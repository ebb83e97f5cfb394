"""Host-side numpy port of the reference's ray-Bezier subdivision
intersector (bezier.scm:13-214), used ONLY as a test oracle for the
vectorized Newton kernel (scheme_raytrace/ops/bezier.py).

This is a behavioral port written from the algorithm spec (Nakamaru-Ohno
recursive ribbon subdivision): world -> ray-space projection with the
reference's (x, -z, y) axis permutation (bezier.scm:13-43), de Casteljau
split at 0.5 (bezier.scm:78-87), box/width pruning (bezier.scm:126-129),
leaf acceptance by tangent-orientation + projected-parameter + width^2 + z
tests (bezier.scm:130-166), and the adaptive depth bound
log4(sqrt(2) n (n-1) L0 / 8 eps), eps = width/20 (bezier.scm:176-193).
"""

from __future__ import annotations

import numpy as np


def _perm(p):
    """The reference's (x, -z, y) coordinate permutation (bezier.scm:16-21,49-55)."""
    return np.array([p[0], -p[2], p[1]])


def projection_matrix(o, d):
    """bezier.scm:13-43 — 4x4 row-vector matrix: world point -> ray space."""
    op = -_perm(o)
    l = _perm(d / np.linalg.norm(d))
    lx, ly, lz = l
    dd = np.hypot(lx, lz)
    if dd == 0:
        ang = -np.pi / 2 if ly >= 0 else np.pi / 2
        rot = np.array([[1, 0, 0, 0],
                        [0, np.cos(ang), -np.sin(ang), 0],
                        [0, np.sin(ang), np.cos(ang), 0],
                        [0, 0, 0, 1.0]])
    else:
        rot = np.array([[lz / dd, -lx * ly / dd, lx, 0],
                        [0, dd, ly, 0],
                        [-lx / dd, -ly * lz / dd, lz, 0],
                        [0, 0, 0, 1.0]])
    trans = np.eye(4)
    trans[3, :3] = op
    return trans @ rot


def transform_point(p, mat):
    """bezier.scm:49-55 — permute then apply the row-vector matrix."""
    q = _perm(p)
    t = np.array([q[0], q[1], q[2], 1.0]) @ mat
    return t[:3]


def _bez_point(cp, t):
    a, b, c, d = cp
    mt = 1.0 - t
    return (mt ** 3 * a + 3 * mt * mt * t * b + 3 * mt * t * t * c
            + t ** 3 * d)


def _tan_vec(cp, t):
    a, b, c, d = cp
    ca = 3 * b + d - 3 * c - a
    cb = 3 * (a - 2 * b + c)
    cc = 3 * (b - a)
    v = 3 * t * t * ca + 2 * t * cb + cc
    return v / np.linalg.norm(v)


def _split(cp, t):
    """de Casteljau (bezier.scm:78-87)."""
    a, b, c, d = cp
    sp = _bez_point(cp, t)
    nbc = (1 - t) * b + t * c
    lb = (1 - t) * a + t * b
    lc = (1 - t) * lb + t * nbc
    rc = (1 - t) * c + t * d
    rb = (1 - t) * nbc + t * rc
    return np.array([a, lb, lc, sp]), np.array([sp, rb, rc, d])


def _dot2d(u, v):
    return u[0] * v[0] + u[1] * v[1]


def _converge(cp, depth, v0, vn, t, width1, width2):
    """bezier.scm:121-175 — returns (hit?, t)."""
    bmin = cp.min(axis=0) - width1      # bbox incl. width padding (:88-98)
    bmax = cp.max(axis=0) + width1
    if (bmin[2] >= t or bmax[2] <= 1e-6
            or bmin[0] >= width1 or bmax[0] <= -width1
            or bmin[1] >= width1 or bmax[1] <= -width1):
        return False, None
    if depth < 0:
        dirv = cp[3] - cp[0]
        dp0 = _tan_vec(cp, 0.0)
        if _dot2d(dirv, dp0) < 0:
            dp0 = -dp0
        if _dot2d(dp0, -cp[0]) < 0:
            return False, None
        dpn = _tan_vec(cp, 1.0)
        if _dot2d(dirv, dpn) < 0:
            dpn = -dpn
        if _dot2d(dpn, cp[3]) < 0:
            return False, None
        w = dirv[0] ** 2 + dirv[1] ** 2
        if w == 0:
            return False, None
        w = (cp[0][0] * dirv[0] + cp[0][1] * dirv[1]) / (-w)
        w = min(max(w, 0.0), 1.0)
        v = v0 * (1 - w) + vn * w
        p = _bez_point(cp, v)
        if (p[0] ** 2 + p[1] ** 2 >= width2 or p[2] <= 1e-4 or t < p[2]):
            return False, None
        return True, p[2]
    vm = (v0 + vn) / 2
    cl, cr = _split(cp, 0.5)
    hl, tl = _converge(cl, depth - 1, v0, vm, t, width1, width2)
    if hl and tl < t:
        t = tl
    hr, tr = _converge(cr, depth - 1, vm, vn, t, width1, width2)
    if hr and tr < t:
        t = tr
    return (hl or hr), t


def hit(cp_world, width, o, d, t_min, t_max):
    """bezier.scm:176-214 — (hit?, t) for one ray against one curve."""
    mat = projection_matrix(np.asarray(o, float), np.asarray(d, float))
    cp = np.array([transform_point(p, mat) for p in np.asarray(cp_world,
                                                               float)])
    n = 4
    l0 = max(
        max(abs(cp[i][0] - 2 * cp[i + 1][0] + cp[i + 2][0]),
            abs(cp[i][1] - 2 * cp[i + 1][1] + cp[i + 2][1]))
        for i in range(n - 2))
    eps = width / 20.0
    arg = np.sqrt(2) * n * (n - 1) * l0 / (8 * eps)
    max_depth = 0 if arg <= 0 else int(np.ceil(np.log(arg) / np.log(4.0)))
    max_depth = max(max_depth, 0)
    ok, t = _converge(cp, max_depth, 0.0, 1.0, t_max,
                      width / 2.0, (width / 2.0) ** 2)
    if ok and t_min < t:
        return True, t
    return False, None
