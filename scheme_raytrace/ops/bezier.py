"""Ray x cubic-Bezier-"ribbon" intersection (bezier.scm:61-223), vectorized.

The reference recursively subdivides the curve in ray space until a depth
derived from a curvature bound, then accepts if the curve point lies within
width/2 of the ray axis (bezier.scm:121-193).  Recursion with a dynamic
work stack is hostile to XLA, so this kernel solves the same geometric
problem directly: in ray space (ray = +z axis) a hit is a curve parameter s
where the squared 2D distance g(s) = Cx(s)^2 + Cy(s)^2 dips below
(width/2)^2 — found by seeding s uniformly and running damped Newton on
g'(s) = 0 (fixed trip count -> differentiable w.r.t. control points, the
BASELINE gradient target).

Acceptance reproduces bezier.scm:161-166: g(s) < (width/2)^2, z > 1e-4,
t_min < z <= t_max.  Hit convention reproduces B11 (bezier.scm:209-213):
normal = -ray.dir, u = v = 0.  The reference's exact ray-space frame (the
(x,-z,y) permutation, bezier.scm:16-21) is irrelevant to the distance test
— any orthonormal frame with w = dir gives the same g — so we reuse
ops.onb.  The endpoint tangent-orientation culls (bezier.scm:140-147) only
reject hits beyond the curve ends; the s in [0,1] clamp here subsumes them.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import onb
from ..core import vecmath as vm

Z_FLOOR = 0.0001  # bezier.scm:163


def power_coeffs(cp):
    """Control points [...,4,C] -> power-basis coeffs (a0..a3) [...,C]."""
    p0, p1, p2, p3 = cp[..., 0, :], cp[..., 1, :], cp[..., 2, :], cp[..., 3, :]
    a0 = p0
    a1 = 3.0 * (p1 - p0)
    a2 = 3.0 * (p0 - 2.0 * p1 + p2)
    a3 = -p0 + 3.0 * p1 - 3.0 * p2 + p3
    return a0, a1, a2, a3


def eval_bezier(cp, s):
    """De-Casteljau-equivalent evaluation at s [...] for cp [...,4,C]."""
    a0, a1, a2, a3 = power_coeffs(cp)
    s = s[..., None]
    return a0 + s * (a1 + s * (a2 + s * a3))


def tangent(cp, s):
    """bezier.scm:106-117 — cubic derivative."""
    _, a1, a2, a3 = power_coeffs(cp)
    s = s[..., None]
    return a1 + s * (2.0 * a2 + s * 3.0 * a3)


def intersect(o, d, time, scene, t_min, t_max, n_seeds: int = 32,
              n_newton: int = 8):
    """Closest bezier hit per ray.

    o, d: [N,3]; scene.bez_cp: [B,4,3]; returns the standard group tuple.
    """
    dtype = o.dtype
    u_f, v_f, w_f = onb.from_w(d)                       # [N,3] ray-space frame
    rel = scene.bez_cp[None] - o[:, None, None, :]      # [N,B,4,3]
    cx = vm.dot(rel, u_f[:, None, None, :])             # [N,B,4]
    cy = vm.dot(rel, v_f[:, None, None, :])
    cz = vm.dot(rel, w_f[:, None, None, :])
    cp2 = jnp.stack([cx, cy], axis=-1)                  # [N,B,4,2]

    a0, a1, a2, a3 = power_coeffs(cp2)                  # [N,B,2] each

    def g_and_derivs(s):
        ss = s[..., None]
        c = a0 + ss * (a1 + ss * (a2 + ss * a3))                  # [.,.,K,2]
        c1 = a1 + ss * (2.0 * a2 + ss * (3.0 * a3))
        c2 = 2.0 * a2 + ss * (6.0 * a3)
        g = jnp.sum(c * c, axis=-1)
        dg = 2.0 * jnp.sum(c * c1, axis=-1)
        d2g = 2.0 * jnp.sum(c1 * c1 + c * c2, axis=-1)
        return g, dg, d2g

    # Seeds along the curve parameter, shared across rays/curves.
    s = jnp.linspace(0.5 / n_seeds, 1.0 - 0.5 / n_seeds, n_seeds, dtype=dtype)
    s = jnp.broadcast_to(s, cx.shape[:2] + (n_seeds,))   # [N,B,K]
    a0, a1, a2, a3 = (x[..., None, :] for x in (a0, a1, a2, a3))

    import jax

    for _ in range(n_newton):
        g, dg, d2g = g_and_derivs(s)
        step = dg / jnp.where(d2g > 1e-12, d2g, 1e-12)   # damped: only convex
        step = jnp.where(d2g > 1e-12, step, 0.0)
        s = jnp.clip(s - step, 0.0, 1.0)

    # Differentiate the ROOT, not the iteration: the unrolled Newton tape is
    # ill-conditioned in f32 (divisions by d2g ~ eps amplify across steps —
    # seen as a 1800x gradient blow-up in the parity harness).  The root s*
    # of dg(s, p) = 0 has implicit derivative ds*/dp = -(d(dg)/dp)/d2g; we
    # attach exactly that with a primal-zero correction: stop_gradient the
    # converged s, then subtract (dg/d2g - stop_gradient(dg/d2g)), whose
    # primal is 0 and whose gradient is the implicit one.  Roots pinned at
    # the s in {0,1} boundary keep zero derivative (correct: the clamp, not
    # the stationarity condition, defines them), handled by the d2g guard.
    s = jax.lax.stop_gradient(s)
    _, dg, d2g = g_and_derivs(s)
    # Scale-relative curvature floor: at a grazing hit the distance minimum
    # flattens (d2g -> 0) and the implicit derivative ds*/dp = -(ddg/dp)/d2g
    # diverges — an unbounded-variance gradient estimator (observed: one
    # seed contributing 4e3 to a ~1 mean).  Flooring the denominator at a
    # fraction of the tangent-speed scale 2|C'(s)|^2 (the d2g of a locally
    # straight curve) bounds the estimator while leaving well-conditioned
    # roots untouched; the floor is scale-invariant across scene units.
    ss = s[..., None]
    c1 = a1 + ss * (2.0 * a2 + ss * (3.0 * a3))
    d2g_scale = 2.0 * jnp.sum(c1 * c1, axis=-1)
    interior = (s > 0.0) & (s < 1.0)
    d2g_safe = jnp.maximum(d2g, 0.05 * d2g_scale + 1e-12)
    corr = jnp.where(interior, dg / d2g_safe, 0.0)
    s = s - (corr - jax.lax.stop_gradient(corr))

    g, _, _ = g_and_derivs(s)
    az0, az1, az2, az3 = power_coeffs(cz[..., None])     # [N,B,1] each
    az0, az1, az2, az3 = (x[..., 0][..., None] for x in (az0, az1, az2, az3))
    z = az0 + s * (az1 + s * (az2 + s * az3))            # [N,B,K]
    half_w = (scene.bez_w * 0.5)[None, :, None]          # bezier.scm:64
    ok = ((g < half_w * half_w) & (z > Z_FLOOR)
          & (z > t_min) & (z <= t_max)
          & scene.bez_valid[None, :, None])
    t = jnp.where(ok, z, jnp.inf)

    t_per_curve = jnp.min(t, axis=-1)                    # [N,B]
    j = jnp.argmin(t_per_curve, axis=1)
    tb = jnp.take_along_axis(t_per_curve, j[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(tb)
    tb = jnp.where(hit, tb, t_max)
    normal = -d                                          # B11 convention
    zero = jnp.zeros_like(tb)
    return hit, tb, normal, scene.bez_mat[j], zero, zero
