"""Batched ray x axis-aligned-rect sweep (geometry.scm:376-431) with
per-primitive rigid instancing (translate geometry.scm:465-481, rotate-y
geometry.scm:483-543).

The reference wraps objects in ray-transforming closures; here every rect
carries an object->world rotation+translation baked at scene compile, and
the sweep transforms each ray into each rect's object space — one fused
[N rays, R rects] computation.  `flip` (+1/-1) folds flip-normals
(geometry.scm:433-442) and the box min-faces (geometry.scm:444-463) into a
sign.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm

# f32 contractions at full precision: a GPU may run them in TF32, which at
# Cornell scale (coordinates 0..555) moves hit points by whole units
_HI = jax.lax.Precision.HIGHEST

# Below this primitive count the sweep unrolls to a per-rect loop of
# [N]-shaped ops instead of one [N, R] sweep whose materialized
# intermediates cost device-memory traffic (the crossover was set on the
# earlier accelerator; not measured on H100).
LOOP_MAX = 48


def intersect(o, d, time, scene, t_min, t_max):
    """Closest valid rect hit per ray; see sphere.intersect for the contract."""
    if scene.rect_k.shape[0] <= LOOP_MAX:
        return _intersect_loop(o, d, time, scene, t_min, t_max)
    return _intersect_sweep(o, d, time, scene, t_min, t_max)


def _intersect_loop(o, d, time, scene, t_min, t_max):
    """Unrolled per-rect running-min merge: R x [N]-shaped fused VPU ops."""
    n = o.shape[0]
    dt = o.dtype
    eye = jnp.eye(3, dtype=dt)
    axis = scene.rect_axis
    ia = jnp.where(axis == 0, 1, 0)
    ib = jnp.where(axis == 2, 1, 2)

    best_t = jnp.full(n, jnp.inf, dt)
    best_j = jnp.zeros(n, jnp.int32)
    best_pa = jnp.zeros(n, dt)
    best_pb = jnp.zeros(n, dt)
    for r in range(scene.rect_k.shape[0]):
        if scene.has_rect_xform:
            o_l = jnp.matmul(o - scene.rect_trans[r], scene.rect_rot[r],
                             precision=_HI)                     # R^T x
            d_l = jnp.matmul(d, scene.rect_rot[r], precision=_HI)
        else:
            o_l, d_l = o, d
        n_sel = eye[axis[r]]
        a_sel = eye[ia[r]]
        b_sel = eye[ib[r]]
        dn = vm.dot(d_l, n_sel)
        # guard: rays exactly parallel to the plane (dn == 0) would put
        # 0/0 = NaN into the where-VJP even though the lane is masked
        dn_ok = dn != 0.0
        dn = jnp.where(dn_ok, dn, 1.0)
        t = (scene.rect_k[r] - vm.dot(o_l, n_sel)) / dn  # geometry.scm:378-379
        pa = vm.dot(o_l, a_sel) + t * vm.dot(d_l, a_sel)
        pb = vm.dot(o_l, b_sel) + t * vm.dot(d_l, b_sel)
        ok = (dn_ok & (t >= t_min) & (t <= t_max) & scene.rect_valid[r]
              & (pa >= scene.rect_a0[r]) & (pa <= scene.rect_a1[r])
              & (pb >= scene.rect_b0[r]) & (pb <= scene.rect_b1[r])
              & (t < best_t))
        best_t = jnp.where(ok, t, best_t)
        best_j = jnp.where(ok, r, best_j)
        best_pa = jnp.where(ok, pa, best_pa)
        best_pb = jnp.where(ok, pb, best_pb)

    hit = jnp.isfinite(best_t)
    tb = jnp.where(hit, best_t, t_max)
    j = best_j
    n_obj = eye[axis[j]] * scene.rect_flip[j][:, None]
    if scene.has_rect_xform:
        normal = jnp.einsum("nij,nj->ni", scene.rect_rot[j], n_obj, precision=_HI)
    else:
        normal = n_obj
    u = (best_pa - scene.rect_a0[j]) / (scene.rect_a1[j] - scene.rect_a0[j])
    v = (best_pb - scene.rect_b0[j]) / (scene.rect_b1[j] - scene.rect_b0[j])
    return hit, tb, normal, scene.rect_mat[j], u, v


def _intersect_sweep(o, d, time, scene, t_min, t_max):
    rot, trans = scene.rect_rot, scene.rect_trans        # [R,3,3], [R,3]
    if scene.has_rect_xform:
        # x_o = R^T (x_w - t);  d_o = R^T d_w
        o_l = jnp.einsum("rji,nrj->nri", rot, o[:, None, :] - trans[None], precision=_HI)
        d_l = jnp.einsum("rji,nj->nri", rot, d, precision=_HI)
    else:
        o_l = o[:, None, :]
        d_l = d[:, None, :]

    axis = scene.rect_axis                               # [R] normal axis
    # One-hot selectors for the normal axis and the two in-plane axes
    # (ascending index order — matches Rect's (a0,a1)/(b0,b1) convention).
    eye = jnp.eye(3, dtype=o.dtype)
    n_sel = eye[axis]                                    # [R,3]
    ia = jnp.where(axis == 0, 1, 0)                      # first in-plane axis
    ib = jnp.where(axis == 2, 1, 2)                      # second in-plane axis
    a_sel = eye[ia]
    b_sel = eye[ib]

    on = jnp.sum(o_l * n_sel[None], axis=-1)             # [N,R] o along normal
    dn = jnp.sum(d_l * n_sel[None], axis=-1)
    dn_ok = dn != 0.0            # parallel-ray guard (see _intersect_loop)
    dn = jnp.where(dn_ok, dn, 1.0)
    t = (scene.rect_k[None] - on) / dn                   # geometry.scm:378-379
    pa = jnp.sum(o_l * a_sel[None], axis=-1) + t * jnp.sum(d_l * a_sel[None], axis=-1)
    pb = jnp.sum(o_l * b_sel[None], axis=-1) + t * jnp.sum(d_l * b_sel[None], axis=-1)

    inside = ((pa >= scene.rect_a0[None]) & (pa <= scene.rect_a1[None])
              & (pb >= scene.rect_b0[None]) & (pb <= scene.rect_b1[None]))
    ok = (dn_ok & (t >= t_min) & (t <= t_max) & inside
          & scene.rect_valid[None])
    t = jnp.where(ok, t, jnp.inf)

    j = jnp.argmin(t, axis=1)
    tb = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(tb)
    tb = jnp.where(hit, tb, t_max)

    # world normal = R @ (one-hot(axis) * flip)
    n_obj = n_sel[j] * scene.rect_flip[j][:, None]
    if scene.has_rect_xform:
        normal = jnp.einsum("nij,nj->ni", rot[j], n_obj, precision=_HI)
    else:
        normal = n_obj
    ga = lambda x: jnp.take_along_axis(x, j[:, None], axis=1)[:, 0]
    u = (ga(pa) - scene.rect_a0[j]) / (scene.rect_a1[j] - scene.rect_a0[j])
    v = (ga(pb) - scene.rect_b0[j]) / (scene.rect_b1[j] - scene.rect_b0[j])
    return hit, tb, normal, scene.rect_mat[j], u, v
