"""Batched ray x sphere intersection sweep (geometry.scm:146-215).

One fused [N rays, S spheres] sweep replaces the reference's per-object
closure calls; static and moving spheres share one parameter layout
(center lerped by ray time, geometry.scm:188-193).  Negative radius keeps
the reference's hollow-dielectric normal flip (normal = (p-c)/r,
geometry.scm:159-160; used by main.scm:171-172).

UV: the reference's `get-sphere-uv` computes phi = atan(z, z) — bug B1
(geometry.scm:139) — and reads the raw hit point, which is only meaningful
for a unit sphere at the origin.  Fixed here to the canonical Shirley form
evaluated on the outward unit normal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm

_PI = jnp.pi


def sphere_uv(n_unit):
    """Canonical Shirley sphere UV from the outward unit normal (B1 fixed).

    theta via arctan2(y, sqrt(1-y^2)) instead of arcsin: exact at the poles
    to ~1e-6 (arcsin needs a clip whose error blows up as 1/sqrt(1-y)), and
    the 1e-12 floor under the sqrt keeps reverse-mode NaN-free there.
    """
    y = n_unit[..., 1]
    phi = jnp.arctan2(n_unit[..., 2], n_unit[..., 0])
    theta = jnp.arctan2(y, jnp.sqrt(jnp.maximum(1.0 - y * y, 1e-12)))
    u = 1.0 - (phi + _PI) / (2.0 * _PI)
    v = (theta + _PI / 2.0) / _PI
    return u, v


# Below this sphere count the sweep unrolls to a per-sphere loop of
# [N]-shaped ops (see ops/rect.py LOOP_MAX: a [N, S] sweep pads S to the
# 128-lane tile, wasting the VPU and HBM at small S).  Larger scenes keep
# the 2-D sweep or the BVH traversal.
LOOP_MAX = 48


def intersect(o, d, time, scene, t_min, t_max):
    """Closest valid sphere hit per ray.

    o, d: [N,3] (d unit); time: [N]; returns
    (hit [N] bool, t [N], normal [N,3], mat [N] i32, u [N], v [N]).
    """
    if scene.sph_r.shape[0] <= LOOP_MAX:
        return _intersect_loop(o, d, time, scene, t_min, t_max)
    return _intersect_sweep(o, d, time, scene, t_min, t_max)


def _intersect_loop(o, d, time, scene, t_min, t_max):
    """Unrolled per-sphere running-min merge (geometry.scm:146-215)."""
    n = o.shape[0]
    dt = o.dtype
    best_t = jnp.full(n, jnp.inf, dt)
    best_j = jnp.zeros(n, jnp.int32)
    for s in range(scene.sph_r.shape[0]):
        if scene.has_moving:
            span = scene.sph_t1[s] - scene.sph_t0[s]
            frac = (time - scene.sph_t0[s]) / jnp.where(span == 0.0, 1.0,
                                                        span)
            c = scene.sph_c0[s] + frac[:, None] * (scene.sph_c1[s]
                                                   - scene.sph_c0[s])
        else:
            c = scene.sph_c0[s]
        oc = o - c
        r = scene.sph_r[s]
        b = vm.dot(oc, d)
        cq = vm.sq_len(oc) - r * r
        disc = b * b - cq
        ok = disc > 0.0
        sq = jnp.sqrt(jnp.where(ok, disc, 1.0))    # double-where (grads)
        t0 = -b - sq
        t1 = -b + sq
        in0 = ok & (t0 > t_min) & (t0 < t_max)
        in1 = ok & (t1 > t_min) & (t1 < t_max)
        t = jnp.where(in0, t0, jnp.where(in1, t1, jnp.inf))
        closer = (t < best_t) & scene.sph_valid[s]
        best_t = jnp.where(closer, t, best_t)
        best_j = jnp.where(closer, s, best_j)

    hit = jnp.isfinite(best_t)
    tb = jnp.where(hit, best_t, t_max)
    j = best_j
    cj = _center_at(scene, j, time)
    rj = scene.sph_r[j]
    p = o + tb[:, None] * d
    normal = (p - cj) / rj[:, None]
    u, v = sphere_uv(normal * jnp.sign(rj)[:, None])
    return hit, tb, normal, scene.sph_mat[j], u, v


def _intersect_sweep(o, d, time, scene, t_min, t_max):
    """[N, S] masked sweep (large scenes; lanes fully packed at S >= 128)."""
    c0, c1 = scene.sph_c0, scene.sph_c1          # [S,3]
    if scene.has_moving:
        # geometry.scm:188-193 — lerp center by ray time
        span = scene.sph_t1 - scene.sph_t0
        frac = (time[:, None] - scene.sph_t0) / jnp.where(span == 0.0, 1.0, span)
        c = c0 + frac[..., None] * (c1 - c0)     # [N,S,3]
        oc = o[:, None, :] - c
    else:
        c = c0                                    # [S,3]
        oc = o[:, None, :] - c0[None, :, :]       # [N,S,3]
    r = scene.sph_r                               # [S]

    # Half-b quadratic (geometry.scm:149-153); a == 1 for unit d.
    b = vm.dot(oc, d[:, None, :])                 # [N,S]
    cq = vm.sq_len(oc) - r * r
    disc = b * b - cq
    ok = disc > 0.0
    # double-where: keep sqrt' finite on masked lanes so grads don't NaN
    sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
    t0 = -b - sq
    t1 = -b + sq
    in0 = ok & (t0 > t_min) & (t0 < t_max)
    in1 = ok & (t1 > t_min) & (t1 < t_max)
    t = jnp.where(in0, t0, jnp.where(in1, t1, jnp.inf))
    t = jnp.where(scene.sph_valid[None, :], t, jnp.inf)

    j = jnp.argmin(t, axis=1)                     # [N]
    tb = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(tb)
    tb = jnp.where(hit, tb, t_max)

    cj = (jnp.take_along_axis(c, j[:, None, None], axis=1)[:, 0, :]
          if c.ndim == 3 else c[j])
    rj = r[j]
    p = o + tb[:, None] * d
    normal = (p - cj) / rj[:, None]               # sign(r) flips (hollow trick)
    u, v = sphere_uv(normal * jnp.sign(rj)[:, None])
    return hit, tb, normal, scene.sph_mat[j], u, v


def _center_at(scene, j, time):
    """Center of sphere j [N] at ray time [N] (geometry.scm:188-193)."""
    c0, c1 = scene.sph_c0[j], scene.sph_c1[j]
    if not scene.has_moving:
        return c0
    span = scene.sph_t1[j] - scene.sph_t0[j]
    frac = (time - scene.sph_t0[j]) / jnp.where(span == 0.0, 1.0, span)
    return c0 + frac[:, None] * (c1 - c0)


def intersect_bvh(o, d, time, scene, t_min, t_max):
    """Closest sphere hit via the flat threaded BVH (scene/bvh.py).

    Vectorized shape of the reference's recursive node hit (geometry.scm:244-257,
    :352-368): every ray carries a node cursor; one `lax.while_loop` step
    slab-tests the cursor node (clipped to the ray's best t so far — the
    closest-so-far pruning the closure tree gets from its t-max argument),
    intersects leaf prim slots vectorized, then follows hit/miss links.
    Stackless, fixed state, no recursion.  Forward-only (while_loop): the
    differentiable path uses the brute-force sweep instead.
    """
    n = o.shape[0]
    dt = o.dtype
    # safe reciprocal: 0*inf = NaN would poison the slab min/max for rays
    # exactly parallel to an axis; a huge signed value keeps IEEE semantics
    tiny = jnp.asarray(1e-30, dt)
    inv_d = jnp.where(jnp.abs(d) > tiny, 1.0 / jnp.where(d == 0, 1.0, d),
                      jnp.where(d >= 0, 1e30, -1e30))

    def cond(state):
        cursor, _, _ = state
        return jnp.any(cursor >= 0)

    def body(state):
        cursor, best_t, best_j = state
        node = jnp.maximum(cursor, 0)
        active = cursor >= 0
        pmin = scene.bvh_pmin[node]                   # [N,3]
        pmax = scene.bvh_pmax[node]
        ta = (pmin - o) * inv_d
        tb_ = (pmax - o) * inv_d
        entry = jnp.maximum(jnp.max(jnp.minimum(ta, tb_), -1), t_min)
        exit_ = jnp.minimum(jnp.min(jnp.maximum(ta, tb_), -1), best_t)
        box_hit = active & (entry < exit_)

        # leaf primitive slots: [N, MAX_LEAF]
        prims = scene.bvh_prims[node]
        slot_ok = box_hit[:, None] & (prims >= 0)
        pj = jnp.maximum(prims, 0)
        c = _center_at_slots(scene, pj, time)         # [N,L,3]
        r = scene.sph_r[pj]
        oc = o[:, None, :] - c
        b = vm.dot(oc, d[:, None, :])
        cq = vm.sq_len(oc) - r * r
        disc = b * b - cq
        ok = slot_ok & (disc > 0.0)
        sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
        t0 = -b - sq
        t1 = -b + sq
        t0 = jnp.where(ok & (t0 > t_min) & (t0 < best_t[:, None]), t0, jnp.inf)
        t1 = jnp.where(ok & (t1 > t_min) & (t1 < best_t[:, None]), t1, jnp.inf)
        t_slot = jnp.minimum(t0, t1)
        k = jnp.argmin(t_slot, axis=1)
        t_new = jnp.take_along_axis(t_slot, k[:, None], axis=1)[:, 0]
        j_new = jnp.take_along_axis(pj, k[:, None], axis=1)[:, 0]
        closer = t_new < best_t
        best_t = jnp.where(closer, t_new, best_t)
        best_j = jnp.where(closer, j_new, best_j)

        nxt = jnp.where(box_hit, scene.bvh_hit[node], scene.bvh_miss[node])
        cursor = jnp.where(active, nxt, cursor)
        return cursor, best_t, best_j

    cursor0 = jnp.zeros(n, jnp.int32)
    best_t0 = jnp.full(n, t_max, dt)
    best_j0 = jnp.zeros(n, jnp.int32)
    _, best_t, j = jax.lax.while_loop(cond, body, (cursor0, best_t0, best_j0))

    hit = best_t < t_max
    tb = jnp.where(hit, best_t, t_max)
    cj = _center_at(scene, j, time)
    rj = scene.sph_r[j]
    p = o + tb[:, None] * d
    normal = (p - cj) / rj[:, None]
    u, v = sphere_uv(normal * jnp.sign(rj)[:, None])
    return hit, tb, normal, scene.sph_mat[j], u, v


def _center_at_slots(scene, pj, time):
    """Centers for [N, L] prim slots at ray time [N]."""
    c0, c1 = scene.sph_c0[pj], scene.sph_c1[pj]       # [N,L,3]
    if not scene.has_moving:
        return c0
    span = scene.sph_t1[pj] - scene.sph_t0[pj]
    frac = (time[:, None] - scene.sph_t0[pj]) / jnp.where(span == 0.0, 1.0,
                                                          span)
    return c0 + frac[..., None] * (c1 - c0)
