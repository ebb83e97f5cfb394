"""Flat threaded BVH traversal over MIXED analytic prims (spheres + rects).

Vectorized shape of the reference's recursive BVH-node hit over arbitrary
hittables (geometry.scm:244-257, :352-368): every ray carries a node
cursor; one `lax.while_loop` step slab-tests the cursor node (clipped to
the ray's best-t — the closest-so-far pruning the closure tree gets from
its t-max argument), intersects the leaf's prim slots vectorized, then
follows hit/miss links.  Stackless, fixed state, no recursion.

Leaf slots hold GLOBAL prim ids (spheres [0, nS), rects [nS, nS + nR) —
scene/build.py packs the tree that way), so one tree spans both analytic
groups; per slot both prim tests run masked by the id's kind (a leaf has
MAX_LEAF=4 slots — the masked double test avoids divergent control
flow).  Forward-only (while_loop): the differentiable path
uses the brute-force sweeps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from . import sphere as sphere_mod
from . import rect as rect_mod

# f32 contractions at full precision: a GPU may run them in TF32, which at
# Cornell scale (coordinates 0..555) moves hit points by whole units
_HI = jax.lax.Precision.HIGHEST


def intersect_bvh_mixed(o, d, time, scene, t_min, t_max):
    """Closest sphere-or-rect hit via the flat threaded BVH.

    Returns the standard group tuple (hit, t, normal, mat, u, v)."""
    n = o.shape[0]
    dt = o.dtype
    nS = int(scene.sph_r.shape[0]) if scene.has_spheres else 0
    has_rects = scene.has_rects

    tiny = jnp.asarray(1e-30, dt)
    inv_d = jnp.where(jnp.abs(d) > tiny, 1.0 / jnp.where(d == 0, 1.0, d),
                      jnp.where(d >= 0, 1e30, -1e30))
    eye = jnp.eye(3, dtype=dt)

    def leaf_slot_t(pj, is_rect, slot_ok, best_t):
        """Candidate t per [N, L] slot (inf when miss)."""
        t_cand = jnp.full(pj.shape, jnp.inf, dt)

        if nS:
            sj = jnp.minimum(pj, nS - 1)
            c = sphere_mod._center_at_slots(scene, sj, time)   # [N,L,3]
            r = scene.sph_r[sj]
            oc = o[:, None, :] - c
            b = vm.dot(oc, d[:, None, :])
            cq = vm.sq_len(oc) - r * r
            disc = b * b - cq
            ok = slot_ok & ~is_rect & (disc > 0.0)
            sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
            t0 = -b - sq
            t1 = -b + sq
            t0 = jnp.where(ok & (t0 > t_min) & (t0 < best_t[:, None]),
                           t0, jnp.inf)
            t1 = jnp.where(ok & (t1 > t_min) & (t1 < best_t[:, None]),
                           t1, jnp.inf)
            t_cand = jnp.minimum(t_cand, jnp.minimum(t0, t1))

        if has_rects:
            rj = jnp.clip(pj - nS, 0, scene.rect_k.shape[0] - 1)
            rot = scene.rect_rot[rj]                     # [N,L,3,3]
            trans = scene.rect_trans[rj]
            if scene.has_rect_xform:
                o_l = jnp.einsum("nlji,nlj->nli", rot,
                                 o[:, None, :] - trans, precision=_HI)
                d_l = jnp.einsum("nlji,nj->nli", rot, d, precision=_HI)
            else:
                o_l = jnp.broadcast_to(o[:, None, :], rot.shape[:2] + (3,))
                d_l = jnp.broadcast_to(d[:, None, :], rot.shape[:2] + (3,))
            axis = scene.rect_axis[rj]                   # [N,L]
            n_sel = eye[axis]
            a_sel = eye[jnp.where(axis == 0, 1, 0)]
            b_sel = eye[jnp.where(axis == 2, 1, 2)]
            dn = vm.dot(d_l, n_sel)
            dn_ok = dn != 0.0
            dn = jnp.where(dn_ok, dn, 1.0)
            t = (scene.rect_k[rj] - vm.dot(o_l, n_sel)) / dn
            pa = vm.dot(o_l, a_sel) + t * vm.dot(d_l, a_sel)
            pb = vm.dot(o_l, b_sel) + t * vm.dot(d_l, b_sel)
            ok = (slot_ok & is_rect & dn_ok
                  & (t >= t_min) & (t < best_t[:, None])
                  & scene.rect_valid[rj]
                  & (pa >= scene.rect_a0[rj]) & (pa <= scene.rect_a1[rj])
                  & (pb >= scene.rect_b0[rj]) & (pb <= scene.rect_b1[rj]))
            t_cand = jnp.minimum(t_cand, jnp.where(ok, t, jnp.inf))

        return t_cand

    def cond(state):
        cursor, _, _ = state
        return jnp.any(cursor >= 0)

    def body(state):
        cursor, best_t, best_g = state
        node = jnp.maximum(cursor, 0)
        active = cursor >= 0
        pmin = scene.bvh_pmin[node]
        pmax = scene.bvh_pmax[node]
        ta = (pmin - o) * inv_d
        tb_ = (pmax - o) * inv_d
        entry = jnp.maximum(jnp.max(jnp.minimum(ta, tb_), -1), t_min)
        exit_ = jnp.minimum(jnp.min(jnp.maximum(ta, tb_), -1), best_t)
        box_hit = active & (entry < exit_)

        prims = scene.bvh_prims[node]                    # [N, L]
        slot_ok = box_hit[:, None] & (prims >= 0)
        pj = jnp.maximum(prims, 0)
        is_rect = pj >= nS
        t_slot = leaf_slot_t(pj, is_rect, slot_ok, best_t)
        k = jnp.argmin(t_slot, axis=1)
        t_new = jnp.take_along_axis(t_slot, k[:, None], axis=1)[:, 0]
        g_new = jnp.take_along_axis(pj, k[:, None], axis=1)[:, 0]
        closer = t_new < best_t
        best_t = jnp.where(closer, t_new, best_t)
        best_g = jnp.where(closer, g_new, best_g)

        nxt = jnp.where(box_hit, scene.bvh_hit[node], scene.bvh_miss[node])
        cursor = jnp.where(active, nxt, cursor)
        return cursor, best_t, best_g

    cursor0 = jnp.zeros(n, jnp.int32)
    best_t0 = jnp.full(n, t_max, dt)
    best_g0 = jnp.zeros(n, jnp.int32)
    _, best_t, g = jax.lax.while_loop(cond, body,
                                      (cursor0, best_t0, best_g0))

    hit = best_t < t_max
    tb = jnp.where(hit, best_t, t_max)
    p = o + tb[:, None] * d
    is_rect = (g >= nS) if has_rects else jnp.zeros_like(hit)

    # resolve attributes per winning prim kind
    normal = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], dt), p.shape)
    mat = jnp.zeros(n, jnp.int32)
    u = jnp.zeros(n, dt)
    v = jnp.zeros(n, dt)
    if nS:
        sj = jnp.minimum(g, nS - 1)
        cj = sphere_mod._center_at(scene, sj, time)
        rjr = scene.sph_r[sj]
        n_s = (p - cj) / rjr[:, None]
        us, vs = sphere_mod.sphere_uv(n_s * jnp.sign(rjr)[:, None])
        sel = (~is_rect)[:, None]
        normal = jnp.where(sel, n_s, normal)
        mat = jnp.where(~is_rect, scene.sph_mat[sj], mat)
        u = jnp.where(~is_rect, us, u)
        v = jnp.where(~is_rect, vs, v)
    if has_rects:
        rj = jnp.clip(g - nS, 0, scene.rect_k.shape[0] - 1)
        axis = scene.rect_axis[rj]
        n_obj = eye[axis] * scene.rect_flip[rj][:, None]
        if scene.has_rect_xform:
            n_r = jnp.einsum("nij,nj->ni", scene.rect_rot[rj], n_obj, precision=_HI)
            p_l = jnp.einsum("nji,nj->ni", scene.rect_rot[rj],
                             p - scene.rect_trans[rj], precision=_HI)
        else:
            n_r = n_obj
            p_l = p
        a_sel = eye[jnp.where(axis == 0, 1, 0)]
        b_sel = eye[jnp.where(axis == 2, 1, 2)]
        pa = vm.dot(p_l, a_sel)
        pb = vm.dot(p_l, b_sel)
        ur = (pa - scene.rect_a0[rj]) / (scene.rect_a1[rj]
                                         - scene.rect_a0[rj])
        vr = (pb - scene.rect_b0[rj]) / (scene.rect_b1[rj]
                                         - scene.rect_b0[rj])
        sel = is_rect[:, None]
        normal = jnp.where(sel, n_r, normal)
        mat = jnp.where(is_rect, scene.rect_mat[rj], mat)
        u = jnp.where(is_rect, ur, u)
        v = jnp.where(is_rect, vr, v)

    return hit, tb, normal, mat, u, v
