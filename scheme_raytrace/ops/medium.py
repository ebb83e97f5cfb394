"""Constant-density participating media (geometry.scm:545-578).

The reference probes the boundary object twice over (-inf, inf) to find the
entry/exit interval, then samples an exponential scatter distance
(geometry.scm:548-574).  Boundaries are convex (boxes or spheres in every
scene), so here the interval comes from one analytic line test — slab for
boxes (in the medium's object space; instanced Cornell-smoke boxes carry a
rigid transform), quadratic for spheres — with no recursion.

Semantics reproduced exactly:
- t1 = max(entry, t_min) then max(t1, 0)   (geometry.scm:556,560)
- t2 = min(exit, t_max)                     (geometry.scm:557)
- scatter iff -1/rho * ln(xi) < (t2 - t1)   (geometry.scm:562-568; |d|=1 here)
- hit record: normal=(1,0,0), u=v=0, material = the *lambertian* phase
  function (geometry.scm:546,571-573 — isotropic is commented out there;
  Scene selects per-medium via ConstantMedium.phase).

The query's t_max must be the closest solid hit so far: the integrator
resolves solids first and passes that in, which matches the reference's
sequential closest-so-far clamping for non-overlapping media (every scene).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import aabb
from .. import config as cfg
from ..core import vecmath as vm

# f32 contractions at full precision: a GPU may run them in TF32, which at
# Cornell scale (coordinates 0..555) moves hit points by whole units
_HI = jax.lax.Precision.HIGHEST
from ..scene import build as sb


def intersect(o, d, time, scene, t_min, t_max, xi):
    """Scatter events inside media, clipped to per-ray t_max [N].

    xi: [N, n_media] uniform draws in [0,1) (exponential distance sampling;
    provided by the caller so the pool/Pallas paths can use counter-hash
    streams).  Returns (hit [N], t [N], normal [N,3], mat [N], u [N], v [N]).
    """
    rot, trans = scene.med_rot, scene.med_trans          # [M,3,3], [M,3]
    o_l = jnp.einsum("mji,nmj->nmi", rot, o[:, None, :] - trans[None], precision=_HI)
    d_l = jnp.einsum("mji,nj->nmi", rot, d, precision=_HI)

    # Box boundary interval (object space)
    box_en, box_ex = aabb.slab_interval(o_l, d_l, scene.med_pmin[None],
                                        scene.med_pmax[None])
    box_ok = box_en < box_ex
    # Sphere boundary interval (world space; sphere media are never rotated)
    oc = o[:, None, :] - scene.med_center[None]
    b = vm.dot(oc, d[:, None, :])
    cq = vm.sq_len(oc) - scene.med_radius * scene.med_radius
    disc = b * b - cq
    sph_ok = disc > 0.0
    sq = jnp.sqrt(jnp.where(sph_ok, disc, 1.0))   # double-where for grads

    is_box = scene.med_kind[None] == sb.MED_BOX
    entry = jnp.where(is_box, box_en, -b - sq)
    exit_ = jnp.where(is_box, box_ex, -b + sq)
    ok = jnp.where(is_box, box_ok, sph_ok) & scene.med_valid[None]

    t1 = jnp.maximum(jnp.maximum(entry, t_min), 0.0)     # geometry.scm:556,560
    t2 = jnp.minimum(exit_, t_max[:, None])              # geometry.scm:557
    ok = ok & (t1 < t2)

    xi = jnp.maximum(xi, jnp.finfo(o.dtype).tiny)        # log(0) guard
    hit_dist = scene.med_neg_inv_d[None] * jnp.log(xi)   # geometry.scm:562-564
    ok = ok & (hit_dist < (t2 - t1))
    t = jnp.where(ok, t1 + hit_dist, jnp.inf)

    j = jnp.argmin(t, axis=1)
    tb = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(tb)
    tb = jnp.where(hit, tb, t_max)
    normal = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], o.dtype), o.shape)
    zero = jnp.zeros_like(tb)
    return hit, tb, normal, scene.med_mat[j], zero, zero
