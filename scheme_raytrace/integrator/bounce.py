"""Fused SoA bounce step: ray regen + intersect + shade in one pass.

The hot loop (the reference's per-pixel `color` recursion, main.scm:100-121,
inlined with `get-ray`, camera.scm:80-92, and the per-object hit walk,
geometry.scm:33-50) as one function over lane arrays: every per-lane
quantity is its OWN lane-shaped array (x, y, z as separate [N] vectors),
never a trailing [N, 3] axis.  Scene data is packed into one flat f32
"constant buffer" whose offsets are static, so primitive loops are
unrolled with scalar parameters and a running closest-hit merge, and the
winning primitive's MATERIAL is merged during the sweep (type, albedo,
fuzz, ref-idx carried as per-lane values) instead of gathered afterwards.

The SAME traced code runs two ways:
  * plain jnp on [M] arrays — the CPU path, and the correctness oracle
    for the kernel;
  * inside a Pallas kernel on the Triton route (`as_pallas`), one program
    per power-of-two block of lanes: ray generation + intersection sweeps
    + scatter/emit in one kernel per bounce, with a lane's state in
    registers and the inner loops' early exits taken per block.

Coverage: spheres (static + moving), rects (with baked rigid transforms),
constant media (oriented-slab/sphere boundaries, exponential scatter),
kleinian SDFs (sphere-traced in-kernel, implicit-function t gradients),
bezier ribbons (Newton-on-seeds, implicit-root gradients),
lambertian/metal/dielectric/diffuse-light, constant/checker/noise/marble
textures (hash perlin computed in register — scene/perlin.py), gradient/
black sky, mixture-PDF light sampling (xz-rect + sphere lights).  Scenes
using big image textures, BVH traversal, or russian roulette take the
general masked-sweep pool body instead (integrator/pool.py chooses per
scene).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as cfg_mod
from ..camera import _basis
from ..core import rng
from ..scene import build as sb
from ..scene import objects as ob

_PI = float(np.pi)
_TWO_PI = 2.0 * _PI

# ---------------------------------------------------------------------------
# SoA vec helpers: a "vector" is a (x, y, z) tuple of same-shape arrays
# ---------------------------------------------------------------------------


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def where3(m, a, b):
    return tuple(jnp.where(m, x, y) for x, y in zip(a, b))


def unit3(a, eps=1e-12):
    inv = jax.lax.rsqrt(jnp.maximum(dot3(a, a), eps))
    return scale3(a, inv)


# ---------------------------------------------------------------------------
# Packed-scene layout (static offsets; one flat f32 vector)
# ---------------------------------------------------------------------------

# header fields
H_SKY_A, H_SKY_B = 0, 3
H_CAM_O, H_CAM_LL, H_CAM_H, H_CAM_V, H_CAM_U, H_CAM_VV = 6, 9, 12, 15, 18, 21
H_LENS_R, H_T0, H_DT = 24, 25, 26
HDR_SIZE = 27

# per-rect fields — ORIENTED-PLANE representation, fully world-space:
# the reference's rotate/translate instancing (geometry.scm:465-543) is
# baked into a world plane at pack time (normal WN, plane constant K =
# WN.point, in-plane edge axes A/B with projected ranges), so the kernel
# never rotates rays: a rotated Cornell box rect costs exactly the same
# ~6 dot products as an axis-aligned wall.
R_WN, R_K, R_A, R_KA0, R_KA1, R_B, R_KB0, R_KB1, R_VALID = (
    0, 3, 4, 7, 8, 9, 12, 13, 14)
# TEXK = texture kind as float (scene.build TEX_* ids: 0 constant,
# 1 checker, 2 noise, 3 marble); TEXS = procedural-texture scale
R_MTYPE, R_ALB0, R_ALB1, R_TEXK, R_FUZZ, R_REF, R_TEXS = (
    15, 16, 19, 22, 23, 24, 25)
RECT_SIZE = 26

# per-sphere fields
S_C0, S_C1, S_T0, S_T1, S_R, S_VALID = 0, 3, 6, 7, 8, 9
S_MTYPE, S_ALB0, S_ALB1, S_TEXK, S_FUZZ, S_REF, S_TEXS = (
    10, 11, 14, 17, 18, 19, 20)
SPH_SIZE = 21

# per-light fields
L_KIND, L_X0, L_X1, L_Z0, L_Z1, L_KY, L_C, L_RAD, L_VALID = (
    0, 1, 2, 3, 4, 5, 6, 9, 10)
LGT_SIZE = 11

# per-medium fields (geometry.scm:545-578): the boundary is an oriented
# 3-slab box (Cornell smoke's rotate_y+translate boxes baked to world
# axes at pack time, like the rects) OR a sphere; M_NID = -1/density
M_KIND = 0                      # 0 box, 1 sphere (scene.build MED_*)
M_AX = 1                        # 3 x (axis vec3, lo, hi) = 15 floats
M_C, M_RAD = 16, 19
M_NID, M_VALID = 20, 21
M_MTYPE, M_ALB0, M_ALB1, M_TEXK, M_FUZZ, M_REF, M_TEXS = (
    22, 23, 26, 29, 30, 31, 32)
MED_SIZE = 33

# per-klein fields (geometry.scm:580-664): center + phase material
K_C, K_VALID = 0, 3
K_MTYPE, K_ALB0, K_ALB1, K_TEXK, K_FUZZ, K_REF, K_TEXS = (
    4, 5, 8, 11, 12, 13, 14)
KL_SIZE = 15

# per-bezier fields (bezier.scm:61-223): 4 control points + ribbon width
B_CP, B_W, B_VALID = 0, 12, 13
B_MTYPE, B_ALB0, B_ALB1, B_TEXK, B_FUZZ, B_REF, B_TEXS = (
    14, 15, 18, 21, 22, 23, 24)
BEZ_SIZE = 25


@dataclasses.dataclass(frozen=True)
class BouncePlan:
    """Static shape/flag info for one (scene, config) pair."""
    n_rects: int
    n_spheres: int
    n_lights: int
    has_moving: bool
    light_sampling: bool
    has_perlin: bool
    perlin_seed: int
    nx: int
    ny: int
    total_pix: int
    max_depth: int
    seed: int
    dtype: str
    n_media: int = 0
    n_kleins: int = 0
    n_beziers: int = 0
    bez_seeds: int = 32
    bez_newton: int = 8
    # image textures: static (ih, iw) per atlas image (see pack)
    img_dims: tuple = ()
    # large-sphere-group sweep keeps only (t, winner index) in its fori
    # carry and gathers the winner's 21 packed attributes ONCE post-loop
    # from pk, instead of merging 14 attribute selects per probe (the
    # same comparisons and attribute floats either way).
    attr_sweep: bool = False
    size: int = 0

    @property
    def has_image(self) -> bool:
        return bool(self.img_dims)

    @property
    def img_chunks(self):
        """Per-image chunk count (128-texel rows per channel)."""
        return tuple(-(-(ih * iw) // 128) for ih, iw in self.img_dims)

    @property
    def img_bases(self):
        """First atlas row of each image (3 channel planes per image)."""
        bases, acc = [], 0
        for nck in self.img_chunks:
            bases.append(acc)
            acc += 3 * nck
        return tuple(bases)

    @property
    def img_rows(self) -> int:
        return 3 * sum(self.img_chunks)

    def __post_init__(self):
        object.__setattr__(
            self, "size",
            HDR_SIZE + self.n_rects * RECT_SIZE
            + self.n_spheres * SPH_SIZE + self.n_lights * LGT_SIZE
            + self.n_media * MED_SIZE + self.n_kleins * KL_SIZE
            + self.n_beziers * BEZ_SIZE)

    @property
    def rect_base(self):
        return HDR_SIZE

    @property
    def sph_base(self):
        return HDR_SIZE + self.n_rects * RECT_SIZE

    @property
    def lgt_base(self):
        return self.sph_base + self.n_spheres * SPH_SIZE

    @property
    def med_base(self):
        return self.lgt_base + self.n_lights * LGT_SIZE

    @property
    def kl_base(self):
        return self.med_base + self.n_media * MED_SIZE

    @property
    def bez_base(self):
        return self.kl_base + self.n_kleins * KL_SIZE


# Per prim GROUP: up to this count the sweep unrolls with constant packed
# offsets; above it, a fori_loop with dynamic packed offsets keeps compile
# size O(1) in prim count (see _intersect).  Carried over from the
# earlier accelerator's tuning; not measured on H100.
UNROLL_MAX = 64
# Prims probed per dynamic-sweep loop trip (static sub-offsets inside the
# body; see _prim_loop).  Not measured on H100.
SWEEP_CHUNK = 8
# Routing cap: scenes with more prims than this take the general [N,3]
# pool (brute sweep), whose one-shot vectorized sweep held up better than
# the fused fori sweep at 16k spheres on the earlier accelerator.  Not
# measured on H100.
MAX_FUSED_PRIMS = 4096


# Image-texture atlas cap for the fused path: total 128-texel chunk rows
# across all images and channels (48 rows = e.g. one 32x64 RGB image).
# Bigger atlases route to the general pool.  Not measured on H100.
IMG_ROWS_MAX = 48


def supported(scene, config) -> bool:
    """True when the fused SoA bounce covers this (scene, config)."""
    n_prims = ((int(scene.rect_k.shape[0]) if scene.has_rects else 0)
               + (int(scene.sph_r.shape[0]) if scene.has_spheres else 0))
    if scene.has_image_tex:
        # fused image textures: sphere/rect materials only (the packed
        # alb0 slots carry (iw, ih, base) for image-textured prims; media
        # phase colors and the klein/bezier u=v=0 convention keep those
        # groups on the general pool), small-atlas cap per IMG_ROWS_MAX
        rows = 3 * sum(-(-(ih * iw) // 128) for ih, iw in scene.img_dims)
        if (not set(scene.img_groups) <= {"sphere", "rect"}
                or rows > IMG_ROWS_MAX):
            return False
    return not (config.russian_roulette or config.traversal == "bvh"
                or config.material_sort     # EP experiment: general pool only
                or n_prims > MAX_FUSED_PRIMS)


def make_plan(scene, config) -> BouncePlan:
    return BouncePlan(
        n_rects=int(scene.rect_k.shape[0]) if scene.has_rects else 0,
        n_spheres=int(scene.sph_r.shape[0]) if scene.has_spheres else 0,
        n_lights=scene.n_lights if config.light_sampling else 0,
        has_moving=scene.has_moving,
        light_sampling=config.light_sampling and scene.n_lights > 0,
        has_perlin=scene.has_perlin_tex, perlin_seed=scene.perlin_seed,
        nx=config.nx, ny=config.ny, total_pix=config.n_pixels,
        max_depth=config.max_depth, seed=config.seed, dtype=config.dtype,
        n_media=int(scene.med_kind.shape[0]) if scene.has_media else 0,
        n_kleins=int(scene.kl_center.shape[0]) if scene.has_klein else 0,
        n_beziers=int(scene.bez_w.shape[0]) if scene.has_beziers else 0,
        bez_seeds=config.bezier_seeds, bez_newton=config.bezier_newton,
        img_dims=scene.img_dims if scene.has_image_tex else (),
        attr_sweep=(int(scene.sph_r.shape[0]) if scene.has_spheres else 0)
        > UNROLL_MAX)


def _mat_fields(scene, mid, img_bases=None):
    """(mtype, alb0, alb1, texk, texs) resolved through the tex table.

    texk carries scene.build's TEX_* id as a float (the kernel has no int
    lanes in the merge); alb0/alb1 are the constant / checker-children
    colors (zeros for procedural textures — the kernel computes those).
    For IMAGE textures the alb0 triple is repurposed as (iw, ih,
    first_atlas_row) — the kernel's texel lookup metadata (the color slots
    are dead for image prims; the texel substitutes for alb in step)."""
    tex = scene.mat_tex[mid]
    ttype = scene.tex_type[tex]
    ischeck = (ttype == sb.TEX_CHECKER)
    alb0 = jnp.where(ischeck[:, None],
                     scene.tex_color[scene.tex_child0[tex]],
                     scene.tex_color[tex])
    if img_bases is not None:
        isimg = (ttype == sb.TEX_IMAGE)
        meta = jnp.stack(
            [scene.tex_iw[tex].astype(alb0.dtype),
             scene.tex_ih[tex].astype(alb0.dtype),
             jnp.asarray(img_bases, alb0.dtype)[scene.tex_image[tex]]],
            axis=1)
        alb0 = jnp.where(isimg[:, None], meta, alb0)
    alb1 = scene.tex_color[scene.tex_child1[tex]]
    return (scene.mat_type[mid].astype(alb0.dtype), alb0, alb1,
            ttype.astype(alb0.dtype), scene.tex_scale[tex])


def pack(scene, cam, plan: BouncePlan, dtype):
    """Build the flat f32 scene/"constant buffer" vector (traced, cheap).

    With image textures (plan.has_image) returns (pk, imgtex) where
    imgtex is the flat [plan.img_rows * 128] texel atlas: each image's
    channel planes flattened row-major and chunked into 128-texel rows
    (image k's rows at plan.img_bases[k], channel c at +c*img_chunks[k]).
    The pool glue passes the pair through opaquely; step/as_pallas unpack
    it."""
    imgtex = None
    if plan.has_image:
        rows = []
        for k, (ih, iw) in enumerate(plan.img_dims):
            nck = plan.img_chunks[k]
            for c in range(3):
                texels = scene.images[k, :ih, :iw, c].reshape(-1)
                texels = jnp.concatenate(
                    [texels, jnp.zeros(nck * 128 - ih * iw, texels.dtype)])
                rows.append(texels.reshape(nck, 128))
        imgtex = jnp.concatenate(rows, axis=0).astype(dtype)
    img_bases = plan.img_bases if plan.has_image else None

    pieces = []
    f = lambda x: jnp.asarray(x, dtype).ravel()
    pieces += [f(scene.sky_a), f(scene.sky_b)]
    origin, ll, hor, ver, cu, cv, _ = _basis(cam)
    pieces += [f(origin), f(ll), f(hor), f(ver), f(cu), f(cv),
               f(cam.aperture / 2.0), f(cam.time0),
               f(cam.time1 - cam.time0)]

    if plan.n_rects:
        eye = jnp.eye(3, dtype=dtype)
        axis = scene.rect_axis
        nsel = eye[axis]
        asel = eye[jnp.where(axis == 0, 1, 0)]
        bsel = eye[jnp.where(axis == 2, 1, 2)]
        rot = scene.rect_rot.astype(dtype)
        trans = scene.rect_trans.astype(dtype)
        # world-space plane: object test p_obj . sel ∈ range, with
        # p_obj = R^T (p - T), becomes p . (R sel) ∈ range + T . (R sel)
        # elementwise sums, not einsum: a GPU may run an f32 contraction
        # in TF32, which moves Cornell-scale (0..555) planes by whole units
        n_w = jnp.sum(rot * nsel[:, None, :], axis=2)
        a_w = jnp.sum(rot * asel[:, None, :], axis=2)
        b_w = jnp.sum(rot * bsel[:, None, :], axis=2)
        tn = jnp.sum(trans * n_w, axis=1)
        ta = jnp.sum(trans * a_w, axis=1)
        tb = jnp.sum(trans * b_w, axis=1)
        flip = scene.rect_flip.astype(dtype)
        wn = n_w * flip[:, None]
        kk = (scene.rect_k + tn) * flip            # so t = (K - o.wn)/(d.wn)
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.rect_mat, img_bases)
        block = jnp.concatenate([
            wn, kk[:, None],
            a_w, (scene.rect_a0 + ta)[:, None], (scene.rect_a1 + ta)[:, None],
            b_w, (scene.rect_b0 + tb)[:, None], (scene.rect_b1 + tb)[:, None],
            scene.rect_valid.astype(dtype)[:, None],
            mtype[:, None], alb0, alb1, texk[:, None],
            scene.mat_fuzz[scene.rect_mat][:, None],
            scene.mat_ref[scene.rect_mat][:, None],
            texs[:, None],
        ], axis=1).astype(dtype)
        assert block.shape[1] == RECT_SIZE
        pieces.append(block.ravel())

    if plan.n_spheres:
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.sph_mat, img_bases)
        block = jnp.concatenate([
            scene.sph_c0, scene.sph_c1, scene.sph_t0[:, None],
            scene.sph_t1[:, None], scene.sph_r[:, None],
            scene.sph_valid.astype(dtype)[:, None],
            mtype[:, None], alb0, alb1, texk[:, None],
            scene.mat_fuzz[scene.sph_mat][:, None],
            scene.mat_ref[scene.sph_mat][:, None],
            texs[:, None],
        ], axis=1).astype(dtype)
        assert block.shape[1] == SPH_SIZE
        pieces.append(block.ravel())

    if plan.n_lights:
        block = jnp.concatenate([
            scene.light_kind.astype(dtype)[:, None],
            scene.light_rect,                       # x0, x1, z0, z1, k
            scene.light_center,
            scene.light_radius[:, None],
            scene.light_valid.astype(dtype)[:, None],
        ], axis=1).astype(dtype)
        assert block.shape[1] == LGT_SIZE
        pieces.append(block.ravel())

    if plan.n_media:
        # oriented 3-slab boundary: object test p_obj[a] in [pmin_a, pmax_a]
        # with p_obj = R^T (p - T) becomes p . R[:,a] in range + T . R[:,a]
        rot = scene.med_rot.astype(dtype)
        trans = scene.med_trans.astype(dtype)
        ax_blocks = []
        for a in range(3):
            u = rot[:, :, a]
            ut = jnp.sum(u * trans, axis=1)
            ax_blocks += [u, (scene.med_pmin[:, a] + ut)[:, None],
                          (scene.med_pmax[:, a] + ut)[:, None]]
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.med_mat)
        block = jnp.concatenate([
            scene.med_kind.astype(dtype)[:, None],
            *ax_blocks,
            scene.med_center, scene.med_radius[:, None],
            scene.med_neg_inv_d[:, None],
            scene.med_valid.astype(dtype)[:, None],
            mtype[:, None], alb0, alb1, texk[:, None],
            scene.mat_fuzz[scene.med_mat][:, None],
            scene.mat_ref[scene.med_mat][:, None],
            texs[:, None],
        ], axis=1).astype(dtype)
        assert block.shape[1] == MED_SIZE
        pieces.append(block.ravel())

    if plan.n_kleins:
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.kl_mat)
        block = jnp.concatenate([
            scene.kl_center,
            scene.kl_valid.astype(dtype)[:, None],
            mtype[:, None], alb0, alb1, texk[:, None],
            scene.mat_fuzz[scene.kl_mat][:, None],
            scene.mat_ref[scene.kl_mat][:, None],
            texs[:, None],
        ], axis=1).astype(dtype)
        assert block.shape[1] == KL_SIZE
        pieces.append(block.ravel())

    if plan.n_beziers:
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.bez_mat)
        block = jnp.concatenate([
            scene.bez_cp.reshape(-1, 12),
            scene.bez_w[:, None],
            scene.bez_valid.astype(dtype)[:, None],
            mtype[:, None], alb0, alb1, texk[:, None],
            scene.mat_fuzz[scene.bez_mat][:, None],
            scene.mat_ref[scene.bez_mat][:, None],
            texs[:, None],
        ], axis=1).astype(dtype)
        assert block.shape[1] == BEZ_SIZE
        pieces.append(block.ravel())

    pk = jnp.concatenate(pieces)
    assert pk.shape[0] == plan.size, (pk.shape, plan.size)
    if plan.has_image:
        assert imgtex.shape == (plan.img_rows, 128), imgtex.shape
        return pk, imgtex.reshape(-1)
    return pk


# ---------------------------------------------------------------------------
# The fused step (shape-agnostic; jnp on [M] or Pallas on (B, 128))
# ---------------------------------------------------------------------------


def _v(pk, base):
    return (pk[base], pk[base + 1], pk[base + 2])


def _camera_ray(plan, pk, u, px, py):
    """SoA get_rays_u (camera.scm:80-92) from packed camera basis."""
    dt = px.dtype
    s = (px + u[0]) * (1.0 / plan.nx)          # main.scm:456-457
    t = (py + u[1]) * (1.0 / plan.ny)
    r = jnp.sqrt(u[2])
    phi = _TWO_PI * u[3]
    rdx = pk[H_LENS_R] * r * jnp.cos(phi)
    rdy = pk[H_LENS_R] * r * jnp.sin(phi)
    cu, cv = _v(pk, H_CAM_U), _v(pk, H_CAM_VV)
    off = add3(scale3(cu, rdx), scale3(cv, rdy))
    origin = _v(pk, H_CAM_O)
    o = add3(origin, off)
    ll, hor, ver = _v(pk, H_CAM_LL), _v(pk, H_CAM_H), _v(pk, H_CAM_V)
    d = tuple(ll[i] + s * hor[i] + t * ver[i] - origin[i] - off[i]
              for i in range(3))
    time = pk[H_T0] + u[4] * pk[H_DT]
    return o, unit3(d), jnp.broadcast_to(time.astype(dt), px.shape)


def _merge_rec(pk, best, ok, t, wn, base, a0_off, a1_off, m_off, tk_off,
               fz_off, rf_off, ts_off, uv=None):
    """Fold one primitive's candidate hit into the running best record.

    `uv` (surface coordinates, carried only when the plan has image
    textures — the "u"/"v" keys exist in `best` then): probes without a
    UV convention (media, klein, bezier — B11's u=v=0) pass None and
    merge zeros, matching the general pool's ops paths."""
    closer = ok & (t < best["t"])
    out = {
        "hit": best["hit"] | closer,
        "t": jnp.where(closer, t, best["t"]),
        "wn": where3(closer, wn, best["wn"]),
        "mtype": jnp.where(closer, pk[base + m_off], best["mtype"]),
        "alb0": where3(closer, tuple(pk[base + a0_off + i]
                                     for i in range(3)), best["alb0"]),
        "alb1": where3(closer, tuple(pk[base + a1_off + i]
                                     for i in range(3)), best["alb1"]),
        "texk": jnp.where(closer, pk[base + tk_off], best["texk"]),
        "texs": jnp.where(closer, pk[base + ts_off], best["texs"]),
        "fuzz": jnp.where(closer, pk[base + fz_off], best["fuzz"]),
        "ref": jnp.where(closer, pk[base + rf_off], best["ref"]),
    }
    if "u" in best:
        zero = jnp.zeros_like(best["u"])
        u, v = uv if uv is not None else (zero, zero)
        out["u"] = jnp.where(closer, u, best["u"])
        out["v"] = jnp.where(closer, v, best["v"])
    return out


# Kleinian inversion-sphere positions, klein-local (geometry.scm:591-599)
_KLEIN_SPHERES = ((300.0, 300.0, 0.0), (300.0, -300.0, 0.0),
                  (-300.0, 300.0, 0.0), (-300.0, -300.0, 0.0),
                  (0.0, 0.0, 424.26), (0.0, 0.0, -424.26))


def _klein_dist(c, px, py, pz):
    """SoA distance estimate (geometry.scm:602-624; ops/klein.dist_func).

    c: (cx, cy, cz) klein center; p*: lane-shaped world positions.  The 6
    inversion-sphere interiors are disjoint, so "first containing sphere"
    unrolls to a masked sequential select inside the fori over iterations.
    """
    px, py, pz = px - c[0], py - c[1], pz - c[2]
    r2 = cfg_mod.KLEIN_SPHERE_R * cfg_mod.KLEIN_SPHERE_R
    tiny = jnp.finfo(px.dtype).tiny

    # masks ride the carry as int32 (0/1), so "any lane active" is a max
    # reduction, which the kernel route lowers (it has no reduce_or)
    def cond(st):
        # EXACT early exit: an inactive point never changes again, so
        # stopping once every lane in the block has escaped its inversion
        # sphere skips only no-op iterations (sky-dominated march points
        # escape in 1-3 inversions; in the kernel the test is per block).
        px, py, pz, dr, active_i, k = st
        return (k < cfg_mod.KLEIN_ITERATIONS) & (jnp.max(active_i) > 0)

    def body(st):
        px, py, pz, dr, active_i, k = st
        active = active_i != 0
        found = jnp.zeros_like(active)
        for sx, sy, sz in _KLEIN_SPHERES:
            dx, dy, dz = px - sx, py - sy, pz - sz
            d2 = dx * dx + dy * dy + dz * dz
            sel = active & ~found & (d2 < r2)
            scale = r2 / jnp.maximum(d2, tiny)
            px = jnp.where(sel, dx * scale + sx, px)
            py = jnp.where(sel, dy * scale + sy, py)
            pz = jnp.where(sel, dz * scale + sz, pz)
            dr = jnp.where(sel, dr * scale, dr)
            found = found | sel
        return px, py, pz, dr, (active & found).astype(jnp.int32), k + 1

    dr0 = jnp.ones_like(px)
    px, py, pz, dr, _, _ = jax.lax.while_loop(
        cond, body,
        (px, py, pz, dr0, jnp.ones_like(px, jnp.int32), jnp.int32(0)))
    ln = jnp.sqrt(px * px + py * py + pz * pz)
    return cfg_mod.KLEIN_DE_SCALE * (ln - cfg_mod.KLEIN_R) / jnp.abs(dr)


def _klein_dist_grad(c, px, py, pz):
    """DE + exact spatial gradient in ONE inversion loop.

    Propagates the three unit tangents d(P)/d(x0), d(P)/d(y0), d(P)/d(z0)
    analytically alongside the primal: the inversion x -> r2*x/|x|^2 + s
    has differential dx' = scale*(dx - x*w) with w = 2*(x.dx)/|x|^2, and
    the DE-scale derivative is ddr' = scale*(ddr - w*dr).  One such loop
    (~4 primal-equivalents of work) replaces the round-4 kernel's
    6-evaluation central-difference normal (geometry.scm:626-632, h=0.01)
    PLUS the separate implicit-t jvp — the ray derivative is just g . d —
    cutting the klein probe's post-march DE cost ~2x, and the normal is
    exact instead of h-smoothed (deviation from the reference's CD
    convention, applied consistently in ops/klein.get_normal and the f64
    oracle; goldens regenerated).
    """
    px, py, pz = px - c[0], py - c[1], pz - c[2]
    r2 = cfg_mod.KLEIN_SPHERE_R * cfg_mod.KLEIN_SPHERE_R
    tiny = jnp.finfo(px.dtype).tiny
    one, zero = jnp.ones_like(px), jnp.zeros_like(px)

    def body(_, st):
        (px, py, pz, dr, t1x, t1y, t1z, t2x, t2y, t2z, t3x, t3y, t3z,
         dd1, dd2, dd3, active_i) = st
        active = active_i != 0
        found = jnp.zeros_like(active)
        for sx, sy, sz in _KLEIN_SPHERES:
            dx, dy, dz = px - sx, py - sy, pz - sz
            d2 = dx * dx + dy * dy + dz * dz
            sel = active & ~found & (d2 < r2)
            inv_d2 = 1.0 / jnp.maximum(d2, tiny)
            scale = r2 * inv_d2
            for j in range(3):
                tx, ty, tz, dd = ((t1x, t1y, t1z, dd1), (t2x, t2y, t2z, dd2),
                                  (t3x, t3y, t3z, dd3))[j]
                w = 2.0 * (dx * tx + dy * ty + dz * tz) * inv_d2
                ntx = scale * (tx - dx * w)
                nty = scale * (ty - dy * w)
                ntz = scale * (tz - dz * w)
                ndd = scale * (dd - w * dr)
                if j == 0:
                    t1x = jnp.where(sel, ntx, t1x)
                    t1y = jnp.where(sel, nty, t1y)
                    t1z = jnp.where(sel, ntz, t1z)
                    dd1 = jnp.where(sel, ndd, dd1)
                elif j == 1:
                    t2x = jnp.where(sel, ntx, t2x)
                    t2y = jnp.where(sel, nty, t2y)
                    t2z = jnp.where(sel, ntz, t2z)
                    dd2 = jnp.where(sel, ndd, dd2)
                else:
                    t3x = jnp.where(sel, ntx, t3x)
                    t3y = jnp.where(sel, nty, t3y)
                    t3z = jnp.where(sel, ntz, t3z)
                    dd3 = jnp.where(sel, ndd, dd3)
            px = jnp.where(sel, dx * scale + sx, px)
            py = jnp.where(sel, dy * scale + sy, py)
            pz = jnp.where(sel, dz * scale + sz, pz)
            dr = jnp.where(sel, dr * scale, dr)
            found = found | sel
        return (px, py, pz, dr, t1x, t1y, t1z, t2x, t2y, t2z,
                t3x, t3y, t3z, dd1, dd2, dd3,
                (active & found).astype(jnp.int32))

    st = jax.lax.fori_loop(
        0, cfg_mod.KLEIN_ITERATIONS, body,
        (px, py, pz, one, one, zero, zero, zero, one, zero,
         zero, zero, one, zero, zero, zero,
         jnp.ones_like(px, jnp.int32)))
    (px, py, pz, dr, t1x, t1y, t1z, t2x, t2y, t2z,
     t3x, t3y, t3z, dd1, dd2, dd3, _) = st
    ln = jnp.sqrt(jnp.maximum(px * px + py * py + pz * pz, tiny))
    adr = jnp.abs(dr)
    de = cfg_mod.KLEIN_DE_SCALE * (ln - cfg_mod.KLEIN_R) / adr
    # d(de)/d(x0_j) = K/|dr| * ((P . t_j)/|P| - (|P| - R)*ddr_j/dr)
    k = cfg_mod.KLEIN_DE_SCALE / adr
    rat = (ln - cfg_mod.KLEIN_R) / dr
    g = tuple(k * ((px * tx + py * ty + pz * tz) / ln - rat * dd)
              for tx, ty, tz, dd in ((t1x, t1y, t1z, dd1),
                                     (t2x, t2y, t2z, dd2),
                                     (t3x, t3y, t3z, dd3)))
    return de, g


def _klein_march(c, o, d, t_min, t_max):
    """SoA sphere trace (geometry.scm:646-661; ops/klein._march_one).

    Runs entirely under stop_gradient by the caller's arrangement; the
    differentiable t is attached afterwards via the implicit-function
    correction (one extra DE evaluation instead of a 100-step tape).

    t_max may be a LANE ARRAY (the closest solid hit so far): accepting at
    t >= t_max can never win the strict closest-hit merge, so bounding the
    march by it is exact — and it stops wall-bound rays from crawling
    through the small-DE fractal basin behind their own hit."""
    # EXACT ray precull: the acceptance set {DE < eps} lies inside
    # |p - c| < 724.3 (outside every inversion sphere the DE is
    # 0.7*(|p-c|-125) > eps, and each inversion-sphere ball B(s_i, 300)
    # has |s_i| = 424.26).  A lane whose ray never enters that ball on
    # (t_min, t_max) can never accept: it starts retired, and all-miss
    # blocks leave the march after a single cond evaluation.  d is unit
    # (regen normalizes, bounce.py:510), so the quadratic is in t units.
    ox, oy, oz = o[0] - c[0], o[1] - c[1], o[2] - c[2]
    bq = ox * d[0] + oy * d[1] + oz * d[2]
    cq = ox * ox + oy * oy + oz * oz - 726.0 * 726.0
    disc = bq * bq - cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    miss = (disc <= 0.0) | (-bq + sq <= t_min) | (-bq - sq >= t_max)

    def cond(st):
        _, done_i, _, k = st
        # early exit: most lanes retire long before the 100-step cap —
        # either accepted, or past t_max (the DE grows geometrically once
        # receding, so sky lanes blow through t_max in ~40 steps) — and a
        # retired lane can never accept again, so skipping its remaining
        # steps is EXACT, not approximate.  done_i is 0/1, so "any lane
        # live" is a min reduction (the kernel route has no reduce_or).
        return (k < cfg_mod.KLEIN_MAX_STEPS) & (jnp.min(done_i) == 0)

    def body(st):
        ray_len, done_i, hit_i, k = st            # masks as i32 (see
        done = done_i != 0                        # the _klein_dist note)
        # done lanes evaluate at a far point: their stale positions can
        # sit deep in the inversion basin and hold _klein_dist's
        # early exit at its 10-iteration cap for the rest
        # of the march; a far point escapes in one iteration, so the
        # inner loop tracks LIVE lanes only.  Exact — dist is discarded
        # for done lanes (ray_len frozen, accept masked by ~done).
        far = jnp.asarray(1e6, ray_len.dtype)
        dist = _klein_dist(c,
                           jnp.where(done, far, o[0] + d[0] * ray_len),
                           jnp.where(done, far, o[1] + d[1] * ray_len),
                           jnp.where(done, far, o[2] + d[2] * ray_len))
        new_len = ray_len + dist
        accept = ((dist < cfg_mod.KLEIN_SURF_EPS) & (new_len > t_min)
                  & (new_len < t_max))
        # backward-stuck retirement: pre-advance position in the DE<=0
        # solid at parameter <= t_min.  DE underestimates distance, and
        # that solid point bounds every later step (len' <= len + dist
        # to it), so new_len can never clear t_min again — no acceptance
        # is reachable; retire as miss.  These are scatter rays born
        # inside the fractal shell that otherwise march backward for the
        # full 100-step cap (measured: 81% of cap-bound lanes).
        stuck = (dist <= 0.0) & (ray_len <= t_min)
        ray_len = jnp.where(done, ray_len, new_len)
        hit_i = hit_i | (accept & ~done).astype(jnp.int32)
        # exact retirements: past t_max, or receding outside the bounding
        # region (the limit set lies within |p - c| < ~725 = sphere radius
        # 300 + offset 424.26; a straight ray past closest approach only
        # moves further out, so acceptance is impossible forever after)
        px = o[0] + d[0] * ray_len - c[0]
        py = o[1] + d[1] * ray_len - c[1]
        pz = o[2] + d[2] * ray_len - c[2]
        receding = (px * d[0] + py * d[1] + pz * d[2]) > 0.0
        outside = (px * px + py * py + pz * pz) > 900.0 * 900.0
        done_i = done_i | (accept | stuck | (new_len >= t_max)
                           | (receding & outside)).astype(jnp.int32)
        return ray_len, done_i, hit_i, k + 1

    zero = jnp.zeros_like(o[0])
    zi = jnp.zeros_like(o[0], dtype=jnp.int32)
    ray_len, _, hit_i, _ = jax.lax.while_loop(
        cond, body, (zero, miss.astype(jnp.int32), zi, jnp.int32(0)))
    return hit_i != 0, ray_len


def _intersect(plan, pk, o, d, time, t_min, t_max):
    """Unrolled closest-hit sweep over every solid group, material merged in.

    Covers rects, spheres, kleins (sphere-traced SDF) and beziers
    (Newton-on-seeds ribbon test); constant media are resolved by the
    caller AFTER this sweep so their scatter interval clips to the closest
    solid hit (geometry.scm:556-557).  Returns dict of per-lane best-hit
    attributes (hit, t, wn, mtype, alb0, alb1, texk, texs, fuzz, ref).
    """
    shp = o[0].shape
    dt = o[0].dtype
    big = jnp.asarray(t_max, dt)
    z = jnp.zeros(shp, dt)
    best = {
        "hit": jnp.zeros(shp, bool), "t": jnp.full(shp, t_max, dt),
        "wn": (z, z, z), "mtype": z, "alb0": (z, z, z), "alb1": (z, z, z),
        "texk": z, "texs": z, "fuzz": z, "ref": z,
    }
    if plan.has_image:
        best["u"] = z
        best["v"] = z

    def merge(best, ok, t, wn, base, a0_off, a1_off, m_off, tk_off,
              fz_off, rf_off, ts_off, uv=None):
        return _merge_rec(pk, best, ok, t, wn, base, a0_off, a1_off, m_off,
                          tk_off, fz_off, rf_off, ts_off, uv)

    def rect_probe(best, b):
        """b = packed base offset of one rect (static OR traced int)."""
        wn_s = _v(pk, b + R_WN)
        dn = dot3(d, wn_s)
        dn_ok = dn != 0.0                          # rays in the rect plane
        dn = jnp.where(dn_ok, dn, 1.0)
        t = (pk[b + R_K] - dot3(o, wn_s)) / dn     # geometry.scm:378-379
        av = _v(pk, b + R_A)
        bv = _v(pk, b + R_B)
        pa = dot3(o, av) + t * dot3(d, av)
        pb = dot3(o, bv) + t * dot3(d, bv)
        ok = (dn_ok & (t >= t_min) & (t <= big) & (pk[b + R_VALID] > 0.5)
              & (pa >= pk[b + R_KA0]) & (pa <= pk[b + R_KA1])
              & (pb >= pk[b + R_KB0]) & (pb <= pk[b + R_KB1]))
        wn = tuple(jnp.broadcast_to(wn_s[i], shp).astype(dt)
                   for i in range(3))
        uv = None
        if plan.has_image:                     # ops/rect.py convention
            uv = ((pa - pk[b + R_KA0]) / (pk[b + R_KA1] - pk[b + R_KA0]),
                  (pb - pk[b + R_KB0]) / (pk[b + R_KB1] - pk[b + R_KB0]))
        return merge(best, ok, t, wn, b, R_ALB0, R_ALB1, R_MTYPE, R_TEXK,
                     R_FUZZ, R_REF, R_TEXS, uv)

    def sphere_probe(best, b):
        """b = packed base offset of one sphere (static OR traced int)."""
        c0 = _v(pk, b + S_C0)
        if plan.has_moving:
            span = pk[b + S_T1] - pk[b + S_T0]
            frac = (time - pk[b + S_T0]) / jnp.where(span == 0.0, 1.0, span)
            c1 = _v(pk, b + S_C1)
            c = tuple(c0[i] + frac * (c1[i] - c0[i]) for i in range(3))
        else:
            c = tuple(jnp.broadcast_to(c0[i], shp).astype(dt)
                      for i in range(3))
        rr = pk[b + S_R]
        oc = sub3(o, c)
        bq = dot3(oc, d)                           # geometry.scm:149-153
        cq = dot3(oc, oc) - rr * rr
        disc = bq * bq - cq
        okd = disc > 0.0
        sq = jnp.sqrt(jnp.where(okd, disc, 1.0))
        t0 = -bq - sq
        t1 = -bq + sq
        in0 = okd & (t0 > t_min) & (t0 < big)
        in1 = okd & (t1 > t_min) & (t1 < big)
        t = jnp.where(in0, t0, jnp.where(in1, t1, big))
        ok = (in0 | in1) & (pk[b + S_VALID] > 0.5)
        # normal (p - c)/r: sign(r) keeps the hollow-dielectric flip
        inv_r = 1.0 / rr
        wn = tuple((o[i] + t * d[i] - c[i]) * inv_r for i in range(3))
        uv = None
        if plan.has_image:
            # ops/sphere.sphere_uv from the OUTWARD unit normal wn*sign(r)
            sgn = jnp.sign(rr)
            nux, nuy, nuz = wn[0] * sgn, wn[1] * sgn, wn[2] * sgn
            phi = jnp.arctan2(nuz, nux)
            theta = jnp.arctan2(
                nuy, jnp.sqrt(jnp.maximum(1.0 - nuy * nuy, 1e-12)))
            uv = (1.0 - (phi + _PI) / (2.0 * _PI),
                  (theta + _PI / 2.0) / _PI)
        return merge(best, ok, t, wn, b, S_ALB0, S_ALB1, S_MTYPE, S_TEXK,
                     S_FUZZ, S_REF, S_TEXS, uv)

    # Small prim groups unroll (constant offsets, best codegen); large
    # groups run a fori_loop with DYNAMIC packed offsets — inside the
    # kernel pk[traced_i] is one scalar load from the whole-array pk ref,
    # and compile size stays O(1) in prim count.  The best["hit"] mask
    # rides the loop carry as int32.
    # CHUNKED: each trip probes SWEEP_CHUNK prims at static sub-offsets
    # (loop trip count n/CHUNK), amortizing the per-iteration loop cost
    # the round-4 one-prim-per-trip form paid (VERDICT r4 #5).  The tail
    # clamps to prim n-1: re-probing the same prim is a no-op under the
    # closest-hit merge (t is equal, the strict < keeps the incumbent).
    def _prim_loop(best, n, probe):
        trips = -(-n // SWEEP_CHUNK)
        def body(i, bst):
            out = dict(bst, hit=bst["hit"] != 0)
            for j in range(SWEEP_CHUNK):
                idx = jnp.minimum(i * SWEEP_CHUNK + j, n - 1)
                out = probe(out, idx)
            return dict(out, hit=out["hit"].astype(jnp.int32))
        best = dict(best, hit=best["hit"].astype(jnp.int32))
        best = jax.lax.fori_loop(0, trips, body, best)
        return dict(best, hit=best["hit"] != 0)

    if plan.n_rects <= UNROLL_MAX:
        for r in range(plan.n_rects):
            best = rect_probe(best, plan.rect_base + r * RECT_SIZE)
    else:
        best = _prim_loop(
            best, plan.n_rects,
            lambda bst, r: rect_probe(bst, plan.rect_base + r * RECT_SIZE))

    def _sphere_sweep_slim(best):
        """Dynamic sphere sweep with a (t, winner-index) carry only.

        The full _prim_loop merge pays 14 lane-wide attribute selects +
        the 3-lane normal per probe; here each probe is just the
        quadratic + 2 selects, and the winner's packed attributes are
        gathered ONCE post-loop from pk at the winner's offset.  Values
        are bitwise the full-merge path's: same t comparisons (strict <,
        first-index ties), same attribute floats, the normal recomputed
        from the same formula and inputs."""
        nsph = plan.n_spheres
        trips = -(-nsph // SWEEP_CHUNK)

        def cand(sidx):
            """(ok, t) for one sphere at traced index sidx."""
            b = plan.sph_base + sidx * SPH_SIZE
            c0 = _v(pk, b + S_C0)
            if plan.has_moving:
                span = pk[b + S_T1] - pk[b + S_T0]
                frac = ((time - pk[b + S_T0])
                        / jnp.where(span == 0.0, 1.0, span))
                c1 = _v(pk, b + S_C1)
                c = tuple(c0[i] + frac * (c1[i] - c0[i]) for i in range(3))
            else:
                c = tuple(jnp.broadcast_to(c0[i], shp).astype(dt)
                          for i in range(3))
            rr = pk[b + S_R]
            oc = sub3(o, c)
            bq = dot3(oc, d)
            cq = dot3(oc, oc) - rr * rr
            disc = bq * bq - cq
            okd = disc > 0.0
            sq = jnp.sqrt(jnp.where(okd, disc, 1.0))
            t0 = -bq - sq
            t1 = -bq + sq
            in0 = okd & (t0 > t_min) & (t0 < big)
            in1 = okd & (t1 > t_min) & (t1 < big)
            t = jnp.where(in0, t0, jnp.where(in1, t1, big))
            ok = (in0 | in1) & (pk[b + S_VALID] > 0.5)
            return ok, t

        def body(i, st):
            t_b, idx_b = st
            for j in range(SWEEP_CHUNK):
                sidx = jnp.minimum(i * SWEEP_CHUNK + j, nsph - 1)
                ok, t = cand(sidx)
                closer = ok & (t < t_b)
                t_b = jnp.where(closer, t, t_b)
                idx_b = jnp.where(closer, sidx, idx_b)
            return t_b, idx_b

        t_w, idx_w = jax.lax.fori_loop(
            0, trips, body, (best["t"], jnp.full(shp, -1, jnp.int32)))
        upd = idx_w >= 0
        wbase = plan.sph_base + jnp.maximum(idx_w, 0) * SPH_SIZE

        def fetch(a):
            """Winner's packed attribute a, per lane (a gather from pk)."""
            return pk[wbase + a]

        if plan.has_moving:
            ft0 = fetch(S_T0)
            span = fetch(S_T1) - ft0
            frac = (time - ft0) / jnp.where(span == 0.0, 1.0, span)
            c = tuple(fetch(S_C0 + i)
                      + frac * (fetch(S_C1 + i) - fetch(S_C0 + i))
                      for i in range(3))
        else:
            c = tuple(fetch(S_C0 + i) for i in range(3))
        rr = fetch(S_R)
        # miss lanes fetch sphere 0: guard the divide so no inf reaches
        # the (masked) normal in reverse mode
        inv_r = 1.0 / jnp.where(upd, rr, 1.0)
        wn = tuple((o[i] + t_w * d[i] - c[i]) * inv_r for i in range(3))
        out = {
            "hit": best["hit"] | upd,
            "t": t_w,
            "wn": where3(upd, wn, best["wn"]),
            "mtype": jnp.where(upd, fetch(S_MTYPE), best["mtype"]),
            "alb0": where3(upd, tuple(fetch(S_ALB0 + i) for i in range(3)),
                           best["alb0"]),
            "alb1": where3(upd, tuple(fetch(S_ALB1 + i) for i in range(3)),
                           best["alb1"]),
            "texk": jnp.where(upd, fetch(S_TEXK), best["texk"]),
            "texs": jnp.where(upd, fetch(S_TEXS), best["texs"]),
            "fuzz": jnp.where(upd, fetch(S_FUZZ), best["fuzz"]),
            "ref": jnp.where(upd, fetch(S_REF), best["ref"]),
        }
        if plan.has_image:
            sgn = jnp.sign(jnp.where(upd, rr, 1.0))
            nux, nuy, nuz = wn[0] * sgn, wn[1] * sgn, wn[2] * sgn
            phi = jnp.arctan2(nuz, nux)
            theta = jnp.arctan2(
                nuy, jnp.sqrt(jnp.maximum(1.0 - nuy * nuy, 1e-12)))
            out["u"] = jnp.where(upd, 1.0 - (phi + _PI) / (2.0 * _PI),
                                 best["u"])
            out["v"] = jnp.where(upd, (theta + _PI / 2.0) / _PI, best["v"])
        return out

    if plan.n_spheres <= UNROLL_MAX:
        for s in range(plan.n_spheres):
            best = sphere_probe(best, plan.sph_base + s * SPH_SIZE)
    elif plan.attr_sweep:
        best = _sphere_sweep_slim(best)
    else:
        best = _prim_loop(
            best, plan.n_spheres,
            lambda bst, s: sphere_probe(bst, plan.sph_base + s * SPH_SIZE))

    def klein_probe(best, b):
        """b = packed base of one klein instance (geometry.scm:635-661).

        The march runs under stop_gradient; the differentiable hit t is
        attached by the implicit-function correction t -= (F - eps)/F'
        at the converged root (F(t) = DE(o + t d)).  ONE primal+3-tangent
        inversion loop (_klein_dist_grad) supplies both the exact surface
        normal AND F' = g . d — replacing the round-4 separate jvp + the
        6-evaluation central-difference normal."""
        c = (pk[b + K_C], pk[b + K_C + 1], pk[b + K_C + 2])
        sg = jax.lax.stop_gradient
        c_s = tuple(sg(x) for x in c)
        o_s = tuple(sg(x) for x in o)
        d_s = tuple(sg(x) for x in d)
        # march bounded by the closest solid hit found so far (the rect +
        # sphere sweeps run first): a klein accept at t >= best_t loses
        # the strict closest-hit merge anyway, so the bound is exact, and
        # it retires wall-bound lanes at their wall instead of letting
        # them crawl through the fractal's small-DE basin behind it —
        # the cornell_klein march-divergence fix (VERDICT r4 #4).
        hitk, t_raw = _klein_march(c_s, o_s, d_s, t_min, sg(best["t"]))

        p_raw = tuple(o[i] + t_raw * d[i] for i in range(3))
        dist, g = _klein_dist_grad(c, *p_raw)
        ddt = g[0] * d[0] + g[1] * d[1] + g[2] * d[2]
        denom = jnp.where(jnp.abs(ddt) > 1e-6, ddt,
                          jnp.where(ddt >= 0.0, 1e-6, -1e-6))
        corr = jnp.where(hitk, (dist - cfg_mod.KLEIN_SURF_EPS) / denom, 0.0)
        t = t_raw - (corr - sg(corr))
        wn = unit3(g)
        ok = hitk & (pk[b + K_VALID] > 0.5)
        return merge(best, ok, t, wn, b, K_ALB0, K_ALB1, K_MTYPE, K_TEXK,
                     K_FUZZ, K_REF, K_TEXS)

    for k in range(plan.n_kleins):
        best = klein_probe(best, plan.kl_base + k * KL_SIZE)

    def bezier_probe(best, b):
        """b = packed base of one bezier ribbon (ops/bezier.py redesign:
        Newton on g'(s)=0 from fixed seeds in ray space, implicit-function
        gradients at the root, normal = -dir per B11)."""
        pick = jnp.abs(d[0]) > 0.9
        a_vec = (jnp.where(pick, 0.0, 1.0), jnp.where(pick, 1.0, 0.0),
                 jnp.zeros_like(d[0]))
        v_f = unit3(cross3(d, a_vec))
        u_f = cross3(v_f, d)
        cxk, cyk, czk = [], [], []
        for k in range(4):
            cp = _v(pk, b + B_CP + 3 * k)
            rel = tuple(cp[i] - o[i] for i in range(3))
            cxk.append(dot3(rel, u_f))
            cyk.append(dot3(rel, v_f))
            czk.append(dot3(rel, d))

        def pcoef(p0, p1, p2, p3):
            return (p0, 3.0 * (p1 - p0), 3.0 * (p0 - 2.0 * p1 + p2),
                    -p0 + 3.0 * p1 - 3.0 * p2 + p3)

        ax, ay, az = pcoef(*cxk), pcoef(*cyk), pcoef(*czk)

        def g_derivs(s):
            cx = ax[0] + s * (ax[1] + s * (ax[2] + s * ax[3]))
            cy = ay[0] + s * (ay[1] + s * (ay[2] + s * ay[3]))
            cx1 = ax[1] + s * (2.0 * ax[2] + s * (3.0 * ax[3]))
            cy1 = ay[1] + s * (2.0 * ay[2] + s * (3.0 * ay[3]))
            cx2 = 2.0 * ax[2] + s * (6.0 * ax[3])
            cy2 = 2.0 * ay[2] + s * (6.0 * ay[3])
            g = cx * cx + cy * cy
            dg = 2.0 * (cx * cx1 + cy * cy1)
            speed2 = 2.0 * (cx1 * cx1 + cy1 * cy1)
            d2g = speed2 + 2.0 * (cx * cx2 + cy * cy2)
            return g, dg, d2g, speed2

        half_w = pk[b + B_W] * 0.5
        hw2 = half_w * half_w
        valid = pk[b + B_VALID] > 0.5
        K = plan.bez_seeds
        sg = jax.lax.stop_gradient

        def seed_body(k, t_best):
            s = jnp.full(shp, 0.0, dt) + (k.astype(dt) + 0.5) * (1.0 / K)
            for _ in range(plan.bez_newton):
                g, dg, d2g, _ = g_derivs(s)
                stepn = jnp.where(d2g > 1e-12,
                                  dg / jnp.where(d2g > 1e-12, d2g, 1e-12),
                                  0.0)
                s = jnp.clip(s - stepn, 0.0, 1.0)
            # implicit-function gradients at the root (ops/bezier.py:95-119):
            # differentiate the ROOT, not the Newton tape; curvature floor
            # bounds the grazing-hit estimator
            s = sg(s)
            _, dg, d2g, speed2 = g_derivs(s)
            interior = (s > 0.0) & (s < 1.0)
            d2g_safe = jnp.maximum(d2g, 0.05 * speed2 + 1e-12)
            corr = jnp.where(interior, dg / d2g_safe, 0.0)
            s = s - (corr - sg(corr))
            g, _, _, _ = g_derivs(s)
            zc = az[0] + s * (az[1] + s * (az[2] + s * az[3]))
            ok = ((g < hw2) & (zc > 1e-4) & (zc > t_min) & (zc <= big)
                  & valid)                       # bezier.scm:161-166
            return jnp.minimum(t_best, jnp.where(ok, zc, big))

        t_curve = jax.lax.fori_loop(0, K, seed_body, jnp.full(shp, big, dt))
        okc = t_curve < big
        wn = (-d[0], -d[1], -d[2])               # B11: normal = -ray dir
        return merge(best, okc, t_curve, wn, b, B_ALB0, B_ALB1, B_MTYPE,
                     B_TEXK, B_FUZZ, B_REF, B_TEXS)

    for j in range(plan.n_beziers):
        best = bezier_probe(best, plan.bez_base + j * BEZ_SIZE)

    return best


def _onb_local(w, x, y, zc):
    """onb.scm:8-16 + local: world vector from local (x, y, zc) about w."""
    pick_y = jnp.abs(w[0]) > 0.9
    a = (jnp.where(pick_y, 0.0, 1.0), jnp.where(pick_y, 1.0, 0.0),
         jnp.zeros_like(w[0]))
    v = unit3(cross3(w, a))
    u = cross3(v, w)
    return tuple(x * u[i] + y * v[i] + zc * w[i] for i in range(3))


def _cosine_dir(u1, u2, w):
    """Cosine-weighted direction about w (util.scm:37-44, B4 fixed)."""
    phi = _TWO_PI * u1
    sr2 = jnp.sqrt(u2)
    zc = jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))
    return unit3(_onb_local(w, jnp.cos(phi) * sr2, jnp.sin(phi) * sr2, zc))


def _cosine_value(n, d):
    return jnp.maximum(dot3(n, d), 0.0) * (1.0 / _PI)


def _lights_sample(plan, pk, u_pick, u_a, u_b, u_s1, u_s2, p):
    """SoA pdfs.lights_sample_u: direction toward one chosen light."""
    shp = p[0].shape
    dt = p[0].dtype
    out = (jnp.zeros(shp, dt), jnp.zeros(shp, dt), jnp.ones(shp, dt))
    nl = plan.n_lights
    scaled = u_pick * nl
    for l in range(nl):
        b = plan.lgt_base + l * LGT_SIZE
        sel = (scaled >= l) & ((scaled < l + 1) | (l == nl - 1))
        is_rect = pk[b + L_KIND] < 0.5              # LIGHT_XZ_RECT == 0
        px = pk[b + L_X0] + u_a * (pk[b + L_X1] - pk[b + L_X0])
        pz = pk[b + L_Z0] + u_b * (pk[b + L_Z1] - pk[b + L_Z0])
        target = (px, jnp.broadcast_to(pk[b + L_KY], shp).astype(dt), pz)
        rect_dir = unit3(sub3(target, p), eps=1e-12)

        c = _v(pk, b + L_C)
        oc = sub3(c, p)
        dist_sq = jnp.maximum(dot3(oc, oc), 1e-12)
        radius = pk[b + L_RAD]
        inner = 1.0 - radius * radius / dist_sq
        outside = inner > 0.0
        ctm = jnp.where(outside, jnp.sqrt(jnp.where(outside, inner, 1.0)),
                        0.0)
        zc = 1.0 + u_s2 * (ctm - 1.0)
        phi = _TWO_PI * u_s1
        zin = 1.0 - zc * zc
        z_ok = zin > 0.0
        sz = jnp.where(z_ok, jnp.sqrt(jnp.where(z_ok, zin, 1.0)), 0.0)
        sph_dir = unit3(_onb_local(unit3(oc), jnp.cos(phi) * sz,
                                   jnp.sin(phi) * sz, zc))
        out = where3(sel, where3(is_rect, rect_dir, sph_dir), out)
    return out


def _lights_value(plan, pk, p, d):
    """SoA pdfs.lights_value: mean hittable-PDF value over the lights."""
    shp = p[0].shape
    total = jnp.zeros(shp, p[0].dtype)
    for l in range(plan.n_lights):
        b = plan.lgt_base + l * LGT_SIZE
        is_rect = pk[b + L_KIND] < 0.5
        # xz-rect (RTROYL 12.1; guards mirror pdfs._rect_value_one)
        dy_ok = jnp.abs(d[1]) > 1e-9
        t_raw = (pk[b + L_KY] - p[1]) / jnp.where(dy_ok, d[1], 1.0)
        hx = p[0] + t_raw * d[0]
        hz = p[2] + t_raw * d[2]
        inside = (dy_ok & (t_raw > 1e-3) & (t_raw < 1e8)
                  & (hx >= pk[b + L_X0]) & (hx <= pk[b + L_X1])
                  & (hz >= pk[b + L_Z0]) & (hz <= pk[b + L_Z1]))
        t = jnp.where(inside, t_raw, 1.0)
        area = (pk[b + L_X1] - pk[b + L_X0]) * (pk[b + L_Z1] - pk[b + L_Z0])
        denom = jnp.where(inside, jnp.maximum(jnp.abs(d[1]) * area, 1e-12),
                          1.0)
        rect_v = jnp.where(inside, t * t / denom, 0.0)
        # sphere (RTROYL 12.2)
        c = _v(pk, b + L_C)
        oc = sub3(c, p)
        dist_sq = dot3(oc, oc)
        radius = pk[b + L_RAD]
        outside = dist_sq > radius * radius
        ratio = jnp.clip(radius * radius / jnp.maximum(dist_sq, 1e-12),
                         0.0, 1.0)
        ctm = jnp.sqrt(jnp.where(outside, 1.0 - ratio, 1.0))
        solid = _TWO_PI * (1.0 - ctm)
        cos_dir = dot3(unit3(d), unit3(oc))
        hitting = outside & (cos_dir >= ctm)
        sph_v = jnp.where(hitting, 1.0 / jnp.maximum(solid, 1e-12), 0.0)
        total = total + jnp.where(is_rect, rect_v, sph_v)
    return total * (1.0 / plan.n_lights)


def _media_scatter(plan, pk, gitem, depth, o, d, rec):
    """Constant-medium scatter events (geometry.scm:545-578), fused.

    Probes each medium's boundary interval (oriented 3-slab box or
    sphere), clips it to the closest solid hit (geometry.scm:556-557 via
    `rec`), and scatters at the exponential distance -ln(xi)/rho drawn
    from the SAME GROUP_MEDIUM counter-hash columns as the general pool
    (integrator/pool.py:136-139) — identical estimator.  A scatter
    overrides the solid record: normal=(1,0,0), phase material merged in
    (geometry.scm:546,571-573)."""
    shp = o[0].shape
    dt = o[0].dtype
    big = cfg_mod.BIG
    tiny = jnp.finfo(dt).tiny
    t_clip = jnp.where(rec["hit"], rec["t"], big)
    u_med = rng.hash_uniforms_tuple(plan.seed, gitem, depth, plan.n_media,
                                    dt, group_base=rng.GROUP_MEDIUM)
    one = jnp.ones(shp, dt)
    zero = jnp.zeros(shp, dt)
    for mi in range(plan.n_media):
        b = plan.med_base + mi * MED_SIZE
        is_box = pk[b + M_KIND] < 0.5
        en = jnp.full(shp, -cfg_mod.BIG, dt)
        ex = jnp.full(shp, cfg_mod.BIG, dt)
        for a in range(3):
            ab = b + M_AX + a * 5
            u_ax = _v(pk, ab)
            pa = dot3(o, u_ax)
            da = dot3(d, u_ax)
            # parallel-ray guard (the general path divides by zero into
            # IEEE infs; the guarded form keeps the backward NaN-free)
            da_ok = jnp.abs(da) > 1e-12
            inv = 1.0 / jnp.where(da_ok, da, 1.0)
            ta = (pk[ab + 3] - pa) * inv
            tb = (pk[ab + 4] - pa) * inv
            lo_t = jnp.minimum(ta, tb)
            hi_t = jnp.maximum(ta, tb)
            inside = (pa >= pk[ab + 3]) & (pa <= pk[ab + 4])
            lo_t = jnp.where(da_ok, lo_t, jnp.where(inside, -big, big))
            hi_t = jnp.where(da_ok, hi_t, jnp.where(inside, big, -big))
            en = jnp.maximum(en, lo_t)
            ex = jnp.minimum(ex, hi_t)
        box_ok = en < ex
        c = _v(pk, b + M_C)
        oc = sub3(o, c)
        bq = dot3(oc, d)
        rr = pk[b + M_RAD]
        cq = dot3(oc, oc) - rr * rr
        disc = bq * bq - cq
        sph_ok = disc > 0.0
        sq = jnp.sqrt(jnp.where(sph_ok, disc, 1.0))
        entry = jnp.where(is_box, en, -bq - sq)
        exit_ = jnp.where(is_box, ex, -bq + sq)
        mok = (((is_box & box_ok) | (~is_box & sph_ok))
               & (pk[b + M_VALID] > 0.5))
        t1 = jnp.maximum(jnp.maximum(entry, cfg_mod.SHADOW_EPS), 0.0)
        t2 = jnp.minimum(exit_, t_clip)                # geometry.scm:556-557
        mok = mok & (t1 < t2)
        xi = jnp.maximum(u_med[mi], tiny)              # log(0) guard
        hit_dist = pk[b + M_NID] * jnp.log(xi)         # geometry.scm:562-564
        mok = mok & (hit_dist < (t2 - t1))
        t_med = t1 + hit_dist
        rec = _merge_rec(pk, rec, mok, t_med, (one, zero, zero), b,
                         M_ALB0, M_ALB1, M_MTYPE, M_TEXK, M_FUZZ, M_REF,
                         M_TEXS)
    return rec


def step(plan: BouncePlan, pk, gitem, px, py, fresh, alive, depth,
         o, d, time, rad, tp):
    """One fused pool iteration: regen fresh lanes, trace, shade.

    All args lane-shaped (any shape); o/d/rad/tp are (x,y,z) tuples.
    Returns (o', d', time', rad', tp', scattering) — the caller (pool glue)
    handles termination bookkeeping, the work queue, and the framebuffer.
    With image textures, `pk` is the (scalar buffer, texel atlas) pair
    from pack().
    """
    imgtex = None
    if plan.has_image:
        pk, imgtex = pk
    dt = px.dtype
    # --- regenerate fresh lanes (camera rays; main.scm:452-469) -----------
    u_cam = rng.hash_uniforms_tuple(plan.seed, gitem, rng.CAMERA_DEPTH, 5,
                                    dt)
    o_f, d_f, time_f = _camera_ray(plan, pk, u_cam, px, py)
    o = where3(fresh, o_f, o)
    d = where3(fresh, d_f, d)
    time = jnp.where(fresh, time_f, time)
    zero = jnp.zeros_like(px)
    rad = where3(fresh, (zero, zero, zero), rad)
    one = jnp.ones_like(px)
    tp = where3(fresh, (one, one, one), tp)

    # --- closest hit (geometry.scm:33-50) ----------------------------------
    rec = _intersect(plan, pk, o, d, time, cfg_mod.SHADOW_EPS, cfg_mod.BIG)
    if plan.n_media:
        rec = _media_scatter(plan, pk, gitem, depth, o, d, rec)
    hit = rec["hit"]
    t_eff = jnp.where(hit, rec["t"], 0.0)          # miss: p = o (sanitized)
    p = tuple(o[i] + t_eff * d[i] for i in range(3))
    wn = where3(hit, rec["wn"], (zero, one, zero))

    # --- sky on miss (main.scm:91-98) ---------------------------------------
    sky_t = 0.5 * (d[1] + 1.0)                     # d is unit
    sky_a, sky_b = _v(pk, H_SKY_A), _v(pk, H_SKY_B)
    sky = tuple((1.0 - sky_t) * sky_a[i] + sky_t * sky_b[i] for i in range(3))
    missed = alive & ~hit
    rad = tuple(rad[i] + jnp.where(missed, tp[i] * sky[i], 0.0)
                for i in range(3))

    # --- texture (texture.scm:12-34) ----------------------------------------
    texk = rec["texk"]
    sines = jnp.sin(10.0 * p[0]) * jnp.sin(10.0 * p[1]) * jnp.sin(10.0 * p[2])
    use1 = (texk == float(sb.TEX_CHECKER)) & (sines < 0.0)
    alb = where3(use1, rec["alb1"], rec["alb0"])
    if plan.has_perlin:
        # hash perlin computed in register (scene/perlin.py is SoA — the
        # same PCG4D recurrence as the RNG, no table gathers)
        from ..scene import perlin as perlin_mod
        ts = rec["texs"]
        gray_n = perlin_mod.noise_xyz(plan.perlin_seed, p[0] * ts,
                                      p[1] * ts, p[2] * ts)
        gray_m = 0.5 * (1.0 + jnp.sin(
            ts * p[2] + 10.0 * perlin_mod.turb_xyz(plan.perlin_seed,
                                                   p[0], p[1], p[2])))
        alb = where3(texk == float(sb.TEX_NOISE),
                     (gray_n, gray_n, gray_n), alb)
        alb = where3(texk == float(sb.TEX_MARBLE),
                     (gray_m, gray_m, gray_m), alb)

    if plan.has_image:
        # texture.scm:36-50 — clamped nearest lookup, v flipped.  The
        # image-textured prims carry (iw, ih, first_atlas_row) in their
        # alb0 slots (_mat_fields); the texel lives at flat index
        # j*iw + i of channel plane c, whose first atlas row is
        # base + c*nchunks: one gather per channel.
        is_img = texk == float(sb.TEX_IMAGE)
        iw_f, ih_f, cb_f = rec["alb0"]
        ii = jnp.clip(rec["u"] * iw_f, 0.0,
                      jnp.maximum(iw_f - 1.0, 0.0)).astype(jnp.int32)
        jj = jnp.clip((1.0 - rec["v"]) * ih_f - 0.001, 0.0,
                      jnp.maximum(ih_f - 1.0, 0.0)).astype(jnp.int32)
        flat = jj * iw_f.astype(jnp.int32) + ii
        nck = ((iw_f * ih_f).astype(jnp.int32) + 127) // 128
        cb = cb_f.astype(jnp.int32)
        # non-image lanes hold colors in alb0: their index is sanitized to
        # 0 so the gather stays inside the atlas
        texel = tuple(
            imgtex[jnp.where(is_img, (cb + ch * nck) * 128 + flat, 0)]
            for ch in range(3))
        alb = where3(is_img, texel, alb)

    # --- emission (material.scm:103-111) ------------------------------------
    mtype = rec["mtype"]
    is_light = mtype == float(ob.MAT_DIFFUSE_LIGHT)
    front = dot3(wn, d) < 0.0
    hit_live = alive & hit
    emit_m = hit_live & is_light & front
    rad = tuple(rad[i] + jnp.where(emit_m, tp[i] * alb[i], 0.0)
                for i in range(3))

    # --- shade uniforms ------------------------------------------------------
    u = rng.hash_uniforms_tuple(plan.seed, gitem, depth, 12, dt)

    # --- lambertian (material.scm:24-39; mixture pdf per pdf.scm intent) ---
    if plan.light_sampling:
        use_light = u[2] < 0.5
        d_cos = _cosine_dir(u[0], u[1], wn)
        d_light = _lights_sample(plan, pk, u[3], u[4], u[5], u[6], u[7], p)
        lam_dir = where3(use_light, d_light, d_cos)
        pdf = 0.5 * _cosine_value(wn, lam_dir) + 0.5 * _lights_value(
            plan, pk, p, lam_dir)
        s_pdf = _cosine_value(wn, lam_dir)
        ratio = s_pdf / jnp.maximum(pdf, 1e-12)
        lam_mult = scale3(alb, ratio)
        lam_ok = pdf > 0.0
    else:
        lam_dir = _cosine_dir(u[0], u[1], wn)
        lam_mult = alb
        lam_ok = jnp.ones_like(hit)

    # --- unit ball draw (metal fuzz; util.scm:9-15 analytic) ----------------
    bz = 2.0 * u[9] - 1.0
    bphi = _TWO_PI * u[10]
    br = jnp.cbrt(u[11])
    bs = jnp.sqrt(jnp.maximum(1.0 - bz * bz, 0.0))
    ball = (br * bs * jnp.cos(bphi), br * bs * jnp.sin(bphi), br * bz)

    # --- metal (material.scm:45-57) ------------------------------------------
    refl = sub3(d, scale3(wn, 2.0 * dot3(d, wn)))
    fuzzed = add3(refl, scale3(ball, rec["fuzz"]))
    metal_ok = dot3(fuzzed, wn) > 0.0
    metal_dir = unit3(fuzzed)

    # --- dielectric (material.scm:76-101) ------------------------------------
    ref_idx = rec["ref"]
    dd = dot3(d, wn)
    exiting = dd > 0.0
    own = where3(exiting, scale3(wn, -1.0), wn)
    ni_over_nt = jnp.where(exiting, ref_idx,
                           1.0 / jnp.where(ref_idx == 0.0, 1.0, ref_idx))
    cosine = jnp.where(exiting, dd * ref_idx, -dd)
    dtn = dot3(d, own)                              # d is unit
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dtn * dtn)
    refr_ok = disc > 0.0
    safe = jnp.sqrt(jnp.where(refr_ok, disc, 1.0))
    refr = tuple(ni_over_nt * (d[i] - own[i] * dtn) - own[i] * safe
                 for i in range(3))
    r0 = (1.0 - ref_idx) / (1.0 + jnp.where(ref_idx == -1.0, 1.0, ref_idx))
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * jnp.power(jnp.maximum(1.0 - cosine, 0.0),
                                          5.0)
    reflect_prob = jnp.where(refr_ok, schlick, 1.0)
    take_refl = u[8] < reflect_prob
    diel_dir = unit3(where3(take_refl, refl, refr))

    # --- combine (B3-fixed full protocol; shade.py contract) ----------------
    is_lam = mtype == float(ob.MAT_LAMBERTIAN)
    is_metal = mtype == float(ob.MAT_METAL)
    is_diel = mtype == float(ob.MAT_DIELECTRIC)
    direction = where3(is_lam, lam_dir,
                       where3(is_metal, metal_dir, diel_dir))
    mult = where3(is_diel, (one, one, one),
                  where3(is_lam, lam_mult, alb))
    sc_ok = (is_lam & lam_ok) | (is_metal & metal_ok) | is_diel
    scattering = hit_live & sc_ok & (depth < plan.max_depth)

    tp = where3(scattering, mul3(tp, mult), tp)
    o = where3(scattering, p, o)
    d = where3(scattering, direction, d)
    return o, d, time, rad, tp, scattering


# ---------------------------------------------------------------------------
# Pallas kernels on the Triton route: the SAME step traced onto lane blocks
# ---------------------------------------------------------------------------

# Lanes per program and warps per program of the bounce kernels: 1-D
# power-of-two lane blocks, one lane per thread at 128 lanes x 4 warps.
# Read at trace time (tools/kernel_ab.py --sweep sets them).
BLOCK_LANES = 128
NUM_WARPS = 4


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pow2_pad(x):
    """Zero-pad a 1-D array to a power-of-two length (Triton block rule)."""
    return jnp.pad(x, (0, _pow2(x.shape[0]) - x.shape[0]))


def _block_lanes(m: int, block: int) -> int:
    """Largest power of two <= block that divides the pool size m."""
    while m % block:
        block //= 2
    return block


def _lane_call(kernel, m, whole, lanes, out_dtypes, interpret, name,
               row_out=None):
    """pallas_call on the Triton route over an m-lane pool.

    `whole` arrays (pk, the texel atlas) are read whole by every program;
    `lanes` and the outputs are [m] arrays cut into power-of-two blocks.
    `row_out=(width, dtype)` adds a first output of one row per program."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    b = _block_lanes(m, BLOCK_LANES)
    grid = (m // b,)
    # under shard_map the outputs inherit the lane inputs' varying-mesh-
    # axes type; pallas_call requires it stated explicitly
    vma = getattr(jax.typeof(lanes[0]), "vma", None) or None
    lane_spec = pl.BlockSpec((b,), lambda i: (i,))
    out_specs = [lane_spec] * len(out_dtypes)
    out_shape = [jax.ShapeDtypeStruct((m,), dt, vma=vma) for dt in out_dtypes]
    if row_out is not None:
        width, dt = row_out
        out_specs = [pl.BlockSpec((1, width), lambda i: (i, 0))] + out_specs
        out_shape = ([jax.ShapeDtypeStruct((grid[0], width), dt, vma=vma)]
                     + out_shape)
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=([pl.BlockSpec(w.shape, lambda i: (0,)) for w in whole]
                  + [lane_spec] * len(lanes)),
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name=name,
    )(*whole, *lanes)


def _lane_inputs(gitem, px, py, fresh, alive, depth, o, d, time, rad, tp):
    return [gitem, px, py, fresh.astype(jnp.int32),
            alive.astype(jnp.int32), depth, *o, *d, time, *rad, *tp]


def _read_lanes(refs):
    """Kernel-side inverse of _lane_inputs: step's lane arguments."""
    v = [r[...] for r in refs]
    return (v[0], v[1], v[2], v[3] != 0, v[4] != 0, v[5],
            tuple(v[6:9]), tuple(v[9:12]), v[12], tuple(v[13:16]),
            tuple(v[16:19]))


def _step_outputs(outs):
    """[o(3), d(3), time, rad(3), tp(3)] flat list -> step's tuples."""
    return (tuple(outs[0:3]), tuple(outs[3:6]), outs[6], tuple(outs[7:10]),
            tuple(outs[10:13]))


def as_pallas(plan: BouncePlan, m: int, interpret: bool = False):
    """Wrap `step` as a Pallas kernel (Triton route) over an m-lane pool.

    One program per block of lanes runs regen + the whole closest-hit
    sweep + shading, so a lane's state stays in registers for the bounce
    and each inner loop (klein march, bezier Newton, prim sweep) exits per
    block rather than over the whole pool.  Returns a function with
    `step`'s exact signature (pk and lane arrays as flat [m] jnp arrays),
    so the pool glue is oblivious to which path runs.  `interpret=True`
    runs the kernel in interpreter mode (CPU tests).
    """
    assert fwd_kernel_covers(plan), plan
    assert m % 128 == 0, m

    def kernel(*refs):
        # step reads pk as pk[i]: on the whole-array ref, an int i (static,
        # or a traced scalar in the prim loops) is one scalar load, served
        # from L1/L2 since every program reads the same few hundred
        # floats; an int array is a gather load
        if plan.has_image:
            pk, refs = (refs[0], refs[1]), refs[2:]
        else:
            pk, refs = refs[0], refs[1:]
        o, d, time, rad, tp, scattering = step(plan, pk,
                                               *_read_lanes(refs[:19]))
        for r, v in zip(refs[19:], [*o, *d, time, *rad, *tp,
                                    scattering.astype(jnp.int32)]):
            r[...] = v

    def stepfn(plan_, pk, gitem, px, py, fresh, alive, depth, o, d, time,
               rad, tp):
        whole = list(pk) if plan.has_image else [pk]
        dt = px.dtype
        outs = _lane_call(
            kernel, m, [_pow2_pad(w) for w in whole],
            _lane_inputs(gitem, px, py, fresh, alive, depth, o, d, time,
                         rad, tp),
            [dt] * 13 + [jnp.int32], interpret, "bounce_fwd")
        return (*_step_outputs(outs), outs[13] != 0)

    return stepfn


# Forward-kernel routing bounds: the exotic groups are unrolled in the
# kernel (one copy of the medium / klein march / bezier Newton code per
# prim), so kernel size and compile time grow with their counts.  Plans
# past a bound run the jnp step (a bezier chain from points.load_bezier_chain
# has one bezier per segment).  Carried over from the earlier accelerator;
# compile time at the bounds is checked by chip_smoke.py on the card.
KERNEL_MAX_MEDIA = 16
KERNEL_MAX_KLEINS = 2
KERNEL_MAX_BEZIERS = 8


def fwd_kernel_covers(plan: BouncePlan) -> bool:
    """True when the forward kernel runs this plan (decided from the
    plan's counts, never from a compile attempt)."""
    return (plan.n_media <= KERNEL_MAX_MEDIA
            and plan.n_kleins <= KERNEL_MAX_KLEINS
            and plan.n_beziers <= KERNEL_MAX_BEZIERS)


def vjp_kernel_covers(plan: BouncePlan) -> bool:
    """True when the custom-VJP kernel can replay this plan.

    The backward kernel traces `jax.vjp(step)` with pk as a tuple of
    scalars, so every pk read must be at a static offset (no fori prim
    sweep, no slim sphere sweep, no texel gather), and the transposed
    step may hold no loop with per-iteration residuals (the klein DE
    gradient loop and the bezier seed loop would need them)."""
    return (fwd_kernel_covers(plan) and not plan.has_image
            and not plan.n_kleins and not plan.n_beziers
            and plan.n_rects <= UNROLL_MAX and plan.n_spheres <= UNROLL_MAX)


def as_pallas_bwd(plan: BouncePlan, m: int, interpret: bool = False):
    """Backward kernel for `step`: recompute + transpose in ONE kernel.

    Given the step's INPUTS and the cotangents of its five float outputs
    (o', d', time', rad', tp'), returns cotangents for (pk, o, d, time,
    rad, tp).  Each program replays the forward `step` on its block and
    transposes it (`jax.vjp` traced inside the kernel), so the residuals
    never touch device memory.  Each pk scalar's cotangent is a reduction
    over the block's lanes; each program writes its own row of partials,
    summed outside the kernel, so nothing carries across blocks.
    """
    assert vjp_kernel_covers(plan), plan
    assert m % 128 == 0, m
    P = plan.size

    def kernel(pk_ref, *refs):
        lanes = _read_lanes(refs[:19])
        cts = _step_outputs([r[...] for r in refs[19:32]])
        o_dpk, lane_out = refs[32], refs[33:]
        pk = tuple(pk_ref[i] for i in range(P))
        gitem, px, py, fresh, alive, depth = lanes[:6]

        def f(pk_t, o, d, time, rad, tp):
            return step(plan, pk_t, gitem, px, py, fresh, alive, depth,
                        o, d, time, rad, tp)[:5]

        _, vjp = jax.vjp(f, pk, *lanes[6:])
        dpk, do, dd, dtm, dr, dtp = vjp(cts)
        for i in range(P):
            o_dpk[0, i] = dpk[i]
        for r, v in zip(lane_out, [*do, *dd, dtm, *dr, *dtp]):
            r[...] = v

    def bwdfn(pk, gitem, px, py, fresh, alive, depth, o, d, time, rad, tp,
              ct_o, ct_d, ct_time, ct_rad, ct_tp):
        dt = px.dtype
        outs = _lane_call(
            kernel, m, [_pow2_pad(pk)],
            _lane_inputs(gitem, px, py, fresh, alive, depth, o, d, time,
                         rad, tp) + [*ct_o, *ct_d, ct_time, *ct_rad, *ct_tp],
            [dt] * 13, interpret, "bounce_bwd", row_out=(_pow2(P), dt))
        d_pk = jnp.sum(outs[0][:, :P], axis=0)
        return (d_pk, *_step_outputs(outs[1:]))

    return bwdfn


def as_pallas_vjp(plan: BouncePlan, m: int, interpret: bool = False):
    """`step` with a jax.custom_vjp: kernel forward AND kernel backward.

    The diff pool's scan differentiates through this step with residuals
    = the step's own inputs (the pool carry — no per-intermediate tape).
    Same signature as `step`; grads flow to pk / o / d / time / rad / tp;
    px / py get zeros (pixel coordinates), int/bool lanes get float0.
    """
    fwd = as_pallas(plan, m, interpret)
    bwd = as_pallas_bwd(plan, m, interpret)

    @jax.custom_vjp
    def cv(pk, o, d, time, rad, tp, px, py, gitem, fresh, alive, depth):
        return fwd(plan, pk, gitem, px, py, fresh, alive, depth,
                   o, d, time, rad, tp)

    def cv_fwd(pk, o, d, time, rad, tp, px, py, gitem, fresh, alive, depth):
        out = cv(pk, o, d, time, rad, tp, px, py, gitem, fresh, alive,
                 depth)
        return out, (pk, o, d, time, rad, tp, px, py, gitem, fresh, alive,
                     depth)

    def cv_bwd(res, cts):
        pk, o, d, time, rad, tp, px, py, gitem, fresh, alive, depth = res
        ct_o, ct_d, ct_time, ct_rad, ct_tp, _ = cts   # scattering: float0
        d_pk, d_o, d_d, d_time, d_rad, d_tp = bwd(
            pk, gitem, px, py, fresh, alive, depth, o, d, time, rad, tp,
            ct_o, ct_d, ct_time, ct_rad, ct_tp)
        f0 = lambda x: np.zeros(np.shape(x), jax.dtypes.float0)
        return (d_pk, d_o, d_d, d_time, d_rad, d_tp,
                jnp.zeros_like(px), jnp.zeros_like(py),
                f0(gitem), f0(fresh), f0(alive), f0(depth))

    cv.defvjp(cv_fwd, cv_bwd)

    def stepfn(plan_, pk, gitem, px, py, fresh, alive, depth, o, d, time,
               rad, tp):
        return cv(pk, o, d, time, rad, tp, px, py, gitem, fresh, alive,
                  depth)

    return stepfn
