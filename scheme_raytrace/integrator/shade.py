"""Masked material shading: scatter + emit for a whole ray batch at once.

The reference dispatches per-hit through closure vtables (material.scm:15-22)
with two incompatible layouts (metal/dielectric are RTIOW-era 2-closure —
bug B3 — so the committed integrator only supports lambertian/diffuse-light
scenes).  Here every material implements the full protocol uniformly:
specular materials are delta distributions whose s_pdf/pdf ratio is
identically 1, so `throughput *= albedo` with no pdf division — this is the
documented B3 fix that makes the RTOW-final config renderable.

All branches are computed masked and select-combined: materials are a few
vector ops each, far cheaper than sorting/compacting by type.  The
EP-style alternative (SURVEY §2.4) exists as `shade_sorted` below
(RenderConfig.material_sort); it measured slower than masked on the
earlier accelerator, because a select runs every branch for every lane
regardless of order.  Not measured on H100 (tools/bench_material_sort.py).

Randomness arrives as an explicit [N, N_U] uniform matrix (column layout
below) so the caller chooses the stream: jax.random keyed per
(pass, bounce) on the differentiable path, or the counter hash
(core/rng.hash_uniforms) keyed per (work-item, bounce) on the regeneration
pool / kernel paths, where draws must not depend on loop-iteration timing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..ops import sampling, texture
from ..scene import objects as ob
from . import pdfs

# --- uniform-matrix column layout -------------------------------------------
U_COS_R1, U_COS_R2 = 0, 1             # lambertian cosine draw
U_MIX_PICK = 2                         # mixture cosine-vs-light pick
U_LIGHT_PICK = 3                       # which light
U_RECT_A, U_RECT_B = 4, 5              # rect light point
U_SPH_R1, U_SPH_R2 = 6, 7              # sphere solid-angle draw
U_DIEL = 8                             # dielectric reflect/refract branch
U_BALL_R1, U_BALL_R2, U_BALL_R3 = 9, 10, 11   # unit-ball draw (fuzz/isotropic
                                               # — exclusive per material, shared)
N_U = 12


class Scatter(NamedTuple):
    alive: jnp.ndarray       # [N] continues bouncing
    direction: jnp.ndarray   # [N,3] unit next direction
    mult: jnp.ndarray        # [N,3] throughput multiplier
    emitted: jnp.ndarray     # [N,3]


def shade(u, scene, config, d, rec):
    """One bounce of material evaluation for rays d hitting at `rec`.

    u: [N, N_U] uniform draws; d: [N,3] unit incoming directions;
    rec: HitRec.  Valid only where rec.hit — caller masks with the alive set.
    """
    n_rays = d.shape[0]
    mtype = scene.mat_type[rec.mat]
    albedo = texture.value(scene, scene.mat_tex[rec.mat], rec.u, rec.v, rec.p)
    normal = rec.normal

    # --- emission (material.scm:103-111): front face only -----------------
    is_light = mtype == ob.MAT_DIFFUSE_LIGHT
    front = vm.dot(normal, d) < 0.0
    emitted = jnp.where((is_light & front)[:, None], albedo,
                        jnp.zeros_like(albedo))

    # --- lambertian (material.scm:24-39) -----------------------------------
    # cosine importance sampling => attenuation * s_pdf/pdf == attenuation;
    # with light-sampling the mixture pdf splits them (main.scm:113-118).
    if config.light_sampling and scene.n_lights > 0:
        lam_dir, pdf = pdfs.mixture_sample_and_value_u(u, scene, normal,
                                                       rec.p)
        s_pdf = pdfs.cosine_value(normal, lam_dir)     # material.scm:33-36
        ratio = s_pdf / jnp.maximum(pdf, 1e-12)
        lam_mult = albedo * ratio[:, None]
        lam_ok = pdf > 0.0
    else:
        lam_dir = pdfs.cosine_sample_u(u[:, U_COS_R1], u[:, U_COS_R2], normal)
        lam_mult = albedo
        lam_ok = jnp.ones(n_rays, bool)

    # --- unit-ball draw (metal fuzz / isotropic phase — exclusive) ---------
    ball = sampling.in_unit_sphere_u(u[:, U_BALL_R1], u[:, U_BALL_R2],
                                     u[:, U_BALL_R3])

    # --- isotropic phase (geometry.scm:546 commented alternative) ----------
    iso_dir = vm.unit(ball, eps=1e-12)

    # --- metal (material.scm:45-57) ----------------------------------------
    refl = vm.reflect(d, normal)
    fuzzed = refl + scene.mat_fuzz[rec.mat][:, None] * ball
    metal_ok = vm.dot(fuzzed, normal) > 0.0
    metal_dir = vm.unit(fuzzed, eps=1e-12)

    # --- dielectric (material.scm:76-101) -----------------------------------
    ref_idx = scene.mat_ref[rec.mat]
    dd = vm.dot(d, normal)
    exiting = dd > 0.0
    outward_n = vm.where3(exiting, -normal, normal)
    ni_over_nt = jnp.where(exiting, ref_idx, 1.0 / ref_idx)
    cosine = jnp.where(exiting, dd * ref_idx, -dd)     # |d| == 1
    refr_ok, refracted = vm.refract(d, outward_n, ni_over_nt)
    reflect_prob = jnp.where(refr_ok, vm.schlick(cosine, ref_idx), 1.0)
    take_refl = u[:, U_DIEL] < reflect_prob
    diel_dir = vm.unit(vm.where3(take_refl, refl, refracted), eps=1e-12)

    # --- combine ------------------------------------------------------------
    is_lam = mtype == ob.MAT_LAMBERTIAN
    is_metal = mtype == ob.MAT_METAL
    is_diel = mtype == ob.MAT_DIELECTRIC
    is_iso = mtype == ob.MAT_ISOTROPIC

    direction = vm.where3(is_lam, lam_dir,
                vm.where3(is_metal, metal_dir,
                vm.where3(is_diel, diel_dir, iso_dir)))
    mult = jnp.where(is_diel[:, None], jnp.ones_like(albedo),
                     jnp.where(is_lam[:, None], lam_mult, albedo))
    alive = ((is_lam & lam_ok) | (is_metal & metal_ok) | is_diel | is_iso)
    return Scatter(alive, direction, mult, emitted)


def shade_sorted(u, scene, config, d, rec):
    """EP-analogue material-sorted dispatch (SURVEY §2.4 row 3: "EP ≙
    material-sorted dispatch, each 'expert' = a material kernel"; §5.7's
    Ulysses analogue "re-sorting rays by material locality").

    Lanes are ranked by the hit material's type, gathered into
    material-major order, shaded by the same kernel, and scattered back.
    shade() is purely elementwise over lanes, so permuting lanes commutes
    with it EXACTLY — the sorted path is bit-identical to the masked path
    (tests/test_render.py::test_material_sorted_shading_bit_identical).

    Why this is an experiment and not the default: in XLA's static-shape
    SPMD model a sort cannot skip per-lane work — `where`/select evaluates
    every material branch for every lane regardless of order, and dynamic
    per-material block sizes are untileable — so sorting can only pay
    through memory locality, against the cost of one sort + two gathers.
    Masked won the A/B on the earlier accelerator; not measured on H100
    (tools/bench_material_sort.py).  Enable via
    RenderConfig.material_sort=True.
    """
    mtype = scene.mat_type[rec.mat]
    order = jnp.argsort(mtype, stable=True)
    inv = jnp.argsort(order, stable=True)
    gather = lambda x: jnp.take(x, order, axis=0)
    sc = shade(gather(u), scene, config, gather(d),
               jax.tree.map(gather, rec))
    return jax.tree.map(lambda x: jnp.take(x, inv, axis=0), sc)


def shade_uniforms(key, n_rays, dtype):
    """Key-derived [N, N_U] uniform matrix (differentiable-path stream)."""
    return jax.random.uniform(key, (n_rays, N_U), dtype)
