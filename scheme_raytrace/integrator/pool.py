"""Regeneration-pool wavefront: the occupancy-preserving fast forward path.

The plain wavefront (wavefront.py) traces one full-frame pass at a time and
iterates until EVERY ray has terminated — in a Cornell box most rays die
within a few bounces, so late iterations run a nearly-empty pool and the
chip idles.  Here the pool holds a fixed
M rays; the moment a ray terminates its radiance is scatter-added into the
framebuffer and the lane is immediately re-issued the next (pixel, sample)
work item, so occupancy stays ~100% until the whole frame's work drains.
This is the persistent-threads/wavefront formulation of the reference's
scanline loops (main.scm:452-491) — same estimator, no idle lanes.

Randomness is the counter hash (core/rng.hash_uniforms) keyed by the
ABSOLUTE work item (sample_count offset included), bounce depth, and call
site — never by pool-iteration index — so renders are deterministic,
resumable mid-frame, and shard-order-invariant.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import config as cfg
from ..camera import get_rays_u
from ..core import rng
from ..core import vecmath as vm
from . import shade
from .hit import scene_hit


class PoolState(NamedTuple):
    o: jnp.ndarray           # [M,3]
    d: jnp.ndarray           # [M,3] unit
    time: jnp.ndarray        # [M]
    radiance: jnp.ndarray    # [M,3] accumulated along the current path
    throughput: jnp.ndarray  # [M,3]
    item: jnp.ndarray        # [M] i32 local work-item id (pass-major)
    gitem: jnp.ndarray       # [M] i32 GLOBAL work-item id (RNG counter key)
    depth: jnp.ndarray       # [M] i32 bounces completed on this path
    alive: jnp.ndarray       # [M] bool
    next_w: jnp.ndarray      # scalar i32 — next local work item to issue
    raw: jnp.ndarray         # [n_pixels,3] framebuffer radiance sums
    segments: jnp.ndarray    # scalar i32 — total path segments traced
    iters: jnp.ndarray       # scalar i32 — pool iterations (occupancy stat)


def _sky(scene, d):
    t = 0.5 * (vm.unit(d)[..., 1] + 1.0)
    return (1.0 - t)[..., None] * scene.sky_a + t[..., None] * scene.sky_b


def _camera_rays(cam, config, item, sample_base, n_pix, pix0, total_pix,
                 dtype):
    """Generate camera rays for local work items.

    `item` is pass-major over this shard's n_pix pixels; the RNG is keyed by
    the GLOBAL work-item id (pass, global pixel) so a sharded render draws
    the exact same randomness as the unsharded one (shard-invariance).
    """
    pix_local = item % n_pix
    pass_idx = item // n_pix
    gpix = pix0 + pix_local
    abs_item = (sample_base + pass_idx) * total_pix + gpix
    u = rng.hash_uniforms(config.seed, abs_item, rng.CAMERA_DEPTH, 5, dtype)
    ys, xs = jnp.divmod(gpix, config.nx)
    s = (xs.astype(dtype) + u[:, 0]) / config.nx      # main.scm:456-457
    t = (ys.astype(dtype) + u[:, 1]) / config.ny
    o, d, time = get_rays_u(cam, s, t, u[:, 2], u[:, 3], u[:, 4])
    return o, d, time, abs_item


# Pixels per framebuffer band: on the earlier accelerator the flush
# scatter-add's per-update cost grew with its OPERAND size, so large
# frames render as sequential row-band pool drains (scan over bands, one
# compiled band graph) that keep every scatter inside a <=256k-pixel
# buffer.  Not measured on H100.  Band-major issue order is BIT-identical
# to frame-major: RNG is keyed by global (pass, pixel) ids and each
# pixel's contributions still arrive pass-major.
BAND_PIX = 256 * 1024


def _band_rows(ny, nx):
    """Largest row count dividing ny with band_rows * nx <= BAND_PIX."""
    cap = max(1, BAND_PIX // max(nx, 1))
    for r in range(min(cap, ny), 0, -1):
        if ny % r == 0:
            return r
    return ny


def render_pool_auto(scene, cam, config, raw0, sample_base, pix0=0,
                     total_pix=None, vary_axes=()):
    """Dispatch to the fused SoA pool (integrator/pool_fused.py — the fast
    path, Pallas kernel on a GPU) when the scene is covered, else to the
    general masked-sweep pool below (image-tex scenes, BVH traversal,
    russian roulette).  Identical estimator + RNG streams.  Frames larger
    than BAND_PIX render as sequential row-band drains (see BAND_PIX)."""
    from . import bounce, pool_fused
    if bounce.supported(scene, config):
        fn = pool_fused.render_pool_fused
    else:
        fn = render_pool

    n_pix = raw0.shape[0]
    whole_frame = (not vary_axes and pix0 == 0
                   and (total_pix is None or total_pix == n_pix)
                   and n_pix == config.n_pixels)
    if whole_frame and n_pix > BAND_PIX:
        band_rows = _band_rows(config.ny, config.nx)
        band_pix = band_rows * config.nx
        n_bands = n_pix // band_pix
        if n_bands > 1:
            def body(raw, b):
                raw_band = jax.lax.dynamic_slice(
                    raw, (b * band_pix, 0), (band_pix, 3))
                out, segs, iters = fn(scene, cam, config, raw_band,
                                      sample_base, pix0=b * band_pix,
                                      total_pix=n_pix)
                raw = jax.lax.dynamic_update_slice(raw, out,
                                                   (b * band_pix, 0))
                return raw, (segs, iters)

            raw, (segs, iters) = jax.lax.scan(
                body, raw0, jnp.arange(n_bands, dtype=jnp.int32))
            return (raw, jnp.sum(segs, dtype=segs.dtype),
                    jnp.sum(iters, dtype=iters.dtype))

    return fn(scene, cam, config, raw0, sample_base, pix0, total_pix,
              vary_axes)


def render_pool(scene, cam, config, raw0, sample_base, pix0=0,
                total_pix=None, vary_axes=()):
    """Trace config.spp passes over raw0's pixels via the regeneration pool.

    raw0: [n_pix, 3] running radiance sums for this shard's pixels
    (flattened; the full frame when unsharded, a row-block when sharded
    with `pix0` = global index of raw0's first pixel and `total_pix` = full
    frame pixel count).  sample_base: passes already in raw0 (offsets the
    absolute work-item ids so resumed renders draw fresh, reproducible
    randomness).  Returns (raw, segments, iters).
    """
    n_pix = raw0.shape[0]
    total_pix = config.n_pixels if total_pix is None else total_pix
    n_work = n_pix * config.spp
    m = min(config.resolve_pool_rays(), n_work)
    dtype = raw0.dtype

    item0 = jnp.arange(m, dtype=jnp.int32)
    o0, d0, time0, gitem0 = _camera_rays(cam, config, item0, sample_base,
                                         n_pix, pix0, total_pix, dtype)
    state = PoolState(
        o=o0, d=d0, time=time0,
        radiance=jnp.zeros((m, 3), dtype),
        throughput=jnp.ones((m, 3), dtype),
        item=item0,
        gitem=gitem0,
        depth=jnp.zeros(m, jnp.int32),
        alive=jnp.ones(m, bool),
        next_w=jnp.asarray(m, jnp.int32),
        raw=raw0,
        segments=jnp.zeros((), jnp.int32),
        iters=jnp.zeros((), jnp.int32),
    )
    if vary_axes:
        # under shard_map the carry must be uniformly device-varying: the
        # freshly-created zeros/aranges above are replicated while the loop
        # outputs vary with the shard (pix0), so mark the whole init varying
        # (skipping leaves, like raw0 itself, that already vary)
        def _vary(x):
            have = getattr(jax.typeof(x), "vma", frozenset())
            need = tuple(a for a in vary_axes if a not in have)
            return jax.lax.pcast(x, need, to='varying') if need else x
        state = jax.tree.map(_vary, state)

    def body(st: PoolState) -> PoolState:
        abs_item = st.gitem
        xi_med = (rng.hash_uniforms(config.seed, abs_item, st.depth,
                                    scene.med_kind.shape[0], dtype,
                                    group_base=rng.GROUP_MEDIUM)
                  if scene.has_media else None)
        u_shade = rng.hash_uniforms(config.seed, abs_item, st.depth,
                                    shade.N_U, dtype)

        rec = scene_hit(st.o, st.d, st.time, scene,
                        cfg.SHADOW_EPS, cfg.BIG, xi_med, config)
        missed = st.alive & ~rec.hit
        radiance = st.radiance + jnp.where(
            missed[:, None], st.throughput * _sky(scene, st.d), 0.0)

        shade_fn = (shade.shade_sorted if config.material_sort
                    else shade.shade)
        sc = shade_fn(u_shade, scene, config, st.d, rec)
        hit_live = st.alive & rec.hit
        radiance = radiance + jnp.where(hit_live[:, None],
                                        st.throughput * sc.emitted, 0.0)

        scattering = hit_live & sc.alive & (st.depth < config.max_depth)
        throughput = jnp.where(scattering[:, None],
                               st.throughput * sc.mult, st.throughput)
        if config.russian_roulette:
            u_rr = rng.hash_uniforms(config.seed, abs_item, st.depth, 1,
                                     dtype, group_base=rng.GROUP_RR)[:, 0]
            p_cont = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
            do_rr = scattering & (st.depth >= config.rr_start_depth)
            scattering = scattering & (~do_rr | (u_rr < p_cont))
            throughput = jnp.where(do_rr[:, None],
                                   throughput / jnp.maximum(p_cont, 0.05)[:, None],
                                   throughput)

        # --- flush finished paths into the framebuffer ---------------------
        terminated = st.alive & ~scattering
        pix = st.item % n_pix
        raw = st.raw.at[pix].add(
            jnp.where(terminated[:, None], radiance, 0.0))

        # --- re-issue freed lanes the next work items ----------------------
        t_i32 = terminated.astype(jnp.int32)
        new_local = st.next_w + jnp.cumsum(t_i32) - t_i32   # exclusive rank
        has_work = terminated & (new_local < n_work)
        item = jnp.where(has_work, new_local, st.item)
        o_new, d_new, time_new, gitem_new = _camera_rays(
            cam, config, item, sample_base, n_pix, pix0, total_pix, dtype)
        gitem = jnp.where(has_work, gitem_new, st.gitem)

        o = vm.where3(scattering, rec.p, vm.where3(has_work, o_new, st.o))
        d = vm.where3(scattering, sc.direction,
                      vm.where3(has_work, d_new, st.d))
        time = jnp.where(has_work, time_new, st.time)
        radiance = jnp.where(terminated[:, None], 0.0, radiance)
        throughput = jnp.where(has_work[:, None], 1.0, throughput)
        depth = jnp.where(scattering, st.depth + 1,
                          jnp.where(has_work, 0, st.depth))
        alive = scattering | has_work
        # dtype-pinned sums: under x64 (f64 oracle) jnp.sum(int32) promotes
        # to int64 (numpy semantics) and would break the while_loop carry
        next_w = jnp.minimum(st.next_w + jnp.sum(t_i32, dtype=jnp.int32),
                             n_work)
        segments = st.segments + jnp.sum(st.alive, dtype=jnp.int32)
        return PoolState(o, d, time, radiance, throughput, item, gitem,
                         depth, alive, next_w, raw, segments, st.iters + 1)

    state = jax.lax.while_loop(lambda s: jnp.any(s.alive), body, state)
    return state.raw, state.segments, state.iters
