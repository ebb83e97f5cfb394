"""Wavefront path tracing over a batched ray pool.

The reference's integrator is a per-pixel recursion up to 100 bounces
(main.scm:100-121); recursion and early return do not vectorize, so
the whole pool advances one bounce per iteration of a `lax.while_loop`
(fast path — exits as soon as every ray has terminated) or a fixed-length
`lax.scan` (differentiable path — reverse-mode needs a static trip count).

Behavioral contract (SURVEY §6.3):
  L = emitted + (attenuation * s_pdf) * L(scattered) / pdf   (main.scm:113-118)
  depth cap: bounce index == max_depth contributes emitted only (main.scm:112)
  miss at any depth -> per-scene sky (main.scm:120, :91-98)
  t range [SHADOW_EPS, BIG] (main.scm:104)
Scattered rays keep the primary ray's time (the reference resets it to 0
via the 2-arg make-ray, ray.scm:8-9 — a motion-blur-only-on-camera-rays
quirk that matters to no committed scene; carrying time is the canonical
RTNW behavior and is documented here as a conscious fix).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import config as cfg
from ..core import vecmath as vm
from ..core import rng
from . import shade
from .hit import scene_hit


class RayState(NamedTuple):
    o: jnp.ndarray           # [N,3]
    d: jnp.ndarray           # [N,3] unit
    time: jnp.ndarray        # [N]
    radiance: jnp.ndarray    # [N,3]
    throughput: jnp.ndarray  # [N,3]
    alive: jnp.ndarray       # [N] bool
    depth: jnp.ndarray       # scalar i32
    segments: jnp.ndarray    # scalar i32 — total path segments traced
                             # (rays/s observability, SURVEY §5.5)


def sky_color(scene, d):
    """main.scm:91-98 — lerp(white, (0.5,0.7,1.0)) by 0.5(y+1), or black."""
    t = 0.5 * (vm.unit(d)[..., 1] + 1.0)
    return (1.0 - t)[..., None] * scene.sky_a + t[..., None] * scene.sky_b


def _bounce(state: RayState, scene, config, key) -> RayState:
    """Advance every live ray one bounce."""
    n = state.o.shape[0]
    dtype = state.o.dtype
    k_hit = rng.bounce_key(key, state.depth, rng.SITE_MEDIUM)
    k_shade = rng.bounce_key(key, state.depth, rng.SITE_SCATTER)
    xi_med = (jax.random.uniform(k_hit, (n, scene.med_kind.shape[0]), dtype)
              if scene.has_media else None)
    u_shade = shade.shade_uniforms(k_shade, n, dtype)

    rec = scene_hit(state.o, state.d, state.time, scene,
                    cfg.SHADOW_EPS, cfg.BIG, xi_med, config)

    missed = state.alive & ~rec.hit
    radiance = state.radiance + jnp.where(
        missed[:, None], state.throughput * sky_color(scene, state.d), 0.0)

    sc = shade.shade(u_shade, scene, config, state.d, rec)
    hit_live = state.alive & rec.hit
    radiance = radiance + jnp.where(hit_live[:, None],
                                    state.throughput * sc.emitted, 0.0)

    scattering = hit_live & sc.alive & (state.depth < config.max_depth)
    throughput = jnp.where(scattering[:, None],
                           state.throughput * sc.mult, state.throughput)
    if config.russian_roulette:
        # Behavior change vs the reference (hard cap only, main.scm:112) —
        # OFF for parity configs (SURVEY §7.3 item 3).
        k_rr = rng.bounce_key(key, state.depth, rng.SITE_RR)
        p_cont = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
        roll = jax.random.uniform(k_rr, p_cont.shape, p_cont.dtype)
        do_rr = scattering & (state.depth >= config.rr_start_depth)
        scattering = scattering & (~do_rr | (roll < p_cont))
        throughput = jnp.where(do_rr[:, None],
                               throughput / jnp.maximum(p_cont, 0.05)[:, None],
                               throughput)

    o = vm.where3(scattering, rec.p, state.o)
    d = vm.where3(scattering, sc.direction, state.d)
    segments = state.segments + jnp.sum(state.alive).astype(jnp.int32)
    return RayState(o, d, state.time, radiance, throughput,
                    scattering, state.depth + 1, segments)


def trace_rays(scene, o, d, time, key, config) -> jnp.ndarray:
    """Integrate radiance for a ray pool; returns [N,3]."""
    return trace_rays_full(scene, o, d, time, key, config).radiance


def trace_rays_full(scene, o, d, time, key, config) -> RayState:
    """Like trace_rays but returns the final RayState (incl. segment count).

    o/d/time from camera.get_rays; key is the per-pass bounce key root.
    """
    # Carry inits derive from the ray arrays (not fresh constants) so they
    # inherit the shard-varying type under shard_map — the loop body makes
    # them varying, and JAX requires carry-in/carry-out types to match.
    state = RayState(
        o=o, d=d, time=time,
        radiance=o * 0.0,
        throughput=o * 0.0 + 1.0,
        alive=time == time,                             # all-True, varying
        depth=jnp.zeros((), jnp.int32),
        segments=(jnp.sum(time) * 0.0).astype(jnp.int32),
    )

    if config.differentiable:
        # Fixed trip count for reverse-mode AD; rematerialize each bounce so
        # memory stays O(state), not O(depth * intersections).
        bounce = jax.checkpoint(
            lambda s, _: (_bounce(s, scene, config, key), None))
        state, _ = jax.lax.scan(bounce, state, None,
                                length=config.max_depth + 1)
    else:
        state = jax.lax.while_loop(
            lambda s: (s.depth <= config.max_depth) & jnp.any(s.alive),
            lambda s: _bounce(s, scene, config, key),
            state)
    return state
