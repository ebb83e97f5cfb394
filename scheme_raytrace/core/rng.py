"""Counter-based RNG threading for the wavefront integrator.

The reference consumes srfi-27's global sequential RNG at many sites
(SURVEY.md §6.3 "RNG call sites"); order-dependent sequential state is
hostile to SPMD, so this design derives every random draw from a
(seed, pixel, sample, bounce, site) counter tuple via threefry fold_in —
order-robust, shard-invariant, and reproducible (parity with the reference
is statistical, not bitwise — SURVEY §7.3 item 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Stable per-call-site salts (matches the reference's variance-shaping RNG
# sites: pixel jitter, lens disk, ray time, scatter dir, dielectric branch,
# medium distance — SURVEY.md §6.3).
SITE_PIXEL_JITTER = 1
SITE_LENS = 2
SITE_TIME = 3
SITE_SCATTER = 4
SITE_DIELECTRIC = 5
SITE_MEDIUM = 6
SITE_LIGHT = 7
SITE_MIX = 8
SITE_RR = 9


def root_key(seed: int):
    return jax.random.key(seed)


# ---------------------------------------------------------------------------
# Counter-based PCG4D hash RNG (the wavefront-pool / Pallas-kernel stream)
# ---------------------------------------------------------------------------
# The regeneration pool retires and re-issues rays at data-dependent loop
# iterations, so draws must be keyed by *what* is being sampled — the
# (seed, work-item, depth, site) counter — never by *when* (the iteration
# index), or resume/sharding would change the image.  threefry fold_in per
# lane per bounce costs ~10x more VPU ops than one PCG4D round; PCG4D's
# statistical quality is ample for Monte Carlo integration (Jarzynski &
# Olano, "Hash Functions for GPU Rendering", JCGT 2020 — public technique).
# The same integer recurrence runs inside the Pallas bounce kernel
# so kernel output is comparable against this path.

# numpy (not jnp) scalars: jnp constants are device arrays that a Pallas
# kernel closure would capture; numpy scalars stay inline literals
_PCG_MULT = np.uint32(1664525)
_PCG_ADD = np.uint32(1013904223)
_INV_2_24 = 1.0 / float(1 << 24)


def _pcg4d(a, b, c, d):
    """One PCG4D round: 4 uint32 counters -> 4 decorrelated uint32."""
    a = a * _PCG_MULT + _PCG_ADD
    b = b * _PCG_MULT + _PCG_ADD
    c = c * _PCG_MULT + _PCG_ADD
    d = d * _PCG_MULT + _PCG_ADD
    a = a + b * d; b = b + c * a; c = c + a * b; d = d + b * c
    a = a ^ (a >> 16); b = b ^ (b >> 16)
    c = c ^ (c >> 16); d = d ^ (d >> 16)
    a = a + b * d; b = b + c * a; c = c + a * b; d = d + b * c
    return a, b, c, d


def _to_unit(bits, dtype):
    """uint32 -> [0, 1) float using the top 24 bits.

    Routed through an int32 bitcast (value-preserving: after >>8 the top bit
    is clear), so the cast is a signed one — this exact function also runs
    inside the bounce kernel.
    """
    i32 = jax.lax.bitcast_convert_type(bits >> jnp.uint32(8), jnp.int32)
    return i32.astype(dtype) * jnp.asarray(_INV_2_24, dtype)


def hash_uniforms_tuple(seed, item, depth, ncols: int, dtype=jnp.float32,
                        group_base: int = 0):
    """Like hash_uniforms but returns a TUPLE of [N] columns (no stack).

    The SoA bounce path (integrator/bounce.py) keeps every quantity as a
    separate lane-shaped array, never a stacked [N, k] matrix.
    Shape-agnostic: runs on [N] arrays under jit and on lane blocks inside
    the Pallas kernel.
    """
    # pin to int32 BEFORE the bitcast: under x64 a python-int depth becomes
    # int64 and bitcasting 64->32 bits would append a (2,) axis
    item = jax.lax.bitcast_convert_type(jnp.asarray(item, jnp.int32),
                                        jnp.uint32)
    # broadcast a scalar `depth` (e.g. CAMERA_DEPTH) to the lane shape
    depth = jnp.broadcast_to(jnp.asarray(depth, jnp.int32), item.shape)
    depth = jax.lax.bitcast_convert_type(depth, jnp.uint32)
    seed_u = jnp.broadcast_to(jnp.uint32(seed & 0xFFFFFFFF), item.shape)
    cols = []
    for g in range((ncols + 3) // 4):
        out = _pcg4d(item, depth,
                     jnp.full_like(item, jnp.uint32(group_base + g)),
                     seed_u)
        cols.extend(out)
    return tuple(_to_unit(c, dtype) for c in cols[:ncols])


def hash_uniforms(seed, item, depth, ncols: int, dtype=jnp.float32,
                  group_base: int = 0):
    """[N, ncols] uniforms keyed by (seed, item, depth, column-group).

    seed: python int; item: [N] int32 absolute work-item ids; depth: scalar
    or [N] bounce index (use CAMERA_DEPTH for ray-generation draws).
    `group_base` offsets the column-group counter so distinct call sites at
    the same (item, depth) draw independent streams.  Deterministic per
    (seed, item, depth, group_base + col) — iteration- and shard-invariant,
    so pool renders are resumable bit-for-bit.
    """
    item = item.astype(jnp.uint32)
    depth = jnp.asarray(depth).astype(jnp.uint32)
    depth = jnp.broadcast_to(depth, item.shape)
    seed_u = jnp.uint32(seed & 0xFFFFFFFF)
    cols = []
    for g in range((ncols + 3) // 4):
        out = _pcg4d(item, depth,
                     jnp.full_like(item, jnp.uint32(group_base + g)),
                     jnp.broadcast_to(seed_u, item.shape))
        cols.extend(out)
    return jnp.stack([_to_unit(c, dtype) for c in cols[:ncols]], axis=-1)


CAMERA_DEPTH = 0xFFFF     # `depth` tag for camera-ray generation draws
GROUP_SHADE = 0           # column groups 0..3: the shade() uniform matrix
GROUP_MEDIUM = 8          # column groups 8+: per-medium scatter distances
GROUP_RR = 0x80           # russian-roulette continuation draw


def bounce_key(key, bounce, site: int):
    """Key for one call site within one bounce (vector draws index rays)."""
    return jax.random.fold_in(jax.random.fold_in(key, bounce), site)


def uniform(key, shape, dtype=jnp.float32, lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, dtype=dtype, minval=lo, maxval=hi)
