"""Perlin gradient noise, hash-based (table-free).

The reference builds three shuffled permutation tables and a 256-entry
gradient-vector table at module-load time from the global srfi-27 RNG
(perlin.scm:10-36) and hashes lattice points through them
(ranvec[perm_x[i&255] ^ perm_y[j&255] ^ perm_z[k&255]], perlin.scm:69-90).
Table lookups are per-lane GATHERS.  Since the tables are themselves just a
fixed hash, we replace them with a counter-based hash computed IN REGISTER:
the gradient at lattice point (i, j, k) is the unit vector derived from one
PCG4D round over (i, j, k, seed) — the same integer recurrence the
renderer's RNG uses (core/rng.py), so it runs unchanged inside the bounce
kernel and is identical between the jnp path and the kernel.  Noise class and
statistics match the reference (Hermite-smoothed lattice gradient noise,
range ~[-1, 1], zero at lattice points); parity with the reference is
statistical, not bitwise (SURVEY §7.3 item 4 — its tables are seeded from
interpreter load-time RNG anyway).

Seeding: `seed` is a python int fixed at scene build (Scene.perlin_seed,
static metadata), replacing the reference's nondeterministic load-time
draw (SURVEY §7.3 item 6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_MULT = 1664525
_ADD = 1013904223
_INV_2_24 = 1.0 / float(1 << 24)


def _hash_grad(ix, iy, iz, seed: int):
    """Unit gradient vector at an int32 lattice point, via one PCG4D round.

    ix/iy/iz: lane-shaped int32 (any shape, incl. (B, 128) kernel blocks).
    Returns (gx, gy, gz) lane-shaped floats (caller's dtype via .astype).
    """
    u32 = jnp.uint32
    a = jax.lax.bitcast_convert_type(ix, u32)
    b = jax.lax.bitcast_convert_type(iy, u32)
    c = jax.lax.bitcast_convert_type(iz, u32)
    d = jnp.full_like(a, u32(seed & 0xFFFFFFFF))
    mult = u32(_MULT); add = u32(_ADD)
    a = a * mult + add; b = b * mult + add
    c = c * mult + add; d = d * mult + add
    a = a + b * d; b = b + c * a; c = c + a * b; d = d + b * c
    a = a ^ (a >> 16); b = b ^ (b >> 16); c = c ^ (c >> 16)
    a = a + b * d; b = b + c * a; c = c + a * b
    return a, b, c


def _to_sym(bits, dtype):
    """uint32 -> (-1, 1) float (top 24 bits; via an int32 bitcast)."""
    i32 = jax.lax.bitcast_convert_type(bits >> jnp.uint32(8), jnp.int32)
    return i32.astype(dtype) * (2.0 * _INV_2_24) - 1.0


def noise_xyz(seed: int, x, y, z):
    """SoA gradient noise at (x, y, z) lane-shaped floats -> lane-shaped.

    Hermite-smoothed trilinear gradient interpolation (perlin.scm:51-90):
    zero at lattice points, range within [-1, 1].
    """
    dtype = x.dtype
    fx, fy, fz = jnp.floor(x), jnp.floor(y), jnp.floor(z)
    ix = fx.astype(jnp.int32); iy = fy.astype(jnp.int32)
    iz = fz.astype(jnp.int32)
    ux, uy, uz = x - fx, y - fy, z - fz
    # Hermite fade (perlin.scm:52-54)
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    acc = jnp.zeros_like(x)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                ga, gb, gc = _hash_grad(ix + di, iy + dj, iz + dk, seed)
                gx = _to_sym(ga, dtype)
                gy = _to_sym(gb, dtype)
                gz = _to_sym(gc, dtype)
                inv = jax.lax.rsqrt(jnp.maximum(
                    gx * gx + gy * gy + gz * gz, 1e-12))
                dot = ((ux - di) * gx + (uy - dj) * gy + (uz - dk) * gz) * inv
                w = ((sx if di else 1.0 - sx)
                     * (sy if dj else 1.0 - sy)
                     * (sz if dk else 1.0 - sz))
                acc = acc + w * dot
    return acc


def turb_xyz(seed: int, x, y, z, depth: int = 7):
    """7-octave |fBm| (perlin.scm:92-103), SoA."""
    acc = jnp.zeros_like(x)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise_xyz(seed, x, y, z)
        x, y, z = x * 2.0, y * 2.0, z * 2.0
        weight = weight * 0.5
    return jnp.abs(acc)


def noise(seed: int, p):
    """Array form: p [..., 3] -> [...]."""
    return noise_xyz(seed, p[..., 0], p[..., 1], p[..., 2])


def turb(seed: int, p, depth: int = 7):
    """Array form: p [..., 3] -> [...]."""
    return turb_xyz(seed, p[..., 0], p[..., 1], p[..., 2], depth)
