"""Batched random direction/point samplers (util.scm:9-54).

The reference rejection-samples unit-sphere/disk points (util.scm:9-23);
rejection loops do not vectorize, so every sampler here is the exact
analytic (inverse-CDF) equivalent — same distribution, fixed trip count.
`random-cosine-direction`'s Shirley-1st-edition x2 bug (util.scm:42-43,
SURVEY.md B4) is consciously fixed to the standard sqrt(r2) form; parity is
defined statistically against this oracle.

Each sampler has two forms: a `*_u` core that maps explicit uniform draws
-> sample (used by the regeneration pool and re-derivable inside Pallas
kernels, where draws come from the counter hash in core/rng.py), and a
key-based wrapper with the original signature.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm

_TWO_PI = 2.0 * jnp.pi


# ---------------------------------------------------------------------------
# uniform-draw cores
# ---------------------------------------------------------------------------

def in_unit_sphere_u(r1, r2, r3):
    """Uniform point inside the unit ball from 3 U[0,1) draws
    (util.scm:9-15, analytic form)."""
    z = 2.0 * r1 - 1.0
    phi = _TWO_PI * r2
    r = jnp.cbrt(r3)
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return r[..., None] * vm.vec3(s * jnp.cos(phi), s * jnp.sin(phi), z)


def in_unit_disk_u(r1, r2):
    """Uniform point in the unit disk, z=0 (util.scm:17-23, analytic)."""
    r = jnp.sqrt(r1)
    phi = _TWO_PI * r2
    return vm.vec3(r * jnp.cos(phi), r * jnp.sin(phi), jnp.zeros_like(r))


def cosine_direction_u(r1, r2):
    """Cosine-weighted hemisphere direction about +z (util.scm:37-44,
    B4 fixed)."""
    phi = _TWO_PI * r1
    sr2 = jnp.sqrt(r2)
    z = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    return vm.vec3(jnp.cos(phi) * sr2, jnp.sin(phi) * sr2, z)


def hemisphere_direction_u(r1, r2):
    """Uniform hemisphere direction about +z (util.scm:25-35, analytic)."""
    z = r1                                          # cos(theta) ~ U[0,1]
    phi = _TWO_PI * r2
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return vm.vec3(s * jnp.cos(phi), s * jnp.sin(phi), z)


def to_sphere_u(r1, r2, radius, distance_sq):
    """Solid-angle direction toward a sphere, local frame (util.scm:46-54).

    Used by the hittable-PDF light sampler (pdf.scm's missing g:random, B5).
    radius/distance_sq broadcast against the draws.
    """
    # double-where (not maximum): sqrt'(0)=inf times maximum's zero cotangent
    # is NaN in reverse-mode when the shading point is inside the sphere
    inner = 1.0 - radius * radius / distance_sq
    outside = inner > 0.0
    cos_theta_max = jnp.where(
        outside, jnp.sqrt(jnp.where(outside, inner, 1.0)), 0.0)
    z = 1.0 + r2 * (cos_theta_max - 1.0)
    phi = _TWO_PI * r1
    zin = 1.0 - z * z
    z_ok = zin > 0.0
    s = jnp.where(z_ok, jnp.sqrt(jnp.where(z_ok, zin, 1.0)), 0.0)
    return vm.vec3(jnp.cos(phi) * s, jnp.sin(phi) * s, z)


# ---------------------------------------------------------------------------
# key-based wrappers (original signatures)
# ---------------------------------------------------------------------------

def _draws(key, n, shape, dtype):
    u = jax.random.uniform(key, shape + (n,), dtype)
    return tuple(u[..., i] for i in range(n))


def in_unit_sphere(key, shape, dtype=jnp.float32):
    return in_unit_sphere_u(*_draws(key, 3, shape, dtype))


def in_unit_disk(key, shape, dtype=jnp.float32):
    return in_unit_disk_u(*_draws(key, 2, shape, dtype))


def cosine_direction(key, shape, dtype=jnp.float32):
    return cosine_direction_u(*_draws(key, 2, shape, dtype))


def hemisphere_direction(key, shape, dtype=jnp.float32):
    return hemisphere_direction_u(*_draws(key, 2, shape, dtype))


def to_sphere(key, radius, distance_sq, shape, dtype=jnp.float32):
    r1, r2 = _draws(key, 2, shape, dtype)
    return to_sphere_u(r1, r2, radius, distance_sq)
