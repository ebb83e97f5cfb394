"""Distribution tests for ops/sampling.py (util.scm:9-54 analytic
equivalents): check support and first moments against closed forms."""

import jax
import jax.numpy as jnp
import numpy as np

from scheme_raytrace.core import vecmath as vm
from scheme_raytrace.ops import sampling

N = 200_000


def test_in_unit_sphere_support_and_moment(key):
    p = sampling.in_unit_sphere(key, (N,))
    r = vm.length(p)
    assert float(jnp.max(r)) <= 1.0 + 1e-6
    # E[|p|] = 3/4 for uniform-in-ball
    np.testing.assert_allclose(float(jnp.mean(r)), 0.75, atol=0.01)
    # isotropy
    np.testing.assert_allclose(np.asarray(jnp.mean(p, 0)), 0.0, atol=0.01)


def test_in_unit_disk(key):
    p = sampling.in_unit_disk(key, (N,))
    np.testing.assert_allclose(np.asarray(p[:, 2]), 0.0)
    r = vm.length(p)
    assert float(jnp.max(r)) <= 1.0 + 1e-6
    # E[r] = 2/3 for uniform-in-disk
    np.testing.assert_allclose(float(jnp.mean(r)), 2.0 / 3.0, atol=0.01)


def test_cosine_direction_moments(key):
    d = sampling.cosine_direction(key, (N,))
    np.testing.assert_allclose(np.asarray(vm.length(d)), 1.0, atol=1e-5)
    assert float(jnp.min(d[:, 2])) >= 0.0
    # E[cos(theta)] = 2/3 under pdf = cos/pi (the B4 fix's defining moment:
    # the reference's x2-bug distribution has a different z-marginal)
    np.testing.assert_allclose(float(jnp.mean(d[:, 2])), 2.0 / 3.0, atol=0.01)


def test_hemisphere_direction_uniform(key):
    d = sampling.hemisphere_direction(key, (N,))
    assert float(jnp.min(d[:, 2])) >= 0.0
    # E[z] = 1/2 for uniform hemisphere
    np.testing.assert_allclose(float(jnp.mean(d[:, 2])), 0.5, atol=0.01)


def test_to_sphere_cone_support(key):
    # util.scm:46-54: directions lie in the cone toward the sphere.
    radius, dist = 1.0, 4.0
    d = sampling.to_sphere(key, radius, dist * dist, (N,))
    cos_theta_max = np.sqrt(1 - radius**2 / dist**2)
    assert float(jnp.min(d[:, 2])) >= cos_theta_max - 1e-5
    np.testing.assert_allclose(np.asarray(vm.length(d)), 1.0, atol=1e-5)
    # mean z = (1 + cos_theta_max)/2 (z uniform on [cos_theta_max, 1])
    np.testing.assert_allclose(float(jnp.mean(d[:, 2])),
                               (1 + cos_theta_max) / 2, atol=0.005)
