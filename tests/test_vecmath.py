"""Unit tests for core/vecmath.py against closed-form cases (vec.scm:7-70,
material.scm:41-74)."""

import jax.numpy as jnp
import numpy as np

from scheme_raytrace.core import vecmath as vm


def test_vec3_stack_and_accessors():
    v = vm.vec3(1.0, 2.0, 3.0)
    assert v.shape == (3,)
    np.testing.assert_allclose(v, [1.0, 2.0, 3.0])


def test_vec3_broadcasts_batches():
    v = vm.vec3(jnp.zeros(5), jnp.ones(5), 2.0)
    assert v.shape == (5, 3)
    np.testing.assert_allclose(v[:, 2], 2.0)


def test_dot_cross_length():
    a = jnp.array([1.0, 0.0, 0.0])
    b = jnp.array([0.0, 1.0, 0.0])
    assert float(vm.dot(a, b)) == 0.0
    np.testing.assert_allclose(vm.cross(a, b), [0.0, 0.0, 1.0])
    np.testing.assert_allclose(vm.length(jnp.array([3.0, 4.0, 0.0])), 5.0)
    np.testing.assert_allclose(vm.sq_len(jnp.array([3.0, 4.0, 0.0])), 25.0)


def test_unit_batched():
    a = jnp.array([[2.0, 0.0, 0.0], [0.0, 0.0, -3.0]])
    u = vm.unit(a)
    np.testing.assert_allclose(u, [[1, 0, 0], [0, 0, -1]], atol=1e-7)


def test_reflect_mirror():
    # 45-degree incidence on the xz plane (material.scm:41-43)
    v = vm.unit(jnp.array([1.0, -1.0, 0.0]))
    n = jnp.array([0.0, 1.0, 0.0])
    r = vm.reflect(v, n)
    np.testing.assert_allclose(r, vm.unit(jnp.array([1.0, 1.0, 0.0])),
                               atol=1e-6)


def test_refract_straight_through():
    # Normal incidence refracts straight through regardless of IOR.
    v = jnp.array([0.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    ok, r = vm.refract(v, n, jnp.asarray(1.0 / 1.5))
    assert bool(ok)
    np.testing.assert_allclose(r, [0.0, -1.0, 0.0], atol=1e-6)


def test_refract_snell_angle():
    # sin(theta_t) = (n1/n2) sin(theta_i), entering glass at 45 degrees.
    v = vm.unit(jnp.array([1.0, -1.0, 0.0]))
    n = jnp.array([0.0, 1.0, 0.0])
    ok, r = vm.refract(v, n, jnp.asarray(1.0 / 1.5))
    assert bool(ok)
    sin_t = float(vm.length(r * jnp.array([1.0, 0.0, 1.0]))
                  / vm.length(r))
    np.testing.assert_allclose(sin_t, np.sin(np.pi / 4) / 1.5, rtol=1e-5)


def test_refract_total_internal_reflection():
    # Glass->air beyond the critical angle (~41.8 deg): no refraction.
    v = vm.unit(jnp.array([1.0, -0.5, 0.0]))   # ~63 deg from normal
    n = jnp.array([0.0, 1.0, 0.0])
    ok, r = vm.refract(v, n, jnp.asarray(1.5))
    assert not bool(ok)
    np.testing.assert_allclose(r, 0.0)


def test_schlick_limits():
    # material.scm:69-74 — r0 at normal incidence, 1.0 at grazing.
    r0 = float(vm.schlick(jnp.asarray(1.0), jnp.asarray(1.5)))
    np.testing.assert_allclose(r0, ((1 - 1.5) / (1 + 1.5)) ** 2, rtol=1e-6)
    rg = float(vm.schlick(jnp.asarray(0.0), jnp.asarray(1.5)))
    np.testing.assert_allclose(rg, 1.0, rtol=1e-6)


def test_where3():
    mask = jnp.array([True, False])
    a = jnp.ones((2, 3))
    b = jnp.zeros((2, 3))
    out = vm.where3(mask, a, b)
    np.testing.assert_allclose(out, [[1, 1, 1], [0, 0, 0]])
