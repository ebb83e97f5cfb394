"""Importance-sampling PDF tests (pdf.scm + the B5 machinery it lacks).

The defining property of every pdf here: it must integrate to 1 over the
sphere/hemisphere, and sample() must be distributed according to value().
Checked by Monte Carlo with generous-but-meaningful tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np

from scheme_raytrace.core import vecmath as vm
from scheme_raytrace.integrator import pdfs
from scheme_raytrace.ops import sampling
from scheme_raytrace.scene import compile_scene, objects as ob

N = 100_000


def _uniform_sphere_dirs(key, n):
    z = jax.random.uniform(key, (n,), minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(jax.random.fold_in(key, 1), (n,),
                             minval=0.0, maxval=2 * np.pi)
    s = jnp.sqrt(1 - z * z)
    return vm.vec3(s * jnp.cos(phi), s * jnp.sin(phi), z)


def test_cosine_pdf_integrates_to_one(key):
    n = jnp.tile(vm.unit(jnp.array([0.2, 0.9, -0.1])), (N, 1))
    d = _uniform_sphere_dirs(key, N)
    # MC integral over the sphere: 4*pi*E[pdf]
    integral = 4 * np.pi * float(jnp.mean(pdfs.cosine_value(n, d)))
    np.testing.assert_allclose(integral, 1.0, atol=0.02)


def test_cosine_sample_matches_value(key):
    # E[1/pdf(sampled)] over samples of pdf = area of support (2*pi-ish
    # weighted); simpler invariant: E[f(d)] under sampling == integral of
    # f*pdf.  Use f = cos(theta): E[cos] = 2/3 for pdf = cos/pi.
    n = jnp.tile(vm.unit(jnp.array([0.0, 0.0, 1.0])), (N, 1))
    d = pdfs.cosine_sample(key, n)
    np.testing.assert_allclose(float(jnp.mean(d[:, 2])), 2 / 3, atol=0.01)
    vals = pdfs.cosine_value(n, d)
    assert float(jnp.min(vals)) > 0.0


def _light_scene(objs):
    return compile_scene(objs + [ob.Sphere((0, -1000, 0), 100,
                                           ob.Lambertian((1, 1, 1)))])


def test_rect_pdf_value_directly_below():
    # xz-rect light, point straight below center at distance D:
    # pdf = t^2 / (cos * area) = D^2 / area (cos = 1)
    light = ob.xz_rect(-1, 1, -1, 1, 5, ob.DiffuseLight((1, 1, 1)))
    sc = _light_scene([light])
    origin = jnp.array([[0.0, 0.0, 0.0]])
    direction = jnp.array([[0.0, 1.0, 0.0]])
    val = float(pdfs.lights_value(sc, origin, direction)[0])
    np.testing.assert_allclose(val, 25.0 / 4.0, rtol=1e-4)
    # direction missing the rect -> 0
    miss = vm.unit(jnp.array([[1.0, 0.2, 0.0]]))
    assert float(pdfs.lights_value(sc, origin, miss)[0]) == 0.0


def test_sphere_pdf_value_solid_angle():
    light = ob.Sphere((0, 10, 0), 2.0, ob.DiffuseLight((1, 1, 1)))
    sc = _light_scene([light])
    origin = jnp.array([[0.0, 0.0, 0.0]])
    direction = jnp.array([[0.0, 1.0, 0.0]])
    cos_max = np.sqrt(1 - (2.0 / 10.0) ** 2)
    want = 1.0 / (2 * np.pi * (1 - cos_max))
    val = float(pdfs.lights_value(sc, origin, direction)[0])
    np.testing.assert_allclose(val, want, rtol=1e-3)
    # outside the cone -> 0
    side = vm.unit(jnp.array([[1.0, 0.5, 0.0]]))
    assert float(pdfs.lights_value(sc, origin, side)[0]) == 0.0


def test_lights_sample_hits_light(key):
    light = ob.xz_rect(-1, 1, -1, 1, 5, ob.DiffuseLight((1, 1, 1)))
    sc = _light_scene([light])
    origin = jnp.zeros((4096, 3))
    d = pdfs.lights_sample(key, sc, origin)
    # every sampled direction must intersect the rect plane inside bounds
    t = 5.0 / d[:, 1]
    px, pz = t * d[:, 0], t * d[:, 2]
    assert float(jnp.min(d[:, 1])) > 0.0
    assert bool(jnp.all((px >= -1) & (px <= 1) & (pz >= -1) & (pz <= 1)))
    # and the pdf there is positive
    vals = pdfs.lights_value(sc, origin, d)
    assert float(jnp.min(vals)) > 0.0


def test_rect_pdf_integrates_to_one(key):
    # MC over the sphere of directions from a point under the light.
    light = ob.xz_rect(-2, 2, -1, 3, 4, ob.DiffuseLight((1, 1, 1)))
    sc = _light_scene([light])
    d = _uniform_sphere_dirs(key, 4 * N)
    origin = jnp.zeros((4 * N, 3))
    integral = 4 * np.pi * float(jnp.mean(pdfs.lights_value(sc, origin, d)))
    np.testing.assert_allclose(integral, 1.0, atol=0.05)


def test_sphere_pdf_integrates_to_one(key):
    light = ob.Sphere((0, 6, 0), 1.5, ob.DiffuseLight((1, 1, 1)))
    sc = _light_scene([light])
    d = _uniform_sphere_dirs(key, 4 * N)
    origin = jnp.zeros((4 * N, 3))
    integral = 4 * np.pi * float(jnp.mean(pdfs.lights_value(sc, origin, d)))
    np.testing.assert_allclose(integral, 1.0, atol=0.05)


def test_mixture_pdf_positive_on_samples(key):
    # pdf.scm:34-41 — 50/50 mixture; sampled dirs must have pdf > 0
    light = ob.xz_rect(-1, 1, -1, 1, 5, ob.DiffuseLight((1, 1, 1)))
    sc = _light_scene([light])
    normal = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (8192, 1))
    p = jnp.zeros((8192, 3))
    d, pdf = pdfs.mixture_sample_and_value(key, sc, normal, p)
    np.testing.assert_allclose(np.asarray(vm.length(d)), 1.0, atol=1e-5)
    assert float(jnp.min(pdf)) > 0.0


def test_mixture_pdf_integrates_to_one(key):
    light = ob.xz_rect(-1, 1, -1, 1, 5, ob.DiffuseLight((1, 1, 1)))
    sc = _light_scene([light])
    d = _uniform_sphere_dirs(key, 4 * N)
    normal = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (4 * N, 1))
    p = jnp.zeros((4 * N, 3))
    pdf = 0.5 * pdfs.cosine_value(normal, d) + 0.5 * pdfs.lights_value(sc, p, d)
    integral = 4 * np.pi * float(jnp.mean(pdf))
    np.testing.assert_allclose(integral, 1.0, atol=0.05)
