"""Texture evaluation (texture.scm) and Perlin noise (perlin.scm) tests."""

import jax.numpy as jnp
import numpy as np

from scheme_raytrace.ops import texture
from scheme_raytrace.scene import compile_scene, objects as ob
from scheme_raytrace.scene import perlin


def _eval(scene, tex_id, p):
    n = p.shape[0]
    z = jnp.zeros(n)
    return texture.value(scene, jnp.full(n, tex_id, jnp.int32), z, z,
                         jnp.asarray(p, jnp.float32))


def test_constant_texture():
    sc = compile_scene([ob.Sphere((0, 0, 0), 1, ob.Lambertian((0.2, 0.4, 0.6)))])
    out = _eval(sc, 0, np.zeros((1, 3)))
    np.testing.assert_allclose(np.asarray(out[0]), [0.2, 0.4, 0.6], atol=1e-6)


def test_checker_texture_sign():
    # texture.scm:16-23: sines = sin(10x)sin(10y)sin(10z); odd when < 0
    even, odd = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    tex = ob.CheckerTexture(ob.ConstantTexture(even), ob.ConstantTexture(odd))
    sc = compile_scene([ob.Sphere((0, 0, 0), 1, ob.Lambertian(tex))])
    pts = np.array([[0.05, 0.05, 0.05],     # all sines > 0 -> even
                    [-0.05, 0.05, 0.05]])   # one negative -> odd
    out = np.asarray(_eval(sc, 0, pts))
    np.testing.assert_allclose(out[0], even, atol=1e-6)
    np.testing.assert_allclose(out[1], odd, atol=1e-6)


def test_marble_texture_range():
    # texture.scm:30-34: 0.5*(1+sin(...)) in [0, 1], gray
    tex = ob.MarbleTexture(2.0)
    sc = compile_scene([ob.Sphere((0, 0, 0), 1, ob.Lambertian(tex))])
    pts = np.random.default_rng(0).uniform(-5, 5, (256, 3))
    out = np.asarray(_eval(sc, 0, pts))
    assert out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out[:, 0], out[:, 1])  # gray
    assert out.std() > 0.05                            # actually varies


def test_image_texture_lookup():
    # texture.scm:36-50: clamped nearest-neighbor, v flipped
    img = np.zeros((2, 2, 3), np.uint8)
    img[0, 0] = (255, 0, 0)      # top-left (v=1, u=0)
    img[1, 1] = (0, 255, 0)      # bottom-right (v=0, u=1)
    tex = ob.ImageTexture(img)
    sc = compile_scene([ob.Sphere((0, 0, 0), 1, ob.Lambertian(tex))])
    n = 2
    uv = [(0.1, 0.9), (0.9, 0.1)]
    u = jnp.array([x[0] for x in uv])
    v = jnp.array([x[1] for x in uv])
    out = np.asarray(texture.value(sc, jnp.zeros(n, jnp.int32), u, v,
                                   jnp.zeros((n, 3))))
    np.testing.assert_allclose(out[0], [1.0, 0.0, 0.0], atol=1e-2)
    np.testing.assert_allclose(out[1], [0.0, 1.0, 0.0], atol=1e-2)


def test_perlin_noise_deterministic_and_seeded():
    pts = jnp.asarray(np.random.default_rng(1).uniform(-10, 10, (256, 3)),
                      jnp.float32)
    a = np.asarray(perlin.noise(7, pts))
    b = np.asarray(perlin.noise(7, pts))
    c = np.asarray(perlin.noise(8, pts))
    np.testing.assert_array_equal(a, b)     # same seed -> same field
    assert not np.allclose(a, c)            # different seed -> different field


def test_perlin_noise_zero_at_lattice_and_smooth():
    # gradient noise vanishes at lattice points
    lattice = jnp.asarray(np.mgrid[0:3, 0:3, 0:3].reshape(3, -1).T,
                          jnp.float32)
    np.testing.assert_allclose(np.asarray(perlin.noise(0, lattice)), 0.0,
                               atol=1e-5)
    # bounded roughly in [-1, 1], and actually varying
    pts = jnp.asarray(np.random.default_rng(1).uniform(-10, 10, (512, 3)),
                      jnp.float32)
    vals = np.asarray(perlin.noise(0, pts))
    assert np.abs(vals).max() <= 1.0
    assert vals.std() > 0.05
    # continuity across a lattice boundary (no cell-seam jumps)
    eps = 1e-3
    lo = np.asarray(perlin.noise(0, jnp.asarray([[1.0 - eps, 0.5, 0.5]],
                                                jnp.float32)))
    hi = np.asarray(perlin.noise(0, jnp.asarray([[1.0 + eps, 0.5, 0.5]],
                                                jnp.float32)))
    assert abs(float(lo[0]) - float(hi[0])) < 0.01


def test_perlin_soa_matches_array_form():
    pts = np.random.default_rng(3).uniform(-4, 4, (128, 3)).astype(np.float32)
    p = jnp.asarray(pts)
    a = perlin.noise(5, p)
    b = perlin.noise_xyz(5, p[:, 0], p[:, 1], p[:, 2])
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ta = perlin.turb(5, p)
    tb = perlin.turb_xyz(5, p[:, 0], p[:, 1], p[:, 2])
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))


def test_turb_nonnegative():
    pts = jnp.asarray(np.random.default_rng(2).uniform(-5, 5, (256, 3)),
                      jnp.float32)
    vals = np.asarray(perlin.turb(0, pts))
    assert vals.min() >= 0.0
    assert vals.std() > 0.01
