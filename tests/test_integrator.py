"""Integrator behavioral-spec tests (SURVEY §6.3 contract: main.scm:100-121).

Key closed-form cases:
- miss -> sky (gradient lerp or black)
- furnace: convex lambertian sphere under constant white sky -> L = albedo
  exactly (cosine importance sampling makes the estimator zero-variance)
- depth cap: max_depth bounces then emitted-only tail
- emission: diffuse light front-face only
- metal mirror: L = albedo * sky(reflected)
- medium transmission statistics: P(pass) = exp(-rho * length)
"""

import jax
import jax.numpy as jnp
import numpy as np

from scheme_raytrace.config import RenderConfig
from scheme_raytrace.core import vecmath as vm
from scheme_raytrace.integrator.wavefront import trace_rays, trace_rays_full
from scheme_raytrace.scene import compile_scene, objects as ob


def _trace(objs, o, d, sky="black", key=0, **cfg):
    config = RenderConfig(**{**dict(nx=1, ny=1, spp=1, max_depth=16), **cfg})
    scene = compile_scene(objs, sky=sky)
    o = jnp.asarray(o, jnp.float32)
    d = vm.unit(jnp.asarray(d, jnp.float32))
    time = jnp.zeros(o.shape[0], jnp.float32)
    return trace_rays(scene, o, d, time, jax.random.key(key), config)


WHITE_SKY = (np.ones(3), np.ones(3))
SOME_SPHERE = [ob.Sphere((0, 0, -100), 1.0, ob.Lambertian((0.5, 0.5, 0.5)))]


def test_miss_black_sky():
    L = _trace(SOME_SPHERE, [[0, 0, 0]], [[0, 0, 1]], sky="black")
    np.testing.assert_allclose(np.asarray(L[0]), 0.0)


def test_miss_gradient_sky():
    # main.scm:91-95: lerp(white, (.5,.7,1)) by t = 0.5*(y+1)
    for d, t in [([0, 1, 0], 1.0), ([0, -1, 0], 0.0), ([1, 0, 0], 0.5)]:
        L = _trace(SOME_SPHERE, [[0, 0, 0]], [d], sky="gradient")
        want = (1 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
        np.testing.assert_allclose(np.asarray(L[0]), want, atol=1e-6)


def test_furnace_lambertian():
    # Convex sphere: exactly one bounce, then escape to the white sky.
    # mult = albedo (cosine importance), sky = 1 -> L = albedo, zero variance.
    albedo = (0.3, 0.5, 0.7)
    objs = [ob.Sphere((0, 0, -3), 1.0, ob.Lambertian(albedo))]
    o = np.zeros((64, 3))
    d = np.tile([0.0, 0.0, -1.0], (64, 1))
    L = _trace(objs, o, d, sky=WHITE_SKY)
    np.testing.assert_allclose(np.asarray(L), np.tile(albedo, (64, 1)),
                               atol=1e-5)


def test_depth_cap_zero_returns_emitted_only():
    albedo = (0.5, 0.5, 0.5)
    objs = [ob.Sphere((0, 0, -3), 1.0, ob.Lambertian(albedo))]
    L = _trace(objs, [[0, 0, 0]], [[0, 0, -1]], sky=WHITE_SKY, max_depth=0)
    np.testing.assert_allclose(np.asarray(L[0]), 0.0)


def test_depth_cap_double_bounce():
    # Two parallel lambertian planes facing each other: with max_depth=k the
    # radiance is bounded by albedo^(k+1)... use albedo=1 so every allowed
    # bounce survives; with a *black* sky any finite path ends at 0 except
    # rays that escape sideways — instead check monotonicity in depth under
    # white sky: L(depth d) grows toward full transport.
    objs = [ob.xy_rect(-50, 50, -50, 50, -1, ob.Lambertian((0.8, 0.8, 0.8))),
            ob.xy_rect(-50, 50, -50, 50, 1, ob.Lambertian((0.8, 0.8, 0.8)))]
    o = np.tile([0.0, 0.0, 0.0], (512, 1))
    d = np.tile([0.0, 0.0, -1.0], (512, 1))
    Ls = [float(jnp.mean(_trace(objs, o, d, sky=WHITE_SKY, max_depth=k)))
          for k in (0, 1, 4, 16)]
    assert Ls[0] == 0.0
    assert Ls[1] <= Ls[2] <= Ls[3] + 0.02
    assert Ls[3] > 0.1


def test_emission_front_face_only():
    # material.scm:108-111: emits only when normal . dir < 0
    light = ob.xy_rect(-1, 1, -1, 1, -2, ob.DiffuseLight((2.0, 2.0, 2.0)))
    # front: ray along -z sees the +z-facing normal -> emits
    L_front = _trace([light], [[0, 0, 0]], [[0, 0, -1]], sky="black")
    np.testing.assert_allclose(np.asarray(L_front[0]), 2.0, atol=1e-6)
    # back: ray along +z from behind
    L_back = _trace([light], [[0, 0, -4]], [[0, 0, 1]], sky="black")
    np.testing.assert_allclose(np.asarray(L_back[0]), 0.0, atol=1e-6)


def test_metal_mirror_deterministic():
    # fuzz=0 mirror: L = albedo * sky(reflected).  The xy-rect at z=-5 has
    # normal +z, so reflection flips the z component and KEEPS y:
    # (0,-1,-1)/sqrt(2) -> (0,-1,+1)/sqrt(2).
    albedo = (0.9, 0.8, 0.7)
    objs = [ob.xy_rect(-10, 10, -10, 10, -5, ob.Metal(albedo, 0.0))]
    d_in = vm.unit(jnp.array([0.0, -1.0, -1.0]))
    L = _trace(objs, [[0, 0, 0]], [np.asarray(d_in)], sky="gradient")
    d_refl = np.array([0.0, -1.0, 1.0]) / np.sqrt(2)
    t = 0.5 * (d_refl[1] + 1)
    sky = (1 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
    np.testing.assert_allclose(np.asarray(L[0]), np.asarray(albedo) * sky,
                               atol=1e-4)


def test_dielectric_straight_through():
    # Head-on through a glass sphere: mostly transmitted straight (4%
    # Schlick reflection at each face also returns to the same sky color
    # by symmetry) -> L = sky(-z) exactly, attenuation (1,1,1).
    objs = [ob.Sphere((0, 0, -3), 1.0, ob.Dielectric(1.5))]
    o = np.tile([0.0, 0.0, 0.0], (256, 1))
    d = np.tile([0.0, 0.0, -1.0], (256, 1))
    L = _trace(objs, o, d, sky=WHITE_SKY)
    np.testing.assert_allclose(np.asarray(L), 1.0, atol=1e-4)


def test_medium_transmission_probability():
    # P(no scatter over chord c) = exp(-rho * c); box chord = 2 here.
    rho = 0.7
    objs = [ob.ConstantMedium(ob.Box((-5, -5, -3), (5, 5, -1),
                                     ob.Lambertian((1, 1, 1))),
                              rho, (1.0, 1.0, 1.0))]
    n = 50_000
    o = np.tile([0.0, 0.0, 0.0], (n, 1))
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    # black sky, max_depth=0: rays that scatter inside emit 0 and die at the
    # cap; rays that pass hit the sky.  White sky, depth 0: passed rays
    # contribute 1, scattered rays 0 -> mean = P(pass).
    L = _trace(objs, o, d, sky=WHITE_SKY, max_depth=0)
    p_pass = float(jnp.mean(L[:, 0]))
    np.testing.assert_allclose(p_pass, np.exp(-rho * 2.0), atol=0.01)


def test_medium_clipped_by_solid_hit():
    # A wall in front of the medium: ray hits the wall first, never scatters.
    objs = [ob.xy_rect(-10, 10, -10, 10, -0.5, ob.Lambertian((0.25, 0.25, 0.25))),
            ob.ConstantMedium(ob.Box((-5, -5, -3), (5, 5, -1),
                                     ob.Lambertian((1, 1, 1))),
                              1e6, (1.0, 1.0, 1.0))]
    o = np.tile([0.0, 0.0, 0.0], (64, 1))
    d = np.tile([0.0, 0.0, -1.0], (64, 1))
    L = _trace(objs, o, d, sky=WHITE_SKY)
    # furnace on the wall: L = wall albedo
    np.testing.assert_allclose(np.asarray(L), 0.25, atol=1e-5)


def test_segment_counter():
    config = RenderConfig(nx=1, ny=1, spp=1, max_depth=4)
    scene = compile_scene(SOME_SPHERE, sky="black")
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.tile(jnp.array([0.0, 0.0, 1.0], jnp.float32), (8, 1))  # all miss
    st = trace_rays_full(scene, o, d, jnp.zeros(8), jax.random.key(0), config)
    assert int(st.segments) == 8          # one segment each, then dead


def test_light_sampling_unbiased_vs_brute():
    # Cornell-like: emissive ceiling rect + floor.  The light-sampled
    # estimator must agree with brute-force cosine sampling in expectation.
    objs = [ob.xz_rect(-1, 1, -1, 1, 2, ob.DiffuseLight((4.0, 4.0, 4.0)),
                       flip=True),
            ob.xz_rect(-20, 20, -20, 20, 0, ob.Lambertian((0.6, 0.6, 0.6)))]
    n = 40_000
    o = np.tile([0.0, 1.0, 3.0], (n, 1))
    d = vm.unit(jnp.tile(jnp.array([0.0, -1.0, -3.0]), (n, 1)))
    kw = dict(max_depth=8)
    L_brute = _trace(objs, o, np.asarray(d), sky="black", key=1, **kw)
    L_light = _trace(objs, o, np.asarray(d), sky="black", key=2,
                     light_sampling=True, **kw)
    m_b = float(jnp.mean(L_brute))
    m_l = float(jnp.mean(L_light))
    np.testing.assert_allclose(m_l, m_b, rtol=0.06)
    assert m_l > 0.01
