"""Fused SoA bounce (integrator/bounce.py) equivalence tests.

The fused pool must reproduce the general masked-sweep pool: identical
RNG streams and estimator, so images agree to f32 op-reordering noise
(rsqrt-vs-sqrt normalization etc.), with at most rare branch-flip pixels.
The Pallas kernel (Triton route, interpret mode on CPU) must match the
plain-jnp trace of the same step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.integrator import bounce, pool, pool_fused
from scheme_raytrace.scene import compile_scene, objects as ob


def _render_both(spec, config, sky=None):
    scene = compile_scene(spec.objects, sky=sky or spec.sky)
    cam = spec.camera(aspect=1.0)
    assert bounce.supported(scene, config)
    raw0 = jnp.zeros((config.n_pixels, 3), jnp.float32)
    fused, seg_f, _ = pool_fused.render_pool_fused(scene, cam, config,
                                                   raw0, 0)
    vec, seg_v, _ = pool.render_pool(scene, cam, config, raw0, 0)
    return np.asarray(fused), np.asarray(vec), int(seg_f), int(seg_v)


def _assert_close(fused, vec, outlier_frac=0.02):
    assert np.isfinite(fused).all()
    assert vec.max() > 0
    diff = np.abs(fused - vec)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < outlier_frac


CFG = RenderConfig(nx=16, ny=16, spp=2, max_depth=8, use_pallas=False)


def test_fused_matches_vector_cornell_light_sampled():
    f, v, sf, sv = _render_both(scenes.cornell_box(),
                                CFG.replace(light_sampling=True))
    _assert_close(f, v)
    # same termination decisions -> same total path segments (modulo rare
    # f32 branch flips changing a path's length)
    assert abs(sf - sv) <= 0.01 * sv + 50


def test_fused_matches_vector_rtow_spheres():
    # metal + dielectric + hollow + checker ground (test_scene, B3 fix)
    f, v, *_ = _render_both(scenes.test_scene(), CFG, sky="gradient")
    _assert_close(f, v)


def test_fused_matches_vector_moving_spheres():
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.6, 0.6, 0.2))),
            ob.MovingSphere((0, 0, -1), (0, 0.4, -1), 0.0, 1.0, 0.5,
                            ob.Lambertian((0.2, 0.3, 0.7)))]
    spec = scenes.SceneSpec(objs, scenes.default_camera(), "gradient")
    f, v, *_ = _render_both(spec, CFG.replace(max_depth=5))
    _assert_close(f, v)


def test_big_scene_runs_fused_prim_loop():
    # >64 prims take the fori_loop sweep (dynamic pk offsets);
    # the fused image must still match the general masked-sweep pool
    spec = scenes.random_scene(seed=3)
    cfg = RenderConfig(nx=8, ny=8, spp=1, max_depth=4, use_pallas=False)
    scene = compile_scene(spec.objects, sky=spec.sky)
    assert bounce.supported(scene, cfg)
    assert (int(scene.sph_r.shape[0]) > bounce.UNROLL_MAX)
    f, v, *_ = _render_both(spec, cfg)
    _assert_close(f, v)


def test_fused_matches_vector_sphere_light():
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.5, 0.5, 0.5))),
            ob.Sphere((0, 1.5, -1), 0.6, ob.DiffuseLight((4.0, 4.0, 4.0))),
            ob.xz_rect(-0.5, 0.5, -1.5, -0.5, 2.5,
                       ob.DiffuseLight((3.0, 3.0, 3.0)))]
    spec = scenes.SceneSpec(objs, scenes.default_camera(), "black")
    scene = compile_scene(objs, sky="black")
    assert scene.n_lights == 2
    f, v, *_ = _render_both(spec, CFG.replace(light_sampling=True))
    _assert_close(f, v)


def test_fused_matches_vector_marble_light_scene():
    # test_scene2 (simple-light marble, main.scm:316-328): covered by the
    # fused path since hash perlin runs in register
    f, v, *_ = _render_both(scenes.test_scene2(), CFG)
    _assert_close(f, v)


def test_unsupported_scenes_fall_back():
    # round 4 lifted media/bezier/klein into the fused path; round 5 added
    # small-atlas image textures on spheres/rects — remaining exclusions
    # are big atlases, image-textured exotic groups, BVH traversal, and
    # russian roulette
    cfg = CFG
    for spec in [scenes.cornell_smoke(), scenes.test_bezier(),
                 scenes.klein_scene(), scenes.textured_scene()]:
        scene = compile_scene(spec.objects, sky=spec.sky)
        assert bounce.supported(scene, cfg)
    scene = compile_scene(scenes.textured_scene().objects, sky="gradient")
    assert not bounce.supported(scene, cfg.replace(traversal="bvh"))
    # atlas beyond IMG_ROWS_MAX -> general pool
    from scheme_raytrace.scene import objects as ob
    big = np.zeros((128, 128, 3), np.float32)
    sbig = compile_scene(
        [ob.Sphere((0, 0, -1), 0.5, ob.Lambertian(ob.ImageTexture(big)))],
        sky="gradient")
    assert not bounce.supported(sbig, cfg)
    # image texture on an excluded group (bezier, u=v=0 convention)
    sb_bez = compile_scene(
        [ob.Bezier([[0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0]], 0.1,
                   ob.Lambertian(ob.ImageTexture(np.ones((4, 4, 3)))))],
        sky="gradient")
    assert not bounce.supported(sb_bez, cfg)
    # render still works through the auto dispatcher
    spec = scenes.klein_scene()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cfgk = RenderConfig(nx=8, ny=8, spp=1, max_depth=3)
    mean, _ = R.render_image(scene, spec.camera(aspect=1.0), cfgk)
    assert np.isfinite(np.asarray(mean)).all()


def test_fused_matches_vector_image_texture():
    # image textures in the fused step (texture.scm:36-50; round-5 close
    # of the last feature-class exclusion): chunked lane-gather atlas +
    # in-kernel sphere UV; texel picks match the general pool except for
    # boundary-straddling samples (covered by the outlier allowance).
    f, v, sf, sv = _render_both(scenes.textured_scene(), CFG)
    _assert_close(f, v)
    assert sf == sv


def test_pallas_interpret_matches_jnp_step():
    spec = scenes.cornell_box()
    config = RenderConfig(nx=16, ny=16, spp=1, max_depth=8,
                          light_sampling=True)
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    plan = bounce.make_plan(scene, config)
    pk = bounce.pack(scene, cam, plan, jnp.float32)

    m = 256
    key = jax.random.key(0)
    ks = jax.random.split(key, 8)
    gitem = jnp.arange(m, dtype=jnp.int32)
    px = jax.random.randint(ks[0], (m,), 0, 16).astype(jnp.float32)
    py = jax.random.randint(ks[1], (m,), 0, 16).astype(jnp.float32)
    fresh = jax.random.bernoulli(ks[2], 0.5, (m,))
    alive = fresh | jax.random.bernoulli(ks[3], 0.7, (m,))
    depth = jax.random.randint(ks[4], (m,), 0, 4)
    o = tuple(jax.random.uniform(ks[5], (m,)) * 500.0 for _ in range(3))
    dvec = jax.random.normal(ks[6], (m, 3))
    dvec = dvec / jnp.linalg.norm(dvec, axis=-1, keepdims=True)
    d = (dvec[:, 0], dvec[:, 1], dvec[:, 2])
    time = jnp.zeros(m)
    rad = tuple(jnp.zeros(m) for _ in range(3))
    tp = tuple(jnp.ones(m) for _ in range(3))

    ref = bounce.step(plan, pk, gitem, px, py, fresh, alive, depth,
                      o, d, time, rad, tp)
    kern = bounce.as_pallas(plan, m, interpret=True)
    got = kern(plan, pk, gitem, px, py, fresh, alive, depth,
               o, d, time, rad, tp)

    for r, g, name in [
        (ref[0], got[0], "o"), (ref[1], got[1], "d"),
        (ref[3], got[3], "rad"), (ref[4], got[4], "tp"),
    ]:
        for i in range(3):
            # atol covers Cornell-scale (0..555) coordinates; interpret-mode
            # compiles the same graph with different fusion/rounding
            np.testing.assert_allclose(np.asarray(g[i]), np.asarray(r[i]),
                                       rtol=1e-4, atol=1e-3,
                                       err_msg=f"{name}[{i}]")
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(ref[2]),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got[5]), np.asarray(ref[5]))


def test_fused_matches_vector_cornell_smoke():
    # constant media (geometry.scm:545-578) now resolve inside the fused
    # step: boundary interval + exponential scatter distance drawn from
    # the same GROUP_MEDIUM hash columns as the general pool
    f, v, sf, sv = _render_both(scenes.cornell_smoke(), CFG)
    _assert_close(f, v)
    assert abs(sf - sv) <= 0.01 * sv + 50


def test_fused_matches_vector_klein():
    # kleinian SDF sphere-traced in the fused step (geometry.scm:580-664)
    cfg = RenderConfig(nx=8, ny=8, spp=1, max_depth=3, use_pallas=False)
    f, v, sf, sv = _render_both(scenes.klein_scene(), cfg)
    _assert_close(f, v)
    assert abs(sf - sv) <= 0.01 * sv + 20


def test_fused_matches_vector_bezier():
    # bezier ribbons via the in-step Newton-on-seeds probe (bezier.scm)
    f, v, sf, sv = _render_both(scenes.test_bezier(), CFG)
    _assert_close(f, v)
    assert abs(sf - sv) <= 0.01 * sv + 50


def test_fused_matches_vector_cornell_bezier():
    f, v, *_ = _render_both(scenes.cornell_bezier(),
                            CFG.replace(light_sampling=True))
    _assert_close(f, v)


def test_pallas_interpret_matches_jnp_step_image_tex():
    # the image-texture kernel path (tuple pk with the flat texel atlas,
    # per-channel texel gather, arctan2 sphere UV) must match the
    # plain-jnp trace of the same step in interpret mode
    spec = scenes.textured_scene()
    config = RenderConfig(nx=16, ny=16, spp=1, max_depth=8)
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    plan = bounce.make_plan(scene, config)
    assert plan.has_image and plan.img_rows == 6
    pk = bounce.pack(scene, cam, plan, jnp.float32)

    m = 256
    ks = jax.random.split(jax.random.key(0), 8)
    gitem = jnp.arange(m, dtype=jnp.int32)
    px = jax.random.randint(ks[0], (m,), 0, 16).astype(jnp.float32)
    py = jax.random.randint(ks[1], (m,), 0, 16).astype(jnp.float32)
    fresh = jax.random.bernoulli(ks[2], 0.5, (m,))
    alive = fresh | jax.random.bernoulli(ks[3], 0.7, (m,))
    depth = jax.random.randint(ks[4], (m,), 0, 4)
    o = tuple(jax.random.uniform(ks[5], (m,)) * 2.0 - 1.0 for _ in range(3))
    dvec = jax.random.normal(ks[6], (m, 3))
    dvec = dvec / jnp.linalg.norm(dvec, axis=-1, keepdims=True)
    d = (dvec[:, 0], dvec[:, 1], dvec[:, 2])
    zero = jnp.zeros(m)
    rad = (zero, zero, zero)
    tp = (jnp.ones(m),) * 3

    ref = bounce.step(plan, pk, gitem, px, py, fresh, alive, depth,
                      o, d, zero, rad, tp)
    got = bounce.as_pallas(plan, m, interpret=True)(
        plan, pk, gitem, px, py, fresh, alive, depth, o, d, zero, rad, tp)
    for r, g, name in [(ref[0], got[0], "o"), (ref[1], got[1], "d"),
                       (ref[3], got[3], "rad"), (ref[4], got[4], "tp")]:
        for i in range(3):
            np.testing.assert_allclose(np.asarray(g[i]), np.asarray(r[i]),
                                       rtol=1e-4, atol=1e-3,
                                       err_msg=f"{name}[{i}]")
    np.testing.assert_array_equal(np.asarray(got[5]), np.asarray(ref[5]))
