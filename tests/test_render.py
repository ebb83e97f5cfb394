"""Render pipeline tests: accumulation, display transform, PPM writer,
checkpoint/resume (main.scm:428-491, :123-124, :439-450; SURVEY §5.4)."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.scene import compile_scene

CFG = RenderConfig(nx=8, ny=8, spp=2, max_depth=4)


def _tiny():
    spec = scenes.test_scene()
    return compile_scene(spec.objects, sky=spec.sky), spec.camera(aspect=1.0)


def test_render_accumulates_passes():
    scene, cam = _tiny()
    st = R.render(scene, cam, CFG, R.init_state(CFG))
    assert int(st.sample_count) == 2
    assert st.raw_sum.shape == (8, 8, 3)
    assert bool(jnp.all(jnp.isfinite(st.raw_sum)))
    assert bool(jnp.all(st.raw_sum >= 0.0))


def test_render_deterministic():
    scene, cam = _tiny()
    a = R.render(scene, cam, CFG, R.init_state(CFG))
    b = R.render(scene, cam, CFG, R.init_state(CFG))
    np.testing.assert_array_equal(np.asarray(a.raw_sum), np.asarray(b.raw_sum))


def test_resume_matches_one_shot():
    # 2 passes then 2 more == 4 passes in one go (pass keys derive from
    # sample_count, so resumption is bit-exact — SURVEY §5.4).
    scene, cam = _tiny()
    one = R.render(scene, cam, CFG.replace(spp=4), R.init_state(CFG))
    st = R.render(scene, cam, CFG, R.init_state(CFG))
    st = R.render(scene, cam, CFG, st)
    np.testing.assert_allclose(np.asarray(st.raw_sum), np.asarray(one.raw_sum),
                               rtol=1e-6)


def test_pool_statistically_matches_scan_path():
    # The regeneration pool (integrator/pool.py) and the per-pass scan
    # (differentiable path) are two estimators of the same integral with
    # different RNG streams — their means must agree within MC noise.
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    # Tolerance calibrated to the measured seed-to-seed MC noise of this
    # config (std/mean ~1.9% at spp=32 over 5 seeds; fireflies are
    # heavy-tailed, so allow ~5 sigma).
    cfg = RenderConfig(nx=32, ny=32, spp=8, max_depth=8, light_sampling=True)
    pool_mean, _ = R.render_image(scene, cam, cfg)
    scan_mean, _ = R.render_image(scene, cam, cfg.replace(differentiable=True))
    np.testing.assert_allclose(float(np.asarray(pool_mean).mean()),
                               float(np.asarray(scan_mean).mean()), rtol=0.12)


def test_pool_small_pool_drains_all_work():
    # pool_rays smaller than the work list: lanes must regenerate through
    # the whole frame (every pixel gets exactly spp samples of signal).
    spec = scenes.test_scene_grid()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=8, ny=8, spp=4, max_depth=3, pool_rays=16)
    st, segments, iters = R.render_with_stats(scene, cam, cfg,
                                              R.init_state(cfg))
    assert int(st.sample_count) == 4
    arr = np.asarray(st.raw_sum)
    assert np.isfinite(arr).all() and (arr > 0).all()   # gradient sky: no black
    # same image as a big pool (work-item-keyed RNG -> layout-invariant)
    st_big = R.render(scene, cam, cfg.replace(pool_rays=1 << 14),
                      R.init_state(cfg))
    np.testing.assert_allclose(arr, np.asarray(st_big.raw_sum), rtol=1e-5)


def test_to_u8_display_transform():
    # main.scm:461-465: floor(255.99 * min(1, sqrt(mean)))
    mean = np.array([[[0.0, 0.25, 4.0]]])
    out = R.to_u8(mean)
    np.testing.assert_array_equal(out[0, 0], [0, int(255.99 * 0.5), 255])
    assert out.dtype == np.uint8


def test_ppm_roundtrip(tmp_path):
    mean = np.random.default_rng(0).uniform(0, 1, (4, 6, 3))
    path = str(tmp_path / "t.ppm")
    R.write_ppm(path, mean)
    with open(path) as f:
        toks = f.read().split()
    assert toks[0] == "P3"
    assert (int(toks[1]), int(toks[2]), int(toks[3])) == (6, 4, 255)
    vals = np.array(toks[4:], np.uint8).reshape(4, 6, 3)
    # writer flips rows (main.scm:445)
    np.testing.assert_array_equal(vals, R.to_u8(mean)[::-1])


def test_save_load_state(tmp_path):
    scene, cam = _tiny()
    st = R.render(scene, cam, CFG, R.init_state(CFG))
    path = str(tmp_path / "ckpt.npz")
    R.save_state(path, st, seed=0)
    st2 = R.load_state(path)
    np.testing.assert_array_equal(np.asarray(st.raw_sum), np.asarray(st2.raw_sum))
    assert int(st2.sample_count) == int(st.sample_count)


def test_render_image_mean():
    scene, cam = _tiny()
    mean, st = R.render_image(scene, cam, CFG)
    np.testing.assert_allclose(np.asarray(mean),
                               np.asarray(st.raw_sum) / 2.0, rtol=1e-6)


def test_banded_render_bit_identical():
    # Large frames render as sequential row-band pool drains
    # (pool.BAND_PIX).
    # Band-major issue order must be BIT-identical to frame-major: RNG is
    # keyed by global (pass, pixel) ids and per-pixel accumulation stays
    # pass-major.  Forced here by shrinking the threshold.
    from scheme_raytrace.integrator import pool as pool_mod

    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=16, ny=16, spp=2, max_depth=6,
                       light_sampling=True, pool_rays=128)
    raw0 = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    ref, seg_ref, _ = jax.jit(
        lambda s, c: pool_mod.render_pool_auto(s, c, cfg, raw0, 0)
    )(scene, cam)

    old = pool_mod.BAND_PIX
    pool_mod.BAND_PIX = 64            # 16x16 frame -> 4 bands of 4 rows
    try:
        banded, seg_b, _ = jax.jit(
            lambda s, c: pool_mod.render_pool_auto(s, c, cfg, raw0, 0)
        )(scene, cam)
    finally:
        pool_mod.BAND_PIX = old
    assert int(seg_b) == int(seg_ref)
    np.testing.assert_array_equal(np.asarray(banded), np.asarray(ref))


def test_material_sorted_shading_bit_identical():
    # EP-analogue material-sorted dispatch (SURVEY §2.4 row 3): ranking
    # the pool's lanes by material type before shade() and unsorting after
    # must be BIT-identical to the masked path — shade() is elementwise,
    # so a lane permutation commutes with it exactly.  test_scene mixes
    # lambertian/checker/metal/dielectric (main.scm:155-174), so the sort
    # is a real permutation every bounce.
    from scheme_raytrace.integrator import pool as pool_mod

    spec = scenes.test_scene()
    scene = compile_scene(spec.objects, sky="gradient")  # light the materials
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=16, ny=16, spp=2, max_depth=8, pool_rays=128)
    raw0 = jnp.zeros((cfg.n_pixels, 3), jnp.float32)

    def run(c):
        raw, seg, _ = jax.jit(
            lambda s, k: pool_mod.render_pool(s, k, c, raw0, 0)
        )(scene, cam)
        return np.asarray(raw), int(seg)

    ref, seg_ref = run(cfg)
    srt, seg_srt = run(cfg.replace(material_sort=True))
    assert seg_ref == seg_srt
    np.testing.assert_array_equal(ref, srt)
    assert ref.max() > 0


def test_pixel_group_pool_bit_identical_and_routed():
    # K>1 pixel-group work items (pool_fused module doc): per-pixel pass
    # order, RNG keys, and the one-scatter-add-per-pixel contract are all
    # K-invariant, so the K=4 pool must render BIT-identically to K=1.
    # Also pins the routing heuristic (choose_group): K>1 only with >= 2
    # items/lane, stride 1, and no march-heavy prims (klein/bezier).
    from scheme_raytrace.integrator import bounce, pool_fused

    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=32, ny=32, spp=2, max_depth=6, light_sampling=True,
                       pool_rays=128)
    plan = bounce.make_plan(scene, cfg)
    assert pool_fused.choose_group(1024, 128, 1, plan) == 4
    assert pool_fused.choose_group(1024, 512, 1, plan) == 1   # <2 items/lane
    assert pool_fused.choose_group(1024, 128, 8, plan) == 1   # strided
    kplan = bounce.make_plan(
        compile_scene(scenes.klein_scene().objects, sky="gradient"), cfg)
    assert pool_fused.choose_group(1024, 128, 1, kplan) == 1  # march-heavy

    raw0 = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    rawK, segK, _ = pool_fused.render_pool_fused(scene, cam, cfg, raw0, 0)
    orig = pool_fused.GROUP_MAX
    try:
        pool_fused.GROUP_MAX = 1                 # force the K=1 pool
        raw1, seg1, _ = pool_fused.render_pool_fused(scene, cam, cfg,
                                                     raw0, 0)
    finally:
        pool_fused.GROUP_MAX = orig
    assert np.asarray(rawK).max() > 0
    assert int(segK) == int(seg1)
    np.testing.assert_array_equal(np.asarray(rawK), np.asarray(raw1))


def test_pool_auto_sizing():
    # pool_rays=None resolves the measured per-direction optima (VERDICT
    # r4 #9): 64k forward / 24k reverse on the bench workload, clamped to
    # the work size on small frames, explicit values untouched.
    cfg = RenderConfig(nx=512, ny=512, spp=16)
    assert cfg.pool_rays is None
    assert cfg.resolve_pool_rays() == 64 * 1024
    assert cfg.resolve_pool_rays(reverse=True) == 24 * 1024
    assert cfg.replace(pool_rays=4096).resolve_pool_rays(reverse=True) == 4096
    # small frame: m clamps to the (grouped) work size, not the cap
    from scheme_raytrace.integrator import bounce, pool_fused
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    small = RenderConfig(nx=16, ny=16, spp=2, max_depth=4,
                         light_sampling=True)
    raw0 = jnp.zeros((small.n_pixels, 3), jnp.float32)
    raw, seg, _ = pool_fused.render_pool_fused(scene, cam, small, raw0, 0)
    assert np.asarray(raw).max() > 0 and int(seg) > 0
