"""Differentiable regeneration pool (integrator/diff_fused.py): bit-identity
with the forward pool, gradient sanity, and FD agreement."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.integrator import diff_fused
from scheme_raytrace.scene import build as sb
from scheme_raytrace.scene import compile_scene

CFG = RenderConfig(nx=16, ny=16, spp=3, max_depth=12, light_sampling=True,
                   pool_rays=256)


def _cornell():
    spec = scenes.cornell_box()
    return compile_scene(spec.objects, sky=spec.sky), spec.camera(aspect=1.0)


def test_supported_covers_cornell():
    scene, _ = _cornell()
    assert diff_fused.supported(scene, CFG)


@pytest.mark.slow
def test_image_bit_identical_to_pool():
    # Same pool, same RNG, same flush order — with a drained queue the
    # differentiable render must reproduce the forward pool image BITWISE.
    scene, cam = _cornell()
    n_iters = diff_fused.calibrate_iters(scene, cam, CFG)
    raw, segs, leftover = jax.jit(
        lambda s, c: diff_fused.render_diff_fused(s, c, CFG, n_iters)
    )(scene, cam)
    assert int(leftover) == 0
    st, segs_pool, _ = R.render_with_stats(scene, cam, CFG,
                                           R.init_state(CFG))
    np.testing.assert_array_equal(
        np.asarray(raw), np.asarray(st.raw_sum).reshape(-1, 3))
    assert int(segs) == int(segs_pool)


def test_undersized_iters_reports_leftover():
    scene, cam = _cornell()
    _, _, leftover = jax.jit(
        lambda s, c: diff_fused.render_diff_fused(s, c, CFG, 2))(scene, cam)
    assert int(leftover) > 0


@pytest.mark.slow
def test_gradients_finite_and_nonzero():
    scene, cam = _cornell()
    n_iters = diff_fused.calibrate_iters(scene, cam, CFG)
    params, rest = sb.partition(scene)

    def loss(p):
        s = sb.combine(p, rest)
        raw, _, _ = diff_fused.render_diff_fused(s, cam, CFG, n_iters)
        return jnp.mean(raw)

    g = jax.jit(jax.grad(loss))(params)
    for name, leaf in g.items():
        assert np.isfinite(np.asarray(leaf)).all(), name
    assert any(np.abs(np.asarray(v)).max() > 0 for v in g.values())


@pytest.mark.slow
def test_grad_matches_fd():
    # Smooth probe: the light's emission intensity is linear in the image —
    # FD and AD through the pool must agree tightly.
    scene, cam = _cornell()
    cfg = CFG.replace(spp=1, max_depth=6)
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = sb.partition(scene)

    @jax.jit
    def loss_at(x):
        p = dict(params)
        p["tex_color"] = params["tex_color"].at[(0, 0)].add(x)
        s = sb.combine(p, rest)
        raw, _, _ = diff_fused.render_diff_fused(s, cam, cfg, n_iters)
        return jnp.mean(raw)

    ad = float(jax.grad(loss_at)(jnp.asarray(0.0, jnp.float32)))
    eps = 1e-2
    fd = float((loss_at(jnp.asarray(eps)) - loss_at(jnp.asarray(-eps)))
               / (2 * eps))
    assert np.isfinite(ad) and abs(ad - fd) < 0.05 * max(abs(fd), 1e-3), (
        ad, fd)


@pytest.mark.parametrize("scene_name", [
    "cornell_smoke", "test_bezier",
    pytest.param("cornell_klein", marks=pytest.mark.slow),
    pytest.param("klein_scene", marks=pytest.mark.slow)])
def test_gradients_finite_through_exotic_groups(scene_name):
    # media / bezier / klein now run inside the fused step (round 4); the
    # reverse-mode pool must produce finite gradients with real signal on
    # the scene leaves each group touches (medium density is not a leaf;
    # albedo always is; bezier cp via the implicit root; klein t/normal via
    # the implicit-function correction + the exact-gradient normal).
    # cornell_klein carries the kl_center signal check: klein_scene's klein
    # is INVISIBLE from the reference *camera* (lookfrom (0,5,5) is inside
    # the |p|<125 DE<0 solid, so every march runs backward and never
    # accepts — faithful to geometry.scm:602-661 + main.scm:141-153), so
    # its zero center-gradient is CORRECT, not a dead path.
    spec = getattr(scenes, scene_name)()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=8, ny=8, spp=1, max_depth=4, pool_rays=128,
                       light_sampling=scene.n_lights > 0)
    assert diff_fused.supported(scene, cfg)
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = sb.partition(scene)

    def loss(p):
        s = sb.combine(p, rest)
        raw, _, leftover = diff_fused.render_diff_fused(s, cam, cfg, n_iters)
        return jnp.mean(raw), leftover

    (val, leftover), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    assert int(leftover) == 0
    assert np.isfinite(float(val))
    for name, leaf in g.items():
        assert np.isfinite(np.asarray(leaf)).all(), name
    assert np.abs(np.asarray(g["tex_color"])).max() > 0
    if scene_name == "test_bezier":
        assert np.abs(np.asarray(g["bez_cp"])).max() > 0
    if scene_name == "cornell_klein":
        assert np.abs(np.asarray(g["kl_center"])).max() > 0


def test_strict_render_poisons_on_underdrain():
    # render_diff_fused_strict: an undersized n_iters must surface as NaN
    # radiance (fail-loud), a drained one must match the plain render
    scene, cam = _cornell()
    raw_bad, _, lo = jax.jit(
        lambda s, c: diff_fused.render_diff_fused_strict(s, c, CFG, 2)
    )(scene, cam)
    assert int(lo) > 0
    assert np.isnan(np.asarray(raw_bad)).all()

    n_iters = diff_fused.calibrate_iters(scene, cam, CFG)
    raw_ok, _, lo = jax.jit(
        lambda s, c: diff_fused.render_diff_fused_strict(s, c, CFG, n_iters)
    )(scene, cam)
    assert int(lo) == 0
    assert np.isfinite(np.asarray(raw_ok)).all()
