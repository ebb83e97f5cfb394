"""Scene library smoke tests: every reference scene (main.scm:155-426,
SURVEY §2.3) compiles and renders finite, plausible output at thumbnail
size.  These are the framework's A/B "golden-eye" harness, automated."""

import jax.numpy as jnp
import numpy as np
import pytest

from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.scene import compile_scene

CFG = RenderConfig(nx=16, ny=16, spp=1, max_depth=8)


@pytest.mark.parametrize("name", sorted(scenes.SCENES))
def test_scene_renders(name):
    spec = scenes.SCENES[name]()
    scene = compile_scene(spec.objects, sky=spec.sky, lights=spec.lights)
    cam = spec.camera(aspect=1.0)
    cfg = CFG
    if name in ("klein", "cornell_klein"):      # fori march is slow on CPU
        cfg = CFG.replace(nx=8, ny=8, max_depth=3)
    mean, _ = R.render_image(scene, cam, cfg)
    arr = np.asarray(mean)
    assert np.isfinite(arr).all(), f"{name}: non-finite radiance"
    if name == "textured":
        # textured exercises the raw noise texture, whose value is the raw
        # gradient noise in [-1, 1] (texture.scm:25-28 — dead code in the
        # reference, reproduced as-is), so slightly negative radiance is
        # the CORRECT output of that (unphysical) albedo.
        assert arr.min() > -1.0, f"{name}: noise albedo out of range"
    else:
        assert (arr >= 0).all(), f"{name}: negative radiance"
    if name == "test":
        # test-scene is black sky + zero emitters (main.scm:155-174): the
        # only correct render is all black (in the reference it crashes
        # outright on B3; our fixed protocol renders it, to black).
        assert arr.max() == 0.0, f"{name}: expected all-black render"
    else:
        assert arr.max() > 0.0, f"{name}: all-black render"


def test_cornell_light_sampled_renders():
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    assert scene.n_lights == 1
    cam = spec.camera(aspect=1.0)
    mean, _ = R.render_image(scene, cam, CFG.replace(light_sampling=True))
    arr = np.asarray(mean)
    assert np.isfinite(arr).all() and arr.max() > 0.0


def test_scene_structure_counts():
    # cornell: 5 walls + light + 2 boxes (12 rects) = 18 rects
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    assert scene.rect_k.shape[0] == 18
    assert scene.has_rect_xform            # rotated boxes
    # grid: ground + 100 spheres
    scene = compile_scene(scenes.test_scene_grid().objects, sky="gradient")
    assert scene.sph_r.shape[0] == 101
    # smoke: two media
    scene = compile_scene(scenes.cornell_smoke().objects, sky="black")
    assert scene.med_kind.shape[0] == 2 and scene.has_media
    # random scene has moving spheres
    scene = compile_scene(scenes.random_scene().objects, sky="gradient")
    assert scene.has_moving


def test_cornell_light_is_brightest_and_on_ceiling():
    # The emitter (emit 3,3,3 at k=554, main.scm:336) must dominate the top
    # half of the image (row 0 = bottom).  Robust statistics only: at finite
    # spp single mixture-PDF estimates f/pdf*L legitimately exceed the raw
    # emission, so no ==3.0 pixel check (round-1 ADVICE item 1); and the
    # argmax pixel itself is an MC-noise statistic (ADVICE item 2), so the
    # location check uses the mean row of ALL bright pixels instead.
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    mean, _ = R.render_image(scene, cam,
                             RenderConfig(nx=32, ny=32, spp=16, max_depth=8,
                                          light_sampling=True))
    lum = np.asarray(mean).mean(-1)
    bright = lum >= 2.0     # ~the emitter (emission 3.0, everything else <1)
    assert bright.any(), f"no pixel reaches the emitter brightness (max {lum.max():.2f})"
    rows = np.nonzero(bright)[0]
    assert rows.mean() >= 16, f"bright pixels centered at row {rows.mean():.1f}"
