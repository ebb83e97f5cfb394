"""checkify NaN/Inf-instrumented rendering (SURVEY §5.2)."""

import numpy as np
import pytest
from jax.experimental import checkify

from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.scene import compile_scene
from scheme_raytrace.utils import checked_render_image

CFG = RenderConfig(nx=8, ny=8, spp=1, max_depth=3)


def test_checked_render_clean_scene_passes():
    spec = scenes.three_spheres()
    scene = compile_scene(spec.objects, sky=spec.sky)
    mean = checked_render_image(scene, spec.camera(aspect=1.0), CFG)
    assert np.isfinite(np.asarray(mean)).all()


def test_checked_render_flags_poisoned_scene():
    import dataclasses
    spec = scenes.three_spheres()
    scene = compile_scene(spec.objects, sky=spec.sky)
    bad = dataclasses.replace(scene,
                              tex_color=scene.tex_color.at[0, 0].set(np.nan))
    with pytest.raises(checkify.JaxRuntimeError):
        checked_render_image(bad, spec.camera(aspect=1.0), CFG)
