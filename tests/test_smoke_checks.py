"""The comparison checks chip_smoke.py runs on the card, run here on CPU
arrays: each passes on agreeing inputs and fails on the fault it exists
to catch.  Also: the measurement scripts refuse to run without a GPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.integrator import bounce
from scheme_raytrace.scene import compile_scene
from scheme_raytrace.utils import smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_pair(m=256):
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    config = RenderConfig(nx=16, ny=16, spp=1, max_depth=8,
                          light_sampling=True)
    plan = bounce.make_plan(scene, config)
    pk = bounce.pack(scene, spec.camera(aspect=1.0), plan, jnp.float32)
    lanes = smoke.random_lanes(m, 0, 0.0, 555.0, 16, 16)
    return bounce.step(plan, pk, *lanes)


def test_compare_step_passes_on_equal_outputs():
    ref = _step_pair()
    res = smoke.compare_step(ref, ref)
    assert res["flip_share"] == 0.0 and res["worst_err_over_tol"] == 0.0


def test_compare_step_counts_mask_flips():
    ref = _step_pair()
    sc = np.asarray(ref[5]).copy()
    sc[:1] = ~sc[:1]                           # one lane of 256 flips
    got = (*ref[:5], jnp.asarray(sc))
    res = smoke.compare_step(ref, got, flip_max=0.01)
    assert res["mask_flips"] == 1
    with pytest.raises(AssertionError):
        smoke.compare_step(ref, got, flip_max=1e-3)


def test_compare_step_fails_on_drift():
    ref = _step_pair()
    o = tuple(x * (1 + 1e-3) + 1e-3 for x in ref[0])   # every lane drifts
    with pytest.raises(AssertionError):
        smoke.compare_step(ref, (o, *ref[1:]))


def test_compare_step_fails_on_nan():
    ref = _step_pair()
    rad = (ref[3][0].at[0].set(jnp.nan), *ref[3][1:])
    with pytest.raises(AssertionError):
        smoke.compare_step(ref, (*ref[:3], rad, *ref[4:]), flip_max=1.0)


def test_compare_tree():
    a = {"x": np.linspace(-1, 1, 64), "y": np.ones(3)}
    assert smoke.compare_tree(a, a)["worst_err_over_tol"] == 0.0
    b = {"x": a["x"] * 1.01, "y": a["y"]}
    with pytest.raises(AssertionError):
        smoke.compare_tree(a, b)


def test_image_vs_golden():
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 1, (32, 32, 3))
    res = smoke.image_vs_golden(ref + 1e-4, ref)
    assert res["mae"] < 2e-4 and res["outlier_frac"] == 0.0
    bad = ref.copy()
    bad[:2] += 0.5                             # 6% of pixels off
    with pytest.raises(AssertionError):
        smoke.image_vs_golden(bad, ref)
    with pytest.raises(AssertionError):
        smoke.image_vs_golden(ref + 0.01, ref)  # MAE over the bound


def test_grads_vs_golden():
    ad64 = np.array([1.0, -0.5, 1e-6])
    assert smoke.grads_vs_golden(ad64 * 1.01, ad64, 0.1)["max_rel"] < 0.02
    with pytest.raises(AssertionError):
        smoke.grads_vs_golden(ad64 * 1.5, ad64, 0.1)


def test_cornell_physical_on_a_real_render():
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    config = RenderConfig(nx=32, ny=32, spp=2, max_depth=8,
                          light_sampling=True, pool_rays=1024)
    mean, _ = R.render_image(scene, spec.camera(aspect=1.0), config)
    res = smoke.cornell_physical(mean)
    assert res["ceiling_mean"] > res["frame_mean"]
    with pytest.raises(AssertionError):        # mirrored: walls swapped
        smoke.cornell_physical(np.asarray(mean)[:, ::-1])


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_fail_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_chip_smoke_alone_fails(tmp_path):
    src = os.path.join(ROOT, "chip_smoke.py")
    (tmp_path / "chip_smoke.py").write_text(open(src).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_compile_cache_dir_follows_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert smoke.compile_cache_dir() == "/some/where"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert smoke.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
