"""EP-analogue material-sorted dispatch A/B (SURVEY §2.4 row 3, §5.7).

Measures the general pool's forward rays/s with masked shading (default)
vs material-sorted shading (RenderConfig.material_sort=True — rank lanes
by the hit material's type, shade, unsort; bit-identical estimator,
tests/test_render.py::test_material_sorted_shading_bit_identical) on the
two scenes where sorting has the most to gain:

  * test_scene (main.scm:155-174): 4 material kinds interleaved per batch,
  * RTOW-final (random_scene, main.scm:31-89): 3 kinds over ~500 prims.

Both A and B run the GENERAL pool (material_sort routes away from the
fused path, which sorts nothing), so the diff isolates the
sort + two gathers against any locality win in shade().  Results feed
PERF.md and the default in config.py.

Run: python tools/bench_material_sort.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.integrator import pool as pool_mod
from scheme_raytrace.scene import compile_scene


def bench(scene, cam, config):
    raw0 = jnp.zeros((config.n_pixels, 3), jnp.float32)
    fn = jax.jit(lambda s, k, b: pool_mod.render_pool(s, k, config, raw0, b))
    raw, seg, _ = fn(scene, cam, 0)
    jax.block_until_ready(raw)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        raw, seg, _ = fn(scene, cam, (i + 1) * config.spp)
        float(raw[0, 0])
        times.append(time.perf_counter() - t0)
    return int(seg) / sorted(times)[1]


if __name__ == "__main__":
    from scheme_raytrace.utils import smoke
    rep = smoke.device_report()
    print(f"{rep} card: {smoke.nvidia_smi()}", flush=True)
    smoke.require_gpu(rep)
    res = 256
    cfg = RenderConfig(nx=res, ny=res, spp=4, max_depth=8,
                       pool_rays=48 * 1024, seed=0)
    for name, spec_fn, sky in [("test_scene", scenes.test_scene, "gradient"),
                               ("rtow_final", scenes.random_scene,
                                "gradient")]:
        spec = spec_fn()
        scene = compile_scene(spec.objects, sky=sky)
        cam = spec.camera(aspect=1.0)
        r_masked = bench(scene, cam, cfg)
        r_sorted = bench(scene, cam, cfg.replace(material_sort=True))
        print(f"{name:12s}  masked: {r_masked/1e6:8.2f}M  "
              f"sorted: {r_sorted/1e6:8.2f}M  "
              f"ratio sorted/masked: {r_sorted/r_masked:5.2f}", flush=True)
