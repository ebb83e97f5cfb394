"""BVH-vs-brute crossover study (VERDICT r3 #5).

Measures forward rays/s on N-sphere grids (N = 256 / 1k / 4k / 16k) for:
  * the fused pool's brute sweep (Pallas in-kernel fori at these sizes),
  * the general pool's flat threaded SAH-BVH traversal,
on the GPU.  Results feed the routing policy in
integrator/pool.render_pool_auto and PERF.md.

Run: python tools/bench_bvh_crossover.py [N ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.scene import compile_scene, objects as ob


def grid_scene(n, bvh=None):
    """sqrt(n) x sqrt(n) lambertian sphere grid + ground (the reference's
    line-upped-spheres, main.scm:177-191, at parameterized scale)."""
    side = int(round(n ** 0.5))
    rng = np.random.default_rng(7)
    objs = [ob.Sphere((0, -1000.0, 0), 1000.0,
                      ob.Lambertian((0.5, 0.5, 0.5)))]
    for i in range(side):
        for j in range(side):
            c = (i - side / 2 + 0.5, 0.2, j - side / 2 + 0.5)
            objs.append(ob.Sphere(c, 0.2, ob.Lambertian(
                tuple(rng.uniform(0.1, 0.9, 3)))))
    cam_kwargs = dict(lookfrom=(side * 0.9, side * 0.35, side * 0.9),
                      lookat=(0.0, 0.0, 0.0), vfov=30.0)
    spec = scenes.SceneSpec(objs, cam_kwargs, "gradient")
    scene = compile_scene(objs, sky="gradient", bvh=bvh)
    return scene, spec.camera(aspect=1.0)


def bench(scene, cam, config):
    st, seg, _ = R.render_with_stats(scene, cam, config,
                                     R.init_state(config))
    jax.block_until_ready(st.raw_sum)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        st, seg, _ = R.render_with_stats(scene, cam, config, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
    return int(seg) / sorted(times)[1]


if __name__ == "__main__":
    sizes = [int(x) for x in sys.argv[1:]] or [256, 1024, 4096, 16384]
    from scheme_raytrace.utils import smoke
    rep = smoke.device_report()
    print(f"{rep} card: {smoke.nvidia_smi()}", flush=True)
    smoke.require_gpu(rep)
    res = 256
    from scheme_raytrace.integrator import pool_fused
    for n in sizes:
        cfg = RenderConfig(nx=res, ny=res, spp=4, max_depth=8,
                           pool_rays=48 * 1024, seed=0)
        line = f"n={n:6d}"
        try:
            scene, cam = grid_scene(n)
            pool_fused.LAST_STEP_IMPL.clear()
            r_brute = bench(scene, cam, cfg)
            impl = pool_fused.LAST_STEP_IMPL.get("forward", "general")
            line += f"  fused-brute[{impl}]: {r_brute/1e6:8.2f}M"
        except Exception as e:  # noqa: BLE001
            line += f"  fused-brute FAILED: {type(e).__name__}"
        try:
            scene_b, cam = grid_scene(n, bvh="sah")
            r_bvh = bench(scene_b, cam, cfg.replace(traversal="bvh"))
            line += f"  bvh-pool: {r_bvh/1e6:8.2f}M rays/s"
        except Exception as e:  # noqa: BLE001
            line += f"  bvh-pool FAILED: {type(e).__name__}"
        print(line, flush=True)
