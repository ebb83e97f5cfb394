"""Per-scene forward rays/s on the current backend (fused-path coverage).

Run `python tools/bench_scenes.py [scene ...]` on a GPU; prints one line
per scene with the executed step impl (pallas kernel, or general-pool for
scenes outside the fused step), with the card's name and power limit.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from scheme_raytrace import scenes
from scheme_raytrace import render as R
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.integrator import pool_fused
from scheme_raytrace.scene import compile_scene

DEFAULT = ["cornell", "cornell_smoke", "klein", "cornell_klein",
           "bezier", "cornell_bezier"]


def bench_one(name, size=512, spp=8):
    spec = scenes.SCENES[name]()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=100,
                          light_sampling=scene.n_lights > 0, seed=0,
                          pool_rays=48 * 1024)
    st, seg, iters = R.render_with_stats(scene, cam, config,
                                         R.init_state(config))
    jax.block_until_ready(st.raw_sum)
    impl = pool_fused.LAST_STEP_IMPL.get("forward", "general-pool")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        st, seg, iters = R.render_with_stats(scene, cam, config, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]
    print(f"{name:18s} impl={impl:8s} {int(seg)/med/1e6:8.2f}M rays/s "
          f"({int(seg)} segs, {med*1e3:.0f} ms)", flush=True)


if __name__ == "__main__":
    from scheme_raytrace.utils import smoke
    rep = smoke.device_report()
    print(f"{rep} card: {smoke.nvidia_smi()}", flush=True)
    smoke.require_gpu(rep)
    names = sys.argv[1:] or DEFAULT
    for n in names:
        pool_fused.LAST_STEP_IMPL.clear()
        bench_one(n)
