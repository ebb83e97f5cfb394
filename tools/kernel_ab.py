"""End-to-end A/B of the Pallas bounce kernels against the plain-jnp step
that XLA compiles, on the GPU, in one process, taking turns.

    python tools/kernel_ab.py [--cells fwd,fwdbwd,random,klein] [--reps 2]
    python tools/kernel_ab.py --sweep 128x4,256x4,256x8,512x8 [--cells ...]

Each cell renders through the normal entry points with
RenderConfig.use_pallas forced True (kernel) and False (XLA's jnp step),
in the order kernel, jnp, jnp, kernel per repetition.  Prints rays/s per
run and the median per arm, with the card's name and power limit.
`--sweep` instead renders the forward cells with the kernel only, at each
lanes-per-program x warps setting (bounce.BLOCK_LANES, NUM_WARPS), in
turns.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _forward_cell(scene, cam, config):
    import jax
    from scheme_raytrace import render as R

    def make(flag):
        cfg = config.replace(use_pallas=flag)
        st0 = R.init_state(cfg)
        t0 = time.perf_counter()
        compiled = R.render_with_stats.lower(scene, cam, cfg, st0).compile()
        setup = time.perf_counter() - t0

        def run():
            t0 = time.perf_counter()
            st, seg, _ = compiled(scene, cam, st0)
            jax.block_until_ready(st.raw_sum)
            return int(seg), time.perf_counter() - t0
        run()                                   # warm-up
        return run, setup
    return make


def _fwdbwd_cell(scene, cam, config):
    import jax
    import jax.numpy as jnp
    from scheme_raytrace.integrator import diff_fused
    from scheme_raytrace.scene import build as sb

    n_iters = diff_fused.calibrate_iters(scene, cam, config)
    params, rest = sb.partition(scene)

    def make(flag):
        cfg = config.replace(use_pallas=flag)

        def loss_fn(params):
            raw, segs, leftover = diff_fused.render_diff_fused(
                sb.combine(params, rest), cam, cfg, n_iters)
            return jnp.sum(raw ** 2) / raw.size, (segs, leftover)

        t0 = time.perf_counter()
        compiled = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
            params).compile()
        setup = time.perf_counter() - t0

        def run():
            t0 = time.perf_counter()
            (_, (segs, leftover)), grads = compiled(params)
            jax.block_until_ready(grads)
            dt = time.perf_counter() - t0
            assert int(leftover) == 0
            return int(segs), dt
        run()
        return run, setup
    return make


def _sweep(cells, args, card):
    import jax
    from scheme_raytrace.integrator import bounce
    settings = [tuple(int(v) for v in s.split("x"))
                for s in args.sweep.split(",")]
    for name in args.cells.split(","):
        make = cells[name]()
        runs = {}
        for blk, warps in settings:
            bounce.BLOCK_LANES, bounce.NUM_WARPS = blk, warps
            jax.clear_caches()          # re-trace with the new setting
            runs[blk, warps] = make(True)[0]
        rates = {k: [] for k in settings}
        for _ in range(args.reps):
            for k in settings + settings[::-1]:
                seg, dt = runs[k]()
                rates[k].append(seg / dt)
        for k in settings:
            r = sorted(rates[k])
            print(f"[sweep] {name} block={k[0]} warps={k[1]}: "
                  f"{r[len(r) // 2] / 1e6:.2f}M rays/s "
                  f"{[round(x / 1e6, 2) for x in rates[k]]} on {card}",
                  flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="fwd,fwdbwd,random,klein")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--sweep", default="",
                    help="comma-separated BLOCKxWARPS kernel settings")
    args = ap.parse_args()

    from scheme_raytrace.utils import smoke
    smoke.enable_compile_cache()
    rep = smoke.device_report()
    card = smoke.nvidia_smi()
    print(f"[ab] {rep} card: {card}", flush=True)
    smoke.require_gpu(rep)

    from scheme_raytrace import scenes
    from scheme_raytrace.config import RenderConfig
    from scheme_raytrace.scene import compile_scene

    def build(name, spp, ls):
        spec = scenes.SCENES[name]()
        scene = compile_scene(spec.objects, sky=spec.sky)
        return (scene, spec.camera(aspect=1.0),
                RenderConfig(nx=512, ny=512, spp=spp, max_depth=100,
                             light_sampling=ls))

    cells = {
        "fwd": lambda: _forward_cell(*build("cornell", 16, True)),
        "fwdbwd": lambda: _fwdbwd_cell(*build("cornell", 8, True)),
        "random": lambda: _forward_cell(*build("random", 16, False)),
        "klein": lambda: _forward_cell(*build("cornell_klein", 4, True)),
    }
    if args.sweep:
        _sweep(cells, args, card)
        return
    for name in args.cells.split(","):
        make = cells[name]()
        runs = {}
        for flag in (True, False):
            runs[flag] = make(flag)
            print(f"[ab] {name} {'kernel' if flag else 'jnp'} compile "
                  f"{runs[flag][1]:.1f}s", flush=True)
        rates = {True: [], False: []}
        for _ in range(args.reps):
            for flag in (True, False, False, True):
                seg, dt = runs[flag][0]()
                rates[flag].append(seg / dt)
        med = {f: sorted(r)[len(r) // 2] for f, r in rates.items()}
        print(f"[ab] {name}: kernel {med[True] / 1e6:.2f}M rays/s "
              f"{[round(r / 1e6, 2) for r in rates[True]]} | jnp "
              f"{med[False] / 1e6:.2f}M rays/s "
              f"{[round(r / 1e6, 2) for r in rates[False]]} | kernel/jnp "
              f"{med[True] / med[False]:.3f} on {card}", flush=True)


if __name__ == "__main__":
    main()
