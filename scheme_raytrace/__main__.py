"""Command-line driver: render any library scene to a PPM from the shell.

The reference is configured by editing globals and drives rendering through
a GLUT window (scanline-progressive, sample count in the title bar, 'S' to
save — main.scm:493-573).  The equivalent here is headless-progressive:
passes are rendered in chunks, each chunk logs rays/s + pool occupancy +
accumulated samples, and the PPM on disk is refreshed after every chunk —
watch it in any image viewer for the same progressive-refinement UX.
Ctrl-C keeps the last written image/state; --resume continues a saved
accumulation bit-exactly (SURVEY §5.4).

    python -m scheme_raytrace render --scene cornell --nx 512 --ny 512 \
        --spp 64 --light-sampling --out cornell.ppm --chunk 8
    python -m scheme_raytrace scenes

For the reference's *interactive* window UX (live image, key bindings,
mouse probe) use the `view` subcommand — viewer.py serves the progressive
render as a browser page straight from the render process.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _build(args):
    import jax
    from .utils import smoke
    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    smoke.enable_compile_cache()
    from . import render as R
    from . import scenes
    from .config import RenderConfig
    from .scene import compile_scene

    spec = scenes.SCENES[args.scene]()
    scene = compile_scene(spec.objects, sky=spec.sky,
                          bvh=args.bvh if args.bvh != "none" else None)
    cam = spec.camera(aspect=args.nx / args.ny)
    config = RenderConfig(
        nx=args.nx, ny=args.ny, spp=args.chunk, max_depth=args.max_depth,
        seed=args.seed, light_sampling=args.light_sampling,
        traversal="bvh" if args.bvh != "none" else "brute",
        pool_rays=args.pool_rays)
    return jax, R, scene, cam, config


def cmd_render(args):
    jax, R, scene, cam, config = _build(args)
    dev = jax.devices()[0]
    print(f"[render] scene={args.scene} {args.nx}x{args.ny} spp={args.spp} "
          f"depth={config.max_depth} light_sampling={config.light_sampling} "
          f"device={dev.platform}", flush=True)

    if args.resume:
        state = R.load_state(args.resume)
        print(f"[render] resumed {args.resume} at "
              f"{int(state.sample_count)} samples", flush=True)
    else:
        state = R.init_state(config)

    profiler_ctx = None
    if args.profile:
        profiler_ctx = jax.profiler.trace(args.profile)
        profiler_ctx.__enter__()
        print(f"[render] jax.profiler trace -> {args.profile}", flush=True)

    pool = min(config.resolve_pool_rays(), config.n_pixels * config.spp)
    try:
        while int(state.sample_count) < args.spp:
            chunk = min(args.chunk, args.spp - int(state.sample_count))
            cc = config.replace(spp=chunk)
            t0 = time.perf_counter()
            state, seg, iters = R.render_with_stats(scene, cam, cc, state)
            jax.block_until_ready(state.raw_sum)
            dt = time.perf_counter() - t0
            occ = int(seg) / max(int(iters) * pool, 1)
            done = int(state.sample_count)
            eta = dt / chunk * (args.spp - done)
            print(f"[render] {done:>5}/{args.spp} samples | "
                  f"{int(seg)/dt/1e6:8.2f} Mrays/s | occupancy {occ:5.1%} | "
                  f"eta {eta:6.1f}s", flush=True)
            mean = np.asarray(state.raw_sum) / max(done, 1)
            R.write_ppm(args.out, mean)
            if args.save_state:
                R.save_state(args.save_state, state, config.seed)
    except KeyboardInterrupt:
        print("[render] interrupted — last chunk kept", flush=True)
    finally:
        if profiler_ctx is not None:
            profiler_ctx.__exit__(None, None, None)

    print(f"[render] wrote {args.out}"
          + (f" and {args.save_state}" if args.save_state else ""),
          flush=True)


def cmd_view(args):
    """Interactive progressive viewer (viewer.py — the reference's GLUT
    window, main.scm:493-573, served as a browser page from the render
    process: live refinement, pass-count title, z/s keys, click probe)."""
    jax, R, scene, cam, config = _build(args)
    from .viewer import Viewer
    v = Viewer(scene, cam, config, scene_name=args.scene,
               spp_target=args.spp, out=args.out, host=args.host,
               port=args.port, chunk=args.chunk)
    v.start_server()
    print(f"[view] serving http://{args.host}:{v.port}/ — "
          f"z toggles rendering, s saves {args.out}, click probes a pixel",
          flush=True)
    try:
        v.render_loop()
        print(f"[view] target reached ({v.samples} passes) — "
              "still serving, Ctrl-C to exit", flush=True)
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        print("[view] stopped", flush=True)
    finally:
        v.stop()


def cmd_scenes(_args):
    from . import scenes
    for name in scenes.SCENES:
        print(name)


def cmd_probe(args):
    """Debug one pixel (the reference's mouse probe, main.scm:555-561,
    printed the clicked coordinate; this prints the pixel's actual per-
    sample radiance and path statistics)."""
    import jax.numpy as jnp
    jax, R, scene, cam, config = _build(args)
    from .camera import get_rays
    from .core import rng
    from .integrator.wavefront import trace_rays_full

    n = args.samples
    dtype = config.jnp_dtype
    x, y = args.x, args.y
    print(f"[probe] scene={args.scene} pixel=({x}, {y}) "
          f"(row 0 = image bottom), {n} samples")
    key = rng.root_key(config.seed)
    k_jit, k_lens, k_trace = jax.random.split(jax.random.fold_in(key, 0), 3)
    xi = jax.random.uniform(k_jit, (n, 2), dtype)
    u = (x + xi[:, 0]) / config.nx                    # main.scm:456-457
    v = (y + xi[:, 1]) / config.ny
    o, d, time = get_rays(cam, u, v, k_lens)
    fin = trace_rays_full(scene, o, d, time, k_trace, config)
    rad = np.asarray(fin.radiance)
    segs = int(fin.segments)
    for i in range(min(n, args.show)):
        print(f"[probe]   sample {i}: radiance = "
              f"({rad[i, 0]:.5f}, {rad[i, 1]:.5f}, {rad[i, 2]:.5f})")
    mean = rad.mean(axis=0)
    print(f"[probe] mean radiance  = ({mean[0]:.5f}, {mean[1]:.5f}, "
          f"{mean[2]:.5f})")
    g = np.minimum(np.sqrt(np.maximum(mean, 0.0)), 1.0)
    u8 = [int(c) for c in np.floor(255.99 * g)]
    print(f"[probe] display (u8)   = ({u8[0]}, {u8[1]}, {u8[2]})")
    print(f"[probe] mean path len  = {segs / n:.2f} segments/sample")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="scheme_raytrace",
        description="differentiable path tracer "
                    "(scheme-raytrace capabilities, JAX/Pallas engine)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to a PPM")
    r.add_argument("--scene", default="cornell", help="scene name "
                   "(see `scenes` subcommand)")
    r.add_argument("--nx", type=int, default=200)     # main.scm:126-127
    r.add_argument("--ny", type=int, default=200)
    r.add_argument("--spp", type=int, default=16)
    r.add_argument("--max-depth", type=int, default=100)   # main.scm:26
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--light-sampling", action="store_true",
                   help="mixture cosine/light-PDF importance sampling")
    r.add_argument("--bvh", choices=["none", "median", "sah"],
                   default="none", help="sphere-group accelerator")
    r.add_argument("--pool-rays", type=int, default=None)
    r.add_argument("--chunk", type=int, default=4,
                   help="samples per progressive chunk (PPM refresh rate)")
    r.add_argument("--out", default="out.ppm")
    r.add_argument("--resume", default=None,
                   help="resume from a saved state .npz")
    r.add_argument("--save-state", default=None,
                   help="persist accumulation state after each chunk")
    r.add_argument("--profile", default=None,
                   help="write a jax.profiler trace to this directory")
    r.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    r.set_defaults(fn=cmd_render)

    s = sub.add_parser("scenes", help="list available scenes")
    s.set_defaults(fn=cmd_scenes)

    v = sub.add_parser("view", help="interactive progressive viewer "
                       "(browser-served; main.scm:493-573 equivalent)")
    v.add_argument("--scene", default="cornell")
    v.add_argument("--nx", type=int, default=200)     # main.scm:126-127
    v.add_argument("--ny", type=int, default=200)
    v.add_argument("--spp", type=int, default=0,
                   help="stop refining after N passes (0 = unbounded, "
                        "the reference's progressive UX)")
    v.add_argument("--max-depth", type=int, default=100)
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--light-sampling", action="store_true")
    v.add_argument("--bvh", choices=["none", "median", "sah"],
                   default="none")
    v.add_argument("--pool-rays", type=int, default=None)
    v.add_argument("--chunk", type=int, default=1,
                   help="passes per refresh (reference: 1)")
    v.add_argument("--out", default="view.ppm",
                   help="PPM written on the 's' key")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8808)
    v.add_argument("--cpu", action="store_true")
    v.set_defaults(fn=cmd_view)

    p = sub.add_parser("probe", help="debug one pixel (radiance/path stats)")
    p.add_argument("x", type=int)
    p.add_argument("y", type=int, help="row 0 = image bottom (PPM order "
                   "flips on write, main.scm:445)")
    p.add_argument("--scene", default="cornell")
    p.add_argument("--nx", type=int, default=200)
    p.add_argument("--ny", type=int, default=200)
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--light-sampling", action="store_true")
    p.add_argument("--bvh", choices=["none", "median", "sah"],
                   default="none")
    p.add_argument("--pool-rays", type=int, default=None)
    p.add_argument("--chunk", type=int, default=4, help=argparse.SUPPRESS)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--show", type=int, default=8,
                   help="print the first N per-sample radiances")
    p.set_defaults(fn=cmd_probe)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
