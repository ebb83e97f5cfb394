"""Smoke test of the renderer on one GPU: the quickest proof that the system
starts on the card and renders right.

    python chip_smoke.py            # all one-card phases
    python chip_smoke.py --four     # only the four-card phase (4 GPUs)
    python chip_smoke.py --phase kernels --phase main   # chosen phases

Phases, in one process (a second JAX process would not get card memory):
  device   platform, device kind and count, JAX version, XLA_FLAGS, the
           card's name and power limit; fails unless the platform is gpu
  kernels  each Pallas kernel vs `bounce.step` traced as plain jnp, on the
           card at the pool's real lane counts, for three plans
  parity   the six parity configs in f32 vs the committed f64 oracle
           goldens (image and gradients, tests/test_parity.py criteria)
  main     the main path at full size through the CLI and the library:
           Cornell 512^2 and 1024^2 forward, Cornell 512^2 fwd+bwd SGD
           steps and train_step_fused, RTOW-final 512^2 forward
  four     (--four) sharded and balanced renders and train_step_fused on
           a 4-device mesh vs the same call on one device

Any failed check ends the run with a non-zero exit.  The last line of
standard output is one JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PHASES = ("device", "kernels", "parity", "main")
OUT_DIR = "smoke_out"    # the main phase's PPMs (listed in .gitignore)
FRAME = 512     # frame edge of the main-path workloads (1024^2 = 2 x FRAME)
M_FWD = 65536   # lanes of the forward kernel comparison (the pool's size)


def log(*a):
    print(*a, flush=True)


def _cornell(nx, ny, spp, max_depth=100):
    from scheme_raytrace import scenes
    from scheme_raytrace.config import RenderConfig
    from scheme_raytrace.scene import compile_scene
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=nx / ny)
    config = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                          light_sampling=True, seed=0)
    return scene, cam, config


def _timed(fn, *args, reps=5):
    """(min seconds, outputs) over reps calls, each ended by
    block_until_ready."""
    import jax
    best, out = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, out


def _compile(jitted, *args):
    """AOT-compile: (compiled, seconds, memory_analysis text)."""
    t0 = time.perf_counter()
    return _finish_compile(jitted.lower(*args), t0)


def _finish_compile(lowered, t0):
    compiled = lowered.compile()
    return compiled, time.perf_counter() - t0, _mem_text(compiled)


def _mem_text(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return "n/a"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k.replace('_size_in_bytes', '')}="
                    f"{getattr(ma, k, 'n/a')}" for k in keys)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "n/a")


# --------------------------------------------------------------------------
# phase: kernels
# --------------------------------------------------------------------------


def _bwd_case(plan, pk, m, lo, hi):
    """Jitted (kernel, jnp) fwd+vjp functions of one plan and their args."""
    import jax
    from scheme_raytrace.integrator import bounce
    from scheme_raytrace.utils import smoke

    lanes = smoke.random_lanes(m, 2, lo, hi, 512, 512)
    gitem, px, py, fresh, alive, depth = lanes[:6]

    def make(stepfn):
        def f(pk, o, d, t, rad, tp):
            return stepfn(plan, pk, gitem, px, py, fresh, alive, depth,
                          o, d, t, rad, tp)[:5]

        def vjp(pk, o, d, t, rad, tp, cts):
            out, back = jax.vjp(f, pk, o, d, t, rad, tp)
            return out, back(cts)
        return jax.jit(vjp)

    ks = iter(jax.random.split(jax.random.key(3), 16))
    r = lambda x: jax.random.normal(next(ks), x.shape, x.dtype)
    o, d, t, rad, tp = lanes[6:]
    cts = (tuple(map(r, o)), tuple(map(r, d)), r(t), tuple(map(r, rad)),
           tuple(map(r, tp)))
    return (make(bounce.as_pallas_vjp(plan, m)), make(bounce.step),
            (pk, o, d, t, rad, tp, cts))


def phase_kernels(card):
    import concurrent.futures as cf
    import jax
    import jax.numpy as jnp
    from scheme_raytrace import scenes
    from scheme_raytrace.config import RenderConfig
    from scheme_raytrace.integrator import bounce
    from scheme_raytrace.scene import compile_scene
    from scheme_raytrace.utils import smoke

    m_fwd = M_FWD
    m_bwd = RenderConfig().resolve_pool_rays(reverse=True)
    log(f"[kernels] precision: f32 step, jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}; tolerance rtol="
        f"{smoke.STEP_RTOL} atol={smoke.STEP_ATOL} on o/d/rad/tp, flip "
        f"share <= {smoke.STEP_FLIP_MAX}; card {card}")
    cases = []
    for name, spec, ls, lo, hi in [
            ("cornell_ls", scenes.cornell_box(), True, 0.0, 555.0),
            ("rtow_final", scenes.random_scene(seed=0), False, -12.0, 12.0),
            ("exotic", smoke.exotic_scene(), False, -1.0, 1.0),
            ("at_bounds", smoke.bounds_scene(), False, -2.5, 2.5)]:
        scene = compile_scene(spec.objects, sky=spec.sky)
        config = RenderConfig(nx=512, ny=512, spp=16, max_depth=100,
                              light_sampling=ls)
        plan = bounce.make_plan(scene, config)
        pk = bounce.pack(scene, spec.camera(aspect=1.0), plan, jnp.float32)
        cases.append((name, plan, pk, lo, hi))

    # set-up: the backward kernel's compile takes minutes, so it runs in
    # the background while the forward programs compile; nothing is timed
    # until every compile has finished
    pool = cf.ThreadPoolExecutor(2)
    bwd = {}
    for name, plan, pk, lo, hi in cases:
        if bounce.vjp_kernel_covers(plan):
            f_got, f_ref, args = _bwd_case(plan, pk, m_bwd, lo, hi)
            bwd[name] = (pool.submit(_compile, f_got, *args),
                         pool.submit(_compile, f_ref, *args), args)
    fwd = []
    for name, plan, pk, lo, hi in cases:
        lanes = smoke.random_lanes(m_fwd, 1, lo, hi, 512, 512)
        kern = bounce.as_pallas(plan, m_fwd)
        f_ref = jax.jit(lambda pk, *a, plan=plan: bounce.step(plan, pk, *a))
        f_got = jax.jit(lambda pk, *a, plan=plan, kern=kern:
                        kern(plan, pk, *a))
        fwd.append((name, plan, (pk, *lanes), _compile(f_ref, pk, *lanes),
                    _compile(f_got, pk, *lanes)))
    bwd = {name: (got_f.result(), ref_f.result(), args)
           for name, (got_f, ref_f, args) in bwd.items()}
    pool.shutdown()

    for name, plan, args, (c_ref, s_ref, mem_ref), (c_got, s_got, mem_got) \
            in fwd:
        t_ref, ref = _timed(c_ref, *args)
        t_got, got = _timed(c_got, *args)
        res = smoke.compare_step(ref, got)
        log(f"[kernels] fwd {name} m={m_fwd} prims(rects={plan.n_rects} "
            f"spheres={plan.n_spheres} media={plan.n_media} "
            f"kleins={plan.n_kleins} beziers={plan.n_beziers}): {res}")
        log(f"[kernels] fwd {name} one step: kernel {t_got * 1e3:.3f} ms "
            f"(compile {s_got:.1f}s, overlapped; {mem_got}) | jnp "
            f"{t_ref * 1e3:.3f} ms (compile {s_ref:.1f}s, overlapped; "
            f"{mem_ref})")

    for name, plan, pk, lo, hi in cases:
        if name not in bwd:
            log(f"[kernels] bwd {name}: not covered by the custom-VJP "
                "kernel; the reverse pool runs the checkpointed jnp step")
            continue
        (c_got, s_got, mem_got), (c_ref, s_ref, mem_ref), args = bwd[name]
        t_ref, (_, g_ref) = _timed(c_ref, *args)
        t_got, (_, g_got) = _timed(c_got, *args)
        res = smoke.compare_tree(g_ref, g_got)
        log(f"[kernels] bwd {name} m={m_bwd} cotangents vs jax.vjp(step): "
            f"{res}")
        log(f"[kernels] bwd {name} one fwd+vjp step: kernel "
            f"{t_got * 1e3:.3f} ms (compile {s_got:.1f}s, overlapped; "
            f"{mem_got}) | jnp {t_ref * 1e3:.3f} ms (compile {s_ref:.1f}s, "
            f"overlapped; {mem_ref})")


# --------------------------------------------------------------------------
# phase: parity
# --------------------------------------------------------------------------


def phase_parity(card):
    import jax.numpy as jnp
    import numpy as np
    from scheme_raytrace import parity
    from scheme_raytrace.utils import smoke

    gold_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "goldens")
    for pc in parity.PARITY_CONFIGS:
        g = np.load(os.path.join(gold_dir, f"{pc.name}.npz"))
        t0 = time.perf_counter()
        img = parity.render_parity_image(pc, jnp.float32)
        res_i = smoke.image_vs_golden(img, g["image"])
        ad32 = parity.probe_gradients(pc, jnp.float32, "ad", big=True)
        res_g = smoke.grads_vs_golden(ad32, g["grad_ad_big"],
                                      pc.f32_grad_rtol)
        log(f"[parity] {pc.name}: image {res_i}, gradients {res_g} "
            f"({time.perf_counter() - t0:.1f}s incl. compile; {card})")


# --------------------------------------------------------------------------
# phase: main path
# --------------------------------------------------------------------------


def _forward(label, scene, cam, config, physical=False):
    """Library entry point render.render_with_stats.  Compiles now (set-up)
    and returns run(card), which times three chained progressive chunks,
    each ended by block_until_ready."""
    import jax
    import numpy as np
    from scheme_raytrace import render as R
    from scheme_raytrace.integrator import pool_fused
    from scheme_raytrace.utils import smoke

    st0 = R.init_state(config)
    compiled, s_compile, mem = _compile(R.render_with_stats, scene, cam,
                                        config, st0)
    step = pool_fused.LAST_STEP_IMPL.get("forward")

    def run(card):
        st, rates = st0, []
        for _ in range(3):
            t0 = time.perf_counter()
            st, seg, iters = compiled(scene, cam, st)
            jax.block_until_ready(st.raw_sum)
            dt = time.perf_counter() - t0
            rates.append((int(seg), dt))
        seg, dt = sorted(rates, key=lambda r: r[1])[1]
        mean = np.asarray(st.raw_sum) / int(st.sample_count)
        assert np.isfinite(mean).all() and mean.max() > 0, f"{label}: bad frame"
        log(f"[main] {label}: {config.nx}x{config.ny} spp{config.spp} "
            f"depth{config.max_depth} step={step} segments={seg} "
            f"iters={int(iters)} median {dt * 1e3:.1f} ms -> "
            f"{seg / dt / 1e6:.2f}M rays/s on {card}; times_ms="
            f"{[round(t * 1e3, 1) for _, t in rates]}; compile "
            f"{s_compile:.1f}s (overlapped with the fwd+bwd compile); {mem}; "
            f"peak_bytes_in_use={_peak_bytes()}")
        if physical:
            log(f"[main] {label} physical check: "
                f"{smoke.cornell_physical(mean)}")
    return run


# train_step_fused runs on a small scene at full frame: its custom-VJP
# kernel compiles in seconds, where Cornell's takes minutes (and the Cornell
# fwd+bwd path is already exercised through diff_fused above)
TRAIN_CASE = "three_spheres {0}x{0} spp4 depth100"


def _train_fused(mesh):
    """Chained train_step_fused SGD steps toward a scaled-down render of
    the scene itself.  Set-up now: the target render, calibration and the
    first step, which compiles.  Returns (set-up seconds, more), where
    more(n) takes n further timed steps and returns (params, last loss,
    n_iters, step seconds)."""
    import jax
    import numpy as np
    from scheme_raytrace import render as R
    from scheme_raytrace import scenes
    from scheme_raytrace.config import RenderConfig
    from scheme_raytrace.parallel import calibrate_iters_sharded, \
        train_step_fused
    from scheme_raytrace.scene import build as sb
    from scheme_raytrace.scene import compile_scene

    t0 = time.perf_counter()
    spec = scenes.three_spheres()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    config = RenderConfig(nx=FRAME, ny=FRAME, spp=4, max_depth=100, seed=0)
    mean, _ = R.render_image(scene, cam, config)
    target = 0.9 * mean
    n_iters = calibrate_iters_sharded(scene, cam, config, mesh)
    params, rest = sb.partition(scene)

    def one():
        nonlocal params
        params, loss, leftover = train_step_fused(params, rest, cam, config,
                                                  target, mesh, n_iters)
        jax.block_until_ready(params)
        assert int(leftover) == 0, int(leftover)
        assert np.isfinite(float(loss)), float(loss)
        assert all(np.isfinite(np.asarray(p)).all()
                   for p in jax.tree.leaves(params))
        return float(loss)

    one()
    setup = time.perf_counter() - t0

    def more(n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            loss = one()
            times.append(time.perf_counter() - t0)
        return params, loss, n_iters, times
    return setup, more


def _fwd_bwd_setup():
    """Cornell fwd+bwd SGD steps through diff_fused: (jitted value_and_grad
    step, params, scene, cam, config), after calibration."""
    import jax
    import jax.numpy as jnp
    from scheme_raytrace.integrator import diff_fused
    from scheme_raytrace.scene import build as sb

    scene, cam, config = _cornell(FRAME, FRAME, 8)
    t0 = time.perf_counter()
    n_iters = diff_fused.calibrate_iters(scene, cam, config)
    log(f"[main] fwd+bwd calibrate_iters -> {n_iters} "
        f"({time.perf_counter() - t0:.1f}s incl. compile)")
    params, rest = sb.partition(scene)

    def loss_fn(params):
        s = sb.combine(params, rest)
        raw, segs, leftover = diff_fused.render_diff_fused(s, cam, config,
                                                           n_iters)
        return jnp.sum(raw ** 2) / raw.size, (segs, leftover, raw)

    return (jax.jit(jax.value_and_grad(loss_fn, has_aux=True)), params,
            scene, cam, config)


def _fwd_bwd_run(card, impl, compiled, s_compile, mem, params, scene, cam,
                 config):
    import jax
    import numpy as np
    from scheme_raytrace import render as R

    times = []
    raw_scan = None
    for k in range(4):
        jax.block_until_ready(params)
        t0 = time.perf_counter()
        (loss, (segs, leftover, raw)), grads = compiled(params)
        jax.block_until_ready(grads)
        times.append(time.perf_counter() - t0)
        if raw_scan is None:
            raw_scan = np.asarray(raw)
        gl = [np.asarray(g) for g in jax.tree.leaves(grads)]
        assert int(leftover) == 0, f"step {k}: leftover {int(leftover)}"
        assert np.isfinite(float(loss)), f"step {k}: loss {loss}"
        assert all(np.isfinite(g).all() for g in gl), f"step {k}: grads"
        assert max(np.abs(g).max() for g in gl) > 0, f"step {k}: zero grads"
        params = jax.tree.map(lambda p, g: p - 1e-6 * g, params, grads)
    dt = sorted(times[1:])[1]
    log(f"[main] fwd+bwd value_and_grad Cornell {config.nx}x{config.ny} "
        f"spp{config.spp} depth{config.max_depth} "
        f"step={impl} segments="
        f"{int(segs)} leftover=0 median {dt * 1e3:.1f} ms -> "
        f"{int(segs) / dt / 1e6:.2f}M rays/s on {card}; times_ms="
        f"{[round(t * 1e3, 1) for t in times]}; compile {s_compile:.1f}s; "
        f"{mem}; peak_bytes_in_use={_peak_bytes()}")

    # the scan (reverse) pool vs the while_loop (forward) pool: same
    # estimator, RNG and per-pixel pass order
    st, _, _ = R.render_with_stats(scene, cam, config, R.init_state(config))
    raw_while = np.asarray(st.raw_sum).reshape(-1, 3)
    diff = np.abs(raw_while - raw_scan)
    log(f"[main] while_loop vs scan pool image: bit-identical="
        f"{bool((diff == 0).all())} max_abs_diff={float(diff.max())} "
        f"differing_pixels={int((diff.max(axis=1) > 0).sum())}")
    assert np.allclose(raw_while, raw_scan, rtol=1e-5, atol=1e-5)


def phase_main(card):
    import concurrent.futures as cf
    from scheme_raytrace import scenes
    from scheme_raytrace.__main__ import main as cli
    from scheme_raytrace.config import RenderConfig
    from scheme_raytrace.integrator import pool_fused
    from scheme_raytrace.parallel import make_mesh
    from scheme_raytrace.scene import compile_scene

    os.makedirs(OUT_DIR, exist_ok=True)
    edge = str(FRAME)

    # set-up: the fwd+bwd program compiles in the background (minutes)
    # while the forward programs compile and train_step_fused takes its
    # first, compiling step; nothing is timed until it has finished
    step, params, *fb = _fwd_bwd_setup()
    t0 = time.perf_counter()
    lowered = step.lower(params)        # traced here: the step choice is read
    impl = pool_fused.LAST_STEP_IMPL["reverse"]
    with cf.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_finish_compile, lowered, t0)
        runs = [_forward("cornell", *_cornell(FRAME, FRAME, 16),
                         physical=True),
                _forward("cornell (row bands)",
                         *_cornell(2 * FRAME, 2 * FRAME, 16), physical=True)]
        spec = scenes.random_scene(seed=0)
        runs.append(_forward(
            "random (RTOW-final, 227 spheres)",
            compile_scene(spec.objects, sky=spec.sky),
            spec.camera(aspect=1.0),
            RenderConfig(nx=FRAME, ny=FRAME, spp=16, max_depth=100)))
        s_train, more_train = _train_fused(make_mesh(1))
        compiled, s_compile, mem = fut.result()

    _fwd_bwd_run(card, impl, compiled, s_compile, mem, params, *fb)
    for run in runs:
        run(card)
    _, loss, n_tr, times = more_train(2)
    log(f"[main] train_step_fused {TRAIN_CASE.format(FRAME)} 1-device "
        f"mesh n_iters={n_tr}: loss {loss:.6g}; step times_ms="
        f"{[round(t * 1e3, 1) for t in times]}; set-up {s_train:.1f}s "
        f"(target, calibration, first step; overlapped with the fwd+bwd "
        f"compile) on {card}")
    # the CLI finds the library's programs in the compile cache
    for scene, extra in (("cornell", ["--light-sampling"]), ("random", [])):
        log(f"[main] CLI render {scene} {edge}x{edge} spp16 on {card}")
        cli(["render", "--scene", scene, "--nx", edge, "--ny", edge,
             "--spp", "16", "--chunk", "16", *extra, "--out",
             os.path.join(OUT_DIR, f"smoke_{scene}{edge}.ppm")])


# --------------------------------------------------------------------------
# phase: four cards
# --------------------------------------------------------------------------


def phase_four(card):
    import jax
    import numpy as np
    from scheme_raytrace.parallel import (make_mesh, render_pool_balanced,
                                          render_pool_sharded)

    assert len(jax.devices()) >= 4, f"--four needs 4 devices: {jax.devices()}"
    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    scene, cam, config = _cornell(FRAME, FRAME, 16)

    def run(fn, mesh):
        out = fn(scene, cam, config, mesh)          # compile + warm-up
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        raw, seg, iters = jax.block_until_ready(fn(scene, cam, config, mesh))
        dt = time.perf_counter() - t0
        return np.asarray(raw), int(seg), int(iters), dt

    for name, fn in (("render_pool_sharded", render_pool_sharded),
                     ("render_pool_balanced", render_pool_balanced)):
        r4, s4, i4, t4 = run(fn, mesh4)
        r1, s1, i1, t1 = run(fn, mesh1)
        diff = np.abs(r4 - r1)
        log(f"[four] {name} Cornell {config.nx}x{config.ny} spp{config.spp}:"
            f" 4 devices {t4 * 1e3:.1f}"
            f" ms ({s4 / t4 / 1e6:.2f}M rays/s, iters {i4}) vs 1 device "
            f"{t1 * 1e3:.1f} ms ({s1 / t1 / 1e6:.2f}M rays/s, iters {i1}); "
            f"segments equal={s4 == s1}; image bit-identical="
            f"{bool((diff == 0).all())} max_abs_diff={float(diff.max())} "
            f"on {card}")
        assert s4 == s1, (s4, s1)
        assert np.allclose(r4, r1, rtol=1e-5, atol=1e-5)

    out = {}
    for n, mesh in ((4, mesh4), (1, mesh1)):
        s_setup, more = _train_fused(mesh)
        out[n] = more(1)
        log(f"[four] train_step_fused {TRAIN_CASE.format(FRAME)} on {n} "
            f"device(s): loss "
            f"{out[n][1]:.8g} n_iters {out[n][2]} second step "
            f"{out[n][3][0] * 1e3:.1f} ms (set-up {s_setup:.1f}s incl. "
            f"compile and the first step) on {card}")
    # same start, two chained steps: compare the parameters they reach
    worst = 0.0
    for p4, p1 in zip(jax.tree.leaves(out[4][0]), jax.tree.leaves(out[1][0])):
        p4, p1 = np.asarray(p4, np.float64), np.asarray(p1, np.float64)
        worst = max(worst, float(np.max(np.abs(p4 - p1)
                                        / (1e-6 + np.abs(p1)), initial=0)))
    log(f"[four] train_step_fused psum'd 4-device steps vs 1-device steps: "
        f"loss {out[4][1]:.8g} vs {out[1][1]:.8g}; max relative parameter "
        f"difference {worst:.3e}")
    assert abs(out[4][1] - out[1][1]) <= 1e-4 * abs(out[1][1])
    assert worst <= 1e-4, worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--phase", action="append", choices=PHASES[1:],
                    help="run only these one-card phases (repeatable)")
    args = ap.parse_args(argv)
    try:
        from scheme_raytrace.utils import smoke
    except ImportError as e:
        print(f"chip_smoke: the scheme_raytrace package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    smoke.enable_compile_cache()

    rep = smoke.device_report()
    card = smoke.nvidia_smi()
    log(f"[device] platform={rep['platform']} kind={rep['kind']} "
        f"count={rep['count']} jax={rep['jax']} "
        f"XLA_FLAGS={rep['xla_flags']!r}")
    log(f"[device] nvidia-smi name, power.limit: {card}")
    smoke.require_gpu(rep)

    phases = (["four"] if args.four
              else (args.phase or list(PHASES[1:])))
    for name in phases:
        t0 = time.perf_counter()
        globals()[f"phase_{name}"](card)
        log(f"[{name}] phase passed in {time.perf_counter() - t0:.1f}s")

    print(json.dumps({"ok": True, "device": {
        "platform": rep["platform"], "kind": rep["kind"],
        "count": rep["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
