"""Device report and comparison checks shared by chip_smoke.py, bench.py
and the tests.

Every check returns the numbers it compared and raises AssertionError when
they are out of bounds, so a caller prints the numbers and a failure stops
it.  The checks take host (numpy) arrays and run anywhere; only
`device_report` and `require_gpu` look at the device.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

# Kernel vs plain-jnp step at the same inputs: per-output tolerance (the
# interpret-mode tests' bound), and the largest share of lanes allowed to
# differ by a branch flip (an f32 rounding that turns a hit, a material
# branch or the scattering decision the other way).
STEP_RTOL = 1e-4
STEP_ATOL = 1e-4
STEP_FLIP_MAX = 1e-3

# Parity with the f64 oracle goldens (tests/test_parity.py criteria).
PARITY_MAE_MAX = 5e-3
PARITY_OUTLIER_DELTA = 0.05
PARITY_OUTLIER_MAX = 0.01


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache` in the
    checkout (listed in .gitignore)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path


def nvidia_smi() -> str:
    """Card name and power limit, read by a child process that does not
    touch JAX (one "name, limit" entry per card, joined by "; ");
    "not available" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({type(e).__name__})"
    cards = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return "; ".join(cards) or f"not available (rc {out.returncode})"


def device_report() -> dict:
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def require_gpu(report: dict) -> None:
    if report["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX platform is {report['platform']!r}; this "
            "measurement runs on the card only")


def exotic_scene():
    """Medium + bezier + klein in one small plan: every inner loop of the
    bounce step (klein march and DE, bezier Newton seeds, medium
    scatter) in one kernel."""
    from .. import scenes
    from ..scene import objects as ob
    cp = np.array([[-1, 0, -2], [-0.3, 1, -2], [0.3, -1, -2], [1, 0, -2]],
                  float)
    return scenes.SceneSpec([
        ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.5, 0.5, 0.5))),
        ob.ConstantMedium(ob.Sphere((0, 0.5, -1), 0.6,
                                    ob.Lambertian((1, 1, 1))),
                          0.8, (0.9, 0.9, 0.9)),
        ob.Bezier(cp, 0.4, ob.Lambertian((0.7, 0.4, 0.2))),
        ob.Klein((0, 2, 0), ob.Lambertian((0.65, 0.05, 0.05))),
    ], scenes.default_camera(), "gradient")


def bounds_scene():
    """The largest plan the forward kernel runs: bounce.KERNEL_MAX_MEDIA
    media, KERNEL_MAX_KLEINS kleins and KERNEL_MAX_BEZIERS beziers, each
    unrolled in the kernel."""
    from .. import scenes
    from ..integrator import bounce
    from ..scene import objects as ob
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.5, 0.5, 0.5)))]
    for i in range(bounce.KERNEL_MAX_MEDIA):
        objs.append(ob.ConstantMedium(
            ob.Sphere((-1.5 + (i % 4), 0.2 * (i // 4), -1.5), 0.2,
                      ob.Lambertian((1, 1, 1))), 0.5 + 0.1 * i,
            (0.9, 0.8, 0.7)))
    for i in range(bounce.KERNEL_MAX_KLEINS):
        objs.append(ob.Klein((-2 + 4 * i, 2, 0),
                             ob.Lambertian((0.65, 0.05, 0.05))))
    for i in range(bounce.KERNEL_MAX_BEZIERS):
        z = -2.5 + 0.2 * i
        cp = np.array([[-1, 0, z], [-0.3, 1, z], [0.3, -1, z], [1, 0, z]],
                      float)
        objs.append(ob.Bezier(cp, 0.1, ob.Lambertian((0.7, 0.4, 0.2))))
    return scenes.SceneSpec(objs, scenes.default_camera(), "gradient")


def random_lanes(m, seed, lo, hi, nx, ny):
    """A pool's lane inputs for one `bounce.step` call: half the lanes
    fresh (camera regen), origins uniform in the box [lo, hi]^3, unit
    directions, depths 0..3 — the same construction as the kernel tests.
    Returns (gitem, px, py, fresh, alive, depth, o, d, time, rad, tp)."""
    import jax
    import jax.numpy as jnp
    ks = jax.random.split(jax.random.key(seed), 9)
    gitem = jnp.arange(m, dtype=jnp.int32)
    px = jax.random.randint(ks[0], (m,), 0, nx).astype(jnp.float32)
    py = jax.random.randint(ks[1], (m,), 0, ny).astype(jnp.float32)
    fresh = jax.random.bernoulli(ks[2], 0.5, (m,))
    alive = fresh | jax.random.bernoulli(ks[3], 0.7, (m,))
    depth = jax.random.randint(ks[4], (m,), 0, 4)
    o = tuple(lo + (hi - lo) * jax.random.uniform(k, (m,))
              for k in jax.random.split(ks[5], 3))
    dvec = jax.random.normal(ks[6], (m, 3))
    dvec = dvec / jnp.linalg.norm(dvec, axis=-1, keepdims=True)
    d = (dvec[:, 0], dvec[:, 1], dvec[:, 2])
    time = jnp.zeros(m)
    rad = tuple(jax.random.uniform(k, (m,))
                for k in jax.random.split(ks[7], 3))
    tp = tuple(jax.random.uniform(k, (m,), minval=0.1, maxval=1.0)
               for k in jax.random.split(ks[8], 3))
    return gitem, px, py, fresh, alive, depth, o, d, time, rad, tp


def compare_step(ref, got, rtol=STEP_RTOL, atol=STEP_ATOL,
                 flip_max=STEP_FLIP_MAX) -> dict:
    """Kernel step outputs vs the plain-jnp step's, lane by lane.

    ref/got: (o, d, time, rad, tp, scattering) with vec3 tuples, as
    `bounce.step` returns.  A lane counts as flipped when its scattering
    mask differs or any of o/d/rad/tp leaves the tolerance; the flipped
    share must stay <= flip_max.  Returns the counts and, over the lanes
    that did not flip, the largest error relative to the tolerance."""
    flat = lambda out: [np.asarray(x) for x in
                        (*out[0], *out[1], *out[3], *out[4])]
    r_vals, g_vals = flat(ref), flat(got)
    sc_r, sc_g = np.asarray(ref[5]), np.asarray(got[5])
    m = sc_r.shape[0]
    mask_flip = sc_r != sc_g
    off = np.zeros(m, bool)
    for r, g in zip(r_vals, g_vals):
        off |= ~np.isclose(g, r, rtol=rtol, atol=atol)
    bad = mask_flip | off
    worst = 0.0
    for r, g in zip(r_vals, g_vals):
        e = np.abs(g - r) / (atol + rtol * np.abs(r))
        worst = max(worst, float(np.max(e[~bad], initial=0.0)))
    res = {"lanes": m, "mask_flips": int(mask_flip.sum()),
           "out_of_tol": int((off & ~mask_flip).sum()),
           "flip_share": float(bad.mean()), "worst_err_over_tol": worst,
           "time_max_abs": float(np.max(np.abs(
               np.asarray(got[2]) - np.asarray(ref[2])), initial=0.0))}
    assert all(np.isfinite(g).all() for g in g_vals), "non-finite output"
    assert res["flip_share"] <= flip_max, res
    return res


def compare_tree(ref, got, rtol=1e-3, atol_scale=1e-5) -> dict:
    """Cotangent trees (the custom-VJP rule vs jax.vjp of the jnp step):
    per leaf, |got - ref| <= atol + rtol |ref| with atol = atol_scale x
    the leaf's largest magnitude.  Returns the worst ratio to the bound."""
    import jax
    worst = 0.0
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        r, g = np.asarray(r, np.float64), np.asarray(g, np.float64)
        assert np.isfinite(g).all(), "non-finite cotangent"
        atol = atol_scale * max(1.0, float(np.abs(r).max(initial=0.0)))
        e = np.abs(g - r) / (atol + rtol * np.abs(r))
        worst = max(worst, float(e.max(initial=0.0)))
    res = {"worst_err_over_tol": worst}
    assert worst <= 1.0, res
    return res


def image_vs_golden(img, ref) -> dict:
    """f32 render vs the f64 oracle golden: mean abs error and the share
    of pixels that moved by more than a whole sample's worth."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    assert img.shape == ref.shape, (img.shape, ref.shape)
    assert np.isfinite(img).all(), "non-finite pixels"
    diff = np.abs(img - ref)
    res = {"mae": float(diff.mean()),
           "outlier_frac": float((diff.max(axis=-1)
                                  > PARITY_OUTLIER_DELTA).mean())}
    assert res["mae"] < PARITY_MAE_MAX, res
    assert res["outlier_frac"] < PARITY_OUTLIER_MAX, res
    return res


def grads_vs_golden(ad32, ad64, rtol) -> dict:
    """f32 AD vs the committed f64 AD; the scale floor is 5% of the
    config's dominant gradient (a near-zero probe is judged against the
    config's gradient scale, not its own noise)."""
    ad32 = np.asarray(ad32, np.float64)
    ad64 = np.asarray(ad64, np.float64)
    assert np.isfinite(ad32).all(), "non-finite gradient"
    scale = np.maximum(np.abs(ad64), 0.05 * np.abs(ad64).max() + 1e-7)
    rel = np.abs(ad32 - ad64) / scale
    res = {"max_rel": float(rel.max()), "rtol": rtol}
    assert (rel < rtol).all(), {**res, "ad32": ad32.tolist(),
                                "ad64": ad64.tolist()}
    return res


def cornell_physical(mean) -> dict:
    """Physical structure of a Cornell render ([ny, nx, 3], row 0 = image
    bottom; camera u axis = -x): green wall on the image LEFT, red on the
    RIGHT, a bright ceiling strip near the light."""
    img = np.asarray(mean, np.float64)
    assert np.isfinite(img).all(), "non-finite pixels"
    ny, nx, _ = img.shape
    mid = slice(ny // 3, 2 * ny // 3)
    left = img[mid, : nx // 10].mean(axis=(0, 1))
    right = img[mid, -(nx // 10):].mean(axis=(0, 1))
    ceiling = img[-(ny // 20):, 2 * nx // 5: 3 * nx // 5].mean()
    res = {"left_rgb": left.round(4).tolist(),
           "right_rgb": right.round(4).tolist(),
           "ceiling_mean": round(float(ceiling), 4),
           "frame_mean": round(float(img.mean()), 4)}
    assert left[1] > left[0] and left[1] > left[2], ("left not green", res)
    assert right[0] > right[1] and right[0] > right[2], ("right not red", res)
    assert ceiling > img.mean(), ("no bright ceiling strip", res)
    return res
