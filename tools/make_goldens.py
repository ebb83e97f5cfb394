"""Generate the committed BASELINE parity goldens (tests/goldens/*.npz).

Run as:  JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu python tools/make_goldens.py

For each of the 5 BASELINE configs (scheme_raytrace/parity.py) this
renders the f64 CPU oracle image and computes the probe gradients as both
f64 central finite differences and f64 autodiff.  It ASSERTS FD == AD in
f64 before committing anything — that is the "finite-difference pixel
gradients allclose" claim of BASELINE.json, checked at full precision.
The achieved FD-vs-AD error is recorded in each npz for audit.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_ENABLE_X64", "1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# the f64 oracle runs on the CPU whatever accelerator is present
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

if not jax.config.read("jax_enable_x64"):
    sys.exit("goldens must be generated with JAX_ENABLE_X64=1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from scheme_raytrace import parity  # noqa: E402


def main():
    grads_only = "--grads-only" in sys.argv
    only = None
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1]
    os.makedirs(parity.GOLDEN_DIR, exist_ok=True)
    failures = []
    for pc in parity.PARITY_CONFIGS:
        if only is not None and pc.name != only:
            continue
        print(f"[{pc.name}] probing {len(pc.probes)} gradients "
              "(f64 FD+AD small, AD big)...", flush=True)
        fd = parity.probe_gradients(pc, jnp.float64, "fd")
        ad = parity.probe_gradients(pc, jnp.float64, "ad")
        err = np.abs(fd - ad) / np.maximum(np.maximum(np.abs(fd),
                                                      np.abs(ad)), 1e-6)
        print(f"[{pc.name}] fd={fd} ad={ad} rel_err={err}", flush=True)
        if not (err < 0.02).all():
            failures.append(
                f"{pc.name}: f64 FD vs AD disagree (rel {err}) — "
                "probe crosses a discrete event; pick a different probe/eps")
            continue
        ad_big = parity.probe_gradients(pc, jnp.float64, "ad", big=True)
        print(f"[{pc.name}] ad_big={ad_big}", flush=True)
        path = os.path.join(parity.GOLDEN_DIR, f"{pc.name}.npz")
        if grads_only:
            # refresh ONLY the gradient fields of the committed golden,
            # keeping the (expensive) oracle image as-is
            if not os.path.exists(path):
                failures.append(f"{pc.name}: --grads-only but {path} missing")
                continue
            old = dict(np.load(path, allow_pickle=False))
            old.update(grad_fd=fd, grad_ad=ad, fd_ad_rel_err=err,
                       grad_ad_big=ad_big)
            np.savez_compressed(path, **old)
            print(f"[{pc.name}] refreshed gradient fields in {path}",
                  flush=True)
            continue

        print(f"[{pc.name}] rendering f64 oracle image "
              f"({pc.config.nx}x{pc.config.ny}, {pc.config.spp} spp)...",
              flush=True)
        img = parity.render_parity_image(pc, jnp.float64)
        assert np.isfinite(img).all(), f"{pc.name}: non-finite oracle image"

        np.savez_compressed(
            path, image=img, grad_fd=fd, grad_ad=ad, fd_ad_rel_err=err,
            grad_ad_big=ad_big,
            probes=np.array([f"{p.leaf}{list(p.index)}" for p in pc.probes]),
            nominal=np.array(pc.nominal))
        print(f"[{pc.name}] wrote {path}", flush=True)

    if failures:
        sys.exit("FAILED:\n" + "\n".join(failures))


if __name__ == "__main__":
    main()
