"""Render configuration.

The reference configures itself through edit-in-place global `define`s
(main.scm:26,104,126-127,433,437 — image size, max depth, shadow epsilon,
sample cap, scene selection).  Here every knob is an explicit field of one
dataclass so parity configs are reproducible (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Numerical-constants ledger (SURVEY.md §6.4), reproduced as named config
# defaults.  The reference's +max-float+ (constant.scm:6) is 999999999999;
# that value is exactly representable in f32 so we keep it for parity.
BIG = 999999999999.0          # constant.scm:6 (+max-float+)
SHADOW_EPS = 0.001            # main.scm:104 (t_min of every scattered ray)
RECT_PAD = 0.0001             # geometry.scm:391,410,429 (rect AABB thickness)
MEDIUM_REHIT_EPS = 0.0001     # geometry.scm:553 (re-probe offset)
KLEIN_MAX_STEPS = 100         # geometry.scm:635
KLEIN_ITERATIONS = 10         # geometry.scm:610-620
KLEIN_SURF_EPS = 0.001        # geometry.scm:656
KLEIN_NORMAL_H = 0.01         # geometry.scm:627-632
KLEIN_DE_SCALE = 0.7          # geometry.scm:607,621
KLEIN_R = 125.0               # geometry.scm:600
KLEIN_SPHERE_R = 300.0        # geometry.scm:590-598
SAH_T_TRI = 1.0               # geometry.scm:297
SAH_T_AABB = 1.0              # geometry.scm:298
GAMMA_QUANT = 255.99          # main.scm:463


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) rendering configuration.

    All fields are Python scalars — the config is hashable and used as a
    static argument to jitted entry points.
    """

    nx: int = 200                 # image width  (main.scm:126)
    ny: int = 200                 # image height (main.scm:127)
    spp: int = 16                 # samples per pixel per render() call
    max_depth: int = 100          # bounce cap (main.scm:26)
    seed: int = 0
    # Integrator options
    light_sampling: bool = False  # mixture cosine/light PDF (pdf.scm intent, B5)
    russian_roulette: bool = False  # OFF for parity (SURVEY §7.3 item 3)
    rr_start_depth: int = 4
    # Traversal: "brute" masked sweep (default; scenes are <1k prims) or
    # "bvh" flat-array stackless traversal.
    traversal: str = "brute"
    # Differentiable path uses a fixed-length scan instead of while_loop.
    differentiable: bool = False
    # Regeneration-pool size cap (lanes in flight at once; terminated
    # lanes immediately pick up the next work item so occupancy stays
    # ~100%).  None = AUTO: 64k forward and 24k reverse-mode, the optima
    # of a sweep on the earlier accelerator, not measured on H100 —
    # clamped to the work size for small frames and applied PER BAND on
    # banded large frames.  Set an int to pin it.
    pool_rays: Optional[int] = None

    def resolve_pool_rays(self, reverse: bool = False) -> int:
        if self.pool_rays is not None:
            return self.pool_rays
        return (24 if reverse else 64) * 1024
    # Precision of the compute path ("f32" on the card; "f64" for the CPU oracle —
    # requires jax_enable_x64, enforced by `jnp_dtype`).
    dtype: str = "f32"
    # Bezier intersection: number of seed samples along the curve parameter
    # and Newton refinement steps (ops/bezier.py).
    bezier_seeds: int = 32
    bezier_newton: int = 8
    # Fused-bounce Pallas kernels (integrator/bounce.py): None = by
    # platform (on for GPU backends), True/False forces (the A/B switch).
    # Only consulted when the scene is covered by the fused path
    # (bounce.supported).
    use_pallas: Optional[bool] = None
    # EP-analogue material-sorted shading (SURVEY §2.4: "EP ≙ material-
    # sorted dispatch"): rank the general pool's lanes by material type
    # before shade() and unsort after — bit-identical estimator (shade is
    # elementwise), measured A/B in tools/bench_material_sort.py.  Default
    # False: masked evaluation is work-optimal under XLA (a select runs
    # every branch for every lane regardless of order), so sorting only
    # buys memory locality and costs two gathers.  Not measured on H100.
    # Scope: GENERAL-POOL ONLY — True forces the general pool (bounce.
    # supported routes away from the fused step), and the wavefront/
    # differentiable path ignores it (always masked shade.shade).
    material_sort: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.nx * self.ny

    @property
    def jnp_dtype(self):
        """Compute dtype; fails loudly if f64 is requested without x64."""
        import jax
        import jax.numpy as jnp
        if self.dtype == "f64":
            if not jax.config.read("jax_enable_x64"):
                raise RuntimeError(
                    "dtype='f64' requires x64 (jax.config.update"
                    "('jax_enable_x64', True) or jax.experimental.enable_x64)")
            return jnp.float64
        return jnp.float32
