"""Reverse-mode-differentiable regeneration pool (the fwd+bwd fast path).

The general differentiable path (render.py with config.differentiable)
scans the [N,3] wavefront over a fixed 101-bounce trip — correct, but far
off the forward pool: the fixed trip count advances a nearly-dead pool
for most of its iterations (Cornell mean path length is ~2.8 of the
100-bounce cap; an all-dead `lax.cond` skip does not survive reverse-mode
— AD runs the taken branch's VJP for every iteration regardless).

The answer (BASELINE north star "fwd and fwd+bwd"): the SAME
regeneration pool as the forward fast path (integrator/pool_fused), with
the `while_loop` swapped for a fixed-length `scan` — occupancy stays ~100%
so the backward pays per USEFUL segment, not per (cap x lanes).  Reverse
mode needs the static trip count up front; `calibrate_iters` measures it
with one (cheap, undifferentiated) forward render, and the returned
`leftover` count proves the queue drained (0 = the image is exactly the
forward pool's, bit-for-bit — same estimator, same counter-hash RNG, same
flush order; tested in tests/test_diff_fused.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import bounce
from . import pool_fused


def supported(scene, config) -> bool:
    """Same coverage as the fused forward step."""
    return bounce.supported(scene, config)


def calibrate_iters(scene, cam, config, slack: float = 1.25) -> int:
    """Static trip count for render_diff_fused: one forward pool render
    measures the drain iteration count; `slack` covers run-to-run RNG
    variation when the caller varies seed/sample_base between calls.

    The calibration render is pinned to the REVERSE-mode pool size: under
    auto sizing (config.pool_rays=None) the forward path would otherwise
    resolve its own larger optimum and report a drain count the smaller
    diff pool cannot meet."""
    config = config.replace(
        pool_rays=config.resolve_pool_rays(reverse=True))
    raw0 = jnp.zeros((config.n_pixels, 3), config.jnp_dtype)
    _, _, iters = jax.jit(
        lambda s, c: pool_fused.render_pool_fused(s, c, config, raw0, 0)
    )(scene, cam)
    return int(-(-int(iters) * slack // 1))


def render_diff_fused_strict(scene, cam, config, n_iters: int,
                             sample_base=0):
    """render_diff_fused with a fail-loud drain guard (jit-compatible).

    `calibrate_iters`' slack is a heuristic; a user training across seeds
    could silently drop work if a later seed needs more iterations than
    the calibrated count and they forget to check `leftover`.  This
    wrapper poisons the radiance to NaN whenever the queue did not drain,
    so the error surfaces immediately in the loss/gradients (and trips
    the NaN hygiene in utils/checks) instead of biasing the estimator
    silently.  Callers who check `leftover` themselves can keep using
    render_diff_fused.
    """
    raw, segs, leftover = render_diff_fused(scene, cam, config, n_iters,
                                            sample_base)
    raw = jnp.where(leftover == 0, raw, jnp.nan)
    return raw, segs, leftover


def render_diff_fused(scene, cam, config, n_iters: int, sample_base=0):
    """Differentiable pool render.

    Returns (raw [n_pix, 3] radiance sums over config.spp passes, segments,
    leftover).  Gradients flow to every float leaf of `scene` and `cam`
    through the packed constant buffer (bounce.pack is traced, not baked).
    `leftover` MUST be checked (host-side, after the step): a nonzero value
    means n_iters was too small to drain the work queue and the image /
    gradient is missing that work's contribution.
    """
    raw0 = jnp.zeros((config.n_pixels, 3), config.jnp_dtype)
    return pool_fused.render_pool_fused(scene, cam, config, raw0,
                                        sample_base, static_iters=n_iters)
