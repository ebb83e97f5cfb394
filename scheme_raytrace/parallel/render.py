"""Sharded rendering + differentiable training step over a device mesh.

The ray pool (rows of the image) shards across the mesh's `rays` axis via
`shard_map`; the Scene pytree and camera are replicated.  The forward pass
needs no collectives at all (rays are independent); the training step
(inverse rendering: fit scene parameters to a target image) psums the
parameter gradients across shards — that single all-reduce is the only
inter-chip traffic, exactly the DP pattern the BASELINE prescribes
("shard rays and tiles, replicate scene parameters, all-reduce parameter
gradients").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import config as cfg_mod
from ..camera import Camera, get_rays
from ..core import rng
from ..integrator.wavefront import trace_rays
from ..scene import build as sb
from .mesh import RAY_AXIS


def _pass_rows(scene, cam, config, pass_idx, shard_idx, rows, dtype):
    """Render `rows` image rows starting at shard_idx*rows: [rows, nx, 3]."""
    key = jax.random.fold_in(
        jax.random.fold_in(rng.root_key(config.seed), pass_idx), shard_idx)
    k_jit, k_lens, k_trace = jax.random.split(key, 3)

    n = rows * config.nx
    idx = jnp.arange(n, dtype=jnp.int32)
    ys_local, xs = jnp.divmod(idx, config.nx)
    ys = ys_local + shard_idx * rows
    xi = jax.random.uniform(k_jit, (n, 2), dtype)
    u = (xs.astype(dtype) + xi[:, 0]) / config.nx
    v = (ys.astype(dtype) + xi[:, 1]) / config.ny
    o, d, time = get_rays(cam, u, v, k_lens)
    radiance = trace_rays(scene, o, d, time, k_trace, config)
    return radiance.reshape(rows, config.nx, 3)


def _mean_image_local(scene, cam, config, rows, dtype):
    """config.spp passes of this shard's rows; returns the mean frame."""
    shard_idx = jax.lax.axis_index(RAY_AXIS)

    def body(acc, i):
        return acc + _pass_rows(scene, cam, config, i, shard_idx, rows,
                                dtype), None
    # pcast-to-varying: the accumulator is shard-local (varying), not replicated
    init = jax.lax.pcast(jnp.zeros((rows, config.nx, 3), dtype), (RAY_AXIS,),
                         to='varying')
    acc, _ = jax.lax.scan(body, init, jnp.arange(config.spp))
    return acc / config.spp


def render_sharded(scene, cam: Camera, config: cfg_mod.RenderConfig, mesh):
    """Full-frame mean radiance [ny,nx,3], rows sharded over the mesh."""
    n_dev = mesh.shape[RAY_AXIS]
    assert config.ny % n_dev == 0, (
        f"ny={config.ny} must divide evenly over {n_dev} devices")
    return _render_sharded_jit(scene, cam, config=config, mesh=mesh)


# Module-level jit with static (config, mesh): building the shard_map
# closure per call would recompile the sharded graph EVERY call —
# measured ~1000x slower than the executable on chip (the same pattern
# holds for every sharded entry point in this file and parallel/pool.py).
@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def _render_sharded_jit(scene, cam, *, config, mesh):
    rows = config.ny // mesh.shape[RAY_AXIS]
    fn = shard_map(
        functools.partial(_mean_image_local, config=config, rows=rows,
                          dtype=config.jnp_dtype),
        mesh=mesh,
        in_specs=(P(), P()),            # scene + camera replicated
        out_specs=P(RAY_AXIS),          # rows sharded
    )
    return fn(scene, cam)


def calibrate_iters_sharded(scene, cam: Camera,
                            config: cfg_mod.RenderConfig, mesh,
                            slack: float = 1.25) -> int:
    """Static per-shard trip count for `train_step_fused`: one sharded
    forward pool render measures the max drain count over shards (each
    shard runs the same static-length scan, so the slowest shard sizes it).
    Pinned to the REVERSE-mode pool size so auto sizing calibrates the
    same pool geometry train_step_fused's diff pool will run (see
    diff_fused.calibrate_iters).
    """
    from .pool import render_pool_sharded

    config = config.replace(
        pool_rays=config.resolve_pool_rays(reverse=True))
    _, _, iters = render_pool_sharded(scene, cam, config, mesh)
    return int(-(-int(iters) * slack // 1))


def train_step_fused(params, rest_scene, cam: Camera,
                     config: cfg_mod.RenderConfig, target, mesh,
                     n_iters: int, lr: float = 1e-2):
    """Training step through the reverse-mode regeneration pool, sharded.

    The multi-chip version of integrator/diff_fused: each device runs its
    own fixed-trip diff pool over a contiguous row-block (on a GPU the
    custom-VJP Pallas kernel where it covers the plan), and the parameter
    gradients are all-reduced by AD itself (the replicated->varying pcast
    of `params` transposes to exactly one psum per leaf — the DP pattern
    the BASELINE prescribes, overlapped with the backward by XLA's
    scheduler).  Scene must satisfy `integrator.diff_fused.supported`.

    Returns (new_params, loss, leftover); `leftover` MUST be checked
    host-side — nonzero means n_iters did not drain some shard's queue and
    the image/gradient is missing that work (see diff_fused docstring).
    """
    n_dev = mesh.shape[RAY_AXIS]
    assert config.ny % n_dev == 0, (
        f"ny={config.ny} must divide evenly over {n_dev} devices")
    # params replicated on the mesh up front: the returned params come back
    # that way, so a chained step hits the same executable
    params = jax.device_put(params, NamedSharding(mesh, P()))
    return _train_fused_jit(params, rest_scene, cam, target,
                            jnp.asarray(lr, config.jnp_dtype),
                            config=config, mesh=mesh, n_iters=n_iters)


@functools.partial(jax.jit,
                   static_argnames=("config", "mesh", "n_iters"))
def _train_fused_jit(params, rest_scene, cam, target, lr, *, config, mesh,
                     n_iters):
    # see _render_sharded_jit: cached executable; rest_scene/lr are
    # operands (a closure capture would bake them as new constants and
    # defeat the cache).
    #
    # check_vma=False: the custom-VJP kernel replays and transposes the
    # step with an in-kernel jax.vjp, and jax.vjp re-abstracts its
    # primals WITHOUT the shard_map varying-axes type — so under vma
    # tracking it rejects the (varying) cotangents outright and the
    # Pallas backward cannot trace inside shard_map at all (the error
    # text itself prescribes this flag).  Without vma tracking AD no
    # longer auto-inserts the
    # replicated-param gradient psum, so it is EXPLICIT below — exactness
    # covered by test_train_step_fused_matches_single_device_diff_pool
    # (f64 sharded-vs-single gradients at 1e-12).
    from ..integrator import pool_fused

    rows = config.ny // mesh.shape[RAY_AXIS]
    local_pix = rows * config.nx
    dtype = config.jnp_dtype

    def local_loss(params, rest_scene, cam, target_shard):
        scene = sb.combine(params, rest_scene)
        shard = jax.lax.axis_index(RAY_AXIS)
        raw0 = jnp.zeros((local_pix, 3), dtype)
        raw, _, leftover = pool_fused.render_pool_fused(
            scene, cam, config, raw0, 0, pix0=shard * local_pix,
            total_pix=config.n_pixels, static_iters=n_iters)
        img = (raw / config.spp).reshape(rows, config.nx, 3)
        # mean over the FULL image: local sum / global count
        loss = jnp.sum((img - target_shard) ** 2) / (config.ny * config.nx * 3)
        return loss, leftover

    def step(params, rest_scene, cam, target_shard, lr):
        (loss, leftover), grads = jax.value_and_grad(
            local_loss, has_aux=True)(params, rest_scene, cam, target_shard)
        loss = jax.lax.psum(loss, RAY_AXIS)
        leftover = jax.lax.psum(leftover, RAY_AXIS)
        # explicit DP gradient all-reduce (check_vma=False, see above)
        grads = jax.lax.psum(grads, RAY_AXIS)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return new_params, loss, leftover

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(), P(), P(), P(RAY_AXIS), P()),
                   out_specs=(P(), P(), P()), check_vma=False)
    return fn(params, rest_scene, cam, target, lr)


def train_step(params, rest_scene, cam: Camera, config: cfg_mod.RenderConfig,
               target, mesh, lr: float = 1e-2):
    """One inverse-rendering SGD step: L2 image loss, psum'd param grads.

    params/rest_scene from `scene.build.partition`; target [ny,nx,3]
    (sharded over rows like the render).  Returns (new_params, loss).
    """
    return _train_jit(params, rest_scene, cam, target,
                      jnp.asarray(lr, config.jnp_dtype),
                      config=config, mesh=mesh)


@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def _train_jit(params, rest_scene, cam, target, lr, *, config, mesh):
    # see _render_sharded_jit: cached executable, operand rest_scene/lr
    rows = config.ny // mesh.shape[RAY_AXIS]
    dtype = config.jnp_dtype
    dcfg = config.replace(differentiable=True)

    def local_loss(params, rest_scene, cam, target_shard):
        scene = sb.combine(params, rest_scene)
        img = _mean_image_local(scene, cam, dcfg, rows, dtype)
        # mean over the FULL image: local sum / global count
        return jnp.sum((img - target_shard) ** 2) / (config.ny * config.nx * 3)

    def step(params, rest_scene, cam, target_shard, lr):
        loss, grads = jax.value_and_grad(local_loss)(
            params, rest_scene, cam, target_shard)
        loss = jax.lax.psum(loss, RAY_AXIS)
        # The DP gradient all-reduce is inserted by AD itself: params enter
        # the shard-varying loss through a replicated->varying broadcast
        # (pcast to varying), whose transpose is exactly psum over the mesh
        # axis — so `grads` is already the global (replicated) gradient
        # here.  An explicit psum on top would multiply it by the device
        # count (caught by test_psum_gradients_match_single_device).
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return new_params, loss

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(), P(), P(), P(RAY_AXIS), P()),
                   out_specs=(P(), P()))
    return fn(params, rest_scene, cam, target, lr)
