"""Regeneration pool over the fused SoA bounce step (integrator/bounce.py).

Same estimator and RNG streams as integrator/pool.py, but:
  * pool state is struct-of-scalars ([M] per component, never [M, 3]),
    so every glue op reads and writes contiguous lanes;
  * the bounce itself is one fused step — on a GPU a Pallas kernel
    (bounce.as_pallas), elsewhere the same code traced as plain jnp;
  * the WORK UNIT IS A GROUP OF K ADJACENT PIXELS (K=1 when the frame
    does not divide): a lane renders all config.spp jittered paths of
    pixel k*K+0, then k*K+1, ..., summing each pixel's passes in-lane in
    pass order into its own accumulator row, and stages the K finished
    sums under ONE framebuffer index when the group completes.  On the
    earlier accelerator the framebuffer flush scatter dominated the
    forward render, its cost scaling with staged index SLOTS rather than
    real updates (not measured on H100).  Pixel work units cut
    the slots spp-fold (completions on a lane are >= spp iterations
    apart); grouping cuts them a further K-fold — slots =
    M*iters/(K*spp) — because S staging rows of K pixel-sums share one
    index, scattered into a [3K, n_pix/K] framebuffer view (row c*K+s =
    component c of group sub-pixel s).  The ESTIMATOR IS BIT-IDENTICAL
    for any K: each pixel's passes are summed in pass order starting
    from 0.0 either way, each pixel contributes exactly ONE scatter-add
    per render call (dummy slots add 0.0, a bitwise no-op), and the RNG
    is keyed by the global (pass, pixel) id.
  * the flush is BATCHED: staged groups go to [S, K, M] sequence buffers
    via a dense one-hot write, and the scatter-add runs once every F
    bounce iterations into the [3K, n_pix/K] framebuffer planes (densely
    tiled; transposed back once per render).

Within any F-iteration window a lane finishes at most
S = (F-1)//(K*spp) + 1 groups (each pixel needs >= spp iterations — one
per path at minimum — so a group needs >= K*spp), so the S staging rows
can never overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import bounce

FLUSH_EVERY = 8     # F floor: bounce iterations per framebuffer scatter
GROUP_MAX = 4       # K cap: pixels per work item (scatter-slot divisor)
FLUSH_MAX = 64      # F cap: bounds the drain-check/overshoot granularity

# Which step implementation the most recent render_pool_fused trace picked,
# keyed by direction: {"forward": "pallas"|"jnp", "reverse":
# "pallas-vjp"|"jnp"}.  Set at TRACE time (the moment the choice is made),
# so bench output can record what actually executed.
LAST_STEP_IMPL: dict = {}


class FusedState(NamedTuple):
    ox: jnp.ndarray; oy: jnp.ndarray; oz: jnp.ndarray
    dx: jnp.ndarray; dy: jnp.ndarray; dz: jnp.ndarray
    time: jnp.ndarray
    rx: jnp.ndarray; ry: jnp.ndarray; rz: jnp.ndarray     # path radiance
    tx: jnp.ndarray; ty: jnp.ndarray; tz: jnp.ndarray     # throughput
    ax: jnp.ndarray; ay: jnp.ndarray; az: jnp.ndarray     # [K, M] pixel sums
    item: jnp.ndarray     # [M] i32 local work item (a GROUP of K pixels)
    pass_idx: jnp.ndarray  # [M] i32 current pass within the group [0, K*spp)
    px: jnp.ndarray       # [M] f32 pixel x (precomputed for the kernel)
    py: jnp.ndarray       # [M] f32 pixel y
    fresh: jnp.ndarray    # [M] bool — regenerate this lane's camera ray
    depth: jnp.ndarray    # [M] i32 bounces completed on current path
    alive: jnp.ndarray    # [M] bool
    next_w: jnp.ndarray   # scalar i32
    seq_x: jnp.ndarray; seq_y: jnp.ndarray; seq_z: jnp.ndarray  # [S, K, M]
    seq_pix: jnp.ndarray  # [S, M] i32 (0-init: flushes add 0.0 — harmless)
    seq_k: jnp.ndarray    # [M] i32 staged group count since last flush
    rawK: jnp.ndarray     # [3K, n_pix/K] framebuffer planes
    segments: jnp.ndarray
    iters: jnp.ndarray


def _pixel_of(item, n_pix, stride, offset):
    """Local frame pixel of a work item.

    Default (stride=1, offset=0): item IS the pixel.  With stride=n_dev,
    offset=shard: local item k maps to GLOBAL pixel k*n_dev + shard — the
    interleaved sharding of parallel.pool's balanced mode, where every
    shard samples the whole frame and partial framebuffers are psum'd.
    The modulo only sanitizes dead padding lanes (item >= n_work)."""
    return (item * stride + offset) % n_pix


def choose_group(n_local, pool_cap, item_stride, plan) -> int:
    """Pixels per work item (K).

    K>1 divides the flush-scatter index slots K-fold but multiplies the
    per-item latency, which costs drain-tail occupancy — so it pays only
    when (a) the per-bounce kernel is cheap enough that the scatter is a
    real fraction of the step (klein/bezier march loops dominate their
    kernels: K=1), and (b) lanes still get >= 2 work items each so the
    tail stays amortized.  The rule comes from a campaign on the earlier
    accelerator; not measured on H100."""
    if item_stride != 1 or plan.n_kleins or plan.n_beziers:
        return 1
    m_est = max(128, min(pool_cap, ((n_local + 127) // 128) * 128))
    for k in (GROUP_MAX, 2):
        if n_local % k == 0 and n_local // k >= 2 * m_est:
            return k
    return 1


def choose_step(plan, m, config, reverse=False):
    """(step function, name) for one pool: chosen by platform.

    On a GPU the Pallas kernels run (forward `as_pallas` where
    bounce.fwd_kernel_covers the plan; reverse `as_pallas_vjp` where
    bounce.vjp_kernel_covers it), else the jnp step; elsewhere the jnp
    step.  config.use_pallas forces either way within those bounds.  A
    kernel that fails to compile is an error, never a silent fallback."""
    use_kernel = (jax.default_backend() == "gpu" if config.use_pallas is None
                  else config.use_pallas)
    if reverse:
        if use_kernel and bounce.vjp_kernel_covers(plan):
            return bounce.as_pallas_vjp(plan, m), "pallas-vjp"
        return bounce.step, "jnp"
    if use_kernel and bounce.fwd_kernel_covers(plan):
        return bounce.as_pallas(plan, m), "pallas"
    return bounce.step, "jnp"


def render_pool_fused(scene, cam, config, raw0, sample_base, pix0=0,
                      total_pix=None, vary_axes=(), static_iters=None,
                      item_stride=1, item_offset=0):
    """Drop-in render_pool with the fused bounce; same return contract.

    `static_iters=None` (forward rendering) drains the work queue with a
    `while_loop`.  A static iteration count switches to a fixed-length
    `scan` — the REVERSE-MODE-DIFFERENTIABLE pool (integrator/diff_fused):
    same estimator, same RNG, bit-identical image, but with a static trip
    count so jax.grad applies; the caller must size static_iters to drain
    the queue (checked via the returned leftover count).  On a GPU the
    scan path differentiates through the custom-VJP kernel where
    bounce.vjp_kernel_covers the plan.

    `item_stride`/`item_offset`: interleaved pixel sharding (_pixel_of) —
    this shard renders global pixels k*stride + offset; raw0 must then be
    the FULL frame and the caller psums partial framebuffers.
    """
    n_pix = raw0.shape[0]
    total_pix = config.n_pixels if total_pix is None else total_pix
    spp = config.spp
    assert n_pix % item_stride == 0, (n_pix, item_stride)
    n_local = n_pix // item_stride             # LOCAL pixels
    plan = bounce.make_plan(scene, config)
    # Both bounds 128-aligned: a user-set --pool-rays that is not a multiple
    # of 128 must not leak through (bounce.as_pallas asserts m % 128 == 0).
    pool_cap = max(128, config.resolve_pool_rays(
        reverse=static_iters is not None) // 128 * 128)
    K = choose_group(n_local, pool_cap, item_stride, plan)
    n_work = n_local // K                      # LOCAL work items (groups)
    m = max(128, min(pool_cap, ((n_work + 127) // 128) * 128))
    dtype = raw0.dtype
    # F >= K*spp keeps S=1 (one index slot per lane per window); the cap
    # bounds while_loop drain-check granularity and all-dead overshoot.
    F = max(FLUSH_EVERY, min(K * spp, FLUSH_MAX))
    S = (F - 1) // (K * spp) + 1               # staging rows (see module doc)
    pk = bounce.pack(scene, cam, plan, dtype)
    step, impl = choose_step(plan, m, config, reverse=static_iters is not None)
    LAST_STEP_IMPL["reverse" if static_iters is not None else "forward"] = impl
    use_vjp_kernel = impl == "pallas-vjp"

    G = n_pix // K                             # framebuffer pixel groups
    item0 = jnp.arange(m, dtype=jnp.int32)
    pixl0 = _pixel_of(item0 * K, n_pix, item_stride, item_offset)
    ys0, xs0 = jnp.divmod(pix0 + pixl0, config.nx)
    z = jnp.zeros(m, dtype)
    zi = jnp.zeros(m, jnp.int32)
    # [3, n_pix] -> [3K, G]: row c*K+s = component c of group sub-pixel s
    rawK0 = raw0.T.reshape(3, G, K).transpose(0, 2, 1).reshape(3 * K, G)
    state = FusedState(
        ox=z, oy=z, oz=z, dx=z, dy=z, dz=jnp.ones(m, dtype), time=z,
        rx=z, ry=z, rz=z, tx=z, ty=z, tz=z,
        ax=jnp.zeros((K, m), dtype), ay=jnp.zeros((K, m), dtype),
        az=jnp.zeros((K, m), dtype),
        item=item0, pass_idx=zi,
        px=xs0.astype(dtype), py=ys0.astype(dtype),
        fresh=item0 < n_work,
        depth=zi, alive=item0 < n_work,
        next_w=jnp.asarray(m, jnp.int32),
        seq_x=jnp.zeros((S, K, m), dtype), seq_y=jnp.zeros((S, K, m), dtype),
        seq_z=jnp.zeros((S, K, m), dtype),
        seq_pix=jnp.zeros((S, m), jnp.int32),
        seq_k=zi,
        rawK=rawK0,
        segments=jnp.zeros((), jnp.int32),
        iters=jnp.zeros((), jnp.int32),
    )
    if vary_axes:
        def _vary(x):
            have = getattr(jax.typeof(x), "vma", frozenset())
            need = tuple(a for a in vary_axes if a not in have)
            return jax.lax.pcast(x, need, to='varying') if need else x
        state = jax.tree.map(_vary, state)

    col = jax.lax.broadcasted_iota(jnp.int32, (S, m), 0)
    rowK = jax.lax.broadcasted_iota(jnp.int32, (K, m), 0)
    KS = K * spp

    def bounce_iter(_, st: FusedState) -> FusedState:
        # RNG key: the global (pass, pixel) work item — identical stream
        # to the per-path pools, shard-, band- and K-invariant
        sub = st.pass_idx // spp               # sub-pixel within the group
        pas = st.pass_idx - sub * spp          # pass within the sub-pixel
        pixl = _pixel_of(st.item * K + sub, n_pix, item_stride, item_offset)
        gitem = (sample_base + pas) * total_pix + (pix0 + pixl)
        o, d, time, rad, tp, scattering = step(
            plan, pk, gitem, st.px, st.py, st.fresh, st.alive, st.depth,
            (st.ox, st.oy, st.oz), (st.dx, st.dy, st.dz), st.time,
            (st.rx, st.ry, st.rz), (st.tx, st.ty, st.tz))

        # --- fold the finished path into its pixel's accumulator row -------
        path_done = st.alive & ~scattering
        fold = (rowK == sub[None, :]) & path_done[None, :]
        ax = st.ax + jnp.where(fold, rad[0][None, :], 0.0)
        ay = st.ay + jnp.where(fold, rad[1][None, :], 0.0)
        az = st.az + jnp.where(fold, rad[2][None, :], 0.0)
        group_done = path_done & (st.pass_idx >= KS - 1)
        more = path_done & ~group_done        # next pass or next sub-pixel

        # --- stage finished groups in the sequence buffer -------------------
        onehot = (col == st.seq_k[None, :]) & group_done[None, :]   # [S, M]
        seq_x = jnp.where(onehot[:, None, :], ax[None, :, :], st.seq_x)
        seq_y = jnp.where(onehot[:, None, :], ay[None, :, :], st.seq_y)
        seq_z = jnp.where(onehot[:, None, :], az[None, :, :], st.seq_z)
        gidx = _pixel_of(st.item * K, n_pix, item_stride, item_offset) // K
        seq_pix = jnp.where(onehot, gidx[None, :], st.seq_pix)
        seq_k = st.seq_k + group_done.astype(jnp.int32)
        # accumulators of staged groups restart at zero
        ax = jnp.where(group_done[None, :], 0.0, ax)
        ay = jnp.where(group_done[None, :], 0.0, ay)
        az = jnp.where(group_done[None, :], 0.0, az)

        # --- re-issue freed lanes the next groups ---------------------------
        gd = group_done.astype(jnp.int32)
        new_local = st.next_w + jnp.cumsum(gd) - gd     # exclusive rank
        has_work = group_done & (new_local < n_work)
        item = jnp.where(has_work, new_local, st.item)
        pass_idx = jnp.where(more, st.pass_idx + 1,
                             jnp.where(has_work, 0, st.pass_idx))
        fresh = more | has_work
        # pixel coordinates for the lane's next path (sub-pixel may change)
        sub2 = pass_idx // spp
        pixl2 = _pixel_of(item * K + sub2, n_pix, item_stride, item_offset)
        ys, xs = jnp.divmod(pix0 + pixl2, config.nx)
        px = jnp.where(fresh, xs.astype(dtype), st.px)
        py = jnp.where(fresh, ys.astype(dtype), st.py)
        depth = jnp.where(scattering, st.depth + 1,
                          jnp.where(fresh, 0, st.depth))
        alive = scattering | fresh
        # dtype-pinned sums: under x64 (f64 oracle) jnp.sum(int32) promotes
        next_w = jnp.minimum(st.next_w + jnp.sum(gd, dtype=jnp.int32),
                             n_work)
        segments = st.segments + jnp.sum(st.alive, dtype=jnp.int32)
        return FusedState(
            o[0], o[1], o[2], d[0], d[1], d[2], time,
            rad[0], rad[1], rad[2], tp[0], tp[1], tp[2],
            ax, ay, az, item, pass_idx, px, py, fresh, depth, alive,
            next_w, seq_x, seq_y, seq_z, seq_pix, seq_k,
            st.rawK, segments, st.iters + 1)

    def body_flush(st: FusedState) -> FusedState:
        # --- flush staged groups: ONE scatter per F iterations --------------
        idx = st.seq_pix.reshape(-1)                            # [S*M]
        vals = jnp.concatenate(
            [st.seq_x.transpose(1, 0, 2).reshape(K, S * m),
             st.seq_y.transpose(1, 0, 2).reshape(K, S * m),
             st.seq_z.transpose(1, 0, 2).reshape(K, S * m)],
            axis=0)                                             # [3K, S*M]
        rawK = st.rawK.at[:, idx].add(vals)
        return st._replace(
            rawK=rawK,
            seq_x=jnp.zeros_like(st.seq_x), seq_y=jnp.zeros_like(st.seq_y),
            seq_z=jnp.zeros_like(st.seq_z),
            seq_pix=jnp.zeros_like(st.seq_pix),
            seq_k=jnp.zeros_like(st.seq_k))

    def body(st: FusedState) -> FusedState:
        st = jax.lax.fori_loop(0, F, bounce_iter, st)
        return body_flush(st)

    def unK(rawK):
        # [3K, G] -> [n_pix, 3] (inverse of the rawK0 packing above)
        return rawK.reshape(3, K, G).transpose(0, 2, 1).reshape(3, n_pix).T

    if static_iters is None:
        state = jax.lax.while_loop(lambda s: jnp.any(s.alive), body, state)
        return unK(state.rawK), state.segments, state.iters

    # --- fixed-length scan (reverse-mode path) -----------------------------
    # The while_loop drain is rewritten as scan-over-blocks with scan-over-F
    # inside (same F-block flush structure; a static-bound fori_loop would
    # also scan-lower, but the explicit scans make the checkpoint placement
    # and per-step residual story visible).  With the jnp step each block is
    # jax.checkpoint'd: backward stores one carry per F iterations and
    # recomputes the block's bounce chain (the jnp step's tape of
    # per-intermediate residuals would dwarf the carry).  With the
    # custom-VJP kernel the step's residuals ARE its inputs (the pool
    # carry), so storing them all is cheap and the checkpoint's forward
    # recompute would only burn kernel time — no checkpoint.
    n_blocks = max(1, -(-int(static_iters) // F))

    def block(st: FusedState, _):
        st, _ = jax.lax.scan(lambda s, __: (bounce_iter(0, s), None),
                             st, None, length=F)
        return body_flush(st), None

    blockfn = block if use_vjp_kernel else jax.checkpoint(block)
    state, _ = jax.lax.scan(blockfn, state, None, length=n_blocks)
    leftover = (jnp.sum(state.alive, dtype=jnp.int32)
                + (n_work - state.next_w))
    return unK(state.rawK), state.segments, leftover
