"""How the pool picks and shapes the bounce kernels, on the CPU: the step
choice by platform, the power-of-two padding and lane blocks the Triton
route needs, which plans the forward and custom-VJP kernels cover, and the
multi-process start-up.  The compiled forward kernel is checked by the
`gpu` tests, which skip without a card; the compiled custom-VJP kernel
takes minutes to compile and is checked by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.integrator import bounce, pool_fused
from scheme_raytrace.parallel import distributed
from scheme_raytrace.scene import compile_scene
from scheme_raytrace.utils import smoke


def _plan(spec_fn, **cfg):
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky)
    config = RenderConfig(nx=16, ny=16, spp=1, max_depth=4, **cfg)
    return scene, spec.camera(aspect=1.0), bounce.make_plan(scene, config)


@pytest.mark.parametrize("backend,use_pallas,reverse,want", [
    ("gpu", None, False, "pallas"),
    ("gpu", None, True, "pallas-vjp"),
    ("cpu", None, False, "jnp"),
    ("cpu", None, True, "jnp"),
    ("gpu", False, False, "jnp"),
    ("gpu", False, True, "jnp"),
    ("cpu", True, False, "pallas"),
])
def test_step_choice_by_platform(monkeypatch, backend, use_pallas, reverse,
                                 want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    _, _, plan = _plan(scenes.cornell_box, light_sampling=True)
    config = RenderConfig(use_pallas=use_pallas)
    step, impl = pool_fused.choose_step(plan, 256, config, reverse=reverse)
    assert impl == want
    assert (step is bounce.step) == (want == "jnp")


@pytest.mark.parametrize("spec_fn", [scenes.klein_scene, scenes.test_bezier,
                                     scenes.textured_scene,
                                     lambda: scenes.random_scene(seed=0)])
def test_reverse_falls_back_to_jnp_where_vjp_kernel_does_not_cover(
        monkeypatch, spec_fn):
    # on a GPU the forward still takes the kernel; the reverse pool runs
    # the checkpointed jnp step for plans the VJP kernel cannot replay
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    _, _, plan = _plan(spec_fn)
    assert not bounce.vjp_kernel_covers(plan)
    cfg = RenderConfig()
    assert pool_fused.choose_step(plan, 256, cfg, reverse=True)[1] == "jnp"
    assert pool_fused.choose_step(plan, 256, cfg)[1] == "pallas"


def _bezier_chain():
    # a points.load_bezier_chain scene: one bezier per polyline segment
    from scheme_raytrace import points
    from scheme_raytrace.scene import objects as ob
    t = np.linspace(0.0, 6.0, 40)
    pts = np.stack([np.cos(t), np.sin(t), 0.2 * t - 2.0], axis=1)
    objs = points.bezier_objs(points.points_to_bezier_cps(pts), 0.05,
                              ob.Lambertian((0.7, 0.4, 0.2)))
    return scenes.SceneSpec(objs, scenes.default_camera(), "gradient")


@pytest.mark.parametrize("field", ["n_media", "n_kleins", "n_beziers"])
def test_plans_past_the_kernel_bounds_run_the_jnp_step(monkeypatch, field):
    import dataclasses
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    _, _, plan = _plan(smoke.bounds_scene)
    assert bounce.fwd_kernel_covers(plan)
    assert pool_fused.choose_step(plan, 256, RenderConfig())[1] == "pallas"
    past = dataclasses.replace(plan, **{field: getattr(plan, field) + 1})
    assert not bounce.fwd_kernel_covers(past)
    assert not bounce.vjp_kernel_covers(past)
    for reverse in (False, True):
        for use_pallas in (None, True):
            step, impl = pool_fused.choose_step(
                past, 256, RenderConfig(use_pallas=use_pallas),
                reverse=reverse)
            assert impl == "jnp" and step is bounce.step
    with pytest.raises(AssertionError):
        bounce.as_pallas(past, 256)


def test_bezier_chain_scene_runs_the_jnp_step(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    _, _, plan = _plan(_bezier_chain)
    assert plan.n_beziers > bounce.KERNEL_MAX_BEZIERS
    assert pool_fused.choose_step(plan, 256, RenderConfig())[1] == "jnp"


@pytest.mark.parametrize("spec_fn,covered", [
    (scenes.cornell_box, True), (scenes.three_spheres, True),
    (scenes.cornell_smoke, True), (scenes.cornell_klein, False),
    (scenes.cornell_bezier, False)])
def test_vjp_kernel_covers(spec_fn, covered):
    assert bounce.vjp_kernel_covers(_plan(spec_fn)[2]) == covered


@pytest.mark.parametrize("n,want", [(1, 1), (2, 2), (3, 4), (27, 32),
                                    (495, 512), (512, 512), (513, 1024)])
def test_pow2_pad(n, want):
    x = jnp.arange(1, n + 1, dtype=jnp.float32)
    y = np.asarray(bounce._pow2_pad(x))
    assert y.shape == (want,)
    np.testing.assert_array_equal(y[:n], np.asarray(x))
    assert (y[n:] == 0).all()


@pytest.mark.parametrize("m,block,want", [(65536, 128, 128), (24576, 256, 256),
                                          (384, 256, 128), (640, 512, 128),
                                          (128, 1024, 128)])
def test_block_lanes_divides_pool(m, block, want):
    b = bounce._block_lanes(m, block)
    assert b == want and m % b == 0 and b & (b - 1) == 0


def test_packed_scene_padding_is_inert():
    # the kernel reads the zero-padded pk: every real offset keeps its
    # value, so the step is unchanged by the padding
    scene, cam, plan = _plan(scenes.cornell_box, light_sampling=True)
    pk = bounce.pack(scene, cam, plan, jnp.float32)
    padded = bounce._pow2_pad(pk)
    lanes = smoke.random_lanes(128, 5, 0.0, 555.0, 16, 16)
    a = bounce.step(plan, pk, *lanes)
    b = bounce.step(plan, padded, *lanes)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_image_atlas_is_flat():
    scene, cam, plan = _plan(scenes.textured_scene)
    pk, atlas = bounce.pack(scene, cam, plan, jnp.float32)
    assert pk.shape == (plan.size,)
    assert atlas.shape == (plan.img_rows * 128,)


def test_distributed_initialize_needs_a_coordinator():
    assert distributed.initialize() is False
    with pytest.raises(ValueError):
        distributed.initialize("localhost:12345")


@pytest.mark.gpu
@pytest.mark.parametrize("spec_fn,ls,lo,hi", [
    (scenes.cornell_box, True, 0.0, 555.0),
    (lambda: scenes.random_scene(seed=0), False, -12.0, 12.0)])
def test_compiled_kernel_matches_jnp_step(spec_fn, ls, lo, hi):
    scene, cam, plan = _plan(spec_fn, light_sampling=ls)
    pk = bounce.pack(scene, cam, plan, jnp.float32)
    m = 8192
    lanes = smoke.random_lanes(m, 1, lo, hi, 16, 16)
    ref = jax.jit(lambda pk, *a: bounce.step(plan, pk, *a))(pk, *lanes)
    kern = bounce.as_pallas(plan, m)
    got = jax.jit(lambda pk, *a: kern(plan, pk, *a))(pk, *lanes)
    smoke.compare_step(ref, got)


@pytest.mark.parametrize("spec_fn,ls", [
    (scenes.cornell_box, True), (lambda: scenes.random_scene(seed=0), False),
    (scenes.textured_scene, False), (scenes.cornell_smoke, True),
    (scenes.cornell_klein, True), (scenes.cornell_bezier, True),
    (smoke.exotic_scene, False), (smoke.bounds_scene, False)],
    ids=["cornell", "rtow_final", "textured", "cornell_smoke",
         "cornell_klein", "cornell_bezier", "exotic", "at_bounds"])
def test_forward_kernel_lowers_to_triton(spec_fn, ls):
    # lowering for CUDA runs the Triton route's lowering rules on the CPU:
    # an op the route cannot lower fails here, not first on the card
    from jax import export
    scene, cam, plan = _plan(spec_fn, light_sampling=ls)
    pk = bounce.pack(scene, cam, plan, jnp.float32)
    m = 256
    kern = bounce.as_pallas(plan, m)
    lanes = smoke.random_lanes(m, 0, 0.0, 1.0, 16, 16)
    exp = export.export(
        jax.jit(lambda pk, *a: kern(plan, pk, *a)), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(pk, *lanes)
    assert b"triton" in exp.mlir_module_serialized


def test_vjp_kernel_lowers_to_triton():
    from jax import export
    scene, cam, plan = _plan(scenes.cornell_box, light_sampling=True)
    pk = bounce.pack(scene, cam, plan, jnp.float32)
    m = 256
    vs = bounce.as_pallas_vjp(plan, m)
    gitem, px, py, fresh, alive, depth, *rest = smoke.random_lanes(
        m, 0, 0.0, 555.0, 16, 16)

    def g(pk, *rest):
        def f(pk, o, d, t, rad, tp):
            return vs(plan, pk, gitem, px, py, fresh, alive, depth,
                      o, d, t, rad, tp)[:5]
        out, back = jax.vjp(f, pk, *rest)
        return back(out)

    exp = export.export(
        jax.jit(g), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(pk, *rest)
    assert b"triton" in exp.mlir_module_serialized


def test_slim_sphere_sweep_reverse_mode_matches_full_merge():
    # >64-sphere groups take the slim sweep (winner attributes gathered
    # from pk) in both directions; its cotangents must equal the
    # full-merge sweep's on the same inputs
    import dataclasses
    scene, cam, plan = _plan(lambda: scenes.random_scene(seed=0))
    assert plan.attr_sweep
    full = dataclasses.replace(plan, attr_sweep=False)
    pk = bounce.pack(scene, cam, plan, jnp.float32)
    gitem, px, py, fresh, alive, depth, *rest = smoke.random_lanes(
        256, 4, -12.0, 12.0, 16, 16)

    def vjp_of(p):
        def f(pk, o, d, t, rad, tp):
            return bounce.step(p, pk, gitem, px, py, fresh, alive, depth,
                               o, d, t, rad, tp)[:5]
        out, back = jax.vjp(f, pk, *rest)
        return out, back(jax.tree.map(jnp.ones_like, out))

    out_s, g_s = vjp_of(plan)
    out_f, g_f = vjp_of(full)
    smoke.compare_tree(out_f, out_s)
    smoke.compare_tree(g_f, g_s)
