"""Custom-VJP Pallas bounce (bounce.as_pallas_vjp): the backward kernel
must reproduce jax.vjp of the plain-jnp step (same math, one fused kernel).

Triton-route kernels in interpret mode on CPU; the compiled kernels are
checked on the card by tests/test_kernel_route.py's `gpu` tests and by
chip_smoke.py.  The fast tier uses a small sphere scene (small packed
buffer, quick interpret-mode compile); the Cornell-scale check is in the
slow tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.integrator import bounce
from scheme_raytrace.scene import compile_scene, objects as ob


def _small_spec():
    return scenes.SceneSpec([
        ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.5, 0.5, 0.5))),
        ob.Sphere((0, 0, -1), 0.5, ob.Metal((0.8, 0.6, 0.2), 0.3)),
        ob.Sphere((-1, 0, -1), 0.5, ob.Dielectric(1.5)),
        ob.Sphere((0, 2, -1), 0.5, ob.DiffuseLight((4, 4, 4))),
    ], scenes.default_camera(), "black")


def _state(spec, m, light_sampling=True):
    config = RenderConfig(nx=16, ny=16, spp=1, max_depth=8,
                          light_sampling=light_sampling)
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    plan = bounce.make_plan(scene, config)
    pk = bounce.pack(scene, cam, plan, jnp.float32)

    key = jax.random.key(7)
    ks = jax.random.split(key, 10)
    gitem = jnp.arange(m, dtype=jnp.int32)
    px = jax.random.randint(ks[0], (m,), 0, 16).astype(jnp.float32)
    py = jax.random.randint(ks[1], (m,), 0, 16).astype(jnp.float32)
    fresh = jax.random.bernoulli(ks[2], 0.5, (m,))
    alive = fresh | jax.random.bernoulli(ks[3], 0.7, (m,))
    depth = jax.random.randint(ks[4], (m,), 0, 4)
    o = tuple(jax.random.uniform(ks[5], (m,)) * 4.0 - 2.0 for _ in range(3))
    dvec = jax.random.normal(ks[6], (m, 3))
    dvec = dvec / jnp.linalg.norm(dvec, axis=-1, keepdims=True)
    d = (dvec[:, 0], dvec[:, 1], dvec[:, 2])
    time = jnp.zeros(m)
    rad = tuple(jax.random.uniform(ks[7], (m,)) for _ in range(3))
    tp = tuple(jax.random.uniform(ks[8], (m,), minval=0.1, maxval=1.0)
               for _ in range(3))
    return plan, pk, gitem, px, py, fresh, alive, depth, o, d, time, rad, tp


def _rand_like_outputs(out, key):
    """Random cotangents for (o', d', time', rad', tp')."""
    ks = iter(jax.random.split(key, 16))

    def r(x):
        return jax.random.normal(next(ks), x.shape, x.dtype)

    return (tuple(r(x) for x in out[0]), tuple(r(x) for x in out[1]),
            r(out[2]), tuple(r(x) for x in out[3]),
            tuple(r(x) for x in out[4]))


def _assert_tree_close(got, ref, rtol=1e-3):
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        g, r = np.asarray(g), np.asarray(r)
        atol = 1e-5 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


def _check_vjp_matches(spec, m=256):
    (plan, pk, gitem, px, py, fresh, alive, depth,
     o, d, time, rad, tp) = _state(spec, m)

    def f_ref(pk, o, d, time, rad, tp):
        return bounce.step(plan, pk, gitem, px, py, fresh, alive, depth,
                           o, d, time, rad, tp)[:5]

    out_ref, vjp_ref = jax.vjp(f_ref, pk, o, d, time, rad, tp)

    stepfn = bounce.as_pallas_vjp(plan, m, interpret=True)

    def f_got(pk, o, d, time, rad, tp):
        return stepfn(plan, pk, gitem, px, py, fresh, alive, depth,
                      o, d, time, rad, tp)[:5]

    out_got, vjp_got = jax.vjp(f_got, pk, o, d, time, rad, tp)
    _assert_tree_close(out_got, out_ref)

    cts = _rand_like_outputs(out_ref, jax.random.key(3))
    _assert_tree_close(vjp_got(cts), vjp_ref(cts))


def test_vjp_kernel_matches_jnp_vjp_spheres():
    # all four material branches + sphere light sampling in one small plan
    _check_vjp_matches(_small_spec())


@pytest.mark.slow
def test_vjp_kernel_matches_jnp_vjp_cornell():
    _check_vjp_matches(scenes.cornell_box())


@pytest.mark.slow
def test_vjp_kernel_grad_through_chain():
    # two chained steps under jax.grad: the custom_vjp must compose
    # (residuals = the carry) and produce finite, nonzero pk gradients.
    # Slow tier: two fwd + two bwd interpret-mode kernel compiles;
    # single-step bwd correctness stays in the fast tier above, and
    # composition on the card is checked by chip_smoke.py's value_and_grad
    # steps.
    (plan, pk, gitem, px, py, fresh, alive, depth,
     o, d, time, rad, tp) = _state(_small_spec(), m=128)
    stepfn = bounce.as_pallas_vjp(plan, 128, interpret=True)

    def loss(pk):
        s = (o, d, time, rad, tp)
        for k in range(2):
            o2, d2, t2, r2, tp2, _ = stepfn(
                plan, pk, gitem, px, py, fresh if k == 0 else
                jnp.zeros_like(fresh), alive, depth + k, s[0], s[1], s[2],
                s[3], s[4])
            s = (o2, d2, t2, r2, tp2)
        return sum(jnp.sum(x) for x in s[3])

    g = jax.jit(jax.grad(loss))(pk)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0


def test_pallas_interpret_matches_jnp_step_exotic():
    # media + bezier probes INSIDE the kernel: the interpret-mode kernel
    # must match the jnp trace of the same step.  Small plan
    # (one medium, one bezier, one sphere) keeps the compile fast-tier-ok.
    from scheme_raytrace.scene import objects as ob
    import numpy as np

    cp = np.array([[-1, 0, -2], [-0.3, 1, -2], [0.3, -1, -2], [1, 0, -2]],
                  float)
    spec = scenes.SceneSpec([
        ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.5, 0.5, 0.5))),
        ob.ConstantMedium(ob.Sphere((0, 0.5, -1), 0.6,
                                    ob.Lambertian((1, 1, 1))),
                          0.8, (0.9, 0.9, 0.9)),
        ob.Bezier(cp, 0.4, ob.Lambertian((0.7, 0.4, 0.2))),
    ], scenes.default_camera(), "gradient")
    config = RenderConfig(nx=16, ny=16, spp=1, max_depth=6)
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    plan = bounce.make_plan(scene, config)
    assert plan.n_media == 1 and plan.n_beziers == 1
    pk = bounce.pack(scene, cam, plan, jnp.float32)

    m = 128
    key = jax.random.key(11)
    ks = jax.random.split(key, 8)
    gitem = jnp.arange(m, dtype=jnp.int32)
    px = jax.random.randint(ks[0], (m,), 0, 16).astype(jnp.float32)
    py = jax.random.randint(ks[1], (m,), 0, 16).astype(jnp.float32)
    fresh = jax.random.bernoulli(ks[2], 0.5, (m,))
    alive = fresh | jax.random.bernoulli(ks[3], 0.7, (m,))
    depth = jax.random.randint(ks[4], (m,), 0, 4)
    o = tuple(jax.random.uniform(ks[5], (m,)) * 2.0 - 1.0 for _ in range(3))
    dvec = jax.random.normal(ks[6], (m, 3))
    dvec = dvec / jnp.linalg.norm(dvec, axis=-1, keepdims=True)
    d = (dvec[:, 0], dvec[:, 1], dvec[:, 2])
    time = jnp.zeros(m)
    rad = tuple(jnp.zeros(m) for _ in range(3))
    tp = tuple(jnp.ones(m) for _ in range(3))

    ref = bounce.step(plan, pk, gitem, px, py, fresh, alive, depth,
                      o, d, time, rad, tp)
    got = bounce.as_pallas(plan, m, interpret=True)(
        plan, pk, gitem, px, py, fresh, alive, depth, o, d, time, rad, tp)
    for r, g, name in [(ref[0], got[0], "o"), (ref[1], got[1], "d"),
                       (ref[3], got[3], "rad"), (ref[4], got[4], "tp")]:
        for i in range(3):
            np.testing.assert_allclose(np.asarray(g[i]), np.asarray(r[i]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name}[{i}]")
    np.testing.assert_array_equal(np.asarray(got[5]), np.asarray(ref[5]))
