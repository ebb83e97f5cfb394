"""Differentiability tests: analytic gradients vs finite differences and
closed forms (BASELINE: differentiable w.r.t. sphere centers/radii, Bezier
control points, albedo, camera pose)."""

import jax
import jax.numpy as jnp
import numpy as np

from scheme_raytrace import render as R
from scheme_raytrace.camera import make_camera
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.scene import build as sb
from scheme_raytrace.scene import compile_scene, objects as ob

CFG = RenderConfig(nx=8, ny=8, spp=1, max_depth=3, differentiable=True)


def _furnace_scene():
    # Big sphere filling the frame under a white sky: every ray hits, so the
    # hit set is FD-stable and L = albedo exactly (zero-variance).
    objs = [ob.Sphere((0, 0, -3), 2.0, ob.Lambertian((0.4, 0.5, 0.6)))]
    scene = compile_scene(objs, sky=(np.ones(3), np.ones(3)))
    cam = make_camera((0, 0, 0), (0, 0, -1), vfov=30.0, aspect=1.0)
    return scene, cam


def _mean_image(params, rest, cam, cfg=CFG):
    scene = sb.combine(params, rest)
    mean, _ = R.render_image(scene, cam, cfg)
    return jnp.mean(mean)


def test_albedo_gradient_exact():
    # Furnace: L = albedo componentwise -> d(mean L)/d(tex_color[c]) = 1/3
    scene, cam = _furnace_scene()
    params, rest = sb.partition(scene)
    g = jax.grad(_mean_image)(params, rest, cam)
    np.testing.assert_allclose(np.asarray(g["tex_color"][0]), 1.0 / 3.0,
                               atol=1e-5)


def test_gradients_flow_to_all_baseline_leaves():
    # Geometry-dependent setup: gradient sky makes the scattered-direction
    # distribution matter, so center/radius/camera grads are nonzero.
    objs = [ob.Sphere((0.0, 0.1, -3.0), 2.0, ob.Lambertian((0.4, 0.5, 0.6)))]
    scene = compile_scene(objs, sky="gradient")
    cam = make_camera((0, 0, 0), (0, 0, -1), vfov=30.0, aspect=1.0)
    params, rest = sb.partition(scene)
    g = jax.grad(_mean_image)(params, rest, cam)
    for leaf in ("sph_c0", "sph_r", "tex_color"):
        assert np.isfinite(np.asarray(g[leaf])).all(), leaf
        assert np.abs(np.asarray(g[leaf])).max() > 0.0, leaf

    g_cam = jax.grad(lambda c: _mean_image(params, rest, c))(cam)
    assert np.isfinite(np.asarray(g_cam.lookfrom)).all()
    assert (np.abs(np.asarray(g_cam.lookfrom)).max()
            + np.abs(np.asarray(g_cam.vfov)).max()) > 0.0


def _mirror_setup():
    # Deterministic specular path: fuzz-0 metal sphere filling the frame
    # under the gradient sky.  L(pixel) = albedo * sky(reflect(d, n)) — no
    # RNG anywhere, and normals (hence L) swing strongly with center/radius,
    # so f32 finite differences have real signal.
    objs = [ob.Sphere((0.0, 0.0, -3.0), 2.0, ob.Metal((0.9, 0.9, 0.9), 0.0))]
    scene = compile_scene(objs, sky="gradient")
    cam = make_camera((0, 0, 0), (0, 0, -1), vfov=30.0, aspect=1.0)
    return sb.partition(scene) + (cam,)


def test_sphere_center_gradient_matches_fd():
    params, rest, cam = _mirror_setup()
    cfg = CFG.replace(max_depth=2)

    def f(cy):
        p = dict(params)
        p["sph_c0"] = params["sph_c0"].at[0, 1].set(cy)
        p["sph_c1"] = p["sph_c0"]
        return _mean_image(p, rest, cam, cfg)

    g = float(jax.grad(f)(jnp.asarray(0.0)))
    eps = 2e-2
    fd = (float(f(jnp.asarray(eps))) - float(f(jnp.asarray(-eps)))) / (2 * eps)
    assert abs(fd) > 1e-3, "setup lost its FD signal"
    np.testing.assert_allclose(g, fd, rtol=0.05)


def test_radius_gradient_matches_fd():
    params, rest, cam = _mirror_setup()
    cfg = CFG.replace(max_depth=2)

    def f(r):
        p = dict(params)
        p["sph_r"] = params["sph_r"].at[0].set(r)
        return _mean_image(p, rest, cam, cfg)

    g = float(jax.grad(f)(jnp.asarray(2.0)))
    eps = 2e-2
    fd = (float(f(jnp.asarray(2.0 + eps))) - float(f(jnp.asarray(2.0 - eps)))) / (2 * eps)
    assert abs(fd) > 1e-4, "setup lost its FD signal"
    np.testing.assert_allclose(g, fd, rtol=0.08)


def test_bezier_cp_gradient_finite_nonzero():
    # The B11 normal convention (normal = -ray.dir, bezier.scm:211-213) makes
    # a *constant*-albedo lambertian ribbon's radiance independent of the
    # control points along every continuous path (the normal, hence the
    # scatter distribution, never sees cp; only discrete hit/miss changes).
    # A marble texture restores continuous dependence: albedo(p) with
    # p = o + t(cp)*d.
    cp = np.array([[-1.0, 0.0, -2.0], [-0.3, 0.4, -2.0],
                   [0.3, 0.4, -2.0], [1.0, 0.0, -2.0]])
    objs = [ob.Bezier(cp, 0.4, ob.Lambertian(ob.MarbleTexture(4.0)))]
    scene = compile_scene(objs, sky="gradient")
    cam = make_camera((0, 0, 0.5), (0, 0, -2), vfov=60.0, aspect=1.0)
    params, rest = sb.partition(scene)
    g = jax.grad(_mean_image)(params, rest, cam)
    assert np.isfinite(np.asarray(g["bez_cp"])).all()
    assert np.abs(np.asarray(g["bez_cp"])).max() > 0.0


def test_bezier_hit_t_gradient_matches_fd():
    # Pointwise d(t_hit)/d(cp) through the implicit-differentiated Newton
    # root (ops/bezier.py): AD must match central FD tightly — this is the
    # kernel-level gradient-correctness claim, independent of the chaotic
    # render-level integrands the parity harness averages over.
    from scheme_raytrace.ops import bezier as bz
    import dataclasses

    cp0 = np.array([[-1, 0, -1], [-0.8, 1, 1], [0.8, -1, 1], [1, 0, -1]],
                   float)
    objs = [ob.Bezier(cp0, 0.7, ob.Lambertian((0.5, 0.5, 0.5)))]
    scene = compile_scene(objs, sky="black")
    o = jnp.asarray([[0.1, 0.05, -5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)

    def t_of(cp_leaf):
        s2 = dataclasses.replace(scene, bez_cp=cp_leaf[None])
        hit, t, *_ = bz.intersect(o, d, jnp.zeros(1, jnp.float32), s2,
                                  1e-3, 1e9)
        return t[0]

    cp = jnp.asarray(cp0, jnp.float32)
    assert float(t_of(cp)) < 1e8, "probe ray must hit the curve"
    ad = np.asarray(jax.grad(t_of)(cp))
    eps = 1e-3
    for (i, j) in [(0, 2), (1, 1), (2, 0), (3, 2)]:
        cp_p = cp0.copy(); cp_p[i, j] += eps
        cp_m = cp0.copy(); cp_m[i, j] -= eps
        fd = (float(t_of(jnp.asarray(cp_p, jnp.float32)))
              - float(t_of(jnp.asarray(cp_m, jnp.float32)))) / (2 * eps)
        np.testing.assert_allclose(ad[i, j], fd, rtol=0.02, atol=1e-4)


def test_no_nan_grads_shading_point_inside_sphere_light():
    # Round-1 regression: sqrt(1 - r^2/d^2) NaN'd in reverse-mode whenever a
    # shading point sat within `radius` of a sphere light (incl. padded
    # invalid light rows near the origin).  Surfaces here sit INSIDE the
    # light sphere's radius on purpose.
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.5, 0.5, 0.5))),
            ob.Sphere((0, 0.0, -1), 3.0, ob.DiffuseLight((4.0, 4.0, 4.0)))]
    scene = compile_scene(objs, sky="black")
    assert scene.n_lights == 1
    cam = make_camera((0, 0.8, 2), (0, 0, -1), vfov=60.0, aspect=1.0)
    params, rest = sb.partition(scene)
    cfg = CFG.replace(light_sampling=True)
    g = jax.grad(_mean_image)(params, rest, cam, cfg)
    for name, leaf in g.items():
        assert np.isfinite(np.asarray(leaf)).all(), f"NaN grad in {name}"


def test_no_nan_grads_on_full_cornell():
    # The NaN-hygiene test: every masked-out lane (sqrt of negative
    # discriminants etc.) must stay NaN-free under reverse-mode.
    from scheme_raytrace import scenes as sc_mod
    spec = sc_mod.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    params, rest = sb.partition(scene)
    cfg = CFG.replace(light_sampling=True)
    g = jax.grad(_mean_image)(params, rest, cam, cfg)
    for name, leaf in g.items():
        assert np.isfinite(np.asarray(leaf)).all(), f"NaN grad in {name}"


def test_no_nan_grads_on_cornell_klein_wavefront():
    # Round-5 regression (found driving the public API): the wavefront
    # path differentiated THROUGH the klein march's 100-step fori tape;
    # tape positions of rays passing near an inversion-sphere center
    # ((550,500,280) lies inside the Cornell box) overflow the squared
    # reverse-mode tangents to inf, and inf - inf poisoned EVERY gradient
    # leaf (kl_center, rect_k, rect_flip...) through the masked selects.
    # ops/klein.intersect now marches under stop_gradient and attaches
    # the implicit-function t at the root, the fused kernel's convention.
    from scheme_raytrace import scenes as sc_mod
    spec = sc_mod.cornell_klein()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    params, rest = sb.partition(scene)
    g = jax.grad(_mean_image)(params, rest, cam, CFG)
    for name, leaf in g.items():
        assert np.isfinite(np.asarray(leaf)).all(), f"NaN grad in {name}"
    assert np.abs(np.asarray(g["kl_center"])).max() > 0
