"""ONB frame (onb.scm:8-36) and thin-lens camera (camera.scm:63-92) tests."""

import jax
import jax.numpy as jnp
import numpy as np

from scheme_raytrace import camera as cam_mod
from scheme_raytrace.core import vecmath as vm
from scheme_raytrace.ops import onb


def test_onb_orthonormal():
    w_in = vm.unit(jnp.array([[0.3, -0.5, 0.8], [0.99, 0.1, 0.0],
                              [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]))
    u, v, w = onb.from_w(w_in)
    for a, b in [(u, v), (v, w), (u, w)]:
        np.testing.assert_allclose(np.asarray(vm.dot(a, b)), 0.0, atol=1e-6)
    for a in (u, v, w):
        np.testing.assert_allclose(np.asarray(vm.length(a)), 1.0, atol=1e-6)
    # right-handed: u x v == w
    np.testing.assert_allclose(np.asarray(vm.cross(u, v)), np.asarray(w),
                               atol=1e-6)


def test_onb_local_roundtrip():
    w = vm.unit(jnp.array([[1.0, 2.0, 3.0]]))
    u, v, ww = onb.from_w(w)
    # local (0,0,1) maps to w itself (onb.scm:27-36)
    out = onb.local(u, v, ww, jnp.array([[0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(np.asarray(out), np.asarray(w), atol=1e-6)


def _cam(**kw):
    base = dict(lookfrom=(0.0, 0.0, 2.0), lookat=(0.0, 0.0, 0.0),
                vfov=90.0, aspect=1.0, aperture=0.0, focus_dist=2.0)
    base.update(kw)
    return cam_mod.make_camera(**base)


def test_center_ray_points_at_lookat(key):
    cam = _cam()
    o, d, t = cam_mod.get_rays(cam, jnp.array([0.5]), jnp.array([0.5]), key)
    np.testing.assert_allclose(np.asarray(o[0]), [0.0, 0.0, 2.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(d[0]), [0.0, 0.0, -1.0], atol=1e-6)


def test_dirs_are_unit(key):
    # Convention change vs camera.scm:85-92 (documented): dirs normalized.
    cam = _cam(vfov=40.0, aspect=2.0)
    s = jax.random.uniform(jax.random.key(1), (64,))
    t = jax.random.uniform(jax.random.key(2), (64,))
    _, d, _ = cam_mod.get_rays(cam, s, t, key)
    np.testing.assert_allclose(np.asarray(vm.length(d)), 1.0, atol=1e-6)


def test_vfov_vertical_extent(key):
    # vfov=90, focus 2: top edge of the image plane sits at y = focus_dist,
    # so the (0.5, 1.0) corner ray has slope dy/|dz| = tan(45 deg) = 1.
    cam = _cam()
    _, d, _ = cam_mod.get_rays(cam, jnp.array([0.5]), jnp.array([1.0]), key)
    slope = float(d[0, 1] / -d[0, 2])
    np.testing.assert_allclose(slope, 1.0, rtol=1e-5)


def test_aspect_scales_horizontal(key):
    # half-width = aspect * half-height (camera.scm:70-71)
    cam = _cam(aspect=2.0)
    _, d, _ = cam_mod.get_rays(cam, jnp.array([1.0]), jnp.array([0.5]), key)
    slope = float(d[0, 0] / -d[0, 2])
    np.testing.assert_allclose(slope, 2.0, rtol=1e-5)


def test_aperture_spreads_origins(key):
    cam = _cam(aperture=1.0)
    s = jnp.full((256,), 0.5)
    o, d, _ = cam_mod.get_rays(cam, s, s, key)
    r = np.asarray(vm.length(o - jnp.array([0.0, 0.0, 2.0])))
    assert r.max() <= 0.5 + 1e-6          # lens radius = aperture/2
    assert r.max() > 0.2                   # actually spread out
    # all rays still converge at the focal point (0,0,0)
    hit = o + d * (vm.length(o - 0.0) / vm.length(d))[:, None]
    # rays through a thin lens focus on the plane at focus_dist:
    tt = (o[:, 2] - 0.0) / -d[:, 2]       # t where z=0
    p = o + d * tt[:, None]
    np.testing.assert_allclose(np.asarray(p[:, :2]), 0.0, atol=1e-5)


def test_time_sampling_range(key):
    cam = _cam(time0=1.0, time1=3.0)
    s = jnp.full((512,), 0.5)
    _, _, t = cam_mod.get_rays(cam, s, s, key)
    assert float(jnp.min(t)) >= 1.0 and float(jnp.max(t)) <= 3.0
    np.testing.assert_allclose(float(jnp.mean(t)), 2.0, atol=0.1)
