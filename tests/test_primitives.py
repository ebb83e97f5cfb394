"""Intersection tests per primitive group against analytic cases
(geometry.scm:146-215 spheres, :376-431 rects, :465-543 instancing,
bezier.scm:61-223, geometry.scm:580-664 klein)."""

import jax
import jax.numpy as jnp
import numpy as np

from scheme_raytrace import config as cfg
from scheme_raytrace.core import vecmath as vm
from scheme_raytrace.ops import sphere, rect, bezier, klein, aabb
from scheme_raytrace.scene import compile_scene
from scheme_raytrace.scene import objects as ob

MAT = ob.Lambertian((0.5, 0.5, 0.5))


def rays(*od_pairs):
    o = jnp.array([p[0] for p in od_pairs], jnp.float32)
    d = vm.unit(jnp.array([p[1] for p in od_pairs], jnp.float32))
    t = jnp.zeros(o.shape[0], jnp.float32)
    return o, d, t


# ---------------------------------------------------------------------------
# spheres (geometry.scm:146-215)
# ---------------------------------------------------------------------------

def test_sphere_hit_t_and_normal():
    sc = compile_scene([ob.Sphere((0, 0, -3), 1.0, MAT)])
    o, d, t = rays(((0, 0, 0), (0, 0, -1)),     # head-on: t = 2
                   ((0, 5, -3), (0, -1, 0)),    # from above: t = 4
                   ((5, 5, 5), (1, 0, 0)))      # miss
    hit, tb, n, mat, u, v = sphere.intersect(o, d, t, sc, 1e-3, 1e9)
    np.testing.assert_array_equal(np.asarray(hit), [True, True, False])
    np.testing.assert_allclose(np.asarray(tb[:2]), [2.0, 4.0], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[1]), [0, 1, 0], atol=1e-5)


def test_sphere_inside_hit_far_root():
    # Origin inside: near root is negative, far root taken (geometry.scm:163-170)
    sc = compile_scene([ob.Sphere((0, 0, 0), 2.0, MAT)])
    o, d, t = rays(((0, 0, 0), (1, 0, 0)))
    hit, tb, n, *_ = sphere.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0])
    np.testing.assert_allclose(float(tb[0]), 2.0, rtol=1e-5)


def test_negative_radius_flips_normal():
    # Hollow-dielectric trick (main.scm:171-172): normal = (p-c)/r
    sc = compile_scene([ob.Sphere((0, 0, -3), -1.0, MAT)])
    o, d, t = rays(((0, 0, 0), (0, 0, -1)))
    hit, tb, n, *_ = sphere.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0])
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-5)


def test_moving_sphere_lerp():
    # geometry.scm:188-193: center(t) = c0 + (t-t0)/(t1-t0) * (c1-c0)
    sc = compile_scene([ob.MovingSphere((0, 0, -3), (2, 0, -3), 0.0, 1.0,
                                        0.5, MAT)])
    o = jnp.zeros((2, 3))
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    time = jnp.array([0.0, 0.5])
    hit, tb, *_ = sphere.intersect(o, d, time, sc, 1e-3, 1e9)
    # at time 0 the sphere is at x=0 (hit); at 0.5 it's at x=1 (miss head-on)
    assert bool(hit[0]) and not bool(hit[1])
    # aim at the time-0.5 position
    d2 = vm.unit(jnp.array([[1.0, 0.0, -3.0]]))
    hit2, *_ = sphere.intersect(o[:1], d2, jnp.array([0.5]), sc, 1e-3, 1e9)
    assert bool(hit2[0])


def test_sphere_uv_poles_and_seam():
    # B1 fixed: canonical Shirley UV on the unit normal
    n = jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]])
    u, v = sphere.sphere_uv(n)
    np.testing.assert_allclose(np.asarray(v), [1.0, 0.0, 0.5], atol=1e-4)
    np.testing.assert_allclose(float(u[2]), 0.5, atol=1e-6)


def test_closest_of_two_spheres():
    sc = compile_scene([ob.Sphere((0, 0, -5), 1.0, MAT),
                        ob.Sphere((0, 0, -10), 1.0, MAT)])
    o, d, t = rays(((0, 0, 0), (0, 0, -1)))
    hit, tb, *_ = sphere.intersect(o, d, t, sc, 1e-3, 1e9)
    np.testing.assert_allclose(float(tb[0]), 4.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# rects + instancing (geometry.scm:376-431, :465-543)
# ---------------------------------------------------------------------------

def test_rect_axes_and_bounds():
    sc = compile_scene([ob.xy_rect(-1, 1, -1, 1, -2, MAT)])
    o, d, t = rays(((0, 0, 0), (0, 0, -1)),        # center hit, t=2
                   ((0.0, 1.5, 0.0), (0, 0, -1)),  # outside bounds
                   ((0, 0, 0), (0, 0, 1)))         # wrong direction
    hit, tb, n, *_ = rect.intersect(o, d, t, sc, 1e-3, 1e9)
    np.testing.assert_array_equal(np.asarray(hit), [True, False, False])
    np.testing.assert_allclose(float(tb[0]), 2.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-6)


def test_rect_uv():
    sc = compile_scene([ob.xz_rect(0, 4, 0, 2, 1, MAT)])
    o, d, t = rays(((1.0, 5.0, 0.5), (0, -1, 0)))
    hit, tb, n, m, u, v = rect.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0])
    np.testing.assert_allclose(float(u[0]), 0.25, rtol=1e-5)
    np.testing.assert_allclose(float(v[0]), 0.25, rtol=1e-5)


def test_flip_normals():
    sc = compile_scene([ob.FlipNormals(ob.xy_rect(-1, 1, -1, 1, -2, MAT))])
    o, d, t = rays(((0, 0, 0), (0, 0, -1)))
    hit, tb, n, *_ = rect.intersect(o, d, t, sc, 1e-3, 1e9)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-6)


def test_translate_rect():
    # geometry.scm:465-481: hit the rect where its translated copy lies
    sc = compile_scene([ob.Translate(ob.xy_rect(-1, 1, -1, 1, 0, MAT),
                                     (5.0, 0.0, -2.0))])
    o, d, t = rays(((5, 0, 0), (0, 0, -1)), ((0, 0, 0), (0, 0, -1)))
    hit, tb, *_ = rect.intersect(o, d, t, sc, 1e-3, 1e9)
    np.testing.assert_array_equal(np.asarray(hit), [True, False])
    np.testing.assert_allclose(float(tb[0]), 2.0, rtol=1e-5)


def test_rotate_y_rect():
    # xy-rect at z=0 rotated 90 deg about +y becomes a yz-rect at x=0:
    # a ray along -x must now hit it; a parallel ray offset to x=0.5 must
    # miss.  (A ray lying exactly IN the rotated plane is measure-zero /
    # undefined — 0/0 in the reference — so it is not asserted here.)
    sc = compile_scene([ob.RotateY(ob.xy_rect(-1, 1, -1, 1, 0, MAT), 90.0)])
    o, d, t = rays(((3, 0, 0), (-1, 0, 0)), ((0.5, 0, 3), (0, 0, -1)))
    hit, tb, n, *_ = rect.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(tb[0]), 3.0, rtol=1e-4)
    np.testing.assert_allclose(abs(float(n[0, 0])), 1.0, atol=1e-5)


def test_box_compiles_to_six_rects():
    sc = compile_scene([ob.Box((0, 0, 0), (1, 1, 1), MAT)])
    assert sc.rect_k.shape[0] == 6
    # ray through the middle hits the near face
    o, d, t = rays(((0.5, 0.5, 5.0), (0, 0, -1)))
    hit, tb, n, *_ = rect.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0])
    np.testing.assert_allclose(float(tb[0]), 4.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-6)


def test_cornell_rotated_box_hit():
    # The cornell tall box (main.scm:349-350) as compiled instancing
    sc = compile_scene([ob.Translate(
        ob.RotateY(ob.Box((0, 0, 0), (165, 330, 165), MAT), 15.0),
        (265, 0, 295))])
    o, d, t = rays(((347.5, 165.0, -800.0), (0, 0, 1)))
    hit, tb, *_ = rect.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0])
    # hit must be in front of the box's z-extent start
    assert 1000.0 < float(tb[0]) < 1300.0


# ---------------------------------------------------------------------------
# aabb slab (geometry.scm:73-136)
# ---------------------------------------------------------------------------

def test_slab_hit_and_interval():
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    pmin = jnp.array([[-1.0, -1.0, -3.0]])
    pmax = jnp.array([[1.0, 1.0, -2.0]])
    assert bool(aabb.slab_hit(o, d, pmin, pmax, 0.0, 100.0)[0])
    assert not bool(aabb.slab_hit(o, d, pmin, pmax, 0.0, 1.0)[0])
    en, ex = aabb.slab_interval(o, d, pmin, pmax)
    np.testing.assert_allclose([float(en[0]), float(ex[0])], [2.0, 3.0],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# bezier ribbons (bezier.scm:61-223)
# ---------------------------------------------------------------------------

def _line_cp(p0, p1):
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    return np.stack([p0, p0 + (p1 - p0) / 3, p0 + 2 * (p1 - p0) / 3, p1])


def test_bezier_eval_endpoints_and_midpoint():
    cp = jnp.asarray(_line_cp((0, 0, 0), (3, 0, 0)))
    for s, want in [(0.0, 0.0), (1.0, 3.0), (0.5, 1.5)]:
        p = bezier.eval_bezier(cp, jnp.asarray(s))
        np.testing.assert_allclose(float(p[0]), want, atol=1e-6)


def test_bezier_tangent():
    cp = jnp.asarray(_line_cp((0, 0, 0), (3, 0, 0)))
    tan = bezier.tangent(cp, jnp.asarray(0.5))
    np.testing.assert_allclose(np.asarray(tan), [3.0, 0.0, 0.0], atol=1e-5)


def test_bezier_straight_segment_hit():
    # Straight "curve" along x at y=0,z=-2, width 0.2: a ray down -z
    # crossing it at x=1 hits at t=2; one passing 0.2 above misses.
    cp = _line_cp((-1, 0, -2), (3, 0, -2))
    sc = compile_scene([ob.Bezier(cp, 0.2, MAT)])
    o, d, t = rays(((1, 0, 0), (0, 0, -1)), ((1, 0.2, 0), (0, 0, -1)))
    hit, tb, n, *_ = bezier.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(tb[0]), 2.0, atol=0.05)
    # B11 convention: normal = -ray.dir
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-6)


def test_bezier_curved_hit_position():
    # Symmetric arch: at s=0.5 the curve passes through y = 0.75
    cp = np.array([[-1.0, 0.0, -2.0], [-0.5, 1.0, -2.0],
                   [0.5, 1.0, -2.0], [1.0, 0.0, -2.0]])
    sc = compile_scene([ob.Bezier(cp, 0.1, MAT)])
    o, d, t = rays(((0.0, 0.75, 0.0), (0, 0, -1)),   # apex: hit
                   ((0.0, 0.0, 0.0), (0, 0, -1)))    # center below arch: miss
    hit, tb, *_ = bezier.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(tb[0]), 2.0, atol=0.06)


def test_bezier_respects_t_range():
    cp = _line_cp((-1, 0, -2), (3, 0, -2))
    sc = compile_scene([ob.Bezier(cp, 0.2, MAT)])
    o, d, t = rays(((1, 0, 0), (0, 0, -1)))
    hit, *_ = bezier.intersect(o, d, t, sc, 1e-3, 1.0)
    assert not bool(hit[0])


# ---------------------------------------------------------------------------
# klein SDF (geometry.scm:580-664)
# ---------------------------------------------------------------------------

def test_klein_de_outside_inversion_spheres():
    # Far from all 6 inversion spheres no inversion fires:
    # DE = 0.7 * (|p - center| - 125)
    center = jnp.zeros(3)
    p = jnp.array([[1000.0, 1000.0, 1000.0]])
    want = 0.7 * (np.linalg.norm([1000.0] * 3) - 125.0)
    np.testing.assert_allclose(float(klein.dist_func(center, p)[0]), want,
                               rtol=1e-4)


def test_klein_march_hits_limit_set():
    # Ground truth from a sequential f64 transcription of the reference's
    # dist-func + marching loop (geometry.scm:602-661): this ray converges
    # onto the limit set at ray-length 81.8068 (the set extends well beyond
    # the |p|=125 ball through the inversions at (0,0,+-424.26)).
    sc = compile_scene([ob.Klein((0, 2, 0), MAT)])
    o = jnp.array([[0.0, 2.0, 400.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    t = jnp.zeros(1)
    hit, tb, n, *_ = klein.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0])
    np.testing.assert_allclose(float(tb[0]), 81.8068, rtol=1e-3)
    np.testing.assert_allclose(float(vm.length(n[0])), 1.0, atol=1e-4)


def test_klein_hits_inversion_cusp_behind():
    # Marching in +z from (0,2,400) also hits the limit set: the cusp near
    # the inversion-sphere center (0,0,424.26), at ray-length 24.2598
    # (sequential-reference oracle). Not a miss — the set is unbounded-ish
    # around the sphere tangency points.
    sc = compile_scene([ob.Klein((0, 2, 0), MAT)])
    o = jnp.array([[0.0, 2.0, 400.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    t = jnp.zeros(1)
    hit, tb, *_ = klein.intersect(o, d, t, sc, 1e-3, 1e9)
    assert bool(hit[0])
    np.testing.assert_allclose(float(tb[0]), 24.2598, rtol=1e-3)


def test_klein_miss_negative_de_runaway():
    # From (0,2,10) toward -z the oracle's march diverges (DE goes negative
    # inside the set's complement pocket) and never satisfies dist<eps with
    # a positive ray length -> miss after 100 steps.
    sc = compile_scene([ob.Klein((0, 2, 0), MAT)])
    o = jnp.array([[0.0, 2.0, 10.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    t = jnp.zeros(1)
    hit, *_ = klein.intersect(o, d, t, sc, 1e-3, 1e9)
    assert not bool(hit[0])
