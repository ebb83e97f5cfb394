"""points.py CSV -> Bezier-chain pipeline (points.scm:10-52; VERDICT r1
item 8 — the round-1 module had zero tests and zero callers)."""

import numpy as np
import pytest

import jax.numpy as jnp

from scheme_raytrace import points as pts
from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.ops import bezier as bz
from scheme_raytrace.scene import compile_scene, objects as ob


def test_load_points_csv(tmp_path):
    p = tmp_path / "pts.csv"
    p.write_text("0,0,0\n1,2,3\n\n-1.5,0.25,4\n")
    got = pts.load_points(str(p), scale=2.0)
    np.testing.assert_allclose(
        got, 2.0 * np.array([[0, 0, 0], [1, 2, 3], [-1.5, 0.25, 4.0]]))


def test_load_points_malformed_line_raises(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("0,0,0\n1,2\n")
    with pytest.raises(ValueError, match="bad.csv:2"):
        pts.load_points(str(p))


def test_calc_bezier_cp_formula():
    # points.scm:23-26: cp1 = p1 + (p2-p0)/6, cp2 = p2 - (p3-p1)/6
    p0, p1, p2, p3 = (np.array([0.0, 0, 0]), np.array([1.0, 0, 0]),
                      np.array([2.0, 1, 0]), np.array([3.0, 3, 0]))
    cp = pts.calc_bezier_cp(p0, p1, p2, p3)
    np.testing.assert_allclose(cp[0], p1)
    np.testing.assert_allclose(cp[1], p1 + (p2 - p0) / 6.0)
    np.testing.assert_allclose(cp[2], p2 - (p3 - p1) / 6.0)
    np.testing.assert_allclose(cp[3], p2)


def test_chain_is_continuous_and_interpolating():
    points = np.array([[0.0, 0, 0], [1.0, 1, 0], [2.0, 0, 0], [3.0, 1, 0],
                       [4.0, 0, 0]])
    cps = pts.points_to_bezier_cps(points)
    assert cps.shape == (4, 4, 3)
    # each segment starts at p_i and ends at p_{i+1} (C0 continuity)
    for i in range(4):
        np.testing.assert_allclose(cps[i, 0], points[i])
        np.testing.assert_allclose(cps[i, 3], points[i + 1])


def test_full_pipeline_objects(tmp_path):
    p = tmp_path / "chain.csv"
    p.write_text("\n".join(f"{x},0,0" for x in range(5)))
    objs = pts.load_bezier_chain(str(p), width=0.2,
                                 material=ob.Lambertian((1, 0, 0)))
    assert len(objs) == 4
    assert all(isinstance(o, ob.Bezier) and o.width == 0.2 for o in objs)


def test_chain_rays_hit_the_curve():
    # a straight-line chain along x: rays aimed at it must hit
    points = np.stack([np.linspace(-1, 1, 5), np.zeros(5),
                       np.full(5, -2.0)], axis=1)
    objs = pts.bezier_objs(pts.points_to_bezier_cps(points), 0.3,
                           ob.Lambertian((1, 0, 0)))
    scene = compile_scene(objs)
    n = 9
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 1.0
    targets = np.stack([np.linspace(-0.9, 0.9, n), np.zeros(n),
                        np.full(n, -2.0)], axis=1)
    d = (targets - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit, t, *_ = bz.intersect(jnp.asarray(o), jnp.asarray(d.astype(np.float32)),
                              jnp.zeros(n, jnp.float32), scene, 1e-3, 1e9)
    assert np.asarray(hit).all()
    np.testing.assert_allclose(np.asarray(t), 3.0, atol=0.2)


def test_points_chain_scene_renders():
    spec = scenes.points_chain_scene()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cfg = RenderConfig(nx=12, ny=12, spp=1, max_depth=3)
    mean, _ = R.render_image(scene, spec.camera(aspect=1.0), cfg)
    arr = np.asarray(mean)
    assert np.isfinite(arr).all() and arr.max() > 0
