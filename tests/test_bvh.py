"""BVH tests (geometry.scm:217-260 median, :282-374 SAH).

The reference validates its BVHs by "same image, less time" A/B scenes
(main.scm:204-235, SURVEY §4 item 3); here that becomes exact assertions:
builder structural invariants, traversal equality vs the brute-force sweep
on random rays, a hand-built-tree traversal-order unit test, and full-image
equality on the 100-sphere grid scene both ways.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scheme_raytrace import render as R
from scheme_raytrace import scenes
from scheme_raytrace.config import RenderConfig
from scheme_raytrace.ops import sphere as sph_ops
from scheme_raytrace.scene import bvh as bvh_mod
from scheme_raytrace.scene import compile_scene


def _random_boxes(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3))
    r = rng.uniform(0.1, 0.5, n)
    return bvh_mod.sphere_bounds(c, c, r)


@pytest.mark.parametrize("builder", ["median", "sah"])
@pytest.mark.parametrize("n", [1, 2, 5, 37, 100])
def test_builder_structural_invariants(builder, n):
    pmin, pmax = _random_boxes(n)
    flat = (bvh_mod.build_sah(pmin, pmax) if builder == "sah"
            else bvh_mod.build_median(pmin, pmax))
    m = flat.n_nodes
    # links stay in range; -1 is the done sentinel
    assert ((flat.hit_link >= -1) & (flat.hit_link < m)).all()
    assert ((flat.miss_link >= -1) & (flat.miss_link < m)).all()
    # every primitive appears in exactly one leaf slot
    prims = flat.prims[flat.prims >= 0]
    assert sorted(prims.tolist()) == list(range(n))
    # node AABBs contain their leaf prims
    for i in range(m):
        ids = flat.prims[i][flat.prims[i] >= 0]
        if len(ids):
            assert (flat.pmin[i][None] <= pmin[ids] + 1e-12).all()
            assert (flat.pmax[i][None] >= pmax[ids] - 1e-12).all()


def test_flatten_threading_hand_built():
    """Preorder hit/miss threading on a known 3-leaf tree.

    Two far-apart clusters force the first split between them; the layout
    must be root -> left subtree -> right subtree with miss links escaping
    to the next right sibling (scene/bvh.py _flatten contract).
    """
    c = np.array([[0.0, 0, 0], [1.0, 0, 0], [100.0, 0, 0], [101.0, 0, 0],
                  [102.0, 0, 0], [103.0, 0, 0], [104.0, 0, 0], [105.0, 0, 0],
                  [106.0, 0, 0], [107.0, 0, 0]])
    r = np.full(10, 0.4)
    pmin, pmax = bvh_mod.sphere_bounds(c, c, r)
    flat = bvh_mod.build_sah(pmin, pmax)
    # root is node 0 and a hit enters its first child (node 1)
    assert flat.prims[0].max() < 0 or flat.n_nodes == 1
    if flat.n_nodes > 1:
        assert flat.hit_link[0] == 1
        assert flat.miss_link[0] == -1          # missing the root ends it
        # every inner node's hit_link is the immediately following node
        for i in range(flat.n_nodes):
            if (flat.prims[i] < 0).all():       # inner
                assert flat.hit_link[i] == i + 1


@pytest.mark.parametrize("builder", ["median", "sah"])
def test_traversal_matches_brute_force(builder):
    spec = scenes.test_scene_grid()
    scene = compile_scene(spec.objects, sky=spec.sky, bvh=builder)
    assert scene.has_bvh
    rng = np.random.default_rng(1)
    n = 512
    o = jnp.asarray(rng.uniform(-3, 12, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    t = jnp.zeros(n, jnp.float32)
    brute = jax.jit(functools.partial(sph_ops.intersect,
                                      t_min=0.001, t_max=1e9))(o, d, t, scene)
    bvh = jax.jit(functools.partial(sph_ops.intersect_bvh,
                                    t_min=0.001, t_max=1e9))(o, d, t, scene)
    np.testing.assert_array_equal(np.asarray(brute[0]), np.asarray(bvh[0]))
    np.testing.assert_allclose(np.asarray(brute[1]), np.asarray(bvh[1]),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(brute[3]), np.asarray(bvh[3]))


def test_grid_scene_image_identical_brute_vs_bvh():
    """main.scm:204-235 non-bvh/bvh/bvh-sah triple: same image all three
    ways.  The two BVH variants must be IDENTICAL to each other (both run
    the general pool); the brute render now routes through the FUSED pool
    (>64-prim loop sweep), whose f32 op ordering differs slightly from the
    general pool's, so brute-vs-bvh is compared statistically (same
    estimator, same RNG; at most rare branch-flip pixels)."""
    spec = scenes.test_scene_grid()
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=16, ny=16, spp=1, max_depth=4)
    imgs = {}
    for builder, traversal in [(None, "brute"), ("median", "bvh"),
                               ("sah", "bvh")]:
        scene = compile_scene(spec.objects, sky=spec.sky, bvh=builder)
        mean, _ = R.render_image(scene, cam, cfg.replace(traversal=traversal))
        imgs[builder] = np.asarray(mean)
    assert imgs[None].max() > 0.0
    np.testing.assert_allclose(imgs["median"], imgs["sah"], atol=1e-5)
    diff = np.abs(imgs[None] - imgs["median"])
    assert diff.mean() < 2e-3
    assert (diff.max(axis=-1) > 0.05).mean() < 0.02


def test_bvh_requested_but_absent_falls_back():
    # traversal="bvh" without compiled BVH arrays must brute-force, not crash
    spec = scenes.test_scene_grid()
    scene = compile_scene(spec.objects, sky=spec.sky)    # no bvh built
    assert not scene.has_bvh
    cam = spec.camera(aspect=1.0)
    mean, _ = R.render_image(scene, cam,
                             RenderConfig(nx=8, ny=8, spp=1, max_depth=2,
                                          traversal="bvh"))
    assert np.isfinite(np.asarray(mean)).all()


def test_mixed_scene_image_identical_brute_vs_bvh():
    """One tree over BOTH analytic groups (spheres + rotated rects): the
    BVH-traversed image must equal the brute-sweep image (ops/traverse.py
    vs the per-group sweeps) on a Cornell box with spheres inside."""
    from scheme_raytrace.scene import objects as ob
    spec = scenes.cornell_box()
    objs = list(spec.objects) + [
        ob.Sphere((190, 90, 190), 90, ob.Lambertian((0.7, 0.7, 0.7))),
        ob.Sphere((370, 60, 350), 60, ob.Metal((0.9, 0.8, 0.7), 0.2)),
    ]
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=16, ny=16, spp=1, max_depth=5, light_sampling=True)
    ref = None
    for builder, traversal in [(None, "brute"), ("median", "bvh"),
                               ("sah", "bvh")]:
        scene = compile_scene(objs, sky=spec.sky, bvh=builder)
        if builder is not None:
            assert scene.has_bvh
        mean, _ = R.render_image(scene, cam, cfg.replace(traversal=traversal))
        arr = np.asarray(mean)
        assert np.isfinite(arr).all() and arr.max() > 0
        if ref is None:
            ref = arr                       # brute (fused pool)
        else:
            # bvh variants run the general pool: compare statistically vs
            # the fused brute (identical estimator, f32 reorder only)
            diff = np.abs(arr - ref)
            assert diff.mean() < 2e-3
            assert (diff.max(axis=-1) > 0.05).mean() < 0.02
