"""scheme_raytrace — a differentiable path tracer in JAX.

A brand-new JAX/XLA/Pallas framework reproducing the capabilities of
soma-arc/scheme-raytrace (Shirley "Ray Tracing in One Weekend" series plus
ray-traced Bezier curve primitives, SAH BVH, and a Kleinian limit-set SDF
fractal) as an array program:

- struct-of-arrays scene representation (no closures / vtables; integer
  material + texture ids dispatched with masked selects),
- wavefront path tracing over batched ray pools (`lax.while_loop` fast path,
  fixed-length `lax.scan` differentiable path),
- brute-force masked intersection sweeps, fused into one Pallas kernel per
  bounce on a GPU, with a flat-array BVH as an alternative traversal,
- ray/pixel sharding over `jax.sharding.Mesh` with replicated scene
  parameters and `psum` gradient all-reduce,
- differentiable w.r.t. sphere centers/radii, Bezier control points,
  albedo, and camera pose.

See SURVEY.md for the structural analysis of the reference this framework
re-implements (a redesign, not a port).
"""

__version__ = "0.1.0"

from .config import RenderConfig  # noqa: F401
