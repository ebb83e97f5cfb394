"""Host-side scene description objects.

These mirror the reference's constructor surface (geometry.scm, material.scm,
texture.scm, bezier.scm) but are inert numpy-backed dataclasses — no closures,
no vtables.  `build.compile_scene` flattens a list of them into the SoA
`Scene` pytree that the integrator consumes (SURVEY.md §2.1: closure
vtables become integer-tagged parameter arrays).

Instancing (translate/rotate-y, geometry.scm:465-543) is *baked* where the
wrapped primitive permits it (spheres/beziers/klein: transform the
parameters) and lowered to a per-primitive rigid transform for rects/boxes/
media, applied to the ray at trace time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

Vec3 = Union[Tuple[float, float, float], Sequence[float], np.ndarray]


def _v(x: Vec3) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


# ---------------------------------------------------------------------------
# Textures (texture.scm)
# ---------------------------------------------------------------------------

class Texture:
    pass


@dataclasses.dataclass(frozen=True)
class ConstantTexture(Texture):
    """texture.scm:12-14."""
    color: Vec3


@dataclasses.dataclass(frozen=True)
class CheckerTexture(Texture):
    """texture.scm:16-23 — sign of sin(10x)sin(10y)sin(10z) picks even/odd.

    Children are restricted to ConstantTexture (the only usage in the
    reference, main.scm:206-209).
    """
    even: ConstantTexture
    odd: ConstantTexture


@dataclasses.dataclass(frozen=True)
class NoiseTexture(Texture):
    """texture.scm:25-28 — gray noise(p*scale); raw range (can be negative),
    reproducing the reference (the feature is dead code there, §6.6)."""
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class MarbleTexture(Texture):
    """texture.scm:30-34 — 0.5*(1+sin(scale*z + 10*turb(p)))."""
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class ImageTexture(Texture):
    """texture.scm:36-50 — clamped nearest-neighbor lookup.

    `data` is an [H, W, 3] uint8/float array (the reference stores a flat
    byte vector + nx/ny; no loader exists there — we accept numpy/PNG-decoded
    arrays directly)."""
    data: np.ndarray

    def __hash__(self):  # numpy payload: identity hash is fine for dedup
        return id(self.data)


def as_texture(t) -> Texture:
    if isinstance(t, Texture):
        return t
    return ConstantTexture(_v(t))


# ---------------------------------------------------------------------------
# Materials (material.scm) — integer type tags at trace time
# ---------------------------------------------------------------------------

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4


class Material:
    pass


@dataclasses.dataclass(frozen=True)
class Lambertian(Material):
    """material.scm:24-39 — ONB cosine-hemisphere scatter."""
    albedo: object  # Texture or color

    def __post_init__(self):
        object.__setattr__(self, "albedo", as_texture(self.albedo))


@dataclasses.dataclass(frozen=True)
class Metal(Material):
    """material.scm:45-57 — fuzzy mirror, full protocol (fixes B3)."""
    albedo: object
    fuzz: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "albedo", as_texture(self.albedo))


@dataclasses.dataclass(frozen=True)
class Dielectric(Material):
    """material.scm:76-101 — Schlick reflect/refract, attenuation (1,1,1)."""
    ref_idx: float


@dataclasses.dataclass(frozen=True)
class DiffuseLight(Material):
    """material.scm:103-111 — emits texture value on the front face only."""
    emit: object

    def __post_init__(self):
        object.__setattr__(self, "emit", as_texture(self.emit))


@dataclasses.dataclass(frozen=True)
class Isotropic(Material):
    """Uniform-sphere phase function — present but commented out in the
    reference (geometry.scm:546); kept as a selectable capability."""
    albedo: object

    def __post_init__(self):
        object.__setattr__(self, "albedo", as_texture(self.albedo))


# ---------------------------------------------------------------------------
# Primitives (geometry.scm, bezier.scm)
# ---------------------------------------------------------------------------

class Hittable:
    pass


@dataclasses.dataclass(frozen=True)
class Sphere(Hittable):
    """geometry.scm:146-175.  Negative radius = hollow-normal trick
    (main.scm:171-172; normal=(p-c)/r flips, geometry.scm:159-160)."""
    center: Vec3
    radius: float
    material: Material


@dataclasses.dataclass(frozen=True)
class MovingSphere(Hittable):
    """geometry.scm:177-215 — center lerped by ray time."""
    center0: Vec3
    center1: Vec3
    time0: float
    time1: float
    radius: float
    material: Material


@dataclasses.dataclass(frozen=True)
class Rect(Hittable):
    """Axis-aligned rect (geometry.scm:376-431).

    axis = index of the normal axis: 0 = yz-rect (x=k), 1 = xz-rect (y=k),
    2 = xy-rect (z=k).  (a0,a1)/(b0,b1) bound the two in-plane axes in
    ascending index order; `flip` = flip-normals wrapper (geometry.scm:433).
    """
    axis: int
    a0: float
    a1: float
    b0: float
    b1: float
    k: float
    material: Material
    flip: bool = False


def xy_rect(x0, x1, y0, y1, k, material, flip=False) -> Rect:
    return Rect(2, x0, x1, y0, y1, k, material, flip)


def xz_rect(x0, x1, z0, z1, k, material, flip=False) -> Rect:
    return Rect(1, x0, x1, z0, z1, k, material, flip)


def yz_rect(y0, y1, z0, z1, k, material, flip=False) -> Rect:
    return Rect(0, y0, y1, z0, z1, k, material, flip)


@dataclasses.dataclass(frozen=True)
class Box(Hittable):
    """geometry.scm:444-463 — 6 rects; compile decomposes it."""
    pmin: Vec3
    pmax: Vec3
    material: Material


@dataclasses.dataclass(frozen=True)
class FlipNormals(Hittable):
    """geometry.scm:433-442."""
    obj: Hittable


@dataclasses.dataclass(frozen=True)
class Translate(Hittable):
    """geometry.scm:465-481 — ray-space offset instancing."""
    obj: Hittable
    offset: Vec3


@dataclasses.dataclass(frozen=True)
class RotateY(Hittable):
    """geometry.scm:483-543 — rotate about +y by `angle` degrees.
    The reference's rotated-AABB min-update bug (B2) is irrelevant here:
    AABBs are recomputed exactly at compile."""
    obj: Hittable
    angle: float


@dataclasses.dataclass(frozen=True)
class ConstantMedium(Hittable):
    """geometry.scm:545-578 — homogeneous volume in a convex boundary.

    The reference's phase function is (canonically-for-this-repo, wrongly)
    lambertian (geometry.scm:546, isotropic commented out); `phase`
    selects which; default reproduces the reference.
    """
    boundary: Hittable          # Box (optionally wrapped in instancing) or Sphere
    density: float
    albedo: object              # texture/color for the phase function
    phase: str = "lambertian"   # "lambertian" (ref) | "isotropic"

    def __post_init__(self):
        object.__setattr__(self, "albedo", as_texture(self.albedo))


@dataclasses.dataclass(frozen=True)
class Bezier(Hittable):
    """bezier.scm:61-223 — cubic Bezier curve with circular cross-section
    width `width` (hit = curve point within width/2 of the ray; normal is
    the camera-facing -dir convention, B11)."""
    cp: np.ndarray              # [4,3] control points
    width: float
    material: Material

    def __hash__(self):
        return id(self.cp)


@dataclasses.dataclass(frozen=True)
class Klein(Hittable):
    """geometry.scm:644-661 — sphere-traced Kleinian limit-set SDF."""
    center: Vec3
    material: Material


# ---------------------------------------------------------------------------
# Host-side instancing resolution
# ---------------------------------------------------------------------------

def _rot_y(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    # object->world rotation about +y (geometry.scm:487-489 sign convention:
    # hit point is rotated by +angle back to world)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclasses.dataclass(frozen=True)
class Xform:
    """Rigid object->world transform: x_w = R @ x_o + t."""
    rot: np.ndarray
    trans: np.ndarray

    @staticmethod
    def identity() -> "Xform":
        return Xform(np.eye(3), np.zeros(3))

    def compose_outer(self, outer: "Xform") -> "Xform":
        """outer ∘ self (outer applied after self)."""
        return Xform(outer.rot @ self.rot, outer.rot @ self.trans + outer.trans)


def unwrap(obj: Hittable):
    """Peel FlipNormals/Translate/RotateY wrappers.

    Returns (core, xform, flip).  Matches the reference's composition
    semantics: translate offsets the ray (geometry.scm:470), rotate-y
    rotates it (geometry.scm:492-507); composing wrappers composes the
    rigid motions.
    """
    xf = Xform.identity()
    flip = False
    while True:
        if isinstance(obj, FlipNormals):
            flip = not flip
            obj = obj.obj
        elif isinstance(obj, Translate):
            # accumulated xf is OUTER relative to this newly peeled wrapper
            xf = Xform(np.eye(3), _v(obj.offset)).compose_outer(xf)
            obj = obj.obj
        elif isinstance(obj, RotateY):
            xf = Xform(_rot_y(obj.angle), np.zeros(3)).compose_outer(xf)
            obj = obj.obj
        else:
            return obj, xf, flip
