"""SDF primitive and combinator library (counterpart of
enoki_tpu/render/sdflib.py): the classic Hart/Quilez distance functions,
same names and formulas.

Every function works on whatever its ``Vec3`` holds: tensors (the plain
versions and the twin of render/generic.py, and autograd through them, to
second order) or the symbols of ``sdf_trace``, from which the CUDA kernels
of ``make_sdf_renderer`` are generated. What is no Python operator goes
through ``sdf_trace``'s dispatching functions for that reason; a scene
function composed from these needs nothing else.
"""

from __future__ import annotations

from .sdf_trace import abs, clip, maximum, minimum, sqrt  # noqa: A004
from .vec import Vec3, dot3

_EPS = 1e-12


def sd_sphere(p: Vec3, center: Vec3, radius):
    d = p - center
    return sqrt(dot3(d, d) + _EPS) - radius


def sd_plane(p: Vec3, normal: Vec3, offset):
    """Half-space below the (unit) normal at signed offset."""
    return dot3(p, normal) + offset


def sd_box(p: Vec3, center: Vec3, half_extent: Vec3):
    q = Vec3(abs(p.x - center.x) - half_extent.x,
             abs(p.y - center.y) - half_extent.y,
             abs(p.z - center.z) - half_extent.z)
    outside = Vec3(maximum(q.x, 0.0), maximum(q.y, 0.0), maximum(q.z, 0.0))
    inside = minimum(maximum(q.x, maximum(q.y, q.z)), 0.0)
    return sqrt(dot3(outside, outside) + _EPS) + inside


def sd_torus(p: Vec3, center: Vec3, major, minor):
    """Torus in the xy-plane around ``center``."""
    dx, dy, dz = p.x - center.x, p.y - center.y, p.z - center.z
    ring = sqrt(dx * dx + dy * dy + _EPS) - major
    return sqrt(ring * ring + dz * dz + _EPS) - minor


def sd_capsule(p: Vec3, a: Vec3, b: Vec3, radius):
    pa = p - a
    ba = b - a
    h = clip(dot3(pa, ba) / (dot3(ba, ba) + _EPS), 0.0, 1.0)
    d = pa - ba * h
    return sqrt(dot3(d, d) + _EPS) - radius


# -- combinators -------------------------------------------------------------


def op_union(*ds):
    out = ds[0]
    for d in ds[1:]:
        out = minimum(out, d)
    return out


def op_intersect(*ds):
    out = ds[0]
    for d in ds[1:]:
        out = maximum(out, d)
    return out


def op_subtract(d_base, d_cut):
    return maximum(d_base, -d_cut)


def op_smooth_union(d1, d2, k):
    """Polynomial smooth-min blend (differentiable union; gradients flow
    into both operands and the blend k)."""
    h = clip(0.5 + 0.5 * (d2 - d1) / (k + _EPS), 0.0, 1.0)
    return d2 + (d1 - d2) * h - k * h * (1.0 - h)


def op_round(d, r):
    return d - r


def op_shell(d, thickness):
    return abs(d) - thickness
