"""Rays, scene parameters and the pixel grid (counterpart of
enoki_tpu/render/sphere.py, the part the SDF render uses).

  make_rays   sensor: one ray per pixel, o=(px,py,-1), d=(0,0,1)
  pixel_grid  linspace(-extent, extent, n) meshgrid, x fastest

The closed-form sphere render (``intersect_rays``, ``shade_hits``,
``combined``) comes with its kernel pair in a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..ops.router import linspace, meshgrid
from .vec import Vec2, Vec3


@dataclasses.dataclass(frozen=True)
class Ray:
    """Ray bundle: o + t*d."""

    o: Vec3
    d: Vec3

    def at(self, t) -> Vec3:
        return self.o + self.d * t


def _reference_leaves(device):
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return dict(center=Vec3(f(0.0), f(0.0), f(0.0)), radius=f(1.0),
                ambient=f(0.2), gain=f(90.0),
                light=Vec3(f(-1.0), f(-1.0), f(2.0)))


@dataclasses.dataclass(frozen=True)
class SphereScene:
    """Differentiable scene parameters."""

    center: Vec3
    radius: torch.Tensor
    ambient: torch.Tensor
    gain: torch.Tensor
    light: Vec3

    @staticmethod
    def reference(device=None) -> "SphereScene":
        """Unit sphere at the origin, light (-1, -1, 2)."""
        return SphereScene(**_reference_leaves(resolve_device(device)))


def make_rays(p: Vec2) -> Ray:
    one = torch.ones_like(p.x)
    zero = torch.zeros_like(p.x)
    return Ray(o=Vec3(p.x, p.y, -one), d=Vec3(zero, zero, one))


def pixel_grid(n: int, extent: float = 1.2, dtype=torch.float32,
               device=None) -> Vec2:
    """linspace + meshgrid pixel grid; each component has n*n entries."""
    idx = linspace(-extent, extent, n, dtype=dtype, device=device)
    xs, ys = meshgrid(idx, idx)
    return Vec2(xs, ys)
