"""Differentiable sphere ray tracer (counterpart of
enoki_tpu/render/sphere.py): the reference mini-app tests/sphere.cpp with
differentiable scene parameters, in plain eager PyTorch.

  make_rays       sensor: one ray per pixel, o=(px,py,-1), d=(0,0,1)
  intersect_rays  quadratic solve against the sphere; miss lanes -> 0
  shade_hits      directional shade ambient + max(dot(n, L), 0) * gain
  combined        all three in one function
  pixel_grid      linspace(-extent, extent, n) meshgrid, x fastest
  render_fused / render_staged, image_loss, render_and_grads
  numpy_reference an independent float64 numpy render

This module is the CPU oracle of the port's sphere kernels
(``sphere_kernels``) and, on the card, the path they are timed against.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..ops.router import linspace, meshgrid, safe_sqrt
from .vec import Vec2, Vec3, dot3


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


def scene_leaves(scene):
    """The 9 parameters of a SphereScene or SDFScene in the flat-vector
    order [cx, cy, cz, radius, ambient, gain, lx, ly, lz]."""
    return (scene.center.x, scene.center.y, scene.center.z, scene.radius,
            scene.ambient, scene.gain, scene.light.x, scene.light.y,
            scene.light.z)


def scene_from_leaves(p, cls=SphereScene):
    """Inverse of ``scene_leaves``: a ``cls`` of the 9 values."""
    return cls(center=Vec3(p[0], p[1], p[2]), radius=p[3], ambient=p[4],
               gain=p[5], light=Vec3(p[6], p[7], p[8]))


def make_rays(p: Vec2) -> Ray:
    one = torch.ones_like(p.x)
    zero = torch.zeros_like(p.x)
    return Ray(o=Vec3(p.x, p.y, -one), d=Vec3(zero, zero, one))


def intersect_rays(r: Ray, scene: SphereScene) -> Vec3:
    """The hit point relative to the center (the normal scaled by the
    radius); miss lanes are 0.

    The reference's order and dtype policy: elementwise products and sums
    in the caller's dtype; discrim, the sqrt, the divide and the hit mask
    in f32, t cast back. The quadratic is not simplified (a = |d|^2 is 1,
    but rewriting it moves silhouette pixels).
    """
    oc = r.o - scene.center
    a = dot3(r.d, r.d)
    b = 2.0 * dot3(oc, r.d)
    c = dot3(oc, oc) - scene.radius * scene.radius
    discrim = b * b - 4.0 * a * c
    d32 = discrim.to(torch.float32)
    t = ((-b.to(torch.float32) + safe_sqrt(d32))
         / (2.0 * a.to(torch.float32))).to(discrim.dtype)
    hit_p = r.at(t) - scene.center
    valid = d32 >= 0.0
    zero = torch.zeros_like(t)
    return Vec3(torch.where(valid, hit_p.x, zero),
                torch.where(valid, hit_p.y, zero),
                torch.where(valid, hit_p.z, zero))


def shade_hits(n: Vec3, scene: SphereScene):
    """ambient + max(dot(n, light), 0) * gain; ``torch.maximum`` splits
    the gradient of a tie 0.5/0.5, as ``jnp.maximum`` does."""
    lam = dot3(n, scene.light)
    return scene.ambient + torch.maximum(lam, torch.zeros_like(lam)) \
        * scene.gain


def combined(p: Vec2, scene: SphereScene):
    """make_rays -> intersect_rays -> shade_hits."""
    return shade_hits(intersect_rays(make_rays(p), scene), scene)


def pixel_grid(n: int, extent: float = 1.2, dtype=torch.float32,
               device=None) -> Vec2:
    """linspace + meshgrid pixel grid; each component has n*n entries."""
    idx = linspace(-extent, extent, n, dtype=dtype, device=device)
    xs, ys = meshgrid(idx, idx)
    return Vec2(xs, ys)


def _grid_for(scene, n):
    return pixel_grid(n, device=scene.radius.device)


def render_fused(scene: SphereScene, n: int = 1024):
    """The (n*n,) image of ``combined`` on the linspace grid."""
    return combined(_grid_for(scene, n), scene)


def render_staged(scene: SphereScene, n: int = 1024):
    """The same image in three stages: rays, hits, shade. Eager PyTorch
    materialises every intermediate in device memory anyway, so this is
    the reference's "separate kernels" contrast without its barriers."""
    rays = make_rays(_grid_for(scene, n))
    hits = intersect_rays(rays, scene)
    return shade_hits(hits, scene)


def image_loss(scene: SphereScene, n: int = 512):
    """Mean intensity: a scalar to differentiate end to end."""
    return torch.mean(combined(_grid_for(scene, n), scene))


def render_and_grads(scene: SphereScene, n: int = 512):
    """The image and d image_loss / d scene (a SphereScene of gradients),
    by autograd through ``combined``."""
    leaves = [x.detach().requires_grad_(True) for x in scene_leaves(scene)]
    with torch.enable_grad():
        s = scene_from_leaves(leaves, type(scene))
        img = combined(_grid_for(s, n), s)
        grads = torch.autograd.grad(torch.mean(img), leaves)
    return img.detach(), scene_from_leaves(grads, type(scene))


def numpy_reference(n: int = 1024, extent: float = 1.2):
    """Independent numpy implementation of tests/sphere.cpp (float64)."""
    import numpy as np

    idx = np.linspace(-extent, extent, n)
    xs, ys = np.meshgrid(idx, idx, indexing="xy")
    xs, ys = xs.ravel(), ys.ravel()
    ox, oy, oz = xs, ys, np.full_like(xs, -1.0)
    dx, dy, dz = 0.0, 0.0, 1.0
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ox * dx + oy * dy + oz * dz)
    c = ox * ox + oy * oy + oz * oz - 1.0
    disc = b * b - 4 * a * c
    t = (-b + np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    valid = disc >= 0
    hx, hy, hz = [np.where(valid, v, 0.0) for v in (hx, hy, hz)]
    shade = 0.2 + np.maximum(hx * -1.0 + hy * -1.0 + hz * 2.0, 0.0) * 90.0
    return shade
