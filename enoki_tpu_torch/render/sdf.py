"""Differentiable SDF sphere-marching (counterpart of
enoki_tpu/render/sdf.py).

Plain PyTorch, eager. This module is the CPU oracle of the port and, on
the card, the baseline the hand-written kernels of ``sdf_kernels`` are
timed against:

  * ``march``: the masked fixed-step loop -- converged or escaped lanes
    freeze, every lane runs all ``n_steps``;
  * ``march_implicit``: the same forward, with an implicit-function
    backward (``implicit_t_vjp``) instead of reversing the loop;
  * ``normal_at``: the SDF gradient taken by autograd, not written in
    closed form, so that this path stays an independent oracle for the
    hand-derived backward kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from .implicit import implicit_t_vjp
from .sphere import (Ray, _reference_leaves, make_rays, pixel_grid,
                     scene_from_leaves, scene_leaves)
from .vec import Vec3, dot3, normalize3
from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class SDFScene:
    """Sphere SDF + shading parameters (all differentiable)."""

    center: Vec3
    radius: torch.Tensor
    ambient: torch.Tensor
    gain: torch.Tensor
    light: Vec3

    @staticmethod
    def reference(device=None) -> "SDFScene":
        """Unit sphere at the origin, ambient 0.2, gain 90, light
        (-1, -1, 2)."""
        return SDFScene(**_reference_leaves(resolve_device(device)))


def sdf(p: Vec3, scene: SDFScene):
    """Signed distance to the sphere."""
    d = p - scene.center
    return torch.sqrt(dot3(d, d) + 1e-12) - scene.radius


def sdf_ortho_parts(px, py, scene: SDFScene):
    """Loop-invariant pieces of ``sdf`` along the orthographic ray
    p = (px, py, -1 + t): (rxy2, z0, radius) with
    sdf(ray(t)) = sqrt(rxy2 + (z0 + t)^2) - radius."""
    dx = px - scene.center.x
    dy = py - scene.center.y
    rxy2 = dx * dx + dy * dy + 1e-12
    z0 = -1.0 - scene.center.z
    return rxy2, z0, scene.radius


def sdf_ortho_dist(px, py, scene: SDFScene):
    """``sdf(Vec3(px, py, -1 + t), scene)`` as a function of t, with the
    xy part computed once (only the addition order differs, ~1 ulp)."""
    rxy2, z0, rad = sdf_ortho_parts(px, py, scene)
    return lambda t: torch.sqrt(rxy2 + (z0 + t) * (z0 + t)) - rad


def march(ray: Ray, scene: SDFScene, n_steps: int = 64,
          eps: float = 1e-4, t_max: float = 10.0):
    """Sphere-trace with a per-lane active mask: returns (t, hit).
    Converged or escaped lanes stop advancing; every lane runs
    ``n_steps`` masked steps. Differentiable through the loop."""
    t = torch.zeros_like(ray.o.x)
    active = torch.ones_like(t, dtype=torch.bool)
    hit = torch.zeros_like(active)
    for _ in range(n_steps):
        d = sdf(ray.at(t), scene)
        converged = d < eps
        hit = hit | (active & converged)
        t_new = t + d
        escaped = t_new > t_max
        active = active & ~converged & ~escaped
        t = torch.where(active, t_new, t)
    return t, hit


def _ray_scene(leaves):
    """(ray, scene) from the 15 tensors o.xyz, d.xyz, scene leaves."""
    ray = Ray(o=Vec3(*leaves[0:3]), d=Vec3(*leaves[3:6]))
    return ray, scene_from_leaves(leaves[6:15], SDFScene)


class _MarchImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_steps, eps, t_max, *leaves):
        t, hit = march(*_ray_scene(leaves), n_steps, eps, t_max)
        ctx.save_for_backward(t, hit, *leaves)
        ctx.mark_non_differentiable(hit)
        return t, hit

    @staticmethod
    def backward(ctx, t_bar, _hit_bar):
        t, hit, *leaves = ctx.saved_tensors

        def f(a, tv):
            ray, scene = _ray_scene(a)
            return sdf(ray.at(tv), scene)

        return (None, None, None,
                *implicit_t_vjp(f, leaves, t, t_bar, hit))


def march_implicit(ray: Ray, scene: SDFScene, n_steps: int = 64,
                   eps: float = 1e-4, t_max: float = 10.0):
    """``march`` with an implicit-function-theorem backward: at a hit,
    dt*/dtheta = -(d sdf/d theta) / (d sdf/d t). Miss lanes get zero."""
    leaves = (ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z,
              *scene_leaves(scene))
    return _MarchImplicit.apply(n_steps, eps, t_max, *leaves)


def normal_at(p: Vec3, scene: SDFScene) -> Vec3:
    """SDF normal: grad_p sdf(p) by autograd (create_graph, so that it
    stays differentiable in the scene and in p), normalized."""
    with torch.enable_grad():
        xs = [c if c.requires_grad else c.detach().requires_grad_(True)
              for c in (p.x, p.y, p.z)]
        s = sdf(Vec3(*xs), scene)
        g = torch.autograd.grad(s.sum(), xs, create_graph=True)
    return normalize3(Vec3(*g))


def _shade_at(ray, scene, t, hit):
    n = normal_at(ray.at(t), scene)
    lam = dot3(n, scene.light)
    lambert = torch.maximum(lam, torch.zeros_like(lam))
    img = scene.ambient + lambert * scene.gain
    return torch.where(hit, img, scene.ambient * torch.ones_like(img))


def shade(ray: Ray, scene: SDFScene, n_steps: int = 64):
    """march -> normal -> directional shade; miss -> ambient."""
    t, hit = march(ray, scene, n_steps)
    return _shade_at(ray, scene, t, hit)


def render_sdf(scene: SDFScene, n: int = 512, n_steps: int = 64):
    """Flat (n*n,) image, differentiable through the march loop."""
    rays = make_rays(pixel_grid(n, device=scene.radius.device))
    return shade(rays, scene, n_steps)


def shade_implicit(ray: Ray, scene: SDFScene, n_steps: int = 64):
    """Same image as ``shade``; the march differentiates implicitly."""
    t, hit = march_implicit(ray, scene, n_steps)
    return _shade_at(ray, scene, t, hit)


def render_sdf_implicit(scene: SDFScene, n: int = 512, n_steps: int = 64):
    rays = make_rays(pixel_grid(n, device=scene.radius.device))
    return shade_implicit(rays, scene, n_steps)


def sdf_loss_implicit(scene: SDFScene, n: int = 256, n_steps: int = 64):
    return torch.mean(render_sdf_implicit(scene, n, n_steps))


def render_sdf_grads_implicit(scene: SDFScene, n: int = 256,
                              n_steps: int = 64):
    """Image and d mean(image) / d scene (an SDFScene of gradients)."""
    leaves = [x.detach().requires_grad_(True) for x in scene_leaves(scene)]
    with torch.enable_grad():
        img = render_sdf_implicit(scene_from_leaves(leaves, SDFScene), n,
                                  n_steps)
        grads = torch.autograd.grad(torch.mean(img), leaves)
    return img.detach(), scene_from_leaves(grads, SDFScene)
