"""Plain reference of the ``sphere_sdf`` configuration: the sphere of
upstream Enoki's ``tests/sphere.cpp``, made differentiable, rendered by
sphere tracing along orthographic rays.

The scene vector is [cx, cy, cz, radius, ambient, gain, lx, ly, lz, 0 x 7]
(16 floats). A ray leaves (px, py, -1) along +z; at parameter t it is at
z = -1 + t. The march carries z itself: the distance at z is
|(px - cx, py - cy, z - cz)| - radius, written sqrt(r2 + u^2) - radius
with r2 the squared distance across the ray (plus 1e-12) and u = z - cz,
evaluated as x * rsqrt(x). A lane advances by the distance while the
distance is at least eps and the ray has not passed t_max, and never at
the last of ``n_steps`` steps; it hits where the final distance is below
eps. The shade is ambient + gain * max(n . l / |n|, 0) with n the unit
vector from the centre to the hit point; a miss shades to the ambient.
"""

from __future__ import annotations

import torch

from .common import T_MAX, march_eps

N_PARAMS = 16


def _c(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _across(px, py, pv, dtype):
    """(r2, u0, radius) in ``dtype``: the squared distance across the ray,
    the ray's start z - cz, and the radius."""
    p = pv.to(dtype)
    dx = px.to(dtype) - p[0]
    dy = py.to(dtype) - p[1]
    r2 = dx * dx + dy * dy + _c(1e-12, dx)
    return r2, _c(-1.0, dx) - p[2], p[3]


def _length(r2, u):
    x = r2 + u * u
    return x * torch.rsqrt(x)


def march(px, py, pv, n_steps: int, dtype=torch.float32):
    r2, u0, rad = _across(px, py, pv, dtype)
    eps = _c(march_eps(dtype), r2)
    reach = rad + eps
    escape = _c(T_MAX, r2) + u0 + rad
    u = u0 + torch.zeros_like(r2)
    adv = torch.zeros(r2.shape, dtype=torch.int32, device=r2.device)
    for _ in range(n_steps - 1):
        s = _length(r2, u)
        alive = (s >= reach) & (u + s <= escape)
        u = torch.where(alive, u + (s - rad), u)
        adv += alive
    hit = (_length(r2, u) - rad) < eps
    return (u - u0).float(), hit, adv


def residual(px, py, t, pv):
    r2, u0, rad = _across(px, py, pv, torch.float32)
    return _length(r2, u0 + t) - rad


def shade(px, py, t, hit, pv, create_graph=False):
    amb, gain = pv[4], pv[5]
    dx = px - pv[0]
    dy = py - pv[1]
    dz = (-1.0 + t) - pv[2]
    q = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    nx, ny, nz = dx * q, dy * q, dz * q
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-12)
    lam = torch.clamp_min((nx * pv[6] + ny * pv[7] + nz * pv[8]) * inv, 0.0)
    return torch.where(hit, amb + lam * gain, amb + torch.zeros_like(lam))
