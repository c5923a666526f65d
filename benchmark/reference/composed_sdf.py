"""Plain reference of the ``composed_sdf`` configuration: a sphere
smooth-unioned with a torus, over a ground plane (Quilez's sdSphere,
sdTorus, sdPlane and polynomial smooth minimum), rendered by sphere
tracing along orthographic rays.

The scene vector is [ambient, gain, lx, ly, lz, cx, cy, cz, radius,
torus major, torus minor, plane offset] (12 floats). A ray leaves
(px, py, -1) along +z and is at p = (px, py, -1 + t). The distance is

    sphere = |p - c| - radius
    torus  = |(|(px, py)| - major, pz - 1)| - minor    (centre (0, 0, 1))
    plane  = -py + offset                              (normal (0, -1, 0))
    h      = clip(0.5 + 0.5 (torus - sphere) / k, 0, 1),  k = 0.1
    blend  = torus + (sphere - torus) h - k h (1 - h)
    d      = min(blend, plane)

with 1e-12 under every root. A lane advances by d while d is at least eps
and t + d stays within t_max, and never at the last of ``n_steps``
steps; it hits where the final distance is below eps. The shade is
ambient + gain * max(n . l / |n|, 0), n the gradient of d at the hit
point; a miss shades to the ambient.
"""

from __future__ import annotations

import torch

from .common import T_MAX, march_eps

N_PARAMS = 12
K_BLEND = 0.1
_EPS = 1e-12


def distance(x, y, z, pv):
    """d at the points (x, y, z), in their dtype."""
    dx, dy, dz = x - pv[5], y - pv[6], z - pv[7]
    sphere = torch.sqrt(dx * dx + dy * dy + dz * dz + _EPS) - pv[8]
    ring = torch.sqrt(x * x + y * y + _EPS) - pv[9]
    tz = z - 1.0
    torus = torch.sqrt(ring * ring + tz * tz + _EPS) - pv[10]
    plane = -y + pv[11]
    h = torch.clamp(0.5 + 0.5 * (torus - sphere) / (K_BLEND + _EPS),
                    0.0, 1.0)
    blend = torus + (sphere - torus) * h - K_BLEND * h * (1.0 - h)
    return torch.minimum(blend, plane)


def march(px, py, pv, n_steps: int, dtype=torch.float32):
    p = pv.to(dtype)
    x, y = px.to(dtype), py.to(dtype)
    eps = torch.tensor(march_eps(dtype), dtype=dtype, device=x.device)
    t_max = torch.tensor(T_MAX, dtype=dtype, device=x.device)
    t = torch.zeros_like(x)
    adv = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for _ in range(n_steps - 1):
        d = distance(x, y, -1.0 + t, p)
        alive = (d >= eps) & (t + d <= t_max)
        t = torch.where(alive, t + d, t)
        adv += alive
    hit = distance(x, y, -1.0 + t, p) < eps
    return t.float(), hit, adv


def residual(px, py, t, pv):
    return distance(px, py, -1.0 + t, pv)


def shade(px, py, t, hit, pv, create_graph=False):
    with torch.enable_grad():
        xs = [px.clone().requires_grad_(True), py.clone().requires_grad_(True),
              (-1.0 + t) if t.requires_grad
              else (-1.0 + t).requires_grad_(True)]
        d = distance(*xs, pv)
        nx, ny, nz = torch.autograd.grad(d.sum(), xs,
                                         create_graph=create_graph)
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-12)
    lam = (nx * pv[2] + ny * pv[3] + nz * pv[4]) * inv
    img = pv[0] + torch.maximum(lam, torch.zeros_like(lam)) * pv[1]
    return torch.where(hit, img, pv[0] + torch.zeros_like(img))
