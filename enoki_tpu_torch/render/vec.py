"""SoA 2/3-vectors for the render pipeline (counterpart of
enoki_tpu/render/vec.py).

Each component is a full tensor, so every vector op is elementwise. Eager
torch only: the lazy ``LazyArray`` dispatch of the reference waits for the
port of ``trace/``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Vec2:
    x: torch.Tensor
    y: torch.Tensor

    def __add__(self, o):
        return Vec2(self.x + o.x, self.y + o.y)

    def __sub__(self, o):
        return Vec2(self.x - o.x, self.y - o.y)

    def __mul__(self, s):
        return Vec2(self.x * s, self.y * s)

    __rmul__ = __mul__


@dataclasses.dataclass(frozen=True)
class Vec3:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, s):
        if isinstance(s, Vec3):
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot3(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def norm3(a: Vec3):
    return torch.sqrt(dot3(a, a))


def normalize3(a: Vec3) -> Vec3:
    return a * torch.rsqrt(dot3(a, a))
