"""SoA 2/3-vectors for the render pipeline (counterpart of
enoki_tpu/render/vec.py).

Each component is a full tensor, so every vector op is elementwise. Eager
torch only: the lazy ``LazyArray`` dispatch of the reference waits for the
port of ``trace/``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .._device import resolve_device
from ..ops.router import _plain_rsqrt, _plain_sqrt, copysign, mulsign
from ..struct.pytree import register


def _as_tensor(v, dtype, device):
    """``v`` in ``dtype``: a tensor keeps its device, a Python number goes
    to ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.as_tensor(v, dtype=dtype, device=device)


@register
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


@register
@dataclasses.dataclass(frozen=True)
class Vec3:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def of(x, y, z, device=None) -> "Vec3":
        """A vector of the components ``x``, ``y``, ``z``, in ``x``'s dtype
        if that is a floating type, else the default float dtype (as
        ``jnp.result_type(x, 1.0)`` promotes); ``y`` and ``z`` take ``x``'s
        dtype. Tensors keep their device; Python numbers go to
        ``resolve_device(device)``: the card unless the caller asks for the
        CPU. The eager branch of the reference's ``Vec3.of``: its lift of
        lazy components waits for the port of ``trace/``."""
        device = x.device if isinstance(x, torch.Tensor) else \
            resolve_device(device)
        xt = torch.as_tensor(x, device=device)
        if not xt.is_floating_point():
            xt = xt.to(torch.get_default_dtype())
        return Vec3(xt, _as_tensor(y, xt.dtype, device),
                    _as_tensor(z, xt.dtype, device))

    @staticmethod
    def splat(x, y, z, like=None, device=None) -> "Vec3":
        """Constant vector in ``like.x``'s dtype and on its device, else in
        float32 on ``resolve_device(device)``; it broadcasts against
        ``like``'s lanes."""
        if like is not None:
            dt, device = like.x.dtype, like.x.device
        else:
            dt, device = torch.float32, resolve_device(device)
        return Vec3(_as_tensor(x, dt, device), _as_tensor(y, dt, device),
                    _as_tensor(z, dt, device))

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


def cross3(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def norm3(a: Vec3):
    return _plain_sqrt(dot3(a, a))


def normalize3(a: Vec3) -> Vec3:
    return a * _plain_rsqrt(dot3(a, a))


def unit_angle(a: Vec3, b: Vec3):
    """Numerically well-behaved angle between two UNIT vectors (Don
    Hatch's formulation, enoki_tpu/render/vec.py:106-117): accurate for
    nearly parallel and nearly antiparallel inputs, where acos(dot) loses
    all precision. ``torch.asin`` and ``torch.where`` stand in for the
    reference's ``ns.asin`` and ``ns.select``."""
    d = dot3(a, b)
    s = mulsign(a.x, d), mulsign(a.y, d), mulsign(a.z, d)
    diff = Vec3(b.x - s[0], b.y - s[1], b.z - s[2])
    temp = 2.0 * torch.asin(0.5 * norm3(diff))
    return torch.where(d >= 0.0, temp, math.pi - temp)


def unit_angle_z(v: Vec3):
    """Angle between a unit vector and the z-axis
    (enoki_tpu/render/vec.py:120-127): use wherever acos(v.z) is
    tempting."""
    zc = v.z - copysign(v.z * 0.0 + 1.0, v.z)
    temp = 2.0 * torch.asin(0.5 * _plain_sqrt(v.x * v.x + v.y * v.y
                                             + zc * zc))
    return torch.where(v.z >= 0.0, temp, math.pi - temp)
