"""Quaternions as a registered pytree of four real tensors, the real part
last (counterpart of enoki_tpu/types/quaternion.py).

Parity with reference include/enoki/quaternion.h: 4-array layout with the
real part last (:28), Hamilton product, exp / log / pow (:165-190), euler
conversion (:197), quaternion <-> matrix (:226-261), slerp (:308),
axis-angle ``rotate`` (:331).

A Python operand takes the dtype and device of the quaternion beside it.
The reference's lazy branches (components that are LazyArrays, and the
SoA matrices of ``to_matrix`` / ``from_matrix`` over them) wait for the
port of trace/ and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .._device import resolve_device
from ..ops import backend as B
from ..ops import math as M
from ..ops.router import (_operands, abs_ as _abs, mulsign, safe_acos,
                          safe_asin, safe_sqrt, select as _sel)
from ..struct.pytree import register


@dataclasses.dataclass(frozen=True)
class Quaternion:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor  # real part (stored last, quaternion.h:28)

    @staticmethod
    def of(x, y, z, w) -> "Quaternion":
        """Four components broadcast to one shape, in their common float
        dtype (integers as float32; Python numbers take the tensors' dtype,
        and go to the card when all four are numbers)."""
        B.require_eager(x, y, z, w)
        vs = M._floats(x, y, z, w)
        dtype = functools.reduce(torch.promote_types, (v.dtype for v in vs))
        return Quaternion(*torch.broadcast_tensors(*(v.to(dtype)
                                                     for v in vs)))

    @staticmethod
    def identity(shape=(), device=None) -> "Quaternion":
        device = resolve_device(device)
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Quaternion(z, z, z, torch.ones(shape, dtype=torch.float32,
                                              device=device))

    def __add__(self, o):
        return Quaternion(self.x + o.x, self.y + o.y, self.z + o.z,
                          self.w + o.w)

    def __sub__(self, o):
        return Quaternion(self.x - o.x, self.y - o.y, self.z - o.z,
                          self.w - o.w)

    def __neg__(self):
        return Quaternion(-self.x, -self.y, -self.z, -self.w)

    def __mul__(self, o):
        if not isinstance(o, Quaternion):
            o = _real(o, self)
            return Quaternion(self.x * o, self.y * o, self.z * o, self.w * o)
        # Hamilton product (quaternion.h operator*)
        x1, y1, z1, w1 = self.x, self.y, self.z, self.w
        x2, y2, z2, w2 = o.x, o.y, o.z, o.w
        return Quaternion(
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        )

    def __rmul__(self, o):
        # scalar * quat only
        o = _real(o, self)
        return Quaternion(self.x * o, self.y * o, self.z * o, self.w * o)

    def __truediv__(self, o):
        if not isinstance(o, Quaternion):
            o = _real(o, self)
            return Quaternion(self.x / o, self.y / o, self.z / o, self.w / o)
        return self * rcp(o)


register(Quaternion)


def _real(o, like: Quaternion):
    """A real operand: a tensor as it is, a Python number as a 0-d tensor
    of ``like``'s dtype and device (a division by it is then one IEEE
    division on every device)."""
    B.require_eager(o)
    return o if isinstance(o, torch.Tensor) else M._scalar(like.w, o)


def real(q: Quaternion):
    return q.w


def imag(q: Quaternion):
    return q.x, q.y, q.z


def conj(q: Quaternion) -> Quaternion:
    return Quaternion(-q.x, -q.y, -q.z, q.w)


def squared_norm(q: Quaternion):
    return q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w


def abs_(q: Quaternion):
    return B.math_ns(q.x).sqrt(squared_norm(q))


def normalize(q: Quaternion) -> Quaternion:
    inv = B.math_ns(q.x).rsqrt(squared_norm(q))
    return q * inv


def rcp(q: Quaternion) -> Quaternion:
    inv = 1.0 / squared_norm(q)
    return conj(q) * inv


def dot(a: Quaternion, b: Quaternion):
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w


def exp(q: Quaternion, impl="native") -> Quaternion:
    """exp(q) (quaternion.h:165): e^w (cos|v|, sin|v| v/|v|)."""
    g = B.math_ns(q.x, impl)
    vn = g.sqrt(q.x * q.x + q.y * q.y + q.z * q.z)
    ew = g.exp(q.w)
    s, c = g.sincos(vn)
    scale = ew * g.select(vn == 0.0, vn * 0.0 + 1.0,
                          s / g.select(vn == 0.0, vn * 0.0 + 1.0, vn))
    return Quaternion(q.x * scale, q.y * scale, q.z * scale, ew * c)


def log(q: Quaternion, impl="native") -> Quaternion:
    """log(q) (quaternion.h:178)."""
    g = B.math_ns(q.x, impl)
    qn = abs_(q)
    vn = g.sqrt(q.x * q.x + q.y * q.y + q.z * q.z)
    one_qn = g.select(qn == 0.0, qn * 0.0 + 1.0, qn)
    one_vn = g.select(vn == 0.0, vn * 0.0 + 1.0, vn)
    t = safe_acos(q.w / one_qn)
    scale = g.select(vn == 0.0, vn * 0.0, t / one_vn)
    return Quaternion(q.x * scale, q.y * scale, q.z * scale, g.log(qn))


def pow(q: Quaternion, beta, impl="native") -> Quaternion:
    """q^beta = exp(beta * log q) (quaternion.h:190)."""
    l = log(q, impl)  # noqa: E741
    beta = _real(beta, q)
    return exp(Quaternion(l.x * beta, l.y * beta, l.z * beta, l.w * beta),
               impl)


def sqrt(q: Quaternion, impl="native") -> Quaternion:
    """Principal square root (quaternion.h sqrt): complex-style on
    (w, |v|)."""
    g = B.math_ns(q.x, impl)
    ri = abs_(q)
    re = g.sqrt(0.5 * (ri + q.w))
    im_mag = g.sqrt(g.maximum(0.5 * (ri - q.w), ri * 0.0))
    vn = g.sqrt(q.x * q.x + q.y * q.y + q.z * q.z)
    one_vn = g.select(vn == 0.0, vn * 0.0 + 1.0, vn)
    # pure-negative-real input (vn == 0, im_mag > 0): the root's
    # imaginary direction is undefined -- NaN, as in the reference, not
    # the zero quaternion (whose square is 0, not q)
    undef = g.select(im_mag > 0.0, vn * 0.0 + float("nan"), vn * 0.0)
    scale = g.select(vn == 0.0, undef, im_mag / one_vn)
    return Quaternion(q.x * scale, q.y * scale, q.z * scale, re)


def rotate_vector(q: Quaternion, vx, vy, vz):
    """Rotate a 3-vector by a unit quaternion: q v q^-1, expanded to the
    branch-free 15-mul form."""
    tx = 2.0 * (q.y * vz - q.z * vy)
    ty = 2.0 * (q.z * vx - q.x * vz)
    tz = 2.0 * (q.x * vy - q.y * vx)
    rx = vx + q.w * tx + (q.y * tz - q.z * ty)
    ry = vy + q.w * ty + (q.z * tx - q.x * tz)
    rz = vz + q.w * tz + (q.x * ty - q.y * tx)
    return rx, ry, rz


def from_axis_angle(ax, ay, az, angle, impl="native") -> Quaternion:
    """``rotate(axis, angle)`` (quaternion.h:331): the axis must be unit.
    A Python angle goes to the axis' device."""
    B.require_eager(ax, ay, az, angle)
    ang = _operands(angle, ax, ay, az)[0]
    s, c = M.sincos(ang * 0.5, impl)
    return Quaternion(ax * s, ay * s, az * s, c + (ax * s) * 0.0)


def to_matrix(q: Quaternion):
    """quat_to_matrix (quaternion.h:226): a dense (..., 3, 3) rotation
    matrix. (The reference gives quaternions of LazyArrays the SoA form of
    types/matrix_soa; that waits for trace/.)"""
    B.require_eager(q.x)
    x, y, z, w = q.x, q.y, q.z, q.w
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def from_matrix(m) -> Quaternion:
    """matrix_to_quat (quaternion.h:240-261): branch-free Shepperd's method
    with lane masks (a select over the four cases). Takes a dense
    (..., 3, 3) tensor or the SoA tuple form (types/matrix_soa)."""
    if isinstance(m, tuple):  # SoA row-major tuples
        (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
        B.require_eager(m00)
    else:
        m = m if isinstance(m, torch.Tensor) else M._f(m)
        m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # case w: tr > 0
    sw = safe_sqrt(tr + 1.0) * 2.0
    qw_w = 0.25 * sw
    qx_w = (m21 - m12) / _sel(sw == 0.0, sw * 0.0 + 1.0, sw)
    qy_w = (m02 - m20) / _sel(sw == 0.0, sw * 0.0 + 1.0, sw)
    qz_w = (m10 - m01) / _sel(sw == 0.0, sw * 0.0 + 1.0, sw)

    # case x: m00 largest diagonal
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    qw_x = (m21 - m12) / _sel(sx == 0.0, sx * 0.0 + 1.0, sx)
    qx_x = 0.25 * sx
    qy_x = (m01 + m10) / _sel(sx == 0.0, sx * 0.0 + 1.0, sx)
    qz_x = (m02 + m20) / _sel(sx == 0.0, sx * 0.0 + 1.0, sx)

    # case y
    sy = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    qw_y = (m02 - m20) / _sel(sy == 0.0, sy * 0.0 + 1.0, sy)
    qx_y = (m01 + m10) / _sel(sy == 0.0, sy * 0.0 + 1.0, sy)
    qy_y = 0.25 * sy
    qz_y = (m12 + m21) / _sel(sy == 0.0, sy * 0.0 + 1.0, sy)

    # case z
    sz = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    qw_z = (m10 - m01) / _sel(sz == 0.0, sz * 0.0 + 1.0, sz)
    qx_z = (m02 + m20) / _sel(sz == 0.0, sz * 0.0 + 1.0, sz)
    qy_z = (m12 + m21) / _sel(sz == 0.0, sz * 0.0 + 1.0, sz)
    qz_z = 0.25 * sz

    use_w = tr > 0
    use_x = ~use_w & (m00 > m11) & (m00 > m22)
    use_y = ~use_w & ~use_x & (m11 > m22)

    def pick(w, x, y, z):
        return _sel(use_w, w, _sel(use_x, x, _sel(use_y, y, z)))

    return Quaternion(pick(qx_w, qx_x, qx_y, qx_z),
                      pick(qy_w, qy_x, qy_y, qy_z),
                      pick(qz_w, qz_x, qz_y, qz_z),
                      pick(qw_w, qw_x, qw_y, qw_z))


def euler_angles(q: Quaternion, impl="native"):
    """Quaternion -> (roll, pitch, yaw) Tait-Bryan angles
    (quaternion.h:197)."""
    sinr_cosp = 2.0 * (q.w * q.x + q.y * q.z)
    cosr_cosp = 1.0 - 2.0 * (q.x * q.x + q.y * q.y)
    roll = M.atan2(sinr_cosp, cosr_cosp, impl)
    sinp = 2.0 * (q.w * q.y - q.z * q.x)
    pitch = _sel(_abs(sinp) >= 1.0,
                 mulsign(sinp * 0.0 + math.pi / 2, sinp),
                 safe_asin(sinp))
    siny_cosp = 2.0 * (q.w * q.z + q.x * q.y)
    cosy_cosp = 1.0 - 2.0 * (q.y * q.y + q.z * q.z)
    yaw = M.atan2(siny_cosp, cosy_cosp, impl)
    return roll, pitch, yaw


def slerp(a: Quaternion, b: Quaternion, t, impl="native") -> Quaternion:
    """Spherical linear interpolation (quaternion.h:308), shortest arc."""
    d = dot(a, b)
    flip = d < 0
    b = Quaternion(_sel(flip, -b.x, b.x), _sel(flip, -b.y, b.y),
                   _sel(flip, -b.z, b.z), _sel(flip, -b.w, b.w))
    d = _abs(d)
    theta = safe_acos(d)
    s = M.sin(theta, impl)
    near = s < 1e-6
    safe_s = _sel(near, s * 0.0 + 1.0, s)
    w0 = _sel(near, theta * 0.0 + (1.0 - t),
              M.sin(theta * (1.0 - t), impl) / safe_s)
    w1 = _sel(near, theta * 0.0 + t, M.sin(theta * t, impl) / safe_s)
    return Quaternion(a.x * w0 + b.x * w1, a.y * w0 + b.y * w1,
                      a.z * w0 + b.z * w1, a.w * w0 + b.w * w1)
