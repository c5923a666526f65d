"""Homogeneous 3D transforms (4x4) and the polar decomposition
(counterpart of enoki_tpu/types/transform.py).

Parity with reference include/enoki/transform.h: translate / scale /
rotate (:20-38), perspective / frustum / ortho (:60-104), look_at (:130),
transform_decompose / compose through the iterative polar decomposition
(:157-199). Matrices are (..., 4, 4) tensors (types/matrix.py).

The builders of Python numbers alone (``perspective`` of a number,
``frustum``, ``ortho``) make their matrix on ``device`` (None: the card,
or raise); given a tensor, every function works on its device.
"""

from __future__ import annotations

import torch

from . import matrix as mat
from . import quaternion as quat
from .._device import resolve_device
from ..ops import math as M
from ..ops.router import _asarray, _sqrt_rn, cross


def _eye4(shape, like):
    """The 4x4 identity broadcast to (*shape, 4, 4), a fresh tensor of
    ``like``'s dtype and device."""
    eye = torch.eye(4, dtype=like.dtype, device=like.device)
    return eye.expand(*shape, 4, 4).clone()


def translate(v):
    """transform.h:20."""
    v = _asarray(v)
    m = _eye4(v.shape[:-1], v)
    m[..., 0:3, 3] = v
    return m


def scale(v):
    """transform.h:29."""
    v = _asarray(v)
    d = torch.cat([v, torch.ones((*v.shape[:-1], 1), dtype=v.dtype,
                                 device=v.device)], -1)
    return mat.diag_matrix(d)


def rotate(axis, angle, impl="native"):
    """Rotation about a unit axis by ``angle`` radians (transform.h:38),
    Rodrigues form, returned as a 4x4. An integer axis is promoted to
    float32 before the angle is cast to its dtype (an int axis would
    otherwise truncate the angle to 0)."""
    axis = M._f(axis)
    angle = angle.to(axis.dtype) if isinstance(angle, torch.Tensor) else \
        torch.tensor(angle, dtype=axis.dtype, device=axis.device)
    s, c = M.sincos(angle, impl)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    t = 1.0 - c
    r = torch.stack([
        torch.stack([c + x * x * t, x * y * t - z * s, x * z * t + y * s], -1),
        torch.stack([y * x * t + z * s, c + y * y * t, y * z * t - x * s], -1),
        torch.stack([z * x * t - y * s, z * y * t + x * s, c + z * z * t], -1),
    ], -2)
    out = _eye4(r.shape[:-2], r)
    out[..., :3, :3] = r
    return out


def _matrix(entries, identity, dtype, device):
    """A 4x4 of ``dtype`` on ``device``, zero (or the identity) but for
    ``entries``: {(i, j): value}, each value a Python number (rounded once
    to ``dtype``) or a 0-d tensor."""
    m = (torch.eye if identity else torch.zeros)(4, 4, dtype=dtype,
                                                 device=device)
    for (i, j), v in entries.items():
        m[i, j] = v
    return m


def _number_device(*vs, device=None):
    """The device of the first tensor of ``vs``, else ``device`` resolved
    (None: the card, or raise)."""
    return next((v.device for v in vs if isinstance(v, torch.Tensor)),
                None) or resolve_device(device)


def perspective(fov, near, far, aspect=1.0, device=None):
    """Perspective projection, fov in radians (transform.h:60-76, matched
    term for term). GL convention: the camera looks down -z and the
    frustum maps to clip z' in [-1, 1] after the perspective divide
    (z' = -1 at z = -near, +1 at z = -far; w = -z). The terms of Python
    numbers are computed in double and rounded once, as in the
    reference."""
    dev = _number_device(fov, device=device)
    fov = M._f(fov if isinstance(fov, torch.Tensor)
               else torch.tensor(fov, dtype=torch.float32, device=dev))
    recip = 1.0 / (near - far)
    c = 1.0 / torch.tan(0.5 * fov)
    aspect = aspect if isinstance(aspect, torch.Tensor) else M._scalar(
        c, aspect)
    return _matrix({(0, 0): c / aspect, (1, 1): c,
                    (2, 2): (near + far) * recip,
                    (2, 3): 2.0 * near * far * recip, (3, 2): -1.0},
                   False, fov.dtype, dev)


def frustum(left, right, bottom, top, near, far, device=None):
    """transform.h:81."""
    rl = 1.0 / (right - left)
    tb = 1.0 / (top - bottom)
    fn = 1.0 / (far - near)
    return _matrix({(0, 0): 2.0 * near * rl, (1, 1): 2.0 * near * tb,
                    (0, 2): (right + left) * rl, (1, 2): (top + bottom) * tb,
                    (2, 2): -(far + near) * fn,
                    (2, 3): -2.0 * far * near * fn, (3, 2): -1.0},
                   False, torch.float32,
                   _number_device(left, right, bottom, top, near, far,
                                  device=device))


def ortho(left, right, bottom, top, near, far, device=None):
    """transform.h:104."""
    rl = 1.0 / (right - left)
    tb = 1.0 / (top - bottom)
    fn = 1.0 / (far - near)
    return _matrix({(0, 0): 2.0 * rl, (1, 1): 2.0 * tb, (2, 2): -2.0 * fn,
                    (0, 3): -(right + left) * rl, (1, 3): -(top + bottom) * tb,
                    (2, 3): -(far + near) * fn},
                   True, torch.float32,
                   _number_device(left, right, bottom, top, near, far,
                                  device=device))


def _unit(v):
    """v / |v| on the last axis of three, the norm a correctly rounded
    root of x*x + y*y + z*z added in that order (``jnp.linalg.norm``; a
    reduction would add in another order on the card)."""
    x, y, z = v.unbind(-1)
    return v / _sqrt_rn(x * x + y * y + z * z)[..., None]


def look_at(origin, target, up):
    """Camera-to-world transform (transform.h:130)."""
    origin, target, up = (_asarray(v).to(torch.float32)
                          for v in (origin, target, up))
    dirv = _unit(target - origin)
    left = _unit(cross(up, dirv))
    new_up = cross(dirv, left)
    m = torch.zeros((*origin.shape[:-1], 4, 4), dtype=origin.dtype,
                    device=origin.device)
    m[..., 0:3, 0] = left
    m[..., 0:3, 1] = new_up
    m[..., 0:3, 2] = dirv
    m[..., 0:3, 3] = origin
    m[..., 3, 3] = 1.0
    return m


def polar_decompose(a, iterations: int = 10):
    """Iterative polar decomposition A = Q P of the upper-left 3x3
    (transform.h:157-176: Higham's inverse-transpose averaging, a fixed
    trip count)."""
    q = _asarray(a)
    for _ in range(iterations):
        qit = mat.inverse_transpose(q)
        q = 0.5 * (q + qit)
    p = mat.matmul(mat.transpose(q), a)
    return q, p


def _sign(x):
    """``jnp.sign``: -1, 0 or 1, with NaN and the zero's sign kept
    (``torch.sign`` gives 0 for NaN and +0 for -0.0)."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def transform_decompose(m, iterations: int = 10):
    """4x4 -> (scale/shear 3x3, rotation quaternion, translation 3-vector)
    (transform.h:157-180). Reflections as in the reference: if det(Q) < 0,
    both Q and P flip."""
    m = _asarray(m)
    a = m[..., :3, :3]
    q, p = polar_decompose(a, iterations)
    sign = _sign(mat.det(q))
    q = q * sign[..., None, None]
    p = p * sign[..., None, None]
    rot = quat.from_matrix(q)
    trans = m[..., :3, 3]
    return p, rot, trans


def transform_compose(s, r: "quat.Quaternion", t):
    """(scale/shear, quaternion, translation) -> 4x4 (transform.h:190-199)."""
    s = _asarray(s)
    rm = quat.to_matrix(r)
    a = mat.matmul(rm, s)
    out = torch.zeros((*a.shape[:-2], 4, 4), dtype=a.dtype, device=a.device)
    out[..., :3, :3] = a
    out[..., :3, 3] = _asarray(t, a.device)
    out[..., 3, 3] = 1.0
    return out


def transform_point(m, p):
    """Apply a 4x4 to a 3-point (w = 1)."""
    return mat.matvec(m[..., :3, :3], _asarray(p, m.device)) + m[..., :3, 3]


def transform_vector(m, v):
    """Apply a 4x4 to a 3-vector (w = 0; no translation)."""
    return mat.matvec(m[..., :3, :3], _asarray(v, m.device))


def transform_normal(m, n):
    """Apply the inverse-transpose to a normal."""
    it = mat.inverse_transpose(m[..., :3, :3])
    return mat.matvec(it, _asarray(n, m.device))
