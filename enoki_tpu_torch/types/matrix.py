"""Small fixed-size matrices on the trailing axes (counterpart of
enoki_tpu/types/matrix.py).

Parity with reference include/enoki/matrix.h: ``Matrix<T,N>`` (:33) with
matmul, from_rows / cols (:108-113), trace (:206), Frobenius norm (:214),
identity (:222), diag (:231), and the analytic inverse / determinant for
N = 1..4 (:247-388).

A matrix batch is one tensor of shape (..., N, N), rows on the second to
last axis. The N <= 4 determinant and inverse are branch-free closed forms,
so that autograd flows through them; above 4 ``torch.linalg.det`` /
``torch.linalg.inv`` stand in for the reference's ``jnp.linalg``, a
library call in both packages. ``matmul``, ``matvec``, ``trace`` and
``frob`` add their terms one at a time in index order, at every N, so that
the card and the CPU agree bit for bit.
"""

from __future__ import annotations

import functools
import operator

import torch

from .._device import resolve_device
from ..ops.router import _asarray


def identity(n: int, shape=(), dtype=torch.float32, device=None):
    """The n x n identity broadcast to (*shape, n, n), on ``device`` (None:
    the card, or raise)."""
    eye = torch.eye(n, dtype=dtype, device=resolve_device(device))
    return torch.broadcast_to(eye, (*shape, n, n))


def diag_matrix(d):
    """Vector (..., N) -> diagonal matrix (..., N, N) (matrix.h:231)."""
    d = _asarray(d)
    n = d.shape[-1]
    return d[..., :, None] * torch.eye(n, dtype=d.dtype, device=d.device)


def diag(m):
    """Matrix (..., N, N) -> diagonal vector (..., N)."""
    return torch.diagonal(m, dim1=-2, dim2=-1)


def from_rows(*rows):
    return torch.stack([torch.stack(list(r), -1)
                        if isinstance(r, (list, tuple)) else r
                        for r in rows], -2)


def from_cols(*cols):
    return torch.stack([torch.stack(list(c), -1)
                        if isinstance(c, (list, tuple)) else c
                        for c in cols], -1)


def _in_order(terms):
    """The sum of ``terms`` added one at a time, first to last: the same
    bits on the CPU and the card, whose reductions and matrix products add
    in orders of their own."""
    return functools.reduce(operator.add, terms)


def matmul(a, b):
    """Matrix product on the trailing axes; each output adds its products
    in index order (``_in_order``)."""
    return _in_order(a[..., :, k, None] * b[..., None, k, :]
                     for k in range(a.shape[-1]))


def matvec(m, v):
    return _in_order(m[..., :, k] * v[..., None, k]
                     for k in range(m.shape[-1]))


def transpose(m):
    return torch.swapaxes(m, -1, -2)


def trace(m):
    return _in_order(torch.diagonal(m, dim1=-2, dim2=-1).unbind(-1))


def frob(m):
    """Squared Frobenius norm (matrix.h:214)."""
    return _in_order((m * m).flatten(-2).unbind(-1))


def det(m):
    """Analytic determinant, N = 1..4 (matrix.h:247-388)."""
    m = _asarray(m)
    n = m.shape[-1]
    if n == 1:
        return m[..., 0, 0]
    if n == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if n == 3:
        a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    if n == 4:
        return _det4(m)
    return torch.linalg.det(m)


def _m2(u, v, i, j):
    return u[..., i] * v[..., j] - u[..., j] * v[..., i]


def _minors(m):
    """The six 2x2 minors of rows (0, 1) and of rows (2, 3), each in the
    order (01, 02, 03, 12, 13, 23)."""
    a, b, c, d = (m[..., k, :] for k in range(4))
    pairs = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    return ([_m2(a, b, i, j) for i, j in pairs],
            [_m2(c, d, i, j) for i, j in pairs])


def _det4(m):
    # 2x2 minors of rows 0,1 and rows 2,3 (standard cofactor contraction)
    (s0, s1, s2, s3, s4, s5), (c0, c1, c2, c3, c4, c5) = _minors(m)
    return s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0


def inverse_transpose(m):
    """Inverse-transpose (normal-vector transform matrix)."""
    return transpose(inverse(m))


def _from_entries(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def inverse(m):
    """Analytic inverse for N = 1..4, ``torch.linalg.inv`` above
    (matrix.h:247-388)."""
    m = _asarray(m)
    n = m.shape[-1]
    if n == 1:
        return 1.0 / m
    if n == 2:
        inv_d = 1.0 / det(m)
        out = _from_entries([[m[..., 1, 1], -m[..., 0, 1]],
                             [-m[..., 1, 0], m[..., 0, 0]]])
        return out * inv_d[..., None, None]
    if n == 3:
        a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        d_, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        A = e * i - f * h
        B = c * h - b * i
        C = b * f - c * e
        D = f * g - d_ * i
        E = a * i - c * g
        F = c * d_ - a * f
        G = d_ * h - e * g
        H = b * g - a * h
        I = a * e - b * d_  # noqa: E741
        inv_d = 1.0 / (a * A + b * D + c * G)
        out = _from_entries([[A, B, C], [D, E, F], [G, H, I]])
        return out * inv_d[..., None, None]
    if n == 4:
        return _inv4(m)
    return torch.linalg.inv(m)


def _inv4(m):
    a, b, c, d = (m[..., k, :] for k in range(4))
    (s0, s1, s2, s3, s4, s5), (c0, c1, c2, c3, c4, c5) = _minors(m)

    detv = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_d = 1.0 / detv

    r00 = b[..., 1] * c5 - b[..., 2] * c4 + b[..., 3] * c3
    r01 = -a[..., 1] * c5 + a[..., 2] * c4 - a[..., 3] * c3
    r02 = d[..., 1] * s5 - d[..., 2] * s4 + d[..., 3] * s3
    r03 = -c[..., 1] * s5 + c[..., 2] * s4 - c[..., 3] * s3

    r10 = -b[..., 0] * c5 + b[..., 2] * c2 - b[..., 3] * c1
    r11 = a[..., 0] * c5 - a[..., 2] * c2 + a[..., 3] * c1
    r12 = -d[..., 0] * s5 + d[..., 2] * s2 - d[..., 3] * s1
    r13 = c[..., 0] * s5 - c[..., 2] * s2 + c[..., 3] * s1

    r20 = b[..., 0] * c4 - b[..., 1] * c2 + b[..., 3] * c0
    r21 = -a[..., 0] * c4 + a[..., 1] * c2 - a[..., 3] * c0
    r22 = d[..., 0] * s4 - d[..., 1] * s2 + d[..., 3] * s0
    r23 = -c[..., 0] * s4 + c[..., 1] * s2 - c[..., 3] * s0

    r30 = -b[..., 0] * c3 + b[..., 1] * c1 - b[..., 2] * c0
    r31 = a[..., 0] * c3 - a[..., 1] * c1 + a[..., 2] * c0
    r32 = -d[..., 0] * s3 + d[..., 1] * s1 - d[..., 2] * s0
    r33 = c[..., 0] * s3 - c[..., 1] * s1 + c[..., 2] * s0

    out = _from_entries([[r00, r01, r02, r03], [r10, r11, r12, r13],
                         [r20, r21, r22, r23], [r30, r31, r32, r33]])
    return out * inv_d[..., None, None]
