"""SoA matrices: a matrix as N*N separate scalar tensors (counterpart of
enoki_tpu/types/matrix_soa.py).

The reference's actual structure: ``Matrix<T, N>`` is an array of arrays
(matrix.h:33). Entries are a row-major tuple of tuples of scalar tensors
(or Python numbers), and every op is straight-line elementwise code with
no (N, N) axis; ``types/matrix.py`` is the dense form. The reference's
lazy entries (LazyArrays, ``Matrix<CUDAArray<float>>``) wait for the port
of trace/.

The same analytic det / inverse as the dense module (matrix.h:247-388),
the cofactor expressions written over scalar entries.
"""

from __future__ import annotations

import torch

from ..ops import backend as B
from ..ops.router import _asarray, _operands


def matrix(rows):
    """Normalize to a row-major tuple-of-tuples; validates squareness."""
    m = tuple(tuple(r) for r in rows)
    n = len(m)
    if any(len(r) != n for r in m):
        raise ValueError("matrix_soa: rows must form a square matrix")
    return m


def from_dense(a):
    """Dense (..., N, N) tensor -> SoA tuples of (...)-shaped scalars."""
    a = _asarray(a)
    n = a.shape[-1]
    return tuple(tuple(a[..., i, j] for j in range(n)) for i in range(n))


def to_dense(m):
    """SoA -> dense (..., N, N) tensor."""
    return torch.stack([torch.stack(list(r), -1) for r in m], -2)


def identity_like(n, like):
    """n x n identity with entries broadcast like the scalar ``like``."""
    one = like * 0.0 + 1.0
    zero = like * 0.0
    return tuple(tuple(one if i == j else zero for j in range(n))
                 for i in range(n))


def matmul(a, b):
    n = len(a)
    return tuple(tuple(sum(a[i][k] * b[k][j] for k in range(n))
                       for j in range(n)) for i in range(n))


def matvec(m, v):
    """v is a tuple of N scalars; returns a tuple of N scalars."""
    n = len(m)
    return tuple(sum(m[i][k] * v[k] for k in range(n)) for i in range(n))


def transpose(m):
    n = len(m)
    return tuple(tuple(m[j][i] for j in range(n)) for i in range(n))


def trace(m):
    return sum(m[i][i] for i in range(len(m)))


def frob(m):
    """Squared Frobenius norm (matrix.h:214)."""
    return sum(e * e for r in m for e in r)


def _minors2(u, v):
    """The six 2x2 minors of the row pair (u, v) (rows as 4-tuples)."""
    def m2(i, j):
        return u[i] * v[j] - u[j] * v[i]

    return (m2(0, 1), m2(0, 2), m2(0, 3), m2(1, 2), m2(1, 3), m2(2, 3))


def det(m):
    """Analytic determinant, N = 1..4 (matrix.h:247-388)."""
    n = len(m)
    if n == 1:
        return m[0][0]
    if n == 2:
        return m[0][0] * m[1][1] - m[0][1] * m[1][0]
    if n == 3:
        (a, b, c), (d, e, f), (g, h, i) = m
        return a * (e * i - f * h) - b * (d * i - f * g) \
            + c * (d * h - e * g)
    if n == 4:
        s0, s1, s2, s3, s4, s5 = _minors2(m[0], m[1])
        c0, c1, c2, c3, c4, c5 = _minors2(m[2], m[3])
        return s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    raise NotImplementedError("analytic det only for N <= 4 "
                              "(use the dense module for larger)")


def inverse(m):
    """Analytic inverse for N = 1..4 (matrix.h:247-388)."""
    n = len(m)
    if n == 1:
        return ((1.0 / m[0][0],),)
    if n == 2:
        inv_d = 1.0 / det(m)
        return ((m[1][1] * inv_d, -m[0][1] * inv_d),
                (-m[1][0] * inv_d, m[0][0] * inv_d))
    if n == 3:
        (a, b, c), (d, e, f), (g, h, i) = m
        A = e * i - f * h
        B_ = c * h - b * i
        C = b * f - c * e
        D = f * g - d * i
        E = a * i - c * g
        F = c * d - a * f
        G = d * h - e * g
        H = b * g - a * h
        I = a * e - b * d  # noqa: E741
        inv_d = 1.0 / (a * A + b * D + c * G)
        return ((A * inv_d, B_ * inv_d, C * inv_d),
                (D * inv_d, E * inv_d, F * inv_d),
                (G * inv_d, H * inv_d, I * inv_d))
    if n == 4:
        a, b, c, d = m
        s0, s1, s2, s3, s4, s5 = _minors2(a, b)
        c0, c1, c2, c3, c4, c5 = _minors2(c, d)
        inv_d = 1.0 / (s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1
                       + s5 * c0)
        r = (
            (b[1] * c5 - b[2] * c4 + b[3] * c3,
             -a[1] * c5 + a[2] * c4 - a[3] * c3,
             d[1] * s5 - d[2] * s4 + d[3] * s3,
             -c[1] * s5 + c[2] * s4 - c[3] * s3),
            (-b[0] * c5 + b[2] * c2 - b[3] * c1,
             a[0] * c5 - a[2] * c2 + a[3] * c1,
             -d[0] * s5 + d[2] * s2 - d[3] * s1,
             c[0] * s5 - c[2] * s2 + c[3] * s1),
            (b[0] * c4 - b[1] * c2 + b[3] * c0,
             -a[0] * c4 + a[1] * c2 - a[3] * c0,
             d[0] * s4 - d[1] * s2 + d[3] * s0,
             -c[0] * s4 + c[1] * s2 - c[3] * s0),
            (-b[0] * c3 + b[1] * c1 - b[2] * c0,
             a[0] * c3 - a[1] * c1 + a[2] * c0,
             -d[0] * s3 + d[1] * s1 - d[2] * s0,
             c[0] * s3 - c[1] * s1 + c[2] * s0),
        )
        return tuple(tuple(e * inv_d for e in row) for row in r)
    raise NotImplementedError("analytic inverse only for N <= 4 "
                              "(use the dense module for larger)")


def inverse_transpose(m):
    """Inverse-transpose (normal-vector transform, matrix.h)."""
    return transpose(inverse(m))


# ---------------------------------------------------------------------------
# Homogeneous transforms in SoA form (transform.h:20-130 over Matrix<T,4>
# with scalar entries; the dense builders live in types/transform.py)
# ---------------------------------------------------------------------------


def _like(x):
    return x * 0.0


def translate(tx, ty, tz):
    """4x4 translation; the components are scalar tensors."""
    z = _like(tx)
    o = z + 1.0
    return ((o, z, z, tx),
            (z, o, z, ty),
            (z, z, o, tz),
            (z, z, z, o))


def scale(sx, sy, sz):
    z = _like(sx)
    o = z + 1.0
    return ((sx, z, z, z),
            (z, sy, z, z),
            (z, z, sz, z),
            (z, z, z, o))


def rotate(ax, ay, az, angle):
    """Axis-angle rotation (unit axis), Rodrigues form (transform.h:38).
    A Python angle goes to the axis' device."""
    B.require_eager(ax, ay, az, angle)
    g = B.math_ns(angle)
    s, c = g.sincos(_operands(angle, ax, ay, az)[0])
    t = 1.0 - c
    z = _like(s)
    o = z + 1.0
    return ((c + ax * ax * t, ax * ay * t - az * s, ax * az * t + ay * s, z),
            (ay * ax * t + az * s, c + ay * ay * t, ay * az * t - ax * s, z),
            (az * ax * t - ay * s, az * ay * t + ax * s, c + az * az * t, z),
            (z, z, z, o))


def transform_point(m, x, y, z):
    """Apply a homogeneous 4x4 to a 3-point (w = 1)."""
    px, py, pz, pw = matvec(m, (x, y, z, x * 0.0 + 1.0))
    return px / pw, py / pw, pz / pw


def transform_vector(m, x, y, z):
    """Apply the linear part only (w = 0)."""
    vx, vy, vz, _ = matvec(m, (x, y, z, x * 0.0))
    return vx, vy, vz
