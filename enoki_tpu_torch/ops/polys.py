"""Estrin-scheme polynomial evaluators (counterpart of
enoki_tpu/ops/polys.py), coefficient order and association unchanged.

``polyN(x, c0, .., cN)`` evaluates c0 + c1*x + ... + cN*x^N. Coefficients
are Python floats and act in ``x.dtype``: PyTorch rounds a Python number
to the tensor's float32 or float64 before the operation, which is the
reference's materialised coefficient; for a 2-byte dtype it would keep
the number in float32, so there the coefficient is rounded to the dtype
first.
"""

from __future__ import annotations

import torch


def _c(x, v):
    if x.dtype in (torch.float32, torch.float64):
        return v
    return torch.tensor(v, dtype=x.dtype).item()


def poly2(x, c0, c1, c2):
    x2 = x * x
    return x2 * _c(x, c2) + (x * _c(x, c1) + _c(x, c0))


def poly3(x, c0, c1, c2, c3):
    x2 = x * x
    return (x * _c(x, c3) + _c(x, c2)) * x2 + (x * _c(x, c1) + _c(x, c0))


def poly4(x, c0, c1, c2, c3, c4):
    x2 = x * x
    x4 = x2 * x2
    return (x * _c(x, c3) + _c(x, c2)) * x2 + (x4 * _c(x, c4) + (x * _c(x, c1) + _c(x, c0)))


def poly5(x, c0, c1, c2, c3, c4, c5):
    x2 = x * x
    x4 = x2 * x2
    return (x * _c(x, c5) + _c(x, c4)) * x4 + ((x * _c(x, c3) + _c(x, c2)) * x2 + (x * _c(x, c1) + _c(x, c0)))


def poly6(x, c0, c1, c2, c3, c4, c5, c6):
    x2 = x * x
    x4 = x2 * x2
    return (x2 * _c(x, c6) + (x * _c(x, c5) + _c(x, c4))) * x4 + (
        (x * _c(x, c3) + _c(x, c2)) * x2 + (x * _c(x, c1) + _c(x, c0))
    )


def poly7(x, c0, c1, c2, c3, c4, c5, c6, c7):
    x2 = x * x
    x4 = x2 * x2
    return ((x * _c(x, c7) + _c(x, c6)) * x2 + (x * _c(x, c5) + _c(x, c4))) * x4 + (
        (x * _c(x, c3) + _c(x, c2)) * x2 + (x * _c(x, c1) + _c(x, c0))
    )


def poly8(x, c0, c1, c2, c3, c4, c5, c6, c7, c8):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return x8 * _c(x, c8) + (
        ((x * _c(x, c7) + _c(x, c6)) * x2 + (x * _c(x, c5) + _c(x, c4))) * x4
        + ((x * _c(x, c3) + _c(x, c2)) * x2 + (x * _c(x, c1) + _c(x, c0)))
    )


def poly9(x, c0, c1, c2, c3, c4, c5, c6, c7, c8, c9):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return (x * _c(x, c9) + _c(x, c8)) * x8 + (
        ((x * _c(x, c7) + _c(x, c6)) * x2 + (x * _c(x, c5) + _c(x, c4))) * x4
        + ((x * _c(x, c3) + _c(x, c2)) * x2 + (x * _c(x, c1) + _c(x, c0)))
    )


def poly10(x, c0, c1, c2, c3, c4, c5, c6, c7, c8, c9, c10):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return (x2 * _c(x, c10) + (x * _c(x, c9) + _c(x, c8))) * x8 + (
        ((x * _c(x, c7) + _c(x, c6)) * x2 + (x * _c(x, c5) + _c(x, c4))) * x4
        + ((x * _c(x, c3) + _c(x, c2)) * x2 + (x * _c(x, c1) + _c(x, c0)))
    )


def horner(x, coeffs):
    """Horner fallback for arbitrary-degree polynomials (coeffs low->high)."""
    acc = (torch.full_like(x, _c(x, coeffs[-1]))
           if isinstance(x, torch.Tensor) else x._coerce(_c(x, coeffs[-1])))
    for c in reversed(coeffs[:-1]):
        acc = acc * x + _c(x, c)
    return acc
