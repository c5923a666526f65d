"""Transcendental math (counterpart of enoki_tpu/ops/math.py), of which
only ``log`` is ported so far: the polynomial ``erfinv`` calls it.

Every function takes ``impl``: ``"native"`` is PyTorch's own function,
``"poly"`` the reference's branch-free range reduction and Estrin
polynomial (the classic Cephes minimax fits, public domain), operation
for operation. 2-byte float inputs are computed in float32 and rounded
back; integer inputs are taken as float32. The lazy (``LazyArray``)
instantiation of the reference waits for the port of ``trace/``.
"""

from __future__ import annotations

import math

import torch

from . import polys as P
from .router import frexp as _frexp

_NATIVE = "native"
_POLY = "poly"

_16BIT = (torch.bfloat16, torch.float16)


def _f(x):
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    return x


_LOGCOF_F32 = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
               -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
               2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)

_LOG_P_F64 = (1.01875663804580931796e-4, 4.97494994976747001425e-1,
              4.70579119878881725854e0, 1.44989225341610930846e1,
              1.79368678507819816313e1, 7.70838733755885391666e0)
_LOG_Q_F64 = (1.12873587189167450590e1, 4.52279145837532221105e1,
              8.29875266912776603211e1, 7.11544750618563894466e1,
              2.31251620126765340583e1)


def log(x, impl=_NATIVE):
    """Natural logarithm. ``impl="poly"``: frexp, a Cody-Waite split of
    e * ln 2 and the Cephes polynomial (float32) or rational (float64)."""
    if x.dtype in _16BIT:
        return log(x.to(torch.float32), impl).to(x.dtype)
    x = _f(x)
    if impl == _NATIVE:
        return torch.log(x)
    mant, e = _frexp(x)
    e = e.to(x.dtype)
    small = mant < 0.70710678118654752440  # sqrt(0.5)
    mant = torch.where(small, 2.0 * mant, mant)
    e = torch.where(small, e - 1.0, e)
    m = mant - 1.0
    if x.dtype == torch.float64:
        pp = P.horner(m, list(reversed(_LOG_P_F64)))
        # Q is monic (leading coefficient 1), Cephes p1evl convention.
        qq = P.horner(m, list(reversed(_LOG_Q_F64)) + [1.0])
        z = m * m
        y = m * (z * pp / qq)
        y = y - 0.5 * z
    else:
        z = m * m
        p = P.poly8(m, *reversed(_LOGCOF_F32))
        y = m * z * p
        y = y - 0.5 * z
    # e*ln2 in two parts: the small correction folds into the small
    # accumulator y BEFORE the m+y sum, and the big part (e*0.693359375 is
    # EXACT: 9-bit constant times a small integer) is added last
    y = y + e * (-2.121944400546905827679e-4)
    r = m + y
    r = r + e * 0.693359375
    r = torch.where(x == 0.0, -math.inf, r)
    r = torch.where(x < 0.0, math.nan, r)
    r = torch.where(torch.isinf(x) & (x > 0), math.inf, r)
    # NaN passes every guard above (all comparisons False) while frexp
    # strips its exponent into a finite mantissa
    r = torch.where(x != x, x, r)
    return r
