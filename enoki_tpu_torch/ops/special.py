"""Special functions (counterpart of enoki_tpu/ops/special.py), of which
only ``erfinv`` is ported so far: the histogram mini-app maps uniform
samples to a normal distribution with it.

``impl="native"`` is ``torch.special.erfinv``; ``impl="poly"`` is the
reference's Giles (2011) single-precision fit, coefficient for
coefficient, on top of ``ops.math.log(.., "poly")``. The two packages'
native functions are different approximations, so a comparison of the two
packages goes through ``"poly"`` on both sides. The lazy (``LazyArray``)
instantiation of the reference waits for the port of ``trace/``.
"""

from __future__ import annotations

import math

import torch

from . import polys as P
from .math import _f, log as _log

_NATIVE = "native"
_POLY = "poly"

_ERFINV_P1 = (1.50140941, 0.246640727, -0.00417768164, -0.00125372503,
              0.00021858087, -4.39150654e-06, -3.5233877e-06,
              3.43273939e-07, 2.81022636e-08)  # low -> high in (w - 2.5)
_ERFINV_P2 = (2.83297682, 1.00167406, 0.00943887047, -0.0076224613,
              0.00573950773, -0.00367342844, 0.00134934322,
              0.000100950558, -0.000200214257)  # low -> high in (sqrt(w) - 3)


def erfinv(x, impl=_NATIVE):
    """Inverse error function; erfinv(+-1) = +-inf."""
    x = _f(x)
    if impl == _NATIVE:
        return torch.special.erfinv(x)
    w = -_log((1.0 - x) * (1.0 + x), _POLY)
    w1 = w - 2.5
    w2 = torch.sqrt(torch.clamp_min(w, 0.0)) - 3.0
    p1 = P.poly8(w1, *_ERFINV_P1)
    p2 = P.poly8(w2, *_ERFINV_P2)
    y = torch.where(w < 5.0, p1, p2) * x
    if x.dtype != torch.float64:
        # erfinv(+-1) = +-inf: w = -log(0) = inf and poly8(inf) mixes
        # +-inf terms into NaN
        return torch.where(x.abs() == 1.0,
                           torch.copysign(torch.full_like(x, math.inf), x),
                           y)
    # float64: the Giles fit is a ~1e-7 seed; two Newton steps square the
    # error to full double precision. In the tail (|x| > 0.5) Newton runs
    # on the complementary equation erfc(y) = 1 - |x|: the direct form
    # cancels catastrophically when erf(y) and x are both ~1.
    half_sqrt_pi = 0.8862269254527580137
    a = x.abs()
    c = 1.0 - a  # exact for a in [0.5, 1] (Sterbenz)
    tail = a > 0.5
    ya = y.abs()
    for _ in range(2):
        scale = half_sqrt_pi * torch.exp(ya * ya)
        step_mid = -(torch.special.erf(ya) - a) * scale
        step_tail = (torch.special.erfc(ya) - c) * scale
        ya = ya + torch.where(tail, step_tail, step_mid)
    y = torch.where(a == 1.0, math.inf, ya)
    return torch.copysign(y, x)
