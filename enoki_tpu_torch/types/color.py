"""sRGB <-> linear conversions (counterpart of enoki_tpu/types/color.py).

Parity with reference include/enoki/color.h: linear_to_srgb (:20) and
srgb_to_linear (:58), the exact piecewise IEC 61966-2-1 curves, with
``pow`` through ``ops.math`` (``impl="native"`` PyTorch's, ``"poly"`` the
reference's polynomials). Integer inputs are taken as float32, and every
constant takes the input's dtype, as a weakly typed scalar does in the
reference. A ``trace.LazyArray`` input records the curves into the trace
(``backend.math_ns`` gives the trace's opcodes, whatever ``impl``).
"""

from __future__ import annotations

from ..ops import backend as B
from ..ops.math import _f, _scalar


def linear_to_srgb(x, impl="native"):
    g = B.math_ns(x, impl)
    x = _f(x)
    lin = x * _scalar(x, 12.92)
    nonlin = (_scalar(x, 1.055) * g.pow(g.maximum(x, 1e-8), 1.0 / 2.4)
              - _scalar(x, 0.055))
    return g.select(x <= _scalar(x, 0.0031308), lin, nonlin)


def srgb_to_linear(x, impl="native"):
    g = B.math_ns(x, impl)
    x = _f(x)
    lin = x * _scalar(x, 1.0 / 12.92)
    nonlin = g.pow(g.maximum((x + _scalar(x, 0.055))
                             * _scalar(x, 1.0 / 1.055), 1e-8), 2.4)
    return g.select(x <= _scalar(x, 0.04045), lin, nonlin)
