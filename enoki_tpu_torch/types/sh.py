"""Real spherical harmonics, orders 0..9 (counterpart of
enoki_tpu/types/sh.py).

Parity with reference include/enoki/sh.h (generated code after P.-P.
Sloan, "Efficient Spherical Harmonic Evaluation", JCGT 2013), through the
same recurrences as the reference: straight-line arithmetic with no
trigonometry.

Convention (the reference's and Sloan's):
  * the input is a *unit* direction d = (x, y, z);
  * the output is (order+1)^2 coefficients indexed l*(l+1) + m, l in
    [0, order], m in [-l, l];
  * the real SH basis y_l^m = K_l^m P_l^m(z) * {sqrt(2) cos(m phi) (m>0),
    1 (m=0), sqrt(2) sin(|m| phi) (m<0)}, with P_l^m's Condon-Shortley
    phase, the sin / cos terms built from powers of (x + iy).

The constants K_l^m are Python floats (double), as in the reference. A
division by the recurrence's integer l - m divides by a 0-d tensor (one
IEEE division on every device). The reference's lazy branch waits for the
port of trace/ and raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import math

import torch

from ..ops import backend as B
from ..ops.math import _floats, _scalar


def _K(l: int, m: int) -> float:  # noqa: E741
    """SH normalization constant K_l^m (host-side python float)."""
    m = abs(m)
    num = (2 * l + 1) * math.factorial(l - m)
    den = 4 * math.pi * math.factorial(l + m)
    return math.sqrt(num / den)


def sh_eval(x, y, z, order: int):
    """Evaluate all real SH bands 0..order at unit directions (x, y, z).

    Returns a list of (order+1)^2 tensors (SoA: one per coefficient),
    index l*(l+1)+m, as sh_eval's output array (sh.h:25-38).
    """
    if order > 9:
        raise ValueError("sh_eval(): order too high (max 9, sh.h:37)")
    B.require_eager(x, y, z)
    # one promotion decision for all three components
    vs = _floats(x, y, z)
    dt = functools.reduce(torch.promote_types, (v.dtype for v in vs))
    x, y, z = (v.to(dt) for v in vs)

    n = (order + 1) ** 2
    out = [None] * n

    # P_l^m(z) through stable recurrences with sin^m(theta) factored out:
    # Pb_m^m = (sin theta)^-m * P_m^m (a constant times a product of odd
    # numbers), recursed in l at fixed m; the sin^m factor is folded into
    # the incremental (cos m phi, sin m phi) pair,
    #   c_m + i s_m = (x + i y)^m == sin^m(theta) (cos m phi + i sin m phi)
    one = z * 0.0 + 1.0

    # incremental (x + iy)^m
    cm = one
    sm = z * 0.0

    # pmm = Pb_m^m, a Python float
    pmm_scale = 1.0
    for m in range(0, order + 1):
        if m > 0:
            cm, sm = x * cm - y * sm, x * sm + y * cm
            pmm_scale *= -(2 * m - 1)

        # l = m band
        pb_prev = one * pmm_scale
        _store(out, m, m, pb_prev, cm, sm)

        if m == order:
            break

        # l = m + 1: Pb_{m+1}^m = z (2m + 1) Pb_m^m
        pb = z * (2 * m + 1) * pmm_scale
        _store(out, m + 1, m, pb, cm, sm)

        # upward recurrence in l
        pb_prev2 = pb_prev
        for l in range(m + 2, order + 1):  # noqa: E741
            pb_new = (((2 * l - 1) * z * pb - (l + m - 1) * pb_prev2)
                      / _scalar(z, l - m))
            pb_prev2 = pb
            pb = pb_new
            _store(out, l, m, pb, cm, sm)

    return out


def _store(out, l: int, m: int, pb, cm, sm):  # noqa: E741
    """Write the +/-m pair (or the m=0 entry) for band l."""
    k = _K(l, m)
    if m == 0:
        out[l * (l + 1)] = k * pb
    else:
        sqrt2 = math.sqrt(2.0)
        out[l * (l + 1) + m] = sqrt2 * k * pb * cm
        out[l * (l + 1) - m] = sqrt2 * k * pb * sm


def sh_eval_stacked(x, y, z, order: int):
    """sh_eval stacked into one (..., (order+1)^2) tensor."""
    return torch.stack(sh_eval(x, y, z, order), dim=-1)
