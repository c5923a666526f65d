"""Integer division by run-time constant divisors through magic
multipliers (counterpart of enoki_tpu/types/idiv.py).

Parity with reference include/enoki/array_idiv.h: precomputed
magic-multiplier division, unsigned (:152) and signed (:191). The divisor
is a Python int known on the host, the reference's model: ``divisor<T>(x)``
precomputes on the CPU and the lanes only do mulhi / shift / add. The magic
constants follow Granlund & Montgomery, "Division by Invariant Integers
using Multiplication" (PLDI '94), as Hacker's Delight ch. 10 gives them.

PyTorch has no shifts or compares for UInt32: a uint32 numerator is taken
through int64 masked to 32 bits (``ops.router``'s rule (j)), and the
results come back as uint32 (``DivisorU32``) or int32 (``DivisorI32``),
the reference's dtypes, with its two's complement wrap-around.
"""

from __future__ import annotations

import torch

from ..ops.router import _asarray, _bits, _from_bits, mulhi


def _u32(n):
    """``jnp.asarray(n, jnp.uint32)``: any integer tensor (or Python
    value, made on the card) taken modulo 2**32, as uint32."""
    n = _asarray(n)
    if n.dtype == torch.uint32:
        return n
    return _from_bits(n.to(torch.int64), torch.uint32)


def _i32(n):
    """``jnp.asarray(n, jnp.int32)``, wrapping as a cast does."""
    n = _asarray(n)
    return n if n.dtype == torch.int32 else _from_bits(n.to(torch.int64),
                                                       torch.int32)


def _const(v, like, dtype):
    """The Python int ``v`` as a 0-d ``dtype`` tensor on ``like``'s
    device (its 32-bit pattern)."""
    return _from_bits(torch.tensor(v, dtype=torch.int64, device=like.device),
                      dtype)


class DivisorU32:
    """Unsigned 32-bit division by a fixed divisor."""

    def __init__(self, d: int):
        if not 0 < d < 2 ** 32:
            raise ValueError("divisor out of range")
        self.d = d
        if d == 1:
            self.magic, self.shift, self.add = 1, 0, False
            return
        # find smallest p >= 32 with 2^p > nc * (d - 1 - (2^p - 1) % d)
        nc = (2 ** 32 // d) * d - 1
        for p in range(32, 65):
            if 2 ** p > nc * (d - 1 - (2 ** p - 1) % d):
                break
        m = (2 ** p + d - 1 - (2 ** p - 1) % d) // d
        if m < 2 ** 32:
            self.magic, self.shift, self.add = m, p - 32, False
        else:
            self.magic, self.shift, self.add = m - 2 ** 32, p - 32, True

    def div(self, n):
        n = _u32(n)
        if self.d == 1:
            return n
        t = _bits(mulhi(n, _const(self.magic, n, torch.uint32)))
        if self.add:
            # q = (((n - t) >> 1) + t) >> (shift - 1)
            q = (((_bits(n) - t) >> 1) + t) >> (self.shift - 1)
        else:
            q = t >> self.shift
        return _from_bits(q, torch.uint32)

    def mod(self, n):
        n = _u32(n)
        return _from_bits(_bits(n) - _bits(self.div(n)) * self.d,
                          torch.uint32)

    __call__ = div


class DivisorI32:
    """Signed 32-bit division by a fixed nonzero divisor (C truncation)."""

    def __init__(self, d: int):
        if d == 0 or not -(2 ** 31) <= d < 2 ** 31:
            raise ValueError("divisor out of range")
        self.d = d
        ad = abs(d)
        if ad == 1:
            self.magic, self.shift = 0, 0
            return
        two31 = 2 ** 31
        t = two31 + (1 if d < 0 else 0)
        anc = t - 1 - t % ad
        p = 31
        q1, r1 = two31 // anc, two31 % anc
        q2, r2 = two31 // ad, two31 % ad
        while True:
            p += 1
            q1, r1 = q1 * 2, r1 * 2
            if r1 >= anc:
                q1 += 1
                r1 -= anc
            q2, r2 = q2 * 2, r2 * 2
            if r2 >= ad:
                q2 += 1
                r2 -= ad
            delta = ad - r2
            if not (q1 < delta or (q1 == delta and r1 == 0)):
                break
        m = q2 + 1
        if d < 0:
            m = -m
        # store as signed 32-bit value
        if m >= 2 ** 31:
            m -= 2 ** 32
        if m < -(2 ** 31):
            m += 2 ** 32
        self.magic, self.shift = m, p - 32

    def div(self, n):
        """n / d rounded toward zero, in int32; computed in int64 and
        wrapped to 32 bits (-INT32_MIN is INT32_MIN, as in the
        reference)."""
        n = _i32(n)
        d = self.d
        if abs(d) == 1:
            return n if d == 1 else _from_bits(-n.to(torch.int64),
                                               torch.int32)
        q = mulhi(n, _const(self.magic, n, torch.int32)).to(torch.int64)
        if d > 0 and self.magic < 0:
            q = q + n
        elif d < 0 and self.magic > 0:
            q = q - n
        q = _from_bits(q, torch.int32).to(torch.int64) >> self.shift
        # add 1 if q negative (round toward zero)
        return _from_bits(q + (q < 0), torch.int32)

    def mod(self, n):
        n = _i32(n)
        return _from_bits(n.to(torch.int64)
                          - self.div(n).to(torch.int64) * self.d,
                          torch.int32)

    __call__ = div


def divisor(d: int, signed: bool = False):
    """array_idiv.h entry point."""
    return DivisorI32(d) if signed else DivisorU32(d)
