"""64-bit unsigned integers over one int64 tensor (counterpart of
enoki_tpu/types/u64.py).

The reference emulates a u64 as a (hi, lo) pair of uint32 arrays because
its target has no 64-bit integer lanes. A GPU has them, so here a ``U64``
wraps a single ``torch.int64`` tensor that holds the 64 bits as a two's
complement pattern: ``+``, ``-`` and ``*`` wrap around exactly as unsigned
arithmetic does, and only what depends on the sign needs care: a right
shift must be logical (``shr``, ``shr_dyn`` mask the sign extension away)
and an order comparison unsigned (``lt``, ``ge`` flip the sign bit first).

The API is the reference's, so that the PCG32 code reads the same:
``U64`` with ``.hi`` / ``.lo`` (the 32-bit halves, as int64 tensors with
values in [0, 2**32)), ``u64``, ``from_py``, ``from_u32``, ``to_py``,
``add``, ``add_u32``, ``sub``, ``mul``, ``mul_u64_u32``, ``xor``, ``or_``,
``and_``, ``shr``, ``shl``, ``shr_dyn``, ``where``, ``eq``, ``ne``,
``is_zero``, ``zeros``, ``ones_bit``; ``lt`` and ``ge`` come on top.
A 32-bit operand (``add_u32``, ``mul_u64_u32``, ``from_u32``) may be an
int64 tensor in [0, 2**32), an int32 bit pattern, or a Python int.

The lazy (``LazyArray``) components of the reference wait for the port of
``trace/``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .._device import resolve_device

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_SIGN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _signed(value: int) -> int:
    """The int64 (two's complement) reading of a 64-bit pattern."""
    value &= _M64
    return value - (1 << 64) if value >> 63 else value


class U64(NamedTuple):
    """64 bits per lane in one int64 tensor ``v``."""

    v: torch.Tensor

    @property
    def hi(self):
        """Upper 32 bits, int64 in [0, 2**32)."""
        return (self.v >> 32) & _M32

    @property
    def lo(self):
        """Lower 32 bits, int64 in [0, 2**32)."""
        return self.v & _M32

    @property
    def shape(self):
        return self.v.shape


def _u32(x):
    """A 32-bit operand as an int64 tensor (or Python int) in [0, 2**32)."""
    if isinstance(x, int):
        return x & _M32
    return x.to(torch.int64) & _M32


def u64(hi, lo) -> U64:
    """The value ``hi * 2**32 + lo`` from two 32-bit halves."""
    hi, lo = _u32(hi), _u32(lo)
    if isinstance(hi, int) and isinstance(lo, int):
        raise TypeError("u64 takes at least one tensor; from_py takes ints")
    return U64((hi << 32) | lo)


def from_py(value: int, shape=(), device=None) -> U64:
    """A 64-bit constant on ``device`` (cuda by default)."""
    return U64(torch.full(tuple(shape), _signed(value), dtype=torch.int64,
                          device=resolve_device(device)))


def from_u32(x) -> U64:
    return U64(_u32(x))


def to_py(x: U64) -> np.ndarray:
    """Host-side conversion to a numpy uint64 array (for tests)."""
    return x.v.detach().cpu().numpy().view(np.uint64)


def add(a: U64, b: U64) -> U64:
    return U64(a.v + b.v)


def add_u32(a: U64, b) -> U64:
    return U64(a.v + _u32(b))


def sub(a: U64, b: U64) -> U64:
    return U64(a.v - b.v)


def mul(a: U64, b: U64) -> U64:
    """Low 64 bits of the 64x64 product (what PCG32's LCG step needs)."""
    return U64(a.v * b.v)


def mul_u64_u32(a: U64, b) -> U64:
    return U64(a.v * _u32(b))


def xor(a: U64, b: U64) -> U64:
    return U64(a.v ^ b.v)


def or_(a: U64, b: U64) -> U64:
    return U64(a.v | b.v)


def and_(a: U64, b: U64) -> U64:
    return U64(a.v & b.v)


def shr(a: U64, k: int) -> U64:
    """Logical right shift by a static amount: int64's ``>>`` copies the
    sign bit into the vacated bits, the mask clears them."""
    if k == 0:
        return a
    if k >= 64:
        return U64(torch.zeros_like(a.v))
    return U64((a.v >> k) & ((1 << (64 - k)) - 1))


def shl(a: U64, k: int) -> U64:
    if k == 0:
        return a
    if k >= 64:
        return U64(torch.zeros_like(a.v))
    return U64(a.v << k)


def shr_dyn(a: U64, k) -> U64:
    """Logical right shift by a per-lane amount in [0, 63]: one logical
    step first (shift, clear the sign copy), the other k - 1 are then
    shifts of a non-negative number."""
    k = _u32(k)
    if isinstance(k, int):
        return shr(a, k)
    rest = ((a.v >> 1) & _I64_MAX) >> torch.clamp_min(k - 1, 0)
    return U64(torch.where(k == 0, a.v, rest))


def where(mask, a: U64, b: U64) -> U64:
    return U64(torch.where(mask, a.v, b.v))


def eq(a: U64, b: U64):
    return a.v == b.v


def ne(a: U64, b: U64):
    return a.v != b.v


def lt(a: U64, b: U64):
    """Unsigned ``a < b``: flipping the sign bit maps unsigned order onto
    int64's."""
    return (a.v ^ _SIGN) < (b.v ^ _SIGN)


def ge(a: U64, b: U64):
    """Unsigned ``a >= b``."""
    return (a.v ^ _SIGN) >= (b.v ^ _SIGN)


def is_zero(a: U64):
    return a.v == 0


def zeros(shape=(), device=None) -> U64:
    return U64(torch.zeros(tuple(shape), dtype=torch.int64,
                           device=resolve_device(device)))


def ones_bit(a: U64):
    """Lowest bit, int64 0 or 1 (delta & 1 in PCG32 advance)."""
    return a.v & 1


# a NamedTuple is a pytree node already; the name lets a treespec holding
# one be written to disk (runtime.checkpoint)
pytree._register_namedtuple(
    U64, serialized_type_name="enoki_tpu_torch.types.u64.U64")
