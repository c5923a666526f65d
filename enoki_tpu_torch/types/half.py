"""Half-precision storage helpers (counterpart of enoki_tpu/types/half.py).

Parity with reference include/enoki/half.h: a storage-only 16-bit float
with conversion to/from float32 (:29, :112, :136). IEEE float16 and
bfloat16 are both exposed; the conversions round to nearest even, and the
bit casts are views of the same 16 bits.

XLA's CPU backend flushes float32 subnormals, PyTorch and the card keep
them (docs/port.md): a float32 subnormal rounds to a bfloat16
subnormal here, to 0 in the reference on the CPU.
"""

from __future__ import annotations

import torch

from .._device import resolve_device


def _as(x, dtype):
    """``jnp.asarray(x, dtype)``: a tensor converted, a Python value made
    on the card (or raise)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(None))


def float_to_half(x):
    """float32 -> float16, round to nearest even."""
    return _as(x, torch.float32).to(torch.float16)


def half_to_float(x):
    return _as(x, torch.float16).to(torch.float32)


def float_to_bf16(x):
    return _as(x, torch.float32).to(torch.bfloat16)


def bf16_to_float(x):
    return _as(x, torch.bfloat16).to(torch.float32)


def half_bits(x):
    """The raw uint16 bit pattern of a float16 array (half.h's storage
    view)."""
    return _as(x, torch.float16).view(torch.uint16)


def half_from_bits(bits):
    return _as(bits, torch.uint16).view(torch.float16)
