"""Arrays of enum values (counterpart of enoki_tpu/types/enum_array.py).

Parity with reference include/enoki/array_enum.h:16-82: enums are stored
as their underlying integer type; comparisons and selects work lanewise
and values convert losslessly back to the Python enum.

The storage dtype is the first of int32, uint32 and int64 that holds every
value. The reference takes int64 or uint64 only with JAX's 64-bit types
on; the port has int64 always and no uint64 (``ops.router``'s rule (j)),
so a value of 2**63 or more raises ``OverflowError``.
"""

from __future__ import annotations

import enum
from typing import Type

import torch

from .._device import resolve_device


def _storage_dtype(vals):
    """The first lane dtype of int32, uint32, int64 that holds every value
    losslessly (the array_enum.h 'underlying integer type' contract; int32
    alone would overflow e.g. a 1 << 31 flag)."""
    lo = min(vals, default=0)
    hi = max(vals, default=0)
    if -(1 << 31) <= lo and hi < (1 << 31):
        return torch.int32
    if 0 <= lo and hi < (1 << 32):
        return torch.uint32
    if -(1 << 63) <= lo and hi < (1 << 63):
        return torch.int64
    raise OverflowError(
        f"enum values span [{lo}, {hi}], which needs a uint64 lane dtype "
        "(the port has none)")


def enum_array(values, enum_cls: Type[enum.IntEnum], device=None):
    """Build a lane array from enum members / ints (lossless storage) on
    ``device`` (None: the card, or raise)."""
    vals = [int(v) for v in values]
    return torch.tensor(vals, dtype=_storage_dtype(vals),
                        device=resolve_device(device))


def enum_full(value: enum.IntEnum, shape, device=None):
    v = int(value)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.full(shape, v, dtype=_storage_dtype([v]),
                      device=resolve_device(device))


def enum_eq(arr, value: enum.IntEnum):
    """Lanewise ``arr == value``, compared in int64 (PyTorch has no
    compares for UInt32)."""
    return arr.to(torch.int64) == int(value)


def to_enum_list(arr, enum_cls: Type[enum.IntEnum]):
    """Host-side conversion back to enum members."""
    return [enum_cls(int(v)) for v in arr.to(torch.int64).tolist()]
