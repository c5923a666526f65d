"""Morton / Z-order curve encoding for N-dimensional unsigned coordinates
(counterpart of enoki_tpu/types/morton.py).

Parity with reference include/enoki/morton.h:28-150 through its
magic-mask shift cascade (the reference's fallback where there is no BMI2
pdep/pext); the masks are the ``morton_magic`` constexpr (morton.h:28-46)
computed on the host.

Coordinates are uint32; with D dimensions only the low floor(32/D) bits of
each coordinate are representable (the reference's contract with a 32-bit
Value). PyTorch has no shifts for UInt32: the cascade runs on the bit
patterns in int64, masked to 32 bits, and the codes and coordinates come
back as uint32. The reference's lazy branch (a LazyArray coordinate) waits
for the port of trace/ and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops import backend as B
from ..ops.router import _asarray, _from_bits

_M32 = 0xFFFFFFFF


def _morton_magic(dim: int, level: int, n_bits: int = 32) -> int:
    """Python port of the mask generator (morton.h:28-46)."""
    max_block_size = n_bits // dim
    block_size = min(1 << (level - 1), max_block_size)
    count = 0
    mask = 1 << (n_bits - 1)
    value = 0
    for i in range(n_bits):
        value >>= 1
        if count < max_block_size and (i // block_size) % dim == 0:
            count += 1
            value |= mask
    return value


def _scatter_bits(x, dim: int, n_bits: int = 32):
    """Spread the low bits of x (int64 holding a 32-bit pattern) so that
    consecutive bits land ``dim`` apart (morton.h:49-68 shift cascade)."""
    if dim == 1:
        return x
    level = n_bits.bit_length() - 1  # clog2i(32) = 5
    for lv in range(level, 0, -1):
        magic = _morton_magic(dim, lv, n_bits)
        shift = (1 << (lv - 1)) * (dim - 1)
        if shift < n_bits:
            x = x | (x << shift)
        x = x & magic
    return x


def _gather_bits(x, dim: int, n_bits: int = 32):
    """Inverse of _scatter_bits (morton.h:71-93)."""
    if dim == 1:
        return x
    level = n_bits.bit_length() - 1
    for lv in range(level, 0, -1):
        ilevel = level - lv + 1
        magic = _morton_magic(dim, ilevel, n_bits)
        shift = (1 << (ilevel - 1)) * (dim - 1)
        x = x & magic
        if shift < n_bits:
            x = x | (x >> shift)
    return x


def _u32_bits(c, like=None):
    """``jnp.asarray(c, jnp.uint32)`` as its bit pattern in int64; a
    Python value goes to ``like``'s device, or the card."""
    c = c if isinstance(c, torch.Tensor) else _asarray(c, like)
    return c.to(torch.int64) & _M32


def morton_encode(coords: Sequence) -> torch.Tensor:
    """Interleave N uint32 coordinate arrays into Morton codes
    (morton.h:135-143). ``coords[0]`` holds the least-significant bits."""
    B.require_eager(*coords)
    like = next((c.device for c in coords if isinstance(c, torch.Tensor)),
                None)
    coords = [_u32_bits(c, like) for c in coords]
    dim = len(coords)
    out = _scatter_bits(coords[0], dim)
    for i in range(1, dim):
        out = out | (_scatter_bits(coords[i], dim) << i)
    return _from_bits(out, torch.uint32)


def morton_decode(value, dim: int) -> Tuple[torch.Tensor, ...]:
    """De-interleave Morton codes into ``dim`` uint32 coordinate arrays
    (morton.h:146-150)."""
    B.require_eager(value)
    value = _u32_bits(value)
    return tuple(_from_bits(_gather_bits(value >> i, dim), torch.uint32)
                 for i in range(dim))
