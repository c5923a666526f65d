"""Vectorized PCG32 random number generator (counterpart of
enoki_tpu/types/random.py).

Bit-exact with the reference's vectorized PCG32 (the PCG scheme is by
Melissa O'Neill, pcg-random.org): a generator with N lanes produces N
independent streams, seeded ``initseq = arange(N) + PCG32_DEFAULT_STREAM``.
State and increment are one int64 tensor each (``types/u64.py``): the
(hi, lo) uint32 emulation of the reference exists for a target without
64-bit integer lanes. The API stays functional, ``value, gen =
gen.next_uint32()``, so that the two packages compare call by call.

What each draw returns:
  next_uint32, next_uint32_bounded   int64 tensor with values in [0, 2**32)
  next_uint64, next_uint64_bounded   a ``U64`` (int64 bit pattern)
  next_float32 / next_float64        float32 / float64 in [0, 1)
  distance                           int32 (the low 32 bits, wrapped)
  distance_u64                       a ``U64``

The bounded draws and ``shuffle`` read their loop condition on the host,
one synchronisation per round: they are for small sizes. The lazy
(``LazyArray``) generator of the reference (``create_lazy``) waits for the
port of ``trace/``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from . import u64 as U
from .._device import resolve_device

PCG32_DEFAULT_STATE = 0x853C49E6748FEA9B
PCG32_DEFAULT_STREAM = 0xDA3E39CB94B95BDB
PCG32_MULT = 0x5851F42D4C957F2D

_M32 = 0xFFFFFFFF


class PCG32(NamedTuple):
    """Functional PCG32: all methods return (result, new_generator)."""

    state: U.U64
    inc: U.U64

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(size: Optional[int] = None,
               initstate=PCG32_DEFAULT_STATE, initseq=None,
               device=None) -> "PCG32":
        """Matches PCG32(initstate, initseq): per-lane streams via
        ``initseq = arange(size) + DEFAULT_STREAM``. ``initstate`` and
        ``initseq`` may be Python ints or ``U64``s; tensors are made on
        ``device`` (cuda by default)."""
        device = resolve_device(device)
        shape = () if size is None else (size,)
        if initseq is None:
            seq = U.from_py(PCG32_DEFAULT_STREAM, shape, device)
            if size is not None:
                lane = torch.arange(size, dtype=torch.int64, device=device)
                seq = U.add(seq, U.U64(lane))
        elif isinstance(initseq, int):
            seq = U.from_py(initseq, shape, device)
        else:
            seq = initseq
        if isinstance(initstate, int):
            st = U.from_py(initstate, shape, device)
        else:
            st = initstate
        return PCG32._seed(st, seq)

    @staticmethod
    def _seed(initstate: U.U64, initseq: U.U64) -> "PCG32":
        """seed(): state = 0; inc = (initseq << 1) | 1; round;
        state += initstate; round."""
        inc = U.U64(U.shl(initseq, 1).v | 1)
        gen = PCG32(U.U64(torch.zeros_like(inc.v)), inc)
        _, gen = gen.next_uint32()
        gen = PCG32(U.add(gen.state, initstate), gen.inc)
        _, gen = gen.next_uint32()
        return gen

    @property
    def shape(self):
        return self.state.v.shape

    @property
    def device(self):
        return self.state.v.device

    def _const(self, value: int) -> U.U64:
        """A 64-bit constant that broadcasts against the lanes."""
        return U.from_py(value, (), self.device)

    # -- core output function ---------------------------------------------

    def _step(self) -> Tuple[torch.Tensor, U.U64]:
        """One LCG step + XSH-RR output permutation."""
        oldstate = self.state
        new_state = U.add(U.mul(oldstate, self._const(PCG32_MULT)), self.inc)
        # xorshifted = uint32(((oldstate >> 18) ^ oldstate) >> 27)
        xs = U.shr(U.xor(U.shr(oldstate, 18), oldstate), 27).lo
        rot = U.shr(oldstate, 59).v
        # a 32-bit rotate held in 64 bits: cut back to 32 (rot = 0 shifts
        # by 0 on both sides and gives xs)
        out = ((xs >> rot) | (xs << ((32 - rot) & 31))) & _M32
        return out, new_state

    def next_uint32(self, mask=None) -> Tuple[torch.Tensor, "PCG32"]:
        """The next 32-bit draw; with ``mask``, inactive lanes do not
        advance."""
        out, new_state = self._step()
        if mask is not None:
            new_state = U.where(mask, new_state, self.state)
        return out, PCG32(new_state, self.inc)

    def next_uint64(self, mask=None) -> Tuple[U.U64, "PCG32"]:
        """Two draws, the low word first."""
        lo, gen = self.next_uint32(mask)
        hi, gen = gen.next_uint32(mask)
        return U.u64(hi, lo), gen

    def next_float32(self, mask=None) -> Tuple[torch.Tensor, "PCG32"]:
        """[0, 1) via the (x >> 9) | 0x3f800000 bit trick."""
        bits, gen = self.next_uint32(mask)
        pattern = ((bits >> 9) | 0x3F800000).to(torch.int32)
        return pattern.view(torch.float32) - 1.0, gen

    def next_float64(self, mask=None):
        """[0, 1) with 32 mantissa bits."""
        bits, gen = self.next_uint32(mask)
        pattern = (bits << 20) | 0x3FF0000000000000
        return pattern.view(torch.float64) - 1.0, gen

    def next_uint32_bounded(self, bound: int, mask=None):
        """Unbiased bounded sampling: lanes redraw until they clear the
        rejection threshold. ``bound`` is a Python int."""
        threshold = ((~bound + 1) & _M32) % bound
        active = (torch.ones(self.shape, dtype=torch.bool, device=self.device)
                  if mask is None else mask)
        result = torch.zeros(self.shape, dtype=torch.int64,
                             device=self.device)
        gen = self
        while bool(active.any()):
            draw, gen = gen.next_uint32(
                mask=active if mask is None else active & mask)
            result = torch.where(active, draw, result)
            active = active & (draw < threshold)
        return result % bound, gen

    def advance(self, delta: int) -> "PCG32":
        """Jump ahead or back by ``delta`` steps (Brown's fast
        exponentiation); a negative ``delta`` goes the long way round."""
        delta &= (1 << 64) - 1
        cur_mult = self._const(PCG32_MULT)
        cur_plus = self.inc
        acc_mult = self._const(1)
        acc_plus = self._const(0)
        one = self._const(1)
        while delta:
            if delta & 1:
                acc_mult = U.mul(acc_mult, cur_mult)
                acc_plus = U.add(U.mul(acc_plus, cur_mult), cur_plus)
            cur_plus = U.mul(U.add(cur_mult, one), cur_plus)
            cur_mult = U.mul(cur_mult, cur_mult)
            delta >>= 1
        return PCG32(U.add(U.mul(acc_mult, self.state), acc_plus), self.inc)

    def distance(self, other: "PCG32") -> torch.Tensor:
        """Number of steps between two generators on the same stream, the
        low 32 bits per lane as int32 (``distance_u64`` has all 64)."""
        lo = self.distance_u64(other).lo
        return ((lo ^ 0x80000000) - 0x80000000).to(torch.int32)

    def distance_u64(self, other: "PCG32") -> U.U64:
        """Brown's bit-by-bit distance algorithm, 64 rounds."""
        cur_mult = self._const(PCG32_MULT)
        cur_plus = self.inc
        cur_state = other.state
        distance = U.U64(torch.zeros_like(self.state.v))
        one = self._const(1)
        for bit in range(64):
            the_bit = self._const(1 << bit)
            differ = ~U.is_zero(U.and_(U.xor(self.state, cur_state),
                                       the_bit))
            step = U.add(U.mul(cur_state, cur_mult), cur_plus)
            cur_state = U.where(differ, step, cur_state)
            distance = U.where(differ, U.or_(distance, the_bit), distance)
            cur_plus = U.mul(U.add(cur_mult, one), cur_plus)
            cur_mult = U.mul(cur_mult, cur_mult)
        return distance

    def next_uint64_bounded(self, bound: int, mask=None):
        """Unbiased bounded 64-bit sampling; ``bound`` is a Python int
        below 2**63."""
        threshold = self._const(((~bound + 1) & ((1 << 64) - 1)) % bound)
        active = (torch.ones(self.shape, dtype=torch.bool, device=self.device)
                  if mask is None else mask)
        result = U.U64(torch.zeros_like(self.state.v))
        gen = self
        while bool(active.any()):
            draw, gen = gen.next_uint64(mask=active)
            result = U.where(active, draw, result)
            active = active & U.lt(draw, threshold)
        return _u64_mod_const(result, bound), gen

    def shuffle(self, x: torch.Tensor) -> Tuple[torch.Tensor, "PCG32"]:
        """Fisher-Yates shuffle of ``x`` along its first axis with lane
        0's stream; returns a new tensor. Each of the n - 1 steps reads its
        index on the host."""
        x = x.clone()
        gen = self
        for i in range(x.shape[0] - 1, 0, -1):
            j, gen = gen.next_uint32_bounded(i + 1)
            j0 = int(j.reshape(-1)[0])
            xi, xj = x[i].clone(), x[j0].clone()
            x[i], x[j0] = xj, xi
        return x, gen


def _u64_mod_const(value: U.U64, bound: int) -> U.U64:
    """Unsigned ``value mod bound`` for a Python ``bound`` below 2**63.
    int64's ``%`` is signed, so the value is halved first (a logical
    shift, which makes it non-negative): with h = value >> 1,
    value = 2 h + bit and value mod b = (2 (h mod b) + bit) mod b, where
    2 (h mod b) + bit < 2 b needs at most one subtraction, compared
    unsigned because it may pass 2**63."""
    v = value.v
    r = (((v >> 1) & ((1 << 63) - 1)) % bound) * 2 + (v & 1)
    b = torch.full_like(v, bound)
    return U.U64(torch.where(U.ge(U.U64(r), U.U64(b)), r - b, r))


def uniform(gen: PCG32, shape=None, dtype=torch.float32):
    """Draw a [0, 1) tensor, ONE draw per generator lane (the output shape
    is the generator's shape); returns (values, new generator). A
    mismatched ``shape`` raises; 2-byte float dtypes are drawn at f32
    precision and cast."""
    if shape is not None:
        want = (tuple(shape) if isinstance(shape, (tuple, list))
                else (int(shape),))
        have = tuple(gen.shape)
        if want != have:
            raise ValueError(
                f"uniform: shape {want} != generator lanes {have}; "
                "PCG32 draws one sample per lane -- size the generator "
                "(PCG32.create(size)) instead of the draw")
    if dtype == torch.float64:
        return gen.next_float64()
    val, gen2 = gen.next_float32()
    if dtype not in (torch.float32, None):
        val = val.to(dtype)
    return val, gen2


# a NamedTuple is a pytree node already; the name lets a treespec holding
# one be written to disk (runtime.checkpoint)
pytree._register_namedtuple(
    PCG32, serialized_type_name="enoki_tpu_torch.types.random.PCG32")
