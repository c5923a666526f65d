"""The plain reference of the ``histogram`` configuration: upstream
Enoki's histogram mini-app (``tests/histogram.cpp``) worked out again in
plain PyTorch, from the published algorithms, to judge what the program
produced:

* PCG32 (O'Neill, pcg-random.org; Enoki's ``random.h``) on int64 tensors
  holding the bit patterns of uint64: ``seed`` as ``PCG32(initstate,
  initseq)`` with ``initseq = arange(n) + PCG32_DEFAULT_STREAM``, ``step``
  (the LCG and the XSH-RR output), ``advance`` (Brown's jump ahead);
* the uniform ``(x >> 9) | 0x3f800000`` read as a float, less 1;
* the probit ``erfinv(2u - 1) * sqrt(2)`` in float64, where the program
  takes float32 (``dtype`` gives another, for the control);
* the bin ``floor((g - lo) * bins / (hi - lo))`` in float64, the lanes
  outside [lo, hi) dropped, counted by ``torch.bincount``;
* beside each bin's count ``r_b`` its band ``a_b``: the lanes whose
  float64 probit lies within ``delta`` of either edge of the bin, which
  a float32 probit off by at most ``delta`` may put in the neighbouring
  bin (or drop, at the outer edges).

Nothing here imports the program under test. Lanes are worked in blocks
of ``BLOCK`` so that the float64 arrays stay small on the card.
"""

from __future__ import annotations

import math

import torch

DEFAULT_STATE = 0x853C49E6748FEA9B
DEFAULT_STREAM = 0xDA3E39CB94B95BDB
MULT = 0x5851F42D4C957F2D
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
BLOCK = 1 << 22


def i64(value: int) -> int:
    """The int64 whose bit pattern is the uint64 ``value``."""
    value &= M64
    return value - (1 << 64) if value >> 63 else value


def shr(x, k: int):
    """The logical right shift of uint64 bit patterns held in int64, for
    0 < k < 64 (``>>`` on int64 is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def step(state, inc):
    """One LCG step and the XSH-RR output: (the 32-bit draw in an int64,
    the next state)."""
    new = state * i64(MULT) + inc
    xs = shr(shr(state, 18) ^ state, 27) & M32
    rot = shr(state, 59)
    out = ((xs >> rot) | (xs << ((32 - rot) & 31))) & M32
    return out, new


def seed(n: int, initstate: int, device):
    """(state, inc) of ``n`` lanes: ``inc = (initseq << 1) | 1``, a step
    from state 0, ``initstate`` added, another step."""
    seq = torch.arange(n, dtype=torch.int64, device=device) + i64(
        DEFAULT_STREAM)
    inc = (seq << 1) | 1
    _, state = step(torch.zeros_like(inc), inc)
    _, state = step(state + i64(initstate), inc)
    return state, inc


def advance(state, inc, delta: int):
    """The state ``delta`` steps on (Brown, "Random number generation with
    arbitrary strides", 1994): the step's affine map raised to ``delta``
    by squaring."""
    cur_mult = torch.full_like(state, i64(MULT))
    cur_plus = inc
    acc_mult = torch.ones_like(state)
    acc_plus = torch.zeros_like(state)
    delta &= M64
    while delta:
        if delta & 1:
            acc_mult = acc_mult * cur_mult
            acc_plus = acc_plus * cur_mult + cur_plus
        cur_plus = (cur_mult + 1) * cur_plus
        cur_mult = cur_mult * cur_mult
        delta >>= 1
    return acc_mult * state + acc_plus


def uniform(bits):
    """The draw's [0, 1) float, exact in float64: its 23 high bits over
    2^23 (what ``(x >> 9) | 0x3f800000`` less 1 is in float32)."""
    return (bits >> 9).to(torch.float64) * 2.0 ** -23


def probit(u, dtype=torch.float64):
    """``erfinv(2u - 1) * sqrt(2)`` computed in ``dtype``, as float64 (2u
    - 1 is exact in float64: u has 23 bits)."""
    x = (2.0 * u - 1.0).to(dtype)
    return (torch.special.erfinv(x) * math.sqrt(2.0)).to(torch.float64)


def scaled(g, lo: float, hi: float, bins: int):
    """The sample's place on the bins' axis: bin b spans [b, b + 1)."""
    return (g - lo) * (bins / (hi - lo))


def histogram(state, inc, lo: float, hi: float, bins: int, delta: float,
              dtype=torch.float64, block: int = BLOCK):
    """(r, a) of one draw a lane from ``state``: ``r_b`` the lanes in bin
    b, ``a_b`` the lanes within ``delta`` of an edge of bin b; both int64
    of ``bins``."""
    r = torch.zeros(bins, dtype=torch.int64, device=state.device)
    edges = torch.zeros(bins + 1, dtype=torch.int64, device=state.device)
    width = delta * bins / (hi - lo)
    for i in range(0, state.numel(), block):
        bits, _ = step(state[i:i + block], inc[i:i + block])
        t = scaled(probit(uniform(bits), dtype), lo, hi, bins)
        inside = (t >= 0) & (t < bins)   # false for NaN and +-inf
        r += torch.bincount(t[inside].floor().long(), minlength=bins)
        j = t.round()
        near = ((t - j).abs() <= width) & (j >= 0) & (j <= bins)
        edges += torch.bincount(j[near].long(), minlength=bins + 1)
    # a lane near edge j may land in bin j - 1 or bin j
    return r, edges[:-1] + edges[1:]


def count_gap(counts, r, a) -> float:
    """``max_b max(0, |c_b - r_b| - a_b)``: the lanes a bin holds beyond
    what the probit's error can move."""
    d = (counts.double().cpu() - r.double().cpu()).abs() - a.double().cpu()
    return float(d.max().clamp_min(0.0))
