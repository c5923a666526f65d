"""Rounding utilities (counterpart of enoki_tpu/ops/rounding.py).

  round_/floor/ceil/trunc     lanewise (round_ = half to even)
  round_half_away             C-style round()
  stochastic_round(x, generator, dtype)
                              unbiased rounding of float32 to bfloat16 or
                              float16 with bits from a ``torch.Generator``
  stochastic_round_from_bits(x, bits, dtype)
                              the same with the random words handed in
  stochastic_round_cuda(x, seed, dtype)
                              the kernel: Philox4x32-10 words made inside
                              a CUDA kernel (csrc/stochastic_round.cu), the
                              counterpart of ``stochastic_round_pallas``;
                              ``stochastic_round_plain`` is its plain
                              version and computes the same bits
  add/sub/mul/div/sqrt_up/_down
                              directed-rounding arithmetic in float32

The contract of every stochastic rounding here: the result is one of the
two 16-bit neighbours of x (x itself where it is representable), and its
mean over the random bits is x. Which neighbour a given seed picks differs
from the reference, whose kernel draws from its device's own generator.
None of them has a gradient (the reference's is a bit cast): outputs are
detached. ``round_``, ``round_half_away``, ``floor``, ``ceil`` and
``trunc`` also take a ``trace.LazyArray`` and record the trace's
ROUND / FLOOR / CEIL / TRUNC opcodes.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .router import _is_lazy, _sqrt_rn, _trace

_M32 = 0xFFFFFFFF


def round_(x):
    """Round half to even."""
    if _is_lazy(x):
        return _trace().round(x)
    return torch.round(x)


def round_half_away(x):
    # NOT trunc(x + 0.5): adding 0.5 first double-rounds (e.g. the largest
    # f32 below 0.5 would round to 1). Compare the exact fractional part.
    if _is_lazy(x):
        tr = _trace()
        t = tr.trunc(x)
        bump = (abs(x - t) >= 0.5).cast(x.dtype)
        return t + tr.select(x >= 0.0, bump, -bump)
    t = torch.trunc(x)
    frac = x - t  # exact: x and t share the exponent range
    bump = (frac.abs() >= 0.5).to(x.dtype)
    return t + torch.where(x >= 0, bump, -bump)


def floor(x):
    if _is_lazy(x):
        return _trace().floor(x)
    return torch.floor(x)


def ceil(x):
    if _is_lazy(x):
        return _trace().ceil(x)
    return torch.ceil(x)


def trunc(x):
    if _is_lazy(x):
        return _trace().trunc(x)
    return torch.trunc(x)


# ---------------------------------------------------------------------------
# Stochastic rounding
# ---------------------------------------------------------------------------


def _check_target(dtype):
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError("stochastic_round targets bfloat16 or float16")


def _f16_neighbour(h, up: bool):
    """The float16 next to ``h`` toward +inf (``up``) or -inf, on the bit
    pattern: NaN and the infinity in that direction stay, +-0 steps to the
    smallest subnormal of the direction's sign."""
    b = h.view(torch.int16).to(torch.int32) & 0xFFFF
    mag = b & 0x7FFF
    negative = b >= 0x8000
    # moving away from zero adds one to the pattern, toward zero takes one
    away = negative != up
    stepped = torch.where(away, b + 1, b - 1)
    stepped = torch.where(mag == 0, 0x0001 if up else 0x8001, stepped)
    stay = (mag > 0x7C00) | (b == (0x7C00 if up else 0xFC00))
    out = torch.where(stay, b, stepped)
    return ((out ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16)


def stochastic_round_from_bits(x, bits, dtype=torch.bfloat16):
    """Stochastic rounding of float32 ``x`` with one 32-bit random word per
    element (``bits``: int64 in [0, 2**32) or an int32 bit pattern).

    bfloat16: the low 16 bits of the word are added as dither below the
    target mantissa and the sum is truncated; NaN and +-inf pass through
    the normal cast (dither on a payload NaN could carry into the
    exponent). float16: a probabilistic pick between the two neighbours,
    the upper one with probability (x - lo) / (hi - lo), against
    u = the word's top 24 bits * 2**-24."""
    _check_target(dtype)
    x = x.detach().to(torch.float32)
    word = bits.to(torch.int64) & _M32
    if dtype == torch.bfloat16:
        pattern = x.view(torch.int32).to(torch.int64) & _M32
        out = (pattern + (word & 0xFFFF)) & 0xFFFF0000
        # the low half is zero: the upper half is the bfloat16, exactly
        upper = out >> 16
        r = ((upper ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)
        return torch.where(torch.isfinite(x), r, x.to(dtype))
    lo16 = x.to(torch.float16)
    lo = lo16.to(torch.float32)
    hi = torch.where(x >= lo, _f16_neighbour(lo16, True).to(torch.float32),
                     _f16_neighbour(lo16, False).to(torch.float32))
    span = hi - lo
    p = torch.where(span != 0, (x - lo) / torch.where(span == 0, 1.0, span),
                    0.0)
    u = (word >> 8).to(torch.float32) * (2.0 ** -24)
    return torch.where(u < p, hi, lo).to(torch.float16)


def stochastic_round(x, generator, dtype=torch.bfloat16):
    """Unbiased stochastic rounding f32 -> 16-bit float, the random words
    drawn from ``generator`` (a ``torch.Generator`` on x's device)."""
    _check_target(dtype)
    bits = torch.randint(0, 1 << 32, tuple(x.shape), generator=generator,
                         dtype=torch.int64, device=x.device)
    return stochastic_round_from_bits(x, bits, dtype)


# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", 2011): multipliers and Weyl key increments
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Ten rounds of Philox4x32 on the counter (c0, c1, c2, c3), int64
    tensors with values in [0, 2**32), under the key (k0, k1), Python
    ints; returns the four output words as such tensors. A 32x32 -> 64
    product is one int64 product: it cannot pass 2**64, so the wrapped
    int64 holds all its bits."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _M32, (k1 + PHILOX_W1) & _M32
        p0, p1 = c0 * PHILOX_M0, c2 * PHILOX_M1
        c0, c1, c2, c3 = ((((p1 >> 32) & _M32) ^ c1) ^ k0, p1 & _M32,
                          (((p0 >> 32) & _M32) ^ c3) ^ k1, p0 & _M32)
    return c0, c1, c2, c3


def philox_words(n: int, seed: int, device):
    """The ``n`` random words of ``stochastic_round_cuda``: element i
    takes word i % 4 of the Philox block whose 128-bit counter is i // 4
    and whose key is the 64-bit ``seed``. int64 in [0, 2**32)."""
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    seed &= (1 << 64) - 1
    words = philox4x32(g & _M32, (g >> 32) & _M32, zero, zero,
                       seed & _M32, seed >> 32)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def _check_1d(x):
    if x.dim() != 1:
        raise ValueError(f"stochastic_round_cuda takes a 1-D tensor, got "
                         f"shape {tuple(x.shape)}")


def stochastic_round_plain(x, seed: int, dtype=torch.bfloat16):
    """Plain version of the stochastic_round kernel: the same Philox
    words, made with int64 tensor arithmetic, through
    ``stochastic_round_from_bits``. Philox is integer arithmetic, so this
    gives the kernel's bits, not only its distribution."""
    _check_target(dtype)
    _check_1d(x)
    return stochastic_round_from_bits(
        x, philox_words(x.shape[0], seed, x.device), dtype)


def stochastic_round_cuda(x, seed: int, dtype=torch.bfloat16):
    """Stochastic rounding of a 1-D float32 tensor to bfloat16 or float16
    with random words made inside the kernel from the 64-bit ``seed``: the
    stochastic_round kernel for a CUDA tensor, its plain version for a CPU
    one. Equal seeds give equal bits, whatever the launch shape. The
    output is detached."""
    _check_target(dtype)
    _check_1d(x)
    if not _build.is_cuda(x):
        return stochastic_round_plain(x, seed, dtype)
    x = x.detach()
    n = x.shape[0]
    _build.check(x, "x", (n,), x.device)
    out = torch.empty(n, dtype=dtype, device=x.device)
    if n == 0:
        return out  # a zero-size grid is a launch error
    lib = _build.load("stochastic_round")
    with torch.cuda.device(x.device):
        _build.launch(
            "stochastic_round", lib.stochastic_round_launch, x.data_ptr(),
            out.data_ptr(), n, seed & ((1 << 64) - 1),
            int(dtype == torch.float16),
            torch.cuda.current_stream().cuda_stream)
    return out


# ---------------------------------------------------------------------------
# Directed-rounding arithmetic.
#
# PyTorch computes round-to-nearest-even only. Directed results are
# recovered in two tiers, as in the reference:
#   add/sub: CORRECTLY ROUNDED via the FMA-free Knuth two-sum error term
#            (exact in eager PyTorch, which never reassociates floats).
#   mul/div/sqrt: PyTorch exposes no fma, so the rounding error of RN is
#            not recoverable exactly; the nearest result is widened by one
#            ulp in the requested direction unless it is provably exact
#            (zero operands). Overflow to +/-inf on finite inputs clamps to
#            +/-f32max in the direction that keeps the bound sound. Bounds
#            remain VALID for interval arithmetic, at most one ulp wider
#            than optimal.
# ---------------------------------------------------------------------------


_F32_MAX = 3.4028234663852886e38


def _f32(a, like=None):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.as_tensor(a, dtype=torch.float32,
                           device=None if like is None else like.device)


def _f32_pair(a, b):
    if isinstance(a, torch.Tensor):
        return _f32(a), _f32(b, a)
    b = _f32(b)
    return _f32(a, b), b


def _bump_up(s, err_pos):
    return torch.where(err_pos,
                       torch.nextafter(s, torch.full_like(s, math.inf)), s)


def _bump_down(s, err_neg):
    return torch.where(err_neg,
                       torch.nextafter(s, torch.full_like(s, -math.inf)), s)


def _clamp_overflow_up(s, inputs_finite):
    """An upper bound that overflowed to -inf on finite inputs is
    -f32max: the smallest finite value that is still >= the exact
    result."""
    return torch.where(torch.isneginf(s) & inputs_finite, -_F32_MAX, s)


def _clamp_overflow_down(s, inputs_finite):
    """A lower bound that overflowed to +inf on finite inputs is f32max
    (+inf would make an unsound interval)."""
    return torch.where(torch.isposinf(s) & inputs_finite, _F32_MAX, s)


def _two_sum(a, b):
    """Knuth two-sum: s + err == a + b exactly (s = RN(a + b))."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def add_up(a, b):
    """a + b rounded toward +inf (correctly rounded)."""
    a, b = _f32_pair(a, b)
    s, err = _two_sum(a, b)
    fin = torch.isfinite(a) & torch.isfinite(b)
    return _clamp_overflow_up(_bump_up(s, err > 0), fin)


def add_down(a, b):
    """a + b rounded toward -inf (correctly rounded)."""
    a, b = _f32_pair(a, b)
    s, err = _two_sum(a, b)
    fin = torch.isfinite(a) & torch.isfinite(b)
    return _clamp_overflow_down(_bump_down(s, err < 0), fin)


def sub_up(a, b):
    a, b = _f32_pair(a, b)
    return add_up(a, -b)


def sub_down(a, b):
    a, b = _f32_pair(a, b)
    return add_down(a, -b)


def mul_up(a, b):
    """a * b rounded toward +inf. One-ulp-conservative: always widened by
    one ulp except for exact zero products; overflow clamps so bounds
    stay interval-sound."""
    a, b = _f32_pair(a, b)
    p = a * b
    fin = torch.isfinite(a) & torch.isfinite(b)
    exact_zero = (a == 0) | (b == 0)
    return _clamp_overflow_up(_bump_up(p, torch.isfinite(p) & ~exact_zero),
                              fin)


def mul_down(a, b):
    a, b = _f32_pair(a, b)
    p = a * b
    fin = torch.isfinite(a) & torch.isfinite(b)
    exact_zero = (a == 0) | (b == 0)
    return _clamp_overflow_down(
        _bump_down(p, torch.isfinite(p) & ~exact_zero), fin)


def div_up(a, b):
    """a / b rounded toward +inf (one-ulp-conservative except exact-zero
    numerators; overflow clamps)."""
    a, b = _f32_pair(a, b)
    q = a / b
    fin = torch.isfinite(a) & torch.isfinite(b) & (b != 0)
    exact_zero = a == 0
    return _clamp_overflow_up(_bump_up(q, torch.isfinite(q) & ~exact_zero),
                              fin)


def div_down(a, b):
    a, b = _f32_pair(a, b)
    q = a / b
    fin = torch.isfinite(a) & torch.isfinite(b) & (b != 0)
    exact_zero = a == 0
    return _clamp_overflow_down(
        _bump_down(q, torch.isfinite(q) & ~exact_zero), fin)


# sqrt_up and sqrt_down rest on the correctly rounded float32 sqrt
# (router._sqrt_rn): PyTorch's CPU float32 sqrt is 1 ulp off on ~0.6% of
# inputs, and its float64 sqrt is not always correctly rounded either.


def sqrt_up(a):
    """sqrt(a) rounded toward +inf (one-ulp-conservative except exact 0;
    sqrt cannot overflow)."""
    a = _f32(a)
    s = _sqrt_rn(a)
    return _bump_up(s, torch.isfinite(s) & (a != 0))


def sqrt_down(a):
    a = _f32(a)
    s = _sqrt_rn(a)
    return _bump_down(s, torch.isfinite(s) & (s > 0))
