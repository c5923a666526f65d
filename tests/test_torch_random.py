"""The port's PCG32 and 64-bit integers (enoki_tpu_torch.types) against
the reference (enoki_tpu.types) and a numpy uint64 implementation: every
draw is integer arithmetic, so every comparison is bit-exact (tolerance
0). 4096 lanes, several draws, all on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.types import PCG32 as JPCG32, u64 as JU
from enoki_tpu.types.random import uniform as juniform
from enoki_tpu_torch import interop
from enoki_tpu_torch.types import (PCG32, PCG32_DEFAULT_STATE,
                                   PCG32_DEFAULT_STREAM, PCG32_MULT, u64 as U,
                                   uniform)

LANES = 4096
M64 = (1 << 64) - 1


class NumpyPCG32:
    """Reference implementation in numpy uint64 (random.h semantics)."""

    def __init__(self, size=None, initstate=PCG32_DEFAULT_STATE, initseq=None):
        if initseq is None:
            if size is None:
                initseq = np.uint64(PCG32_DEFAULT_STREAM)
            else:
                initseq = (np.arange(size, dtype=np.uint64)
                           + np.uint64(PCG32_DEFAULT_STREAM))
        shape = () if size is None else (size,)
        initstate = np.full(shape, initstate, np.uint64)
        initseq = np.asarray(initseq, np.uint64)
        with np.errstate(over="ignore"):
            self.state = np.zeros(shape, np.uint64)
            self.inc = (initseq << np.uint64(1)) | np.uint64(1)
            self.next_uint32()
            self.state += initstate
            self.next_uint32()

    def next_uint32(self):
        with np.errstate(over="ignore"):
            old = self.state
            self.state = old * np.uint64(PCG32_MULT) + self.inc
            xorshifted = (((old >> np.uint64(18)) ^ old)
                          >> np.uint64(27)).astype(np.uint32)
            rot = (old >> np.uint64(59)).astype(np.uint32)
            return (xorshifted >> rot) | (
                xorshifted << ((np.uint32(32) - rot) & np.uint32(31)))

    def next_float32(self):
        bits = (self.next_uint32() >> np.uint32(9)) | np.uint32(0x3F800000)
        return bits.view(np.float32) - np.float32(1.0)

    def advance(self, delta):
        with np.errstate(over="ignore"):
            cur_mult = np.full_like(self.state, PCG32_MULT)
            cur_plus = self.inc.copy() * np.ones_like(self.state)
            acc_mult = np.ones_like(self.state)
            acc_plus = np.zeros_like(self.state)
            delta = np.uint64(delta & ((1 << 64) - 1))
            while delta != 0:
                if delta & np.uint64(1):
                    acc_mult = acc_mult * cur_mult
                    acc_plus = acc_plus * cur_mult + cur_plus
                cur_plus = (cur_mult + np.uint64(1)) * cur_plus
                cur_mult = cur_mult * cur_mult
                delta >>= np.uint64(1)
            self.state = acc_mult * self.state + acc_plus


def _gens(n=LANES):
    return PCG32.create(n, device="cpu"), JPCG32.create(n), NumpyPCG32(n)


def _u32(x):
    """A draw of either package as a numpy uint32 array."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.int64
        a = x.numpy()
        assert a.min() >= 0 and a.max() < 1 << 32
        return a.astype(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _same_state(gen, jgen):
    return (np.array_equal(U.to_py(gen.state), JU.to_py(jgen.state))
            and np.array_equal(U.to_py(gen.inc), JU.to_py(jgen.inc)))


# -- u64 primitives against Python ints --------------------------------------


def _u64_cases():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 64, 200, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, 200, dtype=np.uint64)
    # the high bit set and clear, and the corners
    a[:6] = [0, 1, 1 << 63, M64, (1 << 63) - 1, (1 << 63) + 1]
    b[:6] = [M64, 1 << 63, 1 << 63, M64, 1, 0]
    return a, b


def _as_u64(a):
    return U.U64(torch.from_numpy(a.view(np.int64).copy()))


U64_BINARY = {
    "add": lambda x, y: (x + y) & M64, "sub": lambda x, y: (x - y) & M64,
    "mul": lambda x, y: (x * y) & M64, "xor": lambda x, y: x ^ y,
    "or_": lambda x, y: x | y, "and_": lambda x, y: x & y,
}


@pytest.mark.parametrize("op", list(U64_BINARY))
def test_u64_binary_ops_match_python_ints(op):
    a, b = _u64_cases()
    got = U.to_py(getattr(U, op)(_as_u64(a), _as_u64(b)))
    want = [U64_BINARY[op](int(x), int(y)) for x, y in zip(a, b)]
    assert got.tolist() == want


@pytest.mark.parametrize("k", [0, 1, 18, 27, 31, 32, 33, 59, 63, 64])
def test_u64_shifts_are_logical(k):
    a, _ = _u64_cases()
    A = _as_u64(a)
    assert U.to_py(U.shr(A, k)).tolist() == [int(x) >> k for x in a]
    assert U.to_py(U.shl(A, k)).tolist() == [(int(x) << k) & M64 for x in a]
    if k < 64:
        kk = torch.full((a.size,), k, dtype=torch.int64)
        assert U.to_py(U.shr_dyn(A, kk)).tolist() == [int(x) >> k for x in a]


def test_u64_dynamic_shift_per_lane_and_halves():
    a, b = _u64_cases()
    A = _as_u64(a)
    k = torch.from_numpy((b % np.uint64(64)).astype(np.int64))
    want = [int(x) >> int(s) for x, s in zip(a, k)]
    assert U.to_py(U.shr_dyn(A, k)).tolist() == want
    # int32 bit patterns are taken as unsigned 32-bit operands
    assert U.to_py(U.shr_dyn(A, k.to(torch.int32))).tolist() == want
    assert A.hi.tolist() == [int(x) >> 32 for x in a]
    assert A.lo.tolist() == [int(x) & 0xFFFFFFFF for x in a]
    assert np.array_equal(U.to_py(U.u64(A.hi, A.lo)), a)
    assert U.ones_bit(A).tolist() == [int(x) & 1 for x in a]


def test_u64_comparisons_are_unsigned():
    a, b = _u64_cases()
    A, B = _as_u64(a), _as_u64(b)
    assert U.lt(A, B).tolist() == [int(x) < int(y) for x, y in zip(a, b)]
    assert U.ge(A, B).tolist() == [int(x) >= int(y) for x, y in zip(a, b)]
    assert U.eq(A, B).tolist() == [int(x) == int(y) for x, y in zip(a, b)]
    assert U.ne(A, B).tolist() == [int(x) != int(y) for x, y in zip(a, b)]
    assert U.is_zero(A).tolist() == [int(x) == 0 for x in a]
    m = torch.from_numpy(a > b)
    assert np.array_equal(U.to_py(U.where(m, A, B)), np.where(a > b, a, b))


def test_u64_32_bit_operands_and_constants():
    a, b = _u64_cases()
    A = _as_u64(a)
    b32 = (b & np.uint64(0xFFFFFFFF)).astype(np.int64)
    t = torch.from_numpy(b32)
    assert U.to_py(U.add_u32(A, t)).tolist() == [
        (int(x) + int(y)) & M64 for x, y in zip(a, b32)]
    assert U.to_py(U.mul_u64_u32(A, t)).tolist() == [
        (int(x) * int(y)) & M64 for x, y in zip(a, b32)]
    # the same operand as an int32 bit pattern (negative where bit 31 is set)
    t32 = torch.from_numpy(b32.astype(np.uint32).view(np.int32).copy())
    assert torch.equal(U.mul_u64_u32(A, t32).v, U.mul_u64_u32(A, t).v)
    assert np.array_equal(U.to_py(U.from_u32(t32)), b32.astype(np.uint64))
    for value in (0, 1, PCG32_MULT, PCG32_DEFAULT_STREAM, M64, -1, 1 << 63):
        c = U.from_py(value, (3,), "cpu")
        assert U.to_py(c).tolist() == [value & M64] * 3
    assert U.to_py(U.zeros((2,), "cpu")).tolist() == [0, 0]
    # against the reference's (hi, lo) emulation
    Aj = JU.u64((a >> np.uint64(32)).astype(np.uint32), a.astype(np.uint32))
    Bj = JU.u64((b >> np.uint64(32)).astype(np.uint32), b.astype(np.uint32))
    assert np.array_equal(U.to_py(U.mul(A, _as_u64(b))),
                          JU.to_py(JU.mul(Aj, Bj)))


# -- PCG32, call by call ----------------------------------------------------


def test_seeding_matches_both_references():
    gen, jgen, ref = _gens()
    assert _same_state(gen, jgen)
    assert np.array_equal(U.to_py(gen.state), ref.state)
    assert np.array_equal(U.to_py(gen.inc), ref.inc)
    # a scalar generator, and explicit initstate / initseq
    s, js = PCG32.create(device="cpu"), JPCG32.create()
    assert s.shape == () and _same_state(s, js)
    g2 = PCG32.create(16, initstate=42, initseq=54, device="cpu")
    assert _same_state(g2, JPCG32.create(16, initstate=42, initseq=54))
    assert np.array_equal(U.to_py(g2.state),
                          NumpyPCG32(16, 42, np.full(16, 54)).state)


def test_next_uint32_bit_exact():
    gen, jgen, ref = _gens()
    for _ in range(20):
        got, gen = gen.next_uint32()
        want, jgen = jgen.next_uint32()
        assert np.array_equal(_u32(got), _u32(want))
        assert np.array_equal(_u32(got), ref.next_uint32())
    assert _same_state(gen, jgen)


def test_next_uint64_bit_exact():
    gen, jgen, ref = _gens()
    for _ in range(5):
        got, gen = gen.next_uint64()
        want, jgen = jgen.next_uint64()
        assert np.array_equal(U.to_py(got), JU.to_py(want))
        lo = ref.next_uint32().astype(np.uint64)
        hi = ref.next_uint32().astype(np.uint64)
        assert np.array_equal(U.to_py(got), (hi << np.uint64(32)) | lo)


def test_next_float32_bit_exact():
    gen, jgen, ref = _gens()
    for _ in range(10):
        got, gen = gen.next_float32()
        want, jgen = jgen.next_float32()
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy(), ref.next_float32())
        assert bool(((got >= 0) & (got < 1)).all())


def test_next_float64_bit_exact():
    gen, _, ref = _gens()
    with jax.enable_x64():
        jgen = JPCG32.create(LANES)
        for _ in range(5):
            got, gen = gen.next_float64()
            want, jgen = jgen.next_float64()
            assert got.dtype == torch.float64
            assert np.asarray(want).dtype == np.float64
            assert np.array_equal(got.numpy(), np.asarray(want))
            bits = ref.next_uint32().astype(np.uint64)
            pattern = (bits << np.uint64(20)) | np.uint64(0x3FF0000000000000)
            assert np.array_equal(got.numpy(),
                                  pattern.view(np.float64) - 1.0)


def test_masked_lanes_do_not_advance():
    gen, jgen, _ = _gens()
    mask = np.random.default_rng(1).random(LANES) < 0.5
    for draw in ("next_uint32", "next_float32", "next_uint64"):
        got, gen2 = getattr(gen, draw)(torch.from_numpy(mask))
        want, jgen2 = getattr(jgen, draw)(jnp.asarray(mask))
        assert _same_state(gen2, jgen2)
        st0, st2 = U.to_py(gen.state), U.to_py(gen2.state)
        assert np.array_equal(st0[~mask], st2[~mask])
        assert not np.any(st0[mask] == st2[mask])
        if draw == "next_uint64":
            assert np.array_equal(U.to_py(got), JU.to_py(want))
        elif draw == "next_uint32":
            assert np.array_equal(_u32(got), _u32(want))
        else:
            assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("delta", [1, 100, 12345678901234, -1, -100,
                                   (1 << 63) + 5])
def test_advance_forward_and_backward(delta):
    gen, jgen, ref = _gens(256)
    fast, jfast = gen.advance(delta), jgen.advance(delta)
    assert _same_state(fast, jfast)
    ref.advance(delta)
    assert np.array_equal(U.to_py(fast.state), ref.state)
    assert torch.equal(fast.advance(-delta).state.v, gen.state.v)
    if 0 < delta <= 100:
        slow = gen
        for _ in range(delta):
            _, slow = slow.next_uint32()
        assert torch.equal(fast.state.v, slow.state.v)


@pytest.mark.parametrize("delta", [0, 1, 7, 1000, -3, 1 << 40])
def test_distance(delta):
    gen, jgen, _ = _gens(128)
    ahead, jahead = gen.advance(delta), jgen.advance(delta)
    d = ahead.distance(gen)
    assert d.dtype == torch.int32
    assert np.array_equal(d.numpy(), np.asarray(jahead.distance(jgen)))
    d64 = U.to_py(ahead.distance_u64(gen))
    assert np.array_equal(d64, JU.to_py(jahead.distance_u64(jgen)))
    assert d64.tolist() == [delta & M64] * 128
    wrapped = (delta & 0xFFFFFFFF)
    assert d.tolist() == [wrapped - (1 << 32) if wrapped >> 31
                          else wrapped] * 128


@pytest.mark.parametrize("bound", [1, 2, 10, 1000, (1 << 31) + 12345,
                                   (1 << 32) - 1])
def test_next_uint32_bounded(bound):
    gen, jgen, _ = _gens()
    for _ in range(3):
        got, gen = gen.next_uint32_bounded(bound)
        want, jgen = jgen.next_uint32_bounded(bound)
        assert np.array_equal(_u32(got), _u32(want))
        assert int(got.max()) < bound
    assert _same_state(gen, jgen)


def test_next_uint32_bounded_masked():
    gen, jgen, _ = _gens()
    mask = np.random.default_rng(2).random(LANES) < 0.3
    # a bound that rejects almost half of the draws: several rounds
    bound = (1 << 31) + 1
    got, gen2 = gen.next_uint32_bounded(bound, torch.from_numpy(mask))
    want, jgen2 = jgen.next_uint32_bounded(bound, jnp.asarray(mask))
    assert np.array_equal(_u32(got), _u32(want))
    assert _same_state(gen2, jgen2)
    assert np.array_equal(U.to_py(gen.state)[~mask],
                          U.to_py(gen2.state)[~mask])


@pytest.mark.parametrize("bound", [1, 10, 12345678901234, (1 << 62) + 3,
                                   (1 << 63) - 1])
def test_next_uint64_bounded(bound):
    gen, jgen, _ = _gens(512)
    for _ in range(2):
        got, gen = gen.next_uint64_bounded(bound)
        want, jgen = jgen.next_uint64_bounded(bound)
        assert np.array_equal(U.to_py(got), JU.to_py(want))
        assert int(U.to_py(got).max()) < bound
    assert _same_state(gen, jgen)


def test_shuffle():
    x = np.random.default_rng(5).standard_normal((24, 3)).astype(np.float32)
    for gen, jgen in ((PCG32.create(device="cpu"), JPCG32.create()),
                      (PCG32.create(4, device="cpu"), JPCG32.create(4))):
        t = torch.from_numpy(x.copy())
        got, gen2 = gen.shuffle(t)
        want, jgen2 = jgen.shuffle(jnp.asarray(x))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert _same_state(gen2, jgen2)
        assert np.array_equal(t.numpy(), x)  # the input is left as it was
        assert np.array_equal(np.sort(got.numpy(), 0), np.sort(x, 0))


def test_uniform():
    gen, jgen, _ = _gens(64)
    u, gen2 = uniform(gen)
    ju, _ = juniform(jgen)
    assert u.shape == (64,) and np.array_equal(u.numpy(), np.asarray(ju))
    assert torch.equal(gen2.state.v, gen.next_float32()[1].state.v)
    assert uniform(gen, (64,))[0].shape == (64,)
    assert uniform(gen, 64)[0].shape == (64,)
    with pytest.raises(ValueError):
        uniform(gen, (128,))
    ub, _ = uniform(gen, dtype=torch.bfloat16)
    jub, _ = juniform(jgen, dtype=jnp.bfloat16)
    assert ub.dtype == torch.bfloat16
    assert np.array_equal(ub.float().numpy(),
                          np.asarray(jub.astype(jnp.float32)))
    assert uniform(gen, dtype=torch.float64)[0].dtype == torch.float64


def test_generator_carried_across_continues_the_stream():
    _, jgen, _ = _gens()
    for _ in range(3):
        _, jgen = jgen.next_uint32()
    halves = [np.asarray(h) for h in (jgen.state.hi, jgen.state.lo,
                                      jgen.inc.hi, jgen.inc.lo)]
    gen = interop.pcg32_from_numpy(*halves, device="cpu")
    assert _same_state(gen, jgen)
    for back, want in zip(interop.pcg32_to_numpy(gen), halves):
        assert back.dtype == np.uint32 and np.array_equal(back, want)
    for _ in range(5):
        got, gen = gen.next_float32()
        want, jgen = jgen.next_float32()
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_generator_defaults_to_the_card():
    if torch.cuda.is_available():
        assert PCG32.create(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PCG32.create(4)
