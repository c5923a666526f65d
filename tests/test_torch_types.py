"""types/half.py, idiv.py, morton.py, enum_array.py and color.py of the
port against the reference's (enoki_tpu.types) on the same seeded numpy
inputs, and under the gates of the reference's own tests
(tests/test_types.py:28-97, tests/test_misc_parity.py:26).

Tolerances:
  * integer and bit results (idiv, morton, enum arrays, the half bit
    casts): exact, dtype included;
  * the float16 / bfloat16 conversions: bit-equal to the reference's on
    float32 inputs that are not subnormal (XLA's CPU backend flushes
    those, PyTorch keeps them: ROADMAP §C);
  * color: ``impl="poly"`` bit-equal to the reference's (IEEE arithmetic
    only); ``impl="native"`` (PyTorch's pow) within 4 ulp of the
    reference's (measured 4 with linear_to_srgb, 1 with srgb_to_linear:
    PyTorch's and XLA's pow differ in the last bits), and under the
    reference's gates against the standard points (round trip atol 1e-5,
    ``linear_to_srgb(0.5)`` atol 1e-4).
"""

import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.types import (DivisorI32 as JDivI32, DivisorU32 as JDivU32,
                             color as JC, half as JH,
                             morton_decode as j_morton_decode,
                             morton_encode as j_morton_encode)
from enoki_tpu.types.enum_array import (enum_array as j_enum_array,
                                        enum_full as j_enum_full)
from enoki_tpu_torch.types import (DivisorI32, DivisorU32, color, divisor,
                                   half, morton_decode, morton_encode)
from enoki_tpu_torch.types.enum_array import (_storage_dtype, enum_array,
                                              enum_eq, enum_full,
                                              to_enum_list)

CPU = "cpu"
N = 5000

TORCH_OF = {np.dtype(np.uint32): torch.uint32, np.dtype(np.int32): torch.int32,
            np.dtype(np.uint16): torch.uint16, np.dtype(np.int64): torch.int64,
            np.dtype(np.float16): torch.float16,
            np.dtype(np.float32): torch.float32}


def assert_exact(got, want):
    """Bit-equal, dtype included."""
    want = np.asarray(want)
    assert got.dtype == TORCH_OF[want.dtype], (got.dtype, want.dtype)
    assert got.shape == want.shape
    if got.dtype == torch.uint32:
        got = got.to(torch.int64)
    elif got.dtype == torch.uint16:
        got = got.view(torch.int16).to(torch.int64) & 0xFFFF
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- half --------------------------------------------------------------------


def _normal_f32(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 20, n))) \
        .astype(np.float32)
    x[:6] = [0.0, -0.0, 65504.0, 65520.0, np.inf, np.nan]
    return x


@pytest.mark.parametrize("to, back, jto, jback", [
    (half.float_to_half, half.half_to_float, JH.float_to_half,
     JH.half_to_float),
    (half.float_to_bf16, half.bf16_to_float, JH.float_to_bf16,
     JH.bf16_to_float)], ids=["float16", "bfloat16"])
def test_half_conversions_match_the_reference(to, back, jto, jback):
    x = _normal_f32(N, 0)
    h, hj = to(_t(x)), jto(jnp.asarray(x))
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(hj).astype(np.float32))
    np.testing.assert_array_equal(back(h).numpy(),
                                  np.asarray(jback(hj)))
    assert back(h).dtype == torch.float32


def test_half_bits_match_the_reference():
    with np.errstate(over="ignore"):
        x = _normal_f32(N, 1).astype(np.float16)
    bits = half.half_bits(_t(x))
    assert_exact(bits, JH.half_bits(jnp.asarray(x)))
    back = half.half_from_bits(bits)
    assert back.dtype == torch.float16
    np.testing.assert_array_equal(back.view(torch.int16).numpy(),
                                  x.view(np.int16))


def test_half_gates_of_the_reference():
    # tests/test_types.py:90-97
    x = torch.tensor([1.0, -2.5, 65504.0, 1e-8])
    back = half.half_to_float(half.float_to_half(x))
    np.testing.assert_allclose(back[:3].numpy(), x[:3].numpy(), rtol=1e-3)
    assert int(half.half_bits(torch.tensor(1.0, dtype=torch.float16))
               .view(torch.int16)) == 0x3C00
    assert float(half.half_from_bits(
        torch.tensor(0xC000, dtype=torch.uint16))) == -2.0


# -- idiv --------------------------------------------------------------------

U32_DIVISORS = [1, 2, 3, 5, 7, 10, 641, 6700417, 2**31, 2**31 + 1,
                2**32 - 1, 48271, 2**20, 0x7FFFFFFF]
I32_DIVISORS = [1, -1, 2, -2, 3, -3, 7, -7, 10, 641, -641, 2**30,
                -(2**30), 48271, 0x7FFFFFFF, -0x7FFFFFFF, -(2**31)]


def _u32_numerators():
    n = np.random.default_rng(2).integers(0, 1 << 32, N, dtype=np.uint32)
    n[:4] = [0, 1, 2**31, 2**32 - 1]
    return n


def _i32_numerators():
    n = np.random.default_rng(3).integers(-2**31, 2**31, N,
                                          dtype=np.int64).astype(np.int32)
    n[:6] = [0, 1, -1, -(2**31), 2**31 - 1, -(2**31) + 1]
    return n


@pytest.mark.parametrize("d", U32_DIVISORS)
def test_divisor_u32_matches_the_reference(d):
    n = _u32_numerators()
    div, jdiv = DivisorU32(d), JDivU32(d)
    assert (div.magic, div.shift, div.add) == (jdiv.magic, jdiv.shift,
                                               jdiv.add)
    q, r = div(_t(n)), div.mod(_t(n))
    assert_exact(q, jdiv(jnp.asarray(n)))
    assert_exact(r, jdiv.mod(jnp.asarray(n)))
    # tests/test_types.py:56-68: against numpy's uint64 division
    assert_exact(q, (n.astype(np.uint64) // d).astype(np.uint32))
    assert_exact(r, (n.astype(np.uint64) % d).astype(np.uint32))


@pytest.mark.parametrize("d", I32_DIVISORS)
def test_divisor_i32_matches_the_reference(d):
    n = _i32_numerators()
    div, jdiv = DivisorI32(d), JDivI32(d)
    assert (div.magic, div.shift) == (jdiv.magic, jdiv.shift)
    q = div(_t(n))
    assert_exact(q, jdiv(jnp.asarray(n)))
    assert_exact(div.mod(_t(n)), jdiv.mod(jnp.asarray(n)))
    # tests/test_types.py:71-80: C truncation, INT32_MIN / -1 wrapping
    want = np.trunc(n.astype(np.float64) / d).astype(np.int64)
    assert_exact(q, ((want + 2**31) % 2**32 - 2**31).astype(np.int32))


def test_divisor_takes_other_integer_dtypes_as_the_reference_casts():
    n = _i32_numerators()
    assert_exact(DivisorU32(7)(_t(n)), JDivU32(7)(jnp.asarray(n)))
    assert_exact(DivisorI32(-3)(_t(n.astype(np.int64))),
                 JDivI32(-3)(jnp.asarray(n)))
    assert isinstance(divisor(3), DivisorU32)
    assert isinstance(divisor(3, signed=True), DivisorI32)
    for bad in (0, 2**32):
        with pytest.raises(ValueError):
            DivisorU32(bad)
    with pytest.raises(ValueError):
        DivisorI32(0)


# -- morton ------------------------------------------------------------------


@pytest.mark.parametrize("dim, bits", [(1, 32), (2, 16), (3, 10)])
def test_morton_matches_the_reference(dim, bits):
    rng = np.random.default_rng(dim)
    cs = [rng.integers(0, 1 << bits, N, dtype=np.uint64).astype(np.uint32)
          for _ in range(dim)]
    cs[0][:2] = [0, (1 << bits) - 1]
    code = morton_encode([_t(c) for c in cs])
    want = j_morton_encode([jnp.asarray(c) for c in cs])
    assert_exact(code, want)
    for got, w, c in zip(morton_decode(code, dim),
                         j_morton_decode(want, dim), cs):
        assert_exact(got, w)
        assert_exact(got, c)


def test_morton_keeps_the_low_bits_of_wide_coordinates():
    # bits above floor(32/D) are dropped, as in the reference
    rng = np.random.default_rng(9)
    cs = [rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
          for _ in range(3)]
    assert_exact(morton_encode([_t(c) for c in cs]),
                 j_morton_encode([jnp.asarray(c) for c in cs]))
    code = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    for got, w in zip(morton_decode(_t(code), 2),
                      j_morton_decode(jnp.asarray(code), 2)):
        assert_exact(got, w)


def test_morton_of_int32_coordinates_takes_their_bit_patterns():
    x = np.array([-1, 5, 2**31 - 1], np.int32)
    assert_exact(morton_encode([_t(x), _t(x)]),
                 j_morton_encode([jnp.asarray(x), jnp.asarray(x)]))


def test_morton_gates_of_the_reference():
    # tests/test_types.py:14-50: against numpy bit interleaving
    rng = np.random.default_rng(0)
    x, y = (rng.integers(0, 1 << 16, 1000).astype(np.uint32)
            for _ in range(2))
    want = np.zeros_like(x)
    for b in range(16):
        want |= ((x >> b) & 1) << (2 * b)
        want |= ((y >> b) & 1) << (2 * b + 1)
    assert_exact(morton_encode([_t(x), _t(y)]), want)


# -- enum arrays -------------------------------------------------------------


class Kind(enum.IntEnum):
    DIFFUSE = 0
    MIRROR = 1
    GLASS = 2


class Flag(enum.IntEnum):
    LOW = 1
    TOP = 1 << 31


class Wide(enum.IntEnum):
    NEG = -1
    BIG = 1 << 40


def test_enum_arrays_gates_of_the_reference():
    # tests/test_misc_parity.py:26-31
    arr = enum_array([Kind.MIRROR, Kind.DIFFUSE, Kind.GLASS], Kind,
                     device=CPU)
    assert_exact(arr, np.array([1, 0, 2], np.int32))
    np.testing.assert_array_equal(enum_eq(arr, Kind.DIFFUSE).numpy(),
                                  [False, True, False])
    assert to_enum_list(arr, Kind) == [Kind.MIRROR, Kind.DIFFUSE, Kind.GLASS]
    assert_exact(enum_full(Kind.GLASS, 3, device=CPU),
                 np.array([2, 2, 2], np.int32))


@pytest.mark.parametrize("cls", [Kind, Flag], ids=["int32", "uint32"])
def test_enum_arrays_match_the_reference(cls):
    members = list(cls) * 3
    arr = enum_array(members, cls, device=CPU)
    assert_exact(arr, j_enum_array(members, cls))
    for m in cls:
        assert_exact(enum_full(m, (2, 3), device=CPU), j_enum_full(m, (2, 3)))
        # numpy's compare: the reference's enum_eq overflows on uint32
        # lanes against 1 << 31 (a weakly typed int32 operand)
        np.testing.assert_array_equal(
            enum_eq(arr, m).numpy(),
            np.asarray(j_enum_array(members, cls)) == int(m))
    assert to_enum_list(arr, cls) == members


def test_enum_storage_beyond_32_bits_is_int64_and_uint64_raises():
    # the reference needs jax_enable_x64 here; the port has int64 and no
    # uint64 (ROADMAP §C)
    assert _storage_dtype([-1, 1 << 40]) == torch.int64
    arr = enum_array(list(Wide), Wide, device=CPU)
    assert arr.dtype == torch.int64
    assert to_enum_list(arr, Wide) == list(Wide)
    np.testing.assert_array_equal(enum_eq(arr, Wide.BIG).numpy(),
                                  [False, True])
    with pytest.raises(OverflowError):
        _storage_dtype([0, 1 << 63])
    with pytest.raises(OverflowError):
        _storage_dtype([-(1 << 63) - 1])


# -- color -------------------------------------------------------------------


def _srgb_inputs():
    x = np.random.default_rng(5).uniform(-0.1, 1.2, N).astype(np.float32)
    x[:6] = [0.0, -0.0, 0.0031308, 0.04045, 1.0, 0.5]
    return x


def _ulp(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want)
    return np.abs(got - want) / np.spacing(np.abs(want)).astype(np.float64)


@pytest.mark.parametrize("name", ["linear_to_srgb", "srgb_to_linear"])
def test_color_matches_the_reference(name):
    x = _srgb_inputs()
    fn, jfn = getattr(color, name), getattr(JC, name)
    got = fn(_t(x), "poly")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfn(jnp.asarray(x), "poly")))
    ulp = _ulp(fn(_t(x)).numpy(), np.asarray(jfn(jnp.asarray(x))))
    assert ulp.max() <= 4, ulp.max()


@pytest.mark.parametrize("impl", ["native", "poly"])
def test_color_gates_of_the_reference(impl):
    # tests/test_types.py:83-87
    x = torch.from_numpy(np.array(jnp.linspace(0.0, 1.0, 1001)))
    back = color.srgb_to_linear(color.linear_to_srgb(x, impl), impl)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-5)
    one = torch.tensor(1.0)
    assert abs(float(color.linear_to_srgb(one, impl)) - 1.0) <= 1e-5
    assert abs(float(color.srgb_to_linear(one, impl)) - 1.0) <= 1e-5
    assert abs(float(color.linear_to_srgb(torch.tensor(0.5), impl))
               - 0.7353569830524495) <= 1e-4


def test_color_takes_16_bit_and_integer_inputs_as_the_reference():
    x = _srgb_inputs()
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        got = color.linear_to_srgb(_t(x).to(dt), "poly")
        want = JC.linear_to_srgb(jnp.asarray(x, jdt), "poly")
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    k = np.arange(3, dtype=np.int32)
    got = color.srgb_to_linear(_t(k), "poly")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JC.srgb_to_linear(jnp.asarray(k), "poly")))
