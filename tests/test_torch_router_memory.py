"""The memory operations and bit-level helpers of the port's
ops/router.py against the reference's, on the same seeded numpy inputs.
Everything is exact (tolerance 0) except a float ``scatter_add``, whose
sums the two packages take in different orders: rtol 1e-6, and per slot
an atol of 2**-22 times the sum of the magnitudes added there (a few f32
roundings of the partial sums; hundreds of terms of size ~1 meet in a
slot)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu import config as jconfig_module
from enoki_tpu.ops import router as JR
from enoki_tpu_torch.config import config
from enoki_tpu_torch.ops import router as TR

jconfig = jconfig_module.config


@pytest.fixture
def debug_bounds():
    config.debug_bounds = jconfig.debug_bounds = True
    yield
    config.debug_bounds = jconfig.debug_bounds = False


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rng_case(seed, n=500, size=40, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = size if hi is None else hi
    return (rng.standard_normal(size).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(lo, hi, n).astype(np.int32),
            rng.random(n) < 0.6)


# -- gather --------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_gather(masked):
    src, _, idx, mask = _rng_case(0, lo=-5, hi=50)  # out of range: clamps
    m = mask if masked else None
    got = TR.gather(_t(src), _t(idx), None if m is None else _t(m))
    want = JR.gather(jnp.asarray(src), jnp.asarray(idx),
                     None if m is None else jnp.asarray(m))
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = TR.gather(_t(src), _t(idx), _t(mask), fill=-7.0)
    want = JR.gather(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(mask),
                     fill=-7.0)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_gather_rows_and_index_shapes():
    rng = np.random.default_rng(1)
    src = rng.standard_normal((20, 3)).astype(np.float32)
    idx = rng.integers(0, 20, (4, 5)).astype(np.int32)
    mask = rng.random((4, 5)) < 0.5
    got = TR.gather(_t(src), _t(idx), _t(mask))
    want = JR.gather(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(mask))
    assert got.shape == (4, 5, 3)
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- scatter ---------------------------------------------------------------------


def test_scatter_unique_indices_masked_and_not():
    rng = np.random.default_rng(2)
    tgt = rng.standard_normal(64).astype(np.float32)
    idx = rng.permutation(64)[:40].astype(np.int32)
    val = rng.standard_normal(40).astype(np.float32)
    mask = rng.random(40) < 0.5
    for m in (None, mask):
        got = TR.scatter(_t(tgt), _t(val), _t(idx),
                         None if m is None else _t(m))
        want = JR.scatter(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(idx),
                          None if m is None else jnp.asarray(m))
        assert np.array_equal(got.numpy(), np.asarray(want))
    # the target is left as it was, a scalar value broadcasts
    t = _t(tgt.copy())
    got = TR.scatter(t, 2.5, _t(idx))
    assert np.array_equal(t.numpy(), tgt)
    assert np.array_equal(got.numpy(), np.asarray(
        JR.scatter(jnp.asarray(tgt), 2.5, jnp.asarray(idx))))


def test_scatter_masked_drops_out_of_range():
    rng = np.random.default_rng(3)
    tgt = rng.standard_normal(16).astype(np.float32)
    idx = np.array([0, 3, 16, 99, 5, 7], np.int32)
    val = rng.standard_normal(6).astype(np.float32)
    mask = np.array([True, False, True, True, True, False])
    got = TR.scatter(_t(tgt), _t(val), _t(idx), _t(mask))
    want = JR.scatter(jnp.asarray(tgt), jnp.asarray(val), jnp.asarray(idx),
                      jnp.asarray(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_scatter_debug_bounds_drops_negative_and_out_of_range(debug_bounds):
    tgt = np.zeros(8, np.float32)
    idx = np.array([2, -1, 8, 100, -9, 5], np.int32)
    val = np.arange(1, 7, dtype=np.float32)
    for m in (None, np.array([True, True, True, False, True, True])):
        got = TR.scatter(_t(tgt), _t(val), _t(idx),
                         None if m is None else _t(m))
        want = JR.scatter(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(idx),
                          None if m is None else jnp.asarray(m))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert got.tolist() == [0, 0, 1, 0, 0, 6, 0, 0]


# -- scatter_add -------------------------------------------------------------------


def _close(got, want, val, idx, mask=None):
    got, want = got.numpy(), np.asarray(want)
    size = got.shape[0]
    ok = (idx >= 0) & (idx < size) & (True if mask is None else mask)
    mag = np.zeros(got.shape, np.float64)
    np.add.at(mag, idx[ok], np.abs(val[ok]).astype(np.float64))
    assert (np.abs(got - want) <= 1e-6 * np.abs(want) + 2.0 ** -22 * mag
            + 1e-7).all()


@pytest.mark.parametrize("n,size", [(500, 40),      # the reference's .at[].add
                                    (5000, 16)])    # its dense rewrite
@pytest.mark.parametrize("masked", [False, True])
def test_scatter_add_float(n, size, masked):
    tgt, val, idx, mask = _rng_case(4, n, size)
    m = mask if masked else None
    got = TR.scatter_add(_t(tgt), _t(val), _t(idx),
                         None if m is None else _t(m))
    want = JR.scatter_add(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(idx),
                          None if m is None else jnp.asarray(m))
    _close(got, want, val, idx, m)


@pytest.mark.parametrize("n,size", [(500, 40), (5000, 16)])
def test_scatter_add_masked_drops_negative_and_out_of_range(n, size):
    tgt, val, idx, mask = _rng_case(5, n, size, lo=-4, hi=size + 6)
    got = TR.scatter_add(_t(tgt), _t(val), _t(idx), _t(mask))
    want = JR.scatter_add(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(idx), jnp.asarray(mask))
    _close(got, want, val, idx, mask)


def test_scatter_add_integers_and_scalar_value_are_exact():
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 10, 3000).astype(np.int32)
    val = rng.integers(-50, 50, 3000).astype(np.int32)
    tgt = np.zeros(10, np.int32)
    got = TR.scatter_add(_t(tgt), _t(val), _t(idx))
    want = JR.scatter_add(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    ones = TR.scatter_add(torch.zeros(10), 1.0, _t(idx))
    assert np.array_equal(ones.numpy(), np.bincount(idx, minlength=10))


def test_scatter_add_all_one_bin_conflict():
    n = 100_000
    idx = np.full(n, 3, np.int32)
    val = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    got = TR.scatter_add(torch.zeros(8), _t(val), _t(idx))
    want = JR.scatter_add(jnp.zeros(8), jnp.asarray(val), jnp.asarray(idx))
    # one sum of 1e5 terms, in two orders: against the float64 sum, at
    # f32 summation's error bound for values of this size
    exact = val.astype(np.float64).sum()
    tol = 1e-6 * np.abs(val).sum()
    assert abs(got[3].item() - exact) <= tol
    assert abs(float(want[3]) - exact) <= tol
    assert got.numpy()[[0, 1, 2, 4, 5, 6, 7]].tolist() == [0.0] * 7
    count = TR.scatter_add(torch.zeros(8), 1.0, _t(idx))
    assert count[3].item() == n


def test_scatter_add_rows():
    rng = np.random.default_rng(8)
    tgt = rng.standard_normal((12, 3)).astype(np.float32)
    idx = rng.integers(0, 12, 200).astype(np.int32)
    val = rng.standard_normal((200, 3)).astype(np.float32)
    got = TR.scatter_add(_t(tgt), _t(val), _t(idx))
    want = JR.scatter_add(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(idx))
    _close(got, want, val, idx)


def test_scatter_add_debug_bounds(debug_bounds):
    tgt = np.zeros(8, np.float32)
    idx = np.array([2, -1, 8, 100, 2, 5], np.int32)
    val = np.arange(1, 7, dtype=np.float32)
    got = TR.scatter_add(_t(tgt), _t(val), _t(idx))
    want = JR.scatter_add(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(idx))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, 0, 6, 0, 0, 6, 0, 0]


def test_unmasked_out_of_range_raises_on_the_cpu():
    with pytest.raises((IndexError, RuntimeError)):
        TR.scatter_add(torch.zeros(4), 1.0, torch.tensor([1, 9]))


# -- transform, select, masked_assign ------------------------------------------------


def test_transform():
    rng = np.random.default_rng(9)
    tgt = rng.standard_normal(32).astype(np.float32)
    idx = rng.permutation(32)[:20].astype(np.int32)
    arg = rng.standard_normal(20).astype(np.float32)
    mask = rng.random(20) < 0.5
    for m in (None, mask):
        got = TR.transform(_t(tgt), _t(idx), lambda c, a: c * 2.0 + a,
                           _t(arg), mask=None if m is None else _t(m))
        want = JR.transform(jnp.asarray(tgt), jnp.asarray(idx),
                            lambda c, a: c * 2.0 + a, jnp.asarray(arg),
                            mask=None if m is None else jnp.asarray(m))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_select_and_masked_assign():
    rng = np.random.default_rng(10)
    a = rng.standard_normal(50).astype(np.float32)
    b = rng.standard_normal(50).astype(np.float32)
    m = rng.random(50) < 0.5
    assert np.array_equal(TR.select(_t(m), _t(a), _t(b)).numpy(),
                          np.asarray(JR.select(jnp.asarray(m), a, b)))
    assert np.array_equal(TR.select(_t(m), _t(a), 0.5).numpy(),
                          np.asarray(JR.select(jnp.asarray(m), a, 0.5)))
    assert np.array_equal(TR.masked_assign(_t(a), _t(m), _t(b)).numpy(),
                          np.asarray(JR.masked_assign(a, jnp.asarray(m), b)))
    assert np.array_equal(TR.masked_assign(_t(a), _t(m), -1.0).numpy(),
                          np.asarray(JR.masked_assign(a, jnp.asarray(m),
                                                      -1.0)))


# -- bit-level helpers ---------------------------------------------------------------


def _floats(dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(2000)
         * np.exp(rng.uniform(-30, 30, 2000))).astype(dtype)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 0.5, 2.0, np.inf, -np.inf]
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_frexp_and_ldexp(dtype):
    import jax
    x = _floats(dtype)
    with jax.enable_x64(dtype == np.float64):
        mj, ej = JR.frexp(jnp.asarray(x))
        m, e = TR.frexp(_t(x))
        assert m.numpy().dtype == dtype and np.asarray(mj).dtype == dtype
        assert np.array_equal(m.numpy(), np.asarray(mj), equal_nan=True)
        assert np.array_equal(e.numpy(), np.asarray(ej))
        fin = np.isfinite(x) & (x != 0)
        assert np.array_equal(np.ldexp(m.numpy()[fin], e.numpy()[fin]),
                              x[fin])
        k = np.random.default_rng(12).integers(-20, 20, x.size).astype(
            np.int32)
        got = TR.ldexp(_t(x), _t(k))
        want = JR.ldexp(jnp.asarray(x), jnp.asarray(k))
        assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)
        assert np.array_equal(TR.ldexp(_t(x), 3).numpy(),
                              np.asarray(JR.ldexp(jnp.asarray(x), 3)))


def test_frexp_of_an_integer_tensor_is_taken_in_float32():
    x = np.arange(-4, 9, dtype=np.int32)
    m, e = TR.frexp(_t(x))
    mj, ej = JR.frexp(jnp.asarray(x))
    assert m.dtype == torch.float32
    assert np.array_equal(m.numpy(), np.asarray(mj))
    assert np.array_equal(e.numpy(), np.asarray(ej))


def test_reinterpret():
    x = _floats(np.float32)
    bits = TR.reinterpret(_t(x), torch.int32)
    assert np.array_equal(bits.numpy(), np.asarray(
        JR.reinterpret(jnp.asarray(x), jnp.int32)))
    assert np.array_equal(TR.reinterpret(bits, torch.float32).numpy(), x,
                          equal_nan=True)


def test_next_and_prev_float_and_classification():
    x = _floats(np.float32)
    x[8:10] = [np.nan, 3.4028235e38]
    fin = np.isfinite(x)
    # nextafter at +-0 and at a subnormal result: the CPU backends of the
    # two packages agree on every normal input; compare those exactly
    normal = fin & (np.abs(x) > 1e-30)
    for ours, theirs in ((TR.next_float, JR.next_float),
                         (TR.prev_float, JR.prev_float)):
        got = ours(_t(x)).numpy()
        want = np.asarray(theirs(jnp.asarray(x)))
        assert np.array_equal(got[normal], want[normal])
    assert np.array_equal(TR.next_float(_t(x)).numpy()[fin],
                          np.nextafter(x[fin], np.float32(np.inf)))
    assert np.array_equal(TR.prev_float(_t(x)).numpy()[fin],
                          np.nextafter(x[fin], np.float32(-np.inf)))
    for name in ("isnan", "isinf", "isfinite"):
        assert np.array_equal(getattr(TR, name)(_t(x)).numpy(),
                              np.asarray(getattr(JR, name)(jnp.asarray(x))))
