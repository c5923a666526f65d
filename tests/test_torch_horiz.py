"""The port's ops/horiz.py against the reference's, on the same seeded
numpy inputs, with the reference's own gates (tests/test_horiz.py, the
eager cases of tests/test_widths.py and tests/test_nested_memory.py).

Gates: exact (values and dtype) for integer and mask results, for
``hmax`` / ``hmin``, ``reverse``, ``compress``, ``partition`` and
``segment_offsets``; float ``hsum``, ``hprod``, ``hmean``, ``dot`` and
``psum`` within 2**-22 * sum|x| per output, since the two packages add in
different orders (a float16 or bfloat16 result also within one unit in
its last place, the rounding of the float32 sum; a 16-bit prefix sum
within the reference's own rounding, which scans in the 16-bit dtype);
``normalize`` within 2 ulp plus the sum's order (the reference's rsqrt is
up to 2 ulp off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu import ops as J
from enoki_tpu.ops import horiz as JH
from enoki_tpu_torch import ops as T
from enoki_tpu_torch.ops import horiz as TH

from test_torch_router_ops import WIDTHS, _dtype, _floats, _ints, _np, _t, \
    same

INT_DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.uint8, np.uint16,
              np.uint32]


def _jt(x):
    return jnp.asarray(x), _t(x)


def close_sums(got, want, mag, half=False):
    """Same dtype and shape, and |got - want| <= 2**-22 * mag per output
    (mag: the sum of |terms| that output adds); a 16-bit float result also
    within one unit in its last place."""
    assert _dtype(got) == _dtype(want), (_dtype(got), _dtype(want))
    g, w = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    tol = 2.0**-22 * np.asarray(mag, np.float64)
    if half:
        tol = tol + np.abs(w) * 2.0**-7
    np.testing.assert_array_less(np.abs(g - w), tol + 1e-30)


# -- reductions ---------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", ["hsum", "hmean", "psum"])
def test_float_sums(name, n):
    x = _floats(n, n)
    jx, tx = _jt(x)
    mag = np.abs(x).sum() if name != "psum" else np.cumsum(np.abs(x))
    close_sums(getattr(T, name)(tx), getattr(J, name)(jx), mag)


@pytest.mark.parametrize("n", WIDTHS)
def test_float_products(n):
    x = (1.0 + 0.01 * _floats(n, n)).astype(np.float32)
    jx, tx = _jt(x)
    got, want = T.hprod(tx), J.hprod(jx)
    close_sums(got, want, 2.0 * n * np.abs(np.asarray(want)))


@pytest.mark.parametrize("dtype", [np.float16, jnp.bfloat16],
                         ids=["float16", "bfloat16"])
@pytest.mark.parametrize("name", ["hsum", "hmean", "psum", "hprod"])
def test_half_float_reductions_take_the_references_dtype(name, dtype):
    x = (_floats(300, 1) * (0.01 if name == "hprod" else 1.0)
         + (1.0 if name == "hprod" else 0.0))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(torch.float16 if dtype == np.float16
                                else torch.bfloat16)
    want = getattr(J, name)(jx)
    got = getattr(T, name)(tx)
    if name == "psum":
        # the reference scans in the 16-bit dtype itself, rounding each
        # partial sum (up to 2*log2(n) roundings of 2**-p per output); the
        # port sums in float32 and rounds once
        assert _dtype(got) == _dtype(want)
        p = 11 if dtype == np.float16 else 8
        tol = (2 * np.ceil(np.log2(x.size)) + 1) * 2.0**-p * np.cumsum(
            np.abs(x))
        np.testing.assert_array_less(np.abs(_np(got).astype(np.float64)
                                            - np.asarray(want, np.float64)),
                                     tol)
        return
    mag = (np.abs(x).sum() if name in ("hsum", "hmean")
           else 600 * np.abs(np.asarray(want, np.float32)))
    close_sums(got, want, mag, half=True)


@pytest.mark.parametrize("dtype", INT_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", ["hsum", "hprod", "hmax", "hmin", "hmean",
                                  "psum", "hsum_nested", "hprod_nested",
                                  "hmax_nested", "hmin_nested"])
def test_integer_reductions(name, dtype):
    x = (_ints(dtype, 500, 3) if dtype != np.bool_
         else np.random.default_rng(3).random(500) < 0.5)
    if name in ("hprod", "hprod_nested") and dtype != np.bool_:
        x = x[x != 0][:40]      # wrapping products, not all zero
    jx, tx = _jt(x)
    got, want = getattr(T, name)(tx), getattr(J, name)(jx)
    if name == "hmean":
        close_sums(got, want, np.abs(x.astype(np.float64)).sum() / x.size)
    else:
        same(got, want)


@pytest.mark.parametrize("name,axis", [
    (name, axis) for name in ("hsum", "hmax", "hmin", "hmean", "hprod")
    for axis in (0, 1, -1, None, (0, 1)) if (name, axis) != ("hprod", (0, 1))])
def test_reductions_over_an_axis(name, axis):
    x = np.arange(12, dtype=np.float32).reshape(3, 4) + 1.0
    jx, tx = _jt(x)
    same(getattr(T, name)(tx, axis), getattr(J, name)(jx, axis))
    i = np.arange(24, dtype=np.int32).reshape(2, 3, 4) - 7
    ji, ti = _jt(i)
    if name != "hprod":
        same(getattr(T, name)(ti, axis), getattr(J, name)(ji, axis))


ZERO_DTYPES = {"float16": (torch.float16, jnp.float16),
               "bfloat16": (torch.bfloat16, jnp.bfloat16),
               "float32": (torch.float32, jnp.float32),
               "float64": (torch.float64, jnp.float64)}


def signed_zero_rows(name, n, rows=8, seed=10):
    """Rows of random +-0.0 mixed with negatives (for a maximum) or with
    positives (for a minimum), so that most extremes are a zero whose
    sign the reduction has to choose."""
    rng = np.random.default_rng(seed + n)
    zeros = np.where(rng.random((rows, n)) < 0.5, 0.0, -0.0)
    other = np.abs(rng.normal(size=(rows, n))) + 0.5
    other = -other if "max" in name else other
    return np.where(rng.random((rows, n)) < 0.6, zeros, other)


@pytest.mark.parametrize("n", [4, 17, 1024, 65536])
@pytest.mark.parametrize("dtype", list(ZERO_DTYPES))
@pytest.mark.parametrize("name", ["hmax", "hmin", "hmax_nested",
                                  "hmin_nested"])
def test_extremes_take_the_references_signed_zero(name, dtype, n):
    # C10: where the extreme is 0 and both signs occur, jnp.max gives +0.0
    # and jnp.min -0.0; PyTorch's amax / amin give either. A NaN still
    # propagates (the second input, a NaN at the head of its last row)
    tdt, jdt = ZERO_DTYPES[dtype]
    x = signed_zero_rows(name, n)
    x_nan = x.copy()
    x_nan[-1, 0] = np.nan
    axes = (None,) if name.endswith("nested") else (0, 1, -1, None)
    with jax.enable_x64(dtype == "float64"):
        for data in (x, x_nan):
            tx = torch.from_numpy(data).to(tdt)
            jx = jnp.asarray(data).astype(jdt)
            for axis in axes:
                args = () if axis is None else (axis,)
                got = getattr(T, name)(tx, *args)
                want = getattr(J, name)(jx, *args)
                assert str(got.dtype) == f"torch.{want.dtype}"
                g = got.to(torch.float64).numpy()
                w = np.asarray(want.astype(jnp.float64), np.float64)
                assert g.shape == w.shape
                assert ((g == w) & (np.signbit(g) == np.signbit(w))
                        | np.isnan(g) & np.isnan(w)).all(), (axis, g, w)
                # the data makes the sign matter
                assert data is x_nan or (w == 0).any()
                if data is x_nan or dtype not in ("float32", "float64"):
                    continue
                # the gradient still reaches the tied lanes, as jax.grad's
                tg = tx.clone().requires_grad_(True)
                getattr(T, name)(tg, *args).sum().backward()
                jg = jax.grad(lambda a: getattr(J, name)(a, *args).sum())(jx)
                np.testing.assert_array_equal(tg.grad.numpy(),
                                              np.asarray(jg))


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.bool_, np.float32],
                         ids=lambda d: d.__name__)
def test_psum_along_an_axis(dtype, axis):
    x = (np.arange(35) % 7 - 2).reshape(5, 7)
    x = x > 0 if dtype == np.bool_ else x.astype(dtype)
    jx, tx = _jt(x)
    same(T.psum(tx, axis), J.psum(jx, axis))


# -- mask reductions ------------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_mask_reductions(p, n):
    m = np.random.default_rng(n).random(n) < p
    jm, tm = _jt(m)
    for name in ("all_", "any_", "none", "count", "all_nested",
                 "any_nested", "none_nested", "count_nested"):
        same(getattr(T, name)(tm), getattr(J, name)(jm))


@pytest.mark.parametrize("axis", [0, 1, None])
def test_mask_reductions_over_an_axis(axis):
    m = np.arange(12).reshape(3, 4) > 5
    jm, tm = _jt(m)
    for name in ("all_", "any_", "none", "count"):
        same(getattr(T, name)(tm, axis), getattr(J, name)(jm, axis))
    # a float or integer mask is taken by its truth
    f = np.float32([0.0, 2.0, np.nan, -1.0])
    for name in ("all_", "any_", "none", "all_nested", "any_nested",
                 "none_nested"):
        same(getattr(T, name)(_t(f)), getattr(J, name)(jnp.asarray(f)))


# -- dot, norm, normalize ----------------------------------------------------------------


@pytest.mark.parametrize("n", WIDTHS)
def test_dot_family(n):
    a, b = _floats(n, 20), _floats(n, 21)
    (ja, ta), (jb, tb) = _jt(a), _jt(b)
    mag = np.abs(a * b).sum()
    close_sums(T.dot(ta, tb), J.dot(ja, jb), mag)
    close_sums(T.abs_dot(ta, tb), J.abs_dot(ja, jb), mag)
    close_sums(T.squared_norm(ta), J.squared_norm(ja), (a * a).sum())
    # sqrt halves the sum's relative error, then rounds once more
    want = np.asarray(J.norm(ja))
    close_sums(T.norm(ta), want, np.abs(want) * 2.0)


@pytest.mark.parametrize("w", [1, 3, 31, 32])
def test_normalize(w):
    a = _floats(200 * w, w).reshape(200, w)
    ja, ta = _jt(a)
    got, want = T.normalize(ta), np.asarray(J.normalize(ja))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # 2 ulp of the reference's rsqrt and one of the product, on top of the
    # sum's order (2**-22 relative): 2**-20 of |result|
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 2.0**-20 * np.abs(want) + 1e-45)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-6)


def test_integer_dot_and_norm_dtypes():
    a = np.arange(-5, 6, dtype=np.int32)
    ja, ta = _jt(a)
    same(T.dot(ta, ta), J.dot(ja, ja))
    same(T.abs_dot(ta, -ta), J.abs_dot(ja, -ja))
    same(T.norm(ta), J.norm(ja))


# -- reverse, compress, partition, segment_offsets ------------------------------------------


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32, np.bool_],
                         ids=lambda d: d.__name__)
def test_horiz_reverse(dtype, axis):
    x = (np.arange(20).reshape(4, 5) * 37 % 11).astype(dtype)
    jx, tx = _jt(x)
    same(TH.reverse(tx, axis), JH.reverse(jx, axis))
    same(TH.reverse(tx), JH.reverse(jx))


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32],
                         ids=lambda d: d.__name__)
def test_compress(dtype, n):
    rng = np.random.default_rng(n)
    x = (_floats(n, n) * 1000).astype(dtype)
    for p in (0.0, 0.4, 1.0):
        m = rng.random(n) < p
        for fill in (0, 7):
            gp, gc = T.compress(_t(x), _t(m), fill)
            wp, wc = J.compress(jnp.asarray(x), jnp.asarray(m), fill)
            same(gp, wp)
            same(gc, wc)


def test_compress_gates_of_the_reference():
    x = torch.tensor([10.0, 11.0, 12.0, 13.0, 14.0])
    m = torch.tensor([False, True, False, True, True])
    packed, n = T.compress(x, m)
    assert int(n) == 3 and n.dtype == torch.int32
    assert packed.tolist() == [11, 13, 14, 0, 0]
    assert T.extract(x, m).tolist() == [11.0]


@pytest.mark.parametrize("n,m", [(1, 1), (31, 4), (32, 40), (1000, 7),
                                 (1000, 300), (10_000, 64)])
def test_partition(n, m):
    rng = np.random.default_rng(n + m)
    keys = rng.integers(-2, m + 3, n).astype(np.int32)
    got = T.partition(_t(keys), m)
    want = J.partition(jnp.asarray(keys), m)
    for g, w in zip(got, want):
        same(g, w)
    same(T.segment_offsets(got[1]), J.segment_offsets(want[1]))


def test_partition_gates_of_the_reference():
    keys = torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32)
    unique, counts, perm = T.partition(keys, max_instances=4)
    assert unique.tolist() == [0, 1, 2, -1]
    assert counts.tolist() == [2, 1, 3, 0]
    assert keys[perm.long()].tolist() == [0, 0, 1, 2, 2, 2]
    assert perm.tolist() == [1, 4, 3, 0, 2, 5]
    assert T.segment_offsets(counts).tolist() == [0, 2, 3, 6]
    # a key >= max_instances stays in perm only (the reference's drop)
    unique, counts, perm = T.partition(torch.tensor([5, 0, 1]), 2)
    assert (unique.tolist(), counts.tolist(), perm.tolist()) == (
        [0, 1], [1, 1], [1, 2, 0])
    assert {unique.dtype, counts.dtype, perm.dtype} == {torch.int32}


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8],
                         ids=lambda d: d.__name__)
def test_segment_offsets(dtype):
    c = np.random.default_rng(5).integers(0, 9, 50).astype(dtype)
    same(T.segment_offsets(_t(c)), J.segment_offsets(jnp.asarray(c)))


# -- the reference's own gates ------------------------------------------------------------


def test_reductions_gates_of_the_reference():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert [T.hsum(x), T.hprod(x), T.hmax(x), T.hmin(x), T.hmean(x)] == [
        10, 24, 4, 1, 2.5]
    assert T.psum(x).tolist() == [1, 3, 6, 10]
    assert T.hmean(torch.tensor([1, 2, 3, 4], dtype=torch.int32)).item() \
        == 2.5
    m = torch.tensor([True, False, True])
    assert T.any_(m) and not T.all_(m) and not T.none(m)
    assert T.count(m) == 2
    a = torch.tensor([1.0, 2.0, 2.0])
    assert T.dot(a, a) == 9 and T.norm(a) == 3 and T.squared_norm(a) == 9
    assert abs(T.norm(T.normalize(a)).item() - 1.0) < 1e-6
    y = torch.arange(12.0).reshape(3, 4)
    assert T.hsum_nested(y) == 66 and T.hmax_nested(y) == 11


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 31, 32, 127, 1000])
def test_horizontal_all_widths(n):
    x = T.arange(n, dtype=torch.float32, device="cpu")
    assert float(T.hsum(x)) == n * (n - 1) / 2
    assert float(T.hmax(x)) == n - 1
    np.testing.assert_allclose(T.psum(x).numpy(),
                               np.cumsum(np.arange(n, dtype=np.float64)),
                               rtol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 31, 1000])
def test_select_mask_all_widths(n):
    x = T.arange(n, dtype=torch.float32, device="cpu")
    z = T.select(x > n / 2, x, -x).numpy()
    xs = np.arange(n, dtype=np.float32)
    np.testing.assert_allclose(z, np.where(xs > n / 2, xs, -xs))


def test_nested_reductions_and_masks():
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    np.testing.assert_allclose(T.hsum(a, axis=0).numpy(),
                               np.arange(12).reshape(3, 4).sum(0))
    assert float(T.hsum_nested(a)) == 66.0 and float(T.hmax_nested(a)) == 11
    m = a > 5.0
    assert bool(T.any_(m)) and not bool(T.all_(m))
    assert T.any_(m, axis=1).tolist() == [False, True, True]


def test_extract_and_compress_roundtrip():
    x = torch.tensor([1., 2., 3., 4., 5.])
    m = torch.tensor([False, True, False, True, True])
    assert float(T.extract(x, m)[0]) == 2.0
    packed, cnt = T.compress(x, m)
    assert int(cnt) == 3 and packed[:3].tolist() == [2, 4, 5]


def test_nested_struct_reduction_pipeline():
    from enoki_tpu_torch.render.vec import Vec3, dot3
    n = 16
    v = Vec3(torch.ones(n), torch.full((n,), 2.0), torch.full((n,), 3.0))
    d = dot3(v, v)
    assert d.tolist() == [14.0] * n and float(T.hsum(d)) == 14.0 * n
