"""The port's polynomial evaluators, ``log`` and ``erfinv`` against the
reference's on the same seeded numpy inputs, and against scipy under the
reference's own gates.

Tolerances: ``polys`` in float64 exact, in float32 within 1 ulp (the
reference's compiler may contract a product and a sum into one rounding);
``log`` and ``erfinv`` with ``impl="poly"`` within 2 ulp of the
reference's poly; against scipy the gates of tests/test_special.py
(erfinv f32 max abs error < 5e-6, f64 < 12 ulp max and < 1 ulp mean)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

from enoki_tpu.ops import math as JM, polys as JP, special as JS
from enoki_tpu_torch import ops as TO
from enoki_tpu_torch.ops import math as TM, polys as TP, special as TS

POLY = "poly"


def _ulps(got, want):
    """|got - want| in units of want's spacing (0 where both are equal,
    infinities and NaN included)."""
    got, want = np.asarray(got), np.asarray(want)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore", over="ignore"):
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        u = d / np.spacing(np.abs(want)).astype(np.float64)
    return np.where(same, 0.0, u)


def _coeffs(k):
    return [float(c) for c in
            np.random.default_rng(100 + k).uniform(-2.0, 2.0, k + 1)]


@pytest.mark.parametrize("degree", range(2, 11))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_polys_against_the_reference(degree, dtype):
    x = np.random.default_rng(degree).uniform(-1.5, 1.5, 4000).astype(dtype)
    c = _coeffs(degree)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(getattr(JP, f"poly{degree}")(jnp.asarray(x), *c))
        want_h = np.asarray(JP.horner(jnp.asarray(x), c))
    got = getattr(TP, f"poly{degree}")(torch.from_numpy(x), *c).numpy()
    got_h = TP.horner(torch.from_numpy(x), c).numpy()
    assert got.dtype == dtype and want.dtype == dtype
    if dtype == np.float64:
        assert np.array_equal(got, want) and np.array_equal(got_h, want_h)
    else:
        assert _ulps(got, want).max() <= 1.0
        assert _ulps(got_h, want_h).max() <= 1.0
    # and the polynomial itself, in float64: a few roundings of the
    # largest term
    polyval = np.polynomial.polynomial.polyval
    exact = polyval(x.astype(np.float64), c)
    scale = polyval(np.abs(x).astype(np.float64), np.abs(c))
    eps = 2.0 ** -50 if dtype == np.float64 else 2.0 ** -21
    assert (np.abs(got - exact) <= eps * scale).all()


def test_polys_round_coefficients_to_a_two_byte_dtype():
    x = torch.linspace(-1, 1, 64).to(torch.bfloat16)
    c = (0.1234567, -0.7654321, 0.3333333)
    cb = [torch.tensor(v, dtype=torch.bfloat16) for v in c]
    x2 = x * x
    assert torch.equal(TP.poly2(x, *c), x2 * cb[2] + (x * cb[1] + cb[0]))
    assert TP.poly2(x, *c).dtype == torch.bfloat16


def _log_inputs(dtype):
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(-80, 80, 50000)).astype(dtype)
    x[:6] = [1.0, 0.5, 2.0, 0.70710678, 1.4142135, 10.0]
    return x


def test_log_poly_f32():
    x = _log_inputs(np.float32)
    got = TM.log(torch.from_numpy(x), POLY).numpy()
    want = np.asarray(JM.log(jnp.asarray(x), POLY))
    assert got.dtype == np.float32
    assert _ulps(got, want).max() <= 2.0
    # the reference's published bound: 1 ulp max against the true log
    assert _ulps(got, np.log(x.astype(np.float64)).astype(np.float32)
                 ).max() <= 1.0
    assert TO.log is TM.log


def test_log_poly_f64():
    x = _log_inputs(np.float64)
    got = TM.log(torch.from_numpy(x), POLY).numpy()
    with jax.enable_x64():
        want = np.asarray(JM.log(jnp.asarray(x), POLY))
    assert got.dtype == np.float64 and want.dtype == np.float64
    assert _ulps(got, want).max() <= 2.0
    assert _ulps(got, np.log(x)).max() <= 2.0


def test_log_special_values_and_dtypes():
    x = np.array([np.nan, 0.0, -0.0, -1.0, np.inf, -np.inf, 1.0],
                 np.float32)
    for impl in ("native", POLY):
        got = TM.log(torch.from_numpy(x), impl).numpy()
        want = np.asarray(JM.log(jnp.asarray(x), impl))
        assert np.array_equal(got, want, equal_nan=True), impl
        assert np.isnan(got[0]) and np.isnan(got[3]) and np.isnan(got[5])
        assert got[1] == -np.inf and got[2] == -np.inf
        assert got[4] == np.inf and got[6] == 0.0
    # integers are taken in float32, 2-byte floats computed in float32
    i = TM.log(torch.arange(1, 9), POLY)
    assert i.dtype == torch.float32
    assert np.array_equal(i.numpy(), np.asarray(
        JM.log(jnp.arange(1, 9), POLY)))
    xb = torch.linspace(0.1, 30, 500).to(torch.bfloat16)
    gb = TM.log(xb, POLY)
    assert gb.dtype == torch.bfloat16
    wb = JM.log(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), POLY)
    assert np.array_equal(gb.float().numpy(),
                          np.asarray(wb.astype(jnp.float32)))
    x32 = torch.from_numpy(_log_inputs(np.float32))
    assert torch.equal(TM.log(x32), torch.log(x32))


def _sweep(lo, hi, n=20000, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


def test_erfinv_poly_f32():
    x = _sweep(-0.999, 0.999)
    got = TS.erfinv(torch.from_numpy(x), POLY).numpy()
    want = np.asarray(JS.erfinv(jnp.asarray(x), POLY))
    assert got.dtype == np.float32
    assert _ulps(got, want).max() <= 2.0
    assert np.abs(got.astype(np.float64)
                  - sp.erfinv(x.astype(np.float64))).max() < 5e-6
    # the tail, where the second polynomial takes over (w >= 5)
    t = np.concatenate([1.0 - np.exp(_sweep(-16, -5, 2000, 1)),
                        np.exp(_sweep(-16, -5, 2000, 2)) - 1.0]).astype(
                            np.float32)
    got = TS.erfinv(torch.from_numpy(t), POLY).numpy()
    want = np.asarray(JS.erfinv(jnp.asarray(t), POLY))
    assert _ulps(got, want).max() <= 2.0
    assert TO.erfinv is TS.erfinv


def test_erfinv_native_meets_the_reference_gate():
    x = _sweep(-0.999, 0.999)
    got = TS.erfinv(torch.from_numpy(x)).numpy().astype(np.float64)
    assert np.abs(got - sp.erfinv(x.astype(np.float64))).max() < 5e-6
    assert torch.equal(TS.erfinv(torch.from_numpy(x)),
                       torch.special.erfinv(torch.from_numpy(x)))


def test_erfinv_poly_f64():
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.99999999999, 0.99999999999, 100000)
    got = TS.erfinv(torch.from_numpy(x), POLY).numpy()
    want = sp.erfinv(x)
    ulp = np.abs(got - want) / np.spacing(np.abs(want))
    assert got.dtype == np.float64
    assert ulp.max() < 12.0 and ulp.mean() < 1.0
    with jax.enable_x64():
        ref = np.asarray(JS.erfinv(jnp.asarray(x, jnp.float64), POLY))
    # two Newton steps on two packages' erf / erfc / exp: both within the
    # gate above of scipy, hence within twice that of each other
    assert _ulps(got, ref).max() < 24.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_erfinv_at_the_ends(dtype):
    x = torch.tensor([1.0, -1.0, 0.0, -0.0], dtype=dtype)
    for impl in ("native", POLY):
        y = TS.erfinv(x, impl)
        assert y.dtype == dtype
        assert y[0] == np.inf and y[1] == -np.inf and y[2] == 0 and y[3] == 0
    assert np.isnan(TS.erfinv(torch.tensor([np.nan], dtype=dtype),
                              POLY)).all()
    # an integer tensor is taken in float32
    assert TS.erfinv(torch.tensor([0, 1, -1]), POLY).tolist() == [
        0.0, np.inf, -np.inf]
