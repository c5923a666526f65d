"""The port's polynomial evaluators, ``log`` and ops/special.py against
the reference's on the same seeded numpy inputs, and against scipy and
mpmath under the reference's own gates (tests/test_special.py).

Tolerances: ``polys`` in float64 exact, in float32 within 1 ulp (the
reference's compiler may contract a product and a sum into one rounding);
``log`` and ``erfinv`` with ``impl="poly"`` within 2 ulp of the
reference's poly; against scipy the gates of tests/test_special.py
(erfinv f32 max abs error < 5e-6, f64 < 12 ulp max and < 1 ulp mean).
Every other special function with ``impl="poly"`` (or without an impl)
meets each gate of tests/test_special.py, and is held to the reference's
poly on the same inputs, float32 and float64, within the tolerance that
test uses against scipy for that function:
  erf abs 2e-7, erfc rel 5e-5 (where erfc > 1e-37), i0e rel 1e-5, dawson
  rel 2e-6, erfi rel 1e-4, lgamma abs 1e-3 (x > 0) and 2e-3 (x < 0),
  tgamma and gamma rel 1e-4, carlson_rf / rd / rc rel 1e-4, carlson_rj rel
  1e-3, ellint_1 / ellint_2 / comp_ellint_1 / comp_ellint_2 abs 1e-4,
  ellint_3 and comp_ellint_3 abs 1e-3; in float64 erf and erfc 8 ulp, i0e
  6 ulp, dawson 40 ulp, erfi 20 ulp, lgamma 16 ulp (x > 0) and 1e-14 *
  max(|lgamma|, 1) (x < 0), the others as in float32.
``impl="native"`` (``torch.special.erf`` / ``erfc`` / ``i0e``,
``torch.lgamma``) meets the same gates against scipy."""

import functools

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


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test in one CPU thread. PyTorch's CPU build (MKL's vector math)
    may compute the first transcendental call after its thread pool is
    built at a lower accuracy in one worker thread's chunk (float32-like
    in float64: atan 1.6e7 ulp; sin float32 2.5e3 ulp; docs/port.md), a
    fault of PyTorch's CPU path and not of the port; the gates hold the
    functions, computed in the calling thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# -- the rest of ops/special.py ---------------------------------------------


def _rel(got, want, floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), floor)


def _abs(got, want):
    return np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))


def _f64_ulps(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.spacing(np.abs(want))


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _quad_ellint_3(phi, k, n):
    from scipy.integrate import quad
    return np.array([
        quad(lambda t, kk=kk, nn=nn: 1.0 / ((1 - nn * np.sin(t) ** 2)
             * np.sqrt(1 - kk * kk * np.sin(t) ** 2)), 0, p)[0]
        for p, kk, nn in zip(phi, k, n)])


def _carlson_args(seed, k):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 5, 2000)] + [rng.uniform(0.01, 5, 2000)
                                          for _ in range(k - 1)]


def _ellint_args(seed, lo=-0.49, hi=0.49, kmax=0.95, n=2000):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo * np.pi, hi * np.pi, n), rng.uniform(0.0, kmax, n)]


def _lgamma_args():
    x = _sweep(0.01, 30)
    xn = _sweep(-4.9, -0.1, seed=1)
    return np.concatenate([x, xn[np.abs(xn - np.round(xn)) > 0.05]])


def _lgamma_gate(got, want, x):
    return np.where(x > 0, _abs(got, want) < 1e-3, _abs(got, want) < 2e-3)


@functools.lru_cache(maxsize=None)
def _ellint3_case():
    rng = np.random.default_rng(8)
    phi = rng.uniform(-0.4 * np.pi, 0.4 * np.pi, 500)[:50]
    k = rng.uniform(0.0, 0.9, 500)[:50]
    n = rng.uniform(-0.5, 0.5, 500)[:50]
    return [phi, k, -n], _quad_ellint_3(phi, k, n)


# (name, arguments as float64 numpy, impl or None, scipy truth or None,
#  gate(got, want, args) -> bool array) -- tests/test_special.py, case by
# case; the float32 runs round the arguments once
SPECIAL_CASES = {
    "erf": (lambda: [_sweep(-6, 6)], POLY, sp.erf,
            lambda g, w, a: _abs(g, w) < 2e-7),
    "erfc": (lambda: [_sweep(-4, 9)], POLY, sp.erfc,
             lambda g, w, a: ~(np.asarray(w) > 1e-37) | (_rel(g, w) < 5e-5)),
    "i0e": (lambda: [_sweep(-50, 50)], POLY, sp.i0e,
            lambda g, w, a: _rel(g, w) < 1e-5),
    "dawson": (lambda: [_sweep(-20, 20)], None, sp.dawsn,
               lambda g, w, a: _rel(g, w) < 2e-6),
    "erfi": (lambda: [_sweep(-3, 3)], None, sp.erfi,
             lambda g, w, a: _rel(g, w) < 1e-4),
    "lgamma": (lambda: [_lgamma_args()], POLY, sp.gammaln,
               lambda g, w, a: _lgamma_gate(g, w, a[0])),
    "tgamma": (lambda: [np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 4.0])], None,
               sp.gamma, lambda g, w, a: _rel(g, w) < 1e-4),
    "gamma": (lambda: [_sweep(0.1, 6)], POLY, sp.gamma,
              lambda g, w, a: _rel(g, w) < 1e-4),
    "carlson_rf": (lambda: _carlson_args(2, 3), None, sp.elliprf,
                   lambda g, w, a: _rel(g, w) < 1e-4),
    "carlson_rd": (lambda: _carlson_args(3, 3), None, sp.elliprd,
                   lambda g, w, a: _rel(g, w) < 1e-4),
    "carlson_rc": (lambda: _carlson_args(4, 2), None, sp.elliprc,
                   lambda g, w, a: _rel(g, w) < 1e-4),
    "carlson_rj": (lambda: _carlson_args(5, 4), None, sp.elliprj,
                   lambda g, w, a: _rel(g, w) < 1e-3),
    "ellint_1": (lambda: _ellint_args(6), None,
                 lambda phi, k: sp.ellipkinc(phi, k * k),
                 lambda g, w, a: _abs(g, w) < 1e-4),
    "ellint_1 beyond the quadrant": (
        lambda: [np.array([2.0, 3.0, -2.5]), np.array([0.5, 0.3, 0.7])],
        None, lambda phi, k: sp.ellipkinc(phi, k * k),
        lambda g, w, a: _abs(g, w) < 1e-4),
    "comp_ellint_1": (lambda: [np.linspace(0, 0.95, 100)], None,
                      lambda k: sp.ellipkm1(1 - k * k),
                      lambda g, w, a: _abs(g, w) < 1e-4),
    "comp_ellint_2": (lambda: [np.linspace(0, 0.95, 100)], None,
                      lambda k: sp.ellipe(k * k),
                      lambda g, w, a: _abs(g, w) < 1e-4),
    "ellint_2": (lambda: _ellint_args(7), None,
                 lambda phi, k: sp.ellipeinc(phi, k * k),
                 lambda g, w, a: _abs(g, w) < 1e-4),
    "ellint_3": (lambda: _ellint3_case()[0], None, None,
                 lambda g, w, a: _abs(g, w) < 1e-3),
    "comp_ellint_3": (lambda: [np.linspace(0, 0.9, 50),
                               np.linspace(-0.5, 0.5, 50)], None, None,
                      lambda g, w, a: _abs(g, w) < 1e-3),
}


def _call(mod, name, args, impl):
    fn = getattr(mod, name.split()[0])
    return fn(*args) if impl is None else fn(*args, impl)


@pytest.mark.parametrize("name", list(SPECIAL_CASES))
def test_special_poly_meets_the_reference_gate(name):
    make, impl, truth, gate = SPECIAL_CASES[name]
    args = [a.astype(np.float32) for a in make()]
    got = _call(TS, name, _t(*args), impl).numpy()
    assert got.dtype == np.float32
    if name == "ellint_3":
        want = _ellint3_case()[1]
    elif truth is None:  # comp_ellint_3: the incomplete one at pi/2
        want = _call(TS, "ellint_3", _t(np.full_like(args[0], np.pi / 2),
                                         *args), None).numpy()
        want = want.astype(np.float64)
    else:
        want = truth(*(a.astype(np.float64) for a in args))
    assert gate(got, want, args).all(), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(SPECIAL_CASES))
def test_special_poly_matches_the_reference(name, dtype):
    make, impl, _, gate = SPECIAL_CASES[name]
    args = [a.astype(dtype) for a in make()]
    got = _call(TS, name, _t(*args), impl).numpy()
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(_call(JS, name, _j(*args), impl))
    assert got.dtype == dtype and want.dtype == dtype
    assert gate(got, want, args).all(), name


@pytest.mark.parametrize("name", ["erf", "erfc", "i0e", "lgamma", "tgamma"])
def test_special_native_meets_the_reference_gate(name):
    make, _, truth, gate = SPECIAL_CASES[name]
    args = [a.astype(np.float32) for a in make()]
    got = _call(TS, name, _t(*args), "native")
    want = {"erf": torch.special.erf, "erfc": torch.special.erfc,
            "i0e": torch.special.i0e, "lgamma": torch.lgamma}.get(name)
    if want is not None:
        assert torch.equal(got, want(*_t(*args)))
    assert gate(got.numpy(), truth(*(a.astype(np.float64) for a in args)),
                args).all(), name


def test_erf_roundtrip_of_erfinv():
    # histogram.cpp relies on this for normal sampling
    x = _sweep(-0.999, 0.999)
    rt = TS.erf(TS.erfinv(torch.from_numpy(x), POLY), POLY).numpy()
    assert np.abs(rt - x).max() < 1e-5


def test_lgamma_near_zeros():
    rng = np.random.default_rng(3)
    for zero in (1.0, 2.0):
        x = (zero + rng.uniform(-0.01, 0.01, 5000)).astype(np.float32)
        want = sp.gammaln(x.astype(np.float64))
        keep = np.abs(want) > 0
        got = TS.lgamma(torch.from_numpy(x[keep]), POLY).numpy()
        assert _rel(got, want[keep]).max() < 1e-5, zero


def test_lgamma_ulp_bound():
    rng = np.random.default_rng(4)
    x = rng.uniform(0.1, 30, 100000).astype(np.float32)
    want = sp.gammaln(x.astype(np.float64))
    got = TS.lgamma(torch.from_numpy(x), POLY).numpy().astype(np.float64)
    w32 = want.astype(np.float32)
    keep = np.isfinite(want) & (want != 0)
    ulp = (np.abs(got - w32.astype(np.float64))
           / np.spacing(np.abs(w32)).astype(np.float64))[keep]
    assert ulp.mean() < 1.5 and ulp.max() < 64, (ulp.mean(), ulp.max())


def test_erf_erfc_f64_poly():
    import mpmath as mp
    mp.mp.dps = 40
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(-2, 2, 400), rng.uniform(2, 26.5, 300),
                        rng.uniform(-26.5, -2, 200)])
    for fn, ref in [(TS.erf, mp.erf), (TS.erfc, mp.erfc)]:
        got = fn(torch.from_numpy(x), POLY).numpy()
        want = np.array([float(ref(v)) for v in x])
        keep = np.abs(want) > 2.3e-308
        ulp = _f64_ulps(got[keep], want[keep])
        assert ulp.max() <= 8.0 and ulp.mean() < 1.0, fn.__name__
    assert TS.erfc(torch.tensor(27.5, dtype=torch.float64), POLY) == 0.0
    assert TS.erf(torch.tensor(-30.0, dtype=torch.float64), POLY) == -1.0


def test_dawson_erfi_i0e_f64():
    import mpmath as mp
    mp.mp.dps = 40
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-6, 6, 300), rng.uniform(-60, 60, 300)])
    got = TS.dawson(torch.from_numpy(x)).numpy()
    want = np.array([float(mp.sqrt(mp.pi) / 2 * mp.exp(-mp.mpf(v) ** 2)
                           * mp.erfi(mp.mpf(v))) for v in x])
    ulp = _f64_ulps(got, want)
    assert ulp.max() <= 40.0 and ulp.mean() < 4.0
    got = TS.i0e(torch.from_numpy(x), POLY).numpy()
    want = np.array([float(mp.besseli(0, float(v)) * mp.exp(-abs(float(v))))
                     for v in x])
    assert _f64_ulps(got, want).max() <= 6.0
    xe = rng.uniform(-26, 26, 300)
    got = TS.erfi(torch.from_numpy(xe)).numpy()
    want = np.array([float(mp.erfi(float(v))) for v in xe])
    assert _f64_ulps(got, want).max() <= 20.0


def test_lgamma_f64_poly_factored_zeros():
    import mpmath as mp
    mp.mp.dps = 40
    rng = np.random.default_rng(3)
    for lo, hi, bound in [(1e-8, 0.5, 4), (0.5, 2.75, 8), (2.75, 8.0, 16),
                          (8.0, 1e6, 5)]:
        x = rng.uniform(lo, hi, 1500)
        got = TS.lgamma(torch.from_numpy(x), POLY).numpy()
        want = np.array([float(mp.loggamma(v)) for v in x])
        keep = want != 0
        assert _f64_ulps(got[keep], want[keep]).max() <= bound, (lo, hi)
    for z in (1.0, 2.0):
        x = z + np.linspace(-1e-6, 1e-6, 51)[1::2]
        got = TS.lgamma(torch.from_numpy(x), POLY).numpy()
        want = np.array([float(mp.loggamma(v)) for v in x])
        assert _f64_ulps(got, want).max() <= 8.0
    xn = rng.uniform(-20, -0.01, 1500)
    xn = xn[np.abs(xn - np.round(xn)) > 1e-3]
    got = TS.lgamma(torch.from_numpy(xn), POLY).numpy()
    want = np.array([float(mp.log(abs(mp.gamma(v)))) for v in xn])
    assert (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max() < 1e-14
    assert TS.lgamma(torch.tensor(-3.0, dtype=torch.float64), POLY) == np.inf


def test_special_values_at_infinity_and_signed_zero():
    f32 = torch.float32
    inf32 = torch.tensor(np.inf, dtype=f32)
    for xv in (2000.0, -2000.0):
        got = TS.dawson(torch.tensor(xv)).item()
        assert got == pytest.approx(float(sp.dawsn(xv)), rel=2e-5), xv
    assert TS.dawson(inf32).item() == 0.0 and TS.dawson(-inf32).item() == 0.0
    inf64 = torch.tensor(np.inf, dtype=torch.float64)
    assert TS.erfi(inf64).item() == np.inf
    assert TS.erfi(-inf64).item() == -np.inf
    assert TS.lgamma(inf32, POLY).item() == np.inf
    assert TS.lgamma(-inf32, POLY).item() == np.inf
    assert TS.tgamma(torch.tensor(0.0), POLY).item() == np.inf
    assert TS.tgamma(torch.tensor(-0.0), POLY).item() == -np.inf
    for dtype in (f32, torch.float64):
        assert torch.signbit(TS.erf(torch.tensor(-0.0, dtype=dtype), POLY))
    assert TM.hypot(inf32, inf32).item() == np.inf
    # the f32 lgamma reflection reduces the sin argument exactly
    x = np.float32(-2999999.25)
    got = TS.lgamma(torch.tensor(x), POLY).item()
    assert got == pytest.approx(float(sp.gammaln(np.float64(x))), rel=3e-6)


def _grad(fn, v, dtype=torch.float32):
    x = torch.tensor(v, dtype=dtype, requires_grad=True)
    fn(x).sum().backward()
    return x.grad


GRAD_FNS = {"i0e": lambda v: TS.i0e(v, POLY), "erf": lambda v: TS.erf(v, POLY),
            "dawson": lambda v: TS.dawson(v)}


@pytest.mark.parametrize("name", list(GRAD_FNS))
def test_masked_branch_gradients_finite(name):
    # the untaken branch must not poison the gradient through the where
    # (0 * inf = NaN) for a huge argument
    assert torch.isfinite(_grad(GRAD_FNS[name], 1e20)).all()


def test_dawson_gradient_at_zero():
    assert _grad(TS.dawson, 0.0).item() == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("name", list(GRAD_FNS))
def test_gradients_match_the_reference(name):
    # not at 0, where jnp.abs has slope 1 and torch.abs 0, nor past
    # dawson's |x| = 30 (below)
    x = np.array([-3.0, -0.7, 0.3, 1.5, 9.0, 25.0], np.float32)
    got = _grad(GRAD_FNS[name], x).numpy()
    jfn = {"i0e": lambda v: JS.i0e(v, POLY), "erf": lambda v: JS.erf(v, POLY),
           "dawson": JS.dawson}[name]
    want = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v)))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_ops_exports_every_special_function():
    for name in ("erf", "erfc", "erfinv", "i0e", "dawson", "erfi", "lgamma",
                 "tgamma", "gamma", "carlson_rf", "carlson_rd", "carlson_rc",
                 "carlson_rj", "comp_ellint_1", "ellint_1", "comp_ellint_2",
                 "ellint_2", "comp_ellint_3", "ellint_3"):
        assert getattr(TO, name) is getattr(TS, name), name


def test_dawson_gradient_in_the_tail_is_the_derivative():
    # D'(x) = 1 - 2 x D(x). The reference's mulsign is a sign-bit XOR with
    # no gradient, so its dawson gradient past |x| = 30 misses the tail's
    # 1/(2x) term; the port's mulsign is a select and carries it
    x = np.array([-400.0, -40.0, 31.0, 40.0, 1000.0])
    want = 1.0 - 2.0 * x * sp.dawsn(x)
    got = _grad(TS.dawson, x.astype(np.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
