"""The 'one source, every backend' sweep of the port (twin of
tests/test_unified_surface.py) on the CPU.

Every routed free function of the port's ``ops`` surface is called with
tensors and with CPU ``trace.LazyArray``s on the same numpy inputs, and
so is its counterpart in ``enoki_tpu``. The port's lazy call must stay on
the trace (return a LazyArray), and its result must agree with the
port's eager result and with the reference's lazy result under the
reference test's own gates: rtol 3e-5 / atol 2e-6 for the default
(native) route, whose lazy transcendentals are the trace's opcodes (the
float64 function rounded once) while the eager ones are PyTorch's
float32 functions, an ulp apart at most; rtol 1e-6 for ``impl="poly"``.
The lazy poly route is the same IEEE arithmetic as the eager one and is
held to it bit for bit. The float64 cases run the reference under
``jax.enable_x64``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu import ops as JO
from enoki_tpu_torch import ops as PO


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh traces, and each test in one CPU thread (PyTorch's CPU
    transcendentals may be computed coarsely in a pool worker's first
    chunk, docs/port.md)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()
    torch.set_num_threads(n)


POS = np.linspace(0.05, 2.5, 41).astype(np.float32)        # positive domain
SYM = np.linspace(-1.4, 1.4, 41).astype(np.float32)        # symmetric
UNIT = np.linspace(-0.97, 0.97, 41).astype(np.float32)     # open unit
GT1 = np.linspace(1.05, 4.0, 41).astype(np.float32)        # > 1


def fns(name):
    """(reference function, port function) for "math.sin",
    "special.erf" or "sqrt" (the flat ops surface)."""
    mod, _, attr = name.rpartition(".")
    j = getattr(JO, mod) if mod else JO
    p = getattr(PO, mod) if mod else PO
    return getattr(j, attr), getattr(p, attr)


def JL(a):
    return J.LazyArray(np.asarray(a))


def PL(a):
    return P.LazyArray(np.asarray(a), device="cpu")


def PT(a):
    return torch.from_numpy(np.ascontiguousarray(a))


UNARY = [
    ("math.sin", SYM), ("math.cos", SYM), ("math.tan", UNIT),
    ("math.cot", POS), ("math.asin", UNIT), ("math.acos", UNIT),
    ("math.atan", SYM), ("math.exp", SYM), ("math.exp2", SYM),
    ("math.log", POS), ("math.log2", POS), ("math.log1p", POS),
    ("math.expm1", SYM), ("math.cbrt", SYM), ("math.sinh", SYM),
    ("math.cosh", SYM), ("math.tanh", SYM), ("math.csch", POS),
    ("math.sech", SYM), ("math.coth", POS), ("math.asinh", SYM),
    ("math.acosh", GT1), ("math.atanh", UNIT),
    ("special.erf", SYM), ("special.erfc", SYM), ("special.erfinv", UNIT),
    ("special.dawson", SYM), ("special.erfi", UNIT), ("special.i0e", SYM),
    ("special.lgamma", POS), ("special.tgamma", POS), ("special.gamma", POS),
    ("special.comp_ellint_1", UNIT * 0.6),
    ("special.comp_ellint_2", UNIT * 0.6),
    ("sqrt", POS), ("rsqrt", POS), ("rcp", POS),
    ("safe_sqrt", SYM), ("safe_rsqrt", SYM),
    ("safe_asin", UNIT), ("safe_acos", UNIT),
    ("abs_", SYM), ("sqr", SYM), ("sign", SYM),
    ("isnan", SYM), ("isinf", SYM), ("isfinite", SYM),
    ("floor", SYM * 3), ("ceil", SYM * 3), ("trunc", SYM * 3),
    ("round_", SYM * 3), ("round_half_away", SYM * 3),
    ("reverse", SYM),
]

BINARY = [
    ("math.atan2", SYM, POS), ("math.pow", POS, SYM),
    ("math.fmod", SYM, POS), ("math.hypot", SYM, POS),
    ("copysign", POS, SYM), ("mulsign", POS, SYM),
    ("special.carlson_rc", POS, POS + 0.3),
    ("special.ellint_1", SYM, UNIT * 0.5),
    ("special.ellint_2", SYM, UNIT * 0.5),
]

TERNARY = [
    ("fmadd", SYM, POS, SYM), ("fmsub", SYM, POS, SYM),
    ("fnmadd", SYM, POS, SYM), ("fnmsub", SYM, POS, SYM),
    ("fmaddsub", SYM, POS, SYM), ("fmsubadd", SYM, POS, SYM),
    ("clamp", SYM * 2, SYM * 0 - 1.0, SYM * 0 + 1.0),
    ("lerp", SYM, POS, UNIT * 0.5 + 0.5),
    ("special.carlson_rf", POS, POS + 0.2, POS + 0.4),
    ("special.carlson_rd", POS, POS + 0.2, POS + 0.4),
    ("special.ellint_3", SYM, UNIT * 0.5, UNIT * 0.3),
]

NATIVE_GATE = dict(rtol=3e-5, atol=2e-6, equal_nan=True)


def _check(name, *domains):
    jfn, pfn = fns(name)
    lazy = pfn(*[PL(d) for d in domains])
    assert isinstance(lazy, P.LazyArray), \
        f"{name} left the lazy backend: {type(lazy)}"
    assert lazy.device.type == "cpu"
    got = np.asarray(lazy.numpy(), np.float64)
    eager = np.asarray(pfn(*[PT(d) for d in domains]).numpy(), np.float64)
    ref = np.asarray(jfn(*[JL(d) for d in domains]).numpy(), np.float64)
    np.testing.assert_allclose(got, eager, err_msg=name, **NATIVE_GATE)
    np.testing.assert_allclose(got, ref, err_msg=name, **NATIVE_GATE)


@pytest.mark.parametrize("name,dom", UNARY, ids=[n for n, _ in UNARY])
def test_unary_unified(name, dom):
    _check(name, dom)


@pytest.mark.parametrize("name,d1,d2", BINARY, ids=[n for n, *_ in BINARY])
def test_binary_unified(name, d1, d2):
    _check(name, d1, d2)


@pytest.mark.parametrize("name,d1,d2,d3", TERNARY,
                         ids=[n for n, *_ in TERNARY])
def test_ternary_unified(name, d1, d2, d3):
    _check(name, d1, d2, d3)


def test_sincos_and_sincosh_unified():
    for name in ("math.sincos", "math.sincosh"):
        jfn, pfn = fns(name)
        ls, lc = pfn(PL(SYM))
        assert isinstance(ls, P.LazyArray) and isinstance(lc, P.LazyArray)
        es, ec = pfn(PT(SYM))
        js, jc = jfn(JL(SYM))
        for l, e, j in ((ls, es, js), (lc, ec, jc)):
            np.testing.assert_allclose(l.numpy(), e.numpy(), rtol=2e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(l.numpy(), j.numpy(), rtol=2e-5,
                                       atol=1e-6)


POLY_FNS = [
    ("sin", SYM * 100), ("cos", SYM * 100), ("tan", SYM * 30),
    ("asin", UNIT), ("acos", UNIT), ("atan", SYM * 30),
    ("exp", SYM * 30), ("exp2", SYM * 30), ("log", POS), ("log2", POS),
    ("cbrt", SYM * 1e4), ("sinh", SYM * 30), ("cosh", SYM * 30),
    ("tanh", SYM * 5), ("asinh", SYM * 1e3), ("acosh", GT1 * 100),
    ("atanh", UNIT), ("csc", POS), ("sec", SYM), ("cot", POS),
    ("csch", POS), ("sech", SYM), ("coth", POS),
]


def _poly(name, dom, dtype):
    """The port's lazy poly route of math.<name> on ``dom`` in ``dtype``:
    it stays on the trace, records the polynomial program (more ops than
    the native opcode), equals the port's eager poly route bit for bit
    and the reference's within rtol 1e-6."""
    jfn, pfn = fns("math." + name)
    d = dom.astype(dtype)
    P.reset()
    pfn(PL(d), "native")
    n_native = P.stats()["n_appends"]
    P.reset()
    out = pfn(PL(d), "poly")
    n_poly = P.stats()["n_appends"]
    assert isinstance(out, P.LazyArray), f"{name} left the trace"
    assert n_poly > n_native + 3, \
        f"{name}(impl='poly') recorded {n_poly} ops vs native {n_native}"
    got = out.numpy()
    eager = pfn(PT(d), "poly").numpy()
    np.testing.assert_array_equal(got, eager, err_msg=name)
    ref = np.asarray(jfn(jnp.asarray(d), "poly"), np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=1e-6,
                               atol=1e-30, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("name,dom", POLY_FNS, ids=[n for n, _ in POLY_FNS])
def test_lazy_impl_poly_honored(name, dom):
    _poly(name, dom, np.float32)


@pytest.mark.parametrize("name,dom", POLY_FNS, ids=[n for n, _ in POLY_FNS])
def test_lazy_impl_poly_honored_f64(name, dom):
    """The float64 leg: f64 literals and the f64 polynomial kernels on the
    trace; the reference under jax.enable_x64."""
    with jax.enable_x64():
        _poly(name, dom, np.float64)


def test_lazy_impl_poly_binary():
    for name, d1, d2 in [("atan2", SYM, POS), ("pow", POS, SYM)]:
        jfn, pfn = fns("math." + name)
        out = pfn(PL(d1), PL(d2), "poly")
        assert isinstance(out, P.LazyArray)
        np.testing.assert_array_equal(out.numpy(),
                                      pfn(PT(d1), PT(d2), "poly").numpy())
        ref = np.asarray(jfn(jnp.asarray(d1), jnp.asarray(d2), "poly"),
                         np.float64)
        np.testing.assert_allclose(np.asarray(out.numpy(), np.float64), ref,
                                   rtol=1e-6, atol=1e-30, equal_nan=True,
                                   err_msg=name)


def test_lazy_impl_poly_sincos_fuses_one_program():
    s, c = PO.math.sincos(PL(SYM * 100), "poly")
    before = P.stats()["n_evals"]
    P.eval(s, c)
    assert P.stats()["n_evals"] == before + 1
    np.testing.assert_allclose(s.numpy(), np.sin(SYM * 100), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.cos(SYM * 100), rtol=2e-5,
                               atol=1e-6)


def test_lazy_impl_poly_bf16_policy():
    """16-bit lazy inputs run the poly kernel in float32 and round back,
    as the eager route does, bit for bit."""
    xb = torch.from_numpy(SYM).to(torch.bfloat16)
    out = PO.math.sin(P.LazyArray(xb), "poly")
    assert isinstance(out, P.LazyArray)
    assert out.dtype == torch.bfloat16
    eager = PO.math.sin(xb, "poly")
    assert torch.equal(out.torch(), eager)
    np.testing.assert_allclose(out.numpy(), np.sin(SYM), atol=0.01)
    ref = JO.math.sin(J.LazyArray(jnp.asarray(SYM, jnp.bfloat16)), "poly")
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(ref.numpy(), np.float32))


def test_lazy_ldexp_frexp():
    x = np.array([0.0, 1.5, -3.25, 1e-20, 7.0], np.float32)
    e = np.array([0, 3, -2, 10, -1], np.int32)
    got = PO.ldexp(PL(x), PL(e))
    assert isinstance(got, P.LazyArray)
    np.testing.assert_array_equal(got.numpy(), np.ldexp(x, e))
    np.testing.assert_array_equal(got.numpy(),
                                  JO.ldexp(JL(x), JL(e)).numpy())
    m, ex = PO.frexp(PL(x))
    assert isinstance(m, P.LazyArray) and isinstance(ex, P.LazyArray)
    m_ref, e_ref = np.frexp(x)
    np.testing.assert_array_equal(m.numpy(), m_ref)
    np.testing.assert_array_equal(ex.numpy(), e_ref)

    # 2-byte floats upcast to float32, as the eager route does
    xb = torch.tensor([1.5, -3.25, 7.0], dtype=torch.bfloat16)
    got_b = PO.ldexp(P.LazyArray(xb), PL(e[:3]))
    want_b = PO.ldexp(xb, torch.from_numpy(e[:3]))
    assert torch.equal(got_b.torch(), want_b)
    mb, eb = PO.frexp(P.LazyArray(xb))
    mb_ref, eb_ref = PO.frexp(xb)
    assert torch.equal(mb.torch(), mb_ref) and torch.equal(eb.torch(), eb_ref)
    jm, je = JO.frexp(J.LazyArray(np.asarray(jnp.asarray(xb.float().numpy(),
                                                         jnp.bfloat16))))
    np.testing.assert_array_equal(mb.numpy(), jm.numpy())
    np.testing.assert_array_equal(eb.numpy(), je.numpy())


def test_reductions_unified():
    for name in ("hsum", "hprod", "hmax", "hmin", "hmean", "psum"):
        jfn, pfn = fns(name)
        e = np.asarray(pfn(PT(POS)).numpy(), np.float64)
        out = pfn(PL(POS))
        assert isinstance(out, P.LazyArray), name
        got = np.asarray(out.numpy(), np.float64).reshape(-1)
        np.testing.assert_allclose(got, np.atleast_1d(e), rtol=2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(got, jfn(JL(POS)).numpy().reshape(-1),
                                   rtol=2e-4, err_msg=name)
    m = POS > 1.0
    for name in ("all_", "any_", "none", "count"):
        jfn, pfn = fns(name)
        out = pfn(PL(m))
        assert isinstance(out, P.LazyArray), name
        np.testing.assert_array_equal(out.numpy().reshape(-1),
                                      np.atleast_1d(pfn(PT(m)).numpy()),
                                      err_msg=name)
        np.testing.assert_array_equal(out.numpy().reshape(-1),
                                      jfn(JL(m)).numpy().reshape(-1),
                                      err_msg=name)


def test_edge_semantics_match_across_backends():
    # gather: a negative index clamps on both backends
    src = np.array([10.0, 20.0, 30.0], np.float32)
    idx = np.array([-1, 5], np.int32)
    e = PO.gather(PT(src), PT(idx)).numpy()
    got = PO.gather(PL(src), PL(idx)).numpy()
    np.testing.assert_array_equal(e, got)
    np.testing.assert_array_equal(got, [10.0, 30.0])
    np.testing.assert_array_equal(got, JO.gather(JL(src), JL(idx)).numpy())

    # masked scatter_add: a negative in-mask index is dropped on both
    e = PO.scatter_add(torch.zeros(3), torch.tensor(5.0),
                       torch.tensor([-1], dtype=torch.int32),
                       mask=torch.tensor([True])).numpy()
    lt = PL(np.zeros(3, np.float32))
    lt.numpy()
    PO.scatter_add(lt, PL(np.array([5.0], np.float32)),
                   PL(np.array([-1], np.int32)), mask=PL(np.array([True])))
    np.testing.assert_array_equal(e, lt.numpy())
    np.testing.assert_array_equal(e, 0.0)

    # safe_sqrt: NaN propagates on both
    nan32 = np.array([np.nan, 4.0], np.float32)
    assert np.isnan(PO.safe_sqrt(PT(nan32)).numpy()[0])
    got = PO.safe_sqrt(PL(nan32)).numpy()
    assert np.isnan(got[0]) and got[1] == 2.0

    # mulsign on ints: -a where b < 0, the int dtype kept
    a = np.array([1, -2], np.int32)
    b = np.array([-1, 3], np.int32)
    e_ms = PO.mulsign(PT(a), PT(b)).numpy()
    l_ms = PO.mulsign(PL(a), PL(b))
    assert l_ms.dtype == torch.int32
    np.testing.assert_array_equal(e_ms, [-1, -2])
    np.testing.assert_array_equal(l_ms.numpy(), e_ms)

    # clamp: float bounds promote an int array on both backends
    xi = np.array([0, 1, 2], np.int32)
    e_c = PO.clamp(PT(xi), 0.5, 1.5).numpy()
    l_c = PO.clamp(PL(xi), 0.5, 1.5).numpy()
    np.testing.assert_allclose(e_c, [0.5, 1.0, 1.5])
    np.testing.assert_allclose(l_c, e_c)

    # ns_of().sign agrees at zero between namespaces (sign(0)=1,
    # sign(-0.0)=-1)
    from enoki_tpu_torch.ops.backend import ns_of
    z = np.array([0.0, -0.0, 2.0, -3.0], np.float32)
    e_s = ns_of(PT(z)).sign(PT(z)).numpy()
    l_s = ns_of(PL(z)).sign(PL(z)).numpy()
    np.testing.assert_array_equal(e_s, [1.0, -1.0, 1.0, -1.0])
    np.testing.assert_array_equal(l_s, e_s)


def test_poly_special_values():
    # log(NaN) is NaN in poly mode (frexp strips the NaN exponent)
    v = PO.math.log(PL(np.array([np.nan], np.float32)), "poly").numpy()
    assert np.isnan(v[0])
    # atan2 zeros on the trace: (+-0, +0) = +-0, (+-0, -0.0) = +-pi
    for yv, xv, want in ((0.0, 0.0, 0.0), (-0.0, 0.0, -0.0),
                         (0.0, -0.0, np.pi), (-0.0, -0.0, -np.pi)):
        got = PO.math.atan2(PL(np.float32([yv])), PL(np.float32([xv])),
                            "poly").numpy()[0]
        assert got == pytest.approx(want, abs=1e-6), (yv, xv, got)
        assert np.signbit(got) == np.signbit(want)
    # erfinv(+-1) = +-inf on the f32 poly route, lazy as eager
    ones = np.array([1.0, -1.0], np.float32)
    lv = PO.special.erfinv(PL(ones), "poly").numpy()
    ev = PO.special.erfinv(PT(ones), "poly").numpy()
    np.testing.assert_array_equal(lv, [np.inf, -np.inf])
    np.testing.assert_array_equal(lv, ev)


def test_hmean_empty_lazy_matches_eager():
    e = PO.hmean(torch.zeros(0)).numpy()
    got = PO.hmean(PL(np.zeros(0, np.float32))).numpy()
    assert np.isnan(e) and np.isnan(got).all()
