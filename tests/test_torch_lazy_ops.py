"""The port's ops surface over ``trace.LazyArray`` (twin of
tests/test_lazy_ops.py) on the CPU.

Each test runs the reference test's program through ``enoki_tpu`` and
through ``enoki_tpu_torch`` on the same numpy inputs: the port's lazy
call must stay lazy (recording trace ops, no eval) and agree with the
port's eager result, with the reference's lazy result and with the
expected values, under the reference test's gates. Every LazyArray is
made with ``device="cpu"``, where the trace runs its plain interpreter;
the card runs the same programs as fused kernels (chip_smoke.py phase
30). The float64 cases (the reference's x64 leg) run the reference under
``jax.enable_x64`` in this process.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu import ops as JO
from enoki_tpu.ops import math as JM, special as JS
from enoki_tpu_torch import ops
from enoki_tpu_torch.ops import math as M, special as S


@pytest.fixture(autouse=True)
def _fresh():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()
    torch.set_num_threads(n)


def L(a):
    return P.LazyArray(np.asarray(a), device="cpu")


def JL(a):
    return J.LazyArray(np.asarray(a))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _agree(lazy_out, eager_out, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(
        np.asarray(lazy_out.numpy(), np.float64),
        np.asarray(eager_out.numpy() if hasattr(eager_out, "numpy")
                   else eager_out, np.float64), rtol=rtol, atol=atol)


# -- special.cpp over LazyArray -----------------------------------------------

X_ERF = np.linspace(-4.0, 4.0, 257).astype(np.float32)
X_POS = np.linspace(0.05, 8.0, 161).astype(np.float32)


@pytest.mark.parametrize("name,ref,x", [
    ("erf", sp.erf, X_ERF),
    ("erfc", sp.erfc, X_ERF),
    ("dawson", sp.dawsn, X_ERF),
    ("erfi", sp.erfi, np.linspace(-2, 2, 101).astype(np.float32)),
    ("i0e", sp.i0e, np.linspace(-20, 20, 161).astype(np.float32)),
    ("lgamma", sp.gammaln, X_POS),
    ("tgamma", sp.gamma, np.linspace(0.1, 8, 101).astype(np.float32)),
])
def test_lazy_special_matches_eager_and_scipy(name, ref, x):
    fn, jfn = getattr(S, name), getattr(JS, name)
    lazy = fn(L(x), "poly")
    assert isinstance(lazy, P.LazyArray), f"{name} left the lazy backend"
    # the lazy namespace's exp / log / sin are the trace's opcodes (the
    # reference's per-backend transcendental split): tgamma = exp(lgamma)
    # amplifies their ulp by |lgamma|
    rtol = 3e-6 if name == "tgamma" else 1e-6
    _agree(lazy, fn(T(x), "poly"), rtol=rtol)
    _agree(lazy, jfn(JL(x), "poly"), rtol=rtol)
    want = ref(x.astype(np.float64))
    got = lazy.numpy().astype(np.float64)
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=3e-5, atol=1e-6)


def test_lazy_special_native_impl_routes_to_opcodes():
    x = L(X_ERF)
    for fn, ref in [(S.erf, sp.erf), (S.erfc, sp.erfc)]:
        out = fn(x)
        assert isinstance(out, P.LazyArray)
        np.testing.assert_allclose(out.numpy().astype(np.float64),
                                   ref(X_ERF.astype(np.float64)),
                                   rtol=1e-5, atol=1e-6)
    # one opcode each: the native route records no polynomial
    P.reset()
    S.lgamma(L(X_POS))
    assert P.stats()["n_appends"] <= 2


def test_lazy_erfinv_matches_eager():
    x = np.linspace(-0.999, 0.999, 201).astype(np.float32)
    lazy = S.erfinv(L(x))
    assert isinstance(lazy, P.LazyArray)
    _agree(lazy, S.erfinv(T(x), "poly"))
    _agree(lazy, JS.erfinv(JL(x)))


def test_lazy_erfinv_f64_newton_polish():
    x = np.linspace(-0.99999, 0.99999, 257).astype(np.float64)
    lazy = S.erfinv(L(x), "poly")
    assert isinstance(lazy, P.LazyArray) and lazy.dtype == torch.float64
    got = lazy.numpy()
    want = sp.erfinv(x)
    spacing = np.spacing(np.abs(want))
    lazy_ulp = np.max(np.abs(got - want) / spacing)
    eager = S.erfinv(T(x), "poly").numpy()
    eager_ulp = np.max(np.abs(eager - want) / spacing)
    assert lazy_ulp <= max(eager_ulp, 4.0) + 0.5
    with jax.enable_x64():
        ref = JS.erfinv(JL(x), "poly").numpy()
    ref_ulp = np.max(np.abs(ref - want) / spacing)
    assert lazy_ulp <= max(ref_ulp, 4.0) + 0.5


def _carlson_pairs(mk, y):
    return [
        S.carlson_rf(mk(y), mk(2 * y), mk(3 * y)),
        S.carlson_rd(mk(y), mk(2 * y), mk(3 * y)),
        S.carlson_rc(mk(y), mk(2 * y)),
        S.carlson_rj(mk(y), mk(2 * y), mk(3 * y), 0.7),
        S.comp_ellint_1(mk(y * 0.45)),
        S.ellint_2(mk(y), 0.5),
        S.ellint_3(mk(y), 0.5, 0.3),
    ]


def test_lazy_carlson_and_ellint():
    y = np.linspace(0.1, 2.0, 63).astype(np.float32)
    lazy = _carlson_pairs(L, y)
    eager = _carlson_pairs(T, y)
    ref = [JS.carlson_rf(JL(y), JL(2 * y), JL(3 * y)),
           JS.carlson_rd(JL(y), JL(2 * y), JL(3 * y)),
           JS.carlson_rc(JL(y), JL(2 * y)),
           JS.carlson_rj(JL(y), JL(2 * y), JL(3 * y), 0.7),
           JS.comp_ellint_1(JL(y * 0.45)),
           JS.ellint_2(JL(y), 0.5),
           JS.ellint_3(JL(y), 0.5, 0.3)]
    for lz, e, j in zip(lazy, eager, ref):
        assert isinstance(lz, P.LazyArray)
        _agree(lz, e, rtol=1e-5, atol=1e-6)
        _agree(lz, j, rtol=1e-5, atol=1e-6)


def test_lazy_special_is_one_fused_program():
    x = L(np.linspace(0.1, 0.9, 64).astype(np.float32))
    y = S.dawson(S.erf(x * 0.5, "poly") + 0.1) * S.i0e(x, "poly")
    n0 = P.stats()["n_evals"]
    y.eval()
    assert P.stats()["n_evals"] == n0 + 1


# -- the math surface over LazyArray ------------------------------------------

def test_lazy_math_routes():
    x = np.linspace(0.1, 1.4, 77).astype(np.float32)
    lx = L(x)
    x64 = x.astype(np.float64)
    for fn, ref in [(M.sin, np.sin), (M.cos, np.cos), (M.tan, np.tan)]:
        out = fn(lx)
        assert isinstance(out, P.LazyArray)
        np.testing.assert_allclose(out.numpy(), ref(x64), rtol=1e-5,
                                   atol=1e-6)
    out = M.asin(L(x * 0.6))
    assert isinstance(out, P.LazyArray)
    np.testing.assert_allclose(out.numpy(), np.arcsin(x * 0.6), rtol=1e-5)
    for fn, ref in [(M.exp, np.exp), (M.log, np.log), (M.tanh, np.tanh),
                    (M.sinh, np.sinh), (M.cosh, np.cosh),
                    (M.cbrt, np.cbrt), (M.atan, np.arctan),
                    (M.log1p, np.log1p), (M.expm1, np.expm1),
                    (M.asinh, np.arcsinh),
                    (M.cot, lambda v: 1 / np.tan(v)),
                    (M.csch, lambda v: 1 / np.sinh(v)),
                    (M.sech, lambda v: 1 / np.cosh(v)),
                    (M.coth, lambda v: 1 / np.tanh(v))]:
        out = fn(lx)
        assert isinstance(out, P.LazyArray), fn.__name__
        np.testing.assert_allclose(out.numpy(), ref(x64), rtol=2e-5,
                                   atol=1e-6, err_msg=fn.__name__)
        np.testing.assert_allclose(out.numpy(), fn(T(x)).numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=fn.__name__)
    s, c = M.sincos(lx)
    np.testing.assert_allclose((s * s + c * c).numpy(), np.ones_like(x),
                               rtol=1e-5)
    out = M.atan2(lx, 2.0)
    assert isinstance(out, P.LazyArray)
    np.testing.assert_allclose(out.numpy(), np.arctan2(x, 2.0), rtol=1e-5)
    np.testing.assert_allclose(M.hypot(lx, 0.5).numpy(), np.hypot(x, 0.5),
                               rtol=1e-5)
    np.testing.assert_allclose(M.pow(lx, 2.5).numpy(), x64 ** 2.5,
                               rtol=1e-5)
    out = M.fmod(lx, 0.3)
    np.testing.assert_allclose(out.numpy(), np.fmod(x, np.float32(0.3)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out.numpy(), M.fmod(T(x), 0.3).numpy())


# -- the router surface over LazyArray ----------------------------------------

def test_lazy_router_select_gather_scatter():
    x = L(np.array([1., 2., 3., 4.], np.float32))
    m = x > 2.0
    out = ops.select(m, x * 10.0, -1.0)
    assert isinstance(out, P.LazyArray)
    np.testing.assert_allclose(out.numpy(), [-1, -1, 30, 40])

    idx = L(np.array([3, 0, 1], np.int32))
    np.testing.assert_allclose(ops.gather(x, idx).numpy(), [4, 1, 2])
    gm = ops.gather(x, idx, mask=L(np.array([True, False, True])), fill=9.0)
    np.testing.assert_allclose(gm.numpy(), [4, 9, 2])

    tgt = L(np.zeros(4, np.float32))
    ops.scatter(tgt, L(np.array([5., 6.], np.float32)),
                L(np.array([1, 3], np.int32)))
    np.testing.assert_allclose(tgt.numpy(), [0, 5, 0, 6])

    tgt2 = L(np.zeros(3, np.float32))
    ops.scatter_add(tgt2, 1.0, L(np.array([0, 1, 1, 2, 2], np.int32)))
    np.testing.assert_allclose(tgt2.numpy(), [1, 2, 2])

    tgt3 = L(np.zeros(4, np.float32))
    ops.scatter(tgt3, L(np.array([5., 6.], np.float32)),
                L(np.array([1, 3], np.int32)),
                mask=L(np.array([True, False])))
    np.testing.assert_allclose(tgt3.numpy(), [0, 5, 0, 0])


def test_lazy_router_misc():
    v = np.array([-2.0, -0.5, 0.5, 2.0], np.float32)
    x = L(v)
    np.testing.assert_allclose(ops.clamp(x, -1.0, 1.0).numpy(),
                               [-1, -0.5, 0.5, 1])
    np.testing.assert_allclose(ops.lerp(x, x * 0.0 + 10.0, 0.5).numpy(),
                               [4, 4.75, 5.25, 6])
    np.testing.assert_allclose(ops.sign(x).numpy(), [-1, -1, 1, 1])
    np.testing.assert_allclose(ops.copysign(x * 0.0 + 3.0, x).numpy(),
                               [-3, -3, 3, 3])
    np.testing.assert_allclose(ops.mulsign(x * 0.0 + 3.0, x).numpy(),
                               [-3, -3, 3, 3])
    np.testing.assert_allclose(ops.fmadd(x, 2.0, 1.0).numpy(), [-3, 0, 2, 5])
    np.testing.assert_allclose(ops.abs_(x).numpy(), [2, .5, .5, 2])
    assert ops.isnan(x).numpy().sum() == 0
    assert ops.allclose(x, x)
    assert ops.allclose(x, T(v))
    np.testing.assert_allclose(ops.sqrt(abs(x)).numpy(),
                               np.sqrt([2, .5, .5, 2]), rtol=1e-6)
    np.testing.assert_allclose(ops.rsqrt(abs(x)).numpy(),
                               1 / np.sqrt([2, .5, .5, 2]), rtol=1e-6)
    b = ops.reinterpret(x, torch.uint32)
    assert isinstance(b, P.LazyArray)
    np.testing.assert_array_equal(b.numpy(), v.view(np.uint32))
    u = L(np.array([0, 1, 7, 255], np.uint32))
    np.testing.assert_array_equal(ops.popcnt(u).numpy(), [0, 1, 3, 8])
    # the rest of the bit surface, lazy against eager
    w = np.array([1, 8, 96, 0x40000000], np.int32)
    for fn in (ops.popcnt, ops.lzcnt, ops.tzcnt, ops.log2i):
        np.testing.assert_array_equal(fn(L(w)).numpy(), fn(T(w)).numpy(),
                                      err_msg=fn.__name__)


def test_lazy_safe_math_values_and_grads():
    x = L(np.array([-1.0, 0.0, 4.0], np.float32))
    np.testing.assert_allclose(ops.safe_sqrt(x).numpy(), [0, 0, 2])
    np.testing.assert_allclose(ops.safe_rsqrt(x).numpy()[2], 0.5)
    a = L(np.array([-1.0, 0.0, 0.5, 1.0], np.float32))
    np.testing.assert_allclose(ops.safe_asin(a).numpy(),
                               np.arcsin([-1, 0, 0.5, 1]), rtol=1e-6)
    np.testing.assert_allclose(ops.safe_acos(a).numpy(),
                               np.arccos([-1, 0, 0.5, 1]), rtol=1e-6,
                               atol=1e-6)
    # gradient discipline: d safe_sqrt at the boundary is 0, not NaN
    xs = P.requires_grad(L(np.array([0.0, 4.0], np.float32)))
    P.backward(ops.safe_sqrt(xs).hsum())
    np.testing.assert_allclose(P.gradient(xs).numpy(), [0.0, 0.25])
    xa = P.requires_grad(L(np.array([1.0, 0.5], np.float32)))
    P.backward(ops.safe_asin(xa).hsum())
    ga = P.gradient(xa).numpy()
    assert np.isfinite(ga).all() and ga[0] == 0.0
    np.testing.assert_allclose(ga[1], 1 / np.sqrt(1 - 0.25), rtol=1e-5)
    jx = J.requires_grad(JL(np.array([1.0, 0.5], np.float32)))
    J.backward(JO.safe_asin(jx).hsum())
    np.testing.assert_allclose(ga, J.gradient(jx).numpy(), rtol=1e-6)


def test_lazy_safe_math_f64_tape_segment():
    """The float64 tape: the gradient of a lazy float64 program through
    safe math and the special functions, against the reference's tape
    under jax.enable_x64."""
    v = np.array([0.0, 0.25, 0.5, 2.0], np.float64)

    def prog(tr, ops_, S_, mk):
        x = tr.requires_grad(mk(v))
        y = ops_.safe_sqrt(x) * S_.erf(x, "poly") + ops_.safe_asin(x * 0.4)
        tr.backward(y.hsum())
        return tr.gradient(x).numpy()

    got = prog(P, ops, S, L)
    with jax.enable_x64():
        want = prog(J, JO, JS, JL)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_lazy_horiz_routes():
    x = L(np.array([1., 2., 3., 4.], np.float32))
    assert float(ops.hsum(x).numpy()[0]) == 10.0
    assert float(ops.hprod(x).numpy()[0]) == 24.0
    assert float(ops.hmax(x).numpy()[0]) == 4.0
    assert float(ops.hmin(x).numpy()[0]) == 1.0
    assert float(ops.hmean(x).numpy()[0]) == 2.5
    np.testing.assert_allclose(ops.psum(x).numpy(), [1, 3, 6, 10])
    m = x > 2.0
    assert bool(ops.any_(m).numpy()[0])
    assert not bool(ops.all_(m).numpy()[0])
    assert int(ops.count(m).numpy()[0]) == 2
    assert float(ops.dot(x, x).numpy()[0]) == 30.0
    np.testing.assert_allclose(ops.normalize(x).numpy(),
                               np.arange(1, 5) / np.sqrt(30), rtol=1e-6)
    packed, cnt = ops.compress(x, m)
    np.testing.assert_allclose(packed.numpy(), [3, 4, 0, 0])
    assert int(cnt.numpy()[0]) == 2
    np.testing.assert_allclose(ops.reverse(x).numpy(), [4, 3, 2, 1])
    np.testing.assert_allclose(ops.horiz.reverse(x).numpy(), [4, 3, 2, 1])
    np.testing.assert_allclose(ops.norm(x).numpy(), [np.sqrt(30)],
                               rtol=1e-6)


def test_lazy_meshgrid_and_binary_search():
    x = L(np.array([0., 1., 2.], np.float32))
    y = L(np.array([10., 20.], np.float32))
    xs, ys = ops.meshgrid(x, y)
    np.testing.assert_allclose(xs.numpy(), [0, 1, 2, 0, 1, 2])
    np.testing.assert_allclose(ys.numpy(), [10, 10, 10, 20, 20, 20])

    table = L(np.array([1., 3., 5., 7., 9.], np.float32))
    needle = L(np.array([0.5, 4.0, 9.5], np.float32))

    def pred(mid):
        return table.gather(mid) < needle

    out = ops.binary_search(0, 5, pred, device="cpu")
    assert isinstance(out, P.LazyArray)
    np.testing.assert_array_equal(out.numpy(), [0, 2, 5])
    jt = JL(np.array([1., 3., 5., 7., 9.], np.float32))
    jn = JL(np.array([0.5, 4.0, 9.5], np.float32))
    ref = JO.binary_search(0, 5, lambda mid: jt.gather(mid) < jn)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


# -- one user source, every backend -------------------------------------------

def _user_program(ops_, S_, M_, x):
    """Written once against the ops surface: no backend names."""
    r = ops_.sqrt(ops_.clamp(x * x + 0.25, 0.0, 10.0))
    w = ops_.erf(r) + S_.dawson(r * 0.5) - ops_.lerp(x, r, 0.25)
    w = ops_.select(w > 0.0, w, -w)
    theta = ops_.safe_asin(ops_.clamp(x, -1.0, 1.0))
    return ops_.hsum(w * M_.cos(theta) + S_.i0e(x, "poly"))


def test_one_source_every_backend():
    x = np.linspace(-1.5, 1.5, 101).astype(np.float32)
    eager = float(_user_program(ops, S, M, T(x)))
    lazy_out = _user_program(ops, S, M, L(x))
    assert isinstance(lazy_out, P.LazyArray)
    lazy = float(lazy_out.numpy()[0])
    ref = float(_user_program(JO, JS, JM, JL(x)).numpy()[0])
    assert abs(eager - lazy) <= 2e-4 * max(1.0, abs(eager))
    assert abs(ref - lazy) <= 2e-4 * max(1.0, abs(ref))


def test_extract_first_active_lane():
    v = np.array([5., 6., 7., 8.], np.float32)
    m = np.array([False, False, True, True])
    assert float(ops.extract(T(v), T(m))[0]) == 7.0
    out = ops.extract(L(v), L(m))
    assert isinstance(out, P.LazyArray)
    assert float(out.numpy()[0]) == 7.0


def test_lazy_rounding_routes():
    from enoki_tpu_torch.ops import rounding as R

    v = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, np.inf], np.float32)
    lx = L(v)
    np.testing.assert_array_equal(R.round_(lx).numpy(), np.round(v))
    np.testing.assert_array_equal(R.floor(lx).numpy(), np.floor(v))
    np.testing.assert_array_equal(R.ceil(lx).numpy(), np.ceil(v))
    np.testing.assert_array_equal(R.trunc(lx).numpy(), np.trunc(v))
    want = np.array([-2.0, -1.0, 1.0, 2.0, 3.0, np.inf], np.float32)
    np.testing.assert_array_equal(R.round_half_away(lx).numpy(), want)
    np.testing.assert_array_equal(R.round_half_away(T(v)).numpy(), want)


def test_lazy_safe_math_f64_tiny():
    # the lazy clamps take the input dtype's tiny, not float32's
    x = L(np.array([1e-300, 4.0], np.float64))
    np.testing.assert_allclose(ops.safe_rsqrt(x).numpy(), [1e150, 0.5],
                               rtol=1e-12)
    np.testing.assert_allclose(ops.safe_sqrt(x).numpy(), [1e-150, 2.0],
                               rtol=1e-12)
    with jax.enable_x64():
        jx = JL(np.array([1e-300, 4.0], np.float64))
        np.testing.assert_array_equal(ops.safe_rsqrt(x).numpy(),
                                      JO.safe_rsqrt(jx).numpy())


def test_lazy_fmaddsub_mixed_width():
    # a wider eager operand sets the lane count
    out = ops.fmaddsub(L(np.array([2.0], np.float32)),
                       torch.arange(4.0, dtype=torch.float32), 1.0)
    want = ops.fmaddsub(torch.tensor(2.0), torch.arange(4.0), 1.0)
    np.testing.assert_allclose(out.numpy(), want.numpy())
    ref = JO.fmaddsub(JL(np.array([2.0], np.float32)),
                      jnp.arange(4.0, dtype=jnp.float32), 1.0)
    np.testing.assert_allclose(out.numpy(), ref.numpy())


def test_compress_mixed_backends():
    x = L(np.array([1., 2., 3., 4.], np.float32))
    m = torch.tensor([True, False, True, False])
    packed, cnt = ops.compress(x, m)
    np.testing.assert_allclose(packed.numpy(), [1, 3, 0, 0])
    assert int(cnt.numpy()[0]) == 2
    packed2, _ = ops.compress(torch.tensor([1., 2., 3., 4.]),
                              L(np.array([True, False, True, False])))
    np.testing.assert_allclose(packed2.numpy(), [1, 3, 0, 0])
    with pytest.raises(ValueError, match="zero-fills"):
        ops.compress(x, m, fill=1)


def test_extract_no_active_lane_matches_eager():
    v = np.array([5., 6., 7.], np.float32)
    m = np.zeros(3, bool)
    assert float(ops.extract(T(v), T(m))[0]) == 5.0
    assert float(ops.extract(L(v), L(m)).numpy()[0]) == 5.0


def test_binary_search_single_pred_call_per_iteration():
    calls = []
    table = torch.tensor([1., 3., 5., 7., 9.])

    def pred(mid):
        calls.append(1)
        return table[mid.long()] < 4.0

    out = ops.binary_search(0, 5, pred, device="cpu")
    assert len(calls) == math.floor(math.log2(5)) + 1
    assert int(out) == 2


def test_range_packets_empty():
    assert list(ops.range_packets(0, 8, device="cpu")) == []
    assert list(ops.range_packets((0, 3), 4, dim=2, device="cpu")) == []


def test_nested_reduction_aliases_lazy():
    m = L(np.array([True, False, True]))
    assert bool(ops.any_nested(m).numpy()[0])
    assert not bool(ops.all_nested(m).numpy()[0])
    assert not bool(ops.none_nested(m).numpy()[0])
    assert int(ops.count_nested(m).numpy()[0]) == 2
    x = L(np.array([1., 2., 3.], np.float32))
    assert float(ops.hsum_nested(x).numpy()[0]) == 6.0
    assert float(ops.hmax_nested(x).numpy()[0]) == 3.0


def test_masked_min_mixed_backends():
    from enoki_tpu_torch.struct import masked

    v = torch.tensor([1., 2., 3., 4.])
    m = torch.tensor([False, False, True, True])
    out = masked(v, m).min(L(np.array([3.5], np.float32)))
    assert isinstance(out, P.LazyArray)
    np.testing.assert_allclose(out.numpy(), [1, 2, 3, 3.5])


def test_binary_search_probe_side_effect_guard():
    # a pred that records a lazy side effect and then refuses the tensor
    # probe index must raise: a retry would record the side effect twice
    acc = L(np.zeros(8, np.float32))
    table = L(np.array([1., 3., 5., 7., 9.], np.float32))

    def bad_pred(mid):
        acc.scatter_add(L(np.zeros(1, np.int32)), L(np.ones(1, np.float32)))
        if not isinstance(mid, P.LazyArray):
            raise TypeError("a LazyArray index, please")
        return table.gather(mid) < 4.0

    with pytest.raises(RuntimeError, match="side"):
        ops.binary_search(0, 5, bad_pred, device="cpu")

    # without the side effect the refused probe is retried lazily
    def lazy_only(mid):
        if not isinstance(mid, P.LazyArray):
            raise TypeError("a LazyArray index, please")
        return table.gather(mid) < 4.0

    out = ops.binary_search(0, 5, lazy_only, device="cpu")
    np.testing.assert_array_equal(out.numpy(), [2])


def test_nan_literal_not_cached():
    x = L(np.ones(4, np.float32))
    n0 = len(P._LITERAL_ARRAYS)
    for _ in range(10):
        _ = x + float("nan")
    assert len(P._LITERAL_ARRAYS) == n0


def test_csc_sec_isdenormal():
    x = np.linspace(0.3, 1.2, 33).astype(np.float32)
    lc = M.csc(L(x))
    assert isinstance(lc, P.LazyArray)
    np.testing.assert_allclose(lc.numpy(), 1 / np.sin(x), rtol=1e-5)
    np.testing.assert_allclose(M.sec(L(x)).numpy(), 1 / np.cos(x),
                               rtol=1e-5)
    v = np.array([0.0, 1.0, 1e-39, 2e-38], np.float32)  # 1e-39 subnormal
    ld = ops.isdenormal(L(v))
    assert isinstance(ld, P.LazyArray)
    # the trace keeps subnormals, as the port's eager route does
    np.testing.assert_array_equal(ld.numpy(), ops.isdenormal(T(v)).numpy())
    np.testing.assert_array_equal(ld.numpy(), [False, False, True, False])


def test_lifted_leaves_take_the_operand_device():
    """The device rule: numpy data lifted beside a CPU LazyArray lands on
    the CPU (never on the card by default); a tensor keeps its own device,
    and one on another device raises."""
    x = L(np.array([1., 2., 3.], np.float32))
    g = ops.gather(x, np.array([2, 0], np.int32))
    assert g.device.type == "cpu"
    np.testing.assert_array_equal(g.numpy(), [3, 1])
    xs, ys = ops.meshgrid(x, np.array([5., 6.], np.float32))
    assert xs.device.type == "cpu" and ys.device.type == "cpu"
    np.testing.assert_array_equal(ys.numpy(), [5, 5, 5, 6, 6, 6])
    s = ops.select(np.array([True, False, True]), x, 0.0)
    assert s.device.type == "cpu"
    with pytest.raises(ValueError, match="two devices"):
        ops.select(x > 1.0, x, torch.ones(3, device="meta"))
