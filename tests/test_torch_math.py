"""ops/math.py of the port against the reference's on the same seeded
numpy inputs, and against numpy float64 under the reference's own gates.

Tolerances:
  * ``impl="poly"`` meets every bound of tests/test_math_accuracy.py (the
    same ranges, ``n``, seeds and ulp bounds, through conftest's
    ``check_accuracy``) and its explicit cases (atan2's quadrant edges and
    absolute error < 1e-5, pow's relative error < 1e-5, the edges of exp,
    log, hypot and fmod);
  * ``impl="poly"`` is within 2 ulp of the reference's poly in float32 and
    float64, results below the smallest normal compared as zeros (XLA's
    CPU backend flushes float32 subnormals; PyTorch keeps them);
  * ``impl="native"`` (PyTorch's own functions; ``cbrt`` the float64
    power rounded once) meets the same bounds against numpy float64;
  * 16-bit inputs of the wrapped functions give the float32 result rounded
    once, equal to the reference's; integer inputs are taken as float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import check_accuracy
from enoki_tpu.ops import math as JM
from enoki_tpu_torch import ops as TO
from enoki_tpu_torch.ops import math as TM

POLY = "poly"


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test in one CPU thread. PyTorch's CPU build (MKL's vector math)
    may compute the first transcendental call after its thread pool is
    built at a lower accuracy in one worker thread's chunk (float32-like
    in float64: atan 1.6e7 ulp; sin float32 2.5e3 ulp; ROADMAP §C), a
    fault of PyTorch's CPU path and not of the port; the gates hold the
    functions, computed in the calling thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# tests/test_math_accuracy.py's check_accuracy cases:
# (name, numpy truth, lo, hi, max ulp, mean ulp, log space)
F32_CASES = {
    "sin": (np.sin, -8192.0, 8192.0, 5, 0.45, False),
    "cos": (np.cos, -8192.0, 8192.0, 5, 0.45, False),
    "tan": (np.tan, -8192.0, 8192.0, 7, 0.6, False),
    "asin": (np.arcsin, -1.0, 1.0, 4.0, 0.5, False),
    "acos": (np.arccos, -1.0, 1.0, 4.0, 0.5, False),
    "atan": (np.arctan, -1.0, 1.0, 12, 5.0, False),
    "atan wide": (np.arctan, -1000.0, 1000.0, 12, 5.0, False),
    "exp": (np.exp, -20.0, 30.0, 1.0, 0.3, False),
    "log": (np.log, 1e-20, 2e30, 1.0, 0.02, True),
    "exp2": (np.exp2, -20.0, 30.0, 2.0, 0.5, False),
    "log2": (np.log2, 1e-20, 2e30, 2.5, 0.5, True),
    "sinh": (np.sinh, -10.0, 10.0, 3.0, 0.6, False),
    "cosh": (np.cosh, -10.0, 10.0, 4.0, 0.6, False),
    "tanh": (np.tanh, -10.0, 10.0, 7.0, 0.6, False),
    "asinh": (np.arcsinh, -30.0, 30.0, 6.0, 1.0, False),
    "acosh": (np.arccosh, 1.0, 1000.0, 6.0, 1.0, False),
    "atanh": (np.arctanh, -0.999, 0.999, 6.0, 1.0, False),
    "cbrt": (np.cbrt, -100.0, 100.0, 4.0, 1.0, False),
}
F64_CASES = {
    "exp": (np.exp, -700.0, 700.0, 2.0, 0.5, False),
    "log": (np.log, 1e-300, 1e300, 2.0, 0.5, True),
    "sin": (np.sin, -8192.0, 8192.0, 2.0, 0.5, False),
    "cos": (np.cos, -8192.0, 8192.0, 2.0, 0.5, False),
    "asin": (np.arcsin, -1.0, 1.0, 3.0, 0.5, False),
    "acos": (np.arccos, -1.0, 1.0, 3.0, 0.5, False),
    "atan": (np.arctan, -1000.0, 1000.0, 2.0, 0.5, False),
    "tan": (np.tan, -8192.0, 8192.0, 3.0, 0.6, False),
    "sinh": (np.sinh, -700.0, 700.0, 3.0, 0.5, False),
    "cosh": (np.cosh, -700.0, 700.0, 3.0, 0.5, False),
    "tanh": (np.tanh, -20.0, 20.0, 3.0, 0.5, False),
    "asinh": (np.arcsinh, -30.0, 30.0, 3.0, 0.5, False),
    "acosh": (np.arccosh, 1.0, 1000.0, 2.0, 0.5, False),
    "atanh": (np.arctanh, -0.999, 0.999, 2.0, 0.5, False),
}
CASES = ([("f32", k, np.float32) + v for k, v in F32_CASES.items()]
         + [("f64", k, np.float64) + v for k, v in F64_CASES.items()])


def _port(name, impl):
    fn = getattr(TM, name.split()[0])
    return lambda x: fn(torch.from_numpy(np.ascontiguousarray(x)),
                        impl).numpy()


@pytest.mark.parametrize("impl", [POLY, "native"])
@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_accuracy_meets_the_reference_bounds(case, impl):
    _, name, dtype, ref, lo, hi, max_ulp, mean_ulp, log_space = case
    check_accuracy(_port(name, impl), ref, lo, hi, max_ulp=max_ulp,
                   mean_ulp=mean_ulp, dtype=dtype, log_space=log_space)


def _ulps(got, want):
    """|got - want| in units of want's spacing, results below the smallest
    normal taken as zeros (0 where both are equal, infinities and NaN
    included)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want)
    tiny = np.finfo(want.dtype).tiny
    w = want.astype(np.float64)
    got = np.where(np.abs(got) < tiny, 0.0, got)
    w = np.where(np.abs(w) < tiny, 0.0, w)
    same = (got == w) | (np.isnan(got) & np.isnan(w))
    with np.errstate(invalid="ignore", over="ignore"):
        u = np.abs(got - w) / np.spacing(np.abs(w.astype(want.dtype))
                                         ).astype(np.float64)
    return np.where(same, 0.0, u)


# every function of ops/math.py with an input range (its test's where the
# reference has one); 1-operand functions
RANGES = {
    "sin": (-8192, 8192), "cos": (-8192, 8192), "tan": (-8192, 8192),
    "cot": (-100, 100), "asin": (-1, 1), "acos": (-1, 1),
    "atan": (-1000, 1000), "exp": (-20, 30), "exp2": (-20, 30),
    "log": (1e-20, 2e30), "log2": (1e-20, 2e30), "cbrt": (-100, 100),
    "sinh": (-10, 10), "cosh": (-10, 10), "tanh": (-10, 10),
    "csc": (-100, 100), "sec": (-100, 100), "csch": (-10, 10),
    "sech": (-10, 10), "coth": (-10, 10), "asinh": (-30, 30),
    "acosh": (1, 1000), "atanh": (-0.999, 0.999),
    "sincos": (-100, 100), "sincosh": (-10, 10),
}


def _inputs(name, dtype, n=20000, seed=0):
    lo, hi = RANGES[name]
    rng = np.random.default_rng(seed)
    if lo > 0 and hi / lo > 1e6:
        x = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    else:
        x = rng.uniform(lo, hi, n)
    x = x.astype(dtype)
    # the special values of the line, on every function
    x[:9] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5, -0.5]
    return x


def _pair(out):
    return out if isinstance(out, tuple) else (out,)


def _same(a, b):
    """Equal tensors, NaN equal to NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(RANGES))
def test_poly_within_2_ulp_of_the_reference(name, dtype):
    x = _inputs(name, dtype)
    got = _pair(getattr(TM, name)(torch.from_numpy(x), POLY))
    with jax.enable_x64(dtype == np.float64):
        want = _pair(getattr(JM, name)(jnp.asarray(x), POLY))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == dtype and w.dtype == dtype
        assert _ulps(g, w).max() <= 2.0, name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_two_operand_poly_within_2_ulp_of_the_reference(dtype):
    rng = np.random.default_rng(1)
    y = rng.uniform(-10, 10, 20000).astype(dtype)
    x = rng.uniform(-10, 10, 20000).astype(dtype)
    edges = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan], dtype)
    y[:49], x[:49] = np.repeat(edges, 7), np.tile(edges, 7)
    p = rng.uniform(0.01, 100.0, 20000).astype(dtype)
    e = rng.uniform(-3, 3, 20000).astype(dtype)
    cases = [("atan2", (y, x), (POLY,)), ("pow", (p, e), (POLY,)),
             ("hypot", (y, x), ()), ("fmod", (y, x), ())]
    for name, args, impl in cases:
        got = getattr(TM, name)(*map(torch.from_numpy, args), *impl).numpy()
        with jax.enable_x64(dtype == np.float64):
            want = np.asarray(getattr(JM, name)(*map(jnp.asarray, args),
                                                *impl))
        assert got.dtype == dtype and want.dtype == dtype
        assert _ulps(got, want).max() <= 2.0, name


def test_atan2_gates_of_the_reference():
    rng = np.random.default_rng(1)
    y = rng.uniform(-10, 10, 100000).astype(np.float32)
    x = rng.uniform(-10, 10, 100000).astype(np.float32)
    got = TM.atan2(torch.from_numpy(y), torch.from_numpy(x), POLY).numpy()
    want = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    assert np.abs(got - want).max() < 1e-5
    # quadrant edges, and the signed zeros of IEEE / C
    for yy, xx in [(0.0, 1.0), (0.0, -1.0), (1.0, 0.0), (-1.0, 0.0),
                   (0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0)]:
        for impl in (POLY, "native"):
            r = TM.atan2(torch.tensor(yy), torch.tensor(xx), impl).item()
            assert np.isclose(r, np.arctan2(yy, xx), atol=1e-6)
            assert np.signbit(r) == np.signbit(np.arctan2(yy, xx))


def test_pow_gate_of_the_reference():
    rng = np.random.default_rng(2)
    x = rng.uniform(0.01, 100.0, 100000).astype(np.float32)
    y = rng.uniform(-3, 3, 100000).astype(np.float32)
    want = np.power(x.astype(np.float64), y.astype(np.float64))
    for impl in (POLY, "native"):
        got = TM.pow(torch.from_numpy(x), torch.from_numpy(y), impl).numpy()
        assert (np.abs(got - want) / np.abs(want)).max() < 1e-5, impl


def test_sincos_consistent():
    x = torch.linspace(-100, 100, 10001)
    s, c = TM.sincos(x, POLY)
    assert torch.equal(s, TM.sin(x, POLY)) and torch.equal(c, TM.cos(x, POLY))
    sh, ch = TM.sincosh(x / 10, POLY)
    assert torch.equal(sh, TM.sinh(x / 10, POLY))
    assert torch.equal(ch, TM.cosh(x / 10, POLY))


def test_edges_of_the_reference():
    f = torch.tensor
    assert TM.exp(f(1000.0), POLY) == np.inf
    assert TM.exp(f(-1000.0), POLY) == 0.0
    assert TM.exp(f(0.0), POLY) == 1.0
    assert TM.log(f(0.0), POLY) == -np.inf
    assert torch.isnan(TM.log(f(-1.0), POLY))
    assert TM.log(f(np.inf), POLY) == np.inf
    assert TM.log(f(1.0), POLY) == 0.0
    assert TM.hypot(f(3.0), f(4.0)) == 5.0
    assert TM.hypot(f(0.0), f(0.0)) == 0.0
    # overflow-safe: naive sqrt(a^2+b^2) would overflow at 1e38
    assert np.isclose(TM.hypot(f(1e38), f(1e38)).item(),
                      np.hypot(1e38, 1e38), rtol=1e-6)
    assert TM.hypot(f(np.inf), f(np.inf)) == np.inf
    assert TM.fmod(f(5.5), f(2.0)).item() == 1.5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,ref,lo,hi", [
    ("log1p", np.log1p, -0.9, 100.0), ("expm1", np.expm1, -20.0, 30.0)])
def test_log1p_expm1_ignore_impl_and_are_accurate(name, ref, lo, hi, dtype):
    # the reference routes both impls to the native function; no bound of
    # its own, so the tightest of its table, 1 ulp
    x = np.random.default_rng(3).uniform(lo, hi, 100000).astype(dtype)
    t = torch.from_numpy(x)
    fn = getattr(TM, name)
    assert torch.equal(fn(t, POLY), fn(t)) and torch.equal(
        fn(t), getattr(torch, name)(t))
    check_accuracy(_port(name, POLY), ref, lo, hi, max_ulp=1.0,
                   mean_ulp=0.1, dtype=dtype)


def test_fmod_is_exact():
    rng = np.random.default_rng(4)
    a = rng.uniform(-100, 100, 20000).astype(np.float32)
    b = rng.uniform(0.1, 10, 20000).astype(np.float32)
    got = TM.fmod(torch.from_numpy(a), torch.from_numpy(b), POLY).numpy()
    np.testing.assert_array_equal(got, np.fmod(a, b))


# the wrapped (_bf16_safe) functions: 16-bit in, float32 inside
WRAPPED = [n for n in RANGES] + ["log"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("impl", [POLY, "native"])
def test_16_bit_inputs_are_the_float32_result_rounded_once(impl, dtype):
    for name in sorted(set(WRAPPED)):
        x = torch.from_numpy(_inputs(name, np.float32, 2000)).to(dtype)
        got = _pair(getattr(TM, name)(x, impl))
        want = _pair(getattr(TM, name)(x.float(), impl))
        for g, w in zip(got, want):
            assert g.dtype == dtype, name
            assert _same(g, w.to(dtype)), name


def test_16_bit_poly_matches_the_reference():
    for name in sorted(set(WRAPPED)):
        x = torch.from_numpy(_inputs(name, np.float32, 2000)).to(
            torch.bfloat16)
        got = _pair(getattr(TM, name)(x, POLY))
        want = _pair(getattr(JM, name)(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), POLY))
        for g, w in zip(got, want):
            w = np.asarray(w.astype(jnp.float32))
            assert _ulps(g.float().numpy(), w).max() == 0.0, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_unwrapped_16_bit_functions_keep_their_dtype(dtype):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 4, 1000).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-2, 2, 1000).astype(np.float32))
    a, b = a.to(dtype), b.to(dtype)
    for name, args in (("atan2", (b, a, POLY)), ("pow", (a, b, POLY)),
                       ("hypot", (a, b)), ("fmod", (b, a)),
                       ("log1p", (a,)), ("expm1", (b,))):
        got = getattr(TM, name)(*args)
        assert got.dtype == dtype, name
        # computed in the 16-bit dtype, as the reference computes it:
        # within a few of its ulps of the float32 function
        want = getattr(TM, name)(*(v.float() if isinstance(v, torch.Tensor)
                                   else v for v in args))
        rel = ((got.float() - want).abs() / want.abs().clamp_min(1e-3))
        assert rel.max() < 8 * torch.finfo(dtype).eps, name


@pytest.mark.parametrize("impl", [POLY, "native"])
def test_integer_inputs_are_taken_as_float32(impl):
    i = torch.arange(-5, 6, dtype=torch.int32)
    for name in ("sin", "cos", "tan", "atan", "exp", "exp2", "cbrt", "sinh",
                 "cosh", "tanh", "asinh", "log1p", "expm1"):
        got = getattr(TM, name)(i, impl)
        assert got.dtype == torch.float32, name
        assert _same(got, getattr(TM, name)(i.float(), impl)), name
    got = TM.atan2(i, torch.tensor(2), impl)
    assert got.dtype == torch.float32
    want = np.asarray(JM.atan2(jnp.arange(-5, 6), jnp.int32(2), impl))
    if impl == POLY:
        assert _ulps(got.numpy(), want).max() == 0.0


def test_a_python_operand_takes_the_tensors_dtype_and_device():
    x = torch.linspace(0.1, 3.0, 50, dtype=torch.float64)
    assert torch.equal(TM.pow(x, 0.1, POLY),
                       TM.pow(x, torch.tensor(0.1, dtype=torch.float64),
                              POLY))
    assert TM.pow(x, 0.1).dtype == torch.float64
    assert torch.equal(TM.atan2(0.5, x, POLY),
                       TM.atan2(torch.full_like(x, 0.5), x, POLY))
    assert TM.hypot(x.float(), 2).dtype == torch.float32
    assert TM.fmod(3, x).dtype == torch.float64


def test_ops_exports_every_math_function():
    for name in ("sin", "cos", "sincos", "tan", "cot", "asin", "acos",
                 "atan", "atan2", "exp", "exp2", "log", "log2", "log1p",
                 "expm1", "cbrt", "pow", "sinh", "cosh", "sincosh", "tanh",
                 "csc", "sec", "csch", "sech", "coth", "asinh", "acosh",
                 "atanh", "fmod", "hypot"):
        assert getattr(TO, name) is getattr(TM, name), name
