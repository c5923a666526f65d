"""ops/backend.py of the port (its eager half): ``math_ns`` reaches
ops.math with the impl selector bit for bit, ``ns_of`` and ``is_lazy``
answer for eager tensors, and the structural entries are the router's
(correctly rounded roots, the reference's sign at zero, ``jnp.clip``'s
clamp), checked against the reference's namespaces on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.ops import backend as JB
from enoki_tpu_torch.ops import backend as B, math as M, router as R

MATH_NAMES = ("sin", "cos", "tan", "cot", "asin", "acos", "atan", "exp",
              "exp2", "log", "log2", "log1p", "expm1", "cbrt", "sinh",
              "cosh", "tanh", "csc", "sec", "csch", "sech", "coth", "asinh",
              "acosh", "atanh", "sincos", "sincosh")


def _x(n=4000, lo=-3.0, hi=3.0, dtype=np.float32, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(lo, hi, n).astype(dtype))


def _same(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (
        b if isinstance(b, tuple) else (b,))
    return all(x.dtype == y.dtype and bool(
        ((x == y) | (x.isnan() & y.isnan())).all()) for x, y in zip(a, b))


@pytest.mark.parametrize("impl", ["poly", "native"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_math_ns_is_ops_math_with_the_impl(impl, dtype):
    x = _x(dtype=dtype)
    ns = B.math_ns(x, impl)
    for name in MATH_NAMES:
        assert _same(getattr(ns, name)(x), getattr(M, name)(x, impl)), name
    y = _x(dtype=dtype, seed=1)
    assert _same(ns.atan2(y, x), M.atan2(y, x, impl))
    assert _same(ns.pow(x.abs(), y), M.pow(x.abs(), y, impl))
    assert _same(ns.hypot(x, y), M.hypot(x, y))
    assert _same(ns.fmod(x, y), M.fmod(x, y))


def test_native_namespace_is_shared_and_poly_is_its_own():
    x = _x()
    assert B.math_ns(x) is B.math_ns(x, "native") is B._EAGER_NATIVE
    assert isinstance(B.math_ns(x, "poly"), B._EagerMath)
    assert B.math_ns(x, "poly")._impl == "poly"


def test_ns_of_and_is_lazy_answer_for_eager_tensors():
    x, y = _x(), _x(seed=1)
    for v in (x, 1.0, np.float32(2.0), np.zeros(3), [1.0]):
        assert B.is_lazy(v) is False
    assert B.ns_of(x) is B.ns_of(x, y) is B._TORCH
    ns = B.ns_of(x)
    s, c = ns.sincos(x)
    assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))
    assert torch.equal(ns.select(x > 0, x, y), torch.where(x > 0, x, y))
    assert torch.equal(ns.maximum(x, 0.5), torch.clamp_min(x, 0.5))
    z = torch.tensor([-0.0, 0.0, -0.0, float("nan")])
    w = torch.tensor([0.0, -0.0, -0.0, 1.0])
    assert torch.signbit(ns.maximum(z, w)).tolist()[:3] == [False, False, True]
    assert torch.signbit(ns.minimum(z, w)).tolist()[:3] == [True, True, True]
    assert ns.maximum(z, w)[3].isnan() and ns.minimum(w, z)[3].isnan()
    for name in ("exp", "log", "sin", "cos", "tan", "asin", "acos", "atan",
                 "sinh", "cosh", "tanh", "abs", "floor"):
        assert getattr(ns, name) is getattr(torch, name), name
    assert ns.atan2 is torch.atan2


def test_roots_sign_and_clamp_are_the_routers():
    for ns in (B.ns_of(_x()), B.math_ns(_x()), B.math_ns(_x(), "poly")):
        assert ns.sqrt is R._sqrt_rn and ns.rsqrt is R._rsqrt_rn
    assert B.ns_of(_x()).sign is R.sign
    for ns in (B.math_ns(_x()), B.math_ns(_x(), "poly")):
        assert ns.clamp is R.clamp and ns.mulsign is R.mulsign
        assert ns.copysign is R.copysign
    # the reference's answers at zero, and jnp.clip's clamp
    z = torch.tensor([0.0, -0.0, 2.5, -3.0, float("nan")])
    jz = jnp.asarray(z.numpy())
    np.testing.assert_array_equal(B.ns_of(z).sign(z).numpy(),
                                  np.asarray(JB.ns_of(jz).sign(jz)))
    got = B.math_ns(z).clamp(z, 0.0, 1.0).numpy()
    want = np.asarray(JB.math_ns(jz).clamp(jz, 0.0, 1.0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    # correctly rounded roots, as XLA's sqrt
    x = _x(20000, 0.0, 100.0)
    np.testing.assert_array_equal(B.math_ns(x).sqrt(x).numpy(),
                                  np.sqrt(x.numpy()))


def test_structural_entries_match_the_reference():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.7, -0.2])
    jx = jnp.asarray(x.numpy())
    ns, jns = B.math_ns(x, "poly"), JB.math_ns(jx, "poly")
    for name in ("round", "floor", "abs", "isinf", "isnan"):
        np.testing.assert_array_equal(getattr(ns, name)(x).numpy(),
                                      np.asarray(getattr(jns, name)(jx)))
    np.testing.assert_array_equal(ns.copysign(x, -x).numpy(),
                                  np.asarray(jns.copysign(jx, -jx)))
    np.testing.assert_array_equal(ns.mulsign(x, -x).numpy(),
                                  np.asarray(jns.mulsign(jx, -jx)))
    np.testing.assert_array_equal(ns.maximum(x, 0.0).numpy(),
                                  np.asarray(jns.maximum(jx, 0.0)))
    np.testing.assert_array_equal(ns.minimum(x, 1.0).numpy(),
                                  np.asarray(jns.minimum(jx, 1.0)))
    np.testing.assert_array_equal(ns.select(x > 0, x, 0.0).numpy(),
                                  np.asarray(jns.select(jx > 0, jx, 0.0)))
    for name, fn in (("erf_ref", torch.special.erf),
                     ("erfc_ref", torch.special.erfc),
                     ("lgamma_ref", torch.lgamma)):
        assert getattr(ns, name) is fn, name
    # *_native: PyTorch's own, below float64 taken in float64 and rounded
    # once (the same bits on the CPU and the card)
    x64 = x.double()
    for name, fn in (("exp_native", torch.exp), ("log_native", torch.log),
                     ("sin_native", torch.sin), ("cos_native", torch.cos)):
        assert _same(getattr(ns, name)(x64), fn(x64)), name
        assert _same(getattr(ns, name)(x), fn(x64).float()), name
        assert getattr(ns, name)(x.half()).dtype == torch.float16


def test_full_like_keeps_device_and_dtype_and_broadcast_broadcasts():
    ns = B.math_ns(_x())
    x64 = _x(8, dtype=np.float64)
    f = ns.full_like(x64, 2.5)
    assert f.dtype == torch.float64 and f.device == x64.device
    assert f.shape == x64.shape and bool((f == 2.5).all())
    assert ns.full_like(x64, 3, torch.int32).dtype == torch.int32
    a, b = ns.broadcast(torch.zeros(3, 1), torch.ones(4))
    assert a.shape == b.shape == (3, 4)


def test_lazy_namespaces_wait_for_trace():
    class FakeLazy:
        pass
    FakeLazy.__module__ = "enoki_tpu_torch.trace"
    assert B.is_lazy(FakeLazy())
    with pytest.raises(NotImplementedError, match="trace"):
        B.math_ns(FakeLazy())
    with pytest.raises(NotImplementedError, match="trace"):
        B.ns_of(_x(), FakeLazy())
