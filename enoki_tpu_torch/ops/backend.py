"""Backend-generic op dispatch for composite types (counterpart of
enoki_tpu/ops/backend.py), its eager half.

The reference's composite types are generic over the execution backend:
every op routes through L2 free functions that dispatch on the element
type (array_math.h:121-150's 5-way dispatch macro). ``ns_of(*elements)``
and ``math_ns(x, impl)`` are that dispatch point: they return the op
namespace for the element type, so that ``types/`` and ``ops/special.py``
are written once. Here that namespace is the eager PyTorch one; the lazy
``LazyArray`` namespaces of the reference (``_LazyNS``, ``_TraceMath``)
wait for the port of ``trace/``, and ``is_lazy`` answers for it.

Square roots are correctly rounded on every device (``router._sqrt_rn``,
``_rsqrt_rn``: PyTorch's CPU float32 and float64 sqrt is not), ``sign``
and ``clamp`` are the router's (``sign(-0.0)`` is -1, ``clamp`` is
``jnp.clip``'s), and ``round`` is ``torch.round``, half to even as
``jnp.round``.
"""

from __future__ import annotations

import torch

from . import math as M
from .router import _rsqrt_rn, _sqrt_rn, clamp, copysign, mulsign, sign


def is_lazy(x) -> bool:
    """Whether x is a LazyArray of the port's ``trace`` (False for
    everything until ``trace/`` is ported)."""
    return type(x).__module__.startswith("enoki_tpu_torch.trace")


def _native(fn):
    """PyTorch's ``fn``, a float of fewer than 64 bits taken in float64 and
    rounded once: the correctly rounded result but for rare near-ties, and
    the same bits on the CPU and the card, whose float32 functions differ
    by an ulp."""
    def native(x):
        return fn(x) if x.dtype == torch.float64 else fn(x.double()).to(
            x.dtype)
    return native


class _TorchNS:
    """Eager namespace (PyTorch's own functions)."""

    sqrt = staticmethod(_sqrt_rn)
    rsqrt = staticmethod(_rsqrt_rn)
    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    tan = staticmethod(torch.tan)
    asin = staticmethod(torch.asin)
    acos = staticmethod(torch.acos)
    atan = staticmethod(torch.atan)
    atan2 = staticmethod(torch.atan2)
    sinh = staticmethod(torch.sinh)
    cosh = staticmethod(torch.cosh)
    tanh = staticmethod(torch.tanh)
    abs = staticmethod(torch.abs)
    maximum = staticmethod(M._maximum)
    minimum = staticmethod(M._minimum)
    floor = staticmethod(torch.floor)
    # the reference semantics (sign(0)=1, sign(-0.0)=-1), not
    # torch.sign's sign(0)=0: every namespace must agree at zero
    sign = staticmethod(sign)
    select = staticmethod(torch.where)

    @staticmethod
    def sincos(x):
        return torch.sin(x), torch.cos(x)


_TORCH = _TorchNS()


def require_eager(*xs):
    """Raise ``NotImplementedError`` if any of ``xs`` is a LazyArray: the
    lazy branches of the reference wait for the port of trace/."""
    if any(is_lazy(x) for x in xs):
        raise NotImplementedError("the lazy namespace waits for the port "
                                  "of trace/")


def ns_of(*xs):
    """The op namespace for the given element tensors (the array_router
    dispatch point)."""
    require_eager(*xs)
    return _TORCH


class _EagerMath:
    """Eager math with the ops.math impl selector (native | poly), plus
    the structural op surface generic code needs.

    ``*_native`` / ``*_ref`` names always resolve to PyTorch's own
    function regardless of the impl selector: generic code uses them where
    the reference's poly paths call a native op (the f64 kernels of
    ops/special.py take the native exp and log, the elliptic integrals
    the native sin and cos). ``*_native`` takes a float of fewer than 64
    bits in float64 and rounds once (``_native``)."""

    def __init__(self, impl: str):
        self._impl = impl

    def __getattr__(self, name):
        fn = getattr(M, name)
        impl = self._impl

        def wrapped(*args):
            return fn(*args, impl)

        return wrapped

    # functions without an impl selector
    sqrt = staticmethod(_sqrt_rn)
    rsqrt = staticmethod(_rsqrt_rn)
    maximum = staticmethod(M._maximum)
    minimum = staticmethod(M._minimum)
    select = staticmethod(torch.where)
    hypot = staticmethod(M.hypot)
    abs = staticmethod(torch.abs)
    round = staticmethod(torch.round)
    floor = staticmethod(torch.floor)
    copysign = staticmethod(copysign)
    isinf = staticmethod(torch.isinf)
    isnan = staticmethod(torch.isnan)
    exp_native = staticmethod(_native(torch.exp))
    log_native = staticmethod(_native(torch.log))
    sin_native = staticmethod(_native(torch.sin))
    cos_native = staticmethod(_native(torch.cos))
    clamp = staticmethod(clamp)
    mulsign = staticmethod(mulsign)
    erf_ref = staticmethod(torch.special.erf)
    erfc_ref = staticmethod(torch.special.erfc)
    lgamma_ref = staticmethod(torch.lgamma)

    @staticmethod
    def full_like(x, value, dtype=None):
        return torch.full_like(x, value, dtype=dtype or x.dtype)

    @staticmethod
    def broadcast(*xs):
        return torch.broadcast_tensors(*xs)


_EAGER_NATIVE = _EagerMath("native")


def math_ns(x, impl: str = "native"):
    """Math-function namespace for element ``x``: ops.math(impl=...) for
    eager tensors. The dispatch point that makes types/ and ops/special.py
    backend-generic; the trace's namespace for a LazyArray waits for the
    port of trace/."""
    require_eager(x)
    return _EAGER_NATIVE if impl == "native" else _EagerMath(impl)
