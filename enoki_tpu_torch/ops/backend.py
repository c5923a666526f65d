"""Backend-generic op dispatch for composite types (counterpart of
enoki_tpu/ops/backend.py).

The reference's composite types are generic over the execution backend:
every op routes through L2 free functions that dispatch on the element
type (array_math.h:121-150's 5-way dispatch macro). ``ns_of(*elements)``
and ``math_ns(x, impl)`` are that dispatch point: they return the op
namespace for the element type, so that ``types/``, ``render/vec.py`` and
``ops/special.py`` are written once. For tensors that namespace is the
eager PyTorch one; for the port's ``trace.LazyArray`` it is the trace's
functional API (``_LazyNS``, ``_TraceMath``), which records opcodes that
one later eval fuses (on the card into the trace's CUDA kernels, on the
CPU through its plain interpreter). ``is_lazy`` recognises a LazyArray
without importing the trace (which builds its native core).

Square roots are correctly rounded on every device (``router._sqrt_rn``,
``_rsqrt_rn``: PyTorch's CPU float32 and float64 sqrt is not), ``sign``
and ``clamp`` are the router's (``sign(-0.0)`` is -1, ``clamp`` is
``jnp.clip``'s), and ``round`` is ``torch.round``, half to even as
``jnp.round``.
"""

from __future__ import annotations

import torch

from . import math as M
from .router import _is_lazy as is_lazy  # noqa: F401
from .router import _rsqrt_rn, _sqrt_rn, _trace, clamp, copysign, mulsign, sign


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


class _LazyNS:
    """Lazy namespace: the trace's functional API (records opcodes; one
    downstream eval fuses everything)."""

    def __getattr__(self, name):
        fn = getattr(_trace(), name)
        setattr(self, name, fn)  # cache for the next lookup
        return fn


_LAZY = _LazyNS()


def ns_of(*xs):
    """The op namespace for the given elements (the array_router dispatch
    point): lazy if any element is a LazyArray."""
    return _LAZY if any(is_lazy(x) for x in xs) else _TORCH


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


class _TraceMath:
    """Lazy math: trace opcodes. The impl selector does not apply: a
    lazy transcendental is the trace's own opcode (the float64 function
    rounded once, on the card as in the plain interpreter), as the
    reference's lazy backend takes the device's own route
    (cuda.h:433-453). ``*_native`` / ``*_ref`` resolve to the same
    opcodes, so that generic code addressing "the library's function"
    works on the trace too."""

    def __getattr__(self, name):
        base = name
        for suffix in ("_native", "_ref"):
            if base.endswith(suffix):
                base = base[:-len(suffix)]
        fn = getattr(_trace(), base)
        setattr(self, name, fn)  # cache for the next lookup
        return fn

    hypot = staticmethod(M.hypot)  # its primitives take LazyArrays
    mulsign = staticmethod(mulsign)  # the router's lazy branch

    @staticmethod
    def sincosh(x):
        tr = _trace()
        return tr.sinh(x), tr.cosh(x)

    @staticmethod
    def full_like(x, value, dtype=None):
        """A literal of x's length and dtype (or ``dtype``) on x's device;
        a device-free size-1 ``x`` gives a device-free scalar literal."""
        tr = _trace()
        dtype = dtype or x.dtype
        if x.device is None:
            return x._coerce(value).cast(dtype)
        return tr.LazyArray.literal(value, len(x), dtype, device=x.device)

    @staticmethod
    def broadcast(*xs):
        # the trace broadcasts size-1 operands itself (the 1-or-equal
        # rule, jit.cu:776-782); nothing to materialise
        return xs


_TRACE_MATH = _TraceMath()
_EAGER_NATIVE = _EagerMath("native")


def math_ns(x, impl: str = "native"):
    """Math-function namespace for element ``x``: the trace's opcodes for
    a LazyArray, ops.math(impl=...) for eager tensors. The dispatch point
    that makes types/ and ops/special.py backend-generic (Complex<FloatC>
    instantiates from the same source as Complex<FloatP>)."""
    if is_lazy(x):
        return _TRACE_MATH
    return _EAGER_NATIVE if impl == "native" else _EagerMath(impl)
