"""Transcendental math (counterpart of enoki_tpu/ops/math.py), ported
whole but for its lazy half.

Parity target: the reference's branch-free, range-reduced polynomial
transcendentals (array_math.h:445-1381) with the published accuracy
bounds (docs/reference.rst:1285-1527, BASELINE.md §A).

Every function takes ``impl``:
  * ``"native"`` -- PyTorch's own function (``torch.sin`` ...). PyTorch
    has no cube root: ``cbrt``'s native route is the float64 power
    |x|^(1/3) rounded once to x's dtype, with x's sign.
  * ``"poly"``   -- the reference's branch-free Cody-Waite range reduction
    and Estrin / Horner fits (the classic Cephes minimax fits, public
    domain, and the own float64 fits of ``polys64``), coefficient for
    coefficient and in the same order of operations. Every branch is a
    ``torch.where`` lane mask. Square roots are correctly rounded
    (``router._sqrt_rn``), so that the CPU and the card give the same
    bits.

``log1p``, ``expm1`` and ``fmod`` ignore ``impl`` and ``hypot`` takes
none, as in the reference. 16-bit float inputs are computed in float32
and rounded back on exit (``_bf16_safe``), but for ``atan2``, ``pow``,
``fmod``, ``hypot``, ``log1p`` and ``expm1``, which the reference leaves
unwrapped; integer inputs are taken as float32. A Python number given
with a tensor takes the tensor's dtype and device, as a weakly typed
scalar does in the reference; Python numbers alone make float32 tensors
on the CUDA card, or raise without one.

Every kernel is written against a primitive namespace (``_EPrim``), so
that the same source can later instantiate for the port's ``LazyArray``:
the reference's lazy (``_LPrim``) instantiation waits for the port of
``trace/``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import polys as P
from . import polys64 as P64
from .router import (_asarray, _maximum as _max, _minimum as _min,
                     _sqrt_rn, _to_float, copysign as _copysign,
                     frexp as _frexp, ldexp as _ldexp, mulsign as _mulsign)

_NATIVE = "native"
_POLY = "poly"

_16BIT = (torch.bfloat16, torch.float16)


def _is_number(v):
    return isinstance(v, (bool, int, float))


def _f(x):
    """x as a tensor (a Python value made on the card, ``router.
    _asarray``), integers taken as float32."""
    return _to_float(_asarray(x))


def _scalar(x, v):
    """The Python number ``v`` as a 0-d tensor of x's dtype, on its device
    (``jnp.asarray(v, x.dtype)``)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _floats(*vs):
    """Every operand as a float tensor: tensors (integers as float32) as
    they are; a Python number in the tensors' promoted dtype on the first
    one's device, as a weakly typed scalar; Python numbers alone as float32
    on the card."""
    ts = [_f(v) for v in vs if not _is_number(v)]
    if not ts:
        return tuple(_f(v) for v in vs)
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    it = iter(ts)
    return tuple(torch.full((), v, dtype=dtype, device=ts[0].device)
                 if _is_number(v) else next(it) for v in vs)


def _maximum(a, b):
    """``jnp.maximum`` of a tensor and a tensor or a Python number."""
    return _max(a, b if isinstance(b, torch.Tensor) else _scalar(a, b))


def _minimum(a, b):
    """``jnp.minimum`` of a tensor and a tensor or a Python number."""
    return _min(a, b if isinstance(b, torch.Tensor) else _scalar(a, b))


def _cbrt_native(x):
    """The float64 |x|^(1/3), rounded once to x's dtype, with x's sign
    (PyTorch has no cube root)."""
    return _mulsign(torch.pow(x.abs().double(), 1.0 / 3.0).to(x.dtype), x)


def _bf16_safe(fn):
    """bf16/f16 policy: 8-10 mantissa bits cannot carry a Cody-Waite
    reduction, so 16-bit inputs are computed in float32 and rounded back
    on exit (SURVEY §7 step 1's 'bf16-safe variants'); both impls."""

    @functools.wraps(fn)
    def wrapped(x, impl=_NATIVE, **kw):
        x = _asarray(x)
        if x.dtype in _16BIT:
            out = fn(x.to(torch.float32), impl, **kw)
            if isinstance(out, tuple):
                return tuple(o.to(x.dtype) for o in out)
            return out.to(x.dtype)
        return fn(x, impl, **kw)

    return wrapped


def _is64(x):
    return x.dtype == torch.float64


# ---------------------------------------------------------------------------
# The primitive namespace. The poly kernels below use only arithmetic,
# comparison and bit operators, the primitives here, and the router's
# _ldexp, _frexp, _mulsign and _copysign.
# ---------------------------------------------------------------------------


class _EPrim:
    abs = staticmethod(torch.abs)
    floor = staticmethod(torch.floor)
    sqrt = staticmethod(_sqrt_rn)
    maximum = staticmethod(_maximum)
    minimum = staticmethod(_minimum)
    isinf = staticmethod(torch.isinf)
    where = staticmethod(torch.where)
    # a scalar constant in x's dtype (broadcasts downstream)
    full_like = staticmethod(_scalar)

    # PyTorch's own functions (the ``impl="native"`` route)
    sin_native = staticmethod(torch.sin)
    cos_native = staticmethod(torch.cos)
    tan_native = staticmethod(torch.tan)
    asin_native = staticmethod(torch.asin)
    acos_native = staticmethod(torch.acos)
    atan_native = staticmethod(torch.atan)
    atan2_native = staticmethod(torch.atan2)
    exp_native = staticmethod(torch.exp)
    exp2_native = staticmethod(torch.exp2)
    log_native = staticmethod(torch.log)
    log2_native = staticmethod(torch.log2)
    log1p_native = staticmethod(torch.log1p)
    expm1_native = staticmethod(torch.expm1)
    cbrt_native = staticmethod(_cbrt_native)
    pow_native = staticmethod(torch.pow)
    sinh_native = staticmethod(torch.sinh)
    cosh_native = staticmethod(torch.cosh)
    tanh_native = staticmethod(torch.tanh)
    asinh_native = staticmethod(torch.asinh)
    acosh_native = staticmethod(torch.acosh)
    atanh_native = staticmethod(torch.atanh)
    fmod_native = staticmethod(torch.fmod)


_EP = _EPrim()


def _prim(x):
    """(ns, x): the primitive namespace, x float-coerced."""
    return _EP, _f(x)


def _prim2(a, b):
    """(ns, a, b): two operands on one device and dtype (``_floats``)."""
    return (_EP,) + _floats(a, b)


# ---------------------------------------------------------------------------
# sin / cos / sincos / tan  (array_math.h:445-700, sincos_approx :262)
# ---------------------------------------------------------------------------

# pi/4 split into exactly-representable parts for extended-precision range
# reduction (Cody-Waite). The f32 split uses four 10-significant-bit
# chunks: with |x| < 8192 the quotient j <= 10430 needs 14 bits, so every
# j*chunk product is exact in f32 and the reduction residual is ~j*2^-54.
_DP4_F32 = P64._DP4_F32
_DP_F64 = (7.85398125648498535156e-1, 3.77489470793079817668e-8,
           2.69515142907905952645e-15)

_SINCOF_F32 = (-1.9515295891e-4, 8.3321608736e-3, -1.6666654611e-1)
_COSCOF_F32 = (2.443315711809948e-5, -1.388731625493765e-3, 4.166664568298827e-2)

_SINCOF_F64 = (1.58962301576546568060e-10, -2.50507477628578072866e-8,
               2.75573136213857245213e-6, -1.98412698295895385996e-4,
               8.33333333332211858878e-3, -1.66666666666666307295e-1)
_COSCOF_F64 = (-1.13585365213876817300e-11, 2.08757008419747316778e-9,
               -2.75573141792967388112e-7, 2.48015872888517179954e-5,
               -1.38888888888730564116e-3, 4.16666666666665929218e-2)


def _sincos_reduce(ns, x):
    """Cody-Waite reduction of |x| by pi/4: returns (q, r) with
    x = q*(pi/4) + r, q integer, |r| <= pi/4 + eps."""
    xa = ns.abs(x)
    q = ns.floor(xa * (4.0 / math.pi))
    qi = q.to(torch.int64 if _is64(x) else torch.int32)
    # map quadrant: if odd, bump to even (Cephes: j = (j+1) & ~1 then y++)
    odd = (qi & 1).bool()
    qi = ns.where(odd, qi + 1, qi)
    q = ns.where(odd, q + 1.0, q)
    if _is64(x):
        dp1, dp2, dp3 = _DP_F64
        r = ((xa - q * dp1) - q * dp2) - q * dp3
    else:
        c1, c2, c3, c4 = _DP4_F32
        r = (((xa - q * c1) - q * c2) - q * c3) - q * c4
    return qi, r


def _sincos_poly(ns, x):
    """Returns (quadrant, sin(|x| reduced), cos(|x| reduced))."""
    qi, r = _sincos_reduce(ns, x)
    z = r * r
    if _is64(x):
        s_poly = P.horner(z, list(reversed(_SINCOF_F64)))
        c_poly = P.horner(z, list(reversed(_COSCOF_F64)))
    else:
        s_poly = P.poly2(z, *reversed(_SINCOF_F32))
        c_poly = P.poly2(z, *reversed(_COSCOF_F32))
    sin_r = r + r * z * s_poly
    cos_r = 1.0 - 0.5 * z + z * z * c_poly
    return qi, sin_r, cos_r


@_bf16_safe
def sincos(x, impl=_NATIVE):
    """Simultaneous sin+cos sharing one range reduction (array_math.h
    sincos)."""
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.sin_native(x), ns.cos_native(x)
    qi, sin_r, cos_r = _sincos_poly(ns, x)
    # after the even-ing step the octant j = qi & 7 is in {0, 2, 4, 6}:
    # {0}: sin=s, cos=c; {2}: sin=c, cos=-s; {4}: sin=-s, cos=-c;
    # {6}: sin=-c, cos=s
    j = qi & 7
    sin_v = ns.where(j == 0, sin_r, ns.where(j == 2, cos_r, ns.where(j == 4, -sin_r, -cos_r)))
    cos_v = ns.where(j == 0, cos_r, ns.where(j == 2, -sin_r, ns.where(j == 4, -cos_r, sin_r)))
    sin_v = _mulsign(sin_v, x)
    return sin_v, cos_v


@_bf16_safe
def sin(x, impl=_NATIVE):
    if impl == _NATIVE:
        ns, x = _prim(x)
        return ns.sin_native(x)
    return sincos(x, impl)[0]


@_bf16_safe
def cos(x, impl=_NATIVE):
    if impl == _NATIVE:
        ns, x = _prim(x)
        return ns.cos_native(x)
    return sincos(x, impl)[1]


_TANCOF_F32 = (9.38540185543e-3, 3.11992232697e-3, 2.44301354525e-2,
               5.34112807005e-2, 1.33387994085e-1, 3.33331568548e-1)


@_bf16_safe
def tan(x, impl=_NATIVE):
    """Tangent (array_math.h tan); f32 poly path, f64 through the sincos
    reduction."""
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.tan_native(x)
    if _is64(x):
        qi, r = _sincos_reduce(ns, x)
        z = r * r
        t = r + r * z * P.horner(z, P64._TAN64)
        flip = (qi & 2).bool()
        t = ns.where(flip, -1.0 / t, t)
        return _mulsign(t, x)
    xa = ns.abs(x)
    q = ns.floor(xa * (4.0 / math.pi))
    qi = q.to(torch.int32)
    odd = (qi & 1).bool()
    qi = ns.where(odd, qi + 1, qi)
    q = ns.where(odd, q + 1.0, q)
    c1, c2, c3, c4 = _DP4_F32
    r = (((xa - q * c1) - q * c2) - q * c3) - q * c4
    z = r * r
    t = P.poly5(z, *reversed(_TANCOF_F32))
    t = r + r * z * t
    # odd half-quadrants: tan = -1/tan
    flip = (qi & 2).bool()
    t = ns.where(flip, -1.0 / t, t)
    return _mulsign(t, x)


@_bf16_safe
def cot(x, impl=_NATIVE):
    if impl == _NATIVE:
        ns, x = _prim(x)
        return 1.0 / ns.tan_native(x)
    return 1.0 / tan(x, impl)


# ---------------------------------------------------------------------------
# asin / acos / atan / atan2 (array_math.h:700-900)
# ---------------------------------------------------------------------------

_ASINCOF_F32 = (4.2163199048e-2, 2.4181311049e-2, 4.5470025998e-2,
                7.4953002686e-2, 1.6666752422e-1)


def _asin_kernel64(xx, z):
    """asin on the reduced argument: xx + xx*z*K(z), z = xx^2 <= 0.25."""
    return xx + xx * z * P.horner(z, P64._ASIN64)


def _asin64(ns, x):
    """f64 asin: |x| <= 0.5 direct kernel; |x| > 0.5 through the
    half-angle identity asin(a) = pi/2 - 2 asin(sqrt((1-a)/2)) with a
    two-part pi/2."""
    a = ns.abs(x)
    big = a > 0.5
    zb = 0.5 * (1.0 - a)
    z = ns.where(big, zb, a * a)
    xx = ns.where(big, ns.sqrt(zb), a)
    p = _asin_kernel64(xx, z)
    rb = P64._PIO2_HI_64 - (2.0 * p - P64._PIO2_LO_64)
    r = ns.where(big, rb, p)
    return _mulsign(r, x)


def _acos64(ns, x):
    """f64 acos: pi/2 - asin for |x| <= 0.5; 2 asin(sqrt((1-x)/2)) for
    x > 0.5 and pi - that for x < -0.5 (exact at the endpoints)."""
    a = ns.abs(x)
    big = a > 0.5
    zb = 0.5 * (1.0 - a)
    z = ns.where(big, zb, a * a)
    xx = ns.where(big, ns.sqrt(zb), a)
    p = _asin_kernel64(xx, z)
    small_v = P64._PIO2_HI_64 - (_mulsign(p, x) - P64._PIO2_LO_64)
    big_pos = 2.0 * p
    big_v = ns.where(x < 0, 2.0 * P64._PIO2_HI_64 - (big_pos - 2.0 * P64._PIO2_LO_64), big_pos)
    return ns.where(big, big_v, small_v)


@_bf16_safe
def asin(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.asin_native(x)
    if _is64(x):
        return _asin64(ns, x)
    a = ns.abs(x)
    big = a > 0.5
    z1 = 0.5 * (1.0 - a)
    x1 = ns.sqrt(z1)
    z2 = a * a
    zz = ns.where(big, z1, z2)
    xx = ns.where(big, x1, a)
    p = P.poly4(zz, *reversed(_ASINCOF_F32))
    r = xx + xx * zz * p
    # split pi/2 to cancel rounding in the pi/2 - 2r branch
    pio2_hi, pio2_lo = 1.5707962513, 7.54978941586e-8
    r = ns.where(big, pio2_hi - (2.0 * r - pio2_lo), r)
    return _mulsign(r, x)


@_bf16_safe
def acos(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.acos_native(x)
    if _is64(x):
        return _acos64(ns, x)
    # acos(x) = pi/2 - asin(x), the |x|>0.5 branch rewritten for accuracy
    a = ns.abs(x)
    big = a > 0.5
    z = 0.5 * (1.0 - a)
    s = ns.sqrt(z)
    p = P.poly4(ns.where(big, z, a * a), *reversed(_ASINCOF_F32))
    xx = ns.where(big, s, a)
    r_small = math.pi / 2 - _mulsign(xx + xx * ns.where(big, z, a * a) * p, x)
    r_big_pos = 2.0 * (s + s * z * p)
    r_big = ns.where(x < 0, math.pi - r_big_pos, r_big_pos)
    return ns.where(big, r_big, r_small)


_ATANCOF_F32 = (8.05374449538e-2, -1.38776856032e-1, 1.99777106478e-1,
                -3.33329491539e-1)


@_bf16_safe
def atan(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.atan_native(x)
    a = ns.abs(x)
    if _is64(x):
        t3 = a > 2.414213562373095049  # tan(3*pi/8) = 1 + sqrt(2)
        t1 = (a > 0.4142135623730950488) & ~t3  # tan(pi/8) = sqrt(2) - 1
        y_hi = ns.where(t3, P64._PIO2_HI_64,
                        ns.where(t1, P64._PIO4_HI_64, ns.full_like(x, 0.0)))
        y_lo = ns.where(t3, P64._PIO2_LO_64,
                        ns.where(t1, P64._PIO4_LO_64, ns.full_like(x, 0.0)))
        xr = ns.where(t3, -1.0 / ns.maximum(a, 1e-300),
                      ns.where(t1, (a - 1.0) / (a + 1.0), a))
        z = xr * xr
        r = y_hi + (xr + xr * z * P.horner(z, P64._ATAN64) + y_lo)
        return _mulsign(r, x)
    t3 = a > 2.414213562373095  # tan(3*pi/8)
    t1 = (a > 0.4142135623730950) & ~t3  # tan(pi/8)
    y = ns.where(t3, math.pi / 2,
                 ns.where(t1, math.pi / 4, ns.full_like(x, 0.0)))
    xr = ns.where(t3, -1.0 / ns.maximum(a, 1e-30),
                  ns.where(t1, (a - 1.0) / (a + 1.0), a))
    z = xr * xr
    p = P.poly3(z, *reversed(_ATANCOF_F32))
    r = y + (xr + xr * z * p)
    return _mulsign(r, x)


def atan2(y, x, impl=_NATIVE):
    ns, y, x = _prim2(y, x)
    if impl == _NATIVE:
        return ns.atan2_native(y, x)
    # quadrant fixup around atan(y/x) with mask logic (array_math.h atan2)
    base = atan(y / ns.where(x == 0.0, torch.finfo(x.dtype).tiny, x), impl)
    base = ns.where(x == 0.0, 0.0, base)
    adj = ns.where(x < 0, _copysign(ns.full_like(x, math.pi), y), 0.0)
    r = base + adj
    # x == 0: +/- pi/2 by sign of y
    r = ns.where(x == 0.0, _copysign(ns.full_like(x, math.pi / 2), y), r)
    # both zero (IEEE/C and the native route): atan2(+-0, +0) = +-0,
    # atan2(+-0, -0.0) = +-pi (x == 0.0 also matches -0.0)
    x_neg = _copysign(ns.full_like(x, 1.0), x) < 0  # sign bit (-0.0 too)
    both = (x == 0.0) & (y == 0.0)
    r = ns.where(both,
                 ns.where(x_neg, _copysign(ns.full_like(x, math.pi), y),
                          _copysign(ns.full_like(x, 0.0), y)),
                 r)
    return r


# ---------------------------------------------------------------------------
# exp / log / exp2 / log2 (array_math.h:900-1100)
# ---------------------------------------------------------------------------

_EXPCOF_F32 = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
               4.1665795894e-2, 1.6666665459e-1, 4.9999999912e-1)

_EXP_P_F64 = (1.26177193074810590878e-4, 3.02994407707441961300e-2,
              9.99999999999999999910e-1)
_EXP_Q_F64 = (3.00198505138664455042e-6, 2.52448340349684104192e-3,
              2.27265548208155028766e-1, 2.00000000000000000005e0)


@_bf16_safe
def exp(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.exp_native(x)
    if _is64(x):
        n = ns.floor(1.4426950408889634073599 * x + 0.5)
        xr = x - n * 6.93145751953125e-1 - n * 1.42860682030941723212e-6
        xx = xr * xr
        px = xr * P.horner(xx, list(reversed(_EXP_P_F64)))
        qx = P.horner(xx, list(reversed(_EXP_Q_F64)))
        ex = 1.0 + 2.0 * px / (qx - px)
        r = _ldexp(ex, n)
    else:
        n = ns.floor(1.44269504088896341 * x + 0.5)
        xr = x - n * 0.693359375 - n * (-2.12194440e-4)
        z = P.poly5(xr, *reversed(_EXPCOF_F32))
        r = 1.0 + xr + xr * xr * z
        r = _ldexp(r, n)
    hi = 709.782712893384 if _is64(x) else 88.3762626647949
    lo = -708.396 if _is64(x) else -87.33654
    r = ns.where(x > hi, math.inf, r)
    r = ns.where(x < lo, 0.0, r)
    return r


_LOGCOF_F32 = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
               -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
               2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)

_LOG_P_F64 = (1.01875663804580931796e-4, 4.97494994976747001425e-1,
              4.70579119878881725854e0, 1.44989225341610930846e1,
              1.79368678507819816313e1, 7.70838733755885391666e0)
_LOG_Q_F64 = (1.12873587189167450590e1, 4.52279145837532221105e1,
              8.29875266912776603211e1, 7.11544750618563894466e1,
              2.31251620126765340583e1)


@_bf16_safe
def log(x, impl=_NATIVE):
    """Natural logarithm. ``impl="poly"``: frexp, a Cody-Waite split of
    e * ln 2 and the Cephes polynomial (float32) or rational (float64)."""
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.log_native(x)
    mant, e = _frexp(x)
    e = e.to(x.dtype)
    small = mant < 0.70710678118654752440  # sqrt(0.5)
    mant = ns.where(small, 2.0 * mant, mant)
    e = ns.where(small, e - 1.0, e)
    m = mant - 1.0
    if _is64(x):
        pp = P.horner(m, list(reversed(_LOG_P_F64)))
        # Q is monic (leading coefficient 1), Cephes p1evl convention.
        qq = P.horner(m, list(reversed(_LOG_Q_F64)) + [1.0])
        z = m * m
        y = m * (z * pp / qq)
        y = y - 0.5 * z
    else:
        z = m * m
        p = P.poly8(m, *reversed(_LOGCOF_F32))
        y = m * z * p
        y = y - 0.5 * z
    # e*ln2 in two parts: the small correction folds into the small
    # accumulator y BEFORE the m+y sum, and the big part (e*0.693359375 is
    # EXACT: 9-bit constant times a small integer) is added last
    y = y + e * (-2.121944400546905827679e-4)
    r = m + y
    r = r + e * 0.693359375
    r = ns.where(x == 0.0, -math.inf, r)
    r = ns.where(x < 0.0, math.nan, r)
    r = ns.where(ns.isinf(x) & (x > 0), math.inf, r)
    # NaN passes every guard above (all comparisons False) while frexp
    # strips its exponent into a finite mantissa
    r = ns.where(x != x, x, r)
    return r


@_bf16_safe
def exp2(x, impl=_NATIVE):
    """2^x. Poly path: n = round(x) splits off exactly, the residue
    |r| <= 0.5 runs through the exp polynomial on r*ln2, then an exact
    ldexp."""
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.exp2_native(x)
    n = ns.floor(x + 0.5)
    r = (x - n) * 0.69314718055994530942
    if _is64(x):
        xx = r * r
        px = r * P.horner(xx, list(reversed(_EXP_P_F64)))
        qx = P.horner(xx, list(reversed(_EXP_Q_F64)))
        y = 1.0 + 2.0 * px / (qx - px)
    else:
        z = P.poly5(r, *reversed(_EXPCOF_F32))
        y = 1.0 + r + r * r * z
    out = _ldexp(y, n)
    hi = 1024.0 if _is64(x) else 128.0
    lo = -1022.0 if _is64(x) else -126.0
    out = ns.where(x >= hi, math.inf, out)
    out = ns.where(x < lo, 0.0, out)
    return out


@_bf16_safe
def log2(x, impl=_NATIVE):
    if impl == _NATIVE:
        ns, x = _prim(x)
        return ns.log2_native(x)
    return log(x, impl) * 1.4426950408889634074


def log1p(x, impl=_NATIVE):
    ns, x = _prim(x)
    return ns.log1p_native(x)


def expm1(x, impl=_NATIVE):
    ns, x = _prim(x)
    return ns.expm1_native(x)


@_bf16_safe
def cbrt(x, impl=_NATIVE):
    """Cube root: exp2(log2|x|/3) + one Newton step (array_math.h cbrt)."""
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.cbrt_native(x)
    a = ns.abs(x)
    y = exp2(log2(ns.maximum(a, torch.finfo(x.dtype).tiny), impl) * (1.0 / 3.0), impl)
    # Newton: y <- y - (y - a/y^2)/3
    y = y - (y - a / (y * y)) * (1.0 / 3.0)
    y = ns.where(a == 0.0, 0.0, y)
    y = ns.where(ns.isinf(a), math.inf, y)
    return _mulsign(y, x)


def pow(x, y, impl=_NATIVE):
    """x**y = exp(log(x)*y) (array_math.h pow)."""
    ns, x, y = _prim2(x, y)
    if impl == _NATIVE:
        return ns.pow_native(x, y)
    return exp(log(x, impl) * y, impl)


# ---------------------------------------------------------------------------
# Hyperbolic (array_math.h:1100-1381)
# ---------------------------------------------------------------------------

_SINHCOF_F32 = (2.03721912945e-4, 8.33028376239e-3, 1.66667160211e-1)


@_bf16_safe
def sinh(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.sinh_native(x)
    a = ns.abs(x)
    big = a > 1.0
    e = exp(a, impl)
    big_v = 0.5 * (e - 1.0 / e)
    z = x * x
    if _is64(x):
        small_v_abs = ns.abs(x + x * z * P.horner(z, P64._SINH64))
    else:
        small_v_abs = ns.abs(x + x * z * P.poly2(z, *reversed(_SINHCOF_F32)))
    r = ns.where(big, big_v, small_v_abs)
    return _mulsign(r, x)


@_bf16_safe
def cosh(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.cosh_native(x)
    e = exp(ns.abs(x), impl)
    return 0.5 * (e + 1.0 / e)


@_bf16_safe
def sincosh(x, impl=_NATIVE):
    """Simultaneous sinh+cosh (array_math.h sincosh)."""
    return sinh(x, impl), cosh(x, impl)


_TANHCOF_F32 = (-5.70498872745e-3, 2.06390887954e-2, -5.37397155531e-2,
                1.33314422036e-1, -3.33332819422e-1)


@_bf16_safe
def tanh(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.tanh_native(x)
    a = ns.abs(x)
    big = a > 0.625
    big_v = 1.0 - 2.0 / (exp(2.0 * a, impl) + 1.0)
    z = x * x
    if _is64(x):
        small_v = ns.abs(x + x * z * P.horner(z, P64._TANH64))
    else:
        small_v = ns.abs(x + x * z * P.poly4(z, *reversed(_TANHCOF_F32)))
    r = ns.where(big, big_v, small_v)
    r = ns.where(a > (20.0 if _is64(x) else 10.0), 1.0, r)
    return _mulsign(r, x)


_ASINHCOF_F32 = (2.0122003309e-2, -4.2699340972e-2, 7.4847586088e-2,
                 -1.6666288134e-1)


@_bf16_safe
def asinh(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.asinh_native(x)
    a = ns.abs(x)
    huge = a > (1e8 if _is64(x) else 1500.0)
    big = (a > 0.5) & ~huge
    z = x * x
    if _is64(x):
        small_v = a + a * z * P.horner(z, P64._ASINH64)
    else:
        small_v = a + a * z * P.poly3(z, *reversed(_ASINHCOF_F32))
    big_v = log(a + ns.sqrt(ns.minimum(z, torch.finfo(x.dtype).max) + 1.0), impl)
    huge_v = log(ns.maximum(a, 1.0), impl) + 0.6931471805599453
    r = ns.where(huge, huge_v, ns.where(big, big_v, small_v))
    return _mulsign(r, x)


_ACOSHCOF_F32 = (1.4142135263e0, -1.1784741703e-1, 2.6454905019e-2,
                 -7.5272886713e-3, 1.7596881071e-3)

# sqrt(float_max), taken in the working precision (np.sqrt of an f32
# scalar computes in f32), as the reference's constants
_SQRT_MAX_F32 = float(np.sqrt(np.float32(np.finfo(np.float32).max)))
_SQRT_MAX_F64 = float(np.sqrt(np.finfo(np.float64).max))


@_bf16_safe
def acosh(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.acosh_native(x)
    z = x - 1.0
    huge = x > (1e8 if _is64(x) else 1500.0)
    small = (z < 0.5) & ~huge
    zs = ns.maximum(z, 0.0)
    if _is64(x):
        # acosh(1+z) = sqrt(2z) * C(z) (own fit)
        small_v = ns.sqrt(2.0 * zs) * P.horner(zs, P64._ACOSH64)
    else:
        small_v = ns.sqrt(zs) * P.horner(zs, list(_ACOSHCOF_F32))
    xc = ns.minimum(x, _SQRT_MAX_F64 if _is64(x) else _SQRT_MAX_F32)
    big_v = log(xc + ns.sqrt(ns.maximum(xc * xc - 1.0, 0.0)), impl)
    huge_v = log(ns.maximum(x, 1.0), impl) + 0.6931471805599453
    r = ns.where(huge, huge_v, ns.where(small, small_v, big_v))
    return ns.where(x < 1.0, math.nan, r)


_ATANHCOF_F32 = (1.81740078349e-1, 8.24370301058e-2, 1.46691431730e-1,
                 1.99782164500e-1, 3.33337300303e-1)


@_bf16_safe
def atanh(x, impl=_NATIVE):
    ns, x = _prim(x)
    if impl == _NATIVE:
        return ns.atanh_native(x)
    a = ns.abs(x)
    big = a >= 0.5
    z = x * x
    if _is64(x):
        small_v = x + x * z * P.horner(z, P64._ATANH64)
    else:
        small_v = x + x * z * P.poly4(z, *reversed(_ATANHCOF_F32))
    big_v = _mulsign(0.5 * log((1.0 + a) / ns.maximum(1.0 - a, torch.finfo(x.dtype).tiny), impl), x)
    r = ns.where(big, big_v, small_v)
    r = ns.where(a >= 1.0, _mulsign(ns.full_like(x, math.inf), x), r)
    r = ns.where(a > 1.0, math.nan, r)
    return r


@_bf16_safe
def csc(x, impl=_NATIVE):
    """Cosecant 1/sin (array_math.h csc)."""
    if impl == _NATIVE:
        ns, x = _prim(x)
        return 1.0 / ns.sin_native(x)
    return 1.0 / sin(x, impl)


@_bf16_safe
def sec(x, impl=_NATIVE):
    """Secant 1/cos (array_math.h sec)."""
    if impl == _NATIVE:
        ns, x = _prim(x)
        return 1.0 / ns.cos_native(x)
    return 1.0 / cos(x, impl)


@_bf16_safe
def csch(x, impl=_NATIVE):
    return 1.0 / sinh(x, impl)


@_bf16_safe
def sech(x, impl=_NATIVE):
    return 1.0 / cosh(x, impl)


@_bf16_safe
def coth(x, impl=_NATIVE):
    return 1.0 / tanh(x, impl)


# ---------------------------------------------------------------------------
# misc (array_math.h:1352-1381)
# ---------------------------------------------------------------------------


def fmod(a, b, impl=_NATIVE):
    ns, a, b = _prim2(a, b)
    return ns.fmod_native(a, b)


def hypot(a, b):
    """Overflow-safe hypot (array_math.h:1364)."""
    ns, a, b = _prim2(a, b)
    a, b = ns.abs(a), ns.abs(b)
    mx = ns.maximum(a, b)
    mn = ns.minimum(a, b)
    t = mn / ns.where(mx == 0.0, 1.0, mx)
    r = ns.where(mx == 0.0, 0.0, mx * ns.sqrt(1.0 + t * t))
    # IEEE: hypot is +inf whenever either argument is infinite (the
    # scaled form computes inf/inf = NaN for hypot(inf, inf))
    return ns.where(ns.isinf(mx), mx, r)
