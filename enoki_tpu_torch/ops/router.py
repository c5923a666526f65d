"""Core ops (counterpart of enoki_tpu/ops/router.py), ported whole.

Every public function of the reference, with its name, argument order
and defaults, as plain PyTorch on tensors. The reference's lazy
``LazyArray`` branch of each function is left out: it waits for the port
of ``trace/``. Tensors are updated functionally, as in the reference:
``scatter`` and ``scatter_add`` return a new tensor.

Dtypes follow the reference with JAX's 64-bit types off: a Python int
becomes int32 and a Python float float32 where the reference calls
``jnp.asarray`` on it, ``arange`` counts in int32, and the sign helpers
promote as ``jnp.promote_types`` does. The width of a bit operation comes
from the dtype; ``torch.uint32`` tensors are accepted and computed through
int64 (PyTorch has no shifts or compares for UInt32), and each result
comes back in the dtype the reference returns. Square roots, and the
reciprocal square roots, come from an IEEE float64 root (``_sqrt64``),
so that the CPU and the card agree. A function that makes a tensor from
Python values alone makes it on the CUDA card, or raises without one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..config import config


# ---------------------------------------------------------------------------
# Operands, dtypes and bit patterns
# ---------------------------------------------------------------------------

_SCALAR_DTYPE = ((bool, torch.bool), (int, torch.int32),
                 (float, torch.float32), (complex, torch.complex64))


def _asarray(v, device=None):
    """``v`` as a tensor, as ``jnp.asarray`` makes it: a tensor stays as
    it is; a Python scalar or list takes int32 / float32 on ``device``,
    which None resolves to the CUDA card, or raises (``resolve_device``)."""
    if isinstance(v, torch.Tensor):
        return v
    device = resolve_device(device)
    for kind, dtype in _SCALAR_DTYPE:
        if isinstance(v, kind):
            return torch.tensor(v, dtype=dtype, device=device)
    t = torch.as_tensor(v, device=device)
    if isinstance(v, (list, tuple)):
        t = t.to({torch.int64: torch.int32,
                  torch.float64: torch.float32}.get(t.dtype, t.dtype))
    return t


def _operands(*vs):
    """Every operand as a tensor on the device of the first tensor, or
    on the card when none is a tensor."""
    like = next((v.device for v in vs if isinstance(v, torch.Tensor)), None)
    return tuple(_asarray(v, like) for v in vs)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _signed_view(x):
    """uint16 and uint32 viewed as the signed dtype of their width, for
    which PyTorch has the operations; any other x as it is."""
    return x.view(_SIGNED_VIEW.get(x.dtype, x.dtype))


def _on_bits(fn, x):
    """``fn(x)`` for a function that moves elements and computes nothing
    on them, or wraps around as two's complement does: uint16 and uint32
    go through ``_signed_view`` and come back."""
    return fn(_signed_view(x)).view(x.dtype)


def _width(dtype):
    """(bits, signed) of an integer dtype of at most 32 bits, or int64."""
    if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
        raise TypeError(f"bit operation on {dtype}: needs an integer dtype")
    if dtype == torch.uint64:
        raise TypeError("bit operations on uint64 are not supported "
                        "(PyTorch has almost no uint64 operations)")
    info = torch.iinfo(dtype)
    return info.bits, info.min < 0


def _bits(x):
    """The bit pattern of integer ``x`` as int64: in [0, 2**w) for a
    w <= 32 bit dtype, and x itself for int64."""
    w, _ = _width(x.dtype)
    v = x.to(torch.int64)
    return v if w == 64 else v & ((1 << w) - 1)


def _from_bits(v, dtype):
    """The int64 ``v``, taken modulo 2**w, as the w-bit ``dtype``."""
    w, signed = _width(dtype)
    if w == 64:
        return v
    v = v & ((1 << w) - 1)
    if signed:
        v = v - ((v >> (w - 1)) << w)
    return v.to(dtype)


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _is_negative(x):
    if x.dtype in _UNSIGNED:
        return torch.zeros_like(x, dtype=torch.bool)
    return x < 0


def _negate(x):
    """-x, wrapping for an unsigned dtype as the reference's does."""
    return _from_bits(-_bits(x), x.dtype) if x.dtype in _UNSIGNED else -x


def _to_float(x):
    """x, or x as float32 where it holds integers (``result_type(x,
    1.0)`` with 64-bit types off)."""
    return x if x.dtype.is_floating_point else x.to(torch.float32)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def zeros(shape, dtype=torch.float32, device=None):
    """``zero<Array>(size)``."""
    return torch.zeros(_shape(shape), dtype=dtype,
                       device=resolve_device(device))


def full(shape, value, dtype=None, device=None):
    """``full<Array>(value, size)``. Without ``dtype``, a Python bool
    fills bool, an int int32 and a float float32, as in the reference; a
    tensor value keeps its dtype and is broadcast."""
    device = resolve_device(device)
    if dtype is not None and not isinstance(value, torch.Tensor):
        return torch.full(_shape(shape), value, dtype=dtype, device=device)
    value = _asarray(value, device)
    dtype = value.dtype if dtype is None else dtype
    return torch.broadcast_to(value.to(device=device, dtype=dtype),
                              _shape(shape)).clone()


def empty(shape, dtype=torch.float32, device=None):
    """Defined contents, as in the reference (which has no uninitialised
    memory): NaN for floating dtypes, 0 for the rest. Not
    ``torch.empty``."""
    fill = float("nan") if dtype.is_floating_point else 0
    return torch.full(_shape(shape), fill, dtype=dtype,
                      device=resolve_device(device))


def arange(n, dtype=torch.int32, device=None):
    """``arange<Array>(n)``: int32 by default, as in the reference."""
    return torch.arange(n, dtype=torch.int64,
                        device=resolve_device(device)).to(dtype)


def linspace(start, stop, num, dtype=torch.float32, device=None):
    """``linspace<Array>(min, max, size)``: endpoints inclusive.

    jnp.linspace's formula, ``start*(1 - i/div) + stop*(i/div)`` with the
    last entry set to ``stop``, in the form XLA compiles it to: the
    division by the constant ``div`` becomes a product with ``r = 1/div``,
    and ``stop*(i/div)`` becomes ``i*(stop*r)``. Written literally the
    formula lands up to 2 ulp (of ``stop``) from the reference at n=64,
    this form within 1; ``torch.linspace`` rounds differently again
    (hundreds of entries at n=1024).
    """
    device = resolve_device(device)
    start_t = torch.tensor(start, dtype=dtype, device=device)
    stop_t = torch.tensor(stop, dtype=dtype, device=device)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    r = 1 / torch.tensor(div, dtype=dtype, device=device)
    i = torch.arange(div, dtype=dtype, device=device)
    out = start_t * (1 - i * r) + i * (stop_t * r)
    return torch.cat([out, stop_t.reshape(1)])


def meshgrid(x, y):
    """``meshgrid(x, y)`` with 'xy' indexing, flattened: x varies fastest.
    Returns ``(xs, ys)`` of length ``len(x) * len(y)``."""
    xs, ys = torch.meshgrid(x, y, indexing="xy")
    return xs.reshape(-1), ys.reshape(-1)


# ---------------------------------------------------------------------------
# Select / masking
# ---------------------------------------------------------------------------


def select(mask, a, b):
    """``select(mask, a, b)``: lanewise mask ? a : b."""
    return torch.where(mask, a, b)


def masked_assign(x, mask, value):
    """Functional form of ``masked(x, m) = v``: returns the new tensor."""
    return torch.where(mask, value, x)


# ---------------------------------------------------------------------------
# Fused arithmetic: the reference computes a*b+c with two roundings, and
# so does the port (no torch.addcmul).
# ---------------------------------------------------------------------------


def fmadd(a, b, c):
    return a * b + c


def fmsub(a, b, c):
    return a * b - c


def fnmadd(a, b, c):
    return c - a * b


def fnmsub(a, b, c):
    return -(a * b) - c


def _odd_lanes(a, b, c):
    """Boolean odd-lane mask over the last axis of the broadcast shape; a
    0-d broadcast has a single (even) lane, so the result has shape (1,),
    as the reference's has."""
    shape = torch.broadcast_shapes(*(tuple(v.shape) for v in (a, b, c)
                                     if isinstance(v, torch.Tensor)))
    n = shape[-1] if shape else 1
    like = next((v for v in (a, b, c) if isinstance(v, torch.Tensor)), None)
    device = resolve_device(like.device if like is not None else None)
    return torch.arange(n, device=device) % 2 == 1


def fmaddsub(a, b, c):
    """Even lanes a*b-c, odd lanes a*b+c."""
    return torch.where(_odd_lanes(a, b, c), a * b + c, a * b - c)


def fmsubadd(a, b, c):
    """Even lanes a*b+c, odd lanes a*b-c."""
    return torch.where(_odd_lanes(a, b, c), a * b - c, a * b + c)


# ---------------------------------------------------------------------------
# Reciprocal and reciprocal square root
# ---------------------------------------------------------------------------


def rcp(x):
    """Reciprocal, ``1.0 / x``."""
    return 1.0 / x


def rsqrt(x):
    """Reciprocal square root."""
    return torch.rsqrt(x)


def _elementwise_vmap(fn):
    """The ``vmap`` rule of an elementwise Function: the op applied to the
    batched tensor as it is, its batch dimension kept."""
    def rule(info, in_dims, x, *rest):
        return fn(x, *rest), in_dims[0]
    return staticmethod(rule)


class _NumpySqrt(torch.autograd.Function):
    """numpy's float64 sqrt of a float64 CPU tensor, which is IEEE
    (PyTorch's CPU float64 sqrt is up to 1 ulp off); sqrt's gradient."""

    @staticmethod
    def forward(x):
        with np.errstate(invalid="ignore"):  # NaN below 0, as torch's
            return torch.as_tensor(np.sqrt(x.detach().numpy()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * 0.5 / y

    @staticmethod
    def jvp(ctx, t):
        (y,) = ctx.saved_tensors
        return t * 0.5 / y

    vmap = _elementwise_vmap(lambda x: _NumpySqrt.apply(x))


def _sqrt64(x):
    """sqrt(x) in float64, correctly rounded on every device: the card's
    float64 sqrt is IEEE, the CPU's goes through numpy. Rounded once to a
    16- or 32-bit float dtype it is that dtype's correctly rounded root."""
    xd = x.double()
    return _NumpySqrt.apply(xd) if xd.device.type == "cpu" else torch.sqrt(xd)


def _sqrt_rn(x):
    """sqrt(x), correctly rounded, in x's float dtype."""
    return _sqrt64(x).to(x.dtype)


def _rsqrt_rn(x):
    """1/sqrt(x) in float64 rounded once to x's dtype: the same bits on
    the CPU and the card."""
    return (1.0 / _sqrt64(x)).to(x.dtype)


def _plain_root(native, rn):
    """The root of the render paths' plain versions: ``rn``, correctly
    rounded, on the CPU, whose ``torch.sqrt`` / ``torch.rsqrt`` round
    differently from one host to another; PyTorch's own ``native`` on the
    card, to which the kernels' ``sqrt_pos_`` / ``rsqrt_pos_`` are held bit
    for bit."""
    def root(x):
        return rn(x) if x.device.type == "cpu" else native(x)
    return root


_plain_sqrt = _plain_root(torch.sqrt, _sqrt_rn)
_plain_rsqrt = _plain_root(torch.rsqrt, _rsqrt_rn)


# ---------------------------------------------------------------------------
# Bit manipulation. Each works on the bit pattern (``_bits``) and gives
# the input's dtype back, as the reference's lax ops do; 64-bit values
# are taken as two 32-bit halves.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _popcnt32(v):
    """Set bits of each int64 in [0, 2**32): the SWAR count."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _clz32(v):
    """Leading zeros of each int64 in [0, 2**32), as a 32-bit word: five
    halving steps, each shifting the word up where its top half is 0."""
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        small = v < (1 << (32 - s))
        n = n + small * s
        v = torch.where(small, v << s, v)
    return n + (v == 0)


def _clz(v, w):
    if w == 64:
        hi, lo = (v >> 32) & _M32, v & _M32
        return torch.where(hi != 0, _clz32(hi), 32 + _clz32(lo))
    return _clz32(v) - (32 - w)


def popcnt(x):
    """Set bits of each element, in x's dtype."""
    x = _asarray(x)
    w, _ = _width(x.dtype)
    v = _bits(x)
    n = (_popcnt32(v & _M32) + _popcnt32((v >> 32) & _M32) if w == 64
         else _popcnt32(v))
    return _from_bits(n, x.dtype)


def lzcnt(x):
    """Leading zero bits of each element at x's width, in x's dtype."""
    x = _asarray(x)
    w, _ = _width(x.dtype)
    return _from_bits(_clz(_bits(x), w), x.dtype)


def tzcnt(x):
    """Trailing zero bits: w - 1 - lzcnt(x & -x), and w for x == 0."""
    x = _asarray(x)
    w, _ = _width(x.dtype)
    v = _bits(x)
    n = torch.where(v == 0, w, w - 1 - _clz(v & -v, w))
    return _from_bits(n, x.dtype)


def log2i(x):
    """Integer log2: the position of the highest set bit, w - 1 -
    lzcnt(x); -1 in x's dtype (all bits set) for x == 0."""
    x = _asarray(x)
    w, _ = _width(x.dtype)
    return _from_bits((w - 1) - _clz(_bits(x), w), x.dtype)


def mulhi(a, b):
    """High 32 bits of the 64-bit product: uint32 for unsigned inputs,
    int32 for signed ones (each taken at 32 bits with its sign), as in
    the reference; 64-bit inputs raise."""
    a, b = _operands(a, b)
    b = b.to(a.dtype)
    w, signed = _width(a.dtype)
    if w == 64:
        raise NotImplementedError("64-bit mulhi: use types.u64 module")
    if signed:
        # |a|, |b| <= 2**31: the product fits in int64
        return ((a.to(torch.int64) * b.to(torch.int64)) >> 32).to(
            torch.int32)
    # (a*b) >> 32 as ((a_hi*b) + ((a_lo*b) >> 16)) >> 16 with 16-bit halves
    # of a: every term stays below 2**49
    ua, ub = _bits(a), _bits(b)
    hi = ((ua >> 16) * ub + (((ua & 0xFFFF) * ub) >> 16)) >> 16
    return hi.to(torch.uint32)


def _shr(v, k, w, signed):
    """v >> k on a w-bit pattern: arithmetic for a signed dtype, as the
    reference's ``>>`` is, logical for an unsigned one."""
    if w == 64:
        return v >> k
    if signed:
        v = v - ((v >> (w - 1)) << w)
    return (v >> k) & ((1 << w) - 1)


def _rotate(x, k, right):
    x, k = _operands(x, k)
    w, signed = _width(x.dtype)
    k = k.to(torch.int64) & (w - 1)
    back = (w - k) & (w - 1)
    v = _bits(x)
    if right:
        out = _shr(v, k, w, signed) | (v << back)
    else:
        out = (v << k) | _shr(v, back, w, signed)
    return _from_bits(out, x.dtype)


def ror(x, k):
    """Rotate right: ``(x >> k) | (x << (w - k))`` at x's width. As in the
    reference, ``>>`` is arithmetic on a signed dtype, so a negative
    signed x does not rotate: ror(int32(-2), 1) == -1."""
    return _rotate(x, k, True)


def rol(x, k):
    """Rotate left: ``(x << k) | (x >> (w - k))``, with ``ror``'s
    arithmetic shift on a signed dtype."""
    return _rotate(x, k, False)


def reinterpret(x, dtype):
    """Bit-level reinterpret cast to a dtype of the same width."""
    return x.view(dtype)


# ---------------------------------------------------------------------------
# ldexp / frexp
# ---------------------------------------------------------------------------


def _float_layout(x):
    """(x as f32 or f64, mantissa bits, integer dtype, exponent mask,
    bias): everything but float64 is taken in float32."""
    if x.dtype == torch.float64:
        return x, 52, torch.int64, 0x7FF, 1023
    return x.to(torch.float32), 23, torch.int32, 0xFF, 127


def ldexp(x, e):
    """x * 2^e via direct exponent-field arithmetic (finite x, moderate
    e). Zero inputs stay zero, inf/NaN propagate unchanged."""
    x, mbits, itype, _, _ = _float_layout(x)
    if not isinstance(e, torch.Tensor):
        e = torch.as_tensor(e, device=x.device)
    bits = x.view(itype)
    scaled = (bits + (e.to(itype) << mbits)).view(x.dtype)
    return torch.where((x == 0) | ~torch.isfinite(x), x, scaled)


def frexp(x):
    """Split into (mantissa in [0.5, 1), exponent) as std::frexp, so that
    x == mantissa * 2**exponent; (0, 0) for x == 0. The exponent has the
    integer dtype of x's width."""
    x, mbits, itype, emask, bias = _float_layout(x)
    bits = x.view(itype)
    exp = ((bits >> mbits) & emask) - (bias - 1)
    mant_bits = (bits & ~(emask << mbits)) | ((bias - 1) << mbits)
    mant = mant_bits.view(x.dtype)
    zero = x == 0
    return torch.where(zero, 0.0, mant), torch.where(zero, 0, exp)


# ---------------------------------------------------------------------------
# Gather / scatter / transform
# ---------------------------------------------------------------------------


def _bcast_mask(mask, like):
    while mask.ndim < like.ndim:
        mask = mask[..., None]
    return mask


def gather(source, index, mask=None, fill=0):
    """``gather(source, index, mask)`` along the first axis. Masked-off
    lanes produce ``fill``; out-of-range indices clamp, and masked lanes
    are forced in range first so the clamp cannot hide a real one under a
    valid mask."""
    if mask is not None:
        index = torch.where(mask, index, 0)
    out = source[index.long().clamp(0, source.shape[0] - 1)]
    if mask is not None:
        out = torch.where(_bcast_mask(mask, out), out, fill)
    return out


def _dropped_slot(index, n, mask):
    """``index`` (as int64) with every lane that must not write sent to
    slot ``n``, one past the target: masked-off lanes, negative indices
    (they never wrap around) and, under a mask or ``config.debug_bounds``,
    indices >= n. Without either an index >= n is undefined, as in the
    reference: PyTorch raises on the CPU and trips a device-side assert
    on a CUDA card."""
    index = index.long()
    drop = index < 0
    if mask is not None:
        drop = drop | ~mask
    if mask is not None or config.debug_bounds:
        drop = drop | (index >= n)
    return torch.where(drop, n, index)


def _padded(target):
    """``target`` with one more slot along the first axis, which takes
    the dropped lanes' writes."""
    return torch.cat([target, target.new_zeros((1,) + target.shape[1:])])


def _lanes(target, value, index):
    """Flat int64 index and the value of each lane, broadcast to
    ``index.shape + target.shape[1:]`` in the target's dtype."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value, device=target.device)
    value = torch.broadcast_to(value.to(target.dtype),
                               index.shape + target.shape[1:])
    return index.reshape(-1), value.reshape((-1,) + target.shape[1:])


def scatter(target, value, index, mask=None):
    """``scatter(target, value, index, mask)``: a new tensor with
    ``value`` written at ``index`` along the first axis. Which of two
    lanes with the same index wins is not defined (nor is it in the
    reference). Lanes that ``_dropped_slot`` names write nothing."""
    n = target.shape[0]
    index, value = _lanes(target, value, _dropped_slot(index, n, mask))
    return _padded(target).index_put_((index,), value)[:n]


def scatter_add(target, value, index, mask=None):
    """``scatter_add``: a new tensor with ``value`` added at ``index``
    along the first axis, conflicts summed. Lanes that ``_dropped_slot``
    names add nothing.

    One route for every shape: ``index_add_`` into the target padded by
    the dropped slot. The reference's dense equality-reduction for small
    targets is a workaround for its compiler's serial scatter and relies
    on the (N, bins) compare never being materialised; eager PyTorch would
    materialise it. On a CUDA card ``index_add_`` of floats uses atomic
    adds, whose order changes from run to run: a float result may differ
    in the last bits between two runs. ``ops.histogram`` is the
    reproducible route for a small dense target."""
    n = target.shape[0]
    index, value = _lanes(target, value, _dropped_slot(index, n, mask))
    return _padded(target).index_add_(0, index, value)[:n]


def transform(target, index, func, *args, mask=None):
    """Read-modify-write scatter: ``func`` maps (current_value, *args) to
    the new value. Duplicate indices are resolved as ``scatter`` resolves
    them."""
    current = gather(target, index, mask=mask)
    return scatter(target, func(current, *args), index, mask=mask)


# ---------------------------------------------------------------------------
# Range and sign helpers
# ---------------------------------------------------------------------------


def _maximum(a, b):
    """``jnp.maximum`` of two tensors: NaN where either is NaN, and +0.0
    above -0.0. Which of two equal operands ``torch.maximum`` gives
    depends on the size (the CPU's vector loop gives the second, its
    scalar tail the first), so equal operands take the one without the
    sign bit."""
    r = torch.maximum(a, b)
    if not r.dtype.is_floating_point:
        return r
    return torch.where(a == b, torch.where(torch.signbit(a), b, a), r)


def _minimum(a, b):
    """``jnp.minimum`` of two tensors: NaN where either is NaN, and -0.0
    below +0.0 (equal operands take the one with the sign bit)."""
    r = torch.minimum(a, b)
    if not r.dtype.is_floating_point:
        return r
    return torch.where(a == b, torch.where(torch.signbit(a), a, b), r)


def clamp(x, lo, hi):
    """``minimum(maximum(x, lo), hi)``, as ``jnp.clip``: a float bound
    promotes an integer x to float32, NaN in x stays NaN, -0.0 clamped at
    0 becomes +0.0 (``torch.clamp`` keeps -0.0), and lo > hi gives hi. A
    Python bound is a 0-d tensor, which does not widen x's float
    dtype."""
    lo, hi = (torch.as_tensor(v, device=x.device) for v in (lo, hi))
    return _minimum(_maximum(x, lo), hi)


def lerp(a, b, t):
    """``t*b + (a - t*a)``, the reference's expression, exact at both
    endpoints (not ``torch.lerp``)."""
    return t * b + (a - t * a)


def sign(x):
    """copysign(1, x): sign(+-0) is +-1 and sign(+-NaN) is +-1, unlike
    ``torch.sign``; an integer x gives -1 or 1 in its dtype."""
    x = _asarray(x)
    one = torch.ones_like(x)
    if x.dtype.is_floating_point:
        return torch.copysign(one, x)
    return torch.where(_is_negative(x), _negate(one), one)


def copysign(a, b):
    """|a| with the sign bit of b, in the promoted float dtype (integers
    promote to float32, as in the reference)."""
    a, b = _operands(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        dt = torch.promote_types(dt, torch.float32)
    return torch.copysign(a.to(dt), b.to(dt))


def mulsign(a, b):
    """a with its sign bit flipped where b's sign bit is set (a * sign(b)
    for floats, -0.0 included). For integers, -a where b < 0, in the
    promoted integer dtype, as in the reference."""
    a, b = _operands(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        return torch.where(_is_negative(b), _negate(a), a).to(dt)
    a, b = a.to(dt), b.to(dt)
    return torch.where(torch.signbit(b), -a, a)


def cross(a, b, axis=-1):
    """3-D cross product along ``axis``, component by component as
    ``jnp.cross`` computes it; Vec3-style component structs go to
    ``render.vec.cross3``."""
    if hasattr(a, "x") and hasattr(a, "z"):
        from ..render.vec import cross3

        return cross3(a, b)
    a, b = torch.broadcast_tensors(*_operands(a, b))
    a0, a1, a2 = a.unbind(axis)
    b0, b1, b2 = b.unbind(axis)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=axis)


def copysign_neg(a, b):
    """copysign(a, -b)."""
    a, b = _operands(a, b)
    return copysign(a, _negate(b))


def mulsign_neg(a, b):
    """mulsign(a, -b)."""
    a, b = _operands(a, b)
    return mulsign(a, _negate(b))


def abs_(x):
    """|x|; an unsigned x is its own magnitude."""
    x = _asarray(x)
    return x if x.dtype in _UNSIGNED else torch.abs(x)


def sqr(x):
    return x * x


# ---------------------------------------------------------------------------
# Float classification, predicates and neighbours
# ---------------------------------------------------------------------------


def isnan(x):
    return torch.isnan(x)


def isinf(x):
    return torch.isinf(x)


def isfinite(x):
    return torch.isfinite(x)


def isdenormal(x):
    """True where x is a nonzero subnormal: 0 < |x| < finfo.tiny. The
    IEEE answer: PyTorch and the card keep subnormals, while the
    reference on XLA's CPU backend flushes f32 subnormals and answers
    False there."""
    x = _asarray(x)
    a = torch.abs(x)
    return (a < torch.finfo(x.dtype).tiny) & (a > 0)


def allclose(a, b, rtol=None, atol=None, equal_nan=False):
    """A Python bool: ``|a - b| <= atol + rtol*|b|`` everywhere, in the
    promoted dtype (integers compare as float32). The defaults depend on
    it, as in the reference: 1e-5 / 1e-8 for float64, 1e-3 / 1e-5
    otherwise."""
    a, b = _operands(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    if rtol is None:
        rtol = 1e-5 if dt == torch.float64 else 1e-3
    if atol is None:
        atol = 1e-8 if dt == torch.float64 else 1e-5
    dt = dt if dt.is_floating_point else torch.float32
    a, b = torch.broadcast_tensors(a.to(dt), b.to(dt))
    return bool(torch.isclose(a, b, rtol=rtol, atol=atol,
                              equal_nan=equal_nan).all())


def next_float(x):
    """Next representable float toward +inf."""
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def prev_float(x):
    """Next representable float toward -inf."""
    return torch.nextafter(x, torch.full_like(x, float("-inf")))


# ---------------------------------------------------------------------------
# Safe math: the domain is clamped so that neither the value nor the
# derivative is inf or NaN. Each is the reference's custom JVP: ``jvp``
# multiplies the tangent by the derivative, ``backward`` the cotangent, so
# both are linear in what they are given; ``vmap`` applies the op to the
# batched tensor (they are elementwise), so that torch.func's vmap, jvp
# and grad all go through them.
# ---------------------------------------------------------------------------


def _save_both(ctx, *tensors):
    ctx.save_for_backward(*tensors)
    ctx.save_for_forward(*tensors)


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(x):
        # the correctly rounded sqrt that XLA and CUDA's sqrt give.
        # PyTorch's CPU float32 sqrt goes through MKL's vector library,
        # which is 1 ulp off for ~0.6% of inputs, and that moves
        # silhouette pixels of the sphere render.
        return _sqrt_rn(torch.clamp_min(x, 0.0))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save_both(ctx, inputs[0], output)

    @staticmethod
    def _d(x, y):
        pos = x > 0
        return torch.where(pos, 0.5 / torch.where(pos, y, 1.0), 0.0)

    @staticmethod
    def backward(ctx, g):
        return g * _SafeSqrt._d(*ctx.saved_tensors)

    @staticmethod
    def jvp(ctx, t):
        return t * _SafeSqrt._d(*ctx.saved_tensors)

    vmap = _elementwise_vmap(lambda x: _SafeSqrt.apply(x))


def safe_sqrt(x):
    """sqrt(max(x, 0)), correctly rounded, with a zero (not infinite)
    gradient at x <= 0."""
    return _SafeSqrt.apply(x)


class _SafeRsqrt(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _rsqrt_rn(torch.clamp_min(x, torch.finfo(x.dtype).tiny))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save_both(ctx, inputs[0], output)

    @staticmethod
    def _d(x, y):
        return torch.where(x > 0, -0.5 * y * y * y, 0.0)

    @staticmethod
    def backward(ctx, g):
        return g * _SafeRsqrt._d(*ctx.saved_tensors)

    @staticmethod
    def jvp(ctx, t):
        return t * _SafeRsqrt._d(*ctx.saved_tensors)

    vmap = _elementwise_vmap(lambda x: _SafeRsqrt.apply(x))


def safe_rsqrt(x):
    """rsqrt(max(x, finfo.tiny)) of x's float dtype: finite everywhere,
    with a zero gradient at x <= 0. The root is ``_rsqrt_rn``'s."""
    return _SafeRsqrt.apply(_to_float(_asarray(x)))


class _SafeArc(torch.autograd.Function):
    """asin or acos of clamp(x, -1, 1), taken in float64 and rounded
    once (the card and the CPU may differ in the float64 libm's last
    bit, and so, rarely, by one ulp); the derivative is
    +-rsqrt(max(1 - x*x, 1e-30)) where |x| < 1 and 0 outside, the root
    ``_rsqrt_rn``'s."""

    @staticmethod
    def forward(x, fn, sign):
        return fn(torch.clamp(x, -1.0, 1.0).double()).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sign = inputs[2]
        _save_both(ctx, inputs[0])

    @staticmethod
    def _d(ctx):
        (x,) = ctx.saved_tensors
        d = _rsqrt_rn(torch.clamp_min(1.0 - x * x, 1e-30))
        d = -d if ctx.sign < 0 else d
        return torch.where(torch.abs(x) < 1.0, d, 0.0)

    @staticmethod
    def backward(ctx, g):
        return g * _SafeArc._d(ctx), None, None

    @staticmethod
    def jvp(ctx, t, _fn, _sign):
        return t * _SafeArc._d(ctx)

    vmap = _elementwise_vmap(lambda x, fn, sign: _SafeArc.apply(x, fn, sign))


def safe_asin(x):
    """asin(clamp(x, -1, 1)), with a zero gradient outside (-1, 1)."""
    return _SafeArc.apply(_to_float(_asarray(x)), torch.asin, 1)


def safe_acos(x):
    """acos(clamp(x, -1, 1)), with a zero gradient outside (-1, 1)."""
    return _SafeArc.apply(_to_float(_asarray(x)), torch.acos, -1)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def tile(x, count):
    """``tile(x, n)``: the whole array n times, as ``jnp.tile``."""
    return torch.tile(x, (count,) if isinstance(count, int) else count)


def repeat(x, count):
    """``repeat(x, n)``: each element n times, flattened, as
    ``jnp.repeat``."""
    return torch.repeat_interleave(x, count)


def reverse(x):
    """The order of the last axis reversed; a 0-d x as it is."""
    x = _asarray(x)
    return _on_bits(lambda v: v.flip(-1), x) if x.ndim else x


def head(x, n):
    return x[:n]


def tail(x, n):
    return x[-n:]


def concat(*arrays):
    """The arrays joined along the first axis."""
    return torch.cat(_operands(*arrays), dim=0)


def deg_to_rad(x):
    return x * (math.pi / 180.0)


def rad_to_deg(x):
    return x * (180.0 / math.pi)


def range_packets(n, width, dim=1, device=None):
    """Packets ``(index, mask)`` of ``width`` int32 lanes covering
    [0, n), the last one masked at its tail: the packet loop ``for (auto
    [i, m] : range<UInt32P>(n))``. ``dim=2``: ``n`` is (nx, ny) and the
    index is ``(ix, iy)`` with x varying fastest. The packets are on
    ``device``."""
    lane = torch.arange(width, dtype=torch.int32,
                        device=resolve_device(device))
    if dim == 1:
        total = int(n)
        for start in range(0, total, width):  # empty range: no packets
            idx = lane + start
            yield idx, idx < total
        return
    if dim != 2:
        raise ValueError("range_packets supports dim 1 or 2")
    nx, ny = int(n[0]), int(n[1])
    total = nx * ny
    for start in range(0, total, width):
        flat = lane + start
        yield (flat % nx, flat // nx), flat < total


def extract(value, mask):
    """``value`` at the first set lane of ``mask`` (flattened), as a
    size-1 tensor; element 0 when no lane is set. An index past the first
    axis clamps, as the reference's indexing does. No host sync."""
    value, mask = _operands(value, mask)
    first = torch.argmax(mask.reshape(-1).to(torch.int32))
    return value[first.clamp(max=value.shape[0] - 1)][None]


def prefetch(source, index, mask=None):
    """Memory-prefetch hint: a no-op, as in the reference (the card's
    caches are not steered from here)."""
    return None


def binary_search(start, end, pred, device=None):
    """Per lane, the first index in [start, end) where ``pred`` turns
    False (``pred`` monotone: True...True False...False), in a fixed
    floor(log2(end - start)) + 1 trips. ``pred`` receives int32 index
    tensors on ``device`` (None: the CUDA card, or raise), a 0-d one on
    the first trip, as start and end are host ints. The result is int32
    on ``device``: ``start`` for end <= start."""
    device = resolve_device(device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    start, end = int(start), int(end)
    iters = math.floor(math.log2(end - start)) + 1 if end > start else 0
    if not iters:
        return i32(start)
    mid0 = (start + end) >> 1
    cond = pred(i32(mid0))
    lo = torch.where(cond, i32(min(mid0 + 1, end)), i32(start))
    hi = torch.where(cond, i32(end), i32(mid0))
    for _ in range(iters - 1):
        mid = (lo + hi) >> 1
        cond = pred(mid)
        lo = torch.where(cond, torch.minimum(mid + 1, hi), lo)
        hi = torch.where(cond, hi, mid)
    return lo + torch.zeros_like(hi)


def sqrt(x):
    """Square root, correctly rounded (``_sqrt_rn``), as ``safe_sqrt``
    is: PyTorch's CPU float32 sqrt is 1 ulp off on about 0.6% of inputs.
    Integers give float32."""
    return _sqrt_rn(_to_float(_asarray(x)))
