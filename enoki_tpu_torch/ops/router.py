"""Core ops (counterpart of enoki_tpu/ops/router.py).

The eager subset ported so far: what the renders need (``linspace``,
``meshgrid``, ``safe_sqrt``, ``rsqrt``), and what the histogram and
rounding paths need: ``select`` / ``masked_assign``, ``reinterpret``,
``ldexp`` / ``frexp``, the memory operations ``gather`` / ``scatter`` /
``scatter_add`` / ``transform``, ``isnan`` / ``isinf`` / ``isfinite`` and
``next_float`` / ``prev_float``. Tensors are updated functionally, as in
the reference: ``scatter`` and ``scatter_add`` return a new tensor. The
lazy ``LazyArray`` branch of each function waits for the port of
``trace/``.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..config import config


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


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # sqrt in float64, rounded back once: the correctly rounded sqrt
        # that XLA and CUDA's sqrt give. PyTorch's CPU float32 sqrt goes
        # through MKL's vector library, which is 1 ulp off for ~0.6% of
        # inputs, and that moves silhouette pixels of the sphere render.
        y = torch.sqrt(torch.clamp_min(x, 0.0).double()).to(x.dtype)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        pos = x > 0
        return g * torch.where(pos, 0.5 / torch.where(pos, y, 1.0), 0.0)


def safe_sqrt(x):
    """sqrt(max(x, 0)), correctly rounded, with a zero (not infinite)
    gradient at x <= 0."""
    return _SafeSqrt.apply(x)


def rsqrt(x):
    """Reciprocal square root."""
    return torch.rsqrt(x)


# ---------------------------------------------------------------------------
# Select / masking
# ---------------------------------------------------------------------------


def select(mask, a, b):
    """``select(mask, a, b)``: lanewise mask ? a : b."""
    return torch.where(mask, a, b)


def masked_assign(x, mask, value):
    """Functional form of ``masked(x, m) = v``: returns the new tensor."""
    return torch.where(mask, value, x)


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
# Float classification and neighbours
# ---------------------------------------------------------------------------


def isnan(x):
    return torch.isnan(x)


def isinf(x):
    return torch.isinf(x)


def isfinite(x):
    return torch.isfinite(x)


def next_float(x):
    """Next representable float toward +inf."""
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def prev_float(x):
    """Next representable float toward -inf."""
    return torch.nextafter(x, torch.full_like(x, float("-inf")))
