"""Horizontal (cross-lane) operations (counterpart of
enoki_tpu/ops/horiz.py), ported whole.

Reductions, prefix sums, mask reductions, the dot-product family and the
two static-shape packers: ``compress`` returns ``(packed, count)`` with
the selected lanes first and ``fill`` after them, and ``partition``
stable-sorts lanes by an instance key. The reference's lazy
``LazyArray`` branch of each function is left out: it waits for the port
of ``trace/``.

Dtypes are the reference's, where PyTorch's differ: a sum, product or
prefix sum of bool, int8, int16 or int32 is int32 (PyTorch gives int64),
of an unsigned dtype uint32 (a prefix sum keeps an integer dtype other
than bool), and counts and offsets are int32. ``hmean`` of integers is
float32. float16 and bfloat16 are summed in float32 and rounded once, as
the reference upcasts them.
"""

from __future__ import annotations

import torch

from .router import (_UNSIGNED, _asarray, _on_bits, _operands, _rsqrt_rn,
                     _signed_view, abs_, sqrt)

_HALF = (torch.float16, torch.bfloat16)
_SMALL_SIGNED = (torch.bool, torch.int8, torch.int16, torch.int32)


def _accumulate(x, reduce, dtype):
    """``reduce(x, dtype)`` in the reference's accumulator: int32 or
    uint32 (taken through int32, whose wrap-around has uint32's bits) for
    the integers and bool, float32 for the 16-bit floats; the result in
    ``dtype``."""
    if x.dtype in _HALF:
        return reduce(x, torch.float32).to(dtype)
    if dtype == torch.uint32:
        v = x.view(torch.int32) if x.dtype == dtype else x.to(torch.int32)
        return reduce(v, torch.int32).view(dtype)
    return reduce(x, dtype)


def _sum_dtype(dtype):
    if dtype in _SMALL_SIGNED:
        return torch.int32
    if dtype in _UNSIGNED:
        return torch.uint32
    return dtype


def _dims(axis):
    return {} if axis is None else {"dim": axis}


def _sum(x, axis=None, keepdim=False):
    x = _asarray(x)
    kw = _dims(axis)
    if keepdim:
        kw["keepdim"] = True
    return _accumulate(x, lambda v, dt: torch.sum(v, dtype=dt, **kw),
                       _sum_dtype(x.dtype))


def _prod(x, axis=None):
    """torch.prod takes one axis (or all), not a tuple."""
    x = _asarray(x)
    dims = () if axis is None else (axis,)
    return _accumulate(x, lambda v, dt: torch.prod(v, *dims, dtype=dt),
                       _sum_dtype(x.dtype))


def _extreme(fn, x, axis):
    """amax / amin in x's dtype; uint16 and uint32, for which PyTorch has
    none, through int64. A float extreme of 0 takes the sign that
    ``jnp.max`` / ``jnp.min`` give it: +0.0 for a maximum where any lane
    there is +0.0, -0.0 for a minimum where any lane there is -0.0
    (PyTorch returns either zero). NaN propagates as it does, and the
    gradient is amax's / amin's, shared among the tied lanes."""
    x = _asarray(x)
    dim = () if axis is None else axis
    if x.dtype in (torch.uint16, torch.uint32):
        return fn(x.to(torch.int64), dim=dim).to(x.dtype)
    r = fn(x, dim=dim)
    if not x.dtype.is_floating_point:
        return r
    neg = torch.signbit(x)
    want_neg = fn is torch.amin
    # the zero lanes of the wanted sign, reduced as r was
    found = torch.amax(((x == 0) & (neg if want_neg else ~neg))
                       .to(torch.uint8), dim=dim).to(torch.bool)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    signed = torch.where(found == want_neg, -zero, zero)
    # r.detach() - r is +0.0 at a zero and carries r's gradient;
    # subtracting +0.0 keeps the sign of ``signed``
    return torch.where(r == 0, signed - (r.detach() - r), r)


def _cumsum(x, axis):
    """Inclusive prefix sum along ``axis`` in the reference's dtype: bool
    counts in int32, every other dtype keeps its own (wrapping)."""
    if x.dtype == torch.bool:
        return torch.cumsum(x, axis, dtype=torch.int32)
    if x.dtype in _HALF:
        return torch.cumsum(x, axis, dtype=torch.float32).to(x.dtype)
    return _on_bits(lambda v: torch.cumsum(v, axis, dtype=v.dtype), x)


def _truth(mask):
    mask = _asarray(mask)
    return mask if mask.dtype == torch.bool else mask.to(torch.bool)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


def hsum(x, axis=None):
    """Sum over ``axis`` (all axes by default)."""
    return _sum(x, axis)


def hprod(x, axis=None):
    return _prod(x, axis)


def hmax(x, axis=None):
    return _extreme(torch.amax, x, axis)


def hmin(x, axis=None):
    return _extreme(torch.amin, x, axis)


def hmean(x, axis=None):
    """Mean over ``axis``; integers and bool promote to float32 and the
    16-bit floats are averaged in float32, as ``jnp.mean`` does."""
    x = _asarray(x)
    out = x.dtype if x.dtype.is_floating_point else torch.float32
    acc = torch.float64 if out == torch.float64 else torch.float32
    return torch.mean(x.to(acc), **_dims(axis)).to(out)


def hsum_nested(x):
    """Reduce across *all* axes."""
    return _sum(x)


def hprod_nested(x):
    return _prod(x)


def hmax_nested(x):
    return _extreme(torch.amax, x, None)


def hmin_nested(x):
    return _extreme(torch.amin, x, None)


def all_nested(mask):
    """all() across every nesting level."""
    return torch.all(_truth(mask))


def any_nested(mask):
    return torch.any(_truth(mask))


def none_nested(mask):
    return ~torch.any(_truth(mask))


def count_nested(mask):
    return torch.sum(_truth(mask), dtype=torch.int32)


def psum(x, axis=-1):
    """Inclusive prefix sum along ``axis``."""
    return _cumsum(_asarray(x), axis)


def all_(mask, axis=None):
    return torch.all(_truth(mask), **_dims(axis))


def any_(mask, axis=None):
    return torch.any(_truth(mask), **_dims(axis))


def none(mask, axis=None):
    return ~torch.any(_truth(mask), **_dims(axis))


def count(mask, axis=None):
    """Number of true lanes, int32."""
    return torch.sum(_truth(mask), dtype=torch.int32, **_dims(axis))


def dot(a, b, axis=-1):
    """Sum of a*b over ``axis``."""
    return _sum(a * b, axis)


def abs_dot(a, b, axis=-1):
    return abs_(dot(a, b, axis))


def norm(a, axis=-1):
    """sqrt(dot(a, a)), correctly rounded (``ops.sqrt``)."""
    return sqrt(dot(a, a, axis))


def squared_norm(a, axis=-1):
    return dot(a, a, axis)


def normalize(a, axis=-1):
    """a * rsqrt(sum(a*a, axis)), the rsqrt taken in float64 on an IEEE
    root and rounded once (``_rsqrt_rn``), so that the CPU and the card
    agree."""
    return a * _rsqrt_rn(_sum(a * a, axis, keepdim=True))


def reverse(x, axis=0):
    """The order along ``axis`` reversed (the first axis by default;
    ``ops.reverse`` is the router's, on the last axis)."""
    return _on_bits(lambda v: v.flip(axis), _asarray(x))


# ---------------------------------------------------------------------------
# Compress and partition
# ---------------------------------------------------------------------------


def _packed(n, fill, dtype, device, slots, values):
    """A length-``n`` tensor of ``fill`` with ``values`` written at
    ``slots``; a slot of ``n`` writes nothing (it lands in a padded slot
    that is cut off), as the port's ``scatter`` drops lanes."""
    out = torch.full((n + 1,), fill, dtype=dtype, device=device)
    _signed_view(out).index_put_((slots.long(),), _signed_view(values))
    return out[:n]


def compress(x, mask, fill=0):
    """Pack the lanes where ``mask`` is set to the front, in order.

    Returns ``(packed, count)``: ``packed`` has x's (static) shape, its
    first ``count`` lanes are the selected values and the rest ``fill``;
    ``count`` is an int32 0-d tensor, left on the device (no host sync).
    Each selected lane's slot is the exclusive prefix sum of the mask."""
    x, mask = _operands(x, mask)
    mask = _truth(mask)
    m = mask.to(torch.int32)
    n = x.shape[0]
    slots = torch.where(mask, _cumsum(m, 0) - m, n)
    packed = _packed(n, fill, x.dtype, x.device, slots, x)
    return packed, torch.sum(m, dtype=torch.int32)


def partition(keys, max_instances: int):
    """Stable-sort lanes by key and run-length encode, with static shapes.

    Returns ``(unique, counts, perm)``, all int32:
      unique: (max_instances,) -- the keys present, ascending, padded
              with -1
      counts: (max_instances,) -- lanes per unique key, padded with 0
      perm:   (n,) -- the stable permutation grouping lanes by key
    A key >= ``max_instances`` is left out of ``unique`` and ``counts``
    but stays in ``perm``; a negative key counts from the end, as the
    reference's indexing does (keys are meant to be in
    [0, max_instances))."""
    keys = _asarray(keys).to(torch.int32)
    m = max_instances
    perm = torch.argsort(keys, stable=True).to(torch.int32)
    k = torch.where(keys < 0, keys + m, keys)
    k = torch.where((k < 0) | (k >= m), m, k).long()
    counts_dense = torch.zeros(m + 1, dtype=torch.int32,
                               device=keys.device).index_add_(
        0, k, torch.ones_like(keys))[:m]
    present = counts_dense > 0
    p = present.to(torch.int32)
    slots = torch.where(present, _cumsum(p, 0) - p, m)
    ids = torch.arange(m, dtype=torch.int32, device=keys.device)
    unique = _packed(m, -1, torch.int32, keys.device, slots, ids)
    counts = _packed(m, 0, torch.int32, keys.device, slots, counts_dense)
    return unique, counts, perm


def segment_offsets(counts):
    """Exclusive prefix sum of per-instance counts: the start offset of
    each instance's segment in the permuted order, in counts' dtype."""
    counts = _asarray(counts)
    return _cumsum(counts.reshape(-1), 0) - counts
