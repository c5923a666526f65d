"""Structured vectorization: user structs of tensors (counterpart of
enoki_tpu/struct/pytree.py, the reference's ENOKI_STRUCT support).

``@enoki_struct`` is a frozen dataclass registered with
``torch.utils._pytree``: its fields are the leaves, in their order, as
``jax.tree_util.register_dataclass`` makes them. The helpers map over the
leaves through the op layer (``ops.router``), so a struct of structs (a
``Ray`` of ``Vec3``s) works member by member:

    @enoki_struct
    class Ray:
        o: Vec3
        d: Vec3

    r = Ray(o, d)              # wide struct of tensors
    width(r)                   # slices(): the lanes of the first leaf
    zeros_like(r)              # zero<Ray>()
    gather_struct(r, idx)      # gather<Ray>(r, idx)
    scatter_struct(dst, r, i)  # scatter(dst, r, idx)
    select_struct(m, a, b)     # select(mask, a, b) memberwise
    slice_struct(r, i)         # r[i]: one lane as a struct of scalars
    detach(r)                  # detach leafwise

Each function keeps the reference's dtypes: a leaf keeps its own, and
``concat_structs`` promotes across the pieces as ``jnp.concatenate`` does.
A struct of ``trace.LazyArray`` leaves (``Ray3fC``, a struct of lazy
arrays) works leaf by leaf through the same helpers: the router's lazy
branches record gathers, scatters and selects, ``zeros_like`` /
``full_like`` make literals on each leaf's device, ``slice_struct``
evaluates, ``concat_structs`` scatters each piece into a fresh output at
its offset, and ``detach`` makes fresh data leaves of the values.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TypeVar

import torch
import torch.utils._pytree as pytree

from ..ops.router import _asarray, _is_lazy, _trace, gather, scatter, select

T = TypeVar("T")


def register(cls: type) -> type:
    """Register a dataclass with ``torch.utils._pytree``, its fields the
    leaves in their order (as ``jax.tree_util.register_dataclass`` makes
    them), under its qualified name, so that a treespec holding it can be
    written to disk (``runtime.checkpoint``)."""
    pytree.register_dataclass(
        cls, serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")
    return cls


def enoki_struct(cls: type) -> type:
    """Class decorator: a frozen dataclass registered as a pytree."""
    return register(dataclasses.dataclass(frozen=True)(cls))


def _map(fn, *trees):
    """``fn`` over the leaves of ``trees``."""
    return pytree.tree_map(fn, *trees)


def width(x) -> int:
    """Number of lanes: the leading size of the first leaf (1 for a 0-d
    leaf, 0 for a struct without leaves)."""
    leaves = pytree.tree_leaves(x)
    if not leaves:
        return 0
    leaf = leaves[0]
    shape = tuple(leaf.shape if _is_lazy(leaf) else _asarray(leaf).shape)
    return shape[0] if shape else 1


def _lazy_literal(leaf, value):
    """A literal of ``leaf``'s length and dtype on its device."""
    return _trace().LazyArray.literal(value, len(leaf), leaf.dtype,
                                      device=leaf.device)


def zeros_like(x: T) -> T:
    return _map(lambda l: _lazy_literal(l, 0) if _is_lazy(l)
                else torch.zeros_like(_asarray(l)), x)


def full_like(x: T, value) -> T:
    return _map(lambda l: _lazy_literal(l, value) if _is_lazy(l)
                else torch.full_like(_asarray(l), value), x)


def select_struct(mask, a: T, b: T) -> T:
    """Memberwise select (the masked-assignment idiom for structs)."""
    return _map(lambda u, v: select(mask, u, v), a, b)


def gather_struct(src: T, index, mask=None) -> T:
    """Memberwise gather along the lane axis (``router.gather``: masked-off
    lanes read 0)."""
    return _map(lambda l: gather(l, index, mask=mask), src)


def scatter_struct(dst: T, value: T, index, mask=None) -> T:
    """Memberwise scatter along the lane axis (``router.scatter``)."""
    return _map(lambda d, v: scatter(d, v, index, mask=mask), dst, value)


def slice_struct(x: T, i) -> T:
    """Lane ``i`` as a struct of scalars (``slice()``); a lazy leaf is
    evaluated (the element fetch)."""
    return _map(lambda l: l[i], x)


def set_slice_struct(x: T, i, value: T) -> T:
    """A new struct with lane ``i`` set to ``value``, as ``.at[i].set``:
    each leaf is cloned, then written; ``x`` is left as it is. A lazy
    leaf records a scatter into itself (the value a literal of its dtype,
    an int kept exact) and is returned."""
    def s(l, v):
        if _is_lazy(l):
            LazyArray = _trace().LazyArray
            idx = LazyArray.literal(int(i), 1, torch.int32, device=l.device)
            if not _is_lazy(v):
                v = LazyArray.literal(v if isinstance(v, (int, bool))
                                      else float(v), 1, l.dtype,
                                      device=l.device)
            return l.scatter(idx, v)
        out = l.clone()
        out[i] = v
        return out
    return _map(s, x, value)


def concat_structs(*xs: T) -> T:
    """The structs joined along the lane axis, each leaf in the dtype that
    its pieces promote to (``jnp.concatenate``'s rule). With a lazy piece
    the leaf is a fresh LazyArray on that piece's device, each piece
    scattered into it at its offset."""
    def c(*ls):
        if any(_is_lazy(l) for l in ls):
            tr = _trace()
            ls = [l if _is_lazy(l) else tr.LazyArray(_asarray(l)) for l in ls]
            code = functools.reduce(tr._binary_dtype, (l._code for l in ls))
            dt = tr._DTYPES[code]
            dev = next(l.device for l in ls if l.device is not None)
            out = tr.LazyArray.zeros(sum(len(l) for l in ls), dt, dev)
            off = 0
            for l in ls:
                out.scatter(tr.LazyArray.arange(len(l), device=dev) + off,
                            l if l.dtype == dt else l.cast(dt))
                off += len(l)
            return out
        dt = functools.reduce(torch.promote_types, (l.dtype for l in ls))
        return torch.cat([l.to(dt) for l in ls], dim=0)
    return _map(c, *xs)


def detach(x: T) -> T:
    """``Tensor.detach`` leafwise (``stop_gradient``). A lazy leaf becomes
    a fresh data leaf of its values (evaluated), off the AD tape."""
    return _map(lambda l: _trace().LazyArray(l.torch()) if _is_lazy(l)
                else l.detach(), x)
