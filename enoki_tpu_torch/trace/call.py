"""Vectorized method calls on the lazy trace (the CUDAArray vcall path;
counterpart of enoki_tpu/trace/call.py).

The source paper dispatches ``ptrs->f(args...)`` on lazy GPU arrays by
partitioning the pointer array by instance -- a cub radix sort and a
run-length encoding (src/cuda/horiz.cu:35-123) giving per-instance
permutations cached on the array (cuda.h:815-842) -- then, per instance,
gathering the arguments through the permutation, calling the method once
with vector arguments and scattering the results back
(array_call.h:147-191). ``partition`` is an eval boundary there too: the
host must know the instance list to pick which methods to call.

* ``partition(ids)`` evaluates the id array, sorts it stably on its own
  device (``torch.argsort(stable=True)``) and reads the instance list and
  the runs' lengths to the host in one transfer, the one sync of a
  dispatch; the permutations stay on the device. They are cached per
  array id (256 entries, 64 MiB), and a scatter into the array drops its
  entry.
* ``dispatch(funcs, ids, *args)`` records per-instance gather -> callee
  -> scatter into the trace; the consumer's eval fuses every callee into
  one program, and a retrace of the same dispatch structure is a
  kernel-cache hit (the permutations enter as data leaves). Gradients
  flow through the recorded gathers and scatters by the tape's rules.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import LazyArray, _lib, maximum as _maximum, select as _select
from .plain import to_work

# per-array partition cache: var id -> ((instance, perm int32 tensor), ...),
# in recency order; bounded by entries and by bytes (var ids are not reused
# soon, so an entry whose array died is unreachable)
_PARTITION_CACHE: dict = {}
_PARTITION_CACHE_MAX = 256
_PARTITION_CACHE_MAX_BYTES = 64 << 20
_CACHE_BYTES = 0  # running total


def _parts_bytes(parts) -> int:
    return sum(int(p.nbytes) for _, p in parts)


def _cache_pop(vid) -> None:
    """Remove one entry, keeping the byte total (the only way entries
    leave the cache)."""
    global _CACHE_BYTES
    parts = _PARTITION_CACHE.pop(vid, None)
    if parts is not None:
        _CACHE_BYTES -= _parts_bytes(parts)


def clear_partition_cache():
    global _CACHE_BYTES
    _PARTITION_CACHE.clear()
    _CACHE_BYTES = 0


def partition(ids: LazyArray):
    """Partition a lazy instance-id array (cuda_partition, horiz.cu:35):
    a tuple of ``(instance_id, perm)`` pairs, ``perm`` an int32 tensor of
    the lanes holding that id on the ids' device; the concatenation of
    the perms is the stable sort permutation of ``ids``. Evaluates
    ``ids`` and caches the result on the array until a scatter into it."""
    global _CACHE_BYTES
    if _lib.ett_is_dirty(ids.index):
        _cache_pop(ids.index)
    parts = _PARTITION_CACHE.pop(ids.index, None)
    if parts is None:
        while _PARTITION_CACHE and (
                len(_PARTITION_CACHE) >= _PARTITION_CACHE_MAX
                or _CACHE_BYTES >= _PARTITION_CACHE_MAX_BYTES):
            _cache_pop(next(iter(_PARTITION_CACHE)))
        vals = to_work(ids.torch(), ids._code).to(torch.int64)
        order = torch.argsort(vals, stable=True)
        inst, counts = torch.unique_consecutive(vals[order],
                                                return_counts=True)
        inst, counts = torch.stack([inst, counts]).cpu().tolist()
        order = order.to(torch.int32)
        parts = tuple(zip(inst, torch.split(order, counts)))
        _CACHE_BYTES += _parts_bytes(parts)
    _PARTITION_CACHE[ids.index] = parts  # most recent last
    return parts


def _true_mask(size: int, device) -> LazyArray:
    return LazyArray.literal(True, size, torch.bool, device)


def dispatch(funcs, ids: LazyArray, *args):
    """Vectorized virtual call on the lazy trace: gather -> callee ->
    scatter per instance (array_call.h:147-165).

    ``funcs[i]`` handles the lanes where ``ids == i`` and is called as
    ``f(mask, *gathered_args)``; it returns a LazyArray, a tuple of them,
    or any pytree of them. Arguments may be LazyArrays or pytrees of
    them: every leaf is gathered through the permutation. Negative ids
    are null pointers: their lanes produce zeros. Everything this records
    stays lazy; one downstream eval fuses all callees.
    """
    n = len(ids)
    device = ids.torch().device
    parts = partition(ids)

    # single-instance fast path (array_call.h:150-151): no permutation
    if len(parts) == 1 and parts[0][0] >= 0:
        inst = parts[0][0]
        if inst >= len(funcs):
            raise IndexError(f"instance id {inst} out of range")
        return funcs[inst](_true_mask(n, device), *args)

    pieces = []          # (perm LazyArray, result leaves)
    single = None        # the first callee's result leaves
    single_tree = None   # ... and their structure (the output's)
    for inst, perm in parts:
        if inst < 0:
            continue
        if inst >= len(funcs):
            raise IndexError(f"instance id {inst} out of range")
        perm_l = LazyArray(perm)
        gathered = tuple(pytree.tree_map(lambda a: a.gather(perm_l), arg)
                         for arg in args)
        r = funcs[inst](_true_mask(len(perm), device), *gathered)
        leaves, tree = pytree.tree_flatten(r)
        if single is not None:
            if tree != single_tree:
                raise ValueError(
                    f"dispatch: callees disagree on result structure "
                    f"({single_tree} vs {tree})")
            for a, b in zip(single, leaves):
                if a.dtype != b.dtype:
                    raise ValueError(
                        f"dispatch: callees disagree on result dtype "
                        f"({a.dtype} vs {b.dtype}) -- the scatter into "
                        "the shared output would cast silently")
        pieces.append((perm_l, leaves))
        if single is None:
            single, single_tree = leaves, tree

    if single is None:
        # all lanes null: no callee ran to define the result structure.
        # funcs[0] is probed under an all-false mask inside
        # structure_probe(), where a scatter or printf of the callee
        # registers nothing, and its ops are never evaluated
        if funcs:
            from . import structure_probe
            with structure_probe():
                probe = funcs[0](LazyArray.literal(False, n, torch.bool,
                                                   device), *args)
            leaves, tree = pytree.tree_flatten(probe)
            return pytree.tree_unflatten(
                [LazyArray.zeros(n, l.dtype, device) for l in leaves], tree)
        return LazyArray.zeros(n, device=device)

    outs = [LazyArray.zeros(n, r.dtype, device) for r in single]
    for perm_l, leaves in pieces:
        for o, r in zip(outs, leaves):
            o.scatter(perm_l, r)
    return pytree.tree_unflatten(outs, single_tree)


def getter(table, ids: LazyArray):
    """Vectorized attribute read: ``ptrs->value`` as a lazy gather from a
    table of the attribute (ENOKI_CALL_SUPPORT_GETTER, array_call.h:272).
    Null ids (< 0) read 0."""
    t = table if isinstance(table, LazyArray) else LazyArray(
        table, device=ids.device)
    g = t.gather(_maximum(ids, 0))
    return _select(ids >= 0, g, 0)


def registry_dispatch(registry, method: str, ids: LazyArray, *args):
    """InstanceRegistry dispatch over LazyArray lanes (the FloatC
    counterpart of struct.call.InstanceRegistry.dispatch)."""
    funcs = [getattr(o, method) for o in registry.instances]
    return dispatch(funcs, ids, *args)


def registry_getter(registry, attr: str, ids: LazyArray):
    """An attribute per lane from ``registry.stack(attr)``, on the ids'
    device."""
    return getter(registry.stack(attr, ids.torch().device), ids)
