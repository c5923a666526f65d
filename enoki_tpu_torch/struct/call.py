"""Vectorized method calls over arrays of instance ids (counterpart of
enoki_tpu/struct/call.py, the reference's arrays of pointers with
vectorized virtual calls, array_call.h:17,126).

Instances are integer ids into a registry. Every callee has the signature
``f(mask, *args)``, under every dispatcher:

* ``dispatch_masked``: every callee runs on the whole batch, and the
  results are blended lane by lane with ``select_struct``.
* ``dispatch_partition``: the lanes are stable-sorted by id
  (``ops.horiz.partition``), the arguments gathered through the
  permutation, each callee run on the permuted arrays under its segment's
  mask, and the results gathered back through the inverse permutation.
* ``dispatch_switch``: one callee for all lanes (a uniform id), with a
  0-d all-true mask.

Lanes with an id below 0 (a null pointer) take ``default``, or zeros.
``InstanceRegistry`` keeps the objects, stacks their attributes into
tensors and dispatches their methods. The lazy (``LazyArray``) dispatcher
of the reference waits for the port of trace/ and raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from .._device import resolve_device
from ..ops.backend import require_eager
from ..ops.horiz import partition
from ..ops.router import _asarray, arange, gather, scatter
from .pytree import gather_struct, select_struct, zeros_like


def _ids(ids):
    require_eager(ids)
    return _asarray(ids).to(torch.int32)


def dispatch_masked(funcs: Sequence[Callable], ids, *args, default=None):
    """Evaluate ``funcs[ids[i]]`` lanewise, branch-free: every callee sees
    the whole arguments, and its result is kept on the lanes where
    ``ids == i``. All callees return the same structure; lanes with
    ``ids < 0`` (or past the last callee) take ``default``, or zeros."""
    ids = _ids(ids)
    out = None
    for i, f in enumerate(funcs):
        m = ids == i
        r = f(m, *args)
        if out is None:
            out = zeros_like(r) if default is None else default
        out = select_struct(m, r, out)
    return out


def dispatch_partition(funcs: Sequence[Callable], ids, *args, default=None):
    """Sort-based dispatch (array_call.h:147-165): partition the lanes by
    id, gather the arguments (and ``default``) through the permutation,
    run each callee under its segment's mask, and gather the results back
    through the inverse permutation, a scatter of ``arange``."""
    ids = _ids(ids)
    _, _, perm = partition(torch.clamp_min(ids, 0), len(funcs))
    perm_ids = gather(ids, perm)
    gathered = tuple(gather_struct(a, perm) for a in args)
    out_p = None
    for i, f in enumerate(funcs):
        m = perm_ids == i
        r = f(m, *gathered)
        if out_p is None:
            # default travels through the permutation with the arguments
            out_p = zeros_like(r) if default is None else \
                gather_struct(default, perm)
        out_p = select_struct(m, r, out_p)
    n = perm.shape[0]
    inv = scatter(torch.zeros_like(perm),
                  arange(n, torch.int32, device=perm.device), perm)
    return gather_struct(out_p, inv)


def dispatch_switch(funcs: Sequence[Callable], uniform_id, *args):
    """Single-instance path: all lanes share one id, and exactly one
    callee runs, as ``f(mask, *args)`` with a 0-d all-true mask (it
    broadcasts against any lane shape). The id is clamped into range, as
    ``lax.switch`` clamps it. Reading the id is one host read of a tensor
    id (the reference's ``lax.switch`` picks the branch on the device)."""
    i = min(max(int(uniform_id), 0), len(funcs) - 1)
    like = next((a for a in args if isinstance(a, torch.Tensor)), None)
    device = like.device if like is not None else resolve_device(None)
    mask = torch.ones((), dtype=torch.bool, device=device)
    return funcs[i](mask, *args)


# strategy="auto": the masked select tree below this instance count,
# partition at and above it. 16 is the reference's value, set from its
# TPU table (docs/structs.md); it was not measured on a GPU.
# chip_smoke.py's phase 25 times both strategies on the card at 2-32
# instances.
_AUTO_PARTITION_MIN_K = 16


class InstanceRegistry:
    """Host-side registry of instances (the reference's pointer registry).

    ``register`` gives stable ids; ``stack(attr)`` builds the table of an
    attribute across instances; ``getter`` gathers it per lane; ``dispatch``
    calls a method per lane.
    """

    def __init__(self):
        self._instances: List[Any] = []

    def register(self, obj) -> int:
        self._instances.append(obj)
        return len(self._instances) - 1

    def __len__(self):
        return len(self._instances)

    def __getitem__(self, i):
        return self._instances[i]

    @property
    def instances(self):
        return tuple(self._instances)

    def stack(self, attr: str, device=None):
        """The table of a scalar attribute across instances
        (``torch.stack``), on the attributes' device; Python numbers go to
        ``device`` (None: the card, or raise) as int32 / float32."""
        vals = [getattr(o, attr) for o in self._instances]
        like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
        if like is not None:
            device = like.device
        return torch.stack([_asarray(v, device) for v in vals])

    def getter(self, attr: str, ids):
        """An attribute per lane; null ids (< 0) read 0
        (ENOKI_CALL_SUPPORT_GETTER, array_call.h:272)."""
        ids = _ids(ids)
        return gather(self.stack(attr, ids.device), ids, mask=ids >= 0)

    def dispatch(self, method: str, ids, *args, strategy: str = "auto"):
        """Vectorized virtual call ``ptrs->method(args...)``: each
        instance's bound method is called as f(mask, *args).
        ``strategy="auto"`` takes the masked tree below
        ``_AUTO_PARTITION_MIN_K`` instances and the partition at or above
        it."""
        funcs = [getattr(o, method) for o in self._instances]
        if strategy == "auto":
            strategy = ("partition"
                        if len(funcs) >= _AUTO_PARTITION_MIN_K
                        else "masked")
        if strategy == "masked":
            return dispatch_masked(funcs, ids, *args)
        if strategy == "partition":
            return dispatch_partition(funcs, ids, *args)
        raise ValueError(f"unknown dispatch strategy {strategy!r}")
