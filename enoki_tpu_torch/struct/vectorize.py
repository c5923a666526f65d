"""vectorize / vectorize_wrapper: the dynamic-array packet loops
(counterpart of enoki_tpu/struct/vectorize.py).

The reference's ``vectorize(f, args...)`` (dynamic.h:1026) runs ``f`` over
packets of dynamic arrays. On tensors ``f`` runs once over the whole
arrays, so ``vectorize`` is a call with the reference's size check (sizes
equal or 1). Its ``jit`` flag is accepted and the call runs eagerly: the
port has no tracing compiler to hand ``f`` to (the JAX reference caches a
``jax.jit`` wrapper per function; that cache has nothing to hold here).

``vectorize_wrapper`` (dynamic.h:1105) adapts a per-lane function to wide
tensors: ``torch.func.vmap``. A callee that reads a value to the host
(``.item()``) raises under it, as it does under ``jax.vmap``. A callee
that launches a kernel of the port is batched by its
``autograd.Function``'s ``vmap`` rule (``_build.loop_vmap``): one launch
an item of the batch, forward and backward (the reference batches its
``pallas_call`` in one launch).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils._pytree as pytree


def _shape(a):
    return tuple(getattr(a, "shape", ()))


def _check_sizes(args):
    sizes = {_shape(a)[0] for a in pytree.tree_leaves(args) if _shape(a)}
    big = {s for s in sizes if s != 1}
    if len(big) > 1:
        # the reference's incompatible-size error (dynamic.h:1042)
        raise ValueError(f"vectorize(): incompatible input sizes {sorted(big)}")


def vectorize(f: Callable, *args, jit: bool = True):
    """Run ``f`` over wide inputs. Sizes must be equal or 1 (broadcast),
    else ``ValueError``; returns f's outputs. ``jit`` is accepted for the
    reference's signature; the call is eager either way."""
    _check_sizes(args)
    return f(*args)


def vectorize_safe(f: Callable, *args, jit: bool = True):
    """The reference's alias of ``vectorize`` (dynamic.h:1077): the checks
    always run, so the two coincide."""
    return vectorize(f, *args, jit=jit)


def vectorize_wrapper(f: Callable) -> Callable:
    """Adapt a per-lane function to wide tensors with ``torch.func.vmap``,
    with the reference wrapper's mixed wide/scalar contract: scalar and
    size-1 arguments broadcast (``in_dims`` None, a leading size-1 axis
    squeezed), and an all-scalar call is a plain call."""

    def _axis(a):
        sizes = [_shape(l)[0] for l in pytree.tree_leaves(a) if _shape(l)]
        return 0 if any(s != 1 for s in sizes) else None

    def _squeeze1(a):  # drop a broadcast arg's leading size-1 axis
        return pytree.tree_map(
            lambda l: l.reshape(_shape(l)[1:]) if _shape(l) else l, a)

    def wide(*args):
        _check_sizes(args)
        axes = tuple(_axis(a) for a in args)
        if not any(ax == 0 for ax in axes):
            return f(*args)  # all scalars: nothing to map
        squeezed = tuple(a if ax == 0 else _squeeze1(a)
                         for a, ax in zip(args, axes))
        return torch.func.vmap(f, in_dims=axes)(*squeezed)

    return wide
