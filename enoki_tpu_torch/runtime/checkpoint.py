"""Checkpoint / resume for training state (counterpart of
enoki_tpu/runtime/checkpoint.py, which is built on orbax).

A state is any pytree of ``torch.utils._pytree``: ``@enoki_struct`` and
render structs (``SphereScene``, ``SDFScene``, ``Vec3``), ``PCG32``
generators, a ``torch.optim`` ``state_dict()`` (the reference checkpoints
an optax state), dicts, lists and tuples of all of these. ``save``
flattens it and writes the tensor leaves (on the CPU), the Python-scalar
leaves and the treespec (``treespec_dumps``) with ``torch.save`` to a
temporary file, then moves it into place (``os.replace``): a reader never
sees half a checkpoint. ``restore`` loads with ``weights_only=True``, so
nothing but tensors and plain containers is unpickled.

Paths are local: the reference also takes URL paths (gs://, s3://)
through etils, which the port does not have.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from .._device import resolve_device

_FORMAT = 1


def save(path: str, state: Any, force: bool = True) -> None:
    """Write ``state`` to the file ``path`` (its directory is made).
    ``force=False`` refuses to overwrite."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    leaves, spec = pytree.tree_flatten(state)
    payload = {
        "format": _FORMAT,
        "treespec": pytree.treespec_dumps(spec),
        "leaves": [l.detach().cpu() if isinstance(l, torch.Tensor) else l
                   for l in leaves],
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _leaf_like(saved, like, path):
    """A saved leaf on ``like``'s device, checked against its dtype (or
    type, for a Python scalar) and shape."""
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.dtype != like.dtype \
                or saved.shape != like.shape:
            raise ValueError(
                f"checkpoint {path}: a leaf of {getattr(saved, 'dtype', type(saved))}"
                f" {tuple(getattr(saved, 'shape', ()))} where the template "
                f"has {like.dtype} {tuple(like.shape)}")
        return saved.to(like.device)
    if type(saved) is not type(like):
        raise ValueError(f"checkpoint {path}: a leaf of {type(saved)} where "
                         f"the template has {type(like)}")
    return saved


def restore(path: str, like: Optional[Any] = None, device=None) -> Any:
    """Read a checkpoint. With ``like`` (a pytree of the same structure),
    each leaf goes to ``like``'s leaf's device and is checked against its
    dtype; without it, the structure is rebuilt from the stored treespec
    and the tensors go to ``device`` (None: the card, or raise)."""
    path = os.path.abspath(path)
    payload = torch.load(path, weights_only=True)
    if payload.get("format") != _FORMAT:
        raise ValueError(f"checkpoint {path}: unknown format "
                         f"{payload.get('format')}")
    leaves = payload["leaves"]
    if like is not None:
        like_leaves, spec = pytree.tree_flatten(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint {path}: {len(leaves)} leaves where "
                             f"the template has {len(like_leaves)}")
        return pytree.tree_unflatten(
            [_leaf_like(s, l, path) for s, l in zip(leaves, like_leaves)],
            spec)
    dev = resolve_device(device)
    spec = pytree.treespec_loads(payload["treespec"])
    return pytree.tree_unflatten(
        [l.to(dev) if isinstance(l, torch.Tensor) else l for l in leaves],
        spec)


def _listdir(root: str):
    return os.listdir(root) if os.path.isdir(root) else []


def _steps(root: str):
    steps = []
    for name in _listdir(root):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    """Highest step-numbered checkpoint under ``root`` (step_<N>), or
    None."""
    steps = _steps(root)
    return steps[-1] if steps else None


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def save_step(root: str, step: int, state: Any,
              max_to_keep: Optional[int] = 3) -> None:
    """Save ``state`` as root/step_<N>, and keep only the newest
    ``max_to_keep`` checkpoints (None: all). Rotation runs on rank 0 only,
    so that processes do not race to delete the same files."""
    save(os.path.join(root, f"step_{step}"), state)
    if max_to_keep is None or _rank() != 0:
        return
    for old in _steps(root)[:-max_to_keep]:
        target = os.path.join(root, f"step_{old}")
        if os.path.isdir(target):
            shutil.rmtree(target, ignore_errors=True)
        else:
            try:
                os.remove(target)
            except OSError:  # another writer, or gone already
                pass


def restore_latest(root: str, like: Optional[Any] = None, device=None):
    """(state, step) from the newest checkpoint, or (None, None)."""
    step = latest_step(root)
    if step is None:
        return None, None
    return restore(os.path.join(root, f"step_{step}"), like, device), step
