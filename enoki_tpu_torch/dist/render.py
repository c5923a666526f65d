"""Distributed differentiable rendering and training (counterpart of
enoki_tpu/dist/render.py).

Pixels shard over the ('dp', 'sp') mesh, one (n/dp, n/sp) tile a rank;
the 9 scene parameters are replicated, and one all-reduce sums the
ranks' parameter gradients and losses after the local backward: 10
floats, one bucket, whatever the resolution.

The reference has two formulations, and the port keeps both, each with
the pixel grid of its counterpart:

* ``make_train_step`` (the reference's GSPMD step): each rank takes the
  loss on its tile of the linspace grid (``render.sphere.pixel_grid``'s
  ``linspace``), and the all-reduce is issued here by hand, where XLA
  inserts it.
* ``make_train_step_shardmap``: each rank rebuilds its tile's pixel
  coordinates from its mesh coordinate, ``(row0*tr + iota)*step -
  extent``, as the reference's ``shard_map`` body does. The two grids
  differ by up to an ulp, so the two steps agree to rtol 1e-4, as the
  reference's do.

The optimiser is a ``torch.optim`` factory, ``optimizer(params) ->
Optimizer``, over the scene's 9 leaves; a step is functional, ``step(scene,
target, opt_state) -> (scene, opt_state, loss)``, with ``opt_state`` the
optimiser's ``state_dict()`` (None: a fresh one). Every all-reduce a step
issues is recorded in ``COLLECTIVES`` (op, dtype, element count, bytes),
which ``bench_scaling`` reads.

The per-pixel loss is the mean squared error against a target image: an
inverse-rendering step.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..ops.router import linspace
from ..render.sphere import (SphereScene, combined, scene_from_leaves,
                             scene_leaves)
from ..render.vec import Vec2
from .mesh import image_sharding, mesh_group

EXTENT = 1.2

# every collective the train steps issued since reset_collectives(): one
# dict (op, dtype, numel, bytes) a call, appended where it is issued
COLLECTIVES: list = []


def reset_collectives():
    COLLECTIVES.clear()


def _all_reduce(x, group):
    """Sum ``x`` over ``group`` in place, recorded in COLLECTIVES."""
    COLLECTIVES.append({"op": "all_reduce", "dtype": str(x.dtype),
                        "numel": x.numel(),
                        "bytes": x.numel() * x.element_size()})
    dist.all_reduce(x, group=group)


def _tile(mesh, n):
    """(row0, col0, tr, tc): this rank's tile of an (n, n) image, or None
    for a rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    dp, sp = mesh.shape
    if n % dp or n % sp:
        raise ValueError(f"image size {n} must be divisible by the mesh "
                         f"shape {tuple(mesh.shape)}")
    return coord[0], coord[1], n // dp, n // sp


def _pixel_block(n: int, extent: float = EXTENT, dtype=torch.float32,
                 device=None, rows=None, cols=None) -> Vec2:
    """(n, n) pixel coordinate grids of the linspace (2-D, so that rows
    and columns shard); ``rows`` / ``cols`` (slices) keep a tile of it."""
    idx = linspace(-extent, extent, n, dtype=dtype, device=device)
    ys = idx[rows if rows is not None else slice(None)]
    xs = idx[cols if cols is not None else slice(None)]
    return Vec2(xs[None, :].expand(ys.shape[0], -1),
                ys[:, None].expand(-1, xs.shape[0]))


def _linspace_tile(mesh, n, device):
    r0, c0, tr, tc = _tile(mesh, n)
    return _pixel_block(n, device=device, rows=slice(r0 * tr, (r0 + 1) * tr),
                        cols=slice(c0 * tc, (c0 + 1) * tc))


def _iota_tile(mesh, n, device):
    """The tile's coordinates rebuilt from the mesh coordinate, as the
    reference's shard_map body does: (row0*tr + iota) * step - extent."""
    r0, c0, tr, tc = _tile(mesh, n)
    step = torch.tensor(2.0 * EXTENT / (n - 1), device=device)
    extent = torch.tensor(EXTENT, device=device)
    rows = r0 * tr + torch.arange(tr, dtype=torch.int32, device=device)
    cols = c0 * tc + torch.arange(tc, dtype=torch.int32, device=device)
    return Vec2((cols.float() * step - extent)[None, :].expand(tr, -1),
                (rows.float() * step - extent)[:, None].expand(-1, tc))


def _scene_device(scene):
    return scene.radius.device


def render_sharded(scene: SphereScene, n: int, mesh):
    """Fused sphere render with the image sharded over the mesh: each rank
    renders its tile of the linspace grid; a ``DTensor`` of shape (n, n)
    with ``image_sharding(mesh)`` (None on a rank outside the mesh)."""
    from torch.distributed.tensor import DTensor

    if _tile(mesh, n) is None:
        return None
    local = combined(_linspace_tile(mesh, n, _scene_device(scene)), scene)
    return DTensor.from_local(local, mesh, image_sharding(mesh),
                              shape=(n, n), stride=(n, 1))


def _sum_sq_over(img, target, n):
    """sum((img - target)^2) / n^2, divided by a 0-d tensor: the card
    computes ``x / number`` as a product with the number's reciprocal."""
    return torch.sum((img - target) ** 2) / torch.tensor(
        float(n * n), dtype=img.dtype, device=img.device)


def mse_loss(scene, target, n: int, renderer=combined):
    """The mean squared error of the (n, n) render on the linspace grid
    against ``target``: the sum and one division, as ``jnp.mean``."""
    img = renderer(_pixel_block(n, device=_scene_device(scene)), scene)
    return _sum_sq_over(img, target, n)


def _local_target(target, mesh, n):
    """This rank's tile of ``target``: a DTensor's local shard, or the
    tile of a full (n, n) tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(target, DTensor):
        return target.to_local()
    r0, c0, tr, tc = _tile(mesh, n)
    return target[r0 * tr:(r0 + 1) * tr, c0 * tc:(c0 + 1) * tc]


def _make_step(n, mesh, optimizer, renderer, grid):
    """A functional train step on ``grid(mesh, n, device)``'s tile: the
    local loss and its backward, one all-reduce of the scene's gradients
    and the loss (10 floats for a sphere) over the mesh, then the
    optimiser, built anew on a copy of ``opt_state`` so that the caller's
    state is never updated in place."""
    group = mesh_group(mesh)

    def train_step(scene, target, opt_state):
        if _tile(mesh, n) is None:
            return scene, opt_state, None
        dev = _scene_device(scene)
        leaves = [l.detach().requires_grad_(True) for l in scene_leaves(scene)]
        with torch.enable_grad():
            s = scene_from_leaves(leaves, type(scene))
            img = renderer(grid(mesh, n, dev), s)
            loss = _sum_sq_over(img, _local_target(target, mesh, n), n)
            grads = torch.autograd.grad(loss, leaves)
        flat = torch.stack([*grads, loss.detach()])
        _all_reduce(flat, group)
        params = [l.detach().clone() for l in leaves]
        opt = optimizer(params)
        if opt_state is not None:
            opt.load_state_dict(copy.deepcopy(opt_state))
        k = len(grads)
        for p, g in zip(params, flat[:k]):
            p.grad = g.clone()
        opt.step()
        return scene_from_leaves(params, type(scene)), opt.state_dict(), \
            flat[k]

    return train_step


def make_train_step(n: int, mesh, optimizer, renderer=combined):
    """The reference's GSPMD training step: image sharded, parameters
    replicated, the loss on each rank's tile of the linspace grid, one
    all-reduce of the gradient (and the loss) after the backward."""
    return _make_step(n, mesh, optimizer, renderer, _linspace_tile)


def make_train_step_shardmap(n: int, mesh, optimizer, renderer=combined):
    """The reference's explicit shard_map step: each rank owns an (n/dp,
    n/sp) tile whose coordinates it rebuilds from its mesh position; the
    9 scalar gradients and the loss are reduced in one all-reduce of 10
    floats after the local backward, so the wire payload is the
    parameters' size at any resolution."""
    dp, sp = mesh.shape
    if n % dp or n % sp:
        raise ValueError(f"image size {n} must be divisible by the mesh "
                         f"shape {tuple(mesh.shape)}")
    return _make_step(n, mesh, optimizer, renderer, _iota_tile)


def fit_scene(target, n: int, mesh, steps: int = 100, lr: float = 2e-2,
              init: Optional[SphereScene] = None, strategy: str = "gspmd",
              renderer=combined, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 50):
    """Inverse rendering driver: recover scene parameters from a target
    image with Adam -> (scene, last loss).

    Collective: every rank of the mesh calls it. ``init`` defaults to the
    reference scene on the card. With ``checkpoint_dir`` the run resumes
    from the newest step checkpoint and saves (scene, optimiser state)
    every ``checkpoint_every`` steps (``runtime.checkpoint``): rank 0
    writes, and the mesh waits for it."""
    from ..runtime import checkpoint as ck

    if strategy not in ("gspmd", "shardmap"):
        raise ValueError(f"unknown strategy {strategy!r}: "
                         "expected 'gspmd' or 'shardmap'")
    scene = init if init is not None else SphereScene.reference()
    if _tile(mesh, n) is None:
        return scene, None
    dev = _scene_device(scene)
    opt_state, start = None, 0
    if checkpoint_dir is not None:
        # on the host: the optimiser keeps its step count there
        restored, step0 = ck.restore_latest(checkpoint_dir, device="cpu")
        if restored is not None:
            scene = pytree.tree_map(lambda t: t.to(dev), restored["scene"])
            opt_state, start = restored["opt"], step0

    def adam(params):
        return torch.optim.Adam(params, lr=lr)

    maker = make_train_step if strategy == "gspmd" else \
        make_train_step_shardmap
    step_fn = maker(n, mesh, adam, renderer)
    loss = None
    for k in range(start, steps):
        scene, opt_state, loss = step_fn(scene, target, opt_state)
        if checkpoint_dir is not None and (k + 1) % checkpoint_every == 0:
            if dist.get_rank() == 0:
                ck.save_step(checkpoint_dir, k + 1,
                             {"scene": scene, "opt": opt_state})
            dist.barrier(group=mesh_group(mesh))
    return scene, loss

