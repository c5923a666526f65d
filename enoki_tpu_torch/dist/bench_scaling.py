"""Scaling-efficiency harness for the distributed train step (counterpart
of enoki_tpu/dist/bench_scaling.py).

* ``collective_stats``: run one shardmap train step in the current world
  and read every collective it issued from ``dist.render.COLLECTIVES``,
  the record each call site appends to. The payload must be the
  parameters' size (9 gradients and the loss, 40 bytes), not
  O(pixels/rank), at any resolution. The reference reads the same from
  XLA's compiled HLO; the port has no compiler to ask, and the card phase
  of chip_smoke.py holds the record against the ``c10d`` all-reduce
  events of ``torch.profiler``.
* ``schedule_overlap_report``: what the one all-reduce of a step overlaps,
  read from the profiler's op sequence of one step in launch order.
* ``predicted_efficiency``: the measured one-card step time scaled by the
  pixels a rank renders, plus a ring all-reduce of the payload over an
  H100 cluster's links with zero overlap.
* ``measured_weak_scaling``: per-rank throughput with constant per-rank
  work in spawned worlds of 1, 4, 16 ... ranks.

Run inside a world of one or more ranks:
    torchrun --nproc-per-node=N -m enoki_tpu_torch.dist.bench_scaling
    python -m enoki_tpu_torch.dist.bench_scaling cpu   (a CPU world of one)
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Optional, Sequence

import torch

# The H100 SXM interconnect (NVIDIA's H100 data sheet): NVLink 4, 900 GB/s
# a GPU in both directions together, so 450 GB/s a direction, between the
# GPUs of one node; across nodes one NDR InfiniBand port a GPU, 400 Gb/s
# = 50 GB/s a direction. An HGX H100 node holds 8 GPUs.
NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8
# Per-hop latencies: an assumption, not a measurement (no multi-card
# machine has been measured here): 2 us a ring step over NVLink and 5 us
# over InfiniBand, the order of NCCL's small-message latencies.
NVLINK_HOP_LATENCY_S = 2e-6
IB_HOP_LATENCY_S = 5e-6
# The one-card fwd+bwd+Adam step of make_train_step_shardmap at 1024^2,
# wall time: 5.2900 ms, the median of 7 windows of 20 steps (spread 37.8%;
# device time 0.93877 ms a step, busy share 0.18), chip_smoke.py phase 26
# (e) on an NVIDIA H100 80GB HBM3 at a 700.00 W limit. The step is
# host-bound, and its wall time includes the functional step's host work
# (a new optimiser a step, loaded from a copy of the state): a step as
# short as its device time would make the all-reduce 5.6x the share.
MEASURED_STEP_S_1024 = 5.29e-3


@dataclasses.dataclass
class CollectiveStats:
    n: int                      # frame is n x n pixels
    n_devices: int
    flops_per_device: Optional[float]  # None: no cost model to ask
    allreduce_bytes: int        # total all-reduce payload per step
    allreduce_shapes: list      # "f32[10]" per all-reduce


_SHORT = {"torch.float32": "f32", "torch.float64": "f64",
          "torch.bfloat16": "bf16", "torch.float16": "f16",
          "torch.int32": "s32", "torch.int64": "s64"}


def _one_step(n, n_devices, renderer, device):
    """One shardmap Adam step on a zero target in the current world, its
    collectives recorded -> (mesh, the record)."""
    from ..render.sphere import SphereScene
    from .mesh import make_mesh
    from .render import (COLLECTIVES, make_train_step_shardmap,
                         reset_collectives)

    mesh = make_mesh(n_devices, device=device)
    kw = {} if renderer is None else {"renderer": renderer}
    step = make_train_step_shardmap(
        n, mesh, lambda p: torch.optim.Adam(p, lr=1e-2), **kw)
    scene = SphereScene.reference(device)
    target = torch.zeros((n, n), device=scene.radius.device)
    reset_collectives()
    step(scene, target, None)
    return mesh, list(COLLECTIVES)


def collective_stats(n: int, n_devices: Optional[int] = None,
                     renderer=None, device=None) -> CollectiveStats:
    """Run the shardmap train step once on an ``n_devices`` mesh of the
    current world (collective: every rank calls it) and read its
    all-reduce payloads from the call sites' record. ``flops_per_device``
    is None: the reference takes it from XLA's cost analysis, which has
    no counterpart here."""
    mesh, record = _one_step(n, n_devices, renderer, device)
    ars = [c for c in record if c["op"] == "all_reduce"]
    return CollectiveStats(n, mesh.size(), None,
                           sum(c["bytes"] for c in ars),
                           [f"{_SHORT.get(c['dtype'], c['dtype'])}"
                            f"[{c['numel']}]" for c in ars])


@dataclasses.dataclass
class OverlapReport:
    """What the step's gradient all-reduce overlaps, in the reference's
    fields, read from the profiler's op sequence of one step.

    * async pairs: an all-reduce issued with ``async_op=True`` and its
      ``wait``, with ops launched between them (direct overlap). The
      port's steps issue theirs synchronously, so none.
    * trailing ops: those launched after the all-reduce. Every one is
      the optimiser's update, which reads the reduced gradient: none is
      independent of it (the profiler records no data dependencies, and
      none are counted as independent).
    * neither: then ``ok`` asks that the zero-overlap wire cost fit the
      north star's headroom, comm_share <= 1 - 0.90 at 16 ranks, with one
      all-reduce a step (more would be a per-pixel collective).
    """

    n_allreduce: int
    async_pairs: int
    overlapped_between: int
    trailing_total: int
    trailing_independent: int
    comm_share: float
    ok: bool


def _is_allreduce(name: str) -> bool:
    return name.startswith("c10d::allreduce")


def schedule_overlap_report(n: int = 256, n_devices: Optional[int] = None,
                            renderer=None, target_eff: float = 0.90,
                            device=None) -> OverlapReport:
    """Profile one shardmap train step on an ``n_devices`` mesh of the
    current world (collective) and classify, from its ops in launch
    order, how the gradient all-reduce relates to the work around it
    (``OverlapReport``). ``comm_share`` is the ring model's wire time at
    max(ranks, 16) over the one-card step time ``MEASURED_STEP_S_1024``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        mesh, record = _one_step(n, n_devices, renderer, device)
    # top-level host ops, in launch order
    ops = sorted((e for e in prof.events() if e.cpu_parent is None),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in ops]
    ars = [i for i, name in enumerate(names) if _is_allreduce(name)]
    waits = [i for i, name in enumerate(names) if "wait" in name.lower()]
    async_pairs = sum(1 for i in ars if any(w > i for w in waits))
    overlapped = 0
    for i in ars:
        w = next((w for w in waits if w > i), None)
        if w is not None:
            overlapped += sum(1 for j in range(i + 1, w)
                              if names[j].startswith("aten::"))
    trailing = (sum(1 for name in names[ars[0] + 1:]
                    if name.startswith("aten::") or
                    name.startswith("Optimizer.step")) if ars else 0)
    nbytes = sum(c["bytes"] for c in record if c["op"] == "all_reduce")
    comm_share = _torus_allreduce_s(nbytes, max(mesh.size(), 16)) \
        / MEASURED_STEP_S_1024
    ok = (overlapped > 0 or (len(ars) == 1 and
                             comm_share <= 1.0 - target_eff))
    return OverlapReport(len(ars), async_pairs, overlapped, trailing, 0,
                         comm_share, ok)


def _axis_links(n_devices: int):
    """(ranks, bytes/s, hop latency) of each axis of the (dp, sp) mesh of
    ``n_devices`` ranks: sp, the inner axis, runs over consecutive ranks
    and stays in a node where it divides one; dp spans nodes once the mesh
    outgrows a node."""
    from .mesh import _factor2

    nvlink = (NVLINK_BYTES_PER_S, NVLINK_HOP_LATENCY_S)
    ib = (IB_BYTES_PER_S, IB_HOP_LATENCY_S)
    one_node = n_devices <= GPUS_PER_NODE
    a, b = _factor2(n_devices)
    return [(b, *(nvlink if one_node or GPUS_PER_NODE % b == 0 else ib)),
            (a, *(nvlink if one_node else ib))]


def _torus_allreduce_s(nbytes: int, n_devices: int) -> float:
    """Ring all-reduce decomposed over the axes of the (near-)square mesh:
    per axis, 2(a-1)/a bandwidth steps and 2(a-1) latency hops (the
    standard reduce-scatter + all-gather), each over its axis's link."""
    t = 0.0
    for a, rate, hop in _axis_links(n_devices):
        if a <= 1:
            continue
        t += 2.0 * (a - 1) / a * nbytes / rate + 2.0 * (a - 1) * hop
    return t


def predicted_efficiency(n: int, n_devices: int,
                         allreduce_bytes: Optional[int] = None,
                         step_s_1024: float = MEASURED_STEP_S_1024,
                         overlap: float = 0.0,
                         mode: str = "strong", device=None) -> float:
    """Analytic scaling efficiency on N H100s.

    ``mode="strong"``: one n x n frame split over N ranks. ``"weak"``:
    each rank owns an n x n tile. t_compute = the measured one-card step
    time (``step_s_1024``) scaled by the pixels a rank renders; t_comm =
    the ring all-reduce of the payload (``allreduce_bytes``; None:
    ``collective_stats`` in the current world) over the links, times 1 -
    ``overlap``."""
    if n_devices <= 1:
        return 1.0
    if allreduce_bytes is None:
        allreduce_bytes = collective_stats(256, device=device).allreduce_bytes
    per_dev_pixels = (n * n / n_devices) if mode == "strong" else (n * n)
    t_compute = step_s_1024 * per_dev_pixels / (1024.0 * 1024.0)
    t_comm = _torus_allreduce_s(allreduce_bytes, n_devices) * (1.0 - overlap)
    return t_compute / (t_compute + t_comm)


def _weak_worker(rank, world, tile, iters, device):
    """One rank of measured_weak_scaling's world: the seconds a step takes
    (the median of 3 windows after a discarded one) -> rank 0's."""
    from ..render.sphere import SphereScene
    from .mesh import make_mesh
    from .render import make_train_step_shardmap

    s = math.isqrt(world)
    n = tile * s  # (s, s) mesh: the area a rank renders is tile^2
    mesh = make_mesh(world, device=device)
    step = make_train_step_shardmap(
        n, mesh, lambda p: torch.optim.Adam(p, lr=1e-2))
    scene = SphereScene.reference(device)
    target = torch.zeros((n, n), device=scene.radius.device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    step(scene, target, None)
    sync()
    times = []
    for _ in range(4):
        sc, st = scene, None
        t0 = time.perf_counter()
        for _ in range(iters):
            sc, st, loss = step(sc, target, st)
        float(loss)  # the last step's reduced loss, on every rank
        times.append((time.perf_counter() - t0) / iters)
    return n, sorted(times[1:])[1]


def measured_weak_scaling(device_counts: Sequence[int] = (1, 4, 16),
                          tile: int = 128, iters: int = 10,
                          timeshare: Optional[bool] = None, device=None,
                          store_dir=None):
    """Wall-clock weak scaling: per-rank throughput with constant per-rank
    work, in a spawned world of each count in turn (``gloo`` processes on
    the CPU for ``device="cpu"``, one ``nccl`` process a GPU on the card).
    Returns a list of (n_devices, n, rays_per_s_per_device, efficiency).

    Counts must be perfect squares: over an (s, s) mesh, n = tile*s keeps
    a rank's work exactly tile^2 at every count. Others are skipped with
    a note on stderr. The list stops at a count above the GPUs present
    (the CPU: its cores).

    ``timeshare`` (default: a CPU with fewer cores than the largest
    count) normalises for ranks that share cores: the ideal N-rank step
    then takes N x T(1), so efficiency = N*T(1)/T(N); else T(1)/T(N)."""
    from .._device import resolve_device
    from ._world import run_world

    dev = resolve_device(device).type
    cores = os.cpu_count() or 1
    avail = torch.cuda.device_count() if dev == "cuda" else cores
    if timeshare is None:
        timeshare = dev == "cpu" and cores < max(device_counts)
    rows, base = [], None
    for nd in device_counts:
        if nd > avail:
            break
        s = math.isqrt(nd)
        if s * s != nd:
            print(f"measured_weak_scaling: skipping n_devices={nd} "
                  f"(not a perfect square -- per-device work would "
                  f"change; see docstring)", file=sys.stderr)
            continue
        n, dt = run_world("enoki_tpu_torch.dist.bench_scaling:_weak_worker",
                          nd, (tile, iters, dev), device=dev,
                          store_dir=store_dir)[0]
        per_dev = n * n / dt / nd
        if base is None:
            base = per_dev
        rows.append((nd, n, per_dev, per_dev / base * (nd if timeshare
                                                       else 1)))
    return rows


def main(device=None):
    """Inside a world (torchrun), or a world of one: the payload, the
    predicted efficiencies and the weak scaling on this machine."""
    import torch.distributed as dist

    from .mesh import init_distributed

    init_distributed(device=device)
    nd = dist.get_world_size()
    st = collective_stats(256, nd, device=device)
    st2 = collective_stats(512, nd, device=device)
    if dist.get_rank() != 0:
        return
    print(f"world: {nd} rank(s) on {device or 'cuda'}")
    print(f"all-reduce payload a step {st.allreduce_bytes} B "
          f"({st.allreduce_shapes}); at 4x the pixels "
          f"{st2.allreduce_bytes} B")
    print("predicted efficiency (the measured one-card step, a ring "
          "all-reduce over NVLink / InfiniBand, zero overlap):")
    for mode, n in (("strong", 1024), ("strong", 4096), ("weak", 1024)):
        for ndev in (2, 4, 8, 16, 64, 256):
            eff = predicted_efficiency(n, ndev, st.allreduce_bytes,
                                       mode=mode)
            print(f"  {mode:6s} {n}^2 devices={ndev:4d} "
                  f"efficiency={eff:7.4f}")
    if nd == 1:
        print("measured weak scaling (per-rank throughput):")
        for nd_, n, tput, eff in measured_weak_scaling(device=device):
            print(f"  devices={nd_}  n={n:5d}  {tput / 1e6:8.2f} "
                  f"Mpix/s/dev  eff={eff:6.3f}")


if __name__ == "__main__":
    main("cpu" if "cpu" in sys.argv[1:] else None)
