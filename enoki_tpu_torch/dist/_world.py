"""Spawn a world of processes for ``torch.distributed`` and collect what
each rank returns.

Used by ``bench_scaling.measured_weak_scaling`` and by callers that check
the distributed layer in a world of their own. A world whose rank dies
waits at its next collective forever, so every world here has three
bounds: ``init_process_group``'s timeout, a ``FileStore`` in a directory
of its own as the rendezvous (no TCP port to race for), and a deadline
past which the parent kills every child and raises.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _child(rank, world, target, args, backend, device, store, timeout_s,
           results):
    import torch
    import torch.distributed as dist

    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, _resolve(target)(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(target: str, world: int, args=(), device: str = "cpu",
              backend=None, store_dir=None, deadline_s: float = 300.0,
              timeout_s: float = 60.0):
    """Run ``target`` ("module:function", imported in each child) as
    ``fn(rank, world, *args)`` on ``world`` spawned processes that share a
    process group -> the ranks' return values, by rank (picklable).

    ``backend``: ``nccl`` for ``device="cuda"`` and ``gloo`` for the CPU
    unless given (``gloo`` on CUDA tensors lets several ranks share one
    card, which ``nccl`` refuses); a CUDA rank takes GPU ``rank % count``.
    The rendezvous is a ``FileStore`` under ``store_dir`` (a temporary
    directory by default). ``RuntimeError`` with the rank's traceback if
    one fails; ``TimeoutError`` after ``deadline_s`` seconds, every child
    killed first."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(
            r, world, target, tuple(args), backend, device, store, timeout_s,
            results), daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        out, end = {}, time.monotonic() + deadline_s
        try:
            while len(out) < world:
                left = end - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{target} in a world of {world}: no result from "
                        f"ranks {sorted(set(range(world)) - set(out))} "
                        f"after {deadline_s:.0f} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"{target}: ranks {dead} died "
                                           "without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"{target}, rank {rank} of {world}:"
                                       f"\n{value}")
                out[rank] = value
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            results.close()
    return [out[r] for r in range(world)]
