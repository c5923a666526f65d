"""Runtime introspection and observability (counterpart of
enoki_tpu/runtime), on PyTorch's own tools:

  cuda_whos() live-variable table       -> whos(): live tensors, one row a
                                           storage (gc scan)
  cuda_set_log_level                    -> config.set_log_level
  set_label                             -> label = record_function
  cuda_printf                           -> printf(): str.format of host
                                           copies
  log>=3 full PTX dumps                 -> dump_jaxpr() / dump_hlo()
  kernel cache + hash                   -> cache_stats(), _build's source-
                                           hash cache (enable_compile_cache)
  cuda_mem_get_info, watermarks         -> memory_stats()
  per-kernel timings at log>=2          -> compile_timings()

The reference's XLA views map as follows. ``dump_jaxpr`` and ``dump_hlo``
read the graph of ``make_fx`` (fake tensors, no compute), which cannot
trace a function that launches one of the port's kernels (a ctypes launch
needs a real data pointer): they raise an error that names it.
``vectorization_report`` / ``assert_vectorized`` and ``dump_hlo(...,
stage="optimized")`` run the function once under ``torch.profiler`` instead,
and so work through the kernels. ``kernel_printf`` (a print inside a
Pallas kernel body) is ``render.sdf_trace.kernel_printf``: the port writes
device code from Python in two places, the per-scene emitter
``render/sdf_trace.py`` (the bodies that ``make_sdf_renderer`` closes
over ``sdf_fn`` and ``ray_fn``, the reference's Pallas bodies a user
reaches) and the lazy trace's ``trace/codegen.py``, whose prints are
``trace.printf`` from the host after the launch. In a traced scene
function it is a ``printf`` of the thread of pixel (0, 0), once an
evaluation; on tensors a print from the host. ``cache_stats`` counts live tensors; the lazy trace's kernel cache hits
and misses are ``trace.cache_stats()``, as in the reference.
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import time
import warnings
from typing import Any, Callable, Dict

import torch
import torch.utils._pytree as pytree

from .._device import resolve_device
from ..ad import trace_graph
from ..config import config, set_log_level, log_level, log  # noqa: F401
from ..render.sdf_trace import kernel_printf  # noqa: F401

label = torch.profiler.record_function


def printf(fmt: str, *args, **kwargs) -> None:
    """Print ``fmt.format(*args, **kwargs)`` with each tensor as its values,
    as ``jax.debug.print`` formats (``{}`` fields). Each tensor is read to
    the host."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    print(fmt.format(*(host(a) for a in args),
                     **{k: host(v) for k, v in kwargs.items()}))


def _live_storages():
    """{storage key: (shape, dtype, bytes, device)} of every live tensor
    that holds memory, one entry a storage (views share theirs)."""
    rows = {}
    with warnings.catch_warnings():
        # a deprecated module attribute warns when isinstance looks at it
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects() if torch.is_tensor(o)]
    for obj in tensors:
        try:
            if obj.device.type == "meta":
                continue
            st = obj.untyped_storage()
            key = (str(obj.device), st.data_ptr())
            nbytes = st.nbytes()
            if key in rows and rows[key][2] >= nbytes and \
                    rows[key][0] >= tuple(obj.shape):
                continue
            rows[key] = (tuple(obj.shape), str(obj.dtype).replace(
                "torch.", ""), nbytes, str(obj.device))
        except Exception:  # a tensor without storage (fake, functorch)
            continue
    return rows


def whos(print_out: bool = True) -> str:
    """Live-tensor table with per-device memory, one row a storage, the
    largest first (the analog of ``cuda_whos()``, jit.cu:1564-1634)."""
    rows = list(_live_storages().values())
    total = sum(r[2] for r in rows)
    lines = ["  Shape                Type        Bytes        Devices",
             "  " + "=" * 60]
    for shape, dtype, nbytes, dev in sorted(rows, key=lambda r: -r[2]):
        lines.append(f"  {str(shape):<20} {dtype:<11} {nbytes:<12} {dev}")
    lines.append("  " + "=" * 60)
    lines.append(f"  Total: {total / 1e6:.3f} MB in {len(rows)} arrays")
    out = "\n".join(lines)
    if print_out:
        print(out)
    return out


def memory_stats(device=None) -> Dict[str, Any]:
    """Memory of ``device`` (None: the card, or raise), the analog of
    cuda_mem_get_info and the allocator's watermarks: on the card
    ``torch.cuda.memory_stats`` (``bytes_limit`` the card's total memory);
    on the CPU the bytes of the live tensors, no peak and no limit."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        return {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                dev).total_memory,
            "raw": stats,
        }
    used = sum(r[2] for r in _live_storages().values()
               if r[3] == str(dev))
    return {"bytes_in_use": used, "peak_bytes_in_use": None,
            "bytes_limit": None, "raw": {}}


def dump_jaxpr(f: Callable, *args) -> str:
    """The graph of ``make_fx(f)(*args)`` as code: one line an aten op."""
    return trace_graph(f, *args).print_readable(print_output=False)


def _on_card(args) -> bool:
    return any(isinstance(l, torch.Tensor) and l.device.type == "cuda"
               for l in pytree.tree_leaves(args))


def _sync(card: bool):
    if card:
        torch.cuda.synchronize()


def _profiled_call(f, args, card):
    """One call of ``f`` under ``torch.profiler``: (events, seconds, the
    host syncs it made, kernel launches of the port)."""
    from .. import _build

    activities = [torch.profiler.ProfilerActivity.CPU]
    if card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = sum(_build.LAUNCHES.values())
    syncs = []
    with torch.profiler.profile(activities=activities) as prof:
        _sync(card)
        t0 = time.perf_counter()
        if card:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    f(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            # set_sync_debug_mode also warns that it is a prototype
            syncs = [str(w.message) for w in seen
                     if "called a synchronizing" in str(w.message)]
        else:
            f(*args)
        _sync(card)
        seconds = time.perf_counter() - t0
    launches = sum(_build.LAUNCHES.values()) - before
    return prof.events(), seconds, syncs, launches


def _is_device_event(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _profile_text(events) -> str:
    """The aten ops and device kernels of one call, with their counts."""
    ops, kernels = {}, {}
    for e in events:
        table = kernels if _is_device_event(e) else ops
        if table is kernels or e.name.startswith("aten::"):
            table[e.name] = table.get(e.name, 0) + 1
    lines = ["aten ops:"] + [f"  {k} x{v}" for k, v in ops.items()]
    lines += ["device kernels:"] + [f"  {k} x{v}" for k, v in kernels.items()]
    return "\n".join(lines)


def dump_hlo(f: Callable, *args, stage: str = "hlo") -> str:
    """``stage="hlo"``: the graph of ``make_fx`` after
    ``core_aten_decompositions``; ``stage="optimized"``: the aten ops and
    device kernels that one call runs, from ``torch.profiler`` (this one
    works through the port's kernels)."""
    if stage == "hlo":
        return trace_graph(f, *args, decompose=True).print_readable(
            print_output=False)
    if stage != "optimized":
        raise ValueError(f"unknown stage {stage!r}")
    return _profile_text(_profiled_call(f, args, _on_card(args))[0])


def compile_timings(f: Callable, *args) -> Dict[str, Any]:
    """Wall times of a first call (``compile_s``: it pays any nvcc build
    of ``_build`` or of a scene) and of a second (``cache_hit_s``), each
    under ``torch.profiler`` and ended by a synchronise on the card;
    ``n_eqns``, the aten ops and the port's kernel launches of the first
    call; and
    ``trace_s`` / ``lower_s``, the ``make_fx`` trace and the trace after
    ``core_aten_decompositions`` (None for a function that launches one of
    the port's kernels, which make_fx cannot trace)."""
    card = _on_card(args)
    events, compile_s, _, launches = _profiled_call(f, args, card)
    _, cache_hit_s, _, _ = _profiled_call(f, args, card)
    n_eqns = launches + sum(1 for e in events if e.name.startswith("aten::"))
    try:
        t0 = time.perf_counter()
        trace_graph(f, *args)
        t1 = time.perf_counter()
        trace_graph(f, *args, decompose=True)
        t2 = time.perf_counter()
        trace_s, lower_s = t1 - t0, t2 - t1
    except RuntimeError as e:
        if "make_fx cannot trace" not in str(e):
            raise
        trace_s = lower_s = None
    return {"trace_s": trace_s, "lower_s": lower_s, "compile_s": compile_s,
            "cache_hit_s": cache_hit_s, "n_eqns": n_eqns}


def cache_stats() -> Dict[str, Any]:
    """Live tensors (one a storage) and their bytes."""
    rows = _live_storages()
    return {"live_arrays": len(rows),
            "live_bytes": sum(r[2] for r in rows.values())}


def enable_compile_cache(path: str | None = None) -> None:
    """Build the port's kernels into and load them from ``path`` (default:
    ``cache.cache_root()/build``): ``_build``'s source-hash cache, which
    outlives the process."""
    from .. import _build
    from ..cache import cache_root

    _build.set_build_dir(path or os.path.join(cache_root(), "build"))


@contextlib.contextmanager
def profiler_trace(path: str | None = None):
    """Context manager: a ``torch.profiler`` trace of the block (CPU, and
    the card where there is one), written as a Chrome trace to
    ``path/trace.json`` (default: a directory under the temporary
    directory)."""
    path = path or os.path.join(tempfile.gettempdir(), "enoki_tpu_torch_trace")
    os.makedirs(path, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def eval_shapes(f: Callable, *args):
    """``f`` run on ``meta`` tensors of the arguments' shapes and dtypes
    (no compute, no memory): its outputs' shapes and dtypes."""
    def meta(l):
        return torch.empty_like(l, device="meta") \
            if isinstance(l, torch.Tensor) else l
    return f(*pytree.tree_map(meta, args))


def vectorization_report(f: Callable, *args) -> Dict[str, Any]:
    """Run ``f(*args)`` once under ``torch.profiler`` and count what would
    take a program off the device (the reference counts a compiled
    module's host round trips, ENOKI_TRACK_SCALAR, fwd.h:208-233):

    * ``fusions``: device kernels (None on the card where the profiler
      captured no device activity);
    * ``custom_calls``: launches of the port's own kernels
      (``_build.LAUNCHES``);
    * ``host_transfers``: reads that wait for the device; on the card, the
      syncs that ``torch.cuda.set_sync_debug_mode("warn")`` reports in the
      call; on the CPU, where nothing waits, the ``aten::item`` /
      ``aten::_local_scalar_dense`` events (a Python number made from a CPU
      tensor on the card's path is no transfer);
    * ``while_loops``: 0 (eager code has none); ``lines``: of the report's
      text (``dump_hlo(..., stage="optimized")``).

    This works through the port's kernels, which ``make_fx`` cannot trace.
    ``syncs`` lists the card's warnings."""
    card = _on_card(args)
    events, _, syncs, launches = _profiled_call(f, args, card)
    fusions = sum(1 for e in events if _is_device_event(e))
    if card and fusions == 0:
        fusions = None  # nothing captured: not measured
    if card:
        transfers = len(syncs)
    else:
        items = [e for e in events if e.name == "aten::_local_scalar_dense"]
        transfers = len(items) or sum(1 for e in events
                                      if e.name == "aten::item")
    return {
        "fusions": fusions,
        "custom_calls": launches,
        "host_transfers": transfers,
        "while_loops": 0,
        "lines": _profile_text(events).count("\n"),
        "syncs": syncs,
    }


def assert_vectorized(f: Callable, *args, allow_custom_calls: int = 0
                      ) -> Dict[str, Any]:
    """Raise unless ``f`` makes no host transfer and launches at most
    ``allow_custom_calls`` of the port's kernels (the ENOKI_TRACK_SCALAR
    regression gate). Returns ``vectorization_report``."""
    rep = vectorization_report(f, *args)
    # explicit raises: bare asserts vanish under python -O
    if rep["host_transfers"] != 0:
        raise AssertionError(f"the call transfers to the host: {rep}")
    if rep["custom_calls"] > allow_custom_calls:
        raise AssertionError(f"unexpected kernel launches: {rep}")
    return rep


from . import checkpoint  # noqa: E402,F401
