"""Lazy trace-recording arrays over a native C++ graph core (counterpart of
enoki_tpu/trace/__init__.py).

The source paper's ``CUDAArray<T>`` (cuda.h:206) is a uint32 handle into a
C++-owned variable table; every op appends a PTX instruction template to a
global trace and nothing executes until ``cuda_eval()`` fuses the live
trace into one megakernel (src/cuda/jit.cu:983-1508). ``LazyArray`` here
is the same architecture: a uint32 handle into the port's own native core
(native/trace.cpp: append, reference counts, dirty tracking, scheduling,
structural hashing), with two ways to evaluate a schedule:

* on the CUDA card, ``codegen``: the schedule is cut into fused runs, and
  each run becomes one generated CUDA C++ kernel (``csrc/trace_kernel.cuh``
  as its skeleton), built with nvcc for sm_90a and cached by the core's
  structural hash, in memory and on disk. Horizontal reductions, prefix
  sums and ``compress`` end a run and run between kernels as the port's
  eager ops, as the source paper breaks its kernel at every cub call
  (src/cuda/horiz.cu);
* on the CPU, ``plain``: one interpreter of the schedule over PyTorch ops,
  which is also the oracle the kernels are held against on the card
  (``plain_eval``).

A CUDA ``LazyArray`` never evaluates through the plain interpreter: a
kernel that fails to build or launch raises. A retrace of the same
program costs only the native appends and one hash lookup, the analog of
the source paper's kernel-cache hit (docs/gpu.rst:268-271).

Device rule: a ``LazyArray`` made from a tensor lives on that tensor's
device; one made from numpy or Python values lives on ``device`` (None:
the CUDA card, or raise without one). Every op's operands must share a
device (scalars coerce to it), and a schedule whose variables span two
devices raises. 64-bit dtypes are real (float64 and int64 numpy input
stays 64-bit); uint32 and uint64 are computed as int64 bit patterns and
leave ``.torch()`` as ``torch.uint32`` / ``torch.uint64``.

The AD tape (``requires_grad``, ``backward``, ``forward_from``, ...) is
``tape``: derivatives are trace programs, fused into the same kernels.
The lazy vectorised call is ``trace.call``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import sys
from typing import Optional

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from .build import load_library, load_pymod

_lib = load_library()
_nat = load_pymod()  # fastcall hot path (same library, see build.py)

# ---------------------------------------------------------------------------
# dtypes and opcodes (shared convention with native/trace.cpp; the native
# side treats opcodes opaquely -- only 0 = evaluated leaf is special)
# ---------------------------------------------------------------------------

_DTYPES = [torch.float32, torch.float64, torch.int32, torch.uint32,
           torch.bool, torch.bfloat16, torch.int64, torch.uint64,
           torch.float16]
_NAMES = ["float32", "float64", "int32", "uint32", "bool", "bfloat16",
          "int64", "uint64", "float16"]
_FLOAT_CODES = (0, 1, 5, 8)  # f32 / f64 / bf16 / f16
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}
_NAME_CODE = {n: i for i, n in enumerate(_NAMES)}
_NAME_CODE["bool_"] = 4
_BOOL = 4
_INT32 = 2


def _code_of(dtype) -> int:
    """The trace's code of a torch dtype, a numpy dtype or type, or a
    dtype name."""
    if isinstance(dtype, torch.dtype):
        return _DTYPE_CODE[dtype]
    if isinstance(dtype, str):
        return _NAME_CODE[dtype]
    if dtype is bool:
        return _BOOL
    if dtype is int:
        return _INT32
    if dtype is float:
        return 0
    return _NAME_CODE[np.dtype(dtype).name]


# unsigned carriers for reinterpreting literal bit patterns per item size
_LIT_CARRIER = {2: np.uint16, 4: np.uint32, 8: np.uint64}
_NP_STORAGE = [np.float32, np.float64, np.int32, np.uint32, np.bool_, None,
               np.int64, np.uint64, np.float16]

_LIT_BITS_CACHE: dict = {}
# (code, value[, signbit]) -> shared size-1 literal LazyArray (see
# LazyArray._coerce); cleared by reset()
_LITERAL_ARRAYS: dict = {}


def _literal_bits(value, code) -> int:
    """Encode a Python scalar as its dtype bit pattern, zero-extended to 64
    bits; bit-exact for every dtype in _DTYPES, -0.0 kept apart from +0.0.
    Cached: scalar constants repeat heavily in traced programs."""
    if isinstance(value, np.floating):
        value = float(value)
    elif isinstance(value, np.integer):
        value = int(value)
    k = (code, value, math.copysign(1.0, value)) \
        if isinstance(value, float) else (code, value)
    b = _LIT_BITS_CACHE.get(k)
    if b is not None:
        return b
    if code == _BOOL:
        b = int(bool(value))
    elif code == 5:  # bfloat16: numpy has none; torch rounds it
        t = torch.tensor(float(value), dtype=torch.float64)
        b = int(t.to(torch.bfloat16).view(torch.int16).item()) & 0xFFFF
    else:
        npdt = np.dtype(_NP_STORAGE[code])
        v = np.asarray(value).astype(npdt)  # wraps/rounds per dtype rules
        b = int(v.view(_LIT_CARRIER[npdt.itemsize]))
    if len(_LIT_BITS_CACHE) < (1 << 16):
        _LIT_BITS_CACHE[k] = b
    return b


class Op:
    """Opcode table (the reference's numbers); ``plain`` and ``codegen``
    give each its meaning."""
    (LEAF, ADD, SUB, MUL, DIV, NEG, ABS, MIN, MAX, FMA, SQRT, RSQRT, RCP,
     FLOOR, CEIL, ROUND, TRUNC, EXP, EXP2, LOG, LOG2, SIN, COS, TAN, ASIN,
     ACOS, ATAN, SINH, COSH, TANH, ERF, ATAN2, POW, MOD, EQ, NE, LT, LE, GT,
     GE, AND, OR, XOR, NOT, SELECT, CAST, IOTA, GATHER, SCATTER, SCATTER_ADD,
     HSUM, HPROD, HMIN, HMAX, ALL, ANY, COUNT, PSUM, REVERSE, SHL, SHR,
     POPCNT, CBRT, SIGN, COPYSIGN, LOG1P, EXPM1, ASINH, ACOSH, ATANH,
     ERFC, LGAMMA, ISNAN, ISINF, ISFINITE, COMPRESS, FMOD,
     BITCAST, CLZ, PRINT) = range(80)
    # the port's own, after the reference's 80 (plain.DIGAMMA): LGAMMA's
    # derivative, recorded only by the tape's programs
    DIGAMMA = 80

# name -> (opcode, arity, out_kind) for the functional API.
# out_kind: None = the inputs' promoted dtype, "float" = float-promoted
# (f32 for integer inputs), "bool" = predicate.
_MATH_OPS = {
    "sqrt": (Op.SQRT, 1, "float"), "rsqrt": (Op.RSQRT, 1, "float"),
    "rcp": (Op.RCP, 1, "float"),
    "floor": (Op.FLOOR, 1, None), "ceil": (Op.CEIL, 1, None),
    "round": (Op.ROUND, 1, None), "trunc": (Op.TRUNC, 1, None),
    "exp": (Op.EXP, 1, "float"), "exp2": (Op.EXP2, 1, "float"),
    "log": (Op.LOG, 1, "float"), "log2": (Op.LOG2, 1, "float"),
    "sin": (Op.SIN, 1, "float"), "cos": (Op.COS, 1, "float"),
    "tan": (Op.TAN, 1, "float"), "asin": (Op.ASIN, 1, "float"),
    "acos": (Op.ACOS, 1, "float"), "atan": (Op.ATAN, 1, "float"),
    "sinh": (Op.SINH, 1, "float"), "cosh": (Op.COSH, 1, "float"),
    "tanh": (Op.TANH, 1, "float"), "erf": (Op.ERF, 1, "float"),
    "abs": (Op.ABS, 1, None), "atan2": (Op.ATAN2, 2, "float"),
    "pow": (Op.POW, 2, None),
    "minimum": (Op.MIN, 2, None), "maximum": (Op.MAX, 2, None),
    "fmadd": (Op.FMA, 3, None), "popcnt": (Op.POPCNT, 1, None),
    "cbrt": (Op.CBRT, 1, "float"), "sign": (Op.SIGN, 1, None),
    "copysign": (Op.COPYSIGN, 2, "float"),
    "log1p": (Op.LOG1P, 1, "float"), "expm1": (Op.EXPM1, 1, "float"),
    "asinh": (Op.ASINH, 1, "float"), "acosh": (Op.ACOSH, 1, "float"),
    "atanh": (Op.ATANH, 1, "float"), "erfc": (Op.ERFC, 1, "float"),
    "lgamma": (Op.LGAMMA, 1, "float"),
    "isnan": (Op.ISNAN, 1, "bool"), "isinf": (Op.ISINF, 1, "bool"),
    "isfinite": (Op.ISFINITE, 1, "bool"),
}

# JAX's type-promotion table over the codes above (jnp.promote_types with
# its default 32-bit mode, enoki_tpu/trace/__init__.py:901), written out:
# torch.promote_types differs (int32 with uint32 gives int64 there)
_PROMOTE = [
    [0, 1, 0, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 1, 2, 2, 2, 5, 6, 1, 8],
    [0, 1, 2, 3, 3, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 1, 5, 5, 5, 5, 5, 5, 0],
    [0, 1, 6, 6, 6, 5, 6, 1, 8],
    [0, 1, 1, 7, 7, 5, 1, 7, 8],
    [0, 1, 8, 8, 8, 0, 8, 8, 8],
]


def _binary_dtype(a_code, b_code):
    return _PROMOTE[a_code][b_code]


# ---------------------------------------------------------------------------
# runtime state on the Python side
# ---------------------------------------------------------------------------

_BUFFERS: dict = {}          # var id -> tensor (materialized, storage dtype)
# (structural key, device, config.max_fused_ops) -> _Compiled
_EXE_CACHE: dict = {}
_CACHE_HITS = 0
_CACHE_MISSES = 0
# PRINT ops: var id -> format string ("{}" placeholders). Consulted when a
# program is compiled; entries are overwritten when a recycled id is
# reused for a new PRINT and cleared by reset().
_PRINT_FMT: dict = {}
# scatter ops pending rebind: scatter var id -> target var id
_SCATTER_TARGET: dict = {}
# target var id -> newest pending scatter into it (chain tail). Consecutive
# scatters into one target CHAIN (each depends on the previous) so a
# k-instance vcall dispatch fuses into one program.
_PENDING_SCATTER: dict = {}
# devices by code: a handle's _dev indexes this list (-1: a device-free
# scalar literal, which takes its schedule's device)
_DEVICES: list = []
# var id -> device code of the non-data variables made by a constructor
# (literal, arange, zeros, full, linspace): with the data leaves'
# buffers, what decides a schedule's device
_DEVICE: dict = {}
# structure-probe depth: while > 0, scatter/printf record pure ops (no
# side effects, no flush evals); see structure_probe
_PROBE_DEPTH = 0
# the device types whose schedules run as fused kernels (the others
# through the plain interpreter); a rehearsal on the CPU adds "cpu" and
# builds the kernels with the host's compiler
_KERNEL_DEVICES = ("cuda",)
# the _build.LAUNCHES name the fused kernels count under: the tape's
# adjoint and tangent programs count as "trace_vjp" / "trace_jvp"
_LAUNCH_NAME = "trace"


def _dev_code(device) -> int:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        return _DEVICES.index(device)
    except ValueError:
        _DEVICES.append(device)
        return len(_DEVICES) - 1


@contextlib.contextmanager
def structure_probe():
    """Trace a callee for its result STRUCTURE only: inside this context
    scatter/printf register no side effects and trigger no evals."""
    global _PROBE_DEPTH
    _PROBE_DEPTH += 1
    try:
        yield
    finally:
        _PROBE_DEPTH -= 1


def cache_stats():
    """(hits, misses) of the structural-hash kernel cache."""
    return _CACHE_HITS, _CACHE_MISSES


def clear_cache():
    """Drop the in-memory cache (a later process, as far as it sees: the
    disk cache stays)."""
    global _CACHE_HITS, _CACHE_MISSES
    _EXE_CACHE.clear()
    _CACHE_HITS = 0
    _CACHE_MISSES = 0


def reset():
    """Drop the whole trace state (tests)."""
    # invalidate shared literal handles BEFORE the native reset so their
    # deallocs don't dec-ref recycled ids later
    for r in _LITERAL_ARRAYS.values():
        r.index = 0
    _LITERAL_ARRAYS.clear()
    _BUFFERS.clear()
    _PRINT_FMT.clear()
    _SCATTER_TARGET.clear()
    _PENDING_SCATTER.clear()
    _DEVICE.clear()
    tape.reset()
    clear_cache()
    callmod = sys.modules.get(__name__ + ".call")
    if callmod is not None:
        callmod.clear_partition_cache()
    _lib.ett_reset()
    # the C-side shared-literal cache after the native reset: its ids
    # were dropped wholesale by ett_reset, so no dec-refs here
    _nat.lit_cache_clear()


def set_log_level(level: int):
    """0-5 like cuda_set_log_level (cuda.h:195-200)."""
    _lib.ett_set_log_level(level)


def whos() -> str:
    """Live-variable table (cuda_whos, jit.cu:1564-1634)."""
    buf = ctypes.create_string_buffer(1 << 20)
    _lib.ett_whos(buf, len(buf))
    return buf.value.decode()


def stats() -> dict:
    vals = [ctypes.c_uint64() for _ in range(5)]
    _lib.ett_stats(*[ctypes.byref(v) for v in vals])
    keys = ["n_vars", "n_appends", "n_evals", "n_freed", "peak_vars"]
    d = dict(zip(keys, [v.value for v in vals]))
    d["cache_hits"], d["cache_misses"] = cache_stats()
    return d


# ---------------------------------------------------------------------------
# evaluation: native schedule -> plain interpreter (CPU) or fused kernels
# (CUDA), cached by the structural hash
# ---------------------------------------------------------------------------


class _Compiled:
    """Everything derived from one schedule structure on one device: the
    entries, the outputs, the print formats and, on the card, the
    kernels (``codegen.Plan``)."""

    __slots__ = ("entries", "out_positions", "fmts", "plan", "lit_key",
                 "lit_dev")

    def __init__(self, entries, out_positions, fmts):
        self.entries = entries
        self.out_positions = out_positions
        self.fmts = fmts
        self.plan = None
        # the literal stream of the last eval on the card, keyed by its
        # raw (bits, codes) bytes: a cache hit with the same literals (the
        # common case) uploads nothing
        self.lit_key = None
        self.lit_dev = None


def _read_schedule(n_entries):
    """Bulk schedule fetch (one C call + numpy views)."""
    n = max(n_entries, 1)
    u32, i32, u64 = ctypes.c_uint32, ctypes.c_int32, ctypes.c_uint64
    ids_b = (u32 * n)()
    opc_b = (i32 * n)()
    dtc_b = (i32 * n)()
    siz_b = (u64 * n)()
    dep_b = (u32 * (4 * n))()
    lit_b = (u64 * n)()
    flg_b = (ctypes.c_uint8 * n)()
    got = _lib.ett_schedule_read(ids_b, opc_b, dtc_b, siz_b, dep_b, lit_b,
                                 flg_b, n)
    if got != n_entries:
        raise RuntimeError(f"schedule read mismatch: {got} != {n_entries}")
    ids = np.frombuffer(ids_b, np.uint32, n_entries).tolist()
    opcs = np.frombuffer(opc_b, np.int32, n_entries).tolist()
    dtcs = np.frombuffer(dtc_b, np.int32, n_entries).tolist()
    sizes = np.frombuffer(siz_b, np.uint64, n_entries).tolist()
    deps = np.frombuffer(dep_b, np.uint32,
                         4 * n_entries).reshape(-1, 4).tolist()
    lits = np.frombuffer(lit_b, np.uint64, n_entries).tolist()
    flags = np.frombuffer(flg_b, np.uint8, n_entries).tolist()
    entries = [(ids[i], opcs[i], dtcs[i], sizes[i], tuple(deps[i]),
                lits[i], flags[i] & 1, flags[i] >> 1)
               for i in range(n_entries)]
    n_out = _lib.ett_schedule_num_outputs()
    outs = [_lib.ett_schedule_output(i) for i in range(n_out)]
    return entries, outs


def _collect_literals(n):
    """The current schedule's literals, in schedule order: (bits, codes),
    each literal its dtype's bit pattern zero-extended to 64 bits."""
    cap = max(n, 1)
    bbuf = (ctypes.c_uint64 * cap)()
    cbuf = (ctypes.c_int32 * cap)()
    n_lit = _lib.ett_schedule_literals(bbuf, cbuf, cap)
    return (np.frombuffer(bbuf, np.uint64, n_lit).copy(),
            np.frombuffer(cbuf, np.int32, n_lit).copy())


def _schedule_device(n, leaves):
    """The one device of the current schedule: its data leaves' and its
    constructed variables' (``_DEVICE``); raises if they span two."""
    devs = {b.device for b in leaves}
    if _DEVICE:
        buf = (ctypes.c_uint32 * max(n, 1))()
        _lib.ett_schedule_ids(buf, n)
        ids = np.frombuffer(buf, np.uint32, n)
        keys = np.fromiter(_DEVICE, np.uint32, len(_DEVICE))
        for i in ids[np.isin(ids, keys)].tolist():
            devs.add(_DEVICES[_DEVICE[i]])
    if len(devs) > 1:
        raise ValueError(f"a trace schedule spans two devices: "
                         f"{sorted(map(str, devs))}; evaluate each "
                         "device's arrays on their own")
    return devs.pop() if devs else resolve_device(None)


def _schedule(ids):
    """Schedule ``ids`` (plus pending side effects) in the native core and
    find its compiled record: (n entries, key, record, data leaf ids, data
    leaves, device, the entries if they were read). Counts a cache hit or
    miss."""
    global _CACHE_HITS, _CACHE_MISSES
    from ..config import config
    arr = (ctypes.c_uint32 * max(len(ids), 1))(*ids)
    n = _lib.ett_schedule(arr, len(ids))
    key = _lib.ett_schedule_hash()
    entries = out_positions = None
    if _PRINT_FMT:
        # format strings are not part of the native structural hash: while
        # prints are live, the ordered format signature joins the key, so
        # two structurally equal programs with different formats never
        # share a compiled program
        entries, out_positions = _read_schedule(n)
        sig = tuple(_PRINT_FMT[e[0]] for e in entries
                    if e[1] == Op.PRINT and e[0] in _PRINT_FMT)
        if sig:
            key = (key, sig)
    buf = (ctypes.c_uint32 * max(n, 1))()
    n_data = _lib.ett_schedule_data_ids(buf, n)
    leaf_vids = buf[:n_data]
    leaves = [_BUFFERS[v] for v in leaf_vids]
    device = _schedule_device(n, leaves)
    ckey = (key, device, config.max_fused_ops)
    comp = _EXE_CACHE.get(ckey)
    if comp is None:
        _CACHE_MISSES += 1
        if entries is None:
            entries, out_positions = _read_schedule(n)
        fmts = {e[0]: _PRINT_FMT.get(e[0], "{}")
                for e in entries if e[1] == Op.PRINT}
        comp = _Compiled(entries, out_positions, fmts)
        _EXE_CACHE[ckey] = comp
    else:
        _CACHE_HITS += 1
    return n, key, comp, leaf_vids, leaves, device, entries


def _plan(comp, key):
    """The record's fused kernels (``codegen.Plan``), made on first use."""
    from ..config import config
    from . import codegen
    if comp.plan is None:
        comp.plan = codegen.Plan(comp.entries, comp.out_positions, comp.fmts,
                                 config.max_fused_ops,
                                 key if isinstance(key, int) else None)
    return comp.plan


def _run(comp, key, device, leaves, bits, codes):
    """The schedule's outputs: the fused kernels on the card, the plain
    interpreter on the CPU."""
    if device.type in _KERNEL_DEVICES:
        plan = _plan(comp, key)
        lk = (bits.tobytes(), codes.tobytes())
        if comp.lit_key != lk or comp.lit_dev is None \
                or comp.lit_dev.device != device:
            comp.lit_dev = torch.from_numpy(bits.view(np.int64)).to(device)
            comp.lit_key = lk
        return plan.run(leaves, comp.lit_dev, bits, codes, device,
                        counter=_LAUNCH_NAME)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}: cuda, or cpu for "
                         "the plain interpreter")
    from . import plain
    return plain.run(comp.entries, comp.out_positions, leaves, bits, codes,
                     comp.fmts, device)


def _eval_ids(ids):
    """Evaluate the given variable ids (plus pending side effects), in the
    span ``enoki.trace.eval``; the schedule, its hash and the kernel
    cache's look-up in ``enoki.trace.schedule`` inside it. A miss's build
    is in ``enoki.build.<phase>``, the kernels' launches in
    ``enoki.launch.trace``."""
    with _build.span("trace.eval"):
        _eval_schedule(ids)


def _eval_schedule(ids):
    ids = [i for i in dict.fromkeys(ids) if not _nat.materialized(i)]
    if not ids and _lib.ett_num_side_effects() == 0:
        return
    with _build.span("trace.schedule"):
        n, key, comp, leaf_vids, leaves, device, entries = _schedule(ids)
        bits, codes = _collect_literals(n)
        buf = (ctypes.c_uint32 * max(n, 1))()
        n_out = _lib.ett_schedule_output_ids(buf, n)
        out_vids = [buf[i] for i in range(n_out)]

    results = _run(comp, key, device, leaves, bits, codes)

    if entries is not None:
        # a fired PRINT is consumed: its var materializes and the op never
        # runs again, so its format entry goes
        for e in entries:
            if e[1] == Op.PRINT:
                _PRINT_FMT.pop(e[0], None)

    # the AD tape: a program that touches the differentiable frontier is
    # kept as a segment, so backward() / forward_from() can replay its
    # derivatives after its values were materialized (autodiff.h:126)
    ad_active = tape.active()
    if ad_active:
        tape.record(comp, key, leaf_vids, leaves, bits, codes, out_vids,
                    device)

    # store outputs; scatter results rebind their TARGET's buffer (the
    # dirty-flag protocol, jit.cu:674,719-730). Two passes: plain slots
    # first, scatter rebinds second -- a computed var that is itself a
    # scatter target appears AFTER its scatter among the outputs, and the
    # rebind (the program-order-final state) must win.
    rebinds = []
    for vid, r in zip(out_vids, results):
        if vid == 0:
            continue
        tgt = _SCATTER_TARGET.pop(vid, None)
        _BUFFERS[vid] = r
        _lib.ett_set_materialized(vid)
        if tgt is not None:
            rebinds.append((vid, tgt, r))
    for vid, tgt, r in rebinds:
        if _lib.ett_var_exists(tgt):
            _BUFFERS[tgt] = r
            _lib.ett_set_materialized(tgt)
            _lib.ett_set_data(tgt)  # literal targets now hold data
        if ad_active:
            tape.rebind(tgt, vid)
        _lib.ett_dec_ref_ext(vid)  # release the pending-rebind claim
    _lib.ett_clear_side_effects()
    _PENDING_SCATTER.clear()  # every pending scatter was a schedule root
    # drop buffers and device records of vars the native side has freed
    for table in (_BUFFERS, _DEVICE):
        for vid in list(table):
            if not _lib.ett_var_exists(vid):
                del table[vid]


def eval(*arrays) -> None:  # noqa: A001  (mirrors enoki's cuda_eval name)
    """Force evaluation of the given LazyArrays. With no arguments,
    evaluates EVERY live variable plus all pending side effects --
    cuda_eval()'s no-target semantics (jit.cu:1418-1428)."""
    if arrays:
        _eval_ids([a.index for a in arrays])
        return
    _eval_ids(_live_ids())


def _live_ids():
    cap = _lib.ett_num_vars()
    buf = (ctypes.c_uint32 * max(cap, 1))()
    m = _lib.ett_live_vars(buf, cap)
    return [buf[i] for i in range(m)]


def prepare(*arrays):
    """Compile the kernels that evaluating ``arrays`` would run, without
    running them; returns the schedule's ``codegen.Plan`` (None on the
    CPU). ``plan.library()`` builds it (nvcc), in a thread if need be:
    the setup of a program that builds many structures builds them
    concurrently. It counts as an eval in ``cache_stats``; the eval that
    follows is a hit."""
    ids = [a.index for a in arrays if not a.materialized]
    if not ids and _lib.ett_num_side_effects() == 0:
        return None  # as _eval_ids: pending scatters are evaluated too
    _, key, comp, _, _, device, _ = _schedule(ids)
    if device.type not in _KERNEL_DEVICES:
        return None
    return _plan(comp, key)


def plain_eval(*arrays):
    """The plain interpreter's values of ``arrays`` on their own device
    (storage dtypes), evaluating nothing in the trace: the oracle that the
    fused kernels are held against on the card. A dirty array's value is
    its pending scatter's; prints in the schedule print."""
    from . import plain
    ids = [_PENDING_SCATTER.get(a.index, a.index) for a in arrays]
    if not ids:
        return []
    arr = (ctypes.c_uint32 * len(ids))(*ids)
    n = _lib.ett_schedule(arr, len(ids))
    entries, out_positions = _read_schedule(n)
    buf = (ctypes.c_uint32 * max(n, 1))()
    n_data = _lib.ett_schedule_data_ids(buf, n)
    leaves = [_BUFFERS[buf[i]] for i in range(n_data)]
    device = _schedule_device(n, leaves)
    bits, codes = _collect_literals(n)
    fmts = {e[0]: _PRINT_FMT.get(e[0], "{}")
            for e in entries if e[1] == Op.PRINT}
    outs = plain.run(entries, out_positions, leaves, bits, codes, fmts,
                     device)
    return outs[:len(ids)]


# ---------------------------------------------------------------------------
# LazyArray
# ---------------------------------------------------------------------------


def _as_tensor(value, device):
    """A 1-D tensor of one of the trace's dtypes: a tensor keeps its
    device; numpy and Python values go to ``device`` (None: the card, or
    raise), keeping 64-bit types."""
    if isinstance(value, torch.Tensor):
        x = value
    else:
        a = np.asarray(value)
        dev = resolve_device(device)
        if a.dtype.name == "bfloat16":  # a numpy array of ml_dtypes'
            x = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
            x = x.view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.ascontiguousarray(a))
        x = x.to(dev)
    if x.dim() == 0:
        x = x.reshape(1)
    if x.dim() != 1:
        raise ValueError("LazyArray is 1-D (the flat-index JIT model)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"LazyArray holds {', '.join(_NAMES)}, not "
                        f"{x.dtype}")
    return x.contiguous()


def _shared_literal(code, value):
    """The shared, device-free size-1 literal of ``value`` in ``code``: one
    native var per (dtype, value), -0.0 keyed apart from +0.0."""
    if value:
        k = (code, value)
    else:
        k = (code, value, math.copysign(1.0, value)) \
            if isinstance(value, float) else (code, value)
    r = _LITERAL_ARRAYS.get(k)
    if r is not None:
        return r
    r = LazyArray.__new__(LazyArray)
    r.index = _nat.literal(code, _literal_bits(value, code), 1)
    r._size = 1
    r._code = code
    r._dev = -1
    if value == value and len(_LITERAL_ARRAYS) < (1 << 14):
        _LITERAL_ARRAYS[k] = r
    return r


class LazyArray(_nat.VarBase):
    """Lazy 1-D array handle (the FloatC analog, cuda.h:206).

    Operations record into the native trace; nothing runs until eval() /
    numpy() / torch() / item access forces the fused program.

    The handle state (index, _size, _code, _dev) lives in the C base type
    as raw ints, and the base's dealloc releases the native variable
    reference. A freshly allocated instance has index == 0, which dealloc
    treats as detached; ``reset()`` uses the same convention to neuter the
    shared literal handles.
    """

    __slots__ = ()

    def __init__(self, value=None, index: Optional[int] = None,
                 _size: Optional[int] = None, _code: Optional[int] = None,
                 device=None, _dev: int = -1):
        if index is not None:
            self.index = index
            self._size = _size if _size is not None \
                else int(_lib.ett_var_size(index))
            self._code = _code if _code is not None \
                else _lib.ett_var_dtype(index)
            self._dev = _dev
            return
        x = _as_tensor(value, device)
        self._code = _DTYPE_CODE[x.dtype]
        self._size = x.shape[0]
        self._dev = _dev_code(x.device)
        self.index = _nat.data(self._code, self._size)
        _BUFFERS[self.index] = x

    # -- construction ------------------------------------------------------

    @staticmethod
    def literal(value, size=1, dtype=torch.float32, device=None):
        code = _code_of(dtype)
        dev = _dev_code(resolve_device(device))
        idx = _lib.ett_literal(code, _literal_bits(value, code), size)
        _DEVICE[idx] = dev
        return LazyArray(index=idx, _size=size, _code=code, _dev=dev)

    @staticmethod
    def arange(n, dtype=torch.int32, device=None):
        code = _code_of(dtype)
        dev = _dev_code(resolve_device(device))
        idx = _lib.ett_append(Op.IOTA, code, n, 0, 0, 0, 0)
        _DEVICE[idx] = dev
        return LazyArray(index=idx, _size=n, _code=code, _dev=dev)

    @staticmethod
    def zeros(n, dtype=torch.float32, device=None):
        return LazyArray.literal(0, n, dtype, device)

    @staticmethod
    def full(value, n, dtype=torch.float32, device=None):
        return LazyArray.literal(value, n, dtype, device)

    @staticmethod
    def linspace(lo, hi, n, dtype=torch.float32, device=None):
        i = LazyArray.arange(n, dtype, device).cast(dtype)
        step = (hi - lo) / max(n - 1, 1)
        return i * LazyArray.literal(step, 1, dtype, device) + \
            LazyArray.literal(lo, 1, dtype, device)

    # -- bookkeeping -------------------------------------------------------

    def __len__(self):
        return self._size

    @property
    def size(self):
        return len(self)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self._code]

    @property
    def shape(self):
        return (self._size,)

    @property
    def device(self):
        """The array's device (None for a device-free scalar literal)."""
        return _DEVICES[self._dev] if self._dev >= 0 else None

    @property
    def materialized(self):
        return bool(_nat.materialized(self.index))

    def label(self, name: str) -> "LazyArray":
        """set_label analog (cuda.h:957) -- names show up in whos()."""
        _lib.ett_set_label(self.index, name.encode())
        return self

    def __repr__(self):
        state = "materialized" if self.materialized else "lazy"
        return (f"LazyArray(id={self.index}, size={len(self)}, "
                f"dtype={_NAMES[self._code]}, device={self.device}, "
                f"{state})")

    # -- op recording ------------------------------------------------------

    def _ensure_clean(self):
        """Reading a scatter target forces eval first (jit.cu:719-730)."""
        if _nat.is_dirty(self.index):
            _eval_ids([self.index])

    @staticmethod
    def _record(opcode, dtype_code, size, *dep_arrays, raw=False):
        devs = {d._dev for d in dep_arrays if d._dev >= 0}
        if len(devs) > 1:
            raise ValueError("trace op on arrays of two devices: "
                             f"{sorted(str(_DEVICES[d]) for d in devs)}")
        deps = [d.index for d in dep_arrays] + [0] * (4 - len(dep_arrays))
        idx = _nat.append(opcode, dtype_code, size, deps[0], deps[1],
                          deps[2], deps[3], int(raw))
        if idx == -1:  # dirty dep: eval the pending scatter, retry once
            for d in dep_arrays:
                d._ensure_clean()
            idx = _nat.append(opcode, dtype_code, size, deps[0], deps[1],
                              deps[2], deps[3], int(raw))
        if idx == 0:
            sizes = [len(d) for d in dep_arrays]
            raise ValueError(f"incompatible sizes for trace op: {sizes}")
        if idx == -1:
            raise RuntimeError(
                "trace append failed twice on a dirty dependency -- a "
                "pending scatter could not be flushed")
        r = LazyArray.__new__(LazyArray)
        r.index = idx
        r._size = size
        r._code = dtype_code
        r._dev = devs.pop() if devs else -1
        return r

    def _coerce(self, other):
        if isinstance(other, LazyArray):
            return other
        if isinstance(other, (int, float, bool)):
            return _shared_literal(self._code, other)
        if isinstance(other, torch.Tensor):
            return LazyArray(other)
        return LazyArray(other, device=self.device)

    def _bin(self, other, opcode, out_dtype=None, swap=False):
        if type(other) is not LazyArray:
            other = self._coerce(other)
        a, b = (other, self) if swap else (self, other)
        r = _nat.binop(a, b, opcode, -1 if out_dtype is None else out_dtype)
        if r is not None:
            return r
        # slow path: dirty dependency (flush + retry), broadcast error or
        # operands on two devices
        dc = _PROMOTE[a._code][b._code] if out_dtype is None else out_dtype
        sa, sb = a._size, b._size
        size = sa if sa >= sb else sb
        return LazyArray._record(opcode, dc, size, a, b)

    def _unary(self, opcode, out_dtype=None):
        r = _nat.unop(self, opcode, -1 if out_dtype is None else out_dtype)
        if r is not None:
            return r
        dc = self._code if out_dtype is None else out_dtype
        return LazyArray._record(opcode, dc, self._size, self)

    _BOOL = _BOOL

    __hash__ = None

    def cast(self, dtype):
        return self._unary(Op.CAST, _code_of(dtype))

    # jnp- and torch-style aliases, so that source written for tensors
    # (the port's eager ops) instantiates for LazyArrays as it stands:
    # ``.astype(dt)``, ``.to(dt)`` and ``.bool()`` cast, ``.view(dt)``
    # reinterprets the bits
    astype = cast

    def to(self, dtype):
        """``cast`` (a device or other argument is not a dtype: raise)."""
        if not isinstance(dtype, torch.dtype):
            raise TypeError("LazyArray.to takes a dtype; a LazyArray's "
                            "device is fixed when it is made")
        return self.cast(dtype)

    def bool(self):
        return self.cast(torch.bool)

    def view(self, dtype):
        return self.bitcast(dtype)

    def bitcast(self, dtype):
        """Reinterpret the bits as ``dtype`` (same itemsize)."""
        code = _code_of(dtype)
        if _DTYPES[code].itemsize != self.dtype.itemsize:
            raise TypeError(
                f"bitcast {self.dtype} -> {_DTYPES[code]}: itemsize must "
                "match (a narrowing bitcast would break the 1-D flat-index "
                "model)")
        return self._unary(Op.BITCAST, code)

    # -- horizontal ops: they end a fused run and run between kernels ------

    def hsum(self):
        return LazyArray._record(Op.HSUM, self._code, 1, self)

    def hprod(self):
        return LazyArray._record(Op.HPROD, self._code, 1, self)

    def hmin(self):
        return LazyArray._record(Op.HMIN, self._code, 1, self)

    def hmax(self):
        return LazyArray._record(Op.HMAX, self._code, 1, self)

    def all(self):
        return LazyArray._record(Op.ALL, _BOOL, 1, self)

    def any(self):
        return LazyArray._record(Op.ANY, _BOOL, 1, self)

    def count(self):
        return LazyArray._record(Op.COUNT, _INT32, 1, self)

    def psum(self):
        return LazyArray._record(Op.PSUM, self._code, len(self), self)

    def compress(self, mask: "LazyArray"):
        """(packed, count): lanes where mask holds, packed to the front in
        order; remainder zero-filled (cuda_compress, horiz.cu:158, with
        ops.compress's static-shape contract)."""
        packed = LazyArray._record(Op.COMPRESS, self._code, len(self),
                                   self, mask)
        return packed, mask.count()

    def reverse(self):
        return LazyArray._record(Op.REVERSE, self._code, len(self), self)

    # -- gather / scatter --------------------------------------------------

    def gather(self, index: "LazyArray"):
        """self[index], the index clamped into range (``mode="clip"``) --
        forces eval of self first if it is dirty."""
        self._ensure_clean()
        index = self._coerce(index)
        return LazyArray._record(Op.GATHER, self._code, len(index), self,
                                 index, raw=True)

    def _scatter_op(self, opcode, index, value):
        if _PROBE_DEPTH:
            # structure probe: a scatter contributes nothing to the result
            # STRUCTURE (scatter()/scatter_add() return self)
            return self
        callmod = sys.modules.get(__name__ + ".call")
        if callmod is not None:
            # a scatter invalidates a cached partition of the target now:
            # an unrelated eval would clear the dirty flag before the next
            # partition()
            callmod._cache_pop(self.index)
        index = self._coerce(index)
        value = self._coerce(value)
        from ..config import config
        if config.debug_bounds:
            # a negative index wraps (numpy-style) before out-of-range
            # lanes drop; in debug mode it goes to the dropped slot
            index = select(index < index._coerce(0),
                           index._coerce(len(self)), index)
        index._ensure_clean()
        value._ensure_clean()
        # write-after-pending-read: unevaluated ops that READ this target
        # must materialize against the PRE-scatter value first (a coarse
        # flush of every live var)
        if (self.index not in _PENDING_SCATTER
                and _lib.ett_var_int_ref(self.index) > 0):
            eval()
        base = _PENDING_SCATTER.get(self.index, self.index)
        devs = {d._dev for d in (self, index, value) if d._dev >= 0}
        if len(devs) > 1:
            raise ValueError("scatter on arrays of two devices")
        idx = _lib.ett_append_raw(opcode, self._code, len(self), base,
                                  index.index, value.index, 0)
        if idx == 0:
            raise ValueError("scatter: invalid operands")
        op = LazyArray(index=idx, _size=len(self), _code=self._code,
                       _dev=devs.pop() if devs else -1)
        _lib.ett_mark_side_effect(op.index, self.index)
        prev = _PENDING_SCATTER.get(self.index)
        if prev is not None:
            # the superseded link no longer rebinds nor needs its own
            # output buffer; the tail's dep keeps it alive
            _SCATTER_TARGET.pop(prev, None)
            _lib.ett_unmark_side_effect(prev)
            _lib.ett_dec_ref_ext(prev)
        _SCATTER_TARGET[op.index] = self.index
        _PENDING_SCATTER[self.index] = op.index
        # keep the scatter result's buffer claim alive until eval rebinds
        _lib.ett_inc_ref_ext(op.index)
        return op

    def scatter(self, index, value):
        """enoki scatter: self[index] = value, lazily; self goes dirty. A
        negative index counts from the end, an index out of range after
        that writes nothing."""
        self._scatter_op(Op.SCATTER, index, value)
        return self

    def scatter_add(self, index, value):
        """Conflict-safe accumulation (atom.global.add analog, cuda.h:893),
        with scatter's index rule. A bool target raises ``TypeError``, as
        JAX's ``x.at[i].add`` does for bool, the reference's route; the
        reference raises when it evaluates the scatter, this when it is
        recorded."""
        if self._code == _BOOL:
            raise TypeError("scatter_add does not accept dtype bool: a "
                            "bool target has no addition (JAX's "
                            "x.at[i].add refuses it too)")
        self._scatter_op(Op.SCATTER_ADD, index, value)
        return self

    # -- materialization ---------------------------------------------------

    def eval(self) -> "LazyArray":
        _eval_ids([self.index])
        return self

    def torch(self) -> torch.Tensor:
        """The value as a 1-D tensor on the array's device (the
        reference's ``.jax()``)."""
        self._ensure_clean()
        if not self.materialized:
            self.eval()
        return _BUFFERS[self.index]

    def numpy(self) -> np.ndarray:
        """The value as numpy (bfloat16 as float32: numpy has no bfloat16
        without ml_dtypes)."""
        t = self.torch().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __getitem__(self, i):
        """Single-element fetch forces eval (cuda_fetch_element,
        jit.cu:1520)."""
        return self.numpy()[i]


# ---------------------------------------------------------------------------
# Operator wiring: the dunders call the C fast path (pymod.cpp binop/unop)
# and fall back to _bin/_unary for scalar coercion, dirty-flush retries,
# broadcast errors and operands of two devices.
# ---------------------------------------------------------------------------

_nat.set_class(LazyArray, [c for row in _PROMOTE for c in row],
               len(_DTYPES))


def _bin_dunder(opcode, out_code=-1, swap=False):
    out_dtype = None if out_code < 0 else out_code
    if swap:
        def op(self, other):
            return self._bin(other, opcode, out_dtype, swap=True)
    else:
        def op(self, other):
            r = _nat.binop(self, other, opcode, out_code)
            if r is not None:
                return r
            if type(other) is not LazyArray:
                other = self._coerce(other)
            return self._bin(other, opcode, out_dtype)
    return op


def _un_dunder(opcode):
    def op(self):
        r = _nat.unop(self, opcode, -1)
        return r if r is not None else self._unary(opcode)
    return op


for _n, _o in [("__add__", Op.ADD), ("__sub__", Op.SUB), ("__mul__", Op.MUL),
               ("__truediv__", Op.DIV), ("__mod__", Op.MOD),
               ("__pow__", Op.POW), ("__and__", Op.AND), ("__or__", Op.OR),
               ("__xor__", Op.XOR), ("__lshift__", Op.SHL),
               ("__rshift__", Op.SHR)]:
    setattr(LazyArray, _n, _bin_dunder(_o))
for _n, _o in [("__radd__", Op.ADD), ("__rsub__", Op.SUB),
               ("__rmul__", Op.MUL), ("__rtruediv__", Op.DIV)]:
    setattr(LazyArray, _n, _bin_dunder(_o, swap=True))
for _n, _o in [("__eq__", Op.EQ), ("__ne__", Op.NE), ("__lt__", Op.LT),
               ("__le__", Op.LE), ("__gt__", Op.GT), ("__ge__", Op.GE)]:
    setattr(LazyArray, _n, _bin_dunder(_o, out_code=_BOOL))
for _n, _o in [("__neg__", Op.NEG), ("__abs__", Op.ABS),
               ("__invert__", Op.NOT)]:
    setattr(LazyArray, _n, _un_dunder(_o))
del _n, _o


def _scalar_literal(v) -> "LazyArray":
    """Scalar -> device-free size-1 literal, with numpy-scalar coercion."""
    if isinstance(v, (bool, np.bool_)):
        code = _BOOL
    elif isinstance(v, (int, np.integer)):
        code = _INT32
    elif isinstance(v, (float, np.floating)):
        code = 0
    else:
        raise TypeError(
            f"select: cannot coerce {type(v).__name__} operand -- pass a "
            "LazyArray or a Python/numpy scalar")
    return LazyArray(index=_nat.literal(code, _literal_bits(v, code), 1),
                     _size=1, _code=code)


def select(mask: LazyArray, a, b):
    """Lazy select(mask, a, b). Python-scalar operands coerce against the
    other *value* operand's dtype -- never the mask's bool dtype, which
    would collapse select(m, 5.0, x) to a bool literal."""
    ref = a if isinstance(a, LazyArray) else \
        b if isinstance(b, LazyArray) else None
    if ref is not None:
        a, b = ref._coerce(a), ref._coerce(b)
    else:
        a = _scalar_literal(a)
        b = _scalar_literal(b)
    dc = _binary_dtype(a._code, b._code)
    return LazyArray._record(Op.SELECT, dc, max(len(mask), len(a), len(b)),
                             mask, a, b)


def _out_code(in_code, kind):
    if kind == "bool":
        return _BOOL
    if kind == "float" and in_code not in _FLOAT_CODES:
        return 0  # integer inputs float-promote to f32
    return in_code


def _make_math(name, opcode, arity, kind=None):
    if arity == 1:
        def f(x):
            return x._unary(opcode, _out_code(x._code, kind))
    elif arity == 2:
        def f(x, y):
            y = x._coerce(y)
            dc = _out_code(_binary_dtype(x._code, y._code), kind)
            return x._bin(y, opcode, out_dtype=dc)
    else:
        def f(x, y, z):
            y = x._coerce(y)
            z = x._coerce(z)
            dc = _out_code(_binary_dtype(_binary_dtype(x._code, y._code),
                                         z._code), kind)
            return LazyArray._record(opcode, dc,
                                     max(len(x), len(y), len(z)), x, y, z)
    f.__name__ = name
    f.__doc__ = f"Lazy {name} (records Op.{name.upper()} into the trace)."
    return f


for _name, (_op, _ar, _kind) in _MATH_OPS.items():
    globals()[_name] = _make_math(_name, _op, _ar, _kind)
del _name, _op, _ar, _kind


def sincos(x):
    """(sin, cos) pair (array_math.h sincos)."""
    return sin(x), cos(x)  # noqa: F821


def bitcast(x, dtype):
    """Lazy bit reinterpretation (ops.reinterpret analog)."""
    return x.bitcast(dtype)


def printf(fmt: str, *arrays: "LazyArray") -> "LazyArray":
    """In-trace printf: record a PRINT op (the cuda_printf analog,
    array_router.h:972 / jit.cu:863-916) without breaking fusion: on the
    card its operands become extra outputs of the fused kernel, printed
    by the host after the launch, in schedule order.

    ``fmt`` uses "{}" placeholders, each replaced by an operand as numpy
    prints it ("t={}"); 1-3 array operands. Returns the first operand
    PASSED THROUGH the print op -- use the returned handle downstream to
    anchor where in the program the print fires. An unused print is still
    a pending side effect: the next ``eval()`` runs it. Format strings
    join the kernel-cache key while prints are live, and such programs
    are not written to the disk cache.
    """
    if not arrays or len(arrays) > 3:
        raise ValueError("printf takes 1-3 array operands")
    if not isinstance(fmt, str):
        raise TypeError("printf format must be a string")
    for a in arrays:
        if not isinstance(a, LazyArray):
            raise TypeError("printf operands must be LazyArrays "
                            "(coerce scalars with x._coerce first)")
    x = arrays[0]
    if _PROBE_DEPTH:
        return x
    # read-after-scatter: a dirty operand materializes first
    for a in arrays:
        a._ensure_clean()
    devs = {a._dev for a in arrays if a._dev >= 0}
    if len(devs) > 1:
        raise ValueError("printf of arrays on two devices")
    deps = [a.index for a in arrays] + [0] * (3 - len(arrays))
    idx = _lib.ett_append_raw(Op.PRINT, x._code, len(x), *deps, 0)
    if idx == 0:
        raise ValueError("printf: invalid operands")
    out = LazyArray(index=idx, _size=len(x), _code=x._code,
                    _dev=devs.pop() if devs else -1)
    _PRINT_FMT[out.index] = fmt
    # retained like a scatter: fires at the next eval even if the
    # returned handle is dropped (target 0 = nothing becomes dirty)
    _lib.ett_mark_side_effect(out.index, 0)
    return out


def clz(x):
    """Lazy leading-zero count (lzcnt, array_fallbacks.h:259)."""
    return x._unary(Op.CLZ)


def fmod(x, y):
    """C fmod: remainder with the sign of the dividend (std::fmod).
    Distinct from ``x % y`` (floored)."""
    return x._bin(y, Op.FMOD)


def clamp(x, lo, hi):
    """min(max(x, lo), hi) as trace ops (array_math.h:1352)."""
    return minimum(maximum(x, lo), hi)  # noqa: F821


def lerp(a, b, t):
    """Endpoint-exact interpolation t*b + (a - t*a) (array_math.h:1357)."""
    ref = next(v for v in (a, b, t) if isinstance(v, LazyArray))
    a, b, t = ref._coerce(a), ref._coerce(b), ref._coerce(t)
    return t * b + (a - t * a)


# the AD tape (imported last: it builds on everything above)
from . import tape  # noqa: E402
from .tape import (_GRAD_ENABLED, _GRADS, _ON_TAPE, _PRODUCER,  # noqa: E402
                   _TAPE, _VERSION, backward, clear_gradients, clear_tape,
                   forward_from, grad_enabled, gradient, requires_grad,
                   tape_graphviz, tape_whos)

__all__ = ["LazyArray", "select", "eval", "whos", "stats", "cache_stats",
           "clear_cache", "reset", "set_log_level", "Op", "requires_grad",
           "grad_enabled", "gradient", "clear_gradients", "backward",
           "forward_from", "isnan", "isinf", "isfinite", "clamp",
           "lerp", "sincos", "fmod", "bitcast", "clz", "tape_whos",
           "tape_graphviz"] + list(_MATH_OPS) + ["printf", "plain_eval",
                                                 "prepare"]
