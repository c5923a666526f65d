"""The lazy trace on the card: one generated CUDA kernel per fused run of a
schedule (counterpart of the reference's ``_compile_schedule`` with XLA as
its code generator, enoki_tpu/trace/__init__.py:396, and of the source
paper's PTX trace-JIT, src/cuda/jit.cu:983-1508).

``Plan`` cuts a schedule (``trace._read_schedule``'s entries) into fused
runs. A run is a maximal stretch of the schedule that one thread per lane
can evaluate: the elementwise opcodes, IOTA, literals (read from the
literal stream at run time, so a changed constant reuses the kernel),
CAST, BITCAST, SELECT, GATHER / REVERSE from a buffer materialised before
the run, SCATTER / SCATTER_ADD into a copy of the target made before it
(a SCATTER_ADD into the run's own SCATTER_ADD that nothing else reads
adds into the same copy; the add takes one of three routes, below), and
PRINT, whose operands become outputs of the
kernel printed by the host after the launch. A size-1 operand is read at
index 0. HSUM ... COUNT, PSUM and COMPRESS end a run and run between
kernels as the port's own eager ops (``plain.horizontal``, on
``ops.horiz``), as the source paper breaks its kernel at every cub call
(src/cuda/horiz.cu); so does a GATHER, REVERSE or SCATTER whose source or
target the run itself computes, a read of a scatter's result, and
``MAX_KERNEL_ENTRIES`` entries, or ``config.max_fused_ops`` where that is
smaller: nvcc's time on one kernel grows with the square of its length
(cicc 3.8 s for 1,000 statements on the H100's host), and cicc crashes on
a kernel of the 10,444-op chain's 7,833 (CUDA 12.9).

Each run becomes one ``__global__`` kernel on ``csrc/trace_kernel.cuh``: a
grid-stride loop over the lanes, one C++ statement per entry, a typed load
per input and a store per value that anything outside the run reads. A
SCATTER_ADD target takes a route by its size and type when the source is
written (``Run.assign_routes``): a private row a thread in shared memory,
summed by the last block in a fixed order (float32 targets of at most
``ROW_SLOTS`` slots), a copy a block in shared memory (32- and 64-bit int
and float targets of at most ``BLOCK_BYTES``), or a global atomic a lane,
the run's shared memory at most ``ACC_SMEM``; a run with a target of the
first two has a prologue and an epilogue around its lanes, takes
``ACC_UNROLL`` lanes a thread at a time where it is short, and launches
with ``TK_ACC_LAUNCH`` (its shared memory, a grid of the blocks the card
holds at once, a row of scratch a block for the first route and the
stream's ticket). All
of a schedule's kernels go into one source, built by ``_build`` with nvcc
for sm_90a (no fast math; the arithmetic through the _rn intrinsics) and
cached in memory by the structural hash and on disk under
``cache.export_dir()`` (``config.trace_export_dir``, bounded by
``config.cache_max_bytes``; not while prints are live, nor with
``max_fused_ops`` set, as in the reference). A corrupt cached library is
deleted and rebuilt. Each launch adds one to ``_build.LAUNCHES["trace"]``,
or to ``"trace_vjp"`` / ``"trace_jvp"`` for the tape's adjoint and tangent
programs (``trace.tape``), which are schedules like any other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
from pathlib import Path

import torch

from .. import _build
from . import plain
from .plain import (ABS, ACOS, ACOSH, ADD, AND, ASIN, ASINH, ATAN, ATAN2,
                    ATANH, BF16, BITCAST, BOOL, CAST, CBRT, CEIL, CLZ,
                    COPYSIGN, COS, COSH, DIGAMMA, DIV, EQ, ERF, ERFC, EXP,
                    EXP2, EXPM1,
                    F16, F32, F64, FLOATS, FLOOR, FMA, FMOD, GATHER, GE, GT,
                    HORIZONTAL, I32, I64, IOTA, ISFINITE, ISINF, ISNAN, LE,
                    LGAMMA, LOG, LOG1P, LOG2, LT, MAX, MIN, MOD, MUL, NE,
                    NEG, NOT, OR, POPCNT, POW, PRINT, RCP, REVERSE, ROUND,
                    RSQRT, SCATTER, SCATTER_ADD, SELECT, SENT, SHL, SHR,
                    SIGN, SIN, SINH, SQRT, SUB, TAN, TANH, TRUNC, U32, U64,
                    XOR)

# C++ type of each code's working value (16-bit floats in float)
CT = ["float", "double", "int32_t", "uint32_t", "bool", "float", "int64_t",
      "uint64_t", "float"]
# runs with more pointers than this start a new run (kernel parameters)
MAX_POINTERS = 256
# the most entries of one kernel, whatever config.max_fused_ops says
MAX_KERNEL_ENTRIES = 1024

# The routes of a SCATTER_ADD target (csrc/trace_kernel.cuh): 1, a private
# row a thread in shared memory (float32 targets of at most ROW_SLOTS[code]
# slots: its fixed order makes a float sum repeatable); 2, a copy a block
# in shared memory (32- and 64-bit int and float targets of at most
# BLOCK_BYTES); 3, a global atomic a lane (the rest). A run's private
# copies share ACC_SMEM bytes a block, given out in the order of its
# targets; a target that no longer fits takes the next route. The
# thresholds are the H100's crossovers at 16M lanes, each from the worst
# of three spreads of the indices (each route forced in turn; the
# readings are in docs/port.md, SCATTER_ADD's routes).
ROUTE_ROWS, ROUTE_BLOCK, ROUTE_ATOMIC = 1, 2, 3
ROW_SLOTS = {F32: 96}
BLOCK_BYTES = 32 * 1024
ACC_SMEM = 96 * 1024
ACC_THREADS = 256
# lanes a thread takes at once in a run that accumulates (8 loads of a
# thread in flight: 0.060 ms against 0.098 one at a time, PERF.md §6, the
# thresholds), where the run has at most ACC_UNROLL_ENTRIES entries: each lane
# taken at once is the run's body again, and nvcc's time grows with the
# square of a kernel's length
ACC_UNROLL = 8
ACC_UNROLL_ENTRIES = 32
_WIDE = {I32: 4, U32: 4, F32: 4, I64: 8, U64: 8, F64: 8}

_UNARY = {NEG: "tk::neg", ABS: "tk::abs_", FLOOR: "tk::floor_",
          CEIL: "tk::ceil_", ROUND: "tk::round_", TRUNC: "tk::trunc_",
          SQRT: "tk::sqrt_r", RSQRT: "tk::rsqrt_", RCP: "tk::rcp_",
          EXP: "tk::exp_", EXP2: "tk::exp2_", LOG: "tk::log_",
          LOG2: "tk::log2_", SIN: "tk::sin_", COS: "tk::cos_",
          TAN: "tk::tan_", ASIN: "tk::asin_", ACOS: "tk::acos_",
          ATAN: "tk::atan_", SINH: "tk::sinh_", COSH: "tk::cosh_",
          TANH: "tk::tanh_", ERF: "tk::erf_", ERFC: "tk::erfc_",
          LGAMMA: "tk::lgamma_", LOG1P: "tk::log1p_", EXPM1: "tk::expm1_",
          ASINH: "tk::asinh_", ACOSH: "tk::acosh_", ATANH: "tk::atanh_",
          CBRT: "tk::cbrt_", SIGN: "tk::sign_",
          DIGAMMA: "tk::digamma_"}
# the commonest float ops as macros (TK_FADD ... in the skeleton): cicc's
# time on a long kernel falls by a third without their inlining
_DIRECT = {(ADD, F32): "TK_FADD", (SUB, F32): "TK_FSUB",
           (MUL, F32): "TK_FMUL", (DIV, F32): "TK_FDIV",
           (ADD, F64): "TK_DADD", (SUB, F64): "TK_DSUB",
           (MUL, F64): "TK_DMUL", (DIV, F64): "TK_DDIV",
           (SQRT, F32): "TK_FSQRT", (SQRT, F64): "TK_DSQRT"}
_BINARY = {ADD: "tk::add", SUB: "tk::sub", MUL: "tk::mul", MIN: "tk::min_",
           MAX: "tk::max_", ATAN2: "tk::atan2_", POW: "tk::pow_",
           SHL: "tk::shl", SHR: "tk::shr", COPYSIGN: "tk::copysign_"}
_COMPARE = {EQ: "==", NE: "!=", LT: "<", LE: "<=", GT: ">", GE: ">="}
_PREDICATE = {ISNAN: "tk::isnan_", ISINF: "tk::isinf_",
              ISFINITE: "tk::isfinite_"}
_LOAD = {BF16: "tk::ld_bf16", F16: "tk::ld_f16"}
_STORE = {BF16: "tk::st_bf16", F16: "tk::st_f16"}


def rounded(code, e):
    """``e`` (a float) rounded to a 16-bit code; as it is otherwise."""
    return f"tk::rbf({e})" if code == BF16 else \
        f"tk::rh({e})" if code == F16 else e


def cvt(x, fc, tc):
    """The C++ of CAST from ``fc`` to ``tc`` (plain.convert's bits)."""
    if fc == tc:
        return x
    if tc == BOOL:
        return f"({x} != 0)"
    if fc == BOOL:
        return f"(({CT[tc]})({x} ? 1 : 0))"
    if tc in FLOATS:
        if fc in (F32, BF16, F16):
            f, d = x, None
        elif fc == F64:
            f, d = None, x
        else:
            f, d = f"tk::i2f({x})", f"tk::i2d({x})"
        if tc == F64:
            return d if d is not None else f"((double){f})"
        if f is None:
            f = f"tk::d2f({d})"
        return f if tc == F32 else rounded(tc, f)
    if fc in FLOATS:
        return {I32: "tk::f2i32", U32: "tk::f2u32", I64: "tk::f2i64",
                U64: "tk::f2u64"}[tc] + f"({x})"
    return f"(({CT[tc]})({x}))"


def bitcast(x, fc, tc):
    if fc == tc:
        return x
    if (fc, tc) == (BF16, F16):
        return f"tk::f16_of_bits(tk::bf16_bits({x}))"
    if (fc, tc) == (F16, BF16):
        return f"tk::bf16_of_bits(tk::f16_bits({x}))"
    return f"tk::bits<{CT[tc]}>({x})"


def op_expr(op, out, args, codes):
    """The C++ expression of one lane op on its arguments' expressions
    (``codes``: their codes)."""
    if op == CAST:
        return cvt(args[0], codes[0], out)
    if op == BITCAST:
        return bitcast(args[0], codes[0], out)
    if op in _COMPARE:
        pc = plain.promote(codes[0], codes[1])
        a, b = (cvt(x, c, pc) for x, c in zip(args, codes))
        return f"({a} {_COMPARE[op]} {b})"
    if op in _PREDICATE:
        return f"{_PREDICATE[op]}({args[0]})"
    if op == SELECT:
        m = cvt(args[0], codes[0], BOOL)
        a, b = (cvt(x, c, out) for x, c in zip(args[1:], codes[1:]))
        return f"({m} ? {a} : {b})"
    xs = [cvt(x, c, out) for x, c in zip(args, codes)]
    if (op, out) in _DIRECT:
        return f"{_DIRECT[op, out]}({', '.join(xs)})"
    if op in _UNARY:
        return rounded(out, f"{_UNARY[op]}({xs[0]})")
    if op in _BINARY:
        return rounded(out, f"{_BINARY[op]}({xs[0]}, {xs[1]})")
    if op == DIV:
        return rounded(out, f"tk::div({xs[0]}, {xs[1]})") if out in FLOATS \
            else f"tk::idiv({xs[0]}, {xs[1]})"
    if op == FMA:
        return rounded(out, f"tk::fma_({xs[0]}, {xs[1]}, {xs[2]})")
    if op == FMOD:
        return rounded(out, f"tk::fmod_({xs[0]}, {xs[1]})")
    if op == MOD:
        return rounded(out, f"tk::floor_mod(tk::fmod_({xs[0]}, {xs[1]}), "
                            f"{xs[1]})")
    if op in (AND, OR, XOR):
        if out in FLOATS:
            raise TypeError("a bitwise op needs an integer or bool dtype")
        sym = {AND: "&", OR: "|", XOR: "^"}[op]
        return f"(({CT[out]})({xs[0]} {sym} {xs[1]}))"
    if op == NOT:
        return f"(!{xs[0]})" if out == BOOL else f"(({CT[out]})~{xs[0]})"
    if op in (POPCNT, CLZ):
        if out not in (I32, U32, I64, U64):
            raise TypeError("popcnt / clz need an integer dtype")
        w = 64 if out in (I64, U64) else 32
        fn = ("tk::popc" if op == POPCNT else "tk::clz") + str(w)
        return f"(({CT[out]}){fn}((uint{w}_t){xs[0]}))"
    raise NotImplementedError(f"trace opcode {op} in a fused kernel")


class Run:
    """A stretch of the schedule evaluated by one kernel, lane by lane."""

    def __init__(self, index, width):
        self.index = index
        self.width = width
        self.members = []     # schedule positions, in order
        self.inputs = []      # positions read from memory (leaves, earlier)
        self.outputs = []     # positions stored (read outside the run)
        self.targets = []     # scatter positions (their target's copy)
        self.alias = {}       # a SCATTER_ADD adding into an earlier one's copy
        self.prints = []      # PRINT positions, printed after the launch
        self.routes = {}      # SCATTER_ADD target -> its route
        self.smem = {}        # target of route 1 or 2 -> its shared offset
        self.part = {}        # target of route 1 -> its offset in a row
        self.smem_bytes = 0
        self.part_width = 0   # words of a block's row of route 1's sums
        self.unroll = 1

    @property
    def name(self):
        return f"tk_run{self.index}"

    @property
    def pointers(self):
        return self.inputs + self.outputs + self.targets

    @property
    def accumulates(self):
        """Whether a target of the run adds in shared memory (route 1 or
        2): the run's kernel then has a prologue and an epilogue."""
        return bool(self.smem)

    def assign_routes(self, entries):
        """Give each SCATTER_ADD target its route and its place in shared
        memory (rows of route 1 first, then copies of route 2, 8-byte
        aligned); run when the run is whole."""
        def smem_bytes(route, size, code):
            return ACC_THREADS * 4 * size if route == ROUTE_ROWS \
                else -(-size * _WIDE[code] // 8) * 8

        used = 0
        for p in self.targets:
            op, code, size = entries[p][1], entries[p][2], entries[p][3]
            if op != SCATTER_ADD:
                continue
            self.routes[p] = ROUTE_ATOMIC
            for route, ok in ((ROUTE_ROWS, size <= ROW_SLOTS.get(code, 0)),
                              (ROUTE_BLOCK, code in _WIDE and smem_bytes(
                                  ROUTE_BLOCK, size, code) <= BLOCK_BYTES)):
                if ok and used + smem_bytes(route, size, code) <= ACC_SMEM:
                    self.routes[p] = route
                    used += smem_bytes(route, size, code)
                    break
        for want in (ROUTE_ROWS, ROUTE_BLOCK):
            for p, route in self.routes.items():
                if route == want:
                    self.smem[p] = self.smem_bytes
                    self.smem_bytes += smem_bytes(route, entries[p][3],
                                                  entries[p][2])
                    if route == ROUTE_ROWS:
                        self.part[p] = self.part_width
                        self.part_width += entries[p][3]
        if self.smem and len(self.members) <= ACC_UNROLL_ENTRIES:
            self.unroll = ACC_UNROLL


class Plan:
    """The fused runs and between-run steps of one schedule, its generated
    source, and (``library()``) its built kernels."""

    def __init__(self, entries, out_positions, fmts, max_ops=0, key=None):
        self.entries = entries
        self.out_positions = out_positions
        self.fmts = fmts
        self.max_ops = max_ops
        self.cap = min(max_ops or MAX_KERNEL_ENTRIES, MAX_KERNEL_ENTRIES)
        self.key = key
        self.steps = []       # Run or schedule position (a horizontal op)
        self.runs = []
        self._plan()
        self.text = self._source()
        self._lib = None

    # -- cutting the schedule into runs ------------------------------------

    def _lane_size(self, i):
        e = self.entries[i]
        dps = [p for p in e[4] if p != SENT]
        if e[1] in (SCATTER, SCATTER_ADD):
            return max(self.entries[dps[1]][3], self.entries[dps[2]][3])
        if e[1] == PRINT:
            return max(self.entries[p][3] for p in dps)
        return e[3]

    def _plan(self):
        entries = self.entries
        home = [None] * len(entries)   # a Run, "leaf", "lit" or "eager"
        readers = [0] * len(entries)
        for e in entries:
            for p in set(e[4]) - {SENT}:
                readers[p] += 1
        outs = set(self.out_positions)
        cur = None
        for i, e in enumerate(entries):
            op = e[1]
            dps = [p for p in e[4] if p != SENT]
            if e[6]:
                home[i] = "lit"
                continue
            if e[7]:
                home[i] = "leaf"
                continue
            if op in HORIZONTAL:
                home[i] = "eager"
                if cur is not None and any(home[p] is cur for p in dps):
                    self.steps.append(i)
                    cur = None
                else:  # it reads nothing the open run makes: goes first
                    self.steps.insert(len(self.steps) - (cur is not None), i)
                continue
            lanes = self._lane_size(i)
            new = cur is None
            # a SCATTER_ADD into the run's own SCATTER_ADD that nothing
            # else reads adds into the same copy (and its private sums)
            chained = not new and op == SCATTER_ADD \
                and home[dps[0]] is cur \
                and entries[dps[0]][1] == SCATTER_ADD \
                and readers[dps[0]] == 1 and dps[0] not in outs
            if not new:
                w = cur.width
                new = (lanes != 1 and w != 1 and lanes != w) \
                    or (op in (GATHER, REVERSE, SCATTER, SCATTER_ADD)
                        and home[dps[0]] is cur and not chained) \
                    or any(home[p] is cur and entries[p][1] in (
                        SCATTER, SCATTER_ADD)
                           for p in (dps[1:] if chained else dps)) \
                    or len(cur.members) >= self.cap \
                    or len(cur.pointers) + len(dps) + 1 > MAX_POINTERS
                chained = chained and not new
            if new:
                cur = Run(len(self.runs), lanes)
                self.runs.append(cur)
                self.steps.append(cur)
            elif cur.width == 1:
                cur.width = lanes
            home[i] = cur
            cur.members.append(i)
            for k, p in enumerate(dps):
                if home[p] is cur or home[p] == "lit":
                    continue
                if op in (GATHER, REVERSE) and k == 0:
                    if p not in cur.inputs:
                        cur.inputs.append(p)
                    continue
                if op in (SCATTER, SCATTER_ADD) and k == 0:
                    continue  # copied into the target before the launch
                if p not in cur.inputs:
                    cur.inputs.append(p)
            if chained:
                cur.alias[i] = cur.alias.get(dps[0], dps[0])
            elif op in (SCATTER, SCATTER_ADD):
                cur.targets.append(i)
            if op == PRINT:
                cur.prints.append(i)
        # what leaves a run: the schedule's outputs, and what any other
        # run, horizontal op, print or scatter base reads
        needed = set(p for p in self.out_positions if p != SENT)
        for i, e in enumerate(entries):
            dps = [p for p in e[4] if p != SENT]
            if home[i] in ("lit", "leaf"):
                continue
            for k, p in enumerate(dps):
                if home[p] is not home[i] or e[1] == PRINT \
                        or (k == 0 and e[1] in (GATHER, REVERSE, SCATTER,
                                                SCATTER_ADD)):
                    needed.add(p)
        for r in self.runs:
            r.outputs = [p for p in r.members if p in needed
                         and entries[p][1] not in (SCATTER, SCATTER_ADD)]
            r.assign_routes(entries)

    # -- the source --------------------------------------------------------

    def _source(self):
        lines = ["// generated by enoki_tpu_torch/trace/codegen.py from a "
                 "trace schedule",
                 '#include "trace_kernel.cuh"', ""]
        lit_index = {}
        for i, e in enumerate(self.entries):
            if e[6]:
                lit_index[i] = len(lit_index)
        self.lit_index = lit_index
        for r in self.runs:
            lines += self._kernel(r)
        return "\n".join(lines) + "\n"

    def _kernel(self, r):
        entries = self.entries
        W = r.width
        slot = {p: k for k, p in enumerate(r.pointers)}
        body = []
        names = {}
        # a run that accumulates reads its inputs through the read-only
        # path (nothing writes them while it runs)
        ld = "tk::ldg" if r.accumulates else "tk::ld"

        def value(p, reader=None):
            """The expression of position ``p`` read in this run."""
            if p in names:
                return names[p]
            e = entries[p]
            code, size = e[2], e[3]
            if e[6]:
                j = self.lit_index[p]
                lit = ("tk::lit_b8" if code == BOOL else
                       "tk::lit_bf16" if code == BF16 else
                       "tk::lit_f16" if code == F16 else
                       f"tk::lit<{CT[code]}>")
                body.append(f"    const {CT[code]} l{p} = {lit}(L, {j});")
                names[p] = f"l{p}"
                return names[p]
            idx = "0" if size == 1 else "i"
            load = _LOAD.get(code, f"{ld}<{CT[code]}>")
            body.append(f"    const {CT[code]} x{p} = "
                        f"{load}(P.p[{slot[p]}], {idx});")
            names[p] = f"x{p}"
            return names[p]

        for i in r.members:
            vid, op, code, size, deps, _, _, _ = entries[i]
            dps = [p for p in deps if p != SENT]
            codes = [entries[p][2] for p in dps]
            if op == IOTA:
                ex = cvt("((int64_t)i)" if size != 1 else "((int64_t)0)",
                         I64, code)
            elif op == PRINT:
                ex = value(dps[0])
                for p in dps[1:]:
                    value(p)
            elif op == GATHER:
                src = entries[dps[0]]
                ix = value(dps[1])
                if src[6]:
                    ex = value(dps[0])
                else:
                    load = _LOAD.get(code, f"{ld}<{CT[code]}>")
                    ex = (f"{load}(P.p[{slot[dps[0]]}], "
                          f"tk::clip_index({ix}, {src[3]}LL))")
            elif op == REVERSE:
                src = entries[dps[0]]
                if src[6] or src[3] == 1:
                    ex = value(dps[0])
                else:
                    load = _LOAD.get(code, f"{ld}<{CT[code]}>")
                    ex = f"{load}(P.p[{slot[dps[0]]}], {size - 1}LL - i)"
            elif op in (SCATTER, SCATTER_ADD):
                ix = value(dps[1])
                v = cvt(value(dps[2]), codes[2], code)
                tgt = r.alias.get(i, i)
                ptr = f"P.p[{slot[tgt]}]"
                if op == SCATTER:
                    store = (f"{_STORE[code]}({ptr}, j, {v})" if code in
                             _STORE else f"tk::st<{CT[code]}>({ptr}, j, {v})")
                elif tgt in r.smem:
                    store = f"a{tgt}.put(j, {v})"
                elif code in (BF16, F16):
                    kind = "bf16" if code == BF16 else "f16"
                    store = f"tk::atomic_add_{kind}({ptr}, j, {v})"
                else:
                    store = (f"tk::atomic_add(static_cast<{CT[code]} *>"
                             f"({ptr}) + j, {v})")
                guard = "" if self._lane_size(i) != 1 or W == 1 \
                    else "if (i == 0) "
                body.append(f"    {guard}{{ const long long j = "
                            f"tk::scatter_index({ix}, {size}LL); "
                            f"if (j >= 0) {store}; }}")
                continue
            else:
                ex = op_expr(op, code, [value(p) for p in dps], codes)
            body.append(f"    const {CT[code]} v{i} = {ex};")
            names[i] = f"v{i}"
            if i in r.outputs:
                ptr = f"P.p[{slot[i]}]"
                st = (f"{_STORE[code]}({ptr}, {{}}, v{i})" if code in _STORE
                      else f"tk::st<{CT[code]}>({ptr}, {{}}, v{i})")
                if size == W:
                    body.append(f"    {st.format('i')};")
                else:
                    body.append(f"    if (i == 0) {st.format('0')};")
        # the lane count is an argument, so that one structure at two
        # sizes is one source (the hash tells them apart)
        head = (f"TK_KERNEL({r.name})(const TkPtrs<{len(r.pointers)}> P, "
                f"const uint64_t *__restrict__ L, long long n")
        if not r.accumulates:
            return ([head + ") {", "  TK_LANES(i, n) {"] + body
                    + ["  }", "}", f"TK_LAUNCH({r.name}, {len(r.pointers)})",
                       ""])
        # the private sums: made (and zeroed) before the lanes, added into
        # the targets after them
        lines = [head + ", uint32_t *__restrict__ part, unsigned *ticket) {",
                 "  TK_SMEM(sm);"]
        for p, off in r.smem.items():
            kind = "RowAcc" if r.routes[p] == ROUTE_ROWS else "BlockAcc"
            lines.append(f"  tk::{kind}<{CT[entries[p][2]]}, "
                         f"{entries[p][3]}> a{p}(P.p[{slot[p]}], sm, {off});")
        lines += ["  tk::sync();", "  auto lane = [&](long long i) {"] + body
        lines += ["  };", f"  TK_LANES_BY(lane, n, {r.unroll});",
                  "  tk::sync();"]
        lines += [f"  a{p}.flush();" for p in r.smem if p not in r.part]
        lines += [f"  a{p}.to_part(part, {r.part_width}, {off});"
                  for p, off in r.part.items()]
        if r.part:
            lines.append("  if (tk::last_block(ticket)) {")
            lines += [f"    a{p}.flush(part, {r.part_width}, {off});"
                      for p, off in r.part.items()]
            lines.append("  }")
        return lines + ["}", f"TK_ACC_LAUNCH({r.name}, {len(r.pointers)}, "
                             f"{r.smem_bytes}, {r.unroll})", ""]

    # -- building ------------------------------------------------------------

    def disk_name(self):
        """The library's name in the disk cache, or None where the cache
        is off for this plan."""
        from .. import cache
        if self.key is None or self.max_ops or not cache.export_dir():
            return None
        h = hashlib.sha256(_codegen_digest().encode())
        h.update(self.text.encode())  # the routes: the text, not the hash
        return f"trace-{self.key:016x}-{h.hexdigest()[:8]}.so"

    def library(self, build=None):
        """The built kernels: from memory, from the disk cache, or built
        with nvcc (``build``: text -> library path, ``_build``'s by
        default)."""
        if self._lib is None:
            self._lib = _load(self.text, self.disk_name(),
                              build or _nvcc_build,
                              [(r.name, r.accumulates) for r in self.runs])
        return self._lib

    # -- running -------------------------------------------------------------

    def run(self, leaves, lit_dev, bits, codes, device, build=None,
            counter="trace"):
        """The schedule's outputs (storage tensors) on the card (on the
        CPU for a host ``build`` of the kernels, in the tests); each launch
        adds one to ``_build.LAUNCHES[counter]``."""
        lib = self.library(build)
        entries = self.entries
        mat = {}
        leaf_pos = [i for i, e in enumerate(entries) if e[7]]
        mat.update(zip(leaf_pos, leaves))

        def get(p):
            t = mat.get(p)
            if t is None:  # a literal: filled on the device
                e = entries[p]
                j = self.lit_index[p]
                t = plain.fill(int(bits[j]), int(codes[j]), e[3], device)
                mat[p] = t
            return t

        # the card's current stream (None: a host build of the kernels)
        stream = torch.cuda.current_stream(device).cuda_stream \
            if device.type == "cuda" else None
        for step in self.steps:
            if isinstance(step, int):
                e = entries[step]
                dps = [p for p in e[4] if p != SENT]
                x = get(dps[0])
                mask = get(dps[1]).expand(x.shape[0]) if len(dps) > 1 \
                    else None
                mat[step] = plain.horizontal(e[1], entries[dps[0]][2], x,
                                             mask)
                continue
            ptrs = [get(p).data_ptr() for p in step.inputs]
            for p in step.outputs:
                e = entries[p]
                mat[p] = torch.empty(e[3], dtype=plain.STORAGE[e[2]],
                                     device=device)
                ptrs.append(mat[p].data_ptr())
            for p in step.targets:
                e = entries[p]
                base = get(e[4][0])
                mat[p] = base.expand(e[3]).clone()
                ptrs.append(mat[p].data_ptr())
            for p, root in step.alias.items():
                mat[p] = mat[root]
            arr = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
            entry = getattr(lib, step.name + "_launch")
            if not step.accumulates:
                _build.launch(counter, entry, arr, lit_dev.data_ptr(),
                              step.width, stream)
            else:
                part = ticket = None
                if stream is not None and step.part_width:
                    blocks = getattr(lib, step.name + "_blocks")(step.width)
                    part = torch.empty(blocks * step.part_width,
                                       dtype=torch.int32, device=device)
                    ticket = _build.ticket(lit_dev.device, stream)
                _build.launch(counter, entry, arr, lit_dev.data_ptr(),
                              step.width, stream,
                              None if part is None else part.data_ptr(),
                              None if ticket is None else ticket.data_ptr())
            for p in step.prints:
                e = entries[p]
                ops = [get(q) for q in e[4] if q != SENT]
                plain.print_values(self.fmts.get(e[0], "{}"), [
                    t.expand(e[3]) if t.shape[0] == 1 else t for t in ops])
        return [None if p == SENT else get(p) for p in self.out_positions]


# ---------------------------------------------------------------------------
# building and the caches
# ---------------------------------------------------------------------------

_LIBS: dict = {}   # (digest of the text, build function) -> loaded library


def _codegen_digest():
    h = hashlib.sha256()
    h.update(Path(__file__).read_bytes())
    h.update((_build.CSRC_DIR / "trace_kernel.cuh").read_bytes())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc_build(text):
    return _build.build_generated("trace", text)


def _bind(path, runs):
    """Load a library with the entry points of ``runs`` ((name, whether
    the run accumulates) each)."""
    lib = ctypes.CDLL(str(path))
    P = ctypes.c_void_p
    for name, acc in runs:
        f = getattr(lib, name + "_launch")
        f.argtypes = [P, P, ctypes.c_longlong, P] + [P, P] * acc
        f.restype = ctypes.c_int
        if acc:
            f = getattr(lib, name + "_blocks")
            f.argtypes = [ctypes.c_longlong]
            f.restype = ctypes.c_int
    return lib


def _load(text, disk_name, build, runs):
    """Load the library of ``text``: one already loaded, the disk cache's
    (a corrupt one is deleted and rebuilt) or a new build, which then
    goes into the disk cache."""
    digest = (hashlib.sha256(text.encode()).hexdigest(), build)
    lib = _LIBS.get(digest)
    if lib is not None:
        return lib
    from .. import cache
    d = cache.export_dir() if disk_name else ""
    path = os.path.join(d, disk_name) if d else None
    if path and os.path.exists(path):
        try:
            lib = _bind(path, runs)
        except (OSError, AttributeError):
            os.remove(path)
    if lib is None:
        built = build(text)
        lib = _bind(built, runs)
        if path:
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.{_build._unique()}.tmp"
            shutil.copyfile(built, tmp)
            os.replace(tmp, path)
            cache.evict_lru(d)
    _LIBS[digest] = lib
    return lib
