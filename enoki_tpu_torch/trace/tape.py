"""The AD tape over the lazy trace: the ``DiffArray<CUDAArray<float>>``
analog (counterpart of enoki_tpu/trace/__init__.py:1356-1770).

The source paper wraps the lazy GPU array in a tape that outlives
evaluation (autodiff.h:126): values and derivatives are independent. The
same contract here: whenever an eval's program touches the differentiable
frontier (a ``requires_grad`` leaf, or an output of an earlier recorded
segment), the program is kept as a tape segment with its input buffers
and literal stream. ``backward(loss)`` walks the segments in reverse,
``forward_from(x, loss)`` in order.

The reference differentiates a segment with ``jax.vjp`` / ``jax.jvp``
over its XLA program. The port's kernels have no autodiff, so it does
what the source paper does (SURVEY.md L6/L7): the derivative of a program
is another trace program, which the code generator fuses like any other.
For each segment the schedule is replayed from the leaf buffers and the
literal stream through ``LazyArray._record`` (outputs are recomputed, not
read from their stored buffers: on each route the replay gives the bits
the eval gave), and a sweep of derivative ops is appended -- reverse for
the adjoint program, forward for the tangent program -- from the one
derivative table below (``_VJP``, ``_JVP``). The sweeps of every segment
chain lazily, and one eval at the end evaluates the whole backward: on
the card as fused kernels of ``codegen`` (``csrc/trace_kernel.cuh``;
reductions, prefix sums and ``compress`` between them, as for every
schedule), counted in ``_build.LAUNCHES["trace_vjp"]`` /
``["trace_jvp"]``; on the CPU through the plain interpreter. A CUDA
segment's derivatives never run through ``torch.autograd`` or the plain
interpreter, and a kernel that fails to build or launch raises. The
evals the tape issues are never recorded on it.

One adjoint structure per (segment structures, outputs that carry
cotangents, differentiable leaves): a second optimisation step is a
kernel-cache hit, and the disk cache (``trace-<hash>-<tag>.so`` under
``cache.export_dir()``) covers the adjoint's kernels as it covers any
schedule's.

The rules are JAX's, read from the functions the reference's ``_OP_IMPL``
lowers each opcode to, in the same order of operations: ``jnp.minimum``
/ ``maximum`` split a tie 0.5 / 0.5, ``jnp.abs`` has slope +1 at 0,
``jnp.power`` takes ``log(x == 0 ? 1 : x)`` for its exponent's partial,
``jnp.log2`` is ``log(x) / log(2)``, ``jnp.remainder`` / ``fmod`` are
``lax.rem`` with its ``-sign(x/y) floor|x/y|`` partial, the reductions'
are ``reduce_max``'s (the cotangent shared among the tied lanes) and
``reduce_prod``'s (the pairwise tree of ``_reduce_jvp``: the product of
the other lanes without a division, so zeros need no special case). A
16-bit op's derivative is computed in its dtype. LGAMMA's derivative is
the port's own opcode 80, digamma (``plain.DIGAMMA``). Deliberate
differences (docs/port.md, the tape and calls): a SCATTER's value takes
the cotangent at its slot under the interpreter's wrap-then-drop index
rule, every one of duplicate writes included; a float SCATTER_ADD, and
the adjoint of a GATHER, add with atomics on the card into a target too
large for a private row a thread (``codegen.ROW_SLOTS``: float32 targets,
which add in a fixed order).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import sys

import torch

from . import (LazyArray, Op, _BUFFERS, _DTYPES, _FLOAT_CODES, _dev_code,
               _eval_ids, _lib, _shared_literal, select)
from . import plain as _plain
from .plain import SENT

_trace = sys.modules[__package__]  # the package, whose globals the tape sets

_GRAD_ENABLED: set = set()   # var ids marked as differentiable parameters
_GRADS: dict = {}            # version vid -> accumulated gradient tensor
_TAPE: list = []             # recorded _Segments, chronological
_PRODUCER: dict = {}         # version vid -> (segment index, output slot)
_VERSION: dict = {}          # var id -> current version vid (scatter rebinds)
# every vid that ever appeared on a recorded segment (leaf or output):
# survives clear_tape() so gradient() tells "recorded but untouched"
# (zeros) from "never on the tape" (error); pruned with the gradients
_ON_TAPE: set = set()
# > 0 while the tape evaluates its own programs (they are not recorded)
_OFF = [0]

_BOOL, _I32, _I64 = 4, 2, 6
_I64_MAX = (1 << 63) - 1
_LN2 = 0.6931471805599453
_TWO_OVER_SQRT_PI = 1.1283791670955126


class _Segment:
    """One recorded eval: its schedule and everything needed to replay its
    adjoint and tangent programs (the tape-node analog,
    autodiff.cpp:44-105)."""

    __slots__ = ("entries", "out_positions", "leaf_vids", "leaf_bufs",
                 "bits", "codes", "out_vids", "out_diff", "key", "device")

    def __init__(self, entries, out_positions, leaf_vids, leaf_bufs, bits,
                 codes, out_vids, key, device):
        self.entries = entries
        self.out_positions = out_positions
        self.leaf_vids = leaf_vids    # version vids, schedule order
        self.leaf_bufs = leaf_bufs    # input buffers at record time
        self.bits, self.codes = bits, codes   # the literal stream
        self.out_vids = out_vids      # output vids (0 = dropped)
        self.out_diff = tuple(p != SENT and entries[p][2] in _FLOAT_CODES
                              for p in out_positions)
        self.key = key
        self.device = device

    def leaf_positions(self):
        return [i for i, e in enumerate(self.entries) if e[7]]


# ---------------------------------------------------------------------------
# the hooks of trace._eval_ids
# ---------------------------------------------------------------------------


def active() -> bool:
    """Whether an eval now may be recorded."""
    return bool(_GRAD_ENABLED) and not _OFF[0]


def record(comp, key, leaf_vids, leaves, bits, codes, out_vids, device):
    """Keep the eval just run as a segment if its program touches the
    differentiable frontier (enoki_tpu/trace/__init__.py:826-840)."""
    vleaves = [_VERSION.get(v, v) for v in leaf_vids]
    if not any(v in _GRAD_ENABLED or v in _PRODUCER for v in vleaves):
        return
    si = len(_TAPE)
    _TAPE.append(_Segment(comp.entries, comp.out_positions, vleaves,
                          list(leaves), bits, codes, list(out_vids), key,
                          device))
    _ON_TAPE.update(vleaves)
    for slot, vid in enumerate(out_vids):
        if vid:
            _PRODUCER[vid] = (si, slot)
            _ON_TAPE.add(vid)


def rebind(target, scatter_vid):
    """A scatter becomes its target's new version: later reads of the
    target differentiate through it (:866-871)."""
    _VERSION[target] = scatter_vid


def reset():
    _GRAD_ENABLED.clear()
    _GRADS.clear()
    _ON_TAPE.clear()
    clear_tape()
    _VERSION.clear()


@contextlib.contextmanager
def _own_evals(counter):
    """The tape's own evals: not recorded, their launches counted under
    ``counter``."""
    old = _trace._LAUNCH_NAME
    _OFF[0] += 1
    _trace._LAUNCH_NAME = counter
    try:
        yield
    finally:
        _OFF[0] -= 1
        _trace._LAUNCH_NAME = old


# ---------------------------------------------------------------------------
# building blocks of the derivative programs
# ---------------------------------------------------------------------------


def _cast(v, code):
    return v if v._code == code else v._unary(Op.CAST, code)


def _full(v, n, dev):
    """``v`` at ``n`` lanes (a size-1 value broadcast by adding -0.0,
    which changes no bit)."""
    if len(v) == n:
        return v
    return v + LazyArray.literal(-0.0, n, _DTYPES[v._code], dev)


def _iota(n, dev):
    return LazyArray.arange(n, torch.int32, dev)


def _gather(src, idx):
    return LazyArray._record(Op.GATHER, src._code, len(idx), src, idx,
                             raw=True)


def _scatter(op, base, idx, val):
    """A pure SCATTER / SCATTER_ADD op: ``base`` with ``val`` written (or
    added) at ``idx``, under the interpreter's index rule."""
    return LazyArray._record(op, base._code, len(base), base, idx, val,
                             raw=True)


def _scatter_slot(idx, n):
    """(slot, in range) of a scatter index into ``n`` lanes: a negative
    index counts from the end, one still out of range is dropped (the
    interpreter's wrap-then-drop rule)."""
    k = _cast(idx, _I64)
    j = select(k < 0, k + n, k)
    return j, (j >= 0) & (j < n)


def _clip_slot(idx, n):
    """The slot a GATHER (``mode="clip"``) reads: the index clamped into
    [0, n), a uint64 index of 2**63 or more taken as the largest."""
    k = _cast(idx, _I64)
    if idx._code == 7:
        k = select(k < 0, _I64_MAX, k)
    return select(k < 0, 0, select(k > n - 1, n - 1, k))


def _sum(*terms):
    out = None
    for t in terms:
        if t is not None:
            out = t if out is None else out + t
    return out


def _mul(a, b):
    return None if a is None or b is None else a * b


def _ip2(y):
    """``integer_pow(y, -2)`` as lax lowers it: 1 / (y * y)."""
    return 1.0 / (y * y)


def _prod_levels(x, dev):
    """The levels of ``_reduce_jvp``'s pairwise tree over ``x``: each
    (values, lanes, lanes of its first half); a level multiplies its
    first half by its second, padded with 1."""
    levels = []
    a, m = x, len(x)
    while m > 1:
        h = (m + 1) // 2
        k = _iota(h, dev)
        hi = k + h
        second = select(hi < m, _gather(a, hi), 1.0)
        levels.append((a, m, h))
        a = _gather(a, k) * second
        m = h
    return levels


class _Lane:
    """One entry of a replayed segment as a derivative rule sees it."""

    __slots__ = ("entries", "vals", "dps", "c", "n", "ans", "dev")

    def __init__(self, entries, vals, i, dev):
        e = entries[i]
        self.entries, self.vals, self.dev = entries, vals, dev
        self.dps = [p for p in e[4] if p != SENT]
        self.c, self.n = e[2], e[3]
        self.ans = vals[i]

    def x(self, k):
        """Operand ``k`` in the op's dtype (as the op converts it)."""
        return _cast(self.vals[self.dps[k]], self.c)

    def raw(self, k):
        return self.vals[self.dps[k]]

    def lit(self, v):
        return _shared_literal(self.c, v)

    def mask(self, k):
        return _cast(self.raw(k), _BOOL)


def _u(op):
    return lambda v: v._unary(op)


_sqrt, _rsqrt, _exp, _log, _sin, _cos = (_u(Op.SQRT), _u(Op.RSQRT),
                                         _u(Op.EXP), _u(Op.LOG), _u(Op.SIN),
                                         _u(Op.COS))
_sinh, _cosh, _sign, _floor, _abs = (_u(Op.SINH), _u(Op.COSH), _u(Op.SIGN),
                                     _u(Op.FLOOR), _u(Op.ABS))
_digamma = _u(_plain.DIGAMMA)


def _pow(a, b):
    return a._bin(b, Op.POW)


def _fmod(a, b):
    return a._bin(b, Op.FMOD)


def _rem_k(r):
    """``lax.rem``'s partial in the divisor, negated: sign(x/y) *
    floor(|x/y|)."""
    q = r.x(0) / r.x(1)
    return _sign(q) * _floor(_abs(q))


def _do_plus(r):
    """Where ``jnp.remainder`` adds the divisor to ``lax.rem``."""
    rem = _fmod(r.x(0), r.x(1))
    return ((rem < 0.0) != (r.x(1) < 0.0)) & (rem != 0.0)


def _balanced(r, k):
    """``_balanced_eq`` of min / max: 1 where operand ``k`` is the result,
    0.5 where both are, else 0."""
    mine = r.x(k) == r.ans
    other = r.x(1 - k) == r.ans
    return select(mine, r.lit(1.0), 0.0) / select(other, r.lit(2.0), 1.0)


def _sign_neg(r):
    """``signbit`` of COPYSIGN's second operand."""
    return _sign(r.x(1)) < 0.0


def _chosen(r):
    """(lanes equal to the HMIN / HMAX result in the op's dtype, their
    count in it)."""
    x = r.x(0)
    eq = x == r.ans
    return _cast(eq, r.c), _cast(eq.count(), r.c)


# ---------------------------------------------------------------------------
# the derivative table: for each float opcode its adjoint (ct of each
# operand from the result's ``g``) and its tangent (the result's from the
# operands' ``t``, None where an operand carries none), JAX's rules
# ---------------------------------------------------------------------------


def _v_gather(r, g):
    src = r.entries[r.dps[0]]
    if src[3] == 1:  # every lane read the one element: _give sums them
        return [g]
    base = LazyArray.literal(0.0, src[3], _DTYPES[r.c], r.dev)
    return [_scatter(Op.SCATTER_ADD, base, _clip_slot(r.raw(1), src[3]), g)]


def _v_scatter(r, g, add):
    n = r.n
    j, ok = _scatter_slot(r.raw(1), n)
    at = select(ok, _gather(g, j), 0.0)
    if add:
        base = g
    else:
        base = _scatter(Op.SCATTER, _full(g, n, r.dev), r.raw(1), r.lit(0.0))
    return [base, None, at]


def _v_hprod(r, g):
    c = g
    for a, m, h in reversed(_prod_levels(r.x(0), r.dev)):
        j = _iota(m, r.dev)
        lo = j < h
        partner = select(lo, j + h, j - h)
        c = _gather(c, select(lo, j, j - h)) * select(
            partner < m, _gather(a, partner), 1.0)
    return [c]


def _v_compress(r, g):
    m = _full(r.mask(1), r.n, r.dev)
    slot = _cast(m, _I32).psum() - 1
    return [select(m, _gather(g, slot), 0.0)]


def _v_minmax(r, g):
    return [g * _balanced(r, 0), g * _balanced(r, 1)]


def _v_hchoose(r, g):
    ind, cnt = _chosen(r)
    return [(g / cnt) * ind]


def _v_mod(r, g):
    return [g, select(_do_plus(r), g, 0.0) + -(g * _rem_k(r))]


def _v_copysign(r, g):
    h = select(_sign_neg(r), -g, g)
    return [select(r.x(0) >= 0.0, h, -h)]


def _v_atan2(r, g):
    a, b = r.x(0), r.x(1)
    den = a * a + b * b
    return [g * (b / den), g * (-a / den)]


def _v_pow(r, g):
    x, y = r.x(0), r.x(1)
    return [g * (y * _pow(x, y - 1.0)),
            g * (_log(select(x == 0.0, r.lit(1.0), x)) * r.ans)]


_VJP = {
    Op.ADD: lambda r, g: [g, g],
    Op.SUB: lambda r, g: [g, -g],
    Op.MUL: lambda r, g: [g * r.x(1), r.x(0) * g],
    Op.DIV: lambda r, g: [g / r.x(1), -((g * _ip2(r.x(1))) * r.x(0))],
    Op.NEG: lambda r, g: [-g],
    Op.ABS: lambda r, g: [select(r.x(0) >= 0.0, g, -g)],
    Op.MIN: _v_minmax,
    Op.MAX: _v_minmax,
    Op.FMA: lambda r, g: [g * r.x(1), r.x(0) * g, g],
    Op.SQRT: lambda r, g: [g * (0.5 / r.ans)],
    Op.RSQRT: lambda r, g: [g * (-0.5 * (r.ans / r.x(0)))],
    Op.RCP: lambda r, g: [-(g * _ip2(r.x(0)))],
    Op.EXP: lambda r, g: [g * r.ans],
    Op.EXP2: lambda r, g: [(r.lit(_LN2) * g) * r.ans],
    Op.LOG: lambda r, g: [g / r.x(0)],
    Op.LOG2: lambda r, g: [(g / r.lit(_LN2)) / r.x(0)],
    Op.SIN: lambda r, g: [g * _cos(r.x(0))],
    Op.COS: lambda r, g: [-g * _sin(r.x(0))],
    Op.TAN: lambda r, g: [g * (1.0 + r.ans * r.ans)],
    Op.ASIN: lambda r, g: [g * _rsqrt(1.0 - r.x(0) * r.x(0))],
    Op.ACOS: lambda r, g: [g * -_rsqrt(1.0 - r.x(0) * r.x(0))],
    Op.ATAN: lambda r, g: [g / (1.0 + r.x(0) * r.x(0))],
    Op.SINH: lambda r, g: [g * _cosh(r.x(0))],
    Op.COSH: lambda r, g: [g * _sinh(r.x(0))],
    Op.TANH: lambda r, g: [(lambda u: u + u * r.ans)(g * (1.0 - r.ans))],
    Op.ERF: lambda r, g: [(r.lit(_TWO_OVER_SQRT_PI) * g)
                          * _exp(-(r.x(0) * r.x(0)))],
    Op.ERFC: lambda r, g: [(r.lit(-_TWO_OVER_SQRT_PI) * g)
                           * _exp(-(r.x(0) * r.x(0)))],
    Op.ATAN2: _v_atan2,
    Op.POW: _v_pow,
    Op.MOD: _v_mod,
    Op.FMOD: lambda r, g: [g, -(g * _rem_k(r))],
    Op.CBRT: lambda r, g: [g * (r.lit(1 / 3) * _ip2(r.ans))],
    Op.COPYSIGN: _v_copysign,
    Op.LOG1P: lambda r, g: [g / (r.x(0) + 1.0)],
    Op.EXPM1: lambda r, g: [g * (r.ans + 1.0)],
    Op.ASINH: lambda r, g: [g * _rsqrt(r.x(0) * r.x(0) + 1.0)],
    Op.ACOSH: lambda r, g: [g * _rsqrt(r.x(0) * r.x(0) - 1.0)],
    Op.ATANH: lambda r, g: [((1.0 / (r.x(0) + 1.0)) * g)
                            / (1.0 - r.x(0))],
    Op.LGAMMA: lambda r, g: [g * _digamma(r.x(0))],
    Op.CAST: lambda r, g: [g],
    Op.PRINT: lambda r, g: [g],
    Op.SELECT: lambda r, g: [None, select(r.mask(0), g, 0.0),
                             select(r.mask(0), r.lit(0.0), g)],
    Op.GATHER: _v_gather,
    Op.SCATTER: lambda r, g: _v_scatter(r, g, False),
    Op.SCATTER_ADD: lambda r, g: _v_scatter(r, g, True),
    Op.HSUM: lambda r, g: [g],
    Op.HPROD: _v_hprod,
    Op.HMIN: _v_hchoose,
    Op.HMAX: _v_hchoose,
    Op.PSUM: lambda r, g: [_full(g, r.n, r.dev).reverse().psum().reverse()],
    Op.REVERSE: lambda r, g: [_full(g, r.n, r.dev).reverse()],
    Op.COMPRESS: _v_compress,
}


def _j_gather(r, t):
    return _gather(t[0], r.raw(1))


def _j_scatter(r, t, add):
    base, val = t[0], t[2]
    if base is None:
        base = LazyArray.literal(0.0, r.n, _DTYPES[r.c], r.dev)
    if val is None:
        return base if add else _scatter(Op.SCATTER, base, r.raw(1),
                                         r.lit(0.0))
    return _scatter(Op.SCATTER_ADD if add else Op.SCATTER, base, r.raw(1),
                    val)


def _j_hprod(r, t):
    tt = t[0]
    for a, m, h in _prod_levels(r.x(0), r.dev):
        k = _iota(h, r.dev)
        hi = k + h
        ok = hi < m
        a2 = select(ok, _gather(a, hi), 1.0)
        t2 = select(ok, _gather(tt, hi), 0.0)
        tt = _gather(tt, k) * a2 + _gather(a, k) * t2
    return tt


def _j_minmax(r, t):
    return _sum(_mul(t[0], _balanced(r, 0)), _mul(t[1], _balanced(r, 1)))


def _j_hchoose(r, t):
    ind, cnt = _chosen(r)
    return (t[0] * ind).hsum() / cnt


def _j_mod(r, t):
    rem = _sum(t[0], _mul(None if t[1] is None else -t[1], _rem_k(r)))
    if t[1] is None:
        return rem
    return select(_do_plus(r), rem + t[1], rem)


def _j_copysign(r, t):
    h = select(r.x(0) >= 0.0, t[0], -t[0])
    return select(_sign_neg(r), -h, h)


def _j_atan2(r, t):
    a, b = r.x(0), r.x(1)
    den = a * a + b * b
    return _sum(_mul(t[0], b / den), _mul(t[1], -a / den))


def _j_pow(r, t):
    x, y = r.x(0), r.x(1)
    return _sum(_mul(t[0], y * _pow(x, y - 1.0)),
                _mul(t[1], _log(select(x == 0.0, r.lit(1.0), x)) * r.ans))


def _j_div(r, t):
    return _sum(None if t[0] is None else t[0] / r.x(1),
                None if t[1] is None
                else (-t[1] * r.x(0)) * _ip2(r.x(1)))


def _j_select(r, t):
    a = r.lit(0.0) if t[1] is None else t[1]
    b = r.lit(0.0) if t[2] is None else t[2]
    return select(r.mask(0), a, b)


_JVP = {
    Op.ADD: lambda r, t: _sum(t[0], t[1]),
    Op.SUB: lambda r, t: _sum(t[0], None if t[1] is None else -t[1]),
    Op.MUL: lambda r, t: _sum(_mul(t[0], r.x(1)), _mul(r.x(0), t[1])),
    Op.DIV: _j_div,
    Op.NEG: lambda r, t: -t[0],
    Op.ABS: lambda r, t: select(r.x(0) >= 0.0, t[0], -t[0]),
    Op.MIN: _j_minmax,
    Op.MAX: _j_minmax,
    Op.FMA: lambda r, t: _sum(_mul(t[0], r.x(1)), _mul(r.x(0), t[1]), t[2]),
    Op.SQRT: lambda r, t: t[0] * (0.5 / r.ans),
    Op.RSQRT: lambda r, t: t[0] * (-0.5 * (r.ans / r.x(0))),
    Op.RCP: lambda r, t: -t[0] * _ip2(r.x(0)),
    Op.EXP: lambda r, t: t[0] * r.ans,
    Op.EXP2: lambda r, t: r.lit(_LN2) * (t[0] * r.ans),
    Op.LOG: lambda r, t: t[0] / r.x(0),
    Op.LOG2: lambda r, t: (t[0] / r.x(0)) / r.lit(_LN2),
    Op.SIN: lambda r, t: t[0] * _cos(r.x(0)),
    Op.COS: lambda r, t: -(t[0] * _sin(r.x(0))),
    Op.TAN: lambda r, t: t[0] * (1.0 + r.ans * r.ans),
    Op.ASIN: lambda r, t: t[0] * _rsqrt(1.0 - r.x(0) * r.x(0)),
    Op.ACOS: lambda r, t: t[0] * -_rsqrt(1.0 - r.x(0) * r.x(0)),
    Op.ATAN: lambda r, t: t[0] / (1.0 + r.x(0) * r.x(0)),
    Op.SINH: lambda r, t: t[0] * _cosh(r.x(0)),
    Op.COSH: lambda r, t: t[0] * _sinh(r.x(0)),
    Op.TANH: lambda r, t: (t[0] + t[0] * r.ans) * (1.0 - r.ans),
    Op.ERF: lambda r, t: r.lit(_TWO_OVER_SQRT_PI) * (
        t[0] * _exp(-(r.x(0) * r.x(0)))),
    Op.ERFC: lambda r, t: r.lit(-_TWO_OVER_SQRT_PI) * (
        t[0] * _exp(-(r.x(0) * r.x(0)))),
    Op.ATAN2: _j_atan2,
    Op.POW: _j_pow,
    Op.MOD: _j_mod,
    Op.FMOD: lambda r, t: _sum(t[0], _mul(None if t[1] is None else -t[1],
                                          _rem_k(r))),
    Op.CBRT: lambda r, t: t[0] * (r.lit(1 / 3) * _ip2(r.ans)),
    Op.COPYSIGN: _j_copysign,
    Op.LOG1P: lambda r, t: t[0] / (r.x(0) + 1.0),
    Op.EXPM1: lambda r, t: t[0] * (r.ans + 1.0),
    Op.ASINH: lambda r, t: t[0] * _rsqrt(r.x(0) * r.x(0) + 1.0),
    Op.ACOSH: lambda r, t: t[0] * _rsqrt(r.x(0) * r.x(0) - 1.0),
    Op.ATANH: lambda r, t: (1.0 / (r.x(0) + 1.0)) * (t[0] / (1.0 - r.x(0))),
    Op.LGAMMA: lambda r, t: t[0] * _digamma(r.x(0)),
    Op.CAST: lambda r, t: t[0],
    Op.PRINT: lambda r, t: t[0],
    Op.SELECT: _j_select,
    Op.GATHER: _j_gather,
    Op.SCATTER: lambda r, t: _j_scatter(r, t, False),
    Op.SCATTER_ADD: lambda r, t: _j_scatter(r, t, True),
    Op.HSUM: lambda r, t: t[0].hsum(),
    Op.HPROD: _j_hprod,
    Op.HMIN: _j_hchoose,
    Op.HMAX: _j_hchoose,
    Op.PSUM: lambda r, t: t[0].psum(),
    Op.REVERSE: lambda r, t: t[0].reverse(),
    Op.COMPRESS: lambda r, t: LazyArray._record(
        Op.COMPRESS, r.c, r.n, t[0], r.mask(1), raw=True),
}

# the operands a rule differentiates (the rest: masks, indices, signs)
_SLOTS = {Op.SELECT: (1, 2), Op.GATHER: (0,), Op.SCATTER: (0, 2),
          Op.SCATTER_ADD: (0, 2), Op.COMPRESS: (0,), Op.COPYSIGN: (0,),
          Op.PRINT: (0,)}


def _activity(entries, seeds):
    """Per position: whether it depends on a seed leaf through the table."""
    act = [False] * len(entries)
    for i, e in enumerate(entries):
        if e[7]:
            act[i] = i in seeds
            continue
        if e[6] or e[2] not in _FLOAT_CODES or e[1] not in _VJP:
            continue
        dps = [p for p in e[4] if p != SENT]
        slots = _SLOTS.get(e[1], range(len(dps)))
        act[i] = any(k < len(dps) and act[dps[k]] for k in slots)
    return act


# ---------------------------------------------------------------------------
# replay and the two sweeps of one segment
# ---------------------------------------------------------------------------


def _replay(seg):
    """The segment's schedule recorded anew from its leaf buffers and its
    literal stream: a LazyArray per position (a PRINT passes its first
    operand through and prints nothing)."""
    dev = _dev_code(seg.device)
    vals = [None] * len(seg.entries)
    leaf_i = lit_i = 0
    for i, e in enumerate(seg.entries):
        op, code, size, deps, _, is_lit, is_data = e[1:]
        if is_lit:
            idx = _lib.ett_literal(code, int(seg.bits[lit_i]), size)
            lit_i += 1
            _trace._DEVICE[idx] = dev
            vals[i] = LazyArray(index=idx, _size=size, _code=code, _dev=dev)
        elif is_data:
            vals[i] = LazyArray(seg.leaf_bufs[leaf_i])
            leaf_i += 1
        elif op == Op.PRINT:
            vals[i] = vals[deps[0]]
        else:
            vals[i] = LazyArray._record(op, code, size, *[
                vals[p] for p in deps if p != SENT], raw=True)
    return vals


def _give(ct, pend, entries, p, d):
    """Add the contribution ``d`` to position ``p``'s cotangent; one that
    broadcast a size-1 operand is summed when the sweep reaches it,
    before its cast (JAX's unbroadcast comes first)."""
    e = entries[p]
    if e[3] == 1 and len(d) > 1:
        into = pend.setdefault(p, {})
        key = (len(d), d._code)
        into[key] = d if key not in into else into[key] + d
        return
    d = _cast(d, e[2])
    ct[p] = d if p not in ct else ct[p] + d


def _take(ct, pend, entries, p):
    g = ct.pop(p, None)
    for _, s in pend.pop(p, {}).items():
        h = _cast(s.hsum(), entries[p][2])
        g = h if g is None else g + h
    return g


def _reverse(seg, seeds, diff):
    """The adjoint sweep of one segment: ``seeds`` {output position:
    cotangent}; returns ({leaf position: cotangent}, {output position:
    total cotangent}), each at its entry's size. An output that feeds
    another output of the program gets its total (its own seed and what
    flows back through the later one) when the sweep reaches it."""
    entries = seg.entries
    vals = _replay(seg)
    act = _activity(entries, diff)
    outs = set(p for p in seg.out_positions if p != SENT)
    ct, pend, leaves, totals = dict(seeds), {}, {}, {}
    for i in range(len(entries) - 1, -1, -1):
        g = _take(ct, pend, entries, i)
        if g is None:
            continue
        e = entries[i]
        if i in outs:
            totals[i] = _full(g, e[3], seg.device)
        if e[7]:
            if i in diff:
                leaves[i] = _full(g, e[3], seg.device)
            continue
        if e[6] or not act[i]:
            continue
        r = _Lane(entries, vals, i, seg.device)
        for p, d in zip(r.dps, _VJP[e[1]](r, g)):
            if d is not None and act[p]:
                _give(ct, pend, entries, p, d)
    return leaves, totals


def _forward(seg, seeds):
    """The tangent sweep of one segment: ``seeds`` {leaf position:
    tangent}; returns {output position: tangent}."""
    entries = seg.entries
    vals = _replay(seg)
    tan = dict(seeds)
    for i, e in enumerate(entries):
        if e[6] or e[7] or e[2] not in _FLOAT_CODES or e[1] not in _JVP:
            continue
        dps = [p for p in e[4] if p != SENT]
        slots = _SLOTS.get(e[1], range(len(dps)))
        ts = [tan.get(p) if k in slots and entries[p][2] in _FLOAT_CODES
              else None for k, p in enumerate(dps)]
        if all(t is None for t in ts):
            continue
        ts = [None if t is None else _cast(t, e[2]) for t in ts]
        t = _JVP[e[1]](_Lane(entries, vals, i, seg.device), ts)
        if t is not None:
            tan[i] = _full(t, e[3], seg.device)
    return {p: tan[p] for p in seg.out_positions if p in tan}


def _seed(value, like_code, n, device):
    """``value`` broadcast to ``n`` lanes of code ``like_code``: a literal
    for a Python number (the kernels read it), else a data leaf."""
    if isinstance(value, (int, float, bool)):
        return LazyArray.literal(value, n, _DTYPES[like_code], device)
    t = torch.as_tensor(value, device=device).to(_DTYPES[like_code])
    return LazyArray(torch.broadcast_to(t.reshape(-1), (n,)).contiguous())


def _materialize(table):
    """Evaluate every LazyArray of ``table`` (one eval) in place."""
    _eval_ids([v.index for v in table.values()])


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------


def _vid(x) -> int:
    return _VERSION.get(x.index, x.index)


def _label_of(vid: int) -> str:
    buf = ctypes.create_string_buffer(256)
    n = _lib.ett_get_label(vid, buf, len(buf))
    return buf.value.decode() if n else ""


def _key_tag(key) -> str:
    """Stable string form of a kernel-cache key: hex for the structural
    hash; a key with print formats appends a process-stable digest of
    them."""
    if isinstance(key, int):
        return f"{key:016x}"
    h, sig = key
    d = hashlib.blake2s(repr(sig).encode(), digest_size=4).hexdigest()
    return f"{h:016x}p{d}"


def tape_whos() -> str:
    """Live table of recorded tape segments (the reference tape's whos,
    autodiff.cpp:1165): one row per segment with its program hash, input
    vids (with labels) and output vids, plus the bytes of the buffers the
    tape holds."""
    lines = ["  seg  hash              inputs -> outputs"
             "                      held bytes"]
    total = 0

    def fmt(vid):
        lbl = _label_of(vid)
        return f"{vid}:{lbl}" if lbl else str(vid)

    for i, seg in enumerate(_TAPE):
        held = sum(int(b.nbytes) for b in seg.leaf_bufs)
        total += held
        ins = ", ".join(fmt(v) for v in seg.leaf_vids[:6])
        if len(seg.leaf_vids) > 6:
            ins += f", ... ({len(seg.leaf_vids)} total)"
        outs = ", ".join(fmt(v) for v in seg.out_vids[:6] if v)
        lines.append(f"  {i:3d}  {_key_tag(seg.key)}  [{ins}] -> [{outs}]"
                     f"  {held}")
    lines.append(f"  segments: {len(_TAPE)}, gradients held: "
                 f"{len(_GRADS)}, total held input bytes: {total}")
    return "\n".join(lines)


def tape_graphviz() -> str:
    """DOT rendering of the recorded segment tape: data flow from input
    version vids through each segment to its outputs, with set_label
    names and label-prefix clustering (autodiff.cpp:1076-1163)."""
    lines = ["digraph tape {", "  rankdir=LR;",
             "  node [fontsize=10 shape=box style=filled "
             "fillcolor=\"#e0f0ff\"];"]
    var_nodes = {}
    clusters: dict = {}

    def var_node(vid):
        if vid in var_nodes:
            return var_nodes[vid]
        name = f"v{vid}"
        lbl = _label_of(vid)
        text = f"{vid}: {lbl}" if lbl else f"v{vid}"
        decl = (f"  {name} [label=\"{text}\" shape=ellipse "
                f"fillcolor=\"#ffffff\"];")
        if "/" in lbl:
            clusters.setdefault(lbl.split("/", 1)[0], []).append(decl)
        else:
            lines.append(decl)
        var_nodes[vid] = name
        return name

    for i, seg in enumerate(_TAPE):
        sname = f"seg{i}"
        lines.append(
            f"  {sname} [label=\"segment {i}\\nhash {_key_tag(seg.key)}\\n"
            f"{len(seg.leaf_vids)} in / "
            f"{sum(1 for v in seg.out_vids if v)} out\"];")
        for vid, buf in zip(seg.leaf_vids, seg.leaf_bufs):
            if buf.dtype.is_floating_point:
                lines.append(f"  {var_node(vid)} -> {sname};")
        for k, vid in enumerate(seg.out_vids):
            if vid and seg.out_diff[k]:
                lines.append(f"  {sname} -> {var_node(vid)};")
    for pfx, decls in clusters.items():
        lines.append(f"  subgraph cluster_{pfx} {{ label=\"{pfx}\";")
        lines.extend("  " + d for d in decls)
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


def clear_tape():
    """Release all recorded tape segments (and their held buffers);
    version entries of collected variables are pruned too."""
    _TAPE.clear()
    _PRODUCER.clear()
    for k in list(_VERSION):
        if not _lib.ett_var_exists(k):
            del _VERSION[k]


def requires_grad(x, flag: bool = True):
    """Mark a (leaf) array as differentiable (set_requires_gradient,
    autodiff.h); an unevaluated one is evaluated first. Recording starts
    at the mark: programs evaluated before it are not on the tape."""
    if flag:
        if not x.materialized:
            x.eval()
        _GRAD_ENABLED.add(x.index)
    else:
        _GRAD_ENABLED.discard(x.index)
    return x


def grad_enabled(x) -> bool:
    return x.index in _GRAD_ENABLED


def gradient(x):
    """The gradient accumulated by backward() / forward_from() passes, as
    a LazyArray on its segment's device: of a leaf, or of any
    intermediate that crossed an eval boundary. Zeros for an array on the
    tape that no gradient reached; raises for one never on the tape
    (evaluated before anything was marked, autodiff.h:1410)."""
    vid = _vid(x)
    g = _GRADS.get(vid)
    if g is None:
        if x.index not in _GRAD_ENABLED and vid not in _ON_TAPE:
            raise RuntimeError(
                "gradient: array was never recorded on the AD tape -- "
                "mark parameters with requires_grad BEFORE building and "
                "evaluating the computation (programs evaluated earlier "
                "are not re-recorded)")
        buf = _BUFFERS.get(x.index)
        device = buf.device if buf is not None else x.device
        if device is None:
            from .._device import resolve_device
            device = resolve_device(None)
        g = torch.zeros(len(x), dtype=x.dtype, device=device)
    return LazyArray(g)


def clear_gradients():
    _GRADS.clear()
    # prune freed vars EXCEPT live version vids: an evaluated scatter's op
    # var is freed at eval end, but _VERSION still routes the target's
    # gradient() through it
    keep = set(_VERSION.values())
    for k in list(_ON_TAPE):
        if not _lib.ett_var_exists(k) and k not in keep:
            _ON_TAPE.discard(k)


def _flush_side_effects():
    """A pending scatter or print is part of every schedule: it runs (and
    is recorded) before the tape builds its own programs."""
    if _lib.ett_num_side_effects():
        _eval_ids([])


def _store(cot):
    """Evaluate the cotangents ``cot`` {vid: LazyArray}, each added to the
    gradient already held, and keep them as the gradients."""
    items = [(vid, g if _GRADS.get(vid) is None
              else LazyArray(_GRADS[vid]) + g) for vid, g in cot.items()]
    _eval_ids([g.index for _, g in items])
    for vid, g in items:
        _GRADS[vid] = g.torch()


def adjoint_program(loss, grad_out=1.0):
    """The adjoint program of the tape from ``loss``, built and not
    evaluated: {version vid: its cotangent as a LazyArray}, for every
    array on the tape that the cotangent reaches (``loss`` evaluated, the
    tape kept). ``backward`` evaluates it; ``plain_eval`` of its values is
    its plain version."""
    if not loss.materialized:
        loss.eval()
    _flush_side_effects()
    with _own_evals("trace_vjp"):
        cot = {_vid(loss): _seed(grad_out, loss._code, len(loss),
                                 _BUFFERS[loss.index].device)}
        device = None
        for seg in reversed(_TAPE):
            seeds = {seg.out_positions[k]: cot[vid]
                     for k, vid in enumerate(seg.out_vids)
                     if vid and seg.out_diff[k] and vid in cot}
            if not seeds:
                continue
            if device is not None and seg.device != device:
                _materialize(cot)  # one program spans one device
            device = seg.device
            leaf_pos = seg.leaf_positions()
            diff = {p for k, p in enumerate(leaf_pos)
                    if seg.leaf_bufs[k].dtype.is_floating_point}
            leaves, totals = _reverse(seg, seeds, diff)
            for k, p in enumerate(leaf_pos):
                g = leaves.get(p)
                if g is not None:
                    vid = seg.leaf_vids[k]
                    cot[vid] = g if vid not in cot else cot[vid] + g
            for k, p in enumerate(seg.out_positions):
                vid = seg.out_vids[k]
                if vid and seg.out_diff[k] and p in totals:
                    cot[vid] = totals[p]  # its own seed and the chains
            del leaves, totals
    return cot


def backward(loss, grad_out=1.0, free: bool = True):
    """Reverse pass from ``loss`` into every differentiable array on the
    tape (backward(loss), autodiff.h:1490 -> autodiff.cpp:838); evaluates
    the loss first if needed and returns its primal value. The adjoint
    programs of all segments run as one eval. ``free=True`` releases the
    tape afterwards; pass False to run several backward passes."""
    cot = adjoint_program(loss, grad_out)
    with _own_evals("trace_vjp"):
        _store(cot)
    del cot
    if free:
        clear_tape()
    return _BUFFERS[loss.index]


def tangent_program(x, loss, tangent=1.0):
    """The tangent program of the tape from ``x`` to ``loss``, built and
    not evaluated: the loss's tangent as a LazyArray, or None where no
    tangent reaches it. Raises ValueError where x is not a leaf of the
    tape."""
    if x.index not in _GRAD_ENABLED:
        requires_grad(x)
    if not loss.materialized:
        loss.eval()
    _flush_side_effects()
    xv = _vid(x)
    if not any(xv in seg.leaf_vids for seg in _TAPE):
        raise ValueError(
            "forward_from: x does not appear on the tape. Either the "
            "loss is independent of x, or part of the chain was "
            "evaluated before requires_grad -- mark x BEFORE building "
            "and evaluating the loss")
    with _own_evals("trace_jvp"):
        tan = {xv: _seed(tangent, x._code, len(x),
                         _BUFFERS[x.index].device)}
        device = None
        for seg in _TAPE:
            leaf_pos = seg.leaf_positions()
            seeds = {p: tan[seg.leaf_vids[k]] for k, p in enumerate(leaf_pos)
                     if seg.leaf_vids[k] in tan
                     and seg.leaf_bufs[k].dtype.is_floating_point}
            if not seeds:
                continue
            if device is not None and seg.device != device:
                _materialize(tan)
            device = seg.device
            outs = _forward(seg, seeds)
            for k, p in enumerate(seg.out_positions):
                vid = seg.out_vids[k]
                if vid and seg.out_diff[k] and p in outs:
                    tan[vid] = outs[p] if vid not in tan \
                        else tan[vid] + outs[p]
            del outs
        return tan.get(_vid(loss))


def forward_from(x, loss, tangent=1.0, free: bool = True):
    """Forward mode from parameter ``x`` to ``loss`` (forward(x),
    autodiff.cpp:912): the tangent programs of the segments in order, one
    eval; d loss / d x goes into the loss's gradient slot. Returns (loss
    value, tangent). Mark x (or call this) BEFORE building the loss so
    the programs are recorded; raises ValueError where x is not a leaf of
    the tape."""
    t = tangent_program(x, loss, tangent)
    lv = _vid(loss)
    with _own_evals("trace_jvp"):
        if t is None:
            t = torch.zeros_like(_BUFFERS[loss.index])
            prev = _GRADS.get(lv)
            _GRADS[lv] = t if prev is None else prev + t
        else:
            total = t if _GRADS.get(lv) is None \
                else LazyArray(_GRADS[lv]) + t
            _eval_ids([t.index, total.index])
            t, _GRADS[lv] = t.torch(), total.torch()
    if free:
        clear_tape()
    return _BUFFERS[loss.index], t
