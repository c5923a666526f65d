"""The plain version of the lazy trace: one interpreter of a schedule over
PyTorch ops (counterpart of the reference's ``_OP_IMPL``, ``_emit_op``,
``_compile_schedule``'s ``_body`` and ``_chunked_exe``,
enoki_tpu/trace/__init__.py:112-211, :375-549).

It evaluates every schedule on the CPU, and it is the oracle that the
fused kernels of ``codegen`` are held against on the card
(``trace.plain_eval``); a CUDA ``LazyArray`` is never evaluated through
it. One interpreter, so no opcode can mean two things on two routes; the
kernels' C++ (``csrc/trace_kernel.cuh``) is written to give the same bits
on IEEE operations.

Values are carried in a working form: the float and signed types as
themselves, uint32 as int64 in [0, 2**32) and uint64 as the int64 of its
bit pattern (as ``types/u64.py`` carries 64-bit values), so that shifts,
compares and divisions of the unsigned types are logical and unsigned;
each result leaves in its storage dtype (``torch.uint32`` /
``torch.uint64``). The semantics kept from the reference (JAX's):

* ROUND rounds half to even; MOD is floored, FMOD takes the sign of the
  dividend; SIGN(+-0) is +-1;
* GATHER clamps its index into range; SCATTER / SCATTER_ADD count a
  negative index from the end and drop an index still out of range;
* a shift by the width or more gives 0 (an arithmetic right shift the
  sign); a float -> integer cast truncates and saturates, NaN -> 0;
* integer DIV truncates, x / 0 is -1 (all bits set) and MOD / FMOD by 0
  give x, as XLA's integer division does (the reference returns a float
  quotient under an integer dtype there);
* a float of fewer than 64 bits takes its transcendentals in float64,
  rounded once (ops/backend.py's ``_native``; DIGAMMA, the port's opcode
  80, too), its square roots through
  ``ops.router._sqrt_rn`` / ``_rsqrt_rn``; a 16-bit op is computed in
  float32 and rounded once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import horiz
from ..ops.router import _clz, _popcnt32, _rsqrt_rn, _sqrt_rn

F32, F64, I32, U32, BOOL, BF16, I64, U64, F16 = range(9)
FLOATS = (F32, F64, BF16, F16)
STORAGE = [torch.float32, torch.float64, torch.int32, torch.uint32,
           torch.bool, torch.bfloat16, torch.int64, torch.uint64,
           torch.float16]
# the working dtype of each code
WORK = [torch.float32, torch.float64, torch.int32, torch.int64, torch.bool,
        torch.bfloat16, torch.int64, torch.int64, torch.float16]
WIDTH = {I32: 32, U32: 32, I64: 64, U64: 64}
SIGNED = (I32, I64)
M32 = 0xFFFFFFFF
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
SENT = 0xFFFFFFFF

# opcodes (trace.Op's numbers; this module imports nothing of trace so
# that codegen and the tests can use it on its own)
(LEAF, ADD, SUB, MUL, DIV, NEG, ABS, MIN, MAX, FMA, SQRT, RSQRT, RCP,
 FLOOR, CEIL, ROUND, TRUNC, EXP, EXP2, LOG, LOG2, SIN, COS, TAN, ASIN,
 ACOS, ATAN, SINH, COSH, TANH, ERF, ATAN2, POW, MOD, EQ, NE, LT, LE, GT,
 GE, AND, OR, XOR, NOT, SELECT, CAST, IOTA, GATHER, SCATTER, SCATTER_ADD,
 HSUM, HPROD, HMIN, HMAX, ALL, ANY, COUNT, PSUM, REVERSE, SHL, SHR,
 POPCNT, CBRT, SIGN, COPYSIGN, LOG1P, EXPM1, ASINH, ACOSH, ATANH,
 ERFC, LGAMMA, ISNAN, ISINF, ISFINITE, COMPRESS, FMOD,
 BITCAST, CLZ, PRINT) = range(80)
# the port's own opcode after the reference's 80: digamma, LGAMMA's
# derivative, which only the tape's adjoint and tangent programs record
DIGAMMA = 80

COMPARES = (EQ, NE, LT, LE, GT, GE)
PREDICATES = (ISNAN, ISINF, ISFINITE)
# ops that read other lanes than their own, or the whole array: they run
# between the fused kernels on the card (``horizontal``)
HORIZONTAL = (HSUM, HPROD, HMIN, HMAX, ALL, ANY, COUNT, PSUM, COMPRESS)


def promote(a, b):
    from . import _PROMOTE
    return _PROMOTE[a][b]


# ---------------------------------------------------------------------------
# working form <-> storage, and the casts
# ---------------------------------------------------------------------------


def to_work(t, code):
    """A storage tensor in its working form."""
    if code == U32:
        return t.view(torch.int32).to(torch.int64) & M32
    if code == U64:
        return t.view(torch.int64)
    return t


def to_storage(w, code):
    """A working value in its storage dtype."""
    if code == U32:
        return (((w + (1 << 31)) & M32) - (1 << 31)).to(torch.int32).view(
            torch.uint32)
    if code == U64:
        return w.view(torch.uint64)
    return w


def _wrap(v, code):
    """An int64 taken modulo 2**w as the working form of ``code``."""
    if code == I32:
        return (((v + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)
    if code == U32:
        return v & M32
    return v


def _u64_to_float(w, dt):
    """The unsigned value of uint64 bits, rounded once to ``dt``: the
    halved value with its lost bit kept as a sticky bit, then doubled."""
    half = ((w >> 1) & I64_MAX) | (w & 1)
    return torch.where(w < 0, half.to(dt) * 2, w.to(dt))


def _float_to_int(x, code):
    """Truncate toward zero with saturation, NaN -> 0 (cvt.rzi)."""
    r = torch.where(torch.isnan(x), 0.0, x.double())
    if code == I32:
        return r.clamp(-2.0 ** 31, 2.0 ** 31 - 1).trunc().to(torch.int32)
    if code == U32:
        return r.clamp(0.0, 2.0 ** 32 - 1).trunc().to(torch.int64)
    if code == I64:
        r = r.clamp(min=-2.0 ** 63).trunc()
        big = r >= 2.0 ** 63
        return torch.where(big, I64_MAX, torch.where(big, 0.0, r).to(
            torch.int64))
    r = r.clamp(min=0.0).trunc()  # U64
    hi, top = r >= 2.0 ** 63, r >= 2.0 ** 64
    low = torch.where(hi, 0.0, r).to(torch.int64)
    high = torch.where(hi & ~top, r - 2.0 ** 63, 0.0).to(torch.int64) \
        + I64_MIN
    return torch.where(top, -1, torch.where(hi, high, low))


def convert(w, fc, tc):
    """CAST from code ``fc`` to ``tc``, on working values."""
    if fc == tc:
        return w
    if tc == BOOL:
        return w != 0
    if tc in FLOATS:
        dt = STORAGE[tc]
        if fc == U64:
            return _u64_to_float(w, torch.float32 if tc in (BF16, F16)
                                 else dt).to(dt)
        if fc in (F64, I64, U32, I32) and tc in (BF16, F16):
            return w.to(torch.float32).to(dt)  # through float32
        return w.to(dt)
    if fc in FLOATS:
        return _float_to_int(w, tc)
    return _wrap(w.to(torch.int64), tc)


def bitcast(w, fc, tc):
    return to_work(to_storage(w, fc).view(STORAGE[tc]), tc)


# the dtype a literal is filled in: the signed view of the unsigned ones
# (a fill of uint32 / uint64 is not in every PyTorch)
_FILL = [torch.float32, torch.float64, torch.int32, torch.int32, torch.bool,
         torch.bfloat16, torch.int64, torch.int64, torch.float16]


def fill(bits, code, size, device):
    """A literal's 64-bit pattern as a storage tensor of ``size`` on
    ``device``: a fill from a Python number (no host-to-device copy), of
    a value the dtype holds exactly."""
    b = np.asarray([bits], np.uint64)
    if code == BOOL:
        v = bool(bits)
    elif code == BF16:  # the float32 of the pattern holds it exactly
        v = float(np.asarray([bits << 16], np.uint64).astype(np.uint32)
                  .view(np.float32)[0])
    else:
        npdt = np.dtype([np.float32, np.float64, np.int32, np.int32, None,
                         None, np.int64, np.int64, np.float16][code])
        carrier = {2: np.uint16, 4: np.uint32, 8: np.uint64}[npdt.itemsize]
        v = b.astype(carrier).view(npdt)[0].item()
    t = torch.full((size,), v, dtype=_FILL[code], device=device)
    return t.view(STORAGE[code]) if code in (U32, U64) else t


def literal(bits, code, device):
    """A literal's 64-bit pattern as a working value of shape (1,)."""
    return to_work(fill(bits, code, 1, device), code)


# ---------------------------------------------------------------------------
# the elementwise ops, on working values already converted to ``code``
# ---------------------------------------------------------------------------


def _compute(code):
    """The dtype an op of ``code`` is computed in."""
    return torch.float32 if code in (BF16, F16) else WORK[code]


def _arith(fn):
    """A float op computed in float32 for 16-bit codes and rounded once;
    integers wrap at their width."""
    def op(code, *xs):
        if code in FLOATS:
            cd = _compute(code)
            return fn(*(x.to(cd) for x in xs)).to(STORAGE[code])
        if code == BOOL:
            return fn(*(x.to(torch.int64) for x in xs)) != 0
        return _wrap(fn(*(x.to(torch.int64) for x in xs)), code)
    return op


def _native(fn):
    """A transcendental: float64 in, rounded once to the code's dtype."""
    def op(code, x):
        if code == F64:
            return fn(x)
        return fn(x.double()).to(torch.float32).to(STORAGE[code])
    return op


def _cbrt(x):
    """cbrt in float64: pow(|x|, 1/3) and one Newton step, signed."""
    a = x.abs()
    y = torch.pow(a, 1.0 / 3.0)
    y = torch.where((y > 0) & torch.isfinite(y),
                    y - (y * y * y - a) / (3.0 * y * y), y)
    return torch.copysign(y, x)


def _unsigned_key(w, code):
    """An order-preserving signed key of an unsigned working value."""
    return w ^ I64_MIN if code == U64 else w


def _minmax(is_min):
    def op(code, a, b):
        if code in FLOATS:
            r = torch.minimum(a, b) if is_min else torch.maximum(a, b)
            # jnp's zeros: min takes the sign bit, max the one without
            keep_a = torch.signbit(a) == is_min
            return torch.where(a == b, torch.where(keep_a, a, b), r)
        ka, kb = _unsigned_key(a, code), _unsigned_key(b, code)
        less = ka < kb
        return torch.where(less == is_min, a, b)
    return op


def _udivmod64(a, b):
    """Unsigned 64-bit quotient and remainder of bit patterns, b != 0:
    restoring division, one bit a step."""
    q = torch.zeros_like(a)
    r = torch.zeros_like(a)
    kb = b ^ I64_MIN
    for i in range(63, -1, -1):
        r = (r << 1) | ((a >> i) & 1)
        ge = (r ^ I64_MIN) >= kb
        r = torch.where(ge, r - b, r)
        q = q | (ge.to(torch.int64) << i)
    return q, r


def _int_div(code, a, b, want):
    """Integer division (``want``: "div" truncated quotient, "rem"
    truncated remainder) with XLA's x / 0 = -1 and x % 0 = x."""
    zero = b == 0
    if code == U64:
        q, r = _udivmod64(a, torch.where(zero, 1, b))
        return torch.where(zero, -1 if want == "div" else a,
                           q if want == "div" else r)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    over = (a64 == I64_MIN) & (b64 == -1)  # int64's one overflow
    bs = torch.where(zero | over, 1, b64)
    q = torch.div(a64, bs, rounding_mode="trunc")
    if want == "div":
        q = torch.where(zero, -1, torch.where(over, I64_MIN, q))
        return _wrap(q, code)
    r = torch.where(zero, a64, torch.where(over, 0, a64 - q * bs))
    return _wrap(r, code)


def _div(code, a, b):
    if code in FLOATS:
        cd = _compute(code)
        return (a.to(cd) / b.to(cd)).to(STORAGE[code])
    if code == BOOL:
        return a
    return _int_div(code, a, b, "div")


def _fmod(code, a, b):
    if code in FLOATS:
        cd = _compute(code)
        return torch.fmod(a.to(cd), b.to(cd)).to(STORAGE[code])
    return _int_div(code, a, b, "rem")


def _mod(code, a, b):
    """Floored remainder: jnp.remainder's rem + (b where the signs of rem
    and b differ)."""
    r = _fmod(code, a, b)
    if code in (U32, U64, BOOL):
        return r
    flip = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(flip, _arith(lambda x, y: x + y)(code, r, b), r)


def _pow(code, a, b):
    if code in FLOATS:
        if code == F64:
            return torch.pow(a, b)
        return torch.pow(a.double(), b.double()).to(torch.float32).to(
            STORAGE[code])
    # integers: exponentiation by squaring, wrapping; a negative exponent
    # gives the truncated quotient 1 / a**|b| (0 unless a is 1 or -1)
    a64, e = a.to(torch.int64), b.to(torch.int64)
    if code == U64:
        neg = torch.zeros_like(e, dtype=torch.bool)
    else:
        neg = e < 0
    r = torch.ones_like(a64)
    base = a64
    e = torch.where(neg, 0, e)
    for _ in range(64):
        r = torch.where((e & 1) == 1, r * base, r)
        base = base * base
        e = (e >> 1) & I64_MAX
    inv = torch.where(a64 == 1, 1, torch.where(
        a64 == -1, torch.where((b.to(torch.int64) & 1) == 1, -1, 1), 0))
    return _wrap(torch.where(neg, inv, r), code)


def _shift(left):
    def op(code, a, s):
        w = WIDTH.get(code)
        if w is None:
            raise TypeError("a shift needs an integer dtype")
        v, k = a.to(torch.int64), s.to(torch.int64)
        ok = (k >= 0) & (k < w)
        k = torch.where(ok, k, 0)
        if left:
            return _wrap(torch.where(ok, v << k, 0), code)
        if code in SIGNED:  # arithmetic: out of range gives the sign
            return _wrap(torch.where(ok, v >> k, v >> (w - 1)), code)
        if code == U64:  # logical on the int64 of the bit pattern
            r = torch.where(k == 0, v, (v >> k) & ((1 << (64 - k)) - 1))
            return torch.where(ok, r, 0)
        return torch.where(ok, v >> k, 0)
    return op


def _sign(code, x):
    if code in FLOATS:
        return torch.copysign(torch.ones_like(x), x)
    if code in SIGNED:
        return torch.where(x < 0, -1, 1).to(x.dtype)
    return torch.ones_like(x)


def _abs(code, x):
    if code in FLOATS or code in SIGNED:
        return torch.abs(x)
    return x


def _neg(code, x):
    if code in FLOATS:
        return -x
    return _wrap(-x.to(torch.int64), code)


def _not(code, x):
    if code == BOOL:
        return ~x
    return _wrap(~x.to(torch.int64), code)


def _bits_of(code, x):
    """(bit pattern as int64, width) of an integer working value."""
    w = WIDTH[code]
    v = x.to(torch.int64)
    return (v & M32 if w == 32 else v), w


def _popcnt(code, x):
    v, w = _bits_of(code, x)
    n = _popcnt32(v & M32) + (_popcnt32((v >> 32) & M32) if w == 64 else 0)
    return _wrap(n, code)


def _clz_op(code, x):
    v, w = _bits_of(code, x)
    return _wrap(_clz(v, w), code)


def _float_only(fn, name):
    def op(code, *xs):
        if code not in FLOATS:
            raise TypeError(f"{name} needs a float dtype")
        return fn(code, *xs)
    return op


def _sqrt(code, x):
    return _sqrt_rn(x)


def _rsqrt(code, x):
    return _rsqrt_rn(x)


def _rcp(code, x):
    return _div(code, torch.ones_like(x), x)


def _rounding(fn):
    def op(code, x):
        return fn(x) if code in FLOATS else x
    return op


def _copysign(code, a, b):
    return torch.copysign(a, b)


def _bitwise(fn):
    def op(code, a, b):
        if code in FLOATS:
            raise TypeError("a bitwise op needs an integer or bool dtype")
        return fn(a, b)
    return op


ELEMENTWISE = {
    ADD: _arith(lambda a, b: a + b),
    SUB: _arith(lambda a, b: a - b),
    MUL: _arith(lambda a, b: a * b),
    DIV: _div,
    NEG: _neg,
    ABS: _abs,
    MIN: _minmax(True),
    MAX: _minmax(False),
    FMA: _arith(lambda a, b, c: a * b + c),
    SQRT: _float_only(_sqrt, "sqrt"),
    RSQRT: _float_only(_rsqrt, "rsqrt"),
    RCP: _float_only(_rcp, "rcp"),
    FLOOR: _rounding(torch.floor),
    CEIL: _rounding(torch.ceil),
    ROUND: _rounding(torch.round),
    TRUNC: _rounding(torch.trunc),
    EXP: _native(torch.exp),
    EXP2: _native(torch.exp2),
    LOG: _native(torch.log),
    LOG2: _native(torch.log2),
    SIN: _native(torch.sin),
    COS: _native(torch.cos),
    TAN: _native(torch.tan),
    ASIN: _native(torch.asin),
    ACOS: _native(torch.acos),
    ATAN: _native(torch.atan),
    SINH: _native(torch.sinh),
    COSH: _native(torch.cosh),
    TANH: _native(torch.tanh),
    ERF: _native(torch.erf),
    ATAN2: lambda code, a, b: (
        torch.atan2(a, b) if code == F64 else torch.atan2(
            a.double(), b.double()).to(torch.float32).to(STORAGE[code])),
    POW: _pow,
    MOD: _mod,
    AND: _bitwise(lambda a, b: a & b),
    OR: _bitwise(lambda a, b: a | b),
    XOR: _bitwise(lambda a, b: a ^ b),
    NOT: _not,
    SHL: _shift(True),
    SHR: _shift(False),
    POPCNT: _popcnt,
    CBRT: _native(_cbrt),
    SIGN: _sign,
    COPYSIGN: _float_only(_copysign, "copysign"),
    LOG1P: _native(torch.log1p),
    EXPM1: _native(torch.expm1),
    ASINH: _native(torch.asinh),
    ACOSH: _native(torch.acosh),
    ATANH: _native(torch.atanh),
    ERFC: _native(torch.erfc),
    LGAMMA: _native(torch.lgamma),
    DIGAMMA: _native(torch.digamma),
    FMOD: _fmod,
    CLZ: _clz_op,
}


def _compare(op, code, a, b):
    ka, kb = _unsigned_key(a, code), _unsigned_key(b, code)
    return {EQ: torch.eq, NE: torch.ne, LT: torch.lt, LE: torch.le,
            GT: torch.gt, GE: torch.ge}[op](ka, kb)


def _predicate(op, code, x):
    if code not in FLOATS:
        return (torch.ones_like(x, dtype=torch.bool) if op == ISFINITE
                else torch.zeros_like(x, dtype=torch.bool))
    return {ISNAN: torch.isnan, ISINF: torch.isinf,
            ISFINITE: torch.isfinite}[op](x)


# ---------------------------------------------------------------------------
# the ops that read other lanes: shared with codegen, on storage tensors
# ---------------------------------------------------------------------------


def horizontal(op, code, x, mask=None):
    """HSUM ... COMPRESS of the storage tensor ``x`` (the port's eager
    ops, ``ops.horiz``), in storage dtypes; the reductions keep a
    1-element result."""
    if code == U64 and op in (COMPRESS, PSUM):
        # through the int64 view of the bits (PyTorch has no uint64
        # index_put_ or cumsum; a prefix sum wraps alike)
        return horizontal(op, I64, x.view(torch.int64), mask).view(
            torch.uint64)
    if op == COMPRESS:
        return horiz.compress(x, mask.to(torch.bool))[0]
    if op == PSUM:
        return horiz.psum(x)
    if op in (ALL, ANY, COUNT):
        m = x.to(torch.bool)
        r = {ALL: horiz.all_, ANY: horiz.any_, COUNT: horiz.count}[op](m)
        return r.reshape(1)
    if code == U64 and op in (HMIN, HMAX):
        k = x.view(torch.int64) ^ I64_MIN
        r = (k.amin() if op == HMIN else k.amax()) ^ I64_MIN
        return r.reshape(1).view(torch.uint64)
    if code == U64:  # sums and products wrap as int64 does
        fn = horiz.hsum if op == HSUM else horiz.hprod
        return fn(x.view(torch.int64)).reshape(1).view(torch.uint64)
    fn = {HSUM: horiz.hsum, HPROD: horiz.hprod, HMIN: horiz.hmin,
          HMAX: horiz.hmax}[op]
    return fn(x).reshape(1).to(STORAGE[code])


def scatter_into(target, code, index, value, add):
    """Write (``add``: add) ``value`` into the storage tensor ``target``
    (in place) at ``index``: a negative index counts from the end, one
    still out of range is dropped; ``value`` and ``index`` broadcast."""
    n = target.shape[0]
    idx = index.to(torch.int64)
    # the unsigned values through the signed view of their bits: PyTorch's
    # CUDA build indexes no uint32 / uint64 tensor
    signed = {torch.uint32: torch.int32, torch.uint64: torch.int64}.get(
        value.dtype)
    if signed is not None:
        value = value.view(signed)
    idx, value = torch.broadcast_tensors(idx, value)
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    idx, value = idx[keep], value[keep]
    if code == U32:
        w = to_work(target, code)
        v = value.to(torch.int64) & M32
        w = w.index_add_(0, idx, v) if add else w.index_put_((idx,), v)
        target.copy_(to_storage(w & M32, code))
    elif code == U64:
        t = target.view(torch.int64)
        v = value.to(torch.int64)
        t.index_add_(0, idx, v) if add else t.index_put_((idx,), v)
    elif add and target.dtype in (torch.float16, torch.bfloat16):
        # PyTorch's CUDA index_add_ of 16-bit floats adds two slots at a
        # time, +0.0 into the neighbour, which turns a neighbour's -0.0
        # into +0.0; one add at a time leaves -0.0 where the base is -0.0
        # and nothing but -0.0 is added, as here
        v = value.to(target.dtype)
        moved = torch.zeros_like(target, dtype=torch.bool).index_fill_(
            0, idx[~(torch.signbit(v) & (v == 0))], True)
        keeps = torch.signbit(target) & (target == 0) & ~moved
        target.index_add_(0, idx, v)
        target.copy_(torch.where(keeps, torch.zeros_like(target).neg_(),
                                 target))
    elif add:
        target.index_add_(0, idx, value.to(target.dtype))
    else:
        target.index_put_((idx,), value.to(target.dtype))
    return target


def print_values(fmt, tensors):
    """The host's print of a PRINT op: each operand as numpy prints it
    (bfloat16 as float32)."""
    arrs = []
    for t in tensors:
        t = t.detach().cpu()
        arrs.append((t.float() if t.dtype == torch.bfloat16 else t).numpy())
    print(fmt.format(*arrs), flush=True)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def evaluate(e, code_of, args, device, fmts):
    """One non-leaf entry ``e`` on its working arguments ``args``
    (``code_of``: their codes)."""
    vid, op, out, size = e[0], e[1], e[2], e[3]
    if op == IOTA:
        return convert(torch.arange(size, dtype=torch.int64, device=device),
                       I64, out)
    if op == CAST:
        return convert(args[0], code_of[0], out)
    if op == BITCAST:
        return bitcast(args[0], code_of[0], out)
    if op == PRINT:
        print_values(fmts.get(vid, "{}"), [
            to_storage(a.expand(size) if a.shape[0] == 1 else a, c)
            for a, c in zip(args, code_of)])
        return args[0]
    if op in COMPARES:
        pc = promote(code_of[0], code_of[1])
        return _compare(op, pc, convert(args[0], code_of[0], pc),
                        convert(args[1], code_of[1], pc))
    if op in PREDICATES:
        return _predicate(op, code_of[0], args[0])
    if op == SELECT:
        m = convert(args[0], code_of[0], BOOL)
        a = convert(args[1], code_of[1], out)
        b = convert(args[2], code_of[2], out)
        return torch.where(m, a, b)
    if op == GATHER:
        src = args[0]
        idx = args[1].to(torch.int64)
        if code_of[1] == U64:
            idx = torch.where(idx < 0, I64_MAX, idx)
        return src[idx.clamp(0, src.shape[0] - 1)]
    if op == REVERSE:
        return torch.flip(args[0], (0,))
    if op in (SCATTER, SCATTER_ADD):
        tgt = to_storage(args[0].expand(size), out).clone()
        val = to_storage(convert(args[2], code_of[2], out), out)
        return to_work(scatter_into(tgt, out, args[1], val,
                                    op == SCATTER_ADD), out)
    if op in HORIZONTAL:
        x = args[0]
        mask = None if op != COMPRESS else args[1].expand(x.shape[0])
        return to_work(horizontal(op, code_of[0], to_storage(x, code_of[0]),
                                  mask), out)
    fn = ELEMENTWISE.get(op)
    if fn is None:
        raise NotImplementedError(f"trace opcode {op}")
    return fn(out, *(convert(a, c, out) for a, c in zip(args, code_of)))


def run(entries, out_positions, leaves, bits, codes, fmts, device):
    """The outputs (storage dtypes, each of its entry's size) of a
    schedule (``trace._read_schedule``'s entries) on ``device``, op by op.
    The reference segments its program by ``config.max_fused_ops``
    (``_chunked_exe``) to bound XLA's compile time; an interpreter has
    nothing to compile, and every value here is materialized anyway, so
    that setting changes no value (it caps the fused kernels instead)."""
    # each value is dropped after its last reader (a long chain would
    # otherwise hold every intermediate); the outputs are kept
    last = {}
    for i, e in enumerate(entries):
        for p in e[4]:
            if p != SENT:
                last[p] = i
    keep = set(out_positions)
    vals = {}
    leaf_i = lit_i = 0
    for i, ent in enumerate(entries):
        vid, op, code, size, deps, _, is_lit, is_data = ent
        if is_lit:
            v = literal(int(bits[lit_i]), int(codes[lit_i]), device)
            lit_i += 1
            if size != 1:
                v = v.expand(size)
        elif is_data:
            v = to_work(leaves[leaf_i], code)
            leaf_i += 1
        else:
            dps = [p for p in deps if p != SENT]
            args = [vals[p] for p in dps]
            code_of = [entries[p][2] for p in dps]
            v = evaluate(ent, code_of, args, device, fmts)
            for p in dps:
                if last[p] == i and p not in keep:
                    vals.pop(p, None)
        vals[i] = v
    outs = []
    for p in out_positions:
        if p == SENT:
            outs.append(None)
            continue
        v, size, code = vals[p], entries[p][3], entries[p][2]
        if v.shape[0] != size:
            v = v.expand(size)
        outs.append(to_storage(v, code).contiguous())
    return outs
