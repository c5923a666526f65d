"""The lazy trace's fused kernels (enoki_tpu_torch/trace/codegen.py and
csrc/trace_kernel.cuh) checked without a card: the emitted source of each
schedule, built by the host's C++ compiler (g++ -O1 -ffp-contract=off:
each kernel's per-lane statements in a plain loop over the lanes, the
skeleton's host half), run over the same inputs as the plain interpreter
(trace/plain.py).

* IEEE-only programs (random DAGs in f32 and f64; integer, cast, 16-bit,
  gather / scatter / reverse / iota programs) are bit-equal (NaN as NaN);
  programs with transcendentals within 1 ulp in f32 (the host's libm and
  PyTorch's float64 functions are both within an ulp of the truth, and
  one rounding to f32 rarely meets their difference), 2 in f64;
* the cut into fused runs: one kernel for an elementwise program and for
  a histogram, a reduction between two kernels, a run ended by a gather
  of a value it computes, max_fused_ops entries a run at most;
* the emitted source and the structural hash are the same on a retrace,
  and a changed literal changes neither (the kernels read the stream);
* a print fires with the plain version's text;
* the tape's adjoint and tangent programs (trace/tape.py) are schedules
  like any other: backward() and forward_from() through the host build's
  kernels against the plain interpreter, bit-equal on IEEE-only programs,
  within an ulp with transcendentals (float64: 2, or 4 of the largest
  value where a rule subtracts the result from 1), sums (atomics on the
  card) within
  2^-22 of the sum of the magnitudes of their terms; digamma, the port's
  opcode 80 (LGAMMA's derivative), bit-equal to torch.digamma in float64
  on the host (the same algorithm, libm's log and tan).

The __global__ kernels around the same statements are held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py phase 28).
"""

import ctypes
import hashlib
import subprocess

import numpy as np
import pytest
import torch

import enoki_tpu_torch.trace as P
from enoki_tpu_torch import _build
from enoki_tpu_torch.trace import codegen, plain

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    P.reset()
    yield
    P.reset()


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("trace_host")

    def host_build(text):
        stem = hashlib.sha256(text.encode()).hexdigest()[:16]
        src, out = out_dir / f"{stem}.cpp", out_dir / f"{stem}.so"
        if not out.exists():
            src.write_text(text)
            proc = subprocess.run(
                ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                 "-shared", "-I", str(_build.CSRC_DIR), "-o", str(out),
                 str(src)], capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[:4000]
        return out
    return host_build


def L(a):
    return P.LazyArray(np.asarray(a), device="cpu")


def schedule(arrays, max_ops=0):
    ids = [P._PENDING_SCATTER.get(a.index, a.index) for a in arrays]
    n = P._lib.ett_schedule((ctypes.c_uint32 * len(ids))(*ids), len(ids))
    key = P._lib.ett_schedule_hash()
    entries, outs = P._read_schedule(n)
    buf = (ctypes.c_uint32 * max(n, 1))()
    nd = P._lib.ett_schedule_data_ids(buf, n)
    leaves = [P._BUFFERS[buf[i]] for i in range(nd)]
    bits, codes = P._collect_literals(n)
    fmts = {e[0]: P._PRINT_FMT.get(e[0], "{}") for e in entries
            if e[1] == P.Op.PRINT}
    plan = codegen.Plan(entries, outs, fmts, max_ops, key)
    return plan, key, entries, outs, leaves, bits, codes, fmts


def both(build, *arrays, max_ops=0):
    """(plan, the host build's outputs, the plain interpreter's)."""
    plan, _, entries, outs, leaves, bits, codes, fmts = schedule(arrays,
                                                                 max_ops)
    got = plan.run(leaves, torch.from_numpy(bits.view(np.int64)), bits,
                   codes, CPU, build=build)
    want = plain.run(entries, outs, leaves, bits, codes, fmts, CPU)
    return plan, got[:len(arrays)], want[:len(arrays)]


def bits_of(t):
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want) if want.dtype.is_floating_point else None
    if nan is not None:
        assert torch.equal(torch.isnan(got), nan)
        got, want = got[~nan], want[~nan]
    assert torch.equal(bits_of(got), bits_of(want)), (got, want)


def within_ulp(got, want, ulp=1):
    assert got.dtype == want.dtype
    g, w = got.double(), want.double()
    sp = torch.from_numpy(np.spacing(np.abs(want.numpy())).astype(
        np.float64))
    ok = ((g - w).abs() <= ulp * sp) | (g == w) | (g.isnan() & w.isnan())
    assert ok.all(), (g[~ok], w[~ok])


# -- random IEEE programs ----------------------------------------------------

IEEE = [
    (2, lambda a, b: a + b), (2, lambda a, b: a - b),
    (2, lambda a, b: a * b), (2, lambda a, b: a / (abs(b) + 0.5)),
    (2, P.minimum), (2, P.maximum), (3, P.fmadd), (1, lambda a: -a),
    (1, abs), (1, lambda a: P.sqrt(abs(a) + 0.25)),
    (1, lambda a: P.rsqrt(abs(a) + 0.5)), (1, lambda a: P.rcp(a + 3.0)),
    (2, lambda a, b: P.select(a > b, a, b * 0.5)),
    (1, lambda a: P.floor(a * 3.0)), (1, lambda a: P.round(a * 2.5)),
    (1, lambda a: P.trunc(a * 1.5)), (1, lambda a: P.ceil(a)),
    (2, lambda a, b: a % (abs(b) + 0.25)),
    (2, lambda a, b: P.fmod(a, abs(b) + 0.25)),
    (1, lambda a: P.sign(a) * 0.5 + a),
    (2, lambda a, b: P.copysign(a, b)),
    (2, lambda a, b: (a < b).cast(a.dtype) + a),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(8))
def test_random_ieee_programs_are_bit_equal(build, seed, dtype):
    rng = np.random.default_rng(40 + seed)
    n = int(rng.integers(16, 200))
    pool = [L(rng.uniform(-3, 3, n).astype(dtype)) for _ in range(3)]
    edge = rng.uniform(-3, 3, n).astype(dtype)
    edge[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-30]
    pool.append(L(edge))
    for _ in range(int(rng.integers(10, 40))):
        ar, f = IEEE[int(rng.integers(len(IEEE)))]
        pool.append(f(*[pool[int(rng.integers(len(pool)))]
                        for _ in range(ar)]))
    plan, (got,), (want,) = both(build, pool[-1])
    assert len(plan.runs) == 1
    bit_equal(got, want)


@pytest.mark.parametrize("name", ["sin", "cos", "tanh", "exp", "log1p",
                                  "expm1", "atan", "erf", "erfc", "lgamma",
                                  "cbrt", "asinh", "log2", "exp2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transcendentals_within_an_ulp(build, name, dtype):
    x = L(np.linspace(0.05, 3.0, 101).astype(dtype))
    _, (got,), (want,) = both(build, getattr(P, name)(x) + x)
    # float64: the host's libm and PyTorch's CPU functions differ by up
    # to an ulp, and the sum can round that to 2 (on the card both are
    # libdevice's)
    within_ulp(got, want, 1 if dtype == np.float32 else 2)


# -- integers, casts and 16-bit floats ---------------------------------------

INT_EDGES = {
    np.int32: [0, 1, -1, 7, -7, 2 ** 31 - 1, -2 ** 31, 123456789],
    np.uint32: [0, 1, 7, 2 ** 31, 2 ** 32 - 1, 123456789, 33, 64],
    np.int64: [0, 1, -1, 7, -7, 2 ** 63 - 1, -2 ** 63, 2 ** 40 + 3],
    np.uint64: [0, 1, 7, 2 ** 63, 2 ** 64 - 1, 2 ** 40 + 3, 65, 33],
}


@pytest.mark.parametrize("dtype", list(INT_EDGES))
def test_integer_programs_are_bit_equal(build, dtype):
    rng = np.random.default_rng(3)
    e = np.array(INT_EDGES[dtype], dtype)
    a = np.concatenate([e, rng.integers(-100, 100, 24).astype(dtype)])
    b = np.concatenate([e[::-1], rng.integers(-100, 100, 24).astype(dtype)])
    s = rng.integers(-2, 70, len(a)).astype(dtype)
    x, y, k = L(a), L(b), L(s)
    outs = [x + y, x - y, x * y, x / y, x % y, P.fmod(x, y), x << k,
            x >> k, x & y, x | y, x ^ y, ~x, -x, abs(x), P.minimum(x, y),
            P.maximum(x, y), P.popcnt(x), P.clz(x), P.sign(x),
            (x < y).cast(dtype), (x >= y).cast(dtype), x ** L((s % 5))]
    plan, got, want = both(build, *outs)  # one kernel, 22 outputs
    assert len(plan.runs) == 1
    for g, w in zip(got, want):
        bit_equal(g, w)


CODES = ["float32", "float64", "int32", "uint32", "bool", "bfloat16",
         "int64", "uint64", "float16"]


@pytest.mark.parametrize("src", ["float32", "float64", "int32", "uint32",
                                 "int64", "uint64", "bool"])
def test_casts_are_bit_equal(build, src):
    vals = [0.0, -0.0, 1.5, -1.5, 2.5, -2.7, 3e9, -3e9, 1e20, -1e20,
            2.0 ** 31, 2.0 ** 32, 2.0 ** 63, 2.0 ** 64, 65504.0, 70000.0,
            1e-40, np.nan, np.inf, -np.inf, 0.1, 123456.789]
    if src in ("float32", "float64"):
        a = np.array(vals, src)
    elif src == "bool":
        a = np.array([True, False] * 11)
    else:
        info = np.iinfo(src)
        a = np.array([0, 1, info.max, info.min, 12345, 2 ** 24 + 1,
                      info.max // 3, 255] * 3, src)[:22]
    x = L(a)
    _, got, want = both(build, *[x.cast(dst) for dst in CODES])
    for g, w in zip(got, want):
        bit_equal(g, w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_programs_round_every_op(build, dtype):
    rng = np.random.default_rng(5)
    a = L(rng.uniform(-3, 3, 97).astype(np.float32)).cast(dtype)
    b = L(rng.uniform(0.5, 3, 97).astype(np.float32)).cast(dtype)
    outs = [a + b, a * b - a, a / b, P.fmadd(a, b, a), P.sqrt(b),
            P.rsqrt(b), P.minimum(a, b), a % b, P.floor(a * 3.0),
            P.select(a > b, a, b), (a * b).cast("float32"),
            a.cast("float64") * 1.1, (a * 300.0).cast("int32"),
            a.bitcast("bfloat16" if dtype == "float16" else "float16")]
    _, got, want = both(build, *outs)
    for g, w in zip(got, want):
        bit_equal(g, w)
    _, (got,), (want,) = both(build, P.sin(a) * b)
    within_ulp(got.float(), want.float(), ulp=4)


def test_bitcasts_are_bit_equal(build):
    x = L(np.array([1.5, -0.0, np.nan, 3e38], np.float32))
    d = L(np.array([1.5, -0.0, 1e300, -2.0], np.float64))
    _, got, want = both(build, x.bitcast("int32"), x.bitcast("uint32"),
                        x.bitcast("int32").bitcast("float32"),
                        d.bitcast("int64"), d.bitcast("uint64") >> 52)
    for g, w in zip(got, want):
        bit_equal(g, w)


# -- memory ops, prints, runs ------------------------------------------------


def test_gather_scatter_reverse_iota(build):
    src = L(np.arange(10, dtype=np.float32) * 1.5)
    for idx in (np.array([3, 0, 9, -4, 12, 5], np.int32),
                np.array([3, 0, 2 ** 32 - 1, 5], np.uint32),
                np.array([3, -1, 2 ** 40, 5], np.int64)):
        _, (got,), (want,) = both(build, src.gather(L(idx)) * 2.0)
        bit_equal(got, want)
    _, (got,), (want,) = both(build, (src * 2.0).reverse() + src)
    bit_equal(got, want)
    it = P.LazyArray.arange(10, "float32", device="cpu")
    _, (got,), (want,) = both(build, it * src + P.LazyArray.arange(
        10, "uint32", device="cpu").cast("float32"))
    bit_equal(got, want)
    # scatter (unique indices) and scatter_add (duplicates; exact sums)
    t = L(np.zeros(12, np.float32))
    t.scatter(L(np.array([1, 5, -1, 20], np.int32)), src.gather(
        L(np.array([2, 3, 4, 5], np.int32))))
    _, (got,), (want,) = both(build, t)
    bit_equal(got, want)
    P.reset()
    t = L(np.zeros(12, np.int64))
    t.scatter_add(L(np.array([1, 1, -2, 40, 3, 3, 3], np.int32)),
                  L(np.arange(7, dtype=np.int64)) * 3)
    _, (got,), (want,) = both(build, t)
    bit_equal(got, want)


def test_a_histogram_is_one_kernel(build):
    rng = np.random.default_rng(11)
    v = L(rng.normal(32, 12, 5000).astype(np.float32))
    h = P.LazyArray.zeros(64, "int32", device="cpu")
    h.scatter_add(v.cast("int32"), 1)
    plan, (got,), (want,) = both(build, h)
    assert len(plan.runs) == 1 and len(plan.steps) == 1
    bit_equal(got, want)
    iv = np.trunc(v.numpy()).astype(np.int64)
    iv = np.where(iv < 0, iv + 64, iv)  # a negative index counts from the end
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(iv[(iv >= 0) & (iv < 64)], minlength=64))


def test_reductions_run_between_kernels(build):
    x = L(np.arange(1, 65, dtype=np.float32))
    plan, (got,), (want,) = both(build, x / x.hsum() + x.psum() * 0.5)
    assert len(plan.runs) == 1 and len(plan.steps) == 3
    bit_equal(got, want)
    P.reset()
    x = L(np.arange(1, 65, dtype=np.float32))
    y = x * 3.0
    plan, (got,), (want,) = both(build, y / y.hmax())
    assert [type(s).__name__ for s in plan.steps] == ["Run", "int", "Run"]
    bit_equal(got, want)
    P.reset()
    x = L(np.arange(20, dtype=np.float32))
    packed, count = (x * 2.0).compress(x > 6.0)
    plan, (g1, g2), (w1, w2) = both(build, packed + 1.0, count)
    bit_equal(g1, w1)
    bit_equal(g2, w2)


def test_a_gather_of_a_value_its_run_computes_ends_the_run(build):
    x = L(np.arange(16, dtype=np.float32))
    y = x * 2.0
    plan, (got,), (want,) = both(build, y.gather(L(np.array(
        [15, 0, 3], np.int32))) + 1.0)
    assert len(plan.runs) == 2
    bit_equal(got, want)


@pytest.mark.parametrize("max_ops", [1, 5, 16])
def test_max_fused_ops_caps_a_run(build, max_ops):
    x = L(np.linspace(0.5, 1.5, 33).astype(np.float32))
    y = x
    for i in range(40):
        y = P.sqrt(y * y + (1.0 + 1e-3 * (i % 7)))
    plan, (got,), (want,) = both(build, y, max_ops=max_ops)
    assert all(len(r.members) <= max_ops for r in plan.runs)
    assert len(plan.runs) >= 120 // max_ops  # 3 lane ops an iteration
    bit_equal(got, want)
    whole, (g2,), _ = both(build, y)
    assert len(whole.runs) == 1
    bit_equal(g2, got)


def test_prints_match_the_plain_version(build, capfd):
    x = L(np.arange(5, dtype=np.float32))
    y = P.printf("x={} y={}", x, x * 2.0) + 1.0
    _, (got,), (want,) = both(build, y)
    bit_equal(got, want)
    out = capfd.readouterr().out.splitlines()
    assert out == ["x=[0. 1. 2. 3. 4.] y=[0. 2. 4. 6. 8.]"] * 2


def test_source_and_hash_are_stable(build):
    def prog(c):
        x = L(np.arange(32, dtype=np.float32))
        return P.tanh(x * c + 1.0) - x
    a = schedule([prog(2.0)])
    b = schedule([prog(2.0)])
    c = schedule([prog(3.5)])  # another literal: the same kernel
    assert a[0].text == b[0].text == c[0].text and a[1] == b[1] == c[1]
    P.reset()
    x = L(np.arange(32, dtype=np.float32))
    d = schedule([P.tanh(x * 2.0) + x])
    assert d[0].text != a[0].text and d[1] != a[1]
    # a changed literal changes the result, not the kernel
    got = []
    for sched in (a, c):
        plan, _, _, _, leaves, bits, codes, _ = sched
        got.append(plan.run(leaves, torch.from_numpy(bits.view(np.int64)),
                            bits, codes, CPU, build=build)[0])
    assert not torch.equal(got[0], got[1])


def test_the_kernel_text_has_one_kernel_per_run():
    x = L(np.arange(16, dtype=np.float32))
    y = (x * 2.0).reverse()
    plan = schedule([y + x.hsum()])[0]
    assert plan.text.count("TK_KERNEL(") == len(plan.runs) == 2
    assert plan.text.count("TK_LAUNCH(") == 2
    assert "tk::lit<float>(L," in plan.text


# -- the tape's adjoint and tangent programs ---------------------------------


def _on_the_kernels(monkeypatch, build):
    monkeypatch.setattr(P, "_KERNEL_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(codegen, "_nvcc_build", build)


def _derivatives(prog, leaves):
    """(the gradients of backward(hsum(prog)), the tangent of prog from
    the first leaf) through the current route."""
    P.reset()
    xs = [P.requires_grad(L(a)) for a in leaves]
    P.backward(prog(*xs).hsum())
    grads = [P.gradient(x).torch() for x in xs]
    P.reset()
    xs = [P.requires_grad(L(a)) for a in leaves]
    _, t = P.forward_from(xs[0], prog(*xs))
    return grads + [t]


def _both_routes(monkeypatch, build, prog, leaves):
    """The derivatives through the plain interpreter and through the
    host build's kernels, and the kernels' launches."""
    want = _derivatives(prog, leaves)
    _build.LAUNCHES.clear()
    with monkeypatch.context() as m:
        _on_the_kernels(m, build)
        got = _derivatives(prog, leaves)
    launches = dict(_build.LAUNCHES)
    return got, want, launches


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_adjoint_and_tangent_programs_are_bit_equal(monkeypatch, build,
                                                    seed, dtype):
    rng = np.random.default_rng(90 + seed)
    n = int(rng.integers(16, 120))
    leaves = [rng.uniform(-3, 3, n).astype(dtype) for _ in range(3)]
    recipe = [(int(rng.integers(len(IEEE))), rng.integers(0, 99, 3))
              for _ in range(int(rng.integers(8, 25)))]

    def prog(*xs):
        pool = list(xs)
        for k, picks in recipe:
            ar, f = IEEE[k]
            pool.append(f(*[pool[int(p) % len(pool)] for p in picks[:ar]]))
        return pool[-1] + xs[0] * 0.5  # the tangent reaches the result

    got, want, launches = _both_routes(monkeypatch, build, prog, leaves)
    for g, w in zip(got, want):
        bit_equal(g, w)
    assert launches.get("trace_vjp", 0) >= 1
    assert launches.get("trace_jvp", 0) >= 1


@pytest.mark.parametrize("name", ["sin", "cos", "tanh", "exp", "lgamma",
                                  "erf", "asinh", "cbrt", "log2", "atan2",
                                  "pow"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transcendental_derivatives_within_an_ulp(monkeypatch, build, name,
                                                  dtype):
    x = np.linspace(0.2, 2.5, 67).astype(dtype)
    y = np.linspace(-1.0, 1.0, 67).astype(dtype)
    f = getattr(P, name)
    prog = (lambda a, b: f(a, b)) if name in ("atan2", "pow") \
        else (lambda a, b: f(a) * b)
    got, want, _ = _both_routes(monkeypatch, build, prog, [x, y])
    for g, w in zip(got, want):
        if dtype == np.float32:
            within_ulp(g, w, 1)
            continue
        # float64: the host's libm and PyTorch's differ by an ulp (as in
        # test_transcendentals_within_an_ulp), which a rule such as tanh's
        # (1 - tanh x) turns into an ulp of 1: 2 ulp of each value, or 4
        # of the largest
        scale = 4 * np.finfo(np.float64).eps * float(w.abs().max())
        off = (g - w).abs() > scale
        within_ulp(g[off], w[off], 2)


def test_memory_and_reduction_adjoints(monkeypatch, build):
    rng = np.random.default_rng(5)
    src = rng.uniform(-2, 2, 40).astype(np.float32)
    idx = rng.integers(-45, 45, 64).astype(np.int32)

    def prog(a):
        g = a.gather(L(idx)) * 2.0
        t = a * 1.0
        t.scatter_add(L(idx), g * g)
        u = a * 0.5
        u.scatter(L(np.arange(-5, 5, dtype=np.int32)),
                  L(np.ones(10, np.float32)) * a.hmax())
        packed, _ = (t + u).compress(a > 0.0)
        return packed * a.psum() + (a * 0.25).hprod() + a.reverse()

    got, want, _ = _both_routes(monkeypatch, build, prog, [src])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        # sums of several terms: 2^-22 of the terms' magnitudes
        tol = 2 ** -22 * (w.abs().sum() + g.abs().sum())
        assert float((g - w).abs().max()) <= float(tol), (g, w)


def test_digamma_opcode(monkeypatch, build):
    for dtype in (np.float32, np.float64):
        x = np.concatenate([np.linspace(-7.5, 30.0, 301),
                            [0.0, -0.0, 1.0, 10.0, -2.0, 1e-8, 1e20]])
        a = L(x.astype(dtype))
        y = a._unary(P.Op.DIGAMMA)
        _, (got,), (want,) = both(build, y)
        bit_equal(got, want)
        ref = torch.digamma(torch.from_numpy(x)).to(got.dtype)
        bit_equal(want, ref)
