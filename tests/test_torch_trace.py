"""The port's lazy trace (enoki_tpu_torch.trace) against the reference's
(enoki_tpu.trace) on the CPU: the counterparts of the tests of
tests/test_trace.py that use no tape (the tape's are
tests/test_torch_trace_tape.py), each program run through both packages
on the same numpy inputs.

On the CPU the port evaluates through its plain interpreter (trace/plain.py);
the fused kernels are held to it by tests/test_torch_trace_codegen.py (a
host build of the emitted code) and on the card. Gates: exact, dtype
included, for integer, bit, compare, select, cast, gather / scatter and
literal results; float results within 1 ulp of the reference's, or the
reference test's own rtol / atol against numpy; results below the
smallest normal compare as zeros (XLA's CPU backend flushes them).
Deliberate differences (docs/port.md, the lazy trace): the port keeps
float64 and int64 input 64-bit, its bfloat16 `.numpy()` is float32, and
the export cache's artifact is the built kernel library, which only the
card builds (here a host build stands in for nvcc).
"""

import ctypes
import gc
import hashlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu_torch import _build
from enoki_tpu_torch.config import config as PCFG
from enoki_tpu_torch.trace import codegen

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def both(prog):
    """``prog(tr, L, kw)`` run through the reference (J) and the port (P):
    ``L`` makes a LazyArray from numpy, ``kw`` is the constructors'
    device. Returns [reference's, port's]."""
    out = []
    for tr in (J, P):
        kw = {} if tr is J else {"device": "cpu"}

        def L(a, tr=tr, kw=kw):
            return tr.LazyArray(np.asarray(a), **kw)

        out.append(prog(tr, L, kw))
    return out


def flushed(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = np.where(np.abs(a) < np.finfo(a.dtype).tiny, 0, a).astype(a.dtype)
    return a


def same(ref, port, ulp=0):
    """The port's numpy result against the reference's: the same dtype
    and, for ulp=0, the same values (NaN as NaN, subnormals as zeros);
    else within ``ulp`` units of the reference's dtype."""
    ref, port = np.asarray(ref), np.asarray(port)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    assert port.shape == ref.shape
    if ulp == 0 or ref.dtype.kind != "f":
        np.testing.assert_array_equal(flushed(port), flushed(ref))
        return
    r = flushed(ref).astype(np.float64)
    p = flushed(port).astype(np.float64)
    tol = ulp * np.spacing(np.abs(r).astype(ref.dtype)).astype(np.float64)
    ok = (np.abs(p - r) <= tol) | (np.isnan(p) & np.isnan(r)) | (p == r)
    assert ok.all(), (p[~ok], r[~ok])


def test_lazy_until_eval():
    def prog(tr, L, kw):
        x = L(np.arange(8, dtype=np.float32))
        y = x * 2.0 + 1.0
        assert not y.materialized
        got = y.numpy()
        assert y.materialized
        return got
    ref, port = both(prog)
    same(ref, port)
    np.testing.assert_allclose(port, np.arange(8) * 2.0 + 1.0)


def test_fusion_single_eval():
    def prog(tr, L, kw):
        x = L(np.linspace(0.1, 1.0, 64).astype(np.float32))
        y = x
        for _ in range(50):
            y = tr.sqrt(y * y + 0.01)
        before = tr.stats()["n_evals"]
        y.eval()
        assert tr.stats()["n_evals"] == before + 1
        return y.numpy()
    ref, port = both(prog)
    # XLA contracts y*y + 0.01 into an FMA; the port rounds each op
    np.testing.assert_allclose(port, ref, rtol=1e-5)
    want = np.linspace(0.1, 1.0, 64).astype(np.float32)
    for _ in range(50):
        want = np.sqrt(want * want + 0.01)
    np.testing.assert_allclose(port, want, rtol=1e-5)


def test_cache_hit_on_retrace():
    def prog(tr, L, kw):
        def run(data):
            x = L(data)
            return (tr.sin(x) * 2.0 + tr.cos(x)).numpy()
        run(np.arange(16, dtype=np.float32))
        h0, m0 = tr.cache_stats()
        b = run(np.arange(16, dtype=np.float32) + 3)
        h1, m1 = tr.cache_stats()
        assert m1 == m0 and h1 == h0 + 1
        return b
    ref, port = both(prog)
    same(ref, port, ulp=2)


def test_cache_miss_on_different_structure():
    def prog(tr, L, kw):
        x = L(np.arange(4, dtype=np.float32))
        (x + 1.0).eval()
        _, m0 = tr.cache_stats()
        (x * 3.0).eval()
        _, m1 = tr.cache_stats()
        return m1 - m0
    assert both(prog) == [1, 1]


def test_broadcast_validation():
    for tr, kw in ((J, {}), (P, {"device": "cpu"})):
        x = tr.LazyArray(np.zeros(8, np.float32), **kw)
        s = tr.LazyArray.literal(2.0, **kw)
        (x * s).eval()
        y = tr.LazyArray(np.zeros(7, np.float32), **kw)
        with pytest.raises(ValueError):
            _ = x + y


def test_refcount_collection():
    def prog(tr, L, kw):
        x = L(np.zeros(4, np.float32))
        n0 = tr.stats()["n_vars"]
        y = x + 1.0
        z = y * 2.0
        counts = [tr.stats()["n_vars"] - n0]
        del y, z
        counts.append(tr.stats()["n_vars"] - n0)
        y2 = x + 1.0  # noqa: F841  (the same constant: no new literal)
        counts.append(tr.stats()["n_vars"] - n0)
        return counts
    ref, port = both(prog)
    assert ref == port == [4, 2, 3]


def test_horizontal_fused():
    def prog(tr, L, kw):
        x = L(np.arange(32, dtype=np.float32))
        return [x.hsum().numpy(), x.hmax().numpy(),
                (x * 0 + 2).hprod().numpy(), (x > 15.0).count().numpy(),
                (x >= 0.0).all().numpy(), (x > 100.0).any().numpy(),
                x.psum().numpy(), x.reverse().numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)
    assert float(port[2][0]) == 2.0 ** 32 and int(port[3][0]) == 16


def test_select_and_compare():
    def prog(tr, L, kw):
        x = L(np.arange(10, dtype=np.float32))
        return tr.select(x > 4.0, x, -x).numpy()
    ref, port = both(prog)
    same(ref, port)


def test_gather():
    def prog(tr, L, kw):
        src = L(np.array([10., 20., 30., 40.], np.float32))
        idx = L(np.array([3, 0, 2, -1, 7], np.int32))  # clamped
        return src.gather(idx).numpy()
    ref, port = both(prog)
    same(ref, port)
    np.testing.assert_array_equal(port, [40., 10., 30., 10., 40.])


def test_scatter_dirty_forces_eval():
    def prog(tr, L, kw):
        tgt = L(np.zeros(5, np.float32))
        tgt.scatter(L(np.array([1, 3], np.int32)),
                    L(np.array([7.0, 9.0], np.float32)))
        return (tgt + 1.0).numpy()
    ref, port = both(prog)
    same(ref, port)


def test_scatter_add_conflicts():
    def prog(tr, L, kw):
        tgt = L(np.zeros(4, np.float32))
        idx = L(np.array([0, 1, 1, 1, 3, -1, 9], np.int32))
        tgt.scatter_add(idx, L(np.ones(7, np.float32)))
        return tgt.numpy()
    ref, port = both(prog)
    same(ref, port)
    np.testing.assert_array_equal(port, [1., 3., 0., 2.])


def test_arange_linspace_literal():
    def prog(tr, L, kw):
        return [tr.LazyArray.arange(6, **kw).numpy(),
                tr.LazyArray.linspace(-1.0, 1.0, 5, **kw).numpy(),
                tr.LazyArray.full(2.5, 3, **kw).numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)


def test_cast_and_int_ops():
    def prog(tr, L, kw):
        x = L(np.array([1, 2, 3], np.int32))
        f = x.cast(np.float32)
        u = L(np.array([7, 0xFFFFFFFF, 0x80000000], np.uint32))
        return [(f / 2.0).numpy(), (x << 2).numpy(), tr.popcnt(u).numpy(),
                (u >> 31).numpy(), (u > 5).numpy(), tr.clz(u).numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)


def test_whos_and_labels():
    x = P.LazyArray(np.zeros(16, np.float32), device="cpu").label("weights")
    report = P.whos()
    assert "weights" in report and "live variables" in report
    assert "weights" not in J.whos()
    del x


def test_single_element_fetch_forces_eval():
    def prog(tr, L, kw):
        y = L(np.arange(4, dtype=np.float32)) * 10.0
        assert not y.materialized
        v = y[2]
        assert y.materialized
        return v
    assert both(prog) == [20.0, 20.0]


def test_log_level_roundtrip():
    P.set_log_level(3)
    assert P.stats() is not None
    P.set_log_level(0)


def test_scalar_size1_output():
    def prog(tr, L, kw):
        x = L(np.arange(8, dtype=np.float32))
        return (x / x.hsum()).numpy()
    ref, port = both(prog)
    same(ref, port)


def test_literal_change_hits_cache():
    def prog(tr, L, kw):
        x = L(np.arange(8, dtype=np.float32))
        (x * 2.0 + 1.0).eval()
        h0, m0 = tr.cache_stats()
        y = x * 3.5 + 7.25
        y.eval()
        h1, m1 = tr.cache_stats()
        assert m1 == m0 and h1 == h0 + 1
        return y.numpy()
    ref, port = both(prog)
    same(ref, port)


def test_integer_literals_bit_exact():
    def prog(tr, L, kw):
        x = L(np.array([0x9E3779B9, 1, 0xFFFFFFFF], np.uint32))
        return [(x ^ 0x9E3779B9).numpy(), (x * 0x9E3779B9).numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)


def test_constant_only_program():
    def prog(tr, L, kw):
        i = tr.LazyArray.arange(64, **kw).cast(np.float32)
        return (tr.sin(i * 0.1) + 2.0).numpy()
    ref, port = both(prog)
    same(ref, port, ulp=2)


def test_extended_math_ops():
    xs = np.linspace(0.1, 0.9, 16).astype(np.float32)
    ys = np.linspace(1.5, 3.0, 16).astype(np.float32)

    def prog(tr, L, kw):
        x, y = L(xs), L(ys)
        fs = [tr.cbrt, tr.log1p, tr.expm1, tr.asinh, tr.atanh, tr.sign,
              tr.erfc, tr.lgamma, tr.exp2, tr.log2, tr.tan, tr.asin,
              tr.acos, tr.atan, tr.sinh, tr.cosh, tr.erf, tr.rcp,
              tr.rsqrt, tr.floor, tr.ceil, tr.round, tr.trunc]
        return ([f(x * 4.0).numpy() for f in fs]
                + [tr.acosh(y).numpy(), tr.copysign(x, -y).numpy(),
                   tr.atan2(x, y).numpy(), tr.pow(y, x).numpy()])
    ref, port = both(prog)
    for r, p in zip(ref, port):
        # the port's are the float64 functions rounded once; XLA's float32
        # ones are a few ulp off: the reference test's gate
        assert p.dtype == r.dtype
        np.testing.assert_allclose(p, r, rtol=2e-5, atol=1e-6)


def test_predicates_and_composites():
    def prog(tr, L, kw):
        x = L(np.array([1.0, np.inf, np.nan, -2.0], np.float32))
        z = L(np.array([-1.0, 0.5, 2.0], np.float32))
        a = L(np.zeros(3, np.float32))
        b = L(np.ones(3, np.float32) * 10)
        return [tr.isnan(x).numpy(), tr.isinf(x).numpy(),
                tr.isfinite(x).numpy(), tr.clamp(z, 0.0, 1.0).numpy(),
                tr.lerp(a, b, 0.25).numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)


def test_review_fixes():
    def prog(tr, L, kw):
        a = L(np.array([1e8], np.float32))
        b = L(np.array([1.0], np.float32))
        out = [tr.lerp(a, b, 1.0).numpy(), tr.lerp(a, b, 0.0).numpy()]
        r = tr.lerp(a, np.ones(1, np.float32), 0.5)
        assert isinstance(r, tr.LazyArray) and not r.materialized
        z = L(np.array([-3.0, 0.0, -0.0, 5.0], np.float32))
        out.append(tr.sign(z).numpy())
        y = tr.log1p(L(np.array([0, 3], np.int32)))
        out.append((y + 0.5).numpy())
        return out
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p, ulp=1)
    np.testing.assert_array_equal(port[2], [-1.0, 1.0, -1.0, 1.0])


def test_compress_lazy():
    def prog(tr, L, kw):
        x = L(np.arange(10, dtype=np.float32))
        packed, count = x.compress(x > 6.0)
        assert not packed.materialized
        return [packed.numpy(), count.numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)


def test_select_scalar_operands():
    def prog(tr, L, kw):
        x = L(np.array([10.0, 20.0, 30.0], np.float32))
        m = x > 15.0
        r = tr.select(m, 2.5, 7.0)
        ri = tr.select(m, 1, 0)
        return [tr.select(m, 5.0, x).numpy(), tr.select(m, x, -1.0).numpy(),
                r.numpy(), ri.numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)


def test_fmod_vs_mod_sign_semantics():
    def prog(tr, L, kw):
        a = L(np.array([-5.0, 5.0, -5.0, -6.0, 0.0], np.float32))
        b = L(np.array([3.0, -3.0, -3.0, 3.0, 3.0], np.float32))
        ai = L(np.array([-5, 5, -5, 7], np.int32))
        bi = L(np.array([3, -3, -3, 7], np.int32))
        return [tr.fmod(a, b).numpy(), (a % b).numpy(),
                (ai % bi).numpy(), tr.fmod(ai, bi).numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)


def test_literals_64bit_bit_exact():
    # the port keeps 64-bit dtypes always; the reference under x64
    import jax
    big = 0x0123456789ABCDEF
    with jax.enable_x64():
        ref = both(lambda tr, L, kw: [
            (L(np.array([0, 1], np.uint64)) + big).numpy(),
            (L(np.array([0.0], np.float64)) + (1.0 + 2.0 ** -40)).numpy(),
            (L(np.array([-3, 2 ** 40], np.int64)) * 3).numpy()])
    for r, p in zip(*ref):
        same(r, p)
    np.testing.assert_array_equal(ref[1][0], np.array([big, big + 1],
                                                      np.uint64))


def test_segmented_schedule_matches_fused():
    def build(tr, L, data):
        x = L(data)
        y = x
        for i in range(60):
            y = tr.sqrt(y * y + (1.0 + 1e-3 * (i % 5)))
        idx = L(np.arange(len(data) - 1, -1, -1, dtype=np.int32))
        g = y.gather(idx)
        t = L(np.zeros(len(data), np.float32))
        t.scatter_add(idx, g)
        return (t * y).hsum()

    data = np.linspace(0.5, 1.5, 64).astype(np.float32)
    L = lambda a: P.LazyArray(a, device="cpu")  # noqa: E731
    whole = build(P, L, data).numpy()
    P.reset()
    PCFG.max_fused_ops = 32
    try:
        seg = build(P, L, data).numpy()
    finally:
        PCFG.max_fused_ops = 0
    np.testing.assert_array_equal(seg, whole)
    ref = build(J, J.LazyArray, data).numpy()
    np.testing.assert_allclose(whole, ref, rtol=1e-6)


def test_c_operator_path_no_leaks():
    x = P.LazyArray(np.ones(8, np.float32), device="cpu")
    base = P.stats()["n_vars"]
    z = w = None
    for _ in range(100000):
        z = x * x + 1.0
        w = P.sqrt(z) > 0.5
    del z, w
    gc.collect()
    assert P.stats()["n_vars"] <= base + 4
    z = x * x
    assert sys.getrefcount(z) == 2
    assert isinstance(z.index, int) and isinstance(z._size, int)
    assert z.device == CPU


# -- the disk cache of built kernels (the reference's export cache) ---------


def host_build(out_dir):
    """A stand-in for nvcc: the host's g++ build of the emitted source
    (tests/test_torch_trace_codegen.py holds its values)."""
    calls = []

    def build(text):
        calls.append(text)
        stem = hashlib.sha256(text.encode()).hexdigest()[:16]
        src, out = out_dir / f"{stem}.cpp", out_dir / f"{stem}.so"
        src.write_text(text)
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-I", str(_build.CSRC_DIR), "-o",
                        str(out), str(src)], check=True, capture_output=True)
        return out
    build.calls = calls
    return build


def schedule_plan(*arrays):
    """The port's codegen.Plan of ``arrays``' schedule and its inputs."""
    ids = [a.index for a in arrays]
    n = P._lib.ett_schedule((ctypes.c_uint32 * len(ids))(*ids), len(ids))
    key = P._lib.ett_schedule_hash()
    entries, outs = P._read_schedule(n)
    buf = (ctypes.c_uint32 * max(n, 1))()
    nd = P._lib.ett_schedule_data_ids(buf, n)
    leaves = [P._BUFFERS[buf[i]] for i in range(nd)]
    bits, codes = P._collect_literals(n)
    plan = codegen.Plan(entries, outs, {}, PCFG.max_fused_ops, key)
    return plan, leaves, bits, codes


def chain(n=20):
    x = P.LazyArray(np.linspace(0.5, 1.5, 32).astype(np.float32),
                    device="cpu")
    y = x
    for i in range(n):
        y = P.sqrt(y * y + (1.0 + 0.1 * (i % 3)))
    return y


def run_plan(plan, leaves, bits, codes, build):
    lits = torch.from_numpy(bits.view(np.int64))
    return plan.run(leaves, lits, bits, codes, CPU, build=build)[0]


@pytest.fixture
def export_dir(tmp_path):
    old = PCFG.trace_export_dir
    PCFG.trace_export_dir = str(tmp_path / "export")
    codegen._LIBS.clear()
    yield tmp_path / "export"
    PCFG.trace_export_dir = old
    codegen._LIBS.clear()


def test_trace_export_cache_roundtrip(export_dir, tmp_path):
    build = host_build(tmp_path)
    y = chain()
    plan, *inputs = schedule_plan(y)
    a = run_plan(plan, *inputs, build)
    files = list(export_dir.glob("trace-*.so"))
    assert len(files) == 1 and len(build.calls) == 1
    codegen._LIBS.clear()  # "a new process": the disk cache stays
    plan2, *inputs2 = schedule_plan(chain())
    b = run_plan(plan2, *inputs2, build)
    assert len(build.calls) == 1  # loaded, not built
    assert torch.equal(a, b)
    assert torch.equal(a, P.plain_eval(y)[0])


def test_trace_export_cache_corrupt_artifact_recovers(export_dir, tmp_path):
    build = host_build(tmp_path)
    plan, *inputs = schedule_plan(chain(3))
    want = run_plan(plan, *inputs, build)
    (f,) = export_dir.glob("trace-*.so")
    f.write_bytes(b"garbage")
    codegen._LIBS.clear()
    plan2, *inputs2 = schedule_plan(chain(3))
    assert torch.equal(run_plan(plan2, *inputs2, build), want)
    assert len(build.calls) == 2 and f.read_bytes() != b"garbage"


def test_trace_export_cache_respects_segmentation(export_dir, tmp_path):
    PCFG.max_fused_ops = 8
    try:
        plan, *inputs = schedule_plan(chain())
        run_plan(plan, *inputs, host_build(tmp_path))
        assert len(plan.runs) > 1
        assert not export_dir.exists() or not list(export_dir.iterdir())
    finally:
        PCFG.max_fused_ops = 0


def test_export_cache_write_evicts_stale_files(export_dir, tmp_path):
    # the counterpart of tests/test_cache.py:72-92: a write bounds the
    # directory (config.cache_max_bytes, LRU by mtime)
    import os
    export_dir.mkdir(parents=True)
    stale = export_dir / "trace-00deadbeef.so"
    stale.write_bytes(b"x" * (1 << 20))
    os.utime(stale, (1, 1))
    old = PCFG.cache_max_bytes
    PCFG.cache_max_bytes = 512 << 10
    try:
        plan, *inputs = schedule_plan(chain(2))
        run_plan(plan, *inputs, host_build(tmp_path))
    finally:
        PCFG.cache_max_bytes = old
    names = [p.name for p in export_dir.iterdir()]
    assert stale.name not in names and len(names) == 1, names


# -- printf ------------------------------------------------------------------


def test_printf_fires_inside_fused_program(capfd):
    def prog(tr, L, kw):
        x = L(np.arange(4, dtype=np.float32))
        y = tr.printf("mid={}", x * 2.0) + 1.0
        before = tr.stats()["n_evals"]
        got = y.numpy()
        assert tr.stats()["n_evals"] == before + 1
        return got
    ref, port = both(prog)
    same(ref, port)
    out = capfd.readouterr()
    assert (out.out + out.err).count("mid=[0. 2. 4. 6.]") == 2


def test_printf_unused_is_a_side_effect(capfd):
    x = P.LazyArray(np.ones(3, np.float32), device="cpu")
    P.printf("side effect {}", x)
    (P.LazyArray(np.zeros(3, np.float32), device="cpu") + 1.0).eval()
    assert "side effect [1. 1. 1.]" in capfd.readouterr().out


def test_printf_format_is_part_of_the_cache_key(capfd):
    x = P.LazyArray(np.ones(3, np.float32), device="cpu")
    P.printf("fmt-one {}", x + 1.0).eval()
    y = P.LazyArray(np.ones(3, np.float32), device="cpu")
    P.printf("fmt-two {}", y + 1.0).eval()
    text = capfd.readouterr().out
    assert "fmt-one" in text and "fmt-two" in text


def test_printf_multi_operand(capfd):
    # the print half of the reference's test (its gradient half is A8.3's)
    def prog(tr, L, kw):
        x = L(np.asarray([2.0, 3.0], np.float32))
        y = tr.printf("x={} sq={}", x, x * x)
        return (y * y).numpy()
    ref, port = both(prog)
    same(ref, port)
    assert (capfd.readouterr().out + "").count("x=[2. 3.] sq=[4. 9.]") >= 1


def test_printf_entry_consumed_after_eval(capfd):
    x = P.LazyArray(np.ones(3, np.float32), device="cpu")
    P.printf("once {}", x + 1.0).eval()
    capfd.readouterr()
    assert not P._PRINT_FMT
    z = (P.LazyArray(np.ones(3, np.float32), device="cpu") * 3.0).numpy()
    np.testing.assert_allclose(z, 3.0)
    assert "once" not in capfd.readouterr().out


def test_printf_validation():
    x = P.LazyArray(np.ones(2, np.float32), device="cpu")
    with pytest.raises(ValueError):
        P.printf("no operands")
    with pytest.raises(TypeError):
        P.printf("scalar {}", 3.0)
    with pytest.raises(TypeError):
        P.printf(123, x)


def test_scalar_literal_cache_cap_reclaims_refs():
    x = P.LazyArray(np.ones(8, np.float32), device="cpu")
    base = P.stats()["n_vars"]
    cap = 1 << 14
    for k in range(cap + cap // 2):
        _ = x + float(k + 1)
    assert P.stats()["n_vars"] - base <= cap


def test_scatter_into_lazy_target_survives_unrelated_eval():
    def prog(tr, L, kw):
        x = L(np.ones(4, np.float32))
        y = x * 2.0
        y.scatter(L(np.array([0], np.int32)), L(np.array([99.0], np.float32)))
        (x + 1.0).eval()
        return y.numpy()
    ref, port = both(prog)
    same(ref, port)
    np.testing.assert_array_equal(port, [99.0, 2.0, 2.0, 2.0])


def test_deep_chain_free_is_iterative():
    x = P.LazyArray(np.ones(8, np.float32), device="cpu")
    y = x
    for _ in range(300_000):
        y = y + 1.0
    assert P.stats()["n_vars"] > 300_000
    del y
    assert P.stats()["n_vars"] < 16


def test_printf_in_chunked_program(capfd):
    PCFG.max_fused_ops = 64
    try:
        x = P.LazyArray(np.ones(4, np.float32), device="cpu")
        for _ in range(200):
            x = x + 1.0
        out = P.printf("chunked x0={}", x)
        for _ in range(200):
            out = out * 1.0
        np.testing.assert_allclose(out.numpy(), 201.0)
    finally:
        PCFG.max_fused_ops = 0
    assert "chunked x0=[201. 201. 201. 201.]" in capfd.readouterr().out


def test_printf_flushes_dirty_operand(capfd):
    x = P.LazyArray(np.zeros(3, np.float32), device="cpu")
    x.numpy()
    x.scatter(P.LazyArray(np.array([1], np.int32), device="cpu"),
              P.LazyArray(np.array([7.0], np.float32), device="cpu"))
    P.printf("dirty x={}", x).eval()
    assert "dirty x=[0. 7. 0.]" in capfd.readouterr().out


def test_lazy_fmadd_promotes_mixed_dtypes():
    def prog(tr, L, kw):
        x = L(np.array([1, 2, 3], np.int32))
        y = L(np.array([0.5, 0.5, 0.5], np.float32))
        z = L(np.array([1.0, 1.0, 1.0], np.float32))
        r = tr.fmadd(x, y, z)
        assert str(r.dtype).endswith("float32")
        return r.numpy()
    ref, port = both(prog)
    same(ref, port)


# -- the port's own rules ------------------------------------------------------


def test_two_cores_keep_two_states():
    # both packages' native cores in one process: each counts only its own
    # appends, and a reset of one leaves the other's arrays intact
    jx = J.LazyArray(np.arange(4, dtype=np.float32))
    px = P.LazyArray(np.arange(4, dtype=np.float32), device="cpu")
    j0, p0 = J.stats()["n_appends"], P.stats()["n_appends"]
    jy = jx * 2.0 + 1.0
    assert J.stats()["n_appends"] == j0 + 4
    assert P.stats()["n_appends"] == p0
    py = px * 3.0
    assert P.stats()["n_appends"] == p0 + 2
    assert J.stats()["n_appends"] == j0 + 4
    J.reset()
    np.testing.assert_array_equal(py.numpy(), np.arange(4) * 3.0)
    P.reset()
    jz = J.LazyArray(np.ones(2, np.float32)) + 1.0
    np.testing.assert_array_equal(jz.numpy(), [2.0, 2.0])
    assert P.stats()["n_vars"] == 0
    assert P._lib._name != J._lib._name
    del jy


def test_the_device_rule():
    x = P.LazyArray(np.ones(3, np.float32), device="cpu")
    assert x.device == CPU and (x * 2.0).device == CPU
    assert P.LazyArray(torch.ones(2)).device == CPU
    # 64-bit numpy input stays 64-bit
    assert P.LazyArray(np.arange(3), device="cpu").dtype == torch.int64
    assert P.LazyArray(np.ones(2), device="cpu").dtype == torch.float64


@pytest.mark.parametrize("make", [
    lambda: P.LazyArray(np.ones(2, np.float32)),
    lambda: P.LazyArray.arange(4),
    lambda: P.LazyArray.zeros(4),
    lambda: P.LazyArray.full(1.0, 4),
    lambda: P.LazyArray.literal(1.0),
    lambda: P.LazyArray.linspace(0.0, 1.0, 4)])
def test_constructors_default_to_the_card(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_plain_eval_changes_nothing():
    x = P.LazyArray(np.arange(5, dtype=np.float32), device="cpu")
    y = P.sqrt(x * 2.0 + 1.0)
    (v,) = P.plain_eval(y)
    assert not y.materialized
    assert torch.equal(v, y.torch())
    assert P.prepare(y) is None  # nothing to build on the CPU


def test_uint32_results_leave_as_uint32():
    def prog(tr, L, kw):
        u = L(np.array([1, 0xFFFFFFF0, 0x80000000], np.uint32))
        return [(u + 0x20).numpy(), (u - 2).numpy(), (u * 3).numpy(),
                (-u).numpy(), (~u).numpy(), (u << 1).numpy(),
                tr.minimum(u, 5).numpy(), u.hmax().numpy(),
                u.psum().numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p)
    x = P.LazyArray(np.array([3], np.uint32), device="cpu") + 1
    assert x.torch().dtype == torch.uint32
