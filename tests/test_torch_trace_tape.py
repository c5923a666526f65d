"""The port's AD tape over the lazy trace (enoki_tpu_torch.trace.tape)
against the reference's (enoki_tpu.trace) on the CPU.

* Twins of the 18 tape tests of tests/test_trace.py: each program runs
  through both packages on the same numpy inputs, and the port is held to
  the reference's result and to the expected values, under the reference
  test's own tolerance.
* A sweep of the derivative table: every float opcode in float32 and
  float64 (the reference under jax.enable_x64), and the IEEE subset in
  float16 / bfloat16, each on a domain of its own: ``backward`` of
  ``hsum(op(...))`` against the reference tape's gradient, and
  ``forward_from`` against its tangent. Gates: IEEE ops 1 ulp of the
  dtype (the rules are JAX's, operation for operation; XLA may keep an
  intermediate in a wider register); transcendental ones rtol 1e-5 in
  float32 (the transcendental chain's) and 1e-12 in float64, with an atol
  of that times the largest gradient where the derivative crosses zero;
  16-bit ones 1 ulp of their dtype beyond the float32 gate.
* Ties of MIN / MAX / HMIN / HMAX, zeros of HPROD, dropped and wrapped
  scatter indices, ``compress`` and ``psum``.

On the CPU the port's derivative programs run through the plain
interpreter; tests/test_torch_trace_codegen.py holds the kernels emitted
for them (a host build) to it, and the card runs them as fused kernels
(tests/test_torch_cuda.py, chip_smoke.py phase 29).
"""

import hashlib
import subprocess

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu_torch import _build
from enoki_tpu_torch.config import config as PCFG
from enoki_tpu_torch.trace import codegen


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def both(prog):
    """``prog(tr, L)`` through the reference (J) and the port (P); ``L``
    makes a LazyArray from numpy. Returns [reference's, port's]."""
    out = []
    for tr in (J, P):
        def L(a, tr=tr):
            if tr is P:
                return P.LazyArray(np.asarray(a), device="cpu")
            return J.LazyArray(np.asarray(a))
        out.append(prog(tr, L))
    return out


def close(ref, port, want=None, **tol):
    """The port against the reference's result (and both against
    ``want``) under one tolerance (assert_allclose's, as the reference
    test uses it)."""
    ref, port = np.asarray(ref, np.float64), np.asarray(port, np.float64)
    np.testing.assert_allclose(port, ref, **tol)
    if want is not None:
        np.testing.assert_allclose(ref, want, **tol)
        np.testing.assert_allclose(port, want, **tol)


# -- the 18 tape tests of tests/test_trace.py ---------------------------------


def test_backward_simple():
    def prog(tr, L):
        x = L(np.array([1.0, 2.0, 3.0], np.float32))
        tr.requires_grad(x)
        val = tr.backward((x * x).hsum())
        assert float(np.asarray(val)[0]) == 14.0
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    close(ref, port, [2., 4., 6.])


def test_backward_transcendental_chain():
    def prog(tr, L):
        x = L(np.linspace(0.1, 1.0, 8).astype(np.float32))
        tr.requires_grad(x)
        tr.backward((tr.sin(x) * tr.exp(x)).hsum())
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    xs = np.linspace(0.1, 1.0, 8)
    close(ref, port, np.cos(xs) * np.exp(xs) + np.sin(xs) * np.exp(xs),
          rtol=1e-5)


def test_backward_two_params_and_accumulation():
    def prog(tr, L):
        a = tr.requires_grad(L(np.array([2.0], np.float32)))
        b = tr.requires_grad(L(np.array([3.0], np.float32)))
        tr.backward((a * b).hsum())
        got = [tr.gradient(a).numpy(), tr.gradient(b).numpy()]
        tr.backward((a * b).hsum())  # a second pass accumulates
        got.append(tr.gradient(a).numpy())
        tr.clear_gradients()
        got.append(tr.gradient(a).numpy())
        return got
    ref, port = both(prog)
    for r, p, w in zip(ref, port, [[3.0], [2.0], [6.0], [0.0]]):
        close(r, p, w)


def test_backward_gather_adjoint():
    def prog(tr, L):
        src = tr.requires_grad(L(np.array([1., 2., 3., 4.], np.float32)))
        idx = L(np.array([1, 1, 3], np.int32))
        tr.backward(src.gather(idx).hsum())
        return tr.gradient(src).numpy()
    ref, port = both(prog)
    close(ref, port, [0., 2., 0., 1.])


def test_backward_cache_hit_on_second_step():
    def prog(tr, L):
        def step(data):
            x = tr.requires_grad(L(data))
            tr.backward((tr.tanh(x) * 2.0).hsum())
            return tr.gradient(x).numpy()
        g1 = step(np.array([0.5, -0.5], np.float32))
        h0, m0 = tr.cache_stats()
        g2 = step(np.array([1.5, -1.5], np.float32))
        h1, m1 = tr.cache_stats()
        # step 2 reuses both programs: the forward and its adjoint
        assert m1 == m0 and h1 == h0 + 2
        return g1, g2
    ref, port = both(prog)
    for r, p, xs in zip(ref, port, ([0.5, -0.5], [1.5, -1.5])):
        close(r, p, 2 / np.cosh(xs) ** 2, rtol=1e-5)


def test_backward_after_eval_works():
    def prog(tr, L):
        x = tr.requires_grad(L(np.array([1.0, 2.0], np.float32)))
        loss = (x * x).hsum()
        loss.eval()
        np.testing.assert_allclose(loss.numpy(), [5.0])
        tr.backward(loss)
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    close(ref, port, [2.0, 4.0])


def test_gradient_of_intermediate():
    def prog(tr, L):
        x = tr.requires_grad(L(np.array([2.0, 3.0], np.float32)))
        y = x * x
        tr.backward((y * 5.0).hsum())
        return tr.gradient(y).numpy(), tr.gradient(x).numpy()
    ref, port = both(prog)
    close(ref[0], port[0], [5.0, 5.0])
    close(ref[1], port[1], [20.0, 30.0])


def test_backward_scatter_add_adjoint():
    def prog(tr, L):
        x = tr.requires_grad(L(np.array([1.0, 2.0, 3.0], np.float32)))
        tgt = L(np.zeros(4, np.float32))
        tgt.scatter_add(L(np.array([0, 2, 2], np.int32)), x * 2.0)
        w = L(np.array([1.0, 10.0, 100.0, 1000.0], np.float32))
        tr.backward((tgt * w).hsum())
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    close(ref, port, [2.0, 200.0, 200.0])


def test_backward_scatter_overwrite_combine():
    def prog(tr, L):
        base = tr.requires_grad(L(np.array([1., 2., 3., 4.], np.float32)))
        v = tr.requires_grad(L(np.array([5.0], np.float32)))
        tgt = base * 1.0
        tgt.scatter(L(np.array([1], np.int32)), v)
        tr.backward((tgt * tgt).hsum())
        return tr.gradient(v).numpy(), tr.gradient(base).numpy()
    ref, port = both(prog)
    close(ref[0], port[0], [10.0])
    close(ref[1], port[1], [2., 0., 6., 8.])


def test_backward_through_psum_and_compress():
    def prog(tr, L):
        x = tr.requires_grad(L(np.array([1.0, 2.0, 3.0], np.float32)))
        tr.backward(x.psum().hsum())
        g1 = tr.gradient(x).numpy()
        tr.clear_gradients()
        y = tr.requires_grad(L(np.array([4.0, 5.0, 6.0], np.float32)))
        packed, _ = (y * 2.0).compress(L(np.array([True, False, True])))
        tr.backward(packed.hsum())
        return g1, tr.gradient(y).numpy()
    ref, port = both(prog)
    close(ref[0], port[0], [3.0, 2.0, 1.0])
    close(ref[1], port[1], [2.0, 0.0, 2.0])


def test_backward_twice_with_free_false():
    def prog(tr, L):
        x = tr.requires_grad(L(np.array([3.0], np.float32)))
        loss = (x * x).hsum()
        tr.backward(loss, free=False)
        tr.backward(loss)
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    close(ref, port, [12.0])


def test_forward_mode():
    def prog(tr, L):
        x = tr.requires_grad(L(np.array([0.5], np.float32)))
        y = tr.sin(x) * 3.0
        val, tang = tr.forward_from(x, y)
        return np.asarray(val), np.asarray(tang), tr.gradient(y).numpy()
    ref, port = both(prog)
    for r, p, w in zip(ref, port, (3 * np.sin(0.5), 3 * np.cos(0.5),
                                   [3 * np.cos(0.5)])):
        close(r, p, w, rtol=1e-6)


def test_backward_select_masked_lanes():
    def prog(tr, L):
        x = tr.requires_grad(L(np.array([2.0, 4.0], np.float32)))
        y = tr.select(x > 3.0, x * x, x * 0.5)
        tr.backward(y.hsum())
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    close(ref, port, [0.5, 8.0])


def test_gradient_off_tape_raises():
    def prog(tr, L):
        x = L(np.array([1.0, 2.0], np.float32))
        loss = (x * x).hsum()
        loss.eval()  # evaluated with no differentiable frontier
        tr.requires_grad(x)  # marked too late
        with pytest.raises(RuntimeError, match="never recorded"):
            tr.gradient(loss)
        return tr.gradient(x).numpy()  # a marked leaf reads zeros
    ref, port = both(prog)
    close(ref, port, [0.0, 0.0])


def test_tape_whos_and_graphviz():
    def prog(tr, L):
        r = tr.requires_grad(
            L(np.array([1.0], np.float32)).label("scene/radius"))
        x = L(np.linspace(0, 1, 8).astype(np.float32)).label("px")
        img = tr.maximum(x * r - 0.5, 0.0).label("image")
        loss = (img * img).hsum()
        loss.eval()
        w = tr.tape_whos()
        assert "scene/radius" in w and "image" in w and "segments: 1" in w
        dot = tr.tape_graphviz()
        assert dot.startswith("digraph tape")
        assert "cluster_scene" in dot and "segment 0" in dot and "px" in dot
        tr.backward(loss)  # frees the tape
        assert "segments: 0" in tr.tape_whos()
        return w, dot, tr.gradient(r).numpy()
    ref, port = both(prog)
    # the same table and graph but for the ids and the hash
    assert len(ref[0].splitlines()) == len(port[0].splitlines())
    assert ref[0].splitlines()[0] == port[0].splitlines()[0]
    assert ref[0].splitlines()[-1] == port[0].splitlines()[-1]
    assert len(ref[1].splitlines()) == len(port[1].splitlines())
    close(ref[2], port[2], rtol=1e-6)


@pytest.fixture
def kernels_on_the_cpu(monkeypatch, tmp_path):
    """CPU schedules through the fused kernels, built by the host's g++
    (csrc/trace_kernel.cuh's host half) in place of nvcc; returns the
    list of the sources built."""
    built = []

    def host_build(text):
        built.append(text)
        stem = hashlib.sha256(text.encode()).hexdigest()[:16]
        src, out = tmp_path / f"{stem}.cpp", tmp_path / f"{stem}.so"
        src.write_text(text)
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-I", str(_build.CSRC_DIR),
                        "-o", str(out), str(src)], check=True,
                       capture_output=True)
        return out

    monkeypatch.setattr(P, "_KERNEL_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(codegen, "_nvcc_build", host_build)
    monkeypatch.setattr(codegen, "_LIBS", {})
    return built


def test_export_cache_covers_segment_vjp(kernels_on_the_cpu, tmp_path,
                                         monkeypatch):
    # the adjoint's kernels go into the disk cache like any schedule's: a
    # "new process" (cleared caches) runs backward from the cached
    # libraries, builds nothing and gives the same gradients
    from enoki_tpu.config import config as JCFG

    def prog(tr, L):
        def step(data):
            x = tr.requires_grad(L(data))
            tr.backward((tr.tanh(x * 2.0) * x).hsum())
            return tr.gradient(x).numpy()
        return step

    export = tmp_path / "export"
    monkeypatch.setattr(PCFG, "trace_export_dir", str(export))
    JCFG.trace_export_dir = str(tmp_path / "jax_export")
    try:
        ref_step, port_step = both(prog)
        data = np.array([0.3, -0.7], np.float32)
        g_ref = ref_step(data)
        g1 = port_step(data)
        names = sorted(p.name for p in export.glob("trace-*.so"))
        assert len(names) == 2 and len(kernels_on_the_cpu) == 2, names
        P.clear_cache()
        codegen._LIBS.clear()  # "a new process": only the disk cache stays
        g2 = port_step(data)
        assert len(kernels_on_the_cpu) == 2  # loaded, not built
        assert sorted(p.name for p in export.glob("trace-*.so")) == names
        np.testing.assert_array_equal(g2, g1)
        close(g_ref, g1, rtol=1e-6)
    finally:
        JCFG.trace_export_dir = ""


def test_printf_multi_operand_and_passthrough_grad(capfd):
    def prog(tr, L):
        x = L(np.asarray([2.0, 3.0], np.float32))
        tr.requires_grad(x, True)
        y = tr.printf("x={} sq={}", x, x * x)
        tr.backward((y * y).hsum())
        out = capfd.readouterr()
        assert "sq=" in out.out + out.err
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    close(ref, port, [4.0, 6.0])


def test_clear_gradients_keeps_scatter_versions():
    def prog(tr, L):
        xs = tr.requires_grad(L(np.ones(4, np.float32)))
        tgt = L(np.zeros(4, np.float32))
        tgt.numpy()
        tgt.scatter_add(L(np.arange(4, dtype=np.int32)), xs * 2.0)
        tr.backward(tgt.hsum())
        g = tr.gradient(xs).numpy()
        tr.clear_gradients()
        # still on the tape: zeros, not the off-tape error
        return g, tr.gradient(tgt).numpy()
    ref, port = both(prog)
    close(ref[0], port[0], [2.0] * 4)
    close(ref[1], port[1], [0.0] * 4)


# -- the derivative table, op by op -------------------------------------------

DT = {"float32": np.float32, "float64": np.float64,
      "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}
RTOL = {"float32": 1e-5, "float64": 1e-12}


def ulp(values, dtype):
    """One unit in the last place of ``dtype`` at each value (float64)."""
    v = np.abs(np.asarray(values, np.float64))
    fi = ml_dtypes.finfo(DT[dtype])
    _, e = np.frexp(np.maximum(v, float(fi.smallest_normal)))
    return np.ldexp(float(fi.eps), e - 1)


def table_gate(ref, port, dtype, ieee):
    """The sweep's gate (module docstring)."""
    r = np.asarray(ref, np.float64)
    p = np.asarray(port, np.float64)
    assert r.shape == p.shape
    if dtype in RTOL:
        tol = ulp(r, dtype) if ieee else RTOL[dtype] * (
            np.abs(r) + np.abs(r[np.isfinite(r)]).max(initial=0.0))
    else:
        assert ieee, "the 16-bit sweep takes the IEEE ops"
        tol = ulp(r, dtype) + ulp(r, "float32")
    ok = (np.abs(p - r) <= tol) | (p == r) | (np.isnan(p) & np.isnan(r))
    assert ok.all(), (dtype, r[~ok], p[~ok])


def draw(rng, dom, n, dtype):
    """Lanes from ``dom``: (lo, hi), or such a range with exact values
    mixed in (a tie, a zero)."""
    lo, hi, *exact = dom
    v = rng.uniform(lo, hi, n)
    if exact:
        v[::4] = exact[0]
    return v.astype(DT[dtype])


# name: (arity, op over a trace module, domains, IEEE-only)
POS, ANY, UNIT = (0.1, 4.0), (-3.0, 3.0), (-0.9, 0.9)
TABLE = {
    "add": (2, lambda t, a, b: a + b, (ANY, ANY), True),
    "sub": (2, lambda t, a, b: a - b, (ANY, ANY), True),
    "mul": (2, lambda t, a, b: a * b, (ANY, ANY), True),
    "div": (2, lambda t, a, b: a / b, (ANY, (0.5, 2.0)), True),
    "neg": (1, lambda t, a: -a, (ANY,), True),
    "abs": (1, lambda t, a: abs(a), ((-3.0, 3.0, 0.0),), True),
    "minimum": (2, lambda t, a, b: t.minimum(a, b),
                ((-1.0, 1.0, 0.5), (-1.0, 1.0, 0.5)), True),
    "maximum": (2, lambda t, a, b: t.maximum(a, b),
                ((-1.0, 1.0, 0.5), (-1.0, 1.0, 0.5)), True),
    "fmadd": (3, lambda t, a, b, c: t.fmadd(a, b, c), (ANY, ANY, ANY), True),
    "sqrt": (1, lambda t, a: t.sqrt(a), (POS,), True),
    "rcp": (1, lambda t, a: t.rcp(a), ((0.5, 3.0),), True),
    "copysign": (2, lambda t, a, b: t.copysign(a, b),
                 ((-3.0, 3.0, 0.0), (-1.0, 1.0, -0.0)), True),
    "floor": (1, lambda t, a: t.floor(a) * a, (ANY,), True),
    "ceil": (1, lambda t, a: t.ceil(a) * a, (ANY,), True),
    "round": (1, lambda t, a: t.round(a) * a, (ANY,), True),
    "trunc": (1, lambda t, a: t.trunc(a) * a, (ANY,), True),
    "sign": (1, lambda t, a: t.sign(a) * a, (ANY,), True),
    "cast": (1, lambda t, a: (a.cast(np.float16) * 1.5).cast(a.dtype),
             (ANY,), True),
    "rsqrt": (1, lambda t, a: t.rsqrt(a), (POS,), False),
    "exp": (1, lambda t, a: t.exp(a), (ANY,), False),
    "exp2": (1, lambda t, a: t.exp2(a), (ANY,), False),
    "log": (1, lambda t, a: t.log(a), (POS,), False),
    "log2": (1, lambda t, a: t.log2(a), (POS,), False),
    "sin": (1, lambda t, a: t.sin(a), (ANY,), False),
    "cos": (1, lambda t, a: t.cos(a), (ANY,), False),
    "tan": (1, lambda t, a: t.tan(a), ((-1.2, 1.2),), False),
    "asin": (1, lambda t, a: t.asin(a), (UNIT,), False),
    "acos": (1, lambda t, a: t.acos(a), (UNIT,), False),
    "atan": (1, lambda t, a: t.atan(a), (ANY,), False),
    "sinh": (1, lambda t, a: t.sinh(a), ((-2.0, 2.0),), False),
    "cosh": (1, lambda t, a: t.cosh(a), ((-2.0, 2.0),), False),
    "tanh": (1, lambda t, a: t.tanh(a), (ANY,), False),
    "erf": (1, lambda t, a: t.erf(a), ((-2.0, 2.0),), False),
    "erfc": (1, lambda t, a: t.erfc(a), ((-2.0, 2.0),), False),
    "cbrt": (1, lambda t, a: t.cbrt(a), ((-8.0, 8.0),), False),
    "log1p": (1, lambda t, a: t.log1p(a), ((-0.5, 3.0),), False),
    "expm1": (1, lambda t, a: t.expm1(a), ((-2.0, 2.0),), False),
    "asinh": (1, lambda t, a: t.asinh(a), (ANY,), False),
    "acosh": (1, lambda t, a: t.acosh(a), ((1.1, 4.0),), False),
    "atanh": (1, lambda t, a: t.atanh(a), (UNIT,), False),
    "lgamma": (1, lambda t, a: t.lgamma(a), ((0.2, 6.0),), False),
    "atan2": (2, lambda t, a, b: t.atan2(a, b), (ANY, ANY), False),
    "pow": (2, lambda t, a, b: t.pow(a, b), ((0.2, 3.0), (-2.0, 2.0)),
            False),
    "mod": (2, lambda t, a, b: a % b, ((-5.0, 5.0), (0.7, 2.0)), False),
    "fmod": (2, lambda t, a, b: t.fmod(a, b), ((-5.0, 5.0), (-2.0, -0.7)),
             False),
}
IEEE16 = [k for k, v in TABLE.items() if v[3]]


def run_table(tr, name, dtype, seed, mode):
    """``mode`` "backward": the gradients of hsum(op(...)) for every
    operand; "forward": the tangent of op(...) from its first operand."""
    arity, fn, doms, _ = TABLE[name]
    rng = np.random.default_rng(seed)
    ins = [draw(rng, d, 16, dtype) for d in doms]
    if tr is P:
        xs = [P.LazyArray(a, device="cpu") for a in ins]
    else:
        xs = [J.LazyArray(a) for a in ins]
    if mode == "backward":
        for x in xs:
            tr.requires_grad(x)
        tr.backward(fn(tr, *xs).hsum())
        return [np.asarray(tr.gradient(x).numpy(), np.float64) for x in xs]
    tr.requires_grad(xs[0])
    _, t = tr.forward_from(xs[0], fn(tr, *xs))
    if isinstance(t, torch.Tensor):
        t = t.float() if t.dtype == torch.bfloat16 else t
    return [np.asarray(t, np.float64)]


def run_both(name, dtype, seed, mode):
    if dtype == "float64":
        with jax.enable_x64():
            ref = run_table(J, name, dtype, seed, mode)
    else:
        ref = run_table(J, name, dtype, seed, mode)
    return ref, run_table(P, name, dtype, seed, mode)


@pytest.mark.parametrize("mode", ["backward", "forward"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(TABLE))
def test_derivative_table(name, dtype, mode):
    ref, port = run_both(name, dtype, 7, mode)
    for r, p in zip(ref, port):
        table_gate(r, p, dtype, TABLE[name][3])


@pytest.mark.parametrize("mode", ["backward", "forward"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("name", IEEE16)
def test_derivative_table_16bit(name, dtype, mode):
    ref, port = run_both(name, dtype, 16, mode)
    for r, p in zip(ref, port):
        table_gate(r, p, dtype, True)


# -- the rules with their own cases: reductions, memory ops, edges -----------

def _f32(a):
    return np.asarray(a, np.float32)


def _prog_hminmax(tr, L):
    # ties: the cotangent shared equally among the tied lanes
    x = tr.requires_grad(L(_f32([1.0, 3.0, -2.0, 3.0, 0.5, 3.0])))
    y = tr.requires_grad(L(_f32([-1.0, 2.0, -1.0, 0.0])))
    tr.backward(x.hmax() * 2.0 + y.hmin() * 3.0)
    return [tr.gradient(x).numpy(), tr.gradient(y).numpy()]


def _prog_hprod(tr, L):
    # no zero, one zero, two zeros: the product of the other lanes
    xs = [tr.requires_grad(L(_f32(v))) for v in (
        [1.5, -2.0, 3.0, 0.5, 1.25], [2.0, 0.0, 3.0, 5.0, -1.0, 7.0, 0.5],
        [0.0, 2.0, 0.0, 3.0], [4.0])]
    loss = xs[0].hprod() + xs[1].hprod() + xs[2].hprod() + xs[3].hprod()
    tr.backward(loss)
    return [tr.gradient(x).numpy() for x in xs]


def _prog_minmax_ties(tr, L):
    a = tr.requires_grad(L(_f32([1.0, 2.0, -0.0, 3.0, np.nan])))
    b = tr.requires_grad(L(_f32([1.0, 1.0, 0.0, 4.0, 1.0])))
    tr.backward((tr.minimum(a, b) * 3.0 + tr.maximum(a, b) * 5.0).hsum())
    return [tr.gradient(a).numpy(), tr.gradient(b).numpy()]


def _prog_scatter_indices(tr, L):
    # negative indices wrap, out-of-range ones drop: their values get 0
    base = tr.requires_grad(L(_f32([1.0, 2.0, 3.0, 4.0, 5.0])))
    v = tr.requires_grad(L(_f32([10.0, 20.0, 30.0, 40.0])))
    w = tr.requires_grad(L(_f32([1.0, 2.0, 3.0, 4.0])))
    idx = L(np.array([-1, 7, 1, -9], np.int32))
    t = base * 1.0
    t.scatter(idx, v)
    u = base * 2.0
    u.scatter_add(idx, w * w)
    weights = L(_f32([1.0, 10.0, 100.0, 1000.0, 10000.0]))
    tr.backward((t * weights + u * u).hsum())
    return [tr.gradient(x).numpy() for x in (base, v, w)]


def _prog_gather_clip(tr, L):
    src = tr.requires_grad(L(_f32([1.0, 2.0, 3.0, 4.0])))
    idx = L(np.array([-3, 0, 9, 2, 2], np.int32))
    tr.backward((src.gather(idx) * L(_f32([1, 2, 3, 4, 5]))).hsum())
    return [tr.gradient(src).numpy()]


def _prog_compress_psum_reverse(tr, L):
    x = tr.requires_grad(L(_f32([1.0, -2.0, 3.0, 4.0, -5.0, 6.0])))
    m = x > 0.0
    packed, _ = x.compress(m)
    w = L(_f32([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]))
    loss = (packed * w).hsum() + (x.psum() * w).hsum() \
        + (x.reverse() * w * w).hsum()
    tr.backward(loss)
    return [tr.gradient(x).numpy()]


def _prog_select_broadcast(tr, L):
    # size-1 operands broadcast: their cotangents are sums
    x = tr.requires_grad(L(_f32(np.linspace(-1.0, 1.0, 12))))
    c = tr.requires_grad(L(_f32([0.75])))
    s = tr.requires_grad(L(_f32([-0.5])))
    y = tr.select(x > c, x * c, s - x) * (x + s)
    tr.backward(y.hsum())
    return [tr.gradient(v).numpy() for v in (x, c, s)]


def _prog_two_segments(tr, L):
    # an output of one eval is a leaf of the next: the tape chains them
    x = tr.requires_grad(L(_f32([0.5, 1.5, 2.5])))
    y = tr.sin(x) * x
    y.eval()
    z = (tr.exp(y * 0.5) + y).hsum()
    tr.backward(z)
    return [tr.gradient(x).numpy(), tr.gradient(y).numpy()]


def _prog_pow_edges(tr, L):
    # jnp.power's partials at x = 0 and y = 0
    x = tr.requires_grad(L(_f32([0.0, 0.0, 2.0, 0.0, 1.5])))
    y = tr.requires_grad(L(_f32([2.0, 0.0, 0.0, 3.5, -1.0])))
    tr.backward(tr.pow(x, y).hsum())
    return [tr.gradient(x).numpy(), tr.gradient(y).numpy()]


def _prog_abs_at_zero(tr, L):
    x = tr.requires_grad(L(_f32([0.0, -0.0, -1.0, 2.0])))
    tr.backward((abs(x) + tr.copysign(x, -1.0)).hsum())
    return [tr.gradient(x).numpy()]


PROGRAMS = {"hmin_hmax_ties": _prog_hminmax, "hprod_zeros": _prog_hprod,
            "min_max_ties": _prog_minmax_ties,
            "scatter_wrapped_and_dropped": _prog_scatter_indices,
            "gather_clipped": _prog_gather_clip,
            "compress_psum_reverse": _prog_compress_psum_reverse,
            "select_broadcast": _prog_select_broadcast,
            "two_segments": _prog_two_segments,
            "pow_at_zero": _prog_pow_edges, "abs_at_zero": _prog_abs_at_zero}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_rule_cases_match_the_reference(name):
    # exact but for the sums (2^-22 of the sum of the terms' magnitudes;
    # the terms of a size-1 operand's sum are its lanes' products) and
    # the transcendentals (rtol 1e-5)
    ref, port = both(PROGRAMS[name])
    for r, p in zip(ref, port):
        r, p = np.asarray(r, np.float64), np.asarray(p, np.float64)
        if name in ("select_broadcast", "two_segments"):
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(p, r)


def test_forward_from_raises_where_x_is_not_a_leaf():
    def prog(tr, L):
        x = L(_f32([1.0, 2.0]))
        y = (x * x).eval()  # evaluated before x was marked
        with pytest.raises(ValueError, match="does not appear"):
            tr.forward_from(x, y * 2.0)
        return True
    assert both(prog) == [True, True]


def test_forward_from_matches_the_gradients_dot_product():
    # d loss(x + e t) / de = <gradient, t>: forward and reverse agree
    rng = np.random.default_rng(3)
    xs = rng.uniform(0.2, 2.0, 32).astype(np.float32)
    ts = rng.uniform(-1.0, 1.0, 32).astype(np.float32)

    def loss(x):
        return (P.tanh(x * x) * P.log(x + 1.0) + P.sqrt(x)).hsum()

    x = P.requires_grad(P.LazyArray(xs, device="cpu"))
    P.backward(loss(x))
    g = P.gradient(x).numpy().astype(np.float64)
    P.reset()
    x = P.requires_grad(P.LazyArray(xs, device="cpu"))
    _, t = P.forward_from(x, loss(x), tangent=torch.from_numpy(ts))
    terms = g * ts
    assert abs(float(t[0]) - terms.sum()) <= 2 ** -20 * np.abs(terms).sum()


def test_the_tape_records_only_the_frontier_and_not_its_own_evals():
    x = P.LazyArray(_f32([1.0, 2.0]), device="cpu")
    (x * 3.0).eval()
    assert not P._TAPE  # nothing marked: nothing recorded
    P.requires_grad(x)
    loss = (x * x).hsum()
    loss.eval()
    assert len(P._TAPE) == 1
    P.backward(loss, free=False)
    assert len(P._TAPE) == 1  # the adjoint's eval is not on the tape
    P.backward(loss)
    assert not P._TAPE
    np.testing.assert_array_equal(P.gradient(x).numpy(), [4.0, 8.0])


def test_gradients_stay_on_the_segments_device():
    x = P.requires_grad(P.LazyArray(_f32([1.0, 2.0]), device="cpu"))
    P.backward((x * x).hsum())
    g = P.gradient(x)
    assert g.device == torch.device("cpu") and g.materialized
    assert P._GRADS[x.index].device == torch.device("cpu")
