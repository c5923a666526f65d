"""SCATTER_ADD's routes in the trace's fused kernels (trace/codegen.py,
csrc/trace_kernel.cuh), checked without a card.

A SCATTER_ADD target takes one of three routes when its source is
written: a private row a thread in shared memory (float32 targets up to
``codegen.ROW_SLOTS`` slots), a copy a block in shared memory (32- and
64-bit int and float targets of at most ``codegen.BLOCK_BYTES``), or a
global atomic a lane, the run's shared memory at most ``codegen.ACC_SMEM``
(chip_smoke.scatter_route states the rule). Each case here asserts the
route the plan gives, and that
the program is one fused run and one launch; then it runs the emitted
source built by the host's g++ (the skeleton's host half, where every
route is the sequential add into the target), the plain interpreter
(trace/plain.py) and the reference (enoki_tpu.trace on the CPU, under x64
for the 64-bit codes) on the same numpy inputs (chip_smoke.scatter_case:
negative and out-of-range indices, slots hit by nothing and by -0.0
alone). Gates:

* integers equal exactly everywhere (sums wrap);
* floats bit-equal between the host build and the plain interpreter,
  which add the same terms in the same order; where two SCATTER_ADDs into
  one target share a run, the host build adds them lane by lane and the
  interpreter one after the other, so there they are held as against the
  reference;
* floats against the reference within 2^-22 (float32; 2^-51 for
  float64: four units of roundoff of the type) of the sum of the
  magnitudes of each slot's terms (its base and the values added there):
  XLA may add them in another order (chip_smoke.scatter_gate);
* a slot that nothing but -0.0 reached keeps its base's bits (a base of
  -0.0 included) in the host build and the plain interpreter.

The card's routes are held bit-equal to the plain interpreter by
tests/test_torch_cuda.py and chip_smoke.py phase 28 (b), on values whose
sums are exact in any order, and phase 28 (b)'s timed random weights to
their float64 sums by chip_smoke.weights_gate, whose room both ways is
checked here.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as C
import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu_torch import _build
from enoki_tpu_torch.trace import plain
from test_torch_trace_codegen import bit_equal, build, schedule  # noqa: F401

CPU = torch.device("cpu")
LANES = 2000


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def x64(dtype):
    return jax.enable_x64() if np.dtype(dtype).itemsize == 8 \
        else contextlib.nullcontext()


def as_numpy(a):
    """A case's array as the reference takes it: scatter_case's bfloat16
    tensors as ml_dtypes' bfloat16 arrays."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(jnp.bfloat16)
    return a


def reference(cases, chained=False):
    """enoki_tpu.trace's results of ``cases`` ((base, idx, val) each)."""
    out = []
    for case in cases:
        base, idx, val = (as_numpy(a) for a in case)
        with x64(base.dtype):
            out.append(C.scatter_program(J, base, idx, val, None,
                                         chained).numpy())
    return out


def refused(case, chained=False):
    """Both packages refuse a SCATTER_ADD into a bool target with a
    TypeError: the reference (JAX's x.at[i].add of a bool array) when it
    evaluates the scatter, the port when it is recorded."""
    with pytest.raises(TypeError, match="bool"):
        C.scatter_program(J, *case, None, chained).numpy()
    J.reset()
    with pytest.raises(TypeError, match="bool"):
        C.scatter_program(P, *case, "cpu", chained)


def port(build, cases, chained=False):
    """(plan, the host build's results, the plain interpreter's, launches
    of the host build) of ``cases`` evaluated in one schedule."""
    ts = [C.scatter_program(P, *c, "cpu", chained) for c in cases]
    plan, _, entries, outs, leaves, bits, codes, fmts = schedule(ts)
    before = _build.LAUNCHES["trace"]
    got = plan.run(leaves, torch.from_numpy(bits.view(np.int64)), bits,
                   codes, CPU, build=build)
    launched = _build.LAUNCHES["trace"] - before
    want = plain.run(entries, outs, leaves, bits, codes, fmts, CPU)
    return plan, got[:len(ts)], want[:len(ts)], launched


def held(case, got, want, ref, exact_plain=True):
    base, idx, val = C.scatter_tensors(torch, case, CPU)
    if exact_plain:
        bit_equal(got, want)
    else:
        ok, err = C.scatter_gate(torch, got, want, base, idx, val)
        assert ok, err
    r = torch.from_numpy(np.array(ref).astype(np.float32)).to(got.dtype) \
        if got.dtype == torch.bfloat16 else torch.from_numpy(np.array(ref))
    if not got.dtype.is_floating_point:
        assert torch.equal(got, r) and torch.equal(want, r)
        return
    # the gate's bit check holds the port's two results to the base
    for a in (got, want):
        ok, err = C.scatter_gate(torch, a, r.to(a.dtype), base, idx, val)
        assert ok, err


def one_run(plan):
    (run,) = plan.runs
    assert plan.steps == [run]
    return run


@pytest.mark.parametrize("size", C.SCATTER_SIZES)
@pytest.mark.parametrize("dtype", C.SCATTER_CODES)
def test_each_route_against_the_plain_interpreter_and_the_reference(
        build, dtype, size):
    case = C.scatter_case(dtype, size, LANES, seed=size * 7 + len(dtype))
    if dtype == "bool":
        return refused(case)
    plan, (got,), (want,), launched = port(build, [case])
    run = one_run(plan)
    assert launched == 1 and len(run.targets) == 1
    assert run.routes[run.targets[0]] == C.scatter_route(dtype, size)
    held(case, got, want, reference([case])[0])


@pytest.mark.parametrize("dtype", C.SCATTER_CODES)
def test_two_scatter_adds_into_one_target_share_its_copy(build, dtype):
    case = C.scatter_case(dtype, 64, LANES, seed=11)
    if dtype == "bool":
        return refused(case, chained=True)
    plan, (got,), (want,), launched = port(build, [case], chained=True)
    run = one_run(plan)
    assert launched == 1 and len(run.targets) == 1
    (second, first), = run.alias.items()
    assert first == run.targets[0] and second > first
    assert run.routes == {first: C.scatter_route(dtype, 64)}
    held(case, got, want, reference([case], chained=True)[0],
         exact_plain=False)


@pytest.mark.parametrize("name", list(C.SCATTER_SEVERAL))
def test_several_targets_budget_shared_memory(build, name):
    # the routes in the order of the targets, the shared memory
    # (codegen.ACC_SMEM) given out over all of them
    targets, routes = C.SCATTER_SEVERAL[name]
    cases = [C.scatter_case(dt, n, LANES, seed=k + 3)
             for k, (dt, n) in enumerate(targets)]
    plan, got, want, launched = port(build, cases)
    run = one_run(plan)
    assert launched == 1
    assert [run.routes[p] for p in run.targets] == routes
    assert sum(run.routes[p] < 3 for p in run.targets) == len(run.smem)
    for case, g, w, r in zip(cases, got, want, reference(cases)):
        held(case, g, w, r)


def test_histogram_program_is_one_launch(build):
    vals = np.random.default_rng(28).normal(32.0, 12.0, 1 << 14).astype(
        np.float32)
    ref = J.LazyArray(np.zeros(C.TRACE_HIST_BINS, np.int32))
    ref.scatter_add(J.LazyArray(vals).cast("int32"), 1)
    h = C.trace_hist(P, P.LazyArray(vals, device="cpu"))
    plan, _, entries, outs, leaves, bits, codes, fmts = schedule([h])
    run = one_run(plan)
    assert list(run.routes.values()) == [2] and run.unroll == 8
    before = _build.LAUNCHES["trace"]
    (got,) = plan.run(leaves, torch.from_numpy(bits.view(np.int64)), bits,
                      codes, CPU, build=build)[:1]
    assert _build.LAUNCHES["trace"] == before + 1
    (want,) = plain.run(entries, outs, leaves, bits, codes, fmts, CPU)[:1]
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), np.asarray(ref.numpy()))


@pytest.mark.parametrize("dtype,size,kind", [
    ("float32", 64, "tk::RowAcc<float, 64>"),
    ("int32", 8, "tk::BlockAcc<int32_t, 8>"),
    ("int32", 64, "tk::BlockAcc<int32_t, 64>"),
    ("float32", 97, "tk::BlockAcc<float, 97>"),
    ("float64", 4096, "tk::BlockAcc<double, 4096>"),
    ("float32", 65536, "tk::atomic_add(static_cast<float *>")])
def test_the_route_is_in_the_source(dtype, size, kind):
    # the route is chosen when the source is written: it is in the text,
    # and so in the library's name in the disk cache
    case = C.scatter_case(dtype, size, 64, seed=1)
    plan = schedule([C.scatter_program(P, *case, "cpu")])[0]
    assert kind in plan.text
    acc = C.scatter_route(dtype, size) < 3
    assert ("TK_ACC_LAUNCH" in plan.text) == acc
    assert ("tk::ldg<" in plan.text) == acc


def test_a_refused_launch_raises(build, monkeypatch):
    # no fallback: a launch that returns an error raises, and nothing
    # runs the plain interpreter in its place
    case = C.scatter_case("float32", 64, 256, seed=2)
    t = C.scatter_program(P, *case, "cpu")
    plan, _, entries, outs, leaves, bits, codes, fmts = schedule([t])
    lib = plan.library(build)
    name = plan.runs[0].name + "_launch"
    monkeypatch.setattr(lib, name, lambda *a: 9)

    def no_plain(*a, **k):
        raise AssertionError("the plain interpreter ran")

    monkeypatch.setattr(plain, "run", no_plain)
    before = _build.LAUNCHES["trace"]
    with pytest.raises(RuntimeError, match="trace launch failed: CUDA "
                                           "error 9"):
        plan.run(leaves, torch.from_numpy(bits.view(np.int64)), bits,
                 codes, CPU, build=build)
    assert _build.LAUNCHES["trace"] == before


@pytest.mark.parametrize("size", C.SCATTER_TIMED)
def test_the_weights_gate_has_room_both_ways(size):
    # phase 28 (b)'s timed weights at 2^20 lanes: one float32 sum in lane
    # order (a random order of each slot's terms, as global atomics add
    # them) stays within half of the gate; the same sum without its last
    # lane, or without one of 1,056 equal shares of the lanes (a block's
    # partial sum on the card's grid), fails it
    base, idx, val = (torch.from_numpy(a)
                      for a in C.scatter_timed_case(size, 1 << 20))
    k, v = C.scatter_kept(torch, size, idx, val)
    got = base.clone().index_add_(0, k, v)
    ok, _, share = C.weights_gate(torch, got, base, idx, val)
    assert ok and share < 0.5, share
    lost_lane = got.clone()
    lost_lane[k[-1]] -= v[-1]
    m = k.numel() // 1056
    lost_block = got.clone().index_add_(0, k[:m], -v[:m])
    for bad in (lost_lane, lost_block):
        assert not C.weights_gate(torch, bad, base, idx, val)[0]
