"""The benchmark's ``histogram`` configuration (``benchmark/configs/
histogram.py``: upstream Enoki's histogram mini-app over the port's
``PCG32``, ``ops.erfinv`` and ``ops.histogram``) against its plain
reference (``benchmark/reference/histogram.py``) on the CPU, at 2^16
lanes: the reference's PCG32 is bit-equal to the port's eager and lazy
generators and to ``enoki_tpu``'s; the program's counts on both paths
lie within the reference's band in every bin, out-of-range lanes
dropped; the lazy step's trace does not grow. One ``cuda`` test: a
second lazy step on the card builds nothing and launches at most 2 of
the trace's kernels.

The file imports no JAX at its top, so that the card runs its ``cuda``
test: ``python -m pytest tests/test_torch_histogram_config.py -m cuda
--noconftest -q``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference import histogram as ref  # noqa: E402
from enoki_tpu_torch import _build, trace  # noqa: E402
from enoki_tpu_torch.types import PCG32, u64 as U  # noqa: E402

CFG = json.loads((ROOT / "benchmark" / "configs" /
                  "histogram.json").read_text())
PROGRAM = harness.load_module(ROOT / "benchmark" / "configs" /
                              "histogram.py", "histogram_config_program")
N = 1 << 16
SEED = 0x2545F4914F6CDD1D
STEPS = 3
CPU = torch.device("cpu")


def model(path: str, n: int = N, device=CPU):
    program = PROGRAM.Program(CFG, device)
    program.path, program.initstate = path, SEED
    return program.model(torch.tensor(CFG["base"]), n)


def u64(x) -> np.ndarray:
    """An int64 tensor of uint64 bit patterns as numpy uint64."""
    return x.numpy().view(np.uint64)


def reference_draws(n=N):
    """(state after each step, the draw of each step) by the reference."""
    state, inc = ref.seed(n, SEED, CPU)
    states, draws = [], []
    for _ in range(STEPS):
        bits, state = ref.step(state, inc)
        states.append(u64(state))
        draws.append(bits.numpy().astype(np.uint32))
    return state, inc, states, draws


def test_the_reference_pcg32_is_the_ports_eager_generator():
    state, inc, states, draws = reference_draws()
    gen = PCG32.create(N, initstate=SEED, device="cpu")
    assert np.array_equal(U.to_py(gen.inc), u64(inc))
    for want_state, want_draw in zip(states, draws):
        got, gen = gen.next_uint32()
        assert np.array_equal(got.numpy().astype(np.uint32), want_draw)
        assert np.array_equal(U.to_py(gen.state), want_state)


def test_the_reference_pcg32_is_the_ports_lazy_generator():
    _, _, states, draws = reference_draws()
    gen = PCG32.create_lazy(N, initstate=SEED, device="cpu")
    for want_state, want_draw in zip(states, draws):
        got, gen = gen.next_uint32()
        trace.eval(got, gen.state.v)
        assert np.array_equal(got.numpy().astype(np.uint32), want_draw)
        assert np.array_equal(U.to_py(gen.state), want_state)
    trace.reset()


def test_the_reference_pcg32_is_enoki_tpus():
    from enoki_tpu.types import PCG32 as JPCG32, u64 as JU
    _, inc, states, draws = reference_draws()
    gen = JPCG32.create(N, initstate=SEED)
    assert np.array_equal(JU.to_py(gen.inc), u64(inc))
    for want_state, want_draw in zip(states, draws):
        got, gen = gen.next_uint32()
        assert np.array_equal(np.asarray(got).astype(np.uint32), want_draw)
        assert np.array_equal(JU.to_py(gen.state), want_state)


def test_the_model_steps_the_reference_state():
    state, inc = ref.seed(N, SEED, CPU)
    for path in ("eager", "lazy"):
        m = model(path)
        for _ in range(STEPS):
            m()
        assert torch.equal(m.state(), ref.advance(state, inc, STEPS))
    trace.reset()


@pytest.mark.parametrize("path", ["eager", "lazy"])
def test_the_counts_lie_in_the_reference_band_out_of_range_dropped(path):
    lo, hi = CFG["range"]
    bins, delta = CFG["bins"], CFG["band"]["delta"]
    state, inc = ref.seed(N, SEED, CPU)
    m = model(path)
    dropped = 0
    for k in range(STEPS):
        with torch.no_grad():
            counts = m()
        r, a = ref.histogram(ref.advance(state, inc, k), inc, lo, hi, bins,
                             delta)
        assert counts.shape == (bins,)
        assert ref.count_gap(counts, r, a) == 0.0
        # the lanes outside [lo, hi) are dropped, not put in the end bins
        total = int(counts.sum())
        assert abs(total - int(r.sum())) <= int(a[0] + a[-1])
        dropped += N - total
    assert dropped > 0
    trace.reset()


def test_the_lazy_steps_trace_does_not_grow():
    m = model("lazy")
    m()
    live = []
    for _ in range(STEPS):
        m()
        assert m.gen.state.v.materialized
        live.append(trace.stats()["n_vars"])
    assert live == [live[0]] * STEPS
    trace.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the trace's kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_second_lazy_step_on_the_card_builds_nothing(cuda):
    m = model("lazy", 1 << 20, cuda)
    m()
    torch.cuda.synchronize()
    builds = _build.BUILDS["compile"]
    launches = _build.LAUNCHES["trace"]
    hits = trace.cache_stats()[0]
    counts = m()
    assert _build.BUILDS["compile"] == builds
    assert 1 <= _build.LAUNCHES["trace"] - launches <= 2
    assert trace.cache_stats()[0] == hits + 1
    lo, hi = CFG["range"]
    state, inc = ref.seed(1 << 20, SEED, cuda)
    r, a = ref.histogram(ref.advance(state, inc, 1), inc, lo, hi,
                         CFG["bins"], CFG["band"]["delta"])
    assert ref.count_gap(counts, r, a) == 0.0
    trace.reset()
