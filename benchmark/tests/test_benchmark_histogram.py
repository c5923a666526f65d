"""CPU tests of the ``histogram`` configuration's yardstick: the frozen
work against the reference's formulas, the count gap of the reference
against itself and of the bfloat16 probit, the ``draws`` kind's window
steps and judge on either path, and the new per-layer metric
``roofline.histogram`` on a hand-built trace.

Run: python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, peaks, tracing  # noqa: E402
from benchmark.kinds import draws  # noqa: E402
from benchmark.reference import histogram as ref  # noqa: E402

HARNESS_TESTS = harness.load_module(
    Path(__file__).with_name("test_benchmark_harness.py"),
    "bench_harness_tests_histogram")
Ev = HARNESS_TESTS.Ev
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CFG = json.loads((ROOT / "benchmark" / "configs" /
                  "histogram.json").read_text())
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"
N = 1 << 16


def work():
    return harness.load_module(ROOT / "benchmark" / "work" / "histogram.py",
                               "work_test_histogram")


def metric(name):
    return harness.load_module(harness.Cell.metric_file(name),
                               "histogram_test_" + name.replace(".", "_"))


def test_work_ties_to_the_reference_formulas():
    w = work()
    state, inc = ref.seed(N, 5, CPU)
    nbytes, ops = w.draws(N, CFG["bins"])
    # the state read and written once a lane, the counts written once
    assert nbytes == 2 * state.element_size() * N + 4 * CFG["bins"]
    # the increment is the lane's: the reference makes it from the lane
    seq = torch.arange(N, dtype=torch.int64) + ref.i64(ref.DEFAULT_STREAM)
    assert torch.equal(inc, (seq << 1) | 1)
    assert ops == (w.FP32_OPS + w.INT32_WEIGHT * w.INT32_OPS) * N
    # two degree-8 polynomials of the Giles fit by Horner: 32 of them
    assert w.FP32_OPS > 32 and w.INT32_OPS > 0
    # at the cell's size the bytes bound a step: 0.080 ms on the H100
    t, by = peaks.least_seconds(H100, *w.draws(CFG["lanes"], CFG["bins"]))
    assert by == "bytes"
    assert t == pytest.approx((16 * CFG["lanes"] + 256) / 3.35e12)
    assert 0.0800e-3 < t < 0.0802e-3


def test_the_reference_generator_steps_and_jumps_alike():
    state, inc = ref.seed(N, 11, CPU)
    s = state
    for _ in range(5):
        _, s = ref.step(s, inc)
    assert torch.equal(s, ref.advance(state, inc, 5))
    assert torch.equal(state, ref.advance(state, inc, 0))


def test_count_gap_is_0_for_the_reference_and_positive_for_bfloat16():
    lo, hi = CFG["range"]
    bins, delta = CFG["bins"], CFG["band"]["delta"]
    state, inc = ref.seed(N, draws.initstate(2 ** 33 + 1), CPU)
    r, a = ref.histogram(state, inc, lo, hi, bins, delta)
    assert ref.count_gap(r, r, a) == 0.0
    # the band holds a few lanes near the edges, the counts every lane in
    # range
    assert 0 < int(a.sum()) < N // 100
    assert N - 20 <= int(r.sum()) <= N
    r16, _ = ref.histogram(state, inc, lo, hi, bins, delta,
                           dtype=torch.bfloat16)
    assert ref.count_gap(r16, r, a) > 0


def test_the_band_holds_every_lane_a_small_error_moves():
    lo, hi = CFG["range"]
    bins, delta = CFG["bins"], CFG["band"]["delta"]
    state, inc = ref.seed(N, 3, CPU)
    r, a = ref.histogram(state, inc, lo, hi, bins, delta)
    bits, _ = ref.step(state, inc)
    g = ref.probit(ref.uniform(bits))
    # every probit moved by up to delta, half of them each way
    sign = torch.where(torch.arange(N) % 2 == 0, 1.0, -1.0)
    t = ref.scaled(g + 0.999 * delta * sign, lo, hi, bins)
    inside = (t >= 0) & (t < bins)
    c = torch.bincount(t[inside].floor().long(), minlength=bins)
    assert not torch.equal(c, r)
    assert ref.count_gap(c, r, a) == 0.0


def window_run():
    """A run of a hand-built traced window of 10 s and two steps: each a
    ``draw`` and a ``readback`` span, and the device operations that ran
    in them; the picked steps are both."""
    a = dict(annotation=True)
    events = [
        Ev("bench.window", "CPU", 0.0, 10.0, corr=1, **a),
        Ev("bench.draw", "CPU", 1.0, 1.5, corr=2, **a),
        Ev("bench.readback", "CPU", 1.5, 3.0, corr=3, **a),
        # a kernel the profiler links to no launch: it counts all the same
        Ev("tk_run0", "CUDA", 1.6, 2.6),
        Ev("Memcpy DtoH", "CUDA", 2.7, 2.8, corr=9, linked=3),
        Ev("bench.draw", "CPU", 5.0, 5.2, corr=4, **a),
        Ev("bench.readback", "CPU", 5.2, 7.0, corr=5, **a),
        Ev("k_a", "CUDA", 5.1, 5.6),
        Ev("k_b", "CUDA", 5.7, 6.4),
        # a kernel between the steps belongs to neither
        Ev("k_c", "CUDA", 8.0, 9.0),
    ]
    return types.SimpleNamespace(
        trace_data=tracing.reduce(events),
        steps=types.SimpleNamespace(marks=[(1.0, 1.5, 3.0),
                                           (5.0, 5.2, 7.0)]),
        traced_work=[(0, dict(lanes=1000, bins=64)),
                     (1, dict(lanes=1000, bins=64))],
        work=work(), device_kind=H100)


def test_roofline_histogram_reads_the_steps_device_time():
    run = window_run()
    least = peaks.least_seconds(H100, *work().draws(1000, 64))[0]
    # step 0: 1.0 + 0.1 s; step 1: 0.5 + 0.7 s
    want = 100.0 * 2 * least / 2.3
    assert metric("roofline.histogram").read(run) == pytest.approx(want)
    run.device_kind = "a card the table lacks"
    assert metric("roofline.histogram").read(run) is None


def test_roofline_histogram_fails_a_step_without_device_work():
    run = window_run()
    run.trace_data.ops = [o for o in run.trace_data.ops
                          if o.name not in ("k_a", "k_b")]
    with pytest.raises(RuntimeError, match="window step 1"):
        metric("roofline.histogram").read(run)


@pytest.mark.parametrize("path", ["eager", "lazy"])
def test_the_draws_kind_judges_either_path_sound(path):
    c = harness.Cell(SPEC, "histogram.eager_16m")
    run = harness.Run(c, 2 ** 33 + 3, 0.1, False, CPU, time.time())
    run.mix["path"] = path
    run.program = run.program_mod.Program(run.cfg, CPU)
    loop = draws.Loop(run)
    assert loop.n == run.mix["cpu_lanes"]
    assert loop.model.lazy == (path == "lazy")
    loop.setup()
    for _ in range(4):
        loop.step(run.steps)
    loop.close()
    # the checked steps 2-4 and 3 of the window's 4
    assert len(loop.checked["counts"]) == 3 + 3
    assert [k for k, _ in loop.checked["counts"]][:3] == [2, 3, 4]
    assert loop.checked["state_step"] == 5
    assert draws.judge(run, loop.checked) == {"state_gap": 0,
                                              "count_gap": 0.0}
