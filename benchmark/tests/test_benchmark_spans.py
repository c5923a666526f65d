"""CPU tests of the per-layer metrics that read the program's own spans
and counters (``benchmark/program_spans.py``; ``port_host_ms``,
``launch_us``, ``idle_in_port_ms``, ``builds``): each gives its
hand-computed value on a hand-built trace, a program without the record
gives nothing, a window without a render span fails, and the program's
annotations in the profiler's trace change nothing that the earlier
metrics read.

Run: python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import collections
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, tracing  # noqa: E402
from enoki_tpu_torch import _build  # noqa: E402

HARNESS_TESTS = harness.load_module(
    Path(__file__).with_name("test_benchmark_harness.py"),
    "bench_harness_tests")
Ev = HARNESS_TESTS.Ev
SPAN_METRICS = ("port_host_ms", "launch_us", "idle_in_port_ms")


def metric(name):
    return harness.load_module(harness.Cell.metric_file(name),
                               "span_test_" + name)


def program_events():
    """``enoki.`` annotations of the synthetic trace's two steps, on the
    main thread (1) and autograd's (2): forward 1.0-1.4 s holding a
    launch 1.1-1.12 s and another 1.2-1.24 s, backward 4.5-5.6 s on the
    other thread holding a launch 5.0-5.01 s; forward 5.5-5.75 s holding a
    launch 5.6-5.63 s."""
    a = dict(annotation=True)
    return [
        Ev("enoki.render.forward", "CPU", 1.0, 1.4, corr=20, **a),
        Ev("enoki.launch.sdf_fwd", "CPU", 1.1, 1.12, corr=21, **a),
        Ev("enoki.launch.sdf_fwd", "CPU", 1.2, 1.24, corr=22, **a),
        Ev("enoki.render.backward", "CPU", 4.5, 5.6, corr=23, thread=2,
           **a),
        Ev("enoki.launch.sdf_bwd", "CPU", 5.0, 5.01, corr=24, thread=2,
           **a),
        Ev("enoki.render.forward", "CPU", 5.5, 5.75, corr=25, **a),
        Ev("enoki.launch.sdf_fwd", "CPU", 5.6, 5.63, corr=26, **a),
    ]


def record_of(events):
    """The port's record of the same spans, as ``_build.SPANS`` keeps
    them: (name, start ns, end ns, thread)."""
    return collections.deque((e.name(), e.start_ns(), e.end_ns(),
                              e.start_thread_id()) for e in events)


def traced_run(monkeypatch, record):
    """A run of the synthetic trace's window and two steps, with
    ``record`` as the program's spans (None: a program without them)."""
    if record is None:
        monkeypatch.delattr(_build, "SPANS")
    else:
        monkeypatch.setattr(_build, "SPANS", record)
    steps = types.SimpleNamespace(marks=[(1.0, 1.6, 5.1), (5.5, 5.9, 7.1)])
    return types.SimpleNamespace(
        trace_data=tracing.reduce(HARNESS_TESTS.synthetic_trace()),
        steps=steps)


def test_the_programs_annotations_change_nothing_the_trace_held():
    plain = tracing.reduce(HARNESS_TESTS.synthetic_trace())
    both = tracing.reduce(HARNESS_TESTS.synthetic_trace()
                          + program_events())
    assert both.spans == plain.spans and both.marks == plain.marks
    assert both.ops == plain.ops and both.window == plain.window
    assert tracing.breakdown(both) == tracing.breakdown(plain)


def test_each_span_metric_reads_its_hand_computed_value(monkeypatch):
    run = traced_run(monkeypatch, record_of(program_events()))
    # render spans: 1.0-1.4 and the union of 4.5-5.6 and 5.5-5.75 (4.5 -
    # 5.75): 0.4 + 1.25 s over 2 steps
    assert metric("port_host_ms").read(run) == pytest.approx(825.0)
    # launches of 20, 40, 10 and 30 ms
    assert metric("launch_us").read(run) == pytest.approx(25_000.0)
    # the card idles 0-2, 5-6 and 7-10; the spans cover 1.0-1.4 and
    # 4.5-5.75: 0.4 + 0.75 s over 2 steps
    assert metric("idle_in_port_ms").read(run) == pytest.approx(575.0)


def test_builds_reads_the_programs_compile_counter(monkeypatch):
    run = traced_run(monkeypatch, collections.deque())
    monkeypatch.setattr(_build, "BUILDS",
                        collections.Counter(digest=3, bind=2))
    assert metric("builds").read(run) == 0
    _build.BUILDS["compile"] += 2
    assert metric("builds").read(run) == 2


@pytest.mark.parametrize("name", SPAN_METRICS + ("builds",))
def test_a_program_without_spans_or_counters_gives_nothing(monkeypatch,
                                                           name):
    run = traced_run(monkeypatch, None)
    monkeypatch.delattr(_build, "BUILDS")
    assert metric(name).read(run) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_window_without_a_render_span_fails(monkeypatch, name):
    outside = [Ev("enoki.render.forward", "CPU", 11.0, 11.2, thread=1)]
    launches = [e for e in program_events()
                if e.name().startswith("enoki.launch.")]
    run = traced_run(monkeypatch, record_of(outside + launches))
    with pytest.raises(RuntimeError, match="no enoki.render span"):
        metric(name).read(run)


def test_launch_us_fails_on_render_spans_without_launches(monkeypatch):
    render = [e for e in program_events()
              if e.name().startswith("enoki.render.")]
    run = traced_run(monkeypatch, record_of(render))
    with pytest.raises(RuntimeError, match="no enoki.launch span"):
        metric("launch_us").read(run)
