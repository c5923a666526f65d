"""The port's spans and counters (``_build.span``, ``launch``, ``timed``)
on the CPU: a span off the profiler is one shared null context; a render
call opens one forward span and one backward span, whatever its route; a
launch counts and opens its span, or raises; the build's phases count
only what ran; and the port's record of its spans holds the profiler's
own annotations on the profiler's clock.
"""

from __future__ import annotations

import collections
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from enoki_tpu_torch import _build
from enoki_tpu_torch.render import GenericRender, Vec3, make_sdf_renderer
from enoki_tpu_torch.render import sdflib as sd
from enoki_tpu_torch.render.generic import SceneKernels, ortho_camera
from enoki_tpu_torch.render.sdf_kernels import SDFRender
from enoki_tpu_torch.render.sphere_kernels import SphereRender

N, STEPS = 16, 8


def composed(p, pv):
    """The composed scene of the benchmark's ``composed_sdf``: a sphere
    smooth-unioned with a torus, over a plane."""
    sphere = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
    torus = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
    ground = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
    return sd.op_union(sd.op_smooth_union(sphere, torus, 0.1), ground)


COMPOSED = [0.15, 40.0, -1.0, -1.0, 2.0, 0.0, 0.0, 0.3, 0.5, 0.6, 0.15,
            1.0]


def model(kind: str, coarse: int = 0):
    if kind == "sdf":
        return SDFRender(n=N, n_steps=STEPS, device="cpu", coarse=coarse)
    if kind == "generic":
        render, _ = make_sdf_renderer(composed, len(COMPOSED))
        return GenericRender(render, COMPOSED, n=N, n_steps=STEPS,
                             device="cpu", coarse=coarse)
    return SphereRender(n=N, device="cpu")


def port_annotations(prof):
    """(name, start, end) of every ``enoki.`` annotation the profiler
    recorded, by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()
                   and e.name().startswith("enoki.")), key=lambda a: a[1])


def test_a_span_off_the_profiler_is_one_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called off the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert _build.span("render.forward") is _build._OFF
    assert _build.span("launch.sdf_fwd") is _build._OFF
    before = len(_build.SPANS)
    m = model("sdf")
    m().mean().backward()
    assert m.params.grad is not None
    assert len(_build.SPANS) == before


@pytest.mark.parametrize("kind", ["sdf", "generic", "sphere"])
def test_a_render_opens_one_forward_and_one_backward_span(kind):
    m = model(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m().mean().backward()
    names = collections.Counter(n for n, _, _ in port_annotations(prof))
    assert names["enoki.render.forward"] == 1
    assert names["enoki.render.backward"] == 1
    assert names["enoki.render.prepass"] == 0


@pytest.mark.parametrize("kind", ["sdf", "generic"])
def test_the_cone_prepass_opens_its_span_inside_the_forward(kind):
    m = model(kind, coarse=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m().mean().backward()
    spans = port_annotations(prof)
    fwd = [(s, e) for n, s, e in spans if n == "enoki.render.forward"]
    pre = [(s, e) for n, s, e in spans if n == "enoki.render.prepass"]
    assert len(fwd) == 1 and len(pre) == 1
    assert fwd[0][0] <= pre[0][0] and pre[0][1] <= fwd[0][1]


def test_the_record_holds_the_profilers_annotations_on_its_clock():
    m = model("sdf", coarse=8)
    _build.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m().mean().backward()
    spans = port_annotations(prof)
    kept = sorted(_build.SPANS, key=lambda s: s[1])
    assert [n for n, _, _ in spans] == [n for n, _, _, _ in kept]
    # the annotation opens before the record and closes after it; the
    # slack is only for the profiler's conversion of its clock
    slack = 50_000
    for (_, s, e), (_, ks, ke, _) in zip(spans, kept):
        assert s - slack <= ks <= ke <= e + slack


def test_launch_counts_and_opens_its_span(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _build.launch("fake_kernel", entry, 1, 2.5, None)
    assert calls == [(1, 2.5, None)]
    assert _build.LAUNCHES == {"fake_kernel": 1}
    assert [n for n, _, _ in port_annotations(prof)] == [
        "enoki.launch.fake_kernel"]
    _build.launch("fake_kernel", entry)
    assert _build.LAUNCHES == {"fake_kernel": 2}


def test_a_launch_that_returns_an_error_raises_and_is_not_counted(
        monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    with pytest.raises(RuntimeError,
                       match="fake_kernel launch failed: CUDA error 700"):
        _build.launch("fake_kernel", lambda *a: 700, 1)
    assert not _build.LAUNCHES


class FakeLib:
    """What ``_bind`` reads of a loaded library: an attribute for every
    entry point, which takes ``argtypes`` and ``restype``."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def counters(monkeypatch, tmp_path):
    """A build directory and build counters of the test's own."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILDS", collections.Counter())
    monkeypatch.setattr(_build, "BUILD_SECONDS", collections.Counter())
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    return tmp_path


def test_loading_a_built_library_counts_digest_and_bind_not_compile(
        counters, monkeypatch):
    src = (_build.CSRC_DIR / "hist.cu").read_bytes()
    digest = _build._digest(src)
    (counters / f"hist-{digest[:16]}.so").write_bytes(b"")
    _build.BUILDS.clear()

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc ran for a library that is built")

    monkeypatch.setattr(_build.subprocess, "run", no_nvcc)
    lib = _build.load.__wrapped__("hist")
    assert isinstance(lib, FakeLib)
    assert _build.BUILDS == {"digest": 1, "bind": 1}
    assert set(_build.BUILD_SECONDS) == {"digest", "bind"}


def test_a_build_counts_one_compile_and_the_next_load_none(counters,
                                                           monkeypatch):
    ran = []

    def nvcc(cmd, **kwargs):
        ran.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb"):
            pass
        return type("Done", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()

    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    _build.load.__wrapped__("stochastic_round")
    assert _build.BUILDS == {"digest": 1, "compile": 1, "bind": 1}
    assert _build.BUILD_SECONDS["compile"] > 0
    _build.load.__wrapped__("stochastic_round")
    assert len(ran) == 1
    assert _build.BUILDS == {"digest": 2, "compile": 1, "bind": 2}


def test_a_scenes_timers_come_from_the_build_timer(counters, monkeypatch):
    kernels = SceneKernels(composed, ortho_camera, len(COMPOSED))
    kernels.traced
    assert _build.BUILDS["trace"] == 1
    assert kernels.trace_seconds == _build.BUILD_SECONDS["trace"] > 0
    kernels.traced
    assert _build.BUILDS["trace"] == 1

    def load_generated(name, text):
        with _build.timed("bind"):
            time.sleep(0.002)
        return type("Lib", (), {"generic_n_params":
                                staticmethod(lambda: len(COMPOSED))})()

    monkeypatch.setattr(_build, "load_generated", load_generated)
    kernels.lib
    assert kernels.load_seconds == _build.BUILD_SECONDS["bind"] >= 0.002


def test_build_phases_timed_on_many_threads_lose_no_count(counters):
    threads, calls = 12, 100

    def work():
        for _ in range(calls):
            with _build.timed("digest"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert _build.BUILDS == {"digest": threads * calls}


def lazy_step(n: int = 256):
    """A lazy generator of ``n`` CPU lanes whose seed is evaluated, and
    one recorded step of the histogram mini-app: (counts, the next
    state), neither evaluated."""
    from enoki_tpu_torch import ops, trace
    from enoki_tpu_torch.types import PCG32
    gen = PCG32.create_lazy(n, initstate=7, device="cpu")
    trace.eval(gen.state.v, gen.inc.v)
    u, gen = gen.next_float32()
    g = ops.erfinv(2.0 * u - 1.0) * 2.0 ** 0.5
    counts = ops.histogram(ops.floor((g + 4.0) * 8.0).to(torch.int32), 64)
    return counts, gen.state.v


def test_a_lazy_eval_opens_its_span_once_with_the_schedule_inside():
    from enoki_tpu_torch import trace
    counts, state = lazy_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.eval(counts, state)
    spans = port_annotations(prof)
    evals = [(s, e) for n, s, e in spans if n == "enoki.trace.eval"]
    scheds = [(s, e) for n, s, e in spans if n == "enoki.trace.schedule"]
    assert len(evals) == 1 and len(scheds) == 1
    assert evals[0][0] <= scheds[0][0] and scheds[0][1] <= evals[0][1]
    assert counts.materialized and state.materialized
    assert float(counts.torch().sum()) <= 256
    # an array already evaluated opens no schedule
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.eval(counts, state)
    names = [n for n, _, _ in port_annotations(prof)]
    assert "enoki.trace.schedule" not in names
    trace.reset()


def test_an_eager_draw_and_histogram_open_their_spans():
    from enoki_tpu_torch import ops
    from enoki_tpu_torch.types import PCG32
    gen = PCG32.create(256, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        u, gen = gen.next_float32()
        b = ops.floor((ops.erfinv(2.0 * u - 1.0) * 2.0 ** 0.5 + 4.0) * 8.0)
        counts = ops.histogram(b.to(torch.int32), 64)
    names = collections.Counter(n for n, _, _ in port_annotations(prof))
    assert names["enoki.random.next"] == 1
    assert names["enoki.ops.histogram"] == 1
    assert float(counts.sum()) <= 256


def test_the_histograms_spans_are_not_kept_off_the_profiler():
    from enoki_tpu_torch import ops, trace
    from enoki_tpu_torch.types import PCG32
    assert not torch.autograd._profiler_enabled()
    before = len(_build.SPANS)
    gen = PCG32.create(64, device="cpu")
    u, gen = gen.next_float32()
    ops.histogram((u * 64.0).to(torch.int32), 64)
    trace.eval(*lazy_step())
    trace.reset()
    assert len(_build.SPANS) == before
