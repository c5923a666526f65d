"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, set up from the seed, measure the window, judge the
outputs against the plain reference, and return the result line.

What belongs to one configuration, traffic mix, kind of step or metric
sits in files of its own, found by name, so that a cell, configuration,
mix, kind or metric is added by adding files and entries alone:

* ``configs/<config>.json`` (the configuration's sizes, as
  ``BENCHMARK.json`` names it) and ``configs/<config>.py`` (its
  ``Program``: how the program under test builds the scene's module);
* ``reference/<config>.py``, its plain reference, and ``work/<config>.py``,
  the work its functions need;
* ``traffic/<mix>.json``, the mix's parameters, and
  ``kinds/<kind>.py``, what a step of the mix's ``kind`` is and how its
  results are judged (``loops.py`` says what a kind's file gives);
* ``limits/<cell>.json``, the limit of each number the kind compares;
* ``metrics/<metric>.py``, a metric's reader, end-to-end or per-layer:
  ``read(run)`` returns the value, or None where the run holds nothing
  to read.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import judge, loops, tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "enoki_tpu")
TRACED_STEPS = 4   # steps of a traced window whose work the rooflines count


class CellError(RuntimeError):
    pass


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise CellError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, spec: dict, name: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.name = spec, name
        self.workload = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        root = HERE.parent
        self.config_file = root / self.config_entry["file"]
        config = self.workload["config"]
        self.program_file = HERE / "configs" / f"{config}.py"
        self.reference_module = f"benchmark.reference.{config}"
        self.work_file = HERE / "work" / f"{config}.py"
        mix = self.workload["traffic"]
        self.traffic_file = HERE / "traffic" / f"{mix}.json"
        self.kind = json.loads(self.traffic_file.read_text())["kind"]
        self.kind_file = HERE / "kinds" / f"{self.kind}.py"
        self.limits_file = HERE / "limits" / f"{name}.json"
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]

    def files(self):
        return [self.config_file, self.program_file, self.work_file,
                self.traffic_file, self.kind_file, self.limits_file,
                HERE / "reference" / f"{self.workload['config']}.py"] + [
            self.metric_file(m["name"])
            for m in self.end_to_end + self.per_layer]

    @staticmethod
    def metric_file(metric: str) -> Path:
        return HERE / "metrics" / f"{metric}.py"


def forbidden_modules():
    """The loaded modules whose top-level name is one of FORBIDDEN, the
    whole name compared."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


class Run:
    """Everything one run reads and makes, and what the metrics' readers
    read. ``device`` is the card, or the CPU where a test drives the run
    with the program's plain route."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.cfg = json.loads(cell.config_file.read_text())
        self.mix = json.loads(cell.traffic_file.read_text())
        self.limits = json.loads(cell.limits_file.read_text())
        self.reference = importlib.import_module(cell.reference_module)
        self.work = load_module(cell.work_file,
                                f"bench_work_{cell.workload['config']}")
        self.program_mod = load_module(
            cell.program_file, f"bench_program_{cell.workload['config']}")
        self.program = None
        self.model_dtype = None
        self.make_model = self._program_model
        self.steps = loops.Steps()
        self.setup_s = None
        self.load_s = None
        self.trace_data = None
        self.traced_work = []     # (window step, work arguments) kept
        self.device_kind = None

    def _program_model(self, vec, n):
        return self.program.model(vec, n, self.model_dtype)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, model_dtype=None, make_model=None, sizes=None):
    """One run -> (result line, a line of counts for the log).
    ``model_dtype`` and ``make_model`` stand a control in the program's
    place; ``sizes`` replaces entries of the mix (a test's small run on
    the CPU, where the program takes its plain route)."""
    run = Run(cell, seed, seconds, trace, device, t_start)
    run.model_dtype = model_dtype
    run.mix.update(sizes or {})
    kind = loops.load_kind(cell.kind)
    cuda = device.type == "cuda"
    if cuda:
        run.device_kind = torch.cuda.get_device_name(device)
        torch.cuda.reset_peak_memory_stats(device)
    marks = {"start": time.time() - t_start}
    run.program = run.program_mod.Program(run.cfg, device)
    if cuda:
        t = time.perf_counter()
        run.program.load()
        run.load_s = time.perf_counter() - t
    if make_model is not None:
        run.make_model = lambda vec, n: make_model(run, vec, n)
    marks["loaded"] = time.time() - t_start
    loop = kind.Loop(run)
    marks["inputs"] = time.time() - t_start
    marks["reference_s"] = loop.reference_s
    loop.setup()
    run.sync()
    marks["warm"] = time.time() - t_start

    # the window
    if trace:
        loop.trace_steps(loop.k, TRACED_STEPS, seed)
        loop.span = loops.span_factory(True)
    # the reference's seconds at set-up are not the program's
    run.setup_s = time.time() - t_start - loop.reference_s
    first = loop.k
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])))
        with loop.span("window"):
            t0 = time.perf_counter()
            while True:
                loop.step(run.steps)
                if time.perf_counter() - t0 >= seconds:
                    break
            run.sync()
    if trace:
        run.trace_data = tracing.reduce(prof.profiler.kineto_results.events())
        del prof
    window_s = run.steps.window()
    n_steps = len(run.steps.marks)
    loop.close()

    found = forbidden_modules()
    if found:
        raise CellError("the process loaded " + ", ".join(found))

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    checked = loop.checked
    loop.release()
    if cuda:
        torch.cuda.empty_cache()

    # the per-layer metrics' work, counted by the reference at the kept
    # steps' inputs
    if trace:
        run.traced_work = [(k - first, args)
                           for k, args in loop.traced_work()]

    t = time.perf_counter()
    correct, checks = judge.verdict(kind.judge(run, checked), run.limits)
    judge_s = time.perf_counter() - t

    result = {
        "correct": correct,
        "attempted": n_steps,
        "failed": 0,
        "metrics": {},
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": run.device_kind or str(device),
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    info = {"steps": n_steps, "window_s": window_s,
            "steps_per_s": n_steps / window_s,
            "setup_s": run.setup_s, "load_s": run.load_s,
            "setup_marks": marks, "judge_s": judge_s,
            **loop.info(run.steps)}
    if trace:
        td = run.trace_data
        if not td.ops:
            raise CellError("the profiler caught no device operation in the "
                            "traced window: no per-layer metric can be read")
        result["device"]["busy_s"] = tracing.busy_seconds(td)
        result["device"]["window_s"] = td.window[1] - td.window[0]
    for m in cell.per_layer if trace else cell.end_to_end:
        reader = load_module(cell.metric_file(m["name"]),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    if trace:
        result["breakdown"] = tracing.breakdown(run.trace_data)
    result["checks"] = checks
    return result, info
