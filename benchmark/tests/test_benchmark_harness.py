"""CPU tests of the benchmark's harness: the cells resolve to their files
by name, the statistics and the trace's reduction compute what their
metrics say, a run without a card fails, nothing a run imports is JAX or
the JAX package, and the plain reference imports nothing of the program.

Run: python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, judge, loops, stats, tracing  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.Cell(SPEC, name)
    for f in cell.files():
        assert f.is_file(), f
    kind = loops.load_kind(cell.kind)
    assert cell.kind_file == Path(kind.__file__)
    cfg = json.loads(cell.config_file.read_text())
    assert cfg["name"] == cell.workload["config"]
    assert cfg["lower_precision"]["path"] in ("program", "reference")
    limits = json.loads(cell.limits_file.read_text())
    assert set(limits) == set(kind.NUMBERS)
    assert kind.FAULTS
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "step_ms"}
    assert cell.per_layer


def test_benchmark_json_keeps_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    rooflines = [m for m in SPEC["per_layer"] if "roofline" in m["name"]]
    assert all(m["unit"] == "%" for m in rooflines)


def test_step_ms_is_the_window_over_the_steps():
    assert stats.step_ms(2.5, 1000) == pytest.approx(2.5)
    with pytest.raises(ValueError):
        stats.step_ms(1.0, 0)


def test_the_95th_percentile_is_over_every_step():
    xs = [float(i) for i in range(1, 101)]
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    steps = loops.Steps()
    for k, d in enumerate([1.0, 1.0, 1.0, 1.0, 9.0]):
        steps.marks.append((10.0 * k, 10.0 * k + 0.5, 10.0 * k + d))
    assert stats.percentile(steps.durations(), 95) == pytest.approx(7.4)
    assert steps.window() == pytest.approx(49.0)
    assert steps.host() == [0.5] * 5


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [1.0, 1.1, 1.2, 1.3, 1.4, 1.5]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


class Ev:
    """A raw profiler event as ``tracing.reduce`` reads one."""

    def __init__(self, name, dev, start, end, corr=0, linked=0,
                 annotation=False, thread=1):
        self._v = (name, dev, start, end, corr, linked, annotation, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return int(self._v[2] * 1e9)

    def end_ns(self):
        return int(self._v[3] * 1e9)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


def synthetic_trace():
    """A 10 s window, two steps with a forward span each. Step 0's
    kernels overlap (2-4 and 3-5); step 1's kernel runs 6-7. Host op 7
    and the launch of kernel 7 share a correlation id, as the profiler's
    two counts may."""
    a = dict(annotation=True)
    return [
        Ev("bench.window", "CPU", 0.0, 10.0, corr=1, **a),
        Ev("bench.forward", "CPU", 1.0, 1.5, corr=2, **a),
        Ev("cudaLaunchKernel", "CPU", 1.1, 1.12, corr=7, linked=2),
        Ev("k_a", "CUDA", 2.0, 4.0, corr=7, linked=2),
        Ev("cudaLaunchKernel", "CPU", 1.2, 1.22, corr=8, linked=2),
        Ev("k_b", "CUDA", 3.0, 5.0, corr=8, linked=2),
        Ev("bench.readback", "CPU", 1.6, 5.1, corr=3, **a),
        Ev("bench.forward", "CPU", 5.5, 5.8, corr=4, **a),
        Ev("aten::op", "CPU", 9.0, 9.1, corr=7),
        Ev("cudaLaunchKernel", "CPU", 5.6, 5.62, corr=9, linked=4),
        Ev("k_c", "CUDA", 6.0, 7.0, corr=9, linked=4),
        Ev("bench.forward", "CUDA", 6.0, 7.0, corr=4, **a),
        Ev("bench.readback", "CPU", 5.9, 7.1, corr=5, **a),
    ]


def test_device_idle_share_from_a_synthetic_trace():
    td = tracing.reduce(synthetic_trace())
    assert td.window == (0.0, 10.0)
    # the union of 2-4, 3-5 and 6-7 is 4 s; annotations are no operation
    assert tracing.busy_seconds(td) == pytest.approx(4.0)
    run = type("R", (), {"trace_data": td})()
    reader = harness.load_module(harness.Cell.metric_file(
        "device_idle_share"), "idle_test")
    assert reader.read(run) == pytest.approx(60.0)
    gaps = dict(tracing.breakdown(td)["idle_gaps"])
    # 0-2 before the first operation, 5-6 and 7-10 while reading back
    assert gaps["between spans"] == pytest.approx(2.0)
    assert gaps["readback"] == pytest.approx(4.0)


def test_operations_belong_to_the_span_that_launched_them():
    td = tracing.reduce(synthetic_trace())
    fwd = tracing.spans_named(td, "forward")
    assert [o.name for o in tracing.ops_in(td, *fwd[0])] == ["k_a", "k_b"]
    assert [o.name for o in tracing.ops_in(td, *fwd[1])] == ["k_c"]


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(RuntimeError):
        tracing.reduce([Ev("k", "CUDA", 0.0, 1.0)])


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "enoki_tpu_torch_fake", object())
    assert "enoki_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "enoki_tpu.fake", object())
    assert "enoki_tpu.fake" in harness.forbidden_modules()


def run_py(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def test_a_run_without_a_card_fails():
    if has_card():
        pytest.skip("a card is present: the run would measure it")
    proc = run_py(ROOT, "--workload", CELLS[0], "--seed", "3000000000",
                  "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_py(tmp_path, "--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


IMPORT_PATH = """
import sys, json
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
spec = json.load(open({root!r} + "/BENCHMARK.json"))
run = harness.Run(harness.Cell(spec, {cell!r}), 1, 1.0, False,
                  torch.device("cpu"), 0.0)
run.program = run.program_mod.Program(run.cfg, torch.device("cpu"))
vec = torch.tensor(run.cfg["base"])
run.program.model(vec, 8)().sum().backward()
print(json.dumps(harness.forbidden_modules()))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_imports_neither_jax_nor_the_jax_package(name):
    code = IMPORT_PATH.format(root=str(ROOT), cell=name)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    ref = ROOT / "benchmark" / "reference"
    for f in ref.glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("enoki_tpu_torch", "enoki_tpu",
                                               "jax"), (f, m)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import benchmark.reference.common, "
            "benchmark.reference.sphere_sdf, "
            "benchmark.reference.composed_sdf; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('enoki_tpu') "
            "or m.split('.')[0] == 'jax'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_the_verdict_fails_a_number_over_its_limit_and_a_nan():
    ok, checks = judge.verdict({"a": 0.5, "b": 2.0}, {"a": 1.0, "b": 1.0})
    assert not ok and checks["a"] == {"value": 0.5, "limit": 1.0}
    assert not judge.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert judge.verdict({"a": 1.0}, {"a": 1.0})[0]
    # a number that its limits name and the run leaves out fails
    assert not judge.verdict({"a": 1.0}, {"a": 1.0, "b": 1.0})[0]


TOY_FILES = {
    "configs/toy_sum.json": json.dumps({
        "name": "toy_sum", "n": 4096, "lower_precision":
        {"path": "reference", "dtype": "bfloat16"}}),
    "configs/toy_sum.py": '''
import torch


class Program:
    def __init__(self, cfg, device):
        self.cfg, self.device = cfg, device

    def load(self):
        pass

    def total(self, x):
        return x.sum()
''',
    "reference/toy_sum.py": '''
def total(x):
    return float(sum(x.double().tolist()))
''',
    "work/toy_sum.py": '''
def sum_work(n):
    return 4 * n, n
''',
    "traffic/toy_rows.json": json.dumps({"kind": "toy", "rows": 8}),
    "kinds/toy.py": '''
import importlib
import time

import torch

from benchmark.loops import Steps, span_factory

NUMBERS = ("sum_gap",)


class Loop:
    reference_s = 0.0

    def __init__(self, run):
        self.run, self.k, self.span = run, 0, span_factory(False)
        g = torch.Generator().manual_seed(run.seed)
        self.x = torch.rand(run.mix["rows"], run.cfg["n"], generator=g)
        self.got = None
        self.checked = None

    def step(self, steps: Steps):
        t0 = time.perf_counter()
        got = self.run.program.total(self.x[self.k % len(self.x)])
        t_wait = time.perf_counter()
        self.got = (self.k % len(self.x), float(got))
        steps.marks.append((t0, t_wait, time.perf_counter()))
        self.k += 1

    def setup(self):
        self.step(Steps())

    def trace_steps(self, first, count, seed):
        pass

    def traced_work(self):
        return []

    def info(self, steps):
        return {"rows": self.run.mix["rows"]}

    def close(self):
        self.checked = {"row": self.x[self.got[0]], "got": self.got[1]}

    def release(self):
        pass


def judge(run, checked):
    want = run.reference.total(checked["row"])
    return {"sum_gap": abs(checked["got"] - want) / abs(want)}


FAULTS = {}
''',
    "limits/toy_sum.rows.json": json.dumps({"sum_gap": 1e-5}),
    "metrics/rows_per_s.py": '''
def read(run):
    return len(run.steps.marks) / run.steps.window()
''',
}

TOY_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
spec = json.load(open({root!r} + "/BENCHMARK.json"))
cell = harness.Cell(spec, "toy_sum.rows")
assert all(f.is_file() for f in cell.files())
result, info = harness.run_cell(cell, 2 ** 33 + 5, 0.2, False,
                                torch.device("cpu"), time.time())
print(json.dumps(result))
"""


def test_a_cell_of_a_new_kind_is_added_by_files_alone(tmp_path):
    """A configuration, a mix of a new kind, its limits, an end-to-end
    metric and a cell, each added as a file or an entry: the copy's
    existing files stay as they are, and the run is correct."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    for rel, text in TOY_FILES.items():
        path = tmp_path / "benchmark" / rel
        assert not path.exists(), rel
        path.write_text(text)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy_sum", "source": "a toy",
                            "file": "benchmark/configs/toy_sum.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy_sum.rows", "config": "toy_sum",
                              "traffic": "toy_rows", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["toy_sum.rows"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = TOY_RUN.format(root=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"step_ms", "step_ms_p95", "setup_s",
                                      "rows_per_s"}
    assert result["checks"]["sum_gap"]["limit"] == 1e-5
    assert all(p.read_bytes() == b for p, b in before.items())
