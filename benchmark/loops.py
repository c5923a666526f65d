"""The one generator of the benchmark's traffic: it reads a mix's data
file (``benchmark/traffic/<mix>.json``) and drives the program in a
closed loop with one client, one step at a time, each step ending when
its result is on the host. The mix's ``kind`` names the file that says
what a step of that kind is, ``benchmark/kinds/<kind>.py``, found by
name like every other part of a cell. A kind's file gives:

* ``Loop(run)``: set up from ``run`` (the seed, the configuration, the
  mix, ``run.make_model``), with

  - ``k``, the steps taken so far, and ``span``, set by the harness to
    ``span_factory(True)`` for a traced window;
  - ``setup()``: the warm-up and the steps whose results are checked,
    through the window's own ``step``;
  - ``step(steps)``: one step, appending its (start, wait, end) clock to
    ``steps.marks``;
  - ``trace_steps(first, count, seed)``: which steps of a traced window
    the per-layer metrics count the work of;
  - ``close()`` after the window, ``release()`` to drop the program's
    state; ``checked``, what ``judge`` reads;
  - ``traced_work()``: (window step, work arguments) of the kept steps,
    the arguments of ``work/<config>.py``'s functions, counted by the
    plain reference once the program's state is freed;
  - ``reference_s``: the seconds the plain reference spent making the
    run's inputs at set-up, which ``setup_s`` leaves out;
  - ``info(steps)``: counts printed on the line before the result;

* ``judge(run, checked) -> {number: value}``: what the timed path
  produced against the plain reference, each number held to its limit in
  ``limits/<cell>.json``;
* ``NUMBERS``: the names ``judge`` returns;
* ``FAULTS``: the faults that the cell can have, by name, each a
  function ``plant(kwargs) -> undo`` (``controls.py`` plants them).

The scene vectors come from the configuration's ``base`` and ``draws``:
each drawn entry is uniform in [lo, hi]; where ``strata`` is set, the
vectors of one run take one value from each of as many equal strata as
there are vectors, in an order drawn from the seed. So every seed gives
the same spread of scene sizes, and so of work, in another order.
"""

from __future__ import annotations

import contextlib
import importlib
import random

import numpy as np

from .tracing import MARK_PREFIX, SPAN_PREFIX


def load_kind(kind: str):
    """The module ``benchmark/kinds/<kind>.py``, imported once, so that a
    fault planted in it holds for the run."""
    if not kind.isidentifier():
        raise ValueError(f"a kind's name is a Python identifier: {kind!r}")
    return importlib.import_module(f"benchmark.kinds.{kind}")


def draw_vectors(cfg: dict, rng: np.random.Generator, count: int):
    """``count`` scene vectors of the configuration, as a float32 array."""
    out = np.tile(np.asarray(cfg["base"], np.float32), (count, 1))
    for d in cfg["draws"]:
        u = rng.random(count)
        if d.get("strata"):
            u = (rng.permutation(count) + u) / count
        out[:, d["index"]] = d["lo"] + (d["hi"] - d["lo"]) * u
    return out.astype(np.float32)


class Steps:
    """The host clock of every step: (start, wait, end), ``wait`` being
    when the host began to wait for the step's result."""

    def __init__(self):
        self.marks = []

    def window(self):
        return self.marks[-1][2] - self.marks[0][0]

    def durations(self):
        return [e - s for s, _, e in self.marks]

    def host(self):
        return [w - s for s, w, _ in self.marks]


def pick_steps(first: int, count: int, seed: int):
    """``count`` steps of the window's first 200, drawn from the seed: the
    steps whose work the traced run counts for its rooflines."""
    return sorted(random.Random(seed).sample(range(first, first + 200),
                                             count))


def span_factory(trace: bool):
    """``span(part)``: a ``record_function`` named ``bench.<part>`` in a
    traced run, nothing otherwise."""
    if not trace:
        return lambda part: contextlib.nullcontext()
    from torch.profiler import record_function
    return lambda part: record_function(SPAN_PREFIX + part)


def mark(name: str):
    """An instant in the trace, from whichever thread calls it."""
    from torch.profiler import record_function
    with record_function(MARK_PREFIX + name):
        pass


class Altered:
    """A module whose images have one row altered by +1, where they are
    produced."""

    def __init__(self, base):
        self.base, self.params = base, base.params

    def __call__(self):
        import torch
        img = self.base()
        row = img.shape[0] // 2
        return img + (torch.arange(img.shape[0], device=img.device)
                      == row).to(img.dtype)[:, None]


def plant_altered(kwargs: dict):
    """The fault "an answer altered where it is produced", for a kind
    whose step renders through ``run.make_model``."""
    kwargs["make_model"] = lambda run, vec, n: Altered(
        run.program.model(vec, n, run.model_dtype))
    return lambda: None
