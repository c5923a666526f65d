"""The ``draws`` kind: a Monte Carlo user's batches of random draws. A
step is the configuration's model called once: one draw from each lane
of a generator that persists from step to step, its probit, its bin, the
counts of the bins, read on the host (``bench.draw``: the launches or the
eval; ``bench.readback``: the read). The mix's ``path`` picks the array
type the program's step runs on, ``eager`` tensors or ``lazy`` trace
lanes; the seed gives the generator's initial state.

Judged against the plain reference, which seeds its own generator from
the same state and jumps it ahead to each step it checks:

* ``state_gap``: the lanes whose state differs from the reference's after
  the checked steps (integer arithmetic: exact, limit 0);
* ``count_gap``: over the checked steps and 3 steps of the window drawn
  from the seed, ``max_b max(0, |c_b - r_b| - a_b)``: the program's
  count of bin b against the reference's float64 count, beyond the lanes
  ``a_b`` within the configuration's ``band.delta`` of the bin's edges,
  which the float32 probit's error may move (limit 0).
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.loops import Steps, pick_steps, span_factory

NUMBERS = ("state_gap", "count_gap")
FROZEN_STEP = 2   # the step the "frozen" fault leaves the state as it was


def initstate(seed: int) -> int:
    """The generator's 64-bit initial state drawn from the run's seed."""
    return random.Random(seed).getrandbits(64)


def lanes(run) -> int:
    """The configuration's lanes on the card; the mix's ``cpu_lanes`` on
    the CPU, where a test drives the run through the program's plain
    route."""
    if run.device.type == "cuda":
        return run.cfg["lanes"]
    return run.mix["cpu_lanes"]


class Loop:
    """The steps of one generator over the run's lanes."""

    reference_s = 0.0

    def __init__(self, run):
        self.run, self.mix = run, run.mix
        self.n = lanes(run)
        self.initstate = initstate(run.seed)
        run.program.path = self.mix["path"]
        run.program.initstate = self.initstate
        self.model = run.make_model(torch.tensor(run.cfg["base"]), self.n)
        self.k = 0
        self.span = span_factory(False)
        self.sample = random.Random(run.seed)
        self.kept = []        # (step, counts) drawn from the window's steps
        self.seen = 0
        self.keep = False
        self.picks = []
        self.checked = None

    def step(self, steps: Steps):
        span = self.span
        t0 = time.perf_counter()
        with torch.no_grad():
            with span("draw"):
                counts = self.model.launch()
            with span("readback"):
                t_wait = time.perf_counter()
                counts = self.model.read(counts)
        steps.marks.append((t0, t_wait, time.perf_counter()))
        if self.keep:
            self._reservoir(self.k, counts)
        self.k += 1
        return counts

    def _reservoir(self, k, counts):
        """Keep a uniform sample of ``judged_steps`` of the window's steps,
        drawn from the seed."""
        want = self.mix["judged_steps"]
        if self.seen < want:
            self.kept.append((k, counts))
        else:
            r = self.sample.randrange(self.seen + 1)
            if r < want:
                self.kept[r] = (k, counts)
        self.seen += 1

    def setup(self):
        """The warm-up (the first eval of the lazy step builds or finds its
        kernels), then the checked steps: their counts, and the state
        after them."""
        steps = Steps()
        for _ in range(self.mix["warmup"]):
            self.step(steps)
        counts = [(self.k, self.step(steps))
                  for _ in range(self.mix["checked_steps"])]
        self.checked = {"lanes": self.n, "initstate": self.initstate,
                        "counts": counts, "state_step": self.k,
                        "state": self.model.state()}
        self.keep = True

    def trace_steps(self, first: int, count: int, seed: int):
        self.picks = pick_steps(first, count, seed)

    def traced_work(self):
        """(step, work arguments) of the picked steps the window reached:
        every step draws once from each lane."""
        return [(k, dict(lanes=self.n, bins=self.run.cfg["bins"]))
                for k in self.picks if k < self.k]

    def info(self, steps: Steps):
        return {"lanes": self.n,
                "draws_per_s": self.n * len(steps.marks) / steps.window()}

    def close(self):
        """The window's kept counts join the checked ones."""
        self.checked["counts"] += self.kept
        self.kept = []

    def release(self):
        del self.model


def judge(run, checked) -> dict:
    ref, cfg, dev = run.reference, run.cfg, run.device
    lo, hi = cfg["range"]
    state0, inc = ref.seed(checked["lanes"], checked["initstate"], dev)
    want = ref.advance(state0, inc, checked["state_step"])
    state_gap = int((checked["state"].to(dev) != want).sum())
    del want
    gap = 0.0
    for k, counts in checked["counts"]:
        r, a = ref.histogram(ref.advance(state0, inc, k), inc, lo, hi,
                             cfg["bins"], cfg["band"]["delta"])
        gap = max(gap, ref.count_gap(counts, r, a))
    return {"state_gap": state_gap, "count_gap": gap}


def _wrap_bins(kwargs: dict, wrap):
    """Make the run's model with its binning passed through ``wrap(b,
    model)``."""
    def make(run, vec, n):
        model = run.program.model(vec, n, run.model_dtype)
        bins_of = model.bins_of
        model.bins_of = lambda g: wrap(bins_of(g), model)
        return model
    kwargs["make_model"] = make
    return lambda: None


def plant_frozen(kwargs: dict):
    """The generator's state is not advanced in one step: the step's
    draws are made, and the next step draws from the same state again."""
    def make(run, vec, n):
        model = run.program.model(vec, n, run.model_dtype)
        launch, calls = model.launch, [0]

        def frozen():
            gen = model.gen
            counts = launch()
            if calls[0] == FROZEN_STEP:
                model.gen = gen
            calls[0] += 1
            return counts
        model.launch = frozen
        return model
    kwargs["make_model"] = make
    return lambda: None


def plant_clamped(kwargs: dict):
    """Out-of-range lanes are clamped into the end bins, not dropped."""
    from enoki_tpu_torch import ops
    return _wrap_bins(kwargs,
                      lambda b, model: ops.clamp(b, 0, model.bins - 1))


def plant_block(kwargs: dict):
    """The first 1/64 block of lanes is left out of the histogram."""
    from enoki_tpu_torch import ops

    def leave_out(b, model):
        if model.lazy:
            from enoki_tpu_torch import trace
            lane = trace.LazyArray.arange(model.n, torch.int32, b.device)
        else:
            lane = torch.arange(model.n, dtype=torch.int32, device=b.device)
        return ops.select(lane < model.n // 64, -1, b)
    return _wrap_bins(kwargs, leave_out)


FAULTS = {"frozen": plant_frozen, "clamped": plant_clamped,
          "block": plant_block}
