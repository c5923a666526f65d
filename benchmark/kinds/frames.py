"""The ``frames`` kind: a viewer's frames. A step is, without autograd,
the render of the next of ``sequence`` scene vectors held on the card,
and one synchronise.

Frames are judged one by one: each frame kept from the window, a sample
drawn from the seed, against the reference's image of its vector, by
``image_gap`` (the largest over the frames).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark import judge as J
from benchmark.loops import (Steps, draw_vectors, pick_steps, plant_altered,
                             span_factory)
from benchmark.reference import common as ref_common

NUMBERS = ("image_gap",)


class Loop:
    """The frames over a seeded sequence of scene vectors."""

    reference_s = 0.0

    def __init__(self, run):
        mix, cfg, dev = run.mix, run.cfg, run.device
        self.run, self.mix = run, mix
        self.n = mix["samples_side"] * mix["out_n"]
        rng = np.random.default_rng(run.seed)
        self.seq = torch.from_numpy(
            draw_vectors(cfg, rng, mix["sequence"])).to(dev)
        self.model = run.make_model(self.seq[0].clone(), self.n)
        self.params = self.model.params
        self.k = 0
        self.span = span_factory(False)
        self.sample = random.Random(run.seed)
        self.kept = []       # (frame, image) drawn from the window's frames
        self.seen = 0
        self.keep = False
        self.picks = []
        self.checked = None

    def step(self, steps: Steps):
        span = self.span
        t0 = time.perf_counter()
        i = self.k % self.mix["sequence"]
        with torch.no_grad():
            self.params.copy_(self.seq[i])
            with span("forward"):
                img = self.model()
        with span("readback"):
            t_wait = time.perf_counter()
            self.run.sync()
        steps.marks.append((t0, t_wait, time.perf_counter()))
        if self.keep:
            self._reservoir(i, img)
        self.k += 1

    def _reservoir(self, i, img):
        """Keep a uniform sample of ``checked_frames`` of the window's
        frames, drawn from the seed."""
        want = self.mix["checked_frames"]
        if self.seen < want:
            self.kept.append((i, img))
        else:
            r = self.sample.randrange(self.seen + 1)
            if r < want:
                self.kept[r] = (i, img)
        self.seen += 1

    def setup(self):
        steps = Steps()
        for _ in range(self.mix["warmup"]):
            self.step(steps)
        self.keep = True

    def trace_steps(self, first: int, count: int, seed: int):
        self.picks = pick_steps(first, count, seed)

    def traced_work(self):
        """(step, work arguments) of the picked steps that the window
        reached: the reference's march at their vectors; without autograd
        the forward has only the image to write."""
        run, cfg = self.run, self.run.cfg
        out = []
        for k in [k for k in self.picks if k < self.k]:
            vec = self.seq[k % self.mix["sequence"]]
            evals, adv, hits = ref_common.counts(
                run.reference, vec, self.n, cfg["n_steps"], cfg["extent"])
            out.append((k, dict(evals=evals, adv=adv, hits=hits,
                                rays=self.n * self.n, residual=False)))
        return out

    def info(self, steps: Steps):
        rays = self.n * self.n
        return {"rays_per_step": rays,
                "rays_per_s": rays * len(steps.marks) / steps.window()}

    def close(self):
        """The frames kept for the check, with their scene vectors."""
        self.checked = {"frames": [(self.seq[i].detach().clone(), img)
                                   for i, img in self.kept]}
        self.kept = []

    def release(self):
        del self.model, self.params


def judge(run, checked) -> dict:
    cfg, mix = run.cfg, run.mix
    n = mix["samples_side"] * mix["out_n"]
    if not checked["frames"]:
        raise RuntimeError("the window kept no frame to check")
    worst = 0.0
    for vec, img in checked["frames"]:
        want = ref_common.render(run.reference, vec, n, cfg["n_steps"],
                                 cfg["extent"])
        worst = max(worst, J.image_gap(img, want))
        del want
    return {"image_gap": worst}


FAULTS = {"altered": plant_altered}
