"""The ``fit`` kind: an inverse-rendering fit. A step is zero_grad, the
render of ``samples_side``^2 samples a pixel of an ``out_n``^2 image,
the mean squared error of its box filter against the target, backward,
Adam's step, and the loss read on the host. Every ``fit_steps`` steps
the parameters go back to a start and the optimiser's state is dropped:
the run cycles through ``fits`` (start, target) pairs drawn from the
seed. The plain reference renders the targets at set-up.

A fit is judged as training is: the reference follows the run's checked
steps from the same start, target and hyperparameters, and the run is
held to it on

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as Adam holds it, by its worst
  entry: the gap over the larger of the reference's entry and the median
  entry's size;
* ``change_gap``: the change of the parameters after the checked steps,
  by its worst entry, read the same way;
* ``image_gap``: the share of the first step's samples that differ from
  the reference's by more than a thousandth of max(1, |reference|).

An entry of the scene vector is a leaf of its own (each is one scene
scalar, of its own scale). Entries whose reference gradient is under a
thousandth of the median entry's are left out of the two gaps of
entries: Adam moves them by round-off alone (the sphere's 7 unused
slots read exactly 0).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import judge as J
from benchmark.loops import (Steps, draw_vectors, mark, pick_steps,
                             plant_altered, span_factory)
from benchmark.reference import common as ref_common

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "image_gap")


def box_filter(img, ss: int):
    """The mean of each ``ss`` x ``ss`` block of samples: a view and a
    mean, whose backward writes the samples' cotangent in one pass (the
    CUDA backward of ``avg_pool2d`` takes 1.1 ms at 8192^2 on an H100,
    more than the render's own backward)."""
    n = img.shape[-1] // ss
    return img.view(n, ss, n, ss).mean(dim=(1, 3))


class Adam:
    """Adam over one parameter tensor, as ``torch.optim.Adam`` computes
    it by default (bias corrections on the host, seven launches a step).
    Not the library's optimiser: creating a ``torch.optim`` optimiser
    imports ``torch._dynamo``, which costs every run seconds of set-up
    that serve no step."""

    def __init__(self, param, lr: float, betas, eps: float):
        self.param, self.lr, self.eps = param, lr, eps
        self.b1, self.b2 = betas
        self.reset()

    def reset(self):
        self.k = 0
        self.exp_avg = torch.zeros_like(self.param)
        self.exp_avg_sq = torch.zeros_like(self.param)

    def zero_grad(self):
        self.param.grad = None

    @torch.no_grad()
    def step(self):
        g = self.param.grad
        self.k += 1
        c1 = 1.0 - self.b1 ** self.k
        c2 = 1.0 - self.b2 ** self.k
        self.exp_avg.lerp_(g, 1.0 - self.b1)
        self.exp_avg_sq.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        denom = (self.exp_avg_sq.sqrt() / c2 ** 0.5).add_(self.eps)
        self.param.addcdiv_(self.exp_avg, denom, value=-self.lr / c1)


class Loop:
    """The fit over the run's module (the program's, or a control in its
    place)."""

    def __init__(self, run):
        mix, cfg, dev = run.mix, run.cfg, run.device
        self.run, self.mix = run, mix
        self.ss, self.out_n = mix["samples_side"], mix["out_n"]
        self.n = self.ss * self.out_n
        rng = np.random.default_rng(run.seed)
        f = mix["fits"]
        self.starts = torch.from_numpy(draw_vectors(cfg, rng, f)).to(dev)
        self.ends = torch.from_numpy(draw_vectors(cfg, rng, f)).to(dev)
        t = time.perf_counter()
        self.targets = [ref_common.render(run.reference, v, self.out_n,
                                          cfg["n_steps"], cfg["extent"])
                        for v in self.ends]
        run.sync()
        self.reference_s = time.perf_counter() - t
        self.model = run.make_model(self.starts[0].clone(), self.n)
        self.params = self.model.params
        self.opt = Adam(self.params, mix["lr"], tuple(mix["betas"]),
                        mix["eps"])
        self.k = 0
        self.span = span_factory(False)
        self.traced_params = {}
        self.checked = None

    def step(self, steps: Steps, keep_image: bool = False):
        k, span = self.k, self.span
        t0 = time.perf_counter()
        j, pos = divmod(k, self.mix["fit_steps"])
        j %= self.mix["fits"]
        if pos == 0 and k > 0:
            with torch.no_grad():
                self.params.copy_(self.starts[j])
            self.opt.reset()
        if k in self.traced_params:
            self.traced_params[k] = self.params.detach().clone()
        self.opt.zero_grad()
        with span("forward"):
            img = self.model()
        with span("loss"):
            if self.run.trace:
                img.register_hook(lambda _: mark("render_bwd"))
            loss = F.mse_loss(box_filter(img, self.ss), self.targets[j])
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            self.opt.step()
        with span("readback"):
            t_wait = time.perf_counter()
            value = loss.item()
        steps.marks.append((t0, t_wait, time.perf_counter()))
        self.k += 1
        return value, (img.detach() if keep_image else None)

    def setup(self):
        """The checked steps, through the window's own step: the losses,
        the first gradient as Adam holds it after one step, the change of
        the parameters after the last, and the first image."""
        steps = Steps()
        b1 = self.mix["betas"][0]
        p0 = self.params.detach().clone()
        losses, grad, img0 = [], None, None
        for i in range(self.mix["checked_steps"]):
            loss, img = self.step(steps, keep_image=(i == 0))
            losses.append(loss)
            if i == 0:
                img0 = img
                grad = self.opt.exp_avg / (1.0 - b1)
        change = (self.params.detach() - p0).clone()
        self.checked = {"losses": losses, "grad": grad, "change": change,
                        "image": img0, "start": p0,
                        "target": self.targets[0]}

    def trace_steps(self, first: int, count: int, seed: int):
        """Keep the parameters of ``pick_steps``' steps."""
        self.traced_params = {k: None for k in pick_steps(first, count,
                                                           seed)}

    def traced_work(self):
        """(step, work arguments) of the steps the traced run kept: the
        reference's march at their parameters; the forward writes the
        image and the root that the backward reads."""
        run, cfg = self.run, self.run.cfg
        out = []
        for k, vec in self.traced_params.items():
            if vec is not None:
                evals, adv, hits = ref_common.counts(
                    run.reference, vec, self.n, cfg["n_steps"],
                    cfg["extent"])
                out.append((k, dict(evals=evals, adv=adv, hits=hits,
                                    rays=self.n * self.n, residual=True)))
        return out

    def info(self, steps: Steps):
        rays = self.n * self.n
        return {"rays_per_step": rays,
                "rays_per_s": rays * len(steps.marks) / steps.window()}

    def close(self):
        pass

    def release(self):
        del self.model, self.params, self.opt


def judge(run, checked) -> dict:
    cfg, mix = run.cfg, run.mix
    n = mix["samples_side"] * mix["out_n"]
    losses, grad, change, img = ref_common.fit_steps(
        run.reference, checked["start"], checked["target"],
        mix["checked_steps"], mix["lr"], mix["betas"], mix["eps"], n,
        cfg["n_steps"], cfg["extent"], mix["samples_side"])
    mag = grad.abs().cpu()
    keep = mag >= J.LEAF_FLOOR * J.median(mag)
    gaps = [abs(a - b) / abs(b) for a, b in zip(checked["losses"], losses)]
    return {
        "loss_gap": max(gaps),
        "grad_gap": J.leaf_gaps(checked["grad"], grad, keep),
        "change_gap": J.leaf_gaps(checked["change"], change, keep),
        "image_gap": J.image_gap(checked["image"], img),
    }


def plant_unchanged(kwargs: dict):
    """Adam's step returns the parameters as they were."""
    step = Adam.step
    Adam.step = lambda self: None
    return lambda: setattr(Adam, "step", step)


def plant_half(kwargs: dict):
    """The loss takes the mean over half of the rows and leaves the rest
    out."""
    global F
    functional = F

    def mse_loss(a, b):
        h = a.shape[0] // 2
        return functional.mse_loss(a[:h], b[:h])
    F = types.SimpleNamespace(mse_loss=mse_loss)

    def undo():
        global F
        F = functional
    return undo


FAULTS = {"unchanged": plant_unchanged, "half": plant_half,
          "altered": plant_altered}
