"""Whether what the timed path produced is correct: once the window has
closed, the kind's ``judge`` (``benchmark/kinds/<kind>.py``) has the
plain reference work the same inputs out again and returns each number
compared; ``verdict`` holds each to its limit
(``benchmark/limits/<cell>.json``). The measures the kinds share are
here.
"""

from __future__ import annotations

import torch

IMAGE_TOL = 1e-3
LEAF_FLOOR = 1e-3


def image_gap(img, want) -> float:
    """The share of samples off by more than IMAGE_TOL of max(1,
    |want|)."""
    off = (img.float() - want).abs() > IMAGE_TOL * torch.clamp_min(
        want.abs(), 1.0)
    return float(off.float().mean())


def median(x) -> float:
    """The median, the mean of the two middle values of an even count."""
    return float(torch.quantile(x.double().cpu(), 0.5))


def leaf_gaps(got, want, keep):
    """The worst gap of the kept entries: |got - want| over the larger of
    |want| and the median kept |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    mag = want.abs()[keep]
    scale = torch.clamp_min(mag, median(mag))
    return float(((got[keep] - want[keep]).abs() / scale).max())


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number that is not finite fails, and so does a run that
    leaves out a number its limits name."""
    checks, ok = {}, set(numbers) == set(limits)
    for name, value in numbers.items():
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, checks
