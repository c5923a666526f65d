"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives, and the least time of a piece of
work on one of them.

NVIDIA H100 SXM (the 80 GB HBM3 part), NVIDIA's data sheet at its 700 W
limit: 3.35 TB/s of device memory and 67 TFLOP/s of FP32 outside the
tensor cores, the rate of the scalar adds, multiplies, compares and
roots of a sphere trace (the tensor cores run none of them). A card set
below 700 W runs slower: a share is stated against these peaks, with the
card's power limit beside it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "fp32_per_s": 67e12},
}


def least_seconds(kind: str, nbytes: float, flops: float):
    """(seconds, "bytes" or "operations"): the larger of the two bounds,
    or None for a card the table lacks."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    t = {"bytes": nbytes / peak["bytes_per_s"],
         "operations": flops / peak["fp32_per_s"]}
    by = max(t, key=t.get)
    return t[by], by
