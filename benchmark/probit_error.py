"""The readings that the ``histogram`` configuration's ``band.delta`` is
set from: the largest error of the program's probit, as it bins it,
against the plain reference's float64 probit, over every in-range lane
of a step, on each path and in each precision:

    python3 benchmark/probit_error.py --seeds 1 2 3 [--lanes 16777216] \
        [--dtypes float32 bfloat16] [--out readings.jsonl]

Runs on the card where there is one, else on the CPU (the plain
routes). For each path, dtype and seed it makes the configuration's
model from the seed's generator, draws once, and compares ``(g - lo) *
bins / (hi - lo)`` computed by the program (``Histogram.probit``, then
``bin_index``'s scale) with the reference's ``scaled(probit(u))``, over
the lanes whose float64 value lies within one bin of [lo, hi). Prints
one JSON line each: the largest error in probit units and the sample
where it lies, the median error, and the share of lanes whose error
passes ``band.delta``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("ENOKI_TPU_COMPILE_CACHE",
                      str(ROOT / ".bench_cache" / "build"))
sys.path.insert(0, str(ROOT))


def reading(program, ref, cfg, n, dtype, seed):
    """{"max_error", "at_probit", "median_error", "over_delta"}: the
    largest |error| in probit units, the float64 probit there, the
    median error, and the share of the lanes whose error passes the
    configuration's ``band.delta``."""
    import torch

    from benchmark.kinds import draws
    model = program.model(torch.tensor(cfg["base"]), n, dtype)
    lo, hi = cfg["range"]
    bins = cfg["bins"]
    state = model.state()
    u, _ = model.gen.next_float32()
    t = (model.probit(u) - lo) * (bins / (hi - lo))
    if model.lazy:
        t = t.torch()
    inc = ref.seed(n, draws.initstate(seed), state.device)[1]
    bits, _ = ref.step(state, inc)
    want = ref.scaled(ref.probit(ref.uniform(bits)), lo, hi, bins)
    inside = (want >= -1) & (want <= bins + 1)
    scale = bins / (hi - lo)
    err = (t.double() - want).abs()[inside] / scale
    i = int(err.argmax())
    return {"max_error": float(err[i]),
            "at_probit": float(want[inside][i]) / scale + lo,
            "median_error": float(err.median()),
            "over_delta": float((err > cfg["band"]["delta"]).double()
                                .mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness
    from benchmark.kinds import draws
    from benchmark.reference import histogram as ref
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "histogram.json").read_text())
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    n = args.lanes or (cfg["lanes"] if device.type == "cuda" else 1 << 16)
    mod = harness.load_module(ROOT / "benchmark" / "configs" /
                              "histogram.py", "probit_error_program")
    out = open(args.out, "a") if args.out else None
    for path in ("eager", "lazy"):
        for dtype in args.dtypes:
            for seed in args.seeds:
                program = mod.Program(cfg, device)
                program.path, program.initstate = path, draws.initstate(seed)
                line = {"path": path, "dtype": dtype, "seed": seed,
                        "lanes": n, "device": str(device),
                        **reading(program, ref, cfg, n, dtype, seed)}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
