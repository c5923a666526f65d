"""The readings that the limits of ``benchmark/limits/`` are set from,
at a cell's own size, on the card: sound runs of the program, the
lower-precision control in its place, and the faults planted under the
timed path. Each run is the benchmark's own (set-up, the checked steps,
a short window at the cell's load, the judge), in one process:

    python3 benchmark/controls.py --workload <cell> --mode sound \
        --seeds 1 2 3 ... [--seconds 0.3] [--out chiprun_out/x.jsonl]

Modes:
* ``sound``: the program as the configuration states it;
* ``control``: the step a later change would be tempted to take, one
  precision down, as the configuration's ``lower_precision`` entry
  states it: ``{"path": "program", "dtype": ...}`` where the program has
  such a path of its own (the sphere's bf16 march), ``{"path":
  "reference", "dtype": ...}`` for the plain reference in the program's
  place, marching in that type (the composed scene);
* a fault that the cell's kind can have, from the ``FAULTS`` of
  ``kinds/<kind>.py``: for a fit ``unchanged`` (Adam's step returns the
  parameters as they were), ``half`` (the loss takes the mean over half
  of the rows and leaves the rest out) and ``altered`` (one row of every
  image is altered where it is produced); for frames ``altered``.

Prints one JSON line a run: the mode, the seed and each number compared
beside its limit.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("ENOKI_TPU_COMPILE_CACHE",
                      str(ROOT / ".bench_cache" / "build"))
sys.path.insert(0, str(ROOT))


def plant(mode: str, run_kwargs: dict, cell):
    """Plant ``mode`` for one run; returns the function that undoes it."""
    from benchmark import loops
    from benchmark.reference import common
    if mode == "sound":
        return lambda: None
    if mode == "control":
        cfg = json.loads(cell.config_file.read_text())
        lower = cfg["lower_precision"]
        if lower["path"] == "program":
            run_kwargs["model_dtype"] = lower["dtype"]
        else:
            import torch

            def make(run, vec, n):
                return common.Module(run.reference, vec.to(run.device), n,
                                     run.cfg["n_steps"], run.cfg["extent"],
                                     getattr(torch, lower["dtype"]))
            run_kwargs["make_model"] = make
        return lambda: None
    faults = loops.load_kind(cell.kind).FAULTS
    if mode not in faults:
        raise ValueError(f"the cell {cell.name} has no fault {mode!r}; "
                         f"it has {sorted(faults)}")
    return faults[mode](run_kwargs)


def one(cell, seed, mode, seconds, device, sizes=None):
    """The numbers one run of ``mode`` compares, beside their limits."""
    from benchmark import harness
    kwargs = {}
    undo = plant(mode, kwargs, cell)
    try:
        result, info = harness.run_cell(cell, seed, seconds, False, device,
                                        time.time(), sizes=sizes, **kwargs)
    finally:
        undo()
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", nargs="+", required=True,
                    help="sound, control, or a fault of the cell's kind")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for mode in args.mode:
        for seed in args.seeds:
            t = time.time()
            try:
                result, _ = one(cell, seed, mode, args.seconds, device)
                line = {"cell": args.workload, "mode": mode, "seed": seed,
                        "correct": result["correct"],
                        "checks": result["checks"],
                        "seconds": time.time() - t}
            except Exception as e:  # a control that crashes has failed
                line = {"cell": args.workload, "mode": mode, "seed": seed,
                        "correct": False, "error": repr(e)[:300],
                        "seconds": time.time() - t}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
