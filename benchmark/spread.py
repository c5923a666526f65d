"""Run cells of the benchmark several times, each run a process of its
own as the check runs them, and print each run's result and, per cell
and metric, the median and the spread (the distance between the first
and third quartiles over the median, ``statistics.quantiles``):

    python3 benchmark/spread.py --workload <cell> [<cell> ...] \
        --seeds 1 2 3 4 5 6 [--sets 2] [--seconds 10] [--trace 0] \
        [--out chiprun_out/spread.jsonl]

With ``--sets 2`` the same seeds run twice, one set after the other; the
summary gives each set's spread and the wider of the two.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.stats import spread  # noqa: E402


def one(cell: str, seed: int, seconds: float, trace: int):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return {"cell": cell, "seed": seed, "rc": proc.returncode,
                "stderr": proc.stderr[-2000:]}
    result = json.loads(lines[-1])
    info = json.loads(lines[-2])["info"] if len(lines) > 1 else {}
    return {"cell": cell, "seed": seed, "rc": 0,
            "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "checks": {k: v["value"] for k, v in result["checks"].items()},
            "device": result["device"],
            "breakdown": result.get("breakdown"),
            "info": {k: info.get(k) for k in ("steps", "rays_per_s",
                                               "judge_s", "import_s",
                                               "setup_marks")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    for cell in args.workload:
        sets = []
        for s in range(args.sets):
            runs = []
            for seed in args.seeds:
                r = one(cell, seed, args.seconds, args.trace)
                r["set"] = s
                print(json.dumps(r), flush=True)
                if out:
                    out.write(json.dumps(r) + "\n")
                    out.flush()
                runs.append(r)
            sets.append([r for r in runs if r["rc"] == 0])
        names = sorted({k for runs in sets for r in runs
                        for k in r["metrics"]})
        for name in names:
            per_set = [[r["metrics"][name] for r in runs] for runs in sets]
            spreads = [spread(v) for v in per_set if len(v) >= 2]
            print(json.dumps({
                "cell": cell, "metric": name,
                "medians": [statistics.median(v) for v in per_set if v],
                "spreads": spreads,
                "widest": max(spreads) if spreads else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
