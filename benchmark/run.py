"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The
cell's inputs come from ``--seed``; the window measures for ``--seconds``;
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced window. Every run judges what the timed
path produced against the plain reference and prints each number
compared beside its limit, on standard error and under ``checks`` in the
result. Exits with a code other than 0, and prints no result, where
there is no card, or fewer than the cell asks for, or anything fails.

The program's build caches live at fixed paths inside the checkout
(``.bench_cache/``), so that only the first run of a checkout builds.
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
CACHE = ROOT / ".bench_cache"
os.environ["ENOKI_TPU_COMPILE_CACHE"] = str(CACHE / "build")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_import = time.time()
    import torch

    from benchmark import harness
    t_import = time.time() - t_import

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(spec, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
              f"found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, info = harness.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), torch.device("cuda", 0),
                                    T_START)
    found = harness.forbidden_modules()
    if found:
        print("the process loaded " + ", ".join(found), file=sys.stderr)
        return 3
    info["import_s"] = t_import
    print(json.dumps({"info": info}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
