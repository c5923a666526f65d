#!/usr/bin/env python3
"""Design variants of two kernels of the PyTorch/CUDA port, timed in turns
on one CUDA card, and the same kernels of another checkout beside them.

  python kernel_variants.py [--ab OTHER_ROOT]

generic_bwd (csrc/generic_render.cuh) on chip_smoke.py's composed scene at
1024^2, g = 1 / N^2, and hist (csrc/hist.cu) at 16M samples, 64 bins, on
binned normal samples, counting and weighted. A variant is the shipped
source with one constant or one piece of text replaced, built by nvcc
through enoki_tpu_torch._build; each is checked against its plain
version (generic_bwd within rtol 2e-4 / atol 2e-4 * scale, hist counts
exactly) before it is timed, and the variants are timed twice, in one
order and then in the other. The variants:

  generic_bwd  the emitted cotangent in float (nvcc may contract a*b+c;
               shipped) or in Real (each operation rounded on its own),
               with 8, 4 (shipped) or 2 pixels a thread
  hist         a row per thread with the next chunks' loads in flight
               while the current ones are added (shipped: 8 chunks when
               counting, 4 weighted), the same with 4 when counting, not
               pipelined, and a row per warp for every bins (the earlier
               design)

--ab OTHER_ROOT times generic_bwd and hist of the enoki_tpu_torch under
OTHER_ROOT (a checkout of another commit, with its own chip_smoke.py) in
child processes, interleaved: other, this, this, other.

Needs a CUDA card; prints one line per variant (the card's name and power
limit first), and its ptxas registers and spills.
"""

import argparse
import json
import os
import subprocess
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N, STEPS, HIST_N, BINS = 1024, 64, 1 << 24, 64


def hist_inputs(torch, dev):
    """Binned standard normal samples over [-4, 4) (-1 and BINS dropped)
    and standard normal weights, from a seed."""
    rng = np.random.default_rng(3)
    b = np.floor((rng.standard_normal(HIST_N) + 4.0) * (BINS / 8.0))
    idx = np.clip(b, -1, BINS).astype(np.int32)
    w = rng.standard_normal(HIST_N).astype(np.float32)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)


def time_root(root):
    """generic_bwd and hist of the enoki_tpu_torch under ``root``, through
    that package's wrappers and that checkout's chip_smoke.py (one JSON
    line)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as C
    from enoki_tpu_torch.ops import hist_kernels as H
    from enoki_tpu_torch.render import generic as G
    dev = torch.device("cuda")
    kern = C.generic_scenes()["composed"][0].kernels
    p = torch.tensor(C.GENERIC_PARAMS, dtype=torch.float32, device=dev)
    _, ts = G.generic_fwd(kern, p, N, STEPS)
    g = torch.full((N, N), 1.0 / (N * N), device=dev)
    idx, w = hist_inputs(torch, dev)
    timer = C.DeviceTimer(torch)
    print(json.dumps({
        "root": root,
        "generic_bwd_ms": timer(lambda: G.generic_bwd(kern, p, g, ts, N),
                                200, hold_ms=400.0),
        "hist_ms": timer(lambda: H.hist(idx, BINS), 200),
        "hist_weighted_ms": timer(lambda: H.hist(idx, BINS, w), 200)}))


def substitute(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"variant text not found: {old!r}")
        text = text.replace(old, new)
    return text


CUT_FLOAT = ("  float dp[kNP];\n"
             "  user_cotangent<float>(px, py, tsv, g, pv, dp);\n"
             "#pragma unroll\n"
             "  for (int k = 0; k < kNP; ++k) acc[k] += dp[k];")
REAL = ("  Real dp[kNP], pr[kNP];\n"
        "  for (int k = 0; k < kNP; ++k) pr[k] = Real(pv[k]);\n"
        "  user_cotangent<Real>(Real(px), Real(py), Real(tsv), Real(g), pr,"
        " dp);\n"
        "#pragma unroll\n"
        "  for (int k = 0; k < kNP; ++k) acc[k] += dp[k].v;")
PIXELS = "constexpr int kBwdPixels = 4;"
GENERIC_VARIANTS = {
    "float, 4 px (shipped)": [],
    "float, 8 px": [(PIXELS, "constexpr int kBwdPixels = 8;")],
    "float, 2 px": [(PIXELS, "constexpr int kBwdPixels = 2;")],
    "Real, 4 px": [(CUT_FLOAT, REAL)],
    "Real, 8 px": [(CUT_FLOAT, REAL),
                   (PIXELS, "constexpr int kBwdPixels = 8;")],
}
UNPIPELINED = [
    ("  load(0, key, val);\n", ""),
    ("    // past the thread's last group every chunk is past the block's "
     "end\n    load(k0 + kRowUnroll, next_key, next_val);\n",
     "    load(k0, key, val);\n"),
    ("      key[u] = next_key[u];\n      val[u] = next_val[u];\n", ""),
]
HIST_VARIANTS = {
    "row per thread, pipelined, 8 / 4 chunks (shipped)": [],
    "row per thread, pipelined, 4 / 4 chunks": [
        ("kRowUnrollCount = 8", "kRowUnrollCount = 4")],
    "row per thread, not pipelined, 8 / 4 chunks": UNPIPELINED,
    "row per warp for every bins (the earlier design)": [
        ("constexpr int kSmallBins = 96;", "constexpr int kSmallBins = 0;")],
}


def run_variants(torch, dev, timer, C):
    from concurrent.futures import ThreadPoolExecutor

    from enoki_tpu_torch import _build
    from enoki_tpu_torch.ops import hist_kernels as H
    from enoki_tpu_torch.render import generic as G

    kern = C.generic_scenes()["composed"][0].kernels
    skeleton = (_build.CSRC_DIR / "generic_render.cuh").read_text()
    hist_src = (_build.CSRC_DIR / "hist.cu").read_text()

    def generic_text(pairs):
        # the skeleton inlined into the scene's source, with the variant
        body = substitute(skeleton, pairs).replace("#pragma once", "")
        return kern.traced.source.replace('#include "generic_render.cuh"',
                                          body)

    with ThreadPoolExecutor(len(GENERIC_VARIANTS) + len(HIST_VARIANTS)) as ex:
        g_texts = {k: generic_text(v) for k, v in GENERIC_VARIANTS.items()}
        h_texts = {k: substitute(hist_src, v)
                   for k, v in HIST_VARIANTS.items()}
        g_libs = {k: ex.submit(_build.load_generated, "generic_render", t)
                  for k, t in g_texts.items()}
        h_libs = {k: ex.submit(_build.load_generated, "hist", t)
                  for k, t in h_texts.items()}
        g_libs = {k: f.result() for k, f in g_libs.items()}
        h_libs = {k: f.result() for k, f in h_libs.items()}

    p = torch.tensor(C.GENERIC_PARAMS, dtype=torch.float32, device=dev)
    _, ts = G.generic_fwd(kern, p, N, STEPS)
    g = torch.full((N, N), 1.0 / (N * N), device=dev)
    g_rand = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(dev)
    ref = G.generic_bwd_plain(kern.sdf_fn, kern.ray_fn, p, g_rand, ts, N)
    scale = max(1.0, ref.abs().max().item())
    idx, w = hist_inputs(torch, dev)
    ref_count = H.hist_plain(idx, BINS)

    def hist_call(lib, weights):
        # the hist wrapper's two launches, on a variant's library
        rows = lib.hist_num_blocks(HIST_N, BINS)
        partial = torch.empty((rows, BINS), device=dev)
        out = torch.empty(BINS, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        assert lib.hist_partial_launch(
            idx.data_ptr(), None if weights is None else weights.data_ptr(),
            HIST_N, BINS, partial.data_ptr(), stream) == 0
        assert lib.hist_reduce_launch(partial.data_ptr(), rows, BINS,
                                      out.data_ptr(), stream) == 0
        return out

    times = {}
    for order in (1, -1):
        for name, lib in list(g_libs.items())[::order]:
            k = types.SimpleNamespace(lib=lib, n_params=kern.n_params)
            dp = G.generic_bwd(k, p, g_rand, ts, N)
            ok = bool(((dp - ref).abs()
                       <= 2e-4 * scale + 2e-4 * ref.abs()).all().item())
            if not ok:
                raise RuntimeError(f"generic_bwd {name}: off its gate")
            times.setdefault(("generic_bwd", name), []).append(timer(
                lambda: G.generic_bwd(k, p, g, ts, N), 200, hold_ms=400.0))
        for name, lib in list(h_libs.items())[::order]:
            if not torch.equal(hist_call(lib, None), ref_count):
                raise RuntimeError(f"hist {name}: counts differ")
            times.setdefault(("hist counting", name), []).append(
                timer(lambda: hist_call(lib, None), 200))
            times.setdefault(("hist weighted", name), []).append(
                timer(lambda: hist_call(lib, w), 200))
    hits = int((ts >= 0).sum().item())
    groups = int((ts >= 0).reshape(-1, 32).any(1).sum().item())
    print(f"generic_bwd: {hits} hit pixels of {N * N}; groups of 32 "
          f"neighbouring pixels that hold a hit {groups}, where the hits "
          f"would fill {hits / 32:.1f}")
    for (kernel, name), t in times.items():
        print(f"{kernel} {name}: {' / '.join(f'{x:.5f}' for x in t)} ms")
    for name, text in g_texts.items():
        print(f"ptxas generic_bwd {name}: " + C.resources_text(
            _build.build_generated("generic_render", text),
            ("generic_bwd_partial_kernel",)))
    for name, text in h_texts.items():
        print(f"ptxas hist {name}: " + C.resources_text(
            _build.build_generated("hist", text),
            ("hist_rows_kernelILb0ELb0E", "hist_rows_kernelILb1ELb1E",
             "hist_partial_kernelILb0E", "hist_partial_kernelILb1E")))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT",
                    help="also time the kernels of the checkout there")
    ap.add_argument("--time-root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_root:
        return time_root(args.time_root)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as C
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    print(C.nvidia_smi("name,power.limit"))
    run_variants(torch, torch.device("cuda"), C.DeviceTimer(torch), C)
    if args.ab:
        for root in (args.ab, HERE, HERE, args.ab):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-root",
                 os.path.abspath(root)], cwd=root, check=True,
                capture_output=True, text=True)
            print(out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    main()
