#!/usr/bin/env python3
"""Design variants of the kernels of the PyTorch/CUDA port, timed in
turns on one CUDA card, and some of them of another checkout beside them.

  python kernel_variants.py [--sdf-only | --dense-only | --bwd-only |
                             --sphere-only | --split-only] [--ab OTHER_ROOT]

The SDF backward pair (sdf_bwd in csrc/sdf_render.cu, sdf_bwd_ad in
csrc/sdf_bwd_ad.cu, both on csrc/pixel_sum.cuh) on the reference sphere at
1024^2 with g = 1 / N^2; the sphere kernels (csrc/sphere_render.cu:
sphere_bwd on csrc/pixel_sum.cuh, sphere_fwd in f32 and bf16) on the
reference scene at 1024^2, g = 1 / N^2; the sdf_fwd family
(csrc/sdf_render.cu: sdf_fwd, sdf_fwd_bf16, sdf_fwd_relax and
sdf_fwd_relax_bf16 with relax 1.6 and unimodal,
sdf_fwd_split at split 16) on the reference sphere at 1024^2, 64 steps;
generic_fwd and generic_bwd (csrc/generic_render.cuh) on chip_smoke.py's
composed scene at 1024^2, 64 steps (g = 1 / N^2 for the backward);
stochastic_round (csrc/stochastic_round.cu) at 16M elements of phase 18's
data, f16 and bf16; hist (csrc/hist.cu) at 16M samples, 64 bins, on
binned normal samples, counting and weighted. A variant is the shipped
source with one constant or one piece of text replaced, built by nvcc
through enoki_tpu_torch._build; each is checked against its plain
version (the backward pairs and sphere_bwd: within rtol 2e-4 / atol
2e-4 * scale at 1024^2 and 257^2, two runs bit-equal; the sdf_fwd family
and sphere_fwd: every output bit-equal; generic_fwd: ts
bit-equal, image within 1e-3; generic_bwd within rtol 2e-4 / atol 2e-4 *
scale; stochastic_round bit-equal; hist counts exactly) before it is
timed, and the variants are timed twice, in one order and then in the
other. The variants:

  sdf_bwd, sdf_bwd_ad
               256 threads x 4 pixels a thread (shipped), 128 x 2, 4 or 8,
               256 x 2 or 8, 512 x 2 or 4, 1024 x 1 or 4; registers
               capped for 6, 7 or 8 blocks an SM; and with the shipped
               geometry each step of the redesign reverted alone: the
               blocks' rows summed by reduce_rows_kernel in a second
               launch, single-float loads where float4 loads are taken,
               each pixel's row and column from its 64-bit flat index,
               rsqrtf with its subnormal scaling, a fence in every thread
               before the ticket; sdf_bwd_ad's per-pixel function in
               forward-mode duals (the earlier kernel's, on the
               skeleton); and, tried and dropped, a thread's pixels in
               straight-line code under a warp vote, the last block's
               rows loaded four at a time before they are added or
               staged through shared memory (1024 or 256 rows at a
               time), a resident grid striding over the image (128 or
               256 threads, float4 or single floats); then the probes,
               timed and not gated: g summed alone, the rows alone, the
               ticket without the last block's sum, no fence
  sphere_bwd   256 threads x 4 pixels of a row a thread (shipped), 256 x
               8, 128 x 8 or 128 x 4, each on the pixel-sum skeleton's
               g-only branch; and with the shipped geometry each step of
               the redesign reverted alone: the blocks' rows summed by
               reduce_rows_kernel in a second launch, single-float loads,
               each pixel's column from its 64-bit flat index, the row's
               terms computed for each pixel, the hit's division by the
               IEEE division (not __fdividef); the probes, timed and not
               gated: g summed alone (4 MiB), the hit test alone (no hit's
               terms)
  sphere_fwd   f32 and bf16 in one library: 128, 256 or 512 threads x 1,
               2, 4 or 8 pixels a thread (shipped: 256 x 4 in both, one
               16-byte store a thread in f32, one 8-byte store in bf16;
               8 bf16 pixels take one 16-byte store); and with the shipped
               geometry the row's terms for each pixel, the exact
               identities kept (the plain version's graph as written: a,
               b, the division, o + d t, the mask on the normal), one
               pixel a thread in blocks of 32 x 8 (the earlier layout),
               scalar stores; the probe, timed and not gated: the stores
               alone (every pixel ambient)
  sdf_fwd      a warp on an 8 x 4 tile of pixels in blocks of 16 x 8
               (shipped), of 8 x 8 or 32 x 8; 4 x 8 tiles in the same
               three; 32 x 1 in 32 x 8 (the earlier geometry); and with
               the shipped geometry each step of the march's redesign
               reverted alone: the z-carry hit test evaluated anew after
               the loop, its rsqrt with the subnormal scaling (no
               rsqrt_pos), the relaxed hit test on the loop's last
               distance (the first design), its root range-checked (no
               sqrt_pos), bf16 compares through f32, w * d taken twice;
               and, tried and dropped, unimodal a compile-time constant
               and the relaxed march's last step peeled off its loop; with
               each variant's busy-lane and block shares (the
               plain march's counts) and the SASS instructions of each
               kernel's march loop, laid out and issued an iteration
  sdf_fwd dense
               the z-carry march's dense route (sdf_fwd_dense) against
               its one-pixel route at 1024^2-16384^2: a thread's patch of
               2 rows x 4 columns of samples in blocks of 4 warps
               (shipped), 1 x 4, 2 x 2, 1 x 8, 1 x 2, 4 x 2, 1 x 16 or
               2 x 8 in 4 warps, 2 x 4 in 2 or 8 warps; each held
               bit-equal to the one-pixel route (f32 and bf16, with and
               without a start map, at 4096^2 and 4100^2; f32 at every
               size), with its warp iterations, busy ray slots, march
               loop's SASS and issue floor; then the bf16 march by both
               routes; sdf_kernels.DENSE_MIN_N comes from these times
  generic_fwd  a warp on an 8 x 4 tile of pixels in blocks of 16 x 8
               (shipped), of 8 x 8 or 32 x 8; 4 x 8 tiles in the same
               three; 16 x 2 in 16 x 4, 32 x 1 in 32 x 2 and in 32 x 8
               (the earlier geometry); and with the shipped geometry the
               hit test evaluated anew after the loop (the earlier
               march), the normal by a 3-partial dual (the earlier
               shade, its type defined here), every square root
               range-checked (no sqrt_pos_) or the scene traced with its
               exact identities recorded (x - 0, x * 1, ...); with the
               SASS instructions of each one's march loop, laid out and
               issued an iteration
  generic_bwd  the emitted cotangent in float (nvcc may contract a*b+c;
               shipped) or in Real (each operation rounded on its own),
               with 8, 4 (shipped) or 2 pixels a thread
  stochastic_round
               f16 with the span's reciprocal built from lo's exponent
               (shipped) or an IEEE division (the earlier route), each
               with 2 (shipped) or 4 Philox groups a thread
  split        the two-pass split march (pass 1 of sdf_fwd_split with
               its survivor list, sdf_tail over it) at 1024^2 split 16
               (chip_smoke.py's), 1024^2 split 8 and 2048^2 split 16
               (more survivors than the persistent grid has lanes): the
               tail's schedules (refill at any idle lane, below half the
               lanes, whole warps 32 survivors at a time; 2 or 4 march
               steps a vote), a thread a survivor of the list, the 64-bit
               index, the persistent grid halved; pass 1 with an atomic
               a warp instead of the block scan, and without the append;
               each split render bit-equal to the one-pass render, pass 1
               to plain; pass 1, the tail and the split forward timed
  scatter      the lazy trace's SCATTER_ADD into a target (the generated
               kernels of trace/codegen.py on csrc/trace_kernel.cuh) at
               16M lanes, the indices normal around the middle slot
               (phase 28's histogram scaled), uniform, or cyclic (lane i
               at slot i % size): float32 weights into 8-192 slots by
               routes 1 (a row a thread) and 2 (a copy a block), and by
               3 (a global atomic a lane) for normal indices; float32
               weights into 1024-24576 slots and float64 into 4096 and
               12288 by routes 2 and 3; int32 counts into 64 slots by
               each route and into 4096 and 24576 uniform ones by routes
               2 and 3; route 1 at 64 slots with 1, 4 or 16 lanes a
               thread at a time instead of 8, route 2 at 4096 with 1;
               each held to its reference before it is timed (counts
               equal to the plain interpreter's, weights within
               chip_smoke.weights_gate of the float64 sum, its reading
               printed); the shipped thresholds (codegen.ROW_SLOTS,
               BLOCK_BYTES) come from these times
  hist         a row per thread with the next chunks' loads in flight
               while the current ones are added (shipped: 8 chunks when
               counting, 4 weighted), the same with 4 when counting, not
               pipelined, and a row per warp for every bins (the earlier
               design)

--sdf-only times the sdf_fwd family's variants and its dense route's
alone, --dense-only the dense route's alone, --bwd-only the SDF
backward pair's, --sphere-only the sphere kernels', --split-only the
split march's, --scatter-only the trace's SCATTER_ADD routes;
--scatter-gate reads the weights gate of phase 28 (b)'s three timed
SCATTER_ADDs alone (one kernel each, by its shipped route). --ab
OTHER_ROOT
times the sdf_fwd family, sdf_fwd at 16384^2 by the checkout's own
route, sdf_tail, the split forward's device time (torch.profiler), the
chained fwd+bwd step with split 16 and without, the backward kernels
(sdf_bwd, sdf_bwd_ad, sphere_bwd, generic_bwd), sphere_fwd (f32 and bf16), generic_fwd and
stochastic_round (f16 and bf16) of the enoki_tpu_torch under OTHER_ROOT
(a checkout of another commit, with its own chip_smoke.py) in child
processes, interleaved: other, this, this, other, each with its kernels'
ptxas registers and spills; each child also hashes the SDF backward
pair's dp on chip_smoke.py's phase 2 / 11 cases, and the last line says
whether the two checkouts give the same bits.

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
SEED = 0x5EED5EED5EED


def hist_inputs(torch, dev):
    """Binned standard normal samples over [-4, 4) (-1 and BINS dropped)
    and standard normal weights, from a seed."""
    rng = np.random.default_rng(3)
    b = np.floor((rng.standard_normal(HIST_N) + 4.0) * (BINS / 8.0))
    idx = np.clip(b, -1, BINS).astype(np.int32)
    w = rng.standard_normal(HIST_N).astype(np.float32)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)


def round_inputs(torch, dev):
    """chip_smoke.py phase 18's data: normal samples over 2^+-17 with NaN,
    infinities, zeros, subnormals and f16's edges mixed in."""
    rng = np.random.default_rng(17)
    x = (rng.standard_normal(HIST_N) * np.exp(rng.uniform(-12, 12, HIST_N))
         ).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-41,
                        65504.0, 65519.9, 65520.0, 7e4, -65519.9, 6e-8,
                        5.9e-8, 1e-10, -1e-10, 3.4e38, -3.4e38], np.float32)
    x[::HIST_N // special.size][:special.size] = special
    return torch.from_numpy(x).to(dev)


def first_resources(C, lib_path, names):
    """ptxas's report of the first kernel of ``names`` the library has."""
    for name in names:
        if C.kernel_resources(lib_path, name) is not None:
            return C.resources_text(lib_path, (name,))
    return f"{names[0]} no ptxas report"


def time_root(root):
    """The sdf_fwd family (SDF_KERNELS), the backward kernels (sdf_bwd,
    sdf_bwd_ad, sphere_bwd, generic_bwd: g = 1 / N^2, the reference
    scenes), generic_fwd and stochastic_round of the enoki_tpu_torch under
    ``root``, through that package's wrappers and that checkout's
    chip_smoke.py (one JSON line)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as C
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.ops import rounding as RD
    from enoki_tpu_torch.render import (generic as G, sdf_kernels as K,
                                        sphere_kernels as S)
    dev = torch.device("cuda")
    kern = C.generic_scenes()["composed"][0].kernels
    p = torch.tensor(C.GENERIC_PARAMS, dtype=torch.float32, device=dev)
    p_sdf = torch.from_numpy(C.scene_vec(None)).to(dev)
    x = round_inputs(torch, dev)
    g = torch.full((N, N), 1.0 / (N * N), device=dev)
    ts = K.sdf_fwd(p_sdf, N, STEPS)[1]
    ts_generic = G.generic_fwd(kern, p, N, STEPS)[1]
    timer = C.DeviceTimer(torch)
    out = {"root": root}
    for name in SDF_KERNELS:
        out[f"{name}_ms"] = timer(sdf_call(torch, C, K, p_sdf, name), 200)
    # the forward at the benchmark's 16384^2, by the checkout's own route
    out["sdf_fwd_16384_ms"] = timer(
        lambda: K.sdf_fwd(p_sdf, 16384, STEPS), 20)
    out.update(split_times(torch, C, K, p_sdf, timer))
    for name, fn in (
            ("sdf_bwd_ms", lambda: K.sdf_bwd(p_sdf, g, ts, N)),
            ("sdf_bwd_ad_ms", lambda: K.sdf_bwd(p_sdf, g, ts, N, 1.2, "ad")),
            ("sphere_bwd_ms", lambda: S.sphere_bwd(p_sdf, g, N)),
            ("generic_bwd_ms",
             lambda: G.generic_bwd(kern, p, g, ts_generic, N))):
        out[name] = timer(fn, 200)
    for name, dtype in (("sphere_fwd_ms", torch.float32),
                        ("sphere_fwd_bf16_ms", torch.bfloat16)):
        out[name] = timer(lambda dtype=dtype: S.sphere_fwd(p_sdf, N, 1.2,
                                                           dtype), 200)
    out.update(bwd_bits(torch, C, K, dev))
    for name, fn in (
            ("generic_fwd_ms", lambda: G.generic_fwd(kern, p, N, STEPS)),
            ("stochastic_round_f16_ms",
             lambda: RD.stochastic_round_cuda(x, SEED, torch.float16)),
            ("stochastic_round_bf16_ms",
             lambda: RD.stochastic_round_cuda(x, SEED))):
        out[name] = timer(fn, 200, hold_ms=400.0)
    out["ptxas"] = "; ".join([
        C.resources_text(_build.build("sdf_render"),
                         [kernel for _, kernel in SDF_KERNELS.values()]),
        first_resources(C, _build.build("sdf_render"),
                        ("AnalyticPixel", "sdf_bwd_partial_kernel")),
        first_resources(C, _build.build("sdf_bwd_ad"),
                        ("ReversePixel", "sdf_bwd_ad_partial_kernel")),
        first_resources(C, _build.build("sphere_render"),
                        ("SpherePixel", "sphere_bwd_partial_kernel")),
        C.resources_text(_build.build("sphere_render"), (
            "sphere_fwd_kernelIf", "sphere_fwd_kernelI13__nv_bf")),
        first_resources(C, _build.build_generated(
            "generic_render", kern.traced.source),
            ("generic_fwd_kernelILb0E", "generic_fwd_kernel")),
        C.resources_text(_build.build("stochastic_round"), (
            "stochastic_round_kernelILb1ELb1E",
            "stochastic_round_kernelILb0ELb1E"))])
    print(json.dumps(out))


def split_times(torch, C, K, p, timer):
    """sdf_tail's device time, the split forward's (split 16: the kernels
    of pass 1, of the compaction where there is one, and of the tail, from
    torch.profiler), and the chained fwd+bwd step with split 16 and
    without, through ``K`` (a checkout whose split march compacts by
    torch.nonzero, or by the list on the card)."""
    out = {}
    if hasattr(K, "sdf_fwd_split_list"):
        img, ts, _, pairs, counters = K.sdf_fwd_split_list(p, N, 16)
        fresh = C.fresh_counters(torch, p.device, 1000,
                                 int(counters[0].item()))
        out["sdf_tail_ms"] = timer(lambda: K.sdf_tail(
            p, pairs, fresh(), img, ts, N, STEPS, 16), 200)
    else:
        img, ts, cont = K.sdf_fwd_split(p, N, 16)
        idx = K.survivors(cont)
        out["sdf_tail_ms"] = timer(lambda: K.sdf_tail(
            p, idx, cont, img, ts, N, STEPS, 16), 200)
    by_kernel = C.device_ms_by_kernel(
        torch, lambda p0, p_, k: (K.sdf_split(p0, N, STEPS, 1.2, 16), p0)[1],
        p, 50)
    out["split_fwd_device_ms"] = sum(by_kernel.values())

    def step(split):
        def run(p0, p_, k):
            p_ = p_.detach().requires_grad_(True)
            loss = K.render_sdf_cuda(p_, N, STEPS, 1.2, 128, coarse=0,
                                     split=split).mean()
            (g,) = torch.autograd.grad(loss, p_)
            return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k
        return run
    for split in (16, 0, 0, 16):
        out.setdefault(f"step_split{split}_ms", []).append(
            round(C.chain_ms(torch, step(split), p, 100, 5)[0], 5))
    return out


def bwd_bits(torch, C, K, dev):
    """A digest of the SDF backward pair's dp bits on chip_smoke.py's
    phase 2 / 11 cases (its BWD_SIZES, SEEDS, the mixed and the all-miss
    scene, a seeded g and 1/n^2), by kernel: two checkouts whose kernels
    sum in the same order give the same digests."""
    import hashlib
    digests = {"sdf_bwd": hashlib.sha256(), "sdf_bwd_ad": hashlib.sha256()}
    for n in C.BWD_SIZES:
        gs = (torch.from_numpy(np.random.default_rng(7).standard_normal(
            (n, n)).astype(np.float32)).to(dev),
              torch.full((n, n), 1.0 / (n * n), device=dev))
        for seed in C.SEEDS:
            for shift in (0.0, 10.0):
                p = torch.from_numpy(C.scene_vec(seed)).to(dev)
                p[0] += shift
                ts = K.sdf_fwd(p, n, STEPS, 1.2)[1]
                for g in gs:
                    for name, kernel in (("sdf_bwd", "analytic"),
                                         ("sdf_bwd_ad", "ad")):
                        dp = K.sdf_bwd(p, g, ts, n, 1.2, kernel)
                        digests[name].update(dp.cpu().numpy().tobytes())
    return {f"{name}_bits": d.hexdigest()[:16] for name, d in digests.items()}


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
GEOMETRY = "constexpr int kWarpCols = {}, kBlockCols = {}, kBlockRows = {};"
SHIPPED_GEOMETRY = (8, 16, 8)


def fwd_pairs(dims, pairs):
    """A generic_fwd variant's substitutions: its geometry (warp columns,
    block columns and rows) and ``pairs``."""
    return [(GEOMETRY.format(*SHIPPED_GEOMETRY),
             GEOMETRY.format(*dims))] + pairs


HIT_TEST = "  *hit = d.v < m.eps;\n  return t;"
NUM_INCLUDE = '#include "generic_num.cuh"\n'
# Dual<S, N>, a value of scalar type S with N partial derivatives, as
# generic_num.cuh defined it before the forward's shade ran user_shade
DUAL_TYPE = """
namespace gen {

template <class S, int N>
struct Dual {
  S v;
  S d[N];
  Dual() = default;
  // a constant: every partial zero
  GEN_HD explicit Dual(float c) : v(c) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = S(0.0f);
  }
};

// the k-th independent variable at value x
template <class S, int N>
GEN_HD Dual<S, N> variable(S x, int k) {
  Dual<S, N> r;
  r.v = x;
#pragma unroll
  for (int j = 0; j < N; ++j) r.d[j] = S(j == k ? 1.0f : 0.0f);
  return r;
}

template <class S, int N>
GEN_HD float primal(const Dual<S, N>& a) {
  return primal(a.v);
}

template <class S, int N>
GEN_HD Dual<S, N> operator+(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <class S, int N>
GEN_HD Dual<S, N> operator-(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <class S, int N>
GEN_HD Dual<S, N> operator-(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}

template <class S, int N>
GEN_HD Dual<S, N> operator*(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

// d (a / b) = (da - (a / b) db) / b
template <class S, int N>
GEN_HD Dual<S, N> operator/(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  const S inv = recip_(b.v);
  r.v = a.v * inv;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
  return r;
}

// Scale every partial of a by the scalar slope.
template <class S, int N>
GEN_HD Dual<S, N> chain(const S& value, const S& slope,
                        const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = value;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = slope * a.d[k];
  return r;
}

// d (1 / x) = -1 / x^2
template <class S, int N>
GEN_HD Dual<S, N> recip_(const Dual<S, N>& a) {
  const S v = recip_(a.v);
  return chain(v, -(v * v), a);
}

// d sqrt(x) = 1 / (2 sqrt(x))
template <class S, int N>
GEN_HD Dual<S, N> sqrt_(const Dual<S, N>& a) {
  const S v = sqrt_(a.v);
  return chain(v, recip_(v) * S(0.5f), a);
}

template <class S, int N>
GEN_HD Dual<S, N> sqrt_pos_(const Dual<S, N>& a) {
  return sqrt_(a);
}

// d rsqrt(x) = -x^(-3/2) / 2
template <class S, int N>
GEN_HD Dual<S, N> rsqrt_(const Dual<S, N>& a) {
  const S v = rsqrt_(a.v);
  return chain(v, v * v * v * S(-0.5f), a);
}

// |a|: the sign of the innermost value on every level, +1 at 0 as jnp.abs
template <class S, int N>
GEN_HD Dual<S, N> abs_(const Dual<S, N>& a) {
  return primal(a) >= 0.0f ? a : -a;
}

// min and max: the smaller (larger) operand with all its partials, their
// mean at a tie of the innermost values
template <class S, int N>
GEN_HD Dual<S, N> min_(const Dual<S, N>& a, const Dual<S, N>& b) {
  const float pa = primal(a), pb = primal(b);
  if (pa < pb) return a;
  if (pb < pa) return b;
  return (a + b) * Dual<S, N>(0.5f);
}

template <class S, int N>
GEN_HD Dual<S, N> max_(const Dual<S, N>& a, const Dual<S, N>& b) {
  const float pa = primal(a), pb = primal(b);
  if (pa > pb) return a;
  if (pb > pa) return b;
  return (a + b) * Dual<S, N>(0.5f);
}

}  // namespace gen
"""
SHADE = ("  return user_shade<float>(r.o[0].v, r.o[1].v, r.o[2].v, r.d[0].v, "
         "r.d[1].v,\n                           r.d[2].v, t.v, pv);")
DUAL_SHADE = ("""  using D3 = Dual<float, 3>;
  D3 pvd[kNP];
  for (int k = 0; k < kNP; ++k) pvd[k] = D3(pv[k]);
  const D3 s = user_sdf<D3>(variable<float, 3>((r.o[0] + r.d[0] * t).v, 0),
                            variable<float, 3>((r.o[1] + r.d[1] * t).v, 1),
                            variable<float, 3>((r.o[2] + r.d[2] * t).v, 2),
                            pvd);
  const float gx = s.d[0], gy = s.d[1], gz = s.d[2];
  const float inv = rsqrt_(gx * gx + gy * gy + gz * gz + 1e-12f);
  const float lam = (gx * pv[kLight] + gy * pv[kLight + 1]
                     + gz * pv[kLight + 2]) * inv;
  return pv[kAmbient] + max_(lam, 0.0f) * pv[kGain];""")
IDENTITIES = "8x4 warps, 16x8 blocks, exact identities recorded"
FWD_VARIANTS = {  # name: (warp columns, block columns and rows), text
    "8x4 warps, 16x8 blocks (shipped)": ((8, 16, 8), []),
    "8x4 warps, 8x8 blocks": ((8, 8, 8), []),
    "8x4 warps, 32x8 blocks": ((8, 32, 8), []),
    "4x8 warps, 8x8 blocks": ((4, 8, 8), []),
    "4x8 warps, 16x8 blocks": ((4, 16, 8), []),
    "4x8 warps, 32x8 blocks": ((4, 32, 8), []),
    "16x2 warps, 16x4 blocks": ((16, 16, 4), []),
    "32x1 warps, 32x2 blocks": ((32, 32, 2), []),
    "32x1 warps, 32x8 blocks (the earlier geometry)": ((32, 32, 8), []),
    "8x4 warps, 16x8 blocks, hit test evaluated anew": ((8, 16, 8), [
        (HIT_TEST, "  *hit = dist_at(r, pv, t).v < m.eps;\n  return t;")]),
    "8x4 warps, 16x8 blocks, dual normal": ((8, 16, 8), [
        (NUM_INCLUDE, NUM_INCLUDE + DUAL_TYPE), (SHADE, DUAL_SHADE)]),
    "8x4 warps, 16x8 blocks, square roots range-checked": ((8, 16, 8), [
        ("sqrt_pos_(", "sqrt_(")]),
    IDENTITIES: ((8, 16, 8), []),
}
GROUPS = "constexpr int kGroupsF16 = 2;"
SCALE = """  const float p = __fmul_rn(fabsf(__fsub_rn(x, lo)), inv_span);"""
DIVISION = """  const float hi = __half2float(__ushort_as_half(
      static_cast<uint16_t>(hi_b)));
  const float span = __fsub_rn(hi, lo);
  const float p = span != 0.0f ? __fdiv_rn(__fsub_rn(x, lo), span) : 0.0f;"""
ROUND_VARIANTS = {
    "f16 scale, 2 groups (shipped)": [],
    "f16 scale, 4 groups": [(GROUPS, "constexpr int kGroupsF16 = 4;")],
    "f16 division, 2 groups (the earlier route)": [(SCALE, DIVISION)],
    "f16 division, 4 groups": [
        (SCALE, DIVISION), (GROUPS, "constexpr int kGroupsF16 = 4;")],
}
HIST_VARIANTS = {
    "row per thread, pipelined, 8 / 4 chunks (shipped)": [],
    "row per thread, pipelined, 4 / 4 chunks": [
        ("kRowUnrollCount = 8", "kRowUnrollCount = 4")],
    "row per thread, not pipelined, 8 / 4 chunks": UNPIPELINED,
    "row per warp for every bins (the earlier design)": [
        ("constexpr int kSmallBins = 96;", "constexpr int kSmallBins = 0;")],
}


SDF_GEOMETRY = ("constexpr int kWarpCols = {}, kBlockCols = {}, "
                "kBlockRows = {};")
Z_LOOP = """  for (int k = 0;; ++k) {
    s = dist_len<O>(m.rxy2, z);
    if (k >= n_steps - 1) break;          // the cap: no advance
    if (!march_alive<T>(m, z, s)) break;  // frozen: converged or escaped
    z = O::add(z, O::sub(s, m.rad));
  }"""
# the z-carry loop as it was before the hit test took its last distance
Z_LOOP_ANEW = """  for (int k = 0; k < n_steps - 1; ++k) {
    s = dist_len<O>(m.rxy2, z);
    if (!march_alive<T>(m, z, s)) break;
    z = O::add(z, O::sub(s, m.rad));
  }
  s = dist_len<O>(m.rxy2, z);"""
# the relaxed march's hit test on the loop's last distance where the last
# step did not move the lane (the first design of the redesign)
RELAXED_REUSE = [
    ("  V stp = zero;\n  // one step;",
     "  V stp = zero, d = zero;\n  bool moved = true;\n  // one step;"),
    ("    const V d = dist_at(pos);\n    const V back_stp",
     "    d = dist_at(pos);\n    const V back_stp"),
    ("    pos = new_pos;\n    stp = new_stp;\n    return alive | over;",
     "    moved = over | diverged | adv;\n    pos = new_pos;\n"
     "    stp = new_stp;\n    return alive | over;"),
    ("  *hit = O::lt(dist_at(pos), m.eps);",
     "  if (moved) d = dist_at(pos);\n  *hit = O::lt(d, m.eps);"),
]
# the relaxed march's last step peeled off its loop, which then tests the
# step count once an iteration
PEELED = [("""#pragma unroll 1
  for (int k = 0; k < n_steps; ++k) {
    if (!step(k == n_steps - 1)) break;
  }""", """  int k = 0;
#pragma unroll 1
  for (; k < n_steps - 1; ++k) {
    if (!step(false)) break;
  }
  if (k == n_steps - 1) step(true);""")]
# unimodal a compile-time constant, as a template parameter would make it
# (true: the configuration timed here)
CONSTANT_UNIMODAL = [("unimodal != 0, &hit", "true, &hit")]
F32_COMPARES = [
    ("{ return __hlt(a, b); }",
     "{ return __bfloat162float(a) < __bfloat162float(b); }"),
    ("{ return __hle(a, b); }",
     "{ return __bfloat162float(a) <= __bfloat162float(b); }"),
    ("{ return __hge(a, b); }",
     "{ return __bfloat162float(a) >= __bfloat162float(b); }"),
]
WD_TWICE = [("O::lt(stp, wd)", "O::lt(stp, O::mul(d, w))"),
            ("adv ? wd : zero", "adv ? O::mul(w, d) : zero")]
SDF_SHIPPED = "8x4 warps, 16x8 blocks (shipped)"
SDF_VARIANTS = {  # name: (warp columns, block columns and rows), text
    SDF_SHIPPED: ((8, 16, 8), []),
    "8x4 warps, 8x8 blocks": ((8, 8, 8), []),
    "8x4 warps, 32x8 blocks": ((8, 32, 8), []),
    "4x8 warps, 8x8 blocks": ((4, 8, 8), []),
    "4x8 warps, 16x8 blocks": ((4, 16, 8), []),
    "4x8 warps, 32x8 blocks": ((4, 32, 8), []),
    "32x1 warps, 32x8 blocks (the earlier geometry)": ((32, 32, 8), []),
    "z-carry hit test evaluated anew": ((8, 16, 8), [(Z_LOOP, Z_LOOP_ANEW)]),
    "z-carry rsqrt with its subnormal scaling": ((8, 16, 8), [
        ("O::mul(x, O::rsqrt_pos(x))",
         "O::mul(x, O::of(rsqrtf(O::f32(x))))")]),
    "relaxed hit test on the loop's last distance": ((8, 16, 8),
                                                     RELAXED_REUSE),
    "relaxed last step peeled off the loop": ((8, 16, 8), PEELED),
    "range-checked root": ((8, 16, 8), [
        ("O::sqrt_pos(O::add(m.rxy2, O::mul(u, u)))",
         "O::of(__fsqrt_rn(O::f32(O::add(m.rxy2, O::mul(u, u)))))")]),
    "unimodal a compile-time constant": ((8, 16, 8), CONSTANT_UNIMODAL),
    "bf16 compares through f32": ((8, 16, 8), F32_COMPARES),
    "w * d taken twice": ((8, 16, 8), WD_TWICE),
}
# name: (the kernel's options, its __global__ function); every one at
# 1024^2, 64 steps, split 16, the reference scene, as chip_smoke.py
# phase 12 times it
SDF_KERNELS = {
    "sdf_fwd": (dict(), "sdf_fwd_kernelIfLb0ELb0EE"),
    "sdf_fwd_bf16": (dict(dtype="bf16"),
                     "sdf_fwd_kernelI13__nv_bfloat16Lb0ELb0EE"),
    "sdf_fwd_relax": (dict(relax=1.6, unimodal=True),
                      "sdf_fwd_kernelIfLb1ELb0EE"),
    "sdf_fwd_relax_bf16": (dict(dtype="bf16", relax=1.6, unimodal=True),
                           "sdf_fwd_kernelI13__nv_bfloat16Lb1ELb0EE"),
    "sdf_fwd_split": (None, "sdf_fwd_kernelIfLb0ELb1EE"),
}


def sdf_options(torch, name):
    """The keyword arguments of the sdf_fwd family's kernel ``name``
    (None for sdf_fwd_split), with its march dtype."""
    opts = SDF_KERNELS[name][0]
    if opts is None:
        return None
    return dict(opts, dtype=torch.bfloat16 if opts.get("dtype") == "bf16"
                else torch.float32)


def sdf_call(torch, C, K, p, name):
    """A call of the sdf_fwd family's kernel ``name`` through its wrapper,
    at the shapes chip_smoke.py times it: pass 1 of the split march with
    counters zeroed beforehand where it appends its survivors to a list
    (the wrapper would add a memset to each call)."""
    kw = sdf_options(torch, name)
    if kw is None:
        if not hasattr(K, "sdf_fwd_split_list"):
            return lambda: K.sdf_fwd_split(p, N, 16)
        fresh = C.fresh_counters(torch, p.device, 1000)
        return lambda: K.sdf_fwd_split_list(p, N, 16, counters=fresh())
    return lambda: K.sdf_fwd(p, N, STEPS, 1.2, None, **kw)


def sdf_plain(torch, K, p, name):
    """``sdf_call``'s plain version."""
    kw = sdf_options(torch, name)
    if kw is None:
        return K.sdf_fwd_split_plain(p, N, 16)
    return K.sdf_fwd_plain(p, N, STEPS, 1.2, None, **kw)


def run_sdf_variants(torch, dev, timer, C):
    """The sdf_fwd family's design variants: each built, held bit-equal to
    the plain versions, timed in two passes, one order then the other,
    and its march loops' SASS and ptxas's report printed."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import sdf_kernels as K

    common = (_build.CSRC_DIR / "common.cuh").read_text()
    source = (_build.CSRC_DIR / "sdf_render.cu").read_text().replace(
        '#include "common.cuh"', common.replace("#pragma once", ""))
    texts = {name: substitute(source, [(
        SDF_GEOMETRY.format(8, 16, 8), SDF_GEOMETRY.format(*dims))] + pairs)
        for name, (dims, pairs) in SDF_VARIANTS.items()}
    with ThreadPoolExecutor(len(texts)) as ex:
        libs = dict(zip(texts, ex.map(
            lambda t: _build.load_generated("sdf_render", t),
            texts.values())))
    p = torch.from_numpy(C.scene_vec(None)).to(dev)
    plain = {k: sdf_plain(torch, K, p, k) for k in SDF_KERNELS}
    times = {}
    for order in (1, -1):
        for name, lib in list(libs.items())[::order]:
            # the wrappers load sdf_render alone: they launch the variant's
            with mock.patch.object(_build, "load", lambda _, lib=lib: lib):
                for k in SDF_KERNELS:
                    call = sdf_call(torch, C, K, p, k)
                    if not all(torch.equal(a, b)
                               for a, b in zip(call(), plain[k])):
                        raise RuntimeError(f"{k} {name}: differs from its "
                                           f"plain version")
                    times.setdefault((k, name), []).append(
                        timer(call, 200))
    for (k, name), t in times.items():
        print(f"{k} {name}: {' / '.join(f'{v:.5f}' for v in t)} ms")
    iters = {}  # a lane's loop iterations, as chip_smoke.py phase 12
    for k in SDF_KERNELS:
        kw = sdf_options(torch, k)
        evals, steps = K.march_counts(p, N, 16 if kw is None else STEPS,
                                      1.2, **(kw or {}))
        iters[k] = steps if kw and "relax" in kw else evals
    for name, (dims, _) in SDF_VARIANTS.items():
        shares = []
        for k, c in iters.items():
            lanes = c.sum().item() / (32 * C.warp_evaluations(c, dims[0]))
            shares.append(f"{k} {lanes:.4f} / {C.block_share(c, *dims):.4f}")
        print(f"sdf_fwd family {name}: busy lanes / blocks' warp slots busy "
              + ", ".join(shares))
    for name, text in texts.items():
        path = _build.build_generated("sdf_render", text)
        sass = C.sass_of(path)
        for k, (_, kernel) in SDF_KERNELS.items():
            _, _, laid_out, issued = C.loop_counts(sass, kernel)
            print(f"ptxas {k} {name} ({path.name}): "
                  + C.resources_text(path, (kernel,))
                  + f"; its march loop lays out {laid_out} SASS "
                  f"instructions and issues {issued} an iteration")


# sdf_fwd's dense route (csrc/sdf_render.cu's sdf_fwd_dense): its patches
DENSE_FOOTPRINT = ("constexpr int kPatchCols = {}, kPatchRows = {}, "
                   "kDenseWarps = {};")
DENSE_SHIPPED = (4, 2, 4)
DENSE_VARIANTS = {  # name: (patch columns, patch rows, warps a block)
    "2x4 patch, 4 warps (shipped)": DENSE_SHIPPED,
    "1x4 patch, 4 warps": (4, 1, 4),
    "2x2 patch, 4 warps": (2, 2, 4),
    "1x8 patch, 4 warps": (8, 1, 4),
    "1x2 patch, 4 warps": (2, 1, 4),
    "4x2 patch, 4 warps": (2, 4, 4),
    "1x16 patch, 4 warps": (16, 1, 4),
    "2x8 patch, 4 warps": (8, 2, 4),
    "2x4 patch, 2 warps": (4, 2, 2),
    "2x4 patch, 8 warps": (4, 2, 8),
}
DENSE_SIZES = (1024, 2048, 3072, 4096, 8192, 16384)
# the shipped patch row is one float4 (4 columns); a variant of another
# width takes these rows in its place: float4s, or a float2 for 2 columns
DENSE_ASSERT = 'static_assert(kPatchCols == 4, "a patch row is one float4");'
DENSE_ASSERT_ANY = ("static_assert(32 % kPatchCols == 0 && (kPatchCols == 2 "
                    "|| kPatchCols % 4 == 0), \"a patch row in float4s or a "
                    "float2\");")
DENSE_ROWS = "// A patch row's values from p (its first column's) in v:"
DENSE_ROWS_ANY = r"""// A patch row's values from p (its first column's) in v: as float4s or a
// float2 where vec, else one by one; a column past the image's edge
// (left = n - col0 >= 1 columns are inside) takes the last one's value.
__device__ __forceinline__ void load_row(const float* p, bool vec, int left,
                                         float (&v)[kPatchCols]) {
  if constexpr (kPatchCols % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int g = 0; g < kPatchCols / 4; ++g) {
        // the first float4 is always inside: left >= 1
        if (g == 0 || 4 * g < left) {
          const float4 q = reinterpret_cast<const float4*>(p)[g];
          v[4 * g] = q.x, v[4 * g + 1] = q.y;
          v[4 * g + 2] = q.z, v[4 * g + 3] = q.w;
        } else {
#pragma unroll
          for (int c = 4 * g; c < 4 * g + 4; ++c) v[c] = v[4 * g - 1];
        }
      }
      return;
    }
  } else if constexpr (kPatchCols == 2) {
    if (vec) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x, v[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < kPatchCols; ++c) v[c] = p[min(c, left - 1)];
}

// A patch row's values v to p (its first column's): as float4s or a
// float2 where vec, else one by one; the columns past the image's edge
// are not stored.
__device__ __forceinline__ void store_row(float* p, bool vec, int left,
                                          const float (&v)[kPatchCols]) {
  if constexpr (kPatchCols % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int g = 0; g < kPatchCols / 4; ++g) {
        if (g == 0 || 4 * g < left)
          reinterpret_cast<float4*>(p)[g] = make_float4(
              v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
      }
      return;
    }
  } else if constexpr (kPatchCols == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < kPatchCols; ++c)
    if (c < left) p[c] = v[c];
}
"""


def dense_variant_text(source, dims):
    """sdf_render.cu with sdf_fwd_dense's patch (patch columns, patch rows,
    warps a block) set to ``dims``: the footprint's line replaced, and for
    a patch of other than 4 columns, the rows' loads and stores too."""
    pairs = [(DENSE_FOOTPRINT.format(*DENSE_SHIPPED),
              DENSE_FOOTPRINT.format(*dims))]
    if dims[0] != DENSE_SHIPPED[0]:
        start = source.index(DENSE_ROWS)
        end = source.index("\n}\n", source.index("void store_row(")) + 3
        pairs += [(DENSE_ASSERT, DENSE_ASSERT_ANY),
                  (source[start:end], DENSE_ROWS_ANY)]
    return substitute(source, pairs)


DENSE_KERNEL = "sdf_fwd_dense_kernelIfE"
PIXEL_KERNEL = "sdf_fwd_kernelIfLb0ELb0EE"


def dense_reps(n):
    """Calls a timing of one forward at n^2: a few hundred milliseconds
    of the card's time at every size."""
    return max(20, min(200, 200 * 4096 * 4096 // (n * n)))


def dense_cases(torch, K, p, n):
    """The forwards that the dense route is held to at n^2: (march dtype,
    start map) for f32 and bf16, each without and with a start map (the
    cone prepass's where its block divides n, else half the hit
    distance of the f32 render)."""
    if n % 8 == 0:
        t0 = K._cone_t0(p, n, STEPS, 1.2, 8)
    else:
        t0 = 0.5 * K.sdf_fwd(p, n, STEPS, 1.2)[1].clamp_min(0.0)
    return [(dtype, start) for dtype in (torch.float32, torch.bfloat16)
            for start in (None, t0)]


def run_sdf_dense(torch, dev, timer, C):
    """sdf_fwd's routes at DENSE_SIZES on the reference sphere, 64 steps:
    the one-pixel route and the dense route's patches (DENSE_VARIANTS),
    each held bit-equal to the one-pixel route (img and ts; f32 and bf16,
    with and without a start map, at 4096^2 and 4100^2; f32 at every
    size) before it is timed, in two passes, one order then the other;
    then each route's warp iterations (the plain march's counts), its
    march loop's SASS an iteration and its issue floor, and ptxas's
    report. DENSE_MIN_N is set from these times."""
    import contextlib
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import sdf_kernels as K

    source = (_build.CSRC_DIR / "sdf_render.cu").read_text()
    texts = {name: dense_variant_text(source, dims)
             for name, dims in DENSE_VARIANTS.items()}
    with ThreadPoolExecutor(len(texts)) as ex:
        libs = dict(zip(texts, ex.map(
            lambda t: _build.load_generated("sdf_render", t),
            texts.values())))
    p = torch.from_numpy(C.scene_vec(None)).to(dev)

    def fwd(n, route, lib=None, dtype=torch.float32, t0=None):
        # the variant's library where it is given, else the shipped one
        with (mock.patch.object(_build, "load", lambda _: lib) if lib
              else contextlib.nullcontext()), C.forced_route(K, route):
            return K.sdf_fwd(p, n, STEPS, 1.2, t0, dtype)

    for n in DENSE_SIZES + (4100,):
        cases = (dense_cases(torch, K, p, n) if n in (4096, 4100)
                 else [(torch.float32, None)])
        for dtype, t0 in cases:
            want = fwd(n, "pixel", dtype=dtype, t0=t0)
            for name, lib in libs.items():
                got = fwd(n, "dense", lib, dtype, t0)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(
                        f"sdf_fwd dense {name} at {n}^2 ({dtype}, start "
                        f"map {t0 is not None}): differs from the one-pixel "
                        f"route")
            del want, got
    print("sdf_fwd dense route: every patch bit-equal to the one-pixel "
          "route (img and ts)")
    times = {}
    calls = [("pixel route (8x4 warps, 16x8 blocks)", "pixel", None)] + [
        (name, "dense", lib) for name, lib in libs.items()]
    for n in DENSE_SIZES:
        for order in (1, -1):
            for name, route, lib in calls[::order]:
                times.setdefault((n, name), []).append(timer(
                    lambda: fwd(n, route, lib), dense_reps(n)))
        torch.cuda.empty_cache()
    rate, rate_text = C.issue_rate(torch)
    loops = {}
    for name, text in [(calls[0][0], source)] + list(texts.items()):
        path = _build.build_generated("sdf_render", text)
        sass = C.sass_of(path)
        kernel = PIXEL_KERNEL if name == calls[0][0] else DENSE_KERNEL
        loops[name] = C.loop_counts(sass, kernel)[3]
        print(f"ptxas sdf_fwd {name}: " + C.resources_text(path, (kernel,))
              + f"; its march loop issues {loops[name]} SASS instructions "
              f"an iteration")
    for n in DENSE_SIZES:
        evals, adv = K.march_counts(p, n, STEPS, 1.2)
        pixel = times[(n, calls[0][0])]
        for name, route, _ in calls:
            if route == "pixel":
                iters = C.warp_evaluations(evals, 8)
                lanes = 32
            else:
                cols, rows, _ = DENSE_VARIANTS[name]
                iters = C.dense_warp_iterations(adv, STEPS, cols * rows)
                lanes = 32 * cols * rows
            floor = 1e3 * loops[name] * iters / rate
            t_ms = times[(n, name)]
            print(f"sdf_fwd {n}^2 {name}: "
                  f"{' / '.join(f'{v:.5f}' for v in t_ms)} ms "
                  f"({min(t_ms) / min(pixel):.4f} of the pixel route); "
                  f"{iters} warp iterations (busy ray slots "
                  f"{int(evals.sum().item()) / (lanes * iters):.4f}), issue "
                  f"floor {floor:.5f} ms over {rate_text} (derived, not "
                  f"measured)")
        del evals, adv
        torch.cuda.empty_cache()
    # the bf16 march by both routes of the shipped source
    for n in DENSE_SIZES:
        t_ms = {}
        for order in (1, -1):
            for route in ("pixel", "dense")[::order]:
                t_ms.setdefault(route, []).append(timer(
                    lambda: fwd(n, route, dtype=torch.bfloat16),
                    dense_reps(n)))
        print(f"sdf_fwd_bf16 {n}^2: " + ", ".join(
            f"{route} route {' / '.join(f'{v:.5f}' for v in t)} ms"
            for route, t in t_ms.items())
            + f" (dense {min(t_ms['dense']) / min(t_ms['pixel']):.4f} of "
            f"pixel)")


# the two-pass split march (csrc/sdf_render.cu: pass 1's append, sdf_tail)
TAIL_GRID = "    grid[dev] = sms * per_sm;"
# a lane's first pair loaded beside the count (every slot below n^2 lies
# inside the list), the next one while the current one marches
PREFETCH = [
    ("""  const int count = counters[0];
  const int lanes = gridDim.x * kTailThreads;""",
     """  const int lanes = gridDim.x * kTailThreads;
  int j = blockIdx.x * kTailThreads + threadIdx.x;
  int2 e = j < n * n ? pairs[j] : make_int2(0, 0);
  const int count = counters[0];"""),
    ("""  for (int j = blockIdx.x * kTailThreads + threadIdx.x; j < count;
       j += lanes) {
    const int2 e = pairs[j];""",
     """  while (j < count) {
    const int next = j + lanes;
    const int2 e_next = next < count ? pairs[next] : e;"""),
    ("""                static_cast<size_t>(i), img, ts);
  }
}""", """                static_cast<size_t>(i), img, ts);
    j = next;
    e = e_next;
  }
}""")]
# each survivor's row and column from its index taken as 64 bits
TAIL_INDEX64 = [("""    const int row = i / n;
    const float px = pixel_coord(i - row * n, step, extent);""",
                 """    const int64_t i64 = i;
    const int row = static_cast<int>(i64 / n);
    const float px = pixel_coord(
        static_cast<int>(i64 - static_cast<int64_t>(row) * n), step,
        extent);""")]
# pass 1's append with one atomicAdd a warp and no block scan
APPEND_HEAD = "__device__ __forceinline__ void append_survivor("
WARP_APPEND = """__device__ __forceinline__ void append_survivor(bool live, int i, float z,
                                                int2* __restrict__ pairs,
                                                int* __restrict__ counters) {
  const int lane = threadIdx.x % 32;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (ballot == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(counters, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) {
    pairs[base + __popc(ballot & ((1u << lane) - 1u))] =
        make_int2(i, __float_as_int(z));
  }
}"""
# pass 1's append where every thread sums the four warps' counts itself:
# a block without a survivor leaves after one barrier
SUMMED_APPEND = """__device__ __forceinline__ void append_survivor(bool live, int i, float z,
                                                int2* __restrict__ pairs,
                                                int* __restrict__ counters) {
  constexpr int kWarps = kFwdThreads / 32;
  __shared__ int warp_count[kWarps];
  __shared__ int base;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int total = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (total == 0) return;
  if (threadIdx.x == 0) base = atomicAdd(counters, total);
  __syncthreads();
  if (live) {
    pairs[base + before + __popc(ballot & ((1u << lane) - 1u))] =
        make_int2(i, __float_as_int(z));
  }
}"""
NO_APPEND = "pass 1 without the append (pass 1 alone)"


def split_variants(C, source):
    """{name: text of csrc/sdf_render.cu} of the split march's variants;
    ``source`` is the shipped text."""
    texts = {"a lane a slot, then the slot a grid further (shipped)": source}
    for steps in (2, 4):
        for below, text in C.tail_schedule_sources(steps).items():
            if below == 1 and steps == 4:
                continue  # whole warps march in march_z's loop: no votes
            texts[f"refill: {C.TAIL_SCHEDULES[below]}"
                  + ("" if below == 1 else f", {steps} steps a vote")] = text
    for name, pairs in (
            ("the same, the next pair prefetched", PREFETCH),
            ("the 64-bit index", TAIL_INDEX64),
            ("persistent grid / 2",
             [(TAIL_GRID, TAIL_GRID.replace(";", " / 2;"))]),
            ("pass 1 with an atomic a warp (no block scan)",
             [(C.function_text(source, APPEND_HEAD), WARP_APPEND)]),
            ("pass 1's counts summed by every thread, one barrier where "
             "a block has no survivor",
             [(C.function_text(source, APPEND_HEAD), SUMMED_APPEND)]),
            (NO_APPEND, [("    append_survivor(live, row * n + col, z, "
                          "pairs, counters);\n", "")])):
        texts[name] = substitute(source, pairs)
    return texts


# (n, split): chip_smoke.py's, and two where the survivors outnumber the
# persistent grid's lanes
SPLIT_CASES = ((N, 16), (N, 8), (2 * N, 16))


def run_split_variants(torch, dev, timer, C):
    """The split march's design variants: each built, its split render
    held bit-equal to the one-pass render and its pass 1 to the plain
    version, then pass 1 (counters zeroed beforehand), the tail and the
    split forward as sdf_split runs it timed in two passes, one order then
    the other, with the tail's registers and the SASS of its march loop."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import sdf_kernels as K

    texts = split_variants(
        C, (_build.CSRC_DIR / "sdf_render.cu").read_text())
    with ThreadPoolExecutor(len(texts)) as ex:
        libs = dict(zip(texts, ex.map(
            lambda t: _build.load_generated("sdf_render", t),
            texts.values())))
    p = torch.from_numpy(C.scene_vec(None)).to(dev)
    one = {(n, split): K.sdf_fwd(p, n, STEPS) for n, split in SPLIT_CASES}
    plain = {(n, split): K.sdf_fwd_split_plain(p, n, split)
             for n, split in SPLIT_CASES}
    survivors = {}
    times = {}
    for order in (1, -1):
        for name, lib in list(libs.items())[::order]:
            with mock.patch.object(_build, "load", lambda _, lib=lib: lib):
                for n, split in SPLIT_CASES:
                    img, ts, cont, pairs, counters = K.sdf_fwd_split_list(
                        p, n, split)
                    if not all(torch.equal(a, b) for a, b in
                               zip((img, ts, cont), plain[(n, split)])):
                        raise RuntimeError(f"{name} n={n} split={split}: "
                                           f"pass 1 differs from plain")
                    fresh = C.fresh_counters(torch, dev, 1000)
                    got = [timer(lambda: K.sdf_fwd_split_list(
                        p, n, split, counters=fresh()), 200)]
                    if name != NO_APPEND:
                        k = int(counters[0].item())
                        survivors[(n, split)] = k
                        two = K.sdf_split(p, n, STEPS, 1.2, split)
                        if not all(torch.equal(a, b) for a, b in
                                   zip(two, one[(n, split)])):
                            raise RuntimeError(
                                f"{name} n={n} split={split}: the split "
                                f"render differs from the one-pass render")
                        fresh_t = C.fresh_counters(torch, dev, 1000, k)
                        got.append(timer(lambda: K.sdf_tail(
                            p, pairs, fresh_t(), img, ts, n, STEPS, split),
                            200))
                        got.append(timer(lambda: K.sdf_split(
                            p, n, STEPS, 1.2, split), 200))
                    times.setdefault((name, n, split), []).append(got)
    lanes = (torch.cuda.get_device_properties(0).multi_processor_count
             * 2048)
    print(f"split march: survivors {survivors}; at most {lanes} resident "
          f"lanes on this card")
    for (name, n, split), runs in times.items():
        parts = ["pass 1", "sdf_tail", "split forward"][:len(runs[0])]
        print(f"split {name} n={n} split={split}: " + "; ".join(
            f"{part} " + " / ".join(f"{r[j]:.5f}" for r in runs) + " ms"
            for j, part in enumerate(parts)))
    for name, text in texts.items():
        path = _build.build_generated("sdf_render", text)
        kernel = "sdf_tail_kernel"
        sass = C.sass_of(path)
        _, _, laid_out, issued = C.loop_counts(sass, kernel, innermost=True)
        print(f"ptxas split {name} ({path.name}): " + C.resources_text(
            path, (kernel, "sdf_fwd_kernelIfLb0ELb1EE"))
            + f"; {kernel}'s march loop lays out {laid_out} SASS "
            f"instructions and issues {issued} a trip")


# the backward pair on the pixel-sum skeleton (csrc/pixel_sum.cuh)
PIXEL_SUM_GEOMETRY = ("constexpr int kPixelSumThreads = {}, "
                      "kPixelSumPixels = {};")
# the blocks' rows summed by reduce_rows_kernel in a second launch
TWO_LAUNCHES = [
    ("  last_block_sum<kThreads>(partial, num_rows, ticket, dp);\n", ""),
    ("""      params, g, ts, partial, ticket, dp, n, step, extent, vec);
  return static_cast<int>(cudaGetLastError());""",
     """      params, g, ts, partial, ticket, dp, n, step, extent, vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return reduce_rows_launch<kNGrad, 16>(partial, grid.x * grid.y, dp,
                                        stream);"""),
]
# each pixel's row and column from its flat 64-bit index, as before
INDEX64 = [("""        F::hit(sc, g, t, col, py, step, extent, d);""",
            """        const int64_t i = static_cast<int64_t>(row) * n + col;
        const int r64 = static_cast<int>(i / n);
        F::hit(sc, g, t, static_cast<int>(i - static_cast<int64_t>(r64) * n),
               pixel_coord(r64, step, extent), step, extent, d);""")]
# a thread's pixels in straight-line code, a miss's terms dropped by a
# select, under one vote of the warp (a warp without a hit adds g alone)
PIXEL_LOOP = """#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = seg + (j * kThreads + threadIdx.x) * kVec + e;
        const float g = gv[j * kVec + e], t = tv[j * kVec + e];
        if (t >= 0.0f) {  // a hit stores t itself
          float d[kNGrad];
          F::hit(sc, g, t, col, py, step, extent, d);
#pragma unroll
          for (int k = 0; k < kNGrad; ++k) acc[k] += d[k];
        } else {
          acc[4] += g;
        }
      }
    }"""
WARP_VOTE = [(PIXEL_LOOP, """  bool any_hit = false;
#pragma unroll
  for (int k = 0; k < kPixels; ++k) any_hit |= tv[k] >= 0.0f;
  if (__any_sync(0xffffffffu, any_hit)) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = seg + (j * kThreads + threadIdx.x) * kVec + e;
        const float g = gv[j * kVec + e], t = tv[j * kVec + e];
        float d[kNGrad];
        F::hit(sc, g, t, col, py, step, extent, d);
#pragma unroll
        for (int k = 0; k < kNGrad; ++k)
          acc[k] += t >= 0.0f ? d[k] : (k == 4 ? g : 0.0f);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPixels; ++k) acc[4] += gv[k];
  }""")]
# the forward-mode duals of the earlier sdf_bwd_ad, as its per-pixel
# function on the skeleton (the Dual type defined here)
REVERSE_PIXEL = ("struct ReversePixel {", "};\n\n}  // namespace")
DUAL_PIXEL = """constexpr int kNVar = 10;  // the 9 live parameters, then t
constexpr int kVarT = 9;

struct Dual {
  float v;
  float d[kNVar];
};

__device__ __forceinline__ Dual constant(float v) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = 0.0f;
  return r;
}

__device__ __forceinline__ Dual variable(float v, int index) {
  Dual r = constant(v);
  r.d[index] = 1.0f;
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

__device__ __forceinline__ Dual rsqrt(const Dual& a) {
  Dual r;
  r.v = rsqrtf(a.v);
  const float slope = -0.5f * r.v * r.v * r.v;
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = slope * a.d[k];
  return r;
}

__device__ __forceinline__ Dual relu(const Dual& a) {
  Dual r;
  r.v = fmaxf(a.v, 0.0f);
  const float slope = a.v > 0.0f ? 1.0f : (a.v == 0.0f ? 0.5f : 0.0f);
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = slope * a.d[k];
  return r;
}

struct ReversePixel {
  static constexpr bool kReadsTs = true;

  struct Scene {
    const float* params;
  };

  __device__ __forceinline__ static Scene scene(const float* params) {
    return Scene{params};
  }

  __device__ __forceinline__ static void hit(const Scene& sc, float g,
                                             float tsv, int col, float py_,
                                             float step, float extent,
                                             float (&d)[kNGrad]) {
    const float* params = sc.params;
    const Dual px = constant(pixel_coord(col, step, extent));
    const Dual py = constant(py_);
    const Dual cx = variable(params[0], 0), cy = variable(params[1], 1);
    const Dual cz = variable(params[2], 2), rad = variable(params[3], 3);
    const Dual amb = variable(params[4], 4), gain = variable(params[5], 5);
    const Dual lx = variable(params[6], 6), ly = variable(params[7], 7);
    const Dual lz = variable(params[8], 8);
    const Dual t = variable(tsv, kVarT);
    const Dual dx = px - cx, dy = py - cy;
    const Dual dz = (constant(-1.0f) + t) - cz;
    const Dual x = dx * dx + dy * dy + dz * dz + constant(1e-12f);
    const Dual q = rsqrt(x);
    const Dual sdf = x * q - rad;
    const Dual gx = dx * q, gy = dy * q, gz = dz * q;
    const Dual inv = rsqrt(gx * gx + gy * gy + gz * gz + constant(1e-12f));
    const Dual lambert = relu((gx * lx + gy * ly + gz * lz) * inv);
    const Dual img = amb + lambert * gain;
    const float t_bar = g * img.d[kVarT];
    const float df_dt = sdf.d[kVarT];
    const float sgn = df_dt == 0.0f ? -1.0f : (df_dt > 0.0f ? 1.0f : -1.0f);
    const float slope = fabsf(df_dt) > 1e-6f ? df_dt : sgn;
    const float w = -t_bar / slope;
#pragma unroll
    for (int k = 0; k < kNGrad; ++k) d[k] = g * img.d[k] + w * sdf.d[k];
  }
"""
# the last block's rows read as one coalesced run into shared memory,
# ``rows`` at a time, each thread then adding its own rows in order
STRIDED_SUM = """#pragma unroll 4
  for (int r = threadIdx.x; r < num_rows; r += kThreads) {
#pragma unroll
    for (int k = 0; k < kNGrad; ++k)
      acc[k] += __ldcg(partial + r * kNGrad + k);
  }"""
STAGED_SUM = """  for (int r0 = 0; r0 < num_rows; r0 += {rows}) {{
    const int rows = num_rows - r0 < {rows} ? num_rows - r0 : {rows};
#pragma unroll 12
    for (int e = threadIdx.x; e < rows * kNGrad; e += kThreads)
      stage[e] = __ldcg(partial + r0 * kNGrad + e);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kThreads) {{
#pragma unroll
      for (int k = 0; k < kNGrad; ++k) acc[k] += stage[r * kNGrad + k];
    }}
    __syncthreads();
  }}"""
# a chunk of two floats in one load, for 2 pixels a thread
VEC_LOAD_2 = [("template <int kVec>\nstruct VecLoad;\n",
               "template <int kVec>\nstruct VecLoad;\n\ntemplate <>\n"
               "struct VecLoad<2> {\n  __device__ __forceinline__ static "
               "void load(const float* p, float* v) {\n    const float2 x = "
               "*reinterpret_cast<const float2*>(p);\n    v[0] = x.x;\n"
               "    v[1] = x.y;\n  }\n};\n")]
FOUR_AT_A_TIME = """  for (int r0 = threadIdx.x; r0 < num_rows; r0 += 4 * kThreads) {
    float v[4][kNGrad];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = r0 + b * kThreads;
#pragma unroll
      for (int k = 0; k < kNGrad; ++k)
        v[b][k] = r < num_rows ? __ldcg(partial + r * kNGrad + k) : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (r0 + b * kThreads < num_rows) {
#pragma unroll
        for (int k = 0; k < kNGrad; ++k) acc[k] += v[b][k];
      }
    }
  }"""
BWD_SHIPPED = "256 threads x 4 pixels (shipped)"
BWD_VARIANTS = {  # name: {kernel: substitutions}
    BWD_SHIPPED: {"sdf_bwd": [], "sdf_bwd_ad": []},
    **{f"{t} threads x {px} pixels": {
        k: [(PIXEL_SUM_GEOMETRY.format(256, 4),
             PIXEL_SUM_GEOMETRY.format(t, px))] + (VEC_LOAD_2 if px == 2
                                                   else [])
        for k in ("sdf_bwd", "sdf_bwd_ad")}
       for t, px in ((128, 2), (128, 4), (128, 8), (256, 2), (256, 8),
                     (512, 2), (512, 4), (1024, 4))},
    "1024 threads x 1 pixel": {k: [
        (PIXEL_SUM_GEOMETRY.format(256, 4), PIXEL_SUM_GEOMETRY.format(1024, 1)),
        ("template <int kVec>\nstruct VecLoad;\n",
         "template <int kVec>\nstruct VecLoad;\n\ntemplate <>\nstruct VecLoad<1> "
         "{\n  __device__ __forceinline__ static void load(const float* p, "
         "float* v) {\n    v[0] = *p;\n  }\n};\n")]
        for k in ("sdf_bwd", "sdf_bwd_ad")},
    **{f"at most {65536 // (256 * b)} registers ({b} blocks an SM)": {
        k: [("__launch_bounds__(kThreads)\npixel_sum_kernel",
             f"__launch_bounds__(kThreads, {b})\npixel_sum_kernel")]
        for k in ("sdf_bwd", "sdf_bwd_ad")} for b in (6, 7)},
    "two launches (reduce_rows_kernel)": {
        "sdf_bwd": TWO_LAUNCHES, "sdf_bwd_ad": TWO_LAUNCHES},
    "single-float loads": {k: [("  if (vec) {", "  if (false) {")]
                           for k in ("sdf_bwd", "sdf_bwd_ad")},
    "64-bit index": {"sdf_bwd": INDEX64, "sdf_bwd_ad": INDEX64},
    "rsqrtf with its subnormal scaling": {
        "sdf_bwd": [("rsqrt_pos_(dx * dx", "rsqrtf(dx * dx"),
                    ("rsqrt_pos_(ux * ux", "rsqrtf(ux * ux")],
        "sdf_bwd_ad": [("q = rsqrt_pos_(x);", "q = rsqrtf(x);"),
                       ("inv = rsqrt_pos_(m);", "inv = rsqrtf(m);")]},
    "at most 32 registers (full occupancy)": {
        k: [("__launch_bounds__(kThreads)\npixel_sum_kernel",
             "__launch_bounds__(kThreads, 2048 / kThreads)\n"
             "pixel_sum_kernel")] for k in ("sdf_bwd", "sdf_bwd_ad")},
    "forward-mode duals (the earlier sdf_bwd_ad)": {"sdf_bwd_ad": "duals"},
    "a fence in every thread before the ticket": {k: [
        ("  if (threadIdx.x < kNGrad) __threadfence();",
         "  __threadfence();")] for k in ("sdf_bwd", "sdf_bwd_ad")},
    "the last block's rows loaded four at a time, then added": {k: [
        (STRIDED_SUM, FOUR_AT_A_TIME)] for k in ("sdf_bwd", "sdf_bwd_ad")},
    **{f"the last block's rows staged {rows} at a time in shared memory": {
        k: [(STRIDED_SUM, STAGED_SUM.format(rows=rows)),
            ("  __shared__ bool last;\n", "  __shared__ bool last;\n"
             f"  __shared__ float stage[{rows} * kNGrad];\n")]
        for k in ("sdf_bwd", "sdf_bwd_ad")} for rows in (1024, 256)},
    "straight-line pixels under a warp vote": {
        "sdf_bwd": WARP_VOTE, "sdf_bwd_ad": WARP_VOTE},
    **{f"strided over a resident grid, {t} threads, {what}": {
        k: ("stride", t, what == "single floats")
        for k in ("sdf_bwd", "sdf_bwd_ad")}
       for t in (256, 128) for what in ("float4", "single floats")},
}
# a grid of the blocks the card holds at once, each thread striding over
# the image a chunk at a time (float4 where the wrapper says so, else one
# pixel) with the next chunk's loads in flight while it adds the current
# one; row and column carried from chunk to chunk. The blocks' rows are
# the grid's blocks. kStrideThreads: threads per block
STRIDE_KERNEL = """template <class F, int kThreads, int kVec>
__global__ void __launch_bounds__(kThreads)
stride_kernel(const float* __restrict__ params,
              const float* __restrict__ g_img,
              const float* __restrict__ ts_img, float* __restrict__ partial,
              unsigned* __restrict__ ticket, float* __restrict__ dp, int n,
              float step, float extent) {
  const typename F::Scene sc = F::scene(params);
  const int per_row = n / kVec;
  const long long total = static_cast<long long>(per_row) * n;
  const int stride = gridDim.x * kThreads;
  const int c0 = blockIdx.x * kThreads + threadIdx.x;
  int row = c0 / per_row;
  int col = (c0 - row * per_row) * kVec;
  const int drow = stride / per_row;
  const int dcol = (stride - drow * per_row) * kVec;
  float acc[kNGrad];
#pragma unroll
  for (int k = 0; k < kNGrad; ++k) acc[k] = 0.0f;
  long long c = c0;
  float gv[kVec], tv[kVec];
  auto load = [&](long long ci, float* gq, float* tq) {
    if (ci < total) {
      if constexpr (kVec == 4) {
        VecLoad<4>::load(g_img + ci * 4, gq);
        VecLoad<4>::load(ts_img + ci * 4, tq);
      } else {
        gq[0] = g_img[ci];
        tq[0] = ts_img[ci];
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        gq[e] = 0.0f;
        tq[e] = -1.0f;
      }
    }
  };
  load(c, gv, tv);
  while (c < total) {
    float gn[kVec], tn[kVec];
    load(c + stride, gn, tn);
    const float py = pixel_coord(row, step, extent);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float g = gv[e], t = tv[e];
      if (t >= 0.0f) {
        float d[kNGrad];
        F::hit(sc, g, t, col + e, py, step, extent, d);
#pragma unroll
        for (int k = 0; k < kNGrad; ++k) acc[k] += d[k];
      } else {
        acc[4] += g;
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      gv[e] = gn[e];
      tv[e] = tn[e];
    }
    c += stride;
    col += dcol;
    row += drow;
    if (col >= n) {
      col -= n;
      ++row;
    }
  }
  block_sum<kNGrad, kThreads>(acc, partial + blockIdx.x * kNGrad);
  last_block_sum<kThreads>(partial, gridDim.x, ticket, dp);
}

template <class F, int kThreads>
int stride_num_blocks(int n) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stride_kernel<F, kThreads, 1>, kThreads, 0);
    resident = sms * per_sm;
  }
  const long long need = (static_cast<long long>(n) * n + kThreads - 1)
                         / kThreads;
  return static_cast<int>(need < resident ? need : resident);
}

template <class F, int kThreads, int kPixels>
int pixel_sum_launch(const float* params, const float* g, const float* ts,
                     float* partial, unsigned* ticket, float* dp, int n,
                     float step, float extent, int vec, cudaStream_t stream) {
  const int grid = stride_num_blocks<F, kThreads>(n);
  if (vec)
    stride_kernel<F, kThreads, 4><<<grid, kThreads, 0, stream>>>(
        params, g, ts, partial, ticket, dp, n, step, extent);
  else
    stride_kernel<F, kThreads, 1><<<grid, kThreads, 0, stream>>>(
        params, g, ts, partial, ticket, dp, n, step, extent);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
"""
STRIDE_START = "template <class F, int kThreads, int kPixels>\n__global__"


def stride_text(source, kernel, threads, scalar=False):
    """``source`` with the strided kernel in place of pixel_sum_kernel."""
    a = source.index(STRIDE_START)
    b = source.index("}  // namespace", source.index("int pixel_sum_launch(",
                                                     a)) + len(
        "}  // namespace")
    fn = BWD_PAIR[kernel][2]
    text = source[:a] + STRIDE_KERNEL.replace("} // namespace", "") + source[b:]
    text = substitute(text, [
        ("pixel_sum_num_blocks<kPixelSumThreads, kPixelSumPixels>(n)",
         f"stride_num_blocks<{fn}, {threads}>(n)"),
        (f"pixel_sum_launch<{fn}, kPixelSumThreads, kPixelSumPixels>",
         f"pixel_sum_launch<{fn}, {threads}, 1>")])
    if scalar:
        text = substitute(text, [("  if (vec)\n    stride_kernel",
                                  "  if (false)\n    stride_kernel")])
    return text


# parts of the shipped kernel left out, timed and not gated (they compute
# something else): what the rest costs
BWD_PROBES = {
    "probe: g summed alone (no pixel's terms)": [
        ("      if (t >= 0.0f) {  // a hit stores t itself",
         "      if (false) {")],
    "probe: the rows alone (no ticket, no last block)": TWO_LAUNCHES[:1],
    "probe: the ticket, no last block's sum": [
        ("  if (!last) return;\n",
         "  if (!last || threadIdx.x == 0) {\n    if (last) *ticket = 0u;\n"
         "    return;\n  }\n  if (num_rows > 0) return;\n")],
    "probe: no fence before the ticket": [
        ("  if (threadIdx.x < kNGrad) __threadfence();\n", "")],
}
# kernel: (its library, the wrapper's kernel=, its per-pixel function)
BWD_PAIR = {"sdf_bwd": ("sdf_render", "analytic", "AnalyticPixel"),
            "sdf_bwd_ad": ("sdf_bwd_ad", "ad", "ReversePixel")}


def inlined(name):
    """csrc/<name>.cu with common.cuh and pixel_sum.cuh written into it,
    so that a variant's substitutions reach the skeleton."""
    from enoki_tpu_torch import _build
    common = (_build.CSRC_DIR / "common.cuh").read_text().replace(
        "#pragma once", "")
    pixel_sum = (_build.CSRC_DIR / "pixel_sum.cuh").read_text().replace(
        "#pragma once", "").replace('#include "common.cuh"\n', "")
    return (_build.CSRC_DIR / f"{name}.cu").read_text().replace(
        '#include "common.cuh"\n', common).replace(
        '#include "pixel_sum.cuh"\n', pixel_sum)


def bwd_variant_text(source, pairs, kernel=None):
    if isinstance(pairs, tuple):  # ("stride", threads, scalar)
        return stride_text(source, kernel, pairs[1], pairs[2])
    if pairs == "duals":
        a = source.index(REVERSE_PIXEL[0])
        b = source.index(REVERSE_PIXEL[1], a)
        return source[:a] + DUAL_PIXEL + source[b:]
    return substitute(source, pairs)


def run_bwd_variants(torch, dev, timer, C):
    """The backward pair's design variants: each built, held to its plain
    version under chip_smoke.py's phase 2 / 11 gate at 1024^2 and 257^2
    and bitwise equal from run to run, timed in two passes (one order,
    then the other) at 1024^2 with g = 1 / N^2, and ptxas's report
    printed; and the probes (BWD_PROBES), timed alone."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import sdf_kernels as K

    texts = {(k, name): bwd_variant_text(inlined(BWD_PAIR[k][0]), pairs[k],
                                         k)
             for name, pairs in BWD_VARIANTS.items() for k in pairs}
    texts.update({(k, name): substitute(inlined(BWD_PAIR[k][0]), pairs)
                  for name, pairs in BWD_PROBES.items() for k in BWD_PAIR})
    with ThreadPoolExecutor(len(texts)) as ex:
        libs = dict(zip(texts, ex.map(
            lambda key: _build.load_generated(BWD_PAIR[key[0]][0],
                                              texts[key]), texts)))
    p = torch.from_numpy(C.scene_vec(None)).to(dev)
    plain = {"sdf_bwd": K.sdf_bwd_plain, "sdf_bwd_ad": K.sdf_bwd_ad_plain}
    cases = {}
    for n in (N, 257):
        ts = K.sdf_fwd(p, n, STEPS)[1]
        cases[n] = (ts, torch.from_numpy(np.random.default_rng(7)
                                         .standard_normal((n, n))
                                         .astype(np.float32)).to(dev))
    g_mean = torch.full((N, N), 1.0 / (N * N), device=dev)
    times = {}
    for order in (1, -1):
        for (k, name), lib in list(libs.items())[::order]:
            kernel = BWD_PAIR[k][1]
            # the wrapper loads the library of its kernel: the variant's
            with mock.patch.object(_build, "load", lambda _, lib=lib: lib):
                for n, (ts, g) in (() if name in BWD_PROBES
                                   else cases.items()):
                    dp = K.sdf_bwd(p, g, ts, n, 1.2, kernel)
                    ref = plain[k](p, g, ts, n, 1.2)
                    scale = max(1.0, ref.abs().max().item())
                    if not (torch.equal(dp, K.sdf_bwd(p, g, ts, n, 1.2,
                                                      kernel))
                            and bool(((dp - ref).abs() <= 2e-4 * scale
                                      + 2e-4 * ref.abs()).all().item())):
                        raise RuntimeError(f"{k} {name} n={n}: off its gate")
                ts = cases[N][0]
                times.setdefault((k, name), []).append(timer(
                    lambda: K.sdf_bwd(p, g_mean, ts, N, 1.2, kernel), 200))
    for (k, name), t in times.items():
        print(f"{k} {name}: {' / '.join(f'{v:.5f}' for v in t)} ms")
    for (k, name), text in texts.items():
        path = _build.build_generated(BWD_PAIR[k][0], text)
        print(f"ptxas {k} {name}: "
              + C.resources_text(path, (BWD_PAIR[k][2],)))


# the sphere path (csrc/sphere_render.cu): sphere_bwd on the pixel-sum
# skeleton, its g-only branch
SPHERE_SUM_GEOMETRY = ("constexpr int kSphereSumThreads = {}, "
                       "kSphereSumPixels = {};")
SPHERE_PIXEL_CALL = ("        if (col < n)\n"
                     "          F::pixel(sc, r, gv[j * kVec + e], col, step, "
                     "extent, acc);\n")
SPHERE_BWD_SHIPPED = "256 threads x 4 pixels (shipped)"
SPHERE_BWD_VARIANTS = {
    SPHERE_BWD_SHIPPED: [],
    **{f"{t} threads x {px} pixels": [
        (SPHERE_SUM_GEOMETRY.format(256, 4),
         SPHERE_SUM_GEOMETRY.format(t, px))]
       for t, px in ((256, 8), (128, 8), (128, 4))},
    "two launches (reduce_rows_kernel)": TWO_LAUNCHES,
    "single-float loads": [("  if (vec) {", "  if (false) {")],
    # each pixel's column from its flat 64-bit index, as before
    "64-bit index": [(SPHERE_PIXEL_CALL, """\
        const int64_t i = static_cast<int64_t>(row) * n + col;
        const int r64 = static_cast<int>(i / n);
        if (col < n)
          F::pixel(sc, r, gv[j * kVec + e],
                   static_cast<int>(i - static_cast<int64_t>(r64) * n), step,
                   extent, acc);
""")],
    "row terms per pixel": [("F::pixel(sc, r, ",
                             "F::pixel(sc, F::row(sc, row, step, extent), ")],
    # the hit's one division by the IEEE division, as before
    "the IEEE division": [(
        "disc > 0.0f ? __fdividef(dhz * 0.25f, sq) : 0.0f;",
        "disc > 0.0f ? dhz * 0.25f / sq : 0.0f;")],
}
SPHERE_BWD_PROBES = {
    "probe: the hit test alone (no hit's terms)": [(
        "    if (!(disc >= 0.0f)) return;  // a miss contributes nothing "
        "else\n",
        "    acc[5] += disc >= 0.0f ? g : 0.0f;\n    return;\n")],
    "probe: g summed alone at 4 MiB (no pixel's terms)": [
        (SPHERE_PIXEL_CALL,
         "        if (col < n) acc[4] += gv[j * kVec + e];\n")],
}
# sphere_fwd, one geometry for both dtypes
FWD_GEOMETRY = "constexpr int kFwdThreads = {}, kFwdPixels = {};"
FWD_BODY = """\
  const int row = blockIdx.x;
  const int col0 = blockIdx.y * (kThreads * kPixels) + threadIdx.x * kPixels;
  if (col0 >= n) return;
  const FwdRow<T> r = fwd_row<T>(params, row, step, extent);
  T v[kPixels];
#pragma unroll
  for (int e = 0; e < kPixels; ++e)
    v[e] = sphere_pixel<T>(r, col0 + e, step, extent);
"""
# one pixel a thread in blocks of 32 x 8 pixels (the earlier layout)
ONE_PIXEL = [
    (FWD_BODY + """\
  T* out = img + static_cast<size_t>(row) * n + col0;
  if (vec) {
    store_vector<T, kPixels>(out, v);
  } else {
#pragma unroll
    for (int e = 0; e < kPixels; ++e)
      if (col0 + e < n) out[e] = v[e];
  }
""", """\
  const int col = blockIdx.x * 32 + threadIdx.x % 32;
  const int row = blockIdx.y * 8 + threadIdx.x / 32;
  if (col >= n || row >= n) return;
  const FwdRow<T> r = fwd_row<T>(params, row, step, extent);
  img[static_cast<size_t>(row) * n + col] =
      sphere_pixel<T>(r, col, step, extent);
"""),
    ("  const dim3 grid(n, (n + kSegment - 1) / kSegment);",
     "  const dim3 grid((n + 31) / 32, (n + 7) / 8);"),
    (FWD_GEOMETRY.format(256, 4), FWD_GEOMETRY.format(256, 1))]
# the forward's graph as the plain version writes it: a = d.d and
# b = 2 oc.d computed, the division by 2a, hit_p = o + d t - c, the mask
# on the normal
IDENTITIES_KEPT = """\
  using O = Ops<T>;
  const T zero = O::of(0.0f), one = O::of(1.0f);
  const T px = O::of(pixel_coord(col, step, extent));
  const T oz = O::of(-1.0f), dx = zero, dy = zero, dz = one;
  const T ocx = O::sub(px, r.cx), ocy = O::sub(r.py, r.cy);
  const T ocz = O::sub(oz, r.cz);
  const T a = tdot3<O>(dx, dy, dz, dx, dy, dz);
  const T b = O::mul(O::of(2.0f), tdot3<O>(ocx, ocy, ocz, dx, dy, dz));
  const T c = O::sub(tdot3<O>(ocx, ocy, ocz, ocx, ocy, ocz), r.r2);
  const T discrim = O::sub(O::mul(b, b), O::mul(O::mul(O::of(4.0f), a), c));
  const float d32 = O::f32(discrim);
  const T t = O::of(__fdiv_rn(add(-O::f32(b), __fsqrt_rn(fmaxf(d32, 0.0f))),
                              mul(2.0f, O::f32(a))));
  const bool valid = d32 >= 0.0f;
  const T hx = O::sub(O::add(px, O::mul(dx, t)), r.cx);
  const T hy = O::sub(O::add(r.py, O::mul(dy, t)), r.cy);
  const T hz = O::sub(O::add(oz, O::mul(dz, t)), r.cz);
  const T nx = valid ? hx : zero, ny = valid ? hy : zero;
  const T nz = valid ? hz : zero;
  const T s = tdot3<O>(nx, ny, nz, r.lx, r.ly, r.lz);
  const T lambert = O::f32(s) > 0.0f ? s : zero;
  return O::add(r.amb, O::mul(lambert, r.gain));
}
"""
SPHERE_FWD_VARIANTS = {
    **{f"{t} threads x {px} pixels" + (" (shipped)" if (t, px) == (256, 4)
                                         else ""): [
        (FWD_GEOMETRY.format(256, 4), FWD_GEOMETRY.format(t, px))]
       for t in (128, 256, 512) for px in (1, 2, 4, 8)},
    "row terms per pixel": [(
        "    v[e] = sphere_pixel<T>(r, col0 + e, step, extent);",
        "    v[e] = sphere_pixel<T>(fwd_row<T>(params, row, step, extent),\n"
        "                           col0 + e, step, extent);")],
    "the exact identities kept": [
        ("  float nb;  // -b in f32\n};",
         "  float nb;  // -b in f32\n  T py, cy, ly;\n};"),
        ("O::mul(ocy, ly), -O::f32(b)};",
         "O::mul(ocy, ly), -O::f32(b),\n"
         "                   O::of(pixel_coord(row, step, extent)), cy, ly};"),
        "identities"],
    "one pixel a thread in 32 x 8 blocks": ONE_PIXEL,
    "scalar stores": [("  if (vec) {\n    store_vector",
                       "  if (false) {\n    store_vector")],
}
SPHERE_FWD_PROBES = {
    "probe: stores alone (every pixel ambient)": [(
        "    v[e] = sphere_pixel<T>(r, col0 + e, step, extent);",
        "    v[e] = r.amb;")],
}


def sphere_fwd_text(source, pairs):
    """``source`` with a sphere_fwd variant's substitutions; the string
    "identities" among them puts IDENTITIES_KEPT in place of the body of
    sphere_pixel."""
    source = substitute(source, [p for p in pairs if p != "identities"])
    if "identities" not in pairs:
        return source
    a = source.index("  using O = Ops<T>;\n  // intersect_rays")
    b = source.index("\n}\n", a) + len("\n}\n")
    return source[:a] + IDENTITIES_KEPT + source[b:]


def run_sphere_variants(torch, dev, timer, C):
    """The sphere path's design variants: sphere_bwd's and sphere_fwd's
    (f32 and bf16), each built, held to its plain version (sphere_bwd
    under chip_smoke.py's phase 6 gate at 1024^2 and 257^2 and bitwise
    equal from run to run; sphere_fwd bit-equal at 1024^2 and 257^2),
    timed in two passes (one order, then the other) at 1024^2 on the
    reference scene (g = 1 / N^2), ptxas's report printed; and the probes,
    timed alone."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import sphere_kernels as S

    source = inlined("sphere_render")
    texts = {("bwd", name): substitute(source, pairs) for name, pairs in
             {**SPHERE_BWD_VARIANTS, **SPHERE_BWD_PROBES}.items()}
    texts.update({("fwd", name): sphere_fwd_text(source, pairs)
                  for name, pairs in
                  {**SPHERE_FWD_VARIANTS, **SPHERE_FWD_PROBES}.items()})
    with ThreadPoolExecutor(len(texts)) as ex:
        libs = dict(zip(texts, ex.map(
            lambda t: _build.load_generated("sphere_render", t),
            texts.values())))
    p = torch.from_numpy(C.scene_vec(None)).to(dev)
    probes = {*SPHERE_BWD_PROBES, *SPHERE_FWD_PROBES}
    g_mean = torch.full((N, N), 1.0 / (N * N), device=dev)
    cases = {n: torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, n)).astype(np.float32)).to(dev) for n in (N, 257)}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    times = {}
    for order in (1, -1):
        for (kind, name), lib in list(libs.items())[::order]:
            with mock.patch.object(_build, "load", lambda _, lib=lib: lib):
                if kind == "bwd":
                    for n, g in (() if name in probes else cases.items()):
                        dp = S.sphere_bwd(p, g, n)
                        ref = S.sphere_bwd_plain(p, g, n)
                        scale = max(1.0, ref.abs().max().item())
                        if not (torch.equal(dp, S.sphere_bwd(p, g, n))
                                and bool(((dp - ref).abs() <= 2e-4 * scale
                                          + 2e-4 * ref.abs()).all().item())):
                            raise RuntimeError(f"sphere_bwd {name} n={n}: "
                                               "off its gate")
                    times.setdefault(("sphere_bwd", name), []).append(timer(
                        lambda: S.sphere_bwd(p, g_mean, N), 200))
                    continue
                for tag, dtype in dtypes.items():
                    for n in (() if name in probes else (N, 257)):
                        if not torch.equal(S.sphere_fwd(p, n, 1.2, dtype),
                                           S.sphere_fwd_plain(p, n, 1.2,
                                                              dtype)):
                            raise RuntimeError(f"sphere_fwd {tag} {name} "
                                               f"n={n}: not bit-equal")
                    times.setdefault((f"sphere_fwd {tag}", name), []).append(
                        timer(lambda dtype=dtype: S.sphere_fwd(p, N, 1.2,
                                                               dtype), 200))
    for (k, name), t in sorted(times.items()):
        print(f"{k} {name}: {' / '.join(f'{v:.5f}' for v in t)} ms")
    for (kind, name), text in texts.items():
        path = _build.build_generated("sphere_render", text)
        kernels = (("SpherePixel",) if kind == "bwd" else
                   ("sphere_fwd_kernelIf", "sphere_fwd_kernelI13__nv_bf"))
        print(f"ptxas sphere_{kind} {name}: "
              + C.resources_text(path, kernels))


def traced_with_identities(kern):
    """The scene's source traced with every operation recorded, the exact
    identities that the tracer leaves out (sdf_trace.Trace._identity)
    included."""
    from enoki_tpu_torch.render import sdf_trace
    keep = sdf_trace.Trace._identity
    sdf_trace.Trace._identity = lambda self, name, args: None
    try:
        return sdf_trace.trace_scene(kern.sdf_fn, kern.ray_fn,
                                     kern.n_params).source
    finally:
        sdf_trace.Trace._identity = keep


def run_variants(torch, dev, timer, C):
    from concurrent.futures import ThreadPoolExecutor

    from enoki_tpu_torch import _build
    from enoki_tpu_torch.ops import hist_kernels as H, rounding as RD
    from enoki_tpu_torch.render import generic as G

    kern = C.generic_scenes()["composed"][0].kernels
    skeleton = (_build.CSRC_DIR / "generic_render.cuh").read_text()
    hist_src = (_build.CSRC_DIR / "hist.cu").read_text()
    round_src = (_build.CSRC_DIR / "stochastic_round.cu").read_text()

    with_identities = traced_with_identities(kern)

    def generic_text(pairs, source=kern.traced.source):
        # the skeleton inlined into the scene's source, with the variant
        return substitute(source.replace(
            '#include "generic_render.cuh"',
            skeleton.replace("#pragma once", "")), pairs)

    sets = {  # name -> (library name, {variant: text})
        "generic_fwd": ("generic_render", {
            k: generic_text(fwd_pairs(*v), with_identities if k == IDENTITIES
                            else kern.traced.source)
            for k, v in FWD_VARIANTS.items()}),
        "generic_bwd": ("generic_render", {
            k: generic_text(v) for k, v in GENERIC_VARIANTS.items()}),
        "stochastic_round": ("stochastic_round", {
            k: substitute(round_src, v) for k, v in ROUND_VARIANTS.items()}),
        "hist": ("hist", {
            k: substitute(hist_src, v) for k, v in HIST_VARIANTS.items()}),
    }
    with ThreadPoolExecutor(sum(len(t) for _, t in sets.values())) as ex:
        futures = {(s, k): ex.submit(_build.load_generated, lib, text)
                   for s, (lib, texts) in sets.items()
                   for k, text in texts.items()}
        libs = {key: f.result() for key, f in futures.items()}
    f_libs = {k: libs["generic_fwd", k] for k in FWD_VARIANTS}
    g_libs = {k: libs["generic_bwd", k] for k in GENERIC_VARIANTS}
    r_libs = {k: libs["stochastic_round", k] for k in ROUND_VARIANTS}
    h_libs = {k: libs["hist", k] for k in HIST_VARIANTS}

    p = torch.tensor(C.GENERIC_PARAMS, dtype=torch.float32, device=dev)
    _, ts = G.generic_fwd(kern, p, N, STEPS)
    img_ref, ts_ref = G.generic_fwd_plain(kern.sdf_fn, kern.ray_fn, p, N,
                                          STEPS)
    x = round_inputs(torch, dev)
    round_ref = {dt: RD.stochastic_round_plain(x, SEED, dt).view(torch.int16)
                 for dt in (torch.float16, torch.bfloat16)}

    def round_call(lib, dtype):
        # the stochastic_round wrapper's launch, on a variant's library
        out = torch.empty(HIST_N, dtype=dtype, device=dev)
        assert lib.stochastic_round_launch(
            x.data_ptr(), out.data_ptr(), HIST_N, SEED,
            int(dtype == torch.float16),
            torch.cuda.current_stream().cuda_stream) == 0
        return out
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
        for name, lib in list(f_libs.items())[::order]:
            k = types.SimpleNamespace(lib=lib, n_params=kern.n_params)
            img, ts_v = G.generic_fwd(k, p, N, STEPS)
            if not (torch.equal(ts_v, ts_ref) and (img - img_ref).abs()
                    .max().item() <= 1e-3):
                raise RuntimeError(f"generic_fwd {name}: off its gate")
            times.setdefault(("generic_fwd", name), []).append(timer(
                lambda: G.generic_fwd(k, p, N, STEPS), 200, hold_ms=400.0))
        for name, lib in list(r_libs.items())[::order]:
            for dt in (torch.float16, torch.bfloat16):
                got = round_call(lib, dt).view(torch.int16)
                nan = torch.isnan(x)
                if not torch.equal(got[~nan], round_ref[dt][~nan]):
                    raise RuntimeError(f"stochastic_round {name} {dt}: "
                                       "differs from its plain version")
                times.setdefault((f"stochastic_round {dt}", name), []).append(
                    timer(lambda: round_call(lib, dt), 200))
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
    counts = G.generic_march_counts(kern.sdf_fn, kern.ray_fn, p, N, STEPS)
    evals = int(counts.sum().item())
    for name, (dims, _) in FWD_VARIANTS.items():
        print(f"generic_fwd {name}: busy-lane share "
              f"{evals / (32 * C.warp_evaluations(counts, dims[0])):.4f}, "
              f"its blocks' warp slots busy "
              f"{C.block_share(counts, *dims):.4f}")
    for (kernel, name), t in times.items():
        print(f"{kernel} {name}: {' / '.join(f'{v:.5f}' for v in t)} ms")
    for name, text in sets["generic_fwd"][1].items():
        path = _build.build_generated("generic_render", text)
        _, _, laid_out, issued = C.march_loop(path, "generic_fwd_kernelILb0E")
        print(f"ptxas generic_fwd {name}: " + C.resources_text(
            path, ("generic_fwd_kernelILb0E",)) + f"; its march loop lays "
            f"out {laid_out} SASS instructions and issues {issued} an "
            f"iteration")
    for name, text in sets["stochastic_round"][1].items():
        print(f"ptxas stochastic_round {name}: " + C.resources_text(
            _build.build_generated("stochastic_round", text),
            ("stochastic_round_kernelILb1ELb1E",)))
    for name, text in sets["generic_bwd"][1].items():
        print(f"ptxas generic_bwd {name}: " + C.resources_text(
            _build.build_generated("generic_render", text),
            ("generic_bwd_partial_kernel",)))
    for name, text in sets["hist"][1].items():
        print(f"ptxas hist {name}: " + C.resources_text(
            _build.build_generated("hist", text),
            ("hist_rows_kernelILb0ELb0E", "hist_rows_kernelILb1ELb1E",
             "hist_partial_kernelILb0E", "hist_partial_kernelILb1E")))


# (dtype, slots, the spread of the indices (chip_smoke.scatter_timed_case),
# the routes to time, the lanes a thread takes at once)
SPREADS = ("normal", "uniform", "cyclic")
SCATTER_VARIANTS = (
    [("float32", n, "normal", (1, 2, 3), 8) for n in (8, 32, 64, 96, 128,
                                                       192)]
    + [("float32", n, sp, (1, 2), 8) for sp in SPREADS[1:]
       for n in (8, 32, 64, 96, 128, 192)]
    + [("float32", n, sp, (2, 3), 8) for sp in SPREADS
       for n in (1024, 4096, 8192, 16384, 24576)]
    + [("float64", n, sp, (2, 3), 8) for sp in SPREADS for n in (4096,
                                                                   12288)]
    + [("int32", 64, "normal", (1, 2, 3), 8)]
    + [("int32", n, "uniform", (2, 3), 8) for n in (4096, 24576)]
    + [("float32", 64, "normal", (1,), u) for u in (1, 4, 16)]
    + [("float32", 4096, "normal", (2,), 1)])


def gate_variants(C):
    """phase 28 (b)'s timed weights (chip_smoke.SCATTER_TIMED), each by the
    route codegen gives it: the weights gate's readings."""
    from enoki_tpu_torch.trace import codegen
    return [("float32", n, "normal", (C.scatter_route("float32", n),),
             codegen.ACC_UNROLL) for n in C.SCATTER_TIMED]


def forced_plan(torch, C, tr, dev, arrays, route, unroll):
    """(plan, run) of evaluating ``arrays`` with every SCATTER_ADD target
    on ``route`` and ``unroll`` lanes a thread at a time (the codegen
    thresholds set for it while the source is written; no disk cache)."""
    import ctypes

    from enoki_tpu_torch.trace import codegen
    consts = {"ACC_UNROLL": unroll,
              "ROW_SLOTS": dict.fromkeys((codegen.F32, codegen.I32,
                                          codegen.U32), 227 if route == 1
                                         else 0),
              "BLOCK_BYTES": 0 if route == 3 else 227 * 1024,
              "ACC_SMEM": 0 if route == 3 else 227 * 1024}
    ids = [tr._PENDING_SCATTER.get(a.index, a.index) for a in arrays]
    n = tr._lib.ett_schedule((ctypes.c_uint32 * len(ids))(*ids), len(ids))
    entries, outs = tr._read_schedule(n)
    buf = (ctypes.c_uint32 * max(n, 1))()
    leaves = [tr._BUFFERS[buf[i]]
              for i in range(tr._lib.ett_schedule_data_ids(buf, n))]
    bits, codes = tr._collect_literals(n)
    saved = {k: getattr(codegen, k) for k in consts}
    try:
        for k, v in consts.items():
            setattr(codegen, k, v)
        plan = codegen.Plan(entries, outs, {}, 0, None)
    finally:
        for k, v in saved.items():
            setattr(codegen, k, v)
    lit = torch.from_numpy(bits.view(np.int64)).to(dev)
    return plan, lambda: plan.run(leaves, lit, bits, codes, dev)


def run_scatter_variants(torch, dev, timer, C, gate_only=False):
    """Each variant held to its reference before it is timed: int32 counts
    equal to the plain interpreter's, float weights within
    chip_smoke.weights_gate of the float64 sum (its reading printed).
    ``gate_only``: the gate variants, read and not timed; every reading is
    printed before a failure exits."""
    from concurrent.futures import ThreadPoolExecutor

    import enoki_tpu_torch.trace as tr
    variants = []
    for dtype, size, spread, routes, unroll in (
            gate_variants(C) if gate_only else SCATTER_VARIANTS):
        tr.reset()
        base, idx, val = C.scatter_timed_case(size, HIST_N, spread=spread)
        if dtype == "int32":
            val = np.ones(HIST_N, np.int32)
        base = base.astype(dtype)
        val = val.astype(dtype)
        arrays = [torch.from_numpy(a).to(dev) for a in (base, idx, val)]
        t = C.scatter_program(tr, *arrays, dev)
        want = tr.plain_eval(t)[0] if dtype == "int32" else None
        for route in routes:
            plan, run = forced_plan(torch, C, tr, dev, [t], route, unroll)
            got = list(plan.runs[0].routes.values())
            if got != [route]:
                sys.exit(f"scatter {dtype} {size}: route {got}, not {route}")
            variants.append(((dtype, size, spread, route,
                              plan.runs[0].unroll), plan, run, want, arrays))
        del t
    with ThreadPoolExecutor(16) as ex:
        list(ex.map(lambda v: v[1].library(), variants))
    times, readings, failed = {}, {}, []
    for order in (variants, variants[::-1]) if not gate_only else (
            variants,):
        for key, plan, run, want, arrays in order:
            if key not in readings:
                (got,) = run()[:1]
                torch.cuda.synchronize()
                if want is not None:
                    ok, share = bool(torch.equal(got, want)), 0.0
                    text = "equal to the plain interpreter" if ok else \
                        "differs from the plain interpreter"
                else:
                    ok, err, share = C.weights_gate(torch, got, *arrays)
                    text = (f"{share:.4g} of the weights gate from the "
                            f"float64 sum (max |err| {err:.4g})")
                readings[key] = text
                if not ok:
                    failed.append(key)
                    print(f"scatter {key}: FAIL, {text}", flush=True)
            if not gate_only and key not in failed:
                times.setdefault(key, []).append(
                    timer(run, 20, hold_ms=400.0))
    for key, text in readings.items():
        dtype, size, spread, route, unroll = key
        ms = " / ".join(f"{t:.4f}" for t in times.get(key, []))
        print(f"scatter {dtype} into {size} slots ({spread}), route {route}, "
              f"{unroll} lane(s) a thread at once: "
              + (f"{ms} ms; " if ms else "") + text)
    tr.reset()
    if failed:
        sys.exit(f"scatter: {len(failed)} variant(s) failed their gate")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT",
                    help="also time the kernels of the checkout there")
    ap.add_argument("--sdf-only", action="store_true",
                    help="time the sdf_fwd family's variants alone")
    ap.add_argument("--dense-only", action="store_true",
                    help="time sdf_fwd's two routes alone")
    ap.add_argument("--bwd-only", action="store_true",
                    help="time the SDF backward pair's variants alone")
    ap.add_argument("--sphere-only", action="store_true",
                    help="time the sphere kernels' variants alone")
    ap.add_argument("--split-only", action="store_true",
                    help="time the split march's variants alone")
    ap.add_argument("--scatter-only", action="store_true",
                    help="time the trace's SCATTER_ADD routes alone")
    ap.add_argument("--scatter-gate", action="store_true",
                    help="read the weights gate of phase 28 (b)'s timed "
                         "SCATTER_ADDs alone")
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
    dev, timer = torch.device("cuda"), C.DeviceTimer(torch)
    only = [args.sdf_only, args.dense_only, args.bwd_only,
            args.sphere_only, args.split_only, args.scatter_only,
            args.scatter_gate]
    if sum(only) > 1:
        sys.exit("kernel_variants: at most one of --sdf-only, --dense-only, "
                 "--bwd-only, --sphere-only, --split-only, --scatter-only "
                 "and --scatter-gate")
    if args.bwd_only or not any(only):
        run_bwd_variants(torch, dev, timer, C)
    if args.sdf_only or not any(only):
        run_sdf_variants(torch, dev, timer, C)
    if args.sdf_only or args.dense_only or not any(only):
        run_sdf_dense(torch, dev, timer, C)
    if args.sphere_only or not any(only):
        run_sphere_variants(torch, dev, timer, C)
    if args.split_only or not any(only):
        run_split_variants(torch, dev, timer, C)
    if args.scatter_only or not any(only):
        run_scatter_variants(torch, dev, timer, C)
    if args.scatter_gate:
        run_scatter_variants(torch, dev, timer, C, gate_only=True)
    if not any(only):
        run_variants(torch, dev, timer, C)
    if args.ab:
        bits = {}
        for root in (args.ab, HERE, HERE, args.ab):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-root",
                 os.path.abspath(root)], cwd=root, check=True,
                capture_output=True, text=True)
            line = out.stdout.strip().splitlines()[-1]
            print(line)
            got = json.loads(line)
            bits.setdefault(root, set()).add(
                (got["sdf_bwd_bits"], got["sdf_bwd_ad_bits"]))
        same = len(set.union(*bits.values())) == 1
        print("the SDF backward pair's dp bits on the phase 2 / 11 cases: "
              + ("the same in both checkouts and runs" if same else
                 f"DIFFER: {bits}"))


if __name__ == "__main__":
    main()
