#!/usr/bin/env python3
"""Design variants of the kernels of the PyTorch/CUDA port, timed in
turns on one CUDA card, and some of them of another checkout beside them.

  python kernel_variants.py [--sdf-only] [--ab OTHER_ROOT]

The sdf_fwd family (csrc/sdf_render.cu: sdf_fwd, sdf_fwd_bf16,
sdf_fwd_relax and sdf_fwd_relax_bf16 with relax 1.6 and unimodal,
sdf_fwd_split at split 16) on the reference sphere at 1024^2, 64 steps;
generic_fwd and generic_bwd (csrc/generic_render.cuh) on chip_smoke.py's
composed scene at 1024^2, 64 steps (g = 1 / N^2 for the backward);
stochastic_round (csrc/stochastic_round.cu) at 16M elements of phase 18's
data, f16 and bf16; hist (csrc/hist.cu) at 16M samples, 64 bins, on
binned normal samples, counting and weighted. A variant is the shipped
source with one constant or one piece of text replaced, built by nvcc
through enoki_tpu_torch._build; each is checked against its plain
version (the sdf_fwd family: every output bit-equal; generic_fwd: ts
bit-equal, image within 1e-3; generic_bwd within rtol 2e-4 / atol 2e-4 *
scale; stochastic_round bit-equal; hist counts exactly) before it is
timed, and the variants are timed twice, in one order and then in the
other. The variants:

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
  hist         a row per thread with the next chunks' loads in flight
               while the current ones are added (shipped: 8 chunks when
               counting, 4 weighted), the same with 4 when counting, not
               pipelined, and a row per warp for every bins (the earlier
               design)

--sdf-only times the sdf_fwd family's variants alone. --ab OTHER_ROOT
times the sdf_fwd family, generic_fwd and stochastic_round (f16 and
bf16) of the enoki_tpu_torch under OTHER_ROOT (a checkout of another
commit, with its own chip_smoke.py) in child processes, interleaved:
other, this, this, other, each with its kernels' ptxas registers and
spills.

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
    """The sdf_fwd family (SDF_KERNELS), generic_fwd and stochastic_round
    of the enoki_tpu_torch under ``root``, through that package's
    wrappers and that checkout's chip_smoke.py (one JSON line)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as C
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.ops import rounding as RD
    from enoki_tpu_torch.render import generic as G, sdf_kernels as K
    dev = torch.device("cuda")
    kern = C.generic_scenes()["composed"][0].kernels
    p = torch.tensor(C.GENERIC_PARAMS, dtype=torch.float32, device=dev)
    p_sdf = torch.from_numpy(C.scene_vec(None)).to(dev)
    x = round_inputs(torch, dev)
    timer = C.DeviceTimer(torch)
    out = {"root": root}
    for name in SDF_KERNELS:
        out[f"{name}_ms"] = timer(sdf_call(torch, K, p_sdf, name), 200)
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
        first_resources(C, _build.build_generated(
            "generic_render", kern.traced.source),
            ("generic_fwd_kernelILb0E", "generic_fwd_kernel")),
        C.resources_text(_build.build("stochastic_round"), (
            "stochastic_round_kernelILb1ELb1E",
            "stochastic_round_kernelILb0ELb1E"))])
    print(json.dumps(out))


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


def sdf_call(torch, K, p, name):
    """A call of the sdf_fwd family's kernel ``name`` through its wrapper,
    at the shapes chip_smoke.py times it."""
    kw = sdf_options(torch, name)
    if kw is None:
        return lambda: K.sdf_fwd_split(p, N, 16)
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
                    call = sdf_call(torch, K, p, k)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT",
                    help="also time the kernels of the checkout there")
    ap.add_argument("--sdf-only", action="store_true",
                    help="time the sdf_fwd family's variants alone")
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
    run_sdf_variants(torch, torch.device("cuda"), C.DeviceTimer(torch), C)
    if not args.sdf_only:
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
