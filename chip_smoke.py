#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (enoki_tpu_torch) on one GPU.

Drives the port's render paths through the entry points a user calls, on
the CUDA card, and holds every kernel of each path against its plain
PyTorch version. The main path is the differentiable SDF sphere-march
render at 1024^2 pixels, 64 march steps, f32, and the gradient of its
mean with respect to the 16-float scene vector; the second is the
closed-form sphere render of the reference mini-app (tests/sphere.cpp) at
its full 1024^2, in f32 and bf16 compute, with its gradient; the third is
the SDF render with each of its options (the cone prepass, which is the
reference's default configuration, a bf16 march, the over-relaxed march,
the two-pass split march, the autodiff-route backward), at the same 1024^2
and 64 steps; the fourth is the bring-your-own-SDF renderer
(make_sdf_renderer) on a 12-parameter composed scene (a sphere smooth-
blended with a torus over a ground plane), whose two kernels are generated
per scene, at the same 1024^2 and 64 steps; the fifth is the histogram
mini-app (tests/histogram.cpp of the source paper: PCG32 -> uniform ->
erfinv -> bin -> histogram) at its own 16M samples and 64 bins, with the
weighted histogram's gradient and a bf16 accumulator kept by stochastic
rounding.

  setup    build the kernels from enoki_tpu_torch/csrc with nvcc, and the
           generated sources of the generic renderer's scenes, one process
           per source, all at once
  phase 1  sdf_fwd against sdf_fwd_plain, reference + two seeded scenes
  phase 2  sdf_bwd against sdf_bwd_plain on the same ts, at 1024^2,
           1000^2 and 257^2 (float4 loads at the first two, single
           floats at 257), on the mixed and the all-miss scene of each
           seed, for a seeded g and for g = 1/N^2; two runs must be
           bitwise equal
  phase 3  the main path: SDFRender trained for a few SGD steps, each
           step's loss and gradient against the plain PyTorch render
           (render.sdf, the twin of the reference's jnp path); the launch
           counters must show one sdf_fwd and one sdf_bwd per step (the
           backward sums its blocks' rows in its own last block)
  phase 4  timing with CUDA events: a data-chained fwd+bwd loop (as
           bench.py chains its steps) against the same loop through the
           twin, each kernel alone, the plain versions, and each kernel's
           bound
  phase 5  sphere_fwd (f32 and bf16) bit-equal to sphere_fwd_plain at
           1024^2, 1000^2 and 257^2 (one vector store a thread at the
           first two, single stores at 257), reference + two seeded
           scenes + an all-miss scene
  phase 6  sphere_bwd against sphere_bwd_plain at the sizes, scenes and g
           of phase 2 (float4 loads of g at 1024 and 1000); two runs must
           be bitwise equal
  phase 7  the sphere path: SphereRender trained for a few SGD steps in
           f32, each step's loss and gradient against the plain twin
           (render.sphere, autograd through combined), then one bf16 step,
           whose gradient must equal the f32 step's at the same
           parameters; one sphere_fwd and one sphere_bwd per step (the
           backward sums its blocks' rows in its own last block)
  phase 8  timing: each sphere kernel alone with its bound and its plain
           version (the call after sphere_bwd's 200 timed ones bit-equal
           to the one before), the routes, ptxas's registers and spills and
           an issue floor of each (the fewest SASS instructions a warp of
           these straight-line kernels issues, from cuobjdump, times the
           warps, over the SMs' issue slots at the max SM clock; derived,
           for the record), the chained fwd+bwd loop through SphereRender
           against the twin's, and the mini-app's contrast, render_staged
           (separate kernels) against one sphere_fwd launch
  phase 9  each further sdf_fwd instantiation (start map, bf16 march,
           over-relaxed march, and their combinations) against
           sdf_fwd_plain: bit-equality is the aim, a differing pixel count
           is printed and gated as phase 1 gates flips; bands=8 bit-equal
           to bands=1; the start map conservative against the closed-form
           hit distance; at 1000^2 and 257^2, sizes that the kernels'
           warp tiles and blocks do not divide, the four instantiations
           and the split render bit-equal (with and without the start map
           where it divides)
  phase 10 the split render for (split, coarse) in (16,0), (32,0), (16,8):
           image and ts bit-equal to the one-pass kernel's, the survivors'
           share, pass 1 and the tail against their plain versions
  phase 11 sdf_bwd_ad against sdf_bwd_ad_plain and against sdf_bwd, at
           the sizes, scenes and g of phase 2; two runs must be bitwise
           equal
  phase 12 the options' path: SDFRender(coarse=8) trained for a few SGD
           steps on each scene against the plain twin under the
           head-start gates, then one fwd+bwd step for each other option
           at the reference scene, each counted; timing of
           each new kernel alone with its bound and plain version; the
           issue floor of each sdf_fwd instantiation, of sdf_fwd_split
           and of sdf_tail (the SASS instructions an iteration of its
           march loop issues times its warps' iterations, as phase 16
           derives it; a tail warp takes 32 consecutive survivors; held
           below the measured time) with its busy-lane and block shares and
           ptxas's registers and spills; timing of the
           cone prepass, and of the chained fwd+bwd step for the five
           candidate configurations of bench.py:233-235, interleaved
  phase 13 generic_fwd against generic_fwd_plain: the composed scene at
           the reference parameters and two seeded perturbations, through
           the orthographic and the perspective camera; a sphere-only
           scene against sdf_fwd at the same sphere (two independent
           kernels for one picture) under the flip gate; an all-miss
           scene, exactly ambient
  phase 14 generic_bwd against generic_bwd_plain on the same ts and a
           seeded g; two runs must be bitwise equal; the all-miss gradient
           exact
  phase 15 the generic path: the module of make_sdf_renderer(scene_sdf, 12)
           trained for a few SGD steps, each step's loss and gradient
           against the plain twin; one generic_fwd and one generic_bwd
           (+ reduce) per step; one step each of coarse=8, bands=8
           (composed scene) and relax=1.6, unimodal (sphere-only, a second
           scene in the same process) under the head-start gates
  phase 16 timing: each generic kernel alone with its bound (the
           shade and the cotangent counted from the reverse-mode programs
           they run) and its plain version, ptxas's registers and spills,
           the forward's busy-lane share per warp footprint (from the
           per-pixel evaluation counts) and its issue floor (the SASS
           instructions an iteration of its march loop issues, from
           cuobjdump, its slow paths left out, times the warps'
           evaluations, over the SMs' issue slots at the max SM clock;
           derived, and held below the measured time), the chained
           fwd+bwd step against the twin's, the cone
           prepass over the composed scene, trace and nvcc seconds per
           scene at first use and at a cached use
  phase 17 hist against hist_plain at 16M samples, 64 bins, on three index
           sets (the mini-app's normal samples, a uniform set with
           out-of-range and negative entries, every sample in one bin):
           counting exactly equal to the plain version and to
           torch.bincount, weighted within 1e-6 * sum|w| per bin of a
           float64 sum, two runs bitwise equal; the same for bins = 1 and
           SMALL_BINS (a row per thread), SMALL_BINS + 1 and 1000 (a row
           per warp), for index and weight views off a 16-byte boundary,
           and n = 0; ptxas's registers and spills of the hist kernels
  phase 18 stochastic_round against stochastic_round_plain at 16M: bit-
           equal in bf16 and f16 on data with NaN, infinities, zeros and
           subnormals mixed in; every result one of the two neighbours; on
           1 + 1/512 the share rounded up and the mean; seeds
  phase 19 the paths, counted: three chained iterations of the mini-app
           (the counts against a float64 bincount of the same indices and
           the normal distribution's mass per bin), the weighted
           histogram's gradient, and a bf16 accumulator of 64 small
           updates through stochastic_round_cuda against round-to-nearest
  phase 20 timing: hist counting and weighted and stochastic_round in
           bf16 and f16, each with its bound, its plain version and (hist)
           torch.bincount;
           the mini-app's stages in device time and its iteration as
           samples/s

Run from the root of the repository:  python chip_smoke.py
Needs one CUDA card; exits non-zero, printing no result, without one or
outside the repository. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists the kernels with their launches, errors, times
and bounds.
"""

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import numpy as np

N = 1024
STEPS = 64
EXTENT = 1.2
SEEDS = (None, 1, 2)          # reference scene + two seeded ones
# the backward's sizes: float4 loads at N and 1000 (a row is whole
# float4s), single floats at 257; the last segment of a row is partly
# past its end at 1000 and 257
BWD_SIZES = (N, 1000, 257)
TRAIN_STEPS = 3
LR = 1e-3

# published peaks of one H100 SXM at 700 W: memory and FP32 from NVIDIA's
# data sheet; bf16 outside the tensor cores from the H100 architecture
# whitepaper's table of peak rates ("Peak BF16 TFLOPS (non-Tensor)"), the
# rate of the scalar bf16 adds, multiplies and compares of a march (the
# data sheet's 989 TFLOP/s is the tensor cores', which run none of them)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 133.8e12
# 32-bit integer operations outside the tensor cores, from the same
# whitepaper table ("Peak INT32 TOPS"): the rate of Philox's products,
# adds and xors
INT32_OPS_PER_S = 33.5e12
# MUFU (rsqrt) results per clock per SM on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput): a
# second, tighter floor for the march, printed beside the bound
MUFU_PER_CLK_PER_SM = 16
# warp instructions an SM issues per clock: four schedulers, one each
# (H100 architecture whitepaper): the generic march's issue floor
ISSUE_SLOTS_PER_SM = 4

# FP32 operations of the kernels (csrc/sdf_render.cu), each add, mul,
# compare, max and rsqrt counted once
FWD_FLOPS_PER_EVAL = 7     # z*z, +rxy2, rsqrt, x*r; s >= s_hit, z+s, <= esc
FWD_FLOPS_PER_ADVANCE = 2  # z + (s - rad)
FWD_FLOPS_HIT_TEST = 2     # s - rad < eps, on the loop's last distance
FWD_FLOPS_PER_PIXEL = 16   # pixel coordinates, rxy2, folded constants, ts
FWD_FLOPS_PER_HIT = 28     # closed-form normal + lambert shade
BWD_FLOPS_PER_HIT = 89     # closed-form cotangents (pallas_kernels.py:826)
BWD_FLOPS_PER_PIXEL = 2    # the hit test and the sum of g into d ambient
# ... and of csrc/sphere_render.cu: the forward is branch-free (every pixel
# runs the whole quadratic and shade, in f32 or bf16); the backward runs
# up to the hit test and the sum of g on every pixel, the rest on hits
SPHERE_FWD_FLOPS_PER_PIXEL = 56
SPHERE_BWD_FLOPS_PER_PIXEL = 20
SPHERE_BWD_FLOPS_PER_HIT = 52
# ... and of the SDF options (csrc/sdf_render.cu, csrc/sdf_bwd_ad.cu):
# arithmetic and compares only, the predicates' and/or/not are no
# floating-point operations. A bf16 march's operations are held against
# the bf16 rate, the f32 shade's against the FP32 rate.
RELAX_FLOPS_PER_STEP = 12      # z0+t, u*u, +rxy2, sqrt, -rad, back*stp,
#                                d<, d>=eps, pos+d, <=tmax, w*d, pos+-
UNIMODAL_FLOPS_PER_STEP = 2    # stp>0, w*d>stp (w*d is new_stp's)
RELAX_FLOPS_HIT_TEST = 6       # z0+t, u*u, +rxy2, sqrt, -rad, d<eps
CONT_FLOPS_PER_PIXEL = 3       # pass 1's survivor test after the hit test
# sdf_bwd_ad computes sdf_bwd's function, so its bound takes sdf_bwd's
# count. For the record only: its reverse mode as written per hit pixel
# (csrc/sdf_bwd_ad.cu): the hit test 1, the forward sweep 32, the shade's
# adjoint sweep 41, the SDF's 11, the implicit term 6, the sums 23
BWD_AD_FLOPS_AS_WRITTEN_PER_HIT = 114
# ... and of the generated kernels (csrc/generic_render.cuh): what a
# distance evaluation costs is the traced scene function's own count of
# arithmetic nodes (Program.n_ops), to which come
GENERIC_POINT_FLOPS = 6        # o + d * t, three components
GENERIC_STEP_FLOPS = 3         # d >= eps, t + d, <= t_max
# what a hit pixel's shade and cotangent need comes from the traced scene
# function too, differentiated in reverse mode
# (sdf_trace.generic_hit_programs)
GENERIC_PARAMS = (0.15, 40.0, -1.0, -1.0, 2.0,     # ambient gain light
                  0.1, -0.2, 0.3, 0.45,            # sphere center, radius
                  0.55, 0.18, 1.05)                # torus R, r; plane
# the histogram mini-app (examples/histogram.py:23-24, :40), nothing cut
HIST_N = 1 << 24
HIST_BINS = 64
HIST_LO, HIST_HI = -4.0, 4.0
HIST_ITERS = 3                 # chained iterations of phase 19
ACC_UPDATES = 64               # updates of phase 19's bf16 accumulator
# operations of csrc/hist.cu's function per sample: two compares of the
# index against the range (integer) and one f32 add; of
# csrc/stochastic_round.cu's per element: a Philox block serves four
# elements with 10 rounds of two 32x32->64 products (hi and lo: 2
# operations each) and 4 xors, and 9 x 2 key increments; the bf16
# rounding adds, masks and shifts
HIST_INT_OPS_PER_SAMPLE = 2
HIST_FLOPS_PER_SAMPLE = 1
PHILOX_INT_OPS_PER_BLOCK = 10 * (2 * 2 + 4) + 9 * 2
ROUND_INT_OPS_PER_ELEMENT = 3
# the f16 rounding: the two conversions, x >= lo, x - lo, its magnitude,
# the product, the conversion and scaling of u and u < p in f32; the
# neighbour's pattern (zero test, direction, step), its finiteness and
# the span's exponent (field, max, halving, shift) in 32-bit integers
F16_ROUND_FLOPS_PER_ELEMENT = 9
F16_ROUND_INT_OPS_PER_ELEMENT = 12
# the five candidate configurations of bench.py:233-235:
# (coarse, bands, relax, unimodal, split)
CANDIDATES = ((0, 1, 1.0, False, 0), (8, 1, 1.0, False, 0),
              (0, 1, 1.0, False, 16), (0, 1, 1.0, False, 32),
              (8, 1, 1.0, False, 16))


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


def scene_vec(seed):
    """The reference scene vector, or a seeded perturbation: center +-0.1,
    radius 0.8-1.1, a random light (the CPU tests use the same recipe)."""
    v = np.zeros(16, np.float32)
    v[:9] = [0, 0, 0, 1.0, 0.2, 90.0, -1.0, -1.0, 2.0]
    if seed is not None:
        rng = np.random.default_rng(seed)
        v[0:3] = rng.uniform(-0.1, 0.1, 3)
        v[3] = rng.uniform(0.8, 1.1)
        v[6:9] = rng.uniform(-2.0, 2.0, 3)
    return v


def generic_vec(seed):
    """The composed scene's 12 parameters (examples/composed.py), or a
    seeded perturbation: sphere center +-0.1, radius 0.35-0.55, torus
    0.45-0.65 / 0.12-0.22, plane 0.95-1.1, a random light from above."""
    v = np.asarray(GENERIC_PARAMS, np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        v[2:4] = rng.uniform(-2.0, 2.0, 2)
        v[4] = rng.uniform(1.0, 2.5)
        v[5:8] += rng.uniform(-0.1, 0.1, 3)
        v[8] = rng.uniform(0.35, 0.55)
        v[9] = rng.uniform(0.45, 0.65)
        v[10] = rng.uniform(0.12, 0.22)
        v[11] = rng.uniform(0.95, 1.1)
    return v


def sphere_as_generic(v16):
    """The sphere scene's 16-vector [c, r, ambient, gain, l] in the generic
    layout [ambient, gain, l, c, r]."""
    return np.concatenate([v16[4:9], v16[0:4]]).astype(np.float32)


def generic_scenes():
    """name -> SceneKernels of the scenes phases 13-16 render."""
    from enoki_tpu_torch.render import Vec3, generic as G, sdflib as sd

    def scene_sdf(p, pv):                      # examples/composed.py:22-26
        s = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
        t = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
        g = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
        return sd.op_union(sd.op_smooth_union(s, t, 0.1), g)

    def sphere_only(p, pv):
        return sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])

    return {
        "composed": G.make_sdf_renderer(scene_sdf, 12),
        "composed_perspective": G.make_sdf_renderer(
            scene_sdf, 12, ray_fn=G.perspective_camera()),
        "sphere_only": G.make_sdf_renderer(sphere_only, 9),
    }


def nvidia_smi(query, fmt="csv,noheader"):
    """Card 0's answer to an nvidia-smi query ("" if it cannot answer)."""
    out = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else ""


def robust(samples):
    """Median and spread (max - min) / median."""
    med = statistics.median(samples)
    return med, (max(samples) - min(samples)) / med


class DeviceTimer:
    """Device time per call of ``fn``: a sleep kernel holds the stream
    while the host enqueues ``reps`` calls between two CUDA events, so
    the calls run back to back and the host's launch cost is hidden."""

    def __init__(self, torch):
        self.torch = torch
        s, e = self._events()
        torch.cuda.synchronize()
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 10_000_000 / s.elapsed_time(e)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def __call__(self, fn, reps, hold_ms=200.0, plain=False):
        """``plain``: ``fn`` is a plain version of thousands of eager
        launches. Those can fill the launch queue behind the held stream;
        the host then waits for the hold to end, and the time is taken
        again without a hold (it then includes the host's gaps between
        launches, and the log says so). A kernel's timing never may."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        s, e = self._events()
        torch.cuda._sleep(int(self.cycles_per_ms * hold_ms))
        t0 = time.perf_counter()
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if plain and enqueue_ms >= hold_ms:
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            torch.cuda.synchronize()
            log(f"timer: the enqueue of a plain version took {enqueue_ms:.1f}"
                f" ms of a {hold_ms} ms hold (the launch queue filled); "
                f"timed again without a hold: "
                f"{s.elapsed_time(e) / reps:.4f} ms, host gaps included")
        else:
            check(enqueue_ms < hold_ms, f"timer hold {hold_ms} ms shorter "
                  f"than the enqueue ({enqueue_ms:.1f} ms): raise hold_ms")
        return s.elapsed_time(e) / reps


def chain_ms(torch, step, p0, iters, windows):
    """Per-step time of ``iters`` data-chained steps, ``windows`` times:
    each step's params depend on the previous step's loss and gradient
    (bench.py:35-50), so no step can start before the last one ended."""
    samples = []
    p = step(p0, p0, 0)
    torch.cuda.synchronize()
    for _ in range(windows):
        ev = torch.cuda.Event
        s, e = ev(enable_timing=True), ev(enable_timing=True)
        p = p0
        s.record()
        for k in range(iters):
            p = step(p0, p, k)
        e.record()
        torch.cuda.synchronize()
        samples.append(s.elapsed_time(e) / iters)
    return robust(samples)


def device_ms_by_kernel(torch, step, p0, iters):
    """Device time per step of ``iters`` chained steps, by kernel name,
    from torch.profiler ({} where it saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    p = step(p0, p0, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p = p0
        for k in range(iters):
            p = step(p0, p, k)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = e.self_device_time_total / 1e3 / iters
    return out


def bound(nbytes, flops, bf16_flops=0, int_ops=0):
    """max(bytes / HBM rate, FP32 operations / FP32 peak + bf16 operations
    / bf16 peak + 32-bit integer operations / INT32 peak) in ms, and which
    of the two it is."""
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "operations": flops / FP32_FLOPS_PER_S
         + bf16_flops / BF16_FLOPS_PER_S + int_ops / INT32_OPS_PER_S}
    by = max(t, key=t.get)
    return 1e3 * t[by], by


def kernel_resources(lib_path, kernel):
    """(registers, spill store bytes, spill load bytes) of the ``__global__``
    function whose mangled name holds ``kernel``, from the ptxas report
    kept with the library (``_build.build_log``), or None without one."""
    import re

    from enoki_tpu_torch import _build
    for part in _build.build_log(lib_path).split(
            "Compiling entry function")[1:]:
        head = part.split("\n", 1)[0]
        if kernel not in head:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        if regs and spill:
            return (int(regs.group(1)), int(spill.group(1)),
                    int(spill.group(2)))
    return None


def resources_text(lib_path, kernels):
    """The ptxas report of ``kernels`` of a library, as a log phrase."""
    out = []
    for k in kernels:
        r = kernel_resources(lib_path, k)
        out.append(f"{k} " + ("no ptxas report" if r is None else
                              f"{r[0]} registers, {r[1]} / {r[2]} bytes of "
                              f"spill stores / loads"))
    return "; ".join(out)


def fwd_footprint(source="generic_render.cuh"):
    """A march kernel's footprint, read from its source in csrc/
    (generic_fwd's skeleton, or sdf_render.cu for sdf_fwd): (warp
    columns, block columns, block rows). A warp takes a cols x (32 /
    cols) tile of pixels, a block a block columns x block rows rectangle
    of them (common.cuh's tile_pixel)."""
    import re

    from enoki_tpu_torch import _build
    text = (_build.CSRC_DIR / source).read_text()
    found = re.search(r"constexpr int kWarpCols = (\d+), kBlockCols = (\d+), "
                      r"kBlockRows = (\d+);", text)
    check(found is not None, f"{source} names no footprint")
    return tuple(int(v) for v in found.groups())


def source_constants(source, *names):
    """The integer constants ``names`` of csrc/``source``, read from their
    ``name = value`` definitions."""
    import re

    from enoki_tpu_torch import _build
    text = (_build.CSRC_DIR / source).read_text()
    out = {}
    for name in names:
        found = re.search(rf"\b{name} = (\d+)", text)
        check(found is not None, f"{source} defines no {name}")
        out[name] = int(found.group(1))
    return out


def sass_of(lib_path):
    """``cuobjdump -sass`` of a built library, run anew, its output
    written beside it as ``.sass``."""
    from pathlib import Path

    from enoki_tpu_torch import _build
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    lib_path.with_suffix(".sass").write_text(out.stdout)
    return out.stdout


def march_loop(lib_path, kernel):
    """The march loop of the ``__global__`` function whose mangled name
    holds ``kernel``, from ``sass_of`` the library: see ``loop_counts``."""
    return loop_counts(sass_of(lib_path), kernel)


def issue_rate(torch):
    """(warp instructions the card issues per second: its SMs x
    ISSUE_SLOTS_PER_SM at the max SM clock, that product as a phrase).
    A march kernel's issue floor (derived, not measured) is the SASS
    instructions an iteration of its loop issues times the iterations its
    warps run, over this rate."""
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    return (props.multi_processor_count * ISSUE_SLOTS_PER_SM * sm_mhz * 1e6,
            f"{props.multi_processor_count} SMs x {ISSUE_SLOTS_PER_SM} issue "
            f"slots x {sm_mhz:.0f} MHz")


# a SASS branch names its target by label (`(.L_x_12)) or by address and
# is conditional with a guard, a predicate operand or .DIV
BRA_RE = (r"^(@!?U?P\w+\s+)?BRA((?:\.\w+)*)\s+(!?\w+,\s*)?"
          r"(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))")


def sass_function(sass, kernel):
    """(instructions as (address, text), label -> address, the addresses
    a label names) of the one function whose mangled name holds
    ``kernel`` in ``sass`` (cuobjdump -sass text)."""
    import re
    parts = [part for part in sass.split("Function : ")[1:]
             if kernel in part.split("\n", 1)[0]]
    check(len(parts) == 1, f"{len(parts)} functions named like {kernel} in "
          f"the SASS")
    ins, labels, starts, pending = [], {}, set(), []
    for line in parts[0].splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
            starts.add(addr)
        pending = []
        ins.append((addr, m.group(2)))
    return ins, labels, starts


def sass_branch(text, labels):
    """(target address, conditional) of a SASS branch, else None."""
    import re
    b = re.match(BRA_RE, text)
    if not b:
        return None
    target = labels.get(b.group(4)) if b.group(4) else int(b.group(5), 16)
    return target, bool(b.group(1) or b.group(3)) or ".DIV" in b.group(2)


def path_counts(sass, kernel):
    """(instructions laid out, fewest issued) of the function whose
    mangled name holds ``kernel`` in ``sass``: the fewest instructions on
    a path from its first instruction to an EXIT that takes no backward
    branch (no loop repeats), each instruction on it counted once, a
    predicated one too (it takes its issue slot), a called slow path not
    followed. An EXIT under a predicate ends a path only after the path
    has passed a store or atomic to global memory: the early return of
    threads past the image's edge does not end it, the return of the
    blocks that did not draw the last ticket does. For a straight-line
    kernel this is what a warp issues at the least."""
    import re
    ins, labels, _ = sass_function(sass, kernel)
    index = {addr: i for i, (addr, _) in enumerate(ins)}
    inf = float("inf")
    # cost[i][stored]: the fewest instructions from i to the path's end
    cost = [[inf, inf] for _ in range(len(ins) + 1)]
    for i in range(len(ins) - 1, -1, -1):
        addr, text = ins[i]
        op = re.sub(r"^@!?U?P\w+\s+", "", text)
        guarded = op != text
        for stored in (0, 1):
            after = int(stored or bool(re.match(r"(STG|ATOMG|RED|ATOM)\b",
                                                op)))
            if op.startswith("EXIT"):
                c = 1 if (not guarded or stored) else 1 + cost[i + 1][0]
            elif op.startswith(("RET", "BPT")):
                c = inf
            else:
                b = sass_branch(text, labels)
                nxt = cost[i + 1][after]
                if b is None:
                    c = 1 + nxt
                else:
                    target, conditional = b
                    jump = (cost[index[target]][after]
                            if target is not None and target > addr
                            and target in index else inf)
                    c = 1 + (min(nxt, jump) if conditional else jump)
            cost[i][stored] = c
    fewest = cost[0][0]
    check(fewest < inf, f"{kernel}: no path to an EXIT in its SASS")
    return sum(not t.startswith("NOP") for _, t in ins), int(fewest)


def loop_counts(sass, kernel):
    """(first address, back branch's address, instructions laid out
    between them, instructions an iteration issues) of the largest loop
    of the function whose mangled name holds ``kernel`` in ``sass``
    (cuobjdump -sass text). An iteration's instructions are those of the
    walk from the loop's head to its back branch that follows every
    unconditional branch and takes a conditional one only where the
    instructions it would fall into call a subroutine (the slow paths of
    the IEEE square root and division, which ptxas lays out inside the
    loop or past the kernel's end): cold code is not counted, a
    predicated instruction is (it takes its issue slot)."""
    import re
    ins, labels, starts = sass_function(sass, kernel)
    index = {addr: i for i, (addr, _) in enumerate(ins)}

    def branch(i):
        # (target address, conditional) of a branch, else None
        return sass_branch(ins[i][1], labels)

    def calls(i):
        # whether the straight-line code from i calls a subroutine
        for j in range(i, len(ins)):
            if j > i and ins[j][0] in starts:
                return False
            if ins[j][1].startswith("CALL"):
                return True
            if branch(j) is not None or "EXIT" in ins[j][1]:
                return False
        return False

    def walk(first, last):
        # the instructions an iteration issues from first to the back
        # branch at last, None where the walk leaves the range or repeats
        i, walked = index[first], set()
        while ins[i][0] != last:
            if (i in walked or not first <= ins[i][0] < last
                    or re.match(r"(EXIT|RET|CALL)", ins[i][1])):
                return None
            walked.add(i)
            b = branch(i)
            if b and (not b[1] or first <= b[0] <= last and calls(i + 1)
                      and not calls(index[b[0]])):
                if not first <= b[0] <= last:
                    return None
                i = index[b[0]]
            else:
                i += 1
        return len(walked) + 1

    # the largest backward branch that an iteration reaches: a slow path
    # laid out past the kernel's end branches back into the loop too
    for first, last in sorted(
            ((b[0], ins[i][0]) for i in range(len(ins))
             if (b := branch(i)) and b[0] is not None and b[0] < ins[i][0]),
            key=lambda lp: lp[0] - lp[1]):
        issued = walk(first, last)
        if issued is not None:
            return first, last, sum(first <= a <= last for a, _ in ins), issued
    raise SmokeFailure(f"{kernel}: no loop in its SASS")


def tile_max(counts, cols, rows):
    """The largest of ``counts`` in each ``cols`` x ``rows`` tile of them,
    padded with zeros to whole tiles."""
    n_r, n_c = counts.shape
    pad = counts.new_zeros((-(-n_r // rows) * rows, -(-n_c // cols) * cols))
    pad[:n_r, :n_c] = counts
    return pad.reshape(pad.shape[0] // rows, rows, pad.shape[1] // cols,
                       cols).amax(dim=(1, 3))


def warp_evaluations(counts, cols):
    """Evaluations a march of ``counts`` (one per pixel) costs its warps
    when each warp takes a ``cols`` x (32 / ``cols``) tile of pixels: the
    sum over the tiles of their largest count (a warp waits for its
    longest lane)."""
    return int(tile_max(counts, cols, 32 // cols).sum().item())


def block_share(counts, cols, block_cols, block_rows):
    """The share of a block's warp slots its warps keep busy, a block
    holding its slot until its slowest warp ends: the warps' evaluations
    over (warps a block) x the slowest warp's, summed over the blocks."""
    warps = tile_max(counts, cols, 32 // cols)
    across, down = block_cols // cols, block_rows // (32 // cols)
    slowest = tile_max(warps, across, down)
    return warps.sum().item() / (across * down * slowest.sum().item())


def bwd_cases(torch, dev, phase, run, cuda_vec, vector_loads=None):
    """Phases 2, 6 and 11: a backward kernel at each of BWD_SIZES, on each
    seed's mixed and all-miss scene, for a seeded g and for g = 1/n^2.
    ``run(p, g, ts, n)`` returns two runs of the kernel and its references
    by name: the runs must be bitwise equal, and each reference within
    rtol 2e-4, atol 2e-4 * scale. The load route (``vector_loads(g, ts,
    n)``, the SDF pair's by default) must be float4 where a row is whole
    float4s. Returns the largest |kernel - plain|."""
    from enoki_tpu_torch.render import sdf_kernels as K
    vector_loads = vector_loads or K.bwd_vector_loads
    worst = 0.0
    for n in BWD_SIZES:
        gs = {"seeded": torch.from_numpy(np.random.default_rng(7)
                                         .standard_normal((n, n))
                                         .astype(np.float32)).to(dev),
              "1/N^2": torch.full((n, n), 1.0 / (n * n), device=dev)}
        for seed in SEEDS:
            for shift in (0.0, 10.0):  # mixed scene / all-miss scene
                p = cuda_vec(seed)
                p[0] += shift
                _, ts = K.sdf_fwd(p, n, STEPS, EXTENT)
                vec = {vector_loads(g, ts, n) for g in gs.values()}
                what = f"{phase} n={n} scene={seed} shift={shift}"
                check(vec == {n % 4 == 0}, f"{what}: float4 loads {vec}, "
                      f"expected {n % 4 == 0}")
                parts = []
                for g_name, g in gs.items():
                    dp1, dp2, refs = run(p, g, ts, n)
                    torch.cuda.synchronize()
                    check(torch.equal(dp1, dp2),
                          f"{what} g {g_name}: two runs differ")
                    for which, ref in refs.items():
                        scale = max(1.0, ref.abs().max().item())
                        e = (dp1 - ref).abs()
                        if which == "plain":
                            worst = max(worst, e.max().item())
                        parts.append(f"g {g_name} vs {which} "
                                     f"{e.max().item():.3e} (scale "
                                     f"{scale:.3e})")
                        check(bool((e <= 2e-4 * scale + 2e-4 * ref.abs())
                                   .all().item()),
                              f"{what} g {g_name} vs {which}: {e.tolist()}")
                log(f"{what} ({'float4' if n % 4 == 0 else 'single-float'} "
                    f"loads): max|dp - ref| " + ", ".join(parts)
                    + "; two runs bitwise equal; gate rtol 2e-4 atol "
                    "2e-4*scale: pass")
    return worst


def timed_bwd(torch, timer, name, call, vec):
    """A backward kernel's device time over 200 back-to-back launches of
    ``call`` at the main path's tensors, which must take float4 loads
    (``vec``). Each launch's last block sets the ticket counter back to
    0, so one more call after the 200 must be bit-equal to one before."""
    check(vec, f"{name}: the timed g and ts take single-float loads")
    first = call()
    ms = timer(call, 200)
    last = call()
    torch.cuda.synchronize()
    check(torch.equal(first, last), f"{name}: the call after the 200 timed "
          "ones differs from the one before (the counter did not reset)")
    log(f"{name} timed with float4 loads; the call after the 200 timed ones"
        f" is bit-equal to the one before: pass")
    return ms


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this check "
                           "needs a CUDA card")
    run(torch, torch.device("cuda"))


def run(torch, dev):
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import (LAUNCHES, reset_launch_counts,
                                        sdf_kernels as K)
    from enoki_tpu_torch.render.sdf import (SDFScene,
                                            render_sdf_grads_implicit)

    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    libs = ("sdf_render", "sdf_bwd_ad", "sphere_render", "hist",
            "stochastic_round")
    scenes = generic_scenes()

    def build_scene(name):
        # the scene's first use: one trace, then one nvcc
        t_start = time.perf_counter()
        scenes[name][0].kernels.lib
        return time.perf_counter() - t_start

    with concurrent.futures.ThreadPoolExecutor(len(libs)
                                               + len(scenes)) as pool:
        # one nvcc per source, all at once
        built = pool.map(_build.build, libs)
        first_use = dict(zip(scenes, pool.map(build_scene, scenes)))
        list(built)
    for name in libs:
        _build.load(name)
    log(f"build: {', '.join(f'{n}.cu' for n in libs)} and the generated "
        f"sources of {len(scenes)} scenes with nvcc "
        f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.2f} s")

    def cuda_vec(seed):
        return torch.from_numpy(scene_vec(seed)).to(dev)

    # -- phase 1: sdf_fwd against its plain version ------------------------
    fwd_err, flip_shares = 0.0, []
    for seed in SEEDS:
        p = cuda_vec(seed)
        img_k, ts_k = K.sdf_fwd(p, N, STEPS, EXTENT)
        img_p, ts_p = K.sdf_fwd_plain(p, N, STEPS, EXTENT)
        torch.cuda.synchronize()
        check(img_k.shape == (N, N) and torch.isfinite(img_k).all().item()
              and torch.isfinite(ts_k).all().item(),
              "sdf_fwd: non-finite output")
        d = (img_k - img_p).abs()
        dmax = d.max().item()
        hit_k, hit_p = ts_k >= 0, ts_p >= 0
        mask_flips = (hit_k != hit_p).sum().item()
        both = hit_k & hit_p
        dt = (ts_k - ts_p).abs()[both].max().item() if both.any() else 0.0
        fwd_err = max(fwd_err, dmax)
        if mask_flips == 0:
            gate = f"image atol 1e-3 (max {dmax:.3e})"
            ok = dmax <= 1e-3
            flip_shares.append(0.0)
        else:
            # silhouette pixels flipped: bench.py:209-212's gate, where a
            # hit/miss flip jumps by ~gain
            flips = d > 1.0
            share = flips.float().mean().item()
            off = d[~flips].max().item()
            flip_shares.append(share)
            gate = f"flip share {share:.3e} < 1.5e-3, off-flip max {off:.3e}"
            ok = share < 1.5e-3 and off < 0.05
        log(f"phase 1 sdf_fwd scene={seed}: max|img-plain| {dmax:.3e}, "
            f"hit-mask flips {mask_flips}, max|dt| on shared hits {dt:.3e},"
            f" hits {hit_k.sum().item()}; gate: {gate}: "
            f"{'pass' if ok else 'FAIL'}")
        check(ok, f"sdf_fwd vs plain (scene {seed}): {gate}")

    # -- phase 2: sdf_bwd against its plain version, determinism ----------
    bwd_err = bwd_cases(torch, dev, "phase 2", lambda p, g, ts, n: (
        K.sdf_bwd(p, g, ts, n, EXTENT), K.sdf_bwd(p, g, ts, n, EXTENT),
        {"plain": K.sdf_bwd_plain(p, g, ts, n, EXTENT)}), cuda_vec)

    # -- phase 3: the main path, counted -----------------------------------
    model = K.SDFRender(cuda_vec(None), n=N, n_steps=STEPS, extent=EXTENT)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    reset_launch_counts()
    for step in range(TRAIN_STEPS):
        opt.zero_grad()
        img = model()
        loss = img.mean()
        loss.backward()
        grad = model.params.grad.detach().clone()
        scene = K.vec_to_scene(model.params.detach(), SDFScene)
        img_x, g_x = render_sdf_grads_implicit(scene, N, STEPS)
        gx = K.scene_to_vec(g_x)[:9]
        lx = img_x.mean().item()
        torch.cuda.synchronize()
        check(img.shape == (N, N) and torch.isfinite(img).all().item()
              and torch.isfinite(grad).all().item(), "non-finite output")
        tol = 1e-3 * max(1.0, gx.abs().max().item())
        g_ok = bool(torch.allclose(grad[:9], gx, rtol=1e-2, atol=tol))
        l_ok = abs(loss.item() - lx) <= 1e-5 + 1e-3 * abs(lx)
        log(f"phase 3 step {step}: loss {loss.item():.7g} (twin {lx:.7g}),"
            f" max|grad-twin| {(grad[:9] - gx).abs().max().item():.3e} "
            f"(atol {tol:.3e}); gates: loss rtol 1e-3 "
            f"{'pass' if l_ok else 'FAIL'}, grad rtol 1e-2 "
            f"{'pass' if g_ok else 'FAIL'}")
        check(l_ok and g_ok, f"main path vs twin at step {step}")
        opt.step()
    launches = dict(LAUNCHES)
    log(f"phase 3 launches over {TRAIN_STEPS} steps: {launches}")
    check(launches == {k: TRAIN_STEPS for k in ("sdf_fwd", "sdf_bwd")},
          f"expected one launch of each kernel per step, got {launches}")

    # -- phase 4: timing ----------------------------------------------------
    rays = N * N
    timer = DeviceTimer(torch)
    p_ref = cuda_vec(None)

    def kernel_step(p0, p, k):
        p = p.detach().requires_grad_(True)
        loss = K.render_sdf_cuda(p, N, STEPS, EXTENT, min(128, N),
                                 coarse=0).mean()
        (g,) = torch.autograd.grad(loss, p)
        return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k

    def twin_step(p0, p, k):
        img, g = render_sdf_grads_implicit(K.vec_to_scene(p, SDFScene), N,
                                           STEPS)
        gsum = K.scene_to_vec(g).sum()
        return p0 + (img.mean() + 1e-12 * gsum) * 1e-12 + 1e-6 * k

    # interleaved: kernel, twin, twin, kernel
    t_k1, sp_k1 = chain_ms(torch, kernel_step, p_ref, 100, 7)
    t_x1, sp_x1 = chain_ms(torch, twin_step, p_ref, 5, 3)
    t_x2, sp_x2 = chain_ms(torch, twin_step, p_ref, 5, 3)
    t_k2, sp_k2 = chain_ms(torch, kernel_step, p_ref, 100, 7)
    t_k, t_x = min(t_k1, t_k2), min(t_x1, t_x2)
    log(f"phase 4 fwd+bwd step (chained, median of windows): kernels "
        f"{t_k1:.4f} / {t_k2:.4f} ms (spread {sp_k1:.2%} / {sp_k2:.2%}), "
        f"twin {t_x1:.3f} / {t_x2:.3f} ms (spread {sp_x1:.2%} / "
        f"{sp_x2:.2%})")
    by_kernel = device_ms_by_kernel(torch, kernel_step, p_ref, 50)
    busy_ms = sum(by_kernel.values())
    busy = busy_ms / t_k if by_kernel else None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    log("phase 4 device time per fwd+bwd step (torch.profiler): "
        + (f"{busy_ms:.5f} ms of {t_k:.4f} ms, busy share {busy:.4f}; "
           + ", ".join(f"{k[:48]} {v:.5f} ms" for k, v in top)
           if by_kernel else "not measured (no device events)"))

    _, ts_ref = K.sdf_fwd(p_ref, N, STEPS, EXTENT)
    g_ref = torch.full((N, N), 1.0 / rays, device=dev)
    fwd_ms = timer(lambda: K.sdf_fwd(p_ref, N, STEPS, EXTENT), 200)
    bwd_ms = timed_bwd(torch, timer, "sdf_bwd", lambda: K.sdf_bwd(
        p_ref, g_ref, ts_ref, N, EXTENT), K.bwd_vector_loads(g_ref, ts_ref, N))
    fwd_plain_ms = timer(lambda: K.sdf_fwd_plain(p_ref, N, STEPS, EXTENT),
                         5, hold_ms=1000.0, plain=True)
    bwd_plain_ms = timer(lambda: K.sdf_bwd_plain(p_ref, g_ref, ts_ref, N,
                                                 EXTENT), 20,
                         hold_ms=1000.0, plain=True)

    # bounds from this run's data: the march work is what this scene needs
    evals, adv = (int(c.sum().item())
                  for c in K.march_counts(p_ref, N, STEPS, EXTENT))
    hits = int((ts_ref >= 0).sum().item())
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    mufu_per_s = MUFU_PER_CLK_PER_SM * props.multi_processor_count \
        * sm_mhz * 1e6

    # fwd reads the 16 params and writes img + ts; bwd reads params, g
    # and ts and writes dp[16]. A lane at the step cap skips the freeze
    # test of its last evaluation; counted with it
    fwd_bound, fwd_by = bound(
        8 * rays + 64,
        FWD_FLOPS_PER_EVAL * evals + FWD_FLOPS_PER_ADVANCE * adv
        + (FWD_FLOPS_PER_PIXEL + FWD_FLOPS_HIT_TEST) * rays
        + FWD_FLOPS_PER_HIT * hits)
    bwd_bound, bwd_by = bound(8 * rays + 64 + 64,
                              BWD_FLOPS_PER_HIT * hits
                              + BWD_FLOPS_PER_PIXEL * rays)
    fwd_mufu_ms = 1e3 * (evals + 2 * hits) / mufu_per_s
    log(f"phase 4 work: {evals} march distance evaluations "
        f"({evals / rays:.3f} per pixel) and {adv} advances, counted by "
        f"the plain version; {hits} hit pixels; "
        f"{props.multi_processor_count} SMs, max SM clock {sm_mhz:.0f} MHz,"
        f" MUFU peak {mufu_per_s:.4g} rsqrt/s")
    log(f"phase 4 sdf_fwd {fwd_ms:.5f} ms (plain {fwd_plain_ms:.4f} ms, "
        f"bound {fwd_bound:.5f} ms by {fwd_by}, MUFU rsqrt floor "
        f"{fwd_mufu_ms:.5f} ms); sdf_bwd {bwd_ms:.5f} ms (plain "
        f"{bwd_plain_ms:.4f} ms, bound {bwd_bound:.5f} ms by {bwd_by}); "
        f"library call: none computes either function")

    result = {
        "metric": "rays_per_s_per_chip_fwd_bwd",
        "value": rays / (t_k * 1e-3),
        "unit": "rays/s",
        "vs_baseline": t_x / t_k,
        "spread_pct": 100.0 * max(sp_k1, sp_k2),
        "baseline": "plain PyTorch twin (render.sdf, implicit backward)",
        "baseline_rays_per_s": rays / (t_x * 1e-3),
        "step_ms": t_k, "baseline_step_ms": t_x,
        "n": N, "n_steps": STEPS, "card": smi,
        "fwd_flip_share_max": max(flip_shares),
        "device_busy_share": busy,
    }
    log(json.dumps(result))
    common = {"route": "cuda", "source": "enoki_tpu_torch/csrc/sdf_render.cu",
              "library_ms": None}
    kernels = [
        dict(name="sdf_fwd",
             replaces="enoki_tpu/render/pallas_kernels.py:504",
             launches=launches["sdf_fwd"], max_abs_err=fwd_err,
             ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_bound,
             bound_by=fwd_by, **common),
        dict(name="sdf_bwd",
             replaces="enoki_tpu/render/pallas_kernels.py:772",
             launches=launches["sdf_bwd"], max_abs_err=bwd_err,
             ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_bound,
             bound_by=bwd_by, **common),
    ]
    kernels += run_sphere(torch, dev, timer, cuda_vec)
    kernels += run_sdf_options(torch, dev, timer, cuda_vec)
    kernels += run_generic(torch, dev, timer, scenes, first_use)
    kernels += run_hist(torch, dev, timer)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


def run_sphere(torch, dev, timer, cuda_vec):
    """Phases 5-8: the closed-form sphere path. Returns its kernels'
    entries of the kernels line."""
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import (LAUNCHES, reset_launch_counts,
                                        sphere as TS, sphere_kernels as S)
    from enoki_tpu_torch.render.sdf_kernels import (scene_to_vec,
                                                    tile_pixels,
                                                    vec_to_scene)
    from enoki_tpu_torch.render.vec import Vec2

    f32, bf16 = torch.float32, torch.bfloat16

    # -- phase 5: sphere_fwd (f32, bf16) against its plain version ---------
    # at the backward's sizes: one vector store a thread at N and 1000 (a
    # row is whole vectors in both dtypes), single stores at 257
    fwd_err = {f32: 0.0, bf16: 0.0}
    for n in BWD_SIZES:
        for seed in SEEDS + ("all-miss",):
            p = cuda_vec(1 if seed == "all-miss" else seed)
            if seed == "all-miss":
                p[0] += 10.0  # the sphere leaves the frame
            for dtype in (f32, bf16):
                img_k = S.sphere_fwd(p, n, EXTENT, dtype)
                img_p = S.sphere_fwd_plain(p, n, EXTENT, dtype)
                torch.cuda.synchronize()
                what = (f"phase 5 sphere_fwd {str(dtype)[6:]} n={n} "
                        f"scene={seed}")
                check(img_k.shape == (n, n) and img_k.dtype == dtype
                      and torch.isfinite(img_k).all().item(),
                      f"{what}: bad output")
                vec = S.fwd_vector_stores(img_k, n)
                check(vec == (n != 257), f"{what}: vector stores {vec}, "
                      f"expected {n != 257}")
                d = (img_k.float() - img_p.float()).abs()
                fwd_err[dtype] = max(fwd_err[dtype], d.max().item())
                ok = torch.equal(img_k, img_p)
                log(f"{what} ({'vector' if vec else 'single'} stores): "
                    f"max|img-plain| {d.max().item():.3e}, pixels differing "
                    f"{(d > 0).sum().item()}; gate: bit-equal: "
                    f"{'pass' if ok else 'FAIL'}")
                check(ok, f"{what}: not bit-equal to the plain version")

    # -- phase 6: sphere_bwd against its plain version, determinism --------
    bwd_err = bwd_cases(torch, dev, "phase 6 sphere_bwd",
                        lambda p, g, ts, n: (
                            S.sphere_bwd(p, g, n, EXTENT),
                            S.sphere_bwd(p, g, n, EXTENT),
                            {"plain": S.sphere_bwd_plain(p, g, n, EXTENT)}),
                        cuda_vec, lambda g, ts, n: S.bwd_vector_loads(g, n))

    # -- phase 7: the sphere path, counted ---------------------------------
    model = S.SphereRender(cuda_vec(None), n=N, extent=EXTENT)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    reset_launch_counts()
    for step in range(TRAIN_STEPS):
        opt.zero_grad()
        img = model()
        loss = img.mean()
        loss.backward()
        grad = model.params.grad.detach().clone()
        img_x, g_x = TS.render_and_grads(
            vec_to_scene(model.params.detach(), TS.SphereScene), N)
        gx = scene_to_vec(g_x)[:9]
        lx = img_x.mean().item()
        torch.cuda.synchronize()
        check(img.shape == (N, N) and torch.isfinite(img).all().item()
              and torch.isfinite(grad).all().item(), "non-finite output")
        tol = 1e-3 * max(1.0, gx.abs().max().item())
        g_ok = bool(torch.allclose(grad[:9], gx, rtol=1e-2, atol=tol))
        l_ok = abs(loss.item() - lx) <= 1e-5 + 1e-3 * abs(lx)
        log(f"phase 7 f32 step {step}: loss {loss.item():.7g} (twin "
            f"{lx:.7g}), max|grad-twin| "
            f"{(grad[:9] - gx).abs().max().item():.3e} (atol {tol:.3e}); "
            f"gates: loss rtol 1e-3 {'pass' if l_ok else 'FAIL'}, grad "
            f"rtol 1e-2 {'pass' if g_ok else 'FAIL'}")
        check(l_ok and g_ok, f"sphere path vs twin at step {step}")
        if step == TRAIN_STEPS - 1:
            # one bf16 step at these parameters: its backward is the f32
            # render's, so its gradient is this step's, bit for bit
            model_b = S.SphereRender(model.params.detach(), n=N,
                                     extent=EXTENT, dtype=bf16)
            img_b = model_b()
            loss_b = img_b.mean()
            loss_b.backward()
            torch.cuda.synchronize()
            gb = model_b.params.grad
            b_ok = (img_b.dtype == bf16 and torch.isfinite(gb).all().item()
                    and torch.equal(gb, model.params.grad))
            log(f"phase 7 bf16 step: loss {loss_b.item():.7g} (f32 "
                f"{loss.item():.7g}), gradient equal to the f32 step's: "
                f"{'pass' if b_ok else 'FAIL'}")
            check(b_ok, "bf16 step's gradient differs from the f32 step's")
        opt.step()
    launches = dict(LAUNCHES)
    want = {"sphere_fwd": TRAIN_STEPS, "sphere_fwd_bf16": 1,
            "sphere_bwd": TRAIN_STEPS + 1}
    log(f"phase 7 launches over {TRAIN_STEPS} f32 steps and 1 bf16 step: "
        f"{launches}")
    check(launches == want, f"expected {want}, got {launches}")

    # -- phase 8: timing ----------------------------------------------------
    rays = N * N
    p_ref = cuda_vec(None)
    g_mean = torch.full((N, N), 1.0 / rays, device=dev)
    ms = {k: timer(fn, 200) for k, fn in (
        ("sphere_fwd", lambda: S.sphere_fwd(p_ref, N, EXTENT, f32)),
        ("sphere_fwd_bf16", lambda: S.sphere_fwd(p_ref, N, EXTENT, bf16)))}
    ms["sphere_bwd"] = timed_bwd(
        torch, timer, "phase 8 sphere_bwd",
        lambda: S.sphere_bwd(p_ref, g_mean, N, EXTENT),
        S.bwd_vector_loads(g_mean, N))
    plain_ms = {k: timer(fn, 20, hold_ms=1000.0, plain=True) for k, fn in (
        ("sphere_fwd", lambda: S.sphere_fwd_plain(p_ref, N, EXTENT, f32)),
        ("sphere_fwd_bf16",
         lambda: S.sphere_fwd_plain(p_ref, N, EXTENT, bf16)),
        ("sphere_bwd", lambda: S.sphere_bwd_plain(p_ref, g_mean, N,
                                                  EXTENT)))}
    scene_ref = vec_to_scene(p_ref, TS.SphereScene)
    staged_ms = timer(lambda: TS.render_staged(scene_ref, N), 20,
                      hold_ms=1000.0, plain=True)

    # the hits of this run's scene, as the f32 forward decides them
    px, py = tile_pixels(N, EXTENT, dev)
    nrm = TS.intersect_rays(TS.make_rays(Vec2(px, py)), scene_ref)
    hits = int(((nrm.x != 0) | (nrm.y != 0) | (nrm.z != 0)).sum().item())
    bounds = {
        # write the image (4 or 2 B per pixel), read the 64 B parameters
        "sphere_fwd": bound(4 * rays + 64, SPHERE_FWD_FLOPS_PER_PIXEL * rays),
        "sphere_fwd_bf16": bound(2 * rays + 64, 0,
                                 SPHERE_FWD_FLOPS_PER_PIXEL * rays),
        # read g and the parameters, write dp[16]
        "sphere_bwd": bound(4 * rays + 64 + 64,
                            SPHERE_BWD_FLOPS_PER_PIXEL * rays
                            + SPHERE_BWD_FLOPS_PER_HIT * hits),
    }
    for k in ms:
        log(f"phase 8 {k} {ms[k]:.5f} ms (plain {plain_ms[k]:.4f} ms, "
            f"bound {bounds[k][0]:.5f} ms by {bounds[k][1]})")
    log(f"phase 8 work: {hits} hit pixels of {rays}; library call: none "
        f"computes any of these functions")
    # the routes, registers and whole-kernel issue floors (derived, for
    # the record): the fewest SASS instructions a warp of these
    # straight-line kernels issues (path_counts) x their warps, over the
    # card's issue rate
    lib_path = _build.build("sphere_render")
    sass = sass_of(lib_path)
    rate, rate_text = issue_rate(torch)
    geometry = source_constants("sphere_render.cu", "kFwdThreads",
                                "kFwdPixels", "kSphereSumThreads",
                                "kSphereSumPixels")
    fwd_geometry = (geometry["kFwdThreads"], geometry["kFwdPixels"])
    img_f = S.sphere_fwd(p_ref, N, EXTENT, f32)
    img_b = S.sphere_fwd(p_ref, N, EXTENT, bf16)
    log(f"phase 8 routes at {N}^2: sphere_fwd "
        + ("one 16-byte store a thread" if S.fwd_vector_stores(img_f, N)
           else "single stores")
        + ", sphere_fwd_bf16 "
        + ("one 8-byte store a thread" if S.fwd_vector_stores(img_b, N)
           else "single stores")
        + ", sphere_bwd "
        + ("float4" if S.bwd_vector_loads(g_mean, N) else "single-float")
        + " loads of g")
    for name, fn, (threads, pixels) in (
            ("sphere_fwd", "sphere_fwd_kernelIf", fwd_geometry),
            ("sphere_fwd_bf16", "sphere_fwd_kernelI13__nv_bfloat16",
             fwd_geometry),
            ("sphere_bwd", "SpherePixel",
             (geometry["kSphereSumThreads"], geometry["kSphereSumPixels"]))):
        laid_out, fewest = path_counts(sass, fn)
        warps = N * -(-N // (threads * pixels)) * -(-threads // 32)
        floor_ms = 1e3 * fewest * warps / rate
        log(f"phase 8 {name} issue floor (derived, not measured): "
            f"blocks of {threads} threads x {pixels} pixels a thread, "
            f"{warps} warps x {fewest} SASS instructions on its shortest "
            f"path ({laid_out} laid out; cuobjdump) over {rate_text} = "
            f"{floor_ms:.5f} ms, {floor_ms / ms[name]:.4f} of the measured "
            f"{ms[name]:.5f} ms (bound {bounds[name][0]:.5f} ms by "
            f"{bounds[name][1]}); ptxas: " + resources_text(lib_path, (fn,)))
    log(f"phase 8 mini-app contrast (device time per frame): "
        f"render_staged (separate kernels) {staged_ms:.4f} ms, one "
        f"sphere_fwd launch {ms['sphere_fwd']:.5f} ms, "
        f"{staged_ms / ms['sphere_fwd']:.1f}x")

    def kernel_step(p0, p, k):
        with torch.no_grad():
            model.params.copy_(p)
        model.params.grad = None
        loss = model().mean()
        loss.backward()
        g = model.params.grad
        return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k

    def twin_step(p0, p, k):
        img, g = TS.render_and_grads(vec_to_scene(p, TS.SphereScene), N)
        gsum = scene_to_vec(g).sum()
        return p0 + (img.mean() + 1e-12 * gsum) * 1e-12 + 1e-6 * k

    # interleaved: kernel, twin, twin, kernel
    t_k1, sp_k1 = chain_ms(torch, kernel_step, p_ref, 100, 7)
    t_x1, sp_x1 = chain_ms(torch, twin_step, p_ref, 10, 3)
    t_x2, sp_x2 = chain_ms(torch, twin_step, p_ref, 10, 3)
    t_k2, sp_k2 = chain_ms(torch, kernel_step, p_ref, 100, 7)
    t_k, t_x = min(t_k1, t_k2), min(t_x1, t_x2)
    log(f"phase 8 sphere fwd+bwd step through SphereRender (chained, "
        f"median of windows): kernels {t_k1:.4f} / {t_k2:.4f} ms (spread "
        f"{sp_k1:.2%} / {sp_k2:.2%}), twin {t_x1:.3f} / {t_x2:.3f} ms "
        f"(spread {sp_x1:.2%} / {sp_x2:.2%}); {rays / (t_k * 1e-3):.4g} "
        f"rays/s, {t_x / t_k:.2f}x the twin")
    by_kernel = device_ms_by_kernel(torch, kernel_step, p_ref, 50)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    log("phase 8 device time per sphere fwd+bwd step (torch.profiler): "
        + (f"{busy_ms:.5f} ms of {t_k:.4f} ms, busy share "
           f"{busy_ms / t_k:.4f}; "
           + ", ".join(f"{k[:48]} {v:.5f} ms" for k, v in top)
           if by_kernel else "not measured (no device events)"))

    common = {"route": "cuda",
              "source": "enoki_tpu_torch/csrc/sphere_render.cu",
              "library_ms": None}
    fwd_line = "enoki_tpu/render/pallas_kernels.py:100"
    return [
        dict(name="sphere_fwd", replaces=fwd_line,
             launches=launches["sphere_fwd"], max_abs_err=fwd_err[f32],
             ms=ms["sphere_fwd"], plain_ms=plain_ms["sphere_fwd"],
             bound_ms=bounds["sphere_fwd"][0],
             bound_by=bounds["sphere_fwd"][1], **common),
        dict(name="sphere_fwd_bf16", replaces=fwd_line,
             launches=launches["sphere_fwd_bf16"],
             max_abs_err=fwd_err[bf16], ms=ms["sphere_fwd_bf16"],
             plain_ms=plain_ms["sphere_fwd_bf16"],
             bound_ms=bounds["sphere_fwd_bf16"][0],
             bound_by=bounds["sphere_fwd_bf16"][1], **common),
        dict(name="sphere_bwd",
             replaces="enoki_tpu/render/pallas_kernels.py:108",
             launches=launches["sphere_bwd"], max_abs_err=bwd_err,
             ms=ms["sphere_bwd"], plain_ms=plain_ms["sphere_bwd"],
             bound_ms=bounds["sphere_bwd"][0],
             bound_by=bounds["sphere_bwd"][1], **common),
    ]


def flip_gate(d, what):
    """The gate of a kernel against its plain version where they are not
    bit-equal (bench.py:209-212): a hit/miss flip jumps by ~gain; the
    flips' share stays under 1.5e-3 and every other pixel within 0.05."""
    flips = d > 1.0
    share = flips.float().mean().item()
    off = d[~flips].max().item()
    ok = share < 1.5e-3 and off < 0.05
    log(f"{what}: {(d > 0).sum().item()} pixels differ, flip share "
        f"{share:.3e} < 1.5e-3, off-flip max {off:.3e} < 0.05: "
        f"{'pass' if ok else 'FAIL'}")
    check(ok, f"{what}: flip gate")


def run_sdf_options(torch, dev, timer, cuda_vec):
    """Phases 9-12: every option of the SDF render. Returns its kernels'
    entries of the kernels line."""
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import (LAUNCHES, reset_launch_counts,
                                        sdf_kernels as K)
    from enoki_tpu_torch.render.sdf import (SDFScene, march,
                                            render_sdf_grads_implicit)
    from enoki_tpu_torch.render.sphere import make_rays, pixel_grid

    f32, bf16 = torch.float32, torch.bfloat16
    rays = N * N
    g_rand = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(dev)
    err = {}  # max |kernel - plain| by kernel name

    def worst(name, value):
        err[name] = max(err.get(name, 0.0), value)

    # -- phase 9: the further sdf_fwd instantiations -----------------------
    variants = (
        ("start map", dict(cone=True)),
        ("bf16", dict(dtype=bf16)),
        ("bf16 + start map", dict(cone=True, dtype=bf16)),
        ("relax 1.6 + unimodal", dict(relax=1.6, unimodal=True)),
        ("relax 1.6 + unimodal + start map",
         dict(cone=True, relax=1.6, unimodal=True)),
        ("unimodal", dict(unimodal=True)),
        ("relax 1.2", dict(relax=1.2)),
        ("bf16 + relax 1.6 + unimodal + start map",
         dict(cone=True, dtype=bf16, relax=1.6, unimodal=True)),
    )
    for seed in SEEDS:
        p = cuda_vec(seed)
        t0 = K._cone_t0(p, N, STEPS, EXTENT, 8)
        # conservative: no start lies past the closed-form first hit of
        # the sphere along the ray from z = -1 (tests/test_pallas.py:130);
        # a ray that starts inside the sphere hits at t = 0
        px, py = K.tile_pixels(N, EXTENT, dev)
        pd = p.double()
        r2 = (px.double() - pd[0]) ** 2 + (py.double() - pd[1]) ** 2
        t_hit = torch.where(
            r2 < pd[3] ** 2,
            torch.clamp_min((pd[2] + 1.0) - torch.sqrt(
                torch.clamp_min(pd[3] ** 2 - r2, 0.0)), 0.0),
            torch.inf)
        over = (t0.double() - t_hit).max().item()
        log(f"phase 9 scene={seed}: start map max(t0 - t_hit) {over:.3e} "
            f"<= 1e-5: {'pass' if over <= 1e-5 else 'FAIL'}")
        check(over <= 1e-5, f"cone prepass not conservative (scene {seed})")
        for label, kw in variants:
            kw = dict(kw)
            start = t0 if kw.pop("cone", False) else None
            name = K.fwd_kernel_name(kw.get("dtype", f32),
                                     kw.get("relax", 1.0),
                                     kw.get("unimodal", False))
            img_k, ts_k = K.sdf_fwd(p, N, STEPS, EXTENT, start, **kw)
            img_p, ts_p = K.sdf_fwd_plain(p, N, STEPS, EXTENT, start, **kw)
            torch.cuda.synchronize()
            check(torch.isfinite(img_k).all().item()
                  and torch.isfinite(ts_k).all().item(),
                  f"{name}: non-finite output")
            d = (img_k - img_p).abs()
            worst(name, d.max().item())
            what = f"phase 9 {name} ({label}) scene={seed}"
            if torch.equal(img_k, img_p) and torch.equal(ts_k, ts_p):
                log(f"{what}: img and ts bit-equal to plain, hits "
                    f"{(ts_k >= 0).sum().item()}: pass")
            else:
                log(f"{what}: ts differs on "
                    f"{(ts_k != ts_p).sum().item()} pixels")
                flip_gate(d, what)
        pg = p.clone().requires_grad_(True)
        img1 = K.render_sdf_cuda(pg, N, STEPS, EXTENT, min(64, N), None, 8, 16,
                                 f32, 1)
        img8 = K.render_sdf_cuda(pg, N, STEPS, EXTENT, min(64, N), None, 8, 16,
                                 f32, 8)
        torch.cuda.synchronize()
        check(torch.equal(img1, img8), f"bands=8 differs from bands=1 "
              f"(scene {seed})")
        log(f"phase 9 scene={seed}: bands=8 bit-equal to bands=1: pass")

    # the image edge: sizes that the kernels' warp tiles and blocks do not
    # divide, every pixel still covered once and bit-equal
    p = cuda_vec(None)
    for n in (1000, 257):
        starts = (None, K._cone_t0(p, n, STEPS, EXTENT, 8)) if n % 8 == 0 \
            else (None,)
        for start in starts:
            for kw in (dict(), dict(dtype=bf16),
                       dict(relax=1.6, unimodal=True),
                       dict(dtype=bf16, relax=1.6, unimodal=True)):
                name = K.fwd_kernel_name(kw.get("dtype", f32),
                                         kw.get("relax", 1.0),
                                         kw.get("unimodal", False))
                got = K.sdf_fwd(p, n, STEPS, EXTENT, start, **kw)
                want = K.sdf_fwd_plain(p, n, STEPS, EXTENT, start, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{name} at n={n} (start map: {start is not None}) "
                      f"differs from its plain version")
            got = K.sdf_split(p, n, STEPS, EXTENT, 16, start)
            one = K.sdf_fwd(p, n, STEPS, EXTENT, start)
            want = K.sdf_fwd_split_plain(p, n, 16, EXTENT, start)
            p1 = K.sdf_fwd_split(p, n, 16, EXTENT, start)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, one))
                  and all(torch.equal(a, b) for a, b in zip(p1, want)),
                  f"the split render at n={n} (start map: "
                  f"{start is not None}) differs")
        log(f"phase 9 n={n}: the four sdf_fwd instantiations "
            f"{'with and without the start map ' if n % 8 == 0 else ''}"
            f"bit-equal to plain, the split render to the one-pass render "
            f"and its pass 1 to plain: pass")

    # -- phase 10: the split render -----------------------------------------
    shares = {}
    for seed in SEEDS:
        p = cuda_vec(seed)
        t0 = K._cone_t0(p, N, STEPS, EXTENT, 8)
        for split, coarse in ((16, 0), (32, 0), (16, 8)):
            start = t0 if coarse else None
            one = K.sdf_fwd(p, N, STEPS, EXTENT, start)
            two = K.sdf_split(p, N, STEPS, EXTENT, split, start)
            p1 = K.sdf_fwd_split(p, N, split, EXTENT, start)
            p1_plain = K.sdf_fwd_split_plain(p, N, split, EXTENT, start)
            idx = K.survivors(p1[2])
            tail = K.sdf_tail(p, idx, p1[2], p1[0].clone(), p1[1].clone(),
                              N, STEPS, split, EXTENT)
            tail_plain = K.sdf_tail_plain(
                p, idx, p1_plain[2], p1_plain[0].clone(),
                p1_plain[1].clone(), N, STEPS, split, EXTENT)
            torch.cuda.synchronize()
            worst("sdf_fwd_split", (p1[0] - p1_plain[0]).abs().max().item())
            worst("sdf_tail", (tail[0] - tail_plain[0]).abs().max().item())
            share = idx.numel() / rays
            if seed is None:
                shares[(split, coarse)] = share
            same = all(torch.equal(a, b) for a, b in zip(one, two))
            p1_ok = all(torch.equal(a, b) for a, b in zip(p1, p1_plain))
            tail_ok = all(torch.equal(a, b) for a, b in zip(tail, tail_plain))
            log(f"phase 10 scene={seed} split={split} coarse={coarse}: "
                f"survivors {idx.numel()} ({share:.4%} of the pixels); img "
                f"and ts bit-equal to the one-pass kernel: "
                f"{'pass' if same else 'FAIL'}; pass 1 (img, ts, cont) "
                f"bit-equal to plain: {'pass' if p1_ok else 'FAIL'}; tail "
                f"bit-equal to plain: {'pass' if tail_ok else 'FAIL'}")
            check(same, f"split render differs from one pass (scene {seed}, "
                  f"split {split}, coarse {coarse})")
            if not p1_ok:
                flip_gate((p1[0] - p1_plain[0]).abs(), "phase 10 pass 1")
            if not tail_ok:
                flip_gate((tail[0] - tail_plain[0]).abs(), "phase 10 tail")

    # -- phase 11: sdf_bwd_ad against both routes, determinism -------------
    err["sdf_bwd_ad"] = bwd_cases(torch, dev, "phase 11", lambda p, g, ts, n: (
        K.sdf_bwd(p, g, ts, n, EXTENT, kernel="ad"),
        K.sdf_bwd(p, g, ts, n, EXTENT, kernel="ad"),
        {"plain": K.sdf_bwd_ad_plain(p, g, ts, n, EXTENT),
         "sdf_bwd": K.sdf_bwd(p, g, ts, n, EXTENT)}), cuda_vec)

    # -- phase 12: the options' path, counted -------------------------------
    launches = {}

    def count(name, value):
        launches[name] = launches.get(name, 0) + value

    def twin(params):
        """The plain twin's image, hit mask and gradient at ``params``."""
        scene = K.vec_to_scene(params.detach(), SDFScene)
        img_x, g_x = render_sdf_grads_implicit(scene, N, STEPS)
        _, hit_x = march(make_rays(pixel_grid(N, device=dev)), scene, STEPS)
        return (img_x.reshape(N, N), hit_x.reshape(N, N),
                K.scene_to_vec(g_x)[:9])

    def significant_rel(g, ref):
        sig = ref.abs() > 1e-3 * ref.abs().max()
        return ((g - ref).abs()[sig] / ref.abs()[sig]).max().item()

    # SDFRender(coarse=8), the reference's default configuration, trained
    # on each scene; the counts are zeroed before each step's forward and
    # read after its backward, so the gate's own launches stay out of them
    got = {}
    for seed in SEEDS:
        model = K.SDFRender(cuda_vec(seed), n=N, n_steps=STEPS,
                            extent=EXTENT, coarse=8)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        for step in range(TRAIN_STEPS):
            opt.zero_grad()
            reset_launch_counts()
            img = model()
            loss = img.mean()
            loss.backward()
            for k, v in LAUNCHES.items():
                got[k] = got.get(k, 0) + v
            img = img.detach()
            grad = model.params.grad.detach().clone()[:9]
            p_now = model.params.detach()
            img_x, hit_x, gx = twin(p_now)
            # the path's hit mask: the forward kernel again on the same
            # start map, whose image must be the path's bit for bit
            img_k, ts_k = K.sdf_fwd(p_now, N, STEPS, EXTENT,
                                    K._cone_t0(p_now, N, STEPS, EXTENT, 8))
            torch.cuda.synchronize()
            check(img.shape == (N, N) and torch.isfinite(img).all().item()
                  and torch.isfinite(grad).all().item(), "non-finite output")
            check(torch.equal(img_k, img), "sdf_fwd is not repeatable")
            # head-start gates (tests/test_pallas.py:94-111, :168-169). A
            # flip is a hit/miss disagreement. The reference reads it off
            # the image as |d| > 1, which at this size misses the flips
            # whose lit side is dim (n . l ~ 0 at two points of the
            # silhouette) and files them under off-flip. Here a pixel is a
            # flip if |d| > 1, or if the two hit masks differ and the
            # images with them; every such pixel counts in the gated
            # share. A flip on the unlit half of the silhouette changes no
            # pixel (ambient on both sides): the share of all mask
            # disagreements is printed, and so is the off-flip maximum as
            # the reference reads it.
            d = (img - img_x).abs()
            by_image = d > 1.0
            by_mask = (ts_k >= 0) != hit_x
            flips = by_image | (by_mask & (d > 0.0))
            share = flips.float().mean().item()
            off_max, off_mean = (d[~flips].max().item(),
                                 d[~flips].mean().item())
            tol = 2e-3 * max(1.0, gx.abs().max().item())
            i_ok = share < 1e-3 and off_max < 0.05 and off_mean < 5e-3
            g_ok = bool(torch.allclose(grad, gx, rtol=5e-2, atol=tol))
            g_rel = significant_rel(grad, gx)
            log(f"phase 12 SDFRender(coarse=8) scene={seed} step {step}: "
                f"loss {loss.item():.7g} (twin {img_x.mean().item():.7g}); "
                f"flip share {share:.3e} < 1e-3 (by |d| > 1 alone "
                f"{by_image.float().mean().item():.3e}, hit masks differ on "
                f"{by_mask.float().mean().item():.3e}), off-flip max "
                f"{off_max:.3e} < 0.05 (by |d| > 1 alone "
                f"{d[~by_image].max().item():.3e}), mean {off_mean:.3e} < "
                f"5e-3: {'pass' if i_ok else 'FAIL'}; max|grad-twin| "
                f"{(grad - gx).abs().max().item():.3e} (rtol 5e-2, atol "
                f"{tol:.3e}; largest relative error of a significant "
                f"gradient {g_rel:.4f}): {'pass' if g_ok else 'FAIL'}")
            check(i_ok and g_ok,
                  f"SDFRender(coarse=8) vs twin, scene {seed}, step {step}")
            opt.step()
    steps_run = TRAIN_STEPS * len(SEEDS)
    log(f"phase 12 SDFRender(coarse=8) launches over {steps_run} steps: "
        f"{got}")
    check(got == {k: steps_run for k in ("sdf_fwd", "sdf_bwd")},
          f"expected one launch of each kernel per step, got {got}")

    # one fwd+bwd step of each other option at the reference scene, against
    # the plain configuration's step
    p_ref = cuda_vec(None)
    base = K.SDFRender(p_ref, n=N, n_steps=STEPS, extent=EXTENT)
    img0 = base()
    img0.mean().backward()
    g0 = base.params.grad[:9].clone()
    img0 = img0.detach()
    others = (
        ("bf16", dict(dtype=bf16), {"sdf_fwd_bf16": 1, "sdf_bwd": 1}),
        ("relax 1.6 + unimodal", dict(relax=1.6, unimodal=True),
         {"sdf_fwd_relax": 1, "sdf_bwd": 1}),
        ("bf16 + relax 1.6 + unimodal",
         dict(dtype=bf16, relax=1.6, unimodal=True),
         {"sdf_fwd_relax_bf16": 1, "sdf_bwd": 1}),
        ("split 16", dict(split=16),
         {"sdf_fwd_split": 1, "sdf_tail": 1, "sdf_bwd": 1}),
        ('bwd_kernel="ad"', dict(bwd_kernel="ad"),
         {"sdf_fwd": 1, "sdf_bwd_ad": 1}),
    )
    for label, kw, want in others:
        m = K.SDFRender(p_ref, n=N, n_steps=STEPS, extent=EXTENT, **kw)
        reset_launch_counts()
        img = m()
        img.mean().backward()
        torch.cuda.synchronize()
        got = dict(LAUNCHES)
        for k, v in got.items():
            count(k, v)
        g = m.params.grad[:9]
        check(torch.isfinite(img).all().item()
              and torch.isfinite(g).all().item(), f"{label}: non-finite")
        check(got == want, f"{label}: expected {want}, got {got}")
        d = (img.detach() - img0).abs()
        band = d > 1.0
        share = band.float().mean().item()
        off_mean = d[~band].mean().item()
        if kw.get("dtype") == bf16:
            # the bf16 policy (tests/test_pallas.py:188-218)
            rel = significant_rel(g, g0)
            ok = share < 0.10 and off_mean < 2e-3 and rel < 0.5
            gate = (f"band share {share:.3e} < 0.10, off-band mean "
                    f"{off_mean:.3e} < 2e-3, significant gradients within "
                    f"{rel:.3f} < 0.5 of f32's")
        elif "relax" in kw:
            # relaxed against plain (tests/test_pallas.py:451-477)
            rel = significant_rel(g, g0)
            ok = share < 0.01 and off_mean < 1e-3 and rel < 0.5
            gate = (f"flip share {share:.3e} < 0.01, off-flip mean "
                    f"{off_mean:.3e} < 1e-3, significant gradients within "
                    f"{rel:.3f} < 0.5 of plain's")
        elif "split" in kw:
            ok = torch.equal(img.detach(), img0) and torch.equal(g, g0)
            gate = "image and gradient bit-equal to the one-pass step's"
        else:
            tol = 2e-4 * max(1.0, g0.abs().max().item())
            ok = (torch.equal(img.detach(), img0)
                  and bool(torch.allclose(g, g0, rtol=2e-4, atol=tol)))
            gate = (f"image bit-equal, max|grad - analytic| "
                    f"{(g - g0).abs().max().item():.3e} (rtol 2e-4, atol "
                    f"{tol:.3e})")
        log(f"phase 12 one step, {label}: loss {img.mean().item():.7g} "
            f"(plain {img0.mean().item():.7g}), launches {got}; gate: "
            f"{gate}: {'pass' if ok else 'FAIL'}")
        check(ok, f"one step with {label}: {gate}")

    # -- phase 12: timing -----------------------------------------------------
    g_mean = torch.full((N, N), 1.0 / rays, device=dev)
    t0 = K._cone_t0(p_ref, N, STEPS, EXTENT, 8)
    _, ts_ref = K.sdf_fwd(p_ref, N, STEPS, EXTENT)
    hits = int((ts_ref >= 0).sum().item())
    relax_kw = dict(relax=1.6, unimodal=True)

    def counts(n_steps=STEPS, **kw):
        return tuple(int(c.sum().item()) for c in
                     K.march_counts(p_ref, N, n_steps, EXTENT, **kw))

    def shade_flops(extra=0):
        return (FWD_FLOPS_PER_PIXEL + extra) * rays + FWD_FLOPS_PER_HIT * hits

    def z_march_flops(n_steps=STEPS, **kw):
        evals, adv = counts(n_steps, **kw)
        return (FWD_FLOPS_PER_EVAL * evals + FWD_FLOPS_PER_ADVANCE * adv
                + FWD_FLOPS_HIT_TEST * rays)

    def relax_march_flops(**kw):
        # every executed step in full, then the final hit test
        steps = counts(**relax_kw, **kw)[1]
        return ((RELAX_FLOPS_PER_STEP + UNIMODAL_FLOPS_PER_STEP) * steps
                + RELAX_FLOPS_HIT_TEST * rays)

    p1 = K.sdf_fwd_split(p_ref, N, 16, EXTENT)
    idx = K.survivors(p1[2])
    # a survivor's advances in the tail: the one-pass march's less pass
    # 1's (the split render is the one-pass render bit for bit)
    tail_adv = (K.march_counts(p_ref, N, STEPS, EXTENT)[1]
                - K.march_counts(p_ref, N, 16, EXTENT)[1]).view(-1)[idx]
    tail_adv_n = int(tail_adv.sum().item())
    # a survivor's evaluations: one per advance (the replayed one's
    # included) and one more, whose distance the hit test takes
    k = idx.numel()
    tail_evals = tail_adv_n + k
    tail_hits = int((ts_ref.view(-1)[idx] >= 0).sum().item())

    def tail_call():
        return K.sdf_tail(p_ref, idx, p1[2], p1[0], p1[1], N, STEPS, 16,
                          EXTENT)

    # name -> (kernel call, plain call, (bound ms, by)); each kernel at the
    # configuration phase 12's steps ran it in. A bf16 march's operations
    # go against the bf16 rate, everything else against the FP32 rate
    work = {
        "sdf_fwd_bf16": (
            lambda: K.sdf_fwd(p_ref, N, STEPS, EXTENT, None, bf16),
            lambda: K.sdf_fwd_plain(p_ref, N, STEPS, EXTENT, None, bf16),
            bound(8 * rays + 64, shade_flops(), z_march_flops(dtype=bf16))),
        "sdf_fwd_relax": (
            lambda: K.sdf_fwd(p_ref, N, STEPS, EXTENT, None, f32, 1.6, True),
            lambda: K.sdf_fwd_plain(p_ref, N, STEPS, EXTENT, None, f32, 1.6,
                                    True),
            bound(8 * rays + 64, shade_flops() + relax_march_flops())),
        "sdf_fwd_relax_bf16": (
            lambda: K.sdf_fwd(p_ref, N, STEPS, EXTENT, None, bf16, 1.6, True),
            lambda: K.sdf_fwd_plain(p_ref, N, STEPS, EXTENT, None, bf16, 1.6,
                                    True),
            bound(8 * rays + 64, shade_flops(),
                  relax_march_flops(dtype=bf16))),
        "sdf_fwd_split": (
            lambda: K.sdf_fwd_split(p_ref, N, 16, EXTENT),
            lambda: K.sdf_fwd_split_plain(p_ref, N, 16, EXTENT),
            bound(12 * rays + 64,
                  shade_flops(CONT_FLOPS_PER_PIXEL) + z_march_flops(16))),
        # reads idx (8 B) and cont (4 B), writes img and ts, per survivor
        "sdf_tail": (
            tail_call,
            lambda: K.sdf_tail_plain(p_ref, idx, p1[2], p1[0], p1[1], N,
                                     STEPS, 16, EXTENT),
            bound(20 * k + 64, FWD_FLOPS_PER_EVAL * tail_evals
                  + FWD_FLOPS_PER_ADVANCE * tail_adv_n
                  + (FWD_FLOPS_PER_PIXEL + FWD_FLOPS_HIT_TEST) * k
                  + FWD_FLOPS_PER_HIT * tail_hits)),
        # the function is sdf_bwd's, so the bound is sdf_bwd's
        "sdf_bwd_ad": (
            lambda: K.sdf_bwd(p_ref, g_mean, ts_ref, N, EXTENT, kernel="ad"),
            lambda: K.sdf_bwd_ad_plain(p_ref, g_mean, ts_ref, N, EXTENT),
            bound(8 * rays + 64 + 64, BWD_FLOPS_PER_HIT * hits
                  + BWD_FLOPS_PER_PIXEL * rays)),
    }
    ms = {name: timer(fn, 200) for name, (fn, _, _) in work.items()
          if name != "sdf_bwd_ad"}
    ms["sdf_bwd_ad"] = timed_bwd(torch, timer, "phase 12 sdf_bwd_ad",
                                 work["sdf_bwd_ad"][0],
                                 K.bwd_vector_loads(g_mean, ts_ref, N))
    # the plain versions as phases 4 and 8 time theirs: device time, the
    # stream held while the host enqueues. One call at a time: the
    # relaxed march is ~1600 eager launches, and a few calls of it fill
    # CUDA's launch queue, which then blocks the host until the hold ends
    plain_ms = {name: timer(fn, 1, hold_ms=1000.0, plain=True)
                for name, (_, fn, _) in work.items()}
    for name, (_, _, (b_ms, b_by)) in work.items():
        log(f"phase 12 {name} {ms[name]:.5f} ms (plain "
            f"{plain_ms[name]:.4f} ms, bound {b_ms:.5f} ms by {b_by}); "
            f"library call: none computes this function")
    ad_ops_ms = 1e3 * BWD_AD_FLOPS_AS_WRITTEN_PER_HIT * hits / FP32_FLOPS_PER_S
    log(f"phase 12 sdf_bwd_ad, for the record: its two sweeps as written "
        f"are {BWD_AD_FLOPS_AS_WRITTEN_PER_HIT} operations per hit pixel, "
        f"{ad_ops_ms:.5f} ms at the FP32 peak, against the "
        f"{BWD_FLOPS_PER_HIT} the function needs")
    log("phase 12 the backward pair, one launch each (csrc/pixel_sum.cuh), "
        "at the main path's tensors with "
        + ("float4" if K.bwd_vector_loads(g_mean, ts_ref, N) else
           "single-float") + " loads; ptxas: " + "; ".join(
            f"{name} " + resources_text(_build.build(lib), (fn,))
            for name, lib, fn in (("sdf_bwd", "sdf_render", "AnalyticPixel"),
                                  ("sdf_bwd_ad", "sdf_bwd_ad",
                                   "ReversePixel"))))
    # the main kernel again with the start map, beside its plain march
    ev0, adv0 = counts()
    ev8, adv8 = counts(t0=t0)
    fwd0_ms = timer(lambda: K.sdf_fwd(p_ref, N, STEPS, EXTENT), 200)
    fwd8_ms = timer(lambda: K.sdf_fwd(p_ref, N, STEPS, EXTENT, t0), 200)
    b8 = bound(12 * rays + 64, shade_flops() + z_march_flops(t0=t0))
    log(f"phase 12 sdf_fwd with the coarse=8 start map {fwd8_ms:.5f} ms "
        f"(bound {b8[0]:.5f} ms by {b8[1]}; {ev8 / rays:.3f} distance "
        f"evaluations per pixel) against {fwd0_ms:.5f} ms without "
        f"({ev0 / rays:.3f} per pixel)")
    log(f"phase 12 work: split 16 leaves {k} survivors "
        f"({k / rays:.4%}), {tail_evals / max(k, 1):.2f} evaluations each "
        f"in the tail; survivor shares at the reference scene "
        + ", ".join(f"split {s} coarse {c}: {v:.4%}"
                    for (s, c), v in shares.items())
        + f"; relaxed march {counts(**relax_kw)[0] / rays:.3f} evaluations "
        f"per pixel, bf16 march {counts(dtype=bf16)[0] / rays:.3f}")

    # the issue floors of the sdf_fwd family (derived, not measured): the
    # SASS instructions an iteration of each kernel's march loop issues
    # times the iterations its warps run (a lane's: the z-carry march's
    # evaluations, the relaxed march's steps; the code around the loops is
    # left out), over the card's issue rate
    lib_path = _build.build("sdf_render")
    sass = sass_of(lib_path)
    rate, rate_text = issue_rate(torch)
    cols, block_cols, block_rows = fwd_footprint("sdf_render.cu")
    relax_least = RELAX_FLOPS_PER_STEP + UNIMODAL_FLOPS_PER_STEP

    def relax_steps(**kw):
        return K.march_counts(p_ref, N, STEPS, EXTENT, **relax_kw, **kw)[1]
    # sdf_tail: thread j of a block of 256 takes survivor j, so a warp
    # takes 32 consecutive survivors; a survivor's loop iterations are its
    # tail advances (one evaluation each, the last one's the hit test's;
    # the replayed advance's distance is evaluated before the loop)
    tail_iters = tail_adv.new_zeros(-(-k // 32) * 32)
    tail_iters[:k] = tail_adv
    tail_iters = tail_iters.view(-1, 32)
    floors = {  # name: (its __global__ function, iterations per pixel,
        #               measured ms, bound, fewest instructions a step,
        #               warp columns, block columns and rows)
        "sdf_fwd": ("sdf_fwd_kernelIfLb0ELb0EE",
                    K.march_counts(p_ref, N, STEPS, EXTENT)[0], fwd0_ms,
                    bound(8 * rays + 64, shade_flops() + z_march_flops()),
                    FWD_FLOPS_PER_EVAL, cols, block_cols, block_rows),
        "sdf_fwd_bf16": ("sdf_fwd_kernelI13__nv_bfloat16Lb0ELb0EE",
                         K.march_counts(p_ref, N, STEPS, EXTENT,
                                        dtype=bf16)[0],
                         ms["sdf_fwd_bf16"], work["sdf_fwd_bf16"][2],
                         FWD_FLOPS_PER_EVAL, cols, block_cols, block_rows),
        "sdf_fwd_relax": ("sdf_fwd_kernelIfLb1ELb0EE", relax_steps(),
                          ms["sdf_fwd_relax"], work["sdf_fwd_relax"][2],
                          relax_least, cols, block_cols, block_rows),
        "sdf_fwd_relax_bf16": ("sdf_fwd_kernelI13__nv_bfloat16Lb1ELb0EE",
                               relax_steps(dtype=bf16),
                               ms["sdf_fwd_relax_bf16"],
                               work["sdf_fwd_relax_bf16"][2], relax_least,
                               cols, block_cols, block_rows),
        "sdf_fwd_split": ("sdf_fwd_kernelIfLb0ELb1EE",
                          K.march_counts(p_ref, N, 16, EXTENT)[0],
                          ms["sdf_fwd_split"], work["sdf_fwd_split"][2],
                          FWD_FLOPS_PER_EVAL, cols, block_cols, block_rows),
        "sdf_tail": ("sdf_tail_kernel", tail_iters, ms["sdf_tail"],
                     work["sdf_tail"][2], FWD_FLOPS_PER_EVAL, 32, 32, 8),
    }
    for name, (kernel, iters, t_ms, (b_ms, b_by), least, cols,
               block_cols, block_rows) in floors.items():
        first, last, laid_out, loop_ins = loop_counts(sass, kernel)
        warp_iters = warp_evaluations(iters, cols)
        floor_ms = 1e3 * loop_ins * warp_iters / rate
        # an iteration evaluates the distance once and tests the lane, an
        # instruction an operation at the least
        check(loop_ins >= least, f"{name}: the loop found in its SASS "
              f"issues {loop_ins} instructions, fewer than a step's {least} "
              f"operations")
        check(floor_ms <= t_ms, f"{name}'s issue floor {floor_ms:.5f} ms "
              f"is above its time {t_ms:.5f} ms")
        log(f"phase 12 {name} issue floor (derived, not measured): an "
            f"iteration of its march loop issues {loop_ins} SASS "
            f"instructions (the loop {first:#x}-{last:#x} lays out "
            f"{laid_out}; cuobjdump) x {warp_iters} warp iterations (busy "
            f"lanes {int(iters.sum().item()) / (32 * warp_iters):.4f}, "
            f"{cols}x{32 // cols} warps keep "
            f"{block_share(iters, cols, block_cols, block_rows):.4f} of "
            f"their {block_cols}x{block_rows} blocks' warp slots busy) over "
            f"{rate_text} = {floor_ms:.5f} ms, {floor_ms / t_ms:.4f} of the "
            f"measured {t_ms:.5f} ms (bound {b_ms:.5f} ms by {b_by}); "
            f"ptxas: " + resources_text(lib_path, (kernel,)))

    # the cone prepass: eager ops on a (N/8)^2 array, device and wall time
    cone_dev_ms = timer(lambda: K._cone_t0(p_ref, N, STEPS, EXTENT, 8), 5,
                        hold_ms=1000.0, plain=True)
    wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        K._cone_t0(p_ref, N, STEPS, EXTENT, 8)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t_start))
    cone_wall_ms, cone_spread = robust(wall)
    log(f"phase 12 cone prepass (coarse=8, {STEPS} steps of eager ops on "
        f"{N // 8}^2 rays): device {cone_dev_ms:.4f} ms "
        f"({cone_dev_ms / STEPS:.5f} ms per step), wall "
        f"{cone_wall_ms:.3f} ms ({cone_wall_ms / STEPS:.4f} ms per step, "
        f"spread {cone_spread:.2%})")

    # the chained fwd+bwd step of the five candidates, interleaved:
    # forwards through the list, then backwards
    def make_step(cfg):
        coarse, bands, relax, unimodal, split = cfg

        def step(p0, p, k_):
            p = p.detach().requires_grad_(True)
            loss = K.render_sdf_cuda(p, N, STEPS, EXTENT, min(128, N), None,
                                     coarse, 16, f32, bands, relax, unimodal,
                                     split).mean()
            (g,) = torch.autograd.grad(loss, p)
            return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k_
        return step

    samples = {cfg: [] for cfg in CANDIDATES}
    for cfg in CANDIDATES + CANDIDATES[::-1]:
        iters, windows = (20, 3) if cfg[0] else (100, 5)
        samples[cfg].append(chain_ms(torch, make_step(cfg), p_ref, iters,
                                     windows))
    best = min(CANDIDATES, key=lambda c: min(t for t, _ in samples[c]))
    for cfg in CANDIDATES:
        (t1, s1), (t2, s2) = samples[cfg]
        log(f"phase 12 chained fwd+bwd step, (coarse, bands, relax, "
            f"unimodal, split) = {cfg}: {t1:.4f} / {t2:.4f} ms (spread "
            f"{s1:.2%} / {s2:.2%}), {rays / (min(t1, t2) * 1e-3):.4g} rays/s"
            + ("  <- fastest on this card in this call" if cfg == best
               else ""))

    idle = [name for name in work if launches.get(name, 0) < 1]
    check(not idle, f"kernels never launched on the options' path: {idle}")
    replaces = {
        "sdf_fwd_bf16": "enoki_tpu/render/pallas_kernels.py:504",
        "sdf_fwd_relax": "enoki_tpu/render/pallas_kernels.py:504",
        "sdf_fwd_relax_bf16": "enoki_tpu/render/pallas_kernels.py:504",
        "sdf_fwd_split": "enoki_tpu/render/pallas_kernels.py:607",
        "sdf_tail": "enoki_tpu/render/pallas_kernels.py:666",
        "sdf_bwd_ad": "enoki_tpu/render/pallas_kernels.py:869",
    }
    return [dict(name=name, route="cuda",
                 source="enoki_tpu_torch/csrc/" + (
                     "sdf_bwd_ad.cu" if name == "sdf_bwd_ad"
                     else "sdf_render.cu"),
                 replaces=replaces[name], launches=launches.get(name, 0),
                 max_abs_err=err[name], ms=ms[name], plain_ms=plain_ms[name],
                 bound_ms=work[name][2][0], bound_by=work[name][2][1],
                 library_ms=None) for name in work]

def run_generic(torch, dev, timer, scenes, first_use):
    """Phases 13-16: the bring-your-own-SDF renderer. ``scenes`` are
    ``generic_scenes()``'s renderers, already built; ``first_use`` their
    trace + nvcc seconds. Returns the two kernels' entries of the kernels
    line."""
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import (LAUNCHES, generic as G,
                                        reset_launch_counts, sdf_kernels as K)
    from enoki_tpu_torch.render.sdf_trace import generic_hit_programs

    rays = N * N
    g_rand = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(dev)
    err = {"generic_fwd": 0.0, "generic_bwd": 0.0}

    def kernels_of(name):
        return scenes[name][0].kernels

    def vec(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(dev)

    def significant_rel(g, ref):
        sig = ref.abs() > 1e-3 * ref.abs().max()
        return ((g - ref).abs()[sig] / ref.abs()[sig]).max().item()

    # -- phase 13: generic_fwd against its plain version --------------------
    for name in ("composed", "composed_perspective"):
        kern = kernels_of(name)
        for seed in SEEDS:
            p = vec(generic_vec(seed))
            img_k, ts_k = G.generic_fwd(kern, p, N, STEPS, EXTENT)
            img_p, ts_p = G.generic_fwd_plain(kern.sdf_fn, kern.ray_fn, p, N,
                                              STEPS, EXTENT)
            torch.cuda.synchronize()
            check(img_k.shape == (N, N)
                  and torch.isfinite(img_k).all().item()
                  and torch.isfinite(ts_k).all().item(),
                  f"generic_fwd {name}: non-finite output")
            d = (img_k - img_p).abs()
            err["generic_fwd"] = max(err["generic_fwd"], d.max().item())
            what = f"phase 13 generic_fwd {name} scene={seed}"
            hits = (ts_k >= 0).sum().item()
            check(0.05 * rays < hits < 0.95 * rays,
                  f"{what}: {hits} hits, the scene is not in view")
            if seed is None:
                # the emitted arithmetic rounds where PyTorch's kernels
                # round on this card (a division by a number is a product
                # with its reciprocal there): if that ever changes, it
                # shows here, not as a few flips under a gate
                check(torch.equal(ts_k, ts_p),
                      f"{what}: ts differs from the plain version's on "
                      f"{(ts_k != ts_p).sum().item()} pixels at the "
                      f"reference parameters, where it was bit-equal")
            if torch.equal(ts_k, ts_p):
                # the normal comes from a reverse sweep here and from
                # autograd there: the image is equal to rounding
                ok = d.max().item() <= 1e-3
                log(f"{what}: ts bit-equal to plain, max|img-plain| "
                    f"{d.max().item():.3e} <= 1e-3, {(d > 0).sum().item()} "
                    f"pixels differ, hits {hits}: "
                    f"{'pass' if ok else 'FAIL'}")
                check(ok, f"{what}: image atol 1e-3")
            else:
                log(f"{what}: ts differs on "
                    f"{(ts_k != ts_p).sum().item()} pixels, hit masks on "
                    f"{((ts_k >= 0) != (ts_p >= 0)).sum().item()}")
                flip_gate(d, what)

    # two independent kernels for one picture: the sphere-only scene
    # through generic_fwd against the main path's sdf_fwd, the same sphere
    # (sqrt of the traced function against x * rsqrt(x) of the z-carry)
    kern = kernels_of("sphere_only")
    for seed in SEEDS:
        v16 = scene_vec(seed)
        img_g, ts_g = G.generic_fwd(kern, vec(sphere_as_generic(v16)), N,
                                    STEPS, EXTENT)
        img_s, ts_s = K.sdf_fwd(vec(v16), N, STEPS, EXTENT)
        torch.cuda.synchronize()
        log(f"phase 13 sphere-only scene={seed}: hit masks differ on "
            f"{((ts_g >= 0) != (ts_s >= 0)).sum().item()} pixels of "
            f"{(ts_s >= 0).sum().item()} hits")
        flip_gate((img_g - img_s).abs(),
                  f"phase 13 generic_fwd sphere-only against sdf_fwd "
                  f"scene={seed}")

    # every ray escapes: the image is the ambient term bit for bit
    far = sphere_as_generic(scene_vec(None))
    far[5] = 50.0
    p_far = vec(far)
    img_far, ts_far = G.generic_fwd(kern, p_far, N, STEPS, EXTENT)
    ok = (torch.equal(img_far, torch.full((N, N), float(far[0]), device=dev))
          and bool((ts_far < 0).all().item()))
    log(f"phase 13 all-miss scene: image exactly ambient, no hit: "
        f"{'pass' if ok else 'FAIL'}")
    check(ok, "all-miss scene is not exactly ambient")

    # -- phase 14: generic_bwd against its plain version, determinism ------
    for name in ("composed", "composed_perspective"):
        kern = kernels_of(name)
        for seed in SEEDS:
            p = vec(generic_vec(seed))
            _, ts = G.generic_fwd(kern, p, N, STEPS, EXTENT)
            dp1 = G.generic_bwd(kern, p, g_rand, ts, N, EXTENT)
            dp2 = G.generic_bwd(kern, p, g_rand, ts, N, EXTENT)
            ref = G.generic_bwd_plain(kern.sdf_fn, kern.ray_fn, p, g_rand,
                                      ts, N, EXTENT)
            torch.cuda.synchronize()
            check(torch.equal(dp1, dp2), "generic_bwd: two runs differ")
            check(torch.isfinite(dp1).all().item(), "generic_bwd: non-finite")
            scale = max(1.0, ref.abs().max().item())
            e = (dp1 - ref).abs()
            err["generic_bwd"] = max(err["generic_bwd"], e.max().item())
            ok = bool((e <= 2e-4 * scale + 2e-4 * ref.abs()).all().item())
            log(f"phase 14 generic_bwd {name} scene={seed}: max|dp-plain| "
                f"{e.max().item():.3e} (scale {scale:.3e}), bitwise "
                f"deterministic: yes; gate rtol 2e-4 atol 2e-4*scale: "
                f"{'pass' if ok else 'FAIL'}")
            check(ok, f"generic_bwd vs plain ({name}, scene {seed}): "
                  f"{e.tolist()}")
    dp_far = G.generic_bwd(kernels_of("sphere_only"), p_far,
                           torch.ones((N, N), device=dev), ts_far, N, EXTENT)
    ok = dp_far[0].item() == rays and bool((dp_far[1:] == 0).all().item())
    log(f"phase 14 all-miss scene: gradient of sum(img) exactly {rays} in "
        f"the ambient slot and 0 elsewhere: {'pass' if ok else 'FAIL'}")
    check(ok, f"all-miss gradient: {dp_far.tolist()}")

    # -- phase 15: the generic path, counted --------------------------------
    render, render_plain = scenes["composed"]
    model = G.GenericRender(render, vec(generic_vec(None)), n=N,
                            n_steps=STEPS, extent=EXTENT)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    reset_launch_counts()
    for step in range(TRAIN_STEPS):
        opt.zero_grad()
        img = model()
        loss = img.mean()
        loss.backward()
        grad = model.params.grad.detach().clone()
        p_x = model.params.detach().clone().requires_grad_(True)
        loss_x = render_plain(p_x, N, STEPS, EXTENT).mean()
        (gx,) = torch.autograd.grad(loss_x, p_x)
        torch.cuda.synchronize()
        check(img.shape == (N, N) and torch.isfinite(img).all().item()
              and torch.isfinite(grad).all().item(), "non-finite output")
        lx = loss_x.item()
        tol = 2e-3 * max(1.0, gx.abs().max().item())
        g_ok = bool(torch.allclose(grad, gx, rtol=2e-2, atol=tol))
        l_ok = abs(loss.item() - lx) <= 1e-5 + 1e-3 * abs(lx)
        log(f"phase 15 step {step}: loss {loss.item():.7g} (twin {lx:.7g}), "
            f"max|grad-twin| {(grad - gx).abs().max().item():.3e} (rtol "
            f"2e-2, atol {tol:.3e}; largest relative error of a significant "
            f"gradient {significant_rel(grad, gx):.4f}); gates: loss rtol "
            f"1e-3 {'pass' if l_ok else 'FAIL'}, grad "
            f"{'pass' if g_ok else 'FAIL'}")
        check(l_ok and g_ok, f"generic path vs twin at step {step}")
        opt.step()
    launches = dict(LAUNCHES)
    log(f"phase 15 launches over {TRAIN_STEPS} steps: {launches}")
    check(launches == {k: TRAIN_STEPS for k in
                       ("generic_fwd", "generic_bwd", "generic_bwd_reduce")},
          f"expected one launch of each kernel per step, got {launches}")

    def one_step(name, p, **options):
        """(img, grad, ts) of one counted fwd+bwd step of a module."""
        m = G.GenericRender(scenes[name][0], p, n=N, n_steps=STEPS,
                            extent=EXTENT, **options)
        reset_launch_counts()
        img = m()
        img.mean().backward()
        torch.cuda.synchronize()
        got = dict(LAUNCHES)
        check(got == {"generic_fwd": 1, "generic_bwd": 1,
                      "generic_bwd_reduce": 1},
              f"{name} {options}: expected one launch of each kernel, got "
              f"{got}")
        check(torch.isfinite(img).all().item()
              and torch.isfinite(m.params.grad).all().item(),
              f"{name} {options}: non-finite")
        # the step's hit mask: the forward kernel again on the same start
        kern = kernels_of(name)
        t0 = None
        if options.get("coarse"):
            t0 = G._cone_t0_generic(kern.sdf_fn, kern.ray_fn, p, N, STEPS,
                                    EXTENT, options["coarse"], 1e-4, 10.0)
        img_k, ts = G.generic_fwd(kern, p, N, STEPS, EXTENT, t0,
                                  options.get("relax", 1.0),
                                  options.get("unimodal", False))
        check(torch.equal(img_k, img.detach()),
              "generic_fwd is not repeatable")
        return img.detach(), m.params.grad.detach().clone(), ts

    # the head-start options against the plain configuration's step
    # (tests/test_generic_render.py:98-117 and :145-167). A flip is a
    # hit/miss disagreement: |d| > 1, or the hit masks differ and the
    # images with them (phase 12 reads it the same way at this size)
    p_c = vec(generic_vec(None))
    p_s = vec(sphere_as_generic(scene_vec(None)))
    img0, g0, ts0 = one_step("composed", p_c)
    img8, g8, ts8 = one_step("composed", p_c, coarse=8, bands=8)
    d = (img8 - img0).abs()
    flips = (d > 1.0) | (((ts8 >= 0) != (ts0 >= 0)) & (d > 0.0))
    share = flips.float().mean().item()
    off_max, off_mean = d[~flips].max().item(), d[~flips].mean().item()
    tol = 5e-3 * max(1.0, g0.abs().max().item())
    ok = (share < 1e-3 and off_max < 0.05 and off_mean < 5e-3
          and bool(torch.allclose(g8, g0, rtol=5e-2, atol=tol)))
    log(f"phase 15 one step, coarse=8 bands=8 (composed): flip share "
        f"{share:.3e} < 1e-3 (by |d| > 1 alone "
        f"{(d > 1.0).float().mean().item():.3e}), off-flip max "
        f"{off_max:.3e} < 0.05, mean {off_mean:.3e} < 5e-3; max|grad - "
        f"plain step's| {(g8 - g0).abs().max().item():.3e} (rtol 5e-2, atol "
        f"{tol:.3e}; largest relative error of a significant gradient "
        f"{significant_rel(g8, g0):.4f}): {'pass' if ok else 'FAIL'}")
    check(ok, "one step with coarse=8, bands=8")
    img_s0, g_s0, _ = one_step("sphere_only", p_s)
    img_u, _, _ = one_step("sphere_only", p_s, unimodal=True)
    check(torch.equal(img_u, img_s0),
          "relax=1 with unimodal differs from the plain march")
    img_w, g_w, _ = one_step("sphere_only", p_s, relax=1.6, unimodal=True)
    d = (img_w - img_s0).abs()
    flips = d > 1.0
    share, off_mean = flips.float().mean().item(), d[~flips].mean().item()
    rel = significant_rel(g_w, g_s0)
    ok = (share < 0.01 and off_mean < 1e-3 and rel < 0.5
          and g_w[5:].abs().max().item() > 1e-4)
    log(f"phase 15 one step, relax=1.6 unimodal (sphere-only, a second "
        f"scene's library in this process): unimodal alone bit-equal to "
        f"plain; flip share {share:.3e} < 0.01, off-flip mean "
        f"{off_mean:.3e} < 1e-3, significant gradients within {rel:.3f} < "
        f"0.5 of plain's: {'pass' if ok else 'FAIL'}")
    check(ok, "one step with relax=1.6, unimodal")
    check(kernels_of("sphere_only").lib is not kernels_of("composed").lib,
          "two scenes share one library")

    # -- phase 16: timing -----------------------------------------------------
    kern = kernels_of("composed")
    g_mean = torch.full((N, N), 1.0 / rays, device=dev)
    fwd_ms = timer(lambda: G.generic_fwd(kern, p_c, N, STEPS, EXTENT), 200,
                   hold_ms=400.0)
    bwd_ms = timer(lambda: G.generic_bwd(kern, p_c, g_mean, ts0, N, EXTENT),
                   200, hold_ms=400.0)

    # the plain versions as the earlier phases time theirs: device time,
    # the stream held while the host enqueues, one call at a time (each is
    # thousands of eager launches)
    fwd_plain_ms = timer(lambda: G.generic_fwd_plain(
        kern.sdf_fn, kern.ray_fn, p_c, N, STEPS, EXTENT), 1,
        hold_ms=1000.0, plain=True)
    bwd_plain_ms = timer(lambda: G.generic_bwd_plain(
        kern.sdf_fn, kern.ray_fn, p_c, g_mean, ts0, N, EXTENT), 1,
        hold_ms=1000.0, plain=True)

    # bounds from this run's data. A hit pixel's operations are the
    # arithmetic nodes of the scene's two reverse-mode programs, the
    # cotangent's being the one generic_bwd runs (user_cotangent); the
    # cotangent adds its n_params sums over the image, and every pixel its
    # hit test and the sum of g into the ambient slot
    traced = kern.traced
    shade_prog, cotangent_prog = generic_hit_programs(
        kern.sdf_fn, kern.ray_fn, kern.n_params)
    check(shade_prog == traced.shade
          and cotangent_prog == traced.cotangent,
          "the counted programs are not the programs the kernels run")
    counts = G.generic_march_counts(kern.sdf_fn, kern.ray_fn, p_c, N, STEPS,
                                    EXTENT)
    evals = int(counts.sum().item())
    hits = int((ts0 >= 0).sum().item())
    eval_flops = traced.sdf.n_ops + GENERIC_POINT_FLOPS
    fwd_flops = ((eval_flops + GENERIC_STEP_FLOPS) * evals
                 + (traced.ray.n_ops + 4) * rays   # the ray, the pixel, ts
                 + shade_prog.n_ops * hits)
    bwd_flops = (cotangent_prog.n_ops + kern.n_params) * hits + 2 * rays
    # fwd reads the parameters and writes img + ts; bwd reads the
    # parameters, g and ts and writes dp
    n_par = 4 * kern.n_params
    fwd_bound, fwd_by = bound(8 * rays + n_par, fwd_flops)
    bwd_bound, bwd_by = bound(8 * rays + 2 * n_par, bwd_flops)
    log(f"phase 16 work: the composed scene is {traced.sdf.n_ops} "
        f"operations per distance evaluation ({traced.ray.n_ops} per ray); "
        f"{evals} evaluations ({evals / rays:.3f} per pixel), counted by "
        f"the plain march; {hits} hit pixels of {rays}, each "
        f"{shade_prog.n_ops} operations in the forward's shade and "
        f"{cotangent_prog.n_ops} in the backward's cotangent (the scene "
        f"differentiated in reverse mode)")
    lib_path = _build.build_generated("generic_render", traced.source)
    log("phase 16 ptxas: " + resources_text(
        lib_path, ("generic_fwd_kernelILb0E", "generic_fwd_kernelILb1E",
                   "generic_bwd_partial_kernel")))

    # what a warp waits for: each footprint's busy-lane share, the
    # evaluations over the lane slots its warps spend (the shipped one's
    # are what the issue floor counts), and what a block waits for
    cols, block_cols, block_rows = fwd_footprint()
    slots = {c: warp_evaluations(counts, c) for c in (32, 16, 8, 4)}
    log("phase 16 generic_fwd busy-lane share by warp footprint (cols x "
        "rows): " + ", ".join(
            f"{c}x{32 // c} {evals / (32 * w):.4f} ({32 * w / rays:.3f} "
            f"lane slots a pixel)" + (" <- shipped" if c == cols else "")
            for c, w in slots.items())
        + f"; in blocks of {block_cols}x{block_rows} pixels the warps keep "
        f"{block_share(counts, cols, block_cols, block_rows):.4f} of their "
        f"blocks' warp slots busy (32x8: "
        f"{block_share(counts, cols, 32, 8):.4f}); computed from the plain "
        f"march's counts, not measured")
    first, last, laid_out, loop_ins = march_loop(lib_path,
                                                 "generic_fwd_kernelILb0E")
    rate, rate_text = issue_rate(torch)
    floor_ms = 1e3 * loop_ins * slots[cols] / rate
    # an iteration evaluates the scene once, an instruction an operation at
    # the least; a floor above the measured time would count what a step
    # does not run
    check(loop_ins >= traced.sdf.n_ops, f"generic_fwd: the loop found in its "
          f"SASS issues {loop_ins} instructions, fewer than the scene's "
          f"{traced.sdf.n_ops} operations")
    check(floor_ms <= fwd_ms, f"generic_fwd's issue floor {floor_ms:.5f} ms "
          f"is above its time {fwd_ms:.5f} ms")
    log(f"phase 16 generic_fwd issue floor (derived, not measured): an "
        f"iteration of the plain march issues {loop_ins} SASS instructions "
        f"(the loop {first:#x}-{last:#x} lays out {laid_out}, its slow "
        f"paths included; cuobjdump); x {slots[cols]} warp evaluations over "
        f"{rate_text} = {floor_ms:.5f} ms, "
        f"{floor_ms / fwd_ms:.4f} of the measured {fwd_ms:.5f} ms")
    log(f"phase 16 generic_fwd {fwd_ms:.5f} ms (plain {fwd_plain_ms:.3f} ms,"
        f" bound {fwd_bound:.5f} ms by {fwd_by}: {fwd_flops} operations, "
        f"{8 * rays + n_par} bytes); "
        f"generic_bwd {bwd_ms:.5f} ms (plain "
        f"{bwd_plain_ms:.3f} ms, bound {bwd_bound:.5f} ms by {bwd_by}: "
        f"{bwd_flops} operations, {8 * rays + 2 * n_par} bytes); library "
        f"call: none computes either function")

    def kernel_step(p0, p, k):
        p = p.detach().requires_grad_(True)
        loss = render(p, N, STEPS, EXTENT, min(128, N)).mean()
        (g,) = torch.autograd.grad(loss, p)
        return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k

    def twin_step(p0, p, k):
        p = p.detach().requires_grad_(True)
        loss = render_plain(p, N, STEPS, EXTENT).mean()
        (g,) = torch.autograd.grad(loss, p)
        return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k

    # interleaved: kernel, twin, twin, kernel
    t_k1, sp_k1 = chain_ms(torch, kernel_step, p_c, 50, 5)
    t_x1, sp_x1 = chain_ms(torch, twin_step, p_c, 2, 2)
    t_x2, sp_x2 = chain_ms(torch, twin_step, p_c, 2, 2)
    t_k2, sp_k2 = chain_ms(torch, kernel_step, p_c, 50, 5)
    t_k, t_x = min(t_k1, t_k2), min(t_x1, t_x2)
    log(f"phase 16 generic fwd+bwd step (chained, median of windows): "
        f"kernels {t_k1:.4f} / {t_k2:.4f} ms (spread {sp_k1:.2%} / "
        f"{sp_k2:.2%}), twin {t_x1:.3f} / {t_x2:.3f} ms (spread {sp_x1:.2%} "
        f"/ {sp_x2:.2%}); {rays / (t_k * 1e-3):.4g} rays/s, "
        f"{t_x / t_k:.1f}x the twin")
    by_kernel = device_ms_by_kernel(torch, kernel_step, p_c, 30)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    log("phase 16 device time per generic fwd+bwd step (torch.profiler): "
        + (f"{busy_ms:.5f} ms of {t_k:.4f} ms, busy share "
           f"{busy_ms / t_k:.4f}; "
           + ", ".join(f"{k[:48]} {v:.5f} ms" for k, v in top)
           if by_kernel else "not measured (no device events)"))

    # the cone prepass over the composed scene: eager ops on (N/8)^2 rays
    def cone():
        return G._cone_t0_generic(kern.sdf_fn, kern.ray_fn, p_c, N, STEPS,
                                  EXTENT, 8, 1e-4, 10.0)

    cone_dev_ms = timer(cone, 1, hold_ms=1000.0, plain=True)
    wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        cone()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t_start))
    cone_wall_ms, cone_spread = robust(wall)
    t0_map = cone()
    fwd8_ms = timer(lambda: G.generic_fwd(kern, p_c, N, STEPS, EXTENT,
                                          t0_map), 200, hold_ms=400.0)
    ev8 = int(G.generic_march_counts(kern.sdf_fn, kern.ray_fn, p_c, N, STEPS,
                                     EXTENT, t0_map).sum().item())
    log(f"phase 16 cone prepass over the composed scene (coarse=8, {STEPS} "
        f"steps of eager ops on {N // 8}^2 rays): device {cone_dev_ms:.4f} "
        f"ms, wall {cone_wall_ms:.3f} ms (spread {cone_spread:.2%}); "
        f"generic_fwd with its start map {fwd8_ms:.5f} ms "
        f"({ev8 / rays:.3f} evaluations per pixel) against {fwd_ms:.5f} ms "
        f"without ({evals / rays:.3f})")

    # host cost per scene: the first use (trace + nvcc, in setup, beside
    # the other builds) and a cached use (a new renderer of the same
    # functions: trace, then the library that is already built)
    for name, (render_fn, _) in scenes.items():
        k0 = render_fn.kernels
        again = G.SceneKernels(k0.sdf_fn, k0.ray_fn, k0.n_params)
        t_start = time.perf_counter()
        path = _build.build_generated("generic_render", again.traced.source)
        found_s = time.perf_counter() - t_start - again.trace_seconds
        again.lib
        check(again.lib is k0.lib and path.exists(),
              f"{name}: a second renderer of the scene built a second "
              f"library")
        log(f"phase 16 host cost, scene {name}: first use "
            f"{first_use[name]:.2f} s (trace {k0.trace_seconds * 1e3:.2f} "
            f"ms, nvcc + load {k0.load_seconds:.2f} s, beside the other "
            f"builds); cached use: trace {again.trace_seconds * 1e3:.2f} "
            f"ms, finding the built library {found_s * 1e3:.2f} ms, load "
            f"{again.load_seconds * 1e3:.3f} ms")

    common = {"route": "cuda",
              "source": "enoki_tpu_torch/csrc/generic_render.cuh",
              "library_ms": None}
    return [
        dict(name="generic_fwd", replaces="enoki_tpu/render/generic.py:143",
             launches=launches["generic_fwd"],
             max_abs_err=err["generic_fwd"], ms=fwd_ms,
             plain_ms=fwd_plain_ms, bound_ms=fwd_bound, bound_by=fwd_by,
             coarse8_ms=fwd8_ms, **common),
        dict(name="generic_bwd", replaces="enoki_tpu/render/generic.py:187",
             launches=launches["generic_bwd"],
             max_abs_err=err["generic_bwd"], ms=bwd_ms,
             plain_ms=bwd_plain_ms, bound_ms=bwd_bound, bound_by=bwd_by,
             **common),
    ]


def mini_app_step(gen):
    """One iteration of the histogram mini-app (examples/histogram.py:
    27-36, examples/histogram_torch.py) -> (hist, new generator, the bin
    indices)."""
    import math

    import torch

    from enoki_tpu_torch import ops
    u, gen = gen.next_float32()
    g = ops.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    b = torch.floor((g - HIST_LO) * (HIST_BINS / (HIST_HI - HIST_LO)))
    # clamped before the cast: what the cast of +-inf gives differs
    # between devices; -1 and HIST_BINS are dropped indices
    idx = torch.clamp(b, -1.0, float(HIST_BINS)).to(torch.int32)
    return ops.histogram(idx, HIST_BINS), gen, idx


def normal_bin_mass(bins, lo, hi):
    """The standard normal distribution's mass in each of ``bins`` equal
    bins over [lo, hi)."""
    import math
    edges = np.linspace(lo, hi, bins + 1)
    cdf = np.array([0.5 * (1.0 + math.erf(e / math.sqrt(2.0)))
                    for e in edges])
    return cdf[1:] - cdf[:-1]


def run_hist(torch, dev, timer):
    """Phases 17-20: the histogram mini-app and stochastic rounding.
    Returns their kernels' entries of the kernels line."""
    from enoki_tpu_torch import _build, ops
    from enoki_tpu_torch._build import LAUNCHES, reset_launch_counts
    from enoki_tpu_torch.ops import hist_kernels as H, rounding as RD
    from enoki_tpu_torch.types import PCG32

    n, bins = HIST_N, HIST_BINS

    def library_hist(idx, nbins, w=None):
        # the one PyTorch call for the same function: dropped lanes go to
        # a slot past the bins (timed and compared here, used nowhere in
        # the port)
        safe = torch.where((idx < 0) | (idx >= nbins), nbins, idx)
        return torch.bincount(safe, weights=w,
                              minlength=nbins + 1)[:nbins].float()

    # -- phase 17: hist against its plain version ----------------------------
    rng = np.random.default_rng(17)
    _, _, idx_normal = mini_app_step(PCG32.create(n, device=dev))
    idx_sets = {
        "normal": idx_normal,
        "uniform[-3,70)": torch.from_numpy(
            rng.integers(-3, 70, n).astype(np.int32)).to(dev),
        "one bin": torch.full((n,), 17, dtype=torch.int32, device=dev),
    }
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)

    def f64_sums(idx, nbins):
        # the weighted histogram summed in float64, and the gate per bin:
        # 1e-6 * sum|w|, an f32 sum's error in whatever order it is taken
        safe = torch.where((idx < 0) | (idx >= nbins), nbins, idx).long()
        w64 = w.double()
        zeros = torch.zeros(nbins + 1, dtype=torch.float64, device=dev)
        return (zeros.index_add(0, safe, w64)[:nbins],
                1e-6 * zeros.index_add(0, safe, w64.abs())[:nbins])

    hist_err = 0.0
    for name, idx in idx_sets.items():
        count = H.hist(idx, bins)
        torch.cuda.synchronize()
        check(count.shape == (bins,) and count.dtype == torch.float32,
              f"hist {name}: wrong shape or dtype")
        plain = H.hist_plain(idx, bins)
        lib = library_hist(idx, bins)
        check(torch.equal(count, plain), f"hist {name}: counts differ from "
              f"hist_plain by {(count - plain).abs().max().item()}")
        check(torch.equal(count, lib), f"hist {name}: counts differ from "
              "torch.bincount")
        hw1, hw2 = H.hist(idx, bins, w), H.hist(idx, bins, w)
        torch.cuda.synchronize()
        check(torch.equal(hw1, hw2), f"hist {name}: two weighted runs differ")
        exact, tol = f64_sums(idx, bins)
        err = (hw1.double() - exact).abs()
        ok = bool((err <= tol).all().item())
        hist_err = max(hist_err, err.max().item())
        p_err = (H.hist_plain(idx, bins, w).double()
                 - exact).abs().max().item()
        log(f"phase 17 hist {name}: {int(count.sum().item())} of {n} in "
            f"range, counts == hist_plain == torch.bincount; weighted "
            f"max|hist-f64 sum| {err.max().item():.3e} (plain version "
            f"{p_err:.3e}; gate 1e-6 * sum|w| per bin, smallest "
            f"{tol[tol > 0].min().item():.3e}), two runs bitwise equal: "
            f"{'pass' if ok else 'FAIL'}")
        check(ok, f"hist {name}: weighted sums off by {err.max().item()}")
    # both routes of the kernel: a row per thread up to H.SMALL_BINS bins
    # (the mini-app's 64 above), a row per warp from one more
    small = H.SMALL_BINS
    for nbins in (1, small, small + 1, 1000):
        idx = torch.from_numpy(rng.integers(-3, nbins + 6, n).astype(
            np.int32)).to(dev)
        count = H.hist(idx, nbins)
        check(torch.equal(count, H.hist_plain(idx, nbins))
              and torch.equal(count, library_hist(idx, nbins)),
              f"hist bins={nbins}: counts differ")
        exact, tol = f64_sums(idx, nbins)
        hw1, hw2 = H.hist(idx, nbins, w), H.hist(idx, nbins, w)
        err = (hw1.double() - exact).abs()
        check(bool((err <= tol).all().item()) and torch.equal(hw1, hw2),
              f"hist bins={nbins}: weighted sums off by {err.max().item()} "
              f"or two runs differ")
        hist_err = max(hist_err, err.max().item())
        log(f"phase 17 hist bins={nbins} (row per "
            f"{'thread' if nbins <= small else 'warp'}): counts exact, "
            f"weighted max|hist-f64 sum| {err.max().item():.3e}, two runs "
            f"bitwise equal: pass")
    # views that start off a 16-byte boundary: the weights misaligned as
    # the indices are (read as float4), or aligned where the indices are
    # not (read one by one)
    for off, w_off in ((1, 1), (2, 2), (3, 3), (1, 0), (2, 1)):
        idx = idx_normal[off:]
        wv = w[w_off:w_off + n - off]
        w_view = f"w[{w_off}:{w_off + n - off}]"
        count = H.hist(idx, bins)
        check(torch.equal(count, H.hist_plain(idx, bins))
              and torch.equal(count, library_hist(idx, bins)),
              f"hist of idx[{off}:]: counts differ")
        safe = torch.where((idx < 0) | (idx >= bins), bins, idx).long()
        zeros = torch.zeros(bins + 1, dtype=torch.float64, device=dev)
        exact = zeros.index_add(0, safe, wv.double())[:bins]
        tol = 1e-6 * zeros.index_add(0, safe, wv.double().abs())[:bins]
        hw1, hw2 = H.hist(idx, bins, wv), H.hist(idx, bins, wv)
        err = (hw1.double() - exact).abs()
        check(bool((err <= tol).all().item()) and torch.equal(hw1, hw2),
              f"hist of idx[{off}:] weighted by {w_view}: off by "
              f"{err.max().item()} or two runs differ")
        hist_err = max(hist_err, err.max().item())
        log(f"phase 17 hist of the view idx[{off}:] weighted by {w_view} "
            f"({bins} bins): counts exact, weighted max|hist-f64 sum| "
            f"{err.max().item():.3e}, two runs bitwise equal: pass")
    log("phase 17 ptxas: " + resources_text(_build.build("hist"), (
        "hist_rows_kernelILb0ELb0E", "hist_rows_kernelILb1ELb1E",
        "hist_rows_kernelILb1ELb0E", "hist_partial_kernelILb0E",
        "hist_partial_kernelILb1E")))
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    before = LAUNCHES["hist"]
    z = H.hist(empty, bins)
    check(z.shape == (bins,) and not z.any().item()
          and LAUNCHES["hist"] == before, "hist n=0: not zeros, or launched")
    log("phase 17 hist n=0: zeros without a launch: pass")

    # -- phase 18: stochastic_round against its plain version ---------------
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-12, 12, n))).astype(
        np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-41,
                        65504.0, 65519.9, 65520.0, 7e4, -65519.9, 6e-8,
                        5.9e-8, 1e-10, -1e-10, 3.4e38, -3.4e38], np.float32)
    x[::n // special.size][:special.size] = special
    x = torch.from_numpy(x).to(dev)
    seed = 0x5EED5EED5EED
    sr_err = 0.0

    def same_bits(a, b):
        nan = torch.isnan(a)
        return (torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int16)[~nan],
                                b.view(torch.int16)[~nan]))

    for dtype in (torch.bfloat16, torch.float16):
        out = RD.stochastic_round_cuda(x, seed, dtype)
        torch.cuda.synchronize()
        plain = RD.stochastic_round_plain(x, seed, dtype)
        check(out.dtype == dtype and out.shape == (n,),
              f"stochastic_round {dtype}: wrong shape or dtype")
        differ = int((out.view(torch.int16) != plain.view(torch.int16))[
            ~torch.isnan(out)].sum().item())
        check(same_bits(out, plain), f"stochastic_round {dtype}: {differ} "
              "elements differ from the plain version")
        check(same_bits(out, RD.stochastic_round_cuda(x, seed, dtype)),
              f"stochastic_round {dtype}: one seed gave two results")
        other = RD.stochastic_round_cuda(x, seed + 1, dtype)
        moved = (out.view(torch.int16) != other.view(torch.int16)
                 ).float().mean().item()
        check(moved > 0.1, f"stochastic_round {dtype}: another seed moved "
              f"only {moved:.3f} of the elements")
        fin = torch.isfinite(out.float()) & torch.isfinite(plain.float())
        sr_err = max(sr_err, (out.float() - plain.float())[fin].abs()
                     .max().item())
        # one of the two neighbours of x
        r = out.float()
        if dtype == torch.bfloat16:
            ok_x = torch.isfinite(x)
            bits = x.view(torch.int32)
            down = (bits & -65536).view(torch.float32)
            up = ((bits + 65535) & -65536).view(torch.float32)
        else:
            ok_x = torch.isfinite(x) & (x.abs() < 65504.0)
            near = x.to(dtype)
            down = near.float()
            up = torch.where(
                x >= down, RD._f16_neighbour(near, True).float(),
                RD._f16_neighbour(near, False).float())
        inside = ((r == down) | (r == up))[ok_x]
        check(bool(inside.all().item()), f"stochastic_round {dtype}: "
              f"{int((~inside).sum().item())} results are no neighbour of x")
        log(f"phase 18 stochastic_round {dtype}: bit-equal to the plain "
            f"version on {n} elements, one seed one result, seed + 1 moves "
            f"{moved:.3f} of them, every result a neighbour of x: pass")
    x0 = 1.0 + 1.0 / 512.0
    r = RD.stochastic_round_cuda(torch.full((n,), x0, device=dev), 7).float()
    share = (r > 1.0).float().mean().item()
    mean = r.double().mean().item()
    # a quarter of the way between two bf16 values 2^-7 apart: the share
    # rounded up is binomial; at 16M its gates are 9 and 12 standard
    # deviations, a smaller run widens them to 6
    sd = (0.25 * 0.75 / n) ** 0.5
    share_tol, mean_tol = max(1e-3, 6 * sd), max(1e-5, 6 * sd * 2.0 ** -7)
    ok = (bool(((r == 1.0) | (r == 1.0 + 2.0 ** -7)).all().item())
          and abs(share - 0.25) < share_tol and abs(mean - x0) < mean_tol)
    log(f"phase 18 stochastic_round of 1 + 1/512: share rounded up "
        f"{share:.6f} (gate 0.25 +- {share_tol:.1e}, standard deviation "
        f"{sd:.1e}), mean - x {mean - x0:.3e} (gate {mean_tol:.1e}, "
        f"standard deviation {sd * 2.0 ** -7:.1e}): "
        f"{'pass' if ok else 'FAIL'}")
    check(ok, "stochastic_round is biased on 1 + 1/512")

    # -- phase 19: the paths, counted ----------------------------------------
    reset_launch_counts()
    gen = PCG32.create(n, device=dev)
    mass = normal_bin_mass(bins, HIST_LO, HIST_HI)
    for it in range(HIST_ITERS):      # chained: iteration i + 1 needs i
        hist, gen, idx = mini_app_step(gen)
        torch.cuda.synchronize()
        got = hist.cpu().numpy().astype(np.float64)
        idx_h = idx.cpu().numpy()
        want = np.bincount(idx_h[(idx_h >= 0) & (idx_h < bins)],
                           minlength=bins).astype(np.float64)
        total = got.sum()
        full = mass * n > 2e5     # a 1% gate is then > 4 standard deviations
        rel = np.append(
            np.abs(got[full] - mass[full] * n) / (mass[full] * n), 0.0)
        ok = (hist.shape == (bins,) and np.isfinite(got).all()
              and np.array_equal(got, want) and 0.999 * n < total <= n
              and rel.max() < 0.01)
        log(f"phase 19 mini-app iteration {it}: {int(total)} of {n} "
            f"samples binned, counts == float64 bincount of the indices: "
            f"{np.array_equal(got, want)}; {int(full.sum())} well-filled "
            f"bins within {rel.max():.3%} of the normal mass (gate 1%): "
            f"{'pass' if ok else 'FAIL'}")
        check(ok, f"mini-app iteration {it}")
    launches = dict(LAUNCHES)
    check(launches == {"hist": HIST_ITERS, "hist_reduce": HIST_ITERS},
          f"expected one hist (+ reduce) per iteration, got {launches}")

    b0 = 31
    wg = w.clone().requires_grad_(True)
    ops.histogram(idx, bins, wg)[b0].backward()
    check(torch.equal(wg.grad, (idx == b0).float()),
          "the weighted histogram's gradient is not (idx == b0)")
    log(f"phase 19 d histogram(idx, {bins}, w)[{b0}] / dw == (idx == {b0})"
        f" on {n} lanes: pass")

    delta = 2.0 ** -12
    acc = torch.ones(n, dtype=torch.bfloat16, device=dev)
    acc_rn = acc.clone()
    for step in range(ACC_UPDATES):
        acc = RD.stochastic_round_cuda(acc.float() + delta, seed + step)
        acc_rn = (acc_rn.float() + delta).to(torch.bfloat16)
    torch.cuda.synchronize()
    want = 1.0 + ACC_UPDATES * delta
    mean = acc.double().mean().item()
    ok = (bool((acc_rn == 1.0).all().item()) and abs(mean - want) < 1e-4
          and bool(torch.isfinite(acc.float()).all().item()))
    log(f"phase 19 bf16 accumulator, {ACC_UPDATES} updates of 2^-12 on {n} "
        f"values: round-to-nearest stays at {acc_rn.float().mean().item()}, "
        f"stochastic mean {mean:.7f} (exact {want:.7f}, gate 1e-4): "
        f"{'pass' if ok else 'FAIL'}")
    check(ok, "bf16 accumulator")
    launches = dict(LAUNCHES)
    log(f"phase 19 launches: {launches}")
    check(launches == {"hist": HIST_ITERS + 1, "hist_reduce": HIST_ITERS + 1,
                       "stochastic_round": ACC_UPDATES},
          f"expected {HIST_ITERS} + 1 hist (+ reduce) and {ACC_UPDATES} "
          f"stochastic_round launches, got {launches}")

    # -- phase 20: timing -----------------------------------------------------
    idx = idx_sets["normal"]
    t = {
        "hist": timer(lambda: H.hist(idx, bins), 200),
        "hist_w": timer(lambda: H.hist(idx, bins, w), 200),
        "hist_plain": timer(lambda: H.hist_plain(idx, bins), 5, 1000.0, True),
        "hist_w_plain": timer(lambda: H.hist_plain(idx, bins, w), 5, 1000.0,
                              True),
        "hist_lib": timer(lambda: library_hist(idx, bins), 20, 1000.0, True),
        "hist_w_lib": timer(lambda: library_hist(idx, bins, w), 20, 1000.0,
                            True),
        "sr": timer(lambda: RD.stochastic_round_cuda(x, seed), 200),
        "sr_f16": timer(lambda: RD.stochastic_round_cuda(
            x, seed, torch.float16), 200),
        "sr_plain": timer(lambda: RD.stochastic_round_plain(x, seed), 5,
                          2000.0, True),
    }
    # hist reads the indices (and the weights) once and writes the bins;
    # stochastic_round reads f32 and writes 16 bits per element
    hist_bound, hist_by = bound(4 * n + 4 * bins, HIST_FLOPS_PER_SAMPLE * n,
                                int_ops=HIST_INT_OPS_PER_SAMPLE * n)
    hist_w_bound, hist_w_by = bound(8 * n + 4 * bins,
                                    HIST_FLOPS_PER_SAMPLE * n,
                                    int_ops=HIST_INT_OPS_PER_SAMPLE * n)
    philox_ops = PHILOX_INT_OPS_PER_BLOCK * ((n + 3) // 4)
    sr_ops = philox_ops + ROUND_INT_OPS_PER_ELEMENT * n
    sr_bound, sr_by = bound(6 * n, 0, int_ops=sr_ops)
    f16_bound, f16_by = bound(
        6 * n, F16_ROUND_FLOPS_PER_ELEMENT * n,
        int_ops=philox_ops + F16_ROUND_INT_OPS_PER_ELEMENT * n)
    log(f"phase 20 hist counting {t['hist']:.5f} ms (plain "
        f"{t['hist_plain']:.4f} ms, torch.bincount {t['hist_lib']:.4f} ms, "
        f"bound {hist_bound:.5f} ms by {hist_by}); weighted "
        f"{t['hist_w']:.5f} ms (plain {t['hist_w_plain']:.4f} ms, "
        f"torch.bincount {t['hist_w_lib']:.4f} ms, bound "
        f"{hist_w_bound:.5f} ms by {hist_w_by}); {n} samples, {bins} bins, "
        f"the mini-app's normal indices")
    log(f"phase 20 stochastic_round bf16 {t['sr']:.5f} ms (plain "
        f"{t['sr_plain']:.4f} ms, bound {sr_bound:.5f} ms by {sr_by}; its "
        f"{sr_ops} integer operations alone "
        f"{1e3 * sr_ops / INT32_OPS_PER_S:.5f} ms), f16 {t['sr_f16']:.5f} "
        f"ms (bound {f16_bound:.5f} ms by {f16_by}); library call: none "
        f"rounds stochastically")

    # the mini-app's stages, each alone, and the chained iteration
    import math
    gen = PCG32.create(n, device=dev)
    u, _ = gen.next_float32()
    g = ops.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    scale = HIST_BINS / (HIST_HI - HIST_LO)
    stage = {
        "PCG32 next_float32": timer(lambda: gen.next_float32(), 20, 500.0),
        "erfinv(2u - 1) * sqrt 2": timer(
            lambda: ops.erfinv(2.0 * u - 1.0) * math.sqrt(2.0), 20, 500.0),
        "floor, clamp, cast": timer(
            lambda: torch.clamp(torch.floor((g - HIST_LO) * scale), -1.0,
                                float(HIST_BINS)).to(torch.int32), 20, 500.0),
        "histogram": timer(lambda: ops.histogram(idx, bins), 20, 500.0),
    }
    iters = 10
    samples = []
    for _ in range(3):
        gen_k = gen
        s, e = timer._events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        for _ in range(iters):
            hist, gen_k, _ = mini_app_step(gen_k)
        e.record()
        torch.cuda.synchronize()
        samples.append((1e3 * (time.perf_counter() - t0) / iters,
                        s.elapsed_time(e) / iters))
    wall_ms, dev_ms = min(samples)
    log("phase 20 mini-app stages, device ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage.items())
        + f" (sum {sum(stage.values()):.4f}); chained iteration, best of 3 "
        f"windows of {iters}: {wall_ms:.4f} ms wall, {dev_ms:.4f} ms "
        f"between CUDA events = {n / (wall_ms * 1e-3) / 1e9:.3f} G "
        f"samples/s (RNG + erfinv + histogram; all windows "
        f"{[round(a, 4) for a, _ in samples]} ms wall)")

    return [
        dict(name="hist", route="cuda",
             source="enoki_tpu_torch/csrc/hist.cu",
             replaces="enoki_tpu/ops/pallas_hist.py:44",
             launches=launches["hist"], max_abs_err=hist_err,
             ms=t["hist"], plain_ms=t["hist_plain"], bound_ms=hist_bound,
             bound_by=hist_by, library_ms=t["hist_lib"],
             weighted_ms=t["hist_w"], weighted_plain_ms=t["hist_w_plain"],
             weighted_bound_ms=hist_w_bound,
             weighted_library_ms=t["hist_w_lib"]),
        dict(name="stochastic_round", route="cuda",
             source="enoki_tpu_torch/csrc/stochastic_round.cu",
             replaces="enoki_tpu/ops/rounding.py:270",
             launches=launches["stochastic_round"], max_abs_err=sr_err,
             ms=t["sr"], plain_ms=t["sr_plain"], bound_ms=sr_bound,
             bound_by=sr_by, library_ms=None, f16_ms=t["sr_f16"],
             f16_bound_ms=f16_bound),
    ]


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed phase or gate ends the check
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
