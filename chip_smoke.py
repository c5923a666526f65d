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
           where it divides), pass 1's survivor list, sorted, equal to
           the plain list
  phase 10 the split render for (split, coarse) in (16,0), (32,0), (16,8):
           image and ts bit-equal to the one-pass kernel's and from run
           to run, the survivors' share, pass 1 (and its list, sorted)
           and the tail against their plain versions; no survivor: the
           tail launches and leaves pass 1's image
  phase 11 sdf_bwd_ad against sdf_bwd_ad_plain and against sdf_bwd, at
           the sizes, scenes and g of phase 2; two runs must be bitwise
           equal
  phase 12 the options' path: SDFRender(coarse=8) trained for a few SGD
           steps on each scene against the plain twin under the
           head-start gates, then one fwd+bwd step for each other option
           at the reference scene, each counted; timing of
           each new kernel alone with its bound and plain version; the
           issue floor of each sdf_fwd instantiation and of sdf_fwd_split
           (the SASS instructions an iteration of its march loop issues
           times its warps' iterations, as phase 16 derives it; held
           below the measured time) with its busy-lane and block shares and
           ptxas's registers and spills; sdf_fwd at DENSE_N^2 (dense_floor:
           one launch counted in _build.ROUTES as the dense route, img and
           ts bit-equal to sdf_fwd_plain on the card and to the one-pixel
           route, bf16's two routes bit-equal), each route timed with its
           issue floor, the kernels line's sdf_fwd_dense entry (time,
           plain time, bound); sdf_tail's two floors (its
           survivors' evaluations packed 32 to a warp, and 32 consecutive
           survivors a warp in the card's list and in row-major order),
           the shipped tail against its three refill schedules, the split
           forward's device time (memset, pass 1, tail) and a split
           forward run under torch.cuda.set_sync_debug_mode("error");
           timing of the
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
  phase 21 the render functions the port gained last, on the card
           against their CPU results: unit_angle and unit_angle_z on 10^4
           pairs of unit vectors (rtol 1e-5, atol 1e-6), cross3 bit-equal,
           Vec3.of and Vec3.splat on the card by default,
           render_sdf_grads at 64^2, 64 steps (the image atol 1e-3, the
           gradient rtol 1e-2, atol 1e-3 * max(1, |g|max), the ambient
           gradient 1 within 1e-4)
  phase 22 the ops the port gained last (ops/router.py and ops/horiz.py,
           plain PyTorch), each on the card against the same call on the
           CPU, on seeded inputs of 2^20 elements: integer, bit, sign,
           select, layout, compress and partition results and the float
           elementwise ops bit-equal (dtype included), the safe_*
           gradients bit-equal, asin / acos within 1 ulp (float64 libm
           roundings), float reductions within 2^-22 * sum|x| per output
           (the card sums in another order; products 2^-22 * n * |p|),
           hmax / hmin / hmax_nested / hmin_nested on rows of +-0.0 in
           f16, bf16, f32 and f64 bit-equal with the sign of zero (C10),
           and the constructors, range_packets and extract on the card by
           default
  phase 23 every function of ops/math.py and ops/special.py (plain
           PyTorch) on the card, both impls, float32 and float64, on
           seeded inputs of 2^20 elements over each function's test range
           with the special values of the line planted at their head:
           poly bit-equal to the same call on the CPU (dtype included),
           but where it calls PyTorch's own float64 functions (16 ulp) or
           its log1p / expm1 (1 ulp; POLY_NATIVE_INSIDE); both impls
           under the bounds of the reference's tests against a float64
           truth computed on the host (numpy, scipy, mpmath on 1024
           points), PyTorch's float32 exp and log on the card at their
           measured bounds (NATIVE_GATES); bf16 of every wrapped function
           the float32 result rounded once; the special values at +-inf
           and +-0; math_ns; the masked branches' gradients finite; ops
           of Python values on the card
  phase 24 every public function of the eleven types/ modules the port
           gained last (half, idiv, morton, enum_array, color, complex,
           quaternion, matrix, matrix_soa, transform, sh; plain PyTorch)
           on the card against the same call on the CPU, on seeded inputs
           of 2^20 elements (2^18 quaternions and matrices): integers and
           bit patterns exact, floats bit-equal where only IEEE arithmetic
           and correctly rounded roots are inside (the poly impl, the
           closed-form det and inverse, the SoA matrices, sh), within N
           ulp of the result's norm where PyTorch's own functions are
           (norm<N>, ulp<N>), the dense matmul / matvec / sums within
           2^-22 * sum|terms| per output; the constructors on the card by
           default
  phase 25 the struct, AD and runtime layers (plain PyTorch, no kernel of
           their own): (a) every helper of struct/ and Masked on a struct
           of Vec3s and an int32 leaf at 2^20 lanes, the dispatchers and
           the instance registry with 3 and 16 instances, card against
           CPU bit-equal (dtype included; NaN as NaN; Masked by the
           Python numbers 3.0 and 0.1 in f32, f16 and bf16, C11), and the
           masked and
           partition dispatch timed at 2-32 instances (the card's
           crossover); (b) ad.backward of the main path's loss bit-equal
           to SDFRender's own gradient, one sdf_fwd and one sdf_bwd, held
           to the plain twin as phase 3 holds it; ad.forward and vmap of
           the safe functions and safe_mul card against CPU; (c) a
           checkpoint of SDFRender + Adam + a PCG32 of 2^20 lanes at
           1024^2, 64 steps: 3 steps, save_step, restore_latest into fresh
           objects, 3 steps, bitwise equal to 6 steps straight; (d)
           runtime on the card: memory_stats, whos, vectorization_report
           of a main-path step (2 kernel launches; its host syncs printed),
           assert_vectorized, compile_timings of a new generic scene (the
           cache hit under a tenth of the first call, nvcc included);
           (e) examples/calls_torch.py at 1024^2 lanes
  phase 26 dist/ at 1024^2 (plain PyTorch; the sphere's combined render):
           (a) init_distributed() makes a world of one through nccl (with
           its warning), render_sharded bit-equal to render_fused on the
           card and within the reference's gates of the CPU (max < 5e-3,
           mean < 1e-4); (b) both train steps from the perturbed scene of
           tests/test_dist.py, losses within rtol 1e-4, each step's loss
           and SGD(1) update bit-equal to one process's autograd of the
           same loss on its grid; (c) fit_scene resumed from its
           checkpoint at step 4, bitwise equal to 6 steps straight; (d)
           one all-reduce of 40 B a step at 512^2 and 1024^2, the record
           against torch.profiler's c10d all-reduce events, the schedule
           report; (e) the shardmap step's wall and device ms (median and
           spread of windows) beside the card's name and power limit, the
           predicted efficiencies at 2-256 GPUs with that step time, and
           measured_weak_scaling's one-GPU row; (f) a 2x2 world of four
           processes sharing the card through gloo on CUDA tensors (NCCL
           refuses two ranks on one device): the assembled image
           bit-equal to the world of one's, losses and gradients within
           the reference's gates of it
  phase 27 torch.func.vmap and vmap(grad) of every kernel Function on
           batches of 3 at 1024^2 (render_sphere_cuda f32 and bf16,
           render_sdf_cuda plain, coarse=8 and split=16, the composed
           generic scene, ops.histogram on 3 x 2^20 indices): bit-equal
           to the stacked unbatched calls, each kernel launched 3 times
           one call's count
  phase 28 the lazy trace (enoki_tpu_torch.trace) at 2^24 lanes
           through LazyArray, its operators, select, eval and numpy, each
           fused run of a schedule one generated kernel (trace/codegen.py
           on csrc/trace_kernel.cuh), its structures traced and built at
           setup: (a) 8 fuzz programs of the CPU tests' recipe (f32 and
           f64) against the plain interpreter on the card, IEEE-only ones
           bit-equal, those with transcendentals within 1 ulp, two of
           them against the CPU plain interpreter too; (b) 16M values ->
           cast(int32) -> scatter_add into 64 bins in one eval, counts
           equal to the plain interpreter's and torch.bincount's, every
           SCATTER_ADD route case bit-equal to the plain interpreter on
           the card, and the plain interpreter's lane sweep (every
           storage code through every op that reads other lanes) bitwise
           equal on the card and the CPU; (c) the
           10,444-op chain of tools/jit_overhead.py at 2^16 and 2^24,
           whole (kernels of at most 1,024 entries) and at max_fused_ops
           512, bit-equal, with its trace, schedule, nvcc, first-eval,
           cache-hit and kernel times and bound; (d) one launch a fused
           run; (e) printf's text the same from both routes; (f) a second
           process with the same trace_export_dir runs (a) without nvcc
  phase 29 the trace's AD tape and calls (trace/tape.py, trace/call.py),
           every derivative a trace program fused into generated kernels
           (counted as trace_vjp / trace_jvp), its structures built at
           setup in two rounds: (a) a FloatD fit at 1024^2 (a sphere's
           cx, cy, r from a target image, trace functions only), 10
           gradient steps, each step's gradients bit-equal to the same
           adjoint program under the plain interpreter on the card, step
           1 against the CPU within 2^-22 of its terms' sums, the loss
           falling, steps 2-10 no cache miss and no nvcc; (b) fuzz
           backward programs at 2^24 lanes and digamma (the port's opcode
           80) against the plain interpreter; (c) forward_from against
           the gradient; (d) registry_dispatch over 8 instances at 2^20
           lanes with a gradient, against the plain interpreter and the
           CPU; (e) a second process runs the fit's step 1 from the disk
           cache without nvcc; (f) the forward, adjoint and tangent
           programs' device times, their plain times and bounds
  phase 30 the lazy halves (ops/, types/, struct/, Vec3 over LazyArray)
           and the three lazy examples, every program one eval through
           the trace's kernels, their 55 structures traced and built at
           setup: (a) examples/lazy_sphere_torch.py at 1024^2, scalar and
           struct forms bit-equal to the plain interpreter on the card,
           the second frame a cache hit; (b) lazy_histogram_torch at
           16M samples, 32 bins, one eval, the counts equal to the plain
           interpreter's (and at 2^20 to the CPU's) but for samples
           within 1 ulp of a bin edge, counted, its wall time; (c)
           lazy_fit_torch at 1024^2, 10 steps, the reference's asserts,
           the loss falling at every step, every step's gradients
           bit-equal to the plain interpreter, steps 2-10 no build; (d)
           the 98 functions of
           tests/test_unified_surface.py in 16 programs at 2^20 lanes,
           kernels against the plain interpreter (bit-equal with IEEE
           operations only, 1 ulp with transcendentals) and lazy against
           the port's eager (rtol 3e-5 / atol 2e-6 native, 1e-6 poly);
           (e) lazy PCG32 bit-exact against the eager one, the composite
           types against their eager selves (phase 24's gates), the
           struct helpers and a struct-argument dispatch bit-equal to
           the CPU; then the times of (a)'s sphere and (c)'s adjoint,
           the phase30_* fields of the trace and trace_vjp rows
  phase 31 runtime.kernel_printf in a scene function: the composed scene
           of examples/composed_torch.py at 1024^2, 64 steps, printing a
           parameter and the distance in sdf_fn and the ray's origin in
           ray_fn; generic_fwd's device printf (fd 1, the thread of pixel
           (0, 0)) a prefix of the plain route's lines on the card, the
           rest of them equal to its last, ts bit-equal

Run from the root of the repository:  python chip_smoke.py
Needs one CUDA card; exits non-zero, printing no result, without one or
outside the repository. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists the kernels with their launches, errors, times
and bounds.
"""

import concurrent.futures
import contextlib
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N = 1024
STEPS = 64
EXTENT = 1.2
DENSE_N = 16384  # the benchmark's sphere cells: 1024^2 at 16 x 16 samples
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
OPS_N = 1 << 20                # elements of phase 22's inputs
MATH_N = 1 << 20               # elements of phase 23's inputs
TYPES_N = 1 << 20              # elements of phase 24's inputs
STRUCT_N = 1 << 20             # lanes of phase 25's structs
STRUCT_KS = (2, 4, 8, 16, 32)  # instance counts of phase 25's timing
CALLS_N = 1024                 # phase 25 (e): calls_torch at CALLS_N^2
DIST_N = 1024                  # phase 26's image side
DIST_FIT_STEPS = 6             # phase 26 (c): fit_scene steps (resumed at 4)
DIST_ITERS, DIST_WINDOWS = 20, 7  # phase 26 (e): timed windows of steps
DIST_WORLD = 4                 # phase 26 (f): the 2x2 world on one card
VMAP_N = 1024                  # phase 27's image side
VMAP_BATCH = 3                 # phase 27's batch of parameter vectors
VMAP_HIST_N = 1 << 20          # phase 27: indices an item of the histogram
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


# sdf_tail's refill schedules, timed beside the shipped kernel (a lane a
# list slot, then the slot a grid's lanes further on): a persistent warp
# refills its idle lanes from the work counter counters[1] once fewer than
# kTailRefillBelow lanes are busy, stepping its lanes together
# kTailStepsPerTrip steps between two votes; 1 refills whole warps, whose
# lanes march in march_z's own loop. The kernel that replaces the shipped
# one in csrc/sdf_render.cu:
TAIL_SCHEDULES = {32: "any lane idle", 16: "half the lanes idle",
                  1: "the whole warp idle (32 survivors at a time)"}
REFILL_TAIL = """constexpr int kTailRefillBelow = BELOW;
constexpr int kTailStepsPerTrip = STEPS;

""" + """__global__ void __launch_bounds__(kTailThreads)
sdf_tail_kernel(const float* __restrict__ params,
                const int2* __restrict__ pairs, int* __restrict__ counters,
                float* __restrict__ img, float* __restrict__ ts, int n,
                int n_tail, float step, float extent) {
  using O = Ops<float>;
  constexpr unsigned kAll = 0xffffffffu;
  const int count = counters[0];
  const int lanes = gridDim.x * kTailThreads;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const Shading sh{params[0], params[1], params[2], params[4],
                   params[5], params[6], params[7], params[8]};
  MarchParts<float> m = march_parts<float>(0.0f, 0.0f, sh.cx, sh.cy, sh.cz,
                                           params[3]);
  bool busy = false, ended = false;
  int i = 0, k = 0;
  float px = 0.0f, py = 0.0f, z = 0.0f, s = 0.0f;
  // a lane takes the survivor in list slot ``slot``, if there is one
  auto take = [&](int slot) {
    if (slot >= count) return;
    const int2 e = pairs[slot];
    i = e.x;
    z = __int_as_float(e.y);
    const int row = i / n;
    px = pixel_coord(i - row * n, step, extent);
    py = pixel_coord(row, step, extent);
    m = march_parts<float>(px, py, sh.cx, sh.cy, sh.cz, params[3]);
    k = -1;  // the replayed advance first
    busy = true;
  };
  // the first round is static, lane j of the grid on slot j: no atomic
  // (every warp drawing from one counter at once queued them all on one
  // address); the work counter hands out the slots from ``lanes`` on
  take(blockIdx.x * kTailThreads + threadIdx.x);
  bool drained = lanes >= count;
  for (;;) {
    // after a refill every idle lane holds a survivor unless the list is
    // drained: no lane busy means the warp is done
    if (__ballot_sync(kAll, busy) == 0u) break;
    if constexpr (kTailRefillBelow == 1) {
      // the warp refills only once every lane has ended: each lane
      // marches its survivor to the end in march_z's own loop
      if (busy) {
        s = dist_len<O>(m.rxy2, z);
        if (march_alive<float>(m, z, s)) z = O::add(z, O::sub(s, m.rad));
        march_z<float>(m, z, s, n_tail);
        busy = false;
        ended = true;
      }
    } else {
      // kTailStepsPerTrip steps a trip, every lane through the same
      // instructions: a lane that is not busy, or stops, keeps its z (and
      // evaluates its last distance again, to the same bits)
      do {
#pragma unroll
        for (int u = 0; u < kTailStepsPerTrip; ++u) {
          s = dist_len<O>(m.rxy2, z);
          const bool go =
              busy & (k < n_tail - 1) & march_alive<float>(m, z, s);
          ended = ended | (busy & !go);
          busy = go;
          if (go) {
            z = O::add(z, O::sub(s, m.rad));
            ++k;
          }
        }
      } while (drained ? __any_sync(kAll, busy)
               : kTailRefillBelow == 32
                   ? __all_sync(kAll, busy)
                   : __popc(__ballot_sync(kAll, busy)) >= kTailRefillBelow);
    }
    if (ended) {  // the marches that ended: their pixels
      write_pixel(sh, px, py, O::sub(z, m.z0), O::sub(s, m.rad) < m.eps,
                  static_cast<size_t>(i), img, ts);
      ended = false;
    }
    const unsigned idle = __ballot_sync(kAll, !busy);
    if (idle != 0u && !drained) {
      const int leader = __ffs(idle) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counters + 1, __popc(idle));
      base = lanes + __shfl_sync(kAll, base, leader);
      drained = base + __popc(idle) >= count;
      if (!busy) take(base + __popc(idle & below));
    }
  }
}
"""
SHIPPED_TAIL = ("__global__ void __launch_bounds__(kTailThreads)\n"
                "sdf_tail_kernel(")


def function_text(text, head):
    """The definition that starts with ``head`` in ``text``, up to its
    closing brace at the start of a line."""
    start = text.index(head)
    return text[start:text.index("\n}\n", start) + 2]


def tail_schedule_sources(steps=2):
    """{refill threshold: csrc/sdf_render.cu with its sdf_tail replaced by
    the refill kernel of that schedule, ``steps`` steps a vote}."""
    from enoki_tpu_torch import _build
    text = (_build.CSRC_DIR / "sdf_render.cu").read_text()
    shipped = function_text(text, SHIPPED_TAIL)
    return {below: text.replace(shipped, REFILL_TAIL.replace(
        "BELOW", str(below)).replace("STEPS", str(steps)).rstrip("\n"))
        for below in TAIL_SCHEDULES}


def fwd_footprint(source="generic_render.cuh", dense=False):
    """A march kernel's footprint, read from its source in csrc/
    (generic_fwd's skeleton, or sdf_render.cu for sdf_fwd): (warp
    columns, block columns, block rows). A warp takes a cols x (32 /
    cols) tile of pixels, a block a block columns x block rows rectangle
    of them (common.cuh's tile_pixel). With ``dense``, sdf_fwd_dense's
    (sdf_render.cu): (patch columns, patch rows, warps a block). A thread
    takes a patch, a warp's threads 32 columns x patch columns x patch
    rows rows, and a block stacks its warps down."""
    import re

    from enoki_tpu_torch import _build
    text = (_build.CSRC_DIR / source).read_text()
    found = re.search(
        r"constexpr int kPatchCols = (\d+), kPatchRows = (\d+), "
        r"kDenseWarps = (\d+);" if dense else
        r"constexpr int kWarpCols = (\d+), kBlockCols = (\d+), "
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


def loop_counts(sass, kernel, innermost=False):
    """(first address, back branch's address, instructions laid out
    between them, instructions an iteration issues) of the largest loop
    (with ``innermost``, the smallest: a persistent kernel's march inside
    its refill loop) of the function whose mangled name holds ``kernel``
    in ``sass``
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

    # the largest (smallest) backward branch that an iteration reaches: a
    # slow path laid out past the kernel's end branches back into the loop
    # too
    for first, last in sorted(
            ((b[0], ins[i][0]) for i in range(len(ins))
             if (b := branch(i)) and b[0] is not None and b[0] < ins[i][0]),
            key=lambda lp: (lp[1] - lp[0]) * (1 if innermost else -1)):
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


def dense_warp_iterations(adv, n_steps, patch):
    """The loop iterations sdf_fwd_dense's warps run for a march of
    ``adv`` advances a pixel, a warp on 32 columns x ``patch`` (= patch
    columns x patch rows) rows of them: a thread's loop runs while one of
    its rays advances, up to the cap of n_steps - 1 iterations, so a
    warp's runs min(its largest advance count + 1, n_steps - 1) (its
    distances' last evaluation, after the loop, is not counted)."""
    return int(tile_max(adv, 32, patch).add(1).clamp(max=n_steps - 1)
               .sum().item())


def forced_route(K, route):
    """A context in which ``K.sdf_fwd`` (``K`` sdf_kernels) takes
    ``route``, "dense" or "pixel", for the z-carry march at every n:
    ``K.DENSE_MIN_N`` patched."""
    from unittest import mock
    return mock.patch.object(K, "DENSE_MIN_N",
                             0 if route == "dense" else 1 << 30)


def dense_floor(torch, K, p, timer, n=None):
    """Phase 12's sdf_fwd at n^2 (DENSE_N unless given; the z-carry march,
    64 steps), where fwd_route takes the dense route. One forward, its
    launch and route counted (_build.LAUNCHES, _build.ROUTES), held
    bit-equal (img and ts) to sdf_fwd_plain on the card and to the
    one-pixel route; the bf16 march's two routes bit-equal too. Each
    route's time and its issue floor (derived, not measured): the SASS an
    iteration of its march loop issues, from cuobjdump, times its warps'
    iterations (the plain march's counts: a one-pixel warp's longest
    lane's evaluations, a dense warp's dense_warp_iterations) over the
    card's issue rate; the plain version's time, and the bound from this
    scene's work as phase 4 counts it. Returns the log line and the
    kernels line's sdf_fwd_dense entry."""
    from enoki_tpu_torch import _build
    n = n or DENSE_N
    check(K.fwd_route(n) == "dense", f"sdf_fwd's route at {n}^2 is "
          f"{K.fwd_route(n)}, not the dense route")
    lib_path = _build.build("sdf_render")
    sass = sass_of(lib_path)
    rate, rate_text = issue_rate(torch)
    cols, rows, _ = fwd_footprint("sdf_render.cu", dense=True)
    kernels = {"dense": "sdf_fwd_dense_kernelIfE",
               "pixel": "sdf_fwd_kernelIfLb0ELb0EE"}

    def fwd(route, dtype=torch.float32):
        with forced_route(K, route):
            return K.sdf_fwd(p, n, STEPS, EXTENT, None, dtype)

    def equal(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    _build.reset_launch_counts()
    dense = K.sdf_fwd(p, n, STEPS, EXTENT)
    launches = _build.ROUTES["sdf_fwd.dense"]
    check(dict(_build.LAUNCHES) == {"sdf_fwd": 1}
          and dict(_build.ROUTES) == {"sdf_fwd.dense": 1},
          f"sdf_fwd at {n}^2: launches {dict(_build.LAUNCHES)}, routes "
          f"{dict(_build.ROUTES)}; one sdf_fwd by the dense route expected")
    plain = K.sdf_fwd_plain(p, n, STEPS, EXTENT)
    err = max((a - b).abs().max().item() for a, b in zip(dense, plain))
    check(equal(dense, plain), f"sdf_fwd's dense route differs from "
          f"sdf_fwd_plain at {n}^2: max |diff| {err}")
    del plain
    check(equal(dense, fwd("pixel")), f"sdf_fwd's dense route differs "
          f"from its pixel route at {n}^2")
    hits = int((dense[1] >= 0).sum().item())
    del dense
    check(equal(fwd("dense", torch.bfloat16), fwd("pixel", torch.bfloat16)),
          f"sdf_fwd_bf16's dense route differs from its pixel route at "
          f"{n}^2")
    torch.cuda.empty_cache()
    ms = {route: timer(lambda route=route: fwd(route), 20)
          for route in kernels}
    plain_ms = timer(lambda: K.sdf_fwd_plain(p, n, STEPS, EXTENT), 1,
                     hold_ms=1000.0, plain=True)
    evals, adv = K.march_counts(p, n, STEPS, EXTENT)
    total, advances = int(evals.sum().item()), int(adv.sum().item())
    bound_ms, bound_by = bound(
        8 * n * n + 64,
        FWD_FLOPS_PER_EVAL * total + FWD_FLOPS_PER_ADVANCE * advances
        + (FWD_FLOPS_PER_PIXEL + FWD_FLOPS_HIT_TEST) * n * n
        + FWD_FLOPS_PER_HIT * hits)
    check(bound_ms <= ms["dense"], f"sdf_fwd's dense route: its bound "
          f"{bound_ms:.5f} ms is above its time {ms['dense']:.5f} ms")
    pixel_cols = fwd_footprint("sdf_render.cu")[0]
    iters = {"dense": dense_warp_iterations(adv, STEPS, cols * rows),
             "pixel": warp_evaluations(evals, pixel_cols)}
    slots = {"dense": 32 * cols * rows, "pixel": 32}
    del evals, adv
    parts = []
    for route, kernel in kernels.items():
        loop_ins = loop_counts(sass, kernel)[3]
        floor_ms = 1e3 * loop_ins * iters[route] / rate
        check(floor_ms <= ms[route], f"sdf_fwd's {route} route: its issue "
              f"floor {floor_ms:.5f} ms is above its time {ms[route]:.5f} ms")
        parts.append(
            f"the {route} route {ms[route]:.5f} ms, its loop {loop_ins} SASS "
            f"an iteration x {iters[route]} warp iterations (busy ray slots "
            f"{total / (slots[route] * iters[route]):.4f}) = {floor_ms:.5f} "
            f"ms, {floor_ms / ms[route]:.4f} of its time; ptxas: "
            + resources_text(lib_path, (kernel,)))
    line = (f"phase 12 sdf_fwd at {n}^2 ({total / n ** 2:.3f} evaluations a "
            f"ray; patches of {rows} x {cols}; one launch, route dense; "
            f"img and ts bit-equal to sdf_fwd_plain and to the pixel route, "
            f"bf16's two routes bit-equal), issue floors (derived, not "
            f"measured) over {rate_text}: " + "; ".join(parts)
            + f"; the dense route takes {ms['dense'] / ms['pixel']:.4f} of "
            f"the pixel route's time; plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms by {bound_by}")
    row = dict(name="sdf_fwd_dense",
               replaces="enoki_tpu/render/pallas_kernels.py:504",
               route="cuda", source="enoki_tpu_torch/csrc/sdf_render.cu",
               launches=launches, max_abs_err=err, ms=ms["dense"],
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None)
    return line, row


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
    vector_loads = vector_loads or (
        lambda g, ts, n: K.float4_rows(n, g, ts))
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
        (print_scene if name == "printing" else scenes[name])[0].kernels.lib
        return time.perf_counter() - t_start

    # phase 31's scene, whose kernel prints
    print_scene = printing_scene()

    # sdf_tail's refill schedules, for phase 12
    schedules = list(tail_schedule_sources().values())
    # phase 28's trace structures, traced here and built in the pool; their
    # disk cache in a directory of this run's own, which (f) reads
    from enoki_tpu_torch.config import config
    import shutil
    export = _build.BUILD_DIR / "trace_export"
    shutil.rmtree(export, ignore_errors=True)
    config.trace_export_dir = str(export)
    trace_plans = trace_structures(torch, dev)
    n_texts = len({p.text for p in trace_plans.values()})
    with concurrent.futures.ThreadPoolExecutor(
            len(libs) + len(scenes) + 1 + len(schedules) + n_texts) as pool:
        # one nvcc per source, all at once
        built = pool.map(_build.build, libs)
        variants = pool.map(
            lambda t: _build.build_generated("sdf_render", t), schedules)
        scene_times = pool.map(build_scene, [*scenes, "printing"])
        trace_build_s = build_trace_plans(trace_plans, pool)
        first_use = dict(zip([*scenes, "printing"], scene_times))
        print_build_s = first_use.pop("printing")
        list(built)
        list(variants)
    for plan in trace_plans.values():
        plan.library()
    for name in libs:
        _build.load(name)
    log(f"build: {', '.join(f'{n}.cu' for n in libs)}, the generated "
        f"sources of {len(scenes)} scenes and of phase 28's {n_texts} trace "
        f"structures with nvcc {' '.join(_build.NVCC_FLAGS)} in "
        f"{time.perf_counter() - t0:.2f} s (trace sources: "
        f"{', '.join(f'{v:.1f}' for v in trace_build_s.values())} s)")

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
        p_ref, g_ref, ts_ref, N, EXTENT), K.float4_rows(N, g_ref, ts_ref))
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
    run_render_extras(torch, dev)
    run_ops_extras(torch, dev)
    run_math_extras(torch, dev)
    run_types_extras(torch, dev)
    run_struct_extras(torch, dev)
    run_dist(torch, dev)
    run_vmap(torch, dev, scenes)
    kernels += run_trace(torch, dev, timer, trace_plans, trace_build_s)
    kernels += run_tape(torch, dev, timer)
    # phase 30's lazy programs run the trace's kernels: their launches
    # join the trace's and its adjoints' rows, and the phase30_* fields
    # (launches, and the times, bound and error of one of its programs)
    # describe phase 30 alone
    lazy = run_lazy(torch, dev, timer)
    for row in kernels:
        if row["name"] in lazy:
            row["launches"] += lazy[row["name"]]["phase30_launches"]
            row.update(lazy[row["name"]])
    run_kernel_printf(torch, dev, print_scene, print_build_s)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


def run_render_extras(torch, dev):
    """Phase 21: cross3, unit_angle, unit_angle_z, Vec3.of, Vec3.splat and
    render_sdf_grads on the card against their CPU results."""
    from enoki_tpu_torch.render import (SDFScene, Vec3, cross3,
                                        render_sdf_grads, scene_to_vec)
    from enoki_tpu_torch.render.vec import unit_angle, unit_angle_z
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 3, 10_000))
    a /= np.linalg.norm(a, axis=0)
    b /= np.linalg.norm(b, axis=0)

    def vec(x, device):
        return Vec3(*(torch.from_numpy(c.astype(np.float32)).to(device)
                      for c in x))
    va, vb, ca, cb = vec(a, "cpu"), vec(b, "cpu"), vec(a, dev), vec(b, dev)
    worst = 0.0
    for got, want in ((unit_angle(ca, cb), unit_angle(va, vb)),
                      (unit_angle_z(ca), unit_angle_z(va))):
        got = got.cpu()
        worst = max(worst, (got - want).abs().max().item())
        check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6)),
              "unit_angle on the card differs from the CPU")
    c, w = cross3(ca, cb), cross3(va, vb)
    check(all(torch.equal(g.cpu(), x) for g, x in
              ((c.x, w.x), (c.y, w.y), (c.z, w.z))),
          "cross3 on the card differs from the CPU")
    check(Vec3.of(1, 2, 3).x.device.type == "cuda"
          and Vec3.splat(1.0, 2.0, 3.0).z.device.type == "cuda"
          and Vec3.of(1, 2, 3).y.dtype == torch.get_default_dtype(),
          "Vec3.of / Vec3.splat not on the card by default")
    img, g = render_sdf_grads(SDFScene.reference(dev), 64, 64)
    img_c, g_c = render_sdf_grads(SDFScene.reference("cpu"), 64, 64)
    gv, gc = scene_to_vec(g).cpu(), scene_to_vec(g_c)
    d_img = (img.cpu() - img_c).abs().max().item()
    tol = 1e-3 * max(1.0, gc.abs().max().item())
    ok = (d_img <= 1e-3 and bool(torch.isfinite(gv).all().item())
          and bool(torch.allclose(gv, gc, rtol=1e-2, atol=tol))
          and abs(gv[4].item() - 1.0) <= 1e-4)
    log(f"phase 21 unit_angle, unit_angle_z on 10^4 pairs: max|card - cpu| "
        f"{worst:.3e} (rtol 1e-5, atol 1e-6); cross3 bit-equal; Vec3.of / "
        f"splat on the card by default; render_sdf_grads at 64^2, 64 steps "
        f"(the march checkpointed per step): max|img - cpu| {d_img:.3e}, "
        f"max|grad - cpu| {(gv - gc).abs().max().item():.3e} (rtol 1e-2, "
        f"atol {tol:.3e}), d ambient {gv[4].item():.7g}: "
        f"{'pass' if ok else 'FAIL'}")
    check(ok, "render_sdf_grads on the card differs from the CPU")


def ops_gate(torch, got, want, kind, mag=None):
    """Phase 22's gate of one result: (passed, worst error).

    ``exact``: the same dtype and shape, and every value bit-equal (NaN to
    NaN, the sign of zero kept); ``ulp1``: floats within one unit in the
    last place; ``sum``: |got - want| <= 2^-22 * mag per output, mag being
    the sum of the magnitudes that output adds. The worst error is the
    largest |got - want| (in ulps for ``ulp1``)."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf")
    if not got.dtype.is_floating_point:
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        return bool((diff == 0).all()), float(diff.max()) if diff.numel() \
            else 0.0
    g, w = got.double(), want.double()
    nan = torch.isnan(g) | torch.isnan(w)
    same_nan = bool((torch.isnan(g) == torch.isnan(w)).all())
    diff = torch.where(nan | (g == w), 0.0, (g - w).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    if kind == "exact":
        sign = torch.signbit(g) == torch.signbit(w)
        return same_nan and bool(((diff == 0) & sign | nan).all()), err
    if kind.startswith("ulp"):
        ulp = torch.where(nan, 0.0, torch.abs(
            torch.nextafter(want, torch.full_like(want, float("inf")))
            .double() - w))
        over = torch.where(nan | (diff == 0), 0.0, diff / ulp)
        worst = float(over.max()) if over.numel() else 0.0
        return same_nan and worst <= float(kind[3:]), worst
    tol = 2.0 ** -22 * torch.as_tensor(mag, dtype=torch.float64)
    return same_nan and bool((diff <= tol).all()), err


def _grad_of(torch, fn):
    def grad(x):
        x = x.detach().requires_grad_(True)
        fn(x).sum().backward()
        return x.grad
    return grad


def ops_cases(torch, n, seed=22):
    """Phase 22's cases: (name, gate, function, inputs as numpy, mag).
    ``mag`` (for the ``sum`` gate) is computed from the inputs."""
    from enoki_tpu_torch import ops
    from enoki_tpu_torch.ops import horiz

    rng = np.random.default_rng(seed)

    def floats(scale=3.0):
        return (rng.standard_normal(n) * scale).astype(np.float32)

    a, b, c = floats(), floats(), floats()
    t = rng.random(n).astype(np.float32)
    u = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    p = (1.0 + 0.001 * rng.standard_normal(n)).astype(np.float32)
    i32 = rng.integers(-2**31, 2**31, n).astype(np.int32)
    j32 = rng.integers(-2**31, 2**31, n).astype(np.int32)
    u32, v32 = i32.view(np.uint32), j32.view(np.uint32)
    k = rng.integers(-40, 70, n).astype(np.int32)
    m = rng.random(n) < 0.5
    keys = rng.integers(-2, 1030, n).astype(np.int32)
    v3 = floats().reshape(-1, 4)[:, :3].copy()
    w3 = floats().reshape(-1, 4)[:, :3].copy()
    table = np.sort(floats())
    q = floats()
    cases = []

    def add(name, gate, fn, *args, mag=None):
        cases.append((name, gate, fn, args, mag))

    for name in ("fmadd", "fmsub", "fnmadd", "fnmsub", "fmaddsub",
                 "fmsubadd"):
        add(name, "exact", getattr(ops, name), a, b, c)
    add("lerp", "exact", ops.lerp, a, b, t)
    for name in ("rcp", "sign", "abs_", "sqr", "sqrt", "deg_to_rad",
                 "rad_to_deg", "isdenormal", "safe_rsqrt"):
        add(name, "exact", getattr(ops, name), a)
    add("clamp", "exact", lambda x: ops.clamp(x, -1.0, 2.0), a)
    for name in ("copysign", "mulsign", "copysign_neg", "mulsign_neg"):
        add(name, "exact", getattr(ops, name), a, b)
        add(name + " int32", "exact", getattr(ops, name), i32, j32)
    add("cross", "exact", ops.cross, v3, w3)
    for name in ("safe_asin", "safe_acos"):
        add(name, "ulp1", getattr(ops, name), u)
    for name in ("safe_rsqrt", "safe_asin", "safe_acos", "safe_sqrt"):
        add(name + " grad", "exact", _grad_of(torch, getattr(ops, name)),
            u if name != "safe_rsqrt" else a)
    for name in ("popcnt", "lzcnt", "tzcnt", "log2i"):
        add(name + " int32", "exact", getattr(ops, name), i32)
        add(name + " uint32", "exact", getattr(ops, name), u32)
    for name in ("ror", "rol"):
        add(name + " int32", "exact", getattr(ops, name), i32, k)
        add(name + " uint32", "exact", getattr(ops, name), u32,
            k.view(np.uint32))
    add("mulhi int32", "exact", ops.mulhi, i32, j32)
    add("mulhi uint32", "exact", ops.mulhi, u32, v32)
    add("tile", "exact", lambda x: ops.tile(x, 2), u32)
    add("repeat", "exact", lambda x: ops.repeat(x, 2), a)
    add("reverse", "exact", ops.reverse, u32)
    add("horiz.reverse", "exact", horiz.reverse, v3)
    add("head, tail, concat", "exact", lambda x, y: ops.concat(
        ops.head(x, n // 3), ops.tail(y, n // 5)), u32, v32)
    add("extract", "exact", ops.extract, a, m)
    add("binary_search", "exact", lambda tb, qq: ops.binary_search(
        0, n, lambda i: tb[i.long().clamp(max=n - 1)] < qq, tb.device),
        table, q)
    add("compress", "exact", lambda x, mm: ops.compress(x, mm, 7)[0], a, m)
    add("compress count", "exact", lambda x, mm: ops.compress(x, mm)[1],
        a, m)
    for out, part in enumerate(("unique", "counts", "perm")):
        add(f"partition {part}", "exact",
            lambda kk, out=out: ops.partition(kk, 1024)[out], keys)
    add("segment_offsets", "exact", lambda kk: ops.segment_offsets(
        ops.partition(kk, 1024)[1]), keys)
    for name in ("hmax", "hmin", "hmax_nested", "hmin_nested"):
        add(name, "exact", getattr(ops, name), a)
        add(name + " uint32", "exact", getattr(ops, name), u32)
    for name in ("hsum", "hprod", "psum", "hsum_nested", "hprod_nested"):
        add(name + " int32", "exact", getattr(ops, name), i32)
    for name in ("all_", "any_", "none", "count", "all_nested",
                 "any_nested", "none_nested", "count_nested"):
        add(name, "exact", getattr(ops, name), m)
    add("psum bool", "exact", ops.psum, m)
    s_a = float(np.abs(a).sum())
    add("hsum", "sum", ops.hsum, a, mag=s_a)
    add("hsum_nested", "sum", ops.hsum_nested, a, mag=s_a)
    add("hmean", "sum", ops.hmean, a, mag=s_a / n)
    add("hsum axis 0", "sum", lambda x: ops.hsum(x, 0), v3,
        mag=np.abs(v3).sum(0))
    add("psum", "sum", ops.psum, a, mag=np.cumsum(np.abs(a)))
    prod = float(np.prod(p.astype(np.float64)))
    add("hprod", "sum", ops.hprod, p, mag=n * abs(prod))
    add("hprod_nested", "sum", ops.hprod_nested, p, mag=n * abs(prod))
    ab = float(np.abs(a * b).sum())
    add("dot", "sum", ops.dot, a, b, mag=ab)
    add("abs_dot", "sum", ops.abs_dot, a, b, mag=ab)
    add("squared_norm", "sum", ops.squared_norm, a, mag=float((a * a).sum()))
    nrm = float(np.sqrt((a.astype(np.float64) ** 2).sum()))
    add("norm", "sum", ops.norm, a, mag=nrm)
    # the sum's 2^-22 halves under the root; 2 more roundings
    unit = v3 / np.linalg.norm(v3.astype(np.float64), axis=-1, keepdims=True)
    add("normalize", "sum", ops.normalize, v3, mag=2.0 * np.abs(unit))
    add("allclose", "exact", lambda x, y: torch.tensor(
        [ops.allclose(x, y), ops.allclose(x, y + 1e-2)]), a, a * (1 + 1e-4))
    # C10: rows of +-0.0 mixed with negatives (max) or positives (min), so
    # that most extremes are a zero whose sign the reduction chooses
    zeros = np.where(rng.random((8, n // 8)) < 0.5, 0.0, -0.0)
    other = np.abs(rng.standard_normal((8, n // 8))) + 0.5
    pick = rng.random((8, n // 8)) < 0.6
    signed = {"max": np.where(pick, zeros, -other).astype(np.float64),
              "min": np.where(pick, zeros, other).astype(np.float64)}
    for dt in ("float16", "bfloat16", "float32", "float64"):
        for name in ("hmax", "hmin", "hmax_nested", "hmin_nested"):
            for axis in ((None,) if "nested" in name else (0, 1, None)):
                add(f"{name} signed zeros {dt} axis {axis}", "exact",
                    lambda x, name=name, axis=axis, dt=dt: getattr(
                        ops, name)(x.to(getattr(torch, dt)),
                                   *(() if axis is None else (axis,))),
                    signed[name[1:4]])
    return cases


def run_ops_extras(torch, dev):
    """Phase 22: every function of ops/router.py and ops/horiz.py that the
    port gained last, on the card against the same call on the CPU."""
    from enoki_tpu_torch import ops

    t0 = time.perf_counter()
    cases = ops_cases(torch, OPS_N)
    worst = {"exact": 0.0, "ulp1": 0.0, "sum": 0.0}
    failed = []
    for name, gate, fn, args, mag in cases:
        cpu = [torch.from_numpy(x) for x in args]
        got = fn(*(x.to(dev) for x in cpu))
        want = fn(*cpu)
        ok, err = ops_gate(torch, got, want, gate, mag)
        worst[gate] = max(worst[gate], err)
        if not ok:
            failed.append(f"{name} ({gate}, error {err:.3e})")
    on_card = True
    if dev.type == "cuda":
        packets = list(ops.range_packets(10, 4))
        on_card = (all(x.device.type == "cuda" for x in (
            ops.zeros(4), ops.full(4, 2.0), ops.empty(4), ops.arange(4),
            packets[0][0], packets[-1][1], ops.popcnt(7), ops.sign(-0.0),
            ops.hsum([1.0, 2.0]), ops.partition([5, 0, 1], 2)[2],
            ops.binary_search(0, 8, lambda i: i < 3)))
            and ops.arange(4).dtype == torch.int32
            and ops.prefetch(ops.zeros(4), ops.arange(2)) is None
            and bool(torch.isnan(ops.empty(4)).all()))
    log(f"phase 22 {len(cases)} cases of the ops the port gained last on "
        f"2^{OPS_N.bit_length() - 1} elements, card against CPU: bit-equal "
        f"cases max|d| {worst['exact']:.3e}, asin / acos "
        f"{worst['ulp1']:.3f} ulp, reductions max|d| {worst['sum']:.3e} "
        f"(gate 2^-22 * sum|x| per output); constructors, range_packets "
        f"and ops of Python values on the card by default: {on_card}; "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{'pass' if not failed and on_card else 'FAIL ' + '; '.join(failed)}")
    check(not failed, "phase 22: " + "; ".join(failed))
    check(on_card, "phase 22: the constructors are not on the card by "
          "default")


# -- phase 23: ops/math.py and ops/special.py --------------------------------


def ulp_of(got, want, dtype):
    """conftest.ulp_error: |got - want| over the spacing of the float64
    truth ``want`` rounded to ``dtype`` (the correctly rounded result
    scores 0)."""
    w = np.asarray(want, np.float64).astype(dtype)
    return (np.abs(np.asarray(got, np.float64) - w.astype(np.float64))
            / np.spacing(np.abs(w)).astype(np.float64))


def ulp_gate(max_ulp, mean_ulp):
    """check_accuracy's gate, where the truth is finite and non-zero."""
    def gate(got, want, dtype, args):
        keep = np.isfinite(want) & (want != 0)
        u = ulp_of(got[keep], want[keep], dtype)
        return (float(u.max()) <= max_ulp and float(u.mean()) <= mean_ulp,
                f"{max_ulp}/{mean_ulp} ulp")
    return gate


def err_gate(kind, tol=0.0, keep=None):
    """tests/test_special.py's gates: ``abs`` |got - want| < tol, ``rel``
    |got - want| / max(|want|, 1e-30) < tol, ``exact`` got == want, where
    the truth is finite (and ``keep(want)``)."""
    def gate(got, want, dtype, args):
        k = np.isfinite(want) & (keep(want) if keep else True)
        d = np.abs(np.asarray(got, np.float64)[k] - want[k])
        if kind == "exact":
            return bool((d == 0).all()), "exact"
        if kind == "rel":
            d = d / np.maximum(np.abs(want[k]), 1e-30)
        return bool((d < tol).all()), f"{kind} {tol:g}"
    return gate


def lgamma64_gate(got, want, dtype, args):
    """tests/test_special.py:303-333, range by range: 4, 8, 16 and 5 ulp
    on (0, 0.5), [0.5, 2.75), [2.75, 8) and [8, inf)."""
    x = args[0].astype(np.float64)
    bound = np.select([x < 0.5, x < 2.75, x < 8.0], [4.0, 8.0, 16.0], 5.0)
    keep = want != 0
    u = np.abs(got - want)[keep] / np.spacing(np.abs(want[keep]))
    return bool((u <= bound[keep]).all()), "4/8/16/5 ulp by range"


def mp_truth(name):
    """mpmath at 40 digits (the reference's f64 gates take it: scipy's
    float64 erfc is 8-12 ulp off near 0.9)."""
    import mpmath as mp
    mp.mp.dps = 40
    fn = {"erf": mp.erf, "erfc": mp.erfc, "erfi": mp.erfi,
          "lgamma": mp.loggamma,
          "dawson": lambda v: mp.sqrt(mp.pi) / 2 * mp.exp(-mp.mpf(v) ** 2)
          * mp.erfi(mp.mpf(v)),
          "i0e": lambda v: mp.besseli(0, v) * mp.exp(-abs(v))}[name]
    return lambda x: np.array([float(fn(float(v))) for v in x])


MP_POINTS = 1024               # phase 23's float64 mpmath truths: first n


def ellint3_truth(phi, k, nu):
    """Pi with the reference's 1 + nu sin^2 convention, from scipy's
    Carlson forms: s R_F(c^2, 1 - k^2 s^2, 1)
    - nu/3 s^3 R_J(c^2, 1 - k^2 s^2, 1, 1 + nu s^2)."""
    import scipy.special as sp
    s, c = np.sin(phi), np.cos(phi)
    q = 1 - k * k * s * s
    return (s * sp.elliprf(c * c, q, 1.0)
            - nu / 3 * s ** 3 * sp.elliprj(c * c, q, 1.0, 1 + nu * s * s))


# phase 23's table. name: (argument ranges, float32 gate, float64 gate,
# truth); a range (lo, hi, "log") draws log-uniformly. The gates are the
# reference's (tests/test_math_accuracy.py, tests/test_special.py). Where
# it has none: 1/f (cot, csc, sec, csch, sech, coth) takes f's bounds plus
# one reciprocal's rounding, +1 max and +0.5 mean; exp2, log2 and cbrt in
# float64 the published f64 exp / log bound, 2 ulp (BASELINE.md §A);
# log1p and expm1, PyTorch's for both impls, the table's tightest, 1 ulp
MATH_TABLE = {
    "sin": ([(-8192, 8192)], ulp_gate(5, 0.45), ulp_gate(2, 0.5), np.sin),
    "cos": ([(-8192, 8192)], ulp_gate(5, 0.45), ulp_gate(2, 0.5), np.cos),
    "tan": ([(-8192, 8192)], ulp_gate(7, 0.6), ulp_gate(3, 0.6), np.tan),
    "cot": ([(-100, 100)], ulp_gate(8, 1.1), ulp_gate(4, 1.1),
            lambda x: 1 / np.tan(x)),
    "asin": ([(-1, 1)], ulp_gate(4, 0.5), ulp_gate(3, 0.5), np.arcsin),
    "acos": ([(-1, 1)], ulp_gate(4, 0.5), ulp_gate(3, 0.5), np.arccos),
    "atan": ([(-1000, 1000)], ulp_gate(12, 5), ulp_gate(2, 0.5), np.arctan),
    "exp": ([(-20, 30)], ulp_gate(1, 0.3), ulp_gate(2, 0.5), np.exp),
    "exp2": ([(-20, 30)], ulp_gate(2, 0.5), ulp_gate(2, 0.5), np.exp2),
    "log": ([(1e-20, 2e30, "log")], ulp_gate(1, 0.02), ulp_gate(2, 0.5),
            np.log),
    "log2": ([(1e-20, 2e30, "log")], ulp_gate(2.5, 0.5), ulp_gate(2, 0.5),
             np.log2),
    "log1p": ([(-0.9, 100)], ulp_gate(1, 0.1), ulp_gate(1, 0.1), np.log1p),
    "expm1": ([(-20, 30)], ulp_gate(1, 0.1), ulp_gate(1, 0.1), np.expm1),
    "cbrt": ([(-100, 100)], ulp_gate(4, 1), ulp_gate(2, 0.5), np.cbrt),
    "sinh": ([(-10, 10)], ulp_gate(3, 0.6), ulp_gate(3, 0.5), np.sinh),
    "cosh": ([(-10, 10)], ulp_gate(4, 0.6), ulp_gate(3, 0.5), np.cosh),
    "tanh": ([(-10, 10)], ulp_gate(7, 0.6), ulp_gate(3, 0.5), np.tanh),
    "csc": ([(-100, 100)], ulp_gate(6, 0.95), ulp_gate(3, 1.0),
            lambda x: 1 / np.sin(x)),
    "sec": ([(-100, 100)], ulp_gate(6, 0.95), ulp_gate(3, 1.0),
            lambda x: 1 / np.cos(x)),
    "csch": ([(-10, 10)], ulp_gate(4, 1.1), ulp_gate(4, 1.0),
             lambda x: 1 / np.sinh(x)),
    "sech": ([(-10, 10)], ulp_gate(5, 1.1), ulp_gate(4, 1.0),
             lambda x: 1 / np.cosh(x)),
    "coth": ([(-10, 10)], ulp_gate(8, 1.1), ulp_gate(4, 1.0),
             lambda x: 1 / np.tanh(x)),
    "asinh": ([(-30, 30)], ulp_gate(6, 1), ulp_gate(3, 0.5), np.arcsinh),
    "acosh": ([(1, 1000)], ulp_gate(6, 1), ulp_gate(2, 0.5), np.arccosh),
    "atanh": ([(-0.999, 0.999)], ulp_gate(6, 1), ulp_gate(2, 0.5),
              np.arctanh),
    "atan2": ([(-10, 10), (-10, 10)], err_gate("abs", 1e-5),
              err_gate("abs", 1e-5), np.arctan2),
    "pow": ([(0.01, 100), (-3, 3)], err_gate("rel", 1e-5),
            err_gate("rel", 1e-5), np.power),
    "hypot": ([(-1e30, 1e30), (-1e30, 1e30)], err_gate("rel", 1e-6),
              err_gate("rel", 1e-6), np.hypot),
    "fmod": ([(-100, 100), (0.1, 10)], err_gate("exact"),
             err_gate("exact"), np.fmod),
}
SPECIAL_TABLE = {
    "erf": ([(-6, 6)], err_gate("abs", 2e-7), ulp_gate(8, 1), "erf"),
    "erfc": ([(-4, 9)], err_gate("rel", 5e-5, lambda w: w > 1e-37),
             ulp_gate(8, 1), "erfc"),
    "erfinv": ([(-0.999, 0.999)], err_gate("abs", 5e-6), ulp_gate(12, 1),
               "erfinv"),
    "i0e": ([(-50, 50)], err_gate("rel", 1e-5), ulp_gate(6, 6), "i0e"),
    "dawson": ([(-20, 20)], err_gate("rel", 2e-6), ulp_gate(40, 4),
               "dawsn"),
    "erfi": ([(-3, 3)], err_gate("rel", 1e-4), ulp_gate(20, 20), "erfi"),
    "lgamma": ([(0.01, 30)], err_gate("abs", 1e-3), lgamma64_gate,
               "gammaln"),
    "tgamma": ([(0.1, 6)], err_gate("rel", 1e-4), err_gate("rel", 1e-4),
               "gamma"),
    "gamma": ([(0.1, 6)], err_gate("rel", 1e-4), err_gate("rel", 1e-4),
              "gamma"),
    "carlson_rf": ([(0, 5), (0.01, 5), (0.01, 5)], err_gate("rel", 1e-4),
                   err_gate("rel", 1e-4), "elliprf"),
    "carlson_rd": ([(0, 5), (0.01, 5), (0.01, 5)], err_gate("rel", 1e-4),
                   err_gate("rel", 1e-4), "elliprd"),
    "carlson_rc": ([(0, 5), (0.01, 5)], err_gate("rel", 1e-4),
                   err_gate("rel", 1e-4), "elliprc"),
    "carlson_rj": ([(0, 5), (0.01, 5), (0.01, 5), (0.01, 5)],
                   err_gate("rel", 1e-3), err_gate("rel", 1e-3), "elliprj"),
    "comp_ellint_1": ([(0, 0.95)], err_gate("abs", 1e-4),
                      err_gate("abs", 1e-4), "comp_ellint_1"),
    "ellint_1": ([(-1.54, 1.54), (0, 0.95)], err_gate("abs", 1e-4),
                 err_gate("abs", 1e-4), "ellint_1"),
    "comp_ellint_2": ([(0, 0.95)], err_gate("abs", 1e-4),
                      err_gate("abs", 1e-4), "comp_ellint_2"),
    "ellint_2": ([(-1.54, 1.54), (0, 0.95)], err_gate("abs", 1e-4),
                 err_gate("abs", 1e-4), "ellint_2"),
    "comp_ellint_3": ([(0, 0.9), (-0.5, 0.5)], err_gate("abs", 1e-3),
                      err_gate("abs", 1e-3), "comp_ellint_3"),
    "ellint_3": ([(-1.25, 1.25), (0, 0.9), (-0.5, 0.5)],
                 err_gate("abs", 1e-3), err_gate("abs", 1e-3), "ellint_3"),
}
# PyTorch's own float32 functions on the card that miss the reference's
# bound (1 ulp max and 0.3 mean for exp, 0.02 mean for log): CUDA
# documents 2 ulp for expf; measured on an H100 (max / mean ulp): exp 2 /
# 0.303 at 2^20 points; log 1 / 0.0349 at 2^20 and 1 / 0.0363 at 2^14.
# Gated at that
NATIVE_GATES = {("exp", "float32"): ulp_gate(2, 0.31),
                ("log", "float32"): ulp_gate(1, 0.04)}
# float64 truths from mpmath, on MP_POINTS points (as the reference's f64
# gates: scipy's float64 erfc is 8-12 ulp off near 0.9)
MP_F64 = ("erf", "erfc", "i0e", "dawson", "erfi", "lgamma")
# the functions with a native route besides their polynomial one
SPECIAL_NATIVE = ("erf", "erfc", "erfinv", "i0e", "erfi", "lgamma",
                  "tgamma", "gamma")
# poly cases that call PyTorch's own functions, which the card and the CPU
# compute differently: (name, dtype) -> (the card's gate, why). A float64
# function of the card (libdevice) and of the CPU differ by an ulp or two,
# and the kernel around it carries that on (R_F's duplication rounds, the
# erfc tail's Clenshaw sum, Newton's steps): 16 ulp, 3-7 measured. Below
# float64 the port takes them in float64 and rounds once (backend.
# _native), which gives the same bits on both
_F64_LIBM = "the float64 {} of the card and of the CPU"
POLY_NATIVE_INSIDE = {
    ("ellint_1", "float64"): ("ulp16", _F64_LIBM.format("sin/cos")),
    ("ellint_2", "float64"): ("ulp16", _F64_LIBM.format("sin/cos")),
    ("ellint_3", "float64"): ("ulp16", _F64_LIBM.format("sin/cos")),
    ("erf", "float64"): ("ulp16", _F64_LIBM.format("exp")),
    ("erfc", "float64"): ("ulp16", _F64_LIBM.format("exp")),
    ("erfinv", "float64"): ("ulp16", _F64_LIBM.format("exp/erf/erfc")),
    ("erfi", "float64"): ("ulp16", _F64_LIBM.format("exp")),
    ("lgamma", "float64"): ("ulp16", _F64_LIBM.format("log/sin")),
    ("tgamma", "float64"): ("ulp16", _F64_LIBM.format("log/sin")),
    ("gamma", "float64"): ("ulp16", _F64_LIBM.format("log/sin")),
    ("log1p", "float32"): ("ulp1", "PyTorch's log1p for both impls"),
    ("log1p", "float64"): ("ulp1", "PyTorch's log1p for both impls"),
    ("expm1", "float32"): ("ulp1", "PyTorch's expm1 for both impls"),
    ("expm1", "float64"): ("ulp1", "PyTorch's expm1 for both impls"),
}
# functions without an impl, or that ignore it: one case each
ONE_IMPL = ("hypot", "fmod", "log1p", "expm1")


def special_truth(key, args):
    import scipy.special as sp
    x = [a.astype(np.float64) for a in args]
    if hasattr(sp, key):
        return getattr(sp, key)(*x)
    if key == "comp_ellint_1":
        return sp.ellipkm1(1 - x[0] ** 2)
    if key == "comp_ellint_2":
        return sp.ellipe(x[0] ** 2)
    if key == "ellint_1":
        return sp.ellipkinc(x[0], x[1] ** 2)
    if key == "ellint_2":
        return sp.ellipeinc(x[0], x[1] ** 2)
    if key == "comp_ellint_3":
        return ellint3_truth(np.full_like(x[0], np.pi / 2), x[0], x[1])
    return ellint3_truth(*x)


def draw(rng, ranges, n, dtype):
    out = []
    for r in ranges:
        lo, hi = r[:2]
        v = (np.exp(rng.uniform(np.log(lo), np.log(hi), n)) if len(r) > 2
             else rng.uniform(lo, hi, n))
        out.append(v.astype(dtype))
    return out


# the special values of the line, planted at the head of each input
EDGES = (0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0)


def math_cases(n, seed=23):
    """Phase 23's cases: (label, function name, module, dtype, impl,
    inputs as numpy, float64 truth or None (mpmath's), gate for the truth,
    for poly the card's gate against the CPU and its reason)."""
    rng = np.random.default_rng(seed)
    cases = []
    with np.errstate(all="ignore"):  # the truths at the special values
        for table, mod in ((MATH_TABLE, "math"), (SPECIAL_TABLE, "special")):
            for name, (ranges, g32, g64, truth) in table.items():
                for dtype, gate in ((np.float32, g32), (np.float64, g64)):
                    args = draw(rng, ranges, n, dtype)
                    if len(args) == 1:
                        args[0][:len(EDGES)] = EDGES
                    dt = np.dtype(dtype).name
                    if mod == "math":
                        want = truth(*(a.astype(np.float64) for a in args))
                    elif dtype == np.float64 and name in MP_F64:
                        want = None  # mpmath's, on MP_POINTS points
                    else:
                        want = special_truth(truth, args)
                    impls = ("poly",) if name in ONE_IMPL else (
                        ("poly", "native") if mod == "math"
                        or name in SPECIAL_NATIVE else ("poly",))
                    why = POLY_NATIVE_INSIDE.get((name, dt), ("exact", ""))
                    for impl in impls:
                        g = (NATIVE_GATES.get((name, dt), gate)
                             if impl == "native" else gate)
                        cases.append((f"f{dt[5:]} {impl}", name, mod, dtype,
                                      impl, args, want, g,
                                      why if impl == "poly" else None))
    return cases


def wrapped_math_names():
    """The functions of ops/math.py that compute 16-bit inputs in float32
    and round back (the reference's _bf16_safe)."""
    from enoki_tpu_torch.ops import math as M
    return [k for k, v in vars(M).items()
            if callable(v) and getattr(v, "__wrapped__", None) is not None
            and not k.startswith("_")]


@contextlib.contextmanager
def one_cpu_thread(torch, on=True):
    """PyTorch's CPU transcendentals in the calling thread alone: its CPU
    build (MKL's vector math) may compute the first such call after its
    thread pool is built at a lower accuracy in one worker's chunk
    (float32-like in float64; docs/port.md), which would not be the CPU's
    answer to hold the card to."""
    n = torch.get_num_threads()
    if on:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def call_op(mod, name, args, impl):
    from enoki_tpu_torch.ops import math as M, special as S
    fn = getattr(M if mod == "math" else S, name)
    if name in ("hypot", "dawson") or name.startswith(("carlson", "comp_",
                                                        "ellint")):
        return fn(*args)
    return fn(*args, impl)


def math_case(torch, dev, case):
    """One case of phase 23 on ``dev``: (failures, summary, the card's
    error against the CPU or None)."""
    label, name, mod, dtype, impl, args, want, gate, why = case
    cpu = [torch.from_numpy(a) for a in args]
    got = call_op(mod, name, [a.to(dev) for a in cpu], impl)
    got = got[0] if isinstance(got, tuple) else got
    if got.dtype != cpu[0].dtype or got.device.type != dev.type:
        return [f"{name} {label}: {got.dtype} on {got.device}"], label, None
    failed, card, err = [], "", None
    g = got.cpu()
    if why is not None:  # poly: the card against the CPU, why[0] the gate
        with one_cpu_thread(torch, why[0] != "exact"):
            c = call_op(mod, name, cpu, impl)
        c = c[0] if isinstance(c, tuple) else c
        ok, err = ops_gate(torch, g, c, why[0])
        card = (", card = cpu" if err == 0 else
                f", card - cpu {err:.3g}{' ulp' if why[1] else ''}")
        if not ok:
            failed.append(f"{name} {label}: card against cpu {err:.3g}")
    # the truth past the planted special values (which the card's gate
    # holds to the CPU's); mpmath's on MP_POINTS of them
    sl = slice(len(EDGES) if len(args) == 1 else 0,
               len(EDGES) + MP_POINTS if want is None else None)
    gv, argk = g.numpy().astype(np.float64)[sl], [a[sl] for a in args]
    want = mp_truth(name)(argk[0]) if want is None else want[sl]
    ok, bound = gate(gv, want, dtype, argk)
    keep = np.isfinite(want) & (want != 0) & np.isfinite(gv)
    u = ulp_of(gv[keep], want[keep], dtype)
    if not ok:
        failed.append(f"{name} {label}: {bound} against float64 (max "
                      f"{u.max():.3g} ulp)")
    return failed, f"{label} {u.max():.3g}/{u.mean():.3g} ({bound}){card}", err


def run_math_extras(torch, dev):
    """Phase 23: every function of ops/math.py and ops/special.py on the
    card, with both impls, in float32 and float64 (bf16 for the wrapped
    ones), on seeded inputs of MATH_N elements: poly bit-equal to the same
    call on the CPU (or within 1 ulp where it calls PyTorch's own
    functions, POLY_NATIVE_INSIDE), both impls under the reference's
    bounds against a float64 truth computed on the host."""
    from enoki_tpu_torch import ops
    from enoki_tpu_torch.ops import backend as B, math as M, special as S

    t0 = time.perf_counter()
    failed, summary, card_errs = [], {}, {}
    for case in math_cases(MATH_N):
        name, label = case[1], case[0]
        fails, text, card_err = math_case(torch, dev, case)
        failed += fails
        summary.setdefault(name, []).append(text)
        if card_err is not None:
            card_errs[(name, label)] = card_err
    # 16-bit inputs: the float32 result rounded once, on the card
    wrapped = wrapped_math_names()
    for name in wrapped:
        ranges = MATH_TABLE.get(name, ([(-10, 10)],))[0]
        x = torch.from_numpy(draw(np.random.default_rng(16), ranges, MATH_N,
                                  np.float32)[0]).to(dev)
        xb = x.to(torch.bfloat16)
        for impl in ("poly", "native"):
            gb, gf = getattr(M, name)(xb, impl), getattr(M, name)(
                xb.float(), impl)
            for a, b in zip(gb if isinstance(gb, tuple) else (gb,),
                            gf if isinstance(gf, tuple) else (gf,)):
                b = b.to(torch.bfloat16)
                if not (a.dtype == torch.bfloat16 and bool(
                        ((a == b) | (a.isnan() & b.isnan())).all())):
                    failed.append(f"{name} bf16 {impl}: not the float32 "
                                  f"result rounded once")
    # the special values and the signed zeros
    f = functools.partial(torch.tensor, device=dev)
    inf = float("inf")
    f64 = torch.float64
    specials = [
        ("exp(1000)", M.exp(f(1000.0), "poly"), inf),
        ("exp(-1000)", M.exp(f(-1000.0), "poly"), 0.0),
        ("log(0)", M.log(f(0.0), "poly"), -inf),
        ("hypot(inf, inf)", M.hypot(f(inf), f(inf)), inf),
        ("atan2(-0, -0)", M.atan2(f(-0.0), f(-0.0), "poly"),
         float(np.float32(-np.pi))),
        ("dawson(inf)", S.dawson(f(inf)), 0.0),
        ("dawson(-inf)", S.dawson(f(-inf)), 0.0),
        ("erfi(inf) f64", S.erfi(f(inf, dtype=f64)), inf),
        ("erfi(-inf) f64", S.erfi(f(-inf, dtype=f64)), -inf),
        ("lgamma(inf)", S.lgamma(f(inf), "poly"), inf),
        ("lgamma(-inf)", S.lgamma(f(-inf), "poly"), inf),
        ("lgamma(-3) f64", S.lgamma(f(-3.0, dtype=f64), "poly"), inf),
        ("tgamma(+0)", S.tgamma(f(0.0), "poly"), inf),
        ("tgamma(-0)", S.tgamma(f(-0.0), "poly"), -inf),
        ("erfinv(-1)", S.erfinv(f(-1.0), "poly"), -inf),
        ("erfc(27.5) f64", S.erfc(f(27.5, dtype=f64), "poly"), 0.0),
        ("erf(-30) f64", S.erf(f(-30.0, dtype=f64), "poly"), -1.0),
    ]
    for what, got, want in specials:
        if not (got.device.type == dev.type and got.item() == want):
            failed.append(f"{what} = {got.item()} on {got.device}")
    for dtype in (torch.float32, f64):
        if not torch.signbit(S.erf(f(-0.0, dtype=dtype), "poly")):
            failed.append(f"erf(-0.0) {dtype} lost its sign")
    # math_ns on the card, bit for bit ops.math's
    x = torch.from_numpy(draw(np.random.default_rng(7), [(-3, 3)], MATH_N,
                              np.float32)[0]).to(dev)
    for impl in ("poly", "native"):
        ns = B.math_ns(x, impl)
        for name in ("sin", "exp", "log", "tanh", "asinh", "cbrt"):
            a, b = getattr(ns, name)(x), getattr(M, name)(x, impl)
            if not bool(((a == b) | (a.isnan() & b.isnan())).all()):
                failed.append(f"math_ns(x, {impl!r}).{name} differs")
    # the masked branches' gradients, finite
    for what, fn, v in (("i0e", lambda t: S.i0e(t, "poly"), 1e20),
                        ("erf", lambda t: S.erf(t, "poly"), 1e20),
                        ("dawson", S.dawson, 1e20),
                        ("dawson", S.dawson, 0.0)):
        t = f(v, requires_grad=True)
        fn(t).backward()
        if not (bool(torch.isfinite(t.grad).all())
                and (v != 0.0 or abs(t.grad.item() - 1.0) < 1e-5)):
            failed.append(f"gradient of {what} at {v}: {t.grad.item()}")
    # ops given Python values alone land on the card; a Python operand
    # takes the tensor's device
    outs = [ops.pow(x, 2.0), ops.atan2(x, 0.5)]
    if dev.type == "cuda":
        outs += [ops.sin(1.0, "poly"), ops.pow(2.0, 0.5),
                 ops.atan2(1.0, 2.0), ops.hypot(3.0, 4.0),
                 ops.erf(0.5, "poly"), ops.dawson(0.5),
                 ops.carlson_rf(1.0, 2.0, 3.0), ops.ellint_3(0.5, 0.5, 0.2)]
    if not all(o.device.type == dev.type for o in outs):
        failed.append("ops of Python values not on the card")
    for name, parts in summary.items():
        log(f"phase 23 {name}: max/mean ulp against float64 (gate): "
            + "; ".join(parts))
    named = sorted({f"{n} {lb.split()[0]} {e:.3g}"
                    for (n, lb), e in card_errs.items() if e != 0})
    log(f"phase 23 {sum(len(p) for p in summary.values())} cases of "
        f"ops/math.py and ops/special.py on 2^{MATH_N.bit_length() - 1} "
        f"elements; poly card against CPU: "
        f"{sum(e == 0 for e in card_errs.values())} of {len(card_errs)} "
        f"bit-equal, the others in ulp ({', '.join(named) or 'none'}: "
        f"PyTorch's own functions inside, gates POLY_NATIVE_INSIDE); "
        f"bf16 of {len(wrapped)} wrapped "
        f"functions the float32 result rounded once; {len(specials) + 2} "
        f"special values; math_ns; 4 gradients; ops of Python values on "
        f"the card: {time.perf_counter() - t0:.2f} s: "
        f"{'pass' if not failed else 'FAIL ' + '; '.join(failed)}")
    check(not failed, "phase 23: " + "; ".join(failed))


# -- phase 24: the rest of types/ ----------------------------------------------


def flat_result(torch, out):
    """A result of the types modules on the CPU as one tensor, and whether
    its last axis is a structure's: a Complex's or Quaternion's parts, or
    the members of a tuple of one shape (an SoA matrix's rows too), stacked
    last; a tuple of members of other shapes flattened and concatenated; a
    tensor as it is."""
    if hasattr(out, "re"):
        parts = torch.broadcast_tensors(out.re, out.im)
    elif hasattr(out, "w"):
        parts = torch.broadcast_tensors(out.x, out.y, out.z, out.w)
    elif isinstance(out, (tuple, list)):
        parts = out
    else:
        return out.detach().cpu(), False
    parts = [flat_result(torch, p)[0] for p in parts]
    if len({p.shape for p in parts}) == 1:
        return torch.stack(parts, -1), True
    return torch.cat([p.reshape(-1) for p in parts]), False


def types_gate(torch, got, want, kind, mag):
    """Phase 24's gate: ``ops_gate``'s kinds, and ``norm<N>``: |got - want|
    <= N * 2^-24 * S per output, S the norm of the result's structure
    (a complex number's modulus, a quaternion's norm; |want| for a plain
    tensor) and at least ``mag``: N units in the last place of the
    result's scale, for the cases with a native function inside. The
    worst error of a norm gate is in those units."""
    (g, structured), (w, _) = got, want
    if not kind.startswith("norm"):
        return ops_gate(torch, g, w, kind, mag)
    wd = torch.nan_to_num(w.double(), posinf=0.0, neginf=0.0)
    s = (wd.pow(2).sum(-1, keepdim=True).sqrt().expand_as(wd) if structured
         else wd.abs())
    s = torch.clamp_min(s, float(mag or 0.0))
    ok, _ = ops_gate(torch, g, w, "sum", int(kind[4:]) * 0.25 * s.numpy())
    d = (g.double() - w.double()).abs()
    units = torch.where(torch.isnan(d) | (d == 0), 0.0,
                        d / (2.0 ** -24 * s))
    return ok, float(units.max()) if units.numel() else 0.0


def _perm_abs(m):
    """The permanent of |m| over the last two axes: the sum of the
    magnitudes of a determinant's terms."""
    k = m.shape[-1]
    a = np.abs(m.astype(np.float64))
    return sum(np.prod([a[..., i, p[i]] for i in range(k)], axis=0)
               for p in itertools.permutations(range(k)))


def types_cases(torch, n, seed=24):
    """Phase 24's cases: (name, gate, function, inputs as numpy, mag,
    module of types/). Complex parts, scalars and codes have ``n`` elements, quaternions and
    matrices n / 4. Gates: ``exact`` where only IEEE arithmetic and
    correctly rounded roots are inside (the poly impl included);
    ``norm<N>`` where a native function is (mag the least scale); ``sum``
    (2^-22 * sum|terms|) for the products and sums of the dense
    matrices; ``ulp2`` for angles taken by one native function."""
    from enoki_tpu_torch.types import (Complex, DivisorI32, DivisorU32,
                                       Quaternion, color, complex_ as C,
                                       divisor,
                                       half, matrix as M, matrix_soa as S,
                                       morton_decode, morton_encode,
                                       quaternion as Q, sh, transform as T)
    from enoki_tpu_torch.types import enum_array as E

    rng = np.random.default_rng(seed)
    nq = n // 4
    cases = []

    def add(name, gate, fn, *args, mag=None):
        cases.append((name, gate, fn, args, mag, module))

    # -- half, idiv, morton, enum arrays, color
    module = "half"
    x = (rng.standard_normal(n)
         * np.exp2(rng.integers(-30, 18, n))).astype(np.float32)
    x[:6] = [0.0, -0.0, 65504.0, 65520.0, np.inf, np.nan]
    add("float_to_half", "exact", half.float_to_half, x)
    add("half_to_float", "exact",
        lambda v: half.half_to_float(half.float_to_half(v)), x)
    add("float_to_bf16", "exact", half.float_to_bf16, x)
    add("bf16_to_float", "exact",
        lambda v: half.bf16_to_float(half.float_to_bf16(v)), x)

    def half_bits(v):
        # a NaN's payload is the device's: the CPU keeps float32's quiet
        # NaN (0x7E00), the card gives 0x7FFF; bits of a float16 NaN
        # (exponent all ones, mantissa not 0) read as 0x7E00, any other
        # bits as they are
        b = half.half_bits(half.float_to_half(v)).view(torch.int16)
        nan16 = ((b & 0x7C00) == 0x7C00) & ((b & 0x03FF) != 0)
        return torch.where(nan16, 0x7E00, b)

    add("half_bits", "exact", half_bits, x)
    add("half_from_bits", "exact",
        lambda b: half.half_from_bits(b.view(torch.uint16)),
        rng.integers(-2**15, 2**15, n).astype(np.int16))
    module = "idiv"
    i32 = rng.integers(-2**31, 2**31, n).astype(np.int32)
    i32[:4] = [0, -1, -2**31, 2**31 - 1]
    u32 = i32.view(np.uint32)
    for d in (1, 2, 1 << 20, 3, 7, 0x7FFFFFFF, 0xFFFFFFFF):
        add(f"DivisorU32({d})", "exact", DivisorU32(d), u32)
        add(f"DivisorU32({d}).mod", "exact", DivisorU32(d).mod, u32)
    for d in (1, -1, 2, 3, -7, 1 << 20, 0x7FFFFFFF, -2**31):
        add(f"DivisorI32({d}), divisor", "exact", divisor(d, True), i32)
        add(f"DivisorI32({d}).mod", "exact", DivisorI32(d).mod, i32)
    module = "morton"
    for dim in (1, 2, 3):
        cs = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
              for _ in range(dim)]
        add(f"morton_encode {dim}-D", "exact",
            lambda *c: morton_encode(list(c)), *cs)
        add(f"morton_decode {dim}-D", "exact",
            lambda c, dim=dim: morton_decode(c, dim), cs[0])
    module = "enum_array"
    kinds = rng.integers(0, 3, n).astype(np.int32)
    add("enum_eq int32", "exact", lambda k: E.enum_eq(k, 2), kinds)
    add("enum_eq uint32", "exact", lambda k: E.enum_eq(k, 1 << 31),
        np.where(kinds > 0, np.uint32(1 << 31), np.uint32(1)))
    add("enum_array, enum_full", "exact", lambda k: torch.stack([
        E.enum_array([2, 0, 1], None, k.device).to(torch.int64),
        E.enum_full(1 << 31, 3, k.device).to(torch.int64)]), kinds)
    module = "color"
    lin = rng.uniform(-0.1, 1.2, n).astype(np.float32)
    lin[:4] = [0.0, 0.0031308, 0.04045, 1.0]
    for name in ("linear_to_srgb", "srgb_to_linear"):
        fn = getattr(color, name)
        add(f"{name} poly", "exact", lambda v, fn=fn: fn(v, "poly"), lin)
        add(f"{name} native", "norm16", fn, lin, mag=1.0)

    # -- complex
    module = "complex"
    re, im, re2, im2 = rng.uniform(-2, 2, (4, n)).astype(np.float32)

    def cx(f):
        return lambda a, b, c, d: f(Complex(a, b), Complex(c, d))

    for name, f in (("+", lambda a, b: a + b), ("-", lambda a, b: a - b),
                    ("*", lambda a, b: a * b), ("/", lambda a, b: a / b),
                    ("neg", lambda a, b: -a), ("== / !=", lambda a, b: (
                        (a == a) & (a != b)).to(torch.int8)),
                    ("* 2.5", lambda a, b: a * 2.5),
                    ("/ 3.0", lambda a, b: a / 3.0),
                    ("1.0 - z", lambda a, b: 1.0 - a),
                    ("2.0 / z", lambda a, b: 2.0 / a),
                    ("z * real", lambda a, b: a * b.re),
                    ("Complex.of", lambda a, b: Complex.of(a.re, 0.5)),
                    ("to_torch_complex, from_torch_complex",
                     lambda a, b: torch.view_as_real(
                        C.to_torch_complex(C.from_torch_complex(
                            C.to_torch_complex(a)))))):
        add(f"complex {name}", "exact", cx(f), re, im, re2, im2)
    for name in ("real", "imag", "conj", "squared_norm", "abs_", "rcp",
                 "sqrt"):
        add(f"complex.{name}", "exact", cx(lambda a, b, f=getattr(C, name):
                                           f(a)), re, im, re2, im2)
    add("complex.arg", "ulp2", cx(lambda a, b: C.arg(a)), re, im, re2, im2)
    poly_exact = ("exp", "sin", "cos", "sincos", "tan", "sinh", "cosh",
                  "tanh")
    # native: CUDA's and the CPU's functions differ by a few ulp; tan and
    # tanh divide four of them
    native = {"tan": "norm16", "tanh": "norm16"}
    for name in poly_exact + ("log", "asin", "acos", "atan"):
        f = getattr(C, name)
        for impl in ("poly", "native"):
            gate = ("exact" if impl == "poly" and name in poly_exact
                    else native.get(name, "norm8"))
            add(f"complex.{name} {impl}", gate,
                cx(lambda a, b, f=f, impl=impl: f(a, impl)), re, im, re2,
                im2, mag=np.pi / 2 if name == "acos" else None)
    for impl in ("poly", "native"):
        add(f"complex.pow w = 2 {impl}", "norm32", cx(
            lambda a, b, impl=impl: C.pow(a, Complex.of(a.re * 0 + 2), impl)),
            re, im, re2, im2)
        add(f"complex.pow {impl}", "norm32",
            cx(lambda a, b, impl=impl: C.pow(a, b * 0.5, impl)), re, im,
            re2, im2)

    # -- quaternion
    module = "quaternion"
    q = rng.standard_normal((8, nq)).astype(np.float32)
    qe = q[:4].copy()
    qe[:3] *= 0.5
    qe[3] = np.abs(qe[3]) + 1.0
    un = q.copy()
    un[:4] /= np.linalg.norm(q[:4].astype(np.float64), axis=0)
    un[4:] /= np.linalg.norm(q[4:].astype(np.float64), axis=0)
    ang = rng.uniform(-4, 4, nq).astype(np.float32)
    ax = un[:3] / np.linalg.norm(un[:3].astype(np.float64), axis=0)
    ax = ax.astype(np.float32)

    def qq(f):
        return lambda *c: f(Quaternion(*c[:4]), Quaternion(*c[4:]))

    for name, f in (("+", lambda a, b: a + b), ("-", lambda a, b: a - b),
                    ("neg", lambda a, b: -a), ("*", lambda a, b: a * b),
                    ("/", lambda a, b: a / b), ("* 1.5", lambda a, b: a * 1.5),
                    ("2.5 *", lambda a, b: 2.5 * a),
                    ("/ 3.0", lambda a, b: a / 3.0),
                    ("Quaternion.of", lambda a, b: Quaternion.of(
                        a.x, 0.5, a.z, 1)),
                    ("dot", lambda a, b: Q.dot(a, b)),
                    ("imag", lambda a, b: Q.imag(a)),
                    ("rotate_vector", lambda a, b: Q.rotate_vector(
                        a, b.x, b.y, b.z))):
        add(f"quaternion {name}", "exact", qq(f), *q)
    for name in ("real", "conj", "squared_norm", "abs_", "normalize", "rcp",
                 "to_matrix"):
        add(f"quaternion.{name}", "exact",
            qq(lambda a, b, f=getattr(Q, name): f(a)), *q)
    for impl in ("poly", "native"):
        add(f"quaternion.sqrt {impl}", "exact",
            qq(lambda a, b, impl=impl: Q.sqrt(a, impl)), *q)
        add(f"quaternion.exp {impl}", "exact" if impl == "poly" else "norm8",
            qq(lambda a, b, impl=impl: Q.exp(a, impl)), *qe, *q[4:])
        add(f"quaternion.log {impl}", "norm8",
            qq(lambda a, b, impl=impl: Q.log(a, impl)), *qe, *q[4:])
        add(f"quaternion.pow {impl}", "norm32",
            qq(lambda a, b, impl=impl: Q.pow(a, 0.7, impl)), *qe, *q[4:])
        # roll and yaw: atan2 (CUDA's atan2f is within 3 ulp); pitch the
        # float64 asin rounded once
        add(f"quaternion.euler_angles {impl}",
            "ulp2" if impl == "poly" else "ulp4",
            qq(lambda a, b, impl=impl: Q.euler_angles(a, impl)), *un)
        add(f"quaternion.slerp {impl}", "norm16",
            qq(lambda a, b, impl=impl: Q.slerp(a, b, 0.3, impl)), *un,
            mag=1.0)
        add(f"quaternion.from_axis_angle {impl}",
            "exact" if impl == "poly" else "norm4",
            lambda x0, x1, x2, g, impl=impl: Q.from_axis_angle(
                x0, x1, x2, g, impl), *ax, ang, mag=1.0)
    add("quaternion.from_matrix", "exact",
        qq(lambda a, b: Q.from_matrix(Q.to_matrix(a))), *un)
    add("quaternion.from_matrix SoA", "exact",
        qq(lambda a, b: Q.from_matrix(S.from_dense(Q.to_matrix(a)))), *un)
    ties = np.stack([np.eye(3), np.diag([1.0, -1, -1]),
                     np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1]),
                     np.diag([-1.0, -1, -1]), np.zeros((3, 3)),
                     np.diag([0.5, 0.5, -1.0]),
                     np.diag([-0.5, 0.25, 0.25])]).astype(np.float32)
    add("quaternion.from_matrix ties", "exact", Q.from_matrix, ties)

    # -- dense matrices
    module = "matrix"
    mats = []
    for k in (1, 2, 3, 4):
        a = (rng.standard_normal((nq, k, k)) + 3 * np.eye(k)).astype(
            np.float32)
        b = (rng.standard_normal((nq, k, k)) + 3 * np.eye(k)).astype(
            np.float32)
        v = rng.standard_normal((nq, k)).astype(np.float32)
        mats.append((k, a, b, v))
        ad, bd, vd = (np.abs(t.astype(np.float64)) for t in (a, b, v))
        for name in ("det", "inverse", "inverse_transpose", "transpose",
                     "diag"):
            add(f"matrix.{name} {k}", "exact", getattr(M, name), a)
        add(f"matrix.diag_matrix {k}", "exact", M.diag_matrix, v)
        add(f"matrix.from_rows, from_cols {k}", "exact", lambda m: (
            M.from_rows(*m.unbind(-2)), M.from_cols(*m.unbind(-1)),
            M.from_rows(list(m[..., 0, :].unbind(-1)), *m[..., 1:, :]
                        .unbind(-2))), a)
        add(f"matrix.matmul {k}", "sum", M.matmul, a, b, mag=ad @ bd)
        add(f"matrix.matvec {k}", "sum", M.matvec, a, v,
            mag=np.einsum("nij,nj->ni", ad, vd))
        add(f"matrix.trace {k}", "sum", M.trace, a,
            mag=np.trace(ad, axis1=-2, axis2=-1))
        add(f"matrix.frob {k}", "sum", M.frob, a, mag=(ad * ad).sum((-2, -1)))
    a5 = (rng.standard_normal((4096, 5, 5)) + 3 * np.eye(5)).astype(
        np.float32)
    inv5 = np.abs(np.linalg.inv(a5.astype(np.float64)))
    add("matrix.det 5 (torch.linalg)", "sum", M.det, a5,
        mag=5 * _perm_abs(a5))
    add("matrix.inverse 5 (torch.linalg)", "sum", M.inverse, a5,
        mag=5 * inv5 @ np.abs(a5.astype(np.float64)) @ inv5)
    # the SoA form: straight-line elementwise code
    module = "matrix_soa"
    for k, a, b, v in mats:
        for name in ("det", "inverse", "inverse_transpose", "transpose",
                     "trace", "frob"):
            add(f"matrix_soa.{name} {k}", "exact",
                lambda m, f=getattr(S, name): f(S.from_dense(m)), a)
        add(f"matrix_soa.matmul {k}", "exact", lambda m, mb: S.to_dense(
            S.matmul(S.from_dense(m), S.from_dense(mb))), a, b)
        add(f"matrix_soa.matvec {k}", "exact", lambda m, w: S.matvec(
            S.from_dense(m), tuple(w.unbind(-1))), a, v)
        add(f"matrix_soa.matrix, from_dense, to_dense {k}", "exact",
            lambda m: S.to_dense(S.matrix(S.from_dense(m))), a)
        add(f"matrix_soa.identity_like {k}", "exact", lambda m: S.to_dense(
            S.identity_like(m.shape[-1], m[..., 0, 0])), a)

    # -- SoA and dense transforms
    t3 = rng.standard_normal((3, nq)).astype(np.float32)
    p3 = rng.standard_normal((3, nq)).astype(np.float32)
    for name in ("translate", "scale"):
        f = getattr(S, name)
        add(f"matrix_soa.{name}", "exact", lambda tx, ty, tz, f=f:
            S.to_dense(f(tx, ty, tz)), *t3)
        add(f"matrix_soa.{name}, transform_point, transform_vector",
            "exact", lambda tx, ty, tz, px, py, pz, f=f: (
                S.transform_point(f(tx, ty, tz), px, py, pz)
                + S.transform_vector(f(tx, ty, tz), px, py, pz)), *t3, *p3)
    add("matrix_soa.rotate", "norm8", lambda x0, x1, x2, g: S.to_dense(
        S.rotate(x0, x1, x2, g)), *ax, ang, mag=1.0)
    module = "transform"
    add("transform.translate, scale", "exact", lambda v: (
        T.translate(v), T.scale(v)), t3.T.copy())
    for impl in ("poly", "native"):
        add(f"transform.rotate {impl}",
            "exact" if impl == "poly" else "norm8",
            lambda v, g, impl=impl: T.rotate(v, g, impl), ax.T.copy(), ang,
            mag=1.0)
    # c = 1 / tan(fov / 2): CUDA's tanf is within 4 ulp
    add("transform.perspective", "ulp8", lambda f: torch.stack([
        T.perspective(f[0], 0.1, 100.0), T.perspective(f[1], 0.5, 20.0,
                                                       1.3)]),
        np.float32([np.pi / 2, 1.1]))
    add("transform.frustum, ortho", "exact", lambda v: torch.stack([
        T.frustum(-1.0, 1.2, -0.7, 0.9, 0.1, 50.0, device=v.device),
        T.ortho(-1.0, 1.2, -0.7, 0.9, 0.1, 50.0, device=v.device)]),
        np.zeros(1, np.float32))
    o, tg, up = (rng.standard_normal((nq, 3)).astype(np.float32)
                 for _ in range(3))
    add("transform.look_at", "norm4", T.look_at, o, tg, up, mag=1.0)
    # rotations with a translation and an anisotropic scale
    m4 = np.zeros((nq, 4, 4), np.float32)
    c, s = np.cos(ang), np.sin(ang)
    xx, yy, zz = ax
    rot = np.stack([
        np.stack([c + xx * xx * (1 - c), xx * yy * (1 - c) - zz * s,
                  xx * zz * (1 - c) + yy * s], -1),
        np.stack([yy * xx * (1 - c) + zz * s, c + yy * yy * (1 - c),
                  yy * zz * (1 - c) - xx * s], -1),
        np.stack([zz * xx * (1 - c) - yy * s, zz * yy * (1 - c) + xx * s,
                  c + zz * zz * (1 - c)], -1)], -2)
    m4[:, :3, :3] = rot * rng.uniform(0.5, 2.0, (nq, 1, 3))
    m4[:, :3, 3] = t3.T
    m4[:, 3, 3] = 1.0
    a3 = np.abs(m4[:, :3, :3].astype(np.float64))
    pd = np.abs(p3.T.astype(np.float64))
    add("transform.polar_decompose Q", "exact",
        lambda m: T.polar_decompose(m[..., :3, :3])[0], m4)
    add("transform.transform_decompose R, t", "exact",
        lambda m: T.transform_decompose(m)[1:], m4)
    # P = Q^T A, Q orthogonal: sum_k |Q_ki| |A_kj| <= |A_:j| (Cauchy-Schwarz)
    pmag = np.linalg.norm(a3, axis=-2, keepdims=True).repeat(3, -2)
    add("transform.polar_decompose P", "sum",
        lambda m: T.polar_decompose(m[..., :3, :3])[1], m4, mag=pmag)
    add("transform.transform_decompose P", "sum",
        lambda m: T.transform_decompose(m)[0], m4, mag=pmag)
    # R S with both orthogonal, |entries| <= 1: sum|terms| <= 3; t copied
    m4r = np.zeros((nq, 4, 4), np.float32)
    m4r[:, :3, :3] = rot
    m4r[:, :3, 3] = t3.T
    m4r[:, 3, 3] = 1.0
    add("transform.transform_compose", "sum", lambda m: T.transform_compose(
        m[..., :3, :3], Q.from_matrix(m[..., :3, :3]), m[..., :3, 3]),
        m4r, mag=np.full((nq, 4, 4), 3.0))
    pm = np.einsum("nij,nj->ni", a3, pd)
    add("transform.transform_point", "sum", T.transform_point, m4,
        p3.T.copy(), mag=pm + np.abs(m4[:, :3, 3]))
    add("transform.transform_vector", "sum", T.transform_vector, m4,
        p3.T.copy(), mag=pm)
    itd = np.abs(np.linalg.inv(m4[:, :3, :3].astype(np.float64))
                 .transpose(0, 2, 1))
    add("transform.transform_normal", "sum", T.transform_normal, m4,
        p3.T.copy(), mag=np.einsum("nij,nj->ni", itd, pd))

    # -- spherical harmonics
    module = "sh"
    d = un[:3] / np.linalg.norm(un[:3].astype(np.float64), axis=0)
    d = np.concatenate([d.astype(np.float32)] * 4, -1)
    for order in (2, 9):
        add(f"sh_eval_stacked {order}", "exact",
            lambda x0, x1, x2, order=order: sh.sh_eval_stacked(
                x0, x1, x2, order), *d)
    add("sh_eval 4", "exact", lambda x0, x1, x2: sh.sh_eval(x0, x1, x2, 4),
        *d)
    return cases


def types_case(torch, dev, case):
    """One case of phase 24 on ``dev`` against the CPU: (passed, worst
    error). The CPU side of a case with a native function inside runs in
    one thread (``one_cpu_thread``)."""
    name, gate, fn, args, mag, _ = case
    cpu = [torch.from_numpy(x) for x in args]
    got = flat_result(torch, fn(*(x.to(dev) for x in cpu)))
    with one_cpu_thread(torch, gate != "exact"):
        want = flat_result(torch, fn(*cpu))
    return types_gate(torch, got, want, gate, mag)


def run_types_extras(torch, dev):
    """Phase 24: every public function of the eleven modules of types/
    that the port gained last, on the card against the same call on the
    CPU (gates: ``types_cases``)."""
    from enoki_tpu_torch.types import Quaternion, matrix as M
    from enoki_tpu_torch.types import enum_array as E

    t0 = time.perf_counter()
    cases = types_cases(torch, TYPES_N)
    worst, failed, by_module = {}, [], {}
    for case in cases:
        name, gate, module = case[0], case[1], case[-1]
        ok, err = types_case(torch, dev, case)
        worst[gate] = max(worst.get(gate, (0.0, "")), (err, name))
        by_module.setdefault(module, []).append(f"{name} {err:.3g}")
        if not ok:
            failed.append(f"{name} ({gate}, error {err:.3e})")
    for module, errs in by_module.items():
        log(f"phase 24 {module}, each case's worst error: "
            + "; ".join(errs))
    kinds = E.enum_array([2, 0, 1], None, dev)
    if E.to_enum_list(kinds, int) != [2, 0, 1]:
        failed.append("to_enum_list")
    on_card = True
    if dev.type == "cuda":
        on_card = all(t.device.type == "cuda" for t in (
            M.identity(3), Quaternion.identity().w, E.enum_full(1, 3)))
    log(f"phase 24 {len(cases)} cases of the eleven types/ modules on "
        f"2^{TYPES_N.bit_length() - 1} elements (quaternions, matrices "
        f"2^{TYPES_N.bit_length() - 3}), card against CPU, worst per gate: "
        + ", ".join(f"{g} {e:.3g}{f' ({n})' if e else ''}"
                    for g, (e, n) in sorted(worst.items()))
        + f" (ulp<N> in ulp, norm<N> in units of 2^-24 * the result's "
        f"norm, exact and sum max|d|); constructors on the card by "
        f"default: {on_card}; {time.perf_counter() - t0:.2f} s: "
        f"{'pass' if not failed and on_card else 'FAIL ' + '; '.join(failed)}")
    check(not failed, "phase 24: " + "; ".join(failed))
    check(on_card, "phase 24: the constructors are not on the card by "
          "default")


def same_tree(torch, got, want):
    """Whether two pytrees have equal leaves: same dtype and shape, the
    same bits (signed zeros included), a NaN where the other has a NaN."""
    from torch.utils import _pytree as pytree
    lg, sg = pytree.tree_flatten(got)
    lw, sw = pytree.tree_flatten(want)
    if sg != sw:
        return False
    for a, b in zip(lg, lw):
        if not isinstance(a, torch.Tensor):
            if a != b:
                return False
            continue
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.is_floating_point:
            nan = torch.isnan(a)
            if not torch.equal(nan, torch.isnan(b)):
                return False
            a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
            a, b = (v.view({2: torch.int16, 4: torch.int32,
                            8: torch.int64}[v.element_size()]) for v in (a, b))
        if not torch.equal(a, b):
            return False
    return True


def struct_callee(i):
    """Instance i of phase 25's dispatch: a struct result over a Ray and an
    int32 leaf (IEEE arithmetic and integer products only)."""
    from enoki_tpu_torch.render import Ray

    def f(mask, ray, k):
        c = float(i + 1)
        return {"ray": Ray(ray.o * c + ray.d, ray.d - ray.o * (0.5 * c)),
                "k": k * (i + 1) - i}
    return f


class StructInstance:
    """A registered instance of phase 25: a scale and a method."""

    def __init__(self, i):
        self.c = float(i + 1)
        self.eval = struct_callee(i)


STRUCT_CASES = {
    "width": lambda S, a, b, i, m, mf: S.width(a),
    "zeros_like": lambda S, a, b, i, m, mf: S.zeros_like(a),
    "full_like 2.5": lambda S, a, b, i, m, mf: S.full_like(a, 2.5),
    "full_like -3": lambda S, a, b, i, m, mf: S.full_like(a, -3),
    "select_struct": lambda S, a, b, i, m, mf: S.select_struct(mf, a, b),
    "gather_struct": lambda S, a, b, i, m, mf: S.gather_struct(a, i),
    "gather_struct masked": lambda S, a, b, i, m, mf: S.gather_struct(a, i,
                                                                       m),
    "scatter_struct": lambda S, a, b, i, m, mf: S.scatter_struct(
        S.zeros_like(a), S.gather_struct(b, i), i),
    "scatter_struct masked": lambda S, a, b, i, m, mf: S.scatter_struct(
        S.zeros_like(a), S.gather_struct(b, i), i, m),
    "slice_struct": lambda S, a, b, i, m, mf: S.slice_struct(a, 5),
    "slice_struct -1": lambda S, a, b, i, m, mf: S.slice_struct(a, -1),
    "set_slice_struct": lambda S, a, b, i, m, mf: S.set_slice_struct(
        a, 7, S.slice_struct(b, 3)),
    "concat_structs": lambda S, a, b, i, m, mf: S.concat_structs(a, b),
    "detach": lambda S, a, b, i, m, mf: S.detach(a),
    **{f"Masked.{op}": (lambda op: lambda S, a, b, i, m, mf: getattr(
        S.masked(a["ray"].o.x, mf), op)(b["ray"].d.y))(op)
       for op in ("assign", "add", "sub", "mul", "div", "min", "max")},
    # C11: a Python number, in float32 and in the 16-bit floats (the card
    # multiplies by the reciprocal of a Python divisor)
    **{f"Masked.{op} {v} {dt}": (lambda op, v, dt: lambda S, a, b, i, m, mf:
                                 getattr(S.masked(getattr(a["ray"].o.x, dt)(),
                                                  mf), op)(v))(op, v, dt)
       for op in ("add", "sub", "mul", "div") for v in (3.0, 0.1)
       for dt in ("float", "half", "bfloat16")},
}


def struct_inputs(torch, n, seed=25):
    """Phase 25 (a)'s inputs as numpy arrays: two structs' worth of
    floats (signed zeros, NaN and infinities at their heads), int32
    leaves, n/2 unique indices and a mask beside them, and instance ids
    with nulls (-1) and ids past the last instance."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(12, n)).astype(np.float32)
    f[:, :5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    f[1::2, :2] = [-0.0, 0.0]
    k = rng.integers(-1000, 1000, (2, n)).astype(np.int32)
    idx = rng.permutation(n).astype(np.int32)[:n // 2]
    mask = rng.random(n // 2) < 0.5
    ids = {m: rng.integers(-1, m + 2, n).astype(np.int32) for m in (3, 16)}
    return f, k, idx, mask, ids


def struct_of(torch, f, k, j, dev):
    """The struct {"ray": Ray(o, d), "k": int32} of draw j on ``dev``."""
    from enoki_tpu_torch.render import Ray, Vec3
    c = [torch.from_numpy(f[6 * j + r]).to(dev) for r in range(6)]
    return {"ray": Ray(Vec3(*c[:3]), Vec3(*c[3:])),
            "k": torch.from_numpy(k[j]).to(dev)}


def dispatch_ms(torch, dev, fn, reps=10):
    """Time of one call of ``fn`` back to back: CUDA events on the card
    (the host's launch gaps included, as a user meets them), the wall
    clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    ev = torch.cuda.Event
    s, e = ev(enable_timing=True), ev(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def run_struct_extras(torch, dev):
    """Phase 25: the struct, AD and runtime layers on the card (a)-(e)."""
    import importlib.util
    import pathlib
    import shutil
    import tempfile
    import warnings
    from torch.utils import _pytree as pytree
    from enoki_tpu_torch import ad, ops, runtime, struct as S
    from enoki_tpu_torch.render import (LAUNCHES, SDFScene, Vec3, generic,
                                        reset_launch_counts, sdf_kernels as K,
                                        sdflib)
    from enoki_tpu_torch.render.sdf import render_sdf_grads_implicit
    from enoki_tpu_torch.runtime import checkpoint as ck
    from enoki_tpu_torch.types import PCG32

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    failed = []
    n = STRUCT_N

    # -- (a) struct/ at STRUCT_N lanes, card against CPU -------------------
    f, k, idx, mask, ids = struct_inputs(torch, n)

    def on(d):
        return (struct_of(torch, f, k, 0, d), struct_of(torch, f, k, 1, d),
                torch.from_numpy(idx).to(d), torch.from_numpy(mask).to(d),
                torch.from_numpy(np.resize(mask, n)).to(d))

    args_c, args_d = on(cpu), on(dev)
    for name, fn in STRUCT_CASES.items():
        if not same_tree(torch, fn(S, *args_d), fn(S, *args_c)):
            failed.append(name)
    before = pytree.tree_map(torch.clone, args_d[0])
    S.set_slice_struct(args_d[0], 0, S.slice_struct(args_d[1], 0))
    if not same_tree(torch, args_d[0], before):
        failed.append("set_slice_struct changed its input")
    n_dispatch = 0
    for m in (3, 16):
        funcs = [struct_callee(i) for i in range(m)]
        reg_c, reg_d = S.InstanceRegistry(), S.InstanceRegistry()
        for i in range(m):
            reg_c.register(StructInstance(i))
            reg_d.register(StructInstance(i))
        ic, id_ = torch.from_numpy(ids[m]), torch.from_numpy(ids[m]).to(dev)
        a_c, b_c = args_c[0], args_c[1]
        a_d, b_d = args_d[0], args_d[1]
        calls = {
            "dispatch_masked": lambda I, a, b: S.dispatch_masked(
                funcs, I, a["ray"], a["k"]),
            "dispatch_partition": lambda I, a, b: S.dispatch_partition(
                funcs, I, a["ray"], a["k"]),
            "dispatch_masked default": lambda I, a, b: S.dispatch_masked(
                funcs, I, a["ray"], a["k"], default=b),
            "dispatch_partition default": lambda I, a, b: S.dispatch_partition(
                funcs, I, a["ray"], a["k"], default=b),
            "dispatch_switch": lambda I, a, b: S.dispatch_switch(
                funcs, I[5], a["ray"], a["k"]),
        }
        for name, call in calls.items():
            n_dispatch += 1
            if not same_tree(torch, call(id_, a_d, b_d), call(ic, a_c, b_c)):
                failed.append(f"{name} ({m} instances)")
        if not same_tree(torch, S.dispatch_masked(funcs, id_, a_d["ray"],
                                                  a_d["k"]),
                         S.dispatch_partition(funcs, id_, a_d["ray"],
                                              a_d["k"])):
            failed.append(f"masked != partition on the card ({m})")
        for name, got, want in (
                ("registry getter", reg_d.getter("c", id_),
                 reg_c.getter("c", ic)),
                ("registry stack", reg_d.stack("c", dev),
                 reg_c.stack("c", cpu)),
                ("registry dispatch auto",
                 reg_d.dispatch("eval", id_, a_d["ray"], a_d["k"]),
                 reg_c.dispatch("eval", ic, a_c["ray"], a_c["k"]))):
            n_dispatch += 1
            if not same_tree(torch, got, want):
                failed.append(f"{name} ({m} instances)")
    # the crossover: both strategies at 2..32 instances on the card
    times = {}
    rng = np.random.default_rng(26)
    for m in STRUCT_KS:
        funcs = [struct_callee(i) for i in range(m)]
        I = torch.from_numpy(rng.integers(0, m, n).astype(np.int32)).to(dev)
        a = args_d[0]
        times[m] = tuple(dispatch_ms(torch, dev, lambda fn=fn: fn(
            funcs, I, a["ray"], a["k"])) for fn in (S.dispatch_masked,
                                                    S.dispatch_partition))
    faster = [m for m in STRUCT_KS if times[m][1] < times[m][0]]
    log(f"phase 25 (a) struct/ at {n} lanes ({{ray: Ray(Vec3, Vec3), k: "
        f"int32}}), card against CPU, bit-equal with dtypes: "
        f"{len(STRUCT_CASES)} helper and Masked cases, {n_dispatch} "
        f"dispatcher and registry cases at 3 and 16 instances: "
        f"{'pass' if not failed else 'FAIL ' + '; '.join(failed)}")
    log("phase 25 (a) dispatch ms a call (CUDA events, back to back, host "
        "gaps included), masked / partition: " + ", ".join(
            f"k={m} {tm:.4f} / {tp:.4f}" for m, (tm, tp) in times.items())
        + f"; partition faster at k in {faster or 'none'} (auto takes it "
        f"from k >= {S.call._AUTO_PARTITION_MIN_K}, the reference's TPU "
        f"value)")
    check(not failed, "phase 25 (a): " + "; ".join(failed))

    # -- (b) ad.backward of the main path ----------------------------------
    p = torch.from_numpy(scene_vec(None)).to(dev)

    def loss_fn(q):
        return K.render_sdf_cuda(q, N, STEPS, EXTENT, min(128, N),
                                 coarse=0).mean()

    reset_launch_counts()
    val, (g_ad,) = ad.backward(loss_fn, p)
    launches = dict(LAUNCHES)
    model = K.SDFRender(p, n=N, n_steps=STEPS, extent=EXTENT)
    loss = model().mean()
    loss.backward()
    g_own = model.params.grad
    img_x, g_x = render_sdf_grads_implicit(K.vec_to_scene(p, SDFScene), N,
                                           STEPS)
    gx = K.scene_to_vec(g_x)[:9]
    lx = img_x.mean().item()
    tol = 1e-3 * max(1.0, gx.abs().max().item())
    ok_b = (torch.equal(g_ad, g_own) and val.item() == loss.item()
            and launches == {"sdf_fwd": 1, "sdf_bwd": 1}
            and bool(torch.allclose(g_ad[:9], gx, rtol=1e-2, atol=tol))
            and abs(val.item() - lx) <= 1e-5 + 1e-3 * abs(lx))
    log(f"phase 25 (b) ad.backward of render_sdf_cuda({N}^2, {STEPS} steps,"
        f" plain).mean(): loss {val.item():.7g}, gradient bit-equal to "
        f"SDFRender's own backward: {torch.equal(g_ad, g_own)}; launches "
        f"{launches}; against the twin: max|grad - twin| "
        f"{(g_ad[:9] - gx).abs().max().item():.3e} (rtol 1e-2, atol "
        f"{tol:.3e}), loss {lx:.7g}: {'pass' if ok_b else 'FAIL'}")
    check(ok_b, "phase 25 (b): ad.backward of the main path")
    rng = np.random.default_rng(27)
    bad = []
    for name in ("safe_sqrt", "safe_rsqrt", "safe_asin", "safe_acos"):
        lo, hi = (-1.5, 1.5) if name in ("safe_asin", "safe_acos") else \
            (-2.0, 50.0)
        x = rng.uniform(lo, hi, n).astype(np.float32)
        x[:9] = [0.0, -0.0, 1.0, -1.0, -3.0, 0.5, -0.5, 2.0, 1e-30]
        tx = rng.normal(size=n).astype(np.float32)
        fn = getattr(ops, name)
        res = {}
        for d in (cpu, dev):
            xd, td = torch.from_numpy(x).to(d), torch.from_numpy(tx).to(d)
            v, t = ad.forward(fn, (xd,), (td,))
            vm = torch.func.vmap(fn)(xd.reshape(-1, 64)).reshape(-1)
            g = torch.func.vmap(torch.func.grad(fn))(xd)
            res[d.type] = (v.cpu(), t.cpu(), vm.cpu(), g.cpu())
        (v0, t0, m0, g0), (v1, t1, m1, g1) = res["cpu"], res[dev.type]
        # asin / acos values: the float64 libm's last bit (phase 22)
        vgate = 1 if name in ("safe_asin", "safe_acos") else 0
        vd = max((ulp_of(a.numpy(), b.numpy().astype(np.float64),
                         np.float32)).max() for a, b in ((v1, v0), (m1, m0)))
        if vd > vgate or not (torch.equal(t1, t0) and torch.equal(g1, g0)
                              and torch.equal(m1, v1)):
            bad.append(f"{name} (values {vd} ulp)")
    a, b = np.meshgrid(np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0,
                                   -2.5, 3.0]), np.float32([0.0, np.inf,
                                                            np.nan, -2.0]))
    a, b = np.resize(a.ravel(), n), np.resize(b.ravel(), n)
    res = {}
    for d in (cpu, dev):
        ta, tb = torch.from_numpy(a).to(d), torch.from_numpy(b).to(d)
        v, t = ad.forward(ad.safe_mul, (ta, tb), (torch.ones_like(ta),
                                                 torch.ones_like(tb)))
        g = torch.func.vmap(torch.func.grad(ad.safe_mul, (0, 1)))(ta, tb)
        vm = torch.func.vmap(ad.safe_mul)(ta, tb)
        res[d.type] = (v, t, g, vm)
    if not same_tree(torch, res[dev.type], res["cpu"]):
        bad.append("safe_mul")
    zero_inf = res[dev.type][0][:2].tolist() == [0.0, 0.0]
    log(f"phase 25 (b) ad.forward, torch.func.vmap and vmap(grad) of "
        f"safe_sqrt / rsqrt / asin / acos at {n} lanes and of safe_mul "
        f"(0 * inf, 0 * NaN: {res[dev.type][0][8:10].tolist()}), card "
        f"against CPU: bit-equal (asin / acos values within 1 ulp): "
        f"{'pass' if not bad and zero_inf else 'FAIL ' + '; '.join(bad)}")
    check(not bad and zero_inf, "phase 25 (b): " + "; ".join(bad))

    # -- (c) checkpoint at full width --------------------------------------
    def train(model, opt, gen, steps):
        for _ in range(steps):
            opt.zero_grad()
            model().mean().backward()
            opt.step()
            _, gen = gen.next_uint32()
        return gen

    def fresh(seed):
        model = K.SDFRender(torch.from_numpy(scene_vec(seed)).to(dev), n=N,
                            n_steps=STEPS, extent=EXTENT)
        return model, torch.optim.Adam(model.parameters(), lr=1e-3)

    m_a, o_a = fresh(None)
    gen_a = train(m_a, o_a, PCG32.create(n, device=dev), 6)
    m_b, o_b = fresh(None)
    gen_b = train(m_b, o_b, PCG32.create(n, device=dev), 3)
    root = tempfile.mkdtemp(prefix="enoki_ckpt_")
    try:
        ck.save_step(root, 3, {"scene": K.vec_to_scene(
            m_b.params.detach(), SDFScene), "opt": o_b.state_dict(),
            "rng": gen_b, "step": 3})
        del m_b, o_b, gen_b
        m_c, o_c = fresh(1)
        m_c.params.grad = torch.zeros_like(m_c.params)
        o_c.step()  # a zero step: the optimiser's state takes its shape
        like = {"scene": K.vec_to_scene(m_c.params.detach(), SDFScene),
                "opt": o_c.state_dict(),
                "rng": PCG32.create(n, initstate=7, device=dev), "step": 0}
        restored, step = ck.restore_latest(root, like=like)
        size = sum(os.path.getsize(os.path.join(root, x))
                   for x in os.listdir(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with torch.no_grad():
        m_c.params.copy_(K.scene_to_vec(restored["scene"]))
    o_c.load_state_dict(restored["opt"])
    gen_c = train(m_c, o_c, restored["rng"], 3)
    st_a, st_c = o_a.state_dict()["state"][0], o_c.state_dict()["state"][0]
    ok_c = (step == 3 and restored["step"] == 3
            and torch.equal(m_a.params, m_c.params)
            and all(torch.equal(st_a[key], st_c[key])
                    for key in ("exp_avg", "exp_avg_sq", "step"))
            and torch.equal(gen_a.state.v, gen_c.state.v)
            and torch.equal(gen_a.inc.v, gen_c.inc.v))
    log(f"phase 25 (c) SDFRender {N}^2, {STEPS} steps, Adam: 3 steps, "
        f"save_step ({size} bytes with a PCG32 of {n} lanes), "
        f"restore_latest into fresh objects on the card, 3 steps, against "
        f"6 steps straight: parameters, Adam moments and the generator's "
        f"state bitwise equal: {'pass' if ok_c else 'FAIL'}")
    check(ok_c, "phase 25 (c): the resumed run differs from the straight one")

    # -- (d) runtime on the card --------------------------------------------
    stats = runtime.memory_stats(dev)
    known = torch.empty((1234, 567), dtype=torch.float32, device=dev)
    table = runtime.whos(print_out=False)
    row = [r for r in table.splitlines() if "(1234, 567)" in r]
    ok_whos = bool(row) and str(1234 * 567 * 4) in row[0] and \
        dev.type in row[0]
    del known
    ok_mem = (stats["bytes_in_use"] > 0 and (
        stats["bytes_limit"] == torch.cuda.get_device_properties(
            dev).total_memory if dev.type == "cuda"
        else stats["bytes_limit"] is None))

    def main_step(q):
        q = q.detach().requires_grad_(True)
        K.render_sdf_cuda(q, N, STEPS, EXTENT, min(128, N),
                          coarse=0).mean().backward()
        return q.grad

    rep = runtime.vectorization_report(main_step, p)
    plain = runtime.assert_vectorized(
        lambda x: torch.sin(x) * 2.0 + torch.sqrt(x * x + 1.0), p)
    try:
        runtime.assert_vectorized(lambda x: x * x[0].item(), p)
        raises = False
    except AssertionError:
        raises = True
    names_kernel = True
    if dev.type == "cuda":  # the CPU takes the plain versions: no kernel
        try:
            ad.whos(loss_fn, p)
            names_kernel = False
        except RuntimeError as e:
            names_kernel = "make_fx cannot trace sdf_fwd" in str(e)
    render_new, _ = generic.make_sdf_renderer(
        lambda q, pv: sdflib.sd_sphere(q, Vec3(pv[5], pv[6], pv[7]),
                                       pv[8]) - 0.0125, n_params=9)
    pv = torch.tensor([0.2, 90.0, -1.0, -1.0, 2.0, 0.05, -0.05, 0.0, 0.9],
                      device=dev)
    timings = runtime.compile_timings(lambda v: render_new(v, N).mean(), pv)
    hit_ok = dev.type != "cuda" or \
        timings["cache_hit_s"] < timings["compile_s"] / 10
    ok_d = (ok_mem and ok_whos and rep["custom_calls"] == 2 and raises
            and plain["host_transfers"] == 0 and names_kernel and hit_ok)
    log(f"phase 25 (d) memory_stats: {stats['bytes_in_use']} bytes in use, "
        f"peak {stats['peak_bytes_in_use']}, limit {stats['bytes_limit']}; "
        f"whos lists a (1234, 567) float32 tensor: {ok_whos}; "
        f"vectorization_report of a main-path fwd+bwd step: "
        f"{rep['custom_calls']} kernel launches (2 expected), "
        f"{rep['fusions'] if rep['fusions'] is not None else 'not measured (the profiler captured no device activity)'} device "
        f"kernels, {rep['host_transfers']} host "
        f"transfer(s){': ' + '; '.join(sorted(set(rep['syncs']))) if rep['syncs'] else ''}; "
        f"assert_vectorized passes on plain ops and raises on .item(): "
        f"{raises}; make_fx names the kernel it cannot trace: "
        f"{names_kernel}; compile_timings of a new generic scene: first "
        f"call {timings['compile_s']:.3f} s (trace + nvcc), second "
        f"{timings['cache_hit_s']:.4f} s, {timings['n_eqns']} aten ops and "
        f"launches: {'pass' if ok_d else 'FAIL'}")
    check(ok_d, "phase 25 (d): the runtime layer on the card")

    # -- (e) examples/calls_torch.py -----------------------------------------
    path = pathlib.Path(__file__).resolve().parent / "examples" / \
        "calls_torch.py"
    spec = importlib.util.spec_from_file_location("calls_torch", path)
    calls = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(calls)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_m, t_p = calls.main(CALLS_N, dev)
    log(f"phase 25 (e) examples/calls_torch.py at {CALLS_N}^2 lanes: masked"
        f" {t_m:.4f} ms, partition {t_p:.4f} ms a chained iteration, bit-"
        f"equal; phase 25 took {time.perf_counter() - t_phase:.2f} s")


# -- phase 26: dist/ ------------------------------------------------------------

# tests/test_dist.py:46-49 and :85-88
DIST_PERTURBED = dict(center=(0.1, -0.1, 0.0), radius=0.8, ambient=0.3,
                      gain=80.0)
DIST_FIT_INIT = dict(center=(0.0, 0.0, 0.0), radius=0.75, ambient=0.2,
                     gain=90.0)


def dist_scene(torch, dev, center, radius, ambient, gain,
               light=(-1.0, -1.0, 2.0)):
    from enoki_tpu_torch.render import SphereScene, Vec3

    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    return SphereScene(center=Vec3(*map(f, center)), radius=f(radius),
                       ambient=f(ambient), gain=f(gain),
                       light=Vec3(*map(f, light)))


def dist_leaves(scene):
    from enoki_tpu_torch.render.sphere import scene_leaves
    return np.array([float(x) for x in scene_leaves(scene)], np.float64)


def dist_probe(torch, dev, mesh, n):
    """Both train steps from the perturbed scene against the reference
    render: (init, target, {step: (loss with SGD(0), the leaves SGD(1)
    moves by exactly -grad)})."""
    from enoki_tpu_torch import dist as D
    from enoki_tpu_torch.render import SphereScene, render_fused

    target = render_fused(SphereScene.reference(dev), n).reshape(n, n)
    init = dist_scene(torch, dev, **DIST_PERTURBED)
    out = {}
    for name, maker in (("gspmd", D.make_train_step),
                        ("shardmap", D.make_train_step_shardmap)):
        _, _, loss = maker(n, mesh, lambda p: torch.optim.SGD(p, lr=0.0))(
            init, target, None)
        moved, _, _ = maker(n, mesh, lambda p: torch.optim.SGD(p, lr=1.0))(
            init, target, None)
        out[name] = (float(loss), dist_leaves(moved))
    return init, target, out


def dist_world(rank, world, n, device):
    """One rank of phase 26 (f)'s world: its coordinate, its tile of the
    sharded image and both steps' probes (dist_probe)."""
    import torch
    import torch.distributed as tdist
    from enoki_tpu_torch import dist as D
    from enoki_tpu_torch.render import SphereScene

    dev = torch.device(device)
    mesh = D.make_mesh(device=device)
    img = D.render_sharded(SphereScene.reference(dev), n, mesh)
    _, _, probe = dist_probe(torch, dev, mesh, n)
    return {"coordinate": tuple(mesh.get_coordinate()),
            "tile": img.to_local().cpu().numpy(), "probe": probe,
            "backend": tdist.get_backend()}


def grad_gate(got, want):
    """The reference's probe gate (tests/test_dist.py:74-75): rtol 1e-3,
    atol 1e-5 * the largest |gradient|."""
    return bool(np.allclose(got, want, rtol=1e-3,
                            atol=1e-5 * np.abs(want).max()))


def run_dist(torch, dev):
    """Phase 26: dist/ on the card at DIST_N^2, (a)-(f)."""
    import shutil
    import tempfile
    import warnings
    import torch.distributed as tdist
    from torch.profiler import ProfilerActivity, profile
    from enoki_tpu_torch import dist as D
    from enoki_tpu_torch.dist import bench_scaling as bs
    from enoki_tpu_torch.dist._world import run_world
    from enoki_tpu_torch.dist.render import (COLLECTIVES, _iota_tile,
                                             _sum_sq_over, mse_loss,
                                             reset_collectives)
    from enoki_tpu_torch.render import SphereScene, combined, render_fused
    from enoki_tpu_torch.render.sphere import scene_from_leaves, scene_leaves
    from enoki_tpu_torch.runtime import checkpoint as ck

    t_phase = time.perf_counter()
    n, kind = DIST_N, dev.type
    cpu = torch.device("cpu")
    sync = torch.cuda.synchronize if kind == "cuda" else (lambda: None)

    # -- (a) a world of one through nccl -------------------------------------
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        world = D.init_distributed(device=kind)
    try:
        backend = tdist.get_backend()
        mesh = D.make_mesh(device=kind)
        ref = SphereScene.reference(dev)
        img = D.render_sharded(ref, n, mesh).full_tensor()
        same = torch.equal(img, render_fused(ref, n).reshape(n, n))
        d = (img.cpu() - render_fused(SphereScene.reference(cpu), n)
             .reshape(n, n)).abs()
        ok_a = (world == 1 and same and d.max().item() < 5e-3
                and d.mean().item() < 1e-4)
        log(f"phase 26 (a) init_distributed(): a world of {world} through "
            f"{backend} ({'; '.join(str(w.message) for w in caught)}), "
            f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}; "
            f"render_sharded at {n}^2 bit-equal to render_fused on the card: "
            f"{same}; against the CPU max {d.max().item():.3e} (< 5e-3), "
            f"mean {d.mean().item():.3e} (< 1e-4): "
            f"{'pass' if ok_a else 'FAIL'}")
        check(ok_a, "phase 26 (a): the sharded render in a world of one")
        image_one = img.cpu().numpy()

        # -- (b) both train steps against one process's autograd ------------
        init, target, probe = dist_probe(torch, dev, mesh, n)

        def single(loss_fn):
            leaves = [x.detach().requires_grad_(True)
                      for x in scene_leaves(init)]
            with torch.enable_grad():
                loss = loss_fn(scene_from_leaves(leaves, SphereScene))
                grads = torch.autograd.grad(loss, leaves)
            # SGD(1)'s update, p - 1 * g, rounded once
            return float(loss.detach()), np.array([float(x.detach() - g)
                                          for x, g in zip(leaves, grads)])

        want = {"gspmd": single(lambda s: mse_loss(s, target, n)),
                "shardmap": single(lambda s: _sum_sq_over(
                    combined(_iota_tile(mesh, n, dev), s), target, n))}
        g0 = dist_leaves(init)
        parts = {"losses rtol 1e-4": np.isclose(
            probe["gspmd"][0], probe["shardmap"][0], rtol=1e-4)}
        for name in want:
            parts[f"{name} loss bit-equal"] = probe[name][0] == want[name][0]
            parts[f"{name} update bit-equal"] = np.array_equal(
                probe[name][1], want[name][1])
        ok_b = all(parts.values())
        # the two grids differ by up to an ulp: at this size their
        # gradients differ by more than the reference's 128^2 probe gate
        # allows (logged, not gated; the gate holds at 128^2 in the tests)
        g_gspmd, g_shard = g0 - probe["gspmd"][1], g0 - probe["shardmap"][1]
        rel = np.abs(g_shard - g_gspmd) / np.maximum(np.abs(g_gspmd), 1e-30)
        log(f"phase 26 (b) {parts}; shardmap - gspmd gradient "
            f"{np.array2string(g_shard - g_gspmd, precision=4, max_line_width=200)}"
            f" (largest relative {rel[np.abs(g_gspmd) > 0].max():.3e}; "
            f"within rtol 1e-3 / atol 1e-5 * max|g|: "
            f"{grad_gate(g_shard, g_gspmd)})")
        log(f"phase 26 (b) one step at {n}^2 from the perturbed scene: loss "
            f"gspmd {probe['gspmd'][0]:.7g}, shardmap "
            f"{probe['shardmap'][0]:.7g} (rtol 1e-4); each step's loss and "
            f"SGD(1) update bit-equal to one process's autograd of the same "
            f"loss on its grid (mse_loss on the linspace grid, the iota "
            f"tile); shardmap gradient "
            f"{np.array2string(g0 - probe['shardmap'][1], precision=5,
                               max_line_width=200)}: "
            f"{'pass' if ok_b else 'FAIL'}")
        check(ok_b, "phase 26 (b): the train steps in a world of one")

        # -- (c) fit_scene, resumed from its checkpoint ---------------------
        root = tempfile.mkdtemp(prefix="enoki_dist_")
        try:
            start = dist_scene(torch, dev, **DIST_FIT_INIT)
            straight, l_s = D.fit_scene(target, n, mesh, DIST_FIT_STEPS,
                                        5e-3, start)
            D.fit_scene(target, n, mesh, 4, 5e-3, start,
                        checkpoint_dir=root, checkpoint_every=2)
            at4 = ck.latest_step(root)
            resumed, l_r = D.fit_scene(target, n, mesh, DIST_FIT_STEPS, 5e-3,
                                       start, checkpoint_dir=root,
                                       checkpoint_every=2)
            at6 = ck.latest_step(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        ok_c = (at4 == 4 and at6 == DIST_FIT_STEPS
                and np.array_equal(dist_leaves(resumed),
                                   dist_leaves(straight))
                and float(l_r) == float(l_s) and np.isfinite(float(l_r)))
        log(f"phase 26 (c) fit_scene at {n}^2, Adam lr 5e-3, "
            f"{DIST_FIT_STEPS} steps from radius 0.75: loss {float(l_s):.7g}"
            f", radius {float(straight.radius):.7g}; checkpoints at "
            f"{at4} and {at6}, resumed at 4 bitwise equal to straight: "
            f"{'pass' if ok_c else 'FAIL'}")
        check(ok_c, "phase 26 (c): the resumed fit differs")

        # -- (e) timing of the shardmap step --------------------------------
        step = D.make_train_step_shardmap(
            n, mesh, lambda p: torch.optim.Adam(p, lr=1e-3))

        def steps(k):
            sc, st, loss = init, None, None
            for _ in range(k):
                sc, st, loss = step(sc, target, st)
            return loss

        steps(2)
        sync()
        walls = []
        for _ in range(DIST_WINDOWS):
            sync()
            t0 = time.perf_counter()
            steps(DIST_ITERS)
            sync()
            walls.append(1e3 * (time.perf_counter() - t0) / DIST_ITERS)
        wall_ms, spread = robust(walls)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if kind == "cuda" else [])
        reset_collectives()
        with profile(activities=acts) as prof:
            steps(DIST_ITERS)
            sync()
        record = list(COLLECTIVES)
        avg = prof.key_averages()
        cuda_t = torch.autograd.DeviceType.CUDA
        dev_ms = sum(e.self_device_time_total for e in avg
                     if e.device_type == cuda_t) / 1e3 / DIST_ITERS
        c10d = sum(e.count for e in avg if e.key.startswith(
            "c10d::allreduce"))
        comm_kernels = sorted({e.key[:40] for e in avg
                               if e.device_type == cuda_t
                               and "nccl" in e.key.lower()})
        card = nvidia_smi("name,power.limit") if kind == "cuda" else kind
        log(f"phase 26 (e) make_train_step_shardmap at {n}^2, Adam, one "
            f"card ({card}): {wall_ms:.4f} ms a "
            f"step wall (median of {DIST_WINDOWS} windows of {DIST_ITERS}, "
            f"spread {spread:.2%}; all {[round(w, 4) for w in walls]}), "
            f"device {dev_ms:.5f} ms a step (torch.profiler), busy share "
            f"{dev_ms / wall_ms:.4f}")

        # -- (d) the all-reduce record against the profiler ----------------
        stats = {k: bs.collective_stats(k, device=kind)
                 for k in (n // 2, n)}
        report = bs.schedule_overlap_report(n, device=kind)
        ok_d = (len(record) == DIST_ITERS and c10d == DIST_ITERS
                and all(c["bytes"] == 40 for c in record)
                and all(s.allreduce_bytes == 40 and len(s.allreduce_shapes)
                        == 1 for s in stats.values())
                and report.n_allreduce == 1 and report.trailing_total > 0)
        log(f"phase 26 (d) collectives: {len(record)} all-reduces recorded "
            f"over {DIST_ITERS} steps, {sorted({c['bytes'] for c in record})}"
            f" bytes each; the profiler's c10d::allreduce_ events {c10d}, "
            f"device kernels {comm_kernels}; collective_stats "
            + ", ".join(f"{k}^2 {s.allreduce_bytes} B {s.allreduce_shapes}"
                        for k, s in stats.items())
            + f"; schedule report {report}: "
            f"{'pass' if ok_d else 'FAIL'}")
        check(ok_d, "phase 26 (d): the collective record")

        payload = stats[n].allreduce_bytes
        effs = {(mode, m, k): bs.predicted_efficiency(
            m, k, payload, wall_ms * 1e-3, mode=mode)
            for mode, m in (("strong", 1024), ("strong", 4096),
                            ("weak", 1024)) for k in (2, 4, 8, 16, 64, 256)}
        rows = bs.measured_weak_scaling((1,), tile=n, iters=10, device=kind)
        log("phase 26 (e) predicted efficiency (this step time, a ring "
            "all-reduce of 40 B over NVLink / InfiniBand, zero overlap): "
            + "; ".join(f"{mode} {m}^2 " + ", ".join(
                f"{k}: {effs[(mode, m, k)]:.4f}" for k in (2, 4, 8, 16, 64,
                                                           256))
                for mode, m in (("strong", 1024), ("strong", 4096),
                                ("weak", 1024)))
            + f"; measured_weak_scaling((1,), tile={n}): "
            + ", ".join(f"devices={r[0]} n={r[1]} {r[2] / 1e6:.2f} "
                        f"Mpix/s/dev eff {r[3]:.3f}" for r in rows))
        check(len(rows) == 1 and rows[0][2] > 0,
              "phase 26 (e): measured_weak_scaling gave no row")
    finally:
        tdist.destroy_process_group()

    # -- (f) a 2x2 world of four processes on the one card -------------------
    t0 = time.perf_counter()
    ranks = run_world("chip_smoke:dist_world", DIST_WORLD, (n, kind),
                      device=kind, backend="gloo", deadline_s=600)
    tr = n // 2
    image = np.empty((n, n), np.float32)
    for r in ranks:
        i, j = r["coordinate"]
        image[i * tr:(i + 1) * tr, j * tr:(j + 1) * tr] = r["tile"]
    ok_f = np.array_equal(image, image_one)
    for name in ("gspmd", "shardmap"):
        losses = {r["probe"][name][0] for r in ranks}
        ok_f &= len(losses) == 1 and np.isclose(losses.pop(),
                                                probe[name][0], rtol=1e-4)
        ok_f &= all(grad_gate(g0 - r["probe"][name][1],
                              g0 - probe[name][1]) for r in ranks)
    log(f"phase 26 (f) a 2x2 world of {DIST_WORLD} processes on one card "
        f"through {ranks[0]['backend']} on {kind} tensors (NCCL refuses "
        f"two ranks on one device): coordinates "
        f"{[r['coordinate'] for r in ranks]}; the assembled image bit-equal "
        f"to the world of one's; losses gspmd "
        f"{ranks[0]['probe']['gspmd'][0]:.7g}, shardmap "
        f"{ranks[0]['probe']['shardmap'][0]:.7g} against the world of one "
        f"rtol 1e-4, gradients rtol 1e-3 / atol 1e-5 * max|g|; "
        f"{time.perf_counter() - t0:.2f} s: {'pass' if ok_f else 'FAIL'}; "
        f"phase 26 took {time.perf_counter() - t_phase:.2f} s")
    check(ok_f, "phase 26 (f): the 2x2 world against the world of one")


# -- phase 27: vmap of the kernel Functions ---------------------------------------


def vmap_cases(torch, dev, scenes):
    """Phase 27's cases: name -> (the call on one item, the batch of
    VMAP_BATCH items, the differentiated input's index)."""
    from enoki_tpu_torch import ops
    from enoki_tpu_torch.render import sdf_kernels as K, sphere_kernels as SK

    n = VMAP_N
    seeds = (None,) + tuple(range(1, VMAP_BATCH))
    p16 = torch.from_numpy(np.stack([scene_vec(s) for s in seeds])).to(dev)
    p12 = torch.from_numpy(np.stack([generic_vec(s) for s in seeds])).to(dev)
    rng = np.random.default_rng(27)
    idx = torch.from_numpy(rng.integers(
        -3, HIST_BINS + 4, (VMAP_BATCH, VMAP_HIST_N)).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.standard_normal(
        (VMAP_BATCH, VMAP_HIST_N)).astype(np.float32)).to(dev)
    composed = scenes["composed"][0]
    return {
        "render_sphere_cuda f32": (
            lambda p: SK.render_sphere_cuda(p, n, EXTENT, n), (p16,)),
        "render_sphere_cuda bf16": (
            lambda p: SK.render_sphere_cuda(p, n, EXTENT, n, torch.bfloat16),
            (p16,)),
        "render_sdf_cuda plain": (
            lambda p: K.render_sdf_cuda(p, n, STEPS, EXTENT, n, coarse=0),
            (p16,)),
        "render_sdf_cuda coarse=8": (
            lambda p: K.render_sdf_cuda(p, n, STEPS, EXTENT, n, coarse=8),
            (p16,)),
        "render_sdf_cuda split=16": (
            lambda p: K.render_sdf_cuda(p, n, STEPS, EXTENT, n, coarse=0,
                                        split=16), (p16,)),
        "generic composed": (
            lambda p: composed(p, n, STEPS, EXTENT, tile=n), (p12,)),
        "ops.histogram weighted": (
            lambda wi, i: ops.histogram(i, HIST_BINS, wi), (w, idx)),
    }


def run_vmap(torch, dev, scenes):
    """Phase 27: torch.func.vmap and vmap(grad) of every kernel Function
    on the card, against the stacked unbatched calls, launches counted."""
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.render import LAUNCHES, reset_launch_counts

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    failed, summary = [], []
    for name, (f, batch) in vmap_cases(torch, dev, scenes).items():
        def loss(*a):
            return f(*a).float().square().mean()

        item = tuple(b[0] for b in batch)
        reset_launch_counts()
        f(*item)
        one_fwd = dict(LAUNCHES)
        reset_launch_counts()
        torch.func.grad(loss)(*item)
        one_all = dict(LAUNCHES)
        items = list(zip(*batch))
        want = torch.stack([f(*a) for a in items])
        want_g = torch.stack([torch.func.grad(loss)(*a) for a in items])
        _build.VMAP_LOOPS.clear()
        reset_launch_counts()
        got = torch.func.vmap(f)(*batch)
        sync()
        fwd = dict(LAUNCHES)
        reset_launch_counts()
        got_g = torch.func.vmap(torch.func.grad(loss))(*batch)
        sync()
        both = dict(LAUNCHES)
        loops = dict(_build.VMAP_LOOPS)
        times = VMAP_BATCH
        ok = (torch.equal(got, want) and torch.equal(got_g, want_g)
              and fwd == {k: times * v for k, v in one_fwd.items()}
              and both == {k: times * v for k, v in one_all.items()}
              and min(loops.values()) >= 1)
        if dev.type == "cuda":
            ok &= bool(one_fwd)
        summary.append(f"{name}: launches one call {one_all}, vmap(grad) "
                       f"{both}, loops {loops}")
        if not ok:
            failed.append(name)
    log(f"phase 27 torch.func.vmap and vmap(grad) of the kernel Functions "
        f"on batches of {VMAP_BATCH} at {VMAP_N}^2 ({VMAP_HIST_N} indices "
        f"an item of the histogram), bit-equal to the stacked unbatched "
        f"calls, launches {VMAP_BATCH} x one call's: " + "; ".join(summary)
        + f"; {time.perf_counter() - t0:.2f} s: "
        f"{'pass' if not failed else 'FAIL ' + '; '.join(failed)}")
    check(not failed, "phase 27: " + "; ".join(failed))


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


def same_list(torch, K, got, want):
    """Whether two survivor lists of pass 1 (``sdf_fwd_split_list``'s
    pairs and counters, at [3] and [4]) hold the same pairs: the card's
    list sorted by pixel index against the plain, row-major one, the
    carries bit for bit."""
    idx, z = K.survivor_entries(got[3], got[4])
    w_idx, w_z = K.survivor_entries(want[3], want[4])
    order = torch.argsort(idx)
    return (idx.numel() == w_idx.numel() and torch.equal(idx[order], w_idx)
            and torch.equal(z[order], w_z))


def fresh_counters(torch, dev, calls, count=0):
    """A function that returns, at each call, an int32 pair (count, 0) not
    handed out before, ``calls`` of them: a timed pass 1 needs its list's
    count at 0, a timed tail its work counter, and each call moves them."""
    rows = torch.zeros((calls, 2), dtype=torch.int32, device=dev)
    rows[:, 0] = count
    it = iter(rows)

    def take():
        row = next(it, None)
        check(row is not None, "fresh_counters: more calls than counters")
        return row
    return take


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
            want = K.sdf_fwd_split_list_plain(p, n, 16, EXTENT, start)
            p1 = K.sdf_fwd_split_list(p, n, 16, EXTENT, start)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, one))
                  and all(torch.equal(a, b) for a, b in zip(p1[:3], want))
                  and same_list(torch, K, p1, want),
                  f"the split render at n={n} (start map: "
                  f"{start is not None}) differs")
        log(f"phase 9 n={n}: the four sdf_fwd instantiations "
            f"{'with and without the start map ' if n % 8 == 0 else ''}"
            f"bit-equal to plain, the split render to the one-pass render, "
            f"its pass 1 to plain and pass 1's list, sorted, to the plain "
            f"list: pass")

    # -- phase 10: the split render -----------------------------------------
    shares = {}
    for seed in SEEDS:
        p = cuda_vec(seed)
        t0 = K._cone_t0(p, N, STEPS, EXTENT, 8)
        for split, coarse in ((16, 0), (32, 0), (16, 8)):
            start = t0 if coarse else None
            one = K.sdf_fwd(p, N, STEPS, EXTENT, start)
            two = K.sdf_split(p, N, STEPS, EXTENT, split, start)
            again = K.sdf_split(p, N, STEPS, EXTENT, split, start)
            p1 = K.sdf_fwd_split_list(p, N, split, EXTENT, start)
            p1_plain = K.sdf_fwd_split_list_plain(p, N, split, EXTENT, start)
            tail = K.sdf_tail(p, p1[3], p1[4], p1[0].clone(), p1[1].clone(),
                              N, STEPS, split, EXTENT)
            idx = K.survivors(p1_plain[2])
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
            repeat = all(torch.equal(a, b) for a, b in zip(two, again))
            p1_ok = all(torch.equal(a, b) for a, b in zip(p1[:3],
                                                          p1_plain[:3]))
            list_ok = same_list(torch, K, p1, p1_plain)
            tail_ok = all(torch.equal(a, b) for a, b in zip(tail, tail_plain))
            log(f"phase 10 scene={seed} split={split} coarse={coarse}: "
                f"survivors {idx.numel()} ({share:.4%} of the pixels); img "
                f"and ts bit-equal to the one-pass kernel: "
                f"{'pass' if same else 'FAIL'}, two runs bitwise equal: "
                f"{'pass' if repeat else 'FAIL'}; pass 1 (img, ts, cont) "
                f"bit-equal to plain: {'pass' if p1_ok else 'FAIL'}, its "
                f"list sorted equal to the plain list: "
                f"{'pass' if list_ok else 'FAIL'}; tail bit-equal to plain: "
                f"{'pass' if tail_ok else 'FAIL'}")
            check(same and repeat and list_ok,
                  f"split render differs from one pass, from itself or from "
                  f"the plain list (scene {seed}, split {split}, coarse "
                  f"{coarse})")
            if not p1_ok:
                flip_gate((p1[0] - p1_plain[0]).abs(), "phase 10 pass 1")
            if not tail_ok:
                flip_gate((tail[0] - tail_plain[0]).abs(), "phase 10 tail")
    # no survivor: the tail launches, reads a count of 0 on the card and
    # leaves pass 1's image
    p = cuda_vec(None)
    p[0] += 50.0
    img, ts, _, pairs, counters = K.sdf_fwd_split_list(p, N, 16, EXTENT)
    img1, ts1 = img.clone(), ts.clone()
    K.sdf_tail(p, pairs, counters, img, ts, N, STEPS, 16, EXTENT)
    torch.cuda.synchronize()
    check(counters[0].item() == 0 and torch.equal(img, img1)
          and torch.equal(ts, ts1) and bool((ts < 0).all().item()),
          "the tail over an empty list changed pass 1's image")
    log("phase 10 no survivor (the sphere off screen): count 0 on the card, "
        "the tail launched and left pass 1's img and ts: pass")

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

    p1 = K.sdf_fwd_split_list(p_ref, N, 16, EXTENT)
    k = int(p1[4][0].item())
    p1_img, p1_ts = p1[0].clone(), p1[1].clone()  # the timed tails write p1
    idx = K.survivors(p1[2])
    # a survivor's advances in the tail: the one-pass march's less pass
    # 1's (the split render is the one-pass render bit for bit)
    adv_tail = (K.march_counts(p_ref, N, STEPS, EXTENT)[1]
                - K.march_counts(p_ref, N, 16, EXTENT)[1]).view(-1)
    tail_adv = adv_tail[idx]
    tail_adv_n = int(tail_adv.sum().item())
    # a survivor's evaluations: one per advance (the replayed one's
    # included) and one more, whose distance the hit test takes
    tail_evals = tail_adv_n + k
    tail_hits = int((ts_ref.view(-1)[idx] >= 0).sum().item())
    # each timed call (201 a timing: one, then 200 back to back) with
    # counters of its own
    fwd_counters = fresh_counters(torch, dev, 1000)
    tail_counters = fresh_counters(torch, dev, 2000, k)

    def split_call():
        return K.sdf_fwd_split_list(p_ref, N, 16, EXTENT,
                                    counters=fwd_counters())

    def tail_call():
        return K.sdf_tail(p_ref, p1[3], tail_counters(), p1[0], p1[1], N,
                          STEPS, 16, EXTENT)

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
        # writes img, ts and cont per pixel, a pair per survivor
        "sdf_fwd_split": (
            split_call,
            lambda: K.sdf_fwd_split_list_plain(p_ref, N, 16, EXTENT),
            bound(12 * rays + 8 * k + 64,
                  shade_flops(CONT_FLOPS_PER_PIXEL) + z_march_flops(16))),
        # reads a pair (8 B), writes img and ts, per survivor; the two
        # counters
        "sdf_tail": (
            tail_call,
            lambda: K.sdf_tail_plain(p_ref, idx, p1[2], p1[0], p1[1], N,
                                     STEPS, 16, EXTENT),
            bound(16 * k + 8 + 64, FWD_FLOPS_PER_EVAL * tail_evals
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
                                 K.float4_rows(N, g_mean, ts_ref))
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
        + ("float4" if K.float4_rows(N, g_mean, ts_ref) else
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

    # sdf_tail's floors (derived, not measured). An iteration of its march
    # loop (march_z's, the innermost loop of the persistent kernel) is one
    # evaluation of a lane: one per advance after the replayed one, and
    # the one whose distance the hit test takes; the replayed advance's
    # evaluation, before the loop, is counted with them. The least any
    # schedule issues packs the lanes' evaluations 32 to a warp trip; a
    # warp that takes 32 consecutive survivors waits for the longest of
    # them: in the card's list (the order of pass 1's blocks, 8x4-pixel
    # warps) and, for the record, in the row-major list the thread-per-
    # survivor kernel took
    first, last, laid_out, loop_ins = loop_counts(sass, "sdf_tail_kernel",
                                                  innermost=True)
    card_idx = K.survivor_entries(p1[3], p1[4])[0].long()

    def warp_trips(evals):
        pad = evals.new_zeros(-(-evals.numel() // 32) * 32)
        pad[:evals.numel()] = evals
        return int(pad.view(-1, 32).amax(dim=1).sum().item())

    packed = -(-tail_evals // 32)
    trips = {"packed": packed, "the card's list, 32 consecutive":
             warp_trips(adv_tail[card_idx] + 1),
             "the row-major list, 32 consecutive": warp_trips(tail_adv + 1)}
    floor_ms = 1e3 * loop_ins * packed / rate
    check(loop_ins >= FWD_FLOPS_PER_EVAL, f"sdf_tail: the loop found in its "
          f"SASS issues {loop_ins} instructions, fewer than a step's "
          f"{FWD_FLOPS_PER_EVAL} operations")
    check(floor_ms <= ms["sdf_tail"], f"sdf_tail's issue floor "
          f"{floor_ms:.5f} ms is above its time {ms['sdf_tail']:.5f} ms")
    log(f"phase 12 sdf_tail issue floors (derived, not measured): an "
        f"iteration of its march loop issues {loop_ins} SASS instructions "
        f"(the loop {first:#x}-{last:#x} lays out {laid_out}; cuobjdump); "
        f"{k} survivors, {tail_evals} lane iterations; "
        + "; ".join(f"{what}: {t} warp iterations (busy lanes "
                    f"{tail_evals / (32 * t):.4f}) = "
                    f"{1e3 * loop_ins * t / rate:.5f} ms"
                    for what, t in trips.items())
        + f"; over {rate_text}; the first, the least any schedule issues, "
        f"{floor_ms / ms['sdf_tail']:.4f} of the measured "
        f"{ms['sdf_tail']:.5f} ms (bound {work['sdf_tail'][2][0]:.5f} ms "
        f"by {work['sdf_tail'][2][1]}); ptxas: "
        + resources_text(lib_path, ("sdf_tail_kernel",)))
    dense_line, dense_row = dense_floor(torch, K, p_ref, timer)
    log(dense_line)

    # the shipped tail and the three refill schedules, each held bit-equal
    # to the plain tail, timed in turns, then in the other order
    from unittest import mock
    want = K.sdf_tail_plain(p_ref, idx, p1[2], p1_img.clone(),
                            p1_ts.clone(), N, STEPS, 16, EXTENT)
    sched_libs = {"shipped": _build.load("sdf_render")}
    sched_libs.update({
        below: _build.load_generated("sdf_render", text)
        for below, text in tail_schedule_sources().items()})
    sched_ms = {}
    for order in (1, -1):
        for below, lib in list(sched_libs.items())[::order]:
            with mock.patch.object(_build, "load", lambda _, lib=lib: lib):
                got = K.sdf_tail(p_ref, p1[3], tail_counters(),
                                 p1_img.clone(), p1_ts.clone(), N, STEPS, 16,
                                 EXTENT)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"sdf_tail ({below}) differs from plain")
                sched_ms.setdefault(below, []).append(timer(tail_call, 200))
    log("phase 12 sdf_tail, shipped (a lane a list slot, then the slot a "
        "grid's lanes further on) and refilled from the work counter, "
        "2 steps a vote, each bit-equal to plain, ms (two passes): "
        + "; ".join(f"{TAIL_SCHEDULES.get(b, b)} "
                    f"{' / '.join(f'{t:.5f}' for t in v)}"
                    for b, v in sched_ms.items()))

    # the split forward as a step takes it: the counters' memset, pass 1
    # and the tail, with no host sync; against the one-pass forward
    split_fwd_ms = timer(lambda: K.sdf_split(p_ref, N, STEPS, EXTENT, 16),
                         200)
    log(f"phase 12 split forward (split 16: the counters' memset, "
        f"sdf_fwd_split, sdf_tail) {split_fwd_ms:.5f} ms of device time "
        f"against the one-pass sdf_fwd's {fwd0_ms:.5f} ms")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        K.sdf_split(p_ref, N, STEPS, EXTENT, 16)
        with torch.no_grad():
            K.render_sdf_cuda(p_ref, N, STEPS, EXTENT, 128, coarse=0,
                              split=16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    import warnings
    torch.cuda.synchronize()
    pg = p_ref.clone().requires_grad_(True)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            K.render_sdf_cuda(pg, N, STEPS, EXTENT, 128, coarse=0,
                              split=16).mean().backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    log(f"phase 12 the split forward under "
        f"torch.cuda.set_sync_debug_mode('error') (sdf_split, and "
        f"render_sdf_cuda(split=16) without grad): no host sync: pass; a "
        f"whole split fwd+bwd step warns of {len(syncs)} host sync(s)")

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
                 library_ms=None) for name in work] + [dense_row]

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
    PHASE20_APP.update(wall_ms=wall_ms, n=n)
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



# ---------------------------------------------------------------------------
# Phase 28: the lazy trace (enoki_tpu_torch.trace), one generated kernel a
# fused run
# ---------------------------------------------------------------------------

TRACE_N = 1 << 24              # phase 28's lanes (the mini-app's 16M)
TRACE_CHAIN_OPS = 10_444       # tools/jit_overhead.py's chain
# max_fused_ops of the chain's segmented build: codegen caps a kernel at
# MAX_KERNEL_ENTRIES (1024) entries, so 2048 would give the whole build
TRACE_CHAIN_SEG = 512
TRACE_CHAIN_SMALL = 1 << 16
TRACE_PRINT_N = 1 << 16
TRACE_HIST_BINS = 64
# the CPU fuzz recipes (tests/test_torch_trace_fuzz.py): (name, arity,
# IEEE only?, op over a trace module)
TRACE_OPS = [
    ("add", 2, True, lambda t, a, b: a + b),
    ("sub", 2, True, lambda t, a, b: a - b),
    ("mul", 2, True, lambda t, a, b: a * b),
    ("min", 2, True, lambda t, a, b: t.minimum(a, b)),
    ("max", 2, True, lambda t, a, b: t.maximum(a, b)),
    ("fma", 3, True, lambda t, a, b, c: t.fmadd(a, b, c)),
    ("neg", 1, True, lambda t, a: -a),
    ("abs", 1, True, lambda t, a: abs(a)),
    ("sqrt|x|", 1, True, lambda t, a: t.sqrt(abs(a) + 0.25)),
    ("tanh", 1, False, lambda t, a: t.tanh(a)),
    ("sin", 1, False, lambda t, a: t.sin(a)),
    ("exp/8", 1, False, lambda t, a: t.exp(a * 0.125)),
    ("sel", 2, True, lambda t, a, b: t.select(a > b, a, b * 0.5)),
    ("scal", 1, True, lambda t, a: a * 1.5 + 0.25),
]
# (seed, dtype, IEEE only) of phase 28 (a)'s programs
TRACE_PROGRAMS = [(0, "float32", False), (1, "float32", False),
                  (2, "float32", False), (3, "float32", True),
                  (4, "float32", True), (301, "float64", False),
                  (302, "float64", False), (303, "float64", True)]


def trace_program(tr, seed, dtype, ieee, n, device, data=True):
    """A fuzz program of the CPU tests' recipe over ``tr`` at ``n`` lanes
    on ``device`` (``data``: seeded numpy leaves, else uninitialised ones:
    the same structure). Returns (result, the leaves as numpy or None)."""
    import torch
    rng = np.random.default_rng(seed)
    ops = [o for o in TRACE_OPS if o[2] or not ieee]
    n_leaves = int(rng.integers(2, 5))
    depth = int(rng.integers(5, 40))
    recipe, pool_size = [], n_leaves
    for _ in range(depth):
        k = int(rng.integers(len(ops)))
        recipe.append((k, [int(rng.integers(pool_size))
                           for _ in range(ops[k][1])]))
        pool_size += 1
    if data:
        leaves = [rng.uniform(-2, 2, n).astype(dtype)
                  for _ in range(n_leaves)]
        pool = [tr.LazyArray(l, device=device) for l in leaves]
    else:
        leaves = None
        pool = [tr.LazyArray(torch.empty(n, dtype=getattr(torch, dtype),
                                         device=device))
                for _ in range(n_leaves)]
    for k, slots in recipe:
        pool.append(ops[k][3](tr, *[pool[s] for s in slots]))
    return pool[-1], leaves


def trace_chain(tr, data):
    """tools/jit_overhead.py's build_chain: a TRACE_CHAIN_OPS-long fused
    chain, four appends an iteration (mul, the literal, add, sqrt)."""
    y = tr.LazyArray(data)
    for i in range(TRACE_CHAIN_OPS // 4):
        y = tr.sqrt(y * y + (1.0 + 1e-6 * (i % 7)))
    return y


def trace_hist(tr, values, bins=TRACE_HIST_BINS):
    """values -> cast(int32) -> scatter_add into ``bins`` bins, one eval."""
    h = tr.LazyArray.zeros(bins, "int32", device=values.device)
    h.scatter_add(values.cast("int32"), 1)
    return h


# SCATTER_ADD's routes (trace/codegen.py): the target's codes, and sizes at
# each side of each route's threshold (codegen.ROW_SLOTS, BLOCK_BYTES). A
# bool target has no SCATTER_ADD: its cases hold the refusal (TypeError,
# as JAX's x.at[i].add of a bool array)
SCATTER_CODES = ("int32", "uint32", "int64", "uint64", "float32", "float64",
                 "bfloat16", "float16", "bool")
# the largest magnitude up to which every quarter is exact in a 16-bit
# float (2^(p - 2) for p significand bits): the bound of scatter_case's
# exact sums there
SCATTER_EXACT_SUM = {"bfloat16": 64.0, "float16": 512.0}
SCATTER_SIZES = (1, 8, 9, 32, 64, 96, 97, 4096, 8192, 8193, 65536)
SCATTER_N = 1 << 16            # lanes of phase 28 (b)'s route cases
# several targets in one run: the routes in the order of the targets, the
# shared memory given out over all of them
SCATTER_SEVERAL = {
    "rows-rows-block": ([("float32", 8), ("float32", 32), ("float64", 200)],
                        [1, 1, 2]),
    "rows-full": ([("float32", 96), ("float32", 96)], [1, 3]),
    "rows-then-block": ([("float32", 64), ("float32", 64)], [1, 2]),
    "block-full": ([("int64", 4096), ("float64", 4096), ("float32", 8192),
                    ("int32", 8192)], [2, 2, 2, 3]),
}
# phase 28 (b)'s timed float weights at TRACE_N lanes: the slots of a
# target of each route, the indices normal around the middle slot (the
# histogram's shape)
SCATTER_TIMED = (64, 4096, 65536)
# the timed weights' gate, in units of float32's roundoff (2^-24) of the
# sum of the magnitudes of a slot's terms, against the slot's float64 sum
# (weights_gate)
WEIGHTS_UNITS = 16


def scatter_route(dtype, size):
    """The route a lone SCATTER_ADD target of ``dtype`` and ``size`` slots
    takes under codegen's thresholds: 1 (a row a thread), 2 (a copy a
    block) or 3 (global atomics)."""
    import torch
    from enoki_tpu_torch.trace import _code_of, codegen
    code = _code_of(dtype)
    if size <= codegen.ROW_SLOTS.get(code, 0):
        return 1
    width = getattr(torch, dtype).itemsize
    return 2 if width in (4, 8) and size * width <= codegen.BLOCK_BYTES \
        else 3


def scatter_case(dtype, size, lanes, seed, exact=False):
    """(base, index, value) of a SCATTER_ADD of ``lanes`` lanes into
    ``size`` slots: about half the indices negative (counting from the
    end), a tenth out of range either way (dropped); values and base
    random, ints wide enough to wrap; where the target has 8 slots or
    more, its last two slots are hit by nothing and the two before by 0
    alone (-0.0 for floats), and those four slots' bases are -0.0, +0.0,
    -0.0, +0.0 in a float target. Floats are normal(0, 4), or with
    ``exact`` quarters from -8 to 8, whose sums of up to 2^21 terms are
    exact in float32 in any order: every route then gives the same bits;
    in a 16-bit float the lanes after those that bring a slot's sum of
    magnitudes, its base's included, to ``SCATTER_EXACT_SUM`` add +0.0,
    and with ``exact`` a uint64 value is a small integer. numpy arrays,
    but a bfloat16 base and value (numpy has no bfloat16) are CPU tensors
    (``scatter_tensors`` puts all three on a device)."""
    rng = np.random.default_rng(seed)
    dt = np.dtype("float32" if dtype == "bfloat16" else dtype)

    def draw(k):
        if dt.kind == "f" and exact:
            return (rng.integers(-32, 32, k, endpoint=True) / 4).astype(dt)
        if dt.kind == "f":
            return rng.normal(0.0, 4.0, k).astype(dt)
        if dt.kind == "b":
            return rng.random(k) < 0.5
        if dt == np.uint64 and exact:
            return rng.integers(0, 1000, k, endpoint=True).astype(dt)
        info = np.iinfo(dt)
        lo, hi = max(info.min, -2 ** 62), min(info.max, 2 ** 62)
        return rng.integers(lo, hi, k, dtype=dt, endpoint=True)

    base = draw(size)
    hit = size - 4 if size >= 8 else size
    idx = rng.integers(0, hit, lanes).astype(np.int64)
    idx = np.where(rng.random(lanes) < 0.5, idx - size, idx)
    out = rng.random(lanes) < 0.1
    idx = np.where(out, np.where(rng.random(lanes) < 0.5,
                                 size + rng.integers(0, 9, lanes),
                                 -size - 1 - rng.integers(0, 9, lanes)), idx)
    val = draw(lanes)
    if size >= 8:
        zero = np.array([-0.0 if dt.kind == "f" else 0]).astype(dt)
        extra = rng.integers(size - 4, size - 2, max(lanes // 50, 2))
        idx = np.concatenate([idx, extra])
        val = np.concatenate([val, np.repeat(zero, extra.size)])
        if dt.kind == "f":
            base[size - 4:] = np.array([-0.0, 0.0, -0.0, 0.0], dt)
        order = rng.permutation(idx.size)
        idx, val = idx[order], val[order]
    if exact and dtype in SCATTER_EXACT_SUM:
        val = _exact_sums(base, idx, val, SCATTER_EXACT_SUM[dtype])
    if dtype == "bfloat16":
        import torch
        base, val = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in (base, val))
    return base, idx.astype(np.int32), val


def _exact_sums(base, idx, val, bound):
    """``val`` with +0.0 in each lane that would bring the sum of the
    magnitudes of its slot's terms (base first, then the lanes in order)
    above ``bound``: every partial sum of quarters is then exact."""
    n = base.size
    slot = np.where(idx < 0, idx + n, idx)
    kept = (slot >= 0) & (slot < n)
    order = np.argsort(np.where(kept, slot, n), kind="stable")
    s, v = np.where(kept, slot, n)[order], np.abs(val[order]).astype(
        np.float64)
    run = np.cumsum(v)
    first = np.searchsorted(s, s, side="left")
    before = np.concatenate([[0.0], run])[first]
    within = run - before + np.abs(np.append(base, 0.0)[s]) <= bound
    out = val.copy()
    out[order[~within & (s < n)]] = 0.0
    return out


def scatter_tensors(torch, arrays, device):
    """A case's arrays (numpy, or scatter_case's bfloat16 tensors) as
    tensors on ``device``."""
    return [(a if isinstance(a, torch.Tensor) else torch.from_numpy(a))
            .to(device) for a in arrays]


def scatter_seed(dtype, size):
    return size * 7 + len(dtype)


def scatter_timed_case(size, n, seed=29, spread="normal"):
    """(base, index, value) of a timed weighted SCATTER_ADD: ``n`` float32
    weights, normal(0, 1), into a zero base, at int32 indices drawn by
    ``spread``: "normal", normal(size / 2, size * 12 / 64) (phase 28's
    histogram scaled; the ones below 0 count from the end, the ones at
    ``size`` or above drop); "uniform" over the slots; "cyclic", lane i at
    slot i % size (every slot as often, a warp's lanes on distinct
    slots)."""
    rng = np.random.default_rng(seed)
    if spread == "normal":
        idx = rng.normal(size / 2, size * 12 / 64, n).astype(np.int32)
    elif spread == "uniform":
        idx = rng.integers(0, size, n, dtype=np.int32)
    else:
        idx = (np.arange(n, dtype=np.int64) % size).astype(np.int32)
    return (np.zeros(size, np.float32), idx,
            rng.standard_normal(n).astype(np.float32))


def scatter_program(tr, base, idx, val, device, chained=False):
    """The target ``base`` with ``val`` added at ``idx`` (lazily) on
    ``device`` (None: the module's default, as enoki_tpu.trace has it);
    with ``chained``, in two SCATTER_ADDs of half the lanes each, the
    second into the first's result."""

    def lazy(a):
        if device is None:
            return tr.LazyArray(a)
        import torch
        return tr.LazyArray(*scatter_tensors(torch, [a], device))

    t = lazy(base)
    h = len(idx) // 2 if chained else len(idx)
    for part in ((slice(0, h), slice(h, None)) if chained
                 else (slice(None),)):
        t.scatter_add(lazy(idx[part]), lazy(val[part]))
    return t


def scatter_kept(torch, n, idx, val):
    """The slots (int64, negative ones counted from the end) and values of
    the lanes of a SCATTER_ADD into ``n`` slots that are not dropped."""
    k = idx.to(torch.int64)
    k = torch.where(k < 0, k + n, k)
    keep = (k >= 0) & (k < n)
    return k[keep], val[keep]


def scatter_terms(torch, base, idx, val):
    """Per slot: the sum of the magnitudes of its terms (the base and each
    value added there, as float64), and whether a value other than -0.0
    (or an integer 0) reached it."""
    n = base.shape[0]
    k, v = scatter_kept(torch, n, idx, val)
    mag = base.to(torch.float64).abs().index_add(
        0, k, v.to(torch.float64).abs())
    moves = (v != 0) | ~torch.signbit(v) if v.dtype.is_floating_point \
        else v != 0
    touched = torch.zeros(n, dtype=torch.bool, device=base.device)
    touched[k[moves]] = True
    return mag, touched


def scatter_gate(torch, got, want, base, idx, val):
    """A SCATTER_ADD's result against another's on the same inputs that
    adds each slot's terms in another order: integers exactly; floats
    within four units of the type's roundoff (2^-22 for float32) of the
    sum of the magnitudes of each slot's terms, and a slot that nothing
    but -0.0 reached keeps the base's bits. Returns (ok, the largest
    difference)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf")
    if not got.dtype.is_floating_point:
        same = bool(torch.equal(got, want))
        return same, 0.0 if same else float("inf")
    mag, touched = scatter_terms(torch, base, idx, val)
    u = torch.finfo(got.dtype).eps / 2  # the roundoff, 2^-24 in float32
    diff = (got.double() - want.double()).abs()
    ok = bool((diff <= 4 * u * mag).all()) and keeps_base(
        torch, got, base, touched)
    return ok, float(diff.max()) if diff.numel() else 0.0


def keeps_base(torch, got, base, touched):
    """Whether the float slots not ``touched`` hold their base's bits."""
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        got.element_size()]
    return bool(torch.equal(got[~touched].view(bits),
                            base[~touched].view(bits)))


def scatter_exact(torch, got, want, base, idx, val):
    """Whether a SCATTER_ADD's result has the bits of another's on the
    same inputs (scatter_case's exact values sum alike in any order), and
    the slots that nothing but -0.0 reached keep the base's bits."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        got.element_size()]
    same = bool(torch.equal(got.view(bits), want.view(bits)))
    if not got.dtype.is_floating_point:
        return same
    return same and keeps_base(torch, got, base,
                               scatter_terms(torch, base, idx, val)[1])


def weights_gate(torch, got, base, idx, val):
    """Timed float32 weights (scatter_timed_case) against each slot's
    float64 sum: within WEIGHTS_UNITS units of roundoff, 2^-20, of the
    sum of the magnitudes of its terms. A float32 sum of a slot's terms
    in a random order, as global atomics add them, comes near 2^-22 of
    those magnitudes on some slot of 65,536, while a lost lane or a lost
    block's partial sum moves a slot by far more than 2^-20 (PERF.md §6,
    the weights gate, has the readings of both). Returns (ok, the largest |error|,
    the largest error over its limit)."""
    k, v = scatter_kept(torch, base.shape[0], idx, val)
    exact = base.double().index_add(0, k, v.double())
    limit = WEIGHTS_UNITS * 2.0 ** -24 * scatter_terms(
        torch, base, idx, val)[0]
    err = (got.double() - exact).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    return (bool((err <= limit).all()), float(err.max()),
            float(ratio.max()))


def trace_structures(torch, dev):
    """Setup of phase 28: every structure the phase evaluates, traced once
    and prepared (schedule, fused runs, generated source) in this thread;
    returns {name: plan}. Building them (nvcc) is the caller's, in its
    pool."""
    import enoki_tpu_torch.trace as tr
    from enoki_tpu_torch.config import config
    plans = {}
    t0 = time.perf_counter()
    for seed, dtype, ieee in TRACE_PROGRAMS:
        out, _ = trace_program(tr, seed, dtype, ieee, TRACE_N, dev,
                               data=False)
        plans[f"fuzz{seed}"] = tr.prepare(out)
    for n in (TRACE_CHAIN_SMALL, TRACE_N):
        data = torch.empty(n, device=dev)
        for seg in (0, TRACE_CHAIN_SEG):
            config.max_fused_ops = seg
            try:
                plans[f"chain{n}-{seg}"] = tr.prepare(trace_chain(tr, data))
            finally:
                config.max_fused_ops = 0
    # (b)'s SCATTER_ADDs, each alone: its scatter stays a pending side
    # effect of every later schedule until the trace is reset
    for name, make in scatter_structures(torch, dev, data=False):
        tr.reset()
        plans[name] = tr.prepare(*make(tr))
    tr.reset()
    # last: its scatter stays a pending side effect of every later schedule
    x = tr.LazyArray(torch.empty(TRACE_N, device=dev))
    plans["hist"] = tr.prepare(trace_hist(tr, x))
    tr.reset()
    log(f"setup: phase 28's {len(plans)} trace structures traced and "
        f"scheduled in {time.perf_counter() - t0:.2f} s; "
        f"{len({p.text for p in plans.values()})} distinct sources")
    return plans


def scatter_refused(tr, dev, case):
    """Whether a SCATTER_ADD of ``case`` into a bool target raises
    TypeError when it is recorded, as JAX's x.at[i].add refuses a bool
    array (the trace is reset after)."""
    try:
        scatter_program(tr, *case, dev)
    except TypeError:
        return True
    finally:
        tr.reset()
    return False


def scatter_structures(torch, dev, data=True):
    """Phase 28 (b)'s SCATTER_ADD programs: [(name, make)], ``make(tr)``
    the arrays to evaluate (``data``: the seeded inputs, else uninitialised
    ones of the timed cases: the same structure); a bool target has none
    (scatter_refused)."""
    out = []

    def case(dtype, size, chained=False):
        def make(tr):
            arrays = scatter_case(dtype, size, SCATTER_N,
                                  scatter_seed(dtype, size), exact=True)
            return [scatter_program(tr, *arrays, dev, chained)]
        return make

    for dtype in SCATTER_CODES:
        for size in SCATTER_SIZES if dtype != "bool" else ():
            out.append((f"scatter-{dtype}-{size}", case(dtype, size)))
    out.append(("scatter-chained", case("float32", 64, chained=True)))
    for name, (targets, _) in SCATTER_SEVERAL.items():
        def make(tr, targets=targets):
            return [scatter_program(tr, *scatter_case(
                dt, n, SCATTER_N, k + 3, exact=True), dev)
                for k, (dt, n) in enumerate(targets)]
        out.append((f"scatter-{name}", make))
    for size in SCATTER_TIMED:
        def make(tr, size=size):
            if data:
                arrays = [torch.from_numpy(a).to(dev)
                          for a in scatter_timed_case(size, TRACE_N)]
            else:
                arrays = [torch.empty(k, dtype=dt, device=dev) for k, dt in (
                    (size, torch.float32), (TRACE_N, torch.int32),
                    (TRACE_N, torch.float32))]
            return [scatter_program(tr, *arrays, dev)]
        out.append((f"scatter-timed-{size}", make))
    return out


def trace_launcher(torch, tr, dev, arrays):
    """(plan, a function that runs the kernels of evaluating ``arrays``
    once and evaluates nothing in the trace): for timing. The native
    core's schedule is theirs until the next one is made."""
    import ctypes
    plan = tr.prepare(*arrays)
    n = len(plan.entries)
    bits, codes = tr._collect_literals(n)
    buf = (ctypes.c_uint32 * max(n, 1))()
    leaves = [tr._BUFFERS[buf[i]]
              for i in range(tr._lib.ett_schedule_data_ids(buf, n))]
    lit = torch.from_numpy(bits.view(np.int64)).to(dev)
    return plan, lambda: plan.run(leaves, lit, bits, codes, dev)


def scatter_on(torch, tr, dev, arrays, chained=False):
    """(plan, the kernels' results, the plain interpreter's, launches) of
    the SCATTER_ADD cases ``arrays`` ((base, idx, val) each) evaluated in
    one schedule on ``dev``, the plain interpreter run there too, the
    trace reset before and after."""
    from enoki_tpu_torch.render import LAUNCHES
    tr.reset()
    ts = [scatter_program(tr, *a, dev, chained) for a in arrays]
    plan = tr.prepare(*ts)
    want = tr.plain_eval(*ts)
    before = LAUNCHES["trace"]
    tr.eval(*ts)
    got = [t.torch() for t in ts]
    torch.cuda.synchronize()
    launched = LAUNCHES["trace"] - before
    del ts
    tr.reset()
    return plan, got, want, launched


def run_scatter(torch, dev, timer, timed_ms, smi):
    """Phase 28 (b)'s SCATTER_ADD routes on the card: each route at each
    side of its thresholds, several targets in one run, two SCATTER_ADDs
    into one target, bit-equal to the plain interpreter on values whose
    sums are exact in any order; each route timed at TRACE_N lanes of
    random float32 weights beside its plain version, torch.bincount and
    its bound, held to the float64 sum (weights_gate), route 1 twice,
    bitwise. Returns (launches, runs, rows)."""
    import enoki_tpu_torch.trace as tr
    from enoki_tpu_torch.render import LAUNCHES

    launches = runs = 0
    by_route = {1: [], 2: [], 3: []}

    def held(name, arrays, routes, chained=False):
        nonlocal launches, runs
        plan, got, want, launched = scatter_on(torch, tr, dev, arrays,
                                               chained)
        got_routes = [plan.runs[0].routes[p] for p in plan.runs[0].targets]
        check(len(plan.runs) == 1 and got_routes == routes,
              f"phase 28 (b): {name} took {len(plan.runs)} runs, routes "
              f"{got_routes} (want {routes})")
        launches += launched
        runs += len(plan.runs)
        for g, w, a in zip(got, want, arrays):
            check(scatter_exact(torch, g, w, *scatter_tensors(torch, a, dev)),
                  f"phase 28 (b): {name}: the kernel's bits differ from the "
                  f"plain interpreter's")
        return plan

    for dtype in SCATTER_CODES:
        for size in SCATTER_SIZES:
            case = scatter_case(dtype, size, SCATTER_N,
                                scatter_seed(dtype, size), exact=True)
            if dtype == "bool":
                check(scatter_refused(tr, dev, case),
                      f"phase 28 (b): a SCATTER_ADD into a bool target of "
                      f"{size} was not refused")
                continue
            route = scatter_route(dtype, size)
            held(f"{dtype} into {size}", [case], [route])
            by_route[route].append(f"{dtype}/{size}")
    plan = held("two into one float32 target of 64",
                [scatter_case("float32", 64, SCATTER_N,
                              scatter_seed("float32", 64), exact=True)],
                [scatter_route("float32", 64)],
                chained=True)
    check(len(plan.runs[0].alias) == 1, "phase 28 (b): the two "
          "SCATTER_ADDs into one target do not share its copy")
    for name, (targets, routes) in SCATTER_SEVERAL.items():
        held(name, [scatter_case(dt, n, SCATTER_N, k + 3, exact=True)
                    for k, (dt, n) in enumerate(targets)], routes)
    log(f"phase 28 (b) SCATTER_ADD routes at {SCATTER_N} lanes, one kernel "
        f"a program, bit-equal to the plain interpreter (floats in quarters "
        f"from -8 to 8, whose sums are exact in any order; slots "
        f"that only -0.0 reached keep their base's bits): route 1 (a row a "
        f"thread) {', '.join(by_route[1])}; route 2 (a copy a block) "
        f"{', '.join(by_route[2])}; route 3 (global atomics) "
        f"{', '.join(by_route[3])}; several targets in one run "
        f"({', '.join(SCATTER_SEVERAL)}) and two SCATTER_ADDs into one "
        f"target: pass; a bool target refused (TypeError) at every size")

    rows = []
    for size in SCATTER_TIMED:
        route = scatter_route("float32", size)
        tr.reset()
        base, idx, val = (torch.from_numpy(a).to(dev)
                          for a in scatter_timed_case(size, TRACE_N))
        t = scatter_program(tr, base, idx, val, dev)
        plan, run = trace_launcher(torch, tr, dev, [t])
        check(list(plan.runs[0].routes.values()) == [route],
              f"phase 28 (b): the timed target of {size} slots took routes "
              f"{list(plan.runs[0].routes.values())}, not {route}")
        before = LAUNCHES["trace"]
        (first,) = run()[:1]
        (again,) = run()[:1]
        torch.cuda.synchronize()
        launches += LAUNCHES["trace"] - before
        runs += 2 * len(plan.runs)
        ok, err, share = weights_gate(torch, first, base, idx, val)
        check(ok, f"phase 28 (b): timed route {route}: the kernel is "
              f"{share:.3g} of its limit from the float64 sum (max "
              f"{err:.3g})")
        same = torch.equal(first.view(torch.int32), again.view(torch.int32))
        if route == 1:
            check(same, "phase 28 (b): route 1 gave other bits on a second "
                  "run of the same float32 weights")
        ms = timed_ms(run, 20, 300.0)
        plain_ms = timer(lambda: tr.plain_eval(t), 3, hold_ms=300.0,
                         plain=True)
        k, w = scatter_kept(torch, size, idx, val)
        lib_ms = timer(lambda: torch.bincount(k, weights=w, minlength=size),
                       20, hold_ms=300.0)
        b, by = bound(8 * TRACE_N + 8 * size, TRACE_N, int_ops=3 * TRACE_N)
        rows.append(dict(route=route, slots=size, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b, bound_by=by,
                         max_abs_err=err, gate_share=share,
                         repeatable=bool(same)))
        log(f"phase 28 (b) route {route}, {TRACE_N} float32 weights into "
            f"{size} slots: kernel {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"torch.bincount {lib_ms:.4f} ms, bound {b:.5f} ms by {by}); "
            f"max |err| against the float64 sum {err:.3g}, {share:.3g} of "
            f"its limit ({WEIGHTS_UNITS} x 2^-24 of the slot's magnitudes); "
            f"two runs "
            f"{'bitwise equal' if same else 'differ in their last bits'}; "
            f"{smi}")
        del t, first, again
    tr.reset()
    return launches, runs, rows


# phase 28 (b)'s sweep of the plain interpreter, card against CPU: every
# storage code (trace/plain.py's STORAGE, in its order) through every op
# that reads other lanes than its own
LANE_CODES = ("float32", "float64", "int32", "uint32", "bool", "bfloat16",
              "int64", "uint64", "float16")
LANE_OPS = ("SCATTER", "SCATTER_ADD", "GATHER", "REVERSE", "COMPRESS",
            "PSUM", "HSUM", "HPROD", "HMIN", "HMAX", "ALL", "ANY", "COUNT")
LANE_N = 1 << 16


def lane_values(rng, dtype, n, op):
    """``n`` values of ``dtype`` whose every reduction is exact in any
    order: floats in quarters from -8 to 8 with a twentieth -0.0 (HPROD:
    +-1 with a few +-2 and +-0.5), integers over their whole range with a
    tenth 0, bools half true. numpy, but bfloat16 a CPU tensor, as
    scatter_case's."""
    if dtype == "bool":
        return rng.random(n) < 0.5
    dt = np.dtype("float32" if dtype == "bfloat16" else dtype)
    if dt.kind == "f":
        if op == "HPROD":
            v = rng.choice([1.0, -1.0, 2.0, -2.0, 0.5, -0.5], n, p=[
                0.46, 0.46, 0.02, 0.02, 0.02, 0.02]).astype(dt)
        else:
            v = (rng.integers(-32, 32, n, endpoint=True) / 4).astype(dt)
            v[rng.random(n) < 0.05] = -0.0
        if dtype == "bfloat16":
            import torch
            return torch.from_numpy(v).to(torch.bfloat16)
        return v
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    v[rng.random(n) < 0.1] = 0
    return v


def lane_case(torch, tr, dtype, op, n, device, seed=0):
    """The plain interpreter's result of ``op`` over ``n`` lanes of
    ``dtype`` on ``device`` (``trace.plain_eval``), or "refused" where the
    op raises TypeError when it is recorded (a SCATTER_ADD into a bool
    target, as JAX refuses it). The same ``seed`` gives the same inputs on
    every device. SCATTER writes each kept slot once (which write of two
    wins is not specified), SCATTER_ADD takes scatter_case's exact
    values."""
    rng = np.random.default_rng([seed, LANE_CODES.index(dtype),
                                 LANE_OPS.index(op)])

    def lazy(a):
        return tr.LazyArray(*scatter_tensors(torch, [a], device))

    tr.reset()
    try:
        if op in ("SCATTER", "SCATTER_ADD"):
            if op == "SCATTER_ADD":
                base, idx, val = scatter_case(dtype, n // 16, n, seed + 1,
                                              exact=True)
            else:
                base = lane_values(rng, dtype, n, op)
                val = lane_values(rng, dtype, n, op)
                idx = rng.permutation(n)
                idx = np.where(rng.random(n) < 0.5, idx - n, idx)
                out = rng.random(n) < 0.1
                idx = np.where(out, n + rng.integers(0, 9, n), idx)
            t = lazy(base)
            try:
                (t.scatter_add if op == "SCATTER_ADD" else t.scatter)(
                    lazy(idx.astype(np.int32)), lazy(val))
            except TypeError:
                return "refused"
            (got,) = tr.plain_eval(t)
            return got
        x = lazy(lane_values(rng, dtype, n, op))
        if op == "GATHER":
            y = x.gather(lazy(rng.integers(-n // 8, n + n // 8, n).astype(
                np.int32)))
        elif op == "COMPRESS":
            y = x.compress(lazy(rng.random(n) < 0.3))[0]
        else:
            y = getattr(x, {"REVERSE": "reverse", "PSUM": "psum",
                            "HSUM": "hsum", "HPROD": "hprod",
                            "HMIN": "hmin", "HMAX": "hmax", "ALL": "all",
                            "ANY": "any", "COUNT": "count"}[op])()
        (got,) = tr.plain_eval(y)
        return got
    finally:
        tr.reset()


def lane_same(torch, got, want):
    """Whether two lane_case results are the same: both refused, or the
    same dtype, shape and bits (compared on the CPU)."""
    if isinstance(got, str) or isinstance(want, str):
        return got == want
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        got.element_size()]
    return bool(torch.equal(got.cpu().view(bits), want.cpu().view(bits)))


def run_lane_sweep(torch, dev, n=None):
    """Phase 28 (b)'s sweep: ``lane_case`` of every code of LANE_CODES and
    op of LANE_OPS on ``dev`` and on the CPU, held bitwise; a case that
    raises on ``dev`` fails the phase with its error. Returns the number
    of cases."""
    import enoki_tpu_torch.trace as tr
    n = LANE_N if n is None else n
    cpu = torch.device("cpu")
    bad, t0 = [], time.perf_counter()
    for dtype in LANE_CODES:
        for op in LANE_OPS:
            try:
                got = lane_case(torch, tr, dtype, op, n, dev)
            except Exception as e:  # noqa: BLE001 - reported below
                bad.append(f"{dtype} {op}: {type(e).__name__}: {e}")
                continue
            if not lane_same(torch, got, lane_case(torch, tr, dtype, op, n,
                                                   cpu)):
                bad.append(f"{dtype} {op}: differs from the CPU")
    check(not bad, "phase 28 (b) lane sweep: " + "; ".join(bad))
    cases = len(LANE_CODES) * len(LANE_OPS)
    log(f"phase 28 (b) lane sweep: trace.plain_eval of {', '.join(LANE_OPS)} "
        f"over {n} lanes of each of {', '.join(LANE_CODES)} "
        f"({cases} cases; a bool SCATTER_ADD refused on both devices) "
        f"bitwise equal on {dev.type} and on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    return cases


def build_trace_plans(plans, pool):
    """Build each distinct source of ``plans`` once, in ``pool``; returns
    {source text: build seconds}; every plan's library is loaded after."""
    texts = {}
    for p in plans.values():
        texts.setdefault(p.text, p)

    def build(p):
        t0 = time.perf_counter()
        p.library()
        return time.perf_counter() - t0

    return dict(zip(texts, pool.map(build, texts.values())))


def trace_ulps(torch, got, want):
    """Max ulp distance of two float tensors of one dtype (NaN as NaN)."""
    if not got.dtype.is_floating_point:
        return 0.0 if torch.equal(got, want) else float("inf")
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    g, w = got[~nan].double(), want[~nan].double()
    same = g == w
    if bool(same.all()):
        return 0.0
    sp = torch.abs(torch.nextafter(w.to(want.dtype), torch.full_like(
        w.to(want.dtype), float("inf"))).double() - w)
    return float(((g - w).abs() / sp)[~same].max().item())


def trace_cache_child(device="cuda"):
    """Phase 28 (f), in a second process: the programs of (a) with the
    parent's trace_export_dir and a build directory of their own, nvcc
    refused: every kernel comes from the disk cache."""
    import torch
    from enoki_tpu_torch import _build
    import enoki_tpu_torch.trace as tr

    calls = []

    def no_nvcc():
        calls.append(1)
        raise RuntimeError("phase 28 (f): nvcc called in the second process")

    _build.find_nvcc = no_nvcc
    dev = torch.device(device)
    worst = 0.0
    for seed, dtype, ieee in TRACE_PROGRAMS:
        out, _ = trace_program(tr, seed, dtype, ieee, TRACE_N, dev)
        (want,) = tr.plain_eval(out)
        got = out.torch()
        worst = max(worst, trace_ulps(torch, got, want))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    check(not calls, "phase 28 (f): nvcc was called")
    check(worst <= 1.0, f"phase 28 (f): kernel against plain {worst} ulp")
    print(f"phase 28 (f) child: {len(TRACE_PROGRAMS)} programs at "
          f"{TRACE_N} lanes from the disk cache, no nvcc call, max "
          f"{worst} ulp against the plain interpreter", flush=True)


def run_trace_alone(torch):
    """Phase 28 alone on the card: its setup (the structures, built in a
    pool of their own), then the phase; prints the kernels line."""
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.config import config
    import shutil
    dev = torch.device("cuda")
    log(nvidia_smi("name,power.limit"))
    export = _build.BUILD_DIR / "trace_export"
    shutil.rmtree(export, ignore_errors=True)
    config.trace_export_dir = str(export)
    t0 = time.perf_counter()
    plans = trace_structures(torch, dev)
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        build_s = build_trace_plans(plans, pool)
    for plan in plans.values():
        plan.library()
    log(f"setup: {len(build_s)} trace sources built in "
        f"{time.perf_counter() - t0:.1f} s (each "
        f"{', '.join(f'{v:.1f}' for v in build_s.values())} s)")
    rows = run_trace(torch, dev, DeviceTimer(torch), plans, build_s)
    print(json.dumps({"kernels": rows}))


def run_trace(torch, dev, timer, plans, build_s):
    """Phase 28: the lazy trace at 2^24 lanes through its public API, each
    fused run one generated kernel, held to the plain interpreter."""
    import enoki_tpu_torch.trace as tr
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.config import config
    from enoki_tpu_torch.render import LAUNCHES, reset_launch_counts

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    tr.reset()
    reset_launch_counts()
    counted = []  # (program, launches of its eval, its fused runs)
    timed = [0]   # launches made to time a kernel, not the path's

    def timed_ms(fn, reps, hold_ms):
        before = LAUNCHES["trace"]
        ms = timer(fn, reps, hold_ms=hold_ms)
        timed[0] += LAUNCHES["trace"] - before
        return ms

    # -- (a) fuzz programs: kernel against plain, card against CPU --------
    worst_ieee = worst_all = 0.0
    max_err = 0.0
    cpu_checked = []
    for seed, dtype, ieee in TRACE_PROGRAMS:
        out, leaves = trace_program(tr, seed, dtype, ieee, TRACE_N, dev)
        plan = tr.prepare(out)
        (want,) = tr.plain_eval(out)
        before = LAUNCHES["trace"]
        got = out.torch()
        torch.cuda.synchronize()
        counted.append((f"fuzz{seed}", LAUNCHES["trace"] - before,
                        len(plan.runs)))
        check(LAUNCHES["trace"] - before == len(plan.runs) == 1,
              f"phase 28 (d): fuzz{seed} launched "
              f"{LAUNCHES['trace'] - before} kernels for {len(plan.runs)} "
              "runs")
        check(got.shape == (TRACE_N,) and got.dtype == getattr(torch, dtype),
              f"phase 28 (a): fuzz{seed} gave {got.dtype} {got.shape}")
        u = trace_ulps(torch, got, want)
        fin = torch.isfinite(want)
        max_err = max(max_err, float((got[fin].double() - want[fin].double())
                                     .abs().max().item()))
        if ieee:
            worst_ieee = max(worst_ieee, u)
            check(u == 0.0, f"phase 28 (a): IEEE-only fuzz{seed} {dtype} not "
                  f"bit-equal to the plain interpreter ({u} ulp)")
        else:
            worst_all = max(worst_all, u)
            check(u <= 1.0, f"phase 28 (a): fuzz{seed} {dtype} {u} ulp from "
                  "the plain interpreter")
        if (seed, dtype) in ((3, "float32"), (301, "float64")):
            cpu, _ = trace_program(tr, seed, dtype, ieee, TRACE_N, "cpu")
            c = cpu.torch()
            if ieee:
                ok = trace_ulps(torch, got.cpu(), c) == 0.0
                gate = "bit-equal"
            else:
                rtol, atol = (2e-5, 1e-6) if dtype == "float32" \
                    else (1e-12, 1e-14)
                ok = bool(torch.allclose(got.cpu(), c, rtol=rtol, atol=atol,
                                         equal_nan=True))
                gate = f"rtol {rtol}, atol {atol}"
            cpu_checked.append(f"fuzz{seed} {dtype} ({gate})")
            check(ok, f"phase 28 (a): fuzz{seed} on the card against the "
                  f"CPU plain interpreter: {gate}")
            del cpu, c
        del out, got, want
    log(f"phase 28 (a) {len(TRACE_PROGRAMS)} fuzz programs at {TRACE_N} "
        f"lanes, one kernel each: IEEE-only bit-equal to the plain "
        f"interpreter (max {worst_ieee} ulp), with transcendentals max "
        f"{worst_all} ulp (gate 1); card against the CPU plain interpreter: "
        f"{', '.join(cpu_checked)}: pass")

    # -- (b) a histogram program, one eval, one kernel ----------------------
    rng = np.random.default_rng(28)
    vals = rng.normal(32.0, 12.0, TRACE_N).astype(np.float32)
    v = tr.LazyArray(vals, device=dev)
    h = trace_hist(tr, v)
    plan_h = tr.prepare(h)
    (want,) = tr.plain_eval(h)
    before = LAUNCHES["trace"]
    got = h.torch()
    torch.cuda.synchronize()
    launched = LAUNCHES["trace"] - before
    counted.append(("hist", launched, len(plan_h.runs)))
    idx = torch.from_numpy(vals).to(dev).to(torch.int32).long()
    idx = torch.where(idx < 0, idx + TRACE_HIST_BINS, idx)
    idx = idx[(idx >= 0) & (idx < TRACE_HIST_BINS)]
    lib = torch.bincount(idx, minlength=TRACE_HIST_BINS).to(torch.int32)
    check(launched == 1 and len(plan_h.runs) == 1,
          f"phase 28 (d): the histogram launched {launched} kernels")
    check(torch.equal(got, want) and torch.equal(got, lib),
          "phase 28 (b): histogram counts differ from the plain "
          "interpreter's or torch.bincount's")
    log(f"phase 28 (b) histogram of {TRACE_N} values into "
        f"{TRACE_HIST_BINS} bins in one eval: 1 kernel, counts equal to the "
        f"plain interpreter's and torch.bincount's (total "
        f"{int(got.sum().item())})")

    # -- (c) the 10,444-op chain ---------------------------------------------
    chain_rows = {}
    for n in (TRACE_CHAIN_SMALL, TRACE_N):
        data = torch.from_numpy(np.linspace(0.5, 1.5, n).astype(np.float32))
        data = data.to(dev)
        outs = {}
        for seg in (0, TRACE_CHAIN_SEG):
            config.max_fused_ops = seg
            try:
                t0 = time.perf_counter()
                y = trace_chain(tr, data)
                t_trace = time.perf_counter() - t0
                t0 = time.perf_counter()
                plan = tr.prepare(y)
                t_sched = time.perf_counter() - t0
                before = LAUNCHES["trace"]
                t0 = time.perf_counter()
                y.eval()
                torch.cuda.synchronize()
                t_first = time.perf_counter() - t0
                counted.append((f"chain{n}-{seg}", LAUNCHES["trace"] - before,
                                len(plan.runs)))
                check(LAUNCHES["trace"] - before == len(plan.runs),
                      f"phase 28 (d): the chain launched "
                      f"{LAUNCHES['trace'] - before} kernels for "
                      f"{len(plan.runs)} runs")
                outs[seg] = y.torch()
                hits = []
                for k in range(5):
                    t0 = time.perf_counter()
                    y2 = trace_chain(tr, data + float(k + 1))
                    y2.eval()
                    torch.cuda.synchronize()
                    hits.append(1e3 * (time.perf_counter() - t0))
                    del y2
                hit_ms, hit_spread = robust(hits)
                row = dict(runs=len(plan.runs), trace_ms=1e3 * t_trace,
                           sched_ms=1e3 * t_sched,
                           nvcc_s=build_s.get(plan.text, 0.0),
                           first_s=build_s.get(plan.text, 0.0) + t_first,
                           hit_ms=hit_ms, hit_spread=hit_spread)
                if n == TRACE_N:
                    # the kernel(s) alone, on the last retrace's literals
                    # (the native core's current schedule is that retrace)
                    leaves = [data]
                    bits, codes = tr._collect_literals(len(plan.entries))
                    lit = torch.from_numpy(bits.view(np.int64)).to(dev)
                    row["ms"] = timed_ms(lambda: plan.run(
                        leaves, lit, bits, codes, dev), 5, 500.0)
                chain_rows[(n, seg)] = row
            finally:
                config.max_fused_ops = 0
        check(torch.equal(outs[0], outs[TRACE_CHAIN_SEG]),
              f"phase 28 (c): the chain at {n} lanes, whole and in "
              f"{TRACE_CHAIN_SEG}-entry kernels, differ")
        check(bool(torch.isfinite(outs[0]).all()),
              "phase 28 (c): the chain is not finite")
    y = trace_chain(tr, torch.from_numpy(
        np.linspace(0.5, 1.5, TRACE_N).astype(np.float32)).to(dev))
    chain_plain_ms = timer(lambda: tr.plain_eval(y), 1, hold_ms=1000.0,
                           plain=True)
    (chain_plain,) = tr.plain_eval(y)
    chain_kernel = y.torch()
    torch.cuda.synchronize()
    check(torch.equal(chain_plain, chain_kernel),
          "phase 28 (c): the chain's kernel and plain interpreter differ")
    del y, chain_plain, chain_kernel
    iters = TRACE_CHAIN_OPS // 4
    chain_bound, chain_by = bound(8 * TRACE_N, 3 * iters * TRACE_N)
    for (n, seg), r in chain_rows.items():
        log(f"phase 28 (c) chain of {TRACE_CHAIN_OPS} ops at {n} lanes, "
            f"max_fused_ops {seg}: {r['runs']} kernel(s); trace "
            f"{r['trace_ms']:.2f} ms, schedule + emit {r['sched_ms']:.2f} ms,"
            f" nvcc {r['nvcc_s']:.2f} s (setup), first eval "
            f"{r['first_s']:.2f} s (nvcc included), cache-hit re-dispatch "
            f"{r['hit_ms']:.3f} ms (median of 5, spread {r['hit_spread']:.1%})"
            + (f", kernel device {r['ms']:.4f} ms" if "ms" in r else "")
            + f"; {smi}")
    whole = chain_rows[(TRACE_N, 0)]
    seg_row = chain_rows[(TRACE_N, TRACE_CHAIN_SEG)]
    log(f"phase 28 (c) bound of the chain at {TRACE_N} lanes: "
        f"{1e3 * 8 * TRACE_N / HBM_BYTES_PER_S:.5f} ms by bytes "
        f"(4 B read + 4 B written a lane over 3.35 TB/s), "
        f"{1e3 * 3 * iters * TRACE_N / FP32_FLOPS_PER_S:.4f} ms by "
        f"operations ({3 * iters} FP32 ops a lane); plain interpreter "
        f"{chain_plain_ms:.2f} ms; kernel {whole['ms']:.4f} ms whole, "
        f"{seg_row['ms']:.4f} ms in {seg_row['runs']} kernels")
    if whole["nvcc_s"] > 30.0:
        log(f"phase 28 (c): the whole chain's build took "
            f"{whole['nvcc_s']:.1f} s (> 30 s): the {TRACE_CHAIN_SEG}-entry "
            f"build took {seg_row['nvcc_s']:.1f} s")

    log("phase 28 (d) one launch a fused run, counted by _build.LAUNCHES: "
        + ", ".join(f"{name} {k}/{r}" for name, k, r in counted) + ": pass")

    # -- timing of the histogram's kernel, its plain version, bincount ----
    hist_ms = timed_ms(trace_launcher(torch, tr, dev, [trace_hist(tr, v)])[1],
                       20, 300.0)
    h2 = trace_hist(tr, v)
    hist_plain_ms = timer(lambda: tr.plain_eval(h2), 5, hold_ms=300.0,
                          plain=True)
    hist_lib_ms = timer(lambda: torch.bincount(idx, minlength=64), 20,
                        hold_ms=300.0)
    del h2
    hist_bound, hist_by = bound(4 * TRACE_N + 4 * TRACE_HIST_BINS, 0,
                                int_ops=3 * TRACE_N)
    log(f"phase 28 (b) histogram kernel {hist_ms:.4f} ms (plain "
        f"{hist_plain_ms:.4f} ms, torch.bincount {hist_lib_ms:.4f} ms, bound "
        f"{hist_bound:.5f} ms by {hist_by}: 64 int32 bins, route "
        f"{list(plan_h.runs[0].routes.values())[0]}); {smi}")
    del v
    n_launched, n_runs, scatter_rows = run_scatter(torch, dev, timer,
                                                   timed_ms, smi)
    run_lane_sweep(torch, dev)
    check(n_launched == n_runs, f"phase 28 (d): the SCATTER_ADD programs "
          f"launched {n_launched} kernels for {n_runs} runs")

    # -- (e) printf: the same text from both routes -------------------------
    import io
    x = tr.LazyArray(np.arange(TRACE_PRINT_N, dtype=np.float32) * 0.5,
                     device=dev)
    texts = []
    for route in ("kernel", "plain"):
        yp = tr.printf("x={} y={}", x, tr.sin(x) * 2.0) + 1.0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if route == "kernel":
                yp.eval()
                torch.cuda.synchronize()
            else:
                tr.plain_eval(yp)
        texts.append(buf.getvalue())
        del yp
    check(texts[0] == texts[1] and texts[0].startswith("x=[0."),
          f"phase 28 (e): printf differs between the routes: {texts!r}")
    log(f"phase 28 (e) printf: the kernel route and the plain interpreter "
        f"print the same {len(texts[0])} characters")
    launches = LAUNCHES["trace"] - timed[0]
    tr.reset()  # the plain route's print stays a pending side effect

    # -- (f) the disk cache: a second process without nvcc ------------------
    env = dict(os.environ,
               ENOKI_TPU_EXPORT_CACHE=config.trace_export_dir,
               ENOKI_TPU_COMPILE_CACHE=str(_build.BUILD_DIR
                                           / "trace_child_build"))
    import shutil
    shutil.rmtree(env["ENOKI_TPU_COMPILE_CACHE"], ignore_errors=True)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as C; "
         "C.trace_cache_child()"], env=env, capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(child.returncode == 0,
          f"phase 28 (f): the second process failed:\n{child.stderr[-3000:]}")
    log(child.stdout.strip() + f" ({time.perf_counter() - t0:.1f} s)")
    tr.reset()
    log(f"phase 28 trace: {launches} fused-kernel launches, "
        f"{time.perf_counter() - t_phase:.1f} s")
    return [dict(name="trace", route="cuda",
                 source="enoki_tpu_torch/csrc/trace_kernel.cuh",
                 replaces="enoki_tpu/trace/__init__.py:396",
                 launches=launches, max_abs_err=max_err,
                 ms=whole["ms"], plain_ms=chain_plain_ms,
                 bound_ms=chain_bound, bound_by=chain_by, library_ms=None,
                 chain_seg_ms=seg_row["ms"], chain_nvcc_s=whole["nvcc_s"],
                 chain_first_eval_s=whole["first_s"],
                 chain_hit_ms=whole["hit_ms"], hist_ms=hist_ms,
                 hist_plain_ms=hist_plain_ms, hist_bound_ms=hist_bound,
                 hist_library_ms=hist_lib_ms, scatter_routes=scatter_rows)]


# ---------------------------------------------------------------------------
# Phase 29: the trace's AD tape and its calls (trace/tape.py, trace/call.py):
# adjoint and tangent programs fused into the trace's own kernels
# ---------------------------------------------------------------------------

TAPE_N = 1024                  # the fit's image side (2^20 lanes)
TAPE_STEPS = 10                # gradient steps of the fit
TAPE_TRUE = (0.12, -0.08, 0.85)   # the target sphere's (cx, cy, radius)
TAPE_INIT = (0.0, 0.0, 1.0)
TAPE_LR = (1e-5, 1e-5, 5e-6)  # gradient-descent rates of (cx, cy, r)
TAPE_FUZZ_N = 1 << 24          # lanes of (b)'s fuzz backward programs
# tests/test_torch_trace_fuzz.py's seeds 500-503, and 517: IEEE operations only
TAPE_FUZZ_SEEDS = (500, 501, 502, 503, 517)
TAPE_CALLS = 8                 # callees of (d)'s dispatch
TAPE_CALLS_N = 1 << 20


def tape_render(tr, n, cx, cy, r, device, extent=1.2):
    """examples/lazy_sphere.py's render_lazy in trace functions: the image
    of a sphere of centre (cx, cy) and radius r lit from (-1, -1, 2); the
    square root is taken of 1 where the ray misses or grazes, so that the
    adjoint meets no 0 * inf."""
    idx = tr.LazyArray.arange(n * n, device=device)
    col = (idx % n).cast("float32")
    row = (idx / n).cast("float32")
    step = 2.0 * extent / (n - 1)
    ox = col * step - extent - cx
    oy = row * step - extent - cy
    c = ox * ox + oy * oy + 1.0 - r * r
    disc = 4.0 - c * 4.0
    valid = disc > 0.0
    t = (tr.sqrt(tr.select(valid, disc, 1.0)) + 2.0) * 0.5
    nx = tr.select(valid, ox, 0.0)
    ny = tr.select(valid, oy, 0.0)
    nz = tr.select(valid, t - 1.0, 0.0)
    lam = tr.maximum(nx * -1.0 + ny * -1.0 + nz * 2.0, 0.0)
    return lam * 90.0 + 0.2


def tape_fit_loss(tr, n, params, target, device):
    """The fit's loss, the mean squared difference from ``target``; only
    the loss is returned, so that no intermediate is an output."""
    d = tape_render(tr, n, *params, device) - target
    return (d * d).hsum() * (1.0 / (n * n))


def tape_params(tr, p, device, full=0):
    """The fit's parameters as marked LazyArrays (``full``: each broadcast
    to that many lanes, so that the gradients hold the terms of the
    size-1 parameters' sums)."""
    import torch
    return [tr.requires_grad(tr.LazyArray(torch.full(
        (full or 1,), float(v), dtype=torch.float32, device=device)))
        for v in p]


def tape_target(tr, n, device):
    import torch
    true = [tr.LazyArray(torch.tensor([v], dtype=torch.float32,
                                      device=device)) for v in TAPE_TRUE]
    return tape_render(tr, n, *true, device).torch()


def tape_fuzz(tr, seed, n, device, data=True):
    """A backward fuzz program of tests/test_torch_trace_fuzz.py's recipe
    at ``n`` lanes: (loss, marked leaves, IEEE operations only?)."""
    import torch
    rng = np.random.default_rng(seed)
    rng.integers(4, 33)  # the CPU test's lane count, replaced by n
    n_leaves = int(rng.integers(2, 4))
    leaves = [rng.uniform(-1.5, 1.5, n).astype(np.float32)
              for _ in range(n_leaves)]
    depth = int(rng.integers(4, 25))
    recipe, pool_size = [], n_leaves
    for _ in range(depth):
        k = int(rng.integers(len(TRACE_OPS)))
        recipe.append((k, [int(rng.integers(pool_size))
                           for _ in range(TRACE_OPS[k][1])]))
        pool_size += 1
    xs = [tr.requires_grad(tr.LazyArray(
        torch.from_numpy(l).to(device) if data
        else torch.zeros(n, device=device))) for l in leaves]
    pool = list(xs)
    for k, slots in recipe:
        pool.append(TRACE_OPS[k][3](tr, *[pool[s] for s in slots]))
    return pool[-1].hsum(), xs, all(TRACE_OPS[k][2] for k, _ in recipe)


def tape_digamma(tr, x):
    """The port's opcode 80 (digamma, LGAMMA's derivative) of ``x``."""
    return tr.LazyArray(x)._unary(tr.Op.DIGAMMA)


def digamma_terms(x):
    """The sum of the magnitudes of the terms that digamma adds at ``x``
    (numpy float64; ATen's algorithm: the reflection below 0, the
    recurrence up to 10, log and the asymptotic series)."""
    x = np.asarray(x, np.float64)
    with np.errstate(all="ignore"):
        neg = x < 0
        s = np.where(neg, np.abs(np.pi / np.tan(np.pi * np.modf(x)[0])), 0.0)
        z = np.where(neg, 1.0 - x, x)
        while True:
            low = z < 10
            if not low.any():
                break
            s = s + np.where(low, 1.0 / np.abs(z), 0.0)
            z = np.where(low, z + 1.0, z)
        s = s + np.abs(np.log(z)) + 0.5 / z + 0.1 / (z * z)
    return np.where(np.isfinite(s), s, np.inf)


class TapeInstance:
    """Instance k of (d)'s registry: a value, and a method of IEEE
    operations only."""

    def __init__(self, tr, k):
        self.tr, self.k, self.value = tr, k, 0.5 + 0.25 * k

    def apply(self, mask, x):
        return x * self.value + self.tr.sqrt(abs(x) + 0.125 * (self.k + 1)) \
            - self.tr.minimum(x, 0.1 * self.k)


def tape_dispatch(tr, device):
    """(d)'s program, through trace.call's registry functions (dispatch,
    partition and getter under them): (loss, the marked argument, the
    getter's values a lane)."""
    import torch
    import enoki_tpu_torch.trace.call as tc
    from enoki_tpu_torch.struct.call import InstanceRegistry
    reg = InstanceRegistry()
    for k in range(TAPE_CALLS):
        reg.register(TapeInstance(tr, k))
    rng = np.random.default_rng(29)
    ids = tr.LazyArray(torch.from_numpy(rng.integers(
        -1, TAPE_CALLS, TAPE_CALLS_N).astype(np.int32)).to(device))
    x = tr.requires_grad(tr.LazyArray(torch.from_numpy(rng.uniform(
        -2.0, 2.0, TAPE_CALLS_N).astype(np.float32)).to(device)))
    out = tc.registry_dispatch(reg, "apply", ids, x)
    return (out * out).hsum(), x, tc.registry_getter(reg, "value", ids)


def schedule_inputs(tr, torch, plan, device):
    """(data leaves, literal stream on the device, bits, codes) of the
    native core's current schedule (the one ``tr.prepare`` just made),
    which ``plan.run`` takes."""
    import ctypes
    n = len(plan.entries)
    buf = (ctypes.c_uint32 * max(n, 1))()
    nd = tr._lib.ett_schedule_data_ids(buf, n)
    leaves = [tr._BUFFERS[buf[i]] for i in range(nd)]
    bits, codes = tr._collect_literals(n)
    return leaves, torch.from_numpy(bits.view(np.int64)).to(device), bits, \
        codes


def program_bound(plan, leaves):
    """The least time of a schedule on the card: its data leaves read once
    and its outputs written once over the memory rate, against its float
    operations over the FP32 rate and its integer ones over the INT32
    rate (one operation an entry a lane; literals, leaves, casts,
    bitcasts, selects and prints count none)."""
    from enoki_tpu_torch.trace import plain
    free = (plain.CAST, plain.BITCAST, plain.SELECT, plain.PRINT)
    nbytes = sum(int(t.nbytes) for t in leaves)
    for p in set(plan.out_positions) - {plain.SENT}:
        e = plan.entries[p]
        nbytes += e[3] * plain.STORAGE[e[2]].itemsize
    flops = int_ops = 0
    for e in plan.entries:
        if e[6] or e[7] or e[1] in free:
            continue
        lanes = max([e[3]] + [plan.entries[q][3] for q in e[4]
                              if q != plain.SENT])
        if e[2] in plain.FLOATS:
            flops += lanes
        else:
            int_ops += lanes
    return bound(nbytes, flops, int_ops=int_ops) + (nbytes, flops, int_ops)


def tape_structures(torch, tr, dev, pool):
    """Setup of phase 29: every structure it evaluates, built in ``pool``
    in two rounds: the forward programs; then, those evaluated on their
    inputs (a program is recorded on the tape when it runs), the adjoint
    and tangent programs. Returns (plans, build seconds a source)."""
    from enoki_tpu_torch.trace import tape
    plans, seconds = {}, {}

    def build_all(some):
        texts = {}
        for p in some.values():
            texts.setdefault(p.text, p)

        def build(p):
            t0 = time.perf_counter()
            p.library()
            return time.perf_counter() - t0
        seconds.update(zip(texts, pool.map(build, texts.values())))
        plans.update(some)

    tr.reset()
    zeros = torch.zeros(TAPE_N * TAPE_N, device=dev)
    params = tape_params(tr, TAPE_INIT, dev)
    losses = {"fit": tape_fit_loss(tr, TAPE_N, params, zeros, dev)}
    for s in TAPE_FUZZ_SEEDS:
        losses[f"fuzz{s}"] = tape_fuzz(tr, s, TAPE_FUZZ_N, dev, data=False)[0]
    losses["dispatch"], _, values = tape_dispatch(tr, dev)
    first = {name: tr.prepare(loss) for name, loss in losses.items()}
    first["getter"] = tr.prepare(values)
    for dt in ("float32", "float64"):
        first["digamma_" + dt] = tr.prepare(tape_digamma(
            tr, torch.zeros(TAPE_FUZZ_N, dtype=getattr(torch, dt),
                            device=dev)))
    first["target"] = tr.prepare(tape_render(
        tr, TAPE_N, *[tr.LazyArray(torch.zeros(1, device=dev))
                      for _ in range(3)], dev))
    build_all(first)
    for loss in losses.values():
        loss.eval()
    second = {}
    for name, loss in losses.items():
        cot = tape.adjoint_program(loss)
        second[name + "_vjp"] = tr.prepare(*cot.values())
        del cot
    t = tape.tangent_program(params[0], losses["fit"])
    second["fit_jvp"] = tr.prepare(t)
    del t
    build_all(second)
    tr.reset()
    return plans, seconds


def tape_cpu_step(torch, tr, p, target):
    """Step 1 of the fit on the CPU plain route: (loss, gradients, the sums
    of their terms' magnitudes, from the same step with the parameters
    broadcast to every lane)."""
    tr.clear_gradients()
    params = tape_params(tr, p, "cpu")
    loss = tape_fit_loss(tr, TAPE_N, params, target, "cpu")
    tr.backward(loss)
    grads = [tr.gradient(q).torch() for q in params]
    full = tape_params(tr, p, "cpu", full=TAPE_N * TAPE_N)
    tr.backward(tape_fit_loss(tr, TAPE_N, full, target, "cpu"))
    terms = [float(tr.gradient(q).torch().double().abs().sum()) for q in full]
    tr.clear_gradients()
    return loss.torch(), grads, terms


def tape_cache_child(device="cuda"):
    """Phase 29 (e), in a second process: the fit's first step with the
    parent's trace_export_dir and a build directory of its own, nvcc
    refused: its forward and adjoint kernels come from the disk cache.
    Prints the gradients as float.hex, for the parent to compare."""
    import torch
    from enoki_tpu_torch import _build
    import enoki_tpu_torch.trace as tr

    def no_nvcc():
        raise RuntimeError("phase 29 (e): nvcc called in the second process")

    _build.find_nvcc = no_nvcc
    dev = torch.device(device)
    target = tape_target(tr, TAPE_N, dev)
    params = tape_params(tr, TAPE_INIT, dev)
    tr.backward(tape_fit_loss(tr, TAPE_N, params, target, dev))
    grads = [float(tr.gradient(q).torch()[0]) for q in params]
    print("phase 29 (e) child grads " + " ".join(g.hex() for g in grads),
          flush=True)


def run_tape_alone(torch):
    """Phase 29 alone on the card; prints the kernels line."""
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.config import config
    import shutil
    log(nvidia_smi("name,power.limit"))
    export = _build.BUILD_DIR / "trace_export"
    shutil.rmtree(export, ignore_errors=True)
    config.trace_export_dir = str(export)
    rows = run_tape(torch, torch.device("cuda"), DeviceTimer(torch))
    print(json.dumps({"kernels": rows}))


def run_tape(torch, dev, timer):
    """Phase 29: the AD tape and the calls at full width on the card, each
    derivative program fused into generated kernels and held to its plain
    interpreter."""
    import enoki_tpu_torch.trace as tr
    from enoki_tpu_torch.trace import codegen
    t_phase = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        plans, build_s = tape_structures(torch, tr, dev, pool)
    log(f"phase 29 setup: {len(plans)} structures, {len(build_s)} sources "
        f"built with nvcc at once in {time.perf_counter() - t_phase:.1f} s "
        f"(each {', '.join(f'{v:.1f}' for v in build_s.values())} s)")
    nvcc = [0]
    real = codegen._nvcc_build

    def counted(text):
        nvcc[0] += 1
        return real(text)

    codegen._nvcc_build = counted
    try:
        rows = _tape_phase(torch, tr, dev, timer, nvcc)
    finally:
        codegen._nvcc_build = real
    log(f"phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return rows


def _tape_phase(torch, tr, dev, timer, nvcc):
    from enoki_tpu_torch.render import LAUNCHES
    from enoki_tpu_torch.trace import tape
    smi = nvidia_smi("name,power.limit")
    names = ("trace_vjp", "trace_jvp")
    timed = dict.fromkeys(names, 0)  # launches made to time, not the path's

    def timed_ms(name, fn, reps):
        before = LAUNCHES[name]
        ms = timer(fn, reps, hold_ms=300.0)
        timed[name] += LAUNCHES[name] - before
        return ms

    # -- (a) the fit: the main path, counted ---------------------------------
    tr.reset()
    target = tape_target(tr, TAPE_N, dev)
    p = np.array(TAPE_INIT, np.float64)
    for name in names:
        LAUNCHES[name] = 0
    losses, walls, vjp_err, jvp_err = [], [], 0.0, 0.0
    for step in range(TAPE_STEPS):
        if step == 1:
            stats1, nvcc1 = tr.cache_stats(), nvcc[0]
        tr.clear_gradients()
        params = tape_params(tr, p, dev)
        t0 = time.perf_counter()
        loss = tape_fit_loss(tr, TAPE_N, params, target, dev)
        loss.eval()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # the same adjoint program through the plain interpreter on the
        # card (it launches nothing), then through the kernels
        cot = tape.adjoint_program(loss)
        want = tr.plain_eval(*[cot[q.index] for q in params])
        del cot
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tr.backward(loss, free=step != 0)
        grads = [tr.gradient(q).torch() for q in params]
        torch.cuda.synchronize()
        walls.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t2)))
        for g, w in zip(grads, want):
            vjp_err = max(vjp_err, float((g - w).abs().max()))
            check(torch.equal(g, w), f"phase 29 (a) step {step}: the "
                  "adjoint's kernels and its plain interpreter differ")
        losses.append(float(loss.torch()[0]))
        check(all(bool(torch.isfinite(g).all()) for g in grads),
              f"phase 29 (a) step {step}: a gradient is not finite")
        if step == 0:
            g0 = [float(g[0]) for g in grads]
            whos, dot = tr.tape_whos(), tr.tape_graphviz()
            check("segments: 1," in whos and dot.startswith("digraph tape")
                  and "segment 0" in dot and tr.grad_enabled(params[0]),
                  f"phase 29 (a): the tape's views on the card:\n{whos}")
            # (c) forward_from, its tangent program against the plain
            # interpreter's and against the gradient
            t = tape.tangent_program(params[0], loss)
            (t_want,) = tr.plain_eval(t)
            del t
            _, t_cx = tr.forward_from(params[0], loss)
            torch.cuda.synchronize()
            jvp_err = float((t_cx - t_want).abs().max())
            check(torch.equal(t_cx, t_want), "phase 29 (c): the tangent's "
                  "kernels and its plain interpreter differ")
            loss_cpu, grads_cpu, terms = tape_cpu_step(torch, tr, p,
                                                       target.cpu())
            fwd_bwd = abs(float(t_cx[0]) - g0[0])
            check(fwd_bwd <= 2 * 2 ** -22 * terms[0], "phase 29 (c): "
                  f"forward_from {float(t_cx[0])!r} against the gradient "
                  f"{g0[0]!r} (terms {terms[0]:.4g})")
            cpu_err = [abs(float(g[0]) - float(c[0])) / s
                       for g, c, s in zip(grads, grads_cpu, terms)]
            check(max(cpu_err) <= 2 ** -22, "phase 29 (a) step 1 on the card"
                  f" against the CPU: {cpu_err} of the terms' sums")
            dloss = abs(losses[0] - float(loss_cpu[0]))
            check(dloss <= 2 ** -20 * losses[0], "phase 29 (a) the loss on "
                  f"the card {losses[0]!r} against the CPU "
                  f"{float(loss_cpu[0])!r}")
        p = p - np.array(TAPE_LR) * np.array([float(g[0]) for g in grads])
        del loss, grads, want, params
    stats = tr.cache_stats()
    launches = {k: LAUNCHES[k] for k in names}
    check(stats[1] == stats1[1] and nvcc[0] == nvcc1, "phase 29 (a): steps "
          f"2-{TAPE_STEPS} missed the cache {stats[1] - stats1[1]} times "
          f"and called nvcc {nvcc[0] - nvcc1} times")
    check(losses[-1] < 0.5 * losses[0], f"phase 29 (a): the loss did not "
          f"fall: {losses[0]:.6g} -> {losses[-1]:.6g}")
    check(all(v > 0 for v in launches.values()),
          f"phase 29: a derivative kernel was not launched: {launches}")
    log(f"phase 29 (a) FloatD fit at {TAPE_N}^2: loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g} in {TAPE_STEPS} steps, (cx, cy, r) "
        f"({p[0]:+.4f}, {p[1]:+.4f}, {p[2]:.4f}), true {TAPE_TRUE}; every "
        f"step's gradients bit-equal to the adjoint's plain interpreter on "
        f"the card; step 1 against the CPU within {max(cpu_err):.3g} of the "
        f"terms' sums (gate 2^-22), the loss within {dloss / losses[0]:.3g} "
        f"(gate 2^-20); steps 2-{TAPE_STEPS}: no cache miss, no nvcc; "
        f"launches {launches}")
    log("phase 29 (a) wall ms a step (forward eval, backward), host clock "
        "with a synchronise: " + ", ".join(f"({f:.3f}, {b:.3f})"
                                           for f, b in walls))
    log(f"phase 29 (c) forward_from(cx) {float(t_cx[0])!r} against the "
        f"gradient {g0[0]!r}: {fwd_bwd:.3g} (gate 2^-21 of the terms' sum "
        f"{terms[0]:.6g}); the tangent's kernels bit-equal to its plain "
        f"interpreter")

    # -- (b) the fuzz backward programs at 2^24 lanes -------------------------
    worst = {True: 0.0, False: 0.0}
    for seed in TAPE_FUZZ_SEEDS:
        tr.clear_gradients()
        loss, xs, ieee = tape_fuzz(tr, seed, TAPE_FUZZ_N, dev)
        loss.eval()
        cot = tape.adjoint_program(loss)
        reached = [cot.get(x.index) for x in xs]  # None: no cotangent
        plain = iter(tr.plain_eval(*[c for c in reached if c is not None]))
        want = [None if c is None else next(plain) for c in reached]
        del cot, reached
        tr.backward(loss)
        for x, w in zip(xs, want):
            g = tr.gradient(x).torch()
            w = torch.zeros_like(g) if w is None else w
            u = trace_ulps(torch, g, w)
            worst[ieee] = max(worst[ieee], u)
            vjp_err = max(vjp_err, float((g - w).abs().nan_to_num().max()))
            check(u <= (0.0 if ieee else 1.0), f"phase 29 (b): fuzz{seed} "
                  f"{u} ulp from the plain interpreter")
        del loss, xs, want
    # digamma: its device function against torch.digamma in float64,
    # rounded once (the plain interpreter), on the card: float32 within an
    # ulp; float64 within 16 eps of the sum of its terms' magnitudes (the
    # card's torch.digamma adds the terms in another order, with FMAs, and
    # digamma has a root between every two negative integers)
    rng = np.random.default_rng(80)
    xs = np.concatenate([rng.uniform(-20.0, 40.0, TAPE_FUZZ_N - 8),
                         [0.0, -0.0, 1.0, 10.0, -3.0, 1e-8, 1e20, 1.4616]])
    scale = torch.from_numpy(digamma_terms(xs)).to(dev)
    dg = {}
    for dt in ("float32", "float64"):
        y = tape_digamma(tr, torch.from_numpy(xs).to(dev).to(
            getattr(torch, dt)))
        (w,) = tr.plain_eval(y)
        got = y.torch()
        dg[dt] = trace_ulps(torch, got, w)
        if dt == "float32":
            check(dg[dt] <= 1.0, f"phase 29 (b): digamma float32 {dg[dt]} "
                  "ulp from the plain interpreter (gate 1)")
        else:
            fin = torch.isfinite(w)
            check(torch.equal(fin, torch.isfinite(got)) and torch.equal(
                got[~fin].nan_to_num(), w[~fin].nan_to_num()),
                "phase 29 (b): digamma float64's non-finite lanes differ")
            rel = float(((got - w).abs()[fin] / (np.finfo(np.float64).eps
                                                 * scale[fin])).max())
            dg["terms"] = rel
            check(rel <= 16.0, f"phase 29 (b): digamma float64 {rel} eps of "
                  "its terms' sum from the plain interpreter (gate 16)")
        del y, w, got
    log(f"phase 29 (b) {len(TAPE_FUZZ_SEEDS)} fuzz backward programs at "
        f"{TAPE_FUZZ_N} lanes against the plain interpreter on the card: "
        f"IEEE-only max {worst[True]} ulp (gate 0), with transcendentals max "
        f"{worst[False]} ulp (gate 1); digamma (opcode 80) at {TAPE_FUZZ_N} "
        f"lanes in [-20, 40] and at its edges: float32 {dg['float32']} ulp "
        f"(gate 1), float64 {dg['terms']:.3g} eps of its terms' sum (gate "
        f"16; {dg['float64']} ulp of the value, near its roots)")

    # -- (d) a dispatch over TAPE_CALLS callees, its gradient -----------------
    grads_d, values = {}, {}
    for d in (dev, torch.device("cpu")):
        tr.clear_gradients()
        loss, x, v = tape_dispatch(tr, d)
        values[d.type] = v.torch()
        loss.eval()
        if d == dev:
            cot = tape.adjoint_program(loss)
            (want,) = tr.plain_eval(cot[x.index])
            del cot
        tr.backward(loss)
        grads_d[d.type] = tr.gradient(x).torch()
        del loss, x
    check(torch.equal(grads_d[dev.type], want), "phase 29 (d): the "
          "dispatch's adjoint kernels and its plain interpreter differ")
    check(torch.equal(grads_d[dev.type].cpu(), grads_d["cpu"]),
          "phase 29 (d): the dispatch's gradient on the card and the CPU "
          "differ")
    check(torch.equal(values[dev.type].cpu(), values["cpu"]),
          "phase 29 (d): registry_getter on the card and the CPU differ")
    log(f"phase 29 (d) registry_dispatch over {TAPE_CALLS} instances at "
        f"{TAPE_CALLS_N} lanes (one partition: a sort on the card, one read "
        f"of the instance list), its gradient bit-equal to the plain "
        f"interpreter's on the card and to the CPU's; registry_getter "
        f"bit-equal to the CPU's")

    # -- (f) times: the fit's programs alone ---------------------------------
    tr.clear_gradients()
    params = tape_params(tr, p, dev)
    loss = tape_fit_loss(tr, TAPE_N, params, target, dev)
    plan_f = tr.prepare(loss)
    inp_f = schedule_inputs(tr, torch, plan_f, dev)
    fwd_ms = timer(lambda: plan_f.run(*inp_f, dev), 20, hold_ms=300.0)
    loss.eval()
    cot = tape.adjoint_program(loss)
    vals = list(cot.values())
    del cot
    plan_b = tr.prepare(*vals)
    inp_b = schedule_inputs(tr, torch, plan_b, dev)
    bwd_ms = timed_ms("trace_vjp", lambda: plan_b.run(
        *inp_b, dev, counter="trace_vjp"), 20)
    bwd_plain = timer(lambda: tr.plain_eval(*vals), 3, hold_ms=300.0,
                      plain=True)
    bwd_bound, bwd_by, bwd_bytes, bwd_flops, _ = program_bound(plan_b,
                                                               inp_b[0])
    del vals
    t = tape.tangent_program(params[0], loss)
    plan_t = tr.prepare(t)
    inp_t = schedule_inputs(tr, torch, plan_t, dev)
    jvp_ms = timed_ms("trace_jvp", lambda: plan_t.run(
        *inp_t, dev, counter="trace_jvp"), 20)
    jvp_plain = timer(lambda: tr.plain_eval(t), 3, hold_ms=300.0, plain=True)
    jvp_bound, jvp_by, jvp_bytes, jvp_flops, _ = program_bound(plan_t,
                                                               inp_t[0])
    del t, loss, params
    tr.clear_tape()
    log(f"phase 29 (f) the fit at {TAPE_N}^2 on the card: forward program "
        f"{fwd_ms:.4f} ms ({len(plan_f.runs)} kernel(s)), adjoint "
        f"{bwd_ms:.4f} ms ({len(plan_b.runs)} kernel(s) and "
        f"{len(plan_b.steps) - len(plan_b.runs)} reductions between them; "
        f"plain interpreter {bwd_plain:.3f} ms; bound {bwd_bound:.5f} ms by "
        f"{bwd_by}: {bwd_bytes} B, {bwd_flops} FP32 operations), tangent "
        f"{jvp_ms:.4f} ms ({len(plan_t.runs)} kernel(s); plain "
        f"{jvp_plain:.3f} ms; bound {jvp_bound:.5f} ms by {jvp_by}); device "
        f"time, DeviceTimer, 20 calls; {smi}")

    # -- (e) the disk cache: a second process builds nothing -----------------
    from enoki_tpu_torch import _build
    from enoki_tpu_torch.config import config
    import shutil
    env = dict(os.environ,
               ENOKI_TPU_EXPORT_CACHE=config.trace_export_dir,
               ENOKI_TPU_COMPILE_CACHE=str(_build.BUILD_DIR
                                           / "tape_child_build"))
    shutil.rmtree(env["ENOKI_TPU_COMPILE_CACHE"], ignore_errors=True)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as C; "
         "C.tape_cache_child()"], env=env, capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(child.returncode == 0,
          f"phase 29 (e): the second process failed:\n{child.stderr[-3000:]}")
    got = child.stdout.strip().splitlines()[-1].split()[-3:]
    check([float.fromhex(v) for v in got] == g0, "phase 29 (e): the second "
          f"process's gradients {got} differ from step 1's {g0}")
    log(f"phase 29 (e) a second process ran the fit's step 1 from the disk "
        f"cache, nvcc refused: no build, the same gradients "
        f"({time.perf_counter() - t0:.1f} s)")
    tr.reset()
    common = dict(route="cuda",
                  source="enoki_tpu_torch/csrc/trace_kernel.cuh",
                  library_ms=None)
    return [dict(name="trace_vjp",
                 replaces="enoki_tpu/trace/__init__.py:1571",
                 launches=launches["trace_vjp"], max_abs_err=vjp_err,
                 ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound,
                 bound_by=bwd_by, fwd_ms=fwd_ms, **common),
            dict(name="trace_jvp",
                 replaces="enoki_tpu/trace/__init__.py:1680",
                 launches=launches["trace_jvp"], max_abs_err=jvp_err,
                 ms=jvp_ms, plain_ms=jvp_plain, bound_ms=jvp_bound,
                 bound_by=jvp_by, **common)]


# ---------------------------------------------------------------------------
# Phase 30: the lazy halves -- ops/, types/, struct/ and Vec3 over LazyArray,
# and the three lazy examples -- fused into the trace's kernels
# ---------------------------------------------------------------------------

LAZY_N = 1024                  # (a) and (c)'s image side
LAZY_HIST_N = 1 << 24          # (b): histogram.cpp's 16M samples, nothing cut
LAZY_HIST_SMALL = 1 << 20      # (b) against the CPU's plain interpreter
LAZY_FIT_STEPS = 10            # (c)
LAZY_SWEEP_N = 1 << 20         # lanes of (d) and (e)
LAZY_POOL = 16                 # nvcc processes the setup runs at once
# phase 20's eager mini-app, for (b)'s log: (wall ms an iteration, samples)
PHASE20_APP = {}

# (d)'s programs: (name, IEEE operations only?, [(function of the ops
# surface, impl or None, the domains of its operands)]): every function of
# tests/test_unified_surface.py:36-75 and its POLY_FNS (impl="poly"),
# grouped into programs of at most a few hundred trace ops; erfinv's Giles
# fit and each Carlson form and elliptic integral (duplication rounds) in
# programs of their own. Domains: P, S, U, G of the test at n lanes, or a
# function of them, scaled as the test scales them.
LAZY_GROUPS = [
    ("math", False, [
        ("math.sin", None, "S"), ("math.cos", None, "S"),
        ("math.tan", None, "U"), ("math.cot", None, "P"),
        ("math.asin", None, "U"), ("math.acos", None, "U"),
        ("math.atan", None, "S"), ("math.exp", None, "S"),
        ("math.exp2", None, "S"), ("math.log", None, "P"),
        ("math.log2", None, "P"), ("math.log1p", None, "P"),
        ("math.expm1", None, "S"), ("math.cbrt", None, "S"),
        ("math.sinh", None, "S"), ("math.cosh", None, "S"),
        ("math.tanh", None, "S"), ("math.csch", None, "P"),
        ("math.sech", None, "S"), ("math.coth", None, "P"),
        ("math.asinh", None, "S"), ("math.acosh", None, "G"),
        ("math.atanh", None, "U"), ("math.atan2", None, "S", "P"),
        ("math.pow", None, "P", "S"), ("safe_asin", None, "U"),
        ("safe_acos", None, "U")]),
    ("special", False, [
        ("special.erf", None, "S"), ("special.erfc", None, "S"),
        ("special.dawson", None, "S"), ("special.erfi", None, "U"),
        ("special.i0e", None, "S"), ("special.lgamma", None, "P"),
        ("special.tgamma", None, "P"), ("special.gamma", None, "P")]),
    ("erfinv", False, [("special.erfinv", None, "U")]),
    ("router", True, [
        ("sqrt", None, "P"), ("rsqrt", None, "P"), ("rcp", None, "P"),
        ("safe_sqrt", None, "S"), ("safe_rsqrt", None, "S"),
        ("abs_", None, "S"), ("sqr", None, "S"), ("sign", None, "S"),
        ("isnan", None, "S"), ("isinf", None, "S"), ("isfinite", None, "S"),
        ("floor", None, lambda d: d["S"] * 3),
        ("ceil", None, lambda d: d["S"] * 3),
        ("trunc", None, lambda d: d["S"] * 3),
        ("round_", None, lambda d: d["S"] * 3),
        ("round_half_away", None, lambda d: d["S"] * 3),
        ("reverse", None, "S"),
        ("math.fmod", None, "S", "P"), ("math.hypot", None, "S", "P"),
        ("copysign", None, "P", "S"), ("mulsign", None, "P", "S"),
        ("fmadd", None, "S", "P", "S"), ("fmsub", None, "S", "P", "S"),
        ("fnmadd", None, "S", "P", "S"), ("fnmsub", None, "S", "P", "S"),
        ("fmaddsub", None, "S", "P", "S"), ("fmsubadd", None, "S", "P", "S"),
        ("clamp", None, lambda d: d["S"] * 2, lambda d: d["S"] * 0 - 1,
         lambda d: d["S"] * 0 + 1),
        ("lerp", None, "S", "P", lambda d: d["U"] * 0.5 + 0.5)]),
    ("carlson_rc", True, [("special.carlson_rc", None, "P",
                           lambda d: d["P"] + 0.3)]),
    ("carlson_rf", True, [("special.carlson_rf", None, "P",
                           lambda d: d["P"] + 0.2, lambda d: d["P"] + 0.4)]),
    ("carlson_rd", True, [("special.carlson_rd", None, "P",
                           lambda d: d["P"] + 0.2, lambda d: d["P"] + 0.4)]),
    ("comp_ellint_1", True, [("special.comp_ellint_1", None,
                              lambda d: d["U"] * 0.6)]),
    ("comp_ellint_2", True, [("special.comp_ellint_2", None,
                              lambda d: d["U"] * 0.6)]),
    ("ellint_1", False, [("special.ellint_1", None, "S",
                          lambda d: d["U"] * 0.5)]),
    ("ellint_2", False, [("special.ellint_2", None, "S",
                          lambda d: d["U"] * 0.5)]),
    ("ellint_3", False, [("special.ellint_3", None, "S",
                          lambda d: d["U"] * 0.5, lambda d: d["U"] * 0.3)]),
    ("poly-trig", True, [(f"math.{f}", "poly", d) for f, d in (
        ("sin", lambda d: d["S"] * 100), ("cos", lambda d: d["S"] * 100),
        ("tan", lambda d: d["S"] * 30), ("asin", "U"), ("acos", "U"),
        ("atan", lambda d: d["S"] * 30))]),
    ("poly-exp-log", True, [(f"math.{f}", "poly", d) for f, d in (
        ("exp", lambda d: d["S"] * 30), ("exp2", lambda d: d["S"] * 30),
        ("log", "P"), ("log2", "P"), ("cbrt", lambda d: d["S"] * 1e4))] +
     [("math.atan2", "poly", "S", "P"), ("math.pow", "poly", "P", "S")]),
    ("poly-hyperbolic", True, [(f"math.{f}", "poly", d) for f, d in (
        ("sinh", lambda d: d["S"] * 30), ("cosh", lambda d: d["S"] * 30),
        ("tanh", lambda d: d["S"] * 5), ("asinh", lambda d: d["S"] * 1e3),
        ("acosh", lambda d: d["G"] * 100), ("atanh", "U"))]),
    ("poly-reciprocal", True, [(f"math.{f}", "poly", d) for f, d in (
        ("csc", "P"), ("sec", "S"), ("cot", "P"), ("csch", "P"),
        ("sech", "S"), ("coth", "P"))]),
]


def lazy_domains(n):
    """tests/test_unified_surface.py:29-32's domains at ``n`` lanes."""
    return {"P": np.linspace(0.05, 2.5, n).astype(np.float32),
            "S": np.linspace(-1.4, 1.4, n).astype(np.float32),
            "U": np.linspace(-0.97, 0.97, n).astype(np.float32),
            "G": np.linspace(1.05, 4.0, n).astype(np.float32)}


def lazy_domain(spec, doms):
    """An operand's float32 values: ``spec`` a base domain's letter, or a
    function of the domains."""
    return (doms[spec] if isinstance(spec, str) else spec(doms)).astype(
        np.float32)


def lazy_function(name):
    """The port's function ``name`` of the ops surface ("math.sin",
    "special.erf", "sqrt")."""
    from enoki_tpu_torch import ops
    mod, _, attr = name.rpartition(".")
    return getattr(getattr(ops, mod) if mod else ops, attr)


def lazy_group(tr, torch, group, doms, dev):
    """A (d) program: each member on fresh data leaves of its domains on
    ``dev``; returns the lazy outputs."""
    outs = []
    for name, impl, *specs in group[2]:
        args = [tr.LazyArray(torch.from_numpy(lazy_domain(s, doms)).to(dev))
                for s in specs]
        fn = lazy_function(name)
        outs.append(fn(*args, impl) if impl else fn(*args))
    return outs


def lazy_examples():
    """examples/lazy_{sphere,histogram,fit}_torch.py as modules."""
    import importlib.util
    import pathlib
    mods = []
    for name in ("lazy_sphere_torch", "lazy_histogram_torch",
                 "lazy_fit_torch"):
        path = pathlib.Path(__file__).resolve().parent / "examples" / \
            f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return mods


def lazy_hist_program(tr, torch, H, n, dev):
    """(b)'s probit values and their bin indices, clamped as the
    histogram clamps them (one program)."""
    g = H.probit(n, dev)
    idx = ((g - H.LO) * (H.BINS / (H.HI - H.LO))).cast(torch.int32)
    return g, tr.clamp(idx, 0, H.BINS - 1)


def lazy_fit_loss(tr, F, p, target, n, dev):
    """(c)'s loss as examples/lazy_fit_torch.py's ``fit`` records it."""
    params = [tr.requires_grad(tr.LazyArray(p[i:i + 1], device=dev))
              for i in range(3)]
    return F.loss_of(params, target, n, dev), params


def lazy_types_programs(tr, torch, n, dev):
    """(e)'s type programs over lazy lanes on ``dev``: {name: (outputs,
    the same function of tensors on ``dev``, gate, mag)}; the gates are
    phase 24's (``types_gate``)."""
    from enoki_tpu_torch.types import (Complex, Quaternion, color,
                                       complex_ as C, matrix_soa as S,
                                       morton_decode, morton_encode,
                                       quaternion as Q, sh)
    rng = np.random.default_rng(30)
    re = np.linspace(-2.0, 2.0, n).astype(np.float32)
    im = np.linspace(1.0, 3.0, n).astype(np.float32)
    comps = rng.normal(size=(4, n)).astype(np.float32)
    a = rng.normal(size=(4, 4, n)).astype(np.float32)
    a += 3.0 * np.eye(4, dtype=np.float32)[..., None]
    v = rng.normal(size=(3, n)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0)
    xy = rng.integers(0, 1 << 16, (2, n)).astype(np.uint32)
    lin = np.linspace(0.0, 1.0, n).astype(np.float32)
    cases = {}

    def both(name, fn, gate, *arrays, mag=None):
        lazy = fn(*[tr.LazyArray(torch.from_numpy(x).to(dev))
                    for x in arrays])
        eager = fn(*[torch.from_numpy(x).to(dev) for x in arrays])
        cases[name] = (lazy, eager, gate, mag)

    def cx(f):
        return lambda r, i: f(Complex(r, i))

    both("complex exp(log(z^2 + 1) / 2)", cx(
        lambda z: C.exp(C.log(z * z + 1.0) * 0.5)), "norm32", re, im)
    for name in ("sqrt", "rcp", "conj", "abs_"):
        both(f"complex.{name}", cx(getattr(C, name)), "exact", re, im)
    both("complex.arg", cx(C.arg), "ulp2", re, im)
    both("complex / 3.0", cx(lambda z: z / 3.0), "exact", re, im)
    for name in ("sin", "cos", "sinh", "cosh", "asin", "atan"):
        both(f"complex.{name}", cx(getattr(C, name)), "norm8", re, im)

    def qq(f):
        return lambda *c: f(Quaternion(*c))

    for name in ("normalize", "rcp", "conj", "sqrt"):
        both(f"quaternion.{name}", qq(getattr(Q, name)), "exact", *comps)
    both("quaternion.exp", qq(Q.exp), "norm8", *comps)
    both("quaternion.log(normalize)", qq(lambda q: Q.log(Q.normalize(q))),
         "norm8", *comps)
    def to_soa(m):
        return m if isinstance(m, tuple) else S.from_dense(m)

    both("quaternion.to_matrix(normalize)", qq(
        lambda q: to_soa(Q.to_matrix(Q.normalize(q)))), "exact", *comps)

    def soa(f):
        return lambda *e: f(tuple(tuple(e[4 * i + j] for j in range(4))
                                  for i in range(4)))

    both("matrix_soa inverse, det, m @ inverse(m) 4x4", soa(
        lambda m: (S.inverse(m), S.det(m), S.matmul(m, S.inverse(m)))),
        "exact", *a.reshape(16, n))
    both("sh_eval 4", lambda x, y, z: sh.sh_eval(x, y, z, 4), "exact", *v)
    both("morton_encode, morton_decode 2-D", lambda x, y: (
        morton_encode([x, y]), morton_decode(morton_encode([x, y]), 2)),
        "exact", *xy)
    both("color.linear_to_srgb, srgb_to_linear", lambda x: (
        color.linear_to_srgb(x), color.srgb_to_linear(x)), "norm16", lin,
        mag=1.0)
    return cases


def lazy_pcg_programs(tr, torch, n, dev):
    """(e)'s PCG32 programs: {name: (lazy outputs, eager outputs)}, each
    lazy output bit-exact with the eager generator's on the card."""
    from enoki_tpu_torch.types.random import PCG32
    out = {}
    gl, ge = PCG32.create_lazy(n, device=dev), PCG32.create(n, device=dev)
    ul, gl = gl.next_uint32()
    ue, ge = ge.next_uint32()
    fl, gl = gl.next_float32()
    fe, ge = ge.next_float32()
    wl, gl = gl.next_uint64()
    we, ge = ge.next_uint64()
    out["next_uint32, next_float32, next_uint64"] = (
        [ul, fl, wl.hi, wl.lo], [ue, fe, we.hi, we.lo])
    for delta in (100, -100, 12345678901234, 1 << 63):
        gl = PCG32.create_lazy(n, device=dev).advance(delta)
        ge = PCG32.create(n, device=dev).advance(delta)
        ul, _ = gl.next_uint32()
        ue, _ = ge.next_uint32()
        out[f"advance({delta})"] = ([gl.state.hi, gl.state.lo, ul],
                                    [ge.state.hi, ge.state.lo, ue])
    return out


def lazy_struct_program(tr, torch, n, device):
    """(e)'s struct program on ``device``: the struct helpers and a
    struct-argument dispatch (trace.call) over a Ray of lazy Vec3s;
    returns the lazy leaves, evaluated by the caller."""
    import enoki_tpu_torch.trace.call as tc
    from torch.utils import _pytree as pytree
    from enoki_tpu_torch.render.vec import Vec3
    from enoki_tpu_torch.struct import (concat_structs, gather_struct,
                                        scatter_struct, select_struct,
                                        zeros_like)
    rng = np.random.default_rng(31)

    def leaf(x):
        return tr.LazyArray(torch.from_numpy(x).to(device))

    o = Vec3(*(leaf(rng.normal(size=n).astype(np.float32))
               for _ in range(3)))
    d = Vec3(*(leaf(rng.normal(size=n).astype(np.float32))
               for _ in range(3)))
    idx = leaf(rng.integers(0, n, n).astype(np.int32))
    mask = leaf(rng.random(n) < 0.5)
    g = gather_struct(o, idx, mask=mask)
    s = select_struct(mask, o, d)
    dst = zeros_like(o)
    scatter_struct(dst, d, leaf(np.arange(n, dtype=np.int32)[::-1].copy()))
    c = concat_structs({"v": o.x}, {"v": d.y})

    def f0(m, v, w):
        return Vec3(v.x * w, v.y + w, v.z - w)

    def f1(m, v, w):
        return Vec3(v.z, v.x * 2.0, v.y * w)

    ids = leaf(rng.integers(0, 2, n).astype(np.int32))
    r = tc.dispatch([f0, f1], ids, o, d.x)
    return pytree.tree_leaves((g, s, dst, c, r))


def lazy_structures(torch, tr, dev, pool, S, H, F):
    """Setup of phase 30: every structure it evaluates, traced and
    prepared in this thread, their sources built with nvcc in ``pool`` at
    once; (c)'s adjoint program in a second round (a program is recorded
    on the tape when it runs). Returns {source text: build seconds}."""
    from enoki_tpu_torch.trace import tape
    from torch.utils import _pytree as pytree
    plans = {}
    doms = lazy_domains(LAZY_SWEEP_N)
    tr.reset()
    plans["sphere"] = tr.prepare(S.render_lazy(LAZY_N, device=dev))
    plans["sphere struct"] = tr.prepare(S.render_lazy_struct(LAZY_N,
                                                             device=dev))
    for n in (LAZY_HIST_N, LAZY_HIST_SMALL):
        plans[f"probit {n}"] = tr.prepare(*lazy_hist_program(tr, torch, H,
                                                             n, dev))
    for group in LAZY_GROUPS:
        plans[group[0]] = tr.prepare(*lazy_group(tr, torch, group, doms,
                                                 dev))
    for name, (lazy, _) in lazy_pcg_programs(tr, torch, LAZY_SWEEP_N,
                                             dev).items():
        plans[name] = tr.prepare(*lazy)
    for name, (lazy, _, _, _) in lazy_types_programs(
            tr, torch, LAZY_SWEEP_N, dev).items():
        plans[name] = tr.prepare(*[x for x in pytree.tree_leaves(lazy)
                                   if x.__class__ is tr.LazyArray])
    target_lazy = F.render(*(tr.LazyArray.full(v, 1, device=dev)
                             for v in F.TRUE), LAZY_N, dev)
    plans["fit target"] = tr.prepare(target_lazy)
    del target_lazy
    target = tr.LazyArray(torch.zeros(LAZY_N * LAZY_N, device=dev))
    loss, _ = lazy_fit_loss(tr, F, np.array(F.INIT, np.float32), target,
                            LAZY_N, dev)
    plans["fit loss"] = tr.prepare(loss)
    # last, each followed by a reset: a pending scatter joins every later
    # schedule
    plans["struct"] = tr.prepare(*lazy_struct_program(tr, torch,
                                                      LAZY_SWEEP_N, dev))
    tr.reset()
    for n in (LAZY_HIST_N, LAZY_HIST_SMALL):
        plans[f"histogram {n}"] = tr.prepare(H.histogram(n, dev))
        tr.reset()
    seconds = build_trace_plans(plans, pool)
    # the second round: the fit's adjoint, recorded by its forward's eval
    target = tr.LazyArray(torch.zeros(LAZY_N * LAZY_N, device=dev))
    loss, _ = lazy_fit_loss(tr, F, np.array(F.INIT, np.float32), target,
                            LAZY_N, dev)
    loss.eval()
    cot = tape.adjoint_program(loss)
    second = {"fit adjoint": tr.prepare(*cot.values())}
    del cot, loss
    seconds.update(build_trace_plans(second, pool))
    plans.update(second)
    for plan in plans.values():
        plan.library()
    tr.reset()
    return plans, seconds


def run_lazy_alone(torch):
    """Phase 30 alone on the card; prints its fields of the trace's rows."""
    log(nvidia_smi("name,power.limit"))
    out = run_lazy(torch, torch.device("cuda"), DeviceTimer(torch))
    print(json.dumps(out))


def run_lazy(torch, dev, timer):
    """Phase 30: the lazy halves at full width on the card, every lazy
    program one eval through the trace's fused kernels, held to the plain
    interpreter on the card, to the port's eager route and to the CPU.
    Returns, by counter name ("trace", "trace_vjp"), the launches of the
    trace's kernels it made and the times of one of its programs
    (``lazy_times``), as phase30_* fields of that kernel's row."""
    import enoki_tpu_torch.trace as tr
    from enoki_tpu_torch.render import LAUNCHES
    from enoki_tpu_torch.trace import codegen
    S, H, F = lazy_examples()
    t_phase = time.perf_counter()
    before = {k: LAUNCHES[k] for k in ("trace", "trace_vjp")}
    with concurrent.futures.ThreadPoolExecutor(LAZY_POOL) as pool:
        plans, build_s = lazy_structures(torch, tr, dev, pool, S, H, F)
    t_setup = time.perf_counter() - t_phase
    log(f"phase 30 setup: {len(plans)} structures, {len(build_s)} sources "
        f"built with nvcc at once in {t_setup:.1f} s (the longest "
        f"{max(build_s.values()):.1f} s)")
    nvcc = [0]
    real = codegen._nvcc_build

    def counted(text):
        # a source the setup did not build (a library of one it did is
        # loaded again under this build function: _LIBS keys on it)
        nvcc[0] += text not in build_s
        return real(text)

    codegen._nvcc_build = counted
    try:
        _lazy_phase(torch, tr, dev, plans, nvcc, S, H, F)
    finally:
        codegen._nvcc_build = real
    launches = {k: LAUNCHES[k] - v for k, v in before.items()}
    check(launches["trace"] > 0 and launches["trace_vjp"] > 0,
          f"phase 30: the trace's kernels were not launched: {launches}")
    times = lazy_times(torch, tr, dev, timer, plans, S, F)
    log(f"phase 30 launches of the trace's kernels: {launches}; sources "
        f"built after the setup: {nvcc[0]}; phase 30 took "
        f"{time.perf_counter() - t_phase:.1f} s "
        f"({nvidia_smi('name,power.limit')})")
    return {k: dict(phase30_launches=v, **times[k])
            for k, v in launches.items()}


def lazy_times(torch, tr, dev, timer, plans, S, F):
    """Phase 30's own measured fields of the trace's rows, after its
    launches are counted: (a)'s lazy sphere at LAZY_N^2 for ``trace`` and
    (c)'s adjoint at the initial guess for ``trace_vjp``, each its kernels'
    device time, its plain interpreter's on the card, its bound and its
    largest |kernels - plain|. The structures are the setup's."""
    from enoki_tpu_torch.trace import tape
    smi = nvidia_smi("name,power.limit")
    out = {}
    tr.reset()
    img = S.render_lazy(LAZY_N, device=dev)
    target = F.target_image(LAZY_N, dev)
    tr.clear_gradients()
    loss, _ = lazy_fit_loss(tr, F, np.array(F.INIT, np.float32), target,
                            LAZY_N, dev)
    loss.eval()
    cot = tape.adjoint_program(loss)
    vals = list(cot.values())
    del cot, loss
    for name, arrays, key in (("trace", [img], "sphere"),
                              ("trace_vjp", vals, "fit adjoint")):
        plan = tr.prepare(*arrays)
        check(plan.key == plans[key].key, f"phase 30 times: {key} is not "
              "the structure the setup built")
        inp = schedule_inputs(tr, torch, plan, dev)
        got = plan.run(*inp, dev, counter=name)
        got = got if isinstance(got, (list, tuple)) else [got]
        want = tr.plain_eval(*arrays)
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        ms = timer(lambda: plan.run(*inp, dev, counter=name), 20,
                   hold_ms=300.0)
        plain_ms = timer(lambda: tr.plain_eval(*arrays), 3, hold_ms=300.0,
                         plain=True)
        bound_ms, bound_by, nbytes, flops, _ = program_bound(plan, inp[0])
        out[name] = dict(phase30_program=key, phase30_ms=ms,
                         phase30_plain_ms=plain_ms,
                         phase30_bound_ms=bound_ms,
                         phase30_bound_by=bound_by,
                         phase30_max_abs_err=err)
        log(f"phase 30 times, {key} at {LAZY_N}^2: kernels {ms:.4f} ms "
            f"({len(plan.runs)} kernel(s)), plain interpreter "
            f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by} "
            f"({nbytes} B, {flops} FP32 operations), max |kernels - plain| "
            f"{err:.3g}; device time, DeviceTimer, 20 calls; {smi}")
    del img, vals, target
    tr.clear_tape()
    tr.reset()
    return out


def _ulp1(torch, got, want, ieee, what):
    u = trace_ulps(torch, got, want)
    check(u == 0.0 if ieee else u <= 1.0, f"{what}: the kernels and the "
          f"plain interpreter differ by {u} ulp (gate "
          f"{'bit-equal' if ieee else '1 ulp'})")
    return u


def _lazy_phase(torch, tr, dev, plans, nvcc, S, H, F):
    from enoki_tpu_torch.render import LAUNCHES
    from enoki_tpu_torch.trace import tape
    smi = nvidia_smi("name,power.limit")

    def one_eval(*arrays):
        n0 = tr.stats()["n_evals"]
        tr.eval(*arrays)
        torch.cuda.synchronize()
        check(tr.stats()["n_evals"] == n0 + 1,
              "phase 30: a lazy program took more than one eval")
        return [a.torch() for a in arrays]

    # -- (a) the lazy sphere --------------------------------------------------
    img = S.render_lazy(LAZY_N, device=dev)
    (want,) = tr.plain_eval(img)
    (got,) = one_eval(img)
    check(torch.equal(got, want), "phase 30 (a): render_lazy's kernels and "
          "its plain interpreter differ")
    img_s = S.render_lazy_struct(LAZY_N, device=dev)
    (want_s,) = tr.plain_eval(img_s)
    (got_s,) = one_eval(img_s)
    check(torch.equal(got_s, want_s), "phase 30 (a): render_lazy_struct's "
          "kernels and its plain interpreter differ")
    check(bool(torch.allclose(got_s, got, rtol=1e-5, atol=1e-5)),
          "phase 30 (a): the struct form and the scalar form differ")
    from enoki_tpu_torch.render import SphereScene, render_fused
    ref = render_fused(SphereScene.reference(dev), LAZY_N).reshape(-1)
    fused_err = float((got - ref).abs().max())
    misses, calls = tr.cache_stats()[1], nvcc[0]
    t0 = time.perf_counter()
    (second,) = one_eval(S.render_lazy(LAZY_N, cx=0.05, device=dev))
    second_ms = 1e3 * (time.perf_counter() - t0)
    check(tr.cache_stats()[1] == misses and nvcc[0] == calls,
          "phase 30 (a): the second frame (cx = 0.05) missed the cache")
    check(not torch.equal(second, got), "phase 30 (a): the second frame is "
          "the first")
    log(f"phase 30 (a) render_lazy and render_lazy_struct at {LAZY_N}^2: "
        f"one eval each, bit-equal to the plain interpreter on the card; "
        f"struct against scalar max |d| "
        f"{float((got_s - got).abs().max()):.3g} (rtol 1e-5, atol 1e-5); "
        f"max |err| against render_fused {fused_err:.3g}; the second frame "
        f"(cx = 0.05) a cache hit, no nvcc, {second_ms:.2f} ms wall: pass")
    del img, img_s, got, want, got_s, want_s, second, ref

    # -- (b) the lazy histogram -----------------------------------------------
    def moved(g_a, i_a, g_b, i_b, what):
        """The samples whose bin differs between two routes; each must be
        within 1 ulp of a bin edge: its probit values on the two routes
        at most 1 ulp apart."""
        m = i_a != i_b
        k = int(m.sum())
        if k:
            ga, gb = g_a[m].double(), g_b.to(g_a.device)[m].double()
            sp = torch.abs(torch.nextafter(
                g_a[m], torch.full_like(g_a[m], float("inf"))).double() - ga)
            check(bool(((ga - gb).abs() <= sp).all()), f"phase 30 (b) {what}:"
                  " a sample changed bins without being within 1 ulp of an"
                  " edge")
        return k

    def binned(i):
        return torch.bincount(i.long(), minlength=H.BINS).to(torch.float32)

    tr.reset()
    n = LAZY_HIST_N
    hist = H.histogram(n, dev)
    (want_h,) = tr.plain_eval(hist)
    (got_h,) = one_eval(hist)
    check(float(got_h.sum()) == n, f"phase 30 (b): the counts sum to "
          f"{float(got_h.sum())}, not {n}")
    g_k, i_k = lazy_hist_program(tr, torch, H, n, dev)
    gp, ip = tr.plain_eval(g_k, i_k)
    g_k, i_k = one_eval(g_k, i_k)
    check(torch.equal(got_h, binned(i_k)) and torch.equal(want_h, binned(ip)),
          "phase 30 (b): a histogram and its own bin indices disagree")
    k_plain = moved(g_k, i_k, gp, ip, "kernel against plain")
    # both routes take libdevice's float64 log, so no sample moves at all
    check(k_plain == 0, f"phase 30 (b): {k_plain} samples changed bins "
          "between the kernel and the plain interpreter on the card")
    del hist, gp, ip
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H.histogram(n, dev).torch()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = min(walls)
    ns = LAZY_HIST_SMALL
    h_small = H.histogram(ns, dev).torch()
    g_s, i_s = lazy_hist_program(tr, torch, H, ns, dev)
    g_s, i_s = one_eval(g_s, i_s)
    h_cpu = H.histogram(ns, "cpu").torch()
    g_c, i_c = lazy_hist_program(tr, torch, H, ns, "cpu")
    tr.eval(g_c, i_c)
    g_c, i_c = g_c.torch(), i_c.torch()
    check(torch.equal(h_small.cpu(), binned(i_s).cpu())
          and torch.equal(h_cpu, binned(i_c)),
          "phase 30 (b): a histogram at 2^20 and its bin indices disagree")
    k_cpu = moved(g_s.cpu(), i_s.cpu(), g_c, i_c, "card against the CPU")
    app = PHASE20_APP.get("wall_ms")
    app_text = (f"phase 20's eager mini-app (64 bins, the hist kernel) "
                f"{app:.4f} ms an iteration = "
                f"{PHASE20_APP['n'] / (app * 1e-3) / 1e9:.3f} G samples/s"
                if app else "phase 20 did not run in this process")
    log(f"phase 30 (b) lazy histogram of {n} samples (PCG32 -> erfinv -> "
        f"clamp -> scatter_add) into {H.BINS} bins: one eval, counts sum "
        f"to {n}; against the plain interpreter on the card, {k_plain} "
        f"samples within 1 ulp of a bin edge changed bins, every other "
        f"count equal; at {ns} against the CPU's plain interpreter, "
        f"{k_cpu} such samples: pass; one eval {wall:.3f} ms wall (best of "
        f"3: {', '.join(f'{w:.3f}' for w in walls)}) = "
        f"{n / (wall * 1e-3) / 1e9:.3f} G samples/s, beside {app_text}; "
        f"{smi}")
    del g_k, i_k, got_h, want_h, h_small, g_s, i_s, h_cpu, g_c, i_c

    # -- (c) examples/lazy_fit_torch.py ---------------------------------------
    tr.reset()
    at_step1 = {}
    worst = [0.0]

    def hook(k, loss, params):
        cot = tape.adjoint_program(loss)
        want = tr.plain_eval(*[cot[q.index] for q in params])
        del cot

        def after(grads):
            for g, w in zip(grads, want):
                worst[0] = max(worst[0], float((g - w).abs().max()))
                check(torch.equal(g, w), f"phase 30 (c) step {k}: the "
                      "gradients' kernels and plain interpreter differ")
            if k == 0:  # what step 1 built and missed
                at_step1.update(misses=tr.cache_stats()[1], nvcc=nvcc[0])
        return after

    out = F.fit(LAZY_N, LAZY_FIT_STEPS, dev, hook=hook)
    losses = out["losses"]
    check(losses[-1] < losses[0] * 0.2, f"phase 30 (c): the loss did not "
          f"fall below 0.2 of the first: {losses[0]:.6g} -> {losses[-1]:.6g}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"phase 30 (c): the loss rose at a step: {losses}")
    check(out["misses"] <= 6, f"phase 30 (c): {out['misses']} cache misses")
    check(out["misses"] == at_step1["misses"] and nvcc[0] == at_step1["nvcc"],
          "phase 30 (c): a step after the first built or missed")
    tr.reset()
    t0 = time.perf_counter()
    timed = F.fit(LAZY_N, LAZY_FIT_STEPS, dev)
    fit_ms = 1e3 * (time.perf_counter() - t0) / LAZY_FIT_STEPS
    check(timed["losses"] == losses, "phase 30 (c): a second fit differs")
    p = out["params"]
    log(f"phase 30 (c) examples/lazy_fit_torch.py at {LAZY_N}^2, "
        f"{LAZY_FIT_STEPS} steps: loss {losses[0]:.6g} -> {losses[-1]:.6g} "
        f"(below 0.2 of the first, falling at every step: "
        f"{', '.join(f'{v:.6g}' for v in losses)}), {out['misses']} cache "
        f"misses (at most "
        f"6), steps 2-{LAZY_FIT_STEPS} no miss and no nvcc; every step's "
        f"gradients bit-equal to the plain interpreter's on the card; "
        f"(cx, cy, r) ({p[0]:+.4f}, {p[1]:+.4f}, {p[2]:.4f}), true "
        f"{F.TRUE}: pass; {fit_ms:.2f} ms wall a step (forward eval, "
        f"backward, the host loop; a second fit, all cache hits; step "
        f"walls {[round(f + b, 2) for f, b in timed['walls_ms']]} ms); "
        f"{smi}")
    tr.reset()

    # -- (d) the unified surface ----------------------------------------------
    doms = lazy_domains(LAZY_SWEEP_N)
    worst_k = {True: 0.0, False: 0.0}
    worst_e = {"native": 0.0, "poly": 0.0}
    texts = []
    for group in LAZY_GROUPS:
        name, ieee, members = group
        outs = lazy_group(tr, torch, group, doms, dev)
        plan = plans[name]
        wants = tr.plain_eval(*outs)
        before = LAUNCHES["trace"]
        gots = one_eval(*outs)
        launched = LAUNCHES["trace"] - before
        check(launched == len(plan.runs), f"phase 30 (d) {name}: "
              f"{launched} launches for {len(plan.runs)} fused runs")
        for (fname, impl, *specs), got, want in zip(members, gots, wants):
            what = f"phase 30 (d) {fname}" + (f" {impl}" if impl else "")
            worst_k[ieee] = max(worst_k[ieee],
                                _ulp1(torch, got, want, ieee, what))
            fn = lazy_function(fname)
            args = [torch.from_numpy(lazy_domain(s, doms)).to(dev)
                    for s in specs]
            eager = fn(*args, impl) if impl else fn(*args)
            check(got.dtype == eager.dtype and got.shape == eager.shape,
                  f"{what}: lazy {got.dtype} {tuple(got.shape)} against "
                  f"eager {eager.dtype} {tuple(eager.shape)}")
            if not got.dtype.is_floating_point:
                check(torch.equal(got, eager), f"{what}: lazy and eager "
                      "differ")
                continue
            rtol, atol = (1e-6, 1e-30) if impl == "poly" else (3e-5, 2e-6)
            check(bool(torch.allclose(got, eager, rtol=rtol, atol=atol,
                                      equal_nan=True)),
                  f"{what}: lazy and eager on the card beyond rtol {rtol}, "
                  f"atol {atol}")
            fin = torch.isfinite(eager)
            rel = ((got[fin].double() - eager[fin].double()).abs()
                   / (eager[fin].double().abs() + atol)).max()
            key = "poly" if impl == "poly" else "native"
            worst_e[key] = max(worst_e[key], float(rel))
        texts.append(f"{name} {len(members)} fn / {len(plan.entries)} ops / "
                     f"{len(plan.runs)} kernel(s)")
        del outs, gots, wants
    log(f"phase 30 (d) the unified surface at {LAZY_SWEEP_N} lanes, "
        f"{sum(len(g[2]) for g in LAZY_GROUPS)} functions in "
        f"{len(LAZY_GROUPS)} programs ({'; '.join(texts)}): kernels against "
        f"the plain interpreter on the card, IEEE-only programs max "
        f"{worst_k[True]} ulp (bit-equal), with transcendentals max "
        f"{worst_k[False]} ulp (gate 1); lazy against the port's eager on "
        f"the card, max relative {worst_e['native']:.3g} native (rtol 3e-5, "
        f"atol 2e-6), {worst_e['poly']:.3g} poly (rtol 1e-6): pass")
    tr.reset()

    # -- (e) types and structs ------------------------------------------------
    for name, (lazy, eager) in lazy_pcg_programs(tr, torch, LAZY_SWEEP_N,
                                                  dev).items():
        got = one_eval(*lazy)
        for g, e in zip(got, eager):
            same = (torch.equal(g, e) if g.dtype == e.dtype
                    else torch.equal(g.to(torch.int64), e.to(torch.int64)))
            check(same, f"phase 30 (e) PCG32 {name}: lazy and eager differ")
    tr.reset()
    from torch.utils import _pytree as pytree
    worst_t = {}
    for name, (lazy, eager, gate, mag) in lazy_types_programs(
            tr, torch, LAZY_SWEEP_N, dev).items():
        leaves, spec = pytree.tree_flatten(lazy)
        lz = [x for x in leaves if x.__class__ is tr.LazyArray]
        vals = iter(one_eval(*lz))
        got = pytree.tree_unflatten(
            [next(vals) if x.__class__ is tr.LazyArray else x
             for x in leaves], spec)
        ok, err = types_gate(torch, flat_result(torch, got),
                             flat_result(torch, eager), gate, mag)
        worst_t[name] = err
        check(ok, f"phase 30 (e) {name}: lazy against eager on the card "
              f"beyond the {gate} gate ({err})")
    tr.reset()
    lz_card = lazy_struct_program(tr, torch, LAZY_SWEEP_N, dev)
    tr.eval(*lz_card)
    st_card = [v.torch().cpu() for v in lz_card]
    del lz_card
    tr.reset()
    lz_cpu = lazy_struct_program(tr, torch, LAZY_SWEEP_N, "cpu")
    tr.eval(*lz_cpu)
    st_cpu = [v.torch() for v in lz_cpu]
    check(len(st_card) == len(st_cpu) and all(
        torch.equal(a, b) for a, b in zip(st_card, st_cpu)),
        "phase 30 (e): the struct helpers and dispatch on the card and the "
        "CPU differ")
    tr.reset()
    log(f"phase 30 (e) at {LAZY_SWEEP_N} lanes: lazy PCG32 (next_uint32, "
        f"next_float32, next_uint64; advance by 100, -100, 12345678901234, "
        f"2^63, then a draw) bit-exact against the eager PCG32 on the card; "
        f"Complex, Quaternion, matrix_soa, sh, morton and color against "
        f"their eager selves on the card under phase 24's gates ("
        + ", ".join(f"{k} {v:.3g}" for k, v in worst_t.items())
        + f"); gather_struct, select_struct, scatter_struct, concat_structs"
        f" and a struct-argument trace.call.dispatch bit-equal to the CPU: "
        f"pass")


# ---------------------------------------------------------------------------
# Phase 31: runtime.kernel_printf in a scene's generic_fwd
# ---------------------------------------------------------------------------


def printing_scene():
    """(render, sdf_fn, ray_fn, parameters) of examples/composed_torch.py's
    12-parameter scene with runtime.kernel_printf on a parameter and the
    distance in sdf_fn and on the ray's origin in ray_fn (the orthographic
    camera)."""
    import importlib.util
    import pathlib
    from enoki_tpu_torch.render import generic as G
    from enoki_tpu_torch.runtime import kernel_printf
    path = pathlib.Path(__file__).resolve().parent / "examples" / \
        "composed_torch.py"
    spec = importlib.util.spec_from_file_location("composed_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    def sdf_fn(p, pv):
        d = example.scene_sdf(p, pv)
        kernel_printf("sdf radius={} d={}", pv[8], d)
        return d

    def ray_fn(px, py, pv):
        o, d = G.ortho_camera(px, py, pv)
        kernel_printf("ray o=({}, {}, {})", o.x, o.y, o.z)
        return o, d

    render, _ = G.make_sdf_renderer(sdf_fn, 12, ray_fn=ray_fn)
    return render, sdf_fn, ray_fn, example.PARAMS


def printing_plain(torch, dev, scene, n, steps):
    """Phase 31's plain half on ``dev``: (the lines the plain route prints
    from the host, the distance evaluations of the kernel's thread of
    pixel (0, 0), the plain version's ts)."""
    import io
    from enoki_tpu_torch.render import generic as G
    _, sdf_fn, ray_fn, params = scene
    p = torch.from_numpy(params).to(dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, ts = G.generic_fwd_plain(sdf_fn, ray_fn, p, n, steps, EXTENT)
        evals = int(G.generic_march_counts(sdf_fn, ray_fn, p, n, steps,
                                           EXTENT)[0, 0])
    return buf.getvalue().splitlines(), evals, ts


def prints_follow(kernel, plain, evals, steps):
    """The gate of phase 31: the kernel's lines are a prefix of the plain
    route's, one from the ray and one an evaluation of the march's thread
    of pixel (0, 0); the plain march's lines after them (a frozen lane
    evaluates its last t again) all equal its last."""
    k = len(kernel)
    return (len(plain) == 1 + steps and k == 1 + evals
            and kernel == plain[:k]
            and all(line == plain[-1] for line in plain[k:]))


def capture_fd1(torch, fn):
    """(fn(), what the process wrote to its C stdout, fd 1, while fn ran:
    a kernel's device printf, which the CUDA runtime writes there at a
    synchronisation). Python's stdout is flushed before and restored
    after, so that no line of this script goes into the capture."""
    import ctypes
    import tempfile
    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    libc.fflush(None)
    saved = os.dup(1)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        try:
            out = fn()
            torch.cuda.synchronize()
            libc.fflush(None)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return out, f.read().decode()


def run_kernel_printf_alone(torch):
    """Phase 31 alone on the card: the printing scene built, then run."""
    scene = printing_scene()
    t0 = time.perf_counter()
    scene[0].kernels.lib
    run_kernel_printf(torch, torch.device("cuda"), scene,
                      time.perf_counter() - t0)


def run_kernel_printf(torch, dev, scene, build_s):
    """Phase 31: the composed scene with kernel_printf (printing_scene) at
    N^2, STEPS steps, plain configuration, at its reference parameters:
    generic_fwd's printed lines (fd 1) against the plain route's on the
    card (prints_follow), the kernel's ts bit-equal to the plain
    version's."""
    from enoki_tpu_torch.render import LAUNCHES, generic as G
    t0 = time.perf_counter()
    render, _, _, params = scene
    plain, evals, ts_p = printing_plain(torch, dev, scene, N, STEPS)
    p = torch.from_numpy(params).to(dev)
    before = LAUNCHES["generic_fwd"]
    (_, ts_k), text = capture_fd1(
        torch, lambda: G.generic_fwd(render.kernels, p, N, STEPS, EXTENT))
    kernel = text.splitlines()
    launched = LAUNCHES["generic_fwd"] - before
    same_ts = torch.equal(ts_k.view(torch.int32), ts_p.view(torch.int32))
    ok = launched == 1 and same_ts and prints_follow(kernel, plain, evals,
                                                     STEPS)
    log(f"phase 31 kernel_printf in the composed scene at {N}^2, {STEPS} "
        f"steps: generic_fwd printed {len(kernel)} lines (1 from user_ray, "
        f"{len(kernel) - 1} from user_sdf: pixel (0, 0) evaluates the "
        f"distance {evals} times), the plain route {len(plain)}; the "
        f"kernel's lines a prefix of the plain route's, text-equal, the "
        f"rest equal to its last; ts bit-equal to the plain version's; "
        f"the scene built in {build_s:.2f} s (trace + nvcc, in the setup's "
        f"pool); phase 31 took {time.perf_counter() - t0:.2f} s: "
        f"{'pass' if ok else 'FAIL'}")
    for line in kernel:
        log(f"phase 31 kernel line: {line}")
    check(ok, f"phase 31: generic_fwd's prints {kernel!r} against the plain "
          f"route's {plain!r} (launches {launched}, ts bit-equal {same_ts})")


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed phase or gate ends the check
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
