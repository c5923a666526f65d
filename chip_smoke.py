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
and 64 steps.

  setup    build the kernels from enoki_tpu_torch/csrc with nvcc, one
           process per source, all at once
  phase 1  sdf_fwd against sdf_fwd_plain, reference + two seeded scenes
  phase 2  sdf_bwd against sdf_bwd_plain on the same ts and a seeded g;
           two runs must be bitwise equal
  phase 3  the main path: SDFRender trained for a few SGD steps, each
           step's loss and gradient against the plain PyTorch render
           (render.sdf, the twin of the reference's jnp path); the launch
           counters must show one sdf_fwd and one sdf_bwd (+ reduce) per
           step
  phase 4  timing with CUDA events: a data-chained fwd+bwd loop (as
           bench.py chains its steps) against the same loop through the
           twin, each kernel alone, the plain versions, and each kernel's
           bound
  phase 5  sphere_fwd (f32 and bf16) against sphere_fwd_plain, reference +
           two seeded scenes
  phase 6  sphere_bwd against sphere_bwd_plain for a seeded g; two runs
           must be bitwise equal
  phase 7  the sphere path: SphereRender trained for a few SGD steps in
           f32, each step's loss and gradient against the plain twin
           (render.sphere, autograd through combined), then one bf16 step,
           whose gradient must equal the f32 step's at the same
           parameters; one sphere_fwd and one sphere_bwd (+ reduce) per
           step
  phase 8  timing: each sphere kernel alone with its bound and its plain
           version, the chained fwd+bwd loop through SphereRender against
           the twin's, and the mini-app's contrast, render_staged
           (separate kernels) against one sphere_fwd launch
  phase 9  each further sdf_fwd instantiation (start map, bf16 march,
           over-relaxed march, and their combinations) against
           sdf_fwd_plain: bit-equality is the aim, a differing pixel count
           is printed and gated as phase 1 gates flips; bands=8 bit-equal
           to bands=1; the start map conservative against the closed-form
           hit distance
  phase 10 the split render for (split, coarse) in (16,0), (32,0), (16,8):
           image and ts bit-equal to the one-pass kernel's, the survivors'
           share, pass 1 and the tail against their plain versions
  phase 11 sdf_bwd_ad against sdf_bwd_ad_plain and against sdf_bwd, mixed
           and all-miss scene; two runs must be bitwise equal
  phase 12 the options' path: SDFRender(coarse=8) trained for a few SGD
           steps on each scene against the plain twin under the
           head-start gates, then one fwd+bwd step for each other option
           at the reference scene, each counted; timing of
           each new kernel alone with its bound and plain version, of the
           cone prepass, and of the chained fwd+bwd step for the five
           candidate configurations of bench.py:233-235, interleaved

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
# MUFU (rsqrt) results per clock per SM on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput): a
# second, tighter floor for the march, printed beside the bound
MUFU_PER_CLK_PER_SM = 16

# FP32 operations of the kernels (csrc/sdf_render.cu), each add, mul,
# compare, max and rsqrt counted once
FWD_FLOPS_PER_EVAL = 7     # z*z, +rxy2, rsqrt, x*r; s >= s_hit, z+s, <= esc
FWD_FLOPS_PER_ADVANCE = 2  # z + (s - rad)
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
UNIMODAL_FLOPS_PER_STEP = 3    # stp>0, d*w, >stp
RELAX_FLOPS_HIT_TEST = 6       # z0+t, u*u, +rxy2, sqrt, -rad, d<eps
CONT_FLOPS_PER_PIXEL = 3       # pass 1's survivor test after the hit test
# sdf_bwd_ad computes sdf_bwd's function, so its bound takes sdf_bwd's
# count. For the record only: the duals' arithmetic as written (15
# products of 31, 14 sums of 11, 2 rsqrt of 14, the relu, the
# contraction), before the compiler drops the derivative slots that are
# structurally zero
BWD_AD_FLOPS_AS_WRITTEN_PER_HIT = 693
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

    def __call__(self, fn, reps, hold_ms=200.0):
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
        check(enqueue_ms < hold_ms, f"timer hold {hold_ms} ms shorter than "
              f"the enqueue ({enqueue_ms:.1f} ms): raise hold_ms")
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


def bound(nbytes, flops, bf16_flops=0):
    """max(bytes / HBM rate, FP32 operations / FP32 peak + bf16 operations
    / bf16 peak) in ms, and which of the two it is."""
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "operations": flops / FP32_FLOPS_PER_S
         + bf16_flops / BF16_FLOPS_PER_S}
    by = max(t, key=t.get)
    return 1e3 * t[by], by


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
    libs = ("sdf_render", "sdf_bwd_ad", "sphere_render")
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(_build.build, libs))  # one nvcc per source at once
    for name in libs:
        _build.load(name)
    log(f"build: {', '.join(f'{n}.cu' for n in libs)} with nvcc "
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
    bwd_err = 0.0
    for seed in SEEDS:
        p = cuda_vec(seed)
        _, ts = K.sdf_fwd(p, N, STEPS, EXTENT)
        g = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (N, N)).astype(np.float32)).to(dev)
        dp1 = K.sdf_bwd(p, g, ts, N, EXTENT)
        dp2 = K.sdf_bwd(p, g, ts, N, EXTENT)
        ref = K.sdf_bwd_plain(p, g, ts, N, EXTENT)
        torch.cuda.synchronize()
        check(torch.equal(dp1, dp2), "sdf_bwd: two runs differ")
        scale = max(1.0, ref.abs().max().item())
        err = (dp1 - ref).abs()
        bwd_err = max(bwd_err, err.max().item())
        ok = bool((err <= 2e-4 * scale + 2e-4 * ref.abs()).all().item())
        log(f"phase 2 sdf_bwd scene={seed}: max|dp-plain| "
            f"{err.max().item():.3e} (scale {scale:.3e}), bitwise "
            f"deterministic: yes; gate rtol 2e-4 atol 2e-4*scale: "
            f"{'pass' if ok else 'FAIL'}")
        check(ok, f"sdf_bwd vs plain (scene {seed}): {err.tolist()}")

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
    check(launches == {k: TRAIN_STEPS for k in
                       ("sdf_fwd", "sdf_bwd", "sdf_bwd_reduce")},
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
    bwd_ms = timer(lambda: K.sdf_bwd(p_ref, g_ref, ts_ref, N, EXTENT), 200)
    fwd_plain_ms = timer(lambda: K.sdf_fwd_plain(p_ref, N, STEPS, EXTENT),
                         5, hold_ms=1000.0)
    bwd_plain_ms = timer(lambda: K.sdf_bwd_plain(p_ref, g_ref, ts_ref, N,
                                                 EXTENT), 20, hold_ms=1000.0)

    # bounds from this run's data: the march work is what this scene needs
    evals, adv = (int(c.sum().item())
                  for c in K.march_counts(p_ref, N, STEPS, EXTENT))
    hits = int((ts_ref >= 0).sum().item())
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    mufu_per_s = MUFU_PER_CLK_PER_SM * props.multi_processor_count \
        * sm_mhz * 1e6

    # fwd reads the 16 params and writes img + ts; bwd reads params, g
    # and ts and writes dp[16]
    fwd_bound, fwd_by = bound(
        8 * rays + 64,
        FWD_FLOPS_PER_EVAL * evals + FWD_FLOPS_PER_ADVANCE * adv
        + FWD_FLOPS_PER_PIXEL * rays + FWD_FLOPS_PER_HIT * hits)
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


def run_sphere(torch, dev, timer, cuda_vec):
    """Phases 5-8: the closed-form sphere path. Returns its kernels'
    entries of the kernels line."""
    from enoki_tpu_torch.render import (LAUNCHES, reset_launch_counts,
                                        sphere as TS, sphere_kernels as S)
    from enoki_tpu_torch.render.sdf_kernels import (scene_to_vec,
                                                    tile_pixels,
                                                    vec_to_scene)
    from enoki_tpu_torch.render.vec import Vec2

    f32, bf16 = torch.float32, torch.bfloat16

    # -- phase 5: sphere_fwd (f32, bf16) against its plain version ---------
    fwd_err = {f32: 0.0, bf16: 0.0}
    for seed in SEEDS:
        p = cuda_vec(seed)
        for dtype in (f32, bf16):
            img_k = S.sphere_fwd(p, N, EXTENT, dtype)
            img_p = S.sphere_fwd_plain(p, N, EXTENT, dtype)
            torch.cuda.synchronize()
            check(img_k.shape == (N, N) and img_k.dtype == dtype
                  and torch.isfinite(img_k).all().item(),
                  f"sphere_fwd {dtype}: bad output")
            d = (img_k.float() - img_p.float()).abs()
            dmax = d.max().item()
            fwd_err[dtype] = max(fwd_err[dtype], dmax)
            flips = d > 1.0  # a hit/miss flip jumps by ~gain
            share = flips.float().mean().item()
            if dmax == 0.0:
                gate, ok = "bit-equal", True
            elif dtype == f32:
                off = d[~flips].max().item()
                gate = (f"flip share {share:.3e} < 1.5e-3, off-flip max "
                        f"{off:.3e} < 0.05")
                ok = share < 1.5e-3 and off < 0.05
            else:  # off the flips, within one bf16 ulp (2^-7 relative)
                rel = (d / img_p.float().abs())[~flips].max().item()
                gate = (f"flip share {share:.3e} < 1.5e-3, off-flip max "
                        f"relative {rel:.3e} <= 2^-7")
                ok = share < 1.5e-3 and rel <= 2.0 ** -7
            log(f"phase 5 sphere_fwd {str(dtype)[6:]} scene={seed}: "
                f"max|img-plain| {dmax:.3e}, flip share {share:.3e}, "
                f"pixels differing {(d > 0).sum().item()}; gate: {gate}: "
                f"{'pass' if ok else 'FAIL'}")
            check(ok, f"sphere_fwd {dtype} vs plain (scene {seed}): {gate}")

    # -- phase 6: sphere_bwd against its plain version, determinism --------
    bwd_err = 0.0
    g_rand = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(dev)
    for seed in SEEDS:
        p = cuda_vec(seed)
        dp1 = S.sphere_bwd(p, g_rand, N, EXTENT)
        dp2 = S.sphere_bwd(p, g_rand, N, EXTENT)
        ref = S.sphere_bwd_plain(p, g_rand, N, EXTENT)
        torch.cuda.synchronize()
        check(torch.equal(dp1, dp2), "sphere_bwd: two runs differ")
        scale = max(1.0, ref.abs().max().item())
        err = (dp1 - ref).abs()
        bwd_err = max(bwd_err, err.max().item())
        ok = bool((err <= 2e-4 * scale + 2e-4 * ref.abs()).all().item())
        log(f"phase 6 sphere_bwd scene={seed}: max|dp-plain| "
            f"{err.max().item():.3e} (scale {scale:.3e}), bitwise "
            f"deterministic: yes; gate rtol 2e-4 atol 2e-4*scale: "
            f"{'pass' if ok else 'FAIL'}")
        check(ok, f"sphere_bwd vs plain (scene {seed}): {err.tolist()}")

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
            "sphere_bwd": TRAIN_STEPS + 1,
            "sphere_bwd_reduce": TRAIN_STEPS + 1}
    log(f"phase 7 launches over {TRAIN_STEPS} f32 steps and 1 bf16 step: "
        f"{launches}")
    check(launches == want, f"expected {want}, got {launches}")

    # -- phase 8: timing ----------------------------------------------------
    rays = N * N
    p_ref = cuda_vec(None)
    g_mean = torch.full((N, N), 1.0 / rays, device=dev)
    ms = {k: timer(fn, 200) for k, fn in (
        ("sphere_fwd", lambda: S.sphere_fwd(p_ref, N, EXTENT, f32)),
        ("sphere_fwd_bf16", lambda: S.sphere_fwd(p_ref, N, EXTENT, bf16)),
        ("sphere_bwd", lambda: S.sphere_bwd(p_ref, g_mean, N, EXTENT)))}
    plain_ms = {k: timer(fn, 20, hold_ms=1000.0) for k, fn in (
        ("sphere_fwd", lambda: S.sphere_fwd_plain(p_ref, N, EXTENT, f32)),
        ("sphere_fwd_bf16",
         lambda: S.sphere_fwd_plain(p_ref, N, EXTENT, bf16)),
        ("sphere_bwd", lambda: S.sphere_bwd_plain(p_ref, g_mean, N,
                                                  EXTENT)))}
    scene_ref = vec_to_scene(p_ref, TS.SphereScene)
    staged_ms = timer(lambda: TS.render_staged(scene_ref, N), 20,
                      hold_ms=1000.0)

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
    for seed in SEEDS:
        for shift in (0.0, 10.0):  # mixed scene / all-miss scene
            p = cuda_vec(seed)
            p[0] += shift
            _, ts = K.sdf_fwd(p, N, STEPS, EXTENT)
            dp1 = K.sdf_bwd(p, g_rand, ts, N, EXTENT, kernel="ad")
            dp2 = K.sdf_bwd(p, g_rand, ts, N, EXTENT, kernel="ad")
            refs = {"sdf_bwd": K.sdf_bwd(p, g_rand, ts, N, EXTENT),
                    "plain": K.sdf_bwd_ad_plain(p, g_rand, ts, N, EXTENT)}
            torch.cuda.synchronize()
            check(torch.equal(dp1, dp2), "sdf_bwd_ad: two runs differ")
            for which, ref in refs.items():
                scale = max(1.0, ref.abs().max().item())
                e = (dp1 - ref).abs()
                if which == "plain":
                    worst("sdf_bwd_ad", e.max().item())
                ok = bool((e <= 2e-4 * scale + 2e-4 * ref.abs()).all().item())
                log(f"phase 11 sdf_bwd_ad scene={seed} shift={shift}: "
                    f"max|dp-{which}| {e.max().item():.3e} (scale "
                    f"{scale:.3e}), bitwise deterministic: yes; gate rtol "
                    f"2e-4 atol 2e-4*scale: {'pass' if ok else 'FAIL'}")
                check(ok, f"sdf_bwd_ad vs {which} (scene {seed}, shift "
                      f"{shift}): {e.tolist()}")

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
    check(got == {k: steps_run for k in
                  ("sdf_fwd", "sdf_bwd", "sdf_bwd_reduce")},
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
        check(got == {**want, "sdf_bwd_reduce": 1},
              f"{label}: expected {want} + the reduce, got {got}")
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
        return FWD_FLOPS_PER_EVAL * evals + FWD_FLOPS_PER_ADVANCE * adv

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
    # a survivor's evaluations: one per advance, the one that found it
    # frozen unless it ran to the cap, and the final hit test
    tail_evals = int((torch.clamp_max(tail_adv + 1, STEPS - 16) + 1).sum()
                     .item())
    tail_hits = int((ts_ref.view(-1)[idx] >= 0).sum().item())
    k = idx.numel()

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
                  + FWD_FLOPS_PER_PIXEL * k + FWD_FLOPS_PER_HIT * tail_hits)),
        # the function is sdf_bwd's, so the bound is sdf_bwd's
        "sdf_bwd_ad": (
            lambda: K.sdf_bwd(p_ref, g_mean, ts_ref, N, EXTENT, kernel="ad"),
            lambda: K.sdf_bwd_ad_plain(p_ref, g_mean, ts_ref, N, EXTENT),
            bound(8 * rays + 64 + 64, BWD_FLOPS_PER_HIT * hits
                  + BWD_FLOPS_PER_PIXEL * rays)),
    }
    ms = {name: timer(fn, 200) for name, (fn, _, _) in work.items()}
    # the plain versions as phases 4 and 8 time theirs: device time, the
    # stream held while the host enqueues. One call at a time: the
    # relaxed march is ~1600 eager launches, and a few calls of it fill
    # CUDA's launch queue, which then blocks the host until the hold ends
    plain_ms = {name: timer(fn, 1, hold_ms=1000.0)
                for name, (_, fn, _) in work.items()}
    for name, (_, _, (b_ms, b_by)) in work.items():
        log(f"phase 12 {name} {ms[name]:.5f} ms (plain "
            f"{plain_ms[name]:.4f} ms, bound {b_ms:.5f} ms by {b_by}); "
            f"library call: none computes this function")
    ad_ops_ms = 1e3 * BWD_AD_FLOPS_AS_WRITTEN_PER_HIT * hits / FP32_FLOPS_PER_S
    log(f"phase 12 sdf_bwd_ad, for the record: the duals' arithmetic as "
        f"written is {BWD_AD_FLOPS_AS_WRITTEN_PER_HIT} operations per hit "
        f"pixel, {ad_ops_ms:.5f} ms at the FP32 peak, against the "
        f"{BWD_FLOPS_PER_HIT} the function needs")
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

    # the cone prepass: eager ops on a (N/8)^2 array, device and wall time
    cone_dev_ms = timer(lambda: K._cone_t0(p_ref, N, STEPS, EXTENT, 8), 5,
                        hold_ms=1000.0)
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


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed phase or gate ends the check
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
