// The kernel skeleton of the bring-your-own-SDF renderer
// (enoki_tpu_torch/render/generic.py), for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (enoki_tpu_torch/_build.py).
//
// This header is the second half of a generated source. Its first half,
// written per scene by render/sdf_trace.py from the scene's Python
// functions, defines GENERIC_N_PARAMS, includes generic_num.cuh, and gives
//
//   template <class T> T    gen::user_sdf(x, y, z, const T* pv)
//   template <class T> void gen::user_ray(px, py, const T* pv, T* o, T* d)
//   template <class T> T    gen::user_shade(ox, oy, oz, dx, dy, dz, t,
//                                           const T* pv)
//   template <class T> void gen::user_cotangent(px, py, t, g, const T* pv,
//                                               T* dp)
//
// One library per scene, as the reference makes one pair of Pallas kernels
// per scene by closing them over sdf_fn and ray_fn.
//
// generic_fwd -- replaces fwd_kernel (enoki_tpu/render/generic.py:143-185).
// One thread per pixel. The thread builds its ray with user_ray, marches
// user_sdf along it from the start map t0 (null = 0) as _march_tile does
// (pallas_kernels.py:191-313: the plain carry, or the (pos, stp) carry of
// the over-relaxed / divergence-exit march, neither advancing at step
// n_steps - 1; one kernel for each), shades a hit with user_shade (the
// normal grad_p user_sdf by a reverse sweep and the Lambert term, emitted
// by the tracer: sdf_trace.shade_program), and writes the image and the
// packed residual ts (t on a hit, -t-1 on a miss). eps and t_max are
// arguments. Each thread leaves its loop on its own and a miss skips the
// shade, which does per lane what the TPU kernel's bands and its miss-band
// fast path do per tile. The march runs in gen::Real, every operation
// rounded on its own in the plain version's order, so that it walks the
// plain version's trajectory (nvcc would contract a*b+c otherwise, see
// sdf_render.cu); the shade is float code that nvcc may contract (the
// image is held to a tolerance).
// Bound on this card: 8 B written per pixel (4 B more read with a start
// map) against the operations of the traced scene function times the
// evaluations the march needs; for a scene of a few dozen operations the
// operations set it (chip_smoke.py computes both from the run's data).
// What the design does about it: a warp waits for its longest march, so a
// warp takes a kWarpCols x (32 / kWarpCols) tile of pixels (8 x 4), whose
// marches are more alike than those of a row of 32; and a block holds its
// slot on the SM until its slowest warp ends, so a block is four warps on
// 16 x 8 pixels (with eight on 32 x 8 the tiles' gain was lost there).
// The hit test takes the distance the loop computed last, at the same t,
// and evaluates anew only where the march ran to its step cap (or,
// relaxed, moved after it); the normal is one reverse sweep, not a
// 3-partial dual over the scene; and a square root whose argument the
// tracer bounds (sdflib's all) skips the range check of the IEEE one
// (sqrt_pos_, common.cuh). kernel_variants.py times each choice.
// Each operation of the march is an IEEE operation of its own (the square
// roots several instructions each), so the instructions a warp issues, not
// the FP32 peak, are what is left: chip_smoke.py prints that floor.
//
// generic_bwd -- replaces bwd_kernel (enoki_tpu/render/generic.py:187-231).
// The TPU kernel takes jax.vjp of the shade, whose normal is itself a
// jax.grad of the user function, and adds implicit_t_vjp. Here a hit pixel
// runs user_cotangent: the scene differentiated in reverse mode by the
// tracer (sdf_trace.cotangent_program), emitted as straight-line float
// code. It recomputes the ray and the hit point, the distance with a
// reverse sweep for the normal, the shade, one sweep back through all of
// it for d img / d(pvec, t) times g, one from the distance for its slopes
// in pvec and t, and adds the implicit term -(t_bar / guard(slope_t)) *
// slope_pvec (guard 1e-6, sign kept, an exact zero taken as negative,
// render/implicit.py). nvcc may contract a*b+c here (a derivative is
// held to a tolerance, not bit for bit), and a tie that the scene makes
// by construction (two equal expressions, a
// parameter at a clip bound or an abs at 0) stays a tie, since equal
// expressions are one node of the program. A miss adds g to the ambient
// slot and nothing else. Each thread takes kBwdPixels pixels, a block
// writes its n_params sums as one row of partial[num_blocks][n_params] in
// a fixed order, and reduce_rows_kernel (common.cuh) sums the rows: no
// float atomics, bitwise equal gradients from run to run. The TPU
// kernel's n_pad padding (an SMEM layout rule) is not carried over.
// Bound on this card: 8 B read per pixel (g and ts) against the
// operations of user_cotangent per hit pixel (a few hundred for a scene
// of a few dozen operations: the bytes set it). What held the earlier
// design back (45.6x its bound) was the route, not the memory: it pushed
// n_params + 1 directions one at a time through a nested dual
// Dual<Dual<float, 3>, 1>, 13 sweeps of the scene function on the
// 12-parameter composed scene at 149 registers, where reverse mode needs
// one program of a few hundred operations (264 there), at ~80 registers.
// Divergence along the silhouettes costs little: the warps of 32
// neighbouring pixels that hold a hit are 7% more than the hits would
// fill. What is left is each hit's chain of dependent operations, hidden
// by as many warps as the registers allow; 4 pixels a thread give the
// card enough blocks for that.
//
// The per-pixel functions compile as host C++17 too. Without nvcc this
// header ends in two loops over the image with a C interface
// (generic_host_fwd, generic_host_bwd), so that the generated code, the
// march, the shade and the reverse-mode cotangent can be held against the
// plain PyTorch versions where there is no card
// (tests/test_torch_generic_codegen.py builds it with
// g++ -O2 -ffp-contract=off -shared -fPIC -x c++ <source>, so that the
// host's float rounds each operation on its own).

#pragma once

#ifdef __CUDACC__
#include "common.cuh"
#endif

#include <cstdint>

namespace gen {

constexpr int kNP = GENERIC_N_PARAMS;
// the parameter vector's fixed slots (render/generic.py)
constexpr int kAmbient = 0, kGain = 1, kLight = 2;
static_assert(kNP >= 5, "pv[0:5] are ambient, gain and the light");

// What a march needs beside the ray; w = relax and back = 1 - 1/relax.
struct March {
  int n_steps;
  float eps, t_max, w, back;
  int unimodal;
};

struct Ray {
  Real o[3], d[3];
};

// col * step - extent from the integer index, as sdf_kernels.tile_pixels
GEN_HD float pixel_coord(int i, float step, float extent) {
  return (Real(static_cast<float>(i)) * Real(step) - Real(extent)).v;
}

// sdf_fn(o + d * t, pv)
GEN_HD Real dist_at(const Ray& r, const Real* pv, Real t) {
  return user_sdf<Real>(r.o[0] + r.d[0] * t, r.o[1] + r.d[1] * t,
                        r.o[2] + r.d[2] * t, pv);
}

// The plain carry of _march_tile from t: at most n_steps - 1 advances,
// leaving the loop when the lane freezes (a frozen lane never advances,
// so this is trajectory-exact against the masked march). Returns t; hit
// is d(t) < eps, with the d the loop computed last, which is d(t) bit for
// bit: one evaluation per advance and one more (n_steps at the cap).
GEN_HD Real march_plain(const Ray& r, const Real* pv, Real t, const March& m,
                        bool* hit) {
  Real d;
#pragma unroll 1
  for (int k = 0;; ++k) {
    d = dist_at(r, pv, t);
    if (k >= m.n_steps - 1) break;
    const Real next = t + d;
    if (!((d.v >= m.eps) & (next.v <= m.t_max))) break;
    t = next;
  }
  *hit = d.v < m.eps;
  return t;
}

// The (pos, stp) march of _march_tile's over-relaxed / divergence-exit
// path and _relax_step (pallas_kernels.py:291-349): over, alive, diverged,
// adv, new_stp, new_pos in that order. No advance at k = n_steps - 1; the
// lane leaves once !(alive | over), after which (pos, stp = 0) is a fixed
// point of the step. Returns pos; hit is d(pos) < eps, with the last
// distance the loop computed where pos did not move after it (the step
// neither reverted, nor diverged, nor advanced), else evaluated anew.
GEN_HD Real march_relaxed(const Ray& r, const Real* pv, Real pos,
                          const March& m, bool* hit) {
  const Real w(m.w), back(m.back), zero(0.0f), tmax(m.t_max);
  Real stp = zero, d = zero;
  bool moved = true;  // no distance at pos yet
#pragma unroll 1
  for (int k = 0; k < m.n_steps; ++k) {
    d = dist_at(r, pv, pos);
    const Real back_stp = back * stp;
    const bool over = d.v < back_stp.v;
    const bool far = d.v >= m.eps;
    bool alive = far & ((pos + d).v <= m.t_max);
    bool diverged = false;
    if (m.unimodal) {
      diverged = !over & (stp.v > 0.0f) & far & ((d * w).v > stp.v);
      alive = alive & !diverged;
    }
    const bool adv = alive & !over & (k < m.n_steps - 1);
    const Real new_stp = adv ? w * d : zero;
    // revert (overlap failed) to the plain-step position, else advance; a
    // frozen lane adds 0
    Real new_pos = over ? pos - back_stp : pos + new_stp;
    if (diverged) new_pos = tmax;
    moved = over | diverged | adv;
    pos = new_pos;
    stp = new_stp;
    if (!(alive | over)) break;
  }
  *hit = (moved ? dist_at(r, pv, pos) : d).v < m.eps;
  return pos;
}

// The shade of a hit at t: user_shade, the scene's normal at o + d t by a
// reverse sweep and ambient + max(n . l / |n|, 0) * gain (_shade,
// render/generic.py), in float.
GEN_HD float shade_hit(const Ray& r, const float* pv, Real t) {
  return user_shade<float>(r.o[0].v, r.o[1].v, r.o[2].v, r.d[0].v, r.d[1].v,
                           r.d[2].v, t.v, pv);
}

// One pixel of generic_fwd: (img, ts) at (col, row); kRelaxed takes the
// (pos, stp) march.
template <bool kRelaxed>
GEN_HD void render_pixel(const float* params, float t0, int col, int row,
                         float step, float extent, const March& m,
                         float* img, float* ts) {
  Real pv[kNP];
  float pvf[kNP];
#pragma unroll
  for (int k = 0; k < kNP; ++k) {
    pvf[k] = params[k];
    pv[k] = Real(pvf[k]);
  }
  Ray r;
  user_ray<Real>(Real(pixel_coord(col, step, extent)),
                 Real(pixel_coord(row, step, extent)), pv, r.o, r.d);
  bool hit;
  const Real t = kRelaxed ? march_relaxed(r, pv, Real(t0), m, &hit)
                          : march_plain(r, pv, Real(t0), m, &hit);
  // a miss shades to exactly the ambient term and skips the shade; the
  // hit bit rides the sign of ts
  *img = hit ? shade_hit(r, pvf, t) : pvf[kAmbient];
  *ts = hit ? t.v : -t.v - 1.0f;
}

// Add one pixel's cotangent terms to acc[0..kNP-1]. A hit stores t itself
// in ts and runs the scene's reverse-mode program.
template <class Acc>
GEN_HD void add_pixel_cotangent(Acc (&acc)[kNP], const float* pv, float g,
                                float tsv, float px, float py) {
  if (!(tsv >= 0.0f)) {
    // a miss shades to ambient + 0: d img / d ambient = 1, nothing else
    acc[kAmbient] += g;
    return;
  }
  float dp[kNP];
  user_cotangent<float>(px, py, tsv, g, pv, dp);
#pragma unroll
  for (int k = 0; k < kNP; ++k) acc[k] += dp[k];
}

}  // namespace gen

#ifdef __CUDACC__

namespace {

static_assert(gen::kNP <= kSumThreads,
              "one thread of the reduce block per parameter");

// pixels per thread of generic_bwd: at 1024^2, 1024 blocks of kSumThreads
// (2.6 waves of the 3 blocks an SM that ~80 registers allow), where
// common.cuh's 8 left a second wave of 116 blocks of 512
constexpr int kBwdPixels = 4;

// generic_fwd's footprint (common.cuh's tile_pixel): a block takes
// kBlockCols x kBlockRows pixels, and each of its warps a kWarpCols x
// (32 / kWarpCols) tile of them. A warp stores 4 rows of 8 floats: a
// whole 32-byte sector a row (4 x 8 tiles ran as fast, with half
// sectors).
constexpr int kWarpCols = 8, kBlockCols = 16, kBlockRows = 8;
constexpr int kFwdThreads = kBlockCols * kBlockRows;

}  // namespace

namespace gen {

// The thread that runs a scene's prints (generic_num.cuh): the one of pixel
// (0, 0) of the launch, in generic_fwd's footprint. It prints each time it
// evaluates user_ray or user_sdf, up to its own exit from the march: one
// line a block would be thousands of blocks times the steps, far past the
// device printf buffer. generic_bwd runs neither function.
GEN_HD bool print_pixel() {
#ifdef __CUDA_ARCH__
  int col, row;
  tile_pixel<kWarpCols, kBlockCols, kBlockRows>(&col, &row);
  return col == 0 && row == 0;
#else
  return false;
#endif
}

}  // namespace gen

namespace {

template <bool kRelaxed>
__global__ void __launch_bounds__(kFwdThreads)
generic_fwd_kernel(const float* __restrict__ params,
                   const float* __restrict__ t0_img, float* __restrict__ img,
                   float* __restrict__ ts, int n, float step, float extent,
                   gen::March m) {
  int col, row;
  tile_pixel<kWarpCols, kBlockCols, kBlockRows>(&col, &row);
  if (col >= n || row >= n) return;
  const size_t i = static_cast<size_t>(row) * n + col;
  gen::render_pixel<kRelaxed>(params, t0_img ? t0_img[i] : 0.0f, col, row,
                              step, extent, m, img + i, ts + i);
}

__global__ void __launch_bounds__(kSumThreads)
generic_bwd_partial_kernel(const float* __restrict__ params,
                           const float* __restrict__ g_img,
                           const float* __restrict__ ts_img,
                           float* __restrict__ partial, int n, float step,
                           float extent) {
  const int64_t npix = static_cast<int64_t>(n) * n;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kSumThreads * kBwdPixels) +
      threadIdx.x;
  float pv[gen::kNP], acc[gen::kNP];
#pragma unroll
  for (int k = 0; k < gen::kNP; ++k) {
    pv[k] = params[k];
    acc[k] = 0.0f;
  }
#pragma unroll 1
  for (int j = 0; j < kBwdPixels; ++j) {
    const int64_t i = base + static_cast<int64_t>(j) * kSumThreads;
    if (i < npix) {
      const int row = static_cast<int>(i / n);
      const int col = static_cast<int>(i - static_cast<int64_t>(row) * n);
      gen::add_pixel_cotangent(acc, pv, g_img[i], ts_img[i],
                               gen::pixel_coord(col, step, extent),
                               gen::pixel_coord(row, step, extent));
    }
  }
  block_sum<gen::kNP>(
      acc, partial + static_cast<int64_t>(blockIdx.x) * gen::kNP);
}

}  // namespace

extern "C" {

int generic_n_params() { return gen::kNP; }

// t0 may be null. w = relax and back = 1 - 1/relax; relaxed != 0 takes the
// (pos, stp) march.
int generic_fwd_launch(const float* params, const float* t0, float* img,
                       float* ts, int n, int n_steps, float step,
                       float extent, float eps, float t_max, float w,
                       float back, int relaxed, int unimodal,
                       cudaStream_t stream) {
  const dim3 grid((n + kBlockCols - 1) / kBlockCols,
                  (n + kBlockRows - 1) / kBlockRows);
  const gen::March m{n_steps, eps, t_max, w, back, unimodal};
  if (relaxed)
    generic_fwd_kernel<true><<<grid, kFwdThreads, 0, stream>>>(
        params, t0, img, ts, n, step, extent, m);
  else
    generic_fwd_kernel<false><<<grid, kFwdThreads, 0, stream>>>(
        params, t0, img, ts, n, step, extent, m);
  return static_cast<int>(cudaGetLastError());
}

int generic_bwd_num_blocks(int n) { return sum_num_blocks(n, kBwdPixels); }

// partial has generic_bwd_num_blocks(n) rows of n_params.
int generic_bwd_partial_launch(const float* params, const float* g,
                               const float* ts, float* partial, int n,
                               float step, float extent,
                               cudaStream_t stream) {
  generic_bwd_partial_kernel<<<sum_num_blocks(n, kBwdPixels), kSumThreads,
                               0, stream>>>(params, g, ts, partial, n, step,
                                            extent);
  return static_cast<int>(cudaGetLastError());
}

int generic_bwd_reduce_launch(const float* partial, int num_rows, float* dp,
                              cudaStream_t stream) {
  return reduce_rows_launch<gen::kNP, gen::kNP>(partial, num_rows, dp,
                                                stream);
}

}  // extern "C"

#else  // a host compiler: the same per-pixel functions in two loops

namespace gen {
// no host thread prints (generic_num.cuh)
GEN_HD bool print_pixel() { return false; }
}  // namespace gen

extern "C" {

int generic_n_params() { return gen::kNP; }

int generic_host_fwd(const float* params, const float* t0, float* img,
                     float* ts, int n, int n_steps, float step, float extent,
                     float eps, float t_max, float w, float back, int relaxed,
                     int unimodal) {
  const gen::March m{n_steps, eps, t_max, w, back, unimodal};
  for (int row = 0; row < n; ++row)
    for (int col = 0; col < n; ++col) {
      const int64_t i = static_cast<int64_t>(row) * n + col;
      const float t0i = t0 ? t0[i] : 0.0f;
      if (relaxed)
        gen::render_pixel<true>(params, t0i, col, row, step, extent, m,
                                img + i, ts + i);
      else
        gen::render_pixel<false>(params, t0i, col, row, step, extent, m,
                                 img + i, ts + i);
    }
  return 0;
}

// dp[n_params], summed in double in row-major order.
int generic_host_bwd(const float* params, const float* g, const float* ts,
                     float* dp, int n, float step, float extent) {
  double acc[gen::kNP];
  for (int k = 0; k < gen::kNP; ++k) acc[k] = 0.0;
  for (int row = 0; row < n; ++row)
    for (int col = 0; col < n; ++col) {
      const int64_t i = static_cast<int64_t>(row) * n + col;
      gen::add_pixel_cotangent(acc, params, g[i], ts[i],
                               gen::pixel_coord(col, step, extent),
                               gen::pixel_coord(row, step, extent));
    }
  for (int k = 0; k < gen::kNP; ++k) dp[k] = static_cast<float>(acc[k]);
  return 0;
}

}  // extern "C"

#endif
