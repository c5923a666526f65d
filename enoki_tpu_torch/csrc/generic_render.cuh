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
//   template <class T> void gen::user_cotangent(px, py, t, g, const T* pv,
//                                               T* dp)
//
// One library per scene, as the reference makes one pair of Pallas kernels
// per scene by closing them over sdf_fn and ray_fn.
//
// generic_fwd -- replaces fwd_kernel (enoki_tpu/render/generic.py:143-185).
// One thread per pixel on a 2-D grid. The thread builds its ray with
// user_ray, marches user_sdf along it from the start map t0 (null = 0) as
// _march_tile does (pallas_kernels.py:191-313: the plain carry, or the
// (pos, stp) carry of the over-relaxed / divergence-exit march, neither
// advancing at step n_steps - 1), shades a hit with the normal grad_p
// user_sdf taken by a 3-partial dual, and writes the image and the packed
// residual ts (t on a hit, -t-1 on a miss). eps and t_max are arguments.
// Each thread leaves its loop on its own and a miss skips the shade, which
// does per lane what the TPU kernel's bands and its miss-band fast path do
// per tile. The march runs in gen::Real, every operation rounded on its
// own in the plain version's order, so that it walks the plain version's
// trajectory (nvcc would contract a*b+c otherwise, see sdf_render.cu).
// Bound on this card: 8 B written per pixel (4 B more read with a start
// map) against the operations of the traced scene function times the
// evaluations the march makes; for a scene of a few dozen operations the
// operations set it (chip_smoke.py computes both from the run's data).
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
// dual normal and the reverse-mode cotangent can be held against the
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
  int relaxed, unimodal;
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
// is d(t) < eps.
GEN_HD Real march_plain(const Ray& r, const Real* pv, Real t, const March& m,
                        bool* hit) {
  for (int k = 0; k < m.n_steps - 1; ++k) {
    const Real d = dist_at(r, pv, t);
    const Real next = t + d;
    const bool alive = (d.v >= m.eps) & (next.v <= m.t_max);
    if (!alive) break;
    t = next;
  }
  *hit = dist_at(r, pv, t).v < m.eps;
  return t;
}

// The (pos, stp) march of _march_tile's over-relaxed / divergence-exit
// path and _relax_step (pallas_kernels.py:291-349): over, alive, diverged,
// adv, new_stp, new_pos in that order. No advance at k = n_steps - 1; the
// lane leaves once !(alive | over), after which (pos, stp = 0) is a fixed
// point of the step. Returns pos; hit is d(pos) < eps.
GEN_HD Real march_relaxed(const Ray& r, const Real* pv, Real pos,
                          const March& m, bool* hit) {
  const Real w(m.w), back(m.back), zero(0.0f), tmax(m.t_max);
  Real stp = zero;
  for (int k = 0; k < m.n_steps; ++k) {
    const Real d = dist_at(r, pv, pos);
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
    pos = new_pos;
    stp = new_stp;
    if (!(alive | over)) break;
  }
  *hit = dist_at(r, pv, pos).v < m.eps;
  return pos;
}

// ambient + max(n . l / |n|, 0) * gain from the normal (gx, gy, gz), in a
// float or in a dual; pv holds at least ambient, gain and the light
// (_shade, render/generic.py).
template <class T>
GEN_HD T lambert_shade(const T& gx, const T& gy, const T& gz, const T* pv) {
  const T inv = rsqrt_(gx * gx + gy * gy + gz * gz + T(1e-12f));
  const T lam = (gx * pv[kLight] + gy * pv[kLight + 1] + gz * pv[kLight + 2])
      * inv;
  return pv[kAmbient] + max_(lam, T(0.0f)) * pv[kGain];
}

// The shade of a hit at t: the normal is grad_p user_sdf at p = o + d t.
GEN_HD float shade_hit(const Ray& r, const Real* pv, Real t) {
  using D3 = Dual<float, 3>;
  D3 pvd[kNP];
  float pvf[kNP];
#pragma unroll
  for (int k = 0; k < kNP; ++k) {
    pvd[k] = D3(pv[k].v);
    pvf[k] = pv[k].v;
  }
  const D3 s = user_sdf<D3>(variable<float, 3>((r.o[0] + r.d[0] * t).v, 0),
                            variable<float, 3>((r.o[1] + r.d[1] * t).v, 1),
                            variable<float, 3>((r.o[2] + r.d[2] * t).v, 2),
                            pvd);
  return lambert_shade<float>(s.d[0], s.d[1], s.d[2], pvf);
}

// One pixel of generic_fwd: (img, ts) at (col, row).
GEN_HD void render_pixel(const float* params, float t0, int col, int row,
                         float step, float extent, const March& m,
                         float* img, float* ts) {
  Real pv[kNP];
#pragma unroll
  for (int k = 0; k < kNP; ++k) pv[k] = Real(params[k]);
  Ray r;
  user_ray<Real>(Real(pixel_coord(col, step, extent)),
                 Real(pixel_coord(row, step, extent)), pv, r.o, r.d);
  bool hit;
  const Real t = m.relaxed ? march_relaxed(r, pv, Real(t0), m, &hit)
                           : march_plain(r, pv, Real(t0), m, &hit);
  // a miss shades to exactly the ambient term and skips the shade; the
  // hit bit rides the sign of ts
  *img = hit ? shade_hit(r, pv, t) : params[kAmbient];
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

__global__ void __launch_bounds__(256)
generic_fwd_kernel(const float* __restrict__ params,
                   const float* __restrict__ t0_img, float* __restrict__ img,
                   float* __restrict__ ts, int n, float step, float extent,
                   gen::March m) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= n || row >= n) return;
  const size_t i = static_cast<size_t>(row) * n + col;
  gen::render_pixel(params, t0_img ? t0_img[i] : 0.0f, col, row, step, extent,
                    m, img + i, ts + i);
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
  const dim3 block(32, 8);
  const dim3 grid((n + 31) / 32, (n + 7) / 8);
  const gen::March m{n_steps, eps, t_max, w, back, relaxed, unimodal};
  generic_fwd_kernel<<<grid, block, 0, stream>>>(params, t0, img, ts, n, step,
                                                 extent, m);
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

extern "C" {

int generic_n_params() { return gen::kNP; }

int generic_host_fwd(const float* params, const float* t0, float* img,
                     float* ts, int n, int n_steps, float step, float extent,
                     float eps, float t_max, float w, float back, int relaxed,
                     int unimodal) {
  const gen::March m{n_steps, eps, t_max, w, back, relaxed, unimodal};
  for (int row = 0; row < n; ++row)
    for (int col = 0; col < n; ++col) {
      const int64_t i = static_cast<int64_t>(row) * n + col;
      gen::render_pixel(params, t0 ? t0[i] : 0.0f, col, row, step, extent, m,
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
