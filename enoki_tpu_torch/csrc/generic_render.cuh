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
// pushes one direction of (pvec, t) at a time through the nested dual
// Dual<Dual<float, 3>, 1>: the inner level carries grad_p, the outer the
// direction, so one evaluation of user_sdf gives the normal, its
// derivative along the direction (the mixed second derivative the shade
// needs) and d sdf along it, rays included (user_ray runs on the outer
// dual, so a camera parameter in pvec is differentiated). n_params + 1
// sweeps of an 8-float value fit in registers, where one sweep of all
// directions (4 (n_params + 2) floats per value) would spill; the sweeps
// are unrolled, so the compiler shares the primal work among them and
// drops the partials that are structurally zero. The t direction runs
// first: it gives t_bar and the slope of the implicit root (guard 1e-6,
// sign kept, an exact zero taken as negative, render/implicit.py). A miss
// adds g to the ambient slot and nothing else. Each thread takes
// kSumPixels pixels, a block writes its n_params sums as one row of
// partial[num_blocks][n_params] in a fixed order, and reduce_rows_kernel
// (common.cuh) sums the rows: no float atomics, bitwise equal gradients
// from run to run. The TPU kernel's n_pad padding (an SMEM layout rule)
// is not carried over.
// Bound on this card: 8 B read per pixel (g and ts) against the
// operations the cotangent needs per hit pixel, which is what reverse mode
// would run (a few passes over the scene function), not the n_params + 1
// sweeps run here; for a scene of a few dozen operations the bytes set it.
//
// The per-pixel functions compile as host C++17 too. Without nvcc this
// header ends in two loops over the image with a C interface
// (generic_host_fwd, generic_host_bwd), so that the generated code and the
// nested duals can be held against the plain PyTorch versions where there
// is no card (tests/test_torch_generic_codegen.py builds it with
// g++ -O2 -ffp-contract=off -shared -fPIC -x c++ <source>).

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

// The derivatives of a hit pixel's shade and of its SDF residual
// f(pv, t) = user_sdf(user_ray(px, py, pv)(t), pv) along direction k of
// (pv[0..kNP-1], t): k = kNP is t.
GEN_HD void directional(int k, const float* pv, float t, float px, float py,
                        float* d_img, float* d_sdf) {
  using D1 = Dual<float, 1>;
  using D3 = Dual<float, 3>;
  using D2 = Dual<D3, 1>;
  D1 pv1[kNP];
  D2 pv2[kNP];
#pragma unroll
  for (int j = 0; j < kNP; ++j) {
    const float seed = j == k ? 1.0f : 0.0f;
    pv1[j].v = pv[j];
    pv1[j].d[0] = seed;
    pv2[j].v = D3(pv[j]);
    pv2[j].d[0] = D3(seed);
  }
  D1 t1;
  t1.v = t;
  t1.d[0] = k == kNP ? 1.0f : 0.0f;
  // the ray and the point on it carry the direction only; grad_p is
  // seeded at the point itself
  D1 o[3], d[3];
  user_ray<D1>(D1(px), D1(py), pv1, o, d);
  D2 x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const D1 p = o[i] + d[i] * t1;
    x[i].v = variable<float, 3>(p.v, i);
    x[i].d[0] = D3(p.d[0]);
  }
  const D2 s = user_sdf<D2>(x[0], x[1], x[2], pv2);
  *d_sdf = s.d[0].v;
  D1 g[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i].v = s.v.d[i];
    g[i].d[0] = s.d[0].d[i];
  }
  *d_img = lambert_shade<D1>(g[0], g[1], g[2], pv1).d[0];
}

// Add one pixel's cotangent terms to acc[0..kNP-1].
template <class Acc>
GEN_HD void add_pixel_cotangent(Acc (&acc)[kNP], const float* pv, float g,
                                float tsv, float px, float py) {
  if (!(tsv >= 0.0f)) {
    // a miss shades to ambient + 0: d img / d ambient = 1, nothing else
    acc[kAmbient] += g;
    return;
  }
  // a hit stores t itself. The implicit root f(pv, t*) = eps:
  // dt*/dtheta . t_bar = -(t_bar / f_t) f_theta
  float d_img, d_sdf;
  directional(kNP, pv, tsv, px, py, &d_img, &d_sdf);
  const float t_bar = g * d_img;
  const float sgn = d_sdf == 0.0f ? -1.0f : (d_sdf > 0.0f ? 1.0f : -1.0f);
  const float slope = abs_(d_sdf) > 1e-6f ? d_sdf : sgn;
  const float w = -t_bar / slope;
#pragma unroll
  for (int k = 0; k < kNP; ++k) {
    directional(k, pv, tsv, px, py, &d_img, &d_sdf);
    acc[k] += g * d_img + w * d_sdf;
  }
}

}  // namespace gen

#ifdef __CUDACC__

namespace {

static_assert(gen::kNP <= kSumThreads,
              "one thread of the reduce block per parameter");

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
      static_cast<int64_t>(blockIdx.x) * (kSumThreads * kSumPixels) +
      threadIdx.x;
  float pv[gen::kNP], acc[gen::kNP];
#pragma unroll
  for (int k = 0; k < gen::kNP; ++k) {
    pv[k] = params[k];
    acc[k] = 0.0f;
  }
  // one pixel at a time: the duals of one pixel fill the registers
#pragma unroll 1
  for (int j = 0; j < kSumPixels; ++j) {
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

int generic_bwd_num_blocks(int n) { return sum_num_blocks(n); }

// partial has generic_bwd_num_blocks(n) rows of n_params.
int generic_bwd_partial_launch(const float* params, const float* g,
                               const float* ts, float* partial, int n,
                               float step, float extent,
                               cudaStream_t stream) {
  generic_bwd_partial_kernel<<<sum_num_blocks(n), kSumThreads, 0, stream>>>(
      params, g, ts, partial, n, step, extent);
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
