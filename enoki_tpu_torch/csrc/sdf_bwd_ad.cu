// The autodiff-route backward of the SDF sphere-march render, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (enoki_tpu_torch/_build.py). The entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// sdf_bwd_ad -- replaces _sdf_bwd_kernel_ad
// (enoki_tpu/render/pallas_kernels.py:869-912), the reference's
// lane-for-lane oracle for the analytic backward (sdf_bwd in
// sdf_render.cu; tests/test_pallas.py:352).
//
// The TPU kernel takes jax.vjp of the shade (_sdf_shade_tile :432-446,
// whose normal is itself a jax.grad of the SDF) and adds implicit_t_vjp of
// the SDF at the frozen root. CUDA has no in-kernel autodiff, and the
// closed form is sdf_bwd's route, so this kernel reaches the same
// cotangents by a third one: forward-mode dual numbers. Each hit pixel
// pushes a value with its 10 partial derivatives (the 9 live parameters
// and t) through the shade, written as the forward writes it; the image's
// derivatives contracted with g are the direct term and t_bar. The SDF
// itself goes through the same duals for d sdf/dp and d sdf/dt, and the
// implicit term follows implicit_t_vjp (render/implicit.py): guard 1e-6
// on the slope, sign-preserving, an exact zero taken as negative. Nothing
// of sdf_bwd's algebra is shared, so the two kernels check each other.
//
// As in sdf_bwd, each thread takes kSumPixels pixels, a block writes its 9
// sums as one row of partial[num_blocks][9] in a fixed order, and the
// shared reduce (sdf_bwd_reduce_launch of sdf_render.cu) sums the rows:
// no float atomics, bitwise identical gradients from run to run.
//
// Bound on this card: bytes (8 B/pixel read: g and ts). The function is
// sdf_bwd's, dp[16] from (params, g, ts), so it needs no more operations
// than the closed form's ~89 per hit pixel, which stay far under the byte
// time. What this kernel executes is more: ~40 dual operations of ~2 x 10
// FP32 operations each as written, about 8x the closed form, less the
// derivative slots that are structurally zero, which the compiler drops.
// It is an oracle, not the path's backward, so nothing more is done about
// the distance to the bound.

#include "common.cuh"

namespace {

constexpr int kNVar = 10;  // the 9 live parameters, then t
constexpr int kVarT = 9;

// A value and its partial derivatives with respect to the kNVar inputs.
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

// d rsqrt(x) = -x^(-3/2) / 2
__device__ __forceinline__ Dual rsqrt(const Dual& a) {
  Dual r;
  r.v = rsqrtf(a.v);
  const float slope = -0.5f * r.v * r.v * r.v;
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = slope * a.d[k];
  return r;
}

// max(a, 0) with the subgradient 0.5 at a tie, as jnp.maximum's
__device__ __forceinline__ Dual relu(const Dual& a) {
  Dual r;
  r.v = fmaxf(a.v, 0.0f);
  const float slope = a.v > 0.0f ? 1.0f : (a.v == 0.0f ? 0.5f : 0.0f);
#pragma unroll
  for (int k = 0; k < kNVar; ++k) r.d[k] = slope * a.d[k];
  return r;
}

// Add pixel i's cotangent terms to acc.
__device__ __forceinline__ void add_pixel_cotangent_ad(
    float (&acc)[kNGrad], const float* __restrict__ params, float g,
    float tsv, int64_t i, int n, float step, float extent) {
  if (!(tsv >= 0.0f)) {
    // a miss shades to ambient + 0: d img / d ambient = 1, nothing else
    // (:907-912 and the where(hit, ...) arm of the shade)
    acc[4] += g;
    return;
  }
  const int row = static_cast<int>(i / n);
  const int col = static_cast<int>(i - static_cast<int64_t>(row) * n);
  const Dual px = constant(pixel_coord(col, step, extent));
  const Dual py = constant(pixel_coord(row, step, extent));
  const Dual cx = variable(params[0], 0), cy = variable(params[1], 1);
  const Dual cz = variable(params[2], 2), rad = variable(params[3], 3);
  const Dual amb = variable(params[4], 4), gain = variable(params[5], 5);
  const Dual lx = variable(params[6], 6), ly = variable(params[7], 7);
  const Dual lz = variable(params[8], 8);
  const Dual t = variable(tsv, kVarT);  // a hit stores t itself

  // sdf(p, scene) = sqrt(|p - c|^2 + 1e-12) - radius at p = (px, py, -1+t)
  const Dual dx = px - cx, dy = py - cy;
  const Dual dz = (constant(-1.0f) + t) - cz;
  const Dual x = dx * dx + dy * dy + dz * dz + constant(1e-12f);
  const Dual q = rsqrt(x);
  const Dual sdf = x * q - rad;
  // the shade: the normal is grad_p sdf = d * rsqrt(x)
  const Dual gx = dx * q, gy = dy * q, gz = dz * q;
  const Dual inv = rsqrt(gx * gx + gy * gy + gz * gz + constant(1e-12f));
  const Dual lambert = relu((gx * lx + gy * ly + gz * lz) * inv);
  const Dual img = amb + lambert * gain;

  // the implicit root sdf(ray(t*), theta) = eps: dt*/dtheta . t_bar
  const float t_bar = g * img.d[kVarT];
  const float df_dt = sdf.d[kVarT];
  const float sgn = df_dt == 0.0f ? -1.0f : (df_dt > 0.0f ? 1.0f : -1.0f);
  const float slope = fabsf(df_dt) > 1e-6f ? df_dt : sgn;
  const float w = -t_bar / slope;
#pragma unroll
  for (int k = 0; k < kNGrad; ++k) acc[k] += g * img.d[k] + w * sdf.d[k];
}

__global__ void __launch_bounds__(kSumThreads)
sdf_bwd_ad_partial_kernel(const float* __restrict__ params,
                          const float* __restrict__ g_img,
                          const float* __restrict__ ts_img,
                          float* __restrict__ partial, int n, float step,
                          float extent) {
  const int64_t npix = static_cast<int64_t>(n) * n;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kSumThreads * kSumPixels) +
      threadIdx.x;
  float acc[kNGrad] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // one pixel at a time: the duals of one pixel fill the registers
#pragma unroll 1
  for (int j = 0; j < kSumPixels; ++j) {
    const int64_t i = base + static_cast<int64_t>(j) * kSumThreads;
    if (i < npix)
      add_pixel_cotangent_ad(acc, params, g_img[i], ts_img[i], i, n, step,
                             extent);
  }
  block_sum<kNGrad>(acc, partial + static_cast<int64_t>(blockIdx.x) * kNGrad);
}

}  // namespace

extern "C" {

// partial has sdf_bwd_num_blocks(n) rows of 9 (sdf_render.cu).
int sdf_bwd_ad_partial_launch(const float* params, const float* g,
                              const float* ts, float* partial, int n,
                              float step, float extent,
                              cudaStream_t stream) {
  sdf_bwd_ad_partial_kernel<<<sum_num_blocks(n), kSumThreads, 0, stream>>>(
      params, g, ts, partial, n, step, extent);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
