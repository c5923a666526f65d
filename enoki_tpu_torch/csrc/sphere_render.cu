// Closed-form sphere render (the ray-sphere quadratic and Lambert shade of
// the reference mini-app, tests/sphere.cpp): forward kernels in f32 and
// bf16 compute and the analytic backward, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (enoki_tpu_torch/_build.py).
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
//
// Scene parameters are a device vector of 16 floats
// [cx, cy, cz, radius, ambient, gain, lx, ly, lz, 0 x 7]; every thread
// reads them from device memory, so a training loop never syncs the host.
//
// Numerics: sphere_fwd repeats render/sphere.py's intersect_rays and
// shade_hits operation by operation, in their order and their dtype
// policy, and rounds each product and sum on its own (no FMA
// contraction), so that it is bit-equal to the plain PyTorch version
// (sphere_kernels.sphere_fwd_plain) in f32 and in bf16. The quadratic is
// not simplified: a = dot3(d, d) and b = 2 dot3(oc, d) are computed as
// written, and c = dot3(oc, oc) - r*r in the order (xx + yy) + zz, since
// any other order moves silhouette pixels between hit and miss.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// sphere_fwd -- replaces _sphere_fwd_kernel
// (enoki_tpu/render/pallas_kernels.py:100-105, which evaluates
// render/sphere.py:combined on a pixel tile).
//
// One thread per pixel on a 2-D grid, x along columns, y along rows.
// T = float computes in f32 and writes an f32 image; T = __nv_bfloat16
// follows the reference's bf16 policy (_read_scene :83-92, _tile_pixels
// :56-76, intersect_rays sphere.py:94-102): pixel coordinates in f32, then
// cast; the 9 parameters cast to bf16; every elementwise op rounded to
// bf16; discrim, sqrt, the divide and the hit mask in f32, t cast back;
// a bf16 image.
//
// Bound on this card: bytes in f32 (4 B written per pixel, ~56 FP32
// operations) and in bf16 (2 B per pixel, the same operations at the
// card's bf16 rate outside the tensor cores). The kernel reads
// nothing per pixel, keeps everything in registers and writes each pixel
// once, coalesced along a warp's row. The bf16 instantiation computes in
// native bf16 ops: an earlier build that rounded each f32 op through
// __float2bfloat16_rn spent ~45 conversions per pixel and took 2.7x the
// f32 kernel's time (PERF.md).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
sphere_fwd_kernel(const float* __restrict__ params, T* __restrict__ img,
                  int n, float step, float extent) {
  using O = Ops<T>;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= n || row >= n) return;

  const T cx = O::of(params[0]), cy = O::of(params[1]);
  const T cz = O::of(params[2]), rad = O::of(params[3]);
  const T amb = O::of(params[4]), gain = O::of(params[5]);
  const T lx = O::of(params[6]), ly = O::of(params[7]);
  const T lz = O::of(params[8]);
  const T px = O::of(pixel_coord(col, step, extent));
  const T py = O::of(pixel_coord(row, step, extent));
  const T zero = O::of(0.0f), one = O::of(1.0f);

  // make_rays: o = (px, py, -1), d = (0, 0, 1)
  const T oz = O::of(-1.0f), dx = zero, dy = zero, dz = one;

  // intersect_rays
  const T ocx = O::sub(px, cx), ocy = O::sub(py, cy), ocz = O::sub(oz, cz);
  const T a = tdot3<O>(dx, dy, dz, dx, dy, dz);
  const T b = O::mul(O::of(2.0f), tdot3<O>(ocx, ocy, ocz, dx, dy, dz));
  const T c = O::sub(tdot3<O>(ocx, ocy, ocz, ocx, ocy, ocz),
                     O::mul(rad, rad));
  const T discrim = O::sub(O::mul(b, b), O::mul(O::mul(O::of(4.0f), a), c));
  // discrim, the sqrt, the divide and the mask in f32 whatever the
  // compute type, t cast back
  const float d32 = O::f32(discrim);
  const T t = O::of(__fdiv_rn(add(-O::f32(b), __fsqrt_rn(fmaxf(d32, 0.0f))),
                              mul(2.0f, O::f32(a))));
  const bool valid = d32 >= 0.0f;
  // hit_p = r.at(t) - center = (o + d * t) - center; a miss is 0
  const T hx = O::sub(O::add(px, O::mul(dx, t)), cx);
  const T hy = O::sub(O::add(py, O::mul(dy, t)), cy);
  const T hz = O::sub(O::add(oz, O::mul(dz, t)), cz);
  const T nx = valid ? hx : zero, ny = valid ? hy : zero;
  const T nz = valid ? hz : zero;

  // shade_hits: ambient + max(dot3(n, light), 0) * gain
  const T s = tdot3<O>(nx, ny, nz, lx, ly, lz);
  const T lambert = O::f32(s) > 0.0f ? s : zero;
  img[static_cast<size_t>(row) * n + col] =
      O::add(amb, O::mul(lambert, gain));
}

// ---------------------------------------------------------------------------
// sphere_bwd -- replaces _sphere_bwd_kernel
// (enoki_tpu/render/pallas_kernels.py:108-126).
//
// The TPU kernel recomputes the f32 render per tile and takes an in-kernel
// jax.vjp; CUDA has no in-kernel autodiff, so each thread writes the
// cotangent of the 9 parameters in closed form, following the forward's
// graph (a = 1 and b = 2 ocz exactly):
//   t = (-b + safe_sqrt(D)) / 2,  D = b^2 - 4c,  c = |oc|^2 - r^2
//   n = valid ? (ocx, ocy, -1 + t - cz) : 0,  img = amb + max(n.l, 0) gain
// safe_sqrt's gradient is 0 at D <= 0; max(., 0) takes a subgradient of
// 0.5 at a tie; a miss (n = 0) adds only g to d ambient. The backward is
// always f32: the reference casts g to f32 and recomputes at the f32
// parameters (:108-116), so a bf16 forward gets the f32 render's gradient.
// There is no residual: everything is recomputed from the parameters.
//
// Pass 1 (sphere_bwd_partial_kernel): each thread takes kSumPixels pixels
// (row-major, a block covers kSumThreads * kSumPixels consecutive ones)
// and the block writes its 9 sums as one row of partial[num_blocks][9].
// Pass 2 (reduce_rows_kernel, common.cuh): one block sums the rows in a
// fixed order into dp[16]. The TPU kernel accumulates in SMEM across its
// sequential grid (:118-126); blocks here run in parallel and in no order,
// so the cross-block sum is a second pass instead, and never a float
// atomicAdd: the gradients are bitwise identical from run to run.
//
// Bound on this card: bytes (4 B of g read per pixel; ~20 FP32 operations
// per pixel and ~52 more per hit). Each thread issues its loads for all
// its pixels before it computes, so that enough bytes are in flight.
// ---------------------------------------------------------------------------
struct Scene {
  float cx, cy, cz, rad, gain, lx, ly, lz;
};

// Add pixel i's cotangent terms to acc.
__device__ __forceinline__ void add_pixel_cotangent(
    float (&acc)[kNGrad], const Scene& sc, float g, int64_t i, int n,
    float step, float extent) {
  acc[4] += g;  // d ambient: every pixel, hit or miss
  const int row = static_cast<int>(i / n);
  const int col = static_cast<int>(i - static_cast<int64_t>(row) * n);
  // the f32 forward up to the hit mask, rounded as sphere_fwd rounds it,
  // so that the mask is the forward's
  const float ocx = __fsub_rn(pixel_coord(col, step, extent), sc.cx);
  const float ocy = __fsub_rn(pixel_coord(row, step, extent), sc.cy);
  const float ocz = __fsub_rn(-1.0f, sc.cz);
  const float b = mul(2.0f, ocz);
  const float c = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz),
                            mul(sc.rad, sc.rad));
  const float disc = __fsub_rn(mul(b, b), mul(4.0f, c));
  if (!(disc >= 0.0f)) return;  // a miss contributes nothing else
  const float sq = __fsqrt_rn(disc);
  const float hz = __fsub_rn(add(-1.0f, mul(add(-b, sq), 0.5f)), sc.cz);
  const float s = dot3(ocx, ocy, hz, sc.lx, sc.ly, sc.lz);
  // the shade: relu subgradient 0.5 at a tie, as jnp.maximum's
  const float relu_g = s > 0.0f ? 1.0f : (s == 0.0f ? 0.5f : 0.0f);
  const float m = g * sc.gain * relu_g;  // cotangent of s = n . l
  acc[5] += g * fmaxf(s, 0.0f);
  acc[6] += m * ocx;
  acc[7] += m * ocy;
  acc[8] += m * hz;
  // cotangent of n = hit_p; through hz it reaches t with slope 1
  const float dhx = m * sc.lx, dhy = m * sc.ly, dhz = m * sc.lz;
  // t = (-b + sqrt(D)) / 2: dt/dD = 1 / (4 sqrt(D)), 0 where D = 0
  const float dd = disc > 0.0f ? dhz * 0.25f / sq : 0.0f;
  const float dc = -4.0f * dd;                   // D = b^2 - 4c
  const float db = -0.5f * dhz + 2.0f * b * dd;  // through t and D
  // oc = o - c, c = |oc|^2 - r^2, b = 2 ocz
  acc[0] -= dhx + 2.0f * ocx * dc;
  acc[1] -= dhy + 2.0f * ocy * dc;
  acc[2] -= dhz + 2.0f * ocz * dc + 2.0f * db;
  acc[3] -= 2.0f * sc.rad * dc;
}

__global__ void __launch_bounds__(kSumThreads)
sphere_bwd_partial_kernel(const float* __restrict__ params,
                          const float* __restrict__ g_img,
                          float* __restrict__ partial, int n, float step,
                          float extent) {
  const Scene sc{params[0], params[1], params[2], params[3],
                 params[5], params[6], params[7], params[8]};
  const int64_t npix = static_cast<int64_t>(n) * n;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kSumThreads * kSumPixels) +
      threadIdx.x;
  float g[kSumPixels];
#pragma unroll
  for (int j = 0; j < kSumPixels; ++j) {
    const int64_t i = base + static_cast<int64_t>(j) * kSumThreads;
    g[j] = i < npix ? g_img[i] : 0.0f;
  }
  float acc[kNGrad] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kSumPixels; ++j) {
    const int64_t i = base + static_cast<int64_t>(j) * kSumThreads;
    if (i < npix) add_pixel_cotangent(acc, sc, g[j], i, n, step, extent);
  }
  block_sum<kNGrad>(acc, partial + static_cast<int64_t>(blockIdx.x) * kNGrad);
}

template <typename T>
int sphere_fwd_launch_as(const float* params, void* img, int n, float step,
                         float extent, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((n + 31) / 32, (n + 7) / 8);
  sphere_fwd_kernel<T><<<grid, block, 0, stream>>>(
      params, static_cast<T*>(img), n, step, extent);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sphere_fwd_launch(const float* params, void* img, int n, float step,
                      float extent, cudaStream_t stream) {
  return sphere_fwd_launch_as<float>(params, img, n, step, extent, stream);
}

int sphere_fwd_bf16_launch(const float* params, void* img, int n,
                           float step, float extent, cudaStream_t stream) {
  return sphere_fwd_launch_as<__nv_bfloat16>(params, img, n, step, extent,
                                             stream);
}

int sphere_bwd_num_blocks(int n) { return sum_num_blocks(n); }

int sphere_bwd_partial_launch(const float* params, const float* g,
                              float* partial, int n, float step,
                              float extent, cudaStream_t stream) {
  sphere_bwd_partial_kernel<<<sum_num_blocks(n), kSumThreads, 0, stream>>>(
      params, g, partial, n, step, extent);
  return static_cast<int>(cudaGetLastError());
}

int sphere_bwd_reduce_launch(const float* partial, int num_rows, float* dp,
                             cudaStream_t stream) {
  return reduce_rows_launch<kNGrad, 16>(partial, num_rows, dp, stream);
}

}  // extern "C"
