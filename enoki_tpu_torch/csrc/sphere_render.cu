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
// Numerics: sphere_fwd computes render/sphere.py's intersect_rays and
// shade_hits in their order and their dtype policy, and rounds each
// product and sum on its own (no FMA contraction), so that it is
// bit-equal to the plain PyTorch version (sphere_kernels.sphere_fwd_plain)
// in f32 and in bf16. It leaves out only operations whose result it knows
// exactly (below); c = dot3(oc, oc) - r*r keeps the order (xx + yy) + zz,
// since any other order moves silhouette pixels between hit and miss.

#include "common.cuh"
#include "pixel_sum.cuh"

namespace {

// threads per block and pixels per thread of sphere_fwd, in f32 and bf16
constexpr int kFwdThreads = 256, kFwdPixels = 4;
// ... and of sphere_bwd on the pixel-sum skeleton
constexpr int kSphereSumThreads = 256, kSphereSumPixels = 4;

// ---------------------------------------------------------------------------
// sphere_fwd -- replaces _sphere_fwd_kernel
// (enoki_tpu/render/pallas_kernels.py:100-105, which evaluates
// render/sphere.py:combined on a pixel tile).
//
// T = float computes in f32 and writes an f32 image; T = __nv_bfloat16
// follows the reference's bf16 policy (_read_scene :83-92, _tile_pixels
// :56-76, intersect_rays sphere.py:94-102): pixel coordinates in f32, then
// cast; the 9 parameters cast to bf16; every elementwise op rounded to
// bf16; discrim, sqrt, the halving and the hit mask in f32, t cast back;
// a bf16 image. The bf16 instantiation computes in native bf16 ops.
//
// Layout. blockIdx.x is the image row and blockIdx.y a segment of
// kThreads * kPixels consecutive pixels of it; thread t takes the
// segment's kPixels pixels from t * kPixels on, so that a warp's stores
// are neighbours. Row and column come from the grid in 32-bit arithmetic.
// A thread reads and converts the 9 parameters once and computes the
// row's terms once (FwdRow); a pixel then costs 19 rounded operations,
// the root and two selections. Where the wrapper passes vec != 0 (the
// rows start on a thread's bytes: n % 4 == 0 and img 16-byte aligned), a
// thread's 4 pixels are one store, of 16 bytes in f32 and 8 in bf16;
// otherwise every pixel is stored on its own. Timed on an H100, 256 x 4
// was the fastest of 128, 256 or 512 threads x 1, 2, 4 or 8 pixels
// in both dtypes (bf16 8 pixels, one 16-byte store, within 1%): what a
// thread does once is worth sharing among a few pixels, and a block's
// latency, not the bytes, sets the rest of the time (PERF.md §6).
//
// The operations left out, each exact for parameters whose quadratic
// stays finite (with d = (0, 0, 1) and o = (px, py, -1), make_rays):
//   a = dot3(d, d) = (0*0 + 0*0) + 1*1 = 1, so 4*a*c is 4*c and 2*a is 2;
//   dot3(oc, d) = (ocx*0 + ocy*0) + ocz*1: the first two products are
//     zeros, whose sum added to ocz is ocz (if ocz is 0 it is +0, as
//     -1 - cz is), so b = 2 * ocz, which is the same along the image;
//   x / 2 = x * 0.5 in f32 for every x (both are x * 2^-1 rounded once);
//   hit_p.x = (px + 0*t) - cx: 0*t is a zero (t is finite: the root is of
//     max(discrim, 0)) and px + zero is px (px = +0 at worst), so hit_p.x
//     is ocx, hit_p.y is ocy, and hit_p.z = (-1 + 1*t) - cz = (-1 + t) - cz;
//   where(valid, hit_p, 0): a miss's normal is 0, its dot with the light a
//     zero and its lambert 0, so one selection, valid && n.l > 0, takes n.l
//     or 0.
// What is the same along a row (py, ocy, ocz, b, b^2, ocy^2, ocz^2, r^2,
// ocy * ly) is computed once a thread.
//
// Bound on this card: bytes in f32 (4 B written per pixel) and in bf16
// (2 B per pixel, the operations at the card's bf16 rate outside the
// tensor cores). The kernel reads nothing per pixel, keeps everything in
// registers and writes each pixel once.
// ---------------------------------------------------------------------------

// The parameters a pixel reads, in T, and the terms of one image row.
template <typename T>
struct FwdRow {
  T cx, cz, amb, gain, lx, lz;
  T ocy2, ocz2, r2, b2, ocy_ly;
  float nb;  // -b in f32
};

template <typename T>
__device__ __forceinline__ FwdRow<T> fwd_row(const float* params, int row,
                                              float step, float extent) {
  using O = Ops<T>;
  const T cx = O::of(params[0]), cy = O::of(params[1]);
  const T cz = O::of(params[2]), rad = O::of(params[3]);
  const T ly = O::of(params[7]);
  const T ocy = O::sub(O::of(pixel_coord(row, step, extent)), cy);
  const T ocz = O::sub(O::of(-1.0f), cz);
  const T b = O::mul(O::of(2.0f), ocz);
  return FwdRow<T>{cx, cz, O::of(params[4]), O::of(params[5]),
                   O::of(params[6]), O::of(params[8]), O::mul(ocy, ocy),
                   O::mul(ocz, ocz), O::mul(rad, rad), O::mul(b, b),
                   O::mul(ocy, ly), -O::f32(b)};
}

// The image value of pixel col of row r.
template <typename T>
__device__ __forceinline__ T sphere_pixel(const FwdRow<T>& r, int col,
                                          float step, float extent) {
  using O = Ops<T>;
  // intersect_rays: c = |oc|^2 - r^2, discrim = b^2 - 4c
  const T ocx = O::sub(O::of(pixel_coord(col, step, extent)), r.cx);
  const T c = O::sub(O::add(O::add(O::mul(ocx, ocx), r.ocy2), r.ocz2), r.r2);
  const float d32 = O::f32(O::sub(r.b2, O::mul(O::of(4.0f), c)));
  const T t = O::of(mul(add(r.nb, __fsqrt_rn(fmaxf(d32, 0.0f))), 0.5f));
  const T hz = O::sub(O::add(O::of(-1.0f), t), r.cz);
  // shade_hits: ambient + max(n . light, 0) * gain, n = 0 on a miss
  const T s = O::add(O::add(O::mul(ocx, r.lx), r.ocy_ly), O::mul(hz, r.lz));
  const T lambert = d32 >= 0.0f && O::f32(s) > 0.0f ? s : O::of(0.0f);
  return O::add(r.amb, O::mul(lambert, r.gain));
}

// A pixel's raw bits, to be packed into 32-bit words.
__device__ __forceinline__ unsigned pixel_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned pixel_bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// v[0..kPixels-1] to p, which is aligned to the bytes they take (at most
// 16): 16-byte stores where they fill them, else one 8- or 4-byte store,
// else (one bf16) a plain store.
template <typename T, int kPixels>
__device__ __forceinline__ void store_vector(T* p, const T (&v)[kPixels]) {
  constexpr int kPerWord = 4 / sizeof(T);
  constexpr int kWords = kPixels / kPerWord;
  if constexpr (kWords == 0) {
    p[0] = v[0];
  } else {
    unsigned w[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      w[k] = 0u;
#pragma unroll
      for (int e = 0; e < kPerWord; ++e)
        w[k] |= pixel_bits(v[k * kPerWord + e]) << (32 / kPerWord * e);
    }
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int k = 0; k < kWords; k += 4)
        reinterpret_cast<uint4*>(p)[k / 4] =
            make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
    } else if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      static_assert(kWords == 1, "1, 2 or a multiple of 4 words");
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

template <typename T, int kThreads, int kPixels>
__global__ void __launch_bounds__(kThreads)
sphere_fwd_kernel(const float* __restrict__ params, T* __restrict__ img,
                  int n, float step, float extent, int vec) {
  const int row = blockIdx.x;
  const int col0 = blockIdx.y * (kThreads * kPixels) + threadIdx.x * kPixels;
  if (col0 >= n) return;
  const FwdRow<T> r = fwd_row<T>(params, row, step, extent);
  T v[kPixels];
#pragma unroll
  for (int e = 0; e < kPixels; ++e)
    v[e] = sphere_pixel<T>(r, col0 + e, step, extent);
  T* out = img + static_cast<size_t>(row) * n + col0;
  if (vec) {
    store_vector<T, kPixels>(out, v);
  } else {
#pragma unroll
    for (int e = 0; e < kPixels; ++e)
      if (col0 + e < n) out[e] = v[e];
  }
}

// ---------------------------------------------------------------------------
// sphere_bwd -- replaces _sphere_bwd_kernel
// (enoki_tpu/render/pallas_kernels.py:108-126).
//
// One launch of the pixel-sum skeleton (pixel_sum.cuh) with SpherePixel,
// which reads no ts: the skeleton loads g alone and SpherePixel makes the
// hit test itself. The TPU kernel recomputes the f32 render per tile and
// takes an in-kernel jax.vjp; CUDA has no in-kernel autodiff, so each
// pixel adds the cotangent of the 9 parameters in closed form, following
// the forward's graph (a = 1 and b = 2 ocz exactly, as in sphere_fwd):
//   t = (-b + safe_sqrt(D)) / 2,  D = b^2 - 4c,  c = |oc|^2 - r^2
//   n = valid ? (ocx, ocy, -1 + t - cz) : 0,  img = amb + max(n.l, 0) gain
// safe_sqrt's gradient is 0 at D <= 0; max(., 0) takes a subgradient of
// 0.5 at a tie; a miss (n = 0) adds only g to d ambient. The backward is
// always f32: the reference casts g to f32 and recomputes at the f32
// parameters (:108-116), so a bf16 forward gets the f32 render's gradient.
// There is no residual: everything is recomputed from the parameters.
// The hit mask and n.l are rounded as sphere_fwd rounds them in f32, so
// that the mask and the relu's tie are the forward's.
//
// The TPU kernel accumulates in SMEM across its sequential grid
// (:118-126); here the blocks' rows and the block that draws the last
// ticket sum them in row order in the same launch (pixel_sum.cuh), never
// by a float atomicAdd: the gradients are bitwise identical from run to
// run. The ticket counter is the one sdf_bwd and sdf_bwd_ad take on the
// same stream: launches on one stream run in order, and each sets it back
// to 0 before the next starts.
//
// Bound on this card: bytes (4 B of g read per pixel; ~20 FP32 operations
// per pixel and ~52 more per hit). The skeleton alone (g summed, no
// pixel's terms) takes about two thirds of the time, the hits' terms
// most of the rest (PERF.md §6).
// ---------------------------------------------------------------------------
struct SpherePixel {
  static constexpr bool kReadsTs = false;

  struct Scene {
    float cx, cy, cz, rad, gain, lx, ly, lz;
  };

  // the terms that are the same along a row, rounded as sphere_fwd
  // rounds them in f32
  struct Row {
    float ocy, ocz, b, b2, ocy2, ocz2, r2, ocy_ly;
  };

  __device__ __forceinline__ static Scene scene(const float* params) {
    return Scene{params[0], params[1], params[2], params[3],
                 params[5], params[6], params[7], params[8]};
  }

  __device__ __forceinline__ static Row row(const Scene& sc, int row,
                                            float step, float extent) {
    const float ocy = __fsub_rn(pixel_coord(row, step, extent), sc.cy);
    const float ocz = __fsub_rn(-1.0f, sc.cz);
    const float b = mul(2.0f, ocz);
    return Row{ocy, ocz, b, mul(b, b), mul(ocy, ocy), mul(ocz, ocz),
               mul(sc.rad, sc.rad), mul(ocy, sc.ly)};
  }

  // Add pixel col's cotangent terms for the image cotangent g to acc.
  __device__ __forceinline__ static void pixel(const Scene& sc,
                                               const Row& r, float g,
                                               int col, float step,
                                               float extent,
                                               float (&acc)[kNGrad]) {
    acc[4] += g;  // d ambient: every pixel, hit or miss
    // the f32 forward up to the hit mask, rounded as sphere_fwd rounds it
    const float ocx = __fsub_rn(pixel_coord(col, step, extent), sc.cx);
    const float c = __fsub_rn(add(add(mul(ocx, ocx), r.ocy2), r.ocz2), r.r2);
    const float disc = __fsub_rn(r.b2, mul(4.0f, c));
    if (!(disc >= 0.0f)) return;  // a miss contributes nothing else
    const float sq = __fsqrt_rn(disc);
    const float hz = __fsub_rn(add(-1.0f, mul(add(-r.b, sq), 0.5f)), sc.cz);
    const float s = add(add(mul(ocx, sc.lx), r.ocy_ly), mul(hz, sc.lz));
    // the shade: relu subgradient 0.5 at a tie, as jnp.maximum's
    const float relu_g = s > 0.0f ? 1.0f : (s == 0.0f ? 0.5f : 0.0f);
    const float m = g * sc.gain * relu_g;  // cotangent of s = n . l
    acc[5] += g * fmaxf(s, 0.0f);
    acc[6] += m * ocx;
    acc[7] += m * r.ocy;
    acc[8] += m * hz;
    // cotangent of n = hit_p; through hz it reaches t with slope 1
    const float dhx = m * sc.lx, dhy = m * sc.ly, dhz = m * sc.lz;
    // t = (-b + sqrt(D)) / 2: dt/dD = 1 / (4 sqrt(D)), 0 where D = 0;
    // by the MUFU reciprocal (2 ulp; sq is normal and below 2^126 for any
    // finite D > 0), 8% of the kernel's time against the IEEE division
    const float dd = disc > 0.0f ? __fdividef(dhz * 0.25f, sq) : 0.0f;
    const float dc = -4.0f * dd;                     // D = b^2 - 4c
    const float db = -0.5f * dhz + 2.0f * r.b * dd;  // through t and D
    // oc = o - c, c = |oc|^2 - r^2, b = 2 ocz
    acc[0] -= dhx + 2.0f * ocx * dc;
    acc[1] -= dhy + 2.0f * r.ocy * dc;
    acc[2] -= dhz + 2.0f * r.ocz * dc + 2.0f * db;
    acc[3] -= 2.0f * sc.rad * dc;
  }
};

template <typename T, int kThreads, int kPixels>
int sphere_fwd_launch_as(const float* params, void* img, int n, float step,
                         float extent, int vec, cudaStream_t stream) {
  constexpr int kSegment = kThreads * kPixels;
  const dim3 grid(n, (n + kSegment - 1) / kSegment);
  // a thread's pixels are wholly inside the row or past its end
  vec = vec && n % kPixels == 0;
  sphere_fwd_kernel<T, kThreads, kPixels><<<grid, kThreads, 0, stream>>>(
      params, static_cast<T*>(img), n, step, extent, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: a thread's pixels may take one store (see sphere_fwd_kernel)
int sphere_fwd_launch(const float* params, void* img, int n, float step,
                      float extent, int vec, cudaStream_t stream) {
  return sphere_fwd_launch_as<float, kFwdThreads, kFwdPixels>(
      params, img, n, step, extent, vec, stream);
}

int sphere_fwd_bf16_launch(const float* params, void* img, int n,
                           float step, float extent, int vec,
                           cudaStream_t stream) {
  return sphere_fwd_launch_as<__nv_bfloat16, kFwdThreads, kFwdPixels>(
      params, img, n, step, extent, vec, stream);
}

int sphere_bwd_num_blocks(int n) {
  return pixel_sum_num_blocks<kSphereSumThreads, kSphereSumPixels>(n);
}

// partial has sphere_bwd_num_blocks(n) rows of 9, ticket is 0 (and is 0
// again when the launch ends); vec: see pixel_sum.cuh.
int sphere_bwd_launch(const float* params, const float* g, float* partial,
                      unsigned* ticket, float* dp, int n, float step,
                      float extent, int vec, cudaStream_t stream) {
  return pixel_sum_launch<SpherePixel, kSphereSumThreads, kSphereSumPixels>(
      params, g, nullptr, partial, ticket, dp, n, step, extent, vec, stream);
}

}  // extern "C"
