// The skeleton of a backward that sums a per-pixel cotangent of the 9 live
// scene parameters over an n x n image into dp[16], in one launch, bitwise
// the same on every run: sdf_bwd (sdf_render.cu), sdf_bwd_ad
// (sdf_bwd_ad.cu) and sphere_bwd (sphere_render.cu) instantiate it with
// their own per-pixel functions.
//
// A per-pixel function F provides
//   struct F::Scene;                                 what a pixel reads
//   static F::Scene F::scene(const float* params);
//   static constexpr bool F::kReadsTs;
// and, if F::kReadsTs (a march's backward, whose forward left the hit
// distance ts of each pixel, < 0 on a miss),
//   static void F::hit(const F::Scene&, float g, float t, int col,
//                      float py, float step, float extent,
//                      float (&d)[kNGrad]);     a hit pixel's 9 terms
// (a miss adds g to d ambient, dp[4], and nothing else); else (a closed
// form that makes its hit test itself, from the parameters alone)
//   struct F::Row;                            the terms a row shares
//   static F::Row F::row(const F::Scene&, int row, float step,
//                        float extent);
//   static void F::pixel(const F::Scene&, const F::Row&, float g, int col,
//                        float step, float extent,
//                        float (&acc)[kNGrad]);  adds the pixel's terms
// and the skeleton reads no ts (ts_img may be null).
//
// Layout. blockIdx.x is the image row and blockIdx.y a segment of
// kThreads * kPixels consecutive pixels of it; a thread takes kPixels of
// them in chunks of kVec consecutive pixels, its chunk j being the
// segment's chunk j * kThreads + threadIdx.x, so that a warp's chunks are
// neighbours. Row and column come from the grid and 32-bit arithmetic: no
// 64-bit division. Every thread issues the loads of all its pixels before
// it adds any of them. sdf_bwd and sdf_bwd_ad take 256 threads x 4
// pixels (kPixelSumThreads, kPixelSumPixels): at 1024^2 the grid is 1024
// blocks, 1.55 waves at the 5 blocks an SM that ptxas's 46 registers leave;
// no geometry timed on an H100 was faster (2 or 8 pixels, 128 to 1024
// threads, registers capped to fit more blocks, a resident grid striding
// over the image): a block's latency, not the bytes, sets the time
// (PERF.md §6). sphere_bwd sets its own (sphere_render.cu).
//
// Loads. Where the wrapper passes vec != 0 (n % 4 == 0 and g and ts, where
// read, 16-byte aligned), a chunk is one vector load of g and one of ts,
// wholly inside the row or wholly past its end. Otherwise every pixel is
// loaded on its own, and a pixel past the row's end is a miss with g = 0
// (F::kReadsTs) or is skipped.
//
// The cross-block sum, in the same launch. Each block sums its values in a
// fixed order (block_sum) and writes them as one row of
// partial[num_blocks][9], fences, and takes a ticket from an unsigned
// counter; the block that draws the last ticket sums every row in row
// order, thread t the rows t, t + kThreads, ..., then the block's fixed
// order (reduce_rows_kernel's order), writes dp[0..8] and zeros
// dp[9..15], and sets the counter back to 0 for the next launch on the
// stream. Which block ends last changes nothing in the sum; there are no
// float atomics. The counter is the wrapper's, one per device and stream,
// zeroed once when it is allocated; launches on one stream run in order,
// so every instantiation may share the stream's counter.

#pragma once

#include "common.cuh"

namespace {

// threads per block and pixels per thread of sdf_bwd and sdf_bwd_ad
constexpr int kPixelSumThreads = 256, kPixelSumPixels = 4;

// Segments of a row: blocks along blockIdx.y.
template <int kThreads, int kPixels>
inline int pixel_sum_segments(int n) {
  constexpr int kSegment = kThreads * kPixels;
  return (n + kSegment - 1) / kSegment;
}

template <int kThreads, int kPixels>
inline int pixel_sum_num_blocks(int n) {
  return n * pixel_sum_segments<kThreads, kPixels>(n);
}

// The last of num_rows blocks to get here sums partial's rows into dp.
// Every thread of the block calls it, after the block's row is written.
template <int kThreads>
__device__ __forceinline__ void last_block_sum(const float* partial,
                                               int num_rows,
                                               unsigned* ticket, float* dp) {
  __shared__ bool last;
  // the row's writers (block_sum's threads 0..8, all of warp 0) make it
  // visible before the ticket is drawn; a fence in every warp costs 3%
  if (threadIdx.x < kNGrad) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(num_rows - 1);
  __syncthreads();
  if (!last) return;
  float acc[kNGrad];
#pragma unroll
  for (int k = 0; k < kNGrad; ++k) acc[k] = 0.0f;
  // from L2 (__ldcg): this SM's L1 may hold no other block's row
#pragma unroll 4
  for (int r = threadIdx.x; r < num_rows; r += kThreads) {
#pragma unroll
    for (int k = 0; k < kNGrad; ++k)
      acc[k] += __ldcg(partial + r * kNGrad + k);
  }
  block_sum<kNGrad, kThreads>(acc, dp);
  if (threadIdx.x >= kNGrad && threadIdx.x < 16) dp[threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) *ticket = 0u;
}

// a chunk of kVec consecutive floats in one load (a thread's pixels come
// in chunks of 4)
template <int kVec>
struct VecLoad;

template <>
struct VecLoad<4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};

template <class F, int kThreads, int kPixels>
__global__ void __launch_bounds__(kThreads)
pixel_sum_kernel(const float* __restrict__ params,
                 const float* __restrict__ g_img,
                 const float* __restrict__ ts_img, float* __restrict__ partial,
                 unsigned* __restrict__ ticket, float* __restrict__ dp, int n,
                 float step, float extent, int vec) {
  constexpr int kVec = kPixels < 4 ? kPixels : 4;
  constexpr int kChunks = kPixels / kVec;
  static_assert(kPixels % kVec == 0, "whole chunks");
  const typename F::Scene sc = F::scene(params);
  const int row = blockIdx.x;
  const int seg = blockIdx.y * (kThreads * kPixels);
  const float* g_row = g_img + static_cast<size_t>(row) * n;
  const float* ts_row =
      F::kReadsTs ? ts_img + static_cast<size_t>(row) * n : nullptr;
  float gv[kPixels], tv[kPixels];
  if (vec) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = seg + (j * kThreads + threadIdx.x) * kVec;
      if (col < n) {
        VecLoad<kVec>::load(g_row + col, gv + j * kVec);
        if constexpr (F::kReadsTs)
          VecLoad<kVec>::load(ts_row + col, tv + j * kVec);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          gv[j * kVec + e] = 0.0f;
          tv[j * kVec + e] = -1.0f;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = seg + (j * kThreads + threadIdx.x) * kVec + e;
        gv[j * kVec + e] = col < n ? g_row[col] : 0.0f;
        if constexpr (F::kReadsTs)
          tv[j * kVec + e] = col < n ? ts_row[col] : -1.0f;
      }
    }
  }
  float acc[kNGrad];
#pragma unroll
  for (int k = 0; k < kNGrad; ++k) acc[k] = 0.0f;
  if constexpr (F::kReadsTs) {
    const float py = pixel_coord(row, step, extent);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = seg + (j * kThreads + threadIdx.x) * kVec + e;
        const float g = gv[j * kVec + e], t = tv[j * kVec + e];
        if (t >= 0.0f) {  // a hit stores t itself
          float d[kNGrad];
          F::hit(sc, g, t, col, py, step, extent, d);
#pragma unroll
          for (int k = 0; k < kNGrad; ++k) acc[k] += d[k];
        } else {
          acc[4] += g;
        }
      }
    }
  } else {
    const typename F::Row r = F::row(sc, row, step, extent);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = seg + (j * kThreads + threadIdx.x) * kVec + e;
        if (col < n)
          F::pixel(sc, r, gv[j * kVec + e], col, step, extent, acc);
      }
    }
  }
  const int num_rows = gridDim.x * gridDim.y;
  block_sum<kNGrad, kThreads>(
      acc, partial + (blockIdx.x * gridDim.y + blockIdx.y) * kNGrad);
  last_block_sum<kThreads>(partial, num_rows, ticket, dp);
}

// partial has pixel_sum_num_blocks(n) rows of 9; ticket is 0; ts may be
// null where F reads none.
template <class F, int kThreads, int kPixels>
int pixel_sum_launch(const float* params, const float* g, const float* ts,
                     float* partial, unsigned* ticket, float* dp, int n,
                     float step, float extent, int vec, cudaStream_t stream) {
  const dim3 grid(n, pixel_sum_segments<kThreads, kPixels>(n));
  pixel_sum_kernel<F, kThreads, kPixels><<<grid, kThreads, 0, stream>>>(
      params, g, ts, partial, ticket, dp, n, step, extent, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
