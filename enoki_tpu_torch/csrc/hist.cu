// Dense histogram, hist[b] = sum_i (idx_i == b) * w_i, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (enoki_tpu_torch/_build.py). Each entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Replaces _hist_kernel (enoki_tpu/ops/pallas_hist.py:44, called from
// _hist_pallas :67-82). What is kept of it is the function: int32 indices
// and f32 weights in, `bins` f32 sums out, an index outside [0, bins)
// matches no bin. Its form is not kept: (rows, 128) tiles with the bins on
// the lane axis, a 128-step column loop and one accumulator revisited
// across a sequential grid are that compiler's layout limits. Here blocks
// run in parallel and nothing carries over between them.
//
// Bound on this card: bytes. The function reads 4 B per sample (8 B with
// weights) and needs two compares and an add for each; the output is a
// few hundred bytes.
//
// Design: bitwise the same result from run to run, weighted too, so no
// float atomicAdd anywhere, neither to device memory nor to shared memory.
//  - Every warp walks a fixed, contiguous strip of the samples (a block
//    takes kHistPerBlock of them, each warp 1/8 of that), 32 at a time,
//    coalesced.
//  - Per 32 samples, __match_any_sync groups the lanes that hit the same
//    bin. Heavy contention is the normal case (a normal distribution puts
//    a third of the samples into 6 of 64 bins), and this turns a 32-way
//    conflict into one add. Each group's lowest lane sums the group's
//    weights in lane order (a counting histogram adds the group's size
//    and reads no weight) and adds the sum, without an atomic, to the
//    warp's private row in shared memory: the leaders of one round hold
//    distinct bins, and __syncwarp orders the rounds.
//  - The block sums its warps' rows in warp order into one row of
//    `partial`; hist_reduce sums those rows in a fixed order. The grid
//    depends on N alone, so equal inputs take equal sums on every run.
// A counting histogram's f32 sums are integers: exact up to 2^24 a bin.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistRounds = 64;   // rounds of 32 samples in a warp's strip
constexpr int kHistUnroll = 4;    // rounds whose loads are issued together
constexpr int64_t kHistPerWarp = 32 * kHistRounds;
constexpr int64_t kHistPerBlock = kHistWarps * kHistPerWarp;
// kHistWarps rows of `bins` floats within the 227 KiB a block may use
constexpr int kHistMaxBins = 7168;
constexpr int kReduceBins = 32;   // bins of a reduce block (x)
constexpr int kReduceRows = 32;   // row groups of a reduce block (y)

static_assert(kHistRounds % kHistUnroll == 0, "whole groups of rounds");
static_assert(kHistMaxBins * kHistWarps * sizeof(float) <= 232448,
              "a block's rows must fit its shared memory");

template <bool kWeighted>
__global__ void __launch_bounds__(kHistThreads)
hist_partial_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                    int64_t n, int bins, float* __restrict__ partial) {
  extern __shared__ float rows[];  // [kHistWarps][bins]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* row = rows + warp * bins;
  for (int b = lane; b < bins; b += 32) row[b] = 0.0f;
  __syncwarp();

  const int64_t strip =
      static_cast<int64_t>(blockIdx.x) * kHistPerBlock + warp * kHistPerWarp;
  for (int r0 = 0; r0 < kHistRounds; r0 += kHistUnroll) {
    if (strip + static_cast<int64_t>(r0) * 32 >= n) break;  // whole warp
    int key[kHistUnroll];
    float val[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t i = strip + static_cast<int64_t>(r0 + u) * 32 + lane;
      int b = -1;
      float v = 0.0f;
      if (i < n) {
        b = idx[i];
        if (kWeighted) v = w[i];
      }
      // a dropped lane gets a key of its own, so that it groups with none
      key[u] = (b >= 0 && b < bins) ? b : -1 - lane;
      val[u] = v;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      float s;
      if (kWeighted) {
        // every lane's weight in lane order, a lane outside the group
        // masked to +0.0 on its bit pattern: no select and no predicate
        // (a predicated add here, unrolled 32 x 4 times beside the early
        // exit above, failed ptxas 12.9's register allocation)
        s = 0.0f;
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          const unsigned wl =
              __float_as_uint(__shfl_sync(0xffffffffu, val[u], l));
          s = __fadd_rn(s, __uint_as_float(wl & (0u - ((peers >> l) & 1u))));
        }
      } else {
        s = static_cast<float>(__popc(peers));
      }
      if (key[u] >= 0 && lane == __ffs(peers) - 1)
        row[key[u]] = __fadd_rn(row[key[u]], s);
      __syncwarp();
    }
  }
  __syncthreads();

  float* out = partial + static_cast<int64_t>(blockIdx.x) * bins;
  for (int b = threadIdx.x; b < bins; b += kHistThreads) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kHistWarps; ++k) s = __fadd_rn(s, rows[k * bins + b]);
    out[b] = s;
  }
}

// The second pass: out[b] = the sum of partial[0..num_rows-1][b], in a
// fixed order: thread (x, y) sums the rows y, y + 32, ... of its bin, then
// thread (x, 0) sums the 32 row groups in order. The width is a run-time
// value, which common.cuh's reduce_rows_kernel does not take.
__global__ void __launch_bounds__(kReduceBins * kReduceRows)
hist_reduce_kernel(const float* __restrict__ partial, int num_rows, int bins,
                   float* __restrict__ out) {
  __shared__ float part[kReduceRows][kReduceBins + 1];
  const int b = blockIdx.x * kReduceBins + threadIdx.x;
  float s = 0.0f;
  if (b < bins) {
    for (int r = threadIdx.y; r < num_rows; r += kReduceRows)
      s = __fadd_rn(s, partial[static_cast<int64_t>(r) * bins + b]);
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && b < bins) {
    float t = 0.0f;
#pragma unroll
    for (int y = 0; y < kReduceRows; ++y)
      t = __fadd_rn(t, part[y][threadIdx.x]);
    out[b] = t;
  }
}

template <bool kWeighted>
int hist_partial_launch_as(const int* idx, const float* w, int64_t n,
                           int bins, float* partial, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kHistWarps * bins;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_partial_kernel<kWeighted>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kHistPerBlock - 1) / kHistPerBlock;
  hist_partial_kernel<kWeighted>
      <<<static_cast<unsigned>(blocks), kHistThreads, smem, stream>>>(
          idx, w, n, bins, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows of `partial` for n samples (n >= 1)
int hist_num_blocks(int64_t n) {
  return static_cast<int>((n + kHistPerBlock - 1) / kHistPerBlock);
}

int hist_max_bins() { return kHistMaxBins; }

// w == nullptr: a counting histogram
int hist_partial_launch(const int* idx, const float* w, int64_t n, int bins,
                        float* partial, cudaStream_t stream) {
  if (n < 1 || bins < 1 || bins > kHistMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  return w ? hist_partial_launch_as<true>(idx, w, n, bins, partial, stream)
           : hist_partial_launch_as<false>(idx, w, n, bins, partial, stream);
}

int hist_reduce_launch(const float* partial, int num_rows, int bins,
                       float* out, cudaStream_t stream) {
  const dim3 block(kReduceBins, kReduceRows);
  hist_reduce_kernel<<<(bins + kReduceBins - 1) / kReduceBins, block, 0,
                       stream>>>(partial, num_rows, bins, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
