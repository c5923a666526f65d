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
// few hundred bytes. So the loads must keep the memory busy: 16-byte
// loads, several in flight per thread, and little else on the way.
//
// Both routes give bitwise the same result from run to run, weighted too:
// no float atomicAdd anywhere, neither to device memory nor to shared
// memory. Each block writes one row of `partial`, hist_reduce sums those
// rows in a fixed order, and the grid depends on N (and the route on
// `bins`) alone, so equal inputs take equal sums on every run. A counting
// histogram's f32 sums are integers: exact up to 2^24 a bin.
//
// Route 1, bins <= kSmallBins (the mini-app's 64): one private row per
// thread. The earlier design (route 2 for every `bins`) spent ~180-200
// cycles on each warp's round of 32 samples, one round after the other:
// a __match_any_sync, a lane-order sum (32 shuffles when weighted), the
// group leader's shared-memory read-modify-write, a __syncwarp; that kept
// it at 5.0x (counting) and 4.1x (weighted) its bound. Here each thread of
// a block owns a row of `bins` counters in shared memory, laid out
// bin-major, thread-minor (rows[b * kRowThreads + tid]), so that every
// access of a warp hits 32 distinct banks whatever the bins; a sample is
// a plain read-modify-write of the thread's own counter (int32 when
// counting, f32 weight sums in sample order), with no match, no shuffle
// and no barrier. A block takes kRowPerBlock consecutive samples; its
// threads read them as 16-byte chunks (4 indices, int4, and 4 weights,
// float4), chunk c of the block to thread c % kRowThreads, so that a
// warp's loads are coalesced; the loads of a thread's next 8 chunks (4
// when weighted) are in flight while its current ones are added. A
// view may start at any 4-byte address (idx[1:]): the block's up to 3
// samples before the first 16-byte boundary and up to 3 after its last
// whole chunk are read one by one by threads 0-7; weights whose address
// is not aligned as the indices' are are read one by one inside the
// chunks. The block then sums its rows in a fixed order (per bin: 8 loads
// a lane, then a shuffle tree) into its row of `partial`. 256 threads x
// 96 bins x 4 B = 96 KiB: two blocks fit an SM at kSmallBins, three at 64.
//
// Route 2, up to kHistMaxBins: one private row per warp.
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
//  - The block sums its warps' rows in warp order into its row of
//    `partial`.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// route 1: a row per thread
constexpr int kRowThreads = 256;
constexpr int kSmallBins = 96;
constexpr int kRowChunks = 32;    // 16-byte chunks of a thread in a block
// chunks whose loads are issued together: 8 when counting (4 B a sample),
// 4 when weighted (8 B)
constexpr int kRowUnrollCount = 8, kRowUnrollWeighted = 4;
constexpr int64_t kRowPerBlock = 4 * kRowThreads * kRowChunks;

static_assert(kRowChunks % kRowUnrollCount == 0 &&
                  kRowChunks % kRowUnrollWeighted == 0,
              "whole groups of chunks");
// two blocks' rows and their 1 KiB reserve each within an SM's 228 KiB
static_assert(2 * (kSmallBins * kRowThreads * 4 + 1024) <= 233472,
              "two blocks of the row-per-thread route must fit an SM");

// route 2: a row per warp
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

// Route 1. kVecW: the weights can be read as float4 along with the index
// chunks (their address is aligned as the indices' is).
template <bool kWeighted, bool kVecW>
__global__ void __launch_bounds__(kRowThreads)
hist_rows_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                 int64_t n, int bins, float* __restrict__ partial) {
  // int32 counters count exactly; weights are summed in f32
  using Acc = typename std::conditional<kWeighted, float, int>::type;
  constexpr int kRowUnroll = kWeighted ? kRowUnrollWeighted : kRowUnrollCount;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* rows = reinterpret_cast<Acc*>(smem);  // [bins][kRowThreads]
  const int tid = threadIdx.x;
  Acc* mine = rows + tid;
  for (int b = 0; b < bins; ++b) mine[b * kRowThreads] = Acc(0);

  // one sample into this thread's row; an index outside [0, bins) drops
  auto add = [&](int b, float v) {
    if (static_cast<unsigned>(b) < static_cast<unsigned>(bins)) {
      Acc* c = mine + b * kRowThreads;
      if constexpr (kWeighted) {
        *c = __fadd_rn(*c, v);
      } else {
        *c += 1;
      }
    }
  };

  // [lo, hi): this block's samples; [body, tail): its whole 16-byte
  // chunks. lo is a multiple of 4, so every block starts as misaligned
  // as the view does
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kRowPerBlock;
  const int64_t hi = lo + kRowPerBlock < n ? lo + kRowPerBlock : n;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(idx + lo) >> 2) & 3);
  const int64_t body = lo + ((4 - mis) & 3) < hi ? lo + ((4 - mis) & 3) : hi;
  const int64_t chunks = (hi - body) >> 2;
  const int64_t tail = body + 4 * chunks;
  // the ragged ends, one sample a thread: head on threads 0-3, tail 4-7
  if (tid < 8) {
    const int64_t i = tid < 4 ? lo + tid : tail + (tid - 4);
    if (i < (tid < 4 ? body : hi)) add(idx[i], kWeighted ? w[i] : 0.0f);
  }

  // the chunks of group k0 (k0, k0 + 1, ... of this thread), their loads
  // issued together; a chunk past the block's end gives dropped indices
  const int4* idx4 = reinterpret_cast<const int4*>(idx + body);
  auto load = [&](int k0, int4 (&key)[kRowUnroll],
                  float4 (&val)[kRowUnroll]) {
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int64_t c = tid + static_cast<int64_t>(k0 + u) * kRowThreads;
      key[u] = make_int4(-1, -1, -1, -1);
      val[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < chunks) {
        key[u] = idx4[c];
        if constexpr (kWeighted && kVecW) {
          val[u] = reinterpret_cast<const float4*>(w + body)[c];
        } else if constexpr (kWeighted) {
          const float* wc = w + body + 4 * c;
          val[u] = make_float4(wc[0], wc[1], wc[2], wc[3]);
        }
      }
    }
  };
  // software-pipelined: the next group's loads are in flight while this
  // group's samples go into the row
  int4 key[kRowUnroll], next_key[kRowUnroll];
  float4 val[kRowUnroll], next_val[kRowUnroll];
  load(0, key, val);
  for (int k0 = 0; k0 < kRowChunks; k0 += kRowUnroll) {
    if (static_cast<int64_t>(k0) * kRowThreads >= chunks) break;  // block
    // past the thread's last group every chunk is past the block's end
    load(k0 + kRowUnroll, next_key, next_val);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      add(key[u].x, val[u].x);
      add(key[u].y, val[u].y);
      add(key[u].z, val[u].z);
      add(key[u].w, val[u].w);
      key[u] = next_key[u];
      val[u] = next_val[u];
    }
  }
  __syncthreads();

  // bin b of the block: lane l sums rows l, l + 32, ... of its warp's
  // bins, then the lanes in a fixed shuffle tree
  const int lane = tid & 31, warp = tid >> 5;
  float* out = partial + static_cast<int64_t>(blockIdx.x) * bins;
  for (int b = warp; b < bins; b += kRowThreads / 32) {
    Acc s = Acc(0);
#pragma unroll
    for (int j = 0; j < kRowThreads / 32; ++j)
      s += rows[b * kRowThreads + j * 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[b] = static_cast<float>(s);
  }
}

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

// Launch `kernel` on `blocks` blocks of `threads` with `smem` bytes of
// dynamic shared memory (raising the kernel's limit above 48 KiB first).
template <class Kernel>
int launch_hist(Kernel kernel, int64_t blocks, int threads, size_t smem,
                cudaStream_t stream, const int* idx, const float* w,
                int64_t n, int bins, float* partial) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      idx, w, n, bins, partial);
  return static_cast<int>(cudaGetLastError());
}

int64_t per_block(int bins) {
  return bins <= kSmallBins ? kRowPerBlock : kHistPerBlock;
}

}  // namespace

extern "C" {

// rows of `partial` for n samples (n >= 1) into `bins` bins
int hist_num_blocks(int64_t n, int bins) {
  return static_cast<int>((n + per_block(bins) - 1) / per_block(bins));
}

int hist_max_bins() { return kHistMaxBins; }

// the most bins of the row-per-thread route
int hist_small_bins() { return kSmallBins; }

// w == nullptr: a counting histogram
int hist_partial_launch(const int* idx, const float* w, int64_t n, int bins,
                        float* partial, cudaStream_t stream) {
  if (n < 1 || bins < 1 || bins > kHistMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = hist_num_blocks(n, bins);
  if (bins <= kSmallBins) {
    const size_t smem = static_cast<size_t>(4) * kRowThreads * bins;
    const bool vec_w = ((reinterpret_cast<uintptr_t>(w) ^
                         reinterpret_cast<uintptr_t>(idx)) & 15) == 0;
    return !w ? launch_hist(hist_rows_kernel<false, false>, blocks,
                            kRowThreads, smem, stream, idx, w, n, bins,
                            partial)
         : vec_w ? launch_hist(hist_rows_kernel<true, true>, blocks,
                               kRowThreads, smem, stream, idx, w, n, bins,
                               partial)
                 : launch_hist(hist_rows_kernel<true, false>, blocks,
                               kRowThreads, smem, stream, idx, w, n, bins,
                               partial);
  }
  const size_t smem = sizeof(float) * kHistWarps * bins;
  return w ? launch_hist(hist_partial_kernel<true>, blocks, kHistThreads,
                         smem, stream, idx, w, n, bins, partial)
           : launch_hist(hist_partial_kernel<false>, blocks, kHistThreads,
                         smem, stream, idx, w, n, bins, partial);
}

int hist_reduce_launch(const float* partial, int num_rows, int bins,
                       float* out, cudaStream_t stream) {
  const dim3 block(kReduceBins, kReduceRows);
  hist_reduce_kernel<<<(bins + kReduceBins - 1) / kReduceBins, block, 0,
                       stream>>>(partial, num_rows, bins, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
