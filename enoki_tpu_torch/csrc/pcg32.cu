// One PCG32 draw from every lane of a generator whose state lies on the
// card, for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (enoki_tpu_torch/_build.py). The entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Replaces no Pallas kernel: the reference's generator
// (enoki_tpu/types/random.py) is plain jnp, which XLA fuses on its own. It
// was added because the port's eager draw (types/random.py, PCG32._step
// over types/u64.py) is a chain of about 22 int64 PyTorch launches, the
// 64-bit multiply-add, the XSH-RR output in shifts, masks and a rotation of
// six launches, and the uniform's bits; each reads and writes 16-24 bytes a
// lane, and at 2^24 lanes the chain took about 2.2 ms of the histogram
// mini-app's 3.3 ms step on an H100.
//
// The function, per lane i, with s = state[i] and c = inc[i] (uint64 bit
// patterns in int64):
//   new_state[i] = s * 0x5851F42D4C957F2D + c  (mod 2^64), or s where a
//                  mask is given and mask[i] is false;
//   x            = rotr32(uint32(((s >> 18) ^ s) >> 27), s >> 59), from
//                  the old state whatever the mask;
//   out[i]       = x as int64 (kind 0), the float32 in [0, 1) of
//                  (x >> 9) | 0x3f800000 less 1 (kind 1), or the float64
//                  of (x << 20) | 0x3FF0000000000000 less 1 (kind 2).
// Integer arithmetic and exact subtractions: the same bits as the op chain.
//
// Bound on this card: bytes. A lane reads 16 B (state and increment) and
// writes 12-16 B (the next state and the draw): 28 B for a float32 draw,
// 470 MB at 2^24 lanes, 0.140 ms at 3.35 TB/s; its ~25 INT32 instructions
// take about 0.03 ms. So the design is a streaming pass: each thread takes
// kPairs pairs of lanes, kThreads pairs apart, so that neighbouring threads
// hold neighbouring lanes and every warp-wide access is contiguous; a pair
// is one 16-byte load of the states and one of the increments, one 16-byte
// store of the next states and one 8- or 16-byte store of the draws; all of
// a thread's loads are issued before its first pair's arithmetic; offsets
// are 64-bit. A view that starts off a 16-byte boundary (state[1:]) takes
// the scalar instantiation, and a ragged last pair scalar accesses. At
// 2^24 lanes the grid is 16,384 blocks of 256 threads, about 16 waves of
// 8 blocks an SM over 132 SMs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 2;   // pairs of lanes a thread: 4 lanes
constexpr uint64_t kMult = 0x5851F42D4C957F2DULL;

// the draw's type in `out`, by kind
template <int kKind> struct Draw;
template <> struct Draw<0> { using T = long long; };
template <> struct Draw<1> { using T = float; };
template <> struct Draw<2> { using T = double; };

// XSH-RR: the 32-bit output of the state s
__device__ __forceinline__ uint32_t xsh_rr(uint64_t s) {
  const uint32_t xs = static_cast<uint32_t>(((s >> 18) ^ s) >> 27);
  const uint32_t rot = static_cast<uint32_t>(s >> 59);
  return __funnelshift_r(xs, xs, rot);
}

template <int kKind>
__device__ __forceinline__ typename Draw<kKind>::T draw_as(uint32_t x) {
  if constexpr (kKind == 0) {
    return static_cast<long long>(x);
  } else if constexpr (kKind == 1) {
    return __fsub_rn(__uint_as_float((x >> 9) | 0x3f800000u), 1.0f);
  } else {
    return __dsub_rn(
        __longlong_as_double(static_cast<long long>(
            (static_cast<uint64_t>(x) << 20) | 0x3FF0000000000000ULL)),
        1.0);
  }
}

// two draws as one store: 16 bytes (kinds 0 and 2) or 8 (kind 1)
template <int kKind>
__device__ __forceinline__ void store_pair(typename Draw<kKind>::T* p,
                                           uint32_t x0, uint32_t x1) {
  if constexpr (kKind == 0) {
    *reinterpret_cast<longlong2*>(p) = make_longlong2(draw_as<0>(x0),
                                                      draw_as<0>(x1));
  } else if constexpr (kKind == 1) {
    *reinterpret_cast<float2*>(p) = make_float2(draw_as<1>(x0),
                                                draw_as<1>(x1));
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(draw_as<2>(x0),
                                                  draw_as<2>(x1));
  }
}

// kVec: state and inc start on a 16-byte boundary (new_state and out, from
// the allocator, always do), so whole pairs move as vectors
template <int kKind, bool kVec>
__global__ void __launch_bounds__(kThreads)
pcg32_kernel(const uint64_t* __restrict__ state,
             const uint64_t* __restrict__ inc,
             const unsigned char* __restrict__ mask, int64_t n,
             typename Draw<kKind>::T* __restrict__ out,
             uint64_t* __restrict__ new_state) {
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kPairs) + threadIdx.x;
  uint64_t s[kPairs][2], c[kPairs][2];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int64_t i0 = 2 * (first + static_cast<int64_t>(j) * kThreads);
    if (kVec && i0 + 2 <= n) {
      const ulonglong2 sv = *reinterpret_cast<const ulonglong2*>(state + i0);
      const ulonglong2 cv = *reinterpret_cast<const ulonglong2*>(inc + i0);
      s[j][0] = sv.x;
      s[j][1] = sv.y;
      c[j][0] = cv.x;
      c[j][1] = cv.y;
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        s[j][k] = i0 + k < n ? state[i0 + k] : 0;
        c[j][k] = i0 + k < n ? inc[i0 + k] : 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int64_t i0 = 2 * (first + static_cast<int64_t>(j) * kThreads);
    if (i0 >= n) break;
    uint64_t ns[2];
    uint32_t x[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      ns[k] = s[j][k] * kMult + c[j][k];
      x[k] = xsh_rr(s[j][k]);
    }
    if (mask != nullptr) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (i0 + k < n && !mask[i0 + k]) ns[k] = s[j][k];
      }
    }
    if (kVec && i0 + 2 <= n) {
      *reinterpret_cast<ulonglong2*>(new_state + i0) =
          make_ulonglong2(ns[0], ns[1]);
      store_pair<kKind>(out + i0, x[0], x[1]);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (i0 + k < n) {
          new_state[i0 + k] = ns[k];
          out[i0 + k] = draw_as<kKind>(x[k]);
        }
      }
    }
  }
}

template <int kKind>
int launch_as(const uint64_t* state, const uint64_t* inc,
              const unsigned char* mask, int64_t n, void* out,
              uint64_t* new_state, cudaStream_t stream) {
  using T = typename Draw<kKind>::T;
  const int64_t pairs = (n + 1) / 2;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPairs;
  const unsigned blocks =
      static_cast<unsigned>((pairs + per_block - 1) / per_block);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  T* o = static_cast<T*>(out);
  if (aligned(state) && aligned(inc) && aligned(new_state) && aligned(out))
    pcg32_kernel<kKind, true>
        <<<blocks, kThreads, 0, stream>>>(state, inc, mask, n, o, new_state);
  else
    pcg32_kernel<kKind, false>
        <<<blocks, kThreads, 0, stream>>>(state, inc, mask, n, o, new_state);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// state, inc, new_state: n uint64 (int64 bit patterns); mask: n bytes, 0
// for a lane that keeps its state, or NULL (every lane advances); out: n
// int64 (out_kind 0), float32 (1) or float64 (2); n >= 1
int pcg32_next_launch(const void* state, const void* inc, const void* mask,
                      int64_t n, void* out, int out_kind, void* new_state,
                      cudaStream_t stream) {
  if (n < 1 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const uint64_t*>(state);
  const auto* c = static_cast<const uint64_t*>(inc);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* ns = static_cast<uint64_t*>(new_state);
  switch (out_kind) {
    case 0: return launch_as<0>(s, c, m, n, out, ns, stream);
    case 1: return launch_as<1>(s, c, m, n, out, ns, stream);
    default: return launch_as<2>(s, c, m, n, out, ns, stream);
  }
}

}  // extern "C"
