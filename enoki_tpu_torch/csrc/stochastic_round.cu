// Unbiased stochastic rounding of f32 to bf16 or f16, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (enoki_tpu_torch/_build.py). The entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Replaces `kernel` of stochastic_round_pallas
// (enoki_tpu/ops/rounding.py:270, called at :277), which seeds its
// device's own random generator and hands the bits to its device's
// stochastic-round unit. This card has neither: the random words are
// Philox4x32-10 (philox.cuh) with the 64-bit seed as the key and the index
// of a group of four elements as the counter, and the rounding is the
// arithmetic of the reference's portable function (rounding.py:96-112),
// which ops.rounding.stochastic_round_from_bits repeats in PyTorch. Philox
// and the rounding are integer and IEEE arithmetic, so the plain version
// gives the same bits, and the result depends on (x, seed) alone, not on
// the launch shape. The reference's bits cannot be matched; the contract
// is: one of the two 16-bit neighbours of x, x in the mean.
//
// Bound on this card: bytes (4 B read, 2 B written per element; Philox
// costs ~25 integer operations per element, half the byte time at the
// card's INT32 rate). One thread takes kGroups Philox blocks and the four
// elements of each: a 16-byte load and an 8-byte store where the pointers
// allow, scalar accesses otherwise and at the ragged end. The f16 rounding
// divides by the gap between two neighbouring f16 values, a power of two:
// the kernel multiplies by its reciprocal, read off the f16 pattern, which
// gives the IEEE quotient bit for bit at a fraction of a division's
// instructions (with the division, f16 took 1.66x bf16's time).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
// Philox blocks (groups of four elements) per thread, kThreads apart, all
// loads issued before the first block's arithmetic: with one group per
// thread the bf16 kernel took 0.069 ms for 16M elements on an H100, with
// two 0.037 ms, the time of a plain f32 -> 16-bit copy of this shape
// (PERF.md); f16 with 4 groups timed slower than with 2
constexpr int kGroupsBf16 = 2;
constexpr int kGroupsF16 = 2;

__host__ __device__ constexpr int groups_of(bool half) {
  return half ? kGroupsF16 : kGroupsBf16;
}

// bf16: add the low 16 bits of the word as dither below the target
// mantissa and truncate. A finite x cannot carry past infinity's pattern,
// so the upper half is the bf16. NaN and +-inf take the normal cast
// (dither on a payload NaN could carry into the exponent).
__device__ __forceinline__ uint16_t round_bf16(float x, uint32_t word) {
  const uint32_t bits = __float_as_uint(x);
  if ((bits & 0x7F800000u) == 0x7F800000u)
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return static_cast<uint16_t>((bits + (word & 0xFFFFu)) >> 16);
}

// f16: the nearest f16 `lo` and its neighbour `hi` on x's side; hi with
// probability p = (x - lo) / (hi - lo), against u = the word's top 24 bits
// * 2^-24 (rounding.stochastic_round_from_bits, each operation rounded on
// its own as PyTorch's eager ops).
//
// Where lo and hi are finite, hi - lo is a power of two: lo's f16 ulp
// (2^(e - 25) for the exponent field e >= 1, 2^-24 for e = 0), halved
// where the step from a power of two >= 2^-13 goes toward zero. Its
// magnitude's reciprocal 2^(25 - max(e, 1)) (times 2) is an exact f32, and
// |x - lo| times it is the exact quotient rounded once, the IEEE
// division's result. Where lo or hi is not finite (x is NaN, infinite or
// beyond +-65520, or lo is +-65504 and x lies outside it), the division
// gives NaN or 0 and lo stays: so does the kernel.
// tests/test_torch_rounding.py holds this arithmetic against the division
// for every f16 pattern.
__device__ __forceinline__ uint16_t round_f16(float x, uint32_t word) {
  const __half lo_h = __float2half_rn(x);
  const uint32_t lo_b = __half_as_ushort(lo_h);
  const float lo = __half2float(lo_h);
  const uint32_t e = (lo_b >> 10) & 0x1Fu;
  const bool up = x >= lo;
  // away from zero is one pattern up, toward zero one down; +-0 steps to
  // the smallest subnormal of the direction's sign
  const bool away = ((lo_b & 0x8000u) != 0u) != up;
  const uint32_t hi_b = (lo_b & 0x7FFFu) == 0u ? (up ? 0x0001u : 0x8001u)
                        : away                 ? lo_b + 1u
                                               : lo_b - 1u;
  const bool finite = e != 0x1Fu && (hi_b & 0x7FFFu) != 0x7C00u;
  const uint32_t halve = !away && (lo_b & 0x3FFu) == 0u && e >= 2u;
  const float inv_span =
      __uint_as_float((152u - max(e, 1u) + halve) << 23);
  // x - lo and hi - lo share their sign: the quotient is |x - lo| / |span|
  const float p = __fmul_rn(fabsf(__fsub_rn(x, lo)), inv_span);
  const float u =
      __fmul_rn(static_cast<float>(word >> 8), 5.9604644775390625e-08f);
  return static_cast<uint16_t>(finite && u < p ? hi_b : lo_b);
}

template <bool kHalf>
__device__ __forceinline__ uint16_t round_one(float x, uint32_t word) {
  return kHalf ? round_f16(x, word) : round_bf16(x, word);
}

template <bool kHalf, bool kVec>
__global__ void __launch_bounds__(kThreads)
stochastic_round_kernel(const float* __restrict__ x,
                        uint16_t* __restrict__ out, int64_t n,
                        uint64_t seed) {
  constexpr int kGroups = groups_of(kHalf);
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kGroups) + threadIdx.x;
  float v[kGroups][4];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int64_t i0 = (first + static_cast<int64_t>(j) * kThreads) * 4;
    if (kVec && i0 + 4 <= n) {
      const float4 q = *reinterpret_cast<const float4*>(x + i0);
      v[j][0] = q.x;
      v[j][1] = q.y;
      v[j][2] = q.z;
      v[j][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = i0 + k < n ? x[i0 + k] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int64_t group = first + static_cast<int64_t>(j) * kThreads;
    const int64_t i0 = group * 4;
    if (i0 >= n) break;
    const Philox4 r = philox4x32_10(static_cast<uint64_t>(group), seed);
    uint16_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = round_one<kHalf>(v[j][k], r.w[k]);
    if (kVec && i0 + 4 <= n) {
      *reinterpret_cast<ushort4*>(out + i0) =
          make_ushort4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i0 + k < n) out[i0 + k] = o[k];
      }
    }
  }
}

template <bool kHalf>
int launch_as(const float* x, uint16_t* out, int64_t n, uint64_t seed,
              cudaStream_t stream) {
  const int64_t groups = (n + 3) / 4;
  const int64_t per_block = kThreads * groups_of(kHalf);
  const unsigned blocks =
      static_cast<unsigned>((groups + per_block - 1) / per_block);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (vec)
    stochastic_round_kernel<kHalf, true>
        <<<blocks, kThreads, 0, stream>>>(x, out, n, seed);
  else
    stochastic_round_kernel<kHalf, false>
        <<<blocks, kThreads, 0, stream>>>(x, out, n, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n f32; out: n bf16 (half == 0) or f16 (half != 0); n >= 1
int stochastic_round_launch(const float* x, void* out, int64_t n,
                            uint64_t seed, int half, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  uint16_t* o = static_cast<uint16_t*>(out);
  return half ? launch_as<true>(x, o, n, seed, stream)
              : launch_as<false>(x, o, n, seed, stream);
}

}  // extern "C"
