// Skeleton of the lazy trace's fused kernels (enoki_tpu_torch/trace/
// codegen.py). The counterpart of the reference's XLA code generation of
// a schedule (enoki_tpu/trace/__init__.py:396, _compile_schedule), and of
// the source paper's PTX trace-JIT (src/cuda/jit.cu:983-1508): codegen
// cuts a schedule into fused runs and writes, per run, one __global__
// kernel -- a grid-stride loop over the run's lanes with one C++
// statement per schedule entry -- between an #include of this file and
// its launch function. What bounds such a kernel on the card is the bytes
// it moves: each leaf read once, each exported value written once (a
// value that no later run, reduction or output reads lives in a register
// and never reaches memory); the per-lane arithmetic of any realistic
// program is far below the card's rate.
//
// Numbers: every operation gives the bits of the plain version
// (trace/plain.py) on IEEE operations. So f32 / f64 arithmetic goes
// through the _rn intrinsics (never contracted into an FMA; FMA itself is
// a*b + c, two roundings), divisions are IEEE, a float -> integer cast is
// cvt.rzi (saturating) with NaN -> 0, integers wrap as two's complement
// (computed unsigned, so no signed overflow is undefined), shifts by the
// width or more give 0 (the sign for an arithmetic right shift), 16-bit
// floats are carried in float and rounded after every op
// (__float2bfloat16_rn / __float2half_rn), and a transcendental of a
// 16/32-bit float is the double libdevice function rounded once.
//
// Everything here compiles as host C++17 too (TK_HD empty, the kernel a
// plain loop), so that the emitted per-lane code can be held against the
// plain version where there is no card; a host build must pass
// -ffp-contract=off.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#define TK_HD __device__ __forceinline__
#define TK_STD
#else
#define TK_HD inline
#define TK_STD std::
#endif

namespace tk {

// ---------------------------------------------------------------------------
// storage of the 16-bit floats; in registers they are floats holding a
// value the 16-bit type represents
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
typedef __nv_bfloat16 bf16_t;
typedef __half f16_t;
TK_HD float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
TK_HD float rh(float x) { return __half2float(__float2half_rn(x)); }
TK_HD float ld_bf16(const void *p, long long i) {
  return __bfloat162float(static_cast<const bf16_t *>(p)[i]);
}
TK_HD float ld_f16(const void *p, long long i) {
  return __half2float(static_cast<const f16_t *>(p)[i]);
}
TK_HD void st_bf16(void *p, long long i, float v) {
  static_cast<bf16_t *>(p)[i] = __float2bfloat16_rn(v);
}
TK_HD void st_f16(void *p, long long i, float v) {
  static_cast<f16_t *>(p)[i] = __float2half_rn(v);
}
TK_HD uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
TK_HD uint16_t f16_bits(float v) { return __half_as_ushort(__float2half_rn(v)); }
TK_HD float bf16_of_bits(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
TK_HD float f16_of_bits(uint16_t b) {
  return __half2float(__ushort_as_half(b));
}
#else
typedef uint16_t bf16_t;
typedef uint16_t f16_t;
inline uint32_t fbits(float x) { uint32_t u; std::memcpy(&u, &x, 4); return u; }
inline float ffrom(uint32_t u) { float x; std::memcpy(&x, &u, 4); return x; }
// round to nearest even, as PyTorch's and the card's conversions do
inline uint16_t bf16_bits(float x) {
  uint32_t u = fbits(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
inline float bf16_of_bits(uint16_t b) { return ffrom((uint32_t)b << 16); }
inline uint16_t f16_bits(float f) {
  uint32_t x = fbits(f);
  uint32_t sign = (x >> 16) & 0x8000u, a = x & 0x7fffffffu;
  if (a > 0x7f800000u) return (uint16_t)(sign | 0x7e00u);
  if (a >= 0x477ff000u) return (uint16_t)(sign | 0x7c00u);
  if (a < 0x38800000u) {  // a half subnormal: the FPU rounds at 2^-24
    float m = ffrom(a) + 0.5f;
    return (uint16_t)(sign | (fbits(m) - 0x3f000000u));
  }
  a += 0xc8000fffu + ((a >> 13) & 1u);
  return (uint16_t)(sign | (a >> 13));
}
inline float f16_of_bits(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16, e = (h >> 10) & 0x1fu,
           m = h & 0x3ffu;
  if (e == 0x1f) return ffrom(sign | 0x7f800000u | (m << 13));
  if (e == 0) return sign ? -std::ldexp((float)m, -24) : std::ldexp((float)m, -24);
  return ffrom(sign | ((e + 112u) << 23) | (m << 13));
}
inline float rbf(float x) { return bf16_of_bits(bf16_bits(x)); }
inline float rh(float x) { return f16_of_bits(f16_bits(x)); }
inline float ld_bf16(const void *p, long long i) {
  return bf16_of_bits(static_cast<const uint16_t *>(p)[i]);
}
inline float ld_f16(const void *p, long long i) {
  return f16_of_bits(static_cast<const uint16_t *>(p)[i]);
}
inline void st_bf16(void *p, long long i, float v) {
  static_cast<uint16_t *>(p)[i] = bf16_bits(v);
}
inline void st_f16(void *p, long long i, float v) {
  static_cast<uint16_t *>(p)[i] = f16_bits(v);
}
#endif

template <typename T> TK_HD T ld(const void *p, long long i) {
  return static_cast<const T *>(p)[i];
}
template <typename T> TK_HD void st(void *p, long long i, T v) {
  static_cast<T *>(p)[i] = v;
}

// a literal: its 64-bit pattern in the stream, reinterpreted
template <typename T> TK_HD T lit(const uint64_t *L, int j) {
  uint64_t b = L[j];
  T v;
  std::memcpy(&v, &b, sizeof(T));  // little-endian: the low bytes
  return v;
}
TK_HD bool lit_b8(const uint64_t *L, int j) { return L[j] != 0; }
TK_HD float lit_bf16(const uint64_t *L, int j) {
  return bf16_of_bits((uint16_t)L[j]);
}
TK_HD float lit_f16(const uint64_t *L, int j) {
  return f16_of_bits((uint16_t)L[j]);
}

// ---------------------------------------------------------------------------
// IEEE arithmetic, one rounding per operation
// ---------------------------------------------------------------------------

// the commonest ones also as macros, which the emitted code calls
// directly (cicc's time on a long kernel falls without their inlining)
#ifdef __CUDACC__
#define TK_FADD(a, b) __fadd_rn(a, b)
#define TK_FSUB(a, b) __fsub_rn(a, b)
#define TK_FMUL(a, b) __fmul_rn(a, b)
#define TK_FDIV(a, b) __fdiv_rn(a, b)
#define TK_FSQRT(a) __fsqrt_rn(a)
#define TK_DADD(a, b) __dadd_rn(a, b)
#define TK_DSUB(a, b) __dsub_rn(a, b)
#define TK_DMUL(a, b) __dmul_rn(a, b)
#define TK_DDIV(a, b) __ddiv_rn(a, b)
#define TK_DSQRT(a) __dsqrt_rn(a)
#else
#define TK_FADD(a, b) ((float)(a) + (float)(b))
#define TK_FSUB(a, b) ((float)(a) - (float)(b))
#define TK_FMUL(a, b) ((float)(a) * (float)(b))
#define TK_FDIV(a, b) ((float)(a) / (float)(b))
#define TK_FSQRT(a) std::sqrt((float)(a))
#define TK_DADD(a, b) ((double)(a) + (double)(b))
#define TK_DSUB(a, b) ((double)(a) - (double)(b))
#define TK_DMUL(a, b) ((double)(a) * (double)(b))
#define TK_DDIV(a, b) ((double)(a) / (double)(b))
#define TK_DSQRT(a) std::sqrt((double)(a))
#endif

#ifdef __CUDACC__
TK_HD float add(float a, float b) { return __fadd_rn(a, b); }
TK_HD float sub(float a, float b) { return __fsub_rn(a, b); }
TK_HD float mul(float a, float b) { return __fmul_rn(a, b); }
TK_HD float div(float a, float b) { return __fdiv_rn(a, b); }
TK_HD double add(double a, double b) { return __dadd_rn(a, b); }
TK_HD double sub(double a, double b) { return __dsub_rn(a, b); }
TK_HD double mul(double a, double b) { return __dmul_rn(a, b); }
TK_HD double div(double a, double b) { return __ddiv_rn(a, b); }
TK_HD float sqrt_(float a) { return __fsqrt_rn(a); }
TK_HD double sqrt_(double a) { return __dsqrt_rn(a); }
TK_HD float d2f(double a) { return __double2float_rn(a); }
#else
inline float add(float a, float b) { return a + b; }
inline float sub(float a, float b) { return a - b; }
inline float mul(float a, float b) { return a * b; }
inline float div(float a, float b) { return a / b; }
inline double add(double a, double b) { return a + b; }
inline double sub(double a, double b) { return a - b; }
inline double mul(double a, double b) { return a * b; }
inline double div(double a, double b) { return a / b; }
inline float sqrt_(float a) { return std::sqrt(a); }
inline double sqrt_(double a) { return std::sqrt(a); }
inline float d2f(double a) { return (float)a; }
#endif

// integers wrap: computed on the unsigned type of the same width
template <typename T> struct U;
template <> struct U<int32_t> { typedef uint32_t t; };
template <> struct U<uint32_t> { typedef uint32_t t; };
template <> struct U<int64_t> { typedef uint64_t t; };
template <> struct U<uint64_t> { typedef uint64_t t; };
template <typename T> TK_HD T add(T a, T b) {
  return (T)((typename U<T>::t)a + (typename U<T>::t)b);
}
template <typename T> TK_HD T sub(T a, T b) {
  return (T)((typename U<T>::t)a - (typename U<T>::t)b);
}
template <typename T> TK_HD T mul(T a, T b) {
  return (T)((typename U<T>::t)a * (typename U<T>::t)b);
}
template <typename T> TK_HD T neg(T a) {
  return (T)((typename U<T>::t)0 - (typename U<T>::t)a);
}
TK_HD float neg(float a) { return -a; }
TK_HD double neg(double a) { return -a; }
TK_HD bool add(bool a, bool b) { return a || b; }
TK_HD bool sub(bool a, bool b) { return a != b; }
TK_HD bool mul(bool a, bool b) { return a && b; }

template <typename T> TK_HD T fma_(T a, T b, T c) { return add(mul(a, b), c); }

// integer division with XLA's x / 0 = -1, x % 0 = x (MIN / -1 = MIN)
template <typename T> TK_HD T idiv(T a, T b) {
  if (b == 0) return (T)-1;
  if ((T)-1 < 0 && b == (T)-1) return neg(a);
  return a / b;
}
template <typename T> TK_HD T irem(T a, T b) {
  if (b == 0) return a;
  if ((T)-1 < 0 && b == (T)-1) return 0;
  return a % b;
}
TK_HD bool idiv(bool a, bool) { return a; }

template <typename T> TK_HD T iabs(T a) { return a < 0 ? neg(a) : a; }
TK_HD uint32_t iabs(uint32_t a) { return a; }
TK_HD uint64_t iabs(uint64_t a) { return a; }

// floored remainder (jnp.remainder): rem + b where their signs differ
TK_HD float fmod_(float a, float b) { return TK_STD fmod(a, b); }
TK_HD double fmod_(double a, double b) { return TK_STD fmod(a, b); }
template <typename T> TK_HD T fmod_(T a, T b) { return irem(a, b); }
template <typename T> TK_HD T floor_mod(T r, T b) {
  return (r != 0 && ((r < 0) != (b < 0))) ? add(r, b) : r;
}

// jnp.minimum / jnp.maximum: NaN where either is NaN; -0.0 below +0.0
template <typename T> TK_HD T min_(T a, T b) { return b < a ? b : a; }
template <typename T> TK_HD T max_(T a, T b) { return b > a ? b : a; }
template <typename T> TK_HD T fmin_j(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return TK_STD signbit(a) ? a : b;
  return a < b ? a : b;
}
template <typename T> TK_HD T fmax_j(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return TK_STD signbit(a) ? b : a;
  return a > b ? a : b;
}
TK_HD float min_(float a, float b) { return fmin_j(a, b); }
TK_HD double min_(double a, double b) { return fmin_j(a, b); }
TK_HD float max_(float a, float b) { return fmax_j(a, b); }
TK_HD double max_(double a, double b) { return fmax_j(a, b); }

// shifts: a width or more (or a negative amount) gives 0, the sign for
// an arithmetic right shift
// (a uint64 amount of 2^63 or more is negative as a long long: out of
// range, as the plain version's int64 bit pattern is)
template <typename T> TK_HD T shl(T a, T s) {
  const long long w = 8 * sizeof(T);
  long long k = (long long)s;
  if (k < 0 || k >= w) return 0;
  return (T)((typename U<T>::t)a << k);
}
template <typename T> TK_HD T shr(T a, T s) {
  const long long w = 8 * sizeof(T);
  long long k = (long long)s;
  if (k < 0 || k >= w) return (T)-1 < 0 ? (T)(a < 0 ? -1 : 0) : (T)0;
  return a >> k;
}

#ifdef __CUDACC__
TK_HD uint32_t popc32(uint32_t v) { return __popc(v); }
TK_HD uint32_t popc64(uint64_t v) { return __popcll(v); }
TK_HD uint32_t clz32(uint32_t v) { return __clz((int)v); }
TK_HD uint32_t clz64(uint64_t v) { return __clzll((long long)v); }
#else
inline uint32_t popc32(uint32_t v) { return __builtin_popcount(v); }
inline uint32_t popc64(uint64_t v) { return __builtin_popcountll(v); }
inline uint32_t clz32(uint32_t v) { return v ? __builtin_clz(v) : 32; }
inline uint32_t clz64(uint64_t v) { return v ? __builtin_clzll(v) : 64; }
#endif

template <typename T> TK_HD T sign_(T a) { return a < 0 ? (T)-1 : (T)1; }
TK_HD uint32_t sign_(uint32_t) { return 1; }
TK_HD uint64_t sign_(uint64_t) { return 1; }
TK_HD float sign_(float a) { return TK_STD copysign(1.0f, a); }
TK_HD double sign_(double a) { return TK_STD copysign(1.0, a); }

// integer power by squaring, wrapping; a negative exponent gives the
// truncated 1 / a^|b|
template <typename T> TK_HD T ipow(T a, T b) {
  if ((T)-1 < 0 && b < 0) {
    if (a == 1) return 1;
    if (a == (T)-1) return (b & 1) ? (T)-1 : (T)1;
    return 0;
  }
  typename U<T>::t r = 1, base = (typename U<T>::t)a,
                   e = (typename U<T>::t)b;
  for (int k = 0; k < 64; ++k) {
    if (e & 1) r *= base;
    base *= base;
    e >>= 1;
  }
  return (T)r;
}

// cbrt in double, as the plain version takes it: pow(|x|, 1/3) and one
// Newton step, signed
TK_HD double cbrt_p(double x) {
  double a = TK_STD fabs(x);
  double y = TK_STD pow(a, 1.0 / 3.0);
  if (y > 0 && TK_STD isfinite(y))
    y = sub(y, div(sub(mul(mul(y, y), y), a), mul(mul(3.0, y), y)));
  return TK_STD copysign(y, x);
}

// the math of one opcode, overloaded by the working type: a float is
// computed as the plain version computes it (a transcendental in double,
// rounded once; the 16-bit caller rounds again), an integer is left as
// it is where the op is a rounding
#define TK_NATIVE1(name, fn)                                                 \
  TK_HD float name(float x) { return d2f(TK_STD fn((double)x)); }            \
  TK_HD double name(double x) { return TK_STD fn(x); }
TK_NATIVE1(exp_, exp)
TK_NATIVE1(exp2_, exp2)
TK_NATIVE1(log_, log)
TK_NATIVE1(log2_, log2)
TK_NATIVE1(sin_, sin)
TK_NATIVE1(cos_, cos)
TK_NATIVE1(tan_, tan)
TK_NATIVE1(asin_, asin)
TK_NATIVE1(acos_, acos)
TK_NATIVE1(atan_, atan)
TK_NATIVE1(sinh_, sinh)
TK_NATIVE1(cosh_, cosh)
TK_NATIVE1(tanh_, tanh)
TK_NATIVE1(erf_, erf)
TK_NATIVE1(erfc_, erfc)
TK_NATIVE1(lgamma_, lgamma)
TK_NATIVE1(log1p_, log1p)
TK_NATIVE1(expm1_, expm1)
TK_NATIVE1(asinh_, asinh)
TK_NATIVE1(acosh_, acosh)
TK_NATIVE1(atanh_, atanh)
#undef TK_NATIVE1
// digamma (the port's opcode 80, LGAMMA's derivative; CUDA has none), in
// double as the plain version's torch.digamma computes it
// (ATen/native/Math.h calc_digamma): the reflection below 0, the
// recurrence up to 10, then the asymptotic series
TK_HD double digamma_pos(double x) {
  double result = 0;
  while (x < 10) {
    result = sub(result, div(1.0, x));
    x = add(x, 1.0);
  }
  if (x == 10) return add(result, 2.25175258906672110764);
  double y = 0;
  if (x < 1.0e17) {
    const double A[7] = {8.33333333333333333333E-2, -2.10927960927960927961E-2,
                         7.57575757575757575758E-3, -4.16666666666666666667E-3,
                         3.96825396825396825397E-3, -8.33333333333333333333E-3,
                         8.33333333333333333333E-2};
    double z = div(1.0, mul(x, x)), p = 0;
    for (int k = 0; k < 7; ++k) p = add(mul(p, z), A[k]);
    y = mul(z, p);
  }
  return sub(sub(add(result, TK_STD log(x)), div(0.5, x)), y);
}
TK_HD double digamma_p(double x) {
  const double pi = 3.14159265358979323846;
  if (x == 0) return TK_STD copysign(HUGE_VAL, -x);
  if (x < 0) {
    if (x == TK_STD trunc(x)) return TK_STD nan("");
    double q, r = TK_STD modf(x, &q);
    return sub(digamma_pos(sub(1.0, x)), div(pi, TK_STD tan(mul(pi, r))));
  }
  return digamma_pos(x);
}
TK_HD float digamma_(float x) { return d2f(digamma_p((double)x)); }
TK_HD double digamma_(double x) { return digamma_p(x); }
TK_HD float atan2_(float a, float b) {
  return d2f(TK_STD atan2((double)a, (double)b));
}
TK_HD double atan2_(double a, double b) { return TK_STD atan2(a, b); }
TK_HD float pow_(float a, float b) {
  return d2f(TK_STD pow((double)a, (double)b));
}
TK_HD double pow_(double a, double b) { return TK_STD pow(a, b); }
template <typename T> TK_HD T pow_(T a, T b) { return ipow(a, b); }
TK_HD float cbrt_(float x) { return d2f(cbrt_p((double)x)); }
TK_HD double cbrt_(double x) { return cbrt_p(x); }
// roots: the correctly rounded double root, rounded once (the plain
// version's ops.router._sqrt_rn / _rsqrt_rn)
TK_HD float sqrt_r(float x) { return sqrt_(x); }  // the same bits
TK_HD double sqrt_r(double x) { return sqrt_(x); }
TK_HD float rsqrt_(float x) { return d2f(div(1.0, sqrt_((double)x))); }
TK_HD double rsqrt_(double x) { return div(1.0, sqrt_(x)); }
TK_HD float rcp_(float x) { return div(1.0f, x); }
TK_HD double rcp_(double x) { return div(1.0, x); }
TK_HD float floor_(float x) { return TK_STD floor(x); }
TK_HD double floor_(double x) { return TK_STD floor(x); }
TK_HD float ceil_(float x) { return TK_STD ceil(x); }
TK_HD double ceil_(double x) { return TK_STD ceil(x); }
TK_HD float round_(float x) { return TK_STD rint(x); }  // half to even
TK_HD double round_(double x) { return TK_STD rint(x); }
TK_HD float trunc_(float x) { return TK_STD trunc(x); }
TK_HD double trunc_(double x) { return TK_STD trunc(x); }
template <typename T> TK_HD T floor_(T x) { return x; }
template <typename T> TK_HD T ceil_(T x) { return x; }
template <typename T> TK_HD T round_(T x) { return x; }
template <typename T> TK_HD T trunc_(T x) { return x; }
TK_HD float abs_(float x) { return TK_STD fabs(x); }
TK_HD double abs_(double x) { return TK_STD fabs(x); }
template <typename T> TK_HD T abs_(T x) { return iabs(x); }
TK_HD float copysign_(float a, float b) { return TK_STD copysign(a, b); }
TK_HD double copysign_(double a, double b) { return TK_STD copysign(a, b); }
TK_HD bool isnan_(float x) { return TK_STD isnan(x); }
TK_HD bool isnan_(double x) { return TK_STD isnan(x); }
TK_HD bool isinf_(float x) { return TK_STD isinf(x); }
TK_HD bool isinf_(double x) { return TK_STD isinf(x); }
TK_HD bool isfinite_(float x) { return TK_STD isfinite(x); }
TK_HD bool isfinite_(double x) { return TK_STD isfinite(x); }
template <typename T> TK_HD bool isnan_(T) { return false; }
template <typename T> TK_HD bool isinf_(T) { return false; }
template <typename T> TK_HD bool isfinite_(T) { return true; }

// ---------------------------------------------------------------------------
// casts: float -> integer truncates and saturates, NaN -> 0
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
// cvt.rzi saturates; NaN is taken to 0 here (the 64-bit conversions give
// 0x8000000000000000 for it on the card)
TK_HD int32_t f2i32(float x) { return x != x ? 0 : __float2int_rz(x); }
TK_HD int32_t f2i32(double x) { return x != x ? 0 : __double2int_rz(x); }
TK_HD uint32_t f2u32(float x) { return x != x ? 0 : __float2uint_rz(x); }
TK_HD uint32_t f2u32(double x) { return x != x ? 0 : __double2uint_rz(x); }
TK_HD int64_t f2i64(float x) { return x != x ? 0 : __float2ll_rz(x); }
TK_HD int64_t f2i64(double x) { return x != x ? 0 : __double2ll_rz(x); }
TK_HD uint64_t f2u64(float x) { return x != x ? 0 : __float2ull_rz(x); }
TK_HD uint64_t f2u64(double x) { return x != x ? 0 : __double2ull_rz(x); }
TK_HD float i2f(int32_t v) { return __int2float_rn(v); }
TK_HD float i2f(uint32_t v) { return __uint2float_rn(v); }
TK_HD float i2f(int64_t v) { return __ll2float_rn(v); }
TK_HD float i2f(uint64_t v) { return __ull2float_rn(v); }
TK_HD double i2d(int32_t v) { return (double)v; }
TK_HD double i2d(uint32_t v) { return (double)v; }
TK_HD double i2d(int64_t v) { return __ll2double_rn(v); }
TK_HD double i2d(uint64_t v) { return __ull2double_rn(v); }
#else
inline int32_t f2i32(double x) {
  if (x != x) return 0;
  if (x <= -2147483648.0) return INT32_MIN;
  if (x >= 2147483647.0) return INT32_MAX;
  return (int32_t)x;
}
inline uint32_t f2u32(double x) {
  if (x != x || x <= 0) return 0;
  if (x >= 4294967295.0) return UINT32_MAX;
  return (uint32_t)x;
}
inline int64_t f2i64(double x) {
  if (x != x) return 0;
  if (x <= -9223372036854775808.0) return INT64_MIN;
  if (x >= 9223372036854775808.0) return INT64_MAX;
  return (int64_t)x;
}
inline uint64_t f2u64(double x) {
  if (x != x || x <= 0) return 0;
  if (x >= 18446744073709551616.0) return UINT64_MAX;
  return (uint64_t)x;
}
inline int32_t f2i32(float x) { return f2i32((double)x); }
inline uint32_t f2u32(float x) { return f2u32((double)x); }
inline int64_t f2i64(float x) { return f2i64((double)x); }
inline uint64_t f2u64(float x) { return f2u64((double)x); }
template <typename T> inline float i2f(T v) { return (float)v; }
template <typename T> inline double i2d(T v) { return (double)v; }
#endif

// bit reinterpretations of the same width
template <typename To, typename From> TK_HD To bits(From v) {
  To r;
  std::memcpy(&r, &v, sizeof(To));
  return r;
}

// the index of a gather (clamped into [0, n)) and of a scatter (negative
// counts from the end; -1 when it stays out of range and drops)
template <typename T> TK_HD long long clip_index(T v, long long n) {
  long long k = (long long)v;
  if ((T)-1 > 0 && sizeof(T) == 8 && k < 0) return n - 1;
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}
template <typename T> TK_HD long long scatter_index(T v, long long n) {
  long long k = (long long)v;
  if (k < 0) k += n;
  return (k >= 0 && k < n) ? k : -1;
}

#ifdef __CUDACC__
TK_HD void atomic_add(float *p, float v) { atomicAdd(p, v); }
TK_HD void atomic_add(double *p, double v) { atomicAdd(p, v); }
TK_HD void atomic_add(int32_t *p, int32_t v) { atomicAdd((int *)p, (int)v); }
TK_HD void atomic_add(uint32_t *p, uint32_t v) {
  atomicAdd((unsigned int *)p, (unsigned int)v);
}
TK_HD void atomic_add(int64_t *p, int64_t v) {
  atomicAdd((unsigned long long *)p, (unsigned long long)v);
}
TK_HD void atomic_add(uint64_t *p, uint64_t v) {
  atomicAdd((unsigned long long *)p, (unsigned long long)v);
}
TK_HD void atomic_add_bf16(void *p, long long i, float v) {
  atomicAdd(static_cast<bf16_t *>(p) + i, __float2bfloat16_rn(v));
}
TK_HD void atomic_add_f16(void *p, long long i, float v) {
  atomicAdd(static_cast<f16_t *>(p) + i, __float2half_rn(v));
}
#define TK_KERNEL(name) extern "C" __global__ void __launch_bounds__(256) name
#define TK_LANES(i, n)                                                     \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;      \
       i < (n); i += (long long)gridDim.x * blockDim.x)
#else
template <typename T> inline void atomic_add(T *p, T v) { *p = add(*p, v); }
inline void atomic_add_bf16(void *p, long long i, float v) {
  st_bf16(p, i, rbf(ld_bf16(p, i) + v));
}
inline void atomic_add_f16(void *p, long long i, float v) {
  st_f16(p, i, rh(ld_f16(p, i) + v));
}
#define TK_KERNEL(name) static void name
#define TK_LANES(i, n) for (long long i = 0; i < (n); ++i)
#endif

// ---------------------------------------------------------------------------
// SCATTER_ADD into a small target: the sums kept in shared memory
// ---------------------------------------------------------------------------
//
// One global atomic add a lane serialises in L2 where many lanes hit few
// slots: a histogram of 16M normal samples into 64 bins put most adds on
// some 25 addresses, 4.49 ms on the H100, about 0.27 ns an add, one
// address after another. So codegen.py gives each SCATTER_ADD target of
// a run one of three routes when it writes the source, by the target's
// size and type (codegen.ROW_SLOTS, BLOCK_BYTES, ACC_SMEM):
//  1. RowAcc, for float32 targets of up to codegen.ROW_SLOTS slots: a
//     private row per thread in shared memory, slot-major and thread-minor
//     (rows[j * 256 + tid], so a warp's 32 adds hit 32 banks whatever
//     the slots), added to without atomics. After the lanes the block
//     sums each slot over its threads in a fixed order into its row of
//     `part` (global scratch, a row a block); the block that draws the
//     last ticket sums the rows in a fixed order (runs of consecutive
//     blocks, then the runs' sums) and adds them into the target
//     (csrc/hist.cu's route 1, csrc/pixel_sum.cuh's ticket). No
//     atomic touches a value, and the grid depends on the lane count
//     alone, so a float target is bitwise the same from run to run.
//  2. BlockAcc, for 32- and 64-bit int and float targets of at most
//     codegen.BLOCK_BYTES: one
//     copy of the target a block, added to with shared-memory atomics;
//     after the lanes one global atomic a slot the block touched.
//  3. A global atomic a lane (the code of the run's statement) for larger
//     targets and 16-bit floats (rounded after every add, which must
//     stay). A bool target has no SCATTER_ADD (LazyArray.scatter_add
//     refuses it, as JAX does).
// A private sum starts at 0, or at -0.0 for a float: a slot that gets
// nothing, or only -0.0, then adds -0.0 or nothing to the target, which
// leaves every bit of the target's base as it was, and a slot hit once by
// v gives base + v, the plain interpreter's one add.
//
// On the host each route is the plain sequential add into the target.

template <typename T> TK_HD T acc_zero() { return (T)0; }
template <> TK_HD float acc_zero<float>() { return -0.0f; }
template <> TK_HD double acc_zero<double>() { return -0.0; }
template <typename T> TK_HD bool acc_empty(T v) { return v == (T)0; }
TK_HD bool acc_empty(float v) { return bits<uint32_t>(v) == 0x80000000u; }
TK_HD bool acc_empty(double v) {
  return bits<uint64_t>(v) == 0x8000000000000000ull;
}

#ifdef __CUDACC__
constexpr int kThreads = 256;  // threads a block, every trace kernel

// a load from a buffer that nothing writes while the kernel runs (every
// input of a run): through the read-only path, which lets the compiler
// issue the loads of a thread's next lanes ahead of its shared-memory adds
template <typename T> TK_HD T ldg(const void *p, long long i) {
  if constexpr (sizeof(T) == 8) {
    return bits<T>(__ldg(static_cast<const unsigned long long *>(p) + i));
  } else if constexpr (sizeof(T) == 4) {
    return bits<T>(__ldg(static_cast<const unsigned int *>(p) + i));
  } else {
    return static_cast<const T *>(p)[i];
  }
}

template <typename T, int N> struct RowAcc {
  static_assert(N >= 1 && N <= kThreads, "a row a thread: 1-256 slots");
  static_assert(sizeof(T) == 4, "a block's row of part holds 32-bit sums");
  T *rows, *target;
  __device__ __forceinline__ RowAcc(void *tgt, unsigned char *sm, int off)
      : rows(reinterpret_cast<T *>(sm + off) + threadIdx.x),
        target(static_cast<T *>(tgt)) {
#pragma unroll
    for (int j = 0; j < N; ++j) rows[j * kThreads] = acc_zero<T>();
  }
  __device__ __forceinline__ void put(long long j, T v) {
    rows[j * kThreads] = tk::add(rows[j * kThreads], v);
  }
  // each slot's sum over the block's threads into the block's row of
  // part: a warp a slot, 8 rows a lane in order, then a butterfly
  __device__ __forceinline__ void to_part(uint32_t *part, int width,
                                          int off) const {
    const int lane = threadIdx.x & 31;
    const T *all = rows - threadIdx.x;
    for (int j = threadIdx.x >> 5; j < N; j += kThreads / 32) {
      const T *r = all + j * kThreads + lane;
      T s = r[0];
#pragma unroll
      for (int m = 1; m < kThreads / 32; ++m) s = tk::add(s, r[32 * m]);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        s = tk::add(s, __shfl_xor_sync(0xffffffffu, s, d));
      if (lane == 0)
        part[(long long)blockIdx.x * width + off + j] = bits<uint32_t>(s);
    }
  }
  // in the last block: the blocks' rows (from L2: this SM's L1 may hold
  // no other block's row) cut into Q runs of consecutive blocks, each run
  // summed in block order by a thread of its own, then the Q sums in
  // order, added into the target; the rows' shared memory, free by now,
  // holds the runs' sums
  __device__ __forceinline__ void flush(const uint32_t *part, int width,
                                        int off) {
    constexpr int Q = kThreads / N;
    T *sums = rows - threadIdx.x;
    const int j = threadIdx.x % N, q = threadIdx.x / N;
    if (q < Q) {
      const unsigned long long B = gridDim.x;
      const unsigned hi = (unsigned)(B * (q + 1) / Q);
      T s = acc_zero<T>();
#pragma unroll 4
      for (unsigned b = (unsigned)(B * q / Q); b < hi; ++b)
        s = tk::add(s, bits<T>(__ldcg(part + (long long)b * width + off + j)));
      sums[q * N + j] = s;
    }
    __syncthreads();
    if (threadIdx.x < N) {
      T s = sums[threadIdx.x];
      for (int k = 1; k < Q; ++k) s = tk::add(s, sums[k * N + threadIdx.x]);
      target[threadIdx.x] = tk::add(target[threadIdx.x], s);
    }
  }
};

template <typename T, int N> struct BlockAcc {
  T *copy, *target;
  __device__ __forceinline__ BlockAcc(void *tgt, unsigned char *sm, int off)
      : copy(reinterpret_cast<T *>(sm + off)), target(static_cast<T *>(tgt)) {
    for (int j = threadIdx.x; j < N; j += kThreads) copy[j] = acc_zero<T>();
  }
  __device__ __forceinline__ void put(long long j, T v) {
    atomic_add(copy + j, v);
  }
  __device__ __forceinline__ void flush() const {
    for (int j = threadIdx.x; j < N; j += kThreads) {
      const T v = copy[j];
      if (!acc_empty(v)) atomic_add(target + j, v);
    }
  }
};

TK_HD void sync() { __syncthreads(); }

// whether this block is the last of the grid to get here (every thread
// calls it, after its block's rows are written); the last one sets the
// ticket back to 0 for the stream's next launch
__device__ __forceinline__ bool last_block(unsigned *ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  return last;
}

// the grid of a run that accumulates: as many blocks as the card holds at
// once (its shared memory bounds them: 2-8 an SM), fewer where the lanes
// are fewer; `fit` caches the blocks an SM holds (0: not asked yet)
inline int acc_blocks(const void *kernel, int smem, int unroll, long long n,
                      int *fit) {
  int dev = 0, sms = 0, f = fit ? *fit : 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (f <= 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f, kernel, kThreads, smem);
    cudaGetLastError();  // a refusal shows at the launch, which returns it
    if (f > 0 && fit) *fit = f;
  }
  const long long need = (n + (long long)kThreads * unroll - 1) /
                         ((long long)kThreads * unroll);
  const long long cap = (long long)sms * (f > 0 ? f : 1);
  return (int)(need < 1 ? 1 : (need < cap ? need : cap));
}

// the lanes of a run that accumulates, `lane(i)` for each: unroll lanes at
// a time a thread, 256 apart (each of the unroll loads coalesced)
#define TK_LANES_BY(lane, n, unroll)                                         \
  do {                                                                       \
    const long long s_ = (long long)gridDim.x * blockDim.x * (unroll);       \
    long long i_ = (long long)blockIdx.x * blockDim.x * (unroll) +           \
                   threadIdx.x;                                              \
    for (; i_ + (long long)((unroll) - 1) * blockDim.x < (n); i_ += s_) {    \
      _Pragma("unroll") for (int u_ = 0; u_ < (unroll); ++u_)                \
          lane(i_ + (long long)u_ * blockDim.x);                             \
    }                                                                        \
    _Pragma("unroll 1") for (int u_ = 0; u_ < (unroll); ++u_) {              \
      if (i_ + (long long)u_ * blockDim.x < (n))                             \
        lane(i_ + (long long)u_ * blockDim.x);                               \
    }                                                                        \
  } while (0)
#define TK_SMEM(sm) extern __shared__ __align__(16) unsigned char sm[]
#else
template <typename T> inline T ldg(const void *p, long long i) {
  return ld<T>(p, i);
}

template <typename T, int N> struct RowAcc {
  T *target;
  RowAcc(void *tgt, unsigned char *, int) : target(static_cast<T *>(tgt)) {}
  void put(long long j, T v) { atomic_add(target + j, v); }
  void to_part(uint32_t *, int, int) const {}
  void flush(const uint32_t *, int, int) const {}
};

template <typename T, int N> struct BlockAcc {
  T *target;
  BlockAcc(void *tgt, unsigned char *, int) : target(static_cast<T *>(tgt)) {}
  void put(long long j, T v) { atomic_add(target + j, v); }
  void flush() const {}
};

inline void sync() {}
inline bool last_block(unsigned *) { return false; }

#define TK_LANES_BY(lane, n, unroll) \
  for (long long i_ = 0; i_ < (n); ++i_) lane(i_)
#define TK_SMEM(sm) unsigned char *sm = nullptr
#endif

}  // namespace tk

// the launch of one fused run: its pointers by value, the literal stream,
// a grid-stride grid of at most 32 blocks of 256 a multiprocessor (132 on
// the H100); returns the launch's cudaError_t (0 on the host)
template <int NP> struct TkPtrs { void *p[NP > 0 ? NP : 1]; };

#ifdef __CUDACC__
#define TK_LAUNCH(name, NP)                                                 \
  extern "C" int name##_launch(void *const *ptrs, const uint64_t *L,       \
                               long long n, void *stream) {                 \
    TkPtrs<NP> P;                                                           \
    for (int k = 0; k < NP; ++k) P.p[k] = ptrs[k];                          \
    long long blocks = (n + 255) / 256;                                     \
    if (blocks > 132 * 32) blocks = 132 * 32;                               \
    if (blocks < 1) blocks = 1;                                             \
    name<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(P, L, n);      \
    return (int)cudaGetLastError();                                         \
  }
// the launch of a run that accumulates (routes 1 and 2 above): SMEM bytes
// of dynamic shared memory, the grid of tk::acc_blocks (name_blocks(n),
// which the caller reads to size `part`: a row of route 1's slots a
// block), the stream's ticket (0 between launches)
#define TK_ACC_LAUNCH(name, NP, SMEM, UNROLL)                               \
  extern "C" int name##_blocks(long long n) {                               \
    static int fit[16];                                                     \
    int dev = 0;                                                            \
    cudaGetDevice(&dev);                                                    \
    return tk::acc_blocks((const void *)name, SMEM, UNROLL, n,              \
                          dev >= 0 && dev < 16 ? &fit[dev] : nullptr);      \
  }                                                                         \
  extern "C" int name##_launch(void *const *ptrs, const uint64_t *L,       \
                               long long n, void *stream, uint32_t *part,   \
                               unsigned *ticket) {                          \
    TkPtrs<NP> P;                                                           \
    for (int k = 0; k < NP; ++k) P.p[k] = ptrs[k];                          \
    if (SMEM > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          name, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);         \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    name<<<(unsigned)name##_blocks(n), 256, SMEM, (cudaStream_t)stream>>>(  \
        P, L, n, part, ticket);                                             \
    return (int)cudaGetLastError();                                         \
  }
#else
#define TK_LAUNCH(name, NP)                                                 \
  extern "C" int name##_launch(void *const *ptrs, const uint64_t *L,       \
                               long long n, void *) {                       \
    TkPtrs<NP> P;                                                           \
    for (int k = 0; k < NP; ++k) P.p[k] = ptrs[k];                          \
    name(P, L, n);                                                          \
    return 0;                                                               \
  }
#define TK_ACC_LAUNCH(name, NP, SMEM, UNROLL)                               \
  extern "C" int name##_blocks(long long) { return 1; }                     \
  extern "C" int name##_launch(void *const *ptrs, const uint64_t *L,       \
                               long long n, void *, uint32_t *part,         \
                               unsigned *ticket) {                          \
    TkPtrs<NP> P;                                                           \
    for (int k = 0; k < NP; ++k) P.p[k] = ptrs[k];                          \
    name(P, L, n, part, ticket);                                            \
    return 0;                                                               \
  }
#endif
