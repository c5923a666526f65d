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
// the SDF at the frozen root. This kernel does the same in reverse mode,
// by hand, per hit pixel and in registers: a forward sweep of the shade as
// _sdf_shade_tile writes it (the SDF sqrt(|p - c|^2 + 1e-12) - radius as
// x * rsqrt(x), its gradient, the normal, as d * rsqrt(x)), an adjoint
// sweep seeded with g that takes each operation's adjoint in reverse order
// (g * d img / d params and t_bar), an adjoint sweep of the SDF seeded
// with 1 (d sdf / d params and d sdf / dt), and the implicit term of
// implicit_t_vjp (render/implicit.py): w = -t_bar / (d sdf / dt), the
// slope guarded at 1e-6, sign-preserving, an exact zero taken as negative.
// None of sdf_bwd's projected closed form is shared, so the two kernels
// still check each other.
//
// The pixel layout, the loads and the cross-block sum are the pixel-sum
// skeleton's (pixel_sum.cuh), as sdf_bwd's: one launch, whose last block
// sums the blocks' rows in row order; no float atomics, bitwise identical
// gradients from run to run.
//
// Bound on this card: bytes (8 B/pixel read: g and ts). The function is
// sdf_bwd's, dp[16] from (params, g, ts), so it needs no more operations
// than the closed form's 89 per hit pixel; the two sweeps take 114 as
// written, which stay under the byte time at the reference scene's 54.5%
// hits. As sdf_bwd's, the time is the skeleton's more than the bytes'
// (PERF.md §6); the forward-mode duals took 1.55 times as long on it.

#include "common.cuh"
#include "pixel_sum.cuh"

namespace {

struct ReversePixel {
  static constexpr bool kReadsTs = true;

  struct Scene {
    float cx, cy, cz, gain, lx, ly, lz;
  };

  __device__ __forceinline__ static Scene scene(const float* params) {
    return Scene{params[0], params[1], params[2], params[5],
                 params[6], params[7], params[8]};
  }

  // The cotangent terms d of the hit pixel (col, row) at t; py is the
  // row's coordinate. (A miss shades to ambient + 0: d img / d ambient =
  // 1 and nothing else, :907-912 and the where(hit, ...) arm of the
  // shade; the skeleton adds its g.)
  __device__ __forceinline__ static void hit(const Scene& sc, float g,
                                             float t, int col, float py,
                                             float step, float extent,
                                             float (&d)[kNGrad]) {
    // forward sweep, at p = (px, py, -1 + t)
    const float dx = pixel_coord(col, step, extent) - sc.cx;
    const float dy = py - sc.cy;
    const float dz = (-1.0f + t) - sc.cz;
    const float x = dx * dx + dy * dy + dz * dz + 1e-12f;
    const float q = rsqrt_pos_(x);  // x >= 1e-12 is normal
    const float nx = dx * q, ny = dy * q, nz = dz * q;
    const float m = nx * nx + ny * ny + nz * nz + 1e-12f;
    const float inv = rsqrt_pos_(m);
    const float s = nx * sc.lx + ny * sc.ly + nz * sc.lz;
    const float y = s * inv;
    const float r = fmaxf(y, 0.0f);
    // max(y, 0)'s subgradient splits a tie 0.5/0.5, as jnp.maximum's
    const float r_slope = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);

    // adjoint sweep of img = amb + r * gain, seeded with g
    const float y_bar = g * sc.gain * r_slope;
    const float s_bar = y_bar * inv;
    const float inv_bar = y_bar * s;
    const float m_bar = inv_bar * (-0.5f * inv * inv * inv);
    const float nx_bar = s_bar * sc.lx + 2.0f * m_bar * nx;
    const float ny_bar = s_bar * sc.ly + 2.0f * m_bar * ny;
    const float nz_bar = s_bar * sc.lz + 2.0f * m_bar * nz;
    const float q_bar = nx_bar * dx + ny_bar * dy + nz_bar * dz;
    const float x_bar = q_bar * (-0.5f * q * q * q);
    const float dx_bar = nx_bar * q + 2.0f * x_bar * dx;
    const float dy_bar = ny_bar * q + 2.0f * x_bar * dy;
    const float dz_bar = nz_bar * q + 2.0f * x_bar * dz;  // also t_bar

    // adjoint sweep of sdf = x * q - radius, seeded with 1
    const float xs_bar = q + x * (-0.5f * q * q * q);
    const float dxs = 2.0f * xs_bar * dx;
    const float dys = 2.0f * xs_bar * dy;
    const float dzs = 2.0f * xs_bar * dz;  // d sdf / dt

    // the implicit root sdf(ray(t*), theta) = eps
    const float sgn = dzs == 0.0f ? -1.0f : (dzs > 0.0f ? 1.0f : -1.0f);
    const float slope = fabsf(dzs) > 1e-6f ? dzs : sgn;
    const float w = -dz_bar / slope;
    // d / dc = -d / dd; d sdf / d radius = -1
    d[0] = -dx_bar - w * dxs;
    d[1] = -dy_bar - w * dys;
    d[2] = -dz_bar - w * dzs;
    d[3] = -w;
    d[4] = g;
    d[5] = g * r;
    d[6] = s_bar * nx;
    d[7] = s_bar * ny;
    d[8] = s_bar * nz;
  }
};

}  // namespace

extern "C" {

int sdf_bwd_ad_num_blocks(int n) {
  return pixel_sum_num_blocks<kPixelSumThreads, kPixelSumPixels>(n);
}

// partial has sdf_bwd_ad_num_blocks(n) rows of 9, ticket is 0 (and is 0
// again when the launch ends); vec: see pixel_sum.cuh.
int sdf_bwd_ad_launch(const float* params, const float* g, const float* ts,
                      float* partial, unsigned* ticket, float* dp, int n,
                      float step, float extent, int vec,
                      cudaStream_t stream) {
  return pixel_sum_launch<ReversePixel, kPixelSumThreads, kPixelSumPixels>(
      params, g, ts, partial, ticket, dp, n, step, extent, vec, stream);
}

}  // extern "C"
