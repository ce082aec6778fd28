// Device functions shared by the Klein and Babai (klein.cu, klein_tc.cu),
// IMHK (imhk_tc.cu), SMK (smk_tc.cu), Peikert (peikert_tc.cu) and Z^n (zn.cu)
// kernels on Hopper (sm_90a): Philox4x32-10, the windowed inverse-CDF row
// draw and its log-normalizer, and for klein.cu the coupling passes of a
// backward substitution over 64-row blocks and the Klein proposal sweep,
// one thread per chain on a chain-minor (n_pad, B) state.
//
// expf and logf are the accurate versions (no --use_fast_math); the logit
// and CDF arithmetic uses explicitly rounded operations so that the compiler
// does not contract it into FMAs the plain PyTorch versions do not make.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgk {

constexpr int RB = 64;        // rows per block of the backward substitution
constexpr int THREADS = 128;  // chains per thread block
constexpr int ACCEPT_ROWS = 8;
constexpr uint32_t TAG_ROW = 0;
constexpr uint32_t TAG_ACCEPT = 1;
constexpr uint32_t TAG_NORMAL = 2;
constexpr uint32_t TAG_ZN = 4;

// Philox4x32-10 with counter (c0, c1, c2, c3) and key (k0, k1): the
// function of lattice_gaussian_mcmc_tpu_torch/utils/prng.py, bit for bit.
__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1,
                                         uint32_t c2, uint32_t c3,
                                         uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// 23 random mantissa bits under the exponent of 1.0, minus 1: [0, 1)
__device__ __forceinline__ float mantissa_uniform(uint32_t bits) {
  return __fsub_rn(__int_as_float((int)((bits & 0x7FFFFFu) | 0x3F800000u)),
                   1.0f);
}

// mantissa_uniform half a step up, (k + 1/2) 2^-23 in (0, 1), in one
// subtraction as exact as its: 1 + k 2^-23 minus 1 - 2^-24 (the FALCON
// signer's draws; utils/prng.py `philox_midpoint`)
__device__ __forceinline__ float midpoint_uniform(uint32_t bits) {
  return __fsub_rn(__int_as_float((int)((bits & 0x7FFFFFu) | 0x3F800000u)),
                   0x1.fffffep-1f);
}

// One uniform source: host rows (host != nullptr) or in-kernel Philox
// (output word 0 of counter (chain id, row, step, tag)).
struct Uniforms {
  const float* host;
  long long B;
  uint32_t k0, k1;

  // MID: Philox's midpoint_uniform in place of mantissa_uniform
  template <bool MID = false>
  __device__ __forceinline__ float get(long long host_row, long long chain,
                                       uint32_t chain_id, uint32_t row,
                                       uint32_t step, uint32_t tag) const {
    if (host) return host[(size_t)host_row * (size_t)B + (size_t)chain];
    const uint32_t w = philox4(chain_id, row, step, tag, k0, k1).x;
    return MID ? midpoint_uniform(w) : mantissa_uniform(w);
  }
};

// Unnormalised window weight of offset `off` from base = rint(c):
// exp(-a (off^2 / 2 + delta off)) = exp(off * nad + (off^2 / 2) * (-a)).
__device__ __forceinline__ float window_weight(int k, int half, float nad,
                                               float a) {
  const float off = (float)(k - half);
  const float offh = __fmul_rn(__fmul_rn(0.5f, off), off);
  return expf(__fadd_rn(__fmul_rn(off, nad), __fmul_rn(offh, -a)));
}

// Windowed inverse-CDF draw around c with inverse width isg. W > 0:
// compile-time window with the CDF in registers; W == 0: runtime window,
// two passes that recompute identical weights. logz = log of the window's
// normaliser sum_k exp(-(base + off_k - c)^2 isg^2 / 2).
template <int W>
__device__ __forceinline__ float draw_row(float c, float isg, float u,
                                          int window, float& logz) {
  const float base = rintf(c);
  const float delta = __fsub_rn(base, c);
  const float a = __fmul_rn(isg, isg);
  const float nad = __fmul_rn(-a, delta);
  const float m = __fmul_rn(__fmul_rn(-0.5f, a), __fmul_rn(delta, delta));
  const int w = W > 0 ? W : window;
  const int half = w / 2;
  int idx = 0;
  float total = 0.0f;
  if constexpr (W > 0) {
    float cdf[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      total = __fadd_rn(total, window_weight(k, half, nad, a));
      cdf[k] = total;
    }
    const float target = __fmul_rn(u, total);
#pragma unroll
    for (int k = 0; k < W; ++k) idx += cdf[k] < target ? 1 : 0;
  } else {
    for (int k = 0; k < w; ++k)
      total = __fadd_rn(total, window_weight(k, half, nad, a));
    const float target = __fmul_rn(u, total);
    float run = 0.0f;
    for (int k = 0; k < w; ++k) {
      run = __fadd_rn(run, window_weight(k, half, nad, a));
      idx += run < target ? 1 : 0;
    }
  }
  idx = min(idx, w - 1);
  logz = __fadd_rn(m, logf(total));
  return __fadd_rn(base, (float)(idx - half));
}

// The log-normaliser of draw_row alone: no uniform, no CDF, no compare.
template <int W>
__device__ __forceinline__ float log_normalizer(float c, float isg,
                                                int window) {
  const float base = rintf(c);
  const float delta = __fsub_rn(base, c);
  const float a = __fmul_rn(isg, isg);
  const float nad = __fmul_rn(-a, delta);
  const float m = __fmul_rn(__fmul_rn(-0.5f, a), __fmul_rn(delta, delta));
  const int w = W > 0 ? W : window;
  const int half = w / 2;
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < w; ++k)
    total = __fadd_rn(total, window_weight(k, half, nad, a));
  return __fadd_rn(m, logf(total));
}

struct Operands {
  const float* U;    // (n_pad, n_pad) row-major
  const float* UT;   // U transposed
  const float* cs;   // (n_pad,) recentered centre
  const float* isg;  // (n_pad,) 1 / sigma_i
  int n_pad;
  int window;
};

// Cross-block coupling of rows lo .. lo+63 to the rows j >= lo+64 already
// solved in column `chain` of ybuf (n_pad, B): one pass over those rows,
// each y_j read once and multiplied into 64 register accumulators by a
// column of U (contiguous in UT, warp-uniform float4 loads), FP32 FMA. The
// 64 sums go to the thread's column `col` of the shared tile (stride
// THREADS).
__device__ __forceinline__ void cross_block(const float* __restrict__ UT,
                                            int n_pad, int lo,
                                            const float* __restrict__ ybuf,
                                            long long B, long long chain,
                                            float* col) {
  const int hi = lo + RB;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
  for (int j = hi; j < n_pad; ++j) {
    const float yj = ybuf[(size_t)j * (size_t)B + (size_t)chain];
    const float4* u4 =
        reinterpret_cast<const float4*>(UT + (size_t)j * n_pad + lo);
#pragma unroll
    for (int q = 0; q < RB / 4; ++q) {
      const float4 u = __ldg(u4 + q);
      acc[4 * q + 0] = fmaf(u.x, yj, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(u.y, yj, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(u.z, yj, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(u.w, yj, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) col[r * THREADS] = acc[r];
}

// Row lo + r's centre from its centre c0 and the tile after cross_block:
// c0 - col[r] - sum_{rr>r} U_{i, lo+rr} col[rr], the within-block rows
// already solved (FP32 FMA, rr = r+1 upward).
__device__ __forceinline__ float row_centre(float c0,
                                            const float* __restrict__ Ui,
                                            const float* col, int r) {
  float c = __fsub_rn(c0, col[r * THREADS]);
  for (int rr = r + 1; rr < RB; ++rr)
    c = fmaf(-__ldg(Ui + rr), col[rr * THREADS], c);
  return c;
}

// One Klein draw of this thread's chain into column `chain` of ybuf
// (n_pad, B); `col` is the thread's column of the shared tile (stride
// THREADS). Host uniform row of coordinate i is host_row0 + i.
template <int W>
__device__ double propose(const Operands& op, float* __restrict__ ybuf,
                          long long B, long long chain, uint32_t chain_id,
                          float* col, const Uniforms& un,
                          long long host_row0, uint32_t step) {
  const int n_pad = op.n_pad;
  double lw = 0.0;
  for (int lo = n_pad - RB; lo >= 0; lo -= RB) {
    cross_block(op.UT, n_pad, lo, ybuf, B, chain, col);
    for (int r = RB - 1; r >= 0; --r) {
      const int i = lo + r;
      const size_t at = (size_t)i * (size_t)B + (size_t)chain;
      const float* Ui = op.U + (size_t)i * n_pad + lo;
      const float c = row_centre(__ldg(op.cs + i), Ui, col, r);
      const float u = un.get(host_row0 + i, chain, chain_id, (uint32_t)i,
                             step, TAG_ROW);
      float logz;
      const float y = draw_row<W>(c, __ldg(op.isg + i), u, op.window, logz);
      col[r * THREADS] = y;
      ybuf[at] = y;
      lw += (double)logz;
    }
  }
  return lw;
}

constexpr size_t kSmem = (size_t)RB * THREADS * sizeof(float);

inline dim3 grid_for(long long B) {
  return dim3((unsigned)((B + THREADS - 1) / THREADS));
}

}  // namespace lgk

// Window 16 (the flagship's) is compiled with its CDF in registers; any
// other window takes the runtime-window path.
#define KLEIN_BY_WINDOW(window, CALL) \
  return (window) == 16 ? CALL(16) : CALL(0);
