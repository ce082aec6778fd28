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

// The window's unnormalised weights w(off) = exp(off nad - a off^2 / 2),
// a = isg^2, nad = -a delta, for the offsets off = -W/2 .. W - W/2 - 1 from
// base = rint(c). They go in segments of SEG offsets aligned on the centre,
// [0, 7], [8, 15], ... and [-8, -1], [-16, -9], ... (the window's edge may
// cut the last one short), each walked away from the centre from its
// anchor, the offset nearest 0: w(k + d) = w(k) rho, then rho = rho e, with
// e = exp(-a) once a row and d = +-1. The anchor's weight is expf of the
// argument of `weight_arg`; its first ratio is one more expf,
// exp(d nad - a (|k| + 1/2)), except at the anchors 0 and -1: w(0) = 1 with
// ratio w(1), and w(-1) with ratio w(-1) e. A weight is a function of its
// offset alone, so every split of the window computes the same weights.
constexpr int SEG = 8;

// off nad + (off^2 / 2) (-a), rounded as written
__device__ __forceinline__ float weight_arg(float off, float nad, float a) {
  const float offh = __fmul_rn(__fmul_rn(0.5f, off), off);
  return __fadd_rn(__fmul_rn(off, nad), __fmul_rn(offh, -a));
}

// Anchor of segment q on the upper side (up: offsets SEG q ..) or the lower
// (offsets -SEG q - 1 ..): its weight w and the ratio rho to the next
// weight away from the centre.
__device__ __forceinline__ void anchor(int q, bool up, float nad, float a,
                                       float e, float& w, float& rho) {
  if (q == 0) {
    const float x = expf(__fadd_rn(up ? nad : -nad, __fmul_rn(0.5f, -a)));
    w = up ? 1.0f : x;
    rho = up ? x : __fmul_rn(x, e);
  } else {
    const float off = up ? (float)(SEG * q) : (float)(-SEG * q - 1);
    w = expf(weight_arg(off, nad, a));
    rho = expf(__fadd_rn(up ? nad : -nad, __fmul_rn(fabsf(off) + 0.5f, -a)));
  }
}

// Segment q of one side in walk order: s[t] is the weight of offset
// SEG q + t (up) or -SEG q - 1 - t (down); where the window's edge cuts the
// segment short, the weights past it go unused.
__device__ __forceinline__ void side_segment(int q, bool up, float nad,
                                             float a, float e,
                                             float (&s)[SEG]) {
  float w, rho;
  anchor(q, up, nad, a, e, w, rho);
  s[0] = w;
#pragma unroll
  for (int t = 1; t < SEG; ++t) {
    w = __fmul_rn(w, rho);
    rho = __fmul_rn(rho, e);
    s[t] = w;
  }
}

// The N weights of one side in walk order: wt[t] is the weight of offset t
// (up) or -1 - t (down).
template <int N>
__device__ __forceinline__ void side_weights(float (&wt)[N], bool up,
                                             float nad, float a, float e) {
#pragma unroll
  for (int q = 0; SEG * q < N; ++q) {
    float s[SEG];
    side_segment(q, up, nad, a, e, s);
#pragma unroll
    for (int t = 0; t < SEG; ++t)
      if (SEG * q + t < N) wt[SEG * q + t] = s[t];
  }
}

// The W weights of a compile-time window in ascending order of offset.
template <int W>
__device__ __forceinline__ void window_weights(float (&w)[W], float nad,
                                               float a) {
  static_assert(W >= 2, "a window of at least 2");
  constexpr int LO = W / 2, HI = W - W / 2;
  const float e = expf(-a);
  float lo[LO], hi[HI];
  side_weights(lo, false, nad, a, e);
  side_weights(hi, true, nad, a, e);
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = k < LO ? lo[LO - 1 - k] : hi[k - LO];
}

// f(weight) for each offset of a runtime window of w, in ascending order:
// one segment at a time into SEG registers, then handed on in order.
template <class F>
__device__ __forceinline__ void for_each_weight(int w, float nad, float a,
                                                F&& f) {
  const int lo = w / 2, hi = w - w / 2;
  const float e = expf(-a);
  float s[SEG];
  for (int q = (lo + SEG - 1) / SEG - 1; q >= 0; --q) {
    const int n = min(SEG, lo - SEG * q);
    side_segment(q, false, nad, a, e, s);
#pragma unroll
    for (int t = SEG - 1; t >= 0; --t)
      if (t < n) f(s[t]);
  }
  for (int q = 0; SEG * q < hi; ++q) {
    const int n = min(SEG, hi - SEG * q);
    side_segment(q, true, nad, a, e, s);
#pragma unroll
    for (int t = 0; t < SEG; ++t)
      if (t < n) f(s[t]);
  }
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
    window_weights<W>(cdf, nad, a);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      total = __fadd_rn(total, cdf[k]);
      cdf[k] = total;
    }
    const float target = __fmul_rn(u, total);
#pragma unroll
    for (int k = 0; k < W; ++k) idx += cdf[k] < target ? 1 : 0;
  } else {
    for_each_weight(w, nad, a, [&](float v) { total = __fadd_rn(total, v); });
    const float target = __fmul_rn(u, total);
    float run = 0.0f;
    for_each_weight(w, nad, a, [&](float v) {
      run = __fadd_rn(run, v);
      idx += run < target ? 1 : 0;
    });
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
  float total = 0.0f;
  if constexpr (W > 0) {
    float wk[W];
    window_weights<W>(wk, nad, a);
#pragma unroll
    for (int k = 0; k < W; ++k) total = __fadd_rn(total, wk[k]);
  } else {
    for_each_weight(window, nad, a,
                    [&](float v) { total = __fadd_rn(total, v); });
  }
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
