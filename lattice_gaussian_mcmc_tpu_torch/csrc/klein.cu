// Klein draw and fused IMHK steps on Hopper (sm_90a), one thread per chain.
//
// Replaces the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/klein_pallas.py `_kernel` in its
// draw mode (klein_sample_batch_pallas, B1) and its fused Metropolis-Hastings
// mode (imhk_step_pallas_fused / imhk_steps_batch_pallas, B2). The law is
// the same; the TPU layout devices (bf16 split of U, CDF as a triangular
// matrix product, (8, 128) row groups) are not carried over.
//
// What it computes, per chain, for rows i = n_pad-1 down to 0:
//   c_i   = cs_i - sum_{j>i} U_ij y_j          (FP32 FMA on the CUDA cores)
//   base  = rint(c_i) (half to even), delta = base - c_i, a = isg_i^2
//   w_k   = exp(-a (off_k^2 / 2 + delta off_k)), off_k in [-W/2, W/2 - 1]
//   idx   = #{k : cdf_k < u total} clipped to W-1, cdf a sequential sum
//   y_i   = base + idx - W/2,  log Z_i = -a delta^2 / 2 + log(total)
// and lw = sum_i log Z_i accumulated in double. Fused mode then accepts
// iff log max(u, 1e-30) < lw_prop - lw, per chain, n_steps times.
//
// Design. The state is chain-minor (n_pad, B): thread t of a block owns
// chain blockIdx.x * 128 + t, so every row access of a warp is one
// coalesced 128-byte line and no two threads touch the same chain (each
// block owns disjoint chains; there is no inter-thread sharing at all).
// Rows go in 64-row blocks. For a block [lo, lo+64) the coupling to the
// already drawn rows j >= lo+64 is one pass over those rows: y_j is read
// once from device memory and multiplied into 64 register accumulators by
// a column of U (contiguous in UT, read as uniform float4 loads that every
// thread of the warp shares). The 64 partial centres, and then the 64 draws,
// live in the thread's own column of a 64 x 128 float shared-memory tile
// (32 KB per block), so the within-block coupling reads shared memory.
//
// Bound (n = 1024, W = 16): per proposal per chain about n^2/2 = 5.2e5 FMAs
// of coupling (1.05e6 FLOP) plus n W = 16,384 exps; at 524,288 chains that
// is ~5.5e11 FLOP per IMHK step against 67 TFLOP/s of FP32 on the CUDA
// cores (8.2 ms). Device-memory traffic per step: the proposal is written
// once and each 64-row block re-reads the rows below it (~30 KB per chain,
// ~16 GB per step), plus the accept copy of 4 KB per chain: about 5-7 ms at
// 3.35 TB/s. So the kernel sits near the balance point of both; this
// version aims to be right and simple, not at either roof.
//
// Randomness: host uniforms (tests and kernel-vs-plain checks) or
// Philox4x32-10 with counter (chain id, row, step, tag) and key (seed lo,
// seed hi), output word 0, mantissa-trick uniform in [0, 1) — the function
// of lattice_gaussian_mcmc_tpu_torch/utils/prng.py, bit for bit. No curand.
//
// expf and logf are the accurate versions (no --use_fast_math); the logit
// and CDF arithmetic uses explicitly rounded operations so that the compiler
// does not contract it into FMAs the plain PyTorch version does not make.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 64;        // rows per block of the backward substitution
constexpr int THREADS = 128;  // chains per thread block
constexpr int ACCEPT_ROWS = 8;
constexpr uint32_t TAG_ROW = 0;
constexpr uint32_t TAG_ACCEPT = 1;

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
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
  return c0;
}

__device__ __forceinline__ float mantissa_uniform(uint32_t bits) {
  return __fsub_rn(__int_as_float((int)((bits & 0x7FFFFFu) | 0x3F800000u)),
                   1.0f);
}

// One uniform source: host rows (host != nullptr) or in-kernel Philox.
struct Uniforms {
  const float* host;
  long long B;
  uint32_t k0, k1;

  __device__ __forceinline__ float get(long long host_row, long long chain,
                                       uint32_t chain_id, uint32_t row,
                                       uint32_t step, uint32_t tag) const {
    if (host) return host[(size_t)host_row * (size_t)B + (size_t)chain];
    return mantissa_uniform(philox_word0(chain_id, row, step, tag, k0, k1));
  }
};

// Windowed inverse-CDF draw. W > 0: compile-time window with the CDF in
// registers; W == 0: runtime window, two passes that recompute identical
// weights.
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
      const float off = (float)(k - half);
      const float offh = __fmul_rn(__fmul_rn(0.5f, off), off);
      total = __fadd_rn(total,
                        expf(__fadd_rn(__fmul_rn(off, nad),
                                       __fmul_rn(offh, -a))));
      cdf[k] = total;
    }
    const float target = __fmul_rn(u, total);
#pragma unroll
    for (int k = 0; k < W; ++k) idx += cdf[k] < target ? 1 : 0;
  } else {
    for (int k = 0; k < w; ++k) {
      const float off = (float)(k - half);
      const float offh = __fmul_rn(__fmul_rn(0.5f, off), off);
      total = __fadd_rn(total,
                        expf(__fadd_rn(__fmul_rn(off, nad),
                                       __fmul_rn(offh, -a))));
    }
    const float target = __fmul_rn(u, total);
    float run = 0.0f;
    for (int k = 0; k < w; ++k) {
      const float off = (float)(k - half);
      const float offh = __fmul_rn(__fmul_rn(0.5f, off), off);
      run = __fadd_rn(run, expf(__fadd_rn(__fmul_rn(off, nad),
                                          __fmul_rn(offh, -a))));
      idx += run < target ? 1 : 0;
    }
  }
  idx = min(idx, w - 1);
  logz = __fadd_rn(m, logf(total));
  return __fadd_rn(base, (float)(idx - half));
}

struct Operands {
  const float* U;    // (n_pad, n_pad) row-major
  const float* UT;   // U transposed
  const float* cs;   // (n_pad,) recentered centre
  const float* isg;  // (n_pad,) 1 / sigma_i
  int n_pad;
  int window;
};

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
    const int hi = lo + RB;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    for (int j = hi; j < n_pad; ++j) {
      const float yj = ybuf[(size_t)j * (size_t)B + (size_t)chain];
      const float4* u4 =
          reinterpret_cast<const float4*>(op.UT + (size_t)j * n_pad + lo);
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
    for (int r = RB - 1; r >= 0; --r) {
      const int i = lo + r;
      float c = __fsub_rn(__ldg(op.cs + i), col[r * THREADS]);
      const float* Ui = op.U + (size_t)i * n_pad + lo;
      for (int rr = r + 1; rr < RB; ++rr)
        c = fmaf(-__ldg(Ui + rr), col[rr * THREADS], c);
      const float u = un.get(host_row0 + i, chain, chain_id, (uint32_t)i,
                             step, TAG_ROW);
      float logz;
      const float y = draw_row<W>(c, __ldg(op.isg + i), u, op.window, logz);
      col[r * THREADS] = y;
      ybuf[(size_t)i * (size_t)B + (size_t)chain] = y;
      lw += (double)logz;
    }
  }
  return lw;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
    klein_draw_kernel(Operands op, Uniforms un, float* __restrict__ y,
                      float* __restrict__ lw_out, long long B, uint32_t step,
                      uint32_t chain_offset) {
  extern __shared__ float tile[];
  const long long chain = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (chain >= B) return;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  const double lw = propose<W>(op, y, B, chain, chain_id,
                               tile + threadIdx.x, un, 0, step);
  lw_out[chain] = (float)lw;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
    imhk_fused_kernel(Operands op, Uniforms un, float* __restrict__ x,
                      float* __restrict__ lw_state, float* __restrict__ acc,
                      float* __restrict__ prop, long long B, int n_steps,
                      uint32_t step0, uint32_t chain_offset) {
  extern __shared__ float tile[];
  const long long chain = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (chain >= B) return;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  const int n_pad = op.n_pad;
  float lw = lw_state[chain];
  float a = acc[chain];
  for (int s = 0; s < n_steps; ++s) {
    const uint32_t step = step0 + (uint32_t)s;
    const long long row0 = (long long)s * (n_pad + ACCEPT_ROWS);
    const float lwp = (float)propose<W>(op, prop, B, chain, chain_id,
                                        tile + threadIdx.x, un, row0, step);
    float u = un.get(row0 + n_pad, chain, chain_id, 0u, step, TAG_ACCEPT);
    u = fmaxf(u, 1e-30f);
    if (logf(u) < __fsub_rn(lwp, lw)) {
      for (int i = 0; i < n_pad; ++i) {
        const size_t at = (size_t)i * (size_t)B + (size_t)chain;
        x[at] = prop[at];
      }
      lw = lwp;
      a = __fadd_rn(a, 1.0f);
    }
  }
  lw_state[chain] = lw;
  acc[chain] = a;
}

constexpr size_t kSmem = (size_t)RB * THREADS * sizeof(float);

inline dim3 grid_for(long long B) {
  return dim3((unsigned)((B + THREADS - 1) / THREADS));
}

template <int W>
int launch_draw(const Operands& op, const Uniforms& un, float* y, float* lw,
                long long B, uint32_t step, uint32_t chain_offset,
                cudaStream_t stream) {
  klein_draw_kernel<W><<<grid_for(B), THREADS, kSmem, stream>>>(
      op, un, y, lw, B, step, chain_offset);
  return (int)cudaGetLastError();
}

template <int W>
int launch_fused(const Operands& op, const Uniforms& un, float* x, float* lw,
                 float* acc, float* prop, long long B, int n_steps,
                 uint32_t step, uint32_t chain_offset, cudaStream_t stream) {
  imhk_fused_kernel<W><<<grid_for(B), THREADS, kSmem, stream>>>(
      op, un, x, lw, acc, prop, B, n_steps, step, chain_offset);
  return (int)cudaGetLastError();
}

// Window 16 (the flagship's) is compiled with its CDF in registers; any
// other window takes the runtime-window path.
#define KLEIN_BY_WINDOW(window, CALL) \
  return (window) == 16 ? CALL(16) : CALL(0);

}  // namespace

extern "C" {

// B1: one Klein draw per chain. unif: (n_pad, B) or null for Philox.
int klein_draw_launch(const float* U, const float* UT, const float* cs,
                      const float* isg, const float* unif, float* y,
                      float* lw, int n_pad, long long B, int window,
                      uint32_t seed_lo, uint32_t seed_hi, uint32_t step,
                      uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  const Operands op{U, UT, cs, isg, n_pad, window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(W) launch_draw<W>(op, un, y, lw, B, step, chain_offset, st)
  KLEIN_BY_WINDOW(window, CALL)
#undef CALL
}

// B2: n_steps fused IMHK steps; x (n_pad, B), lw (B,), acc (B,) in place,
// prop (n_pad, B) scratch. unif: (n_steps * (n_pad + 8), B) or null.
int imhk_fused_launch(const float* U, const float* UT, const float* cs,
                      const float* isg, const float* unif, float* x,
                      float* lw, float* acc, float* prop, int n_pad,
                      long long B, int window, int n_steps, uint32_t seed_lo,
                      uint32_t seed_hi, uint32_t step, uint32_t chain_offset,
                      void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 || n_steps <= 0)
    return (int)cudaErrorInvalidValue;
  const Operands op{U, UT, cs, isg, n_pad, window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(W) \
  launch_fused<W>(op, un, x, lw, acc, prop, B, n_steps, step, chain_offset, st)
  KLEIN_BY_WINDOW(window, CALL)
#undef CALL
}

const char* klein_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
