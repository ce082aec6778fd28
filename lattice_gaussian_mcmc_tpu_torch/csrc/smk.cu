// Fused symmetric Metropolis-Klein (SMK) steps on Hopper (sm_90a), one
// thread per chain.
//
// Replaces the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/smk_pallas.py `_smk_kernel`
// (_smk_steps_jit / smk_steps_batch_pallas, B4). The law is the same; the
// TPU layout devices (bf16 split of U, CDF as a matrix product, 8-row
// groups with Kahan sums, the state in scratch to dodge an aliased-window
// DMA race) are not carried over.
//
// What it computes, per chain, in the recentered frame y = x - k of the
// target precomputation (U unit upper triangular, k = round(cs)):
//   once per launch   ct = U y                      (current centres)
//   per step          a Klein sweep around ct (klein_common.cuh `propose`
//                     with SMK = true): row i draws around
//                     c_i = ct_i - sum_{j>i} U_ij y'_j with the proposal
//                     widths, and stores ctn_i = y'_i + coupling_i = (U y')_i;
//                     lw_fwd = sum_i log Z_i(c_i)
//                     then, rows independent:
//                     c'_i = ctn_i - ct_i + y_i     (reverse centres)
//                     lw_rev = sum_i log Z_i(c'_i)
//                     qn = sum_i (wqt_i (ctn_i - cse_i))^2, qc likewise at ct
//                     log alpha = (qc - qn) + (lw_fwd - lw_rev)
//                     accept iff log max(u, 1e-30) < log alpha: y <- y',
//                     ct <- ctn
// with wqt_i = R_ii / (sqrt(2) sigma_target) and cse the recentered target
// centre; the four sums are accumulated in double. The proposal's quadratic
// terms cancel exactly (y'_i - c_i = ctn_i - ct_i = -(y_i - c'_i)), so the
// proposal ratio is the difference of the two log-normaliser sums.
//
// Design. As in klein.cu: chain-minor (n_pad, B) buffers, thread t of a
// block owns one chain, rows in 64-row blocks with U's columns read as
// warp-uniform float4 loads. The state x, the centres ct, the proposal and
// its centres ctn are four separate buffers; only the owning thread reads
// or writes a chain's column of any of them, so the in-place updates on
// accept cannot race (the Pallas kernel's aliasing race, smk_pallas.py
// :275-284, has no counterpart here).
//
// Bound (n = 1024, proposal window W): per step per chain one Klein sweep
// (n^2/2 FMAs plus n W exps and the CDF) and n W more exps for the reverse
// normalisers; per launch one U y product (n^2/2 FMAs). Device memory per
// step: the sweep's traffic as in klein.cu plus reading ct, ctn and x in
// the reverse pass and the 8 KB accept copy per chain. Right and simple
// first: no attempt at either roof.

#include "klein_common.cuh"

using namespace lgk;

namespace {

template <int W>
__global__ void __launch_bounds__(THREADS)
    smk_kernel(Operands op, const float* __restrict__ wqt, Uniforms un,
               float* __restrict__ x, float* __restrict__ acc,
               float* __restrict__ ct, float* __restrict__ prop,
               float* __restrict__ ctn, float* __restrict__ la_out,
               long long B, int n_steps, uint32_t step0,
               uint32_t chain_offset) {
  extern __shared__ float tile[];
  const long long chain = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (chain >= B) return;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  const int n_pad = op.n_pad;

  // ct = U y: for the 64-row block [lo, lo+64) one pass over rows j >= lo
  // (U is zero below its unit diagonal, so the full columns give exactly
  // y_i + sum_{j>i} U_ij y_j)
  for (int lo = 0; lo < n_pad; lo += RB) {
    float cacc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) cacc[r] = 0.0f;
    for (int j = lo; j < n_pad; ++j) {
      const float xj = x[(size_t)j * (size_t)B + (size_t)chain];
      const float4* c4 =
          reinterpret_cast<const float4*>(op.UT + (size_t)j * n_pad + lo);
#pragma unroll
      for (int q = 0; q < RB / 4; ++q) {
        const float4 v = __ldg(c4 + q);
        cacc[4 * q + 0] = fmaf(v.x, xj, cacc[4 * q + 0]);
        cacc[4 * q + 1] = fmaf(v.y, xj, cacc[4 * q + 1]);
        cacc[4 * q + 2] = fmaf(v.z, xj, cacc[4 * q + 2]);
        cacc[4 * q + 3] = fmaf(v.w, xj, cacc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
      ct[(size_t)(lo + r) * (size_t)B + (size_t)chain] = cacc[r];
  }

  float a = acc[chain];
  float la = 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    const uint32_t step = step0 + (uint32_t)s;
    const long long row0 = (long long)s * (n_pad + ACCEPT_ROWS);
    const double lwf = propose<W, true>(op, prop, B, chain, chain_id,
                                        tile + threadIdx.x, un, row0, step,
                                        ct, ctn);
    double lwr = 0.0, qn = 0.0, qc = 0.0;
    for (int i = 0; i < n_pad; ++i) {
      const size_t at = (size_t)i * (size_t)B + (size_t)chain;
      const float cti = ct[at], ctni = ctn[at];
      const float cp = __fadd_rn(__fsub_rn(ctni, cti), x[at]);
      lwr += (double)log_normalizer<W>(cp, __ldg(op.isg + i), op.window);
      const float wq = __ldg(wqt + i), ce = __ldg(op.cs + i);
      const float tn = __fmul_rn(wq, __fsub_rn(ctni, ce));
      const float tc = __fmul_rn(wq, __fsub_rn(cti, ce));
      qn += (double)__fmul_rn(tn, tn);
      qc += (double)__fmul_rn(tc, tc);
    }
    la = (float)((qc - qn) + (lwf - lwr));
    float u = un.get(row0 + n_pad, chain, chain_id, 0u, step, TAG_ACCEPT);
    u = fmaxf(u, 1e-30f);
    if (logf(u) < la) {
      for (int i = 0; i < n_pad; ++i) {
        const size_t at = (size_t)i * (size_t)B + (size_t)chain;
        x[at] = prop[at];
        ct[at] = ctn[at];
      }
      a = __fadd_rn(a, 1.0f);
    }
  }
  acc[chain] = a;
  if (la_out != nullptr) la_out[chain] = la;
}

template <int W>
int launch_smk(const Operands& op, const float* wqt, const Uniforms& un,
               float* x, float* acc, float* ct, float* prop, float* ctn,
               float* la, long long B, int n_steps, uint32_t step,
               uint32_t chain_offset, cudaStream_t stream) {
  smk_kernel<W><<<grid_for(B), THREADS, kSmem, stream>>>(
      op, wqt, un, x, acc, ct, prop, ctn, la, B, n_steps, step,
      chain_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4: n_steps fused SMK steps. x (n_pad, B) recentered state and acc (B,)
// in place; ct, prop, ctn (n_pad, B) scratch; la (B,) receives the last
// step's log alpha, or null. cse, isgp, wqt: (n_pad,) target centre,
// inverse proposal widths, R_ii / (sqrt 2 sigma_target). unif:
// (n_steps * (n_pad + 8), B) or null for Philox.
int smk_steps_launch(const float* U, const float* UT, const float* cse,
                     const float* isgp, const float* wqt, const float* unif,
                     float* x, float* acc, float* ct, float* prop, float* ctn,
                     float* la, int n_pad, long long B, int window,
                     int n_steps, uint32_t seed_lo, uint32_t seed_hi,
                     uint32_t step, uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 || n_steps <= 0)
    return (int)cudaErrorInvalidValue;
  const Operands op{U, UT, cse, isgp, n_pad, window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(W)                                                             \
  launch_smk<W>(op, wqt, un, x, acc, ct, prop, ctn, la, B, n_steps, step, \
                chain_offset, st)
  KLEIN_BY_WINDOW(window, CALL)
#undef CALL
}

const char* smk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
