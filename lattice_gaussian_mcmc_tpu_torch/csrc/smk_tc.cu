// Fused symmetric Metropolis-Klein (SMK) steps (B4) on Hopper (sm_90a), on
// B2's tensor-core sweep (imhk_tc_common.cuh) with the reverse pass folded
// into it.
//
// Replaces the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/smk_pallas.py `_smk_kernel`
// (_smk_steps_jit / smk_steps_batch_pallas, B4). The law is the same; the
// TPU layout devices (CDF as a matrix product, 8-row groups with Kahan
// sums, the state in scratch to dodge an aliased-window DMA race) are not
// carried over.
//
// What it computes, per chain, in the recentered frame y = x - k of the
// target precomputation (U unit upper triangular, k = round(cs)):
//   once per launch   ct = U y                      (current centres)
//   per step, rows i = n_pad-1 down to 0:
//     coupling_i = sum_{j>i} U_ij y'_j
//     y'_i ~ the windowed draw around c_i = ct_i - coupling_i with the
//            proposal widths (klein_common.cuh `draw_row`, rintf, C3);
//            lw_fwd += log Z_i(c_i)
//     ctn_i = y'_i + coupling_i = (U y')_i           (the proposal's centres)
//     c'_i  = (ctn_i - ct_i) + y_i; lw_rev += log Z_i(c'_i)
//     qn += (wqt_i (ctn_i - cse_i))^2, qc += (wqt_i (ct_i - cse_i))^2
//   log alpha = (qc - qn) + (lw_fwd - lw_rev), the four sums in double
//   (hazard C4); accept iff log max(u, 1e-30) < log alpha: y <- y',
//   ct <- ctn.
// wqt_i = R_ii / (sqrt(2) sigma_target) and cse is the recentered target
// centre. The proposal's quadratic terms cancel exactly (y'_i - c_i =
// ctn_i - ct_i = -(y_i - c'_i)), so the proposal ratio is the difference of
// the two log-normaliser sums.
//
// Bound. Per chain and step the coupling is n(n-1) FLOP (three bf16 passes
// on the tensor cores: 13.3 ms at 131,072 chains x 32 steps and n = 1024
// at 989 TFLOP/s) and the two windows 2 n W exps (16.4 ms at W = 8 at 16
// exps a clock per SM): the exps bound the design. Device memory per step
// and chain: ct_i and y_i read and ctn_i written per row (12 KB), the
// accepted proposal written into x (4 KB).
//
// Design. B2's block (imhk_tc.cu): 32 chains and 64 threads a block for
// all steps, two threads per chain; the proposal y' in shared memory as a
// swizzled bf16 tile; each 64-row block's coupling to the rows drawn on
// mma.sync over the three exact bf16 parts of U (C2), the block's own rows
// in 16-row sub-blocks. The centre of row i is the chain's own ct_i from
// device memory; each thread fetches ct_i and y_i of one row of the next
// pair with its uniform, one pair ahead of the draws (no shared staging,
// so three blocks still fit an SM at n_pad 1024). As soon as y'_i is drawn,
// ctn_i and c'_i are known, and both quadratic terms are summed; c'_i
// takes row i's slot of the coupling tile, which the draw no longer needs.
// Once a 16-row sub-block is drawn, each thread of the pair sums the
// reverse log-normalisers of its 8 rows (one parity) there: independent
// windows, off the serial chain of draws, and no second pass over the
// rows. ctn_i goes to a chain-minor device buffer as it is drawn. Two ct
// buffers and a selector per chain take the place of the copy ct <- ctn:
// on accept the selector flips, and the block writes x <- y' from the
// tile. The block owns its chains for all steps, so the in-place updates
// cannot race (C5).
// ct = U y at the launch start runs on the tensor cores over the state in
// the tile (its integers exact in bf16, hazard C8), the diagonal block
// included. Hazard C8: a state or drawn |y| > 256 is counted into bad[0],
// and bad[1] keeps the largest |y|.
//
// Randomness: host uniforms (n_pad + 8 rows a step, the accept uniform in
// row n_pad) or Philox4x32-10 with counter (chain id, row, step, tag), the
// function of lattice_gaussian_mcmc_tpu_torch/utils/prng.py, bit for bit.

#include "imhk_tc_common.cuh"

using namespace lgk;

namespace {

constexpr int PASSES = PARTS;       // bf16 passes of the coupling (all)

// DBG: step 0 also writes each row's forward centre to dbg[i, chain], its
// reverse centre to dbg[n_pad + i, chain] and its draw to
// dbg[2 n_pad + i, chain].
template <int W, bool DBG>
__global__ void __launch_bounds__(TPB, 3)
    smk_tc_kernel(TcOperands op, const float* __restrict__ wqt, Uniforms un,
                  float* __restrict__ x, float* __restrict__ acc,
                  float* ct0, float* ct1,
                  float* __restrict__ la_out, float* __restrict__ dbg,
                  int* __restrict__ bad, long long B, int n_steps,
                  uint32_t step0, uint32_t chain_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pad = op.n_pad;
  unsigned char* ytile = smem;
  float* cpl = reinterpret_cast<float*>(smem + (size_t)n_pad * Y_ROW);
  int* accepted = reinterpret_cast<int*>(cpl + NC * CT_STRIDE);
  const uint32_t ysm = (uint32_t)__cvta_generic_to_shared(ytile);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid >> 1, h = tid & 1;   // chain of the block, half
  const long long chain0 = (long long)blockIdx.x * NC;
  const long long chain = chain0 + cl;
  const bool valid = chain < B;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  float* crow = cpl + cl * CT_STRIDE;
  float ymax = 0.0f;

  // the state into the tile (a warp writes whole rows of the block's 32
  // chains), then ct = U y block by block into ct0
  {
    const int cc = tid & (NC - 1);
    const long long ch = chain0 + cc;
    for (int i = tid / NC; i < n_pad; i += TPB / NC) {
      const float v = ch < B ? x[(size_t)i * (size_t)B + (size_t)ch] : 0.0f;
      *reinterpret_cast<unsigned short*>(ytile + y_off(i, cc)) =
          to_bf16_bits(v);
      ymax = fmaxf(ymax, fabsf(v));
      if (fabsf(v) > EXACT_Y) atomicAdd(bad, 1);
    }
  }
  for (int lo = 0; lo < n_pad; lo += RB) {
    __syncthreads();   // the tile written; the coupling tile free
    {
      float cacc[2][4][4];
      couple<PASSES, true>(op, ysm, cacc, lo, warp, lane);
      store_ct(cacc, cpl, warp, lane);
    }
    __syncthreads();
    for (int e = tid; e < RB * NC; e += TPB) {
      const int r = e / NC, cc = e % NC;
      const long long ch = chain0 + cc;
      if (ch < B)
        ct0[(size_t)(lo + r) * (size_t)B + (size_t)ch] =
            cpl[cc * CT_STRIDE + r];
    }
  }

  float a_cnt = valid ? acc[chain] : 0.0f;
  float la = 0.0f;
  int sel = 0;   // the current centres: ct0 or ct1
  for (int s = 0; s < n_steps; ++s) {
    const uint32_t step = step0 + (uint32_t)s;
    const long long row0 = (long long)s * (n_pad + ACCEPT_ROWS);
    // no __restrict__: written and read within the launch, never through
    // the read-only cache
    const float* ctc = sel ? ct1 : ct0;
    float* ctn = sel ? ct0 : ct1;
    double lwf = 0.0, lwr = 0.0, qn = 0.0, qc = 0.0;
    for (int lo = n_pad - RB; lo >= 0; lo -= RB) {
      __syncthreads();   // rows >= lo + 64 drawn; the tile is free
      {
        // the block's coupling to the rows drawn (rows >= lo + 64): warp w
        // takes its rows lo + 32w .. +31
        float cacc[2][4][4];
        couple<PASSES>(op, ysm, cacc, lo, warp, lane);
        store_ct(cacc, cpl, warp, lane);
      }
      __syncthreads();
      for (int sb = RB / SB - 1; sb >= 0; --sb) {
        const int rlo = SB * sb;
        uint4 ad[RB / SB - 1][PARTS];
        load_diag(ad, op.Ufrag, lo, sb, n_pad >> 4, lane);
        // uniform, current centre and state of rows r2 (thread 0) and
        // r2 - 1 (thread 1), one pair ahead of the draws
        int ih = lo + rlo + SB - 1 - h;
        size_t at = (size_t)ih * (size_t)B + (size_t)chain;
        float uh = valid ? un.get(row0 + ih, chain, chain_id, (uint32_t)ih,
                                  step, TAG_ROW)
                         : 0.5f;
        float cth = valid ? ctc[at] : 0.0f;
        float yh = valid ? x[at] : 0.0f;
        for (int r2 = rlo + SB - 1; r2 > rlo; r2 -= 2) {
          const float upair[2] = {__shfl_sync(FULL, uh, lane & ~1),
                                  __shfl_sync(FULL, uh, lane | 1)};
          const float ctpair[2] = {__shfl_sync(FULL, cth, lane & ~1),
                                   __shfl_sync(FULL, cth, lane | 1)};
          const float ypair[2] = {__shfl_sync(FULL, yh, lane & ~1),
                                  __shfl_sync(FULL, yh, lane | 1)};
          if (r2 - 2 > rlo) {
            ih -= 2;
            at = (size_t)ih * (size_t)B + (size_t)chain;
            uh = valid ? un.get(row0 + ih, chain, chain_id, (uint32_t)ih,
                                step, TAG_ROW)
                       : 0.5f;
            cth = valid ? ctc[at] : 0.0f;
            yh = valid ? x[at] : 0.0f;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r2 - e;
            const int i = lo + r;
            // U[rr, i] for the sub-block's rows rr < r, by quads split by
            // parity between the two threads, loaded before the draw
            const float4* ucol = reinterpret_cast<const float4*>(
                op.UT + (size_t)i * n_pad + lo);
            float4 uq[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int q = (rlo >> 2) + h + 2 * j;
              if (4 * q <= r) uq[j] = __ldg(ucol + q);
            }
            const float coup = crow[r];
            const float cti = ctpair[e];
            const float c = __fsub_rn(cti, coup);
            const float isg = __ldg(op.isg + i);
            float logz;
            const float y = draw_pair<W>(c, isg, upair[e], op.window, h,
                                         lane, logz);
            lwf += (double)logz;
            // the reverse move and the target, off the chain of draws
            const float ctni = __fadd_rn(y, coup);
            const float cp = __fadd_rn(__fsub_rn(ctni, cti), ypair[e]);
            const float wq = __ldg(wqt + i), ce = __ldg(op.cs + i);
            const float tn = __fmul_rn(wq, __fsub_rn(ctni, ce));
            const float tc = __fmul_rn(wq, __fsub_rn(cti, ce));
            qn += (double)__fmul_rn(tn, tn);
            qc += (double)__fmul_rn(tc, tc);
            if (h == 0) {
              *reinterpret_cast<unsigned short*>(ytile + y_off(i, cl)) =
                  to_bf16_bits(y);
              if (valid) {
                const size_t ai = (size_t)i * (size_t)B + (size_t)chain;
                ctn[ai] = ctni;
                ymax = fmaxf(ymax, fabsf(y));
                if (fabsf(y) > EXACT_Y) atomicAdd(bad, 1);
                if constexpr (DBG) {
                  if (s == 0) {
                    const size_t np = (size_t)n_pad * (size_t)B;
                    dbg[ai] = c;
                    dbg[np + ai] = cp;
                    dbg[2 * np + ai] = y;
                  }
                }
              }
            }
            // the sub-block's rows rr < r: coupling += U[rr, r] y_r (U is
            // zero below its diagonal, so rows rr > r of the quads add 0);
            // row r's slot, drawn, then keeps its reverse centre c'_r,
            // written by the thread that owns its quad
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int q = (rlo >> 2) + h + 2 * j;
              if (4 * q <= r) {
                float4 cq = *reinterpret_cast<float4*>(crow + 4 * q);
                cq.x = fmaf(uq[j].x, y, cq.x);
                cq.y = fmaf(uq[j].y, y, cq.y);
                cq.z = fmaf(uq[j].z, y, cq.z);
                cq.w = fmaf(uq[j].w, y, cq.w);
                *reinterpret_cast<float4*>(crow + 4 * q) = cq;
                if (r - 4 * q < 4) crow[r] = cp;
              }
            }
            __syncwarp();
          }
        }
        {
          // the sub-block's reverse log-normalisers, rows of parity h,
          // independent of one another and of the draws
          double part = 0.0;
#pragma unroll 4
          for (int k = 0; k < SB / 2; ++k) {
            const int r = rlo + 2 * k + h;
            part += (double)log_normalizer<W>(crow[r], __ldg(op.isg + lo + r),
                                              op.window);
          }
          lwr += part;
        }
        if (sb > 0) {
          __syncthreads();   // the sub-block's rows and centres written
          sub_update<PASSES>(ad, ysm, cpl, lo, sb, warp, lane);
          __syncthreads();
        }
      }
    }
    // accept or keep, per chain (both threads hold the same sums)
    lwr += __shfl_xor_sync(FULL, lwr, 1);   // the two parities' sums
    la = (float)((qc - qn) + (lwf - lwr));
    float u = valid ? un.get(row0 + n_pad, chain, chain_id, 0u, step,
                             TAG_ACCEPT)
                    : 1.0f;
    u = fmaxf(u, 1e-30f);
    const bool take = logf(u) < la;
    if (take) {
      a_cnt = __fadd_rn(a_cnt, 1.0f);
      sel ^= 1;
    }
    if (h == 0) accepted[cl] = take ? 1 : 0;
    __syncthreads();
    // accepted proposals into x: a warp writes whole rows of the block's
    // 32 chains
    {
      const int cc = tid & (NC - 1);
      const long long ch = chain0 + cc;
      if (ch < B && accepted[cc] != 0)
        for (int i = tid / NC; i < n_pad; i += TPB / NC)
          x[(size_t)i * (size_t)B + (size_t)ch] = from_bf16_bits(
              *reinterpret_cast<const unsigned short*>(ytile + y_off(i, cc)));
    }
  }
  if (h == 0 && valid) {
    acc[chain] = a_cnt;
    if (la_out != nullptr) la_out[chain] = la;
  }
  atomicMax(bad + 1, (int)ymax);
}

template <int W, bool DBG>
int launch(const TcOperands& op, const float* wqt, const Uniforms& un,
           float* x, float* acc, float* ct0, float* ct1, float* la,
           float* dbg, int* bad, long long B, int n_steps, uint32_t step,
           uint32_t chain_offset, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(op.n_pad);
  cudaError_t e = cudaFuncSetAttribute(
      smk_tc_kernel<W, DBG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + NC - 1) / NC));
  smk_tc_kernel<W, DBG><<<grid, TPB, smem, stream>>>(
      op, wqt, un, x, acc, ct0, ct1, la, dbg, bad, B, n_steps, step,
      chain_offset);
  return (int)cudaGetLastError();
}

template <bool DBG>
int launch_by_window(const TcOperands& op, const float* wqt,
                     const Uniforms& un, float* x, float* acc, float* ct0,
                     float* ct1, float* la, float* dbg, int* bad,
                     long long B, int n_steps, uint32_t step,
                     uint32_t chain_offset, cudaStream_t st) {
#define CALL(W)                                                          \
  launch<W, DBG>(op, wqt, un, x, acc, ct0, ct1, la, dbg, bad, B, n_steps, \
                 step, chain_offset, st)
  switch (op.window) {
    case 8: return CALL(8);
    case 16: return CALL(16);
    case 24: return CALL(24);
    default: return CALL(0);
  }
#undef CALL
}

template <int W>
int info(int n_pad, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, smk_tc_kernel<W, false>);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tc_smem_bytes(n_pad);
  e = cudaFuncSetAttribute(smk_tc_kernel<W, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, smk_tc_kernel<W, false>, TPB, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = TPB;
  return 0;
}

}  // namespace

extern "C" {

// B4: n_steps fused SMK steps. x (n_pad, B) recentered state and acc (B,)
// in place; ct0, ct1 (n_pad, B) scratch; la (B,) receives the last step's
// log alpha, or null. Ufrag: the three bf16 parts of U in A-fragment order,
// UT float32; cse, isgp, wqt: (n_pad,) target centre, inverse proposal
// widths, R_ii / (sqrt 2 sigma_target). unif: (n_steps * (n_pad + 8), B)
// or null for Philox. bad: two ints, bad[0] incremented per state or drawn
// |y| > 256, bad[1] raised to the largest |y|. dbg: null, or (3 n_pad, B)
// for step 0's centres, reverse centres and draws.
int smk_tc_launch(const void* Ufrag, const float* UT, const float* cse,
                  const float* isgp, const float* wqt, const float* unif,
                  float* x, float* acc, float* ct0, float* ct1, float* la,
                  float* dbg, int* bad, int n_pad, long long B, int window,
                  int n_steps, uint32_t seed_lo, uint32_t seed_hi,
                  uint32_t step, uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_steps <= 0 || bad == nullptr)
    return (int)cudaErrorInvalidValue;
  const TcOperands op{static_cast<const uint4*>(Ufrag), UT, cse, isgp,
                      n_pad, window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbg != nullptr)
    return launch_by_window<true>(op, wqt, un, x, acc, ct0, ct1, la, dbg,
                                  bad, B, n_steps, step, chain_offset, st);
  return launch_by_window<false>(op, wqt, un, x, acc, ct0, ct1, la, dbg,
                                 bad, B, n_steps, step, chain_offset, st);
}

// The kernel's resources for a window at n_pad: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] dynamic shared memory a
// block, out[3] blocks per SM, out[4] threads a block.
int smk_tc_info(int n_pad, int window, int* out) {
  switch (window) {
    case 8: return info<8>(n_pad, out);
    case 16: return info<16>(n_pad, out);
    case 24: return info<24>(n_pad, out);
    default: return info<0>(n_pad, out);
  }
}

const char* smk_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
