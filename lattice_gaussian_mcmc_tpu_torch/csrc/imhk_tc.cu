// Fused IMHK steps (B2) and the IMHK trajectory (B3) on Hopper (sm_90a),
// with the Klein coupling on the tensor cores and the proposal kept in
// shared memory.
//
// Replaces the fused Metropolis-Hastings mode of the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/klein_pallas.py `_kernel`
// (imhk_step_pallas_fused / imhk_steps_batch_pallas, B2) and its trajectory
// mode (imhk_trajectory_pallas, B3). B2 and B3 are one code path (null ring
// pointers for B2), so the ring cannot change the chain.
//
// What it computes, per chain and step, for rows i = n_pad-1 down to 0:
//   c_i   = cs_i - sum_{j>i} U_ij y_j
//   y_i   = the windowed inverse-CDF draw of klein_common.cuh `draw_row`
//           around c_i (rintf, hazard C3), log Z_i its log-normaliser
// lw' = sum_i log Z_i in double (hazard C4); accept iff
// log max(u, 1e-30) < lw' - lw; x, lw and acc in place. B3 writes lw and,
// when asked, the state after every thin-th step to its rings.
//
// Bound. Per proposal and chain the coupling is n(n-1) FLOP (1.05e6 at
// n = 1024) and the draw n W exps (16,384 at W = 16). Over the flagship's
// launch (524,288 chains x 64 steps) that is 3.5e13 FLOP, ~107 ms at the
// bf16 tensor-core rate with the three passes below, and 5.5e11 exps,
// ~131 ms at the SFU rate; device memory moves only the accepted
// proposals into x (4 KB per chain and step, ~0.6 ms per step).
//
// Design.
// - A thread block owns NC = 32 chains for all n_steps steps. Their
//   proposal lives in shared memory as bf16, (n_pad, 32) chain-minor with
//   the 16-byte chunks of a row XOR-swizzled by (row / 2) mod 4, so that
//   ldmatrix reads eight rows without bank conflicts: 64 bytes per row,
//   64 KB at n_pad = 1024. Rows already drawn are never read back from
//   device memory.
// - Hazard C2: U = U1 + U2 + U3, three bf16 parts split on the host (exact
//   for a float32 U), packed in mma.sync m16n8k16 A-fragment order (one
//   16-byte load per lane, part and 16 x 16 tile), three passes over Y. Y
//   holds integers, exact in bf16 for |y| <= 256 (hazard C8: a drawn
//   |y| > 256 is counted into bad[0] and the wrapper raises; bad[1] keeps
//   the largest |y| drawn). Fault C11: where the wrapper predicts draws
//   beyond 256 (klein_cuda.py `wide_y`), the WIDE instantiation writes
//   each proposal to yprop (n_pad, B) in float32 as well, flags the
//   16-row tiles holding some |y| > 256, and multiplies their second and
//   third bf16 parts too (imhk_tc_common.cuh `WideY`, B7's device code);
//   an accepted proposal is copied from yprop. It counts nothing.
// - For a 64-row block [lo, lo+64), its coupling to the rows j >= lo+64 is
//   C = U[lo:lo+64, lo+64:] Y, a 64 x 32 x K product on mma.sync with FP32
//   accumulation: each warp takes 32 rows, U's fragments stream from L2
//   through a ring of four 16-column steps in registers (6 MB of parts at
//   n = 1024, 2.9 MB read per block of chains and proposal), and each pair
//   of steps sums into a zeroed partial accumulator that is then added in
//   IEEE FP32, so the tensor cores' own rounding acts on short sums only.
// - The block's rows go in four sub-blocks of 16. Once a sub-block is
//   drawn, its coupling to the rows below it in the block is one more
//   small product on the tensor cores (16 sb x 32 x 16, three passes);
//   within a sub-block, after y_r the pair adds U[rr, r] y_r (FP32, float4
//   quads split by parity) into the coupling of its rows rr < r in a
//   (32, 72)-float tile, so the next row's centre is one shared load away.
// - Each row is drawn by two threads per chain: each computes half of the
//   window's weights; the CDF is the same sequential sum as draw_row's (the
//   low half's sum is shuffled up), so the draw is draw_row's bit for bit.
//   Each thread draws the Philox uniform of one row of a pair, one pair
//   ahead of the draws.
// - 64 threads and 64 n_pad + 9,344 bytes of shared memory a block (74,880
//   at n_pad = 1024): three blocks (six warps, 96 chains) per SM there, one
//   (32 chains) at n_pad = 2048; the proposal tiles bound it. The 227 KB a
//   block of sm_90 may take set the largest n_pad, 3,456 (klein_cuda.py
//   IMHK_TC_MAX_N_PAD; its wrapper raises above it).
//   ~255 registers a thread (ptxas spills a few bytes at the coupling's
//   register ring). The draws are latency-bound (~0.8 of a launch), the
//   coupling L2-bound (~0.25); see PERF.md.
//
// The sweep's device code, shared with fused SMK (smk_tc.cu, B4), is in
// imhk_tc_common.cuh.
//
// Randomness: host uniforms (n_pad + 8 rows a step, the accept uniform in
// row n_pad) or Philox4x32-10 with counter (chain id, row, step, tag), the
// function of lattice_gaussian_mcmc_tpu_torch/utils/prng.py, bit for bit.

#include "imhk_tc_common.cuh"

using namespace lgk;

namespace {

constexpr int PASSES = PARTS;       // bf16 passes of the coupling (all)

// DBG: step 0 also writes each row's centre to dbg[i, chain] and its draw
// to dbg[n_pad + i, chain]. WIDE: y's wide parts through yprop (fault
// C11).
template <int W, bool DBG, bool WIDE = false>
__global__ void __launch_bounds__(TPB, 3)
    imhk_tc_kernel(TcOperands op, Uniforms un, float* __restrict__ x,
                   float* __restrict__ lw_state, float* __restrict__ acc,
                   float* __restrict__ tlw, float* __restrict__ tx,
                   float* __restrict__ dbg, float* yprop,
                   int* __restrict__ bad, int thin, long long B, int n_steps,
                   uint32_t step0, uint32_t chain_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pad = op.n_pad;
  unsigned char* ytile = smem;
  float* ct = reinterpret_cast<float*>(smem + (size_t)n_pad * Y_ROW);
  int* accepted = reinterpret_cast<int*>(ct + NC * CT_STRIDE);
  const uint32_t ysm = (uint32_t)__cvta_generic_to_shared(ytile);
  // WIDE: a byte a 16-row tile, set where the tile holds some |y| > 256
  unsigned char* big = smem + tc_smem_bytes(n_pad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid >> 1, h = tid & 1;   // chain of the block, half
  const long long chain0 = (long long)blockIdx.x * NC;
  const long long chain = chain0 + cl;
  const bool valid = chain < B;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  float* crow = ct + cl * CT_STRIDE;
  const WideY wide{big, yprop, B, chain0};

  float lw = valid ? lw_state[chain] : 0.0f;
  float a_cnt = valid ? acc[chain] : 0.0f;
  float ymax = 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    const uint32_t step = step0 + (uint32_t)s;
    const long long row0 = (long long)s * (n_pad + ACCEPT_ROWS);
    double lwp = 0.0;
    // a flag cleared here is set again only after the first barrier below
    if constexpr (WIDE)
      for (int k = tid; k < n_pad / SB; k += TPB) big[k] = 0;
    for (int lo = n_pad - RB; lo >= 0; lo -= RB) {
      __syncthreads();   // rows >= lo + 64 drawn; the tile is free
      {
        // the block's coupling to the rows drawn (rows >= lo + 64): warp w
        // takes its rows lo + 32w .. +31
        float cacc[2][4][4];
        if constexpr (WIDE)
          couple<PASSES, false>(op, ysm, cacc, lo, warp, lane, wide);
        else
          couple<PASSES>(op, ysm, cacc, lo, warp, lane);
        store_ct(cacc, ct, warp, lane);
      }
      __syncthreads();
      for (int sb = RB / SB - 1; sb >= 0; --sb) {
        const int rlo = SB * sb;
        uint4 ad[RB / SB - 1][PARTS];
        load_diag(ad, op.Ufrag, lo, sb, n_pad >> 4, lane);
        // uniforms of rows r2 (thread 0) and r2 - 1 (thread 1), one pair
        // ahead of the draws
        int ih = lo + rlo + SB - 1 - h;
        float uh = valid ? un.get(row0 + ih, chain, chain_id, (uint32_t)ih,
                                  step, TAG_ROW)
                         : 0.5f;
        for (int r2 = rlo + SB - 1; r2 > rlo; r2 -= 2) {
          const float upair[2] = {__shfl_sync(FULL, uh, lane & ~1),
                                  __shfl_sync(FULL, uh, lane | 1)};
          if (r2 - 2 > rlo) {
            ih -= 2;
            uh = valid ? un.get(row0 + ih, chain, chain_id, (uint32_t)ih,
                                step, TAG_ROW)
                       : 0.5f;
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
              if (4 * q < r) uq[j] = __ldg(ucol + q);
            }
            const float c = __fsub_rn(__ldg(op.cs + i), crow[r]);
            float logz;
            const float y = draw_pair<W>(c, __ldg(op.isg + i), upair[e],
                                         op.window, h, lane, logz);
            lwp += (double)logz;
            if (h == 0) {
              *reinterpret_cast<unsigned short*>(ytile + y_off(i, cl)) =
                  WIDE ? to_bf16_rn_bits(y) : to_bf16_bits(y);
              if (valid) {
                ymax = fmaxf(ymax, fabsf(y));
                if constexpr (WIDE) {
                  yprop[(size_t)i * (size_t)B + (size_t)chain] = y;
                  if (fabsf(y) > EXACT_Y) big[i / SB] = 1;
                } else {
                  if (fabsf(y) > EXACT_Y) atomicAdd(bad, 1);
                }
              }
              if constexpr (DBG) {
                if (s == 0 && valid) {
                  dbg[(size_t)i * (size_t)B + (size_t)chain] = c;
                  dbg[(size_t)(n_pad + i) * (size_t)B + (size_t)chain] = y;
                }
              }
            }
            // the sub-block's rows rr < r: coupling += U[rr, r] y_r
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int q = (rlo >> 2) + h + 2 * j;
              if (4 * q < r) {
                float4 cq = *reinterpret_cast<float4*>(crow + 4 * q);
                cq.x = fmaf(uq[j].x, y, cq.x);
                cq.y = fmaf(uq[j].y, y, cq.y);
                cq.z = fmaf(uq[j].z, y, cq.z);
                cq.w = fmaf(uq[j].w, y, cq.w);
                *reinterpret_cast<float4*>(crow + 4 * q) = cq;
              }
            }
            __syncwarp();
          }
        }
        if (sb > 0) {
          __syncthreads();   // the sub-block's rows and centres written
          if constexpr (WIDE)
            sub_update<PASSES>(ad, ysm, ct, lo, sb, warp, lane, wide);
          else
            sub_update<PASSES>(ad, ysm, ct, lo, sb, warp, lane);
          __syncthreads();
        }
      }
    }
    // accept or keep, per chain
    const float lwpf = (float)lwp;
    float u = valid ? un.get(row0 + n_pad, chain, chain_id, 0u, step,
                             TAG_ACCEPT)
                    : 1.0f;
    u = fmaxf(u, 1e-30f);
    const bool take = logf(u) < __fsub_rn(lwpf, lw);
    if (take) {
      lw = lwpf;
      a_cnt = __fadd_rn(a_cnt, 1.0f);
    }
    if (h == 0) accepted[cl] = take ? 1 : 0;
    const bool keep = tlw != nullptr && (s + 1) % thin == 0;
    const size_t k = keep ? (size_t)((s + 1) / thin - 1) : 0;
    if (keep && h == 0 && valid) tlw[k * (size_t)B + (size_t)chain] = lw;
    __syncthreads();
    // accepted proposals into x (and the state into the coefficient ring):
    // a warp writes whole rows of the block's 32 chains
    {
      const int cc = tid & (NC - 1);
      const long long ch = chain0 + cc;
      if (ch < B) {
        const bool took = accepted[cc] != 0;
        for (int i = tid / NC; i < n_pad; i += TPB / NC) {
          const size_t at = (size_t)i * (size_t)B + (size_t)ch;
          float v = 0.0f;
          if (took) {
            v = WIDE ? yprop[at]
                     : from_bf16_bits(*reinterpret_cast<const unsigned short*>(
                           ytile + y_off(i, cc)));
            x[at] = v;
          }
          if (keep && tx != nullptr) {
            if (!took) v = x[at];
            tx[(k * n_pad + i) * (size_t)B + (size_t)ch] = v;
          }
        }
      }
    }
  }
  if (h == 0 && valid) {
    lw_state[chain] = lw;
    acc[chain] = a_cnt;
    atomicMax(bad + 1, (int)ymax);
  }
}

// WIDE's flags follow the draw's shared memory, a byte a 16-row tile
__host__ __device__ inline size_t imhk_smem_bytes(int n_pad, bool wide) {
  return tc_smem_bytes(n_pad) + (wide ? (size_t)(n_pad / SB) : 0);
}

template <int W, bool DBG, bool WIDE>
int launch(const TcOperands& op, const Uniforms& un, float* x, float* lw,
           float* acc, float* tlw, float* tx, float* dbg, float* yprop,
           int* bad, int thin, long long B, int n_steps, uint32_t step,
           uint32_t chain_offset, cudaStream_t stream) {
  const size_t smem = imhk_smem_bytes(op.n_pad, WIDE);
  cudaError_t e = cudaFuncSetAttribute(
      imhk_tc_kernel<W, DBG, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + NC - 1) / NC));
  imhk_tc_kernel<W, DBG, WIDE><<<grid, TPB, smem, stream>>>(
      op, un, x, lw, acc, tlw, tx, dbg, yprop, bad, thin, B, n_steps, step,
      chain_offset);
  return (int)cudaGetLastError();
}

template <bool DBG, bool WIDE = false>
int launch_by_window(const TcOperands& op, const Uniforms& un, float* x,
                     float* lw, float* acc, float* tlw, float* tx,
                     float* dbg, float* yprop, int* bad, int thin,
                     long long B, int n_steps, uint32_t step,
                     uint32_t chain_offset, cudaStream_t st) {
#define CALL(W)                                                         \
  launch<W, DBG, WIDE>(op, un, x, lw, acc, tlw, tx, dbg, yprop, bad,    \
                       thin, B, n_steps, step, chain_offset, st)
  switch (op.window) {
    case 8: return CALL(8);
    case 16: return CALL(16);
    case 24: return CALL(24);
    default: return CALL(0);
  }
#undef CALL
}

template <int W, bool WIDE>
int info(int n_pad, int* out) {
  cudaFuncAttributes fa;
  const auto kernel = imhk_tc_kernel<W, false, WIDE>;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = imhk_smem_bytes(n_pad, WIDE);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, TPB,
                                                    smem);
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

// B2 (tlw null) and B3: n_steps fused IMHK steps; x (n_pad, B), lw (B,),
// acc (B,) in place. Ufrag: the three bf16 parts of U in A-fragment order
// ((n_pad/16)^2 * 3 * 32 16-byte entries), UT float32. unif:
// (n_steps * (n_pad + 8), B) or null. B3 writes lw every thin-th step to
// tlw (n_steps / thin, B) and, when tx is not null, the state to tx
// (n_steps / thin * n_pad, B). bad: two ints, bad[0] incremented per drawn
// |y| > 256, bad[1] raised to the largest drawn |y|. dbg: null, or
// (2 n_pad, B) for step 0's centres and draws. yprop: null, or (n_pad, B)
// float32 for the WIDE instantiation (fault C11: y's wide parts, nothing
// counted into bad[0]); not with dbg.
int imhk_tc_launch(const void* Ufrag, const float* UT, const float* cs,
                   const float* isg, const float* unif, float* x, float* lw,
                   float* acc, float* tlw, float* tx, float* dbg,
                   float* yprop, int* bad, int thin, int n_pad, long long B,
                   int window, int n_steps, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t step, uint32_t chain_offset,
                   void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_steps <= 0 || thin <= 0 || bad == nullptr ||
      (tx != nullptr && tlw == nullptr) ||
      (yprop != nullptr && dbg != nullptr))
    return (int)cudaErrorInvalidValue;
  const TcOperands op{static_cast<const uint4*>(Ufrag), UT, cs, isg, n_pad,
                      window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbg != nullptr)
    return launch_by_window<true>(op, un, x, lw, acc, tlw, tx, dbg, yprop,
                                  bad, thin, B, n_steps, step, chain_offset,
                                  st);
  if (yprop != nullptr)
    return launch_by_window<false, true>(op, un, x, lw, acc, tlw, tx, dbg,
                                         yprop, bad, thin, B, n_steps, step,
                                         chain_offset, st);
  return launch_by_window<false>(op, un, x, lw, acc, tlw, tx, dbg, yprop,
                                 bad, thin, B, n_steps, step, chain_offset,
                                 st);
}

// The kernel's resources (WIDE's when wide is not 0) for a window at
// n_pad: out[0] registers a thread, out[1] local (spill) bytes a thread,
// out[2] dynamic shared memory a block, out[3] blocks per SM, out[4]
// threads a block.
int imhk_tc_info(int n_pad, int window, int wide, int* out) {
  if (wide) {
    switch (window) {
      case 8: return info<8, true>(n_pad, out);
      case 16: return info<16, true>(n_pad, out);
      case 24: return info<24, true>(n_pad, out);
      default: return info<0, true>(n_pad, out);
    }
  }
  switch (window) {
    case 8: return info<8, false>(n_pad, out);
    case 16: return info<16, false>(n_pad, out);
    case 24: return info<24, false>(n_pad, out);
    default: return info<0, false>(n_pad, out);
  }
}

const char* imhk_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
