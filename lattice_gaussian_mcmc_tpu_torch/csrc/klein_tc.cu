// Klein draw (B1) and its ring (B6) on Hopper (sm_90a), on the tensor-core
// sweep of the fused IMHK kernel (imhk_tc.cu, B2): the coupling on the
// tensor cores, the proposal kept in shared memory.
//
// Replaces the draw mode (klein_sample_batch_pallas, B1) and the ring mode
// (klein_sample_ring_pallas, B6) of the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/klein_pallas.py `_kernel`. The law
// is the same; the TPU layout devices (CDF as a triangular matrix product,
// (8, 128) row groups, the 8-row DMA staging of the rings) are not carried
// over. Above n_pad 3,456 the proposal tile no longer fits a block's
// shared memory, and the wrappers take the FP32 sweep of klein.cu instead
// (klein_cuda.py `klein_route`, chosen by n_pad before the launch).
//
// What it computes, per chain and round, for rows i = n_pad-1 down to 0:
//   c_i   = cs_i - sum_{j>i} U_ij y_j
//   y_i   = the windowed inverse-CDF draw of klein_common.cuh `draw_row`
//           around c_i (rintf, hazard C3), log Z_i its log-normaliser
// and lw = sum_i log Z_i in double (hazard C4). Round r uses Philox step
// `step + r` (counter (chain id, row, step + r, TAG_ROW)) or host uniform
// rows r n_pad ..; it writes its draw to rows r n_pad .. of the ring
// (n_rounds n_pad, B) and its lw to row r of the lw ring (n_rounds, B). B1
// is the one-round case, with its own compile-time instantiation: with a
// runtime round count the FP32 draw at the flagship shapes took 101-103 ms
// instead of 85 (tools/ab_klein.py, NVIDIA H100 80GB HBM3, 700 W). A round
// is B2's proposal at the same step, bit for bit: the same counters, sweep
// and arithmetic.
//
// Bound (n = 1024): per draw and chain the coupling is n(n-1) FLOP and the
// draw n W exps; the ring is 4 n_pad bytes a chain and round written once.
// At the flagship's B1 (524,288 chains, W 16) that is 5.5e11 FLOP, ~1.7 ms
// at the bf16 tensor-core rate with the three passes below, 8.6e9 exps,
// ~2.1 ms at the SFU rate, and 2.1 GB written, 0.64 ms at 3.35 TB/s.
//
// Design: B2's block without the accept (imhk_tc_common.cuh).
// - A block of 64 threads owns NC = 32 chains for all its rounds. Their
//   draw lives in shared memory as bf16, (n_pad, 32) chain-minor and
//   XOR-swizzled (64 KB at n_pad 1024); rows already drawn are never read
//   back from device memory. Each drawn row also goes to the ring as
//   float32 (a row of the block's 32 chains is 128 contiguous bytes).
// - Hazard C2: U = U1 + U2 + U3, three bf16 parts (exact for a float32 U)
//   in mma.sync A-fragment order. `couple` forms a 64-row block's coupling
//   to the rows drawn on the tensor cores, `sub_update` a 16-row
//   sub-block's coupling to the rows below it in the block; within a
//   sub-block the pair adds U[rr, r] y_r in FP32. Hazard C8: y is exact in
//   bf16 for |y| <= 256; a drawn |y| > 256 is counted into bad[0] and the
//   wrapper (or the entry point that passed its guard) raises; bad[1]
//   keeps the largest |y| drawn.
// - Two threads draw each row (`draw_pair`, draw_row's arithmetic bit for
//   bit), with the uniforms fetched a row pair ahead.
// - B6's rounds run inside the block, which reuses its tiles; lw is summed
//   in double and written once a round.
// - Windows 8, 16 and 24 are compiled with the CDF in registers; any other
//   window takes draw_row's runtime-window branch.
// - 64 threads and 64 n_pad + 9,344 bytes of shared memory a block (74,880
//   at n_pad 1024): three blocks (96 chains) per SM there.
//
// Randomness: host uniforms or Philox4x32-10, the function of
// lattice_gaussian_mcmc_tpu_torch/utils/prng.py, bit for bit.

#include "imhk_tc_common.cuh"

using namespace lgk;

namespace {

constexpr int PASSES = PARTS;       // bf16 passes of the coupling (all)

// RING: n_rounds rounds (B6), else one (B1). DBG: each round's centres
// also go to dbg (n_rounds n_pad, B), beside the ring.
template <int W, bool RING, bool DBG>
__global__ void __launch_bounds__(TPB, 3)
    klein_tc_kernel(TcOperands op, Uniforms un, float* __restrict__ yout,
                    float* __restrict__ lw_out, float* __restrict__ dbg,
                    int* __restrict__ bad, long long B, int n_rounds,
                    uint32_t step0, uint32_t chain_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pad = op.n_pad;
  unsigned char* ytile = smem;
  float* ct = reinterpret_cast<float*>(smem + (size_t)n_pad * Y_ROW);
  const uint32_t ysm = (uint32_t)__cvta_generic_to_shared(ytile);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid >> 1, h = tid & 1;   // chain of the block, half
  const long long chain = (long long)blockIdx.x * NC + cl;
  const bool valid = chain < B;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  float* crow = ct + cl * CT_STRIDE;

  float ymax = 0.0f;
  const int rounds = RING ? n_rounds : 1;
  for (int rd = 0; rd < rounds; ++rd) {
    const uint32_t step = step0 + (uint32_t)rd;
    const long long row0 = (long long)rd * n_pad;
    double lwp = 0.0;
    for (int lo = n_pad - RB; lo >= 0; lo -= RB) {
      __syncthreads();   // rows >= lo + 64 drawn; the tile is free
      {
        // the block's coupling to the rows drawn (rows >= lo + 64): warp w
        // takes its rows lo + 32w .. +31
        float cacc[2][4][4];
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
                  to_bf16_bits(y);
              if (valid) {
                const size_t at =
                    (size_t)(row0 + i) * (size_t)B + (size_t)chain;
                yout[at] = y;
                ymax = fmaxf(ymax, fabsf(y));
                if (fabsf(y) > EXACT_Y) atomicAdd(bad, 1);
                if constexpr (DBG) dbg[at] = c;
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
          sub_update<PASSES>(ad, ysm, ct, lo, sb, warp, lane);
          __syncthreads();
        }
      }
    }
    if (h == 0 && valid)
      lw_out[(size_t)rd * (size_t)B + (size_t)chain] = (float)lwp;
  }
  if (h == 0 && valid) atomicMax(bad + 1, (int)ymax);
}

template <int W, bool RING, bool DBG>
int launch(const TcOperands& op, const Uniforms& un, float* y, float* lw,
           float* dbg, int* bad, long long B, int n_rounds, uint32_t step,
           uint32_t chain_offset, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(op.n_pad);
  cudaError_t e = cudaFuncSetAttribute(
      klein_tc_kernel<W, RING, DBG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + NC - 1) / NC));
  klein_tc_kernel<W, RING, DBG><<<grid, TPB, smem, stream>>>(
      op, un, y, lw, dbg, bad, B, n_rounds, step, chain_offset);
  return (int)cudaGetLastError();
}

template <bool RING, bool DBG>
int launch_by_window(const TcOperands& op, const Uniforms& un, float* y,
                     float* lw, float* dbg, int* bad, long long B,
                     int n_rounds, uint32_t step, uint32_t chain_offset,
                     cudaStream_t st) {
#define CALL(W)                                                          \
  launch<W, RING, DBG>(op, un, y, lw, dbg, bad, B, n_rounds, step,      \
                       chain_offset, st)
  switch (op.window) {
    case 8: return CALL(8);
    case 16: return CALL(16);
    case 24: return CALL(24);
    default: return CALL(0);
  }
#undef CALL
}

template <int W, bool RING>
int info(int n_pad, int* out) {
  cudaFuncAttributes fa;
  const auto kernel = klein_tc_kernel<W, RING, false>;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tc_smem_bytes(n_pad);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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

template <bool RING>
int info_by_window(int n_pad, int window, int* out) {
  switch (window) {
    case 8: return info<8, RING>(n_pad, out);
    case 16: return info<16, RING>(n_pad, out);
    case 24: return info<24, RING>(n_pad, out);
    default: return info<0, RING>(n_pad, out);
  }
}

}  // namespace

extern "C" {

// B1 (n_rounds 1) and B6: n_rounds Klein draws per chain into the ring y
// (n_rounds n_pad, B) and the lw ring (n_rounds, B). Ufrag: the three bf16
// parts of U in A-fragment order ((n_pad/16)^2 * 3 * 32 16-byte entries),
// UT float32. unif: (n_rounds n_pad, B) or null for Philox (round r at
// step + r). bad: two ints, bad[0] incremented per drawn |y| > 256, bad[1]
// raised to the largest drawn |y|. dbg: null, or (n_rounds n_pad, B) for
// each round's centres (the ring instantiation, any n_rounds).
int klein_tc_launch(const void* Ufrag, const float* UT, const float* cs,
                    const float* isg, const float* unif, float* y, float* lw,
                    float* dbg, int* bad, int n_pad, long long B, int window,
                    int n_rounds, uint32_t seed_lo, uint32_t seed_hi,
                    uint32_t step, uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_rounds <= 0 || bad == nullptr)
    return (int)cudaErrorInvalidValue;
  const TcOperands op{static_cast<const uint4*>(Ufrag), UT, cs, isg, n_pad,
                      window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbg != nullptr)
    return launch_by_window<true, true>(op, un, y, lw, dbg, bad, B, n_rounds,
                                        step, chain_offset, st);
  if (n_rounds == 1)
    return launch_by_window<false, false>(op, un, y, lw, dbg, bad, B, 1,
                                          step, chain_offset, st);
  return launch_by_window<true, false>(op, un, y, lw, dbg, bad, B, n_rounds,
                                       step, chain_offset, st);
}

// The resources of B1's (ring 0) or B6's (ring 1) kernel for a window at
// n_pad: out[0] registers a thread, out[1] local (spill) bytes a thread,
// out[2] dynamic shared memory a block, out[3] blocks per SM, out[4]
// threads a block.
int klein_tc_info(int n_pad, int window, int ring, int* out) {
  return ring ? info_by_window<true>(n_pad, window, out)
              : info_by_window<false>(n_pad, window, out);
}

const char* klein_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
