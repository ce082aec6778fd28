// Klein draw (B1), its ring (B6) and batched Babai decoding (B7) on Hopper
// (sm_90a), on the tensor-core sweep of the fused IMHK kernel (imhk_tc.cu,
// B2): the coupling on the tensor cores, the proposal kept in shared memory.
//
// Replaces the draw mode (klein_sample_batch_pallas, B1) and the ring mode
// (klein_sample_ring_pallas, B6) of the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/klein_pallas.py `_kernel`, and the
// inner kernel of babai_decode_batch_pallas (B7). The law is the same; the
// TPU layout devices (CDF as a triangular matrix product, (8, 128) row
// groups, the 8-row DMA staging of the rings) are not carried over. Above
// n_pad 3,456 the proposal tile no longer fits a block's shared memory,
// and the wrappers take the FP32 sweep of klein.cu instead (klein_cuda.py
// `klein_route`, chosen by n_pad before the launch).
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
//   keeps the largest |y| drawn. Fault C11: where the wrapper predicts
//   draws beyond 256 (the LLL-reduced q-ary bases, klein_cuda.py
//   `wide_y`), it takes the WIDE instantiation, which carries such y on
//   their second and third bf16 parts as B7 does (below), reading them
//   back from the round's rows of the ring, and counts nothing.
// - Two threads draw each row (`draw_pair`, draw_row's arithmetic bit for
//   bit), with the uniforms fetched a row pair ahead.
// - B6's rounds run inside the block, which reuses its tiles; lw is summed
//   in double and written once a round.
// - Windows 8, 16 and 24 are compiled with the CDF in registers; any other
//   window takes the W 0 instantiation, whose draw (imhk_tc_common.cuh
//   `draw_split`) splits the window by side in one pass, keeps each
//   segment's end CDF and the upper side's anchors in shared memory (the
//   lower side's CDFs in the coupling tile's unused floats up to 8
//   segments, the anchors after the kernel's own: 256 bytes a segment of
//   a side), and walks only the segment where the CDF crosses u total
//   again. At n_pad 1024 three blocks an SM fit it up to window 112,
//   narrow and WIDE; where the tile and the store pass a block's 227 KB
//   (n_pad 3,456 past window 112, from n_pad 3,200 at the widest windows)
//   klein_cuda.py `klein_route` takes klein.cu's sweep.
// - 64 threads and 64 n_pad + 9,344 bytes of shared memory a block (74,880
//   at n_pad 1024), and at W 0 the draw's store: three blocks (96 chains)
//   per SM there.
//
// Randomness: host uniforms or Philox4x32-10, the function of
// lattice_gaussian_mcmc_tpu_torch/utils/prng.py, bit for bit.
//
// Centred draws (CENTRED, B1 with a centre per chain; the FALCON signer,
// samplers/sign.py): row i of chain b is drawn around ct[i, b] - coupling
// in place of cs_i - coupling, with the same arithmetic, so centres all
// equal to cs give B1's draw bit for bit. The two threads of a chain fetch
// the centres of their rows with the uniforms, a row pair ahead, so the
// read stays off the rows' serial chain. Window 40 (the signing window:
// tail budget 2^-64 on FALCON-512) is compiled with its CDF in registers,
// any other takes the runtime window. Narrow only: the caller recentres
// each chain on an integer point, so that its draws stay within 256.
// In-kernel Philox gives the midpoint uniform, (k + 1/2) 2^-23
// (`midpoint_uniform`): k = 0 would take the window's first point, 20
// below round(c) at W 40, with probability 2^-23 a row. Caller uniforms
// are used as given.
//
// Babai (BABAI, B7): the same sweep with rintf (half to even, hazard C3)
// in place of the draw, per target on recentred centres ct (n_pad, B)
// (the wrapper removes k = rint(ct) in float64 first): y_i = rint(ct_i -
// sum_{j>i} U_ij y_j), written to y (n_pad, B) as float32. No uniforms, no
// lw. Two latencies that the draw hides behind its exps lie on B7's
// serial chain of rows, so B7 moves them off it: the centres of a 64-row
// block are read once, beside its coupling, and folded into the coupling
// tile (crow = coupling - ct, the row's centre -crow: the plain version's
// order, ct - cross - within); the 16 x 16 triangle of U that a sub-block's
// rows add to each other is staged in shared memory by cp.async while the
// tensor cores run. Bound (n = 1024,
// 65,536 targets): the coupling's n(n-1) FLOP a target is 1.02 ms in FP32
// on the CUDA cores, 0.07 ms a bf16 pass on the tensor cores (0.21 ms for
// the three), and ct read and y written once 0.16 ms at 3.35 TB/s.
// Reach in y: the recentred y_i = x_i - rint(ct_i) is about
// -sum_{j>i} U_ij x_j, which exceeds bf16's exact 256 when U has large
// entries, and B7 must decode what the FP32 sweep decodes (exact for
// |y| < 2^24). The tile holds y1 = bf16(y), rounded to nearest; a row
// with |y| > 256 flags its 16-row tile, and the products over flagged
// tiles also take y2 and y3 (imhk_tc_common.cuh `WideY`), so that
// U1..U3 x y1..y3 is exact. Unflagged tiles keep the three passes.
// bad[0] counts the coefficients with |y| > 256 and bad[1] keeps the
// largest |y|; neither raises. Shared memory: the draw's, the 1 KB
// triangle and a byte a 16-row tile (75,968 bytes at n_pad 1024: still
// three blocks an SM).

#include "imhk_tc_common.cuh"

using namespace lgk;

namespace {

constexpr int PASSES = PARTS;       // bf16 passes of the coupling (all)

// Shared memory beyond the draw's: B7's staged 16 x 16 triangle of U of
// a sub-block (1 KB), then, for B7 and WIDE, a byte a 16-row tile
constexpr int TRI_BYTES = SB * SB * sizeof(float);
__host__ __device__ inline size_t klein_smem_bytes(int n_pad, bool babai,
                                                   bool wide) {
  return tc_smem_bytes(n_pad) + (babai ? TRI_BYTES : 0) +
         ((babai || wide) ? (size_t)(n_pad / SB) : 0);
}

__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// B7: start copying UT[b0 + r, b0 .. b0 + 15] (U[b0 .., b0 + r], the
// columns of the sub-block's rows) into tri[r * 16 ..], 16 bytes a thread
__device__ __forceinline__ void tri_load(uint32_t tri, const float* UT,
                                        int n_pad, int b0, int tid) {
  const int r = tid >> 2, q = tid & 3;
  cp_async16(tri + (uint32_t)(r * SB + 4 * q) * sizeof(float),
             UT + (size_t)(b0 + r) * n_pad + b0 + 4 * q);
}

// B7: acc (rows 32 warp .. +31 of the block lo) less the centres ctin of
// those rows into the coupling tile, ct[chain * CT_STRIDE + row] =
// coupling - centre: the row's centre is then minus the tile's entry once
// the rows below it in the block have added theirs
__device__ __forceinline__ void store_ct_centred(
    const float (&acc)[2][4][4], float* ct, const float* __restrict__ ctin,
    long long B, long long chain0, int lo, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float v[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lo + 32 * warp + 16 * m + g + 8 * (e >> 1);
        const long long c = chain0 + 8 * n + 2 * t + (e & 1);
        v[m][n][e] =
            c < B ? __ldg(ctin + (size_t)r * (size_t)B + (size_t)c) : 0.0f;
      }
  float d[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[m][n][e] = __fsub_rn(acc[m][n][e], v[m][n][e]);
  store_ct(d, ct, warp, lane);
}

// RING: n_rounds rounds (B6), else one (B1). DBG: each round's centres
// also go to dbg (n_rounds n_pad, B), beside the ring. BABAI: B7 on the
// centres ctin (n_pad, B), one round, no draw (W, RING, DBG unused).
// WIDE: B1/B6 with y's wide parts (fault C11). CENTRED: B1 around the
// centres ctin (n_pad, B), one round (RING, DBG, BABAI, WIDE unused).
template <int W, bool RING, bool DBG, bool BABAI = false, bool WIDE = false,
          bool CENTRED = false>
__global__ void __launch_bounds__(TPB, 3)
    klein_tc_kernel(TcOperands op, Uniforms un,
                    const float* __restrict__ ctin, float* yout,
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

  // B7: the staged triangle of U; B7 and WIDE: the flags of the 16-row
  // tiles holding some |y| > 256
  constexpr bool WIDE_ON = BABAI || WIDE;
  const size_t tri_at = tc_smem_bytes(n_pad);
  const float* tri = reinterpret_cast<const float*>(smem + tri_at);
  const uint32_t trism = ysm + (uint32_t)tri_at;
  unsigned char* big = smem + tri_at + (BABAI ? TRI_BYTES : 0);
  // W 0: this thread's slots of draw_split's store (split_slot)
  int sstride = 0;
  float* slot = nullptr;
  if constexpr (W == 0 && !BABAI)
    slot = split_slot(reinterpret_cast<float*>(
                          smem + split_at(klein_smem_bytes(n_pad, BABAI,
                                                           WIDE))),
                      crow, op.window, true, cl, h, sstride);
  const long long chain0 = (long long)blockIdx.x * NC;
  int n_big = 0;

  float ymax = 0.0f;
  const int rounds = RING ? n_rounds : 1;
  for (int rd = 0; rd < rounds; ++rd) {
    const uint32_t step = step0 + (uint32_t)rd;
    const long long row0 = (long long)rd * n_pad;
    // the round's rows of y, where the wide parts are read back; a flag
    // cleared here is set again only after the first barrier below
    const WideY wide{big, yout + (size_t)row0 * (size_t)B, B, chain0};
    if constexpr (WIDE_ON)
      for (int k = tid; k < n_pad / SB; k += TPB) big[k] = 0;
    double lwp = 0.0;
    // row ih's uniform
    const auto fetch = [&](int ih) -> float {
      // CENTRED: in-kernel Philox gives the midpoint uniform
      return valid ? un.get<CENTRED>(row0 + ih, chain, chain_id,
                                     (uint32_t)ih, step, TAG_ROW)
                   : 0.5f;
    };
    // CENTRED: row ih's centre of this chain
    const auto centre = [&](int ih) -> float {
      return valid ? __ldg(ctin + (size_t)ih * (size_t)B + (size_t)chain)
                   : 0.0f;
    };
    for (int lo = n_pad - RB; lo >= 0; lo -= RB) {
      __syncthreads();   // rows >= lo + 64 drawn; the tile is free
      {
        // the block's coupling to the rows drawn (rows >= lo + 64): warp w
        // takes its rows lo + 32w .. +31
        float cacc[2][4][4];
        if constexpr (BABAI) {
          tri_load(trism, op.UT, n_pad, lo + RB - SB, tid);
          couple<PASSES, false, WideY>(op, ysm, cacc, lo, warp, lane, wide);
          store_ct_centred(cacc, ct, ctin, B, chain0, lo, warp, lane);
          cp_async_wait_all();
        } else {
          if constexpr (WIDE)
            couple<PASSES, false>(op, ysm, cacc, lo, warp, lane, wide);
          else
            couple<PASSES>(op, ysm, cacc, lo, warp, lane);
          store_ct(cacc, ct, warp, lane);
        }
      }
      __syncthreads();
      for (int sb = RB / SB - 1; sb >= 0; --sb) {
        const int rlo = SB * sb;
        uint4 ad[RB / SB - 1][PARTS];
        load_diag(ad, op.Ufrag, lo, sb, n_pad >> 4, lane);
        // uniforms of rows r2 (thread 0) and r2 - 1 (thread 1), one pair
        // ahead of the draws (B7 has none)
        int ih = lo + rlo + SB - 1 - h;
        float uh = 0.0f;
        if constexpr (!BABAI) uh = fetch(ih);
        float chh = 0.0f;
        if constexpr (CENTRED) chh = centre(ih);
        for (int r2 = rlo + SB - 1; r2 > rlo; r2 -= 2) {
          float upair[2] = {0.0f, 0.0f};
          float cpair[2] = {0.0f, 0.0f};
          if constexpr (!BABAI) {
            upair[0] = __shfl_sync(FULL, uh, lane & ~1);
            upair[1] = __shfl_sync(FULL, uh, lane | 1);
            if constexpr (CENTRED) {
              cpair[0] = __shfl_sync(FULL, chh, lane & ~1);
              cpair[1] = __shfl_sync(FULL, chh, lane | 1);
            }
            if (r2 - 2 > rlo) {
              ih -= 2;
              uh = fetch(ih);
              if constexpr (CENTRED) chh = centre(ih);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r2 - e;
            const int i = lo + r;
            // U[rr, i] for the sub-block's rows rr < r, by quads split by
            // parity between the two threads, loaded before the draw (B7:
            // from the staged triangle)
            const float4* ucol = reinterpret_cast<const float4*>(
                op.UT + (size_t)i * n_pad + lo);
            const float4* tcol =
                reinterpret_cast<const float4*>(tri + (r - rlo) * SB);
            float4 uq[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int q = (rlo >> 2) + h + 2 * j;
              if (4 * q < r)
                uq[j] = BABAI ? tcol[h + 2 * j] : __ldg(ucol + q);
            }
            float c, y;
            if constexpr (BABAI) {
              c = -crow[r];
              y = rintf(c);
            } else {
              float cs_i;
              if constexpr (CENTRED)
                cs_i = cpair[e];
              else
                cs_i = __ldg(op.cs + i);
              c = __fsub_rn(cs_i, crow[r]);
              float logz;
              if constexpr (W == 0)
                y = draw_split(c, __ldg(op.isg + i), upair[e], op.window, h,
                               lane, slot, sstride, logz);
              else
                y = draw_pair<W>(c, __ldg(op.isg + i), upair[e], op.window,
                                 h, lane, logz);
              lwp += (double)logz;
            }
            if (h == 0) {
              *reinterpret_cast<unsigned short*>(ytile + y_off(i, cl)) =
                  WIDE_ON ? to_bf16_rn_bits(y) : to_bf16_bits(y);
              if (valid) {
                const size_t at =
                    (size_t)(row0 + i) * (size_t)B + (size_t)chain;
                yout[at] = y;
                ymax = fmaxf(ymax, fabsf(y));
                if (fabsf(y) > EXACT_Y) {
                  if constexpr (WIDE_ON) {
                    big[i / SB] = 1;
                    ++n_big;
                  } else {
                    atomicAdd(bad, 1);
                  }
                }
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
          if constexpr (BABAI) {
            tri_load(trism, op.UT, n_pad, lo + rlo - SB, tid);
            sub_update<PASSES, WideY>(ad, ysm, ct, lo, sb, warp, lane, wide);
            cp_async_wait_all();
          } else if constexpr (WIDE) {
            sub_update<PASSES>(ad, ysm, ct, lo, sb, warp, lane, wide);
          } else {
            sub_update<PASSES>(ad, ysm, ct, lo, sb, warp, lane);
          }
          __syncthreads();
        }
      }
    }
    if (!BABAI && h == 0 && valid)
      lw_out[(size_t)rd * (size_t)B + (size_t)chain] = (float)lwp;
  }
  if (h == 0 && valid) {
    if (BABAI && n_big) atomicAdd(bad, n_big);
    atomicMax(bad + 1, (int)ymax);
  }
}

// A block's shared memory: klein_smem_bytes, and for a draw at W 0
// draw_split's store for the window
template <int W, bool BABAI, bool WIDE>
size_t kernel_smem(int n_pad, int window) {
  const size_t own = klein_smem_bytes(n_pad, BABAI, WIDE);
  return W == 0 && !BABAI ? split_at(own) + split_bytes(window, true) : own;
}

template <int W, bool RING, bool DBG, bool BABAI = false, bool WIDE = false,
          bool CENTRED = false>
int launch(const TcOperands& op, const Uniforms& un, const float* ctin,
           float* y, float* lw, float* dbg, int* bad, long long B,
           int n_rounds, uint32_t step, uint32_t chain_offset,
           cudaStream_t stream) {
  const size_t smem = kernel_smem<W, BABAI, WIDE>(op.n_pad, op.window);
  cudaError_t e = cudaFuncSetAttribute(
      klein_tc_kernel<W, RING, DBG, BABAI, WIDE, CENTRED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + NC - 1) / NC));
  klein_tc_kernel<W, RING, DBG, BABAI, WIDE, CENTRED>
      <<<grid, TPB, smem, stream>>>(
      op, un, ctin, y, lw, dbg, bad, B, n_rounds, step, chain_offset);
  return (int)cudaGetLastError();
}

template <bool RING, bool DBG, bool WIDE = false>
int launch_by_window(const TcOperands& op, const Uniforms& un, float* y,
                     float* lw, float* dbg, int* bad, long long B,
                     int n_rounds, uint32_t step, uint32_t chain_offset,
                     cudaStream_t st) {
#define CALL(W)                                                          \
  launch<W, RING, DBG, false, WIDE>(op, un, nullptr, y, lw, dbg, bad, B, \
                                    n_rounds, step, chain_offset, st)
  switch (op.window) {
    case 8: return CALL(8);
    case 16: return CALL(16);
    case 24: return CALL(24);
    default: return CALL(0);
  }
#undef CALL
}

// B1 with a centre per chain: window 40 compiled, any other at run time
int launch_centred(const TcOperands& op, const Uniforms& un, const float* ct,
                   float* y, float* lw, int* bad, long long B, uint32_t step,
                   uint32_t chain_offset, cudaStream_t st) {
#define CALL(W)                                                         \
  launch<W, false, false, false, false, true>(op, un, ct, y, lw, nullptr, \
                                              bad, B, 1, step,            \
                                              chain_offset, st)
  return op.window == 40 ? CALL(40) : CALL(0);
#undef CALL
}

template <int W, bool RING, bool BABAI = false, bool WIDE = false,
          bool CENTRED = false>
int info(int n_pad, int window, int* out) {
  cudaFuncAttributes fa;
  const auto kernel = klein_tc_kernel<W, RING, false, BABAI, WIDE, CENTRED>;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = kernel_smem<W, BABAI, WIDE>(n_pad, window);
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

template <bool RING, bool WIDE = false>
int info_by_window(int n_pad, int window, int* out) {
  switch (window) {
    case 8: return info<8, RING, false, WIDE>(n_pad, window, out);
    case 16: return info<16, RING, false, WIDE>(n_pad, window, out);
    case 24: return info<24, RING, false, WIDE>(n_pad, window, out);
    default: return info<0, RING, false, WIDE>(n_pad, window, out);
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
// each round's centres (the ring instantiation, any n_rounds). wide: take
// the WIDE instantiation (y's wide parts, nothing counted into bad[0]);
// not with dbg.
int klein_tc_launch(const void* Ufrag, const float* UT, const float* cs,
                    const float* isg, const float* unif, float* y, float* lw,
                    float* dbg, int* bad, int n_pad, long long B, int window,
                    int n_rounds, uint32_t seed_lo, uint32_t seed_hi,
                    uint32_t step, uint32_t chain_offset, int wide,
                    void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_rounds <= 0 || bad == nullptr || (wide && dbg != nullptr))
    return (int)cudaErrorInvalidValue;
  const TcOperands op{static_cast<const uint4*>(Ufrag), UT, cs, isg, n_pad,
                      window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide && n_rounds == 1)
    return launch_by_window<false, false, true>(op, un, y, lw, dbg, bad, B,
                                                1, step, chain_offset, st);
  if (wide)
    return launch_by_window<true, false, true>(op, un, y, lw, dbg, bad, B,
                                               n_rounds, step, chain_offset,
                                               st);
  if (dbg != nullptr)
    return launch_by_window<true, true>(op, un, y, lw, dbg, bad, B, n_rounds,
                                        step, chain_offset, st);
  if (n_rounds == 1)
    return launch_by_window<false, false>(op, un, y, lw, dbg, bad, B, 1,
                                          step, chain_offset, st);
  return launch_by_window<true, false>(op, un, y, lw, dbg, bad, B, n_rounds,
                                       step, chain_offset, st);
}

// B1 with a centre per chain: one Klein draw a chain around its own
// recentred centres ct (n_pad, B), which take the place of cs; the rest as
// klein_tc_launch's one-round draw (uniforms, y, lw, bad, step, chain
// offset). Narrow only (no WIDE instantiation): a drawn |y| > 256 is
// counted into bad[0].
int klein_tc_centred_launch(const void* Ufrag, const float* UT,
                            const float* ct, const float* isg,
                            const float* unif, float* y, float* lw, int* bad,
                            int n_pad, long long B, int window,
                            uint32_t seed_lo, uint32_t seed_hi, uint32_t step,
                            uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      ct == nullptr || bad == nullptr)
    return (int)cudaErrorInvalidValue;
  const TcOperands op{static_cast<const uint4*>(Ufrag), UT, nullptr, isg,
                      n_pad, window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  return launch_centred(op, un, ct, y, lw, bad, B, step, chain_offset,
                        static_cast<cudaStream_t>(stream));
}

// B7: Babai nearest plane for B targets on the recentred centres ct
// (n_pad, B); coefficients (recentred) into y (n_pad, B). Ufrag and UT as
// for klein_tc_launch. bad: two ints, bad[0] incremented per coefficient
// with |y| > 256 (decoded on the wide parts), bad[1] raised to the largest
// |y|.
int babai_tc_launch(const void* Ufrag, const float* UT, const float* ct,
                    float* y, int* bad, int n_pad, long long B,
                    void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || bad == nullptr)
    return (int)cudaErrorInvalidValue;
  const TcOperands op{static_cast<const uint4*>(Ufrag), UT, nullptr,
                      nullptr, n_pad, 1};
  const Uniforms un{nullptr, B, 0u, 0u};
  return launch<0, false, false, true>(op, un, ct, y, nullptr, nullptr, bad,
                                       B, 1, 0u, 0u,
                                       static_cast<cudaStream_t>(stream));
}

// The resources of the kernel in mode 0 (B1), 1 (B6), 2 (B7, any
// window), 3 (B1's WIDE), 4 (B6's WIDE) or 5 (centred B1) for a window at
// n_pad: out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] dynamic
// shared memory a block, out[3] blocks per SM, out[4] threads a block.
int klein_tc_info(int n_pad, int window, int mode, int* out) {
  switch (mode) {
    case 0: return info_by_window<false>(n_pad, window, out);
    case 1: return info_by_window<true>(n_pad, window, out);
    case 2: return info<0, false, true>(n_pad, window, out);
    case 3: return info_by_window<false, true>(n_pad, window, out);
    case 4: return info_by_window<true, true>(n_pad, window, out);
    case 5:
      return window == 40
                 ? info<40, false, false, false, true>(n_pad, window, out)
                 : info<0, false, false, false, true>(n_pad, window, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* klein_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
