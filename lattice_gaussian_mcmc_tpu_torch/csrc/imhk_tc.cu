// Fused IMHK steps (B2) and the IMHK trajectory (B3) on Hopper (sm_90a),
// with the Klein coupling on the tensor cores and the proposal in device
// memory, so that eight blocks (256 chains) share an SM.
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
// - A thread block owns NC = 32 chains for all n_steps steps, two threads
//   a chain. A chain's rows are serial (row i's centre needs y_{i+1}), so
//   only other chains' rows hide a row's latency: the kernel is built for
//   eight blocks an SM (256 chains, 16 warps). __launch_bounds__ holds a
//   thread to 128 registers, and a block takes 21,120 bytes of shared
//   memory whatever n_pad is (at W 0 the draw's store too, with which
//   eight blocks fit up to window 288), so the registers set the
//   residency at every n_pad (imhk_tc_info reports it). The WIDE
//   instantiation is built for four blocks (128 chains): its wide parts
//   would spill at 128 registers.
// - The proposal lives in a device-memory scratch that the wrapper
//   allocates, n_pad x 64 bytes a block: bf16, (n_pad, 32) chain-minor,
//   the 16-byte chunks of a row XOR-swizzled by (row / 2) mod 4
//   (imhk_tc_common.cuh `y_off`), so that ldmatrix reads eight rows
//   without bank conflicts. Shared memory holds the 64-row block being
//   drawn (the tile, 4 KB), a ring of Y's rows (6 KB), the coupling tile
//   (9 KB), the accept flags, and the block's cs and isg with a sub-block's
//   16 x 16 triangle of UT (1.5 KB). While block lo's coupling runs, each
//   thread stores its 16-byte chunk of each 16-row slice of the block
//   above (rows lo + 64 .. lo + 127) from the tile to the scratch; it
//   later copies the same chunks back with cp.async, so a thread reads
//   back only what it wrote.
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
//   accumulation (`couple_ring`): each warp takes 32 rows. Y's first four
//   16-row k-steps (the block above) come from the tile, the rest from the
//   scratch through the ring, three pairs of k-steps filled two pairs
//   ahead, one barrier a pair. U's fragments stream from L2 one pair of
//   k-steps ahead in registers (6 MB of parts at n = 1024, 2.9 MB read per
//   block of chains and proposal). Each pair of steps sums into a zeroed
//   partial accumulator that is then added in IEEE FP32 into the coupling
//   tile, so the tensor cores' own rounding acts on short sums only: the
//   sums and their order are imhk_tc_common.cuh `couple`'s.
// - The block's rows go in four sub-blocks of 16. Once a sub-block is
//   drawn, U's fragments of its columns are loaded and its coupling to the
//   rows below it in the block is one more small product on the tensor
//   cores (16 sb x 32 x 16, three passes); within a sub-block, after y_r
//   the pair adds U[rr, r] y_r (FP32, float4 quads split by parity) into
//   the coupling of its rows rr < r in a (32, 72)-float tile, so the next
//   row's centre is one shared load away. A row's cs, isg and column of U
//   are shared loads too: the block's cs and isg are staged while its
//   coupling runs, and each sub-block's triangle of UT by cp.async while
//   the sub-block before it finishes (klein_tc.cu's `tri_load`).
// - Each row is drawn by two threads per chain: each computes half of the
//   window's weights, one side's segments of products (klein_common.cuh:
//   two exps a thread a row at W 16, four at W 24); the CDF is the same
//   sequential sum as draw_row's (the low half's sum is shuffled up), so
//   the draw is draw_row's bit for bit. Each thread draws the Philox
//   uniform of one row of a pair, one pair ahead of the draws. Windows 8,
//   16 and 24 are compiled (`draw_pair`); any other takes the W 0
//   instantiation, whose draw (`draw_split`) also splits the window by
//   side: one pass, the lower side's segment-end CDFs and the upper
//   side's anchors kept in shared memory after the kernel's own
//   (split_bytes, 384 bytes a segment of a side), the upper side walked
//   again by products from its anchors, and only the segment where the
//   CDF crosses u total walked a third time.
// - At 256 chains an SM the draws are bound by instruction issue (the
//   row loop ~220 SASS instructions a row at W 16, ~274 at W 24,
//   tools/draw_sass.py), no longer by a row's latency; the coupling alone
//   is L2-bound on U's fragments; see PERF.md. The
//   largest n_pad, 3,456 (klein_cuda.py IMHK_TC_MAX_N_PAD; its wrapper
//   raises above it), is B1's, which starts the chains.
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
constexpr int MIN_BLOCKS = 8;       // blocks an SM: <= 128 registers a thread
// WIDE at window 104 spills 216 bytes a thread at 128 registers and runs
// 2% slower than at four blocks, where it spills nothing (q-ary n = 64,
// W 104, 65,536 chains, NVIDIA H100)
constexpr int MIN_BLOCKS_WIDE = 4;
constexpr int TILE_BYTES = RB * Y_ROW;   // the 64-row block's rows
constexpr int SLICE = SB * Y_ROW;        // 16 rows of Y, one k-step
constexpr int PAIR = 2 * SLICE;          // two k-steps, one slot of the ring
constexpr int RING = 3;                  // slots of the ring
// the 64-row block's cs and isg, and a sub-block's 16 x 16 triangle of UT
constexpr int TRI_BYTES = SB * SB * sizeof(float);
constexpr int OPS_BYTES = 2 * RB * sizeof(float) + TRI_BYTES;

// The tile, the ring, the coupling tile, one int a chain, the staged
// operands and WIDE's flags (a byte a 16-row tile): 21,120 bytes and the
// flags, whatever n_pad is
__host__ __device__ inline size_t imhk_smem_bytes(int n_pad, bool wide) {
  return (size_t)TILE_BYTES + (size_t)RING * PAIR +
         (size_t)NC * CT_STRIDE * sizeof(float) + (size_t)NC * sizeof(int) +
         OPS_BYTES + (wide ? (size_t)(n_pad / SB) : 0);
}

__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying UT[b0 + r, b0 .. b0 + 15] into tri[r * 16 ..], 16 bytes a
// thread (klein_tc.cu `tri_load`): one commit group.
__device__ __forceinline__ void tri_fetch(uint32_t tri, const float* UT,
                                          int n_pad, int b0, int tid) {
  const int r = tid >> 2, q = tid & 3;
  cp_async16(tri + (uint32_t)(r * SB + 4 * q) * sizeof(float),
             UT + (size_t)(b0 + r) * n_pad + b0 + 4 * q);
  cp_async_commit();
}

// Start copying k-steps k and k + 1 (rows 16k .. 16k + 31) of the block's
// scratch into a slot of the ring: thread t copies the 16-byte chunk t of
// each 1 KB slice, the chunk it stored. One commit group, empty past the
// last k-step.
__device__ __forceinline__ void fetch_pair(uint32_t slot,
                                           const unsigned char* ysc, int k,
                                           int KT, int tid) {
  if (k < KT) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      cp_async16(slot + j * SLICE + 16 * tid,
                 ysc + (size_t)(k + j) * SLICE + 16 * tid);
  }
  cp_async_commit();
}

// imhk_tc_common.cuh `couple` (DIAG false) and `store_ct` with Y read
// from two places: k-steps kt0 .. kt0 + 3 (the 64-row block above, rows
// lo + 64 .. lo + 127) from the tile, the rest from the block's scratch
// through the ring, RING - 1 pairs ahead, one barrier a pair. U's
// fragments stream from L2 one pair of k-steps ahead in registers. Each
// pair's partial sums are added into the thread's entries of the coupling
// tile ct, zeroed first, rather than into registers: the products, the
// sums and their order are couple's, and ct ends as store_ct leaves it.
template <class Wide = NoWide>
__device__ void couple_ring(const TcOperands& op, uint32_t tile,
                            uint32_t ring, const unsigned char* ysc,
                            float* ct, int lo, int warp, int lane, int tid,
                            const Wide& wide = Wide()) {
  const int KT = op.n_pad >> 4;
  const int kt0 = (lo + RB) >> 4;
  const int kg = kt0 + RB / SB;   // the first k-step read from the scratch
  const int mi = lane >> 3, rin = lane & 7;   // ldmatrix: matrix, its row
  const int mt0 = (lo >> 4) + 2 * warp;
  // the thread's entries: rows 32 warp + 16 m + g (+ 8), chains 8 n + 2 t
  // (+ 1), as store_ct places them
  float* cw = ct + (2 * (lane & 3)) * CT_STRIDE + 32 * warp + (lane >> 2);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cw[(8 * n + (e & 1)) * CT_STRIDE + 16 * m + 8 * (e >> 1)] = 0.0f;
#pragma unroll
  for (int j = 0; j < RING - 1; ++j)
    fetch_pair(ring + j * PAIR, ysc, kg + 2 * j, KT, tid);
  uint4 a[2][2][PARTS];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (kt0 + j < KT) load_a(a[j], op.Ufrag, mt0, kt0 + j, KT, lane);
  int slot = 0;
  for (int kt = kt0; kt < KT; kt += 2) {
    uint32_t src = tile + (uint32_t)(kt - kt0) * SLICE;
    if (kt >= kg) {
      cp_async_wait<RING - 2>();
      __syncthreads();   // the pair has landed; the slot refilled was read
      fetch_pair(ring + ((slot + RING - 1) % RING) * PAIR, ysc,
                 kt + 2 * (RING - 1), KT, tid);
      src = ring + slot * PAIR;
      slot = slot + 1 == RING ? 0 : slot + 1;
    }
    float part[2][4][4];
    zero(part);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k = kt + kk;
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int row = ((mi & 1) << 3) + rin;   // of the 16-row slice
        const int nt = 2 * np + (mi >> 1);
        ldsm_x4_t(src + kk * SLICE + row * Y_ROW +
                      ((nt ^ ((row >> 1) & 3)) << 4),
                  b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                  b[2 * np + 1][1]);
      }
#pragma unroll
      for (int p = PASSES - 1; p >= 0; --p)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(part[m][n], a[kk][m][p], b[n][0], b[n][1]);
      if constexpr (Wide::on) {
        if (wide.tile(k)) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            uint32_t b2[2], b3[2];
            wide_frags(wide, k, n, lane, b2, b3);
#pragma unroll
            for (int p = PASSES - 1; p >= 0; --p)
#pragma unroll
              for (int m = 0; m < 2; ++m) {
                mma_bf16(part[m][n], a[kk][m][p], b3[0], b3[1]);
                mma_bf16(part[m][n], a[kk][m][p], b2[0], b2[1]);
              }
          }
        }
      }
      if (k + 2 < KT) load_a(a[kk], op.Ufrag, mt0, k + 2, KT, lane);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& c = cw[(8 * n + (e & 1)) * CT_STRIDE + 16 * m + 8 * (e >> 1)];
          c = __fadd_rn(c, part[m][n][e]);
        }
  }
}

// DBG: step 0 also writes each row's centre to dbg[i, chain] and its draw
// to dbg[n_pad + i, chain]. WIDE: y's wide parts through yprop (fault
// C11).
template <int W, bool DBG, bool WIDE = false>
__global__ void __launch_bounds__(TPB, WIDE ? MIN_BLOCKS_WIDE : MIN_BLOCKS)
    imhk_tc_kernel(TcOperands op, Uniforms un, float* __restrict__ x,
                   float* __restrict__ lw_state, float* __restrict__ acc,
                   float* __restrict__ tlw, float* __restrict__ tx,
                   float* __restrict__ dbg, float* yprop,
                   unsigned char* yscratch, int* __restrict__ bad, int thin,
                   long long B, int n_steps, uint32_t step0,
                   uint32_t chain_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pad = op.n_pad;
  unsigned char* ytile = smem;   // the 64-row block being drawn
  const uint32_t tsm = (uint32_t)__cvta_generic_to_shared(ytile);
  const uint32_t rsm = tsm + TILE_BYTES;
  float* ct = reinterpret_cast<float*>(smem + TILE_BYTES + RING * PAIR);
  int* accepted = reinterpret_cast<int*>(ct + NC * CT_STRIDE);
  // the block's cs and isg, and the sub-block's triangle of UT
  float* cs_b = reinterpret_cast<float*>(accepted + NC);
  float* isg_b = cs_b + RB;
  const float* tri = isg_b + RB;
  const uint32_t trism = (uint32_t)__cvta_generic_to_shared(tri);
  // WIDE: a byte a 16-row tile, set where the tile holds some |y| > 256
  unsigned char* big = reinterpret_cast<unsigned char*>(smem) +
                       imhk_smem_bytes(n_pad, false);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid >> 1, h = tid & 1;   // chain of the block, half
  const long long chain0 = (long long)blockIdx.x * NC;
  const long long chain = chain0 + cl;
  const bool valid = chain < B;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  float* crow = ct + cl * CT_STRIDE;
  const WideY wide{big, yprop, B, chain0};
  // the block's proposal, (n_pad, 32) bf16 in the tile's layout
  unsigned char* ysc = yscratch + (size_t)blockIdx.x * n_pad * Y_ROW;
  // W 0: this thread's slots of draw_split's store (split_slot)
  int sstride = 0;
  float* slot = nullptr;
  if constexpr (W == 0)
    slot = split_slot(reinterpret_cast<float*>(
                          smem + split_at(imhk_smem_bytes(n_pad, WIDE))),
                      crow, op.window, false, cl, h, sstride);

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
      // the block's cs and isg, and its last sub-block's triangle of UT,
      // while the coupling runs
      cs_b[tid] = __ldg(op.cs + lo + tid);
      isg_b[tid] = __ldg(op.isg + lo + tid);
      tri_fetch(trism, op.UT, n_pad, lo + RB - SB, tid);
      if (lo + RB < n_pad) {
        // the block above (rows lo + 64 .. lo + 127) from the tile into the
        // scratch: thread t stores the chunk t of each 16-row slice
        const int kb = (lo + RB) >> 4;
#pragma unroll
        for (int j = 0; j < RB / SB; ++j)
          *reinterpret_cast<uint4*>(ysc + (size_t)(kb + j) * SLICE +
                                    16 * tid) =
              *reinterpret_cast<const uint4*>(ytile + j * SLICE + 16 * tid);
      }
      // the block's coupling to the rows drawn (rows >= lo + 64) into the
      // coupling tile: warp w takes its rows lo + 32w .. +31
      if constexpr (WIDE)
        couple_ring(op, tsm, rsm, ysc, ct, lo, warp, lane, tid, wide);
      else
        couple_ring(op, tsm, rsm, ysc, ct, lo, warp, lane, tid);
      cp_async_wait<0>();
      __syncthreads();
      for (int sb = RB / SB - 1; sb >= 0; --sb) {
        const int rlo = SB * sb;
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
            const float4* tcol =
                reinterpret_cast<const float4*>(tri + (r - rlo) * SB);
            float4 uq[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int q = (rlo >> 2) + h + 2 * j;
              if (4 * q < r) uq[j] = tcol[h + 2 * j];
            }
            const float c = __fsub_rn(cs_b[r], crow[r]);
            float logz;
            float y;
            if constexpr (W == 0)
              y = draw_split(c, isg_b[r], upair[e], op.window, h, lane, slot,
                             sstride, logz);
            else
              y = draw_pair<W>(c, isg_b[r], upair[e], op.window, h, lane,
                               logz);
            lwp += (double)logz;
            if (h == 0) {
              *reinterpret_cast<unsigned short*>(ytile + y_off(r, cl)) =
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
          // U's fragments of the sub-block's columns, after its draws
          uint4 ad[RB / SB - 1][PARTS];
          load_diag(ad, op.Ufrag, lo, sb, n_pad >> 4, lane);
          __syncthreads();   // the sub-block's rows and centres written
          tri_fetch(trism, op.UT, n_pad, lo + rlo - SB, tid);
          // sub_update addresses the tile by row: its row lo is byte 0
          const uint32_t ysm = tsm - (uint32_t)lo * Y_ROW;
          if constexpr (WIDE)
            sub_update<PASSES>(ad, ysm, ct, lo, sb, warp, lane, wide);
          else
            sub_update<PASSES>(ad, ysm, ct, lo, sb, warp, lane);
          cp_async_wait<0>();
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
    // accepted proposals into x, then the state into the coefficient ring:
    // a warp writes whole rows of the block's 32 chains, rows 0 .. 63 from
    // the tile, the rest from the scratch, eight rows a turn (the swizzle
    // of row i8 + i0 + 2u is u)
    {
      const int cc = tid & (NC - 1), i0 = tid / NC;
      const long long ch = chain0 + cc;
      if (ch < B && accepted[cc] != 0) {
        if constexpr (WIDE) {
          for (int i = i0; i < n_pad; i += TPB / NC) {
            const size_t at = (size_t)i * (size_t)B + (size_t)ch;
            x[at] = yprop[at];
          }
        } else {
          float* xr = x + (size_t)i0 * (size_t)B + (size_t)ch;
          const int lanebits = (cc & 7) << 1;
          for (int i8 = 0; i8 < n_pad; i8 += 8, xr += 8 * (size_t)B) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int off = (i8 + i0 + 2 * u) * Y_ROW +
                              ((((cc >> 3) ^ u) << 4) | lanebits);
              const unsigned short v =
                  i8 < RB ? *reinterpret_cast<const unsigned short*>(ytile +
                                                                     off)
                          : __ldcg(reinterpret_cast<const unsigned short*>(
                                ysc + off));
              xr[(size_t)(2 * u) * (size_t)B] = from_bf16_bits(v);
            }
          }
        }
      }
      if (keep && tx != nullptr && ch < B) {
        for (int i = i0; i < n_pad; i += TPB / NC)
          tx[(k * n_pad + i) * (size_t)B + (size_t)ch] =
              x[(size_t)i * (size_t)B + (size_t)ch];
      }
    }
  }
  if (h == 0 && valid) {
    lw_state[chain] = lw;
    acc[chain] = a_cnt;
    atomicMax(bad + 1, (int)ymax);
  }
}

// A block's shared memory: imhk_smem_bytes, and at W 0 draw_split's store
// for the window (at most 45,920 bytes at n_pad 3,456 and window 1,024:
// below the 48 KB a block may take without opting in)
template <int W, bool WIDE>
size_t kernel_smem(int n_pad, int window) {
  const size_t own = imhk_smem_bytes(n_pad, WIDE);
  return W == 0 ? split_at(own) + split_bytes(window, false) : own;
}

template <int W, bool DBG, bool WIDE>
int launch(const TcOperands& op, const Uniforms& un, float* x, float* lw,
           float* acc, float* tlw, float* tx, float* dbg, float* yprop,
           unsigned char* ysc, int* bad, int thin, long long B, int n_steps,
           uint32_t step, uint32_t chain_offset, cudaStream_t stream) {
  const size_t smem = kernel_smem<W, WIDE>(op.n_pad, op.window);
  const dim3 grid((unsigned)((B + NC - 1) / NC));
  imhk_tc_kernel<W, DBG, WIDE><<<grid, TPB, smem, stream>>>(
      op, un, x, lw, acc, tlw, tx, dbg, yprop, ysc, bad, thin, B, n_steps,
      step, chain_offset);
  return (int)cudaGetLastError();
}

template <bool DBG, bool WIDE = false>
int launch_by_window(const TcOperands& op, const Uniforms& un, float* x,
                     float* lw, float* acc, float* tlw, float* tx,
                     float* dbg, float* yprop, unsigned char* ysc,
                     int* bad, int thin, long long B, int n_steps,
                     uint32_t step, uint32_t chain_offset, cudaStream_t st) {
#define CALL(W)                                                          \
  launch<W, DBG, WIDE>(op, un, x, lw, acc, tlw, tx, dbg, yprop, ysc, bad, \
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
int info(int n_pad, int window, int* out) {
  cudaFuncAttributes fa;
  const auto kernel = imhk_tc_kernel<W, false, WIDE>;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = kernel_smem<W, WIDE>(n_pad, window);
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
// counted into bad[0]); not with dbg. yscratch: the proposals, bf16,
// n_pad * 64 bytes for each block of 32 chains ((B + 31) / 32 blocks),
// written and read by the kernel alone.
int imhk_tc_launch(const void* Ufrag, const float* UT, const float* cs,
                   const float* isg, const float* unif, float* x, float* lw,
                   float* acc, float* tlw, float* tx, float* dbg,
                   float* yprop, void* yscratch, int* bad, int thin,
                   int n_pad, long long B, int window, int n_steps,
                   uint32_t seed_lo, uint32_t seed_hi, uint32_t step,
                   uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_steps <= 0 || thin <= 0 || bad == nullptr || yscratch == nullptr ||
      (tx != nullptr && tlw == nullptr) ||
      (yprop != nullptr && dbg != nullptr))
    return (int)cudaErrorInvalidValue;
  const TcOperands op{static_cast<const uint4*>(Ufrag), UT, cs, isg, n_pad,
                      window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* ysc = static_cast<unsigned char*>(yscratch);
  if (dbg != nullptr)
    return launch_by_window<true>(op, un, x, lw, acc, tlw, tx, dbg, yprop,
                                  ysc, bad, thin, B, n_steps, step,
                                  chain_offset, st);
  if (yprop != nullptr)
    return launch_by_window<false, true>(op, un, x, lw, acc, tlw, tx, dbg,
                                         yprop, ysc, bad, thin, B, n_steps,
                                         step, chain_offset, st);
  return launch_by_window<false>(op, un, x, lw, acc, tlw, tx, dbg, yprop,
                                 ysc, bad, thin, B, n_steps, step,
                                 chain_offset, st);
}

// The kernel's resources (WIDE's when wide is not 0) for a window at
// n_pad: out[0] registers a thread, out[1] local (spill) bytes a thread,
// out[2] dynamic shared memory a block, out[3] blocks per SM, out[4]
// threads a block.
int imhk_tc_info(int n_pad, int window, int wide, int* out) {
  if (wide) {
    switch (window) {
      case 8: return info<8, true>(n_pad, window, out);
      case 16: return info<16, true>(n_pad, window, out);
      case 24: return info<24, true>(n_pad, window, out);
      default: return info<0, true>(n_pad, window, out);
    }
  }
  switch (window) {
    case 8: return info<8, false>(n_pad, window, out);
    case 16: return info<16, false>(n_pad, window, out);
    case 24: return info<24, false>(n_pad, window, out);
    default: return info<0, false>(n_pad, window, out);
  }
}

const char* imhk_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
