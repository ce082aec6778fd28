// Peikert's convolution sampler (B5) on Hopper (sm_90a): per round a
// triangular product on the tensor cores in split precision (3xTF32), with
// the independent draws in its epilogue, written to a ring in device
// memory.
//
// Replaces the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/peikert_pallas.py `_peikert_kernel`
// (peikert_sample_batch_pallas and peikert_rounds_pallas, B5). The law is
// the same; the TPU layout devices (CDF as a matrix product, 8-row groups,
// the DMA to the ring) are not carried over, nor is the Pallas kernel's
// two-part bf16 split of the product, which puts the centres 7.9e-3 r off
// float64 at the Peikert row's operands (hazard C9).
//
// What it computes, per chain and round k:
//   z     = n_pad standard normals: host rows, or Box-Muller from Philox
//           (counter (chain id, pair p, round k, TAG_NORMAL), words 0 and 1:
//           u1 = 1 - U(word 0) in (0, 1], u2 = U(word 1),
//           z_2p = sqrt(-2 log u1) cos(2 pi u2), z_2p+1 = ... sin(2 pi u2))
//   c_i   = c'_i - sum_{j<=i} L2_ij z_j
//   x_i   ~ D_{Z, r, c_i} on a window of W integers around rint(c_i), by
//           the inverse CDF (klein_common.cuh `draw_row`, rintf, C3),
//           uniform of counter (chain id, row i, round k, TAG_ROW) or host
//           row k n_pad + i
// and x goes to rows k n_pad .. of the ring. n_pad is a multiple of 64, so
// the normals come in whole pairs and never run past the end (hazard C1).
//
// Bound (n = 1024, W = 24, 65,536 chains x 8 rounds): the product is
// n(n+1) FLOP a chain and round, three TF32 passes at 495 TFLOP/s: 3.34 ms;
// the draws n W exps plus Box-Muller's four special functions a pair,
// 3.3 ms at 16 a clock per SM; the ring, 2 GB written once, 0.64 ms at
// 3.35 TB/s.
//
// Design. Once a round's z is known every row is an independent draw: the
// kernel is C = L2 Z, lower triangular (n_pad x n_pad) times (n_pad x
// chains), then an elementwise sampling pass.
// - A block of 16 warps owns NCP chains of one round (grid: chain blocks x
//   rounds). It makes their normals once into shared memory, (n_pad, NCP)
//   float32, each row's chains XOR-swizzled so that the B-fragment reads
//   are free of bank conflicts (`z_idx`). No normal goes to device memory.
//   NCP = 32 up to n_pad 1,792 (128 n_pad bytes, 128 KB at n_pad 1024);
//   above, NCP = 16 (64 n_pad bytes), which the 227 KB of a block bound
//   at n_pad 3,584 (peikert_cuda.py `peikert_block_chains`, chosen before
//   the launch, and PEIKERT_TC_MAX_N_PAD). That covers every n_pad that
//   B2-B4 reach (3,456), and dimension 2048 (NTRU-1024) at 16 chains.
// - Each warp takes 16-row tiles of C, in a zigzag over the warps so that
//   the triangle's work is even, and runs the K loop up to the tile's
//   diagonal only: mma.sync m16n8k8 .tf32 over four n8 tiles (the 32
//   chains). L2 comes packed in A-fragment order (one 16-byte load a lane
//   and k-step, from L2 cache); both operands are split in registers,
//   x = hi + lo with hi = x truncated to TF32 and lo = x - hi truncated in
//   turn (`split`, three integer and float operations), and
//   C = hi.hi + (hi.lo + lo.hi): 3xTF32, within 6.7e-4 r of float64 on
//   the Peikert row's operands (ROADMAP C9). hi.hi and the two cross terms
//   accumulate apart over two k-steps, then add into the tile's sum in
//   IEEE FP32, so the tensor cores' own rounding acts on short sums only.
// - The epilogue: a finished tile's 16 rows x 32 chains are complete and
//   independent; each lane draws its 16 entries with draw_row's arithmetic
//   and writes them to the ring, 32-byte runs of chains.
// - No block synchronisation after the normals: the warps run their tiles
//   independently.

#include "klein_common.cuh"

using namespace lgk;

namespace {

constexpr int WARPS = 16;
constexpr int PTPB = 32 * WARPS;
constexpr float kTwoPi = 6.28318530717958647692f;

// the normals tile of NCP chains (32 or 16 a block)
inline size_t smem_bytes(int n_pad, int ncp) {
  return (size_t)n_pad * ncp * sizeof(float);
}

// index of (row, chain) in the swizzled normals tile: a warp's B-fragment
// read takes rows 8k + t (t < 4) and chains 8n + g (g < 8); the 32 banks
// are the chains of one row (NCP = 32), swizzled by 8 (row mod 4), or of
// two rows (NCP = 16), swizzled by 8 ((row / 2) mod 2)
template <int NCP>
__device__ __forceinline__ int z_idx(int row, int chain) {
  constexpr int SHIFT = NCP == 32 ? 0 : 1;
  return row * NCP + (chain ^ (((row >> SHIFT) & (NCP / 8 - 1)) << 3));
}

// TF32's sign, exponent and 10 mantissa bits
constexpr uint32_t KEEP = 0xFFFFE000u;

// x = hi + lo: hi is x truncated to TF32, lo = x - hi (exact in float32)
// truncated to TF32 in turn
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & KEEP;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & KEEP;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a tile: A fragments of L2[16 mt .., 8 kt ..] (a float4 a
// lane), B fragments of z[8 kt .., chains] from the shared tile, NT n8
// tiles of chains.
template <int NCP, int NT = NCP / 8>
__device__ __forceinline__ void kstep(const float4* __restrict__ Afrag,
                                      const float* zs, int mt, int kt,
                                      int KT, int lane, float (&dm)[NT][4],
                                      float (&dc)[NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  const float4 av = __ldg(Afrag + ((size_t)mt * KT + kt) * 32 + lane);
  uint32_t ahi[4], alo[4];
  split(av.x, ahi[0], alo[0]);
  split(av.y, ahi[1], alo[1]);
  split(av.z, ahi[2], alo[2]);
  split(av.w, ahi[3], alo[3]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t bh[2], bl[2];
    split(zs[z_idx<NCP>(8 * kt + t, 8 * n + g)], bh[0], bl[0]);
    split(zs[z_idx<NCP>(8 * kt + t + 4, 8 * n + g)], bh[1], bl[1]);
    mma_tf32(dm[n], ahi, bh[0], bh[1]);
    mma_tf32(dc[n], ahi, bl[0], bl[1]);
    mma_tf32(dc[n], alo, bh[0], bh[1]);
  }
}

// DBG: round 0 also writes each row's centre c_i to dbg[i, chain]. NCP
// chains a block.
template <int W, bool DBG, int NCP>
__global__ void __launch_bounds__(PTPB, 1)
    peikert_tc_kernel(const float4* __restrict__ Afrag,
                      const float* __restrict__ cp, float isg, int window,
                      Uniforms un, const float* __restrict__ zin,
                      float* __restrict__ ring, float* __restrict__ dbg,
                      int n_pad, long long B, uint32_t chain_offset) {
  extern __shared__ __align__(16) float zs[];
  constexpr int NT = NCP / 8;         // n8 tiles of chains
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rnd = blockIdx.y;
  const long long chain0 = (long long)blockIdx.x * NCP;

  // the round's normals of the block's chains (a warp writes whole rows)
  {
    const int cc = tid & (NCP - 1);
    const long long ch = chain0 + cc;
    const bool valid = ch < B;
    if (zin != nullptr) {
      for (int r = tid / NCP; r < n_pad; r += PTPB / NCP)
        zs[z_idx<NCP>(r, cc)] =
            valid ? zin[((size_t)rnd * n_pad + r) * (size_t)B + (size_t)ch]
                  : 0.0f;
    } else {
      const uint32_t chain_id = chain_offset + (uint32_t)ch;
      for (int p = tid / NCP; p < n_pad / 2; p += PTPB / NCP) {
        float z0 = 0.0f, z1 = 0.0f;
        if (valid) {
          const uint4 w = philox4(chain_id, (uint32_t)p, (uint32_t)rnd,
                                  TAG_NORMAL, un.k0, un.k1);
          const float u1 = __fsub_rn(1.0f, mantissa_uniform(w.x));
          const float u2 = mantissa_uniform(w.y);
          const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
          const float ang = __fmul_rn(kTwoPi, u2);
          z0 = __fmul_rn(rad, cosf(ang));
          z1 = __fmul_rn(rad, sinf(ang));
        }
        zs[z_idx<NCP>(2 * p, cc)] = z0;
        zs[z_idx<NCP>(2 * p + 1, cc)] = z1;
      }
    }
  }
  __syncthreads();

  const int KT = n_pad >> 3, MT = n_pad >> 4;
  const int g = lane >> 2, t = lane & 3;
  for (int base = 0; base < MT; base += 2 * WARPS) {
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      const int mt = side ? base + 2 * WARPS - 1 - warp : base + warp;
      if (mt >= MT) continue;
      // C[16 mt .. +15, chains] = L2[rows, 0 .. 16 mt + 15] z
      float tot[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[n][e] = 0.0f;
      const int kend = 2 * mt + 2;
      for (int kt = 0; kt < kend; kt += 2) {
        float dm[NT][4], dc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dm[n][e] = dc[n][e] = 0.0f;
        kstep<NCP>(Afrag, zs, mt, kt, KT, lane, dm, dc);
        kstep<NCP>(Afrag, zs, mt, kt + 1, KT, lane, dm, dc);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tot[n][e] = __fadd_rn(tot[n][e], __fadd_rn(dm[n][e], dc[n][e]));
      }
      // the epilogue: the tile's 16 rows x NCP chains, independent draws
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * mt + g + 8 * (e >> 1);
        const float cpi = __ldg(cp + i);
        const long long row = (long long)rnd * n_pad + i;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int cc = 8 * n + 2 * t + (e & 1);
          const long long ch = chain0 + cc;
          if (ch >= B) continue;
          const float c = __fsub_rn(cpi, tot[n][e]);
          const float u = un.get(row, ch, chain_offset + (uint32_t)ch,
                                 (uint32_t)i, (uint32_t)rnd, TAG_ROW);
          float logz;
          const size_t at = (size_t)row * (size_t)B + (size_t)ch;
          ring[at] = draw_row<W>(c, isg, u, window, logz);
          if constexpr (DBG) {
            if (rnd == 0) dbg[at] = c;
          }
        }
      }
    }
  }
}

template <int W, bool DBG, int NCP>
int launch(const float4* Afrag, const float* cp, float isg, int window,
           const Uniforms& un, const float* zin, float* ring, float* dbg,
           int n_pad, long long B, int n_rounds, uint32_t chain_offset,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(n_pad, NCP);
  cudaError_t e = cudaFuncSetAttribute(
      peikert_tc_kernel<W, DBG, NCP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + NCP - 1) / NCP), (unsigned)n_rounds);
  peikert_tc_kernel<W, DBG, NCP><<<grid, PTPB, smem, stream>>>(
      Afrag, cp, isg, window, un, zin, ring, dbg, n_pad, B, chain_offset);
  return (int)cudaGetLastError();
}

template <bool DBG, int NCP>
int launch_by_window(const float4* Afrag, const float* cp, float isg,
                     int window, const Uniforms& un, const float* zin,
                     float* ring, float* dbg, int n_pad, long long B,
                     int n_rounds, uint32_t chain_offset, cudaStream_t st) {
#define CALL(W)                                                            \
  launch<W, DBG, NCP>(Afrag, cp, isg, window, un, zin, ring, dbg, n_pad, \
                      B, n_rounds, chain_offset, st)
  switch (window) {
    case 8: return CALL(8);
    case 16: return CALL(16);
    case 24: return CALL(24);
    default: return CALL(0);
  }
#undef CALL
}

template <bool DBG>
int launch_by_shape(int ncp, const float4* Afrag, const float* cp, float isg,
                    int window, const Uniforms& un, const float* zin,
                    float* ring, float* dbg, int n_pad, long long B,
                    int n_rounds, uint32_t chain_offset, cudaStream_t st) {
  if (ncp == 32)
    return launch_by_window<DBG, 32>(Afrag, cp, isg, window, un, zin, ring,
                                     dbg, n_pad, B, n_rounds, chain_offset,
                                     st);
  return launch_by_window<DBG, 16>(Afrag, cp, isg, window, un, zin, ring,
                                   dbg, n_pad, B, n_rounds, chain_offset, st);
}

}  // namespace

extern "C" {

// B5: n_rounds Peikert draws per chain into ring (n_rounds * n_pad, B).
// Afrag: L2 (n_pad, n_pad, lower triangular) in m16n8k8 A-fragment order,
// (n_pad/16, n_pad/8, 32) float4; cp: (n_pad,) coefficient-space centre;
// isg = 1 / r. Host randomness (both or neither): unif and zin
// (n_rounds * n_pad, B); otherwise Philox keyed by (seed_lo, seed_hi).
// dbg: null, or (n_pad, B) for round 0's centres. chains: chains a block,
// 32 or 16, the one whose normals tile (4 chains n_pad bytes) fits a
// block's shared memory (peikert_cuda.py `peikert_block_chains`).
int peikert_tc_launch(const void* Afrag, const float* cp, float isg,
                      const float* unif, const float* zin, float* ring,
                      float* dbg, int n_pad, long long B, int window,
                      int n_rounds, int chains, uint32_t seed_lo,
                      uint32_t seed_hi, uint32_t chain_offset,
                      void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_rounds <= 0 || (chains != 32 && chains != 16) ||
      (unif == nullptr) != (zin == nullptr))
    return (int)cudaErrorInvalidValue;
  const Uniforms un{unif, B, seed_lo, seed_hi};
  const float4* A = static_cast<const float4*>(Afrag);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dbg != nullptr)
    return launch_by_shape<true>(chains, A, cp, isg, window, un, zin, ring,
                                 dbg, n_pad, B, n_rounds, chain_offset, st);
  return launch_by_shape<false>(chains, A, cp, isg, window, un, zin, ring,
                                dbg, n_pad, B, n_rounds, chain_offset, st);
}

const char* peikert_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
