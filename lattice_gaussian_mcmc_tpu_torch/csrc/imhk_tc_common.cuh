// Device code shared by the tensor-core Klein sweeps on Hopper (sm_90a):
// fused IMHK and its trajectory (imhk_tc.cu, B2/B3), fused SMK (smk_tc.cu,
// B4), and the Klein draw, its ring and Babai decoding (klein_tc.cu, B1/B6,
// B7).
//
// A thread block of 64 threads owns NC = 32 chains. Their proposal lives
// in shared memory as bf16, (n_pad, 32) chain-minor with the 16-byte chunks
// of a row XOR-swizzled by (row / 2) mod 4 (`y_off`), so that ldmatrix
// reads eight rows without bank conflicts (B2/B3 keep it in device memory
// in the same layout and read it back through a ring, imhk_tc.cu
// `couple_ring`). U = U1 + U2 + U3, three bf16 parts split on the host
// (exact for a float32 U, hazard C2), packed in mma.sync m16n8k16
// A-fragment order (klein_cuda.py `tc_fragments`).
// `couple` forms a 64-row block's coupling to the rows drawn on the tensor
// cores, `sub_update` a 16-row sub-block's coupling to the rows below it in
// the block, and `draw_pair` splits a row's window between the two threads
// of a chain with `draw_row`'s arithmetic bit for bit. The
// PASSES template argument is the number of bf16 parts a product uses (all
// three in the kernels). With a `WideY` (Babai, B7 in klein_tc.cu) both
// products also take y's second and third bf16 parts in the 16-row tiles
// flagged as holding some |y| > 256, read from the float32 rows in device
// memory; the draw kernels pass none and compile without them.

#pragma once

#include "klein_common.cuh"

namespace lgk {

constexpr int NC = 32;              // chains per thread block
constexpr int TPB = 2 * NC;         // two threads per chain
constexpr int CT_STRIDE = 72;       // floats per chain of the coupling tile
constexpr int Y_ROW = 2 * NC;       // bytes per proposal row (bf16)
constexpr int SB = 16;              // rows per sub-block of a 64-row block
constexpr int PARTS = 3;            // bf16 parts of U
constexpr float EXACT_Y = 256.0f;   // |y| exact in bf16
constexpr unsigned FULL = 0xFFFFFFFFu;

struct TcOperands {
  const uint4* Ufrag;  // (n_pad/16, n_pad/16, 3, 32) A fragments
  const float* UT;     // float32 U transposed: the within-block triangle
  const float* cs;
  const float* isg;
  int n_pad;
  int window;
};

// the proposal tile, the coupling tile and one int a chain
__host__ __device__ inline size_t tc_smem_bytes(int n_pad) {
  return (size_t)n_pad * Y_ROW + (size_t)NC * CT_STRIDE * sizeof(float) +
         (size_t)NC * sizeof(int);
}

// byte offset of (row, chain) in the swizzled proposal tile
__device__ __forceinline__ int y_off(int row, int chain) {
  return row * Y_ROW +
         ((((chain >> 3) ^ ((row >> 1) & 3)) << 4) | ((chain & 7) << 1));
}

__device__ __forceinline__ unsigned short to_bf16_bits(float y) {
  return (unsigned short)(__float_as_uint(y) >> 16);  // exact: |y| <= 256
}

// bf16 of a finite float, rounded to nearest even
__device__ __forceinline__ unsigned short to_bf16_rn_bits(float v) {
  const uint32_t b = __float_as_uint(v);
  return (unsigned short)((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float from_bf16_bits(unsigned short v) {
  return __uint_as_float((uint32_t)v << 16);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load_a(uint4 (&a)[2][PARTS],
                                       const uint4* __restrict__ Ufrag,
                                       int mt0, int kt, int KT, int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      a[m][p] = __ldg(Ufrag +
                      (((size_t)(mt0 + m) * KT + kt) * PARTS + p) * 32 +
                      lane);
}

// No wide parts: the draw kernels' products.
struct NoWide {
  static constexpr bool on = false;
  __device__ __forceinline__ bool tile(int) const { return false; }
};

// y beyond bf16's exact range (B7). The tile holds y1 = bf16(y) (round to
// nearest), exact for |y| <= 256. An integer |y| < 2^24 is y1 + y2 + y3
// exactly, y2 = bf16(y - y1), y3 = y - y1 - y2 (each rounding drops the
// eight leading bits of what is left). `big` flags the 16-row tiles with
// some |y| > 256; their y2 and y3 are formed from the float32 rows that the
// block already wrote to y (n_pad, B), read through L2.
struct WideY {
  static constexpr bool on = true;
  const unsigned char* big;   // shared, one byte a 16-row tile
  const float* y;             // (n_pad, B), rows written before a barrier
  long long B;
  long long chain0;           // the block's first chain
  __device__ __forceinline__ bool tile(int k) const { return big[k] != 0; }
};

// B fragments of y2 and y3 of tile k for the n8 tile nt of the block's
// chains: element e of lane l is row 16k + 2(l % 4) + (e & 1) + 8 (e >> 1),
// chain 8 nt + l / 4, as ldmatrix.trans lays out the tile's y1.
__device__ __forceinline__ void wide_frags(const WideY& w, int k, int nt,
                                           int lane, uint32_t (&b2)[2],
                                           uint32_t (&b3)[2]) {
  const long long chain = w.chain0 + 8 * nt + (lane >> 2);
  const bool ok = chain < w.B;
  uint32_t p2[4], p3[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = 16 * k + 2 * (lane & 3) + (e & 1) + ((e >> 1) << 3);
    const float v =
        ok ? __ldcg(w.y + (size_t)row * (size_t)w.B + (size_t)chain) : 0.0f;
    const float r = __fsub_rn(v, from_bf16_bits(to_bf16_rn_bits(v)));
    p2[e] = to_bf16_rn_bits(r);
    p3[e] = to_bf16_rn_bits(__fsub_rn(r, from_bf16_bits(p2[e])));
  }
  b2[0] = p2[0] | (p2[1] << 16);
  b2[1] = p2[2] | (p2[3] << 16);
  b3[0] = p3[0] | (p3[1] << 16);
  b3[1] = p3[2] | (p3[3] << 16);
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
}

// acc = U[rows, k0 ..] Y[k0 .., chains] for the rows lo + 32 warp .. +31
// (two m16 tiles) and all 32 chains (four n8 tiles): k0 = lo + 64, block
// lo's coupling to the rows drawn, or with DIAG k0 = lo, the whole product
// (U y)_i of those rows. U's fragments stream from L2 into a ring of PF
// 16-column steps in registers, each slot refilled PF steps ahead as it is
// consumed (the step count is a multiple of 4). Each pair of steps sums
// into a zeroed partial accumulator, then into acc in IEEE FP32. With a
// WideY, a step whose tile is flagged also multiplies every part of U into
// y2 and y3.
constexpr int PF = 4;
template <int PASSES, bool DIAG = false, class Wide = NoWide>
__device__ void couple(const TcOperands& op, uint32_t ysm,
                       float (&acc)[2][4][4], int lo, int warp, int lane,
                       const Wide& wide = Wide()) {
  const int KT = op.n_pad >> 4;
  const int kt0 = (lo + (DIAG ? 0 : RB)) >> 4, kt1 = KT;
  const int mi = lane >> 3, rin = lane & 7;   // ldmatrix: matrix, its row
  const int mt0 = (lo >> 4) + 2 * warp;
  zero(acc);
  uint4 a[PF][2][PARTS];
#pragma unroll
  for (int j = 0; j < PF; ++j)
    if (kt0 + j < kt1) load_a(a[j], op.Ufrag, mt0, kt0 + j, KT, lane);
  for (int kt = kt0; kt < kt1; kt += PF) {
#pragma unroll
    for (int half = 0; half < PF / 2; ++half) {
      float part[2][4][4];
      zero(part);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j = 2 * half + kk;
        const int k = kt + j;
        uint32_t b[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int row = 16 * k + ((mi & 1) << 3) + rin;
          const int nt = 2 * np + (mi >> 1);
          ldsm_x4_t(ysm + row * Y_ROW + ((nt ^ ((row >> 1) & 3)) << 4),
                    b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                    b[2 * np + 1][1]);
        }
#pragma unroll
        for (int p = PASSES - 1; p >= 0; --p)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              mma_bf16(part[m][n], a[j][m][p], b[n][0], b[n][1]);
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
                  mma_bf16(part[m][n], a[j][m][p], b3[0], b3[1]);
                  mma_bf16(part[m][n], a[j][m][p], b2[0], b2[1]);
                }
            }
          }
        }
        if (k + PF < kt1) load_a(a[j], op.Ufrag, mt0, k + PF, KT, lane);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][n][e] = __fadd_rn(acc[m][n][e], part[m][n][e]);
    }
  }
}

// acc (rows 32 warp .. +31 of the block) into the coupling tile
// ct[chain * CT_STRIDE + row]
__device__ __forceinline__ void store_ct(const float (&acc)[2][4][4],
                                         float* ct, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int r = 32 * warp + 16 * m + g;
      const int c = 8 * n + 2 * t;
      ct[c * CT_STRIDE + r] = acc[m][n][0];
      ct[(c + 1) * CT_STRIDE + r] = acc[m][n][1];
      ct[c * CT_STRIDE + r + 8] = acc[m][n][2];
      ct[(c + 1) * CT_STRIDE + r + 8] = acc[m][n][3];
    }
}

// A fragments of U[lo : lo + 16 sb, lo + 16 sb : +16] (m16 tiles m < sb):
// the columns of sub-block sb in the rows below it.
__device__ __forceinline__ void load_diag(uint4 (&a)[RB / SB - 1][PARTS],
                                          const uint4* __restrict__ Ufrag,
                                          int lo, int sb, int KT, int lane) {
  const int kt = (lo >> 4) + sb;
#pragma unroll
  for (int m = 0; m < RB / SB - 1; ++m)
    if (m < sb) {
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
        a[m][p] = __ldg(Ufrag +
                        (((size_t)((lo >> 4) + m) * KT + kt) * PARTS + p) *
                            32 +
                        lane);
    }
}

// Sub-block sb of block lo is drawn: add its coupling to the rows below it,
// ct[rows 0 .. 16 sb) += U[.., sub-block] Y[sub-block], on the tensor
// cores. Warp w takes chains 16w .. 16w + 15 (two n8 tiles). With a WideY
// and the sub-block's tile flagged, y2 and y3 enter as in `couple`.
template <int PASSES, class Wide = NoWide>
__device__ void sub_update(const uint4 (&a)[RB / SB - 1][PARTS],
                           uint32_t ysm, float* ct, int lo, int sb, int warp,
                           int lane, const Wide& wide = Wide()) {
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, rin = lane & 7;
  const int row = lo + SB * sb + ((mi & 1) << 3) + rin;
  const int nt = 2 * warp + (mi >> 1);
  uint32_t b[2][2];
  ldsm_x4_t(ysm + row * Y_ROW + ((nt ^ ((row >> 1) & 3)) << 4), b[0][0],
            b[0][1], b[1][0], b[1][1]);
  uint32_t b2[2][2], b3[2][2];
  bool wide_tile = false;
  if constexpr (Wide::on) {
    const int kt = (lo >> 4) + sb;
    wide_tile = wide.tile(kt);
    if (wide_tile)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wide_frags(wide, kt, 2 * warp + n, lane, b2[n], b3[n]);
  }
#pragma unroll
  for (int m = 0; m < RB / SB - 1; ++m)
    if (m < sb) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int p = PASSES - 1; p >= 0; --p)
          mma_bf16(d, a[m][p], b[n][0], b[n][1]);
        if constexpr (Wide::on) {
          if (wide_tile)
#pragma unroll
            for (int p = PASSES - 1; p >= 0; --p) {
              mma_bf16(d, a[m][p], b3[n][0], b3[n][1]);
              mma_bf16(d, a[m][p], b2[n][0], b2[n][1]);
            }
        }
        const int r = 16 * m + g;
        float* c0 = ct + (16 * warp + 8 * n + 2 * t) * CT_STRIDE + r;
        float* c1 = c0 + CT_STRIDE;
        c0[0] = __fadd_rn(c0[0], d[0]);
        c1[0] = __fadd_rn(c1[0], d[1]);
        c0[8] = __fadd_rn(c0[8], d[2]);
        c1[8] = __fadd_rn(c1[8], d[3]);
      }
    }
}

// draw_row<W> by the two threads of a chain (h = 0, 1), bit for bit: each
// computes W/2 of the weights, one side's segments (the lower side's in
// walk order, put back in ascending order by a select), the low half's sum
// is shuffled up, and the CDF is the same sequential sum. W == 0:
// draw_row's runtime window, run by both threads alike.
template <int W>
__device__ __forceinline__ float draw_pair(float c, float isg, float u,
                                           int window, int h, int lane,
                                           float& logz) {
  if constexpr (W == 0) {
    return draw_row<0>(c, isg, u, window, logz);
  } else {
    constexpr int H = W / 2;
    const float base = rintf(c);
    const float delta = __fsub_rn(base, c);
    const float a = __fmul_rn(isg, isg);
    const float nad = __fmul_rn(-a, delta);
    const float m = __fmul_rn(__fmul_rn(-0.5f, a), __fmul_rn(delta, delta));
    float wt[H], w[H];
    side_weights(wt, h != 0, nad, a, expf(-a));
#pragma unroll
    for (int j = 0; j < H; ++j) w[j] = h ? wt[j] : wt[H - 1 - j];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < H; ++j) s = __fadd_rn(s, w[j]);
    const float low = __shfl_xor_sync(FULL, s, 1);
    float run = h ? low : 0.0f;
    float cdf[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      run = __fadd_rn(run, w[j]);
      cdf[j] = run;
    }
    const float total = __shfl_sync(FULL, run, lane | 1);
    const float target = __fmul_rn(u, total);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < H; ++j) cnt += cdf[j] < target ? 1 : 0;
    const int idx = min(cnt + __shfl_xor_sync(FULL, cnt, 1), W - 1);
    logz = __fadd_rn(m, logf(total));
    return __fadd_rn(base, (float)(idx - H));
  }
}

}  // namespace lgk
