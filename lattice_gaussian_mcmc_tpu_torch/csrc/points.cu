// Lattice points from integer coefficients on Hopper (sm_90a): P = x B^T,
// exact, on the int8 tensor cores, in place of the float64 DGEMM (and the
// cast of float32 coefficients to float64 before it) that ends every
// sampler of the port.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (lattice_gaussian_mcmc_tpu/samplers/klein.py `klein_points`). It exists
// because both operands are small integers, so 8-bit integer products
// compute it exactly at 1,979 TOPS where the DGEMM runs at 67 TFLOP/s.
//
// What it computes: P (M, N) float64, row-major, P[r, i] = sum_k x[r, k]
// B[i, k], for coefficients x (M, N) float32 or float64 read in place
// through their strides (rows or columns contiguous) and the basis B (N, N)
// integer-valued with |B| < 2^15, given as its int8 limbs in mma fragment
// order (ops/kernels/points_cuda.py `points_operands`, made once at
// set-up): B = sum_b l_b 256^b, lower limbs unsigned, the top limb signed.
//
// Limbs of x, a tile at a time. A tile is 64 rows x 32 columns of x. Its
// values are converted to int32 and split into their two's-complement
// bytes; the tile takes the fewest bytes that hold its largest |x|: one
// for -128 .. 127, two up to 2^15, three up to 2^23, four for int32. Its
// lower bytes enter the products unsigned, its top byte signed, so the
// limbs sum to x exactly. A tile holding a value that is not an integer,
// not finite or outside int32 is out of reach: the block writes NaN over
// its 64 rows of P and counts the tile. The decision is the block's, on
// the device: no host read.
//
// Products. mma.sync m16n8k32 (s8 or u8 by u8 or s8, int32 sums) for each
// pair of limbs (a, b); the pair's sum goes to the accumulator of shift
// a + b. Every int32 sum is below 2^31: at most two pairs share a shift
// (B has at most two limbs), each product is at most 255 * 255 and N is at
// most 16,384 (the wrapper's MAX_DIM). The shifts are combined in int64 in
// the epilogue, P = sum_s acc_s 256^s, and converted to float64 once. For
// integer inputs whose products and partial sums stay below 2^53 this is
// the float64 DGEMM's result bit for bit; beyond, it is the exact sum
// correctly rounded.
//
// Bound (65,536 x 1,024 x 1,024, two limbs of x, one of B): reading x,
// 268 MB of float32, and writing P, 537 MB, take 0.24 ms at 3.35 TB/s;
// the two limb pairs' 2.8e14 int8 operations 0.14 ms at 1,979 TOPS. What
// bounds it in practice is the traffic through L2: besides x and P, each
// panel of 64 rows reads all of B's limbs once, 1 GB at that shape.
//
// Design. A persistent grid: one block of 16 warps an SM, each walking the
// panels of 64 rows of x (blockIdx.x, + gridDim.x, ...) and computing every
// column of P for them, so that it reads and converts its rows of x once
// (with fewer panels than SMs, as in a redraw round of a few messages,
// blocks share a panel's columns).
// - Conversion. The warps take the panel's tiles in turn, read x along its
//   contiguous stride (16-byte loads where the layout allows), check and
//   convert each value, and pack each row's 4 bytes of a limb into a word
//   (byte_perm), stored into limb planes in shared memory, k-word-major
//   with rows padded to 72 words so that the fragment reads are free of
//   bank conflicts. A warp reduces its tile's largest |x| and writes the
//   tile's limb count beside the planes.
// - Products. After one barrier each warp runs on its own: for each group
//   of 256 columns it owns 16 and all 64 rows (4 x 2 mma tiles a limb
//   pair, two shift accumulators), reads the A fragments from the planes
//   and B's through a ring of 8 stages (4 with two limbs) in shared memory,
//   each lane copying its own 16 bytes a tile and limb by cp.async. The
//   epilogue writes the warp's 64 x 16 block of P and the warp starts the
//   next group.
// - Room. The planes take 147,456 bytes: two limbs of 1,024 columns (one
//   of 2,048); the rings 64 KB. A panel whose tiles need more limbs than
//   the planes hold at once, or a wider x, runs again for the next limbs
//   or columns, its partial sums kept in P's memory as int64 between
//   passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 64;               // rows of x a block
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int WC = 16;               // columns of P a warp: two mma tiles
constexpr int NTW = WC / 8;
constexpr int CG = WC * WARPS;       // columns of P a group
constexpr int RS = BM + 8;           // words a k-word row of a limb plane
constexpr int CAP_KW = 512;          // k-words the planes hold, all limbs
constexpr int MAXB = 2;              // limbs of the basis
constexpr int MAX_TILES = CAP_KW / 8;
constexpr int RING_KB = 4;           // a warp's ring of B's fragments, KB
constexpr size_t PLANE_BYTES = (size_t)CAP_KW * RS * 4;
constexpr size_t SMEM =
    PLANE_BYTES + MAX_TILES + (size_t)WARPS * RING_KB * 1024;

struct Args {
  const void* x;
  long long sr, sk;          // strides of x in elements: rows, columns
  const uint4* bw;           // B's limbs in fragment order (points_cuda.py)
  double* out;               // (M, N) row-major
  unsigned long long* stats; // tiles of x by limbs 1..4, tiles out of reach
  long long M;
  int N, KC, nb, vec;        // KC: tiles of 32 columns; vec: 16-byte loads
  int splits;                // blocks that share a panel's column groups
};

__device__ __forceinline__ int to_int(float v, bool& ok) {
  const int i = __float2int_rn(v);
  ok = (float)i == v && v < 2147483648.0f;
  return i;
}

__device__ __forceinline__ int to_int(double v, bool& ok) {
  const int i = __double2int_rn(v);
  ok = (double)i == v;
  return i;
}

// x[row, k], 0 outside x
template <typename T>
__device__ __forceinline__ T load_x(const Args& a, const T* x, long long row,
                                    int k) {
  return (row < a.M && k < a.N) ? __ldg(x + row * a.sr + (long long)k * a.sk)
                                : (T)0;
}

// The four values x[row, k .. k + 3]: one or two 16-byte loads along a
// row (vec), else four element loads
template <typename T>
__device__ __forceinline__ void load_quad(const Args& a, const T* x,
                                          long long row, int k, T (&v)[4]) {
  if (a.vec) {
    if (row < a.M && k < a.N) {
      const T* p = x + row * a.sr + k;
      if constexpr (sizeof(T) == 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
        const double2 d0 = __ldg(reinterpret_cast<const double2*>(p));
        const double2 d1 = __ldg(reinterpret_cast<const double2*>(p) + 1);
        v[0] = d0.x; v[1] = d0.y; v[2] = d1.x; v[3] = d1.y;
      }
    } else {
      v[0] = v[1] = v[2] = v[3] = (T)0;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = load_x(a, x, row, k + j);
}

// The row and k-word of the i-th of a lane's 16 words of a tile, for
// element and row-wise 16-byte loads: lanes along the rows where rows are
// contiguous (COL), else 8 lanes along a row's 32 values, so that each
// load instruction reads whole lines
template <bool COL>
__device__ __forceinline__ void word_at(int lane, int i, int& r, int& kw) {
  if constexpr (COL) {
    r = lane + 32 * (i >> 3);
    kw = i & 7;
  } else {
    r = (lane >> 3) + 4 * i;
    kw = lane & 7;
  }
}

// A lane's running largest |x| (two's complement) and whether every value
// was in reach
struct Reach {
  uint32_t mag = 0;
  bool ok = true;
};

// Convert x[r, 4 kw .. 4 kw + 3] of tile c (values v) and store their
// bytes a0 .. a0 + P - 1 as words of planes 0 .. P - 1
template <typename T>
__device__ __forceinline__ void put(Reach& rc, uint32_t* planes, int seg_kw,
                                    int P, uint32_t sel, int c, int r, int kw,
                                    const T (&v)[4]) {
  int iv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bool ok;
    iv[j] = to_int(v[j], ok);
    rc.ok &= ok;
    rc.mag = max(rc.mag, (uint32_t)(iv[j] ^ (iv[j] >> 31)));
  }
  uint32_t* w = planes + (8 * c + kw) * RS + r;
  for (int p = 0; p < P; ++p) {
    const uint32_t s = sel + 0x11u * (uint32_t)p;
    w[p * seg_kw * RS] = __byte_perm(__byte_perm(iv[0], iv[1], s),
                                     __byte_perm(iv[2], iv[3], s), 0x5410u);
  }
}

// Convert tile c of the segment (columns 32 (t0 + c) ..) into planes
// 0 .. P - 1 (bytes a0 .. a0 + P - 1 of every value); returns the tile's
// limb count (0: out of reach), the same in every lane. A lane loads a
// batch of its values before it converts them.
template <typename T, bool COL>
__device__ __forceinline__ int convert_tile(const Args& a, uint32_t* planes,
                                            int seg_kw, long long m0, int t0,
                                            int c, int a0, int P, int lane) {
  const T* x = static_cast<const T*>(a.x);
  const int k0 = 32 * (t0 + c);
  const uint32_t sel = (uint32_t)a0 | ((uint32_t)(a0 + 4) << 4);
  Reach rc;
  if (COL && a.vec) {
    // E rows a 16-byte load: 64 / E lanes cover a k-word's rows, each lane
    // 4 (float) or 8 (double) k-words, 2 at a time
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int LPK = BM / E, STEP = 32 / LPK, NKW = 8 / STEP;
    const int r0 = E * (lane % LPK), kwb = lane / LPK;
    const bool in = m0 + r0 < a.M;
#pragma unroll
    for (int i0 = 0; i0 < NKW; i0 += 2) {
      T vals[2][4][E];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + 4 * (kwb + STEP * (i0 + i)) + j;
          const T* p = x + (long long)k * a.sk + m0 + r0;
          if constexpr (E == 4) {
            const float4 f = (in && k < a.N)
                                 ? __ldg(reinterpret_cast<const float4*>(p))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            vals[i][j][0] = f.x; vals[i][j][1] = f.y;
            vals[i][j][2] = f.z; vals[i][j][3] = f.w;
          } else {
            const double2 d = (in && k < a.N)
                                  ? __ldg(reinterpret_cast<const double2*>(p))
                                  : make_double2(0.0, 0.0);
            vals[i][j][0] = d.x; vals[i][j][1] = d.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T v[4] = {vals[i][0][e], vals[i][1][e], vals[i][2][e],
                          vals[i][3][e]};
          put(rc, planes, seg_kw, P, sel, c, r0 + e, kwb + STEP * (i0 + i),
              v);
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      T v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int r, kw;
        word_at<COL>(lane, 4 * q + i, r, kw);
        load_quad(a, x, m0 + r, k0 + 4 * kw, v[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int r, kw;
        word_at<COL>(lane, 4 * q + i, r, kw);
        put(rc, planes, seg_kw, P, sel, c, r, kw, v[i]);
      }
    }
  }
  const uint32_t mag = __reduce_max_sync(0xffffffffu, rc.mag);
  if (!__all_sync(0xffffffffu, rc.ok)) return 0;
  return mag < 128u ? 1 : mag < 32768u ? 2 : mag < 8388608u ? 3 : 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool AS, bool BS>
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
#define LGM_MMA(TA, TB)                                                     \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "  \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "             \
               "{%0, %1, %2, %3};\n"                                        \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (AS && BS) LGM_MMA("s8", "s8");
  else if constexpr (AS) LGM_MMA("s8", "u8");
  else if constexpr (BS) LGM_MMA("u8", "s8");
  else LGM_MMA("u8", "u8");
#undef LGM_MMA
}

// acc += (limb plane A, one tile) x (B's limb fragments bf) for the warp's
// 64 rows x 16 columns
template <bool AS, bool BS>
__device__ __forceinline__ void tile(int (&acc)[4][NTW][4], const uint32_t* A,
                                     const uint4& bf, int g, int t) {
  const uint32_t b[4] = {bf.x, bf.y, bf.z, bf.w};
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r = mt * 16 + g;
    const uint32_t af[4] = {A[t * RS + r], A[t * RS + r + 8],
                            A[(4 + t) * RS + r], A[(4 + t) * RS + r + 8]};
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      mma_s8<AS, BS>(acc[mt][nt], af, b[2 * nt], b[2 * nt + 1]);
  }
}

__device__ __forceinline__ void pair(int (&acc)[4][NTW][4], const uint32_t* A,
                                     const uint4& bf, bool as, bool bs,
                                     int g, int t) {
  if (as) {
    if (bs) tile<true, true>(acc, A, bf, g, t);
    else tile<true, false>(acc, A, bf, g, t);
  } else {
    if (bs) tile<false, true>(acc, A, bf, g, t);
    else tile<false, false>(acc, A, bf, g, t);
  }
}

// Start copying B's fragments of tile c, every limb, for the warp's 16
// columns into stage st of the lane's ring (16 bytes a lane and limb)
template <int NB>
__device__ __forceinline__ void ring_fetch(const Args& a, uint4* ring,
                                           int col16, int c, int st,
                                           int lane) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
    cp_async16(ring + (st * NB + b) * 32 + lane,
               a.bw + (((size_t)col16 * a.KC + c) * NB + b) * 32 + lane);
}

template <typename T, bool COL, int NB>
__global__ void __launch_bounds__(THREADS, 1) points_s8_kernel(const Args a) {
  // stages of a lane's ring of B's fragments
  constexpr int STAGES = RING_KB * 1024 / (NB * 32 * 16);
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  unsigned char* tile_limbs = smem + PLANE_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint4* ring = reinterpret_cast<uint4*>(smem + PLANE_BYTES + MAX_TILES) +
                (size_t)warp * (RING_KB * 1024 / 16);
  const int g = lane >> 2, t = lane & 3;
  const int kw_all = 8 * a.KC;
  // limbs a pass (P) and k-words a segment: two limbs of a one-limb basis
  // where they fit, else one
  const int P = (NB == 1 && 2 * kw_all <= CAP_KW) ? 2 : 1;
  const int seg_kw = min(kw_all, CAP_KW / P);
  const int nseg = (kw_all + seg_kw - 1) / seg_kw;
  const int ngroups_n = (a.N + CG - 1) / CG;
  const long long panels = (a.M + BM - 1) / BM;

  // work items: (panel, column groups js, js + splits, ...)
  const long long items = panels * a.splits;
  uint32_t tiles[5] = {0, 0, 0, 0, 0};  // thread 0's counts
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long pnl = item / a.splits;
    const int js = (int)(item - pnl * a.splits);
    const long long m0 = pnl * BM;
    int la_max = 1, groups = 1;
    bool bad = false;
    for (int grp = 0; grp < groups; ++grp) {
      const int a0 = grp * P;
      for (int s = 0; s < nseg; ++s) {
        const int t0 = s * (seg_kw / 8);
        const int nt = min(seg_kw, kw_all - s * seg_kw) / 8;
        __syncthreads();  // the last pass's products are done with the planes
        for (int c = warp; c < nt; c += WARPS) {
          const int la = convert_tile<T, COL>(a, planes, seg_kw, m0, t0, c,
                                              a0, P, lane);
          if (lane == 0) tile_limbs[c] = (unsigned char)la;
        }
        __syncthreads();
        if (grp == 0) {
          for (int c = 0; c < nt; ++c) {
            const int la = tile_limbs[c];
            la_max = max(la_max, la);
            bad |= la == 0;
            if (tid == 0 && js == 0) {
#pragma unroll
              for (int i = 0; i < 5; ++i) tiles[i] += (la ? la - 1 : 4) == i;
            }
          }
          if (s == nseg - 1) groups = (la_max + P - 1) / P;
        }
        const bool first = grp == 0 && s == 0;
        const bool last = grp == groups - 1 && s == nseg - 1;

        for (int j = js; j < ngroups_n; j += a.splits) {
          const int col16 = j * WARPS + warp;
          if (WC * col16 >= a.N) continue;
          int acc0[4][NTW][4], acc1[4][NTW][4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int n = 0; n < NTW; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc0[mt][n][e] = acc1[mt][n][e] = 0;
          for (int c = 0; c < STAGES - 1; ++c) {
            if (c < nt) ring_fetch<NB>(a, ring, col16, t0 + c, c, lane);
            cp_async_commit();
          }
          for (int c = 0; c < nt; ++c) {
            const int f = c + STAGES - 1;
            if (f < nt)
              ring_fetch<NB>(a, ring, col16, t0 + f, f % STAGES, lane);
            cp_async_commit();
            cp_async_wait<STAGES - 1>();
            const int la = tile_limbs[c];
            const uint4* st = ring + (c % STAGES) * NB * 32 + lane;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const uint4 bf = st[b * 32];
              const bool bs = b == NB - 1;
              const int x0 = a0 - b, x1 = a0 + 1 - b;  // x limbs of both shifts
              if (x0 >= a0 && x0 < a0 + P && x0 < la)
                pair(acc0, planes + ((x0 - a0) * seg_kw + 8 * c) * RS, bf,
                     x0 == la - 1, bs, g, t);
              if (x1 >= a0 && x1 < a0 + P && x1 < la)
                pair(acc1, planes + ((x1 - a0) * seg_kw + 8 * c) * RS, bf,
                     x1 == la - 1, bs, g, t);
            }
          }
          // epilogue: rows g, g + 8 and columns 2t, 2t + 1 of each mma tile
          const long long w0 = 1LL << (8 * a0), w1 = 1LL << (8 * a0 + 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
              const int col = WC * col16 + 8 * n + 2 * t;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const long long row = m0 + mt * 16 + g + 8 * h;
                if (row >= a.M || col >= a.N) continue;
                double* o = a.out + row * a.N + col;
                long long* oi = reinterpret_cast<long long*>(o);
                const bool two = col + 1 < a.N;
                long long v0 = (long long)acc0[mt][n][2 * h] * w0 +
                               (long long)acc1[mt][n][2 * h] * w1;
                long long v1 = (long long)acc0[mt][n][2 * h + 1] * w0 +
                               (long long)acc1[mt][n][2 * h + 1] * w1;
                if (!first) {
                  v0 += oi[0];
                  if (two) v1 += oi[1];
                }
                if (last) {
                  const double nan =
                      __longlong_as_double(0x7ff8000000000000LL);
                  const double d0 = bad ? nan : (double)v0;
                  const double d1 = bad ? nan : (double)v1;
                  if (two && (a.N & 1) == 0) {
                    *reinterpret_cast<double2*>(o) = make_double2(d0, d1);
                  } else {
                    o[0] = d0;
                    if (two) o[1] = d1;
                  }
                } else {
                  oi[0] = v0;
                  if (two) oi[1] = v1;
                }
              }
            }
          }
        }
      }
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (tiles[i]) atomicAdd(a.stats + i, (unsigned long long)tiles[i]);
  }
}

template <typename T, bool COL, int NB>
int launch_nb(Args a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      points_s8_kernel<T, COL, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // one block an SM, each walking the work items blockIdx.x, + gridDim.x,
  // ...; with fewer panels than SMs, a panel's column groups are split
  // among blocks
  const long long panels = (a.M + BM - 1) / BM;
  const int groups = (a.N + CG - 1) / CG;
  a.splits = panels >= sms ? 1 : (int)std::min<long long>(groups,
                                                          sms / panels);
  const long long items = panels * a.splits;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  points_s8_kernel<T, COL, NB><<<blocks, THREADS, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool COL>
int launch(const Args& a, cudaStream_t st) {
  return a.nb == 1 ? launch_nb<T, COL, 1>(a, st) : launch_nb<T, COL, 2>(a, st);
}

}  // namespace

extern "C" {

// P (M, N) float64 row-major = x B^T. x: (M, N) float32 (elem_bytes 4) or
// float64 (8), element (r, k) at x[r sr + k sk]; col = 1 when rows are
// contiguous (sr = 1), else 0 (sk = 1); vec = 1 when col = 0 and x's rows
// split into whole, aligned 16-byte loads, else 0 (element loads). words:
// B's nb limbs in fragment order (points_cuda.py `points_operands`).
// stats: (5,) counters, added to.
int points_launch(const void* x, int elem_bytes, int col, long long sr,
                  long long sk, long long M, int N, int vec,
                  const void* words, int nb, double* out, void* stats,
                  void* stream) {
  if (x == nullptr || words == nullptr || out == nullptr ||
      stats == nullptr || M <= 0 || N <= 0 || N > 16384 || nb < 1 ||
      nb > MAXB || (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.sr = sr;
  a.sk = sk;
  a.bw = static_cast<const uint4*>(words);
  a.out = out;
  a.stats = static_cast<unsigned long long*>(stats);
  a.M = M;
  a.N = N;
  a.KC = (N + 31) / 32;
  a.nb = nb;
  a.vec = vec;
  a.splits = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return col ? launch<float, true>(a, st) : launch<float, false>(a, st);
  return col ? launch<double, true>(a, st) : launch<double, false>(a, st);
}

const char* points_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
