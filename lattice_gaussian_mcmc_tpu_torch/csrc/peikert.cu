// Peikert's convolution sampler on Hopper (sm_90a), one thread per chain,
// n_rounds independent draws per launch written to a ring in device memory.
//
// Replaces the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/peikert_pallas.py `_peikert_kernel`
// (peikert_sample_batch_pallas and peikert_rounds_pallas, B5). The law is
// the same; the TPU layout devices (bf16 split of L2 and z into three MXU
// dots, CDF as a matrix product, 8-row groups, the DMA to the ring) are not
// carried over.
//
// What it computes, per chain and round k:
//   z     = n_pad standard normals: host rows, or Box-Muller from Philox
//           (counter (chain id, pair p, round k, TAG_NORMAL), words 0 and 1:
//           u1 = 1 - U(word 0) in (0, 1], u2 = U(word 1),
//           z_2p = sqrt(-2 log u1) cos(2 pi u2), z_2p+1 = ... sin(2 pi u2))
//   c_i   = c'_i - sum_{j<=i} L2_ij z_j         (FP32 FMA on the CUDA cores)
//   x_i   ~ D_{Z, r, c_i} on a window of W integers around rint(c_i), by
//           the inverse CDF (klein_common.cuh `draw_row`), uniform of
//           counter (chain id, row i, round k, TAG_ROW) or host row
//           k n_pad + i
// and x goes to rows k n_pad .. of the ring. n_pad is even (a multiple of
// 64), so the normals come in whole pairs and never run past the end (the
// Pallas kernel's Box-Muller writes two 8-row blocks at a time and overruns
// when its padded n is 8 mod 16).
//
// Design. L2 is lower triangular, so the product is B1's coupling pass with
// the triangle on the other side: for the 64-row block [lo, lo+64) one pass
// over rows j < lo+64 of z (read once from device memory, coalesced across
// the warp) into 64 register accumulators, with the column L2[lo.., j]
// (contiguous in L2T) read as warp-uniform float4 loads; the zeros above
// the diagonal add exactly 0. The 64 products go to the thread's column of
// a 32 KB shared tile, and the rows of the block are then independent
// draws. Normals are generated into a chain-minor (n_pad, B) scratch once
// per round.
//
// Bound (n = 1024, W = 24): per round and chain n^2/2 = 5.2e5 FMAs and
// n W exps; at 65,536 chains and 8 rounds ~5.6e11 FLOP against 67 TFLOP/s
// of FP32 (8 ms). Memory: the ring (2 GB at that size) written once, the
// normals written and read back once per row block. Right and simple
// first: no attempt at either roof.

#include "klein_common.cuh"

using namespace lgk;

namespace {

constexpr float kTwoPi = 6.28318530717958647692f;

template <int W>
__global__ void __launch_bounds__(THREADS)
    peikert_kernel(const float* __restrict__ L2T, const float* __restrict__ cp,
                   float isg, int window, Uniforms un,
                   const float* __restrict__ zin, float* __restrict__ z,
                   float* __restrict__ ring, int n_pad, long long B,
                   int n_rounds, uint32_t chain_offset) {
  const long long chain = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (chain >= B) return;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  // the thread's column of a 64 x 128 shared tile holds a block's products
  extern __shared__ float tile[];
  float* col = tile + threadIdx.x;
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const float* zr;
    if (zin != nullptr) {
      zr = zin + (size_t)rnd * n_pad * (size_t)B;
    } else {
      for (int p = 0; p < n_pad / 2; ++p) {
        const uint4 w = philox4(chain_id, (uint32_t)p, (uint32_t)rnd,
                                TAG_NORMAL, un.k0, un.k1);
        const float u1 = __fsub_rn(1.0f, mantissa_uniform(w.x));
        const float u2 = mantissa_uniform(w.y);
        const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
        const float ang = __fmul_rn(kTwoPi, u2);
        z[(size_t)(2 * p) * (size_t)B + (size_t)chain] =
            __fmul_rn(rad, cosf(ang));
        z[(size_t)(2 * p + 1) * (size_t)B + (size_t)chain] =
            __fmul_rn(rad, sinf(ang));
      }
      zr = z;
    }
    for (int lo = 0; lo < n_pad; lo += RB) {
      const int hi = lo + RB;
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
      for (int j = 0; j < hi; ++j) {
        const float zj = zr[(size_t)j * (size_t)B + (size_t)chain];
        const float4* l4 =
            reinterpret_cast<const float4*>(L2T + (size_t)j * n_pad + lo);
#pragma unroll
        for (int q = 0; q < RB / 4; ++q) {
          const float4 l = __ldg(l4 + q);
          acc[4 * q + 0] = fmaf(l.x, zj, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(l.y, zj, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(l.z, zj, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(l.w, zj, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) col[r * THREADS] = acc[r];
      for (int r = 0; r < RB; ++r) {
        const int i = lo + r;
        const long long row = (long long)rnd * n_pad + i;
        const float c = __fsub_rn(__ldg(cp + i), col[r * THREADS]);
        const float u = un.get(row, chain, chain_id, (uint32_t)i,
                               (uint32_t)rnd, TAG_ROW);
        float logz;
        ring[(size_t)row * (size_t)B + (size_t)chain] =
            draw_row<W>(c, isg, u, window, logz);
      }
    }
  }
}

template <int W>
int launch_peikert(const float* L2T, const float* cp, float isg, int window,
                   const Uniforms& un, const float* zin, float* z,
                   float* ring, int n_pad, long long B, int n_rounds,
                   uint32_t chain_offset, cudaStream_t stream) {
  peikert_kernel<W><<<grid_for(B), THREADS, kSmem, stream>>>(
      L2T, cp, isg, window, un, zin, z, ring, n_pad, B, n_rounds,
      chain_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B5: n_rounds Peikert draws per chain into ring (n_rounds * n_pad, B).
// L2T: (n_pad, n_pad) transposed lower-triangular factor; cp: (n_pad,)
// coefficient-space centre; isg = 1 / r. Host randomness (both or neither):
// unif and zin (n_rounds * n_pad, B); otherwise z (n_pad, B) is the
// normals' scratch and Philox is keyed by (seed_lo, seed_hi).
int peikert_rounds_launch(const float* L2T, const float* cp, float isg,
                          const float* unif, const float* zin, float* z,
                          float* ring, int n_pad, long long B, int window,
                          int n_rounds, uint32_t seed_lo, uint32_t seed_hi,
                          uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_rounds <= 0 || (unif == nullptr) != (zin == nullptr) ||
      (zin == nullptr && z == nullptr))
    return (int)cudaErrorInvalidValue;
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(W)                                                           \
  launch_peikert<W>(L2T, cp, isg, window, un, zin, z, ring, n_pad, B, \
                    n_rounds, chain_offset, st)
  KLEIN_BY_WINDOW(window, CALL)
#undef CALL
}

const char* peikert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
