// Klein draw and its ring and batched Babai decoding on Hopper (sm_90a), one
// thread per chain (or target), the coupling in FP32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/klein_pallas.py `_kernel` in its
// draw mode (klein_sample_batch_pallas, B1) and its ring mode
// (klein_sample_ring_pallas, B6), and the inner kernel of
// babai_decode_batch_pallas (B7), each above n_pad 3,456. Up to n_pad
// 3,456 B1, B6 and B7 run on the tensor-core sweep of klein_tc.cu, whose
// draw tile bounds n_pad; this FP32 sweep has no such bound (klein_cuda.py
// `klein_route`). Its
// fused Metropolis-Hastings and trajectory modes (B2, B3) are imhk_tc.cu.
// The law is the same; the TPU layout devices (bf16 split of U, CDF as a
// triangular matrix product, (8, 128) row groups, the 8-row DMA staging of
// the rings) are not carried over.
//
// What it computes, per chain, for rows i = n_pad-1 down to 0:
//   c_i   = cs_i - sum_{j>i} U_ij y_j          (FP32 FMA on the CUDA cores)
//   base  = rint(c_i) (half to even), delta = base - c_i, a = isg_i^2
//   w_k   = exp(-a (off_k^2 / 2 + delta off_k)), off_k in [-W/2, W/2 - 1]
//   idx   = #{k : cdf_k < u total} clipped to W-1, cdf a sequential sum
//   y_i   = base + idx - W/2,  log Z_i = -a delta^2 / 2 + log(total)
// and lw = sum_i log Z_i accumulated in double.
//
// Ring mode (B6) is the draw kernel run n_rounds times per chain: round r
// uses Philox step `step + r` (host uniform rows r n_pad ..) and writes its
// draw straight into rows r n_pad .. of the output ring and its lw into
// row r of the lw ring. B1 is the same kernel with one round, so round 0
// of a ring is a B1 draw on the same uniforms, bit for bit. B1 takes the
// instantiation with one compile-time round (RING = false): with the
// runtime round count the draw at the flagship shapes took 101-103 ms
// instead of 85 (tools/ab_klein.py, NVIDIA H100 80GB HBM3, 700 W).
//
// Babai mode (B7) is the same backward substitution with rintf (half to
// even, as torch.round) in place of the draw: y_i = rint(ct_i - sum_{j>i}
// U_ij y_j) per target, on recentred centres ct (the wrapper removes
// k = rint(ct) in float64 first). No uniforms, no lw; exact in its
// operands for any |y| < 2^24. bad[0] counts the coefficients with
// |y| > 256 and bad[1] keeps the largest |y|, as klein_tc.cu's B7 does.
// Bound (n = 1024): n(n-1) FLOP of coupling per target, ~1 ms for 65,536
// targets at 67 TFLOP/s; the centres in and the coefficients out are 0.5 GB,
// 0.16 ms at 3.35 TB/s.
//
// Design. The state is chain-minor (n_pad, B): thread t of a block owns
// chain blockIdx.x * 128 + t, so every row access of a warp is one
// coalesced 128-byte line and no two threads touch the same chain (each
// block owns disjoint chains; there is no inter-thread sharing at all). A
// chain writes its own ring entries, coalesced across the warp; there is
// nothing to stage. Rows go in 64-row blocks (klein_common.cuh `propose`).
// For a block [lo, lo+64) the coupling to the already drawn rows
// j >= lo+64 is one pass over those rows: y_j is read once from device
// memory and multiplied into 64 register accumulators by a column of U
// (contiguous in UT, read as uniform float4 loads that every thread of the
// warp shares). The 64 partial centres, and then the 64 draws, live in the
// thread's own column of a 64 x 128 float shared-memory tile (32 KB per
// block), so the within-block coupling reads shared memory.
//
// Bound (n = 1024, W = 16): per proposal per chain about n^2/2 = 5.2e5 FMAs
// of coupling (1.05e6 FLOP) plus n W = 16,384 exps; at 524,288 chains that
// is ~5.5e11 FLOP per draw against 67 TFLOP/s of FP32 on the CUDA
// cores (8.2 ms). Device-memory traffic per draw: the draw is written once
// and each 64-row block re-reads the rows below it (~30 KB per chain,
// ~16 GB): about 5 ms at 3.35 TB/s. So the kernel sits near the balance
// point of both; this version aims to be right and simple, not at either
// roof.
//
// Randomness: host uniforms (tests and kernel-vs-plain checks) or
// Philox4x32-10 with counter (chain id, row, step, tag) and key (seed lo,
// seed hi), output word 0, mantissa-trick uniform in [0, 1) — the function
// of lattice_gaussian_mcmc_tpu_torch/utils/prng.py, bit for bit. No curand.

#include "klein_common.cuh"

using namespace lgk;

namespace {

// n_rounds Klein draws per chain: round r into rows r n_pad .. of y
// (n_rounds n_pad, B) and its lw into lw_out[r, chain] (B1: RING = false,
// one round).
template <int W, bool RING>
__global__ void __launch_bounds__(THREADS)
    klein_draw_kernel(Operands op, Uniforms un, float* __restrict__ y,
                      float* __restrict__ lw_out, long long B, int n_rounds,
                      uint32_t step, uint32_t chain_offset) {
  extern __shared__ float tile[];
  const long long chain = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (chain >= B) return;
  const uint32_t chain_id = chain_offset + (uint32_t)chain;
  const size_t round_size = (size_t)op.n_pad * (size_t)B;
  const int rounds = RING ? n_rounds : 1;
  for (int r = 0; r < rounds; ++r) {
    const uint32_t step_r = step + (uint32_t)r;
    const double lw =
        propose<W>(op, y + (size_t)r * round_size, B, chain, chain_id,
                   tile + threadIdx.x, un, (long long)r * op.n_pad, step_r);
    lw_out[(size_t)r * (size_t)B + (size_t)chain] = (float)lw;
  }
}

// B7: Babai nearest plane per target on recentred centres ct (n_pad, B),
// coefficients (recentred) into y (n_pad, B).
__global__ void __launch_bounds__(THREADS)
    babai_kernel(const float* __restrict__ U, const float* __restrict__ UT,
                 const float* __restrict__ ct, float* __restrict__ y,
                 int* __restrict__ bad, int n_pad, long long B) {
  extern __shared__ float tile[];
  const long long chain = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (chain >= B) return;
  float* col = tile + threadIdx.x;
  float ymax = 0.0f;
  int n_big = 0;
  for (int lo = n_pad - RB; lo >= 0; lo -= RB) {
    cross_block(UT, n_pad, lo, y, B, chain, col);
    for (int r = RB - 1; r >= 0; --r) {
      const int i = lo + r;
      const size_t at = (size_t)i * (size_t)B + (size_t)chain;
      const float c = row_centre(ct[at], U + (size_t)i * n_pad + lo, col, r);
      const float yi = rintf(c);
      col[r * THREADS] = yi;
      y[at] = yi;
      ymax = fmaxf(ymax, fabsf(yi));
      n_big += fabsf(yi) > 256.0f ? 1 : 0;
    }
  }
  if (n_big) atomicAdd(bad, n_big);
  atomicMax(bad + 1, (int)ymax);
}

template <int W>
int launch_draw(const Operands& op, const Uniforms& un, float* y, float* lw,
                long long B, int n_rounds, uint32_t step,
                uint32_t chain_offset, cudaStream_t stream) {
  if (n_rounds == 1)
    klein_draw_kernel<W, false><<<grid_for(B), THREADS, kSmem, stream>>>(
        op, un, y, lw, B, 1, step, chain_offset);
  else
    klein_draw_kernel<W, true><<<grid_for(B), THREADS, kSmem, stream>>>(
        op, un, y, lw, B, n_rounds, step, chain_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B6 (and B1, n_rounds 1): n_rounds Klein draws per chain into the ring y
// (n_rounds n_pad, B) and the lw ring (n_rounds, B). unif: (n_rounds
// n_pad, B) or null for Philox (round r at step + r).
int klein_ring_launch(const float* U, const float* UT, const float* cs,
                      const float* isg, const float* unif, float* y,
                      float* lw, int n_pad, long long B, int window,
                      int n_rounds, uint32_t seed_lo, uint32_t seed_hi,
                      uint32_t step, uint32_t chain_offset, void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || window <= 0 ||
      n_rounds <= 0)
    return (int)cudaErrorInvalidValue;
  const Operands op{U, UT, cs, isg, n_pad, window};
  const Uniforms un{unif, B, seed_lo, seed_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(W) \
  launch_draw<W>(op, un, y, lw, B, n_rounds, step, chain_offset, st)
  KLEIN_BY_WINDOW(window, CALL)
#undef CALL
}

// B7 above n_pad 3,456: Babai nearest plane for B targets; ct (n_pad, B)
// recentred centres, y (n_pad, B) out; bad as for klein_tc.cu's
// babai_tc_launch.
int babai_decode_launch(const float* U, const float* UT, const float* ct,
                        float* y, int* bad, int n_pad, long long B,
                        void* stream) {
  if (n_pad <= 0 || n_pad % RB != 0 || B <= 0 || bad == nullptr)
    return (int)cudaErrorInvalidValue;
  babai_kernel<<<grid_for(B), THREADS, kSmem,
                 static_cast<cudaStream_t>(stream)>>>(U, UT, ct, y, bad,
                                                      n_pad, B);
  return (int)cudaGetLastError();
}

const char* klein_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
