// I.i.d. draws of D_{Z, sigma, c} on Hopper (sm_90a): B8.
//
// Replaces the Pallas TPU kernel
// lattice_gaussian_mcmc_tpu/ops/kernels/zn_pallas.py `_kernel`
// (sample_zn_pallas), the direct sampler of Z^n. The law is the same; the
// TPU devices (CDF as a bf16-split triangular matrix product, (rows, tile)
// programs, num a multiple of 262,144) are not carried over.
//
// What it computes. One window of W integers around base = rint(c) (half to
// even): support_k = base + k - W/2, z_k = (support_k - c) * isg with
// isg = 1 / sigma rounded to float32, logit_k = (-0.5 z_k) z_k, weights
// w_k = exp(logit_k - max logit), the CDF as a sequential float32 prefix
// sum, total = cdf_{W-1}. Each draw: target = u total,
// idx = #{k : cdf_k < target} clipped to W - 1, out = base + idx - W/2.
// The CDF is non-decreasing, so a binary search for the first cdf_k >=
// target gives the Pallas kernel's compare-and-sum count.
//
// Design. Thread 0 of each block builds the CDF once into shared memory
// (W floats); then each of the 256 threads makes 16 draws at indices
// block * 4096 + r * 256 + t, so every store of a warp is one coalesced
// line. Any num is allowed. The logit and CDF arithmetic uses explicitly
// rounded operations so that the plain PyTorch version repeats it.
//
// Bound: 4 bytes written per draw (67M draws at the benchmark suite's
// 65,536 x 1024: 0.08 ms at 3.35 TB/s) plus W exps per block; the binary
// search and Philox are integer work. So it is bound by bytes, if anything.
//
// Randomness: host uniforms in the flat draw order, or Philox4x32-10 with
// counter (draw index low word, draw index high word, 0, TAG_ZN) and key
// (seed lo, seed hi), output word 0, mantissa-trick uniform in [0, 1) — the
// function of lattice_gaussian_mcmc_tpu_torch/utils/prng.py. The draw index
// is 64-bit, split over two counter words, so it does not wrap.

#include "klein_common.cuh"

using namespace lgk;

namespace {

constexpr int ZN_THREADS = 256;
constexpr int ZN_PER_THREAD = 16;

__device__ __forceinline__ float zn_logit(int k, int half, float base,
                                          float c, float isg) {
  const float support = __fadd_rn(base, (float)(k - half));
  const float z = __fmul_rn(__fsub_rn(support, c), isg);
  return __fmul_rn(__fmul_rn(-0.5f, z), z);
}

__global__ void __launch_bounds__(ZN_THREADS)
    zn_kernel(float c, float isg, int window, const float* __restrict__ unif,
              float* __restrict__ out, long long num, uint32_t k0,
              uint32_t k1) {
  extern __shared__ float cdf[];
  const float base = rintf(c);
  const int half = window / 2;
  if (threadIdx.x == 0) {
    float m = -__int_as_float(0x7f800000);   // -inf
    for (int k = 0; k < window; ++k)
      m = fmaxf(m, zn_logit(k, half, base, c, isg));
    float run = 0.0f;
    for (int k = 0; k < window; ++k) {
      run = __fadd_rn(run, expf(__fsub_rn(zn_logit(k, half, base, c, isg),
                                          m)));
      cdf[k] = run;
    }
  }
  __syncthreads();
  const float total = cdf[window - 1];
  const long long first =
      (long long)blockIdx.x * (ZN_THREADS * ZN_PER_THREAD) + threadIdx.x;
  for (int r = 0; r < ZN_PER_THREAD; ++r) {
    const long long idx = first + (long long)r * ZN_THREADS;
    if (idx >= num) break;
    const float u =
        unif != nullptr
            ? unif[idx]
            : mantissa_uniform(philox4((uint32_t)idx,
                                       (uint32_t)((unsigned long long)idx >>
                                                  32),
                                       0u, TAG_ZN, k0, k1)
                                   .x);
    const float target = __fmul_rn(u, total);
    int lo = 0, hi = window;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] < target) lo = mid + 1;
      else hi = mid;
    }
    out[idx] = __fadd_rn(base, (float)(min(lo, window - 1) - half));
  }
}

}  // namespace

extern "C" {

// B8: num i.i.d. draws of D_{Z, sigma, c} into out (num,). isg = 1 / sigma
// in float32; unif (num,) or null for Philox.
int zn_draw_launch(float c, float isg, int window, const float* unif,
                   float* out, long long num, uint32_t seed_lo,
                   uint32_t seed_hi, void* stream) {
  if (num <= 0 || window <= 0 || window > 1024)
    return (int)cudaErrorInvalidValue;
  const long long per_block = ZN_THREADS * ZN_PER_THREAD;
  const dim3 grid((unsigned)((num + per_block - 1) / per_block));
  zn_kernel<<<grid, ZN_THREADS, (size_t)window * sizeof(float),
              static_cast<cudaStream_t>(stream)>>>(
      c, isg, window, unif, out, num, seed_lo, seed_hi);
  return (int)cudaGetLastError();
}

const char* zn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
