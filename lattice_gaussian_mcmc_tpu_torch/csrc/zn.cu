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
//
// Bound: 4 bytes written a draw (67M draws at the benchmark suite's
// 65,536 x 1024: 0.08 ms at 3.35 TB/s), and the generator's integer work,
// a quarter of a Philox4x32-10 call a draw (its instructions counted from
// the SASS of `zn_philox_probe` against `zn_store_probe`, zn_cuda.py
// `philox_instructions`) at the card's INT32 rate. The lookup and the CDF
// are small beside either.
//
// Design.
// - A grid of as many blocks as fit the card at once (a few an SM), each
//   looping over groups of four draws (grid stride). Each block builds the
//   window's CDF once into shared memory: warp 0 forms the logits, their
//   maximum and the exps a lane an entry, and lane 0 the sequential prefix
//   sum (zn_cuda.py `zn_cdf`, bit for bit).
// - Group j is draws 4j .. 4j + 3: one Philox call, counter (j lo, j hi,
//   0, TAG_ZN), word w for draw 4j + w, so no word is discarded and draw i
//   does not depend on num (a prefix of a longer run is the same draws).
//   Host uniforms are read in the flat draw order instead.
// - Lookup: a branch-free binary search of the CDF padded with +inf to a
//   power of two P >= W, idx += s if cdf[idx + s - 1] < target for
//   s = P/2 .. 1, which is the count #{k : cdf_k < target}. Windows up to
//   64 (the suite's 40 and 48) compile P = 64, six steps; wider windows up
//   to 1,024 take the same loop at run time. The four draws of a thread
//   search side by side. A count over the CDF in registers would take W
//   compares a draw (~2W instructions) against the search's ~18.
// - Each thread writes its four draws as one 16-byte store (a scalar
//   store each in a final group of fewer than four).

#include "klein_common.cuh"

using namespace lgk;

namespace {

constexpr int ZN_THREADS = 256;
constexpr int ZN_PER = 4;           // draws a group: one Philox call
constexpr int ZN_COMPILED_P = 64;   // padded CDF of windows up to 64

__device__ __forceinline__ float zn_logit(int k, int half, float base,
                                          float c, float isg) {
  const float support = __fadd_rn(base, (float)(k - half));
  const float z = __fmul_rn(__fsub_rn(support, c), isg);
  return __fmul_rn(__fmul_rn(-0.5f, z), z);
}

// #{k < P : cdf_k < target} for a non-decreasing cdf padded with +inf
template <int P>
__device__ __forceinline__ int zn_search(const float* cdf, float target,
                                         int pad) {
  const int p = P > 0 ? P : pad;
  int idx = 0;
#pragma unroll
  for (int s = p >> 1; s > 0; s >>= 1)
    idx += cdf[idx + s - 1] < target ? s : 0;
  return idx;
}

template <int P>
__global__ void __launch_bounds__(ZN_THREADS)
    zn_kernel(float c, float isg, int window, int pad,
              const float* __restrict__ unif, float* __restrict__ out,
              long long num, uint32_t k0, uint32_t k1) {
  extern __shared__ float cdf[];
  const float base = rintf(c);
  const int half = window / 2;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = -__int_as_float(0x7f800000);   // -inf
    for (int k = lane; k < window; k += 32)
      m = fmaxf(m, zn_logit(k, half, base, c, isg));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    for (int k = lane; k < window; k += 32)
      cdf[k] = expf(__fsub_rn(zn_logit(k, half, base, c, isg), m));
    for (int k = window + lane; k < pad; k += 32)
      cdf[k] = __int_as_float(0x7f800000);   // +inf
    __syncwarp();
    if (lane == 0) {
      float run = 0.0f;
      for (int k = 0; k < window; ++k) {
        run = __fadd_rn(run, cdf[k]);
        cdf[k] = run;
      }
    }
  }
  __syncthreads();
  const float total = cdf[window - 1];
  const long long groups = (num + ZN_PER - 1) / ZN_PER;
  const long long stride = (long long)gridDim.x * ZN_THREADS;
  for (long long j = (long long)blockIdx.x * ZN_THREADS + threadIdx.x;
       j < groups; j += stride) {
    const long long first = j * ZN_PER;
    float u[ZN_PER];
    if (unif != nullptr) {
#pragma unroll
      for (int w = 0; w < ZN_PER; ++w)
        u[w] = first + w < num ? unif[first + w] : 0.0f;
    } else {
      const uint4 r = philox4((uint32_t)j,
                              (uint32_t)((unsigned long long)j >> 32), 0u,
                              TAG_ZN, k0, k1);
      u[0] = mantissa_uniform(r.x);
      u[1] = mantissa_uniform(r.y);
      u[2] = mantissa_uniform(r.z);
      u[3] = mantissa_uniform(r.w);
    }
    float z[ZN_PER];
#pragma unroll
    for (int w = 0; w < ZN_PER; ++w) {
      const int idx = zn_search<P>(cdf, __fmul_rn(u[w], total), pad);
      z[w] = __fadd_rn(base, (float)(min(idx, window - 1) - half));
    }
    if (first + ZN_PER <= num) {
      *reinterpret_cast<float4*>(out + first) =
          make_float4(z[0], z[1], z[2], z[3]);
    } else {
#pragma unroll
      for (int w = 0; w < ZN_PER; ++w)
        if (first + w < num) out[first + w] = z[w];
    }
  }
}

template <int P>
int launch(float c, float isg, int window, int pad, const float* unif,
           float* out, long long num, uint32_t k0, uint32_t k1,
           cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = (size_t)pad * sizeof(float);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, zn_kernel<P>, ZN_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (num + ZN_PER - 1) / ZN_PER;
  const long long need = (groups + ZN_THREADS - 1) / ZN_THREADS;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const dim3 grid((unsigned)(need < fit ? need : fit));
  zn_kernel<P><<<grid, ZN_THREADS, smem, stream>>>(c, isg, window, pad, unif,
                                                   out, num, k0, k1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B8: num i.i.d. draws of D_{Z, sigma, c} into out (num,), 16-byte
// aligned. isg = 1 / sigma in float32; unif (num,) or null for Philox.
int zn_draw_launch(float c, float isg, int window, const float* unif,
                   float* out, long long num, uint32_t seed_lo,
                   uint32_t seed_hi, void* stream) {
  if (num <= 0 || window <= 0 || window > 1024 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (window <= ZN_COMPILED_P)
    return launch<ZN_COMPILED_P>(c, isg, window, ZN_COMPILED_P, unif, out,
                                 num, seed_lo, seed_hi, st);
  int pad = 1;
  while (pad < window) pad <<= 1;
  return launch<0>(c, isg, window, pad, unif, out, num, seed_lo, seed_hi,
                   st);
}

// For counting a Philox call's instructions in the SASS (cuobjdump): the
// call of zn_kernel on a thread's group index, its four words stored, and
// the same index arithmetic and store without the call.
__global__ void zn_philox_probe(uint4* out, long long j0, uint32_t k0,
                                uint32_t k1) {
  const long long j = j0 + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  out[j - j0] = philox4((uint32_t)j, (uint32_t)((unsigned long long)j >> 32),
                        0u, TAG_ZN, k0, k1);
}

__global__ void zn_store_probe(uint4* out, long long j0, uint32_t k0,
                               uint32_t k1) {
  const long long j = j0 + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  out[j - j0] = make_uint4((uint32_t)j ^ k0,
                           (uint32_t)((unsigned long long)j >> 32) ^ k1, 0u,
                           TAG_ZN);
}

const char* zn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
