// The FALCON signer's own kernels (samplers/sign.py) on Hopper (sm_90a):
// hash-to-point, the targets c (M, n) of M messages, uniform on Z_q^n, from
// the port's Philox stream in place of SHAKE-256 (Falcon spec v1.2,
// Algorithm 3, whose output the spec takes as uniform); and the uniforms of
// a redraw round, those of the failing messages alone.
//
// What it computes: coefficient j of message m is output word j mod 4 of
// Philox4x32-10 counter (m, j / 4, 0, TAG_HASH) under the key (seed mod
// 2^32, seed >> 32), reduced mod q. The reduction keeps the bias of 2^32
// mod q (q = 12289: residues below 2^32 mod q = 10,952 are drawn
// 1 + 2.9e-6 times as often as the rest).
// lattice_gaussian_mcmc_tpu_torch/ops/kernels/sign_cuda.py
// `hash_to_point_plain` is the same function in PyTorch.
//
// Bound: one Philox call and four int64 stores a thread; at 65,536
// messages of n = 512 that is 268 MB written, 0.08 ms at 3.35 TB/s.
//
// Redraw uniforms: entry (i, b) of u (n_rows, F) is the midpoint uniform
// (k + 1/2) 2^-23 of Philox counter (ids[b], i, step, TAG_ROW), the one
// centred B1 (klein_tc.cu) draws in-kernel for row i of chain ids[b] at
// that step. One launch in place of the plain version's few dozen
// element-wise ones, which leave the card idle behind the host in a round
// of a handful of messages.

#include "klein_common.cuh"

using namespace lgk;

namespace {

constexpr uint32_t TAG_HASH = 6;
constexpr int HASH_THREADS = 256;

// One thread a group of four coefficients (m, p): coefficients 4p .. 4p + 3
// of message m, those below n
__global__ void __launch_bounds__(HASH_THREADS)
    hash_to_point_kernel(long long* __restrict__ c, long long M, int n,
                         uint32_t q, uint32_t k0, uint32_t k1) {
  const int groups = (n + 3) / 4;
  const long long g =
      (long long)blockIdx.x * HASH_THREADS + (long long)threadIdx.x;
  if (g >= M * groups) return;
  const long long m = g / groups;
  const int p = (int)(g - m * groups);
  const uint4 w = philox4((uint32_t)m, (uint32_t)p, 0u, TAG_HASH, k0, k1);
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
  long long* row = c + (size_t)m * (size_t)n;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * p + k;
    if (j < n) row[j] = (long long)(word[k] % q);
  }
}

// One thread an entry (i, b) of u (n_rows, F), row-major
__global__ void __launch_bounds__(HASH_THREADS)
    redraw_uniforms_kernel(float* __restrict__ u,
                           const long long* __restrict__ ids, long long F,
                           int n_rows, uint32_t step, uint32_t k0,
                           uint32_t k1) {
  const long long g =
      (long long)blockIdx.x * HASH_THREADS + (long long)threadIdx.x;
  if (g >= F * n_rows) return;
  const long long i = g / F;
  const uint32_t id = (uint32_t)ids[g - i * F];
  u[g] = midpoint_uniform(philox4(id, (uint32_t)i, step, TAG_ROW, k0, k1).x);
}

}  // namespace

extern "C" {

// The targets c (M, n) int64, row-major, of messages 0 .. M-1 under the
// seed (seed_lo, seed_hi).
int hash_to_point_launch(long long* c, long long M, int n, uint32_t q,
                         uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (c == nullptr || M <= 0 || n <= 0 || q < 2)
    return (int)cudaErrorInvalidValue;
  const long long threads = M * (long long)((n + 3) / 4);
  const dim3 grid((unsigned)((threads + HASH_THREADS - 1) / HASH_THREADS));
  hash_to_point_kernel<<<grid, HASH_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      c, M, n, q, seed_lo, seed_hi);
  return (int)cudaGetLastError();
}

// The uniforms u (n_rows, F) float32 of rows 0 .. n_rows-1 of the chains
// ids (F,) int64 at Philox step `step` under the seed (seed_lo, seed_hi).
int redraw_uniforms_launch(float* u, const long long* ids, long long F,
                           int n_rows, uint32_t step, uint32_t seed_lo,
                           uint32_t seed_hi, void* stream) {
  if (u == nullptr || ids == nullptr || F <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = F * (long long)n_rows;
  const dim3 grid((unsigned)((threads + HASH_THREADS - 1) / HASH_THREADS));
  redraw_uniforms_kernel<<<grid, HASH_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      u, ids, F, n_rows, step, seed_lo, seed_hi);
  return (int)cudaGetLastError();
}

const char* sign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
