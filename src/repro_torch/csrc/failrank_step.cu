// One fused dense FailRank step over the MCG:
//
//   s'[v]   = (1 - lam) * s0[v] + lam * sum_u W[u,v] * s[u]
//   L'[u,v] = alpha * W[u,v] + beta * s[u] + gamma * L[u,v]
//
// Replaces the TPU kernel src/repro/kernels/failrank_step/kernel.py
// (failrank_step, body _kernel): both outputs from one read of W.
//
// What bounds it on this card: bytes.  It reads W and L and writes L' once,
// 3 * n^2 * 4 B (811 KB at n = 260, about 0.24 us at 3.35 TB/s), against
// 5 * n^2 floating-point operations.  At the main path's sizes (n = 68 or
// 260) that is under a microsecond, so launch latency dominates.
//
// What the design does about it: one thread per column v (128-thread
// blocks), s staged once in shared memory, and a loop over rows u in order,
// so each row's reads of W and L and write of L' are coalesced along v and
// W is read once for both outputs.  The sum over u runs in a fixed order,
// so the result is the same from run to run.  Build with -fmad=false: L'
// then equals the plain torch version bit for bit.

#include <cuda_runtime.h>

#define NT 128

__global__ void __launch_bounds__(NT) failrank_step_kernel(
    const float* __restrict__ w, const float* __restrict__ l,
    const float* __restrict__ s, const float* __restrict__ s0,
    float* __restrict__ s_out, float* __restrict__ l_out, int n,
    float one_minus_lam, float lam, float alpha, float beta, float gamma) {
  extern __shared__ float s_sh[];
  for (int u = threadIdx.x; u < n; u += NT) s_sh[u] = s[u];
  __syncthreads();
  const int v = blockIdx.x * NT + threadIdx.x;
  if (v >= n) return;
  float acc = 0.0f;
  for (int u = 0; u < n; ++u) {
    const size_t at = (size_t)u * n + v;
    const float wuv = w[at], su = s_sh[u];
    acc = acc + wuv * su;
    l_out[at] = alpha * wuv + beta * su + gamma * l[at];
  }
  s_out[v] = one_minus_lam * s0[v] + lam * acc;
}

extern "C" {

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  All pointers are device memory, row-major [n, n] for
// w, l and l_out.
int failrank_step(const float* w, const float* l, const float* s,
                  const float* s0, float* s_out, float* l_out, int n,
                  float one_minus_lam, float lam, float alpha, float beta,
                  float gamma, void* stream) {
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        failrank_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  failrank_step_kernel<<<(n + NT - 1) / NT, NT, smem, (cudaStream_t)stream>>>(
      w, l, s, s0, s_out, l_out, n, one_minus_lam, lam, alpha, beta, gamma);
  return (int)cudaGetLastError();
}

}  // extern "C"
