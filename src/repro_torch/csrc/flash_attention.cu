// Blocked online-softmax attention in f32, over explicit positions, with
// grouped-query heads read in place.
//
//   out[b,i,h,:] = sum_j softmax_j(q[b,i,h,:] . k[b,j,hk,:] / sqrt(D)) v[b,j,hk,:]
//   over the keys j with k_pos[j] >= 0 (-1 marks an empty cache slot),
//   k_pos[j] <= q_pos[i] when causal, k_pos[j] > q_pos[i] - window when
//   window > 0; hk = h / (Hq / Hkv).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _kernel).  That kernel takes [B*H, S, D] tensors
// with K/V repeated to every query head and counts positions from 0; this
// one reads the model layout q [B,S,Hq,D], k/v [B,T,Hkv,D] directly and
// takes q_pos [S] and k_pos [T], so prefill (k_pos = q_pos) and decode over
// a rolling cache (k_pos = the cache's position table) share it.
//
// What bounds it on this card: a causal prefill of 4 x 512 tokens with 9
// heads of 64 does about 1.2 GFLOP in f32 on CUDA cores (no tensor cores in
// f32), about 18 us at 67 TFLOP/s, above its bytes.  A decode step (one
// query row) over a 1,024-slot cache reads about 6.3 MB of K and V and is
// bound by bytes (about 1.9 us at 3.35 TB/s).
//
// What the design does about it: one 128-thread block per (query tile of
// 32 rows, query head, batch).  A loop over key tiles of 64 stages K and V
// in shared memory and carries the running max, denominator and the f32
// accumulator (in registers) across tiles, so the scores never reach
// device memory.  A tile in which no key can be live for any row of the
// query tile is skipped (half of a causal prefill); rows past the end of
// the query (31 of 32 in decode) are not computed.  Products and sums are
// in f32, built with -fmad=false; the result matches the plain version to
// about 1e-6 (sums in another order).  A row with no live key is written
// as 0.  Simple first: no tensor cores, no cp.async or TMA, no split of
// the key axis across blocks for decode.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#define NT 128
#define BQ 32
#define BK 64
#define FULL 0xffffffffu

__device__ __forceinline__ bool live_key(int kp, int qp, int causal,
                                         int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Whether key position kp can be live for some query position in
// [q_lo, q_hi]: false only when it is masked for every row of the tile.
__device__ __forceinline__ bool maybe_live(int kp, int q_lo, int q_hi,
                                          int causal, int window) {
  return kp >= 0 && (!causal || kp <= q_hi) &&
         (window <= 0 || kp > q_lo - window);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out, int S, int T,
    int Hq, int Hkv, int causal, int window, float sqrt_d) {
  extern __shared__ float smem[];
  float* q_sh = smem;                  // [BQ][D]
  float* k_sh = q_sh + BQ * D;         // [BK][D + 1] (padded: no conflicts)
  float* v_sh = k_sh + BK * (D + 1);   // [BK][D]
  float* p_sh = v_sh + BK * D;         // [BQ][BK] scores, then probabilities
  float* m_sh = p_sh + BQ * BK;        // [BQ] running max
  float* l_sh = m_sh + BQ;             // [BQ] running denominator
  float* alpha_sh = l_sh + BQ;         // [BQ] rescale of this tile
  int* qp_sh = (int*)(alpha_sh + BQ);  // [BQ]
  int* kp_sh = qp_sh + BQ;             // [BK]
  __shared__ int q_lo, q_hi, run_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, S - q0);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    q_sh[i] = r < nq ? q[((size_t)(b * S + q0 + r) * Hq + h) * D + d] : 0.0f;
  }
  if (tid < BQ) {
    qp_sh[tid] = tid < nq ? q_pos[q0 + tid] : 0;
    m_sh[tid] = -INFINITY;
    l_sh[tid] = 0.0f;
  }
  if (warp == 0) {  // BQ == 32: one lane per query row
    const int qp = lane < nq ? q_pos[q0 + lane] : 0;
    int lo = lane < nq ? qp : INT_MAX, hi = lane < nq ? qp : INT_MIN;
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, off));
      hi = max(hi, __shfl_xor_sync(FULL, hi, off));
    }
    if (lane == 0) {
      q_lo = lo;
      q_hi = hi;
    }
  }

  // scores: thread owns key column c and rows r0 + 2i
  const int c = tid % BK, r0 = tid / BK;
  // accumulator: thread owns feature d and rows ra + (NT / D) j
  constexpr int ACC = BQ * D / NT;
  const int d_own = tid % D, ra = tid / D;
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += BK) {
    const int nk = min(BK, T - t0);
    __syncthreads();  // the previous tile is consumed; q_lo/q_hi are set
    if (tid < BK) kp_sh[tid] = tid < nk ? k_pos[t0 + tid] : -1;
    __syncthreads();
    if (warp == 0) {  // BK == 64: two keys per lane
      const bool any =
          maybe_live(kp_sh[lane], q_lo, q_hi, causal, window) ||
          maybe_live(kp_sh[lane + 32], q_lo, q_hi, causal, window);
      const unsigned ballot = __ballot_sync(FULL, any);
      if (lane == 0) run_tile = ballot != 0u;
    }
    __syncthreads();
    if (!run_tile) continue;

    for (int i = tid; i < BK * D; i += NT) {
      const int cc = i / D, d = i % D;
      const bool ok = cc < nk;
      const size_t at = ((size_t)(b * T + t0 + cc) * Hkv + hk) * D + d;
      k_sh[cc * (D + 1) + d] = ok ? k[at] : 0.0f;
      v_sh[cc * D + d] = ok ? v[at] : 0.0f;
    }
    __syncthreads();

    {
      float s[BQ * BK / NT];
#pragma unroll
      for (int i = 0; i < BQ * BK / NT; ++i) s[i] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float kd = k_sh[c * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < BQ * BK / NT; ++i) {
          const int r = r0 + i * (NT / BK);
          if (r < nq) s[i] = s[i] + q_sh[r * D + d] * kd;
        }
      }
      const int kp = kp_sh[c];
#pragma unroll
      for (int i = 0; i < BQ * BK / NT; ++i) {
        const int r = r0 + i * (NT / BK);
        if (r < nq)
          p_sh[r * BK + c] = live_key(kp, qp_sh[r], causal, window)
                                 ? s[i] / sqrt_d
                                 : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < nq; r += NT / 32) {
      const float s0 = p_sh[r * BK + lane], s1 = p_sh[r * BK + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_prev = m_sh[r], m_new = fmaxf(m_prev, mx);
      float p0 = 0.0f, p1 = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {
        alpha = expf(m_prev - m_new);
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
      }
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum = sum + __shfl_xor_sync(FULL, sum, off);
      p_sh[r * BK + lane] = p0;
      p_sh[r * BK + lane + 32] = p1;
      if (lane == 0) {
        l_sh[r] = l_sh[r] * alpha + sum;
        m_sh[r] = m_new;
        alpha_sh[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int r = ra + j * (NT / D);
      if (r < nq) acc[j] = acc[j] * alpha_sh[r];
    }
    for (int cc = 0; cc < BK; ++cc) {
      const float vd = v_sh[cc * D + d_own];
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        const int r = ra + j * (NT / D);
        if (r < nq) acc[j] = acc[j] + p_sh[r * BK + cc] * vd;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int r = ra + j * (NT / D);
    if (r < nq) {
      const float l = l_sh[r];
      out[((size_t)(b * S + q0 + r) * Hq + h) * D + d_own] =
          l > 0.0f ? acc[j] / l : 0.0f;
    }
  }
}

template <int D>
static int launch(const float* q, const float* k, const float* v,
                  const int* q_pos, const int* k_pos, float* out, int B,
                  int S, int T, int Hq, int Hkv, int causal, int window,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D +
                                       BQ * BK + 3 * BQ) +
                      sizeof(int) * (BQ + BK);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<D><<<grid, NT, smem, stream>>>(
      q, k, v, q_pos, k_pos, out, S, T, Hq, Hkv, causal, window,
      sqrtf((float)D));
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  q/out [B,S,Hq,D], k/v [B,T,Hkv,D] row-major f32;
// q_pos [S], k_pos [T] int32; all device memory.  window <= 0: no window.
// D must be 16, 32, 64 or 128 and Hq a multiple of Hkv (the wrapper checks;
// an unsupported D returns cudaErrorInvalidValue).
int flash_attention(const float* q, const float* k, const float* v,
                    const int* q_pos, const int* k_pos, float* out, int B,
                    int S, int T, int Hq, int Hkv, int D, int causal,
                    int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv, causal,
                        window, st);
    case 32:
      return launch<32>(q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv, causal,
                        window, st);
    case 64:
      return launch<64>(q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv, causal,
                        window, st);
    case 128:
      return launch<128>(q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv, causal,
                         window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
