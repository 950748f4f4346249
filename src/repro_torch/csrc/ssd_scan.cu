// Chunked Mamba-2 SSD scan in f32, per (batch, head), from an initial state.
//
// Per chunk of Q steps, with cum = inclusive cumsum(dt * a) in the chunk:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(min(cum_i - cum_j, 0)) dt_j x_j
//         + exp(cum_i) C_i . S^T                     (S entering the chunk)
//   S    <- exp(cum_end) S + sum_j exp(cum_end - cum_j) dt_j x_j (x) B_j
// x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,G,N] (head h reads group
// h / (H / G)), init_state and state_out [B,H,P,N]; positions past S count
// as dt = 0, x = 0 and are not written.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (ssd_scan,
// body _kernel).  The Pallas kernel walks the chunks on a sequential grid
// axis with the state in VMEM scratch and always starts from zero; here the
// chunk loop runs inside one block, the state starts from init_state, the
// chunk length is a run-time argument (the model picks 16-128 from the
// sequence length), and B/C are read per group without a repeat in memory.
//
// What bounds it on this card: operations.  At mamba2-1.3b's prefill
// (4 x 512 tokens, 64 heads, P 64, N 128, Q 128) the causal half of the
// dual form, the inter-chunk term and the state update are about 7.5 GFLOP
// per layer in f32 on CUDA cores (113 us at 67 TFLOP/s), against about
// 101 MB of inputs and outputs (30 us at 3.35 TB/s).
//
// What the design does about it: one 256-thread block per (head, batch).
// The state S [P][N] stays in shared memory for the whole sequence; each
// chunk's B, C and x*dt are staged in shared memory (at Q=128, P=64, N=128:
// S 33 KB + B 66 KB + C 64 KB + x 32 KB, about 202 KB with the rest), and
// the Q x Q score matrix is never formed: rows of C.B^T times the decay are
// made R = 16 rows at a time and consumed at once.  B and S rows are padded
// by one float so the column-wise reads hit distinct banks.  The per-chunk
// cumsum is a warp scan.  Products and sums in f32, built with -fmad=false.
// Simple first: no tensor cores, no register tiling, one block per SM.

#include <cuda_runtime.h>
#include <math.h>

#define NT 256
#define R 16
#define MAX_Q 128
#define FULL 0xffffffffu

__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ init_state,
    float* __restrict__ y, float* __restrict__ state_out, int S, int H,
    int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* s_sh = smem;              // [P][N + 1] carried state
  float* b_sh = s_sh + P * NP;     // [Q][N + 1]
  float* c_sh = b_sh + Q * NP;     // [Q][N]
  float* x_sh = c_sh + Q * N;      // [Q][P] x * dt
  float* g_sh = x_sh + Q * P;      // [R][Q] rows of the decayed scores
  float* dt_sh = g_sh + R * Q;     // [Q]
  float* cum_sh = dt_sh + Q;       // [Q]
  float* w_sh = cum_sh + Q;        // [Q] exp(cum_end - cum_j)

  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a_h = a[h];
  const size_t state_at = (size_t)(b * H + h) * P * N;

  for (int e = tid; e < P * N; e += NT)
    s_sh[(e / N) * NP + e % N] = init_state ? init_state[state_at + e] : 0.0f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int nl = min(Q, S - t0);  // live steps in this chunk
    __syncthreads();  // the previous chunk is consumed
    for (int j = tid; j < Q; j += NT)
      dt_sh[j] = j < nl ? dt[(size_t)(b * S + t0 + j) * H + h] : 0.0f;
    for (int e = tid; e < Q * P; e += NT) {
      const int j = e / P;
      x_sh[e] = j < nl ? x[((size_t)(b * S + t0 + j) * H + h) * P + e % P]
                       : 0.0f;
    }
    for (int e = tid; e < Q * N; e += NT) {
      const int j = e / N, n = e % N;
      const size_t at = ((size_t)(b * S + t0 + j) * G + g) * N + n;
      b_sh[j * NP + n] = j < nl ? bm[at] : 0.0f;
      c_sh[e] = j < nl ? cm[at] : 0.0f;
    }
    __syncthreads();

    if (tid < 32) {  // inclusive cumsum of dt * a over the chunk
      const int per = (Q + 31) / 32;
      float loc[MAX_Q / 32];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < MAX_Q / 32; ++e) {
        const int j = lane * per + e;
        if (e < per && j < Q) run = run + dt_sh[j] * a_h;
        loc[e] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = incl + o;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.0f;
#pragma unroll
      for (int e = 0; e < MAX_Q / 32; ++e) {
        const int j = lane * per + e;
        if (e < per && j < Q) cum_sh[j] = excl + loc[e];
      }
    }
    for (int e = tid; e < Q * P; e += NT) x_sh[e] = x_sh[e] * dt_sh[e / P];
    __syncthreads();

    const float cum_end = cum_sh[Q - 1];
    for (int j = tid; j < Q; j += NT) w_sh[j] = expf(cum_end - cum_sh[j]);

    for (int i0 = 0; i0 < nl; i0 += R) {
      // rows i0..i0+R-1 of (C B^T) * exp(min(cum_i - cum_j, 0)), causal
      for (int e = tid; e < R * Q; e += NT) {
        const int i = i0 + e / Q, j = e % Q;
        float gv = 0.0f;
        if (i < nl && j <= i) {
          float dot = 0.0f;
          for (int n = 0; n < N; ++n)
            dot = dot + c_sh[i * N + n] * b_sh[j * NP + n];
          gv = dot * expf(fminf(cum_sh[i] - cum_sh[j], 0.0f));
        }
        g_sh[e] = gv;
      }
      __syncthreads();
      for (int e = tid; e < R * P; e += NT) {
        const int r = e / P, p = e % P, i = i0 + r;
        if (i < nl) {
          float intra = 0.0f;
          for (int j = 0; j <= i; ++j)
            intra = intra + g_sh[r * Q + j] * x_sh[j * P + p];
          float inter = 0.0f;
          for (int n = 0; n < N; ++n)
            inter = inter + c_sh[i * N + n] * s_sh[p * NP + n];
          y[((size_t)(b * S + t0 + i) * H + h) * P + p] =
              intra + expf(cum_sh[i]) * inter;
        }
      }
      __syncthreads();  // g_sh is rewritten; s_sh is read until here
    }

    const float decay = expf(cum_end);
    for (int e = tid; e < P * N; e += NT) {
      const int p = e / N, n = e % N;
      float upd = 0.0f;
      for (int j = 0; j < nl; ++j)
        upd = upd + (w_sh[j] * x_sh[j * P + p]) * b_sh[j * NP + n];
      s_sh[p * NP + n] = decay * s_sh[p * NP + n] + upd;
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += NT)
    state_out[state_at + e] = s_sh[(e / N) * NP + e % N];
}

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t ssd_scan_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * ((size_t)P * (N + 1) + (size_t)Q * (N + 1) +
                          (size_t)Q * N + (size_t)Q * P + (size_t)R * Q +
                          3 * (size_t)Q);
}

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  All pointers are device memory, row-major f32;
// init_state may be null (a zero state).  Needs 1 <= Q <= 128, H a multiple
// of G and ssd_scan_smem_bytes(P, N, Q) within the block limit (the wrapper
// checks).
int ssd_scan(const float* x, const float* dt, const float* a, const float* b,
             const float* c, const float* init_state, float* y,
             float* state_out, int B, int S, int H, int P, int G, int N, int Q,
             void* stream) {
  if (Q < 1 || Q > MAX_Q) return (int)cudaErrorInvalidValue;
  const size_t smem = ssd_scan_smem_bytes(P, N, Q);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_scan_kernel<<<dim3(H, B), NT, smem, (cudaStream_t)stream>>>(
      x, dt, a, b, c, init_state, y, state_out, S, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
