// Chunked Mamba-2 SSD scan in f32, chunk-parallel, from an initial state.
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
// axis with the state in VMEM scratch and always starts from zero.  Here
// only the state pass is sequential over chunks; everything else runs per
// chunk in parallel, the state starts from init_state, the chunk length is
// a run-time argument (the model picks 16-128 from the sequence length),
// and B/C are read per group without a repeat in memory.
//
// What bounds it on this card: operations.  At mamba2-1.3b's prefill
// (4 x 512 tokens, 64 heads over 8 groups, P 64, N 128, Q 128) the causal
// half of C.B^T once per group (0.27 GFLOP), the intra-chunk product
// (1.08 GFLOP), the chunk states and the inter-chunk term (4.29 GFLOP) are
// about 5.6 GFLOP per layer in f32 on CUDA cores (84 us at 67 TFLOP/s),
// against about 101 MB of inputs and outputs (30 us at 3.35 TB/s).
//
// What the design does about it: four launches, the decomposition of the
// plain version (kernels/ssd_scan/ref.py):
//   1. ssd_scores_kernel, per (64x64 tile on or above the diagonal, chunk,
//      group, batch): C.B^T of the chunk, once for all heads of the group,
//      written transposed (cbt[j][i] = B_j . C_i) so that step 2 reads it
//      along i;
//   2. ssd_chunk_kernel, per (64x64 output tile, chunk, head, batch): the
//      chunk's cumsum (a warp scan), then either a tile of
//      y_intra = (C.B^T o decay) . (x dt) or a tile of the chunk's own
//      state dS = sum_j exp(cum_end - cum_j) dt_j x_j (x) B_j;
//   3. ssd_state_kernel, per (state element, head, batch): the chunks in
//      order from init_state, S_c = exp(cum_end) S_{c-1} + dS_c, writing
//      each chunk's entry state over its dS and the final state;
//   4. ssd_inter_kernel, per (64x64 tile, chunk, head, batch):
//      y += exp(cum_i) C_i . S_entry^T (the first chunk's entry state is
//      init_state, or zero).
// Every product is a 64x64 output tile per 256-thread block, 4x4 outputs
// in registers per thread, the contraction staged 32 at a time in shared
// memory (18 KB a block, so several blocks share an SM) and read as float4:
// one shared load feeds four to eight multiply-adds.  The state pass keeps
// eight chunks' loads in flight per thread.  Built with FMA
// contraction; no atomics, so two runs are bit-identical.  No tensor cores:
// in f32 they mean TF32, which cannot hold the plain version's 2e-4.

#include <cuda_runtime.h>
#include <math.h>

#define NT 256         // threads of a tile-product block (16 x 16 of them)
#define NT_STATE 256   // threads of a state-pass block
#define TILE 64
#define KC 32
#define RS (KC + 4)    // row stride of a slice kept row by row, [TILE][KC]
#define CS (TILE + 4)  // row stride of a slice kept k by k, [KC][TILE]
#define MAX_Q 128
#define CHUNKS_IN_FLIGHT 8
#define FULL 0xffffffffu

// acc[a][b] += sum_k A[ty + 16a][k] B[tx + 16b][k] over one slice kept row
// by row (as, bs: [TILE][RS]).  Rows 36 floats apart put the eight threads
// of a quarter warp on distinct banks; A is a broadcast.
__device__ __forceinline__ void mma_rows(const float* as, const float* bs,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 4) {
    float4 av[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(as + (ty + 16 * a) * RS + kk);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 bv =
          *reinterpret_cast<const float4*>(bs + (tx + 16 * b) * RS + kk);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float s = acc[a][b];
        s = fmaf(av[a].x, bv.x, s);
        s = fmaf(av[a].y, bv.y, s);
        s = fmaf(av[a].z, bv.z, s);
        acc[a][b] = fmaf(av[a].w, bv.w, s);
      }
    }
  }
}

// acc[a][b] += sum_k A[k][4 ty + a] B[k][4 tx + b] over one slice kept k by
// k (as, bs: [KC][CS]).
__device__ __forceinline__ void mma_cols(const float* as, const float* bs,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(as + kk * CS + ty * 4);
    const float4 b4 = *reinterpret_cast<const float4*>(bs + kk * CS + tx * 4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// 1. cbt[b,c,g][j][i] = B_j . C_i for the tile pair (jt <= it).
__global__ void __launch_bounds__(NT) ssd_scores_kernel(
    const float* __restrict__ bm, const float* __restrict__ cm,
    float* __restrict__ cbt, int S, int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sa[TILE * RS];
  __shared__ __align__(16) float sb[TILE * RS];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int jt = blockIdx.x, it = 0;  // blockIdx.x enumerates (jt <= it)
  while (jt > it) {
    jt -= it + 1;
    ++it;
  }
  const int c = blockIdx.y % nc, g = blockIdx.y / nc, b = blockIdx.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  const int j0 = jt * TILE, i0 = it * TILE;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();  // the previous slice is consumed
    for (int e = tid; e < TILE * KC; e += NT) {
      const int m = e / KC, kk = e % KC, n = k0 + kk;
      const int j = j0 + m, i = i0 + m;
      sa[m * RS + kk] =
          j < nl && n < N ? bm[((size_t)(b * S + t0 + j) * G + g) * N + n]
                          : 0.0f;
      sb[m * RS + kk] =
          i < nl && n < N ? cm[((size_t)(b * S + t0 + i) * G + g) * N + n]
                          : 0.0f;
    }
    __syncthreads();
    mma_rows(sa, sb, ty, tx, acc);
  }
  float* out = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int i = i0 + tx + 16 * bb;
      if (j < Q && i < Q) out[(size_t)j * Q + i] = acc[a][bb];
    }
  }
}

// 2. The chunk's cumsum, then one tile of y_intra or of dS.
__global__ void __launch_bounds__(NT) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cbt, float* __restrict__ y,
    float* __restrict__ cum, float* __restrict__ dstate, int S, int H,
    int P, int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sa[KC * CS];
  __shared__ __align__(16) float sb[KC * CS];
  __shared__ float dt_s[MAX_Q], cum_s[MAX_Q];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, lane = tid & 31;
  const int c = blockIdx.y % nc, h = blockIdx.y / nc, b = blockIdx.z;
  const int g = h / (H / G);
  const int t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h;  // (batch, chunk, head)

  for (int j = tid; j < Q; j += NT)
    dt_s[j] = j < nl ? dt[(size_t)(b * S + t0 + j) * H + h] : 0.0f;
  __syncthreads();
  if (tid < 32) {  // inclusive cumsum of dt * a over the chunk
    const float a_h = a[h];
    const int per = (Q + 31) / 32;
    float loc[MAX_Q / 32];
    float run = 0.0f;
#pragma unroll
    for (int e = 0; e < MAX_Q / 32; ++e) {
      const int j = lane * per + e;
      if (e < per && j < Q) run = run + dt_s[j] * a_h;
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
      if (e < per && j < Q) cum_s[j] = excl + loc[e];
    }
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int j = tid; j < Q; j += NT) cum[ch * Q + j] = cum_s[j];

  const int n_pt = (P + TILE - 1) / TILE;
  const int n_yt = (Q + TILE - 1) / TILE * n_pt;
  float acc[4][4] = {};
  if ((int)blockIdx.x < n_yt) {
    // y_intra[i][p] = sum_{j<=i} cbt[j][i] exp(min(cum_i - cum_j, 0))
    //                 dt_j x[j][p]
    const int i0 = blockIdx.x / n_pt * TILE, p0 = blockIdx.x % n_pt * TILE;
    const float* cb = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
    const int kend = min(nl, i0 + TILE);
    for (int k0 = 0; k0 < kend; k0 += KC) {
      __syncthreads();
      for (int e = tid; e < KC * TILE; e += NT) {
        const int kk = e / TILE, m = e % TILE, j = k0 + kk;
        const int i = i0 + m, p = p0 + m;
        sa[kk * CS + m] =
            j <= i && i < nl
                ? cb[(size_t)j * Q + i] *
                      expf(fminf(cum_s[i] - cum_s[j], 0.0f))
                : 0.0f;
        sb[kk * CS + m] =
            j < nl && p < P
                ? x[((size_t)(b * S + t0 + j) * H + h) * P + p] * dt_s[j]
                : 0.0f;
      }
      __syncthreads();
      mma_cols(sa, sb, ty, tx, acc);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + tx * 4 + q;
        if (i < nl && p < P)
          y[((size_t)(b * S + t0 + i) * H + h) * P + p] = acc[r][q];
      }
    }
  } else {
    // dS[p][n] = sum_j exp(cum_end - cum_j) dt_j x[j][p] B[j][n]
    const int n_nt = (N + TILE - 1) / TILE, tile = blockIdx.x - n_yt;
    const int p0 = tile / n_nt * TILE, n0 = tile % n_nt * TILE;
    const float cum_end = cum_s[Q - 1];
    for (int k0 = 0; k0 < nl; k0 += KC) {
      __syncthreads();
      for (int e = tid; e < KC * TILE; e += NT) {
        const int kk = e / TILE, m = e % TILE, j = k0 + kk;
        const int p = p0 + m, n = n0 + m;
        sa[kk * CS + m] =
            j < nl && p < P
                ? x[((size_t)(b * S + t0 + j) * H + h) * P + p] *
                      (dt_s[j] * expf(cum_end - cum_s[j]))
                : 0.0f;
        sb[kk * CS + m] =
            j < nl && n < N ? bm[((size_t)(b * S + t0 + j) * G + g) * N + n]
                            : 0.0f;
      }
      __syncthreads();
      mma_cols(sa, sb, ty, tx, acc);
    }
    float* ds = dstate + ch * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + ty * 4 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + tx * 4 + q;
        if (p < P && n < N) ds[(size_t)p * N + n] = acc[r][q];
      }
    }
  }
}

// 3. The state pass: one thread per state element walks the chunks, the
// loads of CHUNKS_IN_FLIGHT chunks issued before their stores.
__global__ void __launch_bounds__(NT_STATE) ssd_state_kernel(
    const float* __restrict__ init_state, const float* __restrict__ cum,
    float* __restrict__ states, float* __restrict__ state_out, int H, int PN,
    int Q, int nc) {
  const int e = blockIdx.x * NT_STATE + threadIdx.x, h = blockIdx.y,
            b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = (size_t)b * H + h;
  float s = init_state ? init_state[bh * PN + e] : 0.0f;
  for (int c0 = 0; c0 < nc; c0 += CHUNKS_IN_FLIGHT) {
    float ds[CHUNKS_IN_FLIGHT], w[CHUNKS_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < CHUNKS_IN_FLIGHT; ++u) {
      const size_t ch = (size_t)(b * nc + c0 + u) * H + h;
      if (c0 + u < nc) {
        ds[u] = states[ch * PN + e];
        w[u] = expf(cum[ch * Q + Q - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < CHUNKS_IN_FLIGHT; ++u) {
      const size_t ch = (size_t)(b * nc + c0 + u) * H + h;
      if (c0 + u < nc) {
        states[ch * PN + e] = s;  // the state entering chunk c0 + u
        s = w[u] * s + ds[u];
      }
    }
  }
  state_out[bh * PN + e] = s;
}

// 4. y[i][p] += exp(cum_i) sum_n C[i][n] S_entry[p][n].  Bounded to five
// blocks an SM (at most 51 registers a thread), which made it faster at
// mamba2-1.3b's prefill on an H100; the same bound made the other two
// products slower.
__global__ void __launch_bounds__(NT, 5) ssd_inter_kernel(
    const float* __restrict__ cm, const float* __restrict__ cum,
    const float* __restrict__ states, float* __restrict__ y, int S, int H,
    int P, int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sa[TILE * RS];
  __shared__ __align__(16) float sb[TILE * RS];
  const int c = blockIdx.y % nc, h = blockIdx.y / nc, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int g = h / (H / G);
  const int t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h;
  const int n_pt = (P + TILE - 1) / TILE;
  const int i0 = blockIdx.x / n_pt * TILE, p0 = blockIdx.x % n_pt * TILE;
  const float* st = states + ch * P * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < TILE * KC; e += NT) {
      const int m = e / KC, kk = e % KC, n = k0 + kk;
      const int i = i0 + m, p = p0 + m;
      sa[m * RS + kk] =
          i < nl && n < N ? cm[((size_t)(b * S + t0 + i) * G + g) * N + n]
                          : 0.0f;
      sb[m * RS + kk] = p < P && n < N ? st[(size_t)p * N + n] : 0.0f;
    }
    __syncthreads();
    mma_rows(sa, sb, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= nl) continue;
    const float w = expf(cum[ch * Q + i]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + tx + 16 * q;
      if (p < P) {
        float* out = y + ((size_t)(b * S + t0 + i) * H + h) * P + p;
        *out = *out + w * acc[r][q];
      }
    }
  }
}

extern "C" {

// Floats of scratch ssd_scan needs: C.B^T [B, nc, G, Q, Q], cumsums
// [B, nc, H, Q], chunk states [B, nc, H, P, N] (nc = chunks).
size_t ssd_scan_scratch_floats(int B, int S, int H, int P, int G, int N,
                               int Q) {
  const size_t nc = (S + Q - 1) / Q;
  return (size_t)B * nc *
         ((size_t)G * Q * Q + (size_t)H * Q + (size_t)H * P * N);
}

// Launch the four kernels on `stream`; allocates nothing, does not
// synchronise, returns the first cudaGetLastError() that is not success.
// All pointers are device memory, row-major f32; init_state may be null (a
// zero state); scratch holds ssd_scan_scratch_floats(...) floats.  Needs
// 1 <= Q <= 128, H a multiple of G, and chunks x max(G, H) and B within a
// grid's y and z limits (the wrapper checks).
int ssd_scan(const float* x, const float* dt, const float* a, const float* b,
             const float* c, const float* init_state, float* y,
             float* state_out, float* scratch, int B, int S, int H, int P,
             int G, int N, int Q, void* stream) {
  if (Q < 1 || Q > MAX_Q || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q, nt = (Q + TILE - 1) / TILE;
  const int n_pt = (P + TILE - 1) / TILE, n_nt = (N + TILE - 1) / TILE;
  float* cbt = scratch;
  float* cum = cbt + (size_t)B * nc * G * Q * Q;
  float* states = cum + (size_t)B * nc * H * Q;
  ssd_scores_kernel<<<dim3(nt * (nt + 1) / 2, nc * G, B), NT, 0, st>>>(
      b, c, cbt, S, G, N, Q, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_kernel<<<dim3(nt * n_pt + n_pt * n_nt, nc * H, B), NT, 0, st>>>(
      x, dt, a, b, cbt, y, cum, states, S, H, P, G, N, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_kernel<<<dim3((P * N + NT_STATE - 1) / NT_STATE, H, B),
                     NT_STATE, 0, st>>>(
      init_state, cum, states, state_out, H, P * N, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_inter_kernel<<<dim3(nt * n_pt, nc * H, B), NT, 0, st>>>(
      c, cum, states, y, S, H, P, G, N, Q, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
