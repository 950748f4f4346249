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
//
// bf16 (ssd_scan_bf16): the same TPU kernel in the reference's working
// type, x, b, c and y in bf16, dt, a, the states and the scratch in f32,
// as the Pallas kernel takes them (kernel.py:36-40, :75):
// the four kernels are templated on the element type, convert each value
// to f32 as they stage it and do every product in f32 on CUDA cores, as
// the f32 path does; the intra-chunk term goes to an f32 copy of y, and
// the inter-chunk kernel rounds y to bf16 once.  The inputs' bytes halve
// (about 59 MB at mamba2-1.3b's prefill, 18 us at 3.35 TB/s); what bounds
// it is still the 5.6 GFLOP of f32 operations, 84 us.  The products of C.B^T
// and of the chunk states take bf16 operands with f32 sums, so they could
// go to the tensor cores with exact products: that is a later design.

#include <cuda_bf16.h>
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

// One input value as f32: x, b and c come as f32 or bf16.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_y(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
template <class T>
__global__ void __launch_bounds__(NT) ssd_scores_kernel(
    const T* __restrict__ bm, const T* __restrict__ cm,
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
          j < nl && n < N ? ld(bm + ((size_t)(b * S + t0 + j) * G + g) * N + n)
                          : 0.0f;
      sb[m * RS + kk] =
          i < nl && n < N ? ld(cm + ((size_t)(b * S + t0 + i) * G + g) * N + n)
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

// 2. The chunk's cumsum, then one tile of y_intra (in f32) or of dS.
template <class T>
__global__ void __launch_bounds__(NT) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
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
                ? ld(x + ((size_t)(b * S + t0 + j) * H + h) * P + p) * dt_s[j]
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
                ? ld(x + ((size_t)(b * S + t0 + j) * H + h) * P + p) *
                      (dt_s[j] * expf(cum_end - cum_s[j]))
                : 0.0f;
        sb[kk * CS + m] =
            j < nl && n < N
                ? ld(bm + ((size_t)(b * S + t0 + j) * G + g) * N + n)
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

// 4. y[i][p] += exp(cum_i) sum_n C[i][n] S_entry[p][n]: in place in the
// f32 path; in bf16, y = round(yin + ...) with y_intra in yin (f32).
// Bounded to five blocks an SM (at most 51 registers a thread), which made
// it faster at mamba2-1.3b's prefill on an H100; the same bound made the
// other two products slower.  The bf16 instantiation, which converts C as
// it stages it, gets four (64 registers): at five it spilled.
template <class T>
__global__ void __launch_bounds__(NT, sizeof(T) == sizeof(float) ? 5 : 4)
    ssd_inter_kernel(const T* __restrict__ cm, const float* __restrict__ cum,
                     const float* __restrict__ states,
                     const float* __restrict__ yin, T* __restrict__ y, int S,
                     int H, int P, int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sa[TILE * RS];
  __shared__ __align__(16) float sb[TILE * RS];
  const int c = blockIdx.y % nc, h = blockIdx.y / nc, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int g = h / (H / G);
  const int t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h;
  const int n_pt = (P + TILE - 1) / TILE;
  const int i0 = blockIdx.x / n_pt * TILE, p0 = blockIdx.x % n_pt * TILE;
  const float* sp = states + ch * P * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < TILE * KC; e += NT) {
      const int m = e / KC, kk = e % KC, n = k0 + kk;
      const int i = i0 + m, p = p0 + m;
      sa[m * RS + kk] =
          i < nl && n < N ? ld(cm + ((size_t)(b * S + t0 + i) * G + g) * N + n)
                          : 0.0f;
      sb[m * RS + kk] = p < P && n < N ? sp[(size_t)p * N + n] : 0.0f;
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
        const size_t at = ((size_t)(b * S + t0 + i) * H + h) * P + p;
        if constexpr (sizeof(T) == sizeof(float)) {
          y[at] = y[at] + w * acc[r][q];
        } else {
          store_y(y + at, yin[at] + w * acc[r][q]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The backward.  It has no TPU twin: the reference differentiates
// ssd_chunked (src/repro/models/mamba2.py:64) with jax.grad.  With
// u = dt x, E_ij = exp(min(cum_i - cum_j, 0)) (j <= i), M_ij = C_i . B_j
// per group, S_{c-1} the state entering chunk c (the forward's scratch
// keeps it) and Shat_c the cotangent of the state leaving it:
//   Shat_{c-1} = exp(cum_end) Shat_c + sum_i exp(cum_i) dy_i (x) C_i
//   du_j  = sum_{i>=j} M_ij E_ij dy_i + exp(cum_end - cum_j) Shat_c B_j
//   dM_ij = sum_{h in group} E_ij (dy_i . u_j)            (heads in order)
//   dC_i  = sum_j dM_ij B_j + sum_h exp(cum_i) S_{c-1}^T dy_i
//   dB_j  = sum_i dM_ij C_i + sum_h exp(cum_end - cum_j) Shat_c^T u_j
// and dcum (from E, the inter term and the state update), whose reverse
// in-chunk cumsum dl gives ddt_j = x_j . du_j + a dl_j and da = sum dt dl.
// E's diagonal adds g and -g to the same dcum_i, so the sums leave it out.
// The inter term's share of dcum_i is C_i . (exp(cum_i) S_{c-1}^T dy_i),
// the dot of C_i with the head's state term of dC, which the group kernel
// forms anyway.  The plain mirror is ssd_bwd_ref in kernels/ssd_scan/ref.py.
//
// What bounds it: operations.  At mamba2-1.3b's training shape (4 x 512
// tokens, 64 heads over 8 groups, P 64, N 128, Q 128) the per-head
// products (the state aggregate, Shat B_j, dC's and dB's state terms:
// 8 nl P N a chunk; dy u^T and (M o E)^T dy over the causal half) and dM's
// two products per group come to about 11.3 GFLOP per layer in f32
// (0.17 ms at 67 TFLOP/s), against about 180 MB read and written.
//
// Five launches, the same 64x64 register tiles as the forward:
//   1. ssd_bwd_chunk_kernel, a block per (chunk, head, batch): the chunk's
//      aggregate sum_i exp(cum_i) dy_i (x) C_i; dy u^T over the causal
//      tiles, giving the head's share of dM (written to scratch) and the
//      row and column sums of M o dM^h below the diagonal;
//   2. ssd_bwd_state_kernel, the reverse state pass from dstate, writing
//      each chunk's Shat_c over its aggregate, and dinit;
//   3. ssd_bwd_group_kernel, a block per (64x64 tile of dC or dB, chunk,
//      group, batch): dM summed over the group's heads in order as it is
//      staged, then dM with B or C, then each head's state term in head
//      order; a dC block also writes each head's C_i . (state term) over
//      its 64 columns;
//   4. ssd_bwd_du_kernel, a block per (chunk, head, batch): du, dx, x . du,
//      the state terms of dcum, <Shat_c, S_{c-1}>, the inter term's share
//      (the group kernel's column tiles summed in order), the reverse
//      cumsum, ddt and the block's share of da;
//   5. ssd_bwd_da_kernel: da summed over batches and chunks in order.
// Row and column sums go through a staged tile and are added in index
// order; no atomics, so two runs are bit-identical.

#define RED (TILE + 1)  // row stride of a 64x64 tile staged for its sums

// acc[r][q] += sum_{k0 <= k < k1} A(4 ty + r, k) B(k, 4 tx + q) over a
// 64x64 output tile.  la(m, k) and lb(k, m) return an operand's element
// (0 outside it; m is the tile's row or column); each slice of KC is
// staged k by k.  KFA / KFB: the operand is contiguous along k in device
// memory, so neighbouring threads load neighbouring k (else neighbouring m).
template <bool KFA, bool KFB, class LA, class LB>
__device__ __forceinline__ void tile_product(float* sa, float* sb, int k0,
                                             int k1, LA la, LB lb,
                                             float acc[4][4]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int kb = k0; kb < k1; kb += KC) {
    __syncthreads();  // the previous slice (or a staged tile) is consumed
    for (int e = tid; e < KC * TILE; e += NT) {
      const int ka = KFA ? e % KC : e / TILE, ma = KFA ? e / KC : e % TILE;
      const int kq = KFB ? e % KC : e / TILE, mb = KFB ? e / KC : e % TILE;
      sa[ka * CS + ma] = kb + ka < k1 ? la(ma, kb + ka) : 0.0f;
      sb[kq * CS + mb] = kb + kq < k1 ? lb(kb + kq, mb) : 0.0f;
    }
    __syncthreads();
    mma_cols(sa, sb, ty, tx, acc);
  }
}

// rows[r0 + m] += sum_q red[m][q] and cols[c0 + m] += sum_r red[r][m] for
// the staged tile red [TILE][RED], in index order, below `lim`; either
// output may be null.
__device__ __forceinline__ void tile_sums(const float* red, float* rows,
                                          int r0, float* cols, int c0,
                                          int lim) {
  const int tid = threadIdx.x;
  __syncthreads();  // the tile is staged
  if (tid < TILE) {
    if (rows && r0 + tid < lim) {
      float s = 0.0f;
      for (int q = 0; q < TILE; ++q) s += red[tid * RED + q];
      rows[r0 + tid] += s;
    }
  } else if (tid < 2 * TILE) {
    const int m = tid - TILE;
    if (cols && c0 + m < lim) {
      float s = 0.0f;
      for (int r = 0; r < TILE; ++r) s += red[r * RED + m];
      cols[c0 + m] += s;
    }
  }
  __syncthreads();
}

// 1. Per (chunk, head): the aggregate, the head's dM and the dcum terms
// that need no Shat.
__global__ void __launch_bounds__(NT) ssd_bwd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cm, const float* __restrict__ dy,
    const float* __restrict__ cbt, const float* __restrict__ cum,
    float* __restrict__ hat, float* __restrict__ dm,
    float* __restrict__ dcum, int S, int H, int P, int G, int N, int Q,
    int nc) {
  __shared__ __align__(16) float sm[2 * KC * CS];
  __shared__ float dt_s[MAX_Q], cum_s[MAX_Q], ec_s[MAX_Q], rs[MAX_Q],
      cs[MAX_Q];
  float* sa = sm;
  float* sb = sm + KC * CS;
  float* red = sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.y % nc, h = blockIdx.y / nc, b = blockIdx.z;
  const int g = h / (H / G), t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h;
  const size_t row0 = (size_t)b * S + t0;  // the chunk's first step
  for (int j = tid; j < Q; j += NT) {
    dt_s[j] = j < nl ? dt[(row0 + j) * H + h] : 0.0f;
    cum_s[j] = cum[ch * Q + j];
    ec_s[j] = expf(cum_s[j]);
    rs[j] = cs[j] = 0.0f;
  }
  __syncthreads();
  auto dyv = [&](int i, int p) { return dy[((row0 + i) * H + h) * P + p]; };
  auto cv = [&](int i, int n) { return cm[((row0 + i) * G + g) * N + n]; };
  const int n_pt = (P + TILE - 1) / TILE, n_nt = (N + TILE - 1) / TILE;
  const int n_qt = (Q + TILE - 1) / TILE;

  // agg[p][n] = sum_i exp(cum_i) dy[i][p] C[i][n]
  for (int tile = 0; tile < n_pt * n_nt; ++tile) {
    const int p0 = tile / n_nt * TILE, n0 = tile % n_nt * TILE;
    float acc[4][4] = {};
    tile_product<false, false>(
        sa, sb, 0, nl,
        [&](int m, int i) { return p0 + m < P ? ec_s[i] * dyv(i, p0 + m) : 0.0f; },
        [&](int i, int m) { return n0 + m < N ? cv(i, n0 + m) : 0.0f; }, acc);
    float* out = hat + ch * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + ty * 4 + r, n = n0 + tx * 4 + q;
        if (p < P && n < N) out[(size_t)p * N + n] = acc[r][q];
      }
  }

  // dM^h[i][j] = E_ij (dy_i . u_j) on the causal tiles; sums of M o dM^h
  // below the diagonal
  const float* cb = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
  float* dmo = dm + ch * Q * Q;
  for (int it = 0; it < n_qt; ++it)
    for (int jt = 0; jt <= it; ++jt) {
      const int i0 = it * TILE, j0 = jt * TILE;
      float acc[4][4] = {};
      tile_product<true, true>(
          sa, sb, 0, P,
          [&](int m, int p) { return i0 + m < nl ? dyv(i0 + m, p) : 0.0f; },
          [&](int p, int m) {
            const int j = j0 + m;
            return j < nl ? dt_s[j] * x[((row0 + j) * H + h) * P + p] : 0.0f;
          },
          acc);
      __syncthreads();  // red overlays the slices
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + ty * 4 + r, j = j0 + tx * 4 + q;
          float d = 0.0f, gm = 0.0f;
          if (j <= i && i < nl) {
            d = expf(fminf(cum_s[i] - cum_s[j], 0.0f)) * acc[r][q];
            if (j < i) gm = cb[(size_t)j * Q + i] * d;
          }
          if (i < Q && j < Q) dmo[(size_t)i * Q + j] = d;
          red[(ty * 4 + r) * RED + tx * 4 + q] = gm;
        }
      tile_sums(red, rs, i0, cs, j0, Q);
    }
  for (int j = tid; j < Q; j += NT) dcum[ch * Q + j] = rs[j] - cs[j];
}

// 2. The reverse state pass: one thread per state element walks the chunks
// from the last, Shat_{c-1} = exp(cum_end) Shat_c + agg_c, writing Shat_c
// over agg_c, and dinit = Shat_{-1}.
__global__ void __launch_bounds__(NT_STATE) ssd_bwd_state_kernel(
    const float* __restrict__ dstate, const float* __restrict__ cum,
    float* __restrict__ hat, float* __restrict__ dinit, int H, int PN,
    int Q, int nc) {
  const int e = blockIdx.x * NT_STATE + threadIdx.x, h = blockIdx.y,
            b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = (size_t)b * H + h;
  float s = dstate ? dstate[bh * PN + e] : 0.0f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= CHUNKS_IN_FLIGHT) {
    float ag[CHUNKS_IN_FLIGHT], w[CHUNKS_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < CHUNKS_IN_FLIGHT; ++u) {
      const size_t ch = (size_t)(b * nc + c0 - u) * H + h;
      if (c0 - u >= 0) {
        ag[u] = hat[ch * PN + e];
        w[u] = expf(cum[ch * Q + Q - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < CHUNKS_IN_FLIGHT; ++u) {
      const size_t ch = (size_t)(b * nc + c0 - u) * H + h;
      if (c0 - u >= 0) {
        hat[ch * PN + e] = s;  // the cotangent leaving chunk c0 - u
        s = w[u] * s + ag[u];
      }
    }
  }
  if (dinit) dinit[bh * PN + e] = s;
}

// 4. Per (chunk, head): du = (M o E)^T dy + exp(cum_end - cum_j) Shat_c B_j,
// dx, x . du, the state terms of dcum, the inter term's share (dcs: the
// group kernel's n tiles, summed in order), the reverse cumsum, ddt and the
// block's share of da.
__global__ void __launch_bounds__(NT) ssd_bwd_du_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ dy, const float* __restrict__ cbt,
    const float* __restrict__ cum, const float* __restrict__ states,
    const float* __restrict__ hat, const float* __restrict__ dcum,
    const float* __restrict__ dcs, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dapart, int S, int H, int P,
    int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sm[2 * KC * CS];
  __shared__ float dt_s[MAX_Q], cum_s[MAX_Q], xd_s[MAX_Q], w_s[MAX_Q],
      dl_s[MAX_Q], dc_s[MAX_Q], part[NT];
  float* sa = sm;
  float* sb = sm + KC * CS;
  float* red = sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.y % nc, h = blockIdx.y / nc, b = blockIdx.z;
  const int g = h / (H / G), t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h;
  const size_t row0 = (size_t)b * S + t0;
  const int n_nt = (N + TILE - 1) / TILE;
  for (int j = tid; j < Q; j += NT) {
    dt_s[j] = j < nl ? dt[(row0 + j) * H + h] : 0.0f;
    cum_s[j] = cum[ch * Q + j];
    xd_s[j] = w_s[j] = 0.0f;
    float it = 0.0f;
    for (int nt = 0; nt < n_nt; ++nt) it += dcs[(ch * n_nt + nt) * Q + j];
    dc_s[j] = dcum[ch * Q + j] + it;
  }
  __syncthreads();
  const float cum_end = cum_s[Q - 1];
  const float* cb = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
  const float* sh = hat + ch * P * N;
  const float* st = states + ch * P * N;
  auto xv = [&](int j, int p) { return x[((row0 + j) * H + h) * P + p]; };
  const int n_pt = (P + TILE - 1) / TILE, n_qt = (Q + TILE - 1) / TILE;
  for (int jt = 0; jt < n_qt; ++jt)
    for (int pt = 0; pt < n_pt; ++pt) {
      const int j0 = jt * TILE, p0 = pt * TILE;
      float ai[4][4] = {}, as[4][4] = {};
      // sum_{i>=j} M_ij E_ij dy[i][p] (cbt[j][i] = M_ij, valid for i >= j)
      tile_product<true, false>(
          sa, sb, j0, nl,
          [&](int m, int i) {
            const int j = j0 + m;
            return j <= i ? cb[(size_t)j * Q + i] *
                                expf(fminf(cum_s[i] - cum_s[j], 0.0f))
                          : 0.0f;
          },
          [&](int i, int m) {
            return p0 + m < P ? dy[((row0 + i) * H + h) * P + p0 + m] : 0.0f;
          },
          ai);
      // sum_n B[j][n] Shat[p][n]
      tile_product<true, true>(
          sa, sb, 0, N,
          [&](int m, int n) {
            return j0 + m < nl ? bm[((row0 + j0 + m) * G + g) * N + n] : 0.0f;
          },
          [&](int n, int m) {
            return p0 + m < P ? sh[(size_t)(p0 + m) * N + n] : 0.0f;
          },
          as);
      __syncthreads();
      float du[4][4], su[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + ty * 4 + r, p = p0 + tx * 4 + q;
          const bool live = j < nl && p < P;
          const float xs = live ? xv(j, p) : 0.0f;
          const float sd = live ? expf(cum_end - cum_s[j]) * as[r][q] : 0.0f;
          du[r][q] = ai[r][q] + sd;
          su[r][q] = live ? dt_s[j] * xs * sd : 0.0f;  // u_j . (state du)
          if (live) dx[((row0 + j) * H + h) * P + p] = dt_s[j] * du[r][q];
          red[(ty * 4 + r) * RED + tx * 4 + q] = xs * du[r][q];
        }
      tile_sums(red, xd_s, j0, nullptr, 0, Q);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          red[(ty * 4 + r) * RED + tx * 4 + q] = su[r][q];
      tile_sums(red, w_s, j0, nullptr, 0, Q);
    }
  // <Shat_c, S_{c-1}>, each thread's strided part then a fixed tree
  float es = 0.0f;
  for (int e = tid; e < P * N; e += NT) es += sh[e] * st[e];
  part[tid] = es;
  __syncthreads();
  for (int off = NT / 2; off > 0; off >>= 1) {
    if (tid < off) part[tid] += part[tid + off];
    __syncthreads();
  }
  if (tid == 0) {
    float wsum = 0.0f;
    for (int j = 0; j < Q; ++j) wsum += w_s[j];
    float run = expf(cum_end) * part[0] + wsum;  // d cum_end's own terms
    for (int j = Q - 1; j >= 0; --j) {
      run += dc_s[j] - w_s[j];
      dl_s[j] = run;
    }
    float dap = 0.0f;
    for (int j = 0; j < nl; ++j) dap += dt_s[j] * dl_s[j];
    dapart[ch] = dap;
  }
  __syncthreads();
  const float a_h = a[h];
  for (int j = tid; j < nl; j += NT)
    ddt[(row0 + j) * H + h] = xd_s[j] + a_h * dl_s[j];
}

// 3. Per (64x64 tile of dC or dB, chunk, group): dM summed over the group's
// heads in order, then dM with B or C, then each head's state term in head
// order; a dC block writes each head's C_i . (state term) over its columns
// to dcs [B, nc, H, n tiles, Q].
__global__ void __launch_bounds__(NT) ssd_bwd_group_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ dy, const float* __restrict__ cum,
    const float* __restrict__ states, const float* __restrict__ hat,
    const float* __restrict__ dm, float* __restrict__ db,
    float* __restrict__ dc, float* __restrict__ dcs, int S, int H, int P,
    int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sm[2 * KC * CS];
  float* sa = sm;
  float* sb = sm + KC * CS;
  float* red = sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_qt = (Q + TILE - 1) / TILE, n_nt = (N + TILE - 1) / TILE;
  const int per = n_qt * n_nt, is_db = blockIdx.x / per,
            tile = blockIdx.x % per;
  const int r0 = tile / n_nt * TILE, n0 = tile % n_nt * TILE;
  const int c = blockIdx.y % nc, g = blockIdx.y / nc, b = blockIdx.z;
  const int rep = H / G, t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch0 = (size_t)(b * nc + c) * H + g * rep;  // the group's head 0
  const size_t row0 = (size_t)b * S + t0;
  auto dmsum = [&](int i, int j) {
    float s = 0.0f;
    for (int hh = 0; hh < rep; ++hh)
      s += dm[((ch0 + hh) * Q + i) * Q + j];
    return s;
  };
  const float* bc = is_db ? cm : bm;  // the other side of M
  float acc[4][4] = {};
  if (!is_db) {
    // dC[i][n] = sum_{j <= i} dM[i][j] B[j][n] + sum_h sum_p
    //            exp(cum_i) dy[i][p] S[p][n]
    tile_product<true, false>(
        sa, sb, 0, min(nl, r0 + TILE),
        [&](int m, int j) { return r0 + m < nl ? dmsum(r0 + m, j) : 0.0f; },
        [&](int j, int m) {
          return n0 + m < N ? bc[((row0 + j) * G + g) * N + n0 + m] : 0.0f;
        },
        acc);
    for (int hh = 0; hh < rep; ++hh) {
      float ah[4][4] = {};
      tile_product<true, false>(
          sa, sb, 0, P,
          [&](int m, int p) {
            const int i = r0 + m;
            return i < nl ? expf(cum[(ch0 + hh) * Q + i]) *
                                dy[((row0 + i) * H + g * rep + hh) * P + p]
                          : 0.0f;
          },
          [&](int p, int m) {
            return n0 + m < N ? states[((ch0 + hh) * P + p) * N + n0 + m]
                              : 0.0f;
          },
          ah);
      __syncthreads();  // red overlays the slices
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = r0 + ty * 4 + r, n = n0 + tx * 4 + q;
          acc[r][q] += ah[r][q];
          red[(ty * 4 + r) * RED + tx * 4 + q] =
              i < nl && n < N ? cm[((row0 + i) * G + g) * N + n] * ah[r][q]
                              : 0.0f;
        }
      __syncthreads();
      if (tid < TILE && r0 + tid < Q) {
        float t = 0.0f;
        for (int q = 0; q < TILE; ++q) t += red[tid * RED + q];
        dcs[((ch0 + hh) * n_nt + n0 / TILE) * Q + r0 + tid] = t;
      }
    }
  } else {
    // dB[j][n] = sum_{i >= j} dM[i][j] C[i][n] + sum_h sum_p
    //            exp(cum_end - cum_j) u[j][p] Shat[p][n]
    tile_product<false, false>(
        sa, sb, r0, nl,
        [&](int m, int i) { return r0 + m < nl ? dmsum(i, r0 + m) : 0.0f; },
        [&](int i, int m) {
          return n0 + m < N ? bc[((row0 + i) * G + g) * N + n0 + m] : 0.0f;
        },
        acc);
    tile_product<true, false>(
        sa, sb, 0, rep * P,
        [&](int m, int k) {
          const int j = r0 + m, hh = k / P, p = k % P;
          if (j >= nl) return 0.0f;
          const float* cu = cum + (ch0 + hh) * Q;
          const size_t at = (row0 + j) * H + g * rep + hh;
          return expf(cu[Q - 1] - cu[j]) * dt[at] * x[at * P + p];
        },
        [&](int k, int m) {
          const int hh = k / P, p = k % P;
          return n0 + m < N ? hat[((ch0 + hh) * P + p) * N + n0 + m] : 0.0f;
        },
        acc);
  }
  float* out = is_db ? db : dc;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = r0 + ty * 4 + r, n = n0 + tx * 4 + q;
      if (i < nl && n < N) out[((row0 + i) * G + g) * N + n] = acc[r][q];
    }
}

// 5. da[h] = sum over batches and chunks of the blocks' shares, in order.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ dapart,
                                  float* __restrict__ da, int B, int H,
                                  int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.0f;
  for (int bc = 0; bc < B * nc; ++bc) s += dapart[(size_t)bc * H + h];
  da[h] = s;
}

// The four launches of the forward for element type T; y32 holds y_intra
// in f32 (y itself when T is float, updated in place by the last).
template <class T>
static int launch_forward(const T* x, const float* dt, const float* a,
                          const T* b, const T* c, const float* init_state,
                          T* y, float* y32, float* state_out, float* scratch,
                          int B, int S, int H, int P, int G, int N, int Q,
                          void* stream) {
  if (Q < 1 || Q > MAX_Q || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q, nt = (Q + TILE - 1) / TILE;
  const int n_pt = (P + TILE - 1) / TILE, n_nt = (N + TILE - 1) / TILE;
  float* cbt = scratch;
  float* cum = cbt + (size_t)B * nc * G * Q * Q;
  float* states = cum + (size_t)B * nc * H * Q;
  ssd_scores_kernel<T><<<dim3(nt * (nt + 1) / 2, nc * G, B), NT, 0, st>>>(
      b, c, cbt, S, G, N, Q, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_kernel<T>
      <<<dim3(nt * n_pt + n_pt * n_nt, nc * H, B), NT, 0, st>>>(
          x, dt, a, b, cbt, y32, cum, states, S, H, P, G, N, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_kernel<<<dim3((P * N + NT_STATE - 1) / NT_STATE, H, B),
                     NT_STATE, 0, st>>>(
      init_state, cum, states, state_out, H, P * N, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_inter_kernel<T><<<dim3(nt * n_pt, nc * H, B), NT, 0, st>>>(
      c, cum, states, sizeof(T) == sizeof(float) ? nullptr : y32, y, S, H, P,
      G, N, Q, nc);
  return (int)cudaGetLastError();
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
  return launch_forward<float>(x, dt, a, b, c, init_state, y, y, state_out,
                               scratch, B, S, H, P, G, N, Q, stream);
}

// As ssd_scan for x, b, c and y in bf16 (dt, a, the states and the scratch
// f32); y32, B*S*H*P floats, holds y in f32 until its one rounding.
int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt, const float* a,
                  const __nv_bfloat16* b, const __nv_bfloat16* c,
                  const float* init_state, __nv_bfloat16* y, float* y32,
                  float* state_out, float* scratch, int B, int S, int H,
                  int P, int G, int N, int Q, void* stream) {
  return launch_forward<__nv_bfloat16>(x, dt, a, b, c, init_state, y, y32,
                                       state_out, scratch, B, S, H, P, G, N,
                                       Q, stream);
}
// Floats of scratch ssd_scan_backward needs: the aggregates, then the
// cotangents Shat [B, nc, H, P, N]; each head's dM [B, nc, H, Q, Q]; dcum
// [B, nc, H, Q]; the inter term's share of dcum per n tile [B, nc, H,
// n tiles, Q]; the blocks' shares of da [B, nc, H].
size_t ssd_scan_backward_scratch_floats(int B, int S, int H, int P, int G,
                                        int N, int Q) {
  const size_t nc = (S + Q - 1) / Q, n_nt = (N + TILE - 1) / TILE;
  return (size_t)B * nc * H *
         ((size_t)P * N + (size_t)Q * Q + (size_t)Q + n_nt * Q + 1);
}

// The gradients of ssd_scan's (y, state_out) given their cotangents dy and
// dstate (null: zero): dx, ddt, da [H], db, dc and, unless null, dinit
// [B,H,P,N].  `saved` is the scratch of the forward call on the same
// inputs (its C.B^T, cumsums and entry states); scratch holds
// ssd_scan_backward_scratch_floats(...) floats.  Launches five kernels on
// `stream`, allocates nothing, does not synchronise; the same limits as
// ssd_scan.
int ssd_scan_backward(const float* x, const float* dt, const float* a,
                      const float* b, const float* c, const float* dy,
                      const float* dstate, const float* saved, float* dx,
                      float* ddt, float* da, float* db, float* dc,
                      float* dinit, float* scratch, int B, int S, int H,
                      int P, int G, int N, int Q, void* stream) {
  if (Q < 1 || Q > MAX_Q || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q, nt = (Q + TILE - 1) / TILE;
  const int n_nt = (N + TILE - 1) / TILE;
  const float* cbt = saved;
  const float* cum = cbt + (size_t)B * nc * G * Q * Q;
  const float* states = cum + (size_t)B * nc * H * Q;
  float* hat = scratch;
  float* dm = hat + (size_t)B * nc * H * P * N;
  float* dcum = dm + (size_t)B * nc * H * Q * Q;
  float* dcs = dcum + (size_t)B * nc * H * Q;
  float* dapart = dcs + (size_t)B * nc * H * n_nt * Q;
  ssd_bwd_chunk_kernel<<<dim3(1, nc * H, B), NT, 0, st>>>(
      x, dt, c, dy, cbt, cum, hat, dm, dcum, S, H, P, G, N, Q, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_state_kernel<<<dim3((P * N + NT_STATE - 1) / NT_STATE, H, B),
                         NT_STATE, 0, st>>>(dstate, cum, hat, dinit, H,
                                            P * N, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_group_kernel<<<dim3(2 * nt * n_nt, nc * G, B), NT, 0, st>>>(
      x, dt, b, c, dy, cum, states, hat, dm, db, dc, dcs, S, H, P, G, N, Q,
      nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_du_kernel<<<dim3(1, nc * H, B), NT, 0, st>>>(
      x, dt, a, b, dy, cbt, cum, states, hat, dcum, dcs, dx, ddt, dapart, S,
      H, P, G, N, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_da_kernel<<<(H + 127) / 128, 128, 0, st>>>(dapart, da, B, H, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
