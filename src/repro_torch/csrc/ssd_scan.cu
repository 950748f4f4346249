// Chunked Mamba-2 SSD scan, chunk-parallel, from an initial state: its
// forward and its backward, each in f32 and in bf16.
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
// about 5.6 GFLOP per layer (84 us in f32 on CUDA cores at 67 TFLOP/s),
// against about 101 MB of inputs and outputs in f32 (30 us at 3.35 TB/s).
//
// f32 (ssd_scan), four launches, the decomposition of the plain version
// (kernels/ssd_scan/ref.py):
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
// contraction; no atomics, so two runs are bit-identical.  The f32 forward
// runs on CUDA cores: a single TF32 product cannot hold the plain version's
// 2e-4, and the backward reads the scratch it leaves (C.B^T, the cumsums,
// the entry states) bit for bit.
//
// bf16 (ssd_scan_bf16): the same TPU kernel in the reference's working
// type, x, b, c and y in bf16, dt, a, the states and the scratch in f32, as
// the Pallas kernel takes them (kernel.py:36-40, :75), on tensor cores:
//   1. ssd_scores_bf16_kernel: C.B^T by mma.sync m16n8k16 on the bf16 C
//      and B as they come, f32 sums (a product of two bf16 values is exact
//      in f32: only the order of the sums differs from the f32 algebra);
//   2. ssd_chunk_state_bf16_kernel: the cumsum, then dS with
//      w_j = exp(cum_end - cum_j) dt_j folded into the f32 side (w_j x_j),
//      B_j whole;
//   3. ssd_state_kernel, as in f32;
//   4. ssd_output_bf16_kernel, per (64x64 tile of y, chunk, head): the
//      intra-chunk product with C.B^T o decay o dt on the f32 side and x
//      whole, and the inter term C_i . S_entry^T with C whole, summed in f32
//      and rounded to bf16 once: y makes no f32 round trip through memory.
// Those three products each have one f32 operand.  They run as TF32 on
// mma.sync m16n8k8 with the f32 operand split into a TF32 high part and
// the rest (hi = x with its low 13 mantissa bits clear, lo = x - hi) and
// the bf16 operand whole (exact in TF32: 8 mantissa bits against 10): two
// products where 3xTF32 takes three, within a few parts in 2^20 of the f32
// algebra.  No f32 operand is rounded to bf16.  The inputs' bytes halve
// (about 59 MB at mamba2-1.3b's prefill, 18 us at 3.35 TB/s); the
// operations take about 30 us at the tensor cores' rates (bf16 989, TF32
// 495 TFLOP/s, two passes).
//
// The tensor-core kernels (the bf16 forward's and the backward's) share
// one shape: 128 threads, four warps of 32x32 outputs over a 64x64 tile,
// each contraction in slices of 32 (64 for the bf16 scores) brought by
// cp.async into a ring of three stages, two in flight while one computes;
// operand tiles are kept with a row stride that puts the fragment loads of
// a warp on distinct banks, zero past the shapes' edges (an unaligned
// shape is staged by plain loads instead).  Scale factors (exp(cum),
// dt) are staged once per block in shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NT 256         // threads of a tile-product block (16 x 16 of them)
#define NT_STATE 256   // threads of a state-pass block
#define TILE 64
#define KC 32
#define RS (KC + 4)    // row stride of a slice kept row by row, [TILE][KC]
#define CS (TILE + 4)  // row stride of a slice kept k by k, [KC][TILE]
#define MAX_Q 128
#define CHUNKS_IN_FLIGHT 8
#define FULL 0xffffffffu

typedef __nv_bfloat16 bf16;

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

// cum_s[j] = inclusive cumsum of dt_s[j] * a_h over the chunk (j < Q) by
// the block's first warp: each lane runs over its ceil(Q / 32) steps, then
// the lanes' totals are scanned.
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float* cum_s,
                                             const float* a_h, int Q) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const float ah = *a_h;
    const int per = (Q + 31) / 32;
    float loc[MAX_Q / 32];
    float run = 0.0f;
#pragma unroll
    for (int e = 0; e < MAX_Q / 32; ++e) {
      const int j = lane * per + e;
      if (e < per && j < Q) run = run + dt_s[j] * ah;
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
}

// Every grid of the forward and the backward is one-dimensional in x: the
// kernel indexes an (nx, ny, nz) grid, (tile, chunk and head or group,
// batch) as a rule, and block x is (z * ny + y) * nx + x.  The blocks run
// in the order of that grid, while chunks x heads may pass a grid's y
// limit of 65,535 (mamba2-1.3b's 524,288-token prefill: 4,096 chunks x 64
// heads) and the batch its z limit.  flat() is the host's side.
struct Blk {
  int x, y, z;
};
__device__ __forceinline__ Blk grid_block(int nx, int ny) {
  const int i = blockIdx.x, r = i / nx;
  return {i - r * nx, r % ny, r / ny};
}

// 1. cbt[b,c,g][j][i] = B_j . C_i for the tile pair (jt <= it).
__global__ void __launch_bounds__(NT) ssd_scores_kernel(
    const float* __restrict__ bm, const float* __restrict__ cm,
    float* __restrict__ cbt, int S, int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sa[TILE * RS];
  __shared__ __align__(16) float sb[TILE * RS];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nt = (Q + TILE - 1) / TILE;
  const Blk blk = grid_block(nt * (nt + 1) / 2, nc * G);
  int jt = blk.x, it = 0;  // the tile enumerates (jt <= it)
  while (jt > it) {
    jt -= it + 1;
    ++it;
  }
  const int c = blk.y % nc, g = blk.y / nc, b = blk.z;
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
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_pt = (P + TILE - 1) / TILE;
  const int n_yt = (Q + TILE - 1) / TILE * n_pt;
  const Blk blk = grid_block(n_yt + n_pt * ((N + TILE - 1) / TILE), nc * H);
  const int tile = blk.x, c = blk.y % nc, h = blk.y / nc, b = blk.z;
  const int g = h / (H / G);
  const int t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h;  // (batch, chunk, head)

  for (int j = tid; j < Q; j += NT)
    dt_s[j] = j < nl ? dt[(size_t)(b * S + t0 + j) * H + h] : 0.0f;
  __syncthreads();
  chunk_cumsum(dt_s, cum_s, a + h, Q);
  __syncthreads();
  if (tile == 0)
    for (int j = tid; j < Q; j += NT) cum[ch * Q + j] = cum_s[j];

  float acc[4][4] = {};
  if (tile < n_yt) {
    // y_intra[i][p] = sum_{j<=i} cbt[j][i] exp(min(cum_i - cum_j, 0))
    //                 dt_j x[j][p]
    const int i0 = tile / n_pt * TILE, p0 = tile % n_pt * TILE;
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
    const int n_nt = (N + TILE - 1) / TILE, st = tile - n_yt;
    const int p0 = st / n_nt * TILE, n0 = st % n_nt * TILE;
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
  const Blk blk = grid_block((PN + NT_STATE - 1) / NT_STATE, H);
  const int e = blk.x * NT_STATE + threadIdx.x, h = blk.y, b = blk.z;
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

// 4. y[i][p] += exp(cum_i) sum_n C[i][n] S_entry[p][n], in place.
// Bounded to five blocks an SM (at most 51 registers a thread), which made
// it faster at mamba2-1.3b's prefill on an H100; the same bound made the
// other two products slower.
__global__ void __launch_bounds__(NT, 5)
    ssd_inter_kernel(const float* __restrict__ cm,
                     const float* __restrict__ cum,
                     const float* __restrict__ states, float* __restrict__ y,
                     int S, int H, int P, int G, int N, int Q, int nc) {
  __shared__ __align__(16) float sa[TILE * RS];
  __shared__ __align__(16) float sb[TILE * RS];
  const int n_pt = (P + TILE - 1) / TILE;
  const Blk blk = grid_block((Q + TILE - 1) / TILE * n_pt, nc * H);
  const int tile = blk.x, c = blk.y % nc, h = blk.y / nc, b = blk.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int g = h / (H / G);
  const int t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h;
  const int i0 = tile / n_pt * TILE, p0 = tile % n_pt * TILE;
  const float* sp = states + ch * P * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < TILE * KC; e += NT) {
      const int m = e / KC, kk = e % KC, n = k0 + kk;
      const int i = i0 + m, p = p0 + m;
      sa[m * RS + kk] =
          i < nl && n < N ? cm[((size_t)(b * S + t0 + i) * G + g) * N + n]
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
        y[at] = y[at] + w * acc[r][q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core blocks: 128 threads, warp w owns rows 32 (w / 2) and columns
// 32 (w % 2) of a 64x64 output tile, the contraction in slices through a
// cp.async ring.
// ---------------------------------------------------------------------------

#define TT 128             // threads of a tensor-core block
#define KS 32              // contraction slice of a ring stage
#define LDR (KS + 4)       // f32 row stride of a slice kept row by row
#define LDK (TILE + 8)     // f32 row stride of a slice kept k by k
#define SLICE (TILE * LDR)  // floats of one operand's slice in a stage
#define RING 3             // ring stages
#define MT (TILE + 4)      // f32 row stride of a whole 64x64 tile
#define LDH (TILE + 8)     // bf16 row stride, [TILE][64] or [KS][TILE]
#define LDHR (KS + 8)      // bf16 row stride, [TILE][KS]
#define RING_FLOATS (RING * 2 * SLICE)
static_assert(TILE * LDR == KS * LDK, "both slice shapes fill a stage");

// 16 bytes from device to shared memory, zeros where !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float zero_like(float) { return 0.0f; }
__device__ __forceinline__ bf16 zero_like(bf16) {
  return __float2bfloat16(0.0f);
}

// Rows [0, rows) and columns [0, cols) of the row-major matrix at src (row
// stride lds elements) into dst (row stride ld elements): rows below nr and
// columns below nc copied, zeros elsewhere.  By cp.async, 16 bytes a copy,
// when every row starts on 16 bytes and the copies do not cross nc; else
// by plain loads and stores (shapes off the alignment).  `safe` is an
// address that a copy of zero bytes may name.
template <class T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      size_t lds, int rows, int cols, int nr,
                                      int nc, const T* safe) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = lds % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (nc >= cols || nc % V == 0);
  if (vec) {
    const int per = cols / V;
    for (int e = threadIdx.x; e < rows * per; e += TT) {
      const int r = e / per, c = e % per * V;
      const bool ok = r < nr && c < nc;
      cp_async16(dst + r * ld + c, ok ? src + r * lds + c : safe, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += TT) {
      const int r = e / cols, c = e % cols;
      dst[r * ld + c] = r < nr && c < nc ? src[r * lds + c] : zero_like(T());
    }
  }
}

// Runs n slices through the ring: stage(s, buf) issues slice s into stage
// buffer buf, compute(s, buf) consumes it; two slices in flight while one
// computes.  Every thread of the block calls it.
template <class Stage, class Compute>
__device__ __forceinline__ void ring_run(int n, Stage stage_slice,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n) stage_slice(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // slice s landed; the buffer of slice s - 1 is free
    if (s + RING - 1 < n) stage_slice(s + RING - 1, (s + RING - 1) % RING);
    cp_async_commit();
    compute(s, s % RING);
  }
  cp_async_wait<0>();
}

// x as TF32 hi + lo: hi is x with its low 13 mantissa bits clear, lo is
// x - hi (exact), of which the tensor core takes the TF32 part.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

typedef float Acc[2][4][4];  // a warp's 32x32 outputs, mma's C layout

// The tile row and column of this thread's accumulator element [mf][nf][e].
__device__ __forceinline__ int acc_row(int mf, int e) {
  return 32 * (threadIdx.x >> 6) + 16 * mf + ((threadIdx.x & 31) >> 2) +
         8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int nf, int e) {
  return 32 * ((threadIdx.x >> 5) & 1) + 8 * nf + 2 * (threadIdx.x & 3) +
         (e & 1);
}

// acc += A.B over one KS-deep slice on mma.sync m16n8k8 (TF32), A(m, k) and
// B(k, n) given by fa and fb over the block's tile.  A split operand (SA,
// SB) is f32 taken as hi + lo; the other must be exact in TF32 (a bf16
// value).  Both split: 3xTF32 (lo.hi + hi.lo + hi.hi); one: two products
// (lo then hi).  The small terms first.
template <bool SA, bool SB, class FA, class FB>
__device__ __forceinline__ void slice_mma(Acc& acc, FA fa, FB fb) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (w >> 1) + g, n0 = 32 * (w & 1) + g;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 8) {
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = fa(m0 + 16 * mf + 8 * (i & 1), kk + t + 4 * (i >> 1));
        if constexpr (SA) split_tf32(v, ah[mf][i], al[mf][i]);
        else ah[mf][i] = __float_as_uint(v);
      }
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = fb(kk + t + 4 * i, n0 + 8 * nf);
        if constexpr (SB) split_tf32(v, bh[nf][i], bl[nf][i]);
        else bh[nf][i] = __float_as_uint(v);
      }
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        if constexpr (SA) mma_tf32(acc[mf][nf], al[mf], bh[nf][0], bh[nf][1]);
        if constexpr (SB) mma_tf32(acc[mf][nf], ah[mf], bl[nf][0], bl[nf][1]);
        mma_tf32(acc[mf][nf], ah[mf], bh[nf][0], bh[nf][1]);
      }
  }
}

// acc += A.B over a DEPTH-deep bf16 slice on mma.sync m16n8k16: A(m, k) =
// a[m * LD + k], B(k, n) = b[n * LD + k] (both kept with k contiguous).
template <int DEPTH, int LD>
__device__ __forceinline__ void slice_mma_bf16_ld(Acc& acc, const bf16* a,
                                                  const bf16* b) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (w >> 1) + g, n0 = 32 * (w & 1) + g;
  auto u32 = [](const bf16* p) {
    return *reinterpret_cast<const unsigned*>(p);
  };
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 16) {
    unsigned af[2][4], bf[4][2];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
      const bf16* p = a + (m0 + 16 * mf) * LD + kk + 2 * t;
      af[mf][0] = u32(p);
      af[mf][1] = u32(p + 8 * LD);
      af[mf][2] = u32(p + 8);
      af[mf][3] = u32(p + 8 * LD + 8);
    }
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      const bf16* q = b + (n0 + 8 * nf) * LD + kk + 2 * t;
      bf[nf][0] = u32(q);
      bf[nf][1] = u32(q + 8);
    }
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
        mma_bf16(acc[mf][nf], af[mf], bf[nf][0], bf[nf][1]);
  }
}

// acc += A.B over a 64-deep bf16 slice: A(m, k) = a[m * LDH + k], B(k, n) =
// b[n * LDH + k].
__device__ __forceinline__ void slice_mma_bf16(Acc& acc, const bf16* a,
                                               const bf16* b) {
  slice_mma_bf16_ld<64, LDH>(acc, a, b);
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.0f;
}

// The sum over the tile's 64 columns of v's row threadIdx.x (threads below
// 64; 0 for the others), in a fixed order: each thread's 8 values of a row,
// then the row's four lanes by shuffles, then its two warps in order.  red
// holds 2 * TILE floats of shared memory; every thread of the block calls.
__device__ __forceinline__ float row_sums(const Acc& v, float* red) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 1;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = 0.0f;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
        s += v[mf][nf][2 * half] + v[mf][nf][2 * half + 1];
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      if ((lane & 3) == 0) red[wn * TILE + acc_row(mf, 2 * half)] = s;
    }
  __syncthreads();
  const float r = threadIdx.x < TILE
                      ? red[threadIdx.x] + red[TILE + threadIdx.x]
                      : 0.0f;
  __syncthreads();
  return r;
}

// As row_sums, over the tile's 64 rows of v's column threadIdx.x.
__device__ __forceinline__ float col_sums(const Acc& v, float* red) {
  const int lane = threadIdx.x & 31, wm = threadIdx.x >> 6;
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      float s = (v[0][nf][e1] + v[0][nf][2 + e1]) +
                (v[1][nf][e1] + v[1][nf][2 + e1]);
      s += __shfl_xor_sync(FULL, s, 4);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (lane < 4) red[wm * TILE + acc_col(nf, e1)] = s;
    }
  __syncthreads();
  const float r = threadIdx.x < TILE
                      ? red[threadIdx.x] + red[TILE + threadIdx.x]
                      : 0.0f;
  __syncthreads();
  return r;
}

// The tile pair (jt <= it) that t enumerates.
__device__ __forceinline__ void tile_pair(int t, int& jt, int& it) {
  jt = t;
  it = 0;
  while (jt > it) {
    jt -= it + 1;
    ++it;
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward on tensor cores
// ---------------------------------------------------------------------------

// 1. cbt[b,c,g][j][i] = B_j . C_i for the tile pair (jt <= it), bf16
// products, f32 sums.
__global__ void __launch_bounds__(TT) ssd_scores_bf16_kernel(
    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
    float* __restrict__ cbt, int S, int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (Q + TILE - 1) / TILE;
  const Blk blk = grid_block(nt * (nt + 1) / 2, nc * G);
  int jt, it;
  tile_pair(blk.x, jt, it);
  const int c = blk.y % nc, g = blk.y / nc, b = blk.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  const int j0 = jt * TILE, i0 = it * TILE;
  const size_t gn = (size_t)G * N;
  const bf16* bg = bm + ((size_t)b * S + t0) * gn + (size_t)g * N;
  const bf16* cg = cm + ((size_t)b * S + t0) * gn + (size_t)g * N;
  Acc acc = {};
  ring_run(
      (N + 63) / 64,
      [&](int s, int buf) {
        bf16* sa = reinterpret_cast<bf16*>(smem + buf * 2 * SLICE);
        bf16* sb = reinterpret_cast<bf16*>(smem + buf * 2 * SLICE + SLICE);
        stage(sa, LDH, bg + j0 * gn + s * 64, gn, TILE, 64, nl - j0,
              N - s * 64, bg);
        stage(sb, LDH, cg + i0 * gn + s * 64, gn, TILE, 64, nl - i0,
              N - s * 64, cg);
      },
      [&](int, int buf) {
        slice_mma_bf16(
            acc, reinterpret_cast<const bf16*>(smem + buf * 2 * SLICE),
            reinterpret_cast<const bf16*>(smem + buf * 2 * SLICE + SLICE));
      });
  float* out = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + acc_row(mf, e), i = i0 + acc_col(nf, e);
        if (j < Q && i < Q) out[(size_t)j * Q + i] = acc[mf][nf][e];
      }
}

// 2. The chunk's cumsum, then one 64x64 tile of the chunk's own state
// dS[p][n] = sum_j (w_j x[j][p]) B[j][n], w_j = dt_j exp(cum_end - cum_j).
__global__ void __launch_bounds__(TT) ssd_chunk_state_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const bf16* __restrict__ bm,
    float* __restrict__ cum, float* __restrict__ dstate, int S, int H, int P,
    int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* dt_s = smem + RING_FLOATS;
  float* cum_s = dt_s + MAX_Q;
  float* w_s = cum_s + MAX_Q;
  const int n_nt = (N + TILE - 1) / TILE;
  const Blk blk = grid_block((P + TILE - 1) / TILE * n_nt, nc * H);
  const int tile = blk.x, p0 = tile / n_nt * TILE, n0 = tile % n_nt * TILE;
  const int c = blk.y % nc, h = blk.y / nc, b = blk.z;
  const int g = h / (H / G), t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h, row0 = (size_t)b * S + t0;
  for (int j = threadIdx.x; j < Q; j += TT)
    dt_s[j] = j < nl ? dt[(row0 + j) * H + h] : 0.0f;
  __syncthreads();
  chunk_cumsum(dt_s, cum_s, a + h, Q);
  __syncthreads();
  if (tile == 0)
    for (int j = threadIdx.x; j < Q; j += TT) cum[ch * Q + j] = cum_s[j];
  const float cum_end = cum_s[Q - 1];
  for (int j = threadIdx.x; j < MAX_Q; j += TT)
    w_s[j] = j < nl ? dt_s[j] * expf(cum_end - cum_s[j]) : 0.0f;

  const size_t hp = (size_t)H * P, gn = (size_t)G * N;
  const bf16* xh = x + row0 * hp + (size_t)h * P;
  const bf16* bg = bm + row0 * gn + (size_t)g * N;
  Acc acc = {};
  ring_run(
      (nl + KS - 1) / KS,
      [&](int s, int buf) {
        bf16* sa = reinterpret_cast<bf16*>(smem + buf * 2 * SLICE);
        bf16* sb = reinterpret_cast<bf16*>(smem + buf * 2 * SLICE + SLICE);
        const int k0 = s * KS;
        stage(sa, LDH, xh + k0 * hp + p0, hp, KS, TILE, nl - k0, P - p0, xh);
        stage(sb, LDH, bg + k0 * gn + n0, gn, KS, TILE, nl - k0, N - n0, bg);
      },
      [&](int s, int buf) {
        const bf16* sa = reinterpret_cast<const bf16*>(smem + buf * 2 * SLICE);
        const bf16* sb =
            reinterpret_cast<const bf16*>(smem + buf * 2 * SLICE + SLICE);
        const float* w = w_s + s * KS;
        slice_mma<true, false>(
            acc,
            [&](int m, int k) { return __bfloat162float(sa[k * LDH + m]) * w[k]; },
            [&](int k, int n) { return __bfloat162float(sb[k * LDH + n]); });
      });
  float* ds = dstate + ch * P * N;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + acc_row(mf, e), n = n0 + acc_col(nf, e);
        if (p < P && n < N) ds[(size_t)p * N + n] = acc[mf][nf][e];
      }
}

// 4. y[i][p] = bf16(sum_{j<=i} (cbt[j][i] exp(min(cum_i - cum_j, 0)) dt_j)
// x[j][p] + exp(cum_i) sum_n C[i][n] S_entry[p][n]) for a 64x64 tile.
__global__ void __launch_bounds__(TT) ssd_output_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const bf16* __restrict__ cm, const float* __restrict__ cbt,
    const float* __restrict__ cum, const float* __restrict__ states,
    bf16* __restrict__ y, int S, int H, int P, int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* cum_s = smem + RING_FLOATS;
  float* dt_s = cum_s + MAX_Q;
  const int n_pt = (P + TILE - 1) / TILE;
  const Blk blk = grid_block((Q + TILE - 1) / TILE * n_pt, nc * H);
  const int i0 = blk.x / n_pt * TILE, p0 = blk.x % n_pt * TILE;
  const int c = blk.y % nc, h = blk.y / nc, b = blk.z;
  const int g = h / (H / G), t0 = c * Q, nl = min(Q, S - t0);
  if (i0 >= nl) return;
  const size_t ch = (size_t)(b * nc + c) * H + h, row0 = (size_t)b * S + t0;
  for (int j = threadIdx.x; j < MAX_Q; j += TT) {
    cum_s[j] = j < Q ? cum[ch * Q + j] : 0.0f;
    dt_s[j] = j < nl ? dt[(row0 + j) * H + h] : 0.0f;
  }
  const size_t hp = (size_t)H * P, gn = (size_t)G * N;
  const float* mg = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
  const bf16* xh = x + row0 * hp + (size_t)h * P;
  const bf16* cg = cm + row0 * gn + (size_t)g * N;
  const float* sp = states + ch * P * N;
  const int k_hi = min(nl, i0 + TILE);
  const int n1 = (k_hi + KS - 1) / KS, n2 = (N + KS - 1) / KS;
  Acc ai = {}, ae = {};
  ring_run(
      n1 + n2,
      [&](int s, int buf) {
        float* sa = smem + buf * 2 * SLICE;
        float* sb = sa + SLICE;
        if (s < n1) {  // cbt rows j, columns i; x rows j, columns p
          const int k0 = s * KS;
          stage(sa, LDK, mg + (size_t)k0 * Q + i0, Q, KS, TILE, k_hi - k0,
                Q - i0, mg);
          stage(reinterpret_cast<bf16*>(sb), LDH, xh + k0 * hp + p0, hp, KS,
                TILE, k_hi - k0, P - p0, xh);
        } else {  // C rows i, columns n; S rows p, columns n
          const int n0 = (s - n1) * KS;
          stage(reinterpret_cast<bf16*>(sa), LDHR, cg + i0 * gn + n0, gn,
                TILE, KS, nl - i0, N - n0, cg);
          stage(sb, LDR, sp + (size_t)p0 * N + n0, (size_t)N, TILE, KS,
                P - p0, N - n0, sp);
        }
      },
      [&](int s, int buf) {
        float* sa = smem + buf * 2 * SLICE;
        const float* sb = sa + SLICE;
        if (s < n1) {
          // the slice of C.B^T becomes C.B^T o decay o dt, once
          const int k0 = s * KS;
          for (int e = threadIdx.x; e < KS * TILE; e += TT) {
            const int k = e / TILE, m = e % TILE, i = i0 + m, j = k0 + k;
            float& v = sa[k * LDK + m];
            v = j <= i ? v * expf(fminf(cum_s[i] - cum_s[j], 0.0f)) * dt_s[j]
                       : 0.0f;
          }
          __syncthreads();
          const bf16* xb = reinterpret_cast<const bf16*>(sb);
          slice_mma<true, false>(
              ai, [&](int m, int k) { return sa[k * LDK + m]; },
              [&](int k, int n) { return __bfloat162float(xb[k * LDH + n]); });
        } else {
          const bf16* cb = reinterpret_cast<const bf16*>(sa);
          slice_mma<false, true>(
              ae,
              [&](int m, int k) { return __bfloat162float(cb[m * LDHR + k]); },
              [&](int k, int n) { return sb[n * LDR + k]; });
        }
      });
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + acc_row(mf, e), p = p0 + acc_col(nf, e);
        if (i < nl && p < P)
          y[((row0 + i) * H + h) * P + p] = __float2bfloat16(
              ai[mf][nf][e] + expf(cum_s[i]) * ae[mf][nf][e]);
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
//   dB_j  = sum_i dM_ij C_i + sum_h exp(cum_end - cum_j) dt_j Shat_c^T x_j
// and dcum (from E, the inter term and the state update), whose reverse
// in-chunk cumsum dl gives ddt_j = x_j . du_j + a dl_j and da = sum dt dl.
// E's diagonal adds g and -g to the same dcum_i, so the sums leave it out.
// The inter term's share of dcum_i is C_i . (exp(cum_i) S_{c-1}^T dy_i),
// the dot of C_i with the head's state term of dC, which the dC blocks
// form anyway.  The plain mirror is ssd_bwd_ref in kernels/ssd_scan/ref.py
// (with tf32x3 it takes the products as the tensor cores below do).
//
// What bounds it: operations.  At mamba2-1.3b's training shape (4 x 512
// tokens, 64 heads over 8 groups, P 64, N 128, Q 128) the per-head
// products (the state aggregate, Shat B_j, dC's and dB's state terms:
// 8 nl P N a chunk; dy u^T and (M o E)^T dy over the causal half) and dM's
// two products per group come to about 11.3 GFLOP per layer (0.17 ms in
// f32 on CUDA cores at 67 TFLOP/s, 0.069 ms as 3xTF32 at 165), against
// about 180 MB read and written.
//
// Every product runs on the tensor cores as 3xTF32 (mma.sync m16n8k8, each
// f32 operand split into TF32 hi + lo, a.b = lo.hi + hi.lo + hi.hi with f32
// sums; the dropped lo.lo and lo's own cut come to a few parts in 2^20, so
// the gradients stay within 1e-4 of each one's largest entry).  Seven
// launches, each product a 64x64 tile of 128 threads through the ring:
//   1. ssd_bwd_agg_kernel, per (P x N tile, chunk, head): the chunk's
//      aggregate sum_i exp(cum_i) dy_i (x) C_i;
//   2. ssd_bwd_dm_kernel, per (causal tile pair, chunk, group): walks the
//      group's heads in order, forming dy^h u^h^T, E^h and the head's
//      share of dM, adding it to the group's sum in registers, and the row
//      and column sums of M o dM^h below the diagonal (written per tile);
//      the group's dM is written once (no per-head dM in memory);
//   3. ssd_bwd_state_kernel, the reverse state pass from dstate, writing
//      each chunk's Shat_c over its aggregate, and dinit;
//   4. ssd_bwd_dcdb_kernel, per (64x64 tile of dC or dB, chunk, group): dM
//      with B or C, then each head's state term in head order (its rows
//      scaled after the product); a dC block also writes each head's
//      C_i . (state term) over its columns;
//   5. ssd_bwd_du_kernel, per (64x64 tile of du, chunk, head): (M o E)^T dy
//      and B Shat^T, then dx, and x . du and u . (state du) over the tile's
//      columns;
//   6. ssd_bwd_dcum_kernel, per (chunk, head): the tile sums added in
//      order, <Shat_c, S_{c-1}>, the reverse cumsum, ddt and the block's
//      share of da;
//   7. ssd_bwd_da_kernel: da summed over batches and chunks in order.
// Row and column sums run by shuffles in a fixed order, then across warps
// and tiles in index order; no atomics, so two runs are bit-identical.
//
// bf16 (ssd_scan_backward_bf16, for the bf16 forward's training): x, b, c
// and dy in bf16, read in place and held in shared memory as bf16; dt, a,
// dstate, the forward's scratch and every intermediate (cumsums, M, dM,
// Shat, the states) f32; dx, db and dc rounded to bf16 once as they are
// written, ddt, da and dinit f32.  No TPU twin either: the reference's
// gradient is jax.grad of ssd_chunked in bf16.  The same seven launches
// and scratch.  dy.x^T has two bf16 sides; every other product has an f32
// side (dM, M o E, Shat, the entry states, or a bf16 value times an f32
// scale).
//
// What bounds it, at mamba2-1.3b's training shape: bytes, 110.6 MB (x,
// dt, b, c and their gradients 51.4 MB, dy 16.8, the forward's f32
// scratch 42.4) in 0.033 ms at 3.35 TB/s, against 11.35 GFLOP in 0.031 ms
// on bf16 wgmma with every f32 side in three bf16 passes (989 TFLOP/s,
// 989/3 for those); at the mma.sync design's units (dy.x^T on bf16, the
// rest as two TF32 passes at 495/2) operations bound it at 0.0426 ms.
// Seven launches with f32 intermediates in device memory (the aggregates
// and Shat, 33.5 MB, make four trips) cannot reach either: the design's
// answer is the products at the tensor cores' full rate and the operand
// tiles brought by TMA ahead of use (below).
//
// Two designs: on Hopper's wgmma with the f32 sides as three bf16 parts
// (the section "The bf16 backward on Hopper" below), for every shape
// whose strides TMA takes (P and N multiples of 8, Q of 4) with P <= 64
// and N <= 128; otherwise the mma.sync design (the bodies below are templates
// on the input type): dy.x^T on mma.sync m16n8k16 in bf16 with dt_j
// scaling its columns after, every other product as the bf16 forward's,
// two TF32 passes with the f32 side split and the bf16 side whole.

// The backward reads x, b, c and dy in the forward's type T: f32, or bf16
// (ssd_scan_backward_bf16).  A bf16 operand is exact in TF32, so it enters
// a product whole (two TF32 passes where its other side is f32) where an
// f32 one is split (3xTF32); dy.x^T, whose sides are both bf16, runs on
// mma.sync m16n8k16 in bf16.  The kernels' bodies below are templates on
// T; each __global__ kernel is one instance.

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// Row strides of a slice of T kept k by k ([KS][TILE]: K) or row by row
// ([TILE][KS]: R) and of a whole 64x64 tile (M); whether an operand of T is
// split into TF32 hi + lo.
template <class T>
struct Lay;
template <>
struct Lay<float> {
  static constexpr int K = LDK, R = LDR, M = MT;
  static constexpr bool SPLIT = true;
};
template <>
struct Lay<bf16> {
  static constexpr int K = LDH, R = LDHR, M = LDH;
  static constexpr bool SPLIT = false;
};

// 1. agg[p][n] = sum_i exp(cum_i) dy[i][p] C[i][n], a 64x64 tile.
template <class T>
__device__ __forceinline__ void bwd_agg(const T* __restrict__ cm,
                                        const T* __restrict__ dy,
                                        const float* __restrict__ cum,
                                        float* __restrict__ hat, int S, int H,
                                        int P, int G, int N, int Q, int nc,
                                        float* smem) {
  constexpr int LK = Lay<T>::K;
  float* ec = smem + RING_FLOATS;  // exp(cum_i), 0 past the chunk's end
  const int n_nt = (N + TILE - 1) / TILE;
  const Blk blk = grid_block((P + TILE - 1) / TILE * n_nt, nc * H);
  const int p0 = blk.x / n_nt * TILE, n0 = blk.x % n_nt * TILE;
  const int c = blk.y % nc, h = blk.y / nc, b = blk.z;
  const int g = h / (H / G), t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch = (size_t)(b * nc + c) * H + h, row0 = (size_t)b * S + t0;
  for (int i = threadIdx.x; i < MAX_Q; i += TT)
    ec[i] = i < nl ? expf(cum[ch * Q + i]) : 0.0f;
  const size_t hp = (size_t)H * P, gn = (size_t)G * N;
  const T* dyh = dy + row0 * hp + (size_t)h * P;
  const T* cg = cm + row0 * gn + (size_t)g * N;
  Acc acc = {};
  ring_run(
      (nl + KS - 1) / KS,
      [&](int s, int buf) {  // dy rows i, columns p; C rows i, columns n
        T* sa = reinterpret_cast<T*>(smem + buf * 2 * SLICE);
        T* sb = reinterpret_cast<T*>(smem + buf * 2 * SLICE + SLICE);
        const int k0 = s * KS;
        stage(sa, LK, dyh + k0 * hp + p0, hp, KS, TILE, nl - k0, P - p0, dyh);
        stage(sb, LK, cg + k0 * gn + n0, gn, KS, TILE, nl - k0, N - n0, cg);
      },
      [&](int s, int buf) {
        const T* sa = reinterpret_cast<const T*>(smem + buf * 2 * SLICE);
        const T* sb =
            reinterpret_cast<const T*>(smem + buf * 2 * SLICE + SLICE);
        const float* e = ec + s * KS;
        slice_mma<true, Lay<T>::SPLIT>(
            acc, [&](int m, int k) { return f32(sa[k * LK + m]) * e[k]; },
            [&](int k, int n) { return f32(sb[k * LK + n]); });
      });
  float* out = hat + ch * P * N;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + acc_row(mf, e), n = n0 + acc_col(nf, e);
        if (p < P && n < N) out[(size_t)p * N + n] = acc[mf][nf][e];
      }
}

__global__ void __launch_bounds__(TT) ssd_bwd_agg_kernel(
    const float* __restrict__ cm, const float* __restrict__ dy,
    const float* __restrict__ cum, float* __restrict__ hat, int S, int H,
    int P, int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_agg(cm, dy, cum, hat, S, H, P, G, N, Q, nc, smem);
}

__global__ void __launch_bounds__(TT) ssd_bwd_agg_bf16_kernel(
    const bf16* __restrict__ cm, const bf16* __restrict__ dy,
    const float* __restrict__ cum, float* __restrict__ hat, int S, int H,
    int P, int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_agg(cm, dy, cum, hat, S, H, P, G, N, Q, nc, smem);
}

// 2. Per causal tile pair (rows i of tile it, columns j of tile jt <= it),
// chunk and group: for each head of the group in order, dM^h_ij =
// E_ij (dy_i . u_j) on tensor cores, added to the group's dM in registers;
// the head's sums of M o dM^h below the diagonal over the tile's columns
// (rpart [B, nc, H, column tile, Q]) and rows (cpart [B, nc, H, row tile,
// Q]).  The group's dM [B, nc, G, Q, Q] is written once per tile pair.  In
// f32 u_j = dt_j x_j enters the product (3xTF32); in bf16 the product is
// dy . x^T on bf16 operands and dt_j scales its column after.
template <class T>
__device__ __forceinline__ void bwd_dm(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ dy, const float* __restrict__ cbt,
    const float* __restrict__ cum, float* __restrict__ dm,
    float* __restrict__ rpart, float* __restrict__ cpart, int S, int H,
    int P, int G, int Q, int nc, float* smem) {
  constexpr int LR = Lay<T>::R;
  const int rep = H / G;
  float* mt = smem + RING_FLOATS;  // M's tile, [j][i]
  float* cu_i = mt + TILE * MT;    // per head: cum over the row tile
  float* cu_j = cu_i + rep * TILE;  // cum over the column tile
  float* dt_j = cu_j + rep * TILE;  // dt over the column tile
  float* red = dt_j + rep * TILE;
  const int n_qt = (Q + TILE - 1) / TILE;
  const Blk blk = grid_block(n_qt * (n_qt + 1) / 2, nc * G);
  int jt, it;
  tile_pair(blk.x, jt, it);
  const int i0 = it * TILE, j0 = jt * TILE;
  const int c = blk.y % nc, g = blk.y / nc, b = blk.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  const size_t ch0 = (size_t)(b * nc + c) * H + g * rep;  // head 0 of g
  const size_t row0 = (size_t)b * S + t0;
  const float* mg = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
  stage(mt, MT, mg + (size_t)j0 * Q + i0, (size_t)Q, TILE, TILE, Q - j0,
        Q - i0, mg);  // lands with the ring's first slice
  for (int e = threadIdx.x; e < rep * TILE; e += TT) {
    const int hh = e / TILE, r = e % TILE;
    const float* cu = cum + (ch0 + hh) * Q;
    cu_i[e] = i0 + r < Q ? cu[i0 + r] : 0.0f;
    cu_j[e] = j0 + r < Q ? cu[j0 + r] : 0.0f;
    dt_j[e] = j0 + r < nl ? dt[(row0 + j0 + r) * H + g * rep + hh] : 0.0f;
  }
  const size_t hp = (size_t)H * P;
  const T* dyg = dy + row0 * hp + (size_t)g * rep * P;
  const T* xg = x + row0 * hp + (size_t)g * rep * P;
  const int n_ps = (P + KS - 1) / KS;
  Acc dacc = {}, hacc;
  ring_run(
      rep * n_ps,
      [&](int s, int buf) {  // dy^h rows i, x^h rows j, columns p
        const int hh = s / n_ps, k0 = s % n_ps * KS;
        T* sa = reinterpret_cast<T*>(smem + buf * 2 * SLICE);
        T* sb = reinterpret_cast<T*>(smem + buf * 2 * SLICE + SLICE);
        stage(sa, LR, dyg + i0 * hp + hh * P + k0, hp, TILE, KS, nl - i0,
              P - k0, dyg);
        stage(sb, LR, xg + j0 * hp + hh * P + k0, hp, TILE, KS, nl - j0,
              P - k0, xg);
      },
      [&](int s, int buf) {
        const int hh = s / n_ps, ps = s % n_ps;
        const T* sa = reinterpret_cast<const T*>(smem + buf * 2 * SLICE);
        const T* sb =
            reinterpret_cast<const T*>(smem + buf * 2 * SLICE + SLICE);
        const float* dth = dt_j + hh * TILE;
        if (ps == 0) zero_acc(hacc);
        if constexpr (Lay<T>::SPLIT)
          slice_mma<true, true>(
              hacc, [&](int m, int k) { return sa[m * LR + k]; },
              [&](int k, int n) { return sb[n * LR + k] * dth[n]; });
        else
          slice_mma_bf16_ld<KS, LR>(hacc, sa, sb);
        if (ps < n_ps - 1) return;
        // head hh: E o (dy u^T), its share of dM, M o dM^h below the diagonal
        const float* ci = cu_i + hh * TILE;
        const float* cj = cu_j + hh * TILE;
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = acc_row(mf, e), q = acc_col(nf, e);
              const int i = i0 + r, j = j0 + q;
              float d = 0.0f, gm = 0.0f;
              if (j <= i && i < nl) {
                if constexpr (Lay<T>::SPLIT)
                  d = expf(fminf(ci[r] - cj[q], 0.0f)) * hacc[mf][nf][e];
                else
                  d = expf(fminf(ci[r] - cj[q], 0.0f)) *
                      (dth[q] * hacc[mf][nf][e]);
                if (j < i) gm = mt[q * MT + r] * d;
              }
              dacc[mf][nf][e] += d;
              hacc[mf][nf][e] = gm;
            }
        const float rs = row_sums(hacc, red);
        if (threadIdx.x < TILE && i0 + threadIdx.x < Q)
          rpart[((ch0 + hh) * n_qt + jt) * Q + i0 + threadIdx.x] = rs;
        const float cs = col_sums(hacc, red);
        if (threadIdx.x < TILE && j0 + threadIdx.x < Q)
          cpart[((ch0 + hh) * n_qt + it) * Q + j0 + threadIdx.x] = cs;
      });
  float* dmg = dm + ((size_t)(b * nc + c) * G + g) * Q * Q;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + acc_row(mf, e), j = j0 + acc_col(nf, e);
        if (i < Q && j < Q) dmg[(size_t)i * Q + j] = dacc[mf][nf][e];
      }
}

__global__ void __launch_bounds__(TT) ssd_bwd_dm_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ dy, const float* __restrict__ cbt,
    const float* __restrict__ cum, float* __restrict__ dm,
    float* __restrict__ rpart, float* __restrict__ cpart, int S, int H,
    int P, int G, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_dm(x, dt, dy, cbt, cum, dm, rpart, cpart, S, H, P, G, Q, nc, smem);
}

__global__ void __launch_bounds__(TT) ssd_bwd_dm_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const bf16* __restrict__ dy, const float* __restrict__ cbt,
    const float* __restrict__ cum, float* __restrict__ dm,
    float* __restrict__ rpart, float* __restrict__ cpart, int S, int H,
    int P, int G, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_dm(x, dt, dy, cbt, cum, dm, rpart, cpart, S, H, P, G, Q, nc, smem);
}

// 3. The reverse state pass: one thread per state element walks the chunks
// from the last, Shat_{c-1} = exp(cum_end) Shat_c + agg_c, writing Shat_c
// over agg_c, and dinit = Shat_{-1}.
__global__ void __launch_bounds__(NT_STATE) ssd_bwd_state_kernel(
    const float* __restrict__ dstate, const float* __restrict__ cum,
    float* __restrict__ hat, float* __restrict__ dinit, int H, int PN,
    int Q, int nc) {
  const Blk blk = grid_block((PN + NT_STATE - 1) / NT_STATE, H);
  const int e = blk.x * NT_STATE + threadIdx.x, h = blk.y, b = blk.z;
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

// 4. One 64x64 tile (rows r0.. of the chunk, columns n0..) of dC (DB
// false) or dB: dM with B (dC_i = sum_{j<=i} dM_ij B_j) or with C (dB_j =
// sum_{i>=j} dM_ij C_i), then each head's state term in head order,
// dy^h S^h (rows scaled by exp(cum_i)) or x^h Shat^h (rows scaled by
// exp(cum_end - cum_j) dt_j); a dC tile writes each head's C_i . (state
// term) over its columns to dcs [B, nc, H, column tile, Q].
template <bool DB, class T>
__device__ __forceinline__ void dcdb_tile(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ dy, const float* __restrict__ cum,
    const float* __restrict__ states, const float* __restrict__ hat,
    const float* __restrict__ dm, T* __restrict__ out,
    float* __restrict__ dcs, int S, int H, int P, int G, int N, int Q,
    int nc, Blk blk, int tile, float* smem) {
  constexpr int LK = Lay<T>::K, LR = Lay<T>::R, LM = Lay<T>::M;
  const int rep = H / G, n_nt = (N + TILE - 1) / TILE;
  const int r0 = tile / n_nt * TILE, n0 = tile % n_nt * TILE;
  const int c = blk.y % nc, g = blk.y / nc, b = blk.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  if (r0 >= nl) return;
  const size_t ch0 = (size_t)(b * nc + c) * H + g * rep;
  const size_t row0 = (size_t)b * S + t0;
  float* sc = smem + RING_FLOATS;  // per head, each row's scale
  T* ct = reinterpret_cast<T*>(sc + rep * TILE);  // dC: C's tile, [i][n]
  float* red = sc + rep * TILE + TILE * MT;
  const size_t hp = (size_t)H * P, gn = (size_t)G * N;
  for (int e = threadIdx.x; e < rep * TILE; e += TT) {
    const int hh = e / TILE, i = r0 + e % TILE;
    const float* cu = cum + (ch0 + hh) * Q;
    sc[e] = i >= nl ? 0.0f
            : DB    ? expf(cu[Q - 1] - cu[i]) *
                       dt[(row0 + i) * H + g * rep + hh]
                    : expf(cu[i]);
  }
  const T* cg = cm + row0 * gn + (size_t)g * N;
  if (!DB)
    stage(ct, LM, cg + r0 * gn + n0, gn, TILE, TILE, nl - r0, N - n0, cg);
  const float* dmg = dm + ((size_t)(b * nc + c) * G + g) * Q * Q;
  const T* og = (DB ? cm : bm) + row0 * gn + (size_t)g * N;
  const T* side = (DB ? x : dy) + row0 * hp + (size_t)g * rep * P;
  const float* mats = DB ? hat : states;
  // dM's contraction: j in [0, min(nl, r0 + 64)) for dC, i in [r0, nl) for dB
  const int k_lo = DB ? r0 : 0, k_hi = DB ? nl : min(nl, r0 + TILE);
  const int n1 = (k_hi - k_lo + KS - 1) / KS, n_ps = (P + KS - 1) / KS;
  Acc acc = {}, hacc;
  ring_run(
      n1 + rep * n_ps,
      [&](int s, int buf) {
        float* sa = smem + buf * 2 * SLICE;
        float* sb = sa + SLICE;
        if (s < n1) {
          const int k0 = k_lo + s * KS;
          if (DB)  // dM rows i (the contraction), columns j
            stage(sa, LDK, dmg + (size_t)k0 * Q + r0, (size_t)Q, KS, TILE,
                  nl - k0, nl - r0, dmg);
          else  // dM rows i, columns j (the contraction)
            stage(sa, LDR, dmg + (size_t)r0 * Q + k0, (size_t)Q, TILE, KS,
                  nl - r0, k_hi - k0, dmg);
          stage(reinterpret_cast<T*>(sb), LK, og + k0 * gn + n0, gn, KS,
                TILE, k_hi - k0, N - n0, og);
        } else {  // dy^h or x^h rows r, columns p; S^h or Shat^h rows p
          const int hh = (s - n1) / n_ps, k0 = (s - n1) % n_ps * KS;
          stage(reinterpret_cast<T*>(sa), LR, side + r0 * hp + hh * P + k0,
                hp, TILE, KS, nl - r0, P - k0, side);
          const float* mh = mats + (ch0 + hh) * P * N;
          stage(sb, LDK, mh + (size_t)k0 * N + n0, (size_t)N, KS, TILE,
                P - k0, N - n0, mh);
        }
      },
      [&](int s, int buf) {
        const float* sa = smem + buf * 2 * SLICE;
        const float* sb = sa + SLICE;
        if (s < n1) {
          const T* ob = reinterpret_cast<const T*>(sb);
          auto fo = [&](int k, int n) { return f32(ob[k * LK + n]); };
          if (DB)
            slice_mma<true, Lay<T>::SPLIT>(
                acc, [&](int m, int k) { return sa[k * LDK + m]; }, fo);
          else
            slice_mma<true, Lay<T>::SPLIT>(
                acc, [&](int m, int k) { return sa[m * LDR + k]; }, fo);
          return;
        }
        const int hh = (s - n1) / n_ps, ps = (s - n1) % n_ps;
        if (ps == 0) zero_acc(hacc);
        const T* sd = reinterpret_cast<const T*>(sa);
        slice_mma<Lay<T>::SPLIT, true>(
            hacc, [&](int m, int k) { return f32(sd[m * LR + k]); },
            [&](int k, int n) { return sb[k * LDK + n]; });
        if (ps < n_ps - 1) return;
        const float* sch = sc + hh * TILE;
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = hacc[mf][nf][e] * sch[acc_row(mf, e)];
              acc[mf][nf][e] += v;
              if (!DB)
                hacc[mf][nf][e] =
                    f32(ct[acc_row(mf, e) * LM + acc_col(nf, e)]) * v;
            }
        if (!DB) {
          const float d = row_sums(hacc, red);
          if (threadIdx.x < TILE && r0 + threadIdx.x < nl)
            dcs[((ch0 + hh) * n_nt + n0 / TILE) * Q + r0 + threadIdx.x] = d;
        }
      });
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + acc_row(mf, e), n = n0 + acc_col(nf, e);
        if (r < nl && n < N)
          put(out + (row0 + r) * gn + (size_t)g * N + n, acc[mf][nf][e]);
      }
}

template <class T>
__device__ __forceinline__ void bwd_dcdb(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ dy, const float* __restrict__ cum,
    const float* __restrict__ states, const float* __restrict__ hat,
    const float* __restrict__ dm, T* __restrict__ db, T* __restrict__ dc,
    float* __restrict__ dcs, int S, int H, int P, int G, int N, int Q,
    int nc, float* smem) {
  const int per = (Q + TILE - 1) / TILE * ((N + TILE - 1) / TILE);
  const Blk blk = grid_block(2 * per, nc * G);
  if (blk.x < per)
    dcdb_tile<false>(x, dt, bm, cm, dy, cum, states, hat, dm, dc, dcs, S, H,
                     P, G, N, Q, nc, blk, blk.x, smem);
  else
    dcdb_tile<true>(x, dt, bm, cm, dy, cum, states, hat, dm, db, dcs, S, H,
                    P, G, N, Q, nc, blk, blk.x - per, smem);
}

__global__ void __launch_bounds__(TT) ssd_bwd_dcdb_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ dy, const float* __restrict__ cum,
    const float* __restrict__ states, const float* __restrict__ hat,
    const float* __restrict__ dm, float* __restrict__ db,
    float* __restrict__ dc, float* __restrict__ dcs, int S, int H, int P,
    int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_dcdb(x, dt, bm, cm, dy, cum, states, hat, dm, db, dc, dcs, S, H, P, G,
           N, Q, nc, smem);
}

__global__ void __launch_bounds__(TT) ssd_bwd_dcdb_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
    const bf16* __restrict__ dy, const float* __restrict__ cum,
    const float* __restrict__ states, const float* __restrict__ hat,
    const float* __restrict__ dm, bf16* __restrict__ db,
    bf16* __restrict__ dc, float* __restrict__ dcs, int S, int H, int P,
    int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_dcdb(x, dt, bm, cm, dy, cum, states, hat, dm, db, dc, dcs, S, H, P, G,
           N, Q, nc, smem);
}

// 5. One 64x64 tile (rows j0.., columns p0..) of du = (M o E)^T dy +
// exp(cum_end - cum_j) B Shat^T for one head: dx, and the tile's shares of
// x_j . du_j (xdpart) and u_j . (state du_j) (wpart) [B, nc, H, p tile, Q].
template <class T>
__device__ __forceinline__ void bwd_du(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ bm, const T* __restrict__ dy,
    const float* __restrict__ cbt, const float* __restrict__ cum,
    const float* __restrict__ hat, T* __restrict__ dx,
    float* __restrict__ xdpart, float* __restrict__ wpart, int S, int H,
    int P, int G, int N, int Q, int nc, float* smem) {
  constexpr int LK = Lay<T>::K, LR = Lay<T>::R;
  float* cum_s = smem + RING_FLOATS;
  float* dt_s = cum_s + MAX_Q;
  float* red = dt_s + MAX_Q;
  const int n_pt = (P + TILE - 1) / TILE;
  const Blk blk = grid_block((Q + TILE - 1) / TILE * n_pt, nc * H);
  const int pt = blk.x % n_pt;
  const int j0 = blk.x / n_pt * TILE, p0 = pt * TILE;
  const int c = blk.y % nc, h = blk.y / nc, b = blk.z;
  const int g = h / (H / G), t0 = c * Q, nl = min(Q, S - t0);
  if (j0 >= nl) return;
  const size_t ch = (size_t)(b * nc + c) * H + h, row0 = (size_t)b * S + t0;
  for (int j = threadIdx.x; j < MAX_Q; j += TT) {
    cum_s[j] = j < Q ? cum[ch * Q + j] : 0.0f;
    dt_s[j] = j < nl ? dt[(row0 + j) * H + h] : 0.0f;
  }
  const size_t hp = (size_t)H * P, gn = (size_t)G * N;
  const float* mg = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
  const T* dyh = dy + row0 * hp + (size_t)h * P;
  const T* bg = bm + row0 * gn + (size_t)g * N;
  const float* sh = hat + ch * P * N;
  const int n1 = (nl - j0 + KS - 1) / KS, n2 = (N + KS - 1) / KS;
  Acc ai = {}, as = {};
  ring_run(
      n1 + n2,
      [&](int s, int buf) {
        float* sa = smem + buf * 2 * SLICE;
        float* sb = sa + SLICE;
        if (s < n1) {  // cbt rows j, columns i; dy rows i, columns p
          const int k0 = j0 + s * KS;
          stage(sa, LDR, mg + (size_t)j0 * Q + k0, (size_t)Q, TILE, KS,
                Q - j0, nl - k0, mg);
          stage(reinterpret_cast<T*>(sb), LK, dyh + k0 * hp + p0, hp, KS,
                TILE, nl - k0, P - p0, dyh);
        } else {  // B rows j, columns n; Shat rows p, columns n
          const int k0 = (s - n1) * KS;
          stage(reinterpret_cast<T*>(sa), LR, bg + j0 * gn + k0, gn, TILE,
                KS, nl - j0, N - k0, bg);
          stage(sb, LDR, sh + (size_t)p0 * N + k0, (size_t)N, TILE, KS,
                P - p0, N - k0, sh);
        }
      },
      [&](int s, int buf) {
        float* sa = smem + buf * 2 * SLICE;
        const float* sb = sa + SLICE;
        if (s < n1) {
          // the slice of M^T becomes (M o E)^T, once
          const int k0 = j0 + s * KS;
          for (int e = threadIdx.x; e < TILE * KS; e += TT) {
            const int m = e / KS, k = e % KS, j = j0 + m, i = k0 + k;
            float& v = sa[m * LDR + k];
            v = i >= j ? v * expf(fminf(cum_s[i] - cum_s[j], 0.0f)) : 0.0f;
          }
          __syncthreads();
          const T* dys = reinterpret_cast<const T*>(sb);
          slice_mma<true, Lay<T>::SPLIT>(
              ai, [&](int m, int k) { return sa[m * LDR + k]; },
              [&](int k, int n) { return f32(dys[k * LK + n]); });
        } else {
          const T* bs = reinterpret_cast<const T*>(sa);
          slice_mma<Lay<T>::SPLIT, true>(
              as, [&](int m, int k) { return f32(bs[m * LR + k]); },
              [&](int k, int n) { return sb[n * LDR + k]; });
        }
      });
  const float cum_end = cum_s[Q - 1];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + acc_row(mf, e), p = p0 + acc_col(nf, e);
        const bool live = j < nl && p < P;
        const size_t at = ((row0 + j) * H + h) * P + p;
        const float xs = live ? f32(x[at]) : 0.0f;
        const float sd =
            live ? expf(cum_end - cum_s[j]) * as[mf][nf][e] : 0.0f;
        const float du = ai[mf][nf][e] + sd;
        if (live) put(dx + at, dt_s[j] * du);
        ai[mf][nf][e] = xs * du;                // x_j . du_j
        as[mf][nf][e] = live ? dt_s[j] * xs * sd : 0.0f;  // u_j . (state du)
      }
  const float xd = row_sums(ai, red);
  const size_t part = (ch * n_pt + pt) * Q + j0 + threadIdx.x;
  if (threadIdx.x < TILE && j0 + threadIdx.x < nl) xdpart[part] = xd;
  const float w = row_sums(as, red);
  if (threadIdx.x < TILE && j0 + threadIdx.x < nl) wpart[part] = w;
}

__global__ void __launch_bounds__(TT) ssd_bwd_du_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ dy,
    const float* __restrict__ cbt, const float* __restrict__ cum,
    const float* __restrict__ hat, float* __restrict__ dx,
    float* __restrict__ xdpart, float* __restrict__ wpart, int S, int H,
    int P, int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_du(x, dt, bm, dy, cbt, cum, hat, dx, xdpart, wpart, S, H, P, G, N, Q,
         nc, smem);
}

__global__ void __launch_bounds__(TT) ssd_bwd_du_bf16_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const bf16* __restrict__ bm, const bf16* __restrict__ dy,
    const float* __restrict__ cbt, const float* __restrict__ cum,
    const float* __restrict__ hat, bf16* __restrict__ dx,
    float* __restrict__ xdpart, float* __restrict__ wpart, int S, int H,
    int P, int G, int N, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  bwd_du(x, dt, bm, dy, cbt, cum, hat, dx, xdpart, wpart, S, H, P, G, N, Q,
         nc, smem);
}

// 6. Per (chunk, head): dcum from the tiles' sums (in tile order), then
// d cum_end's own terms (<Shat_c, S_{c-1}> and sum_j w_j), the reverse
// cumsum dl, ddt and the block's share of da.
__global__ void __launch_bounds__(TT) ssd_bwd_dcum_kernel(
    const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ cum, const float* __restrict__ states,
    const float* __restrict__ hat, const float* __restrict__ rpart,
    const float* __restrict__ cpart, const float* __restrict__ dcs,
    const float* __restrict__ xdpart, const float* __restrict__ wpart,
    float* __restrict__ ddt, float* __restrict__ dapart, int S, int H, int P,
    int N, int Q, int nc) {
  __shared__ float dt_s[MAX_Q], dc_s[MAX_Q], w_s[MAX_Q], xd_s[MAX_Q],
      dl_s[MAX_Q], part[TT / 32];
  const Blk blk = grid_block(nc, H);
  const int c = blk.x, h = blk.y, b = blk.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  const int n_qt = (Q + TILE - 1) / TILE, n_nt = (N + TILE - 1) / TILE,
            n_pt = (P + TILE - 1) / TILE;
  const size_t ch = (size_t)(b * nc + c) * H + h, row0 = (size_t)b * S + t0;
  for (int j = threadIdx.x; j < Q; j += TT) {
    float dcj = 0.0f, wj = 0.0f, xdj = 0.0f, dtj = 0.0f;
    if (j < nl) {
      const int jt = j / TILE;
      float rs = 0.0f, cs = 0.0f, it = 0.0f;
      for (int t = 0; t <= jt; ++t) rs += rpart[(ch * n_qt + t) * Q + j];
      for (int t = jt; t < n_qt; ++t) cs += cpart[(ch * n_qt + t) * Q + j];
      for (int t = 0; t < n_nt; ++t) it += dcs[(ch * n_nt + t) * Q + j];
      for (int t = 0; t < n_pt; ++t) {
        xdj += xdpart[(ch * n_pt + t) * Q + j];
        wj += wpart[(ch * n_pt + t) * Q + j];
      }
      dcj = (rs - cs) + it;
      dtj = dt[(row0 + j) * H + h];
    }
    dt_s[j] = dtj;
    dc_s[j] = dcj;
    w_s[j] = wj;
    xd_s[j] = xdj;
  }
  // <Shat_c, S_{c-1}>: each thread's strided part, the warp's by shuffles,
  // the warps' in order
  const float* sh = hat + ch * P * N;
  const float* st = states + ch * P * N;
  float es = 0.0f;
  for (int e = threadIdx.x; e < P * N; e += TT) es = fmaf(sh[e], st[e], es);
  for (int off = 16; off > 0; off >>= 1) es += __shfl_xor_sync(FULL, es, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = es;
  __syncthreads();
  if (threadIdx.x == 0) {
    float dot = 0.0f;
    for (int w = 0; w < TT / 32; ++w) dot += part[w];
    float wsum = 0.0f;
    for (int j = 0; j < Q; ++j) wsum += w_s[j];
    float run = expf(cum[ch * Q + Q - 1]) * dot + wsum;  // d cum_end's terms
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
  for (int j = threadIdx.x; j < nl; j += TT)
    ddt[(row0 + j) * H + h] = xd_s[j] + a_h * dl_s[j];
}

// 7. da[h] = sum over batches and chunks of the blocks' shares, in order.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ dapart,
                                  float* __restrict__ da, int B, int H,
                                  int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.0f;
  for (int bc = 0; bc < B * nc; ++bc) s += dapart[(size_t)bc * H + h];
  da[h] = s;
}

// Dynamic shared memory of a tensor-core kernel: the ring and `extra`
// floats; sets the kernel's limit when it passes 48 KB.
template <class K>
static cudaError_t smem_for(K kernel, size_t extra, size_t* bytes) {
  *bytes = sizeof(float) * (RING_FLOATS + extra);
  if (*bytes > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// The one-dimensional grid of an (nx, ny, nz) grid (grid_block is the
// kernels' side); an empty grid, which fails to launch, past x's limit of
// 2^31 - 1 blocks.
static dim3 flat(long long nx, long long ny, long long nz) {
  const long long n = nx * ny * nz;
  return dim3(n < (1LL << 31) ? (unsigned)n : 0u);
}

#define CHECK(x)                                  \
  do {                                            \
    const cudaError_t e_ = (x);                   \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

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
// 1 <= Q <= 128 and H a multiple of G; any batch and number of chunks
// whose grids stay within 2^31 - 1 blocks (flat(): a launch error past
// it).  Offsets into x, y and the scratch are 64-bit: x may hold more than
// 2^31 elements.
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
  ssd_scores_kernel<<<flat(nt * (nt + 1) / 2, (long long)nc * G, B), NT,
                      0, st>>>(
      b, c, cbt, S, G, N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_chunk_kernel<<<flat(nt * n_pt + n_pt * n_nt, (long long)nc * H, B),
                     NT, 0, st>>>(x, dt, a, b, cbt, y, cum, states, S, H,
                                  P, G, N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_state_kernel<<<flat((P * N + NT_STATE - 1) / NT_STATE, H, B),
                     NT_STATE, 0, st>>>(
      init_state, cum, states, state_out, H, P * N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_inter_kernel<<<flat(nt * n_pt, (long long)nc * H, B), NT, 0, st>>>(
      c, cum, states, y, S, H, P, G, N, Q, nc);
  return (int)cudaGetLastError();
}

// As ssd_scan for x, b, c and y in bf16 (dt, a, the states and the scratch
// f32, the same scratch layout), on tensor cores: four launches.
int ssd_scan_bf16(const bf16* x, const float* dt, const float* a,
                  const bf16* b, const bf16* c, const float* init_state,
                  bf16* y, float* state_out, float* scratch, int B, int S,
                  int H, int P, int G, int N, int Q, void* stream) {
  if (Q < 1 || Q > MAX_Q || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q, nt = (Q + TILE - 1) / TILE;
  const int n_pt = (P + TILE - 1) / TILE, n_nt = (N + TILE - 1) / TILE;
  float* cbt = scratch;
  float* cum = cbt + (size_t)B * nc * G * Q * Q;
  float* states = cum + (size_t)B * nc * H * Q;
  size_t sm_scores, sm_chunk, sm_out;
  CHECK(smem_for(ssd_scores_bf16_kernel, 0, &sm_scores));
  CHECK(smem_for(ssd_chunk_state_bf16_kernel, 3 * MAX_Q, &sm_chunk));
  CHECK(smem_for(ssd_output_bf16_kernel, 2 * MAX_Q, &sm_out));
  ssd_scores_bf16_kernel<<<flat(nt * (nt + 1) / 2, (long long)nc * G, B),
                           TT, sm_scores, st>>>(b, c, cbt, S, G, N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_chunk_state_bf16_kernel<<<flat(n_pt * n_nt, (long long)nc * H, B),
                                TT, sm_chunk, st>>>(x, dt, a, b, cum,
                                                    states, S, H, P, G, N,
                                                    Q, nc);
  CHECK(cudaGetLastError());
  ssd_state_kernel<<<flat((P * N + NT_STATE - 1) / NT_STATE, H, B),
                     NT_STATE, 0, st>>>(
      init_state, cum, states, state_out, H, P * N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_output_bf16_kernel<<<flat(nt * n_pt, (long long)nc * H, B), TT,
                           sm_out, st>>>(x, dt, c, cbt, cum, states, y, S,
                                         H, P, G, N, Q, nc);
  return (int)cudaGetLastError();
}

// Floats of scratch ssd_scan_backward needs: the aggregates, then the
// cotangents Shat [B, nc, H, P, N]; the group's dM [B, nc, G, Q, Q]; the
// sums of M o dM^h by column tile and by row tile [B, nc, H, Q tiles, Q]
// each; the inter term's share of dcum by n tile [B, nc, H, N tiles, Q];
// x . du and u . (state du) by p tile [B, nc, H, P tiles, Q] each; the
// blocks' shares of da [B, nc, H].
size_t ssd_scan_backward_scratch_floats(int B, int S, int H, int P, int G,
                                        int N, int Q) {
  const size_t nc = (S + Q - 1) / Q, n_qt = (Q + TILE - 1) / TILE,
               n_nt = (N + TILE - 1) / TILE, n_pt = (P + TILE - 1) / TILE;
  return (size_t)B * nc *
         ((size_t)H * P * N + (size_t)G * Q * Q +
          (size_t)H * Q * (2 * n_qt + n_nt + 2 * n_pt) + H);
}

}  // extern "C"

// The seven launches of the backward, on the kernels of input type T.
template <class T, class AggK, class DmK, class DcdbK, class DuK>
static int backward(const T* x, const float* dt, const float* a, const T* b,
                    const T* c, const T* dy, const float* dstate,
                    const float* saved, T* dx, float* ddt, float* da, T* db,
                    T* dc, float* dinit, float* scratch, int B, int S, int H,
                    int P, int G, int N, int Q, cudaStream_t st,
                    AggK agg_k, DmK dm_k, DcdbK dcdb_k, DuK du_k) {
  if (Q < 1 || Q > MAX_Q || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q, nt = (Q + TILE - 1) / TILE;
  const int n_nt = (N + TILE - 1) / TILE, n_pt = (P + TILE - 1) / TILE;
  const int rep = H / G;
  const float* cbt = saved;
  const float* cum = cbt + (size_t)B * nc * G * Q * Q;
  const float* states = cum + (size_t)B * nc * H * Q;
  const size_t bch = (size_t)B * nc * H;
  float* hat = scratch;
  float* dm = hat + bch * P * N;
  float* rpart = dm + (size_t)B * nc * G * Q * Q;
  float* cpart = rpart + bch * nt * Q;
  float* dcs = cpart + bch * nt * Q;
  float* xdpart = dcs + bch * n_nt * Q;
  float* wpart = xdpart + bch * n_pt * Q;
  float* dapart = wpart + bch * n_pt * Q;
  size_t sm_agg, sm_dm, sm_dcdb, sm_du;
  CHECK(smem_for(agg_k, MAX_Q, &sm_agg));
  CHECK(smem_for(dm_k, TILE * MT + 3 * rep * TILE + 2 * TILE, &sm_dm));
  CHECK(smem_for(dcdb_k, rep * TILE + TILE * MT + 2 * TILE, &sm_dcdb));
  CHECK(smem_for(du_k, 2 * MAX_Q + 2 * TILE, &sm_du));
  agg_k<<<flat(n_pt * n_nt, (long long)nc * H, B), TT, sm_agg, st>>>(
      c, dy, cum, hat, S, H, P, G, N, Q, nc);
  CHECK(cudaGetLastError());
  dm_k<<<flat(nt * (nt + 1) / 2, (long long)nc * G, B), TT, sm_dm, st>>>(
      x, dt, dy, cbt, cum, dm, rpart, cpart, S, H, P, G, Q, nc);
  CHECK(cudaGetLastError());
  ssd_bwd_state_kernel<<<flat((P * N + NT_STATE - 1) / NT_STATE, H, B),
                         NT_STATE, 0, st>>>(dstate, cum, hat, dinit, H,
                                            P * N, Q, nc);
  CHECK(cudaGetLastError());
  dcdb_k<<<flat(2 * nt * n_nt, (long long)nc * G, B), TT, sm_dcdb, st>>>(
      x, dt, b, c, dy, cum, states, hat, dm, db, dc, dcs, S, H, P, G, N, Q,
      nc);
  CHECK(cudaGetLastError());
  du_k<<<flat(nt * n_pt, (long long)nc * H, B), TT, sm_du, st>>>(
      x, dt, b, dy, cbt, cum, hat, dx, xdpart, wpart, S, H, P, G, N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_bwd_dcum_kernel<<<flat(nc, H, B), TT, 0, st>>>(
      dt, a, cum, states, hat, rpart, cpart, dcs, xdpart, wpart, ddt, dapart,
      S, H, P, N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_bwd_da_kernel<<<(H + 127) / 128, 128, 0, st>>>(dapart, da, B, H, nc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 backward on Hopper: wgmma from TMA rings, f32 sides as three
// exact bf16 parts
// ---------------------------------------------------------------------------
//
// ssd_scan_backward_bf16 for the shapes it takes on this path (P and N
// multiples of 8 and Q of 4, TMA's 16-byte strides; P <= 64, N <= 128,
// one tile of P, two slabs of N; mamba2-1.3b and jamba take it): the same
// seven launches and the same scratch as the mma.sync design that the other
// shapes keep (the templated bodies above, instanced for bf16), with its
// four product kernels redesigned.  Each is one consumer warpgroup and
// one producer warp (160 threads):
//   - the producer takes each operand tile by TMA into a ring of stages
//     with full and empty mbarriers, ahead of the consumers: the bf16 ones
//     (x, dy, b, c: 64 rows of 64 values, the 128-byte swizzle) and the
//     f32 sides (C.B^T, dM, the entry states, Shat: 64 x 64);
//   - the consumers run every product as wgmma m64n64k16 from shared
//     memory, f32 accumulators in registers;
//   - a product with an f32 side (dM, M o E, the states, or a bf16 value
//     times an f32 scale) takes that side as three bf16 parts, hi =
//     bf16(v), mid = bf16(v - hi), lo = v - hi - mid, whose sum is v
//     exactly (24 bits of mantissa in 8 + 8 + 8; away from the bottom of
//     the exponent range, where lo would be subnormal): each part times a
//     bf16 value is exact in f32, so lo.b, mid.b and hi.b (in that order,
//     the small terms first) into one f32 accumulator are the f32 product
//     to the order of its sums.  The consumers write the parts, 64 x 64 a
//     chunk, into shared memory in the swizzled layout (in the aggregates'
//     kernel two buffers, the next head's written while this one's
//     products run); scales along the contraction (exp(cum_i) on dy, E on
//     M) enter before the split, scales of output rows after the product;
//     exponents by ex2.approx.
// The kernels:
//   1. ssd_bwd_agg_hopper_kernel, per (chunk, group): C once, each head's
//      dy through the ring; agg_h = (exp(cum) o dy_h)^T C, N whole;
//   2. ssd_bwd_dm_hopper_kernel, per (causal 64 x 64 tile pair, chunk,
//      group): dy_h.x_h^T on bf16 operands for each head in order, head
//      h + 1's products issued (a group of their own) before head h's
//      epilogue (E, dt, the group's dM in registers, the row and column
//      sums of M o dM^h: rows within a warp by shuffles, each warp's
//      column sums kept in shared memory and added across the warps in
//      order once the heads are done) and waited for after it;
//   3. ssd_bwd_dcdb_hopper_kernel, per (64 rows of dC or dB, 64 columns of
//      N, chunk, group): dM's parts with B or C, then each head's state
//      term, dy_h or x_h with the parts of S_h or Shat_h, its rows scaled
//      after; a dC block's C_i . (state term) per head by shuffles;
//   4. ssd_bwd_du_hopper_kernel, per (64 rows of du, chunk, head): the
//      parts of (M o E)^T with dy, B with the parts of Shat^T, then dx and
//      the row sums x . du and u . (state du) by shuffles (a warp owns
//      whole rows of wgmma's accumulator).
// Sums in a fixed order, no atomics: two runs are bit-identical.

#define HC 128   // consumer threads: one warpgroup
#define HTH 160  // and a producer warp
#define TBYTES 8192   // a 64 x 64 bf16 tile
#define FBYTES 16384  // a 64 x 64 f32 tile
#define PARTS_BYTES (3 * TBYTES)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// A wait that outlasts about 10 s of clock traps: a launch error, not a
// hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > 20000000000LL)
      __trap();
  }
}

// One 64 x 64 box of a 4-d bf16 tensor map at (c0, c1, c2, c3), or of a
// 3-d f32 one at (c0, c1, c2), into shared memory, completing its bytes on
// `bar`.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_f32(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's descriptor of a 64 x 64 bf16 tile at p (rows of 128 bytes, the
// 128-byte swizzle, 1,024-byte aligned): K-major (k contiguous along a
// row; p already offset by the k step's 32 bytes) or MN-major (k down the
// rows; p offset by the k step's 16 rows).
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(16 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of d across the
// asynchronous products.
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The consumers' barrier (named barrier 1, 128 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

#define WG_D8(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7])
#define WG_D32(C, d) \
  WG_D8(C, d), WG_D8(C, (d + 8)), WG_D8(C, (d + 16)), WG_D8(C, (d + 24))

// d (+)= A.B for A [64 x 16] and B [16 x 64], bf16 in shared memory; TA /
// TB: the operand is MN-major (1) or K-major (0); acc 0 writes d only.
template <int TA, int TB>
__device__ __forceinline__ void wg64(float* d, uint64_t da, uint64_t db,
                                     int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_D32("+f", d)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d (+)= A.B over 64 of the contraction for 64 x 64 tiles a and b (four k
// steps of 16): A K-major (row m, k) or MN-major (row k, m); B likewise.
// Past the operands' valid depth one of the two holds zeros.
template <int TA, int TB>
__device__ __forceinline__ void tile_mma(float* d, const unsigned char* a,
                                         const unsigned char* b, int acc) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wg64<TA, TB>(d, tile_desc(a + (TA ? k * 16 * 128 : k * 32)),
                 tile_desc(b + (TB ? k * 16 * 128 : k * 32)), acc || k > 0);
}

// As tile_mma with A given as three parts (lo, mid, hi: 64 x 64 tiles one
// after another at a), the three products in that order; mma_parts with B
// as the three parts.
template <int TA, int TB>
__device__ __forceinline__ void parts_mma(float* d, const unsigned char* a,
                                          const unsigned char* b, int acc) {
#pragma unroll
  for (int part = 0; part < 3; ++part)
    tile_mma<TA, TB>(d, a + part * TBYTES, b, acc || part > 0);
}
template <int TA, int TB>
__device__ __forceinline__ void mma_parts(float* d, const unsigned char* a,
                                          const unsigned char* b, int acc) {
#pragma unroll
  for (int part = 0; part < 3; ++part)
    tile_mma<TA, TB>(d, a, b + part * TBYTES, acc || part > 0);
}

// Byte offset of element (r, c) of a 64 x 64 bf16 tile kept as TMA writes
// it with the 128-byte swizzle: rows of 128 bytes, 16-byte chunk c / 8 of
// row r at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ int sw(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ unsigned bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two values as hi + mid + lo, each a pair of bf16 values (the first in
// the low half), the sums exact (the subtractions are exact and never
// contracted).
__device__ __forceinline__ void split3(float2 v, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(__fsub_rn(v.x, hf.x), __fsub_rn(v.y, hf.y));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = bits2(h);
  mid = bits2(m);
  lo = bits2(__floats2bfloat162_rn(__fsub_rn(r.x, mf.x),
                                   __fsub_rn(r.y, mf.y)));
}

// exp(x) by the SFU's ex2.approx (a few ulps of f32; the bf16 backward's
// decays and scales).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The parts (lo, mid, hi tiles at `parts`) of a 64 x 64 f32 chunk: each of
// the 128 consumers takes 16 pairs (r, c..c+1), 32 pairs a row, v(r, c)
// giving the pair's two values; then the writes are made visible to wgmma
// (the async proxy).  The caller meets the other consumers before a
// product reads them.
template <class F>
__device__ __forceinline__ void write_parts(unsigned char* parts, F v) {
#pragma unroll 8
  for (int u = 0; u < 16; ++u) {
    const int e = threadIdx.x + HC * u, r = e >> 5, c = (e & 31) * 2;
    unsigned hi, mid, lo;
    split3(v(r, c), hi, mid, lo);
    const int at = sw(r, c);
    *reinterpret_cast<unsigned*>(parts + at) = lo;
    *reinterpret_cast<unsigned*>(parts + TBYTES + at) = mid;
    *reinterpret_cast<unsigned*>(parts + 2 * TBYTES + at) = hi;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Elements (r, c) and (r, c + 1) of an f32 tile that TMA wrote (rows of 64
// floats), or element (r, c) of a bf16 one, as f32.
__device__ __forceinline__ float2 f32_at(const unsigned char* t, int r,
                                         int c) {
  return *reinterpret_cast<const float2*>(t + r * 256 + c * 4);
}
__device__ __forceinline__ float tile_at(const unsigned char* t, int r,
                                         int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(t + sw(r, c)));
}

// wgmma's accumulator of a 64 x 64 product: element 4 jj + 2 i2 + c of
// this consumer is row acc_r(i2), column acc_c(jj, c).
__device__ __forceinline__ int acc_r(int i2) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * i2;
}
__device__ __forceinline__ int acc_c(int jj, int c) {
  return 8 * jj + 2 * (threadIdx.x & 3) + c;
}

// The sum over a row of the accumulator's 64 columns, in the layout's
// order: this thread's 16 values, then its quad's four lanes by shuffles
// (the same in all four lanes).
__device__ __forceinline__ float quad_row_sum(const float* v, int i2) {
  float s = 0.0f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    s += v[4 * jj + 2 * i2] + v[4 * jj + 2 * i2 + 1];
  s += __shfl_xor_sync(FULL, s, 1);
  s += __shfl_xor_sync(FULL, s, 2);
  return s;
}

// A ring of `stages` stages of `bytes` each: step k sits in stage k %
// stages, its use k / stages.  The producer's begin() waits for the stage
// to be free and sets the bytes its copies will bring; the consumers
// wait() for them and release() the stage once their products that read
// it are complete (one arrival a warp).
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, bytes;
  __device__ unsigned char* stage(int k) const {
    return base + (k % stages) * bytes;
  }
  __device__ uint64_t* bar(int k) const { return &full[k % stages]; }
  __device__ unsigned char* begin(int k, unsigned tx) const {
    const int s = k % stages;
    mbar_wait(&empty[s], ((k / stages) & 1) ^ 1);
    mbar_expect_tx(&full[s], tx);
    return base + s * bytes;
  }
  __device__ void wait(int k) const {
    mbar_wait(&full[k % stages], (k / stages) & 1);
  }
  __device__ void release(int k) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[k % stages]);
  }
};

// The dynamic shared memory, 1,024-byte aligned: `bytes` of tiles, then
// floats, then mbarriers.
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

static size_t hsmem_bytes(size_t bytes, int floats, int bars) {
  return 1024 + bytes + ((floats * 4 + 7) & ~7) + 8 * bars;
}

// The ring over `stages` stages of `bytes` at `tiles`, its barriers at
// `bars` and `extra` more single-arrival barriers after them; thread 0
// sets them up and the block meets.
__device__ __forceinline__ Ring ring_init(unsigned char* tiles,
                                          uint64_t* bars, int stages,
                                          int bytes, int extra) {
  Ring r{tiles, bars, bars + stages, stages, bytes};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], HC / 32);
    }
    for (int s = 0; s < extra; ++s) mbar_init(&bars[2 * stages + s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// 1. agg_h[p][n] = sum_i exp(cum_i) dy_h[i][p] C[i][n] for each head h of
// group g in order: C [rows i][N] once (two slabs of 64 columns per 64
// rows), dy_h's row tiles through the ring; A = (exp(cum) o dy_h)^T as
// parts, MN-major (rows i), B = C MN-major.
#define AGG_STAGES 4
__global__ void __launch_bounds__(HTH, 1) ssd_bwd_agg_hopper_kernel(
    const __grid_constant__ CUtensorMap tm_dy,
    const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ cum,
    float* __restrict__ hat, int S, int H, int P, int G, int N, int Q,
    int nc) {
  extern __shared__ __align__(1024) unsigned char hraw[];
  unsigned char* sm = smem_base(hraw);
  const int rep = H / G, nt = (Q + TILE - 1) / TILE, nsl = (N + 63) / 64;
  const Blk blk = grid_block(nc, G);
  const int c = blk.x, g = blk.y, b = blk.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  // C [row tile][slab], the ring, two part buffers of two row tiles
  unsigned char* ct = sm;
  unsigned char* parts = sm + (4 + AGG_STAGES) * TBYTES;
  float* ec = reinterpret_cast<float*>(parts + 4 * PARTS_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ec + rep * 128);
  const Ring ring = ring_init(sm + 4 * TBYTES, bars, AGG_STAGES, TBYTES, 1);
  uint64_t* c_full = bars + 2 * AGG_STAGES;
  const size_t ch0 = (size_t)(b * nc + c) * H + g * rep;

  if (threadIdx.x >= HC) {  // the producer
    if (threadIdx.x == HC) {
      mbar_expect_tx(c_full, nt * nsl * TBYTES);
      for (int rt = 0; rt < nt; ++rt)
        for (int s = 0; s < nsl; ++s)
          tma_tile(ct + (rt * 2 + s) * TBYTES, &tm_c, c_full, 64 * s, g,
                   t0 + 64 * rt, b);
      for (int k = 0; k < rep * nt; ++k)
        tma_tile(ring.begin(k, TBYTES), &tm_dy, ring.bar(k), 0,
                 g * rep + k / nt, t0 + 64 * (k % nt), b);
    }
    return;
  }
  for (int e = threadIdx.x; e < rep * nt * 64; e += HC) {
    const int hh = e / (nt * 64), i = e % (nt * 64);
    ec[e] = i < nl ? expf(cum[(ch0 + hh) * Q + i]) : 0.0f;
  }
  consumers_sync();
  mbar_wait(c_full, 0);
  float acc[2][32];
  // the parts of head hh into buffer hh & 1: row tile rt of A^T (rows i,
  // columns p)
  auto convert = [&](int hh) {
    unsigned char* pb = parts + (hh & 1) * 2 * PARTS_BYTES;
    for (int rt = 0; rt < nt; ++rt) {
      const int k = hh * nt + rt;
      ring.wait(k);
      const unsigned char* dyt = ring.stage(k);
      const float* e = ec + hh * nt * 64 + 64 * rt;
      write_parts(pb + rt * PARTS_BYTES, [&](int r, int cc) {
        return make_float2(__fmul_rn(e[r], tile_at(dyt, r, cc)),
                           __fmul_rn(e[r], tile_at(dyt, r, cc + 1)));
      });
      ring.release(k);
    }
  };
  convert(0);
  consumers_sync();
  for (int hh = 0; hh < rep; ++hh) {
    const unsigned char* pb = parts + (hh & 1) * 2 * PARTS_BYTES;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
        if (s < nsl && rt < nt)
          parts_mma<1, 1>(acc[s], pb + rt * PARTS_BYTES,
                          ct + (rt * 2 + s) * TBYTES, rt > 0);
    wgmma_commit();
    if (hh + 1 < rep) convert(hh + 1);  // behind the products
    wgmma_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    float* out = hat + (ch0 + hh) * P * N;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int p = acc_r(i2), n = 64 * s + acc_c(jj, 0);
          if (s < nsl && p < P && n < N)
            *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
                make_float2(acc[s][4 * jj + 2 * i2],
                            acc[s][4 * jj + 2 * i2 + 1]);
        }
    consumers_sync();  // the next head's parts are all written
  }
}

// 2. dM per causal tile pair (rows i of tile it, columns j of tile jt <=
// it), chunk and group, the group's heads in order: dy_h.x_h^T on bf16
// operands (both K-major), E_ij dt_j, the group's dM in registers, and the
// head's row and column sums of M o dM^h below the diagonal (rpart,
// cpart, the layouts of ssd_bwd_dm_kernel).  Head h + 1's products are
// issued before head h's epilogue and waited for after it, two
// accumulators taking turns.
#define DM_STAGES 3  // heads in flight: dy and x tiles
#define DM_MS (TILE + 4)
__global__ void __launch_bounds__(HTH, 3) ssd_bwd_dm_hopper_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_dy, const float* __restrict__ dt,
    const float* __restrict__ cbt, const float* __restrict__ cum,
    float* __restrict__ dm, float* __restrict__ rpart,
    float* __restrict__ cpart, int S, int H, int P, int G, int Q, int nc) {
  extern __shared__ __align__(1024) unsigned char hraw[];
  unsigned char* sm = smem_base(hraw);
  const int rep = H / G, n_qt = (Q + TILE - 1) / TILE;
  const Blk blk = grid_block(n_qt * (n_qt + 1) / 2, nc * G);
  int jt, it;
  tile_pair(blk.x, jt, it);
  const int i0 = it * TILE, j0 = jt * TILE;
  const int c = blk.y % nc, g = blk.y / nc, b = blk.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  float* mt = reinterpret_cast<float*>(sm + DM_STAGES * 2 * TBYTES);
  float* cu_i = mt + TILE * DM_MS;  // [rep][64]
  float* cu_j = cu_i + rep * TILE;
  float* dt_j = cu_j + rep * TILE;
  float* colp = dt_j + rep * TILE;  // [rep][4 warps][64] column sums
  const Ring ring =
      ring_init(sm, reinterpret_cast<uint64_t*>(colp + rep * 4 * TILE),
                DM_STAGES, 2 * TBYTES, 0);
  const size_t ch0 = (size_t)(b * nc + c) * H + g * rep;
  const size_t row0 = (size_t)b * S + t0;
  if (threadIdx.x >= HC) {
    if (threadIdx.x == HC)
      for (int hh = 0; hh < rep; ++hh) {  // dy (rows i), x (rows j)
        unsigned char* st = ring.begin(hh, 2 * TBYTES);
        tma_tile(st, &tm_dy, ring.bar(hh), 0, g * rep + hh, t0 + i0, b);
        tma_tile(st + TBYTES, &tm_x, ring.bar(hh), 0, g * rep + hh, t0 + j0,
                 b);
      }
    return;
  }
  const float* mg = cbt + ((size_t)(b * nc + c) * G + g) * Q * Q;
  for (int e = threadIdx.x; e < TILE * TILE; e += HC) {
    const int q = e / TILE, r = e % TILE;  // M's tile, row j0 + q
    mt[q * DM_MS + r] =
        j0 + q < Q && i0 + r < Q ? mg[(size_t)(j0 + q) * Q + i0 + r] : 0.0f;
  }
  for (int e = threadIdx.x; e < rep * TILE; e += HC) {
    const int hh = e / TILE, r = e % TILE;
    const float* cu = cum + (ch0 + hh) * Q;
    cu_i[e] = i0 + r < Q ? cu[i0 + r] : 0.0f;
    cu_j[e] = j0 + r < Q ? cu[j0 + r] : 0.0f;
    dt_j[e] = j0 + r < nl ? dt[(row0 + j0 + r) * H + g * rep + hh] : 0.0f;
  }
  consumers_sync();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float dacc[32], ha[32], hb[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dacc[e] = 0.0f;
  auto issue = [&](float* h, int hh) {
    ring.wait(hh);
    wgmma_fence();
    tile_mma<0, 0>(h, ring.stage(hh), ring.stage(hh) + TBYTES, 0);
    wgmma_commit();
  };
  // head hh's epilogue on its product h: E, dt, dM; the row sums of M o
  // dM^h by shuffles within the warp, its warp's column sums into colp
  auto epilogue = [&](float* h, int hh) {
    reg_fence(h);
    ring.release(hh);
    const float* ci = cu_i + hh * TILE;
    const float* cj = cu_j + hh * TILE;
    const float* dth = dt_j + hh * TILE;
    float rs[2] = {0.0f, 0.0f}, cs[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float gv[2];
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int e = 4 * jj + 2 * i2 + cc;
          const int r = acc_r(i2), q = acc_c(jj, cc);
          const int i = i0 + r, j = j0 + q;
          // computed everywhere, kept where live: no branches
          const float ex = fast_exp(fminf(ci[r] - cj[q], 0.0f));
          const float d = j <= i && i < nl ? ex * (dth[q] * h[e]) : 0.0f;
          gv[i2] = j < i ? mt[q * DM_MS + r] * d : 0.0f;
          dacc[e] += d;
          rs[i2] += gv[i2];
        }
        cs[2 * jj + cc] = gv[0] + gv[1];
      }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      float v = rs[i2];
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      const int r = acc_r(i2);
      if ((lane & 3) == 0 && i0 + r < Q)
        rpart[((ch0 + hh) * n_qt + jt) * Q + i0 + r] = v;
    }
    float* cw = colp + (hh * 4 + w) * TILE;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float v = cs[k];
      v += __shfl_xor_sync(FULL, v, 4);
      v += __shfl_xor_sync(FULL, v, 8);
      v += __shfl_xor_sync(FULL, v, 16);
      if (lane < 4) cw[acc_c(k >> 1, k & 1)] = v;
    }
  };
  issue(ha, 0);
  int hh = 0;
  for (; hh + 2 < rep; hh += 2) {  // heads hh + 1 and hh + 2 follow
    issue(hb, hh + 1);
    wgmma_wait<1>();
    epilogue(ha, hh);
    issue(ha, hh + 2);
    wgmma_wait<1>();
    epilogue(hb, hh + 1);
  }
  if (hh + 1 < rep) {  // the last two heads
    issue(hb, hh + 1);
    wgmma_wait<1>();
    epilogue(ha, hh);
    wgmma_wait<0>();
    epilogue(hb, hh + 1);
  } else {
    wgmma_wait<0>();
    epilogue(ha, hh);
  }
  // each head's column sums: its four warps' in order
  consumers_sync();
  for (int e = threadIdx.x; e < rep * TILE; e += HC) {
    const int hh = e / TILE, q = e % TILE;
    const float* cw = colp + hh * 4 * TILE + q;
    if (j0 + q < Q)
      cpart[((ch0 + hh) * n_qt + it) * Q + j0 + q] =
          ((cw[0] + cw[TILE]) + cw[2 * TILE]) + cw[3 * TILE];
  }
  float* dmg = dm + ((size_t)(b * nc + c) * G + g) * Q * Q;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int i = i0 + acc_r(i2), j = j0 + acc_c(jj, 0);
      if (i < Q && j < Q) {
        float* o = dmg + (size_t)i * Q + j;
        o[0] = dacc[4 * jj + 2 * i2];
        if (j + 1 < Q) o[1] = dacc[4 * jj + 2 * i2 + 1];
      }
    }
}

// 3. 64 rows (r0..) and 64 columns (n0..) of dC (DB false) or dB for a
// chunk and group: dM's parts with B_j (dC_i = sum_{j<=i} dM_ij B_j; A =
// dM K-major) or with C_i (dB_j = sum_{i>=j} dM_ij C_i; A = dM^T,
// MN-major), 64 of the contraction a step; then for each head in order
// dy_h or x_h (K-major, rows r) with the parts of S_h or Shat_h (MN-major,
// rows p), its rows scaled after by exp(cum_i) or exp(cum_end - cum_j)
// dt_j; a dC block writes each head's C_i . (state term) over its columns
// to dcs (the layout of ssd_bwd_dcdb_kernel).  A stage holds a step's bf16
// tile and its f32 tile (dM's, or the head's state's), both by TMA.
#define DCDB_STAGES 3
template <bool DB>
__device__ __forceinline__ void dcdb_hopper(
    const CUtensorMap* tm_side, const CUtensorMap* tm_other,
    const CUtensorMap* tm_c, const CUtensorMap* tm_dm,
    const CUtensorMap* tm_mats, const float* __restrict__ dt,
    const float* __restrict__ cum, bf16* __restrict__ out,
    float* __restrict__ dcs, int S, int H, int P, int G, int N, int Q,
    int nc, Blk blk, int rt, int ntile) {
  extern __shared__ __align__(1024) unsigned char hraw[];
  unsigned char* sm = smem_base(hraw);
  const int rep = H / G, n_nt = (N + 63) / 64;
  const int r0 = rt * TILE, n0 = ntile * 64;
  const int c = blk.y % nc, g = blk.y / nc, b = blk.z;
  const int t0 = c * Q, nl = min(Q, S - t0);
  if (r0 >= nl) return;
  // dM's contraction: j in [0, min(nl, r0 + 64)) for dC, i in [r0, nl)
  // for dB, in steps of 64
  const int k_lo = DB ? r0 : 0, k_hi = DB ? nl : min(nl, r0 + TILE);
  const int n1 = (k_hi - k_lo + 63) / 64;
  constexpr int SB = TBYTES + FBYTES;  // a stage: bf16 tile, f32 tile
  unsigned char* parts = sm + DCDB_STAGES * SB;
  unsigned char* ct = parts + PARTS_BYTES;  // dC: C [rows i][n0..]
  float* sc = reinterpret_cast<float*>(ct + TBYTES);  // [rep][64]
  const Ring ring =
      ring_init(sm, reinterpret_cast<uint64_t*>(sc + rep * TILE),
                DCDB_STAGES, SB, 1);
  uint64_t* c_full = ring.empty + DCDB_STAGES;
  const size_t ch0 = (size_t)(b * nc + c) * H + g * rep;
  const size_t row0 = (size_t)b * S + t0;
  const int gm = (b * nc + c) * G + g;  // dM's matrix
  if (threadIdx.x >= HC) {
    if (threadIdx.x == HC) {
      if (!DB) {
        mbar_expect_tx(c_full, TBYTES);
        tma_tile(ct, tm_c, c_full, n0, g, t0 + r0, b);
      }
      for (int k = 0; k < n1 + rep; ++k) {
        unsigned char* st = ring.begin(k, TBYTES + FBYTES);
        if (k < n1) {  // B_j or C_i rows kb.., columns n0..; dM
          const int kb = k_lo + 64 * k;
          tma_tile(st, tm_other, ring.bar(k), n0, g, t0 + kb, b);
          tma_f32(st + TBYTES, tm_dm, ring.bar(k), DB ? r0 : kb,
                  DB ? kb : r0, gm);
        } else {  // dy_h or x_h rows r0.., columns p; S_h or Shat_h
          const int h = g * rep + k - n1;
          tma_tile(st, tm_side, ring.bar(k), 0, h, t0 + r0, b);
          tma_f32(st + TBYTES, tm_mats, ring.bar(k), n0, 0,
                  (b * nc + c) * H + h);
        }
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < rep * TILE; e += HC) {
    const int hh = e / TILE, i = r0 + e % TILE;
    const float* cu = cum + (ch0 + hh) * Q;
    sc[e] = i >= nl ? 0.0f
            : DB    ? expf(cu[Q - 1] - cu[i]) *
                       dt[(row0 + i) * H + g * rep + hh]
                    : expf(cu[i]);
  }
  // the parts of step k: dM's (rows r, columns k of the contraction for
  // dC; rows k, columns r for dB; zero past the chunk) or the head's
  // state's (rows p, columns n; TMA's zeros past P and N)
  auto convert = [&](int k) {
    unsigned char* pb = parts;
    ring.wait(k);
    const unsigned char* ft = ring.stage(k) + TBYTES;
    if (k < n1) {
      const int kb = k_lo + 64 * k;
      write_parts(pb, [&](int r, int cc) {
        const float2 v = f32_at(ft, r, cc);
        const int kk = DB ? kb + r : kb + cc;  // the contraction index
        return make_float2(kk < k_hi ? v.x : 0.0f,
                           (DB ? kk : kk + 1) < k_hi ? v.y : 0.0f);
      });
    } else {
      write_parts(pb, [&](int r, int cc) { return f32_at(ft, r, cc); });
    }
  };
  float acc[32], hacc[32];
  if (!DB) mbar_wait(c_full, 0);
  for (int k = 0; k < n1; ++k) {  // dM's steps
    convert(k);
    consumers_sync();  // the step's parts are all written
    wgmma_fence();
    parts_mma<DB ? 1 : 0, 1>(acc, parts, ring.stage(k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    ring.release(k);
  }
  for (int k = n1; k < n1 + rep; ++k) {  // the heads' state terms
    convert(k);
    consumers_sync();
    wgmma_fence();
    mma_parts<0, 1>(hacc, ring.stage(k), parts, 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(hacc);
    ring.release(k);
    {
      const int hh = k - n1;
      const float* sch = sc + hh * TILE;
      float cs[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = acc_r((e >> 1) & 1), q = acc_c(e >> 2, e & 1);
        const float v = hacc[e] * sch[r];
        acc[e] += v;
        if (!DB) cs[e] = tile_at(ct, r, q) * v;
      }
      if (!DB)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const float d = quad_row_sum(cs, i2);
          const int r = acc_r(i2);
          if ((threadIdx.x & 3) == 0 && r0 + r < nl)
            dcs[((ch0 + hh) * n_nt + ntile) * Q + r0 + r] = d;
        }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int r = r0 + acc_r(i2), n = n0 + acc_c(jj, 0);
      if (r < nl && n < N)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (row0 + r) * G * N + (size_t)g * N + n) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * i2],
                                  acc[4 * jj + 2 * i2 + 1]);
    }
}

__global__ void __launch_bounds__(HTH, 2) ssd_bwd_dcdb_hopper_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_dy,
    const __grid_constant__ CUtensorMap tm_b,
    const __grid_constant__ CUtensorMap tm_c,
    const __grid_constant__ CUtensorMap tm_dm,
    const __grid_constant__ CUtensorMap tm_states,
    const __grid_constant__ CUtensorMap tm_hat, const float* __restrict__ dt,
    const float* __restrict__ cum, bf16* __restrict__ db,
    bf16* __restrict__ dc, float* __restrict__ dcs, int S, int H, int P,
    int G, int N, int Q, int nc) {
  const int nt = (Q + TILE - 1) / TILE, n_nt = (N + 63) / 64;
  const int per = nt * n_nt;
  const Blk blk = grid_block(2 * per, nc * G);
  const int x = blk.x % per;
  if (blk.x < per)
    dcdb_hopper<false>(&tm_dy, &tm_b, &tm_c, &tm_dm, &tm_states, dt, cum, dc,
                       dcs, S, H, P, G, N, Q, nc, blk, x / n_nt, x % n_nt);
  else
    dcdb_hopper<true>(&tm_x, &tm_c, &tm_c, &tm_dm, &tm_hat, dt, cum, db, dcs,
                      S, H, P, G, N, Q, nc, blk, x / n_nt, x % n_nt);
}

// 4. 64 rows (j0..) of du = (M o E)^T dy + exp(cum_end - cum_j) B Shat^T
// for one head (P <= 64 columns): the parts of (M o E)^T (K-major, from
// C.B^T's rows j) with dy (MN-major), 64 of i a step; then B (K-major)
// with the parts of Shat (rows p, columns n: K-major), 64 of n a step;
// then dx and the row sums x . du and u . (state du) (xdpart, wpart).  A
// stage holds a step's bf16 tile and its f32 tile (C.B^T's or Shat's).
#define DU_STAGES 3
__global__ void __launch_bounds__(HTH, 2) ssd_bwd_du_hopper_kernel(
    const __grid_constant__ CUtensorMap tm_dy,
    const __grid_constant__ CUtensorMap tm_b,
    const __grid_constant__ CUtensorMap tm_cbt,
    const __grid_constant__ CUtensorMap tm_hat, const bf16* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ cum,
    bf16* __restrict__ dx, float* __restrict__ xdpart,
    float* __restrict__ wpart, int S, int H, int P, int G, int N, int Q,
    int nc) {
  extern __shared__ __align__(1024) unsigned char hraw[];
  unsigned char* sm = smem_base(hraw);
  const Blk blk = grid_block((Q + TILE - 1) / TILE, nc * H);
  const int j0 = blk.x * TILE;
  const int c = blk.y % nc, h = blk.y / nc, b = blk.z;
  const int g = h / (H / G), t0 = c * Q, nl = min(Q, S - t0);
  if (j0 >= nl) return;
  const int n1 = (nl - j0 + 63) / 64, n2 = (N + 63) / 64;
  constexpr int SB = TBYTES + FBYTES;
  unsigned char* parts = sm + DU_STAGES * SB;
  float* cum_s = reinterpret_cast<float*>(parts + PARTS_BYTES);
  float* dt_s = cum_s + MAX_Q;
  const Ring ring = ring_init(
      sm, reinterpret_cast<uint64_t*>(dt_s + MAX_Q), DU_STAGES, SB, 0);
  const size_t ch = (size_t)(b * nc + c) * H + h, row0 = (size_t)b * S + t0;
  if (threadIdx.x >= HC) {
    if (threadIdx.x == HC)
      for (int k = 0; k < n1 + n2; ++k) {
        unsigned char* st = ring.begin(k, TBYTES + FBYTES);
        if (k < n1) {  // dy rows kb.., columns p; C.B^T rows j0.., i = kb..
          const int kb = j0 + 64 * k;
          tma_tile(st, &tm_dy, ring.bar(k), 0, h, t0 + kb, b);
          tma_f32(st + TBYTES, &tm_cbt, ring.bar(k), kb, j0,
                  (b * nc + c) * G + g);
        } else {  // B rows j0.., columns nb..; Shat rows p, columns nb..
          const int nb = 64 * (k - n1);
          tma_tile(st, &tm_b, ring.bar(k), nb, g, t0 + j0, b);
          tma_f32(st + TBYTES, &tm_hat, ring.bar(k), nb, 0, (int)ch);
        }
      }
    return;
  }
  for (int j = threadIdx.x; j < MAX_Q; j += HC) {
    cum_s[j] = j < Q ? cum[ch * Q + j] : 0.0f;
    dt_s[j] = j < nl ? dt[(row0 + j) * H + h] : 0.0f;
  }
  consumers_sync();
  auto convert = [&](int k) {
    unsigned char* pb = parts;
    ring.wait(k);
    const unsigned char* ft = ring.stage(k) + TBYTES;
    if (k < n1) {  // (M o E)^T: rows j, columns i = kb + cc
      const int kb = j0 + 64 * k;
      write_parts(pb, [&](int r, int cc) {
        const int j = j0 + r;
        const float2 m = f32_at(ft, r, cc);
        float v[2] = {m.x, m.y};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = kb + cc + u;
          v[u] = i >= j && i < nl
                     ? v[u] * fast_exp(fminf(cum_s[i] - cum_s[j], 0.0f))
                     : 0.0f;
        }
        return make_float2(v[0], v[1]);
      });
    } else {  // Shat: rows p, columns n (TMA's zeros past P and N)
      write_parts(pb, [&](int r, int cc) { return f32_at(ft, r, cc); });
    }
  };
  float ai[32], as[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) ai[e] = as[e] = 0.0f;
  for (int k = 0; k < n1; ++k) {  // (M o E)^T dy
    convert(k);
    consumers_sync();  // the step's parts are all written
    wgmma_fence();
    parts_mma<0, 1>(ai, parts, ring.stage(k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(ai);
    ring.release(k);
  }
  for (int k = n1; k < n1 + n2; ++k) {  // B Shat^T
    convert(k);
    consumers_sync();
    wgmma_fence();
    mma_parts<0, 0>(as, ring.stage(k), parts, 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(as);
    ring.release(k);
  }
  const float cum_end = cum_s[Q - 1];
  const size_t hp = (size_t)H * P;
  float xd[32], wv[32];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int r = acc_r(i2), j = j0 + r, p = acc_c(jj, 0);
      const int e = 4 * jj + 2 * i2;
      const bool live = j < nl && p < P;
      const size_t at = (row0 + j) * hp + (size_t)h * P + p;
      const float2 xs = live ? __bfloat1622float2(
                                   *reinterpret_cast<const __nv_bfloat162*>(
                                       x + at))
                             : make_float2(0.0f, 0.0f);
      const float ws = live ? expf(cum_end - cum_s[j]) : 0.0f;
      const float sd0 = ws * as[e], sd1 = ws * as[e + 1];
      const float du0 = ai[e] + sd0, du1 = ai[e + 1] + sd1;
      if (live)
        *reinterpret_cast<__nv_bfloat162*>(dx + at) =
            __floats2bfloat162_rn(dt_s[j] * du0, dt_s[j] * du1);
      xd[e] = xs.x * du0;
      xd[e + 1] = xs.y * du1;
      wv[e] = live ? dt_s[j] * xs.x * sd0 : 0.0f;
      wv[e + 1] = live ? dt_s[j] * xs.y * sd1 : 0.0f;
    }
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const float a = quad_row_sum(xd, i2), w = quad_row_sum(wv, i2);
    const int j = j0 + acc_r(i2);
    if ((threadIdx.x & 3) == 0 && j < nl) {
      xdpart[ch * Q + j] = a;  // one p tile (P <= 64)
      wpart[ch * Q + j] = w;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda function, through the runtime's
// entry-point query (the library does not link libcuda); null if the
// installed libcuda lacks it.
static EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major [B, rows, heads, D] bf16 tensor in place:
// boxes of 64 values of one head over 64 rows, the 128-byte swizzle;
// elements out of bounds (columns D.., rows past `rows`) read as 0.
static int encode_tiles(CUtensorMap* map, const bf16* base, int B, int rows,
                        int heads, int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<bf16*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The TMA map of a row-major [mats, rows, cols] f32 tensor in place:
// boxes of 64 x 64, no swizzle; elements out of bounds read as 0.
static int encode_f32(CUtensorMap* map, const float* base, int mats,
                      int rows, int cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Sets a kernel's dynamic shared memory limit to `bytes`.
template <class K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Whether the Hopper design takes the shape: TMA's 16-byte strides (P and
// N multiples of 8, Q of 4), one tile of P, two slabs of N.
static bool hopper_takes(int P, int N, int Q) {
  return P % 8 == 0 && N % 8 == 0 && Q % 4 == 0 && P <= 64 && N <= 128;
}

// The seven launches of the bf16 backward on Hopper (the scratch of
// backward()).
static int backward_bf16_hopper(const bf16* x, const float* dt,
                                const float* a, const bf16* b, const bf16* c,
                                const bf16* dy, const float* dstate,
                                const float* saved, bf16* dx, float* ddt,
                                float* da, bf16* db, bf16* dc, float* dinit,
                                float* scratch, int B, int S, int H, int P,
                                int G, int N, int Q, cudaStream_t st) {
  const int nc = (S + Q - 1) / Q, nt = (Q + TILE - 1) / TILE;
  const int n_nt = (N + TILE - 1) / TILE, n_pt = (P + TILE - 1) / TILE;
  const int rep = H / G;
  const float* cbt = saved;
  const float* cum = cbt + (size_t)B * nc * G * Q * Q;
  const float* states = cum + (size_t)B * nc * H * Q;
  const size_t bch = (size_t)B * nc * H;
  float* hat = scratch;
  float* dm = hat + bch * P * N;
  float* rpart = dm + (size_t)B * nc * G * Q * Q;
  float* cpart = rpart + bch * nt * Q;
  float* dcs = cpart + bch * nt * Q;
  float* xdpart = dcs + bch * n_nt * Q;
  float* wpart = xdpart + bch * n_pt * Q;
  float* dapart = wpart + bch * n_pt * Q;
  CUtensorMap tx, tdy, tb, tc, tcbt, tdm, tstates, that;
  int e = encode_tiles(&tx, x, B, S, H, P);
  if (!e) e = encode_tiles(&tdy, dy, B, S, H, P);
  if (!e) e = encode_tiles(&tb, b, B, S, G, N);
  if (!e) e = encode_tiles(&tc, c, B, S, G, N);
  if (!e) e = encode_f32(&tcbt, cbt, B * nc * G, Q, Q);
  if (!e) e = encode_f32(&tdm, dm, B * nc * G, Q, Q);
  if (!e) e = encode_f32(&tstates, states, B * nc * H, P, N);
  if (!e) e = encode_f32(&that, hat, B * nc * H, P, N);
  if (e) return e;
  const size_t sm_agg = hsmem_bytes(
      (4 + AGG_STAGES) * TBYTES + 4 * PARTS_BYTES, rep * 128,
      2 * AGG_STAGES + 1);
  const size_t sm_dm = hsmem_bytes(DM_STAGES * 2 * TBYTES,
                                   TILE * DM_MS + 7 * rep * TILE,
                                   2 * DM_STAGES);
  const size_t sm_dcdb = hsmem_bytes(
      DCDB_STAGES * (TBYTES + FBYTES) + PARTS_BYTES + TBYTES,
      rep * TILE, 2 * DCDB_STAGES + 1);
  const size_t sm_du = hsmem_bytes(
      DU_STAGES * (TBYTES + FBYTES) + PARTS_BYTES, 2 * MAX_Q,
      2 * DU_STAGES);
  CHECK(allow_smem(ssd_bwd_agg_hopper_kernel, sm_agg));
  CHECK(allow_smem(ssd_bwd_dm_hopper_kernel, sm_dm));
  CHECK(allow_smem(ssd_bwd_dcdb_hopper_kernel, sm_dcdb));
  CHECK(allow_smem(ssd_bwd_du_hopper_kernel, sm_du));
  ssd_bwd_agg_hopper_kernel<<<flat(nc, G, B), HTH, sm_agg, st>>>(
      tdy, tc, cum, hat, S, H, P, G, N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_bwd_dm_hopper_kernel<<<flat(nt * (nt + 1) / 2, (long long)nc * G, B),
                             HTH, sm_dm, st>>>(tx, tdy, dt, cbt, cum, dm,
                                               rpart, cpart, S, H, P, G, Q,
                                               nc);
  CHECK(cudaGetLastError());
  ssd_bwd_state_kernel<<<flat((P * N + NT_STATE - 1) / NT_STATE, H, B),
                         NT_STATE, 0, st>>>(dstate, cum, hat, dinit, H,
                                            P * N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_bwd_dcdb_hopper_kernel<<<flat(2 * nt * n_nt, (long long)nc * G, B),
                               HTH, sm_dcdb, st>>>(tx, tdy, tb, tc, tdm,
                                                   tstates, that, dt, cum,
                                                   db, dc, dcs, S, H, P, G,
                                                   N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_bwd_du_hopper_kernel<<<flat(nt, (long long)nc * H, B), HTH, sm_du,
                             st>>>(
      tdy, tb, tcbt, that, x, dt, cum, dx, xdpart, wpart, S, H, P, G, N, Q,
      nc);
  CHECK(cudaGetLastError());
  ssd_bwd_dcum_kernel<<<flat(nc, H, B), TT, 0, st>>>(
      dt, a, cum, states, hat, rpart, cpart, dcs, xdpart, wpart, ddt, dapart,
      S, H, P, N, Q, nc);
  CHECK(cudaGetLastError());
  ssd_bwd_da_kernel<<<(H + 127) / 128, 128, 0, st>>>(dapart, da, B, H, nc);
  return (int)cudaGetLastError();
}

extern "C" {

// The gradients of ssd_scan's (y, state_out) given their cotangents dy and
// dstate (null: zero): dx, ddt, da [H], db, dc and, unless null, dinit
// [B,H,P,N].  `saved` is the scratch of the forward call on the same
// inputs (its C.B^T, cumsums and entry states); scratch holds
// ssd_scan_backward_scratch_floats(...) floats.  Launches seven kernels on
// `stream`, allocates nothing, does not synchronise; the same limits as
// ssd_scan, and the group's H / G heads' scale vectors within a block's
// shared memory.
int ssd_scan_backward(const float* x, const float* dt, const float* a,
                      const float* b, const float* c, const float* dy,
                      const float* dstate, const float* saved, float* dx,
                      float* ddt, float* da, float* db, float* dc,
                      float* dinit, float* scratch, int B, int S, int H,
                      int P, int G, int N, int Q, void* stream) {
  return backward(x, dt, a, b, c, dy, dstate, saved, dx, ddt, da, db, dc,
                  dinit, scratch, B, S, H, P, G, N, Q, (cudaStream_t)stream,
                  ssd_bwd_agg_kernel, ssd_bwd_dm_kernel, ssd_bwd_dcdb_kernel,
                  ssd_bwd_du_kernel);
}

// As ssd_scan_backward for ssd_scan_bf16: x, b, c, dy and the gradients
// dx, db, dc in bf16 (each rounded once, from f32 sums), dt, a, dstate,
// ddt, da, dinit, saved (the bf16 forward's scratch, the same layout) and
// the scratch f32.  Seven launches: on Hopper's wgmma with the f32 sides as
// three bf16 parts where the shape allows (hopper_takes: P and N multiples
// of 8, Q of 4, P <= 64, N <= 128), else the mma.sync design (dy.x^T in
// bf16, every other product with its f32 side split in two TF32 parts).
int ssd_scan_backward_bf16(const bf16* x, const float* dt, const float* a,
                           const bf16* b, const bf16* c, const bf16* dy,
                           const float* dstate, const float* saved, bf16* dx,
                           float* ddt, float* da, bf16* db, bf16* dc,
                           float* dinit, float* scratch, int B, int S, int H,
                           int P, int G, int N, int Q, void* stream) {
  if (Q < 1 || Q > MAX_Q || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (hopper_takes(P, N, Q))
    return backward_bf16_hopper(x, dt, a, b, c, dy, dstate, saved, dx, ddt,
                                da, db, dc, dinit, scratch, B, S, H, P, G, N,
                                Q, (cudaStream_t)stream);
  return backward(x, dt, a, b, c, dy, dstate, saved, dx, ddt, da, db, dc,
                  dinit, scratch, B, S, H, P, G, N, Q, (cudaStream_t)stream,
                  ssd_bwd_agg_bf16_kernel, ssd_bwd_dm_bf16_kernel,
                  ssd_bwd_dcdb_bf16_kernel, ssd_bwd_du_bf16_kernel);
}

}  // extern "C"
