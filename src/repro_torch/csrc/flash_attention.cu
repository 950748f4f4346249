// Online-softmax attention in f32, over explicit positions, with
// grouped-query heads read in place.
//
//   out[b,i,h,:] = sum_j softmax_j(q[b,i,h,:] . k[b,j,hk,:] / sqrt(D)) v[b,j,hk,:]
//   over the keys j with k_pos[j] >= 0 (-1 marks an empty cache slot),
//   k_pos[j] <= q_pos[i] when causal, k_pos[j] > q_pos[i] - window when
//   window > 0; hk = h / (Hq / Hkv).  A row with no live key is 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _kernel).  That kernel takes [B*H, S, D] tensors
// with K/V repeated to every query head and counts positions from 0; this
// one reads the model layout q [B,S,Hq,D], k/v [B,T,Hkv,D] directly and
// takes q_pos [S] and k_pos [T], so prefill (k_pos = q_pos) and decode over
// a rolling cache (k_pos = the cache's position table) share it.
//
// Two forward entry points; the wrapper picks one from the shapes alone,
// and takes the prefill whenever a gradient is needed, since only it can
// write each row's log-sum-exp.  A third entry point, the backward
// (flash_attention_backward, below the decode), has no TPU twin: the
// reference trains by autodiff through XLA attention, and this computes
// what that autodiff computes.
//
// Prefill (flash_attention_prefill): bound by operations.  A causal
// prefill of 4 x 512 tokens with 9 heads of 64 does about 1.2 GFLOP in f32
// on CUDA cores, about 18 us at 67 TFLOP/s, above its bytes.  One 128-thread
// block per (query tile of 64 rows, query head, batch); key tiles of 64
// arrive by 16-byte cp.async in a two-stage ring, the next tile in flight
// while this one computes.  Each thread owns a 4 x 8 register tile of
// scores (rows ty + 16i, keys tx + 8j) and a 4 x D/8 tile of the output:
// Q and K rows are read as float4 along D, so one shared load feeds four
// (K) or sixteen (Q, broadcast) multiply-adds.  The running max and sum are
// shuffles among the eight threads of a row; only P goes through shared
// memory, for P.V.  Every warp classifies each key tile from the position
// tables on its own (no barrier): dead (skipped, not loaded), wholly live
// (no compares) or straddling the diagonal, the window edge or an empty
// slot (masked per element).  The query tiles with the most key tiles
// start first.
//
// Decode (flash_attention_decode, for few query rows a KV head, S * Hq/Hkv,
// as in a decode step): bound by bytes,
// the live K/V of each KV head read once (about 1 us at the serve fill).
// Flash-decoding: phase 1 runs one block per (split of 64 keys, KV head,
// batch), reads its split's K/V rows once by 16-byte cp.async and serves
// all S x Hq/Hkv query rows of the group from them, writing a partial
// (m, l, acc[D]) per row to scratch; a split with no live key writes
// m = -inf, l = 0 and loads nothing.  Phase 2 runs one warp per (batch,
// row, query head) and merges the splits in index order.  The split length
// is fixed, so the order of every sum depends on the shapes only: no
// atomics, two runs are bit-identical.
//
// f32 products on CUDA cores, built with FMA contraction; the result
// matches the plain version to about 1e-6.  No tensor cores: in f32 they
// mean TF32, which cannot hold 2e-5.
//
// Head dims: every entry point takes each D that is a multiple of 8 from 8
// to 128.  The kernels are built for tile widths DP = 16, 32, 64 and 128
// and run D at the smallest that holds it (padded_head_dim): they read the
// D columns of q, k, v and the cache in place (a row of 8 values is 16
// bytes, the unit of every copy), hold columns D..DP-1 at zero in shared
// memory, where they add nothing to a score or a product, never write
// them, and scale by 1/sqrt(D) of the true D.  At D = DP the f32 kernels
// compute what they computed when D was their template argument, bit for
// bit.  (D = 120 runs at 128: one instance per width keeps the build
// short, and the padded columns cost 1/16 of the products.)
//
// bf16 (flash_attention_prefill_bf16, flash_attention_decode_bf16): the
// same TPU kernel as it runs in the reference's working type, on q, k, v
// and out in bf16, with its algebra (kernel.py:62-84): scores in f32 from
// the bf16 inputs, the unnormalised P = exp(s - m) rounded to bf16 before
// P.V, the row sums and the accumulator in f32, one rounding of the
// normalised result to bf16.  Forward only; the backward stays f32.
//
// Prefill bf16, on Hopper (flash_prefill_bf16_hopper_kernel): bound by
// bytes or by tensor-core operations at the serving shapes (yi-34b's
// 4 x 512 prefill: 67 MB, 20 us at 3.35 TB/s; whisper's encoder: 46 GFLOP,
// 47 us at 989 TFLOP/s).  One block of three warpgroups takes 128 query
// rows of one head: warpgroups 0 and 1 own 64 rows each and compute, one
// warp of warpgroup 2 produces; setmaxnreg moves registers from the
// producer (40) to the consumers (232).  The producer loads Q once and
// each live key tile of 128 by TMA (cp.async.bulk.tensor, one box per 64
// columns, 128-, 64- or 32-byte swizzle as the tile width gives) into a
// ring of 3 or 4 stages with full and empty mbarriers; the tensor maps
// address the model layout in place (KV head h / (Hq/Hkv), no repeat),
// and TMA fills rows past T and columns past D with zeros.  It walks the
// key tiles from the position tables one tile ahead, skips the dead ones
// (never loaded), and hands each tile's first key, its class for either
// warpgroup (straddling or wholly live) and its positions to the
// consumers in shared memory.  A consumer warpgroup runs S = Q.K^T as
// wgmma m64n128k16 from shared memory (both K-major), the online softmax
// on the accumulator registers (a row over four lanes; per-element masks
// only in straddling tiles; exp2 with scale . log2 e folded into one FMA,
// by ex2.approx), rounds P to bf16 in registers and runs O += P.V as wgmma
// with P the register A operand and V read MN-major from shared memory
// (the transpose bit).  Turn j issues S_j and P_{j-1}.V_{j-1} together
// and the softmax of S_j runs while P_{j-1}.V_{j-1} does; the two
// warpgroups take turns to issue (named barriers), so one's softmax
// overlaps the other's products.  No atomics: two runs are bit-identical.
// At whisper's shapes the kernel is held by the K/V that every 128-row
// query tile reads again through L2, not by its products (PERF.md).
//
// Decode bf16: the f32 decode's split-key design (bound by bytes: the live
// K/V read once, half the bytes of an f32 cache), reading K/V and q as bf16
// by cp.async; scores, partials and the merge in f32 on CUDA cores, p
// rounded to bf16 before it multiplies V, the merged row written in bf16.
// The merge is the f32 path's, in split order: two runs are bit-identical.

#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define BQ 64          // prefill: query rows per block
#define BK 64          // keys per tile (prefill) and per split (decode)
#define PT 128         // prefill threads
#define DT 128         // decode threads
#define PS (BK + 8)    // row stride of the probability tile

__device__ __forceinline__ bool live_key(int kp, int qp, int causal,
                                         int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Whether key position kp can be live for some query position in
// [q_lo, q_hi]: false only when it is masked for every row.
__device__ __forceinline__ bool maybe_live(int kp, int q_lo, int q_hi,
                                          int causal, int window) {
  return kp >= 0 && (!causal || kp <= q_hi) &&
         (window <= 0 || kp > q_lo - window);
}

// Whether key position kp is live for every query position in [q_lo, q_hi].
__device__ __forceinline__ bool all_live(int kp, int q_lo, int q_hi,
                                         int causal, int window) {
  return kp >= 0 && (!causal || kp <= q_lo) &&
         (window <= 0 || kp > q_hi - window);
}

// 16 bytes from device to shared memory, zeros where !valid.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + rows) of a [*, Hkv or Hq, D] tensor at head `head` into
// sh[rows][stride] by cp.async, DP columns a row: rows `valid` and beyond
// and columns D..DP-1 zero-filled (D a multiple of 4, so no 16-byte copy
// straddles D).
template <int DP, int NTH>
__device__ __forceinline__ void stage_rows(float* sh, int stride,
                                           const float* src, size_t row0,
                                           int rows, int valid, int heads,
                                           int head, int D, int tid) {
  for (int e = tid; e < rows * (DP / 4); e += NTH) {
    const int r = e / (DP / 4), c4 = (e % (DP / 4)) * 4;
    const bool ok = r < valid && c4 < D;
    const float* g =
        src + ((row0 + (r < valid ? r : 0)) * heads + head) * D +
        (ok ? c4 : 0);
    cp_async16(sh + r * stride + c4, g, ok);
  }
}

// The smallest and largest of the positions pos[0..n) (n <= 64), in every
// lane of the calling warp.
__device__ __forceinline__ void pos_range(const int* pos, int n, int lane,
                                          int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = lane; i < n; i += 32) {
    lo = min(lo, pos[i]);
    hi = max(hi, pos[i]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
}

// Key tile at t0: 0 dead, 1 straddling, 2 wholly live; the same in every
// lane of the calling warp.
__device__ __forceinline__ int classify(const int* k_pos, int t0, int T,
                                        int q_lo, int q_hi, int causal,
                                        int window, int lane) {
  const int a = t0 + lane < T ? k_pos[t0 + lane] : -1;
  const int b = t0 + lane + 32 < T ? k_pos[t0 + lane + 32] : -1;
  const unsigned any =
      __ballot_sync(FULL, maybe_live(a, q_lo, q_hi, causal, window) ||
                              maybe_live(b, q_lo, q_hi, causal, window));
  if (!any) return 0;
  const unsigned all =
      __ballot_sync(FULL, all_live(a, q_lo, q_hi, causal, window) &&
                              all_live(b, q_lo, q_hi, causal, window));
  return all == FULL ? 2 : 1;
}

// The first key tile at or after t0 that is not dead (T if none); its
// class in cls.
__device__ __forceinline__ int next_tile(const int* k_pos, int t0, int T,
                                         int q_lo, int q_hi, int causal,
                                         int window, int lane, int& cls) {
  for (; t0 < T; t0 += BK) {
    cls = classify(k_pos, t0, T, q_lo, q_hi, causal, window, lane);
    if (cls) return t0;
  }
  cls = 0;
  return T;
}

// Output column e (0 <= e < DP/8) of thread tx: float4 groups 32 apart
// when DP >= 32, so the eight threads of a quarter warp read distinct
// banks.  Columns D..DP-1 are padding, never written.
template <int DP>
__device__ __forceinline__ int out_col(int tx, int e) {
  if constexpr (DP >= 32)
    return (e >> 2) * 32 + tx * 4 + (e & 3);
  else
    return tx * (DP / 8) + e;
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(PT) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out,
    float* __restrict__ lse, int S, int T, int Hq, int Hkv, int D,
    int causal, int window, float scale) {
  constexpr int KS = DP + 4;  // row stride of Q and K tiles
  constexpr int DV = DP / 8;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                 // [BQ][KS]
  float* k_sh = q_sh + BQ * KS;       // 2 x [BK][KS]
  float* v_sh = k_sh + 2 * BK * KS;   // 2 x [BK][DP]
  float* p_sh = v_sh + 2 * BK * DP;   // [BQ][PS]

  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid >> 3, tx = tid & 7;  // rows ty + 16i, keys tx + 8j
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, S - q0);

  int q_lo, q_hi;
  pos_range(q_pos + q0, nq, lane, q_lo, q_hi);
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    qp[i] = r < nq ? q_pos[q0 + r] : q_hi;
  }

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.0f;
  }

  int cls;
  int cur = next_tile(k_pos, 0, T, q_lo, q_hi, causal, window, lane, cls);
  stage_rows<DP, PT>(q_sh, KS, q, (size_t)b * S + q0, BQ, nq, Hq, h, D,
                     tid);
  if (cur < T) {
    stage_rows<DP, PT>(k_sh, KS, k, (size_t)b * T + cur, BK, T - cur, Hkv,
                       hk, D, tid);
    stage_rows<DP, PT>(v_sh, DP, v, (size_t)b * T + cur, BK, T - cur, Hkv,
                       hk, D, tid);
  }
  cp_async_commit();

  int stage = 0;
  while (cur < T) {
    int nxt_cls;
    const int nxt = next_tile(k_pos, cur + BK, T, q_lo, q_hi, causal, window,
                              lane, nxt_cls);
    if (nxt < T) {  // the next tile flies while this one computes
      stage_rows<DP, PT>(k_sh + (stage ^ 1) * BK * KS, KS, k,
                         (size_t)b * T + nxt, BK, T - nxt, Hkv, hk, D, tid);
      stage_rows<DP, PT>(v_sh + (stage ^ 1) * BK * DP, DP, v,
                         (size_t)b * T + nxt, BK, T - nxt, Hkv, hk, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) has landed for every thread

    const float* ks = k_sh + stage * BK * KS;
    const float* vs = v_sh + stage * BK * DP;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] =
            *reinterpret_cast<const float4*>(q_sh + (ty + 16 * i) * KS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kb =
            *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb.x, t);
          t = fmaf(qa[i].y, kb.y, t);
          t = fmaf(qa[i].z, kb.z, t);
          s[i][j] = fmaf(qa[i].w, kb.w, t);
        }
      }
    }
    if (cls == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = cur + tx + 8 * j;
        const int kp = t < T ? k_pos[t] : -1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] = live_key(kp, qp[i], causal, window) ? s[i][j] * scale
                                                        : -INFINITY;
      }
    }

    // online softmax: each row's eight threads are lanes 8r..8r+7
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.0f, sum = 0.0f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p_sh[(ty + 16 * i) * PS + tx + 8 * j] = s[i][j];
    }
    __syncthreads();  // P is complete

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] =
            *reinterpret_cast<const float4*>(p_sh + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DV];
        const float* vr = vs + (c + cc) * DP;
        if constexpr (DP >= 32) {
#pragma unroll
          for (int e = 0; e < DV; e += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vr + (e >> 2) * 32 + tx * 4);
            vv[e] = t.x;
            vv[e + 1] = t.y;
            vv[e + 2] = t.z;
            vv[e + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < DV; ++e) vv[e] = vr[out_col<DP>(tx, e)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pa[i].x
                          : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z
                                    : pa[i].w;
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // P and this stage are consumed before they refill

    cur = nxt;
    cls = nxt_cls;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
      float* o = out + ((size_t)(b * S + q0 + r) * Hq + h) * D;
#pragma unroll
      for (int e = 0; e < DV; ++e)
        if (out_col<DP>(tx, e) < D) o[out_col<DP>(tx, e)] = acc[i][e] * inv;
      // the row's log-sum-exp of scaled scores (every thread of the row
      // holds the same m and l), for the backward
      if (lse != nullptr && tx == 0)
        lse[((size_t)b * Hq + h) * S + q0 + r] =
            l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// decode: split-key partials, then a fixed-order merge
// ---------------------------------------------------------------------------

// Partial of split blockIdx.x for the R = S * (Hq/Hkv) query rows of KV head
// blockIdx.y (row r = s * group + g reads query head hk * group + g at
// position s).  Partials are indexed ((b * S + s) * Hq + h) * n_split + split.
template <int DP>
__global__ void __launch_bounds__(DT) flash_decode_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int S, int T,
    int Hq, int Hkv, int D, int causal, int window, float scale) {
  constexpr int KS = DP + 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, group = Hq / Hkv, R = S * group;
  float* q_sh = smem;             // [R][KS]
  float* k_sh = q_sh + R * KS;    // [BK][KS]
  float* v_sh = k_sh + BK * KS;   // [BK][DP]
  float* p_sh = v_sh + BK * DP;   // [R][PS]
  const int t0 = split * BK, nk = min(BK, T - t0);

  int q_lo, q_hi;
  pos_range(q_pos, S, lane, q_lo, q_hi);
  if (!classify(k_pos, t0, T, q_lo, q_hi, causal, window, lane)) {
    for (int r = tid; r < R; r += DT) {
      const int s = r / group, h = hk * group + r % group;
      const size_t at = ((size_t)(b * S + s) * Hq + h) * n_split + split;
      part_m[at] = -INFINITY;
      part_l[at] = 0.0f;
    }
    return;
  }

  for (int e = tid; e < R * (DP / 4); e += DT) {
    const int r = e / (DP / 4), c4 = (e % (DP / 4)) * 4;
    const int s = r / group, h = hk * group + r % group;
    cp_async16(q_sh + r * KS + c4,
               q + ((size_t)(b * S + s) * Hq + h) * D + (c4 < D ? c4 : 0),
               c4 < D);
  }
  stage_rows<DP, DT>(k_sh, KS, k, (size_t)b * T + t0, BK, nk, Hkv, hk, D,
                     tid);
  stage_rows<DP, DT>(v_sh, DP, v, (size_t)b * T + t0, BK, nk, Hkv, hk, D,
                     tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  {  // scores: thread owns key c and rows rg, rg + 2, ...
    const int c = tid & (BK - 1), rg = tid / BK;
    const int kp = c < nk ? k_pos[t0 + c] : -1;
    for (int r = rg; r < R; r += DT / BK) {
      float t = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DP; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(q_sh + r * KS + d);
        const float4 kb = *reinterpret_cast<const float4*>(k_sh + c * KS + d);
        t = fmaf(qa.x, kb.x, t);
        t = fmaf(qa.y, kb.y, t);
        t = fmaf(qa.z, kb.z, t);
        t = fmaf(qa.w, kb.w, t);
      }
      p_sh[r * PS + c] =
          live_key(kp, q_pos[r / group], causal, window) ? t * scale
                                                         : -INFINITY;
    }
  }
  __syncthreads();

  // softmax of the split, a warp a row
  for (int r = warp; r < R; r += DT / 32) {
    const float s0 = p_sh[r * PS + lane], s1 = p_sh[r * PS + lane + 32];
    float mx = fmaxf(s0, s1);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float p0 = 0.0f, p1 = 0.0f;
    if (mx != -INFINITY) {
      p0 = expf(s0 - mx);
      p1 = expf(s1 - mx);
    }
    float sum = p0 + p1;
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    p_sh[r * PS + lane] = p0;
    p_sh[r * PS + lane + 32] = p1;
    if (lane == 0) {
      const int s = r / group, h = hk * group + r % group;
      const size_t at = ((size_t)(b * S + s) * Hq + h) * n_split + split;
      part_m[at] = mx;
      part_l[at] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < R * DP; e += DT) {
    const int r = e / DP, d = e % DP;
    if (d >= D) continue;
    float t = 0.0f;
#pragma unroll 8
    for (int c = 0; c < BK; ++c)
      t = fmaf(p_sh[r * PS + c], v_sh[c * DP + d], t);
    const int s = r / group, h = hk * group + r % group;
    part_acc[(((size_t)(b * S + s) * Hq + h) * n_split + split) * D + d] = t;
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One warp per output row ((b * S + s) * Hq + h): merge the splits in
// index order; the row is rounded to O once.
template <class O>
__global__ void __launch_bounds__(DT) flash_decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, O* __restrict__ out, int rows,
    int n_split, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (DT / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* pm = part_m + (size_t)row * n_split;
  const float* pl = part_l + (size_t)row * n_split;
  const float* pa = part_acc + (size_t)row * n_split * D;
  float mx = -INFINITY;
  for (int j = lane; j < n_split; j += 32) mx = fmaxf(mx, pm[j]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  float l = 0.0f, acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // D <= 128
  for (int j = 0; j < n_split; ++j) {
    const float mj = pm[j];
    if (mj == -INFINITY) continue;  // no live key in split j for this row
    const float w = expf(mj - mx);
    l = fmaf(w, pl[j], l);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = lane + 32 * e;
      if (d < D) acc[e] = fmaf(w, pa[(size_t)j * D + d], acc[e]);
    }
  }
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = lane + 32 * e;
    if (d < D) store_out(out + (size_t)row * D + d, acc[e] * inv);
  }
}

// ---------------------------------------------------------------------------
// backward: D = rowsum(dO o O), then dK/dV and dQ from P recomputed with the
// forward's log-sum-exp
// ---------------------------------------------------------------------------
//
// With s_ij = q_i . k_j / sqrt(D) over the live pairs and lse_i the
// forward's log-sum-exp of row i:
//   P_ij  = exp(s_ij - lse_i)           (0 where the pair is masked)
//   D_i   = sum_d dO_i[d] O_i[d]
//   dV_j  = sum_i P_ij dO_i             (summed over the group's query heads)
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i  = sum_j dS_ij k_j / sqrt(D)
//   dK_j  = sum_i dS_ij q_i / sqrt(D)   (summed over the group's query heads)
// Launches: one warp per row for D; one block per (batch, query head, key
// tile of 64) for that head's share of dK and dV, looping in index order
// over the query tiles that hold a live pair (a block per query head, not
// per KV head, so that a causal prefill's longest blocks are a group's
// length shorter and three times as many blocks fill the card); with
// grouped heads, a pass that adds each group's shares in head order; one
// block per (batch, query head, query tile of 64) for dQ, looping over the
// key tiles that hold a live pair.  Every sum runs in an order fixed by
// the shapes: no atomics, two runs are bit-identical.  Bound by
// operations, 10 * D f32 operations per live pair (S, dP, dV, dS.K,
// dS^T.Q); a simple design on CUDA cores, one stage of cp.async, no tensor
// cores.

// The DP/8 output columns out_col(tx, e) of one shared-memory row, as
// float4 loads where DP >= 32.
template <int DP>
__device__ __forceinline__ void load_cols(const float* row, int tx,
                                          float* out) {
  if constexpr (DP >= 32) {
#pragma unroll
    for (int e = 0; e < DP / 8; e += 4) {
      const float4 t =
          *reinterpret_cast<const float4*>(row + (e >> 2) * 32 + tx * 4);
      out[e] = t.x;
      out[e + 1] = t.y;
      out[e + 2] = t.z;
      out[e + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < DP / 8; ++e) out[e] = row[out_col<DP>(tx, e)];
  }
}

// One warp per row ((b * S + i) * Hq + h): delta[(b * Hq + h) * S + i].
__global__ void __launch_bounds__(DT) flash_bwd_dot_kernel(
    const float* __restrict__ out, const float* __restrict__ dout,
    float* __restrict__ delta, int rows, int S, int Hq, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (DT / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* o = out + (size_t)row * D;
  const float* g = dout + (size_t)row * D;
  float t = 0.0f;
  for (int d = lane; d < D; d += 32) t = fmaf(o[d], g[d], t);
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(FULL, t, off);
  if (lane == 0) {
    const int h = row % Hq, bi = row / Hq;  // bi = b * S + i
    const int b = bi / S, i = bi % S;
    delta[((size_t)b * Hq + h) * S + i] = t;
  }
}

// dK and dV of key tile blockIdx.y from query head blockIdx.x % Hq of
// batch blockIdx.x / Hq, over the query tiles in index order.  With one
// query head per KV head the block writes dk/dv [B,T,Hkv,D]; with more, it
// writes its head's share to dk/dv laid out [B,T,Hq,D], and
// flash_bwd_group_sum_kernel adds the shares of a group in head order.
// The thread owns keys ty + 16i and, in the score tile, query rows tx + 8j;
// its accumulators hold its keys' output columns out_col(tx, e).
template <int DP>
__global__ void __launch_bounds__(PT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dk, float* __restrict__ dv, int S, int T, int Hq,
    int Hkv, int D, int causal, int window, float scale) {
  constexpr int KS = DP + 4;
  constexpr int DV = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* k_sh = smem;                 // [BK][KS]
  float* v_sh = k_sh + BK * KS;       // [BK][KS]
  float* q_sh = v_sh + BK * KS;       // [BQ][KS]
  float* do_sh = q_sh + BQ * KS;      // [BQ][KS]
  float* p_sh = do_sh + BQ * KS;      // [BK][PS], P^T (key, row)
  float* ds_sh = p_sh + BK * PS;      // [BK][PS], dS^T
  float* lse_sh = ds_sh + BK * PS;    // [BQ]
  float* dl_sh = lse_sh + BQ;         // [BQ]
  int* qp_sh = (int*)(dl_sh + BQ);    // [BQ]

  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid >> 3, tx = tid & 7;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int t0 = blockIdx.y * BK, nk = min(BK, T - t0);

  int kp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    kp[i] = c < nk ? k_pos[t0 + c] : -1;
  }
  float dk_acc[4][DV], dv_acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DV; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;

  stage_rows<DP, PT>(k_sh, KS, k, (size_t)b * T + t0, BK, nk, Hkv, hk, D,
                     tid);
  stage_rows<DP, PT>(v_sh, KS, v, (size_t)b * T + t0, BK, nk, Hkv, hk, D,
                     tid);
  cp_async_commit();

  for (int q0 = 0; q0 < S; q0 += BQ) {
    const int nq = min(BQ, S - q0);
    int q_lo, q_hi;
    pos_range(q_pos + q0, nq, lane, q_lo, q_hi);
    if (!classify(k_pos, t0, T, q_lo, q_hi, causal, window, lane))
      continue;  // no live pair between this query tile and the keys
    stage_rows<DP, PT>(q_sh, KS, q, (size_t)b * S + q0, BQ, nq, Hq, h, D,
                       tid);
    stage_rows<DP, PT>(do_sh, KS, dout, (size_t)b * S + q0, BQ, nq, Hq, h, D,
                       tid);
    cp_async_commit();
    if (tid < BQ) {
      const bool ok = tid < nq;
      const size_t at = ((size_t)b * Hq + h) * S + q0 + tid;
      lse_sh[tid] = ok ? lse[at] : 0.0f;
      dl_sh[tid] = ok ? delta[at] : 0.0f;
      qp_sh[tid] = ok ? q_pos[q0 + tid] : 0;
    }
    cp_async_wait<0>();
    __syncthreads();  // K/V (first time), Q, dO and the row values landed

    // P^T: scores of keys ty + 16i against rows tx + 8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ka[i] =
            *reinterpret_cast<const float4*>(k_sh + (ty + 16 * i) * KS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 qb =
            *reinterpret_cast<const float4*>(q_sh + (tx + 8 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = s[i][j];
          t = fmaf(ka[i].x, qb.x, t);
          t = fmaf(ka[i].y, qb.y, t);
          t = fmaf(ka[i].z, qb.z, t);
          s[i][j] = fmaf(ka[i].w, qb.w, t);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tx + 8 * j;
      const bool row_ok = r < nq;
      const int qp = qp_sh[r];
      const float m = lse_sh[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = row_ok && live_key(kp[i], qp, causal, window);
        p_sh[(ty + 16 * i) * PS + r] =
            live ? expf(fmaf(s[i][j], scale, -m)) : 0.0f;
      }
    }

    // dP^T = V . dO^T, then dS^T = P^T (dP^T - D), in the same cells
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        va[i] =
            *reinterpret_cast<const float4*>(v_sh + (ty + 16 * i) * KS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 gb =
            *reinterpret_cast<const float4*>(do_sh + (tx + 8 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = s[i][j];
          t = fmaf(va[i].x, gb.x, t);
          t = fmaf(va[i].y, gb.y, t);
          t = fmaf(va[i].z, gb.z, t);
          s[i][j] = fmaf(va[i].w, gb.w, t);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tx + 8 * j;
      const float dl = dl_sh[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = (ty + 16 * i) * PS + r;
        ds_sh[at] = p_sh[at] * (s[i][j] - dl);
      }
    }
    __syncthreads();  // P^T and dS^T are complete

    // dV += P^T . dO, dK += dS^T . Q over the tile's rows, in order
#pragma unroll 2
    for (int c = 0; c < BQ; c += 4) {
      float4 pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] =
            *reinterpret_cast<const float4*>(p_sh + (ty + 16 * i) * PS + c);
        da[i] =
            *reinterpret_cast<const float4*>(ds_sh + (ty + 16 * i) * PS + c);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float gv[DV], qv[DV];
        load_cols<DP>(do_sh + (c + cc) * KS, tx, gv);
        load_cols<DP>(q_sh + (c + cc) * KS, tx, qv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pa[i].x
                          : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z
                                    : pa[i].w;
          const float ds = cc == 0 ? da[i].x
                           : cc == 1 ? da[i].y
                           : cc == 2 ? da[i].z
                                     : da[i].w;
#pragma unroll
          for (int e = 0; e < DV; ++e) {
            dv_acc[i][e] = fmaf(p, gv[e], dv_acc[i][e]);
            dk_acc[i][e] = fmaf(ds, qv[e], dk_acc[i][e]);
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before the next one lands
  }
  cp_async_wait<0>();  // K/V of a block that found no live tile

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c < nk) {
      const size_t row =
          Hq == Hkv ? ((size_t)(b * T + t0 + c) * Hkv + hk) * D
                    : ((size_t)(b * T + t0 + c) * Hq + h) * D;
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        const int col = out_col<DP>(tx, e);
        if (col < D) {
          dk[row + col] = dk_acc[i][e] * scale;
          dv[row + col] = dv_acc[i][e];
        }
      }
    }
  }
}

// dk/dv [B,T,Hkv,D] from the query heads' shares [B,T,Hq,D]: the G
// shares of each KV head added in head order, one thread per output.
__global__ void __launch_bounds__(DT) flash_bwd_group_sum_kernel(
    const float* __restrict__ part_k, const float* __restrict__ part_v,
    float* __restrict__ dk, float* __restrict__ dv, size_t n, int Hq,
    int Hkv, int D) {
  const size_t e = (size_t)blockIdx.x * DT + threadIdx.x;
  if (e >= n) return;
  const int group = Hq / Hkv;
  const int d = (int)(e % D);
  const size_t row = e / D;  // (b * T + t) * Hkv + hk
  const int hk = (int)(row % Hkv);
  const size_t src = ((row / Hkv) * Hq + (size_t)hk * group) * D + d;
  float sk = 0.0f, sv = 0.0f;
  for (int g = 0; g < group; ++g) {
    sk += part_k[src + (size_t)g * D];
    sv += part_v[src + (size_t)g * D];
  }
  dk[e] = sk;
  dv[e] = sv;
}

// dQ of query tile blockIdx.y for query head blockIdx.x % Hq of batch
// blockIdx.x / Hq: rows ty + 16i, keys tx + 8j, as the forward.
template <int DP>
__global__ void __launch_bounds__(PT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dq, int S, int T, int Hq, int Hkv, int D, int causal,
    int window, float scale) {
  constexpr int KS = DP + 4;
  constexpr int DV = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                 // [BQ][KS]
  float* do_sh = q_sh + BQ * KS;      // [BQ][KS]
  float* k_sh = do_sh + BQ * KS;      // [BK][KS]
  float* v_sh = k_sh + BK * KS;       // [BK][KS]
  float* ds_sh = v_sh + BK * KS;      // [BQ][PS]

  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid >> 3, tx = tid & 7;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, S - q0);

  int q_lo, q_hi;
  pos_range(q_pos + q0, nq, lane, q_lo, q_hi);
  int qp[4];
  float m[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool ok = r < nq;
    const size_t at = ((size_t)b * Hq + h) * S + q0 + r;
    qp[i] = ok ? q_pos[q0 + r] : 0;
    m[i] = ok ? lse[at] : 0.0f;
    dl[i] = ok ? delta[at] : 0.0f;
  }
  float acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.0f;

  stage_rows<DP, PT>(q_sh, KS, q, (size_t)b * S + q0, BQ, nq, Hq, h, D,
                     tid);
  stage_rows<DP, PT>(do_sh, KS, dout, (size_t)b * S + q0, BQ, nq, Hq, h, D,
                     tid);
  cp_async_commit();

  int cls;
  for (int cur = next_tile(k_pos, 0, T, q_lo, q_hi, causal, window, lane, cls);
       cur < T;
       cur = next_tile(k_pos, cur + BK, T, q_lo, q_hi, causal, window, lane,
                       cls)) {
    stage_rows<DP, PT>(k_sh, KS, k, (size_t)b * T + cur, BK, T - cur, Hkv,
                       hk, D, tid);
    stage_rows<DP, PT>(v_sh, KS, v, (size_t)b * T + cur, BK, T - cur, Hkv,
                       hk, D, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // this key tile (and Q, dO) landed

    float s[4][8], p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] =
            *reinterpret_cast<const float4*>(q_sh + (ty + 16 * i) * KS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kb =
            *reinterpret_cast<const float4*>(k_sh + (tx + 8 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb.x, t);
          t = fmaf(qa[i].y, kb.y, t);
          t = fmaf(qa[i].z, kb.z, t);
          s[i][j] = fmaf(qa[i].w, kb.w, t);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = cur + tx + 8 * j;
      const int kp = t < T ? k_pos[t] : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live =
            ty + 16 * i < nq && live_key(kp, qp[i], causal, window);
        p[i][j] = live ? expf(fmaf(s[i][j], scale, -m[i])) : 0.0f;
        s[i][j] = 0.0f;
      }
    }
    // dP = dO . V^T
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 ga[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ga[i] =
            *reinterpret_cast<const float4*>(do_sh + (ty + 16 * i) * KS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 vb =
            *reinterpret_cast<const float4*>(v_sh + (tx + 8 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = s[i][j];
          t = fmaf(ga[i].x, vb.x, t);
          t = fmaf(ga[i].y, vb.y, t);
          t = fmaf(ga[i].z, vb.z, t);
          s[i][j] = fmaf(ga[i].w, vb.w, t);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ds_sh[(ty + 16 * i) * PS + tx + 8 * j] = p[i][j] * (s[i][j] - dl[i]);
    __syncthreads();  // dS is complete

    // dQ += dS . K over the tile's keys, in order
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[i] =
            *reinterpret_cast<const float4*>(ds_sh + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float kv[DV];
        load_cols<DP>(k_sh + (c + cc) * KS, tx, kv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ds = cc == 0 ? da[i].x
                           : cc == 1 ? da[i].y
                           : cc == 2 ? da[i].z
                                     : da[i].w;
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[i][e] = fmaf(ds, kv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // K, V and dS are consumed before they refill
  }
  cp_async_wait<0>();  // Q and dO of a tile with no live key

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      float* o = dq + ((size_t)(b * S + q0 + r) * Hq + h) * D;
#pragma unroll
      for (int e = 0; e < DV; ++e)
        if (out_col<DP>(tx, e) < D) o[out_col<DP>(tx, e)] = acc[i][e] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: the prefill on Hopper's tensor cores, the split-key decode
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// 16 bytes from device to shared memory, zeros where !valid.
__device__ __forceinline__ void cp_async16_any(void* smem, const void* gmem,
                                               bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

// As stage_rows, for bf16 rows (8 values a copy; D a multiple of 8).
template <int DP, int NTH>
__device__ __forceinline__ void stage_rows_bf16(bf16* sh, int stride,
                                                const bf16* src, size_t row0,
                                                int rows, int valid,
                                                int heads, int head, int D,
                                                int tid) {
  for (int e = tid; e < rows * (DP / 8); e += NTH) {
    const int r = e / (DP / 8), c8 = (e % (DP / 8)) * 8;
    const bool ok = r < valid && c8 < D;
    const bf16* g = src + ((row0 + (r < valid ? r : 0)) * heads + head) * D +
                    (ok ? c8 : 0);
    cp_async16_any(sh + r * stride + c8, g, ok);
  }
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// mbarriers in shared memory: init with the arrivals a phase takes; a
// producer's arrival that also expects `bytes` from TMA copies; a wait for
// the phase of the given parity to complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A wait that outlasts about 10 s of clock (a copy that never lands, an
// arrival that never comes) traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
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

// A TMA copy of one box of a 4-d tensor map at coordinates (c0..c3) into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units) and the swizzle (1: 128 bytes,
// 2: 64, 3: 32).
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo, unsigned swz) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` over n threads: sync waits for all n (its own warp
// counted), arrive counts its warp and goes on.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keeps the compiler from moving reads or writes of the N registers d
// across the asynchronous products (issued before, waited for after).
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A.B for A [64 x 16] and B [16 x 128], both bf16 in shared memory,
// K-major (descriptors da, db); d f32 [64 x 128], the accumulator layout.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d = A.B as wgmma_ss_n128, d written only (scale-d 0).
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
      "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
      "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
      "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
      "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
      "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
      "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
      "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
      "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
      "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
      "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
      "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
      "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
      "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
      "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A.B for A [64 x 16] bf16 in registers (a[4] per thread, each
// warp's 16 rows in mma.m16n8k16's A layout) and B [16 x 16] bf16 in
// shared memory, MN-major (descriptor db, transposed); d f32 [64 x 16].
__device__ __forceinline__ void wgmma_rs_n16(float* d, const unsigned* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B for A [64 x 16] bf16 in registers (a[4] per thread, each
// warp's 16 rows in mma.m16n8k16's A layout) and B [16 x 32] bf16 in
// shared memory, MN-major (descriptor db, transposed); d f32 [64 x 32].
__device__ __forceinline__ void wgmma_rs_n32(float* d, const unsigned* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B for A [64 x 16] bf16 in registers (a[4] per thread, each
// warp's 16 rows in mma.m16n8k16's A layout) and B [16 x 64] bf16 in
// shared memory, MN-major (descriptor db, transposed); d f32 [64 x 64].
__device__ __forceinline__ void wgmma_rs_n64(float* d, const unsigned* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P.V for the PV columns of one slab: CW = 16, 32 or 64.
template <int CW>
__device__ __forceinline__ void wgmma_rs(float* d, const unsigned* a,
                                         uint64_t db) {
  if constexpr (CW == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (CW == 32)
    wgmma_rs_n32(d, a, db);
  else
    wgmma_rs_n16(d, a, db);
}

#define WQ 128        // bf16 prefill: query rows per block (2 x 64)
#define WK 128        // keys per tile
#define WTHREADS 384  // consumer warpgroups 0 and 1, producer warpgroup 2

// Shared memory of the bf16 prefill at tile width DP: Q [WQ][DP], then
// STAGES K tiles and STAGES V tiles of [WK][DP], then the barriers, each
// stage's tile (its first key, its class for either warpgroup) and its
// key positions.
// Each tile is DP / CW column slabs of CW = min(DP, 64) values, as TMA
// writes them: rows of SPAN = 2 CW bytes, swizzled on SPAN bytes, every
// slab 1,024-byte aligned.
template <int DP>
struct WTile {
  static constexpr int STAGES = DP < 128 ? 4 : 3;  // K/V tiles in flight
  static constexpr int CW = DP < 64 ? DP : 64;
  static constexpr int SPAN = 2 * CW;
  static constexpr int NS = DP / CW;
  static constexpr unsigned SWZ = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
  static constexpr int Q_BYTES = WQ * DP * 2;
  static constexpr int KV_BYTES = WK * DP * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int META_OFF = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int KPOS_OFF = META_OFF + 16 * STAGES;
  static constexpr size_t SMEM = KPOS_OFF + 4 * WK * STAGES + 1024;
};

// 2^x by the special-function unit (ex2.approx, subnormal results 0):
// the exponential of the bf16 prefill's softmax.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile of a warpgroup, in place on the
// accumulator (s[4j + 2i + c]: the thread's row i, key 8j + fc + c; a
// row's four lanes are lane ^ 1, ^ 2): s becomes
// P = 2^(s . scale log2 e - m . scale log2 e), 0 where masked, and alpha
// the rescale O owes.  MASKED: the bits of `live` (index 4j + 2i + c) say
// which entries are live.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float* s,
                                             unsigned long long live,
                                             float* m, float* l,
                                             float* alpha, float sl2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        if (!MASKED || ((live >> e) & 1)) mx = fmaxf(mx, s[e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float ms = m_new == -INFINITY ? 0.0f : __fmul_rn(m_new, sl2);
    alpha[i] = fast_exp2(__fmul_rn(m[i], sl2) - ms);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const float p = !MASKED || ((live >> e) & 1)
                            ? fast_exp2(fmaf(s[e], sl2, -ms))
                            : 0.0f;
        s[e] = p;
        sum += p;
      }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

template <int DP>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_prefill_bf16_hopper_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const int* __restrict__ q_pos, const int* __restrict__ k_pos,
        bf16* __restrict__ out, int S, int T, int Hq, int Hkv, int D,
        int causal, int window, float scale) {
  using L = WTile<DP>;
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* sm =
      wsmem + ((1024u - (smem_addr(wsmem) & 1023u)) & 1023u);
  unsigned char* q_sh = sm;
  unsigned char* k_sh = sm + L::Q_BYTES;
  unsigned char* v_sh = k_sh + L::STAGES * L::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* full = q_full + 1;         // [STAGES]: a K/V tile landed
  uint64_t* empty = full + L::STAGES;  // [STAGES]: 8 consumer warps done
  int* meta = reinterpret_cast<int*>(sm + L::META_OFF);  // [STAGES][4]
  int* kpos_sh = reinterpret_cast<int*>(sm + L::KPOS_OFF);  // [STAGES][WK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the query tiles of a head, and the heads of a KV group, are launched
  // together, so their blocks share K/V through L2; the longest tiles of
  // a head first
  const int h = blockIdx.y % Hq, b = blockIdx.y / Hq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WQ;
  const int hk = h / (Hq / Hkv);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: warp 8 walks the key tiles live for some row of the block,
    // classifies each for either warpgroup's rows, and its lane 0 issues
    // every copy; an end marker (first key T) closes the list
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      int q_lo, q_hi, w_lo[2], w_hi[2];
      pos_range(q_pos + q0, min(WQ, S - q0), lane, q_lo, q_hi);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        pos_range(q_pos + q0 + 64 * w, min(64, S - q0 - 64 * w), lane,
                  w_lo[w], w_hi[w]);
      if (lane == 0) {
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int s = 0; s < L::NS; ++s)
          tma_load(q_sh + s * WQ * L::SPAN, &tm_q, q_full, s * L::CW, h, q0,
                   b);
      }
      // lane holds the positions of keys t0 + lane + 32u, the next tile's
      // loading while this one is classified
      int kv[4], nx[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kv[u] = lane + 32 * u < T ? __ldg(k_pos + lane + 32 * u) : -1;
      int stage = 0;
      unsigned phase = 0;
      for (int t0 = 0;; t0 += WK) {
        const bool end = t0 >= T;
        bool any = false, wany[2] = {false, false}, wall[2] = {true, true};
        if (!end) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = t0 + WK + lane + 32 * u;
            nx[u] = t < T ? __ldg(k_pos + t) : -1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            any = any || maybe_live(kv[u], q_lo, q_hi, causal, window);
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              wany[w] = wany[w] ||
                        maybe_live(kv[u], w_lo[w], w_hi[w], causal, window);
              wall[w] = wall[w] &&
                        all_live(kv[u], w_lo[w], w_hi[w], causal, window);
            }
          }
        }
        if (end || __ballot_sync(FULL, any)) {
          int wc[2];
#pragma unroll
          for (int w = 0; w < 2; ++w)
            wc[w] = !__ballot_sync(FULL, wany[w])          ? 0
                    : __ballot_sync(FULL, wall[w]) == FULL ? 2
                                                           : 1;
          // the stage is free once its last tile's P.V is done (the first
          // round passes at once)
          if (lane == 0) mbar_wait(&empty[stage], phase ^ 1);
          __syncwarp();
#pragma unroll
          for (int u = 0; u < 4; ++u)
            kpos_sh[stage * WK + lane + 32 * u] = kv[u];
          __syncwarp();
          if (lane == 0) {
            meta[4 * stage] = end ? T : t0;
            meta[4 * stage + 1] = wc[0];
            meta[4 * stage + 2] = wc[1];
            if (end) {
              mbar_arrive(&full[stage]);
            } else {
              mbar_expect_tx(&full[stage], 2 * L::KV_BYTES);
              for (int s = 0; s < L::NS; ++s) {
                const int at = stage * L::KV_BYTES + s * WK * L::SPAN;
                tma_load(k_sh + at, &tm_k, &full[stage], s * L::CW, hk, t0,
                         b);
                tma_load(v_sh + at, &tm_v, &full[stage], s * L::CW, hk, t0,
                         b);
              }
            }
          }
          __syncwarp();
          if (end) break;
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) kv[u] = nx[u];
      }
    }
  } else {
    // consumers: warpgroup wq owns rows q0 + 64 wq .. + 63; each warp 16
    // of them, each thread rows row0 and row0 + 8 (the accumulator layout)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wq = warp >> 2;
    const int r_wg = q0 + 64 * wq;
    const int row0 = r_wg + 16 * (warp & 3) + (lane >> 2);
    const int fc = (lane & 3) * 2;
    int qp[2];  // (a row past S is computed, never written)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qp[i] = q_pos[min(row0 + 8 * i, S - 1)];

    // running max (in raw scores), this thread's share of the row sums,
    // the rescale of O owed from the last softmax, the last P in bf16
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float alpha[2] = {1.0f, 1.0f};
    float o[L::NS][L::CW / 2];
#pragma unroll
    for (int sl = 0; sl < L::NS; ++sl)
#pragma unroll
      for (int e = 0; e < L::CW / 2; ++e) o[sl][e] = 0.0f;
    unsigned pa[WK / 16][4];
    const float sl2 = scale * 1.4426950408889634f;  // scale . log2(e)

    // S_j = Q.K_j^T into s, 16 columns of D a step (both K-major slabs)
    auto issue_s = [&](int stg, float* s) {
      const unsigned char* ks = k_sh + stg * L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int slab = kk * 16 / L::CW, off = (kk * 16 % L::CW) * 2;
        const uint64_t da = smem_desc(
            q_sh + slab * WQ * L::SPAN + wq * 64 * L::SPAN + off, 16,
            8 * L::SPAN, L::SWZ);
        const uint64_t db = smem_desc(ks + slab * WK * L::SPAN + off, 16,
                                      8 * L::SPAN, L::SWZ);
        if (kk == 0)
          wgmma_ss_n128_first(s, da, db);
        else
          wgmma_ss_n128(s, da, db);
      }
    };
    // O += P.V from the A fragments pa, 16 keys a step (V MN-major)
    auto issue_pv = [&](int stg) {
      const unsigned char* vs = v_sh + stg * L::KV_BYTES;
#pragma unroll
      for (int kc = 0; kc < WK / 16; ++kc)
#pragma unroll
        for (int sl = 0; sl < L::NS; ++sl)
          wgmma_rs<L::CW>(
              o[sl], pa[kc],
              smem_desc(vs + sl * WK * L::SPAN + kc * 16 * L::SPAN,
                        WK * L::SPAN, 8 * L::SPAN, L::SWZ));
    };
    // the softmax of the tile in stage stg (its class for this warpgroup
    // wcls), in s
    auto softmax = [&](float* s, int stg, int wcls) {
      if (wcls == 2) {
        softmax_tile<false>(s, 0, m, l, alpha, sl2);
        return;
      }
      unsigned long long live = 0;
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = kpos_sh[stg * WK + 8 * j + fc + c];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (live_key(kp, qp[i], causal, window))
              live |= 1ull << (4 * j + 2 * i + c);
        }
      softmax_tile<true>(s, live, m, l, alpha, sl2);
    };
    // P rounded to bf16: the A fragments of the next P.V
    auto pack_p = [&](const float* s) {
#pragma unroll
      for (int kc = 0; kc < WK / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int sl = 0; sl < L::NS; ++sl)
#pragma unroll
        for (int nb = 0; nb < L::CW / 8; ++nb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[sl][4 * nb + 2 * i] *= alpha[i];
            o[sl][4 * nb + 2 * i + 1] *= alpha[i];
          }
#pragma unroll
      for (int sl = 0; sl < L::NS; ++sl) reg_fence<L::CW / 2>(o[sl]);
    };
    auto release = [&](int stg) {  // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stg]);
    };

    // Turn j issues S_j and O += P_{j-1}.V_{j-1} together; the two
    // warpgroups take turns (named barriers 1 and 2), so one's softmax
    // overlaps the other's products.  Warpgroup 0 goes first.  The first
    // turn has no P.V and a last turn no S.
    mbar_wait(q_full, 0);
    if (wq == 1) named_arrive(1, 256);
    int stage = 0;
    unsigned phase = 0;
    mbar_wait(&full[stage], phase);
    int t0 = meta[0];
    if (t0 < T) {
      {
        const int wcls = meta[1 + wq];
        float s[WK / 2];
        named_sync(1 + wq, 256);
        wgmma_fence();
        issue_s(stage, s);
        wgmma_commit();
        named_arrive(2 - wq, 256);
        wgmma_wait<0>();
        reg_fence<WK / 2>(s);
        softmax(s, stage, wcls);
        pack_p(s);
      }
      for (;;) {
        const int pstage = stage;
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
        mbar_wait(&full[stage], phase);
        t0 = meta[4 * stage];
        if (t0 >= T) {  // the last turn: the last tile's P.V
          rescale_o();
          named_sync(1 + wq, 256);
          wgmma_fence();
          issue_pv(pstage);
          wgmma_commit();
          named_arrive(2 - wq, 256);
          wgmma_wait<0>();
#pragma unroll
          for (int sl = 0; sl < L::NS; ++sl) reg_fence<L::CW / 2>(o[sl]);
          release(pstage);
          break;
        }
        const int wcls = meta[4 * stage + 1 + wq];
        rescale_o();
        float s[WK / 2];
        named_sync(1 + wq, 256);
        wgmma_fence();
        issue_s(stage, s);
        wgmma_commit();
        wgmma_fence();
        issue_pv(pstage);
        wgmma_commit();
        named_arrive(2 - wq, 256);
        wgmma_wait<1>();  // S landed; P.V may still run
        reg_fence<WK / 2>(s);
        softmax(s, stage, wcls);
        wgmma_wait<0>();  // P.V done: the last tile's stage is free
#pragma unroll
        for (int sl = 0; sl < L::NS; ++sl) reg_fence<L::CW / 2>(o[sl]);
        release(pstage);
        pack_p(s);
      }
    }
    if (wq == 0) named_sync(1, 256);  // warpgroup 1's last arrival

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[i];
      lt += __shfl_xor_sync(FULL, lt, 1);
      lt += __shfl_xor_sync(FULL, lt, 2);
      const int r = row0 + 8 * i;
      if (r < S) {
        const float inv = lt > 0.0f ? 1.0f / lt : 0.0f;
        bf16* orow = out + ((size_t)(b * S + r) * Hq + h) * D;
#pragma unroll
        for (int sl = 0; sl < L::NS; ++sl)
#pragma unroll
          for (int nb = 0; nb < L::CW / 8; ++nb) {
            const int col = sl * L::CW + 8 * nb + fc;
            if (col < D)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(o[sl][4 * nb + 2 * i] * inv,
                                        o[sl][4 * nb + 2 * i + 1] * inv);
          }
      }
    }
  }
}

// t + the dot of eight bf16 pairs, in f32.
__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b, float t) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]), y = __bfloat1622float2(pb[i]);
    t = fmaf(x.x, y.x, t);
    t = fmaf(x.y, y.y, t);
  }
  return t;
}

// flash_decode_partial_kernel for bf16 q, k, v: the same partials (f32),
// p rounded to bf16 before P.V.
template <int DP>
__global__ void __launch_bounds__(DT) flash_decode_partial_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int S, int T,
    int Hq, int Hkv, int D, int causal, int window, float scale) {
  constexpr int ST = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, group = Hq / Hkv, R = S * group;
  bf16* q_sh = reinterpret_cast<bf16*>(smem_bytes);    // [R][ST]
  bf16* k_sh = q_sh + R * ST;                          // [BK][ST]
  bf16* v_sh = k_sh + BK * ST;                          // [BK][DP]
  float* p_sh = reinterpret_cast<float*>(v_sh + BK * DP);  // [R][PS]
  const int t0 = split * BK, nk = min(BK, T - t0);

  int q_lo, q_hi;
  pos_range(q_pos, S, lane, q_lo, q_hi);
  if (!classify(k_pos, t0, T, q_lo, q_hi, causal, window, lane)) {
    for (int r = tid; r < R; r += DT) {
      const int s = r / group, h = hk * group + r % group;
      const size_t at = ((size_t)(b * S + s) * Hq + h) * n_split + split;
      part_m[at] = -INFINITY;
      part_l[at] = 0.0f;
    }
    return;
  }

  for (int e = tid; e < R * (DP / 8); e += DT) {
    const int r = e / (DP / 8), c8 = (e % (DP / 8)) * 8;
    const int s = r / group, h = hk * group + r % group;
    cp_async16_any(q_sh + r * ST + c8,
                   q + ((size_t)(b * S + s) * Hq + h) * D + (c8 < D ? c8 : 0),
                   c8 < D);
  }
  stage_rows_bf16<DP, DT>(k_sh, ST, k, (size_t)b * T + t0, BK, nk, Hkv, hk,
                          D, tid);
  stage_rows_bf16<DP, DT>(v_sh, DP, v, (size_t)b * T + t0, BK, nk, Hkv, hk,
                          D, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  {  // scores: thread owns key c and rows rg, rg + 2, ...
    const int c = tid & (BK - 1), rg = tid / BK;
    const int kp = c < nk ? k_pos[t0 + c] : -1;
    for (int r = rg; r < R; r += DT / BK) {
      float t = 0.0f;
#pragma unroll
      for (int d = 0; d < DP; d += 8)
        t = dot8_bf16(*reinterpret_cast<const uint4*>(q_sh + r * ST + d),
                      *reinterpret_cast<const uint4*>(k_sh + c * ST + d), t);
      p_sh[r * PS + c] =
          live_key(kp, q_pos[r / group], causal, window) ? t * scale
                                                         : -INFINITY;
    }
  }
  __syncthreads();

  // softmax of the split, a warp a row: the sum of p in f32, p rounded to
  // bf16 for P.V
  for (int r = warp; r < R; r += DT / 32) {
    const float s0 = p_sh[r * PS + lane], s1 = p_sh[r * PS + lane + 32];
    float mx = fmaxf(s0, s1);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float p0 = 0.0f, p1 = 0.0f;
    if (mx != -INFINITY) {
      p0 = expf(s0 - mx);
      p1 = expf(s1 - mx);
    }
    float sum = p0 + p1;
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    p_sh[r * PS + lane] = __bfloat162float(__float2bfloat16(p0));
    p_sh[r * PS + lane + 32] = __bfloat162float(__float2bfloat16(p1));
    if (lane == 0) {
      const int s = r / group, h = hk * group + r % group;
      const size_t at = ((size_t)(b * S + s) * Hq + h) * n_split + split;
      part_m[at] = mx;
      part_l[at] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < R * DP; e += DT) {
    const int r = e / DP, d = e % DP;
    if (d >= D) continue;
    float t = 0.0f;
#pragma unroll 8
    for (int c = 0; c < BK; ++c)
      t = fmaf(p_sh[r * PS + c], __bfloat162float(v_sh[c * DP + d]), t);
    const int s = r / group, h = hk * group + r % group;
    part_acc[(((size_t)(b * S + s) * Hq + h) * n_split + split) * D + d] = t;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The tile width the source builds for head dim D: the smallest of 16, 32,
// 64 and 128 that holds it, for D a multiple of 8 from 8 to 128; 0 for any
// other D.
static int padded_head_dim(int D) {
  if (D < 8 || D > 128 || D % 8) return 0;
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

template <class K>
static int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
static int launch_prefill(const float* q, const float* k, const float* v,
                          const int* q_pos, const int* k_pos, float* out,
                          float* lse, int B, int S, int T, int Hq, int Hkv,
                          int D, int causal, int window, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (3 * BQ * (DP + 4) + 2 * BK * DP + BQ * PS);
  int e = allow_smem(flash_prefill_kernel<DP>, smem);
  if (e) return e;
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_prefill_kernel<DP><<<grid, PT, smem, st>>>(
      q, k, v, q_pos, k_pos, out, lse, S, T, Hq, Hkv, D, causal, window,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_decode(const float* q, const float* k, const float* v,
                         const int* q_pos, const int* k_pos, float* out,
                         float* part_m, float* part_l, float* part_acc, int B,
                         int S, int T, int Hq, int Hkv, int D, int causal,
                         int window, cudaStream_t st) {
  const int R = S * (Hq / Hkv);
  const size_t smem =
      sizeof(float) * ((R + BK) * (DP + 4) + BK * DP + R * PS);
  int e = allow_smem(flash_decode_partial_kernel<DP>, smem);
  if (e) return e;
  const int n_split = (T + BK - 1) / BK;
  flash_decode_partial_kernel<DP><<<dim3(n_split, Hkv, B), DT, smem, st>>>(
      q, k, v, q_pos, k_pos, part_m, part_l, part_acc, S, T, Hq, Hkv, D,
      causal, window, 1.0f / sqrtf((float)D));
  e = (int)cudaGetLastError();
  if (e) return e;
  const int rows = B * S * Hq;
  flash_decode_combine_kernel<float>
      <<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
          part_m, part_l, part_acc, out, rows, n_split, D);
  return (int)cudaGetLastError();
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
// boxes of cw values of one head over box_rows rows, swizzled on 2 cw
// bytes; elements out of bounds (columns D.., rows past `rows`) read as 0.
static int encode_rows(CUtensorMap* map, const bf16* base, int B, int rows,
                       int heads, int D, int cw, int box_rows,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<bf16*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP>
static int launch_prefill_bf16(const bf16* q, const bf16* k, const bf16* v,
                               const int* q_pos, const int* k_pos, bf16* out,
                               int B, int S, int T, int Hq, int Hkv, int D,
                               int causal, int window, cudaStream_t st) {
  using L = WTile<DP>;
  const CUtensorMapSwizzle swizzle =
      L::SPAN == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::SPAN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  int e = encode_rows(&tq, q, B, S, Hq, D, L::CW, WQ, swizzle);
  if (!e) e = encode_rows(&tk, k, B, T, Hkv, D, L::CW, WK, swizzle);
  if (!e) e = encode_rows(&tv, v, B, T, Hkv, D, L::CW, WK, swizzle);
  if (!e) e = allow_smem(flash_prefill_bf16_hopper_kernel<DP>, L::SMEM);
  if (e) return e;
  const dim3 grid((S + WQ - 1) / WQ, B * Hq);
  flash_prefill_bf16_hopper_kernel<DP><<<grid, WTHREADS, L::SMEM, st>>>(
      tq, tk, tv, q_pos, k_pos, out, S, T, Hq, Hkv, D, causal, window,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_decode_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const int* q_pos, const int* k_pos, bf16* out,
                              float* part_m, float* part_l, float* part_acc,
                              int B, int S, int T, int Hq, int Hkv, int D,
                              int causal, int window, cudaStream_t st) {
  const int R = S * (Hq / Hkv);
  const size_t smem = sizeof(bf16) * ((size_t)(R + BK) * (DP + 8) + BK * DP) +
                      sizeof(float) * (size_t)R * PS;
  int e = allow_smem(flash_decode_partial_bf16_kernel<DP>, smem);
  if (e) return e;
  const int n_split = (T + BK - 1) / BK;
  flash_decode_partial_bf16_kernel<DP>
      <<<dim3(n_split, Hkv, B), DT, smem, st>>>(
          q, k, v, q_pos, k_pos, part_m, part_l, part_acc, S, T, Hq, Hkv, D,
          causal, window, 1.0f / sqrtf((float)D));
  e = (int)cudaGetLastError();
  if (e) return e;
  const int rows = B * S * Hq;
  flash_decode_combine_kernel<bf16>
      <<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
          part_m, part_l, part_acc, out, rows, n_split, D);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_backward(const float* q, const float* k, const float* v,
                           const float* out, const float* dout,
                           const float* lse, const int* q_pos,
                           const int* k_pos, float* delta, float* part,
                           float* dq, float* dk, float* dv, int B, int S,
                           int T, int Hq, int Hkv, int D, int causal,
                           int window, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)D);
  const int rows = B * S * Hq;
  flash_bwd_dot_kernel<<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
      out, dout, delta, rows, S, Hq, D);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t kv_smem = sizeof(float) * (2 * BK * (DP + 4) +
                                          2 * BQ * (DP + 4) + 2 * BK * PS +
                                          3 * BQ);
  e = allow_smem(flash_bwd_dkdv_kernel<DP>, kv_smem);
  if (e) return e;
  // one query head's share per block; a group's shares are added after
  const size_t n_part = (size_t)B * T * Hq * D;
  float* pk = Hq == Hkv ? dk : part;
  float* pv = Hq == Hkv ? dv : part + n_part;
  flash_bwd_dkdv_kernel<DP>
      <<<dim3(B * Hq, (T + BK - 1) / BK), PT, kv_smem, st>>>(
          q, k, v, dout, lse, delta, q_pos, k_pos, pk, pv, S, T, Hq, Hkv, D,
          causal, window, scale);
  e = (int)cudaGetLastError();
  if (e) return e;
  if (Hq != Hkv) {
    const size_t n = (size_t)B * T * Hkv * D;
    flash_bwd_group_sum_kernel<<<(unsigned)((n + DT - 1) / DT), DT, 0, st>>>(
        pk, pv, dk, dv, n, Hq, Hkv, D);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  const size_t q_smem =
      sizeof(float) * (2 * BQ * (DP + 4) + 2 * BK * (DP + 4) + BQ * PS);
  e = allow_smem(flash_bwd_dq_kernel<DP>, q_smem);
  if (e) return e;
  flash_bwd_dq_kernel<DP>
      <<<dim3(B * Hq, (S + BQ - 1) / BQ), PT, q_smem, st>>>(
          q, k, v, dout, lse, delta, q_pos, k_pos, dq, S, T, Hq, Hkv, D,
          causal, window, scale);
  return (int)cudaGetLastError();
}

// Calls LAUNCH<DP>(args...) at the tile width of head dim D; an
// unsupported D returns cudaErrorInvalidValue.
#define DISPATCH_HEAD_DIM(D, LAUNCH, ...)                 \
  switch (padded_head_dim(D)) {                           \
    case 16:                                              \
      return LAUNCH<16>(__VA_ARGS__);                     \
    case 32:                                              \
      return LAUNCH<32>(__VA_ARGS__);                     \
    case 64:                                              \
      return LAUNCH<64>(__VA_ARGS__);                     \
    case 128:                                             \
      return LAUNCH<128>(__VA_ARGS__);                    \
    default:                                              \
      return (int)cudaErrorInvalidValue;                  \
  }

extern "C" {

// Keys per split of the decode path.
int flash_attention_split_keys(void) { return BK; }

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  q/out [B,S,Hq,D], k/v [B,T,Hkv,D] row-major f32
// with 16-byte aligned bases; q_pos [S], k_pos [T] int32; all device
// memory.  lse, when not null, receives each row's log-sum-exp of scaled
// scores, [B,Hq,S] f32 (-inf for a row with no live key); when null the
// kernel writes out only.  window <= 0: no window.  D must be a multiple
// of 8 from 8 to 128 (the kernels run at the tile width padded_head_dim(D)
// with the columns past D zero in shared memory and never written) and Hq
// a multiple of Hkv (the wrapper checks; another D returns
// cudaErrorInvalidValue).
int flash_attention_prefill(const float* q, const float* k, const float* v,
                            const int* q_pos, const int* k_pos, float* out,
                            float* lse, int B, int S, int T, int Hq, int Hkv,
                            int D, int causal, int window, void* stream) {
  DISPATCH_HEAD_DIM(D, launch_prefill, q, k, v, q_pos, k_pos, out, lse, B, S,
                    T, Hq, Hkv, D, causal, window, (cudaStream_t)stream)
}

// As flash_attention_prefill, with scratch for the partials: part_m and
// part_l hold B*S*Hq*n_split floats and part_acc D times as many, n_split =
// ceil(T / flash_attention_split_keys()).  One block holds the
// R = S * Hq/Hkv query rows of a KV head in shared memory, so R must be
// small (a decode step; the wrapper picks the entry point).
int flash_attention_decode(const float* q, const float* k, const float* v,
                           const int* q_pos, const int* k_pos, float* out,
                           float* part_m, float* part_l, float* part_acc,
                           int B, int S, int T, int Hq, int Hkv, int D,
                           int causal, int window, void* stream) {
  DISPATCH_HEAD_DIM(D, launch_decode, q, k, v, q_pos, k_pos, out, part_m,
                    part_l, part_acc, B, S, T, Hq, Hkv, D, causal, window,
                    (cudaStream_t)stream)
}

// The backward of flash_attention_prefill: dq [B,S,Hq,D] and dk, dv
// [B,T,Hkv,D], f32, from q, k, v, the forward's out and lse, and dout
// [B,S,Hq,D], with the forward's positions and masks.  delta is scratch of
// B*Hq*S floats; part, scratch of 2*B*T*Hq*D floats for the query heads'
// shares of dK and dV, may be null when Hq == Hkv.  Three launches on
// `stream` (D, dK/dV, dQ), four with a group sum when Hq > Hkv; allocates
// nothing, does not synchronise, returns cudaGetLastError().
int flash_attention_backward(const float* q, const float* k, const float* v,
                             const float* out, const float* dout,
                             const float* lse, const int* q_pos,
                             const int* k_pos, float* delta, float* part,
                             float* dq, float* dk, float* dv, int B, int S,
                             int T, int Hq, int Hkv, int D, int causal,
                             int window, void* stream) {
  DISPATCH_HEAD_DIM(D, launch_backward, q, k, v, out, dout, lse, q_pos, k_pos,
                    delta, part, dq, dk, dv, B, S, T, Hq, Hkv, D, causal,
                    window, (cudaStream_t)stream)
}

// As flash_attention_prefill for q, k, v and out in bf16 (same layout,
// 16-byte aligned bases), without the log-sum-exp output: the Hopper
// kernel (TMA, wgmma, a producer warp), f32 softmax and accumulation, P
// and the result rounded to bf16.  cudaErrorNotSupported if libcuda has
// no tensor-map encoder.
int flash_attention_prefill_bf16(const bf16* q, const bf16* k, const bf16* v,
                                 const int* q_pos, const int* k_pos,
                                 bf16* out, int B, int S, int T, int Hq,
                                 int Hkv, int D, int causal, int window,
                                 void* stream) {
  DISPATCH_HEAD_DIM(D, launch_prefill_bf16, q, k, v, q_pos, k_pos, out, B, S,
                    T, Hq, Hkv, D, causal, window, (cudaStream_t)stream)
}

// As flash_attention_decode for q, k, v and out in bf16; the partials are
// f32 scratch of the same sizes.
int flash_attention_decode_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const int* q_pos, const int* k_pos, bf16* out,
                                float* part_m, float* part_l,
                                float* part_acc, int B, int S, int T, int Hq,
                                int Hkv, int D, int causal, int window,
                                void* stream) {
  DISPATCH_HEAD_DIM(D, launch_decode_bf16, q, k, v, q_pos, k_pos, out, part_m,
                    part_l, part_acc, B, S, T, Hq, Hkv, D, causal, window,
                    (cudaStream_t)stream)
}

}  // extern "C"
