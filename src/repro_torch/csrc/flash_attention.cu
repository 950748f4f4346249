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
// bf16 (flash_attention_prefill_bf16, flash_attention_decode_bf16): the
// same TPU kernel as it runs in the reference's working type, on q, k, v
// and out in bf16, with its algebra (kernel.py:62-84): scores in f32 from
// the bf16 inputs, the unnormalised P = exp(s - m) rounded to bf16 before
// P.V, the row sums and the accumulator in f32, one rounding of the
// normalised result to bf16.
// Forward only; the backward stays f32.
//
// Prefill bf16: the same grid, tile classification and two-stage cp.async
// ring as the f32 prefill, 16 bytes now 8 values.  Bound by bytes at the
// serving shapes (yi-34b's 4 x 512 prefill, 56 heads of 128 over 8: about
// 15 GFLOP, 15 us at the 989 TFLOP/s of bf16 tensor cores, against 67 MB,
// 20 us at 3.35 TB/s), so the products go to the tensor cores and the rest
// of the block's work (masks, exp, the online softmax) is what a tile
// costs.  Each of the 4 warps owns 16 query rows: S = Q.K^T by
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with Q's fragments taken once
// by ldmatrix and kept in registers and K's by ldmatrix from the tile; the
// online softmax runs on the f32 accumulator fragments (a row's max and
// sum over the four lanes that hold it); P is rounded to bf16 in registers
// and is the A operand of P.V, with V's fragments by ldmatrix.trans.  Rows
// of every tile are D + 8 values apart, so the eight row addresses of an
// ldmatrix fall on distinct banks.  No wgmma, TMA or warp specialisation
// yet: a simple kernel that is right first.
//
// Decode bf16: the f32 decode's split-key design (bound by bytes: the live
// K/V read once, half the bytes of an f32 cache), reading K/V and q as bf16
// by cp.async; scores, partials and the merge in f32 on CUDA cores, p
// rounded to bf16 before it multiplies V, the merged row written in bf16.
// The merge is the f32 path's, in split order: two runs are bit-identical.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// Rows [r0, r0 + rows) of a [*, Hkv or Hq, D] tensor at head `head`, rows
// `valid` and beyond zero-filled, into sh[rows][stride] by cp.async.
template <int D, int NTH>
__device__ __forceinline__ void stage_rows(float* sh, int stride,
                                           const float* src, size_t row0,
                                           int rows, int valid, int heads,
                                           int head, int tid) {
  for (int e = tid; e < rows * (D / 4); e += NTH) {
    const int r = e / (D / 4), c4 = (e % (D / 4)) * 4;
    const bool ok = r < valid;
    const float* g =
        src + ((row0 + (ok ? r : 0)) * heads + head) * D + c4;
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

// Output column e (0 <= e < D/8) of thread tx: float4 groups 32 apart when
// D >= 32, so the eight threads of a quarter warp read distinct banks.
template <int D>
__device__ __forceinline__ int out_col(int tx, int e) {
  if constexpr (D >= 32)
    return (e >> 2) * 32 + tx * 4 + (e & 3);
  else
    return tx * (D / 8) + e;
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(PT) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out,
    float* __restrict__ lse, int S, int T, int Hq, int Hkv, int causal,
    int window, float scale) {
  constexpr int KS = D + 4;  // row stride of Q and K tiles
  constexpr int DV = D / 8;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                 // [BQ][KS]
  float* k_sh = q_sh + BQ * KS;       // 2 x [BK][KS]
  float* v_sh = k_sh + 2 * BK * KS;   // 2 x [BK][D]
  float* p_sh = v_sh + 2 * BK * D;    // [BQ][PS]

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
  stage_rows<D, PT>(q_sh, KS, q, (size_t)b * S + q0, BQ, nq, Hq, h, tid);
  if (cur < T) {
    stage_rows<D, PT>(k_sh, KS, k, (size_t)b * T + cur, BK, T - cur, Hkv, hk,
                      tid);
    stage_rows<D, PT>(v_sh, D, v, (size_t)b * T + cur, BK, T - cur, Hkv, hk,
                      tid);
  }
  cp_async_commit();

  int stage = 0;
  while (cur < T) {
    int nxt_cls;
    const int nxt = next_tile(k_pos, cur + BK, T, q_lo, q_hi, causal, window,
                              lane, nxt_cls);
    if (nxt < T) {  // the next tile flies while this one computes
      stage_rows<D, PT>(k_sh + (stage ^ 1) * BK * KS, KS, k,
                        (size_t)b * T + nxt, BK, T - nxt, Hkv, hk, tid);
      stage_rows<D, PT>(v_sh + (stage ^ 1) * BK * D, D, v,
                        (size_t)b * T + nxt, BK, T - nxt, Hkv, hk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) has landed for every thread

    const float* ks = k_sh + stage * BK * KS;
    const float* vs = v_sh + stage * BK * D;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
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
        const float* vr = vs + (c + cc) * D;
        if constexpr (D >= 32) {
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
          for (int e = 0; e < DV; ++e) vv[e] = vr[out_col<D>(tx, e)];
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
      for (int e = 0; e < DV; ++e) o[out_col<D>(tx, e)] = acc[i][e] * inv;
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
template <int D>
__global__ void __launch_bounds__(DT) flash_decode_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int S, int T,
    int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int KS = D + 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, group = Hq / Hkv, R = S * group;
  float* q_sh = smem;             // [R][KS]
  float* k_sh = q_sh + R * KS;    // [BK][KS]
  float* v_sh = k_sh + BK * KS;   // [BK][D]
  float* p_sh = v_sh + BK * D;    // [R][PS]
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

  for (int e = tid; e < R * (D / 4); e += DT) {
    const int r = e / (D / 4), c4 = (e % (D / 4)) * 4;
    const int s = r / group, h = hk * group + r % group;
    cp_async16(q_sh + r * KS + c4, q + ((size_t)(b * S + s) * Hq + h) * D + c4,
               true);
  }
  stage_rows<D, DT>(k_sh, KS, k, (size_t)b * T + t0, BK, nk, Hkv, hk, tid);
  stage_rows<D, DT>(v_sh, D, v, (size_t)b * T + t0, BK, nk, Hkv, hk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  {  // scores: thread owns key c and rows rg, rg + 2, ...
    const int c = tid & (BK - 1), rg = tid / BK;
    const int kp = c < nk ? k_pos[t0 + c] : -1;
    for (int r = rg; r < R; r += DT / BK) {
      float t = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
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

  for (int e = tid; e < R * D; e += DT) {
    const int r = e / D, d = e % D;
    float t = 0.0f;
#pragma unroll 8
    for (int c = 0; c < BK; ++c)
      t = fmaf(p_sh[r * PS + c], v_sh[c * D + d], t);
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

// The D/8 output columns out_col(tx, e) of one shared-memory row, as
// float4 loads where D >= 32.
template <int D>
__device__ __forceinline__ void load_cols(const float* row, int tx,
                                          float* out) {
  if constexpr (D >= 32) {
#pragma unroll
    for (int e = 0; e < D / 8; e += 4) {
      const float4 t =
          *reinterpret_cast<const float4*>(row + (e >> 2) * 32 + tx * 4);
      out[e] = t.x;
      out[e + 1] = t.y;
      out[e + 2] = t.z;
      out[e + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < D / 8; ++e) out[e] = row[out_col<D>(tx, e)];
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
template <int D>
__global__ void __launch_bounds__(PT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dk, float* __restrict__ dv, int S, int T, int Hq,
    int Hkv, int causal, int window, float scale) {
  constexpr int KS = D + 4;
  constexpr int DV = D / 8;
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

  stage_rows<D, PT>(k_sh, KS, k, (size_t)b * T + t0, BK, nk, Hkv, hk, tid);
  stage_rows<D, PT>(v_sh, KS, v, (size_t)b * T + t0, BK, nk, Hkv, hk, tid);
  cp_async_commit();

  for (int q0 = 0; q0 < S; q0 += BQ) {
    const int nq = min(BQ, S - q0);
    int q_lo, q_hi;
    pos_range(q_pos + q0, nq, lane, q_lo, q_hi);
    if (!classify(k_pos, t0, T, q_lo, q_hi, causal, window, lane))
      continue;  // no live pair between this query tile and the keys
    stage_rows<D, PT>(q_sh, KS, q, (size_t)b * S + q0, BQ, nq, Hq, h, tid);
    stage_rows<D, PT>(do_sh, KS, dout, (size_t)b * S + q0, BQ, nq, Hq, h,
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
    for (int d = 0; d < D; d += 4) {
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
    for (int d = 0; d < D; d += 4) {
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
        load_cols<D>(do_sh + (c + cc) * KS, tx, gv);
        load_cols<D>(q_sh + (c + cc) * KS, tx, qv);
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
        dk[row + out_col<D>(tx, e)] = dk_acc[i][e] * scale;
        dv[row + out_col<D>(tx, e)] = dv_acc[i][e];
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
template <int D>
__global__ void __launch_bounds__(PT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dq, int S, int T, int Hq, int Hkv, int causal,
    int window, float scale) {
  constexpr int KS = D + 4;
  constexpr int DV = D / 8;
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

  stage_rows<D, PT>(q_sh, KS, q, (size_t)b * S + q0, BQ, nq, Hq, h, tid);
  stage_rows<D, PT>(do_sh, KS, dout, (size_t)b * S + q0, BQ, nq, Hq, h, tid);
  cp_async_commit();

  int cls;
  for (int cur = next_tile(k_pos, 0, T, q_lo, q_hi, causal, window, lane, cls);
       cur < T;
       cur = next_tile(k_pos, cur + BK, T, q_lo, q_hi, causal, window, lane,
                       cls)) {
    stage_rows<D, PT>(k_sh, KS, k, (size_t)b * T + cur, BK, T - cur, Hkv, hk,
                      tid);
    stage_rows<D, PT>(v_sh, KS, v, (size_t)b * T + cur, BK, T - cur, Hkv, hk,
                      tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // this key tile (and Q, dO) landed

    float s[4][8], p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
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
    for (int d = 0; d < D; d += 4) {
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
        load_cols<D>(k_sh + (c + cc) * KS, tx, kv);
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
      for (int e = 0; e < DV; ++e) o[out_col<D>(tx, e)] = acc[i][e] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: the prefill on tensor cores, the split-key decode
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

// As stage_rows, for bf16 rows (8 values a copy).
template <int D, int NTH>
__device__ __forceinline__ void stage_rows_bf16(bf16* sh, int stride,
                                                const bf16* src, size_t row0,
                                                int rows, int valid,
                                                int heads, int head,
                                                int tid) {
  for (int e = tid; e < rows * (D / 8); e += NTH) {
    const int r = e / (D / 8), c8 = (e % (D / 8)) * 8;
    const bool ok = r < valid;
    const bf16* g = src + ((row0 + (ok ? r : 0)) * heads + head) * D + c8;
    cp_async16_any(sh + r * stride + c8, g, ok);
  }
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 and receives in r[j] its two values of
// matrix j (row lane / 4, columns 2 (lane % 4) and + 1; with trans, of
// the matrix transposed).
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a . b for a 16x16 bf16 A (row-major fragments), a 16x8 bf16 B
// (column-major fragments) and a 16x8 f32 C: c[0], c[1] hold row lane / 4,
// columns 2 (lane % 4) and + 1, c[2], c[3] the same columns of row
// lane / 4 + 8.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int D>
__global__ void __launch_bounds__(PT) flash_prefill_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, bf16* __restrict__ out, int S, int T,
    int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int ST = D + 8;   // row stride of every tile, in values
  constexpr int NKS = D / 16; // k-steps of Q.K^T
  constexpr int ND = D / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem_bytes);  // [BQ][ST]
  bf16* k_sh = q_sh + BQ * ST;                       // 2 x [BK][ST]
  bf16* v_sh = k_sh + 2 * BK * ST;                   // 2 x [BK][ST]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fc = (lane & 3) * 2;  // a fragment's row, column
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, S - q0);
  const int r0 = warp * 16;  // the warp's rows in the tile

  int q_lo, q_hi;
  pos_range(q_pos + q0, nq, lane, q_lo, q_hi);
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + fr + 8 * i;
    qp[i] = r < nq ? q_pos[q0 + r] : q_hi;
  }

  // per row (fr, fr + 8): the running max, this lane's share of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  unsigned qf[NKS][4];

  int cls;
  int cur = next_tile(k_pos, 0, T, q_lo, q_hi, causal, window, lane, cls);
  stage_rows_bf16<D, PT>(q_sh, ST, q, (size_t)b * S + q0, BQ, nq, Hq, h,
                         tid);
  if (cur < T) {
    stage_rows_bf16<D, PT>(k_sh, ST, k, (size_t)b * T + cur, BK, T - cur,
                           Hkv, hk, tid);
    stage_rows_bf16<D, PT>(v_sh, ST, v, (size_t)b * T + cur, BK, T - cur,
                           Hkv, hk, tid);
  }
  cp_async_commit();

  bool have_q = false;
  int stage = 0;
  while (cur < T) {
    int nxt_cls;
    const int nxt = next_tile(k_pos, cur + BK, T, q_lo, q_hi, causal, window,
                              lane, nxt_cls);
    if (nxt < T) {  // the next tile flies while this one computes
      stage_rows_bf16<D, PT>(k_sh + (stage ^ 1) * BK * ST, ST, k,
                             (size_t)b * T + nxt, BK, T - nxt, Hkv, hk, tid);
      stage_rows_bf16<D, PT>(v_sh + (stage ^ 1) * BK * ST, ST, v,
                             (size_t)b * T + nxt, BK, T - nxt, Hkv, hk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) has landed for every thread

    if (!have_q) {  // Q's A fragments, once
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
        ldmatrix_x4(qf[kk],
                    q_sh + (r0 + (lane & 15)) * ST + kk * 16 + (lane >> 4) * 8);
      have_q = true;
    }
    const bf16* ks = k_sh + stage * BK * ST;
    const bf16* vs = v_sh + stage * BK * ST;

    // S = Q.K^T: eight 16x8 tiles, keys 8j .. 8j + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bf[4];
        ldmatrix_x4(bf, ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * ST +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }
    }
    if (cls == 2) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = cur + 8 * j + fc + c;
          const int kp = t < T ? k_pos[t] : -1;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            s[j][2 * i + c] = live_key(kp, qp[i], causal, window)
                                  ? s[j][2 * i + c] * scale
                                  : -INFINITY;
        }
    }

    // online softmax on the fragments: a row's four lanes are lane ^ 1, ^ 2
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.0f, sum = 0.0f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pj = expf(s[j][2 * i + c] - m_new);
            s[j][2 * i + c] = pj;
            sum += pj;
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][2 * i] = s[j][2 * i + 1] = 0.0f;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }

    // O += P.V: P rounded to bf16 is the A operand, 16 keys a step
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, vs + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * ST +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it refills

    cur = nxt;
    cls = nxt_cls;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const int r = r0 + fr + 8 * i;
    if (r < nq) {
      const float inv = lt > 0.0f ? 1.0f / lt : 0.0f;
      bf16* orow = out + ((size_t)(b * S + q0 + r) * Hq + h) * D;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d + fc) =
            __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
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
template <int D>
__global__ void __launch_bounds__(DT) flash_decode_partial_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int S, int T,
    int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, group = Hq / Hkv, R = S * group;
  bf16* q_sh = reinterpret_cast<bf16*>(smem_bytes);    // [R][ST]
  bf16* k_sh = q_sh + R * ST;                          // [BK][ST]
  bf16* v_sh = k_sh + BK * ST;                         // [BK][D]
  float* p_sh = reinterpret_cast<float*>(v_sh + BK * D);  // [R][PS]
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

  for (int e = tid; e < R * (D / 8); e += DT) {
    const int r = e / (D / 8), c8 = (e % (D / 8)) * 8;
    const int s = r / group, h = hk * group + r % group;
    cp_async16_any(q_sh + r * ST + c8,
                   q + ((size_t)(b * S + s) * Hq + h) * D + c8, true);
  }
  stage_rows_bf16<D, DT>(k_sh, ST, k, (size_t)b * T + t0, BK, nk, Hkv, hk,
                         tid);
  stage_rows_bf16<D, DT>(v_sh, D, v, (size_t)b * T + t0, BK, nk, Hkv, hk,
                         tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  {  // scores: thread owns key c and rows rg, rg + 2, ...
    const int c = tid & (BK - 1), rg = tid / BK;
    const int kp = c < nk ? k_pos[t0 + c] : -1;
    for (int r = rg; r < R; r += DT / BK) {
      float t = 0.0f;
#pragma unroll
      for (int d = 0; d < D; d += 8)
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

  for (int e = tid; e < R * D; e += DT) {
    const int r = e / D, d = e % D;
    float t = 0.0f;
#pragma unroll 8
    for (int c = 0; c < BK; ++c)
      t = fmaf(p_sh[r * PS + c], __bfloat162float(v_sh[c * D + d]), t);
    const int s = r / group, h = hk * group + r % group;
    part_acc[(((size_t)(b * S + s) * Hq + h) * n_split + split) * D + d] = t;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <class K>
static int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
static int launch_prefill(const float* q, const float* k, const float* v,
                          const int* q_pos, const int* k_pos, float* out,
                          float* lse, int B, int S, int T, int Hq, int Hkv,
                          int causal, int window, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (3 * BQ * (D + 4) + 2 * BK * D + BQ * PS);
  int e = allow_smem(flash_prefill_kernel<D>, smem);
  if (e) return e;
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_prefill_kernel<D><<<grid, PT, smem, st>>>(
      q, k, v, q_pos, k_pos, out, lse, S, T, Hq, Hkv, causal, window,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
static int launch_decode(const float* q, const float* k, const float* v,
                         const int* q_pos, const int* k_pos, float* out,
                         float* part_m, float* part_l, float* part_acc, int B,
                         int S, int T, int Hq, int Hkv, int causal, int window,
                         cudaStream_t st) {
  const int R = S * (Hq / Hkv);
  const size_t smem = sizeof(float) * ((R + BK) * (D + 4) + BK * D + R * PS);
  int e = allow_smem(flash_decode_partial_kernel<D>, smem);
  if (e) return e;
  const int n_split = (T + BK - 1) / BK;
  flash_decode_partial_kernel<D><<<dim3(n_split, Hkv, B), DT, smem, st>>>(
      q, k, v, q_pos, k_pos, part_m, part_l, part_acc, S, T, Hq, Hkv, causal,
      window, 1.0f / sqrtf((float)D));
  e = (int)cudaGetLastError();
  if (e) return e;
  const int rows = B * S * Hq;
  flash_decode_combine_kernel<float>
      <<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
          part_m, part_l, part_acc, out, rows, n_split, D);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_prefill_bf16(const bf16* q, const bf16* k, const bf16* v,
                               const int* q_pos, const int* k_pos, bf16* out,
                               int B, int S, int T, int Hq, int Hkv,
                               int causal, int window, cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * BK) * (D + 8);
  int e = allow_smem(flash_prefill_bf16_kernel<D>, smem);
  if (e) return e;
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_prefill_bf16_kernel<D><<<grid, PT, smem, st>>>(
      q, k, v, q_pos, k_pos, out, S, T, Hq, Hkv, causal, window,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
static int launch_decode_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const int* q_pos, const int* k_pos, bf16* out,
                              float* part_m, float* part_l, float* part_acc,
                              int B, int S, int T, int Hq, int Hkv,
                              int causal, int window, cudaStream_t st) {
  const int R = S * (Hq / Hkv);
  const size_t smem = sizeof(bf16) * ((size_t)(R + BK) * (D + 8) + BK * D) +
                      sizeof(float) * (size_t)R * PS;
  int e = allow_smem(flash_decode_partial_bf16_kernel<D>, smem);
  if (e) return e;
  const int n_split = (T + BK - 1) / BK;
  flash_decode_partial_bf16_kernel<D>
      <<<dim3(n_split, Hkv, B), DT, smem, st>>>(
          q, k, v, q_pos, k_pos, part_m, part_l, part_acc, S, T, Hq, Hkv,
          causal, window, 1.0f / sqrtf((float)D));
  e = (int)cudaGetLastError();
  if (e) return e;
  const int rows = B * S * Hq;
  flash_decode_combine_kernel<bf16>
      <<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
          part_m, part_l, part_acc, out, rows, n_split, D);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_backward(const float* q, const float* k, const float* v,
                           const float* out, const float* dout,
                           const float* lse, const int* q_pos,
                           const int* k_pos, float* delta, float* part,
                           float* dq, float* dk, float* dv, int B, int S,
                           int T, int Hq, int Hkv, int causal, int window,
                           cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)D);
  const int rows = B * S * Hq;
  flash_bwd_dot_kernel<<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
      out, dout, delta, rows, S, Hq, D);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t kv_smem = sizeof(float) * (2 * BK * (D + 4) +
                                          2 * BQ * (D + 4) + 2 * BK * PS +
                                          3 * BQ);
  e = allow_smem(flash_bwd_dkdv_kernel<D>, kv_smem);
  if (e) return e;
  // one query head's share per block; a group's shares are added after
  const size_t n_part = (size_t)B * T * Hq * D;
  float* pk = Hq == Hkv ? dk : part;
  float* pv = Hq == Hkv ? dv : part + n_part;
  flash_bwd_dkdv_kernel<D>
      <<<dim3(B * Hq, (T + BK - 1) / BK), PT, kv_smem, st>>>(
          q, k, v, dout, lse, delta, q_pos, k_pos, pk, pv, S, T, Hq, Hkv,
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
      sizeof(float) * (2 * BQ * (D + 4) + 2 * BK * (D + 4) + BQ * PS);
  e = allow_smem(flash_bwd_dq_kernel<D>, q_smem);
  if (e) return e;
  flash_bwd_dq_kernel<D><<<dim3(B * Hq, (S + BQ - 1) / BQ), PT, q_smem, st>>>(
      q, k, v, dout, lse, delta, q_pos, k_pos, dq, S, T, Hq, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

extern "C" {

// Keys per split of the decode path.
int flash_attention_split_keys(void) { return BK; }

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  q/out [B,S,Hq,D], k/v [B,T,Hkv,D] row-major f32
// with 16-byte aligned bases; q_pos [S], k_pos [T] int32; all device
// memory.  lse, when not null, receives each row's log-sum-exp of scaled
// scores, [B,Hq,S] f32 (-inf for a row with no live key); when null the
// kernel writes out only.  window <= 0: no window.  D must be 16, 32, 64
// or 128 and Hq a multiple of Hkv (the wrapper checks; an unsupported D
// returns cudaErrorInvalidValue).
int flash_attention_prefill(const float* q, const float* k, const float* v,
                            const int* q_pos, const int* k_pos, float* out,
                            float* lse, int B, int S, int T, int Hq, int Hkv,
                            int D, int causal, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_prefill<16>(q, k, v, q_pos, k_pos, out, lse, B, S, T, Hq,
                                Hkv, causal, window, st);
    case 32:
      return launch_prefill<32>(q, k, v, q_pos, k_pos, out, lse, B, S, T, Hq,
                                Hkv, causal, window, st);
    case 64:
      return launch_prefill<64>(q, k, v, q_pos, k_pos, out, lse, B, S, T, Hq,
                                Hkv, causal, window, st);
    case 128:
      return launch_prefill<128>(q, k, v, q_pos, k_pos, out, lse, B, S, T,
                                 Hq, Hkv, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_decode<16>(q, k, v, q_pos, k_pos, out, part_m, part_l,
                               part_acc, B, S, T, Hq, Hkv, causal, window, st);
    case 32:
      return launch_decode<32>(q, k, v, q_pos, k_pos, out, part_m, part_l,
                               part_acc, B, S, T, Hq, Hkv, causal, window, st);
    case 64:
      return launch_decode<64>(q, k, v, q_pos, k_pos, out, part_m, part_l,
                               part_acc, B, S, T, Hq, Hkv, causal, window, st);
    case 128:
      return launch_decode<128>(q, k, v, q_pos, k_pos, out, part_m, part_l,
                                part_acc, B, S, T, Hq, Hkv, causal, window,
                                st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_backward<16>(q, k, v, out, dout, lse, q_pos, k_pos, delta,
                                 part, dq, dk, dv, B, S, T, Hq, Hkv, causal,
                                 window, st);
    case 32:
      return launch_backward<32>(q, k, v, out, dout, lse, q_pos, k_pos, delta,
                                 part, dq, dk, dv, B, S, T, Hq, Hkv, causal,
                                 window, st);
    case 64:
      return launch_backward<64>(q, k, v, out, dout, lse, q_pos, k_pos, delta,
                                 part, dq, dk, dv, B, S, T, Hq, Hkv, causal,
                                 window, st);
    case 128:
      return launch_backward<128>(q, k, v, out, dout, lse, q_pos, k_pos,
                                  delta, part, dq, dk, dv, B, S, T, Hq, Hkv,
                                  causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As flash_attention_prefill for q, k, v and out in bf16 (same layout,
// 16-byte aligned bases), without the log-sum-exp output: tensor-core
// products, f32 softmax and accumulation, P and the result rounded to bf16.
int flash_attention_prefill_bf16(const bf16* q, const bf16* k, const bf16* v,
                                 const int* q_pos, const int* k_pos,
                                 bf16* out, int B, int S, int T, int Hq,
                                 int Hkv, int D, int causal, int window,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_prefill_bf16<16>(q, k, v, q_pos, k_pos, out, B, S, T, Hq,
                                     Hkv, causal, window, st);
    case 32:
      return launch_prefill_bf16<32>(q, k, v, q_pos, k_pos, out, B, S, T, Hq,
                                     Hkv, causal, window, st);
    case 64:
      return launch_prefill_bf16<64>(q, k, v, q_pos, k_pos, out, B, S, T, Hq,
                                     Hkv, causal, window, st);
    case 128:
      return launch_prefill_bf16<128>(q, k, v, q_pos, k_pos, out, B, S, T,
                                      Hq, Hkv, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As flash_attention_decode for q, k, v and out in bf16; the partials are
// f32 scratch of the same sizes.
int flash_attention_decode_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const int* q_pos, const int* k_pos, bf16* out,
                                float* part_m, float* part_l,
                                float* part_acc, int B, int S, int T, int Hq,
                                int Hkv, int D, int causal, int window,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_decode_bf16<16>(q, k, v, q_pos, k_pos, out, part_m,
                                    part_l, part_acc, B, S, T, Hq, Hkv,
                                    causal, window, st);
    case 32:
      return launch_decode_bf16<32>(q, k, v, q_pos, k_pos, out, part_m,
                                    part_l, part_acc, B, S, T, Hq, Hkv,
                                    causal, window, st);
    case 64:
      return launch_decode_bf16<64>(q, k, v, q_pos, k_pos, out, part_m,
                                    part_l, part_acc, B, S, T, Hq, Hkv,
                                    causal, window, st);
    case 128:
      return launch_decode_bf16<128>(q, k, v, q_pos, k_pos, out, part_m,
                                     part_l, part_acc, B, S, T, Hq, Hkv,
                                     causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
