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
// Two entry points; the wrapper picks one from the shapes alone.
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

#include <climits>
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
    const int* __restrict__ k_pos, float* __restrict__ out, int S, int T,
    int Hq, int Hkv, int causal, int window, float scale) {
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

// One warp per output row ((b * S + s) * Hq + h): merge the splits in
// index order.
__global__ void __launch_bounds__(DT) flash_decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, float* __restrict__ out, int rows,
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
    if (d < D) out[(size_t)row * D + d] = acc[e] * inv;
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
                          int B, int S, int T, int Hq, int Hkv, int causal,
                          int window, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (3 * BQ * (D + 4) + 2 * BK * D + BQ * PS);
  int e = allow_smem(flash_prefill_kernel<D>, smem);
  if (e) return e;
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_prefill_kernel<D><<<grid, PT, smem, st>>>(
      q, k, v, q_pos, k_pos, out, S, T, Hq, Hkv, causal, window,
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
  flash_decode_combine_kernel<<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
      part_m, part_l, part_acc, out, rows, n_split, D);
  return (int)cudaGetLastError();
}

extern "C" {

// Keys per split of the decode path.
int flash_attention_split_keys(void) { return BK; }

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().  q/out [B,S,Hq,D], k/v [B,T,Hkv,D] row-major f32
// with 16-byte aligned bases; q_pos [S], k_pos [T] int32; all device
// memory.  window <= 0: no window.  D must be 16, 32, 64 or 128 and Hq a
// multiple of Hkv (the wrapper checks; an unsupported D returns
// cudaErrorInvalidValue).
int flash_attention_prefill(const float* q, const float* k, const float* v,
                            const int* q_pos, const int* k_pos, float* out,
                            int B, int S, int T, int Hq, int Hkv, int D,
                            int causal, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_prefill<16>(q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv,
                                causal, window, st);
    case 32:
      return launch_prefill<32>(q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv,
                                causal, window, st);
    case 64:
      return launch_prefill<64>(q, k, v, q_pos, k_pos, out, B, S, T, Hq, Hkv,
                                causal, window, st);
    case 128:
      return launch_prefill<128>(q, k, v, q_pos, k_pos, out, B, S, T, Hq,
                                 Hkv, causal, window, st);
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

}  // extern "C"
