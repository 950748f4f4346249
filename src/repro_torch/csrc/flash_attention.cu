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
// tables on its own (no barrier), over the tiles live_tile_range leaves it
// (all, or with a sorted table only those that can be live): dead
// (skipped, not loaded), wholly live (no compares) or straddling the
// diagonal, the window edge or an empty slot (masked per element).  The
// query tiles with the most key tiles start first.
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
// f32 forward products on CUDA cores, built with FMA contraction; the
// result matches the plain version to about 1e-6.  No single TF32 product
// anywhere: TF32 cannot hold 2e-5.  The backward's products run on tensor
// cores as 3xTF32, three TF32 products that together keep f32's accuracy
// (below, at the backward).
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
// normalised result to bf16.  Its backward (flash_attention_backward_bf16,
// below the decode) is a Hopper kernel of its own: one launch over key
// tiles after the D launch.
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
// (never loaded; with a sorted table, as a prefill's, it starts at the
// first tile that can be live and stops after the last: live_tile_range),
// and hands each tile's first key, its class for either
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
// Decode bf16 (flash_decode_bf16_kernel): bound by bytes, the live K/V
// read once (yi-34b's last serve step: 8.9 MB, 2.7 us at 3.35 TB/s), in
// one launch; at these sizes each block's chain of dependent steps, not
// the bytes, sets the time (PERF.md).  A cluster of n_split blocks per
// (KV head, batch), each block a split of contiguous keys (n_split and the
// split length from the shapes and the card's multiprocessor count:
// ops.decode_splits).  A block marks its live key tiles of 64 in one pass
// over the positions, puts the first 2 or 3 in flight by cp.async (K, V
// and their positions) and refills each stage as its tile is consumed;
// dead tiles are never loaded.  Its four warps take 16 keys of each tile
// apiece: S = Q.K^T and O += P.V on tensor cores (mma.sync m16n8k16,
// ldmatrix; the R <= 16 query rows of the KV group as M, zero rows past
// R, f32 accumulators), the online softmax of the TPU kernel's bf16
// algebra in registers (f32 scores and sums, P rounded to bf16 from the
// accumulators into the A operand).  The block merges its warps' (m, l, O)
// in order into shared memory, for the R live rows; after a cluster
// barrier every block turns the splits' (m, l) into per-row weights and
// writes a share of the output, each element the splits' O in split order
// through distributed shared memory, rounded once to bf16.  No atomics:
// two runs are bit-identical.

#include <climits>
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

// The first key tile in [t0, t_end) that is not dead (T if none); its
// class in cls.
__device__ __forceinline__ int next_tile(const int* k_pos, int t0, int t_end,
                                         int T, int q_lo, int q_hi,
                                         int causal, int window, int lane,
                                         int& cls) {
  for (; t0 < t_end; t0 += BK) {
    cls = classify(k_pos, t0, T, q_lo, q_hi, causal, window, lane);
    if (cls) return t0;
  }
  cls = 0;
  return T;
}

// [begin, end): the key tiles (of `tile` keys, counted from key 0) that a
// block over query positions [q_lo, q_hi] walks.  With `sorted` (the
// wrapper knows k_pos[0..T) is non-decreasing: a prefill's own arange),
// the keys that can be live for some row form one run, from the first at
// or past the window's oldest position (q_lo - window + 1, or 0) to the
// last at or below q_hi (causal): begin is the tile that holds the first,
// end one past the last, both T when the run is empty.  The tiles outside
// hold only dead keys, which the full walk skips unloaded, so the result is
// the full walk's bit for bit; the walk's length drops from T / tile to
// the live tiles (danube's 524,288-key prefill: 4,096 tiles to about 33).
// Both ends come from a 32-way search in every lane of the calling warp,
// one load a lane a round, the two searches in the same rounds
// (ceil(log32 T) rounds).  Without `sorted` (a ring cache's table, or a
// table too short for the search to pay: the wrapper decides), or with
// neither a causal mask nor a window: every tile.  The same range as
// flash_attention.ref.live_tile_range.
__device__ __forceinline__ void live_tile_range(const int* k_pos, int T,
                                                int tile, int q_lo, int q_hi,
                                                int causal, int window,
                                                int sorted, int lane,
                                                int& begin, int& end) {
  begin = 0;
  end = T;
  if (!sorted || (!causal && window <= 0)) return;
  // a[s]: the first index whose position is >= key[s], in [lo[s], hi[s]]
  const int key[2] = {window > 0 ? max(0, q_lo - window + 1) : 0,
                      causal ? q_hi + 1 : INT_MAX};
  int lo[2] = {0, causal ? 0 : T}, hi[2] = {T, T};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int step = (hi[s] - lo[s] + 31) >> 5;  // 0 once found
      const int p = lo[s] + (lane + 1) * step - 1;
      const bool below = step > 0 && p < hi[s] && __ldg(k_pos + p) < key[s];
      const int nlo = lo[s] + __popc(__ballot_sync(FULL, below)) * step;
      if (step > 0) {
        hi[s] = min(hi[s], nlo + step - 1);
        lo[s] = nlo;
      }
    }
  }
  if (lo[0] < lo[1]) {
    begin = lo[0] / tile * tile;
    end = lo[1];
  } else {
    begin = end = T;
  }
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

// One block of BQ query rows of one (batch, query head); the kernels below
// only set the launch bounds.
template <int DP>
__device__ __forceinline__ void prefill_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out,
    float* __restrict__ lse, int S, int T, int Hq, int Hkv, int D,
    int causal, int window, int sorted, float scale) {
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

  int q_lo, q_hi, t_begin, t_end;
  pos_range(q_pos + q0, nq, lane, q_lo, q_hi);
  live_tile_range(k_pos, T, BK, q_lo, q_hi, causal, window, sorted, lane,
                  t_begin, t_end);
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
  int cur = next_tile(k_pos, t_begin, t_end, T, q_lo, q_hi, causal, window,
                      lane, cls);
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
    const int nxt = next_tile(k_pos, cur + BK, t_end, T, q_lo, q_hi, causal,
                              window, lane, nxt_cls);
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

template <int DP>
__global__ void __launch_bounds__(PT) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out,
    float* __restrict__ lse, int S, int T, int Hq, int Hkv, int D,
    int causal, int window, int sorted, float scale) {
  prefill_block<DP>(q, k, v, q_pos, k_pos, out, lse, S, T, Hq, Hkv, D,
                    causal, window, sorted, scale);
}

// Tile widths 64 and 128 at one block a multiprocessor, all the shared
// memory of width 128 allows: without the bound ptxas held width 128 to
// 168 registers and spilled once live_tile_range was inlined, and width
// 64 ran whisper's encoder 2-3 % slower than before the search (on an
// H100; PERF.md section 6).  Widths 16 and 32 keep ptxas's choice.
template <int DP>
__global__ void __launch_bounds__(PT, 1) flash_prefill_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out,
    float* __restrict__ lse, int S, int T, int Hq, int Hkv, int D,
    int causal, int window, int sorted, float scale) {
  prefill_block<DP>(q, k, v, q_pos, k_pos, out, lse, S, T, Hq, Hkv, D,
                    causal, window, sorted, scale);
}

// The prefill kernel of tile width DP.
template <int DP>
static auto prefill_kernel() {
  if constexpr (DP >= 64)
    return flash_prefill_wide_kernel<DP>;
  else
    return flash_prefill_kernel<DP>;
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
// backward: D = rowsum(dO o O), then dK/dV and dQ from P recomputed with the
// forward's log-sum-exp, every product on tensor cores in 3xTF32
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
// over the query tiles of 32 that hold a live pair; with grouped heads, a
// pass that adds each group's shares in head order; one block per (batch,
// query head, query tile of 64) for dQ, looping over the key tiles of 32
// that hold a live pair.  Every sum runs in an order fixed by the shapes:
// no atomics, two runs are bit-identical.
//
// Bound by operations: 10 * D per live pair (S, dP, dV, dS.K, dS^T.Q);
// the dQ pass computes S and dP again, 14 * D in all.  On CUDA cores f32
// runs at 67 TFLOP/s; the five products run instead on the tensor cores as
// 3xTF32 (mma.sync m16n8k8): each f32 operand x is split into a TF32 part
// hi = x with its low 13 mantissa bits cleared and lo = x - hi (exact), of
// which the tensor core takes the TF32 part, and a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with f32 accumulators.  The dropped
// lo.lo term and lo's own cut come to a few parts in 2^20 of each
// product, so the gradients stay within 1e-4 of each one's largest entry
// of the f32 algebra (a single TF32 product, 2^-11, would not).  Each of the four
// warps of a block owns 16 rows of the products' M (keys in the dK/dV
// pass, queries in the dQ pass); the streamed tiles (Q and dO with their
// rows' lse, D and positions, or K and V with their positions) arrive by
// cp.async in a ring of 3 stages, the next two in flight while one
// computes.  A block first marks, in one pass over the positions, which
// streamed tiles hold a live pair, so that no global read waits on the
// way from one tile to the next.  P and dS go from the accumulator layout
// to the A operand's through 16 x 32 floats of the warp's own shared
// memory.  Tiles are f32 rows of DP + 4 floats, so that the fragment
// loads along D fall on distinct banks (those along the streamed rows, two
// to a bank).

// An f32 or bf16 value as f32, and an f32 result stored.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

#define BKT 128  // bf16 backward: keys per block (two warpgroups of 64)
#define BQT 64   // bf16 backward: query rows per streamed tile

// One warp per row ((b * S + i) * Hq + h): delta[(b * Hq + h) * S + i], the
// row's dO . O summed in f32 (out and dout f32, or bf16 for the bf16
// backward).  The bf16 instance also readies the bf16 backward's integer
// scratch ws (null for f32): its first n_zero ints (the ticket and every
// turn counter) set to 0, then the position range of each query tile of
// BQT rows (lo[I], hi[I]) and of the live keys of each key tile of BKT
// (lo[J], hi[J]: INT_MAX, INT_MIN for a tile with none; full[J]: every key
// of the tile inside T and live).
template <class T>
__global__ void __launch_bounds__(DT) flash_bwd_dot_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, int rows, int S, int Hq, int D,
    int* __restrict__ ws, int n_zero, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, int n_keys) {
  if constexpr (!std::is_same<T, float>::value) {
    for (int e = blockIdx.x * DT + threadIdx.x; e < n_zero;
         e += gridDim.x * DT)
      ws[e] = 0;
    const int I = (S + BQT - 1) / BQT, J = (n_keys + BKT - 1) / BKT;
    int* ranges = ws + n_zero;  // q lo, q hi, k lo, k hi, k full
    const int ln = threadIdx.x & 31;
    for (int it = blockIdx.x * (DT / 32) + (threadIdx.x >> 5); it < I + J;
         it += gridDim.x * (DT / 32)) {
      int lo = INT_MAX, hi = INT_MIN;
      bool full = true;
      if (it < I) {
        for (int r = BQT * it + ln; r < min(S, BQT * it + BQT); r += 32) {
          lo = min(lo, q_pos[r]);
          hi = max(hi, q_pos[r]);
        }
      } else {
        for (int t = BKT * (it - I) + ln; t < BKT * (it - I + 1); t += 32) {
          const int kp = t < n_keys ? k_pos[t] : -1;
          if (kp >= 0) {
            lo = min(lo, kp);
            hi = max(hi, kp);
          } else {
            full = false;
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(FULL, lo, off));
        hi = max(hi, __shfl_xor_sync(FULL, hi, off));
      }
      full = __all_sync(FULL, full);
      if (ln == 0) {
        if (it < I) {
          ranges[it] = lo;
          ranges[I + it] = hi;
        } else {
          ranges[2 * I + it - I] = lo;
          ranges[2 * I + J + it - I] = hi;
          ranges[2 * I + 2 * J + it - I] = full;
        }
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (DT / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float t = 0.0f;
  for (int d = lane; d < D; d += 32) t = fmaf(to_f32(o[d]), to_f32(g[d]), t);
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(FULL, t, off);
  if (lane == 0) {
    const int h = row % Hq, bi = row / Hq;  // bi = b * S + i
    const int b = bi / S, i = bi % S;
    delta[((size_t)b * Hq + h) * S + i] = t;
  }
}

#define BC 32        // backward: streamed tile rows (queries or keys)
#define BSTAGES 3    // backward: ring depth
#define SC (BC + 4)  // row stride of a warp's P / dS scratch

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

// An A operand (16 x 8) and a B operand (8 x 8) of m16n8k8, split.
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

// c += a.b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// A = X[0..16)[k0..k0+8) of a row-major X with row stride ld: lane
// (g, t) = (lane / 4, lane % 4) holds rows g, g + 8 and columns t, t + 4.
__device__ __forceinline__ FragA frag_a(const float* x, int ld, int k0,
                                        int g, int t) {
  const float e[4] = {x[g * ld + k0 + t], x[(g + 8) * ld + k0 + t],
                      x[g * ld + k0 + t + 4], x[(g + 8) * ld + k0 + t + 4]};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(e[i], f.hi[i], f.lo[i]);
  return f;
}

// B(kk, n) = X[n][k0 + kk] (B is X^T: X row-major over n), n in 0..8.
__device__ __forceinline__ FragB frag_b_t(const float* x, int ld, int k0,
                                          int g, int t) {
  FragB f;
  split_tf32(x[g * ld + k0 + t], f.hi[0], f.lo[0]);
  split_tf32(x[g * ld + k0 + t + 4], f.hi[1], f.lo[1]);
  return f;
}

// B(kk, n) = X[k0 + kk][n0 + n] (X row-major over k).
__device__ __forceinline__ FragB frag_b(const float* x, int ld, int k0,
                                        int n0, int g, int t) {
  FragB f;
  split_tf32(x[(k0 + t) * ld + n0 + g], f.hi[0], f.lo[0]);
  split_tf32(x[(k0 + t + 4) * ld + n0 + g], f.hi[1], f.lo[1]);
  return f;
}

// Whether any of the keys t0..t0+31 (< T) is live for a query position in
// [q_lo, q_hi]; the same in every lane of the calling warp.
__device__ __forceinline__ bool keys32_live(const int* k_pos, int t0, int T,
                                            int q_lo, int q_hi, int causal,
                                            int window, int lane) {
  const int a = t0 + lane < T ? k_pos[t0 + lane] : -1;
  return __ballot_sync(FULL, maybe_live(a, q_lo, q_hi, causal, window)) != 0;
}

template <int DP>
struct BwdTile {
  static constexpr int KS = DP + 4;  // f32 row stride of every tile
  static constexpr int STAGE = 2 * BC * KS;
  // dK/dV: K, V [BK][KS]; the ring of Q, dO [BC][KS] and the tile's lse,
  // delta, q_pos [BC]; P^T, dS^T a warp; then a byte a query tile
  static constexpr size_t KV_SMEM =
      sizeof(float) * (2 * BK * KS + BSTAGES * (STAGE + 3 * BC) +
                       4 * 2 * 16 * SC);
  // dQ: Q, dO [BQ][KS]; the ring of K, V [BC][KS] and the tile's k_pos
  // [BC]; dS a warp; then a byte a key tile
  static constexpr size_t Q_SMEM =
      sizeof(float) * (2 * BQ * KS + BSTAGES * (STAGE + BC) + 4 * 16 * SC);
};

// 4 bytes from device to shared memory, zeros where !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// dK and dV of key tile blockIdx.y from query head blockIdx.x % Hq of
// batch blockIdx.x / Hq, over the query tiles in index order.  With one
// query head per KV head the block writes dk/dv [B,T,Hkv,D]; with more, it
// writes its head's share to dk/dv laid out [B,T,Hq,D], and
// flash_bwd_group_sum_kernel adds the shares of a group in head order.
// Warp w owns keys 16w..16w+15 of the tile: S^T and dP^T of its keys
// against the tile's 32 queries, then dV += P^T.dO and dK += dS^T.Q.
template <int DP>
__global__ void __launch_bounds__(PT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dk, float* __restrict__ dv, int S, int T, int Hq,
    int Hkv, int D, int causal, int window, float scale) {
  using L = BwdTile<DP>;
  constexpr int KS = L::KS;
  extern __shared__ __align__(16) float smem[];
  float* k_sh = smem;                          // [BK][KS]
  float* v_sh = k_sh + BK * KS;                // [BK][KS]
  float* ring = v_sh + BK * KS;                // stages of Q, dO [BC][KS]
  float* rows = ring + BSTAGES * L::STAGE;     // stages of lse, delta, q_pos
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  float* p_w = rows + BSTAGES * 3 * BC + warp * 2 * 16 * SC;    // P^T
  float* ds_w = p_w + 16 * SC;                                   // dS^T
  unsigned char* live_tile =
      reinterpret_cast<unsigned char*>(rows + BSTAGES * 3 * BC +
                                       4 * 2 * 16 * SC);
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int t0 = blockIdx.y * BK, nk = min(BK, T - t0);
  const int c0 = 16 * warp + g;  // this lane's keys c0 and c0 + 8
  const int kp[2] = {c0 < nk ? k_pos[t0 + c0] : -1,
                     c0 + 8 < nk ? k_pos[t0 + c0 + 8] : -1};

  // which query tiles hold a live pair with the block's keys: one pass
  // over q_pos, each warp a tile at a time against the keys lane and
  // lane + 32 that every lane holds
  {
    const int ka = lane < nk ? k_pos[t0 + lane] : -1;
    const int kb = lane + 32 < nk ? k_pos[t0 + lane + 32] : -1;
#pragma unroll 4
    for (int j = warp; j * BC < S; j += PT / 32) {
      const int i = j * BC + lane;
      int lo = i < S ? q_pos[i] : INT_MAX, hi = i < S ? q_pos[i] : INT_MIN;
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(FULL, lo, off));
        hi = max(hi, __shfl_xor_sync(FULL, hi, off));
      }
      const unsigned any =
          __ballot_sync(FULL, maybe_live(ka, lo, hi, causal, window) ||
                                  maybe_live(kb, lo, hi, causal, window));
      if (lane == 0) live_tile[j] = any != 0;
    }
  }
  __syncthreads();

  // the next query tile at or after i0 with a live pair (S if none)
  auto next_live = [&](int i0) {
    for (; i0 < S; i0 += BC)
      if (live_tile[i0 / BC]) return i0;
    return S;
  };
  auto load = [&](int i0, int stage) {
    float* qd = ring + stage * L::STAGE;
    stage_rows<DP, PT>(qd, KS, q, (size_t)b * S + i0, BC, S - i0, Hq, h, D,
                       tid);
    stage_rows<DP, PT>(qd + BC * KS, KS, dout, (size_t)b * S + i0, BC,
                       S - i0, Hq, h, D, tid);
    if (tid < BC) {  // the tile's lse, delta and positions (0 past S)
      float* rd = rows + stage * 3 * BC;
      const bool ok = i0 + tid < S;
      const size_t at = ((size_t)b * Hq + h) * S + (ok ? i0 + tid : 0);
      cp_async4(rd + tid, lse + at, ok);
      cp_async4(rd + BC + tid, delta + at, ok);
      cp_async4(rd + 2 * BC + tid, q_pos + (ok ? i0 + tid : 0), ok);
    }
  };

  stage_rows<DP, PT>(k_sh, KS, k, (size_t)b * T + t0, BK, nk, Hkv, hk, D,
                     tid);
  stage_rows<DP, PT>(v_sh, KS, v, (size_t)b * T + t0, BK, nk, Hkv, hk, D,
                     tid);
  int ld = next_live(0), cur = ld;
#pragma unroll
  for (int st = 0; st < BSTAGES - 1; ++st) {  // K and V go with the first
    if (ld < S) {
      load(ld, st);
      ld = next_live(ld + BC);
    }
    cp_async_commit();
  }

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  const float* kw = k_sh + 16 * warp * KS;
  const float* vw = v_sh + 16 * warp * KS;
  for (int it = 0; cur < S; ++it) {
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();  // tile `it` landed; the stage of tile it-1 is free
    if (ld < S) {
      load(ld, (it + BSTAGES - 1) % BSTAGES);
      ld = next_live(ld + BC);
    }
    cp_async_commit();
    const float* qs = ring + (it % BSTAGES) * L::STAGE;
    const float* gs = qs + BC * KS;
    const float* rs = rows + (it % BSTAGES) * 3 * BC;  // lse, delta, q_pos

    // S^T and dP^T: this warp's 16 keys against the tile's 32 queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      const FragA ak = frag_a(kw, KS, kk, g, t4);
      const FragA av = frag_a(vw, KS, kk, g, t4);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma3(s[n], ak, frag_b_t(qs + 8 * n * KS, KS, kk, g, t4));
        mma3(dp[n], av, frag_b_t(gs + 8 * n * KS, KS, kk, g, t4));
      }
    }
    // P^T and dS^T into the warp's scratch: element e of block n is key
    // c0 + 8 (e >> 1), query cur + 8n + 2 t4 + (e & 1)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int col = 8 * n + 2 * t4 + e1;
        const bool ok = cur + col < S;
        const int qp = __float_as_int(rs[2 * BC + col]);
        const float m = rs[col], dl = rs[BC + col];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half + e1;
          const bool live = ok && live_key(kp[half], qp, causal, window);
          const float p = live ? expf(fmaf(s[n][e], scale, -m)) : 0.0f;
          p_w[(g + 8 * half) * SC + col] = p;
          ds_w[(g + 8 * half) * SC + col] = p * (dp[n][e] - dl);
        }
      }
    __syncwarp();
    // dV += P^T.dO, dK += dS^T.Q over the tile's queries, in order
#pragma unroll
    for (int kq = 0; kq < BC; kq += 8) {
      const FragA ap = frag_a(p_w, SC, kq, g, t4);
      const FragA ad = frag_a(ds_w, SC, kq, g, t4);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        mma3(dv_acc[n], ap, frag_b(gs, KS, kq, 8 * n, g, t4));
        mma3(dk_acc[n], ad, frag_b(qs, KS, kq, 8 * n, g, t4));
      }
    }
    __syncwarp();  // the scratch is read before the next tile writes it
    cur = next_live(cur + BC);
  }
  cp_async_wait<0>();  // K/V of a block that found no live tile

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = c0 + 8 * half;
    if (c >= nk) continue;
    const size_t row = Hq == Hkv ? ((size_t)(b * T + t0 + c) * Hkv + hk) * D
                                 : ((size_t)(b * T + t0 + c) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < D) {
        *reinterpret_cast<float2*>(dk + row + col) =
            make_float2(dk_acc[n][2 * half] * scale,
                        dk_acc[n][2 * half + 1] * scale);
        *reinterpret_cast<float2*>(dv + row + col) =
            make_float2(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
      }
    }
  }
}

// dk/dv [B,T,Hkv,D] from the query heads' f32 shares [B,T,Hq,D]: the G
// shares of each KV head added in head order, one thread per output,
// stored in T (the f32 backward's; the bf16 backward adds its group's
// shares in its own kernel).
template <class T>
__global__ void __launch_bounds__(DT) flash_bwd_group_sum_kernel(
    const float* __restrict__ part_k, const float* __restrict__ part_v,
    T* __restrict__ dk, T* __restrict__ dv, size_t n, int Hq, int Hkv,
    int D) {
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
  store(dk + e, sk);
  store(dv + e, sv);
}

// dQ of query tile blockIdx.y for query head blockIdx.x % Hq of batch
// blockIdx.x / Hq.  Warp w owns rows 16w..16w+15 of the tile: S and dP of
// its rows against each key tile of 32, then dQ += dS.K.
template <int DP>
__global__ void __launch_bounds__(PT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dq, int S, int T, int Hq, int Hkv, int D, int causal,
    int window, float scale) {
  using L = BwdTile<DP>;
  constexpr int KS = L::KS;
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                 // [BQ][KS]
  float* do_sh = q_sh + BQ * KS;      // [BQ][KS]
  float* ring = do_sh + BQ * KS;      // stages of K, V [BC][KS]
  int* kp_sh = reinterpret_cast<int*>(ring + BSTAGES * L::STAGE);  // k_pos
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  float* ds_w = reinterpret_cast<float*>(kp_sh + BSTAGES * BC) +
                warp * 16 * SC;
  unsigned char* live_tile = reinterpret_cast<unsigned char*>(
      reinterpret_cast<float*>(kp_sh + BSTAGES * BC) + 4 * 16 * SC);
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, S - q0);

  int q_lo, q_hi;
  pos_range(q_pos + q0, nq, lane, q_lo, q_hi);
  // this lane's rows r0 and r0 + 8 of the tile
  const int r0 = 16 * warp + g;
  bool ok[2];
  int qp[2];
  float m[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    ok[half] = r < nq;
    const size_t at = ((size_t)b * Hq + h) * S + q0 + (ok[half] ? r : 0);
    qp[half] = ok[half] ? q_pos[q0 + r] : 0;
    m[half] = ok[half] ? lse[at] : 0.0f;
    dl[half] = ok[half] ? delta[at] : 0.0f;
  }

  // which key tiles hold a live pair with the block's rows: one pass over
  // k_pos, each warp a tile at a time
#pragma unroll 4
  for (int j = warp; j * BC < T; j += PT / 32) {
    const bool live =
        keys32_live(k_pos, j * BC, T, q_lo, q_hi, causal, window, lane);
    if (lane == 0) live_tile[j] = live;
  }
  __syncthreads();

  // the next key tile at or after j0 with a live pair (T if none)
  auto next_live = [&](int j0) {
    for (; j0 < T; j0 += BC)
      if (live_tile[j0 / BC]) return j0;
    return T;
  };
  auto load = [&](int j0, int stage) {
    float* kd = ring + stage * L::STAGE;
    stage_rows<DP, PT>(kd, KS, k, (size_t)b * T + j0, BC, T - j0, Hkv, hk, D,
                       tid);
    stage_rows<DP, PT>(kd + BC * KS, KS, v, (size_t)b * T + j0, BC, T - j0,
                       Hkv, hk, D, tid);
    if (tid < BC)  // the tile's positions (0 past T)
      cp_async4(kp_sh + stage * BC + tid,
                k_pos + (j0 + tid < T ? j0 + tid : 0), j0 + tid < T);
  };

  stage_rows<DP, PT>(q_sh, KS, q, (size_t)b * S + q0, BQ, nq, Hq, h, D,
                     tid);
  stage_rows<DP, PT>(do_sh, KS, dout, (size_t)b * S + q0, BQ, nq, Hq, h, D,
                     tid);
  int ld = next_live(0), cur = ld;
#pragma unroll
  for (int st = 0; st < BSTAGES - 1; ++st) {  // Q and dO go with the first
    if (ld < T) {
      load(ld, st);
      ld = next_live(ld + BC);
    }
    cp_async_commit();
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const float* qw = q_sh + 16 * warp * KS;
  const float* gw = do_sh + 16 * warp * KS;
  for (int it = 0; cur < T; ++it) {
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();  // tile `it` landed; the stage of tile it-1 is free
    if (ld < T) {
      load(ld, (it + BSTAGES - 1) % BSTAGES);
      ld = next_live(ld + BC);
    }
    cp_async_commit();
    const float* ks = ring + (it % BSTAGES) * L::STAGE;
    const float* vs = ks + BC * KS;
    const int* kps = kp_sh + (it % BSTAGES) * BC;

    // S and dP: this warp's 16 rows against the tile's 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      const FragA aq = frag_a(qw, KS, kk, g, t4);
      const FragA ag = frag_a(gw, KS, kk, g, t4);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma3(s[n], aq, frag_b_t(ks + 8 * n * KS, KS, kk, g, t4));
        mma3(dp[n], ag, frag_b_t(vs + 8 * n * KS, KS, kk, g, t4));
      }
    }
    // dS into the warp's scratch: element e of block n is row
    // r0 + 8 (e >> 1), key cur + 8n + 2 t4 + (e & 1)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int col = 8 * n + 2 * t4 + e1;
        const int kp = cur + col < T ? kps[col] : -1;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half + e1;
          const bool live = ok[half] && live_key(kp, qp[half], causal, window);
          const float p = live ? expf(fmaf(s[n][e], scale, -m[half])) : 0.0f;
          ds_w[(g + 8 * half) * SC + col] = p * (dp[n][e] - dl[half]);
        }
      }
    __syncwarp();
    // dQ += dS.K over the tile's keys, in order
#pragma unroll
    for (int kc = 0; kc < BC; kc += 8) {
      const FragA ad = frag_a(ds_w, SC, kc, g, t4);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        mma3(acc[n], ad, frag_b(ks, KS, kc, 8 * n, g, t4));
    }
    __syncwarp();  // the scratch is read before the next tile writes it
    cur = next_live(cur + BC);
  }
  cp_async_wait<0>();  // Q and dO of a tile with no live key

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!ok[half]) continue;
    float* o = dq + ((size_t)(b * S + q0 + r0 + 8 * half) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < D)
        *reinterpret_cast<float2*>(o + col) =
            make_float2(acc[n][2 * half] * scale,
                        acc[n][2 * half + 1] * scale);
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
        bf16* __restrict__ out, float* __restrict__ lse, int S, int T,
        int Hq, int Hkv, int D, int causal, int window, int sorted,
        float scale) {
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
    // producer: warp 8 walks the key tiles live for some row of the block
    // (from live_tile_range's first to its last), classifies each for
    // either warpgroup's rows, and its lane 0 issues every copy; an end
    // marker (first key T) closes the list
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
      int t_begin, t_end;
      live_tile_range(k_pos, T, WK, q_lo, q_hi, causal, window, sorted, lane,
                      t_begin, t_end);
      // lane holds the positions of keys t0 + lane + 32u, the next tile's
      // loading while this one is classified
      int kv[4], nx[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t_begin + lane + 32 * u;
        kv[u] = t < T ? __ldg(k_pos + t) : -1;
      }
      int stage = 0;
      unsigned phase = 0;
      for (int t0 = t_begin;; t0 += WK) {
        const bool end = t0 >= t_end;
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
        // the row's log-sum-exp of scaled scores (m is in raw scores), for
        // the backward
        if (lse != nullptr && fc == 0)
          lse[((size_t)b * Hq + h) * S + r] =
              lt > 0.0f ? m[i] * scale + logf(lt) : -INFINITY;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 decode: one cluster launch, the products on tensor cores
// ---------------------------------------------------------------------------

#define DROWS 16       // M of the products: a group's R <= 16 query rows
#define DMAX_SPLIT 8   // blocks of a cluster (the portable largest)

template <int DP>
struct DecodeTile {
  static constexpr int ST = DP + 8;  // bf16 row stride (ldmatrix: no conflict)
  static constexpr int STAGES = DP == 128 ? 2 : 3;
  static constexpr int RING = STAGES * 2 * BK * ST;     // bf16 elements
  static constexpr int OS = DP + 8;  // f32 row stride of a partial's o
  static constexpr int PART = 2 * DROWS + DROWS * OS;   // floats: m, l, o
  // Q, the ring, the block's partial, the rows' weights (of the warps,
  // then of the splits), each stage's key positions; then a byte a tile
  // of the split (its liveness)
  static constexpr size_t SMEM =
      sizeof(bf16) * (DROWS * ST + RING) +
      sizeof(float) * (PART + DROWS * DMAX_SPLIT) + sizeof(int) * STAGES * BK;
  static_assert(4 * PART * sizeof(float) <= RING * sizeof(bf16),
                "the warps' partials fit in the ring");
};


__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a.b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The R = S * (Hq/Hkv) query rows of KV head blockIdx.y of batch
// blockIdx.z (row r reads query head hk * group + r % group at position
// r / group) over the keys [split * split_keys, + split_keys) of split
// blockIdx.x, one block of a cluster of gridDim.x.  The block first marks
// which of its key tiles hold a live key (one pass over its positions),
// puts the first live tiles in flight, and refills each stage as soon as
// its tile is consumed; a tile's positions arrive with its K and V.  Warp
// w takes keys 16w..16w+15 of every live tile of 64 with its own running
// (m, l, O); the block merges its warps in order, and after a cluster
// barrier each block writes a share of the output, merging the splits'
// partials in split order through distributed shared memory.
template <int DP>
__global__ void __launch_bounds__(DT) flash_decode_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, bf16* __restrict__ out, int S, int T,
    int Hq, int Hkv, int D, int causal, int window, int split_keys,
    float scale) {
  using L = DecodeTile<DP>;
  constexpr int ST = L::ST, NS = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem_bytes);         // [DROWS][ST]
  bf16* ring = q_sh + DROWS * ST;                            // K, V [BK][ST]
  float* part = reinterpret_cast<float*>(ring + L::RING);    // the block's
  float* wts = part + L::PART;                    // [DROWS][DMAX_SPLIT]
  int* kp_sh = reinterpret_cast<int*>(wts + DROWS * DMAX_SPLIT);  // [NS][BK]
  unsigned char* live_tile =
      reinterpret_cast<unsigned char*>(kp_sh + NS * BK);     // a tile each
  float* wpart = reinterpret_cast<float*>(ring);  // the warps', after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, group = Hq / Hkv, R = S * group;
  const int k_lo = split * split_keys, k_hi = min(T, k_lo + split_keys);

  for (int e = tid; e < DROWS * (DP / 8); e += DT) {  // rows R.. are zero
    const int r = e / (DP / 8), c8 = (e % (DP / 8)) * 8;
    const bool ok = r < R && c8 < D;
    const int s = ok ? r / group : 0, h = hk * group + (ok ? r % group : 0);
    cp_async16_any(q_sh + r * ST + c8,
                   q + ((size_t)(b * S + s) * Hq + h) * D + (ok ? c8 : 0), ok);
  }
  int q_lo, q_hi;
  pos_range(q_pos, S, lane, q_lo, q_hi);
  // this lane's rows g and g + 8
  const bool row_ok[2] = {g < R, g + 8 < R};
  const int qp[2] = {row_ok[0] ? q_pos[g / group] : 0,
                     row_ok[1] ? q_pos[(g + 8) / group] : 0};
#pragma unroll 4
  for (int j = warp; k_lo + j * BK < k_hi; j += DT / 32) {
    const int cls =
        classify(k_pos, k_lo + j * BK, k_hi, q_lo, q_hi, causal, window, lane);
    if (lane == 0) live_tile[j] = cls != 0;
  }
  __syncthreads();

  // the next tile at or after t with a live key (k_hi if none)
  auto next_live = [&](int t) {
    for (; t < k_hi; t += BK)
      if (live_tile[(t - k_lo) / BK]) return t;
    return k_hi;
  };
  auto load = [&](int t, int stage) {
    bf16* kd = ring + stage * 2 * BK * ST;
    stage_rows_bf16<DP, DT>(kd, ST, k, (size_t)b * T + t, BK, k_hi - t, Hkv,
                            hk, D, tid);
    stage_rows_bf16<DP, DT>(kd + BK * ST, ST, v, (size_t)b * T + t, BK,
                            k_hi - t, Hkv, hk, D, tid);
    if (tid < BK)
      cp_async4(kp_sh + stage * BK + tid, k_pos + (t + tid < T ? t + tid : 0),
                t + tid < T);
  };
  int ld = next_live(k_lo), cur = ld;
#pragma unroll
  for (int st = 0; st < NS; ++st) {  // Q goes with the first
    if (ld < k_hi) {
      load(ld, st);
      ld = next_live(ld + BK);
    }
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  unsigned qa[DP / 16][4];

  for (int it = 0; cur < k_hi; ++it) {
    cp_async_wait<NS - 1>();
    __syncthreads();  // tile `it` (and Q) landed for every thread
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldsm_x4(qa[kk], q_sh + (lane & 15) * ST + kk * 16 + (lane >> 4) * 8);
    }
    const int stage = it % NS;
    const bf16* ks = ring + stage * 2 * BK * ST + 16 * warp * ST;
    const bf16* vs = ks + BK * ST;
    const int* kps = kp_sh + stage * BK + 16 * warp;

    // S = Q.K^T over the warp's 16 keys: block j holds keys 8j..8j+7,
    // summed over D in two chains (even and odd k-steps)
    float sc[2][4], s2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = s2[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      unsigned kb[4];
      ldsm_x4(kb, ks + ((lane & 7) + ((lane >> 4) << 3)) * ST + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      if (kk & 1) {
        mma_bf16(s2[0], qa[kk], kb[0], kb[1]);
        mma_bf16(s2[1], qa[kk], kb[2], kb[3]);
      } else {
        mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] += s2[j][e];
    // element e of block j: row g + 8 (e >> 1), key 8j + 2 t4 + (e & 1)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = 8 * j + 2 * t4 + e1;
        const int kp = cur + 16 * warp + c < k_hi ? kps[c] : -1;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = sc[j][2 * i + e1];
          x = row_ok[i] && live_key(kp, qp[i], causal, window) ? x * scale
                                                               : -INFINITY;
        }
      }
    // online softmax of rows g (i = 0) and g + 8: a row is a quad's 4 lanes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(fmaxf(sc[0][2 * i], sc[0][2 * i + 1]),
                       fmaxf(sc[1][2 * i], sc[1][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.0f, sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          float& x = sc[j][2 * i + e1];
          x = m_new != -INFINITY ? expf(x - m_new) : 0.0f;
          sum += x;
        }
      if (m_new != -INFINITY) alpha = expf(m[i] - m_new);
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    // O += P.V with P rounded to bf16: the accumulators are the A operand
    const unsigned pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      unsigned vb[4];
      ldsm_x4_trans(vb, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ST +
                            n * 8 + (lane >> 4) * 8);
      mma_bf16(o[n], pa, vb[0], vb[1]);
      mma_bf16(o[n + 1], pa, vb[2], vb[3]);
    }
    __syncthreads();  // every warp is done with this stage
    if (ld < k_hi) {
      load(ld, stage);
      ld = next_live(ld + BK);
    }
    cp_async_commit();
    cur = next_live(cur + BK);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the warps' partials

  // the warps' partials, rows R.. left out: m [DROWS], l, o [DROWS][OS]
  float* wp = wpart + warp * L::PART;
  constexpr int OS = L::OS;
  if (t4 == 0) {
    wp[g] = m[0];
    wp[g + 8] = m[1];
    wp[DROWS + g] = l[0];
    wp[DROWS + g + 8] = l[1];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row_ok[i]) {
      float* row = wp + 2 * DROWS + (g + 8 * i) * OS + 2 * t4;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
  __syncthreads();
  // the block's partial: per row the warps' weights once, then o
  constexpr int NW = DT / 32;
  if (tid < R) {
    float mb = -INFINITY, lb = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) mb = fmaxf(mb, wpart[w * L::PART + tid]);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = wpart[w * L::PART + tid];
      const float wt = mw == -INFINITY ? 0.0f : expf(mw - mb);
      lb = fmaf(wt, wpart[w * L::PART + DROWS + tid], lb);
      wts[tid * DMAX_SPLIT + w] = wt;
    }
    part[tid] = mb;
    part[DROWS + tid] = lb;
  }
  __syncthreads();
  for (int e = tid; e < R * DP; e += DT) {
    const int r = e / DP, c = e % DP;
    float ob = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      ob = fmaf(wts[r * DMAX_SPLIT + w],
                wpart[w * L::PART + 2 * DROWS + r * OS + c], ob);
    part[2 * DROWS + r * OS + c] = ob;
  }
  cluster.sync();  // every block's partial is written

  // per row the splits' weights over the row's sum (0 for a row with no
  // live key), in every block
  if (tid < R) {
    float mj[DMAX_SPLIT], mx = -INFINITY, lt = 0.0f;
#pragma unroll
    for (int j = 0; j < DMAX_SPLIT; ++j)
      if (j < n_split) {
        mj[j] = cluster.map_shared_rank(part, j)[tid];
        mx = fmaxf(mx, mj[j]);
      }
#pragma unroll
    for (int j = 0; j < DMAX_SPLIT; ++j)
      if (j < n_split) {
        mj[j] = mj[j] == -INFINITY ? 0.0f : expf(mj[j] - mx);
        lt = fmaf(mj[j], cluster.map_shared_rank(part, j)[DROWS + tid], lt);
      }
    const float inv = lt > 0.0f ? 1.0f / lt : 0.0f;
#pragma unroll
    for (int j = 0; j < DMAX_SPLIT; ++j)
      if (j < n_split) wts[tid * DMAX_SPLIT + j] = mj[j] * inv;
  }
  __syncthreads();
  // element (r, d) of the output, by thread split * DT + tid of the
  // cluster: the splits' o in split order, rounded to bf16 once
  for (int e = split * DT + tid; e < R * D; e += n_split * DT) {
    const int r = e / D, d = e % D;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < DMAX_SPLIT; ++j)
      if (j < n_split)
        acc = fmaf(wts[r * DMAX_SPLIT + j],
                   cluster.map_shared_rank(part, j)[2 * DROWS + r * OS + d],
                   acc);
    const int s = r / group, h = hk * group + r % group;
    out[((size_t)(b * S + s) * Hq + h) * D + d] = __float2bfloat16(acc);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// bf16 backward on Hopper: one launch over key tiles, wgmma from a TMA ring
// ---------------------------------------------------------------------------
//
// The backward of the bf16 prefill, for bf16 training: q, k, v, the
// forward's out and dout in bf16, its lse and D in f32; dq, dk, dv in bf16.
// No TPU twin (the reference differentiates XLA attention,
// src/repro/models/layers.py:225, by jax.grad).  Two launches: D =
// rowsum(dO o O) in f32, one warp a row (flash_bwd_dot_kernel<bf16>, which
// also zeroes the scratch's ticket and turn counters and writes each
// tile's position range), then flash_bwd_bf16_hopper_kernel.
//
// What bounds it: 10 * D operations per live pair on bf16 tensor cores
// (989 TFLOP/s) or the bytes of q, k, v, out, dout and the gradients read
// or written once, whichever is larger: bytes at smollm-135m's and
// h2o-danube-3-4b's training shapes, operations at whisper-large-v3's
// 1,500 frames.  The kernel's answer to both: each product once (S^T, dP^T,
// dV, dK and dQ: five per live pair, none recomputed), K and V read once
// per (key tile, query head), Q and dO streamed by TMA, every product on
// wgmma.  What holds it (PERF.md): shared-memory traffic and the writers'
// turns, about a third of the time at whisper-large-v3's encoder shape.
//
// A block owns one key tile of BKT = 128 keys of one query head of one
// batch, three warpgroups: warpgroups 0 and 1 take 64 keys each and
// compute, taking turns to issue their products (named barriers, as the
// prefill's), so that one's elementwise work runs while the other's
// products do; warp 8 is the producer; warps 9-11 add dQ (setmaxnreg
// moves registers from warpgroup 2 to the consumers: 56 and 224 at tile
// widths up to 64, 40 and 232 at 128, of the block's 384 x 168 at
// launch).  The producer
// loads K and V once by TMA (kept in shared memory), then walks the query
// tiles of BQT = 64 rows that meet the key tile (from the tiles' position
// ranges; the others are never loaded) and streams each one's Q and dO by
// TMA, with its rows' lse, D and positions, into a ring of 2 or 3 stages
// with full and empty mbarriers.  A consumer warpgroup runs
//   S^T = K.Q^T and dP^T = V.dO^T   wgmma m64n64k16: at tile widths up
//                                    to 64 with the warpgroup's K and V
//                                    held in registers for the whole walk
//                                    (the A operand, by ldmatrix once),
//                                    at 128 both from shared memory; Q and
//                                    dO K-major
//   P^T = exp(S^T scale - lse), dS^T = P^T o (dP^T - D)
//                                    in f32 on the accumulator registers,
//                                    without branches (a masked pair's
//                                    exponent is -inf; no masks at all
//                                    where the tiles' ranges leave every
//                                    pair live; exp2 by ex2.approx)
//   dV += P^T.dO, dK += dS^T.Q       P^T, dS^T rounded to bf16 into the
//                                    register A operand; dO, Q MN-major
//   dQ_w = dS_w.K_w                  dS^T staged in shared memory (bf16,
//                                    128-byte swizzle), read as a
//                                    transposed A, K MN-major
// Warpgroup 0 writes its dQ share of the query tile to shared memory in
// f32 and warpgroup 1 adds its own (keys 0-63, then 64-127); a writer
// warp copies the sums so far in (cp.async) once it is the block's turn,
// adds the share and stores the sums to dq_acc (f32), or, for the last
// key tile, rounds dq once, dq = bf16(scale * sum), then hands the turn
// on.  Three staging buffers and three writer warps taking the query
// tiles in turns, so that the consumers go on to the next query tiles
// while a writer waits for its turn or its fence (at tile width 128,
// whose steps are long enough, one buffer, and the three warps split each
// tile).  dK and dV stay in registers over the whole walk; with one
// query head a KV head they are rounded and written, with more the group's
// heads add their f32 shares (dK scaled) into dk_acc / dv_acc in head
// order and the last head rounds dk and dv once.
//
// Turns.  Each (batch, query head, query tile) has a counter in ws: the
// block whose key tile is the j-th of those that meet the query tile
// (in key-tile order) waits until it reads j (ld.acquire.gpu), stores its
// share (j = 0) or adds it, and then sets it to j + 1 (fence.acq_rel.gpu,
// then a store); the last one writes dq instead.  Each (batch, KV head,
// key tile) has one for the group's heads the same way.  The only atomic
// is on an int: each block takes a ticket (atomicAdd) when it starts and
// maps it to its work item, in the order (key tile, batch, KV head, head
// of the group), so key tile j - 1 of a head comes before key tile j (a
// wave or so before it: its shares are mostly in when they are wanted)
// and head r - 1 of a group before head r.  Why this cannot deadlock: every
// wait is on a block with a smaller ticket, and a block that holds a
// ticket is running or done (it took the ticket when it started), so by
// induction on the ticket every block that waits is waited for by none
// that has not started, and every wait ends.  Every float sum has a fixed
// order (the j-th share after the (j-1)-th, head r after head r - 1), so
// two runs are bit-identical.  A query tile that meets no key tile gets dq
// = 0 from the writers of its head's key tile 0; rows and keys with no
// live pair get 0 through their zero shares.  The D launch zeroes the
// ticket and the counters (dq_acc, dk_acc, dv_acc need no zeroing: the
// first share is stored).

#define BTHREADS 384  // consumer warpgroups 0, 1; warpgroup 2 produces, adds

// Shared memory of the bf16 backward at tile width DP: K and V [BKT][DP];
// STAGES of Q and dO [BQT][DP]; dS^T of either warpgroup [64][BQT]; two f32
// dQ shares [BQT][DP + 8]; each stage's lse, D and positions [BQT]; each
// stage's query tile and class; the work item; the barriers.  K, V, Q and
// dO are DP / CW column slabs of CW = min(DP, 64) values as TMA writes them
// (rows of SPAN = 2 CW bytes, swizzled on SPAN bytes, 1,024-byte aligned);
// dS^T is rows of 64 bf16, swizzled on 128 bytes.
template <int DP>
struct BTile {
  static constexpr int STAGES = DP < 128 ? 3 : 2;  // query tiles in flight
  static constexpr int CW = DP < 64 ? DP : 64;
  static constexpr int SPAN = 2 * CW;
  static constexpr int NS = DP / CW;
  static constexpr unsigned SWZ = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
  static constexpr int KV_BYTES = BKT * DP * 2;
  static constexpr int QD_BYTES = BQT * DP * 2;
  static constexpr int DS_BYTES = 64 * BQT * 2;
  static constexpr int DQS = DP + 8;  // f32 row stride of a dQ share
  static constexpr int DQ_BYTES = BQT * DQS * 4;
  // dQ shares in flight, one a writer warp: three, but one at DP = 128
  // (no room; its longer steps cover the writers' turn)
  static constexpr int NQB = DP < 128 ? 3 : 1;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  static constexpr int DS_OFF = RING_OFF + STAGES * 2 * QD_BYTES;
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int ACC_OFF = DQ_OFF + NQB * DQ_BYTES;  // the sums so far
  static constexpr int ROWS_OFF = ACC_OFF + NQB * DQ_BYTES;
  static constexpr int META_OFF = ROWS_OFF + STAGES * 3 * BQT * 4;
  static constexpr int BAR_OFF = META_OFF + 16 * STAGES + 16;
  // kv_full, full[STAGES], empty[STAGES], dq_half[3], dq_full[3],
  // dq_empty[3]
  static constexpr int NBAR = 1 + 2 * STAGES + 9;
  static constexpr size_t SMEM = BAR_OFF + 8 * NBAR + 1024;
};

#define WG_D8(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7])
#define WG_D16(C, d) WG_D8(C, d), WG_D8(C, (d + 8))
#define WG_D32(C, d) WG_D16(C, d), WG_D16(C, (d + 16))

// d (+)= A.B for A [64 x 16] and B [16 x 64], both bf16 in shared memory,
// K-major; ACC false writes d only (scale-d 0).
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D32("+f", d)
        : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D32("=f", d)
        : "l"(da), "l"(db), "r"(0));
}

// d (+)= A.B for A [64 x 16] and B [16 x CW], both bf16 in shared memory
// and MN-major (both transposed: A's 64 rows and B's CW columns run along
// the rows of 128 and 2 CW bytes); acc 0 writes d only.
template <int CW>
__device__ __forceinline__ void wgmma_ss_tt(float* d, uint64_t da,
                                            uint64_t db, int acc) {
  if constexpr (CW == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : WG_D32("+f", d)
        : "l"(da), "l"(db), "r"(acc));
  else if constexpr (CW == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : WG_D16("+f", d)
        : "l"(da), "l"(db), "r"(acc));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : WG_D8("+f", d)
        : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A.B for A [64 x 16] bf16 in registers (the m16n8k16 A layout of
// each warp's 16 rows) and B [16 x 64] bf16 in shared memory, K-major;
// ACC false writes d only.
template <bool ACC>
__device__ __forceinline__ void wgmma_rs_n64_k(float* d, const unsigned* a,
                                               uint64_t db) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : WG_D32("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : WG_D32("=f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Wait until *turn reads `want` (the blocks before have added their
// shares); traps after about 10 s of clock, as mbar_wait.
__device__ __forceinline__ void wait_turn(const int* turn, int want) {
  long long start = 0;
  while (ld_acquire(turn) != want) {
    if (start == 0)
      start = clock64();
    else if (clock64() - start > 20000000000LL)
      __trap();
  }
}

// Hand the turn on: the threads that stored the shares have met the caller
// at a barrier (or an mbarrier); the fence orders those stores before the
// new value (the pattern of CUTLASS's semaphore).
__device__ __forceinline__ void pass_turn(int* turn, int next) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(turn),
      "r"(next)
      : "memory");
}

// Whether query tile (positions q_lo..q_hi) and key tile (live keys' range
// k_lo..k_hi) may hold a live pair: one test, from the ranges the D launch
// wrote, in every role of every block, so that all agree on which tiles
// meet.  And whether every pair is live (every key of the tile inside T
// and live, and the masks leave the whole rectangle).
__device__ __forceinline__ bool tiles_meet(int q_lo, int q_hi, int k_lo,
                                           int k_hi, int causal,
                                           int window) {
  return k_lo <= k_hi && (!causal || k_lo <= q_hi) &&
         (window <= 0 || k_hi > q_lo - window);
}

__device__ __forceinline__ bool tiles_all_live(int q_lo, int q_hi, int k_lo,
                                               int k_hi, int k_full,
                                               int causal, int window) {
  return k_full && (!causal || k_hi <= q_lo) &&
         (window <= 0 || k_lo > q_hi - window);
}

template <int DP>
__global__ void __launch_bounds__(BTHREADS, 1) flash_bwd_bf16_hopper_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, int* __restrict__ ws, int n_zero,
    float* __restrict__ dq_acc, float* __restrict__ dk_acc,
    float* __restrict__ dv_acc, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int B, int S, int T, int Hq, int Hkv, int D,
    int causal, int window, float scale) {
  using L = BTile<DP>;
  constexpr int CW = L::CW, SPAN = L::SPAN, NS = L::NS;
  extern __shared__ __align__(1024) unsigned char bsmem[];
  unsigned char* sm =
      bsmem + ((1024u - (smem_addr(bsmem) & 1023u)) & 1023u);
  unsigned char* k_sh = sm;
  unsigned char* v_sh = sm + L::KV_BYTES;
  unsigned char* ring = sm + L::RING_OFF;  // stage: Q, then dO
  unsigned char* ds_sh = sm + L::DS_OFF;   // [2][64][BQT] bf16
  float* dq_sh = reinterpret_cast<float*>(sm + L::DQ_OFF);  // [NQB][BQT][DQS]
  float* acc_sh = reinterpret_cast<float*>(sm + L::ACC_OFF);  // [NQB][BQT][DQS]
  float* rows_sh = reinterpret_cast<float*>(sm + L::ROWS_OFF);
  int* meta = reinterpret_cast<int*>(sm + L::META_OFF);  // [STAGES][4]
  int* work_sh = meta + 4 * L::STAGES;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* full = kv_full + 1;          // [STAGES]: a query tile landed
  uint64_t* empty = full + L::STAGES;    // [STAGES]: 8 consumer warps done
  uint64_t* dq_half = empty + L::STAGES;  // [3]: warpgroup 0's share written
  uint64_t* dq_full = dq_half + 3;        // [3]: the tile's share written
  uint64_t* dq_empty = dq_full + 3;       // [3]: the writers are done with it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int I = (S + BQT - 1) / BQT, J = (T + BKT - 1) / BKT;
  const int G = Hq / Hkv;
  const int* qlo = ws + n_zero;
  const int* qhi = qlo + I;
  const int* klo = qhi + I;
  const int* khi = klo + J;
  const int* kfull = khi + J;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    for (int s = 0; s < 3; ++s) {
      mbar_init(&dq_half[s], 4);
      mbar_init(&dq_full[s], 4);
      mbar_init(&dq_empty[s], L::NQB > 1 ? 1 : 3);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *work_sh = atomicAdd(ws, 1);  // the ticket
  }
  __syncthreads();
  // the ticket's work item: (key tile, batch, KV head, head of the group)
  // in that order
  int item = *work_sh;
  const int r = item % G;
  item /= G;
  const int hk = item % Hkv;
  item /= Hkv;
  const int b = item % B, kt = item / B;
  const int h = hk * G + r;
  const int t0 = kt * BKT;
  const int my_klo = klo[kt], my_khi = khi[kt], my_kfull = kfull[kt];
  auto meets = [&](int i) {
    return tiles_meet(qlo[i], qhi[i], my_klo, my_khi, causal, window);
  };

  if (warp >= 8) {
    if constexpr (DP <= 64)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      // producer: K and V once, then each query tile that meets the key
      // tile, in order; an end marker (query tile -1) closes the list
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
        for (int s = 0; s < NS; ++s) {
          tma_load(k_sh + s * BKT * SPAN, &tm_k, kv_full, s * CW, hk, t0, b);
          tma_load(v_sh + s * BKT * SPAN, &tm_v, kv_full, s * CW, hk, t0, b);
        }
      }
      int stage = 0;
      unsigned phase = 0;
      for (int i = 0;; ++i) {
        const bool end = i >= I;
        if (!end && !meets(i)) continue;
        if (lane == 0) mbar_wait(&empty[stage], phase ^ 1);
        __syncwarp();
        if (!end) {
          float* rs = rows_sh + stage * 3 * BQT;
          for (int rr = lane; rr < BQT; rr += 32) {
            const int gi = BQT * i + rr;
            const bool ok = gi < S;
            const size_t at = ((size_t)b * Hq + h) * S + (ok ? gi : 0);
            // a row past S: P = exp(s - inf) = 0
            rs[rr] = ok ? lse[at] : INFINITY;
            rs[BQT + rr] = ok ? delta[at] : 0.0f;
            reinterpret_cast<int*>(rs)[2 * BQT + rr] = ok ? q_pos[gi] : 0;
          }
        }
        __syncwarp();
        if (lane == 0) {
          meta[4 * stage] = end ? -1 : i;
          if (end) {
            mbar_arrive(&full[stage]);
          } else {
            meta[4 * stage + 1] = tiles_all_live(qlo[i], qhi[i], my_klo,
                                                 my_khi, my_kfull, causal,
                                                 window);
            unsigned char* qs = ring + stage * 2 * L::QD_BYTES;
            mbar_expect_tx(&full[stage], 2 * L::QD_BYTES);
            for (int s = 0; s < NS; ++s) {
              tma_load(qs + s * BQT * SPAN, &tm_q, &full[stage], s * CW, h,
                       BQT * i, b);
              tma_load(qs + L::QD_BYTES + s * BQT * SPAN, &tm_do,
                       &full[stage], s * CW, h, BQT * i, b);
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
    } else {
      // The dQ share of each query tile the block meets, added in its turn
      // (dq = 0 for the query tiles that no key tile meets, from key tile
      // 0): the writers read the sums so far once a lane 0 has seen the
      // turn, store the new ones and hand the turn on.  With three staging
      // buffers, warps 9-11 take the tiles in turns, each with a copy
      // buffer of its own (one waits for a turn or a fence while the others
      // add); with one, they split each tile and meet at a barrier before
      // the turn is handed on.
      constexpr bool ALT = L::NQB > 1;
      const int wt = tid - 9 * 32;  // 0..95
      // its float4 of a tile: column wc, rows wr0, wr0 + RS, ...
      constexpr int C4 = DP / 4, RS = (ALT ? 32 : 96) / C4;
      const int wk = ALT ? lane : wt;
      const int wc = (wk % C4) * 4, wr0 = wk / C4;
      int nq = 0;
      for (int i = 0; i < I; ++i) {
        // this key tile's place among those that meet query tile i
        int before = 0, total = 0;
        for (int k0 = 0; k0 < J; k0 += 32) {
          const int kk = k0 + lane;
          const unsigned m = __ballot_sync(
              FULL, kk < J && tiles_meet(qlo[i], qhi[i], klo[kk], khi[kk],
                                         causal, window));
          total += __popc(m);
          const int below = kt - k0;
          before += __popc(below >= 32 ? m
                           : below <= 0 ? 0u
                                        : m & ((1u << below) - 1u));
        }
        const int rows = min(BQT, S - BQT * i);
        const size_t row0 = (size_t)b * S + BQT * i;
        if (!meets(i)) {
          if (kt == 0 && total == 0)
            for (int e = wt; e < rows * (D / 8); e += 96) {
              const int rr = e / (D / 8), c = (e % (D / 8)) * 8;
              *reinterpret_cast<uint4*>(dq + ((row0 + rr) * Hq + h) * D +
                                        c) = make_uint4(0, 0, 0, 0);
            }
          continue;
        }
        const int buf = nq % L::NQB;
        const unsigned use = (nq / L::NQB) & 1;
        int* turn = ws + 1 + ((size_t)b * Hq + h) * I + i;
        const bool last = before == total - 1;
        ++nq;
        if (ALT && warp != 9 + buf) continue;  // another writer's
        float* acc = acc_sh + (ALT ? buf : 0) * BQT * L::DQS;
        // the turn, then the sums so far copied in (cp.async: no registers
        // held, all in flight), then the share; the thread's float4 are
        // rows wr0 + RS u of its column wc
        const size_t tile0 = (row0 * Hq + h) * D;
        const int rstride = Hq * D;
        if (before > 0) {
          if (lane == 0) wait_turn(turn, before);
          __syncwarp();
          if (wc < D)
#pragma unroll 4
            for (int rr = wr0; rr < rows; rr += RS)
              cp_async16_any(acc + rr * L::DQS + wc,
                             dq_acc + tile0 + rr * rstride + wc, true);
          cp_async_commit();
        }
        mbar_wait(&dq_full[buf], use);
        cp_async_wait<0>();
        // sum = share (first) or sums so far + share, four rows at a time
        // (their loads first); stored in f32, or as dq (scaled, rounded
        // once) by the last
        const float* sh = dq_sh + buf * BQT * L::DQS + wc;
        const float* ac = acc + wc;
        if (wc < D)
          for (int r0 = wr0; r0 < rows; r0 += 4 * RS) {
            float4 x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int rr = min(r0 + u * RS, rows - 1);
              x[u] = *reinterpret_cast<const float4*>(sh + rr * L::DQS);
              if (before > 0) {
                const float4 a =
                    *reinterpret_cast<const float4*>(ac + rr * L::DQS);
                x[u] = make_float4(a.x + x[u].x, a.y + x[u].y, a.z + x[u].z,
                                   a.w + x[u].w);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int rr = r0 + u * RS;
              if (rr >= rows) break;
              const size_t at = tile0 + rr * rstride + wc;
              if (last) {
                uint2 o;
                o.x = pack_bf16(x[u].x * scale, x[u].y * scale);
                o.y = pack_bf16(x[u].z * scale, x[u].w * scale);
                *reinterpret_cast<uint2*>(dq + at) = o;
              } else {
                *reinterpret_cast<float4*>(dq_acc + at) = x[u];
              }
            }
          }
        if constexpr (ALT) {
          __syncwarp();
        } else {
          named_sync(5, 96);
        }
        if (lane == 0) mbar_arrive(&dq_empty[buf]);
        if (wk == 0 && !last) pass_turn(turn, before + 1);
      }
    }
  } else {
    // consumers: warpgroup w owns keys t0 + 64 w .. + 63; each warp 16 of
    // them, each thread keys kr and kr + 8 (the accumulator layout's rows),
    // and the tile's query columns 8 j + fc, + 1
    if constexpr (DP <= 64)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = warp >> 2, wi = warp & 3, g = lane >> 2;
    const int fc = (lane & 3) * 2;
    const int kr = 64 * w + 16 * wi + g;
    int kp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      kp[i] = t0 + kr + 8 * i < T ? k_pos[t0 + kr + 8 * i] : -1;
    float dkr[NS][CW / 2], dvr[NS][CW / 2];
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int e = 0; e < CW / 2; ++e) dkr[sl][e] = dvr[sl][e] = 0.0f;
    const float sl2 = scale * 1.4426950408889634f;  // scale . log2(e)
    unsigned char* ds_w = ds_sh + w * L::DS_BYTES;
    // the A operands of S^T and dP^T at DP <= 64: this warp's 16 keys of K
    // and V in registers for the whole walk (ldmatrix from the swizzled
    // tiles; at DP = 128 they would not fit, and both come from shared
    // memory)
    constexpr bool KV_REGS = DP <= 64;
    unsigned ka[KV_REGS ? DP / 16 : 1][4], va[KV_REGS ? DP / 16 : 1][4];

    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2, warpgroup 0 first), so that one's elementwise work
    // runs while the other's products do
    mbar_wait(kv_full, 0);
    if constexpr (KV_REGS) {
      const int row = 64 * w + 16 * wi + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int ch = (kk * 16 % CW) / 8 + (lane >> 4);
        const int at = (kk * 16 / CW) * BKT * SPAN + row * SPAN +
                       ((ch ^ ((row * SPAN >> 7) & (SPAN / 16 - 1))) << 4);
        ldsm_x4(ka[kk], reinterpret_cast<const bf16*>(k_sh + at));
        ldsm_x4(va[kk], reinterpret_cast<const bf16*>(v_sh + at));
      }
    }
    if (w == 1) named_arrive(1, 256);
    int stage = 0, nq = 0;
    unsigned phase = 0;
    for (;; ++nq) {
      mbar_wait(&full[stage], phase);
      const int i = meta[4 * stage];
      if (i < 0) break;
      const bool all_live = meta[4 * stage + 1] != 0;
      const unsigned char* qs = ring + stage * 2 * L::QD_BYTES;
      const unsigned char* gs = qs + L::QD_BYTES;
      const float* rs = rows_sh + stage * 3 * BQT;
      const int* qps = reinterpret_cast<const int*>(rs + 2 * BQT);

      // S^T and dP^T: this warpgroup's 64 keys against the tile's 64
      // queries, 16 columns of D a step
      float s[32], dp[32];
      named_sync(1 + w, 256);
      wgmma_fence();
      // X = s with K, Q or dp with V, dO
      auto issue = [&](float* x, const unsigned char* kv,
                       const unsigned (*frag)[4], const unsigned char* qd) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int slab = kk * 16 / CW, off = (kk * 16 % CW) * 2;
          const uint64_t db =
              smem_desc(qd + slab * BQT * SPAN + off, 16, 8 * SPAN, L::SWZ);
          if constexpr (KV_REGS) {
            if (kk == 0)
              wgmma_rs_n64_k<false>(x, frag[kk], db);
            else
              wgmma_rs_n64_k<true>(x, frag[kk], db);
          } else {
            const uint64_t da = smem_desc(
                kv + slab * BKT * SPAN + 64 * w * SPAN + off, 16, 8 * SPAN,
                L::SWZ);
            if (kk == 0)
              wgmma_ss_n64<false>(x, da, db);
            else
              wgmma_ss_n64<true>(x, da, db);
          }
        }
        wgmma_commit();
      };
      issue(s, k_sh, ka, qs);
      issue(dp, v_sh, va, gs);
      named_arrive(2 - w, 256);

      // P^T in place (s[4j + 2i + c]: key kr + 8i, query 8j + fc + c),
      // without branches: a masked pair's exponent is -inf
      wgmma_wait<1>();
      reg_fence<32>(s);
      if (all_live) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float nl = rs[8 * j + fc + c] * 1.4426950408889634f;
#pragma unroll
            for (int i2 = 0; i2 < 2; ++i2) {
              const int e = 4 * j + 2 * i2 + c;
              s[e] = fast_exp2(fmaf(s[e], sl2, -nl));
            }
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * j + fc + c;
            const float nl = rs[col] * 1.4426950408889634f;
            const int qp = qps[col];
#pragma unroll
            for (int i2 = 0; i2 < 2; ++i2) {
              const int e = 4 * j + 2 * i2 + c;
              const float x = fmaf(s[e], sl2, -nl);
              s[e] = fast_exp2(live_key(kp[i2], qp, causal, window)
                                   ? x
                                   : -INFINITY);
            }
          }
      }
      // dS^T in place, then both rounded to bf16: the A operands of dV and
      // dK, and dS^T to shared memory for dQ (row kr + 8i - 64 w of ds_w,
      // 16-byte chunk j at j ^ g: the 128-byte swizzle)
      wgmma_wait<0>();
      reg_fence<32>(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = rs[BQT + 8 * j + fc + c];
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int e = 4 * j + 2 * i2 + c;
            dp[e] = s[e] * (dp[e] - dl);
          }
        }
      unsigned pa[4][4], da4[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pa[kc][u] = pack_bf16(s[8 * kc + 2 * u], s[8 * kc + 2 * u + 1]);
          da4[kc][u] = pack_bf16(dp[8 * kc + 2 * u], dp[8 * kc + 2 * u + 1]);
          const int j = 2 * kc + (u >> 1), row = 16 * wi + g + 8 * (u & 1);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           smem_addr(ds_w + row * 128 + ((j ^ g) << 4) +
                                     2 * fc)),
                       "r"(da4[kc][u])
                       : "memory");
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + w, 128);  // the warpgroup's dS^T is in shared memory

      // dV += P^T.dO and dK += dS^T.Q over the tile's queries (dO and Q
      // MN-major), then dQ_w = dS_w.K_w over this warpgroup's keys (dS^T
      // and K MN-major)
      float dqs[NS][CW / 2];
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int e = 0; e < CW / 2; ++e) dqs[sl][e] = 0.0f;
      named_sync(1 + w, 256);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) {
          wgmma_rs<CW>(dvr[sl], pa[kc],
                       smem_desc(gs + sl * BQT * SPAN + kc * 16 * SPAN,
                                 BQT * SPAN, 8 * SPAN, L::SWZ));
          wgmma_rs<CW>(dkr[sl], da4[kc],
                       smem_desc(qs + sl * BQT * SPAN + kc * 16 * SPAN,
                                 BQT * SPAN, 8 * SPAN, L::SWZ));
        }
      wgmma_commit();
      if constexpr (DP == 128) {  // registers: dQ only after dV and dK
        named_arrive(2 - w, 256);
        wgmma_wait<0>();
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) {
          reg_fence<CW / 2>(dvr[sl]);
          reg_fence<CW / 2>(dkr[sl]);
        }
        named_sync(1 + w, 256);
        wgmma_fence();
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int sl = 0; sl < NS; ++sl)
          wgmma_ss_tt<CW>(
              dqs[sl],
              smem_desc(ds_w + kc * 16 * 128, 64 * 128, 8 * 128, 1),
              smem_desc(k_sh + sl * BKT * SPAN + (64 * w + 16 * kc) * SPAN,
                        BKT * SPAN, 8 * SPAN, L::SWZ),
              kc > 0);
      wgmma_commit();
      named_arrive(2 - w, 256);
      wgmma_wait<1>();  // dV and dK done: the stage is free
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        reg_fence<CW / 2>(dvr[sl]);
        reg_fence<CW / 2>(dkr[sl]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      wgmma_wait<0>();
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) reg_fence<CW / 2>(dqs[sl]);

      // the tile's dQ share: warpgroup 0 writes its keys' part, warpgroup 1
      // adds its own, the writers take it (query row 16 wi + g + 8 i2,
      // column sl CW + 8 jj + fc)
      const int buf = nq % L::NQB;
      const unsigned use = (nq / L::NQB) & 1;  // the parity of this use
      float* sh = dq_sh + buf * BQT * L::DQS;
      if (w == 0)
        mbar_wait(&dq_empty[buf], use ^ 1);
      else
        mbar_wait(&dq_half[buf], use);
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int jj = 0; jj < CW / 8; ++jj)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            float2* p = reinterpret_cast<float2*>(
                sh + (16 * wi + g + 8 * i2) * L::DQS + sl * CW + 8 * jj + fc);
            float2 x = make_float2(dqs[sl][4 * jj + 2 * i2],
                                   dqs[sl][4 * jj + 2 * i2 + 1]);
            if (w == 1) {
              const float2 a = *p;
              x = make_float2(a.x + x.x, a.y + x.y);
            }
            *p = x;
          }
      __syncwarp();
      if (lane == 0) mbar_arrive(w == 0 ? &dq_half[buf] : &dq_full[buf]);
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (w == 0) named_sync(1, 256);  // warpgroup 1's last arrival

    // dK (scaled) and dV of the block's keys: written in bf16, or with
    // grouped heads added to the group's f32 sums in head order
    int* turn = ws + 1 + (size_t)B * Hq * I + ((size_t)b * Hkv + hk) * J + kt;
    if (G > 1) {
      if (r > 0 && tid == 0) wait_turn(turn, r);
      named_sync(6, 256);
    }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int key = t0 + kr + 8 * i2;
      if (key >= T) continue;
      const size_t row = ((size_t)(b * T + key) * Hkv + hk) * D;
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int jj = 0; jj < CW / 8; ++jj) {
          const int col = sl * CW + 8 * jj + fc;
          if (col >= D) continue;
          float2 xk = make_float2(dkr[sl][4 * jj + 2 * i2] * scale,
                                  dkr[sl][4 * jj + 2 * i2 + 1] * scale);
          float2 xv = make_float2(dvr[sl][4 * jj + 2 * i2],
                                  dvr[sl][4 * jj + 2 * i2 + 1]);
          if (G > 1 && r > 0) {
            const float2 ak = __ldcg(
                reinterpret_cast<const float2*>(dk_acc + row + col));
            const float2 av = __ldcg(
                reinterpret_cast<const float2*>(dv_acc + row + col));
            xk = make_float2(ak.x + xk.x, ak.y + xk.y);
            xv = make_float2(av.x + xv.x, av.y + xv.y);
          }
          if (r == G - 1) {
            *reinterpret_cast<unsigned*>(dk + row + col) =
                pack_bf16(xk.x, xk.y);
            *reinterpret_cast<unsigned*>(dv + row + col) =
                pack_bf16(xv.x, xv.y);
          } else {
            __stcg(reinterpret_cast<float2*>(dk_acc + row + col), xk);
            __stcg(reinterpret_cast<float2*>(dv_acc + row + col), xv);
          }
        }
    }
    if (G > 1 && r < G - 1) {
      named_sync(6, 256);
      if (tid == 0) pass_turn(turn, r + 1);
    }
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
                          int D, int causal, int window, int sorted,
                          cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (3 * BQ * (DP + 4) + 2 * BK * DP + BQ * PS);
  const auto kernel = prefill_kernel<DP>();
  int e = allow_smem(kernel, smem);
  if (e) return e;
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  kernel<<<grid, PT, smem, st>>>(
      q, k, v, q_pos, k_pos, out, lse, S, T, Hq, Hkv, D, causal, window,
      sorted, 1.0f / sqrtf((float)D));
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
  flash_decode_combine_kernel<<<(rows + DT / 32 - 1) / (DT / 32), DT, 0,
                                st>>>(part_m, part_l, part_acc, out, rows,
                                      n_split, D);
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
                               float* lse, int B, int S, int T, int Hq,
                               int Hkv, int D, int causal, int window,
                               int sorted, cudaStream_t st) {
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
      tq, tk, tv, q_pos, k_pos, out, lse, S, T, Hq, Hkv, D, causal, window,
      sorted, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_decode_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const int* q_pos, const int* k_pos, bf16* out,
                              int B, int S, int T, int Hq, int Hkv, int D,
                              int causal, int window, int n_split,
                              int split_keys, cudaStream_t st) {
  using L = DecodeTile<DP>;
  if (S * (Hq / Hkv) > DROWS || n_split < 1 || n_split > DMAX_SPLIT ||
      split_keys < BK || split_keys % BK ||
      (long long)n_split * split_keys < T ||
      (long long)(n_split - 1) * split_keys >= T)
    return (int)cudaErrorInvalidValue;
  // and a byte a tile of the split, for its liveness
  const size_t smem = L::SMEM + (size_t)(split_keys / BK + 15) / 16 * 16;
  int e = allow_smem(flash_decode_bf16_kernel<DP>, smem);
  if (e) return e;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(DT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, flash_decode_bf16_kernel<DP>, q, k, v,
                              q_pos, k_pos, out, S, T, Hq, Hkv, D, causal,
                              window, split_keys, 1.0f / sqrtf((float)D));
  if (e) return e;
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
      out, dout, delta, rows, S, Hq, D, nullptr, 0, nullptr, nullptr, T);
  int e = (int)cudaGetLastError();
  if (e) return e;
  using L = BwdTile<DP>;
  // and a byte a streamed tile, for its liveness
  const size_t kv_smem =
      L::KV_SMEM + (size_t)((S + BC - 1) / BC + 15) / 16 * 16;
  const size_t q_smem =
      L::Q_SMEM + (size_t)((T + BC - 1) / BC + 15) / 16 * 16;
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
  e = allow_smem(flash_bwd_dq_kernel<DP>, q_smem);
  if (e) return e;
  flash_bwd_dq_kernel<DP>
      <<<dim3(B * Hq, (S + BQ - 1) / BQ), PT, q_smem, st>>>(
          q, k, v, dout, lse, delta, q_pos, k_pos, dq, S, T, Hq, Hkv, D,
          causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_backward_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const bf16* out, const bf16* dout,
                                const float* lse, const int* q_pos,
                                const int* k_pos, float* delta, int* ws,
                                float* dq_acc, float* dkv_acc, bf16* dq,
                                bf16* dk, bf16* dv, int B, int S, int T,
                                int Hq, int Hkv, int D, int causal,
                                int window, cudaStream_t st) {
  using L = BTile<DP>;
  const CUtensorMapSwizzle swizzle =
      L::SPAN == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::SPAN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tdo, tk, tv;
  int e = encode_rows(&tq, q, B, S, Hq, D, L::CW, BQT, swizzle);
  if (!e) e = encode_rows(&tdo, dout, B, S, Hq, D, L::CW, BQT, swizzle);
  if (!e) e = encode_rows(&tk, k, B, T, Hkv, D, L::CW, BKT, swizzle);
  if (!e) e = encode_rows(&tv, v, B, T, Hkv, D, L::CW, BKT, swizzle);
  if (!e) e = allow_smem(flash_bwd_bf16_hopper_kernel<DP>, L::SMEM);
  if (e) return e;
  const int I = (S + BQT - 1) / BQT, J = (T + BKT - 1) / BKT;
  // the ticket, a turn counter per (batch, query head, query tile) and,
  // with grouped heads, per (batch, KV head, key tile)
  const int n_zero = 1 + B * Hq * I + (Hq > Hkv ? B * Hkv * J : 0);
  const int rows = B * S * Hq;
  flash_bwd_dot_kernel<<<(rows + DT / 32 - 1) / (DT / 32), DT, 0, st>>>(
      out, dout, delta, rows, S, Hq, D, ws, n_zero, q_pos, k_pos, T);
  e = (int)cudaGetLastError();
  if (e) return e;
  const size_t n_kv = (size_t)B * T * Hkv * D;
  flash_bwd_bf16_hopper_kernel<DP><<<B * Hq * J, BTHREADS, L::SMEM, st>>>(
      tq, tdo, tk, tv, lse, delta, q_pos, k_pos, ws, n_zero, dq_acc,
      dkv_acc, dkv_acc == nullptr ? nullptr : dkv_acc + n_kv, dq, dk, dv, B,
      S, T, Hq, Hkv, D, causal, window, 1.0f / sqrtf((float)D));
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
// kernel writes out only.  window <= 0: no window.  sorted != 0 promises
// that k_pos is non-decreasing: each block then walks only the key tiles
// that can be live (live_tile_range), with the same result.  D must be a
// multiple of 8 from 8 to 128 (the kernels run at the tile width
// padded_head_dim(D) with the columns past D zero in shared memory and
// never written) and Hq a multiple of Hkv (the wrapper checks; another D
// returns cudaErrorInvalidValue).
int flash_attention_prefill(const float* q, const float* k, const float* v,
                            const int* q_pos, const int* k_pos, float* out,
                            float* lse, int B, int S, int T, int Hq, int Hkv,
                            int D, int causal, int window, int sorted,
                            void* stream) {
  DISPATCH_HEAD_DIM(D, launch_prefill, q, k, v, q_pos, k_pos, out, lse, B, S,
                    T, Hq, Hkv, D, causal, window, sorted,
                    (cudaStream_t)stream)
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
// 16-byte aligned bases; lse, when not null, f32 as there): the Hopper
// kernel (TMA, wgmma, a producer warp), f32 softmax and accumulation, P
// and the result rounded to bf16.  cudaErrorNotSupported if libcuda has
// no tensor-map encoder.
int flash_attention_prefill_bf16(const bf16* q, const bf16* k, const bf16* v,
                                 const int* q_pos, const int* k_pos,
                                 bf16* out, float* lse, int B, int S, int T,
                                 int Hq, int Hkv, int D, int causal,
                                 int window, int sorted, void* stream) {
  DISPATCH_HEAD_DIM(D, launch_prefill_bf16, q, k, v, q_pos, k_pos, out, lse,
                    B, S, T, Hq, Hkv, D, causal, window, sorted,
                    (cudaStream_t)stream)
}

// The backward of flash_attention_prefill_bf16: dq [B,S,Hq,D] and dk, dv
// [B,T,Hkv,D] in bf16, from q, k, v, the forward's bf16 out and its f32
// lse, and dout [B,S,Hq,D] in bf16, with the forward's positions and
// masks.  Scratch: delta (f32, B*Hq*S); ws (int32, 1 + B*Hq*I + (Hq > Hkv ?
// B*Hkv*J : 0) + 2 I + 3 J, with I = ceil(S / 64) query tiles and J =
// ceil(T / 128) key tiles); dq_acc (f32, B*S*Hq*D); dkv_acc (f32,
// 2*B*T*Hkv*D; null when Hq == Hkv).  Two launches on `stream`: D (which
// readies ws), then the Hopper kernel (TMA, wgmma, a producer warp, dQ
// and the group's dK/dV added in a fixed order); every product on bf16
// operands with f32 sums.  Allocates nothing, does not synchronise,
// returns cudaGetLastError(); cudaErrorNotSupported if libcuda has no
// tensor-map encoder.
int flash_attention_backward_bf16(const bf16* q, const bf16* k,
                                  const bf16* v, const bf16* out,
                                  const bf16* dout, const float* lse,
                                  const int* q_pos, const int* k_pos,
                                  float* delta, int* ws, float* dq_acc,
                                  float* dkv_acc, bf16* dq, bf16* dk,
                                  bf16* dv, int B, int S, int T, int Hq,
                                  int Hkv, int D, int causal, int window,
                                  void* stream) {
  DISPATCH_HEAD_DIM(D, launch_backward_bf16, q, k, v, out, dout, lse, q_pos,
                    k_pos, delta, ws, dq_acc, dkv_acc, dq, dk, dv, B, S, T,
                    Hq, Hkv, D, causal, window, (cudaStream_t)stream)
}

// As flash_attention_decode for q, k, v and out in bf16, in one launch and
// without scratch: the keys of each (batch, KV head) cut into n_split
// splits of split_keys keys (a multiple of 64; n_split from 1 to 8, none
// empty by shape), one block of a cluster each.  The wrapper picks both
// from the shapes and the card's multiprocessor count (ops.decode_splits);
// R = S * Hq/Hkv must be at most 16.  Other values return
// cudaErrorInvalidValue.
int flash_attention_decode_bf16(const bf16* q, const bf16* k, const bf16* v,
                                const int* q_pos, const int* k_pos, bf16* out,
                                int B, int S, int T, int Hq, int Hkv, int D,
                                int causal, int window, int n_split,
                                int split_keys, void* stream) {
  DISPATCH_HEAD_DIM(D, launch_decode_bf16, q, k, v, q_pos, k_pos, out, B, S,
                    T, Hq, Hkv, D, causal, window, n_split, split_keys,
                    (cudaStream_t)stream)
}

}  // extern "C"
