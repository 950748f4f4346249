// Fail-Slow Sketch insertion over runs of identical-key records (Algorithm 1).
//
// Replaces the TPU kernel src/repro/kernels/sketch_update/kernel.py
// (sketch_insert, body _kernel, hash _hash_scalar) and the run-compressed
// scan the recorder calls, src/repro/kernels/sketch_update/batched.py
// (insert_runs_vectorized: _one_table_run, _step_run, _stage2).  A record
// is a run with reps = 1 and dt = 0, which reduces exactly to the
// per-record update, so this one kernel serves both entry points.
//
// What bounds it on this card: neither bytes nor operations.  The work is a
// serial chain: within one sketch the order of runs is semantic (Stage-1
// frequencies race between keys that share a bucket, Stage-2 eviction is
// FIFO by promotion arrival), so run i+1 cannot start before run i has
// finished.  Each run costs one barrier after the Stage-1 update and, when
// it promotes, one block reduction over the L Stage-2 slots and a second
// barrier.  Bytes moved are ~28 B per run plus the state once in and once
// out, a fraction of a microsecond at 3.35 TB/s; the dependency chain is
// what holds the kernel back.
//
// What the design does about it: one block per sketch keeps the whole
// packed state (Stage-1 [d][m] x lo/hi/valid/freq and Stage-2 11 x L,
// 16*d*m + 44*L bytes = 77,828 B at d=2, m=1024, L=1024) in dynamic shared
// memory for the whole call, so every step of the chain is a shared-memory
// access, never a device-memory round trip.  Threads 0..d-1 each own one
// hash table (no conflicts between them); the Stage-2 search for the
// matching slot, the lowest free slot and the oldest (arrival, index) row
// is spread over all 256 threads and reduced with warp shuffles.  The
// Stage-1 promotion indices are double-buffered by run parity, so a run
// that promotes nothing costs a single barrier.
//
// Floats: build with -fmad=false.  The Stage-2 aggregates are computed in
// the operation order of the plain torch version (ref.insert_runs_plain),
// and without FMA contraction each product and sum rounds alone, so the
// two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARPS (NT / 32)
#define MAX_D 8
#define I32MAX 2147483647

__constant__ uint32_t HASH_A1[MAX_D] = {
    0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du, 0x27D4EB2Fu,
    0x165667B1u, 0xD3A2646Du, 0xFD7046C5u, 0xB55A4F09u};
__constant__ uint32_t HASH_A2[MAX_D] = {
    0x632BE59Bu, 0x9E3779B9u, 0x7F4A7C15u, 0xF39CC060u,
    0x1F83D9ABu, 0x5BE0CD19u, 0xCA62C1D6u, 0x8F1BBCDCu};
__constant__ uint32_t HASH_B[MAX_D] = {
    0x7ED55D16u, 0xC761C23Cu, 0x165667B1u, 0xD3A2646Cu,
    0xFD7046C5u, 0xB55A4F09u, 0x2DEB33A5u, 0x14292967u};

// Every pointer is device memory.  Field order must match SketchArgs in
// kernels/sketch_update/ops.py.
struct SketchArgs {
  const int* lo; const int* hi; const int* reps;
  const float* dur; const float* val; const float* t0; const float* dt;
  int* keys_lo; int* keys_hi; int* valid; int* freq;
  int* s2_lo; int* s2_hi; int* s2_valid; int* s2_count; int* s2_arrival;
  float* s2_sum; float* s2_sumsq; float* s2_val;
  float* s2_tmin; float* s2_tmax; float* s2_min;
  int* counter;
  int* d_lo; int* d_hi; int* d_count; int* d_arrival;
  float* d_sum; float* d_sumsq; float* d_val;
  float* d_tmin; float* d_tmax; float* d_min;
  int* d_n;
  int n, d, m, H, L, cap;
};

// core/sketch.py hash_bucket, in uint32 so that wraparound is defined.
__device__ __forceinline__ int hash_bucket(int lo, int hi, int table, int m) {
  uint32_t x = HASH_A1[table] * (uint32_t)lo + HASH_A2[table] * (uint32_t)hi
               + HASH_B[table];
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 13;
  return (int)((x & 0x7FFFFFFFu) % (uint32_t)m);
}

static size_t smem_bytes(int d, int m, int L) {
  return NWARPS * sizeof(unsigned long long)       // red_evict
         + (2 * NWARPS + 2 * MAX_D) * sizeof(int)  // red_match/free, ks
         + (size_t)4 * d * m * sizeof(int)          // Stage-1 tables
         + (size_t)5 * L * sizeof(int)              // Stage-2 int columns
         + (size_t)6 * L * sizeof(float);           // Stage-2 float columns
}

__global__ void __launch_bounds__(NT) sketch_insert_runs_kernel(SketchArgs a) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* red_evict = smem;
  int* red_match = (int*)(red_evict + NWARPS);
  int* red_free = red_match + NWARPS;
  int* ks = red_free + NWARPS;                 // [2][MAX_D], by run parity
  const int dm = a.d * a.m, L = a.L;
  int* t_lo = ks + 2 * MAX_D;
  int* t_hi = t_lo + dm;
  int* t_v = t_hi + dm;
  int* t_f = t_v + dm;
  int* s_lo = t_f + dm;
  int* s_hi = s_lo + L;
  int* s_v = s_hi + L;
  int* s_c = s_v + L;
  int* s_arr = s_c + L;
  float* s_sum = (float*)(s_arr + L);
  float* s_sq = s_sum + L;
  float* s_val = s_sq + L;
  float* s_tmin = s_val + L;
  float* s_tmax = s_tmin + L;
  float* s_min = s_tmax + L;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < dm; i += NT) {
    t_lo[i] = a.keys_lo[i]; t_hi[i] = a.keys_hi[i];
    t_v[i] = a.valid[i];    t_f[i] = a.freq[i];
  }
  for (int j = tid; j < L; j += NT) {
    s_lo[j] = a.s2_lo[j]; s_hi[j] = a.s2_hi[j]; s_v[j] = a.s2_valid[j];
    s_c[j] = a.s2_count[j]; s_arr[j] = a.s2_arrival[j];
    s_sum[j] = a.s2_sum[j]; s_sq[j] = a.s2_sumsq[j]; s_val[j] = a.s2_val[j];
    s_tmin[j] = a.s2_tmin[j]; s_tmax[j] = a.s2_tmax[j]; s_min[j] = a.s2_min[j];
  }
  int C = 0, dn = 0;                           // live in thread 0 only
  if (tid == 0) { C = *a.counter; dn = *a.d_n; }
  int par = 0;                                 // parity of processed runs
  __syncthreads();

  for (int i = 0; i < a.n; ++i) {
    const int r = __ldg(a.reps + i);
    if (r <= 0) continue;                      // uniform: every thread skips
    const int lo = __ldg(a.lo + i), hi = __ldg(a.hi + i);
    int* kb = ks + par * MAX_D;
    par ^= 1;
    // ---- Stage 1: thread t owns table t (batched._one_table_run) -------
    if (tid < a.d) {
      const int b = tid * a.m + hash_bucket(lo, hi, tid, a.m);
      const int f0 = t_f[b];
      const bool match = t_v[b] == 1 && t_lo[b] == lo && t_hi[b] == hi;
      const bool empty = t_v[b] == 0;
      const bool steal = !match && !empty && r > f0;
      int newf, k;
      if (match)      { newf = f0 + r; k = a.H - f0 - 1; }
      else if (empty) { newf = r;      k = a.H - 1; }
      else if (steal) { newf = r - f0; k = f0 + a.H - 1; }
      else            { newf = f0 - r; k = r; }
      if (empty || steal) { t_lo[b] = lo; t_hi[b] = hi; }
      t_v[b] = (match || empty || steal || newf > 0) ? 1 : 0;
      t_f[b] = newf;
      kb[tid] = max(k, 0);
    }
    __syncthreads();
    int first = r;
    for (int t = 0; t < a.d; ++t) first = min(first, kb[t]);
    if (first >= r) continue;                  // nothing reaches Stage 2

    // ---- Stage 2: find the slot (block reduction over L) ---------------
    int jm = I32MAX, jf = I32MAX;
    unsigned long long ev = ~0ull;             // (arrival, index) of oldest
    for (int j = tid; j < L; j += NT) {
      const int v = s_v[j];
      if (v == 1) {
        if (s_lo[j] == lo && s_hi[j] == hi) jm = min(jm, j);
        // flip the sign bit so signed arrival order is unsigned order
        const unsigned long long key =
            ((unsigned long long)((uint32_t)s_arr[j] ^ 0x80000000u) << 32)
            | (uint32_t)j;
        ev = min(ev, key);
      } else if (v == 0) {
        jf = min(jf, j);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      jm = min(jm, __shfl_xor_sync(0xffffffffu, jm, off));
      jf = min(jf, __shfl_xor_sync(0xffffffffu, jf, off));
      ev = min(ev, __shfl_xor_sync(0xffffffffu, ev, off));
    }
    if (lane == 0) { red_match[warp] = jm; red_free[warp] = jf; red_evict[warp] = ev; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < NWARPS; ++w) {      // warp 0's is in registers
        jm = min(jm, red_match[w]); jf = min(jf, red_free[w]);
        ev = min(ev, red_evict[w]);
      }
      const bool exists = jm != I32MAX, any_free = jf != I32MAX;
      const int j = exists ? jm : (any_free ? jf : (int)(uint32_t)ev);
      // ---- closed-form aggregates of records first..r-1 (_step_run) ---
      const float dur = __ldg(a.dur + i), val = __ldg(a.val + i);
      const float t0 = __ldg(a.t0 + i), dt = __ldg(a.dt + i);
      const int n = r - first;
      const float nf = (float)n;
      const float sdur = nf * dur;
      const float ssq = sdur * dur;
      const float sval = nf * val;
      const float tfirst = t0 + dt * (float)first;
      const float tlast = t0 + dt * (float)(r - 1) + dur;
      if (exists) {
        s_c[j] += n;
        s_sum[j] = s_sum[j] + sdur;
        s_sq[j] = s_sq[j] + ssq;
        s_val[j] = s_val[j] + sval;
        s_tmin[j] = fminf(s_tmin[j], tfirst);
        s_tmax[j] = fmaxf(s_tmax[j], tlast);
        s_min[j] = fminf(s_min[j], dur);
      } else {
        if (!any_free && dn < a.cap) {         // drain the FIFO victim
          a.d_lo[dn] = s_lo[j]; a.d_hi[dn] = s_hi[j];
          a.d_count[dn] = s_c[j]; a.d_arrival[dn] = s_arr[j];
          a.d_sum[dn] = s_sum[j]; a.d_sumsq[dn] = s_sq[j];
          a.d_val[dn] = s_val[j]; a.d_tmin[dn] = s_tmin[j];
          a.d_tmax[dn] = s_tmax[j]; a.d_min[dn] = s_min[j];
          ++dn;
        }
        s_lo[j] = lo; s_hi[j] = hi; s_v[j] = 1; s_c[j] = n; s_arr[j] = C;
        s_sum[j] = sdur; s_sq[j] = ssq; s_val[j] = sval;
        s_tmin[j] = tfirst; s_tmax[j] = tlast; s_min[j] = dur;
        ++C;
      }
    }
    // Thread 0's Stage-2 writes are published by the next run's Stage-1
    // barrier, before any thread reads Stage 2 again.
  }
  __syncthreads();

  for (int i = tid; i < dm; i += NT) {
    a.keys_lo[i] = t_lo[i]; a.keys_hi[i] = t_hi[i];
    a.valid[i] = t_v[i];    a.freq[i] = t_f[i];
  }
  for (int j = tid; j < L; j += NT) {
    a.s2_lo[j] = s_lo[j]; a.s2_hi[j] = s_hi[j]; a.s2_valid[j] = s_v[j];
    a.s2_count[j] = s_c[j]; a.s2_arrival[j] = s_arr[j];
    a.s2_sum[j] = s_sum[j]; a.s2_sumsq[j] = s_sq[j]; a.s2_val[j] = s_val[j];
    a.s2_tmin[j] = s_tmin[j]; a.s2_tmax[j] = s_tmax[j]; a.s2_min[j] = s_min[j];
  }
  if (tid == 0) { *a.counter = C; *a.d_n = dn; }
}

extern "C" {

// Dynamic shared memory the kernel needs for this geometry.
long long sketch_insert_smem_bytes(int d, int m, int L) {
  return (long long)smem_bytes(d, m, L);
}

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError().
int sketch_insert_runs(const SketchArgs* args, void* stream) {
  const size_t smem = smem_bytes(args->d, args->m, args->L);
  cudaError_t e = cudaFuncSetAttribute(
      sketch_insert_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sketch_insert_runs_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"
