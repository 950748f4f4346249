// Fail-Slow Sketch insertion over runs of identical-key records (Algorithm 1).
//
// Replaces the TPU kernel src/repro/kernels/sketch_update/kernel.py
// (sketch_insert, body _kernel, hash _hash_scalar) and the run-compressed
// scan the recorder calls, src/repro/kernels/sketch_update/batched.py
// (insert_runs_vectorized: _one_table_run, _step_run, _stage2).  A record
// is a run with reps = 1 and dt = 0, which reduces exactly to the
// per-record update, so this one kernel serves both entry points.
//
// What bounds it on this card: neither bytes nor operations but two serial
// chains.  Within one sketch the order of runs is semantic: Stage-1
// frequencies race between keys that share a bucket, and Stage-2 rows are
// updated, taken and evicted (FIFO by promotion arrival) in run order.
// Bytes moved are ~28 B per run plus the state once in and once out, a
// fraction of a microsecond at 3.35 TB/s; what costs is the latency of the
// dependent steps: a shared-memory round trip per run for its Stage-1
// bucket, and for each run that reaches Stage 2 the lookup of its row and
// the row's read-modify-write, each behind the one before.
//
// What the design does about it: it takes off the chains everything that
// does not depend on them, and splits what does into two chains that run
// side by side.
//   * One block per sketch, several sketches per launch (the recorder's
//     comp and comm sketches share nothing and run side by side).  The
//     packed state (Stage-1 [d*m] x int4 (lo, hi, valid, freq), Stage-2
//     [L] x 12 words, 16*d*m + 48*L B = 81,920 B at d=2, m=1024, L=1024)
//     lives in dynamic shared memory for the whole call, beside the
//     Stage-2 index below and two ring stages of staged runs: 228,992 B at
//     the pod telemetry's d=2, m=1024, L=2048, of the 232,448 a block may
//     have (a third stage would not fit).
//   * Four loader warps stage the runs in a ring of NSTAGE chunks: five
//     fields by cp.async, the key halves, the run's bucket in each of the d
//     tables and its home slot in the key index (hashes depend on (lo, hi)
//     alone), each chunk signalled by an mbarrier.  No chain reads device
//     memory or hashes.
//   * Stage 1 does not depend on Stage 2, so a warp of its own runs it
//     ahead: lane t updates table t (one 16-byte load and store), one
//     __reduce_min_sync gives the run's first promoted record.  For each
//     run that reaches Stage 2 it appends the run to the chunk's list with
//     a record of its closed-form aggregates laid out like a row, and hands
//     the chunk on by an mbarrier.
//   * The Stage-2 warp runs the listed runs, warp-synchronously (no
//     __syncthreads in either chain), loading each while the one before
//     is on the chain.  Each decision is O(1) instead of a
//     scan of L rows, from three structures built at kernel start from the
//     incoming state (mirrored in Python by kernels/sketch_update/ref
//     .Stage2Index):
//       - key -> row: open addressing over a power of two >= 2L, entries
//         (lo, hi, row, home); 32 lanes probe 32 slots with one load and
//         two ballots; deletion by backward shift keeps lookups stopping
//         at the first empty slot;
//       - free rows: a bitmap read with __ballot_sync and __ffs (rows are
//         overwritten, never cleared, so free rows never come back);
//       - live rows in arrival order: a ring whose head is the FIFO
//         victim.  In every state the sketch produces the live arrivals
//         are exactly counter - live .. counter - 1 (a new row takes the
//         counter, an eviction drops the oldest), so a row's place in the
//         ring is its arrival's offset: built in O(L).
//     Lane k < 11 then makes field k of the row from word k of the record
//     (an add, a min or max, or a write), and lanes 0..9 drain a victim's
//     fields, in parallel.
//     The build checks the precondition these need (s2_valid in {0,1};
//     live arrivals distinct and in counter - live .. counter - 1; live
//     keys distinct) and reports a violation in the sketch's status word
//     instead of running.
//
// The device-memory variant (the same body, WIDE = true).  A sketch whose
// sections do not all fit one block's shared memory (d=2 or 4 at m=4096,
// L=1024 among the paper's Fig 13 geometries; any L past 4,096) keeps the
// algorithm, the order of operations and one block per sketch, but holds
// the sections named in its placement mask (SEC_*: Stage 1, the key index,
// the Stage-2 rows, the row and index slots, the ring, the free bitmap) in
// a device-memory scratch the wrapper allocates, and its slots are 32 bits
// wide.  The wrapper moves the fewest sections, largest first
// (kernels/sketch_update/layout.placement): for the Fig 13 geometries only
// Stage 1, whose chain then pays an L1/L2 round trip a run where it paid a
// shared-memory one; the Stage-2 chain's state stays in shared memory.  A
// launch whose sketches take both paths is split in two, each kernel
// launched with its own shared-memory size.
//
// Floats: build with -fmad=false.  The Stage-2 aggregates are computed in
// the operation order of the plain torch version (ref.insert_runs_plain),
// and without FMA contraction each product and sum rounds alone, so the
// two agree bit for bit.  The one exception is the run's first and last
// start, t0 + dt * k: the reference's scan (XLA on the CPU) contracts it
// into one fused multiply-add, so the kernel does so explicitly
// (__fmaf_rn) and the plain version rounds dt * k + t0 once (ref.fma_f32).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NT 192                 // Stage-2 warp, Stage-1 warp, 4 loader warps
#define NLOAD (NT - 64)
#define CHUNK NLOAD            // runs per ring stage: one per loader
#define NSTAGE 2
#define MAX_D 8
#define MAX_SKETCHES 8
#define ROW 12                 // words of a Stage-2 row (11 fields, a pad)
#define FULL 0xffffffffu
#define MAX_L 4096             // shared-memory kernel: rows and index
                               // slots fit 16 bits
// sections the device-memory variant may keep in its scratch (bit masks)
#define SEC_IDX 1
#define SEC_T1 2
#define SEC_S2 4
#define SEC_POS 8
#define SEC_RING 16
#define SEC_FBITS 32

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
  int* status;                 // out: precondition code, 0 when it holds
  int n, d, m, H, L, cap;
};

struct SketchBatch {
  SketchArgs s[MAX_SKETCHES];
  unsigned char* scratch[MAX_SKETCHES];  // the variant's device sections
  int place[MAX_SKETCHES];               // which sections (SEC_*) they are
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

// Home slot of a key in the index (ref.index_home).
__device__ __forceinline__ int index_home(int lo, int hi, int mask) {
  uint32_t x = (uint32_t)lo * 0x9E3779B1u + (uint32_t)hi * 0x85EBCA77u;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  return (int)(x & (uint32_t)mask);
}

// Byte offsets of the sections, in shared memory or (the variant's
// sections in `place`) in the sketch's scratch; identical on host and
// device (kernels/sketch_update/layout.py restates it).  The block's
// SketchArgs come first, at offset 0 of shared memory.
struct Layout {
  size_t bars, idx, t1, s2, pos, ring, fbits, stage, total, scratch;
  int tsize, nwords;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// The next section's offset in shared memory (`at`) or in the scratch
// (`g`), each section starting on 16 bytes.
__host__ __device__ inline size_t put(size_t& at, size_t& g, bool dev, size_t bytes) {
  size_t& p = dev ? g : at;
  const size_t off = p;
  p = align16(p + bytes);
  return off;
}

// `wide`: 32-bit row and index slots (the variant), else 16-bit.
__host__ __device__ inline Layout layout(int d, int m, int L, bool wide, int place) {
  Layout o;
  o.tsize = 1;
  while (o.tsize < 2 * L) o.tsize *= 2;       // ref.index_size
  o.nwords = (L + 31) / 32;
  const size_t slot = wide ? 4 : 2;
  size_t at = align16(sizeof(SketchArgs)), g = 0;
  o.bars = put(at, g, false, 3 * NSTAGE * 8 + 2 * 4);                   // barriers; flags
  o.idx = put(at, g, place & SEC_IDX, (size_t)o.tsize * 16);             // int4 entries
  o.t1 = put(at, g, place & SEC_T1, (size_t)16 * d * m);                 // Stage 1
  o.s2 = put(at, g, place & SEC_S2, (size_t)4 * ROW * L);                // Stage 2
  o.pos = put(at, g, place & SEC_POS, slot * L);                         // row -> index slot
  o.ring = put(at, g, place & SEC_RING, slot * L);                       // FIFO ring
  o.fbits = put(at, g, place & SEC_FBITS, (size_t)4 * o.nwords);         // free bitmap
  o.stage = put(at, g, false, ((size_t)NSTAGE * CHUNK * (9 + ROW + d) + NSTAGE) * 4);
  o.total = at;
  o.scratch = g;
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// The arrive fires when every cp.async this thread issued so far has landed
// (without .noinc the pending count is raised by one first, so the thread
// also makes its own arrive).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Claim an empty ring place: 16-bit slots (shared-memory kernel) or
// 32-bit ones (device-memory variant).
__device__ __forceinline__ uint16_t slot_cas(uint16_t* p, uint16_t cmp, uint16_t v) {
  return atomicCAS(p, cmp, v);
}

__device__ __forceinline__ uint32_t slot_cas(uint32_t* p, uint32_t cmp, uint32_t v) {
  return atomicCAS(p, cmp, v);
}

// A promoting run as the Stage-2 warp holds it: key, home slot in the
// index, and word `lane` of its record.
struct StagedRun { int lo, hi, h, word; };

// Which field of a Stage-2 row lane k < 11 makes, as bit masks (all ones
// or zero), and how it is updated: per-lane selects would compile to
// divergent branches that the lanes take one after another.
struct RowMasks { int lo, hi, one, cnt, arr, sum, sq, val, tmin, tmax, min, add, keep; };

__device__ __forceinline__ RowMasks row_masks(int lane) {
  RowMasks m;
  m.lo = -(lane == 0); m.hi = -(lane == 1); m.one = -(lane == 2);
  m.cnt = -(lane == 3); m.arr = -(lane == 4); m.sum = -(lane == 5);
  m.sq = -(lane == 6); m.val = -(lane == 7); m.tmin = -(lane == 8);
  m.tmax = -(lane == 9); m.min = -(lane == 10);
  m.add = m.sum | m.sq | m.val;                // float sums
  m.keep = m.lo | m.hi | m.one | m.arr;        // unchanged by an update
  return m;
}

static_assert(sizeof(SketchArgs) % 8 == 0 && sizeof(SketchArgs) / 8 <= NT,
              "SketchArgs is copied as one 8-byte word a thread");

template <bool WIDE>
__global__ void __launch_bounds__(NT) sketch_insert_runs_kernel(
    const __grid_constant__ SketchBatch batch) {
  // row and index slots: 16 bits in shared memory up to MAX_L rows, 32 in
  // the device-memory variant
  typedef typename std::conditional<WIDE, uint32_t, uint16_t>::type Slot;
  const Slot EMPTY = (Slot)~0u;                   // an empty ring place
  extern __shared__ __align__(16) unsigned char smem[];
  // The block's arguments, copied once: a run-time index into the
  // parameter space would make every use a generic load.
  if (threadIdx.x < sizeof(SketchArgs) / 8)
    ((uint64_t*)smem)[threadIdx.x] =
        ((const uint64_t*)&batch.s[blockIdx.x])[threadIdx.x];
  __syncthreads();
  const SketchArgs a = *(const SketchArgs*)smem;
  // the variant's sections in device memory; none in the shared kernel
  const int place = WIDE ? batch.place[blockIdx.x] : 0;
  unsigned char* const scratch = WIDE ? batch.scratch[blockIdx.x] : nullptr;
  const Layout o = layout(a.d, a.m, a.L, WIDE, place);
  auto sec = [&](int bit, size_t off) { return ((place & bit) ? scratch : smem) + off; };
  uint64_t* loaded = (uint64_t*)(smem + o.bars);  // loaders -> Stage 1
  uint64_t* ready = loaded + NSTAGE;              // Stage 1 -> Stage 2
  uint64_t* freed = ready + NSTAGE;               // Stage 2 -> loaders
  int* flags = (int*)(freed + NSTAGE);            // code, live rows
  int4* idx = (int4*)sec(SEC_IDX, o.idx);         // (lo, hi, row or -1, home)
  int4* T1 = (int4*)sec(SEC_T1, o.t1);            // (lo, hi, valid, freq)
  int* S2 = (int*)sec(SEC_S2, o.s2);              // row j at S2 + j * ROW
  const int d = a.d, m = a.m, dm = d * m, L = a.L, n = a.n;
  const int tmask = o.tsize - 1;
  Slot* pos_of = (Slot*)sec(SEC_POS, o.pos);
  Slot* ring = (Slot*)sec(SEC_RING, o.ring);
  uint32_t* fbits = (uint32_t*)sec(SEC_FBITS, o.fbits);
  const int NB = NSTAGE * CHUNK;                  // staged runs, by field
  int* g_lo = (int*)(smem + o.stage);
  int* g_hi = g_lo + NB;
  int* g_reps = g_hi + NB;
  int* g_home = g_reps + NB;
  int* g_plist = g_home + NB;                     // written by Stage 1: the
  int* g_rec = g_plist + NB;                      // runs that promote, a record each
  float* g_dur = (float*)(g_rec + NB * ROW);
  float* g_val = g_dur + NB;
  float* g_t0 = g_val + NB;
  float* g_dt = g_t0 + NB;
  int* g_bkt = (int*)(g_dt + NB);                 // [NB][d]
  int* g_pcount = g_bkt + NB * d;                 // [NSTAGE]: their number

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < dm; i += NT)
    T1[i] = make_int4(a.keys_lo[i], a.keys_hi[i], a.valid[i], a.freq[i]);
  for (int j = tid; j < L; j += NT) {
    int* row = S2 + j * ROW;
    row[0] = a.s2_lo[j]; row[1] = a.s2_hi[j]; row[2] = a.s2_valid[j];
    row[3] = a.s2_count[j]; row[4] = a.s2_arrival[j];
    row[5] = __float_as_int(a.s2_sum[j]); row[6] = __float_as_int(a.s2_sumsq[j]);
    row[7] = __float_as_int(a.s2_val[j]); row[8] = __float_as_int(a.s2_tmin[j]);
    row[9] = __float_as_int(a.s2_tmax[j]); row[10] = __float_as_int(a.s2_min[j]);
    ring[j] = EMPTY;
  }
  for (int q = tid; q < o.tsize; q += NT) idx[q] = make_int4(0, 0, -1, 0);
  if (tid == 0) {
    flags[0] = 0; flags[1] = 0;
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&loaded[s], NLOAD); mbar_init(&ready[s], 1); mbar_init(&freed[s], 1);
    }
  }
  const int C0 = *a.counter;
  __syncthreads();

  // ---- build the index, the free bitmap and the ring; check ------------
  int code = 0, live = 0;
  for (int base = warp * 32; base < o.nwords * 32; base += (NT / 32) * 32) {
    const int j = base + lane;
    const int v = j < L ? S2[j * ROW + 2] : 1;
    if (v != 0 && v != 1) code |= 1;
    live += v == 1 && j < L;
    const uint32_t b = __ballot_sync(FULL, v == 0);
    if (lane == 0) fbits[base >> 5] = b;
  }
  if (live) atomicAdd(&flags[1], live);
  __syncthreads();
  const int nlive = flags[1], oldest = C0 - nlive;
  for (int j = tid; j < L; j += NT) {
    const int* row = S2 + j * ROW;
    if (row[2] != 1) continue;
    if (row[4] >= C0 || row[4] < oldest) code |= 2;
    else if (slot_cas(&ring[row[4] - oldest], EMPTY, (Slot)j) != EMPTY)
      code |= 4;
    const int lo = row[0], hi = row[1], h = index_home(lo, hi, tmask);
    for (int q = h;; q = (q + 1) & tmask) {
      if (atomicCAS(&idx[q].z, -1, j) == -1) {
        idx[q].x = lo; idx[q].y = hi; idx[q].w = h; pos_of[j] = q;
        break;
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < L; j += NT) {          // each live key finds its row
    const int* row = S2 + j * ROW;
    if (row[2] != 1) continue;
    const int lo = row[0], hi = row[1];
    for (int q = index_home(lo, hi, tmask);; q = (q + 1) & tmask) {
      const int4 e = idx[q];
      if (e.z >= 0 && e.x == lo && e.y == hi) { if (e.z != j) code |= 8; break; }
    }
  }
  if (code) atomicOr(&flags[0], code);
  __syncthreads();
  if (flags[0]) {                              // uniform: nothing is written
    if (tid == 0) *a.status = flags[0];
    return;
  }

  const int nchunks = (n + CHUNK - 1) / CHUNK;
  if (warp >= 2) {
    // ---- loaders: stage chunk c in ring stage c % NSTAGE ------------------
    const int p = tid - 64;
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % NSTAGE;
      if (c >= NSTAGE) mbar_wait(&freed[s], ((c / NSTAGE) - 1) & 1);
      const int i = c * CHUNK + p, e = s * CHUNK + p;
      if (i < n) {
        cp_async4(g_reps + e, a.reps + i);
        cp_async4(g_dur + e, a.dur + i);
        cp_async4(g_val + e, a.val + i);
        cp_async4(g_t0 + e, a.t0 + i);
        cp_async4(g_dt + e, a.dt + i);
        const int lo = __ldg(a.lo + i), hi = __ldg(a.hi + i);
        g_lo[e] = lo; g_hi[e] = hi;
        g_home[e] = index_home(lo, hi, tmask);
        for (int t = 0; t < d; ++t) g_bkt[e * d + t] = t * m + hash_bucket(lo, hi, t, m);
      }
      mbar_arrive_cp_async(&loaded[s]);
      mbar_arrive(&loaded[s]);
    }
  } else if (warp == 1) {
    // ---- Stage 1, run after run: lane t owns table t ----------------------
    const int H = a.H;
    const RowMasks mk = row_masks(lane);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % NSTAGE, e0 = s * CHUNK;
      const int e_end = e0 + min(CHUNK, n - c * CHUNK);
      mbar_wait(&loaded[s], (c / NSTAGE) & 1);
      int np = 0;                              // runs that reach Stage 2
      int r_n = g_reps[e0], lo_n = g_lo[e0], hi_n = g_hi[e0];
      int b_n = lane < d ? g_bkt[e0 * d + lane] : 0;
      float dur_n = g_dur[e0], val_n = g_val[e0], t0_n = g_t0[e0], dt_n = g_dt[e0];
      for (int e = e0; e < e_end; ++e) {
        const int r = r_n, lo = lo_n, hi = hi_n, b = b_n;
        const float dur = dur_n, val = val_n, t0 = t0_n, dt = dt_n;
        if (e + 1 < e_end) {                   // the next run's fields, ahead
          r_n = g_reps[e + 1]; lo_n = g_lo[e + 1]; hi_n = g_hi[e + 1];
          if (lane < d) b_n = g_bkt[(e + 1) * d + lane];
          dur_n = g_dur[e + 1]; val_n = g_val[e + 1];
          t0_n = g_t0[e + 1]; dt_n = g_dt[e + 1];
        }
        int kk = r;
        if (r > 0 && lane < d) {               // batched._one_table_run
          const int4 t = T1[b];
          const int f0 = t.w;
          const bool match = t.z == 1 && t.x == lo && t.y == hi;
          const bool emp = t.z == 0;
          const bool steal = !match && !emp && r > f0;
          const bool claim = emp || steal;
          const int newf = match ? f0 + r : emp ? r : steal ? r - f0 : f0 - r;
          const int k = match ? H - f0 - 1 : emp ? H - 1 : steal ? f0 + H - 1 : r;
          T1[b] = make_int4(claim ? lo : t.x, claim ? hi : t.y,
                            (match || claim || newf > 0) ? 1 : 0, newf);
          kk = max(k, 0);
        }
        // records first..r-1 reach Stage 2 (none when first >= r)
        const int first = __reduce_min_sync(FULL, kk);
        if (first < r) {
          // their closed-form aggregates (_step_run), laid out as a row:
          // lane k < 11 writes word k
          const int nrec = r - first;
          const float nf = (float)nrec;
          const float sdur = nf * dur;
          const float ssq = sdur * dur;
          const float sval = nf * val;
          const float tfirst = __fmaf_rn(dt, (float)first, t0);
          const float tlast = __fmaf_rn(dt, (float)(r - 1), t0) + dur;
          const int word = (lo & mk.lo) | (hi & mk.hi) | (1 & mk.one)
                           | (nrec & mk.cnt) | (__float_as_int(sdur) & mk.sum)
                           | (__float_as_int(ssq) & mk.sq) | (__float_as_int(sval) & mk.val)
                           | (__float_as_int(tfirst) & mk.tmin)
                           | (__float_as_int(tlast) & mk.tmax) | (__float_as_int(dur) & mk.min);
          // every lane stores, lanes past 10 a zero into the row's unused
          // word 11: with the fused starts ptxas compiled a store under
          // lane < 11 as a divergent branch, which cost a detect 5 %
          g_rec[(e0 + np) * ROW + min(lane, ROW - 1)] = word;
          if (lane == 0) g_plist[e0 + np] = e;
          ++np;
        }
      }
      if (lane == 0) g_pcount[s] = np;
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[s]);
    }
  } else {
    // ---- Stage 2, promoting run after promoting run -----------------------
    int C = C0, dn = *a.d_n, head = 0, count = nlive;
    const int cap = a.cap;
    // lane k < 10 drains row field k < 2 ? k : k + 1 into drain column k
    int* const dcols[10] = {a.d_lo, a.d_hi, a.d_count, a.d_arrival,
                            (int*)a.d_sum, (int*)a.d_sumsq, (int*)a.d_val,
                            (int*)a.d_tmin, (int*)a.d_tmax, (int*)a.d_min};
    int* dcol = dcols[0];
#pragma unroll
    for (int k = 1; k < 10; ++k) dcol = lane == k ? dcols[k] : dcol;
    const int dsrc = lane < 2 ? lane : lane + 1;
    const RowMasks mk = row_masks(lane);
    const int fld = min(lane, ROW - 1);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % NSTAGE, e0 = s * CHUNK;
      mbar_wait(&ready[s], (c / NSTAGE) & 1);
      const int np = g_pcount[s];
      // promoting run k + 1 is loaded while run k is on the chain (its key,
      // home slot and, in lane k < 11, word k of its record), and the place
      // of run k + 2, so that no load waits for another
      auto fetch = [&](int q, int e) {
        return StagedRun{g_lo[e], g_hi[e], g_home[e], g_rec[(e0 + q) * ROW + fld]};
      };
      StagedRun nx = np ? fetch(0, g_plist[e0]) : StagedRun{};
      int e_nn = np > 1 ? g_plist[e0 + 1] : e0;
      for (int k = 0; k < np; ++k) {
        const StagedRun x = nx;
        if (k + 1 < np) {
          nx = fetch(k + 1, e_nn);
          if (k + 2 < np) e_nn = g_plist[e0 + k + 2];
        }
        const int lo = x.lo, hi = x.hi, h = x.h, v = x.word;
        const int victim = ring[head];
        // the key's row from the index
        int j = -1, ins = -1;
        for (int base = h;; base += 32) {
          const int4 en = idx[(base + lane) & tmask];
          const uint32_t hit = __ballot_sync(FULL, en.z >= 0 && en.x == lo && en.y == hi);
          if (hit) { j = __shfl_sync(FULL, en.z, __ffs(hit) - 1); break; }
          const uint32_t gap = __ballot_sync(FULL, en.z < 0);
          if (gap) { ins = (base + __ffs(gap) - 1) & tmask; break; }
        }
        const bool exists = j >= 0;
        if (!exists && count < L) {            // the lowest free row
          for (int wb = 0;; wb += 32) {
            const uint32_t word = wb + lane < o.nwords ? fbits[wb + lane] : 0u;
            const uint32_t any = __ballot_sync(FULL, word != 0u);
            if (any) {
              const int wl = __ffs(any) - 1;
              const uint32_t bits = __shfl_sync(FULL, word, wl);
              j = (wb + wl) * 32 + __ffs(bits) - 1;
              if (lane == 0) {
                fbits[wb + wl] = bits & ~(1u << (j & 31));
                ring[(head + count) % L] = j;
              }
              break;
            }
          }
          ++count;
        } else if (!exists) {                  // the FIFO victim
          j = victim;
          head = head + 1 == L ? 0 : head + 1;
          if (dn < cap) {                      // drain it first
            if (lane < 10) dcol[dn] = S2[j * ROW + dsrc];
            ++dn;
          }
          // delete its key: backward shift, 32 slots a load; each round
          // moves the first entry whose home is not between gap and itself
          int p = pos_of[j];
          for (int w0 = p + 1;; w0 += 32) {
            const int q = (w0 + lane) & tmask;
            const int4 en = idx[q];
            const uint32_t gaps = __ballot_sync(FULL, en.z < 0);
            const uint32_t before = gaps ? (gaps & (0u - gaps)) - 1u : FULL;
            uint32_t left = before;
            for (;;) {
              const uint32_t mv = __ballot_sync(
                  FULL, ((q - en.w) & tmask) >= ((q - p) & tmask)) & left;
              if (!mv) break;
              const int i = __ffs(mv) - 1;
              if (lane == i) { idx[p] = en; pos_of[en.z] = p; }
              p = (w0 + i) & tmask;
              left &= i == 31 ? 0u : FULL << (i + 1);
            }
            if (gaps) break;
          }
          if (lane == 0) idx[p] = make_int4(0, 0, -1, 0);
          // the shift left every gap a gap and opened one more, at p: the
          // key's first gap is p if p comes before the one the lookup found
          if (((p - h) & tmask) < ((ins - h) & tmask)) ins = p;
          __syncwarp();
        }
        if (!exists && lane == 0) {
          idx[ins] = make_int4(lo, hi, j, h);
          pos_of[j] = ins;
        }
        // field k of the row, by the plain version's operations: the
        // record's word k added, taken as a min or max, or written
        int* f = S2 + j * ROW + fld;
        const int old = *f;
        const float of = __int_as_float(old), fv = __int_as_float(v);
        const int w = exists
            ? (__float_as_int(of + fv) & mk.add) | (__float_as_int(fmaxf(of, fv)) & mk.tmax)
                  | (__float_as_int(fminf(of, fv)) & (mk.tmin | mk.min))
                  | ((old + v) & mk.cnt) | (old & mk.keep)
            : v | (C & mk.arr);
        if (lane < 11) *f = w;
        if (!exists) ++C;
        __syncwarp();                          // the row and index, before the next lookup
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&freed[s]);   // stage s may be refilled
    }
    if (lane == 0) { *a.counter = C; *a.d_n = dn; *a.status = 0; }
  }
  __syncthreads();

  for (int i = tid; i < dm; i += NT) {
    const int4 t = T1[i];
    a.keys_lo[i] = t.x; a.keys_hi[i] = t.y; a.valid[i] = t.z; a.freq[i] = t.w;
  }
  for (int j = tid; j < L; j += NT) {
    const int* row = S2 + j * ROW;
    a.s2_lo[j] = row[0]; a.s2_hi[j] = row[1]; a.s2_valid[j] = row[2];
    a.s2_count[j] = row[3]; a.s2_arrival[j] = row[4];
    a.s2_sum[j] = __int_as_float(row[5]); a.s2_sumsq[j] = __int_as_float(row[6]);
    a.s2_val[j] = __int_as_float(row[7]); a.s2_tmin[j] = __int_as_float(row[8]);
    a.s2_tmax[j] = __int_as_float(row[9]); a.s2_min[j] = __int_as_float(row[10]);
  }
}

extern "C" {

// Dynamic shared memory one block of the shared-memory kernel needs.
long long sketch_insert_smem_bytes(int d, int m, int L) {
  return (long long)layout(d, m, L, false, 0).total;
}

// Dynamic shared memory and device scratch of one block of the
// device-memory variant with the sections `place` in device memory.
long long sketch_insert_variant_smem_bytes(int d, int m, int L, int place) {
  return (long long)layout(d, m, L, true, place).total;
}

long long sketch_insert_scratch_bytes(int d, int m, int L, int place) {
  return (long long)layout(d, m, L, true, place).scratch;
}

// Insert each sketch's runs, one block per sketch, on `stream`
// (1 <= count <= MAX_SKETCHES).  place[k] < 0 runs sketch k in the
// shared-memory kernel (L <= MAX_L); place[k] >= 0 in the device-memory
// variant, with the sections place[k] in scratch[k].  The sketches of each
// path share one launch, with that path's largest shared-memory size:
// one launch, or two when the batch mixes the paths (shared first).
// Allocates nothing, does not synchronise, returns cudaGetLastError().
int sketch_insert_runs(const SketchArgs* args, void* const* scratch,
                       const int* place, int count, void* stream) {
  if (count < 1 || count > MAX_SKETCHES) return (int)cudaErrorInvalidValue;
  SketchBatch batch[2];
  int n[2] = {0, 0};
  size_t smem[2] = {0, 0};
  for (int k = 0; k < count; ++k) {
    const int v = place[k] >= 0;
    if (!v && args[k].L > MAX_L) return (int)cudaErrorInvalidValue;
    batch[v].s[n[v]] = args[k];
    batch[v].scratch[n[v]] = (unsigned char*)scratch[k];
    batch[v].place[n[v]] = v ? place[k] : 0;
    ++n[v];
    const size_t need = layout(args[k].d, args[k].m, args[k].L, v, v ? place[k] : 0).total;
    smem[v] = need > smem[v] ? need : smem[v];
  }
  // one launch of `count` sketches, all on the path `wide` names
  auto launch = [stream](auto wide, const SketchBatch& b, int count, size_t smem) {
    constexpr bool WIDE = decltype(wide)::value;
    cudaError_t e = cudaFuncSetAttribute(
        sketch_insert_runs_kernel<WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sketch_insert_runs_kernel<WIDE><<<count, NT, smem, (cudaStream_t)stream>>>(b);
    return (int)cudaGetLastError();
  };
  int rc = n[0] ? launch(std::false_type{}, batch[0], n[0], smem[0]) : 0;
  if (!rc && n[1]) rc = launch(std::true_type{}, batch[1], n[1], smem[1]);
  return rc;
}

}  // extern "C"
