// The dense FailRank iteration over the MCG, every step in one launch:
//
//   s'[v]   = (1 - lam) * s0[v] + lam * sum_u W[u,v] * s[u]
//   L'[u,v] = alpha * W[u,v] + beta * s[u] + gamma * L[u,v]
//
// repeated until the L1 residual sum|s' - s| + sum|L' - L| is below eps or
// max_iters steps have run.
//
// Replaces the TPU kernel src/repro/kernels/failrank_step/kernel.py
// (failrank_step, body _kernel: both outputs from one read of W) and the
// host loop around it (src/repro/kernels/failrank_step/ops.py,
// failrank_dense).  With max_iters = 1 it is that one step.
//
// What bounds it on this card: latency.  One step reads W and L and
// writes L' once, 3 * n^2 * 4 B (811 KB at n = 260, about 0.24 us at
// 3.35 TB/s), against 5 * n^2 floating-point operations; a launch and a
// host read of the residual per step cost far more than that.
//
// What the design does about it: one launch runs the whole iteration on a
// cluster of CLUSTER blocks (distributed shared memory, Hopper's thread
// block clusters).  Block b owns a stripe of about n / CLUSTER columns of W
// and L, kept in its shared memory for the whole call where the stripe
// fits (n = 68 and 260 on the main path; 256 threads a block), else read
// and updated in place in device memory (the 8.5 MB of n = 1,028 stay in
// the 50 MB L2; 1,024 threads a block, so that enough loads are in flight
// to cover the L2's latency).  Each
// step a block makes its columns of s' and L' from the current s, which
// every block holds whole (a thread takes a column and a class of rows and
// reads each W and L element there once for both); writes its s' columns into every block's next
// s (double-buffered, so no block overwrites what another still reads);
// and writes its partial residuals into every block.  One cluster barrier
// per step publishes both, then every block sums the partials in rank
// order, so all take the same eps decision.  The host reads s, L and the
// step count once (and, on request, the residual of the last step).  Every
// sum runs in an order fixed by n, so two runs are bit-identical.  Build
// with -fmad=false: L' then equals the plain torch version bit for bit.
//
// The order of the sums decides the step at which the residual, which sits
// at eps, first falls below it.  A column's sum runs over `parts` classes
// of rows (below); the shared-memory path takes nt / cw classes, the
// device-memory path the number its caller gives (ops.DEVICE_ROW_CLASSES,
// 39), the order in which it stops at the reference's Pallas step counts
// at n = 68 and 1,028 (kernels/failrank_step/ref.py,
// failrank_iterate_ordered, mirrors the order on the CPU).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define CLUSTER 8

// Threads a block: the device-memory path needs more loads in flight.
__host__ __device__ constexpr int threads(bool on_chip) { return on_chip ? 256 : 1024; }

struct FailRankArgs {
  const float* w; const float* l; const float* s; const float* s0;
  float* s_out; float* l_out; int* iters; float* residual;
  int n, max_iters, device_parts;
  float one_minus_lam, lam, alpha, beta, gamma;
  double eps;
};

// Rows split into `parts` classes u = p (mod parts): on chip nt / cw, so
// that a block of nt threads has about nt (class, column) items; in device
// memory `device_parts`, but at most 8 nt / cw (eight items a thread, and
// the column partial sums within shared memory); at most n.
__host__ __device__ inline int col_parts(int n, bool on_chip,
                                         int device_parts) {
  const int cw = (n + CLUSTER - 1) / CLUSTER, w = cw > 0 ? cw : 1;
  const int cap = 8 * threads(false) / w;
  const int p = on_chip ? threads(true) / w
                        : device_parts < cap ? device_parts : cap;
  return p < 1 ? 1 : p > n ? n : p;
}

// Floats of shared memory: s twice, partial residuals twice, the block
// reduction, s0 of the stripe, the column partial sums and, on chip, the W
// and L stripes.
__host__ __device__ inline size_t smem_floats(int n, bool on_chip,
                                              int device_parts) {
  const int cw = (n + CLUSTER - 1) / CLUSTER;
  return (size_t)2 * n + 4 * CLUSTER + 2 * (threads(on_chip) / 32) + cw
         + (size_t)col_parts(n, on_chip, device_parts) * cw
         + (on_chip ? (size_t)2 * n * cw : 0);
}

// Item (p, v): column v's partial sum over rows u = p (mod P), u
// ascending, into colp[p][v], and L' at those rows in place.  Returns the
// thread's part of sum |L' - L|.  U rows' W and L are loaded before any of
// them is used, so that U loads of each are in flight (the stores to L
// would otherwise keep the next rows' loads behind them); the sums still
// run over u in order.
template <int NT, int U>
__device__ __forceinline__ float step_items(
    const float* __restrict__ W, float* __restrict__ Ls,
    const float* __restrict__ s, float* __restrict__ colp, int ld, int n,
    int nc, int cw, int P, float alpha, float beta, float gamma) {
  float dl = 0.0f;
  for (int item = threadIdx.x; item < P * nc; item += NT) {
    const int p = item / nc, v = item - p * nc;
    float acc = 0.0f;
    int u = p;
    for (; u + (U - 1) * P < n; u += U * P) {
      float wv[U], lo[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const size_t at = (size_t)(u + k * P) * ld + v;
        wv[k] = W[at];
        lo[k] = Ls[at];
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const float su = s[u + k * P];
        acc = acc + wv[k] * su;
        const float ln = alpha * wv[k] + beta * su + gamma * lo[k];
        Ls[(size_t)(u + k * P) * ld + v] = ln;
        dl = dl + fabsf(ln - lo[k]);
      }
    }
    for (; u < n; u += P) {
      const size_t at = (size_t)u * ld + v;
      const float wv = W[at], su = s[u], lo = Ls[at];
      acc = acc + wv * su;
      const float ln = alpha * wv + beta * su + gamma * lo;
      Ls[at] = ln;
      dl = dl + fabsf(ln - lo);
    }
    colp[p * cw + v] = acc;
  }
  return dl;
}

template <bool ON_CHIP>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(threads(ON_CHIP))
failrank_kernel(const __grid_constant__ FailRankArgs a) {
  constexpr int NT = threads(ON_CHIP), NWARPS = NT / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = a.n, cw = (n + CLUSTER - 1) / CLUSTER;
  const int P = col_parts(n, ON_CHIP, a.device_parts);
  const int c0 = min(n, rank * cw), nc = min(n, c0 + cw) - c0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float sm[];
  float* sbuf = sm;                            // [2][n]
  float* part = sbuf + 2 * n;                  // [2][CLUSTER][2]: s, L
  float* red = part + 4 * CLUSTER;             // [NWARPS][2]
  float* s0c = red + 2 * NWARPS;               // [cw]
  float* colp = s0c + cw;                      // [P][cw]
  const float* W;                              // stripe [n][ld]
  float* Ls;
  int ld;
  if (ON_CHIP) {
    float* ws = colp + P * cw;
    Ls = ws + n * cw;
    W = ws;
    ld = cw;
    for (int e = tid; e < n * nc; e += NT) {
      const int u = e / nc, v = e - u * nc;
      ws[u * cw + v] = a.w[(size_t)u * n + c0 + v];
      Ls[u * cw + v] = a.l[(size_t)u * n + c0 + v];
    }
  } else {
    W = a.w + c0;
    Ls = a.l_out + c0;
    ld = n;
    for (int e = tid; e < n * nc; e += NT) {
      const int u = e / nc, v = e - u * nc;
      Ls[(size_t)u * n + v] = a.l[(size_t)u * n + c0 + v];
    }
  }
  for (int u = tid; u < n; u += NT) sbuf[u] = a.s[u];
  for (int v = tid; v < nc; v += NT) s0c[v] = a.s0[c0 + v];
  cluster.sync();                              // every block set up

  int cur = 0, done = 0;
  float last = 0.0f;  // the residual of the last step
  for (int it = 0; it < a.max_iters; ++it) {
    const float* s = sbuf + cur * n;
    float* s_next = sbuf + (cur ^ 1) * n;
    float ds = 0.0f;
    float dl = step_items<NT, ON_CHIP ? 4 : 8>(W, Ls, s, colp, ld, n, nc, cw,
                                               P, a.alpha, a.beta, a.gamma);
    __syncthreads();                           // colp complete
    for (int v = tid; v < nc; v += NT) {
      float acc = 0.0f;
      for (int p = 0; p < P; ++p) acc = acc + colp[p * cw + v];
      const float sv = a.one_minus_lam * s0c[v] + a.lam * acc;
      ds = ds + fabsf(sv - s[c0 + v]);
      for (int r = 0; r < CLUSTER; ++r)
        cluster.map_shared_rank(s_next, r)[c0 + v] = sv;
    }
    // block sums of (ds, dl): warp trees, then warps in order
    for (int off = 16; off > 0; off >>= 1) {
      ds = ds + __shfl_xor_sync(0xffffffffu, ds, off);
      dl = dl + __shfl_xor_sync(0xffffffffu, dl, off);
    }
    if (lane == 0) { red[2 * warp] = ds; red[2 * warp + 1] = dl; }
    __syncthreads();
    if (tid < CLUSTER) {
      float bs = 0.0f, bl = 0.0f;
      for (int k = 0; k < NWARPS; ++k) { bs = bs + red[2 * k]; bl = bl + red[2 * k + 1]; }
      float* dst = cluster.map_shared_rank(part, tid) + (cur * CLUSTER + rank) * 2;
      dst[0] = bs;
      dst[1] = bl;
    }
    cluster.sync();                            // s' and the partials everywhere
    const float* pr = part + cur * CLUSTER * 2;
    float rs = 0.0f, rl = 0.0f;
    for (int r = 0; r < CLUSTER; ++r) { rs = rs + pr[2 * r]; rl = rl + pr[2 * r + 1]; }
    cur ^= 1;
    done = it + 1;
    last = rs + rl;
    if ((double)last < a.eps) break;           // the same in every block
  }

  for (int v = tid; v < nc; v += NT) a.s_out[c0 + v] = sbuf[cur * n + c0 + v];
  if (ON_CHIP) {
    for (int e = tid; e < n * nc; e += NT) {
      const int u = e / nc, v = e - u * nc;
      a.l_out[(size_t)u * n + c0 + v] = Ls[u * cw + v];
    }
  }
  if (rank == 0 && tid == 0) {
    *a.iters = done;
    if (a.residual) *a.residual = last;
  }
}

extern "C" {

// Run up to max_iters steps on `stream` (max_iters = 1 and eps < 0: one
// step); allocates nothing, does not synchronise, returns
// cudaGetLastError().  All pointers are device memory, row-major [n, n]
// for w, l and l_out; iters receives the number of steps run and, unless
// null, residual the last step's L1 residual.  stripes: 1 keeps W and L in
// shared memory, 0 in device memory, -1 picks shared memory where they
// fit; device_parts is the number of row classes in device memory.
int failrank_iterate(const float* w, const float* l, const float* s,
                     const float* s0, float* s_out, float* l_out, int* iters,
                     float* residual, int n, int max_iters, int device_parts,
                     float one_minus_lam, float lam, float alpha, float beta,
                     float gamma, double eps, int stripes, void* stream) {
  if (device_parts < 1) return (int)cudaErrorInvalidValue;
  const FailRankArgs a = {w, l, s, s0, s_out, l_out, iters, residual, n,
                          max_iters, device_parts, one_minus_lam, lam,
                          alpha, beta, gamma, eps};
  const bool on_chip =
      stripes < 0 ? smem_floats(n, true, device_parts) * sizeof(float) <= 232448
                  : stripes == 1;
  const size_t smem = smem_floats(n, on_chip, device_parts) * sizeof(float);
  auto kernel = on_chip ? failrank_kernel<true> : failrank_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<CLUSTER, threads(on_chip), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
