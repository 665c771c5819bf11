// The reduced system of the Schur-complement solvers K8 (schur_spa_2d.cu,
// 3x3 blocks) and K16 (schur_spa_3d.cu, 6x6 blocks): B X and B y into
// the reduced matrix without atomics, and its Cholesky solve in one
// thread-block cluster. B is the block width.
//
// B X, B y: the coupling entries (E of them, each a B x B block Bc between
// reduced slot ae and node be) are grouped by slot once per call (`order`,
// with slot_start and piece_start per slot, S + 1 each), each slot's
// entries cut into pieces of kPiece. reduce_pieces_kernel: one block per
// (piece, column tile) adds its entries' Bc X[be] (and Bc y[be], the last
// column) in order in registers and writes the piece's B rows;
// reduce_slots_kernel: one block per (slot, tile of 32 columns) adds its
// pieces and writes the slot's rows of B X (and B y) once. The sums' order
// is fixed from run to run.
//
// Cholesky: the n x n system blockdiag(A) - B X, augmented with its
// right-hand side -(g_s - B y) as row n, factored by panels of 32 columns
// with one cluster barrier per panel, the forward substitution riding along
// as the last row, then the back substitution by panels (below).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage (an unnamed namespace) for everything here, so that two
// libraries that include this header share nothing when loaded into one
// process, the launch's once-per-device attribute flag least of all.
namespace schur {
namespace {

constexpr int kReduceThreads = 128;  // a block's threads in the B X launches
constexpr int kPiece = 64;           // coupling entries per piece of the B X reduction
constexpr int kCholThreads = 512;
constexpr int kPanel = 32;           // columns per panel step of the reduced Cholesky
constexpr int kMaxCluster = 16;      // Hopper's largest cluster, a non-portable size
constexpr size_t kMaxShared = 232448;  // a block's dynamic shared memory on Hopper

// ------------------------------------------------------------ B X, B y

template <int B>
struct SlotReduce {
  int S, K;                // reduced slots; columns of X and of the partial sums (B S + 1)
  const float* Bc;         // (E, B, B) coupling blocks
  const int* ae;           // (E,) reduced slot, < 0 where the entry is zero
  const int* be;           // (E,) node
  const float* X;          // (N, B, K) T^-1 [B^T | g_n]
  const int* order;        // (E,) entries by slot
  const int* slot_start;   // (S + 1,) first position of each slot's entries
  const int* piece_start;  // (S + 1,) first piece of each slot
  float* partial;          // (pieces, B, K)
  float* M;                // (B S, B S) B X, followed by B y (B S)
};

template <int B>
__global__ void __launch_bounds__(kReduceThreads) reduce_pieces_kernel(SlotReduce<B> g) {
  __shared__ float bc[kPiece][B * B];
  __shared__ int node[kPiece];
  const int q = blockIdx.x;
  int lo = 0, hi = g.S;  // the slot a with piece_start[a] <= q < piece_start[a + 1]
  if (q >= g.piece_start[g.S]) return;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (g.piece_start[mid] <= q) lo = mid;
    else hi = mid;
  }
  const int a = lo;
  const int first = g.slot_start[a] + (q - g.piece_start[a]) * kPiece;
  const int count = min(kPiece, g.slot_start[a + 1] - first);
  for (int t = threadIdx.x; t < count * B * B; t += blockDim.x) {
    const int e = g.order[first + t / (B * B)];
    bc[t / (B * B)][t % (B * B)] = g.ae[e] >= 0 ? g.Bc[B * B * (size_t)e + t % (B * B)] : 0.0f;
    if (t % (B * B) == 0) node[t / (B * B)] = g.ae[e] >= 0 ? g.be[e] : -1;
  }
  __syncthreads();
  const int c = blockIdx.y * kReduceThreads + threadIdx.x;
  if (c >= g.K) return;
  const size_t K = g.K;
  float acc[B];
#pragma unroll
  for (int i = 0; i < B; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int t = 0; t < count; ++t) {
    if (node[t] < 0) continue;
    const float* x = g.X + (size_t)node[t] * B * K + c;
    float xv[B];
#pragma unroll
    for (int j = 0; j < B; ++j) xv[j] = x[j * K];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < B; ++j) v = v + bc[t][B * i + j] * xv[j];
      acc[i] = acc[i] + v;
    }
  }
#pragma unroll
  for (int i = 0; i < B; ++i) g.partial[((size_t)q * B + i) * K + c] = acc[i];
}

// A block per slot and tile of 32 columns: warp w adds the pieces q = w
// mod 4 in order, then the first warp adds the four warps' sums in order.
template <int B>
__global__ void __launch_bounds__(kReduceThreads) reduce_slots_kernel(SlotReduce<B> g) {
  constexpr int warps = kReduceThreads / 32;
  __shared__ float part[warps][B][32];
  const int a = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.y * 32 + lane;
  const int q0 = g.piece_start[a], q1 = g.piece_start[a + 1];
  if (q0 == q1) return;
  const size_t K = g.K;
  float acc[B];
#pragma unroll
  for (int i = 0; i < B; ++i) acc[i] = 0.0f;
  if (c < g.K)
#pragma unroll 4
    for (int q = q0 + warp; q < q1; q += warps)
#pragma unroll
      for (int i = 0; i < B; ++i) acc[i] = acc[i] + g.partial[((size_t)q * B + i) * K + c];
#pragma unroll
  for (int i = 0; i < B; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp != 0 || c >= g.K) return;
  const int n = B * g.S;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    float v = part[0][i][lane];
    for (int u = 1; u < warps; ++u) v = v + part[u][i][lane];
    // Column c < n of B X, or B y (row n of the augmented system).
    g.M[c < g.K - 1 ? (size_t)(B * a + i) * n + c : (size_t)n * n + B * a + i] = v;
  }
}

// Both launches; `max_pieces` at least the pieces the grouping makes.
template <int B>
inline void launch_slot_reduce(const SlotReduce<B>& g, int max_pieces, cudaStream_t s) {
  if (max_pieces <= 0) return;
  reduce_pieces_kernel<B><<<dim3(max_pieces, (g.K + kReduceThreads - 1) / kReduceThreads),
                            kReduceThreads, 0, s>>>(g);
  reduce_slots_kernel<B><<<dim3(g.S, (g.K + 31) / 32), kReduceThreads, 0, s>>>(g);
}

// ------------------------------------------------------------ the reduced system

struct System {
  int n;             // rows
  int bs;            // width of A's diagonal blocks
  const float* A;    // (n / bs, bs, bs)
  const float* g_s;  // (n,)
  float* M;          // (n + 1, n): B X, then B y as row n; the rows in place where the
                     // cluster's shared memory cannot hold them
  float* panels;     // kMaxCluster x kPanel x (n + 1): the panel buffers in that case
  float* dx;         // (n,) the solution
};

// The augmented system's rows: row i < n holds blockdiag(A) - B X (its
// lower triangle is read), row n -(g_s - B y). Rows are dealt out to the
// cluster's blocks in turn (row i to block i mod blocks), held in the
// blocks' shared memory where they fit, else in place in M.
struct Rows {
  float* own;  // this block's rows where they are shared, else null
  float* M;    // the rows in place, where they are not
  int shift;   // log2 of the cluster's blocks
  int n;
  // Row i, held by block i mod blocks.
  __device__ float* row(cooperative_groups::cluster_group cluster, int i) const {
    if (!own) return M + (size_t)i * n;
    return cluster.map_shared_rank(own, (unsigned int)(i & ((1 << shift) - 1))) +
           (size_t)(i >> shift) * n;
  }
  // Row i of this block's own, through its own shared memory.
  __device__ float* mine(int i) const {
    return own ? own + (size_t)(i >> shift) * n : M + (size_t)i * n;
  }
};

// This block's rows' factor columns [c0, c0 + wd) from the panel buffer.
__device__ inline void write_panel(const Rows& R, const float* panel, int ld, int n, int rank,
                                   int c0, int wd) {
  const int blocks = 1 << R.shift;
  const int first = rank + (c0 > rank ? (c0 - rank + blocks - 1) >> R.shift << R.shift : 0);
  const int rows = first <= n ? (n - first) / blocks + 1 : 0;
  for (int e = threadIdx.x; e < rows * kPanel; e += blockDim.x) {
    const int i = first + (e / kPanel) * blocks, k = e % kPanel;
    if (k < wd && c0 + k <= i) R.mine(i)[c0 + k] = panel[k * ld + i];
  }
}

// Cholesky factor and solve of the reduced system in one thread-block
// cluster, by panels of kPanel columns. In panel step c0 every block reads
// the panel's columns of all rows i >= c0 from their blocks, factors the
// panel's diagonal block in one warp (registers and shuffles), solves every
// row below it against that factor (a thread per row; row n so becomes
// the forward substitution's y), and updates its own rows' trailing columns
// with the panel; one cluster barrier ends the step. A block writes its
// rows' panel values (the factor's columns) at the start of the next step,
// when no block reads them any more. Then one block solves L^T x = y by
// panels, reading the factor's rows from the cluster and multiplying by the
// diagonal's reciprocals it kept. A pivot's reciprocal square root is one
// MUFU.RSQ, and the rows below take the reciprocal, not a division. A pivot
// that is not positive gives NaN, which reaches dx, and the step is
// rejected. At 192 rows in 8 blocks the one warp's chains still set the
// time: the diagonal factor takes 30% of its cycles and the back
// substitution 22% on an NVIDIA H100 80GB HBM3 at 700.00 W
// (tests/reduced_cholesky_trace.py, PERF.md).
__global__ void __launch_bounds__(kCholThreads, 1)
    cholesky_kernel(System s, int in_shared) {
  // in_shared: the rows and the panel buffer in shared memory; else the rows
  // in place in M and each block's panel buffer in s.panels.
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n = s.n, ld = n + 1;  // ld: the panel buffer's row length
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* diag = sm;  // [32][33]: the panel's factor, and 1 / its diagonal in column 32
  float* vec = diag + 32 * 33;  // [n]: the back substitution's vector
  float* rdiag = vec + n;       // [n]: 1 / the factor's diagonal, for the back substitution
  // [k][i]: column c0 + k of row i in the panel step c0.
  float* panel = in_shared ? rdiag + n : s.panels + (size_t)rank * kPanel * ld;
  float* own = rdiag + n + kPanel * ld;  // this block's rows, where they are shared
  Rows R{in_shared ? own : nullptr, s.M, __ffs(blocks) - 1, n};

  // This block's rows: blockdiag(A) - B X on and below the diagonal; row n.
  const int bs = s.bs;
  for (int i = rank; i <= n; i += blocks) {
    float* dst = R.mine(i);
    const float* src = s.M + (size_t)i * n;  // row n: B y
    for (int j = tid; j < (i < n ? i + 1 : n); j += blockDim.x) {
      if (i == n) {
        dst[j] = -(s.g_s[j] - src[j]);
      } else {
        const float a = i / bs == j / bs ? s.A[bs * bs * (i / bs) + bs * (i % bs) + j % bs]
                                         : 0.0f;
        dst[j] = a - src[j];
      }
    }
  }
  cluster.sync();

  int prev = -1, prev_w = 0;
  for (int c0 = 0; c0 < n; c0 += kPanel) {
    const int wd = min(kPanel, n - c0), c1 = c0 + wd;
    // The previous panel's factor columns into this block's rows.
    if (prev >= 0) write_panel(R, panel, ld, n, rank, prev, prev_w);
    __syncthreads();
    // A warp per row, a lane per column: the loads of four rows in flight.
    if (lane < wd)
#pragma unroll 4
      for (int i = c0 + warp; i <= n; i += kCholThreads / 32)
        panel[lane * ld + i] = R.row(cluster, i)[c0 + lane];
    __syncthreads();
    if (warp == 0) {  // the diagonal block's factor, lane r its row r
      float a[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k)
        a[k] = lane < wd ? (k <= lane && k < wd ? panel[k * ld + c0 + lane] : 0.0f)
                         : (k == lane ? 1.0f : 0.0f);
      // Column k scaled by 1 / sqrt(pivot), one MUFU.RSQ (the chain of 32
      // pivots is the panel step's longest: an IEEE sqrt and division a
      // pivot took twice as long); lane k keeps its reciprocal.
      float rinv = 1.0f;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        const float inv = rsqrtf(__shfl_sync(0xffffffffu, a[k], k));
        a[k] = a[k] * inv;
        rinv = lane == k ? inv : rinv;
#pragma unroll
        for (int c = k + 1; c < kPanel; ++c) {
          const float lck = __shfl_sync(0xffffffffu, a[k], c);
          if (lane >= c) a[c] = a[c] - a[k] * lck;
        }
      }
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        diag[lane * 33 + k] = a[k];
        if (lane < wd && k < wd) panel[k * ld + c0 + lane] = k <= lane ? a[k] : 0.0f;
      }
      diag[lane * 33 + 32] = rinv;
      if (lane < wd) rdiag[c0 + lane] = rinv;
    }
    __syncthreads();
    // Rows below: L_ip = M_ip L_pp^-T, column k subtracted from the columns
    // after it as soon as it is known (the same operations in the same order
    // as a dot product per column, without its chain).
    for (int i = c1 + tid; i <= n; i += blockDim.x) {
      float l[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) l[k] = k < wd ? panel[k * ld + i] : 0.0f;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        l[k] = l[k] * diag[k * 33 + 32];
#pragma unroll
        for (int t = k + 1; t < kPanel; ++t) l[t] = l[t] - l[k] * diag[t * 33 + k];
        if (k < wd) panel[k * ld + i] = l[k];
      }
    }
    __syncthreads();
    // This block's rows' trailing columns j in [c1, min(i, n - 1)].
    for (int i = rank + warp * blocks; i <= n; i += (blockDim.x >> 5) * blocks) {
      if (i < c1) continue;
      float li[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) li[k] = k < wd ? panel[k * ld + i] : 0.0f;
      float* dst = R.mine(i);
      const int last = min(i, n - 1);
      for (int j = c1 + lane; j <= last; j += 32) {
        float v = dst[j];
#pragma unroll
        for (int k = 0; k < kPanel; ++k) v = v - li[k] * panel[k * ld + j];
        dst[j] = v;
      }
    }
    prev = c0;
    prev_w = wd;
    cluster.sync();
  }
  if (prev >= 0) write_panel(R, panel, ld, n, rank, prev, prev_w);
  cluster.sync();

  if (rank == 0) {  // L^T x = y, y the factor's row n
    const float* y = R.row(cluster, n);
    for (int j = tid; j < n; j += blockDim.x) vec[j] = y[j];
    __syncthreads();
    for (int c0 = ((n - 1) / kPanel) * kPanel; c0 >= 0; c0 -= kPanel) {
      const int wd = min(kPanel, n - c0);
      if (warp == 0) {  // lane r: column r of the panel's factor, and x_r
        float col[kPanel];
#pragma unroll
        for (int i = 0; i < kPanel; ++i)
          col[i] = lane < wd && i < wd && i > lane ? R.row(cluster, c0 + i)[c0 + lane] : 0.0f;
        float t = lane < wd ? vec[c0 + lane] : 0.0f;
        const float r = lane < wd ? rdiag[c0 + lane] : 0.0f;
#pragma unroll
        for (int k = kPanel - 1; k >= 0; --k) {
          if (k < wd) {
            const float xk = __shfl_sync(0xffffffffu, t * r, k);
            if (lane == k) t = xk;
            else if (lane < k) t = t - col[k] * xk;
          }
        }
        if (lane < wd) vec[c0 + lane] = t;
      }
      __syncthreads();
      for (int j = tid; j < c0; j += blockDim.x) {
        float v = vec[j];
#pragma unroll 8
        for (int i = 0; i < wd; ++i) v = v - R.row(cluster, c0 + i)[j] * vec[c0 + i];
        vec[j] = v;
      }
      __syncthreads();
    }
    for (int j = tid; j < n; j += blockDim.x) s.dx[j] = vec[j];
  }
  cluster.sync();  // no block leaves while block 0 reads its rows
}

// Blocks of the reduced system's cluster by default: a power of two, a block
// per 24 rows or so: at 384 rows 16 blocks took 0.44-0.50 ms, 8 took
// 0.51-0.54 and 4 0.58-0.62 on an NVIDIA H100 80GB HBM3 at 700.00 W
// (PERF.md).
inline int cholesky_blocks(int n) {
  int blocks = 1;
  while (2 * blocks <= kMaxCluster && 2 * blocks <= (n + 24) / 24) blocks *= 2;
  return blocks;
}

// Shared memory of a block: the panel's factor, the back substitution's
// vector and reciprocals, and where they fit (in_shared) the panel buffer
// and its rows.
inline size_t cholesky_shared_bytes(int n, int blocks, bool in_shared) {
  const size_t rows = (size_t)(n + 1 + blocks - 1) / blocks * n;
  return sizeof(float) * (32 * 33 + 2 * n + (in_shared ? (size_t)kPanel * (n + 1) + rows : 0));
}

// Launches cholesky_kernel as one cluster of `blocks` (a power of two up to
// kMaxCluster; 0: cholesky_blocks(n)).
inline cudaError_t launch_cholesky(const System& sys, int blocks, cudaStream_t s) {
  if (blocks == 0) blocks = cholesky_blocks(sys.n);
  if (sys.n <= 0 || blocks < 1 || blocks > kMaxCluster || (blocks & (blocks - 1)))
    return cudaErrorInvalidValue;
  const bool in_shared = cholesky_shared_bytes(sys.n, blocks, true) <= kMaxShared;
  const size_t bytes = cholesky_shared_bytes(sys.n, blocks, in_shared);
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  static int configured = -1;  // the device on which the kernel may take kMaxShared
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    err = cudaFuncSetAttribute(cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cholesky_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) configured = device;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, 1, 1);
  config.blockDim = dim3(kCholThreads, 1, 1);
  config.dynamicSmemBytes = bytes;
  config.stream = s;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = blocks;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, cholesky_kernel, sys, (int)in_shared);
}

}  // namespace
}  // namespace schur
