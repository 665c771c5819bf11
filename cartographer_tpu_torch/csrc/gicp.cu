// K26 icp_normals and K27 gicp_lm
//
// K26 replaces: cartographer_tpu/ops/icp.py:estimate_normals (l.118) with
// _pairwise_sq_dist (l.36). K27 replaces gicp_match's inner lm_solve
// (l.150-156; ops/gauss_newton.py:22, se3_retract in
// ops/scan_matcher_3d.py:45).
//
// K26: one thread per point i of the cloud. It walks the cloud in
// shared-memory tiles of x, y, z, |b|^2 and the mask, as K23 (icp.cu) does,
// with the reference's distance d2 = (|a|^2 + |b|^2) - 2 (a0 b0 + a1 b1 +
// a2 b2), each sum left to right, and +inf for a masked column; it keeps
// the k smallest (d2, index) pairs in a sorted list in registers, the lower
// index first among equal distances, as lax.top_k(-d2) orders them. So the
// list does not assume the point itself comes first (the reference form
// can rank a neighbour below it), and where fewer than k columns are
// masked in, masked columns fill the list in index order. The list is
// first seeded from the columns within kSeed of i in index order (a scan's
// neighbours in azimuth), which the sweep then skips: the list is the k
// smallest of a total order whatever order the columns come in, and with a
// near-final list the sweep seldom inserts, so a warp seldom waits on the
// insertion of one of its threads. A masked-in point then takes the mean of its k neighbours (summed in list order,
// divided by k), their 3x3 covariance (sum over the list of the centered
// products, divided by k) in float32, and the eigenvector of its smallest
// eigenvalue by cyclic Jacobi rotations in double precision (one thread,
// as K24's svd3), its largest component (the first of equal ones) made
// positive: eigh's sign is LAPACK's choice, and GICP's J^T J and J^T r do
// not depend on it. Rows of masked points are written as zeros: no valid
// correspondence reads them. It writes the normals (n, 3) and the
// neighbour indices (n, k).
// Bound: operations. At 32,768 x 32,768 points a call evaluates 1.07 G
// pairs of about 10 float operations plus the list's compare: about 0.16 ms
// at the card's float32 rate; the cloud is 0.4 MB and stays in L2.
//
// K27: the whole <= 10-iteration LM of one outer GICP round in one launch
// (se3_lm.cuh), one row per source point: r = valid * ((R p + t) -
// target[nn]) . normal[nn] (each sum left to right), with the tangent
// gradient [n, p x (R^T n)]. It reads and writes the 7-float pose buffer
// [t, q] in place, so the rounds run with no host sync.
// Bound: latency (the LM's dependent block-wide passes); bytes per pass
// 32,768 x 29 (the point, its index, its flag, the matched point and
// normal), read from L2 after the first.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "se3_lm.cuh"

namespace {

constexpr int kNormalThreads = 128;
constexpr int kTile = 1024;  // points per shared-memory tile
constexpr int kMaxK = 16;    // the longest neighbour list kept in registers
constexpr int kSeed = 16;    // columns i - kSeed .. i + kSeed seed point i's list

// The pair (d, j) into the sorted list (bd, bi) of K, if it ranks above the
// last entry: (distance, index) ascending.
template <int K>
__device__ inline void insert(float (&bd)[K], int (&bi)[K], float d, int j) {
  if (!(d < bd[K - 1] || (d == bd[K - 1] && j < bi[K - 1]))) return;
  bd[K - 1] = d;
  bi[K - 1] = j;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (bd[s] < bd[s - 1] || (bd[s] == bd[s - 1] && bi[s] < bi[s - 1])) {
      const float td = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = td;
      const int ti = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ti;
    }
  }
}

// The unit eigenvector of the smallest eigenvalue of the symmetric 3x3 c
// (row-major) by cyclic Jacobi rotations in double precision, its largest
// component (the first of equal ones) made positive.
__device__ void smallest_eigenvector(const double c[9], double v[3]) {
  double a[3][3], V[3][3];
  for (int r = 0; r < 3; ++r)
    for (int s = 0; s < 3; ++s) {
      a[r][s] = c[3 * r + s];
      V[r][s] = r == s ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < 32; ++sweep) {
    const double off = fabs(a[0][1]) + fabs(a[0][2]) + fabs(a[1][2]);
    const double diag = fabs(a[0][0]) + fabs(a[1][1]) + fabs(a[2][2]);
    if (off <= 1e-18 * diag || off == 0.0) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        const double apq = a[p][q];
        if (apq == 0.0) continue;
        const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double cs = 1.0 / sqrt(t * t + 1.0), sn = t * cs;
        for (int r = 0; r < 3; ++r) {  // A <- A J
          const double arp = a[r][p], arq = a[r][q];
          a[r][p] = cs * arp - sn * arq;
          a[r][q] = sn * arp + cs * arq;
        }
        for (int r = 0; r < 3; ++r) {  // A <- J^T A
          const double apr = a[p][r], aqr = a[q][r];
          a[p][r] = cs * apr - sn * aqr;
          a[q][r] = sn * apr + cs * aqr;
        }
        a[p][q] = a[q][p] = 0.0;
        for (int r = 0; r < 3; ++r) {  // V <- V J
          const double vrp = V[r][p], vrq = V[r][q];
          V[r][p] = cs * vrp - sn * vrq;
          V[r][q] = sn * vrp + cs * vrq;
        }
      }
    }
  }
  int m = 0;
  for (int s = 1; s < 3; ++s)
    if (a[s][s] < a[m][m]) m = s;
  int big = 0;
  for (int r = 1; r < 3; ++r)
    if (fabs(V[r][m]) > fabs(V[big][m])) big = r;
  const double sign = V[big][m] < 0.0 ? -1.0 : 1.0;
  for (int r = 0; r < 3; ++r) v[r] = sign * V[r][m];
}

template <int K>
__global__ void __launch_bounds__(kNormalThreads)
    normals_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask, int n,
                   float* __restrict__ normals, int* __restrict__ neighbours) {
  __shared__ float4 tile[kTile];
  __shared__ uint8_t tile_mask[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float a[3] = {0.0f, 0.0f, 0.0f};
  if (i < n)
    for (int c = 0; c < 3; ++c) a[c] = points[3 * i + c];
  const float a2 = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = INT_MAX;
  }
  const int lo = i < n ? max(0, i - kSeed) : 0, hi = i < n ? min(n, i + kSeed + 1) : 0;
  for (int j = lo; j < hi; ++j) {
    const float* b = points + 3 * (size_t)j;
    const float b2 = (b[0] * b[0] + b[1] * b[1]) + b[2] * b[2];
    const float cross = (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
    insert<K>(bd, bi, mask[j] ? (a2 + b2) - 2.0f * cross : INFINITY, j);
  }
  for (int base = 0; base < n; base += kTile) {
    const int count = min(kTile, n - base);
    __syncthreads();
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const float* b = points + 3 * (size_t)(base + k);
      tile[k] = make_float4(b[0], b[1], b[2], (b[0] * b[0] + b[1] * b[1]) + b[2] * b[2]);
      tile_mask[k] = mask[base + k];
    }
    __syncthreads();
    for (int k = 0; k < count; ++k) {
      const float4 b = tile[k];
      const float cross = (a[0] * b.x + a[1] * b.y) + a[2] * b.z;
      const float d2 = tile_mask[k] ? (a2 + b.w) - 2.0f * cross : INFINITY;
      const int j = base + k;
      if ((unsigned)(j - lo) >= (unsigned)(hi - lo)) insert<K>(bd, bi, d2, j);
    }
  }
  if (i >= n) return;
  for (int s = 0; s < K; ++s) neighbours[(size_t)i * K + s] = bi[s];
  if (!mask[i]) {
    for (int c = 0; c < 3; ++c) normals[3 * i + c] = 0.0f;
    return;
  }
  float mu[3];
  for (int c = 0; c < 3; ++c) mu[c] = points[3 * (size_t)bi[0] + c];
  for (int s = 1; s < K; ++s)
    for (int c = 0; c < 3; ++c) mu[c] = mu[c] + points[3 * (size_t)bi[s] + c];
  const float kf = (float)K;
  for (int c = 0; c < 3; ++c) mu[c] = mu[c] / kf;
  float cov[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // xx xy xz yy yz zz
  for (int s = 0; s < K; ++s) {
    float e[3];
    for (int c = 0; c < 3; ++c) e[c] = points[3 * (size_t)bi[s] + c] - mu[c];
    const float prod[6] = {e[0] * e[0], e[0] * e[1], e[0] * e[2],
                           e[1] * e[1], e[1] * e[2], e[2] * e[2]};
    for (int q = 0; q < 6; ++q) cov[q] = cov[q] + prod[q];
  }
  for (int q = 0; q < 6; ++q) cov[q] = cov[q] / kf;
  const double c9[9] = {cov[0], cov[1], cov[2], cov[1], cov[3], cov[4], cov[2], cov[4], cov[5]};
  double v[3];
  smallest_eigenvector(c9, v);
  for (int c = 0; c < 3; ++c) normals[3 * i + c] = (float)v[c];
}

template <int K>
cudaError_t launch_normals(const void* points, const void* mask, int n, void* normals,
                           void* neighbours, cudaStream_t stream) {
  normals_kernel<K><<<(n + kNormalThreads - 1) / kNormalThreads, kNormalThreads, 0, stream>>>(
      (const float*)points, (const uint8_t*)mask, n, (float*)normals, (int*)neighbours);
  return cudaGetLastError();
}

struct GicpRows {
  static constexpr int kRows = 1;
  const float* source;
  const float* target;
  const float* normals;
  const int* nn;
  const uint8_t* valid;
  int n;

  __device__ void rows(const float x[7], int k, float r[1], float jac[1][6], bool with_jac) const {
    r[0] = 0.0f;
    if (with_jac)
      for (int a = 0; a < 6; ++a) jac[0][a] = 0.0f;
    if (!valid[k]) return;
    const float p[3] = {source[3 * k], source[3 * k + 1], source[3 * k + 2]};
    float w[3];
    se3lm::transform(x, p, w);
    const size_t j = 3 * (size_t)nn[k];
    const float nv[3] = {normals[j], normals[j + 1], normals[j + 2]};
    r[0] = ((w[0] - target[j]) * nv[0] + (w[1] - target[j + 1]) * nv[1]) +
           (w[2] - target[j + 2]) * nv[2];
    if (with_jac) se3lm::tangent_gradient(x, p, nv, jac[0]);
  }
};

__global__ void __launch_bounds__(se3lm::kThreads)
    gicp_lm_kernel(GicpRows rows, const float* x0, int num_iterations, float function_tolerance,
                   float* x_out, float* cost_out, int* iterations_out) {
  se3lm::solve(rows, x0, num_iterations, function_tolerance, x_out, cost_out, iterations_out);
}

}  // namespace

// K26: normals (n, 3) float32 and neighbours (n, k) int32 of the cloud
// `points` (n, 3) with `mask` (n,) uint8; 1 <= k <= 16 and k <= n.
extern "C" int icp_normals(const void* points, const void* mask, int n, int k, void* normals,
                           void* neighbours, void* stream) {
  if (n < 1 || k < 1 || k > kMaxK || k > n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define CASE(K) \
  case K:       \
    return (int)launch_normals<K>(points, mask, n, normals, neighbours, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K27: the LM of one GICP round from the pose x0 [t, q] (7,) to x_out (may
// be x0); cost_out and iterations_out are nullable.
extern "C" int gicp_lm(const void* source, int n, const void* target, const void* normals,
                       const void* nn, const void* valid, const void* x0, void* x_out,
                       void* cost_out, void* iterations_out, int num_iterations,
                       float function_tolerance, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  GicpRows rows{(const float*)source, (const float*)target, (const float*)normals,
                (const int*)nn, (const uint8_t*)valid, n};
  gicp_lm_kernel<<<1, se3lm::kThreads, 0, (cudaStream_t)stream>>>(
      rows, (const float*)x0, num_iterations, function_tolerance, (float*)x_out,
      (float*)cost_out, (int*)iterations_out);
  return (int)cudaGetLastError();
}
