// K23 icp_nearest and K24 icp_kabsch, icp_stats
//
// K23 replaces: cartographer_tpu/ops/icp.py:_correspondences (l.44) with
// _pairwise_sq_dist (l.36). K24 replaces the body of icp_match's round
// (l.62-80) with _rotation_matrix_to_quat (l.94), and its closing pass
// (l.82-89) as icp_stats.
//
// K23: one thread per source point. It transforms the point by the pose
// that lives on the device ([t, q], 7 floats; the rotation written out one
// operation at a time as the twin's quat.rotate_expanded), then walks the
// target cloud in shared-memory tiles of x, y, z, |b|^2 and the mask. Each
// distance is the reference's form, d2 = (|a|^2 + |b|^2) - 2 (a0 b0 + a1 b1
// + a2 b2), each sum left to right; a masked target counts as +inf; the
// first minimum wins (a strict <), as jnp.argmin. It writes the index, the
// transformed point and valid = mask & d2 <= max_dist^2 & isfinite(d2).
// Bound: operations. At 32,768 x 32,768 points a call evaluates 1.07 G
// pairs of about 10 float operations: about 0.16 ms at the card's float32
// rate; the clouds are 0.4 MB each and stay in L2.
//
// K24: one block. Pass 1 sums the weights (valid), the weighted world
// points and the weighted matched targets; pass 2 sums H = sum over points
// of ((world - mu_s) w) (matched - mu_t)^T. Each of those 16 sums is the
// plain twin's pairwise halving tree over the points padded to a power of
// two: each thread folds its points k + j * 1,024 in that tree's order
// (halving_fold.cuh), then the block's tree of 1,024 runs in shared
// memory. Thread 0 then takes the 3x3 SVD H = U S V^T by one-sided Jacobi
// sweeps in double precision, sorts the singular values descending,
// completes U where H has rank 2 (u3 = u1 x u2), and forms R = V diag(1, 1,
// sign(det(V U^T))) U^T (sign 0 at a zero determinant, as jnp.sign), then
// in float32 in JAX's order t = mu_t - R mu_s, the quaternion of R (four
// candidates, the first largest), and the left composition delta * pose,
// written back to the pose buffer. Bound: bytes, 32,768 x 33 bytes read
// twice; the block's dependent passes make it latency-bound.
//
// icp_stats: one block; fitness = sum(valid) / max(sum(mask), 1) and
// rmse = sqrt(sum over valid of |world - target[nn]|^2 / max(sum(valid), 1)),
// the direct squared distance (not K23's d2), summed in the same tree.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "halving_fold.cuh"

namespace {

constexpr int kNearestThreads = 128;
constexpr int kTile = 1024;  // targets per shared-memory tile
constexpr int kBlock = 1024;  // K24's threads and the shared tile of its sums

// v + qw t + cross(qv, t) with t = 2 cross(qv, v), one operation at a time.
__device__ inline void rotate(const float* q, const float v[3], float out[3]) {
  float t0 = 2.0f * (q[2] * v[2] - q[3] * v[1]);
  float t1 = 2.0f * (q[3] * v[0] - q[1] * v[2]);
  float t2 = 2.0f * (q[1] * v[1] - q[2] * v[0]);
  out[0] = (v[0] + q[0] * t0) + (q[2] * t2 - q[3] * t1);
  out[1] = (v[1] + q[0] * t1) + (q[3] * t0 - q[1] * t2);
  out[2] = (v[2] + q[0] * t2) + (q[1] * t1 - q[2] * t0);
}

__global__ void __launch_bounds__(kNearestThreads)
    nearest_kernel(const float* __restrict__ source, const uint8_t* __restrict__ source_mask,
                   int n, const float* __restrict__ target,
                   const uint8_t* __restrict__ target_mask, int m,
                   const float* __restrict__ pose, float max_d2, int* __restrict__ nn,
                   float* __restrict__ world, uint8_t* __restrict__ valid) {
  __shared__ float4 tile[kTile];
  __shared__ uint8_t tile_mask[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float a[3] = {0.0f, 0.0f, 0.0f};
  if (i < n) {
    const float p[3] = {source[3 * i], source[3 * i + 1], source[3 * i + 2]};
    rotate(pose + 3, p, a);
    for (int c = 0; c < 3; ++c) a[c] = a[c] + pose[c];
  }
  const float a2 = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2];
  float best = INFINITY;
  int best_index = 0;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const float* b = target + 3 * (size_t)(base + k);
      tile[k] = make_float4(b[0], b[1], b[2], (b[0] * b[0] + b[1] * b[1]) + b[2] * b[2]);
      tile_mask[k] = target_mask[base + k];
    }
    __syncthreads();
    for (int k = 0; k < count; ++k) {
      const float4 b = tile[k];
      const float cross = (a[0] * b.x + a[1] * b.y) + a[2] * b.z;
      const float d2 = tile_mask[k] ? (a2 + b.w) - 2.0f * cross : INFINITY;
      if (d2 < best) {
        best = d2;
        best_index = base + k;
      }
    }
  }
  if (i < n) {
    nn[i] = best_index;
    for (int c = 0; c < 3; ++c) world[3 * i + c] = a[c];
    valid[i] = source_mask[i] && best <= max_d2 && isfinite(best);
  }
}

// K sums of leaf(k) over k < padded (a power of two; entries at or above n
// are zero) in the halving tree; every thread of the block calls it and
// gets the K results.
template <int K, typename F>
__device__ inline halving::Lanes<K> block_tree_sums(int padded, float* shared, F leaf) {
  const int tile = min(padded, kBlock), m = padded / tile;
  for (int k = threadIdx.x; k < tile; k += blockDim.x) {
    const halving::Lanes<K> s =
        halving::fold_of<halving::Lanes<K>>(m, [&](int j) { return leaf(k + j * tile); });
    for (int c = 0; c < K; ++c) shared[c * kBlock + k] = s.v[c];
  }
  __syncthreads();
  for (int h = tile / 2; h > 0; h >>= 1) {
    for (int k = threadIdx.x; k < h; k += blockDim.x)
      for (int c = 0; c < K; ++c)
        shared[c * kBlock + k] = shared[c * kBlock + k] + shared[c * kBlock + k + h];
    __syncthreads();
  }
  halving::Lanes<K> out;
  for (int c = 0; c < K; ++c) out.v[c] = shared[c * kBlock];
  __syncthreads();
  return out;
}

// One-sided Jacobi SVD of the 3x3 a (row-major): a = U diag(s) V^T, s
// descending, U and V orthonormal (u3 = u1 x u2 where s3 vanishes).
__device__ void svd3(const double a_in[9], double U[9], double s[3], double V[9]) {
  double A[9], W[9];
  for (int k = 0; k < 9; ++k) {
    A[k] = a_in[k];
    W[k] = (k % 4 == 0) ? 1.0 : 0.0;
  }
  for (int sweep = 0; sweep < 30; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        double alpha = 0.0, beta = 0.0, gamma = 0.0;
        for (int r = 0; r < 3; ++r) {
          alpha += A[3 * r + p] * A[3 * r + p];
          beta += A[3 * r + q] * A[3 * r + q];
          gamma += A[3 * r + p] * A[3 * r + q];
        }
        if (gamma == 0.0) continue;
        off = fmax(off, fabs(gamma) / sqrt(fmax(alpha * beta, 1e-300)));
        double zeta = (beta - alpha) / (2.0 * gamma);
        double t = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        double c = 1.0 / sqrt(1.0 + t * t), sn = c * t;
        for (int r = 0; r < 3; ++r) {
          double ap = A[3 * r + p], aq = A[3 * r + q];
          A[3 * r + p] = c * ap - sn * aq;
          A[3 * r + q] = sn * ap + c * aq;
          double wp = W[3 * r + p], wq = W[3 * r + q];
          W[3 * r + p] = c * wp - sn * wq;
          W[3 * r + q] = sn * wp + c * wq;
        }
      }
    }
    if (off < 1e-15) break;
  }
  double norm[3];
  for (int c = 0; c < 3; ++c)
    norm[c] = sqrt(A[c] * A[c] + A[3 + c] * A[3 + c] + A[6 + c] * A[6 + c]);
  int order[3] = {0, 1, 2};
  for (int x = 0; x < 3; ++x)
    for (int y = x + 1; y < 3; ++y)
      if (norm[order[y]] > norm[order[x]]) {
        int tmp = order[x];
        order[x] = order[y];
        order[y] = tmp;
      }
  for (int c = 0; c < 3; ++c) {
    const int src = order[c];
    s[c] = norm[src];
    for (int r = 0; r < 3; ++r) {
      V[3 * r + c] = W[3 * r + src];
      U[3 * r + c] = norm[src] > 0.0 ? A[3 * r + src] / norm[src] : 0.0;
    }
  }
  const double tiny = 1e-12 * fmax(s[0], 1e-300);
  if (s[1] <= tiny) {  // rank <= 1: complete u2 orthogonal to u1
    double e[3] = {1.0, 0.0, 0.0};
    if (fabs(U[0]) > 0.6) e[0] = 0.0, e[1] = 1.0;
    double d = e[0] * U[0] + e[1] * U[3] + e[2] * U[6];
    double u[3] = {e[0] - d * U[0], e[1] - d * U[3], e[2] - d * U[6]};
    double nu = sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
    for (int r = 0; r < 3; ++r) U[3 * r + 1] = u[r] / nu;
  }
  if (s[2] <= tiny) {  // rank <= 2: u3 = u1 x u2
    U[2] = U[3] * U[7] - U[6] * U[4];
    U[5] = U[6] * U[1] - U[0] * U[7];
    U[8] = U[0] * U[4] - U[3] * U[1];
  }
}

__device__ inline double det3(const double M[9]) {
  return M[0] * (M[4] * M[8] - M[5] * M[7]) - M[1] * (M[3] * M[8] - M[5] * M[6]) +
         M[2] * (M[3] * M[7] - M[4] * M[6]);
}

// _rotation_matrix_to_quat in float32, in JAX's order; R row-major.
__device__ void rotation_to_quat(const float R[9], float q[4]) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = (m00 + m11) + m22;
  const float qw = sqrtf(fmaxf(1.0f + tr, 1e-12f)) / 2.0f;
  const float qx = sqrtf(fmaxf(((1.0f + m00) - m11) - m22, 1e-12f)) / 2.0f;
  const float qy = sqrtf(fmaxf(((1.0f - m00) + m11) - m22, 1e-12f)) / 2.0f;
  const float qz = sqrtf(fmaxf(((1.0f - m00) - m11) + m22, 1e-12f)) / 2.0f;
  int c = 0;
  float top = qw;
  if (qx > top) c = 1, top = qx;
  if (qy > top) c = 2, top = qy;
  if (qz > top) c = 3, top = qz;
  float r[4];
  if (c == 0) {
    r[0] = qw, r[1] = (m21 - m12) / (4.0f * qw), r[2] = (m02 - m20) / (4.0f * qw),
    r[3] = (m10 - m01) / (4.0f * qw);
  } else if (c == 1) {
    r[0] = (m21 - m12) / (4.0f * qx), r[1] = qx, r[2] = (m01 + m10) / (4.0f * qx),
    r[3] = (m02 + m20) / (4.0f * qx);
  } else if (c == 2) {
    r[0] = (m02 - m20) / (4.0f * qy), r[1] = (m01 + m10) / (4.0f * qy), r[2] = qy,
    r[3] = (m12 + m21) / (4.0f * qy);
  } else {
    r[0] = (m10 - m01) / (4.0f * qz), r[1] = (m02 + m20) / (4.0f * qz),
    r[2] = (m12 + m21) / (4.0f * qz), r[3] = qz;
  }
  const float norm = sqrtf(((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]) + r[3] * r[3]);
  for (int k = 0; k < 4; ++k) q[k] = r[k] / norm;
}

__global__ void __launch_bounds__(kBlock)
    kabsch_kernel(const float* __restrict__ world, const float* __restrict__ target,
                  const int* __restrict__ nn, const uint8_t* __restrict__ valid, int n,
                  int padded, float* __restrict__ pose, float* __restrict__ out_rt) {
  extern __shared__ float shared[];
  auto matched = [&](int k, int c) { return target[3 * (size_t)nn[k] + c]; };
  const halving::Lanes<7> first = block_tree_sums<7>(padded, shared, [&](int k) {
    halving::Lanes<7> r;
    const float w = k < n && valid[k] ? 1.0f : 0.0f;
    r.v[0] = w;
    for (int c = 0; c < 3; ++c) {
      r.v[1 + c] = k < n ? world[3 * k + c] * w : 0.0f;
      r.v[4 + c] = k < n ? matched(k, c) * w : 0.0f;
    }
    return r;
  });
  const float wsum = fmaxf(first.v[0], 1.0f);
  float mu_s[3], mu_t[3];
  for (int c = 0; c < 3; ++c) {
    mu_s[c] = first.v[1 + c] / wsum;
    mu_t[c] = first.v[4 + c] / wsum;
  }
  const halving::Lanes<9> h = block_tree_sums<9>(padded, shared, [&](int k) {
    halving::Lanes<9> r;
    if (k >= n) {
      for (int c = 0; c < 9; ++c) r.v[c] = 0.0f;
      return r;
    }
    const float w = valid[k] ? 1.0f : 0.0f;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        r.v[3 * a + b] = ((world[3 * k + a] - mu_s[a]) * w) * (matched(k, b) - mu_t[b]);
    return r;
  });
  if (threadIdx.x != 0) return;
  double H[9], U[9], S[3], V[9];
  for (int k = 0; k < 9; ++k) H[k] = h.v[k];
  svd3(H, U, S, V);
  double VUt[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      VUt[3 * a + b] = V[3 * a] * U[3 * b] + V[3 * a + 1] * U[3 * b + 1] +
                       V[3 * a + 2] * U[3 * b + 2];
  const double det = det3(VUt);
  const double d = det > 0.0 ? 1.0 : (det < 0.0 ? -1.0 : 0.0);
  float R[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      R[3 * a + b] = (float)(V[3 * a] * U[3 * b] + V[3 * a + 1] * U[3 * b + 1] +
                             d * V[3 * a + 2] * U[3 * b + 2]);
  float t[3];
  for (int a = 0; a < 3; ++a)
    t[a] = mu_t[a] - ((R[3 * a] * mu_s[0] + R[3 * a + 1] * mu_s[1]) + R[3 * a + 2] * mu_s[2]);
  float qd[4];
  rotation_to_quat(R, qd);
  // delta * pose: (rotate(q_delta, t_pose) + t_delta, normalize(q_delta q_pose)).
  float p[3] = {pose[0], pose[1], pose[2]}, rp[3];
  const float qp[4] = {pose[3], pose[4], pose[5], pose[6]};
  rotate(qd, p, rp);
  const float mq[4] = {
      ((qd[0] * qp[0] - qd[1] * qp[1]) - qd[2] * qp[2]) - qd[3] * qp[3],
      ((qd[0] * qp[1] + qd[1] * qp[0]) + qd[2] * qp[3]) - qd[3] * qp[2],
      ((qd[0] * qp[2] - qd[1] * qp[3]) + qd[2] * qp[0]) + qd[3] * qp[1],
      ((qd[0] * qp[3] + qd[1] * qp[2]) - qd[2] * qp[1]) + qd[3] * qp[0]};
  const float norm = sqrtf(((mq[0] * mq[0] + mq[1] * mq[1]) + mq[2] * mq[2]) + mq[3] * mq[3]);
  for (int a = 0; a < 3; ++a) pose[a] = rp[a] + t[a];
  for (int a = 0; a < 4; ++a) pose[3 + a] = mq[a] / norm;
  if (out_rt != nullptr) {
    for (int k = 0; k < 9; ++k) out_rt[k] = R[k];
    for (int a = 0; a < 3; ++a) out_rt[9 + a] = t[a];
  }
}

__global__ void __launch_bounds__(kBlock)
    stats_kernel(const float* __restrict__ world, const uint8_t* __restrict__ source_mask,
                 const float* __restrict__ target, const int* __restrict__ nn,
                 const uint8_t* __restrict__ valid, int n, int padded,
                 float* __restrict__ out) {
  extern __shared__ float shared[];
  const halving::Lanes<3> s = block_tree_sums<3>(padded, shared, [&](int k) {
    halving::Lanes<3> r = {{0.0f, 0.0f, 0.0f}};
    if (k < n) {
      float e[3];
      for (int c = 0; c < 3; ++c) {
        const float diff = world[3 * k + c] - target[3 * (size_t)nn[k] + c];
        e[c] = diff * diff;
      }
      r.v[0] = valid[k] ? (e[0] + e[1]) + e[2] : 0.0f;
      r.v[1] = valid[k] ? 1.0f : 0.0f;
      r.v[2] = source_mask[k] ? 1.0f : 0.0f;
    }
    return r;
  });
  if (threadIdx.x == 0) {
    out[0] = s.v[1] / fmaxf(s.v[2], 1.0f);           // fitness
    out[1] = sqrtf(s.v[0] / fmaxf(s.v[1], 1.0f));    // rmse
  }
}

int padded_count(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// K23: `pose` [t, q] (7,) on the device; outputs nn (n,) int32, world (n, 3)
// and valid (n,) uint8.
extern "C" int icp_nearest(const void* source, const void* source_mask, int n,
                           const void* target, const void* target_mask, int m, const void* pose,
                           float max_d2, void* nn, void* world, void* valid, void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  nearest_kernel<<<(n + kNearestThreads - 1) / kNearestThreads, kNearestThreads, 0,
                   (cudaStream_t)stream>>>(
      (const float*)source, (const uint8_t*)source_mask, n, (const float*)target,
      (const uint8_t*)target_mask, m, (const float*)pose, max_d2, (int*)nn, (float*)world,
      (uint8_t*)valid);
  return (int)cudaGetLastError();
}

// K24: one round's update of `pose` in place from K23's outputs; `out_rt`
// (nullable) receives R (row-major) and t, 12 floats.
extern "C" int icp_kabsch(const void* world, const void* target, const void* nn,
                          const void* valid, int n, void* pose, void* out_rt, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int padded = padded_count(n), threads = padded < kBlock ? padded : kBlock;
  const size_t bytes = 9 * kBlock * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kabsch_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kabsch_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      (const float*)world, (const float*)target, (const int*)nn, (const uint8_t*)valid, n,
      padded, (float*)pose, (float*)out_rt);
  return (int)cudaGetLastError();
}

// K24's closing form: out = [fitness, rmse].
extern "C" int icp_stats(const void* world, const void* source_mask, const void* target,
                         const void* nn, const void* valid, int n, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int padded = padded_count(n), threads = padded < kBlock ? padded : kBlock;
  stats_kernel<<<1, threads, 3 * kBlock * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)world, (const uint8_t*)source_mask, (const float*)target, (const int*)nn,
      (const uint8_t*)valid, n, padded, (float*)out);
  return (int)cudaGetLastError();
}
