// The one-block Levenberg-Marquardt solve on the SE(3) tangent shared by K27
// (gicp.cu, point-to-plane rows) and K29 (ndt.cu, whitened point-to-mean
// rows): ops/gauss_newton.py:lm_solve (l.22) with se3_retract
// (ops/scan_matcher_3d.py:45), without penalties or nonmonotonic steps, as
// K11 (scan_matcher_3d.cu) runs it.
//
// A model gives, for point k at the pose x = [t, q], its kRows residuals and
// (when asked) their gradients on the tangent [dt, so3], whose rotation acts
// on the right: d world / d so3 = -R(q) [p]x, so a row with world gradient n
// has the tangent gradient [n, p x (R^T n)], as jax.jacfwd takes it at
// delta = 0. Per iteration one pass sums J^T J (21 values) and J^T r (6);
// thread 0 damps the diagonal (lambda * max(diag, 1e-6)), solves the 6x6
// system by Gaussian elimination with partial pivoting and retracts (t +=
// dt, q = normalize(q * exp(so3))); a second pass sums the squares at the
// new pose; accept or reject, the lambda schedule (x 0.5 / x 4) and the
// function_tolerance exit follow lm_solve (l.72-127).
//
// Order of the sums: each thread adds its strided share of the points, a
// warp shuffle adds the 32 lanes, one thread adds the warps. The plain twins
// (ops/gauss_newton.py) form J^T J and J^T r as matrix products, which add
// in another order, so kernel and twin are held to 1e-4 m, 1e-4 rad and
// 1e-4 of the cost, as K11 is.
//
// Bound: latency. The solve is a chain of up to 2 x num_iterations dependent
// block-wide passes; one block of 512 threads holds the state in shared
// memory and runs the loop without returning to the host.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace se3lm {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // H upper triangle (21), g (6), sum of squares

// v + qw t + cross(qv, t) with t = 2 cross(qv, v), one operation at a time,
// as the port's quat.rotate_expanded.
__device__ inline void rotate(const float* q, const float v[3], float out[3]) {
  const float t0 = 2.0f * (q[2] * v[2] - q[3] * v[1]);
  const float t1 = 2.0f * (q[3] * v[0] - q[1] * v[2]);
  const float t2 = 2.0f * (q[1] * v[1] - q[2] * v[0]);
  out[0] = (v[0] + q[0] * t0) + (q[2] * t2 - q[3] * t1);
  out[1] = (v[1] + q[0] * t1) + (q[3] * t0 - q[1] * t2);
  out[2] = (v[2] + q[0] * t2) + (q[1] * t1 - q[2] * t0);
}

// R(q) p + t for the pose x = [t, q].
__device__ inline void transform(const float x[7], const float p[3], float w[3]) {
  rotate(x + 3, p, w);
  for (int a = 0; a < 3; ++a) w[a] = w[a] + x[a];
}

// The tangent gradient [n, p x (R^T n)] of a row whose world gradient is n.
__device__ inline void tangent_gradient(const float x[7], const float p[3], const float n[3],
                                        float jac[6]) {
  const float qc[4] = {x[3], -x[4], -x[5], -x[6]};
  float b[3];
  rotate(qc, n, b);
  for (int a = 0; a < 3; ++a) jac[a] = n[a];
  jac[3] = p[1] * b[2] - p[2] * b[1];
  jac[4] = p[2] * b[0] - p[0] * b[2];
  jac[5] = p[0] * b[1] - p[1] * b[0];
}

__device__ inline void quat_multiply(const float a[4], const float b[4], float out[4]) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// x_new = [t + d[0:3], normalize(q * exp(d[3:6]))].
__device__ inline void retract(const float x[7], const float d[6], float x_new[7]) {
  for (int a = 0; a < 3; ++a) x_new[a] = x[a] + d[a];
  const float angle_sq = d[3] * d[3] + d[4] * d[4] + d[5] * d[5];
  const float angle = sqrtf(fmaxf(angle_sq, 1e-32f));
  const float half = 0.5f * angle;
  const bool small = angle_sq < 1e-12f;
  const float k = small ? 0.5f - angle_sq / 48.0f : sinf(half) / angle;
  const float e[4] = {small ? 1.0f - angle_sq / 8.0f : cosf(half), k * d[3], k * d[4], k * d[5]};
  float q[4];
  quat_multiply(x + 3, e, q);
  const float norm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int a = 0; a < 4; ++a) x_new[3 + a] = q[a] / norm;
}

// Block-wide sum of v[0..count); the result is in out[] for every thread.
__device__ inline void block_sum(float* v, int count, float (*scratch)[kSums], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = 0; q < count; ++q) {
    float a = v[q];
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) scratch[warp][q] = a;
  }
  __syncthreads();
  if (threadIdx.x < count) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += scratch[w][threadIdx.x];
    out[threadIdx.x] = a;
  }
  __syncthreads();
}

// Solve A d = b (6 x 6) by Gaussian elimination with partial pivoting.
__device__ inline void solve6(float a[6][6], float b[6], float d[6]) {
  for (int col = 0; col < 6; ++col) {
    int piv = col;
    for (int r = col + 1; r < 6; ++r)
      if (fabsf(a[r][col]) > fabsf(a[piv][col])) piv = r;
    if (piv != col) {
      for (int c = 0; c < 6; ++c) {
        const float t = a[col][c];
        a[col][c] = a[piv][c];
        a[piv][c] = t;
      }
      const float t = b[col];
      b[col] = b[piv];
      b[piv] = t;
    }
    for (int r = col + 1; r < 6; ++r) {
      const float f = a[r][col] / a[col][col];
      for (int c = col; c < 6; ++c) a[r][c] = a[r][c] - f * a[col][c];
      b[r] = b[r] - f * b[col];
    }
  }
  for (int r = 5; r >= 0; --r) {
    float acc = b[r];
    for (int c = r + 1; c < 6; ++c) acc = acc - a[r][c] * d[c];
    d[r] = acc / a[r][r];
  }
}

template <class Model>
__device__ float sum_of_squares(const Model& m, const float x[7]) {
  float acc = 0.0f;
  for (int k = threadIdx.x; k < m.n; k += blockDim.x) {
    float r[Model::kRows], jac[Model::kRows][6];
    m.rows(x, k, r, jac, false);
    for (int a = 0; a < Model::kRows; ++a) acc += r[a] * r[a];
  }
  return acc;
}

// The whole solve from x0 = [t, q] (7 floats in device memory); writes the
// pose to x_out (which may be x0: it is read before any write), and the
// final cost and the iterations run to the nullable cost_out and
// iterations_out. Launch with one block of kThreads threads.
template <class Model>
__device__ void solve(const Model& m, const float* x0, int num_iterations,
                      float function_tolerance, float* x_out, float* cost_out,
                      int* iterations_out) {
  __shared__ float scratch[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float x[7], x_new[7];
  __shared__ float lam, current;
  __shared__ int it, stop, finite_delta;

  if (threadIdx.x == 0) {
    for (int q = 0; q < 7; ++q) x[q] = x0[q];
    lam = 1e-4f;
    it = 0;
    stop = 0;
  }
  __syncthreads();
  {
    float xl[7];
    for (int q = 0; q < 7; ++q) xl[q] = x[q];
    float acc = sum_of_squares(m, xl);
    block_sum(&acc, 1, scratch, sums);
    if (threadIdx.x == 0) current = 0.5f * sums[0];
  }
  __syncthreads();

  while (!stop && it < num_iterations) {
    // Pass A: the normal equations at x.
    float xl[7];
    for (int q = 0; q < 7; ++q) xl[q] = x[q];
    float acc[kSums - 1];
    for (int q = 0; q < kSums - 1; ++q) acc[q] = 0.0f;
    for (int k = threadIdx.x; k < m.n; k += blockDim.x) {
      float r[Model::kRows], jac[Model::kRows][6];
      m.rows(xl, k, r, jac, true);
      for (int row = 0; row < Model::kRows; ++row) {
        int q = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = a; b < 6; ++b) acc[q++] += jac[row][a] * jac[row][b];
        for (int a = 0; a < 6; ++a) acc[21 + a] += jac[row][a] * r[row];
      }
    }
    block_sum(acc, kSums - 1, scratch, sums);
    if (threadIdx.x == 0) {
      float h[6][6], rhs[6], d[6];
      int q = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b) {
          h[a][b] = h[b][a] = sums[q];
          ++q;
        }
      for (int a = 0; a < 6; ++a) rhs[a] = -sums[21 + a];
      for (int a = 0; a < 6; ++a) h[a][a] = h[a][a] + lam * fmaxf(h[a][a], 1e-6f);
      solve6(h, rhs, d);
      int finite = 1;
      for (int a = 0; a < 6; ++a) finite = finite && isfinite(d[a]);
      finite_delta = finite;
      float xn[7];
      retract(xl, d, xn);
      for (int a = 0; a < 7; ++a) x_new[a] = xn[a];
    }
    __syncthreads();

    // Pass B: the cost at the retracted pose.
    float xn[7];
    for (int q = 0; q < 7; ++q) xn[q] = x_new[q];
    float sq = sum_of_squares(m, xn);
    block_sum(&sq, 1, scratch, sums);
    if (threadIdx.x == 0) {
      const float new_cost = 0.5f * sums[0];
      const bool finite = finite_delta && isfinite(new_cost);
      const bool improved = new_cost < current && finite;
      const float improvement = improved ? (current - new_cost) / fmaxf(current, 1e-30f) : 1.0f;
      lam = improved ? lam * 0.5f : lam * 4.0f;
      if (improved) {
        for (int q = 0; q < 7; ++q) x[q] = xn[q];
        current = new_cost;
      }
      it = it + 1;
      stop = improved && improvement < function_tolerance && improvement >= 0.0f;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    for (int q = 0; q < 7; ++q) x_out[q] = x[q];
    if (cost_out != nullptr) cost_out[0] = current;
    if (iterations_out != nullptr) iterations_out[0] = it;
  }
}

}  // namespace se3lm
