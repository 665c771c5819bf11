// K11 scan_matcher_3d
//
// Replaces: cartographer_tpu/ops/scan_matcher_3d.py:gauss_newton_match_3d
// (l.61) with _occupied_residuals (l.53) and se3_retract (l.45),
// ops/interp.py:interp_trilinear (l.80) and ops/gauss_newton.py:lm_solve
// (l.22).
//
// The whole Levenberg-Marquardt solve on the SE(3) tangent [dt, so3] (or
// [dt, yaw]) is one launch of one block: per iteration one pass over the
// high- and the low-resolution cloud computes the residuals
// w / sqrt(n) * (1 - P(T p)), their analytic Jacobian, J^T J (21 values),
// J^T r (6) and the cost at the pose; thread 0 adds the translation and
// rotation penalties, damps the diagonal, solves the 6x6 (4x4) system with
// partial pivoting and retracts (t += dt, q = normalize(q * exp(so3))); a
// second pass computes the cost at the new pose; accept/reject, the lambda
// schedule, use_nonmonotonic_steps and the function_tolerance exit follow
// lm_solve (l.72-127).
//
// P is the trilinear interpolation of the grid's probability, with the
// corner indices clamped to the border. The probability is computed from
// the log-odds and known flags of the 8 gathered corners
// (1 / (1 + exp(-l)), or 0.1 where unknown): no probability volume is made.
// The rotation acts on the right, so d world / d so3 = -R(q) [p]x, and the
// rotation penalty log(conj(q_target) q) has the inverse right Jacobian of
// SO(3); JAX takes both with jacfwd at delta = 0.
//
// Bound: latency. 1,536 points with 8 corners each from two grids is a few
// hundred KB; the solve is a chain of up to 25 dependent block-wide passes.
// Design: one block of 256 threads holds the state in shared memory and
// runs the loop without returning to the host.
//
// Order of the sums: each thread adds its strided share of the points, a
// warp shuffle adds the 32 lanes, one thread adds the 8 warps. The plain
// twin (ops/scan_matcher_3d.py:_match_plain) forms J^T J and J^T r as matrix
// products, which add in another order, so kernel and twin are not bit-equal:
// they are held to 1e-4 m, 1e-4 rad and 1e-4 of the cost.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // H upper triangle (21), g (6), sum of squares

struct Grid {
  const float* log_odds;
  const uint8_t* known;
  const float* origin;  // (3,) world position of the corner of cell (0, 0, 0)
  float resolution;
  int size;
};

struct Cloud {
  const float* points;
  const uint8_t* mask;
  int n;
  float scale;  // occupied_space_weight / sqrt(number of valid points)
};

__device__ inline float probability(const Grid& g, int i, int j, int k) {
  size_t idx = ((size_t)i * g.size + j) * g.size + k;
  return g.known[idx] ? 1.0f / (1.0f + expf(-g.log_odds[idx])) : 0.1f;
}

__device__ inline void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// v + qw * t + cross(qv, t) with t = 2 cross(qv, v).
__device__ inline void rotate(const float q[4], const float v[3], float out[3]) {
  float t[3], u[3];
  cross3(q + 1, v, t);
  for (int a = 0; a < 3; ++a) t[a] = 2.0f * t[a];
  cross3(q + 1, t, u);
  for (int a = 0; a < 3; ++a) out[a] = (v[a] + q[0] * t[a]) + u[a];
}

__device__ inline void quat_multiply(const float a[4], const float b[4], float out[4]) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// Residual of point k of `cloud` at pose x = [t, q] and, when jac != nullptr,
// its gradient on the tangent [dt, so3].
__device__ inline float residual(const Grid& g, const Cloud& cloud, const float x[7], int k,
                                 float* jac) {
  if (!cloud.mask[k]) {
    if (jac)
      for (int a = 0; a < 6; ++a) jac[a] = 0.0f;
    return 0.0f;
  }
  const float* q = x + 3;
  float p[3] = {cloud.points[3 * k], cloud.points[3 * k + 1], cloud.points[3 * k + 2]};
  float rot[3];
  rotate(q, p, rot);
  int base[3];
  float w[3][2];
  for (int a = 0; a < 3; ++a) {
    float c = ((rot[a] + x[a]) - g.origin[a]) / g.resolution - 0.5f;
    float b = floorf(c);
    float f = c - b;
    base[a] = (int)b;
    w[a][0] = 1.0f - f;
    w[a][1] = f;
  }
  float val = 0.0f, grad[3] = {0.0f, 0.0f, 0.0f};
  for (int di = 0; di < 2; ++di) {
    int ii = min(max(base[0] + di, 0), g.size - 1);
    for (int dj = 0; dj < 2; ++dj) {
      int jj = min(max(base[1] + dj, 0), g.size - 1);
      for (int dk = 0; dk < 2; ++dk) {
        int kk = min(max(base[2] + dk, 0), g.size - 1);
        float c = probability(g, ii, jj, kk);
        val = val + w[0][di] * w[1][dj] * w[2][dk] * c;
        float si = di ? 1.0f : -1.0f, sj = dj ? 1.0f : -1.0f, sk = dk ? 1.0f : -1.0f;
        grad[0] = grad[0] + si * (w[1][dj] * w[2][dk]) * c;
        grad[1] = grad[1] + sj * (w[0][di] * w[2][dk]) * c;
        grad[2] = grad[2] + sk * (w[0][di] * w[1][dj]) * c;
      }
    }
  }
  if (jac) {
    float gw[3], gb[3];
    for (int a = 0; a < 3; ++a) gw[a] = -cloud.scale * (grad[a] / g.resolution);
    float qc[4] = {q[0], -q[1], -q[2], -q[3]};
    rotate(qc, gw, gb);
    for (int a = 0; a < 3; ++a) jac[a] = gw[a];
    cross3(p, gb, jac + 3);
  }
  return cloud.scale * (1.0f - val);
}

// Block-wide sum of v[0..count); the result is valid in every thread.
__device__ void block_sum(float* v, int count, float (*scratch)[kSums], float* out) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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

// Solve A d = b (n <= 6) by Gaussian elimination with partial pivoting.
__device__ void solve(float a[6][6], float b[6], float d[6], int n) {
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (fabsf(a[r][col]) > fabsf(a[piv][col])) piv = r;
    if (piv != col) {
      for (int c = 0; c < n; ++c) {
        float t = a[col][c];
        a[col][c] = a[piv][c];
        a[piv][c] = t;
      }
      float t = b[col];
      b[col] = b[piv];
      b[piv] = t;
    }
    for (int r = col + 1; r < n; ++r) {
      float f = a[r][col] / a[col][col];
      for (int c = col; c < n; ++c) a[r][c] = a[r][c] - f * a[col][c];
      b[r] = b[r] - f * b[col];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    float acc = b[r];
    for (int c = r + 1; c < n; ++c) acc = acc - a[r][c] * d[c];
    d[r] = acc / a[r][r];
  }
}

struct Penalty {
  float target_t[3];
  float target_q[4];
  float wt, wr;
};

// Axis-angle vector of conj(target_q) * q, angle in [0, pi].
__device__ inline void rotation_error(const Penalty& pen, const float q[4], float phi[3]) {
  float qc[4] = {pen.target_q[0], -pen.target_q[1], -pen.target_q[2], -pen.target_q[3]};
  float dq[4];
  quat_multiply(qc, q, dq);
  if (dq[0] < 0.0f)
    for (int a = 0; a < 4; ++a) dq[a] = -dq[a];
  float w = fminf(fmaxf(dq[0], -1.0f), 1.0f);
  float vnorm_sq = dq[1] * dq[1] + dq[2] * dq[2] + dq[3] * dq[3];
  float vnorm = sqrtf(fmaxf(vnorm_sq, 1e-32f));
  float scale = vnorm_sq < 1e-12f ? 2.0f / fmaxf(w, 1e-12f) : 2.0f * atan2f(vnorm, w) / vnorm;
  for (int a = 0; a < 3; ++a) phi[a] = scale * dq[a + 1];
}

__device__ inline float penalty_sq(const Penalty& pen, const float x[7]) {
  float phi[3];
  rotation_error(pen, x + 3, phi);
  float acc = 0.0f;
  for (int a = 0; a < 3; ++a) {
    float rt = pen.wt * (x[a] - pen.target_t[a]);
    float rr = pen.wr * phi[a];
    acc += rt * rt + rr * rr;
  }
  return acc;
}

// I + [phi]x / 2 + c [phi]x^2: the inverse right Jacobian of SO(3).
__device__ inline void inverse_right_jacobian(const float phi[3], float m[3][3]) {
  float theta_sq = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float theta = sqrtf(fmaxf(theta_sq, 1e-12f));
  float half = 0.5f * theta;
  float c = theta_sq < 1e-6f
                ? 1.0f / 12.0f
                : 1.0f / fmaxf(theta_sq, 1e-12f) -
                      cosf(half) / (2.0f * theta * fmaxf(sinf(half), 1e-12f));
  float k[3][3] = {{0.0f, -phi[2], phi[1]}, {phi[2], 0.0f, -phi[0]}, {-phi[1], phi[0], 0.0f}};
  for (int r = 0; r < 3; ++r)
    for (int col = 0; col < 3; ++col) {
      float kk = 0.0f;
      for (int i = 0; i < 3; ++i) kk += k[r][i] * k[i][col];
      m[r][col] = (r == col ? 1.0f : 0.0f) + 0.5f * k[r][col] + c * kk;
    }
}

// x_new = [t + d[0:3], normalize(q * exp(d[3:6]))].
__device__ inline void retract(const float x[7], const float d[6], float x_new[7]) {
  for (int a = 0; a < 3; ++a) x_new[a] = x[a] + d[a];
  float angle_sq = d[3] * d[3] + d[4] * d[4] + d[5] * d[5];
  float angle = sqrtf(fmaxf(angle_sq, 1e-32f));
  float half = 0.5f * angle;
  bool small = angle_sq < 1e-12f;
  float k = small ? 0.5f - angle_sq / 48.0f : sinf(half) / angle;
  float e[4] = {small ? 1.0f - angle_sq / 8.0f : cosf(half), k * d[3], k * d[4], k * d[5]};
  float q[4];
  quat_multiply(x + 3, e, q);
  float norm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int a = 0; a < 4; ++a) x_new[3 + a] = q[a] / norm;
}

__device__ float sum_of_squares(const Grid& hg, const Cloud& hc, const Grid& lg,
                                const Cloud& lc, const float x[7]) {
  float acc = 0.0f;
  for (int k = threadIdx.x; k < hc.n; k += blockDim.x) {
    float r = residual(hg, hc, x, k, nullptr);
    acc += r * r;
  }
  for (int k = threadIdx.x; k < lc.n; k += blockDim.x) {
    float r = residual(lg, lc, x, k, nullptr);
    acc += r * r;
  }
  return acc;
}

__device__ inline void accumulate(float* acc, const float j[6], float r) {
  int q = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) acc[q++] += j[a] * j[b];
  for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * r;
  acc[27] += r * r;
}

__global__ void scan_matcher_3d_kernel(Grid hg, Cloud hc, Grid lg, Cloud lc,
                                       const float* __restrict__ x0,
                                       const float* __restrict__ target_t, float wt, float wr,
                                       int yaw_only, int num_iterations, int nonmonotonic,
                                       float function_tolerance, float* __restrict__ x_out,
                                       float* __restrict__ cost_out,
                                       int* __restrict__ iterations_out) {
  __shared__ float scratch[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float x[7], x_new[7], best_x[7];
  __shared__ float lam, current, best_cost;
  __shared__ int it, stop, finite_delta;

  // n = max(number of valid points, 1) of each cloud, counted once.
  float cnt[2] = {0.0f, 0.0f};
  for (int k = threadIdx.x; k < hc.n; k += blockDim.x) cnt[0] += hc.mask[k] ? 1.0f : 0.0f;
  for (int k = threadIdx.x; k < lc.n; k += blockDim.x) cnt[1] += lc.mask[k] ? 1.0f : 0.0f;
  block_sum(cnt, 2, scratch, sums);
  hc.scale = hc.scale / sqrtf(fmaxf(sums[0], 1.0f));
  lc.scale = lc.scale / sqrtf(fmaxf(sums[1], 1.0f));
  __syncthreads();
  Penalty pen;
  for (int a = 0; a < 3; ++a) pen.target_t[a] = target_t[a];
  for (int a = 0; a < 4; ++a) pen.target_q[a] = x0[3 + a];
  pen.wt = wt;
  pen.wr = wr;

  if (threadIdx.x == 0) {
    for (int q = 0; q < 7; ++q) x[q] = best_x[q] = x0[q];
    lam = 1e-4f;
    it = 0;
    stop = 0;
  }
  __syncthreads();

  // Initial cost.
  {
    float xl[7];
    for (int q = 0; q < 7; ++q) xl[q] = x[q];
    float acc = sum_of_squares(hg, hc, lg, lc, xl);
    block_sum(&acc, 1, scratch, sums);
    if (threadIdx.x == 0) current = best_cost = 0.5f * (sums[0] + penalty_sq(pen, xl));
  }
  __syncthreads();

  const int dim = yaw_only ? 4 : 6;
  while (!stop && it < num_iterations) {
    // Pass A: normal equations at x.
    float xl[7];
    for (int q = 0; q < 7; ++q) xl[q] = x[q];
    float acc[kSums];
    for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
    for (int k = threadIdx.x; k < hc.n; k += blockDim.x) {
      float j[6];
      float r = residual(hg, hc, xl, k, j);
      accumulate(acc, j, r);
    }
    for (int k = threadIdx.x; k < lc.n; k += blockDim.x) {
      float j[6];
      float r = residual(lg, lc, xl, k, j);
      accumulate(acc, j, r);
    }
    block_sum(acc, 27, scratch, sums);
    if (threadIdx.x == 0) {
      float h6[6][6], g6[6];
      int q = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b) {
          h6[a][b] = h6[b][a] = sums[q];
          ++q;
        }
      for (int a = 0; a < 6; ++a) g6[a] = sums[21 + a];
      // Penalty rows: r_t = wt (t - target), r_r = wr log(conj(q_target) q).
      float phi[3], m[3][3];
      rotation_error(pen, xl + 3, phi);
      inverse_right_jacobian(phi, m);
      for (int a = 0; a < 3; ++a) {
        h6[a][a] = h6[a][a] + wt * wt;
        g6[a] = g6[a] + wt * (wt * (xl[a] - pen.target_t[a]));
        for (int b = 0; b < 3; ++b) {
          float hh = 0.0f;
          for (int r = 0; r < 3; ++r) hh += (wr * m[r][a]) * (wr * m[r][b]);
          h6[3 + a][3 + b] = h6[3 + a][3 + b] + hh;
        }
        float gg = 0.0f;
        for (int r = 0; r < 3; ++r) gg += (wr * m[r][a]) * (wr * phi[r]);
        g6[3 + a] = g6[3 + a] + gg;
      }
      // The tangent's columns: all six, or [dt, yaw].
      const int cols[6] = {0, 1, 2, yaw_only ? 5 : 3, 4, 5};
      float h[6][6], rhs[6], d[6];
      for (int a = 0; a < dim; ++a) {
        for (int b = 0; b < dim; ++b) h[a][b] = h6[cols[a]][cols[b]];
        rhs[a] = -g6[cols[a]];
      }
      for (int a = 0; a < dim; ++a) h[a][a] = h[a][a] + lam * fmaxf(h[a][a], 1e-6f);
      solve(h, rhs, d, dim);
      int finite = 1;
      float d6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int a = 0; a < dim; ++a) {
        finite = finite && isfinite(d[a]);
        d6[cols[a]] = d[a];
      }
      finite_delta = finite;
      float xn[7];
      retract(xl, d6, xn);
      for (int q2 = 0; q2 < 7; ++q2) x_new[q2] = xn[q2];
    }
    __syncthreads();

    // Pass B: cost at the retracted pose.
    float xn[7];
    for (int q = 0; q < 7; ++q) xn[q] = x_new[q];
    float sq = sum_of_squares(hg, hc, lg, lc, xn);
    block_sum(&sq, 1, scratch, sums);
    if (threadIdx.x == 0) {
      float new_cost = 0.5f * (sums[0] + penalty_sq(pen, xn));
      bool finite = finite_delta && isfinite(new_cost);
      bool improved = new_cost < current && finite;
      bool accept = nonmonotonic ? finite : improved;
      float improvement = improved ? (current - new_cost) / fmaxf(current, 1e-30f) : 1.0f;
      lam = improved ? lam * 0.5f : lam * 4.0f;
      if (accept) {
        for (int q = 0; q < 7; ++q) x[q] = xn[q];
        current = new_cost;
      }
      if (finite && new_cost < best_cost) {
        for (int q = 0; q < 7; ++q) best_x[q] = xn[q];
        best_cost = new_cost;
      }
      it = it + 1;
      stop = accept && improvement < function_tolerance && improvement >= 0.0f;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    for (int q = 0; q < 7; ++q) x_out[q] = nonmonotonic ? best_x[q] : x[q];
    cost_out[0] = nonmonotonic ? best_cost : current;
    iterations_out[0] = it;
  }
}

Grid make_grid(const void* log_odds, const void* known, const void* origin, float resolution,
               int size) {
  Grid g;
  g.log_odds = (const float*)log_odds;
  g.known = (const uint8_t*)known;
  g.origin = (const float*)origin;
  g.resolution = resolution;
  g.size = size;
  return g;
}

Cloud make_cloud(const void* points, const void* mask, int n, float weight) {
  Cloud c;
  c.points = (const float*)points;
  c.mask = (const uint8_t*)mask;
  c.n = n;
  c.scale = weight;
  return c;
}

}  // namespace

extern "C" int scan_matcher_3d(
    const void* high_log_odds, const void* high_known, const void* high_origin,
    float high_resolution, int high_size, const void* high_points, const void* high_mask,
    int num_high, const void* low_log_odds, const void* low_known, const void* low_origin,
    float low_resolution, int low_size, const void* low_points, const void* low_mask,
    int num_low, const void* x0, const void* target_t, float occupied_space_weight_0,
    float occupied_space_weight_1, float translation_weight, float rotation_weight,
    int only_optimize_yaw, int num_iterations, int nonmonotonic, float function_tolerance,
    void* x_out, void* cost_out, void* iterations_out, void* stream) {
  Grid hg = make_grid(high_log_odds, high_known, high_origin, high_resolution, high_size);
  Grid lg = make_grid(low_log_odds, low_known, low_origin, low_resolution, low_size);
  Cloud hc = make_cloud(high_points, high_mask, num_high, occupied_space_weight_0);
  Cloud lc = make_cloud(low_points, low_mask, num_low, occupied_space_weight_1);
  scan_matcher_3d_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      hg, hc, lg, lc, (const float*)x0, (const float*)target_t, translation_weight,
      rotation_weight, only_optimize_yaw, num_iterations, nonmonotonic, function_tolerance,
      (float*)x_out, (float*)cost_out, (int*)iterations_out);
  return (int)cudaGetLastError();
}
