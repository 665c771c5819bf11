// K3 scan_matcher_2d
//
// Replaces: cartographer_tpu/ops/scan_matcher_2d.py:gauss_newton_match_2d
// (l.70) with occupied_space_residuals (l.38), ops/interp.py:interp_bicubic
// (l.31) and ops/gauss_newton.py:lm_solve (l.22).
//
// The whole Levenberg-Marquardt solve on (x, y, theta) is one launch of one
// block: per iteration one pass computes the residuals, the analytic
// Jacobian, J^T J (6 values), J^T r (3) and the cost at x, thread 0 solves
// the damped 3x3 system, and a second pass computes the cost at x + delta;
// accept/reject, the lambda schedule, use_nonmonotonic_steps and the
// function_tolerance exit follow lm_solve (l.72-127).
//
// Residual i = w / sqrt(n) * (1 - P(T p_i)) with P the border-clamped
// Catmull-Rom bicubic of the probability grid, plus the translation and
// rotation penalties. The probability is computed on the fly from the
// grid's log-odds and known flags (1 / (1 + exp(-l)), or 0.1 where unknown)
// for the 16 taps of each point: no probability grid is materialised. The
// derivative is Catmull-Rom's analytic one; the floored cell index carries
// no derivative, the fraction does, as under jax.jacfwd.
//
// Bound: latency. The data is small (512 points, 16 taps each from a 5 MB
// grid), and the solve is a chain of up to 41 dependent block-wide passes
// with a reduction and a barrier each. Design: one block of 256 threads
// holds the state in shared memory and runs the loop without returning to
// the host, so the early exit costs no synchronisation.
//
// Robots: one block per robot of a cross-robot batch (the JAX package's
// _batched_step_cached vmaps the solve over robots), each with its own
// grid, points, start pose, target and early exit. The robots' grids stay
// where their submaps keep them: a pointer table (surface values, flags,
// origin per robot) travels in the launch's parameters, so it needs no copy
// to the device; above kMaxRobots robots the entry point launches once per
// kMaxRobots. The points, masks, start poses and targets are robot 0's plus
// the robot times a robot stride in elements. One solve is the R = 1 case.
//
// One template over the surface the residual reads serves three exported
// functions:
//  - scan_matcher_2d (K3) on an occupancy grid, as above;
//  - scan_matcher_2d_tsdf (K3's TSDF form): the same residual on the score
//    surface of a TSDF grid, weight > 0 ? 1 - |tsd| / truncation : 0 (JAX
//    ops/tsdf_2d.py:TsdfGrid2D.correspondence_score, l.71, which the JAX
//    loop-closure refine reads through grid.probability());
//  - lm_match_tsdf_2d (K22), in place of ops/tsdf_2d.py:
//    gauss_newton_match_tsdf (l.183) with tsdf_residuals (l.210): residual
//    w / sqrt(n) * bicubic(tsd) * 0.8 / resolution of the raw signed
//    distance, lm_solve's defaults (monotonic steps, tolerance 1e-6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 10;  // H (6), g (3), sum of squares
constexpr int kMaxRobots = 64;  // robots per launch: the pointer table's rows

// Per robot: the surface values, flags and grid origin.
struct Grids {
  const void* values[kMaxRobots];
  const void* flags[kMaxRobots];
  const void* origin[kMaxRobots];
};

// Robot strides of the per-robot inputs, in elements.
struct RobotStrides {
  long long points, mask, x0, target;
};

enum Surface { kOccupancy = 0, kTsdfScore = 1, kTsdfDistance = 2 };

struct Problem {
  const float* values;  // log-odds (occupancy) or tsd (TSDF)
  const void* flags;    // known (uint8, occupancy) or weight (float, TSDF)
  float truncation;     // TSDF score surface only
  float distance_scale;  // 0.8 / resolution, K22 only
  const float* origin;  // (2,) world position of cell (0, 0)
  float resolution;
  int size;
  const float* points;
  const uint8_t* mask;
  int m;
  float scale;  // occupied_space_weight / sqrt(n)
};

// The interpolated cell value: probability (0.1 where unknown), TSDF score
// (0 where unknown) or the raw signed distance.
template <int kSurface>
__device__ inline float cell_value(const Problem& p, int i, int j) {
  size_t idx = (size_t)i * p.size + j;
  if (kSurface == kOccupancy)
    return ((const uint8_t*)p.flags)[idx] ? 1.0f / (1.0f + expf(-p.values[idx])) : 0.1f;
  if (kSurface == kTsdfScore)
    return ((const float*)p.flags)[idx] > 0.0f ? 1.0f - fabsf(p.values[idx]) / p.truncation
                                               : 0.0f;
  return p.values[idx];
}

__device__ inline void catmull_rom(float f, float w[4], float dw[4]) {
  float f2 = f * f;
  float f3 = f2 * f;
  w[0] = 0.5f * (-f3 + 2.0f * f2 - f);
  w[1] = 0.5f * (3.0f * f3 - 5.0f * f2 + 2.0f);
  w[2] = 0.5f * (-3.0f * f3 + 4.0f * f2 + f);
  w[3] = 0.5f * (f3 - f2);
  dw[0] = 0.5f * (-3.0f * f2 + 4.0f * f - 1.0f);
  dw[1] = 0.5f * (9.0f * f2 - 10.0f * f);
  dw[2] = 0.5f * (-9.0f * f2 + 8.0f * f + 1.0f);
  dw[3] = 0.5f * (3.0f * f2 - 2.0f * f);
}

// Residual of point k at pose x and, when jac != nullptr, its gradient.
template <int kSurface>
__device__ inline float residual(const Problem& p, const float x[3], float c, float s,
                                 int k, float* jac) {
  if (!p.mask[k]) {
    if (jac) jac[0] = jac[1] = jac[2] = 0.0f;
    return 0.0f;
  }
  float px = p.points[2 * k], py = p.points[2 * k + 1];
  float rx = c * px - s * py;
  float ry = s * px + c * py;
  float cx = (rx + x[0] - p.origin[0]) / p.resolution - 0.5f;
  float cy = (ry + x[1] - p.origin[1]) / p.resolution - 0.5f;
  float fi = floorf(cx), fj = floorf(cy);
  float fx = cx - fi, fy = cy - fj;
  int i0 = (int)fi, j0 = (int)fj;
  float wx[4], dwx[4], wy[4], dwy[4];
  catmull_rom(fx, wx, dwx);
  catmull_rom(fy, wy, dwy);
  float val = 0.0f, dfx = 0.0f, dfy = 0.0f;
  for (int di = 0; di < 4; ++di) {
    int ii = min(max(i0 + di - 1, 0), p.size - 1);
    float row = 0.0f, drow = 0.0f;
    for (int dj = 0; dj < 4; ++dj) {
      int jj = min(max(j0 + dj - 1, 0), p.size - 1);
      float g = cell_value<kSurface>(p, ii, jj);
      row = row + wy[dj] * g;
      drow = drow + dwy[dj] * g;
    }
    val = val + wx[di] * row;
    dfx = dfx + dwx[di] * row;
    dfy = dfy + wx[di] * drow;
  }
  if (kSurface == kTsdfDistance) {
    if (jac) {
      float k_ = p.scale * p.distance_scale / p.resolution;
      jac[0] = k_ * dfx;
      jac[1] = k_ * dfy;
      jac[2] = k_ * (dfy * rx - dfx * ry);
    }
    return p.scale * (val * p.distance_scale);
  }
  if (jac) {
    float k_ = -p.scale / p.resolution;
    jac[0] = k_ * dfx;
    jac[1] = k_ * dfy;
    jac[2] = k_ * (dfy * rx - dfx * ry);
  }
  return p.scale * (1.0f - val);
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
  if (threadIdx.x == 0) {
    for (int q = 0; q < count; ++q) {
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w) a += scratch[w][q];
      out[q] = a;
    }
  }
  __syncthreads();
}

// Solve A d = b for a 3x3 system by Gaussian elimination with partial pivoting.
__device__ void solve3(float a[3][3], float b[3], float d[3]) {
  for (int col = 0; col < 3; ++col) {
    int piv = col;
    for (int r = col + 1; r < 3; ++r)
      if (fabsf(a[r][col]) > fabsf(a[piv][col])) piv = r;
    if (piv != col) {
      for (int c = 0; c < 3; ++c) {
        float t = a[col][c];
        a[col][c] = a[piv][c];
        a[piv][c] = t;
      }
      float t = b[col];
      b[col] = b[piv];
      b[piv] = t;
    }
    for (int r = col + 1; r < 3; ++r) {
      float f = a[r][col] / a[col][col];
      for (int c = col; c < 3; ++c) a[r][c] = a[r][c] - f * a[col][c];
      b[r] = b[r] - f * b[col];
    }
  }
  for (int r = 2; r >= 0; --r) {
    float acc = b[r];
    for (int c = r + 1; c < 3; ++c) acc = acc - a[r][c] * d[c];
    d[r] = acc / a[r][r];
  }
}

struct Penalty {
  float tx, ty, rot;        // targets
  float wt, wr;             // weights
};

__device__ inline float penalty_sq(const Penalty& q, const float x[3]) {
  float a = q.wt * (x[0] - q.tx), b = q.wt * (x[1] - q.ty), r = q.wr * (x[2] - q.rot);
  return a * a + b * b + r * r;
}

template <int kSurface>
__global__ void scan_matcher_2d_kernel(Problem p, Grids grids, RobotStrides rs,
                                       const float* __restrict__ x0,
                                       const float* __restrict__ target_t, float wt,
                                       float wr, int num_iterations, int nonmonotonic,
                                       float function_tolerance, float* __restrict__ x_out,
                                       float* __restrict__ cost_out,
                                       int* __restrict__ iterations_out) {
  const int r = blockIdx.x;
  p.values = (const float*)grids.values[r];
  p.flags = grids.flags[r];
  p.origin = (const float*)grids.origin[r];
  p.points += r * rs.points;
  p.mask += r * rs.mask;
  x0 += r * rs.x0;
  target_t += r * rs.target;
  x_out += 3 * r;
  cost_out += r;
  iterations_out += r;
  __shared__ float scratch[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float x[3], x_new[3], best_x[3];
  __shared__ float lam, current, best_cost;
  __shared__ int it, stop, finite_delta;

  // n = max(number of valid points, 1), counted once.
  float cnt = 0.0f;
  for (int k = threadIdx.x; k < p.m; k += blockDim.x) cnt += p.mask[k] ? 1.0f : 0.0f;
  block_sum(&cnt, 1, scratch, sums);
  p.scale = p.scale / sqrtf(fmaxf(sums[0], 1.0f));
  Penalty pen = {target_t[0], target_t[1], x0[2], wt, wr};

  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) x[q] = best_x[q] = x0[q];
    lam = 1e-4f;
    it = 0;
    stop = 0;
  }
  __syncthreads();

  // Initial cost.
  {
    float xl[3] = {x[0], x[1], x[2]};
    float c = cosf(xl[2]), s = sinf(xl[2]);
    float acc = 0.0f;
    for (int k = threadIdx.x; k < p.m; k += blockDim.x) {
      float r = residual<kSurface>(p, xl, c, s, k, nullptr);
      acc += r * r;
    }
    block_sum(&acc, 1, scratch, sums);
    if (threadIdx.x == 0) current = best_cost = 0.5f * (sums[0] + penalty_sq(pen, xl));
  }
  __syncthreads();

  while (!stop && it < num_iterations) {
    // Pass A: normal equations at x.
    float xl[3] = {x[0], x[1], x[2]};
    float c = cosf(xl[2]), s = sinf(xl[2]);
    float acc[kSums] = {0.0f};
    for (int k = threadIdx.x; k < p.m; k += blockDim.x) {
      float j[3];
      float r = residual<kSurface>(p, xl, c, s, k, j);
      acc[0] += j[0] * j[0];
      acc[1] += j[0] * j[1];
      acc[2] += j[0] * j[2];
      acc[3] += j[1] * j[1];
      acc[4] += j[1] * j[2];
      acc[5] += j[2] * j[2];
      acc[6] += j[0] * r;
      acc[7] += j[1] * r;
      acc[8] += j[2] * r;
    }
    block_sum(acc, 9, scratch, sums);
    if (threadIdx.x == 0) {
      // Penalty rows: r_t = wt (x_xy - t), r_r = wr (theta - rot).
      float h[3][3] = {{sums[0] + wt * wt, sums[1], sums[2]},
                       {sums[1], sums[3] + wt * wt, sums[4]},
                       {sums[2], sums[4], sums[5] + wr * wr}};
      float g[3] = {sums[6] + wt * (wt * (xl[0] - pen.tx)),
                    sums[7] + wt * (wt * (xl[1] - pen.ty)),
                    sums[8] + wr * (wr * (xl[2] - pen.rot))};
      for (int q = 0; q < 3; ++q) h[q][q] = h[q][q] + lam * fmaxf(h[q][q], 1e-6f);
      float rhs[3] = {-g[0], -g[1], -g[2]};
      float d[3];
      solve3(h, rhs, d);
      finite_delta = isfinite(d[0]) && isfinite(d[1]) && isfinite(d[2]);
      for (int q = 0; q < 3; ++q) x_new[q] = xl[q] + d[q];
    }
    __syncthreads();

    // Pass B: cost at x + delta.
    float xn[3] = {x_new[0], x_new[1], x_new[2]};
    float cn = cosf(xn[2]), sn = sinf(xn[2]);
    float sq = 0.0f;
    for (int k = threadIdx.x; k < p.m; k += blockDim.x) {
      float r = residual<kSurface>(p, xn, cn, sn, k, nullptr);
      sq += r * r;
    }
    block_sum(&sq, 1, scratch, sums);
    if (threadIdx.x == 0) {
      float new_cost = 0.5f * (sums[0] + penalty_sq(pen, xn));
      bool finite = finite_delta && isfinite(new_cost);
      bool improved = new_cost < current && finite;
      bool accept = nonmonotonic ? finite : improved;
      float improvement =
          improved ? (current - new_cost) / fmaxf(current, 1e-30f) : 1.0f;
      lam = improved ? lam * 0.5f : lam * 4.0f;
      if (accept) {
        for (int q = 0; q < 3; ++q) x[q] = xn[q];
        current = new_cost;
      }
      if (finite && new_cost < best_cost) {
        for (int q = 0; q < 3; ++q) best_x[q] = xn[q];
        best_cost = new_cost;
      }
      it = it + 1;
      stop = accept && improvement < function_tolerance && improvement >= 0.0f;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) x_out[q] = nonmonotonic ? best_x[q] : x[q];
    cost_out[0] = nonmonotonic ? best_cost : current;
    iterations_out[0] = it;
  }
}

// `grids` (host memory): robots x (values, flags, origin) device pointers;
// `strides` (host memory): the robot strides of points, mask, x0, target.
template <int kSurface>
int launch(const void* const* grids, int robots, float truncation, float distance_scale,
           float resolution, int size, const void* points, const void* mask, int m,
           const void* x0, const void* target_t, const void* strides,
           float occupied_space_weight, float translation_weight, float rotation_weight,
           int num_iterations, int nonmonotonic, float function_tolerance, void* x_out,
           void* cost_out, void* iterations_out, void* stream) {
  if (grids == nullptr || strides == nullptr || robots < 1) return (int)cudaErrorInvalidValue;
  const long long* st = (const long long*)strides;
  RobotStrides rs = {st[0], st[1], st[2], st[3]};
  for (int r0 = 0; r0 < robots; r0 += kMaxRobots) {
    const int count = min(kMaxRobots, robots - r0);
    Grids g = {};
    for (int r = 0; r < count; ++r) {
      g.values[r] = grids[3 * (r0 + r)];
      g.flags[r] = grids[3 * (r0 + r) + 1];
      g.origin[r] = grids[3 * (r0 + r) + 2];
    }
    Problem p;
    p.values = nullptr;
    p.flags = nullptr;
    p.truncation = truncation;
    p.distance_scale = distance_scale;
    p.origin = nullptr;
    p.resolution = resolution;
    p.size = size;
    p.points = (const float*)points + r0 * rs.points;
    p.mask = (const uint8_t*)mask + r0 * rs.mask;
    p.m = m;
    p.scale = occupied_space_weight;
    scan_matcher_2d_kernel<kSurface><<<count, kThreads, 0, (cudaStream_t)stream>>>(
        p, g, rs, (const float*)x0 + r0 * rs.x0, (const float*)target_t + r0 * rs.target,
        translation_weight, rotation_weight, num_iterations, nonmonotonic,
        function_tolerance, (float*)x_out + 3 * r0, (float*)cost_out + r0,
        (int*)iterations_out + r0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// K3 on occupancy grids: per robot the log-odds (float32) and known (uint8)
// grids, size^2, and the grid origin.
extern "C" int scan_matcher_2d(const void* const* grids, int robots, float resolution,
                               int size, const void* points, const void* mask, int m,
                               const void* x0, const void* target_t, const void* strides,
                               float occupied_space_weight, float translation_weight,
                               float rotation_weight, int num_iterations, int nonmonotonic,
                               float function_tolerance, void* x_out, void* cost_out,
                               void* iterations_out, void* stream) {
  return launch<kOccupancy>(grids, robots, 0.0f, 0.0f, resolution, size, points, mask, m, x0,
                            target_t, strides, occupied_space_weight, translation_weight,
                            rotation_weight, num_iterations, nonmonotonic, function_tolerance,
                            x_out, cost_out, iterations_out, stream);
}

// K3 on the TSDF score surface: per robot `tsd` and `weight` (float32,
// size^2) and the grid origin; one truncation.
extern "C" int scan_matcher_2d_tsdf(const void* const* grids, int robots, float truncation,
                                    float resolution, int size, const void* points,
                                    const void* mask, int m, const void* x0,
                                    const void* target_t, const void* strides,
                                    float occupied_space_weight, float translation_weight,
                                    float rotation_weight, int num_iterations,
                                    int nonmonotonic, float function_tolerance, void* x_out,
                                    void* cost_out, void* iterations_out, void* stream) {
  return launch<kTsdfScore>(grids, robots, truncation, 0.0f, resolution, size, points, mask, m,
                            x0, target_t, strides, occupied_space_weight, translation_weight,
                            rotation_weight, num_iterations, nonmonotonic, function_tolerance,
                            x_out, cost_out, iterations_out, stream);
}

// K22: the TSDF LM on the raw signed distance: per robot `tsd` (float32,
// size^2; the table's flags column unused) and the grid origin;
// distance_scale is 0.8 / resolution rounded to float32 on the host.
extern "C" int lm_match_tsdf_2d(const void* const* grids, int robots, float distance_scale,
                                float resolution, int size, const void* points,
                                const void* mask, int m, const void* x0, const void* target_t,
                                const void* strides, float occupied_space_weight,
                                float translation_weight, float rotation_weight,
                                int num_iterations, int nonmonotonic, float function_tolerance,
                                void* x_out, void* cost_out, void* iterations_out,
                                void* stream) {
  return launch<kTsdfDistance>(grids, robots, 0.0f, distance_scale, resolution, size, points,
                               mask, m, x0, target_t, strides, occupied_space_weight,
                               translation_weight, rotation_weight, num_iterations,
                               nonmonotonic, function_tolerance, x_out, cost_out,
                               iterations_out, stream);
}
