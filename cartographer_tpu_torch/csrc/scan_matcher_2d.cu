// K3 scan_matcher_2d
//
// Replaces: cartographer_tpu/ops/scan_matcher_2d.py:gauss_newton_match_2d
// (l.70) with occupied_space_residuals (l.38), ops/interp.py:interp_bicubic
// (l.31) and ops/gauss_newton.py:lm_solve (l.22).
//
// The whole Levenberg-Marquardt solve on (x, y, theta) is one launch of one
// block, with one pass over the points per iteration: the pass at the
// candidate x + delta computes the residuals, the analytic Jacobian and all
// ten sums (J^T J: 6, J^T r: 3, the sum of squares). If the step is
// accepted, the next iteration's normal equations are already there; if it
// is rejected, the sums at x are kept. The first pass, at the start pose,
// gives the initial cost and the first normal equations. lm_solve rebuilds
// J at the same x from the same inputs, so with one order of the sums this
// is what a pass at x and a pass at x + delta compute: 1 + n passes for n
// iterations where the two-pass form took 1 + 2n. Accept/reject, the lambda
// schedule, use_nonmonotonic_steps and the function_tolerance exit follow
// lm_solve (l.72-127).
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
// grid), and the solve is a chain of up to 21 dependent block-wide passes.
// Design: one thread per point (up to 512 threads, a loop above that); each
// point issues its 16 taps' loads (value and flag) together before any use,
// so a pass waits for one round trip to memory, not one per tap; one
// barrier per pass: the warps' partial sums go to a double-buffered shared
// array, after the barrier each warp adds them in a fixed order (a lane a
// sum) and passes them round its lanes, and every thread solves the damped
// 3x3 system itself, the same in every thread, so nothing is broadcast
// through shared memory. No atomics: two calls give the same bits. At 512
// points the block issues about as many instructions a pass as its SM can
// (PERF.md).
//
// Robots: one block per robot of a cross-robot batch (the JAX package's
// _batched_step_cached vmaps the solve over robots), each with its own
// grid, points, start pose, target and early exit; the block's layout
// depends on the point count only. The robots' grids stay where their
// submaps keep them: a pointer table (surface values, flags, origin per
// robot) travels in the launch's parameters, so it needs no copy to the
// device; above kMaxRobots robots the entry point launches once per
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

constexpr int kMaxThreads = 512;  // a thread per point up to this many points
constexpr int kMaxWarps = kMaxThreads / 32;
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

// The 16 taps' values around cell (i0, j0) (rows i0 - 1 .. i0 + 2, border
// clamped), tap t at (t / 4, t % 4): probability (0.1 where unknown), TSDF
// score (0 where unknown) or the raw signed distance. Every load is issued
// before any is used.
template <int kSurface>
__device__ inline void taps(const Problem& p, int i0, int j0, float g[16]) {
  float v[16], f[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const size_t idx = (size_t)min(max(i0 + t / 4 - 1, 0), p.size - 1) * p.size +
                       min(max(j0 + t % 4 - 1, 0), p.size - 1);
    v[t] = p.values[idx];
    if (kSurface == kOccupancy) f[t] = ((const uint8_t*)p.flags)[idx] ? 1.0f : 0.0f;
    if (kSurface == kTsdfScore) f[t] = ((const float*)p.flags)[idx];
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (kSurface == kOccupancy) g[t] = f[t] != 0.0f ? 1.0f / (1.0f + expf(-v[t])) : 0.1f;
    if (kSurface == kTsdfScore) g[t] = f[t] > 0.0f ? 1.0f - fabsf(v[t]) / p.truncation : 0.0f;
    if (kSurface == kTsdfDistance) g[t] = v[t];
  }
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

// Residual of point k at pose x and its gradient.
template <int kSurface>
__device__ inline float residual(const Problem& p, const float x[3], float c, float s,
                                 int k, float jac[3]) {
  if (!p.mask[k]) {
    jac[0] = jac[1] = jac[2] = 0.0f;
    return 0.0f;
  }
  float px = p.points[2 * k], py = p.points[2 * k + 1];
  float rx = c * px - s * py;
  float ry = s * px + c * py;
  float cx = (rx + x[0] - p.origin[0]) / p.resolution - 0.5f;
  float cy = (ry + x[1] - p.origin[1]) / p.resolution - 0.5f;
  float fi = floorf(cx), fj = floorf(cy);
  float fx = cx - fi, fy = cy - fj;
  float g[16];
  taps<kSurface>(p, (int)fi, (int)fj, g);
  float wx[4], dwx[4], wy[4], dwy[4];
  catmull_rom(fx, wx, dwx);
  catmull_rom(fy, wy, dwy);
  float val = 0.0f, dfx = 0.0f, dfy = 0.0f;
#pragma unroll
  for (int di = 0; di < 4; ++di) {
    float row = 0.0f, drow = 0.0f;
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) {
      row = row + wy[dj] * g[4 * di + dj];
      drow = drow + dwy[dj] * g[4 * di + dj];
    }
    val = val + wx[di] * row;
    dfx = dfx + dwx[di] * row;
    dfy = dfy + wx[di] * drow;
  }
  if (kSurface == kTsdfDistance) {
    float k_ = p.scale * p.distance_scale / p.resolution;
    jac[0] = k_ * dfx;
    jac[1] = k_ * dfy;
    jac[2] = k_ * (dfy * rx - dfx * ry);
    return p.scale * (val * p.distance_scale);
  }
  float k_ = -p.scale / p.resolution;
  jac[0] = k_ * dfx;
  jac[1] = k_ * dfy;
  jac[2] = k_ * (dfy * rx - dfx * ry);
  return p.scale * (1.0f - val);
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

// One pass at pose x: the ten sums over the points into out, in every
// thread. Each thread adds its points (k, k + blockDim.x, ...) in order, a
// shuffle tree adds a warp's lanes, and after the one barrier each warp
// adds the warps' sums in order from `part`, which the caller alternates between
// two buffers: a thread that runs ahead into the next pass writes the other
// one, and the pass after that comes only after every thread has passed
// the next barrier.
template <int kSurface>
__device__ inline void pass(const Problem& p, const float x[3], float (*part)[kSums],
                            float out[kSums]) {
  const float c = cosf(x[2]), s = sinf(x[2]);
  float acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
  for (int k = threadIdx.x; k < p.m; k += blockDim.x) {
    float j[3];
    const float r = residual<kSurface>(p, x, c, s, k, j);
    acc[0] += j[0] * j[0];
    acc[1] += j[0] * j[1];
    acc[2] += j[0] * j[2];
    acc[3] += j[1] * j[1];
    acc[4] += j[1] * j[2];
    acc[5] += j[2] * j[2];
    acc[6] += j[0] * r;
    acc[7] += j[1] * r;
    acc[8] += j[2] * r;
    acc[9] += r * r;
  }
#pragma unroll
  for (int q = 0; q < kSums; ++q)
    for (int off = 16; off > 0; off >>= 1) acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int q = 0; q < kSums; ++q) part[threadIdx.x >> 5][q] = acc[q];
  __syncthreads();
  // Lane q < kSums of every warp adds sum q over the warps, then the lanes
  // pass the sums round (the same bits in every warp).
  float v = 0.0f;
  if ((threadIdx.x & 31) < kSums)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += part[w][threadIdx.x & 31];
#pragma unroll
  for (int q = 0; q < kSums; ++q) out[q] = __shfl_sync(0xffffffffu, v, q);
}

template <int kSurface>
__global__ void __launch_bounds__(kMaxThreads)
    scan_matcher_2d_kernel(Problem p, Grids grids, RobotStrides rs,
                           const float* __restrict__ x0, const float* __restrict__ target_t,
                           float wt, float wr, int num_iterations, int nonmonotonic,
                           float function_tolerance, float* __restrict__ x_out,
                           float* __restrict__ cost_out, int* __restrict__ iterations_out) {
  const int r = blockIdx.x;
  p.values = (const float*)grids.values[r];
  p.flags = grids.flags[r];
  p.origin = (const float*)grids.origin[r];
  p.points += r * rs.points;
  p.mask += r * rs.mask;
  x0 += r * rs.x0;
  target_t += r * rs.target;
  __shared__ float part[2][kMaxWarps][kSums];

  // n = max(number of valid points, 1), counted once.
  int count = 0;
  for (int k0 = 0; k0 < p.m; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    count += __syncthreads_count(k < p.m && p.mask[k]);
  }
  p.scale = p.scale / sqrtf(fmaxf((float)count, 1.0f));
  const Penalty pen = {target_t[0], target_t[1], x0[2], wt, wr};

  // The state, the same in every thread: the sums at x and the candidate's.
  float x[3] = {x0[0], x0[1], x0[2]}, best_x[3] = {x0[0], x0[1], x0[2]};
  float sums[kSums], cand[kSums];
  int buf = 0;
  pass<kSurface>(p, x, part[buf], sums);
  float current = 0.5f * (sums[9] + penalty_sq(pen, x)), best_cost = current;
  float lam = 1e-4f;
  int it = 0;
  bool stop = false;
  while (!stop && it < num_iterations) {
    // Penalty rows: r_t = wt (x_xy - t), r_r = wr (theta - rot).
    float h[3][3] = {{sums[0] + wt * wt, sums[1], sums[2]},
                     {sums[1], sums[3] + wt * wt, sums[4]},
                     {sums[2], sums[4], sums[5] + wr * wr}};
    float g[3] = {sums[6] + wt * (wt * (x[0] - pen.tx)),
                  sums[7] + wt * (wt * (x[1] - pen.ty)),
                  sums[8] + wr * (wr * (x[2] - pen.rot))};
    for (int q = 0; q < 3; ++q) h[q][q] = h[q][q] + lam * fmaxf(h[q][q], 1e-6f);
    float rhs[3] = {-g[0], -g[1], -g[2]};
    float d[3];
    solve3(h, rhs, d);
    const bool finite_delta = isfinite(d[0]) && isfinite(d[1]) && isfinite(d[2]);
    const float xn[3] = {x[0] + d[0], x[1] + d[1], x[2] + d[2]};

    buf ^= 1;
    pass<kSurface>(p, xn, part[buf], cand);
    const float new_cost = 0.5f * (cand[9] + penalty_sq(pen, xn));
    const bool finite = finite_delta && isfinite(new_cost);
    const bool improved = new_cost < current && finite;
    const bool accept = nonmonotonic ? finite : improved;
    const float improvement = improved ? (current - new_cost) / fmaxf(current, 1e-30f) : 1.0f;
    lam = improved ? lam * 0.5f : lam * 4.0f;
    if (accept) {
      for (int q = 0; q < 3; ++q) x[q] = xn[q];
      for (int q = 0; q < kSums; ++q) sums[q] = cand[q];
      current = new_cost;
    }
    if (finite && new_cost < best_cost) {
      for (int q = 0; q < 3; ++q) best_x[q] = xn[q];
      best_cost = new_cost;
    }
    it = it + 1;
    stop = accept && improvement < function_tolerance && improvement >= 0.0f;
  }

  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) x_out[3 * r + q] = nonmonotonic ? best_x[q] : x[q];
    cost_out[r] = nonmonotonic ? best_cost : current;
    iterations_out[r] = it;
  }
}

// A solve's threads for m points: one per point, whole warps, at most
// kMaxThreads (a loop above).
inline int block_threads(int m) { return min(kMaxThreads, max(32, (m + 31) / 32 * 32)); }

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
    scan_matcher_2d_kernel<kSurface><<<count, block_threads(m), 0, (cudaStream_t)stream>>>(
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
