// K11 scan_matcher_3d
//
// Replaces: cartographer_tpu/ops/scan_matcher_3d.py:gauss_newton_match_3d
// (l.61) with _occupied_residuals (l.53), the intensity residual (l.93-113)
// and se3_retract (l.45), ops/interp.py:interp_trilinear (l.80) and
// ops/gauss_newton.py:lm_solve (l.22).
//
// The whole Levenberg-Marquardt solve on the SE(3) tangent [dt, so3] (or
// [dt, yaw]) is one launch, with one pass over the rows per iteration: the
// pass at the candidate x + delta computes, for the high- and the
// low-resolution cloud and the intensity rows, the residuals
// w / sqrt(n) * (1 - P(T p)) (with an intensity grid also the high cloud's
// intensity rows w_i / sqrt(n_i) * clip(I(T p) - i) over the points whose
// intensity i is at most the threshold), their analytic Jacobian and all 28
// sums (J^T J: 21, J^T r: 6, the sum of squares). If the step is accepted,
// the next iteration's normal equations are already there; if it is
// rejected, the sums at x are kept. The first pass, at the start pose, gives
// the initial cost and the first normal equations: 1 + n passes for n
// iterations where the two-pass form took 1 + 2n. The solve adds the
// translation and rotation penalties at x, damps the diagonal, solves the
// 6x6 (4x4) system with partial pivoting and retracts (t += dt,
// q = normalize(q * exp(so3))); accept/reject, the lambda schedule,
// use_nonmonotonic_steps (the best pose kept beside the accepted one) and
// the function_tolerance exit follow lm_solve (l.72-127).
//
// P is the trilinear interpolation of the grid's probability, with the
// corner indices clamped to the border. The probability is computed from
// the log-odds and known flags of the 8 gathered corners
// (1 / (1 + exp(-l)), or 0.1 where unknown): no probability volume is made.
// I is the trilinear interpolation of the running-average intensity, read
// per corner as sums / max(counts, 1), the value of the twin's average()
// volume to the bit. clip is the soft Huber clip of the JAX program: the
// identity up to twice the scale s, s + sqrt(s (|r| - s)) beyond it; its
// derivative is 1 (0 at r = 0, where sign(r) = 0), s / (2 sqrt(s (|r| - s)))
// beyond, and the mean of the two at the kink, as jax.jacfwd takes it. The
// intensity grid's pointers are null when the term is off.
// The rotation acts on the right, so d world / d so3 = -R(q) [p]x, and the
// rotation penalty log(conj(q_target) q) has the inverse right Jacobian of
// SO(3); JAX takes both with jacfwd at delta = 0.
//
// Bound: latency. The frontend's 512 + 1,024 points with 8 corners each
// from two grids are a few hundred KB; the solve is a chain of up to 13
// dependent passes (23 for the testbed's `ceres` mode). Design:
//  - a thread per row (a high point with its intensity row, or a low point):
//    each row issues its corners' loads together before any use (8 log-odds
//    and 8 known flags, and 8 sums and 8 counts for an intensity row), so a
//    pass waits for one round trip to memory, not one per corner;
//  - above one block's 256 rows, the rows spread over a thread-block cluster
//    of up to 16 blocks, ceil(rows / 256) of them (the `ceres` testbed's
//    2 x 32,768 points take 16, each thread 16 rows): a block adds its warps'
//    sums after a block barrier, and after one cluster barrier a pass every
//    warp reads the blocks' 28 sums through distributed shared memory;
//  - the warps' partial sums go to double-buffered shared arrays, so a pass
//    takes one barrier in one block (one block and one cluster barrier in a
//    cluster): a thread that runs ahead into the next pass writes the other
//    buffer;
//  - the damped solve: one warp of each block keeps the solve's state,
//    solves the 6x6 system and broadcasts the candidate through shared
//    memory, at the cost of a second block barrier a pass; every thread
//    solving the same system itself so that nothing is broadcast (as K3's
//    template does) took 5-18% longer on the card (PERF.md row 14).
// The 28 sums add in double: each row's products are float32, and their
// sum over a thread's rows, the warp's tree, the warps and the cluster's
// blocks is float64, and so are the cost and the LM accept test taken from
// it (the normal equations are rounded to float32 for the solve). On the
// `ceres` testbed's flat cost (2 x 32,768 rows) float32 sums took 26 LM
// iterations and ended 7.4e-5 m from the twin run in float64; float64 sums
// take its 22 and end within 1e-5 m of it (PERF.md row 14). So that double
// sums cost little more than float ones: a warp's tree is a halving
// exchange (31 shuffles of a lane for the 28 sums, where a shuffle tree a
// sum takes 140), and the solver warp keeps the sums at x spread over its
// lanes (lane q sum q), gathering them as it forms the normal equations,
// which keeps the kernel within its registers. No atomics and a
// fixed order of every sum (a thread's rows in order, a shuffle tree over a
// warp's lanes, the warps in order, the blocks in order; the layout depends
// on the point counts only), so two calls give the same bits. The plain
// twin (ops/scan_matcher_3d.py:_match_plain) forms J^T J and J^T r as
// float32 matrix products, which add in another order and precision, so
// kernel and twin are held to 1e-4 m, 1e-4 rad and 1e-4 of the cost.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
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

struct Intensity {
  const float* sums;  // (size^3,) or null: no intensity rows
  const float* counts;
  const float* origin;
  float resolution;
  int size;
  const float* values;  // (n,) the high cloud's intensities
  float scale;  // intensity weight / sqrt(number of points within the threshold)
  float huber_scale;
  float threshold;
};

struct Shared {
  double part[2][kWarps][kSums];  // the warps' partial sums, double-buffered
  double total[2][kSums];         // in a cluster: the block's sums, read by the others
  float candidate[8];            // the pose to evaluate and whether to go on
};

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

// The 8 corners of the trilinear stencil at the world point `world` of a
// size^3 grid (corner indices clamped to the border), corner c at
// (c >> 2, (c >> 1) & 1, c & 1), and the weights w[axis][0 or 1].
__device__ inline void stencil(const float* origin, float resolution, int size,
                               const float world[3], size_t idx[8], float w[3][2]) {
  int base[3];
  for (int a = 0; a < 3; ++a) {
    float c = (world[a] - origin[a]) / resolution - 0.5f;
    float b = floorf(c);
    float f = c - b;
    base[a] = (int)b;
    w[a][0] = 1.0f - f;
    w[a][1] = f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ii = min(max(base[0] + (c >> 2), 0), size - 1);
    const int jj = min(max(base[1] + ((c >> 1) & 1), 0), size - 1);
    const int kk = min(max(base[2] + (c & 1), 0), size - 1);
    idx[c] = ((size_t)ii * size + jj) * size + kk;
  }
}

// Trilinear value of the corner values v and its gradient in cell coordinates.
__device__ inline float trilinear(const float v[8], const float w[3][2], float grad[3]) {
  float val = 0.0f;
  grad[0] = grad[1] = grad[2] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int di = c >> 2, dj = (c >> 1) & 1, dk = c & 1;
    val = val + w[0][di] * w[1][dj] * w[2][dk] * v[c];
    float si = di ? 1.0f : -1.0f, sj = dj ? 1.0f : -1.0f, sk = dk ? 1.0f : -1.0f;
    grad[0] = grad[0] + si * (w[1][dj] * w[2][dk]) * v[c];
    grad[1] = grad[1] + sj * (w[0][di] * w[2][dk]) * v[c];
    grad[2] = grad[2] + sk * (w[0][di] * w[1][dj]) * v[c];
  }
  return val;
}

// The gradient on the tangent [dt, so3] of a residual whose gradient in
// world coordinates is gw, at the body point p and rotation q.
__device__ inline void tangent_gradient(const float q[4], const float p[3], const float gw[3],
                                        float* jac) {
  float gb[3];
  float qc[4] = {q[0], -q[1], -q[2], -q[3]};
  rotate(qc, gw, gb);
  for (int a = 0; a < 3; ++a) jac[a] = gw[a];
  cross3(p, gb, jac + 3);
}

// The row's float32 products added to the float64 sums.
__device__ inline void accumulate(double* acc, const float j[6], float r) {
  int q = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) acc[q++] += (double)(j[a] * j[b]);
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += (double)(j[a] * r);
  acc[27] += (double)(r * r);
}

// Adds row `row` at pose x (translation t, rotation q) to acc: a high point
// (row < hc.n) with its intensity row, or low point row - hc.n.
__device__ inline void add_row(const Grid& hg, const Cloud& hc, const Grid& lg, const Cloud& lc,
                               const Intensity& it, const float t[3], const float q[4],
                               int row, double* acc) {
  const bool high = row < hc.n;
  const Grid& g = high ? hg : lg;
  const Cloud& cloud = high ? hc : lc;
  const int k = high ? row : row - hc.n;
  if (!cloud.mask[k]) return;  // a zero row adds nothing
  const float p[3] = {cloud.points[3 * k], cloud.points[3 * k + 1], cloud.points[3 * k + 2]};
  float world[3];
  rotate(q, p, world);
  for (int a = 0; a < 3; ++a) world[a] = world[a] + t[a];
  const bool rows = high && it.sums != nullptr;
  const float value = rows ? it.values[k] : 0.0f;
  const bool intensity_row = rows && value <= it.threshold;

  // Every corner's loads, issued before any is used.
  size_t idx[8], iidx[8];
  float w[3][2], iw[3][2];
  stencil(g.origin, g.resolution, g.size, world, idx, w);
  if (intensity_row) stencil(it.origin, it.resolution, it.size, world, iidx, iw);
  float lo[8], isum[8], icount[8];
  uint8_t kn[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    lo[c] = g.log_odds[idx[c]];
    kn[c] = g.known[idx[c]];
  }
  if (intensity_row) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      isum[c] = it.sums[iidx[c]];
      icount[c] = it.counts[iidx[c]];
    }
  }

  float v[8], grad[3], jac[6];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = kn[c] ? 1.0f / (1.0f + expf(-lo[c])) : 0.1f;
  const float val = trilinear(v, w, grad);
  float gw[3];
  for (int a = 0; a < 3; ++a) gw[a] = -cloud.scale * (grad[a] / g.resolution);
  tangent_gradient(q, p, gw, jac);
  accumulate(acc, jac, cloud.scale * (1.0f - val));

  if (!intensity_row) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = isum[c] / fmaxf(icount[c], 1.0f);
  const float pred = trilinear(v, iw, grad);
  const float r = pred - value;
  const float s = it.huber_scale;
  const float a = fabsf(r);
  const float arg = s * (a - s);
  const bool outlier = arg > 0.0f;
  const float soft = outlier ? sqrtf(arg) : 0.0f;
  const float bound = s + soft;
  const float sign = r > 0.0f ? 1.0f : (r < 0.0f ? -1.0f : 0.0f);
  const float d_bound = outlier ? 0.5f * s * sign / soft : 0.0f;
  const float d_min = a < bound ? sign : (a > bound ? d_bound : 0.5f * (sign + d_bound));
  const float d_r = sign * d_min;
  for (int c = 0; c < 3; ++c) gw[c] = (it.scale * d_r) * (grad[c] / it.resolution);
  tangent_gradient(q, p, gw, jac);
  accumulate(acc, jac, it.scale * (sign * fminf(a, bound)));
}

// One level of the halving exchange below and the levels under it, each
// unrolled at compile time (a loop over the levels left v in local memory):
// a lane keeps v[0..H) or v[H..2H) by its bit H and adds what lane ^ H
// sends of the other half.
template <int H, int P>
__device__ inline void exchange(double (&v)[P], int lane) {
  if constexpr (H >= 1) {
    const bool upper = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const double send = upper ? v[i] : v[H + i];
      const double keep = upper ? v[H + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    exchange<H / 2, P>(v, lane);
  }
}

// The cluster's sums of acc[0..K): lane q < K of each warp that takes them
// (every warp, or warp 0 alone) returns sum q. Over a warp's lanes,
// a halving exchange: at offset h = P/2 ... 1 (P the power of two >= K) a
// lane keeps half of its sums, sends the other half to lane ^ h and adds
// what it receives, so lane q ends with sum q of lanes that agree in their
// bits >= P, and an xor tree over those bits completes it: for every sum
// the pairing of a shuffle tree (lane l with l + 16, then l + 8, ...) in
// P - 1 + 5 - log2(P) shuffles of a lane instead of 5 K. Then the warps in
// order into buffer `buf` of `part`; in a cluster each block adds its warps
// after a block barrier and, after the cluster barrier, lane q of a warp
// adds sum q of the blocks in order.
template <int K>
__device__ inline double reduce(double acc[K], Shared& s, int buf, cg::cluster_group& cluster,
                                unsigned int blocks, bool take) {
  constexpr int P = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double v[P];
#pragma unroll
  for (int q = 0; q < P; ++q) v[q] = q < K ? acc[q] : 0.0;
  exchange<P / 2, P>(v, lane);
#pragma unroll
  for (int off = 16; off >= P; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  if (lane < K) s.part[buf][warp][lane] = v[0];
  __syncthreads();
  double t = 0.0;
  if (blocks == 1) {
    if (take && lane < K)
      for (int w = 0; w < kWarps; ++w) t += s.part[buf][w][lane];
  } else {
    if (warp == 0 && lane < K) {
      double b = 0.0;
      for (int w = 0; w < kWarps; ++w) b += s.part[buf][w][lane];
      s.total[buf][lane] = b;
    }
    cluster.sync();
    if (take && lane < K) {
      double u[kMaxCluster];
#pragma unroll
      for (int b = 0; b < kMaxCluster; ++b)  // the loads in flight together
        u[b] = b < (int)blocks ? cluster.map_shared_rank(&s.total[buf][0], (unsigned int)b)[lane]
                               : 0.0;
#pragma unroll
      for (int b = 0; b < kMaxCluster; ++b)
        if (b < (int)blocks) t += u[b];
    }
  }
  return t;
}

// One pass at pose x: the 28 sums over the rows, sum q in lane q of the
// warps that take them. Thread g of the cluster
// takes rows g, g + G, ... (G the cluster's threads) in order.
__device__ inline double pass(const Grid& hg, const Cloud& hc, const Grid& lg, const Cloud& lc,
                            const Intensity& it, const float x[7], Shared& s, int buf,
                            cg::cluster_group& cluster, unsigned int blocks, unsigned int rank,
                            bool take) {
  double acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.0;
  const int stride = (int)blocks * kThreads, rows = hc.n + lc.n;
  for (int row = (int)rank * kThreads + threadIdx.x; row < rows; row += stride)
    add_row(hg, hc, lg, lc, it, x, x + 3, row, acc);
  return reduce<kSums>(acc, s, buf, cluster, blocks, take);
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

// The penalty rows' sum of squares: float32 squares, a float64 sum.
__device__ inline double penalty_sq(const Penalty& pen, const float x[7]) {
  float phi[3];
  rotation_error(pen, x + 3, phi);
  double acc = 0.0;
  for (int a = 0; a < 3; ++a) {
    float rt = pen.wt * (x[a] - pen.target_t[a]);
    float rr = pen.wr * phi[a];
    acc += (double)(rt * rt) + (double)(rr * rr);
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

// The damped step from the sums at x: the penalty rows at x added to the
// normal equations, the diagonal damped by lam, the 6x6 (or [dt, yaw] 4x4)
// system solved and the step retracted into xn. `sum` is lane q's sum q of
// the warp (every lane of which calls this), each rounded to float32 as it
// is gathered. Returns whether the step is finite.
__device__ inline bool lm_step(double sum, const float x[7], const Penalty& pen, float lam,
                               bool yaw_only, float xn[7]) {
  const float wt = pen.wt, wr = pen.wr;
  float h6[6][6], g6[6];
  int q = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) {
      h6[a][b] = h6[b][a] = (float)__shfl_sync(0xffffffffu, sum, q);
      ++q;
    }
#pragma unroll
  for (int a = 0; a < 6; ++a) g6[a] = (float)__shfl_sync(0xffffffffu, sum, 21 + a);
  // Penalty rows: r_t = wt (t - target), r_r = wr log(conj(q_target) q).
  float phi[3], m[3][3];
  rotation_error(pen, x + 3, phi);
  inverse_right_jacobian(phi, m);
  for (int a = 0; a < 3; ++a) {
    h6[a][a] = h6[a][a] + wt * wt;
    g6[a] = g6[a] + wt * (wt * (x[a] - pen.target_t[a]));
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
  const int dim = yaw_only ? 4 : 6;
  const int cols[6] = {0, 1, 2, yaw_only ? 5 : 3, 4, 5};
  float h[6][6], rhs[6], d[6];
  for (int a = 0; a < dim; ++a) {
    for (int b = 0; b < dim; ++b) h[a][b] = h6[cols[a]][cols[b]];
    rhs[a] = -g6[cols[a]];
  }
  for (int a = 0; a < dim; ++a) h[a][a] = h[a][a] + lam * fmaxf(h[a][a], 1e-6f);
  solve(h, rhs, d, dim);
  bool finite = true;
  float d6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int a = 0; a < dim; ++a) {
    finite = finite && isfinite(d[a]);
    d6[cols[a]] = d[a];
  }
  retract(x, d6, xn);
  return finite;
}

// The solve's state, kept by every lane of the warp that solves; the sums at
// x spread over its lanes, lane q holding sum q.
struct State {
  float x[7], best_x[7];
  double sum;  // at x
  double current, best_cost;
  float lam;
  int it;
  bool stop;
};

// lm_solve's accept/reject of the candidate xn, lane q holding its sum q
// in cand.
__device__ inline void decide(State& st, const float xn[7], double cand, bool finite_delta,
                              const Penalty& pen, int nonmonotonic, float function_tolerance) {
  const double new_cost = 0.5 * (__shfl_sync(0xffffffffu, cand, 27) + penalty_sq(pen, xn));
  const bool finite = finite_delta && isfinite(new_cost);
  const bool improved = new_cost < st.current && finite;
  const bool accept = nonmonotonic ? finite : improved;
  const double improvement =
      improved ? (st.current - new_cost) / fmax(st.current, 1e-30) : 1.0;
  st.lam = improved ? st.lam * 0.5f : st.lam * 4.0f;
  if (accept) {
    for (int q = 0; q < 7; ++q) st.x[q] = xn[q];
    st.sum = cand;
    st.current = new_cost;
  }
  if (finite && new_cost < st.best_cost) {
    for (int q = 0; q < 7; ++q) st.best_x[q] = xn[q];
    st.best_cost = new_cost;
  }
  st.it = st.it + 1;
  st.stop = accept && improvement < (double)function_tolerance && improvement >= 0.0;
}

__global__ void __launch_bounds__(kThreads)
    scan_matcher_3d_kernel(Grid hg, Cloud hc, Grid lg, Cloud lc, Intensity rows,
                           const float* __restrict__ x0, const float* __restrict__ target_t,
                           float wt, float wr, int yaw_only, int num_iterations, int nonmonotonic,
                           float function_tolerance, float* __restrict__ x_out,
                           float* __restrict__ cost_out, int* __restrict__ iterations_out) {
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int blocks = cluster.num_blocks(), rank = cluster.block_rank();
  // Warp 0 of each block keeps the solve's state.
  const bool solver = threadIdx.x < 32;
  int buf = 0;

  // n = max(number of valid points, 1) of each cloud and of the intensity
  // rows, counted once.
  {
    double cnt[3] = {0.0, 0.0, 0.0};
    const int stride = (int)blocks * kThreads;
    for (int k = (int)rank * kThreads + threadIdx.x; k < hc.n; k += stride) {
      cnt[0] += hc.mask[k] ? 1.0 : 0.0;
      if (rows.sums) cnt[2] += (hc.mask[k] && rows.values[k] <= rows.threshold) ? 1.0 : 0.0;
    }
    for (int k = (int)rank * kThreads + threadIdx.x; k < lc.n; k += stride)
      cnt[1] += lc.mask[k] ? 1.0 : 0.0;
    const double n = reduce<3>(cnt, s, buf, cluster, blocks, true);  // whole counts, exact
    hc.scale = hc.scale / sqrtf(fmaxf((float)__shfl_sync(0xffffffffu, n, 0), 1.0f));
    lc.scale = lc.scale / sqrtf(fmaxf((float)__shfl_sync(0xffffffffu, n, 1), 1.0f));
    rows.scale = rows.scale / sqrtf(fmaxf((float)__shfl_sync(0xffffffffu, n, 2), 1.0f));
  }
  Penalty pen;
  for (int a = 0; a < 3; ++a) pen.target_t[a] = target_t[a];
  for (int a = 0; a < 4; ++a) pen.target_q[a] = x0[3 + a];
  pen.wt = wt;
  pen.wr = wr;

  State st;
  for (int q = 0; q < 7; ++q) st.x[q] = st.best_x[q] = x0[q];
  buf ^= 1;
  st.sum = pass(hg, hc, lg, lc, rows, st.x, s, buf, cluster, blocks, rank, solver);
  st.current = st.best_cost =
      0.5 * (__shfl_sync(0xffffffffu, st.sum, 27) + penalty_sq(pen, st.x));
  st.lam = 1e-4f;
  st.it = 0;
  st.stop = false;
  while (true) {
    float xn[7];
    bool finite_delta = false, go = !st.stop && st.it < num_iterations;
    if (solver && go) finite_delta = lm_step(st.sum, st.x, pen, st.lam, yaw_only != 0, xn);
    // Warp 0 broadcasts the candidate and whether to go on.
    if (threadIdx.x == 0) {
      for (int q = 0; q < 7; ++q) s.candidate[q] = xn[q];
      s.candidate[7] = go ? 1.0f : 0.0f;
    }
    __syncthreads();
    for (int q = 0; q < 7; ++q) xn[q] = s.candidate[q];
    go = s.candidate[7] != 0.0f;
    if (!go) break;
    buf ^= 1;
    const double cand = pass(hg, hc, lg, lc, rows, xn, s, buf, cluster, blocks, rank, solver);
    if (solver) decide(st, xn, cand, finite_delta, pen, nonmonotonic, function_tolerance);
  }

  if (rank == 0 && threadIdx.x == 0) {
    for (int q = 0; q < 7; ++q) x_out[q] = nonmonotonic ? st.best_x[q] : st.x[q];
    cost_out[0] = (float)(nonmonotonic ? st.best_cost : st.current);
    iterations_out[0] = st.it;
  }
  if (blocks > 1) cluster.sync();  // no block leaves while another may read its sums
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

// Blocks of the cluster for `rows` rows: one per kThreads, at most kMaxCluster.
int cluster_blocks(long long rows) {
  const long long b = (rows + kThreads - 1) / kThreads;
  return b < 1 ? 1 : b > kMaxCluster ? kMaxCluster : (int)b;
}

}  // namespace

extern "C" int scan_matcher_3d(
    const void* high_log_odds, const void* high_known, const void* high_origin,
    float high_resolution, int high_size, const void* high_points, const void* high_mask,
    int num_high, const void* low_log_odds, const void* low_known, const void* low_origin,
    float low_resolution, int low_size, const void* low_points, const void* low_mask,
    int num_low, const void* intensity_sums, const void* intensity_counts,
    const void* intensity_origin, float intensity_resolution, int intensity_size,
    const void* high_intensities, float intensity_weight, float huber_scale,
    float intensity_threshold, const void* x0, const void* target_t,
    float occupied_space_weight_0,
    float occupied_space_weight_1, float translation_weight, float rotation_weight,
    int only_optimize_yaw, int num_iterations, int nonmonotonic, float function_tolerance,
    void* x_out, void* cost_out, void* iterations_out, void* stream) {
  Grid hg = make_grid(high_log_odds, high_known, high_origin, high_resolution, high_size);
  Grid lg = make_grid(low_log_odds, low_known, low_origin, low_resolution, low_size);
  Cloud hc = make_cloud(high_points, high_mask, num_high, occupied_space_weight_0);
  Cloud lc = make_cloud(low_points, low_mask, num_low, occupied_space_weight_1);
  Intensity rows{(const float*)intensity_sums, (const float*)intensity_counts,
                 (const float*)intensity_origin, intensity_resolution, intensity_size,
                 (const float*)high_intensities, intensity_weight, huber_scale,
                 intensity_threshold};
  void (*kernel)(Grid, Cloud, Grid, Cloud, Intensity, const float*, const float*, float, float,
                 int, int, int, float, float*, float*, int*) = scan_matcher_3d_kernel;
  static int configured = -1;  // the device on which the kernel may take 16 blocks a cluster
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) configured = device;
  }
  if (err != cudaSuccess) return (int)err;
  const unsigned int blocks = (unsigned int)cluster_blocks((long long)num_high + num_low);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = blocks;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, hg, hc, lg, lc, rows, (const float*)x0,
                           (const float*)target_t, translation_weight, rotation_weight,
                           only_optimize_yaw, num_iterations, nonmonotonic, function_tolerance,
                           (float*)x_out, (float*)cost_out, (int*)iterations_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
