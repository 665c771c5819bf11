// K17 correlative_3d
//
// Replaces: cartographer_tpu/ops/scan_matcher_3d.py:real_time_correlative_match_3d
// (l.144), the 3D real-time correlative search (real_time_correlative_scan_matcher_3d.cc).
//
// Every candidate (x, y, z, rx, ry, rz) of a window around the initial pose
// is scored as the mean probability of the cells the rotated and shifted
// cloud falls in (unknown cells and cells outside the dense window count as
// 0.1) times the motion prior exp(-(|dt| w_t + |aa| w_r)^2), and the best is
// taken. The grid of A^3 rotations (A = 2 na + 1, static) is spaced by a
// per-scan angular step, (1 - 1e-3) acos(1 - r^2 / (2 R^2)) with R the
// cloud's largest masked range (at least 3 cells); the rotations with an
// angle beyond the window are skipped.
//
// Two launches. A one-block kernel takes the cloud's largest masked range
// and its number of valid points once, and from the range the per-scan
// step and the largest angle index k still inside the window, so the step
// never goes to the host. The angles (m * step for m = -na..na) are
// symmetric and grow with |m|, so the rotations inside the window are the
// (2k + 1)^3 with every |m| <= k: at the defaults (a 1 degree window,
// 0.10 m cells, 60 m max_scan_range) 27 to 125 of the static 9,261. The
// search kernel then walks (valid rotation, group of translations) work
// items with a grid stride: each item rotates the cloud,
// rotate(q_initial, rotate(q_r, p)) + t_initial, into its cells in shared
// memory (floor of a true division by the resolution), then scores its
// translations of the L^3 (L = 2 nl + 1): one shared row of probabilities
// per translation, summed over the points as a tree (x[:h] + x[h:] from
// half the padded length down, the plain twin's order, so the two agree to
// the bit), divided by the number of valid points. The probability is
// computed from the log-odds and known flag of the cell, as K11 does. The
// best candidate is the 64-bit atomicMax of (score bits, ~(r * L^3 + t)),
// with r the static rotation index: scores are non-negative, so their bits
// order as the scores, and of equal scores the lowest flat index wins, as
// jnp.argmax per rotation and then across rotations gives it. A one-thread
// kernel decodes the winner into the score and the pose
// [t_initial + offset, normalize(q_initial * q_r)], on the device.
//
// Bound: operations. The range maximum reads the N points once; each valid
// rotation transforms the valid points and gathers their cells for every
// translation (125 x 125 x 512 = 8 M cells at most at the defaults, 5 bytes
// each from a 256^3 window that mostly stays in L2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuffer = 4096;  // floats of shared memory for the rows of sums
constexpr int kMaxPoints = 2048;

struct Grid {
  const float* log_odds;
  const uint8_t* known;
  const float* origin;  // (3,) world position of the corner of cell (0, 0, 0)
  float resolution;
  int size;
};

struct Search {
  int nl, na;
  float resolution_sq;  // float32(resolution^2)
  float min_range;      // float32(3 * resolution)
  float shrink;         // float32(1 - 1e-3)
  float window;         // float32(angular_search_window + 1e-6)
  float wt, wr;
};

__device__ inline float probability(const Grid& g, int i, int j, int k) {
  size_t idx = ((size_t)i * g.size + j) * g.size + k;
  return g.known[idx] ? 1.0f / (1.0f + expf(-g.log_odds[idx])) : 0.1f;
}

// v + qw * t + cross(qv, t) with t = 2 cross(qv, v), one operation at a time.
__device__ inline void rotate(const float q[4], const float v[3], float out[3]) {
  float t0 = 2.0f * (q[2] * v[2] - q[3] * v[1]);
  float t1 = 2.0f * (q[3] * v[0] - q[1] * v[2]);
  float t2 = 2.0f * (q[1] * v[1] - q[2] * v[0]);
  out[0] = (v[0] + q[0] * t0) + (q[2] * t2 - q[3] * t1);
  out[1] = (v[1] + q[0] * t1) + (q[3] * t0 - q[1] * t2);
  out[2] = (v[2] + q[0] * t2) + (q[1] * t1 - q[2] * t0);
}

// quat.from_axis_angle with the Taylor branch below |aa|^2 = 1e-12; also |aa|.
__device__ inline float from_axis_angle(const float aa[3], float q[4]) {
  float angle_sq = (aa[0] * aa[0] + aa[1] * aa[1]) + aa[2] * aa[2];
  float angle = sqrtf(fmaxf(angle_sq, 1e-32f));
  float half = 0.5f * angle;
  bool small = angle_sq < 1e-12f;
  float k = small ? 0.5f - angle_sq / 48.0f : sinf(half) / angle;
  q[0] = small ? 1.0f - angle_sq / 8.0f : cosf(half);
  for (int a = 0; a < 3; ++a) q[a + 1] = k * aa[a];
  return sqrtf(angle_sq);
}

__device__ inline void angles(const Search& s, int r, float step, float aa[3]) {
  int A = 2 * s.na + 1;
  int idx[3] = {r / (A * A), (r / A) % A, r % A};
  for (int a = 0; a < 3; ++a) aa[a] = (float)(idx[a] - s.na) * step;
}

// What the search needs of the cloud, taken once per scan by step_kernel.
struct State {
  float step;  // the per-scan angular step
  int count;   // the number of valid points
  int k;       // the largest |m| with |m * step| inside the window
  int pad;
};

__global__ void __launch_bounds__(kThreads)
    step_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask, int n,
                Search s, State* __restrict__ state) {
  __shared__ float largest[kThreads];
  __shared__ int counts[kThreads];
  float r = 0.0f;
  int count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!mask[i]) continue;
    float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
    r = fmaxf(r, sqrtf((x * x + y * y) + z * z));
    ++count;
  }
  largest[threadIdx.x] = r;
  counts[threadIdx.x] = count;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      largest[threadIdx.x] = fmaxf(largest[threadIdx.x], largest[threadIdx.x + h]);
      counts[threadIdx.x] += counts[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float range = fmaxf(largest[0], s.min_range);
    float step = s.shrink * acosf(1.0f - s.resolution_sq / (2.0f * (range * range)));
    int k = 0;
    while (k < s.na && fabsf((float)(k + 1) * step) <= s.window) ++k;
    *state = State{step, counts[0], k, 0};
  }
}

__global__ void __launch_bounds__(kThreads)
    search_kernel(Grid g, const float* __restrict__ points, const uint8_t* __restrict__ mask,
                  int n, int npad, const float* __restrict__ x0, Search s,
                  const State* __restrict__ state, unsigned long long* __restrict__ best) {
  __shared__ float buffer[kBuffer];
  __shared__ int cells[3 * kMaxPoints];

  const State st = *state;
  const int A = 2 * s.na + 1, V = 2 * st.k + 1;
  const int L = 2 * s.nl + 1, T = L * L * L;
  const int rows = kBuffer / npad, groups = (T + rows - 1) / rows;
  const float num = (float)max(st.count, 1);
  const float q0[4] = {x0[3], x0[4], x0[5], x0[6]};
  for (int item = blockIdx.x; item < V * V * V * groups; item += gridDim.x) {
    const int v = item / groups, t0 = (item - v * groups) * rows;
    const int m[3] = {v / (V * V) - st.k, (v / V) % V - st.k, v % V - st.k};
    const int r = ((m[0] + s.na) * A + (m[1] + s.na)) * A + (m[2] + s.na);
    float aa[3], q[4];
    for (int a = 0; a < 3; ++a) aa[a] = (float)m[a] * st.step;
    const float angle = from_axis_angle(aa, q);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
      float a[3], b[3];
      rotate(q, p, a);
      rotate(q0, a, b);
      for (int c = 0; c < 3; ++c)
        cells[3 * i + c] = (int)floorf(((b[c] + x0[c]) - g.origin[c]) / g.resolution);
    }
    __syncthreads();

    const int nr = min(rows, T - t0);
    for (int idx = threadIdx.x; idx < nr * npad; idx += blockDim.x) {
      int row = idx / npad, i = idx - row * npad, t = t0 + row;
      float val = 0.0f;
      if (i < n && mask[i]) {
        int c[3] = {cells[3 * i] + t / (L * L) - s.nl, cells[3 * i + 1] + (t / L) % L - s.nl,
                    cells[3 * i + 2] + t % L - s.nl};
        bool inside = true;
        for (int a = 0; a < 3; ++a) inside = inside && c[a] >= 0 && c[a] < g.size;
        val = inside ? probability(g, c[0], c[1], c[2]) : 0.1f;
      }
      buffer[idx] = val;
    }
    __syncthreads();
    for (int h = npad / 2; h > 0; h >>= 1) {
      for (int idx = threadIdx.x; idx < nr * h; idx += blockDim.x) {
        int row = idx / h, i = idx - row * h;
        buffer[row * npad + i] = buffer[row * npad + i] + buffer[row * npad + i + h];
      }
      __syncthreads();
    }
    if (threadIdx.x < nr) {
      int t = t0 + threadIdx.x;
      float raw = buffer[threadIdx.x * npad] / num;
      float lx = (float)(t / (L * L) - s.nl) * g.resolution;
      float ly = (float)((t / L) % L - s.nl) * g.resolution;
      float lz = (float)(t % L - s.nl) * g.resolution;
      float dist = sqrtf((lx * lx + ly * ly) + lz * lz);
      float w = dist * s.wt + angle * s.wr;
      float score = raw * expf(-(w * w));
      unsigned int flat = (unsigned int)r * (unsigned int)T + (unsigned int)t;
      unsigned long long key = ((unsigned long long)__float_as_uint(score) << 32) |
                               (unsigned long long)(~flat);
      atomicMax(best, key);
    }
    __syncthreads();
  }
}

__global__ void decode_kernel(const unsigned long long* __restrict__ best,
                              const State* __restrict__ state, const float* __restrict__ x0,
                              float resolution, Search s, float* __restrict__ x_out,
                              float* __restrict__ score_out) {
  unsigned long long key = best[0];
  unsigned int flat = ~(unsigned int)(key & 0xFFFFFFFFull);
  const int L = 2 * s.nl + 1, T = L * L * L;
  int r = (int)(flat / (unsigned int)T), t = (int)(flat % (unsigned int)T);
  float aa[3], q[4];
  angles(s, r, state->step, aa);
  from_axis_angle(aa, q);
  const float* q0 = x0 + 3;
  float m[4] = {q0[0] * q[0] - q0[1] * q[1] - q0[2] * q[2] - q0[3] * q[3],
                q0[0] * q[1] + q0[1] * q[0] + q0[2] * q[3] - q0[3] * q[2],
                q0[0] * q[2] - q0[1] * q[3] + q0[2] * q[0] + q0[3] * q[1],
                q0[0] * q[3] + q0[1] * q[2] - q0[2] * q[1] + q0[3] * q[0]};
  float norm = sqrtf(((m[0] * m[0] + m[1] * m[1]) + m[2] * m[2]) + m[3] * m[3]);
  int off[3] = {t / (L * L) - s.nl, (t / L) % L - s.nl, t % L - s.nl};
  for (int a = 0; a < 3; ++a) x_out[a] = x0[a] + (float)off[a] * resolution;
  for (int a = 0; a < 4; ++a) x_out[3 + a] = m[a] / norm;
  score_out[0] = __uint_as_float((unsigned int)(key >> 32));
}

}  // namespace

// `best` holds one zero int64; `state` four 32-bit words of scratch (the
// scan's angular step, its valid points and the largest angle index inside
// the window on return); `x_out` the best pose [t, q] (7,) and `score_out`
// its score.
extern "C" int correlative_3d(const void* log_odds, const void* known, const void* origin,
                              float resolution, int size, const void* points, const void* mask,
                              int n, int npad, const void* x0, int nl, int na,
                              float resolution_sq, float min_range, float shrink,
                              float window, float translation_weight, float rotation_weight,
                              void* best, void* state, void* x_out, void* score_out,
                              void* stream) {
  if (n <= 0 || n > kMaxPoints || npad < n || npad > kBuffer || (npad & (npad - 1)))
    return (int)cudaErrorInvalidValue;
  Grid g{(const float*)log_odds, (const uint8_t*)known, (const float*)origin, resolution, size};
  Search s{nl, na, resolution_sq, min_range, shrink, window, translation_weight,
           rotation_weight};
  cudaStream_t st = (cudaStream_t)stream;
  step_kernel<<<1, kThreads, 0, st>>>((const float*)points, (const uint8_t*)mask, n, s,
                                      (State*)state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The valid rotations are known only on the device: enough blocks for the
  // work items of every rotation of a window that holds 27 of them, a grid
  // stride beyond.
  const int L = 2 * nl + 1, rows = kBuffer / npad;
  const int items = 27 * ((L * L * L + rows - 1) / rows);
  search_kernel<<<items, kThreads, 0, st>>>(g, (const float*)points, (const uint8_t*)mask, n,
                                            npad, (const float*)x0, s, (const State*)state,
                                            (unsigned long long*)best);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_kernel<<<1, 1, 0, st>>>((const unsigned long long*)best, (const State*)state,
                                 (const float*)x0, resolution, s, (float*)x_out,
                                 (float*)score_out);
  return (int)cudaGetLastError();
}
