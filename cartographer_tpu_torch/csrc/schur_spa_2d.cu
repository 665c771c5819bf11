// K8 schur_spa_2d
//
// Replaces: cartographer_tpu/parallel/schur_spa.py:solve_spa_2d_schur (l.396)
// through _solver_fn (l.237): _assemble_local (l.131) with
// ops/spa.py:constraint_residual (l.49) and _wrap_angle (l.45), the block
// LU _block_tridiag_factor (l.188), the multi-RHS sweep _tridiag_solve_multi
// (l.210), the reduced Cholesky solve (l.345-361) and the LM accept/reject
// (l.362-375), on one device.
//
// One call runs every Levenberg-Marquardt iteration: the host enqueues the
// launches of all iterations at once and lambda, the costs and the accept
// decision live in device memory, so the solve needs no host
// synchronisation (the JAX form is one lax.scan). Per iteration:
//   assemble  one thread per constraint: residual, Huber IRLS weight and the
//             analytic Jacobians (jacfwd's values; the wrap's floor has no
//             derivative), atomically added into A (S,3,3), Td, To (N,3,3),
//             g_s, g_n; the coupling block Bc = (Ja * free)^T Jb is kept per
//             constraint and scattered transposed into the sweep's
//             right-hand sides [B^T | g_n] (N, 3, 3S+1); the cost at x.
//   damp      one thread per slot: frozen slots get zero rows and columns
//             and a unit diagonal, free ones lambda * |diag| + damping.
//   factor    one thread walks the node chain: C_i = Td_i - To_{i-1}^T
//             Cinv_{i-1} To_{i-1}, Cinv_i = (C_i + 1e-9 I)^-1 (pivoted
//             Gauss-Jordan), CinvU_i = Cinv_i To_i.
//   sweep     one thread per right-hand side: forward and back substitution
//             down and up the chain; the chain is sequential, the 3S+1
//             columns run in parallel and read the same factor blocks.
//   reduce    one block per constraint: B X and B y scattered atomically
//             into the reduced matrix and right-hand side.
//   cholesky  one block: the 3S x 3S system A - B X, factored in place and
//             solved; a system that is not positive definite yields NaN,
//             and the step is then rejected.
//   update    dx_n = -(y + X dx_s) and the candidate poses.
//   cost      the cost at the candidate.
//   accept    finite and not larger: take the candidate, lambda / 3; else
//             keep the poses, lambda * 8; lambda within [1e-8, 1e8].
// Atomics order the sums differently from run to run: the result agrees
// with the plain twin to a tolerance, not bit for bit.
//
// Bound: latency. At full width (N = 4096 nodes, S = 64 submaps, C = 16,384
// constraints) an iteration moves some 30 MB and does some 0.1 GFLOP, tens of
// microseconds of either; the factor is a chain of 4096 dependent 3x3
// inversions on one thread and the sweep a chain of 8192 dependent 3x3
// products per column, which is what the time is made of.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159274101257324f;     // float32(pi)
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kEps = 1e-9f;
constexpr int kThreads = 256;

struct Problem {
  int S, N, C, D, K;
  const int* a_idx;
  const int* b_idx;
  const float* rel;
  const float* tw;
  const float* rw;
  const uint8_t* huber;
  const uint8_t* valid;
  const int* j_idx;
  const float* nn_rel;
  const float* nn_tw;
  const float* nn_rw;
  const uint8_t* nn_valid;
  const uint8_t* sub_fixed;
  const uint8_t* node_fixed;
  float huber_scale;
  float damping;
};

struct Workspace {
  float *A, *Td, *To, *g_s, *g_n, *X, *M, *r;  // zeroed every iteration, in this order
  float *scal;  // [0] cost at x, [1] cost at the candidate, [2] lambda
  float *Cinv, *CinvU, *Bc, *dx, *cand_sub, *cand_nod;
};

__device__ inline float wrap_angle(float a) {
  return a - kTwoPi * floorf((a + kPi) / kTwoPi);
}

// Weighted residual of poses pa, pb against rel and, when ja != nullptr, the
// Jacobians d r / d pa and d r / d pb (row-major 3x3).
__device__ inline void residual(const float* pa, const float* pb, const float* rel, float tw,
                                float rw, float r[3], float* ja, float* jb) {
  float c = cosf(pa[2]), s = sinf(pa[2]);
  float dx = pb[0] - pa[0], dy = pb[1] - pa[1];
  r[0] = (c * dx + s * dy - rel[0]) * tw;
  r[1] = (-s * dx + c * dy - rel[1]) * tw;
  r[2] = wrap_angle(pb[2] - pa[2] - rel[2]) * rw;
  if (ja) {
    ja[0] = -c * tw; ja[1] = -s * tw; ja[2] = (-s * dx + c * dy) * tw;
    ja[3] = s * tw;  ja[4] = -c * tw; ja[5] = (-c * dx - s * dy) * tw;
    ja[6] = 0.0f;    ja[7] = 0.0f;    ja[8] = -rw;
    jb[0] = c * tw;  jb[1] = s * tw;  jb[2] = 0.0f;
    jb[3] = -s * tw; jb[4] = c * tw;  jb[5] = 0.0f;
    jb[6] = 0.0f;    jb[7] = 0.0f;    jb[8] = rw;
  }
}

__device__ inline float huber_weight(const float r[3], bool use_huber, float hs) {
  float s2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  return (use_huber && s2 > hs * hs) ? sqrtf(hs / sqrtf(fmaxf(s2, 1e-12f))) : 1.0f;
}

__device__ inline void add_jtj(float* dst, const float* x, const float* y) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      atomicAdd(&dst[3 * i + j], x[i] * y[j] + x[3 + i] * y[3 + j] + x[6 + i] * y[6 + j]);
}

__device__ inline void add_jtr(float* dst, const float* x, const float r[3]) {
  for (int i = 0; i < 3; ++i)
    atomicAdd(&dst[i], x[i] * r[0] + x[3 + i] * r[1] + x[6 + i] * r[2]);
}

__device__ inline void warp_add(float v, float* dst) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
}

__global__ void init_kernel(float* scal) { scal[2] = 1e-4f; }

// Cost terms and, with `assemble`, the normal-equation contributions.
__global__ void constraint_kernel(Problem p, Workspace w, const float* __restrict__ sub,
                                  const float* __restrict__ nod, bool assemble, float* cost) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  float sq = 0.0f;
  if (t < p.C) {
    int c = t;
    float* bc = w.Bc + 9 * c;
    if (p.valid[c]) {
      int a = p.a_idx[c], b = p.b_idx[c];
      float r[3], ja[9], jb[9];
      residual(sub + 3 * a, nod + 3 * b, p.rel + 3 * c, p.tw[c], p.rw[c], r,
               assemble ? ja : nullptr, jb);
      float hw = huber_weight(r, p.huber[c], p.huber_scale);
      for (int q = 0; q < 3; ++q) r[q] = r[q] * hw;
      sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      if (assemble) {
        for (int q = 0; q < 9; ++q) {
          ja[q] = ja[q] * hw;
          jb[q] = jb[q] * hw;
        }
        add_jtj(w.A + 9 * a, ja, ja);
        add_jtj(w.Td + 9 * b, jb, jb);
        add_jtr(w.g_s + 3 * a, ja, r);
        add_jtr(w.g_n + 3 * b, jb, r);
        bool coupled = !p.sub_fixed[a] && !p.node_fixed[b];
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) {
            float v = coupled ? ja[i] * jb[j] + ja[3 + i] * jb[3 + j] + ja[6 + i] * jb[6 + j]
                              : 0.0f;
            bc[3 * i + j] = v;
            // B^T block (node b row i, submap a column j) = Bc[j][i].
            if (coupled) atomicAdd(&w.X[((size_t)b * 3 + j) * p.K + 3 * a + i], v);
          }
      }
    } else if (assemble) {
      for (int q = 0; q < 9; ++q) bc[q] = 0.0f;
    }
  } else if (t < p.C + p.D) {
    int d = t - p.C;
    if (p.nn_valid[d]) {
      int j = p.j_idx[d], k = j + 1;
      float r[3], jj[9], jk[9];
      residual(nod + 3 * j, nod + 3 * k, p.nn_rel + 3 * d, p.nn_tw[d], p.nn_rw[d], r,
               assemble ? jj : nullptr, jk);
      sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      if (assemble) {
        add_jtj(w.Td + 9 * j, jj, jj);
        add_jtj(w.Td + 9 * k, jk, jk);
        add_jtj(w.To + 9 * j, jj, jk);
        add_jtr(w.g_n + 3 * j, jj, r);
        add_jtr(w.g_n + 3 * k, jk, r);
      }
    }
  }
  warp_add(sq, cost);
}

__global__ void damp_kernel(Problem p, Workspace w) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  float lam = w.scal[2];
  if (t < p.S) {
    bool fixed = p.sub_fixed[t];
    float* a = w.A + 9 * t;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        if (fixed) a[3 * i + j] = 0.0f;
      a[4 * i] = a[4 * i] + (fixed ? 1.0f : lam * fabsf(a[4 * i]) + p.damping);
      if (fixed) w.g_s[3 * t + i] = 0.0f;
    }
  } else if (t < p.S + p.N) {
    int n = t - p.S;
    bool fixed = p.node_fixed[n];
    bool couple = !fixed && n + 1 < p.N && !p.node_fixed[n + 1];
    float* d = w.Td + 9 * n;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        if (fixed) d[3 * i + j] = 0.0f;
        if (!couple) w.To[9 * n + 3 * i + j] = 0.0f;
      }
      d[4 * i] = d[4 * i] + (fixed ? 1.0f : lam * fabsf(d[4 * i]) + p.damping);
      float g = fixed ? 0.0f : w.g_n[3 * n + i];
      w.X[((size_t)n * 3 + i) * p.K + p.K - 1] = g;
    }
  }
}

// In-place inverse of a 3x3 matrix by Gauss-Jordan with partial pivoting.
__device__ void inverse3(const float m[9], float out[9]) {
  float a[3][6];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a[i][j] = m[3 * i + j];
      a[i][3 + j] = i == j ? 1.0f : 0.0f;
    }
  for (int col = 0; col < 3; ++col) {
    int piv = col;
    for (int r = col + 1; r < 3; ++r)
      if (fabsf(a[r][col]) > fabsf(a[piv][col])) piv = r;
    if (piv != col)
      for (int j = 0; j < 6; ++j) {
        float tmp = a[col][j];
        a[col][j] = a[piv][j];
        a[piv][j] = tmp;
      }
    float inv = 1.0f / a[col][col];
    for (int j = 0; j < 6; ++j) a[col][j] = a[col][j] * inv;
    for (int r = 0; r < 3; ++r) {
      if (r == col) continue;
      float f = a[r][col];
      for (int j = 0; j < 6; ++j) a[r][j] = a[r][j] - f * a[col][j];
    }
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = a[i][3 + j];
}

__global__ void factor_kernel(Problem p, Workspace w) {
  if (threadIdx.x != 0) return;
  float prev[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < p.N; ++i) {
    float c[9];
    const float* d = w.Td + 9 * i;
    for (int r = 0; r < 3; ++r)
      for (int q = 0; q < 3; ++q) {
        float v = d[3 * r + q];
        if (i > 0) {
          const float* u = w.To + 9 * (i - 1);  // L_i = To_{i-1}^T
          v = v - (u[r] * prev[q] + u[3 + r] * prev[3 + q] + u[6 + r] * prev[6 + q]);
        }
        c[3 * r + q] = v;
      }
    for (int r = 0; r < 3; ++r) c[4 * r] = c[4 * r] + kEps;
    float ci[9];
    inverse3(c, ci);
    const float* u = w.To + 9 * i;  // U_i = To_i (zero for the last node)
    for (int r = 0; r < 3; ++r)
      for (int q = 0; q < 3; ++q)
        prev[3 * r + q] = i + 1 < p.N
            ? ci[3 * r] * u[q] + ci[3 * r + 1] * u[3 + q] + ci[3 * r + 2] * u[6 + q]
            : 0.0f;
    for (int q = 0; q < 9; ++q) {
      w.Cinv[9 * i + q] = ci[q];
      w.CinvU[9 * i + q] = prev[q];
    }
  }
}

__global__ void sweep_kernel(Problem p, Workspace w) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  const size_t K = p.K;
  float y[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < p.N; ++i) {
    float* x = w.X + (size_t)i * 3 * K + k;
    float b[3] = {x[0], x[K], x[2 * K]};
    if (i > 0) {
      const float* u = w.To + 9 * (i - 1);
      for (int r = 0; r < 3; ++r) b[r] = b[r] - (u[r] * y[0] + u[3 + r] * y[1] + u[6 + r] * y[2]);
    }
    const float* ci = w.Cinv + 9 * i;
    for (int r = 0; r < 3; ++r) y[r] = ci[3 * r] * b[0] + ci[3 * r + 1] * b[1] + ci[3 * r + 2] * b[2];
    x[0] = y[0];
    x[K] = y[1];
    x[2 * K] = y[2];
  }
  float z[3] = {0.0f, 0.0f, 0.0f};
  for (int i = p.N - 1; i >= 0; --i) {
    float* x = w.X + (size_t)i * 3 * K + k;
    const float* cu = w.CinvU + 9 * i;
    float v[3];
    for (int r = 0; r < 3; ++r)
      v[r] = x[r * K] - (cu[3 * r] * z[0] + cu[3 * r + 1] * z[1] + cu[3 * r + 2] * z[2]);
    for (int r = 0; r < 3; ++r) {
      z[r] = v[r];
      x[r * K] = v[r];
    }
  }
}

__global__ void reduce_kernel(Problem p, Workspace w) {
  int c = blockIdx.x;
  if (!p.valid[c]) return;
  int a = p.a_idx[c], b = p.b_idx[c];
  if (p.sub_fixed[a] || p.node_fixed[b]) return;
  const float* bc = w.Bc + 9 * c;
  const size_t K = p.K;
  const float* x = w.X + (size_t)b * 3 * K;
  int n3 = 3 * p.S;
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) {
    float x0 = x[k], x1 = x[K + k], x2 = x[2 * K + k];
    for (int i = 0; i < 3; ++i) {
      float v = bc[3 * i] * x0 + bc[3 * i + 1] * x1 + bc[3 * i + 2] * x2;
      if (k < p.K - 1)
        atomicAdd(&w.M[(size_t)(3 * a + i) * n3 + k], v);
      else
        atomicAdd(&w.r[3 * a + i], v);
    }
  }
}

__global__ void cholesky_kernel(Problem p, Workspace w) {
  const int n = 3 * p.S;
  float* m = w.M;
  float* b = w.r;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    int r = idx / n, q = idx % n;
    float a = r / 3 == q / 3 ? w.A[9 * (r / 3) + 3 * (r % 3) + q % 3] : 0.0f;
    m[idx] = a - m[idx];
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) b[r] = -(w.g_s[r] - b[r]);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (threadIdx.x == 0) m[(size_t)k * n + k] = sqrtf(m[(size_t)k * n + k]);
    __syncthreads();
    float dkk = m[(size_t)k * n + k];
    for (int i = k + 1 + threadIdx.x; i < n; i += blockDim.x)
      m[(size_t)i * n + k] = m[(size_t)i * n + k] / dkk;
    __syncthreads();
    int rem = n - k - 1;
    for (int idx = threadIdx.x; idx < rem * rem; idx += blockDim.x) {
      int i = k + 1 + idx / rem, j = k + 1 + idx % rem;
      if (j <= i) m[(size_t)i * n + j] = m[(size_t)i * n + j] - m[(size_t)i * n + k] * m[(size_t)j * n + k];
    }
    __syncthreads();
  }
  for (int k = 0; k < n; ++k) {  // L y = b
    if (threadIdx.x == 0) b[k] = b[k] / m[(size_t)k * n + k];
    __syncthreads();
    for (int i = k + 1 + threadIdx.x; i < n; i += blockDim.x)
      b[i] = b[i] - m[(size_t)i * n + k] * b[k];
    __syncthreads();
  }
  for (int k = n - 1; k >= 0; --k) {  // L^T x = y
    if (threadIdx.x == 0) {
      b[k] = b[k] / m[(size_t)k * n + k];
      w.dx[k] = b[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) b[i] = b[i] - m[(size_t)k * n + i] * b[k];
    __syncthreads();
  }
}

__global__ void update_kernel(Problem p, Workspace w, const float* __restrict__ sub,
                              const float* __restrict__ nod) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.S) {
    float free = p.sub_fixed[t] ? 0.0f : 1.0f;
    for (int i = 0; i < 3; ++i) w.cand_sub[3 * t + i] = sub[3 * t + i] + w.dx[3 * t + i] * free;
  } else if (t < p.S + p.N) {
    int n = t - p.S;
    float free = p.node_fixed[n] ? 0.0f : 1.0f;
    const size_t K = p.K;
    for (int i = 0; i < 3; ++i) {
      const float* x = w.X + ((size_t)n * 3 + i) * K;
      float acc = 0.0f;
      for (int k = 0; k < p.K - 1; ++k) acc = acc + x[k] * w.dx[k];
      float d = -(x[p.K - 1] + acc);
      w.cand_nod[3 * n + i] = nod[3 * n + i] + d * free;
    }
  }
}

__global__ void accept_kernel(Problem p, Workspace w, float* sub, float* nod) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  float c0 = w.scal[0], c1 = w.scal[1];
  bool accept = isfinite(c1) && c1 <= c0;
  if (accept) {
    if (t < p.S) {
      for (int i = 0; i < 3; ++i) sub[3 * t + i] = w.cand_sub[3 * t + i];
    } else if (t < p.S + p.N) {
      int n = t - p.S;
      for (int i = 0; i < 3; ++i) nod[3 * n + i] = w.cand_nod[3 * n + i];
    }
  }
  if (t == 0) {
    float lam = accept ? w.scal[2] / 3.0f : w.scal[2] * 8.0f;
    w.scal[2] = fminf(fmaxf(lam, 1e-8f), 1e8f);
  }
}

inline int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" int schur_spa_2d(void* sub, void* nod, int S, int N, const void* a_idx,
                            const void* b_idx, const void* rel, const void* tw, const void* rw,
                            const void* huber, const void* valid, int C, const void* j_idx,
                            const void* nn_rel, const void* nn_tw, const void* nn_rw,
                            const void* nn_valid, int D, const void* sub_fixed,
                            const void* node_fixed, int num_iterations, float huber_scale,
                            float damping, void* workspace, long long workspace_floats,
                            void* stream) {
  Problem p;
  p.S = S; p.N = N; p.C = C; p.D = D; p.K = 3 * S + 1;
  p.a_idx = (const int*)a_idx; p.b_idx = (const int*)b_idx;
  p.rel = (const float*)rel; p.tw = (const float*)tw; p.rw = (const float*)rw;
  p.huber = (const uint8_t*)huber; p.valid = (const uint8_t*)valid;
  p.j_idx = (const int*)j_idx; p.nn_rel = (const float*)nn_rel;
  p.nn_tw = (const float*)nn_tw; p.nn_rw = (const float*)nn_rw;
  p.nn_valid = (const uint8_t*)nn_valid;
  p.sub_fixed = (const uint8_t*)sub_fixed; p.node_fixed = (const uint8_t*)node_fixed;
  p.huber_scale = huber_scale;
  p.damping = damping;

  const long long K = p.K;
  long long zeroed = 9LL * S + 9LL * N + 9LL * N + 3LL * S + 3LL * N + 3LL * N * K +
                     9LL * S * S + 3LL * S;
  long long needed = zeroed + 8 + 9LL * N + 9LL * N + 9LL * C + 3LL * S + 3LL * S + 3LL * N;
  if (workspace_floats < needed || S <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  Workspace w;
  float* f = (float*)workspace;
  w.A = f; f += 9LL * S;
  w.Td = f; f += 9LL * N;
  w.To = f; f += 9LL * N;
  w.g_s = f; f += 3LL * S;
  w.g_n = f; f += 3LL * N;
  w.X = f; f += 3LL * N * K;
  w.M = f; f += 9LL * S * S;
  w.r = f; f += 3LL * S;
  w.scal = f; f += 8;
  w.Cinv = f; f += 9LL * N;
  w.CinvU = f; f += 9LL * N;
  w.Bc = f; f += 9LL * C;
  w.dx = f; f += 3LL * S;
  w.cand_sub = f; f += 3LL * S;
  w.cand_nod = f;

  cudaStream_t s = (cudaStream_t)stream;
  float* psub = (float*)sub;
  float* pnod = (float*)nod;
  int cons_blocks = blocks_for((long long)C + D, kThreads);
  int slot_blocks = blocks_for((long long)S + N, kThreads);
  init_kernel<<<1, 1, 0, s>>>(w.scal);
  for (int it = 0; it < num_iterations; ++it) {
    cudaMemsetAsync(w.A, 0, zeroed * sizeof(float), s);
    cudaMemsetAsync(w.scal, 0, 2 * sizeof(float), s);
    if (cons_blocks > 0)
      constraint_kernel<<<cons_blocks, kThreads, 0, s>>>(p, w, psub, pnod, true, w.scal);
    damp_kernel<<<slot_blocks, kThreads, 0, s>>>(p, w);
    factor_kernel<<<1, 32, 0, s>>>(p, w);
    sweep_kernel<<<blocks_for(K, 64), 64, 0, s>>>(p, w);
    if (C > 0) reduce_kernel<<<C, 128, 0, s>>>(p, w);
    cholesky_kernel<<<1, 1024, 0, s>>>(p, w);
    update_kernel<<<slot_blocks, kThreads, 0, s>>>(p, w, psub, pnod);
    if (cons_blocks > 0)
      constraint_kernel<<<cons_blocks, kThreads, 0, s>>>(p, w, w.cand_sub, w.cand_nod, false,
                                                         w.scal + 1);
    accept_kernel<<<slot_blocks, kThreads, 0, s>>>(p, w, psub, pnod);
  }
  return (int)cudaGetLastError();
}
