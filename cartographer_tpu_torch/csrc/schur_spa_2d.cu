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
//             constraint and scattered transposed into the band solve's
//             right-hand sides [B^T | g_n] (N, 3, 3S+1); the cost at x.
//   damp      one thread per slot: frozen slots get zero rows and columns
//             and a unit diagonal, free ones lambda * |diag| + damping.
//   band      T X = [B^T | g_n] over the N 3x3 node blocks by block cyclic
//             reduction (Band, below), in place of _block_tridiag_factor and
//             _tridiag_solve_multi's Thomas chain: ceil(log2 N) levels down
//             and as many back up, each one launch over its blocks and
//             column tiles, so the dependent depth is 2 ceil(log2 N) + 1
//             launches (25 at N = 4,096) where the chain was 2N steps on
//             one thread. Each pivot, plus 1e-9 I as JAX adds to each Thomas
//             pivot, is inverted by its adjugate in registers by every
//             thread that needs it (T is symmetric positive definite under
//             the damping); the right-hand sides are read along X's
//             columns, a thread per column. It solves the same system as the
//             twin's Thomas chain in another order of float32 operations:
//             the twin's tolerance holds the result.
//   reduce    B X and B y into the reduced system without atomics: the
//             constraints grouped by submap slot once per call, a block per
//             piece of 64 and column tile, then a block per slot and tile
//             adds its pieces in order (csrc/schur_reduced.cuh, shared with
//             K16: a fixed order from run to run).
//   cholesky  the 3S x 3S system blockdiag(A) - B X, augmented with its
//             right-hand side, factored by panels of 32 columns and solved
//             in one thread-block cluster, K16's (schur_reduced.cuh: 8
//             blocks at 3S = 192, its rows in their shared memory; alone,
//             one block took 0.26-0.27 ms there against the cluster's
//             0.16-0.17 on an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md);
//             a system that is not positive definite yields NaN, and the
//             step is then rejected.
//   update    dx_n = -(y + X dx_s), a warp per node along X's row, and the
//             candidate poses.
//   cost      the cost at the candidate.
//   accept    finite and not larger: take the candidate, lambda / 3; else
//             keep the poses, lambda * 8; lambda within [1e-8, 1e8].
// The assembly's atomics order its sums differently from run to run: the
// result agrees with the plain twin to a tolerance, not bit for bit.
//
// Bound: latency. At capacity (N = 4096 nodes, S = 64 submaps, C = 16,384
// constraints) an iteration moves some 30 MB and does some 0.1 GFLOP, tens of
// microseconds of either. On an NVIDIA H100 80GB HBM3 at 700.00 W the former
// form spent 3.215 of its 7.702 ms an iteration in a one-thread factor chain
// over the nodes, 3.296 in the one-thread-per-column sweep and 1.052 in a
// one-block Cholesky in device memory; this one spends 0.467-0.469 ms of
// kernels in 33 launches: the band 0.172, the reduced Cholesky's one-warp
// chains 0.106-0.107, the assembly and costs 0.047 (PERF.md row 11).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "schur_reduced.cuh"

namespace {

constexpr float kPi = 3.14159274101257324f;     // float32(pi)
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kEps = 1e-9f;
constexpr int kThreads = 256;
constexpr int kBandThreads = 256;  // a block's threads (columns) in the band's launches, at most

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
  float* scal;  // [0] cost at x, [1] cost at the candidate, [2] lambda
  float* panels;  // the reduced Cholesky's panel buffers where shared memory cannot hold them
  float* Bc;
  int *ae, *be;  // per constraint: its slot (< 0: the coupling is zero) and node
  float *dx, *cand_sub, *cand_nod;
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
        w.ae[c] = coupled ? a : -1;
        w.be[c] = b;
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
      w.ae[c] = -1;
      w.be[c] = 0;
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

// ------------------------------------------------------------ the node band

// Block cyclic reduction of T X = [B^T | g_n] over the n = N node blocks
// (3x3). Level l (stride s = 2^l) holds the blocks whose index is a multiple
// of s: D^(l)_i on the diagonal and U^(l)_i coupling i to i + s (U^(0) = To).
// While more than one block is left, the odd ones of the level (i = s mod
// 2s) are eliminated: x_j = y_j - G_j x_{j-s} - H_j x_{j+s} with
// Dinv_j = (D_j + 1e-9 I)^-1, G_j = Dinv_j U_{j-s}^T, H_j = Dinv_j U_j and
// y_j = Dinv_j b_j; each even one i takes D_i - U_{i-s}^T H_{i-s} - U_i
// G_{i+s}, b_i - U_{i-s}^T y_{i-s} - U_i y_{i+s} and, to i + 2s, the
// coupling -U_i H_{i+s}. The last block (index 0) is eliminated with no
// neighbours, so its y is its x; back up the levels each eliminated block
// then takes its x from its neighbours'. A block past the end is zero. The
// plain form, level by level in this order: parallel/schur_spa.py
// cyclic_reduction_solve.
struct Band {
  int n;        // node blocks
  float* D[2];  // D^(l) by the parity of l, l >= 1
  float* U[2];  // U^(l) by the parity of l, l >= 1
  float* G;     // per eliminated block
  float* H;
};

__device__ inline void load3x3(const float* src, bool in, float* out) {
#pragma unroll
  for (int e = 0; e < 9; ++e) out[e] = in ? src[e] : 0.0f;
}

// Block k's diagonal at `level`.
__device__ inline const float* d_at(const Workspace& w, const Band& b, int level, int k) {
  return (level == 0 ? w.Td : b.D[level & 1]) + 9 * (size_t)k;
}
// U^(level)_k, or null where k or k + 2^level lies outside the band.
__device__ inline const float* u_at(const Workspace& w, const Band& b, int level, int k) {
  if (k < 0 || k + (1 << level) >= b.n) return nullptr;
  return (level == 0 ? w.To : b.U[level & 1]) + 9 * (size_t)k;
}

// out = (a + 1e-9 I)^-1 by the adjugate.
__device__ inline void inverse3(const float* a, float* out) {
  const float m0 = a[0] + kEps, m4 = a[4] + kEps, m8 = a[8] + kEps;
  const float c00 = m4 * m8 - a[5] * a[7];
  const float c01 = a[5] * a[6] - a[3] * m8;
  const float c02 = a[3] * a[7] - m4 * a[6];
  const float inv = 1.0f / (m0 * c00 + a[1] * c01 + a[2] * c02);
  out[0] = c00 * inv;
  out[1] = (a[2] * a[7] - a[1] * m8) * inv;
  out[2] = (a[1] * a[5] - a[2] * m4) * inv;
  out[3] = c01 * inv;
  out[4] = (m0 * m8 - a[2] * a[6]) * inv;
  out[5] = (a[2] * a[3] - m0 * a[5]) * inv;
  out[6] = c02 * inv;
  out[7] = (a[1] * a[6] - m0 * a[7]) * inv;
  out[8] = (m0 * m4 - a[1] * a[3]) * inv;
}

// G_k = dinv ul^T and H_k = dinv ur of eliminated block k, an element a
// thread for the first 9 threads of the first column tile.
__device__ inline void write_gh(const Band& b, int k, const float* dinv, const float* ul,
                                const float* ur) {
  if (blockIdx.y != 0 || threadIdx.x >= 9) return;
  const int r = threadIdx.x / 3, c = threadIdx.x % 3;
  float g = 0.0f, h = 0.0f;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    g = g + dinv[3 * r + m] * ul[3 * c + m];
    h = h + dinv[3 * r + m] * ur[3 * m + c];
  }
  b.G[9 * (size_t)k + threadIdx.x] = g;
  b.H[9 * (size_t)k + threadIdx.x] = h;
}

// This thread's column of X (blockIdx.y's tile), or K and beyond.
__device__ inline int band_column() { return blockIdx.y * blockDim.x + threadIdx.x; }

// Level 0's eliminations: the odd blocks (block 0 where it is the only one).
__global__ void __launch_bounds__(kBandThreads) band_first_kernel(Problem p, Workspace w, Band b) {
  const int j = b.n == 1 ? 0 : 2 * blockIdx.x + 1;
  const float* ul_p = u_at(w, b, 0, j - 1);
  const float* ur_p = u_at(w, b, 0, j);
  float d[9], ul[9], ur[9], dinv[9];
  load3x3(d_at(w, b, 0, j), true, d);
  load3x3(ul_p, ul_p != nullptr, ul);
  load3x3(ur_p, ur_p != nullptr, ur);
  inverse3(d, dinv);
  write_gh(b, j, dinv, ul, ur);
  const int c = band_column();
  if (c >= p.K) return;
  const size_t K = p.K;
  float* x = w.X + 3 * (size_t)j * K + c;
  const float v[3] = {x[0], x[K], x[2 * K]};
#pragma unroll
  for (int r = 0; r < 3; ++r)
    x[r * K] = dinv[3 * r] * v[0] + dinv[3 * r + 1] * v[1] + dinv[3 * r + 2] * v[2];
}

// The even blocks of `level`: their updates from the odd neighbours, then,
// for those the next level eliminates, their elimination.
__global__ void __launch_bounds__(kBandThreads)
    band_level_kernel(Problem p, Workspace w, Band b, int level) {
  __shared__ float dn[9], uin[9], uln[9];
  const int s = 1 << level;
  const int i = blockIdx.x * 2 * s, jl = i - s, jr = i + s;
  const bool has_l = i > 0, has_r = jr < b.n;
  const float* ul_p = u_at(w, b, level, jl);    // couples i - s to i
  const float* ui_p = u_at(w, b, level, i);     // couples i to i + s
  const float* ull_p = u_at(w, b, level, i - 2 * s);
  float ul[9], ui[9];
  load3x3(ul_p, ul_p != nullptr, ul);
  load3x3(ui_p, ui_p != nullptr, ui);
  if (threadIdx.x < 9) {
    const int r = threadIdx.x / 3, c = threadIdx.x % 3;
    float hl[9], gr[9], hr[9], ull[9];
    load3x3(b.H + 9 * (size_t)jl, has_l, hl);
    load3x3(b.G + 9 * (size_t)jr, has_r, gr);
    load3x3(b.H + 9 * (size_t)jr, has_r, hr);
    load3x3(ull_p, ull_p != nullptr, ull);
    float v = d_at(w, b, level, i)[threadIdx.x], un = 0.0f, ln = 0.0f;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      v = v - ul[3 * m + r] * hl[3 * m + c];
      v = v - ui[3 * r + m] * gr[3 * m + c];
      un = un - ui[3 * r + m] * hr[3 * m + c];
      ln = ln - ull[3 * r + m] * hl[3 * m + c];
    }
    dn[threadIdx.x] = v;
    uin[threadIdx.x] = un;
    uln[threadIdx.x] = ln;
    if (blockIdx.y == 0) {
      b.D[(level + 1) & 1][9 * (size_t)i + threadIdx.x] = v;
      b.U[(level + 1) & 1][9 * (size_t)i + threadIdx.x] = un;
    }
  }
  __syncthreads();
  const int next = 2 * s;
  const bool eliminated = (b.n + next - 1) / next == 1 ? i == 0 : i % (2 * next) == next;
  float dinv[9];
  if (eliminated) {
    inverse3(dn, dinv);
    write_gh(b, i, dinv, uln, uin);
  }
  const int c = band_column();
  if (c >= p.K) return;
  const size_t K = p.K;
  float* x = w.X + 3 * (size_t)i * K + c;
  float v[3] = {x[0], x[K], x[2 * K]}, yl[3] = {0.0f, 0.0f, 0.0f}, yr[3] = {0.0f, 0.0f, 0.0f};
  if (has_l) {
    const float* xl = w.X + 3 * (size_t)jl * K + c;
    for (int m = 0; m < 3; ++m) yl[m] = xl[m * K];
  }
  if (has_r) {
    const float* xr = w.X + 3 * (size_t)jr * K + c;
    for (int m = 0; m < 3; ++m) yr[m] = xr[m * K];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float t = v[r];
#pragma unroll
    for (int m = 0; m < 3; ++m) t = t - ul[3 * m + r] * yl[m] - ui[3 * r + m] * yr[m];
    v[r] = t;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    x[r * K] = eliminated ? dinv[3 * r] * v[0] + dinv[3 * r + 1] * v[1] + dinv[3 * r + 2] * v[2]
                          : v[r];
}

// Back up `level`: each block it eliminated takes x_j = y_j - G_j x_{j-s} -
// H_j x_{j+s}.
__global__ void __launch_bounds__(kBandThreads)
    band_back_kernel(Problem p, Workspace w, Band b, int level) {
  const int s = 1 << level;
  const int j = s + blockIdx.x * 2 * s;
  const bool has_r = j + s < b.n;
  float g[9], h[9];
  load3x3(b.G + 9 * (size_t)j, true, g);
  load3x3(b.H + 9 * (size_t)j, has_r, h);
  const int c = band_column();
  if (c >= p.K) return;
  const size_t K = p.K;
  float* x = w.X + 3 * (size_t)j * K + c;
  const float* xl = w.X + 3 * (size_t)(j - s) * K + c;
  float xr[3] = {0.0f, 0.0f, 0.0f};
  if (has_r)
    for (int m = 0; m < 3; ++m) xr[m] = w.X[(3 * (size_t)(j + s) + m) * K + c];
  const float v[3] = {x[0], x[K], x[2 * K]}, vl[3] = {xl[0], xl[K], xl[2 * K]};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float t = v[r];
#pragma unroll
    for (int m = 0; m < 3; ++m) t = t - g[3 * r + m] * vl[m] - h[3 * r + m] * xr[m];
    x[r * K] = t;
  }
}

// ------------------------------------------------------------ update, accept

// The candidate: submap slot t moved by its part of dx, node n by dx_n =
// -(y + X dx_s), a warp per node with its lanes along X's row.
__global__ void update_kernel(Problem p, Workspace w, const float* __restrict__ sub,
                              const float* __restrict__ nod) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.S) {
    const float free = p.sub_fixed[t] ? 0.0f : 1.0f;
    for (int i = 0; i < 3; ++i) w.cand_sub[3 * t + i] = sub[3 * t + i] + w.dx[3 * t + i] * free;
  }
  const int n = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= p.N) return;  // whole warps leave together
  const size_t K = p.K;
  const float free = p.node_fixed[n] ? 0.0f : 1.0f;
  for (int i = 0; i < 3; ++i) {
    const float* x = w.X + ((size_t)n * 3 + i) * K;
    float acc = 0.0f;
    for (int k = lane; k < p.K - 1; k += 32) acc = acc + x[k] * w.dx[k];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) w.cand_nod[3 * n + i] = nod[3 * n + i] + -(x[p.K - 1] + acc) * free;
  }
}

__global__ void accept_kernel(Problem p, Workspace w, float* sub, float* nod, float* history) {
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
    if (history) {
      history[0] = c0;
      history[1] = c1;
      history[2] = accept ? 1.0f : 0.0f;
      history[3] = w.scal[2];
    }
  }
}

inline int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

// The reduced system of p.S slots in w's A, g_s, M, r, panels and dx.
inline schur::System reduced_system(const Problem& p, const Workspace& w) {
  return schur::System{3 * p.S, 3, w.A, w.g_s, w.M, w.panels, w.dx};
}

}  // namespace

// The problem's device pointers as their names say (parallel/schur_spa.py
// SchurSpaProblem2D); sub and nod (the state) are optimized in place.
// order, slot_start, piece_start (int32: (C,), (S + 1,), (S + 1,)) are the
// constraints grouped by submap slot, max_pieces at least the number of
// pieces of schur::kPiece constraints the grouping makes. `history` (device,
// may be null) takes per iteration the cost at x, the cost at the
// candidate, the accept flag and the new lambda.
extern "C" int schur_spa_2d(void* sub, void* nod, int S, int N, const void* a_idx,
                            const void* b_idx, const void* rel, const void* tw, const void* rw,
                            const void* huber, const void* valid, int C, const void* j_idx,
                            const void* nn_rel, const void* nn_tw, const void* nn_rw,
                            const void* nn_valid, int D, const void* sub_fixed,
                            const void* node_fixed, const void* order, const void* slot_start,
                            const void* piece_start, int max_pieces, int num_iterations,
                            float huber_scale, float damping, void* workspace,
                            long long workspace_floats, void* history, void* stream) {
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

  const long long K = p.K, n3 = 3LL * S;
  const long long zeroed = 9LL * S + 9LL * N + 9LL * N + 3LL * S + 3LL * N + 3LL * N * K +
                           9LL * S * S + 3LL * S;
  const long long needed = zeroed + 8 + 6 * 9LL * N + 9LL * C + 2LL * C + 3LL * S + 3LL * S +
                           3LL * N + (long long)schur::kMaxCluster * schur::kPanel * (n3 + 1) +
                           (long long)max_pieces * 3 * K;
  if (workspace_floats < needed || S <= 0 || N <= 0 || max_pieces < 0)
    return (int)cudaErrorInvalidValue;
  Workspace w;
  Band b;
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
  for (int i = 0; i < 2; ++i) {
    b.D[i] = f; f += 9LL * N;
    b.U[i] = f; f += 9LL * N;
  }
  b.G = f; f += 9LL * N;
  b.H = f; f += 9LL * N;
  w.Bc = f; f += 9LL * C;
  w.ae = (int*)f; f += C;
  w.be = (int*)f; f += C;
  w.dx = f; f += 3LL * S;
  w.cand_sub = f; f += 3LL * S;
  w.cand_nod = f; f += 3LL * N;
  w.panels = f; f += (long long)schur::kMaxCluster * schur::kPanel * (n3 + 1);
  schur::SlotReduce<3> g;
  g.S = S;
  g.K = p.K;
  g.Bc = w.Bc;
  g.ae = w.ae;
  g.be = w.be;
  g.X = w.X;
  g.order = (const int*)order;
  g.slot_start = (const int*)slot_start;
  g.piece_start = (const int*)piece_start;
  g.partial = f;
  g.M = w.M;

  b.n = N;
  int levels = 0;  // ceil(log2 n)
  while ((1ll << levels) < N) ++levels;
  // A thread per column of X, whole warps, up to kBandThreads a block: one
  // column tile up to S = 85, so each block's 3x3 work is done once.
  const int band_threads = (int)(K < kBandThreads ? (K + 31) / 32 * 32 : kBandThreads);
  const unsigned tiles = (unsigned)((K + band_threads - 1) / band_threads);

  cudaStream_t s = (cudaStream_t)stream;
  float* psub = (float*)sub;
  float* pnod = (float*)nod;
  const int cons_blocks = blocks_for((long long)C + D, kThreads);
  const int slot_blocks = blocks_for((long long)S + N, kThreads);
  const int update_blocks = blocks_for(S > 32LL * N ? S : 32LL * N, kThreads);  // a warp a node
  init_kernel<<<1, 1, 0, s>>>(w.scal);
  for (int it = 0; it < num_iterations; ++it) {
    cudaMemsetAsync(w.A, 0, zeroed * sizeof(float), s);
    cudaMemsetAsync(w.scal, 0, 2 * sizeof(float), s);
    if (cons_blocks > 0)
      constraint_kernel<<<cons_blocks, kThreads, 0, s>>>(p, w, psub, pnod, true, w.scal);
    damp_kernel<<<slot_blocks, kThreads, 0, s>>>(p, w);
    band_first_kernel<<<dim3(N == 1 ? 1 : N / 2, tiles), band_threads, 0, s>>>(p, w, b);
    for (int l = 0; l < levels; ++l) {
      const int stride = 2 << l;
      band_level_kernel<<<dim3((N + stride - 1) / stride, tiles), band_threads, 0, s>>>(p, w, b,
                                                                                        l);
    }
    for (int l = levels - 1; l >= 0; --l) {
      const int step = 1 << l;
      band_back_kernel<<<dim3((N + step - 1) / (2 * step), tiles), band_threads, 0, s>>>(p, w, b,
                                                                                         l);
    }
    if (C > 0) schur::launch_slot_reduce(g, max_pieces, s);
    const cudaError_t err = schur::launch_cholesky(reduced_system(p, w), 0, s);
    if (err != cudaSuccess) return (int)err;
    update_kernel<<<update_blocks, kThreads, 0, s>>>(p, w, psub, pnod);
    if (cons_blocks > 0)
      constraint_kernel<<<cons_blocks, kThreads, 0, s>>>(p, w, w.cand_sub, w.cand_nod, false,
                                                         w.scal + 1);
    accept_kernel<<<slot_blocks, kThreads, 0, s>>>(
        p, w, psub, pnod, history ? (float*)history + 4 * it : nullptr);
  }
  return (int)cudaGetLastError();
}

// The reduced system's Cholesky solve alone (schur::cholesky_kernel as K8
// runs it, in a cluster of schur::cholesky_blocks(n)): x = P^-1 b of the
// symmetric positive definite P (n rows, its lower triangle read) given as
// `system` (n + 1, n) = [-P; b]; `panels` holds schur::kMaxCluster x 32 x
// (n + 1) floats; `zeros` 2n zero floats (the kernel's A, read as its
// diagonal, and g_s). `system` is overwritten where the cluster's shared
// memory cannot hold the rows.
extern "C" int schur_spa_2d_reduced_cholesky(int n, void* system, void* zeros, void* panels,
                                             void* x, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const schur::System sys{n, 1, (const float*)zeros, (const float*)zeros + n, (float*)system,
                          (float*)panels, (float*)x};
  return (int)schur::launch_cholesky(sys, 0, (cudaStream_t)stream);
}
