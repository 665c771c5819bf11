// K16 schur_spa_3d
//
// Replaces: cartographer_tpu/parallel/schur_spa_3d.py:solve_spa_3d_schur
// (l.529) through _solver_fn (l.356): _assemble_local (l.198) over the four
// residual families of ops/spa_3d.py (constraint_residual_3d l.110,
// rotation_residual_3d l.98, acceleration_residual_3d l.78) through the
// retractions _bin_local, _rot_local, _acc_local (l.131-151), the Huber
// weights (l.154), the 12x12 block LU _block_tridiag_factor (l.316), the
// multi-RHS sweep _tridiag_solve_multi (l.334), the reduced Cholesky solve
// and the Levenberg-Marquardt accept/reject with the gravity clamp
// (l.380-505), on one device.
//
// One call runs every iteration: the host enqueues the launches of all
// iterations at once and lambda, the costs and the accept decision live in
// device memory, so the solve needs no host synchronisation (the JAX form
// is one lax.scan). Per iteration:
//   assemble  one thread per term of each family (binary reduced-node,
//             node-node, gyro rotation, acceleration triplet): the residual
//             and its Jacobians at zero tangent, the Huber IRLS weight on
//             the flagged binary terms, atomically added into A (S,6,6),
//             the node band d0/u1/u2 (N,6,6), g_s, g_n. The Jacobians are
//             jacfwd's: each tangent argument in turn carries a 6-component
//             dual number through the retraction q exp(d) (whose value and
//             derivative at d = 0 are [1, 0.5 d]), the normalisation, the
//             quaternion products and the log map (hemisphere flip, small-
//             angle branch below |v|^2 = 1e-12). The coupling blocks
//             B = J_reduced^T J_node, masked by the free dims, are kept per
//             entry (E = C + 2R + 3A) and scattered transposed into the
//             band solve's right-hand sides [B^T | g_n] (N, 6, 6S+1).
//   cost      the cost at x (no retraction, as _cost_local).
//   damp      one thread per slot: frozen dims get zero rows and columns
//             and a unit diagonal, free ones lambda |diag| + damping.
//   band      T X = [B^T | g_n] over the 12x12 super-blocks of node pairs
//             (2k, 2k+1) by block cyclic reduction (Band, below), in place
//             of _block_tridiag_factor and _tridiag_solve_multi's Thomas
//             chain: ceil(log2(N/2)) levels down and as many back up, each
//             one launch over its blocks and column tiles, so the dependent
//             depth is 2 ceil(log2(N/2)) + 1 launches (23 at N = 4,096)
//             where the chain was 4,096 steps in one block. Each pivot,
//             plus 1e-9 I as JAX adds to each Thomas pivot, is inverted by
//             one warp in registers (Gauss-Jordan without pivot search: T is
//             symmetric positive definite under the damping); its 12 x K
//             right-hand-side rows are read along X's columns, a thread per
//             column. It solves the same system as the twin's Thomas chain
//             in another order of float32 operations: the twin's tolerance
//             holds the result.
//   reduce    B X and B y into the reduced system without atomics: the
//             entries grouped by slot once per call, a block per piece of
//             64 entries and column tile, then a block per slot and tile
//             adds its pieces in order (a fixed order from run to run;
//             csrc/schur_reduced.cuh, shared with K8, as the Cholesky).
//   cholesky  the 6S x 6S system blockdiag(A) - B X, augmented with its
//             right-hand side, in one thread-block cluster (up to 16
//             blocks, its rows in their shared memory where they fit: at
//             S = 64, 590 KB over 16 blocks), factored by panels of 32
//             columns with one cluster barrier per panel, the forward
//             substitution riding along as the last row, then the back
//             substitution by panels; a system that is not positive
//             definite yields NaN, and the step is then rejected.
//   update    dx_n = -(y + X dx_s) (a warp per node along X's row), the
//             retraction of every slot and the gravity clamp.
//   cost      the cost at the candidate.
//   accept    finite and not larger: take the candidate, lambda / 3; else
//             keep the state, lambda * 8; lambda within [1e-8, 1e8].
// The assembly's atomics order its sums differently from run to run: the
// result agrees with the plain twin to a tolerance, not bit for bit.
//
// Bound: latency. At capacity (N = 4096 nodes, S = 64 reduced slots,
// C = 16,384 binary terms, 4,095 gyro and 4,094 acceleration terms) an
// iteration moves some 70 MB (the right-hand sides are 4096 x 6 x 385
// floats) and does some 0.5 GFLOP (the cyclic reduction about twice the
// Thomas chain's band work). The former form spent 16.4 of its 27.5 ms an
// iteration in the one-block factor chain, 7.0 in the one-block Cholesky
// and 3.2 in the sweep; this one takes about 1.1 ms: the cluster's 12
// panel steps 0.40 (each block reads each panel from the cluster), the
// band's 23 dependent launches 0.27, the assembly's atomics 0.23 and B X
// 0.15, which reads X once per entry (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "schur_reduced.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-9f;
constexpr int kBandThreads = 128;  // a block's threads in the band's launches
constexpr int kWideLaunch = 264;   // blocks from which a level launch takes no column tiles

struct Problem {
  int S, N, C, D, R, A, E, K, N2;
  const int* a_idx;
  const int* b_idx;
  const float* rel_t;
  const float* rel_q;
  const float* tw;
  const float* rw;
  const uint8_t* huber;
  const uint8_t* valid;
  const int* j_idx;
  const float* nn_rel_t;
  const float* nn_rel_q;
  const float* nn_tw;
  const float* nn_rw;
  const uint8_t* nn_valid;
  const int* rot_i;
  const int* rot_traj;
  const float* rot_dq;
  const float* rot_w;
  const uint8_t* rot_valid;
  const int* acc_i;
  const int* acc_traj;
  const float* acc_dv;
  const float* acc_dt1;
  const float* acc_dt2;
  const float* acc_w;
  const uint8_t* acc_valid;
  const uint8_t* sub_free;   // (S, 6)
  const uint8_t* node_free;  // (N, 6)
  const uint8_t* grav_clamp;
  float huber_scale;
  float damping;
};

struct State {
  float *s_t, *s_q, *n_t, *n_q;
};

struct Workspace {
  float *A, *d0, *u1, *u2, *g_s, *g_n, *X, *M, *r;  // zeroed every iteration, in this order
  float* scal;  // [0] cost at x, [1] cost at the candidate, [2] lambda
  float* panels;  // the reduced Cholesky's panel buffers where shared memory cannot hold them
  float* Bc;
  int *ae, *be;  // ae < 0: the entry is zero
  float* dx;
  State cand;
};

// ------------------------------------------------------------ dual numbers

struct Dual {
  float v;
  float d[6];
};

__device__ inline Dual mk(float v) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = 0.0f;
  return r;
}
__device__ inline Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ inline Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ inline Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = -a.d[i];
  return r;
}
__device__ inline Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ inline Dual operator*(float s, const Dual& a) {
  Dual r;
  r.v = s * a.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = s * a.d[i];
  return r;
}
__device__ inline Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
__device__ inline Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
  float h = 0.5f / r.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] * h;
  return r;
}
__device__ inline Dual datan2(const Dual& y, const Dual& x) {
  Dual r;
  r.v = atan2f(y.v, x.v);
  float den = x.v * x.v + y.v * y.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) / den;
  return r;
}

// Quaternions (w, x, y, z) and vectors of duals.
__device__ inline void qmul(const Dual* a, const Dual* b, Dual* o) {
  Dual w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  Dual x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  Dual y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  Dual z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w;
  o[1] = x;
  o[2] = y;
  o[3] = z;
}
__device__ inline void qconj(const Dual* q, Dual* o) {
  o[0] = q[0];
  o[1] = -q[1];
  o[2] = -q[2];
  o[3] = -q[3];
}
__device__ inline void qrotate(const Dual* q, const Dual* v, Dual* o) {
  Dual tx = 2.0f * (q[2] * v[2] - q[3] * v[1]);
  Dual ty = 2.0f * (q[3] * v[0] - q[1] * v[2]);
  Dual tz = 2.0f * (q[1] * v[1] - q[2] * v[0]);
  o[0] = v[0] + q[0] * tx + (q[2] * tz - q[3] * ty);
  o[1] = v[1] + q[0] * ty + (q[3] * tx - q[1] * tz);
  o[2] = v[2] + q[0] * tz + (q[1] * ty - q[2] * tx);
}
__device__ inline void qnormalize(Dual* q) {
  Dual n = dsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}
// Log map: angle in [0, pi], the small branch below |v|^2 = 1e-12.
__device__ inline void to_axis_angle(const Dual* qin, Dual* o) {
  Dual q[4];
  bool flip = qin[0].v < 0.0f;
  for (int i = 0; i < 4; ++i) q[i] = flip ? -qin[i] : qin[i];
  Dual w = q[0];
  if (w.v > 1.0f || w.v < -1.0f) w = mk(fminf(fmaxf(w.v, -1.0f), 1.0f));
  Dual vsq = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  Dual scale;
  if (vsq.v < 1e-12f) {
    scale = w.v > 1e-12f ? mk(2.0f) / w : mk(2.0f / 1e-12f);
  } else {
    Dual vn = dsqrt(vsq);
    scale = (2.0f * datan2(vn, w)) / vn;
  }
  for (int i = 0; i < 3; ++i) o[i] = scale * q[1 + i];
}
// The retraction q exp(d) at d = 0, normalised; with `seeded` the tangent
// d[3:6] carries the dual's components 3..5 (exp(d) = [1, 0.5 d] there).
__device__ inline void retract_q(const float* q, bool seeded, Dual* o) {
  Dual a[4], e[4];
  for (int i = 0; i < 4; ++i) a[i] = mk(q[i]);
  e[0] = mk(1.0f);
  for (int i = 0; i < 3; ++i) {
    e[1 + i] = mk(0.0f);
    if (seeded) e[1 + i].d[3 + i] = 0.5f;
  }
  qmul(a, e, o);
  qnormalize(o);
}
__device__ inline void plain_q(const float* q, Dual* o) {
  for (int i = 0; i < 4; ++i) o[i] = mk(q[i]);
}
__device__ inline void trans(const float* t, bool seeded, Dual* o) {
  for (int i = 0; i < 3; ++i) {
    o[i] = mk(t[i]);
    if (seeded) o[i].d[i] = 1.0f;
  }
}

// seed < 0: the residual at the state (no retraction, as _cost_local);
// else the residual through the retraction with the tangent `seed` carried.
__device__ void bin_residual(const float* ta, const float* qa, const float* tb, const float* qb,
                             const float* rel_t, const float* rel_q, float tw, float rw,
                             int seed, Dual* r) {
  Dual ta2[3], tb2[3], qa2[4], qb2[4];
  trans(ta, seed == 0, ta2);
  trans(tb, seed == 1, tb2);
  if (seed < 0) {
    plain_q(qa, qa2);
    plain_q(qb, qb2);
  } else {
    retract_q(qa, seed == 0, qa2);
    retract_q(qb, seed == 1, qb2);
  }
  Dual cqa[4], d[3], local[3];
  qconj(qa2, cqa);
  for (int i = 0; i < 3; ++i) d[i] = tb2[i] - ta2[i];
  qrotate(cqa, d, local);
  for (int i = 0; i < 3; ++i) r[i] = (local[i] - mk(rel_t[i])) * mk(tw);
  Dual rq[4], crq[4], m1[4], dq[4], aa[3];
  plain_q(rel_q, rq);
  qconj(rq, crq);
  qmul(cqa, qb2, m1);
  qmul(crq, m1, dq);
  to_axis_angle(dq, aa);
  for (int i = 0; i < 3; ++i) r[3 + i] = aa[i] * mk(rw);
}

// Tangents: 0 node i, 1 node i+1, 2 the trajectory slot.
__device__ void rot_residual(const float* qi, const float* qj, const float* cq, const float* dq,
                             float w, int seed, Dual* r) {
  Dual qi2[4], qj2[4], c2[4];
  if (seed < 0) {
    plain_q(qi, qi2);
    plain_q(qj, qj2);
    plain_q(cq, c2);
  } else {
    retract_q(qi, seed == 0, qi2);
    retract_q(qj, seed == 1, qj2);
    retract_q(cq, seed == 2, c2);
  }
  Dual dqd[4], cc[4], inner[4], m1[4], m2[4], cqj[4], err[4];
  plain_q(dq, dqd);
  qconj(c2, cc);
  qmul(dqd, cc, inner);
  qmul(c2, inner, m1);
  qmul(qi2, m1, m2);
  qconj(qj2, cqj);
  qmul(cqj, m2, err);
  for (int i = 0; i < 3; ++i) r[i] = mk(w) * err[1 + i];
}

// Tangents: 0, 1, 2 the nodes i, i+1, i+2; 3 the trajectory slot (gravity
// in its dim 0, the calibration in 3..5).
__device__ void acc_residual(const float* ti, const float* tj, const float* tk, const float* qj,
                             float gv, const float* cq, const float* dv, float dt1, float dt2,
                             float w, int seed, Dual* r) {
  Dual ti2[3], tj2[3], tk2[3], qj2[4], c2[4];
  trans(ti, seed == 0, ti2);
  trans(tj, seed == 1, tj2);
  trans(tk, seed == 2, tk2);
  Dual g = mk(gv);
  if (seed == 3) g.d[0] = 1.0f;
  if (seed < 0) {
    plain_q(qj, qj2);
    plain_q(cq, c2);
  } else {
    retract_q(qj, seed == 1, qj2);
    retract_q(cq, seed == 3, c2);
  }
  dt1 = fmaxf(dt1, 1e-6f);
  dt2 = fmaxf(dt2, 1e-6f);
  float dt_sum = 0.5f * (dt1 + dt2);
  Dual v[3], cv[3], imu[3];
  for (int i = 0; i < 3; ++i) v[i] = mk(dv[i]);
  qrotate(c2, v, cv);
  qrotate(qj2, cv, imu);
  Dual gz = g * mk(dt_sum);
  for (int i = 0; i < 3; ++i) {
    Dual second = (tk2[i] - tj2[i]) / mk(dt2) - (tj2[i] - ti2[i]) / mk(dt1);
    Dual imu_dv = i == 2 ? imu[i] - gz : imu[i];
    r[i] = mk(w) * (imu_dv - second);
  }
}

// ------------------------------------------------------------ assembly

// dst (6x6) += x^T y over `rows` residual rows (row-major jac[row][col]).
__device__ inline void add_jtj(float* dst, const float (*x)[6], const float (*y)[6], int rows) {
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      float v = 0.0f;
      for (int q = 0; q < rows; ++q) v = v + x[q][i] * y[q][j];
      if (v != 0.0f) atomicAdd(&dst[6 * i + j], v);
    }
}
__device__ inline void add_jtr(float* dst, const float (*x)[6], const float* r, int rows) {
  for (int i = 0; i < 6; ++i) {
    float v = 0.0f;
    for (int q = 0; q < rows; ++q) v = v + x[q][i] * r[q];
    if (v != 0.0f) atomicAdd(&dst[i], v);
  }
}
// B entry e = jt^T jx, masked by the free dims of reduced slot t and node n,
// kept and scattered transposed into the right-hand sides.
__device__ inline void add_coupling(const Problem& p, const Workspace& w, int e, int t, int n,
                                    const float (*jt)[6], const float (*jx)[6], int rows) {
  float* bc = w.Bc + 36 * (size_t)e;
  bool any = false;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      float v = 0.0f;
      for (int q = 0; q < rows; ++q) v = v + jt[q][i] * jx[q][j];
      v = (p.sub_free[6 * t + i] && p.node_free[6 * n + j]) ? v : 0.0f;
      bc[6 * i + j] = v;
      if (v != 0.0f) {
        any = true;
        atomicAdd(&w.X[((size_t)n * 6 + j) * p.K + 6 * t + i], v);
      }
    }
  w.ae[e] = any ? t : -1;
  w.be[e] = n;
}
__device__ inline void clear_coupling(const Workspace& w, int e) {
  w.ae[e] = -1;
  w.be[e] = 0;
}

template <int R>
__device__ inline void take(const Dual* r, float (*jac)[6], float* val, float scale) {
  for (int q = 0; q < R; ++q) {
    if (val) val[q] = r[q].v * scale;
    for (int i = 0; i < 6; ++i) jac[q][i] = r[q].d[i] * scale;
  }
}

__device__ inline void warp_add(float v, float* dst) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
}

__global__ void init_kernel(float* scal) { scal[2] = 1e-4f; }

// With `assemble` the normal-equation contributions at `st` (residuals
// through the retraction at zero tangent); else the cost at `st` added into
// `cost` (no retraction, as _cost_local).
__global__ void constraint_kernel(Problem p, Workspace w, State st, bool assemble, float* cost) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float sq = 0.0f;
  if (t < p.C) {
    int c = (int)t;
    if (p.valid[c]) {
      int a = p.a_idx[c], b = p.b_idx[c];
      const float *ta = st.s_t + 3 * a, *qa = st.s_q + 4 * a, *tb = st.n_t + 3 * b,
                  *qb = st.n_q + 4 * b;
      Dual r[6];
      bin_residual(ta, qa, tb, qb, p.rel_t + 3 * c, p.rel_q + 4 * c, p.tw[c], p.rw[c],
                   assemble ? 0 : -1, r);
      float s2 = 0.0f;
      for (int q = 0; q < 6; ++q) s2 = s2 + r[q].v * r[q].v;
      float hs = p.huber_scale;
      float hw = (p.huber[c] && s2 > hs * hs) ? sqrtf(hs / sqrtf(fmaxf(s2, 1e-18f))) : 1.0f;
      float val[6], ja[6][6], jb[6][6];
      take<6>(r, ja, val, hw);
      for (int q = 0; q < 6; ++q) sq = sq + val[q] * val[q];
      if (assemble) {
        bin_residual(ta, qa, tb, qb, p.rel_t + 3 * c, p.rel_q + 4 * c, p.tw[c], p.rw[c], 1, r);
        take<6>(r, jb, nullptr, hw);
        add_jtj(w.A + 36 * a, ja, ja, 6);
        add_jtj(w.d0 + 36 * b, jb, jb, 6);
        add_jtr(w.g_s + 6 * a, ja, val, 6);
        add_jtr(w.g_n + 6 * b, jb, val, 6);
        add_coupling(p, w, c, a, b, ja, jb, 6);
      }
    } else if (assemble) {
      clear_coupling(w, c);
    }
  } else if (t < (long long)p.C + p.D) {
    int d = (int)(t - p.C);
    if (p.nn_valid[d]) {
      int j = p.j_idx[d], k = j + 1;
      const float *tj = st.n_t + 3 * j, *qj = st.n_q + 4 * j, *tk = st.n_t + 3 * k,
                  *qk = st.n_q + 4 * k;
      Dual r[6];
      bin_residual(tj, qj, tk, qk, p.nn_rel_t + 3 * d, p.nn_rel_q + 4 * d, p.nn_tw[d],
                   p.nn_rw[d], assemble ? 0 : -1, r);
      float val[6], jj[6][6], jk[6][6];
      take<6>(r, jj, val, 1.0f);
      for (int q = 0; q < 6; ++q) sq = sq + val[q] * val[q];
      if (assemble) {
        bin_residual(tj, qj, tk, qk, p.nn_rel_t + 3 * d, p.nn_rel_q + 4 * d, p.nn_tw[d],
                     p.nn_rw[d], 1, r);
        take<6>(r, jk, nullptr, 1.0f);
        add_jtj(w.d0 + 36 * j, jj, jj, 6);
        add_jtj(w.d0 + 36 * k, jk, jk, 6);
        add_jtj(w.u1 + 36 * j, jj, jk, 6);
        add_jtr(w.g_n + 6 * j, jj, val, 6);
        add_jtr(w.g_n + 6 * k, jk, val, 6);
      }
    }
  } else if (t < (long long)p.C + p.D + p.R) {
    int g = (int)(t - p.C - p.D);
    int e = p.C + 2 * g;
    if (p.rot_valid[g]) {
      int i = p.rot_i[g], tr = p.rot_traj[g];
      const float *qi = st.n_q + 4 * i, *qj = st.n_q + 4 * (i + 1), *cq = st.s_q + 4 * tr;
      Dual r[3];
      rot_residual(qi, qj, cq, p.rot_dq + 4 * g, p.rot_w[g], assemble ? 0 : -1, r);
      float val[3], ji[3][6], jn[3][6], jt[3][6];
      take<3>(r, ji, val, 1.0f);
      for (int q = 0; q < 3; ++q) sq = sq + val[q] * val[q];
      if (assemble) {
        rot_residual(qi, qj, cq, p.rot_dq + 4 * g, p.rot_w[g], 1, r);
        take<3>(r, jn, nullptr, 1.0f);
        rot_residual(qi, qj, cq, p.rot_dq + 4 * g, p.rot_w[g], 2, r);
        take<3>(r, jt, nullptr, 1.0f);
        add_jtj(w.d0 + 36 * i, ji, ji, 3);
        add_jtj(w.d0 + 36 * (i + 1), jn, jn, 3);
        add_jtj(w.u1 + 36 * i, ji, jn, 3);
        add_jtj(w.A + 36 * tr, jt, jt, 3);
        add_jtr(w.g_n + 6 * i, ji, val, 3);
        add_jtr(w.g_n + 6 * (i + 1), jn, val, 3);
        add_jtr(w.g_s + 6 * tr, jt, val, 3);
        add_coupling(p, w, e, tr, i, jt, ji, 3);
        add_coupling(p, w, e + 1, tr, i + 1, jt, jn, 3);
      }
    } else if (assemble) {
      clear_coupling(w, e);
      clear_coupling(w, e + 1);
    }
  } else if (t < (long long)p.C + p.D + p.R + p.A) {
    int g = (int)(t - p.C - p.D - p.R);
    int e = p.C + 2 * p.R + 3 * g;
    if (p.acc_valid[g]) {
      int i = p.acc_i[g], tr = p.acc_traj[g];
      const float *ti = st.n_t + 3 * i, *tj = st.n_t + 3 * (i + 1), *tk = st.n_t + 3 * (i + 2),
                  *qj = st.n_q + 4 * (i + 1), *cq = st.s_q + 4 * tr;
      float gv = st.s_t[3 * tr];
      Dual r[3];
      acc_residual(ti, tj, tk, qj, gv, cq, p.acc_dv + 3 * g, p.acc_dt1[g], p.acc_dt2[g],
                   p.acc_w[g], assemble ? 0 : -1, r);
      float val[3], jac[4][3][6];
      take<3>(r, jac[0], val, 1.0f);
      for (int q = 0; q < 3; ++q) sq = sq + val[q] * val[q];
      if (assemble) {
        for (int s = 1; s < 4; ++s) {
          acc_residual(ti, tj, tk, qj, gv, cq, p.acc_dv + 3 * g, p.acc_dt1[g], p.acc_dt2[g],
                       p.acc_w[g], s, r);
          take<3>(r, jac[s], nullptr, 1.0f);
        }
        for (int s = 0; s < 3; ++s) {
          add_jtj(w.d0 + 36 * (i + s), jac[s], jac[s], 3);
          add_jtr(w.g_n + 6 * (i + s), jac[s], val, 3);
          add_coupling(p, w, e + s, tr, i + s, jac[3], jac[s], 3);
        }
        add_jtj(w.u1 + 36 * i, jac[0], jac[1], 3);
        add_jtj(w.u1 + 36 * (i + 1), jac[1], jac[2], 3);
        add_jtj(w.u2 + 36 * i, jac[0], jac[2], 3);
        add_jtj(w.A + 36 * tr, jac[3], jac[3], 3);
        add_jtr(w.g_s + 6 * tr, jac[3], val, 3);
      }
    } else if (assemble) {
      for (int s = 0; s < 3; ++s) clear_coupling(w, e + s);
    }
  }
  if (!assemble) warp_add(sq, cost);
}

__global__ void damp_kernel(Problem p, Workspace w) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  float lam = w.scal[2];
  if (t < p.S) {
    const uint8_t* f = p.sub_free + 6 * t;
    float* a = w.A + 36 * t;
    for (int i = 0; i < 6; ++i) {
      for (int j = 0; j < 6; ++j)
        if (!(f[i] && f[j])) a[6 * i + j] = 0.0f;
      a[7 * i] = a[7 * i] + (f[i] ? lam * fabsf(a[7 * i]) + p.damping : 1.0f);
      if (!f[i]) w.g_s[6 * t + i] = 0.0f;
    }
  } else if (t < p.S + p.N) {
    int n = t - p.S;
    const uint8_t* f = p.node_free + 6 * n;
    float* d = w.d0 + 36 * n;
    for (int i = 0; i < 6; ++i) {
      for (int j = 0; j < 6; ++j) {
        if (!(f[i] && f[j])) d[6 * i + j] = 0.0f;
        bool f1 = n + 1 < p.N && f[i] && p.node_free[6 * (n + 1) + j];
        bool f2 = n + 2 < p.N && f[i] && p.node_free[6 * (n + 2) + j];
        if (!f1) w.u1[36 * n + 6 * i + j] = 0.0f;
        if (!f2) w.u2[36 * n + 6 * i + j] = 0.0f;
      }
      d[7 * i] = d[7 * i] + (f[i] ? lam * fabsf(d[7 * i]) + p.damping : 1.0f);
      float g = f[i] ? w.g_n[6 * n + i] : 0.0f;
      w.X[((size_t)n * 6 + i) * p.K + p.K - 1] = g;
    }
  }
}

// The super-blocks of node pairs (2k, 2k+1): diagonal Td_k and upper To_k
// (coupling to pair k+1), element (r, c) of 12x12.
__device__ inline float td_at(const Workspace& w, int k, int r, int c) {
  if (r < 6 && c < 6) return w.d0[36 * (2 * k) + 6 * r + c];
  if (r < 6) return w.u1[36 * (2 * k) + 6 * r + (c - 6)];
  if (c < 6) return w.u1[36 * (2 * k) + 6 * c + (r - 6)];
  return w.d0[36 * (2 * k + 1) + 6 * (r - 6) + (c - 6)];
}
__device__ inline float to_at(const Workspace& w, int k, int r, int c) {
  if (r < 6 && c < 6) return w.u2[36 * (2 * k) + 6 * r + c];
  if (r < 6) return 0.0f;
  if (c < 6) return w.u1[36 * (2 * k + 1) + 6 * (r - 6) + c];
  return w.u2[36 * (2 * k + 1) + 6 * (r - 6) + (c - 6)];
}

// ------------------------------------------------------------ the node band

// Block cyclic reduction of T X = [B^T | g_n] over the n = N/2 super-blocks.
// Level l (stride s = 2^l) holds the blocks whose index is a multiple of s:
// D^(l)_i on the diagonal and U^(l)_i coupling i to i + s (U^(0) = To).
// While more than one block is left, the odd ones of the level (i = s mod
// 2s) are eliminated: x_j = y_j - G_j x_{j-s} - H_j x_{j+s} with
// Dinv_j = (D_j + 1e-9 I)^-1, G_j = Dinv_j U_{j-s}^T, H_j = Dinv_j U_j and
// y_j = Dinv_j b_j; each even one i takes D_i - U_{i-s}^T H_{i-s} - U_i
// G_{i+s}, b_i - U_{i-s}^T y_{i-s} - U_i y_{i+s} and, to i + 2s, the
// coupling -U_i H_{i+s}. The last block (index 0) is eliminated with no
// neighbours, so its y is its x; back up the levels each eliminated block
// then takes its x from its neighbours'. A block past the end is zero.
struct Band {
  int n;           // super-blocks
  float* D[2];     // D^(l) by the parity of l, l >= 1
  float* U[2];     // U^(l) by the parity of l, l >= 1
  float* G;        // per eliminated block
  float* H;
};

// Block k's diagonal at `level` into the shared `out` (144 floats).
__device__ inline void load_d(const Workspace& w, const Band& b, int level, int k, float* out) {
  for (int e = threadIdx.x; e < 144; e += blockDim.x)
    out[e] = level == 0 ? td_at(w, k, e / 12, e % 12) : b.D[level & 1][144 * (size_t)k + e];
}
// U^(level)_k, zero where k or k + 2^level lies outside the band.
__device__ inline void load_u(const Workspace& w, const Band& b, int level, int k, float* out) {
  const bool in = k >= 0 && k + (1 << level) < b.n;
  for (int e = threadIdx.x; e < 144; e += blockDim.x)
    out[e] = !in ? 0.0f
             : level == 0 ? to_at(w, k, e / 12, e % 12)
                          : b.U[level & 1][144 * (size_t)k + e];
}
__device__ inline void load_block(const float* src, int k, bool in, float* out) {
  for (int e = threadIdx.x; e < 144; e += blockDim.x)
    out[e] = in ? src[144 * (size_t)k + e] : 0.0f;
}

// out = (a + 1e-9 I)^-1 of the symmetric positive definite 12x12 `a` by the
// first warp: Gauss-Jordan without pivot search, lane r holding row r of
// [a | I] in registers, the pivot row broadcast by shuffles.
__device__ inline void warp_inverse(const float* a, float* out) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int r = lane < 12 ? lane : 0;
  float m[12], e[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    m[c] = a[12 * r + c] + (c == r ? kEps : 0.0f);
    e[c] = c == r ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    float pm[12], pe[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      pm[c] = __shfl_sync(0xffffffffu, m[c], k);
      pe[c] = __shfl_sync(0xffffffffu, e[c], k);
    }
    const float inv = 1.0f / pm[k];
    const float f = m[k];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      const float nm = pm[c] * inv, ne = pe[c] * inv;
      m[c] = lane == k ? nm : m[c] - f * nm;
      e[c] = lane == k ? ne : e[c] - f * ne;
    }
  }
  if (lane < 12)
#pragma unroll
    for (int c = 0; c < 12; ++c) out[12 * lane + c] = e[c];
}

// Eliminates block k from its diagonal `d` and its couplings `ul` (to the
// left neighbour, U_{k-s}) and `ur` (U_k), all shared: Dinv into `dinv`,
// and G_k, H_k written by the first column tile.
__device__ inline void eliminate(const Band& b, int k, const float* d, const float* ul,
                                 const float* ur, float* dinv) {
  warp_inverse(d, dinv);
  __syncthreads();
  if (blockIdx.y == 0)
    for (int e = threadIdx.x; e < 144; e += blockDim.x) {
      const int r = e / 12, c = e % 12;
      float g = 0.0f, h = 0.0f;
      for (int m = 0; m < 12; ++m) {
        g = g + dinv[12 * r + m] * ul[12 * c + m];
        h = h + dinv[12 * r + m] * ur[12 * m + c];
      }
      b.G[144 * (size_t)k + e] = g;
      b.H[144 * (size_t)k + e] = h;
    }
}

// The columns of X of this block's tile (blockIdx.y of gridDim.y), a
// thread's every blockDim.x-th: [first, end). The first and back launches
// always take tiles of at most blockDim.x columns, one a thread (a loop
// over several lets the compiler hold the block's 12x12 matrices in
// registers across it, 288 floats, and spill).
__device__ inline int2 band_columns(int K) {
  const int per = (K + gridDim.y - 1) / gridDim.y;
  return make_int2(blockIdx.y * per + threadIdx.x, min(K, (blockIdx.y + 1) * per));
}

__device__ inline void load_rows(const float* x, size_t K, float* v) {
#pragma unroll
  for (int r = 0; r < 12; ++r) v[r] = x[r * K];
}

// Level 0's eliminations: the odd blocks (block 0 where it is the only one).
__global__ void __launch_bounds__(kBandThreads)
    band_first_kernel(Problem p, Workspace w, Band b) {
  __shared__ float d[144], ul[144], ur[144], dinv[144];
  const int j = b.n == 1 ? 0 : 2 * blockIdx.x + 1;
  load_d(w, b, 0, j, d);
  load_u(w, b, 0, j - 1, ul);
  load_u(w, b, 0, j, ur);
  __syncthreads();
  eliminate(b, j, d, ul, ur, dinv);
  const size_t K = p.K;
  const int2 c = band_columns(p.K);  // a column a thread: the launch is in column tiles
  if (c.x < c.y) {
    float* x = w.X + 12 * (size_t)j * K + c.x;
    float v[12];
    load_rows(x, K, v);
#pragma unroll
    for (int r = 0; r < 12; ++r) {
      float y = 0.0f;
#pragma unroll
      for (int m = 0; m < 12; ++m) y = y + dinv[12 * r + m] * v[m];
      x[r * K] = y;
    }
  }
}

// The even blocks of `level`: their updates from the odd neighbours, then,
// for those the next level eliminates, their elimination.
__global__ void __launch_bounds__(kBandThreads)
    band_level_kernel(Problem p, Workspace w, Band b, int level) {
  __shared__ float d[144], ul[144], ui[144], hl[144], gr[144], hr[144], ull[144];
  __shared__ float dn[144], uln[144], uin[144], dinv[144];
  const int s = 1 << level;
  const int i = blockIdx.x * 2 * s, jl = i - s, jr = i + s;
  const bool has_l = i > 0, has_r = jr < b.n;
  load_d(w, b, level, i, d);
  load_u(w, b, level, jl, ul);
  load_u(w, b, level, i, ui);
  load_u(w, b, level, i - 2 * s, ull);
  load_block(b.H, jl, has_l, hl);
  load_block(b.G, jr, has_r, gr);
  load_block(b.H, jr, has_r, hr);
  __syncthreads();
  for (int e = threadIdx.x; e < 144; e += blockDim.x) {
    const int r = e / 12, c = e % 12;
    float v = d[e], un = 0.0f, ln = 0.0f;
    for (int m = 0; m < 12; ++m) {
      v = v - ul[12 * m + r] * hl[12 * m + c];
      v = v - ui[12 * r + m] * gr[12 * m + c];
      un = un - ui[12 * r + m] * hr[12 * m + c];
      ln = ln - ull[12 * r + m] * hl[12 * m + c];
    }
    dn[e] = v;
    uin[e] = un;
    uln[e] = ln;
  }
  __syncthreads();
  const int next = 2 * s;
  const bool eliminated = (b.n + next - 1) / next == 1 ? i == 0 : i % (2 * next) == next;
  if (blockIdx.y == 0) {
    float* dst_d = b.D[(level + 1) & 1] + 144 * (size_t)i;
    float* dst_u = b.U[(level + 1) & 1] + 144 * (size_t)i;
    for (int e = threadIdx.x; e < 144; e += blockDim.x) {
      dst_d[e] = dn[e];
      dst_u[e] = uin[e];
    }
  }
  if (eliminated) eliminate(b, i, dn, uln, uin, dinv);
  const size_t K = p.K;
#pragma unroll 1  // a column at a time: its 12-row vectors fill the registers
  for (int2 c = band_columns(p.K); c.x < c.y; c.x += blockDim.x) {
    float* x = w.X + 12 * (size_t)i * K + c.x;
    float v[12], yl[12], yr[12];
    load_rows(x, K, v);
#pragma unroll
    for (int r = 0; r < 12; ++r) yl[r] = yr[r] = 0.0f;
    if (has_l) load_rows(w.X + 12 * (size_t)jl * K + c.x, K, yl);
    if (has_r) load_rows(w.X + 12 * (size_t)jr * K + c.x, K, yr);
#pragma unroll
    for (int r = 0; r < 12; ++r) {
      float t = v[r];
#pragma unroll
      for (int m = 0; m < 12; ++m) t = t - ul[12 * m + r] * yl[m] - ui[12 * r + m] * yr[m];
      v[r] = t;
    }
    if (eliminated) {
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        float y = 0.0f;
#pragma unroll
        for (int m = 0; m < 12; ++m) y = y + dinv[12 * r + m] * v[m];
        x[r * K] = y;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 12; ++r) x[r * K] = v[r];
    }
  }
}

// Back up `level`: each block it eliminated takes x_j = y_j - G_j x_{j-s} -
// H_j x_{j+s}.
__global__ void __launch_bounds__(kBandThreads)
    band_back_kernel(Problem p, Workspace w, Band b, int level) {
  __shared__ float g[144], h[144];
  const int s = 1 << level;
  const int j = s + blockIdx.x * 2 * s;
  const bool has_r = j + s < b.n;
  load_block(b.G, j, true, g);
  load_block(b.H, j, has_r, h);
  __syncthreads();
  const size_t K = p.K;
  const int2 c = band_columns(p.K);  // a column a thread: the launch is in column tiles
  if (c.x < c.y) {
    float* x = w.X + 12 * (size_t)j * K + c.x;
    float v[12], xl[12], xr[12];
    load_rows(x, K, v);
    load_rows(w.X + 12 * (size_t)(j - s) * K + c.x, K, xl);
#pragma unroll
    for (int r = 0; r < 12; ++r) xr[r] = 0.0f;
    if (has_r) load_rows(w.X + 12 * (size_t)(j + s) * K + c.x, K, xr);
#pragma unroll
    for (int r = 0; r < 12; ++r) {
      float t = v[r];
#pragma unroll
      for (int m = 0; m < 12; ++m) t = t - g[12 * r + m] * xl[m] - h[12 * r + m] * xr[m];
      x[r * K] = t;
    }
  }
}

// t + d[0:3], normalize(q exp(d[3:6])) (quaternion.from_axis_angle).
__device__ inline void retract(const float* t, const float* q, const float* d, float* t2,
                               float* q2) {
  for (int i = 0; i < 3; ++i) t2[i] = t[i] + d[i];
  float ax = d[3], ay = d[4], az = d[5];
  float angle_sq = ax * ax + ay * ay + az * az;
  float k, e0;
  if (angle_sq < 1e-12f) {
    k = 0.5f - angle_sq / 48.0f;
    e0 = 1.0f - angle_sq / 8.0f;
  } else {
    float angle = sqrtf(angle_sq);
    float half = 0.5f * angle;
    k = sinf(half) / angle;
    e0 = cosf(half);
  }
  float e[4] = {e0, k * ax, k * ay, k * az};
  float o[4];
  o[0] = q[0] * e[0] - q[1] * e[1] - q[2] * e[2] - q[3] * e[3];
  o[1] = q[0] * e[1] + q[1] * e[0] + q[2] * e[3] - q[3] * e[2];
  o[2] = q[0] * e[2] - q[1] * e[3] + q[2] * e[0] + q[3] * e[1];
  o[3] = q[0] * e[3] + q[1] * e[2] - q[2] * e[1] + q[3] * e[0];
  float n = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
  for (int i = 0; i < 4; ++i) q2[i] = o[i] / n;
}

// The candidate: slot t retracted by its part of dx (gravity clamped), node
// n by dx_n = -(y + X dx_s), a warp per node with its lanes along X's row.
__global__ void update_kernel(Problem p, Workspace w, State st) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.S) {
    float d[6];
    for (int i = 0; i < 6; ++i) d[i] = p.sub_free[6 * t + i] ? w.dx[6 * t + i] : 0.0f;
    retract(st.s_t + 3 * t, st.s_q + 4 * t, d, w.cand.s_t + 3 * t, w.cand.s_q + 4 * t);
    if (p.grav_clamp[t]) w.cand.s_t[3 * t] = fmaxf(w.cand.s_t[3 * t], 0.0f);
  }
  const int n = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= p.N) return;  // whole warps leave together
  const size_t K = p.K;
  float d[6];
  for (int i = 0; i < 6; ++i) {
    const float* x = w.X + ((size_t)n * 6 + i) * K;
    float acc = 0.0f;
    for (int k = lane; k < p.K - 1; k += 32) acc = acc + x[k] * w.dx[k];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    d[i] = p.node_free[6 * n + i] ? -(x[p.K - 1] + acc) : 0.0f;
  }
  if (lane == 0)
    retract(st.n_t + 3 * n, st.n_q + 4 * n, d, w.cand.n_t + 3 * n, w.cand.n_q + 4 * n);
}

__global__ void accept_kernel(Problem p, Workspace w, State st, float* history) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  float c0 = w.scal[0], c1 = w.scal[1];
  bool accept = isfinite(c1) && c1 <= c0;
  if (accept) {
    if (t < p.S) {
      for (int i = 0; i < 3; ++i) st.s_t[3 * t + i] = w.cand.s_t[3 * t + i];
      for (int i = 0; i < 4; ++i) st.s_q[4 * t + i] = w.cand.s_q[4 * t + i];
    } else if (t < p.S + p.N) {
      int n = t - p.S;
      for (int i = 0; i < 3; ++i) st.n_t[3 * n + i] = w.cand.n_t[3 * n + i];
      for (int i = 0; i < 4; ++i) st.n_q[4 * n + i] = w.cand.n_q[4 * n + i];
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
  return schur::System{6 * p.S, 6, w.A, w.g_s, w.M, w.panels, w.dx};
}

}  // namespace

// `ptrs` (host) holds the problem's device pointers in the order of
// parallel/schur_spa_3d.py:_FIELDS, then sub_t, sub_q, node_t, node_q (the
// state, optimized in place), then the coupling entries grouped by slot
// (order (E,), slot_start (S + 1,), piece_start (S + 1,) int32);
// `dims` (host) is [S, N, C, D, R, A, pieces], pieces at least the number
// of pieces of schur::kPiece entries the grouping makes. `history` (device, may be
// null) takes per iteration the cost at x, the cost at the candidate, the
// accept flag and the new lambda.
extern "C" int schur_spa_3d(const void* ptrs_v, const void* dims_v, int num_iterations,
                            float huber_scale, float damping, void* workspace,
                            long long workspace_floats, void* history, void* stream) {
  const unsigned long long* ptrs = (const unsigned long long*)ptrs_v;
  const int* dims = (const int*)dims_v;
  Problem p;
  p.S = dims[0]; p.N = dims[1]; p.C = dims[2]; p.D = dims[3]; p.R = dims[4]; p.A = dims[5];
  const int max_pieces = dims[6];
  p.E = p.C + 2 * p.R + 3 * p.A;
  p.K = 6 * p.S + 1;
  p.N2 = p.N / 2;
  int f = 0;
  p.a_idx = (const int*)ptrs[f++]; p.b_idx = (const int*)ptrs[f++];
  p.rel_t = (const float*)ptrs[f++]; p.rel_q = (const float*)ptrs[f++];
  p.tw = (const float*)ptrs[f++]; p.rw = (const float*)ptrs[f++];
  p.huber = (const uint8_t*)ptrs[f++]; p.valid = (const uint8_t*)ptrs[f++];
  p.j_idx = (const int*)ptrs[f++]; p.nn_rel_t = (const float*)ptrs[f++];
  p.nn_rel_q = (const float*)ptrs[f++]; p.nn_tw = (const float*)ptrs[f++];
  p.nn_rw = (const float*)ptrs[f++]; p.nn_valid = (const uint8_t*)ptrs[f++];
  p.rot_i = (const int*)ptrs[f++]; p.rot_traj = (const int*)ptrs[f++];
  p.rot_dq = (const float*)ptrs[f++]; p.rot_w = (const float*)ptrs[f++];
  p.rot_valid = (const uint8_t*)ptrs[f++];
  p.acc_i = (const int*)ptrs[f++]; p.acc_traj = (const int*)ptrs[f++];
  p.acc_dv = (const float*)ptrs[f++]; p.acc_dt1 = (const float*)ptrs[f++];
  p.acc_dt2 = (const float*)ptrs[f++]; p.acc_w = (const float*)ptrs[f++];
  p.acc_valid = (const uint8_t*)ptrs[f++];
  p.sub_free = (const uint8_t*)ptrs[f++]; p.node_free = (const uint8_t*)ptrs[f++];
  p.grav_clamp = (const uint8_t*)ptrs[f++];
  State st;
  st.s_t = (float*)ptrs[f++]; st.s_q = (float*)ptrs[f++];
  st.n_t = (float*)ptrs[f++]; st.n_q = (float*)ptrs[f++];
  schur::SlotReduce<6> g;
  g.order = (const int*)ptrs[f++];
  g.slot_start = (const int*)ptrs[f++];
  g.piece_start = (const int*)ptrs[f++];
  p.huber_scale = huber_scale;
  p.damping = damping;

  const long long S = p.S, N = p.N, K = p.K, E = p.E, N2 = p.N2, n6 = 6 * S;
  long long zeroed = 36 * S + 3 * 36 * N + 6 * S + 6 * N + 6 * N * K + 36 * S * S + 6 * S;
  long long needed = zeroed + 8 + 6 * 144 * N2 + 36 * E + 2 * E + 6 * S + 7 * S + 7 * N +
                     (long long)schur::kMaxCluster * schur::kPanel * (n6 + 1) +
                     (long long)max_pieces * 6 * K;
  if (workspace_floats < needed || S <= 0 || N <= 0 || N % 2 || max_pieces < 0)
    return (int)cudaErrorInvalidValue;
  Workspace w;
  Band b;
  float* q = (float*)workspace;
  w.A = q; q += 36 * S;
  w.d0 = q; q += 36 * N;
  w.u1 = q; q += 36 * N;
  w.u2 = q; q += 36 * N;
  w.g_s = q; q += 6 * S;
  w.g_n = q; q += 6 * N;
  w.X = q; q += 6 * N * K;
  w.M = q; q += 36 * S * S;
  w.r = q; q += 6 * S;
  w.scal = q; q += 8;
  for (int i = 0; i < 2; ++i) {
    b.D[i] = q; q += 144 * N2;
    b.U[i] = q; q += 144 * N2;
  }
  b.G = q; q += 144 * N2;
  b.H = q; q += 144 * N2;
  w.Bc = q; q += 36 * E;
  w.ae = (int*)q; q += E;
  w.be = (int*)q; q += E;
  w.dx = q; q += 6 * S;
  w.cand.s_t = q; q += 3 * S;
  w.cand.s_q = q; q += 4 * S;
  w.cand.n_t = q; q += 3 * N;
  w.cand.n_q = q; q += 4 * N;
  w.panels = q; q += (long long)schur::kMaxCluster * schur::kPanel * (n6 + 1);
  g.partial = q;
  g.S = p.S;
  g.K = p.K;
  g.Bc = w.Bc;
  g.ae = w.ae;
  g.be = w.be;
  g.X = w.X;
  g.M = w.M;

  b.n = (int)N2;
  int levels = 0;  // ceil(log2 n)
  while ((1ll << levels) < N2) ++levels;
  // X's columns in tiles of kBandThreads, but a level launch of many blocks
  // takes all of them in each block (its 12x12 work then once a block).
  const int most_tiles = (int)((K + kBandThreads - 1) / kBandThreads);
  auto band_grid = [&](long long blocks, bool wide) {
    return dim3((unsigned)blocks, wide && blocks >= kWideLaunch ? 1u : (unsigned)most_tiles);
  };

  cudaStream_t s = (cudaStream_t)stream;
  long long terms = (long long)p.C + p.D + p.R + p.A;
  int term_blocks = blocks_for(terms, kThreads);
  int slot_blocks = blocks_for(S + N, kThreads);
  int update_blocks = blocks_for(S > 32 * N ? S : 32 * N, kThreads);  // a warp per node
  init_kernel<<<1, 1, 0, s>>>(w.scal);
  for (int it = 0; it < num_iterations; ++it) {
    cudaMemsetAsync(w.A, 0, zeroed * sizeof(float), s);
    cudaMemsetAsync(w.scal, 0, 2 * sizeof(float), s);
    if (term_blocks > 0) {
      constraint_kernel<<<term_blocks, kThreads, 0, s>>>(p, w, st, true, nullptr);
      constraint_kernel<<<term_blocks, kThreads, 0, s>>>(p, w, st, false, w.scal);
    }
    damp_kernel<<<slot_blocks, kThreads, 0, s>>>(p, w);
    band_first_kernel<<<band_grid(b.n == 1 ? 1 : b.n / 2, false), kBandThreads, 0, s>>>(p, w,
                                                                                       b);
    for (int l = 0; l < levels; ++l) {
      const int stride = 2 << l;
      band_level_kernel<<<band_grid((b.n + stride - 1) / stride, true), kBandThreads, 0, s>>>(
          p, w, b, l);
    }
    for (int l = levels - 1; l >= 0; --l) {
      const int step = 1 << l;
      band_back_kernel<<<band_grid((b.n + step - 1) / (2 * step), false), kBandThreads, 0, s>>>(
          p, w, b, l);
    }
    if (E > 0) schur::launch_slot_reduce(g, max_pieces, s);
    const cudaError_t err = schur::launch_cholesky(reduced_system(p, w), 0, s);
    if (err != cudaSuccess) return (int)err;
    update_kernel<<<update_blocks, kThreads, 0, s>>>(p, w, st);
    if (term_blocks > 0)
      constraint_kernel<<<term_blocks, kThreads, 0, s>>>(p, w, w.cand, false, w.scal + 1);
    accept_kernel<<<slot_blocks, kThreads, 0, s>>>(
        p, w, st, history ? (float*)history + 4 * it : nullptr);
  }
  return (int)cudaGetLastError();
}
