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
//             sweep's right-hand sides [B^T | g_n] (N, 6, 6S+1).
//   cost      the cost at x (no retraction, as _cost_local).
//   damp      one thread per slot: frozen dims get zero rows and columns
//             and a unit diagonal, free ones lambda |diag| + damping.
//   factor    one block walks the 12x12 super-blocks of node pairs (2k,
//             2k+1): C_k = Td_k - To_{k-1}^T CinvU_{k-1}, Cinv_k =
//             (C_k + 1e-9 I)^-1 (Gauss-Jordan with partial pivoting, the
//             block's threads over the augmented matrix), CinvU_k =
//             Cinv_k To_k.
//   sweep     one warp per two right-hand sides, a lane per row of the
//             super-block: forward and back substitution down and up the
//             chain.
//   reduce    one block per B entry: B X and B y scattered atomically into
//             the reduced matrix and right-hand side.
//   cholesky  one block: the 6S x 6S system blockdiag(A) - B X in global
//             memory (at S = 64, 384^2 floats, 590 KB, more than shared
//             memory holds), factored in place and solved; a system that
//             is not positive definite yields NaN, and the step is then
//             rejected.
//   update    dx_n = -(y + X dx_s), the retraction of every slot and the
//             gravity clamp.
//   cost      the cost at the candidate.
//   accept    finite and not larger: take the candidate, lambda / 3; else
//             keep the state, lambda * 8; lambda within [1e-8, 1e8].
// Atomics order the sums differently from run to run: the result agrees
// with the plain twin to a tolerance, not bit for bit.
//
// Bound: latency. At capacity (N = 4096 nodes, S = 64 reduced slots,
// C = 16,384 binary terms, 4,095 gyro and 4,094 acceleration terms) an
// iteration moves some 70 MB (the right-hand sides are 4096 x 6 x 385
// floats) and does some 0.5 GFLOP; the factor is a chain of 2,048 dependent
// 12x12 inversions and the sweep a chain of 4,096 dependent 12x12 products
// per column, which is what the time is made of.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-9f;
constexpr int kSweepWarps = 8;

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
  float *Cinv, *CinvU, *To;
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

__global__ void factor_kernel(Problem p, Workspace w) {
  __shared__ float aug[12][24];
  __shared__ float prev[12][12];  // CinvU_{k-1}
  __shared__ float lo[12][12];    // To_{k-1}
  __shared__ float up[12][12];    // To_k
  __shared__ float fcol[12];
  __shared__ int piv;
  const int tid = threadIdx.x;
  for (int k = 0; k < p.N2; ++k) {
    bool last = k + 1 == p.N2;
    if (tid < 144) {
      int r = tid / 12, c = tid % 12;
      float v = td_at(w, k, r, c);
      if (k > 0) {
        float s = 0.0f;
        for (int m = 0; m < 12; ++m) s = s + lo[m][r] * prev[m][c];
        v = v - s;
      }
      aug[r][c] = v + (r == c ? kEps : 0.0f);
      aug[r][12 + c] = r == c ? 1.0f : 0.0f;
      float u = last ? 0.0f : to_at(w, k, r, c);
      up[r][c] = u;
      if (!last) w.To[144 * (size_t)k + tid] = u;
    }
    __syncthreads();
    for (int col = 0; col < 12; ++col) {
      if (tid == 0) {
        int best = col;
        for (int r = col + 1; r < 12; ++r)
          if (fabsf(aug[r][col]) > fabsf(aug[best][col])) best = r;
        piv = best;
      }
      __syncthreads();
      if (piv != col && tid < 24) {
        float tmp = aug[col][tid];
        aug[col][tid] = aug[piv][tid];
        aug[piv][tid] = tmp;
      }
      __syncthreads();
      float inv = 1.0f / aug[col][col];
      __syncthreads();
      if (tid < 24) aug[col][tid] = aug[col][tid] * inv;
      if (tid < 12) fcol[tid] = aug[tid][col];
      __syncthreads();
      for (int idx = tid; idx < 288; idx += blockDim.x) {
        int r = idx / 24, j = idx % 24;
        if (r != col) aug[r][j] = aug[r][j] - fcol[r] * aug[col][j];
      }
      __syncthreads();
    }
    if (tid < 144) {
      int r = tid / 12, c = tid % 12;
      w.Cinv[144 * (size_t)k + tid] = aug[r][12 + c];
      float s = 0.0f;
      for (int m = 0; m < 12; ++m) s = s + aug[r][12 + m] * up[m][c];
      w.CinvU[144 * (size_t)k + tid] = s;
      prev[r][c] = s;  // read next step, after the barrier below
      lo[r][c] = up[r][c];
    }
    __syncthreads();
  }
}

// X = T^-1 [B^T | g_n]: one warp per two columns, lane 12 c + r holds row r
// of column c of the current super-block.
__global__ void sweep_kernel(Problem p, Workspace w) {
  __shared__ float buf[kSweepWarps][2][2][12];  // [warp][column][carry, tmp][row]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = 2 * (blockIdx.x * kSweepWarps + warp);
  if (first >= p.K) return;  // whole warps leave together
  const int c = lane < 24 ? lane / 12 : 0;
  const int row = lane % 12;
  const int col = first + c;
  const bool active = lane < 24 && col < p.K;
  const size_t K = p.K;
  float* carry = buf[warp][c][0];
  float* tmp = buf[warp][c][1];
  if (active) carry[row] = 0.0f;
  __syncwarp();
  for (int k = 0; k < p.N2; ++k) {
    float* x = w.X + (12 * (size_t)k + row) * K + col;
    float b = active ? x[0] : 0.0f;
    if (k > 0 && active) {
      const float* to = w.To + 144 * (size_t)(k - 1);
      float s = 0.0f;
      for (int m = 0; m < 12; ++m) s = s + to[12 * m + row] * carry[m];
      b = b - s;
    }
    __syncwarp();
    if (active) tmp[row] = b;
    __syncwarp();
    float y = 0.0f;
    if (active) {
      const float* ci = w.Cinv + 144 * (size_t)k + 12 * row;
      for (int m = 0; m < 12; ++m) y = y + ci[m] * tmp[m];
      x[0] = y;
    }
    __syncwarp();
    if (active) carry[row] = y;
    __syncwarp();
  }
  if (active) carry[row] = 0.0f;
  __syncwarp();
  for (int k = p.N2 - 1; k >= 0; --k) {
    float* x = w.X + (12 * (size_t)k + row) * K + col;
    float v = 0.0f;
    if (active) {
      const float* cu = w.CinvU + 144 * (size_t)k + 12 * row;
      float s = 0.0f;
      for (int m = 0; m < 12; ++m) s = s + cu[m] * carry[m];
      v = x[0] - s;
      x[0] = v;
    }
    __syncwarp();
    if (active) carry[row] = v;
    __syncwarp();
  }
}

__global__ void reduce_kernel(Problem p, Workspace w) {
  int e = blockIdx.x;
  int a = w.ae[e];
  if (a < 0) return;
  int b = w.be[e];
  const float* bc = w.Bc + 36 * (size_t)e;
  const size_t K = p.K;
  const float* x = w.X + (size_t)b * 6 * K;
  const int n6 = 6 * p.S;
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) {
    float xv[6];
    for (int j = 0; j < 6; ++j) xv[j] = x[j * K + k];
    for (int i = 0; i < 6; ++i) {
      float v = 0.0f;
      for (int j = 0; j < 6; ++j) v = v + bc[6 * i + j] * xv[j];
      if (k < p.K - 1)
        atomicAdd(&w.M[(size_t)(6 * a + i) * n6 + k], v);
      else
        atomicAdd(&w.r[6 * a + i], v);
    }
  }
}

__global__ void cholesky_kernel(Problem p, Workspace w) {
  const int n = 6 * p.S;
  float* m = w.M;
  float* b = w.r;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    int r = idx / n, q = idx % n;
    float a = r / 6 == q / 6 ? w.A[36 * (r / 6) + 6 * (r % 6) + q % 6] : 0.0f;
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
      if (j <= i)
        m[(size_t)i * n + j] = m[(size_t)i * n + j] - m[(size_t)i * n + k] * m[(size_t)j * n + k];
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

__global__ void update_kernel(Problem p, Workspace w, State st) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.S) {
    float d[6];
    for (int i = 0; i < 6; ++i) d[i] = p.sub_free[6 * t + i] ? w.dx[6 * t + i] : 0.0f;
    retract(st.s_t + 3 * t, st.s_q + 4 * t, d, w.cand.s_t + 3 * t, w.cand.s_q + 4 * t);
    if (p.grav_clamp[t]) w.cand.s_t[3 * t] = fmaxf(w.cand.s_t[3 * t], 0.0f);
  } else if (t < p.S + p.N) {
    int n = t - p.S;
    const size_t K = p.K;
    float d[6];
    for (int i = 0; i < 6; ++i) {
      const float* x = w.X + ((size_t)n * 6 + i) * K;
      float acc = 0.0f;
      for (int k = 0; k < p.K - 1; ++k) acc = acc + x[k] * w.dx[k];
      d[i] = p.node_free[6 * n + i] ? -(x[p.K - 1] + acc) : 0.0f;
    }
    retract(st.n_t + 3 * n, st.n_q + 4 * n, d, w.cand.n_t + 3 * n, w.cand.n_q + 4 * n);
  }
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

}  // namespace

// `ptrs` (host) holds the problem's device pointers in the order of
// parallel/schur_spa_3d.py:_FIELDS, then sub_t, sub_q, node_t, node_q (the
// state, optimized in place); `dims` (host) is [S, N, C, D, R, A].
// `history` (device, may be null) takes per iteration the cost at x, the
// cost at the candidate, the accept flag and the new lambda.
extern "C" int schur_spa_3d(const void* ptrs_v, const void* dims_v, int num_iterations,
                            float huber_scale, float damping, void* workspace,
                            long long workspace_floats, void* history, void* stream) {
  const unsigned long long* ptrs = (const unsigned long long*)ptrs_v;
  const int* dims = (const int*)dims_v;
  Problem p;
  p.S = dims[0]; p.N = dims[1]; p.C = dims[2]; p.D = dims[3]; p.R = dims[4]; p.A = dims[5];
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
  p.huber_scale = huber_scale;
  p.damping = damping;

  const long long S = p.S, N = p.N, K = p.K, E = p.E, N2 = p.N2;
  long long zeroed = 36 * S + 3 * 36 * N + 6 * S + 6 * N + 6 * N * K + 36 * S * S + 6 * S;
  long long needed = zeroed + 8 + 3 * 144 * N2 + 36 * E + 2 * E + 6 * S + 7 * S + 7 * N;
  if (workspace_floats < needed || S <= 0 || N <= 0 || N % 2) return (int)cudaErrorInvalidValue;
  Workspace w;
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
  w.Cinv = q; q += 144 * N2;
  w.CinvU = q; q += 144 * N2;
  w.To = q; q += 144 * N2;
  w.Bc = q; q += 36 * E;
  w.ae = (int*)q; q += E;
  w.be = (int*)q; q += E;
  w.dx = q; q += 6 * S;
  w.cand.s_t = q; q += 3 * S;
  w.cand.s_q = q; q += 4 * S;
  w.cand.n_t = q; q += 3 * N;
  w.cand.n_q = q;

  cudaStream_t s = (cudaStream_t)stream;
  long long terms = (long long)p.C + p.D + p.R + p.A;
  int term_blocks = blocks_for(terms, kThreads);
  int slot_blocks = blocks_for(S + N, kThreads);
  int sweep_blocks = blocks_for((K + 1) / 2, kSweepWarps);
  init_kernel<<<1, 1, 0, s>>>(w.scal);
  for (int it = 0; it < num_iterations; ++it) {
    cudaMemsetAsync(w.A, 0, zeroed * sizeof(float), s);
    cudaMemsetAsync(w.scal, 0, 2 * sizeof(float), s);
    if (term_blocks > 0) {
      constraint_kernel<<<term_blocks, kThreads, 0, s>>>(p, w, st, true, nullptr);
      constraint_kernel<<<term_blocks, kThreads, 0, s>>>(p, w, st, false, w.scal);
    }
    damp_kernel<<<slot_blocks, kThreads, 0, s>>>(p, w);
    factor_kernel<<<1, kThreads, 0, s>>>(p, w);
    sweep_kernel<<<sweep_blocks, 32 * kSweepWarps, 0, s>>>(p, w);
    if (E > 0) reduce_kernel<<<(int)E, 128, 0, s>>>(p, w);
    cholesky_kernel<<<1, 1024, 0, s>>>(p, w);
    update_kernel<<<slot_blocks, kThreads, 0, s>>>(p, w, st);
    if (term_blocks > 0)
      constraint_kernel<<<term_blocks, kThreads, 0, s>>>(p, w, w.cand, false, w.scal + 1);
    accept_kernel<<<slot_blocks, kThreads, 0, s>>>(
        p, w, st, history ? (float*)history + 4 * it : nullptr);
  }
  return (int)cudaGetLastError();
}
