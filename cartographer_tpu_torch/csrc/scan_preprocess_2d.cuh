// K1's per-point code, shared by its standalone kernel
// (scan_preprocess_2d.cu) and the 2D step's one launch of K1 and K2
// (voxel_filter.cu, `scan_filter_2d`): the same functions in both, built with
// -fmad=false, so both give the same bits.
//
// Per point: the unwarp pose (translation lerp, shortest-arc slerp with the
// linear branch when sin(theta) < 1e-6, as transform/quaternion.py:116-128),
// the range gate, the clamp of misses to missing_data_ray_length, the
// alignment T = R_gravity * pose_end^-1 and the z crop. The scan-level
// quantities (the slerp angle, the alignment) come from five pose vectors
// in device memory, so a launch needs no host copy of the poses.
//
// Robots: each input is robot 0's row plus the robot's index times that
// input's robot stride (in elements: a row of the tick's upload, or 0 for
// one robot); the outputs are contiguous (robots, n, ...).
//
// Everything here is in an unnamed namespace: a source that includes it
// keeps its own copy (a shared symbol across the process's libraries made a
// launch fail with CUDA error 912).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace scan2d {

struct Quat {
  float w, x, y, z;
};

__device__ inline Quat load_quat(const float* q) { return {q[0], q[1], q[2], q[3]}; }

__device__ inline Quat qmul(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ inline Quat qnormalize(Quat q) {
  float n = sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

// v + w*t + qv x t with t = 2 qv x v (transform/quaternion.py:rotate).
__device__ inline void qrotate(Quat q, const float v[3], float out[3]) {
  float t0 = 2.0f * (q.y * v[2] - q.z * v[1]);
  float t1 = 2.0f * (q.z * v[0] - q.x * v[2]);
  float t2 = 2.0f * (q.x * v[1] - q.y * v[0]);
  out[0] = v[0] + q.w * t0 + (q.y * t2 - q.z * t1);
  out[1] = v[1] + q.w * t1 + (q.z * t0 - q.x * t2);
  out[2] = v[2] + q.w * t2 + (q.x * t1 - q.y * t0);
}

__device__ inline void transform(Quat q, const float t[3], const float v[3], float out[3]) {
  qrotate(q, v, out);
  out[0] += t[0];
  out[1] += t[1];
  out[2] += t[2];
}

// The robot strides of the nine inputs, in elements.
struct Strides {
  long long points, times01, mask, origins, ps_t, ps_q, pe_t, pe_q, gravity_q;
};

// A launch's K1 inputs, parameters and outputs (robot 0's).
struct ScanArgs {
  const float* points;   // (n, 3)
  const float* times01;  // (n,)
  const uint8_t* mask;   // (n,)
  const float* origins;  // (n, 3)
  const float *ps_t, *ps_q, *pe_t, *pe_q, *gravity_q;
  Strides rs;
  float min_range, max_range, min_z, max_z, missing_data_ray_length;
  float* hits;          // (robots, n, 3)
  float* misses;        // (robots, n, 2)
  uint8_t* is_return;   // (robots, n)
  uint8_t* is_miss;     // (robots, n)
  float* origin;        // (robots, 3)
};

// One robot's input rows.
struct Rows {
  const float *points, *times01, *origins;
  const uint8_t* mask;
};

__device__ inline Rows rows_of(const ScanArgs& s, long long r) {
  return {s.points + r * s.rs.points, s.times01 + r * s.rs.times01,
          s.origins + r * s.rs.origins, s.mask + r * s.rs.mask};
}

// Point i's inputs.
struct Loaded {
  float f, pt[3], o[3];
  bool valid;
};

__device__ inline Loaded load_point(const Rows& w, int i) {
  return {w.times01[i],
          {w.points[3 * i], w.points[3 * i + 1], w.points[3 * i + 2]},
          {w.origins[3 * i], w.origins[3 * i + 1], w.origins[3 * i + 2]},
          w.mask[i] != 0};
}

// One robot's scan-level quantities.
struct ScanPose {
  float ps_t[3], pe_t[3];
  Quat a, b;  // the slerp's ends, b on a's side
  float theta, sin_theta;
  bool near;  // the linear branch
  Quat align_q;
  float align_t[3];
};

__device__ inline ScanPose scan_pose(const ScanArgs& s, long long r) {
  ScanPose p;
  const float* ps_t = s.ps_t + r * s.rs.ps_t;
  const float* pe_t = s.pe_t + r * s.rs.pe_t;
  const float* pe_q = s.pe_q + r * s.rs.pe_q;
  for (int k = 0; k < 3; ++k) {
    p.ps_t[k] = ps_t[k];
    p.pe_t[k] = pe_t[k];
  }
  p.a = load_quat(s.ps_q + r * s.rs.ps_q);
  p.b = load_quat(pe_q);
  float dot = p.a.w * p.b.w + p.a.x * p.b.x + p.a.y * p.b.y + p.a.z * p.b.z;
  if (dot < 0.0f) {
    p.b = {-p.b.w, -p.b.x, -p.b.y, -p.b.z};
  }
  dot = fabsf(dot);
  p.theta = acosf(fminf(fmaxf(dot, -1.0f), 1.0f));
  p.sin_theta = sinf(p.theta);
  p.near = p.sin_theta < 1e-6f;

  // align = Rigid3(0, gravity) * pose_end^-1.
  Quat pe = load_quat(pe_q);
  Quat pe_inv = {pe.w, -pe.x, -pe.y, -pe.z};
  float neg_pe_t[3] = {-p.pe_t[0], -p.pe_t[1], -p.pe_t[2]};
  float pe_inv_t[3];
  qrotate(pe_inv, neg_pe_t, pe_inv_t);
  Quat g = load_quat(s.gravity_q + r * s.rs.gravity_q);
  qrotate(g, pe_inv_t, p.align_t);
  p.align_q = qnormalize(qmul(g, pe_inv));
  return p;
}

// Point i of a scan, gravity-aligned.
struct Aligned {
  float hit[3], miss[3];
  bool is_return, is_miss;
};

__device__ inline Aligned align_loaded(const ScanArgs& s, const ScanPose& p, const Loaded& in) {
  // Per-point pose between the scan-start and scan-end poses.
  const float f = in.f;
  float t[3];
  for (int k = 0; k < 3; ++k) t[k] = p.ps_t[k] + f * (p.pe_t[k] - p.ps_t[k]);
  const Quat a = p.a, b = p.b;
  float wa = p.near ? 1.0f - f : sinf((1.0f - f) * p.theta) / p.sin_theta;
  float wb = p.near ? f : sinf(f * p.theta) / p.sin_theta;
  Quat q = qnormalize({wa * a.w + wb * b.w, wa * a.x + wb * b.x,
                       wa * a.y + wb * b.y, wa * a.z + wb * b.z});

  float hit[3], org[3];
  transform(q, t, in.pt, hit);
  transform(q, t, in.o, org);
  float d[3] = {hit[0] - org[0], hit[1] - org[1], hit[2] - org[2]};
  float range = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  const bool valid = in.valid;
  Aligned out;
  out.is_return = valid && range >= s.min_range && range <= s.max_range;
  out.is_miss = valid && range > s.max_range;
  float scale = s.missing_data_ray_length / fmaxf(range, 1e-6f);
  float miss[3] = {org[0] + d[0] * scale, org[1] + d[1] * scale, org[2] + d[2] * scale};
  transform(p.align_q, p.align_t, hit, out.hit);
  transform(p.align_q, p.align_t, miss, out.miss);
  out.is_return = out.is_return && out.hit[2] >= s.min_z && out.hit[2] <= s.max_z;
  out.is_miss = out.is_miss && out.miss[2] >= s.min_z && out.miss[2] <= s.max_z;
  return out;
}

__device__ inline Aligned align_point(const ScanArgs& s, const ScanPose& p, const Rows& w,
                                     int i) {
  return align_loaded(s, p, load_point(w, i));
}

// Writes robot r's point i.
__device__ inline void write_point(const ScanArgs& s, long long r, int n, int i,
                                   const Aligned& v) {
  const long long at = r * n + i;
  s.hits[3 * at] = v.hit[0];
  s.hits[3 * at + 1] = v.hit[1];
  s.hits[3 * at + 2] = v.hit[2];
  s.misses[2 * at] = v.miss[0];
  s.misses[2 * at + 1] = v.miss[1];
  s.is_return[at] = v.is_return;
  s.is_miss[at] = v.is_miss;
}

// Writes robot r's aligned sensor origin (the scan-end position).
__device__ inline void write_origin(const ScanArgs& s, const ScanPose& p, long long r) {
  transform(p.align_q, p.align_t, p.pe_t, s.origin + 3 * r);
}

}  // namespace scan2d
}  // namespace
