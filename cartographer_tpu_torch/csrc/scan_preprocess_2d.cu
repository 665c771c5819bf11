// K1 scan_preprocess_2d
//
// Replaces: cartographer_tpu/ops/scan_pipeline_2d.py:preprocess_scan_2d
// (l.40-104) up to its voxel filter (that is K2, voxel_filter.cu).
//
// Per point: the unwarp pose (translation lerp, shortest-arc slerp with the
// linear branch when sin(theta) < 1e-6, as transform/quaternion.py:116-128),
// the range gate, the clamp of misses to missing_data_ray_length, the
// alignment T = R_gravity * pose_end^-1 and the z crop.
//
// Robots: blockIdx.y is the robot of a cross-robot batch (the JAX
// package's _batched_step_cached vmaps the step over robots). Each input
// is robot 0's row plus the robot's index times that input's robot stride
// (in elements: a row of the tick's upload, or 0 for one robot); the
// outputs are contiguous (robots, n, ...). One robot is the grid's R = 1
// case: the same kernel body (instantiated with the robot index 0) and the
// same C entry point.
//
// Bound: bytes. One pass over the scans: it reads 3+3+1 floats and one mask
// byte per point and writes 3+2 floats and two mask bytes, about 50 bytes a
// point; the arithmetic (two quaternion rotations, a slerp) is small.
// Design: one thread per point, every scan-level quantity (the slerp angle,
// the alignment) recomputed per thread from five small pose vectors read
// from device memory, so the launch needs no host copy of the poses.
// Built with -fmad=false so that the rounding follows the PyTorch twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// kRobots: a launch for several robots (blockIdx.y); one robot's launch
// instantiates the same body with r = 0, at the one-robot kernel's cost.
template <bool kRobots>
__global__ void scan_preprocess_2d_kernel(
    const float* __restrict__ points, const float* __restrict__ times01,
    const uint8_t* __restrict__ mask, const float* __restrict__ origins,
    const float* __restrict__ ps_t, const float* __restrict__ ps_q,
    const float* __restrict__ pe_t, const float* __restrict__ pe_q,
    const float* __restrict__ gravity_q, Strides rs, int n, float min_range,
    float max_range, float min_z, float max_z, float missing_data_ray_length,
    float* __restrict__ hits_out, float* __restrict__ misses_out,
    uint8_t* __restrict__ is_return_out, uint8_t* __restrict__ is_miss_out,
    float* __restrict__ origin_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = kRobots ? blockIdx.y : 0;
  points += r * rs.points;
  times01 += r * rs.times01;
  mask += r * rs.mask;
  origins += r * rs.origins;
  ps_t += r * rs.ps_t;
  ps_q += r * rs.ps_q;
  pe_t += r * rs.pe_t;
  pe_q += r * rs.pe_q;
  gravity_q += r * rs.gravity_q;
  hits_out += r * 3 * n;
  misses_out += r * 2 * n;
  is_return_out += r * n;
  is_miss_out += r * n;
  origin_out += r * 3;

  // Per-point pose between the scan-start and scan-end poses.
  float f = times01[i];
  float t[3];
  for (int k = 0; k < 3; ++k) t[k] = ps_t[k] + f * (pe_t[k] - ps_t[k]);
  Quat a = load_quat(ps_q), b = load_quat(pe_q);
  float dot = a.w * b.w + a.x * b.x + a.y * b.y + a.z * b.z;
  if (dot < 0.0f) {
    b = {-b.w, -b.x, -b.y, -b.z};
  }
  dot = fabsf(dot);
  float theta = acosf(fminf(fmaxf(dot, -1.0f), 1.0f));
  float sin_theta = sinf(theta);
  bool near = sin_theta < 1e-6f;
  float wa = near ? 1.0f - f : sinf((1.0f - f) * theta) / sin_theta;
  float wb = near ? f : sinf(f * theta) / sin_theta;
  Quat q = qnormalize({wa * a.w + wb * b.w, wa * a.x + wb * b.x,
                       wa * a.y + wb * b.y, wa * a.z + wb * b.z});

  float p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
  float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  float hit[3], org[3];
  transform(q, t, p, hit);
  transform(q, t, o, org);
  float d[3] = {hit[0] - org[0], hit[1] - org[1], hit[2] - org[2]};
  float range = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  bool valid = mask[i] != 0;
  bool is_return = valid && range >= min_range && range <= max_range;
  bool is_miss = valid && range > max_range;
  float scale = missing_data_ray_length / fmaxf(range, 1e-6f);
  float miss[3] = {org[0] + d[0] * scale, org[1] + d[1] * scale, org[2] + d[2] * scale};

  // align = Rigid3(0, gravity) * pose_end^-1.
  Quat pe = load_quat(pe_q);
  Quat pe_inv = {pe.w, -pe.x, -pe.y, -pe.z};
  float neg_pe_t[3] = {-pe_t[0], -pe_t[1], -pe_t[2]};
  float pe_inv_t[3];
  qrotate(pe_inv, neg_pe_t, pe_inv_t);
  Quat g = load_quat(gravity_q);
  float align_t[3];
  qrotate(g, pe_inv_t, align_t);
  Quat align_q = qnormalize(qmul(g, pe_inv));

  float hit_a[3], miss_a[3];
  transform(align_q, align_t, hit, hit_a);
  transform(align_q, align_t, miss, miss_a);
  is_return = is_return && hit_a[2] >= min_z && hit_a[2] <= max_z;
  is_miss = is_miss && miss_a[2] >= min_z && miss_a[2] <= max_z;

  hits_out[3 * i] = hit_a[0];
  hits_out[3 * i + 1] = hit_a[1];
  hits_out[3 * i + 2] = hit_a[2];
  misses_out[2 * i] = miss_a[0];
  misses_out[2 * i + 1] = miss_a[1];
  is_return_out[i] = is_return;
  is_miss_out[i] = is_miss;
  if (i == 0) {
    float pe_t3[3] = {pe_t[0], pe_t[1], pe_t[2]};
    transform(align_q, align_t, pe_t3, origin_out);
  }
}

}  // namespace

// `strides` (host memory): the nine inputs' robot strides, in elements.
extern "C" int scan_preprocess_2d(
    const void* points, const void* times01, const void* mask, const void* origins,
    const void* ps_t, const void* ps_q, const void* pe_t, const void* pe_q,
    const void* gravity_q, const void* strides, int robots, int n, float min_range,
    float max_range, float min_z, float max_z, float missing_data_ray_length, void* hits_out,
    void* misses_out, void* is_return_out, void* is_miss_out, void* origin_out, void* stream) {
  if (robots < 1 || robots > 65535 || n < 1 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* st = (const long long*)strides;
  Strides rs = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  const int threads = 256;
  const dim3 blocks((n + threads - 1) / threads, robots);
  auto kernel =
      robots == 1 ? scan_preprocess_2d_kernel<false> : scan_preprocess_2d_kernel<true>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)times01, (const uint8_t*)mask,
      (const float*)origins, (const float*)ps_t, (const float*)ps_q,
      (const float*)pe_t, (const float*)pe_q, (const float*)gravity_q, rs, n, min_range,
      max_range, min_z, max_z, missing_data_ray_length, (float*)hits_out,
      (float*)misses_out, (uint8_t*)is_return_out, (uint8_t*)is_miss_out,
      (float*)origin_out);
  return (int)cudaGetLastError();
}
