// K1 scan_preprocess_2d, the standalone launch
//
// Replaces: cartographer_tpu/ops/scan_pipeline_2d.py:preprocess_scan_2d
// (l.40-104) up to its voxel filter (that is K2, voxel_filter.cu).
//
// The 2D step runs K1 inside K2's launch (voxel_filter.cu `scan_filter_2d`);
// this launch computes the same outputs alone, from the same per-point code
// (scan_preprocess_2d.cuh), and gives the fused launch's K1 outputs their
// reference on the card, bit for bit.
//
// Robots: blockIdx.y is the robot of a cross-robot batch (the JAX
// package's _batched_step_cached vmaps the step over robots). One robot is
// the grid's R = 1 case: the same kernel body (instantiated with the robot
// index 0) and the same C entry point.
//
// Bound: bytes. One pass over the scans: it reads 3+3+1 floats and one mask
// byte per point and writes 3+2 floats and two mask bytes, about 50 bytes a
// point; the arithmetic (two quaternion rotations, a slerp) is small.
// Design: one thread per point, every scan-level quantity recomputed per
// thread from five small pose vectors read from device memory.
// Built with -fmad=false so that the rounding follows the PyTorch twin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_preprocess_2d.cuh"

namespace {

// kRobots: a launch for several robots (blockIdx.y); one robot's launch
// instantiates the same body with r = 0, at the one-robot kernel's cost.
template <bool kRobots>
__global__ void scan_preprocess_2d_kernel(const scan2d::ScanArgs s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = kRobots ? blockIdx.y : 0;
  const scan2d::ScanPose p = scan2d::scan_pose(s, r);
  scan2d::write_point(s, r, n, i, scan2d::align_point(s, p, scan2d::rows_of(s, r), i));
  if (i == 0) scan2d::write_origin(s, p, r);
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
  const scan2d::ScanArgs s = {
      (const float*)points, (const float*)times01, (const uint8_t*)mask, (const float*)origins,
      (const float*)ps_t, (const float*)ps_q, (const float*)pe_t, (const float*)pe_q,
      (const float*)gravity_q, {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]},
      min_range, max_range, min_z, max_z, missing_data_ray_length, (float*)hits_out,
      (float*)misses_out, (uint8_t*)is_return_out, (uint8_t*)is_miss_out, (float*)origin_out};
  const int threads = 256;
  const dim3 blocks((n + threads - 1) / threads, robots);
  auto kernel =
      robots == 1 ? scan_preprocess_2d_kernel<false> : scan_preprocess_2d_kernel<true>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(s, n);
  return (int)cudaGetLastError();
}
