// Global-timer stamps of a kernel's phases, compiled in only with
// -DCARTO_STAMPS: `tests/frontend_3d_timing.py ... stamps` builds such copies
// of K12 and K17 into csrc/_build/variant/. STAMP_IF(cond, k) has the thread
// for which `cond` holds record the global timer (ns) as stamp k, and the
// library exports `stamps_read`, which copies the 64 stamps out. Without the
// flag the macros are empty, and the kernels are built without them.
// STAMP_VALUE(k, v) has block 0's thread 0 record the count v as stamp k.

#pragma once

#include <cuda_runtime.h>

#ifdef CARTO_STAMPS
namespace {
__device__ unsigned long long carto_stamps[64];
}
#define STAMP_IF(cond, k)                                                        \
  do {                                                                           \
    if (cond) {                                                                  \
      unsigned long long t_;                                                     \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                      \
      carto_stamps[k] = t_;                                                      \
    }                                                                            \
  } while (0)
#define STAMP_VALUE(k, v)                                                        \
  do {                                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) carto_stamps[k] = (unsigned long long)(v); \
  } while (0)
extern "C" int stamps_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, carto_stamps, sizeof(carto_stamps));
}
#else
#define STAMP_IF(cond, k) \
  do {                    \
  } while (0)
#define STAMP_VALUE(k, v) \
  do {                    \
  } while (0)
#endif

#define STAMP(k) STAMP_IF(blockIdx.x == 0 && threadIdx.x == 0, k)
