// The first halvings of a pairwise halving tree, folded into one thread.
// Shared by K5 (correlative_2d.cu), K7 (bnb_2d.cu), K13 (rot_histogram.cu)
// and K17 (correlative_3d.cu) above their one-block
// tiles, and by K24 (icp.cu) for its sums over a whole cloud.
//
// Those kernels sum n values (a power of two) in the plain twins' order,
// x[k] + x[k + n / 2] for every k < n / 2, then the same on the result, down
// to one value. For n = T * m (T the tile a block or warp holds, m a power of
// two) the first log2(m) halvings fold x[k + j * T], j < m, into x[k] for each
// k < T; `fold` computes that one value per k, in the same pairing, so the
// tile's own tree then runs as before and the result keeps its bits. The
// pairs of the tree over j are the j that differ in their top bit, then in
// the next, ...: visiting the leaves in bit-reversed order makes each pair
// adjacent, and a stack of log2(m) + 1 partial sums combines two subtrees of
// equal size as soon as both exist.

#pragma once

#include <cuda_runtime.h>

namespace halving {

// K floats added lane by lane: one fold for several sums of the same leaves.
template <int K>
struct Lanes {
  float v[K];
  __device__ Lanes operator+(const Lanes& o) const {
    Lanes r;
    for (int c = 0; c < K; ++c) r.v[c] = v[c] + o.v[c];
    return r;
  }
};

// The halving-tree sum of leaf(j) for j < m (a power of two, m <= 2^31), of
// a type T with operator+ (a float, or a few floats added lane by lane).
template <typename T, typename F>
__device__ inline T fold_of(int m, F leaf) {
  if (m == 1) return leaf(0);
  const int bits = __ffs(m) - 1;  // log2(m) >= 1
  T stack[32];
  int depth = 0;
  for (int i = 0; i < m; ++i) {
    T v = leaf((int)(__brev((unsigned int)i) >> (32 - bits)));
    for (int t = i; t & 1; t >>= 1) v = stack[--depth] + v;
    stack[depth++] = v;
  }
  return stack[0];
}

template <typename F>
__device__ inline float fold(int m, F leaf) {
  return fold_of<float>(m, leaf);
}

}  // namespace halving
