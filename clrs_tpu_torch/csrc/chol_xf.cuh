// The K-limb Cholesky and forward substitution that K1 and K5
// (spd_inverse_xf.cu) and K7 (steplen_xf.cu) share, one thread block per
// matrix, as the Pallas kernels share them (pallas_xf.py:753-812 and
// :908-965), and the dot product both build on.  Every thread of the block
// must call these functions: they synchronize the block, and their dot
// products shuffle within each warp.  The input matrix is read in place
// through an XfView (any limb, row and column strides); L and the solve's
// output are K limbs of n x n entries, limb q of entry e at X[q * n * n +
// e]; S holds one K-limb value per row (limb q of row i at S[q * n + i]),
// in shared memory, and Rcp one per diagonal entry of L, in scratch.
//
// Each dot product of the reference is a zero-padded halving tree
// (xops.sum_axis) over np2 = the power of two >= n terms: level by level,
// term t takes term t + half.  A group of G = min(np2, 32) lanes forms
// one: lane l holds the terms t = l + G m (m < np2 / G), so the levels with
// half >= G pair terms of the same lane and the levels below pair lane l
// with lane l + half, which __shfl_down_sync(., half, G) delivers.  The
// same additions in the same order, with no trip through memory: a dot
// product is one multiply and log2(np2) dependent adds.  Each Cholesky
// column and each solve row is then two steps with a barrier after each:
// a group per row (column) forms s = a - dot into S, and the threads then
// finish the rows (columns), a row each while n <= blockDim.x, with the
// K-limb sqrt and div, whose dependent chains set the kernels' time.  The
// div of a solve step is by a diagonal entry of L, final since its column
// of the Cholesky: the thread that stores L[j, j] also stores its
// reciprocal xf_recip(L[j, j]) in Rcp, and the solves run only the five
// operations of xf_div that follow the reciprocal (eft.cuh: xf_div_recip),
// the same operations on the same values, so the same bits, with the
// reciprocal's Newton steps (12 of a k=3 div's 17 cascades) off their
// chains.
#pragma once

#include <cuda_runtime.h>

#include "eft.cuh"

namespace clrs {

// At k = 10..12 a thread takes up to 255 registers, so a block holds at
// most 256 threads, and the rows a kernel takes are capped at 256 for
// K >= 3; at K=2 (K1, and K7 at k=2) at 1024, K1's range, each of the
// 256 threads finishing up to 4 rows.  The wrappers refuse n
// above the cap (ops/cuda_dd.py: max_rows).  The block stays at 256
// threads at K=2 too: 1024 would hold a thread to 64 registers, under
// what the lane terms of a 1024-row dot product take.
template <int K>
constexpr int kMaxRows = K == 2 ? 1024 : 256;
constexpr int kBlockThreads = 256;
// Terms a lane holds: np2 / 32 for n up to kMaxRows.
template <int K>
constexpr int kMaxLaneTerms = kMaxRows<K> / 32;

// A K-limb n x n matrix read where it lies: limb q of entry (i, j) at
// p[q * ls + i * rs + j * cs].
struct XfView {
  const double* p;
  long long ls, rs, cs;
  __device__ __forceinline__ const double* at(int i, int j) const {
    return p + i * rs + j * cs;
  }
};

// The width of a dot product's halving tree: the power of two >= n.
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

__host__ __device__ inline int group_width(int np2) { return np2 < 32 ? np2 : 32; }

// Threads of a block: a group for every row at once where 256 threads
// allow.
inline int block_threads(int n, int np2) {
  const int want = (n * group_width(np2) + 31) / 32 * 32;
  return want < kBlockThreads ? want : kBlockThreads;
}

// sum_{t < n} x(t) y(t) by the zero-padded halving tree of width np2,
// formed by the group of G = group_width(np2) lanes that holds this lane
// (lane l = threadIdx.x % G of it); the sum is valid in the group's lane 0.
// A group with no row to take passes active = false and sums zeros.  All
// 32 lanes of a warp call this together.
template <int K, class X, class Y>
__device__ __forceinline__ void group_dot(int n, int np2, bool active, X x_of, Y y_of,
                                          double (&r)[K]) {
  const int G = group_width(np2);
  const int M = np2 / G;  // terms per lane
  const int l = threadIdx.x % G;
  auto term = [&](int t, double(&p)[K]) {
    if (active && t < n) {
      double x[K], y[K];
      x_of(t, x);
      y_of(t, y);
      xf_mul_c<K>(x, y, p);
    } else {
#pragma unroll
      for (int q = 0; q < K; ++q) p[q] = 0.0;
    }
  };
  if (M == 1) {
    term(l, r);
  } else {
    // the levels with half >= G, inside the lane: the first one as the
    // terms are formed, then M/4, ..., 1
    double p[kMaxLaneTerms<K> / 2][K];
#pragma unroll
    for (int m = 0; m < kMaxLaneTerms<K> / 2; ++m) {
      if (m < M / 2) {
        double u[K], v[K];
        term(l + G * m, u);
        term(l + G * (m + M / 2), v);
        xf_add_c<K>(u, v, p[m]);
      }
    }
#pragma unroll
    for (int h = kMaxLaneTerms<K> / 4; h >= 1; h /= 2) {
      if (2 * h <= M / 2) {
#pragma unroll
        for (int m = 0; m < h; ++m) xf_add_c<K>(p[m], p[m + h], p[m]);
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) r[q] = p[0][q];
  }
  // the levels with half < G, across the group's lanes
  for (int half = G / 2; half >= 1; half /= 2) {
    double y[K];
#pragma unroll
    for (int q = 0; q < K; ++q) y[q] = __shfl_down_sync(0xffffffffu, r[q], half, G);
    xf_add_c<K>(r, y, r);
  }
}

// A = L L^T by columns: for column j, a group per row i >= j forms
// s_i = A[i, j] - sum_t L[i, t] L[j, t] into S, then the threads finish
// the rows: each takes the pivot s_j, whose leading limb sets ok[j] (1.0 /
// 0.0), a non-positive pivot replaced by 1 so that the factorization runs
// to its end, and its square root L[j, j]; row j stores it and its
// reciprocal Rcp[j], every row i > j L[i, j] = s_i / L[j, j].  Rows i < j
// keep the zero they start with.  L is zeroed here; ok holds n flags, Rcp
// n K-limb values (limb q of entry j at Rcp[q * n + j]).
template <int K>
__device__ void block_cholesky_xf(XfView A, double* L, double* Rcp, double* S, double* ok,
                                  int n, int np2) {
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;
  const int G = group_width(np2);
  const int group = tid / G, groups = blockDim.x / G;
  for (size_t e = tid; e < K * nn; e += blockDim.x) L[e] = 0.0;
  for (int r = tid; r < n; r += blockDim.x) ok[r] = 1.0;
  __syncthreads();

  double x[K], s[K], c[K];
  for (int j = 0; j < n; ++j) {
    for (int i0 = j; i0 < n; i0 += groups) {
      const int i = i0 + group;
      const bool active = i < n;
      group_dot<K>(
          n, np2, active,
          [&](int t, double(&v)[K]) { load_xf<K>(L + (size_t)i * n + t, nn, v); },
          [&](int t, double(&v)[K]) { load_xf<K>(L + (size_t)j * n + t, nn, v); }, c);
      if (active && tid % G == 0) {
#pragma unroll
        for (int q = 0; q < K; ++q) c[q] = -c[q];
        load_xf<K>(A.at(i, j), A.ls, x);
        xf_add_c<K>(x, c, s);
        store_xf<K>(S + i, n, s);
      }
    }
    __syncthreads();
    const bool pos = S[j] > 0.0;
    if (tid == 0) ok[j] = pos ? 1.0 : 0.0;
    int r = tid;  // this thread's first row >= j
    while (r < j) r += blockDim.x;
    if (r < n) {
      double d[K], ljj[K];
#pragma unroll
      for (int q = 0; q < K; ++q) d[q] = pos ? S[q * n + j] : (q == 0 ? 1.0 : 0.0);
      xf_sqrt<K>(d, ljj);
      for (; r < n; r += blockDim.x) {
        if (r == j) {
          store_xf<K>(L + (size_t)j * n + j, nn, ljj);
          xf_recip<K>(ljj, c);
          store_xf<K>(Rcp + j, n, c);
        } else {
          load_xf<K>(S + r, n, s);
          xf_div<K>(s, ljj, c);
          store_xf<K>(L + (size_t)r * n + j, nn, c);
        }
      }
    }
    __syncthreads();
  }
}

// W = L^-1 R by forward substitution, one row at a time: for row i, a
// group per column forms s = R[i, col] - sum_t L[i, t] W[t, col] over all
// t (rows t >= i of W still zero) into S, then the threads finish the
// columns, W[i, col] = s / L[i, i] with the reciprocal Rcp[i] of the
// Cholesky.  R.p = nullptr takes the identity.  W is zeroed here and the
// block is synchronized on return.
template <int K>
__device__ void block_forward_rows_xf(const double* L, const double* Rcp, XfView R,
                                      double* W, double* S, int n, int np2) {
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;
  const int G = group_width(np2);
  const int group = tid / G, groups = blockDim.x / G;
  for (size_t e = tid; e < K * nn; e += blockDim.x) W[e] = 0.0;
  __syncthreads();
  double x[K], s[K], c[K], y[K], rc[K];
  for (int i = 0; i < n; ++i) {
    for (int c0 = 0; c0 < n; c0 += groups) {
      const int col = c0 + group;
      const bool active = col < n;
      group_dot<K>(
          n, np2, active,
          [&](int t, double(&v)[K]) { load_xf<K>(L + (size_t)i * n + t, nn, v); },
          [&](int t, double(&v)[K]) { load_xf<K>(W + (size_t)t * n + col, nn, v); }, c);
      if (active && tid % G == 0) {
#pragma unroll
        for (int q = 0; q < K; ++q) c[q] = -c[q];
        if (R.p != nullptr) {
          load_xf<K>(R.at(i, col), R.ls, x);
        } else {
#pragma unroll
          for (int q = 0; q < K; ++q) x[q] = (q == 0 && col == i) ? 1.0 : 0.0;
        }
        xf_add_c<K>(x, c, s);
        store_xf<K>(S + col, n, s);
      }
    }
    __syncthreads();
    if (tid < n) {
      load_xf<K>(L + (size_t)i * n + i, nn, y);
      load_xf<K>(Rcp + i, n, rc);
      for (int col = tid; col < n; col += blockDim.x) {
        load_xf<K>(S + col, n, s);
        xf_div_recip<K>(s, y, rc, c);
        store_xf<K>(W + (size_t)i * n + col, nn, c);
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory of a block: S, K n doubles (24.6 KB at n = 256,
// k = 12, and 16 KB at n = 1024, k = 2, inside the default 48 KB).  L, its
// companion (W, or K7's X) and Rcp live in global scratch, K (2 n^2 + n)
// doubles a matrix (scratch_doubles).
template <int K>
inline size_t shared_bytes(int n) {
  return sizeof(double) * (size_t)K * n;
}

template <int K>
__host__ __device__ inline size_t scratch_doubles(int n) {
  return (size_t)K * (2 * (size_t)n * n + n);
}

}  // namespace clrs
