// The K-limb Cholesky and forward substitution that K5
// (spd_inverse_xf.cu) and K7 (steplen_xf.cu) share, one thread block per
// matrix, as the Pallas kernels share them (pallas_xf.py:753-812 and
// :908-965).  Every thread of the block must call these functions: they
// synchronize the block.  Matrices are K limbs of n x n entries, limb q of
// entry e at X[q * n * n + e]; P holds one product vector of np2 entries
// per thread (limb stride n * np2), np2 the power of two >= n.
#pragma once

#include "eft.cuh"

namespace clrs {

// One thread per row: a block holds at most kMaxRows threads, as many as the
// register file takes at k = 10..12, where a thread uses up to 255
// registers.  Wrappers refuse larger n (ops/cuda_xf.py: MAX_ROWS).
constexpr int kMaxRows = 256;

// Product vector of thread `row`: p[t] = x(t) * y(t) for t < n, zeros up to
// np2, then the zero-padded halving sum into r.
template <int K, class X, class Y>
__device__ __forceinline__ void matvec_xf(double* P, int row, int n, int np2, X x_of,
                                          Y y_of, double (&r)[K]) {
  const size_t pn = (size_t)n * np2;
  double* p = P + (size_t)row * np2;
  double x[K], y[K], c[K];
  for (int t = 0; t < n; ++t) {
    x_of(t, x);
    y_of(t, y);
    xf_mul_n<K>(x, y, c);
    store_xf<K>(p + t, pn, c);
  }
  for (int t = n; t < np2; ++t)
    for (int q = 0; q < K; ++q) p[q * pn + t] = 0.0;
  xf_halving_sum<K>(p, pn, np2, r);
}

// A = L L^T by columns: thread i forms s_i = A[i, j] - sum_t L[i, t] L[j, t],
// the pivot's leading limb sets ok[j] (1.0 / 0.0), a non-positive pivot is
// replaced by 1 so that the factorization runs to its end.  L is zeroed
// here; ok holds n flags.
template <int K>
__device__ void block_cholesky_xf(const double* A, double* L, double* P, double* ok,
                                  int n, int np2) {
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;
  const bool active = tid < n;
  __shared__ double piv[K];
  for (size_t e = tid; e < K * nn; e += blockDim.x) L[e] = 0.0;
  if (active) ok[tid] = 1.0;
  __syncthreads();

  double x[K], s[K], c[K];
  for (int j = 0; j < n; ++j) {
    if (active) {
      const int i = tid;
      matvec_xf<K>(
          P, i, n, np2, [&](int t, double(&v)[K]) { load_xf<K>(L + (size_t)i * n + t, nn, v); },
          [&](int t, double(&v)[K]) { load_xf<K>(L + (size_t)j * n + t, nn, v); }, c);
#pragma unroll
      for (int q = 0; q < K; ++q) c[q] = -c[q];
      load_xf<K>(A + (size_t)i * n + j, nn, x);
      xf_add_n<K>(x, c, s);
      if (i == j)
        for (int q = 0; q < K; ++q) piv[q] = s[q];
    }
    __syncthreads();
    const bool pos = piv[0] > 0.0;
    if (tid == 0) ok[j] = pos ? 1.0 : 0.0;
    double d[K], ljj[K];
#pragma unroll
    for (int q = 0; q < K; ++q) d[q] = pos ? piv[q] : (q == 0 ? 1.0 : 0.0);
    xf_sqrt<K>(d, ljj);
    if (active) {
      const int i = tid;
      xf_div<K>(s, ljj, c);
#pragma unroll
      for (int q = 0; q < K; ++q) c[q] = i == j ? ljj[q] : (i < j ? 0.0 : c[q]);
      store_xf<K>(L + (size_t)i * n + j, nn, c);
    }
    __syncthreads();
  }
}

// W = L^-1 R by forward substitution, one row at a time: thread col solves
// column col, W[i, col] = (R[i, col] - sum_t L[i, t] W[t, col]) / L[i, i],
// the sum over all t (rows t >= i of W still zero).  R = nullptr takes the
// identity.  A thread reads and writes only its own column of W, so the
// rows need no barrier between them; W is zeroed here and the block is
// synchronized on return.
template <int K>
__device__ void block_forward_rows_xf(const double* L, const double* R, double* W,
                                      double* P, int n, int np2) {
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;
  for (size_t e = tid; e < K * nn; e += blockDim.x) W[e] = 0.0;
  __syncthreads();
  if (tid < n) {
    const int col = tid;
    double x[K], s[K], c[K], y[K];
    for (int i = 0; i < n; ++i) {
      matvec_xf<K>(
          P, col, n, np2,
          [&](int t, double(&v)[K]) { load_xf<K>(L + (size_t)i * n + t, nn, v); },
          [&](int t, double(&v)[K]) { load_xf<K>(W + (size_t)t * n + col, nn, v); }, c);
#pragma unroll
      for (int q = 0; q < K; ++q) c[q] = -c[q];
      if (R != nullptr) {
        load_xf<K>(R + (size_t)i * n + col, nn, x);
      } else {
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = (q == 0 && col == i) ? 1.0 : 0.0;
      }
      xf_add_n<K>(x, c, s);
      load_xf<K>(L + (size_t)i * n + i, nn, y);
      xf_div<K>(s, y, c);
      store_xf<K>(W + (size_t)i * n + col, nn, c);
    }
  }
  __syncthreads();
}

}  // namespace clrs
