// K7: the step-length sandwich W = L^-1 dM L^-T with M = L L^T, batched,
// one thread block per matrix.
//
// Replaces ops/pallas_xf.py:_steplen_sandwich_kernel_k (wrapper
// xf_steplen_sandwich_pallas_k, caller solver._step_length_lambda_pallas):
// per block, the K-limb Cholesky of M with a positive-pivot flag per
// column, W1 = L^-1 dM by forward substitution one row at a time (dM's
// rows as right-hand sides), then X = W1 L^-T by columns,
// X[:, j] = (W1[:, j] - sum_{t<j} X[:, t] L[j, t]) / L[j, j], and the
// output is the plain float64 value of X, limb 0 + limb 1, for the
// float64 Jacobi eigenvalue bound that follows.  The plain PyTorch version
// is clrs_tpu_torch/ops/cuda_xf.py:steplen_sandwich_xf_torch; it performs
// the same operations in the same order.
//
// What bounds it: latency, as for K5, whose design and Cholesky and row
// solve it shares (chol_xf.cuh): chains of K-limb div and sqrt in one
// thread block per matrix, the solver's blocks being 5-6 wide on config 1.
// The column solve gives one thread to each row i of X: a row of X depends
// only on the same row of W1 and on L, so the threads never wait on each
// other there.  As in the Pallas kernel, the contraction runs over all n
// terms with L[j, t] multiplied by the mask t < j: the masked terms enter
// the halving tree as the signed-zero products the reference forms (a
// cascade add of zero is not a bitwise identity), and X overwrites W1 in
// place, column by column.
#include <cuda_runtime.h>

#include "chol_xf.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(clrs::kMaxRows)
    steplen_xf_kernel(const double* __restrict__ m, const double* __restrict__ dm,
                      double* __restrict__ w, double* __restrict__ okf,
                      double* __restrict__ scratch, int n, int np2) {
  using namespace clrs;
  const size_t nn = (size_t)n * n;
  const size_t pn = (size_t)n * np2;
  const size_t b = blockIdx.x;
  double* L = scratch + b * (2 * K * nn + K * pn);
  double* X = L + K * nn;  // W1, then X column by column
  double* P = X + K * nn;

  block_cholesky_xf<K>(m + b * K * nn, L, P, okf + b * n, n, np2);
  block_forward_rows_xf<K>(L, dm + b * K * nn, X, P, n, np2);

  const int i = threadIdx.x;
  if (i >= n) return;
  double x[K], s[K], c[K], y[K];
  for (int j = 0; j < n; ++j) {
    matvec_xf<K>(
        P, i, n, np2, [&](int t, double(&v)[K]) { load_xf<K>(X + (size_t)i * n + t, nn, v); },
        [&](int t, double(&v)[K]) {
          const double mask = t < j ? 1.0 : 0.0;
          load_xf<K>(L + (size_t)j * n + t, nn, v);
#pragma unroll
          for (int q = 0; q < K; ++q) v[q] = v[q] * mask;
        },
        c);
#pragma unroll
    for (int q = 0; q < K; ++q) c[q] = -c[q];
    load_xf<K>(X + (size_t)i * n + j, nn, x);
    xf_add_n<K>(x, c, s);
    load_xf<K>(L + (size_t)j * n + j, nn, y);
    xf_div<K>(s, y, c);
    store_xf<K>(X + (size_t)i * n + j, nn, c);
  }
  for (int j = 0; j < n; ++j) {
    const size_t e = (size_t)i * n + j;
    w[b * nn + e] = X[e] + X[nn + e];
  }
}

template <int K>
int launch(const double* m, const double* dm, double* w, double* okf, double* scratch,
           int B, int n, int np2, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n > clrs::kMaxRows) return (int)cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  steplen_xf_kernel<K><<<B, threads, 0, stream>>>(m, dm, w, okf, scratch, n, np2);
  return (int)cudaGetLastError();
}

}  // namespace

// m, dm: (B, k, n, n) float64; w: (B, n, n) float64; okf: (B, n) float64
// flags (1.0 / 0.0); scratch: B * (2 k n^2 + k n np2) float64, np2 the
// power of two >= n.  Returns -1 for a limb count the library was not
// built for.
extern "C" int clrs_steplen_xf(int k, const double* m, const double* dm, double* w,
                               double* okf, double* scratch, int B, int n, int np2,
                               void* stream) {
  switch (k) {
#define CLRS_CASE(K)                                                                \
  case K:                                                                           \
    return launch<K>(m, dm, w, okf, scratch, B, n, np2, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
