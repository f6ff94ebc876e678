// K5: batched K-limb SPD inverse, one thread block per matrix.
//
// Replaces ops/pallas_xf.py:_spd_inverse_kernel_k (wrappers
// xf_spd_inverse_pallas_k, xf_spd_inverse_pallas_k_batched): per block,
// the Cholesky A = L L^T by columns with a positive-pivot flag on the
// leading limb of each pivot, W = L^-1 by forward substitution one row at a
// time, and A^-1 = W^T W by rank-1 accumulation over the rows of W in
// order, all in K-limb arithmetic.  Every matvec sums through the
// zero-padded halving tree of _XOps.sum_axis.  The plain PyTorch version
// is clrs_tpu_torch/ops/cuda_xf.py:spd_inverse_xf_torch; it performs the
// same operations in the same order.
//
// What bounds it: latency, as for K1 (csrc/spd_inverse_dd.cu), only more
// so: the column loop and the row loop are sequential chains of K-limb
// div and sqrt (a k=3 div alone is 17 cascades), and the solver's blocks
// are small (1-64 wide).  The design is K1's: each matrix stays inside one
// thread block, one thread per row for a Cholesky column, one per column
// for a solve row, one per output entry for W^T W; each thread reduces
// its own product vector in place in global scratch, which takes any n up
// to 1024 without a shared-memory budget.  The cascades run through
// out-of-line K-limb add and multiply (eft.cuh: xf_add_n, xf_mul_n), so
// the many call sites share one body per K: the kernel waits on its
// dependent chain, not on instruction issue, and the build stays short.
// The Mosaic one-hot row, column and pivot picks (pallas_xf.py:755-770)
// are plain indexing here.  The Cholesky and the forward substitution are
// chol_xf.cuh's, which K7 (steplen_xf.cu) shares.
#include <cuda_runtime.h>

#include "chol_xf.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(clrs::kMaxRows)
    spd_inverse_xf_kernel(const double* __restrict__ a, double* __restrict__ out,
                          double* __restrict__ okf, double* __restrict__ scratch, int n,
                          int np2) {
  using namespace clrs;
  const size_t nn = (size_t)n * n;
  const size_t pn = (size_t)n * np2;  // limb stride of the product vectors
  const size_t b = blockIdx.x;
  const double* A = a + b * K * nn;  // limb q of entry e at A[q * nn + e]
  double* O = out + b * K * nn;
  double* L = scratch + b * (2 * K * nn + K * pn);
  double* W = L + K * nn;
  double* P = W + K * nn;  // per-thread product vectors, np2 each

  block_cholesky_xf<K>(A, L, P, okf + b * n, n, np2);
  block_forward_rows_xf<K>(L, nullptr, W, P, n, np2);  // W = L^-1

  const int tid = threadIdx.x;
  double x[K], y[K], c[K];
  // A^-1 = W^T W by sequential rank-1 accumulation over the rows t of W.
  for (size_t e = tid; e < nn; e += blockDim.x) {
    const int r = (int)(e / n), col = (int)(e % n);
    double acc[K];
#pragma unroll
    for (int q = 0; q < K; ++q) acc[q] = 0.0;
    for (int t = 0; t < n; ++t) {
      load_xf<K>(W + (size_t)t * n + r, nn, x);
      load_xf<K>(W + (size_t)t * n + col, nn, y);
      xf_mul_n<K>(x, y, c);
      xf_add_n<K>(acc, c, acc);
    }
    store_xf<K>(O + e, nn, acc);
  }
}

template <int K>
int launch(const double* a, double* out, double* okf, double* scratch, int B, int n,
           int np2, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n > clrs::kMaxRows) return (int)cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  spd_inverse_xf_kernel<K><<<B, threads, 0, stream>>>(a, out, okf, scratch, n, np2);
  return (int)cudaGetLastError();
}

}  // namespace

// a, out: (B, k, n, n) float64; okf: (B, n) float64 flags (1.0 / 0.0);
// scratch: B * (2 k n^2 + k n np2) float64, np2 the power of two >= n.
// Returns -1 for a limb count the library was not built for.
extern "C" int clrs_spd_inverse_xf(int k, const double* a, double* out, double* okf,
                                   double* scratch, int B, int n, int np2,
                                   void* stream) {
  switch (k) {
#define CLRS_CASE(K)                                                          \
  case K:                                                                     \
    return launch<K>(a, out, okf, scratch, B, n, np2, (cudaStream_t)stream);
    CLRS_FOR_EACH_K(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
