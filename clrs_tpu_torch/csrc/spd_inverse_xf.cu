// K5: batched K-limb SPD inverse, one thread block per matrix.
//
// Replaces ops/pallas_xf.py:_spd_inverse_kernel_k (wrappers
// xf_spd_inverse_pallas_k, xf_spd_inverse_pallas_k_batched): per block,
// the Cholesky A = L L^T by columns with a positive-pivot flag on the
// leading limb of each pivot, W = L^-1 by forward substitution one row at a
// time, and A^-1 = W^T W by rank-1 accumulation over the rows of W in
// order, all in K-limb arithmetic.  Every dot product sums through the
// zero-padded halving tree of _XOps.sum_axis.  The plain PyTorch version
// is clrs_tpu_torch/ops/cuda_xf.py:spd_inverse_xf_torch; it performs the
// same operations in the same order.
//
// What bounds it: latency.  The column loop and the row loop are
// sequential chains of K-limb div and sqrt (a k=3 div alone is 17
// cascades), and the solver's blocks are small (1-64 wide) and come one
// or a few at a time, so one matrix runs on one SM.  The design shortens
// the chain: the Cholesky and the row solve are chol_xf.cuh's, where a
// group of up to 32 lanes forms each dot product with its halving tree in
// registers and shuffles (one multiply and log2(np2) adds deep), and a
// thread per row or column then runs the div.  L and W live in global
// scratch, S in shared memory.  Keeping L and W in shared memory too
// (possible up to n = 68 at k=3, 34 at k=12) measured the same on an H100
// at the solver's shapes and at 64 blocks of 32x32 (0.0996 ms either way
// for S_j 11x11 at k=3; PERF.md section 6): a block's working set stays in
// L1 either way, and the wait is the div chain.  So there is one placement.
// W^T W keeps the reference's sequential rank-1 order for each entry, a
// thread per entry.  The Mosaic one-hot row, column and pivot picks
// (pallas_xf.py:755-770) are plain indexing here.  K7 (steplen_xf.cu)
// shares the Cholesky and the row solve.
#include <cuda_runtime.h>

#include "chol_xf.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(clrs::kBlockThreads)
    spd_inverse_xf_kernel(const double* __restrict__ a, double* __restrict__ out,
                          double* __restrict__ okf, double* __restrict__ scratch, int n,
                          int np2) {
  using namespace clrs;
  extern __shared__ double smem[];
  const size_t nn = (size_t)n * n;
  const size_t b = blockIdx.x;
  const double* A = a + b * K * nn;  // limb q of entry e at A[q * nn + e]
  double* O = out + b * K * nn;
  double* S = smem;
  double* L = scratch + b * 2 * K * nn;
  double* W = L + K * nn;

  block_cholesky_xf<K>(A, L, S, okf + b * n, n, np2);
  block_forward_rows_xf<K>(L, nullptr, W, S, n, np2);  // W = L^-1

  double x[K], y[K], c[K];
  // A^-1 = W^T W by sequential rank-1 accumulation over the rows t of W.
  for (size_t e = threadIdx.x; e < nn; e += blockDim.x) {
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
  spd_inverse_xf_kernel<K><<<B, clrs::block_threads(n, np2), clrs::shared_bytes<K>(n),
                             stream>>>(a, out, okf, scratch, n, np2);
  return (int)cudaGetLastError();
}

}  // namespace

// a, out: (B, k, n, n) float64; okf: (B, n) float64 flags (1.0 / 0.0);
// np2 the power of two >= n; scratch: B * 2 k n^2 float64 for L and W.
// Returns -1 for a limb count the library was not built for.
extern "C" int clrs_spd_inverse_xf(int k, const double* a, double* out, double* okf,
                                   double* scratch, int B, int n, int np2, void* stream) {
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
