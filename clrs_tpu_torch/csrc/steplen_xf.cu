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
// The column solve is built the same way: for column j, a group of lanes
// per row i of X forms the dot product X[i, :] . L[j, :] with its halving
// tree in registers and shuffles, and a thread per row then runs the div;
// a row of X depends only on the same row of W1 and on L.  As in the
// Pallas kernel, the contraction runs over all n terms with L[j, t]
// multiplied by the mask t < j: the masked terms enter the halving tree as
// the signed-zero products the reference forms (a cascade add of zero is
// not a bitwise identity), and X overwrites W1 in place, column by column.
// L and X live in global scratch and S in shared memory, as for K5.
#include <cuda_runtime.h>

#include "chol_xf.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(clrs::kBlockThreads)
    steplen_xf_kernel(const double* __restrict__ m, const double* __restrict__ dm,
                      double* __restrict__ w, double* __restrict__ okf,
                      double* __restrict__ scratch, int n, int np2) {
  using namespace clrs;
  extern __shared__ double smem[];
  const size_t nn = (size_t)n * n;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int G = group_width(np2);
  const int group = tid / G, groups = blockDim.x / G;
  double* S = smem;
  double* L = scratch + b * 2 * K * nn;
  double* X = L + K * nn;  // W1, then X column by column

  block_cholesky_xf<K>(m + b * K * nn, L, S, okf + b * n, n, np2);
  block_forward_rows_xf<K>(L, dm + b * K * nn, X, S, n, np2);

  double x[K], s[K], c[K], y[K];
  for (int j = 0; j < n; ++j) {
    for (int i0 = 0; i0 < n; i0 += groups) {
      const int i = i0 + group;
      const bool active = i < n;
      group_dot<K>(
          n, np2, active,
          [&](int t, double(&v)[K]) { load_xf<K>(X + (size_t)i * n + t, nn, v); },
          [&](int t, double(&v)[K]) {
            const double mask = t < j ? 1.0 : 0.0;
            load_xf<K>(L + (size_t)j * n + t, nn, v);
#pragma unroll
            for (int q = 0; q < K; ++q) v[q] = v[q] * mask;
          },
          c);
      if (active && tid % G == 0) {
#pragma unroll
        for (int q = 0; q < K; ++q) c[q] = -c[q];
        load_xf<K>(X + (size_t)i * n + j, nn, x);
        xf_add_c<K>(x, c, s);
        store_xf<K>(S + i, n, s);
      }
    }
    __syncthreads();
    if (tid < n) {
      load_xf<K>(S + tid, n, s);
      load_xf<K>(L + (size_t)j * n + j, nn, y);
      xf_div<K>(s, y, c);
      store_xf<K>(X + (size_t)tid * n + j, nn, c);
    }
    __syncthreads();
  }
  for (size_t e = tid; e < nn; e += blockDim.x) w[b * nn + e] = X[e] + X[nn + e];
}

template <int K>
int launch(const double* m, const double* dm, double* w, double* okf, double* scratch,
           int B, int n, int np2, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n > clrs::kMaxRows) return (int)cudaErrorInvalidValue;
  steplen_xf_kernel<K><<<B, clrs::block_threads(n, np2), clrs::shared_bytes<K>(n), stream>>>(
      m, dm, w, okf, scratch, n, np2);
  return (int)cudaGetLastError();
}

}  // namespace

// m, dm: (B, k, n, n) float64; w: (B, n, n) float64; okf: (B, n) float64
// flags (1.0 / 0.0); np2 the power of two >= n; scratch: B * 2 k n^2
// float64 for L and X.  Returns -1 for a limb count the library was not
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
