// K8: elementwise K-limb add or multiply of two (k, N) limb arrays.
//
// Replaces ops/pallas_xf.py:_elemwise_kernel_k (wrappers
// _elemwise_batched_k and xf_elemwise_pallas, dispatched from xfloat's
// xf_add / xf_mul above a limb-count gate): r = a + b or a * b per element
// by the kernels' arithmetic (eft.cuh: the dd sequences at k=2, the
// per-order cascades at k >= 3), the operands already broadcast and
// zero-padded to k limbs by the caller.  The plain PyTorch version is
// clrs_tpu_torch/ops/cuda_xf.py:elemwise_xf_torch (ops/xops.py add and
// mul on the limb rows).
//
// What bounds it: at the solver's sizes (1 to a few hundred elements) the
// launch; on wide arrays the FP64 operations of the cascades (a k=3
// multiply is ~100 of them on 48 bytes of operands).  One thread per
// element, grid-stride; limb q of all elements is contiguous, so the
// loads and stores of each limb are coalesced, and the cascade runs in
// registers, inline: one launch where eager PyTorch issues one per
// double operation.
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

template <int K, bool MUL>
__global__ void elemwise_xf_kernel(const double* __restrict__ a, long long lda,
                                   const double* __restrict__ b, long long ldb,
                                   double* __restrict__ out, long long N) {
  using namespace clrs;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += (long long)gridDim.x * blockDim.x) {
    double x[K], y[K], r[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      x[q] = a[q * lda + e];
      y[q] = b[q * ldb + e];
    }
    if constexpr (MUL)
      xf_mul<K>(x, y, r);
    else
      xf_add<K>(x, y, r);
#pragma unroll
    for (int q = 0; q < K; ++q) out[q * N + e] = r[q];
  }
}

template <int K>
int launch(int op, const double* a, long long lda, const double* b, long long ldb,
           double* out, long long N, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  const long long want = (N + threads - 1) / threads;
  const int blocks = (int)(want < 8448 ? want : 8448);  // 64 per SM, then grid-stride
  if (op == 1)
    elemwise_xf_kernel<K, true><<<blocks, threads, 0, stream>>>(a, lda, b, ldb, out, N);
  else
    elemwise_xf_kernel<K, false><<<blocks, threads, 0, stream>>>(a, lda, b, ldb, out, N);
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 add, 1 multiply.  a, b: k limbs of N float64, limb q at a + q * lda
// (b + q * ldb); out: (k, N) contiguous.  Returns -1 for a limb count the
// library was not built for.
extern "C" int clrs_elemwise_xf(int k, int op, const double* a, long long lda,
                                const double* b, long long ldb, double* out,
                                long long N, void* stream) {
  switch (k) {
#define CLRS_CASE(K) \
  case K:            \
    return launch<K>(op, a, lda, b, ldb, out, N, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
