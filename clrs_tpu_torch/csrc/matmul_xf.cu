// K4 (+K6): batched k-limb matmul by sequential rank-1 accumulation.
//
// Replaces ops/pallas_xf.py:_matmul_kernel_k (wrapper _matmul_batched_k)
// and its output-tiled variant _matmul_kernel_k_tiled (wrappers
// _matmul_batched_k_tiled, xf_matmul_pallas_tiled): C[b] = A[b] @ B[b] for
// (B, n, K) x (B, K, m) in K-limb arithmetic, acc = add(acc, mul(a[i, r],
// b[r, j])) over r in order.  Both Pallas kernels give every output entry
// that same sequence, whatever their output tiles, so one kernel covers
// both.  The Pallas wrappers zero-pad the contraction to a multiple of 8
// (pallas_xf.py:351-356, 514-518, 1115): the kernel repeats those steps
// with zero operands, since a cascade add of a zero product need not leave
// the accumulator's limbs bitwise unchanged.  The plain PyTorch version is
// clrs_tpu_torch/ops/cuda_xf.py:matmul_xf_torch.
//
// What bounds it: FP64 issue rate and the dependent chain.  A K-limb
// multiply-add is a few hundred (k=3) to a few thousand (k=10) dependent
// double operations, with no use for tensor cores (the cascades need exact
// products and error terms).  The design gives every output entry its own
// thread with the K-limb accumulator in registers; neighbouring threads
// take neighbouring columns, so the B-row loads coalesce and the A-row
// loads broadcast.  Any n, K and m are taken.
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

// a: (K, B, n, Kc); b: (K, B, Kc, m); c: (K, B, n, m); Kp >= Kc steps.
template <int K>
__global__ void matmul_xf_kernel(const double* __restrict__ a,
                                 const double* __restrict__ b,
                                 double* __restrict__ c, long long Bt, int n, int Kc,
                                 int Kp, int m) {
  using namespace clrs;
  const long long total = Bt * n * m;
  const size_t a_lo = (size_t)Bt * n * Kc, b_lo = (size_t)Bt * Kc * m;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % m);
    const long long bi = e / m;  // batch * n + i
    const long long bb = bi / n;
    const double* ar = a + bi * Kc;
    const double* bc = b + bb * Kc * m + j;
    double acc[K], x[K], y[K], p[K];
#pragma unroll
    for (int q = 0; q < K; ++q) acc[q] = 0.0;
    for (int r = 0; r < Kp; ++r) {
      if (r < Kc) {
        load_xf<K>(ar + r, a_lo, x);
        load_xf<K>(bc + (size_t)r * m, b_lo, y);
      } else {
#pragma unroll
        for (int q = 0; q < K; ++q) x[q] = y[q] = 0.0;
      }
      xf_mul<K>(x, y, p);
      xf_add<K>(acc, p, acc);
    }
    store_xf<K>(c + e, (size_t)total, acc);
  }
}

template <int K>
int launch(const double* a, const double* b, double* c, long long Bt, int n, int Kc,
           int Kp, int m, cudaStream_t stream) {
  const long long total = Bt * n * (long long)m;
  if (total <= 0) return 0;
  const int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  matmul_xf_kernel<K><<<(unsigned)blocks, threads, 0, stream>>>(a, b, c, Bt, n, Kc, Kp,
                                                                m);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns -1 for a limb count the library was not built for.
extern "C" int clrs_matmul_xf(int k, const double* a, const double* b, double* c,
                              long long Bt, int n, int Kc, int Kp, int m,
                              void* stream) {
  switch (k) {
#define CLRS_CASE(K)                                                          \
  case K:                                                                     \
    return launch<K>(a, b, c, Bt, n, Kc, Kp, m, (cudaStream_t)stream);
    CLRS_FOR_EACH_K(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
