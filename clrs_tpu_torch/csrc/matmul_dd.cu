// K3: batched double-double matmul by sequential rank-1 accumulation.
//
// Replaces ops/pallas_xf.py:_matmul_kernel (wrappers _matmul_batched and
// the dispatch xf_matmul_pallas): C[b] = A[b] @ B[b] for (B, n, K) x
// (B, K, m), every product a dd product and every accumulation a dd add,
// over the contraction index r = 0..K-1 in order (pallas_xf.py:378-387).
// The plain PyTorch version is clrs_tpu_torch/ops/cuda_xf.py:
// dd_matmul_seq_torch.  Any n, K and m are taken, so the k=2 case of the
// TPU's tiled kernel (_matmul_kernel_k_tiled) needs no separate kernel.
//
// What bounds it: FP64 issue rate and the dependent chain.  Each output
// entry is a serial chain of K dd multiply-adds (~45 dependent double
// operations each) that cannot use tensor cores (dd needs exact products
// and error terms); at the solver's sizes (K <= ~64) there are few
// entries, so latency dominates.  The design gives every output entry its
// own thread, with neighbouring threads on neighbouring columns so the
// B-row loads coalesce and the A-row loads broadcast, and the accumulator
// in registers.  The TPU's zero padding of K to the chunk width is not
// needed.
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

// a: (2, B, n, K); b: (2, B, K, m); c: (2, B, n, m).
__global__ void matmul_dd_kernel(const double* __restrict__ a,
                                 const double* __restrict__ b,
                                 double* __restrict__ c, long long Bt, int n, int K,
                                 int m) {
  using namespace clrs;
  const long long total = Bt * n * m;
  const long long a_lo = Bt * n * K, b_lo = Bt * K * m;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % m);
    const long long bi = e / m;  // batch * n + i
    const long long bb = bi / n;
    const double* ar = a + bi * K;
    const double* bc = b + bb * K * m + j;
    double ch = 0.0, cl = 0.0;
    for (int r = 0; r < K; ++r) {
      const double ah = ar[r], al = ar[a_lo + r];
      const double bh = bc[(long long)r * m], bl = bc[b_lo + (long long)r * m];
      double ph, pe;
      two_prod(ah, bh, ph, pe);
      double plo = pe + (ah * bl + al * bh);
      fast_two_sum(ph, plo, ph, plo);
      dd_add(ch, cl, ph, plo, ch, cl);
    }
    c[e] = ch;
    c[total + e] = cl;
  }
}

}  // namespace

extern "C" int clrs_matmul_dd(const double* a, const double* b, double* c, long long Bt,
                              int n, int K, int m, void* stream) {
  const long long total = Bt * n * (long long)m;
  if (total <= 0) return 0;
  const int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  matmul_dd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a, b, c, Bt,
                                                                          n, K, m);
  return (int)cudaGetLastError();
}
