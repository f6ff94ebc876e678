// K2: the Schur-complement pairs core at K limbs, one thread per output entry.
//
// Replaces ops/pallas_xf.py:_schur_pairs_kernel_k (wrappers
// _schur_pairs_batched, _schur_pairs_batched_tiled, xf_schur_pairs_pallas):
// for every block pair q and entry (t1, t2),
//     w = ((a1*b1 + a2*b2) + (a3*b3 + a4*b4)) * HH
// in K-limb arithmetic, in the association of pallas_xf.py:613.  At K=2 the
// products and sums are the dd sequences, as in the Pallas kernel.  The
// plain PyTorch version is clrs_tpu_torch/ops/cuda_xf.py:schur_pairs_torch.
//
// What bounds it: memory at k=2, operations from k=3 on.  Each entry reads
// 9K doubles (8 K-limb operands and one K-limb weight) and writes K; at k=2
// that is ~150 double operations against 160 bytes, below the card's
// FP64 flop-per-byte balance point, while the k=3 cascades already take
// ~5x the operations for 1.5x the bytes.  The design is one fused
// elementwise pass: neighbouring threads take neighbouring t2, so every
// load and store is coalesced, and the 5 products and 3 sums never leave
// registers (the unfused torch path writes every intermediate limb to
// device memory).  The TPU version's row tiling for VMEM has no
// counterpart; the gather of the pairing slices and the rank segment-sum
// stay outside the kernel, as on the TPU (core/kernels.py).
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

// a4, b4: (K, G, P2, 4, T, T); hh: (K, G, T, T); out: (K, G, P2, T, T).
template <int K>
__global__ void schur_pairs_kernel(const double* __restrict__ a4,
                                   const double* __restrict__ b4,
                                   const double* __restrict__ hh,
                                   double* __restrict__ out, long long G, int P2, int T) {
  using namespace clrs;
  const long long TT = (long long)T * T;
  const long long total = G * P2 * TT;  // entries per limb of out
  const size_t in_lo = (size_t)G * P2 * 4 * TT;  // limb stride of a4/b4
  const size_t hh_lo = (size_t)G * TT;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long tt = e % TT;
    const long long gq = e / TT;  // g * P2 + q
    const long long g = gq / P2;
    double p[4][K], x[K], y[K];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long off = (gq * 4 + i) * TT + tt;
      load_xf<K>(a4 + off, in_lo, x);
      load_xf<K>(b4 + off, in_lo, y);
      xf_mul<K>(x, y, p[i]);
    }
    double s12[K], s34[K], s[K], w[K];
    xf_add<K>(p[0], p[1], s12);
    xf_add<K>(p[2], p[3], s34);
    xf_add<K>(s12, s34, s);
    load_xf<K>(hh + g * TT + tt, hh_lo, y);
    xf_mul<K>(s, y, w);
    store_xf<K>(out + e, (size_t)total, w);
  }
}

template <int K>
int launch(const double* a4, const double* b4, const double* hh, double* out,
           long long G, int P2, int T, cudaStream_t stream) {
  const long long total = G * P2 * (long long)T * T;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  schur_pairs_kernel<K><<<(unsigned)blocks, threads, 0, stream>>>(a4, b4, hh, out, G, P2,
                                                                  T);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns -1 for a limb count the library was not built for.
extern "C" int clrs_schur_pairs(int k, const double* a4, const double* b4,
                                const double* hh, double* out, long long G, int P2,
                                int T, void* stream) {
  switch (k) {
    case 2:
      return launch<2>(a4, b4, hh, out, G, P2, T, (cudaStream_t)stream);
#define CLRS_CASE(K)                                                          \
  case K:                                                                     \
    return launch<K>(a4, b4, hh, out, G, P2, T, (cudaStream_t)stream);
    CLRS_FOR_EACH_K(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
