// K2: the Schur-complement pairs core at k=2, one thread per output entry.
//
// Replaces ops/pallas_xf.py:_schur_pairs_kernel_k at k=2 (wrappers
// _schur_pairs_batched, _schur_pairs_batched_tiled, xf_schur_pairs_pallas):
// for every block pair q and entry (t1, t2),
//     w = ((a1*b1 + a2*b2) + (a3*b3 + a4*b4)) * HH
// in double-double.  The plain PyTorch version is
// clrs_tpu_torch/ops/cuda_xf.py:schur_pairs_torch.
//
// What bounds it: memory.  Each entry reads 18 doubles (8 dd operands and
// one dd weight) and writes 2, against ~150 double operations, below the
// card's flop-per-byte balance point for FP64.  The design is one fused
// elementwise pass: neighbouring threads take neighbouring t2, so every
// load and store is coalesced, and the 5 dd products and 3 dd adds never
// leave registers (the unfused torch path writes every intermediate limb
// to device memory).  The TPU version's row tiling for VMEM has no
// counterpart; the gather of the pairing slices and the rank segment-sum
// stay outside the kernel, as on the TPU (core/kernels.py).
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

// a4, b4: (2, G, P2, 4, T, T); hh: (2, G, T, T); out: (2, G, P2, T, T).
__global__ void schur_pairs_dd_kernel(const double* __restrict__ a4,
                                      const double* __restrict__ b4,
                                      const double* __restrict__ hh,
                                      double* __restrict__ out, long long G, int P2,
                                      int T) {
  using namespace clrs;
  const long long TT = (long long)T * T;
  const long long total = G * P2 * TT;  // entries per limb of out
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long tt = e % TT;
    const long long gq = e / TT;  // g * P2 + q
    const long long g = gq / P2;
    const long long in_lo = G * P2 * 4 * TT;  // limb stride of a4/b4
    double ph[4], pl[4];
    for (int i = 0; i < 4; ++i) {
      const long long off = (gq * 4 + i) * TT + tt;
      dd_mul(a4[off], a4[in_lo + off], b4[off], b4[in_lo + off], ph[i], pl[i]);
    }
    double s12h, s12l, s34h, s34l, sh, sl, wh, wl;
    dd_add(ph[0], pl[0], ph[1], pl[1], s12h, s12l);
    dd_add(ph[2], pl[2], ph[3], pl[3], s34h, s34l);
    dd_add(s12h, s12l, s34h, s34l, sh, sl);
    const long long hoff = g * TT + tt;
    dd_mul(sh, sl, hh[hoff], hh[G * TT + hoff], wh, wl);
    out[e] = wh;
    out[total + e] = wl;
  }
}

}  // namespace

extern "C" int clrs_schur_pairs_dd(const double* a4, const double* b4, const double* hh,
                                   double* out, long long G, int P2, int T,
                                   void* stream) {
  const long long total = G * P2 * (long long)T * T;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  schur_pairs_dd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a4, b4, hh, out, G, P2, T);
  return (int)cudaGetLastError();
}
