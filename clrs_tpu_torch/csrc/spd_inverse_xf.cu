// K1 and K5: batched K-limb SPD inverse, one thread block per matrix; the
// K=2 instance is K1, the K >= 3 instances K5.
//
// Replaces ops/pallas_dd.py:_spd_inverse_kernel (K1, wrapper
// dd_spd_inverse_pallas) and ops/pallas_xf.py:_spd_inverse_kernel_k (K5,
// wrappers xf_spd_inverse_pallas_k, xf_spd_inverse_pallas_k_batched): per
// block, the Cholesky A = L L^T by columns with a positive-pivot flag on
// the leading limb of each pivot, W = L^-1 by forward substitution one row
// at a time, and A^-1 = W^T W by rank-1 accumulation over the rows of W in
// order, all in K-limb arithmetic.  Every dot product sums through the
// zero-padded halving tree of pallas_dd.py:128-148 and _XOps.sum_axis.  At
// K=2 the adds and multiplies are the dd sequences (eft.cuh: xf_add<2>,
// xf_mul<2>) and the div and sqrt the dd Newton steps, so the K=2 instance
// performs K1's operations in K1's order.  The plain PyTorch versions are
// clrs_tpu_torch/ops/cuda_dd.py:dd_spd_inverse_torch (K1) and
// ops/cuda_xf.py:spd_inverse_xf_torch (K5), the same operations in the
// same order (the two are bitwise equal at k=2).
//
// What bounds it: latency.  The column loop and the row loop are
// sequential chains of K-limb div and sqrt (a k=3 div alone is 17
// cascades), and the solver's blocks are small (1-64 wide) and come one
// or a few at a time, so one matrix runs on one SM.  The design shortens
// the chain: the Cholesky and the row solve are chol_xf.cuh's, where a
// group of up to 32 lanes forms each dot product with its halving tree in
// registers and shuffles (one multiply and log2(np2) adds deep), a thread
// per row or column then runs the sqrt and div, and the row solve's divs
// take the reciprocals of L's diagonal that the Cholesky stored (the
// Newton steps of a reciprocal leave the row chain).  L, W and the
// reciprocals live in global scratch, S in shared memory.  Keeping L and W
// in shared memory too (possible up to n = 68 at k=3, 34 at k=12) measured
// the same on an H100 at the solver's shapes and at 64 blocks of 32x32
// (0.0996 ms either way for S_j 11x11 at k=3; PERF.md section 6): a
// block's working set stays in L1 either way, and the wait is the div
// chain.  So there is one placement.  The input is read in place at its
// limb, batch, row and column strides and the output written at its limb
// and batch strides, so the solver's stacked (k, B, n, n) limbs go in and
// come out with no copy.  W^T W keeps the reference's sequential rank-1
// order for each entry, a thread per entry.  The Mosaic one-hot row,
// column and pivot picks (pallas_xf.py:755-770, pallas_dd.py:181-186) are
// plain indexing here.  K7 (steplen_xf.cu) shares the Cholesky and the
// row solve.
#include <cuda_runtime.h>

#include <cstring>

#include "chol_xf.cuh"

namespace {

// The description ops/cuda_dd.py:_spd_inverse_plan packs: 9 int64.
struct Desc {
  long long k, B, n;
  long long a_ls, a_bs, a_rs, a_cs;  // input strides: limb, batch, row, column
  long long o_ls, o_bs;              // output strides: limb, batch (rows dense)
};

template <int K>
__global__ void __launch_bounds__(clrs::kBlockThreads)
    spd_inverse_xf_kernel(const double* __restrict__ a, double* __restrict__ out,
                          double* __restrict__ okf, double* __restrict__ scratch,
                          const Desc d, int np2) {
  using namespace clrs;
  extern __shared__ double smem[];
  const int n = (int)d.n;
  const size_t nn = (size_t)n * n;
  const size_t b = blockIdx.x;
  const XfView A{a + b * d.a_bs, d.a_ls, d.a_rs, d.a_cs};
  double* O = out + b * d.o_bs;  // limb q of entry e at O[q * o_ls + e]
  double* S = smem;
  double* L = scratch + b * scratch_doubles<K>(n);
  double* W = L + K * nn;
  double* Rcp = W + K * nn;

  block_cholesky_xf<K>(A, L, Rcp, S, okf + b * n, n, np2);
  block_forward_rows_xf<K>(L, Rcp, XfView{nullptr, 0, 0, 0}, W, S, n, np2);  // W = L^-1

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
      if constexpr (K == 2) {  // the dd sequences are short: inline
        xf_mul<K>(x, y, c);
        xf_add<K>(acc, c, acc);
      } else {
        xf_mul_n<K>(x, y, c);
        xf_add_n<K>(acc, c, acc);
      }
    }
    store_xf<K>(O + e, d.o_ls, acc);
  }
}

template <int K>
int launch(const Desc& d, const double* a, double* out, double* okf, double* scratch,
           cudaStream_t stream) {
  if (d.B <= 0) return 0;
  const int n = (int)d.n;
  if (n < 1 || n > clrs::kMaxRows<K>) return (int)cudaErrorInvalidValue;
  const int np2 = clrs::pow2_at_least(n);
  spd_inverse_xf_kernel<K><<<(unsigned)d.B, clrs::block_threads(n, np2),
                             clrs::shared_bytes<K>(n), stream>>>(a, out, okf, scratch, d,
                                                                 np2);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: the 9 int64 of Desc; a: the input limbs at desc's strides; out:
// written at desc's output strides, rows dense; okf: (B, n) float64 flags
// (1.0 / 0.0); scratch: B * k (2 n^2 + n) float64 for L, W and the
// reciprocals.  Returns -1 for a limb count the library was not built for.
extern "C" int clrs_spd_inverse_xf(const char* desc, const double* a, double* out,
                                   double* okf, double* scratch, void* stream) {
  Desc d;
  std::memcpy(&d, desc, sizeof d);
  switch (d.k) {
#define CLRS_CASE(K)                                                      \
  case K:                                                                 \
    return launch<K>(d, a, out, okf, scratch, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
