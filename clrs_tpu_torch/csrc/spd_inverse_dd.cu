// K1: batched double-double SPD inverse, one thread block per matrix.
//
// Replaces ops/pallas_dd.py:_spd_inverse_kernel (wrapper
// dd_spd_inverse_pallas): per block, the dd Cholesky A = L L^T, W = L^-1 by
// forward substitution, and A^-1 = W^T W, with a positive-pivot flag per
// column.  The plain PyTorch version is clrs_tpu_torch/ops/cuda_dd.py:
// dd_spd_inverse_torch; it performs the same operations in the same order.
//
// What bounds it: latency, not bytes or flops.  The column loop of the
// Cholesky and the row loop of the solve are sequential chains of dd
// div/sqrt (hundreds of dependent double operations each), and the
// solver's blocks are small (1-64 wide), so one block holds at most a few
// warps.  The design keeps each matrix inside one thread block (no
// launch per column, no host round trip) and spreads the independent work
// of each step over threads: one thread per row for a Cholesky column,
// one per column for a solve row, one per output entry for W^T W.  The
// matvec sums use the Pallas kernel's zero-padded halving tree
// (pallas_dd.py:128-148), each thread reducing its own product vector in
// place in global scratch (cached in L1), which takes any n up to 1024
// without a shared-memory budget.  The Mosaic one-hot row and column picks
// (pallas_dd.py:181-186) are plain indexing here.
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

__global__ void spd_inverse_dd_kernel(const double* __restrict__ a,
                                      double* __restrict__ out,
                                      double* __restrict__ okf,
                                      double* __restrict__ scratch, int n,
                                      int np2) {
  using namespace clrs;
  const size_t nn = (size_t)n * n;
  const size_t b = blockIdx.x;
  const double* Ah = a + b * 2 * nn;
  const double* Al = Ah + nn;
  double* Oh = out + b * 2 * nn;
  double* Ol = Oh + nn;
  double* Lh = scratch + b * (4 * nn + 2 * (size_t)n * np2);
  double* Ll = Lh + nn;
  double* Wh = Ll + nn;
  double* Wl = Wh + nn;
  double* Ph = Wl + nn;  // per-thread product vectors, np2 each
  double* Pl = Ph + (size_t)n * np2;
  double* ok = okf + b * n;

  const int tid = threadIdx.x;
  const bool active = tid < n;
  __shared__ double piv[2];

  for (size_t e = tid; e < nn; e += blockDim.x) {
    Lh[e] = 0.0;
    Ll[e] = 0.0;
    Wh[e] = 0.0;
    Wl[e] = 0.0;
  }
  if (active) ok[tid] = 1.0;
  __syncthreads();

  // Cholesky, column j: thread i forms s_i = A[i, j] - sum_t L[i, t] L[j, t].
  for (int j = 0; j < n; ++j) {
    double sh = 0.0, sl = 0.0;
    if (active) {
      const int i = tid;
      double* ph = Ph + (size_t)i * np2;
      double* pl = Pl + (size_t)i * np2;
      for (int t = 0; t < n; ++t)
        dd_mul(Lh[i * n + t], Ll[i * n + t], Lh[j * n + t], Ll[j * n + t], ph[t], pl[t]);
      for (int t = n; t < np2; ++t) {
        ph[t] = 0.0;
        pl[t] = 0.0;
      }
      double acch, accl;
      dd_halving_sum(ph, pl, np2, 1, acch, accl);
      dd_add(Ah[i * n + j], Al[i * n + j], -acch, -accl, sh, sl);
      if (i == j) {
        piv[0] = sh;
        piv[1] = sl;
      }
    }
    __syncthreads();
    const double djh = piv[0], djl = piv[1];
    const bool pos = djh > 0.0;
    if (tid == 0) ok[j] = pos ? 1.0 : 0.0;
    double ljh, ljl;
    dd_sqrt(pos ? djh : 1.0, pos ? djl : 0.0, ljh, ljl);
    if (active) {
      const int i = tid;
      double ch, cl;
      dd_div(sh, sl, ljh, ljl, ch, cl);
      if (i == j) {
        ch = ljh;
        cl = ljl;
      } else if (i < j) {
        ch = 0.0;
        cl = 0.0;
      }
      Lh[i * n + j] = ch;
      Ll[i * n + j] = cl;
    }
    __syncthreads();
  }

  // W = L^-1, row i: thread c solves column c (it reads and writes only
  // its own column of W, so the rows need no barrier between them).
  if (active) {
    const int c = tid;
    double* ph = Ph + (size_t)c * np2;
    double* pl = Pl + (size_t)c * np2;
    for (int i = 0; i < n; ++i) {
      for (int t = 0; t < n; ++t)
        dd_mul(Lh[i * n + t], Ll[i * n + t], Wh[t * n + c], Wl[t * n + c], ph[t], pl[t]);
      for (int t = n; t < np2; ++t) {
        ph[t] = 0.0;
        pl[t] = 0.0;
      }
      double acch, accl, nh, nl, qh, ql;
      dd_halving_sum(ph, pl, np2, 1, acch, accl);
      dd_add(c == i ? 1.0 : 0.0, 0.0, -acch, -accl, nh, nl);
      dd_div(nh, nl, Lh[i * n + i], Ll[i * n + i], qh, ql);
      Wh[i * n + c] = qh;
      Wl[i * n + c] = ql;
    }
  }
  __syncthreads();

  // A^-1 = W^T W by sequential rank-1 accumulation over the rows t of W.
  for (size_t e = tid; e < nn; e += blockDim.x) {
    const int r = (int)(e / n), c = (int)(e % n);
    double acch = 0.0, accl = 0.0, ph, pl;
    for (int t = 0; t < n; ++t) {
      dd_mul(Wh[t * n + r], Wl[t * n + r], Wh[t * n + c], Wl[t * n + c], ph, pl);
      dd_add(acch, accl, ph, pl, acch, accl);
    }
    Oh[e] = acch;
    Ol[e] = accl;
  }
}

}  // namespace

// a, out: (B, 2, n, n) float64; okf: (B, n) float64 flags (1.0 / 0.0);
// scratch: B * (4 n^2 + 2 n np2) float64, np2 the power of two >= n.
extern "C" int clrs_spd_inverse_dd(const double* a, double* out, double* okf,
                                   double* scratch, int B, int n, int np2,
                                   void* stream) {
  if (B <= 0) return 0;
  const int threads = ((n + 31) / 32) * 32;
  spd_inverse_dd_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(a, out, okf, scratch,
                                                                  n, np2);
  return (int)cudaGetLastError();
}
