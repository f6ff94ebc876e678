// K9: batched double-double SPD inverse in the batch-minor layout
// (2, n, n, B), all blocks of the batch in lockstep.
//
// Replaces ops/pallas_dd.py:_spd_inverse_wide_kernel (wrappers
// dd_spd_inverse_pallas_wide, xf_spd_inverse_pallas_wide): K1's sequences
// (dd Cholesky with a positive-pivot flag per column, W = L^-1 by rows,
// A^-1 = W^T W by rank-1 accumulation, matvec sums through the
// zero-padded halving tree) with the batch on the fastest axis.  The
// sequences are K1's (the K=2 instance of spd_inverse_xf.cu), so the two
// agree bit for bit;
// the plain PyTorch version is clrs_tpu_torch/ops/cuda_dd.py:
// dd_spd_inverse_wide_torch, K1's plain version.  Where the Pallas wrapper
// pads the batch with identity blocks to whole chunks, the last thread
// block here runs short (active = b < B).
//
// What bounds it: latency, as for K1.  The layout puts consecutive
// matrices on consecutive threads: a thread block holds up to 32 matrices
// (threadIdx.x) by the n rows of a column step (threadIdx.y), at most 512
// threads (it takes ~96 registers a thread), so every load and store of a
// warp is coalesced over matrices, and the Pallas kernel's lane-axis
// lockstep becomes the warp's.  Where K1 gives one
// small matrix a whole thread block, this packs up to 32 of them into it.
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

constexpr int kMaxGroup = 32;
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
    spd_inverse_dd_wide_kernel(const double* __restrict__ a, double* __restrict__ out,
                               double* __restrict__ okf, double* __restrict__ scratch,
                               int n, int np2, int B) {
  using namespace clrs;
  // entry (r, c) of matrix b at [(r * n + c) * B + b]; limb 1 nn * B further
  const size_t nn = (size_t)n * n;
  const size_t NB = nn * B;
  const int g = threadIdx.x;  // matrix within the group
  const int row = threadIdx.y;
  const int b = blockIdx.x * blockDim.x + g;
  const bool active = b < B;
  const double* Ah = a;
  const double* Al = a + NB;
  double* Oh = out;
  double* Ol = out + NB;
  double* Lh = scratch;
  double* Ll = Lh + NB;
  double* Wh = Ll + NB;
  double* Wl = Wh + NB;
  double* Ph = Wl + NB;  // product vectors: entry t of (row, b) at [(t * n + row) * B + b]
  double* Pl = Ph + (size_t)np2 * n * B;
  const size_t pstride = (size_t)n * B;
  auto at = [&](int r, int c) { return ((size_t)r * n + c) * B + b; };
  __shared__ double piv[2][kMaxGroup];

  if (active) {
    for (int c = 0; c < n; ++c) {
      Lh[at(row, c)] = 0.0;
      Ll[at(row, c)] = 0.0;
      Wh[at(row, c)] = 0.0;
      Wl[at(row, c)] = 0.0;
    }
    okf[(size_t)row * B + b] = 1.0;
  }
  __syncthreads();

  // Cholesky, column j: thread (i, b) forms s_i = A[i, j] - sum_t L[i, t] L[j, t].
  for (int j = 0; j < n; ++j) {
    double sh = 0.0, sl = 0.0;
    if (active) {
      const int i = row;
      double* ph = Ph + (size_t)i * B + b;
      double* pl = Pl + (size_t)i * B + b;
      for (int t = 0; t < n; ++t)
        dd_mul(Lh[at(i, t)], Ll[at(i, t)], Lh[at(j, t)], Ll[at(j, t)], ph[t * pstride],
               pl[t * pstride]);
      for (int t = n; t < np2; ++t) {
        ph[t * pstride] = 0.0;
        pl[t * pstride] = 0.0;
      }
      double acch, accl;
      dd_halving_sum(ph, pl, np2, (int)pstride, acch, accl);
      dd_add(Ah[at(i, j)], Al[at(i, j)], -acch, -accl, sh, sl);
      if (i == j) {
        piv[0][g] = sh;
        piv[1][g] = sl;
      }
    }
    __syncthreads();
    if (active) {
      const int i = row;
      const double djh = piv[0][g], djl = piv[1][g];
      const bool pos = djh > 0.0;
      if (i == 0) okf[(size_t)j * B + b] = pos ? 1.0 : 0.0;
      double ljh, ljl, ch, cl;
      dd_sqrt(pos ? djh : 1.0, pos ? djl : 0.0, ljh, ljl);
      dd_div(sh, sl, ljh, ljl, ch, cl);
      if (i == j) {
        ch = ljh;
        cl = ljl;
      } else if (i < j) {
        ch = 0.0;
        cl = 0.0;
      }
      Lh[at(i, j)] = ch;
      Ll[at(i, j)] = cl;
    }
    __syncthreads();
  }

  // W = L^-1, row i: thread (c, b) solves column c of matrix b.
  if (active) {
    const int c = row;
    double* ph = Ph + (size_t)c * B + b;
    double* pl = Pl + (size_t)c * B + b;
    for (int i = 0; i < n; ++i) {
      for (int t = 0; t < n; ++t)
        dd_mul(Lh[at(i, t)], Ll[at(i, t)], Wh[at(t, c)], Wl[at(t, c)], ph[t * pstride],
               pl[t * pstride]);
      for (int t = n; t < np2; ++t) {
        ph[t * pstride] = 0.0;
        pl[t * pstride] = 0.0;
      }
      double acch, accl, nh, nl, qh, ql;
      dd_halving_sum(ph, pl, np2, (int)pstride, acch, accl);
      dd_add(c == i ? 1.0 : 0.0, 0.0, -acch, -accl, nh, nl);
      dd_div(nh, nl, Lh[at(i, i)], Ll[at(i, i)], qh, ql);
      Wh[at(i, c)] = qh;
      Wl[at(i, c)] = ql;
    }
  }
  __syncthreads();

  // A^-1 = W^T W by sequential rank-1 accumulation over the rows t of W.
  if (active) {
    for (size_t e = row; e < nn; e += blockDim.y) {
      const int r = (int)(e / n), c = (int)(e % n);
      double acch = 0.0, accl = 0.0, ph, pl;
      for (int t = 0; t < n; ++t) {
        dd_mul(Wh[at(t, r)], Wl[at(t, r)], Wh[at(t, c)], Wl[at(t, c)], ph, pl);
        dd_add(acch, accl, ph, pl, acch, accl);
      }
      Oh[e * B + b] = acch;
      Ol[e * B + b] = accl;
    }
  }
}

}  // namespace

// a, out: (2, n, n, B) float64; okf: (n, B) float64 flags (1.0 / 0.0);
// scratch: B * (4 n^2 + 2 n np2) float64, np2 the power of two >= n.
extern "C" int clrs_spd_inverse_dd_wide(const double* a, double* out, double* okf,
                                        double* scratch, int B, int n, int np2,
                                        void* stream) {
  if (B <= 0) return 0;
  int group = kMaxThreads / n;
  if (group > kMaxGroup) group = kMaxGroup;
  if (group < 1) return (int)cudaErrorInvalidValue;
  const dim3 threads(group, n);
  const int blocks = (B + group - 1) / group;
  spd_inverse_dd_wide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, out, okf, scratch, n, np2, B);
  return (int)cudaGetLastError();
}
