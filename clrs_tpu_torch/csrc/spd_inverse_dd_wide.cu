// K9: batched double-double SPD inverse for many small matrices at once,
// a team of warps per matrix and several matrices per thread block.
//
// Replaces ops/pallas_dd.py:_spd_inverse_wide_kernel (wrappers
// dd_spd_inverse_pallas_wide, xf_spd_inverse_pallas_wide), which lays the
// batch along the TPU's lanes because a kernel per matrix "wastes ~all
// lanes for the reference's small blocks".  It computes K1's function
// with K1's operations in K1's order (spd_inverse_xf.cu at K=2 on
// chol_xf.cuh, eft.cuh's dd sequences): the Cholesky A = L L^T by columns
// with a positive-pivot flag per column, W = L^-1 by forward
// substitution one row at a time, the row solve dividing by the
// reciprocals of L's diagonal that the Cholesky stored (eft.cuh:
// xf_div_recip), and A^-1 = W^T W by sequential rank-1
// accumulation over the rows of W in order; every dot product is the
// zero-padded halving tree of width np2 (the power of two >= n) with the
// same pairs.  So the two agree bit for bit on every input; the plain
// PyTorch version is clrs_tpu_torch/ops/cuda_dd.py:
// dd_spd_inverse_wide_torch, K1's plain version.
//
// What bounds it: FP64 instructions on wide batches (a 64x64 inverse is
// ~29 million of them with Dekker's products, and 256 such inverses are
// two an SM), the latency of the sqrt/div chains on small ones.  The design:
// - a team of 32-256 threads (ops/cuda_dd.py:_wide_plan) per matrix and
//   several teams per block while they fit, each team synchronized by its
//   own named barrier (a warp by __syncwarp), so no block barrier ties the
//   matrices of a block together; a wide 256x64x64 batch is 256 blocks,
//   two on each SM;
// - the dot products' halving tree in registers and shuffles, with groups
//   narrow enough that few lanes idle: G = max(1, np2 / 16) lanes per dot,
//   each holding its 16 terms t = l + G m (np2 / G for np2 < 16), the
//   levels with half >= G inside the lane and the G lanes' levels by
//   __shfl_down_sync (chol_xf.cuh: group_dot with narrower groups, the
//   same additions); 64x64 takes 4 lanes per dot where K1 takes 32, and
//   the shuffle levels that keep most lanes busy for one result are 2
//   instead of 5;
// - L packed (its lower triangle, row i at i (i + 1) / 2) and W
//   transposed (column c at c ldw, ldw = 1 mod 8 so that the columns of a
//   warp fall on distinct banks) in shared memory where the matrix fits
//   (n <= 96), in global scratch above; the input's lower triangle is
//   copied into L's place once, read from there by the column that
//   replaces it, and every entry of L or W that K1 holds as a stored zero
//   (columns not factored yet, the upper triangle, rows of W not solved
//   yet) is a zero in registers, not a load;
// - work whose result is known exactly, not done: a dot product's term
//   that multiplies two such stored zeros is (+0, +0), and so is every add
//   of two such terms, so the terms past the last column (row) with a
//   nonzero entry and their adds are skipped (in a 64x64 inverse about
//   half of the Cholesky's and the solve's multiplies); and once every
//   limb of W is finite and below 2^996 (checked), W's upper triangle is
//   zeros whose products with any entry of W are (+0, +0), which leave
//   W^T W's accumulator at its starting (+0, +0) (round-to-nearest: +0 +
//   -0 = +0), so entry (r, c) starts at t = max(r, c), two thirds of the
//   steps gone; where the check fails every step runs, as in K1;
// - each pivot's square root and reciprocal taken once per thread, and
//   each row below it divided by the five operations that follow the
//   reciprocal, as the row solve does (K1 runs a whole div per row there:
//   the same bits);
// - W^T W by threads on neighbouring output columns, each accumulating a
//   strip of four rows, so that four independent chains share each load.
// The input is read once, in place at its batch, limb, row and column
// strides (the batch-minor view of the Pallas layout included); the
// output is (B, 2, n, n) dense, the flags one per matrix.
#include <cuda_runtime.h>

#include <cstring>

#include "eft.cuh"

namespace {

constexpr int kLaneTerms = 16;  // terms of a dot product a lane holds at most
constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 512;
constexpr size_t kMaxShared = 232448;  // an H100 block's dynamic shared memory

// The description ops/cuda_dd.py:_wide_plan packs: 11 int64.
struct Desc {
  long long B, n;
  long long bs, ls, rs, cs;  // input strides: batch, limb, row, column
  long long team, teams;     // threads per matrix, matrices per block
  long long in_shared, ldw;  // L and W in shared memory (1) or scratch (0); W's column stride
  long long group;           // lanes per dot product
};

__host__ __device__ inline size_t packed(int n) { return (size_t)n * (n + 1) / 2; }

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// double2 slots of a team's shared memory: L, W, then S, the reciprocals
// and the flag; S, the reciprocals and the flag alone where L and W live
// in scratch.
__host__ __device__ inline size_t team_slots(const Desc& d) {
  const int n = (int)d.n;
  return (d.in_shared ? packed(n) + (size_t)n * d.ldw : 0) + 2 * (size_t)n + 1;
}

__device__ __forceinline__ void team_sync(int team, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(threads) : "memory");
}

__device__ __forceinline__ void ld2(const double2* p, double (&x)[2]) {
  const double2 v = *p;
  x[0] = v.x;
  x[1] = v.y;
}

__device__ __forceinline__ void st2(double2* p, const double (&x)[2]) {
  *p = make_double2(x[0], x[1]);
}

__device__ __forceinline__ void zero2(double (&x)[2]) { x[0] = x[1] = 0.0; }

// sum_{t < np2} x(t) y(t) by the zero-padded halving tree of width np2
// = G M, formed by the G lanes of this lane's group (l its lane there):
// the lane's terms t = l + G m, m < M, their levels inside the lane (the
// first as the terms are formed), then the group's levels by shuffles; the
// sum is valid in the group's lane 0.  Every term t >= live is a product
// of two zeros that K1 holds in memory, (+0, +0) exactly, and so is every
// sum of such terms: a node of the tree whose leaves all lie at or past
// live (its first leaf does) is (+0, +0) without its multiply or add.  An
// inactive group passes live = 0.  All 32 lanes of a warp call this
// together.
template <class X, class Y>
__device__ __forceinline__ void lane_dot(int G, int M, int l, int live, X x_of, Y y_of,
                                         double (&r)[2]) {
  using namespace clrs;
  auto term = [&](int t, double(&p)[2]) {
    if (t < live) {
      double x[2], y[2];
      x_of(t, x);
      y_of(t, y);
      xf_mul<2>(x, y, p);
    } else {
      zero2(p);
    }
  };
  if (M == 1) {
    term(l, r);
  } else {
    double p[kLaneTerms / 2][2];
#pragma unroll
    for (int m = 0; m < kLaneTerms / 2; ++m) {
      if (m < M / 2) {
        if (l + G * m < live) {
          double u[2], v[2];
          term(l + G * m, u);
          term(l + G * (m + M / 2), v);
          xf_add<2>(u, v, p[m]);
        } else {
          zero2(p[m]);
        }
      }
    }
#pragma unroll
    for (int h = kLaneTerms / 4; h >= 1; h /= 2) {
      if (2 * h <= M / 2) {
#pragma unroll
        for (int m = 0; m < h; ++m)
          if (l + G * m < live) xf_add<2>(p[m], p[m + h], p[m]);
      }
    }
    r[0] = p[0][0];
    r[1] = p[0][1];
  }
  for (int half = G / 2; half >= 1; half /= 2) {
    double y[2];
    y[0] = __shfl_down_sync(0xffffffffu, r[0], half, G);
    y[1] = __shfl_down_sync(0xffffffffu, r[1], half, G);
    if (l < live) xf_add<2>(r, y, r);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2)
    spd_inverse_dd_wide_kernel(const double* __restrict__ a, double* __restrict__ out,
                               double* __restrict__ okf, double2* __restrict__ scratch,
                               const Desc d) {
  using namespace clrs;
  extern __shared__ double2 smem2[];
  const int n = (int)d.n, NT = (int)d.team, ldw = (int)d.ldw;
  const int team = threadIdx.x / NT, tt = threadIdx.x % NT;
  const long long b = (long long)blockIdx.x * d.teams + team;
  if (b >= d.B) return;
  const int G = (int)d.group, M = pow2_at_least(n) / G;
  const int l = tt % G, grp = tt / G, groups = NT / G;
  double2* L = d.in_shared ? smem2 + team * team_slots(d)
                           : scratch + b * (packed(n) + (size_t)n * ldw);
  double2* Wt = L + packed(n);  // W[t][c] at Wt[c ldw + t]
  double2* S = d.in_shared ? Wt + (size_t)n * ldw : smem2 + team * team_slots(d);
  double2* Rcp = S + n;
  double* flag = reinterpret_cast<double*>(Rcp + n);
  auto row = [&](int i) { return L + packed(i); };  // L[i][t] at row(i)[t], t <= i

  // the input's lower triangle into L's place
  const double* A = a + b * d.bs;
  for (int e = tt; e < n * n; e += NT) {
    const int i = e / n, j = e % n;
    if (j <= i) {
      const double* p = A + i * d.rs + j * d.cs;
      row(i)[j] = make_double2(p[0], p[d.ls]);
    }
  }
  if (tt == 0) *flag = 1.0;
  team_sync(team, NT);

  double c[2], x[2], s[2];
  // Cholesky, column j: a group per row i >= j forms s_i = A[i, j] - sum_t
  // L[i, t] L[j, t] (columns t >= j still zero), then the rows are divided
  // by the pivot's square root.
  for (int j = 0; j < n; ++j) {
    const double2* Lj = row(j);
    for (int i0 = j; i0 < n; i0 += groups) {
      const int i = i0 + grp;
      const bool active = i < n;
      const double2* Li = row(active ? i : j);
      lane_dot(
          G, M, l, active ? j : 0, [&](int t, double(&v)[2]) { ld2(Li + t, v); },
          [&](int t, double(&v)[2]) { ld2(Lj + t, v); }, c);
      if (active && l == 0) {
        ld2(Li + j, x);  // A[i, j]: its column is not factored yet
        c[0] = -c[0];
        c[1] = -c[1];
        xf_add<2>(x, c, s);
        st2(S + i, s);
      }
    }
    team_sync(team, NT);
    double dj[2];
    ld2(S + j, dj);
    const bool pos = dj[0] > 0.0;
    if (tt == 0 && !pos) *flag = 0.0;
    int r = j + tt;
    if (r < n) {
      double piv[2] = {pos ? dj[0] : 1.0, pos ? dj[1] : 0.0}, ljj[2], rc[2];
      xf_sqrt<2>(piv, ljj);
      xf_recip<2>(ljj, rc);
      for (; r < n; r += NT) {
        if (r == j) {
          st2(row(j) + j, ljj);
          st2(Rcp + j, rc);
        } else {
          ld2(S + r, s);
          xf_div_recip<2>(s, ljj, rc, x);
          st2(row(r) + j, x);
        }
      }
    }
    team_sync(team, NT);
  }

  // W = L^-1, row i: a group per column forms s = I[i, col] - sum_t L[i, t]
  // W[t, col] (L's upper triangle and W's rows t >= i zero), then W[i, col]
  // = s / L[i, i] with the stored reciprocal.
  for (int i = 0; i < n; ++i) {
    const double2* Li = row(i);
    for (int c0 = 0; c0 < n; c0 += groups) {
      const int col = c0 + grp;
      const bool active = col < n;
      const double2* Wc = Wt + (size_t)(active ? col : 0) * ldw;
      lane_dot(
          G, M, l, active ? i + 1 : 0, [&](int t, double(&v)[2]) { ld2(Li + t, v); },
          [&](int t, double(&v)[2]) {
            if (t < i) ld2(Wc + t, v); else zero2(v);
          },
          c);
      if (active && l == 0) {
        x[0] = col == i ? 1.0 : 0.0;
        x[1] = 0.0;
        c[0] = -c[0];
        c[1] = -c[1];
        xf_add<2>(x, c, s);
        st2(S + col, s);
      }
    }
    team_sync(team, NT);
    if (tt < n) {
      double y[2], rc[2];
      ld2(Li + i, y);
      ld2(Rcp + i, rc);
      for (int col = tt; col < n; col += NT) {
        ld2(S + col, s);
        xf_div_recip<2>(s, y, rc, x);
        st2(Wt + (size_t)col * ldw + i, x);
      }
    }
    team_sync(team, NT);
  }

  // W's upper triangle holds zeros when every limb of W is finite and
  // below 2^996 (where Dekker's split does not overflow): then the steps t
  // < max(r, col) of entry (r, col) below add (+0, +0) to (+0, +0).
  const size_t nn = (size_t)n * n;
  bool* small = reinterpret_cast<bool*>(S);  // S is free after the solve
  if (tt == 0) *small = true;
  team_sync(team, NT);
  for (size_t e = tt; e < nn; e += NT) {
    const double2 v = Wt[(e / n) * ldw + e % n];
    if (!(fabs(v.x) < 0x1p996 && fabs(v.y) < 0x1p996)) *small = false;
  }
  team_sync(team, NT);
  const bool skip = *small;

  // A^-1 = W^T W by sequential rank-1 accumulation over the rows t of W: a
  // thread per output column and strip of R rows, four where the team has
  // four strips a thread (their chains share the column's loads), else one.
  double* O = out + b * 2 * n * n;  // limb q of (r, col) at O[q n^2 + r n + col]
  const int R = nn >= 4 * (size_t)NT ? 4 : 1;
  const int strips = (n + R - 1) / R;
  for (int e = tt; e < strips * n; e += NT) {
    const int col = e % n, r0 = R * (e / n);
    const double2* Wc = Wt + (size_t)col * ldw;
    double acc[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) zero2(acc[u]);
    for (int t = skip ? (r0 > col ? r0 : col) : 0; t < n; ++t) {
      double y[2];
      ld2(Wc + t, y);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < R && r0 + u < n && (!skip || t >= r0 + u)) {
          ld2(Wt + (size_t)(r0 + u) * ldw + t, x);
          xf_mul<2>(x, y, c);
          xf_add<2>(acc[u], c, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < R && r0 + u < n) {
        O[(size_t)(r0 + u) * n + col] = acc[u][0];
        O[nn + (size_t)(r0 + u) * n + col] = acc[u][1];
      }
    }
  }
  if (tt == 0) okf[b] = *flag;
}

}  // namespace

// desc: the 10 int64 of Desc; a: the input limbs at desc's strides; out:
// (B, 2, n, n) dense; okf: B float64 flags (1.0 / 0.0); scratch: where
// desc puts L and W in global memory, B (n (n + 1) / 2 + n ldw) double2
// (else unused).
extern "C" int clrs_spd_inverse_dd_wide(const char* desc, const double* a, double* out,
                                        double* okf, double* scratch, void* stream) {
  Desc d;
  std::memcpy(&d, desc, sizeof d);
  if (d.B <= 0 || d.n <= 0) return 0;
  const long long np2 = pow2_at_least((int)d.n);
  if (d.n > kMaxRows || d.team < 32 || d.team % 32 || d.teams < 1 ||
      d.team * d.teams > kMaxThreads || d.ldw < d.n || d.group < 1 || d.group > 32 ||
      np2 % d.group || np2 / d.group > kLaneTerms || d.team < d.group)
    return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(double2) * team_slots(d) * d.teams;
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spd_inverse_dd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (d.B + d.teams - 1) / d.teams;
  spd_inverse_dd_wide_kernel<<<(unsigned)blocks, (unsigned)(d.team * d.teams), shared,
                               (cudaStream_t)stream>>>(a, out, okf,
                                                       reinterpret_cast<double2*>(scratch), d);
  return (int)cudaGetLastError();
}
