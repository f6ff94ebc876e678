// K7: the step-length sandwich W = L^-1 dM L^-T with M = L L^T, one thread
// block per matrix, every matrix of an iteration in one launch.
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
// Two things follow.  First, the matrices of an iteration come in one
// launch: the Pallas kernel ran once per block-size group and side (4 on
// config 1), each launch one matrix on one SM and the host's call path
// between them.  The launch takes a table of per-matrix entries (the M and
// dM pointers with their limb, row and column strides, so the solver's
// blocks are read where they lie; n; the offsets of the matrix's output
// and flags), passed by value as a kernel parameter, so building it costs
// no copy; each block reads its own entry, so matrices of every size share
// the launch, which takes the largest block and shared size of its table.
// Second, the divs of both solves are by diagonal entries of L, and take
// the reciprocals that the Cholesky stored.  The column solve is built
// like the row solve: for column j, a group of lanes per row i of X forms
// the dot product X[i, :] . L[j, :] with its halving tree in registers and
// shuffles, and a thread per row then runs the div; a row of X depends
// only on the same row of W1 and on L.  As in the Pallas kernel, the
// contraction runs over all n terms with L[j, t] multiplied by the mask
// t < j: the masked terms enter the halving tree as the signed-zero
// products the reference forms (a cascade add of zero is not a bitwise
// identity), and X overwrites W1 in place, column by column.  L, X and the
// reciprocals live in global scratch and S in shared memory, as for K5.
#include <cuda_runtime.h>

#include <cstring>

#include "chol_xf.cuh"

namespace {

// One matrix of a launch, as ops/cuda_xf.py:_STEPLEN_ENTRY packs it.  Its
// W is w[w_off:][:n * n], its flags okf[ok_off:][:n], its scratch at
// scratch + k (2 w_off + ok_off) (chol_xf.cuh: scratch_doubles).
struct Entry {
  const double* m;
  const double* dm;
  long long m_ls, m_rs, m_cs, dm_ls, dm_rs, dm_cs;  // limb, row, column strides
  long long w_off, ok_off, n;
};

// Entries a launch takes: a parameter block of up to 32,764 bytes from CUDA
// 12.1 on (sm_70 and later), 4,096 before.
#if CUDART_VERSION >= 12010
constexpr int kTableEntries = 360;
#else
constexpr int kTableEntries = 44;
#endif

struct Table {
  Entry e[kTableEntries];
};

template <int K>
__global__ void __launch_bounds__(clrs::kBlockThreads)
    steplen_xf_kernel(const __grid_constant__ Table table, double* __restrict__ w,
                      double* __restrict__ okf, double* __restrict__ scratch) {
  using namespace clrs;
  extern __shared__ double smem[];
  const Entry& ent = table.e[blockIdx.x];
  const int n = (int)ent.n, np2 = pow2_at_least(n);
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;
  const int G = group_width(np2);
  const int group = tid / G, groups = blockDim.x / G;
  double* S = smem;
  double* L = scratch + K * (2 * ent.w_off + ent.ok_off);
  double* X = L + K * nn;  // W1, then X column by column
  double* Rcp = X + K * nn;

  block_cholesky_xf<K>(XfView{ent.m, ent.m_ls, ent.m_rs, ent.m_cs}, L, Rcp, S,
                       okf + ent.ok_off, n, np2);
  block_forward_rows_xf<K>(L, Rcp, XfView{ent.dm, ent.dm_ls, ent.dm_rs, ent.dm_cs}, X, S,
                           n, np2);

  double x[K], s[K], c[K], y[K], rc[K];
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
      load_xf<K>(L + (size_t)j * n + j, nn, y);
      load_xf<K>(Rcp + j, n, rc);
      for (int r = tid; r < n; r += blockDim.x) {
        load_xf<K>(S + r, n, s);
        xf_div_recip<K>(s, y, rc, c);
        store_xf<K>(X + (size_t)r * n + j, nn, c);
      }
    }
    __syncthreads();
  }
  double* W = w + ent.w_off;
  for (size_t e = tid; e < nn; e += blockDim.x) W[e] = X[e] + X[nn + e];
}

template <int K>
int launch(const Table& table, int count, double* w, double* okf, double* scratch,
           cudaStream_t stream) {
  int threads = 32, n_max = 1;
  for (int i = 0; i < count; ++i) {
    const long long n = table.e[i].n;
    if (n < 1 || n > clrs::kMaxRows<K>) return (int)cudaErrorInvalidValue;
    const int t = clrs::block_threads((int)n, clrs::pow2_at_least((int)n));
    threads = t > threads ? t : threads;
    n_max = n > n_max ? (int)n : n_max;
  }
  steplen_xf_kernel<K><<<count, threads, clrs::shared_bytes<K>(n_max), stream>>>(
      table, w, okf, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// The entries one launch takes (ops/cuda_xf.py splits a longer list).
extern "C" int clrs_steplen_xf_capacity() { return kTableEntries; }

// entries: count packed Entry (count <= clrs_steplen_xf_capacity()); w, okf
// (1.0 / 0.0): float64, at the entries' offsets; scratch: k (2 sum n^2 +
// sum n) float64 for L, X and the reciprocals.  Returns -1 for a limb count
// the library was not built for.
extern "C" int clrs_steplen_xf(int k, const char* entries, int count, double* w, double* okf,
                               double* scratch, void* stream) {
  if (count <= 0) return 0;
  if (count > kTableEntries) return (int)cudaErrorInvalidValue;
  Table table;
  std::memcpy(table.e, entries, sizeof(Entry) * count);
  switch (k) {
#define CLRS_CASE(K)                                                                \
  case K:                                                                           \
    return launch<K>(table, count, w, okf, scratch, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
