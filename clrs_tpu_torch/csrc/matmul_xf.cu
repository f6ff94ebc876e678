// K3 and K4 (+K6): batched k-limb matmul by sequential rank-1 accumulation,
// k = 2..12, operands read in place.
//
// Replaces ops/pallas_xf.py:_matmul_kernel (K3, k=2; wrappers
// _matmul_batched and xf_matmul_pallas), _matmul_kernel_k (K4, k >= 3;
// wrapper _matmul_batched_k) and its output-tiled variant
// _matmul_kernel_k_tiled (K6; wrappers _matmul_batched_k_tiled,
// xf_matmul_pallas_tiled): C[b] = A[b] @ B[b], every output entry
// acc = add(acc, mul(a[i, r], b[r, j])) over r in order, in the kernels'
// arithmetic (eft.cuh: the dd sequences at k=2, the per-order cascades at
// k >= 3).  The Pallas kernels give every output entry that sequence,
// whatever their tiles, so one kernel covers all three.  The step count
// is an argument: K at k=2, where the Pallas kernel runs the contraction
// as it is, and K rounded up to a multiple of 8 at k >= 3, where the
// Pallas wrappers zero-pad it (pallas_xf.py:351-356, 514-518, 1115); the
// padded steps multiply zeros, since a cascade add of a zero product need
// not leave the accumulator's limbs bitwise unchanged.  The plain PyTorch
// versions are clrs_tpu_torch/ops/cuda_xf.py:dd_matmul_seq_torch (k=2) and
// matmul_xf_torch (k >= 3).
//
// What bounds it: at the solver's sizes (10-121 outputs, K <= 11) the
// launch, the host's call path and the latency of each output's chain;
// on wide products the FP64 instruction rate (a k=3 step is ~100 FP64
// instructions on 48 bytes of operands).  Tensor cores cannot serve: an
// FP64 mma gives neither the error terms nor the sequential order.  The
// design:
// - operands in place: each arrives as a base pointer, a limb stride, a
//   stride per batch axis (0 where broadcast) and a row and a column
//   stride, so transposed, sliced and broadcast operands need no copy,
//   and one C entry takes the call's description (ops/cuda_xf.py:
//   _matmul_plan);
// - a thread per output entry, the accumulator in registers, threads of
//   a warp on neighbouring columns; blocks of 32 threads, so that the
//   few outputs of a main-path product spread over several SMs;
// - the products off the serial chain: for each chunk of C steps a
//   thread first forms the chunk's C products, which are independent of
//   each other and of the accumulator, then folds them into the
//   accumulator in order, so the dependent path is about
//   ceil(steps / C) multiplies plus steps adds instead of steps of both;
//   C keeps the chunk's products in registers (8 at k <= 4, 4 at k = 5,
//   6, 2 at k = 9, 1 at the other k >= 7, where one multiply alone has
//   ILP enough); a contraction that is not a multiple of C ends in
//   chunks of C/2, C/4, ..., 1;
// - at k >= 7 each instance runs at 160-254 registers, where ptxas's
//   schedule, not the instruction count, sets the time: the chunk size
//   and the width of the output index (32 or 64 bits) each move a k >= 7
//   instance's time by -34 % to +48 % with the same FP64 instructions
//   per step, so both are chosen per k as measured on the H100 (PERF.md);
// - the padded steps' product of zeros formed once per output (it has
//   the same bits every step) and added once per padded step, so the
//   loads of the real steps need no predicate;
// - at k <= 4 every exact product by the fused multiply-add (eft.cuh:
//   two_prod_fma): the same (p, e) as Dekker's in 2 instructions instead
//   of 17; the cross terms stay uncontracted (--fmad=false).
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

constexpr int kBatchAxes = 3;
constexpr int kThreads = 32;

struct Operand {
  const double* p;
  long long limb_stride, batch[kBatchAxes], row, col;
};

// Batch axes right-aligned in batch[kBatchAxes - nbatch .. kBatchAxes),
// 1 in front.
struct Shape {
  long long total, steps, Kc, n, m, batch[kBatchAxes];
};

// Products formed ahead of the accumulation per chunk: all of them stay
// live in registers until they are folded.  At k >= 7, 1 except at k = 9,
// where chunks of 2 measured 1.5x faster on the H100 and slower at every
// other k = 7..12 (PERF.md).
template <int K>
constexpr int kChunk = K <= 4 ? 8 : (K <= 6 ? 4 : (K == 9 ? 2 : 1));

// The output index in 64 bits whatever the output count: at k = 7, 11
// and 12 that instance measured 6-26 % faster on the H100 than the 32-bit
// one, at k <= 6, 8 and 10 slower; at k = 9 faster, but chunks of 2 with
// the 32-bit index faster still (PERF.md).
template <int K>
constexpr bool kWideIndex = K == 7 || K >= 11;

// The exact products by the fused multiply-add where that measured faster
// on the H100 (k <= 4: the same time or up to 27 % less); at k = 5..12
// Dekker's splitting measured as fast or up to 1.7x faster (PERF.md): there the
// compiler schedules its independent instructions into the long
// dependent chains of the k-limb multiply.
template <int K>
constexpr bool kFma = K <= 4;

// Steps r0 .. r0 + C - 1 of the contraction: the products first, then the
// adds in order.
template <int K, int C>
__device__ __forceinline__ void chunk_steps(const double* ar, const double* bc,
                                            const Operand& a, const Operand& b,
                                            long long r0, double (&acc)[K]) {
  using namespace clrs;
  double p[C][K];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    double x[K], y[K];
    load_xf<K>(ar + (r0 + s) * a.col, (size_t)a.limb_stride, x);
    load_xf<K>(bc + (r0 + s) * b.row, (size_t)b.limb_stride, y);
    xf_mul<K, kFma<K>>(x, y, p[s]);
  }
#pragma unroll
  for (int s = 0; s < C; ++s) xf_add<K>(acc, p[s], acc);
}

// The steps past the last full chunk, in chunks of C/2, C/4, ..., 1.
template <int K, int C>
__device__ __forceinline__ void tail_steps(const double* ar, const double* bc,
                                           const Operand& a, const Operand& b,
                                           long long r0, long long left, double (&acc)[K]) {
  if constexpr (C > 1) {
    constexpr int H = C / 2;
    if (left >= H) {
      chunk_steps<K, H>(ar, bc, a, b, r0, acc);
      r0 += H;
      left -= H;
    }
    tail_steps<K, H>(ar, bc, a, b, r0, left, acc);
  }
}

// c: (K, total) contiguous, total = prod(batch) * n * m; I, the type of
// the output index's decomposition (32-bit where total allows).
template <int K, class I>
__global__ void __launch_bounds__(kThreads)
    matmul_xf_kernel(Operand a, Operand b, double* __restrict__ c, Shape sh) {
  using namespace clrs;
  constexpr int C = kChunk<K>;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < sh.total;
       e += (long long)gridDim.x * blockDim.x) {
    const I j = (I)e % (I)sh.m;
    const I t = (I)e / (I)sh.m;
    const I i = t % (I)sh.n;
    I rem = t / (I)sh.n;
    long long oa = (long long)i * a.row, ob = (long long)j * b.col;
    // every axis index a constant: a kernel parameter indexed at run time
    // would be copied to the thread's stack
#pragma unroll
    for (int d = kBatchAxes - 1; d >= 1; --d) {
      const I dim = (I)sh.batch[d];
      oa += (long long)(rem % dim) * a.batch[d];
      ob += (long long)(rem % dim) * b.batch[d];
      rem /= dim;
    }
    oa += (long long)rem * a.batch[0];
    ob += (long long)rem * b.batch[0];
    const double* ar = a.p + oa;
    const double* bc = b.p + ob;
    double acc[K];
#pragma unroll
    for (int q = 0; q < K; ++q) acc[q] = 0.0;
    long long r0 = 0;
    for (; r0 + C <= sh.Kc; r0 += C) chunk_steps<K, C>(ar, bc, a, b, r0, acc);
    tail_steps<K, C>(ar, bc, a, b, r0, sh.Kc - r0, acc);
    if (sh.steps > sh.Kc) {
      // the zero padding (k >= 3): each padded step adds the product of
      // zero operands, the same bits every step, so it is formed once
      double z[K], pz[K];
#pragma unroll
      for (int q = 0; q < K; ++q) z[q] = 0.0;
      xf_mul<K, kFma<K>>(z, z, pz);
      for (long long r = sh.Kc; r < sh.steps; ++r) xf_add<K>(acc, pz, acc);
    }
    store_xf<K>(c + e, (size_t)sh.total, acc);
  }
}

template <int K>
int launch(const Operand& a, const Operand& b, double* c, const Shape& sh,
           cudaStream_t stream) {
  if (sh.total <= 0) return 0;
  const long long want = (sh.total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65535LL * 32 ? want : 65535LL * 32);
  if constexpr (!kWideIndex<K>) {
    if (sh.total <= 0xffffffffLL) {
      matmul_xf_kernel<K, unsigned><<<blocks, kThreads, 0, stream>>>(a, b, c, sh);
      return (int)cudaGetLastError();
    }
  }
  matmul_xf_kernel<K, long long><<<blocks, kThreads, 0, stream>>>(a, b, c, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: 20 int64, the call's description (ops/cuda_xf.py:_matmul_plan): k,
// steps, the contraction length Kc, n, m, the batch dims (3, right-
// aligned, 1 in front), then for a and for b: limb stride, batch strides
// (3, aligned with the dims, 0 where broadcast), row stride, column
// stride.  a: (k, batch, n, Kc) and b: (k, batch, Kc, m) at those strides;
// c: (k, batch, n, m) contiguous.  Returns -1 for a limb count the
// library was not built for, else a cudaError_t.
extern "C" int clrs_matmul_xf(const long long* desc, const double* a, const double* b,
                              double* c, void* stream) {
  Shape sh{0, desc[1], desc[2], desc[3], desc[4], {desc[5], desc[6], desc[7]}};
  sh.total = sh.n * sh.m * sh.batch[0] * sh.batch[1] * sh.batch[2];
  const Operand oa{a, desc[8], {desc[9], desc[10], desc[11]}, desc[12], desc[13]};
  const Operand ob{b, desc[14], {desc[15], desc[16], desc[17]}, desc[18], desc[19]};
  switch (desc[0]) {
#define CLRS_CASE(K) \
  case K:            \
    return launch<K>(oa, ob, c, sh, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}

// Test-only: the exact product of n pairs both ways, for
// tests/test_torch_cuda.py:test_two_prod_fma_range, which holds
// two_prod_fma to Dekker's two_prod (no kernel wrapper calls it): p, e
// from the fused multiply-add, pd, ed from Dekker's splitting.
namespace {
__global__ void two_prod_pairs_kernel(const double* a, const double* b, double* p,
                                      double* e, double* pd, double* ed, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    clrs::two_prod_fma(a[i], b[i], p[i], e[i]);
    clrs::two_prod(a[i], b[i], pd[i], ed[i]);
  }
}
}  // namespace

extern "C" int clrs_two_prod_pairs(const double* a, const double* b, double* p, double* e,
                                   double* pd, double* ed, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long want = (n + 255) / 256;
  two_prod_pairs_kernel<<<(int)(want < 4096 ? want : 4096), 256, 0, (cudaStream_t)stream>>>(
      a, b, p, e, pd, ed, n);
  return (int)cudaGetLastError();
}
