// K8: elementwise K-limb add or multiply of two limb arrays, broadcast.
//
// Replaces ops/pallas_xf.py:_elemwise_kernel_k (wrappers
// _elemwise_batched_k and xf_elemwise_pallas, dispatched from xfloat's
// xf_add / xf_mul above a limb-count gate): r = a + b or a * b per element
// by the kernels' arithmetic (eft.cuh: the dd sequences at k=2, the
// per-order cascades at k >= 3).  The reference broadcasts both operands
// and zero-pads them to k limbs before its call (xfloat.py:732-738); here
// the loads do both: each operand arrives as a base pointer, its own limb
// count (the missing limbs are exact zeros in registers), a limb stride
// and an element stride per output axis, 0 on a broadcast axis.  So every
// xf_add / xf_mul is one launch, with no copy before it.  The output is
// written contiguous, (k, *shape).  The plain PyTorch version is
// clrs_tpu_torch/ops/cuda_xf.py:elemwise_xf_torch (broadcast and zero pad,
// then ops/xops.py add and mul).
//
// What bounds it: at the solver's sizes (1 to a few hundred elements) the
// launch and the host's call path, which the wrapper keeps short (a
// cached operand description, one C entry); on wide arrays the bytes at
// k=2..3 and the FP64 operations of the cascades above (a k=3 multiply is
// ~100 of them on 48 bytes of operands).  One thread per element,
// grid-stride; limb q of all elements is contiguous in the output, and in
// the operands where they are, so the loads and stores of each limb are
// coalesced, and the cascade runs in registers, inline.
#include <cuda_runtime.h>

#include "eft.cuh"

namespace {

constexpr int kMaxAxes = 4;

struct Operand {
  const double* p;
  long long limbs, limb_stride, stride[kMaxAxes];
};

// Output axes right-aligned in dims[kMaxAxes - ndim .. kMaxAxes).
struct Shape {
  long long N, ndim, dims[kMaxAxes];
};

// Element offsets of output element e in a and b; I is the index type of
// the decomposition (32-bit where N allows).  The loops are unrolled so
// that every axis index is a constant: a kernel parameter indexed at run
// time would be copied to the thread's stack first.
template <class I>
__device__ __forceinline__ void offsets(I e, const Shape& sh, const Operand& a,
                                        const Operand& b, long long& oa, long long& ob) {
  const int outer = kMaxAxes - (int)sh.ndim;
  I rem = e;
  oa = 0;
  ob = 0;
#pragma unroll
  for (int d = kMaxAxes - 1; d >= 1; --d) {
    if (d > outer) {
      const I dim = (I)sh.dims[d];
      const I i = rem % dim;
      rem /= dim;
      oa += (long long)i * a.stride[d];
      ob += (long long)i * b.stride[d];
    }
  }
#pragma unroll
  for (int d = 0; d < kMaxAxes; ++d) {
    if (d == outer) {
      oa += (long long)rem * a.stride[d];
      ob += (long long)rem * b.stride[d];
    }
  }
}

template <int K>
__device__ __forceinline__ void load_operand(const Operand& x, long long off, double (&v)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = q < x.limbs ? x.p[q * x.limb_stride + off] : 0.0;
}

// DENSE: both operands of k limbs, laid out as the output (one axis,
// element stride 1), the solver's most common call: unpredicated loads at
// the output's offsets, as wide arrays want them.
template <int K, bool MUL, bool DENSE>
__global__ void elemwise_xf_kernel(Operand a, Operand b, double* __restrict__ out,
                                   Shape sh) {
  using namespace clrs;
  const long long N = sh.N;
  const bool narrow = N <= 0xffffffffLL;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += (long long)gridDim.x * blockDim.x) {
    double x[K], y[K], r[K];
    if constexpr (DENSE) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        x[q] = a.p[q * a.limb_stride + e];
        y[q] = b.p[q * b.limb_stride + e];
      }
    } else {
      long long oa, ob;
      if (sh.ndim == 1) {
        oa = e * a.stride[kMaxAxes - 1];
        ob = e * b.stride[kMaxAxes - 1];
      } else if (narrow) {
        offsets<unsigned>((unsigned)e, sh, a, b, oa, ob);
      } else {
        offsets<long long>(e, sh, a, b, oa, ob);
      }
      load_operand<K>(a, oa, x);
      load_operand<K>(b, ob, y);
    }
    if constexpr (MUL)
      xf_mul<K>(x, y, r);
    else
      xf_add<K>(x, y, r);
#pragma unroll
    for (int q = 0; q < K; ++q) out[q * N + e] = r[q];
  }
}

template <int K, bool MUL>
void launch_op(bool dense, int blocks, int threads, const Operand& a, const Operand& b,
               double* out, const Shape& sh, cudaStream_t stream) {
  if (dense)
    elemwise_xf_kernel<K, MUL, true><<<blocks, threads, 0, stream>>>(a, b, out, sh);
  else
    elemwise_xf_kernel<K, MUL, false><<<blocks, threads, 0, stream>>>(a, b, out, sh);
}

template <int K>
int launch(bool mul, const Operand& a, const Operand& b, double* out, const Shape& sh,
           cudaStream_t stream) {
  if (sh.N <= 0) return 0;
  const int threads = 256;
  const long long want = (sh.N + threads - 1) / threads;
  const int blocks = (int)(want < 8448 ? want : 8448);  // 64 per SM, then grid-stride
  const bool dense = sh.ndim == 1 && a.limbs == K && b.limbs == K &&
                     a.stride[kMaxAxes - 1] == 1 && b.stride[kMaxAxes - 1] == 1;
  if (mul)
    launch_op<K, true>(dense, blocks, threads, a, b, out, sh, stream);
  else
    launch_op<K, false>(dense, blocks, threads, a, b, out, sh, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: 20 int64, the call's operand description (ops/cuda_xf.py:
// _elemwise_plan): k, op (0 add, 1 multiply), N, ndim (1..4), the output
// dims (4, right-aligned, 1 in front), then for a and for b: limb count
// (<= k), limb stride, element strides (4, aligned with the dims).  a, b:
// the operands' base pointers; out: (k, N) contiguous.  Returns -1 for a
// limb count the library was not built for, else a cudaError_t.
extern "C" int clrs_elemwise_xf(const long long* desc, const double* a, const double* b,
                                double* out, void* stream) {
  Shape sh{desc[2], desc[3], {desc[4], desc[5], desc[6], desc[7]}};
  if (sh.ndim < 1 || sh.ndim > kMaxAxes) return (int)cudaErrorInvalidValue;
  const Operand oa{a, desc[8], desc[9], {desc[10], desc[11], desc[12], desc[13]}};
  const Operand ob{b, desc[14], desc[15], {desc[16], desc[17], desc[18], desc[19]}};
  const bool mul = desc[1] == 1;
  switch (desc[0]) {
#define CLRS_CASE(K) \
  case K:            \
    return launch<K>(mul, oa, ob, out, sh, (cudaStream_t)stream);
    CLRS_FOR_EACH_K_FROM_2(CLRS_CASE)
#undef CLRS_CASE
    default:
      return -1;
  }
}
