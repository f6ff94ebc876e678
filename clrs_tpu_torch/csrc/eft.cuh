// Float-expansion device functions shared by every kernel of the port.
//
// Restates ops/pallas_dd.py:_Ops (the error-free transforms and the QD
// library's dd sequences) on scalar (hi, lo) pairs, and
// ops/pallas_xf.py:_XOps (the k-limb cascades) on register arrays of K
// limbs.  The plain PyTorch versions of the kernels
// (clrs_tpu_torch/ops/cuda_dd.py, cuda_xf.py, xops.py) perform the same
// operations in the same order, so a kernel and its plain version agree
// bit for bit.
//
// Build with --fmad=false: a contracted multiply-add would break Dekker's
// two_prod and change the cross terms of dd_mul, so every product below
// must round on its own; the one fused multiply-add is two_prod_fma's,
// written out, whose (p, e) equals Dekker's.  Division and sqrt are IEEE correctly rounded in
// double on the card (nvcc's defaults), as they are in PyTorch on the CPU;
// the reciprocal-sqrt seed is 1.0 / sqrt(x), never rsqrt(), whose double
// version is not correctly rounded.
#pragma once

namespace clrs {

__device__ __forceinline__ void two_sum(double a, double b, double& s, double& e) {
  s = a + b;
  double bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

__device__ __forceinline__ void fast_two_sum(double a, double b, double& s, double& e) {
  s = a + b;
  e = b - (s - a);
}

__device__ __forceinline__ void split(double a, double& hi, double& lo) {
  double t = 134217729.0 * a;  // 2^27 + 1
  double u = t - a;
  hi = t - u;
  lo = a - hi;
}

__device__ __forceinline__ void two_prod(double a, double b, double& p, double& e) {
  p = a * b;
  double ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

// The same (p, e) in two instructions: the fused multiply-add rounds
// a*b - p once, and that difference is a double.  Equal to Dekker's
// two_prod, bit for bit and in the sign of a zero e (both give +0 for an
// exact product), wherever Dekker's is exact: a and b zero or normal
// with |a|, |b| < 2^996 (the
// split's 2^27 + 1 multiple does not overflow), |a*b| < 2^1023, and
// exponent(a) + exponent(b) >= -969, exponents as floor(log2 |x|) (e
// and the split halves' products do not underflow); zeros of either
// sign included.  Outside that range Dekker's e is inf, NaN or
// inexact and this one is still a*b - p rounded once.  Only the matmul
// (K3, and K4 at k <= 4) and the Schur block (K2 at k <= 4) take it,
// through the FMA flag of dd_mul and xf_mul; every other kernel, and
// every plain version, keeps Dekker's.
__device__ __forceinline__ void two_prod_fma(double a, double b, double& p, double& e) {
  p = a * b;
  e = __fma_rn(a, b, -p);
}

template <bool FMA>
__device__ __forceinline__ void two_prod_t(double a, double b, double& p, double& e) {
  if constexpr (FMA)
    two_prod_fma(a, b, p, e);
  else
    two_prod(a, b, p, e);
}

// QD ieee_add (ops/xfloat._dd_add, pallas_dd._Ops.add).
__device__ __forceinline__ void dd_add(double ah, double al, double bh, double bl,
                                       double& rh, double& rl) {
  double s1, s2, t1, t2;
  two_sum(ah, bh, s1, s2);
  two_sum(al, bl, t1, t2);
  s2 = s2 + t1;
  fast_two_sum(s1, s2, s1, s2);
  s2 = s2 + t2;
  fast_two_sum(s1, s2, rh, rl);
}

// QD dd multiply (ops/xfloat._dd_mul, pallas_dd._Ops.mul); FMA: the
// exact product by two_prod_fma.
template <bool FMA = false>
__device__ __forceinline__ void dd_mul(double ah, double al, double bh, double bl,
                                       double& rh, double& rl) {
  double p, e;
  two_prod_t<FMA>(ah, bh, p, e);
  e = e + (ah * bl + al * bh);
  fast_two_sum(p, e, rh, rl);
}

// Reciprocal Newton (two steps) plus one refinement (pallas_dd._Ops.div).
__device__ __forceinline__ void dd_div(double ah, double al, double bh, double bl,
                                       double& rh, double& rl) {
  double safe = (bh != 0.0) ? bh : 1.0;
  double xh = 1.0 / safe, xl = 0.0;
  double th, tl, eh, el, ch, cl;
  for (int it = 0; it < 2; ++it) {
    dd_mul(bh, bl, xh, xl, th, tl);
    dd_add(1.0, 0.0, -th, -tl, eh, el);
    dd_mul(xh, xl, eh, el, ch, cl);
    dd_add(xh, xl, ch, cl, xh, xl);
  }
  double qh, ql;
  dd_mul(ah, al, xh, xl, qh, ql);
  dd_mul(bh, bl, qh, ql, th, tl);
  double resh, resl;
  dd_add(ah, al, -th, -tl, resh, resl);
  dd_mul(resh, resl, xh, xl, ch, cl);
  dd_add(qh, ql, ch, cl, rh, rl);
}

// sqrt by rsqrt Newton (two steps) plus one refinement (pallas_dd._Ops.sqrt);
// a >= 0, 0 allowed.
__device__ __forceinline__ void dd_sqrt(double ah, double al, double& rh, double& rl) {
  bool pos = ah > 0.0;
  double sh = pos ? ah : 1.0;
  double sl = pos ? al : 0.0;
  double xh = 1.0 / sqrt(sh), xl = 0.0;
  double x2h, x2l, th, tl, eh, el, ch, cl;
  for (int it = 0; it < 2; ++it) {
    dd_mul(xh, xl, xh, xl, x2h, x2l);
    dd_mul(sh, sl, x2h, x2l, th, tl);
    dd_add(1.0, 0.0, -th, -tl, eh, el);
    dd_mul(xh, xl, eh, el, ch, cl);
    dd_add(xh, xl, 0.5 * ch, 0.5 * cl, xh, xl);
  }
  double qh, ql, q2h, q2l;
  dd_mul(sh, sl, xh, xl, qh, ql);
  dd_mul(qh, ql, qh, ql, q2h, q2l);
  dd_add(sh, sl, -q2h, -q2l, eh, el);
  dd_mul(eh, el, xh, xl, ch, cl);
  dd_add(qh, ql, 0.5 * ch, 0.5 * cl, qh, ql);
  rh = pos ? qh : 0.0;
  rl = pos ? ql : 0.0;
}

// In-place zero-padded halving tree over v[0..np2) with the given stride
// (pallas_dd._Ops.sum_axis): level by level, v[t] += v[t + half].  The
// caller fills v[n..np2) with zeros first.  Returns the sum in (rh, rl).
__device__ __forceinline__ void dd_halving_sum(double* vh, double* vl, int np2,
                                               int stride, double& rh, double& rl) {
  for (int half = np2 / 2; half >= 1; half /= 2) {
    for (int t = 0; t < half; ++t) {
      dd_add(vh[t * stride], vl[t * stride], vh[(t + half) * stride],
             vl[(t + half) * stride], vh[t * stride], vl[t * stride]);
    }
  }
  rh = vh[0];
  rl = vl[0];
}

// ---------------------------------------------------------------------------
// K limbs (pallas_xf._XOps; plain version clrs_tpu_torch/ops/xops.py).  At
// K=2 add and mul are the dd sequences above; for K >= 3 they are the
// per-order error cascades of ops/xfloat.py:_cascade_add/_cascade_mul.
// Every function reads all of its inputs before it writes its output, so
// the output may alias an input.
// ---------------------------------------------------------------------------

// Final renormalization of both cascades: a two_sum chain down the
// orders, then VecSum (two_sums from the last term up).
template <int K>
__device__ __forceinline__ void renorm_chain(double (&v)[K], double (&r)[K]) {
  double t[K];
  double err;
  two_sum(v[0], v[1], t[0], err);
#pragma unroll
  for (int i = 2; i < K; ++i) two_sum(err, v[i], t[i - 1], err);
  t[K - 1] = err;
  double s = t[K - 1];
#pragma unroll
  for (int i = K - 2; i >= 0; --i) two_sum(t[i], s, s, r[i + 1]);
  r[0] = s;
}

template <int K>
__device__ __forceinline__ void xf_add(const double (&a)[K], const double (&b)[K],
                                       double (&r)[K]) {
  if constexpr (K == 2) {
    dd_add(a[0], a[1], b[0], b[1], r[0], r[1]);
  } else {
    double s[K], e[K], v[K], carry[K];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) two_sum(a[i], b[i], s[i], e[i]);
    double top = a[K - 1] + b[K - 1];
    v[0] = s[0];
    carry[0] = e[0];
#pragma unroll
    for (int i = 1; i < K - 1; ++i) {
      double x = s[i];
#pragma unroll
      for (int c = 0; c < i; ++c) two_sum(x, carry[c], x, carry[c]);
      v[i] = x;
      carry[i] = e[i];
    }
#pragma unroll
    for (int c = 0; c < K - 1; ++c) top = top + carry[c];
    v[K - 1] = top;
    renorm_chain<K>(v, r);
  }
}

// Fold the error g of order q - 1 into order q, and the error of that
// into the next order, down to the top order, which adds plainly.  This
// keeps each order's sequence of terms exactly the reference's (its
// originals first, then the errors of the order above it in the order
// they arise), when the orders are processed from the top down.
template <int K>
__device__ __forceinline__ void push_error(double (&v)[K], int q, double g) {
#pragma unroll
  for (int o = 1; o < K - 1; ++o)
    if (o >= q) two_sum(v[o], g, v[o], g);
  v[K - 1] = v[K - 1] + g;
}

// Fold term t into order o (o < K - 1) whose first term is already in v[o].
template <int K>
__device__ __forceinline__ void fold_term(double (&v)[K], int o, double t) {
  double g;
  two_sum(v[o], t, v[o], g);
  push_error<K>(v, o + 1, g);
}

// FMA: every exact product by two_prod_fma (the matmul's instance).
template <int K, bool FMA = false>
__device__ __forceinline__ void xf_mul(const double (&a)[K], const double (&b)[K],
                                       double (&r)[K]) {
  if constexpr (K == 2) {
    dd_mul<FMA>(a[0], a[1], b[0], b[1], r[0], r[1]);
  } else {
    // Order o holds the products a[i] b[o-i] of order o and the errors of
    // the products of order o - 1; the reference lists, per order, the
    // errors of order o - 1 (by i), then the products of order o (by i),
    // then the two_sum errors of order o - 1's combine.
    double v[K], p_hi[K], p_lo[K];
    double p, e;
    // top order K-1: errors of order K-2, then the plain products of
    // orders K-1 and K
#pragma unroll
    for (int i = 0; i <= K - 2; ++i) {
      two_prod_t<FMA>(a[i], b[K - 2 - i], p, e);
      p_hi[i] = p;
      v[K - 1] = (i == 0) ? e : v[K - 1] + e;
    }
    double cheap = a[0] * b[K - 1];
#pragma unroll
    for (int i = 1; i <= K - 1; ++i) cheap = cheap + a[i] * b[K - 1 - i];
#pragma unroll
    for (int i = 1; i <= K - 1; ++i) cheap = cheap + a[i] * b[K - i];
    v[K - 1] = v[K - 1] + cheap;
    // orders K-2 .. 1, top down: errors of order o - 1, then the products
    // of order o (saved from the step above), each error of the combine
    // folded at once into the orders above
#pragma unroll
    for (int o = K - 2; o >= 1; --o) {
#pragma unroll
      for (int i = 0; i <= o - 1; ++i) {
        two_prod_t<FMA>(a[i], b[o - 1 - i], p, e);
        p_lo[i] = p;
        if (i == 0)
          v[o] = e;
        else
          fold_term<K>(v, o, e);
      }
#pragma unroll
      for (int i = 0; i <= o; ++i) fold_term<K>(v, o, p_hi[i]);
#pragma unroll
      for (int i = 0; i <= o - 1; ++i) p_hi[i] = p_lo[i];
    }
    v[0] = p_hi[0];
    renorm_chain<K>(v, r);
  }
}

// Out-of-line copies for the kernels whose K-limb chains are long and not
// the inner loop (K5): one body per K instead of one per call site.
template <int K>
__device__ __noinline__ void xf_add_n(const double (&a)[K], const double (&b)[K],
                                      double (&r)[K]) {
  xf_add<K>(a, b, r);
}

template <int K>
__device__ __noinline__ void xf_mul_n(const double (&a)[K], const double (&b)[K],
                                      double (&r)[K]) {
  xf_mul<K>(a, b, r);
}

// The add and multiply of the long dependent chains (div, sqrt, and the dot
// products of K5 and K7): inline up to K = 4, whose bodies are short, so
// that no link of the chain makes an out-of-line call's round trip through
// the stack; out of line above, one body per K.
template <int K>
__device__ __forceinline__ void xf_add_c(const double (&a)[K], const double (&b)[K],
                                         double (&r)[K]) {
  if constexpr (K <= 4)
    xf_add<K>(a, b, r);
  else
    xf_add_n<K>(a, b, r);
}

template <int K>
__device__ __forceinline__ void xf_mul_c(const double (&a)[K], const double (&b)[K],
                                         double (&r)[K]) {
  if constexpr (K <= 4)
    xf_mul<K>(a, b, r);
  else
    xf_mul_n<K>(a, b, r);
}

// Newton steps of recip and sqrt: ceil(log2 k) + 1.
__host__ __device__ constexpr int newton_steps(int k) {
  int c = 0;
  while ((1 << c) < k) ++c;
  return c + 1;
}

// 1/b by Newton from the seed 1/b0 of a masked divisor (_XOps.recip).
template <int K>
__device__ void xf_recip(const double (&b)[K], double (&x)[K]) {
  double one[K], t[K], e[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    one[q] = q == 0 ? 1.0 : 0.0;
    x[q] = 0.0;
  }
  x[0] = 1.0 / (b[0] != 0.0 ? b[0] : 1.0);
  for (int it = 0; it < newton_steps(K); ++it) {
    xf_mul_c<K>(b, x, t);
#pragma unroll
    for (int q = 0; q < K; ++q) t[q] = -t[q];
    xf_add_c<K>(one, t, e);
    xf_mul_c<K>(x, e, t);
    xf_add_c<K>(x, t, x);
  }
}

// a / b given r = xf_recip(b): the five operations that follow the
// reciprocal in xf_div, in its order, so that xf_div_recip(a, b,
// xf_recip(b)) is xf_div(a, b) bit for bit.  The solves of K1, K5 and K7
// divide by diagonal entries of L whose reciprocals the Cholesky stored
// (chol_xf.cuh).
template <int K>
__device__ void xf_div_recip(const double (&a)[K], const double (&b)[K],
                             const double (&r)[K], double (&out)[K]) {
  double q[K], t[K], res[K];
  xf_mul_c<K>(a, r, q);
  xf_mul_c<K>(b, q, t);
#pragma unroll
  for (int i = 0; i < K; ++i) t[i] = -t[i];
  xf_add_c<K>(a, t, res);
  xf_mul_c<K>(res, r, t);
  xf_add_c<K>(q, t, out);
}

// a / b with one refinement step (_XOps.div).
template <int K>
__device__ void xf_div(const double (&a)[K], const double (&b)[K], double (&out)[K]) {
  double r[K];
  xf_recip<K>(b, r);
  xf_div_recip<K>(a, b, r, out);
}

// sqrt by rsqrt Newton plus one refinement (_XOps.sqrt); a >= 0, 0
// allowed.  The seed is 1.0 / sqrt(a0), correctly rounded, never rsqrt().
template <int K>
__device__ void xf_sqrt(const double (&a)[K], double (&out)[K]) {
  const bool pos = a[0] > 0.0;
  double safe[K], one[K], x[K], t[K], u[K], e[K], s[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    safe[q] = pos ? a[q] : (q == 0 ? 1.0 : 0.0);
    one[q] = q == 0 ? 1.0 : 0.0;
    x[q] = 0.0;
  }
  x[0] = 1.0 / sqrt(safe[0]);
  for (int it = 0; it < newton_steps(K); ++it) {
    xf_mul_c<K>(x, x, t);
    xf_mul_c<K>(safe, t, u);
#pragma unroll
    for (int q = 0; q < K; ++q) u[q] = -u[q];
    xf_add_c<K>(one, u, e);
    xf_mul_c<K>(x, e, t);
#pragma unroll
    for (int q = 0; q < K; ++q) t[q] = 0.5 * t[q];
    xf_add_c<K>(x, t, x);
  }
  xf_mul_c<K>(safe, x, s);
  xf_mul_c<K>(s, s, t);
#pragma unroll
  for (int q = 0; q < K; ++q) t[q] = -t[q];
  xf_add_c<K>(safe, t, e);
  xf_mul_c<K>(e, x, t);
#pragma unroll
  for (int q = 0; q < K; ++q) t[q] = 0.5 * t[q];
  xf_add_c<K>(s, t, s);
#pragma unroll
  for (int q = 0; q < K; ++q) out[q] = pos ? s[q] : 0.0;
}

// Load / store K limbs at a limb stride.
template <int K>
__device__ __forceinline__ void load_xf(const double* p, size_t limb_stride,
                                        double (&x)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) x[q] = p[q * limb_stride];
}

template <int K>
__device__ __forceinline__ void store_xf(double* p, size_t limb_stride,
                                         const double (&x)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) p[q * limb_stride] = x[q];
}

}  // namespace clrs

// The limb counts the k-limb kernels are instantiated for.
#define CLRS_FOR_EACH_K(X) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)
// K7 and K8 also take k=2, as the Pallas kernels do, and the SPD inverse's
// K=2 instance is K1: it adds and multiplies by the dd sequences and
// divides and takes square roots by the generic Newton steps (two at k=2),
// as ops/xops.py does; those are dd_div's and dd_sqrt's steps, in their
// order.
#define CLRS_FOR_EACH_K_FROM_2(X) X(2) CLRS_FOR_EACH_K(X)
