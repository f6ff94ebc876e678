// Double-double device functions shared by every kernel of the port.
//
// Restates ops/pallas_dd.py:_Ops (the error-free transforms and the QD
// library's dd sequences) on scalar (hi, lo) pairs.  The plain PyTorch
// versions of the kernels (clrs_tpu_torch/ops/cuda_dd.py, cuda_xf.py)
// perform the same operations in the same order, so a kernel and its plain
// version agree bit for bit.
//
// Build with --fmad=false: a fused multiply-add would break Dekker's
// two_prod and change the cross terms of dd_mul, so every product below
// must round on its own.  Division and sqrt are IEEE correctly rounded in
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

// QD dd multiply (ops/xfloat._dd_mul, pallas_dd._Ops.mul).
__device__ __forceinline__ void dd_mul(double ah, double al, double bh, double bl,
                                       double& rh, double& rl) {
  double p, e;
  two_prod(ah, bh, p, e);
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

}  // namespace clrs
