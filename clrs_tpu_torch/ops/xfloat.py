"""k-limb float-expansion arithmetic on torch tensors.

An ``XF`` value is an unevaluated sum of k float64 "limbs"
x = l_0 + l_1 + ... + l_{k-1}, stored as ONE tensor of shape (k, *shape)
on an explicit device.  This module is the torch counterpart of
``clrs_tpu/ops/xfloat.py`` for k = 2..12: the QD library's double-double
sequences at k=2, the triple- and quad-word sequences at k=3 and 4, the
per-order error cascades at 5 <= k <= 12 (and for mixed limb counts).
Every function performs the reference's operations in the reference's
order, so on float64 limbs the two packages agree limb for limb.

What the reference carries and this module leaves out: scaled expansions
(a TPU float32 exponent-range workaround), the XLA optimization barriers
(eager torch never rewrites ``(a+b)-a`` to ``b``, and each op rounds on
its own, so nothing contracts into an FMA), the ``_loop_*`` kernels that
take k >= 13 (such a k raises ``NotImplementedError``), and the
gates of the elementwise Pallas kernel (float32, TPU backend, size, limb
count).  In their place one switch, off by default: inside
``elemwise_cuda()`` every ``xf_add``/``xf_mul`` goes through K8
(``ops/cuda_xf.elemwise_xf``); the solver turns it on with
``SolverConfig.use_cuda_elemwise``.

Never reduce limbs with ``torch.sum``/``torch.matmul``: their summation
order is the library's, which breaks the error-free transforms and the
limb-for-limb agreement.  ``xf_sum`` is the tree the reference uses.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch

F64 = torch.float64

# ---------------------------------------------------------------------------
# Error-free transforms
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a+b).  (Knuth, 6 flops.)"""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """s + e == a + b exactly, assuming |a| >= |b|.  (Dekker, 3 flops.)"""
    s = a + b
    e = b - (s - a)
    return s, e


_SPLIT = 134217729.0  # 2^27 + 1 for float64


def split(a):
    """a == hi + lo with hi, lo of ~26-bit significands (Dekker)."""
    t = _SPLIT * a
    u = t - a
    hi = t - u
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a*b).  (Dekker splitting.)"""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root on any device.  torch's CPU
    kernel is not: it misses by one ulp on ~0.8 % of random float64
    inputs (torch 2.13 CPU build, against numpy and mpmath), which would
    break the limb-for-limb agreement of every sqrt seed.  numpy's and
    CUDA's double sqrt are IEEE correctly rounded."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
    return torch.sqrt(x)


def _vec_sum(terms):
    """VecSum: chain of two_sums from the last term up; terms[0] of the
    result is fl(sum of inputs) (exact transform)."""
    n = len(terms)
    out = [None] * n
    s = terms[n - 1]
    for i in range(n - 2, -1, -1):
        s, e = two_sum(terms[i], s)
        out[i + 1] = e
    out[0] = s
    return out


def _vec_sum_err_branch(terms, k: int):
    """Compress a VecSum output into k nonoverlapping limbs (CAMPARY's
    VecSumErrBranch, the output index realized as elementwise selects)."""
    n = len(terms)
    zero = torch.zeros_like(terms[0])
    out = [zero] * k
    j = torch.zeros(terms[0].shape, dtype=torch.int32, device=terms[0].device)
    eps = terms[0]
    for i in range(n - 1):
        r, new_eps = two_sum(eps, terms[i + 1])
        advance = new_eps != 0.0
        for slot in range(k):
            out[slot] = torch.where(advance & (j == slot), r, out[slot])
        eps = torch.where(advance, new_eps, r)
        j = torch.where(advance & (j < k), j + 1, j)
    for slot in range(k):
        out[slot] = torch.where(j == slot, eps, out[slot])
    return out


def _renorm(terms, k: int, passes: int = 2):
    """Exact-sum compression of roughly magnitude-ordered terms into k
    limbs: VecSum passes, then the branch pass."""
    terms = list(terms)
    if len(terms) == 1:
        return terms + [torch.zeros_like(terms[0])] * (k - 1)
    for _ in range(passes):
        terms = _vec_sum(terms)
    return _vec_sum_err_branch(terms, k)


MAX_K = 12  # beyond this the reference switches to its _loop_* kernels


def _check_k(k: int):
    if not 2 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: the port computes in 2..{MAX_K} limbs; above {MAX_K} the "
            "reference runs its _loop_add/_loop_mul kernels, not ported yet")


# ---------------------------------------------------------------------------
# The XF type
# ---------------------------------------------------------------------------


class XF:
    """k-limb float expansion over a stacked tensor of shape (k, *shape)."""

    __slots__ = ("limbs",)

    def __init__(self, limbs: torch.Tensor):
        self.limbs = limbs

    # -- metadata --
    @property
    def k(self) -> int:
        return self.limbs.shape[0]

    @property
    def shape(self):
        return tuple(self.limbs.shape[1:])

    @property
    def ndim(self) -> int:
        return self.limbs.ndim - 1

    @property
    def dtype(self):
        return self.limbs.dtype

    @property
    def device(self):
        return self.limbs.device

    def __len__(self):
        return self.shape[0]

    def to(self, device) -> "XF":
        return XF(self.limbs.to(device))

    # -- construction --
    @staticmethod
    def from_limb_list(limbs: Sequence[torch.Tensor]) -> "XF":
        return XF(torch.stack(list(limbs), dim=0))

    @staticmethod
    def zeros(shape=(), k: int = 2, *, device, dtype=F64) -> "XF":
        return XF(torch.zeros((k,) + tuple(shape), dtype=dtype, device=device))

    @staticmethod
    def ones(shape=(), k: int = 2, *, device, dtype=F64) -> "XF":
        limbs = torch.zeros((k,) + tuple(shape), dtype=dtype, device=device)
        limbs[0] = 1.0
        return XF(limbs)

    @staticmethod
    def eye(n: int, k: int = 2, *, device, dtype=F64) -> "XF":
        limbs = torch.zeros((k, n, n), dtype=dtype, device=device)
        limbs[0] = torch.eye(n, dtype=dtype, device=device)
        return XF(limbs)

    @staticmethod
    def from_float(x, k: int = 2, *, device=None, dtype=F64, shape=()) -> "XF":
        """Lift a float/tensor (already exactly representable) to XF.  A
        tensor keeps its own device; a Python scalar needs ``device``."""
        if isinstance(x, torch.Tensor):
            x = x.to(dtype)
            device = x.device
        else:
            if device is None:
                raise ValueError("from_float of a Python scalar needs device=")
            x = torch.tensor(x, dtype=dtype, device=device)
        if shape:
            x = torch.broadcast_to(x, tuple(shape))
        limbs = torch.zeros((k,) + tuple(x.shape), dtype=dtype, device=device)
        limbs[0] = x
        return XF(limbs)

    # -- conversion --
    def to_float(self) -> torch.Tensor:
        """The leading limb, fl(value)."""
        return self.limbs[0]

    def to_float64(self) -> torch.Tensor:
        return self.limbs[0].to(F64)

    # -- indexing and views --
    def __getitem__(self, idx) -> "XF":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return XF(self.limbs[(slice(None),) + idx])

    def reshape(self, *shape) -> "XF":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return XF(self.limbs.reshape((self.k,) + tuple(shape)))

    def broadcast_to(self, shape) -> "XF":
        shape = tuple(shape)
        limbs = self.limbs.reshape(
            (self.k,) + (1,) * (len(shape) - self.ndim) + self.shape)
        return XF(torch.broadcast_to(limbs, (self.k,) + shape))

    @property
    def T(self) -> "XF":
        return self.transpose()

    def transpose(self, *axes) -> "XF":
        """Permute the value axes (all reversed by default, like numpy)."""
        if not axes:
            axes = tuple(range(self.ndim - 1, -1, -1))
        elif len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return XF(self.limbs.permute((0,) + tuple(a + 1 for a in axes)))

    @property
    def mT(self) -> "XF":
        """Swap the last two value axes (a batched matrix transpose)."""
        return XF(self.limbs.transpose(-1, -2))

    # -- operators --
    def __neg__(self):
        return XF(-self.limbs)

    def __add__(self, other):
        return xf_add(self, _lift(other, self))

    def __radd__(self, other):
        return xf_add(_lift(other, self), self)

    def __sub__(self, other):
        return xf_add(self, -_lift(other, self))

    def __rsub__(self, other):
        return xf_add(_lift(other, self), -self)

    def __mul__(self, other):
        return xf_mul(self, _lift(other, self))

    def __rmul__(self, other):
        return xf_mul(_lift(other, self), self)

    def __truediv__(self, other):
        return xf_div(self, _lift(other, self))

    def __rtruediv__(self, other):
        return xf_div(_lift(other, self), self)

    def __matmul__(self, other):
        return xf_matmul(self, other)

    def __lt__(self, other):
        return xf_lt(self, _lift(other, self))

    def __le__(self, other):
        return ~xf_lt(_lift(other, self), self)

    def __gt__(self, other):
        return xf_lt(_lift(other, self), self)

    def __ge__(self, other):
        return ~xf_lt(self, _lift(other, self))

    def __repr__(self):
        return (f"XF(k={self.k}, shape={self.shape}, dtype={self.dtype}, "
                f"device={self.device})")


def _lift(x, like: XF) -> XF:
    if isinstance(x, XF):
        return x
    return XF.from_float(x, k=like.k, dtype=like.dtype, device=like.device)


def _lift2(a, b):
    if not isinstance(a, XF):
        a = _lift(a, b)
    if not isinstance(b, XF):
        b = _lift(b, a)
    return a, b


def _broadcast_shape(*shapes) -> tuple:
    """The common shape, as torch.broadcast_shapes gives it; that one's
    Python implementation takes ~60 us a call, a third of a solve on the
    CPU."""
    first = tuple(shapes[0])
    if all(tuple(s) == first for s in shapes[1:]):
        return first
    return np.broadcast_shapes(*shapes)


def _operands(a: XF, b: XF):
    """Limb lists of a and b broadcast to their common value shape, and
    the result's limb count max(a.k, b.k)."""
    k = max(a.k, b.k)
    _check_k(k)
    sa, sb = a.shape, b.shape
    shape = _broadcast_shape(sa, sb)
    al, bl = a.limbs.unbind(0), b.limbs.unbind(0)
    if sa != shape:
        al = [torch.broadcast_to(x, shape) for x in al]
    if sb != shape:
        bl = [torch.broadcast_to(x, shape) for x in bl]
    return list(al), list(bl), k


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def dd_add(ah, al, bh, bl):
    """Accurate double-double add (QD library's ieee_add) on limb pairs."""
    s1, s2 = two_sum(ah, bh)
    t1, t2 = two_sum(al, bl)
    s2 = s2 + t1
    s1, s2 = fast_two_sum(s1, s2)
    s2 = s2 + t2
    return fast_two_sum(s1, s2)


def dd_mul(ah, al, bh, bl):
    """Double-double multiply (QD library) on limb pairs."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return fast_two_sum(p, e)


def _renorm_chain(vals):
    """The cascades' final renormalization: a two_sum chain down the
    orders, then a VecSum pull-up for canonical leading limbs."""
    r = []
    hi, err = two_sum(vals[0], vals[1])
    r.append(hi)
    for v in vals[2:]:
        hi, err = two_sum(err, v)
        r.append(hi)
    r.append(err)
    return _vec_sum(r)


def cascade_add(al, bl, k: int):
    """k-limb add of equal-length limb lists by per-order error cascades
    (xfloat.py:860-898): exact two_sums per order, errors pushed one order
    down, plain folds only at the top order."""
    s, e = [], []
    for i in range(k - 1):
        si, ei = two_sum(al[i], bl[i])
        s.append(si)
        e.append(ei)
    vals = [s[0]]
    carry = [e[0]]  # errors destined for the current order
    for i in range(1, k - 1):
        v = s[i]
        nxt = []
        for c in carry:
            v, g = two_sum(v, c)
            nxt.append(g)
        vals.append(v)
        nxt.append(e[i])
        carry = nxt
    top = al[k - 1] + bl[k - 1]
    for c in carry:
        top = top + c
    vals.append(top)
    return _renorm_chain(vals)


def cascade_mul(al, bl, k: int):
    """k-limb multiply of limb lists (any lengths) by per-order error
    cascades (xfloat.py:1038-1084): exact two_prods for the orders
    0..k-2 with their errors pushed one order down, plain products folded
    at orders k-1 and k, per-order two_sum combines."""
    ka, kb = len(al), len(bl)
    groups = [[] for _ in range(k)]
    for o in range(k - 1):
        for i in range(o + 1):
            j = o - i
            if i < ka and j < kb:
                p, e = two_prod(al[i], bl[j])
                groups[o].append(p)
                groups[o + 1].append(e)
    cheap = None
    for o in (k - 1, k):
        for i in range(o + 1):
            j = o - i
            if i < ka and j < kb:
                t = al[i] * bl[j]
                cheap = t if cheap is None else cheap + t
    if cheap is not None:
        groups[k - 1].append(cheap)
    vals = []
    for o in range(k):
        terms = groups[o]
        if not terms:
            vals.append(torch.zeros_like(al[0]))
            continue
        v = terms[0]
        for t in terms[1:]:
            if o == k - 1:
                v = v + t  # below the last limb's ulp
            else:
                v, g = two_sum(v, t)
                groups[o + 1].append(g)
        vals.append(v)
    return _renorm_chain(vals)


def _td_add(al, bl):
    """Triple-word add (xfloat.py:912-925)."""
    s0, e0 = two_sum(al[0], bl[0])
    s1, e1 = two_sum(al[1], bl[1])
    s2 = al[2] + bl[2]
    t1, t2 = two_sum(s1, e0)
    o2 = (s2 + e1) + t2
    r0, u = two_sum(s0, t1)
    r1, r2 = two_sum(u, o2)
    return _vec_sum([r0, r1, r2])


def _td_mul(al, bl):
    """Triple-word multiply (xfloat.py:928-939)."""
    p00, e00 = two_prod(al[0], bl[0])
    p01, e01 = two_prod(al[0], bl[1])
    p10, e10 = two_prod(al[1], bl[0])
    o2 = ((al[0] * bl[2] + al[2] * bl[0]) + al[1] * bl[1]) + (e01 + e10)
    t1, t2 = two_sum(p01, p10)
    t1, t3 = two_sum(t1, e00)
    o2t = o2 + (t2 + t3)
    r0, u = two_sum(p00, t1)
    r1, r2 = two_sum(u, o2t)
    return _vec_sum([r0, r1, r2])


def _qw_add(al, bl):
    """Quad-word add (xfloat.py:942-959)."""
    s0, e0 = two_sum(al[0], bl[0])
    s1, e1 = two_sum(al[1], bl[1])
    s2, e2 = two_sum(al[2], bl[2])
    s3 = al[3] + bl[3]
    t1, f1 = two_sum(s1, e0)
    u2, f2 = two_sum(s2, e1)
    u2, f3 = two_sum(u2, f1)
    o3 = ((s3 + e2) + f2) + f3
    r0, a1 = two_sum(s0, t1)
    r1, a2 = two_sum(a1, u2)
    r2, r3 = two_sum(a2, o3)
    return _vec_sum([r0, r1, r2, r3])


def _qw_mul(al, bl):
    """Quad-word multiply (xfloat.py:962-990)."""
    p00, q00 = two_prod(al[0], bl[0])
    p01, q01 = two_prod(al[0], bl[1])
    p10, q10 = two_prod(al[1], bl[0])
    p02, q02 = two_prod(al[0], bl[2])
    p11, q11 = two_prod(al[1], bl[1])
    p20, q20 = two_prod(al[2], bl[0])
    o3 = ((al[0] * bl[3] + al[3] * bl[0])
          + (al[1] * bl[2] + al[2] * bl[1])
          + ((q02 + q11) + q20))
    t1, f1 = two_sum(p01, p10)
    t1, f2 = two_sum(t1, q00)
    u2, g1 = two_sum(p02, p11)
    u2, g2 = two_sum(u2, p20)
    u2, g3 = two_sum(u2, q01)
    u2, g4 = two_sum(u2, q10)
    u2, g5 = two_sum(u2, f1)
    u2, g6 = two_sum(u2, f2)
    o3 = o3 + (((g1 + g2) + (g3 + g4)) + (g5 + g6))
    r0, a1 = two_sum(p00, t1)
    r1, a2 = two_sum(a1, u2)
    r2, r3 = two_sum(a2, o3)
    return _vec_sum([r0, r1, r2, r3])


# Elementwise add/mul through K8, one launch per op, while on (off by
# default): the counterpart of the reference's elementwise-Pallas gate
# (xfloat.py:707-738) without its float32, TPU-backend, size and limb-count
# thresholds.  At k = 2 and k >= 5 K8 computes xf_add/xf_mul's own
# sequences; at k = 3 and 4 it runs the kernels' generic cascades instead of
# the triple- and quad-word sequences, as on the TPU.
_ELEMWISE_CUDA = False


@contextlib.contextmanager
def elemwise_cuda():
    """Send every xf_add/xf_mul through K8 for the duration of a
    with-block."""
    global _ELEMWISE_CUDA
    old = _ELEMWISE_CUDA
    _ELEMWISE_CUDA = True
    try:
        yield
    finally:
        _ELEMWISE_CUDA = old


_elemwise_xf = None  # ops/cuda_xf.elemwise_xf, bound at first use (cuda_xf imports this module)


def _elemwise_kernel(op: str, a: XF, b: XF) -> XF:
    """a op b through K8, which broadcasts the operands and zero-pads them
    to k = max(a.k, b.k) limbs in its loads (xfloat.py:732-738): one launch
    on CUDA tensors, the plain version on CPU ones."""
    global _elemwise_xf
    if _elemwise_xf is None:
        from clrs_tpu_torch.ops.cuda_xf import elemwise_xf as _elemwise_xf
    return XF(_elemwise_xf(op, a.limbs, b.limbs))


def xf_add(a: XF, b: XF) -> XF:
    """The reference's dispatch (xfloat.py:741-777): dd, triple-word and
    quad-word sequences at matching k = 2, 3, 4; otherwise the shorter
    operand is padded with exact zeros and the cascade adds k limbs."""
    a, b = _lift2(a, b)
    if _ELEMWISE_CUDA:
        return _elemwise_kernel("add", a, b)
    al, bl, k = _operands(a, b)
    if a.k == b.k == 2:
        return XF.from_limb_list(dd_add(al[0], al[1], bl[0], bl[1]))
    if a.k == b.k == 3:
        return XF.from_limb_list(_td_add(al, bl))
    if a.k == b.k == 4:
        return XF.from_limb_list(_qw_add(al, bl))
    zero = torch.zeros_like(al[0])
    al = al + [zero] * (k - len(al))
    bl = bl + [zero] * (k - len(bl))
    return XF.from_limb_list(cascade_add(al, bl, k))


def xf_mul(a: XF, b: XF) -> XF:
    """The reference's dispatch (xfloat.py:993-1014); mixed limb counts
    go through the cascade unpadded."""
    a, b = _lift2(a, b)
    if _ELEMWISE_CUDA:
        return _elemwise_kernel("mul", a, b)
    al, bl, k = _operands(a, b)
    if a.k == b.k == 2:
        return XF.from_limb_list(dd_mul(al[0], al[1], bl[0], bl[1]))
    if a.k == b.k == 3:
        return XF.from_limb_list(_td_mul(al, bl))
    if a.k == b.k == 4:
        return XF.from_limb_list(_qw_mul(al, bl))
    return XF.from_limb_list(cascade_mul(al, bl, k))


def xf_reciprocal(b: XF) -> XF:
    """Newton iteration for 1/b, doubling correct bits each step:
    ceil(log2 k) + 1 steps from the float64 seed."""
    k = b.k
    _check_k(k)
    x = XF.from_float(1.0 / b.limbs[0], k=k, dtype=b.dtype)
    n_iter = max(1, math.ceil(math.log2(k)) + 1)
    for _ in range(n_iter):
        # x <- x + x*(1 - b*x)
        e = xf_add(XF.ones(x.shape, k=k, dtype=b.dtype, device=b.device),
                   -xf_mul(b, x))
        x = xf_add(x, xf_mul(x, e))
    return x


def xf_div(a: XF, b: XF) -> XF:
    a, b = _lift2(a, b)
    r = xf_reciprocal(b)
    q = xf_mul(a, r)
    # one refinement step: q += (a - b*q) * r
    rres = xf_add(a, -xf_mul(b, q))
    return xf_add(q, xf_mul(rres, r))


def xf_sqrt(a: XF) -> XF:
    """sqrt via Newton on rsqrt; a must be >= 0 (0 allowed).  The seed is
    1/sqrt(hi), both correctly rounded in IEEE double on every device
    (``sqrt_rn``)."""
    k = a.k
    _check_k(k)
    dev = a.device
    safe_hi = torch.where(a.limbs[0] > 0, a.limbs[0], 1.0)
    x = XF.from_float(1.0 / sqrt_rn(safe_hi), k=k, dtype=a.dtype)
    n_iter = max(1, math.ceil(math.log2(k)) + 1)
    half = XF.from_float(0.5, k=k, dtype=a.dtype, device=dev)
    for _ in range(n_iter):
        # x <- x + 0.5*x*(1 - a*x*x)
        e = xf_add(XF.ones(x.shape, k=k, dtype=a.dtype, device=dev),
                   -xf_mul(a, xf_mul(x, x)))
        x = xf_add(x, xf_mul(half, xf_mul(x, e)))
    s = xf_mul(a, x)
    # refinement: s += (a - s*s) * x / 2
    e = xf_add(a, -xf_mul(s, s))
    s = xf_add(s, xf_mul(half, xf_mul(e, x)))
    is_zero = a.limbs[0] <= 0
    return xf_where(is_zero, XF.zeros(s.shape, k=k, dtype=a.dtype, device=dev), s)


def xf_is_neg(a: XF) -> torch.Tensor:
    """Sign from the leading nonzero limb (limbs are nonoverlapping)."""
    neg = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for i in range(a.k - 1, -1, -1):
        l = a.limbs[i]
        neg = torch.where(l != 0, l < 0, neg)
    return neg


def xf_abs(a: XF) -> XF:
    return xf_where(xf_is_neg(a), -a, a)


def xf_lt(a: XF, b: XF) -> torch.Tensor:
    return xf_is_neg(xf_add(a, -b))


def xf_where(cond, a: XF, b: XF) -> XF:
    a, b = _lift2(a, b)
    cond = torch.as_tensor(cond, device=a.device)
    shape = _broadcast_shape(tuple(cond.shape), a.shape, b.shape)
    al = a.broadcast_to(shape).limbs
    bl = b.broadcast_to(shape).limbs
    return XF(torch.where(torch.broadcast_to(cond, shape)[None], al, bl))


def xf_max(a: XF, b: XF) -> XF:
    return xf_where(xf_lt(a, b), b, a)


def xf_min(a: XF, b: XF) -> XF:
    return xf_where(xf_lt(a, b), a, b)


def pow2(e, device=None) -> torch.Tensor:
    """Exact 2^e (float64) for an int tensor e by exponent-bit
    construction; e is clamped to the normal range [-1022, 1023]."""
    e = torch.as_tensor(e, device=device)
    ec = torch.clamp(e.to(torch.int64), -1022, 1023)
    return ((ec + 1023) << 52).view(F64)


def xf_ldexp(a: XF, e) -> XF:
    """Exact scaling by 2^e (e int, scalar or broadcastable tensor)."""
    return XF(a.limbs * pow2(e, device=a.device))


# ---------------------------------------------------------------------------
# Reductions and contractions
# ---------------------------------------------------------------------------


def xf_sum(a: XF, axis: int = -1) -> XF:
    """Sum along an axis via the reference's binary tree of xf_adds: an odd
    length first folds its last element into its first, then the lower
    half is added to the upper half (xfloat.py:1300-1325)."""
    if axis < 0:
        axis = a.ndim + axis
    n = a.shape[axis]
    if n == 0:
        shape = a.shape[:axis] + a.shape[axis + 1:]
        return XF.zeros(shape, k=a.k, dtype=a.dtype, device=a.device)
    x = a.limbs
    laxis = axis + 1  # axis in limb space
    while n > 1:
        if n % 2 == 1:
            first = x.narrow(laxis, 0, 1)
            last = x.narrow(laxis, n - 1, 1)
            rest = x.narrow(laxis, 1, n - 2)
            folded = xf_add(XF(first), XF(last))
            x = torch.cat([folded.limbs, rest], dim=laxis)
            n = n - 1
        half = n // 2
        x = xf_add(XF(x.narrow(laxis, 0, half)),
                   XF(x.narrow(laxis, half, half))).limbs
        n = half
    return XF(x.squeeze(laxis))


def xf_dot(a: XF, b: XF) -> XF:
    """Inner product of flat vectors (or elementwise-matching tensors)."""
    p = xf_mul(a, b)
    return xf_sum(p.reshape((-1,)), axis=0)


def xf_matmul(a: XF, b: XF) -> XF:
    """(..., n, K) x (..., K, m): the (..., n, K, m) product tensor in full
    precision, tree-summed over K (xfloat.py:1335-1350)."""
    assert a.ndim >= 2 and b.ndim >= 2, (a.shape, b.shape)
    pa = XF(a.limbs[..., :, :, None])  # (..., n, K, 1)
    pb = XF(b.limbs[..., None, :, :])  # (..., 1, K, m)
    return xf_sum(xf_mul(pa, pb), axis=-2)


def xf_norm_max(a: XF) -> XF:
    """max(abs(entries)) over the whole tensor, by the reference's tree."""
    x = xf_abs(a).reshape((-1,))
    n = x.shape[0]
    while n > 1:
        if n % 2 == 1:
            first = x[0:1]
            last = x[n - 1:n]
            rest = x[1:n - 1]
            x = XF(torch.cat([xf_max(first, last).limbs, rest.limbs], dim=1))
            n -= 1
        half = n // 2
        x = xf_max(x[0:half], x[half:2 * half])
        n = half
    return x[0]


# ---------------------------------------------------------------------------
# Host conversion (mpmath interop for set-up and tests)
# ---------------------------------------------------------------------------


def xf_from_mp_np(values, k: int = 2) -> np.ndarray:
    """Round mpmath scalars / nested lists / object arrays to the nearest
    k-limb float64 expansion (each limb the correctly rounded remainder);
    returns the (k, *shape) numpy limb array."""
    import mpmath  # noqa: F401  (the values are mpmath numbers)

    arr = np.asarray(values, dtype=object)
    shape = arr.shape
    flat = arr.reshape(-1)
    limbs = np.zeros((k, flat.size), dtype=np.float64)
    min_normal = 2.0 ** -1022
    for idx, v in enumerate(flat):
        rem = v
        for i in range(k):
            li = np.float64(float(rem))
            if abs(float(li)) < min_normal:
                li = np.float64(0.0)
            limbs[i, idx] = li
            rem = rem - float(li)
    return limbs.reshape((k,) + shape)


def xf_from_mp(values, k: int = 2, *, device) -> XF:
    """XF of mpmath values on ``device`` (see xf_from_mp_np)."""
    return XF(torch.from_numpy(xf_from_mp_np(values, k)).to(device))


def xf_to_mp(a: XF):
    """Convert to a numpy object array of mpmath mpf (for oracles)."""
    import mpmath

    limbs = a.limbs.detach().cpu().numpy()
    flat = limbs.reshape(a.k, -1)
    out = np.empty(flat.shape[1], dtype=object)
    for idx in range(flat.shape[1]):
        s = mpmath.mpf(0)
        for i in range(a.k):
            s += mpmath.mpf(float(flat[i, idx]))
        out[idx] = s
    return out.reshape(a.shape)
