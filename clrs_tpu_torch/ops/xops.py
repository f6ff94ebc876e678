"""The kernels' own k-limb arithmetic on lists of limb tensors.

Plain PyTorch counterpart of ``clrs_tpu/ops/pallas_xf.py:_XOps`` (:60-345)
without its scaled mode: the arithmetic inside the k-limb Pallas kernels,
which the plain versions of K2, K4 and K5 (``ops/cuda_xf.py``) and K1's
halving sums (``ops/cuda_dd.py``) run, and which ``csrc/eft.cuh`` restates
operation for operation on the card.

It differs from ``ops/xfloat.py`` where the reference's kernels differ
from its XLA path: at k = 3 and 4 ``_XOps`` runs the generic cascades,
not the triple- and quad-word sequences; the reciprocal seed is taken on
a masked divisor; and sqrt halves with an exact scaling where
``xf_sqrt`` multiplies by 0.5 in k limbs.  At k=2 add and mul are the dd
sequences, as in ``_XOps``.  The sqrt seed is ``1.0 / sqrt_rn(x)``
(correctly rounded on every device) where the Pallas kernel takes
``rsqrt``.
"""

from __future__ import annotations

import math

import torch

from clrs_tpu_torch.ops.xfloat import cascade_add, cascade_mul, dd_add, dd_mul, sqrt_rn


def _newton_steps(k: int) -> int:
    return max(1, math.ceil(math.log2(k)) + 1)


def add(al, bl):
    """k-limb add of equal-length, equal-shape limb lists."""
    k = len(al)
    if k == 2:
        return list(dd_add(al[0], al[1], bl[0], bl[1]))
    return cascade_add(al, bl, k)


def mul(al, bl):
    """k-limb multiply; the operands' shapes broadcast."""
    k = len(al)
    if k == 2:
        return list(dd_mul(al[0], al[1], bl[0], bl[1]))
    return cascade_mul(al, bl, k)


def neg(al):
    return [-x for x in al]


def scale_half(al):
    """Exact limbwise scaling by 0.5."""
    return [0.5 * x for x in al]


def _ones_like(x, k: int):
    return [torch.ones_like(x)] + [torch.zeros_like(x)] * (k - 1)


def recip(bl):
    """1/b by Newton from the float64 seed of a masked divisor
    (_XOps.recip, pallas_xf.py:253-275)."""
    k = len(bl)
    safe = torch.where(bl[0] != 0, bl[0], torch.ones_like(bl[0]))
    ones = _ones_like(safe, k)
    x = [1.0 / safe] + [torch.zeros_like(safe)] * (k - 1)
    for _ in range(_newton_steps(k)):
        e = add(ones, neg(mul(bl, x)))
        x = add(x, mul(x, e))
    return x


def div(al, bl):
    """a / b with one refinement step (_XOps.div)."""
    r = recip(bl)
    q = mul(al, r)
    res = add(al, neg(mul(bl, q)))
    return add(q, mul(res, r))


def sqrt(al):
    """sqrt by rsqrt Newton plus one refinement (_XOps.sqrt); a >= 0, 0
    allowed."""
    k = len(al)
    pos = al[0] > 0
    zero = torch.zeros_like(al[0])
    safe = [torch.where(pos, al[0], torch.ones_like(al[0]))] + [
        torch.where(pos, x, zero) for x in al[1:]]
    ones = _ones_like(safe[0], k)
    x = [1.0 / sqrt_rn(safe[0])] + [zero] * (k - 1)
    for _ in range(_newton_steps(k)):
        e = add(ones, neg(mul(safe, mul(x, x))))
        x = add(x, scale_half(mul(x, e)))
    s = mul(safe, x)
    e = add(safe, neg(mul(s, s)))
    s = add(s, scale_half(mul(e, x)))
    return [torch.where(pos, si, zero) for si in s]


def sum_axis(limbs, axis: int):
    """Sum along an axis by the zero-padded halving tree (_XOps.sum_axis):
    pad to the next power of two, then add the upper half onto the lower
    half level by level."""
    axis = axis % limbs[0].ndim
    m = limbs[0].shape[axis]
    np2 = 1
    while np2 < m:
        np2 *= 2
    if np2 != m:
        shape = list(limbs[0].shape)
        shape[axis] = np2 - m
        z = torch.zeros(shape, dtype=limbs[0].dtype, device=limbs[0].device)
        limbs = [torch.cat([x, z], dim=axis) for x in limbs]
    while np2 > 1:
        half = np2 // 2
        limbs = add([x.narrow(axis, 0, half) for x in limbs],
                    [x.narrow(axis, half, half) for x in limbs])
        np2 = half
    return [x.squeeze(axis) for x in limbs]
