"""Double-double kernels K0 and K1: the dd device functions and the
batched SPD inverse, each beside its plain PyTorch version, and the launch
of ``csrc/spd_inverse_xf.cu``, the SPD inverse at every k (K1 and K5).

K0 is ``csrc/eft.cuh``: the dd sequences of ``ops/pallas_dd.py:_Ops``
(two_sum, fast_two_sum, split, two_prod, add, mul, div, sqrt and the
zero-padded halving sum).  Its plain versions are ``xops.sum_axis`` and,
from ops/xfloat.py, ``dd_add``/``dd_mul`` and ``xf_div``/``xf_sqrt`` at
k=2 (the ``_Ops`` div and sqrt sequences are theirs).

K1 (replaces ``pallas_dd._spd_inverse_kernel``) is the K=2 instance of
``csrc/spd_inverse_xf.cu``, whose K >= 3 instances are K5: at k=2 that
kernel's adds, multiplies, divs and square roots are the dd sequences, in
K1's order.  ``dd_spd_inverse`` is its wrapper: a CPU tensor takes the
plain version ``dd_spd_inverse_torch``; a CUDA tensor launches the kernel
(and counts the launch in ``dd_spd_inverse.launches``) or raises.  The
plain version follows the Pallas kernel's algorithm, halving trees
included, so it differs from ``ops/linalg.xf_spd_inverse`` (which sums
with ``xf_sum``'s odd-fold tree and solves L^T x = W instead of forming
W^T W) in the low limbs; it is bitwise K5's plain version
(``cuda_xf.spd_inverse_xf_torch``) at k=2.  ``spd_inverse_launch`` runs the
kernel for K1's and K5's wrappers and for ``cuda_xf.xf_spd_inverse_batched``
(the solver's stacked layout), on operands read in place.

K9 is ``csrc/spd_inverse_dd_wide.cu`` (replaces
``pallas_dd._spd_inverse_wide_kernel``): K1's function, bit for bit, for
many small matrices at once, a team of warps per matrix and several
matrices per thread block, the input read in place at any strides (the
reference's batch-minor (2, n, n, B) layout as a view included).
``dd_spd_inverse_wide`` is its wrapper; like the reference's, no solver
route calls it.
"""

from __future__ import annotations

import struct
from typing import Tuple

import torch

from clrs_tpu_torch.ops import _build, xops
from clrs_tpu_torch.ops.xfloat import F64, XF, dd_add, dd_mul, xf_div, xf_sqrt


def _dd_div(ah, al, bh, bl):
    return tuple(xf_div(XF(torch.stack([ah, al])), XF(torch.stack([bh, bl]))).limbs)


# ---------------------------------------------------------------------------
# K1: batched dd SPD inverse
# ---------------------------------------------------------------------------


def dd_spd_inverse_torch(limbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: limbs (B, 2, n, n) -> (inv (B, 2, n, n),
    ok (B,)).  Per block: Cholesky by columns, W = L^-1 by rows,
    A^-1 = W^T W by sequential rank-1 accumulation."""
    B, two, n, _ = limbs.shape
    assert two == 2
    dev = limbs.device
    Ah, Al = limbs[:, 0], limbs[:, 1]
    Lh = torch.zeros((B, n, n), dtype=F64, device=dev)
    Ll = torch.zeros_like(Lh)
    okf = torch.ones((B, n), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    for j in range(n):
        # s = A[:, j] - L @ L[j, :]
        ph, pl = dd_mul(Lh, Ll, Lh[:, j:j + 1, :], Ll[:, j:j + 1, :])
        acch, accl = xops.sum_axis([ph, pl], axis=-1)
        sh, sl = dd_add(Ah[:, :, j], Al[:, :, j], -acch, -accl)  # (B, n)
        djh, djl = sh[:, j], sl[:, j]
        pos = djh > 0
        okf[:, j] = pos
        ljh, ljl = xf_sqrt(XF(torch.stack([torch.where(pos, djh, 1.0),
                                           torch.where(pos, djl, 0.0)]))).limbs
        ch, cl = _dd_div(sh, sl, ljh[:, None], ljl[:, None])
        at, below = rows == j, rows > j
        Lh[:, :, j] = torch.where(at, ljh[:, None], torch.where(below, ch, 0.0))
        Ll[:, :, j] = torch.where(at, ljl[:, None], torch.where(below, cl, 0.0))
    # W = L^-1 by forward substitution, one row at a time
    Wh = torch.zeros_like(Lh)
    Wl = torch.zeros_like(Lh)
    for i in range(n):
        ph, pl = dd_mul(Lh[:, i, :, None], Ll[:, i, :, None], Wh, Wl)
        acch, accl = xops.sum_axis([ph, pl], axis=-2)  # (B, n) over t
        ei = (rows == i).to(F64).expand(B, n)
        nh, nl = dd_add(ei, torch.zeros_like(ei), -acch, -accl)
        qh, ql = _dd_div(nh, nl, Lh[:, i, i, None], Ll[:, i, i, None])
        Wh[:, i, :] = qh
        Wl[:, i, :] = ql
    # inv = W^T W
    acch = torch.zeros_like(Lh)
    accl = torch.zeros_like(Lh)
    for t in range(n):
        rh, rl = Wh[:, t, :], Wl[:, t, :]
        ph, pl = dd_mul(rh[:, :, None], rl[:, :, None], rh[:, None, :], rl[:, None, :])
        acch, accl = dd_add(acch, accl, ph, pl)
    return torch.stack([acch, accl], dim=1), torch.all(okf, dim=1)


def max_rows(k: int) -> int:
    """The largest n that K1, K5 and K7 take at k limbs (csrc/chol_xf.cuh:
    kMaxRows): 1024 at k=2, 256 above, where a thread takes up to 255
    registers at k = 10..12 and a block holds 256 threads."""
    return 1024 if k == 2 else 256


def _spd_inverse_plan(x: torch.Tensor, limb_axis: int):
    """The description csrc/spd_inverse_xf.cu's C entry takes for the SPD
    inverse of x, four axes (limbs, batch, n, n) or (batch, limbs, n, n) as
    limb_axis is 0 or 1, read in place at its strides, the output written
    dense in x's axis order; and (k, B, n).  Raises on what the kernel does
    not take."""
    if x.dtype != F64 or x.ndim != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"spd_inverse: need 4-axis float64 limbs ending (n, n), got "
                         f"{tuple(x.shape)} {x.dtype}")
    k, B, n = x.shape[limb_axis], x.shape[1 - limb_axis], x.shape[2]
    if n > max_rows(k):
        raise ValueError(f"spd_inverse: n={n} > {max_rows(k)} rows at k={k}")
    st = x.stride()
    o_ls, o_bs = (B * n * n, n * n) if limb_axis == 0 else (n * n, k * n * n)
    desc = struct.pack("<9q", k, B, n, st[limb_axis], st[1 - limb_axis], st[2], st[3],
                       o_ls, o_bs)
    return desc, k, B, n


_spd_inverse_plans = {}


def spd_inverse_launch(wrapper, x: torch.Tensor, limb_axis: int):
    """One launch of csrc/spd_inverse_xf.cu on the CUDA limbs x (axes as
    _spd_inverse_plan), counted in wrapper.launches -> (inverse, dense in
    x's axis order, ok (B,)).  The description is computed once for each
    layout and kept."""
    key = (x.shape, x.stride(), limb_axis, x.dtype, x.get_device())
    desc, k, B, n = _build.cached_plan(_spd_inverse_plans, key, _spd_inverse_plan, x,
                                       limb_axis)
    out = x.new_empty(x.shape)
    okf = x.new_empty((B, n))
    if B and n:
        scratch = x.new_empty((B * k * (2 * n * n + n),))
        rc = _build.library().clrs_spd_inverse_xf(desc, x.data_ptr(), out.data_ptr(),
                                                  okf.data_ptr(), scratch.data_ptr(),
                                                  _build.stream(x))
        if rc:
            _build.check(rc, "clrs_spd_inverse_xf", k)
        wrapper.launches += 1
    return out, torch.all(okf > 0.5, dim=1)


def dd_spd_inverse(limbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper: limbs (B, 2, n, n) float64, n <= 1024, any strides ->
    (inv (B, 2, n, n), ok (B,)).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel on limbs where they lie."""
    if limbs.device.type == "cpu":
        return dd_spd_inverse_torch(limbs)
    if limbs.device.type != "cuda":
        raise ValueError(f"dd_spd_inverse: unsupported device {limbs.device}")
    if limbs.ndim != 4 or limbs.shape[1] != 2:
        raise ValueError(f"dd_spd_inverse: need (B, 2, n, n), got {tuple(limbs.shape)}")
    return spd_inverse_launch(dd_spd_inverse, limbs, 1)


dd_spd_inverse.launches = 0


# ---------------------------------------------------------------------------
# K9: batched dd SPD inverse, batch-minor layout
# ---------------------------------------------------------------------------


def dd_spd_inverse_wide_torch(limbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: limbs (B, 2, n, n) -> (inv (B, 2, n, n), ok
    (B,)).  K9 runs K1's sequences on each matrix, so this is K1's plain
    version."""
    return dd_spd_inverse_torch(limbs)


WIDE_MAX_ROWS = 512  # csrc/spd_inverse_dd_wide.cu: kMaxRows
WIDE_LANE_TERMS = 16  # kLaneTerms: the terms of a dot product a lane holds at most
WIDE_MAX_THREADS = 256  # kMaxThreads
WIDE_PAIR_SHARED = 115712  # shared memory of a block that leaves two blocks an SM
WIDE_MAX_SHARED = 232448  # kMaxShared: an H100 block's dynamic shared memory
WIDE_CARD_THREADS = 132 * 2048  # the threads an H100 holds at once


def _wide_plan(x: torch.Tensor):
    """The description csrc/spd_inverse_dd_wide.cu's C entry takes for K9
    on x (B, 2, n, n), read in place at its strides, and (B, n, the
    float64 scratch it needs).  A matrix takes a team of threads, a group
    of G lanes per row (per column in the solve) in whole warps up to 256
    threads: G the widest power of two that fills the team, at most 32 and
    np2 (the power of two >= n), at least np2 / 16 (16 terms a lane), and
    halved while the batch's teams would not fit on the card at once, so
    that a lone small matrix takes short dot products and a wide batch
    idles fewer lanes.  L (packed) and W (transposed, column stride ldw = 1
    mod 8) live in shared memory while one matrix fits in a block, and as
    many matrices share a block as fit in 256 threads and leave two blocks
    an SM; above that in global scratch.  Raises on what the kernel does
    not take."""
    if x.dtype != F64 or x.ndim != 4 or x.shape[1] != 2 or x.shape[2] != x.shape[3]:
        raise ValueError(f"dd_spd_inverse_wide: need (B, 2, n, n) float64, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, _, n, _ = x.shape
    if n > WIDE_MAX_ROWS:
        raise ValueError(f"dd_spd_inverse_wide: n={n} > {WIDE_MAX_ROWS}")
    np2 = 1 << max(n - 1, 0).bit_length()
    least = max(1, np2 // WIDE_LANE_TERMS)

    def team(G):
        return min(WIDE_MAX_THREADS, max(32, -(-n * G // 32) * 32))

    G = max(least, min(np2, 32, 1 << max(WIDE_MAX_THREADS // max(n, 1), 1).bit_length() - 1))
    while G > least and B * team(G) > WIDE_CARD_THREADS:
        G //= 2
    ldw = -(-n // 8) * 8 + 1
    lw = n * (n + 1) // 2 + n * ldw  # double2 slots of L and W
    in_shared = 16 * (lw + 2 * n + 1) <= WIDE_MAX_SHARED
    per_team = 16 * ((lw if in_shared else 0) + 2 * n + 1)
    teams = max(1, min(WIDE_MAX_THREADS // team(G), WIDE_PAIR_SHARED // per_team, B))
    st = x.stride()
    desc = struct.pack("<11q", B, n, st[0], st[1], st[2], st[3], team(G), teams,
                       int(in_shared), ldw, G)
    return desc, B, n, 0 if in_shared else 2 * B * lw


_wide_plans = {}


def dd_spd_inverse_wide(limbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 wrapper: limbs (B, 2, n, n) float64, n <= 512, any strides (the
    batch-minor view ``x.permute(3, 0, 1, 2)`` of a (2, n, n, B) array
    included) -> (inv (B, 2, n, n) dense, ok (B,)), bit for bit K1's.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on limbs where they lie, the description computed once for each
    layout and kept."""
    if limbs.device.type == "cpu":
        return dd_spd_inverse_wide_torch(limbs)
    if limbs.device.type != "cuda":
        raise ValueError(f"dd_spd_inverse_wide: unsupported device {limbs.device}")
    key = (limbs.shape, limbs.stride(), limbs.dtype, limbs.get_device())
    desc, B, n, scratch_len = _build.cached_plan(_wide_plans, key, _wide_plan, limbs)
    out = limbs.new_empty((B, 2, n, n))
    okf = limbs.new_empty((B,))
    if B and n:
        scratch = limbs.new_empty((scratch_len,)) if scratch_len else None
        rc = _build.library().clrs_spd_inverse_dd_wide(
            desc, limbs.data_ptr(), out.data_ptr(), okf.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, _build.stream(limbs))
        if rc:
            _build.check(rc, "clrs_spd_inverse_dd_wide")
        dd_spd_inverse_wide.launches += 1
    return out, okf > 0.5


dd_spd_inverse_wide.launches = 0
