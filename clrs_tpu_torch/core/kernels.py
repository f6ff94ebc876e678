"""Batched IPM compute kernels: bilinear pairings, Schur assembly,
constraint traces, weighted constraint sums (torch).

Counterpart of ``clrs_tpu/core/kernels.py``.  Every function takes an
optional leading batch of clusters (the reference ``jax.vmap``s them) and
performs the reference's operations per cluster.

Index conventions (per cluster j, inner block l):
  delta  = length of each low-rank vector
  T      = n_samples * rmax  (padded vector count), t = k*rmax + rnk
  V      = (delta, T) XF of vectors; H = (T,) XF of weights (0 in padding)
  PSD block Z is (m*delta, m*delta), viewed as (m, delta, m, delta)
  pairing tensor P_Z[r, t1, s, t2] = v_{t1}^T Z[r, s] v_{t2}, (m, T, m, T)
  tuple index within the cluster: idx = pair_index(r, s)*K + k

The pairing, weighted-A and trace-A products take their matmul ``mm``
as an argument, chosen once by ``matmul_route``: K3 (k=2) or K4 (k >=
3), the int8-sliced product (ops/mxu_matmul.py, the reference's
``use_mxu=True``) or the expansion matmul.  ``use_cuda`` forms each Schur
block by one launch of K2 at the problem's k.  On a CPU tensor the
kernels' plain versions run instead.
"""

from __future__ import annotations

from typing import List

import torch

from clrs_tpu_torch.core.blockinfo import pair_list
from clrs_tpu_torch.ops.cuda_xf import schur_pairs, xf_matmul_k
from clrs_tpu_torch.ops.mxu_matmul import xf_matmul_mxu
from clrs_tpu_torch.ops.xfloat import XF, xf_add, xf_matmul, xf_mul, xf_sum


def matmul_route(use_cuda: bool, use_mxu: bool = False):
    """The matmul of the pairing, weighted-A and trace-A products: K3 or K4
    (sequential accumulation) under use_cuda, else the int8-sliced product
    (ops/mxu_matmul.py) under use_mxu, else the expansion matmul's product
    tree.  The kernels come first, as the reference's "pallas" beats its
    MXU route (solver.py:172-179); the MXU route takes each 2-D product of
    a batch as the reference takes one under its per-cluster vmap."""
    if use_cuda:
        return xf_matmul_k
    if use_mxu:
        return xf_matmul_mxu
    return xf_matmul


def _band(plan, n: int):
    """This rank's rows of an axis of n under an intra plan
    (parallel/intra.IntraPlan), None where the axis is not split."""
    return None if plan is None else plan.band(n)


def _perm(nb: int, *axes) -> tuple:
    """Value-axis permutation of the trailing axes behind nb batch axes."""
    return tuple(range(nb)) + tuple(nb + a for a in axes)


def compute_pairings(Z: XF, V: XF, m: int, mm=xf_matmul, plan=None) -> XF:
    """P[r, t1, s, t2] = V[:,t1]^T Z[r·δ:(r+1)δ, s·δ:(s+1)δ] V[:,t2].
    Z: (..., m*delta, m*delta), V: (..., delta, T) -> (..., m, T, m, T).
    Under an intra plan (parallel/intra.IntraPlan) whose world divides T,
    each rank forms its band of ZV's columns t2 and of P's rows t1, and
    the bands are gathered in rank order after each product."""
    bs = Z.shape[:-2]
    nb = len(bs)
    delta, T = V.shape[-2:]
    band = _band(plan, T)
    # ZV[r, d, s, t2] = sum_e Z[r,d,s,e] V[e,t2]
    Zflat = Z.reshape(bs + (m * delta * m, delta))
    if band is None:
        ZV = mm(Zflat, V)
    else:
        ZV = XF(plan.gather(mm(Zflat, V[..., band]).limbs, -1))
    ZV = ZV.reshape(bs + (m, delta, m, T))
    # P[r, t1, s, t2] = sum_d V[d, t1] ZV[r, d, s, t2]
    ZVt = ZV.transpose(_perm(nb, 1, 0, 2, 3)).reshape(bs + (delta, m * m * T))
    if band is None:
        P = mm(V.mT, ZVt)
    else:
        P = XF(plan.gather(mm(V.mT[..., band, :], ZVt).limbs, -2))
    P = P.reshape(bs + (T, m, m, T))
    return P.transpose(_perm(nb, 1, 0, 2, 3))


def pairing_diag(P: XF, m: int) -> XF:
    """A_Y[r, s, t] = P[r, t, s, t] — the diagonal pairings kept for the
    fast Tr(A_* Y) path."""
    nd = P.limbs.ndim
    return XF(torch.diagonal(P.limbs, dim1=nd - 3, dim2=nd - 1))


def _schur_block_contribution_cuda(PX: XF, PY: XF, HH: XF, m: int, K: int,
                                   rmax: int, plan=None) -> XF:
    """Kernel-routed Schur block: K2 forms every (pair, t1, pair, t2) entry
    in one launch, reading PX, PY and HH where they lie (under a plan, the
    views of this rank's rows t1), then the exact rank segment-sum on its
    layout (_rank_sums)."""
    band = _band(plan, PX.shape[-1]) or slice(None)
    W = XF(schur_pairs(PX.limbs[..., band, :, :], PY.limbs[..., band],
                       HH.limbs[..., band, :]))  # (k, *bs, P, Tb, P, T)
    return _rank_sums(W, K, rmax, plan)


def _rank_sums(W: XF, K: int, rmax: int, plan) -> XF:
    """W (..., P, Tb, P, T), the entries of rows t1 before the rank sums ->
    (..., P K, P K): t2's rank slots summed first, then t1's, the adds of
    the reference's (kernels.py:150-155), exact; where a plan splits T =
    K rmax the rows are this rank's band, gathered between the two sums.
    At rmax = 1 the sums add nothing and the block is a reshape."""
    bs, P, Tb = W.shape[:-4], W.shape[-4], W.shape[-3]
    W = xf_sum(W.reshape(bs + (P, Tb, P, K, rmax)), axis=-1)  # (..., P, Tb, P, K)
    if _band(plan, K * rmax) is not None:
        W = XF(plan.gather(W.limbs, -3))
    blk = xf_sum(W.reshape(bs + (P, K, rmax, P, K)), axis=-3)  # (..., P, K, P, K)
    return blk.reshape(bs + (P * K, P * K))


def _schur_block_contribution_plain(PX: XF, PY: XF, HH: XF, m: int, K: int,
                                    rmax: int, plan=None) -> XF:
    """The Schur block by the reference's products (kernels.py:161-220),
    w[i1, t1, i2, t2] for the rows t1 of this rank's band (all without a
    plan), then _rank_sums."""
    band = _band(plan, PX.shape[-1]) or slice(None)
    pairs = pair_list(m)
    rows: List[XF] = []
    for (r1, s1) in pairs:
        cols: List[XF] = []
        for (r2, s2) in pairs:
            a1 = PX[..., s1, band, r2, :]
            b1 = PY[..., s2, :, r1, band].mT  # [t2, t1] -> [t1, t2]
            a2 = PX[..., r1, band, r2, :]
            b2 = PY[..., s2, :, s1, band].mT
            a3 = PX[..., s1, band, s2, :]
            b3 = PY[..., r2, :, r1, band].mT
            a4 = PX[..., r1, band, s2, :]
            b4 = PY[..., r2, :, s1, band].mT
            w = xf_add(
                xf_add(xf_mul(a1, b1), xf_mul(a2, b2)),
                xf_add(xf_mul(a3, b3), xf_mul(a4, b4)),
            )
            cols.append(xf_mul(w, HH[..., band, :]))  # (Tb, T)
        rows.append(XF(torch.stack([c.limbs for c in cols], dim=-2)))  # (Tb, P, T)
    W = XF(torch.stack([r.limbs for r in rows], dim=-4))  # (P, Tb, P, T)
    return _rank_sums(W, K, rmax, plan)


def schur_block_contribution(
    PX: XF, PY: XF, H: XF, m: int, K: int, rmax: int, use_cuda: bool = False,
    plan=None,
) -> XF:
    """Contribution of one (j, l) block to the Schur complement S_j: for
    tuples i1=(r1,s1,k1), i2=(r2,s2,k2),

      S[i1, i2] += sum_{rnk1, rnk2} H[t1] H[t2] / 4 * (
          PX[s1,t1,r2,t2]·PY[s2,t2,r1,t1] + PX[r1,t1,r2,t2]·PY[s2,t2,s1,t1]
        + PX[s1,t1,s2,t2]·PY[r2,t2,r1,t1] + PX[r1,t1,s2,t2]·PY[r2,t2,s1,t1])

    Returns (..., npairs*K, npairs*K); use_cuda forms the entries by one
    K2 launch.  Under an intra plan whose world divides T each rank forms
    the rows t1 of its band and sums their t2 slots, and t1's sum runs
    after the gather (_rank_sums)."""
    HH = xf_mul(XF(H.limbs[..., :, None]), XF(H.limbs[..., None, :]))  # (T, T)
    HH = XF(HH.limbs * 0.25)
    route = _schur_block_contribution_cuda if use_cuda else _schur_block_contribution_plain
    return route(PX, PY, HH, m, K, rmax, plan)


def trace_A_from_diag(A_Y: XF, H: XF, m: int, K: int, rmax: int) -> XF:
    """Fast path Tr(A_i Y) from precomputed diagonal pairings.
    A_Y: (..., m, m, T) -> (..., npairs*K) in tuple order."""
    bs = A_Y.shape[:-3]
    out: List[XF] = []
    for (r, s) in pair_list(m):
        w = xf_mul(A_Y[..., r, s, :], H)  # (T,)
        out.append(xf_sum(w.reshape(bs + (K, rmax)), axis=-1))  # (K,)
    return XF(torch.cat([o.limbs for o in out], dim=-1))


def trace_A_generic(
    Z: XF, V: XF, H: XF, m: int, K: int, rmax: int, mm=xf_matmul
) -> XF:
    """Tr(A_i Z) for a generic symmetric block Z, via
    D[t] = sum_d V[d,t] * (Z[r,s] V)[d,t].  Z: (..., m*delta, m*delta)
    -> (..., npairs*K)."""
    bs = Z.shape[:-2]
    delta, T = V.shape[-2:]
    Zb = Z.reshape(bs + (m, delta, m, delta))
    out: List[XF] = []
    for (r, s) in pair_list(m):
        Zrs = Zb[..., r, :, s, :]  # (delta, delta)
        M = mm(Zrs, V)  # (delta, T)
        D = xf_sum(xf_mul(V, M), axis=-2)  # (T,)
        w = xf_mul(D, H).reshape(bs + (K, rmax))
        out.append(xf_sum(w, axis=-1))
    return XF(torch.cat([o.limbs for o in out], dim=-1))


def weighted_A_block(
    a_j: XF, V: XF, H: XF, m: int, K: int, rmax: int, mm=xf_matmul
) -> XF:
    """sum_i a_i A_i restricted to one (j, l) PSD block: a_j (...,
    npairs*K) -> (..., m*delta, m*delta), off-diagonal (r,s) blocks halved
    (the Sym(E_rs) factor) and symmetrized."""
    bs = V.shape[:-2]
    delta, T = V.shape[-2:]
    zero = XF.zeros(bs + (delta, delta), k=V.k, dtype=V.dtype, device=V.device)
    blocks = [[None for _ in range(m)] for _ in range(m)]
    for p, (r, s) in enumerate(pair_list(m)):
        a_rs = a_j[..., p * K:(p + 1) * K]  # (K,)
        a_t = XF(torch.repeat_interleave(a_rs.limbs, rmax, dim=-1))  # (T,)
        w = xf_mul(a_t, H)  # (T,)
        U = xf_mul(V, XF(w.limbs[..., None, :]))  # (delta, T) scaled columns
        W = mm(U, V.mT)  # (delta, delta) = V diag(w) V^T
        if r == s:
            blocks[r][s] = W
        else:
            Wh = XF(W.limbs * 0.5)
            blocks[r][s] = Wh
            blocks[s][r] = Wh.mT
    rows = [
        XF(torch.cat([(zero if blocks[r][s] is None else blocks[r][s]).limbs
                      for s in range(m)], dim=-1))
        for r in range(m)
    ]
    return XF(torch.cat([r.limbs for r in rows], dim=-2))
