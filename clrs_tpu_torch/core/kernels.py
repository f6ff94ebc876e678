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

``use_cuda`` routes the products through the hand-written kernels:
every matmul of ``_mm`` through K3 (k=2) or K4 (k >= 3), and each Schur
block through one launch of K2 at the problem's k.  On a CPU tensor the
kernels' plain versions run instead.
"""

from __future__ import annotations

from typing import List

import torch

from clrs_tpu_torch.core.blockinfo import pair_list
from clrs_tpu_torch.ops.cuda_xf import schur_pairs, xf_matmul_k
from clrs_tpu_torch.ops.xfloat import XF, xf_add, xf_matmul, xf_mul, xf_sum


def _mm(a: XF, b: XF, use_cuda: bool) -> XF:
    """Matmul dispatch: K3 or K4 (sequential accumulation) under use_cuda,
    else the expansion matmul's product tree."""
    if use_cuda:
        return xf_matmul_k(a, b)
    return xf_matmul(a, b)


def _perm(nb: int, *axes) -> tuple:
    """Value-axis permutation of the trailing axes behind nb batch axes."""
    return tuple(range(nb)) + tuple(nb + a for a in axes)


def compute_pairings(Z: XF, V: XF, m: int, use_cuda: bool = False) -> XF:
    """P[r, t1, s, t2] = V[:,t1]^T Z[r·δ:(r+1)δ, s·δ:(s+1)δ] V[:,t2].
    Z: (..., m*delta, m*delta), V: (..., delta, T) -> (..., m, T, m, T)."""
    bs = Z.shape[:-2]
    nb = len(bs)
    delta, T = V.shape[-2:]
    # ZV[r, d, s, t2] = sum_e Z[r,d,s,e] V[e,t2]
    Zflat = Z.reshape(bs + (m * delta * m, delta))
    ZV = _mm(Zflat, V, use_cuda).reshape(bs + (m, delta, m, T))
    # P[r, t1, s, t2] = sum_d V[d, t1] ZV[r, d, s, t2]
    ZVt = ZV.transpose(_perm(nb, 1, 0, 2, 3)).reshape(bs + (delta, m * m * T))
    P = _mm(V.mT, ZVt, use_cuda).reshape(bs + (T, m, m, T))
    return P.transpose(_perm(nb, 1, 0, 2, 3))


def pairing_diag(P: XF, m: int) -> XF:
    """A_Y[r, s, t] = P[r, t, s, t] — the diagonal pairings kept for the
    fast Tr(A_* Y) path."""
    nd = P.limbs.ndim
    return XF(torch.diagonal(P.limbs, dim1=nd - 3, dim2=nd - 1))


def _schur_block_contribution_cuda(PX: XF, PY: XF, HH: XF, m: int, K: int,
                                   rmax: int) -> XF:
    """Kernel-routed Schur block: K2 forms every (pair, t1, pair, t2) entry
    in one launch, reading PX, PY and HH where they lie, then the exact
    rank segment-sum on its layout (t2's rank slots first, then t1's, the
    adds of the reference's, kernels.py:150-155); at rmax = 1 the sums add
    nothing and the block is a reshape of K2's output."""
    W = XF(schur_pairs(PX.limbs, PY.limbs, HH.limbs))  # (k, *bs, P, T, P, T)
    bs, P = W.shape[:-4], W.shape[-4]
    W = W.reshape(bs + (P, K, rmax, P, K, rmax))
    blk = xf_sum(xf_sum(W, axis=-1), axis=-3)  # (..., P, K, P, K)
    return blk.reshape(bs + (P * K, P * K))


def schur_block_contribution(
    PX: XF, PY: XF, H: XF, m: int, K: int, rmax: int, use_cuda: bool = False
) -> XF:
    """Contribution of one (j, l) block to the Schur complement S_j: for
    tuples i1=(r1,s1,k1), i2=(r2,s2,k2),

      S[i1, i2] += sum_{rnk1, rnk2} H[t1] H[t2] / 4 * (
          PX[s1,t1,r2,t2]·PY[s2,t2,r1,t1] + PX[r1,t1,r2,t2]·PY[s2,t2,s1,t1]
        + PX[s1,t1,s2,t2]·PY[r2,t2,r1,t1] + PX[r1,t1,s2,t2]·PY[r2,t2,s1,t1])

    Returns (..., npairs*K, npairs*K)."""
    pairs = pair_list(m)
    HH = xf_mul(XF(H.limbs[..., :, None]), XF(H.limbs[..., None, :]))  # (T, T)
    HH = XF(HH.limbs * 0.25)
    if use_cuda:
        return _schur_block_contribution_cuda(PX, PY, HH, m, K, rmax)

    bs = PX.shape[:-4]
    rows: List[XF] = []
    for (r1, s1) in pairs:
        cols: List[XF] = []
        for (r2, s2) in pairs:
            a1 = PX[..., s1, :, r2, :]
            b1 = PY[..., s2, :, r1, :].mT  # [t2, t1] -> [t1, t2]
            a2 = PX[..., r1, :, r2, :]
            b2 = PY[..., s2, :, s1, :].mT
            a3 = PX[..., s1, :, s2, :]
            b3 = PY[..., r2, :, r1, :].mT
            a4 = PX[..., r1, :, s2, :]
            b4 = PY[..., r2, :, s1, :].mT
            w = xf_add(
                xf_add(xf_mul(a1, b1), xf_mul(a2, b2)),
                xf_add(xf_mul(a3, b3), xf_mul(a4, b4)),
            )
            w = xf_mul(w, HH)  # (T, T)
            # segment-sum the rank slots: (K, rmax, K, rmax) -> (K, K)
            w4 = w.reshape(bs + (K, rmax, K, rmax))
            cols.append(xf_sum(xf_sum(w4, axis=-1), axis=-2))
        rows.append(XF(torch.cat([c.limbs for c in cols], dim=-1)))
    return XF(torch.cat([r.limbs for r in rows], dim=-2))


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
    Z: XF, V: XF, H: XF, m: int, K: int, rmax: int, use_cuda: bool = False
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
        M = _mm(Zrs, V, use_cuda)  # (delta, T)
        D = xf_sum(xf_mul(V, M), axis=-2)  # (T,)
        w = xf_mul(D, H).reshape(bs + (K, rmax))
        out.append(xf_sum(w, axis=-1))
    return XF(torch.cat([o.limbs for o in out], dim=-1))


def weighted_A_block(
    a_j: XF, V: XF, H: XF, m: int, K: int, rmax: int, use_cuda: bool = False
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
        W = _mm(U, V.mT, use_cuda)  # (delta, delta) = V diag(w) V^T
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
