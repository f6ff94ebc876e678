"""Numerical problem data for the clustered low-rank SDP (torch).

Counterpart of ``clrs_tpu/core/problem.py``.  Per cluster j the ragged
[l, k][rnk] constraint data becomes, per (j, l), two padded XF tensors:
  V: (delta, T)  columns = vectors, T = n_samples * rmax, column index
                 t = k * rmax + rnk
  H: (T,)        weights, 0.0 in padding slots (exact no-op everywhere)
plus XF B (dim_S, n_y) and c (dim_S, 1).  ``prepare_pack_data`` is the
reference's exact (mpmath object-level) packing and preconditioning,
copied unchanged; ``_pack_from_data`` rounds it to k float64 limbs on
an explicit device.  As in the reference, the packing rounds at the
ambient mpmath precision: ``xf_from_mp``'s remainders are computed at
``mpmath.mp.prec``, so at 53 bits the limbs past the first come out zero.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clrs_tpu_torch.core.blockinfo import BlockInfo, get_block_info
from clrs_tpu_torch.ops.xfloat import XF, xf_add, xf_dot, xf_from_mp


def _xf_to(x, device):
    return None if x is None else x.to(device)


@dataclass
class ClusterData:
    """Numerical data of one constraint cluster."""

    Vs: Tuple[XF, ...]  # per l: (delta_l, K*rmax_l)
    Hs: Tuple[XF, ...]  # per l: (K*rmax_l,)
    B: XF  # (dim_S, n_y)
    c: XF  # (dim_S, 1)

    def to(self, device) -> "ClusterData":
        return ClusterData(
            tuple(v.to(device) for v in self.Vs),
            tuple(h.to(device) for h in self.Hs),
            self.B.to(device),
            self.c.to(device),
        )


@dataclass
class SDPProblem:
    """The full clustered SDP: clusters + objective, with its BlockInfo."""

    clusters: Tuple[ClusterData, ...]
    b: XF  # (n_y, 1) objective vector
    C_blocks: Optional[Any]  # block-diag cost matrix or None (AbsoluteZero)
    b0: XF  # scalar constant objective offset
    info: BlockInfo
    x_sigma: Optional[XF] = None  # x_user = x_internal / x_sigma
    y_R_inv: Optional[XF] = None  # y_user = y_R_inv @ y_internal
    y_R: Optional[XF] = None  # inverse transform for warm starts
    # parallel/intra.IntraPlan: this rank's share of the work inside each
    # cluster (parallel/intra.shard_problem); None runs it all here
    plan: Optional[Any] = None

    @property
    def device(self):
        return self.b.device

    def to(self, device) -> "SDPProblem":
        C = None
        if self.C_blocks is not None:
            C = [[cb.to(device) for cb in row] for row in self.C_blocks]
        return replace(
            self,
            clusters=tuple(c.to(device) for c in self.clusters),
            b=self.b.to(device),
            C_blocks=C,
            b0=self.b0.to(device),
            x_sigma=_xf_to(self.x_sigma, device),
            y_R_inv=_xf_to(self.y_R_inv, device),
            y_R=_xf_to(self.y_R, device),
        )


def prepare_pack_data(
    constraints: Sequence,
    b,
    info: Optional[BlockInfo] = None,
    C=None,
    b0=0,
    equilibrate: bool = True,
    orthonormalize: bool = True,
    orthonormalize_B: bool = True,
):
    """Exact (mpmath object-level) packing + preconditioning, shared by the
    device path (pack_constraints -> XF) and the host high-precision path
    (core/host_solver.py -> HXF).  Returns a dict of object arrays.

    equilibrate: rescale each constraint matrix A_(r,s,k) -> A/sigma_k with
    sigma_k = sum_l sum_rnk |H| ||v||^2 (its trace scale), compensating in
    B, c (rows /sigma) and in the returned x (x_user = x_internal / sigma).
    The dual (y, Y) is unchanged.  Polynomial-basis data like the
    reference's sphere-packing example spans ~1e11 element scales
    (Laguerre values at rescaled sample points); without equilibration
    cond(S) starts at ~1e22 and exhausts double-double immediately —
    the reference instead absorbs this with 512-bit arithmetic.
    """
    import mpmath

    if info is None:
        info = get_block_info(constraints)
    clusters = []
    sigmas = []  # per-cluster (dim_S,) scaling used on A/B/c rows
    for j in range(info.J):
        A, B, c, H = constraints[j][:4]
        K = info.n_samples[j]

        # collect padded V object matrices and raw weights per inner block
        Vmats, Hvecs = [], []
        for l in range(info.L[j]):
            rmax = info.rmax[j][l]
            delta = info.delta[j][l]
            Vmat = np.zeros((delta, K * rmax), dtype=object)
            Hvec = np.zeros((K * rmax,), dtype=object)
            Vmat[...] = mpmath.mpf(0)
            Hvec[...] = mpmath.mpf(0)
            for kk in range(K):
                vecs = A[l][kk]
                ws = H[l][kk]
                assert len(vecs) <= rmax
                for rnk in range(len(vecs)):
                    col = np.asarray(vecs[rnk], dtype=object).reshape(-1)
                    assert col.shape[0] == delta, (col.shape, delta)
                    Vmat[:, kk * rmax + rnk] = [mpmath.mpf(v) for v in col]
                    Hvec[kk * rmax + rnk] = mpmath.mpf(ws[rnk])
            Vmats.append(Vmat)
            Hvecs.append(Hvec)

        if orthonormalize:
            # per-(j,l) sampled-basis orthonormalization (SDPB's
            # bilinear-basis conditioning, done numerically): replace
            # V <- L^-1 V where L L^T = V V^T (+ tiny ridge).  An exact
            # congruence reparameterization of the PSD blocks — x, B, c,
            # y and both objectives are invariant; it removes the
            # Vandermonde-type conditioning of raw polynomial samples,
            # which otherwise puts cond(S) at ~cond(basis)^2 (~1e22 for
            # the reference's sphere-packing data at 2d=16).
            for l in range(info.L[j]):
                Vmat = Vmats[l]
                delta = Vmat.shape[0]
                Gm = mpmath.matrix(delta, delta)
                for i in range(delta):
                    for jj in range(delta):
                        Gm[i, jj] = mpmath.fsum(
                            Vmat[i, t] * Vmat[jj, t] for t in range(Vmat.shape[1])
                        )
                ridge = mpmath.mpf(10) ** (-2 * mpmath.mp.dps + 10)
                tr = mpmath.fsum(Gm[i, i] for i in range(delta))
                for i in range(delta):
                    Gm[i, i] += ridge * (tr if tr > 0 else 1)
                L = mpmath.cholesky(Gm)
                # forward substitution: V <- L^-1 V
                for t in range(Vmat.shape[1]):
                    colv = [Vmat[i, t] for i in range(delta)]
                    for i in range(delta):
                        s = colv[i]
                        for jj in range(i):
                            s -= L[i, jj] * colv[jj]
                        colv[i] = s / L[i, i]
                    for i in range(delta):
                        Vmat[i, t] = colv[i]

        # sigma per sample k: trace scale of A_(r,s,k) (post-transform)
        if equilibrate:
            sig_k = []
            for kk in range(K):
                s = mpmath.mpf(0)
                for l in range(info.L[j]):
                    rmax = info.rmax[j][l]
                    for rnk in range(rmax):
                        t = kk * rmax + rnk
                        nrm2 = mpmath.fsum(
                            Vmats[l][i, t] ** 2 for i in range(Vmats[l].shape[0])
                        )
                        s += abs(Hvecs[l][t]) * nrm2
                sig_k.append(s if s > 0 else mpmath.mpf(1))
        else:
            sig_k = [mpmath.mpf(1)] * K

        Vs, Hs = [], []
        for l in range(info.L[j]):
            rmax = info.rmax[j][l]
            Hvec = Hvecs[l].copy()
            for kk in range(K):
                for rnk in range(rmax):
                    Hvec[kk * rmax + rnk] = Hvec[kk * rmax + rnk] / sig_k[kk]
            Vs.append(Vmats[l])
            Hs.append(Hvec)
        # scale B and c rows (tuple order (r, s<=r, k), k fastest)
        B = np.asarray(B, dtype=object).copy()
        c = np.asarray(c, dtype=object).reshape(-1).copy()
        npairs = info.n_pairs(j)
        sigma_rows = np.empty((info.dim_S[j],), dtype=object)
        for p in range(npairs):
            for kk in range(K):
                row = p * K + kk
                sigma_rows[row] = sig_k[kk]
                if equilibrate:
                    B[row, :] = [mpmath.mpf(v) / sig_k[kk] for v in B[row, :]]
                    c[row] = mpmath.mpf(c[row]) / sig_k[kk]
        clusters.append([tuple(Vs), tuple(Hs), B, c])
        sigmas.append(sigma_rows)

    b_mp = [mpmath.mpf(v) for v in np.asarray(b, dtype=object).reshape(-1)]
    n_y = info.n_y
    assert len(b_mp) == n_y
    y_R_inv = None
    if orthonormalize_B and n_y > 0:
        # orthonormalize the free-variable basis: stack B over clusters,
        # QR-factor in mpmath, use B' = Q-hat internally (y' = R y,
        # b' = R^-T b; objectives and residuals invariant; user y
        # recovered via y = R^-1 y').  The reference's applications make
        # B itself a Vandermonde (columns are x^k samples,
        # examples/SpherePacking.jl:59), putting cond(Q) ~ cond(B)^2
        # ~1e24 at 2d=16 — fatal below ~512-bit arithmetic.
        D = sum(info.dim_S)
        Bt = mpmath.matrix(D, n_y)
        r0 = 0
        for j in range(info.J):
            Bj = clusters[j][2]
            for i in range(info.dim_S[j]):
                for jj in range(n_y):
                    Bt[r0 + i, jj] = mpmath.mpf(Bj[i, jj])
            r0 += info.dim_S[j]
        # "skinny" returns the thin D x n_y Q / n_y x n_y R; any other
        # mode string silently falls into mpmath's full-Q branch, which
        # builds the D x D Q (~12x the work at these precisions) for
        # identical leading columns
        Qh, Rh = mpmath.qr(Bt, mode="skinny")
        # guard rank: R diagonal must be nonzero
        for i in range(n_y):
            if Rh[i, i] == 0:
                Rh[i, i] = mpmath.mpf(10) ** (-mpmath.mp.dps)
        # b' = R^-T b  (solve R^T z = b, R upper -> R^T lower)
        bprime = [mpmath.mpf(0)] * n_y
        for i in range(n_y):
            s = b_mp[i]
            for jj in range(i):
                s -= Rh[jj, i] * bprime[jj]
            bprime[i] = s / Rh[i, i]
        b_mp = bprime
        # R^-1 for recovering user y
        Rinv = mpmath.matrix(n_y, n_y)
        for col in range(n_y):
            e = [mpmath.mpf(1) if i == col else mpmath.mpf(0) for i in range(n_y)]
            for i in range(n_y - 1, -1, -1):
                s = e[i]
                for jj in range(i + 1, n_y):
                    s -= Rh[i, jj] * e[jj]
                e[i] = s / Rh[i, i]
            for i in range(n_y):
                Rinv[i, col] = e[i]
        y_R_inv = np.array(
            [[Rinv[i, jj] for jj in range(n_y)] for i in range(n_y)], dtype=object
        )
        y_R_mat = np.array(
            [[Rh[i, jj] for jj in range(n_y)] for i in range(n_y)], dtype=object
        )
        # replace B blocks with Q-hat rows
        r0 = 0
        for j in range(info.J):
            Bj = np.empty((info.dim_S[j], n_y), dtype=object)
            for i in range(info.dim_S[j]):
                for jj in range(n_y):
                    Bj[i, jj] = Qh[r0 + i, jj]
            clusters[j][2] = Bj
            r0 += info.dim_S[j]

    C_obj = None
    if C is not None and not (np.isscalar(C) and C == 0):
        C_obj = [
            [np.asarray(Cb, dtype=object) for Cb in Cj] for Cj in C
        ]
    return dict(
        info=info,
        clusters=clusters,  # [ (Vs tuple, Hs tuple, B obj, c obj) ] per j
        b=np.asarray(b_mp, dtype=object).reshape(-1, 1),
        sigma=np.concatenate(sigmas).reshape(-1, 1),
        y_R_inv=y_R_inv,
        y_R=y_R_mat if y_R_inv is not None else None,
        C=C_obj,
        b0=np.asarray(b0, dtype=object).reshape(()),
    )



def pack_constraints(
    constraints: Sequence,
    b,
    info: Optional[BlockInfo] = None,
    C=None,
    b0=0,
    k: int = 2,
    equilibrate: bool = True,
    orthonormalize: bool = True,
    orthonormalize_B: bool = True,
    *,
    device,
) -> SDPProblem:
    """Pack reference-format constraint tuples (A, B, c, H) into an
    SDPProblem of k-limb float64 tensors on ``device``.  See
    prepare_pack_data for the exact preconditioning performed."""
    data = prepare_pack_data(
        constraints, b, info=info, C=C, b0=b0,
        equilibrate=equilibrate, orthonormalize=orthonormalize,
        orthonormalize_B=orthonormalize_B,
    )
    return _pack_from_data(data, k, device)


def _pack_from_data(data, k, device) -> SDPProblem:
    info = data["info"]

    def cvt(v):
        return xf_from_mp(np.asarray(v, dtype=object), k=k, device=device)

    packed = []
    for j in range(info.J):
        Vs, Hs, B, c = data["clusters"][j]
        packed.append(ClusterData(
            tuple(cvt(V) for V in Vs),
            tuple(cvt(H) for H in Hs),
            cvt(B),
            cvt(np.asarray(c, dtype=object).reshape(-1, 1)),
        ))
    C_blocks = None
    if data["C"] is not None:
        C_blocks = [[cvt(Cb) for Cb in Cj] for Cj in data["C"]]
    return SDPProblem(
        tuple(packed),
        cvt(data["b"]),
        C_blocks,
        cvt(data["b0"]),
        info,
        cvt(data["sigma"]),
        cvt(data["y_R_inv"]) if data["y_R_inv"] is not None else None,
        cvt(data["y_R"]) if data["y_R"] is not None else None,
    )


# ---------------------------------------------------------------------------
# Block-diagonal state helpers (nested [j][l] lists of XF)
# ---------------------------------------------------------------------------

BlockDiag = List[List[XF]]


def bd_map(f, *bds) -> BlockDiag:
    return [
        [f(*(bd[j][l] for bd in bds)) for l in range(len(bds[0][j]))]
        for j in range(len(bds[0]))
    ]


def bd_scalar_identity(info: BlockInfo, scale, k: int = 2, *, device) -> BlockDiag:
    """scale * I per block (the cold start X = Omega_p I)."""
    out = []
    for j in range(info.J):
        row = []
        for l in range(info.L[j]):
            n = info.Y_blocksizes[j][l]
            eye = XF.eye(n, k=k, device=device)
            row.append(XF(eye.limbs * scale))
        out.append(row)
    return out


def bd_zeros_like(bd: BlockDiag) -> BlockDiag:
    return bd_map(lambda b: XF(torch.zeros_like(b.limbs)), bd)


def bd_dot(a: BlockDiag, b: BlockDiag) -> XF:
    """<A, B> = sum of elementwise products over all blocks, in (j, l)
    order."""
    total = None
    for aj, bj in zip(a, b):
        for al, bl in zip(aj, bj):
            d = xf_dot(al, bl)
            total = d if total is None else xf_add(total, d)
    return total
