"""prepareabc — the MPMP -> clustered-SDP compiler (reference MPMP.jl:225-407).

Samples one polynomial-matrix constraint

    M_1(x) + sum_{i>=2} y_i (-M_i(x)) >= 0   on a domain certified by G

into low-rank numerical data: for each weight l and sample point x_k the
constraint matrix for the tuple (r, s, k) is

    A_(r,s,k) = sum_eta H_(l,k,eta) Sym(E_rs ⊗ v_(l,k,eta) v_(l,k,eta)^T)

with v = (Pi-eigenvector component) * q_d(x_k) * sqrt(|G_l(x_k)|) built as a
manual Kronecker product with per-row degree truncation (MPMP.jl:345-377),
and H = (eigenvalue of Pi(x_k)) * sign(G_l(x_k)) (MPMP.jl:307-312).

Everything is evaluated with mpmath at the ambient precision; the output is
host data consumed by core.problem.pack_constraints.

Deviation from the reference: for the symmetry-reduction matrices Pi we use
a symmetric eigendecomposition (mpmath.eigsy) instead of an SVD with a
sign-recovery dot product (MPMP.jl:256-269) — same spectral data Q(x_k) =
sum_r lambda_r u_r u_r^T, computed directly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import mpmath
import numpy as np

from clrs_tpu_torch.models.poly import MPoly


def _eig_sym_mp(mat: np.ndarray):
    """Eigen-decomposition of a symmetric mpmath object matrix.

    Returns (vals: list, vecs: list of column arrays)."""
    n = mat.shape[0]
    if n == 1:
        return [mat[0, 0]], [np.array([mpmath.mpf(1)], dtype=object)]
    m = mpmath.matrix(n, n)
    for i in range(n):
        for j in range(n):
            m[i, j] = mat[i, j]
    E, Q = mpmath.eigsy(m)
    vals = [E[i] for i in range(n)]
    vecs = [
        np.array([Q[i, r] for i in range(n)], dtype=object) for r in range(n)
    ]
    return vals, vecs


def prepareabc(
    M: Sequence,
    G: Sequence[MPoly],
    q: Sequence[MPoly],
    x: Sequence,
    delta: int = -1,
    Pi: Optional[Sequence] = None,
    threshold=None,
    qp_precomp: Optional[np.ndarray] = None,
):
    """Sample one polynomial matrix constraint into (A, B, c, H).

    Args mirror the reference (MPMP.jl:225-236):
      M: list of m x m polynomial matrices [M_1, ..., M_{n_y+1}] (object
         arrays of MPoly); M[0] is the constant part (-> c), the rest give
         the columns of B with a minus sign (MPMP.jl:387-400).
      G: domain-certificate weight polynomials.
      q: polynomial basis, degree-monotone (warned otherwise, MPMP.jl:289).
      x: sample points (scalars or tuples of mpf).
      delta: max degree; negative -> 2 * deg(q[-1]) (MPMP.jl:247).
      Pi: optional symmetry matrices, one per weight in G.
      threshold: prune |H| <= threshold (default 1e-70, MPMP.jl:234).
      qp_precomp: optional precomputed q values, qp_precomp[k][d]
         (MPMP.jl:235, 355-363).
    Returns (A, B, c, H) with A[l][k] = list of vectors, H[l][k] = list of
    weights, B (dim_S, n_y) object array, c (dim_S,) object array.
    """
    if threshold is None:
        threshold = mpmath.mpf(10) ** (-70)
    M = list(M)
    m = M[0].shape[0]
    x = [pt if isinstance(pt, (list, tuple)) else (pt,) for pt in x]
    K = len(x)
    nL = len(G)

    if delta is None or delta < 0:
        delta = 2 * q[-1].total_degree()

    # --- Pi spectral data (MPMP.jl:250-281) ---
    if Pi is None:
        Pi_vecs = [[[np.array([mpmath.mpf(1)], dtype=object)] for _ in range(K)] for _ in range(nL)]
        Pi_vals = [[[mpmath.mpf(1)] for _ in range(K)] for _ in range(nL)]
        deg_Pi_vec = [[0] for _ in range(nL)]
    else:
        assert len(Pi) == nL
        Pi_vecs = []
        Pi_vals = []
        for l in range(nL):
            vr, vv = [], []
            for k in range(K):
                nn = Pi[l].shape[0]
                sampled = np.empty((nn, nn), dtype=object)
                for i in range(nn):
                    for j in range(nn):
                        sampled[i, j] = Pi[l][i, j](*x[k])
                vals, vecs = _eig_sym_mp(sampled)
                vr.append(vecs)
                vv.append(vals)
            Pi_vecs.append(vr)
            Pi_vals.append(vv)
        deg_Pi_vec = [
            [Pi[l][i, i].total_degree() for i in range(Pi[l].shape[0])]
            for l in range(nL)
        ]

    # --- degree bookkeeping: last index of each degree in q (MPMP.jl:283-303)
    all_degrees = [qi.total_degree() for qi in q]
    for i in range(len(all_degrees) - 1):
        if all_degrees[i] > all_degrees[i + 1]:
            print(
                "Degrees are not monotone. The program will (most probably) "
                "not be correct if you don't fix this"
            )
    # last_deg[dg] = number of basis elements with degree <= dg (i.e. the
    # 1-based last index; fill-forward where a degree is absent)
    last_deg = [0] * (delta // 2 + 1)
    for dg in range(delta // 2 + 1):
        idxs = [i for i, ad in enumerate(all_degrees) if ad == dg]
        if idxs:
            last_deg[dg] = idxs[-1] + 1
        else:
            last_deg[dg] = last_deg[dg - 1] if dg > 0 else 0

    # --- q evaluations (cache q_d(x_k)) ---
    if qp_precomp is not None:
        q_at = qp_precomp  # [k][d]
    else:
        q_at = [[qd(*x[k]) for qd in q] for k in range(K)]

    # --- A vectors and H weights (MPMP.jl:305-383) ---
    A: List[List[List[np.ndarray]]] = []
    H: List[List[List[mpmath.mpf]]] = []
    for l in range(nL):
        degG = G[l].total_degree()
        Al, Hl = [], []
        for k in range(K):
            Gval = G[l](*x[k])
            sqG = mpmath.sqrt(abs(Gval))
            sgnG = mpmath.mpf(1) if Gval >= 0 else mpmath.mpf(-1)
            vecs_k, ws_k = [], []
            n_eta = len(Pi_vecs[l][k])
            for r in range(n_eta):
                w = Pi_vals[l][k][r] * sgnG
                entries = []
                for pi_idx in range(len(deg_Pi_vec[l])):
                    cut = last_deg[(delta - degG - deg_Pi_vec[l][pi_idx]) // 2]
                    comp = Pi_vecs[l][k][r][pi_idx]
                    for dd in range(cut):
                        entries.append(comp * q_at[k][dd] * sqG)
                # prune near-zero weights (MPMP.jl:378-383)
                if abs(w) > threshold:
                    vecs_k.append(np.array(entries, dtype=object))
                    ws_k.append(w)
            Al.append(vecs_k)
            Hl.append(ws_k)
        A.append(Al)
        H.append(Hl)

    # --- B and c in tuple order (r, s<=r, k), k fastest (MPMP.jl:387-400) ---
    n_y = len(M) - 1
    dim_S = m * (m + 1) // 2 * K
    B = np.empty((dim_S, n_y), dtype=object)
    c = np.empty((dim_S,), dtype=object)
    row = 0
    for r in range(m):
        for s in range(r + 1):
            for k in range(K):
                c[row] = M[0][r, s](*x[k])
                for i in range(n_y):
                    B[row, i] = -M[i + 1][r, s](*x[k])
                row += 1
    return A, B, c, H
