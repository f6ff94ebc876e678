"""Pure-host mpmath oracle IPM for tiny problems.

An independent, dense, arbitrary-precision implementation of the same XZ
predictor-corrector algorithm the device solver runs (reference:
MPMP.jl:595-1025) — no JAX, no low-rank structure exploitation, no
preconditioning, just mpmath matrices at whatever working precision is set.
It plays the role the reference delegates to SDPB cross-validation
(examples/SpherePacking.jl:95-98 exports the problem for SDPB): a second,
structurally different implementation of the same math that tiny test
problems can be checked against to ~working-precision accuracy.

A copy of ``clrs_tpu/utils/oracle.py`` (which needs no jax), kept in the
port so that it imports nothing of the JAX package.

Input format matches `solverank1sdp(constraints, b, blockinfo)`:
constraints[j] = (A, B, c, H) host data with A[l][k][rnk] low-rank vectors,
H[l][k][rnk] weights, dense B (dim_S, n_y), c (dim_S,).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import mpmath
import numpy as np

from clrs_tpu_torch.core.blockinfo import BlockInfo, get_block_info, pair_list


def _sym(M):
    return (M + M.T) / 2


def _dense_constraint_matrices(constraints, info: BlockInfo):
    """A_mats[j][l] = list over tuples (p*K + k) of dense mpmath matrices
    A_(j,r,s,k)|_l = sum_rnk H * Sym(E_rs (x) v v^T)  (MPMP.jl:385-386)."""
    out = []
    for j in range(info.J):
        A, B, c, H = constraints[j][:4]
        m, K = info.m[j], info.n_samples[j]
        pairs = pair_list(m)
        rows = []
        for l in range(info.L[j]):
            delta = info.delta[j][l]
            n = m * delta
            mats = []
            for (r, s) in pairs:
                for k in range(K):
                    M = mpmath.zeros(n, n)
                    for rnk in range(len(A[l][k])):
                        v = [mpmath.mpf(vv) for vv in np.asarray(A[l][k][rnk], dtype=object).reshape(-1)]
                        h = mpmath.mpf(H[l][k][rnk])
                        for i1 in range(delta):
                            for i2 in range(delta):
                                w = h * v[i1] * v[i2]
                                if r == s:
                                    M[r * delta + i1, s * delta + i2] += w
                                else:
                                    M[r * delta + i1, s * delta + i2] += w / 2
                                    M[s * delta + i1, r * delta + i2] += w / 2
                    mats.append(M)
            rows.append(mats)
        out.append(rows)
    return out


def _trace_dot(A, B):
    n = A.rows
    s = mpmath.mpf(0)
    for i in range(n):
        for j in range(n):
            s += A[i, j] * B[j, i]
    return s


def _min_eig(M):
    E = mpmath.eigsy(_sym(M), eigvals_only=True)
    return min(E[i] for i in range(M.rows))


def _solve(A, B):
    """A^-1 B for vector or matrix B (mpmath.lu_solve is vector-only)."""
    if B.cols == 1:
        return mpmath.lu_solve(A, B)
    out = mpmath.zeros(A.rows, B.cols)
    for c in range(B.cols):
        col = mpmath.lu_solve(A, B[:, c])
        for i in range(A.rows):
            out[i, c] = col[i]
    return out


def solve_oracle(
    constraints,
    b,
    blockinfo: Optional[BlockInfo] = None,
    C=None,
    b0=0,
    maxiterations: int = 200,
    beta_infeasible: float = 0.3,
    beta_feasible: float = 0.1,
    gamma: float = 0.7,
    omega_p: float = 1e10,
    omega_d: float = 1e10,
    duality_gap_threshold: float = 1e-15,
    primal_error_threshold: float = 1e-30,
    dual_error_threshold: float = 1e-30,
    verbose: bool = False,
):
    """Dense mpmath IPM on the reference problem format.  Returns a dict
    with x, y, X, Y (mpmath), objectives, gap, errors, iterations, status.

    Intended for tiny problems only (everything is O(dim^2) dense loops in
    interpreted mpmath).
    """
    info = blockinfo if blockinfo is not None else get_block_info(constraints)
    J, n_y = info.J, info.n_y
    A_mats = _dense_constraint_matrices(constraints, info)
    B_mats = []
    c_vecs = []
    for j in range(J):
        Bj = np.asarray(constraints[j][1], dtype=object)
        B_mats.append(
            mpmath.matrix([[mpmath.mpf(Bj[i, t]) for t in range(n_y)] for i in range(info.dim_S[j])])
            if n_y > 0 else None
        )
        cj = np.asarray(constraints[j][2], dtype=object).reshape(-1)
        c_vecs.append(mpmath.matrix([mpmath.mpf(v) for v in cj]))
    b_vec = mpmath.matrix([mpmath.mpf(v) for v in np.asarray(b, dtype=object).reshape(-1)])
    b0 = mpmath.mpf(b0)
    C_blocks = None
    if C is not None and not (np.isscalar(C) and C == 0):
        C_blocks = [
            [mpmath.matrix([[mpmath.mpf(x) for x in row] for row in np.asarray(Cb, dtype=object)]) for Cb in Cj]
            for Cj in C
        ]

    sizes = [[info.Y_blocksizes[j][l] for l in range(info.L[j])] for j in range(J)]
    Ktot = sum(sum(sz) for sz in sizes)
    dims = list(info.dim_S)
    total_dim = sum(dims)

    # cold start (MPMP.jl:659-686)
    x = mpmath.matrix([mpmath.mpf(0)] * total_dim) if total_dim else mpmath.matrix(0, 1)
    y = mpmath.matrix([mpmath.mpf(0)] * n_y) if n_y else mpmath.matrix(0, 1)
    X = [[mpmath.eye(sizes[j][l]) * omega_p for l in range(info.L[j])] for j in range(J)]
    Y = [[mpmath.eye(sizes[j][l]) * omega_d for l in range(info.L[j])] for j in range(J)]

    def bd_dot(U, V):
        return mpmath.fsum(_trace_dot(U[j][l], V[j][l]) for j in range(J) for l in range(info.L[j]))

    def x_slice(j):
        lo = info.x_indices[j]
        return mpmath.matrix([x[lo + i] for i in range(dims[j])])

    pd_feas = False
    status = "max_iterations"
    converged = False
    history = []
    gap = mpmath.mpf("inf")

    for itn in range(1, maxiterations + 1):
        mu = bd_dot(X, Y) / Ktot
        mu_p = mpmath.mpf(0) if pd_feas else mu * beta_infeasible

        X_inv = [[_sym(X[j][l] ** -1) for l in range(info.L[j])] for j in range(J)]

        # Schur complement S_j[p, q] = sum_l Tr(A_p X^-1 A_q Y), symmetrized
        S = []
        for j in range(J):
            dj = dims[j]
            Sj = mpmath.zeros(dj, dj)
            for l in range(info.L[j]):
                XiA = [X_inv[j][l] * A_mats[j][l][q] for q in range(dj)]
                AY = [A_mats[j][l][p] * Y[j][l] for p in range(dj)]
                for p in range(dj):
                    for q in range(dj):
                        Sj[p, q] += _trace_dot(AY[p], XiA[q])
            S.append(_sym(Sj))

        # residuals (MPMP.jl:1107-1144)
        P = []
        for j in range(J):
            xj = x_slice(j)
            row = []
            for l in range(info.L[j]):
                M = mpmath.zeros(sizes[j][l], sizes[j][l])
                for p in range(dims[j]):
                    if xj[p] != 0:
                        M += A_mats[j][l][p] * xj[p]
                M -= X[j][l]
                if C_blocks is not None:
                    M -= C_blocks[j][l]
                row.append(M)
            P.append(row)
        p_res = b_vec.copy()
        for j in range(J):
            if n_y:
                p_res -= B_mats[j].T * x_slice(j)
        d_parts = []
        for j in range(J):
            dj = c_vecs[j].copy()
            if n_y:
                dj -= B_mats[j] * y
            for p in range(dims[j]):
                tr = mpmath.fsum(
                    _trace_dot(A_mats[j][l][p], Y[j][l]) for l in range(info.L[j])
                )
                dj[p] -= tr
            d_parts.append(dj)

        def directions(Rmat):
            # Z = Sym(X^-1 (P Y - R))
            Z = [
                [_sym(X_inv[j][l] * (P[j][l] * Y[j][l] - Rmat[j][l])) for l in range(info.L[j])]
                for j in range(J)
            ]
            rhs_x = []
            for j in range(J):
                rj = mpmath.matrix(dims[j], 1)
                for p in range(dims[j]):
                    rj[p] = -d_parts[j][p] - mpmath.fsum(
                        _trace_dot(A_mats[j][l][p], Z[j][l]) for l in range(info.L[j])
                    )
                rhs_x.append(rj)
            # saddle: S dx - B dy = rhs_x; B^T dx = p_res
            t = [_solve(S[j], rhs_x[j]) for j in range(J)]
            if n_y:
                Q = mpmath.zeros(n_y, n_y)
                rhs_dy = p_res.copy()
                for j in range(J):
                    SinvB = _solve(S[j], B_mats[j])
                    Q += B_mats[j].T * SinvB
                    rhs_dy -= B_mats[j].T * t[j]
                dy = _solve(Q, rhs_dy)
                dx = [t[j] + _solve(S[j], B_mats[j] * dy) for j in range(J)]
            else:
                dy = mpmath.matrix(0, 1)
                dx = t
            dX = []
            for j in range(J):
                row = []
                for l in range(info.L[j]):
                    M = P[j][l].copy()
                    for p in range(dims[j]):
                        M += A_mats[j][l][p] * dx[j][p]
                    row.append(M)
                dX.append(row)
            dY = [
                [_sym(X_inv[j][l] * (Rmat[j][l] - dX[j][l] * Y[j][l])) for l in range(info.L[j])]
                for j in range(J)
            ]
            return dx, dX, dy, dY

        R1 = [
            [mpmath.eye(sizes[j][l]) * mu_p - X[j][l] * Y[j][l] for l in range(info.L[j])]
            for j in range(J)
        ]
        dx, dX, dy, dY = directions(R1)

        # corrector (MPMP.jl:832-858)
        XdX = [[X[j][l] + dX[j][l] for l in range(info.L[j])] for j in range(J)]
        YdY = [[Y[j][l] + dY[j][l] for l in range(info.L[j])] for j in range(J)]
        rr = bd_dot(XdX, YdY) / (mu * Ktot)
        beta = rr**2 if rr < 1 else rr
        if pd_feas:
            beta_c = min(max(mpmath.mpf(beta_feasible), beta), mpmath.mpf(1))
        else:
            beta_c = max(mpmath.mpf(beta_infeasible), beta)
        mu_c = beta_c * mu
        R2 = [
            [
                mpmath.eye(sizes[j][l]) * mu_c - X[j][l] * Y[j][l] - dX[j][l] * dY[j][l]
                for l in range(info.L[j])
            ]
            for j in range(J)
        ]
        dx, dX, dy, dY = directions(R2)

        # step lengths (MPMP.jl:1829-1898)
        def steplen(M, dM):
            lam = mpmath.mpf("inf")
            for j in range(J):
                for l in range(info.L[j]):
                    Lc = mpmath.cholesky(M[j][l])
                    W = _solve(Lc, dM[j][l])
                    W2 = _solve(Lc, W.T)
                    lam = min(lam, _min_eig(W2))
            if lam > -gamma:
                return mpmath.mpf(1)
            return min(mpmath.mpf(1), -gamma / lam)

        alpha_p = steplen(X, dX)
        alpha_d = steplen(Y, dY)
        if pd_feas:
            alpha_p = alpha_d = min(alpha_p, alpha_d)

        for j in range(J):
            lo = info.x_indices[j]
            for i in range(dims[j]):
                x[lo + i] += alpha_p * dx[j][i]
            for l in range(info.L[j]):
                X[j][l] = _sym(X[j][l] + alpha_p * dX[j][l])
                Y[j][l] = _sym(Y[j][l] + alpha_d * dY[j][l])
        for i in range(n_y):
            y[i] += alpha_d * dy[i]

        # metrics (MPMP.jl:1027-1092)
        p_obj = mpmath.fsum(
            c_vecs[j][i] * x[info.x_indices[j] + i] for j in range(J) for i in range(dims[j])
        ) + b0
        d_obj = mpmath.fsum(b_vec[i] * y[i] for i in range(n_y)) + b0
        if C_blocks is not None:
            d_obj += bd_dot(C_blocks, Y)
        gap = abs(p_obj - d_obj) / max(mpmath.mpf(1), abs(p_obj + d_obj))
        P_err = max(
            (max(abs(P[j][l][i1, i2]) for i1 in range(sizes[j][l]) for i2 in range(sizes[j][l]))
             for j in range(J) for l in range(info.L[j])),
            default=mpmath.mpf(0),
        )
        p_err = max((abs(v) for v in p_res), default=mpmath.mpf(0))
        d_err = max(
            (abs(d_parts[j][i]) for j in range(J) for i in range(dims[j])),
            default=mpmath.mpf(0),
        )
        history.append(dict(iter=itn, mu=mu, gap=gap, p_obj=p_obj, d_obj=d_obj,
                            P_err=P_err, p_err=p_err, d_err=d_err,
                            alpha_p=alpha_p, alpha_d=alpha_d))
        if verbose:
            print(f"{itn:4d} mu={mpmath.nstr(mu, 3)} gap={mpmath.nstr(gap, 3)} "
                  f"P={mpmath.nstr(P_err, 2)} p={mpmath.nstr(p_err, 2)} "
                  f"d={mpmath.nstr(d_err, 2)} a_p={mpmath.nstr(alpha_p, 2)} "
                  f"a_d={mpmath.nstr(alpha_d, 2)}")

        primal_feas = P_err < primal_error_threshold and p_err < primal_error_threshold
        dual_feas = d_err < dual_error_threshold
        pd_feas = bool(primal_feas and dual_feas)
        if primal_feas and dual_feas and gap < duality_gap_threshold:
            status = "optimal"
            converged = True
            break

    return dict(
        x=x, y=y, X=X, Y=Y,
        primal_objective=p_obj, dual_objective=d_obj, dual_gap=gap,
        iterations=itn, converged=converged, status=status, history=history,
    )
