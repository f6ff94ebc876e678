"""The clustered low-rank SDP interior-point solver (XZ predictor-corrector)
on torch tensors.

Counterpart of ``clrs_tpu/core/solver.py``: the same phases
(``make_ipm_phases``), run eagerly as plain functions, and the same host
driver (``solverank1sdp``) with its sticky Cholesky->LU switch, stall
guard, blowup detector, history rows and per-phase timings.  Blocks and
clusters of one shape are stacked on a leading batch axis where the
reference ``jax.vmap``s them; the arithmetic per block is unchanged.

Algorithm (MPMP.jl:642-657):
  1. init (x, X, y, Y) = (0, Omega_p I, 0, Omega_d I), or warm start
  2. residuals P = sum_i A_i x_i - X - C, p = b - B^T x, d = c - Tr(A_* Y) - By
  3. mu = <X, Y>/K; mu_p = 0 if pd-feasible else beta_infeasible * mu
  4. predictor direction with R = mu_p I - XY
  5. corrector factor beta_c from r = <X+dX, Y+dY>/(mu K)
  6. corrector direction with R = mu_c I - XY - dX dY
  7. step lengths alpha = min(1, -gamma/lambda_min(L^-1 dM L^-T))
  8. x += a_p dx, X += a_p dX, y += a_d dy, Y += a_d dY
  until duality gap < 1e-15 and feasibility errors < 1e-30.

The arithmetic runs in k-limb expansions, k = ``precision_k`` (2..12).
On a CUDA problem (``use_cuda_matmul`` on by default there) the products
of the pairings, weighted-A and trace-A go through K3 (k=2) or K4
(k >= 3), the Schur core through K2, and S_j^-1 and Q^-1 through K1 (k=2)
or K5 (k >= 3); ``use_cuda_inverse`` also sends X^-1 there,
``use_cuda_steplength`` sends the step lengths of both sides through one
K7 launch, and ``use_cuda_elemwise`` every k-limb add and multiply of the
phases through K8.  With all three on, every kernel of the port runs: the
all-kernels route.  On the CPU the same routing runs the kernels' plain
versions.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from clrs_tpu_torch.core.batched import (
    block_groups,
    cluster_groups,
    map_block_scalar,
    map_blocks,
    stack_xf,
)
from clrs_tpu_torch.core.blockinfo import BlockInfo
from clrs_tpu_torch.core.kernels import (
    compute_pairings,
    matmul_route,
    pairing_diag,
    schur_block_contribution,
    trace_A_from_diag,
    trace_A_generic,
    weighted_A_block,
)
from clrs_tpu_torch.core.problem import (
    SDPProblem,
    bd_dot,
    bd_map,
    bd_scalar_identity,
)
from clrs_tpu_torch.ops.cuda_xf import steplen_sandwich_xf_groups, xf_spd_inverse_batched
from clrs_tpu_torch.ops.linalg import (
    jacobi_min_eig,
    xf_inverse_lu,
    xf_min_eig_sym,
    xf_spd_inverse,
    xf_sym,
)
from clrs_tpu_torch.ops.xfloat import (
    XF,
    elemwise_cuda,
    xf_abs,
    xf_add,
    xf_div,
    xf_dot,
    xf_matmul,
    xf_max,
    xf_min,
    xf_mul,
    xf_norm_max,
    xf_sum,
    xf_where,
)


@dataclass(frozen=True)
class SolverConfig:
    """Solver options; defaults mirror the reference kwargs (MPMP.jl:599-615)."""

    maxiterations: int = 500
    beta_infeasible: float = 0.3
    beta_feasible: float = 0.1
    gamma: float = 0.7
    omega_p: float = 1e10
    omega_d: float = 1e10
    duality_gap_threshold: float = 1e-15
    primal_error_threshold: float = 1e-30
    dual_error_threshold: float = 1e-30
    need_primal_feasible: bool = False
    need_dual_feasible: bool = False
    stall_patience: int = 40  # stop after this many non-improving iterations
    # explosion detector: once the merit (max of gap and feasibility errors)
    # exceeds best*blowup_factor, count such iterations toward the stall
    # budget with this weight, so the run ends soon after the blowup
    blowup_factor: float = 1e3
    blowup_weight: int = 8
    verbose: bool = True
    testing: bool = False  # print early-iteration phase timings
    refine_steps: int = 1  # iterative-refinement rounds on the saddle solve
    # numerical degradation ladder (sticky, MPMP.jl:717-718)
    use_lu_inverse: bool = False  # X^-1 via LU instead of Cholesky
    use_lu_schur: bool = False  # S_j and Q via LU instead of Cholesky
    use_cuda_inverse: bool = False  # X^-1 through the K1/K5 SPD-inverse kernel
    # step lengths through K7 (the k-limb sandwich L^-1 dM L^-T per block
    # group) and the float64 Jacobi bound, as the reference's
    # use_pallas_steplength; scalar blocks keep xf_min_eig_sym
    use_cuda_steplength: bool = False
    # every k-limb add and multiply of the phases through K8 (one launch
    # each), as the reference's CLRS_XF_ELEMWISE_PALLAS_MIN_K gate
    use_cuda_elemwise: bool = False
    # pairing / weighted-A / trace-A products through K3/K4, the Schur core
    # through K2, S_j^-1 and Q^-1 through K1/K5.  None = on when the
    # problem lies on a CUDA device.
    use_cuda_matmul: Optional[bool] = None
    # pairing / weighted-A / trace-A products through the int8-sliced
    # product (ops/mxu_matmul.py: torch._int_mm, the card's int8 tensor
    # cores) where the kernels are off, as the reference's use_mxu_matmul
    use_mxu_matmul: bool = False

    def use_cuda_kernels(self, device) -> bool:
        if self.use_cuda_matmul is None:
            return torch.device(device).type == "cuda"
        return bool(self.use_cuda_matmul)


# ---------------------------------------------------------------------------
# Iteration pieces
# ---------------------------------------------------------------------------


def _x_slice(v: XF, info: BlockInfo, j: int) -> XF:
    return v[info.x_indices[j]:info.x_indices[j + 1]]


def _cat0(parts: List[XF]) -> XF:
    """Concatenate XFs along their first value axis."""
    return XF(torch.cat([p.limbs for p in parts], dim=1))


def compute_residual_R(X, Y, mu: XF, info: BlockInfo, dX=None, dY=None):
    """R = mu I - XY (- dX dY), batched by block size."""

    def fn(Xb, Yb):
        eye = XF.eye(Xb.shape[-1], k=mu.k, device=mu.device)
        return xf_add(xf_mul(eye, mu), -xf_matmul(Xb, Yb))

    def fn2(Xb, Yb, dXb, dYb):
        eye = XF.eye(Xb.shape[-1], k=mu.k, device=mu.device)
        t = xf_add(xf_mul(eye, mu), -xf_matmul(Xb, Yb))
        return xf_add(t, -xf_matmul(dXb, dYb))

    if dX is None:
        return map_blocks(fn, info, X, Y)
    return map_blocks(fn2, info, X, Y, dX, dY)


def _cuda_spd_inverse(a: XF, group=None):
    """S^-1 (any leading batch) through K1 or K5, symmetrized; group bands
    the panel route's row products."""
    n = a.shape[-1]
    inv, ok = xf_spd_inverse_batched(a.limbs.reshape(a.k, -1, n, n), group)
    return xf_sym(XF(inv.reshape(a.limbs.shape))), ok.reshape(a.shape[:-2])


def compute_X_inv(X, info: BlockInfo, use_lu: bool, use_cuda: bool = False):
    """Per-block SPD inverse with ok flags, batched by block size."""
    if use_cuda and not use_lu:
        out = [[None] * info.L[j] for j in range(info.J)]
        ok = None
        for size, jls in block_groups(info).items():
            stacked = stack_xf([X[j][l] for (j, l) in jls])
            inv, okb = xf_spd_inverse_batched(stacked.limbs)
            okg = torch.all(okb)
            ok = okg if ok is None else ok & okg
            for i, (j, l) in enumerate(jls):
                out[j][l] = XF(inv[:, i])
        return out, ok

    inv_fn = xf_inverse_lu if use_lu else xf_spd_inverse

    def fn(Xb):
        inv, okb = inv_fn(Xb)
        return xf_sym(inv), okb

    return map_blocks(fn, info, X, out_has_flag=True)


def compute_decomposition(problem: SDPProblem, X_inv, Y, use_lu_schur: bool,
                          use_cuda: bool = False, mm=None):
    """Pairings + Schur complement + saddle-point factorization, one
    batched call per cluster shape group.  S_j^-1 and Q^-1 are
    materialized, so the direction solves are matmuls.  use_cuda takes
    K2 and K1/K5, mm the pairings' matmul (matmul_route(use_cuda) by
    default).  Under the problem's intra plan (parallel/intra.py) the
    ranks split the pairing products, the Schur rows and the panel forms'
    trailing updates.

    Returns dict with: S_mat, S_inv, S_inv_B per cluster, Q_inv, A_Y
    (diagonal Y pairings for the fast Tr(A_* Y)), ok."""
    info = problem.info
    dev = problem.device
    plan = problem.plan
    group = None if plan is None else plan.group
    mm = matmul_route(use_cuda) if mm is None else mm
    ok = None
    S_mat: List[Any] = [None] * info.J
    S_inv: List[Any] = [None] * info.J
    S_inv_B: List[Any] = [None] * info.J
    A_Y: List[Any] = [None] * info.J
    k = problem.b.k
    if use_lu_schur:
        inv_fn = xf_inverse_lu
    elif use_cuda:
        inv_fn = functools.partial(_cuda_spd_inverse, group=group)
    else:
        inv_fn = functools.partial(xf_spd_inverse, group=group)

    Q = XF.zeros((info.n_y, info.n_y), k=k, device=dev)
    for js in cluster_groups(info):
        j0 = js[0]
        m, K = info.m[j0], info.n_samples[j0]
        L = info.L[j0]
        rmaxs = info.rmax[j0]
        dim = info.dim_S[j0]
        G = len(js)
        Xinv_b = [stack_xf([X_inv[j][l] for j in js]) for l in range(L)]
        Y_b = [stack_xf([Y[j][l] for j in js]) for l in range(L)]
        Vs = [stack_xf([problem.clusters[j].Vs[l] for j in js]) for l in range(L)]
        Hs = [stack_xf([problem.clusters[j].Hs[l] for j in js]) for l in range(L)]
        B = stack_xf([problem.clusters[j].B for j in js])

        S_j = XF.zeros((G, dim, dim), k=k, device=dev)
        ay = []
        for l in range(L):
            PX = compute_pairings(Xinv_b[l], Vs[l], m, mm, plan)
            PY = compute_pairings(Y_b[l], Vs[l], m, mm, plan)
            ay.append(pairing_diag(PY, m))
            S_j = xf_add(S_j, schur_block_contribution(
                PX, PY, Hs[l], m, K, rmaxs[l], use_cuda, plan))
        S_j = xf_sym(S_j)
        Sj_inv, okj = inv_fn(S_j)
        Sj_inv = xf_sym(Sj_inv)
        SB = xf_matmul(Sj_inv, B)
        Qp = xf_matmul(B.mT, SB)
        for i, j in enumerate(js):
            S_mat[j] = S_j[i]
            S_inv[j] = Sj_inv[i]
            S_inv_B[j] = SB[i]
            A_Y[j] = [ay[l][i] for l in range(L)]
        Q = xf_add(Q, xf_sum(Qp, axis=0))
        okg = torch.all(okj)
        ok = okg if ok is None else ok & okg

    # Q = B^T S^-1 B (n_y x n_y)
    Q_inv, okq = inv_fn(xf_sym(Q))
    ok = ok & torch.all(okq)
    return dict(S_mat=S_mat, S_inv=S_inv, S_inv_B=S_inv_B, Q_inv=Q_inv,
                A_Y=A_Y, ok=ok)


def compute_weighted_A(problem: SDPProblem, a: XF, mm=xf_matmul):
    """Block-diagonal sum_i a_i A_i, cluster-grouped."""
    info = problem.info
    out: List[Any] = [None] * info.J
    for js in cluster_groups(info):
        j0 = js[0]
        m, K = info.m[j0], info.n_samples[j0]
        rmaxs = info.rmax[j0]
        a_j = stack_xf([_x_slice(a, info, j)[:, 0] for j in js])
        rows = []
        for l in range(info.L[j0]):
            V = stack_xf([problem.clusters[j].Vs[l] for j in js])
            H = stack_xf([problem.clusters[j].Hs[l] for j in js])
            rows.append(weighted_A_block(a_j, V, H, m, K, rmaxs[l], mm))
        for i, j in enumerate(js):
            out[j] = [r[i] for r in rows]
    return out


def _concat_cluster_vecs(info: BlockInfo, parts) -> XF:
    return _cat0(parts).reshape((info.total_dim_S, 1))


def compute_trace_A_diag(problem: SDPProblem, A_Y):
    """Fast-path Tr(A_* Y) from stored diagonal pairings."""
    info = problem.info
    parts: List[Any] = [None] * info.J
    for js in cluster_groups(info):
        j0 = js[0]
        m, K = info.m[j0], info.n_samples[j0]
        rmaxs = info.rmax[j0]
        tr = None
        for l in range(info.L[j0]):
            ay = stack_xf([A_Y[j][l] for j in js])
            H = stack_xf([problem.clusters[j].Hs[l] for j in js])
            t = trace_A_from_diag(ay, H, m, K, rmaxs[l])
            tr = t if tr is None else xf_add(tr, t)
        for i, j in enumerate(js):
            parts[j] = tr[i]
    return _concat_cluster_vecs(info, parts)


def compute_trace_A_generic(problem: SDPProblem, Z, mm=xf_matmul):
    """Tr(A_* Z) for a generic block-diagonal Z."""
    info = problem.info
    parts: List[Any] = [None] * info.J
    for js in cluster_groups(info):
        j0 = js[0]
        m, K = info.m[j0], info.n_samples[j0]
        rmaxs = info.rmax[j0]
        tr = None
        for l in range(info.L[j0]):
            Zb = stack_xf([Z[j][l] for j in js])
            V = stack_xf([problem.clusters[j].Vs[l] for j in js])
            H = stack_xf([problem.clusters[j].Hs[l] for j in js])
            t = trace_A_generic(Zb, V, H, m, K, rmaxs[l], mm)
            tr = t if tr is None else xf_add(tr, t)
        for i, j in enumerate(js):
            parts[j] = tr[i]
    return _concat_cluster_vecs(info, parts)


def _group_By(problem: SDPProblem, y: XF) -> List[XF]:
    """B_j y for every cluster j, one batched matmul per cluster group."""
    info = problem.info
    out: List[Any] = [None] * info.J
    for js in cluster_groups(info):
        Bs = stack_xf([problem.clusters[j].B for j in js])
        By = xf_matmul(Bs, y)
        for i, j in enumerate(js):
            out[j] = By[i]
    return out


def compute_residuals(problem: SDPProblem, x, X, y, A_Y, mm=xf_matmul, Y=None):
    """P = sum A_i x_i - X - C;  p = b - B^T x;  d = c - Tr(A_* Y) - By.
    The trace term uses the fast diag-pairing path when A_Y is given;
    pass A_Y=None with the Y blocks for the generic trace."""
    info = problem.info
    P = compute_weighted_A(problem, x, mm)
    for j in range(info.J):
        for l in range(info.L[j]):
            t = xf_add(P[j][l], -X[j][l])
            if problem.C_blocks is not None:
                t = xf_add(t, -problem.C_blocks[j][l])
            P[j][l] = t

    p = problem.b
    for js in cluster_groups(info):
        Bs = stack_xf([problem.clusters[j].B for j in js])
        xs = stack_xf([_x_slice(x, info, j) for j in js])
        p = xf_add(p, -xf_sum(xf_matmul(Bs.mT, xs), axis=0))

    cs = _cat0([problem.clusters[j].c for j in range(info.J)])
    By = _cat0(_group_By(problem, y))
    if A_Y is not None:
        tr = compute_trace_A_diag(problem, A_Y)
    else:
        tr = compute_trace_A_generic(problem, Y, mm)
    d = xf_add(xf_add(cs, -By), -tr)
    return P, p, d


def compute_direction_zrhs(problem, P, p, d, R, X_inv, Y, mm=xf_matmul):
    """Direction stage 1: Z = Sym(X^-1 (P Y - R)), rhs_x = -d - Tr(A_* Z),
    rhs_y = p."""
    Z = map_blocks(
        lambda Pb, Yb, Rb, Xib: xf_sym(
            xf_matmul(Xib, xf_add(xf_matmul(Pb, Yb), -Rb))),
        problem.info, P, Y, R, X_inv,
    )
    rhs_x = xf_add(-d, -compute_trace_A_generic(problem, Z, mm))
    return rhs_x, p


def compute_direction_solve(problem, rhs_x, rhs_y, decomp, refine_steps: int = 1):
    """Direction stage 2: the saddle solve of [S -B; B^T 0] (dx; dy) =
    (rhs_x; rhs_y) from the materialized inverses, with iterative
    refinement; returns (dx concatenated, dy)."""
    info = problem.info
    groups = cluster_groups(info)

    def saddle_solve(rx, ry):
        temp_x: List[Any] = [None] * info.J
        acc = None
        for js in groups:
            Sis = stack_xf([decomp["S_inv"][j] for j in js])
            rjs = stack_xf([_x_slice(rx, info, j) for j in js])
            Bs = stack_xf([problem.clusters[j].B for j in js])
            txs = xf_matmul(Sis, rjs)
            a = xf_sum(xf_matmul(Bs.mT, txs), axis=0)
            for i, j in enumerate(js):
                temp_x[j] = txs[i]
            acc = a if acc is None else xf_add(acc, a)
        dy_ = xf_matmul(decomp["Q_inv"], xf_add(ry, -acc))
        dxs_: List[Any] = [None] * info.J
        for js in groups:
            SBs = stack_xf([decomp["S_inv_B"][j] for j in js])
            txs = stack_xf([temp_x[j] for j in js])
            outs = xf_add(txs, xf_matmul(SBs, dy_))
            for i, j in enumerate(js):
                dxs_[j] = outs[i]
        return dxs_, dy_

    def saddle_residual(dxs_, dy_):
        """rx - (S dx - B dy), ry - B^T dx — the true system residual."""
        rxs: List[Any] = [None] * info.J
        accb = None
        for js in groups:
            Sms = stack_xf([decomp["S_mat"][j] for j in js])
            Bs = stack_xf([problem.clusters[j].B for j in js])
            dxb = stack_xf([dxs_[j] for j in js])
            rjs = stack_xf([_x_slice(rhs_x, info, j) for j in js])
            outs = xf_add(rjs, xf_add(-xf_matmul(Sms, dxb), xf_matmul(Bs, dy_)))
            a = xf_sum(xf_matmul(Bs.mT, dxb), axis=0)
            for i, j in enumerate(js):
                rxs[j] = outs[i]
            accb = a if accb is None else xf_add(accb, a)
        return _cat0(rxs), xf_add(rhs_y, -accb)

    dxs, dy = saddle_solve(rhs_x, rhs_y)
    # iterative refinement: one round squares the effective solve accuracy
    for _ in range(refine_steps):
        rx_full, ry_full = saddle_residual(dxs, dy)
        ddxs, ddy = saddle_solve(rx_full, ry_full)
        dxs = [xf_add(dxs[j], ddxs[j]) for j in range(info.J)]
        dy = xf_add(dy, ddy)
    return _cat0(dxs), dy


def compute_direction_dxdy(problem, P, R, X_inv, Y, dx, mm=xf_matmul):
    """Direction stage 3: dX = P + sum_i dx_i A_i, dY = Sym(X^-1 (R - dX Y))."""
    dX = compute_weighted_A(problem, dx, mm)
    dX = bd_map(xf_add, dX, P)
    dY = map_blocks(
        lambda Rb, dXb, Yb, Xib: xf_sym(
            xf_matmul(Xib, xf_add(Rb, -xf_matmul(dXb, Yb)))),
        problem.info, R, dX, Y, X_inv,
    )
    return dX, dY


def compute_search_direction(problem, P, p, d, R, X_inv, Y, decomp,
                             refine_steps: int = 1, mm=xf_matmul):
    """Predictor/corrector direction via the saddle-point factorization."""
    rhs_x, rhs_y = compute_direction_zrhs(problem, P, p, d, R, X_inv, Y, mm)
    dx, dy = compute_direction_solve(problem, rhs_x, rhs_y, decomp, refine_steps)
    dX, dY = compute_direction_dxdy(problem, P, R, X_inv, Y, dx, mm)
    return dx, dX, dy, dY


def _alpha(lam: torch.Tensor, gamma: float) -> torch.Tensor:
    """alpha = min(1, -gamma/lambda_min) as a 0-dim float64 tensor."""
    alpha = torch.where(lam > -gamma, 1.0, -gamma / torch.clamp(lam, max=-1e-300))
    return torch.clamp(alpha, max=1.0)


def _step_lambdas(sides, info: BlockInfo, use_cuda: bool):
    """(lambda_min, ok) of each side (M, dM) over its blocks: the K7 route
    (one launch for every side) or xf_min_eig_sym, one side after the
    other."""
    if use_cuda:
        return _step_length_lambda_cuda(sides, info)
    return [map_block_scalar(xf_min_eig_sym, info, M, dM) for M, dM in sides]


def compute_step_length(M, dM, gamma: float, info: BlockInfo, use_cuda: bool = False):
    """alpha = min(1, -gamma/lambda_min), lambda_min over all blocks.
    Returns (alpha as a 0-dim float64 tensor, ok).  use_cuda takes the
    K7 route at every limb count: the reference keeps float64 limbs off
    its Pallas route (solver.py:705-710), the port has no other limbs."""
    (lam, ok), = _step_lambdas([(M, dM)], info, use_cuda)
    return _alpha(lam, gamma), ok


def compute_step_lengths(X, dX, Y, dY, gamma: float, info: BlockInfo,
                         use_cuda: bool = False):
    """compute_step_length of (X, dX) and of (Y, dY) in one call:
    (alpha_p, ok_p, alpha_d, ok_d), bit for bit the two calls; on the K7
    route the blocks of both sides go in one launch."""
    (lam_p, ok_p), (lam_d, ok_d) = _step_lambdas([(X, dX), (Y, dY)], info, use_cuda)
    return _alpha(lam_p, gamma), ok_p, _alpha(lam_d, gamma), ok_d


def _step_length_lambda_cuda(sides, info: BlockInfo):
    """lambda_min and ok of each side (M, dM) through K7
    (solver._step_length_lambda_pallas): one K7 launch for every block of
    size > 1 of every side, read where it lies, gives L^-1 dM L^-T in
    float64, one (B, n, n) view per side and block-size group, whose
    symmetric part goes to the float64 Jacobi bound as one batch per side
    and group; scalar blocks take xf_min_eig_sym (lambda = dM/M, nothing to
    fuse)."""
    groups = block_groups(info)
    sandwiches = iter(steplen_sandwich_xf_groups(
        [([M[j][l].limbs for (j, l) in jls], [dM[j][l].limbs for (j, l) in jls])
         for M, dM in sides for size, jls in groups.items() if size > 1]))
    out = []
    for M, dM in sides:
        val = ok = None
        for size, jls in groups.items():
            if size == 1:
                lam, okb = xf_min_eig_sym(stack_xf([M[j][l] for (j, l) in jls]),
                                          stack_xf([dM[j][l] for (j, l) in jls]))
            else:
                W, okb = next(sandwiches)
                lam = jacobi_min_eig((W + W.transpose(-1, -2)) * 0.5)
            v, okg = torch.amin(lam), torch.all(okb)
            val = v if val is None else torch.minimum(val, v)
            ok = okg if ok is None else ok & okg
        out.append((val, ok))
    return out


def compute_error_bd(P) -> XF:
    """max |entry| over a block-diagonal."""
    e = None
    for row in P:
        for b in row:
            m = xf_norm_max(b)
            e = m if e is None else xf_max(e, m)
    return e


def compute_primal_objective(problem: SDPProblem, x: XF) -> XF:
    cs = _cat0([problem.clusters[j].c for j in range(problem.info.J)])
    return xf_add(xf_dot(cs, x), problem.b0)


def compute_dual_objective(problem: SDPProblem, y: XF, Y) -> XF:
    obj = xf_add(xf_dot(problem.b, y), problem.b0)
    if problem.C_blocks is not None:
        obj = xf_add(obj, bd_dot(problem.C_blocks, Y))
    return obj


def compute_duality_gap(p_obj: XF, d_obj: XF) -> XF:
    """|p - d| / max(1, |p + d|)."""
    num = xf_abs(xf_add(p_obj, -d_obj))
    den = xf_max(XF.ones((), k=p_obj.k, device=p_obj.device),
                 xf_abs(xf_add(p_obj, d_obj)))
    return xf_div(num, den)


# ---------------------------------------------------------------------------
# The iteration's phases
# ---------------------------------------------------------------------------


def make_ipm_phases(problem: SDPProblem, cfg: SolverConfig):
    """The per-phase functions of one IPM iteration for this problem (the
    reference's separately-jitted phases, run eagerly here; the host-side
    phase boundaries give the per-phase timings)."""
    info = problem.info
    k = problem.b.k
    dev = problem.device
    use_cuda = cfg.use_cuda_kernels(dev)
    mm = matmul_route(use_cuda, cfg.use_mxu_matmul)
    # the iteration's constants, made once on the problem's device (fills,
    # no host-to-device copy)
    Ktot = XF.from_float(float(info.total_psd_size), k=k, device=dev)
    beta_inf = XF.from_float(cfg.beta_infeasible, k=k, device=dev)
    beta_fea = XF.from_float(cfg.beta_feasible, k=k, device=dev)
    one = XF.ones((), k=k, device=dev)
    zero = XF.zeros((), k=k, device=dev)

    def phase_mu_R_Xinv(problem, state, pd_feas):
        x, y, X, Y = state
        mu = xf_div(bd_dot(X, Y), Ktot)
        mu_p = xf_where(pd_feas, zero, xf_mul(mu, beta_inf))
        R = compute_residual_R(X, Y, mu_p, info)
        X_inv, ok_inv = compute_X_inv(X, info, cfg.use_lu_inverse,
                                      cfg.use_cuda_inverse)
        return mu, R, X_inv, ok_inv

    def phase_decomp(problem, X_inv, Y):
        return compute_decomposition(problem, X_inv, Y, cfg.use_lu_schur, use_cuda, mm)

    def phase_residuals(problem, x, X, y, A_Y):
        return compute_residuals(problem, x, X, y, A_Y, mm)

    def phase_direction(problem, P, p, d, R, X_inv, Y, decomp):
        return compute_search_direction(problem, P, p, d, R, X_inv, Y, decomp,
                                        cfg.refine_steps, mm)

    def phase_corrector_R(X, Y, dX, dY, mu, pd_feas):
        XdX = bd_map(xf_add, X, dX)
        YdY = bd_map(xf_add, Y, dY)
        r = xf_div(bd_dot(XdX, YdY), xf_mul(mu, Ktot))
        beta = xf_where(r < one, xf_mul(r, r), r)
        beta_c = xf_where(pd_feas, xf_min(xf_max(beta_fea, beta), one),
                          xf_max(beta_inf, beta))
        mu_c = xf_mul(beta_c, mu)
        R2 = compute_residual_R(X, Y, mu_c, info, dX, dY)
        return beta_c, R2

    def phase_steplength(X, dX, Y, dY):
        return compute_step_lengths(X, dX, Y, dY, cfg.gamma, info, cfg.use_cuda_steplength)

    def phase_update(problem, state, dx, dy, dX, dY, alpha_p, alpha_d, pd_feas,
                     P, p, d, mu, beta_c):
        x, y, X, Y = state
        both = torch.minimum(alpha_p, alpha_d)
        if not isinstance(pd_feas, torch.Tensor):  # the phase driver's bool
            pd_feas = torch.full((), bool(pd_feas), device=dev)
        alpha_p = torch.where(pd_feas, both, alpha_p)
        alpha_d = torch.where(pd_feas, both, alpha_d)
        ap = XF.from_float(alpha_p, k=k)
        ad = XF.from_float(alpha_d, k=k)
        x_new = xf_add(x, xf_mul(dx, ap))
        y_new = xf_add(y, xf_mul(dy, ad))
        X_new = bd_map(lambda Xb, dXb: xf_add(Xb, xf_mul(dXb, ap)), X, dX)
        Y_new = bd_map(lambda Yb, dYb: xf_add(Yb, xf_mul(dYb, ad)), Y, dY)

        p_obj = compute_primal_objective(problem, x_new)
        d_obj = compute_dual_objective(problem, y_new, Y_new)
        gap = compute_duality_gap(p_obj, d_obj)
        P_err = compute_error_bd(P)
        p_err = xf_norm_max(p)
        d_err = xf_norm_max(d)
        primal_err = xf_max(P_err, p_err)
        diag = dict(
            mu=mu.to_float64(),
            p_obj=p_obj.to_float64(),
            d_obj=d_obj.to_float64(),
            gap=gap.to_float64(),
            P_err=P_err.to_float64(),
            p_err=p_err.to_float64(),
            d_err=d_err.to_float64(),
            primal_err=primal_err.limbs[0],
            dual_err=d_err.limbs[0],
            alpha_p=alpha_p,
            alpha_d=alpha_d,
            beta_c=beta_c.to_float64(),
        )
        return (x_new, y_new, X_new, Y_new), diag

    phases = dict(
        mu_R_Xinv=phase_mu_R_Xinv,
        decomp=phase_decomp,
        residuals=phase_residuals,
        direction=phase_direction,
        corrector_R=phase_corrector_R,
        steplength=phase_steplength,
        update=phase_update,
    )
    if cfg.use_cuda_elemwise:
        phases = {name: _with_elemwise_cuda(fn) for name, fn in phases.items()}
    return phases


def _with_elemwise_cuda(fn):
    """fn with every xf_add/xf_mul it makes sent through K8."""

    def run(*args):
        with elemwise_cuda():
            return fn(*args)

    return run


def make_fused_step(problem: SDPProblem, cfg: SolverConfig):
    """One whole IPM iteration as one call (solver.py:965-990 of the
    reference, run eagerly): fn(state, pd_feas) -> (state', diag), with
    diag["ok"] the conjunction of every factorization's flag.  pd_feas is a
    0-dim bool tensor on the problem's device (or a Python bool, as the
    phase driver passes it) and every flag stays on the device: nothing in
    the step reads a value back to the host, so its launches queue without
    waiting (core/device_loop.py runs it ``chunk`` times between reads)."""
    phases = make_ipm_phases(problem, cfg)

    def step(state, pd_feas):
        x, y, X, Y = state
        mu, R, X_inv, ok_inv = phases["mu_R_Xinv"](problem, state, pd_feas)
        decomp = phases["decomp"](problem, X_inv, Y)
        P, p, d = phases["residuals"](problem, x, X, y, decomp["A_Y"])
        dx, dX, dy, dY = phases["direction"](problem, P, p, d, R, X_inv, Y, decomp)
        beta_c, R2 = phases["corrector_R"](X, Y, dX, dY, mu, pd_feas)
        dx, dX, dy, dY = phases["direction"](problem, P, p, d, R2, X_inv, Y, decomp)
        alpha_p, ok_p, alpha_d, ok_d = phases["steplength"](X, dX, Y, dY)
        new_state, diag = phases["update"](problem, state, dx, dy, dX, dY, alpha_p,
                                           alpha_d, pd_feas, P, p, d, mu, beta_c)
        diag["ok"] = ok_inv & decomp["ok"] & ok_p & ok_d
        return new_state, diag

    return step


def solve_device(device, caller: str):
    """The device to pack a problem on: ``device``, or the CUDA card when it
    is None.  On a machine without a card, asking for it raises (caller
    names the entry point) instead of running on the CPU."""
    if device is None:
        device = "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device; pass device='cpu' to solve on the CPU")
    return device


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, XF):
        yield tree.limbs
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def classify_failure(kind: str, *tensors) -> str:
    """"overflow:<kind>" if a leading limb is not finite, else
    "numerical_failure:<kind>" (a factorization that is genuinely not
    SPD at this precision)."""
    for t in tensors:
        for arr in _leaves(t):
            lead = arr[0] if arr.ndim else arr
            if not bool(torch.all(torch.isfinite(lead))):
                return f"overflow:{kind}"
    return f"numerical_failure:{kind}"


def initial_state(problem: SDPProblem, cfg: SolverConfig):
    """Cold start (MPMP.jl:659-686)."""
    info = problem.info
    k = problem.b.k
    dev = problem.device
    x = XF.zeros((info.total_dim_S, 1), k=k, device=dev)
    y = XF.zeros((info.n_y, 1), k=k, device=dev)
    X = bd_scalar_identity(info, cfg.omega_p, k=k, device=dev)
    Y = bd_scalar_identity(info, cfg.omega_d, k=k, device=dev)
    return x, y, X, Y


@dataclass
class SolveResult:
    """Return bundle mirroring the reference's tuple (MPMP.jl:1014-1024).
    P, p, d are the residuals at the returned iterate in the solver's
    internal (preconditioned) coordinates; x and y are in user
    coordinates."""

    x: XF
    X: Any
    y: XF
    Y: Any
    P: Any
    p: XF
    d: XF
    dual_gap: float
    primal_objective: float
    dual_objective: float
    time_total: float
    iterations: int
    converged: bool
    status: str
    history: List[Dict[str, float]] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict)


_HISTORY_KEYS = ("mu", "p_obj", "d_obj", "gap", "P_err", "p_err", "d_err",
                 "alpha_p", "alpha_d", "beta_c", "primal_err", "dual_err")


def solverank1sdp(
    constraints=None,
    b=None,
    blockinfo: Optional[BlockInfo] = None,
    problem: Optional[SDPProblem] = None,
    C=None,
    b0=0,
    initial_solutions=(),
    precision_k: int = 2,
    device=None,
    **kwargs,
) -> SolveResult:
    """Solve the clustered low-rank SDP.

    Two entry forms, as the reference: solverank1sdp(constraints, b,
    blockinfo; ...) with constraints[j] = (A, B, c, H) host data, packed
    in ``precision_k`` limbs (2..12) onto ``device`` (default the CUDA
    card; a machine without one raises, and device="cpu" runs on the
    CPU), or solverank1sdp(problem=SDPProblem) on the problem's own
    device.
    """
    cfg = SolverConfig(**kwargs)
    if problem is None:
        from clrs_tpu_torch.core.problem import pack_constraints

        problem = pack_constraints(constraints, b, info=blockinfo, C=C, b0=b0,
                                   k=precision_k,
                                   device=solve_device(device, "solverank1sdp"))
    elif device is not None:
        problem = problem.to(device)
    dev = problem.device
    on_cuda = dev.type == "cuda"

    if len(initial_solutions) == 4:
        state = list(initial_solutions)
        if problem.x_sigma is not None:
            state[0] = xf_mul(state[0], problem.x_sigma)  # user -> internal
        if problem.y_R is not None:
            state[1] = xf_matmul(problem.y_R, state[1])
        state = tuple(state)
    else:
        state = initial_state(problem, cfg)

    phases = make_ipm_phases(problem, cfg)

    if cfg.verbose:
        print(
            f"{'iter':>5} {'time(s)':>8} {'mu':>11} {'P-obj':>11} {'D-obj':>11} "
            f"{'gap':>10} {'P-error':>10} {'p-error':>10} {'d-error':>10} "
            f"{'alpha_p':>10} {'alpha_d':>10} {'beta':>10}"
        )

    t0 = time.time()
    itn = 0
    pd_feas = False
    converged = False
    status = "max_iterations"
    gap = np.inf
    history: List[Dict[str, float]] = []
    best_merit = np.inf
    best_state = state
    best_row = None
    best_res = (None, None, None)  # (P, p, d) at the best iterate
    last_res = (None, None, None)
    stall_count = 0
    # per-phase wall-clock buckets; the first 2 iterations are excluded
    timings: Dict[str, float] = {}
    iter_times: Dict[str, float] = {}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        if on_cuda:
            torch.cuda.synchronize(dev)
        dt = time.time() - t
        if itn > 2:
            timings[name] = timings.get(name, 0.0) + dt
        iter_times[name] = iter_times.get(name, 0.0) + dt
        return out

    def switch(field_name, message):
        nonlocal cfg, phases
        if cfg.verbose:
            print(message)
        cfg = dataclasses.replace(cfg, **{field_name: True})
        phases = make_ipm_phases(problem, cfg)

    while itn < cfg.maxiterations:
        itn += 1
        iter_times = {}
        mu, R, X_inv, ok_inv = timed("Xinv+R", phases["mu_R_Xinv"], problem,
                                     state, pd_feas)
        if not bool(ok_inv):
            status = classify_failure("Xinv", state, mu)
            if status.startswith("overflow"):
                break
            # sticky degradation ladder: Cholesky-based inverse failed ->
            # LU for the rest of the run
            if not cfg.use_lu_inverse:
                switch("use_lu_inverse",
                       "X^-1 Cholesky failed — switching to LU inverse")
                itn -= 1
                continue
            break
        decomp = timed("decomp", phases["decomp"], problem, X_inv, state[3])
        if not bool(decomp["ok"]):
            status = classify_failure("schur_factorization", X_inv, decomp["S_mat"])
            if status.startswith("overflow"):
                break
            if not cfg.use_lu_schur:
                switch("use_lu_schur", "Schur Cholesky failed — switching to "
                       "LU factorization for S and Q")
                itn -= 1
                continue
            break
        P, p, d = timed("residuals", phases["residuals"], problem, state[0],
                        state[2], state[1], decomp["A_Y"])

        dx, dX, dy, dY = timed("predictor_dir", phases["direction"], problem,
                               P, p, d, R, X_inv, state[3], decomp)
        beta_c, R2 = timed("corrector_R", phases["corrector_R"], state[2],
                           state[3], dX, dY, mu, pd_feas)
        dx, dX, dy, dY = timed("corrector_dir", phases["direction"], problem,
                               P, p, d, R2, X_inv, state[3], decomp)
        alpha_p, ok_p, alpha_d, ok_d = timed("alpha", phases["steplength"], state[2], dX,
                                             state[3], dY)
        if not (bool(ok_p) and bool(ok_d)):
            status = classify_failure("steplength", dX, dY)
            break
        # this iteration's P/p/d (and the merit below) measure the
        # PRE-update iterate; the stall guard must return that state
        prev_state = state
        state, diag = timed("update", phases["update"], problem, state, dx, dy,
                            dX, dY, alpha_p, alpha_d, pd_feas, P, p, d, mu, beta_c)
        vals = dict(zip(_HISTORY_KEYS, torch.stack(
            [diag[name].reshape(()) for name in _HISTORY_KEYS]).tolist()))
        gap = vals["gap"]
        primal_err = vals["primal_err"]
        dual_err = vals["dual_err"]
        row = dict(
            iter=itn,
            time=time.time() - t0,
            mu=vals["mu"],
            p_obj=vals["p_obj"],
            d_obj=vals["d_obj"],
            gap=gap,
            P_err=vals["P_err"],
            p_err=vals["p_err"],
            d_err=vals["d_err"],
            alpha_p=vals["alpha_p"],
            alpha_d=vals["alpha_d"],
            beta=vals["beta_c"],
        )
        history.append(row)
        last_res = (P, p, d)
        if cfg.verbose:
            print(
                f"{itn:5d} {row['time']:8.1f} {row['mu']:11.3e} "
                f"{row['p_obj']:11.3e} {row['d_obj']:11.3e} {gap:10.2e} "
                f"{row['P_err']:10.2e} {row['p_err']:10.2e} {row['d_err']:10.2e} "
                f"{row['alpha_p']:10.2e} {row['alpha_d']:10.2e} {row['beta']:10.2e}"
            )
        if cfg.testing and itn <= 5:
            print("  phases: "
                  + " ".join(f"{n}={t:.3f}s" for n, t in iter_times.items()))

        # stall safeguard: once progress stops, keep the best iterate
        merit = max(gap, primal_err, dual_err)
        if not np.isfinite(merit):
            merit = np.inf
        if merit < best_merit:
            best_merit = merit
            best_state = prev_state  # the state the residuals measure
            best_row = row
            best_res = (P, p, d)
            stall_count = 0
        else:
            exploded = merit > best_merit * cfg.blowup_factor
            stall_count += cfg.blowup_weight if exploded else 1
        if stall_count >= cfg.stall_patience:
            status = "stalled"
            state = best_state
            if cfg.verbose:
                print(f"no progress for {cfg.stall_patience} iterations — "
                      "returning best iterate")
            break

        primal_feas = primal_err < cfg.primal_error_threshold
        dual_feas = dual_err < cfg.dual_error_threshold
        pd_feas = primal_feas and dual_feas
        if cfg.need_primal_feasible and primal_feas:
            status = "primal_feasible"
            converged = True
            break
        if cfg.need_dual_feasible and dual_feas:
            status = "dual_feasible"
            converged = True
            break
        if primal_feas and dual_feas and gap < cfg.duality_gap_threshold:
            status = "optimal"
            converged = True
            break

    degraded = (status.startswith(("numerical_failure", "overflow"))
                or status == "stalled")
    if degraded and best_row is not None:
        # hand back the best iterate, with its objectives and gap
        # recomputed at that (pre-update) state
        state = best_state
        bp_obj = compute_primal_objective(problem, best_state[0])
        bd_obj = compute_dual_objective(problem, best_state[1], best_state[3])
        gap = float(compute_duality_gap(bp_obj, bd_obj).limbs[0])
        best_row = dict(best_row, gap=gap, p_obj=float(bp_obj.to_float64()),
                        d_obj=float(bd_obj.to_float64()))

    time_total = time.time() - t0
    if cfg.verbose:
        print(f"status: {status}  iterations: {itn}  time: {time_total:.2f}s")
        if timings:
            print("time per phase (excl. first 2 iterations):")
            for name, tval in sorted(timings.items(), key=lambda kv: -kv[1]):
                print(f"  {name:>14}: {tval:9.3f}s")

    report_row = history[-1] if history else None
    res_out = last_res
    if degraded and best_row is not None:
        report_row = best_row
        res_out = best_res

    x, y, X, Y = state
    if problem.x_sigma is not None:
        x = xf_div(x, problem.x_sigma)  # internal -> user-facing scaling
    if problem.y_R_inv is not None:
        y = xf_matmul(problem.y_R_inv, y)
    return SolveResult(
        x=x, X=X, y=y, Y=Y,
        P=res_out[0], p=res_out[1], d=res_out[2],
        dual_gap=gap,
        primal_objective=report_row["p_obj"] if report_row else float("nan"),
        dual_objective=report_row["d_obj"] if report_row else float("nan"),
        time_total=time_total,
        iterations=itn,
        converged=converged,
        status=status,
        history=history,
        timings=timings,
    )
