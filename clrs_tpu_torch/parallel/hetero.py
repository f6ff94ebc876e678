"""Heterogeneous cluster-sharded IPM step over ranks (torch.distributed).

Counterpart of ``clrs_tpu/parallel/hetero.py``, and the port's path for
running its applications over several cards.  Clusters are grouped into
*bundles* of one shape signature (m, K, per-l delta/rmax), stacked on a
batch axis, and every bundle's cluster axis is split over the ranks of
one process group: each rank holds a contiguous slice of every bundle on
its own device and runs the per-bundle work there, the slice's clusters a
batch axis of the port's functions (core/kernels.py, ops/linalg.py, the
kernels' wrappers) where the reference ``jax.vmap``s a per-cluster
function.  The cross-cluster reductions (p-partials, Q-partials, the dy
rhs, the step length's min, the scalar dots) are the only communication,
all O(n_y^2) or smaller (parallel/sharded.py's collectives).

A bundle whose cluster count does not divide the ranks is padded with
dummy clusters (V=H=B=c=0) carried by a ``valid`` mask:
  - the padded Schur block gets +I (else S is singular);
  - the padded primal residual P is masked to 0 (else dX=-X caps alpha);
  - padded step-length eigenvalues are masked to +inf.
``allsum`` drops the padded slots after its gather and sums the real
clusters in canonical order, so every rank count gives the one-rank sum,
and every iterate the same bits (the reference sums the padded axis,
whose tree changes with the device count).

The step reaches the kernels as core/solver.make_ipm_phases does: K2 for
the Schur blocks, K3 (k=2) or K4 (k >= 3) for the pairing, weighted-A and
trace-A products, K1 (k=2) or K5 (k >= 3, its panel route above the cap)
for S_j^-1 and Q^-1 under cfg.use_cuda_kernels(device); K1/K5 for X^-1
under use_cuda_inverse, K7 for the step lengths' sandwich under
use_cuda_steplength and K8 for every k-limb add and multiply under
use_cuda_elemwise.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clrs_tpu_torch.core.batched import stack_xf
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
from clrs_tpu_torch.core.problem import SDPProblem
from clrs_tpu_torch.core.solver import (
    SolveResult,
    SolverConfig,
    _alpha,
    _cuda_spd_inverse,
    compute_dual_objective,
    compute_duality_gap,
    compute_primal_objective,
    compute_residuals,
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
    xf_add,
    xf_div,
    xf_matmul,
    xf_mul,
    xf_sum,
    xf_where,
)
from clrs_tpu_torch.parallel.sharded import (
    allgather,
    allmax,
    allmin,
    allsum,
    alltrue,
    per_cluster_sum,
    world,
)


@dataclass(frozen=True)
class BundleShape:
    """Shape signature of one cluster bundle."""

    J: int  # cluster slots over all ranks, divisibility padding included
    J_real: int  # clusters that carry real data
    m: int
    K: int
    deltas: Tuple[int, ...]  # per inner block l
    rmaxs: Tuple[int, ...]

    @property
    def L(self) -> int:
        return len(self.deltas)

    @property
    def npairs(self) -> int:
        return self.m * (self.m + 1) // 2

    @property
    def dim_S(self) -> int:
        return self.npairs * self.K

    def bs(self, l: int) -> int:
        return self.m * self.deltas[l]

    @property
    def psd_size(self) -> int:
        return sum(self.bs(l) for l in range(self.L))


def _signature(info: BlockInfo, j: int):
    return (info.m[j], info.n_samples[j], tuple(info.delta[j]), tuple(info.rmax[j]))


def bundles_from_problem(
    problem: SDPProblem, group=None
) -> Tuple[List[BundleShape], List[Dict[str, Any]], List[List[int]]]:
    """Group a packed problem's clusters into homogeneous bundles, each
    padded to a multiple of the group's ranks, and build this rank's slice
    of each on the problem's device.

    Returns (shapes, data, owners): data[b] holds this rank's slots of
    bundle b (V, H, C per l, B, c, and the valid mask); owners[b] lists the
    original cluster indices j of bundle b's real slots, over all ranks
    (for scattering x back)."""
    n, rank = world(group)
    info = problem.info
    groups: Dict[tuple, List[int]] = {}
    for j in range(info.J):
        groups.setdefault(_signature(info, j), []).append(j)

    shapes: List[BundleShape] = []
    data: List[Dict[str, Any]] = []
    owners: List[List[int]] = []
    k, dev = problem.b.k, problem.device
    for sig, js in groups.items():
        m, K, deltas, rmaxs = sig
        J_real = len(js)
        J = -(-J_real // n) * n  # round up
        shape = BundleShape(J=J, J_real=J_real, m=m, K=K, deltas=deltas, rmaxs=rmaxs)
        per = J // n
        slots = range(rank * per, (rank + 1) * per)
        mine = [js[s] if s < J_real else None for s in slots]

        def padstack(leaf, zshape) -> XF:
            return stack_xf([leaf(j) if j is not None else XF.zeros(zshape, k=k, device=dev)
                             for j in mine])

        cl = problem.clusters
        entry = dict(
            V=tuple(padstack(lambda j, l=l: cl[j].Vs[l], (deltas[l], K * rmaxs[l]))
                    for l in range(shape.L)),
            H=tuple(padstack(lambda j, l=l: cl[j].Hs[l], (K * rmaxs[l],))
                    for l in range(shape.L)),
            B=padstack(lambda j: cl[j].B, (shape.dim_S, info.n_y)),
            c=padstack(lambda j: cl[j].c, (shape.dim_S, 1)),
            valid=torch.tensor([float(j is not None) for j in mine], dtype=torch.float64,
                               device=dev),
        )
        if problem.C_blocks is not None:
            # cost matrix C: padded clusters carry C=0
            entry["C"] = tuple(
                padstack(lambda j, l=l: problem.C_blocks[j][l], (shape.bs(l), shape.bs(l)))
                for l in range(shape.L))
        data.append(entry)
        shapes.append(shape)
        owners.append(js)
    return shapes, data, owners


def initial_bundle_state(shapes: Sequence[BundleShape], omega_p: float, omega_d: float,
                         k: int, n_y: int, *, device, group=None):
    """Cold start of this rank's slots: x=0, y=0, X=omega_p I, Y=omega_d I
    (padded slots too; they are masked)."""
    n, _ = world(group)
    bstates = []
    for sh in shapes:
        per = sh.J // n
        x = XF.zeros((per, sh.dim_S, 1), k=k, device=device)
        Xs, Ys = [], []
        for l in range(sh.L):
            eye = torch.eye(sh.bs(l), dtype=torch.float64, device=device).expand(
                per, sh.bs(l), sh.bs(l))
            Xs.append(XF.from_float(eye * omega_p, k=k))
            Ys.append(XF.from_float(eye * omega_d, k=k))
        bstates.append((x, tuple(Xs), tuple(Ys)))
    y = XF.zeros((n_y, 1), k=k, device=device)
    return tuple(bstates), y


DIAG_KEYS = ("mu", "p_obj", "d_obj", "gap", "P_err", "p_err", "d_err", "alpha_p",
             "alpha_d", "ok", "ok_inv", "ok_schur")


def make_hetero_step(shapes: Sequence[BundleShape], b: XF, cfg=None, b0: Optional[XF] = None,
                     has_C: bool = False, group=None):
    """Build the cluster-sharded IPM step over all bundles.

      step(data, state, pd_feas) -> ((bstates, y), diag)

    with bstates[b] = (x_b, X_b tuple, Y_b tuple), this rank's slots, and
    diag the DIAG_KEYS as 0-dim tensors on b's device.  As core/solver.py:
    C blocks and b0 in the residuals and the dual objective (has_C), saddle
    refinement (cfg.refine_steps), and the Cholesky->LU ladders
    (cfg.use_lu_inverse / cfg.use_lu_schur; diag reports ok_inv and
    ok_schur apart so that the driver switches the right one)."""
    cfg = cfg or SolverConfig()
    k, dev = b.k, b.device
    n_y = b.shape[0]
    use_cuda = cfg.use_cuda_kernels(dev)
    mm = matmul_route(use_cuda)
    nB = len(shapes)
    if cfg.use_lu_schur:
        inv_s = xf_inverse_lu
    elif use_cuda:
        inv_s = _cuda_spd_inverse
    else:
        inv_s = xf_spd_inverse
    # the iteration's constants, made once on b's device
    Ktot = XF.from_float(float(sum(sh.J_real * sh.psd_size for sh in shapes)), k=k, device=dev)
    zero = XF.zeros((), k=k, device=dev)
    one = XF.ones((), k=k, device=dev)
    bF = XF.from_float(cfg.beta_feasible, k=k, device=dev)
    bI = XF.from_float(cfg.beta_infeasible, k=k, device=dev)
    eyes = {n: XF.eye(n, k=k, device=dev)
            for sh in shapes for n in [sh.dim_S] + [sh.bs(l) for l in range(sh.L)]}
    inf = torch.full((), float("inf"), dtype=torch.float64, device=dev)

    def asum(v: XF, sh: BundleShape) -> XF:
        return allsum(v, sh.J_real, group)

    def add_all(parts: List[XF]) -> XF:
        out = parts[0]
        for t in parts[1:]:
            out = xf_add(out, t)
        return out

    def x_inverse(X: XF):
        if cfg.use_lu_inverse:
            inv, ok = xf_inverse_lu(X)
            return xf_sym(inv), ok
        if cfg.use_cuda_inverse:
            inv, ok = xf_spd_inverse_batched(X.limbs)
            return XF(inv), ok
        inv, ok = xf_spd_inverse(X)
        return xf_sym(inv), ok

    def step_ranks(data, state, pd_feas):
        bstates, y = state

        # ---- mu = <X, Y> / Ktot over the real clusters of all bundles ----
        mu = xf_div(add_all([
            asum(add_all([per_cluster_sum(xf_mul(Xs[l], Ys[l])) for l in range(sh.L)]), sh)
            for sh, (_, Xs, Ys) in zip(shapes, bstates)]), Ktot)
        mu_p = xf_where(pd_feas, zero, xf_mul(mu, bI))

        # ---- per bundle: R, X^-1, decomposition, residual pieces ----
        oks_inv, oks_schur = [], []
        ws: List[Dict[str, Any]] = [dict() for _ in range(nB)]
        Q = XF.zeros((n_y, n_y), k=k, device=dev)
        p_parts = []
        for bi, sh in enumerate(shapes):
            x_b, Xs, Ys = bstates[bi]
            d_b, w = data[bi], ws[bi]
            valid = d_b["valid"]
            m, K = sh.m, sh.K
            w["R"] = [xf_add(xf_mul(eyes[sh.bs(l)], mu_p), -xf_matmul(Xs[l], Ys[l]))
                      for l in range(sh.L)]
            w["Xinv"] = []
            for l in range(sh.L):
                inv, oki = x_inverse(Xs[l])
                w["Xinv"].append(inv)
                oks_inv.append(torch.all(oki))

            S = XF.zeros((x_b.shape[0], sh.dim_S, sh.dim_S), k=k, device=dev)
            w["A_Y"] = []
            for l in range(sh.L):
                PX = compute_pairings(w["Xinv"][l], d_b["V"][l], m, mm)
                PY = compute_pairings(Ys[l], d_b["V"][l], m, mm)
                w["A_Y"].append(pairing_diag(PY, m))
                S = xf_add(S, schur_block_contribution(
                    PX, PY, d_b["H"][l], m, K, sh.rmaxs[l], use_cuda))
            S = xf_sym(S)
            # identity for padded clusters (S would be singular)
            S = xf_add(S, XF(eyes[sh.dim_S].limbs[:, None] * (1.0 - valid)[:, None, None]))
            S_inv, ok_s = inv_s(S)
            w["S_mat"], w["S_inv"] = S, xf_sym(S_inv)
            w["SB"] = xf_matmul(w["S_inv"], d_b["B"])
            oks_schur.append(torch.all(ok_s))
            Q = xf_add(Q, asum(xf_matmul(d_b["B"].mT, w["SB"]), sh))

            # residuals: P = sum_i x_i A_i - X - C per l (masked), p partial, d
            w["P"] = []
            for l in range(sh.L):
                P_l = xf_add(weighted_A_block(x_b[..., 0], d_b["V"][l], d_b["H"][l], m, K,
                                              sh.rmaxs[l], mm), -Xs[l])
                if has_C:
                    P_l = xf_add(P_l, -d_b["C"][l])
                w["P"].append(XF(P_l.limbs * valid[:, None, None]))
            p_parts.append(asum(xf_matmul(d_b["B"].mT, x_b), sh))
            trY = add_all([trace_A_from_diag(w["A_Y"][l], d_b["H"][l], m, K, sh.rmaxs[l])
                           for l in range(sh.L)])
            w["d"] = xf_add(xf_add(d_b["c"], -XF(trY.limbs[..., None])),
                            -xf_matmul(d_b["B"], y))

        p = xf_add(b, -add_all(p_parts))
        Q_inv, ok_q = inv_s(xf_sym(Q))
        oks_schur.append(torch.all(ok_q))

        # ---- the saddle solve from the materialized inverses ----
        def saddle_solve(rxs, ry):
            txs = [xf_matmul(w["S_inv"], rx) for w, rx in zip(ws, rxs)]
            acc = add_all([asum(xf_matmul(d_b["B"].mT, tx), sh)
                           for sh, d_b, tx in zip(shapes, data, txs)])
            dy = xf_matmul(Q_inv, xf_add(ry, -acc))
            return [xf_add(tx, xf_matmul(w["SB"], dy)) for w, tx in zip(ws, txs)], dy

        def saddle_residual(rxs, ry, dxs, dy):
            """The true system residual: rx - (S dx - B dy), ry - sum B^T dx."""
            rrs = [xf_add(rx, xf_add(-xf_matmul(w["S_mat"], dx), xf_matmul(d_b["B"], dy)))
                   for w, d_b, rx, dx in zip(ws, data, rxs, dxs)]
            accb = add_all([asum(xf_matmul(d_b["B"].mT, dx), sh)
                            for sh, d_b, dx in zip(shapes, data, dxs)])
            return rrs, xf_add(ry, -accb)

        # ---- search directions (shared by predictor and corrector) ----
        def directions(R_all):
            rxs = []
            for bi, sh in enumerate(shapes):
                _, Xs, Ys = bstates[bi]
                d_b, w = data[bi], ws[bi]
                trZ = add_all([trace_A_generic(
                    xf_sym(xf_matmul(w["Xinv"][l],
                                     xf_add(xf_matmul(w["P"][l], Ys[l]), -R_all[bi][l]))),
                    d_b["V"][l], d_b["H"][l], sh.m, sh.K, sh.rmaxs[l], mm)
                    for l in range(sh.L)])
                rxs.append(xf_add(-w["d"], -XF(trZ.limbs[..., None])))

            dxs, dy = saddle_solve(rxs, p)
            # iterative refinement: each round squares the solve's accuracy
            for _ in range(cfg.refine_steps):
                rrs, rry = saddle_residual(rxs, p, dxs, dy)
                ddxs, ddy = saddle_solve(rrs, rry)
                dxs = [xf_add(dx, ddx) for dx, ddx in zip(dxs, ddxs)]
                dy = xf_add(dy, ddy)

            outs = []
            for bi, sh in enumerate(shapes):
                _, Xs, Ys = bstates[bi]
                d_b, w = data[bi], ws[bi]
                dXs, dYs = [], []
                for l in range(sh.L):
                    dX = xf_add(weighted_A_block(dxs[bi][..., 0], d_b["V"][l], d_b["H"][l],
                                                 sh.m, sh.K, sh.rmaxs[l], mm), w["P"][l])
                    dXs.append(dX)
                    dYs.append(xf_sym(xf_matmul(
                        w["Xinv"][l], xf_add(R_all[bi][l], -xf_matmul(dX, Ys[l])))))
                outs.append((dxs[bi], tuple(dXs), tuple(dYs)))
            return outs, dy

        d_dirs, dy = directions([w["R"] for w in ws])

        # ---- corrector ----
        r = xf_div(add_all([
            asum(add_all([per_cluster_sum(xf_mul(xf_add(Xs[l], dXs[l]), xf_add(Ys[l], dYs[l])))
                          for l in range(sh.L)]), sh)
            for sh, (_, Xs, Ys), (_, dXs, dYs) in zip(shapes, bstates, d_dirs)]),
            xf_mul(mu, Ktot))
        beta = xf_where(r < one, xf_mul(r, r), r)
        beta_c = xf_where(pd_feas,
                          xf_where(beta < bF, bF, xf_where(beta < one, beta, one)),
                          xf_where(beta < bI, bI, beta))
        mu_c = xf_mul(beta_c, mu)
        R2_all = [[xf_add(xf_add(xf_mul(eyes[sh.bs(l)], mu_c), -xf_matmul(Xs[l], Ys[l])),
                          -xf_matmul(dXs[l], dYs[l])) for l in range(sh.L)]
                  for sh, (_, Xs, Ys), (_, dXs, dYs) in zip(shapes, bstates, d_dirs)]
        d_dirs, dy = directions(R2_all)

        # ---- step lengths: this rank's min eigenvalue, then the min over ranks ----
        sides = [[(Xs, dXs) for (_, Xs, _), (_, dXs, _) in zip(bstates, d_dirs)],
                 [(Ys, dYs) for (_, _, Ys), (_, _, dYs) in zip(bstates, d_dirs)]]
        lams, oks_step = _step_lambdas(shapes, data, sides, cfg.use_cuda_steplength, inf)
        lam_p, lam_d = (allmin(lam, group) for lam in lams)
        alpha_p, alpha_d = _alpha(lam_p, cfg.gamma), _alpha(lam_d, cfg.gamma)
        pd = torch.as_tensor(pd_feas, device=dev)
        both = torch.minimum(alpha_p, alpha_d)
        alpha_p = torch.where(pd, both, alpha_p)
        alpha_d = torch.where(pd, both, alpha_d)
        ap = XF.from_float(alpha_p, k=k)
        ad = XF.from_float(alpha_d, k=k)

        # ---- update and diagnostics ----
        new_bstates = []
        for (x_b, Xs, Ys), (dx, dXs, dYs) in zip(bstates, d_dirs):
            new_bstates.append((xf_add(x_b, xf_mul(dx, ap)),
                                tuple(xf_add(X, xf_mul(dX, ap)) for X, dX in zip(Xs, dXs)),
                                tuple(xf_add(Y, xf_mul(dY, ad)) for Y, dY in zip(Ys, dYs))))
        y_new = xf_add(y, xf_mul(dy, ad))
        p_obj = add_all([asum(per_cluster_sum(xf_mul(d_b["c"], x_new)), sh)
                         for sh, d_b, (x_new, _, _) in zip(shapes, data, new_bstates)])
        d_obj = xf_sum(xf_mul(b, y_new).reshape((-1,)), axis=0)
        if has_C:
            # the dual objective <b,y> + <C,Y> + b0
            for sh, d_b, (_, _, Yn) in zip(shapes, data, new_bstates):
                d_obj = xf_add(d_obj, asum(add_all([
                    per_cluster_sum(xf_mul(d_b["C"][l], Yn[l])) for l in range(sh.L)]), sh))
        if b0 is not None:
            p_obj = xf_add(p_obj, b0)
            d_obj = xf_add(d_obj, b0)
        ok_step = torch.stack(oks_step).all()
        ok_inv = alltrue(torch.stack(oks_inv).all(), group)
        ok_schur = alltrue(torch.stack(oks_schur).all(), group)
        ok = alltrue(ok_step, group) & ok_inv & ok_schur

        # feasibility errors: max-abs over the residuals' leading limbs (P
        # is masked to zero on padded clusters, d is zero there: B = c = 0;
        # p is replicated)
        P_err = allmax(torch.stack([torch.amax(torch.abs(P.limbs[0]))
                                    for w in ws for P in w["P"]]).amax(), group)
        d_err = allmax(torch.stack([torch.amax(torch.abs(w["d"].limbs[0]))
                                    for w in ws]).amax(), group)
        p_err = torch.amax(torch.abs(p.limbs[0]))
        gap = torch.abs(p_obj.limbs[0] - d_obj.limbs[0]) / torch.clamp(
            torch.abs(p_obj.limbs[0] + d_obj.limbs[0]), min=1.0)
        diag = dict(mu=mu.to_float64(), p_obj=p_obj.to_float64(), d_obj=d_obj.to_float64(),
                    gap=gap, P_err=P_err, p_err=p_err, d_err=d_err, alpha_p=alpha_p,
                    alpha_d=alpha_d, ok=ok, ok_inv=ok_inv, ok_schur=ok_schur)
        return (tuple(new_bstates), y_new), diag

    if cfg.use_cuda_elemwise:
        def step_k8(data, state, pd_feas):
            with elemwise_cuda():
                return step_ranks(data, state, pd_feas)

        return step_k8
    return step_ranks


def _step_lambdas(shapes, data, sides, use_k7: bool, inf):
    """(lambda_min over this rank's real clusters, per side) and the ok
    flags.  use_k7: one K7 launch for every block of size > 1 of both
    sides, whose float64 sandwich goes to the Jacobi bound
    (core/solver._step_length_lambda_cuda); scalar blocks, and every block
    without it, take xf_min_eig_sym."""
    sandwiches = None
    if use_k7:
        sandwiches = iter(steplen_sandwich_xf_groups(
            [(list(M.limbs.unbind(1)), list(dM.limbs.unbind(1)))
             for side in sides for (Ms, dMs), sh in zip(side, shapes)
             for l, (M, dM) in enumerate(zip(Ms, dMs)) if sh.bs(l) > 1]))
    lams, oks = [], []
    for side in sides:
        lam = inf
        for (Ms, dMs), sh, d_b in zip(side, shapes, data):
            valid = d_b["valid"] > 0
            for l, (M, dM) in enumerate(zip(Ms, dMs)):
                if sandwiches is not None and sh.bs(l) > 1:
                    W, okb = next(sandwiches)
                    lb = jacobi_min_eig((W + W.transpose(-1, -2)) * 0.5)
                else:
                    lb, okb = xf_min_eig_sym(M, dM)
                oks.append(torch.all(okb | ~valid))
                lam = torch.minimum(lam, torch.amin(torch.where(valid, lb, inf)))
        lams.append(lam)
    return lams, oks


def gather_bundle_state(state, group=None):
    """The bundled state one rank would hold: every rank's slots of each
    bundle in rank order (each bundle's padded slots at its end), y as it
    is; the identity on one rank."""
    bstates, y = state
    return tuple((allgather(x, group), tuple(allgather(X, group) for X in Xs),
                  tuple(allgather(Y, group) for Y in Ys)) for x, Xs, Ys in bstates), y


def scatter_bundle_state(problem: SDPProblem, shapes, owners, state):
    """A one-rank bundled state (x, X, Y) + y in the packed problem's
    layout: x (total_dim_S, 1), block-diagonal X/Y lists, y (n_y, 1)."""
    info = problem.info
    bstates, y = state
    x = XF.zeros((info.total_dim_S, 1), k=problem.b.k, device=problem.device)
    X_bd: List[Any] = [None] * info.J
    Y_bd: List[Any] = [None] * info.J
    for (xb, Xs, Ys), js in zip(bstates, owners):
        for slot, j in enumerate(js):
            x.limbs[:, info.x_indices[j]:info.x_indices[j + 1]] = xb.limbs[:, slot]
            X_bd[j] = [Xl[slot] for Xl in Xs]
            Y_bd[j] = [Yl[slot] for Yl in Ys]
    return x, X_bd, Y_bd, y


def solve_hetero_sharded(problem: SDPProblem, group=None, maxiterations: int = 200, cfg=None,
                         verbose: bool = False):
    """Bundle a packed problem over the group's ranks (each rank packs the
    same problem on its own device and keeps its slice) and run the step
    to convergence, checked on the host each iteration, with the core
    solver's sticky Cholesky->LU ladders (a failed factorization switches
    its ladder and retries the same iteration from the pre-step state).
    Returns a core-solver SolveResult with x and y in user coordinates.  On
    more than one rank the returned iterate is gathered once, at the end,
    so that every rank returns the one-rank result bit for bit (x, X, Y,
    the residuals and the objectives recomputed at a stall's pre-update
    iterate; the reference leaves x, X, Y out there); this rank's bundled
    slots are attached as res.raw_state."""
    cfg = cfg or SolverConfig()
    shapes, data, owners = bundles_from_problem(problem, group)
    k, dev = problem.b.k, problem.device
    has_C = problem.C_blocks is not None
    state = initial_bundle_state(shapes, cfg.omega_p, cfg.omega_d, k, problem.info.n_y,
                                 device=dev, group=group)

    def build_step(c):
        return make_hetero_step(shapes, problem.b, c, b0=problem.b0, has_C=has_C, group=group)

    step = build_step(cfg)
    pd_feas = False
    it = 0
    gap = np.inf
    t0 = time.time()
    # stall guard: keep the best iterate, as the core solver; its state is
    # the PRE-update one, which this step's residual errors measure
    best = (np.inf, None, None)  # (merit, state, history row)
    stall = 0
    history: List[Dict[str, float]] = []
    converged = False
    status = "max_iterations"
    while it < maxiterations:
        it += 1
        prev_state = state
        state, diag = step(data, state, pd_feas)
        vals = dict(zip(DIAG_KEYS, torch.stack(
            [diag[name].to(torch.float64).reshape(()) for name in DIAG_KEYS]).tolist()))
        # sticky degradation ladders: rebuild the step and retry the same
        # iteration from the pre-step state
        if not vals["ok_inv"] and not cfg.use_lu_inverse:
            if verbose:
                print("X^-1 Cholesky failed — switching to LU inverse")
            cfg = dataclasses.replace(cfg, use_lu_inverse=True)
            step, state, it = build_step(cfg), prev_state, it - 1
            continue
        if not vals["ok_schur"] and not cfg.use_lu_schur:
            if verbose:
                print("Schur Cholesky failed — switching to LU for S and Q")
            cfg = dataclasses.replace(cfg, use_lu_schur=True)
            step, state, it = build_step(cfg), prev_state, it - 1
            continue
        gap = vals["gap"]
        primal_err = max(vals["P_err"], vals["p_err"])
        dual_err = vals["d_err"]
        history.append(dict(iter=it, time=time.time() - t0,
                            **{name: vals[name] for name in DIAG_KEYS[:9]}))
        # feasibility-locked steps once both residuals vanish
        pd_feas = (primal_err < cfg.primal_error_threshold
                   and dual_err < cfg.dual_error_threshold)
        merit = max(gap, primal_err, dual_err)
        if not np.isfinite(merit):
            merit = np.inf
        if merit < best[0]:
            best = (merit, prev_state, history[-1])
            stall = 0
        else:
            stall += cfg.blowup_weight if merit > best[0] * cfg.blowup_factor else 1
        if verbose:
            print(f"iter {it}: mu={vals['mu']:.3e} p={vals['p_obj']:.12f} "
                  f"d={vals['d_obj']:.12f} gap={gap:.2e} Perr={primal_err:.1e} "
                  f"derr={dual_err:.1e}")
        if pd_feas and gap < cfg.duality_gap_threshold:
            converged = True
            status = "optimal"
            break
        if stall >= cfg.stall_patience or not vals["ok"]:
            status = "stalled" if stall >= cfg.stall_patience else "numerical_failure"
            if best[1] is not None:
                state = best[1]
                gap = best[2]["gap"]
            break

    row = best[2] if status in ("stalled", "numerical_failure") else None
    x, X_bd, Y_bd, y_out = scatter_bundle_state(problem, shapes, owners,
                                                gather_bundle_state(state, group))
    # the residuals at the returned iterate, in internal coordinates
    P_res, p_res, d_res = compute_residuals(problem, x, X_bd, y_out, None, Y=Y_bd)
    if row is not None:
        # the row's gap and objectives were evaluated after its update;
        # recompute them at the returned (pre-update) iterate
        b_po = compute_primal_objective(problem, x)
        b_do = compute_dual_objective(problem, y_out, Y_bd)
        gap = float(compute_duality_gap(b_po, b_do).limbs[0])
        row = dict(row, gap=gap, p_obj=float(b_po.to_float64()),
                   d_obj=float(b_do.to_float64()))
    if problem.x_sigma is not None:
        x = xf_div(x, problem.x_sigma)
    if problem.y_R_inv is not None:
        y_out = xf_matmul(problem.y_R_inv, y_out)
    if row is None:
        row = history[-1] if history else None
    res = SolveResult(
        x=x, X=X_bd, y=y_out, Y=Y_bd, P=P_res, p=p_res, d=d_res, dual_gap=gap,
        primal_objective=row["p_obj"] if row else float("nan"),
        dual_objective=row["d_obj"] if row else float("nan"),
        time_total=time.time() - t0, iterations=it, converged=converged, status=status,
        history=history)
    res.raw_state = state  # the bundled iterate, this rank's slots
    return res
