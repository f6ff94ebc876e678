"""Cluster-sharded IPM step over ranks (torch.distributed).

Counterpart of ``clrs_tpu/parallel/sharded.py``.  Clusters are independent
through the whole IPM iteration except a few small reductions:
  (a) p = b - sum_j B_j^T x_j            -> allsum
  (b) Q = sum_j B_j^T S_j^-1 B_j         -> allsum (n_y^2)
  (c) rhs of dy                           -> allsum
  (d) dy broadcast back to clusters       -> replicated compute after (c)
  (e) global min eigenvalue for alpha     -> all_reduce(MIN), float64
  plus scalar dots (<X,Y>, objectives)    -> allsum, and the ok flags.

A process group takes the place of the reference's device mesh: each rank
holds a contiguous slice of the cluster axis on its own device and runs
the per-cluster work on it, the slice's clusters a batch axis of the
port's functions (core/kernels.py, ops/linalg.py) where the reference
``jax.vmap``s them.  ``allsum`` gathers every rank's per-cluster partials
and sums them with ``xf_sum`` over the clusters in their canonical order,
so the sum, and with it every iterate, is bit for bit the same at any
rank count.  Without a process group (``group=None`` and torch.distributed
not initialized) the world is this one rank and every collective is the
identity.

This module holds the *homogeneous* step: J clusters of one shape
signature (m, K, L=1, delta, rmax) on synthetic data; parallel/hetero.py
runs real packed problems of mixed shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from clrs_tpu_torch.core.kernels import (
    compute_pairings,
    matmul_route,
    pairing_diag,
    schur_block_contribution,
    trace_A_from_diag,
    trace_A_generic,
    weighted_A_block,
)
from clrs_tpu_torch.core.solver import SolverConfig, _alpha, _cuda_spd_inverse, solve_device
from clrs_tpu_torch.ops.cuda_xf import steplen_sandwich_xf_groups
from clrs_tpu_torch.ops.linalg import jacobi_min_eig, xf_min_eig_sym, xf_spd_inverse, xf_sym
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

# ---------------------------------------------------------------------------
# Collectives over the cluster axis
# ---------------------------------------------------------------------------


def world(group=None):
    """(world size, rank) of group; (1, 0) without torch.distributed."""
    if group is None and not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def cluster_slice(J: int, group=None) -> slice:
    """This rank's contiguous slice of J cluster slots (J a multiple of the
    world size)."""
    n, r = world(group)
    if J % n:
        raise ValueError(f"{J} cluster slots do not split over {n} ranks")
    per = J // n
    return slice(r * per, (r + 1) * per)


def allgather(v: XF, group=None) -> XF:
    """Every rank's slots of a per-cluster XF (value axis 0 = this rank's
    cluster slots), concatenated in rank order, which is the canonical
    cluster order; the identity on one rank."""
    n, _ = world(group)
    if n == 1:
        return v
    parts = [torch.empty_like(v.limbs) for _ in range(n)]
    dist.all_gather(parts, v.limbs.contiguous(), group=group)
    return XF(torch.cat(parts, dim=1))


def allsum(v: XF, n_real: Optional[int] = None, group=None) -> XF:
    """Sum a per-cluster XF (value axis 0 = this rank's cluster slots) over
    all clusters: gather every rank's partials in rank order, keep the
    first n_real slots (the others are padding), and tree-sum them with
    xf_sum.  Full k-limb precision and the same bits at any rank count; a
    limb-wise all_reduce(SUM) would collapse the reduction to float64."""
    limbs = allgather(v, group).limbs
    if n_real is not None:
        limbs = limbs[:, :n_real]
    return xf_sum(XF(limbs), axis=0)


def allmin(x: torch.Tensor, group=None) -> torch.Tensor:
    """The minimum of a float64 scalar over the ranks (exact)."""
    n, _ = world(group)
    if n > 1:
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def allmax(x: torch.Tensor, group=None) -> torch.Tensor:
    n, _ = world(group)
    if n > 1:
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def alltrue(ok: torch.Tensor, group=None) -> torch.Tensor:
    """A bool flag true on every rank."""
    n, _ = world(group)
    if n == 1:
        return ok
    flag = ok.to(torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return flag > 0


def per_cluster_sum(a: XF) -> XF:
    """xf_sum over every value axis but the cluster axis 0."""
    return xf_sum(a.reshape((a.shape[0], -1)), axis=1)


# ---------------------------------------------------------------------------
# The homogeneous problem
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HomogeneousShape:
    """Shape signature of one cluster bundle."""

    J: int  # number of clusters in the bundle
    n_y: int
    m: int
    K: int  # samples per cluster
    delta: int  # basis length (single inner block L=1)
    rmax: int

    @property
    def npairs(self) -> int:
        return self.m * (self.m + 1) // 2

    @property
    def dim_S(self) -> int:
        return self.npairs * self.K

    @property
    def bs(self) -> int:  # PSD block size
        return self.m * self.delta


def random_homogeneous_problem(shape: HomogeneousShape, seed: int = 0, k: int = 2,
                               device=None):
    """Synthetic well-posed problem data (the reference's arrays from the
    same seed): random orthogonal-ish vectors, H=1, random B, c from a
    feasible dual point.  All J clusters, on ``device`` (default the CUDA
    card); ``shard`` takes a rank's slice."""
    device = solve_device(device, "random_homogeneous_problem")
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((shape.J, shape.delta, shape.K * shape.rmax))
    H = np.ones((shape.J, shape.K * shape.rmax))
    B = rng.standard_normal((shape.J, shape.dim_S, shape.n_y)) / shape.n_y
    # c chosen so the dual y=0, Y=I is strictly feasible
    c = np.zeros((shape.J, shape.dim_S))
    for j in range(shape.J):
        for r in range(shape.m):
            for s in range(r + 1):
                for kk in range(shape.K):
                    idx = (s + r * (r + 1) // 2) * shape.K + kk
                    if r == s:
                        acc = 0.0
                        for rnk in range(shape.rmax):
                            v = V[j, :, kk * shape.rmax + rnk]
                            acc += H[j, kk * shape.rmax + rnk] * v @ v
                        c[j, idx] = acc
    b = rng.standard_normal((shape.n_y, 1)) * 0.1

    def to_xf(a):
        return XF.from_float(torch.from_numpy(np.ascontiguousarray(a)).to(device), k=k)

    return dict(V=to_xf(V), H=to_xf(H), B=to_xf(B), c=to_xf(c[..., None]), b=to_xf(b))


def initial_sharded_state(shape: HomogeneousShape, omega_p=100.0, omega_d=100.0,
                          k: int = 2, device=None):
    """Cold start of all J clusters: x=0, y=0, X=omega_p I, Y=omega_d I."""
    device = solve_device(device, "initial_sharded_state")
    x = XF.zeros((shape.J, shape.dim_S, 1), k=k, device=device)
    y = XF.zeros((shape.n_y, 1), k=k, device=device)
    eye = torch.eye(shape.bs, dtype=torch.float64, device=device).expand(
        shape.J, shape.bs, shape.bs)
    X = XF.from_float(eye * omega_p, k=k)
    Y = XF.from_float(eye * omega_d, k=k)
    return (x, y, X, Y)


def shard(data: dict, state, J: int, group=None):
    """This rank's slice of the cluster axis of the data and the state (b
    and y are replicated)."""
    sl = cluster_slice(J, group)
    local = {name: (v if name == "b" else v[sl]) for name, v in data.items()}
    x, y, X, Y = state
    return local, (x[sl], y, X[sl], Y[sl])


def make_sharded_step(shape: HomogeneousShape, group=None, cfg=None):
    """Build the cluster-sharded full IPM step (predictor + corrector).

    step(data, state, pd_feas) -> (state', diag) runs on this rank's slice
    of the cluster axis (``shard``); y, dy, Q and the scalars are
    replicated.  The products, the Schur block and S_j^-1 take the kernels
    under cfg.use_cuda_kernels(device), X^-1 under cfg.use_cuda_inverse,
    the step lengths' sandwich K7 under cfg.use_cuda_steplength, and every
    k-limb add and multiply K8 under cfg.use_cuda_elemwise, as in
    core/solver.make_ipm_phases."""
    cfg = cfg or SolverConfig()
    m, K, rmax = shape.m, shape.K, shape.rmax
    Ktot = float(shape.J * shape.bs)
    J = shape.J

    def step(data, state, pd_feas):
        x, y, X, Y = state
        V, H, B, c, b = data["V"], data["H"], data["B"], data["c"], data["b"]
        k, dev = b.k, b.device
        use_cuda = cfg.use_cuda_kernels(dev)
        mm = matmul_route(use_cuda)
        inv_s = _cuda_spd_inverse if use_cuda else xf_spd_inverse
        Jl = x.shape[0]
        eye = XF.eye(shape.bs, k=k, device=dev)
        one = XF.ones((), k=k, device=dev)
        zero = XF.zeros((), k=k, device=dev)
        beta_inf = XF.from_float(cfg.beta_infeasible, k=k, device=dev)
        beta_fea = XF.from_float(cfg.beta_feasible, k=k, device=dev)
        Ktot_x = XF.from_float(Ktot, k=k, device=dev)

        def asum(v):
            return allsum(v, J, group)

        mu = xf_div(asum(per_cluster_sum(xf_mul(X, Y))), Ktot_x)
        mu_p = xf_where(pd_feas, zero, xf_mul(mu, beta_inf))

        def resid_R(mu_s):
            return xf_add(xf_mul(eye, mu_s), -xf_matmul(X, Y))

        R = resid_R(mu_p)
        if cfg.use_cuda_inverse:
            X_inv, ok_inv = _cuda_spd_inverse(X)
        else:
            X_inv, ok_inv = xf_spd_inverse(X)
            X_inv = xf_sym(X_inv)
        ok = torch.all(ok_inv)

        PX = compute_pairings(X_inv, V, m, mm)
        PY = compute_pairings(Y, V, m, mm)
        A_Y = pairing_diag(PY, m)
        S = xf_sym(schur_block_contribution(PX, PY, H, m, K, rmax, use_cuda))
        S_inv, ok_s = inv_s(S)
        S_inv = xf_sym(S_inv)
        SB = xf_matmul(S_inv, B)
        Q = asum(xf_matmul(B.mT, SB))  # the Q reduction, (b)
        ok = ok & torch.all(ok_s)
        Q_inv, ok_q = inv_s(xf_sym(Q))
        ok = ok & torch.all(ok_q)

        # residuals
        P = xf_add(weighted_A_block(x[..., 0], V, H, m, K, rmax, mm), -X)
        p = xf_add(b, -asum(xf_matmul(B.mT, x)))
        trY = trace_A_from_diag(A_Y, H, m, K, rmax)
        d = xf_add(xf_add(c, -XF(trY.limbs[..., None])), -xf_matmul(B, y))

        def directions(RR):
            Z = xf_sym(xf_matmul(X_inv, xf_add(xf_matmul(P, Y), -RR)))
            trZ = trace_A_generic(Z, V, H, m, K, rmax, mm).reshape(
                (Jl, shape.dim_S, 1))
            tx = xf_matmul(S_inv, xf_add(-d, -trZ))
            acc = asum(xf_matmul(B.mT, tx))
            dy = xf_matmul(Q_inv, xf_add(p, -acc))
            dx = xf_add(tx, xf_matmul(SB, dy))
            dX = xf_add(weighted_A_block(dx[..., 0], V, H, m, K, rmax, mm), P)
            dY = xf_sym(xf_matmul(X_inv, xf_add(RR, -xf_matmul(dX, Y))))
            return dx, dX, dy, dY

        dx, dX, dy, dY = directions(R)

        # corrector
        r = xf_div(asum(per_cluster_sum(xf_mul(xf_add(X, dX), xf_add(Y, dY)))),
                   xf_mul(mu, Ktot_x))
        beta = xf_where(r < one, xf_mul(r, r), r)
        beta_c = xf_where(
            pd_feas,
            xf_where(beta < beta_fea, beta_fea, xf_where(beta < one, beta, one)),
            xf_where(beta < beta_inf, beta_inf, beta),
        )
        mu_c = xf_mul(beta_c, mu)
        R2 = xf_add(resid_R(mu_c), -xf_matmul(dX, dY))
        dx, dX, dy, dY = directions(R2)

        # step lengths: this rank's min eigenvalue, then the min over ranks
        if cfg.use_cuda_steplength and shape.bs > 1:
            # one K7 launch for both sides; its float64 sandwich goes to
            # the Jacobi bound, as in hetero._step_lambdas
            (Wp, okp), (Wd, okd) = steplen_sandwich_xf_groups(
                [(list(M.limbs.unbind(1)), list(dM.limbs.unbind(1)))
                 for M, dM in ((X, dX), (Y, dY))])
            lam_p, lam_d = (jacobi_min_eig((W + W.transpose(-1, -2)) * 0.5) for W in (Wp, Wd))
        else:
            lam_p, okp = xf_min_eig_sym(X, dX)
            lam_d, okd = xf_min_eig_sym(Y, dY)
        ok = ok & torch.all(okp) & torch.all(okd)
        alpha_p = _alpha(allmin(torch.amin(lam_p), group), cfg.gamma)
        alpha_d = _alpha(allmin(torch.amin(lam_d), group), cfg.gamma)
        pd = torch.as_tensor(pd_feas, device=dev)
        both = torch.minimum(alpha_p, alpha_d)
        alpha_p = torch.where(pd, both, alpha_p)
        alpha_d = torch.where(pd, both, alpha_d)

        ap = XF.from_float(alpha_p, k=k)
        ad = XF.from_float(alpha_d, k=k)
        x_new = xf_add(x, xf_mul(dx, ap))
        y_new = xf_add(y, xf_mul(dy, ad))
        X_new = xf_add(X, xf_mul(dX, ap))
        Y_new = xf_add(Y, xf_mul(dY, ad))

        p_obj = asum(per_cluster_sum(xf_mul(c, x_new)))
        d_obj = xf_sum(xf_mul(b, y_new).reshape((-1,)), axis=0)
        diag = dict(mu=mu.to_float64(), p_obj=p_obj.to_float64(), d_obj=d_obj.to_float64(),
                    alpha_p=alpha_p, alpha_d=alpha_d, ok=alltrue(ok, group))
        return (x_new, y_new, X_new, Y_new), diag

    if cfg.use_cuda_elemwise:
        def step_k8(data, state, pd_feas):
            with elemwise_cuda():
                return step(data, state, pd_feas)

        return step_k8
    return step
