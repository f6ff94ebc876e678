"""One rank of a run of the cluster-sharded steps over several processes.

    python -m clrs_tpu_torch.tools.mp_hetero_worker RANK WORLD PORT OUT.npz \
        [--device cpu|cuda] [--backend gloo|nccl] [--what sharded,hetero,solve] \
        [--d 3] [--k 2] [--steps 3] [--max-iterations 200] [--all-kernels]

Sets torchrun's variables (MASTER_ADDR=localhost, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK: the rank on the CPU, the rank modulo the number
of cards on the card, so that ranks share a card only where there are
fewer cards than ranks), joins the world group through
``parallel/multihost.init_multihost`` and runs ``--steps`` steps of:
  sharded: parallel/sharded.py's homogeneous step on the reference's test
           problem (HomogeneousShape(J=8, n_y=3, m=1, K=3, delta=3,
           rmax=1), seed 1, at --k limbs);
  hetero:  parallel/hetero.py's step on the Delsarte bound, dim 8, 2d =
           2 --d, packed at --k limbs (--all-kernels: every kernel, their
           plain versions on the CPU);
and, for "solve", the same problem through
``parallel/multihost.solve_hetero_multihost`` (the user's entry point)
to its end or --max-iterations.
It writes this rank's slices of the iterates after every step and the
diagnostics to OUT.npz (keys "<what>/<step>/<leaf>"; the solve's status,
iterations, objectives, history rows and returned iterate and residuals
under "solve/", its seconds at each iteration's end under "timing/") and
prints one line,
"MPRESULT rank=<r> ok". With WORLD 1 it runs alone, without a process
group.  The counterpart of the reference's scripts/mp_hetero_worker.py.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _leaves(prefix, tree, out):
    if hasattr(tree, "limbs"):
        out[prefix] = tree.limbs.cpu().numpy()
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.cpu().numpy()
    elif isinstance(tree, dict):
        for key, v in tree.items():
            _leaves(f"{prefix}/{key}", v, out)
    else:
        for i, v in enumerate(tree):
            _leaves(f"{prefix}/{i}", v, out)


def run_sharded(k, steps, device, group, out):
    from clrs_tpu_torch.parallel import sharded as S

    shape = S.HomogeneousShape(J=8, n_y=3, m=1, K=3, delta=3, rmax=1)
    data = S.random_homogeneous_problem(shape, seed=1, k=k, device=device)
    state = S.initial_sharded_state(shape, k=k, device=device)
    data, state = S.shard(data, state, shape.J, group)
    step = S.make_sharded_step(shape, group)
    for i in range(steps):
        state, diag = step(data, state, False)
        _leaves(f"sharded/{i}", dict(state=state, diag=diag), out)


def delsarte_problem(d, k, device):
    """The Delsarte bound, dim 8 at 2d, packed at k limbs at 53 bits: the
    ambient mpmath precision that delsarte_lp_bound packs at by default,
    fixed here so that every process packs the same limbs."""
    import mpmath

    from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints
    from clrs_tpu_torch.core.problem import pack_constraints

    cons, b, info = build_delsarte_constraints(8, d)
    with mpmath.workprec(53):
        return pack_constraints(cons, b, info=info, k=k, device=device)


def solver_config(all_kernels):
    from clrs_tpu_torch.core.solver import SolverConfig

    route = dict(use_cuda_matmul=True, use_cuda_inverse=True, use_cuda_steplength=True,
                 use_cuda_elemwise=True) if all_kernels else {}
    return SolverConfig(omega_p=100.0, omega_d=100.0, verbose=False, **route)


def run_hetero(d, k, steps, device, group, out, all_kernels):
    from clrs_tpu_torch.parallel import hetero as H

    problem = delsarte_problem(d, k, device)
    cfg = solver_config(all_kernels)
    shapes, data, _ = H.bundles_from_problem(problem, group)
    state = H.initial_bundle_state(shapes, cfg.omega_p, cfg.omega_d, k, problem.info.n_y,
                                   device=device, group=group)
    step = H.make_hetero_step(shapes, problem.b, cfg, b0=problem.b0, group=group)
    for i in range(steps):
        state, diag = step(data, state, False)
        _leaves(f"hetero/{i}", dict(state=state, diag=diag), out)


def run_solve(d, k, device, out, all_kernels, max_iterations):
    from clrs_tpu_torch.parallel.multihost import solve_hetero_multihost

    res = solve_hetero_multihost(delsarte_problem(d, k, device), maxiterations=max_iterations,
                                 cfg=solver_config(all_kernels))
    keys = [key for key in res.history[0] if key != "time"]
    out["solve/status"] = np.array(res.status)
    out["solve/iterations"] = np.array(res.iterations)
    out["solve/objectives"] = np.array([res.primal_objective, res.dual_objective, res.dual_gap])
    out["solve/history"] = np.array([[row[key] for key in keys] for row in res.history])
    # host-clock seconds at each iteration's end; they differ between runs
    out["timing/solve"] = np.array([row["time"] for row in res.history])
    _leaves("solve/result", dict(x=res.x, y=res.y, X=res.X, Y=res.Y, P=res.P, p=res.p, d=res.d),
            out)


def clustered(key: str) -> bool:
    """Whether an output key names a state leaf with a cluster axis (limb
    axis 0, clusters axis 1): the sharded step's x, X, Y and the hetero
    step's bundles (y is replicated)."""
    parts = key.split("/")
    if len(parts) < 4:  # the solve's outputs, replicated
        return False
    what, _, kind, leaf = parts[:4]
    return kind == "state" and (leaf == "0" if what == "hetero" else leaf != "1")


def differing(one: dict, ranks: list, prefix: str) -> list:
    """The keys under prefix whose leaves on the ranks are not bit for bit
    the one-rank run's: the ranks' slices of a clustered leaf concatenated
    in rank order (padded slots at the end dropped), every other leaf on
    every rank.  Raises if a rank lacks a key."""
    bad = []
    for key in (key for key in one if key.startswith(prefix)):
        want = one[key]
        if clustered(key):
            got = [np.concatenate([r[key] for r in ranks], axis=1)[:, :want.shape[1]]]
        else:
            got = [r[key] for r in ranks]
        if any(g.shape != want.shape or g.tobytes() != want.tobytes() for g in got):
            bad.append(key)
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--what", default="sharded,hetero")
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--max-iterations", type=int, default=200)
    ap.add_argument("--all-kernels", action="store_true")
    args = ap.parse_args(argv)

    on_cpu = torch.device(args.device).type == "cpu"
    local = args.rank if on_cpu else args.rank % max(1, torch.cuda.device_count())
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
                      RANK=str(args.rank), WORLD_SIZE=str(args.world), LOCAL_RANK=str(local))
    if on_cpu:
        torch.set_num_threads(1)
    from clrs_tpu_torch.parallel.multihost import (
        global_cluster_group,
        init_multihost,
        local_device,
    )

    rank = init_multihost(args.device, args.backend)
    assert rank == args.rank, (rank, args.rank)
    device = local_device(args.device)
    group = global_cluster_group()
    out = {}
    try:
        for what in args.what.split(","):
            if what == "sharded":
                run_sharded(args.k, args.steps, device, group, out)
            elif what == "solve":
                run_solve(args.d, args.k, device, out, args.all_kernels, args.max_iterations)
            else:
                run_hetero(args.d, args.k, args.steps, device, group, out, args.all_kernels)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()
    np.savez(args.out, **out)
    print(f"MPRESULT rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
