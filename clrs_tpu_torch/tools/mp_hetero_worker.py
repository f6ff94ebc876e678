"""One rank of a run of the cluster-sharded steps over several processes.

    python -m clrs_tpu_torch.tools.mp_hetero_worker RANK WORLD PORT OUT.npz \
        [--device cpu|cuda] [--backend gloo|nccl] \
        [--what sharded,hetero,solve,intra,intra_solve,bands] [--d 3] [--k 2] \
        [--steps 3] [--max-iterations 200] [--all-kernels] [--mxu] [--pad 4] \
        [--band-sizes 40]

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
  intra:   core/solver.make_fused_step on the same problem packed with its
           ranks padded by parallel/intra.pad_info_ranks(info, --pad),
           split inside its clusters by parallel/intra.shard_problem
           (--mxu: use_mxu_matmul);
and, for "solve", the hetero problem through
``parallel/multihost.solve_hetero_multihost`` (the user's entry point)
to its end or --max-iterations; for "intra_solve", intra's problem
through ``parallel/intra.solve_intra_sharded``; for "bands", the panel
forms with their trailing updates in row bands over the group: the
panel Cholesky (ops/linalg.xf_cholesky_panel, 64 rows, panels of 16)
and the panel route's SPD inverse (ops/cuda_xf.spd_inverse_panels) at
each of --band-sizes rows, on SPD matrices made from a seed, at --k
limbs, then both without a group on matrices that differ between ranks
(run_bands).
It writes this rank's slices of the iterates after every step and the
diagnostics to OUT.npz (keys "<what>/<step>/<leaf>"; the solve's status,
iterations, objectives, history rows and returned iterate and residuals
under "solve/", its seconds at each iteration's end under "timing/"; the
kernels' launches in the intra runs under "launches/", their seconds
under "timing/") and prints one line,
"MPRESULT rank=<r> ok". With WORLD 1 it runs alone, without a process
group.  The counterpart of the reference's scripts/mp_hetero_worker.py.
"""

from __future__ import annotations

import argparse
import os
import time

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


def solver_config(all_kernels, mxu=False):
    """The solve's options: omega 100; all_kernels turns every kernel on,
    mxu the int8-sliced products in place of K3/K4."""
    from clrs_tpu_torch.core.solver import SolverConfig

    route = dict(use_cuda_matmul=not mxu, use_cuda_inverse=True, use_cuda_steplength=True,
                 use_cuda_elemwise=True) if all_kernels else {}
    if mxu:
        route.update(use_cuda_matmul=False, use_mxu_matmul=True)
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


def intra_problem(d, k, device, pad, group):
    """The Delsarte problem of delsarte_problem with T padded to a
    multiple of pad, split over group."""
    import mpmath

    from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints
    from clrs_tpu_torch.core.problem import pack_constraints
    from clrs_tpu_torch.parallel.intra import pad_info_ranks, shard_problem

    cons, b, info = build_delsarte_constraints(8, d)
    with mpmath.workprec(53):
        problem = pack_constraints(cons, b, info=pad_info_ranks(info, pad), k=k, device=device)
    return shard_problem(problem, group)


def launch_counts():
    """Every kernel's launches so far, by name (cuda_xf.launch_counters)."""
    from clrs_tpu_torch.ops.cuda_xf import launch_counters

    return {name: fn.launches for name, fn in launch_counters().items()}


def _synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _record_launches(name, before, out):
    for kernel, n in launch_counts().items():
        out[f"launches/{name}/{kernel}"] = np.array(n - before[kernel])


def run_intra(d, k, steps, device, group, out, all_kernels, pad, mxu):
    from clrs_tpu_torch.core.solver import initial_state, make_fused_step

    problem = intra_problem(d, k, device, pad, group)
    cfg = solver_config(all_kernels, mxu)
    state = initial_state(problem, cfg)
    step = make_fused_step(problem, cfg)
    before = launch_counts()
    seconds = []
    for i in range(steps):
        t0 = time.time()
        state, diag = step(state, False)
        _synchronize(device)
        seconds.append(time.time() - t0)
        _leaves(f"intra/{i}", dict(state=state, diag=diag), out)
    _record_launches("intra", before, out)
    out["timing/intra"] = np.array(seconds)


def run_intra_solve(d, k, device, group, out, all_kernels, pad, mxu, max_iterations):
    from clrs_tpu_torch.parallel.intra import solve_intra_sharded

    problem = intra_problem(d, k, device, pad, None)
    before = launch_counts()
    t0 = time.time()
    state, res = solve_intra_sharded(problem, group, maxiterations=max_iterations,
                                     cfg=solver_config(all_kernels, mxu))
    out["timing/intra_solve"] = np.array(time.time() - t0)
    _record_launches("intra_solve", before, out)
    out["intra_solve/iterations"] = np.array(res["iterations"])
    out["intra_solve/gap"] = np.array(res["gap"])
    _leaves("intra_solve/result", dict(state=state, diag=res["diag"]), out)


SOLO_BATCH = 3  # the matrices of the "bands/solo" check


def run_bands(k, sizes, device, group, out):
    """The panel forms with row bands over group (bands/cholesky,
    bands/inverse<n>), then the same forms without a group on matrices
    that differ between ranks (bands/solo): rank r inverts the batch of
    SOLO_BATCH matrices rolled by r and rolls the result back, so that
    every rank's leaves are the one rank's only if no rank reads
    another's rows while torch.distributed runs."""
    from clrs_tpu_torch.ops.cuda_xf import spd_inverse_panels
    from clrs_tpu_torch.ops.linalg import xf_cholesky_panel
    from clrs_tpu_torch.ops.xfloat import XF

    def spd(n, seed, batch=1):
        limbs = np.zeros((k, batch, n, n))
        for b in range(batch):
            rng = np.random.default_rng(seed + b)
            m = rng.standard_normal((n, n)) * 10.0 ** -np.linspace(0, 3, n)
            a = m @ m.T + n * np.eye(n)
            lo = rng.standard_normal((n, n))
            limbs[0, b] = a
            limbs[1, b] = (lo + lo.T) * np.abs(a) * 2.0 ** -60  # a symmetric second limb
        return torch.from_numpy(limbs).to(device)

    L, ok = xf_cholesky_panel(XF(spd(64, 64)), panel=16, group=group)
    _leaves("bands/cholesky", dict(L=L, ok=ok), out)
    before = launch_counts()
    for n in sizes:
        inv, ok = spd_inverse_panels(spd(n, n), group=group)
        _leaves(f"bands/inverse{n}", dict(inv=inv, ok=ok), out)
    _record_launches("bands", before, out)
    shift = (torch.distributed.get_rank() if group is not None else 0) % SOLO_BATCH

    def solo(x):  # rank-distinct inputs in, the batch's own order out
        return torch.roll(x, shift, dims=1)

    L, ok = xf_cholesky_panel(XF(solo(spd(64, 64, SOLO_BATCH))), panel=16)
    _leaves("bands/solo/cholesky", dict(L=torch.roll(L.limbs, -shift, dims=1),
                                        ok=torch.roll(ok, -shift, dims=0)), out)
    for n in sizes:
        inv, ok = spd_inverse_panels(solo(spd(n, n, SOLO_BATCH)))
        _leaves(f"bands/solo/inverse{n}", dict(inv=torch.roll(inv, -shift, dims=1),
                                               ok=torch.roll(ok, -shift, dims=0)), out)


def clustered(key: str) -> bool:
    """Whether an output key names a state leaf with a cluster axis (limb
    axis 0, clusters axis 1): the sharded step's x, X, Y and the hetero
    step's bundles (y is replicated)."""
    parts = key.split("/")
    if len(parts) < 4 or parts[0] not in ("sharded", "hetero"):  # replicated
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
    ap.add_argument("--mxu", action="store_true")
    ap.add_argument("--pad", type=int, default=4)
    ap.add_argument("--band-sizes", default="40")
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
            elif what == "intra":
                run_intra(args.d, args.k, args.steps, device, group, out, args.all_kernels,
                          args.pad, args.mxu)
            elif what == "intra_solve":
                run_intra_solve(args.d, args.k, device, group, out, args.all_kernels, args.pad,
                                args.mxu, args.max_iterations)
            elif what == "bands":
                run_bands(args.k, [int(n) for n in args.band_sizes.split(",")], device, group,
                          out)
            else:
                run_hetero(args.d, args.k, args.steps, device, group, out, args.all_kernels)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()
    np.savez(args.out, **out)
    print(f"MPRESULT rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
