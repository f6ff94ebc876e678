"""Intra-cluster split of the IPM step over ranks (torch.distributed).

Counterpart of ``clrs_tpu/parallel/intra.py``.  parallel/sharded.py and
hetero.py split the cluster axis; this module covers the opposite regime,
one large cluster (high degree, large delta and T = n_samples * rmax)
whose work must be split inside.  The reference lays the large tensors
out over a mesh and runs the unmodified fused step under GSPMD; torch has
no partitioner, so here the unmodified fused step (core/solver.py:
make_fused_step) reads a small plan that ``shard_problem`` attaches to the
problem (IntraPlan: the group, this rank, the world) and
the few functions that split read it:
  - the pairing products (core/kernels.compute_pairings): each rank forms
    its band of ZV's columns t2 and of P's rows t1 of the sample-rank axis
    T, the reference's sharded axis of V;
  - the Schur assembly (core/kernels.schur_block_contribution): each rank
    forms the tuple rows of its band of t1 and sums their t2 rank slots;
  - the panel forms' trailing updates (ops/linalg.xf_cholesky_panel,
    ops/cuda_xf.spd_inverse_panels) where S_j or Q takes them.
A rank computes only whole output rows, each by the one-rank arithmetic,
the bands are gathered in rank order, and every reduction runs after the
gather on every rank in the one-rank order; everything else (Q, y, the
scalars, the step lengths) is replicated.  So N ranks give one rank's
bits, where the reference's test allows the dd ulp.  An axis that the
ranks do not divide is replicated, as the reference's ``_put`` does;
``pad_info_ranks`` makes T divide at pack time.

Memory: every rank keeps the whole problem and the whole state; only the
work is split (the reference's shards also split memory).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from clrs_tpu_torch.core.blockinfo import BlockInfo
from clrs_tpu_torch.core.problem import SDPProblem
from clrs_tpu_torch.core.solver import SolverConfig, initial_state, make_fused_step
from clrs_tpu_torch.ops.bands import gather, size_rank


@dataclass(frozen=True)
class IntraPlan:
    """How one cluster's work splits over a group: an axis of n rows
    splits into equal contiguous bands where the world divides n, and is
    replicated (every rank computes it whole) where it does not, as the
    reference's ``_put`` replicates (intra.py:65-77).  The functions that
    split (core/kernels.py) read ``band`` and ``gather`` only."""

    group: Any
    rank: int
    world: int

    def band(self, n: int) -> Optional[slice]:
        """This rank's rows of an axis of n, or None where n is replicated."""
        if self.world == 1 or n % self.world:
            return None
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        return gather(part, dim, self.group)


def pad_info_ranks(info: BlockInfo, multiple: int) -> BlockInfo:
    """Pad every rmax[j][l] up so that T = n_samples * rmax is a multiple
    of ``multiple``.  Pass the result as ``info=`` to pack_constraints: the
    extra slots get V = 0, H = 0, exact no-ops on the iterates."""
    rmax = []
    for j in range(info.J):
        K = info.n_samples[j]
        step = multiple // math.gcd(K, multiple)
        rmax.append(tuple(-(-r // step) * step for r in info.rmax[j]))
    return replace(info, rmax=tuple(rmax))


def make_chip_group(n_ranks: Optional[int] = None):
    """The group of the first n_ranks ranks of the world (all of them by
    default), the reference's make_chip_mesh; None without
    torch.distributed, where the world is this one rank.  A group of fewer
    ranks than the world is made by every rank of the world
    (dist.new_group)."""
    if not dist.is_initialized():
        return None
    size = dist.get_world_size()
    if n_ranks is None or n_ranks == size:
        return dist.group.WORLD
    return dist.new_group(list(range(n_ranks)))


def shard_problem(problem: SDPProblem, group=None) -> SDPProblem:
    """The packed problem with this rank's plan over group (None: every
    rank of the world, make_chip_group) attached; the data stays whole on
    every rank."""
    if group is None:
        group = make_chip_group()
    size, rank = size_rank(group)
    return replace(problem, plan=IntraPlan(group, rank, size))


def shard_state(state, group=None):
    """The IPM state (x, y, X, Y) as each rank holds it: whole, since the
    split is of the work (the reference places the PSD block rows and x's
    tuple axis over its mesh)."""
    return state


def solve_intra_sharded(problem: SDPProblem, group=None, maxiterations: int = 200,
                        cfg: Optional[SolverConfig] = None, verbose: bool = False):
    """Driver: attach the plan and run the fused step with the host's
    check of convergence each iteration, the reference's driver
    (intra.py:125-183): the best iterate is the one after the step, and
    the run stops on stall_patience non-improving iterations or a failed
    factorization.  Returns (state, dict(gap, iterations, diag)), every
    rank the same."""
    cfg = cfg or SolverConfig()
    sp = shard_problem(problem, group)
    state = shard_state(initial_state(problem, cfg), group)
    step = make_fused_step(sp, cfg)
    pd_feas = False
    gap = np.inf
    it = 0
    best = (np.inf, None, None)  # (merit, state, diag)
    stall = 0
    diag = None
    for it in range(1, maxiterations + 1):
        state, diag = step(state, pd_feas)
        gap = float(diag["gap"])
        primal_err = float(diag["primal_err"])
        dual_err = float(diag["dual_err"])
        pd_feas = (primal_err < cfg.primal_error_threshold
                   and dual_err < cfg.dual_error_threshold)
        merit = max(gap, primal_err, dual_err)
        if not np.isfinite(merit):
            merit = np.inf
        if merit < best[0]:
            best = (merit, state, diag)
            stall = 0
        else:
            stall += 1
        if verbose:
            print(f"iter {it}: mu={float(diag['mu']):.3e} p={float(diag['p_obj']):.12f} "
                  f"d={float(diag['d_obj']):.12f} gap={gap:.2e}")
        if pd_feas and gap < cfg.duality_gap_threshold:
            break
        if stall >= cfg.stall_patience or not bool(diag["ok"]):
            if best[1] is not None:
                state, diag = best[1], best[2]
                gap = float(diag["gap"])
            break
    return state, dict(gap=gap, iterations=it, diag=diag)
