"""Several processes, several cards: torch.distributed bring-up and groups.

Counterpart of ``clrs_tpu/parallel/multihost.py``.  Every process runs
one rank on one device (``cuda:<local rank>``, or the CPU when the caller
asks for it), joins the world process group from the standard variables
that torchrun sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
LOCAL_RANK), and runs the same bundle-sharded solve (parallel/hetero.py)
on its slice of the clusters.  The communication per iteration is the
few small reductions of that step, O(n_y^2) and scalars.

The backend is NCCL for the card and gloo for the CPU; a caller may name
gloo for the card too, and gloo then carries the CUDA tensors itself.
Nothing here copies a card's tensors to the host, and asking for the card
on a machine without one raises.  A single process (no WORLD_SIZE, or 1)
initializes nothing, and every collective of the step is the identity.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from clrs_tpu_torch.core.blockinfo import BlockInfo, distribute_weights_swapping


def local_device(device=None) -> torch.device:
    """This rank's device: cuda:<LOCAL_RANK> unless ``device`` is the CPU
    (a machine without a card raises)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_multihost(device=None, backend: Optional[str] = None) -> int:
    """Join the world process group from torchrun's variables (idempotent)
    and return this process's global rank; a no-op returning 0 for one
    process.  backend: NCCL for the card, gloo for the CPU, unless named."""
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return 0
    if not dist.is_initialized():
        dev = local_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                rank=int(os.environ["RANK"]), world_size=world_size)
    return dist.get_rank()


def global_cluster_group():
    """The group the bundle-sharded step runs over: every rank of every
    host, in global rank order (None, the world of one, without
    torch.distributed)."""
    return dist.group.WORLD if dist.is_initialized() else None


def host_chip_groups() -> Tuple[object, object]:
    """The world split by (host, local rank): (this rank's host group,
    the ranks of its own host; its chip group, the ranks of its local rank
    on every host), for programs that want separate axes.  Hosts hold
    LOCAL_WORLD_SIZE ranks each, in global rank order.  (None, None)
    without torch.distributed."""
    if not dist.is_initialized():
        return None, None
    n, rank = dist.get_world_size(), dist.get_rank()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    host = chip = None
    # every rank takes part in creating every group
    for h in range(n // per_host):
        g = dist.new_group(list(range(h * per_host, (h + 1) * per_host)))
        if rank // per_host == h:
            host = g
    for c in range(per_host):
        g = dist.new_group(list(range(c, n, per_host)))
        if rank % per_host == c:
            chip = g
    return host, chip


def assign_clusters_to_hosts(info: BlockInfo, n_hosts: int) -> Sequence[Sequence[int]]:
    """Weighted static assignment of clusters to hosts, weights = sum_l
    blocksize^3 (the reference's load-balancing cost proxy).  For clusters
    solved host-locally, and as a placement hint for loading data."""
    weights = [float(sum(info.block_weight(j, l) for l in range(info.L[j])))
               for j in range(info.J)]
    sets, _ = distribute_weights_swapping(weights, n_hosts)
    return sets


def solve_hetero_multihost(problem, maxiterations: int = 200, cfg=None,
                           verbose: bool = False):
    """Join the world group (if configured) and run the bundle-sharded
    solver over it.  problem must lie on this rank's device
    (``local_device``: cuda:<LOCAL_RANK>, or the CPU); one packed on
    another card raises before any group is joined."""
    from clrs_tpu_torch.parallel.hetero import solve_hetero_sharded

    dev = local_device(problem.device)
    if problem.device != dev:
        raise ValueError(f"the problem lies on {problem.device}, this rank's device is {dev}: "
                         f"pack it with device={str(dev)!r}")
    init_multihost(dev)
    return solve_hetero_sharded(problem, global_cluster_group(), maxiterations=maxiterations,
                                cfg=cfg, verbose=verbose)
