"""Row bands of a product over the ranks of a torch.distributed process group.

The panel forms (ops/linalg.xf_cholesky_panel, ops/cuda_xf.spd_inverse_panels)
and the intra-cluster split (parallel/intra.py) form the rows of a product
in bands: each rank a contiguous band of output rows, each row whole and by
the one-rank arithmetic, and ``gather`` concatenates the bands in rank
order, so that any rank count gives the one rank's bits.

A split happens only where the caller names a group: ``group=None`` is
this one rank whether or not torch.distributed is running (every band the
whole axis, every gather the identity), so a call on data that differs
between ranks (the cluster-sharded solve's own S_j, Q and X blocks) never
mixes rows of another rank's matrix into its own.

Rows that do not divide the ranks: ``row_band`` gives ceil(n / size)
rows a rank and ``gather`` pads the short bands, exact at any split, which
spd_inverse_panels needs (its trailing updates shrink panel by panel).
Two callers keep the reference's own rule instead: the plain panel
Cholesky raises, as the reference asserts (ops/linalg.xf_cholesky_panel),
and the intra plan computes such an axis whole on every rank, as the
reference's ``_put`` replicates it (parallel/intra.IntraPlan).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def size_rank(group=None):
    """(size, rank) of group; (1, 0) for group None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def row_band(n: int, group=None) -> slice:
    """This rank's band of n rows: ceil(n / size) rows each in rank order,
    the last bands shorter or empty; the whole axis on one rank."""
    size, rank = size_rank(group)
    per = -(-n // size)
    lo = min(rank * per, n)
    return slice(lo, min(lo + per, n))


def gather(part: torch.Tensor, dim: int, group=None, n: Optional[int] = None) -> torch.Tensor:
    """Every rank's part concatenated along dim in rank order, the
    identity on one rank.  The parts may be shorter than ceil(n / size)
    along dim (row_band's last bands): each is zero-padded to that for the
    all_gather and the result cut to n."""
    size, _ = size_rank(group)
    if size == 1:
        return part
    dim = dim % part.ndim
    per = part.shape[dim] if n is None else -(-n // size)
    if part.shape[dim] < per:
        pad = list(part.shape)
        pad[dim] = per - part.shape[dim]
        part = torch.cat([part, part.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(part) for _ in range(size)]
    dist.all_gather(parts, part.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    return out if n is None else out.narrow(dim, 0, n)
