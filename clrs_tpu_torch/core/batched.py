"""Shape-grouped batched execution of per-block / per-cluster work.

Counterpart of ``clrs_tpu/core/batched.py``.  Blocks (or clusters) with
identical shape signatures are stacked on a leading batch axis and go
through ONE call of a batch-polymorphic function, where the reference
``jax.vmap``s a per-block function.  The arithmetic per block is
unchanged, so the results agree with the reference limb for limb.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from clrs_tpu_torch.core.blockinfo import BlockInfo
from clrs_tpu_torch.ops.xfloat import XF


def stack_xf(xs: Sequence[XF]) -> XF:
    """Stack XF leaves on a new value-axis 0 (limb axis 1)."""
    return XF(torch.stack([x.limbs for x in xs], dim=1))


def unstack_xf(x: XF, n: int) -> List[XF]:
    return [XF(x.limbs[:, i]) for i in range(n)]


def block_groups(info: BlockInfo) -> Dict[int, List[Tuple[int, int]]]:
    """(j, l) PSD blocks grouped by block size."""
    groups: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for j in range(info.J):
        for l in range(info.L[j]):
            groups[info.Y_blocksizes[j][l]].append((j, l))
    return dict(groups)


def cluster_signature(info: BlockInfo, j: int):
    return (
        info.m[j],
        info.n_samples[j],
        info.L[j],
        info.delta[j],
        info.rmax[j],
        info.dim_S[j],
    )


def cluster_groups(info: BlockInfo) -> List[List[int]]:
    """Clusters grouped by identical shape signature (order-preserving)."""
    seen: Dict[tuple, List[int]] = {}
    order: List[tuple] = []
    for j in range(info.J):
        sig = cluster_signature(info, j)
        if sig not in seen:
            seen[sig] = []
            order.append(sig)
        seen[sig].append(j)
    return [seen[sig] for sig in order]


def map_blocks(fn: Callable, info: BlockInfo, *block_lists, out_has_flag=False):
    """Apply a batch-polymorphic per-block function over all (j, l) blocks,
    one call per block-size group.

    block_lists: nested [j][l] lists of XF.  Returns nested [j][l] outputs;
    with out_has_flag, fn returns (XF, per-block bool tensor) and the
    conjunction of all flags is returned separately (a 0-dim bool tensor).
    """
    out = [[None] * info.L[j] for j in range(info.J)]
    ok = None
    for size, jls in block_groups(info).items():
        stacked = [stack_xf([bl[j][l] for (j, l) in jls]) for bl in block_lists]
        res = fn(*stacked)
        if out_has_flag:
            res, oks = res
            okg = torch.all(oks)
            ok = okg if ok is None else ok & okg
        for i, (j, l) in enumerate(jls):
            out[j][l] = res[i]
    if out_has_flag:
        return out, ok
    return out


def map_block_scalar(fn: Callable, info: BlockInfo, *block_lists):
    """Per-block function returning (per-block scalar, per-block flag),
    reduced with min / all over every block."""
    val = None
    ok = None
    for size, jls in block_groups(info).items():
        stacked = [stack_xf([bl[j][l] for (j, l) in jls]) for bl in block_lists]
        vs, oks = fn(*stacked)
        v = torch.amin(vs)
        val = v if val is None else torch.minimum(val, v)
        okg = torch.all(oks)
        ok = okg if ok is None else ok & okg
    return val, ok
