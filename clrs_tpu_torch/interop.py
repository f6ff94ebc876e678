"""State carried across from the JAX package, without importing it.

The JAX package's packed ``SDPProblem`` and iterates are pytrees of XF
leaves.  A caller that has both packages (the comparison tests) extracts
them on the JAX side as nested lists and dicts of numpy limb arrays
(k, *shape); the functions here rebuild the port's objects from those on
a given device.
"""

from __future__ import annotations

import numpy as np
import torch

from clrs_tpu_torch.core.blockinfo import BlockInfo
from clrs_tpu_torch.core.problem import ClusterData, SDPProblem
from clrs_tpu_torch.ops.xfloat import XF


def _xf(a, device):
    if a is None:
        return None
    return XF(torch.from_numpy(np.array(a, dtype=np.float64)).to(device))


def _bd(bd, device):
    return [[_xf(b, device) for b in row] for row in bd]


def problem_from_numpy(tree: dict, info: BlockInfo, *, device) -> SDPProblem:
    """tree: {"clusters": [{"Vs": [...], "Hs": [...], "B": a, "c": a}, ...],
    "b": a, "C_blocks": None or [[a]], "b0": a, "x_sigma": a or None,
    "y_R_inv": a or None, "y_R": a or None} with numpy limb arrays."""
    clusters = tuple(
        ClusterData(
            tuple(_xf(v, device) for v in cl["Vs"]),
            tuple(_xf(h, device) for h in cl["Hs"]),
            _xf(cl["B"], device),
            _xf(cl["c"], device),
        )
        for cl in tree["clusters"]
    )
    C = tree.get("C_blocks")
    return SDPProblem(
        clusters,
        _xf(tree["b"], device),
        None if C is None else _bd(C, device),
        _xf(tree["b0"], device),
        info,
        _xf(tree.get("x_sigma"), device),
        _xf(tree.get("y_R_inv"), device),
        _xf(tree.get("y_R"), device),
    )


def state_from_numpy(x, y, X, Y, *, device):
    """An iterate (x, y, X, Y) from numpy limb arrays; X and Y are nested
    [j][l] lists."""
    return _xf(x, device), _xf(y, device), _bd(X, device), _bd(Y, device)
