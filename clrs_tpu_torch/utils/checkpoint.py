"""Checkpoint / warm-restart of solver state (SURVEY.md §5.4).

Counterpart of ``clrs_tpu/utils/checkpoint.py``, in the same ``.npz``
layout (``x``, ``y``, ``X_j_l``, ``Y_j_l`` limb arrays (k, *shape) and a
``_meta`` JSON with J, L and k), so a checkpoint written by either package
loads in the other.  The reference supports warm starts only in memory
(initial_solutions, MPMP.jl:613-614, 687-690); persisting the iterate lets
a long solve resume across processes and across precision escalations.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from clrs_tpu_torch.core.blockinfo import BlockInfo
from clrs_tpu_torch.core.escalate import _reround_state
from clrs_tpu_torch.ops.xfloat import XF


def _numpy(x: XF) -> np.ndarray:
    return x.limbs.detach().cpu().numpy()


def save_state(path: str, state, info: BlockInfo, meta: dict | None = None) -> None:
    """Persist (x, y, X, Y) to `path` (.npz)."""
    x, y, X, Y = state
    arrays = {
        "x": _numpy(x),
        "y": _numpy(y),
    }
    for j, row in enumerate(X):
        for l, blk in enumerate(row):
            arrays[f"X_{j}_{l}"] = _numpy(blk)
    for j, row in enumerate(Y):
        for l, blk in enumerate(row):
            arrays[f"Y_{j}_{l}"] = _numpy(blk)
    arrays["_meta"] = np.frombuffer(
        json.dumps(
            dict(
                J=info.J,
                L=list(info.L),
                k=int(x.k),
                **(meta or {}),
            )
        ).encode(),
        dtype=np.uint8,
    )
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_state(path: str, info: BlockInfo, k: int | None = None, device=None):
    """Load a state saved by save_state onto ``device`` (default the CUDA
    card; a machine without one raises unless given device="cpu");
    optionally re-round it to `k` limbs, as escalation does between rungs
    (core/escalate._reround_state).  Returns ((x, y, X, Y), meta)."""
    if device is None:
        device = "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_state: no CUDA device; pass device='cpu' to load "
                           "onto the CPU")
    data = np.load(path)
    meta = json.loads(bytes(data["_meta"]).decode())

    def conv(a: np.ndarray) -> XF:
        return XF(torch.from_numpy(np.array(a, dtype=np.float64)).to(device))

    state = (
        conv(data["x"]),
        conv(data["y"]),
        [[conv(data[f"X_{j}_{l}"]) for l in range(info.L[j])] for j in range(info.J)],
        [[conv(data[f"Y_{j}_{l}"]) for l in range(info.L[j])] for j in range(info.J)],
    )
    if k is not None:
        state = _reround_state(state, k)
    return state, meta
