"""Import SDPs in SDPB's sparse input format (and our own export layout).

The reference can only *export* problems for SDPB cross-validation (via the
external WriteFilesSDPB package, examples/SpherePacking.jl:6, 95-98); the
import direction lets SDPB-format problems (e.g. produced by sdp2input /
pvm2sdp from the SDPB distribution) run through this solver directly.

Two layouts are recognized:
  1. this repo's export (apps/sdpb_export.py): objectives.json +
     block_<j>.json with explicit low-rank vectors and weights;
  2. SDPB 2.x "sdp" directories (or .zip archives): control.json,
     objectives.json {constant, b}, block_info_<j>.json {dim, num_points},
     block_data_<j>.json {c, B, bilinear_bases_even, bilinear_bases_odd}.
     SDPB stores each constraint block as two parity PSD blocks whose
     bilinear bases hold one vector per sample point (rank 1, weight 1);
     that maps exactly onto our (A, B, c, H) constraint tuples.

Returned data plugs straight into `solverank1sdp(constraints, b, blockinfo)`.

A copy of ``clrs_tpu/apps/sdpb_import.py``; ``solve_sdpb`` solves with the
port's solver, on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import List, Optional, Tuple

import mpmath
import numpy as np

from clrs_tpu_torch.core.blockinfo import BlockInfo, get_block_info


def _mpf(s) -> mpmath.mpf:
    return mpmath.mpf(str(s))


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def read_sdpb_dir(path: str) -> Tuple[list, list, BlockInfo, mpmath.mpf]:
    """Read an SDP from `path` (directory or .zip).

    Returns (constraints, b, blockinfo, b0) in solverank1sdp's input format.
    """
    if path.endswith(".zip") or (os.path.isfile(path) and zipfile.is_zipfile(path)):
        tmp = tempfile.mkdtemp(prefix="sdpb_import_")
        with zipfile.ZipFile(path) as z:
            z.extractall(tmp)
        path = tmp

    names = set(os.listdir(path))
    if any(n.startswith("block_data_") for n in names):
        return _read_sdpb2(path)
    if any(n.startswith("block_") and n.endswith(".json") for n in names):
        return _read_native(path)
    raise ValueError(f"no SDPB block files found under {path}")


def _read_native(path: str):
    """Read apps/sdpb_export.py's layout (lossless round-trip)."""
    obj = _load_json(os.path.join(path, "objectives.json"))
    b = [_mpf(v) for v in obj["b"]]
    b0 = _mpf(obj.get("b0", "0"))
    constraints = []
    j = 0
    while os.path.exists(os.path.join(path, f"block_{j}.json")):
        blk = _load_json(os.path.join(path, f"block_{j}.json"))
        K = int(blk["num_points"])
        A = [
            [[np.array([_mpf(x) for x in vec], dtype=object) for vec in blk["bilinear_bases"][l][k]]
             for k in range(K)]
            for l in range(len(blk["bilinear_bases"]))
        ]
        H = [
            [[_mpf(w) for w in blk["weights"][l][k]] for k in range(K)]
            for l in range(len(blk["weights"]))
        ]
        B = np.array([[_mpf(v) for v in row] for row in blk["B"]], dtype=object)
        c = np.array([_mpf(v) for v in blk["c"]], dtype=object)
        constraints.append((A, B, c, H))
        j += 1
    info = get_block_info(constraints)
    return constraints, b, info, b0


def _read_sdpb2(path: str):
    """Read an SDPB 2.x sdp directory (sdp2input/pvm2sdp output)."""
    obj = _load_json(os.path.join(path, "objectives.json"))
    b = [_mpf(v) for v in obj["b"]]
    b0 = _mpf(obj.get("constant", "0"))

    num_blocks = None
    ctrl_path = os.path.join(path, "control.json")
    if os.path.exists(ctrl_path):
        num_blocks = int(_load_json(ctrl_path).get("num_blocks"))
    if num_blocks is None:
        num_blocks = len([n for n in os.listdir(path) if n.startswith("block_data_")])

    constraints = []
    for j in range(num_blocks):
        data = _load_json(os.path.join(path, f"block_data_{j}.json"))
        # dim/num_points live in block_info_<j>.json in newer layouts, or
        # inline in older ones
        info_path = os.path.join(path, f"block_info_{j}.json")
        meta = _load_json(info_path) if os.path.exists(info_path) else data
        K = int(meta["num_points"])

        bases = []
        for key in ("bilinear_bases_even", "bilinear_bases_odd"):
            base = data.get(key)
            if base is None or len(base) == 0 or len(base[0]) == 0:
                continue
            bases.append(np.array([[_mpf(v) for v in row] for row in base], dtype=object))
        # each parity base is (delta_l, K): column k is the sampled basis
        # scaled by sqrt(sample weight) — one rank-1 vector, weight 1
        A = [
            [[bases[l][:, k]] for k in range(K)]
            for l in range(len(bases))
        ]
        H = [[[mpmath.mpf(1)] for _ in range(K)] for _ in range(len(bases))]
        B = np.array([[_mpf(v) for v in row] for row in data["B"]], dtype=object)
        c = np.array([_mpf(v) for v in data["c"]], dtype=object)
        constraints.append((A, B, c, H))
    info = get_block_info(constraints)
    return constraints, b, info, b0


def solve_sdpb(path: str, device="cuda", **solver_kwargs):
    """Read an SDPB-format problem and solve it on ``device`` (the CUDA
    card unless told otherwise; without one it raises)."""
    from clrs_tpu_torch.core.solver import solverank1sdp

    constraints, b, info, b0 = read_sdpb_dir(path)
    return solverank1sdp(constraints, b, info, b0=b0, device=device, **solver_kwargs)
