"""Export an assembled clustered SDP in SDPB's sparse input format.

The reference delegates this to the external `WriteFilesSDPB` package
(examples/SpherePacking.jl:6, 95-98) so the same problem can be cross-run
through Simmons-Duffin's SDPB as an oracle (SURVEY.md §4).  Here we write
the SDPB "SDP blocks" text format directly from the sampled constraint
data: objective vector, per-cluster bilinear bases (the low-rank vectors),
B matrices and c vectors.

A copy of ``clrs_tpu/apps/sdpb_export.py`` (host data only, no jax): both
packages write the same files.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import mpmath


def _nstr(v, dps: int = 50) -> str:
    return mpmath.nstr(mpmath.mpf(v), dps, strip_zeros=False)


def write_sdpb_files(
    path: str, constraints: Sequence, blockinfo, b, b0=0, format: str = "native"
) -> None:
    """Write the assembled SDP to `path` (a directory).

    format="native": objectives.json with b; per-cluster block_<j>.json with
    c, B, the low-rank vectors and weights — a faithful serialization of the
    clustered low-rank data (lossless round-trip via apps/sdpb_import.py).

    format="sdpb2": SDPB 2.x sdp-directory layout (control.json,
    objectives.json, block_info_<j>.json, block_data_<j>.json) so the
    problem can be fed to Simmons-Duffin's SDPB binary as an external
    oracle (SURVEY.md §4).  Requires rank-1 weights-equal-one data with at
    most two inner blocks (SDPB's even/odd parity bases); general-rank data
    must use the native layout.
    """
    if format == "sdpb2":
        return _write_sdpb2(path, constraints, blockinfo, b, b0)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "objectives.json"), "w") as f:
        json.dump(
            {
                "b0": _nstr(b0),
                "b": [_nstr(v) for v in b],
            },
            f,
        )
    for j in range(blockinfo.J):
        A, B, c, H = constraints[j][:4]
        blk = {
            "dim": blockinfo.m[j],
            "num_points": blockinfo.n_samples[j],
            "c": [_nstr(v) for v in list(c)],
            "B": [[_nstr(v) for v in row] for row in B],
            "bilinear_bases": [
                [
                    [[_nstr(x) for x in vec] for vec in A[l][k]]
                    for k in range(blockinfo.n_samples[j])
                ]
                for l in range(blockinfo.L[j])
            ],
            "weights": [
                [[_nstr(w) for w in H[l][k]] for k in range(blockinfo.n_samples[j])]
                for l in range(blockinfo.L[j])
            ],
        }
        with open(os.path.join(path, f"block_{j}.json"), "w") as f:
            json.dump(blk, f)


def _write_sdpb2(path: str, constraints: Sequence, blockinfo, b, b0) -> None:
    """SDPB 2.x sdp directory (see write_sdpb_files)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "control.json"), "w") as f:
        json.dump({"num_blocks": blockinfo.J, "command": "clrs_tpu export"}, f)
    with open(os.path.join(path, "objectives.json"), "w") as f:
        json.dump({"constant": _nstr(b0), "b": [_nstr(v) for v in b]}, f)
    parity_keys = ("bilinear_bases_even", "bilinear_bases_odd")
    for j in range(blockinfo.J):
        A, B, c, H = constraints[j][:4]
        K = blockinfo.n_samples[j]
        L = blockinfo.L[j]
        if L > 2:
            raise ValueError(
                f"cluster {j} has {L} inner blocks; SDPB 2.x supports at "
                "most 2 (even/odd parity) — use format='native'"
            )
        bases = {}
        for l in range(L):
            for k in range(K):
                if len(A[l][k]) != 1 or mpmath.mpf(H[l][k][0]) != 1:
                    raise ValueError(
                        f"cluster {j} block {l} sample {k} is not rank-1 "
                        "weight-1; SDPB 2.x cannot represent it — use "
                        "format='native'"
                    )
            # base matrix: (delta_l, K), column k = the sample-k vector
            base = [
                [_nstr(A[l][k][0][i]) for k in range(K)]
                for i in range(blockinfo.delta[j][l])
            ]
            bases[parity_keys[l]] = base
        for key in parity_keys:
            bases.setdefault(key, [])
        with open(os.path.join(path, f"block_info_{j}.json"), "w") as f:
            json.dump({"dim": blockinfo.m[j], "num_points": K}, f)
        blk = {
            "c": [_nstr(v) for v in list(c)],
            "B": [[_nstr(v) for v in row] for row in B],
            **bases,
        }
        with open(os.path.join(path, f"block_data_{j}.json"), "w") as f:
            json.dump(blk, f)
