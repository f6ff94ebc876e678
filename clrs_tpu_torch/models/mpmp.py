"""solvempmp — the full MPMP pipeline driver (reference MPMP.jl:562-586).

Counterpart of ``clrs_tpu/models/mpmp.py``: maps prepareabc over all
polynomial constraints, infers the block metadata, and calls the port's
clustered SDP solver.
"""

from __future__ import annotations

from typing import Optional, Sequence

from clrs_tpu_torch.core.blockinfo import get_block_info
from clrs_tpu_torch.core.solver import solverank1sdp
from clrs_tpu_torch.models.prepare import prepareabc


def solvempmp(
    M: Sequence,
    G: Sequence,
    q: Sequence,
    x: Sequence,
    delta: Sequence,
    b,
    Pi: Optional[Sequence] = None,
    backend: str = "xla",
    device="cuda",
    **kwargs,
):
    """Solve a multivariate polynomial matrix program on ``device`` (the
    CUDA card unless told otherwise; without one it raises).

    Per constraint j: M[j] (list of matrix polys), G[j] (weights), q[j]
    (basis), x[j] (sample points), delta[j] (max degree), plus the objective
    vector b and optional symmetry matrices Pi[j].  Remaining kwargs are
    forwarded to the solver (MPMP.jl:571).

    backend: "xla" and "host" both run the port's ``solverank1sdp`` at the
    given ``precision_k`` (default 2).  The reference's "host" is a separate
    native IPM for the limb counts its XLA path compiles too slowly; the
    port's one solver runs every k = 2..12 on the card.
    """
    if backend not in ("xla", "host"):
        raise ValueError(f"solvempmp: backend {backend!r} is not 'xla' or 'host'")
    J = len(M)
    if Pi is not None:
        abc = [
            prepareabc(M[j], G[j], q[j], x[j], delta[j], Pi[j]) for j in range(J)
        ]
    else:
        abc = [prepareabc(M[j], G[j], q[j], x[j], delta[j]) for j in range(J)]
    blockinfo = get_block_info(abc)
    return solverank1sdp(abc, b, blockinfo, device=device, **kwargs)
