"""Delsarte LP bound for spherical codes / the kissing number (torch).

Counterpart of ``clrs_tpu/apps/delsarte.py``; the solve runs on the
device given by ``device=``.

BASELINE.json config 1 ("Delsarte bound, dim 8, 2d=10 — single cluster,
CPU-runnable").  Classic known answer: in dimension 8 with polynomial
degree >= 6 the LP bound on the kissing number is exactly 240
(Odlyzko-Sloane / Levenshtein), which makes this a sharp end-to-end
correctness anchor for the whole pipeline.

Formulation as a polynomial matrix program (solved through prepareabc +
solverank1sdp, the same path as the reference's applications):

  variables y_k >= 0 (k = 1..2d),  f(t) = 1 + sum_k y_k G_k^{(n)}(t)
  constraint: -f(t) >= 0 on [-1, cos_theta]   (1x1 polynomial constraint,
      weights G = {1, (t+1)(cos_theta - t)})
  sign constraints: y_k >= 0  (one 1x1 constant constraint each)
  objective: maximize -sum_k y_k  ->  bound = f(1) = 1 + sum_k y_k.
"""

from __future__ import annotations

import mpmath

from clrs_tpu_torch.core.blockinfo import get_block_info
from clrs_tpu_torch.core.solver import solverank1sdp
from clrs_tpu_torch.models.bases import gegenbauer_basis
from clrs_tpu_torch.models.poly import MPoly, poly_matrix
from clrs_tpu_torch.models.prepare import prepareabc
from clrs_tpu_torch.models.samples import create_sample_points_chebyshev


def build_delsarte_constraints(n: int, d: int, costheta="0.5",
                               prec: int = 256):
    """Assemble the Delsarte LP-bound constraint data (no solve):
    returns (constraints, b, blockinfo)."""
    old_prec = mpmath.mp.prec
    mpmath.mp.prec = max(prec, mpmath.mp.prec)
    try:
        ct = mpmath.mpf(costheta)
        deg = 2 * d
        x = MPoly.var(0, 1)
        gb = gegenbauer_basis(deg, n, x)  # G_0..G_deg, normalized G_k(1)=1

        # constraint 1: -1 - sum_k y_k G_k(t) >= 0 on [-1, ct]
        M_main = [poly_matrix([[MPoly.constant(-1, 1)]])] + [
            poly_matrix([[-gb[k]]]) for k in range(1, deg + 1)
        ]
        G_main = [MPoly.constant(1, 1), (x + 1) * (MPoly.constant(ct, 1) - x)]
        # basis for the SOS multipliers: Chebyshev-ish on [-1, ct] — use
        # Gegenbauer basis (any degree-monotone basis works; conditioning
        # matters).  Need degrees up to deg/2.
        q_main = gegenbauer_basis(d, n, x)
        pts = create_sample_points_chebyshev(deg, -1, ct)

        # sign constraints y_k >= 0: 0 + y_k * 1 >= 0, single sample
        cons = [prepareabc(M_main, G_main, q_main, pts, deg)]
        one = MPoly.constant(1, 1)
        zero = MPoly.constant(0, 1)
        for k in range(1, deg + 1):
            Mj = [poly_matrix([[zero]])] + [
                poly_matrix([[one if i == k else zero]]) for i in range(1, deg + 1)
            ]
            cons.append(
                prepareabc(Mj, [one], [one], [mpmath.mpf(0)], 0)
            )

        b = [-1.0] * deg
        info = get_block_info(cons)
        return cons, b, info
    finally:
        mpmath.mp.prec = old_prec


def delsarte_lp_bound(
    n: int,
    d: int,
    costheta="0.5",
    prec: int = 256,
    return_problem: bool = False,
    device="cuda",
    **solver_kwargs,
):
    """LP upper bound for spherical codes with min angle arccos(costheta)
    in S^{n-1}, using Gegenbauer polynomials up to degree 2d, solved on
    ``device`` (the CUDA card unless told otherwise; without one it
    raises) in ``precision_k`` limbs (a solver keyword, default 2).
    Returns (bound, SolveResult) — bound = 1 + sum y_k."""
    cons, b, info = build_delsarte_constraints(n, d, costheta, prec)
    res = solverank1sdp(cons, b, info, device=device, **solver_kwargs)
    bound = 1.0 - res.dual_objective
    if return_problem:
        return bound, res, (cons, b, info)
    return bound, res
