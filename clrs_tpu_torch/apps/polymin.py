"""Multivariate polynomial minimization over the standard simplex.

A real application of the multivariate MPMP path (solvempmp ->
prepareabc with n-variate bases and simplex sample points) — the
reference ships only the univariate sphere-packing example
(examples/SpherePacking.jl) but its front-end is explicitly multivariate
(rational-simplex / Padua sample generators, MPMP.jl:94-170; n-variate
monomial bases, MPMP.jl:24-41).  This module exercises that surface on a
problem with checkable answers:

  lambda_d  =  max  lambda
               s.t. f(x) - lambda >= 0  on  Delta_n = { x_i >= 0,
                                                        1 - sum x_i >= 0 }

certified Handelman/Putinar style with weight polynomials
G = {1, x_1, ..., x_n, 1 - sum x_i} and SOS multipliers of degree <= 2d:
lambda_d is a monotone (in d) lower bound on min_{Delta} f, exact at
finite d for generic f.

MPMP encoding (same shape as the reference's constraints): one cluster,
M0 = f, M1 = -1 (so the constraint reads f + y_1 * (-1) >= 0), objective
b = [1] maximizes y_1 = lambda.

Counterpart of ``clrs_tpu/apps/polymin.py``; the solve runs on the device
given by ``device=``.
"""

from __future__ import annotations

import mpmath

from clrs_tpu_torch.models.bases import make_monomial_basis
from clrs_tpu_torch.models.mpmp import solvempmp
from clrs_tpu_torch.models.poly import MPoly, poly_matrix
from clrs_tpu_torch.models.samples import create_sample_points


def polymin_simplex(
    f: MPoly,
    nvars: int,
    d: int,
    prec: int = 256,
    device="cuda",
    **solver_kwargs,
):
    """Degree-d certified lower bound on min of `f` over the standard
    simplex in `nvars` variables.

    d is the half-degree of the SOS multipliers; the sampled constraint
    degree is delta = max(deg f, 2d + 1) and the sample set is the
    rational simplex grid of that degree (unisolvent,
    reference MPMP.jl:94-106).

    The solve runs on ``device`` (the CUDA card unless told otherwise;
    without one it raises).  Returns (bound, SolveResult): bound =
    lambda_d <= min_Delta f.
    """
    old_prec = mpmath.mp.prec
    mpmath.mp.prec = max(prec, mpmath.mp.prec)
    try:
        one = MPoly.constant(1, nvars)
        xs = MPoly.gens(nvars)
        delta = max(f.total_degree(), 2 * d + 1)
        G = [one] + list(xs) + [one - sum(xs[1:], xs[0])]
        q = make_monomial_basis(nvars, d)
        pts = create_sample_points(nvars, delta)
        M = [poly_matrix([[f]]), poly_matrix([[-one]])]
        defaults = dict(
            omega_p=100.0,
            omega_d=100.0,
            maxiterations=250,
            verbose=False,
            duality_gap_threshold=1e-10,
            primal_error_threshold=1e-20,
            dual_error_threshold=1e-12,
        )
        defaults.update(solver_kwargs)
        res = solvempmp([M], [G], [q], [pts], [delta], [1.0], device=device,
                        **defaults)
        return res.dual_objective, res
    finally:
        mpmath.mp.prec = old_prec
