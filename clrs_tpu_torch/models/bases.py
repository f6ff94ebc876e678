"""Orthogonal polynomial basis generators (reference: MPMP.jl:22-92).

All recurrences are evaluated in mpmath precision so the sampled SDP data
is exact to the working precision before rounding to XF limbs.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import List, Union

import mpmath

from clrs_tpu_torch.models.poly import MPoly, _mpf


def make_monomial_basis(nvars: int, d: int) -> List[MPoly]:
    """Monomial basis of total degree <= d ('in general a very bad choice',
    MPMP.jl:24-41); (n+d choose d) polynomials ordered by degree."""
    out = []
    for k in range(d + 1):
        for combo in combinations_with_replacement(range(nvars), k):
            e = [0] * nvars
            for i in combo:
                e[i] += 1
            out.append(MPoly({tuple(e): mpmath.mpf(1)}, nvars))
    return out


def laguerrebasis(k: int, alpha, x: MPoly) -> List[MPoly]:
    """Generalized Laguerre polynomials L_0..L_k in the polynomial x
    (MPMP.jl:43-54)."""
    alpha = _mpf(alpha)
    v = [MPoly.constant(1, x.nvars)]
    if k == 0:
        return v
    v.append(MPoly.constant(1 + alpha, x.nvars) - x)
    for l in range(2, k + 1):
        lm = mpmath.mpf(l)
        nxt = (
            (MPoly.constant(2 * lm - 1 + alpha, x.nvars) - x) * v[l - 1]
            - (lm + alpha - 1) * v[l - 2]
        ) * (1 / lm)
        v.append(nxt)
    return v


def jacobi_basis(d: int, alpha, beta, x: MPoly, normalized: bool = True) -> List[MPoly]:
    """Jacobi-polynomial basis (MPMP.jl:56-75), same recurrence and the same
    normalization switch as the reference."""
    alpha = _mpf(alpha)
    beta = _mpf(beta)
    q = [MPoly.constant(1, x.nvars)]
    if d == 0:
        return q
    q1 = x
    if not normalized:
        q1 = x * (alpha + 1)
    q.append(q1)
    for k in range(2, d + 1):
        km = mpmath.mpf(k)
        c0 = (2 * km + alpha + beta - 1) / (
            2 * km * (km + alpha + beta) * (2 * km + alpha + beta - 2)
        )
        inner = (
            x * ((2 * km + alpha + beta) * (2 * km + alpha + beta - 2))
            + (beta**2 - alpha**2)
        )
        nxt = (inner * q[k - 1]) * c0 + q[k - 2] * (
            -2 * (km + alpha - 1) * (km + beta - 1) * (2 * km + alpha + beta)
        )
        q.append(nxt)
    return q


def gegenbauer_basis(k: int, n: Union[int, float], x: MPoly) -> List[MPoly]:
    """Gegenbauer polynomials for dimension n, normalized to 1 at 1
    (MPMP.jl:77-92) — the kernel of the Delsarte LP bound."""
    n = _mpf(n)
    v = [MPoly.constant(1, x.nvars)]
    if k == 0:
        return v
    v.append(x)
    for l in range(2, k + 1):
        lm = mpmath.mpf(l)
        nxt = x * v[l - 1] * ((2 * lm + n - 4) / (lm + n - 3)) - v[l - 2] * (
            (lm - 1) / (lm + n - 3)
        )
        v.append(nxt)
    return v
