"""N-species sphere-packing upper bounds (2-point Cohn-Elkies style).

Re-derivation of the reference application
(examples/SpherePacking.jl:28-129): the N-species packing-density bound of
de Laat-Oliveira-Vallentin via a single radial function with Laguerre
eigenbasis, posed as a multivariate polynomial matrix program.

Problem (examples/SpherePacking.jl:32-45): with f(x) = sum_k a_k k!/pi^k
L_k^{n/2-1}(pi |x|^2) and F(f) its Fourier transform,

  max -M  s.t.
    F(f)(0) - (vol B(r_i)^1/2 vol B(r_j)^1/2)_{ij}  >= 0          (NxN, G={1})
    F(f)(t) >= 0 for t >= 0                                        (NxN, G={1,x})
    -f_ij(w) >= 0 for w >= (r_i+r_j)^2, each i>=j                  (1x1)
    M - f_ii(0) >= 0 for each i                                    (1x1)

The resulting bound on the packing density is -M * sum_i vol B(r_i) ...
(reported as -M, matching the reference's printed `-cur_bound[end]`).

Counterpart of ``clrs_tpu/apps/sphere_packing.py``; the solve runs on the
device given by ``device=``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import mpmath
import numpy as np

from clrs_tpu_torch.core.blockinfo import get_block_info
from clrs_tpu_torch.core.solver import solverank1sdp
from clrs_tpu_torch.models.bases import laguerrebasis
from clrs_tpu_torch.models.poly import MPoly
from clrs_tpu_torch.models.prepare import prepareabc
from clrs_tpu_torch.models.samples import create_sample_points_1d


def spherevolume(n, r) -> mpmath.mpf:
    """Volume of the n-ball of radius r (examples/SpherePacking.jl:10-12)."""
    n = mpmath.mpf(n)
    return mpmath.sqrt(mpmath.pi) ** n / mpmath.gamma(n / 2 + 1) * mpmath.mpf(r) ** n


def laguerre(k: int, alpha, x: MPoly) -> MPoly:
    return laguerrebasis(k, alpha, x)[-1]


def standard_basis_matrix(N: int, i: int, j: int, element: MPoly, zero: MPoly):
    """Symmetric E_ij matrix with `element` at (i, j) and (j, i)
    (examples/SpherePacking.jl:17-26)."""
    E = np.full((N, N), zero, dtype=object)
    E[i, j] = element
    E[j, i] = element
    return E


def nsphere_packing_2point(
    n: int,
    d: int,
    r: Sequence,
    N: int = 2,
    prec: int = 512,
    omega=100.0,
    sdpb_path: Optional[str] = None,
    write_only: bool = False,
    reorder: bool = True,
    return_problem: bool = False,
    backend: str = "xla",
    build_only: bool = False,
    device="cuda",
    **solver_kwargs,
):
    """Compute the N-species sphere-packing bound (reference
    examples/SpherePacking.jl:28-114).  Returns (bound, SolveResult) where
    bound = -M* (the quantity compared to 0.813 for NaCl radii).

    The solve runs on ``device`` (the CUDA card unless told otherwise;
    without one it raises) in ``precision_k`` limbs (a solver keyword,
    default 2), packed at this function's raised mpmath precision.
    backend: "xla" and "host" both run the port's ``solverank1sdp``, as in
    ``models/mpmp.solvempmp``.  build_only returns (constraints, b,
    blockinfo) without solving.
    """
    if backend not in ("xla", "host"):
        raise ValueError(f"nsphere_packing_2point: backend {backend!r} is not 'xla' or 'host'")
    old_prec = mpmath.mp.prec
    mpmath.mp.prec = max(prec, mpmath.mp.prec)
    try:
        r = [mpmath.mpf(str(ri)) if not isinstance(ri, mpmath.mpf) else ri for ri in r]
        x = MPoly.var(0, 1)
        zero = MPoly.constant(0, 1)
        one = MPoly.constant(1, 1)
        npairs = N * (N + 1) // 2
        n_a = (2 * d + 1) * npairs  # a_{ij,k} for k=0:2d, i>=j
        n_y = 1 + n_a  # M plus the a's

        # variable order: y = (M, a_{ij,k} for k=0:2d for i for j<=i)
        def a_index(k, i, j):
            # examples/SpherePacking.jl:57 ordering: for k=0:2d for i for j<=i
            pos = 0
            for kk in range(2 * d + 1):
                for ii in range(N):
                    for jj in range(ii + 1):
                        if (kk, ii, jj) == (k, i, j):
                            return 1 + pos
                        pos += 1
            raise KeyError((k, i, j))

        def zeros_M():
            return [np.full((N, N), zero, dtype=object) for _ in range(1 + n_y)]

        # M0: F(f)(0) - vol matrix >= 0 (examples/SpherePacking.jl:56-57)
        M0 = [np.empty((N, N), dtype=object) for _ in range(1 + n_y)]
        for t in range(1 + n_y):
            M0[t][...] = zero
        for i in range(N):
            for j in range(N):
                M0[0][i, j] = MPoly.constant(
                    -mpmath.sqrt(spherevolume(n, r[i]) * spherevolume(n, r[j])), 1
                )
        for i in range(N):
            for j in range(i + 1):
                M0[1 + a_index(0, i, j)] = standard_basis_matrix(N, i, j, one, zero)

        # M1: F(f)(t) >= 0 on t >= 0 (examples/SpherePacking.jl:59)
        M1 = [np.full((N, N), zero, dtype=object) for _ in range(1 + n_y)]
        for k in range(2 * d + 1):
            for i in range(N):
                for j in range(i + 1):
                    M1[1 + a_index(k, i, j)] = standard_basis_matrix(
                        N, i, j, x**k, zero
                    )

        # M2: -f_ij(w) >= 0 on w >= (r_i+r_j)^2, one 1x1 constraint per pair
        # (examples/SpherePacking.jl:61-62)
        alpha = mpmath.mpf(n) / 2 - 1
        lag = [laguerre(k, alpha, x * mpmath.pi) for k in range(2 * d + 1)]
        M2 = []
        for i in range(N):
            for j in range(i + 1):
                Mj = [np.full((1, 1), zero, dtype=object) for _ in range(1 + n_y)]
                for k in range(2 * d + 1):
                    coef = mpmath.factorial(k) / mpmath.pi**k
                    Mj[1 + a_index(k, i, j)] = np.array(
                        [[lag[k] * (-coef)]], dtype=object
                    )
                M2.append(Mj)

        # M3: M - f_ii(0) >= 0 per species (examples/SpherePacking.jl:64-65)
        lag0 = [laguerre(k, alpha, MPoly.constant(0, 1)) for k in range(2 * d + 1)]
        M3 = []
        for i in range(N):
            Mj = [np.full((1, 1), zero, dtype=object) for _ in range(1 + n_y)]
            Mj[1] = np.array([[one]], dtype=object)  # the M variable
            for k in range(2 * d + 1):
                coef = mpmath.factorial(k) / mpmath.pi**k
                Mj[1 + a_index(k, i, i)] = np.array(
                    [[lag0[k] * (-coef)]], dtype=object
                )
            M3.append(Mj)

        M = [M0, M1] + M2 + M3

        # sample points (examples/SpherePacking.jl:69-72)
        lagpts = create_sample_points_1d(2 * d)
        sample_points = (
            [[mpmath.mpf(0)]]
            + [lagpts]
            + [
                [p + (r[i] + r[j]) ** 2 for p in lagpts]
                for i in range(N)
                for j in range(i + 1)
            ]
            + [[mpmath.mpf(0)] for _ in range(N)]
        )

        # weights (examples/SpherePacking.jl:75-78)
        G = (
            [[one]]
            + [[one, x]]
            + [
                [one, x - MPoly.constant((r[i] + r[j]) ** 2, 1)]
                for i in range(N)
                for j in range(i + 1)
            ]
            + [[one] for _ in range(N)]
        )

        # basis: Laguerre in 2 pi x, normalized per-polynomial by max |coef|
        # (examples/SpherePacking.jl:81-83)
        q = laguerrebasis(d, alpha, x * (2 * mpmath.pi))
        q = [qi * (1 / max(abs(c) for c in qi.coefficients())) for qi in q]

        delta = [0, 2 * d] + [2 * d] * npairs + [0] * N
        b = [mpmath.mpf(-1)] + [mpmath.mpf(0)] * n_a

        constraints = [
            prepareabc(M[j], G[j], q, sample_points[j], delta[j])
            for j in range(len(M))
        ]
        blockinfo = get_block_info(constraints)

        if sdpb_path:
            from clrs_tpu_torch.apps.sdpb_export import write_sdpb_files

            write_sdpb_files(sdpb_path, constraints, blockinfo, b)
            if write_only:
                return True

        if reorder and len(M) == 7:
            # SDPB-imitating constraint placement for N=2
            # (examples/SpherePacking.jl:99-105, 1-based [3,6,5,7,4,1,2])
            ordering = [2, 5, 4, 6, 3, 0, 1]
            constraints = [constraints[i] for i in ordering]
            blockinfo = get_block_info(constraints)

        if build_only:
            return constraints, b, blockinfo

        res = solverank1sdp(
            constraints,
            b,
            blockinfo,
            omega_p=omega,
            omega_d=omega,
            device=device,
            **solver_kwargs,
        )
        bound = -res.dual_objective
        if return_problem:
            return bound, res, (constraints, b, blockinfo)
        return bound, res
    finally:
        mpmath.mp.prec = old_prec


def test_bound_sphere_packing(n: int = 3, d: int = 8, **kwargs):
    """Known-answer check (examples/SpherePacking.jl:116-129): 2-species
    radii (1, sqrt(2)-1): published bound 0.813 (de Laat-Oliveira-Vallentin)
    vs the NaCl crystal density 0.793."""
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    bound, res = nsphere_packing_2point(n, d, r, 2, **kwargs)
    print(f"bound: {bound}")
    print("Compare to the density of NaCl: 0.793 (Current bound: 0.813)")
    return bound, res
