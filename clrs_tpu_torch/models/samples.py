"""Unisolvent sample-point generators (reference: MPMP.jl:94-200).

All points are mpmath.mpf at the ambient working precision.
"""

from __future__ import annotations

from itertools import product
from typing import List

import mpmath


def create_sample_points(n: int, d: int) -> List[List[mpmath.mpf]]:
    """Rational points in the unit simplex with denominator d
    (MPMP.jl:94-106): (n+d choose d) points."""
    pts = []
    for tup in product(range(d + 1), repeat=n):
        if sum(tup) <= d:
            pts.append([mpmath.mpf(i) / d for i in tup])
    return pts


def create_sample_points_2d(d: int) -> List[List[mpmath.mpf]]:
    """Padua points (MPMP.jl:108-122)."""
    pts = []
    for j in range(d + 1):
        delta_j = 1 if (j % 2 == 1 and d % 2 == 1) else 0
        mu_j = mpmath.cospi(mpmath.mpf(j) / d)
        for k in range(1, d // 2 + 1 + delta_j + 1):
            if j % 2 == 1:
                eta_k = mpmath.cospi(mpmath.mpf(2 * k - 2) / (d + 1))
            else:
                eta_k = mpmath.cospi(mpmath.mpf(2 * k - 1) / (d + 1))
            pts.append([mu_j, eta_k])
    return pts


def create_sample_points_3d(d: int, pairs=((0, 2), (2, 1), (1, 0))) -> List[List[mpmath.mpf]]:
    """Padua x Chebyshev extension for 3 variables (MPMP.jl:124-145); best
    for odd d."""
    if d % 2 == 0:
        print(
            "n should be odd for the sample points to be good. "
            "Consider using different sample points."
        )
    pad = create_sample_points_2d(d)
    pad_div = [pad[0::3], pad[1::3], pad[2::3]]
    ch = create_sample_points_chebyshev(d + 2)
    cheb_div = [ch[0::3], ch[1::3], ch[2::3]]
    pts = []
    for (i1, i2) in pairs:
        for p1 in pad_div[i1]:
            for p2 in cheb_div[i2]:
                pts.append([*p1, p2])
    return pts


def points_X_general(n: int, d: int) -> List[List[mpmath.mpf]]:
    """Recursive general-n construction (MPMP.jl:147-170): 'sometimes good,
    not always'."""
    if n == 2:
        return create_sample_points_2d(d)
    Xn_1 = points_X_general(n - 1, d)
    cheb = create_sample_points_chebyshev(d + n - 1)
    X_div = [Xn_1[i::n] for i in range(n)]
    cheb_div = [cheb[i::n] for i in range(n)]
    pts = []
    for i in range(n):
        j = n - 1 if i == 0 else i - 1
        for p1 in X_div[i]:
            for p2 in cheb_div[j]:
                pts.append([*p1, p2])
    return pts


def create_sample_points_1d(d: int) -> List[mpmath.mpf]:
    """Simmons-Duffin 'rescaled Laguerre' points (MPMP.jl:173-182):
    x_k = -sqrt(pi)/(64(d+1) log(3-2 sqrt 2)) (-1+4k)^2, k = 0..d."""
    c = -mpmath.sqrt(mpmath.pi) / (
        64 * (d + 1) * mpmath.log(3 - 2 * mpmath.sqrt(2))
    )
    return [c * (-1 + 4 * k) ** 2 for k in range(d + 1)]


def create_sample_points_chebyshev(d: int, a=-1, b=1) -> List[mpmath.mpf]:
    """Chebyshev-root points on [a, b] (MPMP.jl:184-191)."""
    a, b = mpmath.mpf(a), mpmath.mpf(b)
    return [
        (a + b) / 2
        + (b - a) / 2 * mpmath.cos((2 * k - 1) * mpmath.pi / (2 * (d + 1)))
        for k in range(1, d + 2)
    ]


def create_sample_points_chebyshev_mod(d: int, a=-1, b=1) -> List[mpmath.mpf]:
    """Chebyshev roots scaled by 1/cos(pi/(2(d+1))) for a lower Lebesgue
    constant (MPMP.jl:193-200)."""
    a, b = mpmath.mpf(a), mpmath.mpf(b)
    scale = mpmath.cos(mpmath.pi / (2 * (d + 1)))
    return [
        (a + b) / 2
        + (b - a) / 2 * mpmath.cos((2 * k - 1) * mpmath.pi / (2 * (d + 1))) / scale
        for k in range(1, d + 2)
    ]
