"""Minimal multivariate polynomials over mpmath reals (host-side, setup only).

The reference leans on Julia's AbstractAlgebra for its polynomial layer
(MPMP.jl:5, ring construction in examples/SpherePacking.jl:47-51).  The
TPU build needs only a thin slice of that: construction, ring arithmetic,
total degree, coefficient access, and evaluation at high-precision points —
all used exclusively at setup time by prepareabc, so a dict-keyed
implementation over mpmath.mpf is plenty and keeps full control of
precision.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import mpmath

Exponent = Tuple[int, ...]


def _mpf(v):
    if isinstance(v, mpmath.mpf):
        return v
    if isinstance(v, (int, float, str)):
        return mpmath.mpf(v)
    if isinstance(v, mpmath.mpc):
        return v.real
    # Fraction, numpy scalars
    try:
        return mpmath.mpf(v)
    except Exception:
        return mpmath.mpf(float(v))


class MPoly:
    """Multivariate polynomial: {exponent tuple: mpf coefficient}."""

    __slots__ = ("coeffs", "nvars")

    def __init__(self, coeffs: Dict[Exponent, mpmath.mpf], nvars: int):
        self.nvars = nvars
        self.coeffs = {e: c for e, c in coeffs.items() if c != 0}

    # -- constructors --
    @staticmethod
    def constant(c, nvars: int = 1) -> "MPoly":
        return MPoly({(0,) * nvars: _mpf(c)}, nvars)

    @staticmethod
    def var(i: int = 0, nvars: int = 1) -> "MPoly":
        e = [0] * nvars
        e[i] = 1
        return MPoly({tuple(e): mpmath.mpf(1)}, nvars)

    @staticmethod
    def gens(nvars: int) -> Tuple["MPoly", ...]:
        return tuple(MPoly.var(i, nvars) for i in range(nvars))

    def _lift(self, other) -> "MPoly":
        if isinstance(other, MPoly):
            assert other.nvars == self.nvars
            return other
        return MPoly.constant(other, self.nvars)

    # -- ring ops --
    def __add__(self, other):
        other = self._lift(other)
        out = dict(self.coeffs)
        for e, c in other.coeffs.items():
            out[e] = out.get(e, mpmath.mpf(0)) + c
        return MPoly(out, self.nvars)

    __radd__ = __add__

    def __neg__(self):
        return MPoly({e: -c for e, c in self.coeffs.items()}, self.nvars)

    def __sub__(self, other):
        return self + (-self._lift(other))

    def __rsub__(self, other):
        return self._lift(other) + (-self)

    def __mul__(self, other):
        if not isinstance(other, MPoly):
            c = _mpf(other)
            return MPoly({e: v * c for e, v in self.coeffs.items()}, self.nvars)
        assert other.nvars == self.nvars
        out: Dict[Exponent, mpmath.mpf] = {}
        for e1, c1 in self.coeffs.items():
            for e2, c2 in other.coeffs.items():
                e = tuple(a + b for a, b in zip(e1, e2))
                out[e] = out.get(e, mpmath.mpf(0)) + c1 * c2
        return MPoly(out, self.nvars)

    __rmul__ = __mul__

    def __truediv__(self, other):
        assert not isinstance(other, MPoly), "polynomial division not supported"
        inv = 1 / _mpf(other)
        return self * inv

    def __pow__(self, n: int):
        assert n >= 0
        out = MPoly.constant(1, self.nvars)
        base = self
        while n:
            if n & 1:
                out = out * base
            base = base * base
            n >>= 1
        return out

    def __eq__(self, other):
        other = self._lift(other)
        return self.coeffs == other.coeffs

    # -- queries --
    def total_degree(self) -> int:
        if not self.coeffs:
            return 0  # reference convention: deg(0) treated as 0 in tables
        return max(sum(e) for e in self.coeffs)

    def is_zero(self) -> bool:
        return not self.coeffs

    def coefficients(self):
        return list(self.coeffs.values())

    def __call__(self, *pts):
        """Evaluate at mpf point(s), full mpmath precision."""
        if len(pts) == 1 and isinstance(pts[0], (list, tuple)):
            pts = tuple(pts[0])
        assert len(pts) == self.nvars, (len(pts), self.nvars)
        pts = [_mpf(p) for p in pts]
        tot = mpmath.mpf(0)
        for e, c in self.coeffs.items():
            term = c
            for xi, ei in zip(pts, e):
                if ei:
                    term = term * xi**ei
            tot += term
        return tot

    def __repr__(self):
        terms = []
        for e, c in sorted(self.coeffs.items()):
            mono = "*".join(
                f"x{i}^{ei}" if ei > 1 else f"x{i}"
                for i, ei in enumerate(e)
                if ei
            )
            terms.append(f"{mpmath.nstr(c, 8)}{'*' + mono if mono else ''}")
        return " + ".join(terms) if terms else "0"


def poly_matrix(entries) -> "object":
    """Nested-list -> numpy object matrix of MPoly (SN(...) analogue)."""
    import numpy as np

    return np.asarray(entries, dtype=object)


def constant_matrix(values, nvars: int = 1):
    """Matrix of constants lifted to MPoly."""
    import numpy as np

    arr = np.asarray(values, dtype=object)
    out = np.empty(arr.shape, dtype=object)
    it = np.nditer(arr, flags=["multi_index", "refs_ok"])
    for v in it:
        out[it.multi_index] = MPoly.constant(v.item(), nvars)
    return out
