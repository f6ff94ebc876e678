"""Static block metadata for the clustered SDP (jit-static).

Mirrors the reference's `BlockInfo` struct and `get_block_info`
(MPMP.jl:467-513, 516-560): the immutable description of the whole SDP —
numbers of clusters/blocks/samples, PSD block sizes, per-sample low ranks,
and the tuple-index layout of the x vector.  In the TPU build this is a
frozen, hashable dataclass: it parameterizes trace shapes, so it must be
usable as a jit-static argument.

Ragged ranks are padded: every (j, l) block stores `rmax[j][l]` vector
slots per sample, with zero weight H for the padding (the reference instead
prunes |H| <= 1e-70 entries, MPMP.jl:378-383; zero-H padding contributes
exactly zero to every pairing/trace/sum formula, so the two layouts are
numerically identical).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple


def pair_index(r: int, s: int) -> int:
    """Index of the ordered pair (r, s), s <= r, in the reference's tuple
    layout (MPMP.jl:1341: (s1-1) + r1(r1-1)/2, 0-based here)."""
    assert s <= r
    return s + r * (r + 1) // 2


def pair_list(m: int):
    """All (r, s) with s <= r in tuple order."""
    return [(r, s) for r in range(m) for s in range(r + 1)]


@dataclass(frozen=True)
class BlockInfo:
    """Static description of a clustered low-rank SDP.

    Attributes (all per-cluster j unless noted):
      J: number of clusters (constraints)
      n_y: number of free variables y
      m: size of the constraint polynomial matrix
      L: number of inner PSD blocks
      n_samples: number of sample points (K_j)
      delta: [j][l] basis length (vector length of each low-rank vector)
      rmax: [j][l] padded rank per sample
      Y_blocksizes: [j][l] = m_j * delta_jl
      dim_S: m(m+1)/2 * n_samples (rows of S_j / entries of x per cluster)
      x_indices: prefix sums of dim_S (length J+1)
    """

    J: int
    n_y: int
    m: Tuple[int, ...]
    L: Tuple[int, ...]
    n_samples: Tuple[int, ...]
    delta: Tuple[Tuple[int, ...], ...]
    rmax: Tuple[Tuple[int, ...], ...]
    Y_blocksizes: Tuple[Tuple[int, ...], ...] = field(default=())
    dim_S: Tuple[int, ...] = field(default=())
    x_indices: Tuple[int, ...] = field(default=())

    def __post_init__(self):
        if len(self.m) != self.J or len(self.L) != self.J or len(self.n_samples) != self.J:
            raise ValueError("m, L, n_samples must have length J")
        for j in range(self.J):
            if len(self.delta[j]) != self.L[j] or len(self.rmax[j]) != self.L[j]:
                raise ValueError(f"delta[{j}], rmax[{j}] must have length L[{j}]")
        if not self.Y_blocksizes:
            object.__setattr__(
                self,
                "Y_blocksizes",
                tuple(
                    tuple(self.m[j] * self.delta[j][l] for l in range(self.L[j]))
                    for j in range(self.J)
                ),
            )
        if not self.dim_S:
            object.__setattr__(
                self,
                "dim_S",
                tuple(
                    self.m[j] * (self.m[j] + 1) // 2 * self.n_samples[j]
                    for j in range(self.J)
                ),
            )
        if not self.x_indices:
            xi = [0]
            for j in range(self.J):
                xi.append(xi[-1] + self.dim_S[j])
            object.__setattr__(self, "x_indices", tuple(xi))

    @property
    def total_dim_S(self) -> int:
        return self.x_indices[-1]

    @property
    def total_psd_size(self) -> int:
        """Sum of all PSD block sizes = K in mu = <X, Y>/K (MPMP.jl:755)."""
        return sum(sum(bs) for bs in self.Y_blocksizes)

    def n_pairs(self, j: int) -> int:
        return self.m[j] * (self.m[j] + 1) // 2

    def tuple_index(self, j: int, r: int, s: int, k: int) -> int:
        """Global index of the x entry for tuple (j, r, s, k)."""
        return self.x_indices[j] + pair_index(r, s) * self.n_samples[j] + k

    def block_weight(self, j: int, l: int) -> int:
        """Cost proxy blocksize^3 — the reference's load-balancing weight
        (MPMP.jl:495)."""
        return self.Y_blocksizes[j][l] ** 3


def get_block_info(constraints: Sequence) -> BlockInfo:
    """Infer a BlockInfo from assembled constraint data.

    Accepts the same shape of data as the reference's get_block_info
    (MPMP.jl:516-560): a list of per-cluster tuples (A, B, c, H) where
    A[l][k] is a list of vectors (each a 1-D array-like of length delta),
    B is (dim_S, n_y), c is (dim_S,), H[l][k] is a list of weights.
    """
    J = len(constraints)
    n_y = int(_shape(constraints[0][1])[1])
    m_list, L_list, K_list, delta_list, rmax_list = [], [], [], [], []
    for j in range(J):
        A, B, c, H = constraints[j][:4]
        L = len(A)
        K = len(A[0])
        n_tuples = int(_shape(c)[0])
        # m(m+1)/2 * K = n_tuples  =>  m from the integer quadratic
        x = 2 * (n_tuples // K)
        m = int((-1 + math_isqrt(4 * x + 1)) // 2)
        assert m * (m + 1) // 2 * K == n_tuples, "inconsistent tuple count"
        deltas, rmaxs = [], []
        for l in range(L):
            nz = next((k for k in range(K) if len(A[l][k]) > 0), None)
            assert nz is not None, f"cluster {j} block {l} has no vectors"
            deltas.append(len(A[l][nz][0]))
            rmaxs.append(max(len(A[l][k]) for k in range(K)))
        m_list.append(m)
        L_list.append(L)
        K_list.append(K)
        delta_list.append(tuple(deltas))
        rmax_list.append(tuple(rmaxs))
    return BlockInfo(
        J=J,
        n_y=n_y,
        m=tuple(m_list),
        L=tuple(L_list),
        n_samples=tuple(K_list),
        delta=tuple(delta_list),
        rmax=tuple(rmax_list),
    )


def _shape(x):
    if hasattr(x, "shape"):
        return tuple(x.shape)
    # nested lists
    s = []
    while isinstance(x, (list, tuple)):
        s.append(len(x))
        x = x[0]
    return tuple(s)


def math_isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


def distribute_weights_swapping(weights, n, nswaps=None):
    """Greedy-then-swap static partition of weighted items over n workers.

    Re-derivation of the reference's load balancer (MPMP.jl:425-465): start
    from an even contiguous split, then repeatedly move/swap items between
    the heaviest and lightest sets while the maximum set weight decreases.
    Used for assigning clusters/blocks to hosts (SURVEY.md §2.5).
    Returns (sets, set_weights).
    """
    items = sorted(range(len(weights)), key=lambda i: -weights[i])
    sets = [[] for _ in range(n)]
    set_weights = [0.0] * n
    # greedy longest-processing-time
    for i in items:
        t = min(range(n), key=lambda s: set_weights[s])
        sets[t].append(i)
        set_weights[t] += weights[i]
    if nswaps is None:
        nswaps = len(weights) ** 2
    for _ in range(nswaps):
        hi = max(range(n), key=lambda s: set_weights[s])
        lo = min(range(n), key=lambda s: set_weights[s])
        best = None
        for a in sets[hi]:
            for b in sets[lo] + [None]:
                wa, wb = weights[a], (weights[b] if b is not None else 0.0)
                if wa <= wb:
                    continue
                new_hi = set_weights[hi] - wa + wb
                new_lo = set_weights[lo] + wa - wb
                if max(new_hi, new_lo) < set_weights[hi]:
                    gain = set_weights[hi] - max(new_hi, new_lo)
                    if best is None or gain > best[0]:
                        best = (gain, a, b)
        if best is None:
            break
        _, a, b = best
        sets[hi].remove(a)
        sets[lo].append(a)
        set_weights[hi] -= weights[a]
        set_weights[lo] += weights[a]
        if b is not None:
            sets[lo].remove(b)
            sets[hi].append(b)
            set_weights[lo] -= weights[b]
            set_weights[hi] += weights[b]
    return sets, set_weights
