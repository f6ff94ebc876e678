"""The port's cost model: operation counts, bytes and the H100's peaks.

Counterpart of ``clrs_tpu/utils/flops.py``, and the one count of the
repository: ``chip_smoke.py`` and ``clrs_tpu_torch/tools/`` take their
bounds from here.  It holds two counts.

The reference's (``add_flops`` .. ``iteration_flops``, ``decomp_mfu``):
the hardware flops of the expansion arithmetic per IPM phase, counted by
mirroring ``ops/xfloat.py``'s cascades (two_sum = 6 flops, fast_two_sum =
3, two_prod = 17 with Dekker's splitting).  The port keeps the
reference's cascades, so these are the reference's integers.
``decomp_mfu`` sets them against the card's FP64 peak
(``fp64_peak_flops``, keyed by ``torch.cuda.get_device_name()``) as the
reference does; it is no roofline (the second count is).

The card's bound (``op_counts``, ``bound`` and the ``*_work`` functions):
the least time the card could take for a function, the larger of its
bytes (each input read once, each output written once) over the memory
rate and its FP64 instructions over their rate.  Instructions are counted
by running the plain arithmetic (``ops/xops.py``) on counting stand-ins,
a fused multiply-add once and every exact product as the FMA's 2,
whatever form a kernel runs.  Every bound counts the function's own work,
not a kernel's way of doing it: the SPD inverse's and the step-length
sandwich's least arithmetic, whichever route computes them (the
divisions by L's diagonal share its n reciprocals, as the kernels'
do).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np

TS = 6  # two_sum
FTS = 3  # fast_two_sum
TP = 17  # two_prod (incl. two Dekker splits)


@lru_cache(maxsize=None)
def add_flops(k: int) -> int:
    """Hardware flops of one k-limb expansion add (xfloat.xf_add path)."""
    if k <= 1:
        return 1
    if k == 2:  # _dd_add: 2 two_sum + 2 adds + 2 fast_two_sum
        return 2 * TS + 2 + 2 * FTS  # = 20
    if k == 3:  # _td_add, op-by-op: 5 two_sum + 3 adds + vec_sum(3)
        return 45
    if k == 4:  # _qw_add: 6 two_sum + 4 adds + renorm + vec_sum(4)
        return 76
    # generic _cascade_add, counted by mirroring its loops
    f = (k - 1) * TS  # per-order two_sums
    carry = 1
    for i in range(1, k - 1):
        f += carry * TS
        carry += 1
    f += 1 + carry  # top-order plain folds
    f += (k - 1) * TS  # renorm chain
    f += k * TS  # _vec_sum(k+1)
    return f


@lru_cache(maxsize=None)
def mul_flops(k: int) -> int:
    """Hardware flops of one k-limb expansion multiply (xf_mul path)."""
    if k <= 1:
        return 1
    if k == 2:  # _dd_mul: two_prod + 3 flops + fast_two_sum
        return TP + 3 + FTS  # = 23
    if k == 3:  # _td_mul, op-by-op (3 two_prod + folds + vec_sum)
        return 110
    if k == 4:  # _qw_mul, op-by-op (6 two_prod + folds + vec_sum)
        return 201
    # generic _cascade_mul, counted by mirroring the loops with
    # group-size counters (reproduces the 110 of _td_mul at k=3)
    f = 0
    groups = [0] * (k + 1)
    for o in range(k - 1):
        for i in range(o + 1):
            j = o - i
            if i < k and j < k:
                f += TP
                groups[o] += 1
                if o + 1 < k:
                    groups[o + 1] += 1
    cheap = 0
    for o in (k - 1, k):
        for i in range(o + 1):
            j = o - i
            if i < k and j < k:
                f += 1  # plain product
                if cheap:
                    f += 1  # plain add
                cheap += 1
    if cheap:
        groups[k - 1] += 1
    for o in range(k):
        extra = max(0, groups[o] - 1)
        if o == k - 1:
            f += extra
        else:
            f += extra * TS
            groups[o + 1] += extra
    f += (k - 1) * TS  # renorm chain
    f += k * TS  # _vec_sum
    return f


def matmul_flops(n: int, K: int, m: int, k: int) -> int:
    """xf_matmul / the matmul kernel: n*m*K expansion muls + tree-sum adds."""
    return n * m * (K * mul_flops(k) + max(0, K - 1) * add_flops(k))


def spd_inverse_flops(n: int, k: int) -> int:
    """Cholesky (n^3/3 mul+add pairs) + L^-1 forward solve (n^3/2) +
    W^T W (n^3/2), expansion-op counts; div/sqrt are lower order."""
    pairs = mul_flops(k) + add_flops(k)
    return int((n**3 / 3 + n**3 / 2 + n**3 / 2) * pairs)


def decomp_flops(info, k: int) -> int:
    """Schur build + factorization phase (compute_decomposition):
    pairings, S-entry assembly, per-cluster S^-1, Q = B^T S^-1 B, Q^-1."""
    total = 0
    for j in range(info.J):
        m = info.m[j]
        K = info.n_samples[j]
        dim = info.dim_S[j]
        npairs = m * (m + 1) // 2
        for l in range(info.L[j]):
            delta = info.Y_blocksizes[j][l] // m
            T = K * info.rmax[j][l]
            # two pairing tensors (X^-1 and Y), two matmuls each
            per_pairing = matmul_flops(m * delta * m, delta, T, k) + \
                matmul_flops(T, delta, m * m * T, k)
            total += 2 * per_pairing
            # S-entry assembly: npairs^2 pair-blocks, each 4 muls + 3 adds
            # + 1 HH mul over (T, T), plus rank segment-sums
            total += npairs * npairs * T * T * (5 * mul_flops(k)
                                                + 4 * add_flops(k))
            total += T * T * mul_flops(k)  # HH outer product
        # S_j^-1 and S_inv @ B, B^T @ (S^-1 B)
        total += spd_inverse_flops(dim, k)
        total += matmul_flops(dim, dim, info.n_y, k)
        total += matmul_flops(info.n_y, dim, info.n_y, k)
    total += spd_inverse_flops(info.n_y, k)
    return total


def direction_flops(info, k: int) -> int:
    """One compute_search_direction: Z, generic trace, saddle solves (+1
    refinement), weighted-A, dX, dY."""
    pairs = mul_flops(k) + add_flops(k)
    total = 0
    for j in range(info.J):
        m = info.m[j]
        K = info.n_samples[j]
        dim = info.dim_S[j]
        npairs = m * (m + 1) // 2
        for l in range(info.L[j]):
            bs = info.Y_blocksizes[j][l]
            delta = bs // m
            T = K * info.rmax[j][l]
            # Z = X^-1 (P Y - R): two bs^3 matmuls; dY: two more
            total += 4 * matmul_flops(bs, bs, bs, k)
            # generic trace: per (r, s) pair Z_rs @ V + hadamard
            total += npairs * (matmul_flops(delta, delta, T, k)
                               + T * delta * pairs)
            # weighted-A (P and dX): per pair V diag(w) V^T
            total += 2 * npairs * (delta * T * mul_flops(k)
                                   + matmul_flops(delta, T, delta, k))
        # saddle: S^-1 rx (x2 for refinement), S_inv_B dy, B^T products
        total += 2 * (matmul_flops(dim, dim, 1, k)
                      + 2 * matmul_flops(info.n_y, dim, 1, k)
                      + matmul_flops(dim, info.n_y, 1, k))
    total += 2 * matmul_flops(info.n_y, info.n_y, 1, k)  # Q^-1 ry
    return total


def steplength_flops(info, k: int) -> int:
    """One compute_step_length pass over X or Y: Cholesky + two
    triangular solves + eig bound per block."""
    pairs = mul_flops(k) + add_flops(k)
    total = 0
    for j in range(info.J):
        for l in range(info.L[j]):
            bs = info.Y_blocksizes[j][l]
            total += int((bs**3 / 3 + bs**3) * pairs)  # chol + 2 trisolve
            total += int(6 * bs**3 * 2)  # float64 Jacobi sweeps (plain)
    return total


def iteration_flops(info, k: int) -> int:
    """One full IPM iteration (predictor + corrector)."""
    pairs = mul_flops(k) + add_flops(k)
    total = decomp_flops(info, k)
    total += 2 * direction_flops(info, k)  # predictor + corrector
    total += 2 * steplength_flops(info, k)  # X and Y passes
    elem = 0
    for j in range(info.J):
        for l in range(info.L[j]):
            bs = info.Y_blocksizes[j][l]
            # R (x2), X^-1, residual P, updates: a few bs^3 matmuls + bs^2
            elem += 3 * matmul_flops(bs, bs, bs, k) + 6 * bs * bs * pairs
            elem += spd_inverse_flops(bs, k)
    total += elem
    return total


# The float64 peak by card name (NVIDIA's data sheet, dense, outside the
# tensor cores, where the expansion arithmetic runs; an FMA counted as two
# flops).  A card may run below it under a power limit under 700 W:
# nvidia-smi's power.limit says so.
PEAKS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 34e12,  # SXM5
}


def fp64_peak_flops(device_name: Optional[str] = None) -> float:
    """The card's float64 peak in flop/s; device_name defaults to
    torch.cuda.get_device_name(0).  A card not in PEAKS raises: no figure
    stands in for one that was not looked up."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    if device_name not in PEAKS:
        raise KeyError(f"no FP64 peak known for {device_name!r}; known: {sorted(PEAKS)}")
    return PEAKS[device_name]


def decomp_mfu(info, k: int, decomp_seconds: float,
               device_name: Optional[str] = None) -> float:
    """Achieved fraction of the card's float64 peak in one decomposition
    phase (decomp ms/iter over decomp_flops).  Kept to match the
    reference: its count is the reference's hardware-flop model (Dekker
    products, the dense SPD inverse), several times the card's own
    instructions, so it feeds no roofline; a bound or a share of one
    comes from ``bound`` and the ``*_work`` functions below."""
    if decomp_seconds <= 0:
        return float("nan")
    return decomp_flops(info, k) / decomp_seconds / fp64_peak_flops(device_name)


# ---------------------------------------------------------------------------
# The card's bound: FP64 instructions and bytes
# ---------------------------------------------------------------------------

# the card every bound of the repository is stated for: the H100 SXM5
HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = PEAKS["NVIDIA H100 80GB HBM3"]
# the FP64 instruction rate: adds, multiplies and fused multiply-adds, one each
FP64_INSTR_PER_S = FP64_PER_S / 2


class _Count:
    """A stand-in float that counts the FP64 instructions applied to it.
    An exact product (xfloat.two_prod, Dekker's splitting, 17 operations)
    counts as the 2 of its fused multiply-add form (csrc/eft.cuh:
    two_prod_fma), whichever form a kernel runs: a bound counts the least
    the function needs.  Dekker's two splits of an exact product each
    begin with a multiply by 2^27 + 1, which marks them."""

    n = 0
    splits = 0
    mark = None  # xfloat's split constant, 2^27 + 1

    def _op(self, other=None):
        _Count.n += 1
        if isinstance(other, float) and other == _Count.mark:
            _Count.splits += 1
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op

    def __neg__(self):
        return self._op()

    @classmethod
    def instructions(cls, fn, k):
        """FP64 instructions of fn on two k-limb stand-ins."""
        from clrs_tpu_torch.ops import xfloat

        cls.n, cls.splits, cls.mark = 0, 0, xfloat._SPLIT
        fn([cls() for _ in range(k)], [cls() for _ in range(k)])
        assert cls.splits % 2 == 0
        return cls.n - (TP - 2) * (cls.splits // 2)


def op_counts(k: int) -> dict:
    """FP64 instructions of one k-limb add, multiply, reciprocal, div and
    sqrt (add and mul counted by running the plain arithmetic on counting
    stand-ins, every exact product as an FMA's 2)."""
    from clrs_tpu_torch.ops import xops

    c = {"add": _Count.instructions(xops.add, k), "mul": _Count.instructions(xops.mul, k)}
    steps = max(1, int(np.ceil(np.log2(k))) + 1)
    c["recip"] = 1 + steps * (2 * c["mul"] + 2 * c["add"] + k)
    c["div"] = c["recip"] + 3 * c["mul"] + 2 * c["add"] + k
    c["sqrt"] = 2 + (steps + 1) * (3 * c["mul"] + 2 * c["add"] + 2 * k)
    return c


def bound(nbytes: float, instructions: float):
    """The least time the card could take (ms), and what bounds it: the
    bytes over the memory rate, or the FP64 instructions over their
    rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, instructions / FP64_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def matmul_work(k, B, n, K, m, steps, Ba=None, Bb=None):
    """K3/K4: bytes of A (Ba matrices, B where not broadcast), B (Bb) and
    C, and steps multiply-adds per output."""
    c = op_counts(k)
    Ba, Bb = Ba or B, Bb or B
    return (8 * k * (Ba * n * K + Bb * K * m + B * n * m),
            B * n * m * steps * (c["mul"] + c["add"]))


def schur_work(k, G, m, T):
    """K2: the bytes it must touch, PX and PY (m^2 T^2 each), HH (T^2) and
    the output (P^2 T^2, P = m (m + 1) / 2) once per cluster, and 5
    multiplies and 3 adds per output entry."""
    c = op_counts(k)
    P = m * (m + 1) // 2
    return (8 * k * G * T * T * (2 * m * m + 1 + P * P),
            G * P * P * T * T * (5 * c["mul"] + 3 * c["add"]))


def _divisions(c, n, count):
    """count divisions by the n entries of L's diagonal: each reciprocal
    taken once and reused, each division then its refinement alone
    (xops.div past its xops.recip)."""
    return n * c["recip"] + count * (c["div"] - c["recip"])


def spd_inverse_function_work(k, B, n):
    """The SPD inverse as a function, whatever route computes it (K1, K5's
    single launch or its panel route, K9): A read and A^-1 written once
    (k limbs each, a flag a block), and the least arithmetic it needs: the
    multiply-adds of the Cholesky ((n^3 - n) / 6), of W = L^-1 ((n^3 - n)
    / 6) and of the symmetric W^T W (n (n + 1) (n + 2) / 6), n square
    roots, and n^2 divisions by L's n diagonal entries (n (n - 1) / 2 in
    the Cholesky, n (n + 1) / 2 in L^-1)."""
    c = op_counts(k)
    macs = (n ** 3 - n) // 3 + n * (n + 1) * (n + 2) // 6
    ops = macs * (c["mul"] + c["add"]) + _divisions(c, n, n * n) + n * c["sqrt"]
    return 8 * B * (2 * k * n * n + 1), B * ops


def steplen_function_work(k, B, n):
    """The step length's sandwich as a function (K7): per block M and dM
    read (k limbs each), the float64 L^-1 dM L^-T and a flag written, and
    the least arithmetic it needs: the Cholesky's multiply-adds ((n^3 - n)
    / 6), n square roots and n (n - 1) / 2 divisions; W = L^-1 dM on n
    columns (n^2 (n - 1) / 2 multiply-adds, n^2 divisions); and the lower
    triangle of the symmetric W L^-T by forward substitution ((n^3 - n) / 6
    multiply-adds, n (n + 1) / 2 divisions), with one plain add per output
    entry; the 2 n^2 divisions share L's n diagonal entries."""
    c = op_counts(k)
    macs = (n ** 3 - n) // 3 + n * n * (n - 1) // 2
    ops = macs * (c["mul"] + c["add"]) + _divisions(c, n, 2 * n * n) + n * c["sqrt"] + n * n
    return 8 * B * (2 * k * n * n + n * n + 1), B * ops


def elemwise_work(k, N, op):
    """K8: two k-limb operands read and one written, N elements of op."""
    return 3 * k * 8 * N, N * op_counts(k)[op]
