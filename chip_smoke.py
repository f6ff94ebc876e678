"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. requires a CUDA device; prints the card's name and power limit, and
     starts the CPU reference solves of phases 4, 5 and 7 and the plain
     versions of phase 3's K5 and K7 tree rows in worker processes (they
     need no card);
  2. builds the hand-written kernels (clrs_tpu_torch/csrc, one nvcc per
     source, all at once) and prints the build seconds and ptxas's
     registers and spills of the k-limb kernels at k=3, 10 and 12, of the
     matmul, the Schur block and the SPD inverse also at k=2 (K3, K2, K1),
     and of K9;
  3. runs each kernel (K1 SPD inverse, the k=2 instance of K5's kernel,
     also at n = 257 and 1024, K2 the Schur block at k=2 and k on the
     pairings laid out as compute_pairings returns them, also at m=2
     rank 2 and wide, K3 and K4 matmul at k=2 and k >= 3, K5 k-limb SPD
     inverse, K7 step-length sandwich, K8 elementwise k-limb add and
     multiply, K9 the dd SPD inverse for many small matrices) against its
     plain PyTorch version on the card, at every Delsarte config-1 shape
     of the main path, K2, K4 and K5 at k = 3, 4, 6, 10, K7 at k = 2, 3,
     4, 6, 10 (first the iteration's one launch over both sides' 6x6 and
     5x5 blocks, then each size alone), K8 at every k = 2..12 (and at
     k >= 5 against xfloat's own add and multiply), K9 also against K1
     (and K1's time beside it) at n = 1, 2, 31, 32, 33, 64, 65 and 512 on
     B-major and batch-minor inputs, and at wide shapes; K3 and K4 also
     on operands read in place (V.mT as A and as B, a broadcast batch) at
     k = 2, 3, 4, 6, 10, 12; K8 also on broadcast operands read in place
     and on operands of fewer limbs, K5 and K7 also at n = 1, 2, 31, 32,
     33, 64, 65 (every shape of their halving trees) at k = 3 and 12 with
     one indefinite block: limbs and flags must be bitwise equal; prints
     the kernel's median time of one call, its time per call over a run
     of back-to-back calls, the plain version's median time, and each
     call's bound (bytes over 3.35 TB/s or FP64 instructions over their
     rate, 1.7e13 per second, an FMA counted as one and every exact
     product as the FMA's 2, whatever form the kernel runs; the larger);
  4. solves the Delsarte kissing-number bound in dimension 8 at 2d=10 on
     the card at k=2 with every launch counter reset first: K1, K2 and K3
     must have launched, the bound must be 240 to 1e-9, and the run must
     follow the same solve on the CPU, routed through the kernels' plain
     versions (same status, iterations within 2, p_obj/d_obj/gap within
     1e-10 relative until an error reaches the double-double floor 1e-20);
  5. solves the same bound at k=3 on the card, counters reset: K2, K4 and
     K5 must have launched (K1 and K3 are k=2 kernels and must not), the
     status must be `optimal` with the bound 240 to 1e-12, and the run must
     follow the CPU's on the same route as in phase 4, over the whole
     history (the k=3 noise floor, ~1e-45, lies far below the 1e-30
     thresholds);
  6. solves the dimension-24 bound (2d=20, k=2) on the card, counters
     reset: K1, K2 and K3 must have launched, and the bound is 196560 to
     1e-3;
  7. solves config 1 at k=3 on the all-kernels route (use_cuda_inverse,
     use_cuda_steplength, use_cuda_elemwise), counters reset: K2, K4, K5,
     K7 (one launch per iteration) and K8 must have launched and K1, K3
     and K9 must
     not; the run must follow the CPU port on the same route as in phase 5
     and end `optimal` with the bound 240 to 1e-12 within 2 iterations of
     phase 5; prints both routes' steady it/s and ms/iter by phase side by
     side;
  8. profiles iterations 3-6 of phase 7's route with torch.profiler: the
     device's busy share, the device time per launch of K8, K5, K7, K4 and
     K2, launches per iteration by kernel name with copies apart and the
     copy launches in all, the aten ops under K8's and K3/K4's call paths
     and the Schur block's (a copy among them fails the phase, and so does
     a Schur block entered other than once per K2 launch), and the step
     length's split
     between K7, the float64 Jacobi bound and xf_min_eig_sym; then the
     decomposition phase of iteration 3 of config 1 at k=2 for K1's
     device time per launch (K1 and K5 told apart by the template
     instance in the kernel's name);
  9. prints the kernels' JSON line, then the result line
     {"ok": true, "device": {...}} as the last line.
The full record also goes to chiprun_out/chip_smoke.json.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time
from multiprocessing import get_context

import mpmath  # noqa: F401  (the port's front-end needs it; fail loudly here)
import numpy as np
import torch

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "spd_inverse_dd": ("clrs_tpu_torch/csrc/spd_inverse_xf.cu",
                       "clrs_tpu/ops/pallas_dd.py:151"),
    "schur_pairs_dd": ("clrs_tpu_torch/csrc/schur_pairs.cu",
                       "clrs_tpu/ops/pallas_xf.py:591"),
    "matmul_dd": ("clrs_tpu_torch/csrc/matmul_xf.cu", "clrs_tpu/ops/pallas_xf.py:359"),
    "schur_pairs_xf": ("clrs_tpu_torch/csrc/schur_pairs.cu",
                       "clrs_tpu/ops/pallas_xf.py:591"),
    "matmul_xf (K4, K6)": ("clrs_tpu_torch/csrc/matmul_xf.cu",
                           "clrs_tpu/ops/pallas_xf.py:443"),
    "spd_inverse_xf": ("clrs_tpu_torch/csrc/spd_inverse_xf.cu",
                       "clrs_tpu/ops/pallas_xf.py:730"),
    "steplen_xf": ("clrs_tpu_torch/csrc/steplen_xf.cu", "clrs_tpu/ops/pallas_xf.py:887"),
    "elemwise_xf": ("clrs_tpu_torch/csrc/elemwise_xf.cu",
                    "clrs_tpu/ops/pallas_xf.py:1157"),
    "spd_inverse_dd_wide": ("clrs_tpu_torch/csrc/spd_inverse_dd_wide.cu",
                            "clrs_tpu/ops/pallas_dd.py:337"),
}
# the solve whose launches each kernel's JSON entry reports, and the limb
# count of its first main-path shape there; K9 is an entry point that no
# solver route calls, so its solve count is phase 4's zero
KERNEL_PATH = {"spd_inverse_dd": (2, 2), "schur_pairs_dd": (2, 2), "matmul_dd": (2, 2),
               "schur_pairs_xf": (3, 3), "matmul_xf (K4, K6)": (3, 3),
               "spd_inverse_xf": (3, 3), "steplen_xf": ("all", 3),
               "elemwise_xf": ("all", 3), "spd_inverse_dd_wide": (2, 2)}
STEPLEN_LADDER = (2, 3, 4, 6, 10)
ALL_KERNELS_ROUTE = dict(use_cuda_inverse=True, use_cuda_steplength=True,
                         use_cuda_elemwise=True)
LADDER = (3, 4, 6, 10)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP64_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores, an FMA counted as two
# the FP64 instruction rate: adds, multiplies and fused multiply-adds, one each
FP64_INSTR_PER_S = FP64_PER_S / 2
SOLVE = dict(omega_p=100.0, omega_d=100.0, verbose=False)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Operation counts and bounds
# ---------------------------------------------------------------------------


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
        return cls.n - (17 - 2) * (cls.splits // 2)


def op_counts(k: int) -> dict:
    """FP64 instructions of one k-limb add, multiply, div and sqrt (add and
    mul counted by running the plain arithmetic on counting stand-ins,
    every exact product as an FMA's 2)."""
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


def _chol_solve_ops(k, n):
    """Operations of the Cholesky and one forward substitution of n rows
    (K1, K5, K7), each matvec through the halving tree, the reciprocal of
    each diagonal entry of L taken once and every div by it the five
    operations that follow (csrc/eft.cuh: xf_div_recip)."""
    c = op_counts(k)
    np2 = 1 << max(n - 1, 0).bit_length()
    matvec = n * c["mul"] + (np2 - 1) * c["add"] + k + c["add"]
    div = c["div"] - c["recip"]
    chol = n * (n * matvec + c["sqrt"] + c["recip"] + n * div)
    solve = n * n * (matvec + div)
    return chol, solve, matvec, div


def spd_inverse_work(k, B, n):
    c = op_counts(k)
    chol, solve, _, _ = _chol_solve_ops(k, n)
    wtw = n * n * n * (c["mul"] + c["add"])
    return 8 * B * (2 * k * n * n + n), B * (chol + solve + wtw)


def steplen_work(k, B, n):
    """K7: K5's Cholesky and row solve, then a column solve of n^2 entries
    (a matvec and a div each, the masks n^2 k products) and the plain
    output add; reads M and dM, writes W and the flags."""
    chol, solve, matvec, div = _chol_solve_ops(k, n)
    cols = n * n * (matvec + div + n * k) + n * n
    return 8 * B * (2 * k * n * n + n * n + n), B * (chol + solve + cols)


def elemwise_work(k, N, op):
    return 3 * k * 8 * N, N * op_counts(k)[op]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def median_ms(fn, reps: int, warm: bool = True) -> float:
    """Median wall time of fn on the card, by CUDA events."""
    if warm:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def many_ms(fn, count: int) -> float:
    """fn's time per call over count back-to-back calls between two CUDA
    events (warmed up first): where the device outpaces the host this is
    the host's call path, where not the kernel's own time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int64),
                                              b.contiguous().view(torch.int64))


def rand_xf(rng, shape, k, dev):
    """(k, *shape) normalized k-limb expansions."""
    limbs = [rng.standard_normal(shape)]
    for _ in range(1, k):
        limbs.append(rng.uniform(-0.5, 0.5, shape) * np.spacing(np.abs(limbs[-1])))
    return torch.from_numpy(np.stack(limbs)).to(dev)


def spd_batch(rng, B, n, k, cond, dev):
    """(B, k, n, n) symmetric positive definite blocks of condition ~cond."""
    out = np.zeros((B, k, n, n))
    for b in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
        out[b, 0] = (A + A.T) / 2
        for q in range(1, k):
            lo = rng.uniform(-0.5, 0.5, (n, n)) * np.spacing(np.abs(out[b, q - 1]))
            out[b, q] = (lo + lo.T) / 2
    return torch.from_numpy(out).to(dev)


IN_PLACE_KS = (2, 3, 4, 6, 10, 12)


def in_place_operands(rng, k, dev):
    """K3/K4 operands as the solver hands them over, uncopied: (label,
    (a, b), (B, n, K, m, matrices of a, matrices of b))."""
    V = rand_xf(rng, (1, 6, 11), k, dev)
    return (("V.mT as A (11,6)x(6,11)", (V.transpose(-1, -2), rand_xf(rng, (1, 6, 11), k, dev)),
             (1, 11, 6, 11, 1, 1)),
            ("V.mT as B (6,11)x(11,6)", (rand_xf(rng, (1, 6, 11), k, dev), V.transpose(-1, -2)),
             (1, 6, 11, 6, 1, 1)),
            ("broadcast (6,6)x3x(6,11)", (rand_xf(rng, (1, 6, 6), k, dev),
                                          rand_xf(rng, (3, 6, 11), k, dev)),
             (3, 6, 6, 11, 1, 3)))


# config-1 products of _mm (B, n, K, m): pairings, weighted-A and trace-A
# of the 6x6 and 5x5 blocks, and the ten 1x1 sign blocks batched as B=10
MATMUL_SHAPES = (("(6,6)x(6,11)", (1, 6, 6, 11)), ("(11,6)x(6,11)", (1, 11, 6, 11)),
                 ("(6,11)x(11,6)", (1, 6, 11, 6)), ("(5,5)x(5,11)", (1, 5, 5, 11)),
                 ("(11,5)x(5,11)", (1, 11, 5, 11)), ("(5,11)x(11,5)", (1, 5, 11, 5)),
                 ("signs 10x(1,1)x(1,1)", (10, 1, 1, 1)))
# K2's blocks (G, m, K, rmax): config 1's cluster (the two blocks' shape)
# and its ten sign clusters as one group, then two clusters of m=2 at rank
# 2 and the wide block (P = 6 pairs, T = 128)
SCHUR_SHAPES = (("config1 G=1 m=1 K=11 rmax=1", (1, 1, 11, 1)),
                ("signs G=10 m=1 K=1 rmax=1", (10, 1, 1, 1)),
                ("G=2 m=2 K=3 rmax=2", (2, 2, 3, 2)),
                ("wide G=1 m=3 K=64 rmax=2", (1, 3, 64, 2)))
SCHUR_MAIN = 2  # the first two are the main path's
# K9 beyond the config-1 shapes: every shape of the halving tree and its
# cap, on two blocks (the second indefinite), B-major and batch-minor
WIDE_TREE_SIZES = (1, 2, 31, 32, 33, 64, 65, 512)
INVERSE_SHAPES = (("S_j 1x11x11", (1, 11, 1e8)), ("Q 1x10x10", (1, 10, 1e6)),
                  ("signs 10x1x1", (10, 1, 1.0)))
ELEMWISE_SHAPES = (("()", ()), ("(11,)", (11,)), ("(6,6)", (6, 6)), ("(10,1,1)", (10, 1, 1)),
                   ("(11,11)", (11, 11)), ("wide 2^20", (1 << 20,)))
# K8 on operands of other shapes or limb counts, read in place: (label,
# (shape a, limbs a), (shape b, limbs b)), limbs 0 meaning k and -1 k - 1
ELEMWISE_OPERANDS = (("(10,1,1)x(10,11,11)", ((10, 1, 1), 0), ((10, 11, 11), 0)),
                     ("()x(11,)", ((), 0), ((11,), 0)),
                     ("(6,1)x(1,6)", ((6, 1), 0), ((1, 6), 0)),
                     ("2-limb (11,11)", ((11, 11), 2), ((11, 11), 0)),
                     ("(k-1)-limb (6,6)", ((6, 6), -1), ((6, 6), 0)))
# K5 and K7 where the halving tree changes shape (csrc/chol_xf.cuh)
TREE_SIZES = (1, 2, 31, 32, 33, 64, 65)
TREE_WORKERS = 4  # CPU processes for the tree rows' plain versions


def schur_operands(rng, k, G, m, K, rmax, dev):
    """K2's operands: pairings laid out as compute_pairings returns them
    (transposed views of (k, G, T, m, m, T): t2 at unit stride, t1 at
    stride m^2 T) and positive weights HH (k, G, T, T)."""
    T = K * rmax
    px, py = (rand_xf(rng, (G, T, m, m, T), k, dev).permute(0, 1, 3, 2, 4, 5)
              for _ in range(2))
    return px, py, rand_xf(rng, (G, T, T), k, dev).abs()


def tree_inputs(k, n):
    """The tree rows' inputs, on the CPU, the same in every process: two
    SPD blocks for K5, two blocks M and a symmetric dM for K7, the second
    block of each indefinite."""
    rng = np.random.default_rng(1000 + 100 * k + n)
    a = spd_batch(rng, 2, n, k, 1e6, "cpu")
    m = spd_batch(rng, 2, n, k, 1e6, "cpu")
    a[1, 0, n // 2, n // 2] = m[1, 0, n // 2, n // 2] = -1.0
    d = rand_xf(rng, (2, n, n), k, "cpu").transpose(0, 1)
    return a, m, ((d + d.transpose(-1, -2)) / 2).contiguous()


def tree_plain(k, n):
    """K5's and K7's plain versions on tree_inputs(k, n), in a CPU worker
    (at k=12 and n = 64, 65 they take minutes of small launches on the
    card): outputs, flags and seconds."""
    torch.set_num_threads(1)
    from clrs_tpu_torch.ops import cuda_xf

    a, m, d = tree_inputs(k, n)
    t0 = time.time()
    inv, ok = cuda_xf.spd_inverse_xf_torch(a)
    t1 = time.time()
    w, okw = cuda_xf.steplen_sandwich_xf_torch(m, d)
    return dict(inv=inv.numpy(), ok=ok.numpy(), w=w.numpy(), okw=okw.numpy(),
                k5_s=t1 - t0, k7_s=time.time() - t1)


def check_kernels(dev, record, tree_futures):
    """Phase 3: every kernel bitwise against its plain version."""
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    rng = np.random.default_rng(0)
    rows = []

    def case(name, k, label, kernel, plain, args, work, reps, plain_reps, main,
             plain_ms=None, view=None):
        """view: applied to both outputs before they are compared (not timed)."""
        out_k = kernel(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out_p = plain(*args)
        end.record()
        torch.cuda.synchronize()
        if view is not None:
            out_k, out_p = view(out_k), view(out_p)
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        ok = outs_p[1] if len(outs_p) > 1 else None
        vk, vp = outs_k[0], outs_p[0]
        if ok is not None:  # compare the blocks whose factorization succeeded
            assert torch.equal(outs_k[1], ok), f"{name} k={k} {label}: flags differ"
            bad_k, bad_p = vk[~ok], vp[~ok]  # the others: NaN in the same places
            nan_k, nan_p = torch.isnan(bad_k), torch.isnan(bad_p)
            assert torch.equal(nan_k, nan_p) and bits_equal(bad_k[~nan_k], bad_p[~nan_p]), \
                f"{name} k={k} {label}: a flagged block differs"
            vk, vp = vk[ok], vp[ok]
        err = float(torch.max(torch.abs(vk - vp))) if vk.numel() else 0.0
        assert bits_equal(vk, vp), f"{name} k={k} {label}: not bitwise equal ({err})"
        ms = median_ms(lambda: kernel(*args), reps)
        ms_many = many_ms(lambda: kernel(*args), max(5, min(200, int(20.0 / max(ms, 0.05)))))
        if plain_ms is None:
            plain_ms = (median_ms(lambda: plain(*args), plain_reps, warm=False)
                        if plain_reps else start.elapsed_time(end))
        bound_ms, bound_by = bound(*work)
        row = dict(name=name, k=k, shape=label, ms=ms, ms_many=ms_many, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, main_path=main)
        if ok is not None:
            row["flags"] = [bool(v) for v in ok.tolist()][:8]
        rows.append(row)
        log(f"kernel {name:15s} k={k:<2d} {label:30s} bitwise-equal  kernel {ms:9.4f} ms"
            f" (many {ms_many:9.4f})  plain {plain_ms:10.3f} ms  bound {bound_ms:.6f} ms "
            f"({bound_by})")
        return row

    # K1 (the k=2 instance of K5's kernel) at config-1 shapes, then wide:
    # 256 blocks of 64x64 at cond ~1e10, one of them indefinite, and one
    # block of 257 and of 1024 rows (the threads finish more than a row each)
    for label, (B, n, cond) in INVERSE_SHAPES:
        a = spd_batch(rng, B, n, 2, cond, dev)
        case("spd_inverse_dd", 2, label, cuda_dd.dd_spd_inverse,
             cuda_dd.dd_spd_inverse_torch, (a,), spd_inverse_work(2, B, n), 50, 3, True)
    a = spd_batch(rng, 256, 64, 2, 1e10, dev)
    a[7, 0, 5, 5] = -1e3
    row = case("spd_inverse_dd", 2, "wide 256x64x64 (1 indefinite)", cuda_dd.dd_spd_inverse,
               cuda_dd.dd_spd_inverse_torch, (a,), spd_inverse_work(2, 256, 64), 5, 1, False)
    assert row["flags"][7] is False, "K1: the indefinite block was not flagged"
    for n in (257, 1024):
        a = spd_batch(rng, 1, n, 2, 1e4, dev)
        case("spd_inverse_dd", 2, f"1x{n}x{n}", cuda_dd.dd_spd_inverse,
             cuda_dd.dd_spd_inverse_torch, (a,), spd_inverse_work(2, 1, n), 3, 0, False)

    # K2 at k=2, the whole block in one launch on the pairings as they lie:
    # the main cluster has m=1 (one pair) and T = K*rmax = 11; the ten sign
    # clusters go as one group of G=10 with T=1; m=2 at rank 2; wide
    def schur_rows(k):
        for i, (label, (G, m, K, rmax)) in enumerate(SCHUR_SHAPES):
            main = i < SCHUR_MAIN
            case("schur_pairs_dd" if k == 2 else "schur_pairs_xf", k, label,
                 cuda_xf.schur_pairs, cuda_xf.schur_pairs_torch,
                 schur_operands(rng, k, G, m, K, rmax, dev), schur_work(k, G, m, K * rmax),
                 50 if main else 10, (3 if k < 6 else 1) if main else 1, main)

    schur_rows(2)

    # K3: every product of the config-1 solve, and a wide batch
    for label, (B, n, K, m) in MATMUL_SHAPES + (("wide 8x256x256x256", (8, 256, 256, 256)),):
        main = not label.startswith("wide")
        a, b = rand_xf(rng, (B, n, K), 2, dev), rand_xf(rng, (B, K, m), 2, dev)
        case("matmul_dd", 2, label, cuda_xf.dd_matmul, cuda_xf.dd_matmul_seq_torch,
             (a, b), matmul_work(2, B, n, K, m, K), 50 if main else 5, 3 if main else 1, main)

    # K3 (k=2) and K4 on operands read in place: V.mT as A (compute_pairings)
    # and as B (weighted_A_block), and a batch broadcast from one matrix
    for k in IN_PLACE_KS:
        name, kernel, plain = (("matmul_dd", cuda_xf.dd_matmul, cuda_xf.dd_matmul_seq_torch)
                               if k == 2 else ("matmul_xf (K4, K6)", cuda_xf.matmul_xf,
                                               cuda_xf.matmul_xf_torch))
        for label, (a, b), (B, n, K, m, Ba, Bb) in in_place_operands(rng, k, dev):
            steps = K if k == 2 else cuda_xf.padded_contraction(K)
            case(name, k, label, kernel, plain, (a, b),
                 matmul_work(k, B, n, K, m, steps, Ba, Bb), 50, 3 if k < 6 else 1, True)

    # K2, K4 and K5 at the ladder's k, at every config-1 shape
    for k in LADDER:
        plain_reps = 3 if k < 6 else 1
        schur_rows(k)
        for label, (B, n, K, m) in MATMUL_SHAPES:
            a, b = rand_xf(rng, (B, n, K), k, dev), rand_xf(rng, (B, K, m), k, dev)
            case("matmul_xf (K4, K6)", k, label, cuda_xf.matmul_xf, cuda_xf.matmul_xf_torch,
                 (a, b), matmul_work(k, B, n, K, m, cuda_xf.padded_contraction(K)), 50,
                 plain_reps, True)
        for label, (B, n, cond) in INVERSE_SHAPES:
            a = spd_batch(rng, B, n, k, cond, dev)
            case("spd_inverse_xf", k, label, cuda_xf.spd_inverse_xf,
                 cuda_xf.spd_inverse_xf_torch, (a,), spd_inverse_work(k, B, n), 20, 1, True)

    # wide: K4 above K6's size gate (k*n*m > 2e6 tiles on the TPU), and K5
    # on 64 blocks of 32x32 with one indefinite
    a, b = rand_xf(rng, (1, 1024, 64), 3, dev), rand_xf(rng, (1, 64, 1024), 3, dev)
    case("matmul_xf (K4, K6)", 3, "wide (1024,64)x(64,1024)", cuda_xf.matmul_xf,
         cuda_xf.matmul_xf_torch, (a, b), matmul_work(3, 1, 1024, 64, 1024, 64), 5, 1,
         False)
    a = spd_batch(rng, 64, 32, 3, 1e10, dev)
    a[5, 0, 3, 3] = -1e3
    row = case("spd_inverse_xf", 3, "wide 64x32x32 (1 indefinite)", cuda_xf.spd_inverse_xf,
               cuda_xf.spd_inverse_xf_torch, (a,), spd_inverse_work(3, 64, 32), 5, 1, False)
    assert row["flags"][5] is False, "K5: the indefinite block was not flagged"

    # K7 on the config-1 step-length groups (M SPD, dM symmetric indefinite)
    # at the ladder's k, and wide at k=3 with one indefinite M
    def sandwich_inputs(B, n, k, cond):
        m = spd_batch(rng, B, n, k, cond, dev)
        d = rand_xf(rng, (B, n, n), k, dev).transpose(0, 1)
        return m, (d + d.transpose(-1, -2)) / 2

    def flat(groups):  # W and flags of every group, as one float64 vector
        return torch.cat([w.reshape(-1) for w, _ in groups] + [ok.double() for _, ok in groups])

    for k in STEPLEN_LADDER:
        # the iteration's one launch: X's and Y's 6x6 and 5x5 blocks, each
        # a (k, n, n) view read in place, dM a transposed one
        groups = []
        for n in (6, 5, 6, 5):
            m, d = sandwich_inputs(1, n, k, 1e6)
            groups.append(([m[0]], [d[0].transpose(-1, -2)]))
        work = [steplen_work(k, 1, n) for n in (6, 5, 6, 5)]
        row = case("steplen_xf", k, "iteration X, Y x (1x6x6, 1x5x5)",
                   cuda_xf.steplen_sandwich_xf_groups,
                   lambda g: [cuda_xf.steplen_sandwich_xf_torch(torch.stack(ms), torch.stack(ds))
                              for ms, ds in g],
                   (groups,), tuple(map(sum, zip(*work))), 20, 1, True, view=flat)
        per_size = flat([cuda_xf.steplen_sandwich_xf(torch.stack(ms), torch.stack(ds))
                         for ms, ds in groups])
        assert bits_equal(per_size, flat(cuda_xf.steplen_sandwich_xf_groups(groups))), \
            f"steplen_xf k={k}: one launch differs from a launch per size"
        row["equals_per_size_launches"] = True
        for label, (B, n) in (("1x6x6", (1, 6)), ("1x5x5", (1, 5))):
            case("steplen_xf", k, label, cuda_xf.steplen_sandwich_xf,
                 cuda_xf.steplen_sandwich_xf_torch, sandwich_inputs(B, n, k, 1e6),
                 steplen_work(k, B, n), 20, 1, True)
    m, d = sandwich_inputs(64, 32, 3, 1e10)
    m[5, 0, 4, 4] = -1e3
    row = case("steplen_xf", 3, "wide 64x32x32 (1 indefinite)", cuda_xf.steplen_sandwich_xf,
               cuda_xf.steplen_sandwich_xf_torch, (m, d), steplen_work(3, 64, 32), 5, 1,
               False)
    assert row["flags"][5] is False, "K7: the indefinite block was not flagged"

    # K5 and K7 at every shape of their dot products' halving tree (one term
    # per lane, a group below a warp, a warp, terms kept in the lane), two
    # blocks of which the second is indefinite; their plain versions ran in
    # CPU workers on the same inputs (tree_plain), and their times are those
    for (k, n), future in tree_futures.items():
        a, m, d = (x.to(dev) for x in tree_inputs(k, n))
        plain = future.get()
        for name, kern, args, outs, secs, work in (
                ("spd_inverse_xf", cuda_xf.spd_inverse_xf, (a,), ("inv", "ok"), "k5_s",
                 spd_inverse_work(k, 2, n)),
                ("steplen_xf", cuda_xf.steplen_sandwich_xf, (m, d), ("w", "okw"), "k7_s",
                 steplen_work(k, 2, n))):
            want = tuple(torch.from_numpy(plain[o]).to(dev) for o in outs)
            row = case(name, k, f"tree 2x{n}x{n} (1 indefinite)", kern,
                       lambda *_, want=want: want, args, work, 5, 0, False,
                       plain_ms=1e3 * plain[secs])
            row["plain_device"] = "cpu"
            assert row["flags"] == [True, False], f"{name} n={n}: flags {row['flags']}"

    # K8 at every k, add and multiply, at the solver's shapes and wide; at
    # k >= 5 (equal-k operands) it computes xfloat's own sequences
    from clrs_tpu_torch.ops.xfloat import XF, xf_add, xf_mul

    for k in range(2, 13):
        for label, shape in ELEMWISE_SHAPES:
            main = not label.startswith("wide")
            a, b = rand_xf(rng, shape, k, dev), rand_xf(rng, shape, k, dev)
            a2, b2 = a.reshape(k, -1), b.reshape(k, -1)
            for op, xf_op in (("add", xf_add), ("mul", xf_mul)):
                row = case("elemwise_xf", k, f"{op} {label}",
                           lambda x, y, op=op: cuda_xf.elemwise_xf(op, x, y),
                           lambda x, y, op=op: cuda_xf.elemwise_xf_torch(op, x, y),
                           (a2, b2), elemwise_work(k, a2.shape[1], op), 50 if main else 10,
                           3 if main and k < 6 else 1, main)
                if k >= 5:
                    got = cuda_xf.elemwise_xf(op, a2, b2).reshape(a.shape)
                    assert bits_equal(got, xf_op(XF(a), XF(b)).limbs), \
                        f"elemwise_xf k={k} {op} {label}: not xfloat's result"
                    row["equals_xfloat"] = True
        # operands read in place: broadcast, and shorter in limbs (padded
        # with zeros in the kernel's loads, as the reference pads them)
        for label, (sa, ka), (sb, kb) in ELEMWISE_OPERANDS:
            ka, kb = (k if v == 0 else k - 1 if v < 0 else min(v, k) for v in (ka, kb))
            a, b = rand_xf(rng, sa, ka, dev), rand_xf(rng, sb, kb, dev)
            n_out = int(np.prod(np.broadcast_shapes(sa, sb)))
            for op, xf_op in (("add", xf_add), ("mul", xf_mul)):
                row = case("elemwise_xf", k, f"{op} {label}",
                           lambda x, y, op=op: cuda_xf.elemwise_xf(op, x, y),
                           lambda x, y, op=op: cuda_xf.elemwise_xf_torch(op, x, y),
                           (a, b), elemwise_work(k, n_out, op), 50, 3 if k < 6 else 1, True)
                if k >= 5 and ka == kb:
                    got = cuda_xf.elemwise_xf(op, a, b)
                    assert bits_equal(got, xf_op(XF(a), XF(b)).limbs), \
                        f"elemwise_xf k={k} {op} {label}: not xfloat's result"
                    row["equals_xfloat"] = True

    # K9 at the config-1 inverse shapes and wide, then at every shape of
    # its halving tree and its cap on two blocks (the second indefinite),
    # each B-major and as the batch-minor view of a (2, n, n, B) array:
    # against its plain version and bitwise against K1, whose time on the
    # same input stands beside it
    def wide_row(label, a, flagged, plain=None):
        """plain: the plain version's (outputs, ms) on the same values in
        another layout, reused (at n = 512 it takes seconds); returns this
        row's."""
        B, _, n, _ = a.shape
        main = label.startswith(("signs", "S_j"))
        big = n > 256
        if plain is None:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            want = cuda_dd.dd_spd_inverse_wide_torch(a)
            end.record()
            end.synchronize()
            plain = (want, median_ms(lambda: cuda_dd.dd_spd_inverse_wide_torch(a), 3, warm=False)
                     if main else start.elapsed_time(end))
        row = case("spd_inverse_dd_wide", 2, label, cuda_dd.dd_spd_inverse_wide,
                   lambda *_: plain[0], (a,), spd_inverse_work(2, B, n),
                   50 if main else (2 if big else 5), 0, main, plain_ms=plain[1])
        inv_w, ok_w = cuda_dd.dd_spd_inverse_wide(a)
        inv_1, ok_1 = cuda_dd.dd_spd_inverse(a)
        assert torch.equal(ok_w, ok_1) and bits_equal(inv_w[ok_w], inv_1[ok_1]), \
            f"spd_inverse_dd_wide {label}: not K1's result"
        row["equals_K1"] = True
        row["k1_ms"] = median_ms(lambda: cuda_dd.dd_spd_inverse(a), 1 if big else 20)
        if flagged is not None:
            assert row["flags"][flagged] is False, \
                f"K9 {label}: the indefinite block was not flagged"
        return plain

    def batch_minor(a):  # the (B, 2, n, n) view of a (2, n, n, B) copy of a
        return a.permute(1, 2, 3, 0).contiguous().permute(3, 0, 1, 2)

    for label, (B, n, cond) in (("signs 10x1x1", (10, 1, 1.0)),
                                ("S_j 1x11x11", (1, 11, 1e8)),
                                ("wide 256x64x64 (1 indefinite)", (256, 64, 1e10))):
        a = spd_batch(rng, B, n, 2, cond, dev)
        if B == 256:
            a[7, 0, 5, 5] = -1e3
        plain = wide_row(label, a, 7 if B == 256 else None)
        if B == 256:
            wide_row("wide 256x64x64 batch-minor", batch_minor(a), 7, plain)
    for n in WIDE_TREE_SIZES:
        a = spd_batch(rng, 2, n, 2, 1e6, dev)
        a[1, 0, n // 2, n // 2] = -1.0
        plain = wide_row(f"tree 2x{n}x{n} (1 indefinite)", a, 1)
        wide_row(f"tree 2x{n}x{n} batch-minor", batch_minor(a), 1, plain)
    record["kernel_checks"] = rows
    return rows


# ---------------------------------------------------------------------------
# Phases 4-6: the solves
# ---------------------------------------------------------------------------


def counters():
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    return {"spd_inverse_dd": cuda_dd.dd_spd_inverse, "schur_pairs": cuda_xf.schur_pairs,
            "matmul_dd": cuda_xf.dd_matmul, "matmul_xf": cuda_xf.matmul_xf,
            "spd_inverse_xf": cuda_xf.spd_inverse_xf,
            "steplen_xf": cuda_xf.steplen_sandwich_xf, "elemwise_xf": cuda_xf.elemwise_xf,
            "spd_inverse_dd_wide": cuda_dd.dd_spd_inverse_wide}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def per_phase_ms(res):
    n = max(res.iterations - 2, 1)  # timings exclude the first 2 iterations
    return {k: 1e3 * v / n for k, v in sorted(res.timings.items())}


def solve(n, d, k, device, route):
    """delsarte_lp_bound on device with the route's solver options."""
    from clrs_tpu_torch import delsarte_lp_bound

    return delsarte_lp_bound(n, d, precision_k=k, device=device, **route, **SOLVE)


def cpu_solve(n, d, k, route=None):
    """The CPU port on the card's route (the kernels' plain versions); run
    in a worker process while the card works."""
    torch.set_num_threads(2)
    t0 = time.time()
    bound_, res = solve(n, d, k, "cpu", dict(route or {}, use_cuda_matmul=True))
    return dict(bound=bound_, status=res.status, iterations=res.iterations,
                history=res.history, wall_s=time.time() - t0)


def solve_config1(dev, record, k, cpu_future, floor, bound_tol, expect_status, kernels,
                  route=None, tag=None):
    """Delsarte dim 8, 2d=10 at k limbs on the card, held against the CPU."""
    reset_counters()
    t0 = time.time()
    bound_, res = solve(8, 5, k, dev, route or {})
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counters()
    tag = tag or f"config1 k={k}"
    log(f"{tag} gpu: bound {bound_!r} status {res.status} iterations {res.iterations} "
        f"wall {wall:.3f} s ({res.iterations / wall:.4f} it/s, set-up included)")
    it_s = (res.iterations - 2) / max(sum(res.timings.values()), 1e-12)
    phases = per_phase_ms(res)
    log(f"{tag} gpu: steady {it_s:.4f} it/s; ms/iter by phase: "
        + ", ".join(f"{p}={v:.2f}" for p, v in phases.items()))
    log(f"{tag} gpu: kernel launches during the solve: {launches}")

    # The CPU run takes the same route (the kernels' plain versions, bit
    # for bit the kernels).  The step length's float64 eigenvalues come
    # from each device's own eigensolver and differ in the last bits; once
    # an error reaches the k-limb noise floor the feasibility tests turn on
    # such bits and the two paths may part (at k=2 a one-ulp change of the
    # eigenvalues on the CPU alone parts them by ~0.08 in gap).  So the
    # histories must agree to 1e-10 only until either run has p_err or
    # d_err below the floor; floor None holds the whole history.
    cpu = cpu_future.get()
    log(f"{tag} cpu: bound {cpu['bound']!r} status {cpu['status']} iterations "
        f"{cpu['iterations']} wall {cpu['wall_s']:.3f} s")
    rel_by_iter = [max(abs(rg[key] - rc[key]) / max(abs(rc[key]), 1e-300)
                       for key in ("p_obj", "d_obj", "gap"))
                   for rg, rc in zip(res.history, cpu["history"])]
    floor_at = next((i for i, (rg, rc) in enumerate(zip(res.history, cpu["history"]))
                     if floor is not None
                     and min(rg["p_err"], rg["d_err"], rc["p_err"], rc["d_err"]) < floor),
                    len(rel_by_iter))
    pre_floor = max(rel_by_iter[:floor_at], default=0.0)
    parted = next((i for i, r in enumerate(rel_by_iter) if r > 1e-10), None)
    log(f"{tag}: relative history difference gpu vs cpu: {max(rel_by_iter)!r} over "
        f"{len(rel_by_iter)} iterations, first above 1e-10 at iteration {parted}; "
        f"{pre_floor!r} over the {floor_at} iterations held "
        f"({'the whole history' if floor is None else f'before the {floor:g} error floor'})")
    record[tag.replace(" ", "_").replace("=", "")] = dict(
        bound=bound_, status=res.status, iterations=res.iterations, wall_s=wall,
        steady_it_per_s=it_s, phase_ms_per_iter=phases, launches=launches,
        bound_cpu=cpu["bound"], status_cpu=cpu["status"], iterations_cpu=cpu["iterations"],
        wall_cpu_s=cpu["wall_s"], history_rel_diff_by_iter=rel_by_iter,
        history_parted_at=parted, floor_at=floor_at,
        history_pre_floor_max_rel_diff=pre_floor, history=res.history)

    for name in kernels:
        assert launches[name] > 0, f"{name} never launched during the {tag} solve"
    for name in set(launches) - set(kernels):
        assert launches[name] == 0, f"{name} launched during the {tag} solve"
    assert abs(bound_ - 240.0) < bound_tol, f"{tag} bound {bound_!r}"
    if expect_status is not None:
        assert res.status == expect_status, f"{tag} status {res.status}"
    assert res.status == cpu["status"], (res.status, cpu["status"])
    assert abs(res.iterations - cpu["iterations"]) <= 2, (res.iterations, cpu["iterations"])
    assert floor_at >= 1, "no iteration before the error floor to compare"
    assert pre_floor <= 1e-10, f"gpu and cpu histories differ by {pre_floor!r}"
    return launches, res


def solve_all_kernels(dev, record, cpu_future, default):
    """Phase 7: config 1 at k=3 on the all-kernels route, against the CPU
    on the same route and against phase 5's default route."""
    launches, res = solve_config1(
        dev, record, 3, cpu_future, None, 1e-12, "optimal",
        ("schur_pairs", "matmul_xf", "spd_inverse_xf", "steplen_xf", "elemwise_xf"),
        route=ALL_KERNELS_ROUTE, tag="config1 k=3 all-kernels")
    # X's and Y's 6x6 and 5x5 blocks, all in one launch every iteration
    assert launches["steplen_xf"] == res.iterations, launches["steplen_xf"]
    assert abs(res.iterations - default.iterations) <= 2, (res.iterations, default.iterations)
    assert default.status == "optimal"
    steady = {}
    for name, r in (("default", default), ("all-kernels", res)):
        steady[name] = (r.iterations - 2) / max(sum(r.timings.values()), 1e-12)
    log(f"config1 k=3 routes, steady it/s: default {steady['default']:.4f}, "
        f"all-kernels {steady['all-kernels']:.4f}; iterations {default.iterations} / "
        f"{res.iterations}")
    a, b = per_phase_ms(default), per_phase_ms(res)
    log("config1 k=3 routes, ms/iter by phase (default / all-kernels): " + ", ".join(
        f"{p}={a.get(p, 0.0):.2f}/{b.get(p, 0.0):.2f}" for p in sorted(set(a) | set(b))))
    log(f"config1 k=3 all-kernels: launches per iteration: " + ", ".join(
        f"{n}={v / res.iterations:.2f}" for n, v in launches.items()))
    record["config1_k3_routes"] = dict(steady_it_per_s=steady, default_ms=a,
                                       all_kernels_ms=b)
    return launches


PROFILE_ITERATIONS = (3, 6)  # the window: iterations 3 to 6 of the solve
COPY_WORDS = ("copy", "Memcpy", "Memset", "CatArray", "cat_")


RANGES = ("K8 call path", "alpha", "alpha: K7", "alpha: float64 Jacobi",
          "alpha: xf_min_eig_sym", "K3/K4 call path", "Schur call path")
CALL_PATHS = (RANGES[0], RANGES[5], RANGES[6])  # no copy may run under these


def profile_all_kernels(dev, record, steady_it_s, check=True):
    """Phase 8: torch.profiler over iterations 3-6 of config 1 at k=3 on
    the all-kernels route.  Prints the device's busy time per iteration as
    a share of the window's wall time (which the profiler stretches) and of
    the unprofiled iteration of phase 7 (steady_it_s), the device time per
    launch of K8, K5, K7, K4 and K2, launches per iteration by kernel name
    (copies apart) and the copy launches in all, the copies that K8's,
    K3/K4's and the Schur block's (K2's) call paths made, and how the step
    length (alpha) splits between K7, the float64 Jacobi bound and the
    scalar groups' xf_min_eig_sym.  Those parts, each K8 call, each
    matmul, each Schur block and alpha are marked with record_function
    ranges while the window is open (a few us per call).  check: fail on
    a copy under those call paths and on a range that was not entered as
    often as its kernel launched (kernel_turns.py profiles other trees
    without it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from clrs_tpu_torch.core import kernels as core_kernels
    from clrs_tpu_torch.core import solver
    from clrs_tpu_torch.ops import xfloat

    first, last = PROFILE_ITERATIONS
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    originals = {}

    def ranged(owner, attr, label):
        fn = getattr(owner, attr, None)
        if fn is None:  # an older tree that kernel_turns.py profiles: the range stays out
            return
        originals[(owner, attr)] = fn

        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)

        setattr(owner, attr, run)

    make_phases = solver.make_ipm_phases
    count = [0]

    def phases_with_window(problem, cfg):
        phases = make_phases(problem, cfg)
        start = phases["mu_R_Xinv"]

        def first_phase(*args):
            count[0] += 1
            if count[0] in (first, last + 1):
                torch.cuda.synchronize()
                if count[0] == first:
                    for (owner, attr), label in zip(
                            ((xfloat, "_elemwise_kernel"), (solver, "compute_step_lengths"),
                             (solver, "steplen_sandwich_xf_groups"), (solver, "jacobi_min_eig"),
                             (solver, "xf_min_eig_sym"), (core_kernels, "xf_matmul_k"),
                             (solver, "schur_block_contribution")),
                            RANGES):
                        ranged(owner, attr, label)
                    prof.start()
                    window["t0"] = time.perf_counter()
                else:
                    window["wall_s"] = time.perf_counter() - window["t0"]
                    prof.stop()
                    for (owner, attr), fn in originals.items():
                        setattr(owner, attr, fn)
            return start(*args)

        return dict(phases, mu_R_Xinv=first_phase)

    solver.make_ipm_phases = phases_with_window
    try:
        solve(8, 5, 3, dev, dict(ALL_KERNELS_ROUTE, maxiterations=last + 1))
        torch.cuda.synchronize()
    finally:
        solver.make_ipm_phases = make_phases
        for (owner, attr), fn in originals.items():
            setattr(owner, attr, fn)
    assert "wall_s" in window, "the profile window did not close"
    iters = last - first + 1
    t0 = time.time()
    events = prof.events()
    kernels, spans = {}, {}  # device work by name; the ranges' spans on the device
    for e in events:
        if e.device_type == DeviceType.CUDA:
            into = spans if e.name in RANGES else kernels
            n, us = into.get(e.name, (0, 0.0))
            into[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in kernels.values())
    wall_us = 1e6 * window["wall_s"]
    out = dict(iterations=iters, wall_ms_per_iter=wall_us / 1e3 / iters,
               device_busy_ms_per_iter=busy_us / 1e3 / iters,
               busy_share=busy_us / wall_us if wall_us else 0.0,
               busy_share_of_unprofiled_iteration=busy_us / 1e3 / iters * steady_it_s / 1e3)
    log(f"profile (config1 k=3 all-kernels, iterations {first}-{last}): wall "
        f"{out['wall_ms_per_iter']:.2f} ms/iter under the profiler, device busy "
        f"{out['device_busy_ms_per_iter']:.3f} ms/iter: busy share {out['busy_share']:.4f} "
        f"of the profiled wall, {out['busy_share_of_unprofiled_iteration']:.4f} of phase 7's "
        f"unprofiled iteration ({1e3 / steady_it_s:.2f} ms); {len(events)} events, read in "
        f"{time.time() - t0:.1f} s")
    if not kernels:
        log("profile: the profiler showed no device time; the CUDA-event times above stand")
    per_launch = {}
    for tag, word in (("K8", "elemwise_xf_kernel"), ("K5", "spd_inverse_xf_kernel"),
                      ("K7", "steplen_xf_kernel"), ("K4", "matmul_xf_kernel"),
                      ("K2", "schur_pairs_kernel")):
        mine = [v for name, v in kernels.items() if word in name
                and (tag != "K5" or spd_inverse_limbs(name) >= 3)]
        n, us = sum(c for c, _ in mine), sum(u for _, u in mine)
        per_launch[tag] = dict(launches_per_iter=n / iters,
                               device_ms_per_launch=us / 1e3 / n if n else None)
        log(f"profile: {tag} {n / iters:.2f} launches/iter, device "
            + (f"{us / 1e3 / n:.5f} ms per launch" if n else "none"))
    copies = {name: v for name, v in kernels.items() if any(w in name for w in COPY_WORDS)}
    copy_launches = sum(n for n, _ in copies.values()) / iters
    log(f"profile: copy launches per iteration {copy_launches:.2f} in all; K4 "
        f"{per_launch['K4']['launches_per_iter']:.2f} launches/iter at "
        f"{per_launch['K4']['device_ms_per_launch'] or 0.0:.5f} ms of device time each")
    others = sorted(((v[0], name, v[1]) for name, v in kernels.items() if name not in copies),
                    reverse=True)
    log(f"profile: launches per iteration by kernel ({len(kernels)} names; copies apart):")
    for n, name, us in others[:25]:
        log(f"profile:   {n / iters:9.2f}  {us / 1e3 / iters:8.3f} ms/iter  {name[:100]}")
    for name, (n, us) in sorted(copies.items(), key=lambda kv: -kv[1][0]):
        log(f"profile:   copy {n / iters:9.2f}  {us / 1e3 / iters:8.3f} ms/iter  {name[:100]}")
    # ops beneath K8's, the matmuls' and the Schur block's call paths: none
    # may copy
    path_ops, path_copies = {}, {}
    for path in CALL_PATHS:
        ops = path_ops[path] = {}
        for e in events:
            if e.device_type != DeviceType.CPU or e.name == path:
                continue
            p = e.cpu_parent
            while p is not None and p.name != path:
                p = p.cpu_parent
            if p is not None and e.name.startswith("aten::"):
                ops[e.name] = ops.get(e.name, 0) + 1
        path_copies[path] = {n: c for n, c in ops.items()
                             if any(w in n for w in ("copy", "cat", "clone", "contiguous"))}
        log(f"profile: aten ops under the {path} per iteration: "
            + (", ".join(f"{n}={c / iters:.2f}" for n, c in sorted(ops.items())) or "none")
            + f"; copies {path_copies[path] or 'none'}")
    ranges = {}
    for e in events:  # the ranges' host time, and the device span each covered
        if e.device_type == DeviceType.CPU and e.name in RANGES:
            r = ranges.setdefault(e.name, dict(calls=0, host_us=0.0))
            r["calls"] += 1
            r["host_us"] += e.time_range.elapsed_us()
    for key, r in ranges.items():
        r = ranges[key] = dict(calls_per_iter=r["calls"] / iters,
                               host_ms_per_iter=r["host_us"] / 1e3 / iters,
                               device_span_ms_per_iter=spans.get(key, (0, 0.0))[1] / 1e3 / iters)
        log(f"profile: range {key:24s} {r['calls_per_iter']:8.2f} calls/iter, host "
            f"{r['host_ms_per_iter']:8.3f} ms/iter, device span {r['device_span_ms_per_iter']:8.3f} "
            f"ms/iter")
    out.update(per_launch=per_launch, copies_per_iter={n: c / iters for n, (c, _) in copies.items()},
               copy_launches_per_iter=copy_launches,
               call_path_aten_ops_per_iter={
                   path: {n: c / iters for n, c in ops.items()} for path, ops in path_ops.items()},
               ranges=ranges,
               launches_per_iter={n: c / iters for n, (c, _) in kernels.items()})
    record["profile_all_kernels_k3"] = out
    if not check:
        return out
    for path, found in path_copies.items():
        assert not found, f"the {path} made copies: {found}"
    # a range that a refactor bypassed would read 0: each must be entered
    # every iteration, and those around one kernel once per launch
    lost = [key for key in RANGES if ranges.get(key, {}).get("calls_per_iter", 0) < 1]
    assert not lost, f"profile ranges entered less than once per iteration: {lost}"
    if kernels:
        for key, tag in ((RANGES[0], "K8"), (RANGES[2], "K7"), (RANGES[5], "K4"),
                         (RANGES[6], "K2")):
            assert ranges[key]["calls_per_iter"] == per_launch[tag]["launches_per_iter"], (
                f"range {key!r}: {ranges[key]['calls_per_iter']} calls/iter against "
                f"{per_launch[tag]['launches_per_iter']} {tag} launches/iter")
    return out


def spd_inverse_limbs(name: str) -> int:
    """The limb count of the csrc/spd_inverse_xf.cu instance that a
    profiler kernel name (demangled or not) names, 0 for another kernel:
    2 is K1, 3 and above K5."""
    m = re.search(r"spd_inverse_xf_kernel(?:<|ILi)(\d+)", name)
    return int(m.group(1)) if m else 0


def profile_k1(dev, record):
    """Phase 8, K1: torch.profiler over the decomposition phase of
    iteration 3 of config 1 at k=2 (the default route, where K1 computes
    S_j^-1 and Q^-1): K1's launches there and its device time per launch,
    by the k=2 instance of spd_inverse_xf_kernel in the kernel names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clrs_tpu_torch.core import solver

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    make_phases = solver.make_ipm_phases
    count = [0]

    def phases_with_window(problem, cfg):
        phases = make_phases(problem, cfg)
        decomp = phases["decomp"]

        def windowed(*args):
            count[0] += 1
            if count[0] != 3:
                return decomp(*args)
            torch.cuda.synchronize()
            prof.start()
            try:
                out = decomp(*args)
                torch.cuda.synchronize()
            finally:
                prof.stop()
            return out

        return dict(phases, decomp=windowed)

    solver.make_ipm_phases = phases_with_window
    try:
        solve(8, 5, 2, dev, dict(maxiterations=3))
    finally:
        solver.make_ipm_phases = make_phases
    assert count[0] >= 3, "the K1 profile window did not open"
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and spd_inverse_limbs(e.name) == 2]
    out = dict(launches=len(us), device_ms_per_launch=sum(us) / 1e3 / len(us) if us else None,
               device_ms=[u / 1e3 for u in us])
    each = ", ".join(f"{u / 1e3:.5f}" for u in us)
    log(f"profile (config1 k=2, decomposition of iteration 3): K1 {len(us)} launches, device "
        + (f"{out['device_ms_per_launch']:.5f} ms per launch ({each})" if us else "none"))
    record["profile_k1_k2"] = out
    if prof.events() and any(e.device_type == DeviceType.CUDA for e in prof.events()):
        assert us, "K1 did not run in the decomposition of config 1 at k=2"
    return out


def solve_dim24(dev, record):
    """Phase 6: the dimension-24 kissing bound (Leech lattice) on the card."""
    from clrs_tpu_torch import delsarte_lp_bound

    reset_counters()
    t0 = time.time()
    bound_, res = delsarte_lp_bound(24, 10, device=dev, **SOLVE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counters()
    it_s = (res.iterations - 2) / max(sum(res.timings.values()), 1e-12)
    log(f"dim24 gpu: bound {bound_!r} status {res.status} iterations "
        f"{res.iterations} wall {wall:.3f} s steady {it_s:.4f} it/s")
    log(f"dim24 gpu: kernel launches during the solve: {launches}")
    record["dim24"] = dict(bound=bound_, status=res.status, iterations=res.iterations,
                           wall_s=wall, steady_it_per_s=it_s,
                           phase_ms_per_iter=per_phase_ms(res), launches=launches)
    for name in ("spd_inverse_dd", "schur_pairs", "matmul_dd"):
        assert launches[name] > 0, f"{name} never launched during the dim24 solve"
    assert abs(bound_ - 196560.0) < 1e-3, f"dim24 bound {bound_!r}"
    return launches


def ptxas_report(text: str):
    """Registers, stack and spills of the k-limb kernels (and of the
    out-of-line add and multiply of K5 and K7) at k=3, 10 and 12, of the
    matmul, the Schur block and the SPD inverse also at k=2 (K3, K2, K1),
    the matmul's 64-bit-index instances marked so, and of K9; K8's
    instances are named by op and by the dense form."""
    names = ("matmul_xf_kernel", "schur_pairs_kernel", "spd_inverse_xf_kernel",
             "steplen_xf_kernel", "elemwise_xf_kernel", "xf_add_n", "xf_mul_n")
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            fn = m.group(1)
            cur = next((f"{n} k={kk}" for n in names for kk in (2, 3, 10, 12)
                        if f"{n}ILi{kk}E" in fn and (kk > 2 or n in names[:3])), None)
            if cur and names[0] in fn and f"ILi{cur.split('=')[1]}Ex" in fn:
                cur += " (64-bit index)"
            k8 = re.search(r"elemwise_xf_kernelILi\d+ELb([01])ELb([01])E", fn)
            if cur and k8:
                cur += (" mul" if k8.group(1) == "1" else " add") + (
                    " dense" if k8.group(2) == "1" else "")
            if "spd_inverse_dd_wide_kernel" in fn:
                cur = "spd_inverse_dd_wide_kernel"
        elif cur and ("spill" in line or "Used" in line):
            out.append(f"{cur}: {line.split(':', 1)[-1].strip()}")
    return out


def kernel_summary(rows, launches):
    """One entry per kernel: launches in its main path's solve
    (KERNEL_PATH), times and bound at that path's first shape.  No PyTorch
    call computes a k-limb product, inverse, sandwich or elementwise
    expansion, so there is no library time."""
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path, k = KERNEL_PATH[name]
        first = next(r for r in rows if r["name"] == name and r["main_path"] and r["k"] == k)
        counter = "schur_pairs" if name.startswith("schur_pairs") else name.split(" ")[0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[path][counter],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["name"] == name),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None))
    return kernels


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device: this script checks the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda", 0)
    t_start = time.time()
    record = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  device=torch.cuda.get_device_name(0))
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {record['device']}")

    # the pool's exit terminates both workers, on success and on failure
    with get_context("spawn").Pool(3 + TREE_WORKERS) as pool:
        cpu_k2 = pool.apply_async(cpu_solve, (8, 5, 2))
        cpu_k3 = pool.apply_async(cpu_solve, (8, 5, 3))
        cpu_all = pool.apply_async(cpu_solve, (8, 5, 3, ALL_KERNELS_ROUTE))
        trees = sorted(((k, n) for k in (3, 12) for n in TREE_SIZES), key=lambda kn: -kn[0] * kn[1])
        tree_futures = {kn: pool.apply_async(tree_plain, kn) for kn in trees}

        from clrs_tpu_torch.ops import _build

        t0 = time.time()
        _build.library()
        record["build_s"] = time.time() - t0
        build_log = _build.log_path().read_text()
        log(f"build: {record['build_s']:.2f} s ({_build.library_path().name})")
        for line in build_log.splitlines():
            if line.startswith("=="):
                log("build: " + line[3:])
        record["ptxas"] = ptxas_report(build_log)
        for line in record["ptxas"]:
            log("ptxas: " + line)

        rows = check_kernels(dev, record, dict(sorted(tree_futures.items())))
        launches = {2: solve_config1(dev, record, 2, cpu_k2, 1e-20, 1e-9, None,
                                     ("spd_inverse_dd", "schur_pairs", "matmul_dd"))[0]}
        launches[3], default_k3 = solve_config1(
            dev, record, 3, cpu_k3, None, 1e-12, "optimal",
            ("schur_pairs", "matmul_xf", "spd_inverse_xf"))
        launches["dim24"] = solve_dim24(dev, record)
        launches["all"] = solve_all_kernels(dev, record, cpu_all, default_k3)
    profile_all_kernels(dev, record, record["config1_k3_routes"]["steady_it_per_s"]["all-kernels"])
    profile_k1(dev, record)

    kernels = kernel_summary(rows, launches)
    record["total_s"] = time.time() - t_start
    log(f"chip_smoke: {record['total_s']:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(record, kernels=kernels), f, indent=1)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
