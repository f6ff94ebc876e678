"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. requires a CUDA device; prints the card's name and power limit, and
     starts the CPU reference solves of phases 4, 5 and 7, the plain
     versions of phase 3's K5 and K7 tree rows and config-1 rows at k = 6
     and 10 and of phase 12's K5 and K7 rows, phase 9's CPU run, and
     phase 14's plain versions, and in a pool of its own sp86's packing,
     then its CPU run and LU, in worker processes (they need no card);
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
     one indefinite block (those rows' plain versions, and K5's and K7's at
     config-1 shapes at k = 6 and 10, ran in the CPU workers on the same
     inputs): limbs and flags must be bitwise equal; prints
     the kernel's median time of one call, its time per call over a run
     of back-to-back calls, the plain version's median time, and each
     call's bound (clrs_tpu_torch/utils/flops.py: bytes over 3.35 TB/s or
     FP64 instructions over their rate, 1.7e13 per second, an FMA counted
     as one and every exact product as the FMA's 2, whatever form the
     kernel runs; the larger; the SPD inverse's and the step length's on
     the function's own work, whichever route computes it);
  4. solves the Delsarte kissing-number bound in dimension 8 at 2d=10 on
     the card at k=2 with every launch counter reset first: K1, K2 and K3
     must have launched, the bound must be 240 to 1e-9, and the run must
     follow the same solve on the CPU, routed through the kernels' plain
     versions (same status, iterations within 2, p_obj/d_obj/gap within
     1e-10 relative until an error reaches the double-double floor 1e-20);
  5. solves the same bound at k=3 on the card for its first 8 iterations
     (DEFAULT_K3_ITERATIONS; the default route takes ~3.7 s an iteration
     there), counters reset: K2, K4 and K5 must have launched (K1 and K3
     are k=2 kernels and must not), and the run must follow the CPU's on
     the same route as in phase 4 over all its rows (the k=3 noise floor,
     ~1e-45, lies far below the 1e-30 thresholds); the CPU's whole run
     must end `optimal` with the bound 240 to 1e-12;
  6. solves the dimension-24 bound (2d=20, k=2) on the card, counters
     reset: K1, K2 and K3 must have launched, and the bound is 196560 to
     1e-3;
  7. solves config 1 at k=3 on the all-kernels route (use_cuda_inverse,
     use_cuda_steplength, use_cuda_elemwise), counters reset: K2, K4, K5,
     K7 (one launch per iteration) and K8 must have launched and K1, K3
     and K9 must
     not; the run must follow the CPU port on the same route as in phase 5
     and end `optimal` with the bound 240 to 1e-12 within 2 iterations of
     the default route's whole run (phase 5's CPU run); prints both routes'
     steady it/s and ms/iter by phase side by side;
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
  9. climbs sp16 (the two-species sphere packing at 2d=16, the reference's
     own example, built at 53*10 + 150 bits) through solve_with_escalation's
     default ladder (2, 3, 4, 6, 10) on the all-kernels route, omega 100,
     350 iterations, stall patience 40, under the full contract: it must
     end `optimal` at 0.8150097064427971 to 1e-10 with the last row's gap
     under 1e-15 and its errors under 1e-30; each rung resets the counters
     and prints its status, iterations, wall, steady it/s, launches by
     kernel and ms/iter by phase, must launch its kernels (K1, K2, K3, K7,
     K8 at k=2; K2, K4, K5, K7, K8 above) and no other, and must start
     from the previous rung's result re-rounded, bitwise; the k=2 rung's
     first 10 iterations follow a CPU worker on the same route to 1e-10
     relative until an error reaches 1e-20;
 10. solves sp30 (2d=30, BASELINE config 2) cold at k=6 on the same route
     and contract through the ladder (6, 10), per rung as in phase 9: it
     must end `optimal` at 0.813598677806444 to 1e-10;
 11. solves BASELINE config 4, polymin_simplex on the 2-simplex quadratic
     x^2 + y^2 - xy - x - y, at k=2, counters reset: K1, K2, K3 must
     launch and the bound is -0.75 to 1e-6;
 12. runs each kernel of phases 9 and 10 against its plain version at
     those solves' shapes, at every rung that runs it (sp16 at k = 2, 3,
     4, 6, 10, sp30 at k = 6, 10): K2 on each cluster group (m=1 and m=2,
     T = 2d + 1), K3 (k=2) and K4 on the pairing products and S_j^-1 B and
     B^T S_j^-1 B, K1 (k=2) and K5 on S_j (up to 51 and 93 rows) and Q (52
     and 94), and K7's iteration launch over both sides' blocks (up to
     18/16 and 32/30 rows); K5's and K7's plain versions run in the CPU
     workers meanwhile;
 13. runs the device-resident loop (core/device_loop.solve_on_device):
     (a) config 1 at k=3 on the all-kernels route with chunk=1, every
     history row, the status, the iterations and the bound bitwise phase
     7's, and the same launches by kernel; with chunk=25 the final state,
     status and iterations bitwise the chunk=1 run's, and the launches per
     launched iteration the same; (b) config 1 at k=2 on the default route
     (K1, K2, K3) with chunk=25: phase 4's status and iterations, and the
     bound of phase 4's best row (the device loop keeps the post-update
     state of the best iteration); (c) the launches of every chunk but the
     first under torch.cuda.set_sync_debug_mode("error") on the all-kernels
     route at k=2 and k=3 (k=3: (a)'s chunk=25 run; a synchronizing call
     fails the phase), and on the default route at k=2 ((b)'s run) under
     "warn", counting the synchronizing calls per iteration by source; (d) both drivers' wall and it/s on
     config 1 at k=3 on the all-kernels route (phase 7's rows against the
     device loop's), and the device's busy share over one profiled chunk;
     (e) sp16 through solve_with_escalation(driver="device_loop") on the
     all-kernels route under the full contract, the rungs (6, 10) from
     phase 9's k=4 rung's result (saved with utils/checkpoint and loaded
     at k=6), so that the device loop's k=6 rung stalls and hands its
     post-update best iterate on, re-rounded, to k=10; its kernels and
     warm starts checked as in phase 9: it must end `optimal` at
     0.8150097064427971 to 1e-10; prints each rung beside phase 9's;
 14. checks K5's panel route (ops/cuda_xf.spd_inverse_panels: the SPD
     inverse above the single launch's 256 rows at k >= 3, a launch of
     csrc/spd_panel_xf.cu's clrs_spd_panel_xf per panel and K4 and K8
     launches between them): (a) bitwise against its plain version, which
     ran in the CPU workers, on sp86's S_j (1x261x261) at k = 3, 6, 10 and
     Q (1x262x262) at k=3, and on 1x257 and 1x512 at k=3, each with its
     one-call and back-to-back times, its bound (the SPD inverse's own
     work: A and A^-1 once, ~n^3/2 multiply-adds) and its launches per call
     (those of the panel kernel, K4 and K8 only), limb 0 once against a
     float64 LAPACK inverse, one call under torch.profiler whose op and
     kernel names must show this repo's three kernels and no library
     product or factorization (no cuBLAS, cuSOLVER, torch.matmul or
     torch.linalg); 1x1024 at k=3 timed against its bound and
     held to LAPACK only (its plain version takes ~8 min of a CPU); at n =
     256 the single launch's time beside the panel route's; (b) sp86 (the two-species packing at 2d =
     86, built at 53*3 + 150 bits and its packing's mpmath
     preconditioning done once in a worker of its own) at k=3 for 3
     iterations on the all-kernels route (the default route's eager LU,
     which a Schur Cholesky's failure at the first iteration brings, takes
     ~2.5 min an iteration, more than the script's time holds), counters
     reset: its kernels, the panel route's among them, and no other must
     launch, and the first iteration must follow a CPU worker on the same
     route to 1e-10 relative; prints every iteration's row,
     launches per iteration by kernel and ms/iter by phase; (c)
     xf_inverse_lu of sp86's largest S_j at the cold start
     (261 rows, k=3) on the card against the CPU port's, to the ulp of the
     last limb;
 15. runs the cluster-sharded solve (parallel/hetero.py), after phase 7:
     (a) config 1 at k=3 through solve_hetero_sharded on one rank on the
     card, all-kernels route, counters reset: `optimal` at 240 to 1e-12,
     phase 7's status, iterations within 2 and bound to 1e-12, its rows
     held to the same solve of a CPU worker to 1e-10 over the whole
     history (the k=3 noise floor lies far below the thresholds, as in
     phase 7), and K2, K4, K5, K7 and K8 launched and no other
     kernel; (b) sp16 packed at k=3 for 10 iterations through the hetero
     step against the phase driver on the card, every row to 1e-10;
     (c) two ranks of clrs_tpu_torch/tools/mp_hetero_worker.py on the one
     card, gloo carrying the CUDA tensors, 3 steps of config 1 at k=3:
     every iterate and diagnostic bitwise the same steps on one rank,
     which are (a)'s first rows bit for bit; prints the phase's seconds;
 16. runs the intra-cluster split (parallel/intra.py) and the int8-sliced
     matmul (ops/mxu_matmul.py), after phase 15: (a) two ranks of
     clrs_tpu_torch/tools/mp_hetero_worker.py on the one card, gloo
     carrying the CUDA tensors, split config 1 at k=3 (T padded to a
     multiple of 2 by pad_info_ranks) inside its clusters on the
     all-kernels route: 3 fused steps with every leaf bitwise the same
     steps on one rank, then solve_intra_sharded to `optimal` (gap under
     1e-15, errors under 1e-30) with the bound 240 to 1e-12, K2, K4, K5,
     K7 and K8 launched and no other kernel; prints the fused step's ms on
     two ranks and on one; (b) the same ranks' panel-route SPD inverse
     (ops/cuda_xf.spd_inverse_panels) with its row products in bands at
     261, 262 and 512 rows at k=3, and the plain panel Cholesky at 64,
     bitwise the one rank's, launching the panel kernel, K4 and K8 only;
     (c) xf_matmul_mxu (torch._int_mm) on the card bitwise a CPU worker's
     at config 1's pairing shapes at k = 2 and 3 and at (1024,64)x(64,1024)
     at k=3, each call timed (also with its adds through K8, as the route
     below runs it) beside K4 on the same operands, and config 1
     at k=3 with use_cuda_matmul=False, use_mxu_matmul=True (X^-1, the step
     lengths and the elementwise arithmetic on their kernels) to `optimal`
     at 240 to 1e-12, its rows held to the CPU's run of the same route to
     1e-10; prints the phase's seconds;
 17. prints the kernels' JSON line, then the result line
     {"ok": true, "device": {...}} as the last line.
Phase 10 runs in a card process of its own (a spawned worker) beside
phases 4-6, 11 and 9, in that order, where the card's compute mode is
Default (else after them, in this process); phase 7 follows.  Each solve
leaves the card idle ~95 % of its time, so the two share it, and those
phases' times are taken beside phase 10's; phases 3, 7, 8 and 12-16 run
alone on the card (15 and 16 beside their own two ranks).  Phase 8's profiles run after phases 9-12, and phase 13
after them: with phase 13's profiled chunk before it, phase 8's window on
the card showed 942 of K8's 943 launches per iteration.
The full record also goes to chiprun_out/chip_smoke.json.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from multiprocessing import get_context

import mpmath
import numpy as np
import torch

from clrs_tpu_torch.utils.flops import (
    bound,
    elemwise_work,
    matmul_work,
    schur_work,
    spd_inverse_function_work,
    steplen_function_work,
)

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
    "spd_panel_xf (K5 above 256 rows)": ("clrs_tpu_torch/csrc/spd_panel_xf.cu",
                                         "clrs_tpu/ops/pallas_xf.py:730"),
}
# the solve whose launches each kernel's JSON entry reports, and the limb
# count of its first main-path shape there; K9 is an entry point that no
# solver route calls, so its solve count is phase 4's zero
KERNEL_PATH = {"spd_inverse_dd": (2, 2), "schur_pairs_dd": (2, 2), "matmul_dd": (2, 2),
               "schur_pairs_xf": (3, 3), "matmul_xf (K4, K6)": (3, 3),
               "spd_inverse_xf": (3, 3), "steplen_xf": ("all", 3),
               "elemwise_xf": ("all", 3), "spd_inverse_dd_wide": (2, 2),
               "spd_panel_xf (K5 above 256 rows)": ("sp86", 3)}
STEPLEN_LADDER = (2, 3, 4, 6, 10)
ALL_KERNELS_ROUTE = dict(use_cuda_inverse=True, use_cuda_steplength=True,
                         use_cuda_elemwise=True)
LADDER = (3, 4, 6, 10)
SOLVE = dict(omega_p=100.0, omega_d=100.0, verbose=False)


LOG_LINES = None  # a list while phase 10 keeps its lines for the main process


def log(*a):
    if LOG_LINES is None:
        print(*a, flush=True)
    else:
        LOG_LINES.append(" ".join(map(str, a)))


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


# config-1 products of core/kernels.matmul_route (B, n, K, m): pairings, weighted-A and trace-A
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
# the sphere-packing solves' shapes (phases 9 and 10), at every rung that
# runs them: sp16 climbs (2, 3, 4, 6, 10), sp30 runs (6, 10).  Each has four
# cluster groups (G clusters of m x m blocks, K = 2d + 1 samples, rank 1):
# three of m=1 with blocks of d + 1 and d rows, two 1x1, one of m=2 with a
# 2x2 block, and the main one of m=2 with blocks of 2d + 2 and 2d rows
SP_RUNGS = {"sp16": (2, 3, 4, 6, 10), "sp30": (6, 10)}
# K2 (G, m, K, rmax); the 1x1 and 2x2 groups are the same in both
SP_SCHUR_SHAPES = {
    "sp16": (("sp16 G=3 m=1 K=17 rmax=1", (3, 1, 17, 1)), ("sp16 G=1 m=2 K=17 rmax=1", (1, 2, 17, 1)),
             ("G=2 m=1 K=1 rmax=1", (2, 1, 1, 1)), ("G=1 m=2 K=1 rmax=1", (1, 2, 1, 1))),
    "sp30": (("sp30 G=3 m=1 K=31 rmax=1", (3, 1, 31, 1)), ("sp30 G=1 m=2 K=31 rmax=1", (1, 2, 31, 1)))}
# K3 (k=2) and K4 (B, n, K, m): the pairing products of the widest block of
# each group (Z V and V^T (Z V), kernels.py's compute_pairings), then
# S_j^-1 B and B^T (S_j^-1 B) of the main cluster (n_y = dim_S + 1)
SP_MATMUL_SHAPES = {
    "sp16": (("sp16 V^T ZV 3x(17,9)x(9,17)", (3, 17, 9, 17)), ("sp16 ZV m=2 (36,9)x(9,17)", (1, 36, 9, 17)),
             ("sp16 V^T ZV m=2 (17,9)x(9,68)", (1, 17, 9, 68)),
             ("sp16 S_j^-1 B (51,51)x(51,52)", (1, 51, 51, 52)),
             ("sp16 B^T S_j^-1 B (52,51)x(51,52)", (1, 52, 51, 52))),
    "sp30": (("sp30 V^T ZV 3x(31,16)x(16,31)", (3, 31, 16, 31)),
             ("sp30 ZV m=2 (64,16)x(16,31)", (1, 64, 16, 31)),
             ("sp30 V^T ZV m=2 (31,16)x(16,124)", (1, 31, 16, 124)),
             ("sp30 S_j^-1 B (93,93)x(93,94)", (1, 93, 93, 94)),
             ("sp30 B^T S_j^-1 B (94,93)x(93,94)", (1, 94, 93, 94)))}
# K1 (k=2) and K5 (B, n, cond): S_j of the m=1 group and of the main
# cluster, and Q; "config1" holds phase 3's config-1 shapes, whose K5 rows
# at CONFIG1_CPU_KS take their plain versions from the CPU workers too
SP_INVERSE_SHAPES = {
    "config1": INVERSE_SHAPES,
    "sp16": (("sp16 S_j 3x17x17", (3, 17, 1e8)), ("sp16 S_j 1x51x51", (1, 51, 1e8)),
             ("sp16 Q 1x52x52", (1, 52, 1e6))),
    "sp30": (("sp30 S_j 3x31x31", (3, 31, 1e8)), ("sp30 S_j 1x93x93", (1, 93, 1e8)),
             ("sp30 Q 1x94x94", (1, 94, 1e6)))}
# K7's iteration launch: (n, count) per block size of one side, X's and
# Y's in one launch (the 1x1 blocks take the closed form)
SP_STEPLEN_BLOCKS = {"config1": ((6, 1), (5, 1)),
                     "sp16": ((9, 3), (8, 3), (2, 1), (18, 1), (16, 1)),
                     "sp30": ((16, 3), (15, 3), (2, 1), (32, 1), (30, 1))}
# K5 and K7 where the halving tree changes shape (csrc/chol_xf.cuh)
TREE_SIZES = (1, 2, 31, 32, 33, 64, 65)
TREE_WORKERS = 4  # CPU processes for the tree rows' plain versions
WORKER_NICE = 10  # os.nice of every worker process
# phase 3's K5 and K7 rows at config-1 shapes at these k: their plain
# versions take ~110 s of small launches on the card (41 s for K7's
# iteration launch at k=10), a few seconds each in the CPU workers
CONFIG1_CPU_KS = (6, 10)


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


def tree_plain(k, n, kernel):
    """K5's ("k5") or K7's ("k7") plain version on tree_inputs(k, n), in a
    CPU worker (at k=12 and n = 64, 65 each takes minutes of small launches
    on the card, ~2 min on the CPU, so the two run as tasks of their own):
    outputs, flags and seconds."""
    torch.set_num_threads(1)
    from clrs_tpu_torch.ops import cuda_xf

    a, m, d = tree_inputs(k, n)
    t0 = time.time()
    if kernel == "k5":
        inv, ok = cuda_xf.spd_inverse_xf_torch(a)
        return dict(inv=inv.numpy(), ok=ok.numpy(), k5_s=time.time() - t0)
    w, okw = cuda_xf.steplen_sandwich_xf_torch(m, d)
    return dict(w=w.numpy(), okw=okw.numpy(), k7_s=time.time() - t0)


def ladder_tasks(rungs=None):
    """The rows whose plain versions run in CPU workers (ladder_plain),
    longest first: K5 on each SP_INVERSE_SHAPES entry and K7 on each
    (side, block size) group of SP_STEPLEN_BLOCKS, at every rung of rungs
    (default SP_RUNGS, the sphere-packing solves; K5 from k=3: K1 takes k=2
    on the card)."""
    tasks = []
    for sp, ks in (rungs or SP_RUNGS).items():
        for k in ks:
            if k > 2:
                tasks += [("spd_inverse_xf", sp, k, i) for i in range(len(SP_INVERSE_SHAPES[sp]))]
            tasks += [("steplen_xf", sp, k, (side, i)) for side in range(2)
                      for i in range(len(SP_STEPLEN_BLOCKS[sp]))]

    def size(task):
        name, sp, k, i = task
        n = (SP_INVERSE_SHAPES[sp][i][1][1] if name == "spd_inverse_xf"
             else SP_STEPLEN_BLOCKS[sp][i[1]][0])
        return k * k * n

    return sorted(tasks, key=size, reverse=True)


def ladder_inputs(task):
    """A ladder task's inputs, on the CPU, the same in every process: for
    K5 the blocks of (B, n) at cond, for K7 M (SPD) and a symmetric dM of
    one side's blocks of one size."""
    name, sp, k, i = task
    if name == "spd_inverse_xf":
        B, n, cond = SP_INVERSE_SHAPES[sp][i][1]
        return [spd_batch(np.random.default_rng([3000, k, n]), B, n, k, cond, "cpu")]
    side, j = i
    n, count = SP_STEPLEN_BLOCKS[sp][j]
    rng = np.random.default_rng([3001, k, n, side])
    m = spd_batch(rng, count, n, k, 1e6, "cpu")
    d = rand_xf(rng, (count, n, n), k, "cpu").transpose(0, 1)
    return [m, ((d + d.transpose(-1, -2)) / 2).contiguous()]


def ladder_plain(task):
    """A ladder task's plain version in a CPU worker (at k=10 K5 on 93 rows
    and K7 on sp30's blocks take minutes of small launches on the card):
    outputs and seconds."""
    torch.set_num_threads(1)
    from clrs_tpu_torch.ops import cuda_xf

    inputs = ladder_inputs(task)
    t0 = time.time()
    if task[0] == "steplen_xf":
        m, d = inputs
        out = cuda_xf.steplen_sandwich_xf_torch(m, d.transpose(-1, -2))
    else:
        out = cuda_xf.spd_inverse_xf_torch(inputs[0])
    return dict(out=tuple(x.numpy() for x in out), s=time.time() - t0)


def make_case(rows):
    """The check of one kernel row: the kernel's output bitwise against its
    plain version's on the same inputs, then the kernel's time (median and
    back to back), the plain version's and the bound; the row goes to rows."""

    def case(name, k, label, kernel, plain, args, work, reps, plain_reps, main,
             plain_ms=None, view=None):
        """view: applied to both outputs before they are compared (not timed).
        plain_reps 0: the plain version's time is that of the call compared
        (from k=6, where one call of K5's or K7's takes seconds of small
        launches), not a median of more."""
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
        ms = median_ms(lambda: kernel(*args), reps, warm=False)  # the call compared warmed it
        ms_many = many_ms(lambda: kernel(*args), max(2, min(200, int(20.0 / max(ms, 0.05)))))
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

    return case


def flat(groups):  # W and flags of every K7 group, as one float64 vector
    return torch.cat([w.reshape(-1) for w, _ in groups] + [ok.double() for _, ok in groups])


def inverse_row_from_cpu(case, sp, k, i, dev, futures, reps, main):
    """K5 on entry i of SP_INVERSE_SHAPES[sp] at k against its plain
    version, computed in a CPU worker on the same inputs (ladder_plain),
    whose time is that of the row."""
    from clrs_tpu_torch.ops import cuda_xf

    label, (B, n, _) = SP_INVERSE_SHAPES[sp][i]
    task = ("spd_inverse_xf", sp, k, i)
    (a,) = (x.to(dev) for x in ladder_inputs(task))
    plain = futures[task].get()
    want = tuple(torch.from_numpy(x).to(dev) for x in plain["out"])
    row = case("spd_inverse_xf", k, label, cuda_xf.spd_inverse_xf, lambda *_: want, (a,),
               spd_inverse_function_work(k, B, n), reps, 0, main, plain_ms=1e3 * plain["s"])
    row["plain_device"] = "cpu"
    return row


def steplen_groups(sp, k, dev, futures):
    """K7's iteration launch of SP_STEPLEN_BLOCKS[sp] at k: the groups (each
    side's blocks of one size, M read in place, dM a transposed view) on
    the card, and per group the plain version's outputs and seconds from
    the CPU workers (ladder_plain) and the work."""
    groups, want, secs, work = [], [], [], []
    for side in range(2):
        for i, (n, count) in enumerate(SP_STEPLEN_BLOCKS[sp]):
            task = ("steplen_xf", sp, k, (side, i))
            m, d = (x.to(dev) for x in ladder_inputs(task))
            groups.append((list(m.unbind(0)), [x.transpose(-1, -2) for x in d.unbind(0)]))
            plain = futures[task].get()
            want.append(tuple(torch.from_numpy(x).to(dev) for x in plain["out"]))
            secs.append(plain["s"])
            work.append(steplen_function_work(k, count, n))
    return groups, want, secs, work


def check_kernels(dev, record, rows, tree_futures, config1_futures):
    """Phase 3: every kernel bitwise against its plain version (K5's and
    K7's at CONFIG1_CPU_KS from config1_futures, the CPU workers')."""
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    rng = np.random.default_rng(0)
    case = make_case(rows)

    # K1 (the k=2 instance of K5's kernel) at config-1 shapes, then wide:
    # 256 blocks of 64x64 at cond ~1e10, one of them indefinite, and one
    # block of 257 and of 1024 rows (the threads finish more than a row each)
    for label, (B, n, cond) in INVERSE_SHAPES:
        a = spd_batch(rng, B, n, 2, cond, dev)
        case("spd_inverse_dd", 2, label, cuda_dd.dd_spd_inverse,
             cuda_dd.dd_spd_inverse_torch, (a,), spd_inverse_function_work(2, B, n), 50, 3, True)
    a = spd_batch(rng, 256, 64, 2, 1e10, dev)
    a[7, 0, 5, 5] = -1e3
    row = case("spd_inverse_dd", 2, "wide 256x64x64 (1 indefinite)", cuda_dd.dd_spd_inverse,
               cuda_dd.dd_spd_inverse_torch, (a,), spd_inverse_function_work(2, 256, 64), 5, 1, False)
    assert row["flags"][7] is False, "K1: the indefinite block was not flagged"
    for n in (257, 1024):
        a = spd_batch(rng, 1, n, 2, 1e4, dev)
        case("spd_inverse_dd", 2, f"1x{n}x{n}", cuda_dd.dd_spd_inverse,
             cuda_dd.dd_spd_inverse_torch, (a,), spd_inverse_function_work(2, 1, n), 3, 0, False)

    # K2 at k=2, the whole block in one launch on the pairings as they lie:
    # the main cluster has m=1 (one pair) and T = K*rmax = 11; the ten sign
    # clusters go as one group of G=10 with T=1; m=2 at rank 2; wide
    def schur_rows(k):
        for i, (label, (G, m, K, rmax)) in enumerate(SCHUR_SHAPES):
            main = i < SCHUR_MAIN
            case("schur_pairs_dd" if k == 2 else "schur_pairs_xf", k, label,
                 cuda_xf.schur_pairs, cuda_xf.schur_pairs_torch,
                 schur_operands(rng, k, G, m, K, rmax, dev), schur_work(k, G, m, K * rmax),
                 50 if main else 10, (3 if main else 1) if k < 6 else 0, main)

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
                 matmul_work(k, B, n, K, m, steps, Ba, Bb), 50, 3 if k < 6 else 0, True)

    # K2, K4 and K5 at the ladder's k, at every config-1 shape
    for k in LADDER:
        plain_reps = 3 if k < 6 else 0
        schur_rows(k)
        for label, (B, n, K, m) in MATMUL_SHAPES:
            a, b = rand_xf(rng, (B, n, K), k, dev), rand_xf(rng, (B, K, m), k, dev)
            case("matmul_xf (K4, K6)", k, label, cuda_xf.matmul_xf, cuda_xf.matmul_xf_torch,
                 (a, b), matmul_work(k, B, n, K, m, cuda_xf.padded_contraction(K)), 50,
                 plain_reps, True)
        for i, (label, (B, n, cond)) in enumerate(INVERSE_SHAPES):
            if k in CONFIG1_CPU_KS:
                inverse_row_from_cpu(case, "config1", k, i, dev, config1_futures, 20, True)
                continue
            a = spd_batch(rng, B, n, k, cond, dev)
            case("spd_inverse_xf", k, label, cuda_xf.spd_inverse_xf,
                 cuda_xf.spd_inverse_xf_torch, (a,), spd_inverse_function_work(k, B, n), 20,
                 1 if k < 6 else 0, True)

    # wide: K4 above K6's size gate (k*n*m > 2e6 tiles on the TPU), and K5
    # on 64 blocks of 32x32 with one indefinite
    a, b = rand_xf(rng, (1, 1024, 64), 3, dev), rand_xf(rng, (1, 64, 1024), 3, dev)
    case("matmul_xf (K4, K6)", 3, "wide (1024,64)x(64,1024)", cuda_xf.matmul_xf,
         cuda_xf.matmul_xf_torch, (a, b), matmul_work(3, 1, 1024, 64, 1024, 64), 5, 1,
         False)
    a = spd_batch(rng, 64, 32, 3, 1e10, dev)
    a[5, 0, 3, 3] = -1e3
    row = case("spd_inverse_xf", 3, "wide 64x32x32 (1 indefinite)", cuda_xf.spd_inverse_xf,
               cuda_xf.spd_inverse_xf_torch, (a,), spd_inverse_function_work(3, 64, 32), 5, 1, False)
    assert row["flags"][5] is False, "K5: the indefinite block was not flagged"

    # K7 on the config-1 step-length groups (M SPD, dM symmetric indefinite)
    # at the ladder's k, and wide at k=3 with one indefinite M
    def sandwich_inputs(B, n, k, cond):
        m = spd_batch(rng, B, n, k, cond, dev)
        d = rand_xf(rng, (B, n, n), k, dev).transpose(0, 1)
        return m, (d + d.transpose(-1, -2)) / 2

    for k in STEPLEN_LADDER:
        # the iteration's one launch: X's and Y's 6x6 and 5x5 blocks, each
        # a (k, n, n) view read in place, dM a transposed one; then each
        # size alone, at CONFIG1_CPU_KS on X's groups of that launch, every
        # plain version from the CPU workers
        on_cpu = k in CONFIG1_CPU_KS
        if on_cpu:
            groups, want, secs, work = steplen_groups("config1", k, dev, config1_futures)
            plain, plain_ms = (lambda *_: want), 1e3 * sum(secs)
        else:
            groups = []
            for n in (6, 5, 6, 5):
                m, d = sandwich_inputs(1, n, k, 1e6)
                groups.append(([m[0]], [d[0].transpose(-1, -2)]))
            work = [steplen_function_work(k, 1, n) for n in (6, 5, 6, 5)]
            plain, plain_ms = (lambda g: [
                cuda_xf.steplen_sandwich_xf_torch(torch.stack(ms), torch.stack(ds))
                for ms, ds in g]), None
        row = case("steplen_xf", k, "iteration X, Y x (1x6x6, 1x5x5)",
                   cuda_xf.steplen_sandwich_xf_groups, plain,
                   (groups,), tuple(map(sum, zip(*work))), 20, 0 if on_cpu else 1, True,
                   plain_ms=plain_ms, view=flat)
        per_size = flat([cuda_xf.steplen_sandwich_xf(torch.stack(ms), torch.stack(ds))
                         for ms, ds in groups])
        assert bits_equal(per_size, flat(cuda_xf.steplen_sandwich_xf_groups(groups))), \
            f"steplen_xf k={k}: one launch differs from a launch per size"
        row["equals_per_size_launches"] = True
        if on_cpu:
            row["plain_device"] = "cpu"
        for i, (label, (B, n)) in enumerate((("1x6x6", (1, 6)), ("1x5x5", (1, 5)))):
            if on_cpu:
                ms, ds = groups[i]
                row = case("steplen_xf", k, label, cuda_xf.steplen_sandwich_xf,
                           lambda *_, w=want[i]: w, (torch.stack(ms), torch.stack(ds)),
                           steplen_function_work(k, B, n), 20, 0, True, plain_ms=1e3 * secs[i])
                row["plain_device"] = "cpu"
                continue
            case("steplen_xf", k, label, cuda_xf.steplen_sandwich_xf,
                 cuda_xf.steplen_sandwich_xf_torch, sandwich_inputs(B, n, k, 1e6),
                 steplen_function_work(k, B, n), 20, 1, True)
    m, d = sandwich_inputs(64, 32, 3, 1e10)
    m[5, 0, 4, 4] = -1e3
    row = case("steplen_xf", 3, "wide 64x32x32 (1 indefinite)", cuda_xf.steplen_sandwich_xf,
               cuda_xf.steplen_sandwich_xf_torch, (m, d), steplen_function_work(3, 64, 32), 5, 1,
               False)
    assert row["flags"][5] is False, "K7: the indefinite block was not flagged"

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
                           (3 if main else 1) if k < 6 else 0, main)
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
                           (a, b), elemwise_work(k, n_out, op), 50, 3 if k < 6 else 0, True)
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
                   lambda *_: plain[0], (a,), spd_inverse_function_work(2, B, n),
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

    # K5 and K7 at every shape of their dot products' halving tree (one term
    # per lane, a group below a warp, a warp, terms kept in the lane), two
    # blocks of which the second is indefinite; their plain versions ran in
    # CPU workers on the same inputs (tree_plain), and their times are those;
    # last, so that the card checks K8 and K9 while the workers finish
    for (k, n), futures in tree_futures.items():
        a, m, d = (x.to(dev) for x in tree_inputs(k, n))
        plain = dict(futures[0].get(), **futures[1].get())
        for name, kern, args, outs, secs, work in (
                ("spd_inverse_xf", cuda_xf.spd_inverse_xf, (a,), ("inv", "ok"), "k5_s",
                 spd_inverse_function_work(k, 2, n)),
                ("steplen_xf", cuda_xf.steplen_sandwich_xf, (m, d), ("w", "okw"), "k7_s",
                 steplen_function_work(k, 2, n))):
            want = tuple(torch.from_numpy(plain[o]).to(dev) for o in outs)
            row = case(name, k, f"tree 2x{n}x{n} (1 indefinite)", kern,
                       lambda *_, want=want: want, args, work, 5, 0, False,
                       plain_ms=1e3 * plain[secs])
            row["plain_device"] = "cpu"
            assert row["flags"] == [True, False], f"{name} n={n}: flags {row['flags']}"
    record["kernel_checks"] = rows
    return rows


def check_ladder_kernels(dev, rows, futures):
    """Phase 12: every kernel of phases 9 and 10 bitwise against its plain
    version at those solves' shapes, at every rung that runs it: K2 on
    each cluster group, K3 (k=2) and K4 on the pairing and Schur products,
    K1 (k=2) and K5 on S_j and Q, and K7's iteration launch over both
    sides' blocks.  K5's and K7's plain versions ran in CPU workers on the
    same inputs (ladder_plain), and their times are those."""
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    rng = np.random.default_rng(2)
    case = make_case(rows)
    for sp, ks in SP_RUNGS.items():
        for k in ks:
            reps = 1 if k < 6 else 0
            for label, (G, m, K, rmax) in SP_SCHUR_SHAPES[sp] + (SP_SCHUR_SHAPES["sp16"][2:]
                                                                 if sp == "sp30" else ()):
                case("schur_pairs_dd" if k == 2 else "schur_pairs_xf", k, label,
                     cuda_xf.schur_pairs, cuda_xf.schur_pairs_torch,
                     schur_operands(rng, k, G, m, K, rmax, dev), schur_work(k, G, m, K * rmax),
                     20, reps, False)
            for label, (B, n, K, m) in SP_MATMUL_SHAPES[sp]:
                a, b = rand_xf(rng, (B, n, K), k, dev), rand_xf(rng, (B, K, m), k, dev)
                if k == 2:
                    case("matmul_dd", 2, label, cuda_xf.dd_matmul, cuda_xf.dd_matmul_seq_torch,
                         (a, b), matmul_work(2, B, n, K, m, K), 20, reps, False)
                else:
                    case("matmul_xf (K4, K6)", k, label, cuda_xf.matmul_xf,
                         cuda_xf.matmul_xf_torch, (a, b),
                         matmul_work(k, B, n, K, m, cuda_xf.padded_contraction(K)), 20, reps,
                         False)
            if k == 2:
                for label, (B, n, cond) in SP_INVERSE_SHAPES[sp]:
                    a = spd_batch(rng, B, n, 2, cond, dev)
                    case("spd_inverse_dd", 2, label, cuda_dd.dd_spd_inverse,
                         cuda_dd.dd_spd_inverse_torch, (a,), spd_inverse_function_work(2, B, n), 20, 1,
                         False)
            else:
                for i in range(len(SP_INVERSE_SHAPES[sp])):
                    inverse_row_from_cpu(case, sp, k, i, dev, futures, 5, False)
            groups, want, secs, work = steplen_groups(sp, k, dev, futures)
            sizes = ", ".join(f"{c}x{n}x{n}" for n, c in SP_STEPLEN_BLOCKS[sp])
            row = case("steplen_xf", k, f"{sp} iteration X, Y x ({sizes})",
                       cuda_xf.steplen_sandwich_xf_groups, lambda *_, want=want: want,
                       (groups,), tuple(map(sum, zip(*work))), 5, 0, False,
                       plain_ms=1e3 * sum(secs), view=flat)
            row["plain_device"] = "cpu"
    return rows


# ---------------------------------------------------------------------------
# Phases 4-6: the solves
# ---------------------------------------------------------------------------


def counters():
    from clrs_tpu_torch.ops.cuda_xf import launch_counters

    return launch_counters()


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def per_phase_ms(res):
    n = max(res.iterations - 2, 1)  # timings exclude the first 2 iterations
    return {k: 1e3 * v / n for k, v in sorted(res.timings.items())}


def held_rows(gpu, cpu, floor=None):
    """The largest relative difference of p_obj, d_obj and gap between two
    histories over the rows before either reaches an error below floor
    (None: every row), and that count of rows."""
    held = next((i for i, (rg, rc) in enumerate(zip(gpu, cpu)) if floor is not None
                 and min(rg["p_err"], rg["d_err"], rc["p_err"], rc["d_err"]) < floor),
                min(len(gpu), len(cpu)))
    worst = max((abs(rg[key] - rc[key]) / max(abs(rc[key]), 1e-300)
                 for rg, rc in zip(gpu[:held], cpu[:held]) for key in ("p_obj", "d_obj", "gap")),
                default=0.0)
    return worst, held


# phase 5's iterations on the card: the default route at k=3 takes ~3.7 s an
# iteration there (eager k-limb arithmetic), so its 39 would take more of
# the script's time than it can give; iterations 3-8 give its time by phase
DEFAULT_K3_ITERATIONS = 8


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
                  route=None, tag=None, iterations=None):
    """Delsarte dim 8, 2d=10 at k limbs on the card, held against the CPU.
    iterations: the card runs only the solve's first iterations, held row
    for row against the CPU's whole run, whose end (status and bound) then
    stands for the route's; None runs the whole solve on the card."""
    reset_counters()
    t0 = time.time()
    bound_, res = solve(8, 5, k, dev, dict(route or {}, **(
        {"maxiterations": iterations} if iterations else {})))
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
    if iterations:
        assert res.iterations == len(res.history) == iterations, res.iterations
        bound_, status = cpu["bound"], cpu["status"]  # the end, on the CPU only
    else:
        status = res.status
        assert res.status == cpu["status"], (res.status, cpu["status"])
        assert abs(res.iterations - cpu["iterations"]) <= 2, (res.iterations, cpu["iterations"])
    assert abs(bound_ - 240.0) < bound_tol, f"{tag} bound {bound_!r}"
    if expect_status is not None:
        assert status == expect_status, f"{tag} status {status}"
    assert floor_at >= 1, "no iteration before the error floor to compare"
    assert pre_floor <= 1e-10, f"gpu and cpu histories differ by {pre_floor!r}"
    return launches, res


def solve_all_kernels(dev, record, cpu_future, default, default_cpu):
    """Phase 7: config 1 at k=3 on the all-kernels route, against the CPU
    on the same route and against the default route: phase 5's iterations
    on the card (default) for the time by phase, the CPU's whole run
    (default_cpu, a future) for the status and the iterations."""
    launches, res = solve_config1(
        dev, record, 3, cpu_future, None, 1e-12, "optimal",
        ("schur_pairs", "matmul_xf", "spd_inverse_xf", "steplen_xf", "elemwise_xf"),
        route=ALL_KERNELS_ROUTE, tag="config1 k=3 all-kernels")
    # X's and Y's 6x6 and 5x5 blocks, all in one launch every iteration
    assert launches["steplen_xf"] == res.iterations, launches["steplen_xf"]
    whole = default_cpu.get()
    assert abs(res.iterations - whole["iterations"]) <= 2, (res.iterations, whole["iterations"])
    assert whole["status"] == "optimal", whole["status"]
    steady = {}
    for name, r in (("default", default), ("all-kernels", res)):
        steady[name] = (r.iterations - 2) / max(sum(r.timings.values()), 1e-12)
    log(f"config1 k=3 routes, steady it/s: default {steady['default']:.4f}, "
        f"all-kernels {steady['all-kernels']:.4f}; iterations {whole['iterations']} (the "
        f"CPU's whole run; {default.iterations} on the card) / {res.iterations}")
    a, b = per_phase_ms(default), per_phase_ms(res)
    log("config1 k=3 routes, ms/iter by phase (default / all-kernels): " + ", ".join(
        f"{p}={a.get(p, 0.0):.2f}/{b.get(p, 0.0):.2f}" for p in sorted(set(a) | set(b))))
    log(f"config1 k=3 all-kernels: launches per iteration: " + ", ".join(
        f"{n}={v / res.iterations:.2f}" for n, v in launches.items()))
    record["config1_k3_routes"] = dict(steady_it_per_s=steady, default_ms=a,
                                       all_kernels_ms=b)
    return launches, res


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
                             (solver, "xf_min_eig_sym"), (solver, "schur_block_contribution")),
                            RANGES[:5] + RANGES[6:]):
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
    # the phases take their matmul when they are made (core/kernels.py's
    # matmul_route), so its range goes on before the solve; it records
    # only while the profiler runs
    ranged(core_kernels, "xf_matmul_k", RANGES[5])
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


# ---------------------------------------------------------------------------
# Phases 9-11: the precision ladder, sp30 and config 4
# ---------------------------------------------------------------------------

# the reference's own example (examples/SpherePacking.jl:116-129): two
# species, radii 1 and sqrt(2) - 1, n = 3, built at the precision of the
# ladder's top rung (scripts/bench_escalation.py:47-48); sp16 is 2d = 16,
# sp30 2d = 30 (BASELINE config 2); known answers from BASELINE.md round 3
SP_PREC = 53 * 10 + 150
SP16_BOUND, SP30_BOUND = 0.8150097064427971, 0.813598677806444
LADDER_SOLVE = dict(omega_p=100.0, omega_d=100.0, maxiterations=350, stall_patience=40,
                    duality_gap_threshold=1e-15, primal_error_threshold=1e-30,
                    dual_error_threshold=1e-30)
LADDER_PARITY_ITERATIONS = 10  # the k=2 rung's first iterations held against the CPU
SP30_LADDER = (6, 10)  # cold at k=6; a stall restarts at k=10
# the kernels each rung must launch on the all-kernels route; the others
# must not (K1 and K3 are the k=2 instances, K9 has no solver caller)
RUNG_KERNELS = {2: ("spd_inverse_dd", "schur_pairs", "matmul_dd", "steplen_xf", "elemwise_xf"),
                3: ("schur_pairs", "matmul_xf", "spd_inverse_xf", "steplen_xf", "elemwise_xf")}


def sphere_problem(d):
    """(constraints, b, blockinfo) of the two-species packing at 2d, built
    at SP_PREC bits; mpmath's precision is left there, for the packing of
    every rung (the caller restores it)."""
    from clrs_tpu_torch import nsphere_packing_2point

    mpmath.mp.prec = SP_PREC
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    return nsphere_packing_2point(3, d, r, 2, prec=SP_PREC, build_only=True)


def cpu_sphere(d, k, iterations):
    """The first iterations of the packing solve at k on the CPU, on the
    all-kernels route's plain versions; run in a worker process."""
    from clrs_tpu_torch import solverank1sdp

    torch.set_num_threads(2)
    cons, b, info = sphere_problem(d)
    t0 = time.time()
    res = solverank1sdp(cons, b, info, device="cpu", precision_k=k, verbose=False,
                        use_cuda_matmul=True, **ALL_KERNELS_ROUTE,
                        **dict(LADDER_SOLVE, maxiterations=iterations))
    return dict(history=res.history, wall_s=time.time() - t0)


def reround_leaves(res, k):
    """The result's iterate with k limbs, padded with zeros or cut, as a
    flat list of tensors (written here apart from core/escalate.py)."""
    out = []
    for x in [res.x, res.y] + [b for row in res.X for b in row] + [b for row in res.Y for b in row]:
        limbs = x.limbs
        pad = max(k - limbs.shape[0], 0)
        out.append(torch.cat([limbs, limbs.new_zeros((pad,) + limbs.shape[1:])])[:k])
    return out


def climb(dev, tag, cons, b, info, **ladder):
    """solve_with_escalation on the card on the all-kernels route, with
    every launch counter reset before each rung and read after it, and each
    rung's warm start held bitwise against the previous rung's result
    re-rounded.  Returns (result, rungs)."""
    from clrs_tpu_torch.core import escalate

    rungs = []
    solve_fn = escalate.solverank1sdp

    def rung(*args, precision_k, initial_solutions, **kwargs):
        warm_equal = None
        if rungs:
            x, y, X, Y = initial_solutions
            got = [x.limbs, y.limbs] + [t.limbs for row in X + Y for t in row]
            want = reround_leaves(rungs[-1]["res"], precision_k)
            warm_equal = len(got) == len(want) and all(map(bits_equal, got, want))
            assert warm_equal, f"{tag} k={precision_k}: the warm start is not the last result"
        reset_counters()
        t0 = time.time()
        res = solve_fn(*args, precision_k=precision_k, initial_solutions=initial_solutions,
                       **kwargs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counters()
        it_s = (res.iterations - 2) / max(sum(res.timings.values()), 1e-12)
        rungs.append(dict(k=precision_k, res=res, wall_s=wall, launches=launches,
                          steady_it_per_s=it_s, warm_start_equal=warm_equal))
        log(f"{tag} rung k={precision_k}: status {res.status} iterations {res.iterations} wall "
            f"{wall:.3f} s steady {it_s:.4f} it/s; warm start "
            f"{'cold' if warm_equal is None else 'bitwise the last result re-rounded'}")
        log(f"{tag} rung k={precision_k}: launches " + ", ".join(
            f"{n}={v} ({v / max(res.iterations, 1):.2f}/iter)" for n, v in launches.items()))
        log(f"{tag} rung k={precision_k}: ms/iter by phase: " + ", ".join(
            f"{p}={v:.2f}" for p, v in per_phase_ms(res).items()))
        expect = RUNG_KERNELS[min(precision_k, 3)]
        for name, n in launches.items():
            assert (n > 0) == (name in expect), \
                f"{tag} rung k={precision_k}: {name} launched {n} times"
        return res

    escalate.solverank1sdp = rung
    try:
        res = escalate.solve_with_escalation(cons, b, info, device=dev, verbose=False,
                                             **ALL_KERNELS_ROUTE, **LADDER_SOLVE, **ladder)
    finally:
        escalate.solverank1sdp = solve_fn
    return res, rungs


def check_contract(tag, res, known):
    """`optimal` at the known bound to 1e-10, with the last row's gap under
    1e-15 and its errors under 1e-30."""
    row = res.history[-1]
    bound_ = -res.dual_objective
    log(f"{tag}: status {res.status} bound {bound_!r} (known {known!r}, off by "
        f"{abs(bound_ - known):.3e}); last row gap {row['gap']:.3e} P/p/d errors "
        f"{row['P_err']:.3e}/{row['p_err']:.3e}/{row['d_err']:.3e}")
    assert res.status == "optimal", f"{tag}: status {res.status}"
    assert abs(bound_ - known) < 1e-10, f"{tag}: bound {bound_!r}"
    assert row["gap"] < 1e-15 and max(row["P_err"], row["p_err"], row["d_err"]) < 1e-30, row
    return bound_


def rung_record(rungs):
    return [dict({key: v for key, v in r.items() if key != "res"}, status=r["res"].status,
                 iterations=r["res"].iterations, phase_ms_per_iter=per_phase_ms(r["res"]),
                 history=r["res"].history) for r in rungs]


def solve_sp16_ladder(dev, record, cpu_future):
    """Phase 9: sp16 through solve_with_escalation's default ladder (2, 3,
    4, 6, 10) on the all-kernels route under the full contract; the k=2
    rung's first iterations against the CPU on the same route."""
    from clrs_tpu_torch.core.escalate import DEFAULT_LADDER

    old = mpmath.mp.prec
    try:
        t0 = time.time()
        cons, b, info = sphere_problem(8)
        log(f"sp16: front-end {time.time() - t0:.3f} s; m {info.m}, blocks "
            f"{info.Y_blocksizes}, dim_S {info.dim_S}")
        t0 = time.time()
        res, rungs = climb(dev, "sp16", cons, b, info)
        wall = time.time() - t0
    finally:
        mpmath.mp.prec = old
    log(f"sp16 ladder: {[(r['k'], r['res'].status, r['res'].iterations) for r in rungs]}, "
        f"wall {wall:.3f} s")
    bound_ = check_contract("sp16 ladder", res, SP16_BOUND)
    assert [r["k"] for r in rungs] == list(DEFAULT_LADDER[:len(rungs)])

    cpu = cpu_future.get()
    worst, held = held_rows(rungs[0]["res"].history, cpu["history"], 1e-20)
    log(f"sp16 k=2: relative history difference gpu vs cpu {worst!r} over the first {held} "
        f"iterations (cpu {cpu['wall_s']:.3f} s for {len(cpu['history'])})")
    assert held >= 1 and worst <= 1e-10, f"sp16 k=2: gpu and cpu differ by {worst!r}"
    record["sp16_ladder"] = dict(bound=bound_, status=res.status, wall_s=wall,
                                 rungs=rung_record(rungs), k2_cpu_rel_diff=worst,
                                 k2_cpu_held=held, k2_cpu_wall_s=cpu["wall_s"])
    return rungs


def solve_sp30(dev, record):
    """Phase 10: sp30 (BASELINE config 2) cold at k=6 on the all-kernels
    route under the full contract, through the ladder (6, 10): a k=6 solve
    that stalls restarts at k=10 from its best iterate."""
    old = mpmath.mp.prec
    try:
        t0 = time.time()
        cons, b, info = sphere_problem(15)
        log(f"sp30: front-end {time.time() - t0:.3f} s; blocks {info.Y_blocksizes}, "
            f"dim_S {info.dim_S}")
        t0 = time.time()
        res, rungs = climb(dev, "sp30", cons, b, info, k_ladder=SP30_LADDER)
        wall = time.time() - t0
    finally:
        mpmath.mp.prec = old
    log(f"sp30: {[(r['k'], r['res'].status, r['res'].iterations) for r in rungs]}, "
        f"wall {wall:.3f} s")
    bound_ = check_contract("sp30", res, SP30_BOUND)
    record["sp30"] = dict(bound=bound_, status=res.status, wall_s=wall, rungs=rung_record(rungs))
    return rungs


def sp30_process():
    """Phase 10 with its log lines kept: run in a card process of its own
    beside phases 4-6, 9 and 11 where the card takes more than one process
    (each solve leaves the card idle ~95 % of its time, waiting on its
    host), else in the main process.  Returns (its record, its lines)."""
    global LOG_LINES
    LOG_LINES, record = [], {}
    try:
        solve_sp30(torch.device("cuda", 0), record)
        return record["sp30"], LOG_LINES
    except Exception as e:
        raise RuntimeError("phase 10 (sp30) failed:\n" + "\n".join(LOG_LINES)) from e
    finally:
        LOG_LINES = None


def solve_config4(dev, record):
    """Phase 11: BASELINE config 4, polymin_simplex on the 2-simplex
    quadratic of tests/test_polymin.py (minimum -3/4) at k=2, counters
    reset: K1, K2 and K3 must launch."""
    from clrs_tpu_torch import polymin_simplex
    from clrs_tpu_torch.models.poly import MPoly

    x, y = MPoly.gens(2)
    f = x * x + y * y - x * y - x - y
    reset_counters()
    t0 = time.time()
    bound_, res = polymin_simplex(f, 2, d=1, device=dev, precision_k=2)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counters()
    log(f"config4: bound {bound_!r} status {res.status} iterations {res.iterations} wall "
        f"{wall:.3f} s; launches {launches}")
    record["config4"] = dict(bound=bound_, status=res.status, iterations=res.iterations,
                             wall_s=wall, launches=launches)
    for name in ("spd_inverse_dd", "schur_pairs", "matmul_dd"):
        assert launches[name] > 0, f"{name} never launched during the config-4 solve"
    assert abs(bound_ + 0.75) < 1e-6, f"config4 bound {bound_!r}"
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the device-resident loop
# ---------------------------------------------------------------------------

DL_CHUNK = 25  # solve_on_device's default chunk
SYNC_CHUNK, SYNC_ITERATIONS = 5, 10  # the sync checks: chunks after the first are watched
PROFILE_CHUNK = 2  # the profiled chunk: iterations 3-4
DL_LADDER_FROM = 4  # (e) climbs the rungs above phase 9's k=4 rung, from its result
DL_LADDER = (6, 10)


class LoopWatch:
    """While on, counts the device loop's launched iterations
    (DeviceSolve.body calls) and its chunks, and runs around(n), a context
    manager, around the launches of chunk n (1-based; the chunk's one read
    comes after, outside it)."""

    def __init__(self, around=None):
        from clrs_tpu_torch.core.device_loop import DeviceSolve

        self.cls, self.around = DeviceSolve, around
        self.body, self.run_chunk = DeviceSolve.body, DeviceSolve.run_chunk
        self.launched = self.chunks = 0

    def __enter__(self):
        watch = self

        def body(loop, *args):
            watch.launched += 1
            return watch.body(loop, *args)

        def run_chunk(loop, *args):
            watch.chunks += 1
            with (watch.around(watch.chunks) if watch.around else contextlib.nullcontext()):
                return watch.run_chunk(loop, *args)

        self.cls.body, self.cls.run_chunk = body, run_chunk
        return self

    def __exit__(self, *exc):
        self.cls.body, self.cls.run_chunk = self.body, self.run_chunk


def dl_config1(dev, k, route, chunk, around=None, **options):
    """Config 1 (Delsarte dim 8, 2d=10) at k limbs through solve_on_device on
    the card, counters reset first: (result, measures)."""
    from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints
    from clrs_tpu_torch.core.device_loop import solve_on_device
    from clrs_tpu_torch.core.problem import pack_constraints

    cons, b, info = build_delsarte_constraints(8, 5)
    problem = pack_constraints(cons, b, info=info, k=k, device=dev)
    reset_counters()
    with LoopWatch(around) as watch:
        t0 = time.time()
        res = solve_on_device(problem, chunk=chunk, **route, **dict(SOLVE, **options))
        torch.cuda.synchronize()
        wall = time.time() - t0
    return res, dict(bound=1.0 - res.dual_objective, wall_s=wall, launches=read_counters(),
                     launched=watch.launched, chunks=watch.chunks)


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


def rows_equal(a, b):
    """Two histories equal row for row, bit for bit (all but the time)."""
    return len(a) == len(b) and all(
        set(ra) == set(rb) and all(bits_equal(f64(ra[key]), f64(rb[key]))
                                   for key in ra if key != "time")
        for ra, rb in zip(a, b))


def result_leaves(res):
    return [res.x.limbs, res.y.limbs] + [t.limbs for row in res.X + res.Y for t in row]


def rate(history, first, last=None):
    """it/s over iterations first+1..last (default: the last row's), from
    the rows' time stamps (each taken after its iteration's host read)."""
    by_iter = {int(r["iter"]): r["time"] for r in history}
    last = last or max(by_iter)
    return (last - first) / max(by_iter[last] - by_iter[first], 1e-12)


def best_row(history):
    """The phase driver's best iterate: the first row of least merit."""
    merits = [max(abs(r["gap"]), r["P_err"], r["p_err"], r["d_err"]) for r in history]
    return merits.index(min(merits))


@contextlib.contextmanager
def sync_mode(mode, caught=None):
    """torch.cuda.set_sync_debug_mode(mode) inside; under "warn" every
    synchronizing call's warning is kept in caught."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if caught is not None:
        caught.extend(w for w in seen if "synchronizing" in str(w.message))


def profile_chunk(dev, record):
    """torch.profiler over one chunk of the device loop (iterations 3-4 of
    config 1 at k=3 on the all-kernels route), from its first launch to the
    device's end: the device's busy time per iteration and its share of the
    chunk's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    @contextlib.contextmanager
    def around(n):
        if n != 2:
            yield
            return
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        try:
            yield
            torch.cuda.synchronize()
        finally:
            window["wall_s"] = time.perf_counter() - t0
            prof.stop()

    dl_config1(dev, 3, ALL_KERNELS_ROUTE, PROFILE_CHUNK, around,
               maxiterations=2 * PROFILE_CHUNK)
    assert "wall_s" in window, "the device-loop profile window did not close"
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return dict(iterations=PROFILE_CHUNK, wall_ms_per_iter=1e3 * window["wall_s"] / PROFILE_CHUNK,
                device_busy_ms_per_iter=busy_us / 1e3 / PROFILE_CHUNK,
                busy_share=busy_us / 1e6 / window["wall_s"])


def climb_device_loop(dev, cons, b, info, ladder, start):
    """solve_with_escalation(driver="device_loop", k_ladder=ladder) on the
    card on the all-kernels route, its first rung warm-started from start
    (a rung's SolveResult, through a checkpoint file saved and loaded at the
    first rung's k), each rung's counters reset before it and read after,
    its warm start held bitwise against the last result re-rounded."""
    from clrs_tpu_torch import load_state, save_state
    from clrs_tpu_torch.core import escalate

    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "sp16_device_loop_start.npz")
    save_state(path, (start.x, start.y, start.X, start.Y), info)
    warm, _ = load_state(path, info, k=ladder[0], device=dev)
    rungs = []
    solve_fn = escalate.solve_on_device

    def rung(problem, initial_solutions=(), **kwargs):
        k = problem.b.k
        if not rungs:  # solve_with_escalation starts cold; this ladder starts warm
            initial_solutions = warm
        got = [t.limbs for t in initial_solutions[:2]] + [
            t.limbs for row in initial_solutions[2] + initial_solutions[3] for t in row]
        want = reround_leaves(rungs[-1]["res"] if rungs else start, k)
        assert len(got) == len(want) and all(map(bits_equal, got, want)), \
            f"sp16 device loop k={k}: the warm start is not the last result"
        reset_counters()
        t0 = time.time()
        res = solve_fn(problem, initial_solutions=initial_solutions, **kwargs)
        torch.cuda.synchronize()
        rungs.append(dict(k=k, res=res, wall_s=time.time() - t0, launches=read_counters()))
        expect = RUNG_KERNELS[min(k, 3)]
        for name, n in rungs[-1]["launches"].items():
            assert (n > 0) == (name in expect), f"sp16 device loop k={k}: {name} launched {n} times"
        return res

    escalate.solve_on_device = rung
    try:
        res = escalate.solve_with_escalation(cons, b, info, device=dev, verbose=False,
                                             driver="device_loop", k_ladder=ladder,
                                             **ALL_KERNELS_ROUTE, **LADDER_SOLVE)
    finally:
        escalate.solve_on_device = solve_fn
    return res, rungs


def device_loop_phase(dev, record, phase7, phase7_launches, phase4, sp16_rungs):
    """Phase 13: config 1 and the sp16 ladder through the device loop,
    held against the phase driver's solves of phases 4, 7 and 9."""
    out = record["device_loop"] = {}
    sync = out["sync"] = {}
    t0 = time.time()

    def watched(mode):  # every chunk after the first under mode
        return lambda n: sync_mode(mode) if n > 1 else contextlib.nullcontext()

    def timed(part):
        log(f"device loop: ({part}) done {time.time() - t0:.1f} s into the phase")

    # (a) config 1 at k=3, all-kernels route: chunk=1 row for row, then
    # chunk=25 bitwise chunk=1's result, its second chunk launched under
    # set_sync_debug_mode("error") (part of (c))
    res1, m1 = dl_config1(dev, 3, ALL_KERNELS_ROUTE, 1)
    same_rows = rows_equal(res1.history, phase7.history)
    log(f"device loop config1 k=3 all-kernels chunk=1: status {res1.status} iterations "
        f"{res1.iterations} bound {m1['bound']!r}; rows bitwise phase 7's: {same_rows}; "
        f"launches {m1['launches']}")
    assert same_rows, "device loop chunk=1: a row differs from the phase driver's"
    assert (res1.status, res1.iterations) == (phase7.status, phase7.iterations)
    assert bits_equal(f64(res1.dual_objective), f64(phase7.dual_objective))
    assert m1["launches"] == phase7_launches, (m1["launches"], phase7_launches)
    assert m1["launched"] == res1.iterations
    res25, m25 = dl_config1(dev, 3, ALL_KERNELS_ROUTE, DL_CHUNK, watched("error"))
    sync["all_k3"] = dict(iterations_watched=res25.iterations - DL_CHUNK, syncs=0)
    log(f"device loop sync check, all-kernels k=3: iterations {DL_CHUNK + 1}-"
        f"{res25.iterations} launched under set_sync_debug_mode('error'): no synchronizing call")
    same_state = all(map(bits_equal, result_leaves(res25), result_leaves(res1)))
    wasted = m25["launched"] - res25.iterations
    log(f"device loop config1 k=3 all-kernels chunk={DL_CHUNK}: status {res25.status} "
        f"iterations {res25.iterations} in {m25['chunks']} chunks, {m25['launched']} launched "
        f"({wasted} after the end); final state bitwise chunk=1's: {same_state}")
    assert same_state and (res25.status, res25.iterations) == (res1.status, res1.iterations)
    per_iter = {}
    for name, n in m1["launches"].items():
        assert n % res1.iterations == 0, f"{name}: {n} launches over {res1.iterations} iterations"
        per_iter[name] = n // res1.iterations
        assert m25["launches"][name] == per_iter[name] * m25["launched"], (name, m25["launches"])
    log(f"device loop: launches per iteration (phase driver and device loop alike): {per_iter}")
    out["config1_k3_all"] = dict(status=res1.status, iterations=res1.iterations,
                                 bound=m1["bound"], rows_bitwise_phase7=same_rows,
                                 chunk25_state_bitwise=same_state, launched_chunk25=m25["launched"],
                                 wasted_after_end_chunk25=wasted, launches_per_iter=per_iter)
    timed("a")

    # (d) both drivers' it/s and wall, config 1 k=3 all-kernels, this call
    drivers = {"phase driver (phase 7)": phase7.history, "device loop chunk=1": res1.history,
               f"device loop chunk={DL_CHUNK}": res25.history}
    speed = out["speed"] = {}
    for name, hist in drivers.items():
        s = speed[name] = dict(wall_s=hist[-1]["time"], iterations=int(hist[-1]["iter"]),
                               it_s_after_25=rate(hist, DL_CHUNK))
        if len(hist) > 2:
            s["steady_it_s"] = rate(hist, 2)
        log(f"device loop speed, {name}: wall {s['wall_s']:.4f} s for {s['iterations']} "
            f"iterations; steady (iterations 3-) "
            + (f"{s['steady_it_s']:.4f} it/s ({1e3 / s['steady_it_s']:.2f} ms/iter)"
               if "steady_it_s" in s else "not measured (one row a chunk)")
            + f"; iterations {DL_CHUNK + 1}- {s['it_s_after_25']:.4f} it/s "
              f"({1e3 / s['it_s_after_25']:.2f} ms/iter)")
    prof = out["profile"] = profile_chunk(dev, record)
    unprofiled = prof["device_busy_ms_per_iter"] * speed[f"device loop chunk={DL_CHUNK}"][
        "it_s_after_25"] / 1e3
    prof["busy_share_of_unprofiled_iteration"] = unprofiled
    log(f"device loop profile (chunk of iterations 3-4): wall {prof['wall_ms_per_iter']:.2f} "
        f"ms/iter under the profiler, device busy {prof['device_busy_ms_per_iter']:.3f} ms/iter: "
        f"busy share {prof['busy_share']:.4f} of the profiled chunk, {unprofiled:.4f} of the "
        f"unprofiled chunk=25 iteration")
    timed("d")

    # (c) no synchronizing call inside a chunk on the all-kernels route at
    # k=2 (k=3 in (a)); the default route's counted in (b)
    res, m = dl_config1(dev, 2, ALL_KERNELS_ROUTE, SYNC_CHUNK, watched("error"),
                        maxiterations=SYNC_ITERATIONS)
    sync["all_k2"] = dict(iterations_watched=res.iterations - SYNC_CHUNK, syncs=0)
    log(f"device loop sync check, all-kernels k=2: iterations {SYNC_CHUNK + 1}-"
        f"{res.iterations} launched under set_sync_debug_mode('error'): no synchronizing call")
    assert res.iterations == SYNC_ITERATIONS
    timed("c")

    # (b) config 1 at k=2, default route (K1, K2, K3), chunk=25, against
    # phase 4; every chunk after the first under set_sync_debug_mode("warn"),
    # each synchronizing call kept with its source
    caught = []
    r2, m2 = dl_config1(dev, 2, {}, DL_CHUNK,
                        lambda n: sync_mode("warn", caught) if n > 1 else contextlib.nullcontext())
    if phase4.status == "stalled":
        # the reference's device loop keeps the post-update state of the best
        # iteration, the phase driver the state entering it
        want = 1.0 - phase4.history[best_row(phase4.history)]["d_obj"]
    else:
        want = 1.0 - phase4.dual_objective
    log(f"device loop config1 k=2 default chunk={DL_CHUNK}: status {r2.status} iterations "
        f"{r2.iterations} bound {m2['bound']!r}, wall {m2['wall_s']:.3f} s (phase 4: "
        f"{phase4.status} {phase4.iterations} {1.0 - phase4.dual_objective!r}; its best row's "
        f"post-update bound {want!r}); launches {m2['launches']}")
    assert (r2.status, r2.iterations) == (phase4.status, phase4.iterations)
    assert m2["bound"] == want, (m2["bound"], want)
    for name in ("spd_inverse_dd", "schur_pairs", "matmul_dd"):
        assert m2["launches"][name] > 0, f"{name} never launched in the device loop at k=2"
    out["config1_k2_default"] = dict(
        status=r2.status, iterations=r2.iterations, bound=m2["bound"],
        phase4_bound=1.0 - phase4.dual_objective, launches=m2["launches"], wall_s=m2["wall_s"])
    watched_iters = r2.iterations - DL_CHUNK
    sources = {}
    for w in caught:
        where = f"{os.path.relpath(w.filename)}:{w.lineno}"
        sources[where] = sources.get(where, 0) + 1
    sync["default_k2"] = dict(iterations_watched=watched_iters,
                              syncs_per_iter=len(caught) / watched_iters,
                              sources={src: n / watched_iters for src, n in sources.items()})
    log(f"device loop sync count, default route k=2: {len(caught) / watched_iters:.2f} "
        f"synchronizing calls per iteration over iterations {DL_CHUNK + 1}-{r2.iterations}; "
        f"by source (per iteration): {sync['default_k2']['sources']}")
    timed("b")

    # (e) the sp16 ladder through driver="device_loop", from phase 9's k=4
    # rung's result
    start = next(r["res"] for r in sp16_rungs if r["k"] == DL_LADDER_FROM)
    old = mpmath.mp.prec
    try:
        cons, b, info = sphere_problem(8)  # mpmath at SP_PREC for every rung's packing
        t1 = time.time()
        res, rungs = climb_device_loop(dev, cons, b, info, DL_LADDER, start)
        wall = time.time() - t1
    finally:
        mpmath.mp.prec = old
    phase9 = {p["k"]: p for p in sp16_rungs}
    for r in rungs:
        p = phase9.get(r["k"])
        log(f"sp16 device-loop ladder rung k={r['k']}: {r['res'].status} {r['res'].iterations} "
            f"iterations, wall {r['wall_s']:.3f} s, launches {r['launches']}"
            + (f" (phase 9: {p['res'].status} {p['res'].iterations} iterations, "
               f"{p['wall_s']:.3f} s)" if p else " (phase 9 had no such rung)"))
    log(f"sp16 device-loop ladder from phase 9's k={DL_LADDER_FROM} rung: wall {wall:.3f} s "
        f"(phase 9's rungs above it: "
        f"{sum(p['wall_s'] for k, p in phase9.items() if k > DL_LADDER_FROM):.3f} s)")
    bound_ = check_contract("sp16 device-loop ladder", res, SP16_BOUND)
    out["sp16_ladder"] = dict(
        bound=bound_, status=res.status, wall_s=wall, started_from_k=DL_LADDER_FROM,
        rungs=[dict(k=r["k"], status=r["res"].status, iterations=r["res"].iterations,
                    wall_s=r["wall_s"], launches=r["launches"]) for r in rungs])
    timed("e")


# ---------------------------------------------------------------------------
# Phase 14: K5's panel route and sp86
# ---------------------------------------------------------------------------

# sp86: the two-species packing at 2d = 86, the smallest degree of the
# example whose S_j (261 rows) and Q (262) both pass the single launch's
# 256 rows at k >= 3; built at the precision k=3 needs, in every process
SP86_D = 43
SP86_PREC = 53 * 3 + 150
# iterations on the card, on the all-kernels route only, cut from 10 to
# fit the script's time: at k=3 a Schur Cholesky of sp86 fails at the
# first iteration and the solver takes S_j and Q by LU from then on, ~4 s
# an iteration on the all-kernels route (through K8) and ~2.5 min on the
# default route (eager arithmetic; PERF.md section 6), which the
# script's 1200 s cannot hold; and the first iteration held against a
# CPU worker on the same route (~2 min an iteration there): from iteration
# 2 the card and the CPU part by ~0.05, by their float64 step lengths
# alone (the Jacobi bound's float64 products differ in their last bits
# between the two; given the card's step lengths the CPU follows the card
# bit for bit for 3 iterations: scripts/sp86_step_witness.py)
SP86_ITERATIONS = 3
SP86_PARITY = 1
SP86_WORKERS = 2  # a pool of its own: the packing, then the CPU run and the LU at once
# the panel route's rows (label, k, n): sp86's S_j and Q at k=3, its S_j at
# k = 6 and 10, then 257 and 512 rows at k=3; their plain versions run in
# the CPU workers (one thread each on the H100 machine: 12 s at 261 rows
# and k=3, 72 s at 512, ~105 s at k=6 and ~435 s at k=10; Q at k = 6, 10
# and 1024 rows, ~500 s, would not fit the script's time, so 1024 rows
# are timed against their bound and held to float64 LAPACK only)
PANEL_SHAPES = (("S_j 1x261x261", 3, 261), ("Q 1x262x262", 3, 262), ("S_j 1x261x261", 6, 261),
                ("S_j 1x261x261", 10, 261), ("1x257x257", 3, 257), ("1x512x512", 3, 512))
PANEL_UNCHECKED = (("1x1024x1024", 3, 1024),)
PANEL_NAME = "spd_panel_xf (K5 above 256 rows)"
SP86_KERNELS = ("schur_pairs", "matmul_xf", "spd_inverse_xf", "steplen_xf", "elemwise_xf",
                "spd_panel_xf")


def sp86_problem():
    """(constraints, b, blockinfo) of sp86 at SP86_PREC bits; mpmath's
    precision is left there, for the packing (the caller restores it)."""
    from clrs_tpu_torch import nsphere_packing_2point

    mpmath.mp.prec = SP86_PREC
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    return nsphere_packing_2point(3, SP86_D, r, 2, prec=SP86_PREC, build_only=True)


def sp86_pack_data():
    """sp86's front-end and the mpmath preconditioning of its packing
    (core/problem.prepare_pack_data: QRs of its bases and of B, minutes of
    one core), done once in a worker for every process that packs it."""
    from clrs_tpu_torch.core.problem import prepare_pack_data

    torch.set_num_threads(1)
    t0 = time.time()
    cons, b, info = sp86_problem()
    t1 = time.time()
    data = prepare_pack_data(cons, b, info=info)
    return dict(data=data, front_end_s=t1 - t0, prepare_s=time.time() - t1)


def sp86_packed(data, device):
    """sp86 packed at k=3 on device from sp86_pack_data's data (mpmath's
    precision raised for the rounding, then restored)."""
    from clrs_tpu_torch.core.problem import _pack_from_data

    old = mpmath.mp.prec
    mpmath.mp.prec = SP86_PREC
    try:
        return _pack_from_data(data, 3, device)
    finally:
        mpmath.mp.prec = old


def cpu_sp86(data):
    """sp86's first SP86_PARITY iterations at k=3 on the CPU, on the
    all-kernels route's plain versions; run in a worker process."""
    from clrs_tpu_torch import solverank1sdp

    torch.set_num_threads(2)
    t0 = time.time()
    res = solverank1sdp(problem=sp86_packed(data, "cpu"), verbose=False, use_cuda_matmul=True,
                        **ALL_KERNELS_ROUTE, **dict(LADDER_SOLVE, maxiterations=SP86_PARITY))
    return dict(history=res.history, wall_s=time.time() - t0)


def cpu_sp86_lu(data):
    """sp86's largest S_j (261 rows) at the cold start, k=3, and its
    xf_inverse_lu on the CPU port; run in a worker process."""
    from clrs_tpu_torch.core.solver import (SolverConfig, compute_decomposition,
                                            compute_X_inv, initial_state)
    from clrs_tpu_torch.ops.linalg import xf_inverse_lu

    torch.set_num_threads(2)
    problem = sp86_packed(data, "cpu")
    info = problem.info
    _, _, X, Y = initial_state(problem, SolverConfig(**LADDER_SOLVE))
    X_inv, _ = compute_X_inv(X, info, False)
    j = max(range(info.J), key=lambda i: info.dim_S[i])
    S = compute_decomposition(problem, X_inv, Y, False)["S_mat"][j]
    t0 = time.time()
    inv, ok = xf_inverse_lu(S)
    return dict(S=S.limbs.numpy(), inv=inv.limbs.numpy(), ok=bool(ok), s=time.time() - t0)


def panel_inputs(k, n):
    """A panel row's input, on the CPU, the same in every process: one SPD
    block (1, k, n, n) of condition 1e6."""
    return spd_batch(np.random.default_rng([4000, k, n]), 1, n, k, 1e6, "cpu")


def panel_plain(k, n):
    """The panel route's plain version on panel_inputs(k, n), in a CPU
    worker: outputs and seconds."""
    torch.set_num_threads(1)
    from clrs_tpu_torch.ops import cuda_xf

    a = panel_inputs(k, n)
    t0 = time.time()
    out = cuda_xf.spd_inverse_xf_torch(a)
    return dict(out=tuple(x.numpy() for x in out), s=time.time() - t0)


def check_panel_route(dev, record, rows, plain):
    """Phase 14 (a): the panel route bitwise against its plain version
    (computed in the CPU workers) at PANEL_SHAPES, its launches per call,
    one check against float64 LAPACK, one call under torch.profiler (no
    library product or factorization on its path), and the single launch
    beside the panel route at n = 256, where both take the matrix."""
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    case = make_case(rows)
    out = record["panel_route"] = dict(panel=cuda_xf.SPD_PANEL, rows={})
    for label, k, n in PANEL_SHAPES:
        a = panel_inputs(k, n).to(dev)
        res = plain[(k, n)]
        want = tuple(torch.from_numpy(x).to(dev) for x in res["out"])
        reset_counters()
        cuda_xf.spd_inverse_xf(a)
        torch.cuda.synchronize()
        per_call = {name: v for name, v in read_counters().items() if v}
        row = case(PANEL_NAME, k, label, cuda_xf.spd_inverse_xf, lambda *_: want, (a,),
                   spd_inverse_function_work(k, 1, n), 3, 0, label.startswith("S_j"),
                   plain_ms=1e3 * res["s"])
        row.update(plain_device="cpu", launches_per_call=per_call)
        assert per_call.get("spd_panel_xf") == -(-n // cuda_xf.SPD_PANEL), per_call
        assert set(per_call) == {"spd_panel_xf", "matmul_xf", "elemwise_xf"}, per_call
        log(f"panel route k={k} {label}: launches per call {per_call}")
        out["rows"][label + f" k={k}"] = row
        if (k, n) == (3, 261):
            got = want[0][0, 0].cpu().numpy()
            lapack = np.linalg.inv(a[0, 0].cpu().numpy())
            rel = float(np.max(np.abs(got - lapack)) / np.max(np.abs(lapack)))
            log(f"panel route k=3 {label}: limb 0 against float64 LAPACK {rel:.3e} relative")
            assert rel < 1e-8, rel
            out["lapack_rel_diff"] = rel
    # the panel route's call path in a profile: this repo's kernels, fills
    # and copies, and no library product or factorization
    from torch.profiler import ProfilerActivity, profile

    a = panel_inputs(3, 261).to(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_xf.spd_inverse_xf(a)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    library = [name for name in names if re.search(
        r"gemm|cublas|cusolver|magma|xmma|potrf|trsm|getrf|aten::(mm|bmm|matmul|addmm|baddbmm|"
        r"linalg|cholesky|triangular|inverse)", name, re.IGNORECASE)]
    ours = sorted({kernel for kernel in ("spd_panel_xf_kernel", "matmul_xf_kernel",
                                         "elemwise_xf_kernel")
                   if any(kernel in name for name in names)})
    log(f"panel route k=3 S_j 1x261x261 profile: {len(names)} op and kernel names; this "
        f"repo's kernels {ours}; library products or factorizations {library}")
    assert not library and len(ours) == 3, (library, ours)
    out["profile_names"] = names
    for label, k, n in PANEL_UNCHECKED:
        a = panel_inputs(k, n).to(dev)
        reset_counters()
        inv, ok = cuda_xf.spd_inverse_xf(a)
        torch.cuda.synchronize()
        per_call = {name: v for name, v in read_counters().items() if v}
        lapack = np.linalg.inv(a[0, 0].cpu().numpy())
        rel = float(np.max(np.abs(inv[0, 0].cpu().numpy() - lapack)) / np.max(np.abs(lapack)))
        ms = median_ms(lambda: cuda_xf.spd_inverse_xf(a), 3)
        ms_many = many_ms(lambda: cuda_xf.spd_inverse_xf(a), 5)
        bound_ms, bound_by = bound(*spd_inverse_function_work(k, 1, n))
        log(f"kernel {PANEL_NAME} k={k} {label}: no plain version (its CPU time would not fit); "
            f"limb 0 against float64 LAPACK {rel:.3e} relative; kernel {ms:.4f} ms (many "
            f"{ms_many:.4f}) bound {bound_ms:.6f} ms ({bound_by}); launches per call {per_call}")
        assert bool(ok.all()) and rel < 1e-8, rel
        out["rows"][label + f" k={k}"] = dict(ms=ms, ms_many=ms_many, bound_ms=bound_ms,
                                              bound_by=bound_by, lapack_rel_diff=rel,
                                              launches_per_call=per_call)
    # n = 256: the single launch's last size, and the panel route's on the
    # same input (max_rows lowered for the call)
    a = panel_inputs(3, 256).to(dev)
    single_ms = median_ms(lambda: cuda_xf.spd_inverse_xf(a), 3)
    single, _ = cuda_xf.spd_inverse_xf(a)
    max_rows = cuda_dd.max_rows
    cuda_dd.max_rows = lambda k: 255
    try:
        panel_ms = median_ms(lambda: cuda_xf.spd_inverse_xf(a), 3)
        panel, ok = cuda_xf.spd_inverse_xf(a)
    finally:
        cuda_dd.max_rows = max_rows
    diff = float(torch.max(torch.abs(torch.sum(panel.double() - single.double(), dim=1))))
    rel = diff / float(torch.max(torch.abs(single[:, 0])))
    log(f"K5 at n=256, k=3: single launch {single_ms:.3f} ms, panel route {panel_ms:.3f} ms "
        f"({single_ms / panel_ms:.1f}x); the two agree to {rel:.3e} relative")
    assert bool(ok.all()) and rel < 1e-30, rel
    out["n256_k3"] = dict(single_ms=single_ms, panel_ms=panel_ms, rel_diff=rel)


def solve_sp86(dev, record, packed, cpu_future):
    """Phase 14 (b): sp86 at k=3 on the all-kernels route for
    SP86_ITERATIONS, counters reset: its kernels (the panel route's among
    them) and no other must launch, and the first SP86_PARITY iterations
    must follow a CPU worker on the same route to 1e-10 (cpu_future, read
    once the card is done).  Returns the launches."""
    from clrs_tpu_torch import solverank1sdp

    t0 = time.time()
    problem = sp86_packed(packed["data"], dev)
    pack_s = time.time() - t0
    info = problem.info
    log(f"sp86: front-end {packed['front_end_s']:.3f} s and packing's preconditioning "
        f"{packed['prepare_s']:.3f} s (in a worker), packing {pack_s:.3f} s; m {info.m}, "
        f"blocks {info.Y_blocksizes}, dim_S {info.dim_S}, n_y {info.n_y}")
    reset_counters()
    t0 = time.time()
    res = solverank1sdp(problem=problem, verbose=False, **ALL_KERNELS_ROUTE,
                        **dict(LADDER_SOLVE, maxiterations=SP86_ITERATIONS))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counters()
    phases = per_phase_ms(res)
    cpu = cpu_future.get()
    rel = [max(abs(rg[key] - rc[key]) / max(abs(rc[key]), 1e-300)
               for key in ("p_obj", "d_obj", "gap"))
           for rg, rc in zip(res.history, cpu["history"])]
    log(f"sp86 k=3 all-kernels route: status {res.status} iterations {res.iterations} wall "
        f"{wall:.3f} s; launches per iteration " + ", ".join(
            f"{n}={v / max(res.iterations, 1):.2f}" for n, v in launches.items()))
    log("sp86 k=3 all-kernels route: ms/iter by phase: " + ", ".join(
        f"{p}={v:.2f}" for p, v in phases.items()))
    for row in res.history:
        log(f"sp86 k=3 all-kernels route: iteration {row['iter']} p_obj {row['p_obj']!r} "
            f"d_obj {row['d_obj']!r} gap {row['gap']:.3e} P/p/d errors "
            f"{row['P_err']:.3e}/{row['p_err']:.3e}/{row['d_err']:.3e}")
    log(f"sp86 k=3 all-kernels route: relative history difference gpu vs cpu over the first "
        f"{len(rel)} iterations {max(rel, default=0.0)!r} (cpu {cpu['wall_s']:.3f} s)")
    record["sp86"] = dict(front_end_s=packed["front_end_s"], prepare_s=packed["prepare_s"],
                          pack_s=pack_s, dim_S=list(info.dim_S), n_y=info.n_y,
                          status=res.status, iterations=res.iterations, wall_s=wall,
                          launches=launches, phase_ms_per_iter=phases, cpu_rel_diff=rel,
                          cpu_wall_s=cpu["wall_s"], history=res.history)
    assert res.iterations == SP86_ITERATIONS, res.iterations
    assert len(rel) == SP86_PARITY and max(rel) <= 1e-10, rel
    assert all(np.isfinite(r[key]) for r in res.history for key in ("p_obj", "d_obj", "gap"))
    for name, n in launches.items():
        assert (n > 0) == (name in SP86_KERNELS), f"sp86: {name} launched {n} times"
    return launches


def check_sp86_lu(dev, record, cpu):
    """Phase 14 (c): xf_inverse_lu of sp86's largest S_j at the cold start
    (k=3, 261 rows: the LU solves take the panel trisolves) on the card,
    against the CPU port's."""
    from clrs_tpu_torch.ops.linalg import xf_inverse_lu
    from clrs_tpu_torch.ops.xfloat import XF

    S = torch.from_numpy(cpu["S"]).to(dev)
    t0 = time.time()
    inv, ok = xf_inverse_lu(XF(S))
    torch.cuda.synchronize()
    wall = time.time() - t0
    want = torch.from_numpy(cpu["inv"]).to(dev)
    same = bits_equal(inv.limbs, want)
    rel = float(torch.max(torch.abs(torch.sum(inv.limbs - want, dim=0)))
                / torch.max(torch.abs(want[0])))
    log(f"sp86 S_j {tuple(S.shape[1:])} xf_inverse_lu k=3: card {wall:.3f} s, cpu {cpu['s']:.3f} s; "
        f"bitwise the cpu's: {same}; {rel:.3e} relative")
    record["sp86_lu"] = dict(card_s=wall, cpu_s=cpu["s"], bitwise=same, rel_diff=rel)
    assert bool(ok) and cpu["ok"]
    assert same or rel <= 2.0 ** (10 - 53 * 3), rel


# ---------------------------------------------------------------------------
# Phase 15: the cluster-sharded solve (parallel/hetero.py)
# ---------------------------------------------------------------------------

SHARDED_STEPS = 3  # (c)'s steps on two ranks
SP16_WINDOW = 10  # (b)'s iterations of sp16's k=3 rung
SHARDED_KERNELS = ("schur_pairs", "matmul_xf", "spd_inverse_xf", "steplen_xf", "elemwise_xf")


def hetero_config1(device):
    """solve_hetero_sharded of config 1 at k=3 on the all-kernels route
    (on the CPU its plain versions), one rank."""
    from clrs_tpu_torch.core.solver import SolverConfig
    from clrs_tpu_torch.parallel.hetero import solve_hetero_sharded
    from clrs_tpu_torch.tools.mp_hetero_worker import delsarte_problem

    cfg = SolverConfig(use_cuda_matmul=True, **ALL_KERNELS_ROUTE, **SOLVE)
    return solve_hetero_sharded(delsarte_problem(5, 3, device), cfg=cfg,
                                maxiterations=cfg.maxiterations)


def cpu_hetero_config1():
    """Phase 15 (a)'s CPU run; in a worker process while the card works."""
    torch.set_num_threads(2)
    t0 = time.time()
    res = hetero_config1("cpu")
    return dict(history=res.history, status=res.status, iterations=res.iterations,
                bound=1.0 - res.dual_objective, wall_s=time.time() - t0)


def sharded_phase(dev, record, phase7, cpu_future):
    """Phase 15: (a) config 1 at k=3 through solve_hetero_sharded on one
    rank on the card, all-kernels route: `optimal` at 240 to 1e-12, phase
    7's status, iterations within 2 and bound to 1e-12, its rows against the
    CPU's run to 1e-10 over the whole history (as phase 7's), and K2, K4, K5, K7 and
    K8 launched; (b) sp16's k=3 rung for SP16_WINDOW iterations through the
    hetero step against the phase driver's on the same packed problem, to
    the same tolerances; (c) two ranks on the one card (gloo carrying the
    CUDA tensors; NCCL takes one rank a card) for SHARDED_STEPS steps of
    config 1 at k=3, every iterate and diagnostic bitwise the one-rank
    steps, which are (a)'s first rows bit for bit."""
    import shutil
    import socket
    import tempfile

    from clrs_tpu_torch.core.problem import pack_constraints
    from clrs_tpu_torch.core.solver import SolverConfig, solverank1sdp
    from clrs_tpu_torch.parallel.hetero import solve_hetero_sharded
    from clrs_tpu_torch.tools import mp_hetero_worker as worker

    t_phase = time.time()
    out = record["sharded"] = {}
    # (c)'s ranks start first: each takes ~8 s to reach the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "clrs_tpu_torch.tools.mp_hetero_worker", str(r), "2", str(port),
         os.path.join(tmp, f"r{r}.npz"), "--device", "cuda", "--backend", "gloo",
         "--what", "hetero", "--d", "5", "--k", "3", "--steps", str(SHARDED_STEPS),
         "--all-kernels"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(2)]
    try:
        # (a)
        reset_counters()
        t0 = time.time()
        res = hetero_config1(dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counters()
        bound_ = 1.0 - res.dual_objective
        bound7 = 1.0 - phase7.dual_objective
        cpu = cpu_future.get()
        worst, held = held_rows(res.history, cpu["history"])
        log(f"sharded (a) config1 k=3 all-kernels, one rank: bound {bound_!r} status "
            f"{res.status} iterations {res.iterations} wall {wall:.3f} s; phase 7: "
            f"{bound7!r} {phase7.status} {phase7.iterations}; cpu: {cpu['bound']!r} "
            f"{cpu['status']} {cpu['iterations']} ({cpu['wall_s']:.1f} s), rows held "
            f"{worst!r} over {held}; launches {launches}")
        out["a"] = dict(bound=bound_, status=res.status, iterations=res.iterations, wall_s=wall,
                        launches=launches, cpu_rel_diff=worst, cpu_held=held,
                        cpu_wall_s=cpu["wall_s"], history=res.history)
        assert res.status == "optimal" == phase7.status, (res.status, phase7.status)
        assert abs(bound_ - 240.0) < 1e-12 and abs(bound_ - bound7) < 1e-12, bound_
        assert abs(res.iterations - phase7.iterations) <= 2, res.iterations
        assert held == min(res.iterations, cpu["iterations"]) and worst <= 1e-10, \
            f"sharded (a): gpu and cpu differ by {worst!r}"
        for name, n in launches.items():
            assert (n > 0) == (name in SHARDED_KERNELS), f"sharded (a): {name} launched {n}"

        # (b)
        old = mpmath.mp.prec
        try:
            cons, b, info = sphere_problem(8)
            problem = pack_constraints(cons, b, info=info, k=3, device=dev)
        finally:
            mpmath.mp.prec = old
        opts = dict(LADDER_SOLVE, maxiterations=SP16_WINDOW, verbose=False, **ALL_KERNELS_ROUTE)
        t0 = time.time()
        hres = solve_hetero_sharded(problem, cfg=SolverConfig(**opts), maxiterations=SP16_WINDOW)
        torch.cuda.synchronize()
        t1 = time.time()
        dres = solverank1sdp(problem=problem, **opts)
        t2 = time.time()
        worst, held = held_rows(hres.history, dres.history)
        log(f"sharded (b) sp16 k=3, {SP16_WINDOW} iterations: hetero {t1 - t0:.3f} s, phase "
            f"driver {t2 - t1:.3f} s; rows held {worst!r} over {held}")
        out["b"] = dict(hetero_s=t1 - t0, driver_s=t2 - t1, rel_diff=worst, held=held,
                        history=hres.history)
        assert len(hres.history) == len(dres.history) == SP16_WINDOW
        assert held == SP16_WINDOW and worst <= 1e-10, f"sharded (b): differ by {worst!r}"

        # (c): the one-rank steps here, then the two ranks' output
        one = {}
        worker.run_hetero(5, 3, SHARDED_STEPS, dev, None, one, True)
        for i in range(SHARDED_STEPS):
            row = res.history[i]
            for key in ("mu", "p_obj", "d_obj", "gap", "alpha_p", "alpha_d"):
                assert float(one[f"hetero/{i}/diag/{key}"]) == row[key], (i, key)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        log(f"sharded (c): two gloo ranks with CUDA tensors on one card FAILED (ranks {failed}): "
            + logs[failed[0]][-2000:].replace("\n", " | "))
        raise AssertionError("sharded (c): the two gloo ranks failed on the card")
    ranks = [dict(np.load(os.path.join(tmp, f"r{r}.npz"))) for r in range(2)]
    shutil.rmtree(tmp)
    bad = worker.differing(one, ranks, "hetero/")
    log(f"sharded (c) two gloo ranks on one card, {SHARDED_STEPS} steps of config1 k=3: "
        f"{len(one)} leaves, {len(bad)} not bitwise the one rank's {bad[:5]}")
    out["c"] = dict(leaves=len(one), differing=bad)
    assert not bad, bad
    out["s"] = time.time() - t_phase
    log(f"sharded phase: {out['s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 16: the intra-cluster split and the int8-sliced matmul
# ---------------------------------------------------------------------------

INTRA_STEPS = 3  # (a)'s fused steps on two ranks
INTRA_KERNELS = ("schur_pairs", "matmul_xf", "spd_inverse_xf", "steplen_xf", "elemwise_xf")
BAND_KERNELS = ("spd_panel_xf", "matmul_xf", "elemwise_xf")
BAND_SIZES = (261, 262, 512)  # sp86's S_j and Q, and a panel route's wide block
# the int8-sliced matmul (ops/mxu_matmul.py) at config 1's pairing shapes
# at k = 2 and 3, and wide at k=3, timed beside K4 on the same operands
MXU_SHAPES = tuple((label, shape, k) for k in (2, 3) for label, shape in MATMUL_SHAPES[:2]) + (
    ("(1024,64)x(64,1024)", (1, 1024, 64, 1024), 3),)
MXU_ROUTE = dict(ALL_KERNELS_ROUTE, use_cuda_matmul=False, use_mxu_matmul=True)


def mxu_operands(i, dev):
    """MXU_SHAPES[i]'s operands, made from a seed."""
    _, (B, n, K, m), k = MXU_SHAPES[i]
    rng = np.random.default_rng(1600 + i)
    return rand_xf(rng, (B, n, K), k, dev), rand_xf(rng, (B, K, m), k, dev)


def mxu_plain(i):
    """xf_matmul_mxu of MXU_SHAPES[i] on the CPU; in a worker process."""
    from clrs_tpu_torch.ops.mxu_matmul import xf_matmul_mxu
    from clrs_tpu_torch.ops.xfloat import XF

    torch.set_num_threads(2)
    a, b = mxu_operands(i, "cpu")
    return xf_matmul_mxu(XF(a), XF(b)).limbs


def cpu_mxu_config1():
    """Config 1 at k=3 on MXU_ROUTE on the CPU; in a worker process."""
    torch.set_num_threads(2)
    t0 = time.time()
    bound_, res = solve(8, 5, 3, "cpu", MXU_ROUTE)
    return dict(bound=bound_, status=res.status, iterations=res.iterations,
                history=res.history, wall_s=time.time() - t0)


def intra_phase(dev, record, mxu_futures, cpu_mxu):
    """Phase 16: (a) two ranks on the one card (gloo carrying the CUDA
    tensors) split config 1 at k=3 inside its clusters (parallel/intra.py,
    T padded to a multiple of 2) on the all-kernels route: 3 fused steps
    with every leaf bitwise the one rank's, then solve_intra_sharded to
    `optimal` with the bound 240 to 1e-12, K2, K4, K5, K7 and K8 launched;
    (b) the same ranks' panel-route SPD inverse with row bands at 261, 262
    and 512 rows at k=3 (and the plain panel Cholesky at 64), bitwise the
    one rank's, through the panel kernel, K4 and K8 only, and both forms
    without a group on matrices that differ between the ranks, bitwise the
    one rank's (no rank reads another's rows unless it names a group); (c)
    xf_matmul_mxu on the card bitwise a CPU worker's at config 1's pairing
    shapes at k = 2, 3 and wide at k=3, timed beside K4 (and with its adds
    through K8, as MXU_ROUTE runs it), and config 1 at
    k=3 on MXU_ROUTE to `optimal`, its rows held to the CPU's run of the
    same route to 1e-10."""
    import shutil
    import socket
    import tempfile

    from clrs_tpu_torch.ops import cuda_xf
    from clrs_tpu_torch.ops.mxu_matmul import xf_matmul_mxu
    from clrs_tpu_torch.ops.xfloat import XF, elemwise_cuda
    from clrs_tpu_torch.tools import mp_hetero_worker as worker

    t_phase = time.time()
    out = record["intra"] = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_intra_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    opts = ["--what", "intra,intra_solve,bands", "--d", "5", "--k", "3", "--steps",
            str(INTRA_STEPS), "--all-kernels", "--pad", "2",
            "--band-sizes", ",".join(map(str, BAND_SIZES))]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "clrs_tpu_torch.tools.mp_hetero_worker", str(r), "2", str(port),
         os.path.join(tmp, f"r{r}.npz"), "--device", "cuda", "--backend", "gloo", *opts],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(2)]
    try:
        # (c) while the ranks start
        rows = out["mxu"] = []
        for i, (label, shape, k) in enumerate(MXU_SHAPES):
            a, b = mxu_operands(i, dev)
            got = xf_matmul_mxu(XF(a), XF(b)).limbs
            want = mxu_futures[i].get()
            with elemwise_cuda():  # its adds through K8, as the solve's route runs it
                k8_ms = median_ms(lambda: xf_matmul_mxu(XF(a), XF(b)), 5)
            row = dict(shape=label, k=k, bitwise=bits_equal(got.cpu(), want),
                       max_abs_err=float((got.cpu() - want).abs().max()),
                       ms=median_ms(lambda: xf_matmul_mxu(XF(a), XF(b)), 5), k8_ms=k8_ms,
                       k4_ms=median_ms(lambda: cuda_xf.matmul_xf(a, b), 5) if k > 2 else None)
            log(f"intra (c) xf_matmul_mxu {label} k={k}: bitwise the CPU's "
                f"{row['bitwise']}, one call {row['ms']:.4f} ms, its adds through K8 "
                f"{k8_ms:.4f} ms" + (f", K4 {row['k4_ms']:.4f} ms" if row["k4_ms"] else ""))
            rows.append(row)
            assert row["bitwise"], f"intra (c): xf_matmul_mxu {label} k={k} differs from the CPU"
        reset_counters()
        t0 = time.time()
        bound_, res = solve(8, 5, 3, dev, MXU_ROUTE)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counters()
        cpu = cpu_mxu.get()
        worst, held = held_rows(res.history, cpu["history"])
        log(f"intra (c) config1 k=3 use_mxu_matmul (beside the ranks): bound {bound_!r} "
            f"status {res.status} iterations {res.iterations} wall {wall:.3f} s; cpu: "
            f"{cpu['bound']!r} {cpu['status']} {cpu['iterations']} ({cpu['wall_s']:.1f} s), "
            f"rows held {worst!r} over {held}; launches {launches}")
        out["mxu_solve"] = dict(bound=bound_, status=res.status, iterations=res.iterations,
                                wall_s=wall, launches=launches, cpu_rel_diff=worst,
                                cpu_held=held, cpu_wall_s=cpu["wall_s"])
        assert res.status == "optimal" == cpu["status"], (res.status, cpu["status"])
        assert abs(bound_ - 240.0) < 1e-12, bound_
        assert held == min(res.iterations, cpu["iterations"]) and worst <= 1e-10, \
            f"intra (c): gpu and cpu differ by {worst!r}"
        assert launches["matmul_xf"] == launches["schur_pairs"] == 0, launches
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        log(f"intra: two gloo ranks on one card FAILED (ranks {failed}): "
            + logs[failed[0]][-2000:].replace("\n", " | "))
        raise AssertionError("intra: the two gloo ranks failed on the card")
    ranks = [dict(np.load(os.path.join(tmp, f"r{r}.npz"))) for r in range(2)]
    shutil.rmtree(tmp)

    # (a) and (b): the one rank's steps and bands here, the card alone
    one = {}
    worker.run_intra(5, 3, INTRA_STEPS, dev, None, one, True, 2, False)
    worker.run_bands(3, BAND_SIZES, dev, None, one)
    for part in ("intra", "bands"):
        bad = worker.differing(one, ranks, part + "/")
        n = sum(key.startswith(part + "/") for key in one)
        log(f"intra ({'a' if part == 'intra' else 'b'}) two gloo ranks on one card: "
            f"{n - len(bad)} of {n} leaves bitwise the one rank's {bad[:5]}")
        out[part] = dict(leaves=n, differing=bad)
        assert not bad, (part, bad)
    for part, kernels in (("intra", INTRA_KERNELS), ("intra_solve", INTRA_KERNELS),
                          ("bands", BAND_KERNELS)):
        counts = {key.split("/")[-1]: int(v) for key, v in ranks[0].items()
                  if key.startswith(f"launches/{part}/")}
        out[part + "_launches"] = counts
        for name, count in counts.items():
            assert (count > 0) == (name in kernels), f"intra: {part} launched {name} {count}"
    diag = {key.split("/")[-1]: float(v) for key, v in ranks[0].items()
            if key.startswith("intra_solve/result/diag/")}
    solve_ = dict(iterations=int(ranks[0]["intra_solve/iterations"]),
                  gap=float(ranks[0]["intra_solve/gap"]), bound=1.0 - diag["d_obj"],
                  primal_err=diag["primal_err"], dual_err=diag["dual_err"],
                  wall_s=float(ranks[0]["timing/intra_solve"]))
    solve_["ms_per_iteration"] = 1e3 * solve_["wall_s"] / solve_["iterations"]
    steps = dict(ranks_ms=[1e3 * float(t) for t in ranks[0]["timing/intra"]],
                 one_ms=[1e3 * float(t) for t in one["timing/intra"]])
    out.update(solve=solve_, step_ms=steps)
    log(f"intra (a) solve_intra_sharded on two ranks: bound {solve_['bound']!r} gap "
        f"{solve_['gap']:.3e} errors {solve_['primal_err']:.3e} {solve_['dual_err']:.3e} "
        f"iterations {solve_['iterations']} ({solve_['ms_per_iteration']:.1f} ms each); "
        f"fused step ms, two ranks {steps['ranks_ms']}, one rank {steps['one_ms']}")
    optimal = (solve_["gap"] < 1e-15 and solve_["primal_err"] < 1e-30
               and solve_["dual_err"] < 1e-30)
    assert optimal and abs(solve_["bound"] - 240.0) < 1e-12, solve_
    out["s"] = time.time() - t_phase
    log(f"intra phase: {out['s']:.1f} s")


def ptxas_report(text: str):
    """Registers, stack and spills of the k-limb kernels (and of the
    out-of-line add and multiply of K5 and K7, and K5's panel kernel) at
    k=3, 10 and 12, of the
    matmul, the Schur block and the SPD inverse also at k=2 (K3, K2, K1),
    the matmul's 64-bit-index instances marked so, and of K9; K8's
    instances are named by op and by the dense form."""
    names = ("matmul_xf_kernel", "schur_pairs_kernel", "spd_inverse_xf_kernel",
             "steplen_xf_kernel", "elemwise_xf_kernel", "xf_add_n", "xf_mul_n",
             "spd_panel_xf_kernel")
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
    # phase 10 runs beside phases 4-6, 11 and 9 in a card process of its own
    # where the card's compute mode lets a second process on it
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    shared = mode == "Default"
    log(f"compute mode {mode}: phase 10 runs "
        + ("in a card process of its own" if shared else "in this process"))
    dev = torch.device("cuda", 0)
    t_start = time.time()
    record = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  device=torch.cuda.get_device_name(0))
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {record['device']}")

    # the pools' exit terminates their workers, on success and on failure;
    # sp86's pool packs it, then runs its CPU iterations and LU at once
    # the workers run at a lower priority than this process, which drives
    # the card from one core and waits on the host between launches, and
    # than the build's nvcc processes
    sp86_pool = get_context("spawn").Pool(SP86_WORKERS, os.nice, (WORKER_NICE,))
    sp86_futures = {}

    def sp86_tasks(packed):  # in the pool's result thread, once the packing is done
        sp86_futures["cpu"] = sp86_pool.apply_async(cpu_sp86, (packed["data"],))
        sp86_futures["lu"] = sp86_pool.apply_async(cpu_sp86_lu, (packed["data"],))

    sp86_futures["packed"] = sp86_pool.apply_async(sp86_pack_data, callback=sp86_tasks)
    with sp86_pool, get_context("spawn").Pool(3 + TREE_WORKERS, os.nice, (WORKER_NICE,)) as pool:
        # phase 14's longest task first: the panel row at k=10 (~7 min)
        panel_futures = {(k, n): pool.apply_async(panel_plain, (k, n))
                         for _, k, n in PANEL_SHAPES if k == 10}
        cpu_k2 = pool.apply_async(cpu_solve, (8, 5, 2))
        cpu_k3 = pool.apply_async(cpu_solve, (8, 5, 3))
        cpu_all = pool.apply_async(cpu_solve, (8, 5, 3, ALL_KERNELS_ROUTE))
        trees = sorted(((k, n) for k in (3, 12) for n in TREE_SIZES), key=lambda kn: -kn[0] * kn[1])
        config1_futures = {task: pool.apply_async(ladder_plain, (task,))
                           for task in ladder_tasks({"config1": CONFIG1_CPU_KS})}
        tree_futures = {kn: [pool.apply_async(tree_plain, kn + (kernel,)) for kernel in ("k5", "k7")]
                        for kn in trees}
        cpu_sp16 = pool.apply_async(cpu_sphere, (8, 2, LADDER_PARITY_ITERATIONS))
        cpu_hetero = pool.apply_async(cpu_hetero_config1)
        cpu_mxu = pool.apply_async(cpu_mxu_config1)
        mxu_futures = [pool.apply_async(mxu_plain, (i,)) for i in range(len(MXU_SHAPES))]
        # phase 12's plain versions, wanted last (~480 s of one core's work on
        # the H100 machine)
        ladder_futures = {task: pool.apply_async(ladder_plain, (task,)) for task in ladder_tasks()}
        # phase 14's other panel rows
        panel_futures.update({(k, n): pool.apply_async(panel_plain, (k, n))
                              for _, k, n in sorted(PANEL_SHAPES, key=lambda s: -s[1] ** 3 * s[2])
                              if k != 10})

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

        phase_s = record["phase_s"] = {}

        def done(name):
            phase_s[name] = time.time() - t_start
            log(f"chip_smoke: {name} done at {phase_s[name]:.1f} s")

        done("build")
        rows = check_kernels(dev, record, [], dict(sorted(tree_futures.items())),
                             config1_futures)
        done("kernels")
        launches = {}
        with get_context("spawn").Pool(1) as card_pool:
            sp30_future = card_pool.apply_async(sp30_process) if shared else None
            launches[2], default_k2 = solve_config1(
                dev, record, 2, cpu_k2, 1e-20, 1e-9, None,
                ("spd_inverse_dd", "schur_pairs", "matmul_dd"))
            launches[3], default_k3 = solve_config1(
                dev, record, 3, cpu_k3, None, 1e-12, "optimal",
                ("schur_pairs", "matmul_xf", "spd_inverse_xf"), iterations=DEFAULT_K3_ITERATIONS)
            done("config 1")
            launches["dim24"] = solve_dim24(dev, record)
            done("dim 24")
            launches["config4"] = solve_config4(dev, record)
            done("config 4")
            sp16_rungs = solve_sp16_ladder(dev, record, cpu_sp16)
            done("sp16 ladder")
            record["sp30"], lines = sp30_future.get() if shared else sp30_process()
        for line in lines:
            log(line)
        done("sp30")
        launches["all"], all_k3 = solve_all_kernels(dev, record, cpu_all, default_k3, cpu_k3)
        done("config 1 all-kernels")
        sharded_phase(dev, record, all_k3, cpu_hetero)
        done("sharded")
        intra_phase(dev, record, mxu_futures, cpu_mxu)
        done("intra")
        check_ladder_kernels(dev, rows, ladder_futures)
        done("sphere-packing kernels")
        panel_plain_out = {kn: f.get() for kn, f in panel_futures.items()}
        done("phase 14's panel rows on the CPU")
        pool.terminate()  # the workers' work is done: free their cores
        profile_all_kernels(dev, record,
                            record["config1_k3_routes"]["steady_it_per_s"]["all-kernels"])
        profile_k1(dev, record)
        done("profiles")
        device_loop_phase(dev, record, all_k3, launches["all"], default_k2, sp16_rungs)
        done("device loop")
        check_panel_route(dev, record, rows, panel_plain_out)
        done("panel route")
        packed = sp86_futures["packed"].get()  # its callback has run when this returns
        done("sp86's packing")
        # the card's sp86 and LU while the CPU worker runs its iteration
        launches["sp86"] = solve_sp86(dev, record, packed, sp86_futures["cpu"])
        done("sp86")
        check_sp86_lu(dev, record, sp86_futures["lu"].get())
        done("sp86 LU")

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
