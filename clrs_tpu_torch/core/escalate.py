"""Precision escalation: restart the solve with more limbs from the last
iterate (SURVEY.md §3.5/§5.3).

Counterpart of ``clrs_tpu/core/escalate.py``.  The reference's recovery
story is "restart the whole solve at higher precision, warm-started via
initial_solutions" (MPMP.jl:793, 1439, 1503, 1882 + :613-614); here, as in
the reference, the restart is automated as a ladder of limb counts.  Each
rung repacks the exact host-side constraint data at its k and starts from
the previous rung's iterate, padded with zero limbs.

The port's limbs are float64 on every device and its one solver runs every
k = 2..12, so the ladder is one list of plain rungs, (2, 3, 4, 6, 10) by
default: the rungs that land the reference's full contract.  Left out of
the reference's driver, and why:
- scaled rungs ``(k, scale_bits)`` and the representation changes between
  them: they lift the float32 exponent floor of TPU limbs, which float64
  limbs do not have;
- ``default_device_ladder`` and ``CLRS_ESCALATE_512``: the platform choice
  between a TPU ladder and a CPU ladder;
- ``core/subproc.py`` (``isolate_slow_compiles``, ``subprocess_platform``):
  XLA:CPU's compile flags per k; the port compiles nothing per k;
- the separate host solver (``core/host_solver.py``): it exists for XLA's
  compile cost at k >= 9.  ``host_ladder`` is kept so that reference calls
  run: its rungs are appended to ``k_ladder`` and run by the same solver.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from clrs_tpu_torch.core.blockinfo import BlockInfo
from clrs_tpu_torch.core.device_loop import solve_on_device
from clrs_tpu_torch.core.problem import pack_constraints
from clrs_tpu_torch.core.solver import SolveResult, solve_device, solverank1sdp
from clrs_tpu_torch.ops.xfloat import XF

DEFAULT_LADDER = (2, 3, 4, 6, 10)


def _reround_limbs(x: XF, k: int) -> XF:
    """x with k limbs: zero limbs appended (exact), or the trailing ones
    dropped, on x's own device."""
    limbs = x.limbs
    have = limbs.shape[0]
    if k > have:
        limbs = torch.cat([limbs, limbs.new_zeros((k - have,) + limbs.shape[1:])])
    return XF(limbs[:k])


def _reround_state(state, k: int):
    """The iterate (x, y, X, Y) re-rounded to k limbs for the next rung."""
    x, y, X, Y = state
    return (
        _reround_limbs(x, k),
        _reround_limbs(y, k),
        [[_reround_limbs(b, k) for b in row] for row in X],
        [[_reround_limbs(b, k) for b in row] for row in Y],
    )


def solve_with_escalation(
    constraints,
    b,
    blockinfo: Optional[BlockInfo] = None,
    k_ladder: Optional[Sequence[int]] = None,
    host_ladder: Sequence[int] = (),
    C=None,
    b0=0,
    verbose: bool = True,
    driver: str = "phase",
    device="cuda",
    **kwargs,
) -> SolveResult:
    """Solve, escalating the limb count on numerical failure or stall.

    Runs the rungs ``k_ladder`` (default ``DEFAULT_LADDER``) then
    ``host_ladder`` in order, each through ``driver`` on ``device`` (the
    CUDA card unless told otherwise; without one it raises) with every
    other solver keyword.  A rung that converges is returned.  One that
    ends on a numerical failure, an overflow or a stall hands its (best)
    iterate, re-rounded, to the next rung, with ``maxiterations`` less the
    iterations spent (at least 10); any other status ends the ladder.
    Without convergence the rung result of least merit (the smallest max
    of gap and errors over its history) is returned.  The result's
    ``.rungs`` lists every rung's k, status, iterations and wall seconds.

    driver: "phase" (the host driver, solverank1sdp, which reads the
    device after every phase) or "device_loop" (core/device_loop.
    solve_on_device on the rung's problem packed on ``device``, which reads
    it once per ``chunk`` iterations; ``chunk`` and the route flags pass
    through the keywords).  The device loop keeps the post-update state of
    its best iteration, so a rung that stalls hands the next one another
    warm start than the phase driver would.
    """
    if driver not in ("phase", "device_loop"):
        raise ValueError(f"solve_with_escalation: unknown driver {driver!r}")
    ladder = tuple(DEFAULT_LADDER if k_ladder is None else k_ladder) + tuple(host_ladder)

    state = ()
    res = None
    best = None
    rung_log = []  # per-rung summaries, attached to the result as .rungs

    def _finish(r):
        r.rungs = list(rung_log)
        return r

    def merit(r):
        if not r.history:
            return float("inf")
        return min(
            max(abs(h["gap"]), h["P_err"], h["p_err"], h["d_err"])
            for h in r.history
        )

    def consider(r):
        nonlocal best
        if best is None or merit(r) < merit(best):
            best = r

    remaining = kwargs.pop("maxiterations", 500)
    for rung, k in enumerate(ladder):
        k = int(k)
        t_rung = time.time()
        if verbose and rung > 0:
            print(f"[escalate] restarting at k={k} limbs (warm start)")
        if driver == "device_loop":
            problem = pack_constraints(constraints, b, info=blockinfo, C=C, b0=b0, k=k,
                                       device=solve_device(device, "solve_with_escalation"))
            res = solve_on_device(problem, initial_solutions=state, verbose=verbose,
                                  maxiterations=remaining, **kwargs)
        else:
            res = solverank1sdp(
                constraints,
                b,
                blockinfo,
                C=C,
                b0=b0,
                precision_k=k,
                initial_solutions=state,
                verbose=verbose,
                maxiterations=remaining,
                device=device,
                **kwargs,
            )
        rung_log.append(dict(
            path="device", k=k, iterations=res.iterations, status=res.status,
            wall=round(time.time() - t_rung, 2)))
        if res.converged:
            return _finish(res)
        consider(res)
        escalatable = (
            res.status.startswith(("numerical_failure", "overflow"))
            or res.status == "stalled"
        )
        if not escalatable or rung + 1 == len(ladder):
            break  # max_iterations etc. — escalation will not help
        remaining = max(10, remaining - res.iterations)
        state = _reround_state((res.x, res.y, res.X, res.Y), int(ladder[rung + 1]))
    return _finish(best if best is not None else res)
