"""Device-resident IPM solve: iterations launched back to back, the host
reading the device once per ``chunk`` iterations.

Counterpart of ``clrs_tpu/core/device_loop.py``.  The reference runs the
loop as a ``lax.while_loop`` on the device and returns to the host every
``chunk`` iterations or on a terminal status.  Here the host launches up
to ``chunk`` iterations of ``core/solver.make_fused_step`` and reads
nothing in between: the termination test, the best iterate, the stall
counter and the blow-up rule are device tensors of the loop's carry, and
an iteration launched after the status has left RUNNING (or past the
chunk's end) leaves the carry unchanged, by ``torch.where`` on every leaf.
So the result is bitwise the same for any ``chunk``.  The phase driver
(``core/solver.solverank1sdp``) reads flags after every phase instead.

Ending a chunk early: after each launch the status goes into a pinned host
buffer by a non-blocking copy, and an event marks its arrival; when the
event of the newest or the one before has fired (``Event.query``, which
never blocks) and shows a terminal status, no further iteration of the
chunk is launched.  On a CUDA device a chunk thus launches one or two
masked iterations after the terminal one (the copies trail the host by an
iteration or more); on the CPU none, the copy being done when it returns.

Status codes (the reference's device-side re-derivation of the
termination test, MPMP.jl:1147-1173, and the degradation ladder):
  0 RUNNING          chunk exhausted, keep going
  1 OPTIMAL          gap + both feasibility thresholds met
  2 NUMERICAL_FAIL   a factorization failed at this precision
  3 STALLED          no merit improvement for `stall_patience` iterations
  4 PRIMAL_FEASIBLE  need_primal_feasible short-circuit
  5 DUAL_FEASIBLE    need_dual_feasible short-circuit

Two of the reference's semantics differ from the phase driver's, and are
kept: on improvement the best state is the post-update state (the phase
driver keeps the pre-update state that the residuals measure), and the
status is tested in the order NUMERICAL_FAIL, OPTIMAL, PRIMAL_FEASIBLE,
DUAL_FEASIBLE, STALLED (the phase driver tests the stall first).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from clrs_tpu_torch.core.solver import (
    _HISTORY_KEYS,
    SolveResult,
    SolverConfig,
    initial_state,
    make_fused_step,
)
from clrs_tpu_torch.ops.xfloat import XF, xf_div, xf_matmul, xf_mul

RUNNING, OPTIMAL, NUMERICAL_FAIL, STALLED, PRIMAL_FEASIBLE, DUAL_FEASIBLE = range(6)

_STATUS_NAMES = {
    OPTIMAL: "optimal",
    NUMERICAL_FAIL: "numerical_failure:device_loop",
    STALLED: "stalled",
    PRIMAL_FEASIBLE: "primal_feasible",
    DUAL_FEASIBLE: "dual_feasible",
}

# the carry: (state, pd_feas, itn, status, best_state, best_merit, stall,
# diag, best_diag), every leaf a tensor on the problem's device
STATE, PD, ITN, STATUS, BEST, BEST_MERIT, STALL, DIAG, BEST_DIAG = range(9)


def _where(cond, a, b):
    """torch.where over a tree of XF, tensors, lists, tuples and dicts."""
    if isinstance(a, XF):
        return XF(torch.where(cond, a.limbs, b.limbs))
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, dict):
        return {key: _where(cond, a[key], b[key]) for key in a}
    return type(a)(_where(cond, x, y) for x, y in zip(a, b))


class _StatusProbe:
    """The loop's status, read without blocking: each launch's status is
    copied into one of two host buffers (pinned on a CUDA device) without
    waiting, and an event marks when it has landed."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.zeros(1, dtype=torch.int32, pin_memory=self.cuda)
                     for _ in range(2)]
        self.views = [buf.numpy() for buf in self.bufs]  # read with no torch call
        self.events = [torch.cuda.Event() if self.cuda else None for _ in range(2)]
        self.posted = [False, False]
        self.count = 0

    def start(self):
        self.posted = [False, False]
        self.count = 0

    def post(self, status: torch.Tensor):
        slot = self.count % 2
        self.bufs[slot].copy_(status.reshape(1), non_blocking=self.cuda)
        if self.cuda:
            self.events[slot].record()
        self.posted[slot] = True
        self.count += 1

    def terminal(self) -> bool:
        """True when the newest status that has landed (the last launch's,
        or the one before) is not RUNNING."""
        for back in (1, 2):
            slot = (self.count - back) % 2
            if self.count - back < 0 or not self.posted[slot]:
                return False
            event = self.events[slot]
            if event is None or event.query():
                return int(self.views[slot][0]) != RUNNING
        return False


class DeviceSolve:
    """The device loop over one problem and configuration (the reference's
    make_device_solve): ``init_carry`` builds the carry, ``body`` is one
    masked iteration, ``run_chunk`` launches a chunk of them."""

    def __init__(self, problem, cfg: SolverConfig):
        self.problem, self.cfg = problem, cfg
        self.device = problem.device
        self.step = make_fused_step(problem, cfg)
        self.probe = _StatusProbe(self.device)

    def init_carry(self, state, pd_feas: bool = False):
        dev = self.device
        pd = torch.full((), bool(pd_feas), device=dev)
        diag0 = {key: torch.zeros((), dtype=torch.float64, device=dev)
                 for key in _HISTORY_KEYS}
        diag0["ok"] = torch.zeros((), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (state, pd, zero, torch.full_like(zero, RUNNING), state,
                torch.full((), float("inf"), dtype=torch.float64, device=dev), zero,
                diag0, dict(diag0))

    def body(self, carry, itn_stop: torch.Tensor):
        """One iteration (device_loop.py:89-141 of the reference); the
        carry comes back unchanged unless the status is RUNNING and itn <
        itn_stop."""
        cfg = self.cfg
        state, pd, itn, status, best, best_merit, stall, diag_prev, best_diag = carry
        new_state, diag = self.step(state, pd)
        ok = diag["ok"]
        gap, pe, de = diag["gap"], diag["primal_err"], diag["dual_err"]
        finite = torch.isfinite(gap) & torch.isfinite(pe) & torch.isfinite(de)
        merit = torch.maximum(torch.maximum(torch.abs(gap), pe), de)
        merit = torch.where(finite & ok, merit, float("inf"))

        improved = merit < best_merit
        new_best_merit = torch.where(improved, merit, best_merit)
        # explosion detector (SolverConfig.blowup_factor): past-the-floor
        # iterations burn the stall budget blowup_weight at a time
        exploded = merit > new_best_merit * cfg.blowup_factor
        new_stall = torch.where(improved, 0,
                                stall + torch.where(exploded, cfg.blowup_weight, 1))

        primal_feas = pe < cfg.primal_error_threshold
        dual_feas = de < cfg.dual_error_threshold
        new_pd = primal_feas & dual_feas
        converged = new_pd & (gap < cfg.duality_gap_threshold)

        new_status = torch.where(new_stall >= cfg.stall_patience, STALLED, RUNNING)
        if cfg.need_dual_feasible:
            new_status = torch.where(dual_feas, DUAL_FEASIBLE, new_status)
        if cfg.need_primal_feasible:
            new_status = torch.where(primal_feas, PRIMAL_FEASIBLE, new_status)
        new_status = torch.where(converged, OPTIMAL, new_status)
        new_status = torch.where(ok, new_status, NUMERICAL_FAIL).to(torch.int32)

        active = (status == RUNNING) & (itn < itn_stop)
        take_best = active & improved
        # on factorization failure the produced state is garbage: keep the
        # entering state (the host can switch to LU, or escalate, from it)
        return (
            _where(active & ok, new_state, state),
            torch.where(active, new_pd, pd),
            itn + active.to(torch.int32),
            torch.where(active, new_status, status),
            _where(take_best, new_state, best),
            torch.where(take_best, merit, best_merit),
            torch.where(active, new_stall.to(torch.int32), stall),
            _where(active, diag, diag_prev),
            _where(take_best, diag, best_diag),
        )

    def run_chunk(self, carry, itn: int, itn_stop: int):
        """Launch up to itn_stop - itn iterations (itn: the carry's count, as
        the host last read it) with no read of the device in between."""
        stop = torch.full((), itn_stop, dtype=torch.int32, device=self.device)
        self.probe.start()
        for _ in range(itn_stop - itn):
            carry = self.body(carry, stop)
            self.probe.post(carry[STATUS])
            if self.probe.terminal():
                break
        return carry


make_device_solve = DeviceSolve  # the reference's name


# a history row: the phase driver's keys (core/solver.py), beta_c as "beta"
_ROW_KEYS = ("mu", "p_obj", "d_obj", "gap", "P_err", "p_err", "d_err", "alpha_p", "alpha_d")


def _read(carry) -> Dict[str, float]:
    """The one read of a chunk: itn, status and the last iteration's
    diagnostics, in one transfer."""
    diag = carry[DIAG]
    vals = torch.stack([carry[ITN].to(torch.float64), carry[STATUS].to(torch.float64)]
                       + [diag[key] for key in _HISTORY_KEYS]).tolist()
    return dict(zip(("itn", "status") + _HISTORY_KEYS, vals))


def solve_on_device(
    problem,
    cfg: Optional[SolverConfig] = None,
    initial=None,
    initial_solutions=(),
    chunk: int = 25,
    **kwargs,
) -> SolveResult:
    """Solve with the device-resident loop on the problem's own device; the
    host reads the device once per
    ``chunk`` iterations.  Handles the same sticky Cholesky->LU switch as
    the reference's device loop: on NUMERICAL_FAIL both X^-1 and the Schur
    factorizations switch to LU and the loop goes on.

    ``initial`` is an internal-coordinates state; ``initial_solutions`` is a
    user-coordinates (x, y, X, Y) warm start (MPMP.jl:613-614): the x_sigma
    and y_R transforms are applied here, as in solverank1sdp.
    """
    if chunk < 1:
        raise ValueError(f"solve_on_device: chunk={chunk}, needs at least 1")
    cfg = cfg or SolverConfig(**kwargs)

    if initial is None and len(initial_solutions) == 4:
        st = list(initial_solutions)
        if problem.x_sigma is not None:
            st[0] = xf_mul(st[0], problem.x_sigma)  # user -> internal
        if problem.y_R is not None:
            st[1] = xf_matmul(problem.y_R, st[1])
        initial = tuple(st)
    state = initial if initial is not None else initial_state(problem, cfg)

    loop = DeviceSolve(problem, cfg)
    carry = loop.init_carry(state)
    t0 = time.time()
    history: List[Dict[str, float]] = []
    if cfg.verbose:
        print(
            f"{'iter':>5} {'time(s)':>8} {'mu':>11} {'P-obj':>11} {'D-obj':>11} "
            f"{'gap':>10} {'P-error':>10} {'p-error':>10} {'d-error':>10}"
        )

    itn = 0
    status_code = RUNNING
    while True:
        carry = loop.run_chunk(carry, itn, min(itn + chunk, cfg.maxiterations))
        vals = _read(carry)
        itn, status_code = int(vals["itn"]), int(vals["status"])
        row = dict(iter=itn, time=time.time() - t0,
                   **{key: vals[key] for key in _ROW_KEYS}, beta=vals["beta_c"])
        history.append(row)
        if cfg.verbose:
            print(
                f"{itn:5d} {row['time']:8.1f} {row['mu']:11.3e} "
                f"{row['p_obj']:11.3e} {row['d_obj']:11.3e} {row['gap']:10.2e} "
                f"{row['P_err']:10.2e} {row['p_err']:10.2e} {row['d_err']:10.2e}"
            )
        if status_code == NUMERICAL_FAIL:
            # sticky degradation ladder (MPMP.jl:762-801): retry with LU for
            # both X^-1 and the Schur factorization
            if not (cfg.use_lu_inverse and cfg.use_lu_schur):
                if cfg.verbose:
                    print("factorization failed — switching to LU (sticky)")
                cfg = dataclasses.replace(cfg, use_lu_inverse=True, use_lu_schur=True)
                loop = DeviceSolve(problem, cfg)
                # keep the iterate and the diagnostics, reset the stall count
                carry = list(carry)
                carry[STATUS] = torch.full_like(carry[STATUS], RUNNING)
                carry[STALL] = torch.zeros_like(carry[STALL])
                carry = tuple(carry)
                continue
            break
        if status_code != RUNNING or itn >= cfg.maxiterations:
            break

    state = carry[STATE]
    converged = status_code in (OPTIMAL, PRIMAL_FEASIBLE, DUAL_FEASIBLE)
    status = _STATUS_NAMES.get(status_code, "max_iterations")
    last = history[-1]
    if status_code in (NUMERICAL_FAIL, STALLED):
        bd = carry[BEST_DIAG]
        best_merit, gap, p_obj, d_obj = torch.stack(
            [carry[BEST_MERIT], bd["gap"], bd["p_obj"], bd["d_obj"]]).tolist()
        if best_merit < float("inf"):
            # best-iterate contract: the best state, with its own metrics
            state = carry[BEST]
            last = dict(gap=gap, p_obj=p_obj, d_obj=d_obj)
    x, y, X, Y = state
    if problem.x_sigma is not None:
        x = xf_div(x, problem.x_sigma)  # internal -> user-facing scaling
    if problem.y_R_inv is not None:
        y = xf_matmul(problem.y_R_inv, y)
    res = SolveResult(
        x=x, X=X, y=y, Y=Y, P=None, p=None, d=None,
        dual_gap=last["gap"],
        primal_objective=last["p_obj"],
        dual_objective=last["d_obj"],
        time_total=time.time() - t0,
        iterations=itn,
        converged=converged,
        status=status,
        history=history,
    )
    if cfg.verbose:
        print(f"status: {res.status}  iterations: {res.iterations}  "
              f"time: {res.time_total:.2f}s")
    return res
