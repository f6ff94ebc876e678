"""The port's device-resident loop (clrs_tpu_torch/core/device_loop.py) on
the CPU, against the JAX reference's (clrs_tpu/core/device_loop.py) and
against the port's own phase driver.

- Both packages' solve_on_device on small LPs packed by the reference and
  passed through interop: the two problems of tests/test_device_loop.py
  (the LP with chunk=16, the two-cluster problem with chunk=64) and an LP
  that reaches each other status: STALLED (infeasible), NUMERICAL_FAIL
  with the sticky switch to LU (an indefinite warm start), PRIMAL_FEASIBLE
  and DUAL_FEASIBLE (need_*_feasible), maxiterations reached mid-chunk.
  Same status, iterations and history rows, objectives to 1e-12 and x to
  1e-8 relative; bitwise is not possible, as XLA:CPU contracts
  multiply-adds inside the reference's compiled loop.  The reference
  compiles its loop anew in every solve_on_device call; its compiled loop
  takes the problem as an argument and reads only its shapes otherwise, so
  the fixture keeps one per configuration and shape.  That leaves four
  compiles (the LP's, the two-cluster problem's, the LU loop the failure
  switches to, and the need_*_feasible loop: the configuration's flags and
  thresholds are constants of the compiled loop), ~20-27 s each, mostly
  tracing; the cases that compile run in threads of their own, which
  overlap the compiles' native parts.
- Against the port's phase driver at test_torch_slice.py's size (Delsarte
  dim 8, 2d=6, k=2) on the plain versions of the default and the
  all-kernels routes: chunk=1 gives the phase driver's rows bit for bit;
  chunk 1, 7 and 64 give the same final carry bit for bit; an iteration
  launched after the end leaves the carry unchanged.
- The reference semantics the device loop keeps, on a scripted step: the
  best state is the post-update state, and the status order.
- Device residency: whole chunks run while every host read raises.
"""

import types

import mpmath
import numpy as np
import pytest
import torch

from clrs_tpu.core.blockinfo import get_block_info as j_get_block_info
from clrs_tpu.core.device_loop import solve_on_device as j_solve_on_device
from clrs_tpu.core.problem import pack_constraints as j_pack
from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints
from clrs_tpu_torch.core import device_loop
from clrs_tpu_torch.core.blockinfo import get_block_info
from clrs_tpu_torch.core.device_loop import DeviceSolve, solve_on_device
from clrs_tpu_torch.core.problem import pack_constraints
from clrs_tpu_torch.core.solver import _HISTORY_KEYS, SolverConfig, solverank1sdp
from clrs_tpu_torch.interop import problem_from_numpy, state_from_numpy
from clrs_tpu_torch.ops import xfloat, xops
from clrs_tpu_torch.ops.linalg import xf_eigvalsh_approx
from clrs_tpu_torch.ops.xfloat import XF

from test_solver_small import make_lp_constraint
from test_torch_slice import to_numpy_tree

from test_torch_xfloat import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
F64 = torch.float64

# ---------------------------------------------------------------------------
# Both packages' device loops on small LPs
# ---------------------------------------------------------------------------

VS = [np.array([1.0, 0.0]), np.array([0.0, 1.0])]
BASE = dict(omega_p=100.0, omega_d=100.0, maxiterations=200, verbose=False)
NEED_BOTH = dict(need_primal_feasible=True, need_dual_feasible=True,
                 primal_error_threshold=1e-10, dual_error_threshold=1e-10)
LP = ([[1.0], [1.0]], [2.0, 3.0])
# x1 X1 + x2 X2 = X with X = diag(1, -1): X^-1's Cholesky fails, then,
# after the switch to LU, the step length's
INDEFINITE = (np.zeros((2, 2, 1)), np.zeros((2, 1, 1)),
              [[np.stack([np.diag([1.0, -1.0]), np.zeros((2, 2))])]],
              [[np.stack([np.eye(2), np.zeros((2, 2))])]])
CASES = {  # name: (clusters' (B, c), b, options, chunk, warm start, status)
    "lp": ([LP], [1.0], {}, 16, None, "optimal"),
    "two_cluster": ([([[1.0], [1.0]], [1.0, 2.0]), ([[1.0], [1.0]], [3.0, 1.0])], [1.0], {},
                    64, None, "optimal"),
    "stalled": ([LP], [-1.0], {}, 16, None, "stalled"),  # x1 + x2 = -1, x >= 0
    "numerical_failure": ([LP], [1.0], {}, 16, INDEFINITE, "numerical_failure:device_loop"),
    "primal_feasible": ([LP], [1e3], NEED_BOTH, 16, None, "primal_feasible"),
    "dual_feasible": ([LP], [1.0], NEED_BOTH, 16, None, "dual_feasible"),
    "max_iterations": ([LP], [1.0], dict(maxiterations=7), 4, None, "max_iterations"),
}


def lp_problems(name):
    """The case's problem packed by the reference at mpmath's default 53
    bits (packing runs at the ambient precision, which an earlier test in
    the process may have raised, and the diverging cases follow their data
    to the last bit), and the port's copy of it through interop."""
    clusters = CASES[name][0]
    cons = [make_lp_constraint(VS, B, c) for B, c in clusters]
    with mpmath.workprec(53):
        jp = j_pack(cons, CASES[name][1], info=j_get_block_info(cons))
    return jp, problem_from_numpy(to_numpy_tree(jp), get_block_info(cons), device=CPU)


# the cases in groups that share no compiled loop: the failure switches from
# the LP's loop to the LU one, so it follows the LP in its group
CASE_GROUPS = (("lp", "numerical_failure", "stalled", "max_iterations"), ("two_cluster",),
               ("primal_feasible", "dual_feasible"))


@pytest.fixture(scope="module")
def lp_runs():
    """Every case through both packages' solve_on_device, a group a thread
    (the problems are packed first: mpmath's precision is global)."""
    import dataclasses
    import sys
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp
    from clrs_tpu.core import device_loop as j_device_loop
    from clrs_tpu.ops.xfloat import XF as JXF

    loops = {}
    make = j_device_loop.make_device_solve

    def one_loop_per_shape(problem, cfg):
        key = (dataclasses.replace(cfg, maxiterations=0), repr(problem.info))
        if key not in loops:
            loops[key] = make(problem, cfg)
        return loops[key]

    problems = {name: lp_problems(name) for name in CASES}

    def run(names):
        out = {}
        for name in names:
            _, _, options, chunk, warm, _ = CASES[name]
            jp, tp = problems[name]
            kwargs = dict(BASE, **options)
            j_warm = t_warm = ()
            if warm is not None:
                x, y, X, Y = warm
                j_warm = (JXF(jnp.asarray(x)), JXF(jnp.asarray(y)),
                          [[JXF(jnp.asarray(b)) for b in r] for r in X],
                          [[JXF(jnp.asarray(b)) for b in r] for r in Y])
                t_warm = state_from_numpy(x, y, X, Y, device=CPU)
            out[name] = (j_solve_on_device(jp, chunk=chunk, initial_solutions=j_warm, **kwargs),
                         solve_on_device(tp, chunk=chunk, initial_solutions=t_warm, **kwargs))
        return out

    assert sorted(sum(CASE_GROUPS, ())) == sorted(CASES)
    limit = sys.getrecursionlimit()  # the reference's solves raise it, each in turn
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_device_loop, "make_device_solve", one_loop_per_shape)
            with ThreadPoolExecutor(len(CASE_GROUPS)) as pool:
                return {name: r for group in pool.map(run, CASE_GROUPS)
                        for name, r in group.items()}
    finally:
        sys.setrecursionlimit(limit)


def close(a, b, rel):
    return abs(a - b) <= rel * max(1.0, abs(a))


@pytest.mark.parametrize("name", list(CASES))
def test_device_loop_matches_reference(lp_runs, name):
    want, got = lp_runs[name]
    assert got.status == want.status == CASES[name][5]
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    # one row per chunk, at the same iterations: the same chunks, the same
    # early ends and (for the failure) the same switch to LU
    assert [r["iter"] for r in got.history] == [r["iter"] for r in want.history]
    # with no finite merit (every iteration failed) both report the last
    # row, the failed iteration's objectives: an LU solve with the
    # indefinite X, conditioned ~1e35, which the two packages' roundings
    # part at 2e-7
    rel = 1e-6 if name == "numerical_failure" else 1e-12
    assert close(want.primal_objective, got.primal_objective, rel)
    assert close(want.dual_objective, got.dual_objective, rel)
    assert close(want.dual_gap, got.dual_gap, rel)
    xw = np.asarray(want.x.to_float64()).ravel()
    xg = got.x.to_float64().numpy().ravel()
    assert all(close(a, b, 1e-8) for a, b in zip(xw, xg)), (xw, xg)


# ---------------------------------------------------------------------------
# Against the port's phase driver, on config 1's smaller sibling
# ---------------------------------------------------------------------------

DELSARTE = dict(omega_p=100.0, omega_d=100.0, verbose=False, maxiterations=30,
                primal_error_threshold=1e-20, dual_error_threshold=1e-20,
                duality_gap_threshold=0.5)  # pd-feasible after iteration 7, optimal at 8
ROUTES = {"default": dict(use_cuda_matmul=True),
          "all-kernels": dict(use_cuda_matmul=True, use_cuda_inverse=True,
                              use_cuda_steplength=True, use_cuda_elemwise=True)}
CHUNKS = (1, 7, 64)
ITERATIONS = 8


def delsarte_problem():
    with mpmath.workprec(53):  # packed as in a fresh process (see lp_problems)
        cons, b, info = build_delsarte_constraints(8, 3)
        return pack_constraints(cons, b, info=info, k=2, device=CPU)


def solve_capturing(problem, chunk, **kwargs):
    """solve_on_device, with its last chunk's carry and the number of
    iterations it launched."""
    seen = dict(launched=0)
    run_chunk, body = DeviceSolve.run_chunk, DeviceSolve.body

    def counting_body(self, *args):
        seen["launched"] += 1
        return body(self, *args)

    def capturing(self, *args):
        seen["carry"], seen["loop"] = run_chunk(self, *args), self
        return seen["carry"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceSolve, "run_chunk", capturing)
        mp.setattr(DeviceSolve, "body", counting_body)
        res = solve_on_device(problem, chunk=chunk, **kwargs)
    return res, seen


@pytest.fixture(scope="module")
def delsarte_runs():
    problem = delsarte_problem()
    out = {}
    for route, flags in ROUTES.items():
        phase = solverank1sdp(problem=problem, **DELSARTE, **flags)
        loops = {chunk: solve_capturing(problem, chunk, **DELSARTE, **flags)
                 for chunk in CHUNKS}
        out[route] = (phase, loops)
    return out


def leaves(tree):
    if isinstance(tree, XF):
        return [tree.limbs]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    return [leaf for t in tree for leaf in leaves(t)]


def bitwise(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and (
        torch.equal(a.view(torch.int64), b.view(torch.int64)) if a.dtype == F64
        else torch.equal(a, b))


def same_tree(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(map(bitwise, la, lb))


def same_rows(a, b):
    keys = [key for key in a[0] if key != "time"]
    return len(a) == len(b) and all(
        np.array_equal(np.float64([ra[key] for key in keys]).view(np.uint64),
                       np.float64([rb[key] for key in keys]).view(np.uint64))
        for ra, rb in zip(a, b))


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunk1_rows_bitwise_phase_driver(delsarte_runs, route):
    phase, loops = delsarte_runs[route]
    res, seen = loops[1]
    assert phase.status == res.status == "optimal"
    assert phase.iterations == res.iterations == seen["launched"] == ITERATIONS
    assert same_rows(phase.history, res.history)
    assert phase.dual_objective == res.dual_objective
    assert same_tree((phase.x, phase.y, phase.X, phase.Y), (res.x, res.y, res.X, res.Y))


@pytest.mark.parametrize("chunk", CHUNKS[1:])
@pytest.mark.parametrize("route", list(ROUTES))
def test_final_carry_bitwise_across_chunks(delsarte_runs, route, chunk):
    """The status is reached mid-chunk at chunk 7 and 64; on the CPU the
    chunk stops launching at once (the status copy is done when it
    returns), so no iteration runs after the end."""
    _, loops = delsarte_runs[route]
    (one, seen1), (res, seen) = loops[1], loops[chunk]
    assert (res.status, res.iterations) == (one.status, one.iterations)
    assert seen["launched"] == res.iterations
    assert same_tree(seen["carry"], seen1["carry"])
    assert [r["iter"] for r in res.history] == sorted(
        {min(c, ITERATIONS) for c in range(chunk, ITERATIONS + chunk, chunk)})


@pytest.mark.parametrize("route", list(ROUTES))
def test_launch_after_the_end_leaves_the_carry(delsarte_runs, route):
    """An iteration launched after the status has left RUNNING, or at
    itn_stop, changes nothing (what makes the result the same for any
    chunk)."""
    _, loops = delsarte_runs[route]
    _, seen = loops[7]
    loop, carry = seen["loop"], seen["carry"]
    assert int(carry[device_loop.STATUS]) == device_loop.OPTIMAL
    stop = torch.tensor(100, dtype=torch.int32)
    assert same_tree(loop.body(carry, stop), carry)
    running = list(carry)
    running[device_loop.STATUS] = torch.zeros((), dtype=torch.int32)
    running = tuple(running)
    assert same_tree(loop.body(running, running[device_loop.ITN]), running)


# ---------------------------------------------------------------------------
# The reference semantics the device loop keeps, on a scripted step
# ---------------------------------------------------------------------------


class ScriptedStep:
    """Stands in for make_fused_step: iteration t (from 1) adds 1 to x and
    reports script[t - 1] = (gap, primal_err, dual_err, ok), with p_obj = t;
    records each configuration it is built for."""

    def __init__(self, script):
        self.script, self.t, self.configs = script, 0, []

    def __call__(self, problem, cfg):
        self.configs.append(cfg)

        def step(state, pd_feas):
            self.t += 1
            gap, pe, de, ok = self.script[self.t - 1]
            x, y, X, Y = state
            diag = {key: torch.zeros((), dtype=F64) for key in _HISTORY_KEYS}
            diag.update(gap=torch.tensor(gap, dtype=F64), primal_err=torch.tensor(pe, dtype=F64),
                        dual_err=torch.tensor(de, dtype=F64),
                        p_obj=torch.tensor(float(self.t), dtype=F64), ok=torch.tensor(ok))
            one = torch.tensor([1.0, 0.0], dtype=F64).reshape(2, 1, 1)
            return (XF(x.limbs + one), y, X, Y), diag

        return step


def scripted_solve(monkeypatch, script, **options):
    step = ScriptedStep(script)
    monkeypatch.setattr(device_loop, "make_fused_step", step)
    problem = types.SimpleNamespace(device=CPU, x_sigma=None, y_R=None, y_R_inv=None)
    zero = XF(torch.zeros((2, 1, 1), dtype=F64))
    res = solve_on_device(problem, initial=(zero, zero, [[zero]], [[zero]]), chunk=3,
                          **dict(dict(verbose=False, maxiterations=20), **options))
    return res, step, float(res.x.to_float64()[0, 0])


def test_best_state_is_the_post_update_state(monkeypatch):
    """Stalled: the result is the state that the best iteration produced
    (x = 2 after iteration 2), with that iteration's objectives; the phase
    driver hands back the state entering it (x = 1)."""
    script = [(1e-1, 1.0, 1.0, True), (1e-3, 1e-4, 1e-4, True)] + [(1e-2, 1e-2, 1e-2, True)] * 5
    res, _, x = scripted_solve(monkeypatch, script, stall_patience=3)
    assert (res.status, res.iterations) == ("stalled", 5)
    assert x == 2.0 and res.primal_objective == 2.0 and res.dual_gap == 1e-3


ORDER = {  # name: (script, options, status, iterations, x at the end)
    # ok false wins over a converged diagnostic: the entering state is
    # kept, both factorizations switch to LU, and the loop goes on
    "numerical failure before optimal": (
        [(1e-20, 1e-31, 1e-31, False), (1e-20, 1e-31, 1e-31, True)], {}, "optimal", 2, 1.0),
    "optimal before stalled": (
        [(1e-16, 1e-29, 1e-29, True), (5e-16, 1e-31, 1e-31, True)], dict(stall_patience=1),
        "optimal", 2, 2.0),
    "primal feasible before dual feasible": (
        [(1.0, 1e-31, 1e-31, True)], NEED_BOTH, "primal_feasible", 1, 1.0),
    "dual feasible before stalled": (
        [(1e-3, 1e-3, 1e-3, True), (1e-2, 1e-2, 1e-31, True)],
        dict(need_dual_feasible=True, stall_patience=1), "dual_feasible", 2, 2.0),
}


@pytest.mark.parametrize("name", list(ORDER))
def test_status_order(monkeypatch, name):
    """NUMERICAL_FAIL, OPTIMAL, PRIMAL_FEASIBLE, DUAL_FEASIBLE, STALLED, in
    that order (the phase driver tests the stall first)."""
    script, options, status, iterations, x_end = ORDER[name]
    res, step, x = scripted_solve(monkeypatch, script, **options)
    assert (res.status, res.iterations, x) == (status, iterations, x_end)
    switched = [(c.use_lu_inverse, c.use_lu_schur) for c in step.configs]
    assert switched == ([(False, False), (True, True)] if name.startswith("numerical")
                        else [(False, False)])


# ---------------------------------------------------------------------------
# Nothing is read back to the host while a chunk launches
# ---------------------------------------------------------------------------

HOST_READS = ("item", "__bool__", "__float__", "__int__", "tolist", "numpy", "cpu")


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunks_read_nothing_back(monkeypatch, route):
    """Every host read of a tensor raises while a chunk's iterations launch
    (the per-chunk read comes after), and so does every write of host data
    into a tensor (torch.tensor, torch.as_tensor of a number, item
    assignment of a number: on a CUDA device each is a copy from pageable
    host memory, which blocks).  The first chunk runs unguarded, as in
    chip_smoke.py: it fills the caches made once (the Jacobi schedule on
    the device, the plain versions' index tables).  The CPU's correctly
    rounded sqrt (xfloat.sqrt_rn) goes through numpy by design, on the CPU
    only (a CUDA tensor takes torch.sqrt), so it runs unguarded."""
    guard = dict(on=False)
    originals = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    tensor, as_tensor = torch.tensor, torch.as_tensor
    setitem, sqrt_rn, run_chunk = torch.Tensor.__setitem__, xfloat.sqrt_rn, DeviceSolve.run_chunk

    def guarded(name, fn, allowed=lambda *args: False):
        def call(*args, **kwargs):
            if guard["on"] and not allowed(*args):
                raise AssertionError(f"{name} inside a chunk")
            return fn(*args, **kwargs)

        return call

    for name, fn in originals.items():
        monkeypatch.setattr(torch.Tensor, name, guarded(name, fn))
    monkeypatch.setattr(torch, "tensor", guarded("torch.tensor", tensor))
    monkeypatch.setattr(torch, "as_tensor", guarded(
        "torch.as_tensor of host data", as_tensor, lambda x, *a: isinstance(x, torch.Tensor)))
    monkeypatch.setattr(torch.Tensor, "__setitem__", guarded(
        "item assignment of host data", setitem, lambda t, i, v: isinstance(v, torch.Tensor)))

    def unguarded_sqrt(x):
        on, guard["on"] = guard["on"], False
        try:
            return sqrt_rn(x)
        finally:
            guard["on"] = on

    chunks = []

    def chunk(self, *args):
        chunks.append(args)
        guard["on"] = len(chunks) > 1
        try:
            return run_chunk(self, *args)
        finally:
            guard["on"] = False

    monkeypatch.setattr(xfloat, "sqrt_rn", unguarded_sqrt)
    monkeypatch.setattr(xops, "sqrt_rn", unguarded_sqrt)
    monkeypatch.setattr(DeviceSolve, "run_chunk", chunk)
    res = solve_on_device(delsarte_problem(), chunk=2, **dict(DELSARTE, maxiterations=5),
                          **ROUTES[route])
    assert res.iterations == 5 and [r["iter"] for r in res.history] == [2, 4, 5]


# ---------------------------------------------------------------------------
# The pieces that keep an iteration on the device
# ---------------------------------------------------------------------------


def test_constants_are_fills_and_one_by_one_eigenvalues_are_the_entries():
    """XF.from_float of a Python scalar gives torch.tensor's bits by a fill,
    and the 1x1 eigenvalue is eigvalsh's, bit for bit, with no eigensolver
    (whose error check reads back to the host on a CUDA device)."""
    for v in (0.3, 0.1, 1e-300, -2.5, 7, np.float64(0.7)):
        got = XF.from_float(v, k=3, device=CPU)
        want = torch.zeros((3,), dtype=F64)
        want[0] = torch.tensor(float(v), dtype=F64)
        assert bitwise(got.limbs, want)
    a = XF(torch.from_numpy(np.random.default_rng(0).standard_normal((2, 10, 1, 1))))
    assert bitwise(xf_eigvalsh_approx(a), torch.linalg.eigvalsh(a.to_float64()))


def test_fused_step_is_the_phase_drivers_iteration():
    """make_fused_step with a Python bool and with a 0-dim tensor for
    pd_feas gives the same bits (the phase driver passes the first, the
    device loop the second), on a pd-feasible and an infeasible step."""
    from clrs_tpu_torch.core.solver import initial_state, make_fused_step

    problem = delsarte_problem()
    cfg = SolverConfig(**dict(DELSARTE, maxiterations=1), **ROUTES["all-kernels"])
    step = make_fused_step(problem, cfg)
    state = initial_state(problem, cfg)
    for pd in (False, True):
        a = step(state, pd)
        b = step(state, torch.tensor(pd))
        assert same_tree(a, b)
        assert a[1]["ok"].dtype == torch.bool and a[1]["ok"].shape == ()
