"""The port's precision escalation and checkpoints on the CPU, against the
JAX reference (clrs_tpu/core/escalate.py, clrs_tpu/utils/checkpoint.py).

- Re-rounding between rungs is bitwise the reference's plain (scale 0)
  re-rounding, and stays on the input's device.
- The ladder's control flow is the reference's: a scripted stub solver,
  patched into both modules, sees the same calls (k, maxiterations, warm
  start and its limb count) and both drivers log the same rungs and
  return the same result.
- The univariate PMP of tests/test_aux.py climbs (2, 3) to the full
  contract, held against the reference's host IPM at k=6.
- Checkpoints written by either package load bitwise in the other.
"""

import types

import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from clrs_tpu.apps.sphere_packing import nsphere_packing_2point as j_sphere
from clrs_tpu.core import escalate as j_escalate
from clrs_tpu.models.mpmp import solvempmp as j_solvempmp
from clrs_tpu.models.poly import MPoly as JMPoly
from clrs_tpu.models.poly import poly_matrix as j_poly_matrix
from clrs_tpu.models.samples import create_sample_points_chebyshev as j_cheb
from clrs_tpu.ops.xfloat import XF as JXF
from clrs_tpu.utils import checkpoint as j_checkpoint
from clrs_tpu_torch.apps.sphere_packing import nsphere_packing_2point as t_sphere
from clrs_tpu_torch.core import escalate as t_escalate
from clrs_tpu_torch.core.blockinfo import get_block_info
from clrs_tpu_torch.models.poly import MPoly, poly_matrix
from clrs_tpu_torch.models.prepare import prepareabc
from clrs_tpu_torch.models.samples import create_sample_points_chebyshev
from clrs_tpu_torch.ops.xfloat import XF
from clrs_tpu_torch.utils import checkpoint as t_checkpoint

from test_torch_xfloat import assert_bitwise
from test_torch_xfloat import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")


def random_state(shapes, k, seed):
    """(x, y, X, Y) as numpy limb arrays (k, *shape): shapes = (x shape,
    y shape, [[X_j_l shape]])."""
    rng = np.random.default_rng(seed)
    x_shape, y_shape, blocks = shapes

    def arr(shape):
        return rng.standard_normal((k,) + tuple(shape))

    return (arr(x_shape), arr(y_shape), [[arr(s) for s in row] for row in blocks],
            [[arr(s) for s in row] for row in blocks])


def as_xf(state, make):
    x, y, X, Y = state
    return (make(x), make(y), [[make(b) for b in row] for row in X],
            [[make(b) for b in row] for row in Y])


def j_make(a):
    return JXF(jnp.asarray(a))


def t_make(a):
    return XF(torch.from_numpy(np.array(a)))


def state_leaves(state):
    x, y, X, Y = state
    return [x, y] + [b for row in X for b in row] + [b for row in Y for b in row]


SHAPES = ((5, 1), (3, 1), [[(2, 2), (1, 1)], [(3, 3)]])


@pytest.mark.parametrize("k_from,k_to", [(2, 3), (3, 6), (6, 4), (10, 12)])
def test_reround_state_matches_reference(k_from, k_to):
    raw = random_state(SHAPES, k_from, 10 * k_from + k_to)
    want = j_escalate._reround_state(as_xf(raw, j_make), k_to)
    src = as_xf(raw, t_make)
    got = t_escalate._reround_state(src, k_to)
    for w, g, s in zip(state_leaves(want), state_leaves(got), state_leaves(src)):
        assert g.k == k_to and g.device == s.device
        assert_bitwise(w, g)


# ---------------------------------------------------------------------------
# The ladder's control flow against the reference's, with a scripted solver
# ---------------------------------------------------------------------------


class ScriptedSolver:
    """Stands in for solverank1sdp: the i-th call ends with script[i] =
    (status, iterations, merit), its history falling to that merit, and
    returns an iterate of the call's limb count made from a seed."""

    def __init__(self, script, make):
        self.script, self.make, self.calls = script, make, []

    def __call__(self, constraints, b, blockinfo, precision_k, initial_solutions,
                 maxiterations, **kwargs):
        i = len(self.calls)
        warm = initial_solutions
        self.calls.append(dict(
            k=precision_k, maxiterations=maxiterations, warm=len(warm), chunk=kwargs.get("chunk"),
            warm_limbs=warm[0].limbs.shape[0] if warm else None,
            warm_state=[np.asarray(leaf.limbs) for leaf in state_leaves(warm)] if warm
            else None, device=kwargs.get("device")))
        status, iters, merit = self.script[i]
        history = [dict(gap=merit * 10.0 ** (iters - t), P_err=merit, p_err=0.0, d_err=0.0)
                   for t in range(1, iters + 1)]
        x, y, X, Y = as_xf(random_state(SHAPES, precision_k, 1000 + i), self.make)
        return types.SimpleNamespace(
            call=i, status=status, converged=status == "optimal", iterations=iters,
            history=history, x=x, y=y, X=X, Y=Y)


LADDER_SCRIPTS = {
    "converges at the second rung": ((2, 3, 4), 100, [("stalled", 30, 1e-6), ("optimal", 12, 1e-16)]),
    "max_iterations ends the ladder": ((2, 3), 50, [("max_iterations", 50, 1e-3)]),
    "every rung stalls, the best merit returns": (
        (2, 3, 4), 40, [("stalled", 20, 1e-5), ("stalled", 15, 1e-9), ("stalled", 12, 1e-7)]),
    "overflow and failure escalate": (
        (2, 3, 4), 100, [("overflow:Xinv", 3, 1e-2), ("numerical_failure:steplength", 7, 1e-4),
                         ("optimal", 20, 1e-16)]),
}


@pytest.mark.parametrize("name", sorted(LADDER_SCRIPTS))
def test_ladder_control_flow_matches_reference(name, monkeypatch):
    ladder, maxit, script = LADDER_SCRIPTS[name]
    ref, port = ScriptedSolver(script, j_make), ScriptedSolver(script, t_make)
    monkeypatch.setattr(j_escalate, "solverank1sdp", ref)
    monkeypatch.setattr(t_escalate, "solverank1sdp", port)
    args = (None, [1.0], None)
    want = j_escalate.solve_with_escalation(*args, k_ladder=ladder, host_ladder=(),
                                            isolate_slow_compiles=False, maxiterations=maxit,
                                            verbose=False)
    got = t_escalate.solve_with_escalation(*args, k_ladder=ladder, maxiterations=maxit,
                                           verbose=False, device="cpu")
    assert len(port.calls) == len(ref.calls)
    for r, p in zip(ref.calls, port.calls):
        assert p["device"] == "cpu"
        for key in ("k", "maxiterations", "warm", "warm_limbs"):
            assert p[key] == r[key], (key, r[key], p[key])
        if r["warm_state"] is not None:
            for a, b in zip(r["warm_state"], p["warm_state"]):
                assert np.array_equal(a.view(np.uint64), b.view(np.uint64))
    strip = [{key: r[key] for key in ("path", "k", "iterations", "status")} for r in want.rungs]
    assert [{key: r[key] for key in strip[0]} for r in got.rungs] == strip
    assert got.call == want.call


def test_host_ladder_rungs_append_and_device_loop_raises(monkeypatch):
    """A reference-style call k_ladder=(2,), host_ladder=(6,) runs (2, 6)
    through the one solver.  driver="device_loop" runs the same scripted
    ladder through solve_on_device, each rung packed at its k on the
    device (the reference's escalate.py:209-222), with the same calls and
    rungs as the phase driver; an unknown driver raises."""
    script = [("stalled", 10, 1e-5), ("stalled", 7, 1e-9), ("optimal", 8, 1e-16)]
    solver = ScriptedSolver(script[:1] + script[2:], t_make)
    monkeypatch.setattr(t_escalate, "solverank1sdp", solver)
    res = t_escalate.solve_with_escalation(None, [1.0], None, k_ladder=(2,), host_ladder=(6,),
                                           verbose=False, device="cpu")
    assert [c["k"] for c in solver.calls] == [2, 6] and solver.calls[1]["warm_limbs"] == 6
    assert res.call == 1 and [r["k"] for r in res.rungs] == [2, 6]

    phase = ScriptedSolver(script, t_make)
    monkeypatch.setattr(t_escalate, "solverank1sdp", phase)
    want = t_escalate.solve_with_escalation(None, [1.0], None, k_ladder=(2, 3, 4),
                                            maxiterations=60, verbose=False, device="cpu")
    loop, packed = ScriptedSolver(script, t_make), []

    def pack(constraints, b, info, C, b0, k, device):
        packed.append((k, device))
        return types.SimpleNamespace(k=k)

    def solve_on_device(problem, initial_solutions, maxiterations, **kwargs):
        return loop(None, None, None, precision_k=problem.k,
                    initial_solutions=initial_solutions, maxiterations=maxiterations,
                    device="cpu", **kwargs)

    monkeypatch.setattr(t_escalate, "solverank1sdp", None)
    monkeypatch.setattr(t_escalate, "pack_constraints", pack)
    monkeypatch.setattr(t_escalate, "solve_on_device", solve_on_device)
    got = t_escalate.solve_with_escalation(None, [1.0], None, k_ladder=(2, 3, 4),
                                           maxiterations=60, verbose=False, device="cpu",
                                           driver="device_loop", chunk=5)
    assert packed == [(2, "cpu"), (3, "cpu"), (4, "cpu")]
    assert [c["chunk"] for c in loop.calls] == [5, 5, 5]
    for p, d in zip(phase.calls, loop.calls):
        for key in ("k", "maxiterations", "warm", "warm_limbs"):
            assert p[key] == d[key], (key, p[key], d[key])
        if p["warm_state"] is not None:
            for a, b in zip(p["warm_state"], d["warm_state"]):
                assert np.array_equal(a.view(np.uint64), b.view(np.uint64))
    strip = ("path", "k", "iterations", "status")
    assert [{key: r[key] for key in strip} for r in got.rungs] == \
        [{key: r[key] for key in strip} for r in want.rungs]
    assert got.call == want.call == 2
    with pytest.raises(ValueError, match="unknown driver"):
        t_escalate.solve_with_escalation(None, [1.0], None, driver="lax", device="cpu")


# ---------------------------------------------------------------------------
# The univariate PMP through the port's ladder to the full contract
# ---------------------------------------------------------------------------


@pytest.fixture
def mp_prec():
    """Sets mpmath's precision for one test, and restores it after."""
    old = mpmath.mp.prec

    def set_prec(bits):
        mpmath.mp.prec = bits

    yield set_prec
    mpmath.mp.prec = old


def test_univariate_pmp_ladder_full_contract(mp_prec):
    """y - x >= 0 on [0, 1] (tests/test_aux.py:71-95) under the default
    contract: at k=2 the dual error stalls on the dd floor, the k=3 rung
    warm-started from it ends optimal at -1, as the reference's host IPM
    at k=6 does."""
    mp_prec(200)
    x = MPoly.var(0, 1)
    one = MPoly.constant(1, 1)
    cons = [prepareabc([poly_matrix([[-x]]), poly_matrix([[one]])], [one, x * (one - x)],
                       [one, x], create_sample_points_chebyshev(2, 0, 1), 2)]
    res = t_escalate.solve_with_escalation(
        cons, [-1.0], get_block_info(cons), k_ladder=(2, 3), omega_p=100.0, omega_d=100.0,
        maxiterations=150, stall_patience=10, verbose=False, device="cpu")
    assert [(r["k"], r["status"]) for r in res.rungs] == [(2, "stalled"), (3, "optimal")]
    assert res.status == "optimal" and res.converged
    assert abs(res.dual_objective + 1.0) < 1e-12
    row = res.history[-1]
    assert row["gap"] < 1e-15 and max(row["P_err"], row["p_err"], row["d_err"]) < 1e-30

    jx = JMPoly.var(0, 1)
    jone = JMPoly.constant(1, 1)
    ref = j_solvempmp([[j_poly_matrix([[-jx]]), j_poly_matrix([[jone]])]],
                      [[jone, jx * (jone - jx)]], [[jone, jx]], [j_cheb(2, 0, 1)], [2], [-1.0],
                      backend="host", precision_k=6, omega_p=100.0, omega_d=100.0,
                      maxiterations=150, verbose=False)
    assert ref.status == "optimal"
    for key in ("dual_objective", "primal_objective"):
        assert abs(getattr(res, key) - getattr(ref, key)) < 1e-12, key


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_checkpoints_cross_packages_bitwise(tmp_path, mp_prec):
    mp_prec(128)
    r = [1, "0.41421356237309504880"]
    _, _, j_info = j_sphere(3, 1, r, 2, prec=128, build_only=True)
    _, _, t_info = t_sphere(3, 1, r, 2, prec=128, build_only=True)
    sizes = [[(n, n) for n in row] for row in t_info.Y_blocksizes]
    raw = random_state(((t_info.total_dim_S, 1), (t_info.n_y, 1), sizes), 2, 7)
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    t_checkpoint.save_state(port_path, as_xf(raw, t_make), t_info, meta={"iter": 7})
    j_checkpoint.save_state(ref_path, as_xf(raw, j_make), j_info, meta={"iter": 7})
    for path in (port_path, ref_path):
        want, want_meta = j_checkpoint.load_state(path, j_info)
        got, got_meta = t_checkpoint.load_state(path, t_info, device="cpu")
        assert got_meta == want_meta and got_meta["iter"] == 7 and got_meta["k"] == 2
        for w, g, a in zip(state_leaves(want), state_leaves(got), state_leaves(raw)):
            assert_bitwise(w, g)
            assert_bitwise(a, g)
        # re-rounded to k=3 on load: the limbs kept, a limb of exact zeros
        want3, _ = j_checkpoint.load_state(path, j_info, k=3)
        got3, _ = t_checkpoint.load_state(path, t_info, k=3, device="cpu")
        for w, g, a in zip(state_leaves(want3), state_leaves(got3), state_leaves(raw)):
            assert g.k == 3 and bool(torch.all(g.limbs[2] == 0))
            assert_bitwise(a, g.limbs[:2])
            assert_bitwise(w, g)
