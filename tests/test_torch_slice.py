"""The port's main path end to end on the CPU: the Delsarte LP bound
(dim 8, 2d=6) through clrs_tpu_torch against the JAX reference.

Per-iteration histories are compared over the first 20 iterations.  With
the kernel routing off the port repeats the reference's operations; the
low limbs still differ where XLA:CPU contracts multiply-adds into FMAs
inside the reference's compiled phases: 1e-12 relative.  With the routing
on (the kernels' plain versions on the CPU) the matmul sums run
sequentially instead of the product tree and the S/Q inverses by W^T W:
the same iterates to 1e-8 relative, with the same status.

The runs use feasibility thresholds of 1e-20, as tests/test_delsarte.py
does: at the default 1e-30 the feasibility errors sit at the
double-double noise floor (~1e-30 for this problem's scale), so whether
an iteration counts as primal-dual feasible -- which changes its step --
depends on low-limb rounding, and the two packages' paths part there.
"""

import os
import subprocess
import sys

import mpmath
import numpy as np
import pytest
import torch

from clrs_tpu.apps.delsarte import build_delsarte_constraints as j_build
from clrs_tpu.apps.delsarte import delsarte_lp_bound as j_bound
from clrs_tpu.core.problem import pack_constraints as j_pack
from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints as t_build
from clrs_tpu_torch.apps.delsarte import delsarte_lp_bound as t_bound
from clrs_tpu_torch.core.problem import pack_constraints as t_pack
from clrs_tpu_torch.interop import problem_from_numpy, state_from_numpy

from test_torch_xfloat import assert_bitwise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N, D, ITERS, COMPARED = 8, 3, 30, 20
SOLVE = dict(omega_p=100.0, omega_d=100.0, verbose=False, maxiterations=ITERS,
             primal_error_threshold=1e-20, dual_error_threshold=1e-20)
KEYS = ("mu", "p_obj", "d_obj", "gap", "alpha_p", "alpha_d")


@pytest.fixture(scope="module")
def reference_run():
    bound, res = j_bound(N, D, **SOLVE)
    return bound, res


def to_numpy_tree(problem):
    """The JAX-packed problem as nested dicts/lists of numpy limb arrays."""
    def a(x):
        return None if x is None else np.asarray(x.limbs)

    return dict(
        clusters=[dict(Vs=[a(v) for v in c.Vs], Hs=[a(h) for h in c.Hs],
                       B=a(c.B), c=a(c.c)) for c in problem.clusters],
        b=a(problem.b), b0=a(problem.b0),
        C_blocks=None if problem.C_blocks is None
        else [[a(x) for x in row] for row in problem.C_blocks],
        x_sigma=a(problem.x_sigma), y_R_inv=a(problem.y_R_inv), y_R=a(problem.y_R),
    )


def assert_history_close(ref, got, rel):
    assert len(got) >= COMPARED and len(ref) >= COMPARED
    for rj, rt in zip(ref[:COMPARED], got[:COMPARED]):
        for key in KEYS:
            a, b = rj[key], rt[key]
            assert abs(a - b) <= rel * max(abs(a), 1e-300), (rj["iter"], key, a, b)


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, clrs_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'clrs_tpu' or m.startswith('clrs_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_packing_and_interop_limb_for_limb():
    j_cons, j_b, j_info = j_build(N, D)
    t_cons, t_b, t_info = t_build(N, D)
    assert tuple(j_info.Y_blocksizes) == tuple(t_info.Y_blocksizes)
    jp = j_pack(j_cons, j_b, info=j_info, k=2, dtype=np.float64)
    tp = t_pack(t_cons, t_b, info=t_info, k=2, device=CPU)
    via = problem_from_numpy(to_numpy_tree(jp), t_info, device=CPU)
    for p in (tp, via):
        for cj, ct in zip(jp.clusters, p.clusters):
            for x, y in zip(cj.Vs + cj.Hs + (cj.B, cj.c), ct.Vs + ct.Hs + (ct.B, ct.c)):
                assert_bitwise(x, y)
        for name in ("b", "b0", "x_sigma", "y_R_inv", "y_R"):
            assert_bitwise(getattr(jp, name), getattr(p, name))
    x = np.zeros((2, t_info.total_dim_S, 1))
    y = np.zeros((2, t_info.n_y, 1))
    X = [[np.ones((2, 1, 1))] for _ in range(t_info.J)]
    sx, sy, sX, sY = state_from_numpy(x, y, X, X, device=CPU)
    assert sx.shape == (t_info.total_dim_S, 1) and sX[0][0].shape == (1, 1)


def test_slice_history_matches_reference(reference_run):
    _, jres = reference_run
    bound, tres = t_bound(N, D, use_cuda_matmul=False, device=CPU, **SOLVE)
    assert tres.status == jres.status
    assert tres.iterations == jres.iterations
    assert_history_close(jres.history, tres.history, 1e-12)
    assert abs(bound - 240.0) < 1e-3


def test_slice_kernel_route_matches_reference(reference_run):
    _, jres = reference_run
    bound, tres = t_bound(N, D, use_cuda_matmul=True, device=CPU, **SOLVE)
    assert tres.status == jres.status
    assert_history_close(jres.history, tres.history, 1e-8)
    assert abs(bound - 240.0) < 1e-3


@pytest.mark.parametrize("prec", [53, 256])
def test_packing_k3_limb_for_limb(prec):
    """Packing at k=3 matches the reference limb for limb.  Both pack at
    the ambient mpmath precision: the front-end restores mp.prec before
    the solver packs (clrs_tpu/apps/delsarte.py:36-71), so at the default
    53 bits the preconditioned data are 53-bit numbers and limbs 1 and 2 of
    b are zero, as in the reference; at 256 bits they are not."""
    j_cons, j_b, j_info = j_build(N, D)
    t_cons, t_b, t_info = t_build(N, D)
    old = mpmath.mp.prec
    mpmath.mp.prec = prec
    try:
        jp = j_pack(j_cons, j_b, info=j_info, k=3, dtype=np.float64)
        tp = t_pack(t_cons, t_b, info=t_info, k=3, device=CPU)
    finally:
        mpmath.mp.prec = old
    for cj, ct in zip(jp.clusters, tp.clusters):
        for x, y in zip(cj.Vs + cj.Hs + (cj.B, cj.c), ct.Vs + ct.Hs + (ct.B, ct.c)):
            assert_bitwise(x, y)
    for name in ("b", "b0", "x_sigma", "y_R_inv", "y_R"):
        assert_bitwise(getattr(jp, name), getattr(tp, name))
    assert tp.b.k == 3
    assert bool(torch.any(tp.b.limbs[1:] != 0)) == (prec > 53)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device=, solverank1sdp packs onto the CUDA card and
    delsarte_lp_bound solves there; on a machine without one both raise
    instead of running on the CPU."""
    from clrs_tpu_torch import solverank1sdp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cons, b, info = t_build(N, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solverank1sdp(cons, b, info, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_bound(N, 1, verbose=False)
