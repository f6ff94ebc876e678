"""The port's main path at k=3 on the CPU: one IPM iteration of the
Delsarte LP bound (dim 8, 2d=4), phase by phase, against the JAX
reference's phases run op by op (``jax.disable_jit``, so XLA:CPU fuses and
contracts nothing).

Both packages start from the same packed problem (the reference's, carried
over as numpy limbs) and the same cold start.  On the reference's route
(``use_cuda_matmul=False``: the expansion matmul's product tree, the
Cholesky inverses) every phase output is bitwise equal, except the step
lengths, whose float64 eigenvalues come from two LAPACK builds: those agree
to 1e-12 relative, and the update is fed the reference's step lengths.
Since they are held only to 1e-12, the reference's step-length phase runs
compiled: op by op it takes twice its compile time, and it is the costliest
phase of the iteration.  On
the kernel route (``use_cuda_matmul=True``: the plain versions of K4, K2 at
k=3 and K5) the sums run sequentially and the inverses as W^T W, so the
phases agree in value to 2^-140 relative (k=3 keeps ~159 bits).  The
all-kernels route (the kernel route with X^-1 through K5, the step
lengths through K7 and every k-limb add and multiply through K8) agrees to
the same 2^-140, its step lengths, a Jacobi bound instead of eigenvalues,
to 1e-10 of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.apps.delsarte import build_delsarte_constraints as j_build
from clrs_tpu.core.problem import pack_constraints as j_pack
from clrs_tpu.core.solver import SolverConfig as JSolverConfig
from clrs_tpu.core.solver import initial_state as j_initial_state
from clrs_tpu.core.solver import make_ipm_phases as j_phases
from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints as t_build
from clrs_tpu_torch.core.solver import SolverConfig, initial_state, make_ipm_phases
from clrs_tpu_torch.interop import problem_from_numpy
from clrs_tpu_torch.ops import cuda_dd, cuda_xf
from clrs_tpu_torch.ops.xfloat import XF, xf_add

from test_torch_slice import to_numpy_tree
from test_torch_xfloat import assert_bitwise
from test_torch_xfloat import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
N, D, K = 8, 2, 3
OPTS = dict(omega_p=100.0, omega_d=100.0, verbose=False)
REL_KERNEL_ROUTE = 2.0 ** -140


def run_iteration(phases, problem, state, pd_feas, alphas=None):
    """One IPM iteration's phases in the solver's order; alphas, if given,
    replace the step lengths before the update."""
    out = {}
    mu, R, X_inv, ok_inv = phases["mu_R_Xinv"](problem, state, pd_feas)
    out["mu_R_Xinv"] = (mu, R, X_inv)
    decomp = phases["decomp"](problem, X_inv, state[3])
    out["decomp"] = {key: decomp[key] for key in ("S_mat", "S_inv", "S_inv_B", "Q_inv",
                                                  "A_Y")}
    P, p, d = phases["residuals"](problem, state[0], state[2], state[1], decomp["A_Y"])
    out["residuals"] = (P, p, d)
    pred = phases["direction"](problem, P, p, d, R, X_inv, state[3], decomp)
    out["predictor"] = pred
    beta_c, R2 = phases["corrector_R"](state[2], state[3], pred[1], pred[3], mu, pd_feas)
    out["corrector_R"] = (beta_c, R2)
    dx, dX, dy, dY = phases["direction"](problem, P, p, d, R2, X_inv, state[3], decomp)
    out["corrector"] = (dx, dX, dy, dY)
    ap, ok_p, ad, ok_d = phases["steplength"](state[2], dX, state[3], dY)
    out["alpha"] = (float(ap), float(ad))
    oks = [bool(x) for x in (ok_inv, decomp["ok"], ok_p, ok_d)]
    if alphas is not None:
        ap, ad = (torch.tensor(a, dtype=torch.float64) for a in alphas)
    new_state, _ = phases["update"](problem, state, dx, dy, dX, dY, ap, ad, pd_feas,
                                    P, p, d, mu, beta_c)
    out["update"] = new_state
    return out, oks


def leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module")
def reference():
    cons, b, info = j_build(N, D)
    jp = j_pack(cons, b, info=info, k=K, dtype=np.float64)
    cfg = JSolverConfig(**OPTS, use_pallas_matmul=False)
    phases = j_phases(jp, cfg)

    def compiled_steplength(X, dX, Y, dY):  # both sides, as the port's phase takes them
        with jax.disable_jit(False):
            return phases["steplength"](X, dX) + phases["steplength"](Y, dY)

    with jax.disable_jit():
        out, oks = run_iteration(dict(phases, steplength=compiled_steplength), jp,
                                 j_initial_state(jp, cfg), jnp.bool_(False))
    return to_numpy_tree(jp), out, oks


@pytest.fixture(scope="module")
def port_problem(reference):
    _, _, info = t_build(N, D)
    return problem_from_numpy(reference[0], info, device=CPU)


def port_iteration(problem, use_cuda, alphas, **routes):
    cfg = SolverConfig(**OPTS, use_cuda_matmul=use_cuda, **routes)
    return run_iteration(make_ipm_phases(problem, cfg), problem,
                         initial_state(problem, cfg), False, alphas)


def assert_phases_close(ref, got, rel):
    for phase in ref:
        if phase == "alpha":
            continue
        rl, gl = list(leaves(ref[phase])), list(leaves(got[phase]))
        assert len(rl) == len(gl), phase
        for r, g in zip(rl, gl):
            r = XF(torch.from_numpy(np.array(r.limbs)))
            scale = float(torch.max(torch.abs(r.limbs[0]))) or 1.0
            diff = float(torch.max(torch.abs(xf_add(r, -g).limbs[0])))
            assert diff <= rel * scale, (phase, diff / scale)


def test_k3_iteration_phases_bitwise(reference, port_problem):
    _, ref, ref_oks = reference
    assert port_problem.b.k == K
    got, oks = port_iteration(port_problem, False, ref["alpha"])
    assert oks == ref_oks == [True] * 4
    for (ra, ga) in zip(ref["alpha"], got["alpha"]):
        assert abs(ra - ga) <= 1e-12 * abs(ra), (ra, ga)
    for phase in ref:
        if phase == "alpha":
            continue
        rl, gl = list(leaves(ref[phase])), list(leaves(got[phase]))
        assert len(rl) == len(gl), phase
        for r, g in zip(rl, gl):
            assert_bitwise(r, g)


def test_k3_iteration_kernel_route_matches(reference, port_problem):
    _, ref, ref_oks = reference
    got, oks = port_iteration(port_problem, True, ref["alpha"])
    assert oks == ref_oks
    for (ra, ga) in zip(ref["alpha"], got["alpha"]):
        assert abs(ra - ga) <= 1e-12 * abs(ra), (ra, ga)
    assert_phases_close(ref, got, REL_KERNEL_ROUTE)


def test_k3_iteration_all_kernels_route_matches(reference, port_problem, monkeypatch):
    """Every kernel's plain version on the route the card takes with
    use_cuda_inverse, use_cuda_steplength and use_cuda_elemwise: K7's and
    K8's plain versions must run, and on the CPU no launch is counted."""
    _, ref, ref_oks = reference
    calls = {"elemwise_xf_torch": 0, "steplen_sandwich_xf_torch": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(cuda_xf, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(cuda_xf, name, counted)
    counts = (cuda_xf.elemwise_xf.launches, cuda_xf.steplen_sandwich_xf.launches,
              cuda_dd.dd_spd_inverse_wide.launches)
    got, oks = port_iteration(port_problem, True, ref["alpha"], use_cuda_inverse=True,
                              use_cuda_steplength=True, use_cuda_elemwise=True)
    assert oks == ref_oks
    for (ra, ga) in zip(ref["alpha"], got["alpha"]):
        assert abs(ra - ga) <= 1e-10 * abs(ra), (ra, ga)
    assert_phases_close(ref, got, REL_KERNEL_ROUTE)
    assert calls["elemwise_xf_torch"] > 0 and calls["steplen_sandwich_xf_torch"] == 4, calls
    assert counts == (cuda_xf.elemwise_xf.launches, cuda_xf.steplen_sandwich_xf.launches,
                      cuda_dd.dd_spd_inverse_wide.launches)
