"""The cluster-sharded steps of the port (clrs_tpu_torch/parallel/) on the
CPU: against the JAX reference's (clrs_tpu/parallel/sharded.py and
hetero.py on a one-device mesh), against the port's own solver, and two
gloo ranks against one, bit for bit.

Mirrors tests/test_sharding.py, tests/test_hetero_sharding.py,
tests/test_multihost.py and tests/test_multiprocess.py.  The step
lengths' float64 eigenvalues come from two LAPACK builds (the packages
part there in the last bits, tests/test_torch_slice_k.py), so the
comparisons with the reference give the port the reference's eigensolver
(jax.numpy.linalg.eigvalsh on the same float64 matrix); everything else
is the port's.  The reference's steps run compiled (op by op they take
far longer than their compiles), and XLA:CPU contracts multiply-adds
there, so the low limbs agree to the tolerances of the reference's own
tests, not bitwise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from clrs_tpu.parallel import sharded as jsharded
from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints
from clrs_tpu_torch.core.blockinfo import get_block_info
from clrs_tpu_torch.core.problem import pack_constraints
from clrs_tpu_torch.core.solver import SolverConfig, initial_state, make_ipm_phases
from clrs_tpu_torch.interop import problem_from_numpy
from clrs_tpu_torch.ops import linalg as tlinalg
from clrs_tpu_torch.parallel import hetero, multihost, sharded
from clrs_tpu_torch.tools import mp_hetero_worker as worker
from clrs_tpu_torch.tools import ranks_vs_one

import reference_hetero_step
from test_torch_slice import to_numpy_tree
from test_torch_xfloat import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
OPTS = dict(omega_p=100.0, omega_d=100.0, verbose=False)
SHAPE = dict(J=8, n_y=3, m=1, K=3, delta=3, rmax=1)  # tests/test_sharding.py:18-32
STEPS = 3
DIAG = ("mu", "p_obj", "d_obj", "alpha_p", "alpha_d")
# the rank worker's options for two_rank_result
WORKER_ARGS = ("--device", "cpu", "--steps", str(STEPS), "--what",
               "sharded,hetero,solve,intra,bands", "--max-iterations", "4")


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """Work started before the module's first test, in processes of its
    own, so that it runs while this process compiles the reference's
    sharded step: the rank worker's processes of two_rank_result, and one
    step of the reference's hetero step (tests/reference_hetero_step.py)."""
    from concurrent.futures import ThreadPoolExecutor

    hetero = reference_hetero_step.start(tmp_path_factory.mktemp("hetero"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(ranks_vs_one.run, 2, tmp_path_factory.mktemp("ranks"),
                            list(WORKER_ARGS), timeout=300, together=True)
        yield types.SimpleNamespace(ranks=ranks, hetero=hetero)
        ranks.exception()  # wait for the processes before the module ends
        hetero.close()


def reference_eigvalsh(a):
    return torch.from_numpy(np.array(jnp.linalg.eigvalsh(jnp.asarray(a.to_float64().numpy()))))


@pytest.fixture
def reference_eigensolver(monkeypatch):
    monkeypatch.setattr(tlinalg, "xf_eigvalsh_approx", reference_eigvalsh)


def assert_values_close(a, b, rtol, atol):
    """Two expansions (k, ...) equal as values to rtol/atol: the limbs'
    differences summed against the leading limb's magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[0], b[0])
    err = np.sum(np.abs(a - b), axis=0)
    assert np.all(err <= atol + rtol * np.abs(a[0])), float(np.max(err))


def test_sharded_step_matches_reference(reference_eigensolver):
    """3 homogeneous steps of the port against clrs_tpu.parallel.sharded's
    on one device, every leaf to rtol 1e-25 / atol 1e-28 as values (the
    reference's 1-vs-8 tolerance), the diagnostics bitwise."""
    shape = jsharded.HomogeneousShape(**SHAPE)
    data = jsharded.random_homogeneous_problem(shape, seed=1, k=2)
    mesh = jsharded.make_cluster_mesh(1)
    # placed as the step places its outputs, so that the three calls share
    # one compile (a fresh array's single-device placement compiles anew)
    state = jax.device_put(jsharded.initial_sharded_state(shape, k=2), NamedSharding(mesh, P()))
    step = jsharded.make_sharded_step(shape, mesh)

    tshape = sharded.HomogeneousShape(**SHAPE)
    tdata = sharded.random_homogeneous_problem(tshape, seed=1, k=2, device=CPU)
    for name in ("V", "H", "B", "c", "b"):
        np.testing.assert_array_equal(np.asarray(data[name].limbs), tdata[name].limbs.numpy())
    tstate = sharded.initial_sharded_state(tshape, k=2, device=CPU)
    tstep = sharded.make_sharded_step(tshape)
    for _ in range(STEPS):
        state, diag = step(data, state, jnp.bool_(False))
        tstate, tdiag = tstep(tdata, tstate, False)
        for a, b in zip(state, tstate):
            assert_values_close(a.limbs, b.limbs.numpy(), 1e-25, 1e-28)
        for key in DIAG:
            assert float(np.asarray(diag[key])) == float(tdiag[key]), key
        assert bool(np.asarray(diag["ok"])) and bool(tdiag["ok"])


def test_sharded_step_length_route(monkeypatch):
    """The homogeneous step with use_cuda_steplength: K7's sandwich (its
    plain version on the CPU) and the float64 Jacobi bound take both sides'
    step lengths in one call a step; 3 steps follow the default route's
    eigensolver to rtol 1e-12 in every diagnostic."""
    calls = []

    def counted(groups):
        calls.append(len(groups))
        return sharded_groups(groups)

    sharded_groups = sharded.steplen_sandwich_xf_groups
    monkeypatch.setattr(sharded, "steplen_sandwich_xf_groups", counted)
    shape = sharded.HomogeneousShape(**SHAPE)
    data = sharded.random_homogeneous_problem(shape, seed=1, k=2, device=CPU)
    runs = []
    for flag in (False, True):
        state = sharded.initial_sharded_state(shape, k=2, device=CPU)
        step = sharded.make_sharded_step(shape, cfg=SolverConfig(use_cuda_steplength=flag))
        diags = []
        for _ in range(STEPS):
            state, diag = step(data, state, False)
            assert bool(diag["ok"])
            diags.append(diag)
        runs.append(diags)
    assert calls == [2] * STEPS
    for a, b in zip(*runs):
        for key in DIAG:
            np.testing.assert_allclose(float(b[key]), float(a[key]), rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def delsarte():
    """Delsarte dim 8, 2d=6 (tests/test_hetero_sharding.py:24-34): one
    polynomial cluster and six sign clusters, two shape signatures; packed
    by the port, limb for limb the reference's (test_torch_slice)."""
    cons, b, info = build_delsarte_constraints(8, 3)
    return pack_constraints(cons, b, info=info, k=2, device=CPU)


def port_steps(problem, n_steps, cfg=None):
    cfg = cfg or SolverConfig(**OPTS)
    shapes, data, _ = hetero.bundles_from_problem(problem)
    state = hetero.initial_bundle_state(shapes, cfg.omega_p, cfg.omega_d, problem.b.k,
                                        problem.info.n_y, device=CPU)
    step = hetero.make_hetero_step(shapes, problem.b, cfg, b0=problem.b0)
    out = []
    for _ in range(n_steps):
        state, diag = step(data, state, False)
        out.append((state, diag))
    return out


def test_hetero_step_matches_reference(delsarte, background, reference_eigensolver):
    """One hetero step of the port against clrs_tpu.parallel.hetero's on a
    one-device mesh (tests/reference_hetero_step.py, in a process of its
    own since the module's start): y's hi + lo to 1e-28 of max|y| and the
    diagnostics to rtol 1e-12 (tests/test_hetero_sharding.py:53-72); in
    fact the diagnostics and y's leading limbs agree bitwise."""
    import bench

    problem, _ = bench.build_problem(d=3, dtype=np.float64, k=2)
    yj, diag = background.hetero.result()

    port = problem_from_numpy(to_numpy_tree(problem), delsarte.info, device=CPU)
    (_, ty), tdiag = port_steps(port, 1)[0]
    yt = ty.limbs.numpy()
    np.testing.assert_array_equal(yj[0], yt[0])
    scale = np.max(np.abs(yj.sum(axis=0)))
    np.testing.assert_allclose(yj.sum(axis=0), yt.sum(axis=0), rtol=0, atol=1e-28 * scale)
    for key in DIAG + ("gap",):
        a, b = float(np.asarray(diag[key])), float(tdiag[key])
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-20)
        assert a == b, key
    assert bool(np.asarray(diag["ok"])) and bool(tdiag["ok"])


def test_hetero_matches_general_solver(delsarte):
    """One hetero step == one step of the port's phases on the same packed
    problem (tests/test_hetero_sharding.py:74-102's tolerances)."""
    (_, y), diag = port_steps(delsarte, 1)[0]
    cfg = SolverConfig(**OPTS)
    phases = make_ipm_phases(delsarte, cfg)
    st = initial_state(delsarte, cfg)
    mu, R, X_inv, ok = phases["mu_R_Xinv"](delsarte, st, False)
    decomp = phases["decomp"](delsarte, X_inv, st[3])
    P, p, d = phases["residuals"](delsarte, st[0], st[2], st[1], decomp["A_Y"])
    dx, dX, dy, dY = phases["direction"](delsarte, P, p, d, R, X_inv, st[3], decomp)
    beta_c, R2 = phases["corrector_R"](st[2], st[3], dX, dY, mu, False)
    dx, dX, dy, dY = phases["direction"](delsarte, P, p, d, R2, X_inv, st[3], decomp)
    ap, _, ad, _ = phases["steplength"](st[2], dX, st[3], dY)
    st2, gdiag = phases["update"](delsarte, st, dx, dy, dX, dY, ap, ad, False, P, p, d, mu,
                                  beta_c)
    np.testing.assert_allclose(y.limbs[0].numpy().ravel(), st2[1].limbs[0].numpy().ravel(),
                               rtol=1e-18, atol=1e-22)
    assert abs(float(diag["mu"]) - float(gdiag["mu"])) < 1e-10 * max(1.0, abs(float(gdiag["mu"])))


def nonzero_C_problem():
    """The LP-as-SDP of tests/test_hetero_sharding.py:123-149: C != 0 and
    b0 = 10, optimum 2.3 + b0 = 12.3 at x = (0.7, 0.3)."""
    vs = [np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    A = [[[np.asarray(v, dtype=object).reshape(-1)] for v in vs]]
    H = [[[1.0], [1.0]]]
    cons = [(A, np.asarray([[1.0], [1.0]], dtype=object),
             np.asarray([2.0, 3.0], dtype=object), H)]
    C = [[np.array([[0.2, 0.0], [0.0, 0.3]], dtype=object)]]
    return pack_constraints(cons, [1.0], info=get_block_info(cons), C=C, b0=10.0, device=CPU)


def assert_nonzero_C_solved(out):
    assert out.converged, out.status
    assert abs(out.primal_objective - 12.3) < 1e-9
    assert abs(out.dual_objective - 12.3) < 1e-9
    x = out.x.to_float64().numpy().ravel()
    assert abs(x[0] - 0.7) < 1e-7 and abs(x[1] - 0.3) < 1e-7
    assert out.P is not None and out.p is not None and out.d is not None


def test_hetero_nonzero_C():
    """C != 0 and b0 through the sharded solve (tests/test_hetero_sharding.py:
    123-149): the LP-as-SDP with optimum 2.3 + b0 = 12.3."""
    out = hetero.solve_hetero_sharded(nonzero_C_problem(), maxiterations=200,
                                      cfg=SolverConfig(**OPTS))
    assert_nonzero_C_solved(out)


def test_multihost_solve_single_process():
    """The multihost entry point in one process (tests/test_multihost.py:
    47-54): no group, the same solve as solve_hetero_sharded's."""
    out = multihost.solve_hetero_multihost(nonzero_C_problem(), maxiterations=200,
                                           cfg=SolverConfig(**OPTS))
    assert_nonzero_C_solved(out)


# ---------------------------------------------------------------------------
# Two gloo ranks against one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_rank_result(background):
    """Both steps, 3 each, 4 iterations of solve_hetero_multihost, 3 intra
    steps and the panel forms' row bands, on 2 gloo ranks of the rank
    worker (one process each), beside the same on one rank alone
    (tools/ranks_vs_one.py), launched once when the module starts."""
    _, one, ranks = background.ranks.result()
    return one, ranks


@pytest.mark.parametrize("what", ["sharded", "hetero", "solve", "intra", "bands"])
def test_two_ranks_bitwise_one(two_rank_result, what):
    """Every iterate and diagnostic of 3 steps on 2 ranks, bit for bit the
    one rank's: each rank holds its contiguous slice of every bundle (the
    padded slots of Delsarte's 1-cluster bundle on rank 1 dropped), and
    the reduced values are replicated.  The solve's result (status,
    objectives, history, and the iterate and residuals gathered at its
    end) is the one rank's on every rank.  The intra steps (Delsarte 2d=6
    at k=2, T padded to a multiple of 4, parallel/intra.py) and the panel
    Cholesky and panel-route SPD inverse with row bands (64 and 40 rows;
    40 splits unevenly at every panel) hold every leaf whole on every rank,
    each the one rank's."""
    one, ranks = two_rank_result
    keys = [key for key in one if key.startswith(what + "/")]
    assert len(keys) > (3 if what == "bands" else 10)
    assert worker.differing(one, ranks, what + "/") == []
    if what == "hetero":  # the padding path: the 1-cluster bundle is padded on rank 1
        assert ranks[1]["hetero/0/state/0/0/0"].shape[1] == 1


def test_multihost_single_process():
    """One process: nothing to initialize, no groups, the world is one rank
    (tests/test_multihost.py)."""
    assert multihost.init_multihost("cpu") == 0
    assert multihost.global_cluster_group() is None
    assert multihost.host_chip_groups() == (None, None)
    assert sharded.world(None) == (1, 0)
    assert multihost.local_device("cpu") == CPU
    _, _, info = build_delsarte_constraints(8, 3)
    sets = multihost.assign_clusters_to_hosts(info, 2)
    assert sorted(j for s in sets for j in s) == list(range(info.J))
    # the one big polynomial cluster dominates: the balancer puts every
    # sign cluster on the other host
    assert min(len(s) for s in sets) == 1


def test_multihost_rejects_a_problem_on_another_card(monkeypatch):
    """A rank whose LOCAL_RANK is 1 given a problem packed on cuda:0 raises
    before it joins any group: its collectives would run on another rank's
    card.  The card is faked: nothing here touches one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")

    def joined(*args, **kwargs):
        raise AssertionError("joined a group")

    monkeypatch.setattr(multihost, "init_multihost", joined)
    monkeypatch.setattr(hetero, "solve_hetero_sharded", joined)
    problem = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="cuda:1"):
        multihost.solve_hetero_multihost(problem)
    assert multihost.local_device("cuda") == torch.device("cuda", 1)
