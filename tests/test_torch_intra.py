"""The intra-cluster split of the port (clrs_tpu_torch/parallel/intra.py)
on the CPU, without torch.distributed: the rank padding against the JAX
reference's (clrs_tpu/parallel/intra.py), padding as an exact no-op on
the port's fused step, the rows each rank forms, and the driver.

Mirrors tests/test_intra_sharding.py.  Two gloo ranks against one, bit for
bit, ride on tests/test_torch_parallel.py's launch of the rank worker
(--what intra,bands).  The link from one rank to the reference is the
fused step that tests/test_torch_slice.py holds against the reference's
(test_slice_history_matches_reference): the split runs that step, and no
reference step is compiled here.
"""

import dataclasses

import mpmath
import numpy as np
import pytest
import torch

from clrs_tpu.apps.delsarte import build_delsarte_constraints as j_build
from clrs_tpu.parallel.intra import pad_info_ranks as j_pad
from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints
from clrs_tpu_torch.core import kernels as tk
from clrs_tpu_torch.core.problem import pack_constraints
from clrs_tpu_torch.core.solver import SolverConfig, initial_state, make_fused_step
from clrs_tpu_torch.ops import linalg as tlinalg
from clrs_tpu_torch.ops.xfloat import XF
from clrs_tpu_torch.ops import bands
from clrs_tpu_torch.parallel import intra

from test_torch_xfloat import assert_bitwise
from test_torch_xfloat import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
CFG = SolverConfig(omega_p=100.0, omega_d=100.0, verbose=False)
STEPS = 3


@pytest.mark.parametrize("d", [3, 5])
def test_pad_info_ranks_matches_reference(d):
    """pad_info_ranks field for field the reference's, at multiples that
    divide K, that do not, and 1 (no padding)."""
    _, _, info = build_delsarte_constraints(8, d)
    _, _, jinfo = j_build(8, d)
    for multiple in (1, 2, 3, 4, 8, 11):
        got = dataclasses.asdict(intra.pad_info_ranks(info, multiple))
        want = dataclasses.asdict(j_pad(jinfo, multiple))
        assert got.keys() == want.keys()
        for key in want:
            assert np.array_equal(np.asarray(got[key], dtype=object),
                                  np.asarray(want[key], dtype=object)), (multiple, key)
        padded = intra.pad_info_ranks(info, multiple)
        for j in range(info.J):
            assert all(K * r % multiple == 0
                       for K, r in zip([padded.n_samples[j]] * info.L[j], padded.rmax[j]))


def leaves(tree):
    if isinstance(tree, XF):
        return [tree.limbs]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    return [x for v in tree for x in leaves(v)]


def fused_steps(problem, n_steps=STEPS):
    state = initial_state(problem, CFG)
    step = make_fused_step(problem, CFG)
    out = []
    for _ in range(n_steps):
        state, diag = step(state, False)
        out.append((state, diag))
    return out


@pytest.fixture(scope="module")
def problems():
    """Delsarte dim 8, 2d=6 at k=2 packed as-is and with T padded to a
    multiple of 8 (tests/test_intra_sharding.py:27-36)."""
    cons, b, info = build_delsarte_constraints(8, 3)
    with mpmath.workprec(53):
        base = pack_constraints(cons, b, info=info, k=2, device=CPU)
        padded = pack_constraints(cons, b, info=intra.pad_info_ranks(info, 8), k=2, device=CPU)
    return base, padded


@pytest.fixture(scope="module")
def padded_steps(problems):
    return fused_steps(problems[1])


def test_rank_padding_is_exact(problems, padded_steps):
    """The padded slots (V = 0, H = 0) change no bit of 3 fused steps:
    every iterate and diagnostic equals the unpadded problem's (the
    reference's test allows 1e-28 relative)."""
    base, padded = problems
    assert padded.info.n_samples[0] * padded.info.rmax[0][0] % 8 == 0
    assert padded.info.rmax != base.info.rmax
    for (s1, d1), (s2, d2) in zip(fused_steps(base), padded_steps):
        for a, b in zip(leaves((s1, d1)), leaves((s2, d2))):
            assert_bitwise(a.numpy(), b)


@dataclasses.dataclass(frozen=True)
class Split(intra.IntraPlan):
    """A plan of a world of several ranks in one process: it records each
    gather's part and returns the part world times, so only the shapes
    downstream mean anything."""

    parts: list = dataclasses.field(default_factory=list)

    def gather(self, part, dim):
        self.parts.append((tuple(part.shape), dim % part.ndim))
        return torch.cat([part] * self.world, dim=dim)


@pytest.mark.parametrize("use_cuda", [False, True])
def test_plan_splits_the_rows(problems, use_cuda):
    """Under a plan of two ranks each forms half of ZV's columns, of P's
    rows and of the Schur rows (before their t1 rank sums), and gathers
    them; an axis the ranks do not divide (T = 7 unpadded) is computed
    whole with no gather."""
    base, padded = problems
    for problem, split in ((padded, True), (base, False)):
        V, H = problem.clusters[0].Vs[0], problem.clusters[0].Hs[0]
        delta, T = V.shape
        Z = XF.from_float(torch.eye(delta, dtype=torch.float64), k=2)
        plan = Split(None, 1, 2)
        K, rmax = problem.info.n_samples[0], problem.info.rmax[0][0]
        P = tk.compute_pairings(Z, V, 1, tk.matmul_route(use_cuda), plan=plan)
        tk.schur_block_contribution(P, P, H, 1, K, rmax, use_cuda, plan=plan)
        # (limbs, ...): ZV's columns, P's rows, the Schur rows
        want = [((2, delta, T // 2), 2), ((2, T // 2, T), 1), ((2, 1, T // 2, 1, K), 2)]
        assert plan.parts == (want if split else []), plan.parts


def test_intra_driver_one_rank(problems, padded_steps):
    """solve_intra_sharded on one rank runs the fused step: its state after
    3 iterations is the 3 steps' bit for bit (its convergence to the bound
    240 on two ranks is chip_smoke.py's phase 16)."""
    _, padded = problems
    state, out = intra.solve_intra_sharded(padded, maxiterations=STEPS, cfg=CFG)
    assert out["iterations"] == STEPS
    for a, b in zip(leaves(state), leaves(padded_steps[-1][0])):
        assert_bitwise(a.numpy(), b)
    shard = intra.shard_problem(padded)
    assert shard.plan == intra.IntraPlan(None, 0, 1) and shard.plan.band(8) is None
    assert intra.shard_state(state) is state and intra.make_chip_group() is None


def test_panel_bands_refuse_a_rank_count_that_does_not_divide(monkeypatch):
    """The plain panel Cholesky with row bands needs the padded order to
    divide the ranks (the reference's assert, linalg.py:157); the solver's
    xf_cholesky computes the updates whole there instead."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((20, 20))
    a = XF.from_float(torch.from_numpy(m @ m.T + 20 * np.eye(20)), k=2)
    monkeypatch.setattr(tlinalg, "size_rank", lambda group=None: (5, 0) if group else (1, 0))
    with pytest.raises(ValueError, match="does not divide"):
        tlinalg.xf_cholesky_panel(a, panel=8, group="five ranks")  # 24 rows
    monkeypatch.setattr(tlinalg, "_PANEL_MIN_N", 16)
    monkeypatch.setattr(tlinalg, "_PANEL_DEFAULT", 8)
    L, ok = tlinalg.xf_cholesky(a, group="five ranks")
    monkeypatch.setattr(tlinalg, "size_rank", bands.size_rank)
    assert bool(ok.all())
    assert_bitwise(tlinalg.xf_cholesky_panel(a, panel=8)[0].limbs.numpy(), L)
