"""The port's applications and front-end on the CPU, against the JAX
reference: sphere packing (clrs_tpu/apps/sphere_packing.py), SDPB export
and import, polymin and the multivariate solvempmp, the mpmath oracle.

- The sphere-packing constraint data, block metadata and packed problem
  are the reference's limb for limb (at d=2 and d=8, k=2 and k=6), built
  at the precision of the ladder's top rung, 53*10 + 150 bits.
- SDPB files read the same in both packages, whichever package wrote them.
- polymin and solvempmp hand the solver the reference's data.
- The port's sphere-packing solve at 2d=4 follows the reference's IPM
  (its host path at k=2) to 1e-12 relative over 4 iterations, and the
  oracle copy gives exactly the reference oracle's result.
"""

import dataclasses
import os
import types

import mpmath
import numpy as np
import pytest
import torch

from clrs_tpu.apps import sdpb_export as j_export
from clrs_tpu.apps import sdpb_import as j_import
from clrs_tpu.apps.polymin import polymin_simplex as j_polymin
from clrs_tpu.apps.sphere_packing import nsphere_packing_2point as j_sphere
from clrs_tpu.core.blockinfo import get_block_info as j_info_of
from clrs_tpu.core.problem import _pack_from_data as j_pack_from
from clrs_tpu.core.problem import prepare_pack_data as j_prepare
from clrs_tpu.models import mpmp as j_mpmp
from clrs_tpu.models.bases import make_monomial_basis as j_monomials
from clrs_tpu.models.poly import MPoly as JMPoly
from clrs_tpu.models.poly import poly_matrix as j_poly_matrix
from clrs_tpu.models.samples import create_sample_points as j_simplex_points
from clrs_tpu.utils.oracle import solve_oracle as j_oracle
from clrs_tpu_torch.apps import sdpb_export as t_export
from clrs_tpu_torch.apps import sdpb_import as t_import
from clrs_tpu_torch.apps.polymin import polymin_simplex as t_polymin
from clrs_tpu_torch.apps.sphere_packing import nsphere_packing_2point as t_sphere
from clrs_tpu_torch.core.blockinfo import get_block_info as t_info_of
from clrs_tpu_torch.core.problem import _pack_from_data as t_pack_from
from clrs_tpu_torch.core.problem import prepare_pack_data as t_prepare
from clrs_tpu_torch.models import mpmp as t_mpmp
from clrs_tpu_torch.models.bases import make_monomial_basis as t_monomials
from clrs_tpu_torch.models.poly import MPoly
from clrs_tpu_torch.models.poly import poly_matrix as t_poly_matrix
from clrs_tpu_torch.models.samples import create_sample_points as t_simplex_points
from clrs_tpu_torch.utils.oracle import solve_oracle as t_oracle

from test_torch_escalate import mp_prec  # noqa: F401 (a fixture)
from test_torch_slice import KEYS, to_numpy_tree
from test_torch_xfloat import assert_bitwise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SP_PREC = 53 * 10 + 150  # the ladder's top rung, k=10, plus a margin
RADII = (1, "0.41421356237309504880168872420969807856967187537694807317667973799")


def same_data(a, b):
    """Deep equality of host constraint data: nested tuples, lists and
    object arrays of mpmath numbers, compared exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a, dtype=object), np.asarray(b, dtype=object)
        return a.shape == b.shape and all(map(same_data, a.reshape(-1), b.reshape(-1)))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(map(same_data, a, b)))
    return mpmath.mpf(a) == mpmath.mpf(b)


def same_info(j_info, t_info):
    return dataclasses.asdict(j_info) == dataclasses.asdict(t_info)


def assert_problem_bitwise(jp, tp):
    tree = to_numpy_tree(jp)
    for cj, ct in zip(tree["clusters"], tp.clusters):
        for x, y in zip(cj["Vs"] + cj["Hs"] + [cj["B"], cj["c"]],
                        list(ct.Vs) + list(ct.Hs) + [ct.B, ct.c]):
            assert_bitwise(x, y)
    for name in ("b", "b0", "x_sigma", "y_R_inv", "y_R"):
        assert_bitwise(tree[name], getattr(tp, name))


@pytest.fixture(scope="module", params=[2, 8])
def sphere_front_end(request):
    """Both packages' constraints, b, blockinfo and preconditioned pack data
    at d, built once per module at SP_PREC bits and shared by the tests
    below (at d=8 each package's preconditioning, an mpmath QR of B, takes
    ~3-4 s)."""
    old = mpmath.mp.prec
    mpmath.mp.prec = SP_PREC
    try:
        j_cons, j_b, j_info = j_sphere(3, request.param, RADII, 2, prec=SP_PREC, build_only=True)
        t_cons, t_b, t_info = t_sphere(3, request.param, RADII, 2, prec=SP_PREC, build_only=True)
        return dict(j=(j_cons, j_b, j_info), t=(t_cons, t_b, t_info),
                    j_data=j_prepare(j_cons, j_b, info=j_info),
                    t_data=t_prepare(t_cons, t_b, info=t_info))
    finally:
        mpmath.mp.prec = old


def test_sphere_packing_front_end_limb_for_limb(sphere_front_end):
    """The same constraints, b and blockinfo."""
    j_cons, j_b, j_info = sphere_front_end["j"]
    t_cons, t_b, t_info = sphere_front_end["t"]
    assert same_info(j_info, t_info) and same_data(j_b, t_b)
    assert same_data([c[:4] for c in j_cons], [c[:4] for c in t_cons])


@pytest.mark.parametrize("k", [2, 6])
def test_sphere_packing_packed_limb_for_limb(sphere_front_end, k, mp_prec):
    """The same packed problem at k=2 and k=6, packed at SP_PREC bits."""
    mp_prec(SP_PREC)
    tp = t_pack_from(sphere_front_end["t_data"], k, CPU)
    assert_problem_bitwise(j_pack_from(sphere_front_end["j_data"], k, np.float64), tp)
    assert tp.b.k == k and bool(torch.any(tp.b.limbs[k - 1] != 0))


def test_sdpb_sp16_artifact_reads_the_same():
    path = os.path.join(REPO, "artifacts", "sdpb_sp16", "native")
    j_cons, j_b, j_info, j_b0 = j_import.read_sdpb_dir(path)
    t_cons, t_b, t_info, t_b0 = t_import.read_sdpb_dir(path)
    assert j_info.J == 7 and same_info(j_info, t_info)
    assert same_data(j_cons, t_cons) and same_data(j_b, t_b) and same_data(j_b0, t_b0)


def lp_problem():
    """tests/test_sdpb_io.py's tiny LP: rank 1, weight 1, one block."""
    vs = [np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    A = [[[np.asarray(v, dtype=object).reshape(-1)] for v in vs]]
    H = [[[mpmath.mpf(1)] for _ in vs]]
    return [(A, np.asarray([[1.0], [2.0]], dtype=object), np.asarray([1.0, 1.0], dtype=object),
             H)], [1.0]


@pytest.mark.parametrize("fmt", ["native", "sdpb2"])
def test_sdpb_files_cross_packages(fmt, tmp_path, mp_prec):
    """Files written by either package are the same bytes (numbers at 50
    digits), and read back the same by both.  native carries sphere packing at 2d=2 (m = 2,
    weights), sdpb2 the rank-1 weight-1 LP it can hold."""
    mp_prec(200)
    if fmt == "native":
        cons, b, _ = t_sphere(3, 1, RADII, 2, prec=200, build_only=True)
    else:
        cons, b = lp_problem()
    for writer, sub in ((j_export, "ref"), (t_export, "port")):
        writer.write_sdpb_files(str(tmp_path / sub), cons, writer_info(writer, cons), b,
                                b0=0.5, format=fmt)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    reads = [reader.read_sdpb_dir(str(tmp_path / sub))
             for reader in (j_import, t_import) for sub in ("ref", "port")]
    for cons2, b2, info2, b02 in reads[1:]:
        assert same_data(cons2, reads[0][0]) and same_data(b2, reads[0][1])
        assert same_data(b02, reads[0][3]) and same_info(info2, reads[0][2])


def writer_info(writer, cons):
    return (j_info_of if writer is j_export else t_info_of)(cons)


def capture_solver(monkeypatch, module):
    """Replaces the solver that module's solvempmp calls: the first call
    records its arguments and returns a stand-in result."""
    seen = {}

    def fake(abc, b, blockinfo, **kwargs):
        seen.update(abc=abc, b=b, info=blockinfo, kwargs=kwargs)
        return types.SimpleNamespace(dual_objective=0.0)

    monkeypatch.setattr(module, "solverank1sdp", fake)
    return seen


def test_polymin_and_multivariate_solvempmp_prepare_the_same(monkeypatch, mp_prec):
    """polymin_simplex on tests/test_polymin.py's quadratic, and solvempmp
    on tests/test_aux.py's two-variable PMP, hand the solver the
    reference's data and options."""
    mp_prec(200)
    j_seen, t_seen = capture_solver(monkeypatch, j_mpmp), capture_solver(monkeypatch, t_mpmp)

    def quadratic(P):
        x, y = P.gens(2)
        return x * x + y * y - x * y - x - y

    def simplex_pmp(P, poly_matrix, monomials, points, solvempmp, **kw):
        x0, x1 = P.gens(2)
        one = P.constant(1, 2)
        return solvempmp([[poly_matrix([[-(x0 + x1)]]), poly_matrix([[one]])]],
                         [[one, x0, x1, one - x0 - x1]], [monomials(2, 0)], [points(2, 1)],
                         [1], [-1.0], omega_p=100.0, omega_d=100.0, maxiterations=150,
                         verbose=False, **kw)

    for run_j, run_t in (
            (lambda: j_polymin(quadratic(JMPoly), 2, d=1),
             lambda: t_polymin(quadratic(MPoly), 2, d=1, device="cpu")),
            (lambda: simplex_pmp(JMPoly, j_poly_matrix, j_monomials, j_simplex_points,
                                 j_mpmp.solvempmp),
             lambda: simplex_pmp(MPoly, t_poly_matrix, t_monomials, t_simplex_points,
                                 t_mpmp.solvempmp, device="cpu"))):
        run_j()
        run_t()
        assert same_info(j_seen["info"], t_seen["info"]) and same_data(j_seen["b"], t_seen["b"])
        assert same_data([c[:4] for c in j_seen["abc"]], [c[:4] for c in t_seen["abc"]])
        assert dict(t_seen["kwargs"]) == dict(j_seen["kwargs"], device="cpu")


def test_sphere_packing_solve_follows_reference(mp_prec):
    """2d=4 (rank-2 clusters, m = (1,1,1,1,1,2,2)) at k=2 on the kernel
    route (the kernels' plain versions): 4 iterations against the
    reference's IPM (its host path), 1e-12 relative."""
    mp_prec(53)
    opts = dict(precision_k=2, maxiterations=4, verbose=False)
    _, ref = j_sphere(3, 2, RADII, 2, backend="host", **opts)
    _, res = t_sphere(3, 2, RADII, 2, device="cpu", use_cuda_matmul=True, **opts)
    assert res.iterations == ref.iterations == 4 and res.status == ref.status
    for rj, rt in zip(ref.history, res.history):
        for key in KEYS:
            a, b = rj[key], rt[key]
            assert abs(a - b) <= 1e-12 * max(abs(a), 1e-300), (rj["iter"], key, a, b)


def test_oracle_copy_matches_reference(mp_prec):
    """tests/test_oracle.py:22-49's LP through both oracles at 60 digits:
    the same result, exactly."""
    mp_prec(200)
    cons, b = lp_problem()
    old = mpmath.mp.dps
    mpmath.mp.dps = 60
    try:
        want = j_oracle(cons, b, j_info_of(cons), maxiterations=150, omega_p=100.0,
                        omega_d=100.0)
        got = t_oracle(cons, b, t_info_of(cons), maxiterations=150, omega_p=100.0,
                       omega_d=100.0)
        assert want["status"] == got["status"] == "optimal"
        assert sorted(want) == sorted(got)
        for key in want:  # at 60 digits, reprs print every digit
            assert repr(got[key]) == repr(want[key]), key
    finally:
        mpmath.mp.dps = old
