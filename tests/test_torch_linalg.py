"""The port's double-double linear algebra (clrs_tpu_torch/ops/linalg.py)
against the JAX reference (clrs_tpu/ops/linalg.py) on the CPU in float64.

The factorizations and solves keep the reference's order of operations,
so limbs must be BITWISE equal, also when the port runs a batch of blocks
in one call (the reference's vmap).  The reference runs op by op here
(``jax.disable_jit``): XLA:CPU contracts multiply-adds into FMAs inside a
compiled ``fori_loop`` body, which changes the low limbs of the
reference's own result against its op-by-op semantics.  jacobi_min_eig
runs plain float64 matmuls, whose summation order is the BLAS library's:
it is held to 1e-12 relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.ops import linalg as jl
from clrs_tpu.ops.xfloat import XF as JXF
from clrs_tpu_torch.ops import linalg as tl
from clrs_tpu_torch.ops.xfloat import XF as TXF

from test_torch_xfloat import assert_bitwise
from test_torch_xfloat import torch_one_thread  # noqa: F401


def spd_dd(rng, n, cond):
    """A symmetric positive definite dd matrix (2, n, n) of condition
    ~cond, with a nonzero low limb."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0, np.log10(cond), n)
    A = (Q * lam) @ Q.T
    A = (A + A.T) / 2
    lo = rng.uniform(-0.5, 0.5, (n, n)) * np.spacing(np.abs(A))
    lo = (lo + lo.T) / 2
    return np.stack([A, lo])


def general_dd(rng, n):
    A = rng.standard_normal((n, n)) + n * np.eye(n) * 0.1
    lo = rng.uniform(-0.5, 0.5, (n, n)) * np.spacing(np.abs(A))
    return np.stack([A, lo])


def jxf(a):
    return JXF(jnp.asarray(a))


def txf(a):
    return TXF(torch.from_numpy(np.array(a)))


CASES = [(1, 1.0), (6, 1e4), (11, 1e10)]


@functools.lru_cache(maxsize=None)
def reference(n, cond):
    """The reference's factorizations of one SPD and one general matrix,
    computed once per case, op by op."""
    rng = np.random.default_rng(n)
    a = spd_dd(rng, n, cond)
    g = general_dd(rng, n)
    b = np.stack([rng.standard_normal((n, 3)), np.zeros((n, 3))])
    with jax.disable_jit():
        L, ok = jl.xf_cholesky(jxf(a))
        U = JXF(jnp.swapaxes(L.limbs, 1, 2))
        lu, perm, oklu = jl.xf_lu(jxf(g))
        out = dict(
            a=a, g=g, b=b, L=L, ok=bool(ok),
            tril=jl.xf_solve_tril(L, jxf(b)),
            tril_unit=jl.xf_solve_tril(L, jxf(b), unit_diag=True),
            triu=jl.xf_solve_triu(U, jxf(b)),
            inv=jl.xf_spd_inverse(jxf(a))[0],
            lu=lu, perm=np.asarray(perm), oklu=bool(oklu),
            lu_solve=jl.xf_lu_solve(lu, perm, jxf(b)),
            inv_lu=jl.xf_inverse_lu(jxf(g))[0],
        )
        out["sym"] = jl.xf_sym(out["inv"])
    return out


@pytest.mark.parametrize("n,cond", CASES)
def test_cholesky_bitwise(n, cond):
    ref = reference(n, cond)
    Lt, okt = tl.xf_cholesky(txf(ref["a"]))
    assert ref["ok"] and bool(okt)
    assert_bitwise(ref["L"], Lt)


@pytest.mark.parametrize("n,cond", CASES)
def test_triangular_solves_bitwise(n, cond):
    ref = reference(n, cond)
    Lt, _ = tl.xf_cholesky(txf(ref["a"]))
    b = txf(ref["b"])
    assert_bitwise(ref["tril"], tl.xf_solve_tril(Lt, b))
    assert_bitwise(ref["tril_unit"], tl.xf_solve_tril(Lt, b, unit_diag=True))
    assert_bitwise(ref["triu"], tl.xf_solve_triu(Lt.mT, b))


@pytest.mark.parametrize("n,cond", CASES)
def test_spd_inverse_bitwise(n, cond):
    ref = reference(n, cond)
    invt, okt = tl.xf_spd_inverse(txf(ref["a"]))
    assert bool(okt)
    assert_bitwise(ref["inv"], invt)
    assert_bitwise(ref["sym"], tl.xf_sym(invt))


@pytest.mark.parametrize("n,cond", CASES)
def test_lu_and_inverse_bitwise(n, cond):
    ref = reference(n, cond)
    lut, permt, okt = tl.xf_lu(txf(ref["g"]))
    assert ref["oklu"] and bool(okt)
    assert_bitwise(ref["lu"], lut)
    assert np.array_equal(ref["perm"], permt.numpy())
    assert_bitwise(ref["lu_solve"], tl.xf_lu_solve(lut, permt, txf(ref["b"])))
    assert_bitwise(ref["inv_lu"], tl.xf_inverse_lu(txf(ref["g"]))[0])


def test_batched_blocks_match_per_block_reference():
    """A stack of blocks in one port call == the reference block by block
    (the reference's jax.vmap), including a failing pivot flag."""
    rng = np.random.default_rng(40)
    n = 6
    blocks = [spd_dd(rng, n, 1e6) for _ in range(3)]
    blocks[1][0] = -blocks[1][0]  # negative definite: ok must be False
    stacked = np.stack(blocks, axis=1)  # (2, B, n, n)
    inv_t, ok_t = tl.xf_spd_inverse(txf(stacked))
    lu_t, perm_t, oklu_t = tl.xf_lu(txf(stacked))
    for i, blk in enumerate(blocks):
        with jax.disable_jit():
            inv_j, ok_j = jl.xf_spd_inverse(jxf(blk))
            lu_j, perm_j, _ = jl.xf_lu(jxf(blk))
        assert bool(ok_t[i]) == bool(ok_j)
        if bool(ok_j):
            assert_bitwise(inv_j, inv_t[i])
        assert_bitwise(lu_j, lu_t[i])
        assert np.array_equal(np.asarray(perm_j), perm_t[i].numpy())
    assert not bool(ok_t[1]) and bool(ok_t[0]) and bool(ok_t[2])


def test_min_eig_sym_matches_reference():
    rng = np.random.default_rng(50)
    n = 6
    m = spd_dd(rng, n, 1e3)
    dm = np.stack([rng.standard_normal((n, n)), np.zeros((n, n))])
    dm[0] = (dm[0] + dm[0].T) / 2
    with jax.disable_jit():
        lam_j, ok_j = jl.xf_min_eig_sym(jxf(m), jxf(dm))
    lam_t, ok_t = tl.xf_min_eig_sym(txf(m), txf(dm))
    assert bool(ok_j) and bool(ok_t)
    assert abs(float(lam_t) - float(lam_j)) <= 1e-12 * abs(float(lam_j))


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_jacobi_min_eig_matches_reference(n):
    rng = np.random.default_rng(60 + n)
    a = rng.standard_normal((3, n, n))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    want = np.asarray(jnp.stack([jl.jacobi_min_eig(jnp.asarray(x)) for x in a]))
    got = tl.jacobi_min_eig(torch.from_numpy(a)).numpy()
    scale = np.max(np.abs(np.linalg.eigvalsh(a)))
    assert np.max(np.abs(got - want)) <= 1e-12 * scale
    # a safe lower bound on the true minimum eigenvalue
    assert np.all(got <= np.linalg.eigvalsh(a)[:, 0] + 1e-12 * scale)


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test: at 256 rows each limb
    tensor passes the size at which torch splits an elementwise op over its
    intra-op threads, and with several test processes on the machine those
    threads contend (xf_lu at n = 256 took ~2 min, against ~3 s on one
    thread).  Elementwise ops, gathers and argmax give the same bits on
    any number of threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cholesky_at_256_takes_the_panel_form(one_thread):
    """At n = _PANEL_MIN_N = 256 xf_cholesky dispatches to the panel form
    at the reference's panel width 32: bitwise the direct call."""
    a = TXF(torch.from_numpy(spd_dd(np.random.default_rng(256), 256, 1e4)))
    L, ok = tl.xf_cholesky(a)
    Lp, okp = tl.xf_cholesky_panel(a, panel=32)
    assert bool(ok) and bool(okp)
    assert_bitwise(Lp, L)


def test_panel_dispatch_bitwise(monkeypatch):
    """With _PANEL_MIN_N and _PANEL_DEFAULT lowered in both packages (as
    tests/test_linalg.py:262-275 lowers the reference's), the dispatched
    xf_spd_inverse and xf_inverse_lu (whose LU solves reach the panel
    trisolves) equal the reference's limb for limb; 12 rows in panels of
    3, whose matmuls sum odd contractions."""
    n = 12
    for mod in (jl, tl):
        monkeypatch.setattr(mod, "_PANEL_MIN_N", 8)
        monkeypatch.setattr(mod, "_PANEL_DEFAULT", 3)
    rng = np.random.default_rng(1200)
    a = spd_dd(rng, n, 1e6)
    g = general_dd(rng, n)
    with jax.disable_jit():
        inv_j, ok_j = jl.xf_spd_inverse(jxf(a))
        lu_inv_j, oklu_j = jl.xf_inverse_lu(jxf(g))
    inv_t, ok_t = tl.xf_spd_inverse(txf(a))
    lu_inv_t, oklu_t = tl.xf_inverse_lu(txf(g))
    assert bool(ok_j) and bool(ok_t) and bool(oklu_j) and bool(oklu_t)
    assert_bitwise(inv_j, inv_t)
    assert_bitwise(lu_inv_j, lu_inv_t)


def test_lu_at_256_bitwise(one_thread):
    """xf_lu has no panel form and no size limit, as in the reference: at
    n = 256, where the dispatchers take the panel forms, it equals the
    reference's limb for limb."""
    g = general_dd(np.random.default_rng(1300), 256)
    with jax.disable_jit():
        lu_j, perm_j, ok_j = jl.xf_lu(jxf(g))
    lu_t, perm_t, ok_t = tl.xf_lu(txf(g))
    assert bool(ok_j) and bool(ok_t)
    assert np.array_equal(np.asarray(perm_j), perm_t.numpy())
    assert_bitwise(lu_j, lu_t)
