"""The blocked panel forms (clrs_tpu_torch/ops/linalg.py) on the CPU,
against the JAX reference.  The dispatch and xf_lu at n = 256 are tested
in test_torch_linalg.py, K5's panel route (ops/cuda_xf.spd_inverse_panels)
in test_torch_kernels.py, the slice with lowered thresholds in
test_torch_slice.py.

The panel forms keep the reference's order of operations
(clrs_tpu/ops/linalg.py:124-322): identity-tail padding, the masked column
block of L, the trailing update through the plain xf_matmul, the (n,)
right-hand side kept as a vector, the bottom-up panels of triu.  So limbs
are BITWISE equal, run on the reference's side op by op
(``jax.disable_jit``: XLA:CPU contracts multiply-adds inside compiled
loops).
"""

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

from test_torch_linalg import spd_dd
from test_torch_xfloat import assert_bitwise
from test_torch_xfloat import torch_one_thread  # noqa: F401

PANEL = 3


def spd_k(rng, n, k, cond):
    """A symmetric positive definite (k, n, n) limb array of condition
    ~cond: spd_dd's two limbs, then smaller normalized ones."""
    out = np.zeros((k, n, n))
    out[:2] = spd_dd(rng, n, cond)
    for q in range(2, k):
        lo = rng.uniform(-0.5, 0.5, (n, n)) * np.spacing(np.abs(out[q - 1]))
        out[q] = (lo + lo.T) / 2
    return out


def jxf(a):
    return JXF(jnp.asarray(a))


def txf(a):
    return TXF(torch.from_numpy(np.array(a)))


# panels of 3 rows: three whole ones at n = 9; at n = 8 the last is padded
# with an identity tail; the matmuls sum odd contractions (3)
CASES = [(9, 2), (8, 3)]


@functools.lru_cache(maxsize=None)
def panel_reference(n, k):
    """The reference's panel forms on one SPD matrix and one right-hand
    side, op by op, computed once per case."""
    rng = np.random.default_rng(1000 + n)
    a = spd_k(rng, n, k, 1e6)
    b = np.zeros((k, n, 3))
    b[0] = rng.standard_normal((n, 3))
    with jax.disable_jit():
        L, ok = jl.xf_cholesky_panel(jxf(a), panel=PANEL)
        U = JXF(jnp.swapaxes(L.limbs, 1, 2))
        return dict(
            a=a, b=b, L=L, ok=bool(ok),
            tril=jl.xf_solve_tril_panel(L, jxf(b), panel=PANEL),
            tril_unit=jl.xf_solve_tril_panel(L, jxf(b), unit_diag=True, panel=PANEL),
            tril_vec=jl.xf_solve_tril_panel(L, jxf(b[:, :, 0]), panel=PANEL),
            triu=jl.xf_solve_triu_panel(U, jxf(b), panel=PANEL))


@pytest.mark.parametrize("n,k", CASES)
def test_cholesky_panel_bitwise(n, k):
    ref = panel_reference(n, k)
    L, ok = tl.xf_cholesky_panel(txf(ref["a"]), panel=PANEL)
    assert ref["ok"] and bool(ok)
    assert_bitwise(ref["L"], L)


@pytest.mark.parametrize("n,k", CASES)
def test_solve_tril_panel_bitwise(n, k):
    """With and without a unit diagonal, and an (n,) right-hand side solved
    as one column and returned as a vector."""
    ref = panel_reference(n, k)
    L = txf(np.asarray(ref["L"].limbs))
    b = txf(ref["b"])
    assert_bitwise(ref["tril"], tl.xf_solve_tril_panel(L, b, panel=PANEL))
    assert_bitwise(ref["tril_unit"], tl.xf_solve_tril_panel(L, b, unit_diag=True, panel=PANEL))
    vec = tl.xf_solve_tril_panel(L, txf(ref["b"][:, :, 0]), panel=PANEL)
    assert vec.shape == (n,)
    assert_bitwise(ref["tril_vec"], vec)


@pytest.mark.parametrize("n,k", CASES)
def test_solve_triu_panel_bitwise(n, k):
    ref = panel_reference(n, k)
    L = txf(np.asarray(ref["L"].limbs))
    assert_bitwise(ref["triu"], tl.xf_solve_triu_panel(L.mT, txf(ref["b"]), panel=PANEL))


def test_panel_forms_batched_match_per_block_reference():
    """Two blocks in one port call (a leading batch axis; 5 rows, the last
    panel padded) == two reference calls: the Cholesky, and the forward
    solve on its factor."""
    rng = np.random.default_rng(1100)
    n = 5
    blocks = [spd_k(rng, n, 2, 1e4) for _ in range(2)]
    b = np.zeros((2, n, 2))
    b[0] = rng.standard_normal((n, 2))
    L, ok = tl.xf_cholesky_panel(txf(np.stack(blocks, axis=1)), panel=PANEL)
    x = tl.xf_solve_tril_panel(L, txf(b), panel=PANEL)
    assert x.shape == (2, n, 2)
    for i, blk in enumerate(blocks):
        with jax.disable_jit():
            Lj, okj = jl.xf_cholesky_panel(jxf(blk), panel=PANEL)
            xj = jl.xf_solve_tril_panel(Lj, jxf(b), panel=PANEL)
        assert bool(okj) and bool(ok[i])
        assert_bitwise(Lj, L[i])
        assert_bitwise(xj, x[i])
