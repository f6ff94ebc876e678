"""The int8-sliced matmul of the port (clrs_tpu_torch/ops/mxu_matmul.py)
against the JAX reference's (clrs_tpu/ops/mxu_matmul.py), and its route
through the solver (SolverConfig.use_mxu_matmul).

The reference runs op by op (jax.disable_jit): no XLA compile, and no
multiply-add for XLA:CPU to contract.  Mirrors tests/test_mxu_matmul.py.
The port's default route, which the solve here is held against, is held
against the reference's by tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.ops import mxu_matmul as jmxu
from clrs_tpu.ops.xfloat import XF as JXF
from clrs_tpu_torch.core.blockinfo import get_block_info
from clrs_tpu_torch.core.solver import solverank1sdp
from clrs_tpu_torch.ops import mxu_matmul as tmxu
from clrs_tpu_torch.ops.xfloat import XF
from clrs_tpu_torch.ops.xfloat import xf_matmul as txf_matmul

from test_torch_xfloat import assert_bitwise
from test_torch_xfloat import torch_one_thread  # noqa: F401


def rand_limbs(rng, shape, k):
    """k limbs of magnitudes 2^-20..2^20, each limb below the last's ulp."""
    x = rng.standard_normal((k,) + shape) * np.exp2(rng.integers(-20, 20, size=(k,) + shape))
    x[1:] *= 2.0 ** -60
    return x


def operands(k, seed, n=12, K=17, m=9):
    """A (n, K) with a zero row 0, a row whose largest entry is exactly 1
    (the reference's first slice rounds to +2^7 there) and one whose
    largest magnitude is the negative -2^5 (its first slice -2^7, which
    int8 holds); B (K, m) whose first column's leading limbs are all 2^-1
    (+2^7 again) and second column's all -2^-2 (-2^7).  K = 17 and S m are
    not multiples of 8: torch._int_mm's operands are padded."""
    rng = np.random.default_rng(seed)
    A, B = rand_limbs(rng, (n, K), k), rand_limbs(rng, (K, m), k)
    A[:, 0] = A[:, 1] = 0.0
    A[0, 1, 3] = 1.0
    A[:, 2] *= 2.0 ** -25
    A[:, 2, 5] = (-2.0 ** 5, 0.0) + (0.0,) * (k - 2)
    B[0, :, 0] = 0.5
    B[0, :, 1] = -0.25
    return A, B


def values(limbs):
    """The expansions' values as float64 sums of their limbs."""
    return np.asarray(limbs).sum(axis=0)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_xf_matmul_mxu_matches_reference(k):
    """xf_matmul_mxu at S = 17, 24, 32 slices, zero rows included: bit for
    bit the reference's at every entry whose row of A and column of B the
    reference slices within int8, with the reference's exponents there
    (max |row| 2^-e in (0.5, 1]), the row at -2^5 and the column at -2^-2
    among them.  A row or column whose largest positive entry scales to
    255/256 or more (here the row at 1 and the column at 2^-1) takes one
    more power of two: the reference saturates its first slice there and
    errs by ~2^-7 of the row's scale, the port stays within the truncation
    bound K 2^(-7S+3) of the expansion product, as every other entry is."""
    A, B = operands(k, 40 + k)
    with jax.disable_jit():
        want = np.asarray(jmxu.xf_matmul_mxu(JXF(jnp.asarray(A)), JXF(jnp.asarray(B))).limbs)
        e_rows = np.asarray(jmxu._row_exponents(JXF(jnp.asarray(A)), axis=1))
        e_cols = np.asarray(jmxu._row_exponents(JXF(jnp.asarray(B)), axis=0))
    got = tmxu.xf_matmul_mxu(XF(torch.from_numpy(A)), XF(torch.from_numpy(B))).limbs.numpy()
    sat_rows = np.max(A[0], axis=1) * np.exp2(-e_rows.astype(float)) >= 255 / 256
    sat_cols = np.max(B[0], axis=0) * np.exp2(-e_cols.astype(float)) >= 255 / 256
    assert sat_rows.tolist()[:3] == [False, True, False]
    assert sat_cols.tolist()[:2] == [True, False]
    keep = ~sat_rows[:, None] & ~sat_cols[None, :]
    assert keep.sum() > 50 and keep[2, 1]
    assert_bitwise(want[:, keep], torch.from_numpy(np.ascontiguousarray(got[:, keep])))
    e = tmxu._row_exponents(XF(torch.from_numpy(A)), dim=-1).numpy()
    np.testing.assert_array_equal(e, e_rows + sat_rows)
    f = tmxu._row_exponents(XF(torch.from_numpy(B)), dim=-2).numpy()
    np.testing.assert_array_equal(f, e_cols + sat_cols)
    # the reference's rule scales the row at 1 to 1 in (0.5, 1], the port
    # one power of two past it; the row at -2^5 and the column at -2^-2
    # scale to -1 on both
    assert (e_rows[1], e_rows[2], e[1], e[2]) == (0, 5, 1, 5)
    assert (e_cols[0], e_cols[1], f[0], f[1]) == (-1, -2, 0, -2)
    exact = values(txf_matmul(XF(torch.from_numpy(A)), XF(torch.from_numpy(B))).limbs)
    S = tmxu._default_slices(k)
    scale = (np.max(np.abs(A[0]), axis=1)[:, None] * np.max(np.abs(B[0]), axis=0)[None, :])
    tol = A.shape[-1] * scale * 2.0 ** (-7 * S + 3) + 1e-300
    assert np.all(np.abs(values(got) - exact) <= tol)
    ref_err = np.abs(values(want) - exact)[sat_rows]
    assert np.max(ref_err / scale[sat_rows]) > 2.0 ** -10
    assert tmxu._default_slices(k) == jmxu._default_slices(k, jnp.float64)


def test_xf_matmul_mxu_batch_and_shapes():
    """A batch (B broadcast over it) is each 2-D product bit for bit; so
    are products whose shapes lie on _int_mm's rules (one row, K and S m
    multiples of 8 or not); zero operands give zeros; a contraction past
    the int32 bound raises."""
    rng = np.random.default_rng(7)
    k = 3
    a = XF(torch.from_numpy(rand_limbs(rng, (3, 5, 8), k)))
    b = XF(torch.from_numpy(rand_limbs(rng, (8, 4), k)))
    got = tmxu.xf_matmul_mxu(a, b)
    assert got.shape == (3, 5, 4)
    for g in range(3):
        assert_bitwise(tmxu.xf_matmul_mxu(a[g], b).limbs.numpy(), got[g])
    for n, K, m in ((1, 1, 1), (1, 8, 8), (17, 16, 3), (2, 9, 1)):
        x = XF(torch.from_numpy(rand_limbs(rng, (2, n, K), k)))
        y = XF(torch.from_numpy(rand_limbs(rng, (2, K, m), k)))
        both = tmxu.xf_matmul_mxu(x, y)
        for g in range(2):
            assert_bitwise(tmxu.xf_matmul_mxu(x[g], y[g]).limbs.numpy(), both[g])
    zero = tmxu.xf_matmul_mxu(XF.zeros((4, 5), k=2, device="cpu"),
                              XF.from_float(torch.ones((5, 3), dtype=torch.float64), k=2))
    assert torch.all(zero.limbs == 0)
    S = tmxu._default_slices(3)
    K = tmxu._max_contraction(S)
    assert K * 2 ** 12 * (S + 2) < 2 ** 31 <= (K + 1) * 2 ** 12 * (S + 2)
    with pytest.raises(ValueError, match="overflow"):
        tmxu.xf_matmul_mxu(XF.zeros((1, K + 1), k=3, device="cpu"),
                           XF.zeros((K + 1, 1), k=3, device="cpu"))


def test_solver_with_mxu_matmul_matches_default(monkeypatch):
    """The reference's tiny LP (tests/test_mxu_matmul.py:67-86) with
    use_mxu_matmul=True: the pairing, weighted-A and trace-A products
    through xf_matmul_mxu reach the default route's objective to 1e-12.
    With use_cuda_matmul too the kernels take the products, as the
    reference's "pallas" beats its MXU route."""
    import clrs_tpu_torch.core.kernels as tk

    vs = [np.array([1.0, 0.3]), np.array([-0.2, 1.0])]
    A = [[[v] for v in vs]]
    H = [[[1.0], [1.0]]]
    cons = [(A, np.asarray([[1.0], [2.0]], dtype=object),
             np.asarray([1.0, 1.0], dtype=object), H)]
    kwargs = dict(omega_p=100.0, omega_d=100.0, maxiterations=200, verbose=False,
                  duality_gap_threshold=1e-12, primal_error_threshold=1e-24,
                  dual_error_threshold=1e-24, device="cpu")
    calls = []

    def counted(a, b, mxu=tk.xf_matmul_mxu):
        calls.append(a.shape)
        return mxu(a, b)

    monkeypatch.setattr(tk, "xf_matmul_mxu", counted)
    res_ref = solverank1sdp(cons, [1.0], get_block_info(cons), **kwargs)
    assert calls == []
    res_mxu = solverank1sdp(cons, [1.0], get_block_info(cons), use_mxu_matmul=True, **kwargs)
    assert res_ref.converged and res_mxu.converged, (res_ref.status, res_mxu.status)
    assert abs(res_ref.primal_objective - res_mxu.primal_objective) < 1e-12
    assert len(calls) == 9 * res_mxu.iterations  # 4 pairing, 3 weighted-A, 2 trace-A
    calls.clear()
    solverank1sdp(cons, [1.0], get_block_info(cons), use_mxu_matmul=True, use_cuda_matmul=True,
                  **dict(kwargs, maxiterations=1))
    assert calls == []
