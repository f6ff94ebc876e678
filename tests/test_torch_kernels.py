"""The port's kernels K1-K3 (clrs_tpu_torch/ops/cuda_dd.py, cuda_xf.py)
and the IPM compute kernels that route through them
(clrs_tpu_torch/core/kernels.py).

On the CPU each kernel wrapper runs its plain PyTorch version, which is
held (a) against the Pallas kernel it replaces, run with interpret=True as
tests/test_pallas_dd.py and tests/test_pallas_xf.py run it, at 2^-48
relative: interpret mode inlines the kernel into an XLA:CPU program,
which contracts and reorders the low-limb arithmetic (pallas_dd.py:18-24,
tests/test_pallas_xf.py:7-17); and (b) against an mpmath oracle at
double-double accuracy.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py and chip_smoke.py), where each must equal its
plain version bit for bit.
"""

import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from clrs_tpu.core import kernels as jk
from clrs_tpu.ops.pallas_dd import dd_spd_inverse_pallas
from clrs_tpu.ops.pallas_xf import _matmul_batched, _schur_pairs_batched
from clrs_tpu.ops.xfloat import XF as JXF
from clrs_tpu_torch.core import kernels as tk
from clrs_tpu_torch.ops import cuda_dd, cuda_xf
from clrs_tpu_torch.ops.xfloat import XF as TXF

from test_torch_linalg import spd_dd
from test_torch_xfloat import assert_bitwise, rand_dd

REL_INTERPRET = 2.0 ** -48


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close_dd(want, got, rel):
    """(2, ...) limb arrays agree in value to rel of the largest entry."""
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    scale = np.max(np.abs(w[0])) or 1.0
    err = np.max(np.abs((g[0] - w[0]) + (g[1] - w[1])))
    assert err <= rel * scale, err / scale


def mp_value(limbs, idx):
    return mpmath.mpf(float(limbs[(0,) + idx])) + mpmath.mpf(float(limbs[(1,) + idx]))


# ---------------------------------------------------------------------------
# K1: dd SPD inverse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8, 11])
def test_spd_inverse_plain_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    limbs = np.stack([spd_dd(rng, n, 1e6) for _ in range(3)])  # (B, 2, n, n)
    inv_p, ok_p = dd_spd_inverse_pallas(jnp.asarray(limbs), interpret=True)
    inv_t, ok_t = cuda_dd.dd_spd_inverse_torch(t(limbs))
    assert bool(jnp.all(ok_p)) and bool(torch.all(ok_t))
    for b in range(3):
        assert_close_dd(np.asarray(inv_p[b]), inv_t[b].numpy(), REL_INTERPRET)


def test_spd_inverse_plain_flags_indefinite():
    rng = np.random.default_rng(2)
    limbs = np.stack([spd_dd(rng, 5, 1e3) for _ in range(2)])
    limbs[1, 0, 2, 2] = -50.0
    _, ok_p = dd_spd_inverse_pallas(jnp.asarray(limbs), interpret=True)
    _, ok_t = cuda_dd.dd_spd_inverse_torch(t(limbs))
    assert np.array_equal(np.asarray(ok_p), ok_t.numpy())
    assert ok_t.tolist() == [True, False]


@pytest.mark.parametrize("cond", [1e2, 1e10])
def test_spd_inverse_plain_dd_accuracy(cond):
    """A @ inv(A) = I to (cond * 2^-100) in exact (mpmath) arithmetic."""
    n = 6
    rng = np.random.default_rng(3)
    a = spd_dd(rng, n, cond)
    inv, ok = cuda_dd.dd_spd_inverse_torch(t(a)[None])
    assert bool(ok[0])
    inv = inv[0].numpy()
    old = mpmath.mp.prec
    mpmath.mp.prec = 300
    try:
        worst = 0
        for i in range(n):
            for j in range(n):
                s = mpmath.fsum(mp_value(a, (i, q)) * mp_value(inv, (q, j))
                                for q in range(n))
                worst = max(worst, abs(s - (1 if i == j else 0)))
        assert worst < cond * mpmath.mpf(2) ** -100, worst
    finally:
        mpmath.mp.prec = old


def test_spd_inverse_plain_versus_dd_ops():
    """The plain version's dd div/sqrt are the xfloat layer's at k=2
    (pallas_dd._Ops.div/sqrt mirror xf_div/xf_sqrt): on 1x1 blocks it
    returns W*W with W = 1/sqrt(a), bit for bit."""
    from clrs_tpu.ops.xfloat import xf_div, xf_mul, xf_sqrt

    rng = np.random.default_rng(4)
    a = rand_dd(rng, (5,), 3.0, positive=True)
    inv, ok = cuda_dd.dd_spd_inverse_torch(t(a).T[:, :, None, None])
    assert bool(torch.all(ok))
    w = xf_div(jxf(np.stack([np.ones(5), np.zeros(5)])), xf_sqrt(jxf(a)))
    assert_bitwise(xf_mul(w, w), TXF(inv[:, :, 0, 0].T.contiguous()))


# ---------------------------------------------------------------------------
# K2: Schur pairs core
# ---------------------------------------------------------------------------


def schur_inputs(rng, P2=4, T=5):
    a4 = rand_dd(rng, (P2, 4, T, T))
    b4 = rand_dd(rng, (P2, 4, T, T))
    hh = rand_dd(rng, (T, T), positive=True)
    return a4, b4, hh


def test_schur_pairs_plain_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    a4, b4, hh = schur_inputs(rng)
    want = _schur_pairs_batched(jnp.asarray(a4), jnp.asarray(b4), jnp.asarray(hh),
                                interpret=True)
    got = cuda_xf.schur_pairs_torch(t(a4)[:, None], t(b4)[:, None], t(hh)[:, None])
    assert_close_dd(np.asarray(want), got[:, 0].numpy(), REL_INTERPRET)


def test_schur_pairs_plain_dd_accuracy():
    rng = np.random.default_rng(6)
    a4, b4, hh = schur_inputs(rng, P2=2, T=3)
    got = cuda_xf.schur_pairs_torch(t(a4)[:, None], t(b4)[:, None],
                                    t(hh)[:, None])[:, 0].numpy()
    old = mpmath.mp.prec
    mpmath.mp.prec = 300
    try:
        for q in range(2):
            for i in range(3):
                for j in range(3):
                    s = mpmath.fsum(mp_value(a4, (q, r, i, j)) * mp_value(b4, (q, r, i, j))
                                    for r in range(4))
                    w = s * mp_value(hh, (i, j))
                    g = mp_value(got, (q, i, j))
                    assert abs(g - w) <= mpmath.mpf(2) ** -100 * (abs(w) + 1)
    finally:
        mpmath.mp.prec = old


# ---------------------------------------------------------------------------
# K3: batched dd matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 6, 6, 11), (3, 11, 6, 11),
                                   (1, 5, 13, 4)])
def test_matmul_plain_matches_pallas_interpret(shape):
    B, n, K, m = shape
    rng = np.random.default_rng(sum(shape))
    a = rand_dd(rng, (B, n, K))
    b = rand_dd(rng, (B, K, m))
    want = _matmul_batched(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = cuda_xf.dd_matmul_seq_torch(t(a), t(b))
    for i in range(B):
        assert_close_dd(np.asarray(want[:, i]), got[:, i].numpy(), REL_INTERPRET)


def test_matmul_plain_dd_accuracy():
    rng = np.random.default_rng(7)
    a = rand_dd(rng, (1, 4, 9))
    b = rand_dd(rng, (1, 9, 3))
    got = cuda_xf.dd_matmul_seq_torch(t(a), t(b)).numpy()
    old = mpmath.mp.prec
    mpmath.mp.prec = 300
    try:
        for i in range(4):
            for j in range(3):
                terms = [mp_value(a, (0, i, r)) * mp_value(b, (0, r, j)) for r in range(9)]
                w = mpmath.fsum(terms)
                bound = mpmath.mpf(2) ** -100 * mpmath.fsum(abs(x) for x in terms)
                assert abs(mp_value(got, (0, i, j)) - w) <= bound
    finally:
        mpmath.mp.prec = old


# ---------------------------------------------------------------------------
# Wrappers: CPU routing, counters, refusal of other devices
# ---------------------------------------------------------------------------


def test_wrappers_take_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(8)
    counts = (cuda_dd.dd_spd_inverse.launches, cuda_xf.schur_pairs.launches,
              cuda_xf.dd_matmul.launches)
    a = np.stack([spd_dd(rng, 4, 10.0)])
    inv, ok = cuda_dd.dd_spd_inverse(t(a))
    inv2, ok2 = cuda_dd.dd_spd_inverse_torch(t(a))
    assert torch.equal(inv, inv2) and torch.equal(ok, ok2)
    a4, b4, hh = schur_inputs(rng, P2=1, T=2)
    args = (t(a4)[:, None], t(b4)[:, None], t(hh)[:, None])
    assert torch.equal(cuda_xf.schur_pairs(*args), cuda_xf.schur_pairs_torch(*args))
    x, y = t(rand_dd(rng, (2, 3, 4))), t(rand_dd(rng, (2, 4, 5)))
    assert torch.equal(cuda_xf.dd_matmul(x, y), cuda_xf.dd_matmul_seq_torch(x, y))
    assert counts == (cuda_dd.dd_spd_inverse.launches, cuda_xf.schur_pairs.launches,
                      cuda_xf.dd_matmul.launches)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 2, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        cuda_dd.dd_spd_inverse(meta)
    with pytest.raises(ValueError):
        cuda_xf.dd_matmul(meta[:, 0], meta[:, 0])


# ---------------------------------------------------------------------------
# core/kernels.py against the reference
# ---------------------------------------------------------------------------


def cluster_inputs(rng, m=2, delta=3, K=3, rmax=2, G=2):
    """Symmetric Z blocks, vectors V and weights H (with zero padding
    slots) for a batch of G clusters."""
    n = m * delta
    T = K * rmax
    Z = rand_dd(rng, (G, n, n))
    Z = (Z + np.swapaxes(Z, -1, -2)) / 2
    Z[1] = 0.0
    V = rand_dd(rng, (G, delta, T))
    H = rand_dd(rng, (G, T))
    H[:, :, 1] = 0.0  # a padding slot
    return Z, V, H


def jxf(a):
    return JXF(jnp.asarray(a))


def txf(a):
    return TXF(t(a))


def test_pairings_traces_weighted_A_bitwise():
    rng = np.random.default_rng(9)
    m, delta, K, rmax = 2, 3, 3, 2
    Z, V, H = cluster_inputs(rng, m, delta, K, rmax)
    aw = rand_dd(rng, (2, m * (m + 1) // 2 * K))
    PZt = tk.compute_pairings(txf(Z), txf(V), m)
    for g in range(2):
        Zg, Vg, Hg = jxf(Z[:, g]), jxf(V[:, g]), jxf(H[:, g])
        PZj = jk.compute_pairings(Zg, Vg, m)
        assert_bitwise(PZj, PZt[g])
        assert_bitwise(jk.pairing_diag(PZj, m), tk.pairing_diag(PZt, m)[g])
        assert_bitwise(jk.trace_A_from_diag(jk.pairing_diag(PZj, m), Hg, m, K, rmax),
                       tk.trace_A_from_diag(tk.pairing_diag(PZt, m), txf(H), m, K,
                                            rmax)[g])
        assert_bitwise(jk.trace_A_generic(Zg, Vg, Hg, m, K, rmax),
                       tk.trace_A_generic(txf(Z), txf(V), txf(H), m, K, rmax)[g])
        assert_bitwise(jk.weighted_A_block(jxf(aw[:, g]), Vg, Hg, m, K, rmax),
                       tk.weighted_A_block(txf(aw), txf(V), txf(H), m, K, rmax)[g])


def test_schur_block_contribution_bitwise_and_kernel_route():
    """The cascade matches the reference bit for bit; the K2-routed body
    (gather, kernel core, segment-sum) matches the cascade bit for bit."""
    rng = np.random.default_rng(10)
    m, delta, K, rmax = 2, 3, 3, 2
    Z, V, H = cluster_inputs(rng, m, delta, K, rmax)
    Y, _, _ = cluster_inputs(rng, m, delta, K, rmax)
    PX = tk.compute_pairings(txf(Z), txf(V), m)
    PY = tk.compute_pairings(txf(Y), txf(V), m)
    cascade = tk.schur_block_contribution(PX, PY, txf(H), m, K, rmax)
    routed = tk.schur_block_contribution(PX, PY, txf(H), m, K, rmax, use_cuda=True)
    assert_bitwise(cascade.limbs.numpy(), routed)
    for g in range(2):
        want = jk.schur_block_contribution(
            JXF(jnp.asarray(PX.limbs[:, g].numpy())),
            JXF(jnp.asarray(PY.limbs[:, g].numpy())), jxf(H[:, g]), m, K, rmax)
        assert_bitwise(want, cascade[g])


def test_mm_kernel_route_matches_pallas_interpret():
    from clrs_tpu.ops.pallas_xf import xf_matmul_pallas

    rng = np.random.default_rng(11)
    a = rand_dd(rng, (3, 6, 6))
    # batched on both sides: the reference dispatch cannot broadcast an
    # unbatched operand (its limb axis comes first)
    b = rand_dd(rng, (3, 6, 11))
    want = xf_matmul_pallas(jxf(a), jxf(b), interpret=True)
    got = tk._mm(txf(a), txf(b), use_cuda=True)
    for i in range(3):
        assert_close_dd(np.asarray(want.limbs[:, i]), got.limbs[:, i].numpy(),
                        REL_INTERPRET)
