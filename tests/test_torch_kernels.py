"""The port's kernels K1-K5 (clrs_tpu_torch/ops/cuda_dd.py, cuda_xf.py),
their k-limb arithmetic (ops/xops.py) and the IPM compute kernels that
route through them (clrs_tpu_torch/core/kernels.py).

On the CPU each kernel wrapper runs its plain PyTorch version, which is
held (a) against the Pallas kernel it replaces, run with interpret=True as
tests/test_pallas_dd.py and tests/test_pallas_xf.py run it, at 2^-48
relative: interpret mode inlines the kernel into an XLA:CPU program,
which contracts and reorders the low-limb arithmetic (pallas_dd.py:18-24,
tests/test_pallas_xf.py:7-17); and (b) against an mpmath oracle at
double-double accuracy.  At k >= 3 the plain versions are held bit for
bit against the Pallas kernel bodies replayed with the reference's own
_XOps, and against interpret mode at a few k-limb ulps.  The CUDA kernels
themselves run only on the card
(tests/test_torch_cuda.py and chip_smoke.py), where each must equal its
plain version bit for bit.
"""

import jax
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
from clrs_tpu_torch.core.blockinfo import pair_list
from clrs_tpu_torch.ops import cuda_dd, cuda_xf, xops
from clrs_tpu_torch.ops.xfloat import XF as TXF
from clrs_tpu_torch.ops.xfloat import xf_mul as txf_mul
from clrs_tpu_torch.ops.xfloat import xf_sum as txf_sum

from test_torch_cuda import matmul_operands as cuda_matmul_operands
from test_torch_linalg import spd_dd
from test_torch_xfloat import assert_bitwise, rand_dd, rand_xf

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


@pytest.mark.parametrize("n", [1, 2, 5, 11, 17])
def test_spd_inverse_k2_plain_is_k1_plain(n):
    """K1 is the k=2 instance of K5's kernel: K5's plain version at k=2
    gives K1's plain version bit for bit, limbs and flags, the second of
    two blocks indefinite."""
    rng = np.random.default_rng(40 + n)
    limbs = np.stack([spd_dd(rng, n, 1e6) for _ in range(2)])
    limbs[1, 0, n // 2, n // 2] = -1.0
    inv_1, ok_1 = cuda_dd.dd_spd_inverse_torch(t(limbs))
    inv_5, ok_5 = cuda_xf.spd_inverse_xf_torch(t(limbs))
    assert ok_1.tolist() == ok_5.tolist() == [True, False]
    assert torch.equal(inv_1.view(torch.int64), inv_5.view(torch.int64))


@pytest.mark.parametrize("k", [2, 3])
def test_spd_inverse_stacked_layout_matches_contiguous(k):
    """xf_spd_inverse_batched on the solver's stacked (k, B, n, n) limbs
    (K1 at k=2, K5 above) gives the wrapper's (B, k, n, n) result on the
    same blocks, bit for bit, in the stacked layout."""
    a = t(spd_xf(np.random.default_rng(45 + k), 3, 4, k, 1e4))
    inv, ok = (cuda_dd.dd_spd_inverse if k == 2 else cuda_xf.spd_inverse_xf)(a)
    inv_s, ok_s = cuda_xf.xf_spd_inverse_batched(a.transpose(0, 1).contiguous())
    assert ok.tolist() == ok_s.tolist() == [True] * 3
    assert_bitwise(inv.transpose(0, 1), inv_s)


def test_spd_inverse_plan_layouts_and_refusals():
    """K1's and K5's launch description (cuda_dd._spd_inverse_plan) reads
    the limbs where they lie: the stacked view's own strides, with no copy;
    the output dense in the caller's axis order.  The row cap is 1024 at
    k=2 and 256 above; other shapes and types are refused."""
    import struct

    x = torch.zeros((3, 5, 7, 7), dtype=torch.float64)  # (k, B, n, n)
    desc, k, B, n = cuda_dd._spd_inverse_plan(x, 0)
    assert (k, B, n) == (3, 5, 7)
    assert struct.unpack("<9q", desc) == (3, 5, 7, 245, 49, 7, 1, 245, 49)
    desc, k, B, n = cuda_dd._spd_inverse_plan(x.transpose(0, 1), 1)  # (B, k, n, n) view
    assert (k, B, n) == (3, 5, 7)
    assert struct.unpack("<9q", desc) == (3, 5, 7, 245, 49, 7, 1, 49, 147)
    xt = x.transpose(-1, -2)
    assert struct.unpack("<9q", cuda_dd._spd_inverse_plan(xt, 0)[0])[5:7] == (1, 7)
    assert cuda_dd.max_rows(2) == 1024 and cuda_dd.max_rows(3) == cuda_dd.max_rows(12) == 256
    def square(k, n):  # (1, k, n, n) of one stored zero
        return torch.zeros((1, k, 1, 1), dtype=torch.float64).expand(1, k, n, n)

    assert cuda_dd._spd_inverse_plan(square(2, 1024), 1)[3] == 1024
    assert cuda_dd._spd_inverse_plan(square(3, 256), 1)[3] == 256
    for bad, axis in ((square(2, 1025), 1), (square(3, 257), 1),
                      (torch.zeros((2, 1, 3, 4), dtype=torch.float64), 0),
                      (torch.zeros((2, 1, 3, 3), dtype=torch.float32), 0),
                      (torch.zeros((2, 3, 3), dtype=torch.float64), 0)):
        with pytest.raises(ValueError):
            cuda_dd._spd_inverse_plan(bad, axis)


# ---------------------------------------------------------------------------
# K2: the Schur block of a group of clusters
# ---------------------------------------------------------------------------


def schur_operands(rng, k=2, m=2, T=5, G=1):
    """Pairings PX, PY (k, G, m, T, m, T) laid out as compute_pairings
    returns them (transposed views of (k, G, T, m, m, T)), and positive
    weights HH (k, G, T, T)."""
    px, py = (t(rand_xf(rng, (G, T, m, m, T), k)).permute(0, 1, 3, 2, 4, 5)
              for _ in range(2))
    return px, py, t(rand_xf(rng, (G, T, T), k, positive=True))


def gathered_slices(px, py):
    """The reference route's gather (kernels.py:_schur_block_contribution_pallas):
    for pair of pairs q = i1 P + i2 the four a_i = PX[ar, t1, ac, t2] and
    b_i = PY[br, t2, bc, t1], each (k, G, P^2, 4, T, T)."""
    k, G, m, T = px.shape[0], px.shape[1], px.shape[2], px.shape[-1]
    pairs = pair_list(m)
    P = len(pairs)
    ar, ac, br, bc = (np.empty((P * P, 4), np.int64) for _ in range(4))
    for i1, (r1, s1) in enumerate(pairs):
        for i2, (r2, s2) in enumerate(pairs):
            q = i1 * P + i2
            ar[q], ac[q] = (s1, r1, s1, r1), (r2, r2, s2, s2)
            br[q], bc[q] = (s2, s2, r2, r2), (r1, s1, r1, s1)

    def mm_first(x):  # (k, G, m, T, m, T) -> (k, G, m m, T, T), [r m + s, t1, t2]
        return x.permute(0, 1, 2, 4, 3, 5).reshape(k, G, m * m, T, T)

    a4 = mm_first(px)[:, :, torch.from_numpy(ar * m + ac)]
    b4 = mm_first(py)[:, :, torch.from_numpy(br * m + bc)].transpose(-1, -2)
    return a4, b4


def gathered_schur_block(PX, PY, HH, m, K, rmax):
    """The Schur block as the kernel route formed it before K2 took the
    whole block: the gathered slices, the elementwise core on xops, the
    rank segment-sum over (P, P, K, rmax, K, rmax) and the transpose into
    the (P K, P K) layout; PX, PY (k, G, m, T, m, T), HH (k, G, T, T)."""
    k, G, T = PX.k, PX.shape[0], K * rmax
    P = m * (m + 1) // 2
    a4, b4 = gathered_slices(PX.limbs, PY.limbs)
    p = [xops.mul(list(a4[:, :, :, i].unbind(0)), list(b4[:, :, :, i].unbind(0)))
         for i in range(4)]
    s = xops.add(xops.add(p[0], p[1]), xops.add(p[2], p[3]))
    w = torch.stack(xops.mul(s, [x[:, None] for x in HH.limbs.unbind(0)]))
    W = TXF(w.reshape(k, G, P, P, K, rmax, K, rmax))
    blk = txf_sum(txf_sum(W, axis=-1), axis=-2)  # (G, P, P, K, K)
    return blk.transpose(0, 1, 3, 2, 4).reshape(G, P * K, P * K)


def test_schur_pairs_plain_matches_pallas_interpret():
    """K2's plain version, the whole block at once on the pairings as they
    lie, against the Pallas kernel in interpret mode on the slices the
    reference's route gathers, entry for entry."""
    rng = np.random.default_rng(5)
    m, T, P = 2, 5, 3
    px, py, hh = schur_operands(rng, 2, m, T)
    a4, b4 = gathered_slices(px, py)
    want = _schur_pairs_batched(jnp.asarray(a4[:, 0].numpy()), jnp.asarray(b4[:, 0].numpy()),
                                jnp.asarray(hh[:, 0].numpy()), interpret=True)
    got = cuda_xf.schur_pairs_torch(px, py, hh)[:, 0]  # (2, P, T, P, T)
    got = got.permute(0, 1, 3, 2, 4).reshape(2, P * P, T, T)
    assert_close_dd(np.asarray(want), got.numpy(), REL_INTERPRET)


def test_schur_pairs_plain_dd_accuracy():
    """Every entry of K2's plain version against the same sums in mpmath
    at 300 bits, to double-double accuracy."""
    rng = np.random.default_rng(6)
    m, T = 2, 3
    px, py, hh = (x.numpy() for x in schur_operands(rng, 2, m, T))
    got = cuda_xf.schur_pairs_torch(t(px), t(py), t(hh))[:, 0].numpy()
    pairs = pair_list(m)
    old = mpmath.mp.prec
    mpmath.mp.prec = 300
    try:
        for i1, (r1, s1) in enumerate(pairs):
            for i2, (r2, s2) in enumerate(pairs):
                ab = (((s1, r2), (s2, r1)), ((r1, r2), (s2, s1)), ((s1, s2), (r2, r1)),
                      ((r1, s2), (r2, s1)))
                for i in range(T):
                    for j in range(T):
                        s = mpmath.fsum(mp_value(px, (0, ra, i, ca, j))
                                        * mp_value(py, (0, rb, j, cb, i))
                                        for (ra, ca), (rb, cb) in ab)
                        w = s * mp_value(hh, (0, i, j))
                        g = mp_value(got, (i1, i, i2, j))
                        assert abs(g - w) <= mpmath.mpf(2) ** -100 * (abs(w) + 1)
    finally:
        mpmath.mp.prec = old


@pytest.mark.parametrize("k", [2, 3, 6])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_schur_block_plain_is_gathered_composition(k, m):
    """The kernel route's Schur block (K2's plain version on the strided
    pairings compute_pairings returns, then the segment-sum on its layout
    and a reshape) is bit for bit the composition it replaces (gather, the
    elementwise core, segment-sum, transpose), for rmax 1 and 2 and one
    and two clusters."""
    for rmax in (1, 2):
        for G in (1, 2):
            rng = np.random.default_rng(300 + 10 * k + m + 3 * rmax + G)
            K, delta = 3, 2
            T = K * rmax
            Z, Y = (rand_xf(rng, (G, m * delta, m * delta), k) for _ in range(2))
            Z, Y = ((x + np.swapaxes(x, -1, -2)) / 2 for x in (Z, Y))
            V, H = rand_xf(rng, (G, delta, T), k), rand_xf(rng, (G, T), k)
            PX = tk.compute_pairings(txf(Z), txf(V), m)
            PY = tk.compute_pairings(txf(Y), txf(V), m)
            assert PX.limbs.stride()[-3] == m * m * T and PX.limbs.stride()[-1] == 1
            Ht = txf(H)
            HH = TXF(txf_mul(TXF(Ht.limbs[..., :, None]), TXF(Ht.limbs[..., None, :])).limbs
                     * 0.25)
            want = gathered_schur_block(PX, PY, HH, m, K, rmax)
            got = tk._schur_block_contribution_cuda(PX, PY, HH, m, K, rmax)
            assert_bitwise(want.limbs.numpy(), got)


def read_strided(x, limb_stride, strides, dims):
    """The limbs a kernel loads from x's storage for an operand of the
    given dims at limb_stride * q + sum_i index_i * strides[i]."""
    k = x.shape[0]
    idx = torch.zeros(dims, dtype=torch.int64)
    for ax, (dim, st) in enumerate(zip(dims, strides)):
        shape = [1] * len(dims)
        shape[ax] = dim
        idx = idx + (torch.arange(dim) * st).reshape(shape)
    flat = torch.as_strided(x, (int(idx.max()) + (k - 1) * limb_stride + 1,), (1,),
                            x.storage_offset())
    return torch.stack([flat[q * limb_stride + idx] for q in range(k)])


@pytest.mark.parametrize("k", [2, 3, 12])
def test_schur_plan_reads_operands_in_place(k):
    """The description K2's wrapper hands the kernel addresses, in each
    operand's own storage, exactly the operand broadcast to the batch: the
    transposed pairings of compute_pairings, a contiguous copy, a PX and an
    HH broadcast over the clusters, no batch axis, and two batch axes that
    merge; the tile's rows follow T and the staged bytes."""
    import struct

    rng = np.random.default_rng(180 + k)
    px, py, hh = schur_operands(rng, k, 2, 5, G=3)
    cases = ((px, py, hh), (px.contiguous(), py, hh),
             (px[:, :1].expand(px.shape), py, hh[:, :1]),
             (px[:, 0], py[:, 0], hh[:, 0]),
             (px.reshape((k, 3, 1) + px.shape[2:]), py.contiguous().reshape(
                 (k, 3, 1) + py.shape[2:]), hh.reshape(k, 3, 1, 5, 5)))
    ty = 8 if cuda_xf._schur_shared(k, 2, 8) <= cuda_xf.SCHUR_SHARED_BUDGET else 4
    for x, y, h in cases:
        desc, shape, N = cuda_xf._schur_plan(x, y, h)
        d = struct.unpack("<22q", desc)
        batch = tuple(np.broadcast_shapes(x.shape[1:-4], y.shape[1:-4], h.shape[1:-2]))
        G = int(np.prod(batch))
        assert d[:6] == (k, G, 2, 5, 3, ty) and shape == (k,) + batch + (3, 5, 3, 5)
        assert N == G * 225
        for op, off, dims in ((x, 6, (G, 2, 5, 2, 5)), (y, 12, (G, 2, 5, 2, 5)),
                              (h, 18, (G, 5, 5))):
            want = op.expand((k,) + batch + op.shape[len(op.shape) - len(dims) + 1:])
            got = read_strided(op, d[off], d[off + 1:off + len(dims) + 1], dims)
            assert_bitwise(want.reshape(got.shape).numpy(), got)
    one = torch.zeros((k, 1, 1, 1, 1, 1), dtype=torch.float64)
    for T, ty in ((1, 1), (2, 2), (3, 4), (8, 8), (11, 8), (128, 8)):
        x = one.expand(k, 1, 3, T, 3, T)
        h = one[..., 0, 0].expand(k, 1, T, T)
        want = ty if cuda_xf._schur_shared(k, 3, ty) <= cuda_xf.SCHUR_SHARED_BUDGET else 4
        assert struct.unpack("<22q", cuda_xf._schur_plan(x, x, h)[0])[5] == want


def test_schur_plan_refusals():
    """K2's description raises on what its kernel does not take: a device
    mix, non-float64 limbs, pairings of other shapes or limb counts, a
    batch whose axes do not merge, an m whose staged slices do not fit one
    row of a tile, and a limb count the library holds no kernel for."""
    rng = np.random.default_rng(190)
    px, py, hh = schur_operands(rng, 3, 2, 4, G=2)
    meta = torch.empty(px.shape, dtype=torch.float64, device="meta")
    for x, y, h in ((px, meta, hh), (px, py.float(), hh), (px, py[:2], hh),
                    (px, py[..., :3, :, :3], hh), (px, py, hh[..., :3, :3]),
                    (px, py[..., :1, :, :1, :], hh), (px[:, 0, 0], py, hh)):
        with pytest.raises(ValueError):
            cuda_xf._schur_plan(x, y, h)
    wide = torch.zeros((3, 2, 3, 2, 4, 2, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_xf._schur_plan(wide.transpose(1, 2), wide, hh)
    one = torch.zeros((12, 1, 1, 1, 1, 1), dtype=torch.float64)
    big = one.expand(12, 1, 36, 1, 36, 1)
    assert cuda_xf._schur_shared(12, 36, 1) > cuda_xf.SCHUR_MAX_SHARED
    with pytest.raises(ValueError):
        cuda_xf._schur_plan(big, big, one[..., 0, 0])
    ok = one.expand(12, 1, 35, 1, 35, 1)
    cuda_xf._schur_plan(ok, ok, one[..., 0, 0])
    with pytest.raises(NotImplementedError):
        z = torch.zeros((13, 1, 1, 1, 1), dtype=torch.float64)
        cuda_xf._schur_plan(z, z, z[:, 0, 0])


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
              cuda_xf.dd_matmul.launches, cuda_xf.matmul_xf.launches,
              cuda_xf.spd_inverse_xf.launches)
    a = np.stack([spd_dd(rng, 4, 10.0)])
    inv, ok = cuda_dd.dd_spd_inverse(t(a))
    inv2, ok2 = cuda_dd.dd_spd_inverse_torch(t(a))
    assert torch.equal(inv, inv2) and torch.equal(ok, ok2)
    args = schur_operands(rng, 2, 2, 2)
    assert torch.equal(cuda_xf.schur_pairs(*args), cuda_xf.schur_pairs_torch(*args))
    x, y = t(rand_dd(rng, (2, 3, 4))), t(rand_dd(rng, (2, 4, 5)))
    assert torch.equal(cuda_xf.dd_matmul(x, y), cuda_xf.dd_matmul_seq_torch(x, y))
    x, y = t(rand_xf(rng, (2, 3, 4), 3)), t(rand_xf(rng, (2, 4, 5), 3))
    assert torch.equal(cuda_xf.matmul_xf(x, y), cuda_xf.matmul_xf_torch(x, y))
    a3 = t(np.concatenate([a, np.zeros((1, 1, 4, 4))], axis=1))
    assert all(torch.equal(u, v) for u, v in zip(cuda_xf.spd_inverse_xf(a3),
                                                 cuda_xf.spd_inverse_xf_torch(a3)))
    assert counts == (cuda_dd.dd_spd_inverse.launches, cuda_xf.schur_pairs.launches,
                      cuda_xf.dd_matmul.launches, cuda_xf.matmul_xf.launches,
                      cuda_xf.spd_inverse_xf.launches)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 2, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        cuda_dd.dd_spd_inverse(meta)
    with pytest.raises(ValueError):
        cuda_xf.dd_matmul(meta[:, 0], meta[:, 0])
    meta3 = torch.empty((1, 3, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        cuda_xf.spd_inverse_xf(meta3)
    with pytest.raises(ValueError):
        cuda_xf.matmul_xf(meta3, meta3)


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


# ---------------------------------------------------------------------------
# k >= 3: the kernels' arithmetic (ops/xops.py) and K2, K4 (+K6), K5
# ---------------------------------------------------------------------------

KS = (3, 4, 6, 10)


def jlist(a):
    return [jnp.asarray(x) for x in a]


def tlist(a):
    return [t(x) for x in a]


def assert_limbs_bitwise(want, got):
    assert_bitwise(np.stack([np.asarray(x) for x in want]), torch.stack(got))


@pytest.mark.parametrize("k", (2,) + KS)
def test_xops_match_pallas_xops(k, monkeypatch):
    """ops/xops.py is pallas_xf._XOps op for op, bit for bit (eager JAX,
    so no XLA fusion); _XOps seeds sqrt with rsqrt, which is patched to
    the port's correctly rounded 1/sqrt for the comparison."""
    import jax

    from clrs_tpu.ops.pallas_xf import _XOps
    from clrs_tpu_torch.ops import xops

    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    rng = np.random.default_rng(20 + k)
    a, b = rand_xf(rng, (3, 6), k), rand_xf(rng, (3, 6), k)
    p = rand_xf(rng, (3, 6), k, positive=True)
    p[:, 0, 0] = 0.0
    xo = _XOps(False, k)
    assert_limbs_bitwise(xo.add(jlist(a), jlist(b)), xops.add(tlist(a), tlist(b)))
    assert_limbs_bitwise(xo.mul(jlist(a), jlist(b)), xops.mul(tlist(a), tlist(b)))
    assert_limbs_bitwise(xo.div(jlist(a), jlist(b)), xops.div(tlist(a), tlist(b)))
    assert_limbs_bitwise(xo.sqrt(jlist(p)), xops.sqrt(tlist(p)))
    for axis in (0, 1):
        assert_limbs_bitwise(xo.sum_axis(jlist(a), axis), xops.sum_axis(tlist(a), axis))


@pytest.mark.parametrize("k", (2,) + KS)
def test_matmul_and_schur_k_plain_match_xops_replay(k):
    """The plain K3/K4 and K2 are the Pallas kernel bodies replayed with
    _XOps, bit for bit: K4 accumulates add(acc, mul(a[:, r], b[r, :])) over
    the contraction zero-padded to 8 (pallas_xf.py:489-493, 514-518), K3
    (k=2, xfloat's dd sequences written out) the same over the contraction
    as it is, with no padding: so one kernel source serves both, its step
    count an argument; K2 forms ((p1 + p2) + (p3 + p4)) * HH
    (pallas_xf.py:605-614) on the slices the reference gathers, every pair
    of pairs in one call on the pairings as they lie."""
    from clrs_tpu.ops.pallas_xf import _XOps
    from clrs_tpu_torch.ops import xops

    rng = np.random.default_rng(30 + k)
    xo = _XOps(False, k)
    a, b = rand_xf(rng, (2, 3, 5), k), rand_xf(rng, (2, 5, 4), k)
    steps = 5 if k == 2 else 8
    ap = np.pad(a, ((0, 0),) * 3 + ((0, steps - 5),))
    bp = np.pad(b, ((0, 0),) * 2 + ((0, steps - 5), (0, 0)))
    acc = xo.zeros_like(jnp.zeros((2, 3, 4)))
    mine = [torch.zeros((2, 3, 4), dtype=torch.float64)] * k
    for r in range(steps):
        acc = xo.add(acc, xo.mul(jlist(ap[:, :, :, r:r + 1]), jlist(bp[:, :, r:r + 1, :])))
        mine = xops.add(mine, xops.mul(tlist(ap[:, :, :, r:r + 1]),
                                       tlist(bp[:, :, r:r + 1, :])))
    plain = cuda_xf.dd_matmul_seq_torch if k == 2 else cuda_xf.matmul_xf_torch
    assert_limbs_bitwise(acc, list(plain(t(a), t(b))))
    assert_limbs_bitwise(acc, mine)
    px, py, hh = schur_operands(rng, k, 2, 5, G=2)
    a4, b4 = (x.numpy() for x in gathered_slices(px, py))  # (k, 2, 9, 4, 5, 5)
    p = [xo.mul(jlist(a4[:, :, :, i]), jlist(b4[:, :, :, i])) for i in range(4)]
    w = xo.mul(xo.add(xo.add(p[0], p[1]), xo.add(p[2], p[3])), jlist(hh.numpy()[:, :, None]))
    got = cuda_xf.schur_pairs_torch(px, py, hh)  # (k, 2, P, T, P, T)
    assert_limbs_bitwise(w, list(got.permute(0, 1, 2, 4, 3, 5).reshape(k, 2, 9, 5, 5)))


def assert_close_xf(want, got, tol):
    """(k, ...) limb arrays represent values within tol of each other,
    relative to the largest leading limb (sums in mpmath)."""
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    scale = float(np.max(np.abs(w[0]))) or 1.0
    old = mpmath.mp.prec
    mpmath.mp.prec = 60 * w.shape[0] + 60
    try:
        for idx in np.ndindex(w.shape[1:]):
            d = mpmath.fsum(mpmath.mpf(float(x)) for x in w[(slice(None),) + idx]) \
                - mpmath.fsum(mpmath.mpf(float(x)) for x in g[(slice(None),) + idx])
            assert abs(d) <= tol * scale, (idx, float(abs(d) / scale), tol)
    finally:
        mpmath.mp.prec = old


def k_ulp(k):
    """A few ulps of a k-limb expansion (53k bits, 2^10 of slack)."""
    return 2.0 ** (10 - 53 * k)


@pytest.mark.parametrize("k", [3])
def test_mm_k_route_matches_pallas_interpret(k):
    """_mm's kernel route at k >= 3 (K4's plain version) against
    xf_matmul_pallas in interpret mode, on one grid step: in interpret
    mode the Pallas kernels' unrolled k < 6 bodies lose low limbs once the
    grid takes more steps (ROADMAP.md, reference quirks); the K6 test
    below takes the k >= 6 loop_kc body over several steps.  Interpret
    mode inlines the kernel into XLA:CPU, which reorders the low-limb
    arithmetic: k-limb ulps."""
    from clrs_tpu.ops.pallas_xf import xf_matmul_pallas

    rng = np.random.default_rng(40 + k)
    a, b = rand_xf(rng, (1, 6, 6), k), rand_xf(rng, (1, 6, 11), k)
    want = xf_matmul_pallas(jxf(a), jxf(b), interpret=True)
    got = tk._mm(txf(a), txf(b), use_cuda=True)
    assert_close_xf(want.limbs, got.limbs.numpy(), k_ulp(k))


def test_matmul_k_tiled_plain_matches_pallas_interpret():
    """K6 (the tiled K4) in interpret mode with 8x8 output tiles, a
    ragged edge and two contraction steps: the same per-entry sequence as
    K4's plain version (k=6, the Pallas kernel's loop_kc body)."""
    from clrs_tpu.ops.pallas_xf import _matmul_batched_k_tiled

    k = 6
    rng = np.random.default_rng(50)
    a, b = rand_xf(rng, (1, 9, 11), k), rand_xf(rng, (1, 11, 10), k)
    want = _matmul_batched_k_tiled(jnp.asarray(a), jnp.asarray(b), interpret=True,
                                   bn=8, bm=8)
    assert_close_xf(want, cuda_xf.matmul_xf_torch(t(a), t(b)).numpy(), k_ulp(k))


@pytest.mark.parametrize("k", [3])
def test_schur_block_contribution_k_route_matches_pallas_interpret(k):
    """The K2-routed Schur block at k (gather, plain K2, segment-sum)
    against the reference's Pallas-routed block in interpret mode."""
    rng = np.random.default_rng(60 + k)
    m, delta, K, rmax = 2, 3, 3, 2
    Z, V, H = cluster_inputs(rng, m, delta, K, rmax)
    Y, _, _ = cluster_inputs(rng, m, delta, K, rmax)
    lift = np.zeros((k - 2,) + Z.shape[1:])
    Z, Y = (np.concatenate([x, lift]) for x in (Z, Y))
    V = np.concatenate([V, np.zeros((k - 2,) + V.shape[1:])])
    H = np.concatenate([H, np.zeros((k - 2,) + H.shape[1:])])
    PX = tk.compute_pairings(txf(Z), txf(V), m)
    PY = tk.compute_pairings(txf(Y), txf(V), m)
    routed = tk.schur_block_contribution(PX, PY, txf(H), m, K, rmax, use_cuda=True)
    jPX, jPY = (JXF(jnp.asarray(P.limbs[:, 0].numpy())) for P in (PX, PY))
    jH = jxf(H[:, 0])
    HH = jxf(np.asarray(jk.xf_mul(JXF(jH.limbs[:, :, None]), JXF(jH.limbs[:, None, :])).limbs)
             * 0.25)
    want = jk._schur_block_contribution_pallas(jPX, jPY, HH, m, K, rmax, interpret=True)
    assert_close_xf(want.limbs, routed.limbs[:, 0].numpy(), k_ulp(k))


def spd_xf(rng, B, n, k, cond):
    """(B, k, n, n) symmetric positive definite blocks with k normalized
    limbs."""
    out = np.zeros((B, k, n, n))
    for i in range(B):
        out[i, :2] = spd_dd(rng, n, cond)
        for q in range(2, k):
            lo = rng.uniform(-0.5, 0.5, (n, n)) * np.spacing(np.abs(out[i, q - 1]))
            out[i, q] = (lo + lo.T) / 2
    return out


def test_spd_inverse_k_plain_matches_pallas_interpret():
    """K5's plain version at k=3 against the Pallas kernel in interpret
    mode, flags included (one block indefinite).  Besides the interpret
    reordering, the Pallas sqrt seeds with rsqrt: k-limb ulps times the
    condition number."""
    from clrs_tpu.ops.pallas_xf import xf_spd_inverse_pallas_k

    k, cond = 3, 1e6
    rng = np.random.default_rng(70)
    limbs = spd_xf(rng, 2, 3, k, cond)
    limbs[1, 0, 2, 2] = -50.0
    inv_p, ok_p = xf_spd_inverse_pallas_k(jnp.asarray(limbs), interpret=True)
    inv_t, ok_t = cuda_xf.spd_inverse_xf_torch(t(limbs))
    assert np.asarray(ok_p).tolist() == ok_t.tolist() == [True, False]
    assert_close_xf(np.asarray(inv_p[0]), inv_t[0].numpy(), cond * k_ulp(k))


def test_spd_inverse_panel_route_plain_matches_reference_and_pallas(monkeypatch):
    """K5's panel route (cuda_xf.spd_inverse_panels) on the plain versions,
    with cuda_dd.max_rows lowered so that n = 3 takes it in panels of 2
    and 1 rows, on the inputs of the test above: the flags, the stacked
    layout bit for bit, and the values against the Pallas K5 in interpret
    mode and the reference's xf_spd_inverse (op by op) to cond k-limb
    ulps, the tolerance of the test above."""
    from clrs_tpu.ops import linalg as jl
    from clrs_tpu.ops.pallas_xf import xf_spd_inverse_pallas_k

    k, cond = 3, 1e6
    rng = np.random.default_rng(70)
    limbs = spd_xf(rng, 2, 3, k, cond)
    limbs[1, 0, 2, 2] = -50.0
    monkeypatch.setattr(cuda_dd, "max_rows", lambda kk: 1)
    monkeypatch.setattr(cuda_xf, "SPD_PANEL", 2)
    launches = cuda_xf.spd_panel_xf.launches
    inv_t, ok_t = cuda_xf.spd_inverse_xf_torch(t(limbs))
    assert cuda_xf.spd_panel_xf.launches == launches  # the plain version counts nothing
    stacked, ok_s = cuda_xf.xf_spd_inverse_batched(t(limbs).transpose(0, 1))
    assert ok_t.tolist() == ok_s.tolist() == [True, False]
    assert torch.equal(stacked.transpose(0, 1).contiguous().view(torch.int64),
                       inv_t.contiguous().view(torch.int64))
    inv_p, ok_p = xf_spd_inverse_pallas_k(jnp.asarray(limbs), interpret=True)
    assert np.asarray(ok_p).tolist() == [True, False]
    assert_close_xf(np.asarray(inv_p[0]), inv_t[0].numpy(), cond * k_ulp(k))
    with jax.disable_jit():
        inv_j, ok_j = jl.xf_spd_inverse(JXF(jnp.asarray(limbs[0])))
    assert bool(ok_j)
    assert_close_xf(np.asarray(inv_j.limbs), inv_t[0].numpy(), cond * k_ulp(k))


@pytest.mark.parametrize("k", KS)
def test_spd_inverse_k_plain_accuracy(k):
    """A @ inv(A) = I to cond * (k-limb ulps) in exact (mpmath) arithmetic."""
    n, cond = 4, 1e4
    rng = np.random.default_rng(80 + k)
    a = spd_xf(rng, 1, n, k, cond)
    inv, ok = cuda_xf.spd_inverse_xf_torch(t(a))
    assert bool(ok[0])
    inv = inv[0].numpy()
    old = mpmath.mp.prec
    mpmath.mp.prec = 60 * k + 60

    def val(x, i, j):
        return mpmath.fsum(mpmath.mpf(float(v)) for v in x[:, i, j])

    try:
        worst = max(abs(mpmath.fsum(val(a[0], i, q) * val(inv, q, j) for q in range(n))
                        - (1 if i == j else 0)) for i in range(n) for j in range(n))
        assert worst < cond * k_ulp(k), worst
    finally:
        mpmath.mp.prec = old


# ---------------------------------------------------------------------------
# K7: step-length sandwich
# ---------------------------------------------------------------------------


def steplen_inputs(rng, B, n, k):
    """M SPD (B, k, n, n), its last block indefinite when B > 1, and dM
    symmetric indefinite."""
    m = spd_xf(rng, B, n, k, 1e3)
    if B > 1:
        m[-1, 0, 1, 1] = -5.0
    d = np.moveaxis(rand_xf(rng, (B, n, n), k), 0, 1)
    return m, (d + np.swapaxes(d, -1, -2)) / 2


def test_steplen_plain_matches_pallas_interpret():
    """K7's plain version against the Pallas kernel in interpret mode at
    k=2, two 4x4 blocks, the second indefinite: W and flags bit for bit.
    W is the float64 value limb 0 + limb 1, which interpret mode's
    reordering of the low limbs does not reach here.  k=3 is held in the
    step-length test below, over two grid steps, which keep every bit,
    unlike the k < 6 matmul bodies (ROADMAP.md, reference quirks).  At k=6
    interpret mode compiles the kernel for ~100 s and is not run: its
    arithmetic is test_xops_match_pallas_xops[6]'s, and the card holds K7
    against this plain version at every k."""
    from clrs_tpu.ops.pallas_xf import xf_steplen_sandwich_pallas_k

    k, n, B = 2, 4, 2
    m, d = steplen_inputs(np.random.default_rng(93), B, n, k)
    w_p, ok_p = xf_steplen_sandwich_pallas_k(jnp.asarray(m), jnp.asarray(d),
                                             interpret=True)
    w_t, ok_t = cuda_xf.steplen_sandwich_xf_torch(t(m), t(d))
    assert np.asarray(ok_p).tolist() == ok_t.tolist() == [True, False]
    assert_bitwise(np.asarray(w_p)[None], w_t[None])


def test_step_length_lambda_cuda_matches_reference_pallas(monkeypatch):
    """The K7 route of the step length against the reference's Pallas
    route on the same blocks at k=3, a group of two 3x3 blocks (the scalar
    blocks of both routes are xf_min_eig_sym's, held in
    test_torch_linalg.py).  The group's sandwich W is bit for bit the
    Pallas kernel's in interpret mode over two grid steps; lambda, a
    float64 Jacobi bound on W whose rotations are each library's own
    matmuls, agrees to 1e-13 of the blocks' norm; the flags exactly."""
    from types import SimpleNamespace

    from clrs_tpu.core.solver import _step_length_lambda_pallas
    from clrs_tpu.ops import pallas_xf
    from clrs_tpu_torch.core.solver import _step_length_lambda_cuda

    k, n = 3, 3
    rng = np.random.default_rng(99)
    (m, d), (m2, d2) = (steplen_inputs(rng, 1, n, k) for _ in range(2))
    info = SimpleNamespace(J=1, L=[2], Y_blocksizes=[[n, n]])
    blocks = {"M": [[m[0], m2[0]]], "dM": [[d[0], d2[0]]]}
    sandwich, seen = pallas_xf.xf_steplen_sandwich_pallas_k, []

    def capture(ms, ds, **kwargs):
        seen.append((ms, ds) + tuple(sandwich(ms, ds, **kwargs)))
        return seen[-1][2:]

    monkeypatch.setattr(pallas_xf, "xf_steplen_sandwich_pallas_k", capture)
    lam_j, ok_j = _step_length_lambda_pallas(
        *([[jxf(x) for x in row] for row in blocks[key]] for key in ("M", "dM")), info)
    (lam_t, ok_t), = _step_length_lambda_cuda(
        [tuple([[txf(x) for x in row] for row in blocks[key]] for key in ("M", "dM"))], info)
    (ms, ds, w_p, ok_p), = seen
    w_t, ok_w = cuda_xf.steplen_sandwich_xf_torch(t(ms), t(ds))
    assert np.asarray(ok_p).tolist() == ok_w.tolist() == [True, True]
    assert_bitwise(np.asarray(w_p)[None], w_t[None])
    scale = max(np.max(np.abs(np.linalg.eigvalsh(x[0]))) for x in (d[0], d2[0]))
    assert bool(ok_j) and bool(ok_t)
    assert abs(float(lam_t) - float(lam_j)) <= 1e-13 * scale, (float(lam_t), float(lam_j))


@pytest.mark.parametrize("use_cuda", [False, True])
@pytest.mark.parametrize("k", [2, 3])
def test_step_lengths_joint_equals_two_calls(k, use_cuda):
    """compute_step_lengths (the solver's one step-length call, both sides
    in one K7 launch on the card) gives the alphas and flags of two
    compute_step_length calls, bit for bit, on the plain routes: K7's plain
    version (use_cuda) and xf_min_eig_sym; groups of 3x3 (two blocks), 2x2
    and 1x1 blocks on each side, one of Y's 3x3 blocks indefinite."""
    from types import SimpleNamespace

    from clrs_tpu_torch.core.solver import compute_step_length, compute_step_lengths

    rng = np.random.default_rng(110 + k)
    info = SimpleNamespace(J=2, L=[3, 1], Y_blocksizes=[[3, 2, 3], [1]])
    sides = []
    for side in range(2):
        M, dM = [], []
        for sizes in info.Y_blocksizes:
            ms, ds = zip(*(steplen_inputs(rng, 1, n, k) for n in sizes))
            M.append([txf(m[0]) for m in ms])
            dM.append([txf(d[0]) for d in ds])
        sides += [M, dM]
    sides[2][0][2] = txf(steplen_inputs(rng, 2, 3, k)[0][1])  # indefinite
    got = compute_step_lengths(*sides, 0.7, info, use_cuda)
    want = (compute_step_length(sides[0], sides[1], 0.7, info, use_cuda)
            + compute_step_length(sides[2], sides[3], 0.7, info, use_cuda))
    assert [bool(v) for v in got[1::2]] == [bool(v) for v in want[1::2]] == [True, False]
    assert_bitwise(torch.stack(got[0::2])[None], torch.stack(want[0::2])[None])


def test_steplen_table_offsets_and_refusals():
    """K7's launch table (cuda_xf._steplen_table): one entry per block of
    every group, in order, each with its block's pointers and limb, row and
    column strides (a transposed dM read where it lies), n, and the
    offsets of its W and flags: each group's a dense run of the buffers.
    Blocks beyond the row cap, of mixed shapes or types, or an M without
    its dM are refused."""
    rng = np.random.default_rng(120)
    k = 3
    groups, blocks = [], []
    for n, B in ((6, 2), (5, 1), (6, 1), (33, 2)):
        ms = [txf(m).limbs for m in spd_xf(rng, B, n, k, 1e3)]
        ds = [txf(d).limbs.transpose(-1, -2) for d in spd_xf(rng, B, n, k, 1e3)]
        groups.append((ms, ds))
        blocks += [(m, d, n) for m, d in zip(ms, ds)]
    k_, entries, spans, w_size, ok_size = cuda_xf._steplen_table(groups)
    assert k_ == k and len(entries) == 6
    assert spans == [(2, 6, 0, 0), (1, 5, 72, 12), (1, 6, 97, 17), (2, 33, 133, 23)]
    assert (w_size, ok_size) == (133 + 2 * 33 * 33, 23 + 66)
    w_off = ok_off = 0
    for raw, (m, d, n) in zip(entries, blocks):
        got = cuda_xf._STEPLEN_ENTRY.unpack(raw)
        assert got == ((m.data_ptr(), d.data_ptr()) + m.stride() + d.stride()
                       + (w_off, ok_off, n))
        assert d.stride()[1:] == (1, n)
        w_off, ok_off = w_off + n * n, ok_off + n
    m, d = groups[0][0][0], groups[0][1][0]
    wide = torch.zeros((k, 1, 1), dtype=torch.float64).expand(k, 257, 257)
    for bad in ([([wide], [wide])], [([m], [m.float()])], [([m], [d[:, :5, :5]])],
                [([m, m], [d])], [([m[:2]], [d[:2]])]):
        with pytest.raises(ValueError):
            cuda_xf._steplen_table(groups[:1] + bad)
    two = torch.zeros((2, 1, 1), dtype=torch.float64).expand(2, 257, 257)
    assert cuda_xf._steplen_table([([two], [two])])[2] == [(1, 257, 0, 0)]


# ---------------------------------------------------------------------------
# K8: elementwise k-limb add and multiply, and xfloat's gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3, 6])
def test_elemwise_plain_matches_pallas_interpret(k):
    """K8's plain version against the Pallas kernel in interpret mode
    (N = 300, three row bands of 128 lanes with a ragged end).  The add is
    bitwise.  In the multiply interpret mode's XLA:CPU program contracts
    the two_prod products into fused multiply-adds, as for K1 (ROADMAP.md,
    reference quirks): the leading limbs agree bit for bit, the value to
    the k-limb ulp; op by op, _XOps multiplies bit for bit as the plain
    version does."""
    from clrs_tpu.ops.pallas_xf import _XOps, _elemwise_batched_k

    rng = np.random.default_rng(110 + k)
    a, b = rand_xf(rng, (300,), k), rand_xf(rng, (300,), k)
    for op in ("add", "mul"):
        want = np.asarray(_elemwise_batched_k(jnp.asarray(a), jnp.asarray(b), op,
                                              interpret=True))
        got = cuda_xf.elemwise_xf_torch(op, t(a), t(b))
        if op == "add":
            assert_bitwise(want, got)
        else:
            assert np.array_equal(want[0], got[0].numpy())
            assert_close_xf(want, got.numpy(), k_ulp(k))
            assert_limbs_bitwise(_XOps(False, k).mul(jlist(a), jlist(b)), list(got))


def test_elemwise_gate_bitwise_at_k6():
    """Inside elemwise_cuda(), xf_add and xf_mul of equal-k operands go
    through K8's plain version and at k=6 return the ungated results bit for
    bit, scalars and broadcast shapes included; a mixed-k multiply is padded
    to k limbs first, as the reference's gate pads it; at k=2 K8 computes
    the dd sequences, bit for bit; on leaving the block the switch is off."""
    from clrs_tpu_torch.ops import xfloat as tx
    from clrs_tpu_torch.ops import xops

    rng = np.random.default_rng(120)
    cases = [((), ()), ((4, 1), (1, 5)), ((3, 3), (3, 3))]
    before = cuda_xf.elemwise_xf.launches
    for sa, sb in cases:
        a, b = txf(rand_xf(rng, sa, 6)), txf(rand_xf(rng, sb, 6))
        plain = (tx.xf_add(a, b), tx.xf_mul(a, b))
        with tx.elemwise_cuda():
            gated = (tx.xf_add(a, b), tx.xf_mul(a, b))
        for p, g in zip(plain, gated):
            assert_bitwise(p.limbs.numpy(), g)
    a, b = txf(rand_xf(rng, (7,), 6)), txf(rand_xf(rng, (7,), 3))
    padded = list(b.limbs) + [torch.zeros(7, dtype=torch.float64)] * 3
    with tx.elemwise_cuda():
        assert_limbs_bitwise(xops.mul(list(a.limbs), padded), list(tx.xf_mul(a, b).limbs))
    a2, b2 = txf(rand_dd(rng, (5,))), txf(rand_dd(rng, (5,)))
    plain = (tx.xf_add(a2, b2), tx.xf_mul(a2, b2))
    with tx.elemwise_cuda():
        gated = (tx.xf_add(a2, b2), tx.xf_mul(a2, b2))
    for p, g in zip(plain, gated):
        assert_bitwise(p.limbs.numpy(), g)
    assert tx._ELEMWISE_CUDA is False
    assert cuda_xf.elemwise_xf.launches == before  # CPU tensors: the plain version


def elemwise_materialized(op, a, b):
    """The path K8's operand description replaced, kept here to hold the
    new plain version against: both limb tensors broadcast and copied to
    (k, N) rows, zero limbs appended, the op on the rows, then reshaped."""
    from clrs_tpu_torch.ops import xops

    k = max(a.shape[0], b.shape[0])
    shape = np.broadcast_shapes(a.shape[1:], b.shape[1:])

    def rows(x):
        r = TXF(x).broadcast_to(shape).limbs.reshape(x.shape[0], -1)
        return torch.cat([r, r.new_zeros((k - x.shape[0], r.shape[1]))])

    fn = xops.add if op == "add" else xops.mul
    return torch.stack(fn(list(rows(a)), list(rows(b)))).reshape((k,) + shape)


def elemwise_operands(rng, k):
    """Operand pairs as the solver and its callers hand them to K8:
    broadcast batches and scalars, rows against columns, stride-0
    expansions, transposed and sliced views, mixed limb counts."""
    r = lambda shape, kk=k: t(rand_xf(rng, shape, kk))  # noqa: E731
    return [
        (r((10, 1, 1)), r((10, 11, 11))),
        (r(()), r((11,))),
        (r((6, 1)), r((1, 6))),
        (r((1, 5)).expand(k, 4, 5), r((4, 5))),
        (r((7, 9)).transpose(1, 2), r((9, 14))[:, :, ::2]),
        (r((3, 3), max(2, k - 1)), r((3, 3))),
        (r((11,), 2), r((11, 11))),
    ]


@pytest.mark.parametrize("k", [2, 3, 5, 12])
def test_elemwise_plain_operand_description_bitwise(k):
    """K8's plain version takes each operand as it lies (broadcast, stride
    0, its own limb count) and equals, bit for bit, the broadcast-copy-
    and-pad path it replaces; so does xfloat's switch, on the CPU."""
    from clrs_tpu_torch.ops import xfloat as tx

    for a, b in elemwise_operands(np.random.default_rng(140 + k), k):
        for op, xf_op in (("add", tx.xf_add), ("mul", tx.xf_mul)):
            want = elemwise_materialized(op, a, b)
            assert_bitwise(want.numpy(), cuda_xf.elemwise_xf_torch(op, a, b))
            with tx.elemwise_cuda():
                assert_bitwise(want.numpy(), xf_op(TXF(a), TXF(b)))


def read_by_plan(desc, x, limbs, limb_stride, strides):
    """The operand values K8 loads under its description: limb q of output
    element e at x's storage + q * limb_stride + offset(e), the offset from
    e's index over the (right-aligned) dims, limbs past the operand's own
    as zeros; mirrors csrc/elemwise_xf.cu."""
    import struct

    d = struct.unpack("<20q", desc)
    k, N, ndim, dims = d[0], d[2], d[3], d[4:8]
    outer = 4 - ndim
    rem, off = torch.arange(N), torch.zeros(N, dtype=torch.int64)
    for ax in range(3, outer, -1):
        off += (rem % dims[ax]) * strides[ax]
        rem = rem // dims[ax]
    off += rem * strides[outer]
    flat = torch.as_strided(x, (int(off.max()) + (limbs - 1) * limb_stride + 1,), (1,),
                            x.storage_offset())
    got = [flat[q * limb_stride + off] for q in range(limbs)]
    return torch.stack(got + [torch.zeros(N, dtype=x.dtype)] * (k - limbs))


@pytest.mark.parametrize("k", [2, 7, 12])
def test_elemwise_plan_reads_operands_in_place(k):
    """The description K8's wrapper hands the kernel (limb counts, limb
    strides, per-axis element strides after merging axes) addresses, in
    the operands' own storage, exactly the broadcast and zero-padded limbs
    of the plain version; equal layouts take one axis, and the plan is
    made once per layout pair."""
    import struct

    for a, b in elemwise_operands(np.random.default_rng(150 + k), k):
        for op in ("add", "mul"):
            desc, shape, N = cuda_xf._elemwise_plan(op, a, b)
            d = struct.unpack("<20q", desc)
            kk = max(a.shape[0], b.shape[0])
            assert (d[0], d[1], N) == (kk, op == "mul", int(np.prod(shape[1:])))
            assert shape == (kk,) + tuple(np.broadcast_shapes(a.shape[1:], b.shape[1:]))
            for x, at in ((a, 8), (b, 14)):
                want = TXF(x).broadcast_to(shape[1:]).limbs.reshape(x.shape[0], -1)
                want = torch.cat([want, want.new_zeros((kk - x.shape[0], N))])
                got = read_by_plan(desc, x, d[at], d[at + 1], d[at + 2:at + 6])
                assert_bitwise(want.numpy(), got)
    x, y = t(rand_xf(np.random.default_rng(0), (6, 6), k)), t(rand_xf(np.random.default_rng(1), (6, 6), k))
    assert struct.unpack("<20q", cuda_xf._elemwise_plan("add", x, y)[0])[3] == 1


def test_elemwise_refusals():
    """K8's wrapper raises on what its kernel does not take: other devices
    or a device mix, non-float64 limbs, more than four axes that do not
    merge, an unknown op, and a limb count the library holds no kernel
    for."""
    meta = torch.empty((3, 4), dtype=torch.float64, device="meta")
    cpu = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_xf.elemwise_xf("add", meta, meta)
    with pytest.raises(ValueError):
        cuda_xf.elemwise_xf("add", cpu, meta)
    with pytest.raises(ValueError):
        cuda_xf._elemwise_plan("add", cpu, cpu.float())
    with pytest.raises(ValueError):
        cuda_xf._elemwise_plan("sub", cpu, cpu)
    wide = torch.zeros((3, 2, 3, 2, 3, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_xf._elemwise_plan("mul", wide, wide.transpose(1, 2))
    assert struct_ndim(cuda_xf._elemwise_plan("mul", wide, wide)[0]) == 1
    with pytest.raises(NotImplementedError):
        cuda_xf._elemwise_plan("add", torch.zeros((13, 2), dtype=torch.float64), cpu)


def struct_ndim(desc):
    import struct

    return struct.unpack("<20q", desc)[3]


# ---------------------------------------------------------------------------
# K3 and K4: operands read in place
# ---------------------------------------------------------------------------


def batch_broadcast(x, batch):
    """The limb tensor x (k, *bx, rows, cols) broadcast to (k, *batch,
    rows, cols), a view."""
    x = x.reshape(x.shape[:1] + (1,) * (len(batch) + 3 - x.ndim) + x.shape[1:])
    return torch.broadcast_to(x, x.shape[:1] + batch + x.shape[-2:])


def matmul_materialized(a, b):
    """The path the matmul's operand description replaced, kept here to
    hold the new one against: both limb tensors broadcast to the common
    batch, copied contiguous and flattened to one batch axis, the plain
    version on the copies, the output reshaped back."""
    k = a.shape[0]
    batch = tuple(np.broadcast_shapes(a.shape[1:-2], b.shape[1:-2]))
    (n, K), m = a.shape[-2:], b.shape[-1]
    al = batch_broadcast(a, batch).contiguous().reshape(k, -1, n, K)
    bl = batch_broadcast(b, batch).contiguous().reshape(k, -1, K, m)
    plain = cuda_xf.dd_matmul_seq_torch if k == 2 else cuda_xf.matmul_xf_torch
    return plain(al, bl).reshape((k,) + batch + (n, m))


def matmul_operands(rng, k):
    """test_torch_cuda.matmul_operands on the CPU."""
    return cuda_matmul_operands(lambda shape: t(rand_xf(rng, shape, k)))


def read_matmul_plan(desc, x, which):
    """The limbs the kernel loads for operand `which` (0: A, 1: B) under
    its description, at every (batch, row, column) of the operand's
    broadcast shape: x's storage at limb_stride * q + the batch, row and
    column offsets; mirrors csrc/matmul_xf.cu."""
    import struct

    d = struct.unpack("<20q", desc)
    k, Kc, n, m, dims = d[0], d[2], d[3], d[4], d[5:8]
    ls, bst, rs, cs = d[8 + 6 * which], d[9 + 6 * which:12 + 6 * which], \
        d[12 + 6 * which], d[13 + 6 * which]
    rows, cols = (n, Kc) if which == 0 else (Kc, m)
    idx = torch.zeros(dims + (rows, cols), dtype=torch.int64)
    for ax, (dim, st) in enumerate(zip(dims, bst)):
        shape = [1] * 5
        shape[ax] = dim
        idx = idx + (torch.arange(dim) * st).reshape(shape)
    idx = idx + (torch.arange(rows) * rs)[:, None] + torch.arange(cols) * cs
    flat = torch.as_strided(x, (int(idx.max()) + (k - 1) * ls + 1,), (1,),
                            x.storage_offset())
    return torch.stack([flat[q * ls + idx] for q in range(k)])


@pytest.mark.parametrize("k", [2, 3, 12])
def test_matmul_plan_reads_operands_in_place(k):
    """The description K3's and K4's wrappers hand the kernel (limb
    strides, batch strides with 0 where broadcast, row and column
    strides, after merging the batch axes) addresses, in the operands' own
    storage, exactly the broadcast operands; the step count is K at k=2
    and K padded to 8 above; the output is the broadcast batch."""
    import struct

    for a, b in matmul_operands(np.random.default_rng(160 + k), k):
        desc, shape, N = cuda_xf._matmul_plan(a, b)
        d = struct.unpack("<20q", desc)
        batch = tuple(np.broadcast_shapes(a.shape[1:-2], b.shape[1:-2]))
        K = a.shape[-1]
        assert d[:5] == (k, K if k == 2 else cuda_xf.padded_contraction(K), K,
                         a.shape[-2], b.shape[-1])
        assert shape == (k,) + batch + (a.shape[-2], b.shape[-1])
        assert N == int(np.prod(shape[1:])) and int(np.prod(d[5:8])) == int(np.prod(batch))
        for which, x in enumerate((a, b)):
            want = batch_broadcast(x, batch)
            got = read_matmul_plan(desc, x, which)
            assert_bitwise(want.reshape(got.shape).numpy(), got)
    x = t(rand_xf(np.random.default_rng(0), (4, 6, 6), k))
    assert struct.unpack("<20q", cuda_xf._matmul_plan(x, x)[0])[5:8] == (1, 1, 4)


@pytest.mark.parametrize("k", [2, 3])
def test_matmul_plain_in_place_operands_bitwise(k):
    """K3's and K4's plain versions take the operands as they lie
    (transposed, sliced, broadcast batches) and give, bit for bit, what
    they give on broadcast contiguous copies; so does xf_matmul_k, which
    now hands its operands over uncopied, on V.mT as the solver calls it."""
    from clrs_tpu_torch.ops.xfloat import XF

    for a, b in matmul_operands(np.random.default_rng(170 + k), k):
        want = matmul_materialized(a, b)
        plain = cuda_xf.dd_matmul_seq_torch if k == 2 else cuda_xf.matmul_xf_torch
        assert_bitwise(want.numpy(), plain(a, b))
        assert_bitwise(want.numpy(), cuda_xf.xf_matmul_k(XF(a), XF(b)))


def test_matmul_plan_refusals():
    """The matmul's description raises on what its kernel does not take:
    a device mix, non-float64 limbs, unequal limb counts or contraction
    lengths, batches that do not broadcast, more than three batch axes
    that do not merge, and a limb count the library holds no kernel for."""
    cpu = torch.zeros((3, 2, 4, 4), dtype=torch.float64)
    meta = torch.empty((3, 2, 4, 4), dtype=torch.float64, device="meta")
    for a, b in ((cpu, meta), (cpu, cpu.float()), (cpu, cpu[:2]), (cpu, cpu[..., :3, :]),
                 (cpu, torch.zeros((3, 3, 4, 4), dtype=torch.float64))):
        with pytest.raises(ValueError):
            cuda_xf._matmul_plan(a, b)
    with pytest.raises(ValueError):
        cuda_xf.matmul_xf(cpu, meta)
    wide = torch.zeros((3, 2, 3, 2, 3, 2, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_xf._matmul_plan(wide, wide.transpose(1, 3))
    assert cuda_xf._matmul_plan(wide, wide)[0][40:64] == struct_pack(1, 1, 36)
    with pytest.raises(NotImplementedError):
        cuda_xf._matmul_plan(torch.zeros((13, 2, 2), dtype=torch.float64),
                             torch.zeros((13, 2, 2), dtype=torch.float64))


def struct_pack(*v):
    import struct

    return struct.pack(f"<{len(v)}q", *v)


# ---------------------------------------------------------------------------
# K9: dd SPD inverse for many small matrices
# ---------------------------------------------------------------------------


def test_wide_plan_reads_input_in_place():
    """K9's description reads the input where it lies (B-major, the
    batch-minor view of a (2, n, n, B) array, transposed blocks) and lays
    out the launch: G lanes per dot product, the widest power of two that
    fills a team of up to 256 threads (at most 32 and np2, at least np2 /
    16), narrower while the batch's teams overfill the card; several
    matrices a block while they fit in 256 threads and two blocks an SM;
    L and W in shared memory up to n = 96 and in scratch above."""
    import struct

    x = torch.zeros((5, 2, 7, 7), dtype=torch.float64)
    minor = torch.zeros((2, 7, 7, 5), dtype=torch.float64).permute(3, 0, 1, 2)
    for v, strides in ((x, (98, 49, 7, 1)), (minor, (1, 245, 35, 5)),
                       (x.transpose(-1, -2), (98, 49, 1, 7))):
        desc, B, n, scratch = cuda_dd._wide_plan(v)
        assert (B, n, scratch) == (5, 7, 0)
        assert struct.unpack("<11q", desc) == (5, 7) + strides + (64, 4, 1, 9, 8)

    def plan(B, n):  # (team, teams, in shared memory, ldw, G), scratch
        one = torch.zeros((1, 2, 1, 1), dtype=torch.float64).expand(B, 2, n, n)
        desc, _, _, scratch = cuda_dd._wide_plan(one)
        return struct.unpack("<11q", desc)[6:], scratch

    assert plan(256, 64) == ((256, 1, 1, 65, 4), 0)  # 102 KB a block: two an SM
    assert plan(10, 1) == ((32, 8, 1, 9, 1), 0)
    assert plan(1, 11) == ((192, 1, 1, 17, 16), 0)
    assert plan(4000, 11) == ((64, 4, 1, 17, 4), 0)
    assert plan(3, 33) == ((160, 1, 1, 41, 4), 0)
    assert plan(2, 96)[0][2] == 1 and plan(2, 97)[0][2] == 0
    lw = 512 * 513 // 2 + 512 * 513
    assert plan(2, 512) == ((256, 1, 0, 513, 32), 2 * 2 * lw)
    for bad in (torch.zeros((1, 2, 1, 1), dtype=torch.float64).expand(1, 2, 513, 513),
                torch.zeros((2, 3, 4, 4), dtype=torch.float64),
                torch.zeros((2, 2, 4, 4), dtype=torch.float32),
                torch.zeros((2, 2, 4, 5), dtype=torch.float64),
                torch.zeros((2, 4, 4), dtype=torch.float64)):
        with pytest.raises(ValueError):
            cuda_dd._wide_plan(bad)


def test_spd_inverse_wide_plain_matches_pallas_interpret():
    """K9's plain version against the Pallas kernel in interpret mode: five
    blocks, one indefinite, which the Pallas wrapper runs in chunks of two
    (the last chunk padded with an identity block, whose result it drops)
    and the port in one unpadded batch.  Flags bitwise; values to
    cond * 2^-100, interpret mode contracting the dd products as for K1;
    and bit for bit K1's plain version."""
    from clrs_tpu.ops.pallas_dd import dd_spd_inverse_pallas_wide

    n, cond = 3, 1e4
    rng = np.random.default_rng(130)
    limbs = np.stack([spd_dd(rng, n, cond) for _ in range(5)])
    limbs[3, 0, 1, 1] = -20.0
    inv_p, ok_p = dd_spd_inverse_pallas_wide(jnp.asarray(limbs), interpret=True,
                                             max_chunk_elems=2 * n * n)
    inv_t, ok_t = cuda_dd.dd_spd_inverse_wide_torch(t(limbs))
    assert np.asarray(ok_p).tolist() == ok_t.tolist() == [True, True, True, False, True]
    for i in (0, 1, 2, 4):
        assert_close_dd(np.asarray(inv_p[i]), inv_t[i].numpy(), cond * 2.0 ** -100)
    inv_1, ok_1 = cuda_dd.dd_spd_inverse_torch(t(limbs))
    assert torch.equal(ok_1, ok_t)
    assert_bitwise(inv_1.numpy(), inv_t)
