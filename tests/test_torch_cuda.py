"""The port's CUDA kernels K1-K9 on the card, each bit for bit against its
plain PyTorch version (the comparison that chip_smoke.py also makes at the
main path's and at wide shapes; K8 also on broadcast and mixed-limb
operands, K1 at n = 1..65, 257 and 1024, K5 and K7 at every shape of their
dot products' halving tree at every k, K7 on one launch of blocks of every
size, K2 on the pairings as compute_pairings lays them out, copied and
broadcast, K9 against K1 at n = 1..65, 257 and 512 on both layouts and
on special values).  These tests need an NVIDIA GPU and nvcc and skip
elsewhere; the file imports no JAX, so it runs on the card's machine:
python -m pytest -m gpu --noconftest tests/test_torch_cuda.py
"""

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import pytest
import torch

from clrs_tpu_torch.ops import cuda_dd, cuda_xf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def rand_dd(rng, shape):
    hi = rng.standard_normal(shape)
    lo = rng.uniform(-0.5, 0.5, shape) * np.spacing(np.abs(hi))
    return torch.from_numpy(np.stack([hi, lo]))


def spd_batch(rng, B, n, cond):
    out = np.zeros((B, 2, n, n))
    for b in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
        out[b, 0] = (A + A.T) / 2
    return torch.from_numpy(out)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n", [(1, 11), (10, 1), (4, 33)])
def test_spd_inverse_kernel_bitwise(cuda, B, n):
    a = spd_batch(np.random.default_rng(n), B, n, 1e8).to(cuda)
    a[-1, 0, 0, 0] = -1.0  # the last block is indefinite
    before = cuda_dd.dd_spd_inverse.launches
    inv_k, ok_k = cuda_dd.dd_spd_inverse(a)
    inv_p, ok_p = cuda_dd.dd_spd_inverse_torch(a)
    assert cuda_dd.dd_spd_inverse.launches == before + 1
    assert torch.equal(ok_k, ok_p) and not bool(ok_k[-1])
    good = ok_p.nonzero()[:, 0]
    assert torch.equal(inv_k[good].view(torch.int64), inv_p[good].view(torch.int64))


@pytest.mark.gpu
def test_k1_every_tree_size_bitwise(cuda):
    """K1, the k=2 instance of K5's kernel, at n = 1..65 (every shape of the
    dot products' halving tree), two blocks of which the second is
    indefinite, on (B, 2, n, n) and on the solver's stacked (2, B, n, n)
    view, both read in place: flags and limbs equal to K1's plain version
    (run on the CPU copies, bit for bit what it gives on the card)."""
    rng = np.random.default_rng(30)
    for n in range(1, 66):
        a = spd_batch(rng, 2, n, 1e6)
        a[1, 0, n // 2, n // 2] = -1.0
        inv_p, ok_p = cuda_dd.dd_spd_inverse_torch(a)
        before = cuda_dd.dd_spd_inverse.launches
        inv_k, ok_k = cuda_dd.dd_spd_inverse(a.to(cuda))
        inv_s, ok_s = cuda_xf.xf_spd_inverse_batched(a.to(cuda).transpose(0, 1))
        assert cuda_dd.dd_spd_inverse.launches == before + 2
        assert ok_k.tolist() == ok_s.tolist() == ok_p.tolist() == [True, False], n
        assert bitwise(inv_k[0].cpu(), inv_p[0]) and bitwise(inv_s[:, 0].cpu(), inv_p[0]), n


@pytest.mark.gpu
@pytest.mark.parametrize("n", [257, 1024])
def test_k1_large_bitwise(cuda, n):
    """K1 above the 256 threads of its block (each thread finishes up to
    four rows), up to its cap of 1024 rows, against its plain version on
    the card; one row more raises."""
    a = spd_batch(np.random.default_rng(n), 1, n, 1e4).to(cuda)
    inv_k, ok_k = cuda_dd.dd_spd_inverse(a)
    inv_p, ok_p = cuda_dd.dd_spd_inverse_torch(a)
    assert ok_k.tolist() == ok_p.tolist() == [True]
    assert bitwise(inv_k, inv_p)
    if n == cuda_dd.max_rows(2):
        with pytest.raises(ValueError):
            cuda_dd.dd_spd_inverse(torch.zeros((1, 2, n + 1, n + 1), dtype=torch.float64,
                                               device=cuda))


# K2's shapes (G, m, K, rmax): config 1's cluster and its ten sign
# clusters, two clusters of m=2 at rank 2, and the wide block (P = 6, T = 128)
SCHUR_SHAPES = [(1, 1, 11, 1), (10, 1, 1, 1), (2, 2, 3, 2), (1, 3, 64, 2)]


def schur_operands(rng, k, G, m, K, rmax):
    """Pairings laid out as compute_pairings returns them (transposed views
    of (k, G, T, m, m, T)) and positive weights HH (k, G, T, T)."""
    T = K * rmax
    px, py = (rand_xf(rng, (G, T, m, m, T), k).permute(0, 1, 3, 2, 4, 5) for _ in range(2))
    hh = rand_xf(rng, (G, T, T), k).abs()
    return px, py, hh


def check_schur(cuda, k, G, m, K, rmax):
    """K2 at k on one shape, bitwise against its plain version on the
    card: on the compute_pairings views, on contiguous copies, and with PX
    broadcast over the clusters; one launch each."""
    px, py, hh = (x.to(cuda) for x in schur_operands(np.random.default_rng(k + G + m), k, G,
                                                     m, K, rmax))
    for x, y, h in ((px, py, hh), (px.contiguous(), py.contiguous(), hh),
                    (px[:, :1].expand(px.shape), py, hh)):
        before = cuda_xf.schur_pairs.launches
        got = cuda_xf.schur_pairs(x, y, h)
        assert cuda_xf.schur_pairs.launches == before + 1
        assert bitwise(got, cuda_xf.schur_pairs_torch(x, y, h)), (k, G, m, K, rmax)


@pytest.mark.gpu
@pytest.mark.parametrize("G,m,K,rmax", SCHUR_SHAPES)
def test_schur_pairs_kernel_bitwise(cuda, G, m, K, rmax):
    check_schur(cuda, 2, G, m, K, rmax)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,K,m", [(1, 6, 6, 11), (3, 11, 6, 11), (2, 40, 70, 33)])
def test_matmul_kernel_bitwise(cuda, B, n, K, m):
    rng = np.random.default_rng(n)
    a = rand_dd(rng, (B, n, K)).to(cuda)
    b = rand_dd(rng, (B, K, m)).to(cuda)
    assert torch.equal(cuda_xf.dd_matmul(a, b).view(torch.int64),
                       cuda_xf.dd_matmul_seq_torch(a, b).view(torch.int64))


def rand_xf(rng, shape, k):
    limbs = [rng.standard_normal(shape)]
    for _ in range(1, k):
        limbs.append(rng.uniform(-0.5, 0.5, shape) * np.spacing(np.abs(limbs[-1])))
    return torch.from_numpy(np.stack(limbs))


def bitwise(a, b):
    return torch.equal(a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


BUILT_KS = list(range(3, 13))  # the k-limb instantiations (eft.cuh: CLRS_FOR_EACH_K)


@pytest.mark.gpu
@pytest.mark.parametrize("k", BUILT_KS)
@pytest.mark.parametrize("B,n,K,m", [(1, 6, 6, 11), (10, 1, 1, 1), (2, 40, 70, 33)])
def test_matmul_xf_kernel_bitwise(cuda, k, B, n, K, m):
    rng = np.random.default_rng(n + k)
    a = rand_xf(rng, (B, n, K), k).to(cuda)
    b = rand_xf(rng, (B, K, m), k).to(cuda)
    before = cuda_xf.matmul_xf.launches
    assert bitwise(cuda_xf.matmul_xf(a, b), cuda_xf.matmul_xf_torch(a, b))
    assert cuda_xf.matmul_xf.launches == before + 1


def matmul_operands(r):
    """Operand pairs as the solver and other callers hand them to K3/K4,
    r(shape) making a random limb tensor (k, *shape) on the device under
    test: V.mT as A and as B (a transposed view), a sliced column block, a
    batch broadcast from one matrix and from a missing axis, an expanded
    (stride-0) batch, two batch axes and a batch of one, the sign
    clusters.  tests/test_torch_kernels.py holds the plain versions and
    the operand description to the same pairs on the CPU."""
    V = r((1, 5, 11))
    x = r((1, 4, 3))
    return [
        (V.transpose(-1, -2), r((1, 5, 11))),  # compute_pairings: V.mT @ ZVt
        (r((1, 5, 11)), V.transpose(-1, -2)),  # weighted_A_block: U @ V.mT
        (r((2, 6, 9))[..., 1:7], r((2, 6, 4))),  # sliced columns of A
        (r((1, 3, 4)), r((3, 4, 5))),  # a batch of one against three
        (r((3, 4)), r((2, 4, 3))[..., ::2]),  # no batch axis; strided B
        (x.expand(x.shape[0], 5, 4, 3), r((5, 3, 2))),  # stride-0 batch
        (r((2, 1, 3, 4)), r((3, 4, 2)).transpose(-1, -2).transpose(-1, -2)),
        (r((10, 1, 1)), r((10, 1, 1))),  # the sign clusters
    ]


def matmul_kernel(k):
    """K3 at k=2, K4 above: the wrapper and its plain version."""
    if k == 2:
        return cuda_xf.dd_matmul, cuda_xf.dd_matmul_seq_torch
    return cuda_xf.matmul_xf, cuda_xf.matmul_xf_torch


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2] + BUILT_KS)
def test_matmul_kernels_in_place_operands_bitwise(cuda, k):
    """K3 and K4 read transposed, sliced and broadcast operands where they
    lie, one launch each, through the wrapper and through xf_matmul_k."""
    from clrs_tpu_torch.ops.xfloat import XF

    kernel, plain = matmul_kernel(k)
    rng = np.random.default_rng(700 + k)
    for a, b in matmul_operands(lambda shape: rand_xf(rng, shape, k).to(cuda)):
        want = plain(a, b)
        before = kernel.launches
        assert bitwise(kernel(a, b), want)
        assert bitwise(cuda_xf.xf_matmul_k(XF(a), XF(b)).limbs, want)
        assert kernel.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3, 4, 6, 10, 12])
def test_matmul_kernels_chunk_and_block_boundaries(cuda, k):
    """Output counts around a block of 32 threads (1, 31, 32, 33, 121,
    129) and contractions around the kernel's chunks of products: K =
    1..24 at k=2 (no padding), padded to 8, 16 and 24 steps above.  Then
    one row of A outside the FMA TwoProd's range (dd_matmul's docstring):
    scaled by 2^999, its limbs overflow Dekker's split, so the plain
    version's entries of that row hold NaN; at k <= 4, where the card
    forms the exact products by the FMA, the kernel's are finite and the
    in-range result scaled by 2^999, bit for bit; above, where the card
    splits too, NaN in the same places.  The other rows stay bitwise."""
    kernel, plain = matmul_kernel(k)
    rng = np.random.default_rng(800 + k)
    for n, m in ((1, 1), (1, 31), (4, 8), (3, 11), (11, 11), (3, 43)):
        for K in ((1, 7, 8, 9, 16, 17, 24) if k == 2 else (8, 9, 17, 24)):
            a = rand_xf(rng, (1, n, K), k).to(cuda)
            b = rand_xf(rng, (1, K, m), k).to(cuda)
            assert bitwise(kernel(a, b), plain(a, b)), (n, K, m)
    a, b = rand_xf(rng, (1, 3, 8), k).to(cuda), rand_xf(rng, (1, 8, 5), k).to(cuda)
    big = a.clone()
    big[:, :, 1] *= 2.0 ** 999
    got, want = kernel(big, b), plain(big, b)
    assert bitwise(got[:, :, ::2], want[:, :, ::2])
    assert torch.isnan(want[:, :, 1]).any()
    if k <= 4:
        assert bitwise(got[:, :, 1], plain(a, b)[:, :, 1] * 2.0 ** 999)
    else:
        keep = ~torch.isnan(want)
        assert torch.equal(torch.isnan(got), ~keep) and bitwise(got[keep], want[keep])


def two_prod_inputs(rng, count):
    """Operand pairs for the exact product: inside the range where
    Dekker's two_prod is exact (csrc/eft.cuh: two_prod_fma), zeros of
    either sign among them; past the split's overflow (|a| >= 2^997); and
    past the underflow of the error term (exponents summing below -969)."""
    def pairs(ea, eb):
        mant = lambda: rng.uniform(1.0, 2.0, count) * rng.choice([-1.0, 1.0], count)  # noqa: E731
        return np.ldexp(mant(), ea), np.ldexp(mant(), eb)

    ea = rng.integers(-1000, 996, count)
    eb = rng.integers(np.maximum(-1000, -969 - ea), np.minimum(996, 1022 - ea))
    a, b = pairs(ea, eb)
    a[:64], b[:64] = np.ldexp(rng.integers(-2 ** 20, 2 ** 20, 64), -10), 1.5  # exact
    zeros = np.array([0.0, -0.0, 1.5, -1.5, 3e-300, -3e-300, 1e300, -1e300])
    za, zb = np.meshgrid(zeros[:2], zeros)
    inside = (np.concatenate([a, za.ravel(), zb.ravel()]),
              np.concatenate([b, zb.ravel(), za.ravel()]))
    ea = rng.integers(997, 1023, count)
    overflow = pairs(ea, rng.integers(-60, 1, count) - (ea - 997))
    ea = rng.integers(-1022, -60, count)
    underflow = pairs(ea, np.maximum(-1022, rng.integers(-1040, -975, count) - ea))
    return inside, overflow, underflow


def exact_error(a, b, p):
    """a*b - p rounded once (Python's Fraction to float rounds correctly),
    and whether that is exact."""
    from fractions import Fraction

    d = [Fraction(x) * Fraction(y) - Fraction(z)
         for x, y, z in zip(a.tolist(), b.tolist(), p.tolist())]
    return np.array([float(v) for v in d]), np.array([Fraction(float(v)) == v for v in d])


def check_two_prod(both, rng):
    """The assertions of test_two_prod_fma_range on both(a, b) -> (p, e)
    of the fused multiply-add and (p, e) of Dekker's splitting; returns
    the share of underflowing pairs on which Dekker's error term misses."""
    inside, overflow, underflow = two_prod_inputs(rng, 4096)
    p, e, pd, ed = both(*inside)
    assert np.array_equal(p.view(np.int64), pd.view(np.int64))
    assert np.array_equal(e.view(np.int64), ed.view(np.int64))
    assert not np.signbit(e[e == 0]).any()
    want, exact = exact_error(*inside, p)
    assert np.array_equal(e, want) and exact.all()
    p, e, pd, ed = both(*overflow)
    assert np.isfinite(p).all() and np.isnan(ed).all()
    want, exact = exact_error(*overflow, p)
    assert np.array_equal(e, want) and exact.all()
    p, e, pd, ed = both(*underflow)
    assert np.array_equal(e, exact_error(*underflow, p)[0])
    return float(np.mean(ed != e))


@pytest.mark.gpu
def test_two_prod_fma_range(cuda):
    """The matmul's exact product by the fused multiply-add equals Dekker's
    two_prod bit for bit, zero signs included (+0 for an exact product),
    on the range where Dekker's is exact, and p + e is a*b there.  Outside
    it: where the split overflows, Dekker's error term is NaN and the
    FMA's still exact; where the error term underflows, the FMA's is a*b
    - p rounded once and Dekker's misses it on some pairs (the share is
    printed)."""
    from clrs_tpu_torch.ops import _build

    def both(a, b):
        a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
        out = [torch.empty_like(a) for _ in range(4)]
        rc = _build.library().clrs_two_prod_pairs(
            a.data_ptr(), b.data_ptr(), *(o.data_ptr() for o in out), a.numel(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        return [o.cpu().numpy() for o in out]

    missed = check_two_prod(both, np.random.default_rng(900))
    print(f"underflow: Dekker's error term differs from the FMA's on {missed:.3f} of pairs")
    assert missed > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", BUILT_KS)
@pytest.mark.parametrize("G,m,K,rmax", SCHUR_SHAPES)
def test_schur_pairs_xf_kernel_bitwise(cuda, k, G, m, K, rmax):
    check_schur(cuda, k, G, m, K, rmax)


@pytest.mark.gpu
@pytest.mark.parametrize("k", (2, 3, 6))
@pytest.mark.parametrize("G,m,K,rmax", SCHUR_SHAPES)
def test_schur_pairs_row_band_bitwise(cuda, k, G, m, K, rmax):
    """K2 on a band of rows t1 (the views an intra rank hands it: PX's
    rows t1, PY's columns t1, HH's rows t1), bitwise its plain version and
    the whole block's rows: each half, and an odd band."""
    px, py, hh = (x.to(cuda) for x in schur_operands(np.random.default_rng(k + G + m), k, G,
                                                     m, K, rmax))
    T = K * rmax
    whole = cuda_xf.schur_pairs(px, py, hh)
    for band in (slice(0, T // 2), slice(T // 2, T), slice(1, T, 2)):
        x, y, h = px[..., band, :, :], py[..., band], hh[..., band, :]
        got = cuda_xf.schur_pairs(x, y, h)
        assert bitwise(got, cuda_xf.schur_pairs_torch(x, y, h)), (k, G, m, K, rmax, band)
        assert bitwise(got, whole[..., band, :, :]), (k, G, m, K, rmax, band)


@pytest.mark.gpu
@pytest.mark.parametrize("k", (2, 3, 4))
def test_xf_matmul_mxu_card_bitwise_cpu(cuda, k):
    """The int8-sliced matmul (torch._int_mm on the card) bitwise the same
    function on the CPU, at shapes on either side of _int_mm's rules."""
    from clrs_tpu_torch.ops.mxu_matmul import xf_matmul_mxu
    from clrs_tpu_torch.ops.xfloat import XF

    rng = np.random.default_rng(60 + k)
    for B, n, K, m in ((1, 6, 6, 11), (10, 1, 1, 1), (3, 17, 16, 8), (1, 64, 64, 64)):
        a, b = rand_xf(rng, (B, n, K), k), rand_xf(rng, (B, K, m), k)
        want = xf_matmul_mxu(XF(a), XF(b)).limbs
        got = xf_matmul_mxu(XF(a.to(cuda)), XF(b.to(cuda))).limbs.cpu()
        assert bitwise(got, want), (k, B, n, K, m)


@pytest.mark.gpu
@pytest.mark.parametrize("k", BUILT_KS)
def test_spd_inverse_xf_kernel_bitwise(cuda, k):
    a = spd_batch(np.random.default_rng(k), 3, 9, 1e8)
    a = torch.cat([a, torch.zeros((3, k - 2, 9, 9), dtype=torch.float64)], dim=1).to(cuda)
    a[-1, 0, 0, 0] = -1.0  # the last block is indefinite
    inv_k, ok_k = cuda_xf.spd_inverse_xf(a)
    inv_p, ok_p = cuda_xf.spd_inverse_xf_torch(a)
    assert torch.equal(ok_k, ok_p) and not bool(ok_k[-1])
    good = ok_p.nonzero()[:, 0]
    assert bitwise(inv_k[good], inv_p[good])


@pytest.mark.gpu
def test_unbuilt_limb_count_raises(cuda):
    a = torch.zeros((13, 1, 2, 2), dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError):
        cuda_xf.matmul_xf(a, a)


ALL_KS = [2] + BUILT_KS  # K7 and K8 (eft.cuh: CLRS_FOR_EACH_K_FROM_2)


@pytest.mark.gpu
@pytest.mark.parametrize("k", ALL_KS)
def test_steplen_xf_kernel_bitwise(cuda, k):
    rng = np.random.default_rng(200 + k)
    m = spd_batch(rng, 3, 6, 1e6)
    m = torch.cat([m, torch.zeros((3, k - 2, 6, 6), dtype=torch.float64)], dim=1).to(cuda)
    m[-1, 0, 2, 2] = -1.0  # the last block is indefinite
    d = rand_xf(rng, (3, 6, 6), k).transpose(0, 1).to(cuda)
    d = (d + d.transpose(-1, -2)) / 2
    before = cuda_xf.steplen_sandwich_xf.launches
    w_k, ok_k = cuda_xf.steplen_sandwich_xf(m, d)
    w_p, ok_p = cuda_xf.steplen_sandwich_xf_torch(m, d)
    assert cuda_xf.steplen_sandwich_xf.launches == before + 1
    assert torch.equal(ok_k, ok_p) and ok_k.tolist() == [True, True, False]
    assert bitwise(w_k, w_p)


def sandwich_blocks(rng, n, k):
    """An SPD M (k, n, n) and a symmetric dM as (k, n, n) views, dM
    transposed (the kernel reads it at its strides)."""
    m = spd_batch(rng, 1, n, 1e4)
    m = torch.cat([m, torch.zeros((1, k - 2, n, n), dtype=torch.float64)], dim=1)[0]
    d = rand_xf(rng, (n, n), k)
    return m, ((d + d.transpose(-1, -2)) / 2).transpose(-1, -2)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3, 6, 12])
def test_steplen_one_launch_mixed_sizes_bitwise(cuda, k):
    """The solver's K7 launch: blocks of every size 1..65 on an X side and
    a Y side (a group each, as the solver hands them over, dM a transposed
    view) in one launch, equal bit for bit to a launch per group and to the
    plain version: at k <= 3 at every size, at k = 6 and 12 at the shapes
    of the halving tree (the plain version at k=12 takes ~1 min a block on
    the CPU)."""
    rng = np.random.default_rng(700 + k)
    sizes = range(1, 66)
    groups = [([m], [d]) for side in range(2) for m, d in
              (sandwich_blocks(rng, n, k) for n in sizes)]
    on_card = [([m.to(cuda)], [d.to(cuda)]) for (m,), (d,) in groups]
    before = cuda_xf.steplen_sandwich_xf.launches
    joint = cuda_xf.steplen_sandwich_xf_groups(on_card)
    assert cuda_xf.steplen_sandwich_xf.launches == before + 1
    plain_sizes = set(sizes) if k <= 3 else set(TREE_SIZES)
    for i, (((m,), (d,)), (w, ok)) in enumerate(zip(groups, joint)):
        (w1, ok1), = cuda_xf.steplen_sandwich_xf_groups([on_card[i]])
        assert ok.tolist() == ok1.tolist() == [True] and bitwise(w, w1), (k, i)
        n = m.shape[-1]
        if i < len(sizes) and n in plain_sizes:
            w_p, ok_p = cuda_xf.steplen_sandwich_xf_torch(m[None], d[None])
            assert ok_p.tolist() == [True] and bitwise(w.cpu(), w_p), (k, n)


@pytest.mark.gpu
def test_steplen_more_blocks_than_one_table(cuda):
    """More blocks than one launch's table holds take as few launches as
    they need, each block's result the same as in a launch of its own."""
    cap = cuda_xf._build.library().clrs_steplen_xf_capacity()
    rng = np.random.default_rng(710)
    ms, ds = zip(*(sandwich_blocks(rng, 3, 3) for _ in range(cap + 5)))
    ms, ds = [m.to(cuda) for m in ms], [d.to(cuda) for d in ds]
    before = cuda_xf.steplen_sandwich_xf.launches
    (w, ok), = cuda_xf.steplen_sandwich_xf_groups([(ms, ds)])
    assert cuda_xf.steplen_sandwich_xf.launches == before + 2
    w1, ok1 = cuda_xf.steplen_sandwich_xf(torch.stack(ms[-3:]), torch.stack(ds[-3:]))
    assert bool(torch.all(ok)) and bool(torch.all(ok1)) and bitwise(w[-3:], w1)


@pytest.mark.gpu
@pytest.mark.parametrize("k", ALL_KS)
@pytest.mark.parametrize("op", ["add", "mul"])
def test_elemwise_xf_kernel_bitwise(cuda, k, op):
    rng = np.random.default_rng(300 + k)
    a, b = (rand_xf(rng, (1000,), k).to(cuda) for _ in range(2))
    before = cuda_xf.elemwise_xf.launches
    assert bitwise(cuda_xf.elemwise_xf(op, a, b), cuda_xf.elemwise_xf_torch(op, a, b))
    assert cuda_xf.elemwise_xf.launches == before + 1


def elemwise_operands(rng, k, dev):
    """Broadcast, stride-0, transposed, sliced and mixed-limb operand pairs,
    as xfloat hands them to K8."""
    r = lambda shape, kk=k: rand_xf(rng, shape, kk).to(dev)  # noqa: E731
    return [(r((10, 1, 1)), r((10, 11, 11))), (r(()), r((11,))), (r((6, 1)), r((1, 6))),
            (r((1, 5)).expand(k, 4, 5), r((4, 5))),
            (r((7, 9)).transpose(1, 2), r((9, 14))[:, :, ::2]),
            (r((3, 3), max(2, k - 1)), r((3, 3))), (r((11,), 2), r((11, 11)))]


@pytest.mark.gpu
@pytest.mark.parametrize("k", ALL_KS)
def test_elemwise_xf_kernel_broadcast_mixed_k_bitwise(cuda, k):
    """K8 reads broadcast, strided and shorter operands in place, one
    launch per op, through the wrapper and through xfloat's switch."""
    from clrs_tpu_torch.ops import xfloat as tx

    for a, b in elemwise_operands(np.random.default_rng(310 + k), k, cuda):
        for op, xf_op in (("add", tx.xf_add), ("mul", tx.xf_mul)):
            before = cuda_xf.elemwise_xf.launches
            assert bitwise(cuda_xf.elemwise_xf(op, a, b), cuda_xf.elemwise_xf_torch(op, a, b))
            with tx.elemwise_cuda():
                got = xf_op(tx.XF(a), tx.XF(b))
            assert cuda_xf.elemwise_xf.launches == before + 2
            assert bitwise(got.limbs, cuda_xf.elemwise_xf_torch(op, a, b))


def bitwise_nan(a, b):
    """Bitwise equal, NaNs in the same places (their sign bits are the
    device's own)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and bitwise(a[~na], b[~nb])


TREE_SIZES = (1, 2, 31, 32, 33, 64, 65)


def tree_inputs(k, n):
    """The tree test's inputs at (k, n), the same in every process: two
    blocks for K5 and two M and a symmetric dM for K7, the second block of
    each indefinite."""
    rng = np.random.default_rng(600 + 100 * k + n)

    def blocks():
        a = spd_batch(rng, 2, n, 1e6)
        a = torch.cat([a, torch.zeros((2, k - 2, n, n), dtype=torch.float64)], dim=1)
        a[1, 0, n // 2, n // 2] = -1.0
        return a

    a, m = blocks(), blocks()
    d = rand_xf(rng, (2, n, n), k).transpose(0, 1)
    return a, m, ((d + d.transpose(-1, -2)) / 2).contiguous()


def tree_plain(k, n):
    """K5's and K7's plain versions on tree_inputs(k, n), on the CPU (bit
    for bit what they give on the card, in a fraction of the time: at k=12
    they are minutes of small launches there)."""
    torch.set_num_threads(1)
    a, m, d = tree_inputs(k, n)
    return cuda_xf.spd_inverse_xf_torch(a), cuda_xf.steplen_sandwich_xf_torch(m, d)


@pytest.fixture(scope="module")
def tree_plains():
    """The plain versions of every tree case, started at once in CPU worker
    processes (the costliest first); the pool ends with the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    cases = sorted(((k, n) for k in ALL_KS for n in TREE_SIZES), key=lambda c: -c[0] ** 2 * c[1])
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1), mp_context=get_context("spawn")) as pool:
        yield {c: pool.submit(tree_plain, *c) for c in cases}


@pytest.mark.gpu
@pytest.mark.parametrize("k", ALL_KS)
@pytest.mark.parametrize("n", TREE_SIZES)
def test_row_kernels_tree_boundaries_bitwise(cuda, tree_plains, k, n):
    """K5 (K1 at k=2) and K7 at the sizes where the dot products' halving
    tree changes shape (one term per lane, a group below a warp, a full
    warp, terms kept in the lane), at every k: flags and every limb equal
    to the plain versions, the second of two blocks indefinite, each
    diagonal's reciprocal taken from the Cholesky."""
    (inv_p, ok_p), (w_p, okw_p) = tree_plains[(k, n)].result()
    a, m, d = (x.to(cuda) for x in tree_inputs(k, n))
    inv_k, ok_k = (cuda_dd.dd_spd_inverse if k == 2 else cuda_xf.spd_inverse_xf)(a)
    w_k, okw_k = cuda_xf.steplen_sandwich_xf(m, d)
    assert ok_k.tolist() == ok_p.tolist() == [True, False]
    assert okw_k.tolist() == okw_p.tolist() == [True, False]
    assert bitwise_nan(inv_k.cpu(), inv_p) and bitwise_nan(w_k.cpu(), w_p)


def check_wide(cuda, B, n):
    """K9 on B blocks of n x n, the second indefinite, given B-major and as
    the batch-minor view of a (2, n, n, B) array: one launch each, flags
    and limbs bitwise K1's (NaNs in the same places)."""
    a = spd_batch(np.random.default_rng(400 + n), B, n, 1e6).to(cuda)
    a[1, 0, n // 2, n // 2] = -1.0
    inv_1, ok_1 = cuda_dd.dd_spd_inverse(a)
    assert ok_1.tolist() == [True, False] + [True] * (B - 2)
    for x in (a, a.permute(1, 2, 3, 0).contiguous().permute(3, 0, 1, 2)):
        before = cuda_dd.dd_spd_inverse_wide.launches
        inv_k, ok_k = cuda_dd.dd_spd_inverse_wide(x)
        assert cuda_dd.dd_spd_inverse_wide.launches == before + 1
        assert ok_k.tolist() == ok_1.tolist(), n
        assert bitwise_nan(inv_k, inv_1), n


@pytest.mark.gpu
def test_spd_inverse_wide_kernel_bitwise(cuda):
    """K9 at n = 1..65 (every shape of the halving tree, one and several
    matrices a block), 40 blocks each so that the last block of a launch
    runs short, against K1."""
    for n in range(1, 66):
        check_wide(cuda, 40, n)


@pytest.mark.gpu
def test_spd_inverse_wide_kernel_special_values_bitwise(cuda):
    """K9 against K1 on blocks whose W leaves the range where K9 starts
    W^T W's entries past W's zero upper triangle (infinite, NaN or huge
    entries, tiny and zero pivots), where every step runs, and on blocks
    with exact zeros (zero, identity, diagonal): flags and limbs bitwise
    K1's, NaNs in the same places."""
    n = 9
    base = spd_batch(np.random.default_rng(700), 1, n, 1e3)[0]
    blocks = [torch.zeros((2, n, n), dtype=torch.float64), base.clone(), base.clone(),
              base.clone(), base * 1e300, base * 1e-300, base * 1e-310, base.clone(), -base]
    blocks[1][0] = torch.eye(n, dtype=torch.float64)
    blocks[2][0] = torch.diag(torch.arange(1.0, n + 1, dtype=torch.float64))
    blocks[3][0, 3, 1] = float("inf")
    blocks[7][0, 0, 0] = 1e-300
    nan = base.clone()
    nan[0, 5, 5] = float("nan")
    a = torch.stack(blocks + [nan]).to(cuda)
    inv_1, ok_1 = cuda_dd.dd_spd_inverse(a)
    inv_k, ok_k = cuda_dd.dd_spd_inverse_wide(a)
    assert ok_k.tolist() == ok_1.tolist()
    assert bitwise_nan(inv_k, inv_1)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [257, 512])
def test_spd_inverse_wide_kernel_large_bitwise(cuda, n):
    """K9 with L and W in global scratch, up to its cap of 512 rows, against
    K1; one row more raises."""
    check_wide(cuda, 2, n)
    if n == cuda_dd.WIDE_MAX_ROWS:
        with pytest.raises(ValueError):
            cuda_dd.dd_spd_inverse_wide(torch.zeros((1, 2, n + 1, n + 1), dtype=torch.float64,
                                                    device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["spd_inverse_xf", "steplen_xf"])
def test_row_kernels_at_max_rows(cuda, kernel):
    """K5 and K7 at the largest n their wrappers admit, at k=12, where a
    thread takes the most registers: both launch, flag the indefinite
    block and agree with float64 LAPACK on the other to 1e-10 of its
    largest entry; one row more raises for K7 and takes K5's panel route
    (which flags the zero block)."""
    k = 12
    n = cuda_xf.max_rows(k)
    rng = np.random.default_rng(500)
    m = spd_batch(rng, 2, n, 1e2)
    m = torch.cat([m, torch.zeros((2, k - 2, n, n), dtype=torch.float64)], dim=1).to(cuda)
    m[1, 0, 3, 3] = -1.0  # indefinite
    m0 = m[0, 0]
    if kernel == "spd_inverse_xf":
        out, ok = cuda_xf.spd_inverse_xf(m)
        got, want = out[0, 0], torch.linalg.inv(m0)
        too_big = None
    else:
        d = rand_xf(rng, (2, n, n), k).transpose(0, 1).to(cuda)
        d = (d + d.transpose(-1, -2)) / 2
        got, ok = cuda_xf.steplen_sandwich_xf(m, d)
        got = got[0]
        L = torch.linalg.cholesky(m0)
        half = torch.linalg.solve_triangular(L, d[0, 0], upper=False)
        want = torch.linalg.solve_triangular(L, half.T, upper=False).T
        too_big = lambda x: cuda_xf.steplen_sandwich_xf(x, x)  # noqa: E731
    assert ok.tolist() == [True, False]
    scale = float(torch.max(torch.abs(want)))
    assert float(torch.max(torch.abs(got - want))) <= 1e-10 * scale
    wider = torch.zeros((1, k, n + 1, n + 1), dtype=torch.float64, device=cuda)
    if too_big is None:
        before = cuda_xf.spd_panel_xf.launches
        assert cuda_xf.spd_inverse_xf(wider)[1].tolist() == [False]
        assert cuda_xf.spd_panel_xf.launches > before
        return
    with pytest.raises(ValueError):
        too_big(wider)
