"""The kernels of ``pallas_xf.py``, each beside its plain PyTorch version.

K2 is ``csrc/schur_pairs.cu`` (replaces ``pallas_xf._schur_pairs_kernel_k``
at every k, and the gather that fed it): the whole Schur block of a group
of clusters, w = ((a0 b0 + a1 b1) + (a2 b2 + a3 b3)) HH for every pair of
pairs, in one launch on the pairings read in place.  K3 and K4 are the
k=2 and k >= 3 instances of ``csrc/matmul_xf.cu``: the batched k-limb
matmul by sequential rank-1 accumulation, operands read in place.  K3
(replaces ``pallas_xf._matmul_kernel``) runs the contraction as it is;
K4 (replaces ``pallas_xf._matmul_kernel_k`` and its tiled form K6)
zero-pads it to a multiple of 8, as the Pallas wrappers pad it.  K5 is the k >= 3 instances
of ``csrc/spd_inverse_xf.cu`` (replaces
``pallas_xf._spd_inverse_kernel_k``): the batched SPD inverse, whose k=2
instance is K1 (``cuda_dd.py``).  K7 is ``csrc/steplen_xf.cu`` (replaces
``pallas_xf._steplen_sandwich_kernel_k``): the step-length sandwich
L^-1 dM L^-T with M = L L^T, in plain float64 out, every block of a solver
iteration in one launch.  K8 is
``csrc/elemwise_xf.cu`` (replaces ``pallas_xf._elemwise_kernel_k``): the
elementwise k-limb add or multiply that ``xfloat.xf_add``/``xf_mul`` call
inside ``xfloat.elemwise_cuda()`` (``SolverConfig.use_cuda_elemwise``).
K7 and K8 take k = 2..12.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises), counting launches in its
``launches`` attribute.  The plain versions perform the kernels'
operations in the kernels' order (K3 on ``xfloat``'s dd sequences, the
others on ``ops/xops.py``, the kernels' own arithmetic), so the two agree
bit for bit.  K2, K3 and K4 at k <= 4 form their exact products by a
fused multiply-add, their plain versions by Dekker's splitting: the same
bits on the kernels' range (``csrc/eft.cuh``: two_prod_fma).  The
sequential accumulations differ from ``xfloat.xf_matmul``'s product tree in the low
limbs, by design, as on the TPU.
"""

from __future__ import annotations

import functools
import struct
from typing import Tuple

import torch

from clrs_tpu_torch.ops import _build, cuda_dd, xops
from clrs_tpu_torch.ops.cuda_dd import (  # noqa: F401  (max_rows: read through cuda_dd)
    dd_spd_inverse,
    dd_spd_inverse_torch,
    max_rows,
    spd_inverse_launch,
)
from clrs_tpu_torch.ops.xfloat import (
    F64,
    XF,
    _broadcast_shape,
    _check_k,
    dd_add,
    fast_two_sum,
    two_prod,
)
from clrs_tpu_torch.ops.bands import gather, row_band


def launch_counters():
    """Every kernel's wrapper, by the name its launch count goes under
    (each wrapper counts its launches in its ``launches`` attribute)."""
    return {"spd_inverse_dd": dd_spd_inverse, "schur_pairs": schur_pairs,
            "matmul_dd": dd_matmul, "matmul_xf": matmul_xf, "spd_inverse_xf": spd_inverse_xf,
            "steplen_xf": steplen_sandwich_xf, "elemwise_xf": elemwise_xf,
            "spd_inverse_dd_wide": cuda_dd.dd_spd_inverse_wide, "spd_panel_xf": spd_panel_xf}


def _check_cuda(name: str, *ts: torch.Tensor):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype != F64:
            raise ValueError(f"{name}: need float64 limbs, got {t.dtype}")


def _merged_axes(shape, *operands):
    """The axes K2's, K3/K4's and K8's kernels walk for operands, each a
    (shape, strides) pair, broadcast to `shape` (operand axes
    right-aligned with it): (dims, [the element strides of each operand]),
    a stride 0 where an operand is broadcast, axes of size 1 dropped and
    neighbouring axes merged wherever every operand steps evenly across
    them."""
    def strides(xs, st):
        off = len(shape) - len(xs)
        return [st[i - off] if i >= off and xs[i - off] == d else 0
                for i, d in enumerate(shape)]

    cols = [strides(xs, st) for xs, st in operands]
    dims, out = [], [[] for _ in operands]
    for i, d in enumerate(shape):
        if d == 1:
            continue
        if dims and all(o[-1] == c[i] * d for o, c in zip(out, cols)):
            dims[-1] *= d
            for o, c in zip(out, cols):
                o[-1] = c[i]
        else:
            dims.append(d)
            for o, c in zip(out, cols):
                o.append(c[i])
    return dims, out


_FMA_RANGE = """
    On the card the exact products (at k <= 4) are formed by the fused
    multiply-add (csrc/eft.cuh: two_prod_fma), on the CPU by Dekker's
    splitting: the two give the same limbs, bit for bit, wherever every
    pair of limbs x, y that the multiply takes exactly has |x|, |y| <
    2^996, |x y| < 2^1023 and exponent(x) + exponent(y) >= -969 (zeros of
    either sign included).  Outside that range the card's limbs differ
    from the plain version's and from the JAX reference's: where the
    split overflows the plain version gives NaN and the card a finite
    product; where the error term underflows the card's is x y - p
    rounded once and the plain version's may be inexact."""


# ---------------------------------------------------------------------------
# K2: the Schur block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _schur_indices(m: int):
    """K2's operand indices for m: (ar, ac, br, bc), each (P, P, 4), so
    that for pairs i1 = (r1, s1), i2 = (r2, s2) of core/blockinfo.py:
    pair_list the four products read a_i = PX[ar, t1, ac, t2] and b_i =
    PY[br, t2, bc, t1] (csrc/schur_pairs.cu)."""
    pairs = [(r, s) for r in range(m) for s in range(r + 1)]
    idx = torch.tensor([[[(s1, r1, s1, r1), (r2, r2, s2, s2), (s2, s2, r2, r2),
                          (r1, s1, r1, s1)] for r2, s2 in pairs] for r1, s1 in pairs])
    return tuple(idx[:, :, j] for j in range(4))


def schur_pairs_torch(px: torch.Tensor, py: torch.Tensor, hh: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: px (k, *bs, m, T1, m, T), py (k, *bs, m, T, m,
    T1) and hh (k, *bs, T1, T), any strides, the batch axes broadcast -> w
    (k, *batch, P, T1, P, T) (T1 = T, or a band of the rows t1),
    P = m (m + 1) / 2, w[i1, t1, i2, t2] = ((a0 b0 + a1 b1) + (a2 b2 + a3
    b3)) HH[t1, t2] with a_i = px[ar_i, t1, ac_i, t2], b_i = py[br_i, t2,
    bc_i, t1] (_schur_indices), on ``xops``: the kernel's operations in its
    order, every pair of pairs at once."""
    k, m = px.shape[0], px.shape[-4]
    ar, ac, br, bc = _schur_indices(m)
    # pa[..., t1, t2, r, s] = px[r, t1, s, t2], pb[..., t1, t2, r, s] = py[r, t2, s, t1]
    pa = px.movedim((-4, -2), (-2, -1))
    pb = py.movedim((-4, -2), (-2, -1)).transpose(-3, -4)
    a, b = pa[..., ar, ac], pb[..., br, bc]  # (k, *bs, T, T, P, P, 4)
    p = [xops.mul(list(a[..., i].unbind(0)), list(b[..., i].unbind(0))) for i in range(4)]
    s = xops.add(xops.add(p[0], p[1]), xops.add(p[2], p[3]))
    w = torch.stack(xops.mul(s, [x[..., None, None] for x in hh.unbind(0)]))
    return w.permute(tuple(range(w.ndim - 4)) + (w.ndim - 2, w.ndim - 4, w.ndim - 1,
                                                  w.ndim - 3)).contiguous()


SCHUR_ROW = 34  # csrc/schur_pairs.cu: kRow, the doubles of a staged row
SCHUR_MAX_TILE_T1 = 8  # kMaxTileT1
SCHUR_SHARED_BUDGET = 100 * 1024  # the staged slices that leave two blocks an SM
SCHUR_MAX_SHARED = 232448  # kMaxShared: an H100 block's dynamic shared memory


def _schur_shared(k: int, m: int, ty: int) -> int:
    """Bytes of K2's staged PY slices: 2 m slices of k limbs, ty rows."""
    return 8 * 2 * m * k * ty * SCHUR_ROW


def _schur_plan(px: torch.Tensor, py: torch.Tensor, hh: torch.Tensor):
    """The description csrc/schur_pairs.cu's C entry takes for K2 on px
    (k, *bs, m, T1, m, T), py (k, *bs, m, T, m, T1) and hh (k, *bs, T1, T),
    each read in place at its strides, the batch axes broadcast (stride 0
    where an operand has size 1 or lacks the axis) and merged into one; the
    output shape (k, *batch, P, T1, P, T) and its element count.  The
    tile's rows t1 are the power of two >= T1 up to 8, halved while the
    staged slices exceed SCHUR_SHARED_BUDGET.  Raises on what the kernel
    does not take."""
    ops = (px, py, hh)
    if any(x.dtype != F64 for x in ops) or len({x.device for x in ops}) != 1:
        raise ValueError("schur_pairs: need float64 limbs on one device, got "
                         + ", ".join(f"{x.dtype} on {x.device}" for x in ops))
    if px.ndim < 5 or py.ndim < 5 or hh.ndim < 3:
        raise ValueError(f"schur_pairs: bad shapes {tuple(px.shape)} {tuple(py.shape)} "
                         f"{tuple(hh.shape)}")
    k, m, T1, T = px.shape[0], px.shape[-4], px.shape[-3], px.shape[-1]
    if (px.shape[-4:] != (m, T1, m, T) or py.shape[-4:] != (m, T, m, T1)
            or hh.shape[-2:] != (T1, T) or py.shape[0] != k or hh.shape[0] != k or m < 1):
        raise ValueError(f"schur_pairs: bad shapes {tuple(px.shape)} {tuple(py.shape)} "
                         f"{tuple(hh.shape)}")
    _check_k(k)
    batch = tuple(_broadcast_shape(px.shape[1:-4], py.shape[1:-4], hh.shape[1:-2]))
    dims, strides = _merged_axes(batch, (px.shape[1:-4], px.stride()[1:-4]),
                                 (py.shape[1:-4], py.stride()[1:-4]),
                                 (hh.shape[1:-2], hh.stride()[1:-2]))
    if len(dims) > 1:
        raise ValueError(f"schur_pairs: batch {batch} takes {len(dims)} axes, the kernel 1")
    G = dims[0] if dims else 1
    sx, sy, sh = (s[0] if s else 0 for s in strides)
    ty = SCHUR_MAX_TILE_T1
    while ty > 1 and (ty // 2 >= T1 or _schur_shared(k, m, ty) > SCHUR_SHARED_BUDGET):
        ty //= 2
    if _schur_shared(k, m, ty) > SCHUR_MAX_SHARED:
        raise ValueError(f"schur_pairs: m={m} at k={k} stages {_schur_shared(k, m, 1)} bytes "
                         f"a row, above {SCHUR_MAX_SHARED}")
    P = m * (m + 1) // 2
    desc = struct.pack("<23q", k, G, m, T, T1, P, ty, px.stride(0), sx, *px.stride()[-4:],
                       py.stride(0), sy, *py.stride()[-4:], hh.stride(0), sh, *hh.stride()[-2:])
    return desc, (k,) + batch + (P, T1, P, T), G * P * T1 * P * T


_schur_plans = {}


def schur_pairs(px: torch.Tensor, py: torch.Tensor, hh: torch.Tensor) -> torch.Tensor:
    """K2 wrapper (shapes as schur_pairs_torch): one launch of
    csrc/schur_pairs.cu, px, py and hh read where they lie (the transposed
    views compute_pairings returns, or their band of rows t1, broadcast
    batches); the output is a fresh contiguous (k, *batch, P, T1, P, T).
    The description is computed once for each layout of the three and
    kept."""
    if _on_cpu("schur_pairs", px, py, hh):
        return schur_pairs_torch(px, py, hh)
    key = (px.shape, px.stride(), py.shape, py.stride(), hh.shape, hh.stride(), px.dtype,
           py.dtype, hh.dtype, px.get_device(), py.get_device(), hh.get_device())
    desc, shape, N = _build.cached_plan(_schur_plans, key, _schur_plan, px, py, hh)
    out = px.new_empty(shape)
    if N:
        rc = _build.library().clrs_schur_pairs(desc, px.data_ptr(), py.data_ptr(),
                                               hh.data_ptr(), out.data_ptr(), _build.stream(px))
        if rc:
            _build.check(rc, "clrs_schur_pairs", shape[0])
        schur_pairs.launches += 1
    return out


schur_pairs.__doc__ += _FMA_RANGE
schur_pairs.launches = 0


# ---------------------------------------------------------------------------
# K3 and K4 (+K6): batched k-limb matmul, one kernel (csrc/matmul_xf.cu)
# ---------------------------------------------------------------------------

MATMUL_MAX_BATCH_AXES = 3  # csrc/matmul_xf.cu: kBatchAxes


def _matmul_batch(a: torch.Tensor, b: torch.Tensor):
    """The common batch shape of a (k, *ba, n, K) and b (k, *bb, K, m)."""
    if a.ndim < 3 or b.ndim < 3 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"matmul: bad shapes {tuple(a.shape)} {tuple(b.shape)}")
    return tuple(_broadcast_shape(a.shape[1:-2], b.shape[1:-2]))


def dd_matmul_seq_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: a (2, *ba, n, K), b (2, *bb, K, m), any
    strides, the batch axes broadcast -> (2, *batch, n, m), C += a[:, r]
    (x) b[r, :] for r = 0..K-1 in order, on xfloat's dd sequences."""
    batch = _matmul_batch(a, b)
    n, K = a.shape[-2:]
    m = b.shape[-1]
    ch = torch.zeros(batch + (n, m), dtype=F64, device=a.device)
    cl = torch.zeros_like(ch)
    for r in range(K):
        ah, al = a[0, ..., r:r + 1], a[1, ..., r:r + 1]  # (*ba, n, 1)
        bh, bl = b[0, ..., r:r + 1, :], b[1, ..., r:r + 1, :]  # (*bb, 1, m)
        ph, pe = two_prod(ah, bh)
        plo = pe + (ah * bl + al * bh)
        ph, plo = fast_two_sum(ph, plo)
        ch, cl = dd_add(ch, cl, ph, plo)
    return torch.stack([ch, cl])


def padded_contraction(K: int) -> int:
    """The Pallas wrappers' zero-padded contraction length at k >= 3: K
    rounded up to a multiple of 8 (pallas_xf.py:351-356, 514-518, 1115)."""
    return (K + 7) // 8 * 8


def matmul_xf_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: a (k, *ba, n, K), b (k, *bb, K, m), any
    strides, the batch axes broadcast -> (k, *batch, n, m), acc = add(acc,
    mul(a[:, r], b[r, :])) for r over the zero-padded contraction in
    order."""
    batch = _matmul_batch(a, b)
    k, n, K = a.shape[0], a.shape[-2], a.shape[-1]
    m = b.shape[-1]
    acc = [torch.zeros(batch + (n, m), dtype=F64, device=a.device) for _ in range(k)]
    zero_a = torch.zeros(batch + (n, 1), dtype=F64, device=a.device)
    zero_b = torch.zeros(batch + (1, m), dtype=F64, device=a.device)
    for r in range(padded_contraction(K)):
        if r < K:
            x = [a[q, ..., r:r + 1] for q in range(k)]
            y = [b[q, ..., r:r + 1, :] for q in range(k)]
        else:
            x, y = [zero_a] * k, [zero_b] * k
        acc = xops.add(acc, xops.mul(x, y))
    return torch.stack(acc)


def _matmul_plan(a: torch.Tensor, b: torch.Tensor):
    """The description csrc/matmul_xf.cu's C entry takes for a @ b (a (k,
    *ba, n, K), b (k, *bb, K, m), read in place at their strides), the
    output shape and its element count.  The batch axes are broadcast
    (stride 0 where an operand has size 1 or lacks the axis), axes of
    size 1 dropped and neighbouring axes merged wherever both operands
    step evenly across them.  The contraction takes K steps at k=2 (K3)
    and padded_contraction(K) at k >= 3 (K4).  Raises on what the kernel
    does not take."""
    if a.dtype != F64 or b.dtype != F64 or a.device != b.device:
        raise ValueError(f"matmul: need float64 limbs on one CUDA device, got "
                         f"{a.dtype} on {a.device} and {b.dtype} on {b.device}")
    k = a.shape[0]
    if b.shape[0] != k:
        raise ValueError(f"matmul: limb counts {k} and {b.shape[0]}")
    _check_k(k)
    batch = _matmul_batch(a, b)
    n, K = a.shape[-2:]
    m = b.shape[-1]

    dims, (sa, sb) = _merged_axes(batch, (a.shape[1:-2], a.stride()[1:-2]),
                                  (b.shape[1:-2], b.stride()[1:-2]))
    if len(dims) > MATMUL_MAX_BATCH_AXES:
        raise ValueError(f"matmul: batch {batch} takes {len(dims)} axes, the kernel "
                         f"{MATMUL_MAX_BATCH_AXES}")
    pad = MATMUL_MAX_BATCH_AXES - len(dims)
    dims, sa, sb = [1] * pad + dims, [0] * pad + sa, [0] * pad + sb
    steps = K if k == 2 else padded_contraction(K)
    desc = ([k, steps, K, n, m] + dims
            + [a.stride(0)] + sa + list(a.stride()[-2:])
            + [b.stride(0)] + sb + list(b.stride()[-2:]))
    N = n * m
    for d in dims:
        N *= d
    return struct.pack("<20q", *desc), (k,) + batch + (n, m), N


_matmul_plans = {}


def _matmul(wrapper, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch csrc/matmul_xf.cu on a and b as they lie; the description is
    computed once for each layout of the pair and kept."""
    key = (a.shape, a.stride(), b.shape, b.stride(), a.dtype, b.dtype, a.get_device(),
           b.get_device())
    desc, shape, N = _build.cached_plan(_matmul_plans, key, _matmul_plan, a, b)
    out = a.new_empty(shape)
    if N:
        rc = _build.library().clrs_matmul_xf(desc, a.data_ptr(), b.data_ptr(),
                                             out.data_ptr(), _build.stream(a))
        if rc:
            _build.check(rc, "clrs_matmul_xf", shape[0])
        wrapper.launches += 1
    return out


def _on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True for CPU operands (the plain version's), False for CUDA ones;
    raises for other devices."""
    if ts[0].is_cuda:
        return False
    if all(t.device.type == "cpu" for t in ts):
        return True
    raise ValueError(f"{name}: unsupported devices " + ", ".join(str(t.device) for t in ts))


def dd_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3 wrapper (shapes as dd_matmul_seq_torch): one launch of the k=2
    instance of csrc/matmul_xf.cu, the operands read in place; the output
    is a fresh contiguous (2, *batch, n, m)."""
    if _on_cpu("dd_matmul", a, b):
        return dd_matmul_seq_torch(a, b)
    if a.shape[0] != 2:
        raise ValueError(f"dd_matmul: need 2 limbs, got {tuple(a.shape)}")
    return _matmul(dd_matmul, a, b)


dd_matmul.__doc__ += _FMA_RANGE
dd_matmul.launches = 0


def matmul_xf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4 wrapper (shapes as matmul_xf_torch), k >= 3: one launch of
    csrc/matmul_xf.cu, the operands read in place; the output is a fresh
    contiguous (k, *batch, n, m)."""
    if _on_cpu("matmul_xf", a, b):
        return matmul_xf_torch(a, b)
    if a.shape[0] < 3:
        raise ValueError(f"matmul_xf: need k >= 3 limbs, got {tuple(a.shape)}")
    return _matmul(matmul_xf, a, b)


matmul_xf.__doc__ += _FMA_RANGE
matmul_xf.launches = 0


def xf_matmul_k(a: XF, b: XF) -> XF:
    """(..., n, K) x (..., K, m) through K3 (k=2) or K4 (k >= 3); the
    leading batch axes broadcast, and both operands are read where they
    lie (transposed, sliced or broadcast views included)."""
    k = a.k
    if b.k != k:
        raise NotImplementedError(f"mixed limb counts {a.k} and {b.k}")
    return XF((dd_matmul if k == 2 else matmul_xf)(a.limbs, b.limbs))


# ---------------------------------------------------------------------------
# K5: batched k-limb SPD inverse
# ---------------------------------------------------------------------------


def _cholesky_xops(A):
    """K5's and K7's Cholesky of the limb list A ((B, n, n) each) by
    columns, with the pivot flag on the leading limb and a non-positive
    pivot replaced by 1; returns (L as a limb list, ok flags (B, n))."""
    k = len(A)
    B, n, _ = A[0].shape
    dev = A[0].device
    L = [torch.zeros((B, n, n), dtype=F64, device=dev) for _ in range(k)]
    okf = torch.ones((B, n), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    for j in range(n):
        # s = A[:, j] - L @ L[j, :]
        acc = xops.sum_axis(xops.mul(L, [x[:, j:j + 1, :] for x in L]), axis=-1)
        s = xops.add([x[:, :, j] for x in A], xops.neg(acc))  # (B, n)
        pos = s[0][:, j] > 0
        okf[:, j] = pos
        safe = [torch.where(pos, s[0][:, j], 1.0)] + [
            torch.where(pos, x[:, j], 0.0) for x in s[1:]]
        ljj = xops.sqrt(safe)
        c = xops.div(s, [x[:, None] for x in ljj])
        at, below = rows == j, rows > j
        for q in range(k):
            L[q][:, :, j] = torch.where(at, ljj[q][:, None],
                                        torch.where(below, c[q], 0.0))
    return L, okf


def _forward_rows_xops(L, R):
    """W = L^-1 R by forward substitution, one row at a time, the sum over
    all columns of L (rows of W not yet solved are zero); limb lists of
    (B, n, n) for L and (B, n, m) for R."""
    W = [torch.zeros(x.shape, dtype=F64, device=x.device) for x in R]
    for i in range(L[0].shape[-1]):
        acc = xops.sum_axis(xops.mul([x[:, i, :, None] for x in L], W), axis=-2)
        nrm = xops.add([x[:, i, :] for x in R], xops.neg(acc))
        qv = xops.div(nrm, [x[:, i, i, None] for x in L])
        for q, x in enumerate(W):
            x[:, i, :] = qv[q]
    return W


def _spd_inverse_single_torch(limbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5's single launch: limbs (B, k, n, n) -> (inv (B,
    k, n, n), ok (B,)).  Per block: Cholesky by columns with the pivot
    flag on the leading limb, W = L^-1 by rows, A^-1 = W^T W by sequential
    rank-1 accumulation; every matvec through the zero-padded halving
    tree."""
    B, k, n, _ = limbs.shape
    L, okf = _cholesky_xops([limbs[:, q] for q in range(k)])
    eye = torch.eye(n, dtype=F64, device=limbs.device).expand(B, n, n)
    W = _forward_rows_xops(L, [eye] + [torch.zeros_like(eye)] * (k - 1))
    # inv = W^T W
    acc = [torch.zeros_like(W[0]) for _ in range(k)]
    for t in range(n):
        r = [x[:, t, :] for x in W]
        acc = xops.add(acc, xops.mul([x[:, :, None] for x in r],
                                     [x[:, None, :] for x in r]))
    return torch.stack(acc, dim=1), torch.all(okf, dim=1)


def _spd_inverse_route(x: torch.Tensor, limb_axis: int, single, single_plain, plain: bool,
                       group=None):
    """The one place where the SPD inverse's route is chosen, for x (k, B,
    n, n) at limb_axis 0 or (B, k, n, n) at 1, returned in that layout with
    ok (B,): up to max_rows(k) rows one launch of csrc/spd_inverse_xf.cu
    counted as single's (the K1 or K5 wrapper), or single_plain, its plain
    version, taking (B, k, n, n); above, at any k, the panel route
    (spd_inverse_panels, its row products in bands over group).  plain
    takes the plain versions on any device."""
    k, n = x.shape[limb_axis], x.shape[-1]
    if n <= cuda_dd.max_rows(k):
        if not plain:
            return spd_inverse_launch(single, x, limb_axis)
        inv, ok = single_plain(x if limb_axis == 1 else x.transpose(0, 1))
        return (inv if limb_axis == 1 else inv.transpose(0, 1)), ok
    inv, ok = spd_inverse_panels(x if limb_axis == 0 else x.transpose(0, 1), plain, group)
    return (inv if limb_axis == 0 else inv.transpose(0, 1)), ok


def spd_inverse_xf_torch(limbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5 on any device: limbs (B, k, n, n) -> (inv (B, k,
    n, n), ok (B,)), the single launch's (_spd_inverse_single_torch) up to
    max_rows(k) rows and the panel route's above."""
    return _spd_inverse_route(limbs, 1, spd_inverse_xf, _spd_inverse_single_torch, True)


def spd_inverse_xf(limbs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 wrapper: limbs (B, k, n, n) float64, k >= 3, any strides -> (inv
    (B, k, n, n), ok (B,)), the limbs read where they lie: one launch up
    to max_rows(k) rows, the panel route (spd_inverse_panels) above."""
    if limbs.device.type == "cpu":
        return spd_inverse_xf_torch(limbs)
    _check_cuda("spd_inverse_xf", limbs)
    if limbs.ndim != 4 or limbs.shape[1] < 3:
        raise ValueError(f"spd_inverse_xf: need (B, k>=3, n, n), got {tuple(limbs.shape)}")
    return _spd_inverse_route(limbs, 1, spd_inverse_xf, _spd_inverse_single_torch, False)


spd_inverse_xf.launches = 0


def xf_spd_inverse_batched(x_limbs: torch.Tensor, group=None):
    """SPD inverse of the stacked-XF layout, limbs (k, B, n, n), read in
    place and returned in that layout: K1 at k=2 and K5 at k >= 3 (each
    counted as its wrapper's launch) up to max_rows(k) rows, the panel
    route above (_spd_inverse_route).  A CPU tensor takes the plain
    versions; a CUDA tensor launches the kernels or raises.  group bands
    the panel route's row products (spd_inverse_panels)."""
    plain = x_limbs.device.type == "cpu"
    if not plain:
        _check_cuda("xf_spd_inverse_batched", x_limbs)
    single = ((dd_spd_inverse, dd_spd_inverse_torch) if x_limbs.shape[0] == 2
              else (spd_inverse_xf, _spd_inverse_single_torch))
    return _spd_inverse_route(x_limbs, 0, *single, plain, group)


# ---------------------------------------------------------------------------
# K5's panel route: the SPD inverse above the single launch's rows
# ---------------------------------------------------------------------------

# The panel width: b rows a panel (csrc/spd_panel_xf.cu: kMaxPanel at
# most).  On an H100 16 was the fastest of 8, 16 and 32 at k=3 (2.74 ms
# at 256 rows against 2.76 and 3.26; 24.8 ms at 1024 against 26.6 and
# 29.9) and within 3 % of 8 at k = 6 and 10 (tools/panel_widths.py;
# PERF.md section 6): a
# panel is a chain of b Cholesky columns and b slab rows, each Cholesky
# column's dot products one round of the block's 16 lane groups at 16
# rows and four at 32, while 8 rows double the panels and with them the
# K4 and K8 launches between them.  L_d and the slab's columns fit in
# registers and per-block scratch at any width up to 32.
SPD_PANEL = 16
SPD_MAX_PANEL = 32  # kMaxPanel
_PANEL_THREADS = 256  # csrc/chol_xf.cuh: kBlockThreads


def spd_panel_xf_torch(t: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the panel route's factor step: t (k, B, r, c) ->
    (Z (k, B, b, c - b), ok (B, b)): L_d L_d^T = t[:, :, :b, :b] as K5
    factors it, Z = L_d^-1 t[:, :, :b, b:] by rows."""
    k = t.shape[0]
    L, okf = _cholesky_xops([t[q, :, :b, :b] for q in range(k)])
    return torch.stack(_forward_rows_xops(L, [t[q, :, :b, b:] for q in range(k)])), okf


def _spd_panel_xf_plain(t, b, z, y, okf):
    """spd_panel_xf's writes from its plain version, on any device."""
    zt, okt = spd_panel_xf_torch(t, b)
    z.copy_(zt)
    y.copy_(-zt[..., :y.shape[-1]])
    okf.copy_(okt)


def _panel_plan(t, b, z, y, okf):
    """The description csrc/spd_panel_xf.cu's clrs_spd_panel_xf takes
    for the factor step on t, writing z, y = -z[..., :nA] and the flags
    okf (B, b), each at its strides (columns and flag rows dense), and the
    float64 scratch it needs."""
    k, B, _, c = t.shape
    w, nA = c - b, y.shape[-1]
    if (z.shape != (k, B, b, w) or y.shape[:3] != (k, B, b) or okf.shape != (B, b)
            or z.stride(-1) != 1 or y.stride(-1) != 1 or okf.stride(-1) != 1
            or not 1 <= b <= SPD_MAX_PANEL):
        raise ValueError(f"spd_panel_xf: bad operands t {tuple(t.shape)} b={b} z "
                         f"{tuple(z.shape)} y {tuple(y.shape)} ok {tuple(okf.shape)}")
    np2 = 1 << max(b - 1, 0).bit_length()
    per_block = _PANEL_THREADS // min(np2, 32)
    blocks = -(-w // per_block)
    desc = struct.pack("<16q", k, B, b, w, nA, *t.stride(), z.stride(0), z.stride(1),
                       z.stride(2), y.stride(0), y.stride(1), y.stride(2), okf.stride(0))
    return desc, B * blocks * (k * (b * b + b) + b)


def spd_panel_xf(t: torch.Tensor, b: int, z: torch.Tensor, y: torch.Tensor,
                 okf: torch.Tensor):
    """The panel route's factor step: t (k, B, r, c) float64 at any
    strides, its diagonal block t[:, :, :b, :b] -> writes z (k, B, b, c -
    b) = L_d^-1 t[:, :, :b, b:], y = -z[..., :y.shape[-1]] and okf (B, b),
    the pivot flags (1.0 / 0.0).  A CPU tensor takes the plain version
    (spd_panel_xf_torch); a CUDA tensor launches csrc/spd_panel_xf.cu's
    clrs_spd_panel_xf, counted in spd_panel_xf.launches."""
    if t.device.type == "cpu":
        _spd_panel_xf_plain(t, b, z, y, okf)
        return
    _check_cuda("spd_panel_xf", t, z, y, okf)
    desc, scratch_len = _panel_plan(t, b, z, y, okf)
    scratch = t.new_empty((scratch_len,))
    rc = _build.library().clrs_spd_panel_xf(desc, t.data_ptr(), z.data_ptr(), y.data_ptr(),
                                            okf.data_ptr(), scratch.data_ptr(),
                                            _build.stream(t))
    if rc:
        _build.check(rc, "clrs_spd_panel_xf", t.shape[0])
    spd_panel_xf.launches += 1


spd_panel_xf.launches = 0


def spd_inverse_panels(a: torch.Tensor, plain: bool = False,
                       group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SPD inverse of a (k, B, n, n), any strides -> (inv (k, B, n, n), ok
    (B,)), by the reference's right-looking panels on T = [A | I] (k, B,
    n, 2n): per panel of SPD_PANEL rows, spd_panel_xf factors T's diagonal
    block and solves its slab, Z = L_d^-1 T[:b, b:]; K4 (K3 at k=2) forms
    -Z_A^T Z from Z's A columns negated, and K8 adds it to T[b:, b:], the
    next panel's T.  Z's identity half, row by row, is W = L^-1, and
    A^-1 = W^T W is one more K4 (K3) launch.  No library call: on a CUDA
    tensor every step is a kernel of this package, on a CPU tensor or with
    plain its plain version (on any device), so the card is bitwise the
    CPU.

    Against the reference's xf_spd_inverse (panel Cholesky, then the panel
    trisolves L^-T (L^-1 I)) and against the Pallas K5 (one Cholesky, W =
    L^-1, W^T W) the association differs: halving-tree dot products over
    a panel and sequential rank-1 accumulation in K4 here, the product
    tree of xf_matmul or XLA's there.  Each step is exact-EFT, so they
    agree to the ulp of the last limb (times the condition), not bit for
    bit.

    With a process group each rank forms its band of the rows of every
    trailing update (K4, then K8's add) and of W^T W (K4), ceil(rows /
    ranks) rows in rank order (ops/bands.row_band), and the bands are
    gathered after each: K4 accumulates each entry on its own and K8 is
    elementwise, so the inverse is the same bits at any rank count."""
    k, B, n = a.shape[0], a.shape[1], a.shape[-1]
    if plain:
        factor, add = _spd_panel_xf_plain, elemwise_xf_torch
        matmul = dd_matmul_seq_torch if k == 2 else matmul_xf_torch
    else:
        factor, add = spd_panel_xf, elemwise_xf
        matmul = dd_matmul if k == 2 else matmul_xf
    t = a.new_zeros((k, B, n, 2 * n))
    t[..., :n].copy_(a)
    t[0, :, :, n:].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    z = a.new_empty((k, B, n, 2 * n))
    okf = a.new_empty((B, n))
    for p0 in range(0, n, SPD_PANEL):
        p1 = min(p0 + SPD_PANEL, n)
        zs = z[:, :, p0:p1, p1:]
        y = a.new_empty((k, B, p1 - p0, n - p1))
        factor(t, p1 - p0, zs, y, okf[:, p0:p1])
        if p1 < n:
            rows = row_band(n - p1, group)
            band = t[:, :, p1 - p0 + rows.start:p1 - p0 + rows.stop, p1 - p0:]
            t = gather(add("add", band, matmul(y.mT[..., rows, :], zs)), 2, group, n - p1)
    w = z[..., n:]
    rows = row_band(n, group)
    return gather(matmul(w.mT[..., rows, :], w), 2, group, n), torch.all(okf > 0.5, dim=1)


# ---------------------------------------------------------------------------
# K7: step-length sandwich
# ---------------------------------------------------------------------------


def steplen_sandwich_xf_torch(m: torch.Tensor, dm: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: m, dm (B, k, n, n) -> (W (B, n, n) float64,
    ok (B,)).  Per block: M = L L^T as K5 factors it, W1 = L^-1 dM by
    rows, X = W1 L^-T by columns over all n terms with L[j, t] masked to
    t < j (X overwrites W1 column by column), W = limb 0 + limb 1 of X."""
    B, k, n, _ = m.shape
    L, okf = _cholesky_xops([m[:, q] for q in range(k)])
    X = _forward_rows_xops(L, [dm[:, q] for q in range(k)])
    cols = torch.arange(n, device=m.device)
    for j in range(n):
        mask = (cols < j).to(F64)
        lm = [x[:, j, None, :] * mask for x in L]  # L[j, t] for t < j, else +-0
        acc = xops.sum_axis(xops.mul(X, lm), axis=-1)
        nrm = xops.add([x[:, :, j] for x in X], xops.neg(acc))
        qv = xops.div(nrm, [x[:, j, j, None] for x in L])
        for q, x in enumerate(X):
            x[:, :, j] = qv[q]
    return X[0] + X[1], torch.all(okf, dim=1)


# One matrix of a K7 launch (csrc/steplen_xf.cu: Entry): the M and dM
# pointers, their limb, row and column strides, the offsets of its W and
# flags, and n.
_STEPLEN_ENTRY = struct.Struct("<2Q9q")


def steplen_sandwich_xf_groups(groups):
    """K7 over every block of several groups in one launch: groups is a
    sequence of (ms, dms), ms and dms sequences of B float64 limb tensors
    (k, n, n) of one n per group, any strides, read where they lie ->
    [(W (B, n, n) float64, ok (B,))], one per group, each W a dense view of
    one buffer.  A CPU group takes the plain version on its stacked
    blocks.  More blocks than one launch's table holds (360 from CUDA 12.1
    on) take as few launches as they need; each launch counts in
    steplen_sandwich_xf.launches, K7's count."""
    if not groups:
        return []
    first = groups[0][0][0]
    if first.device.type == "cpu":
        return [steplen_sandwich_xf_torch(torch.stack(ms), torch.stack(dms))
                for ms, dms in groups]
    _check_cuda("steplen_sandwich_xf", first)
    k, entries, spans, w_size, ok_size = _steplen_table(groups)
    w = first.new_empty((w_size,))
    okf = first.new_empty((ok_size,))
    scratch = first.new_empty((k * (2 * w_size + ok_size),))
    lib = _build.library()
    cap = lib.clrs_steplen_xf_capacity()
    for i in range(0, len(entries), cap):
        chunk = entries[i:i + cap]
        rc = lib.clrs_steplen_xf(k, b"".join(chunk), len(chunk), w.data_ptr(), okf.data_ptr(),
                                 scratch.data_ptr(), _build.stream(first))
        if rc:
            _build.check(rc, "clrs_steplen_xf", k)
        steplen_sandwich_xf.launches += 1
    return [(w[wo:wo + B * n * n].view(B, n, n),
             torch.all(okf[oo:oo + B * n].view(B, n) > 0.5, dim=1))
            for B, n, wo, oo in spans]


def _steplen_table(groups):
    """The entries of K7's launches for groups (as
    steplen_sandwich_xf_groups), each block read where it lies: (k,
    entries, spans, W's length, the flags' length), spans (B, n, W offset,
    flags offset) per group.  Raises on what the kernel does not take."""
    first = groups[0][0][0]
    k, dev = first.shape[0], first.get_device()
    entries, spans = [], []
    w_off = ok_off = 0
    for ms, dms in groups:
        n = ms[0].shape[-1]
        if n > cuda_dd.max_rows(k) or len(ms) != len(dms):
            raise ValueError(f"steplen_sandwich_xf: {len(ms)} M and {len(dms)} dM blocks "
                             f"of n={n} (at most {cuda_dd.max_rows(k)} rows at k={k})")
        spans.append((len(ms), n, w_off, ok_off))
        for m, dm in zip(ms, dms):
            if (m.shape != (k, n, n) or dm.shape != (k, n, n) or m.dtype != F64
                    or dm.dtype != F64 or m.get_device() != dev or dm.get_device() != dev):
                raise ValueError(f"steplen_sandwich_xf: need float64 limbs ({k}, {n}, {n}) "
                                 f"on one device, got {tuple(m.shape)} {m.dtype} {m.device} "
                                 f"and {tuple(dm.shape)} {dm.dtype} {dm.device}")
            entries.append(_STEPLEN_ENTRY.pack(m.data_ptr(), dm.data_ptr(), *m.stride(),
                                               *dm.stride(), w_off, ok_off, n))
            w_off += n * n
            ok_off += n
    return k, entries, spans, w_off, ok_off


def steplen_sandwich_xf(m: torch.Tensor, dm: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 wrapper: m, dm (B, k, n, n) float64, k = 2..12, any strides ->
    (W (B, n, n), ok (B,)): one launch (steplen_sandwich_xf_groups with one
    group)."""
    if m.device.type == "cpu":
        return steplen_sandwich_xf_torch(m, dm)
    _check_cuda("steplen_sandwich_xf", m, dm)
    if m.ndim != 4 or tuple(dm.shape) != tuple(m.shape):
        raise ValueError(f"steplen_sandwich_xf: bad shapes {tuple(m.shape)} "
                         f"{tuple(dm.shape)}")
    return steplen_sandwich_xf_groups([(m.unbind(0), dm.unbind(0))])[0]


steplen_sandwich_xf.launches = 0


# ---------------------------------------------------------------------------
# K8: elementwise k-limb add / multiply
# ---------------------------------------------------------------------------

_ELEMWISE_OPS = {"add": (0, xops.add), "mul": (1, xops.mul)}
ELEMWISE_MAX_AXES = 4  # csrc/elemwise_xf.cu: kMaxAxes


def elemwise_xf_torch(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: op "add" or "mul" of the limb tensors a (ka,
    *sa) and b (kb, *sb) -> (k, *shape), k = max(ka, kb), shape the
    broadcast of sa and sb: both operands broadcast and zero-padded to k
    limbs, as the reference pads them, then ``xops.add`` or ``xops.mul``."""
    k = max(a.shape[0], b.shape[0])
    _check_k(k)
    shape = _broadcast_shape(a.shape[1:], b.shape[1:])

    def limbs(x):
        rows = [torch.broadcast_to(v, shape) for v in x.unbind(0)]
        zero = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return rows + [zero] * (k - len(rows))

    return torch.stack(_ELEMWISE_OPS[op][1](limbs(a), limbs(b)))


def _elemwise_plan(op: str, a: torch.Tensor, b: torch.Tensor):
    """The operand description K8's C entry takes for op(a, b) (see
    csrc/elemwise_xf.cu), the output shape and its element count.  Axes
    of size 1 are dropped and neighbouring axes merged wherever both
    operands step evenly across them, so operands of one shape laid out
    alike take one axis.  Raises on what the kernel does not take."""
    if op not in _ELEMWISE_OPS:
        raise ValueError(f"elemwise_xf: unknown op {op!r}")
    if a.dtype != F64 or b.dtype != F64 or a.get_device() != b.get_device():
        raise ValueError(f"elemwise_xf: need float64 limbs on one CUDA device, got "
                         f"{a.dtype} on {a.device} and {b.dtype} on {b.device}")
    ka, kb = a.shape[0], b.shape[0]
    k = max(ka, kb)
    _check_k(k)
    shape = tuple(_broadcast_shape(a.shape[1:], b.shape[1:]))

    dims, (sa, sb) = _merged_axes(shape, (a.shape[1:], a.stride()[1:]),
                                  (b.shape[1:], b.stride()[1:]))
    if len(dims) > ELEMWISE_MAX_AXES:
        raise ValueError(f"elemwise_xf: {shape} takes {len(dims)} axes, the kernel "
                         f"{ELEMWISE_MAX_AXES}")
    dims, sa, sb = dims or [1], sa or [0], sb or [0]
    pad = [1] * (ELEMWISE_MAX_AXES - len(dims))
    zeros = [0] * len(pad)
    N = 1
    for d in dims:
        N *= d
    desc = ([k, _ELEMWISE_OPS[op][0], N, len(dims)] + pad + dims
            + [ka, a.stride(0)] + zeros + sa + [kb, b.stride(0)] + zeros + sb)
    return struct.pack("<20q", *desc), (k,) + shape, N


_elemwise_plans = {}


def elemwise_xf(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K8 wrapper: op "add" or "mul" of the float64 limb tensors a (ka,
    *sa) and b (kb, *sb), k = max(ka, kb) = 2..12, read in place at their
    own strides -> (k, *shape) contiguous, as elemwise_xf_torch.  One
    launch; the operand description is computed once for each layout of
    the pair and kept."""
    dev = a.get_device()
    if not a.is_cuda:
        if a.device.type == "cpu" and b.device.type == "cpu":
            return elemwise_xf_torch(op, a, b)
        raise ValueError(f"elemwise_xf: unsupported devices {a.device}, {b.device}")
    key = (op, a.shape, a.stride(), b.shape, b.stride(), a.dtype, b.dtype, dev,
           b.get_device())
    desc, shape, N = _build.cached_plan(_elemwise_plans, key, _elemwise_plan, op, a, b)
    out = a.new_empty(shape)
    if N:
        rc = _build.library().clrs_elemwise_xf(desc, a.data_ptr(), b.data_ptr(),
                                               out.data_ptr(), _build.stream(a))
        if rc:
            _build.check(rc, "clrs_elemwise_xf", shape[0])
        elemwise_xf.launches += 1
    return out


elemwise_xf.launches = 0
