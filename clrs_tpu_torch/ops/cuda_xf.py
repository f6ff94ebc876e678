"""Double-double kernels K2 and K3, each beside its plain PyTorch version.

K2 is ``csrc/schur_pairs.cu`` (replaces
``pallas_xf._schur_pairs_kernel_k`` at k=2): the elementwise Schur core
w = ((a1 b1 + a2 b2) + (a3 b3 + a4 b4)) HH.  K3 is ``csrc/matmul_dd.cu``
(replaces ``pallas_xf._matmul_kernel``): the batched dd matmul by
sequential rank-1 accumulation.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises), counting launches in its
``launches`` attribute.  The plain versions perform the kernels'
operations in the kernels' order, so the two agree bit for bit; K3's
sequential accumulation differs from ``xfloat.xf_matmul``'s product tree
in the low limbs, by design, as on the TPU.
"""

from __future__ import annotations

import torch

from clrs_tpu_torch.ops import _build
from clrs_tpu_torch.ops.xfloat import (
    F64,
    XF,
    dd_add,
    dd_mul,
    fast_two_sum,
    two_prod,
)


def _check_cuda(name: str, *ts: torch.Tensor):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype != F64:
            raise ValueError(f"{name}: need float64 limbs, got {t.dtype}")


# ---------------------------------------------------------------------------
# K2: Schur pairs core
# ---------------------------------------------------------------------------


def schur_pairs_torch(a4: torch.Tensor, b4: torch.Tensor,
                      hh: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: a4, b4 (2, G, P2, 4, T, T), hh (2, G, T, T) ->
    (2, G, P2, T, T)."""
    p = [dd_mul(a4[0, :, :, i], a4[1, :, :, i], b4[0, :, :, i], b4[1, :, :, i])
         for i in range(4)]
    s12 = dd_add(*p[0], *p[1])
    s34 = dd_add(*p[2], *p[3])
    sh, sl = dd_add(*s12, *s34)
    wh, wl = dd_mul(sh, sl, hh[0][:, None], hh[1][:, None])
    return torch.stack([wh, wl])


def schur_pairs(a4: torch.Tensor, b4: torch.Tensor, hh: torch.Tensor) -> torch.Tensor:
    """K2 wrapper (shapes as schur_pairs_torch)."""
    if a4.device.type == "cpu":
        return schur_pairs_torch(a4, b4, hh)
    _check_cuda("schur_pairs", a4, b4, hh)
    _, G, P2, four, T, T2 = a4.shape
    if four != 4 or T != T2 or tuple(b4.shape) != tuple(a4.shape) \
            or tuple(hh.shape) != (2, G, T, T):
        raise ValueError(f"schur_pairs: bad shapes {tuple(a4.shape)} "
                         f"{tuple(b4.shape)} {tuple(hh.shape)}")
    a4, b4, hh = a4.contiguous(), b4.contiguous(), hh.contiguous()
    out = torch.empty((2, G, P2, T, T), dtype=F64, device=a4.device)
    lib = _build.library()
    rc = lib.clrs_schur_pairs_dd(
        a4.data_ptr(), b4.data_ptr(), hh.data_ptr(), out.data_ptr(), G, P2, T,
        torch.cuda.current_stream(a4.device).cuda_stream)
    _build.check(rc, "clrs_schur_pairs_dd")
    schur_pairs.launches += 1
    return out


schur_pairs.launches = 0


# ---------------------------------------------------------------------------
# K3: batched dd matmul
# ---------------------------------------------------------------------------


def dd_matmul_seq_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: a (2, B, n, K), b (2, B, K, m) -> (2, B, n, m),
    C += a[:, r] (x) b[r, :] for r = 0..K-1 in order."""
    _, B, n, K = a.shape
    m = b.shape[-1]
    ch = torch.zeros((B, n, m), dtype=F64, device=a.device)
    cl = torch.zeros_like(ch)
    for r in range(K):
        ah, al = a[0, :, :, r:r + 1], a[1, :, :, r:r + 1]  # (B, n, 1)
        bh, bl = b[0, :, r:r + 1, :], b[1, :, r:r + 1, :]  # (B, 1, m)
        ph, pe = two_prod(ah, bh)
        plo = pe + (ah * bl + al * bh)
        ph, plo = fast_two_sum(ph, plo)
        ch, cl = dd_add(ch, cl, ph, plo)
    return torch.stack([ch, cl])


def dd_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3 wrapper (shapes as dd_matmul_seq_torch)."""
    if a.device.type == "cpu":
        return dd_matmul_seq_torch(a, b)
    _check_cuda("dd_matmul", a, b)
    two, B, n, K = a.shape
    if two != 2 or tuple(b.shape[:3]) != (2, B, K):
        raise ValueError(f"dd_matmul: bad shapes {tuple(a.shape)} {tuple(b.shape)}")
    m = b.shape[-1]
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((2, B, n, m), dtype=F64, device=a.device)
    lib = _build.library()
    rc = lib.clrs_matmul_dd(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), B, n, K, m,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "clrs_matmul_dd")
    dd_matmul.launches += 1
    return c


dd_matmul.launches = 0


def xf_matmul_dd(a: XF, b: XF) -> XF:
    """(..., n, K) x (..., K, m) through K3; leading batch axes broadcast
    and are flattened into the kernel's batch."""
    if a.k != 2 or b.k != 2:
        raise NotImplementedError("K3 is the k=2 matmul")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    n, K = a.shape[-2:]
    m = b.shape[-1]
    al = torch.broadcast_to(a.limbs, (2,) + batch + (n, K)).reshape(2, -1, n, K)
    bl = torch.broadcast_to(b.limbs, (2,) + batch + (K, m)).reshape(2, -1, K, m)
    return XF(dd_matmul(al, bl).reshape((2,) + batch + (n, m)))
