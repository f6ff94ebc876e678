"""Double-double dense linear algebra on XF matrices (torch).

Counterpart of ``clrs_tpu/ops/linalg.py``.  Every function takes XF
matrices of shape (..., n, n): the leading axes are a batch of
independent blocks, the port's form of the reference's ``jax.vmap``.  A
batch changes nothing in the arithmetic: each block goes through the
reference's sequence of operations, so results agree limb for limb.

The reference's ``lax.fori_loop`` bodies become Python loops over
columns/rows; dynamic slices become plain indexing.  Factorizations
return an ``ok`` flag per block instead of raising (the degradation
ladder of the solver switches to LU on failure).

At n >= ``_PANEL_MIN_N`` the Cholesky and the triangular solves dispatch
to the reference's blocked panel forms, whose trailing updates are
``xf_matmul`` products, split into row bands over a process group when
one is given (``xf_cholesky``, ``xf_spd_inverse``: ``group=``); ``xf_lu``
has no panel form and runs at any n, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from clrs_tpu_torch.ops.xfloat import (
    XF,
    _broadcast_shape,
    xf_abs,
    xf_add,
    xf_div,
    xf_matmul,
    xf_mul,
    xf_sqrt,
    xf_sum,
    xf_where,
)
from clrs_tpu_torch.ops.bands import gather, row_band, size_rank

# The reference's defaults (clrs_tpu/ops/linalg.py:45-46): the order at
# which the Cholesky and the triangular solves take the panel forms, and
# the panel width.  The reference reads them from
# CLRS_PANEL_CHOL_MIN_N / CLRS_PANEL_CHOL_PANEL; the port keeps them as
# constants.
_PANEL_MIN_N = 256
_PANEL_DEFAULT = 32


def _panel(n: int) -> bool:
    return n >= _PANEL_MIN_N


def _matvec(a: XF, v: XF) -> XF:
    """(..., n, m) @ (..., m) in expansion arithmetic (tree over m)."""
    prod = xf_mul(a, XF(v.limbs[..., None, :]))
    return xf_sum(prod, axis=-1)


def _batch(a: XF):
    return a.shape[:-2]


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def xf_cholesky(a: XF, group=None) -> Tuple[XF, torch.Tensor]:
    """Lower-triangular L with a = L L^T; returns (L, ok) with ok False
    per block where a pivot is <= 0.  At n >= _PANEL_MIN_N the blocked
    panel form, its trailing updates in row bands over group where the
    ranks divide the padded order (else every rank computes them whole)."""
    n = a.shape[-1]
    if _panel(n):
        padded = -(-n // _PANEL_DEFAULT) * _PANEL_DEFAULT
        if padded % size_rank(group)[0]:
            group = None
        return xf_cholesky_panel(a, panel=_PANEL_DEFAULT, group=group)
    return xf_cholesky_seq(a)


def xf_cholesky_seq(a: XF) -> Tuple[XF, torch.Tensor]:
    """One column per step, as the reference's sequential kernel."""
    n = a.shape[-1]
    k, dev = a.k, a.device
    iota = _iota(n, dev)
    L = XF.zeros(a.shape, k=k, dtype=a.dtype, device=dev)
    ok = torch.ones(_batch(a), dtype=torch.bool, device=dev)
    one = XF.ones((), k=k, dtype=a.dtype, device=dev)
    zero_col = XF.zeros(a.shape[:-1], k=k, dtype=a.dtype, device=dev)
    for j in range(n):
        rowj = L[..., j, :]  # L[j, t], zero for t >= j
        colA = a[..., :, j]
        s = xf_add(colA, -_matvec(L, rowj))
        djj = s[..., j]
        pos = djj.limbs[0] > 0
        ok = ok & pos
        safe = xf_where(pos, djj, one)
        ljj = xf_sqrt(safe)
        col = xf_div(s, XF(ljj.limbs[..., None]))
        col = xf_where(iota > j, col, zero_col)
        col = xf_where(iota == j, XF(ljj.limbs[..., None]), col)
        L.limbs[..., :, j] = col.limbs
    return L, ok


def xf_cholesky_panel(a: XF, panel: int = 32, group=None) -> Tuple[XF, torch.Tensor]:
    """Blocked right-looking Cholesky (clrs_tpu/ops/linalg.py:124-204).
    Per panel: the (panel x panel) diagonal block by the sequential kernel;
    W = L_d^-1 A[p0:p0+panel, :], the whole row slab; L's column block is
    W^T masked to rows >= p0; the trailing update A -= W_f^T W_f, W_f = W
    masked to the columns past the panel, through the plain xf_matmul.  An
    n that the panel does not divide is padded with an exact identity tail.

    With a process group (the reference's ``axis``/``n_dev`` under
    shard_map, :187-196) each rank forms its contiguous band of the
    trailing update's rows, and the bands are gathered in rank order
    (ops/bands.py).  Each output row's product tree never crosses
    rows, so the factor is the same bits at any rank count.  The padded
    order must divide the ranks (the reference's assert, :157): else
    ValueError."""
    n0 = a.shape[-1]
    k, dev, bs = a.k, a.device, _batch(a)
    n = -(-n0 // panel) * panel
    if n % size_rank(group)[0]:
        raise ValueError(f"xf_cholesky_panel: the padded order {n} does not divide "
                         f"{size_rank(group)[0]} ranks")
    rows = row_band(n, group)
    if n != n0:
        pad = n - n0
        lim = torch.nn.functional.pad(a.limbs, (0, pad, 0, pad))
        eye = XF.eye(pad, k=k, dtype=a.dtype, device=dev).limbs
        lim[..., n0:, n0:] = eye.reshape((k,) + (1,) * len(bs) + (pad, pad))
        a = XF(lim)
    cols = _iota(n, dev)
    zeros_col = XF.zeros((n, panel), k=k, dtype=a.dtype, device=dev)
    zeros_row = XF.zeros((panel, n), k=k, dtype=a.dtype, device=dev)
    A = a
    L = XF.zeros(bs + (n, n), k=k, dtype=a.dtype, device=dev)
    ok = torch.ones(bs, dtype=torch.bool, device=dev)
    for p0 in range(0, n, panel):
        Ld, okd = xf_cholesky_seq(A[..., p0:p0 + panel, p0:p0 + panel])
        ok = ok & okd
        W = xf_solve_tril(Ld, A[..., p0:p0 + panel, :])  # (..., panel, n)
        Lcol = xf_where((cols >= p0)[:, None], W.mT, zeros_col)
        L.limbs[..., p0:p0 + panel] = Lcol.limbs
        Wf = xf_where((cols >= p0 + panel)[None, :], W, zeros_row)
        U = gather(xf_matmul(Wf.mT[..., rows, :], Wf).limbs, -2, group)
        A = xf_add(A, XF(-U))
    if n != n0:
        L = XF(L.limbs[..., :n0, :n0].contiguous())
    return L, ok


def xf_solve_tril(l: XF, b: XF, unit_diag: bool = False) -> XF:
    """Solve L x = b with L lower triangular; b is (..., n, m).  At n >=
    _PANEL_MIN_N the blocked panel form."""
    if _panel(l.shape[-1]):
        return xf_solve_tril_panel(l, b, unit_diag=unit_diag, panel=_PANEL_DEFAULT)
    return xf_solve_tril_seq(l, b, unit_diag=unit_diag)


def xf_solve_tril_seq(l: XF, b: XF, unit_diag: bool = False) -> XF:
    n = l.shape[-1]
    x = XF.zeros(_broadcast_shape(l.shape[:-2], b.shape[:-2]) + b.shape[-2:],
                 k=l.k, dtype=l.dtype, device=l.device)
    for i in range(n):
        rowl = l[..., i, :]  # (..., n)
        rowb = b[..., i, :]  # (..., m)
        # acc = rowl @ x  (entries of x with row >= i are still zero)
        prod = xf_mul(XF(rowl.limbs[..., :, None]), x)
        acc = xf_sum(prod, axis=-2)
        num = xf_add(rowb, -acc)
        if not unit_diag:
            num = xf_div(num, XF(rowl.limbs[..., i, None]))
        x.limbs[..., i, :] = num.limbs
    return x


def xf_solve_tril_panel(l: XF, b: XF, unit_diag: bool = False, panel: int = 32) -> XF:
    """Blocked forward substitution (clrs_tpu/ops/linalg.py:241-264): per
    panel, one xf_matmul of its rows of L left of the panel with the rows
    of x already solved, subtracted from b's rows, then the diagonal block
    by the sequential solve.  b is (..., n, m), or an unbatched (n,)
    vector, solved as one column and returned as a vector."""
    squeeze = b.ndim == 1
    if squeeze:
        b = XF(b.limbs[..., None])
    n, m = l.shape[-1], b.shape[-1]
    x = XF.zeros(_broadcast_shape(l.shape[:-2], b.shape[:-2]) + (n, m), k=l.k,
                 dtype=l.dtype, device=l.device)
    for p0 in range(0, n, panel):
        p1 = min(p0 + panel, n)
        rhs = b[..., p0:p1, :]
        if p0:
            acc = xf_matmul(l[..., p0:p1, :p0], x[..., :p0, :])
            rhs = xf_add(rhs, XF(-acc.limbs))
        xp = xf_solve_tril_seq(l[..., p0:p1, p0:p1], rhs, unit_diag=unit_diag)
        x.limbs[..., p0:p1, :] = xp.limbs
    return XF(x.limbs[..., 0]) if squeeze else x


def xf_solve_triu(u: XF, b: XF, unit_diag: bool = False) -> XF:
    """Solve U x = b with U upper triangular; b is (..., n, m).  At n >=
    _PANEL_MIN_N the blocked panel form."""
    if _panel(u.shape[-1]):
        return xf_solve_triu_panel(u, b, unit_diag=unit_diag, panel=_PANEL_DEFAULT)
    return xf_solve_triu_seq(u, b, unit_diag=unit_diag)


def xf_solve_triu_seq(u: XF, b: XF, unit_diag: bool = False) -> XF:
    n = u.shape[-1]
    x = XF.zeros(_broadcast_shape(u.shape[:-2], b.shape[:-2]) + b.shape[-2:],
                 k=u.k, dtype=u.dtype, device=u.device)
    for step in range(n):
        i = n - 1 - step
        rowu = u[..., i, :]
        rowb = b[..., i, :]
        prod = xf_mul(XF(rowu.limbs[..., :, None]), x)
        acc = xf_sum(prod, axis=-2)
        num = xf_add(rowb, -acc)
        if not unit_diag:
            num = xf_div(num, XF(rowu.limbs[..., i, None]))
        x.limbs[..., i, :] = num.limbs
    return x


def xf_solve_triu_panel(u: XF, b: XF, unit_diag: bool = False, panel: int = 32) -> XF:
    """Blocked back substitution (clrs_tpu/ops/linalg.py:300-322): the
    panels of xf_solve_tril_panel from the bottom up."""
    squeeze = b.ndim == 1
    if squeeze:
        b = XF(b.limbs[..., None])
    n, m = u.shape[-1], b.shape[-1]
    x = XF.zeros(_broadcast_shape(u.shape[:-2], b.shape[:-2]) + (n, m), k=u.k,
                 dtype=u.dtype, device=u.device)
    for p0 in reversed(range(0, n, panel)):
        p1 = min(p0 + panel, n)
        rhs = b[..., p0:p1, :]
        if p1 < n:
            acc = xf_matmul(u[..., p0:p1, p1:], x[..., p1:, :])
            rhs = xf_add(rhs, XF(-acc.limbs))
        xp = xf_solve_triu_seq(u[..., p0:p1, p0:p1], rhs, unit_diag=unit_diag)
        x.limbs[..., p0:p1, :] = xp.limbs
    return XF(x.limbs[..., 0]) if squeeze else x


def _take_rows(limbs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """limbs (k, ..., n, m), idx (..., n) -> rows permuted per batch."""
    k = limbs.shape[0]
    m = limbs.shape[-1]
    g = idx[None, ..., None].expand((k,) + tuple(idx.shape) + (m,))
    return torch.gather(limbs, limbs.ndim - 2, g)


def xf_lu(a: XF) -> Tuple[XF, torch.Tensor, torch.Tensor]:
    """LU with partial pivoting: returns (LU packed, perm, ok); perm is the
    row permutation with a[perm] = L @ U."""
    n = a.shape[-1]
    k, dev = a.k, a.device
    bs = _batch(a)
    iota = _iota(n, dev)
    one = XF.ones((), k=k, dtype=a.dtype, device=dev)
    lu = XF(a.limbs.clone())
    perm = iota.expand(bs + (n,)).clone()
    ok = torch.ones(bs, dtype=torch.bool, device=dev)
    zero_vec = XF.zeros(bs + (n,), k=k, dtype=a.dtype, device=dev)
    zero_mat = XF.zeros(a.shape, k=k, dtype=a.dtype, device=dev)
    for kk in range(n):
        mag = torch.abs(lu.limbs[0][..., :, kk])
        mag = torch.where(iota >= kk, mag, -torch.inf)
        p = torch.argmax(mag, dim=-1)  # first maximum on ties, like jnp
        ok = ok & (torch.gather(mag, -1, p[..., None])[..., 0] > 0)
        # swap rows kk <-> p
        idx = iota.expand(bs + (n,)).clone()
        idx[..., kk] = p
        idx.scatter_(-1, p[..., None], torch.full_like(p[..., None], kk))
        lu = XF(_take_rows(lu.limbs, idx))
        perm = torch.gather(perm, -1, idx)
        # eliminate below the pivot
        rowk = lu[..., kk, :]
        pivot = rowk[..., kk]
        safe_p = xf_where(xf_abs(pivot).limbs[0] > 0, pivot, one)
        colk = lu[..., :, kk]
        mults = xf_div(colk, XF(safe_p.limbs[..., None]))
        mults = xf_where(iota > kk, mults, zero_vec)
        upd = xf_mul(XF(mults.limbs[..., :, None]), XF(rowk.limbs[..., None, :]))
        upd = xf_where((iota > kk)[None, :], upd, zero_mat)
        lu = xf_add(lu, -upd)
        newcol = xf_where(iota > kk, mults, colk)
        lu.limbs[..., :, kk] = newcol.limbs
    return lu, perm, ok


def xf_lu_solve(lu: XF, perm: torch.Tensor, b: XF) -> XF:
    """Solve A x = b from packed LU factors."""
    pb = XF(_take_rows(b.broadcast_to(lu.shape[:-2] + b.shape[-2:]).limbs, perm))
    y = xf_solve_tril(lu, pb, unit_diag=True)
    return xf_solve_triu(lu, y, unit_diag=False)


def xf_spd_inverse(a: XF, group=None) -> Tuple[XF, torch.Tensor]:
    """SPD inverse via Cholesky: L^-T (L^-1 I); group bands the panel
    form's trailing updates (xf_cholesky)."""
    n = a.shape[-1]
    L, ok = xf_cholesky(a, group)
    eye = XF.eye(n, k=a.k, dtype=a.dtype, device=a.device)
    w = xf_solve_tril(L, eye)
    inv = xf_solve_triu(L.mT, w)
    return inv, ok


def xf_inverse_lu(a: XF) -> Tuple[XF, torch.Tensor]:
    """General inverse via LU."""
    n = a.shape[-1]
    lu, perm, ok = xf_lu(a)
    eye = XF.eye(n, k=a.k, dtype=a.dtype, device=a.device)
    return xf_lu_solve(lu, perm, eye), ok


def xf_sym(a: XF) -> XF:
    """(A + A^T)/2."""
    s = xf_add(a, a.mT)
    return XF(s.limbs * 0.5)


def xf_eigvalsh_approx(a: XF) -> torch.Tensor:
    """Eigenvalues of a symmetric XF matrix, in plain float64, on the
    matrix's own device (the step length consumes only lambda_min with a
    gamma=0.7 slack, so float64 relative accuracy suffices).  A 1x1
    matrix is its own eigenvalue, as the eigensolvers return it, without
    their error check (which on a CUDA device reads a status back to the
    host)."""
    if a.shape[-1] == 1:
        return a.to_float64()[..., 0]
    return torch.linalg.eigvalsh(a.to_float64())


_SCHEDULES = {}


def _device_schedule(n: int, device):
    """_jacobi_schedule(n) as two int64 tensors on ``device``, copied there
    once per (n, device) and kept: a copy from pageable host memory in
    every round would block the host."""
    key = (n, torch.device(device))
    if key not in _SCHEDULES:
        top, bot = _jacobi_schedule(n)
        _SCHEDULES[key] = (torch.from_numpy(top).to(device), torch.from_numpy(bot).to(device))
    return _SCHEDULES[key]


def _jacobi_schedule(n: int):
    """Round-robin pairings: (rounds, n//2) index arrays top/bot such that
    every unordered pair appears once across the n-1 rounds."""
    assert n % 2 == 0
    rounds = n - 1
    top = np.zeros((rounds, n // 2), dtype=np.int64)
    bot = np.zeros((rounds, n // 2), dtype=np.int64)
    others = list(range(1, n))
    for r in range(rounds):
        arr = [0] + others[r:] + others[:r]
        for i in range(n // 2):
            a, b = arr[i], arr[n - 1 - i]
            top[r, i], bot[r, i] = min(a, b), max(a, b)
    return top, bot


def jacobi_min_eig(a: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Safe lower bound on lambda_min of a symmetric matrix (..., n, n) in
    its own dtype: parallel-order cyclic Jacobi, each round one orthogonal
    similarity Q^T A Q, then the Gershgorin lower bound of the rotated
    matrix (never above the true lambda_min)."""
    n = a.shape[-1]
    if n == 1:
        return a[..., 0, 0]
    dtype, dev = a.dtype, a.device
    npad = n + (n % 2)
    if npad != n:
        # decoupled pad eigenvalue = max diagonal, never the minimum
        pad_val = torch.amax(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
        a[..., n, n] = pad_val
    top, bot = _device_schedule(npad, dev)
    rounds = top.shape[0]
    eye = torch.eye(npad, dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).tiny
    for step in range(sweeps * rounds):
        r = step % rounds
        p = top[r]
        q = bot[r]
        app = a[..., p, p]
        aqq = a[..., q, q]
        apq = a[..., p, q]
        small = torch.abs(apq) <= tiny
        safe_apq = torch.where(small, 1.0, apq)
        tau = (aqq - app) / (2.0 * safe_apq)
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0, 1.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        c = torch.where(small, 1.0, c)
        s = torch.where(small, 0.0, s)
        Q = eye.expand(a.shape).clone()
        Q[..., p, p] = c
        Q[..., q, q] = c
        Q[..., p, q] = s
        Q[..., q, p] = -s
        a = torch.matmul(Q.transpose(-1, -2), torch.matmul(a, Q))
        a = (a + a.transpose(-1, -2)) * 0.5
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    radius = torch.sum(torch.abs(a), dim=-1) - torch.abs(diag)
    return torch.amin(diag - radius, dim=-1)


def xf_min_eig_sym(m: XF, dm: XF) -> Tuple[torch.Tensor, torch.Tensor]:
    """lambda_min of L^-1 dM L^-T where m = L L^T (the step-length
    oracle), per block: returns (lambda_min, ok)."""
    L, ok = xf_cholesky(m)
    w = xf_solve_tril(L, dm)
    lml = xf_solve_tril(L, w.mT)
    lml_sym = xf_sym(lml)
    if lml_sym.dtype == torch.float32:
        return jacobi_min_eig(lml_sym.to_float()), ok
    eigs = xf_eigvalsh_approx(lml_sym)
    return torch.amin(eigs, dim=-1), ok
