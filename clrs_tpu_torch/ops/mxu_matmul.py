"""k-limb matmul by integer slices on int8 tensor cores (torch).

Counterpart of ``clrs_tpu/ops/mxu_matmul.py`` (the Ozaki scheme): an
expansion product is computed as a sum of small integer products.  Each
row of A and each column of B is scaled by a power of two into [-1, 1],
cut into S slices of 7 bits, and the slice products run as int8 x int8 ->
int32 matrix products (``torch._int_mm``: the card's int8 tensor cores,
the CPU's integer GEMM).  Integer sums are exact, so the int32 sums of
each diagonal s1 + s2 = d (d < S) are the reference's bit for bit,
however they are grouped; they are rebuilt into k float64 limbs with
``xf_ldexp`` and ``xf_add`` in the reference's order.  Slice pairs with
s1 + s2 >= S are dropped:
  |C - C_exact| <= K * rowscale_i * colscale_j * 2^(-7S+2).

Only the float64 branch of the reference is ported: the port's limbs are
always float64.  ``_row_exponents`` keeps the reference's rule (the
largest entry scaled into (0.5, 1], not ``torch.frexp``'s [0.5, 1)), with
one departure: where the largest positive entry scales to 255/256 or more
(an exact power of two among them) its first slice would round to +2^7,
one past int8.  The reference's conversion saturates it to 127 while the
remainder carried on assumes 128, so its product errs by up to 2^-7 of
that row's scale (config 1 at k=3 stalls at 239.9993 on that route); here
such a row or column takes one more power of two, and its slices are
exact.  A negative entry's first slice reaches -2^7 at most, which int8
holds, so a row whose largest magnitude is negative (-2^5, say) keeps the
reference's exponent.  Everywhere else the two agree bit for bit.

The products are not a kernel of this package: the reference computes
them with ``jax.lax.dot_general`` outside any Pallas kernel, and the port
with a library product.  A 2-D product takes one ``torch._int_mm`` launch
for every diagonal at once (_diagonal_sums: the A slices side by side on
the contraction, the B slices in a block-triangular matrix, twice the
products the diagonals need and no more output than they fill); a batch
of G products takes G.  The slicing and the rebuilding are S steps each
of elementwise expansion arithmetic, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from clrs_tpu_torch.ops.xfloat import XF, _broadcast_shape, pow2, xf_add, xf_ldexp

_BITS = 7  # bits per slice; the first slice reaches -2^7..2^7 - 1, the others +-2^6
_SATURATES = 255 / 256  # a scaled entry whose first slice rounds to +2^7
_INT_MM_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows,
_INT_MM_MULTIPLE = 8  # K and N multiples of 8, B column-major


def _default_slices(k: int) -> int:
    """S for k float64 limbs: 7 S covers 53 k + 7 bits."""
    return math.ceil((53 * k + _BITS) / _BITS)


def _max_contraction(slices: int) -> int:
    """The largest contraction whose diagonal sums fit int32: |q_0| <=
    2^7, |q_s| <= 2^6 for s >= 1, so a diagonal's terms per contraction
    index sum to at most 2^14 + (S - 2) 2^12 = 2^12 (S + 2)."""
    return (2 ** 31 - 1) // (2 ** 12 * (slices + 2))


def _row_exponents(a: XF, dim: int) -> torch.Tensor:
    """e with max|entry| 2^-e in (0.5, 1] along ``dim`` (hi limbs): an
    approximate log2, then one exact correction, as the reference
    (mxu_matmul.py:42-58); then e + 1 where the largest positive entry
    scales to 255/256 or more, whose first slice would round to +2^7, one
    past int8 (a negative one rounds to -2^7 at most, which int8 holds)."""
    top = torch.amax(torch.abs(a.limbs[0]), dim=dim)
    mx = torch.where(top > 0, top, 1.0)
    e = torch.floor(torch.log2(mx)).to(torch.int64) + 1
    scaled = mx * pow2(-e)
    e = torch.where(scaled > 1.0, e + 1, e)
    e = torch.where(scaled <= 0.5, e - 1, e)
    return torch.where(torch.amax(a.limbs[0], dim=dim) * pow2(-e) >= _SATURATES, e + 1, e)


def _slices(r: XF, slices: int):
    """Cut r (-1 <= r < 255/256) into int8 slices: r = sum_s q_s
    2^(-7(s+1)) + O(2^(-7S)), -2^7 <= q_0 <= 2^7 - 1 and |q_s| <= 2^6
    after it."""
    qs = []
    for _ in range(slices):
        r = XF(r.limbs * 2.0 ** _BITS)
        q = torch.round(r.limbs[0])
        r = xf_add(r, XF.from_float(-q, k=1))
        qs.append(q.to(torch.int8))
    return qs


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x.contiguous()
    out = x.new_zeros((rows, cols))
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _up(n: int) -> int:
    return -(-n // _INT_MM_MULTIPLE) * _INT_MM_MULTIPLE


def _diagonal_sums(qa: torch.Tensor, qb: torch.Tensor, slices: int) -> torch.Tensor:
    """qa (S, n, K), qb (S, K, m) int8 -> (S, n, m) int32, the sums over
    s1 + s2 = d of qa[s1] @ qb[s2], every diagonal in one torch._int_mm:
    [qa_0 | ... | qa_{S-1}] (n, S K) times the block matrix (S K, S m) whose
    block (s1, d) is qb[d - s1] for d >= s1 and zero above, so that the
    GEMM's own int32 accumulation forms each diagonal's sum.  The operands
    are zero-padded to _int_mm's shape rules (integer zeros change no sum),
    A row-major and B column-major."""
    S, n, K = qa.shape
    m = qb.shape[-1]
    idx, below = _toeplitz(slices, qa.device)
    blocks = torch.where(below[:, :, None, None], qb[idx], 0)  # (s1, d, K, m)
    rows = max(_INT_MM_ROWS, _up(n))
    inner, cols = max(_INT_MM_MULTIPLE, _up(S * K)), max(_INT_MM_MULTIPLE, _up(S * m))
    A = _pad_to(qa.permute(1, 0, 2).reshape(n, S * K), rows, inner)
    # B column-major, its contraction contiguous: cuBLASLt's int8 GEMM
    # takes only that layout (TN)
    Bt = _pad_to(blocks.permute(1, 3, 0, 2).reshape(S * m, S * K), cols, inner)
    return torch._int_mm(A, Bt.t())[:n, :S * m].reshape(n, S, m).permute(1, 0, 2)


_TOEPLITZ = {}


def _toeplitz(slices: int, device):
    """(d - s1 clamped at 0, d >= s1) over (s1, d), as tensors on device,
    made once per (S, device)."""
    key = (slices, torch.device(device))
    if key not in _TOEPLITZ:
        s = torch.arange(slices)
        diff = s[None, :] - s[:, None]
        _TOEPLITZ[key] = (diff.clamp(min=0).to(device), (diff >= 0).to(device))
    return _TOEPLITZ[key]


def xf_matmul_mxu(a: XF, b: XF, slices: Optional[int] = None) -> XF:
    """C = A @ B by int8 slices: a (..., n, K), b (..., K, m) -> (...,
    n, m) at max(a.k, b.k) limbs, the batch axes broadcast, each 2-D
    product of the batch as the reference's ``xf_matmul_mxu`` computes one
    (mxu_matmul.py:77-123).  Raises ValueError where a diagonal's int32 sum
    could overflow, K (S + 2) 2^12 >= 2^31 (the reference wraps there)."""
    if a.ndim < 2 or b.ndim < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"xf_matmul_mxu: bad shapes {a.shape} {b.shape}")
    k = max(a.k, b.k)
    if slices is None:
        slices = _default_slices(k)
    K = a.shape[-1]
    if K > _max_contraction(slices):
        raise ValueError(f"xf_matmul_mxu: a contraction of {K} at {slices} slices can "
                         f"overflow int32 (at most {_max_contraction(slices)})")
    batch = tuple(_broadcast_shape(a.shape[:-2], b.shape[:-2]))
    a = a.broadcast_to(batch + a.shape[-2:])
    b = b.broadcast_to(batch + b.shape[-2:])
    n, m = a.shape[-2], b.shape[-1]

    ea = _row_exponents(a, dim=-1)  # (..., n)
    eb = _row_exponents(b, dim=-2)  # (..., m)
    ra = xf_ldexp(a, -ea[..., None]).reshape((-1,))
    rb = xf_ldexp(b, -eb[..., None, :]).reshape((-1,))
    if a.k == b.k:  # both operands in one pass: the slicing is elementwise
        qs = _slices(XF(torch.cat([ra.limbs, rb.limbs], dim=1)), slices)
        qs = [(q[:ra.shape[0]], q[ra.shape[0]:]) for q in qs]
    else:
        qs = list(zip(_slices(ra, slices), _slices(rb, slices)))
    G = math.prod(batch)
    qa = torch.stack([q for q, _ in qs]).reshape((slices, G, n, K))
    qb = torch.stack([q for _, q in qs]).reshape((slices, G, K, m))
    diag = torch.stack([_diagonal_sums(qa[:, g], qb[:, g], slices) for g in range(G)], dim=1)
    diag = diag.reshape((slices,) + batch + (n, m))

    # C = 2^(ea_i + eb_j) sum_d diag_d 2^(-7(d+2)), added in d's order
    out = None
    for d in range(slices):
        hi = diag[d].to(torch.float64)
        term = XF(torch.cat([hi[None], hi.new_zeros((k - 1,) + hi.shape)]))
        term = xf_ldexp(term, -_BITS * (d + 2))
        out = term if out is None else xf_add(out, term)
    return xf_ldexp(out, ea[..., :, None] + eb[..., None, :])
