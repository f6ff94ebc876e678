"""How accurate is the inverse of sp86's largest S_j (261 rows) at k limbs,
by K5's panel route and by the reference's algorithm, against mpmath?

    python scripts/sp86_schur_accuracy.py out.json [k] [--cache DIR]

Runs the port on the CPU on the all-kernels route's plain versions (bit
for bit the card's, chip_smoke.py phase 14) on sp86 as
clrs_tpu_torch/tools/sphere_history.py builds it (--cache as there) at k
limbs (default 6), and keeps the S_j of 261 rows that the panel route
(ops/cuda_xf.spd_inverse_panels) inverts at iterations 1 and 2, with the
inverse it returned; the solve stops there.  For each it computes the
inverse by ops/linalg.xf_spd_inverse (the reference's panel Cholesky and
triangular solves, limb for limb the reference's) and, from the limbs'
exact sum, by mpmath at PREC bits, and prints cond_1(S_j) from mpmath's
inverse and each inverse's largest entry error relative to mpmath's
largest entry; out.json keeps the numbers.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mpmath  # noqa: E402
import torch  # noqa: E402

from clrs_tpu_torch import solverank1sdp  # noqa: E402
from clrs_tpu_torch.core.problem import _pack_from_data  # noqa: E402
from clrs_tpu_torch.ops import cuda_xf  # noqa: E402
from clrs_tpu_torch.ops.linalg import xf_spd_inverse  # noqa: E402
from clrs_tpu_torch.ops.xfloat import XF  # noqa: E402
from clrs_tpu_torch.tools import sphere_history  # noqa: E402

D, N, KEEP = 43, 261, 2
PREC = 1200


class Enough(Exception):
    pass


def to_mp(limbs):
    """(k, n, n) float64 limbs -> mpmath matrix of their exact sums."""
    k, n, _ = limbs.shape
    rows = limbs.permute(1, 2, 0).tolist()
    return mpmath.matrix([[mpmath.fsum(mpmath.mpf(v) for v in rows[i][j]) for j in range(n)]
                          for i in range(n)])


def rel_error(limbs, exact, scale):
    """Largest |limb sum - exact| over scale."""
    got = to_mp(limbs)
    n = exact.rows
    return float(max(abs(got[i, j] - exact[i, j]) for i in range(n) for j in range(n)) / scale)


def accuracy(a, inv_panel, ok, k):
    """The numbers printed for one S_j: a and inv_panel (k, n, n) limbs."""
    t0 = time.time()
    inv_ref, ok_ref = xf_spd_inverse(XF(a))
    t_ref = time.time() - t0
    old = mpmath.mp.prec
    mpmath.mp.prec = PREC
    try:
        A = to_mp(a)
        t0 = time.time()
        exact = A ** -1
        t_mp = time.time() - t0
        n = A.rows
        scale = max(abs(x) for x in exact)
        norm1 = lambda m: max(mpmath.fsum(abs(m[i, j]) for i in range(n)) for j in range(n))  # noqa: E731
        cond = float(norm1(A) * norm1(exact))
        return dict(cond_1=cond, cond_eps=cond * 2.0 ** (-53 * k), ok_panel=ok,
                    ok_reference=bool(ok_ref), err_panel=rel_error(inv_panel, exact, scale),
                    err_reference=rel_error(inv_ref.limbs, exact, scale), reference_s=t_ref,
                    mpmath_s=t_mp)
    finally:
        mpmath.mp.prec = old


def main():
    args = sys.argv[1:]
    cache = None
    if "--cache" in args:
        i = args.index("--cache")
        cache, args = args[i + 1], args[:i] + args[i + 2:]
    out = args[0]
    k = int(args[1]) if len(args) > 1 else 6
    torch.set_num_threads(2)
    data = sphere_history.pack_data(D, cache)
    mpmath.mp.prec = sphere_history.PREC
    problem = _pack_from_data(data, k, torch.device("cpu"))
    kept, panels = [], cuda_xf.spd_inverse_panels

    def keep(a, plain=False):
        inv, ok = panels(a, plain)
        if a.shape[-1] == N:
            kept.append((a[:, 0].clone(), inv[:, 0].clone(), bool(ok[0])))
            print(f"kept S_j {len(kept)} ({time.strftime('%H:%M:%S')})", flush=True)
            if len(kept) == KEEP:
                raise Enough
        return inv, ok

    cuda_xf.spd_inverse_panels = keep
    try:
        solverank1sdp(problem=problem, use_cuda_matmul=True, **sphere_history.ROUTES["all"],
                      **dict(sphere_history.OPTIONS, maxiterations=KEEP, verbose=True))
    except Enough:
        pass
    finally:
        cuda_xf.spd_inverse_panels = panels
    record = dict(k=k, prec=PREC, iterations=[])
    for it, (a, inv_panel, ok) in enumerate(kept, 1):
        row = dict(iteration=it, **accuracy(a, inv_panel, ok, k))
        record["iterations"].append(row)
        print(f"iteration {it}: cond_1 {row['cond_1']:.3e} (cond eps_k {row['cond_eps']:.3e}); "
              f"inverse error, relative to its largest entry: panel route "
              f"{row['err_panel']:.3e}, reference's algorithm {row['err_reference']:.3e} (ok "
              f"{ok}, {row['ok_reference']}; {row['reference_s']:.0f} s, mpmath "
              f"{row['mpmath_s']:.0f} s)", flush=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
