"""Residuals of K5's panel route on sp86's own S_j and Q, on the card.

    python scripts/sp86_inverse_residuals.py out.json [k] [iterations] [--cache DIR]

Solves sp86 (the two-species packing at 2d = 86) cold at k limbs
(default 6) on the all-kernels route, with clrs_tpu_torch/tools/
sphere_history.py's problem and options (--cache as there), for
``iterations`` (default 30), and checks every matrix that the panel route
(ops/cuda_xf.spd_inverse_panels) inverts on the way, S_j of 261 rows and
Q of 262: the largest entry of the k-limb residual A A^-1 - I (K4's
product, then K8's add of -I, read from the leading limb) beside
cond_1(A) = ||A||_1 ||A^-1||_1 from limb 0, and that residual over
cond_1(A) 2^(-53 k): near 1 or below for an inverse that is backward
stable at k limbs; one whose entries are as accurate as the limbs allow
(cond_1(A) 2^(-53 k) relative) may leave up to cond_1(A) times more
(scripts/sp86_schur_accuracy.py measures the entries against mpmath).
Prints each call's numbers and the solve's rows, and writes them to
out.json.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mpmath  # noqa: E402
import torch  # noqa: E402

from clrs_tpu_torch import solverank1sdp  # noqa: E402
from clrs_tpu_torch.core.problem import _pack_from_data  # noqa: E402
from clrs_tpu_torch.ops import cuda_xf  # noqa: E402
from clrs_tpu_torch.tools import sphere_history  # noqa: E402

D = 43


def checked(panels, calls):
    """spd_inverse_panels with each call's residual appended to calls."""
    def run(a, plain=False):
        inv, ok = panels(a, plain)
        k, B, n = a.shape[0], a.shape[1], a.shape[-1]
        neg_eye = torch.zeros((k, 1, n, n), dtype=a.dtype, device=a.device)
        neg_eye[0, 0].diagonal().fill_(-1.0)
        res = cuda_xf.elemwise_xf("add", cuda_xf.matmul_xf(a, inv), neg_eye)
        residual = torch.amax(torch.abs(res[0]), dim=(-2, -1))
        norm = lambda x: torch.amax(torch.sum(torch.abs(x[0]), dim=-2), dim=-1)  # noqa: E731
        cond = norm(a) * norm(inv)
        for b in range(B):
            r, c = float(residual[b]), float(cond[b])
            calls.append(dict(n=n, residual=r, cond=c, ok=bool(ok[b]),
                              relative=r / (c * 2.0 ** (-53 * k))))
            print(f"panel call {len(calls)}: n={n} residual {r:.3e} cond_1 {c:.3e} "
                  f"residual/(cond eps_k) {calls[-1]['relative']:.3e} ok {bool(ok[b])}",
                  flush=True)
        return inv, ok
    return run


def main():
    args = sys.argv[1:]
    cache = None
    if "--cache" in args:
        i = args.index("--cache")
        cache, args = args[i + 1], args[:i] + args[i + 2:]
    out = args[0]
    k = int(args[1]) if len(args) > 1 else 6
    iterations = int(args[2]) if len(args) > 2 else 30
    data = sphere_history.pack_data(D, cache)
    mpmath.mp.prec = sphere_history.PREC
    problem = _pack_from_data(data, k, torch.device("cuda", 0))
    calls = []
    cuda_xf.spd_inverse_panels = checked(cuda_xf.spd_inverse_panels, calls)
    options = dict(sphere_history.OPTIONS, maxiterations=iterations, verbose=True)
    res = solverank1sdp(problem=problem, **sphere_history.ROUTES["all"], **options)
    worst = max(calls, key=lambda c: c["relative"])
    print(f"{len(calls)} panel calls over {res.iterations} iterations ({res.status}); the "
          f"largest residual/(cond eps_k) {worst['relative']:.3e} (n={worst['n']}, residual "
          f"{worst['residual']:.3e}, cond_1 {worst['cond']:.3e})", flush=True)
    with open(out, "w") as f:
        json.dump(dict(k=k, status=res.status, iterations=res.iterations, calls=calls,
                       history=res.history), f, indent=1)


if __name__ == "__main__":
    main()
