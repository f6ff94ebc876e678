"""Cold solves of the two-species sphere packing on the card, each with
its per-iteration history.

    python -m clrs_tpu_torch.tools.sphere_history out.json d:k:route [d:k:route ...] [--cache DIR] [--verbose]

d is half the degree (8 is sp16, 15 is sp30), k the limb count, route
"all" (the all-kernels route) or "default".  The problem and the options
are chip_smoke.py's: radii 1 and sqrt(2) - 1, n = 3, built at 53*10 + 150
bits, omega 100, 350 iterations, stall patience 40, the full contract
(gap < 1e-15, errors < 1e-30).  out.json holds, under each "d:k:route",
{"rungs": [{"k", "status", "iterations", "wall_s", "bound", "history"}]},
the layout of chip_smoke.json's solves, so that
``scripts/sphere_host_history.py d k refine out.json d:k:route 0`` holds
a solve against the reference's host path iteration by iteration.

--cache DIR keeps each problem's front end and packing preconditioning
(core/problem.prepare_pack_data, minutes of one core at 2d = 86) in
DIR/sphere_d<d>.pkl: read when the file is there, written when it is not,
so a machine without a card can make it and the card's run skip it
(``python -m clrs_tpu_torch.tools.sphere_history --pack DIR d`` only
writes it).  --verbose prints the solver's table of iterations.
"""
import json
import os
import pickle
import sys
import time

import mpmath
import torch

from clrs_tpu_torch import nsphere_packing_2point, solverank1sdp
from clrs_tpu_torch.core.problem import _pack_from_data, prepare_pack_data

PREC = 53 * 10 + 150
ROUTES = {"all": dict(use_cuda_inverse=True, use_cuda_steplength=True, use_cuda_elemwise=True),
          "default": {}}
OPTIONS = dict(omega_p=100.0, omega_d=100.0, maxiterations=350, stall_patience=40,
               duality_gap_threshold=1e-15, primal_error_threshold=1e-30,
               dual_error_threshold=1e-30, verbose=False)


def pack_data(d, cache=None):
    """The problem's prepare_pack_data at PREC bits, through cache (above)."""
    path = cache and os.path.join(cache, f"sphere_d{d}.pkl")
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    mpmath.mp.prec = PREC
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    cons, b, info = nsphere_packing_2point(3, d, r, 2, prec=PREC, build_only=True)
    data = prepare_pack_data(cons, b, info=info)
    if path:
        os.makedirs(cache, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(data, f)
    return data


def solve(d, k, route, device, cache=None, verbose=False):
    data = pack_data(d, cache)
    mpmath.mp.prec = PREC
    t0 = time.time()
    res = solverank1sdp(problem=_pack_from_data(data, k, device), **ROUTES[route],
                        **dict(OPTIONS, verbose=verbose))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(k=k, status=res.status, iterations=res.iterations, wall_s=time.time() - t0,
                bound=-res.dual_objective, history=res.history)


def main():
    args = sys.argv[1:]
    verbose = "--verbose" in args
    args = [a for a in args if a != "--verbose"]
    cache = None
    for flag in ("--cache", "--pack"):
        if flag in args:
            i = args.index(flag)
            cache, args = args[i + 1], args[:i] + args[i + 2:]
            if flag == "--pack":
                for d in args:
                    pack_data(int(d), cache)
                return
    out, specs = args[0], args[1:]
    device = torch.device("cuda", 0)
    record = {}
    for spec in specs:
        d, k, route = spec.split(":")
        rung = solve(int(d), int(k), route, device, cache, verbose)
        record[spec] = dict(rungs=[rung])
        row = rung["history"][-1]
        print(f"{spec}: {rung['status']} after {rung['iterations']} iterations, "
              f"{rung['wall_s']:.1f} s, bound {rung['bound']!r}; last row gap {row['gap']:.3e} "
              f"P/p/d {row['P_err']:.3e}/{row['p_err']:.3e}/{row['d_err']:.3e}", flush=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
