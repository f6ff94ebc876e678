"""The reference's host path on the two-species sphere packing at 2d, with
its per-iteration history, held against a run of the PyTorch port.

The packing is the one chip_smoke.py solves (radii 1 and sqrt(2) - 1,
n = 3, built at 53*10 + 150 bits), with chip_smoke's options: omega 100,
350 iterations, stall patience 40, the full contract.  The host path runs
at k limbs with refine_steps iterative-refinement steps of its
factor-and-substitute Schur solves.  Given a chip_smoke.json record, the
script prints, iteration by iteration, the relative difference of mu and
of both objectives between the two runs, both sides' errors, and the
iteration where the runs part (a relative difference above 1e-6) and
where each one's dual error is least.

Usage:
    python scripts/sphere_host_history.py d k refine_steps \\
        [record.json record_key rung_index] [out.json]

e.g. ``python scripts/sphere_host_history.py 15 6 0 chiprun_out/chip_smoke.json
sp30 0`` (about a minute on a CPU core).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mpmath  # noqa: E402

from clrs_tpu.apps.sphere_packing import nsphere_packing_2point  # noqa: E402

PREC = 53 * 10 + 150
KEYS = ("mu", "p_obj", "d_obj")


def run(d, k, refine):
    mpmath.mp.prec = PREC
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    t0 = time.time()
    bound, res = nsphere_packing_2point(
        3, d, r, 2, prec=PREC, backend="host", precision_k=k, refine_steps=refine,
        omega=100.0, maxiterations=350, stall_patience=40,
        duality_gap_threshold=1e-15, primal_error_threshold=1e-30,
        dual_error_threshold=1e-30, verbose=False)
    hist = [{key: float(v) for key, v in row.items()} for row in res.history]
    return dict(d=d, k=k, refine_steps=refine, bound=float(bound), status=res.status,
                iterations=res.iterations, wall_s=time.time() - t0, history=hist)


def compare(ref, port):
    """Prints both histories side by side; returns (first parting
    iteration, the reference's and the port's least-d_err iterations)."""
    parted = None
    print(f"{'iter':>4} {'rel mu':>9} {'rel p_obj':>9} {'rel d_obj':>9} | host p/d err"
          f"{'':>12} | port p/d err")
    for rr, rp in zip(ref, port):
        rel = [abs(rr[key] - rp[key]) / max(abs(rr[key]), 1e-300) for key in KEYS]
        if parted is None and max(rel) > 1e-6:
            parted = int(rr["iter"])
        print(f"{int(rr['iter']):4d} {rel[0]:9.2e} {rel[1]:9.2e} {rel[2]:9.2e} | "
              f"{rr['p_err']:9.2e} {rr['d_err']:9.2e} gap {rr['gap']:9.2e} | "
              f"{rp['p_err']:9.2e} {rp['d_err']:9.2e} gap {rp['gap']:9.2e}")
    least = [int(min(h, key=lambda row: row["d_err"])["iter"]) for h in (ref, port)]
    return parted, least[0], least[1]


def main():
    d, k, refine = (int(a) for a in sys.argv[1:4])
    out = run(d, k, refine)
    print(f"host path 2d={2 * d} k={k} refine_steps={refine}: {out['status']} after "
          f"{out['iterations']} iterations, bound {out['bound']!r}, {out['wall_s']:.1f} s; "
          f"last row {out['history'][-1]}")
    if len(sys.argv) >= 7:
        with open(sys.argv[4]) as f:
            rung = json.load(f)[sys.argv[5]]["rungs"][int(sys.argv[6])]
        print(f"port: k={rung['k']} {rung['status']} after {rung['iterations']} iterations")
        parted, least_ref, least_port = compare(out["history"], rung["history"])
        out.update(parted_at=parted, least_d_err_iter_host=least_ref,
                   least_d_err_iter_port=least_port)
        print(f"parted at iteration {parted}; least d_err at iteration {least_ref} (host), "
              f"{least_port} (port)")
    if len(sys.argv) in (5, 8):
        with open(sys.argv[-1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
