"""Witness for sp86's split between the card and the CPU at k=3: does the
port on the CPU follow the card once it takes the card's step lengths?

    python scripts/sp86_step_witness.py chip_smoke.json out.json [iterations]

chip_smoke.json is a chip_smoke.py record (phase 14's "sp86" history,
with each iteration's alpha_p and alpha_d as the card computed them).  The
script packs sp86 as chip_smoke.py phase 14 does (k=3, built at its
SP86_PREC bits) and runs the port on the CPU, on the all-kernels route's
plain versions, for ``iterations`` (default 3) twice, in two processes:
as it is, and with each iteration's step lengths replaced by the card's
(solver._alpha returning them in the order the solver asks: alpha_p,
then alpha_d).  It prints, for each run and iteration, the largest
relative difference of p_obj, d_obj and gap from the card's row, and
writes both histories to out.json.  The card's step lengths are the
values after the solver's primal-dual minimum, so a substituted run is
the card's only while neither side is feasible (P and d errors above
their thresholds), as in sp86's first iterations.
"""
import json
import os
import sys
import time
from multiprocessing import get_context

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

KEYS = ("p_obj", "d_obj", "gap")


def run(data, iterations, alphas):
    """The CPU run, with alphas (a list of (alpha_p, alpha_d)) substituted
    when given: (history, wall seconds)."""
    from clrs_tpu_torch import solverank1sdp
    from clrs_tpu_torch.core import solver

    torch.set_num_threads(2)
    if alphas is not None:
        values = iter([a for pair in alphas for a in pair])
        solver._alpha = lambda lam, gamma: torch.tensor(next(values), dtype=torch.float64,
                                                        device=lam.device)
    t0 = time.time()
    res = solverank1sdp(problem=chip_smoke.sp86_packed(data, "cpu"), verbose=False,
                        use_cuda_matmul=True, **chip_smoke.ALL_KERNELS_ROUTE,
                        **dict(chip_smoke.LADDER_SOLVE, maxiterations=iterations))
    return res.history, time.time() - t0


def main():
    card_path, out_path = sys.argv[1], sys.argv[2]
    iterations = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    card = json.load(open(card_path))["sp86"]["history"][:iterations]
    assert len(card) == iterations, f"the card's record holds {len(card)} iterations"
    t0 = time.time()
    packed = chip_smoke.sp86_pack_data()
    print(f"sp86 packed at {chip_smoke.SP86_PREC} bits in {time.time() - t0:.1f} s", flush=True)
    alphas = [(row["alpha_p"], row["alpha_d"]) for row in card]
    with get_context("spawn").Pool(2) as pool:
        jobs = {name: pool.apply_async(run, (packed["data"], iterations, a))
                for name, a in (("cpu", None), ("cpu with the card's alphas", alphas))}
        out = {name: job.get() for name, job in jobs.items()}
    record = dict(card=card)
    for name, (history, wall) in out.items():
        rel = [max(abs(rc[key] - rg[key]) / max(abs(rg[key]), 1e-300) for key in KEYS)
               for rc, rg in zip(history, card)]
        record[name] = dict(history=history, wall_s=wall, rel_diff_from_card=rel)
        print(f"{name} ({wall:.1f} s): relative difference from the card by iteration "
              + ", ".join(f"{r!r}" for r in rel), flush=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
