"""Witness for the sp30 k=6 floor: the port's iterate near iteration 68 of
the two-species sphere packing at 2d=30, cold at k=6, continued in
several solvers, iteration by iteration.

The packing and the options are chip_smoke.py's (radii 1 and sqrt(2) - 1,
n = 3, built at 53*10 + 150 bits, omega 100, stall patience 40, the full
contract).  Three steps:

1. On the card (PyTorch port only):

       python scripts/sp30_device_path_witness.py card out.json state.npz [start] [steps]

   solves cold at k=6 on the all-kernels route for ``start`` iterations
   (default 68), saves the iterate with utils/checkpoint.save_state (the
   reference's .npz layout, user coordinates), then continues from the
   saved file for ``steps`` iterations (default 15) on the same route
   through the phase driver and through the device loop (chunk=1), and
   writes every history to out.json.

2. On the CPU (the JAX reference; no card):

       python scripts/sp30_device_path_witness.py reference out.json state.npz card.json [steps] [which]

   continues the same file for ``steps`` iterations at k=6 in the
   reference's phase-split driver (clrs_tpu.core.solver.solverank1sdp,
   XLA on the CPU at backend optimization level 0, every Pallas route off:
   S_j^-1 and Q^-1 materialized, the path the port mirrors) and in its host
   path (factor-and-substitute Schur solves); ``which`` picks "phase",
   "host" or "both" (default), or "phase_eager": the phase-split driver
   under jax.disable_jit(), op by op (no compile, and no multiply-add
   contracted across operations, so it follows the port's step 3 bit for
   bit where the operations agree), for a few iterations.  Prints the d-error, p-error and gap of
   every solver side by side, with the card's runs from card.json, and
   writes them to out.json.  Each reference run is written as soon as it
   ends.

3. On the CPU, the port on the reference's operation order (no jax):

       python scripts/sp30_device_path_witness.py cpu out.json state.npz card.json [steps]

   continues the same file for ``steps`` iterations in the port's phase
   driver on the CPU with ``use_cuda_matmul=False`` and no other route:
   S_j^-1 and Q^-1 materialized by the reference's Cholesky inverse, every
   operation in the reference's order (the tests hold it to the reference
   limb for limb where XLA does not contract multiply-adds), and prints it
   beside the card's runs.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mpmath  # noqa: E402

PREC = 53 * 10 + 150
D, K = 15, 6
OPTIONS = dict(omega_p=100.0, omega_d=100.0, stall_patience=40,
               duality_gap_threshold=1e-15, primal_error_threshold=1e-30,
               dual_error_threshold=1e-30, verbose=False)
ROUTE = dict(use_cuda_inverse=True, use_cuda_steplength=True, use_cuda_elemwise=True)
KEYS = ("gap", "P_err", "p_err", "d_err", "mu", "p_obj", "d_obj")


def rows(history):
    return [{key: float(row.get(key, "nan")) for key in ("iter",) + KEYS} for row in history]


def card(out, state_path, start=68, steps=15):
    import torch

    from clrs_tpu_torch import load_state, nsphere_packing_2point, save_state, solverank1sdp
    from clrs_tpu_torch.core.device_loop import solve_on_device
    from clrs_tpu_torch.core.problem import pack_constraints

    dev = torch.device("cuda", 0)
    mpmath.mp.prec = PREC
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    cons, b, info = nsphere_packing_2point(3, D, r, 2, prec=PREC, build_only=True)
    record = {}
    t0 = time.time()
    res = solverank1sdp(cons, b, info, device=dev, precision_k=K, maxiterations=start,
                        **ROUTE, **OPTIONS)
    torch.cuda.synchronize()
    record["cold"] = dict(status=res.status, iterations=res.iterations,
                          wall_s=time.time() - t0, history=rows(res.history))
    save_state(state_path, (res.x, res.y, res.X, res.Y), info,
               meta=dict(iterations=res.iterations, d=D))
    print(f"cold k={K}: {res.status} after {res.iterations} iterations, "
          f"{record['cold']['wall_s']:.1f} s; saved {state_path}", flush=True)
    state, _ = load_state(state_path, info, device=dev)
    t0 = time.time()
    res = solverank1sdp(cons, b, info, device=dev, precision_k=K, maxiterations=steps,
                        initial_solutions=state, **ROUTE, **OPTIONS)
    torch.cuda.synchronize()
    record["port_phase"] = dict(status=res.status, iterations=res.iterations,
                                wall_s=time.time() - t0, history=rows(res.history))
    problem = pack_constraints(cons, b, info=info, k=K, device=dev)
    t0 = time.time()
    res = solve_on_device(problem, initial_solutions=state, chunk=1, maxiterations=steps,
                          **ROUTE, **OPTIONS)
    record["port_device_loop"] = dict(status=res.status, iterations=res.iterations,
                                      wall_s=time.time() - t0, history=rows(res.history))
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    show(record, start)


def reference(out, state_path, card_json, steps, which):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0"
                               " --xla_cpu_use_fusion_emitters=false").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from clrs_tpu.apps.sphere_packing import nsphere_packing_2point
    from clrs_tpu.core.host_solver import solverank1sdp_host
    from clrs_tpu.core.solver import solverank1sdp
    from clrs_tpu.utils.checkpoint import load_state

    with open(card_json) as f:
        record = json.load(f)
    mpmath.mp.prec = PREC
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    cons, b, info = nsphere_packing_2point(3, D, r, 2, prec=PREC, build_only=True)
    state, meta = load_state(state_path, info)
    runs = []
    if which in ("phase", "both"):
        runs.append(("reference_phase", lambda: solverank1sdp(
            cons, b, info, precision_k=K, maxiterations=steps, initial_solutions=state,
            use_pallas_matmul=False, use_pallas_inverse=False, use_pallas_steplength=False,
            **OPTIONS)))
    if which == "phase_eager":  # the same driver op by op: no compile, no contraction
        def eager():
            with jax.disable_jit():
                return solverank1sdp(
                    cons, b, info, precision_k=K, maxiterations=steps,
                    initial_solutions=state, use_pallas_matmul=False,
                    use_pallas_inverse=False, use_pallas_steplength=False,
                    **dict(OPTIONS, verbose=True))

        runs.append(("reference_phase_eager", eager))
    if which in ("host", "both"):
        runs.append(("reference_host", lambda: solverank1sdp_host(
            cons, b, info, precision_k=K, maxiterations=steps, initial_solutions=state,
            **OPTIONS)))
    for name, run in runs:
        t0 = time.time()
        res = run()
        record[name] = dict(status=res.status, iterations=res.iterations,
                            wall_s=time.time() - t0, history=rows(res.history))
        print(f"{name}: {res.status} after {res.iterations} iterations, "
              f"{record[name]['wall_s']:.1f} s", flush=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    show(record, meta["iterations"])


def port_cpu(out, state_path, card_json, steps):
    from clrs_tpu_torch import load_state, nsphere_packing_2point, solverank1sdp

    with open(card_json) as f:
        record = json.load(f)
    mpmath.mp.prec = PREC
    r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
    cons, b, info = nsphere_packing_2point(3, D, r, 2, prec=PREC, build_only=True)
    state, meta = load_state(state_path, info, device="cpu")
    t0 = time.time()
    res = solverank1sdp(cons, b, info, device="cpu", precision_k=K, maxiterations=steps,
                        initial_solutions=state, use_cuda_matmul=False, **OPTIONS)
    record["port_cpu_reference_order"] = dict(status=res.status, iterations=res.iterations,
                                              wall_s=time.time() - t0,
                                              history=rows(res.history))
    print(f"port on the CPU, the reference's order: {res.status} after {res.iterations} "
          f"iterations, {record['port_cpu_reference_order']['wall_s']:.1f} s", flush=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    show(record, meta["iterations"])


def show(record, start):
    names = [n for n in ("port_phase", "port_device_loop", "port_cpu_reference_order",
                         "reference_phase", "reference_phase_eager", "reference_host")
             if n in record]
    print("iter | " + " | ".join(f"{n:>32}" for n in names))
    print("     | " + " | ".join(f"{'d_err':>10} {'p_err':>10} {'gap':>10}" for _ in names))
    for i in range(max(len(record[n]["history"]) for n in names)):
        cells = []
        for n in names:
            h = record[n]["history"]
            cells.append(f"{h[i]['d_err']:10.3e} {h[i]['p_err']:10.3e} {h[i]['gap']:10.3e}"
                         if i < len(h) else " " * 32)
        print(f"{start + i + 1:4d} | " + " | ".join(cells))


def main():
    mode, out, state_path = sys.argv[1:4]
    if mode == "card":
        card(out, state_path, *(int(a) for a in sys.argv[4:6]))
    elif mode == "cpu":
        port_cpu(out, state_path, sys.argv[4], int(sys.argv[5]) if len(sys.argv) > 5 else 15)
    else:
        steps = int(sys.argv[5]) if len(sys.argv) > 5 else 15
        which = sys.argv[6] if len(sys.argv) > 6 else "both"
        reference(out, state_path, sys.argv[4], steps, which)


if __name__ == "__main__":
    main()
