"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. requires a CUDA device; prints the card's name and power limit;
  2. builds the hand-written kernels (clrs_tpu_torch/csrc, nvcc) and
     prints the build seconds;
  3. runs each kernel (K1 SPD inverse, K2 Schur pairs, K3 matmul) against
     its plain PyTorch version on the card, at the Delsarte config-1
     shapes and at wide shapes: limbs and flags must be bitwise equal;
     prints median times of kernel and plain version;
  4. solves the Delsarte kissing-number bound in dimension 8 at 2d=10 on
     the card with every kernel launch counter reset first; all three
     kernels must have launched, the bound must be 240 to 1e-9, and the
     run must follow the same solve on the CPU, routed through the kernels'
     plain versions (same status, iterations within 2, p_obj/d_obj/gap
     within 1e-10 relative until an error reaches the 1e-20 floor);
  5. solves the dimension-24 bound (2d=20) on the card: 196560 to 1e-3;
  6. prints the kernels' JSON line, then the result line
     {"ok": true, "device": {...}} as the last line.
The full record also goes to chiprun_out/chip_smoke.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import mpmath  # noqa: F401  (the port's front-end needs it; fail loudly here)
import numpy as np
import torch

REPLACES = {
    "spd_inverse_dd": "clrs_tpu/ops/pallas_dd.py:151",
    "schur_pairs_dd": "clrs_tpu/ops/pallas_xf.py:591",
    "matmul_dd": "clrs_tpu/ops/pallas_xf.py:359",
}
SOURCES = {
    "spd_inverse_dd": "clrs_tpu_torch/csrc/spd_inverse_dd.cu",
    "schur_pairs_dd": "clrs_tpu_torch/csrc/schur_pairs.cu",
    "matmul_dd": "clrs_tpu_torch/csrc/matmul_dd.cu",
}


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps: int) -> float:
    """Median wall time of fn on the card, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


def rand_dd(rng, shape, dev):
    hi = rng.standard_normal(shape)
    lo = rng.uniform(-0.5, 0.5, shape) * np.spacing(np.abs(hi))
    return torch.from_numpy(np.stack([hi, lo])).to(dev)


def spd_batch(rng, B, n, cond, dev):
    """(B, 2, n, n) symmetric positive definite dd blocks of condition ~cond."""
    out = np.zeros((B, 2, n, n))
    for b in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
        A = (A + A.T) / 2
        out[b, 0] = A
        out[b, 1] = (rng.uniform(-0.5, 0.5, (n, n)) * np.spacing(np.abs(A)))
        out[b, 1] = (out[b, 1] + out[b, 1].T) / 2
    return torch.from_numpy(out).to(dev)


def check_kernels(dev, record):
    """Phase 3: every kernel bitwise against its plain version."""
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    rng = np.random.default_rng(0)
    rows = []

    def case(name, label, kernel, plain, args, reps, plain_reps, main):
        out_k = kernel(*args)
        out_p = plain(*args)
        torch.cuda.synchronize()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        for x, y in zip(outs_k, outs_p):
            if x.dtype == torch.bool:
                assert torch.equal(x, y), f"{name} {label}: flags differ"
        ok = outs_p[1] if len(outs_p) > 1 else None
        vk, vp = outs_k[0], outs_p[0]
        if ok is not None:  # compare the blocks whose factorization succeeded
            vk, vp = vk[ok], vp[ok]
        err = float(torch.max(torch.abs(vk - vp))) if vk.numel() else 0.0
        assert bits_equal(vk, vp), f"{name} {label}: not bitwise equal (max err {err})"
        ms = median_ms(lambda: kernel(*args), reps)
        plain_ms = median_ms(lambda: plain(*args), plain_reps)
        row = dict(name=name, shape=label, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                   main_path=main)
        if ok is not None:
            row["flags"] = [bool(v) for v in ok.tolist()][:8]
        rows.append(row)
        log(f"kernel {name:15s} {label:32s} bitwise-equal  kernel {ms:10.4f} ms"
            f"  plain {plain_ms:10.3f} ms")

    # K1 at config-1 shapes: S_j (11x11), Q (10x10), ten 1x1 sign blocks
    for label, B, n, cond in (("S_j 1x11x11", 1, 11, 1e8), ("Q 1x10x10", 1, 10, 1e6),
                              ("signs 10x1x1", 10, 1, 1.0)):
        a = spd_batch(rng, B, n, cond, dev)
        case("spd_inverse_dd", label, cuda_dd.dd_spd_inverse,
             cuda_dd.dd_spd_inverse_torch, (a,), 50, 5, True)
    # K1 wide: 256 blocks of 64x64 at cond ~1e10, one of them indefinite
    a = spd_batch(rng, 256, 64, 1e10, dev)
    a[7, 0, 5, 5] = -1e3
    case("spd_inverse_dd", "wide 256x64x64 (1 indefinite)", cuda_dd.dd_spd_inverse,
         cuda_dd.dd_spd_inverse_torch, (a,), 5, 1, False)
    assert rows[-1]["flags"][7] is False, "K1: the indefinite block was not flagged"

    # K2: the main cluster has m=1 (one pair) and T = K*rmax = 11; the ten
    # sign clusters go as one group of G=10 with T=1; wide: P^2=36, T=128
    for label, G, P2, T, main in (("config1 G=1 P2=1 T=11", 1, 1, 11, True),
                                  ("signs G=10 P2=1 T=1", 10, 1, 1, True),
                                  ("wide P2=36 T=128", 1, 36, 128, False)):
        a4 = rand_dd(rng, (G, P2, 4, T, T), dev)
        b4 = rand_dd(rng, (G, P2, 4, T, T), dev)
        hh = rand_dd(rng, (G, T, T), dev)
        case("schur_pairs_dd", label, cuda_xf.schur_pairs, cuda_xf.schur_pairs_torch,
             (a4, b4, hh), 50 if main else 10, 5 if main else 2, main)

    # K3: every product of the config-1 solve (pairings, weighted-A and
    # trace-A of the 6x6 and 5x5 blocks; the sign group batched as B=10)
    # and a wide batch
    for label, (B, n, K, m), main in (("(6,6)x(6,11)", (1, 6, 6, 11), True),
                                      ("(11,6)x(6,11)", (1, 11, 6, 11), True),
                                      ("(6,11)x(11,6)", (1, 6, 11, 6), True),
                                      ("(5,5)x(5,11)", (1, 5, 5, 11), True),
                                      ("(11,5)x(5,11)", (1, 11, 5, 11), True),
                                      ("(5,11)x(11,5)", (1, 5, 11, 5), True),
                                      ("signs 10x(1,1)x(1,1)", (10, 1, 1, 1), True),
                                      ("wide 8x256x256x256", (8, 256, 256, 256), False)):
        a = rand_dd(rng, (B, n, K), dev)
        b = rand_dd(rng, (B, K, m), dev)
        case("matmul_dd", label, cuda_xf.dd_matmul, cuda_xf.dd_matmul_seq_torch,
             (a, b), 50 if main else 5, 5 if main else 1, main)
    record["kernel_checks"] = rows
    return rows


def reset_counters():
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    for fn in (cuda_dd.dd_spd_inverse, cuda_xf.schur_pairs, cuda_xf.dd_matmul):
        fn.launches = 0


def read_counters():
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    return {"spd_inverse_dd": cuda_dd.dd_spd_inverse.launches,
            "schur_pairs_dd": cuda_xf.schur_pairs.launches,
            "matmul_dd": cuda_xf.dd_matmul.launches}


def per_phase_ms(res):
    n = max(res.iterations - 2, 1)  # timings exclude the first 2 iterations
    return {k: 1e3 * v / n for k, v in sorted(res.timings.items())}


def solve_config1(dev, record):
    """Phase 4: Delsarte dim 8, 2d=10 on the card, held against the CPU."""
    from clrs_tpu_torch import delsarte_lp_bound

    kw = dict(omega_p=100.0, omega_d=100.0, verbose=False)
    reset_counters()
    t0 = time.time()
    bound, res = delsarte_lp_bound(8, 5, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counters()
    log(f"config1 gpu: bound {bound!r} status {res.status} iterations "
        f"{res.iterations} wall {wall:.3f} s ({res.iterations / wall:.4f} it/s, "
        f"set-up included)")
    it_s = (res.iterations - 2) / max(sum(res.timings.values()), 1e-12)
    phases = per_phase_ms(res)
    log(f"config1 gpu: steady {it_s:.4f} it/s; ms/iter by phase: "
        + ", ".join(f"{k}={v:.2f}" for k, v in phases.items()))
    log(f"config1 gpu: kernel launches during the solve: {launches}")

    # the same call on the CPU, routed like the card's run (the kernels'
    # plain versions, bit for bit the kernels).  The step length's float64
    # eigenvalues come from each device's own eigensolver and differ in the
    # last bits; once an error reaches the double-double floor (~1e-30) the
    # feasibility tests turn on such bits and the two paths part (a one-ulp
    # change of the eigenvalues on the CPU alone parts them by ~0.08 in gap).
    # So the histories must agree to 1e-10 only before the floor: up to the
    # first iteration where either run has p_err or d_err below 1e-20.
    t0 = time.time()
    bound_cpu, res_cpu = delsarte_lp_bound(8, 5, device="cpu", use_cuda_matmul=True,
                                           **kw)
    wall_cpu = time.time() - t0
    log(f"config1 cpu: bound {bound_cpu!r} status {res_cpu.status} iterations "
        f"{res_cpu.iterations} wall {wall_cpu:.3f} s")
    rel_by_iter = []
    for rg, rc in zip(res.history[:20], res_cpu.history[:20]):
        rel_by_iter.append(max(abs(rg[key] - rc[key]) / max(abs(rc[key]), 1e-300)
                               for key in ("p_obj", "d_obj", "gap")))
    floor_at = next((i for i, (rg, rc) in enumerate(zip(res.history, res_cpu.history))
                     if min(rg["p_err"], rg["d_err"], rc["p_err"], rc["d_err"]) < 1e-20),
                    len(res.history))
    pre_floor = max(rel_by_iter[:floor_at], default=0.0)
    parted = next((i for i, r in enumerate(rel_by_iter) if r > 1e-10), None)
    log(f"config1: relative history difference gpu vs cpu: {max(rel_by_iter)!r} over "
        f"20 iterations, first above 1e-10 at iteration {parted}; {pre_floor!r} over "
        f"the {floor_at} iterations before the 1e-20 error floor")
    record["config1"] = dict(
        bound=bound, status=res.status, iterations=res.iterations, wall_s=wall,
        steady_it_per_s=it_s, phase_ms_per_iter=phases, launches=launches,
        bound_cpu=bound_cpu, status_cpu=res_cpu.status,
        iterations_cpu=res_cpu.iterations, wall_cpu_s=wall_cpu,
        history_rel_diff_by_iter=rel_by_iter, history_parted_at=parted,
        floor_at=floor_at, history_pre_floor_max_rel_diff=pre_floor,
        history=res.history)

    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched during the config-1 solve"
    assert abs(bound - 240.0) < 1e-9, f"config1 bound {bound!r}"
    assert res.status == res_cpu.status, (res.status, res_cpu.status)
    assert abs(res.iterations - res_cpu.iterations) <= 2, \
        (res.iterations, res_cpu.iterations)
    assert len(res.history) >= 20 and len(res_cpu.history) >= 20
    assert floor_at >= 1, "no iteration before the error floor to compare"
    assert pre_floor <= 1e-10, f"gpu and cpu histories differ by {pre_floor!r}"
    return launches


def solve_dim24(dev, record):
    """Phase 5: the dimension-24 kissing bound (Leech lattice) on the card."""
    from clrs_tpu_torch import delsarte_lp_bound

    t0 = time.time()
    bound, res = delsarte_lp_bound(24, 10, omega_p=100.0, omega_d=100.0,
                                   verbose=False, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    it_s = (res.iterations - 2) / max(sum(res.timings.values()), 1e-12)
    log(f"dim24 gpu: bound {bound!r} status {res.status} iterations "
        f"{res.iterations} wall {wall:.3f} s steady {it_s:.4f} it/s")
    record["dim24"] = dict(bound=bound, status=res.status, iterations=res.iterations,
                           wall_s=wall, steady_it_per_s=it_s,
                           phase_ms_per_iter=per_phase_ms(res))
    assert abs(bound - 196560.0) < 1e-3, f"dim24 bound {bound!r}"


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device: this script checks the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda", 0)
    record = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  device=torch.cuda.get_device_name(0))
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {record['device']}")

    from clrs_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    record["build_s"] = time.time() - t0
    log(f"build: {record['build_s']:.2f} s ({_build.library_path().name})")

    rows = check_kernels(dev, record)
    launches = solve_config1(dev, record)
    solve_dim24(dev, record)

    kernels = []
    for name in ("spd_inverse_dd", "schur_pairs_dd", "matmul_dd"):
        main_rows = [r for r in rows if r["name"] == name and r["main_path"]]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["name"] == name),
            ms=main_rows[0]["ms"], plain_ms=main_rows[0]["plain_ms"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(record, kernels=kernels), f, indent=1)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
