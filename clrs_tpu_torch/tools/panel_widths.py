"""Time K5's panel route (ops/cuda_xf.spd_inverse_panels) on the card at
panel widths 8, 16 and 32, beside the single launch where it applies, find
where the two routes cross, and check the panel route at k=2 above K1's
1024 rows.

    python -m clrs_tpu_torch.tools.panel_widths out.json [widths] [crossover] [k2]

Prints the card's name and power limit, then each part asked for (all
three when none is named): "widths", for each (k, n) of SHAPES the median
of 3 one-call times (CUDA events, host call path included) at each width
(cuda_xf.SPD_PANEL set for the call, cuda_dd.max_rows lowered so that the
panel route takes n), and at n <= 256 the single launch's; "crossover",
for each k of CROSSOVER the single launch's time and the panel route's at
SPD_PANEL rows a panel, at each n, and whether the two agree to the k-limb
ulp; "k2", the panel route at k=2 on 1030 rows bitwise against its plain
version on the CPU.  out.json keeps the numbers.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from clrs_tpu_torch.ops import _build, cuda_dd, cuda_xf

WIDTHS = (8, 16, 32)
SHAPES = ((3, 256), (3, 261), (3, 512), (3, 1024), (6, 261), (10, 262))
CROSSOVER = {3: (16, 32, 48, 64, 96, 128, 192, 256), 6: (16, 32, 64, 128, 256),
             10: (16, 32, 64, 128, 256)}


def spd(rng, n, k, cond=1e6):
    """(k, 1, n, n): one SPD block of condition ~cond, two nonzero limbs."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
    out = np.zeros((k, 1, n, n))
    out[0, 0] = (A + A.T) / 2
    lo = rng.uniform(-0.5, 0.5, (n, n)) * np.spacing(np.abs(out[0, 0]))
    out[1, 0] = (lo + lo.T) / 2
    return torch.from_numpy(out)


def ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def panel_ms(x, width):
    """One call of the panel route on x at the given width."""
    old_width, old_rows = cuda_xf.SPD_PANEL, cuda_dd.max_rows
    cuda_xf.SPD_PANEL, cuda_dd.max_rows = width, (lambda k: 1)
    try:
        return ms(lambda: cuda_xf.xf_spd_inverse_batched(x))
    finally:
        cuda_xf.SPD_PANEL, cuda_dd.max_rows = old_width, old_rows


def crossover(dev, record):
    """The single launch against the panel route at each (k, n) of
    CROSSOVER on the same input: both times, their ratio, and the largest
    limb-summed difference relative to the largest entry."""
    rng = np.random.default_rng(5001)
    out = record["crossover"] = {}
    for k, sizes in CROSSOVER.items():
        for n in sizes:
            x = spd(rng, n, k).to(dev)
            single_ms = ms(lambda: cuda_xf.xf_spd_inverse_batched(x))
            single, _ = cuda_xf.xf_spd_inverse_batched(x)
            panel = panel_ms(x, cuda_xf.SPD_PANEL)
            old = cuda_dd.max_rows
            cuda_dd.max_rows = lambda k: 1
            try:
                got, ok = cuda_xf.xf_spd_inverse_batched(x)
            finally:
                cuda_dd.max_rows = old
            rel = float(torch.max(torch.abs(torch.sum(got - single, dim=0)))
                        / torch.max(torch.abs(single[0])))
            out[f"k={k} n={n}"] = dict(single_ms=single_ms, panel_ms=panel, rel_diff=rel,
                                       ok=bool(ok.all()))
            print(f"crossover k={k} n={n}: single launch {single_ms:.4f} ms, panel route "
                  f"{panel:.4f} ms ({single_ms / panel:.2f}x); agree to {rel:.3e} relative",
                  flush=True)


def main():
    out_path, parts = sys.argv[1], set(sys.argv[2:]) or {"widths", "crossover", "k2"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5000)
    record = dict(nvidia_smi=smi, widths={}, single={})
    if "crossover" in parts:
        crossover(dev, record)
    for k, n in SHAPES if "widths" in parts else ():
        x = spd(rng, n, k).to(dev)
        row = {w: panel_ms(x, w) for w in WIDTHS}
        record["widths"][f"k={k} n={n}"] = row
        single = None
        if n <= cuda_dd.max_rows(k):
            single = record["single"][f"k={k} n={n}"] = ms(lambda: cuda_xf.xf_spd_inverse_batched(x))
        print(f"k={k} n={n}: panel route ms by width {row}; single launch "
              f"{'-' if single is None else f'{single:.3f} ms'}", flush=True)
    if "k2" not in parts:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
        return
    n = 1030
    x = spd(rng, n, 2)
    t0 = time.time()
    want, ok_want = cuda_xf.xf_spd_inverse_batched(x)
    plain_s = time.time() - t0
    xg = x.to(dev)
    got, ok = cuda_xf.xf_spd_inverse_batched(xg)
    same = bool(torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))) and \
        ok.tolist() == ok_want.tolist()
    k2_ms = ms(lambda: cuda_xf.xf_spd_inverse_batched(xg))
    record["k2_n1030"] = dict(bitwise=same, ms=k2_ms, plain_s=plain_s)
    print(f"k=2 n={n}: panel route bitwise its plain version {same}; {k2_ms:.3f} ms "
          f"(plain on the CPU {plain_s:.1f} s)", flush=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    if not same:
        sys.exit("k=2 n=1030: the panel route differs from its plain version")


if __name__ == "__main__":
    main()
