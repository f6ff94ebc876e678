"""Run the cluster-sharded steps and solve on N ranks and on one, and
compare them bit for bit.

    python -m clrs_tpu_torch.tools.ranks_vs_one N OUT_DIR [worker options]

Launches N processes of ``tools/mp_hetero_worker.py`` together (ranks
0..N-1 of one group: on the card each on cuda:<rank modulo the number of
cards>, NCCL unless ``--backend`` names another; with ``--device cpu``
gloo on the CPU), then one process alone (world size 1, no group), with
the same worker options (``--what``, ``--d``, ``--k``, ``--steps``,
``--all-kernels``, ``--device``, ``--backend``).  On the card the kernels
are built first, once.  Prints the card's name and power limit (on the
card), each run's seconds, and as its last line one JSON object:
{"world", "device", "backend", "seconds": {"ranks", "one"}, "differing":
{part: [keys]}, "solve": {"status", "iterations", "objectives"},
"ms_per_iteration": {"ranks", "one"}} (the solve's keys with --what
solve; its ms per iteration on the host's clock, the median from the
third iteration on, rank 0's for the ranks); the
keys of "differing" list the leaves whose bits differ between the N ranks
and the one (``mp_hetero_worker.differing``).  Exits 1 if a process fails
or a leaf differs.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from clrs_tpu_torch.tools.mp_hetero_worker import differing

REPO = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _option(opts, name, default):
    return opts[opts.index(name) + 1] if name in opts else default


def run(world, out_dir, opts, timeout=1500, together=False):
    """Launch world ranks, then one (together: the one beside the ranks,
    whose seconds then share the host); return ({"ranks", "one": wall
    seconds}, the one rank's outputs, the ranks' outputs in rank order)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    seconds = {}

    def start(name, n):
        port = _free_port()
        return name, time.time(), [subprocess.Popen(
            [sys.executable, "-m", "clrs_tpu_torch.tools.mp_hetero_worker", str(r), str(n),
             str(port), str(out_dir / f"{name}{r}.npz"), *opts],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
            for r in range(n)]

    def finish(name, t0, procs):
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        seconds[name] = time.time() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0 or f"MPRESULT rank={r} ok" not in log:
                raise RuntimeError(f"{name} rank {r} failed ({p.returncode}):\n{log[-4000:]}")
        return [dict(np.load(out_dir / f"{name}{r}.npz")) for r in range(len(procs))]

    if together:
        launches = [start("ranks", world), start("one", 1)]
        ranks, (one,) = (finish(*launched) for launched in launches)
    else:
        ranks = finish(*start("ranks", world))
        one = finish(*start("one", 1))[0]
    return seconds, one, ranks


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    world, out_dir, opts = int(argv[0]), argv[1], argv[2:]
    device = _option(opts, "--device", "cuda")
    if device != "cpu":
        import torch

        from clrs_tpu_torch.ops import _build

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu to run the ranks on the CPU")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout,
              end="", flush=True)
        _build.build()
    seconds, one, ranks = run(world, out_dir, opts)
    parts = sorted({key.split("/")[0] for key in one} - {"timing"})
    bad = {part: differing(one, ranks, part + "/") for part in parts}
    summary = dict(world=world, device=device,
                   backend=_option(opts, "--backend", "nccl" if device != "cpu" else "gloo"),
                   seconds=seconds, differing=bad)
    if "solve/status" in one:
        summary["solve"] = dict(status=str(one["solve/status"]),
                                iterations=int(one["solve/iterations"]),
                                objectives=[float(v) for v in one["solve/objectives"]])
        # host ms per iteration, median over iterations 3 on (rank 0)
        summary["ms_per_iteration"] = {
            name: float(1e3 * np.median(np.diff(run["timing/solve"])[2:]))
            for name, run in (("ranks", ranks[0]), ("one", one))}
    for part in parts:
        n = sum(key.startswith(part + "/") for key in one)
        print(f"{part}: {n - len(bad[part])} of {n} leaves bit for bit", flush=True)
    print(json.dumps(summary))
    return 1 if any(bad.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
