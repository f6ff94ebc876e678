"""Time the port's kernels and the routes of config 1 in one source tree,
so that two trees can be compared in turns on one card.

    python clrs_tpu_torch/tools/kernel_turns.py TREE LABEL OUT.json [--matmul]

TREE is the root of a checkout: its ``clrs_tpu_torch`` is imported and its
kernels are built under TREE/build.  The inputs and timers are those of
``chip_smoke.py`` in the checkout this script belongs to, whichever TREE
it times.  Comparing two trees means running this script for each in
turns in one call on one card (A, B, B, A) and comparing within the call.
For each kernel case it records the median time of one call between two
CUDA events (the host's call path included, as the solver meets it), the
time per call over a run of back-to-back calls, and the device time per
launch that torch.profiler reports, with the kernel's launches and the
other launches per call (a copy of an operand shows there); K3 (k=2) and
K4 (k=3) at every
main-path shape of ``chip_smoke.MATMUL_SHAPES`` and wide, through their
wrappers, and on the solver's transposed and broadcast operands through
``xf_matmul_k``; K4 at every k = 4..12 on config 1's (6,6)x(6,11) and
(6,11)x(11,6) products.  It also records the SASS of each matmul, Schur
block (K2) and K9 kernel as ``cuobjdump`` reads it from TREE's library:
instructions, FP64 adds, multiplies and FMAs, local-memory loads and
stores, and registers and stack.  Then, unless ``--matmul`` is given (the
matmul cases only): K2 through its call path,
``core.kernels.schur_block_contribution(..., use_cuda=True)`` on the
pairings laid out as compute_pairings returns them, at every
``chip_smoke.SCHUR_SHAPES`` entry at k=2 and 3 (the kernel's device time
per launch, and the other launches of a call: the index copies, gathers
and transposes of a tree that has them); K9 at the config-1 inverse
shapes, wide 256x64x64 (B-major and batch-minor) and on two blocks of 33
and 64 rows; K8;
K1 (k=2) at S_j 11x11, Q 10x10, the signs 10x1x1, wide 256x64x64 and one
block of 257 and of 1024 rows (fewer repetitions); K5
at k=3 and 10; K7 per block size and, as "iteration", the K7 work of one
all-kernels iteration of config 1 (the 6x6 and 5x5 blocks of X and of Y,
each a (k, n, n) tensor as the solver holds them): one launch through
``steplen_sandwich_xf_groups`` where the tree has it, else a launch per
group on the blocks stacked as that tree's solver stacked them; config 1
(Delsarte dim 8, 2d=10) at k=3 on the all-kernels route (a full solve),
on the default route (the first 8 iterations) and at k=2 on the default
route (the first 8 iterations): steady it/s, ms/iter by phase and the
kernels' launches per iteration; and chip_smoke's profile of iterations
3-6 of the all-kernels route (launches per iteration by kernel name, copy
launches in all), without its checks.  Inputs come from fixed seeds, so
every turn sees the same data.  Needs a CUDA card.
"""

import collections
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import chip_smoke as smoke  # noqa: E402

DEV = torch.device("cuda", 0)


def device_ms(fn, kernel, count=20):
    """Device time per launch of the kernels whose name the regular
    expression kernel finds, their launches per call, and the device
    launches of other kernels per call, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in on_card if re.search(kernel, e.name)]
    us = sum(e.time_range.elapsed_us() for e in mine)
    return ((us / 1e3 / len(mine) if mine else None), len(mine) / count,
            (len(on_card) - len(mine)) / count)


# K1's kernel in either tree: its own source's, or the k=2 instance of K5's
K1_KERNEL = r"spd_inverse_dd_kernel|spd_inverse_xf_kernel(<|ILi)2\b"
K5_KERNEL = r"spd_inverse_xf_kernel(<|ILi)([3-9]|1[0-2])\b"


def case(label_tree, rows, kernel, label, fn, reps=50, count=200, profiled=20):
    one = smoke.median_ms(fn, reps)
    many = smoke.many_ms(fn, max(5, min(count, int(20.0 / max(one, 0.05)))))
    dev_ms, launches, other_launches = device_ms(fn, kernel, profiled)
    rows.append(dict(kernel=kernel, case=label, single_ms=one, many_ms=many,
                     device_ms=dev_ms, launches_per_call=launches,
                     other_launches_per_call=other_launches))
    name = {K1_KERNEL: "K1", K5_KERNEL: "K5"}.get(kernel, kernel)
    print(f"{label_tree:8s} {name:22s} {label:34s} single {one:9.4f} ms  "
          f"many {many:9.4f} ms  device {dev_ms if dev_ms is None else round(dev_ms, 5)} ms  "
          f"x {launches:.2f}  other launches/call {other_launches:.2f}", flush=True)


def sass(library, words=("matmul", "schur_pairs", "spd_inverse_dd_wide")):
    """Per kernel function of the library whose name holds one of words:
    SASS instructions by kind (cuobjdump -sass), and registers and stack
    (cuobjdump -res-usage)."""
    from clrs_tpu_torch.ops import _build

    tool = str(pathlib.Path(_build._nvcc()).with_name("cuobjdump"))
    runs = [subprocess.run([tool, flag, str(library)], capture_output=True, text=True)
            for flag in ("-sass", "-res-usage")]
    if any(r.returncode for r in runs):
        return {"cuobjdump failed": [r.stderr[-2000:] for r in runs]}
    out = collections.defaultdict(collections.Counter)
    fn = None
    for line in runs[0].stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(w in m.group(1) for w in words) else None
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and op:
            kind = op.group(1).split(".")[0]
            out[fn]["instructions"] += 1
            if kind in ("DADD", "DMUL", "DFMA", "LDL", "STL"):
                out[fn][kind] += 1
    for line in runs[1].stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
        r = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if fn in out and r:
            out[fn]["registers"], out[fn]["stack"] = int(r.group(1)), int(r.group(2))
    return {f: dict(c) for f, c in sorted(out.items())}


def kernels(label_tree, matmul_only=False):
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf
    from clrs_tpu_torch.ops.xfloat import XF, elemwise_cuda, xf_add, xf_mul

    rng = np.random.default_rng(0)
    rows = []

    def add(*args, **kwargs):
        case(label_tree, rows, *args, **kwargs)

    # "matmul_" names K3's and K4's kernels in either tree
    for k, kern, wide in ((2, cuda_xf.dd_matmul, ("wide 8x256x256x256", (8, 256, 256, 256))),
                          (3, cuda_xf.matmul_xf, ("wide (1024,64)x(64,1024)", (1, 1024, 64, 1024)))):
        for label, (B, n, K, m) in smoke.MATMUL_SHAPES + (wide,):
            a, b = smoke.rand_xf(rng, (B, n, K), k, DEV), smoke.rand_xf(rng, (B, K, m), k, DEV)
            reps, count = (10, 20) if label.startswith("wide") else (50, 200)
            add("matmul_", f"wrapper k={k} {label}", lambda kern=kern, a=a, b=b: kern(a, b),
                reps=reps, count=count)
        for label, (a, b), _ in smoke.in_place_operands(rng, k, DEV):
            add("matmul_", f"xf_matmul_k k={k} {label}",
                lambda a=XF(a), b=XF(b): cuda_xf.xf_matmul_k(a, b))
    for k in range(4, 13):
        for label, (B, n, K, m) in smoke.MATMUL_SHAPES[:3:2]:
            a, b = smoke.rand_xf(rng, (B, n, K), k, DEV), smoke.rand_xf(rng, (B, K, m), k, DEV)
            add("matmul_", f"wrapper k={k} {label}", lambda a=a, b=b: cuda_xf.matmul_xf(a, b))
    if matmul_only:
        return rows

    from clrs_tpu_torch.core import kernels as core_kernels

    for k in (2, 3):
        for label, (G, m, K, rmax) in smoke.SCHUR_SHAPES:
            px, py, _ = smoke.schur_operands(rng, k, G, m, K, rmax, DEV)
            PX, PY = XF(px), XF(py)
            H = XF(smoke.rand_xf(rng, (G, K * rmax), k, DEV))
            add("schur_pairs_kernel", f"call path k={k} {label}",
                lambda PX=PX, PY=PY, H=H, m=m, K=K, rmax=rmax:
                core_kernels.schur_block_contribution(PX, PY, H, m, K, rmax, use_cuda=True))
    for label, (B, n, cond) in smoke.INVERSE_SHAPES[::2] + (("wide 256x64x64", (256, 64, 1e10)),
                                                           ("2x33x33", (2, 33, 1e6)),
                                                           ("2x64x64", (2, 64, 1e6))):
        a = smoke.spd_batch(rng, B, n, 2, cond, DEV)
        layouts = (("", a),) + ((" batch-minor", a.permute(1, 2, 3, 0).contiguous()
                                 .permute(3, 0, 1, 2)),) * (B == 256)
        for tag, x in layouts:
            add("spd_inverse_dd_wide_kernel", f"K9 k=2 {label}{tag}",
                lambda x=x: cuda_dd.dd_spd_inverse_wide(x), reps=5 if B == 256 else 20,
                count=10 if B == 256 else 50)

    for k, ops in ((3, ("add", "mul")), (10, ("mul",))):
        for shape in ((), (11,), (6, 6), (11, 11)):
            a = smoke.rand_xf(rng, shape, k, DEV).reshape(k, -1)
            b = smoke.rand_xf(rng, shape, k, DEV).reshape(k, -1)
            for op in ops:
                add("elemwise_xf_kernel", f"wrapper k={k} {op} {shape}",
                    lambda op=op, a=a, b=b: cuda_xf.elemwise_xf(op, a, b))
    for sa, sb in (((6, 6), (6, 6)), ((10, 1, 1), (10, 11, 11)), ((), (11,)), ((6, 1), (1, 6))):
        a, b = XF(smoke.rand_xf(rng, sa, 3, DEV)), XF(smoke.rand_xf(rng, sb, 3, DEV))
        for op, fn in (("add", xf_add), ("mul", xf_mul)):
            def call(fn=fn, a=a, b=b):
                with elemwise_cuda():
                    fn(a, b)
            add("elemwise_xf_kernel", f"xfloat k=3 {op} {sa}x{sb}", call)
    for k, op in ((3, "add"), (12, "mul")):
        a, b = smoke.rand_xf(rng, (1 << 20,), k, DEV), smoke.rand_xf(rng, (1 << 20,), k, DEV)
        add("elemwise_xf_kernel", f"wrapper k={k} {op} wide 2^20",
            lambda op=op, a=a, b=b: cuda_xf.elemwise_xf(op, a, b), reps=10, count=20)
    for label, (B, n, cond) in smoke.INVERSE_SHAPES + (("wide 256x64x64", (256, 64, 1e10)),):
        a = smoke.spd_batch(rng, B, n, 2, cond, DEV)
        wide = label.startswith("wide")
        add(K1_KERNEL, f"k=2 {label}", lambda a=a: cuda_dd.dd_spd_inverse(a),
            reps=5 if wide else 20, count=10 if wide else 50)
    for n in (257, 1024):  # one block above the 256 threads of a K1 block
        a = smoke.spd_batch(rng, 1, n, 2, 1e4, DEV)
        add(K1_KERNEL, f"k=2 1x{n}x{n}", lambda a=a: cuda_dd.dd_spd_inverse(a), reps=1,
            count=1, profiled=1)
    for k, B, n, cond, label in ((3, 1, 11, 1e8, "S_j 1x11x11"), (3, 1, 10, 1e6, "Q 1x10x10"),
                                 (10, 1, 11, 1e8, "S_j 1x11x11"),
                                 (3, 64, 32, 1e10, "wide 64x32x32")):
        a = smoke.spd_batch(rng, B, n, k, cond, DEV)
        add(K5_KERNEL, f"k={k} {label}",
            lambda a=a: cuda_xf.spd_inverse_xf(a), reps=20, count=50)
    for k, B, n, label in ((3, 1, 6, "1x6x6"), (3, 1, 5, "1x5x5"), (10, 1, 6, "1x6x6"),
                           (3, 64, 32, "wide 64x32x32")):
        m = smoke.spd_batch(rng, B, n, k, 1e6, DEV)
        d = smoke.rand_xf(rng, (B, n, n), k, DEV).transpose(0, 1)
        d = ((d + d.transpose(-1, -2)) / 2).contiguous()
        add("steplen_xf_kernel", f"k={k} {label}",
            lambda m=m, d=d: cuda_xf.steplen_sandwich_xf(m, d), reps=20, count=50)
    for k in (3, 10):
        blocks = []  # X's and Y's 6x6 and 5x5 blocks, (k, n, n) each
        for n in (6, 5, 6, 5):
            d = smoke.rand_xf(rng, (n, n), k, DEV)
            blocks.append((smoke.spd_batch(rng, 1, n, k, 1e6, DEV)[0],
                           (d + d.transpose(-1, -2)) / 2))
        if hasattr(cuda_xf, "steplen_sandwich_xf_groups"):
            def iteration(blocks=blocks):
                cuda_xf.steplen_sandwich_xf_groups([([m], [d]) for m, d in blocks])
        else:  # a launch per group, the blocks stacked as that tree's solver stacked them
            def iteration(blocks=blocks):
                for m, d in blocks:
                    cuda_xf.steplen_sandwich_xf(torch.stack([m], dim=1).transpose(0, 1),
                                                torch.stack([d], dim=1).transpose(0, 1))
        add("steplen_xf_kernel", f"k={k} iteration X, Y x (6x6, 5x5)", iteration,
            reps=20, count=50)
    return rows


def route(label_tree, name, k=3, **kwargs):
    from clrs_tpu_torch import delsarte_lp_bound
    from clrs_tpu_torch.ops import cuda_dd, cuda_xf

    counted = (cuda_xf.elemwise_xf, cuda_xf.spd_inverse_xf, cuda_xf.steplen_sandwich_xf,
               cuda_xf.matmul_xf, cuda_dd.dd_spd_inverse, cuda_xf.dd_matmul,
               cuda_xf.schur_pairs)
    for fn in counted:
        fn.launches = 0
    t0 = time.time()
    bound, res = delsarte_lp_bound(8, 5, precision_k=k, device=DEV, omega_p=100.0,
                                   omega_d=100.0, verbose=False, **kwargs)
    torch.cuda.synchronize()
    steady = (res.iterations - 2) / max(sum(res.timings.values()), 1e-12)
    n = max(res.iterations - 2, 1)
    out = dict(route=name, bound=bound, status=res.status, iterations=res.iterations,
               wall_s=time.time() - t0, steady_it_per_s=steady,
               phase_ms_per_iter={p: 1e3 * v / n for p, v in sorted(res.timings.items())},
               launches_per_iter={f.__name__: f.launches / res.iterations for f in counted})
    print(f"{label_tree:8s} route {name}: {res.status} {bound!r} in {res.iterations} "
          f"iterations, steady {steady:.4f} it/s; ms/iter "
          + ", ".join(f"{p}={v:.2f}" for p, v in out["phase_ms_per_iter"].items())
          + f"; launches/iter {out['launches_per_iter']}", flush=True)
    return out


def main():
    tree, label, out = sys.argv[1:4]
    matmul_only = sys.argv[4:] == ["--matmul"]
    if not torch.cuda.is_available():
        sys.exit("kernel_turns: no CUDA device")
    sys.path.insert(0, tree)  # before this checkout: TREE's clrs_tpu_torch is the one timed
    from clrs_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    result = dict(tree=tree, label=label, device=torch.cuda.get_device_name(0),
                  build_s=time.time() - t0, sass=sass(_build.library_path()))
    for fn, c in result["sass"].items():
        print(f"{label:8s} sass {fn}: {c}", flush=True)
    result["kernels"] = kernels(label, matmul_only)
    if not matmul_only:
        result["routes"] = [route(label, "all-kernels", **smoke.ALL_KERNELS_ROUTE),
                            route(label, "default (8 iterations)", maxiterations=8),
                            route(label, "k=2 default (8 iterations)", k=2, maxiterations=8)]
        result["profile"] = smoke.profile_all_kernels(
            DEV, {}, result["routes"][0]["steady_it_per_s"], check=False)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
