"""Recompute the SPD-inverse and step-length bounds of PERF.md §6 from
``clrs_tpu_torch/utils/flops.py``, and each one's share against the time
recorded for it on the card.

    python -m clrs_tpu_torch.tools.bound_shares

Needs no card: the times are the ones PERF.md §6 records beside each
shape (NVIDIA H100 80GB HBM3, 700.00 W; the run that took each is named
there), here with the kind of time (one call, back to back, device), the
bounds are the function's own work (``spd_inverse_function_work``,
``steplen_function_work``).  Prints one line a shape: kernel, shape, the
bound in ms and what bounds it, the time and its kind, and the share of
the bound that the time reaches; then, for the shapes that the kernels'
own operation counts were pinned at before those counts went, the ratio
of that count's bound to the function's.
"""

from clrs_tpu_torch.utils.flops import bound, spd_inverse_function_work, steplen_function_work

# (n, count) per side of one step-length launch (chip_smoke.SP_STEPLEN_BLOCKS)
SIDES = {"config1": ((6, 1), (5, 1)),
         "sp16": ((9, 3), (8, 3), (2, 1), (18, 1), (16, 1)),
         "sp30": ((16, 3), (15, 3), (2, 1), (32, 1), (30, 1))}


def inverse(k, B, n):
    return [spd_inverse_function_work(k, B, n)]


def iteration(k, problem):
    """Both sides' blocks of one iteration's K7 launch."""
    return [steplen_function_work(k, count, n) for _ in range(2) for n, count in SIDES[problem]]


# (kernel, shape, works, ms, the kind of time)
ROWS = [
    ("K1", "k=2 S_j 1x11x11", inverse(2, 1, 11), 0.0562, "back to back"),
    ("K1", "k=2 wide 256x64x64", inverse(2, 256, 64), 2.957, "back to back"),
    ("K1", "k=2 1x1024", inverse(2, 1, 1024), 3142.0, "one call"),
    ("K1", "k=2 sp16 S_j 1x51x51", inverse(2, 1, 51), 0.947, "back to back"),
    ("K5", "k=3 S_j 1x11x11", inverse(3, 1, 11), 0.1069, "back to back"),
    ("K5", "k=3 wide 64x32x32", inverse(3, 64, 32), 0.5714, "back to back"),
    ("K5", "k=6 1x51x51", inverse(6, 1, 51), 6.182, "back to back"),
    ("K5", "k=6 1x93x93", inverse(6, 1, 93), 23.56, "back to back"),
    ("K5", "k=10 1x51x51", inverse(10, 1, 51), 25.07, "back to back"),
    ("K5", "k=10 1x93x93", inverse(10, 1, 93), 86.67, "back to back"),
    ("K5 panel", "k=3 1x257", inverse(3, 1, 257), 2.797, "one call"),
    ("K5 panel", "k=3 1x261", inverse(3, 1, 261), 2.921, "one call"),
    ("K5 panel", "k=3 1x512", inverse(3, 1, 512), 6.782, "one call"),
    ("K5 panel", "k=3 1x1024", inverse(3, 1, 1024), 25.25, "one call"),
    ("K5 panel", "k=6 1x261", inverse(6, 1, 261), 16.06, "one call"),
    ("K5 panel", "k=10 1x262", inverse(10, 1, 262), 72.99, "one call"),
    ("K7", "k=3 config-1 iteration", iteration(3, "config1"), 0.2051, "back to back"),
    ("K7", "k=3 1x6x6", [steplen_function_work(3, 1, 6)], 0.0594, "device"),
    ("K7", "k=3 wide 64x32x32", [steplen_function_work(3, 64, 32)], 0.7257, "back to back"),
    ("K7", "k=6 sp16 iteration", iteration(6, "sp16"), 1.360, "back to back"),
    ("K7", "k=10 sp16 iteration", iteration(10, "sp16"), 6.312, "back to back"),
    ("K7", "k=6 sp30 iteration", iteration(6, "sp30"), 2.939, "back to back"),
    ("K7", "k=10 sp30 iteration", iteration(10, "sp30"), 12.62, "back to back"),
    ("K9", "k=2 signs 10x1x1", inverse(2, 10, 1), 0.0312, "back to back"),
    ("K9", "k=2 wide 256x64x64", inverse(2, 256, 64), 0.658, "device"),
]

# (bytes, FP64 instructions) of the kernels' own operation counts, as
# chip_smoke.py's model gave them before the bounds moved to the
# function's work (tests/test_torch_flops.py)
KERNEL_COUNTS = [
    ("K1 k=2 1x11x11", (3960, 160875), inverse(2, 1, 11)),
    ("K9 k=2 10x1x1", (400, 5650), inverse(2, 10, 1)),
    ("K1/K9 k=2 256x64x64", (33685504, 5992873984), inverse(2, 256, 64)),
    ("K1 k=2 1x1024", (33562624, 93564780544), inverse(2, 1, 1024)),
    ("K5 k=3 1x11x11", (5896, 535128), inverse(3, 1, 11)),
    ("K5 k=3 64x32x32", (3162112, 666746880), inverse(3, 64, 32)),
    ("K5 k=10 1x93x93", (1384584, 5518808697), inverse(10, 1, 93)),
    ("K7 k=3 1x6x6", (2064, 113328), [steplen_function_work(3, 1, 6)]),
    ("K7 k=3 64x32x32", (3686400, 690208768), [steplen_function_work(3, 64, 32)]),
    ("K7 k=10 1x6x6", (6096, 2477490), [steplen_function_work(10, 1, 6)]),
]


def total(works):
    return sum(w[0] for w in works), sum(w[1] for w in works)


def main():
    print("kernel | shape | bound ms (by) | time ms (kind) | share of the bound")
    for kernel, shape, works, ms, kind in ROWS:
        b, by = bound(*total(works))
        print(f"{kernel} | {shape} | {b:.4g} ({by}) | {ms} ({kind}) | {100 * b / ms:.3g} %")
    print("\nshape | the kernel count's bound / the function's")
    for shape, old, works in KERNEL_COUNTS:
        print(f"{shape} | {bound(*old)[0] / bound(*total(works))[0]:.3g}")


if __name__ == "__main__":
    main()
