"""The port's cost model (clrs_tpu_torch/utils/flops.py) against the
reference's flop counts, and its card-side bounds pinned.

The reference's counts are integers of the expansion cascades that both
packages share, so they must be equal at every k.  The card-side counts
(FP64 instructions and bytes) are pinned at the shapes PERF.md §6 names:
the values chip_smoke.py's own model gave before the model moved here.
The SPD inverse's and the step length's bounds moved on purpose to the
function's own work; their new values are pinned with the old kernel
counts beside them, and their closed forms are held to the loops counted
one by one.
"""

import mpmath
import pytest

from clrs_tpu.utils import flops as jflops
from clrs_tpu_torch.apps.delsarte import build_delsarte_constraints
from clrs_tpu_torch.apps.sphere_packing import nsphere_packing_2point
from clrs_tpu_torch.utils import flops

from test_torch_xfloat import torch_one_thread  # noqa: F401

KS = range(2, 13)


@pytest.fixture(scope="module")
def infos():
    """Config 1's BlockInfo (bench.py's problem, Delsarte dim 8 at d=5)
    and sp16's (radii 1 and sqrt(2) - 1, n = 3, 2d = 16); a BlockInfo
    holds shapes only, so sp16's is built at 120 bits."""
    _, _, config1 = build_delsarte_constraints(8, 5)
    old = mpmath.mp.prec
    try:
        mpmath.mp.prec = 120
        r = [mpmath.mpf(1), mpmath.sqrt(mpmath.mpf(2)) - 1]
        _, _, sp16 = nsphere_packing_2point(3, 8, r, 2, prec=120, build_only=True)
    finally:
        mpmath.mp.prec = old
    return {"config1": config1, "sp16": sp16}


@pytest.mark.parametrize("name", ["config1", "sp16"])
def test_reference_counts_equal(infos, name):
    info = infos[name]
    assert max(max(b) for b in info.Y_blocksizes) == (18 if name == "sp16" else 6)
    for k in KS:
        for fn in ("add_flops", "mul_flops"):
            assert getattr(flops, fn)(k) == getattr(jflops, fn)(k), (fn, k)
        for n, K, m in ((6, 6, 11), (51, 51, 52), (1, 1, 1)):
            assert flops.matmul_flops(n, K, m, k) == jflops.matmul_flops(n, K, m, k)
        for n in (1, 11, 93):
            assert flops.spd_inverse_flops(n, k) == jflops.spd_inverse_flops(n, k)
        for fn in ("decomp_flops", "direction_flops", "steplength_flops", "iteration_flops"):
            got, want = getattr(flops, fn)(info, k), getattr(jflops, fn)(info, k)
            assert isinstance(got, int) and got == want, (fn, k, got, want)


def test_peak_keyed_by_card_name(infos):
    assert flops.fp64_peak_flops("NVIDIA H100 80GB HBM3") == 34e12
    with pytest.raises(KeyError):
        flops.fp64_peak_flops("TPU v5 lite")
    info = infos["config1"]
    mfu = flops.decomp_mfu(info, 3, 0.01, "NVIDIA H100 80GB HBM3")
    assert mfu == flops.decomp_flops(info, 3) / 0.01 / 34e12
    assert flops.HBM_BYTES_PER_S == 3.35e12 and flops.FP64_INSTR_PER_S == 17e12


# op_counts(k) as chip_smoke.py's model gave them
OP_COUNTS = {
    2: (20, 9, 121, 190, 215), 3: (45, 55, 610, 868, 1046), 4: (76, 118, 1177, 1687, 2058),
    5: (113, 221, 2693, 3587, 4497), 6: (156, 376, 4281, 5727, 7262),
    7: (205, 595, 6429, 8631, 11047), 8: (260, 890, 9233, 12431, 16032),
    9: (321, 1273, 15986, 20456, 26876), 10: (388, 1756, 21491, 27545, 36386),
    11: (461, 2351, 28176, 36162, 47984), 12: (540, 3070, 36161, 46463, 61886)}


def test_op_counts_pinned():
    for k, want in OP_COUNTS.items():
        c = flops.op_counts(k)
        assert tuple(c[op] for op in ("add", "mul", "recip", "div", "sqrt")) == want, k


# (bytes, FP64 instructions) as chip_smoke.py's model gave them
WORK = [
    ("matmul_work", (2, 1, 6, 6, 11, 6), (2688, 11484)),
    ("matmul_work", (3, 1, 6, 6, 11, 8), (4032, 52800)),
    ("matmul_work", (2, 8, 256, 256, 256, 256), (25165824, 3892314112)),
    ("matmul_work", (3, 1, 1024, 64, 1024, 64), (28311552, 6710886400)),
    ("matmul_work", (2, 1, 11, 6, 11, 6, 1, 1), (4048, 21054)),
    ("matmul_work", (6, 3, 17, 9, 17, 16), (85680, 7379904)),
    ("matmul_work", (10, 1, 93, 93, 94, 96), (2090640, 1799313408)),
    ("matmul_work", (2, 10, 1, 1, 1, 1), (480, 290)),
    ("schur_work", (2, 1, 1, 11), (7744, 12705)),
    ("schur_work", (3, 1, 1, 11), (11616, 49610)),
    ("schur_work", (2, 1, 3, 128), (14417920, 61931520)),
    ("schur_work", (3, 1, 3, 128), (21626880, 241827840)),
    ("schur_work", (6, 1, 2, 31), (830304, 20307852)),
    ("schur_work", (10, 1, 2, 31), (1383840, 86005656)),
    ("schur_work", (2, 10, 1, 1), (640, 1050)),
    ("elemwise_work", (3, 1, "add"), (72, 45)),
    ("elemwise_work", (3, 1 << 20, "add"), (75497472, 47185920)),
    ("elemwise_work", (12, 1 << 20, "mul"), (301989888, 3219128320)),
    ("elemwise_work", (9, 1 << 20, "mul"), (226492416, 1334837248)),
    ("elemwise_work", (10, 1 << 20, "mul"), (251658240, 1841299456)),
    ("elemwise_work", (2, 36, "mul"), (1728, 324)),
    # K5's panel route (on the function's work before the others, its
    # divisions now sharing L's n reciprocals; the instructions with a
    # reciprocal a division: 909631454, 951787134, 962525644, 6952070144,
    # 54650755072, 5139513081, 21253546896)
    ("spd_inverse_function_work", (3, 1, 257), (3170360, 869498334)),
    ("spd_inverse_function_work", (3, 1, 261), (3269816, 910392534)),
    ("spd_inverse_function_work", (3, 1, 262), (3294920, 920812624)),
    ("spd_inverse_function_work", (3, 1, 512), (12582920, 6792474624)),
    ("spd_inverse_function_work", (3, 1, 1024), (50331656, 54011748352)),
    ("spd_inverse_function_work", (6, 1, 261), (6539624, 4849004421)),
    ("spd_inverse_function_work", (10, 1, 262), (10983048, 19783949334)),
    # K1, K5's single launch and K9, moved on purpose from the kernel's own
    # operations (chip_smoke.spd_inverse_work) to the function's; the old
    # values: (3960, 160875), (400, 5650), (33685504, 5992873984),
    # (33562624, 93564780544), (5896, 535128), (3162112, 666746880),
    # (1384584, 5518808697)
    ("spd_inverse_function_work", (2, 1, 11), (3880, 33099)),
    ("spd_inverse_function_work", (2, 10, 1), (400, 4340)),
    ("spd_inverse_function_work", (2, 256, 64), (33556480, 1066139648)),
    ("spd_inverse_function_work", (2, 1, 1024), (33554440, 15657156608)),
    ("spd_inverse_function_work", (3, 1, 11), (5816, 122034)),
    ("spd_inverse_function_work", (3, 64, 32), (3146240, 128434176)),
    ("spd_inverse_function_work", (10, 1, 93), (1383848, 929286039)),
    # K7, moved likewise (chip_smoke.steplen_work); the old values:
    # (2064, 113328), (3686400, 690208768), (6096, 2477490)
    ("steplen_function_work", (3, 1, 6), (2024, 44548)),
    ("steplen_function_work", (3, 64, 32), (3670528, 208691200)),
    ("steplen_function_work", (10, 1, 6), (6056, 1126226)),
]


@pytest.mark.parametrize("fn, args, want", WORK,
                         ids=[f"{w[0]}-{'-'.join(map(str, w[1]))}" for w in WORK])
def test_work_pinned(fn, args, want):
    got = getattr(flops, fn)(*args)
    assert got == want
    ms, by = flops.bound(*got)
    assert ms == 1e3 * max(want[0] / 3.35e12, want[1] / 17e12)
    assert by == ("bytes" if want[0] / 3.35e12 >= want[1] / 17e12 else "operations")


def _enumerated(n):
    """Multiply-adds and divisions of the SPD inverse and of the step
    length's sandwich, counted loop by loop: the Cholesky (column j's
    diagonal, then its rows below), W = L^-1 (forward substitution on
    each column of the identity, from its first nonzero), W^T W's upper
    triangle, W = L^-1 dM on n full columns, and the lower triangle of
    W L^-T (row i solved up to column i)."""
    chol = sum(j + j * (n - 1 - j) for j in range(n))
    chol_div = n * (n - 1) // 2
    inv = sum(i - c for c in range(n) for i in range(c, n))
    inv_div = n * (n + 1) // 2
    wtw = sum(n - max(i, j) for i in range(n) for j in range(i, n))
    wdm = n * sum(range(n))
    tri = sum(j for i in range(n) for j in range(i + 1))
    return (chol + inv + wtw, chol_div + inv_div), (chol + wdm + tri, chol_div + n * n + inv_div)


@pytest.mark.parametrize("k", [2, 3, 10])
def test_function_work_counts_by_enumeration(k):
    """The closed forms of spd_inverse_function_work and
    steplen_function_work against the loops counted one by one at n = 1..9,
    every division by one of L's n diagonal entries (their reciprocals
    taken once)."""
    c = flops.op_counts(k)
    for n in range(1, 10):
        (inv_macs, inv_divs), (sl_macs, sl_divs) = _enumerated(n)
        divs = lambda count: n * c["recip"] + count * (c["div"] - c["recip"])  # noqa: E731
        want = inv_macs * (c["mul"] + c["add"]) + divs(inv_divs) + n * c["sqrt"]
        assert flops.spd_inverse_function_work(k, 1, n)[1] == want, n
        want = sl_macs * (c["mul"] + c["add"]) + divs(sl_divs) + n * c["sqrt"] + n * n
        assert flops.steplen_function_work(k, 1, n)[1] == want, n
