"""The port's k-limb arithmetic (clrs_tpu_torch/ops/xfloat.py) against
the JAX reference (clrs_tpu/ops/xfloat.py), both on the CPU in float64:
the port performs the reference's operations in the reference's order, so
the limbs must be BITWISE equal, at k=2 (double-double) and at the
ladder's k = 3, 4, 6, 10 (triple-word, quad-word and cascade sequences).
Inputs are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from clrs_tpu.ops import xfloat as jx
from clrs_tpu_torch.ops import xfloat as tx

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """torch on one intra-op thread for a whole port test module (each
    port test file imports this fixture): the suite runs in several worker
    processes, whose intra-op threads only contend for the machine's
    cores.  Every check holds on one thread, as on torch's default."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_xf(rng, shape, k, scale=1.0, positive=False):
    """Normalized k-limb expansions (k, *shape): each limb at most half an
    ulp of the one above it."""
    limbs = [rng.standard_normal(shape) * scale]
    if positive:
        limbs[0] = np.abs(limbs[0]) + 0.1 * scale
    for _ in range(1, k):
        limbs.append(rng.uniform(-0.5, 0.5, shape) * np.spacing(np.abs(limbs[-1])))
    return np.stack(limbs)


def rand_dd(rng, shape, scale=1.0, positive=False):
    """Normalized double-double limbs (2, *shape): |lo| <= ulp(hi)/2."""
    return rand_xf(rng, shape, 2, scale, positive)


KS = (3, 4, 6, 10)  # the precision ladder's limb counts above k=2


def with_k(cases, ids, at_k):
    """Parametrize cases at k=2 under their own ids, and the cases whose
    ids at_k(k, id) accepts again at every k of KS, the id prefixed by k
    (eager JAX takes seconds for one k=10 division, so the higher k run a
    subset)."""
    params = [pytest.param(2, *c, id=i) for c, i in zip(cases, ids)]
    params += [pytest.param(k, *c, id=f"k{k}-{i}") for k in KS
               for c, i in zip(cases, ids) if at_k(k, i)]
    return params


def both(limbs):
    return jx.XF(jnp.asarray(limbs)), tx.XF(torch.from_numpy(np.array(limbs)))


def assert_bitwise(j, t):
    a = np.asarray(j.limbs if hasattr(j, "limbs") else j)
    b = (t.limbs if hasattr(t, "limbs") else t).numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float64:
        assert np.array_equal(a.view(np.uint64), b.view(np.uint64)), \
            np.max(np.abs(a - b))
    else:
        assert np.array_equal(a, b)


BINARY = {
    "add": (jx.xf_add, tx.xf_add),
    "mul": (jx.xf_mul, tx.xf_mul),
    "div": (jx.xf_div, tx.xf_div),
    "max": (jx.xf_max, tx.xf_max),
    "min": (jx.xf_min, tx.xf_min),
}


_BINARY_CASES = [(scale, op) for scale in (1e-8, 1.0, 1e12) for op in sorted(BINARY)]


@pytest.mark.parametrize("k,scale,op", with_k(
    _BINARY_CASES, [f"{s}-{o}" for s, o in _BINARY_CASES],
    lambda k, i: i in ("1.0-add", "1.0-mul", "1.0-div")))
def test_binary_bitwise(k, scale, op):
    rng = np.random.default_rng(0)
    a = rand_xf(rng, (4, 7), k, scale)
    b = rand_xf(rng, (4, 7), k, 1.0)
    ja, ta = both(a)
    jb, tb = both(b)
    fj, ft = BINARY[op]
    assert_bitwise(fj(ja, jb), ft(ta, tb))
    # broadcasting against a row and a scalar
    assert_bitwise(fj(ja, jb[0]), ft(ta, tb[0]))
    assert_bitwise(fj(ja[1, 2], jb), ft(ta[1, 2], tb))


def test_operators_and_cancellation_bitwise():
    rng = np.random.default_rng(1)
    a = rand_dd(rng, (9,))
    ja, ta = both(a)
    # catastrophic cancellation: a - (a + tiny)
    tiny = rand_dd(rng, (9,), 1e-20)
    jt, tt = both(tiny)
    assert_bitwise(ja - (ja + jt), ta - (ta + tt))
    assert_bitwise(2.5 * ja - 1.0, 2.5 * ta - 1.0)
    assert_bitwise(1.0 / ja, 1.0 / ta)
    assert_bitwise(-ja, -ta)
    assert_bitwise(ja < jt, ta < tt)
    assert_bitwise(ja >= 0.25, ta >= 0.25)


@pytest.mark.parametrize("k,scale", with_k(
    [(s,) for s in (1e-100, 1e-6, 1.0, 1e100)], ["1e-100", "1e-06", "1.0", "1e+100"],
    lambda k, i: i == "1.0"))
def test_sqrt_reciprocal_bitwise(k, scale):
    rng = np.random.default_rng(2)
    a = rand_xf(rng, (3, 5), k, scale, positive=True)
    a[:, 0, 0] = 0.0  # sqrt(0) = 0
    ja, ta = both(a)
    assert_bitwise(jx.xf_sqrt(ja), tx.xf_sqrt(ta))
    a[:, 0, 0] = 1.0
    ja, ta = both(a)
    assert_bitwise(jx.xf_reciprocal(ja), tx.xf_reciprocal(ta))


def test_sign_abs_where_bitwise():
    rng = np.random.default_rng(3)
    a = rand_dd(rng, (6, 4))
    a[0, 0, 0] = 0.0
    a[1, 0, 0] = -1e-30  # zero hi, negative lo
    ja, ta = both(a)
    assert_bitwise(jx.xf_is_neg(ja), tx.xf_is_neg(ta))
    assert_bitwise(jx.xf_abs(ja), tx.xf_abs(ta))
    cond = rng.standard_normal((6, 4)) > 0
    jb, tb = both(rand_dd(rng, (4,)))
    assert_bitwise(jx.xf_where(jnp.asarray(cond), ja, jb),
                   tx.xf_where(torch.from_numpy(cond), ta, tb))


def test_pow2_ldexp_bitwise():
    e = np.array([-1100, -1022, -3, 0, 7, 1023, 1500], dtype=np.int64)
    assert_bitwise(jx.pow2(jnp.asarray(e), jnp.float64), tx.pow2(torch.from_numpy(e)))
    rng = np.random.default_rng(4)
    ja, ta = both(rand_dd(rng, (7,)))
    shifts = [-900, -3, 0, 7, 900, 5, -7]  # results stay normal
    assert_bitwise(jx.xf_ldexp(ja, jnp.asarray(shifts)),
                   tx.xf_ldexp(ta, torch.tensor(shifts)))


@pytest.mark.parametrize("k,n", with_k(
    [(n,) for n in (1, 2, 3, 7, 11, 16)], ["1", "2", "3", "7", "11", "16"],
    lambda k, i: i == {3: "7", 4: "11", 6: "3", 10: "2"}[k]))
def test_sum_odd_fold_tree_bitwise(k, n):
    rng = np.random.default_rng(5)
    a = rand_xf(rng, (3, n, 2), k)
    ja, ta = both(a)
    for axis in (0, 1, -1):
        assert_bitwise(jx.xf_sum(ja, axis=axis), tx.xf_sum(ta, axis=axis))


def test_dot_norm_max_bitwise():
    rng = np.random.default_rng(6)
    for n in (1, 5, 13):
        ja, ta = both(rand_dd(rng, (n,)))
        jb, tb = both(rand_dd(rng, (n,)))
        assert_bitwise(jx.xf_dot(ja, jb), tx.xf_dot(ta, tb))
        assert_bitwise(jx.xf_norm_max(ja), tx.xf_norm_max(ta))
    ja, ta = both(rand_dd(rng, (3, 5)))
    assert_bitwise(jx.xf_norm_max(ja), tx.xf_norm_max(ta))


_MATMUL_SHAPES = [((5, 7), (7, 3)), ((1, 1), (1, 1)), ((2, 6, 11), (2, 11, 6)),
                  ((3, 4, 5), (5, 2))]


@pytest.mark.parametrize("k,shapes", [
    pytest.param(2, s, id=f"shapes{i}") for i, s in enumerate(_MATMUL_SHAPES)]
    + [pytest.param(k, _MATMUL_SHAPES[i], id=f"k{k}-shapes{i}")
       for k, i in zip(KS, (0, 2, 3, 0))])
def test_matmul_product_tree_bitwise(k, shapes):
    rng = np.random.default_rng(7)
    ja, ta = both(rand_xf(rng, shapes[0], k))
    jb, tb = both(rand_xf(rng, shapes[1], k))
    assert_bitwise(jx.xf_matmul(ja, jb), tx.xf_matmul(ta, tb))


def test_vec_sum_renorm_bitwise():
    rng = np.random.default_rng(8)
    terms = [rng.standard_normal(5) * 10.0 ** (-8 * i) for i in range(4)]
    jt = [jnp.asarray(t) for t in terms]
    tt = [torch.from_numpy(t) for t in terms]
    for a, b in zip(jx._vec_sum(jt), tx._vec_sum(tt)):
        assert_bitwise(a, b)
    for a, b in zip(jx._renorm(jt, 2), tx._renorm(tt, 2)):
        assert_bitwise(a, b)


@pytest.mark.parametrize("k", [pytest.param(2, id="k2")] + [
    pytest.param(k, id=f"k{k}") for k in KS])
def test_from_to_mp_roundtrip_bitwise(k):
    old = mpmath.mp.prec
    mpmath.mp.prec = max(256, 60 * k)
    try:
        vals = np.array([[mpmath.mpf(1) / 3, -mpmath.pi, mpmath.mpf(0)],
                         [mpmath.sqrt(2) * 1e-200, mpmath.e * 1e250,
                          mpmath.mpf("1e-320")]], dtype=object)
        j = jx.xf_from_mp(vals, k=k)
        t = tx.xf_from_mp(vals, k=k, device=CPU)
        assert_bitwise(j, t)
        back_j = jx.xf_to_mp(j)
        back_t = tx.xf_to_mp(t)
        for a, b in zip(back_j.reshape(-1), back_t.reshape(-1)):
            assert a == b
        # k limbs carry ~53k - 2 bits of the values
        rel = abs(back_t[0, 0] - vals[0, 0]) / vals[0, 0]
        assert rel < mpmath.mpf(2) ** (2 - 53 * k)
    finally:
        mpmath.mp.prec = old


@pytest.mark.parametrize("ka,kb", [(2, 3), (6, 4), (3, 10)])
def test_mixed_limb_counts_bitwise(ka, kb):
    """Mixed k: add pads the shorter operand with zeros, mul runs the
    cascade on the unequal limb lists (xfloat.py:762-769, 1011-1014)."""
    rng = np.random.default_rng(9)
    ja, ta = both(rand_xf(rng, (3, 4), ka))
    jb, tb = both(rand_xf(rng, (3, 4), kb))
    assert_bitwise(jx.xf_add(ja, jb), tx.xf_add(ta, tb))
    assert_bitwise(jx.xf_mul(ja, jb), tx.xf_mul(ta, tb))


def test_other_limb_counts_raise():
    """k = 13 and up run through the reference's _loop_* kernels, which
    are not ported: the port raises rather than compute otherwise."""
    a = tx.XF(torch.zeros((13, 2), dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="_loop_"):
        tx.xf_add(a, a)
    with pytest.raises(NotImplementedError):
        tx.xf_mul(a, a)
    with pytest.raises(NotImplementedError):
        tx.xf_sqrt(a)


def test_constructors_name_their_device():
    z = tx.XF.zeros((2, 3), device=CPU)
    assert z.limbs.dtype == torch.float64 and z.device == CPU
    e = tx.XF.eye(3, device=CPU)
    assert torch.equal(e.limbs[0], torch.eye(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        tx.XF.from_float(1.0)
