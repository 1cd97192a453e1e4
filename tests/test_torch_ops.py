"""The port's tower, curve and pairing layers vs the jitted JAX functions.

The port keeps the JAX package's formulas and its Fq pipeline, so every
output must equal the JAX package's limb for limb (and therefore by value
mod p).  Inputs are made with numpy from a seed and fed to both sides; the
port runs on the CPU, where the Fq wrappers use the kernels' plain versions.
Batches stay at 4 or fewer to keep the JAX compiles short.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import curve as jcurve  # noqa: E402
from lighthouse_tpu.ops import ec as jec  # noqa: E402
from lighthouse_tpu.ops import fq as jfq  # noqa: E402
from lighthouse_tpu.ops import pairing as jpa  # noqa: E402
from lighthouse_tpu.ops import tower as jtw  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import curve as pcurve  # noqa: E402
from lighthouse_tpu_torch.ops import ec, fq, pairing, tower  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one thread: on these tiny tensors its parallel
    regions cost more than they save, and in a parallel test run every
    worker's thread pool would compete for the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def jax_int32_backend():
    """Pin the JAX package's Fq lowering to the int32 path the port keeps
    (fresh jitted closures below trace with it)."""
    prev = jfq.set_fq_backend("int32")
    yield
    jfq.set_fq_backend(prev)


def _rand(rng, shape):
    """Canonical-range random limbs (values below 2^400, not reduced)."""
    return rng.integers(0, 1 << 16, shape + (fq.L16,), dtype=np.int32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _same(port_out, jax_out):
    if isinstance(port_out, tuple):
        assert len(port_out) == len(jax_out)
        for p, j in zip(port_out, jax_out):
            _same(p, j)
        return
    j = np.asarray(jax_out)
    p = port_out.numpy()
    assert p.shape == j.shape
    assert np.array_equal(p, j)


# ------------------------------------------------------------------- tower


@pytest.mark.parametrize("name", ["fq12_mul", "fq12_square", "fq6_mul", "fq2_inv"])
def test_tower_products_equal_jax(name):
    rng = np.random.default_rng(1)
    shapes = {"fq12_mul": (2, 2, 3, 2), "fq12_square": (2, 2, 3, 2),
              "fq6_mul": (3, 3, 2), "fq2_inv": (3, 2)}
    a = _rand(rng, shapes[name])
    b = _rand(rng, shapes[name])
    port_fn, jax_fn = getattr(tower, name), getattr(jtw, name)
    if name in ("fq12_mul", "fq6_mul"):
        _same(port_fn(_t(a), _t(b)), jax.jit(lambda x, y: jax_fn(x, y))(a, b))
    else:
        _same(port_fn(_t(a)), jax.jit(lambda x: jax_fn(x))(a))


def test_fq12_inv_and_frobenius_equal_jax():
    rng = np.random.default_rng(2)
    a = _rand(rng, (2, 2, 3, 2))
    inv = tower.fq12_inv(_t(a))
    _same(inv, jax.jit(lambda x: jtw.fq12_inv(x))(a))
    one = tower.fq12_mul(inv, _t(a))
    assert all(tower.fq12_from_limbs(one[i]).is_one() for i in range(2))
    _same(tower.fq12_frobenius(_t(a)), jax.jit(lambda x: jtw.fq12_frobenius(x))(a))
    _same(tower.fq12_frobenius_n(_t(a), 2), jax.jit(lambda x: jtw.fq12_frobenius_n(x, 2))(a))
    fr = tower.fq12_from_limbs(tower.fq12_frobenius(_t(a))[0])
    assert fr == tower.fq12_from_limbs(a[0]).frobenius()


def test_fq2_many_equals_jax():
    rng = np.random.default_rng(3)
    x, y, z = (_rand(rng, (3, 2)) for _ in range(3))
    port = tower.fq2_many([(_t(x), _t(y)), (_t(y), _t(z))], [_t(z)])
    ref = jax.jit(lambda a, b, c: jtw.fq2_many([(a, b), (b, c)], [c]))(x, y, z)
    _same(tuple(port[0]) + tuple(port[1]), tuple(ref[0]) + tuple(ref[1]))


# ----------------------------------------------------------------------- ec


def _points(rng, ops_name, batch):
    tail = (2,) if ops_name == "G2" else ()
    return tuple(_rand(rng, batch + tail) for _ in range(3))


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_point_add_double_equal_jax(group):
    rng = np.random.default_rng(4)
    p, q = _points(rng, group, (3,)), _points(rng, group, (3,))
    ops, jops = getattr(ec, f"{group}_OPS"), getattr(jec, f"{group}_OPS")
    _same(ec.point_add(ops, tuple(map(_t, p)), tuple(map(_t, q))),
          jax.jit(lambda a, b: jec.point_add(jops, a, b))(p, q))
    _same(ec.point_double(ops, tuple(map(_t, p))),
          jax.jit(lambda a: jec.point_double(jops, a))(p))


def _gen_multiples(group, ks):
    gen = jcurve.G1 if group == "G1" else jcurve.G2
    to = jec.g1_to_limbs if group == "G1" else jec.g2_to_limbs
    pts = [to(jcurve.mul(gen, k)) for k in ks]
    return tuple(np.stack([p[c] for p in pts]) for c in range(3))


def test_scalar_mul_windowed_equals_jax():
    rng = np.random.default_rng(5)
    pts = _gen_multiples("G1", [3, 1234567])
    bits = rng.integers(0, 2, (2, 64), dtype=np.int32)
    port = ec.scalar_mul_windowed(ec.G1_OPS, tuple(map(_t, pts)), _t(bits))
    _same(port, jax.jit(lambda p, b: jec.scalar_mul_windowed(jec.G1_OPS, p, b))(pts, bits))
    k = int("".join(map(str, bits[1])), 2)
    want = jcurve.mul(jcurve.mul(jcurve.G1, 1234567), k)
    got = ec.g1_from_limbs(tuple(c[1] for c in port))
    assert (got[0].n, got[1].n) == (want[0].n, want[1].n)


@pytest.mark.parametrize("n", [4, 3])
def test_msm_windowed_equals_jax(n):
    rng = np.random.default_rng(6 + n)
    pts = _gen_multiples("G2", [5, 7, 11, 13][:n])
    bits = rng.integers(0, 2, (n, 64), dtype=np.int32)
    port = ec.msm_windowed(ec.G2_OPS, tuple(map(_t, pts)), _t(bits))
    _same(port, jax.jit(lambda p, b: jec.msm_windowed(jec.G2_OPS, p, b))(pts, bits))


def test_tree_sum_equals_jax():
    rng = np.random.default_rng(8)
    pts = _points(rng, "G1", (2, 3))  # axis 1 of length 3: identity padding
    _same(ec.tree_sum(ec.G1_OPS, tuple(map(_t, pts)), axis=1),
          jax.jit(lambda p: jec.tree_sum(jec.G1_OPS, p, axis=1))(pts))
    g2 = _gen_multiples("G2", [2, 3, 4, 5])
    summed = ec.tree_sum(ec.G2_OPS, tuple(map(_t, g2)), axis=0)
    _same(summed, jax.jit(lambda p: jec.tree_sum(jec.G2_OPS, p, axis=0))(g2))
    assert ec.g2_from_limbs(summed) == pcurve.mul(pcurve.G2, 14)


# ------------------------------------------------------------------ pairing


def _pairing_inputs():
    """p1 = (6 g1, -g1) projective, q2 = (g2, 6 g2) affine (Z = 1 dropped)."""
    x, y, z = _gen_multiples("G1", [6, 1])
    y = np.stack([y[0], -y[1]])
    qx, qy, _ = _gen_multiples("G2", [1, 6])
    return (x, y, z), (qx, qy)


def test_miller_loop_and_final_exponentiation_equal_jax():
    p1, q2 = _pairing_inputs()
    f = pairing.miller_loop(tuple(map(_t, p1)), tuple(map(_t, q2)))
    jf = jax.jit(lambda p, q: jpa.miller_loop(p, q))(p1, q2)
    _same(f, jf)
    fe = pairing.final_exponentiation(f[0])
    _same(fe, jax.jit(lambda x: jpa.final_exponentiation(x))(np.asarray(jf)[0]))


def test_multi_pairing_fe_equals_jax_and_verifies():
    """e(6 g1, g2) * e(-g1, 6 g2) == 1: the masked multi-pairing's output
    equals the JAX package's limb for limb and is one; a dead pair is
    neutral."""
    p1, q2 = _pairing_inputs()
    mask = np.array([True, True])
    fe = pairing.multi_pairing_fe(tuple(map(_t, p1)), tuple(map(_t, q2)), _t(mask))
    _same(fe, jax.jit(lambda p, q, m: jpa.multi_pairing_fe(p, q, m))(p1, q2, mask))
    assert pairing.fe_is_one(fe)
    dead = pairing.multi_pairing_fe(tuple(map(_t, p1)), tuple(map(_t, q2)),
                                    _t(np.array([True, False])))
    assert not pairing.fe_is_one(dead)
