"""halo2_tpu_torch field layer (the module of kernel K1) against the JAX
package and against Python integers, on the CPU.

The same inputs, made from a seed with numpy, go through
`halo2_tpu.fields.bn254.Fr/Fq` and through the port's `Field` with
device="cpu" (its plain PyTorch versions).  Tolerance: none — decoded
integers are compared for equality.  The JAX side runs once per module, at
the shapes tests/test_field.py already compiles.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields import bn254 as jax_bn254

from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import fq, fr

torch.set_num_threads(1)

FIELDS = {"Fr": (jax_bn254.Fr, fr), "Fq": (jax_bn254.Fq, fq)}
BINARY = ("add", "sub", "mul")
UNARY = ("neg", "square", "to_mont", "from_mont")
N = 64          # the width tests/test_field.py uses for add/sub/mul
N_INV = 8       # ... for inv
N_BATCH = 33    # ... for batch_inverse


def _rand_ints(rng, n, p):
    """n uniform values below p from a numpy generator."""
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]


def _inputs(name):
    p = FIELDS[name][0].p
    rng = np.random.default_rng(0xF1E1D + len(name) + ord(name[1]))
    xs, ys = _rand_ints(rng, N, p), _rand_ints(rng, N, p)
    xs[:4] = [0, 1, p - 1, 0]
    ys[:4] = [p - 1, p - 1, p - 1, 0]
    return xs, ys


def _raw_ints(limbs):
    """The integers the limb words spell, without leaving Montgomery form."""
    arr = tl.to_numpy(limbs) if isinstance(limbs, torch.Tensor) \
        else np.asarray(limbs)
    return tl.limbs_to_ints(arr)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result this module compares with, computed once."""
    out = {}
    for name, (JF, _) in FIELDS.items():
        xs, ys = _inputs(name)
        a, b = jnp.asarray(JF.encode(xs)), jnp.asarray(JF.encode(ys))
        for op in BINARY:
            out[name, op] = _raw_ints(getattr(JF, op)(a, b))
        for op in UNARY:
            out[name, op] = _raw_ints(getattr(JF, op)(a))
        out[name, "inv"] = _raw_ints(JF.inv(a[:, :N_INV]))
    JF = jax_bn254.Fr
    xs, _ = _inputs("Fr")
    zs = list(xs[:N_BATCH])
    zs[5] = zs[17] = 0
    out["Fr", "batch_inverse"] = _raw_ints(
        JF.batch_inverse(jnp.asarray(JF.encode(zs))))
    return out


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("op", BINARY)
def test_binary_op(jax_side, name, op):
    F = FIELDS[name][1]("cpu")
    xs, ys = _inputs(name)
    got = getattr(F, op)(F.encode(xs), F.encode(ys))
    assert _raw_ints(got) == jax_side[name, op]
    want = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
            "mul": lambda x, y: x * y}[op]
    assert F.decode(got) == [want(x, y) % F.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("op", UNARY)
def test_unary_op(jax_side, name, op):
    F = FIELDS[name][1]("cpu")
    xs, _ = _inputs(name)
    got = getattr(F, op)(F.encode(xs))
    assert _raw_ints(got) == jax_side[name, op]
    R = F.R
    want = {"neg": lambda x: -x * R, "square": lambda x: x * x * R,
            "to_mont": lambda x: x * R * R, "from_mont": lambda x: x}[op]
    assert _raw_ints(got) == [want(x) % F.p for x in xs]


@pytest.mark.parametrize("name", list(FIELDS))
def test_inv(jax_side, name):
    F = FIELDS[name][1]("cpu")
    xs, _ = _inputs(name)
    got = F.inv(F.encode(xs[:N_INV]))
    assert _raw_ints(got) == jax_side[name, "inv"]
    assert F.decode(got) == [pow(x, F.p - 2, F.p) for x in xs[:N_INV]]


def test_batch_inverse_with_zeros_matches_jax(jax_side):
    F = fr("cpu")
    xs, _ = _inputs("Fr")
    zs = list(xs[:N_BATCH])
    zs[5] = zs[17] = 0
    got = F.batch_inverse(F.encode(zs))
    assert _raw_ints(got) == jax_side["Fr", "batch_inverse"]
    assert F.decode(got) == [pow(z, F.p - 2, F.p) for z in zs]


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("block", [4, 1024])
def test_prefix_mul_and_batch_inverse_vs_ints(name, block):
    F = FIELDS[name][1]("cpu")
    xs, _ = _inputs(name)
    xs = [x or 7 for x in xs[:37]]
    a = F.encode(xs)
    acc, want = 1, []
    for x in xs:
        acc = acc * x % F.p
        want.append(acc)
    assert F.decode(F.prefix_mul(a, block=block)) == want
    rev = F.decode(F.prefix_mul(a, reverse=True, block=block))
    acc, want_rev = 1, []
    for x in reversed(xs):
        acc = acc * x % F.p
        want_rev.append(acc)
    assert rev == want_rev[::-1]
    zs = [0] + xs[1:9] + [0]
    assert F.decode(F.batch_inverse(F.encode(zs))) == \
        [pow(z, F.p - 2, F.p) for z in zs]


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("op", BINARY)
def test_edge_values_all_pairs(name, op):
    """0, 1, 2, p-2, p-1 and limb-boundary values against each other, as
    raw limb words (so the Montgomery product is a*b/R)."""
    F = FIELDS[name][1]("cpu")
    p = F.p
    vals = [0, 1, 2, p - 2, p - 1, 0xFFFF, 1 << 16, (1 << 128) - 1,
            1 << 128, (1 << 253) - 1, 1 << 253, p >> 1]
    xs = [x for x in vals for _ in vals]
    ys = [y for _ in vals for y in vals]
    a = tl.to_tensor(tl.ints_to_limbs_np(xs), "cpu")
    b = tl.to_tensor(tl.ints_to_limbs_np(ys), "cpu")
    want = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
            "mul": lambda x, y: x * y * F.R_inv}[op]
    assert _raw_ints(getattr(F, op)(a, b)) == \
        [want(x, y) % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", list(FIELDS))
def test_scalar_operand_and_batch_dims(name):
    F = FIELDS[name][1]("cpu")
    xs, ys = _inputs(name)
    a = F.encode(xs[:24]).reshape(16, 2, 3, 4)
    s = F.encode_scalar(ys[7])
    assert F.decode(F.mul(a, s).reshape(16, 24)) == \
        [x * ys[7] % F.p for x in xs[:24]]
    col = F.encode(ys[:4])                       # (16, 4) against (16,2,3,4)
    got = F.add(a, col.reshape(16, 1, 1, 4)).reshape(16, 24)
    assert F.decode(got) == [(x + ys[i % 4]) % F.p
                             for i, x in enumerate(xs[:24])]
    assert F.decode_scalar(F.encode_scalar(xs[9])) == xs[9]
    assert bool(tl.is_zero(F.zeros((3,))).all())
    assert bool(tl.eq(a, a).all())


@pytest.mark.parametrize("name", list(FIELDS))
def test_device_side_encoders(name):
    F = FIELDS[name][1]("cpu")
    xs, _ = _inputs(name)
    blob = b"".join(x.to_bytes(32, "little") for x in xs)
    assert F.decode(F.encode_le_bytes_dev(blob, len(xs))) == xs
    cols = np.array([[0, 1, 2 ** 64 - 1, 12345], [7, 2 ** 63, 2 ** 32, 65535]],
                    dtype=np.uint64)
    enc = F.encode_u64_dev(cols)
    assert enc.shape == (16, 2, 4)
    assert F.decode(enc.reshape(16, 8)) == [int(v) for v in cols.reshape(-1)]


def test_pow_static():
    F = fr("cpu")
    xs, _ = _inputs("Fr")
    a = F.encode(xs[:8])
    for e in (0, 1, 2, 5, 65537):
        assert F.decode(F.pow_static(a, e)) == [pow(x, e, F.p)
                                                for x in xs[:8]]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    F = fr("cpu")
    a = F.encode([1, 2, 3])
    with pytest.raises(TypeError):
        F.add(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        F.add(a[:8], a[:8])
    with pytest.raises(ValueError):
        F.add(a, F.encode([1, 2]))
