"""halo2_tpu_torch G1 layer (the modules of kernels K4 and K5) against the
JAX package and the host big-int curve, on the CPU.

The same points, made from a seed, go through `halo2_tpu.curves.g1` and
through the port's `curves.g1` / `curves.cuda_point` with CPU tensors (the
plain PyTorch versions).  Tolerance: none — projective limb words and
decoded points are compared for equality.  The JAX side runs once per
module, at the batch sizes tests/test_curve.py already compiles.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.curves import g1 as jg1
from halo2_tpu.fields.bn254 import Fq as JFq
from halo2_tpu.fields.limbs import ints_to_limbs_np as j_ints_to_limbs
from halo2_tpu.msm import sorted as jsorted

from halo2_tpu_torch.curves import cuda_point, formulas, g1, host
from halo2_tpu_torch.fields import limbs as tl
from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fq
from halo2_tpu_torch.msm.sorted import pack_xy

torch.set_num_threads(1)

N = 16


def _points(seed, n):
    rng = random.Random(seed)
    return [host.random_point(rng) for _ in range(n)]


PS, QS = _points(0xA11CE, N), _points(0xB0B, N)
# one batch of N for every JAX call (each new batch size is a new XLA
# program): P + P, P - P, identity + P, P + identity, then general pairs
PA = [PS[0], PS[0], None, PS[0]] + PS[4:]
QA = [PS[0], host.neg(PS[0]), PS[0], None] + QS[4:]
KS = [random.Random(5).randrange(FR_MODULUS) for _ in range(4)] + [0, 1]
SIGNS = [i % 2 for i in range(N)]


def _words(point):
    """A tuple of limb arrays (JAX or torch) as a list of numpy arrays."""
    return [tl.to_numpy(c) if isinstance(c, torch.Tensor) else np.asarray(c)
            for c in point]


def _same_words(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_words(a), _words(b)))


def _t_proj(points):
    """Host points (None = identity) -> port projective, identity as
    (0 : 1 : 0)."""
    aff = g1.encode_points(points, "cpu")
    proj = g1.from_affine((aff[0], aff[1]))
    ident = g1.identity((len(points),), "cpu")
    return g1.select(g1.is_identity((aff[0], aff[1])), ident, proj)


def _j_proj(points):
    aff = tuple(jg1.encode_points(points))
    proj = jg1.from_affine(aff)
    ident = jg1.identity((len(points),))
    return jg1.select(jg1.is_identity(aff), ident, proj)


def _t_decode(proj):
    return g1.decode_points(g1.to_affine(proj))


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    jp, jq = _j_proj(PA), _j_proj(QA)
    jq_aff = tuple(jg1.encode_points(QS))
    out["add"] = _words(jg1.add(jp, jq))
    out["add_mixed"] = _words(jg1.add_mixed(jp, jq_aff))
    out["double"] = _words(jg1.double(jp))
    sm = jg1.scalar_mul(tuple(jg1.encode_points(PS[:6])),
                        jnp.asarray(j_ints_to_limbs(KS)))
    out["scalar_mul"] = jg1.decode_points(jnp.stack(jg1.to_affine(sm)))
    out["to_affine"] = _words(jg1.to_affine(jg1.add(jp, jq)))  # has Z = 0
    # the reference's own stand-in for the packed kernel off the TPU
    # (msm/sorted.py: _unpack_xy, negate, g1.add_mixed)
    packed = jsorted._pack_xy(*jq_aff)
    out["packed_words"] = np.asarray(packed)
    qx, qy = jsorted._unpack_xy(packed)
    sign = jnp.asarray(np.array(SIGNS, dtype=bool))
    qy = jnp.where(sign[None], JFq.raw.neg(qy), qy)
    out["add_mixed_packed"] = _words(jg1.add_mixed(jp, (qx, qy)))
    return out


def test_add_matches_jax_and_host(jax_side):
    """Complete addition, with P + P, P - P, identity + P and
    P + identity among the operands."""
    got = g1.add(_t_proj(PA), _t_proj(QA))
    assert _same_words(got, jax_side["add"])
    assert _t_decode(got) == [host.add(p, q) for p, q in zip(PA, QA)]
    assert _t_decode(got)[:4] == [host.double(PS[0]), None, PS[0], PS[0]]


def test_add_mixed_matches_jax_and_host(jax_side):
    """Mixed addition; the projective operand may be the identity."""
    q_aff = g1.encode_points(QS, "cpu")
    got = g1.add_mixed(_t_proj(PA), (q_aff[0], q_aff[1]))
    assert _same_words(got, jax_side["add_mixed"])
    assert _t_decode(got) == [host.add(p, q) for p, q in zip(PA, QS)]


def test_double_matches_jax_and_host(jax_side):
    got = g1.double(_t_proj(PA))
    assert _same_words(got, jax_side["double"])
    assert _t_decode(got) == [host.double(p) for p in PA]
    assert _t_decode(got)[2] is None           # twice the identity


def test_scalar_mul_matches_jax_and_host(jax_side):
    aff = g1.encode_points(PS[:6], "cpu")
    scal = tl.to_tensor(tl.ints_to_limbs_np(KS), "cpu")
    got = _t_decode(g1.scalar_mul((aff[0], aff[1]), scal))
    assert got == jax_side["scalar_mul"]
    assert got == [host.mul(p, k) for p, k in zip(PS[:6], KS)]


def test_to_affine_matches_jax(jax_side):
    got = g1.to_affine(g1.add(_t_proj(PA), _t_proj(QA)))
    assert _same_words(got, jax_side["to_affine"])
    with_identity = g1.to_affine(_t_proj([PS[0], None, PS[1]]))
    assert g1.decode_points(with_identity) == [PS[0], None, PS[1]]


def test_add_mixed_packed_matches_reference_fallback(jax_side):
    q_aff = g1.encode_points(QS, "cpu")
    packed = pack_xy(q_aff[0], q_aff[1])
    assert np.array_equal(tl.to_numpy(packed), jax_side["packed_words"])
    assert bool((packed < 0).any()), "no word with its top bit set"
    sign = torch.tensor(SIGNS, dtype=torch.int32)
    got = cuda_point.add_mixed_packed(_t_proj(PA), packed, sign)
    assert _same_words(got, jax_side["add_mixed_packed"])
    want = [host.add(p, host.neg(q) if s else q)
            for p, q, s in zip(PA, QS, SIGNS)]
    assert _t_decode(got) == want
    # onto the identity, as the first step of the MSM scan does
    first = cuda_point.add_mixed_packed(g1.identity((N,), "cpu"), packed,
                                        sign)
    assert _t_decode(first) == [host.neg(q) if s else q
                                for q, s in zip(QS, SIGNS)]


def test_unpack_is_the_inverse_of_pack():
    q_aff = g1.encode_points(QS, "cpu")
    x, y = cuda_point.unpack_xy(pack_xy(q_aff[0], q_aff[1]))
    assert torch.equal(x, q_aff[0]) and torch.equal(y, q_aff[1])


@pytest.mark.parametrize("op", ["add", "add_mixed", "double"])
def test_plain_point_op_follows_the_formulas(op):
    """The stacked plain version against curves/formulas.py run on the
    port's field ops one at a time."""
    F = fq("cpu")
    tp, tq = _t_proj(PS[:5] + [None]), _t_proj(QS[:5] + [PS[0]])
    q_aff = g1.encode_points(QS[:6], "cpu")
    if op == "add":
        got = cuda_point.point_op(op, list(tp) + list(tq))
        want = formulas.add_complete(F, tp, tq)
    elif op == "add_mixed":
        got = cuda_point.point_op(op, list(tp) + [q_aff[0], q_aff[1]])
        want = formulas.add_mixed(F, tp, (q_aff[0], q_aff[1]))
    else:
        got = cuda_point.point_op(op, list(tp))
        want = formulas.double_complete(F, tp)
    assert _same_words(got, want)


def test_batch_dims_and_one_point():
    tp, tq = _t_proj(PS[:12]), _t_proj(QS[:12])
    shaped = lambda p: tuple(c.reshape(16, 3, 4) for c in p)  # noqa: E731
    got = g1.add(shaped(tp), shaped(tq))
    assert got[0].shape == (16, 3, 4)
    flat = tuple(c.reshape(16, 12) for c in got)
    assert _t_decode(flat) == [host.add(p, q)
                               for p, q in zip(PS[:12], QS[:12])]
    one = g1.add(_t_proj(PS[:1]), _t_proj(QS[:1]))
    assert _t_decode(one) == [host.add(PS[0], QS[0])]


def test_encode_decode_generator_neg():
    pts = PS[:8] + [None]
    assert g1.decode_points(g1.encode_points(pts, "cpu")) == pts
    gen = g1.generator("cpu")
    assert g1.decode_points(
        torch.stack([gen[0][:, None], gen[1][:, None]])) == [(1, 2)]
    assert _t_decode(g1.neg(_t_proj(PS[:3]))) == [host.neg(p)
                                                  for p in PS[:3]]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    tp = _t_proj(PS[:4])
    with pytest.raises(ValueError):
        cuda_point.point_op("add", list(tp))
    with pytest.raises(ValueError):
        cuda_point.point_op("triple", list(tp))
    with pytest.raises(TypeError):
        cuda_point.point_op("double", [c.to(torch.int64) for c in tp])
    with pytest.raises(ValueError):
        cuda_point.point_op("double", [tp[0], tp[1], tp[2][:, :2]])
    packed = pack_xy(tp[0], tp[1])
    with pytest.raises(ValueError):
        cuda_point.add_mixed_packed(
            tp, packed, torch.zeros(3, dtype=torch.int32))
