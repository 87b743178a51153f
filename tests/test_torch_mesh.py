"""The port's mesh layer (halo2_tpu_torch/utils/mesh.py) and the sharded
evaluator's primitives, on the CPU with 8 "cpu" shards.

  * Mesh: axis sizes, the devices a sharding over one or two axes uses,
    one row of a 2-D mesh as a mesh, "cuda" canonicalised to "cuda:0".
  * The collectives against the arrays they stand for: gather / scatter,
    all_gather, all_to_all (the transpose of tiled blocks), ppermute.
  * `dist_roll` over tests/test_dist_roll.py's
    parameter list (EXT_N 512, D 8: every (q, r) branch) against
    torch.roll, as that file holds the JAX package's against jnp.roll,
    and with a batch axis in the middle.
  * `ShardedField`: each op over the shards equal to the field op on the
    whole array, scalars replicated.

Tolerance: none (integer words compared for equality).
"""

import numpy as np
import pytest
import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fr
from halo2_tpu_torch.plonk.evaluator_sharded import (ShardedEvaluator,
                                                     ShardedField)
from halo2_tpu_torch.utils import mesh as mesh_mod
from halo2_tpu_torch.utils.mesh import Mesh, Replicated, ShardedArray

torch.set_num_threads(1)

D = 8
EXT_N = 512          # L = 64 a shard
L = EXT_N // D


@pytest.fixture(scope="module")
def mesh():
    return Mesh(["cpu"] * D)


def _words(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 1 << 16, size=shape).astype(np.int32))


def test_mesh_axes_and_devices():
    m = Mesh([["cpu"] * 4] * 2, ("dcn", "ici"))
    assert m.shape == {"dcn": 2, "ici": 4}
    assert m.size("ici") == 4 and m.size(("dcn", "ici")) == 8
    assert len(m.devices_of(("dcn", "ici"))) == 8
    assert len(m.devices_of("ici")) == 4 and len(m.devices_of("dcn")) == 2
    sub = Mesh(m.devices[1].tolist(), ("ici",))
    assert sub.axis_names == ("ici",) and sub.shape == {"ici": 4}
    with pytest.raises(ValueError):
        m.devices_of("x")
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 2, ("a", "b"))


def test_mesh_devices_order_and_canonical_index():
    m = Mesh([["cuda:0", "cuda:1"], ["cuda:2", "cuda"]], ("dcn", "ici"))
    # a bare "cuda" names card 0; the flat order is row-major
    assert [str(d) for d in m.flat] == ["cuda:0", "cuda:1", "cuda:2",
                                        "cuda:0"]
    assert [str(d) for d in m.devices_of("ici")] == ["cuda:0", "cuda:1"]
    assert [str(d) for d in m.devices_of("dcn")] == ["cuda:0", "cuda:2"]
    assert [str(d) for d in m.devices_of(("ici", "dcn"))] == \
        ["cuda:0", "cuda:2", "cuda:1", "cuda:0"]


def test_scatter_gather_all_gather(mesh):
    devs = mesh.devices_of("x")
    x = _words(0, (16, 3, EXT_N))
    shards = mesh_mod.scatter(x, devs)
    assert [tuple(s.shape) for s in shards] == [(16, 3, L)] * D
    assert torch.equal(mesh_mod.gather(shards, "cpu"), x)
    stacked = mesh_mod.all_gather(shards, "cpu")
    assert torch.equal(stacked, x.reshape(16, 3, D, L).permute(0, 1, 3, 2))
    with pytest.raises(ValueError):
        mesh_mod.scatter(x[..., :EXT_N - 1], devs)


def test_all_to_all_is_the_tiled_transpose(mesh):
    devs = mesh.devices_of("x")
    # shard j holds rows [j*4, (j+1)*4) of a (32, 16) array; split the
    # column axis, concatenate along rows: shard d gets columns
    # [2d, 2d+2) of every row
    x = _words(1, (5, 32, 16))
    shards = list(x.split(4, dim=1))
    got = mesh_mod.all_to_all(shards, devs, split_axis=2, concat_axis=1)
    want = list(x.split(2, dim=2))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    back = mesh_mod.all_to_all(got, devs, split_axis=1, concat_axis=2)
    assert all(torch.equal(g, s) for g, s in zip(back, shards))


def test_ppermute(mesh):
    devs = mesh.devices_of("x")
    shards = [torch.full((2,), d) for d in range(D)]
    got = mesh_mod.ppermute(shards, devs, [((d + 3) % D, d)
                                           for d in range(D)])
    assert [int(g[0]) for g in got] == [(d + 3) % D for d in range(D)]
    partial = mesh_mod.ppermute(shards, devs, [(0, 5)])
    assert partial[5] is shards[0] and partial[0] is None


def test_sharded_array_indexing():
    x = _words(2, (16, 3, EXT_N))
    arr = ShardedArray(x.chunk(D, dim=-1))
    assert arr.shape == (16, 3, EXT_N) and arr.ndim == 3
    assert torch.equal(arr[:, 1, :].gather(), x[:, 1, :])
    assert torch.equal(arr[:, 1].gather(), x[:, 1, :])
    with pytest.raises(IndexError):
        arr[:, 1, 0]
    with pytest.raises(IndexError):
        arr[..., 0]


@pytest.mark.parametrize("shift", [
    0,               # identity
    5,               # q=0, r>0: neighbour boundary rows only
    L,               # q=1, r=0: whole-shard move
    3 * L,           # q=3, r=0
    2 * L + 7,       # q>0, r>0: both transfers
    7 * L + L - 1,   # q=D-1, r=L-1: wrap-around extremes
    EXT_N - 3,       # equivalent of a right-roll by 3
    EXT_N + 11,      # shift > ext_n: reduced mod ext_n
])
def test_dist_roll_matches_global_roll(mesh, shift):
    x = _words(shift % 97, (16, EXT_N))
    got = torch.cat(mesh_mod.dist_roll(x.chunk(D, dim=-1),
                                       mesh.devices_of("x"), shift), dim=-1)
    assert torch.equal(got, torch.roll(x, -shift, dims=-1))


def test_dist_roll_batched_middle_axis(mesh):
    """The prover rolls (16, C, L) blocks: the batch axis passes through."""
    x = _words(5, (16, 3, EXT_N))
    got = torch.cat(mesh_mod.dist_roll(x.chunk(D, dim=-1),
                                       mesh.devices_of("x"), L + 9), dim=-1)
    assert torch.equal(got, torch.roll(x, -(L + 9), dims=-1))


def test_sharded_field_ops_match_whole_array(mesh):
    F = fr("cpu")
    SF = ShardedField(mesh.devices_of("x"))
    rs = np.random.RandomState(9)
    a = F.encode([int(v) for v in rs.randint(0, 1 << 62, size=62)]
                 + [0, P - 1])
    b = F.encode([int(v) for v in rs.randint(0, 1 << 62, size=62)] + [1, 0])
    sa, sb = (ShardedArray(list(t.chunk(D, dim=-1))) for t in (a, b))
    s = SF.encode_scalar(123456789)
    s_whole = F.encode_scalar(123456789)
    assert torch.equal(SF.add(sa, sb).gather(), F.add(a, b))
    assert torch.equal(SF.sub(sa, sb).gather(), F.sub(a, b))
    assert torch.equal(SF.mul(sa, sb).gather(), F.mul(a, b))
    assert torch.equal(SF.neg(sa).gather(), F.neg(a))
    assert torch.equal(SF.mul(sa, s).gather(), F.mul(a, s_whole))
    assert torch.equal(SF.add(s, sb).gather(), F.add(s_whole, b))
    both = SF.mul(s, s)
    assert isinstance(both, Replicated)
    assert torch.equal(both.on("cpu"), F.mul(s_whole, s_whole))
    assert torch.equal(SF.broadcast_scalar(s, (L,)).gather(),
                       s_whole[:, None].expand(16, EXT_N))
    assert torch.equal(SF.ones((4,)).gather(), F.ones((4 * D,)))
    with pytest.raises(TypeError):
        SF.add(sa, a)


def _extension_ev(mesh, j: int, k: int):
    """A ShardedEvaluator over a bare domain of 2^k rows and degree j (the
    extension reads the domain and the coset tables only)."""
    from types import SimpleNamespace
    from halo2_tpu_torch.fields.limbs import to_tensor
    from halo2_tpu_torch.plonk.evaluator import coset_x_tables_np
    from halo2_tpu_torch.poly.domain import EvaluationDomain
    domain = EvaluationDomain(j, k, "cpu")
    outer, inner, _, _ = coset_x_tables_np(domain)
    pk = SimpleNamespace(
        vk=SimpleNamespace(domain=domain),
        ev=SimpleNamespace(_coset_outer=to_tensor(outer, "cpu"),
                           _coset_inner=to_tensor(inner, "cpu")))
    return ShardedEvaluator(pk, mesh), domain


@pytest.mark.parametrize("j, k", [
    (3, 6),      # ext_k 7: the nonzero rows of the (n1, n2) view are whole
    (17, 3),     # ext_k 7, n = 8 < n2 = 16: the strided gather
])
def test_extend_local_matches_coeff_to_extended(mesh, j, k):
    ev, domain = _extension_ev(mesh, j, k)
    F = fr("cpu")
    n = domain.n
    rs = np.random.RandomState(j)
    coeffs = F.encode([int(v) for v in rs.randint(0, 1 << 62, size=2 * n)]
                      ).reshape(16, 2, n)
    got = ev._extend_local(coeffs).gather()
    assert torch.equal(got, domain.coeff_to_extended_values(coeffs))
    assert tuple(ev._extend_local(F.zeros((0, n))).shape) == \
        (16, 0, domain.extended_n)
