"""The port's multi-device transforms and MSM on the CPU with 8 "cpu"
shards, mirroring tests/test_distributed.py's seven cases:

  * `DistNTT` forward (log_n 8 and 10), the batched inverse and
    inverse_nodiv, a row-sharded input (log_n 9) and the column-batched
    transform on a 2-D (2 x 4) mesh, whose columns split over the outer
    axis and whose four-step runs over the inner one — each equal word for
    word to the port's single-device `NTT`, and the first two to the JAX
    package's `DistNTT` on conftest's 8-device CPU mesh
    (tests/data/torch_golden_mesh.json holds the sha256 of its canonical
    integers, from the same inputs);
  * `msm_many_sharded` over 256 points: full scalars with a stretch of
    equal ones, 16-bit scalars under max_bits 16 (the points handed as
    row shards, as Params hands its bases), and the 2-D mesh
    reducing its totals innermost axis first — each the affine point of
    `curves.host.msm_jacobian` and of the JAX package's `msm_sharded`
    (several columns a call run in every sharded proof,
    tests/test_torch_sharded_prover.py).

Tolerance: none.
"""

import functools
import json
import os

import pytest
import torch

from halo2_tpu_torch.curves import g1, host
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.fields.limbs import ints_to_limbs_np, to_tensor
from halo2_tpu_torch.msm.distributed import msm_many_sharded
from halo2_tpu_torch.ntt.distributed import DistNTT
from halo2_tpu_torch.ntt.ntt import NTT
from halo2_tpu_torch.utils.mesh import Mesh, ShardedArray
from tests.data.gen_torch_golden import (ints_sha256, mesh_field_ints,
                                         mesh_msm_inputs)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_mesh.json")
F = fr("cpu")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def mesh(golden):
    return Mesh(["cpu"] * golden["devices"])


@pytest.fixture(scope="module")
def mesh2d():
    return Mesh([["cpu"] * 4] * 2, ("dcn", "ici"))


def _columns(log_n: int):
    """The golden's input: (16, 2, n) from mesh_field_ints(log_n, 2n)."""
    n = 1 << log_n
    return F.encode(mesh_field_ints(log_n, 2 * n)).reshape(16, 2, n)


@pytest.mark.parametrize("log_n", [8, 10])
def test_dist_ntt_matches_single(mesh, golden, log_n):
    a = _columns(log_n)
    dist = DistNTT(log_n, mesh)
    ntt = NTT(log_n, "cpu")
    got = []
    for c in range(2):
        col = dist.forward(a[:, c, :]).gather()
        assert torch.equal(col, ntt.forward(a[:, c, :]))
        got += F.decode(col)
    assert ints_sha256(got) == golden["dist_ntt"][str(log_n)]["forward"][
        "sha256"]


@pytest.mark.parametrize("log_n", [8, 10])
def test_dist_ntt_inverse_matches_single(mesh, golden, log_n):
    """The batched inverse of the prover's step 7 under use_mesh, divisor
    included, and the variant without it."""
    n = 1 << log_n
    a = _columns(log_n)
    dist = DistNTT(log_n, mesh)
    ntt = NTT(log_n, "cpu")
    for name in ("inverse", "inverse_nodiv"):
        got = getattr(dist, name)(a).gather()
        assert torch.equal(got, getattr(ntt, name)(a))
        assert ints_sha256(F.decode(got.reshape(16, 2 * n))) == \
            golden["dist_ntt"][str(log_n)][name]["sha256"]


def test_dist_ntt_sharded_input(mesh):
    """A row-sharded input (as the sharded evaluator hands h over), handed
    over in a list, and column slices fed to the local transform."""
    log_n = 9
    n = 1 << log_n
    a = F.encode(mesh_field_ints(log_n, n))
    dist = DistNTT(log_n, mesh)
    want = NTT(log_n, "cpu").forward(a)
    rows = ShardedArray(list(a.chunk(dist.D, dim=-1)))
    assert torch.equal(dist.forward([rows]).gather(), want)
    assert torch.equal(
        ShardedArray(dist.local_forward(dist.local_slice_from_flat(a)))
        .gather(), want)
    # the row shards of the output are contiguous blocks: n/D rows each
    assert [s.shape[-1] for s in dist.forward(a).shards] == \
        [n // dist.D] * dist.D


def test_dist_ntt_too_small_for_the_mesh(mesh):
    with pytest.raises(AssertionError):
        DistNTT(5, mesh)                 # n1 = 4 < 8 devices


@functools.lru_cache(maxsize=None)
def _msm_inputs(name):
    """A record's points k * G, made by the point ladder on the CPU (the
    host's affine double-and-add takes seconds a point), as (16, n) affine
    limbs and as host points; its scalars and max_bits."""
    ks, scalars, max_bits = mesh_msm_inputs(name)
    gen = g1.generator("cpu")
    n = len(ks)
    base = (gen[0][:, None].expand(16, n).contiguous(),
            gen[1][:, None].expand(16, n).contiguous())
    xy = g1.to_affine(g1.scalar_mul(base, to_tensor(ints_to_limbs_np(ks),
                                                    "cpu")))
    return xy, g1.decode_points(torch.stack(xy)), scalars, max_bits


def _msm_case(golden, name, mesh, axis, presharded=False):
    xy, pts, scalars, max_bits = _msm_inputs(name)
    rec = golden["msm_sharded"]["records"][name]
    assert rec["max_bits"] == max_bits
    if presharded:
        # the points as row shards, one a device (as Params hands its bases)
        xy = tuple(list(t.chunk(mesh.size(axis), dim=-1)) for t in xy)
    proj = msm_many_sharded(xy, [F.encode(scalars)], mesh, axis, [max_bits])
    got = g1.decode_points(g1.to_affine(proj))[0]
    assert got == host.msm_jacobian(pts, scalars)
    assert [str(v) for v in got] == rec["affine"]


def test_msm_sharded_matches_host(mesh, golden):
    """Full scalars; 32 equal ones give one shard degenerate digits."""
    _msm_case(golden, "full", mesh, "x")


def test_msm_sharded_bounded_bits(mesh, golden):
    """16-bit scalars under max_bits 16, the points handed as shards."""
    _msm_case(golden, "bounded", mesh, "x", presharded=True)


def test_msm_sharded_rejects_uneven_point_shards(mesh):
    xy, _, scalars, _ = _msm_inputs("bounded")
    xs, ys = (list(t.chunk(4, dim=-1)) for t in xy)
    with pytest.raises(ValueError):
        msm_many_sharded((xs, ys), [F.encode(scalars)], mesh, "x")


def test_msm_sharded_2d_mesh(mesh2d, golden):
    """Points over all 8 devices of the (2 x 4) mesh; the window totals
    reduce over the inner axis first, then the outer one."""
    _msm_case(golden, "mesh2d", mesh2d, ("dcn", "ici"))


def test_dist_ntt_dcn_batched(mesh2d):
    """Column-batched transform on a 2-D mesh: the columns split over the
    outer (dcn) axis, each group's four-step runs over its inner (ici)
    devices — no exchange crosses the outer axis."""
    log_n, C = 8, 4
    n = 1 << log_n
    a = F.encode(mesh_field_ints(7, C * n)).reshape(16, C, n)
    ntt = NTT(log_n, "cpu")
    groups = mesh2d.shape["dcn"]
    per = C // groups
    for g in range(groups):
        dist = DistNTT(log_n, Mesh(mesh2d.devices[g].tolist(), ("ici",)),
                       axis="ici")
        got = dist.forward(a[:, g * per:(g + 1) * per, :]).gather()
        for c in range(per):
            assert torch.equal(got[:, c, :], ntt.forward(a[:, g * per + c, :]))
