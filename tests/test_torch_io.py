"""The port's files (halo2_tpu_torch/io: params, verifying key, circuit
data, witness) and the witness split, against the JAX package's, on the
CPU, for tests/test_e2e.py's SimpleCircuit at K = 4 (params seed 7).

  * the bytes the port writes for params, vk and witness equal the JAX
    package's, and the arrays of its circuit-data .npz equal the JAX
    file's (keys, dtypes, shapes, values);
  * files the JAX package wrote load in the port (params, vk, witness, and
    circuit data rebuilt into a proving key equal to keygen's), and the
    port's circuit-data file reads in the JAX package (its cs blob through
    `halo2_tpu.io.cs_format.read_cs`, its digest against the JAX vk);
  * a tampered circuit-data file is rejected, a witness value >= p is
    reduced on writing and rejected on reading;
  * create_proof_from_witness gives the bytes of create_proof for the same
    seed, and the JAX package's, and the reloaded vk verifies them; with a
    named advice column too it commits the same advice as synthesis;
  * Params.read's decompression of the SRS on the device against the
    transcript's host point decoder.

Tolerance: none — bytes and integers are compared for equality with
tests/data/torch_golden_multi.json (written by
tests/data/gen_torch_golden.py).
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from halo2_tpu.io.cs_format import read_cs as j_read_cs
from halo2_tpu.plonk.pinned import pinned_cs_str as j_pinned_cs_str

from halo2_tpu_torch.circuits import SimpleCircuit
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fr
from halo2_tpu_torch.io import (load_circuit_data, load_params, load_vk,
                                load_witness, save_circuit_data, save_params,
                                save_vk, save_witness)
from halo2_tpu_torch.io.cs_format import read_cs, write_cs
from halo2_tpu_torch.plonk import Circuit
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.pinned import pinned_cs_str
from halo2_tpu_torch.plonk.prover import (create_proof,
                                          create_proof_from_witness,
                                          create_witness)
from halo2_tpu_torch.plonk.verifier import verify_proof
from halo2_tpu_torch.poly.commitment import Params

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_multi.json")


@pytest.fixture(scope="module")
def files():
    with open(GOLDEN) as fh:
        return json.load(fh)["files"]


@pytest.fixture(scope="module")
def port(files):
    params = Params.unsafe_setup(files["k"], seed=files["params_seed"],
                                 device="cpu")
    vk, pk = keygen(params, SimpleCircuit(), device="cpu")
    return {"params": params, "vk": vk, "pk": pk}


def _written(tmp_path, name, hex_):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(bytes.fromhex(hex_))
    return path


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _jax_circuit_data(tmp_path, files) -> str:
    """The JAX package's circuit-data file, from its recorded arrays."""
    arrays = {key: np.asarray(rec["values"], dtype=rec["dtype"]).reshape(
        rec["shape"]) for key, rec in files["circuit_data"].items()}
    path = str(tmp_path / "jax_cd.npz")
    np.savez(path, **arrays)
    return path


def test_params_file_bytes_equal_and_load(port, files, tmp_path):
    path = str(tmp_path / "params.bin")
    save_params(port["params"], path)
    assert _read(path).hex() == files["params_hex"]
    back = load_params(_written(tmp_path, "jax.bin", files["params_hex"]),
                       device="cpu")
    buf = io.BytesIO()
    back.write(buf)
    assert buf.getvalue().hex() == files["params_hex"]
    assert torch.equal(back.g_lagrange, port["params"].g_lagrange)


def test_vk_file_bytes_equal_and_load(port, files, tmp_path):
    path = str(tmp_path / "vk.bin")
    save_vk(port["vk"], path)
    assert _read(path).hex() == files["vk_hex"]
    back = load_vk(port["params"], SimpleCircuit(),
                   _written(tmp_path, "jax_vk.bin", files["vk_hex"]))
    assert back.fixed_commitments == port["vk"].fixed_commitments
    assert back.permutation.commitments == port["vk"].permutation.commitments
    assert back.pinned() == port["vk"].pinned()
    with pytest.raises(ValueError, match="trailing"):
        load_vk(port["params"], SimpleCircuit(),
                _written(tmp_path, "long.bin", files["vk_hex"] + "00"))


def test_circuit_data_arrays_equal(port, files, tmp_path):
    path = str(tmp_path / "cd.npz")
    save_circuit_data(port["pk"], path)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(files["circuit_data"])
        for key, rec in files["circuit_data"].items():
            assert str(data[key].dtype) == rec["dtype"], key
            assert list(data[key].shape) == rec["shape"], key
            assert data[key].reshape(-1).tolist() == rec["values"], key
        # the JAX package reads the port's cs blob to its own CS
        cs = j_read_cs(data["cs_blob"].tobytes())
    assert j_pinned_cs_str(cs) == pinned_cs_str(port["vk"].cs)


def test_cs_wire_round_trip(port, files):
    blob = write_cs(port["vk"].cs)
    values = files["circuit_data"]["cs_blob"]["values"]
    assert blob == bytes(values)
    cs2 = read_cs(blob)
    assert pinned_cs_str(cs2) == pinned_cs_str(port["vk"].cs)
    assert write_cs(cs2) == blob
    assert cs2.blinding_factors() == port["vk"].cs.blinding_factors()
    with pytest.raises(ValueError):
        read_cs(b"XXXX" + blob[4:])


def test_jax_circuit_data_rebuilds_the_key(port, files, tmp_path):
    vk2, pk2 = load_circuit_data(port["params"],
                                 _jax_circuit_data(tmp_path, files))
    assert vk2.pinned() == port["vk"].pinned()
    assert vk2.fixed_commitments == port["vk"].fixed_commitments
    pk = port["pk"]
    for name in ("fixed_lagrange", "fixed_coeff", "l0_coeff", "l_last_coeff",
                 "l_blind_coeff"):
        assert torch.equal(getattr(pk2, name), getattr(pk, name)), name
    assert torch.equal(pk2.permutation_pk.sigmas_coeff,
                       pk.permutation_pk.sigmas_coeff)
    assert pk2.config is None


def test_tampered_circuit_data_rejected(port, files, tmp_path):
    path = _jax_circuit_data(tmp_path, files)
    data = dict(np.load(path))
    cs = read_cs(data["cs_blob"].tobytes())
    cs.num_advice_columns += 1        # a structural change: another vk
    cs.num_advice_queries.append(0)
    data["cs_blob"] = np.frombuffer(write_cs(cs), dtype=np.uint8).copy()
    tampered = str(tmp_path / "tampered.npz")
    np.savez(tampered, **data)
    with pytest.raises(ValueError, match="does not match"):
        load_circuit_data(port["params"], tampered)
    with pytest.raises(ValueError, match="k = "):
        load_circuit_data(Params.unsafe_setup(3, seed=1, device="cpu"), path)


def test_witness_file_bytes_equal(port, files, tmp_path):
    a, b = files["witness"]
    path = str(tmp_path / "w.bin")
    create_witness(port["pk"], SimpleCircuit(a, b), files["instances"], path)
    assert _read(path).hex() == files["witness_hex"]


def test_witness_file_loads(files, tmp_path):
    """The JAX package's witness file: the column values, their bit
    bounds, and the Montgomery limbs of the device encode."""
    blob = bytes.fromhex(files["witness_hex"])
    C = int.from_bytes(blob[:4], "little")
    n = (len(blob) - 4) // C // 32
    cols = [[int.from_bytes(blob[4 + (c * n + r) * 32: 4 + (c * n + r + 1)
                                 * 32], "little") for r in range(n)]
            for c in range(C)]
    adv, bits = load_witness(_written(tmp_path, "w.bin",
                                      files["witness_hex"]), device="cpu")
    F = fr("cpu")
    assert [F.decode(adv[:, c, :]) for c in range(C)] == cols
    assert bits == [max(max(col).bit_length(), 1) for col in cols]


def test_witness_values_at_or_above_p(tmp_path):
    """Big values are reduced mod p on writing (the reference's bigint
    export once wrote them unreduced), and a file holding one is refused
    on reading."""
    n = 4
    cols = [np.arange(n, dtype=np.uint64) * 7, [P - 3, P, P + 5, 2 ** 256 - 1]]
    path = str(tmp_path / "w.bin")
    save_witness(cols, path)
    blob = _read(path)
    stride = 32 * n
    assert len(blob) == 4 + 2 * stride
    assert blob[4 + 3 * 32: 4 + 4 * 32] == (21).to_bytes(32, "little")
    assert [int.from_bytes(blob[4 + stride + 32 * r: 4 + stride + 32 * r
                                + 32], "little") for r in range(n)] == \
        [P - 3, 0, 5, (2 ** 256 - 1) % P]
    adv, bits = load_witness(path, device="cpu")
    assert fr("cpu").decode(adv[:, 1, :]) == [P - 3, 0, 5, (2 ** 256 - 1) % P]
    assert bits == [5, (P - 3).bit_length()]
    raw = bytearray(blob)
    raw[4 + stride + 32: 4 + stride + 64] = P.to_bytes(32, "little")
    bad = str(tmp_path / "bad.bin")
    with open(bad, "wb") as fh:
        fh.write(bytes(raw))
    with pytest.raises(ValueError, match=">= p"):
        load_witness(bad, device="cpu")


@pytest.fixture(scope="module")
def split_proofs(port, files, tmp_path_factory):
    a, b = files["witness"]
    path = str(tmp_path_factory.mktemp("split") / "w.bin")
    create_witness(port["pk"], SimpleCircuit(a, b), files["instances"], path)
    seed = files["prover_seed"]
    return {
        "split": create_proof_from_witness(
            port["params"], port["pk"], files["instances"], path, seed=seed,
            device="cpu"),
        "direct": create_proof(port["params"], port["pk"],
                               SimpleCircuit(a, b), files["instances"],
                               seed=seed, device="cpu")}


def test_witness_split_equals_the_direct_proof(split_proofs, files):
    assert split_proofs["split"] == split_proofs["direct"]
    assert split_proofs["split"].hex() == files["proof_hex"]


def test_reloaded_vk_verifies_the_split_proof(port, files, split_proofs,
                                              tmp_path):
    path = str(tmp_path / "vk.bin")
    save_vk(port["vk"], path)
    vk = load_vk(load_params(_written(tmp_path, "p.bin",
                                      files["params_hex"]), device="cpu"),
                 SimpleCircuit(), path)
    pv = port["params"].verifier(1)
    assert verify_proof(pv, vk, files["instances"], split_proofs["split"])
    assert not verify_proof(pv, vk, [[files["instances"][0][0] + 1]],
                            split_proofs["split"])


def test_points_from_bytes_equals_the_host_decoder():
    """Params.read decompresses the SRS on the device: the same points as
    the transcript's host decoder, and the same refusals."""
    import random
    from halo2_tpu_torch.curves import g1, host
    from halo2_tpu_torch.transcript.blake2b import (point_from_bytes,
                                                    point_to_bytes)
    rng = random.Random(5)
    blobs = [point_to_bytes(host.random_point(rng)) for _ in range(24)]
    blobs += [point_to_bytes(None)]
    # x with a bit flipped: a point, or no square; x = q; x = 0 with sign
    blobs += [bytes(b ^ (1 << i) if j == 3 else b for j, b in enumerate(
        blobs[i])) for i in range(8)]
    blobs += [host.Q.to_bytes(32, "little"), bytes(31) + b"\x80"]
    valid = []
    for blob in blobs:
        try:
            want = point_from_bytes(blob)
        except ValueError:
            with pytest.raises(ValueError):
                g1.points_from_bytes(blob, "cpu")
            continue
        valid.append((blob, want))
    assert 25 < len(valid) < len(blobs) - 2
    got = g1.decode_points(g1.points_from_bytes(
        b"".join(b for b, _ in valid), "cpu"))
    assert got == [w for _, w in valid]


class _NamedAdviceCircuit(Circuit):
    """a == b on four rows; b is a named advice column (no blinding
    rows)."""

    def __init__(self, values=None):
        self.values = values

    def without_witnesses(self):
        return _NamedAdviceCircuit()

    def configure(self, meta):
        a = meta.advice_column()
        b = meta.named_advice_column("b")
        s = meta.selector()
        meta.create_gate("eq", lambda m: [("eq", m.query_selector(s) * (
            m.query_advice(a, 0) - m.query_advice(b, 0)))])
        return a, b, s

    def synthesize(self, config, layouter):
        a, b, s = config
        values = self.values or [None] * 4

        def fn(region):
            for row, v in enumerate(values):
                region.enable_selector("s", s, row)
                region.assign_advice("a", a, row, v)
                region.assign_advice("b", b, row, v)
        layouter.assign_region("eq", fn)


class _Captured(Exception):
    pass


def _advice_commitment_inputs(params, prove):
    """The columns and bounds of the prover's advice commitment (its second
    batched commitment, after the instances'); the proof stops there."""
    calls = []
    real = params.commit_many_affine

    def spy(columns, max_bits=None, base="coeff"):
        calls.append(base)
        if len(calls) == 2:
            raise _Captured([c.clone() for c in columns], list(max_bits))
        return real(columns, max_bits, base)
    params.commit_many_affine = spy
    try:
        prove()
    except _Captured as done:
        return done.args
    finally:
        del params.commit_many_affine
    raise AssertionError("the prover made no advice commitment")


def test_witness_split_leaves_named_advice_unblinded(tmp_path):
    """From a witness file the advice commitment takes the same columns
    (the same random blinding rows, none in the named column) and bounds
    as from synthesis: the reference's loaded-witness path blinds named
    advice columns too, so its proof there differs from create_proof's."""
    params = Params.unsafe_setup(4, seed=2, device="cpu")
    vk, pk = keygen(params, _NamedAdviceCircuit(), device="cpu")
    assert vk.cs.named_advices == [1]
    values = [5, 6, 7, 8]
    path = str(tmp_path / "w.bin")
    create_witness(pk, _NamedAdviceCircuit(values), [], path)
    direct = _advice_commitment_inputs(params, lambda: create_proof(
        params, pk, _NamedAdviceCircuit(values), [], seed=3, device="cpu"))
    split = _advice_commitment_inputs(
        params, lambda: create_proof_from_witness(params, pk, [], path,
                                                  seed=3, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(direct[0], split[0]))
    assert direct[1] == split[1]
    usable = vk.cs.usable_rows(params.n)
    assert fr("cpu").decode(split[0][1][:, usable:]) == \
        [0] * (params.n - usable)
    assert any(fr("cpu").decode(split[0][0][:, usable:]))
