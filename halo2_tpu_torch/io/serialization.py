"""Persistence: params / keys / witness to disk.

The reference's L7: `Params::write/read` (poly/commitment.rs:241-294 —
byte-compatible in poly/commitment.py), `CircuitData` {vkey, fixed,
permutation} (plonk.rs:126-204), and the witness store/fetch pipeline
(helpers.rs:919-1014) that lets witness generation run on a cheap machine
while proving runs on the card.

The files are those of the JAX package, byte for byte where they are
bytes: big arrays go into numpy `.npz` containers as `uint32` arrays of
16-bit Montgomery limbs (the port's int32 words, viewed), and the full
post-compression ConstraintSystem travels inside the circuit-data file in
the tagged wire format of io/cs_format.py — loading circuit data does not
re-run `configure`; the vk digest is still checked."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from halo2_tpu_torch import native
from halo2_tpu_torch.fields.bn254 import FR_MODULUS, fr
from halo2_tpu_torch.fields.limbs import N_LIMBS, to_numpy
from halo2_tpu_torch.utils.device import require_device

P = FR_MODULUS


# -- params ------------------------------------------------------------------

def save_params(params, path: str) -> None:
    with open(path, "wb") as fh:
        params.write(fh)


def load_params(path: str, device="cuda"):
    from halo2_tpu_torch.poly.commitment import Params
    with open(path, "rb") as fh:
        return Params.read(fh, device=device)


# -- circuit data (fixed + permutation assembly + vk identity) ---------------

def _vk_digest(vk) -> bytes:
    return hashlib.blake2b(vk.pinned().encode(), digest_size=32).digest()


def save_circuit_data(pk, path: str) -> None:
    """Everything needed to rebuild a ProvingKey without keygen's synthesis
    or configure(): the serialized ConstraintSystem, the fixed and sigma
    Lagrange columns, the domain degree and the vk digest (plonk.rs
    CircuitData::write + helpers.rs write_cs)."""
    from halo2_tpu_torch.io.cs_format import write_cs
    np.savez(
        path,
        k=np.int64(pk.vk.k),
        domain_degree=np.int64(pk.vk.domain.quotient_poly_degree + 1),
        cs_blob=np.frombuffer(write_cs(pk.vk.cs), dtype=np.uint8).copy(),
        fixed_lagrange=to_numpy(pk.fixed_lagrange),
        sigmas_lagrange=to_numpy(pk.permutation_pk.sigmas_lagrange),
        vk_pinned_hash=np.frombuffer(_vk_digest(pk.vk),
                                     dtype=np.uint8).copy(),
    )


def load_circuit_data(params, path: str):
    """Rebuild (vk, pk) on `params`' device from saved circuit data alone
    (keygen_pk_from_info, keygen.rs:458-608 + CircuitData::read,
    plonk.rs:126-204): the constraint system comes from the embedded blob,
    the commitments are made anew and the vk digest must match the file's
    (ValueError otherwise)."""
    from halo2_tpu_torch.convert import limbs_from_numpy
    from halo2_tpu_torch.io.cs_format import read_cs
    from halo2_tpu_torch.plonk import permutation as perm_mod
    from halo2_tpu_torch.plonk.keygen import (ProvingKey, VerifyingKey,
                                              l_polys_coeff)
    from halo2_tpu_torch.poly.domain import EvaluationDomain

    device = params.device
    with np.load(path) as data:
        cs = read_cs(data["cs_blob"].tobytes())
        degree = int(data["domain_degree"])
        k = int(data["k"])
        fixed_np = data["fixed_lagrange"]
        sigmas_np = data["sigmas_lagrange"]
        digest = data["vk_pinned_hash"].tobytes()
    if k != params.k:
        raise ValueError(f"circuit data is for k = {k}, params for "
                         f"k = {params.k}")
    domain = EvaluationDomain(degree, k, device)

    def columns(arr):
        lag = limbs_from_numpy(arr, device)
        if lag.shape[1] == 0:
            return lag, lag, []
        coms = params.commit_many_affine(
            [lag[:, i, :] for i in range(lag.shape[1])], base="lagrange")
        return lag, domain.ntt.inverse(lag), coms

    fixed_lagrange, fixed_coeff, fixed_commitments = columns(fixed_np)
    sig_lag, sig_coeff, perm_commitments = columns(sigmas_np)
    vk = VerifyingKey(domain, cs, fixed_commitments,
                      perm_mod.PermutationVk(perm_commitments), k)
    if _vk_digest(vk) != digest:
        raise ValueError("circuit data does not match this circuit/params")
    l0, l_last, l_blind = l_polys_coeff(domain, cs.blinding_factors())
    pk = ProvingKey(vk, fixed_lagrange, fixed_coeff,
                    perm_mod.PermutationPk(sig_lag, sig_coeff),
                    l0, l_last, l_blind)
    return vk, pk


# -- verifying key -----------------------------------------------------------

def save_vk(vk, path: str) -> None:
    """VerifyingKey::write (plonk.rs:60-67): compressed fixed commitments
    followed by the permutation vk commitments."""
    from halo2_tpu_torch.transcript.blake2b import point_to_bytes
    with open(path, "wb") as fh:
        for c in vk.fixed_commitments:
            fh.write(point_to_bytes(c))
        for c in vk.permutation.commitments:
            fh.write(point_to_bytes(c))


def load_vk(params, circuit, path: str, floor_planner=None):
    """VerifyingKey::read (plonk.rs:69-88): re-derive the constraint system
    from the circuit's configure() (and its selector layout under the
    floor planner keygen used), then read the commitment points."""
    from halo2_tpu_torch.plonk import permutation as perm_mod
    from halo2_tpu_torch.plonk.keygen import VerifyingKey, rebuild_cs
    from halo2_tpu_torch.poly.domain import EvaluationDomain
    from halo2_tpu_torch.transcript.blake2b import point_from_bytes

    cs, _, degree = rebuild_cs(circuit, params.n, floor_planner)
    domain = EvaluationDomain(degree, params.k, params.device)
    with open(path, "rb") as fh:
        fixed = [point_from_bytes(fh.read(32))
                 for _ in range(cs.num_fixed_columns)]
        perm = [point_from_bytes(fh.read(32))
                for _ in cs.permutation.columns]
        if fh.read(1):
            raise ValueError("trailing bytes in verifying key file")
    return VerifyingKey(domain, cs, fixed, perm_mod.PermutationVk(perm),
                        params.k)


# -- witness store / fetch ---------------------------------------------------

def save_witness(advice_cols: list, path: str) -> None:
    """Store advice columns in the reference's strided layout
    (helpers.rs:919-1014 store_witness): a u32-le column count, then one
    slab per column at byte stride 32 * n, each value canonical 32-byte
    little-endian.  Written column by column through a memory map, so the
    whole witness is never in memory twice.  A column is a uint64 numpy
    array or a list of ints; ints are reduced mod p first."""
    n = len(advice_cols[0]) if advice_cols else 0
    stride = 32 * n
    with open(path, "wb") as fh:
        fh.write(len(advice_cols).to_bytes(4, "little"))
        fh.truncate(4 + len(advice_cols) * stride)
    for i, col in enumerate(advice_cols):
        if len(col) != n:
            raise ValueError("witness columns differ in length")
        mm = np.memmap(path, dtype=np.uint8, mode="r+",
                       offset=4 + i * stride, shape=(stride,))
        if isinstance(col, np.ndarray) and col.dtype == np.uint64:
            quad = mm.view("<u8").reshape(n, 4)
            quad[:, 0] = col                 # below 2^64 < p: canonical
            quad[:, 1:] = 0
        else:
            mm[:] = np.frombuffer(native.longs_to_blob(col, P),
                                  dtype=np.uint8)
        mm.flush()
        del mm


def load_witness(path: str, device="cuda"):
    """((16, C, n) Montgomery advice limbs on `device`, per-column max bit
    length) from a strided witness file.  The file's column slabs are read
    into the staging buffer in one `readinto`, go up as they are (32 bytes
    a value) and are decoded by one launch (`Field.decode_le_rows`); one
    small read brings back each column's word maxima, which bound its
    bits, and its >= p flag.  A value >= p is rejected (ValueError)."""
    device = require_device(device)
    F = fr(device)
    size = os.path.getsize(path) - 4
    with open(path, "rb") as fh:
        C = int.from_bytes(fh.read(4), "little")
        if not C:
            return torch.zeros((N_LIMBS, 0, 0), dtype=torch.int32,
                               device=device), []
        stride = size // C
        if size % C or stride % 32:
            raise ValueError("witness file size does not fit its column "
                             "count")

        def fill(view):
            if fh.readinto(view) != view.size:
                raise ValueError("witness file ends early")
        adv, stats = F.decode_le_rows(fill, C, stride // 32)
    bits = []
    for i, (*maxima, ge) in enumerate(stats.cpu().numpy().view(np.uint64)):
        if ge:
            raise ValueError(f"witness column {i} holds a value >= p")
        high = [w for w in (1, 2, 3) if maxima[w]]
        if high:
            # the highest non-zero word w with max m bounds every value
            # below (m + 1) 2^(64 w), and one reaches m 2^(64 w)
            w = high[-1]
            bits.append(64 * w + int(maxima[w]).bit_length())
        else:
            bits.append(max(int(maxima[0]).bit_length(), 1))
    return adv, bits
