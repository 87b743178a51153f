#!/usr/bin/env python3
"""Generate tests/data/torch_golden_proof.json,
tests/data/torch_golden_horner.json, tests/data/torch_golden_scan.json and
tests/data/torch_golden_args.json from the JAX package.

    JAX_PLATFORMS=cpu python3 tests/data/gen_torch_golden.py

Proves `tests/test_e2e.py`'s SimpleCircuit (K = 4, Params.unsafe_setup
seed 7, a = 3, b = 5) with halo2_tpu for the prover seeds 0 and 1 and
writes the proof bytes as hex, beside the bytes of `Params.write`, the
pinned verifying key and the transcript hash of the verifying key.  The
port must reproduce these: `chip_smoke.py` checks the proofs on the card,
tests/test_torch_prover.py checks all of them on the CPU and pins the file
against the live JAX package.

The second file holds the MSM's Horner combine over windows
(`halo2_tpu.msm.msm._combine_windows`, c = 4, three windows, two lanes,
one of them with an identity window) on numpy-seeded projective points:
the projective limbs the port's `_combine_windows` must reproduce
(tests/test_torch_chains.py).  The JAX call compiles for about 20 s on
the CPU, so the tests read its result from here.

The third holds the MSM's bucket scan of a window group
(`halo2_tpu.msm.sorted._prefix_scan_group`, `_bucket_ends` and
`_gather_boundary_prefix`, c = 4, block 4) on numpy-seeded points and
digits: for batches of windows at S = 5 and S = 1 steps a block, the
boundary prefixes E and the block totals as projective limbs, which the
port's scan and `window_totals` must reproduce
(tests/test_torch_msm_scan.py).  Each batch shape compiles for some 35 s
on the CPU.

The fourth holds the logup / shuffle / range-check slice (GWC proofs,
`args_golden`): the pinned vk and the proof bytes of
tests/test_lookup_shuffle.py's LookupShuffleCircuit (K = 5, params seed 99,
prover seed 3), tests/test_range_check.py's RangeCheckCircuit (K = 5, seed
21, prover seed 4) and examples/bench_all_args.py's AllArgsCircuit (K = 9,
seed 7, prover seed 0, FlatFloorPlanner, instance [[a0]]); the sha256 of
tests/test_plonk_api.py's pinned vk (keygen only); and module vectors of
`halo2_tpu.plonk.logup_prover` (`_multiplicities_device` on a table with
repeated entries, `multiplicities` + `commit_zs` over two input sets) and
`shuffle_prover.commit_product` over two units, at n = 32, as canonical
integers (tests/test_torch_args.py, tests/test_torch_args_prover.py).
"""

import functools
import hashlib
import importlib
import io
import json
import os
import random
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import tests.conftest  # noqa: E402,F401  (the test suite's JAX settings)
from halo2_tpu.plonk.keygen import keygen  # noqa: E402
from halo2_tpu.plonk.prover import create_proof  # noqa: E402
from halo2_tpu.poly.commitment import Params  # noqa: E402
from halo2_tpu.transcript import Blake2bWrite  # noqa: E402
from tests.test_e2e import K, SimpleCircuit, expected_out  # noqa: E402

PARAMS_SEED = 7
A, B = 3, 5
PROVER_SEEDS = (0, 1)
HORNER_C, HORNER_W, HORNER_LANES, HORNER_SEED = 4, 3, 2, 3
SCAN_C, SCAN_BLOCK, SCAN_SEED, SCAN_MAX_BITS = 4, 4, 5, 16
# (steps a block, the digits of each window of the batch): one of
# "random", "one bucket" (every digit equal), "0 and top" (digits 0 and
# 2^(c-1) only), "all negative" (every sign set), "gaps" (empty buckets
# between full ones), "scalars" (the signed digits of random scalars below
# 2^SCAN_MAX_BITS, all windows of them)
SCAN_BATCHES = ((5, ("random", "one bucket", "0 and top", "all negative",
                     "gaps")),
                (5, ("scalars",)),
                (1, ("random", "one bucket", "gaps")))


def params_bytes(params) -> bytes:
    buf = io.BytesIO()
    params.write(buf)
    return buf.getvalue()


def vk_hash(vk, transcript_cls) -> bytes:
    """The transcript state after absorbing the vk, squeezed to bytes."""
    t = transcript_cls()
    vk.hash_into(t)
    return t.squeeze_challenge().to_bytes(32, "little")


def golden_of(params, vk, proofs) -> dict:
    """The golden record of the JAX package's SRS, key and proofs."""
    return {"circuit": "tests/test_e2e.py::SimpleCircuit", "k": K,
            "params_seed": PARAMS_SEED, "a": A, "b": B,
            "params_hex": params_bytes(params).hex(),
            "pinned_vk": vk.pinned(),
            "vk_hash_hex": vk_hash(vk, Blake2bWrite).hex(),
            "proofs": {str(s): p.hex() for s, p in proofs.items()}}


def horner_inputs():
    """lanes x windows projective points (X, Y, Z) as canonical ints: random
    multiples of the generator with a random Z; lane 1's window 1 is the
    identity (0 : 1 : 0)."""
    from halo2_tpu.curves import host
    from halo2_tpu.fields.bn254 import FQ_MODULUS as Q
    rng = np.random.default_rng(HORNER_SEED)
    lanes = []
    for lane in range(HORNER_LANES):
        wins = []
        for w in range(HORNER_W):
            if (lane, w) == (1, 1):
                wins.append([0, 1, 0])
                continue
            k = int.from_bytes(rng.bytes(32), "little")
            z = int.from_bytes(rng.bytes(40), "little") % (Q - 1) + 1
            x, y = host.mul(host.G1_GEN, k)
            wins.append([x * z % Q, y * z % Q, z])
        lanes.append(wins)
    return lanes


def horner_golden() -> dict:
    """The JAX package's Horner combine of `horner_inputs()`, per lane, as
    the integers its Montgomery limb words spell."""
    from halo2_tpu.fields.bn254 import Fq
    from halo2_tpu.fields.limbs import limbs_to_int
    jmsm = importlib.import_module("halo2_tpu.msm.msm")
    lanes = horner_inputs()
    out = []
    for wins in lanes:
        totals = tuple(Fq.encode([p[i] for p in wins]) for i in range(3))
        acc = jmsm._combine_windows(totals, HORNER_C)
        out.append([limbs_to_int(np.asarray(c)) for c in acc])
    return {"c": HORNER_C, "windows": HORNER_W, "seed": HORNER_SEED,
            "inputs": lanes, "outputs_mont_words": out}


def _scan_windows(rng, kinds, n):
    """(mag, neg, scalars): (G, n) digits and signs of each window kind;
    the scalars (as ints) where the kind is "scalars"."""
    import jax.numpy as jnp
    from halo2_tpu.fields.limbs import ints_to_limbs_np
    from halo2_tpu.msm import sorted as jsorted
    nb = (1 << (SCAN_C - 1)) + 1
    if kinds == ("scalars",):
        scalars = [int(v) for v in rng.integers(0, 1 << SCAN_MAX_BITS, n)]
        scalars[:3] = [0, 1, (1 << SCAN_MAX_BITS) - 1]
        w = jsorted.num_windows_for(SCAN_MAX_BITS, SCAN_C)
        mag, neg = jsorted._signed_digits(
            jnp.asarray(ints_to_limbs_np(scalars)), w, SCAN_C)
        return np.asarray(mag), np.asarray(neg).astype(np.int32), scalars
    mags, negs = [], []
    for kind in kinds:
        neg = rng.integers(0, 2, n)
        if kind == "one bucket":
            mag = np.full(n, 3)
        elif kind == "0 and top":
            mag = rng.integers(0, 2, n) * (nb - 1)
        elif kind == "all negative":
            mag, neg = rng.integers(0, nb, n), np.ones(n, np.int64)
        elif kind == "gaps":
            mag = np.array([2, 6])[rng.integers(0, 2, n)]
        else:
            mag = rng.integers(0, nb, n)
        mags.append(mag)
        negs.append(neg)
    return (np.stack(mags).astype(np.int32), np.stack(negs).astype(np.int32),
            None)


def scan_golden() -> dict:
    """The JAX package's bucket scan of SCAN_BATCHES: per batch the inputs
    (points, digits, signs, the stable sort's order) and the outputs as the
    integers the Montgomery limb words spell."""
    import jax
    import jax.numpy as jnp
    from halo2_tpu.curves import g1 as jg1
    from halo2_tpu.curves import host
    from halo2_tpu.fields.limbs import N_LIMBS, limbs_to_int
    from halo2_tpu.msm import sorted as jsorted

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def scan(rows, order, key, block, nb):
        G, n = key.shape
        S = n // block
        idx = order.reshape(G, block, S).transpose(2, 0, 1)
        pk = jnp.take(rows, idx.reshape(-1), axis=0).reshape(
            S, G, block, N_LIMBS)
        sg = (key & 1).astype(bool).reshape(G, block, S).transpose(2, 0, 1)
        intra, excl = jsorted._prefix_scan_group(pk, sg)
        ends = jsorted._bucket_ends(key >> 1, nb)
        e_pts = jsorted._gather_boundary_prefix(intra, excl, ends, block, n)
        return e_pts, tuple(c[-1].transpose(2, 0, 1) for c in intra)

    def words(c):
        """(16, *B) limbs -> nested lists over *B of the ints they spell."""
        c = np.asarray(c)
        if c.ndim == 2:
            return [limbs_to_int(c[:, i]) for i in range(c.shape[1])]
        return [words(c[:, i]) for i in range(c.shape[1])]

    rng = np.random.default_rng(SCAN_SEED)
    nb = (1 << (SCAN_C - 1)) + 1
    batches = []
    for S, kinds in SCAN_BATCHES:
        n = S * SCAN_BLOCK
        pts = [host.mul(host.G1_GEN, int(k))
               for k in rng.integers(1, 1 << 62, n)]
        mag, neg, scalars = _scan_windows(rng, kinds, n)
        key = (mag << 1) | neg
        order = np.argsort(key, axis=1, kind="stable")
        dev = jg1.encode_points(pts)
        rows = np.asarray(jsorted._pack_xy(dev[0], dev[1])).T.copy()
        e_pts, totals = scan(jnp.asarray(rows), jnp.asarray(order),
                             jnp.asarray(np.take_along_axis(key, order, 1)),
                             SCAN_BLOCK, nb)
        batches.append({
            "S": S, "kinds": list(kinds), "points": [list(p) for p in pts],
            "mag": mag.tolist(), "neg": neg.tolist(),
            "order": order.tolist(), "scalars": scalars,
            "e_pts_mont_words": [words(c) for c in e_pts],
            "block_totals_mont_words": [words(c) for c in totals]})
    return {"c": SCAN_C, "block": SCAN_BLOCK, "seed": SCAN_SEED,
            "max_bits": SCAN_MAX_BITS, "batches": batches}


# the argument circuits: name -> (where the circuit lives, K, params seed,
# prover seed)
ARGS_CIRCUITS = {
    "lookup_shuffle": ("tests/test_lookup_shuffle.py::LookupShuffleCircuit",
                       5, 99, 3),
    "range_check": ("tests/test_range_check.py::RangeCheckCircuit", 5, 21, 4),
    "all_args": ("examples/bench_all_args.py::AllArgsCircuit", 9, 7, 0),
}
# the module vectors: n rows, bf blinding rows, numpy / random seeds
ARGS_N, ARGS_BF, ARGS_SEED = 32, 3, 11


def args_circuit(name):
    """(empty circuit, circuit with its witness, instances, floor planner)
    of one argument circuit, from the JAX package's tests and examples."""
    if name == "lookup_shuffle":
        from tests.test_lookup_shuffle import (VALS_A, VALS_B,
                                               LookupShuffleCircuit)
        return (LookupShuffleCircuit(), LookupShuffleCircuit(VALS_A, VALS_B),
                [], None)
    if name == "range_check":
        from tests.test_range_check import VALUES, RangeCheckCircuit
        return RangeCheckCircuit(), RangeCheckCircuit(VALUES), [], None
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from bench_all_args import AllArgsCircuit
    from halo2_tpu.circuit import FlatFloorPlanner
    from halo2_tpu.plonk.circuit import ConstraintSystem
    k = ARGS_CIRCUITS[name][1]
    cs = ConstraintSystem()
    AllArgsCircuit(1).configure(cs)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    rows = cs.usable_rows(1 << k)
    a0 = int(np.random.RandomState(5).randint(0, 16, size=1)[0])
    return (AllArgsCircuit(rows), AllArgsCircuit(rows), [[a0]],
            FlatFloorPlanner)


def args_proof_record(name, vk, instances, proof: bytes) -> dict:
    where, k, params_seed, prover_seed = ARGS_CIRCUITS[name]
    return {"circuit": where, "k": k, "params_seed": params_seed,
            "prover_seed": prover_seed, "instances": instances,
            "pinned_vk": vk.pinned(), "proof_hex": proof.hex()}


def args_proof(name) -> dict:
    """The JAX package's key and GWC proof of one argument circuit."""
    _, k, params_seed, prover_seed = ARGS_CIRCUITS[name]
    empty, full, instances, planner = args_circuit(name)
    params = Params.unsafe_setup(k, seed=params_seed)
    vk, pk = keygen(params, empty, floor_planner=planner)
    proof = create_proof(params, pk, full, instances, seed=prover_seed,
                         floor_planner=planner)
    return args_proof_record(name, vk, instances, proof)


def plonk_api_pinned_sha256() -> str:
    from tests.test_plonk_api import K as PK, LOOKUP_TABLE, MyCircuit
    params = Params.unsafe_setup(PK, seed=42)
    vk, _ = keygen(params, MyCircuit(None, LOOKUP_TABLE))
    return hashlib.sha256(vk.pinned().encode()).hexdigest()


def _field_ints(rng, count):
    """count random field elements, with 0, 1 and p - 1 among them."""
    from halo2_tpu.fields.bn254 import Fr
    vals = [int.from_bytes(rng.bytes(32), "little") % Fr.p
            for _ in range(count)]
    vals[:3] = [0, 1, Fr.p - 1]
    return vals


def multiplicity_cases() -> list:
    """Tables with repeated entries (small values, p - 1 twice, a 200-bit
    value) and inputs drawn from them with repeats; the second case has
    one input missing from its table."""
    from halo2_tpu.fields.bn254 import Fr
    rng = np.random.default_rng(ARGS_SEED)
    u = ARGS_N - (ARGS_BF + 1)
    cases = []
    for missing in (False, True):
        table = [int(v) for v in rng.integers(0, 12, u)]
        table[3] = table[10] = Fr.p - 1
        table[7] = (1 << 200) + 3
        inputs = [table[int(i)] for i in rng.integers(0, u, 2 * u)]
        if missing:
            inputs[5] = 99
        cases.append({"table": table, "inputs": inputs})
    return cases


def logup_golden() -> dict:
    """`_multiplicities_device` on `multiplicity_cases()`, and one lookup's
    m(X) and grand sums over two input sets (two inputs, then one) through
    `multiplicities` + `commit_zs`, one random.Random drawing both."""
    import jax.numpy as jnp
    from halo2_tpu.fields.bn254 import Fr
    from halo2_tpu.fields.limbs import ints_to_limbs_np
    from halo2_tpu.plonk import logup_prover as lp
    cases = multiplicity_cases()
    for case in cases:
        m_std, ok, max_count = lp._multiplicities_device(
            jnp.asarray(ints_to_limbs_np(case["table"])),
            jnp.asarray(ints_to_limbs_np(case["inputs"])))
        m_std = np.asarray(m_std)
        case.update(counts=[int(v) for v in m_std[0] | (m_std[1] << 16)],
                    ok=bool(ok), max_count=int(max_count))
    n, bf = ARGS_N, ARGS_BF
    u = n - (bf + 1)
    rng_np = np.random.default_rng(ARGS_SEED + 1)
    table = _field_ints(rng_np, u) + [0] * (bf + 1)
    sets = [[[table[int(i)] for i in rng_np.integers(0, u, u)]
             + [int(v) for v in rng_np.integers(0, 1 << 16, bf + 1)]
             for _ in range(width)] for width in (2, 1)]
    beta = int.from_bytes(rng_np.bytes(32), "little") % Fr.p
    rng = random.Random(ARGS_SEED)
    dev = [[jnp.asarray(Fr.encode(c)) for c in s] for s in sets]
    m_lag, m_bits = lp.multiplicities(
        jnp.asarray(Fr.encode(table)), [c for s in dev for c in s], u, rng,
        bf)
    zs = lp.commit_zs(types.SimpleNamespace(n=n), _Blinding(bf),
                      jnp.asarray(Fr.encode(table)), dev, m_lag, beta, rng)
    return {"multiplicities": cases,
            "grand_sums": {"n": n, "bf": bf, "rng_seed": ARGS_SEED,
                           "table": table, "sets": sets, "beta": beta,
                           "m": Fr.decode(np.asarray(m_lag)),
                           "m_bits": m_bits,
                           "zs": [Fr.decode(np.asarray(z)) for z in zs]}}


class _Blinding:
    """The one thing commit_zs / commit_product ask of a constraint
    system."""

    def __init__(self, bf):
        self.bf = bf

    def blinding_factors(self):
        return self.bf


def shuffle_golden() -> dict:
    """`commit_product` of one group of two units: each unit's shuffle
    column a permutation of its input column on the usable rows."""
    import jax.numpy as jnp
    from halo2_tpu.fields.bn254 import Fr
    from halo2_tpu.plonk import shuffle_prover as sp
    n, bf = ARGS_N, ARGS_BF
    u = n - (bf + 1)
    rng_np = np.random.default_rng(ARGS_SEED + 2)
    inputs = [_field_ints(rng_np, n) for _ in range(2)]
    shuffles = []
    for col in inputs:
        perm = rng_np.permutation(u)
        shuffles.append([col[int(i)] for i in perm]
                        + _field_ints(rng_np, n)[3:3 + n - u])
    beta = int.from_bytes(rng_np.bytes(32), "little") % Fr.p
    z = sp.commit_product(types.SimpleNamespace(n=n), _Blinding(bf),
                          [jnp.asarray(Fr.encode(c)) for c in inputs],
                          [jnp.asarray(Fr.encode(c)) for c in shuffles],
                          beta, random.Random(ARGS_SEED))
    return {"n": n, "bf": bf, "rng_seed": ARGS_SEED, "inputs": inputs,
            "shuffles": shuffles, "beta": beta,
            "z": Fr.decode(np.asarray(z))}


def args_golden() -> dict:
    return {"proofs": {name: args_proof(name) for name in ARGS_CIRCUITS},
            "plonk_api_pinned_vk_sha256": plonk_api_pinned_sha256(),
            "logup": logup_golden(), "shuffle": shuffle_golden()}


def _write(name: str, record: dict):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main():
    _write("torch_golden_args.json", args_golden())
    _write("torch_golden_scan.json", scan_golden())
    _write("torch_golden_horner.json", horner_golden())
    params = Params.unsafe_setup(K, seed=PARAMS_SEED)
    vk, pk = keygen(params, SimpleCircuit())
    out = expected_out(A, B)
    proofs = {s: create_proof(params, pk, SimpleCircuit(A, B), [[out]],
                              seed=s) for s in PROVER_SEEDS}
    _write("torch_golden_proof.json", golden_of(params, vk, proofs))


if __name__ == "__main__":
    main()
