#!/usr/bin/env python3
"""Generate tests/data/torch_golden_proof.json,
tests/data/torch_golden_horner.json, tests/data/torch_golden_scan.json,
tests/data/torch_golden_args.json, tests/data/torch_golden_multi.json and
tests/data/torch_golden_synth.json from the JAX package.

    JAX_PLATFORMS=cpu python3 tests/data/gen_torch_golden.py [multi|synth|mesh]

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

The fifth (`multi` writes it alone, about 24 min) holds the multi-instance
and SHPLONK proofs with their pinned vks: the two-instance GWC proof of
tests/test_e2e.py::test_multi_instance_proof (seed 11), the SHPLONK
proofs of tests/test_shplonk.py (SimpleCircuit seed 0,
LookupShuffleCircuit seed 3) and of a lookup_any circuit, and the
two-instance GWC and SHPLONK proofs of tests/test_plonk_api.py (seed 0);
the bytes of the JAX package's params, vk and witness files and the
arrays of its circuit-data file for SimpleCircuit at K = 4, with the proof
from that witness file (seed 5); and `shplonk._construct_intermediate_sets`
on a recorded query list (tests/test_torch_multi.py,
tests/test_torch_shplonk.py, tests/test_torch_io.py).  Each part runs in a
process of its own.

The seventh (`mesh` writes it alone, each part in a process of its own)
holds the multi-device path on conftest's 8-device virtual CPU mesh:
`ntt.distributed.DistNTT` forward (column by column), inverse and
inverse_nodiv (two columns at once) at log_n 8 and 10; `msm_sharded` over
256 points, full scalars, 16-bit scalars with max_bits 16, and on the 2-D
(2 x 4) mesh, as affine points; `ShardedEvaluator.evaluate_h` on
tests/test_sharded_prover.py's K = 6 setup and random inputs; the sharded
SimpleCircuit K = 6 proof (seed 0, equal to the unsharded one) and the
LookupShuffleCircuit K = 6 proof (params seed 99, prover seed 3).  The
transforms and h are stored as the sha256 of their canonical integers
(`ints_sha256`) with their first values; their inputs come from
`mesh_field_ints` (tests/test_torch_distributed.py,
tests/test_torch_sharded_prover.py).

The sixth (`synth` writes it alone) holds the pinned vk, the GWC proof
and the sha256 of the witness file of halo2_tpu_torch.circuits'
BlockMulChainCircuit at K = 5 (four blocks, a = 3, b = 1000003, params
seed 7, prover seed 1, FlatFloorPlanner): the bytes the port must give
with its regions synthesized in turn and in forked workers
(tests/test_torch_parallel_synthesis.py).
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
from halo2_tpu.plonk import Circuit  # noqa: E402
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


# the multi-circuit / SHPLONK / file records (torch_golden_multi.json)
MULTI_SEED = 11          # tests/test_e2e.py::test_multi_instance_proof
MULTI_AB = ((3, 5), (2, 9))
PLONK_API_PARAMS_SEED, PLONK_API_SEED = 42, 0
WITNESS_AB, WITNESS_SEED = (4, 9), 5     # tests/test_serialization.py
SETS_SEED = 13


def _proof_record(circuit, k, params_seed, prover_seed, instances, use_gwc,
                  proof, vk) -> dict:
    return {"circuit": circuit, "k": k, "params_seed": params_seed,
            "prover_seed": prover_seed, "instances": instances,
            "use_gwc": use_gwc, "pinned_vk": vk.pinned(),
            "proof_hex": proof.hex()}


class LookupAnyCircuit(Circuit):
    """One advice column looked up in one fixed column (`lookup_any`), as
    halo2_tpu_torch.circuits.LookupAnyCircuit: the fixed column holds
    TABLE, the advice column `values`."""

    TABLE = [0, 1, 2, 3, 4, 5, 6, 7]
    VALUES = [3, 1, 4, 1, 5, 7, 2, 6]

    def __init__(self, values=None):
        self.values = values

    def without_witnesses(self):
        return LookupAnyCircuit()

    def configure(self, meta):
        a = meta.advice_column()
        t = meta.fixed_column()
        meta.lookup_any("in_table", lambda m: [(m.query_advice(a, 0),
                                                m.query_fixed(t, 0))])
        return a, t

    def synthesize(self, config, layouter):
        a, t = config
        values = self.values or [None] * len(self.VALUES)

        def fn(region):
            for row, v in enumerate(self.TABLE):
                region.assign_fixed("t", t, row, v)
            for row, v in enumerate(values):
                region.assign_advice("a", a, row, v)
        layouter.assign_region("lookup_any", fn)


def _simple_key():
    params = Params.unsafe_setup(K, seed=PARAMS_SEED)
    return (params,) + keygen(params, SimpleCircuit())


def _e2e_multi_gwc() -> dict:
    """tests/test_e2e.py::test_multi_instance_proof."""
    from halo2_tpu.plonk.prover import create_proof_multi
    params, vk, pk = _simple_key()
    insts = [[[expected_out(a, b)]] for a, b in MULTI_AB]
    proof = create_proof_multi(params, pk, [SimpleCircuit(a, b)
                                            for a, b in MULTI_AB],
                               insts, seed=MULTI_SEED)
    return dict(_proof_record("tests/test_e2e.py::SimpleCircuit", K,
                              PARAMS_SEED, MULTI_SEED, insts, True, proof,
                              vk), witnesses=[list(ab) for ab in MULTI_AB])


def _simple_shplonk() -> dict:
    """tests/test_shplonk.py::test_shplonk_prove_verify."""
    from halo2_tpu.plonk.prover import create_proof_multi
    params, vk, pk = _simple_key()
    inst = [[[expected_out(A, B)]]]
    proof = create_proof_multi(params, pk, [SimpleCircuit(A, B)], inst,
                               seed=0, use_gwc=False)
    return dict(_proof_record("tests/test_e2e.py::SimpleCircuit", K,
                              PARAMS_SEED, 0, inst, False, proof, vk),
                witnesses=[[A, B]])


def _lookup_any_shplonk() -> dict:
    from halo2_tpu.plonk.prover import create_proof_multi
    params = Params.unsafe_setup(K, seed=PARAMS_SEED)
    vk, pk = keygen(params, LookupAnyCircuit())
    proof = create_proof_multi(params, pk,
                               [LookupAnyCircuit(LookupAnyCircuit.VALUES)],
                               [[]], seed=0, use_gwc=False)
    return _proof_record("tests/data/gen_torch_golden.py::LookupAnyCircuit",
                         K, PARAMS_SEED, 0, [[]], False, proof, vk)


def _lookup_shuffle_shplonk() -> dict:
    """tests/test_shplonk.py::test_shplonk_with_lookups_shuffles."""
    from halo2_tpu.plonk.prover import create_proof_multi
    _, k, params_seed, seed = ARGS_CIRCUITS["lookup_shuffle"]
    empty, full, _, _ = args_circuit("lookup_shuffle")
    params = Params.unsafe_setup(k, seed=params_seed)
    vk, pk = keygen(params, empty)
    proof = create_proof_multi(params, pk, [full], [[]], seed=seed,
                               use_gwc=False)
    return _proof_record(
        "tests/test_lookup_shuffle.py::LookupShuffleCircuit", k, params_seed,
        seed, [[]], False, proof, vk)


def _plonk_api_multi(use_gwc: bool) -> dict:
    """tests/test_plonk_api.py: test_proof_gwc_single_and_batch and
    test_proof_shplonk (two instances, seed 0)."""
    from halo2_tpu.plonk.prover import create_proof_multi
    from tests.test_plonk_api import INSTANCE, LOOKUP_TABLE, A_VALUE
    from tests.test_plonk_api import K as PK, MyCircuit
    params = Params.unsafe_setup(PK, seed=PLONK_API_PARAMS_SEED)
    vk, pk = keygen(params, MyCircuit(None, LOOKUP_TABLE))
    insts = [[[INSTANCE]], [[INSTANCE]]]
    proof = create_proof_multi(
        params, pk, [MyCircuit(A_VALUE, LOOKUP_TABLE) for _ in insts], insts,
        seed=PLONK_API_SEED, use_gwc=use_gwc)
    return _proof_record("tests/test_plonk_api.py::MyCircuit", PK,
                         PLONK_API_PARAMS_SEED, PLONK_API_SEED, insts,
                         use_gwc, proof, vk)


def files_golden(tmp: str) -> dict:
    """The bytes of the JAX package's params, vk and witness files and the
    arrays of its circuit-data file, for SimpleCircuit at K = 4 (params seed
    7), and the proof from the witness file (seed 5), which equals the
    direct proof."""
    from halo2_tpu.io import serialization as ser
    from halo2_tpu.plonk.prover import (create_proof_from_witness,
                                        create_witness)
    params = Params.unsafe_setup(K, seed=PARAMS_SEED)
    vk, pk = keygen(params, SimpleCircuit())
    paths = {name: os.path.join(tmp, name)
             for name in ("params.bin", "vk.bin", "witness.bin", "cd.npz")}
    ser.save_params(params, paths["params.bin"])
    ser.save_vk(vk, paths["vk.bin"])
    a, b = WITNESS_AB
    inst = [[expected_out(a, b)]]
    create_witness(pk, SimpleCircuit(a, b), inst, paths["witness.bin"])
    ser.save_circuit_data(pk, paths["cd.npz"])
    proof = create_proof_from_witness(params, pk, inst, paths["witness.bin"],
                                      seed=WITNESS_SEED)
    direct = create_proof(params, pk, SimpleCircuit(a, b), inst,
                          seed=WITNESS_SEED)
    assert proof == direct
    data = np.load(paths["cd.npz"])
    arrays = {key: {"dtype": str(data[key].dtype),
                    "shape": list(data[key].shape),
                    "values": data[key].reshape(-1).tolist()}
              for key in data.files}

    def hex_of(name):
        with open(paths[name], "rb") as fh:
            return fh.read().hex()
    return {"k": K, "params_seed": PARAMS_SEED, "witness": list(WITNESS_AB),
            "instances": inst, "prover_seed": WITNESS_SEED,
            "params_hex": hex_of("params.bin"), "vk_hex": hex_of("vk.bin"),
            "witness_hex": hex_of("witness.bin"),
            "circuit_data": arrays, "proof_hex": proof.hex()}


class _Query:
    """A query of the recorded list: its commitment is an object of its
    own per label (two labels of equal value stay two objects)."""

    def __init__(self, point, rotation, commitment):
        self.point, self.rotation, self.commitment = point, rotation, \
            commitment


def sets_queries() -> list:
    """(label, value, rotation) of a verifier-like query stream: an advice
    column at two rotations, grand products at three, a column at -1, two
    fixed commitments with the same value, h and the random poly."""
    return [("instance", 1, 0), ("advice_a", 2, 0), ("advice_a", 2, 1),
            ("advice_b", 3, 0), ("advice_c", 4, -1), ("perm_z0", 5, 0),
            ("perm_z0", 5, 1), ("perm_z0", 5, -4), ("perm_z1", 6, 0),
            ("perm_z1", 6, 1), ("fixed_0", 7, 0), ("fixed_1", 7, 0),
            ("fixed_2", 8, -1), ("h", 9, 0), ("random", 10, 0)]


def intermediate_sets_golden() -> dict:
    """`shplonk._construct_intermediate_sets` on `sets_queries()` at random
    points of each rotation."""
    from halo2_tpu.fields.bn254 import Fr
    from halo2_tpu.multiopen import shplonk
    rng = np.random.default_rng(SETS_SEED)
    rows = sets_queries()
    points = {rot: int.from_bytes(rng.bytes(32), "little") % Fr.p
              for rot in sorted({r for _, _, r in rows})}
    objs = {}
    for label, value, _ in rows:
        objs.setdefault(label, ("point", value))   # equal values, own objects
    queries = [_Query(points[r], r, objs[label]) for label, _, r in rows]
    label_of = {id(o): label for label, o in objs.items()}
    sets, super_points = shplonk._construct_intermediate_sets(queries)
    return {"queries": [list(r) for r in rows],
            "points": {str(r): p for r, p in points.items()},
            "sets": [{"rotations": list(s["rotations"]),
                      "points": s["points"],
                      "commitments": [label_of[id(q.commitment)]
                                      for q in s["queries"]]}
                     for s in sets],
            "super_point_set": super_points}


def _files_part() -> dict:
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return files_golden(tmp)


# the parts of torch_golden_multi.json: the JAX package's multi-instance
# and SHPLONK proofs (one proof record each), its files, the intermediate
# sets
MULTI_PROOFS = {
    "e2e_multi_gwc": _e2e_multi_gwc,
    "simple_shplonk": _simple_shplonk,
    "lookup_any_shplonk": _lookup_any_shplonk,
    "lookup_shuffle_shplonk": _lookup_shuffle_shplonk,
    "plonk_api_multi_gwc": lambda: _plonk_api_multi(True),
    "plonk_api_multi_shplonk": lambda: _plonk_api_multi(False),
}
MULTI_PARTS = dict(MULTI_PROOFS, files=_files_part,
                   intermediate_sets=intermediate_sets_golden)
# parts whose programs crash XLA-CPU's persistent-cache read (the Tier-1
# crash of test_shplonk_with_lookups_shuffles): compiled afresh
NO_CACHE_PARTS = ("lookup_shuffle_shplonk",)


def multi_golden() -> dict:
    """Each part in a process of its own (one process holding every
    program of these proofs ran XLA-CPU out of memory), merged."""
    import subprocess
    parts = {}
    for name in MULTI_PARTS:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "multi-part", name],
            capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"part {name} failed:\n{done.stderr[-3000:]}")
        parts[name] = json.loads(done.stdout.strip().splitlines()[-1])
        print(f"{name}: done", file=sys.stderr, flush=True)
    return {"proofs": {name: parts[name] for name in MULTI_PROOFS},
            "files": parts["files"],
            "intermediate_sets": parts["intermediate_sets"]}


# the block chain of halo2_tpu_torch.circuits.BlockMulChainCircuit, the
# circuit the port synthesizes in forked workers (`synth` writes it alone)
SYNTH_K, SYNTH_BLOCKS, SYNTH_AB = 5, 4, (3, 1000003)
SYNTH_PARAMS_SEED, SYNTH_PROVER_SEED = 7, 1


def synth_golden() -> dict:
    """The JAX package's keygen, witness file and GWC proof of the port's
    BlockMulChainCircuit (K = 5, four blocks, FlatFloorPlanner; the
    class's closures use only the region they are given, so the JAX
    package proves the port's class itself), synthesized in turn."""
    import tempfile
    from halo2_tpu.circuit import FlatFloorPlanner
    from halo2_tpu.plonk.prover import create_witness
    from halo2_tpu.plonk.verifier import verify_proof
    from halo2_tpu_torch.circuits import BlockMulChainCircuit
    steps = BlockMulChainCircuit.steps_for(SYNTH_K, SYNTH_BLOCKS)
    a, b = SYNTH_AB
    circuit = BlockMulChainCircuit(steps, SYNTH_BLOCKS, a, b, workers=1)
    inst = [[circuit.expected_out()]]
    params = Params.unsafe_setup(SYNTH_K, seed=SYNTH_PARAMS_SEED)
    vk, pk = keygen(params, circuit.without_witnesses(),
                    floor_planner=FlatFloorPlanner)
    proof = create_proof(params, pk, circuit, inst, seed=SYNTH_PROVER_SEED,
                         floor_planner=FlatFloorPlanner)
    assert verify_proof(params.verifier(1), vk, inst, proof)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "witness.bin")
        create_witness(pk, circuit, inst, path,
                       floor_planner=FlatFloorPlanner)
        with open(path, "rb") as fh:
            witness = fh.read()
    return dict(_proof_record(
        "halo2_tpu_torch/circuits.py::BlockMulChainCircuit", SYNTH_K,
        SYNTH_PARAMS_SEED, SYNTH_PROVER_SEED, inst, True, proof, vk),
        steps=steps, blocks=SYNTH_BLOCKS, witness=list(SYNTH_AB),
        witness_sha256=hashlib.sha256(witness).hexdigest())


# the multi-device records (torch_golden_mesh.json)
MESH_D = 8
MESH_NTT_LOGS = (8, 10)
MESH_MSM_N, MESH_MSM_SEEDS = 256, {"full": 0xA11, "bounded": 0xB22,
                                   "mesh2d": 0xD2D}
MESH_EV_K, MESH_EV_SEED = 6, 3
MESH_EV_CHALLENGES = (12345, 678, 910, 1112)   # theta, beta, gamma, y
MESH_LS_K, MESH_LS_PARAMS_SEED, MESH_LS_SEED = 6, 99, 3


def mesh_field_ints(seed: int, count: int) -> list:
    """`count` field elements below 2^248 from numpy RandomState(seed):
    four 62-bit draws each."""
    words = np.random.RandomState(seed).randint(
        0, 1 << 62, size=(count, 4), dtype=np.int64)
    return [int(a) | int(b) << 62 | int(c) << 124 | int(d) << 186
            for a, b, c, d in words.tolist()]


def ints_sha256(ints) -> str:
    """sha256 of canonical field elements, 32 little-endian bytes each."""
    return hashlib.sha256(b"".join(
        int(v).to_bytes(32, "little") for v in ints)).hexdigest()


def mesh_msm_inputs(name: str):
    """(ks, scalars, max_bits) of one sharded-MSM record: the points are
    k * G for k in ks (curves.host.random_point's draws), the scalars full
    with a stretch of equal ones (degenerate digits in one shard), or
    16-bit."""
    from halo2_tpu.fields.bn254 import Fr
    r = random.Random(MESH_MSM_SEEDS[name])
    ks = [r.randrange(1, Fr.p) for _ in range(MESH_MSM_N)]
    if name == "bounded":
        return ks, [r.randrange(1 << 16) for _ in range(MESH_MSM_N)], 16
    scalars = [r.randrange(Fr.p) for _ in range(MESH_MSM_N)]
    if name == "full":
        scalars[32:64] = [scalars[32]] * 32
    return ks, scalars, 256


def _jax_mesh(shape=(MESH_D,), axes=("x",)):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:MESH_D]).reshape(shape)
    return Mesh(devs, axes)


def _mesh_ntt_part() -> dict:
    import jax.numpy as jnp
    from halo2_tpu.fields.bn254 import Fr
    from halo2_tpu.ntt.distributed import DistNTT
    out = {}
    for log_n in MESH_NTT_LOGS:
        n = 1 << log_n
        vals = mesh_field_ints(log_n, 2 * n)
        a = jnp.stack([jnp.asarray(Fr.encode(vals[c * n:(c + 1) * n]))
                       for c in range(2)], axis=1)          # (16, 2, n)
        dist = DistNTT(log_n, _jax_mesh())
        fwd = [v for c in range(2)
               for v in Fr.decode(np.asarray(dist.forward(a[:, c, :])))]
        rec = {"forward": fwd}
        for name in ("inverse", "inverse_nodiv"):
            got = np.asarray(getattr(dist, name)(a)).reshape(16, 2 * n)
            rec[name] = Fr.decode(got)
        out[str(log_n)] = {name: {"sha256": ints_sha256(v), "head": v[:4]}
                           for name, v in rec.items()}
    return out


def _mesh_msm_part() -> dict:
    import jax.numpy as jnp
    from halo2_tpu.curves import g1, host
    from halo2_tpu.fields.bn254 import Fr
    from halo2_tpu.msm.distributed import msm_sharded
    out = {}
    for name in MESH_MSM_SEEDS:
        ks, scalars, max_bits = mesh_msm_inputs(name)
        pts = [host.mul(host.G1_GEN, k) for k in ks]
        if name == "mesh2d":
            mesh, axis = _jax_mesh((2, 4), ("dcn", "ici")), ("dcn", "ici")
        else:
            mesh, axis = _jax_mesh(), "x"
        xy = g1.encode_points(pts)
        proj = msm_sharded((xy[0], xy[1]), jnp.asarray(Fr.encode(scalars)),
                           mesh, axis=axis, max_bits=max_bits)
        got = g1.decode_points(jnp.stack(g1.to_affine(
            tuple(c[:, None] for c in proj))))[0]
        assert got == host.msm(pts, scalars)
        out[name] = {"seed": MESH_MSM_SEEDS[name], "max_bits": max_bits,
                     "axis": list(axis) if isinstance(axis, tuple) else axis,
                     "affine": [str(got[0]), str(got[1])]}
    return {"n": MESH_MSM_N, "records": out}


def mesh_ev_inputs(cs, n: int) -> dict:
    """tests/test_sharded_prover.py's evaluator inputs as canonical ints:
    advice, instance and the permutation's z columns from
    RandomState(MESH_EV_SEED), values below 2^30."""
    rs = np.random.RandomState(MESH_EV_SEED)

    def cols(c):
        return [[int(v) for v in rs.randint(0, 1 << 30, size=n)]
                for _ in range(c)]
    chunk = cs.degree() - 2
    sets = (-(-len(cs.permutation.columns) // chunk)
            if cs.permutation.columns else 0)
    return {"advice": cols(cs.num_advice_columns),
            "instance": cols(cs.num_instance_columns),
            "perm_z": cols(sets)}


def _mesh_ev_part() -> dict:
    import jax.numpy as jnp
    from halo2_tpu.fields.bn254 import Fr
    from halo2_tpu.fields.limbs import N_LIMBS
    params = Params.unsafe_setup(MESH_EV_K, seed=PARAMS_SEED)
    vk, pk = keygen(params, SimpleCircuit())
    n = 1 << MESH_EV_K
    inputs = mesh_ev_inputs(vk.cs, n)

    def stack(cols):
        return (jnp.stack([jnp.asarray(Fr.encode(c)) for c in cols], axis=1)
                if cols else jnp.zeros((N_LIMBS, 0, n), jnp.uint32))
    empty = stack([])
    args = (stack(inputs["advice"]), stack(inputs["instance"]),
            stack(inputs["perm_z"]), empty, empty, empty) \
        + MESH_EV_CHALLENGES
    single = np.asarray(pk.ev.evaluate_h(*args))
    sharded = np.asarray(pk.sharded_ev(_jax_mesh()).evaluate_h(*args))
    assert np.array_equal(single, sharded)
    h = Fr.decode(sharded)
    return {"k": MESH_EV_K, "params_seed": PARAMS_SEED,
            "numpy_seed": MESH_EV_SEED,
            "challenges": list(MESH_EV_CHALLENGES),
            "h_sha256": ints_sha256(h), "head": h[:4]}


def _mesh_simple_part() -> dict:
    from halo2_tpu.plonk.verifier import verify_proof
    params = Params.unsafe_setup(MESH_EV_K, seed=PARAMS_SEED)
    vk, pk = keygen(params, SimpleCircuit())
    out = expected_out(A, B)
    single = create_proof(params, pk, SimpleCircuit(A, B), [[out]], seed=0)
    params.use_mesh(_jax_mesh())
    gate, Params.MESH_MSM_MIN = Params.MESH_MSM_MIN, 1
    try:
        sharded = create_proof(params, pk, SimpleCircuit(A, B), [[out]],
                               seed=0)
    finally:
        Params.MESH_MSM_MIN = gate
        params.use_mesh(None)
    assert sharded == single
    assert verify_proof(params.verifier(1), vk, [[out]], sharded)
    return _proof_record("tests/test_e2e.py::SimpleCircuit", MESH_EV_K,
                         PARAMS_SEED, 0, [[out]], True, sharded, vk)


def _mesh_lookup_shuffle_part() -> dict:
    from tests.test_lookup_shuffle import (VALS_A, VALS_B,
                                           LookupShuffleCircuit)
    params = Params.unsafe_setup(MESH_LS_K, seed=MESH_LS_PARAMS_SEED)
    vk, pk = keygen(params, LookupShuffleCircuit())
    proof = create_proof(params, pk, LookupShuffleCircuit(VALS_A, VALS_B),
                         [], seed=MESH_LS_SEED)
    return _proof_record("tests/test_lookup_shuffle.py::LookupShuffleCircuit",
                         MESH_LS_K, MESH_LS_PARAMS_SEED, MESH_LS_SEED, [],
                         True, proof, vk)


MESH_PARTS = {"dist_ntt": _mesh_ntt_part, "msm_sharded": _mesh_msm_part,
              "evaluate_h": _mesh_ev_part, "simple_k6": _mesh_simple_part,
              "lookup_shuffle_k6": _mesh_lookup_shuffle_part}


def mesh_golden() -> dict:
    """Each part in a process of its own, merged."""
    import subprocess
    parts = {}
    for name in MESH_PARTS:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "mesh-part", name],
            capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"part {name} failed:\n{done.stderr[-3000:]}")
        parts[name] = json.loads(done.stdout.strip().splitlines()[-1])
        print(f"{name}: done", file=sys.stderr, flush=True)
    return {"devices": MESH_D, **parts}


def _write(name: str, record: dict):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main(which=()):
    """Writes every file but the mesh records; `multi`, `synth` or `mesh`
    as the only argument writes torch_golden_multi.json,
    torch_golden_synth.json or torch_golden_mesh.json alone (`multi-part
    NAME` and `mesh-part NAME` print one part)."""
    if which[:1] == ("mesh-part",):
        print(json.dumps(MESH_PARTS[which[1]]()))
        return
    if "mesh" in which:
        _write("torch_golden_mesh.json", mesh_golden())
        return
    if which[:1] == ("multi-part",):
        if which[1] in NO_CACHE_PARTS:
            import jax
            jax.config.update("jax_enable_compilation_cache", False)
        print(json.dumps(MULTI_PARTS[which[1]]()))
        return
    if "synth" in which or not which:
        _write("torch_golden_synth.json", synth_golden())
    if "multi" in which or not which:
        _write("torch_golden_multi.json", multi_golden())
    if which:
        return
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
    main(tuple(sys.argv[1:]))
