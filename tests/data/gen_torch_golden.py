#!/usr/bin/env python3
"""Generate tests/data/torch_golden_proof.json,
tests/data/torch_golden_horner.json and tests/data/torch_golden_scan.json
from the JAX package.

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
"""

import functools
import importlib
import io
import json
import os
import sys

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


def _write(name: str, record: dict):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main():
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
