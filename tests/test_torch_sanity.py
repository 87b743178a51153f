"""The sanity checks (HALO2_TPU_SANITY_CHECKS=1, the reference's
`sanity-checks` feature) of the permutation, logup and shuffle provers,
on the CPU, against the JAX package's closures and messages.

With the checks on, a golden proof (LookupShuffleCircuit at K = 5: a
permutation, a logup lookup and a shuffle) keeps the JAX package's bytes
from tests/data/torch_golden_args.json; a grand product or sum forced off
its closure raises the JAX package's message: `permutation grand product
!= 1`, `logup grand sum != 0`, `shuffle grand product != 1`.
"""

import json
import os
import random
import subprocess
import sys
import types

import pytest
import torch

from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P
from halo2_tpu_torch.fields.bn254 import FR_ROOT_OF_UNITY, FR_S, fr
from halo2_tpu_torch.fields.limbs import ints_to_limbs_np, to_tensor
from halo2_tpu_torch.plonk import logup_prover, permutation, shuffle_prover
from halo2_tpu_torch.plonk.keygen import keygen
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.poly.commitment import Params

from tests.data.torch_golden_circuits import argument_circuit

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_args.json")
F = fr("cpu")
MODULES = (permutation, logup_prover, shuffle_prover)


@pytest.fixture
def sanity(monkeypatch):
    for mod in MODULES:
        monkeypatch.setattr(mod, "_SANITY", True)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_checks_are_read_from_the_environment_at_import():
    code = ("from halo2_tpu_torch.plonk import logup_prover, permutation, "
            "shuffle_prover\n"
            "print([m._SANITY for m in (permutation, logup_prover, "
            "shuffle_prover)])")
    for value, want in (("1", "[True, True, True]"),
                        ("0", "[False, False, False]")):
        env = dict(os.environ, HALO2_TPU_SANITY_CHECKS=value)
        done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert done.returncode == 0, done.stderr[-2000:]
        assert done.stdout.strip() == want


def test_golden_proof_keeps_its_bytes(sanity, golden):
    rec = golden["proofs"]["lookup_shuffle"]
    circuit, planner = argument_circuit("lookup_shuffle", rec["k"])
    params = Params.unsafe_setup(rec["k"], seed=rec["params_seed"],
                                 device="cpu")
    vk, pk = keygen(params, circuit, floor_planner=planner, device="cpu")
    proof = create_proof(params, pk, circuit, rec["instances"],
                         seed=rec["prover_seed"], floor_planner=planner,
                         device="cpu")
    assert proof.hex() == rec["proof_hex"]


class _Blinding:
    def __init__(self, bf):
        self.bf = bf

    def blinding_factors(self):
        return self.bf

    def degree(self):
        return 4                             # two columns a chunk


def _permutation_case(n=8, bf=1, cols=3):
    """commit_z_polys' operands for `cols` columns of n rows under the
    identity permutation (sigma_j(w^i) = delta^j w^i): its grand product
    closes to 1."""
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - (n.bit_length() - 1)), P)
    rng = random.Random(11)
    values = [F.encode([rng.randrange(P) for _ in range(n)])
              for _ in range(cols)]
    sig = [[pow(permutation.DELTA, j, P) * pow(omega, i, P) % P
            for i in range(n)] for j in range(cols)]
    sigmas = torch.stack([F.encode(s) for s in sig], dim=1)
    cs = _Blinding(bf)
    cs.permutation = types.SimpleNamespace(columns=list(range(cols)))
    domain = types.SimpleNamespace(F=F, n=n, omega=omega, device="cpu")
    params = types.SimpleNamespace(
        commit_many_affine=lambda zs, base: [None] * len(zs))
    pkey = types.SimpleNamespace(sigmas_lagrange=sigmas)
    return params, domain, cs, pkey, (lambda c: values[c])


def test_permutation_closure(sanity):
    params, domain, cs, pkey, value_cols = _permutation_case()
    zs, _ = permutation.commit_z_polys(params, domain, cs, pkey, value_cols,
                                       5, 7, random.Random(0))
    assert len(zs) == 2 and F.decode(zs[0])[0] == 1
    # a sigma moved off the identity at a usable row: the product breaks
    pkey.sigmas_lagrange[:, 2, 3] = F.encode_scalar(12345)
    with pytest.raises(AssertionError,
                       match=r"permutation grand product != 1: \d+"):
        permutation.commit_z_polys(params, domain, cs, pkey, value_cols, 5,
                                   7, random.Random(0))


def test_permutation_closure_unchecked_when_off(monkeypatch):
    monkeypatch.setattr(permutation, "_SANITY", False)
    params, domain, cs, pkey, value_cols = _permutation_case()
    pkey.sigmas_lagrange[:, 2, 3] = F.encode_scalar(12345)
    zs, _ = permutation.commit_z_polys(params, domain, cs, pkey, value_cols,
                                       5, 7, random.Random(0))
    assert len(zs) == 2


def _logup_case(golden):
    rec = golden["logup"]["grand_sums"]
    table = F.encode(rec["table"])
    sets = [[F.encode(c) for c in s] for s in rec["sets"]]
    u = rec["n"] - (rec["bf"] + 1)
    rng = random.Random(rec["rng_seed"])
    m, _ = logup_prover.multiplicities(table, [c for s in sets for c in s],
                                       u, rng)
    return rec, table, sets, m, rng


def test_logup_closure(sanity, golden):
    rec, table, sets, m, rng = _logup_case(golden)
    domain = types.SimpleNamespace(F=F, n=rec["n"])
    zs = logup_prover.commit_zs(domain, _Blinding(rec["bf"]), table, sets,
                                m, rec["beta"], rng)
    assert [F.decode(z) for z in zs] == rec["zs"]
    # one input moved off the table's values: the sum no longer telescopes
    bad = [list(s) for s in sets]
    bad[-1][0] = bad[-1][0].clone()
    bad[-1][0][:, 0] = F.encode_scalar(P - 3)
    with pytest.raises(AssertionError, match=r"logup grand sum != 0: \d+"):
        logup_prover.commit_zs(domain, _Blinding(rec["bf"]), table, bad, m,
                               rec["beta"], random.Random(0))


def test_shuffle_closure(sanity, golden):
    rec = golden["shuffle"]
    domain = types.SimpleNamespace(F=F, n=rec["n"])
    inputs = [F.encode(c) for c in rec["inputs"]]
    shuffles = [F.encode(c) for c in rec["shuffles"]]
    z = shuffle_prover.commit_product(domain, _Blinding(rec["bf"]), inputs,
                                      shuffles, rec["beta"],
                                      random.Random(rec["rng_seed"]))
    assert F.decode(z) == rec["z"]
    inputs[0] = inputs[0].clone()
    inputs[0][:, 1] = to_tensor(ints_to_limbs_np([F.to_mont_int(P - 3)]),
                                "cpu")[:, 0]
    with pytest.raises(AssertionError,
                       match=r"shuffle grand product != 1: \d+"):
        shuffle_prover.commit_product(domain, _Blinding(rec["bf"]), inputs,
                                      shuffles, rec["beta"],
                                      random.Random(0))
