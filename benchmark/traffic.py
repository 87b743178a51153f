"""The one traffic generator: a traffic file (benchmark/workloads/<name>.json)
and a run's seed give the jobs of a closed loop.

A traffic file holds `k` (2^k rows), `instances` (circuit instances in one
proof), `opening` ("gwc" or "shplonk") and `offload_lagrange`.  From the
seed come the setup's seed, one witness seed per instance and one prover
seed per job: a prover proves the stored witnesses again and again, each
job with fresh blinding, the next job sent when the last proof is done."""

from __future__ import annotations

import hashlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = {"k", "instances", "opening", "offload_lagrange"}


def derive(seed: int, *labels) -> int:
    """A 63-bit seed of its own for each label."""
    text = ":".join([str(seed)] + [str(x) for x in labels]).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def load(name: str, directory: str | None = None) -> dict:
    path = os.path.join(directory or os.path.join(HERE, "workloads"),
                        name + ".json")
    with open(path) as fh:
        mix = json.load(fh)
    missing = KEYS - set(mix)
    if missing:
        raise ValueError(f"traffic {name}: missing {sorted(missing)}")
    if mix["opening"] not in ("gwc", "shplonk"):
        raise ValueError(f"traffic {name}: unknown opening {mix['opening']}")
    return mix


class Plan:
    def __init__(self, mix: dict, seed: int):
        self.k = int(mix["k"])
        self.instances = int(mix["instances"])
        self.gwc = mix["opening"] == "gwc"
        self.offload = bool(mix["offload_lagrange"])
        self.setup_seed = derive(seed, "srs")
        self.witness_seeds = [derive(seed, "witness", i)
                              for i in range(self.instances)]
        self.warmup_seed = derive(seed, "warm-up")

    def prover_seed(self, job: int) -> int:
        return derive(self.setup_seed, "proof", job)
