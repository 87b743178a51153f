"""Plain reference of the `standard_plonk` configuration: the circuit of the
halo2 criterion bench (benches/plonk.rs, StandardPlonk `MyCircuit`).

Columns: advice a, b, c; fixed sm, sa, sb, sc (allocation order); one gate
a*sa + b*sb + a*b*sm - c*sc; a, b, c in the permutation, in that order.
Below the usable rows u = n - 6 (5 blinding factors + 1), row pairs
(2i, 2i + 1) are the bench's raw_multiply / raw_add:

    row 2i     a = w,  b = w,    c = w^2,      sa = 0, sb = 0, sc = 1, sm = 1
    row 2i+1   a = w,  b = w^2,  c = w^2 + w,  sa = 1, sb = 1, sc = 1, sm = 0

with the copies a[2i] == a[2i+1] and b[2i+1] == c[2i]; w is the job's
witness value.  Every other cell is 0.  Each copy is a cycle of two cells,
so the permutation maps each cell of it to the other one:
sigma_col(row) = delta^(col') omega^(row')."""

from __future__ import annotations

import hashlib
import os

from benchmark.reference import bn254
from benchmark.reference.bn254 import R

CS_FILE = os.path.join(os.path.dirname(__file__), "pinned",
                       "standard_plonk.txt")
DEGREE = 3


def usable_rows(k: int) -> int:
    return (1 << k) - 6


def instances(witness) -> list:
    """No instance column."""
    return []


def columns(args, k: int, j0: int, j1: int) -> dict:
    """Rows j0..j1 of every fixed, permutation and advice column;
    args = {"witnesses": [w per instance]}."""
    u = usable_rows(k)
    w_ = bn254.omega(k)
    w_inv = bn254.inv(w_)
    d1, d2 = bn254.DELTA, bn254.DELTA * bn254.DELTA % R
    out = {f"fixed/{i}": [] for i in range(4)}
    out.update({f"sigma/{i}": [] for i in range(3)})
    adv = [[[] for _ in range(3)] for _ in args["witnesses"]]
    vals = []
    for a in args["witnesses"]:
        a %= R
        sq = a * a % R
        vals.append((a, sq, (sq + a) % R))
    x = pow(w_, j0, R)
    sm, sa, sb, sc = (out[f"fixed/{i}"] for i in range(4))
    sig_a, sig_b, sig_c = (out[f"sigma/{i}"] for i in range(3))
    for j in range(j0, j1):
        if j >= u:
            for col in (sm, sa, sb, sc):
                col.append(0)
            sig_a.append(x)
            sig_b.append(d1 * x % R)
            sig_c.append(d2 * x % R)
            for cols in adv:
                for col in cols:
                    col.append(0)
        elif j % 2 == 0:                       # raw_multiply
            sm.append(1)
            sa.append(0)
            sb.append(0)
            sc.append(1)
            sig_a.append(x * w_ % R)           # a[j] <-> a[j + 1]
            sig_b.append(d1 * x % R)
            sig_c.append(d1 * x % R * w_ % R)  # c[j] <-> b[j + 1]
            for cols, (a, sq, _) in zip(adv, vals):
                cols[0].append(a)
                cols[1].append(a)
                cols[2].append(sq)
        else:                                  # raw_add
            sm.append(0)
            sa.append(1)
            sb.append(1)
            sc.append(1)
            sig_a.append(x * w_inv % R)        # a[j] <-> a[j - 1]
            sig_b.append(d2 * x % R * w_inv % R)  # b[j] <-> c[j - 1]
            sig_c.append(d2 * x % R)
            for cols, (a, sq, fin) in zip(adv, vals):
                cols[0].append(a)
                cols[1].append(sq)
                cols[2].append(fin)
        x = x * w_ % R
    for p, cols in enumerate(adv):
        for c, col in enumerate(cols):
            out[f"advice/{p}/{c}"] = col
    return out


def make_witness(seed: int) -> int:
    """The job's witness value w: a non-zero field element from `seed`."""
    digest = hashlib.blake2b(str(seed).encode(), digest_size=32,
                             person=b"std-plonk-w").digest()
    return int.from_bytes(digest, "little") % R or 1
