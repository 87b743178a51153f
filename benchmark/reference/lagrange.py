"""Commitments worked out from s: a column of values v_j over the rows of a
2^k domain commits to [sum_j v_j L_j(s)] G, L_j the Lagrange basis of
the domain, L_j(s) = (s^n - 1) / n * w^j / (s - w^j).

The sums run over row ranges in worker processes (spawned, plain Python
integers, one batch inversion per range); each worker rebuilds the columns
of its range from the configuration's reference module, so nothing large
crosses a pipe."""

from __future__ import annotations

import importlib
import multiprocessing
import os

from benchmark.reference import bn254
from benchmark.reference.bn254 import R


def weights(k: int, s: int, rows) -> dict:
    """L_j(s) for a few rows j."""
    n = 1 << k
    w = bn254.omega(k)
    c = (pow(s, n, R) - 1) * bn254.inv(n) % R
    out = {}
    for j in rows:
        wj = pow(w, j, R)
        out[j] = c * wj % R * bn254.inv(s - wj) % R
    return out


def _range_sums(task) -> dict:
    module, args, k, s, j0, j1 = task
    cols = importlib.import_module(module).columns(args, k, j0, j1)
    n = 1 << k
    w = bn254.omega(k)
    c = (pow(s, n, R) - 1) * bn254.inv(n) % R
    size = j1 - j0
    # w^j, then (s - w^j)^-1 by one batch inversion, then L_j(s)
    pw = [0] * size
    x = pow(w, j0, R)
    for i in range(size):
        pw[i] = x
        x = x * w % R
    prefix = [0] * size
    acc = 1
    for i in range(size):
        prefix[i] = acc
        acc = acc * (s - pw[i]) % R
    inv = bn254.inv(acc)
    lj = [0] * size
    for i in range(size - 1, -1, -1):
        lj[i] = inv * prefix[i] % R * pw[i] % R * c % R
        inv = inv * (s - pw[i]) % R
    out = {}
    for name, values in cols.items():
        acc = 0
        for v, l in zip(values, lj):
            if v:
                acc += v * l
        out[name] = acc % R
    return out


def column_sums(module: str, args, k: int, s: int,
                workers: int | None = None) -> dict:
    """{column name: sum_j v_j L_j(s)} over every row of the columns that
    `module`.columns(args, k, j0, j1) gives."""
    n = 1 << k
    workers = max(1, min(workers or os.cpu_count() or 1, 16))
    pieces = min(n, 4 * workers)
    bounds = [n * i // pieces for i in range(pieces + 1)]
    tasks = [(module, args, k, s, a, b) for a, b in zip(bounds, bounds[1:])]
    if workers == 1:
        parts = [_range_sums(t) for t in tasks]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            parts = pool.map(_range_sums, tasks)
            pool.close()
            pool.join()
    total = {}
    for part in parts:
        for name, v in part.items():
            total[name] = (total.get(name, 0) + v) % R
    return total
