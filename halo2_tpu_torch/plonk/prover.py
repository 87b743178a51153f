"""The prover pipeline — create_proof.

Re-design of halo2_proofs/src/plonk/prover.rs:206-850 (create_proof_ext),
same transcript order, device-first data flow:

  1. vk hash + instance commit/absorb (prover.rs:85-162)
  2. witness synthesis into host column buffers -> device lagrange arrays;
     u16-random blinding rows; bounded-bit advice commitments
     (prover.rs:256-315)
  3. theta; lookups: compress, m(X) (counts + u16 tail), m commitments
  4. shuffles: compress; beta, gamma
  5. permutation z commits (grand products on device), then the lookup
     grand sums (one z a set, chained), then the shuffle grand products
  6. vanishing random poly commit -> y
  7. iNTT to coeff of advice, instance, m and every z
  8. evaluate_h (the Evaluator)
  9. vanishing.construct: divide by t, extended_to_coeff, split, commit -> x
 10. all query evals written in order (instance, advice, fixed, vanishing
     random, permutation common, permutation sets, lookups, shuffles)
 11. GWC multiopen

Randomness is injectable (`seed`) so proofs are reproducible in tests —
the reference uses OsRng (prover.rs:286); byte-level determinism here is a
feature for differential testing.

One circuit instance per proof, opened with GWC (SHPLONK is refused by
name): gates, permutation, logup lookups, shuffles and range checks.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from halo2_tpu_torch.circuit import Assignment, Cell, SimpleFloorPlanner
from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.multiopen import ProverQuery
from halo2_tpu_torch.multiopen import gwc
from halo2_tpu_torch.plonk import logup_prover, shuffle_prover
from halo2_tpu_torch.plonk import permutation as perm_mod
from halo2_tpu_torch.plonk.error import (InstanceTooLarge,
                                         InvalidInstancesError,
                                         NotEnoughRowsAvailable,
                                         SynthesisError)
from halo2_tpu_torch.plonk.expr_eval import ExprCtx
from halo2_tpu_torch.plonk.range_check import fill_and_sort
from halo2_tpu_torch.plonk.vanishing import VanishingProver
from halo2_tpu_torch.poly.arith import eval_poly_batch
from halo2_tpu_torch.transcript import Blake2bWrite
from halo2_tpu_torch.utils.device import require_device
from halo2_tpu_torch.utils.profiling import phase_marker

P = FR_MODULUS


class WitnessCollection(Assignment):
    """Witness synthesis backend (prover.rs:1525-1781): advice values into
    host column buffers; copies/fixed are keygen artifacts and ignored.

    Columnar representation: each column starts as a numpy uint64 buffer
    (the common case — real witness values are machine ints), so bulk
    assignment and the canonical->Montgomery encode are loop-free all the
    way to the device.
    The first full-width (>= 2^64) value DEGRADES that column to a Python
    int list — exact bigint semantics are kept, only the fast path is
    lost."""

    def __init__(self, cs, n, usable_rows, instances):
        self.cs = cs
        self.n = n
        self.usable_rows = usable_rows
        self.instances = instances
        self.advice = [np.zeros(n, np.uint64)
                       for _ in range(cs.num_advice_columns)]
        self.max_assigned = [-1] * cs.num_advice_columns
        # running max VALUE per column — avoids a full O(n) bit_length pass
        # per column after synthesis (the bounded-window commit needs only
        # the max; prover.rs:237-254)
        self.max_value = [0] * cs.num_advice_columns
        # deferred Assigned rationals (col, row, num, den): resolved with
        # ONE batch inversion after synthesis (poly.rs:148-173
        # batch_invert_assigned) — no per-cell `pow` during synthesis
        self.deferred = []

    def enable_selector(self, selector, row):
        pass  # packed into fixed columns at keygen

    def _degrade(self, ci):
        """numpy column -> Python int list (first big value)."""
        if isinstance(self.advice[ci], np.ndarray):
            self.advice[ci] = [int(v) for v in self.advice[ci]]
        return self.advice[ci]

    def assign_advice(self, column, row, value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        if value is None:
            raise SynthesisError("advice value not assigned (synthesis)")
        from halo2_tpu_torch.plonk.assigned import Assigned
        if isinstance(value, Assigned) and not (value.is_trivial()
                                                or value.is_zero()):
            # deferred division: placeholder now, batch-inverted later
            self.deferred.append((column.index, row, value.num, value.den))
            ci = column.index
            if row > self.max_assigned[ci]:
                self.max_assigned[ci] = row
            return
        v = int(value) % P
        ci = column.index
        col = self.advice[ci]
        if isinstance(col, np.ndarray) and v >> 64:
            col = self._degrade(ci)
        col[row] = v
        if row > self.max_assigned[ci]:
            self.max_assigned[ci] = row
        if v > self.max_value[ci]:
            self.max_value[ci] = v

    def assign_fixed(self, column, row, value):
        pass

    def copy(self, left: Cell, right: Cell):
        pass

    def query_instance(self, column, row):
        return self.instances[column.index][row]

    def assign_advice_bulk(self, column, from_row, values):
        """Vectorized fast path (prover.rs:1525-1781's raw-buffer writes):
        accepts a list of ints or a numpy integer array; one slice store +
        one max, no per-cell Python dispatch."""
        count = len(values)
        if from_row + count > self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        ci = column.index
        col = self.advice[ci]
        arr = None
        if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
            # signed arrays containing negatives must NOT wrap via astype
            # (uint64(-1) != -1 mod p) — route them to the exact bigint path
            if values.dtype.kind == "i" and count and int(values.min()) < 0:
                arr = None
                values = [int(v) % P for v in values]
            else:
                arr = values.astype(np.uint64, copy=False)
        if arr is None:
            try:
                arr = np.asarray(values, dtype=np.uint64)
            except (OverflowError, TypeError, ValueError):
                arr = None
        if arr is not None and isinstance(col, np.ndarray):
            # columnar path: one slice store, no Python per-cell work
            col[from_row: from_row + count] = arr
            vmax = int(arr.max()) if count else 0
        else:
            if isinstance(col, np.ndarray):
                col = self._degrade(ci)
            vals = [int(v) % P for v in values] if arr is None \
                else [int(v) for v in arr]
            col[from_row: from_row + count] = vals
            vmax = max(vals, default=0)
        last = from_row + count - 1
        if last > self.max_assigned[ci]:
            self.max_assigned[ci] = last
        if vmax > self.max_value[ci]:
            self.max_value[ci] = vmax

    def resolve_deferred(self):
        """Resolve rational cells with ONE batch inversion
        (batch_invert_assigned, poly.rs:148-173)."""
        from halo2_tpu_torch.plonk.assigned import resolve_deferred

        def write(ci, row, v):
            col = self.advice[ci]
            if isinstance(col, np.ndarray) and v >> 64:
                col = self._degrade(ci)
            col[row] = v
            if v > self.max_value[ci]:
                self.max_value[ci] = v
        resolve_deferred(self.deferred, write)
        self.deferred = []

    def fill_range_checks(self):
        """Range-check fill + counting sort (prover.rs:1699-1779): each
        relation's origin column gets its [min..max] tail and its sort
        column the sorted values; both commit bounds rise to the relation's
        max, which the filled cells reach."""
        for rel in self.cs.range_check:
            fill_and_sort(self.advice, rel, self.usable_rows,
                          self.max_assigned[rel.origin.index])
            for c in (rel.origin, rel.sort):
                self.max_value[c.index] = max(self.max_value[c.index],
                                              rel.max)

    def is_in_prove_mode(self):
        return True


def _quantize_max_bits(bits: int) -> int:
    """Snap a per-column scalar bound to the signed-window grid: the largest
    bit bound with the same window count (prover.rs:237-254 uses the exact
    bound), so a 20-bit column pays 2 windows."""
    from halo2_tpu_torch.msm.sorted import SIGNED_C_BITS, num_windows_for
    w = num_windows_for(bits)
    return min(SIGNED_C_BITS * w - 2, 254)


def m_commit_bits(m_bits: int) -> int:
    """The commit bound of a lookup's m(X): its rows below the usable ones
    hold counts of `m_bits` bits, the rows above u16 random blinding
    values, so the bound covers 16 bits at least (the reference's bound of
    the counts alone drops the blinding values' high bits in a bounded-
    window MSM)."""
    return _quantize_max_bits(max(m_bits, 16))


def create_proof(params, pk, circuit, instances, seed: int | None = None,
                 floor_planner=None, use_gwc: bool = True, device="cuda",
                 phases=None) -> bytes:
    """Prove one circuit instance. instances: list of instance columns
    (each a list of ints, length <= usable rows). Returns proof bytes.
    `device` must be the one `params` and `pk` live on; `phases` is an
    optional utils.profiling.PhaseTimes that receives per-phase seconds."""
    device = require_device(device)
    if params.device != device:
        raise ValueError(f"params are on {params.device}, create_proof was "
                         f"asked for {device}")
    if not use_gwc:
        raise NotImplementedError(
            "the SHPLONK multiopen is not ported to halo2_tpu_torch yet")
    vk = pk.vk
    cs = vk.cs
    domain = vk.domain
    F = domain.F
    n = params.n
    bf = cs.blinding_factors()
    usable_rows = cs.usable_rows(n)
    rng = random.Random(seed)
    transcript = Blake2bWrite()
    m = len(cs.permutation.columns)

    _pm = phase_marker(device, phases)
    # 1. vk hash + instance commitments (absorbed as common points)
    vk.hash_into(transcript)
    instance_cols = []
    for col in instances:
        if len(col) > usable_rows:
            raise InstanceTooLarge()
        instance_cols.append(list(col) + [0] * (n - len(col)))
    if len(instance_cols) != cs.num_instance_columns:
        raise InvalidInstancesError()
    instance_lagrange = (
        torch.stack([F.encode(c) for c in instance_cols], dim=1)
        if instance_cols else F.zeros((0, n)))
    for pt in params.commit_many_affine(
            [instance_lagrange[:, i, :]
             for i in range(cs.num_instance_columns)], base="lagrange"):
        transcript.common_point(pt)

    _pm("instances")
    # 2. witness synthesis + advice commitments
    witness = WitnessCollection(cs, n, usable_rows, instance_cols)
    planner = floor_planner or SimpleFloorPlanner
    planner.synthesize(witness, circuit, witness_config(pk, circuit),
                       cs.constants)
    # batch_invert_assigned: ONE inversion for every deferred rational cell
    # (poly.rs:148-173)
    witness.resolve_deferred()
    witness.fill_range_checks()
    # u16 blinding rows (prover.rs:283-290); named advice exempt
    for ci, col in enumerate(witness.advice):
        if ci in cs.named_advices:
            continue
        for r in range(usable_rows, n):
            col[r] = rng.randrange(1 << 16)
        witness.max_value[ci] = max(witness.max_value[ci], (1 << 16) - 1)

    # columnar staging: u64 columns upload RAW (8 B/value), degraded bigint
    # columns upload 32-byte canonical rows; both convert
    # canonical->Montgomery on the device (one mul by R^2)
    def col_to_dev(c):
        if isinstance(c, np.ndarray):
            return F.encode_u64_dev(c[None])[:, 0, :]
        blob = b"".join(int(v).to_bytes(32, "little") for v in c)
        return F.encode_le_bytes_dev(blob, n)

    if witness.advice and all(isinstance(c, np.ndarray)
                              for c in witness.advice):
        advice_lagrange = F.encode_u64_dev(np.stack(witness.advice))
    elif witness.advice:
        advice_lagrange = torch.stack(
            [col_to_dev(c) for c in witness.advice], dim=1)
    else:
        advice_lagrange = F.zeros((0, n))
    # bounded-window commit bound from the running max (no O(n) host
    # bit-length pass; prover.rs:237-254)
    col_bits = [max(witness.max_value[i].bit_length(), 1)
                for i in range(cs.num_advice_columns)]
    for pt in params.commit_many_affine(
            [advice_lagrange[:, i, :] for i in range(cs.num_advice_columns)],
            [_quantize_max_bits(b) for b in col_bits], base="lagrange"):
        transcript.write_point(pt)

    _pm("advice synth+commit")
    # 3. theta; lookup compression + m(X) commitments
    theta = transcript.squeeze_challenge()
    theta_l = F.encode_scalar(theta)
    lag_ctx = ExprCtx(advice_lagrange, pk.fixed_lagrange, instance_lagrange,
                      rot_scale=1, length=n)
    lookup_data = []
    m_bits = []
    for lookup in cs.lookups:
        table, input_sets = logup_prover.compress(lookup, lag_ctx, theta_l)
        m_lag, bits = logup_prover.multiplicities(
            table, [c for s in input_sets for c in s], usable_rows, rng)
        lookup_data.append((table, input_sets, m_lag))
        m_bits.append(bits)
    for pt in params.commit_many_affine(
            [m for _, _, m in lookup_data], [m_commit_bits(b) for b in m_bits],
            base="lagrange"):
        transcript.write_point(pt)

    _pm("lookup compress+m")
    # 4. shuffle compression; beta, gamma
    shuffle_data = [shuffle_prover.compress(group, lag_ctx, theta_l)
                    for group in cs.shuffles]
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    _pm("shuffle compress")
    # 5. permutation z commits, then lookup zs, then shuffle zs
    def value_col(column):
        if column.ctype == "advice":
            return advice_lagrange[:, column.index, :]
        if column.ctype == "fixed":
            return pk.fixed_lagrange[:, column.index, :]
        return instance_lagrange[:, column.index, :]

    perm_zs, z_commitments = perm_mod.commit_z_polys(
        params, domain, cs, pk.permutation_pk, value_col, beta, gamma, rng)
    for com in z_commitments:
        transcript.write_point(com)
    lookup_zs = [logup_prover.commit_zs(domain, cs, table, input_sets, m_lag,
                                        beta, rng)
                 for table, input_sets, m_lag in lookup_data]
    shuffle_zs = [shuffle_prover.commit_product(domain, cs, inputs, shuffles,
                                                beta, rng)
                  for inputs, shuffles in shuffle_data]
    arg_zs = [z for zset in lookup_zs for z in zset] + shuffle_zs
    for com in params.commit_many_affine(arg_zs, base="lagrange"):
        transcript.write_point(com)
    # the compressed Lagrange forms die here
    lookup_ms = [m for _, _, m in lookup_data]
    del lag_ctx, lookup_data, shuffle_data, arg_zs

    _pm("grand products/sums")
    # 6. vanishing random poly -> y
    vanishing = VanishingProver(params, domain, rng)
    transcript.write_point(vanishing.random_commitment)
    y = transcript.squeeze_challenge()

    _pm("vanishing commit")
    # 7. coeff forms: every column of one kind in one batched iNTT
    def to_coeff(cols):
        return domain.ntt.inverse(torch.stack(cols, dim=1)) if cols \
            else F.zeros((0, n))

    advice_coeff = (domain.ntt.inverse(advice_lagrange)
                    if cs.num_advice_columns else advice_lagrange)
    instance_coeff = (domain.ntt.inverse(instance_lagrange)
                      if cs.num_instance_columns else instance_lagrange)
    perm_z_stack = to_coeff(perm_zs)
    lookup_m_stack = to_coeff(lookup_ms)
    lookup_z_stack = to_coeff([z for zset in lookup_zs for z in zset])
    shuffle_z_stack = to_coeff(shuffle_zs)
    flat_lz = iter(lookup_z_stack.unbind(1))
    lookup_z_coeffs = [[next(flat_lz) for _ in zset] for zset in lookup_zs]
    del advice_lagrange, instance_lagrange, perm_zs, lookup_ms, lookup_zs
    del shuffle_zs
    perm_z_coeffs = list(perm_z_stack.unbind(1))
    lookup_m_coeffs = list(lookup_m_stack.unbind(1))
    shuffle_z_coeffs = list(shuffle_z_stack.unbind(1))

    _pm("iNTTs")
    # 8. h evaluation
    h_ext = pk.ev.evaluate_h(
        advice_coeff, instance_coeff, perm_z_stack, lookup_m_stack,
        lookup_z_stack, shuffle_z_stack, theta, beta, gamma, y)

    _pm("evaluate_h")
    # 9. vanishing construct -> x
    h_pieces, h_commitments = vanishing.construct(h_ext)
    del h_ext
    for com in h_commitments:
        transcript.write_point(com)
    x = transcript.squeeze_challenge()
    xn = pow(x, n, P)

    _pm("h split+commit")
    # 10. evals (verifier read order, verifier.rs:246-290), batched:
    # all polys sharing an evaluation point go through ONE device dot
    x_next = domain.rotate_omega(x, 1)
    x_last = domain.rotate_omega(x, -(bf + 1))

    def z_chain_plan(zcs):
        out = []
        for i, zc in enumerate(zcs):
            out += [(zc, x), (zc, x_next)]
            if i + 1 < len(zcs):
                out.append((zc, x_last))
        return out

    plan = []  # (poly, point) in exact transcript write order
    for column, rot in cs.instance_queries:
        plan.append((instance_coeff[:, column.index, :],
                     domain.rotate_omega(x, rot)))
    for column, rot in cs.advice_queries:
        plan.append((advice_coeff[:, column.index, :],
                     domain.rotate_omega(x, rot)))
    for column, rot in cs.fixed_queries:
        plan.append((pk.fixed_coeff[:, column.index, :],
                     domain.rotate_omega(x, rot)))
    h_poly = vanishing.fold_h(h_pieces, xn)
    plan.append((vanishing.random_poly, x))
    for i in range(m):
        plan.append((pk.permutation_pk.sigmas_coeff[:, i, :], x))
    plan += z_chain_plan(perm_z_coeffs)
    for m_coeff, zcs in zip(lookup_m_coeffs, lookup_z_coeffs):
        plan.append((m_coeff, x))
        plan += z_chain_plan(zcs)
    for zc in shuffle_z_coeffs:
        plan += [(zc, x), (zc, x_next)]
    by_point = {}
    for i, (_, pt) in enumerate(plan):
        by_point.setdefault(pt, []).append(i)
    results = [None] * len(plan)
    for pt, idxs in by_point.items():
        vals = eval_poly_batch([plan[i][0] for i in idxs], pt)
        for i, v in zip(idxs, vals):
            results[i] = v
    for v in results:
        transcript.write_scalar(v)

    _pm("evals")
    # 11. multiopen queries (prover.rs:792-846: the proof's own sections,
    # then fixed / permutation-common / vanishing)
    def z_chain_queries(zcs):
        out = []
        for zc in zcs:
            out += [ProverQuery(x, 0, zc), ProverQuery(x_next, 1, zc)]
        for zc in reversed(zcs[:-1]):
            out.append(ProverQuery(x_last, -(bf + 1), zc))
        return out

    queries = []
    for column, rot in cs.instance_queries:
        queries.append(ProverQuery(domain.rotate_omega(x, rot), rot,
                                   instance_coeff[:, column.index, :]))
    for column, rot in cs.advice_queries:
        queries.append(ProverQuery(domain.rotate_omega(x, rot), rot,
                                   advice_coeff[:, column.index, :]))
    queries += z_chain_queries(perm_z_coeffs)
    for m_coeff, zcs in zip(lookup_m_coeffs, lookup_z_coeffs):
        queries.append(ProverQuery(x, 0, m_coeff))
        queries += z_chain_queries(zcs)
    for zc in shuffle_z_coeffs:
        queries += [ProverQuery(x, 0, zc), ProverQuery(x_next, 1, zc)]
    for column, rot in cs.fixed_queries:
        queries.append(ProverQuery(domain.rotate_omega(x, rot), rot,
                                   pk.fixed_coeff[:, column.index, :]))
    for i in range(m):
        queries.append(ProverQuery(
            x, 0, pk.permutation_pk.sigmas_coeff[:, i, :]))
    queries.append(ProverQuery(x, 0, h_poly))
    queries.append(ProverQuery(x, 0, vanishing.random_poly))

    gwc.create_proof(params, transcript, queries)
    _pm("multiopen")
    return transcript.finalize()


def witness_config(pk, circuit):
    """The config object for witness synthesis.

    Primary path: the pk stores the config produced by the single
    configure() run at keygen time (ProvingKey.config) — guaranteed in
    sync with the keygen CS even if configure() is stateful.  Fallback
    (pk rebuilt from carried-over state, where no Circuit instance existed
    at load time): re-run configure on a throwaway CS and rely on
    allocation determinism."""
    if pk.config is not None:
        return pk.config
    from halo2_tpu_torch.plonk.circuit import ConstraintSystem
    probe = ConstraintSystem()
    return circuit.configure(probe)
