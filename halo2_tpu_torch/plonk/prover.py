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
 11. GWC or SHPLONK multiopen

Several instances of one circuit go into one proof (create_proof_multi):
steps 2-7 and 10 run per proof, in the reference's transcript order, and
the h numerator is chained across proofs before one quotient.

Under params.use_mesh (a mesh of devices, utils/mesh.py) the commitments
take the sharded MSM, the step-7 iNTTs (from MESH_MSM_MIN rows on) and the
quotient's extended iNTT the four-step transform over the mesh, and step 8
the sharded evaluator, whose h stays row-sharded until the quotient's
transform; coefficient forms stay whole on the mesh's first device.  The
host draws and the transcript are the same, so are the proof bytes.

From n >= LARGE_N rows on, the reference's large-domain sequence
(prover.py:361-363, 521-536, 554-599, 608-612, 627-635 of halo2_tpu):
the step-7 stacks are transformed proof by proof, each handed over to its
iNTT; with offload_lagrange the key's Lagrange forms leave the device
after the grand products and the Lagrange SRS after the vanishing commit,
both joined before evaluate_h; and the forward extended twiddle tables
are dropped after evaluate_h from extended_n >= STREAM_NTT_MIN on.  At
every size the inverse extended tables go after the quotient's transform
and the challenges' power tables at the proof's end, so that nothing a
proof builds after its peak sits in the next proof's.

Randomness is injectable (`seed`) so proofs are reproducible in tests —
the reference uses OsRng (prover.rs:286); byte-level determinism here is a
feature for differential testing.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from halo2_tpu_torch import native
from halo2_tpu_torch.circuit import Assignment, Cell, SimpleFloorPlanner
from halo2_tpu_torch.fields.bn254 import FR_MODULUS
from halo2_tpu_torch.multiopen import ProverQuery
from halo2_tpu_torch.multiopen import gwc, shplonk
from halo2_tpu_torch.plonk import logup_prover, shuffle_prover
from halo2_tpu_torch.plonk import permutation as perm_mod
from halo2_tpu_torch.plonk.error import (InstanceTooLarge,
                                         InvalidInstancesError,
                                         NotEnoughRowsAvailable,
                                         SynthesisError)
from halo2_tpu_torch.plonk.expr_eval import ExprCtx
from halo2_tpu_torch.plonk.range_check import fill_and_sort
from halo2_tpu_torch.plonk.vanishing import VanishingProver
from halo2_tpu_torch.poly import domain as domain_mod
from halo2_tpu_torch.poly.arith import PointPowers, eval_poly_batch
from halo2_tpu_torch.transcript import Blake2bWrite
from halo2_tpu_torch.utils.device import require_device
from halo2_tpu_torch.utils.profiling import phase_marker

P = FR_MODULUS

# from this many rows on, the prover runs the large-domain memory sequence
# (the reference's n >= 2^22 gates)
LARGE_N = 1 << 22


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
            self.advice[ci] = self.advice[ci].tolist()
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

    def assign_advice_big(self, ci, rows, values):
        """Exact writes of already-reduced values, some of 2^64 or more,
        into column `ci` (the parallel-synthesis overflow merge, one call
        a column and worker): the column degrades once if a value needs
        it."""
        if not rows:
            return
        col = self.advice[ci]
        vmax = max(values)
        if isinstance(col, np.ndarray) and vmax >> 64:
            col = self._degrade(ci)
        for row, v in zip(rows, values):
            col[row] = v
        self.max_assigned[ci] = max(self.max_assigned[ci], max(rows))
        self.max_value[ci] = max(self.max_value[ci], vmax)

    def supports_parallel_regions(self):
        # a column already degraded to Python ints would send every worker
        # write to it through the overflow records (no parallelism, and the
        # values over a pipe): such a collection runs its regions in turn
        return all(isinstance(c, np.ndarray) for c in self.advice)

    def share_columns(self):
        """Move the u64 advice columns into anonymous POSIX shared memory,
        so that forked synthesis workers write straight into them (the
        *mut [F] of prover.rs:1548-1626).  Returns the shared view of each
        column (None for a degraded column, whose worker writes go through
        the overflow merge).  Pair with unshare_columns() after the join:
        closing a SharedMemory unmaps its buffer under any view left."""
        from multiprocessing import shared_memory
        self._shms, self._shm_cols = [], set()
        for ci, col in enumerate(self.advice):
            if not isinstance(col, np.ndarray):
                continue
            shm = shared_memory.SharedMemory(create=True, size=col.nbytes)
            arr = np.ndarray(col.shape, np.uint64, buffer=shm.buf)
            arr[:] = col
            self.advice[ci] = arr
            self._shms.append(shm)
            self._shm_cols.add(ci)
            try:  # the mapping outlives the name: nothing leaks on a crash
                shm.unlink()
            except FileNotFoundError:
                pass
        return [self.advice[ci] if ci in self._shm_cols else None
                for ci in range(len(self.advice))]

    def unshare_columns(self):
        """Copy the columns out of shared memory and release the mappings
        (one copy a column)."""
        for ci in self._shm_cols:
            if isinstance(self.advice[ci], np.ndarray):
                self.advice[ci] = np.array(self.advice[ci], copy=True)
        self._shm_cols = set()
        for shm in self._shms:
            try:
                shm.close()
            except BufferError:  # a stray view still holds the mapping
                pass
        self._shms = []

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


def _pad_instances(cs, n, usable_rows, instances):
    """Instance columns zero-padded to n rows (InstanceTooLarge /
    InvalidInstancesError on a wrong shape)."""
    cols = []
    for col in instances:
        if len(col) > usable_rows:
            raise InstanceTooLarge()
        cols.append(list(col) + [0] * (n - len(col)))
    if len(cols) != cs.num_instance_columns:
        raise InvalidInstancesError()
    return cols


def _synthesize(pk, circuit, instance_cols, floor_planner):
    """Witness synthesis, the batch inversion of deferred rational cells
    (poly.rs:148-173) and the range-check fill: the WitnessCollection."""
    cs = pk.vk.cs
    n = 1 << pk.vk.k
    witness = WitnessCollection(cs, n, cs.usable_rows(n), instance_cols)
    planner = floor_planner or SimpleFloorPlanner
    planner.synthesize(witness, circuit, witness_config(pk, circuit),
                       cs.constants)
    witness.resolve_deferred()
    witness.fill_range_checks()
    return witness


def synthesize_witness(pk, circuit, instances, floor_planner=None):
    """Witness synthesis and the range-check fill only: (advice host
    columns, padded instance columns).  Backs the create_witness /
    create_proof_from_witness split (prover.rs:895-1523)."""
    cs = pk.vk.cs
    n = 1 << pk.vk.k
    instance_cols = _pad_instances(cs, n, cs.usable_rows(n), instances)
    witness = _synthesize(pk, circuit, instance_cols, floor_planner)
    return witness.advice, instance_cols


def create_witness(pk, circuit, instances, path: str, floor_planner=None):
    """Synthesize the witness and store it at `path` (io.save_witness)."""
    from halo2_tpu_torch.io.serialization import save_witness
    advice, _ = synthesize_witness(pk, circuit, instances, floor_planner)
    save_witness(advice, path)


def create_proof_from_witness(params, pk, instances, path: str,
                              seed: int | None = None, use_gwc: bool = True,
                              device="cuda", phases=None,
                              offload_lagrange: bool = False) -> bytes:
    """Prove from a witness file (create_witness), skipping synthesis: the
    same bytes as create_proof with the same seed."""
    from halo2_tpu_torch.io.serialization import load_witness
    witness_advice = load_witness(path, require_device(device))
    return create_proof(params, pk, None, instances, seed=seed,
                        use_gwc=use_gwc, device=device, phases=phases,
                        witness_advice=witness_advice,
                        offload_lagrange=offload_lagrange)


def create_proof(params, pk, circuit, instances, seed: int | None = None,
                 floor_planner=None, use_gwc: bool = True, device="cuda",
                 phases=None, witness_advice=None,
                 offload_lagrange: bool = False) -> bytes:
    """Prove one circuit instance. instances: list of instance columns
    (each a list of ints, length <= usable rows). Returns proof bytes.
    witness_advice: optional ((16, C, n) Montgomery Lagrange advice,
    per-column max bits), as io.load_witness gives it, instead of
    synthesis."""
    return create_proof_multi(
        params, pk, [circuit], [instances], seed=seed,
        floor_planner=floor_planner, use_gwc=use_gwc, device=device,
        phases=phases,
        witness_advice=None if witness_advice is None else [witness_advice],
        offload_lagrange=offload_lagrange)


def _cat(tensors):
    """(16, C_i, n) stacks -> one (16, sum C_i, n) (no copy for one)."""
    return tensors[0] if len(tensors) == 1 else torch.cat(tensors, dim=1)


def _split(stack, counts):
    """The inverse of _cat: (16, sum C_i, n) -> [(16, C_i, n)]."""
    if len(counts) == 1:
        return [stack]
    return list(torch.split(stack, counts, dim=1))


def create_proof_multi(params, pk, circuits, instances_list,
                       seed: int | None = None, floor_planner=None,
                       use_gwc: bool = True, device="cuda", phases=None,
                       witness_advice=None,
                       offload_lagrange: bool = False) -> bytes:
    """Prove several instances of one circuit in one proof (the
    reference's create_proof over &[ConcreteCircuit], prover.rs:206-850):
    every per-proof commitment and evaluation in the reference transcript
    order, the h numerator chained across proofs, one quotient.  `device`
    must be the one `params` and `pk` live on; `phases` is an optional
    utils.profiling.PhaseTimes that receives per-phase seconds; use_gwc
    False opens with SHPLONK.  witness_advice: optional list, per proof,
    of what io.load_witness returns, instead of synthesis.
    offload_lagrange: move the Lagrange SRS (and, from n >= LARGE_N on, the
    key's Lagrange forms) to host memory once the proof is done with them
    (the reference's HALO2_TPU_OFFLOAD_SRS=1); the next proof brings them
    back.  The proof bytes do not change."""
    device = require_device(device)
    if params.device != device:
        raise ValueError(f"params are on {params.device}, create_proof was "
                         f"asked for {device}")
    if len(circuits) != len(instances_list):
        raise ValueError("one instance list per circuit")
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
    proofs = range(len(circuits))
    n_adv, n_inst = cs.num_advice_columns, cs.num_instance_columns

    _pm = phase_marker(device, phases)
    large = n >= LARGE_N
    # what a prior proof offloaded comes back (the SRS's upload is
    # asynchronous and overlaps the synthesis below)
    pk.onload_lagrange_forms()
    params._lagrange_dev()
    # 1. vk hash + every proof's instance commitments, in one batch
    # (absorbed as common points)
    vk.hash_into(transcript)
    instance_cols = [_pad_instances(cs, n, usable_rows, inst)
                     for inst in instances_list]
    instance_lagrange = [
        torch.stack([F.encode(c) for c in cols], dim=1) if cols
        else F.zeros((0, n)) for cols in instance_cols]
    for pt in params.commit_many_affine(
            [lag[:, i, :] for lag in instance_lagrange
             for i in range(n_inst)], base="lagrange"):
        transcript.common_point(pt)

    _pm("instances")
    # 2. witness synthesis per proof (the advice blinds drawn proof by
    # proof), then every proof's advice commitments in one batch
    def col_to_dev(c):
        # columnar staging: u64 columns upload RAW (8 B/value), degraded
        # bigint columns upload 32-byte canonical rows (exported by the
        # host codec, decoded by one kernel); both convert
        # canonical->Montgomery on the device (one mul by R^2)
        if isinstance(c, np.ndarray):
            return F.encode_u64_dev(c[None])[:, 0, :]
        return F.encode_le_bytes_dev(native.longs_to_blob(c, P), n)

    advice_lagrange, advice_bits = [], []
    for p_i in proofs:
        if witness_advice is not None:
            # the blinding rows and bounds of the synthesis path below, so
            # that a proof from a witness file has create_proof's bytes
            # (the reference's loaded-witness path blinds named advice too)
            lag, col_bits = witness_advice[p_i]
            lag = lag.clone()
            for ci in range(n_adv):
                if ci in cs.named_advices:
                    advice_bits.append(col_bits[ci])
                    continue
                lag[:, ci, usable_rows:] = F.encode(
                    [rng.randrange(1 << 16) for _ in range(usable_rows, n)])
                advice_bits.append(max(col_bits[ci], 16))
            advice_lagrange.append(lag)
            continue
        witness = _synthesize(pk, circuits[p_i], instance_cols[p_i],
                              floor_planner)
        # u16 blinding rows (prover.rs:283-290); named advice exempt
        for ci, col in enumerate(witness.advice):
            if ci in cs.named_advices:
                continue
            for r in range(usable_rows, n):
                col[r] = rng.randrange(1 << 16)
            witness.max_value[ci] = max(witness.max_value[ci], (1 << 16) - 1)
        if witness.advice and all(isinstance(c, np.ndarray)
                                  for c in witness.advice):
            advice_lagrange.append(F.encode_u64_dev(np.stack(witness.advice)))
        elif witness.advice:
            advice_lagrange.append(torch.stack(
                [col_to_dev(c) for c in witness.advice], dim=1))
        else:
            advice_lagrange.append(F.zeros((0, n)))
        # bounded-window commit bound from the running max (no O(n) host
        # bit-length pass; prover.rs:237-254)
        advice_bits += [max(v.bit_length(), 1) for v in witness.max_value]
        del witness
    for pt in params.commit_many_affine(
            [lag[:, i, :] for lag in advice_lagrange for i in range(n_adv)],
            [_quantize_max_bits(b) for b in advice_bits], base="lagrange"):
        transcript.write_point(pt)

    _pm("advice synth+commit")
    # 3. theta; per proof, lookup compression + m(X) (m tails drawn proof
    # by proof), then every m commitment in one batch
    theta = transcript.squeeze_challenge()
    theta_l = F.encode_scalar(theta)
    lag_ctxs = [ExprCtx(advice_lagrange[p_i], pk.fixed_lagrange,
                        instance_lagrange[p_i], rot_scale=1, length=n)
                for p_i in proofs]
    lookup_data = [[] for _ in proofs]
    m_bits = []
    for p_i in proofs:
        for lookup in cs.lookups:
            table, input_sets = logup_prover.compress(lookup, lag_ctxs[p_i],
                                                      theta_l)
            m_lag, bits = logup_prover.multiplicities(
                table, [c for s in input_sets for c in s], usable_rows, rng)
            lookup_data[p_i].append((table, input_sets, m_lag))
            m_bits.append(bits)
    for pt in params.commit_many_affine(
            [m_ for data in lookup_data for _, _, m_ in data],
            [m_commit_bits(b) for b in m_bits], base="lagrange"):
        transcript.write_point(pt)

    _pm("lookup compress+m")
    # 4. shuffle compression; beta, gamma
    shuffle_data = [[shuffle_prover.compress(group, lag_ctxs[p_i], theta_l)
                     for group in cs.shuffles] for p_i in proofs]
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    _pm("shuffle compress")
    # 5. permutation z commits proof by proof, then every proof's lookup
    # zs, then every proof's shuffle zs (the blinds in that order); the
    # argument zs in one batched commitment
    perm_zs = []
    for p_i in proofs:
        def value_col(column, p_i=p_i):
            if column.ctype == "advice":
                return advice_lagrange[p_i][:, column.index, :]
            if column.ctype == "fixed":
                return pk.fixed_lagrange[:, column.index, :]
            return instance_lagrange[p_i][:, column.index, :]

        zs, z_commitments = perm_mod.commit_z_polys(
            params, domain, cs, pk.permutation_pk, value_col, beta, gamma,
            rng)
        for com in z_commitments:
            transcript.write_point(com)
        perm_zs.append(zs)
    lookup_zs = [[logup_prover.commit_zs(domain, cs, table, input_sets,
                                         m_lag, beta, rng)
                  for table, input_sets, m_lag in lookup_data[p_i]]
                 for p_i in proofs]
    shuffle_zs = [[shuffle_prover.commit_product(domain, cs, inputs,
                                                 shuffles, beta, rng)
                   for inputs, shuffles in shuffle_data[p_i]]
                  for p_i in proofs]
    lookup_zs_flat = [[z for zset in lzs for z in zset] for lzs in lookup_zs]
    for com in params.commit_many_affine(
            [z for zs in lookup_zs_flat for z in zs]
            + [z for zs in shuffle_zs for z in zs], base="lagrange"):
        transcript.write_point(com)
    # the compressed Lagrange forms die here
    lookup_ms = [[m_ for _, _, m_ in data] for data in lookup_data]
    del lag_ctxs, lookup_data, shuffle_data

    _pm("grand products/sums")
    if offload_lagrange and large:
        # the key's Lagrange forms are dead from here on (256 MiB a column
        # at k = 22)
        pk.offload_lagrange_forms()
    # 6. vanishing random poly -> y
    vanishing = VanishingProver(params, domain, rng)
    transcript.write_point(vanishing.random_commitment)
    y = transcript.squeeze_challenge()

    _pm("vanishing commit")
    if offload_lagrange:
        # every Lagrange-basis commitment is made: the SRS's Lagrange basis
        # (512 MiB at k = 22) can leave the device
        params.offload_lagrange()
    # 7. coeff forms: every column of one kind, of every proof, in one
    # batched iNTT; from LARGE_N on proof by proof, each stack handed over
    # to its transform (one concatenation would double the stacks).  Under
    # a mesh the transform is the four-step one over it (the multi-GPU
    # lagrange_to_coeff_st of prover.rs:639-661), its result gathered.
    mesh, mesh_axis = params.mesh, params.mesh_axis
    use_dist_ntt = mesh is not None and n >= params.MESH_MSM_MIN
    if use_dist_ntt:
        dist = domain.dist_ntt(mesh, mesh_axis)

        def ntt_inverse(box):
            return dist.inverse(box).gather(device)
    else:
        ntt_inverse = domain.ntt.inverse

    def to_coeff(per_proof):
        """per proof a (16, C_i, n) stack, taken out of the list -> per
        proof its coeff form."""
        counts = [t.shape[1] for t in per_proof]
        if large:
            out = []
            for p_i in proofs:
                box, per_proof[p_i] = [per_proof[p_i]], None
                out.append(ntt_inverse(box) if counts[p_i] else box[0])
            return out
        if not sum(counts):
            return per_proof
        return _split(ntt_inverse([_cat(per_proof)]), counts)

    def stacks(per_proof_lists):
        """per proof a list of (16, n) columns -> per proof one stack; the
        columns live on in the stacks only."""
        out = []
        for cols in per_proof_lists:
            out.append(torch.stack(cols, dim=1) if cols else F.zeros((0, n)))
            cols.clear()
        return out

    sets_of = [[len(zset) for zset in lzs] for lzs in lookup_zs]
    del lookup_zs
    advice_coeff = to_coeff(advice_lagrange)
    instance_coeff = to_coeff(instance_lagrange)
    perm_z_stack = to_coeff(stacks(perm_zs))
    lookup_m_stack = to_coeff(stacks(lookup_ms))
    lookup_z_stack = to_coeff(stacks(lookup_zs_flat))
    shuffle_z_stack = to_coeff(stacks(shuffle_zs))
    del advice_lagrange, instance_lagrange, perm_zs, lookup_ms
    del lookup_zs_flat, shuffle_zs
    perm_z_coeffs = [list(s.unbind(1)) for s in perm_z_stack]
    lookup_m_coeffs = [list(s.unbind(1)) for s in lookup_m_stack]
    shuffle_z_coeffs = [list(s.unbind(1)) for s in shuffle_z_stack]
    lookup_z_coeffs = []
    for p_i in proofs:
        flat_lz = iter(lookup_z_stack[p_i].unbind(1))
        lookup_z_coeffs.append([[next(flat_lz) for _ in range(c)]
                                for c in sets_of[p_i]])

    _pm("iNTTs")
    if large:
        # the offloads' device memory is freed before the extended-domain
        # working set needs it
        pk.join_offloads()
        params.join_offload()
    # 8. h evaluation, the fold chained across proofs
    # (evaluation.rs:900-1000); row-sharded over the mesh under use_mesh
    ev = pk.sharded_ev(mesh, mesh_axis) if mesh is not None else pk.ev
    h_ext = None
    for p_i in proofs:
        h_ext = ev.evaluate_h(
            advice_coeff[p_i], instance_coeff[p_i], perm_z_stack[p_i],
            lookup_m_stack[p_i], lookup_z_stack[p_i], shuffle_z_stack[p_i],
            theta, beta, gamma, y, value_init=h_ext)

    _pm("evaluate_h")
    if domain.extended_n >= domain_mod.STREAM_NTT_MIN:
        # the forward extended tables (a 512 MiB mid table at 2^23) are
        # dead until the next proof's coset extensions
        domain.ntt_ext.drop_tables(inverse=False)
    # 9. vanishing construct -> x; the h values handed over (the extended
    # iNTT over the mesh under use_mesh: evaluation_gpu.rs:863-911's
    # per-GPU extended iFFTs)
    box, h_ext = [h_ext], None
    h_pieces, h_commitments = vanishing.construct(box, mesh, mesh_axis)
    # the inverse extended tables serve this one transform: built after
    # the evaluate_h peak, kept they would sit in the next proof's (256 MiB
    # at 2^22)
    domain.ntt_ext.drop_tables(inverse=True)
    if mesh is not None:
        domain.dist_ntt(mesh, mesh_axis, extended=True).drop_tables()
    for com in h_commitments:
        transcript.write_point(com)
    x = transcript.squeeze_challenge()
    xn = pow(x, n, P)

    _pm("h split+commit")
    # every column sliced once, so that one commitment is one object in the
    # queries (SHPLONK groups its queries by object identity)
    instance_polys = [list(s.unbind(1)) for s in instance_coeff]
    advice_polys = [list(s.unbind(1)) for s in advice_coeff]
    fixed_polys = list(pk.fixed_coeff.unbind(1))
    sigma_polys = list(pk.permutation_pk.sigmas_coeff.unbind(1))
    h_poly = vanishing.fold_h(h_pieces, xn)
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
    for p_i in proofs:
        for column, rot in cs.instance_queries:
            plan.append((instance_polys[p_i][column.index],
                         domain.rotate_omega(x, rot)))
    for p_i in proofs:
        for column, rot in cs.advice_queries:
            plan.append((advice_polys[p_i][column.index],
                         domain.rotate_omega(x, rot)))
    for column, rot in cs.fixed_queries:
        plan.append((fixed_polys[column.index], domain.rotate_omega(x, rot)))
    plan.append((vanishing.random_poly, x))
    plan += [(sigma, x) for sigma in sigma_polys]
    for p_i in proofs:
        plan += z_chain_plan(perm_z_coeffs[p_i])
    for p_i in proofs:
        for m_coeff, zcs in zip(lookup_m_coeffs[p_i], lookup_z_coeffs[p_i]):
            plan.append((m_coeff, x))
            plan += z_chain_plan(zcs)
    for p_i in proofs:
        for zc in shuffle_z_coeffs[p_i]:
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
    # 11. multiopen queries (prover.rs:792-846: the proofs' own sections,
    # then fixed / permutation-common / vanishing)
    def z_chain_queries(zcs):
        out = []
        for zc in zcs:
            out += [ProverQuery(x, 0, zc), ProverQuery(x_next, 1, zc)]
        for zc in reversed(zcs[:-1]):
            out.append(ProverQuery(x_last, -(bf + 1), zc))
        return out

    queries = []
    for p_i in proofs:
        for column, rot in cs.instance_queries:
            queries.append(ProverQuery(domain.rotate_omega(x, rot), rot,
                                       instance_polys[p_i][column.index]))
        for column, rot in cs.advice_queries:
            queries.append(ProverQuery(domain.rotate_omega(x, rot), rot,
                                       advice_polys[p_i][column.index]))
        queries += z_chain_queries(perm_z_coeffs[p_i])
        for m_coeff, zcs in zip(lookup_m_coeffs[p_i], lookup_z_coeffs[p_i]):
            queries.append(ProverQuery(x, 0, m_coeff))
            queries += z_chain_queries(zcs)
        for zc in shuffle_z_coeffs[p_i]:
            queries += [ProverQuery(x, 0, zc), ProverQuery(x_next, 1, zc)]
    for column, rot in cs.fixed_queries:
        queries.append(ProverQuery(domain.rotate_omega(x, rot), rot,
                                   fixed_polys[column.index]))
    queries += [ProverQuery(x, 0, sigma) for sigma in sigma_polys]
    queries.append(ProverQuery(x, 0, h_poly))
    queries.append(ProverQuery(x, 0, vanishing.random_poly))

    (gwc if use_gwc else shplonk).create_proof(params, transcript, queries)
    # this proof's challenges are never drawn again: their power tables go
    PointPowers.clear()
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
