"""Key generation: vk/pk assembly.

Re-design of halo2_proofs/src/plonk/keygen.rs:
  * `KeygenAssembly` collects fixed values / selector enables / copies on
    host (the analogue of AssemblyAssigner, keygen.rs:69-231; synthesis is
    single-threaded host code feeding vectorized device encodes)
  * fixed polys batched iNTT; permutation build via
    halo2_tpu_torch.plonk.permutation.build_keys (keygen.rs:379-432)
  * l0 / l_last / l_blind kept COEFF-form; every extended coset (fixed,
    sigma, l-polys) is produced transiently inside the h evaluation — the
    reference cuda path's "coeff resident, extended transient" memory
    discipline (plonk.rs:226-243, evaluation_gpu.rs:863-911)
  * vk hash (plonk.rs:91-109): Blake2b-512, personalization
    "Halo2-Verify-Key" over the Rust Debug rendering of
    PinnedVerificationKey (plonk/pinned.py)
  * selector compression (circuit.rs:1603-1734) runs between synthesis and
    the fixed-column commits, exactly as keygen_vk does (keygen.rs:258-263)
"""

from __future__ import annotations

import hashlib

import torch

from halo2_tpu_torch.circuit import Assignment, Cell, SimpleFloorPlanner
from halo2_tpu_torch.fields.bn254 import FQ_MODULUS, FR_MODULUS
from halo2_tpu_torch.plonk import permutation as perm_mod
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.error import NotEnoughRowsAvailable
from halo2_tpu_torch.plonk.evaluator import Evaluator
from halo2_tpu_torch.plonk.evaluator_sharded import ShardedEvaluator
from halo2_tpu_torch.poly.arith import PointPowers
from halo2_tpu_torch.poly.domain import EvaluationDomain
from halo2_tpu_torch.utils import offload, profiling
from halo2_tpu_torch.utils.device import require_device

P = FR_MODULUS


class KeygenAssembly(Assignment):
    """Collects fixed column values, selector enables, and copies."""

    def __init__(self, cs: ConstraintSystem, n: int, usable_rows: int):
        self.cs = cs
        self.n = n
        self.usable_rows = usable_rows
        self.fixed = [[0] * n for _ in range(cs.num_fixed_columns)]
        self.selectors = [[False] * n for _ in range(cs.num_selectors)]
        self.perm = perm_mod.Assembly(cs.permutation.columns, n)
        # deferred Assigned rationals: (col, row, num, den), resolved with
        # one batch inversion before the fixed columns are consumed
        # (keygen.rs:258 batch_invert_assigned)
        self.deferred = []

    def enable_selector(self, selector, row):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        self.selectors[selector.index][row] = True

    def assign_advice(self, column, row, value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        # advice ignored during keygen

    def assign_advice_bulk(self, column, from_row, values):
        if from_row + len(values) > self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        # advice ignored during keygen

    def assign_fixed(self, column, row, value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        if value is None:
            return
        from halo2_tpu_torch.plonk.assigned import Assigned
        if isinstance(value, Assigned):
            if value.is_trivial() or value.is_zero():
                self.fixed[column.index][row] = value.num if value.den else 0
            else:
                self.deferred.append((column.index, row,
                                      value.num, value.den))
            return
        self.fixed[column.index][row] = value % P

    def resolve_deferred(self):
        """batch_invert_assigned analogue: one inversion for every deferred
        rational fixed value (poly.rs:148-173)."""
        from halo2_tpu_torch.plonk.assigned import resolve_deferred

        def write(ci, row, v):
            self.fixed[ci][row] = v
        resolve_deferred(self.deferred, write)
        self.deferred = []

    def copy(self, left: Cell, right: Cell):
        self.perm.copy(left.column, left.row, right.column, right.row)

    def query_instance(self, column, row):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.n.bit_length() - 1)
        return None  # instance values unknown at keygen

    def fill_from_row(self, column, from_row, value):
        if value is None:
            return
        for r in range(from_row, self.usable_rows):
            self.fixed[column.index][r] = value % P

    def is_in_prove_mode(self):
        return False


class _SelectorOnlyAssembly(Assignment):
    """Synthesis backend that records ONLY selector activations — used to
    rebuild a compressed ConstraintSystem without re-deriving fixed values
    (a key carried over from elsewhere needs the post-compression CS
    structure, which depends on which rows each selector enables)."""

    def __init__(self, num_selectors: int, n: int):
        self.selectors = [[False] * n for _ in range(num_selectors)]

    def enable_selector(self, selector, row):
        self.selectors[selector.index][row] = True

    def assign_advice(self, column, row, value):
        pass

    def assign_advice_bulk(self, column, from_row, values):
        pass

    def assign_fixed(self, column, row, value):
        pass

    def copy(self, left, right):
        pass

    def query_instance(self, column, row):
        return None

    def fill_from_row(self, column, from_row, value):
        pass


def rebuild_cs(circuit, n: int, floor_planner=None):
    """configure + chunk + selector compression for a circuit, without
    assigning any values.  Returns (cs, config, degree) where degree is the
    PRE-compression constraint degree (what keygen sized the domain with —
    create_domain runs before compression, keygen.rs:34-52).  This is what
    halo2_tpu_torch.convert's callers use so the rebuilt CS structure (fixed column
    count, queries, substituted gates, selector_map) matches keygen's."""
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    degree = cs.degree()
    if cs.num_selectors:
        assembly = _SelectorOnlyAssembly(cs.num_selectors, n)
        planner = floor_planner or SimpleFloorPlanner
        planner.synthesize(assembly, circuit.without_witnesses(), config,
                           cs.constants)
        cs.compress_selectors(assembly.selectors)
    return cs, config, degree


class VerifyingKey:
    def __init__(self, domain, cs, fixed_commitments, permutation_vk, k):
        self.domain = domain
        self.cs = cs
        self.fixed_commitments = fixed_commitments  # host points
        self.permutation = permutation_vk
        self.k = k

    def hash_into(self, transcript):
        """Blake2b-512("Halo2-Verify-Key", len || pinned-debug-string) ->
        common scalar, byte-identical to VerifyingKey::hash_into
        (plonk.rs:91-109)."""
        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        s = self.pinned().encode()
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
        transcript.common_scalar(int.from_bytes(h.digest(), "little") % P)

    def pinned(self) -> str:
        """format!("{:?}", vk.pinned()) — the exact Rust Debug rendering of
        PinnedVerificationKey (plonk.rs:111-133), see plonk/pinned.py."""
        from halo2_tpu_torch.plonk.pinned import pinned_vk_str
        return pinned_vk_str(self, base_modulus=FQ_MODULUS,
                             scalar_modulus=FR_MODULUS,
                             omega=self.domain.omega)


class ProvingKey:
    def __init__(self, vk, fixed_lagrange, fixed_coeff, permutation_pk,
                 l0_coeff, l_last_coeff, l_blind_coeff, config=None):
        self.vk = vk
        # the config object produced by the ONE configure() run at keygen
        # time; the prover reuses it for witness synthesis instead of
        # re-running configure() on a throwaway CS (which silently desyncs
        # columns if configure() has any statefulness). None only for pks
        # rebuilt from carried-over state, where no Circuit instance exists.
        self.config = config
        self.fixed_lagrange = fixed_lagrange
        self.fixed_coeff = fixed_coeff
        self.permutation_pk = permutation_pk
        self.l0_coeff = l0_coeff
        self.l_last_coeff = l_last_coeff
        self.l_blind_coeff = l_blind_coeff
        self.ev = Evaluator(self)
        self._sharded_evs = {}
        self._forms_copy = None           # an offload in flight
        self._forms_on_host = False

    def sharded_ev(self, mesh, axis: str = "x"):
        """The cached h-evaluator over a mesh of devices
        (plonk/evaluator_sharded.py); the prover takes it when
        params.use_mesh is set."""
        key = (mesh, axis)
        if key not in self._sharded_evs:
            self._sharded_evs[key] = ShardedEvaluator(self, mesh, axis)
        return self._sharded_evs[key]

    # -- device memory relief at large k (keygen.py:199-234) --------------
    def offload_lagrange_forms(self):
        """Start moving the Lagrange forms — the fixed columns and the
        permutation's sigmas, 256 MiB a column at k = 22 — to host memory:
        a proof reads them last in its grand products.  join_offloads
        frees their device memory, onload_lagrange_forms brings them
        back (the prover does at the start of every proof)."""
        if self._forms_on_host or self._forms_copy is not None:
            return
        profiling.incr("lagrange_offloads")
        self._forms_copy = offload.HostCopy(
            [self.fixed_lagrange, self.permutation_pk.sigmas_lagrange])

    def join_offloads(self):
        """Finish a pending offload: the device copies are released."""
        if self._forms_copy is not None:
            (self.fixed_lagrange,
             self.permutation_pk.sigmas_lagrange) = self._forms_copy.join()
            self._forms_copy = None
            self._forms_on_host = True

    def onload_lagrange_forms(self):
        self.join_offloads()
        if self._forms_on_host:
            dev = self.vk.domain.device
            self.fixed_lagrange = offload.onload(self.fixed_lagrange, dev)
            self.permutation_pk.sigmas_lagrange = offload.onload(
                self.permutation_pk.sigmas_lagrange, dev)
            self._forms_on_host = False


def keygen(params, circuit, floor_planner=None, device="cuda", phases=None):
    """keygen_vk + keygen_pk in one pass (keygen.rs:233-455).  `device`
    must be the one `params` lives on; `phases` is an optional
    utils.profiling.PhaseTimes that receives per-phase seconds."""
    device = require_device(device)
    if params.device != device:
        raise ValueError(f"params are on {params.device}, keygen was asked "
                         f"for {device}")
    _pm = profiling.phase_marker(device, phases, scope="keygen")
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    # chunk lookups and shuffles by degree (circuit_configure,
    # plonk/circuit.rs:1316-1324)
    cs.chunk_lookups()
    cs.chunk_shuffles()
    degree = cs.degree()
    k = params.k
    n = params.n
    if n < cs.minimum_rows():
        raise NotEnoughRowsAvailable(k)
    domain = EvaluationDomain(degree, k, device)
    F = domain.F
    usable_rows = cs.usable_rows(n)

    assembly = KeygenAssembly(cs, n, usable_rows)
    planner = floor_planner or SimpleFloorPlanner
    planner.synthesize(assembly, circuit.without_witnesses(), config, cs.constants)
    assembly.resolve_deferred()   # batch_invert_assigned (keygen.rs:258)

    # pack selectors into combination fixed columns and substitute their
    # expressions (keygen.rs:258-263 -> circuit.rs:1603-1734)
    if cs.num_selectors:
        combos = cs.compress_selectors(assembly.selectors)
        assembly.fixed.extend(combos)
    _pm("synthesize")

    # fixed polys
    if cs.num_fixed_columns:
        fixed_lagrange = torch.stack(
            [F.encode(col) for col in assembly.fixed], dim=1)
        fixed_coeff = domain.ntt.inverse(fixed_lagrange)
    else:
        fixed_lagrange = F.zeros((0, n))
        fixed_coeff = fixed_lagrange
    fixed_commitments = params.commit_many_affine(
        [fixed_lagrange[:, i, :] for i in range(fixed_lagrange.shape[1])],
        base="lagrange")

    _pm("fixed iNTT+commit")
    perm_vk, perm_pk = perm_mod.build_keys(params, domain, assembly.perm)
    _pm("permutation")

    vk = VerifyingKey(domain, cs, fixed_commitments, perm_vk, k)

    # lagrange-basis helper polys, coeff-form (keygen.rs:397-432; the
    # extended cosets are produced inside the h evaluation)
    bf = cs.blinding_factors()
    l0, l_last, l_blind = l_polys_coeff(domain, bf)

    pk = ProvingKey(vk, fixed_lagrange, fixed_coeff, perm_pk,
                    l0, l_last, l_blind, config=config)
    _pm("l polys+evaluator")
    return vk, pk


def l_polys_coeff(domain, bf: int):
    """Coefficient forms of l_0, l_last and l_blind for `bf` blinding rows.

    Coeff form of a sum of Lagrange one-hots WITHOUT an iNTT: the inverse
    transform of a one-hot at row i is coeffs[j] = omega^{-ij}/n, so each
    row contributes one device powers table scaled by 1/n."""
    F = domain.F
    n = domain.n
    scale = F.encode_scalar(pow(n, P - 2, P))

    def closed(one_rows):
        acc = None
        for r in one_rows:
            tab = PointPowers._build(pow(domain.omega_inv, r, P), n,
                                     domain.device)
            acc = tab if acc is None else F.add(acc, tab)
        return F.mul(acc, scale)

    return (closed([0]), closed([n - (bf + 1)]), closed(range(n - bf, n)))
