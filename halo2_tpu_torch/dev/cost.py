"""Circuit cost model.

Analogue of halo2_proofs/src/dev/cost.rs: `CircuitCost`
measures a circuit's shape (columns, degree, rows) and models proof size and
prover work (MSM/NTT counts) without running the crypto."""

from __future__ import annotations

from dataclasses import dataclass

from halo2_tpu_torch.plonk.circuit import ConstraintSystem


@dataclass
class CircuitCost:
    k: int
    max_degree: int
    extended_k: int
    advice_columns: int
    fixed_columns: int
    instance_columns: int
    gates: int
    gate_constraints: int
    permutation_columns: int
    permutation_sets: int
    lookups: int
    lookup_sets: int
    lookup_set_counts: list
    shuffle_groups: int
    usable_rows: int
    blinding_factors: int
    num_rotations: int

    @classmethod
    def measure(cls, k: int, circuit, floor_planner=None) -> "CircuitCost":
        # full keygen-equivalent CS: configure + chunk + selector
        # compression, so column/query counts match the real keys; a
        # circuit laid out with absolute rows names its FlatFloorPlanner
        from halo2_tpu_torch.plonk.keygen import rebuild_cs
        cs, _, degree = rebuild_cs(circuit, 1 << k, floor_planner)
        return cls.of_cs(k, cs, degree)

    @classmethod
    def of_cs(cls, k: int, cs: ConstraintSystem, degree: int) -> "CircuitCost":
        """The cost of a built constraint system (configured, chunked and
        compressed) whose domain was sized for constraint degree
        `degree`."""
        extended_k = k
        n = 1 << k
        while (1 << extended_k) < n * max(degree - 1, 1):
            extended_k += 1
        chunk = max(degree - 2, 1)
        perm_sets = -(-len(cs.permutation.columns) // chunk) \
            if cs.permutation.columns else 0
        # distinct multiopen rotations: every query rotation, plus cur/next
        # for the z polynomials, plus the chained-set "last" rotation
        rotations = {r for _, r in (cs.advice_queries + cs.fixed_queries
                                    + cs.instance_queries)}
        rotations |= {0, 1}
        chained = (perm_sets > 1
                   or any(len(lk.input_expressions_sets) > 1
                          for lk in cs.lookups))
        if chained:
            rotations.add(-(cs.blinding_factors() + 1))
        return cls(
            k=k,
            max_degree=degree,
            extended_k=extended_k,
            advice_columns=cs.num_advice_columns,
            fixed_columns=cs.num_fixed_columns,
            instance_columns=cs.num_instance_columns,
            gates=len(cs.gates),
            gate_constraints=sum(len(g.polys) for g in cs.gates),
            permutation_columns=len(cs.permutation.columns),
            permutation_sets=perm_sets,
            lookups=len(cs.lookups),
            lookup_sets=sum(len(lk.input_expressions_sets) for lk in cs.lookups),
            lookup_set_counts=[len(lk.input_expressions_sets)
                               for lk in cs.lookups],
            shuffle_groups=len(cs.shuffles),
            usable_rows=cs.usable_rows(n),
            blinding_factors=cs.blinding_factors(),
            num_rotations=len(rotations),
        )

    # -- proof size (bytes), mirrors dev/cost.rs:243-354 -------------------
    def proof_points(self) -> int:
        quotient = max(self.max_degree - 1, 1)
        return (self.advice_columns           # advice commitments
                + self.lookups                 # m commitments
                + self.permutation_sets        # permutation z
                + self.lookup_sets             # lookup z
                + self.shuffle_groups          # shuffle z
                + 1                            # vanishing random
                + quotient)                    # h pieces

    def proof_scalars(self, cs: ConstraintSystem | None = None) -> int:
        perm_evals = 3 * self.permutation_sets - 1 if self.permutation_sets else 0
        # per lookup argument with s sets: m(x) + per z {z(x), z(wx)} +
        # the chained-set last rotation for all but the final z
        lookup_evals = sum(1 + 3 * s - 1 for s in self.lookup_set_counts)
        return (perm_evals + lookup_evals
                + 2 * self.shuffle_groups       # z(x), z(wx)
                + self.permutation_columns      # sigma evals
                + 1)                            # random eval

    def proof_size_gwc(self, num_rotations: int | None = None) -> int:
        """Approximate proof bytes under GWC (one witness per rotation,
        rotation count derived from the measured query set)."""
        if num_rotations is None:
            num_rotations = self.num_rotations
        return 32 * (self.proof_points() + num_rotations
                     + self.proof_scalars())

    def prover_msms(self) -> int:
        """Size-n MSM count per proof (commit phases + multiopen)."""
        return self.proof_points() + 3

    def prover_ntts(self) -> int:
        """Size-n (i)NTT count per proof (coeff conversions + extensions)."""
        cols = (self.advice_columns + self.instance_columns +
                self.permutation_sets + self.lookup_sets + self.lookups +
                self.shuffle_groups)
        return 2 * cols + 2  # iNTT + extended NTT per column + h transforms
