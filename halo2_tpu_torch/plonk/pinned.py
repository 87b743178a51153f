"""Byte-exact Rust Debug rendering of the pinned verification key.

The reference hashes `format!("{:?}", vk.pinned())` into the transcript
(Blake2b-512, personalization "Halo2-Verify-Key" —
halo2_proofs/src/plonk.rs:91-120).  Cross-stack vk-hash
equality therefore requires reproducing, byte for byte:

  * the derived Debug of `PinnedVerificationKey` (field order: base_modulus,
    scalar_modulus, domain, cs, fixed_commitments, permutation —
    plonk.rs:126-133 struct order),
  * `PinnedEvaluationDomain` (poly/domain.rs:544-548),
  * the fork's CUSTOM `PinnedConstraintSystem::to_string`
    (plonk/circuit.rs:1145-1181: `PinnedConstraintSystem{k:v,...}` with no
    spaces, trailing-comma entry lists for gates/lookups/shuffles),
  * derived Debug of `Expression` / `Column` / `Rotation` /
    `permutation::Argument` / `InputExpressionSet`,
  * the external `pairing_bn256` crate's Debug impls: field elements render
    as `0x` + 64 lowercase hex digits of the canonical (non-Montgomery)
    value, affine points as `(x, y)` tuples (the crate lineage that became
    halo2curves; see e.g. the PSE halo2 pinned-vk test fixtures, which show
    commitments in exactly this tuple form).

Rust derive(Debug) non-alternate formatting rules used here:
  struct  -> `Name { field: value, field2: value2 }`
  tuple   -> `Name(a, b)` / `(a, b)`
  Vec     -> `[a, b]`
  Option  -> `None` / `Some(v)`
  String  -> `"..."` (our pinned CS string contains no escapes)
"""

from __future__ import annotations

from halo2_tpu_torch.plonk import circuit as cir

_CTYPE_RUST = {"advice": "Advice", "fixed": "Fixed", "instance": "Instance"}


def fr_debug(value: int) -> str:
    """Canonical field value -> pairing_bn256 Debug: 0x + 64 hex digits."""
    return f"0x{value:064x}"


def point_debug(point) -> str:
    """Host affine point (x, y) ints (or None = identity) -> Debug."""
    if point is None:
        return "Infinity"
    x, y = point
    return f"({fr_debug(x)}, {fr_debug(y)})"


def column_debug(col) -> str:
    return (f"Column {{ index: {col.index}, "
            f"column_type: {_CTYPE_RUST[col.ctype]} }}")


def rotation_debug(rot: int) -> str:
    return f"Rotation({int(rot)})"


def expr_debug(e) -> str:
    """Derived Debug of Expression (plonk/circuit.rs:453-494)."""
    if isinstance(e, cir.Constant):
        return f"Constant({fr_debug(e.value)})"
    if isinstance(e, cir.SelectorExpr):
        s = e.selector
        return f"Selector(Selector({s.index}, {str(s.is_simple).lower()}))"
    if isinstance(e, cir.FixedQuery):
        return (f"Fixed {{ query_index: {e.query_index}, "
                f"column_index: {e.column_index}, "
                f"rotation: {rotation_debug(e.rotation)} }}")
    if isinstance(e, cir.AdviceQuery):
        return (f"Advice {{ query_index: {e.query_index}, "
                f"column_index: {e.column_index}, "
                f"rotation: {rotation_debug(e.rotation)} }}")
    if isinstance(e, cir.InstanceQuery):
        return (f"Instance {{ query_index: {e.query_index}, "
                f"column_index: {e.column_index}, "
                f"rotation: {rotation_debug(e.rotation)} }}")
    if isinstance(e, cir.Negated):
        return f"Negated({expr_debug(e.expr)})"
    if isinstance(e, cir.Sum):
        return f"Sum({expr_debug(e.a)}, {expr_debug(e.b)})"
    if isinstance(e, cir.Product):
        return f"Product({expr_debug(e.a)}, {expr_debug(e.b)})"
    if isinstance(e, cir.Scaled):
        return f"Scaled({expr_debug(e.expr)}, {fr_debug(e.scalar)})"
    raise TypeError(f"unknown expression node {type(e)}")


def _vec(items) -> str:
    return "[" + ", ".join(items) + "]"


def _queries_debug(queries) -> str:
    return _vec(f"({column_debug(c)}, {rotation_debug(r)})"
                for c, r in queries)


def pinned_cs_str(cs) -> str:
    """The fork's PinnedConstraintSystem::to_string
    (plonk/circuit.rs:1145-1181) — custom format, NO spaces around
    `{`/`:`/`,` at the top level, trailing commas inside gates/lookups/
    shuffles lists."""
    gates = "[" + "".join(
        expr_debug(p) + "," for g in cs.gates for p in g.polys) + "]"

    lookups = "["
    for i, arg in enumerate(cs.lookups):
        sets = _vec(
            "InputExpressionSet(" + _vec(
                _vec(expr_debug(e) for e in inputs) for inputs in s) + ")"
            for s in arg.input_expressions_sets)
        tables = _vec(expr_debug(e) for e in arg.table_expressions)
        lookups += f"(lookup{i},{sets},{tables}),"
    lookups += "]"

    shuffles = "["
    for i, group in enumerate(cs.shuffles):
        for j, unit in enumerate(group.units):
            ins = _vec(expr_debug(e) for e in unit.input_expressions)
            shs = _vec(expr_debug(e) for e in unit.shuffle_expressions)
            shuffles += f"(shuffle{i}-{j},{ins},{shs}),"
    shuffles += "]"

    perm = ("Argument { columns: "
            + _vec(column_debug(c) for c in cs.permutation.columns) + " }")
    min_deg = ("None" if cs.minimum_degree is None
               else f"Some({cs.minimum_degree})")

    return (
        "PinnedConstraintSystem{"
        f"num_fixed_columns:{cs.num_fixed_columns},"
        f"num_advice_columns:{cs.num_advice_columns},"
        f"num_instance_columns:{cs.num_instance_columns},"
        f"num_selectors:{cs.num_selectors},"
        f"selector_map:{_vec(column_debug(c) for c in cs.selector_map)},"
        f"gates:{gates},"
        f"advice_queries:{_queries_debug(cs.advice_queries)},"
        f"instance_queries:{_queries_debug(cs.instance_queries)},"
        f"fixed_queries:{_queries_debug(cs.fixed_queries)},"
        f"permutation:{perm},"
        f"lookups:{lookups},"
        f"shuffles:{shuffles},"
        f"constants:{_vec(column_debug(c) for c in cs.constants)},"
        f"minimum_degree:{min_deg}"
        "}")


def pinned_vk_str(vk, base_modulus: int, scalar_modulus: int,
                  omega: int) -> str:
    """format!("{:?}", vk.pinned()) — derived Debug of PinnedVerificationKey
    (plonk.rs:111-133).  fixed_commitments / permutation commitments are
    host affine points (int pairs)."""
    domain = (f"PinnedEvaluationDomain {{ k: {vk.domain.k}, "
              f"extended_k: {vk.domain.extended_k}, "
              f"omega: {fr_debug(omega)} }}")
    cs_str = pinned_cs_str(vk.cs)
    fixed = _vec(point_debug(p) for p in vk.fixed_commitments)
    perm = ("VerifyingKey { commitments: "
            + _vec(point_debug(p) for p in vk.permutation.commitments)
            + " }")
    return (
        "PinnedVerificationKey { "
        f"base_modulus: \"{fr_debug(base_modulus)}\", "
        f"scalar_modulus: \"{fr_debug(scalar_modulus)}\", "
        f"domain: {domain}, "
        f"cs: \"{cs_str}\", "
        f"fixed_commitments: {fixed}, "
        f"permutation: {perm}"
        " }")
