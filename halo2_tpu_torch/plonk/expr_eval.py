"""Shared device-side Expression evaluation over column stacks.

Used by the h-Evaluator (extended domain).  The reference equivalents are
`evaluate`/`evaluate_with_theta` (halo2_proofs/src/plonk/evaluation.rs:
2012-2398) and the ProveExpression GPU walker; here expressions evaluate
eagerly, one field-op launch per node, and rotations are rolls.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.plonk.circuit import (
    AdviceQuery, Constant, FixedQuery, InstanceQuery, Negated, Product,
    Scaled, Sum,
)


class ExprCtx:
    """Column stacks (16, C, length) + rotation scale for one domain.

    `roll` rotates a (16, L) array left by `shift` rows in the domain
    order; `F` is the field context of the column stacks (default: Fr on
    the advice stack's device).  The sharded evaluator hands in sharded
    stacks with a field context and a roll that work on them."""

    def __init__(self, advice, fixed, instance, rot_scale: int, length: int,
                 roll=None, F=None):
        self.advice = advice
        self.fixed = fixed
        self.instance = instance
        self.rot_scale = rot_scale
        self.length = length
        self.roll = roll or (lambda col, shift:
                             torch.roll(col, -shift, dims=-1))
        self.F = F if F is not None else fr(advice.device)


def eval_expr(expr, ctx: ExprCtx):
    F = ctx.F
    if isinstance(expr, Constant):
        return F.broadcast_scalar(F.encode_scalar(expr.value), (ctx.length,))
    if isinstance(expr, (FixedQuery, AdviceQuery, InstanceQuery)):
        stack = {FixedQuery: ctx.fixed, AdviceQuery: ctx.advice,
                 InstanceQuery: ctx.instance}[type(expr)]
        col = stack[:, expr.column_index, :]
        if expr.rotation:
            col = ctx.roll(col, expr.rotation * ctx.rot_scale)
        return col
    if isinstance(expr, Negated):
        return F.neg(eval_expr(expr.expr, ctx))
    if isinstance(expr, Sum):
        return F.add(eval_expr(expr.a, ctx), eval_expr(expr.b, ctx))
    if isinstance(expr, Product):
        return F.mul(eval_expr(expr.a, ctx), eval_expr(expr.b, ctx))
    if isinstance(expr, Scaled):
        return F.mul(eval_expr(expr.expr, ctx), F.encode_scalar(expr.scalar))
    raise TypeError(f"unknown expression node {type(expr)}")


def compress_exprs(exprs, ctx: ExprCtx, theta):
    """theta-fold: acc = acc * theta + eval (first expr highest power)."""
    F = ctx.F
    acc = None
    for e in exprs:
        v = eval_expr(e, ctx)
        acc = v if acc is None else F.add(F.mul(acc, theta), v)
    return acc
