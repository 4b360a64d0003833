"""Transformer block fusion: collapse the block's matmul/epilogue/norm
seams into the fused ops backed by kernels/matmul_fused.py.

Counterpart of ``paddle_tpu/fluid/transpiler/transformer_fuse.py``, rule
for rule, over the port's IR: the same rewrites give the same
ProgramDesc, byte for byte.

- ``mul(X, W_q) / mul(X, W_k) / mul(X, W_v)`` sharing one input
  collapse to ``fused_qkv_matmul`` — one wide matmul (X read once, not
  three times) feeding attention's q/k/v.
- ``mul → elementwise_add(bias) [→ relu|gelu] [→ dropout]
  [→ elementwise_add(residual)]`` collapses to
  ``fused_matmul_bias_act`` — the elementwise tail runs in the matmul
  kernel's epilogue from its f32 accumulator (K4).  The residual add is
  only absorbed when it does NOT feed a layer_norm (see below).
- ``elementwise_add(x, y) → layer_norm`` (the pre-LN residual seam)
  collapses to ``fused_add_ln`` (K5) — sum and LN statistics from one
  pass over the rows; the sum stays an op output because the residual
  stream reads it downstream.  This pattern wins the residual add over
  the matmul epilogue because the statistics then never re-read the
  sum from device memory.

Every fused op carries an EXPLICIT grad lowering over saved
activations (MulOut / Mask / Sum), so the pass must run BEFORE backward
generation: ``minimize`` then differentiates the fused forward.
Flag-gated by ``FLAGS.transformer_fuse``; the unfused program stays the
default.
"""
from __future__ import annotations

import collections

from paddle_tpu_torch.core.desc import OpDesc

from .layout_transpiler import _resync_fluid_program
from .pass_framework import PassManager, ProgramPass

__all__ = ["FuseTransformerBlockPass", "TransformerFuseTranspiler"]

_ACTS = ("relu", "gelu")


def _no_grads_yet(block):
    for op in block.ops:
        if op.type.endswith("_grad"):
            raise ValueError(
                "FuseTransformerBlockPass must run before backward "
                "generation (apply the transformer fuse transpiler "
                "before minimize())")


def _param_like(du, name, bi=0):
    """True when ``name`` is safe to read at any op position: a
    persistable parameter, or at least never produced inside the
    block."""
    if du.persistable(name, bi):
        return True
    blk = du.block(bi)
    for op in blk.ops:
        if name in op.output_arg_names():
            return False
    return True


class FuseTransformerBlockPass(ProgramPass):
    """One pass, three chain rewrites (QKV merge, matmul epilogue,
    add+LN), applied to block 0 until none fires.  ``self.counts``
    holds the per-category rewrite counts."""

    name = "fuse_transformer_block"

    def __init__(self, fuse_qkv=True, fuse_matmul=True, fuse_add_ln=True):
        self.fuse_qkv = fuse_qkv
        self.fuse_matmul = fuse_matmul
        self.fuse_add_ln = fuse_add_ln
        self.counts = collections.Counter()

    def run(self, program, scope, du):
        _no_grads_yet(du.block(0))
        total = 0
        if self.fuse_qkv:
            n = self._fuse_qkv(du)
            self.counts["qkv"] += n
            total += n
            if n:
                du = du.__class__(du.fluid_program)
        if self.fuse_matmul:
            n = self._fuse_matmul_epilogue(du)
            self.counts["matmul_bias_act"] += n
            total += n
            if n:
                du = du.__class__(du.fluid_program)
        if self.fuse_add_ln:
            n = self._fuse_add_ln(du)
            self.counts["add_ln"] += n
            total += n
        return total

    # -- QKV merge --------------------------------------------------------
    def _fuse_qkv(self, du):
        block = du.block(0)
        fused = 0
        while True:
            groups = collections.OrderedDict()
            for idx, op in enumerate(block.ops):
                if op.type != "mul" or \
                        op.attr("y_num_col_dims", 1) != 1:
                    continue
                x = op.input("X")[0]
                w = op.input("Y")[0]
                if du.rank(w) != 2 or not _param_like(du, w):
                    continue
                key = (x, op.attr("x_num_col_dims", 1))
                groups.setdefault(key, []).append((idx, op))
            group = next((g for g in groups.values() if len(g) >= 2),
                         None)
            if group is None:
                return fused
            (first_idx, _), = group[:1]
            ws = [op.input("Y")[0] for _, op in group]
            outs = [op.output("Out")[0] for _, op in group]
            fop = OpDesc(
                "fused_qkv_matmul",
                inputs={"X": [group[0][1].input("X")[0]], "W": ws},
                outputs={"Out": outs},
                attrs={"x_num_col_dims":
                       group[0][1].attr("x_num_col_dims", 1)},
                role=group[0][1].role)
            for idx, _ in sorted(group, key=lambda e: -e[0]):
                block.remove_op(idx, idx + 1)
            block.insert_op(first_idx, fop)
            fused += 1
            du = du.__class__(du.fluid_program)
            block = du.block(0)

    # -- matmul + bias (+act) (+dropout) (+residual) ----------------------
    def _feeds_layer_norm(self, du, name):
        cons = du.consumers(name)
        if cons is None:
            return True     # cross-block reader: be conservative
        return any(op.type == "layer_norm" for _, op in cons)

    def _fuse_matmul_epilogue(self, du):
        block = du.block(0)
        fused = 0
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type != "mul" or op.attr("y_num_col_dims", 1) != 1:
                i += 1
                continue
            w = op.input("Y")[0]
            if du.rank(w) != 2 or not _param_like(du, w):
                i += 1
                continue
            mul_out = op.output("Out")[0]
            cons = du.sole_consumer(mul_out, start=i + 1,
                                    op_type="elementwise_add")
            if cons is None:
                i += 1
                continue
            bi_, badd = cons
            bias = None
            if badd.input("X")[0] == mul_out:
                y = badd.input("Y")[0]
                if du.rank(y) == 1 and _param_like(du, y) and \
                        badd.attr("axis", -1) in (-1, du.rank(mul_out) - 1):
                    bias = y
            if bias is None:
                i += 1
                continue

            act = ""
            drop = None
            residual = None
            pre_name = badd.output("Out")[0]   # x@w + b: the MulOut var
            final = pre_name
            kill = [i, bi_]
            dead = []
            last = bi_

            nxt = du.sole_consumer(final, start=last + 1)
            if nxt is not None and nxt[1].type in _ACTS:
                act = nxt[1].type
                dead.append(final)
                final = nxt[1].output("Out")[0]
                kill.append(nxt[0])
                last = nxt[0]
                nxt = du.sole_consumer(final, start=last + 1)
            if nxt is not None and nxt[1].type == "dropout":
                drop = nxt[1]
                dead.append(final)
                final = drop.output("Out")[0]
                kill.append(nxt[0])
                last = nxt[0]
                nxt = du.sole_consumer(final, start=last + 1)
            if nxt is not None and nxt[1].type == "elementwise_add" and \
                    nxt[1].attr("axis", -1) in (-1, 0):
                ai, add = nxt
                xn, yn = add.input("X")[0], add.input("Y")[0]
                other = xn if yn == final else (
                    yn if xn == final else None)
                add_out = add.output("Out")[0]
                if other is not None and \
                        du.rank(other) == du.rank(final) and \
                        du.shape(other) == du.shape(final) and \
                        not self._feeds_layer_norm(du, add_out):
                    # residual absorbed only when the sum does NOT feed
                    # a layer_norm — that seam belongs to fused_add_ln,
                    # whose statistics then come from the sum it forms
                    residual = other
                    dead.append(final)
                    final = add_out
                    kill.append(ai)
                    last = ai

            # a bare matmul+bias (no act/dropout/residual absorbed) is
            # still fused: one epilogue instead of a separate bias kernel
            inputs = {"X": op.input("X"), "W": [w], "Bias": [bias]}
            if residual is not None:
                inputs["Residual"] = [residual]
            outputs = {"Out": [final]}
            # MulOut (the saved pre-activation) is declared only when
            # the backward needs it: gelu's derivative, or an act whose
            # output is further transformed (dropout/residual) so the
            # Out sign trick no longer applies
            if act == "gelu" or (act and (drop is not None or
                                          residual is not None)):
                if final != pre_name:
                    outputs["MulOut"] = [pre_name]
                    dead = [d for d in dead if d != pre_name]
            attrs = {"x_num_col_dims": op.attr("x_num_col_dims", 1),
                     "act": act, "dropout_prob": 0.0}
            if drop is not None:
                outputs["Mask"] = drop.output("Mask")
                attrs["dropout_prob"] = drop.attr("dropout_prob", 0.5)
                attrs["dropout_implementation"] = drop.attr(
                    "dropout_implementation", "downgrade_in_infer")
                attrs["seed"] = drop.attr("seed", 0)
                attrs["is_test"] = bool(drop.attr("is_test", False))
            fop = OpDesc("fused_matmul_bias_act", inputs=inputs,
                         outputs=outputs, attrs=attrs, role=op.role)
            removed = sorted(kill)
            insert_at = removed[-1] - (len(removed) - 1)
            for idx in reversed(removed):
                block.remove_op(idx, idx + 1)
            block.insert_op(insert_at, fop)
            du.drop_dead_vars(dead, keep=(final,))
            fused += 1
            du = du.__class__(du.fluid_program)
            block = du.block(0)
        return fused

    # -- residual add + layer_norm ----------------------------------------
    def _fuse_add_ln(self, du):
        block = du.block(0)
        fused = 0
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type != "elementwise_add" or \
                    op.attr("axis", -1) not in (-1, 0):
                i += 1
                continue
            xn, yn = op.input("X")[0], op.input("Y")[0]
            if du.rank(xn) < 2 or du.rank(xn) != du.rank(yn) or \
                    du.shape(xn) != du.shape(yn):
                i += 1
                continue
            add_out = op.output("Out")[0]
            cons = du.consumers(add_out, start=i + 1)
            if cons is None:
                i += 1
                continue
            ln_entry = next(((ci, c) for ci, c in cons
                             if c.type == "layer_norm" and
                             c.input("X")[0] == add_out), None)
            if ln_entry is None:
                i += 1
                continue
            li, ln = ln_entry
            scale = ln.input("Scale") if ln.inputs.get("Scale") else []
            lbias = ln.input("Bias") if ln.inputs.get("Bias") else []
            if any(not _param_like(du, n) for n in scale + lbias):
                i += 1
                continue
            inputs = {"X": [xn], "Y": [yn]}
            if scale:
                inputs["Scale"] = scale
            if lbias:
                inputs["Bias"] = lbias
            fop = OpDesc(
                "fused_add_ln", inputs=inputs,
                outputs={"Out": ln.output("Y"), "Sum": [add_out],
                         "Mean": ln.output("Mean"),
                         "Variance": ln.output("Variance")},
                attrs={"begin_norm_axis": ln.attr("begin_norm_axis", 1),
                       "epsilon": ln.attr("epsilon", 1e-5)},
                role=op.role)
            # the fused op sits at the ADD's slot: Sum keeps its
            # original production point (readers between the add and
            # the ln stay ordered); the ln's operands are parameters,
            # available anywhere
            block.remove_op(li, li + 1)
            block.remove_op(i, i + 1)
            block.insert_op(i, fop)
            fused += 1
            du = du.__class__(du.fluid_program)
            block = du.block(0)
        return fused


class TransformerFuseTranspiler:
    """Apply the block-fusion pass to a (pre-backward) training or
    inference program.  ``transpile`` returns the per-category rewrite
    counts, e.g. {'qkv': 4, 'matmul_bias_act': 13, 'add_ln': 8}."""

    def transpile(self, program, scope=None, fuse_qkv=True,
                  fuse_matmul=True, fuse_add_ln=True):
        p = FuseTransformerBlockPass(fuse_qkv=fuse_qkv,
                                     fuse_matmul=fuse_matmul,
                                     fuse_add_ln=fuse_add_ln)
        PassManager([p]).run(program, scope=scope)
        _resync_fluid_program(program)
        return dict(p.counts)
