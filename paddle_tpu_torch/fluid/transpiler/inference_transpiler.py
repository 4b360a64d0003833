"""Inference transpiler: program-rewriting analysis passes for LOADED
inference programs, expressed on the shared pass framework
(``pass_framework.py`` — the reference's DataFlowGraph/subgraph-splitter
role, `inference/analysis/data_flow_graph.cc`).

Counterpart of ``paddle_tpu/fluid/transpiler/inference_transpiler.py``,
rule for rule, over the port's IR: the same rewrites give the same
ProgramDesc, byte for byte.

1. ``BatchNormFoldPass`` (reference
   python/paddle/fluid/transpiler/inference_transpiler.py): a conv2d
   (+ optional elementwise_add bias) followed by a test-mode batch_norm
   is an affine function of the conv output — fold into the conv's
   filter and bias:

       scale_f = scale / sqrt(var + eps)
       W' = W * scale_f (per output channel)
       b' = (b - mean) * scale_f + bias

   The fold reads the scope's values to the host, computes in numpy as
   the JAX package does, and writes each result back as a tensor on the
   device the old value lived on.

2. ``AttentionFusePass``: pattern-match a plain
   matmul(transpose_y) -> [scale] -> softmax -> matmul chain and
   rewrite it to ONE ``ring_attention`` op with ``causal=False``, so
   models saved from the plain front-end get the flash kernel (K1's
   non-causal form on a card, ``kernels/flash_attention.py``) when
   served, and the sequence-parallel ring under a mesh.  The card's K1
   takes head_dim 128 and raises for others.

3. ``LayerNormFusePass``: the canonical composed layer-norm chain
   (reduce_mean -> sub -> square -> reduce_mean -> +eps -> sqrt ->
   div) collapses to ONE ``layer_norm`` op.
"""
from __future__ import annotations

import numpy as np
import torch

from .pass_framework import PassManager, ProgramPass

__all__ = ["InferenceTranspiler", "BatchNormFoldPass",
           "AttentionFusePass", "LayerNormFusePass"]


def _value(scope, name):
    """A scope value as a host numpy array."""
    val = scope.find_var(name)
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _store(scope, name, arr):
    """Write numpy ``arr`` to ``name`` as a tensor on the device its old
    value lived on (the host for a numpy value or a new name)."""
    old = scope.find_var(name) if scope.has_var(name) else None
    dev = old.device if isinstance(old, torch.Tensor) else "cpu"
    scope.set(name, torch.from_numpy(np.ascontiguousarray(arr)).to(dev))


class BatchNormFoldPass(ProgramPass):
    name = "bn_fold"

    def run(self, program, scope, du):
        from paddle_tpu_torch.core.desc import OpDesc

        block = du.block(0)
        ops = block.ops
        i = 0
        folded = 0
        while i < len(ops):
            op = ops[i]
            if op.type != "conv2d":
                i += 1
                continue
            j = i + 1
            bias_op = None
            if j < len(ops) and ops[j].type == "elementwise_add":
                bias_op = ops[j]
                j += 1
            if j >= len(ops) or ops[j].type != "batch_norm":
                i += 1
                continue
            bn = ops[j]
            if not bn.attrs.get("is_test") or not \
                    bn.attrs["is_test"].value:
                i += 1
                continue
            conv_out = op.outputs["Output"][0]
            bn_in = bn.inputs["X"][0]
            chain_out = (bias_op.outputs["Out"][0] if bias_op
                         else conv_out)
            if bn_in != chain_out:
                i += 1
                continue
            if bias_op is not None:
                # only a true bias add folds: X must be the conv output
                # and Y a per-channel parameter living in the scope —
                # a residual add (Y = another activation) must be left
                # alone, and nothing may be mutated before this check
                b_name = bias_op.inputs["Y"][0]
                if bias_op.inputs["X"][0] != conv_out or \
                        not scope.has_var(b_name):
                    i += 1
                    continue
                b_val = _value(scope, b_name)
                n_ch = block.vars[op.inputs["Filter"][0]].shape[0]
                if b_val.size != n_ch:
                    i += 1
                    continue

            w_name = op.inputs["Filter"][0]
            scale = _value(scope, bn.inputs["Scale"][0])
            bias = _value(scope, bn.inputs["Bias"][0])
            mean = _value(scope, bn.inputs["Mean"][0])
            var = _value(scope, bn.inputs["Variance"][0])
            eps = (bn.attrs["epsilon"].value if "epsilon" in bn.attrs
                   else 1e-5)
            factor = scale / np.sqrt(var + eps)

            w = _value(scope, w_name)
            _store(scope, w_name, (w * factor.reshape(-1, 1, 1, 1)).astype(
                w.dtype))
            if bias_op is not None:
                b_name = bias_op.inputs["Y"][0]
                b = _value(scope, b_name)
                _store(scope, b_name, ((b - mean) * factor + bias).astype(
                    b.dtype))
                # bn output now equals the bias-add output
                bias_op.outputs["Out"][0:1] = [bn.outputs["Y"][0]]
                del ops[j]
            else:
                # no conv bias: inject the folded bias via the bn's
                # Bias parameter and turn bn into an elementwise_add
                b_name = bn.inputs["Bias"][0]
                folded_b = ((-mean) * factor + bias).astype(
                    np.float32).reshape(1, -1, 1, 1)
                _store(scope, b_name, folded_b)
                # bias value reshaped to [1,C,1,1] -> plain broadcast
                # add; the VarDesc must follow the value or the desc
                # lies to every desc-driven consumer (the program
                # verifier's shape checker, feed coercion)
                bvd = block.vars.get(b_name)
                if bvd is not None:
                    bvd.shape = tuple(folded_b.shape)
                ops[j] = OpDesc(
                    "elementwise_add",
                    inputs={"X": [conv_out], "Y": [b_name]},
                    outputs={"Out": [bn.outputs["Y"][0]]})
                ops[j]._block = block  # spliced in: keep version bumps
            folded += 1
            du.rebuild()
            i = j
        return folded


class AttentionFusePass(ProgramPass):
    """matmul(QK^T) -> [scale] -> softmax -> matmul(.V)  =>  one
    ring_attention op (flash kernel / ring under a mesh).

    Match conditions (semantics-preserving only):
    - first matmul: transpose_Y, 4-D [B,H,T,D] operands;
    - optional scale op (bias 0) or matmul alpha != 1 between the
      matmuls: folded into the ring_attention ``scale`` attr;
    - softmax directly on the (scaled) scores — an arbitrary mask
      add is NOT fused (the flash kernel only knows causal);
    - every intermediate is consumed exactly once (else the scores
      are observed elsewhere and must stay materialized), is not
      persistable, and is not read by any sub-block.
    """

    name = "attention_fuse"

    def run(self, program, scope, du):
        from paddle_tpu_torch.core.desc import OpDesc

        block = du.block(0)
        ops = block.ops
        i = 0
        fused = 0
        while i < len(ops):
            m1 = ops[i]
            if m1.type != "matmul" or \
                    not m1.attr("transpose_Y", False) or \
                    m1.attr("transpose_X", False):
                i += 1
                continue
            q_name, k_name = m1.input("X")[0], m1.input("Y")[0]
            if du.rank(q_name) != 4 or du.rank(k_name) != 4:
                i += 1
                continue
            scale = float(m1.attr("alpha", 1.0))
            cur = m1.output("Out")[0]
            chain = [i]
            chain_outs = {cur}
            nxt = du.sole_consumer(cur, start=i + 1)
            if nxt is not None and nxt[1].type == "scale":
                j, s_op = nxt
                if float(s_op.attr("bias", 0.0)) != 0.0:
                    i += 1
                    continue
                scale *= float(s_op.attr("scale", 1.0))
                cur = s_op.output("Out")[0]
                chain.append(j)
                chain_outs.add(cur)
                nxt = du.sole_consumer(cur, start=j + 1)
            if nxt is None or nxt[1].type != "softmax":
                i += 1
                continue
            j, sm = nxt
            cur = sm.output("Out")[0]
            chain.append(j)
            chain_outs.add(cur)
            nxt = du.sole_consumer(cur, start=j + 1, op_type="matmul")
            if nxt is None:
                i += 1
                continue
            j, m2 = nxt
            if m2.input("X")[0] != cur or \
                    m2.attr("transpose_X", False) or \
                    m2.attr("transpose_Y", False) or \
                    float(m2.attr("alpha", 1.0)) != 1.0:
                i += 1
                continue
            v_name = m2.input("Y")[0]
            # V must come from OUTSIDE the chain: matmul(attn, attn)
            # would fuse away its own V producer
            if du.rank(v_name) != 4 or v_name in chain_outs:
                i += 1
                continue
            chain.append(j)
            # a persistable intermediate (or one a caller may fetch by
            # name) must survive: fusing would pass program validation
            # but never compute it — skip the chain instead
            if any(du.persistable(n) for n in chain_outs):
                i += 1
                continue
            ring = OpDesc(
                "ring_attention",
                inputs={"Q": [q_name], "K": [k_name], "V": [v_name]},
                outputs={"Out": [m2.output("Out")[0]]},
                attrs={"causal": False, "scale": float(scale)})
            # replace the first op of the chain, delete the rest
            ring._block = block  # spliced in: keep version bumps
            ops[chain[0]] = ring
            for j in sorted(chain[1:], reverse=True):
                del ops[j]
            du.drop_dead_vars(chain_outs, keep=[m2.output("Out")[0]])
            fused += 1
            du.rebuild()   # op indices shifted
            i = chain[0] + 1
        return fused


class LayerNormFusePass(ProgramPass):
    """Composed layer norm -> one ``layer_norm`` op.

    Canonical chain over the LAST axis, as written with fluid
    primitives (each intermediate single-consumer, non-persistable):

        m   = reduce_mean(x, dim=[-1], keep_dim=True)
        d   = elementwise_sub(x, m)
        sq  = square(d) | elementwise_mul(d, d)
        v   = reduce_mean(sq, dim=[-1], keep_dim=True)
        ve  = scale(v, scale=1.0, bias=eps)
        std = sqrt(ve)
        y   = elementwise_div(d, std)

    Rewrites to layer_norm(begin_norm_axis=ndim-1, epsilon=eps); the
    op's Mean/Variance aux outputs get fresh var descs.
    """

    name = "layer_norm_fuse"

    def _last_axis_mean(self, op, du, x_name):
        dims = op.attr("dim", None) or []
        nd = du.rank(x_name)
        return (op.attr("keep_dim", False) and len(dims) == 1
                and int(dims[0]) in (nd - 1, -1))

    def run(self, program, scope, du):
        from paddle_tpu_torch.core.desc import OpDesc
        from paddle_tpu_torch.core.types import np_dtype_to_proto

        block = du.block(0)
        ops = block.ops
        i = 0
        fused = 0
        while i < len(ops):
            mean_op = ops[i]
            if mean_op.type != "reduce_mean":
                i += 1
                continue
            x_name = mean_op.input("X")[0]
            if not self._last_axis_mean(mean_op, du, x_name):
                i += 1
                continue
            m_out = mean_op.output("Out")[0]
            sub_loc = du.sole_consumer(m_out, start=i + 1,
                                       op_type="elementwise_sub")
            if sub_loc is None or sub_loc[1].input("X")[0] != x_name:
                i += 1
                continue
            j_sub, sub = sub_loc
            d_out = sub.output("Out")[0]
            # d feeds the square AND the final div: exactly two reads
            d_cons = du.consumers(d_out, start=j_sub + 1)
            if d_cons is None or len(d_cons) != 2:
                i += 1
                continue
            sq_loc = next(((j, o) for j, o in d_cons
                           if o.type == "square"
                           or (o.type == "elementwise_mul"
                               and o.input("X")[0] == d_out
                               and o.input("Y")[0] == d_out)), None)
            div_loc = next(((j, o) for j, o in d_cons
                            if o.type == "elementwise_div"
                            and o.input("X")[0] == d_out), None)
            if sq_loc is None or div_loc is None:
                i += 1
                continue
            j_sq, sq = sq_loc
            j_div, div = div_loc
            var_loc = du.sole_consumer(sq.output("Out")[0],
                                       start=j_sq + 1,
                                       op_type="reduce_mean")
            if var_loc is None or not self._last_axis_mean(
                    var_loc[1], du, sq.output("Out")[0]):
                i += 1
                continue
            j_var, var_op = var_loc
            eps_loc = du.sole_consumer(var_op.output("Out")[0],
                                       start=j_var + 1, op_type="scale")
            if eps_loc is None or \
                    float(eps_loc[1].attr("scale", 1.0)) != 1.0:
                i += 1
                continue
            j_eps, eps_op = eps_loc
            eps = float(eps_op.attr("bias", 0.0))
            sqrt_loc = du.sole_consumer(eps_op.output("Out")[0],
                                        start=j_eps + 1, op_type="sqrt")
            if sqrt_loc is None:
                i += 1
                continue
            j_sqrt, sqrt_op = sqrt_loc
            if div.input("Y")[0] != sqrt_op.output("Out")[0]:
                i += 1
                continue
            chain = [i, j_sub, j_sq, j_var, j_eps, j_sqrt, j_div]
            y_name = div.output("Out")[0]
            inter = {ops[j].output("Out")[0] for j in chain[:-1]}
            if any(du.persistable(n) for n in inter):
                i += 1
                continue
            nd = du.rank(x_name)
            xshape = du.shape(x_name)
            dtype = block.vars[x_name].dtype if x_name in block.vars \
                else np_dtype_to_proto("float32")
            # the layer_norm lowering emits Mean/Variance reshaped to
            # x.shape[:begin_norm_axis] (ops/nn.py _layer_norm — no
            # trailing 1); the declared var desc must agree or the
            # fused program's shapes lie to downstream passes
            aux_shape = tuple(xshape[:-1])
            mean_v = y_name + "@ln_mean"
            var_v = y_name + "@ln_var"
            for nm in (mean_v, var_v):
                if nm not in block.vars:
                    vd0 = block.vars[y_name]
                    block.vars[nm] = type(vd0)(
                        nm, vd0.kind, dtype, aux_shape)
                    block.vars[nm].stop_gradient = True
            ln = OpDesc(
                "layer_norm", inputs={"X": [x_name]},
                outputs={"Y": [y_name], "Mean": [mean_v],
                         "Variance": [var_v]},
                attrs={"begin_norm_axis": nd - 1, "epsilon": eps})
            ln._block = block  # spliced in: keep version bumps
            ops[chain[0]] = ln
            for j in sorted(chain[1:], reverse=True):
                del ops[j]
            du.drop_dead_vars(inter, keep=[y_name])
            fused += 1
            du.rebuild()
            i = chain[0] + 1
        return fused


class InferenceTranspiler:
    """Public API: runs the pass list through the PassManager."""

    def transpile(self, program, place=None, scope=None):
        """Run every analysis pass in-place to fixpoint."""
        PassManager([BatchNormFoldPass(), AttentionFusePass(),
                     LayerNormFusePass()]).run(program, scope)
        return program

    def fuse_batch_norm(self, program, place=None, scope=None):
        PassManager([BatchNormFoldPass()]).run(program, scope)
        return program

    def fuse_attention(self, program, scope=None):
        counts = PassManager([AttentionFusePass()]).run(program, scope)
        return counts.get("attention_fuse", 0)

    def fuse_layer_norm(self, program, scope=None):
        counts = PassManager([LayerNormFusePass()]).run(program, scope)
        return counts.get("layer_norm_fuse", 0)
