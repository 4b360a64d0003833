"""Transformer language model — the attention-era flagship.

Counterpart of paddle_tpu/models/transformer.py: the same fluid program,
built by the port's fluid (same variable names, same desc), unfused or
with the fused-block rewrite (``fuse_transformer``).  ``sp=True`` builds
the sequence-parallel program (an ``sp`` sharding constraint on the
activations and ``sp_axis`` on the attention ops): run on a mesh with an
``sp`` axis (``fluid.ParallelExecutor(mesh_axes={"sp": p})``), its
attention is the ring of ``parallel/ring.py``; elsewhere it runs dense.
``tp`` shards the block weights' ``ParamAttr`` over a ``tp`` axis and
``moe_experts`` swaps every second FFN for a top-1 mixture-of-experts
block (``moe_ffn``, its expert weights over an ``ep`` axis with
``ep``).  Both build the reference's program and run it dense; a mesh
whose tp or ep axis is larger than 1 raises NotImplementedError in the
ops.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.param_attr import ParamAttr

__all__ = ["transformer_lm", "get_model"]


def _attn_block(x, d_model, n_head, tp, sp, prefix):
    ln = fluid.layers.layer_norm(x, begin_norm_axis=2)
    head_dim = d_model // n_head
    wattr = (lambda: ParamAttr(sharding=(None, "tp"))) if tp else \
        (lambda: None)
    qkv = []
    for nm in ("q", "k", "v"):
        h = fluid.layers.fc(ln, size=d_model, num_flatten_dims=2,
                            param_attr=wattr(), bias_attr=False,
                            name="%s_%s" % (prefix, nm))
        h = fluid.layers.reshape(h, [0, 0, n_head, head_dim])
        qkv.append(fluid.layers.transpose(h, [0, 2, 1, 3]))  # [B,H,S,Dh]
    q, k, v = qkv

    helper = fluid.layer_helper.LayerHelper(prefix + "_ring")
    att = helper.create_tmp_variable(x.dtype)
    # LSE output = the flash residual: the backward runs the two flash
    # kernels from it instead of re-executing the forward inside the
    # grad op's vjp (~2.5 ms/layer on the secondary bench)
    lse = helper.create_tmp_variable("float32")
    lse.stop_gradient = True
    helper.append_op(
        type="ring_attention", inputs={"Q": [q], "K": [k], "V": [v]},
        outputs={"Out": [att], "LSE": [lse]},
        attrs={"causal": True, "sp_axis": "sp" if sp else "",
               "batch_axis": "dp", "head_axis": "tp" if tp else ""})
    att = fluid.layers.transpose(att, [0, 2, 1, 3])
    att = fluid.layers.reshape(att, [0, 0, d_model])
    out = fluid.layers.fc(
        att, size=d_model, num_flatten_dims=2,
        param_attr=ParamAttr(sharding=("tp", None)) if tp else None,
        name=prefix + "_o")
    return fluid.layers.elementwise_add(x, out)


def _ffn_block(x, d_model, d_ff, tp, prefix):
    ln = fluid.layers.layer_norm(x, begin_norm_axis=2)
    h = fluid.layers.fc(
        ln, size=d_ff, num_flatten_dims=2, act="relu",
        param_attr=ParamAttr(sharding=(None, "tp")) if tp else None,
        name=prefix + "_fc1")
    h = fluid.layers.fc(
        h, size=d_model, num_flatten_dims=2,
        param_attr=ParamAttr(sharding=("tp", None)) if tp else None,
        name=prefix + "_fc2")
    return fluid.layers.elementwise_add(x, h)


def _moe_block(x, d_model, d_ff, n_experts, ep, prefix):
    ln = fluid.layers.layer_norm(x, begin_norm_axis=2)
    router = fluid.layers.create_parameter(
        [d_model, n_experts], "float32", name=prefix + "_router")
    eattr = (ParamAttr(sharding=("ep", None, None), name=prefix + "_w1")
             if ep else ParamAttr(name=prefix + "_w1"))
    e2attr = (ParamAttr(sharding=("ep", None, None), name=prefix + "_w2")
              if ep else ParamAttr(name=prefix + "_w2"))
    w1 = fluid.layers.create_parameter([n_experts, d_model, d_ff],
                                       "float32", attr=eattr)
    w2 = fluid.layers.create_parameter([n_experts, d_ff, d_model],
                                       "float32", attr=e2attr)
    helper = fluid.layer_helper.LayerHelper(prefix + "_moe")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [ln], "RouterW": [router], "W1": [w1], "W2": [w2]},
        outputs={"Out": [out]},
        attrs={"ep_axis": "ep" if ep else "", "dp_axis": "dp",
               "capacity_factor": 2.0})
    return fluid.layers.elementwise_add(x, out)


def transformer_lm(src, vocab_size, max_len, d_model=256, n_head=8,
                   n_layers=4, d_ff=1024, tp=False, sp=False,
                   moe_experts=0, ep=False):
    """src: [B, S] int64 token ids -> logits [B, S, vocab_size]."""
    emb = fluid.layers.embedding(src, (vocab_size, d_model))
    pos = fluid.layers.create_parameter([max_len, d_model], "float32",
                                        name="pos_emb")
    x = fluid.layers.elementwise_add(emb, pos, axis=1)
    if sp:
        from paddle_tpu_torch.parallel.api import sharding_constraint
        x = sharding_constraint(x, ("dp", "sp", None))
    for i in range(n_layers):
        x = _attn_block(x, d_model, n_head, tp, sp, "blk%d" % i)
        if moe_experts and i % 2 == 1:
            x = _moe_block(x, d_model, d_ff, moe_experts, ep,
                           "blk%d" % i)
        else:
            x = _ffn_block(x, d_model, d_ff, tp, "blk%d" % i)
    x = fluid.layers.layer_norm(x, begin_norm_axis=2)
    logits = fluid.layers.fc(x, size=vocab_size, num_flatten_dims=2,
                             name="lm_head")
    return logits


def get_model(vocab_size=1000, seq_len=64, batch_size=None, d_model=256,
              n_head=8, n_layers=4, d_ff=1024, learning_rate=1e-3,
              tp=False, sp=False, moe_experts=0, ep=False,
              fuse_transformer=None):
    """(avg_cost, [src, label], []) — next-token LM loss, minimized by
    Adam.

    ``fuse_transformer`` None → ``FLAGS.transformer_fuse``; True runs
    FuseTransformerBlockPass on the built graph BEFORE backward
    generation (fused QKV / matmul+bias+act / residual+LN ops backed by
    kernels/matmul_fused.py), so minimize differentiates the fused
    forward through the explicit saved-activation grad lowerings.  The
    unfused program stays the default.
    """
    from paddle_tpu_torch.core.flags import FLAGS

    if fuse_transformer is None:
        fuse_transformer = bool(FLAGS.transformer_fuse)

    src = fluid.layers.data(name="src", shape=[seq_len], dtype="int64")
    label = fluid.layers.data(name="label", shape=[seq_len, 1],
                              dtype="int64")
    logits = transformer_lm(src, vocab_size, seq_len, d_model, n_head,
                            n_layers, d_ff, tp=tp, sp=sp,
                            moe_experts=moe_experts, ep=ep)
    loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    avg_cost = fluid.layers.mean(loss)
    if fuse_transformer:
        from paddle_tpu_torch.fluid.transpiler import \
            TransformerFuseTranspiler
        TransformerFuseTranspiler().transpile(fluid.default_main_program())
    opt = fluid.optimizer.Adam(learning_rate=learning_rate)
    opt.minimize(avg_cost)
    return avg_cost, [src, label], []
