"""The fused-block transformer program (``FLAGS.transformer_fuse``) in
the port against the JAX package's, on the CPU at a small size (vocab
101, sequence 16, d_model 32, 4 heads, 2 layers, d_ff 64, batch 2).

- FuseTransformerBlockPass rewrites to the same ProgramDesc, byte for
  byte, with the same rewrite counts, for the LM and for every chain
  rule (bias, act, dropout, residual, the add + LN seam);
- each fused op and its explicit grad replays its ``SPECS`` entry of
  ``tools/tpu_optest.py`` at the spec's tolerance;
- three Adam steps of the fused LM track the reference's fused program
  from the reference's startup parameters: loss rtol 1e-4, step-1
  gradients within 1e-4 * max |ref|, parameters after 3 steps atol 1e-4
  (3 % of what three Adam steps at lr 1e-3 can move a weight);
- the port's fused and unfused programs agree at the reference's own bar
  (``tests/test_transformer_fuse.py``): losses 2e-4, parameters
  rtol 1e-4 / atol 4e-7.
"""
import collections
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core import types as ttypes
from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.core.scope import Scope as PortScope
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import transformer as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "tpu_optest", os.path.join(REPO, "tools", "tpu_optest.py"))
optest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(optest)

SMALL = dict(vocab_size=101, seq_len=16, d_model=32, n_head=4, n_layers=2,
             d_ff=64)
LAYERS = SMALL["n_layers"]
STEPS = 3
FUSED_OPS = ["fused_matmul_bias_act", "fused_qkv_matmul", "fused_add_ln"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def build(fluid, module, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(**{**SMALL, **kw})
    return main, startup, loss


def feeds(seed, batch=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.randint(0, SMALL["vocab_size"],
                           (batch, SMALL["seq_len"] + 1)).astype(np.int64)
        out.append({"src": toks[:, :-1], "label": toks[:, 1:, None]})
    return out


def run_in_port(main, feed, fetch_names):
    """Run a ``paddle_tpu.fluid`` program's desc in the port on the CPU."""
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    outs = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch_names, scope=PortScope())
    return dict(zip(fetch_names, outs))


# ---------------------------------------------------------------- the pass

def _lm_forward(fluid, module):
    """The LM's forward graph and loss, not yet minimized."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        s = SMALL["seq_len"]
        src = fluid.layers.data(name="src", shape=[s], dtype="int64")
        label = fluid.layers.data(name="label", shape=[s, 1],
                                  dtype="int64")
        logits = module.transformer_lm(
            src, SMALL["vocab_size"], s, SMALL["d_model"], SMALL["n_head"],
            LAYERS, SMALL["d_ff"])
        fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
    return main


def test_pass_counts_and_fused_desc_are_the_references():
    counts = [fluid.transpiler.TransformerFuseTranspiler().transpile(
        _lm_forward(fluid, module))
        for fluid, module in ((jfluid, jtransformer),
                              (tfluid, ttransformer))]
    assert counts[0] == counts[1] == {
        "qkv": LAYERS, "matmul_bias_act": 3 * LAYERS + 1,
        "add_ln": 2 * LAYERS}
    jmain, jstart, _ = build(jfluid, jtransformer, fuse_transformer=True)
    tmain, tstart, _ = build(tfluid, ttransformer, fuse_transformer=True)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    ops = collections.Counter(o.type for o in tmain.desc.blocks[0].ops)
    assert ops["mul"] == 0 and ops["layer_norm"] == 1
    for op in FUSED_OPS:
        assert ops[op] == ops[op + "_grad"] > 0


def _chain(fluid, act, residual, dropout, ln):
    """mul -> bias add (-> act) (-> dropout) (-> residual add) (-> LN)
    on a [B, T, D] stream, from fluid layers (the idioms the pass
    matches), plus the QKV triple."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[8, 16], dtype="float32")
        h = fluid.layers.fc(x, size=16, num_flatten_dims=2,
                            act=act or None, name="up")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=0.3, seed=11)
        out = fluid.layers.elementwise_add(x, h) if residual else h
        if ln:
            out = fluid.layers.layer_norm(out, begin_norm_axis=2)
        qkv = [fluid.layers.fc(out, size=16, num_flatten_dims=2,
                               bias_attr=False, name="p_" + nm)
               for nm in "qkv"]
        fluid.layers.reduce_sum(fluid.layers.elementwise_add(
            fluid.layers.elementwise_add(qkv[0], qkv[1]), qkv[2]))
    return main


@pytest.mark.parametrize("act,residual,dropout,ln", [
    ("", False, False, False), ("relu", False, False, False),
    ("gelu", False, False, False), ("relu", True, False, False),
    ("gelu", True, False, False), ("", True, True, False),
    ("relu", True, True, False), ("relu", True, False, True)])
def test_every_chain_rule_rewrites_as_the_references(act, residual,
                                                     dropout, ln):
    """The reference's unfused desc, parsed by the port and rewritten by
    the port's pass, serializes to the reference's rewritten desc: the
    residual goes to fused_add_ln when the sum feeds a layer_norm, and
    MulOut is declared only for gelu or an act followed by dropout or a
    residual."""
    jmain = _chain(jfluid, act, residual, dropout, ln)
    tmain = tfluid.Program.parse_from_string(
        jmain.desc.serialize_to_string())
    want = jfluid.transpiler.TransformerFuseTranspiler().transpile(jmain)
    got = tfluid.transpiler.TransformerFuseTranspiler().transpile(tmain)
    assert got == want and want["qkv"] == 1
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in tmain.desc.blocks[0].ops]
    mba = [op for op in tmain.desc.blocks[0].ops
           if op.type == "fused_matmul_bias_act"]
    absorbed = residual and not ln
    assert bool(mba[0].inputs.get("Residual")) == absorbed
    assert bool(mba[0].outputs.get("MulOut")) == (
        act == "gelu" or bool(act and (dropout or absorbed)))
    assert any(op.type == "fused_add_ln"
               for op in tmain.desc.blocks[0].ops) == (residual and ln)


# ------------------------------------------------------------ op replays

def _spec_outputs(t, ref):
    outs = {}
    for slot, val in t.outputs.items():
        entries = val if isinstance(val, list) else [(slot, val)]
        outs[slot] = [(n, ref[n]) for n, _ in entries] \
            if isinstance(val, list) else ref[entries[0][0]]
    return outs


@pytest.mark.parametrize("op", FUSED_OPS)
def test_fused_op_and_its_grad_replay_their_spec(op):
    s = optest.SPECS[op]
    t = optest._make_optest(op, s)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    for n in names:
        err = optest._compare(n, ref[n], got[n], *s["tol"])
        assert err is None, err
    # the grad program (weighted scalar head + calc_gradient) runs the
    # explicit *_grad lowerings; MulOut / Mean / Variance / Sum heads
    # fold their cotangents in
    t2 = optest._make_optest(op, s)
    t2.outputs = _spec_outputs(t, ref)
    gmain, _, gfeed, gnames = optest._grad_program(t2, s["grad"])
    assert any(o.type == op + "_grad" for o in gmain.desc.blocks[0].ops)
    g_ref = optest._run_on(jfluid.CPUPlace(), gmain, gfeed, gnames)
    g_got = run_in_port(gmain, gfeed, gnames)
    for n, a in zip(gnames, g_ref):
        err = optest._compare(n, a, g_got[n], *s["tol"])
        assert err is None, err


def test_qkv_grad_counts_a_missing_out_grad_as_zeros():
    """Only q and v feed the loss: k's Out@GRAD is a hole in the grad
    op, and W_k's gradient comes out zero in both packages."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        x = jfluid.layers.data(name="x", shape=[4, 8], dtype="float32")
        x.stop_gradient = False
        q, _, v = [jfluid.layers.fc(x, size=8, num_flatten_dims=2,
                                    bias_attr=False, name="p_" + nm)
                   for nm in "qkv"]
        loss = jfluid.layers.reduce_sum(jfluid.layers.elementwise_add(q, v))
        jfluid.transpiler.TransformerFuseTranspiler().transpile(main)
        jfluid.backward.append_backward(loss)
    grad_op, = [o for o in main.desc.blocks[0].ops
                if o.type == "fused_qkv_matmul_grad"]
    assert grad_op.inputs["Out@GRAD"][1] == ""
    names = ["x@GRAD", "p_q.w_0@GRAD", "p_k.w_0@GRAD", "p_v.w_0@GRAD"]
    rng = np.random.RandomState(6)
    params = {n: (rng.randn(8, 8) * 0.3).astype(np.float32)
              for n in ("p_q.w_0", "p_k.w_0", "p_v.w_0")}
    feed = {"x": rng.randn(3, 4, 8).astype(np.float32)}
    jscope = JScope()
    for n, v in params.items():
        jscope.set(n, v)
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            main, feed=feed, fetch_list=names)
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    tscope = tfluid.Scope()
    set_scope_arrays(tscope, params, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=names, scope=tscope)
    for n, a, b in zip(names, want, got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=n)
    assert not got[2].any()


def test_dropout_branch_raises(monkeypatch):
    """The dropout branch (it raised before the port had dropout): K4's
    matmul + bias + gelu, then the mask and the residual in torch.  At
    dropout_prob 0.3 with seed 11, the port's draw replaced by the
    reference's (``jax.random.bernoulli(PRNGKey(11))``, through
    ``ops/random.keep_mask``), Out, MulOut and Mask and the grad program
    replay the spec at its tolerance; in test mode (the output scaled
    by 1 - p) no draw is needed."""
    import jax

    from paddle_tpu_torch.ops import random as prandom

    def reference_keep(ctx, shape, keep_prob, seed=0):
        assert seed == 11
        keep = jax.random.bernoulli(jax.random.PRNGKey(seed), keep_prob,
                                    tuple(shape))
        return torch.from_numpy(np.array(keep))

    monkeypatch.setattr(prandom, "keep_mask", reference_keep)
    s = optest.SPECS["fused_matmul_bias_act"]
    for attrs, outs in (
            (dict(s["attrs"], dropout_prob=0.3, seed=11),
             ["Out", "MulOut", "Mask"]),
            (dict(s["attrs"], dropout_prob=0.3, is_test=True),
             ["Out", "MulOut"])):
        spec = dict(s, attrs=attrs, outs=outs)
        t = optest._make_optest("fused_matmul_bias_act", spec)
        names = optest._fetch_names(t)
        ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
        main, _, feed = t._build()
        got = run_in_port(main, feed, names)
        for n in names:
            err = optest._compare(n, ref[n], got[n], *s["tol"])
            assert err is None, err
        t2 = optest._make_optest("fused_matmul_bias_act", spec)
        t2.outputs = _spec_outputs(t, ref)
        gmain, _, gfeed, gnames = optest._grad_program(t2, s["grad"])
        g_ref = optest._run_on(jfluid.CPUPlace(), gmain, gfeed, gnames)
        g_got = run_in_port(gmain, gfeed, gnames)
        for n, a in zip(gnames, g_ref):
            err = optest._compare(n, a, g_got[n], *s["tol"])
            assert err is None, err


@pytest.mark.parametrize("op", FUSED_OPS)
def test_fused_meta_shape_inference_matches_jax(op):
    """Build-time shape inference of the fused ops runs their
    ``infer_shape`` (never a kernel wrapper) and infers what the JAX
    package's abstract evaluation does, -1 batch dims included."""
    from paddle_tpu.core import lowering as jlow
    from paddle_tpu.core import types as jtypes

    t = optest._make_optest(op, optest.SPECS[op])
    main, _, _ = t._build()
    block = main.desc.blocks[0]
    op0 = block.ops[0]
    for slot in ("X", "Y", "Residual"):
        for name in op0.inputs.get(slot, []):
            vd = block.vars[name]
            vd.shape = (-1,) + tuple(vd.shape[1:])
    want = jlow.infer_op_outputs(main.desc, block, op0)
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    tblock = prog.desc.blocks[0]
    got = tlow.infer_op_outputs(prog.desc, tblock, tblock.ops[0])
    assert sorted(got) == sorted(want)
    for n, (shape, dtype) in want.items():
        assert got[n][0] == tuple(shape), n
        assert ttypes.np_dtype_to_proto(got[n][1]) == \
            jtypes.np_dtype_to_proto(dtype)


# ------------------------------------------------------------- training

@pytest.fixture(scope="module")
def fused_runs():
    """The reference's fused program and the port's, from the
    reference's startup parameters, 3 Adam steps each; and the port's
    unfused program from the same parameters."""
    jmain, jstart, jloss = build(jfluid, jtransformer, fuse_transformer=True)
    tmain, _, tloss = build(tfluid, ttransformer, fuse_transformer=True)
    umain, _, uloss = build(tfluid, ttransformer, fuse_transformer=False)
    params = sorted(p.name for p in jmain.all_parameters())
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    fetch = [p + "@GRAD" for p in params]
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    runs = {"jax": [], "port": [], "unfused": []}
    scopes = {}
    for kind, main, loss in (("port", tmain, tloss),
                             ("unfused", umain, uloss)):
        scopes[kind] = tfluid.Scope()
        set_scope_arrays(scopes[kind], init, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    for feed in feeds(0):
        with jfluid.scope_guard(jscope):
            runs["jax"].append(jexe.run(jmain, feed=feed,
                                        fetch_list=[jloss] + fetch))
        for kind, main, loss in (("port", tmain, tloss),
                                 ("unfused", umain, uloss)):
            runs[kind].append(texe.run(main, feed=feed,
                                       fetch_list=[loss] + fetch,
                                       scope=scopes[kind]))
    final = {"jax": {n: np.asarray(jscope.find_var(n)) for n in persist}}
    for kind in ("port", "unfused"):
        final[kind] = get_scope_arrays(scopes[kind], persist)
    return params, runs, final


def test_fused_losses_track_the_reference(fused_runs):
    _, runs, _ = fused_runs
    for step, (j, p) in enumerate(zip(runs["jax"], runs["port"])):
        np.testing.assert_allclose(p[0], j[0], rtol=1e-4,
                                   err_msg="loss at step %d" % step)


def test_fused_gradients_track_the_reference_at_step_one(fused_runs):
    params, runs, _ = fused_runs
    assert len(params) == 2 + 2 * 13 + 4    # emb, pos; per layer; ln, head
    for name, j, p in zip(params, runs["jax"][0][1:], runs["port"][0][1:]):
        assert p.shape == j.shape, name
        err = np.abs(p - j).max()
        assert err <= 1e-4 * np.abs(j).max(), (name, err)


def test_fused_parameters_track_the_reference_after_three_steps(fused_runs):
    params, _, final = fused_runs
    for name in params:
        np.testing.assert_allclose(final["port"][name], final["jax"][name],
                                   atol=1e-4, rtol=0, err_msg=name)


def test_fused_and_unfused_programs_agree(fused_runs):
    _, runs, final = fused_runs
    np.testing.assert_allclose([r[0] for r in runs["port"]],
                               [r[0] for r in runs["unfused"]],
                               rtol=2e-4, atol=2e-4)
    for n, v in final["unfused"].items():
        w = final["port"][n]
        if v.dtype.kind != "f" or v.shape != w.shape:
            continue
        np.testing.assert_allclose(w, v, rtol=1e-4, atol=4e-7, err_msg=n)


def test_flag_gating():
    """FLAGS.transformer_fuse is off by default: get_model builds the
    unfused program unless the flag (or the argument) says otherwise."""
    assert FLAGS.transformer_fuse is False
    main, _, _ = build(tfluid, ttransformer)
    assert not any(o.type.startswith("fused_")
                   for o in main.desc.blocks[0].ops)
    FLAGS.transformer_fuse = True
    try:
        main, _, _ = build(tfluid, ttransformer)
        assert any(o.type == "fused_qkv_matmul"
                   for o in main.desc.blocks[0].ops)
    finally:
        FLAGS.transformer_fuse = False


STANDALONE = """
import sys
for mod in ("jax", "jaxlib", "google.protobuf", "paddle_tpu"):
    sys.modules[mod] = None       # any import of them now fails
import math
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import transformer

main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    loss, _, _ = transformer.get_model(
        vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
        d_ff=64, fuse_transformer=True)
assert any(o.type == "fused_add_ln" for o in main.desc.blocks[0].ops)
scope = fluid.Scope()
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup, scope=scope)
toks = np.random.RandomState(0).randint(0, 64, (2, 17))
feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                        scope=scope)[0][0]) for _ in range(2)]
assert all(math.isfinite(x) for x in losses), losses
assert losses[1] < losses[0], losses
print("OK", losses)
"""


def test_fused_trains_without_jax_or_protobuf():
    """The card's machine has neither: build the fused LM and train 2
    steps with both made unimportable."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", STANDALONE], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout
