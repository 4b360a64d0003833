"""The port's inference transpiler (``paddle_tpu_torch/fluid/transpiler/
inference_transpiler.py``) and ``memory_optimize`` against the JAX
package's, on the CPU.

Each of the reference's cases (tests/test_inference_transpiler.py) is
built in both packages from the same names and the same values (the
reference's startup values, numpy, set in both scopes), and run through
both packages' pass:

- the rewritten ProgramDesc is the reference's, byte for byte, with the
  same rewrite count;
- the BN fold's folded parameters are the reference's within 1e-6
  relative (the same numpy arithmetic on the host);
- the port's outputs before and after a pass agree within 1e-5 (f32 on
  the CPU, the fused ops summing in another order);
- ``memory_optimize`` returns the reference's dict.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

PKGS = ("jax", "port")


def _fluid(pkg):
    return jfluid if pkg == "jax" else tfluid


def _scope(pkg):
    return JScope() if pkg == "jax" else tfluid.Scope()


def _set(pkg, scope, arrays):
    if pkg == "jax":
        for n, v in arrays.items():
            scope.set(n, np.array(v))
    else:
        set_scope_arrays(scope, arrays, "cpu")


def _get(pkg, scope, names):
    if pkg == "jax":
        return {n: np.array(scope.find_var(n)) for n in names}
    return get_scope_arrays(scope, names)


def _build(pkg, body):
    fluid = _fluid(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = body(fluid.layers)
    return main, startup, out


def _persist(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _init(body, extra=None):
    """The reference's startup values of ``body``'s program, with
    ``extra(main)`` -> {name: array} written over them."""
    main, startup, _ = _build("jax", body)
    scope = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    vals = _get("jax", scope, _persist(main))
    if extra is not None:
        vals.update(extra(main))
    return vals


def _count(program, type_):
    return sum(1 for op in program.desc.blocks[0].ops if op.type == type_)


def _desc_bytes(program):
    return program.desc.serialize_to_string()


# ------------------------------------------------------------ BN fold

def _convnet(with_bias):
    def body(layers):
        img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                             bias_attr=True if with_bias else False)
        bn = layers.batch_norm(conv, is_test=True)
        return layers.relu(bn)
    return body


def _bn_stats(main):
    """Non-trivial BN statistics, so the fold moves numbers."""
    rng = np.random.RandomState(1)
    op = [o for o in main.desc.blocks[0].ops if o.type == "batch_norm"][0]
    return {op.inputs["Mean"][0]: rng.randn(4).astype(np.float32) * 0.1,
            op.inputs["Variance"][0]: (rng.rand(4) + 0.5).astype(np.float32),
            op.inputs["Scale"][0]: (rng.rand(4) + 0.5).astype(np.float32),
            op.inputs["Bias"][0]: rng.randn(4).astype(np.float32) * 0.1}


@pytest.mark.parametrize("with_bias", [True, False],
                         ids=["with_conv_bias", "without_conv_bias"])
def test_bn_fold_matches_reference(with_bias):
    body = _convnet(with_bias)
    init = _init(body, _bn_stats)
    xv = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    descs, folded, outs = {}, {}, {}
    for pkg in PKGS:
        fluid = _fluid(pkg)
        main, startup, out = _build(pkg, body)
        scope = _scope(pkg)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            _set(pkg, scope, init)
            before, = exe.run(main, feed={"img": xv}, fetch_list=[out])
            assert _count(main, "batch_norm") == 1
            fluid.transpiler.InferenceTranspiler().transpile(main,
                                                             scope=scope)
            assert _count(main, "batch_norm") == 0
            after, = exe.run(main, feed={"img": xv}, fetch_list=[out])
        descs[pkg] = _desc_bytes(main)
        folded[pkg] = _get(pkg, scope, sorted(init))
        outs[pkg] = (np.asarray(before), np.asarray(after))
    assert descs["port"] == descs["jax"]
    for name, want in folded["jax"].items():
        got = folded["port"][name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=name)
    before, after = outs["port"]
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(after, outs["jax"][1], rtol=1e-5, atol=1e-5)


def test_bn_fold_skips_residual_add():
    """conv -> elementwise_add(conv_out, skip) -> bn is NOT a bias
    pattern: both packages leave it (and the weights) untouched."""
    def body(layers):
        img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = layers.conv2d(img, num_filters=3, filter_size=3, padding=1,
                             bias_attr=False)
        merged = layers.elementwise_add(x=conv, y=img)
        return layers.batch_norm(merged, is_test=True)

    init = _init(body)
    descs = {}
    for pkg in PKGS:
        fluid = _fluid(pkg)
        main, startup, _ = _build(pkg, body)
        scope = _scope(pkg)
        with fluid.scope_guard(scope):
            fluid.Executor(fluid.CPUPlace()).run(startup)
            _set(pkg, scope, init)
            w_name = [op.inputs["Filter"][0]
                      for op in main.desc.blocks[0].ops
                      if op.type == "conv2d"][0]
            fluid.transpiler.InferenceTranspiler().transpile(main,
                                                             scope=scope)
        assert _count(main, "batch_norm") == 1
        np.testing.assert_array_equal(_get(pkg, scope, [w_name])[w_name],
                                      init[w_name])
        descs[pkg] = _desc_bytes(main)
    assert descs["port"] == descs["jax"]


def test_bn_fold_keeps_the_device_of_the_value():
    """A folded parameter goes back to the scope as a tensor where the
    old one lived (a numpy value as a host tensor)."""
    body = _convnet(True)
    main, startup, _ = _build("port", body)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
        w = [op.inputs["Filter"][0] for op in main.desc.blocks[0].ops
             if op.type == "conv2d"][0]
        scope.set(w, np.asarray(scope.find_var(w)))
        tfluid.transpiler.InferenceTranspiler().transpile(main, scope=scope)
    assert isinstance(scope.find_var(w), torch.Tensor)
    assert scope.find_var(w).device.type == "cpu"


# ---------------------------------------------------- memory_optimize

def test_memory_optimize_liveness():
    def body(layers):
        x = layers.data(name="x", shape=[4], dtype="float32")
        h = layers.relu(layers.scale(x, scale=2.0))
        return layers.mean(h)

    live = {}
    for pkg in PKGS:
        main, _, _ = _build(pkg, body)
        before = _desc_bytes(main)
        live[pkg] = _fluid(pkg).transpiler.memory_optimize(main)
        assert _desc_bytes(main) == before          # nothing mutated
        assert tfluid.transpiler.release_memory(main) is main
    assert live["port"] == live["jax"]
    assert live["port"] and all(f <= l for f, l in live["port"].values())
    assert tfluid.memory_optimize is tfluid.transpiler.memory_optimize


# ---------------------------------------------------- attention fuse

def _attention(with_scale, prefix, h=2, t=8, d=4):
    def body(layers):
        q = layers.data(name=prefix + "q", shape=[h, t, d], dtype="float32")
        k = layers.data(name=prefix + "k", shape=[h, t, d], dtype="float32")
        v = layers.data(name=prefix + "v", shape=[h, t, d], dtype="float32")
        scores = layers.matmul(q, k, transpose_y=True)
        if with_scale:
            scores = layers.scale(scores, scale=d ** -0.5)
        out = layers.matmul(layers.softmax(scores), v)
        # a consumer after the chain so the fused output is load-bearing
        return layers.scale(out, scale=2.0)
    return body


@pytest.mark.parametrize("with_scale,prefix", [(True, "as_"),
                                               (False, "ab_")],
                         ids=["with_scale", "bare_chain"])
def test_attention_fuse_on_a_loaded_program(with_scale, prefix, tmp_path):
    """Save a plain-layer attention program, LOAD it, fuse: the same
    rewrite and desc as the reference's, one non-causal ring_attention,
    and the outputs before and after agree (a bare chain keeps scale 1,
    not the flash default 1/sqrt(D))."""
    b, h, t, d = 2, 2, 8, 4
    body = _attention(with_scale, prefix)
    rng = np.random.RandomState(0)
    feed = {prefix + n: rng.randn(b, h, t, d).astype(np.float32)
            for n in ("q", "k", "v")}
    descs, outs = {}, {}
    for pkg in PKGS:
        fluid = _fluid(pkg)
        main, startup, out = _build(pkg, body)
        exe = fluid.Executor(fluid.CPUPlace())
        d_ = str(tmp_path / pkg)
        with fluid.scope_guard(_scope(pkg)):
            exe.run(startup)
            fluid.io.save_inference_model(
                d_, [prefix + "q", prefix + "k", prefix + "v"], [out], exe,
                main_program=main)
        with fluid.scope_guard(_scope(pkg)):
            prog, _, fetches = fluid.io.load_inference_model(d_, exe)
            before, = exe.run(prog, feed=feed, fetch_list=fetches)
            assert _count(prog, "matmul") == 2
            assert fluid.transpiler.InferenceTranspiler().fuse_attention(
                prog) == 1
            assert _count(prog, "matmul") == 0
            assert _count(prog, "softmax") == 0
            ring = [op for op in prog.desc.blocks[0].ops
                    if op.type == "ring_attention"]
            assert len(ring) == 1 and ring[0].attr("causal") is False
            after, = exe.run(prog, feed=feed, fetch_list=fetches)
        descs[pkg] = _desc_bytes(prog)
        outs[pkg] = (np.asarray(before), np.asarray(after))
    assert descs["port"] == descs["jax"]
    before, after = outs["port"]
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(after, outs["jax"][1], rtol=1e-5, atol=1e-5)


def _no_fuse_case(case):
    def observed(layers):
        q = layers.data(name="oq", shape=[2, 8, 4], dtype="float32")
        k = layers.data(name="ok", shape=[2, 8, 4], dtype="float32")
        v = layers.data(name="ov", shape=[2, 8, 4], dtype="float32")
        scores = layers.matmul(q, k, transpose_y=True)
        layers.matmul(layers.softmax(scores), v)
        # a second consumer of the raw scores
        return layers.scale(scores, scale=3.0)

    def self_v(layers):
        q = layers.data(name="sq", shape=[2, 8, 8], dtype="float32")
        k = layers.data(name="sk", shape=[2, 8, 8], dtype="float32")
        attn = layers.softmax(layers.matmul(q, k, transpose_y=True))
        return layers.matmul(attn, attn)

    return {"observed_scores": observed, "self_attention_v": self_v}[case]


@pytest.mark.parametrize("case", ["observed_scores", "self_attention_v"])
def test_attention_fuse_refusals_match_reference(case):
    """Scores consumed elsewhere, or matmul(attn, attn) (V would name a
    chain intermediate whose producer the fusion deletes): no rewrite in
    either package."""
    descs = {}
    for pkg in PKGS:
        main, _, _ = _build(pkg, _no_fuse_case(case))
        assert _fluid(pkg).transpiler.InferenceTranspiler().fuse_attention(
            main) == 0
        assert _count(main, "softmax") == 1
        descs[pkg] = _desc_bytes(main)
    assert descs["port"] == descs["jax"]


def test_attention_fuse_skips_persistable_intermediate():
    """A persistable chain intermediate blocks the fusion; the same chain
    non-persistable fuses and the dead score var desc is gone, in both
    packages alike."""
    def body(layers):
        q = layers.data(name="pq", shape=[2, 4, 3], dtype="float32")
        k = layers.data(name="pk", shape=[2, 4, 3], dtype="float32")
        v = layers.data(name="pv", shape=[2, 4, 3], dtype="float32")
        s = layers.matmul(q, k, transpose_y=True, alpha=0.5)
        p = layers.softmax(s)
        return s, p, layers.matmul(p, v)

    descs = {}
    for pkg in PKGS:
        fluid = _fluid(pkg)
        main, _, (s, p, _) = _build(pkg, body)
        main.global_block().var(p.name).persistable = True
        t = fluid.transpiler.InferenceTranspiler()
        infer = main.clone(for_test=True)
        assert t.fuse_attention(infer) == 0
        infer2 = main.clone(for_test=True)
        infer2.global_block().var(p.name).persistable = False
        assert t.fuse_attention(infer2) == 1
        assert not infer2.desc.blocks[0].has_var(s.name)
        descs[pkg] = (_desc_bytes(infer), _desc_bytes(infer2))
    assert descs["port"] == descs["jax"]


# --------------------------------------------------- layer-norm fuse

def _ln_chain(mul_spelling, name, width):
    def body(layers):
        x = layers.data(name=name, shape=[width], dtype="float32")
        m = layers.reduce_mean(x, dim=[1], keep_dim=True)
        d = layers.elementwise_sub(x, m)
        sq = layers.elementwise_mul(d, d) if mul_spelling \
            else layers.square(d)
        v = layers.reduce_mean(sq, dim=[1], keep_dim=True)
        std = layers.sqrt(layers.scale(v, scale=1.0, bias=1e-5))
        return layers.elementwise_div(d, std)
    return body


@pytest.mark.parametrize("mul_spelling,name,width",
                         [(False, "ln_x", 6), (True, "lnm_x", 5)],
                         ids=["square", "mul_spelling"])
def test_layer_norm_fuse_matches_reference(mul_spelling, name, width):
    """The composed LN chain collapses to one layer_norm op, the same
    desc as the reference's (aux var descs x.shape[:begin], no trailing
    1), outputs within 1e-5 of the chain's."""
    body = _ln_chain(mul_spelling, name, width)
    xv = np.random.RandomState(1).randn(4, width).astype(np.float32)
    descs = {}
    for pkg in PKGS:
        fluid = _fluid(pkg)
        main, startup, y = _build(pkg, body)
        scope = _scope(pkg)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            ref, = exe.run(main, feed={name: xv}, fetch_list=[y])
            infer = main.clone(for_test=True)
            assert fluid.transpiler.InferenceTranspiler().fuse_layer_norm(
                infer, scope=scope) == 1
            types = [op.type for op in infer.desc.blocks[0].ops]
            assert "layer_norm" in types and "elementwise_div" not in types
            blk = infer.desc.blocks[0]
            for nm in (y.name + "@ln_mean", y.name + "@ln_var"):
                assert tuple(blk.vars[nm].shape) == (-1,)
            got, = exe.run(infer, feed={name: xv}, fetch_list=[y.name])
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)
        descs[pkg] = _desc_bytes(infer)
    assert descs["port"] == descs["jax"]


def test_transpile_runs_every_pass_like_the_reference():
    """InferenceTranspiler().transpile on a program holding all three
    patterns: the same desc and the same counts as the reference's."""
    def body(layers):
        out = _convnet(True)(layers)
        att = _attention(True, "t_")(layers)
        ln = _ln_chain(False, "t_x", 6)(layers)
        return out, att, ln

    init = _init(body, _bn_stats)
    descs = {}
    for pkg in PKGS:
        fluid = _fluid(pkg)
        main, startup, _ = _build(pkg, body)
        scope = _scope(pkg)
        with fluid.scope_guard(scope):
            fluid.Executor(fluid.CPUPlace()).run(startup)
            _set(pkg, scope, init)
            infer = main.clone(for_test=True)
            fluid.transpiler.InferenceTranspiler().transpile(infer,
                                                             scope=scope)
        assert [_count(infer, t) for t in ("batch_norm", "softmax",
                                           "ring_attention",
                                           "layer_norm")] == [0, 0, 1, 1]
        descs[pkg] = _desc_bytes(infer)
    assert descs["port"] == descs["jax"]
