"""The transformer LM under bf16 AMP in the port against the JAX package,
on the CPU at a small size (vocab 64, 2 layers, d_model 64, 4 heads,
sequence 64, batch 2).

- every op the LM's AMP programs add to the ResNet's (``ring_attention``
  dense, causal or not, with and without an explicit ``scale``;
  ``fused_qkv_matmul``; ``fused_matmul_bias_act`` with relu and gelu,
  with and without a residual and ``MulOut``; ``fused_add_ln``) and
  each one's grad, through both packages' ``run_op`` under AMP: each
  output's dtype is the reference's, and the values agree within
  rtol = atol = 2**-7 (``test_torch_amp.TOL``) once both are widened to
  f32, a sum the reference takes in a bf16 accumulator within 2**-7 of
  its terms' magnitudes besides;
- three Adam steps of the LM under ``Float16Transpiler``, unfused, fused,
  tp (dense) and moe, from the reference's startup parameters: losses within
  rtol 1e-2 of the reference's AMP losses, the dtypes of the fetched
  activations the reference's, every parameter and parameter gradient
  float32;
- the plain versions of the bf16 kernel forms against the JAX package's
  functions on bf16 operands: the flash forward and backward (their XLA
  branch on the CPU), K4's per-op plain version, K5's; and K4's
  one-rounding plain version (the card's yardstick) against a float32
  numpy product rounded once;
- the MoE program (``moe_ffn``, whose dense dispatch promotes a bf16
  activation and f32 expert weights to f32, as the reference's jnp
  does) as a fourth program, and ``moe_ffn`` and its grad through both
  packages' ``run_op``;
- the refusal that remains: a kernel wrapper given mixed or other
  dtypes;
- the two repairs: the card backward's ``delta`` takes the cotangent in
  O's dtype and sums in float32, and the ring attention grad casts
  ``Out@GRAD`` to ``Out``'s dtype.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.core import desc as jdesc
from paddle_tpu.core import lowering as jlowering
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.kernels import matmul_fused as jmf
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.core import desc as tdesc
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.fluid.io import set_scope_arrays
from paddle_tpu_torch.kernels import matmul_fused as tmf
from paddle_tpu_torch.kernels.conv_fused import bf16_ulp
from paddle_tpu_torch.models import transformer as ttransformer
from test_torch_amp import TOL, _assert_same

# the modules (each package's kernels/__init__ exports a function of the
# same name)
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

LOSS_RTOL = 1e-2
STEPS = 3
SMALL = dict(vocab_size=64, seq_len=64, d_model=64, n_head=4, n_layers=2,
             d_ff=256)
B, H, S, DH = 2, 4, 64, 16        # attention: batch, heads, sequence, head


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _as(pkg, a, dtype):
    """numpy ``a`` as a value of ``pkg`` ('jax' | 'port') in ``dtype``
    ('f32' | 'bf16' | None: as given)."""
    if pkg == "jax":
        v = jnp.asarray(a)
        return v.astype(jnp.bfloat16) if dtype == "bf16" else v
    v = torch.from_numpy(np.array(a))
    return v.to(torch.bfloat16) if dtype == "bf16" else v


def _run_both(op_type, inputs, outputs, attrs=None):
    """One op through both packages' run_op in an AMP program.
    ``inputs``: {slot: (array, dtype) or [(array, dtype), ...]};
    ``outputs``: {slot: number of vars}.  Returns {name: (jax value,
    torch value)}, a list slot's vars named ``<slot>_<i>``."""
    def names(slot, n):
        base = slot.lower().replace("@", "_")
        return [base] if n is None else ["%s_%d" % (base, i)
                                         for i in range(n)]

    ins = {s: names(s, len(v) if isinstance(v, list) else None)
           for s, v in inputs.items()}
    outs = {s: [n + "_out" for n in names(s, None if k == 1 else k)]
            for s, k in outputs.items()}
    results = {}
    for pkg in ("jax", "port"):
        desc = jdesc if pkg == "jax" else tdesc
        prog = desc.ProgramDesc()
        prog.amp_bf16 = True
        op = desc.OpDesc(op_type, inputs=ins, outputs=outs,
                         attrs=dict(attrs or {}))
        env = {}
        for s, v in inputs.items():
            for name, (a, dt) in zip(ins[s], v if isinstance(v, list)
                                     else [v]):
                env[name] = _as(pkg, a, dt)
        if pkg == "jax":
            ctx = jlowering.LoweringContext(prog, 0, env,
                                            jax.random.PRNGKey(0))
            jlowering.run_op(ctx, op)
        else:
            ctx = tlowering.LoweringContext(prog, 0, env,
                                            torch.device("cpu"))
            tlowering.run_op(ctx, op)
        for names_ in outs.values():
            for n in names_:
                results.setdefault(n, []).append(env[n])
    return results


def _host(v):
    """A jax output as a float32 (or int) numpy array: bf16 widens
    exactly, so it goes back to bf16 unchanged."""
    return np.asarray(v.astype(jnp.float32)) if \
        jnp.issubdtype(v.dtype, jnp.floating) else np.asarray(v)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------- ring_attention

ATTN = [({"causal": True}, "bf16"), ({"causal": False}, "bf16"),
        ({"causal": True, "scale": 0.3}, "bf16"),
        ({"causal": True}, "f32")]


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return [_rand(rng, B, H, S, DH) for _ in range(3)]


@pytest.mark.parametrize("attrs,dtype", ATTN)
def test_ring_attention_dense(attrs, dtype):
    q, k, v = _qkv(1)
    _assert_same(_run_both(
        "ring_attention", {"Q": (q, dtype), "K": (k, dtype),
                           "V": (v, dtype)}, {"Out": 1, "LSE": 1}, attrs))


@pytest.mark.parametrize("attrs,dtype", ATTN)
def test_ring_attention_grad(attrs, dtype):
    q, k, v = _qkv(2)
    fwd = _run_both("ring_attention", {"Q": (q, dtype), "K": (k, dtype),
                                       "V": (v, dtype)},
                    {"Out": 1, "LSE": 1}, attrs)
    out, lse = _host(fwd["out_out"][0]), _host(fwd["lse_out"][0])
    dout = _rand(np.random.RandomState(3), B, H, S, DH)
    _assert_same(_run_both(
        "ring_attention_grad",
        {"Q": (q, dtype), "K": (k, dtype), "V": (v, dtype),
         "Out": (out, dtype), "LSE": (lse, None),
         "Out@GRAD": (dout, dtype)},
        {"Q@GRAD": 1, "K@GRAD": 1, "V@GRAD": 1}, attrs))


def test_ring_attention_grad_casts_the_cotangent_to_outs_dtype():
    """An f32 cotangent of a bf16 Out is rounded to bf16 first, as the
    reference's kernel branch does (``do.astype(out.dtype)``)."""
    q, k, v = (_as("port", a, "bf16") for a in _qkv(4))
    out, lse = tfa.flash_attention_fwd_lse(q, k, v, causal=True)
    dout = torch.from_numpy(_rand(np.random.RandomState(5), B, H, S, DH))
    prog = tdesc.ProgramDesc()
    prog.amp_bf16 = True
    slots = {"Q": q, "K": k, "V": v, "Out": out, "LSE": lse,
             "Out@GRAD": dout}
    ins = {s: [s.lower().replace("@", "_")] for s in slots}
    outs = {s: [s.lower().replace("@", "_") + "_out"]
            for s in ("Q@GRAD", "K@GRAD", "V@GRAD")}
    op = tdesc.OpDesc("ring_attention_grad", inputs=ins, outputs=outs,
                      attrs={"causal": True})
    env = {ins[s][0]: t for s, t in slots.items()}
    tlowering.run_op(tlowering.LoweringContext(prog, 0, env,
                                               torch.device("cpu")), op)
    want = tfa.flash_attention_bwd(q, k, v, out, lse,
                                   dout.to(torch.bfloat16), causal=True)
    for slot, w in zip(("Q@GRAD", "K@GRAD", "V@GRAD"), want):
        assert torch.equal(env[outs[slot][0]], w), slot


# ------------------------------------------------------ fused matmuls

def _x_w(seed, n, k=64):
    rng = np.random.RandomState(seed)
    return rng, _rand(rng, B, S, k), _rand(rng, k, n, scale=k ** -0.5)


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
def test_fused_qkv_matmul(x_dtype):
    rng, x, _ = _x_w(6, 64)
    ws = [(_rand(rng, 64, 64, scale=0.125), None) for _ in range(3)]
    _assert_same(_run_both("fused_qkv_matmul",
                           {"X": (x, x_dtype), "W": ws}, {"Out": 3},
                           {"x_num_col_dims": 2}))


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
def test_fused_qkv_matmul_grad(x_dtype):
    rng, x, _ = _x_w(7, 64)
    ws = [(_rand(rng, 64, 64, scale=0.125), None) for _ in range(3)]
    dys = [(_rand(rng, B, S, 64), "bf16") for _ in range(3)]
    _assert_same(_run_both("fused_qkv_matmul_grad",
                           {"X": (x, x_dtype), "W": ws, "Out@GRAD": dys},
                           {"X@GRAD": 1, "W@GRAD": 3},
                           {"x_num_col_dims": 2}))


# act, with a residual, with MulOut (the saved pre-activation)
MBA = [("relu", False, True), ("relu", True, True), ("gelu", False, True),
       ("gelu", True, True), ("relu", False, False), ("", True, False)]


def _mba_inputs(seed, x_dtype, residual, n=256):
    rng, x, w = _x_w(seed, n)
    ins = {"X": (x, x_dtype), "W": (w, None),
           "Bias": (_rand(rng, n, scale=0.1), None)}
    if residual:
        ins["Residual"] = (_rand(rng, B, S, n), "bf16")
    return rng, ins


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("act,residual,mulout", MBA)
def test_fused_matmul_bias_act(x_dtype, act, residual, mulout):
    _, ins = _mba_inputs(8, x_dtype, residual)
    outs = {"Out": 1, "MulOut": 1} if mulout else {"Out": 1}
    _assert_same(_run_both("fused_matmul_bias_act", ins, outs,
                           {"x_num_col_dims": 2, "act": act}))


@pytest.mark.parametrize("act,residual,mulout", MBA)
def test_fused_matmul_bias_act_grad(act, residual, mulout):
    attrs = {"x_num_col_dims": 2, "act": act}
    rng, ins = _mba_inputs(9, "bf16", residual)
    outs = {"Out": 1, "MulOut": 1} if mulout else {"Out": 1}
    fwd = _run_both("fused_matmul_bias_act", ins, outs, attrs)
    saved = {"Out": (_host(fwd["out_out"][0]), "bf16")}
    if mulout:
        saved["MulOut"] = (_host(fwd["mulout_out"][0]), "bf16")
    dy = _rand(rng, B, S, 256)
    grads = {"X@GRAD": 1, "W@GRAD": 1, "Bias@GRAD": 1}
    if residual:
        grads["Residual@GRAD"] = 1
    res = _run_both("fused_matmul_bias_act_grad",
                    {**ins, **saved, "Out@GRAD": (dy, "bf16")}, grads,
                    attrs)
    # the reference sums Bias@GRAD in a bf16 accumulator, and under gelu
    # takes dpre = gelu'(pre) dy op by op in bf16 (each op's rounding its
    # autodiff's own): each sum is held to TOL of the sum of its terms'
    # magnitudes besides
    dpre = np.abs(dy).reshape(-1, 256)
    if act == "gelu":
        dpre = dpre * (1.0 + np.abs(saved["MulOut"][0]).reshape(-1, 256))
    x2 = np.abs(ins["X"][0]).reshape(-1, 64)
    _assert_same(res, {"bias_grad_out": dpre.sum(0),
                       "x_grad_out": (dpre @ np.abs(ins["W"][0]).T)
                       .reshape(B, S, 64),
                       "w_grad_out": x2.T @ dpre})


# ---------------------------------------------------------- fused_add_ln

def _ln_inputs(seed, x_dtype, d=64):
    rng = np.random.RandomState(seed)
    return rng, {"X": (_rand(rng, B, S, d), x_dtype),
                 "Y": (_rand(rng, B, S, d), "bf16"),
                 "Scale": (rng.rand(d).astype(np.float32) + 0.5, None),
                 "Bias": (_rand(rng, d), None)}


LN_ATTRS = {"begin_norm_axis": 2, "epsilon": 1e-5}


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
def test_fused_add_ln(x_dtype):
    _, ins = _ln_inputs(10, x_dtype)
    _assert_same(_run_both("fused_add_ln", ins,
                           {"Out": 1, "Sum": 1, "Mean": 1, "Variance": 1},
                           LN_ATTRS))


def test_fused_add_ln_grad():
    rng, ins = _ln_inputs(11, "bf16")
    fwd = _run_both("fused_add_ln", ins,
                    {"Out": 1, "Sum": 1, "Mean": 1, "Variance": 1},
                    LN_ATTRS)
    dy = _rand(rng, B, S, 64)
    res = _run_both("fused_add_ln_grad",
                    {**ins, "Sum": (_host(fwd["sum_out"][0]), "bf16"),
                     "Out@GRAD": (dy, "bf16")},
                    {"X@GRAD": 1, "Y@GRAD": 1, "Scale@GRAD": 1,
                     "Bias@GRAD": 1}, LN_ATTRS)
    # the reference replays the normalize op by op in bf16 under its
    # vjp: Scale@GRAD / Bias@GRAD are sums over the rows in bf16
    # accumulators, and dX = rstd (g dy - mean(g dy) - xhat mean(g dy
    # xhat)) takes its row means in bf16: each is held to TOL of its
    # terms' magnitudes besides (xhat and g are O(1))
    s_ = _host(fwd["sum_out"][0]).reshape(-1, 64).astype(np.float64)
    xhat = (s_ - s_.mean(1, keepdims=True)) / np.sqrt(
        s_.var(1, keepdims=True) + 1e-5)
    gdy = np.abs(dy.reshape(-1, 64) * ins["Scale"][0])
    dx = (gdy + gdy.mean(1, keepdims=True) + np.abs(xhat) * (
        gdy * np.abs(xhat)).mean(1, keepdims=True)) / np.sqrt(
        s_.var(1, keepdims=True) + 1e-5)
    terms = np.abs(dy).reshape(-1, 64)
    _assert_same(res, {"scale_grad_out": (terms * np.abs(xhat)).sum(0),
                       "bias_grad_out": terms.sum(0),
                       "x_grad_out": dx.reshape(B, S, 64),
                       "y_grad_out": dx.reshape(B, S, 64)})


# ------------------------------------------------------ the programs

def build(fluid, module, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(**{**SMALL, **kw})
    fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


# the ops whose output dtype AMP decides, and the output slot fetched
WATCHED = {"mul": "Out", "elementwise_add": "Out", "layer_norm": "Y",
           "ring_attention": "Out", "relu": "Out", "transpose2": "Out",
           "fused_qkv_matmul": "Out", "fused_matmul_bias_act": "Out",
           "fused_add_ln": "Out", "softmax_with_cross_entropy": "Loss",
           "moe_ffn": "Out"}


def _watched(main):
    names = []
    for op in main.desc.blocks[0].ops:
        slot = WATCHED.get(op.type)
        if slot and not op.role:
            names.extend(n for n in op.output(slot) if n)
    return names


PROGRAMS = {"unfused": {}, "fused": {"fuse_transformer": True},
            "tp": {"tp": True}, "moe": {"moe_experts": 2}}


@pytest.fixture(scope="module")
def lm_runs():
    """Reference and port, each program of PROGRAMS under AMP, 3 Adam
    steps on one batch from the reference's startup parameters:
    {(pkg, program): (losses, {activation: dtype}, {grad: dtype},
    {param: dtype})}."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, SMALL["vocab_size"],
                       (2, SMALL["seq_len"] + 1)).astype(np.int64)
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    runs = {}
    for name, kw in PROGRAMS.items():
        jmain, jstart, _ = build(jfluid, jtransformer, **kw)
        tmain, _, tloss = build(tfluid, ttransformer, **kw)
        persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                         if v.persistable)
        jscope = JScope()
        with jfluid.scope_guard(jscope):
            jfluid.Executor(jfluid.CPUPlace()).run(jstart)
        init = {n: np.asarray(jscope.find_var(n)) for n in persist}
        tscope = tfluid.Scope()
        set_scope_arrays(tscope, init, "cpu")
        watched = _watched(tmain)
        grads = [p.name + "@GRAD" for p in tmain.all_parameters()]
        fetch = [tloss.name] + watched + grads
        for pkg in ("jax", "port"):
            losses = []
            for _ in range(STEPS):
                if pkg == "jax":
                    with jfluid.scope_guard(jscope):
                        out = jfluid.Executor(jfluid.CPUPlace()).run(
                            jmain, feed=feed, fetch_list=fetch,
                            return_numpy=False)
                    dtypes = [jnp.dtype(v.dtype).name for v in out]
                    losses.append(float(np.asarray(out[0]).ravel()[0]))
                else:
                    out = tfluid.Executor(tfluid.CPUPlace()).run(
                        tmain, feed=feed, fetch_list=fetch, scope=tscope,
                        return_numpy=False)
                    dtypes = [str(v.dtype).replace("torch.", "")
                              for v in out]
                    losses.append(float(out[0].float().ravel()[0]))
            if pkg == "jax":
                pdt = {p.name: str(np.asarray(jscope.find_var(p.name)).dtype)
                       for p in tmain.all_parameters()}
            else:
                pdt = {p.name: str(tscope.find_var(p.name).dtype).replace(
                    "torch.", "") for p in tmain.all_parameters()}
            n = len(watched)
            runs[(pkg, name)] = (losses, dict(zip(watched, dtypes[1:1 + n])),
                                 dict(zip(grads, dtypes[1 + n:])), pdt)
    return runs


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_amp_losses_track_the_reference(lm_runs, program):
    want = lm_runs[("jax", program)][0]
    got = lm_runs[("port", program)][0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_amp_activation_dtypes_are_the_references(lm_runs, program):
    want = lm_runs[("jax", program)][1]
    got = lm_runs[("port", program)][1]
    assert got == want
    assert "bfloat16" in got.values()


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_amp_parameters_and_gradients_stay_float32(lm_runs, program):
    _, _, grads, params = lm_runs[("port", program)]
    assert set(grads.values()) == {"float32"}
    assert set(params.values()) == {"float32"}
    assert lm_runs[("jax", program)][2] == grads
    assert lm_runs[("jax", program)][3] == params


# ------------------------------------ plain versions vs the reference

def _close_bf16(got, want, terms=0.0):
    """torch ``got`` and jax ``want`` (both bf16 or both f32) agree
    within TOL, relative and absolute."""
    assert str(got.dtype).replace("torch.", "") == jnp.dtype(want.dtype).name
    w = _host(want).astype(np.float64)
    err = np.abs(got.double().numpy() - w)
    assert np.all(err <= TOL + TOL * np.abs(w) + TOL * terms), \
        float(err.max())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_versions_match_the_reference(causal):
    q, k, v = _qkv(12)
    dout = _rand(np.random.RandomState(13), B, H, S, DH)
    jq, jk, jv, jdo = (_as("jax", a, "bf16") for a in (q, k, v, dout))
    tq, tk, tv, tdo = (_as("port", a, "bf16") for a in (q, k, v, dout))
    jout, jlse = jfa.flash_attention_fwd_lse(jq, jk, jv, causal=causal)
    tout, tlse = tfa.flash_attention_fwd_lse(tq, tk, tv, causal=causal)
    _close_bf16(tout, jout)
    np.testing.assert_allclose(tlse.numpy(), _host(jlse), rtol=1e-5,
                               atol=1e-5)
    # both backward from the reference's residuals
    out_b, lse_b = _as("port", _host(jout), "bf16"), torch.from_numpy(
        _host(jlse))
    want = jfa.flash_attention_bwd(jq, jk, jv, jout, jlse, jdo,
                                   causal=causal)
    got = tfa.flash_attention_bwd(tq, tk, tv, out_b, lse_b, tdo,
                                  causal=causal)
    for g, w in zip(got, want):
        _close_bf16(g, w)


@pytest.mark.parametrize("act", ["", "relu", "gelu"])
@pytest.mark.parametrize("with_res", [False, True])
def test_k4_plain_version_matches_the_references(act, with_res):
    rng, x, w = _x_w(14, 96, k=64)
    x2 = x.reshape(-1, 64)
    bias = _rand(rng, 96, scale=0.1)
    res = _rand(rng, x2.shape[0], 96) if with_res else None
    jargs = [_as("jax", a, "bf16") if a is not None else None
             for a in (x2, w, bias, res)]
    targs = [_as("port", a, "bf16") if a is not None else None
             for a in (x2, w, bias, res)]
    jy, jpre = jmf.matmul_epilogue_reference(*jargs, act=act)
    ty, tpre = tmf.matmul_epilogue_reference(*targs, act=act)
    _close_bf16(ty, jy)
    _close_bf16(tpre.to(ty.dtype), jpre.astype(jy.dtype))
    # the card path on the CPU is the per-op plain version
    _close_bf16(tmf.matmul_epilogue(*targs, act=act), jy)


@pytest.mark.parametrize("act", ["", "relu", "gelu"])
def test_k4_one_rounding_plain_version(act):
    """The card's yardstick rounds once: within one bf16 ulp of a
    float64 numpy product of the widened operands with the float32
    epilogue, rounded to bf16."""
    rng, x, w = _x_w(15, 40, k=72)
    x2 = x.reshape(-1, 72)
    bias, res = _rand(rng, 40), _rand(rng, x2.shape[0], 40)
    tx, tw, tb, tr = (_as("port", a, "bf16") for a in (x2, w, bias, res))
    y, pre = tmf.matmul_epilogue_f32acc_reference(tx, tw, tb, tr, act)
    assert y.dtype == pre.dtype == torch.bfloat16
    acc = (tx.double().numpy() @ tw.double().numpy()).astype(np.float32)
    want_pre = acc + tb.float().numpy()
    want = tmf.apply_act(torch.from_numpy(want_pre), act) + tr.float()
    for got, wnt in ((pre, torch.from_numpy(want_pre)), (y, want)):
        wnt = wnt.to(torch.bfloat16).float()
        assert torch.all((got.float() - wnt).abs() <= bf16_ulp(wnt))


def test_k5_plain_version_matches_the_reference():
    rng = np.random.RandomState(16)
    x, y = _rand(rng, 128, 64), _rand(rng, 128, 64)
    scale = rng.rand(64).astype(np.float32) + 0.5
    bias = _rand(rng, 64)
    want = jmf.add_ln_reference(_as("jax", x, "bf16"), _as("jax", y, "bf16"),
                                jnp.asarray(scale), jnp.asarray(bias))
    got = tmf.add_ln_reference(_as("port", x, "bf16"),
                               _as("port", y, "bf16"),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias))
    for g, w in zip(got, want):
        _close_bf16(g, w)
    # the sum is one bf16 add in both
    assert np.array_equal(got[1].float().numpy(), _host(want[1]))


def test_k5_statistics_are_exact_f32_for_bf16_rows():
    """``ln_from_sum`` takes a bf16 row's f32 statistics from float64
    sums: the correctly rounded f32 mean in any summation order."""
    rng = np.random.RandomState(17)
    s = torch.from_numpy(_rand(rng, 64, 1024, scale=3.0)).to(torch.bfloat16)
    _, mean, var = tmf.ln_from_sum(s)
    exact = s.double().mean(1)
    assert torch.equal(mean, exact.float().to(torch.bfloat16))
    ev = ((s.double() - exact.float().double()[:, None]) ** 2).mean(1)
    assert torch.equal(var, ev.float().to(torch.bfloat16))
    # a permuted row gives the same statistics bit for bit
    perm = torch.from_numpy(rng.permutation(1024))
    _, mean_p, var_p = tmf.ln_from_sum(s[:, perm])
    assert torch.equal(mean_p, mean) and torch.equal(var_p, var)


# ------------------------------------------------------ refusals

def test_moe_under_amp_is_refused(lm_runs):
    """(Its name is kept from when the port refused it.)  The MoE
    program (a top-1 ``moe_ffn`` of 2 experts in every second block)
    runs under AMP: its dense dispatch promotes the bf16 activation and
    the f32 expert weights to f32, as the reference's jnp does, so
    ``moe_ffn``'s Out is float32 in both, and its 3 Adam steps track the
    reference's (the ``moe`` cases of the program tests above)."""
    main, _, _ = build(tfluid, ttransformer, **PROGRAMS["moe"])
    outs = [n for op in main.desc.blocks[0].ops if op.type == "moe_ffn"
            for n in op.output("Out")]
    acts = lm_runs[("port", "moe")][1]
    moe = {n: acts[n] for n in outs}
    assert moe and set(moe.values()) == {"float32"}
    assert {n: lm_runs[("jax", "moe")][1][n] for n in moe} == moe
    want, got = lm_runs[("jax", "moe")][0], lm_runs[("port", "moe")][0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_moe_ffn_promotes_as_the_reference_under_amp():
    """``moe_ffn`` and its grad through both packages' run_op under AMP
    on a bf16 X and f32 weights: each output's dtype is the
    reference's (Out f32; X@GRAD bf16, the weights' f32), the values
    within the file's bf16 tolerance."""
    rng = np.random.RandomState(20)
    x = _rand(rng, 2, 8, 16)
    wg, w1, w2 = (_rand(rng, *shp, scale=0.3) for shp in
                  ((16, 2), (2, 16, 32), (2, 32, 16)))
    ins = {"X": (x, "bf16"), "RouterW": (wg, None), "W1": (w1, None),
           "W2": (w2, None)}
    fwd = _run_both("moe_ffn", ins, {"Out": 1})
    _assert_same(fwd)
    dout = _rand(rng, 2, 8, 16)
    _assert_same(_run_both(
        "moe_ffn_grad", {**ins, "Out": (_host(fwd["out_out"][0]), None),
                         "Out@GRAD": (dout, None)},
        {"X@GRAD": 1, "RouterW@GRAD": 1, "W1@GRAD": 1, "W2@GRAD": 1}))


def test_wrappers_refuse_mixed_and_other_dtypes():
    """The argument checks that run before any launch: the flash
    wrappers on every device, the card's backward kernels and the fused
    kernels' operand check."""
    q, k, v = (_as("port", a, "bf16") for a in _qkv(18))
    lse = torch.zeros(B, H, S)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tfa.flash_attention_fwd_lse(q, k.float(), v)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tfa.flash_attention_fwd_lse(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tfa.flash_attention_bwd(q, k, v, q.float(), lse, q)
    with pytest.raises(ValueError, match="lse must be float32"):
        tfa.flash_attention_bwd(q, k, v, q, lse.bfloat16(), q)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tfa.flash_bwd_dq(q, k.float(), v, q, lse, lse, 0.25, True)
    with pytest.raises(ValueError, match="float32 lse and delta"):
        tfa.flash_bwd_dkv(q, k, v, q, lse, lse.bfloat16(), 0.25, True)
    with pytest.raises(ValueError, match="want bfloat16"):
        tfa.flash_fwd_bf16(q.float(), k.float(), v.float())
    x = torch.zeros(8, 16, dtype=torch.bfloat16)
    for ops in ([x, x.float()], [x.half(), x.half()]):
        with pytest.raises(ValueError, match="all float32 or all bfloat16"):
            tmf._kernel_operands(ops, "matmul epilogue")
    with pytest.raises(ValueError, match="want bfloat16"):
        tmf.add_ln_bf16(x.float(), x.float())
    with pytest.raises(ValueError, match="want bfloat16"):
        tmf.matmul_epilogue_bf16(x.float(), x.float().t())


# ------------------------------------------------------ the repairs

def test_flash_delta_sums_in_float32_from_the_cast_cotangent():
    """The card backward's delta = rowsum(dO * O): dO cast to O's dtype,
    then the products and the sum in float32 (``flash_attention.py``'s
    kernel branch in the reference), not a bf16 sum."""
    rng = np.random.RandomState(19)
    out = torch.from_numpy(_rand(rng, B, H, S, 128)).to(torch.bfloat16)
    do = torch.from_numpy(_rand(rng, B, H, S, 128))
    delta = tfa.flash_delta(do.to(torch.bfloat16), out)
    assert delta.dtype == torch.float32
    want = (do.to(torch.bfloat16).double() * out.double()).sum(-1)
    np.testing.assert_allclose(delta.double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    # an f32 cotangent is rounded to O's dtype first
    assert torch.equal(tfa.flash_delta(do, out), delta)
    # the reference's number for the same operands
    ref = np.asarray(((jnp.asarray(do.numpy()).astype(jnp.bfloat16)
                       .astype(jnp.float32)) *
                      jnp.asarray(out.float().numpy())).sum(-1))
    np.testing.assert_allclose(delta.numpy(), ref, rtol=1e-5, atol=1e-5)
    # a bf16 sum would be off by far more than that
    bf16_sum = (do.to(torch.bfloat16) * out).sum(-1, dtype=torch.bfloat16)
    assert float((bf16_sum.double() - want).abs().max()) > 1e-3
