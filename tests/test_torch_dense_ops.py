"""The dense op library of the port against the JAX package, on the CPU.

- each new op type of ``ops/math.py``, ``ops/tensor.py``,
  ``ops/loss.py``, ``ops/optimizer_ops.py`` and ``ops/nn.py`` (``lrn``,
  ``log_softmax``) replays its ``SPECS`` entry (``tools/tpu_optest.py``)
  at the spec's tolerance, forward and, where the spec has ``grad``,
  gradient;
- ``nce`` with the JAX package's negative samples put in through
  ``ops/loss.nce_negatives`` (another generator draws other numbers);
- the random ops (``*_random_batch_size_like``, ``sampling_id``,
  ``random_crop``, ``nce``'s samples): shape, dtype, range and moments,
  and an explicit seed repeats its draw;
- build-time shape inference on meta tensors gives the reference's
  shapes and (x32-narrowed) dtypes for every new op;
- the port registers every op type these files of the JAX package do.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from test_torch_ops import _check, optest, replay_spec, run_in_port

MATH_OPS = [
    "abs", "brelu", "ceil", "clip", "clip_by_norm", "cos", "cos_sim",
    "cumsum", "elementwise_floordiv", "elementwise_mod", "elu", "exp",
    "floor", "hard_shrink", "hard_sigmoid", "isfinite", "l1_norm",
    "leaky_relu", "log", "logsigmoid", "maxout", "minus", "norm", "pow",
    "prelu", "reciprocal", "reduce_max", "reduce_min", "reduce_prod",
    "relu6", "round", "sign", "sin", "soft_relu", "softplus", "softshrink",
    "softsign", "sqrt", "squared_l2_distance", "squared_l2_norm", "stanh",
    "swish", "tanh_shrink", "thresholded_relu"]
TENSOR_OPS = [
    "arg_max", "arg_min", "argsort", "bilinear_interp", "crop", "expand",
    "fill", "gather", "im2sequence", "label_smooth", "mean_iou",
    "multiplex", "one_hot", "pad", "reshape2", "reverse", "scatter",
    "shape", "slice", "split", "squeeze", "transpose2", "unsqueeze"]
LOSS_OPS = [
    "bilinear_tensor_product", "hinge_loss", "huber_loss", "lambda_rank",
    "log_loss", "margin_rank_loss", "modified_huber_loss", "rank_loss",
    "sigmoid_cross_entropy_with_logits", "smooth_l1_loss"]
OPTIMIZER_OPS = [
    "adadelta", "adamax", "average_accumulates", "decayed_adagrad", "ftrl",
    "proximal_adagrad", "proximal_gd", "rmsprop"]
NN_OPS = ["lrn", "log_softmax"]
RANDOM_OPS = ["gaussian_random_batch_size_like",
              "uniform_random_batch_size_like", "sampling_id", "random_crop"]
DETERMINISTIC = MATH_OPS + TENSOR_OPS + LOSS_OPS + OPTIMIZER_OPS + NN_OPS


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", DETERMINISTIC)
def test_dense_op_replays_its_spec(op):
    replay_spec(op)


# attrs the specs leave at their defaults: {case: (op, spec)}
S = optest.SPECS
GRAD_CASES = {
    "clip_by_norm": ("clip_by_norm", dict(S["clip_by_norm"], grad=["X"])),
    "cumsum_exclusive_reverse": ("cumsum", dict(
        S["cumsum"], attrs={"axis": 1, "exclusive": True,
                            "reverse": True})),
    "reduce_max_all": ("reduce_max", dict(S["reduce_max"],
                                          attrs={"reduce_all": True})),
    "reduce_prod_keep": ("reduce_prod", dict(
        S["reduce_prod"], attrs={"dim": [0], "keep_dim": True})),
    "split_sections": ("split", dict(
        S["split"], attrs={"axis": 1, "num": 0, "sections": [2, 4]})),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_dense_op_variant_replays(case):
    """clip_by_norm's gradient (its spec has none), an exclusive
    reversed cumsum, reduce over all dims and keeping one, split by
    sections."""
    replay_spec(*GRAD_CASES[case])


# exact zeros where the ops take |x| (ROADMAP queue 3, item 1): jax's
# abs has gradient +1 at 0, torch's sgn 0, so each case moved only a
# gradient before the port's ops took ``ops/math.absolute``
_Z = np.zeros
ZERO_CASES = {
    "abs": ("abs", dict(S["abs"], inputs={"X": np.asarray(
        [[0.0, -0.0, 0.5], [-0.5, 0.0, -0.0]], np.float32)})),
    "l1_norm": ("l1_norm", dict(S["l1_norm"], inputs={"X": np.asarray(
        [[0, 1, -2], [0, 0, 3]], np.float32)})),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits", dict(
            S["sigmoid_cross_entropy_with_logits"],
            inputs=dict(S["sigmoid_cross_entropy_with_logits"]["inputs"],
                        X=_Z((4, 5), np.float32)))),
    "rank_loss": ("rank_loss", dict(S["rank_loss"], inputs=dict(
        S["rank_loss"]["inputs"], Left=_Z((4, 1), np.float32),
        Right=_Z((4, 1), np.float32)))),
    "lambda_rank": ("lambda_rank", dict(S["lambda_rank"], inputs=dict(
        S["lambda_rank"]["inputs"], Score=type(
            S["lambda_rank"]["inputs"]["Score"])(
            _Z((8, 1), np.float32),
            S["lambda_rank"]["inputs"]["Score"].lod)))),
}


@pytest.mark.parametrize("case", sorted(ZERO_CASES))
def test_gradient_at_an_exact_zero_is_the_references(case):
    """abs at X = 0 (both signs), l1_norm on [[0, 1, -2], [0, 0, 3]],
    sigmoid_cross_entropy_with_logits at X = 0, rank_loss at Left =
    Right = 0 and lambda_rank at all-zero scores: forward and gradient
    at the spec's tolerance."""
    replay_spec(*ZERO_CASES[case])


def test_absolute_is_torch_abs_with_the_jax_gradient():
    """``ops/math.absolute``: torch.abs's value bit for bit (+0.0 at
    -0.0), the gradient sign(x) off zero and +1 at both zeros, as jax's
    select(x >= 0, g, -g)."""
    from paddle_tpu_torch.ops.math import absolute

    x = torch.tensor([-2.0, -0.0, 0.0, 3.0, -1e-30], requires_grad=True)
    y = absolute(x)
    assert torch.equal(y.detach().view(torch.int32),
                       torch.abs(x.detach()).view(torch.int32))
    g, = torch.autograd.grad(y, x, torch.full_like(x, 2.0))
    assert g.tolist() == [-2.0, 2.0, 2.0, 2.0, -2.0]


def test_nce_with_the_references_samples(monkeypatch):
    """nce's outputs at the spec's tolerance once its negative samples
    are the JAX package's (read from its SampleLabels)."""
    from paddle_tpu_torch.ops import loss as ploss

    s = optest.SPECS["nce"]
    t = optest._make_optest("nce", s)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    labels = np.asarray(ref["SampleLabels"])
    n_true = np.asarray(s["inputs"]["Label"]).reshape(labels.shape[0],
                                                      -1).shape[1]
    drawn = []

    def reference_negatives(ctx, n, num_neg, total, seed=0):
        drawn.append((n, num_neg, total))
        return torch.as_tensor(labels[:, n_true:], dtype=torch.int64)

    monkeypatch.setattr(ploss, "nce_negatives", reference_negatives)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    assert drawn == [(4, 5, 20)]
    for n in names:
        _check(n, ref[n], got[n], s["tol"])


def test_nce_draws_its_samples_from_the_step_stream():
    """Without the patch: the labels lead, the negatives lie in [0,
    total), and the cost is the sigmoid CE of the port's own samples."""
    s = optest.SPECS["nce"]
    t = optest._make_optest("nce", s)
    names = optest._fetch_names(t)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    samples = np.asarray(got["SampleLabels"])
    assert samples.shape == (4, 6) and samples.dtype == np.int64
    np.testing.assert_array_equal(samples[:, :1], s["inputs"]["Label"])
    assert samples[:, 1:].min() >= 0 and samples[:, 1:].max() < 20
    x, w, b = (np.asarray(s["inputs"][k], np.float64)
               for k in ("Input", "Weight", "Bias"))
    logits = np.einsum("nd,nkd->nk", x, w[samples]) + b[samples]
    adj = logits - np.log(5 / 20)
    lbl = np.concatenate([np.ones((4, 1)), np.zeros((4, 5))], 1)
    cost = (np.maximum(adj, 0) - adj * lbl
            + np.log1p(np.exp(-np.abs(adj)))).sum(1, keepdims=True)
    np.testing.assert_allclose(got["Cost"], cost, rtol=1e-5, atol=1e-5)


def _run_random(op, attrs=None):
    s = optest.SPECS[op]
    t = optest._make_optest(op, s)
    if attrs:
        t.attrs = dict(s["attrs"], **attrs)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    return s, ref, run_in_port(main, feed, names)


@pytest.mark.parametrize("op", ["uniform_random_batch_size_like",
                                "gaussian_random_batch_size_like"])
def test_random_batch_size_like_draws(op):
    """The batch dim from the input, the reference's shape and dtype;
    uniform within [min, max), Gaussian with the mean and std asked for
    (over a 4096 x 64 draw: within 0.02); a seeded draw repeats."""
    s, ref, got = _run_random(op)
    out = got["Out"]
    assert out.shape == ref["Out"].shape == (3, 5)
    assert out.dtype == ref["Out"].dtype == np.float32
    if op.startswith("uniform"):
        assert out.min() >= -1.0 and out.max() < 1.0
    big = optest._make_optest(op, s)
    big.inputs = {"Input": np.zeros((4096, 2), np.float32)}
    big.attrs = dict(s["attrs"], shape=[-1, 64], seed=0,
                     **({"mean": 1.5, "std": 2.0} if "gaussian" in op
                        else {"min": 2.0, "max": 4.0}))
    main, _, feed = big._build()
    x = run_in_port(main, feed, ["Out"])["Out"]
    assert x.shape == (4096, 64)
    mean, std = (1.5, 2.0) if "gaussian" in op else (3.0, 2 / 12 ** 0.5)
    assert abs(x.mean() - mean) < 0.02 and abs(x.std() - std) < 0.02
    big.attrs["seed"] = 17
    main, _, feed = big._build()
    a = run_in_port(main, feed, ["Out"])["Out"]
    b = run_in_port(main, feed, ["Out"])["Out"]
    np.testing.assert_array_equal(a, b)


def test_sampling_id_draws_by_the_probabilities():
    """One class a row, int64 as run (the desc records int32, as the
    reference's); over 20000 rows of one distribution the classes come
    up at its probabilities within 0.015."""
    s, ref, got = _run_random("sampling_id")
    out = got["Out"]
    assert out.shape == ref["Out"].shape == (4,)
    assert out.min() >= 0 and out.max() < 6
    p = np.asarray([0.05, 0.1, 0.15, 0.2, 0.5], np.float32)
    t = optest._make_optest("sampling_id", s)
    t.inputs = {"X": np.tile(p, (20000, 1))}
    main, _, feed = t._build()
    ids = run_in_port(main, feed, ["Out"])["Out"]
    freq = np.bincount(ids, minlength=5) / ids.size
    np.testing.assert_allclose(freq, p, atol=0.015)


def test_random_crop_is_a_crop_of_the_input():
    """The reference's shape; the output equals the input at one start
    a dim within range, the same for the whole batch."""
    s, ref, got = _run_random("random_crop")
    x = np.asarray(s["inputs"]["X"])
    out = got["Out"]
    assert out.shape == ref["Out"].shape == (2, 3, 6, 6)
    hits = [(i, j) for i in range(3) for j in range(3)
            if np.array_equal(x[:, :, i:i + 6, j:j + 6], out)]
    assert len(hits) == 1


NEW_OPS = DETERMINISTIC + RANDOM_OPS + ["nce"]


@pytest.mark.parametrize("op", NEW_OPS)
def test_meta_shape_inference_matches_jax(op):
    """Build-time shape inference on meta tensors infers what the JAX
    package's abstract evaluation does (64-bit outputs recorded as
    32-bit in both)."""
    from paddle_tpu.core import lowering as jlow
    from paddle_tpu.core import types as jtypes
    from paddle_tpu_torch.core import lowering as tlow
    from paddle_tpu_torch.core import types as ttypes
    import paddle_tpu_torch.fluid as tfluid

    s = optest.SPECS[op]
    t = optest._make_optest(op, s)
    main, _, _ = t._build()
    block = main.desc.blocks[0]
    op0 = block.ops[0]
    want = jlow.infer_op_outputs(main.desc, block, op0)
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    tblock = prog.desc.blocks[0]
    got = tlow.infer_op_outputs(prog.desc, tblock, tblock.ops[0])
    assert sorted(got) == sorted(want)
    for n, (shape, dtype) in want.items():
        assert got[n][0] == tuple(shape), n
        assert ttypes.np_dtype_to_proto(got[n][1]) == \
            jtypes.np_dtype_to_proto(dtype), n


def test_the_port_registers_the_dense_op_library():
    """Every op type that the JAX package's math, tensor, loss, random,
    optimizer_ops, nn, metric, detection and misc files register is the
    port's too, and the port counts 236 op types (205 at the dense op
    library's slice; crf_ctc's 5 and beam_search's 2, then the conv
    family's 5, detection's 9, misc's 8 and the metric ops' 2 since):
    the reference's 257 but its 22 reader, concurrency and distributed
    types, and the port's own conv2d_grad."""
    import importlib
    import inspect

    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    from paddle_tpu_torch.core.lowering import generic_grad_lower

    missing = {}
    for name in ("math", "tensor", "loss", "random", "optimizer_ops", "nn",
                 "metric", "detection", "misc"):
        mod = importlib.import_module("paddle_tpu.ops." + name)
        ops = {op for op in jreg.registered_ops()
               if inspect.getmodule(jreg._registry[op].lower) is mod}
        left = sorted(op for op in ops if not treg.has_op(op))
        if left:
            missing[name] = left
    assert missing == {}
    # the grad ops made on demand from the forward lowerings aside
    own = [op for op in treg.registered_ops()
           if treg._registry[op].lower is not generic_grad_lower]
    assert len(own) == 236, len(own)
    from paddle_tpu.core.lowering import generic_grad_lower as jgeneric

    ref = {op for op in jreg.registered_ops()
           if jreg._registry[op].lower is not jgeneric}
    left = {}
    for op in sorted(ref - set(own)):
        mod = inspect.getmodule(jreg._registry[op].lower).__name__
        left.setdefault(mod.rsplit(".", 1)[1], []).append(op)
    assert {k: len(v) for k, v in left.items()} == {
        "reader_ops": 10, "concurrency_ops": 6, "distributed_ops": 6}, left
    assert set(own) - ref == {"conv2d_grad"}
