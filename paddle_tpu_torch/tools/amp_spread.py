"""How far bf16 rounding alone moves a training step under AMP, on the
CPU: the calibration of ``chip_smoke.py``'s AMP bars.

- ``--model transformer``: one step of the flagship LM under
  ``Float16Transpiler`` (full width: vocab 8192, d_model 1024, 8 heads,
  d_ff 4096, sequence 2048; ``--depth`` layers, default 1, at
  ``--batch``, default 1: the card-vs-CPU oracle's step), unfused and
  fused-block, from the startup drawn with ``--seed``, then twice more
  with every weight matrix moved by one bf16 ulp up and down: the
  relative Frobenius distance of the loss, of the first block's output
  and of each parameter gradient from the first step's
  (``train_amp_oracle`` and ``train_fused_amp_oracle`` hold the card to
  twice each);
- ``train`` (``--model resnet50``, the default): one step of the fused
  ResNet (``--data-set``, ``--depth``,
  ``--batch``) under ``Float16Transpiler`` and ``FLAGS_bn_bf16`` from
  the startup drawn with ``--seed``, then twice more with every filter
  moved by one bf16 ulp up and down: the relative Frobenius distance of
  the loss, of each fused stage's output and of each parameter
  gradient from the first step's (``train_resnet_fused_amp_oracle``
  holds the card to twice each);
- ``infer`` (flowers only): the is_test fused forward under AMP against
  the f32 one at ``--infer-batch``, each BN's running statistics set to
  the batch's own (``infer_resnet_fused_amp``'s ``INFER_AMP_TOL``).

Run from the repository root:

    python -m paddle_tpu_torch.tools.amp_spread [--depth 50] [--batch 2]
        [--seed 0] [--data-set flowers] [--infer-batch 4]
    python -m paddle_tpu_torch.tools.amp_spread --model transformer
        [--depth 1] [--batch 1] [--seed 0]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import fluid
from ..core.flags import FLAGS
from ..fluid.io import get_scope_arrays, set_scope_arrays
from ..kernels.conv_fused import bf16_ulp
from ..models import resnet, transformer

# the flagship LM at full width (chip_smoke.py's TRAIN_LM)
LM = dict(vocab_size=8192, seq_len=2048, d_model=1024, n_head=8, d_ff=4096,
          learning_rate=1e-3)


def _build(data_set, depth, fused, is_test=False, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.get_model(
            data_set=data_set, depth=depth, learning_rate=0.01,
            input_dtype="uint8", is_test=is_test,
            data_format="NHWC" if fused else "NCHW", fused_stages=fused)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


def _feed(data_set, batch, seed):
    rng = np.random.RandomState(seed)
    side, classes = (32, 10) if data_set == "cifar10" else (224, 102)
    return {"data": rng.randint(0, 256, (batch, 3, side, side))
            .astype(np.uint8),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def _fro(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nudged(v, step):
    t = torch.from_numpy(v).to(torch.bfloat16).float()
    return (t + step * bf16_ulp(t)).numpy()


def build_lm(n_layers, fuse, amp=True):
    """The flagship LM program at full width and ``n_layers``, the
    fused-block program with ``fuse``, under AMP with ``amp``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(n_layers=n_layers,
                                           fuse_transformer=fuse, **LM)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


def lm_feed(batch, seed):
    """One batch of next-token pairs at the LM's sequence length."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, LM["vocab_size"],
                       (batch, LM["seq_len"] + 1)).astype(np.int64)
    return {"src": toks[:, :-1], "label": toks[:, 1:, None]}


def lm_block_output(main):
    """The name of the first block's output, the residual stream after
    its FFN.  Unfused, the input of the third layer_norm (the next
    block's, or the final one); fused, the Sum of the second
    fused_add_ln, which fuses that residual add with the layer_norm."""
    ops = [op for op in main.desc.blocks[0].ops if not op.role]
    seams = [op.output("Sum")[0] for op in ops if op.type == "fused_add_ln"]
    if seams:
        return seams[1]
    return [op.input("X")[0] for op in ops if op.type == "layer_norm"][2]


def nudge_weights(arrays, step, params):
    """``arrays`` with every weight matrix (a 2-D array named in
    ``params``) rounded to bf16 and moved by ``step`` bf16 ulps (0:
    unchanged)."""
    return {k: _nudged(v, step) if step and v.ndim == 2 and k in params
            else v for k, v in arrays.items()}


def lm_spread(n_layers, batch, seed, fuse):
    """The relative Frobenius distance one bf16 ulp on every weight
    matrix, up or down (the larger), moves the LM's AMP step on the CPU:
    {name: spread} for the loss, the block output and each gradient."""
    main, startup, loss = build_lm(n_layers, fuse)
    startup.random_seed = seed
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    arrays = get_scope_arrays(scope, persist)
    params = [p.name for p in main.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    fetch = [loss.name, lm_block_output(main)] + grads
    feed = lm_feed(batch, seed + 4)
    runs = []
    for step in (0, 1, -1):
        host = fluid.Scope()
        set_scope_arrays(host, nudge_weights(arrays, step, params), "cpu")
        runs.append(exe.run(main, feed=feed, fetch_list=fetch, scope=host))
    base, up, down = runs
    return {n: max(_fro(u, b), _fro(d, b))
            for n, b, u, d in zip(fetch, base, up, down)}, fetch


def lm_train_spread(n_layers, batch, seed):
    out = {}
    for fuse in (False, True):
        spread, fetch = lm_spread(n_layers, batch, seed, fuse)
        g = [spread[n] for n in fetch[2:]]
        out["fused" if fuse else "unfused"] = {
            "loss": spread[fetch[0]], "block_output": spread[fetch[1]],
            "grad_worst": max(g), "grad_median": float(np.median(g)),
            "grad_worst_name": max(fetch[2:], key=spread.get)}
    return out


def train_spread(data_set, depth, batch, seed):
    main, startup, loss = _build(data_set, depth, True, amp=True)
    startup.random_seed = seed
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    arrays = get_scope_arrays(scope, persist)
    ys = [op.output("Y")[0] for op in main.desc.blocks[0].ops
          if op.type == "fused_conv2d_bn_act"]
    grads = [p.name + "@GRAD" for p in main.all_parameters()
             if p.trainable]
    fetch = [loss.name] + ys + grads
    feed = _feed(data_set, batch, seed + 7)
    runs = []
    for step in (0, 1, -1):
        host = fluid.Scope()
        set_scope_arrays(host, {k: _nudged(v, step) if step and v.ndim == 4
                                else v for k, v in arrays.items()}, "cpu")
        runs.append(exe.run(main, feed=feed, fetch_list=fetch, scope=host))
    base, up, down = runs
    spread = [max(_fro(u, b), _fro(d, b)) for b, u, d in zip(base, up, down)]
    n = len(ys)
    y_s, g_s = spread[1:1 + n], spread[1 + n:]
    return {"loss": spread[0], "stage_y_first": y_s[0],
            "stage_y_last": y_s[-1], "stage_y_worst": max(y_s),
            "grad_worst": max(g_s), "grad_median": float(np.median(g_s))}


def infer_gap(batch, seed):
    """Max |AMP - f32| of the is_test fused softmax, and top-1
    agreement."""
    exe = fluid.Executor(fluid.CPUPlace())
    feed = _feed("flowers", batch, seed + 6)
    tmain, tstart, _ = _build("flowers", 50, False)
    scope = fluid.Scope()
    exe.run(tstart, scope=scope)
    persist = sorted(n for n, v in tmain.desc.blocks[0].vars.items()
                     if v.persistable)
    params = get_scope_arrays(scope, persist)
    bns = [op for op in tmain.desc.blocks[0].ops if op.type == "batch_norm"]
    stats = exe.run(tmain, feed=feed, scope=scope,
                    fetch_list=[op.output("SavedMean")[0] for op in bns] +
                    [op.output("SavedVariance")[0] for op in bns])
    for op, m, v in zip(bns, stats[:len(bns)], stats[len(bns):]):
        params[op.input("Mean")[0]] = m
        params[op.input("Variance")[0]] = v
    probs = {}
    for amp in (False, True):
        FLAGS.bn_bf16 = amp
        main, _, _ = _build("flowers", 50, True, is_test=True, amp=amp)
        block = main.desc.blocks[0]
        arrays = {}
        for name, v in params.items():
            vd = block.vars.get(name)
            if vd is None:
                continue
            if v.ndim == 4 and tuple(v.shape) != tuple(vd.shape):
                v = np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))
            arrays[name] = v
        host = fluid.Scope()
        set_scope_arrays(host, arrays, "cpu")
        softmax = [op.output("Out")[0] for op in block.ops
                   if op.type == "softmax"]
        probs[amp] = exe.run(main, feed=feed, fetch_list=softmax,
                             scope=host)[0]
    return {"softmax_max_abs": float(np.abs(probs[True] - probs[False])
                                     .max()),
            "top1_agree": [int((probs[True].argmax(1) ==
                                probs[False].argmax(1)).sum()), batch]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("resnet50", "transformer"),
                    default="resnet50")
    ap.add_argument("--data-set", choices=("flowers", "cifar10"),
                    default="flowers")
    ap.add_argument("--depth", type=int, default=None,
                    help="ResNet depth (50) or LM layers (1)")
    ap.add_argument("--batch", type=int, default=None,
                    help="ResNet 2, LM 1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--infer-batch", type=int, default=0,
                    help="flowers: also the AMP-vs-f32 inference gap at "
                    "this batch (0: skip)")
    args = ap.parse_args(argv)
    if args.model == "transformer":
        depth, batch = args.depth or 1, args.batch or 1
        print(json.dumps({"model": "transformer", "depth": depth,
                          "batch": batch, "seed": args.seed, **LM,
                          "train_spread": lm_train_spread(depth, batch,
                                                          args.seed)}))
        return
    args.depth = args.depth or 50
    args.batch = args.batch or 2
    prev = FLAGS.bn_bf16
    try:
        FLAGS.bn_bf16 = True
        out = {"data_set": args.data_set, "depth": args.depth,
               "batch": args.batch, "seed": args.seed,
               "train_spread": train_spread(args.data_set, args.depth,
                                            args.batch, args.seed)}
        if args.infer_batch and args.data_set == "flowers":
            out["infer_batch"] = args.infer_batch
            out["infer"] = infer_gap(args.infer_batch, args.seed)
    finally:
        FLAGS.bn_bf16 = prev
    print(json.dumps(out))


if __name__ == "__main__":
    main()
