"""How far bf16 rounding alone moves a ResNet step under AMP, on the CPU:
the calibration of ``chip_smoke.py``'s AMP bars.

- ``train``: one step of the fused ResNet (``--data-set``, ``--depth``,
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
from ..models import resnet


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
    ap.add_argument("--data-set", choices=("flowers", "cifar10"),
                    default="flowers")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--infer-batch", type=int, default=0,
                    help="flowers: also the AMP-vs-f32 inference gap at "
                    "this batch (0: skip)")
    args = ap.parse_args(argv)
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
