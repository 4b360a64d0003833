"""Training the transformer LM through the port's fluid Executor against
the JAX package's, on the CPU at a small size (vocab 64, sequence 16,
d_model 32, 2 heads, 2 layers, d_ff 64, batch 2).

The JAX package's startup program draws the parameters; they are
carried into the port's scope as numpy arrays (the two packages draw
different random numbers from one seed), and both take 3 Adam steps on
the same feeds.  Tolerances, with their reasons:

- loss at each step: rtol 1e-4 (the same f32 math in another order);
- every parameter gradient at step 1: max |port - jax| <= 1e-4 * max
  |jax| of that gradient;
- every parameter after step 3: atol 1e-4, 3 % of the 3e-3 that three
  Adam steps at lr 1e-3 can move a weight.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import transformer as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
             d_ff=64)
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def build(fluid, module):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(**SMALL)
    return main, startup, loss


def feeds(seed, batch=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.randint(0, SMALL["vocab_size"],
                           (batch, SMALL["seq_len"] + 1)).astype(np.int64)
        out.append({"src": toks[:, :-1], "label": toks[:, 1:, None]})
    return out


@pytest.fixture(scope="module")
def both_runs():
    jmain, jstart, jloss = build(jfluid, jtransformer)
    tmain, _, tloss = build(tfluid, ttransformer)
    params = sorted(p.name for p in jmain.all_parameters())
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    fetch = [p + "@GRAD" for p in params]
    jscope, tscope = JScope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    set_scope_arrays(tscope, {n: np.asarray(jscope.find_var(n))
                              for n in persist}, "cpu")
    runs = {"jax": [], "port": []}
    for feed in feeds(0):
        with jfluid.scope_guard(jscope):
            runs["jax"].append(jexe.run(jmain, feed=feed,
                                        fetch_list=[jloss] + fetch))
        runs["port"].append(texe.run(tmain, feed=feed,
                                     fetch_list=[tloss] + fetch,
                                     scope=tscope))
    final = {"jax": {n: np.asarray(jscope.find_var(n)) for n in params},
             "port": get_scope_arrays(tscope, params)}
    return params, runs, final


def test_losses_match_at_every_step(both_runs):
    _, runs, _ = both_runs
    for step, (j, p) in enumerate(zip(runs["jax"], runs["port"])):
        np.testing.assert_allclose(p[0], j[0], rtol=1e-4,
                                   err_msg="loss at step %d" % step)


def test_gradients_match_at_step_one(both_runs):
    params, runs, _ = both_runs
    for name, j, p in zip(params, runs["jax"][0][1:], runs["port"][0][1:]):
        assert p.shape == j.shape, name
        err = np.abs(p - j).max()
        assert err <= 1e-4 * np.abs(j).max(), (name, err)


def test_parameters_match_after_three_steps(both_runs):
    params, _, final = both_runs
    assert len(params) == 2 + 2 * 13 + 4    # emb, pos; per layer; ln, head
    for name in params:
        np.testing.assert_allclose(final["port"][name], final["jax"][name],
                                   atol=1e-4, rtol=0, err_msg=name)


STANDALONE = textwrap.dedent("""
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
            d_ff=64)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    toks = np.random.RandomState(0).randint(0, 64, (2, 17))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(2)]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[1] < losses[0], losses
    assert not any(m.startswith(("jax", "google.protobuf", "paddle_tpu."))
                   and sys.modules[m] is not None for m in sys.modules)
    print("OK", losses)
""")


def test_trains_without_jax_or_protobuf():
    """The card's machine has neither: build and train 2 steps with
    both made unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", STANDALONE], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout
