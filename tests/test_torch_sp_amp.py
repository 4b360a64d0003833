"""The sequence-parallel transformer LM (``get_model(sp=True)``) under
bf16 AMP (``Float16Transpiler``) in the port against the JAX package,
on the CPU at a small size (vocab 64, sequence 16, d_model 32, 2 heads,
2 layers, d_ff 64, batch 2).

Three Adam steps on one batch from the JAX package's startup scope
(carried over as numpy arrays), through the port's
``ParallelExecutor(use_cuda=False, mesh_axes={"sp": p})`` and the JAX
package's ``ParallelExecutor(use_tpu=False, mesh_axes=...)`` on p host
devices, p = 2 and 4; and the dense AMP program through both packages'
``Executor`` from the same start, the yardstick of what bf16 alone
moves.  Tolerances, with their reasons:

- losses within rtol 1e-3, twice the largest gap measured here (4.6e-4
  at p = 4; the dense AMP programs' own 2.4e-4): one bf16 rounding that
  falls the other way in the two packages moves a sum;
- parameters after step 3: the change of all parameters against the
  reference's change, in relative Frobenius norm, within 0.2 and within
  1.5 times the dense AMP programs' own (0.08 at p = 2 and 4 against
  the dense 0.10 here: a gradient element within a rounding of 0 takes
  the other sign of Adam's normalised step); each element within 6e-3,
  the most that three Adam steps at lr 1e-3, each of either sign, can
  set two runs apart (5.3e-3 here, the dense programs 5.1e-3);
- the fetched activations have the reference's dtypes, and every
  parameter and parameter gradient is float32;
- the ring ran: p(p+1)/2 folds a layer and step, each on bf16 q/k/v.

Besides: the dtype of ``Out@GRAD`` at ``ring_attention_grad`` in both
packages' AMP sp programs (bf16, Out's), and an f32 cotangent handed to
the ring as it arrives, as the reference's ring takes it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import ring as jring
from paddle_tpu_torch.core import desc as tdesc
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.parallel import ring as tring
from test_torch_lm_amp import _watched

SMALL = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
             d_ff=64)
STEPS = 3
LOSS_RTOL = 1e-3
UPDATE_FRO = 0.2
UPDATE_VS_DENSE = 1.5
PARAM_ATOL = 6e-3
MESHES = [2, 4]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def build(fluid, module, sp=True):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(sp=sp, **SMALL)
    fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


def _feed():
    toks = np.random.RandomState(2).randint(
        0, SMALL["vocab_size"], (2, SMALL["seq_len"] + 1)).astype(np.int64)
    return {"src": toks[:, :-1], "label": toks[:, 1:, None]}


def _dtype(v):
    if isinstance(v, torch.Tensor):
        return str(v.dtype)[len("torch."):]
    return jnp.dtype(v.dtype).name


def _grad_dtypes(monkeypatch, registry, into, tag):
    """Record (Q, Out, Out@GRAD) dtypes at every ring_attention_grad the
    package lowers (the JAX package's traces included)."""
    info = registry.get_op_info("ring_attention_grad")
    lower = info.lower

    def spy(ctx, ins, attrs, op=None):
        into.append((tag, _dtype(ins["Q"]), _dtype(ins["Out"]),
                     _dtype(ins["Out@GRAD"])))
        return lower(ctx, ins, attrs, op)

    monkeypatch.setattr(info, "lower", spy)


@pytest.fixture(scope="module")
def runs():
    """{(pkg, p): (losses, {activation: dtype}, {grad: dtype}, {param:
    array after step 3}, {param: dtype}, folds)} for p in (0, *MESHES),
    p = 0 the dense AMP program; plus the start and the recorded
    ring_attention_grad dtypes."""
    jmain, jstart, _ = build(jfluid, jtransformer)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in persist}
    feed = _feed()
    out, seen = {}, []
    mp = pytest.MonkeyPatch()
    try:
        _grad_dtypes(mp, jregistry, seen, "jax")
        _grad_dtypes(mp, tregistry, seen, "port")
        folds = []
        fold = tring.flash_attention_chunk

        def counted(q, *a, **kw):
            folds.append(str(q.dtype))
            return fold(q, *a, **kw)

        mp.setattr(tring, "flash_attention_chunk", counted)
        for p in [0] + MESHES:
            for pkg in ("jax", "port"):
                fluid, module = (jfluid, jtransformer) if pkg == "jax" \
                    else (tfluid, ttransformer)
                main, _, loss = build(fluid, module, sp=bool(p))
                params = sorted(v.name for v in main.all_parameters())
                watched = _watched(main)
                fetch = [loss.name] + watched + [n + "@GRAD" for n in params]
                if pkg == "jax":
                    scope = JScope()
                    for name, arr in init.items():
                        scope.set(name, arr.copy())
                else:
                    scope = tfluid.Scope()
                    set_scope_arrays(scope, init, "cpu")
                del folds[:]
                if p:
                    kw = dict(loss_name=loss.name, main_program=main,
                              scope=scope, mesh_axes={"sp": p})
                    pe = (jfluid.ParallelExecutor(use_tpu=False, **kw)
                          if pkg == "jax" else
                          tfluid.ParallelExecutor(use_cuda=False, **kw))
                    step = lambda: pe.run(fetch_list=fetch, feed=feed,  # noqa
                                          return_numpy=False)
                elif pkg == "jax":
                    exe = jfluid.Executor(jfluid.CPUPlace())

                    def step():
                        with jfluid.scope_guard(scope):
                            return exe.run(main, feed=feed, fetch_list=fetch,
                                           return_numpy=False)
                else:
                    exe = tfluid.Executor(tfluid.CPUPlace())
                    step = lambda: exe.run(main, feed=feed,  # noqa: E731
                                           fetch_list=fetch, scope=scope,
                                           return_numpy=False)
                losses = []
                for _ in range(STEPS):
                    got = step()
                    losses.append(float(np.asarray(
                        got[0].float() if pkg == "port" else got[0])
                        .ravel()[0]))
                dtypes = [_dtype(v) for v in got]
                n = len(watched)
                if pkg == "jax":
                    final = {k: np.array(scope.find_var(k)) for k in params}
                    pdt = {k: str(v.dtype) for k, v in final.items()}
                else:
                    final = get_scope_arrays(scope, params)
                    pdt = {k: str(scope.find_var(k).dtype)[len("torch."):]
                           for k in params}
                out[(pkg, p)] = (losses, dict(zip(watched, dtypes[1:1 + n])),
                                 dict(zip(fetch[1 + n:], dtypes[1 + n:])),
                                 final, pdt, list(folds))
    finally:
        mp.undo()
    return out, init, seen


def _update_gap(got, want, init):
    """||(got - init) - (want - init)|| / ||want - init|| over all
    parameters: how far one run's three Adam steps are from another's."""
    num = sum(float(((got[k] - want[k]).astype(np.float64) ** 2).sum())
              for k in want)
    den = sum(float(((want[k] - init[k]).astype(np.float64) ** 2).sum())
              for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("p", MESHES)
def test_sp_amp_losses_track_the_reference(runs, p):
    res, _, _ = runs
    want, got = res[("jax", p)][0], res[("port", p)][0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("p", MESHES)
def test_sp_amp_parameters_track_the_reference(runs, p):
    res, init, _ = runs
    want, got = res[("jax", p)][3], res[("port", p)][3]
    gap = _update_gap(got, want, init)
    dense = _update_gap(res[("port", 0)][3], res[("jax", 0)][3], init)
    assert gap <= UPDATE_FRO and gap <= UPDATE_VS_DENSE * dense, (gap, dense)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("p", MESHES)
def test_sp_amp_activation_dtypes_are_the_references(runs, p):
    res, _, _ = runs
    want, got = res[("jax", p)][1], res[("port", p)][1]
    assert got == want
    assert "bfloat16" in got.values()


@pytest.mark.parametrize("p", MESHES)
def test_sp_amp_parameters_and_gradients_stay_float32(runs, p):
    res, _, _ = runs
    _, _, grads, _, params, _ = res[("port", p)]
    assert set(grads.values()) == {"float32"}
    assert set(params.values()) == {"float32"}
    assert res[("jax", p)][2] == grads
    assert res[("jax", p)][4] == params


@pytest.mark.parametrize("p", MESHES)
def test_sp_amp_runs_the_ring_on_bf16(runs, p):
    """p(p+1)/2 folds a layer and step, every one on bf16 q/k/v; the
    dense AMP program runs none."""
    res, _, _ = runs
    folds = res[("port", p)][5]
    assert len(folds) == STEPS * SMALL["n_layers"] * p * (p + 1) // 2
    assert set(folds) == {"torch.bfloat16"}
    assert res[("port", 0)][5] == []


def test_out_grad_reaches_the_ring_grad_in_outs_dtype(runs):
    """In both packages' AMP sp programs the cotangent at
    ring_attention_grad is bf16, Out's dtype (transpose's grad of a bf16
    Out): the reference's ring sums delta from it as it arrives, and so
    does the port's.  (The JAX package also traces the op on f32
    operands; every lowering on bf16 Q has a bf16 cotangent.)"""
    _, _, seen = runs
    for pkg in ("jax", "port"):
        amp = [s for s in seen if s[0] == pkg and s[1] == "bfloat16"]
        assert amp, pkg
        assert {s[2:] for s in amp} == {("bfloat16", "bfloat16")}, pkg
    assert {s[1] for s in seen if s[0] == "port"} == {"bfloat16"}


def test_ring_grad_takes_an_f32_cotangent_as_it_arrives():
    """An f32 Out@GRAD of a bf16 Out on an sp mesh: the port's
    ring_attention_grad passes it to the ring uncast, as the reference's
    lowering does; delta = rowsum(dO O) from the f32 values, and the
    gradients match the reference's ring on the f32 cotangent (one bf16
    ulp plus p ulps of max |value|: p bf16-rounded steps summed)."""
    from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

    p = 2
    rng = np.random.RandomState(21)
    q, k, v, do = ((rng.randn(2, 3, 32, 8) * 0.5).astype(np.float32)
                   for _ in range(4))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mesh = make_mesh({"sp": p}, [torch.device("cpu")] * p)
    out, lse = tring.ring_attention_fwd_lse(tq, tk, tv, mesh)
    tdo = torch.from_numpy(do)
    prog = tdesc.ProgramDesc()
    prog.amp_bf16 = True
    slots = {"Q": tq, "K": tk, "V": tv, "Out": out, "LSE": lse,
             "Out@GRAD": tdo}
    ins = {s: [s.lower().replace("@", "_")] for s in slots}
    outs = {s: [s.lower().replace("@", "_") + "_out"]
            for s in ("Q@GRAD", "K@GRAD", "V@GRAD")}
    op = tdesc.OpDesc("ring_attention_grad", inputs=ins, outputs=outs,
                      attrs={"causal": True})
    env = {ins[s][0]: t for s, t in slots.items()}
    tlowering.run_op(tlowering.LoweringContext(
        prog, 0, env, torch.device("cpu"), mesh=mesh), op)
    got = [env[outs[s][0]] for s in ("Q@GRAD", "K@GRAD", "V@GRAD")]
    uncast = tring.ring_attention_bwd(tq, tk, tv, out, lse, tdo, mesh)
    for a, b in zip(got, uncast):
        assert torch.equal(a, b)
    rounded = tring.ring_attention_bwd(tq, tk, tv, out, lse,
                                       tdo.bfloat16(), mesh)
    assert any(not torch.equal(a, b) for a, b in zip(got, rounded))
    jmesh = jmake_mesh({"sp": p}, devices=jax.devices("cpu")[:p])
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    jout = jnp.asarray(out.float().numpy()).astype(jnp.bfloat16)
    want = jax.jit(lambda q, k, v, o, l, d: jring.ring_attention_bwd(
        q, k, v, o, l, d, jmesh))(*jargs, jout, jnp.asarray(lse.numpy()),
                                  jnp.asarray(do))
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        err = (g.float() - w).abs()
        assert bool((err <= bf16_ulp(w) + p * 2 ** -8 * w.abs().max())
                    .all())
