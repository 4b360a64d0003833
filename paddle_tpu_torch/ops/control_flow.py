"""Control-flow operators (counterpart of ``paddle_tpu/ops/control_flow.py``).

The JAX package traces a sub-block into ``lax.cond`` / ``lax.while_loop``
/ ``lax.scan``; here a sub-block runs eagerly through
``LoweringContext.sub_context`` and ``lowering.run_ops``, over an
environment of exactly what the reference puts there (the op's
parameters, step slices, states and condition: never the outer
environment, so no outer '@LEN' is visible inside a body):

- ``recurrent`` (StaticRNN / DynamicRNN, the trainable path) loops over
  the padded time axis in Python, time-major, back to front with
  ``reverse``; when ``masked`` it freezes the states and zeroes the
  outputs past each row's length (the first input's '@LEN').  Its grad
  replays that loop under autograd (``lowering.generic_grad_lower``),
  the counterpart of the reference's ``jax.vjp`` through ``lax.scan``.
  T is fixed for a padded bucket, so a prepared step with a
  ``recurrent`` is captured as one CUDA graph a bucket.  A random op in
  its body is refused: the reference traces the body once per scan (one
  key for every step) and its grad re-traces it with the key counter
  moved on, so its gradient belongs to another draw than its forward.
- ``while`` loops on the host, reading the condition at every
  iteration; it is not differentiable, as in the reference.
- ``conditional_block`` reads its scalar condition on the host and runs
  the taken branch alone, as ``lax.cond`` does.  An output the false
  branch leaves without a prior value is zeros of the shape and dtype
  the true branch gives, which a run of the true branch on ``meta``
  tensors finds (``branch_specs``) where the reference takes
  ``jax.eval_shape``.

``while`` and ``conditional_block`` read a value on the host, which a
CUDA graph replay cannot repeat: ``prepare()`` on a card refuses them
(``executor_impl.Uncapturable``) at any depth of sub-block.

The LoDTensorArray is a ``TensorArray``: a ``[capacity, ...]`` buffer
and a device int32 ``size``, written and read at device indices (no host
sync); a write past the capacity lands in the last slot and a read is
clamped, as ``lax.dynamic_update_index_in_dim`` and
``dynamic_index_in_dim`` clamp.  ``lod_rank_table`` /
``shrink_rnn_memory`` / ``reorder_lod_tensor_by_rank`` are length
bookkeeping and identities in the padded layout, and
``split_lod_tensor`` / ``merge_lod_tensor`` (the IfElse engine) a
row-wise ``torch.where`` over both branches computed on the whole batch.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.lowering import LoweringContext, run_ops
from paddle_tpu_torch.core.registry import get_op_info, register_op
from paddle_tpu_torch.core.types import proto_to_torch_dtype

_META = torch.device("meta")


@register_op("is_empty", grad_maker=None)
def _is_empty(ctx, ins, attrs, op=None):
    x = ins["X"]
    return {"Out": torch.full((1,), x.numel() == 0, dtype=torch.bool,
                              device=x.device)}


# ---------------------------------------------------------------------------
# TensorArray (reference LoDTensorArray, framework.proto LOD_TENSOR_ARRAY)
# ---------------------------------------------------------------------------

class TensorArray:
    """Fixed-capacity stack of same-shape tensors on the device.

    ``buffer`` is ``[capacity, ...]`` (None until the first write of an
    array made without an element shape); ``size`` is the number of
    live entries, a device int32 scalar."""

    __slots__ = ("buffer", "size")

    def __init__(self, buffer, size):
        self.buffer = buffer
        self.size = size

    @staticmethod
    def empty(element_shape, dtype, capacity, device):
        return TensorArray(
            torch.zeros((int(capacity),) + tuple(int(d)
                                                 for d in element_shape),
                        dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    def clone(self):
        return TensorArray(None if self.buffer is None
                           else self.buffer.clone(), self.size.clone())

    def map(self, fn):
        """The array with ``fn`` applied to its buffer and size."""
        return TensorArray(None if self.buffer is None else fn(self.buffer),
                           fn(self.size))

    def __repr__(self):
        return "TensorArray(buffer=%s, size=%s)" % (
            None if self.buffer is None else tuple(self.buffer.shape),
            self.size)


def _as_index(i):
    """A [1] or scalar index as a device int64 scalar."""
    return i.reshape(()).long()


@register_op("create_array", grad_maker=None)
def _create_array(ctx, ins, attrs, op=None):
    """An empty TensorArray, its buffer sized by the ``element_shape``
    and ``capacity`` attrs; without ``element_shape`` the first write
    sizes it."""
    size = torch.zeros((), dtype=torch.int32, device=ctx.device)
    if "element_shape" not in attrs:
        return {"Out": TensorArray(None, size)}
    dtype = proto_to_torch_dtype(attrs["dtype"]) if "dtype" in attrs \
        else torch.float32
    return {"Out": TensorArray.empty(attrs["element_shape"], dtype,
                                     int(attrs.get("capacity", 64)),
                                     ctx.device)}


@register_op("write_to_array", seq_aware=True)
def _write_to_array(ctx, ins, attrs, op=None):
    """array[i] = x (reference tensor_array_read_write.cc WriteToArray),
    out of place; a missing or unsized array is allocated from x."""
    x = ins["X"]
    i = _as_index(ins["I"])
    arr = ins.get("Array")
    if arr is None or arr.buffer is None:
        arr = TensorArray.empty(x.shape, x.dtype,
                                int(attrs.get("capacity", 64)), x.device)
    cap = arr.buffer.shape[0]
    slot = i.clamp(0, cap - 1).reshape(1)
    buf = arr.buffer.index_copy(0, slot,
                                x.to(arr.buffer.dtype).unsqueeze(0))
    size = torch.maximum(arr.size, (i + 1).to(torch.int32))
    return {"Out": TensorArray(buf, size)}


@register_op("read_from_array", seq_aware=True)
def _read_from_array(ctx, ins, attrs, op=None):
    arr = ins["X"]
    cap = arr.buffer.shape[0]
    slot = _as_index(ins["I"]).clamp(0, cap - 1).reshape(1)
    return {"Out": arr.buffer.index_select(0, slot).squeeze(0)}


def _array_length_infer(ins, attrs, op):
    return {"Out": torch.empty((1,), dtype=torch.int32, device=_META)}


# lengths and counts come back int32: the dtype the reference's int64
# takes under the JAX package's default 32-bit mode (its ``_wide_int``)
@register_op("lod_array_length", grad_maker=None,
             infer_shape=_array_length_infer)
def _lod_array_length(ctx, ins, attrs, op=None):
    return {"Out": ins["X"].size.reshape((1,)).to(torch.int32)}


@register_op("lod_rank_table", grad_maker=None, seq_aware=True)
def _lod_rank_table(ctx, ins, attrs, op=None):
    """The [N] length vector of a padded batch (all T when dense): the
    reference sorts sequences by length so the while-RNN can shrink its
    batch; a padded batch keeps its order."""
    x = ins["X"]
    name = (op.inputs.get("X") or [None])[0] if op is not None else None
    lens = ctx.seq_len_of(name) if name else None
    if lens is None:
        n, t = x.shape[0], (x.shape[1] if x.dim() > 1 else 1)
        lens = torch.full((n,), t, dtype=torch.int32, device=x.device)
    return {"Out": lens.to(torch.int32)}


@register_op("max_sequence_len", grad_maker=None)
def _max_sequence_len(ctx, ins, attrs, op=None):
    return {"Out": ins["RankTable"].max().reshape((1,)).to(torch.int32)}


@register_op("lod_tensor_to_array", seq_aware=True)
def _lod_tensor_to_array(ctx, ins, attrs, op=None):
    """Padded [N, T, ...] -> TensorArray of the T time slices [N, ...]."""
    x = ins["X"]
    return {"Out": TensorArray(
        x.movedim(1, 0),
        torch.full((), x.shape[1], dtype=torch.int32, device=x.device))}


@register_op("array_to_lod_tensor", seq_aware=True)
def _array_to_lod_tensor(ctx, ins, attrs, op=None):
    out = ins["X"].buffer.movedim(0, 1)      # [N, T, ...]
    if op is not None:
        table = (op.inputs.get("RankTable") or [""])[0]
        if table and table in ctx.env:
            for name in op.outputs.get("Out") or []:
                if name:
                    ctx.set_seq_len(name, ctx.env[table])
    return {"Out": out}


@register_op("shrink_rnn_memory", seq_aware=True)
def _shrink_rnn_memory(ctx, ins, attrs, op=None):
    """Identity: the masked ``recurrent`` keeps the whole batch and
    freezes the finished rows."""
    return {"Out": ins["X"]}


@register_op("reorder_lod_tensor_by_rank", seq_aware=True)
def _reorder_lod_tensor_by_rank(ctx, ins, attrs, op=None):
    """Identity: a padded batch is never sorted by length."""
    return {"Out": ins["X"]}


# ---------------------------------------------------------------------------
# IfElse engine: a row-wise select (reference split/merge_lod_tensor_op.cc)
# ---------------------------------------------------------------------------

@register_op("split_lod_tensor")
def _split_lod_tensor(ctx, ins, attrs, op=None):
    """Both halves are the whole batch; merge_lod_tensor selects."""
    x = ins["X"]
    return {"OutTrue": x, "OutFalse": x}


@register_op("merge_lod_tensor")
def _merge_lod_tensor(ctx, ins, attrs, op=None):
    in_true, in_false = ins["InTrue"], ins["InFalse"]
    m = ins["Mask"].reshape(-1).bool()
    m = m.reshape((m.shape[0],) + (1,) * (in_true.dim() - 1))
    return {"Out": torch.where(m, in_true, in_false)}


# ---------------------------------------------------------------------------
# conditional_block / while / recurrent
# ---------------------------------------------------------------------------

def _run_block(ctx, block_idx, env):
    run_ops(ctx.sub_context(block_idx, env))
    return env


def _match_dtype(val, ref, amp):
    """Under AMP, pin a carried or branch-merged value to its reference
    dtype (a body may compute in bf16 from an f32 start), as the
    reference must for ``lax``'s invariant carries."""
    if (amp and isinstance(val, torch.Tensor)
            and isinstance(ref, torch.Tensor) and val.dtype != ref.dtype):
        return val.to(ref.dtype)
    return val


def _scalar_true(cond):
    """The host's reading of a [1] or scalar condition (a sync)."""
    return bool(cond.reshape(()).item())


def body_ops(program, block_idx):
    """Every op of sub-block ``block_idx`` and of the sub-blocks its ops
    run, at any depth."""
    ops, todo = [], [block_idx]
    while todo:
        for op in program.blocks[todo.pop()].ops:
            ops.append(op)
            if "sub_block" in op.attrs:
                todo.append(int(op.attrs["sub_block"].value))
    return ops


def _refuse_random_body(program, block_idx, what):
    drawn = sorted({op.type for op in body_ops(program, block_idx)
                    if get_op_info(op.type).stateful})
    if drawn:
        raise NotImplementedError(
            "%s: random op(s) %s in the body. Its gradient replays the "
            "body, which would draw again (the JAX package re-traces it "
            "with its key counter moved on, so its gradient belongs to "
            "another draw as well); draw outside the body and pass the "
            "values in" % (what, drawn))


def branch_specs(ctx, block_idx, env):
    """The values sub-block ``block_idx`` writes into ``env`` when it
    runs on ``meta`` tensors (shapes and dtypes, no data): the port's
    ``jax.eval_shape`` of a branch."""
    meta = {}
    for n, v in env.items():
        if isinstance(v, torch.Tensor):
            v = torch.empty_like(v, device=_META)
        elif isinstance(v, TensorArray):
            v = v.map(lambda t: torch.empty_like(t, device=_META))
        meta[n] = v
    run_ops(LoweringContext(ctx.program, block_idx, meta, _META,
                            seed=ctx.seed, mode=ctx.mode))
    return meta


@register_op("conditional_block")
def _conditional_block(ctx, ins, attrs, op=None):
    """Run the sub-block when the scalar Cond holds (reference
    conditional_block_op.cc).  Input: every outer value the block reads;
    Out: the outer values it writes, which keep their prior values when
    Cond is false (zeros of the true branch's shape and dtype where they
    have none)."""
    cond = ins.list("Cond")[0]
    sub_idx = int(attrs["sub_block"])
    in_names = [n for n in (op.inputs.get("Input") or []) if n]
    in_vals = list(ins.list("Input"))
    out_names = [n for n in (op.outputs.get("Out") or []) if n]
    prior = [ctx.env.get(n) for n in out_names]
    # on meta tensors (a branch_specs run of an enclosing branch) the
    # true branch gives the shapes
    if ctx.device.type == "meta" or _scalar_true(cond):
        env = _run_block(ctx, sub_idx, dict(zip(in_names, in_vals)))
        return {"Out": [_match_dtype(env[n], p, ctx.amp) if n in env else
                        p if p is not None else _zeros_like(None, ctx)
                        for n, p in zip(out_names, prior)]}
    if any(p is None for p in prior):
        specs = branch_specs(ctx, sub_idx, dict(zip(in_names, in_vals)))
        prior = [p if p is not None else _zeros_like(specs.get(n), ctx)
                 for n, p in zip(out_names, prior)]
    return {"Out": prior}


def _zeros_like(spec, ctx):
    """Zeros of ``spec``'s shape and dtype on the op's device; a float
    scalar where the branch wrote nothing, as the reference's."""
    if spec is None:
        return torch.zeros((), dtype=torch.float32, device=ctx.device)
    return torch.zeros(spec.shape, dtype=spec.dtype, device=ctx.device)


@register_op("while", grad_maker=None, seq_aware=True)
def _while(ctx, ins, attrs, op=None):
    """while-loop (reference while_op.cc): Condition [1] bool; X: the
    loop values, read and written by the body and carried; Params: the
    outer values the body only reads; the body recomputes Condition,
    which the host reads before each iteration.  Not differentiable, as
    in the reference: train recurrence with StaticRNN / DynamicRNN."""
    sub_idx = int(attrs["sub_block"])
    cond_name = (op.inputs.get("Condition") or [None])[0]
    x_names = [n for n in (op.inputs.get("X") or []) if n]
    xs = list(ins.list("X"))
    p_names = [n for n in (op.inputs.get("Params") or []) if n]
    p_vals = list(ins.list("Params"))
    c = ins.list("Condition")[0]
    if ctx.device.type == "meta":
        # shape inference: one pass of the body gives the carried shapes
        return {"Out": xs, "CondOut": c}
    while _scalar_true(c):
        env = dict(zip(p_names, p_vals))
        env.update(zip(x_names, xs))
        env[cond_name] = c
        _run_block(ctx, sub_idx, env)
        c = env[cond_name]
        xs = [_match_dtype(env[n], x, ctx.amp) for n, x in zip(x_names, xs)]
    return {"Out": xs, "CondOut": c}


@register_op("recurrent", seq_aware=True)
def _recurrent(ctx, ins, attrs, op=None):
    """Step a sub-block over the time axis (reference recurrent_op.cc;
    the JAX package's ``lax.scan``): the backend of StaticRNN and
    DynamicRNN.

    Inputs      sequences [N, T, ...], sliced to [N, ...] a step
    InitStates  the states' initial values
    Parameters  every outer value the body reads
    Attrs       sub_block, step_input_names, state_in_names,
                state_out_names, step_output_names, masked (freeze the
                states and zero the outputs past each row's length, the
                first input's '@LEN'), reverse (back to front)
    Outputs     the stacked step outputs [N, T, ...] ('@LEN': the
                first input's, when masked)
    FinalStates the last states [N, ...]
    """
    sub_idx = int(attrs["sub_block"])
    _refuse_random_body(ctx.program, sub_idx, "recurrent")
    step_in_names = list(attrs.get("step_input_names", []))
    st_in_names = list(attrs.get("state_in_names", []))
    st_out_names = list(attrs.get("state_out_names", []))
    out_names = list(attrs.get("step_output_names", []))
    masked = bool(attrs.get("masked", False))
    reverse = bool(attrs.get("reverse", False))
    param_names = [n for n in (op.inputs.get("Parameters") or []) if n]

    xs = list(ins.list("Inputs"))
    states = list(ins.list("InitStates"))
    params = list(ins.list("Parameters"))

    lens = None
    if masked and op is not None:
        src = (op.inputs.get("Inputs") or [""])[0]
        if src:
            lens = ctx.seq_len_of(src)
    n, t = xs[0].shape[0], xs[0].shape[1]
    if masked:
        if lens is None:
            mask = torch.ones(
                (t, n), device=xs[0].device,
                dtype=xs[0].dtype if xs[0].is_floating_point()
                else torch.float32)
        else:
            mask = (torch.arange(t, device=lens.device)[:, None]
                    < lens[None, :]).to(torch.float32)
    outs = [[None] * t for _ in out_names]
    for k in (range(t - 1, -1, -1) if reverse else range(t)):
        env = dict(zip(param_names, params))
        env.update(zip(step_in_names, (x[:, k] for x in xs)))
        env.update(zip(st_in_names, states))
        _run_block(ctx, sub_idx, env)
        new = [_match_dtype(env[nm], s, ctx.amp)
               for nm, s in zip(st_out_names, states)]
        if masked:
            mk = mask[k]
            new = [_match_dtype(
                mk.reshape((n,) + (1,) * (s_new.dim() - 1)) * s_new
                + (1 - mk.reshape((n,) + (1,) * (s_new.dim() - 1))) * s_old,
                s_old, ctx.amp) for s_new, s_old in zip(new, states)]
        states = new
        for j, nm in enumerate(out_names):
            o = env[nm]
            if masked:
                o = o * mask[k].reshape((n,) + (1,) * (o.dim() - 1))
            outs[j][k] = o
    result = {"Outputs": [torch.stack(o, dim=1) for o in outs],
              "FinalStates": states}
    if lens is not None and op is not None:
        for nm in (op.outputs.get("Outputs") or []):
            if nm:
                ctx.set_seq_len(nm, lens)
    return result
