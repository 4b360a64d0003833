"""Running a block's ops eagerly on torch tensors.

Counterpart of ``paddle_tpu/core/lowering.py``.  The JAX package traces
a whole block into one XLA computation; here each op's lowering runs
eagerly, in order, against an environment of tensors (``ctx.env``), and
the executor (``executor_impl``) moves values between that environment
and the Scope.  The same lowerings also run on ``meta`` tensors for
build-time shape inference (``infer_op_outputs``).

bf16 mixed precision (``Float16Transpiler`` sets ``amp_bf16`` on the
desc): as each op runs, ``amp_cast_ins`` casts its inputs by the JAX
package's white and black lists, and ``generic_grad_lower`` applies the
same casts inside the forward it replays, so a white op's backward runs
in bf16 too and autograd through the casts gives float32 gradients for
the float32 parameters.

Ragged (LoD) values travel padded [N, T, ...] beside a device-side
int32 length vector '<name>@LEN' in the env (and '<name>@LEN@j' for
nested levels), as in the JAX package: the executor puts a ragged
feed's lengths there (``executor_impl._prepare_lod_feeds``), a
sequence op (``seq_aware``) reads them through ``ctx.seq_len_of`` and
sets its outputs' through ``ctx.set_seq_len``, and ``run_op`` carries
them across every other op whose output keeps the input's [N, T]
leading dims (``_propagate_seq_lens``).  A ``*_grad`` op's forward
replay sees the forward op's names (``_FwdOpView``), so a sequence op
reads the same '<input>@LEN' under differentiation.

A control-flow op (``ops/control_flow.py``) runs a sub-block through
``LoweringContext.sub_context`` and ``run_ops``: the sub-context shares
the block's device, mesh, mode, AMP, seed and random stream, over an
environment of the op's own making.
"""
from __future__ import annotations

import numpy as np
import torch

from .flags import FLAGS
from .registry import get_op_info
from .types import proto_to_np_dtype, proto_to_torch_dtype

EMPTY_VAR = ""

# every op lowering ``run_op`` has run in this process (a plain count,
# never reset here): a serving path that replays a captured graph or an
# exported program runs none, which the AOT tests read off this count
LOWERINGS = 0

# ---------------------------------------------------------------------------
# bf16 mixed precision: the JAX package's lists, member for member.
# ---------------------------------------------------------------------------

# matrix-product ops compute in bf16 (their f32 inputs cast to bf16);
# elementwise_add for the bias and residual adds, so an f32 bias does
# not promote every post-product activation back to f32
AMP_WHITE = frozenset({
    "mul", "matmul", "conv2d", "conv3d", "conv2d_transpose",
    "depthwise_conv2d", "sequence_conv", "elementwise_add",
})
# numerically sensitive ops compute in f32 (bf16 inputs cast back);
# FLAGS.bn_bf16 lets batch_norm pass bf16 through (its statistics are
# f32 inside the lowering either way)
AMP_BLACK = frozenset({
    "softmax", "softmax_with_cross_entropy", "cross_entropy", "mean",
    "reduce_mean", "reduce_sum", "sum", "batch_norm",
    "exp", "log", "square_error_cost", "l2_normalize", "norm",
    "sigmoid_cross_entropy_with_logits",
})
# the ops whose outputs are bf16 activations under AMP: the white list
# and the fused ops that absorb white chains
AMP_AUTOCAST_OPS = AMP_WHITE | frozenset({
    "fused_conv2d_bn_act", "fused_matmul_bias_act",
    "fused_qkv_matmul", "fused_add_ln",
})

_OPTIMIZE_ROLE = 0x0002  # framework.OpRole.Optimize
# the fused ops' slots that take the casts: the conv stage's product
# operands (its BN parameters keep their dtype), the residual add +
# LayerNorm's two streams
_AMP_SLOTS = {"fused_conv2d_bn_act": ("Input", "Filter", "Residual"),
              "fused_add_ln": ("X", "Y")}


def _to(dtype_from, dtype_to):
    def conv(x):
        if isinstance(x, torch.Tensor) and x.dtype == dtype_from:
            return x.to(dtype_to)
        return x
    return conv


def amp_cast_ins(op_type, ins, role=0):
    """``ins`` with the AMP casts of ``op_type`` applied: white ops'
    f32 inputs to bf16, black ops' bf16 inputs to f32, everything else
    as it flows in."""
    if role & _OPTIMIZE_ROLE:
        # parameter updates and learning-rate arithmetic stay f32
        return ins
    slots = _AMP_SLOTS.get(op_type)
    if slots is not None:
        conv = _to(torch.float32, torch.bfloat16)
        return Ins({s: [conv(v) if s in slots else v for v in vs]
                    for s, vs in ins._d.items()})
    if op_type in AMP_WHITE or op_type in ("fused_matmul_bias_act",
                                           "fused_qkv_matmul"):
        if op_type == "elementwise_add":
            # only activation-shaped adds (bias, residual): scalar or [1]
            # adds are learning-rate or counter arithmetic and stay f32
            x = ins.get("X")
            if x is None or x.dim() < 2:
                return ins
        conv = _to(torch.float32, torch.bfloat16)
    elif op_type in AMP_BLACK:
        if op_type == "batch_norm" and FLAGS.bn_bf16:
            # statistics in f32 inside the lowering, output in x.dtype
            return ins
        conv = _to(torch.bfloat16, torch.float32)
    else:
        return ins
    return Ins({s: [conv(v) for v in vs] for s, vs in ins._d.items()})


class Ins:
    """Read-only view of an op's input slots during lowering.

    ``ins[slot]`` -> the single value of a one-var slot;
    ``ins.list(slot)`` -> list (entries may be None for empty var names);
    ``ins.get(slot)`` -> single value or None.
    """

    __slots__ = ("_d",)

    def __init__(self, d):
        self._d = d

    def __getitem__(self, slot):
        v = self._d[slot]
        if len(v) != 1 or v[0] is None:
            raise ValueError("slot %r expected exactly one value, got %r" %
                             (slot, v))
        return v[0]

    def get(self, slot, default=None):
        v = self._d.get(slot)
        if not v or v[0] is None:
            return default
        return v[0]

    def list(self, slot):
        return self._d.get(slot, [])

    def has(self, slot):
        v = self._d.get(slot)
        return bool(v) and any(x is not None for x in v)

    def slots(self):
        return self._d.keys()


class RandomStream:
    """The random numbers of one step, made so that a CUDA graph replay
    draws afresh and draws what ``run()`` draws at the same step.

    The JAX package folds (seed, run counter) into a traced key
    (``LoweringContext.next_key``), so its compiled step draws new
    numbers at every call.  A CUDA graph instead bakes in the Philox
    seed and offset of the generators it records, except for the
    generators registered with it (``CUDAGraph.register_generator_state``),
    whose seed and offset it reads afresh at each replay.  So:

    - every draw of a step takes a ``torch.Generator`` of this stream:
      the draws without a ``seed`` attr share one, seeded from the
      program's random seed and the scope's run counter
      (``executor_impl._run_seed``), which advances op by op; each draw
      with an explicit ``seed`` takes one of its own, in op order,
      seeded with that seed alone, so it draws the same numbers at
      every step and at every place in the program (the reference takes
      ``PRNGKey(seed)`` afresh at each call);
    - ``reset(seed)`` before every step, eager or replayed, puts every
      generator back at offset 0 under its seed;
    - a captured step registers ``generators()`` with its graph before
      the capture; the warm-up steps before it made them (the capture
      makes none).  A replay then draws with the seeds and offsets the
      last ``reset`` set, and the warm-ups leave the run counter as it
      was: the step's seed is drawn once per ``run_prepared``.

    On the CPU and in ``run()`` the same generators draw eagerly, so a
    prepared step and ``run()`` draw the same numbers bit for bit on
    either device.  (The CPU's generator is not Philox: CPU and card
    numbers differ, as torch's and jax's do.)
    """

    def __init__(self, device, seed=0):
        self.device = device
        self.seed = seed
        self._run = None        # the run-seeded draws' generator
        self._fixed = []        # [[seed, generator]] explicit-seed draws
        self._next = 0
        self.frozen = False     # while a graph records: make no generator

    def rewind(self):
        """Start a step at the first explicit-seed generator again, its
        seeds and offsets as they stand (a capture: the graph reads them
        at each replay)."""
        self._next = 0

    def reset(self, seed):
        """Start a step whose run-seeded draws take ``seed``."""
        self.seed = seed
        self.rewind()
        if self._run is not None:
            self._run.manual_seed(seed)
        for s, g in self._fixed:
            g.manual_seed(s)

    def _new(self, seed):
        if self.frozen:
            raise RuntimeError(
                "a draw the warm-up steps did not make reached a captured "
                "step: its generator cannot be registered with the graph")
        return torch.Generator(device=self.device).manual_seed(seed)

    def generator(self, seed=0):
        if not seed:
            if self._run is None:
                self._run = self._new(self.seed)
            return self._run
        i = self._next
        self._next += 1
        if i == len(self._fixed):
            self._fixed.append([seed, self._new(seed)])
        elif self._fixed[i][0] != seed:
            self._fixed[i][0] = seed
            self._fixed[i][1].manual_seed(seed)
        return self._fixed[i][1]

    def generators(self):
        gens = [g for _, g in self._fixed]
        return gens if self._run is None else [self._run] + gens


class LoweringContext:
    """State shared by the ops of one block run."""

    def __init__(self, program, block_idx, env, device, seed=0, mesh=None,
                 stream=None, mode="train", constants=None):
        self.program = program
        self.block_idx = block_idx
        self.block = program.blocks[block_idx]
        self.env = env                  # name -> tensor
        self.device = device            # torch.device the block runs on
        self.seed = seed                # this run's random seed
        self.mesh = mesh                # parallel.Mesh of the run, or None
        self.mode = mode                # 'train' | 'test'
        self.amp = bool(getattr(program, "amp_bf16", False))
        self.op = None                  # the op running (executor_impl)
        self.stream = stream            # RandomStream, made at first draw
        # {id(op): device tensor}: the prepared step's constants
        # (assign_value, fill; ops/tensor.CONSTANT_OPS), made once at
        # prepare()
        self.constants = constants if constants is not None else {}

    def seq_len_of(self, name):
        """Device-side [N] int32 lengths of a ragged (LoD) value, or None
        when the value is dense."""
        return self.env.get(name + "@LEN")

    def set_seq_len(self, name, lengths):
        self.env[name + "@LEN"] = lengths

    def generator(self, seed=0):
        """``torch.Generator`` of a random op (``RandomStream``): the
        op's own for an explicit ``seed`` attr, else the step's, whose
        stream advances op by op."""
        if self.stream is None:
            self.stream = RandomStream(self.device, self.seed)
        return self.stream.generator(seed)

    def var_desc(self, name):
        """The VarDesc of ``name`` in this block or the nearest block
        above it that declares it, or None."""
        return _find_var(self.program, self.block, name)

    def var_np_dtype(self, name):
        vd = self.var_desc(name)
        return np.float32 if vd is None else proto_to_np_dtype(vd.dtype)

    def sub_context(self, block_idx, env):
        """Context for running sub-block ``block_idx`` (a control-flow
        body) over ``env``: the same device, mesh, mode, AMP and seed,
        and the same random stream, so a body's draws advance the
        step's one stream, and the same constants."""
        if self.stream is None:
            self.stream = RandomStream(self.device, self.seed)
        return LoweringContext(self.program, block_idx, env, self.device,
                               seed=self.seed, mesh=self.mesh,
                               stream=self.stream, mode=self.mode,
                               constants=self.constants)


def run_ops(ctx):
    """Run every op of ``ctx.block`` in order over ``ctx.env``
    (``ctx.op`` names the op running)."""
    for op in ctx.block.ops:
        ctx.op = op
        run_op(ctx, op)
    ctx.op = None


def run_op(ctx, op):
    global LOWERINGS
    info = get_op_info(op.type)
    if info.host_op:
        return
    LOWERINGS += 1
    ins = _gather_inputs(ctx.env, op)
    attrs = {k: a.value for k, a in op.attrs.items()}
    if ctx.amp:
        ins = amp_cast_ins(op.type, ins, getattr(op, "role", 0))
    outs = info.lower(ctx, ins, attrs, op)
    _scatter_outputs(ctx.env, op, outs)
    if not info.seq_aware:
        _propagate_seq_lens(ctx, op)


def _propagate_seq_lens(ctx, op):
    """Carry '<name>@LEN' across ops that keep the [N, T, ...] leading
    layout (embedding / fc / activation / elementwise chains), the
    padded-batch analog of the reference's ShareLoD in InferShape: the
    first input with lengths lends them to every output whose first two
    dims equal that input's, and each nested level '@LEN@j' while the
    output keeps dim j + 1."""
    env = ctx.env
    lens = src = None
    nested = []     # (j, '@LEN@j' value) of every nested level present
    for n in op.input_arg_names():
        if n and n + "@LEN" in env:
            lens = env[n + "@LEN"]
            j = 1
            while n + "@LEN@%d" % j in env:
                nested.append((j, env[n + "@LEN@%d" % j]))
                j += 1
            src = env.get(n)
            break
    if lens is None or not isinstance(src, torch.Tensor) or src.dim() < 2:
        return
    lead = tuple(src.shape[:2])
    for n in op.output_arg_names():
        if not n or n + "@LEN" in env:
            continue
        val = env.get(n)
        if isinstance(val, torch.Tensor) and val.dim() >= 2 and \
                tuple(val.shape[:2]) == lead:
            env[n + "@LEN"] = lens
            for j, v in nested:
                if val.dim() >= j + 2 and val.shape[j + 1] == src.shape[j + 1]:
                    env[n + "@LEN@%d" % j] = v


def _gather_inputs(env, op):
    d = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                vals.append(None)
            elif n in env:
                vals.append(env[n])
            else:
                raise KeyError(
                    "op %s input %s/%s not found in environment" %
                    (op.type, slot, n))
        d[slot] = vals
    return Ins(d)


def _scatter_outputs(env, op, outs):
    outs = outs or {}
    for slot, names in op.outputs.items():
        if slot not in outs:
            if names and any(n != EMPTY_VAR for n in names):
                raise ValueError("op %s produced no value for output slot %s"
                                 % (op.type, slot))
            continue
        vals = outs[slot]
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if len(vals) != len(names):
            raise ValueError(
                "op %s output slot %s: %d values for %d names" %
                (op.type, slot, len(vals), len(names)))
        for n, v in zip(names, vals):
            if n == EMPTY_VAR or v is None:
                continue
            env[n] = v


# ---------------------------------------------------------------------------
# Generic gradient lowering: autograd over the forward lowering.
# ---------------------------------------------------------------------------

def generic_grad_lower(ctx, ins, attrs, op):
    """Lower ``<fwd>_grad`` by differentiating the forward lowering.

    Where the JAX package takes ``jax.vjp`` of the forward lowering, this
    re-runs the forward lowering under ``torch.enable_grad()`` on leaves
    that require grad and calls ``torch.autograd.grad`` with the op's
    output grads as ``grad_outputs``.  A missing cotangent counts as
    zero, non-float outputs are skipped, and '' holes in the grad op's
    outputs stay holes.  The forward is recomputed: eager PyTorch has no
    dead-code elimination to drop it, as XLA does for the vjp.

    Under AMP the replayed forward takes the forward op's casts, so a
    white op's backward runs in bf16 and each leaf's gradient comes back
    in the leaf's own dtype; a cotangent whose dtype differs from its
    output's (f32 from a black consumer into a bf16 output) is cast.
    Outside AMP such a mismatch is an error.

    A forward registered with a ``grad_lower`` (``ops/nn.py``'s convs)
    hands its gradient to that lowering instead.
    """
    fwd_type = op.type[: -len("_grad")]
    info = get_op_info(fwd_type)
    if info.grad_lower is not None:
        # the forward's explicit gradient (the convs'), which never
        # re-runs the forward
        return info.grad_lower(ctx, ins, attrs, op)

    out_grad_slots = [s for s in ins.slots() if s.endswith("@GRAD")]
    fwd_output_slots = [s[: -len("@GRAD")] for s in out_grad_slots]
    fwd_input_slots = [s for s in ins.slots() if not s.endswith("@GRAD")
                       and s not in fwd_output_slots]

    # differentiable leaves, read off the grad op's own outputs: slot
    # "X@GRAD" parallels forward slot "X", with "" holes
    wrt = []  # [(fwd_slot, index)]
    for gslot, names in op.outputs.items():
        base = gslot[: -len("@GRAD")]
        for i, n in enumerate(names):
            if n != EMPTY_VAR:
                wrt.append((base, i))
    if not wrt:
        return {}

    fwd_op_view = _FwdOpView(
        fwd_type, {s: list(op.inputs.get(s, [])) for s in fwd_input_slots},
        {s: list(op.inputs.get(s, [])) for s in fwd_output_slots})

    merged = {s: list(ins.list(s)) for s in fwd_input_slots}
    # a TensorArray (ops/control_flow.py) is no leaf: its gradient stays
    # a hole
    wrt = [(slot, i) for slot, i in wrt
           if isinstance(merged[slot][i], torch.Tensor)]
    leaves = []
    with torch.enable_grad():
        for slot, i in wrt:
            leaf = merged[slot][i].detach().requires_grad_(True)
            merged[slot][i] = leaf
            leaves.append(leaf)
        fwd_ins = Ins(merged)
        if ctx.amp:
            fwd_ins = amp_cast_ins(fwd_type, fwd_ins, getattr(op, "role", 0))
        outs = info.lower(ctx, fwd_ins, dict(attrs), fwd_op_view)
        outputs, cots = [], []
        for s in fwd_output_slots:
            if s in info.no_vjp_outputs:
                continue
            vals = outs.get(s)
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            gvals = ins.list(s + "@GRAD")
            for i, ov in enumerate(vals):
                g = gvals[i] if i < len(gvals) else None
                if g is None or not _is_float(ov) or not ov.requires_grad:
                    continue
                if g.dtype != ov.dtype:
                    if not ctx.amp:
                        raise TypeError(
                            "%s: %s@GRAD is %s, the output %s" % (
                                op.type, s, g.dtype, ov.dtype))
                    g = g.to(ov.dtype)
                outputs.append(ov)
                cots.append(g)
        grads = (torch.autograd.grad(outputs, leaves, cots,
                                     allow_unused=True)
                 if outputs and leaves else [None] * len(leaves))
    by_leaf = {}
    for (slot, i), leaf, g in zip(wrt, leaves, grads):
        by_leaf[(slot, i)] = torch.zeros_like(leaf.detach()) if g is None \
            else g
    result = {}
    for gslot, names in op.outputs.items():
        base = gslot[: -len("@GRAD")]
        result[gslot] = [by_leaf.get((base, i)) if n != EMPTY_VAR else None
                         for i, n in enumerate(names)]
    return result


class _FwdOpView:
    """Minimal OpDesc stand-in handed to forward lowerings during the
    gradient's forward re-run."""

    __slots__ = ("type", "inputs", "outputs")

    def __init__(self, type_, inputs, outputs=None):
        self.type = type_
        self.inputs = inputs
        self.outputs = outputs or {}

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]


def _is_float(x):
    return isinstance(x, torch.Tensor) and x.is_floating_point()


# ---------------------------------------------------------------------------
# Build-time shape inference on meta tensors.
# ---------------------------------------------------------------------------

# Sentinels for dynamic (-1) dims, as in the JAX package: inference runs
# on a second sentinel only when an output dim equals the first, and a
# dim maps back to -1 only when it tracks both substitutions.
_FAKE_BATCH = 97
_FAKE_BATCH_ALT = 89
_META = torch.device("meta")
# the JAX package's eval_shape runs in its default 32-bit mode, where
# every 64-bit output narrows: its descs record these dtypes so (the
# lowering keeps the 64-bit tensor)
_X32 = {torch.int64: torch.int32, torch.float64: torch.float32,
        torch.uint64: torch.uint32}


def infer_op_outputs(program, block, op):
    """Infer output (shape, torch dtype) per output var by running the
    op's registered ``infer_shape`` or, as the general fallback, its
    lowering on ``meta`` tensors (no data, no FLOPs; a 64-bit dtype
    recorded narrowed, as the JAX package's ``_X32``)."""
    info = get_op_info(op.type)
    attrs = {k: a.value for k, a in op.attrs.items()}

    def build_specs(fake):
        specs = {}
        dynamic = False
        for slot, names in op.inputs.items():
            lst = []
            for n in names:
                if n == EMPTY_VAR:
                    lst.append(None)
                    continue
                vd = _find_var(program, block, n)
                if vd is None:
                    raise KeyError("var %s not found for shape inference" % n)
                shape, dtype = vd.shape, proto_to_torch_dtype(vd.dtype)
                if any(d == -1 for d in shape):
                    dynamic = True
                shape = tuple(fake if d == -1 else d for d in shape)
                lst.append(torch.empty(shape, dtype=dtype, device=_META))
            specs[slot] = lst
        return specs, dynamic

    def run(specs):
        if callable(info.infer_shape):
            outs = info.infer_shape(Ins(specs), attrs, op)
        else:
            ctx = LoweringContext(program, block.idx, {}, _META)
            outs = info.lower(ctx, Ins(specs), attrs, op)
        return {slot: (list(v) if isinstance(v, (list, tuple)) else [v])
                for slot, v in (outs or {}).items()}

    specs, dynamic = build_specs(_FAKE_BATCH)
    shaped = run(specs)
    shaped_alt = None
    if dynamic and any(
            _FAKE_BATCH in tuple(getattr(t, "shape", ()))
            for outs in shaped.values() for t in outs if t is not None):
        try:
            shaped_alt = run(build_specs(_FAKE_BATCH_ALT)[0])
        except Exception:
            shaped_alt = None

    result = {}
    for slot, names in op.outputs.items():
        if slot not in shaped:
            continue
        alt_slot = shaped_alt.get(slot) if shaped_alt else None
        for i, (n, t) in enumerate(zip(names, shaped[slot])):
            if n == EMPTY_VAR or not isinstance(t, torch.Tensor):
                continue
            alt = alt_slot[i] if alt_slot and i < len(alt_slot) else None
            alt_shape = tuple(alt.shape) if isinstance(alt, torch.Tensor) \
                and alt.dim() == t.dim() else None
            shape = []
            for j, d in enumerate(t.shape):
                if not dynamic:
                    shape.append(d)
                elif d == _FAKE_BATCH and (
                        alt_shape is None
                        or alt_shape[j] == _FAKE_BATCH_ALT):
                    shape.append(-1)
                else:
                    shape.append(d)
            dtype = t.dtype if callable(info.infer_shape) \
                else _X32.get(t.dtype, t.dtype)
            result[n] = (tuple(shape), dtype)
    return result


def _find_var(program, block, name):
    blk = block
    while blk is not None:
        if name in blk.vars:
            return blk.vars[name]
        blk = program.blocks[blk.parent_idx] if blk.parent_idx >= 0 else None
    return None
