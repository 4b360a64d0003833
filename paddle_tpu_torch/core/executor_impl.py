"""Core Executor: runs a block of a ProgramDesc against a Scope.

Counterpart of the part of ``paddle_tpu/core/executor_impl.py``
(``ExecutorCore.run``) that a training step of a fluid Program needs.
Where the JAX package functionalizes the block into one jitted XLA
computation, this runs the block's ops eagerly, in order, on the place's
device (``lowering.run_op``):

- feeds become tensors on the device (int64 ids stay int64, after the
  JAX package's out-of-range check);
- a value neither fed nor written earlier in the block is read from the
  scope;
- every persistable variable the block writes (parameters, optimizer
  state) is written back to the scope after the run;
- a non-persistable, non-fetched value is dropped after its last reader
  in the block, so a training step does not keep every activation and
  every gradient alive to the end;
- everything runs under ``torch.no_grad()``: gradients come from the
  program's own ``*_grad`` ops.

With a ``mesh`` (``parallel.Mesh``), the ops that shard over it (the
ring attention op under an ``sp`` axis) place their shards on the
mesh's devices; every other op runs on the place's device.

Under bf16 AMP (``program.amp_bf16``) the lowering casts each op's
inputs (``lowering.amp_cast_ins``).  Two AMP programs are refused, each
naming its ROADMAP item: one run on a mesh whose sp axis the ring
attention shards over (the ring's chunk kernel K9 has no bf16 form), and
one holding ``moe_ffn`` (its dense dispatch has no test under AMP).

Not ported yet: the compile cache and ``PreparedProgram``, GSPMD's
partition of the whole step over a mesh, the numerics bisect machinery,
host ops and ragged (LoD) feeds.
"""
from __future__ import annotations

import numpy as np
import torch

from .lowering import LoweringContext, run_op
from .registry import get_op_info
from .types import proto_to_np_dtype

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -(2 ** 31)

# ops not ported under bf16 AMP, with the ROADMAP item that brings
# each: an AMP program that holds one (or its grad) is refused rather
# than run on casts no test holds against the reference
AMP_UNPORTED = {"moe_ffn": "ROADMAP queue 1 item 3h, moe_ffn under AMP"}

# a callable op -> context manager that every op runs inside, e.g. CUDA
# events around it for its device time (tools/profile_train.py); None,
# the loop pays one test per op
OP_HOOK = None


class ExecutorCore:
    """place: the device every op runs on.  mesh: an optional
    ``parallel.Mesh`` that the sharded ops lay their shards over."""

    def __init__(self, place, mesh=None):
        self.place = place
        self.device = place.torch_device()
        self.mesh = mesh

    def run(self, program, scope, block_id=0, feed=None, fetch_list=None,
            return_numpy=True):
        block = program.blocks[block_id]
        prelude, core_ops, postlude, mixed = _segment(block)
        host = [op.type for op in prelude + postlude] if not mixed else \
            [op.type for op in block.ops if get_op_info(op.type).host_op]
        if host:
            raise NotImplementedError(
                "host ops %s are not ported to paddle_tpu_torch yet"
                % sorted(set(host)))
        if getattr(program, "amp_bf16", False):
            _refuse_unported_amp(block, self.mesh)
        fetch_list = list(fetch_list or [])
        env = {name: self._feed_tensor(block, name, val)
               for name, val in (feed or {}).items()}
        ctx = LoweringContext(program, block_id, env, self.device,
                              seed=_run_seed(program, scope), mesh=self.mesh)
        written = set()
        free_after = _free_plan(block, core_ops, set(fetch_list))
        with torch.no_grad():
            for i, op in enumerate(core_ops):
                for name in op.input_arg_names():
                    if name and name not in env:
                        env[name] = self._scope_tensor(scope, name)
                if OP_HOOK is None:
                    run_op(ctx, op)
                else:
                    with OP_HOOK(op):
                        run_op(ctx, op)
                written.update(n for n in op.output_arg_names() if n)
                for name in free_after.get(i, ()):
                    env.pop(name, None)
        for name in sorted(written):
            vd = block.find_var_recursive(name)
            if vd is not None and vd.persistable and name in env:
                (scope.find_scope_of(name) or scope).set(name, env[name])
        fetches = []
        for name in fetch_list:
            val = env[name] if name in env else scope.find_var(name)
            fetches.append(val)
        if return_numpy:
            fetches = fetches_to_host(fetches)
        return fetches

    def _feed_tensor(self, block, name, val):
        if isinstance(val, torch.Tensor):
            return val.to(self.device)
        vd = block.find_var_recursive(name)
        if vd is not None and not hasattr(val, "dtype"):
            arr = np.asarray(val, dtype=proto_to_np_dtype(vd.dtype))
        else:
            arr = np.asarray(val)
        if arr.dtype.kind in "iu" and arr.dtype.itemsize == 8 and arr.size:
            _check_int32_range(name, arr)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _scope_tensor(self, scope, name):
        try:
            val = scope.find_var(name)
        except KeyError:
            raise KeyError(
                "variable %r is neither fed nor in the scope (run the "
                "startup program first?)" % name) from None
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(val)
        if isinstance(val, torch.Tensor) and val.device != self.device:
            val = val.to(self.device)
        return val


def _refuse_unported_amp(block, mesh):
    """Raise NotImplementedError for an AMP block the port cannot run:
    one that holds an ``AMP_UNPORTED`` op, or a ``ring_attention`` whose
    sp axis has size > 1 on ``mesh`` (the ring under AMP)."""
    types = {op.type[:-len("_grad")] if op.type.endswith("_grad")
             else op.type for op in block.ops}
    unported = sorted(types & set(AMP_UNPORTED))
    if unported:
        raise NotImplementedError(
            "bf16 AMP (Float16Transpiler): %s not ported under AMP (%s)"
            % (unported, "; ".join(AMP_UNPORTED[t] for t in unported)))
    if mesh is None:
        return
    for op in block.ops:
        if op.type != "ring_attention":
            continue
        axis = op.attr("sp_axis", "sp")
        if axis in mesh.axis_names and mesh.shape[axis] > 1:
            raise NotImplementedError(
                "bf16 AMP (Float16Transpiler) on a mesh whose %r axis has "
                "size %d: the ring attention's chunk kernel K9 has no bf16 "
                "form yet (ROADMAP queue 1 item 3g, the sp program under "
                "AMP)" % (axis, mesh.shape[axis]))


def _check_int32_range(name, arr):
    """The JAX package narrows int64 feeds to int32 and refuses values
    that do not fit (fluid/executor.py ``_guard_int64``).  The port keeps
    them int64 but keeps the refusal, so a program runs on the same feeds
    in both."""
    amax, amin = int(arr.max()), int(arr.min())
    if amax > _INT32_MAX or amin < _INT32_MIN:
        raise ValueError(
            "feed %r: int64 value out of the int32 range ([%d, %d] vs "
            "[-2^31, 2^31-1]); re-index ids/offsets below 2^31"
            % (name, amin, amax))


def _run_seed(program, scope):
    """Seed of this run's random ops: the program's random_seed and a
    per-scope run counter (the JAX package's ``_rng_counter``)."""
    counter = getattr(scope, "_rng_counter", 0)
    scope._rng_counter = counter + 1
    seed = getattr(program, "random_seed", 0) or 0
    return (int(seed) * 1000003 + counter) & 0x7FFFFFFFFFFFFFFF


def _free_plan(block, ops, keep):
    """{op index: names to drop after that op}: every non-persistable,
    non-fetched name is dropped after the last op that reads or writes
    it."""
    last = {}
    for i, op in enumerate(ops):
        for name in op.input_arg_names() + op.output_arg_names():
            if name:
                last[name] = i
    plan = {}
    for name, i in last.items():
        if name in keep:
            continue
        vd = block.find_var_recursive(name)
        if vd is not None and vd.persistable:
            continue
        plan.setdefault(i, []).append(name)
    return plan


def _segment(block):
    """Split ops into host prelude / device core / host postlude.

    Returns (prelude, core, postlude, mixed): ``mixed`` is True when host
    ops are interleaved with device ops."""
    ops = block.ops
    is_host = [get_op_info(op.type).host_op for op in ops]
    i = 0
    while i < len(ops) and is_host[i]:
        i += 1
    j = len(ops)
    while j > i and is_host[j - 1]:
        j -= 1
    mixed = any(is_host[i:j])
    return ops[:i], ops[i:j], ops[j:], mixed


def fetches_to_host(outs):
    """Fetch-list values -> host numpy (None passes through).  numpy has
    no bfloat16: a bf16 value (an AMP activation) comes back as float32,
    exactly; fetch with ``return_numpy=False`` to see its dtype."""
    return [_host(v) if isinstance(v, torch.Tensor)
            else (None if v is None else np.asarray(v)) for v in outs]


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
