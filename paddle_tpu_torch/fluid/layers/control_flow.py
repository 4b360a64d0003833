"""Control-flow layers: While / StaticRNN / DynamicRNN / IfElse / Switch /
ConditionalBlock, the compare and logical layers and the LoDTensorArray
op family.

Counterpart of ``paddle_tpu/fluid/layers/control_flow.py``, builder for
builder, so a program serializes to the same bytes in both packages:

- StaticRNN / DynamicRNN build a sub-block and emit one ``recurrent``
  op (``ops/control_flow.py``: a Python loop over the padded time axis,
  masked past each row's '@LEN' for DynamicRNN, differentiated by
  replaying it under autograd).  Sequences are batch-major padded
  ``[N, T, ...]``, so DynamicRNN needs no length-descending reorder and
  ``memory(need_reorder=True)`` is a no-op.
- While emits a ``while`` op: the loop-carried values are the outer
  vars the body writes, the read-only outer vars are its Params.  Not
  differentiable: train recurrence with StaticRNN / DynamicRNN.
- IfElse computes both branches over the whole batch and merges them
  row-wise (split / merge_lod_tensor as a mask select).
"""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper
from .. import unique_name
from .tensor import fill_constant_batch_size_like
from paddle_tpu_torch.core.types import np_dtype_to_proto

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "IfElse", "Switch",
    "ConditionalBlock", "BlockGuard", "increment", "is_empty",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "array_write", "array_read", "array_length",
    "create_array", "lod_rank_table", "max_sequence_len",
    "lod_tensor_to_array", "array_to_lod_tensor", "shrink_memory",
    "reorder_lod_tensor_by_rank", "split_lod_tensor", "merge_lod_tensor",
    "Print", "logical_and", "logical_or", "logical_xor", "logical_not",
]


def _logical_op(op_type, x, y=None, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_tmp_variable(dtype="bool")
        out.stop_gradient = True
    inputs = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical_op("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _logical_op("logical_or", x, y, out)


def logical_xor(x, y, out=None, name=None):
    return _logical_op("logical_xor", x, y, out)


def logical_not(x, out=None, name=None):
    return _logical_op("logical_not", x, out=out)


class BlockGuard:
    """``with``-guard that pushes a new sub-block on the program
    (reference control_flow.py BlockGuard)."""

    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program.rollback()
        return False


def _collect_outer_io(sub_block, bound_names=()):
    """Names a sub-block reads from / writes to enclosing blocks.

    ``bound_names`` are locally bound slots (step inputs, states) that do
    not count as outer reads.  Returns (reads, writes) in first-touch
    order; reads exclude names previously written inside the block.
    """
    parent = sub_block.parent_block
    local = set(bound_names)
    reads, writes = [], []
    seen_r, seen_w = set(), set()
    for op in sub_block.ops:
        for n in op.desc.input_arg_names():
            if not n or n in local or n in seen_r or n in seen_w:
                continue
            if parent is not None and parent.has_var_recursive(n):
                seen_r.add(n)
                reads.append(n)
            # else: local temp created by an earlier layer call
        for n in op.desc.output_arg_names():
            if not n or n in local:
                continue
            local_def = sub_block.has_var(n)
            if not local_def and parent is not None \
                    and parent.has_var_recursive(n) and n not in seen_w:
                seen_w.add(n)
                writes.append(n)
    return reads, writes


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While:
    """``while cond:`` over a sub-block (reference control_flow.py:608).

    The body must re-write ``cond`` (e.g. via ``less_than(..., cond=cond)``)
    and may update outer vars in place (``assign``, ``increment``,
    ``array_write`` with an explicit array).  Loop-carried state = the
    outer vars the body writes.
    """

    def __init__(self, cond, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("While condition must be a Variable")
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond

    def block(self):
        return WhileGuard(self)

    def _complete(self, sub_block):
        parent = sub_block.parent_block
        reads, writes = _collect_outer_io(sub_block)
        cond_name = self.cond_var.name
        carried = [n for n in writes if n != cond_name]
        params = [n for n in reads
                  if n not in set(carried) and n != cond_name]
        parent.append_op(
            type="while",
            inputs={"Condition": [cond_name], "X": carried,
                    "Params": params},
            # the final condition value is written back so post-loop
            # reads of cond see False, not the stale pre-loop value
            outputs={"Out": carried, "CondOut": [cond_name]},
            attrs={"sub_block": sub_block.idx},
            infer_shape=False)


class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        super().__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __exit__(self, exc_type, exc_val, exc_tb):
        sub_block = self.main_program.current_block()
        ret = super().__exit__(exc_type, exc_val, exc_tb)
        if exc_type is None:
            self.while_op._complete(sub_block)
        return ret


# ---------------------------------------------------------------------------
# StaticRNN / DynamicRNN -> one `recurrent` op
# ---------------------------------------------------------------------------

class _MemoryCell:
    __slots__ = ("init_name", "in_var", "out_name")

    def __init__(self, init_name, in_var):
        self.init_name = init_name
        self.in_var = in_var
        self.out_name = None


class _RNNBase:
    """Shared builder: collect step inputs / memories / outputs inside a
    sub-block, then emit one ``recurrent`` op in the parent block."""

    _masked = False
    _layer_type = "rnn"

    def __init__(self, name=None):
        self.helper = LayerHelper(self._layer_type, name=name)
        self.sub_block = None
        self._seq_srcs = []        # outer [N, T, ...] vars
        self._step_vars = []       # in-block per-step vars
        self._memories = []        # [_MemoryCell]
        self._outputs = []         # in-block step-output vars
        self._final_vars = None
        self._out_vars = None
        self._reverse = False
        self._status = "before"

    # -- with-block plumbing --
    def _guard(self):
        return _RNNGuard(self)

    def _in_rnn_block(self):
        if self._status != "in":
            raise RuntimeError(
                "%s: call inside the rnn block" % self._layer_type)

    def step_input(self, x):
        """Declare an outer sequence var [N, T, ...]; returns the per-step
        slice [N, ...] visible inside the block."""
        self._in_rnn_block()
        if not isinstance(x, Variable):
            raise TypeError("step_input expects a Variable")
        shape = list(x.shape)
        step_shape = shape[:1] + shape[2:]
        ipt = self.sub_block.create_var(
            name=unique_name.generate("%s.step_in" % self.helper.name),
            dtype=x.dtype, shape=step_shape)
        self._seq_srcs.append(x)
        self._step_vars.append(ipt)
        return ipt

    def static_input(self, x):
        """A var read whole (not sliced) every step; outer reads are closed
        over automatically, so this is the identity."""
        self._in_rnn_block()
        return x

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1,
               need_reorder=False, dtype="float32"):
        """A loop-carried state.  ``init``: initial value var; or
        ``shape``(+ optional batch_ref / first step input) to boot a
        constant-filled state.  need_reorder is a no-op: padded batches
        keep their order (see module docstring)."""
        self._in_rnn_block()
        parent = self.sub_block.parent_block
        if init is None:
            if shape is None:
                raise ValueError("memory needs init= or shape=")
            ref = batch_ref if batch_ref is not None else (
                self._seq_srcs[0] if self._seq_srcs else None)
            if ref is None:
                raise ValueError(
                    "memory(shape=...) needs batch_ref or a prior "
                    "step_input to size the batch dim")
            # boot var in the PARENT block, filled to [N] + shape
            cur_idx = self.helper.main_program.current_block_idx
            self.helper.main_program.current_block_idx = parent.idx
            try:
                init = fill_constant_batch_size_like(
                    input=ref, shape=[1] + list(shape), dtype=dtype,
                    value=float(init_value), input_dim_idx=0,
                    output_dim_idx=0)
            finally:
                self.helper.main_program.current_block_idx = cur_idx
        mem = self.sub_block.create_var(
            name=unique_name.generate("%s.mem" % self.helper.name),
            dtype=init.dtype, shape=init.shape)
        self._memories.append(_MemoryCell(init.name, mem))
        return mem

    def update_memory(self, mem, var):
        self._in_rnn_block()
        for cell in self._memories:
            if cell.in_var.name == mem.name:
                cell.out_name = var.name
                return
        raise ValueError("update_memory: %r is not a memory" % mem.name)

    def step_output(self, o):
        self._in_rnn_block()
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self, *args, **kwargs):
        if self._status != "after":
            raise RuntimeError("rnn outputs are available after the block")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars

    @property
    def final_states(self):
        if self._status != "after":
            raise RuntimeError("final states are available after the block")
        return self._final_vars

    # -- completion --
    def _complete(self):
        if not self._seq_srcs:
            raise ValueError("%s needs at least one step_input"
                             % self._layer_type)
        for cell in self._memories:
            if cell.out_name is None:
                raise ValueError("memory %r never updated (call "
                                 "update_memory)" % cell.in_var.name)
        sub = self.sub_block
        parent = sub.parent_block
        bound = ([v.name for v in self._step_vars]
                 + [c.in_var.name for c in self._memories])
        reads, _ = _collect_outer_io(sub, bound_names=bound)
        init_names = [c.init_name for c in self._memories]
        params = [n for n in reads if n not in set(init_names)]

        n_dim = self._seq_srcs[0].shape[0]
        t_dim = self._seq_srcs[0].shape[1]
        out_vars = []
        for o in self._outputs:
            ov = parent.create_var(
                name=unique_name.generate("%s.out" % self.helper.name),
                dtype=o.dtype, shape=[n_dim, t_dim] + list(o.shape[1:]),
                lod_level=self._seq_srcs[0].lod_level)
            out_vars.append(ov)
        final_vars = []
        for c in self._memories:
            fv = parent.create_var(
                name=unique_name.generate("%s.final" % self.helper.name),
                dtype=c.in_var.dtype, shape=list(c.in_var.shape))
            final_vars.append(fv)

        attrs = {
            "sub_block": sub.idx,
            "step_input_names": [v.name for v in self._step_vars],
            "state_in_names": [c.in_var.name for c in self._memories],
            "state_out_names": [c.out_name for c in self._memories],
            "step_output_names": [o.name for o in self._outputs],
            "masked": self._masked,
            "reverse": self._reverse,
        }
        attrs = {k: v for k, v in attrs.items()
                 if not (isinstance(v, list) and not v)}
        parent.append_op(
            type="recurrent",
            inputs={"Inputs": [v.name for v in self._seq_srcs],
                    "InitStates": init_names,
                    "Parameters": params},
            outputs={"Outputs": [v.name for v in out_vars],
                     "FinalStates": [v.name for v in final_vars]},
            attrs=attrs, infer_shape=False)
        self._out_vars = out_vars
        self._final_vars = final_vars


class _RNNGuard(BlockGuard):
    def __init__(self, rnn):
        super().__init__(rnn.helper.main_program)
        self.rnn = rnn

    def __enter__(self):
        super().__enter__()
        self.rnn.sub_block = self.main_program.current_block()
        self.rnn._status = "in"
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        ret = super().__exit__(exc_type, exc_val, exc_tb)
        self.rnn._status = "after"
        if exc_type is None:
            self.rnn._complete()
        return ret


class StaticRNN(_RNNBase):
    """Fixed-length RNN over padded [N, T, ...] sequences (reference
    control_flow.py:383; time axis = dim 1 here, not dim 0 — padded
    batch-major layout).  Usage::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)           # [N, D] slice of [N, T, D]
            h = rnn.memory(shape=[H], batch_ref=x)
            h_new = layers.fc(input=[x_t, h], size=H, act='tanh')
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        out = rnn()                            # [N, T, H]
    """

    _layer_type = "static_rnn"
    _masked = False

    def step(self):
        return self._guard()


class DynamicRNN(_RNNBase):
    """Variable-length RNN (reference control_flow.py:1313): the same
    ``recurrent`` backend as StaticRNN with per-sequence masking — state freezes and
    outputs zero past each row's '@LEN' length, replacing the reference's
    lod_rank_table + batch-shrinking while-loop machinery."""

    _layer_type = "dynamic_rnn"
    _masked = True

    def block(self):
        return self._guard()

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32", batch_ref=None, init_value=None):
        """DynamicRNN's parameter order (reference control_flow.py:1460:
        memory(init, shape, value, need_reorder, dtype)) — positional
        calls ported from the reference bind correctly.  The StaticRNN
        spellings (batch_ref=, init_value=) stay accepted as keywords."""
        return super().memory(
            init=init, shape=shape, batch_ref=batch_ref,
            init_value=value if init_value is None else init_value,
            need_reorder=need_reorder, dtype=dtype)


# ---------------------------------------------------------------------------
# ConditionalBlock / Switch / IfElse
# ---------------------------------------------------------------------------

class ConditionalBlock:
    """Run a sub-block when a scalar bool cond holds (reference
    control_flow.py:1065 over conditional_block_op.cc; the host reads
    the condition)."""

    def __init__(self, inputs, name=None):
        for x in inputs:
            if not isinstance(x, Variable):
                raise TypeError("ConditionalBlock inputs must be Variables")
        self.cond_vars = inputs
        self.helper = LayerHelper("conditional_block", name=name)

    def block(self):
        return ConditionalBlockGuard(self)

    def _complete(self, sub_block):
        parent = sub_block.parent_block
        cond_names = {v.name for v in self.cond_vars}
        reads, writes = _collect_outer_io(sub_block)
        in_names = [n for n in reads if n not in cond_names]
        parent.append_op(
            type="conditional_block",
            inputs={"Cond": [v.name for v in self.cond_vars],
                    "Input": in_names},
            outputs={"Out": writes},
            attrs={"sub_block": sub_block.idx},
            infer_shape=False)


class ConditionalBlockGuard(BlockGuard):
    def __init__(self, cond_block):
        super().__init__(cond_block.helper.main_program)
        self.cond_block = cond_block

    def __exit__(self, exc_type, exc_val, exc_tb):
        sub_block = self.main_program.current_block()
        ret = super().__exit__(exc_type, exc_val, exc_tb)
        if exc_type is None:
            self.cond_block._complete(sub_block)
        return ret


class Switch:
    """First-match case dispatch on scalar bool conds (reference
    control_flow.py:1122), e.g. piecewise learning-rate schedules.  Each
    case body runs in a ConditionalBlock gated on
    ``cond AND not any-earlier-match``."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._matched = None   # bool var: any earlier case hit

    def case(self, condition):
        if self._matched is None:
            eff = condition
            self._matched = condition
        else:
            eff = logical_and(x=condition,
                              y=logical_not(x=self._matched))
            self._matched = logical_or(x=self._matched, y=condition)
        return ConditionalBlock([eff]).block()

    def default(self):
        if self._matched is None:
            raise ValueError("default() needs at least one prior case()")
        return ConditionalBlock([logical_not(x=self._matched)]).block()


class IfElse:
    """Per-row branch on a [N, 1] bool cond (reference control_flow.py:1211).

    Both branches are computed over the full batch and merged row-wise
    with ``merge_lod_tensor`` (mask-select): branch ops are appended to
    the enclosing block, not hidden sub-blocks, as in the JAX package.
    Results match the reference for row-wise branch computations.
    """

    OUT_IF_ELSE_BLOCKS = 2
    IN_IF_ELSE_TRUE_BLOCKS = 0
    IN_IF_ELSE_FALSE_BLOCKS = 1

    def __init__(self, cond, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("IfElse cond must be a Variable")
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self._outputs = {True: [], False: []}

    class _BranchGuard:
        def __init__(self, ie, is_true):
            self.ie = ie
            self.is_true = is_true

        def __enter__(self):
            self.ie.status = (IfElse.IN_IF_ELSE_TRUE_BLOCKS if self.is_true
                              else IfElse.IN_IF_ELSE_FALSE_BLOCKS)
            return self

        def __exit__(self, exc_type, exc_val, exc_tb):
            self.ie.status = IfElse.OUT_IF_ELSE_BLOCKS
            return False

    def true_block(self):
        return IfElse._BranchGuard(self, True)

    def false_block(self):
        return IfElse._BranchGuard(self, False)

    def input(self, x):
        """The branch's view of x — the full batch (see class docstring)."""
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise RuntimeError("IfElse.input used outside a branch block")
        out_true, out_false = split_lod_tensor(input=x, mask=self.cond)
        return (out_true if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
                else out_false)

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise RuntimeError("IfElse.output used outside a branch block")
        branch = self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
        self._outputs[branch].extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise RuntimeError("IfElse() must be called outside the blocks")
        t, f = self._outputs[True], self._outputs[False]
        if len(t) != len(f):
            raise ValueError(
                "true/false branches declared %d vs %d outputs; both "
                "branches must declare the same outputs" % (len(t), len(f)))
        merged = [merge_lod_tensor(in_true=tv, in_false=fv, x=tv,
                                   mask=self.cond)
                  for tv, fv in zip(t, f)]
        return merged[0] if len(merged) == 1 else merged


# ---------------------------------------------------------------------------
# function-form ops used by loop bodies
# ---------------------------------------------------------------------------

def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def _cmp_layer(op_type, x, y, cond):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    return _cmp_layer("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp_layer("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp_layer("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp_layer("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp_layer("not_equal", x, y, cond)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


# ---------------------------------------------------------------------------
# TensorArray front-end (reference LoDTensorArray layers)
# ---------------------------------------------------------------------------

def create_array(dtype, element_shape=None, capacity=64):
    """An empty TensorArray var.  With ``element_shape`` the device buffer
    is preallocated (the JAX package requires it when the first
    ``array_write`` happens inside a While body); without it the first
    write sizes the buffer."""
    helper = LayerHelper("create_array")
    out = helper.create_tmp_variable(dtype=dtype)
    out.stop_gradient = True
    attrs = {"dtype": int(np_dtype_to_proto(dtype)),
             "capacity": int(capacity)}
    if element_shape is not None:
        attrs["element_shape"] = [int(d) for d in element_shape]
        # record it on the var too so array_read's shape propagation
        # works when the first write happens inside a While body
        out.desc.shape = tuple(int(d) for d in element_shape)
    helper.append_op(type="create_array", outputs={"Out": [out]},
                     attrs=attrs)
    return out


def array_write(x, i, array=None, capacity=64):
    helper = LayerHelper("array_write")
    if array is None:
        array = helper.create_tmp_variable(dtype=x.dtype)
        array.stop_gradient = True
        inputs = {"X": [x], "I": [i]}
    else:
        inputs = {"X": [x], "I": [i], "Array": [array]}
    helper.append_op(type="write_to_array", inputs=inputs,
                     outputs={"Out": [array]},
                     attrs={"capacity": int(capacity)})
    # record the element shape on the ARRAY var: abstract shape
    # inference cannot evaluate the runtime TensorArray, so array_read
    # (possibly in another block) copies this — without it an fc on a
    # read value sees shape () and mis-sizes its parameter
    if x.shape and array.desc is not None:
        array.desc.shape = tuple(x.shape)
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(dtype=array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    # element shape recorded by array_write / create_array
    if array.shape:
        out.desc.shape = tuple(array.shape)
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable(dtype="int64")
    out.stop_gradient = True
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def lod_rank_table(x, level=0):
    """[N] sequence-length vector of a padded LoD var (reference builds a
    length-sorted rank table; padded batches keep their order)."""
    helper = LayerHelper("lod_rank_table")
    table = helper.create_tmp_variable(dtype="int32")
    table.stop_gradient = True
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_tmp_variable(dtype="int64")
    out.stop_gradient = True
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    array = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def shrink_memory(x, i, table):
    """Identity in the padded world: the recurrent op's mask freezes rows
    instead of shrinking the batch (reference shrink_rnn_memory_op.cc)."""
    helper = LayerHelper("shrink_memory")
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def split_lod_tensor(input, mask, level=0):
    helper = LayerHelper("split_lod_tensor")
    out_true = helper.create_tmp_variable(dtype=input.dtype)
    out_false = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="split_lod_tensor",
                     inputs={"X": [input], "Mask": [mask]},
                     outputs={"OutTrue": [out_true],
                              "OutFalse": [out_false]},
                     attrs={"level": level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_tmp_variable(dtype=in_true.dtype)
    helper.append_op(type="merge_lod_tensor",
                     inputs={"X": [x], "Mask": [mask],
                             "InTrue": [in_true], "InFalse": [in_false]},
                     outputs={"Out": [out]}, attrs={"level": level})
    return out


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """In-graph tensor printing (a host op, ``ops/io_ops.py``): after the
    block's device ops it runs in the postlude; between two device ops
    it makes the executor run the block op by op; inside a sub-block it
    is skipped."""
    helper = LayerHelper("print")
    helper.append_op(
        type="print", inputs={"In": [input]}, outputs={},
        attrs={"first_n": first_n, "message": message or "",
               "summarize": summarize,
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_phase": print_phase})
    return input
