"""Python mirror of the Program IR: Program / Block / Operator / Variable.

Counterpart of paddle_tpu/fluid/framework.py: the same front-end over
the port's pure-Python core.desc classes, with op output shapes inferred
by running the op's lowering on ``meta`` tensors
(``core.lowering.infer_op_outputs``) where the JAX package abstractly
evaluates its JAX lowering.
"""
from __future__ import annotations

import contextlib

import numpy as np

from paddle_tpu_torch.core import desc as core_desc
from paddle_tpu_torch.core.types import (VarKind, np_dtype_to_proto,
                                         proto_to_np_dtype)
from paddle_tpu_torch.core.registry import get_op_info, has_op
from paddle_tpu_torch.core import lowering
from . import unique_name

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program", "OpRole",
]


class OpRole:
    """Bit-flag op roles (reference framework/op_proto_maker.h)."""

    Forward = 0x0000
    Backward = 0x0001
    Optimize = 0x0002
    RPC = 0x0004
    Loss = 0x0100


GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


def convert_np_dtype_to_dtype_(dtype):
    return np_dtype_to_proto(dtype)


class Variable:
    """A typed symbolic value in a Block (reference framework.py:121)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 kind=None, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        if block.desc.has_var(name):
            self.desc = block.desc.var(name)
            if shape is not None and tuple(shape) != self.desc.shape:
                raise ValueError(
                    "variable %s redeclared with different shape" % name)
        else:
            if kind is None:
                kind = (VarKind.LOD_TENSOR if lod_level > 0
                        else VarKind.DENSE)
            self.desc = block.desc.add_var(core_desc.VarDesc(
                name, kind=kind,
                dtype=np_dtype_to_proto(dtype),
                shape=tuple(shape or ()),
                persistable=persistable, lod_level=lod_level,
                stop_gradient=stop_gradient))
        self.op = None  # last op writing this var

    # --- metadata ---
    @property
    def name(self):
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape)

    @shape.setter
    def shape(self, value):
        self.desc.shape = tuple(int(d) for d in value)

    @property
    def dtype(self):
        return np.dtype(proto_to_np_dtype(self.desc.dtype))

    @property
    def proto_dtype(self):
        return self.desc.dtype

    @property
    def lod_level(self):
        return self.desc.lod_level

    @property
    def persistable(self):
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v):
        self.desc.persistable = bool(v)

    @property
    def stop_gradient(self):
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v):
        self.desc.stop_gradient = bool(v)

    def set_sharding(self, spec):
        """Assign tensor dims to mesh axes, e.g. ``(None, "tp")``.
        Recorded on the ProgramDesc (no mesh of the port reads it yet)."""
        desc = self.block.program.desc
        desc.var_shardings[self.name] = tuple(spec)
        desc.bump_version()  # invalidate compiled-executable cache entries
        return self

    @property
    def sharding(self):
        return self.block.program.desc.var_shardings.get(self.name)

    def __repr__(self):
        return "<Variable %s shape=%s dtype=%s>" % (self.name, self.shape,
                                                    self.dtype)

    __str__ = __repr__

    # math_op_patch (reference layers/math_op_patch.py): operators build ops
    def _binary_op(self, other, op_type, reverse=False):
        block = self.block
        if not isinstance(other, Variable):
            from .layers.tensor import fill_constant
            if isinstance(other, (int, float)):
                other = fill_constant(shape=[1], dtype=self.dtype,
                                      value=float(other))
            else:
                raise TypeError("unsupported operand %r" % (other,))
        x, y = (other, self) if reverse else (self, other)
        out = block.create_var(dtype=x.dtype)
        block.append_op(type=op_type, inputs={"X": x, "Y": y},
                        outputs={"Out": out}, attrs={"axis": -1})
        return out

    def __add__(self, o):
        return self._binary_op(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary_op(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary_op(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary_op(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary_op(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary_op(o, "elementwise_div", reverse=True)

    def __pow__(self, o):
        return self._binary_op(o, "elementwise_pow")

    def __neg__(self):
        block = self.block
        out = block.create_var(dtype=self.dtype)
        block.append_op(type="scale", inputs={"X": self},
                        outputs={"Out": out}, attrs={"scale": -1.0})
        return out

    def _cmp_op(self, other, op_type):
        block = self.block
        if not isinstance(other, Variable):
            from .layers.tensor import fill_constant
            other = fill_constant(shape=[1], dtype=self.dtype,
                                  value=float(other))
        out = block.create_var(dtype="bool")
        block.append_op(type=op_type, inputs={"X": self, "Y": other},
                        outputs={"Out": out})
        return out

    def __lt__(self, o):
        return self._cmp_op(o, "less_than")

    def __le__(self, o):
        return self._cmp_op(o, "less_equal")

    def __gt__(self, o):
        return self._cmp_op(o, "greater_than")

    def __ge__(self, o):
        return self._cmp_op(o, "greater_equal")


class Parameter(Variable):
    """A trainable persistable Variable (reference framework.py:1272)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


class Operator:
    """Wrapper over a core OpDesc inside a Block (reference framework.py:374)."""

    def __init__(self, block, desc):
        self.block = block
        self.desc = desc

    @property
    def type(self):
        return self.desc.type

    def input(self, slot):
        return self.desc.input(slot)

    def output(self, slot):
        return self.desc.output(slot)

    @property
    def input_arg_names(self):
        return self.desc.input_arg_names()

    @property
    def output_arg_names(self):
        return self.desc.output_arg_names()

    @property
    def input_names(self):
        return list(self.desc.inputs.keys())

    @property
    def output_names(self):
        return list(self.desc.outputs.keys())

    def attr(self, name, default=None):
        return self.desc.attr(name, default)

    def set_attr(self, name, value):
        self.desc.set_attr(name, value)
        self.block.program.desc.bump_version()

    def has_attr(self, name):
        return self.desc.has_attr(name)

    @property
    def attr_names(self):
        return list(self.desc.attrs.keys())

    def __repr__(self):
        return repr(self.desc)


class Block:
    def __init__(self, program, idx, desc=None):
        self.program = program
        self.desc = desc if desc is not None else program.desc.block(idx)
        self.vars = {}  # name -> Variable
        self.ops = []   # [Operator]

    @property
    def idx(self):
        return self.desc.idx

    @property
    def parent_idx(self):
        return self.desc.parent_idx

    @property
    def parent_block(self):
        return (self.program.block(self.desc.parent_idx)
                if self.desc.parent_idx >= 0 else None)

    # --- vars ---
    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("variable %r not found in block %d" %
                             (name, self.idx))
        return v

    def _var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError("variable %r not found" % name)

    def has_var(self, name):
        return name in self.vars

    def has_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return True
            blk = blk.parent_block
        return False

    def create_var(self, **kwargs):
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        global_block = self.program.global_block()
        param = Parameter(global_block, **kwargs)
        global_block.vars[param.name] = param
        return param

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # --- ops ---
    def append_op(self, type=None, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op_desc = core_desc.OpDesc(
            type, _to_name_map(inputs), _to_name_map(outputs),
            _clean_attrs(attrs), role=self.program._current_role)
        self.desc.append_op(op_desc)
        op = Operator(self, op_desc)
        self.ops.append(op)
        if infer_shape:
            self._infer_and_set_shapes(op_desc, outputs)
        self._share_lod(inputs, outputs)
        # record producing op on output Variables
        for slot, vs in _iter_vars(outputs):
            vs.op = op
        return op

    def _share_lod(self, inputs, outputs):
        """Build-time LoD propagation (reference ShareLoD in per-op
        InferShape): outputs keeping an input's leading [N, T] layout
        inherit its lod_level; the executor propagates the runtime
        lengths the same way (core/lowering._propagate_seq_lens)."""
        src = None
        for _, v in _iter_vars(inputs):
            if isinstance(v, Variable) and v.lod_level > 0 \
                    and len(v.shape) >= 2:
                src = v
                break
        if src is None:
            return
        lead = src.shape[:2]
        for _, v in _iter_vars(outputs):
            if not isinstance(v, Variable) or v.lod_level > 0:
                continue
            shp = v.shape
            if len(shp) >= 2 and all(a == b
                                     for a, b in zip(shp[:2], lead)):
                v.desc.lod_level = src.lod_level

    def _infer_and_set_shapes(self, op_desc, outputs):
        """Run the lowering on meta tensors to set output VarDesc shapes
        (the reference's per-op C++ InferShape at build time)."""
        if not has_op(op_desc.type):
            return
        info = get_op_info(op_desc.type)
        if info.host_op or info.lower is None:
            return
        try:
            inferred = lowering.infer_op_outputs(self.program.desc, self.desc,
                                                 op_desc)
        except Exception:
            return  # shapes stay as declared; executor will catch real errors
        for name, (shape, dtype) in inferred.items():
            vd = self.desc.find_var_recursive(name)
            if vd is not None and not vd.persistable:
                vd.shape = tuple(shape)
                vd.dtype = np_dtype_to_proto(dtype)

    def prepend_op(self, type=None, inputs=None, outputs=None, attrs=None):
        op_desc = core_desc.OpDesc(
            type, _to_name_map(inputs), _to_name_map(outputs),
            _clean_attrs(attrs), role=self.program._current_role)
        self.desc.prepend_op(op_desc)
        op = Operator(self, op_desc)
        self.ops.insert(0, op)
        return op


def _iter_vars(io_map):
    for slot, v in (io_map or {}).items():
        if isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, Variable):
                    yield slot, x
        elif isinstance(v, Variable):
            yield slot, v


def _to_name_map(io_map):
    out = {}
    for slot, v in (io_map or {}).items():
        if not isinstance(v, (list, tuple)):
            v = [v]
        out[slot] = [x.name if isinstance(x, Variable) else x for x in v]
    return out


def _clean_attrs(attrs):
    out = {}
    for k, v in (attrs or {}).items():
        if v is None:
            continue
        if isinstance(v, np.dtype):
            v = int(np_dtype_to_proto(v))
        if isinstance(v, (np.integer,)):
            v = int(v)
        if isinstance(v, (np.floating,)):
            v = float(v)
        out[k] = v
    return out


class Program:
    """A whole computation: list of blocks (reference framework.py:1036)."""

    def __init__(self):
        self.desc = core_desc.ProgramDesc()
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._current_role = OpRole.Forward
        self._op_role_var = []
        self._is_test = False

    # --- seeds/roles ---
    @property
    def random_seed(self):
        return self.desc.random_seed

    @random_seed.setter
    def random_seed(self, seed):
        self.desc.random_seed = int(seed)

    @contextlib.contextmanager
    def optimized_guard(self, param_and_grads):
        old = self._current_role
        self._current_role = OpRole.Optimize
        try:
            yield
        finally:
            self._current_role = old

    @contextlib.contextmanager
    def _backward_role_guard(self):
        old = self._current_role
        self._current_role = OpRole.Backward
        try:
            yield
        finally:
            self._current_role = old

    # --- blocks ---
    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        new_desc = self.desc.append_block(
            parent_idx if parent_idx is not None else self.current_block_idx)
        blk = Block(self, new_desc.idx, new_desc)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    # --- introspection ---
    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def all_parameters(self):
        return self.global_block().all_parameters()

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append("block %d (parent %d):" % (blk.idx, blk.parent_idx))
            for v in blk.desc.vars.values():
                lines.append("  " + repr(v))
            for op in blk.desc.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = __repr__

    # --- clone / prune ---
    def clone(self, for_test=False):
        """Deep copy; for_test=True strips backward/optimize ops and flips
        is_test attrs (reference Program.clone)."""
        p = Program()
        p.desc = core_desc.ProgramDesc.parse_from_string(
            self.desc.serialize_to_string())
        p.desc.random_seed = self.desc.random_seed  # not in the proto
        if for_test:
            for blk in p.desc.blocks:
                kept = []
                for op in blk.ops:
                    if op.role & (OpRole.Backward | OpRole.Optimize):
                        continue
                    if op.has_attr("is_test"):
                        op.set_attr("is_test", True)
                    kept.append(op)
                blk.ops = kept
            p.desc.bump_version()
            p._is_test = True
        p._rebuild_from_desc(self)
        return p

    def _rebuild_from_desc(self, src_program=None):
        src_params = set()
        if src_program is not None:
            for v in src_program.list_vars():
                if isinstance(v, Parameter):
                    src_params.add(v.name)
        self.blocks = []
        for bdesc in self.desc.blocks:
            blk = Block(self, bdesc.idx, bdesc)
            for name, vd in bdesc.vars.items():
                var = object.__new__(
                    Parameter if name in src_params else Variable)
                if name in src_params:
                    src = src_program.global_block().vars.get(name)
                    var.trainable = getattr(src, "trainable", True)
                    var.optimize_attr = getattr(src, "optimize_attr",
                                                {"learning_rate": 1.0})
                    var.regularizer = getattr(src, "regularizer", None)
                    var.gradient_clip_attr = getattr(
                        src, "gradient_clip_attr", None)
                    var.do_model_average = getattr(src, "do_model_average",
                                                   None)
                var.block = blk
                var.desc = vd
                var.op = None
                blk.vars[name] = var
            for op_desc in bdesc.ops:
                blk.ops.append(Operator(blk, op_desc))
            self.blocks.append(blk)
        self.current_block_idx = 0

    @staticmethod
    def parse_from_string(binary):
        p = Program()
        p.desc = core_desc.ProgramDesc.parse_from_string(binary)
        p._rebuild_from_desc()
        return p

    def serialize_to_string(self):
        return self.desc.serialize_to_string()

    def prune(self, targets):
        """Keep only ops needed to compute `targets` (reference Program.prune
        used by save_inference_model)."""
        target_names = set()
        for t in targets:
            target_names.add(t.name if isinstance(t, Variable) else t)
        blk = self.desc.blocks[0]
        needed = set(target_names)
        kept = []
        for op in reversed(blk.ops):
            if any(n in needed for n in op.output_arg_names()):
                kept.append(op)
                needed.update(n for n in op.input_arg_names() if n)
        kept.reverse()
        p = self.clone()
        blk0 = p.desc.blocks[0]
        blk0.ops = [core_desc.OpDesc.from_proto(op.to_proto())
                    for op in kept]
        for op in blk0.ops:
            op._block = blk0  # mutations must keep bumping the version
        p.desc.bump_version()
        p._rebuild_from_desc(self)
        return p


# --- default programs & guards (reference framework.py bottom) ---

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
