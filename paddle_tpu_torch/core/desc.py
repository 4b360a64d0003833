"""Program IR descriptor classes.

Counterpart of ``paddle_tpu/core/desc.py``: the same plain-Python
ProgramDesc / BlockDesc / OpDesc / VarDesc with loss-free
(de)serialization to the ``torch_framework.proto`` schema, whose field
numbers are those of the JAX package's, so a program serializes to the
same bytes in both.  The schema module (and with it protobuf) is
imported only by the (de)serialization methods.

A monotonically increasing ``version`` on ProgramDesc is bumped on every
mutation, as in the JAX package (it is part of the serialized desc).
"""
from __future__ import annotations

from .types import DataType, VarKind

# Attribute type tags (the proto's AttrType values).
AT_INT = 1
AT_FLOAT = 2
AT_STRING = 3
AT_INTS = 4
AT_FLOATS = 5
AT_STRINGS = 6
AT_BOOL = 7
AT_BOOLS = 8
AT_BLOCK = 9
AT_BLOCKS = 10
AT_LONG = 11


def _pb():
    from paddle_tpu_torch.proto import torch_framework_pb2

    return torch_framework_pb2


class Attr:
    __slots__ = ("name", "type", "value")

    def __init__(self, name, type_, value):
        self.name = name
        self.type = type_
        self.value = value

    @staticmethod
    def infer(name, value):
        """Build an Attr inferring the tag from the Python value."""
        if isinstance(value, bool):
            return Attr(name, AT_BOOL, value)
        if isinstance(value, int):
            return Attr(name, AT_INT, value)
        if isinstance(value, float):
            return Attr(name, AT_FLOAT, value)
        if isinstance(value, str):
            return Attr(name, AT_STRING, value)
        if isinstance(value, BlockRef):
            return Attr(name, AT_BLOCK, value)
        if isinstance(value, (list, tuple)):
            seq = list(value)
            if seq and isinstance(seq[0], BlockRef):
                return Attr(name, AT_BLOCKS, seq)
            if seq and isinstance(seq[0], bool):
                return Attr(name, AT_BOOLS, seq)
            if seq and isinstance(seq[0], float):
                return Attr(name, AT_FLOATS, [float(v) for v in seq])
            if seq and isinstance(seq[0], str):
                return Attr(name, AT_STRINGS, seq)
            # default (incl. empty list): ints
            return Attr(name, AT_INTS, [int(v) for v in seq])
        raise TypeError(
            "unsupported attr %r = %r (%s)" % (name, value, type(value)))


class BlockRef:
    """Reference to a sub-block by index (control-flow op attrs)."""

    __slots__ = ("idx",)

    def __init__(self, idx):
        self.idx = int(idx)

    def __repr__(self):
        return "BlockRef(%d)" % self.idx


class OpSlotError(KeyError):
    """Missing input/output slot, with the op context in the message
    (a bare KeyError("X") tells the user nothing about WHICH op or what
    slots it does have)."""

    def __str__(self):
        return self.args[0]


_MISSING = object()


class OpDesc:
    """One operator: type + named input/output slots + attrs.

    Slots map parameter name -> list of variable names, as in reference
    OpDesc (framework.proto:34).

    Once attached to a block (append/prepend/insert), every mutator —
    ``set_attr``, ``rename_input``, ``rename_output`` — bumps the owning
    program's version, so the executor's prepared/compile caches (keyed
    on uid+version) can never serve an executable for a program a
    transpiler has since rewritten.
    """

    __slots__ = ("type", "inputs", "outputs", "attrs", "role", "_block")

    def __init__(self, type_, inputs=None, outputs=None, attrs=None, role=0):
        self._block = None   # set when attached to a BlockDesc
        self.type = type_
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = {}
        for k, v in (attrs or {}).items():
            self.set_attr(k, v)
        self.role = role

    def _mutated(self):
        blk = self._block
        if blk is not None:
            blk.program.bump_version()

    # --- attrs ---
    def set_attr(self, name, value):
        if isinstance(value, Attr):
            self.attrs[name] = value
        else:
            self.attrs[name] = Attr.infer(name, value)
        self._mutated()

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value

    def has_attr(self, name):
        return name in self.attrs

    # --- io ---
    def input(self, slot, default=_MISSING):
        try:
            return self.inputs[slot]
        except KeyError:
            if default is not _MISSING:
                return default
            raise OpSlotError(
                "op %r has no input slot %r (available input slots: %s; "
                "output slots: %s)" % (self.type, slot,
                                       sorted(self.inputs) or "none",
                                       sorted(self.outputs) or "none")) \
                from None

    def output(self, slot, default=_MISSING):
        try:
            return self.outputs[slot]
        except KeyError:
            if default is not _MISSING:
                return default
            raise OpSlotError(
                "op %r has no output slot %r (available output slots: "
                "%s; input slots: %s)" % (self.type, slot,
                                          sorted(self.outputs) or "none",
                                          sorted(self.inputs) or "none")) \
                from None

    def input_arg_names(self):
        return [n for args in self.inputs.values() for n in args]

    def output_arg_names(self):
        return [n for args in self.outputs.values() for n in args]

    def rename_input(self, old, new):
        changed = False
        for args in self.inputs.values():
            for i, n in enumerate(args):
                if n == old:
                    args[i] = new
                    changed = True
        if changed:
            self._mutated()

    def rename_output(self, old, new):
        changed = False
        for args in self.outputs.values():
            for i, n in enumerate(args):
                if n == old:
                    args[i] = new
                    changed = True
        if changed:
            self._mutated()

    def __repr__(self):
        return "<op %s %s -> %s>" % (self.type, dict(self.inputs),
                                     dict(self.outputs))

    # --- proto ---
    def to_proto(self):
        p = _pb().OpDesc(type=self.type, role=self.role)
        for k in sorted(self.inputs):
            p.inputs.add(parameter=k, arguments=self.inputs[k])
        for k in sorted(self.outputs):
            p.outputs.add(parameter=k, arguments=self.outputs[k])
        for k in sorted(self.attrs):
            a = self.attrs[k]
            ap = p.attrs.add(name=a.name, type=a.type)
            t, v = a.type, a.value
            if t == AT_INT or t == AT_LONG:
                ap.i = int(v)
            elif t == AT_FLOAT:
                ap.f = float(v)
            elif t == AT_STRING:
                ap.s = v
            elif t == AT_BOOL:
                ap.b = bool(v)
            elif t == AT_INTS:
                ap.ints.extend(int(x) for x in v)
            elif t == AT_FLOATS:
                ap.floats.extend(float(x) for x in v)
            elif t == AT_STRINGS:
                ap.strings.extend(v)
            elif t == AT_BOOLS:
                ap.bools.extend(bool(x) for x in v)
            elif t == AT_BLOCK:
                ap.block_idx = v.idx
            elif t == AT_BLOCKS:
                ap.blocks_idx.extend(b.idx for b in v)
        return p

    @staticmethod
    def from_proto(p):
        op = OpDesc(p.type, role=p.role)
        for s in p.inputs:
            op.inputs[s.parameter] = list(s.arguments)
        for s in p.outputs:
            op.outputs[s.parameter] = list(s.arguments)
        for ap in p.attrs:
            t = ap.type
            if t in (AT_INT, AT_LONG):
                v = ap.i
            elif t == AT_FLOAT:
                v = ap.f
            elif t == AT_STRING:
                v = ap.s
            elif t == AT_BOOL:
                v = ap.b
            elif t == AT_INTS:
                v = list(ap.ints)
            elif t == AT_FLOATS:
                v = list(ap.floats)
            elif t == AT_STRINGS:
                v = list(ap.strings)
            elif t == AT_BOOLS:
                v = list(ap.bools)
            elif t == AT_BLOCK:
                v = BlockRef(ap.block_idx)
            elif t == AT_BLOCKS:
                v = [BlockRef(i) for i in ap.blocks_idx]
            else:
                continue
            op.attrs[ap.name] = Attr(ap.name, t, v)
        return op


class VarDesc:
    __slots__ = ("name", "kind", "dtype", "shape", "persistable", "lod_level",
                 "stop_gradient")

    def __init__(self, name, kind=VarKind.DENSE, dtype=DataType.FP32,
                 shape=(), persistable=False, lod_level=0,
                 stop_gradient=False):
        self.name = name
        self.kind = kind
        self.dtype = dtype
        self.shape = tuple(int(d) for d in shape)
        self.persistable = persistable
        self.lod_level = lod_level
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return "<var %s %s %s%s>" % (self.name, self.shape, self.dtype,
                                     " persistable" if self.persistable else "")

    def to_proto(self):
        return _pb().VarDesc(
            name=self.name, kind=self.kind, dtype=self.dtype,
            dims=list(self.shape), persistable=self.persistable,
            lod_level=self.lod_level, stop_gradient=self.stop_gradient)

    @staticmethod
    def from_proto(p):
        return VarDesc(p.name, p.kind, p.dtype, tuple(p.dims), p.persistable,
                       p.lod_level, p.stop_gradient)


class BlockDesc:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars = {}   # name -> VarDesc
        self.ops = []    # [OpDesc]

    # --- vars ---
    def var(self, name):
        return self.vars[name]

    def has_var(self, name):
        return name in self.vars

    def find_var_recursive(self, name):
        """Look up a var here or in ancestor blocks (reference Scope-like
        resolution used at program-build time)."""
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (self.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        return None

    def add_var(self, desc):
        self.vars[desc.name] = desc
        self.program.bump_version()
        return desc

    # --- ops ---
    def append_op(self, op_desc):
        self.ops.append(op_desc)
        op_desc._block = self
        self.program.bump_version()
        return op_desc

    def prepend_op(self, op_desc):
        self.ops.insert(0, op_desc)
        op_desc._block = self
        self.program.bump_version()
        return op_desc

    def insert_op(self, index, op_desc):
        self.ops.insert(index, op_desc)
        op_desc._block = self
        self.program.bump_version()
        return op_desc

    def remove_op(self, start, end):
        del self.ops[start:end]
        self.program.bump_version()

    def to_proto(self):
        p = _pb().BlockDesc(idx=self.idx, parent_idx=self.parent_idx,
                         forward_block_idx=self.forward_block_idx)
        for name in sorted(self.vars):
            p.vars.append(self.vars[name].to_proto())
        for op in self.ops:
            p.ops.append(op.to_proto())
        return p


_prog_uid = [0]


class ProgramDesc:
    def __init__(self):
        self.blocks = [BlockDesc(self, 0, -1)]
        self.version = 0
        _prog_uid[0] += 1
        self.uid = _prog_uid[0]
        self.random_seed = 0
        # name -> per-dim mesh-axis tuple (e.g. (None, "tp")); carried in
        # the desc for parity, no mesh consumes it in the port yet
        self.var_shardings = {}
        # bf16 mixed precision (Float16Transpiler): the lowering's
        # autocast reads it (core/lowering.amp_cast_ins)
        self.amp_bf16 = False

    def bump_version(self):
        self.version += 1

    def block(self, idx):
        return self.blocks[idx]

    def append_block(self, parent_idx):
        blk = BlockDesc(self, len(self.blocks), parent_idx)
        self.blocks.append(blk)
        self.bump_version()
        return blk

    def num_blocks(self):
        return len(self.blocks)

    def to_proto(self):
        p = _pb().ProgramDesc(version=self.version, amp_bf16=self.amp_bf16)
        for blk in self.blocks:
            p.blocks.append(blk.to_proto())
        for name in sorted(self.var_shardings):
            spec = self.var_shardings[name]
            p.var_shardings.add(
                var=name, axes=["" if a is None else a for a in spec])
        return p

    def serialize_to_string(self):
        return self.to_proto().SerializeToString()

    @staticmethod
    def parse_from_string(data):
        p = _pb().ProgramDesc()
        p.ParseFromString(data)
        prog = ProgramDesc()
        prog.blocks = []
        for bp in p.blocks:
            blk = BlockDesc(prog, bp.idx, bp.parent_idx)
            blk.forward_block_idx = bp.forward_block_idx
            for vp in bp.vars:
                blk.vars[vp.name] = VarDesc.from_proto(vp)
            for op_p in bp.ops:
                op = OpDesc.from_proto(op_p)
                op._block = blk
                blk.ops.append(op)
            prog.blocks.append(blk)
        if not prog.blocks:
            prog.blocks = [BlockDesc(prog, 0, -1)]
        prog.version = p.version
        prog.amp_bf16 = p.amp_bf16
        prog.var_shardings = {
            vs.var: tuple(a if a else None for a in vs.axes)
            for vs in p.var_shardings}
        return prog
