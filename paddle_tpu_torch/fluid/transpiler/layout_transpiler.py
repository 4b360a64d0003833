"""NHWC layout transpiler: pin the convnet pipeline in the conv-stage
kernel's layout at the IR level.

Counterpart of ``paddle_tpu/fluid/transpiler/layout_transpiler.py``,
rule for rule, over the port's desc classes and ``pass_framework.DefUse``
(so both packages rewrite a program to the same bytes).  It rewrites the
PROGRAM once, before backward generation:

- ``NHWCLayoutPass`` propagates NHWC through the image domain —
  conv/pool/bn and the elementwise chains between them — rewriting
  VarDescs to NHWC and attaching ``data_format`` attrs.  Boundary
  transposes are inserted only where the image domain meets
  layout-fixed code (the NCHW feed contract, fc flattens): one
  transpose per program edge.  ``cast`` and ``scale`` are elementwise,
  so with a uint8 feed the boundary transpose lands on the uint8 image.
- Convolution weights are **pinned HWIO at creation**: the parameter's
  VarDesc, its startup-program initializer and any live scope value are
  rewritten, so the stored bytes are what the kernel reads as its
  row-major [KH*KW*Ci, Co] operand.  Backward runs through the
  rewritten forward (the pass must run before ``minimize``), so filter
  gradients and optimizer state are HWIO end to end.
- ``FuseConvBNActPass`` then collapses conv → batch_norm
  (→ residual-add) (→ relu) chains into the ``fused_conv2d_bn_act`` op
  backed by K6 (kernels/conv_fused.py), whose explicit grad lowering
  consumes the forward's saved ConvOut / SavedMean / SavedInvStd
  instead of re-running the forward.

Flag-gated: models consult ``FLAGS.conv_layout`` (see core/flags.py);
the untransformed NCHW program remains the default.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.desc import OpDesc, VarDesc
from paddle_tpu_torch.core.types import (np_dtype_to_proto,
                                         proto_to_torch_dtype)

from .pass_framework import DefUse, PassManager, ProgramPass

__all__ = ["LayoutTranspiler", "NHWCLayoutPass", "FuseConvBNActPass"]

NCHW_TO_NHWC = (0, 2, 3, 1)
NHWC_TO_NCHW = (0, 3, 1, 2)
OIHW_TO_HWIO = (2, 3, 1, 0)

# Image-domain anchor ops (carry an explicit layout attr).
_LAYOUT_OPS = {"conv2d", "depthwise_conv2d", "pool2d", "batch_norm"}
# Layout-agnostic ops the NHWC domain propagates through: pure
# elementwise on the image tensor (same-shape in/out or documented
# broadcast handling below).
_ELEM_OPS = {
    "relu", "relu6", "leaky_relu", "sigmoid", "tanh", "elu", "brelu",
    "soft_relu", "abs", "square", "cast", "scale", "dropout",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_max", "elementwise_min", "clip",
}


def _permute(shape, perm):
    return tuple(shape[p] for p in perm)


def _resync_fluid_program(program):
    """Desc-level rewrites leave the fluid python wrappers (Block.ops /
    Block.vars) stale; refresh them IN PLACE so references the caller
    already holds (the loss Variable, the Block) stay valid for further
    graph building — ``minimize`` runs AFTER this transpiler and walks
    the python op list."""
    from paddle_tpu_torch.fluid import framework as fw

    for blk in getattr(program, "blocks", []):
        bdesc = blk.desc
        for name in list(blk.vars):
            if name not in bdesc.vars:
                del blk.vars[name]
        for name, vd in bdesc.vars.items():
            v = blk.vars.get(name)
            if v is None:
                v = object.__new__(fw.Variable)
                v.block = blk
                v.desc = vd
                v.op = None
                blk.vars[name] = v
            else:
                v.desc = vd
        by_desc = {id(op.desc): op for op in blk.ops}
        blk.ops = [by_desc.get(id(od)) or fw.Operator(blk, od)
                   for od in bdesc.ops]


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.array(v))


def _is4d(du, name, bi=0):
    return du.rank(name, bi) == 4


class NHWCLayoutPass(ProgramPass):
    """Propagate NHWC through the image domain of block 0 and pin conv
    weights HWIO (VarDesc + startup initializer + live scope value)."""

    name = "nhwc_layout"

    def __init__(self, startup_program=None, scope=None):
        self.startup_program = startup_program
        self.scope = scope

    # -- helpers ----------------------------------------------------------
    def _op_imgs(self, op, du):
        """The op's image-tensor slot names (4-D operands subject to
        layout), or None when the op cannot join the NHWC domain."""
        if op.type in ("conv2d", "depthwise_conv2d"):
            return [op.input("Input")[0], op.output("Output")[0]]
        if op.type == "pool2d":
            return [op.input("X")[0], op.output("Out")[0]]
        if op.type == "batch_norm":
            return [op.input("X")[0], op.output("Y")[0]]
        if op.type not in _ELEM_OPS:
            return None
        names = []
        shapes = set()
        for slot, args in list(op.inputs.items()) + \
                list(op.outputs.items()):
            for n in args:
                if not n:
                    continue
                r = du.rank(n)
                if r == 4:
                    names.append(n)
                    shapes.add(du.shape(n))
                elif r > 1:
                    return None     # mixed-rank elementwise: stay out
        if len(shapes) > 1:
            return None             # 4-D broadcast: not convertible
        return names

    def run(self, program, scope, du):
        block = du.block(0)
        scope = self.scope if self.scope is not None else scope

        # ---- seed: untransformed layout-anchor ops ----
        anchors = []
        for op in block.ops:
            if op.type in ("conv2d", "depthwise_conv2d", "pool2d") and \
                    op.attr("data_format", "NCHW") == "NCHW":
                anchors.append(op)
            elif op.type == "batch_norm" and \
                    op.attr("data_layout", "NCHW") == "NCHW" and \
                    _is4d(du, op.input("X")[0]):
                anchors.append(op)
        if not anchors:
            return 0
        for op in block.ops:
            if op.type.endswith("_grad") or "@GRAD" in str(
                    list(op.outputs.values())):
                raise ValueError(
                    "NHWCLayoutPass must run before backward generation "
                    "(apply the layout transpiler before minimize())")

        img = set()
        for op in anchors:
            names = self._op_imgs(op, du)
            for n in names:
                if _is4d(du, n):
                    img.add(n)

        # ---- closure over the elementwise chains ----
        converted_ops = set(id(op) for op in anchors)
        changed = True
        while changed:
            changed = False
            for op in block.ops:
                if id(op) in converted_ops or op.type not in _ELEM_OPS:
                    continue
                names = self._op_imgs(op, du)
                if names is None or not names:
                    continue
                if any(n in img for n in names):
                    converted_ops.add(id(op))
                    for n in names:
                        if n not in img:
                            img.add(n)
                            changed = True

        # ---- decide per-var fate ----
        producer = {}
        for idx, op in enumerate(block.ops):
            for args in op.outputs.values():
                for n in args:
                    if n:
                        producer.setdefault(n, (idx, op))

        rewrites = 0
        boundary_in = []    # (var, first converted-consumer idx)
        boundary_out = []   # (var, producer idx, [non-converted ops])
        for name in sorted(img):
            prod = producer.get(name)
            consumers = []
            for idx, op in enumerate(block.ops):
                if name in op.input_arg_names():
                    consumers.append((idx, op))
            conv_cons = [(i, o) for i, o in consumers
                         if id(o) in converted_ops]
            plain_cons = [(i, o) for i, o in consumers
                          if id(o) not in converted_ops]
            if prod is None or id(prod[1]) not in converted_ops:
                # produced outside the domain (feed var): keep it NCHW,
                # bridge with ONE transpose before its first converted
                # consumer
                if conv_cons:
                    boundary_in.append((name, conv_cons[0][0], conv_cons))
            else:
                vd = block.vars[name]
                vd.shape = _permute(vd.shape, NCHW_TO_NHWC)
                rewrites += 1
                if plain_cons:
                    boundary_out.append((name, prod[0], plain_cons))

        # ---- attrs on converted ops ----
        for op in block.ops:
            if id(op) not in converted_ops:
                continue
            if op.type in ("conv2d", "depthwise_conv2d"):
                op.set_attr("data_format", "NHWC")
                op.set_attr("filter_format", "HWIO")
                self._pin_filter(op, block, scope)
                rewrites += 1
            elif op.type == "pool2d":
                op.set_attr("data_format", "NHWC")
                rewrites += 1
            elif op.type == "batch_norm":
                op.set_attr("data_layout", "NHWC")
                rewrites += 1
            elif op.type.startswith("elementwise") and \
                    op.attr("axis", -1) == 1:
                y = op.input("Y")[0]
                if du.rank(y) == 1:
                    op.set_attr("axis", 3)   # per-channel bias: C is last
                    rewrites += 1

        # ---- boundary transposes (insert bottom-up to keep indices) ----
        inserts = []
        for name, at, conv_cons in boundary_in:
            nhwc = name + "@layout_nhwc"
            vd = block.vars.get(name) or VarDesc(name)
            block.add_var(VarDesc(
                nhwc, dtype=vd.dtype,
                shape=_permute(vd.shape, NCHW_TO_NHWC) if len(vd.shape)
                == 4 else vd.shape,
                stop_gradient=vd.stop_gradient))
            t = OpDesc("transpose", inputs={"X": [name]},
                       outputs={"Out": [nhwc]},
                       attrs={"axis": list(NCHW_TO_NHWC)})
            inserts.append((at, t))
            for _, cop in conv_cons:
                cop.rename_input(name, nhwc)
        for name, pidx, plain_cons in boundary_out:
            nchw = name + "@layout_nchw"
            vd = block.vars[name]     # already NHWC here
            block.add_var(VarDesc(
                nchw, dtype=vd.dtype,
                shape=_permute(vd.shape, NHWC_TO_NCHW),
                stop_gradient=vd.stop_gradient))
            t = OpDesc("transpose", inputs={"X": [name]},
                       outputs={"Out": [nchw]},
                       attrs={"axis": list(NHWC_TO_NCHW)})
            inserts.append((pidx + 1, t))
            for _, cop in plain_cons:
                cop.rename_input(name, nchw)
        for at, t in sorted(inserts, key=lambda e: -e[0]):
            block.insert_op(at, t)
        rewrites += len(inserts)
        return rewrites

    def _pin_filter(self, conv_op, block, scope):
        """Store the filter HWIO: VarDesc, startup initializer shape and
        any live scope value."""
        fname = conv_op.input("Filter")[0]
        vd = block.vars.get(fname)
        if vd is None or len(vd.shape) != 4:
            return
        vd.shape = _permute(vd.shape, OIHW_TO_HWIO)
        if self.startup_program is not None:
            sblock = self.startup_program.desc.blocks[0]
            svd = sblock.vars.get(fname)
            if svd is not None and len(svd.shape) == 4:
                svd.shape = _permute(svd.shape, OIHW_TO_HWIO)
            for op in sblock.ops:
                if fname in op.output_arg_names() and \
                        op.has_attr("shape"):
                    shp = list(op.attr("shape"))
                    if len(shp) == 4:
                        op.set_attr("shape",
                                    [shp[p] for p in OIHW_TO_HWIO])
        if scope is not None and getattr(scope, "has_var", None) and \
                scope.has_var(fname):
            v = _as_tensor(scope.find_var(fname))
            if v.dim() == 4:
                scope.set(fname, v.permute(*OIHW_TO_HWIO).contiguous())


class FuseConvBNActPass(ProgramPass):
    """conv2d → batch_norm (→ residual elementwise_add) (→ relu), all in
    the pinned NHWC domain, collapses to ONE ``fused_conv2d_bn_act`` op
    (conv-stage kernel K6 + fused BN statistics; explicit residual-
    consuming grad lowering — see ops/nn.py)."""

    name = "fuse_conv_bn_act"

    def run(self, program, scope, du):
        block = du.block(0)
        ops = block.ops
        fused = 0
        i = 0
        while i < len(ops):
            op = ops[i]
            if op.type != "conv2d" or \
                    op.attr("data_format", "NCHW") != "NHWC" or \
                    op.attr("groups", 1) != 1 or \
                    list(op.attr("dilations", [1, 1])) != [1, 1]:
                i += 1
                continue
            conv_out = op.output("Output")[0]
            cons = du.sole_consumer(conv_out, start=i + 1,
                                    op_type="batch_norm")
            if cons is None:
                i += 1
                continue
            bi, bn = cons
            if bn.attr("data_layout", "NCHW") != "NHWC":
                i += 1
                continue
            bn_y = bn.output("Y")[0]
            residual = None
            act = ""
            final_y = bn_y
            dead = []
            kill = [bi]
            nxt = du.sole_consumer(bn_y, start=bi + 1)
            if nxt is not None and nxt[1].type == "elementwise_add" and \
                    nxt[1].attr("axis", -1) in (-1, 0):
                ai, add = nxt
                xn, yn = add.input("X")[0], add.input("Y")[0]
                other = xn if yn == bn_y else (yn if xn == bn_y else None)
                if other is not None and du.rank(other) == 4 and \
                        du.shape(other) == du.shape(bn_y):
                    residual = other
                    dead.append(final_y)
                    final_y = add.output("Out")[0]
                    kill.append(ai)
                    nxt = du.sole_consumer(final_y, start=ai + 1)
            if nxt is not None and nxt[1].type == "relu":
                ri, relu = nxt
                act = "relu"
                dead.append(final_y)
                final_y = relu.output("Out")[0]
                kill.append(ri)

            inv_name = bn_y + "@inv_std"
            sm = bn.output("SavedMean")[0]
            sv = bn.output("SavedVariance")[0]
            block.add_var(VarDesc(
                inv_name, dtype=np_dtype_to_proto(np.dtype(np.float32)),
                shape=block.vars[sm].shape, stop_gradient=True))
            svd = block.vars.get(sm)
            if svd is not None:
                svd.dtype = np_dtype_to_proto(np.dtype(np.float32))
            inputs = {"Input": op.input("Input"),
                      "Filter": op.input("Filter"),
                      "Scale": bn.input("Scale"),
                      "Bias": bn.input("Bias"),
                      "Mean": bn.input("Mean"),
                      "Variance": bn.input("Variance")}
            if residual is not None:
                inputs["Residual"] = [residual]
            fop = OpDesc(
                "fused_conv2d_bn_act",
                inputs=inputs,
                outputs={"Y": [final_y], "ConvOut": [conv_out],
                         "MeanOut": bn.output("MeanOut"),
                         "VarianceOut": bn.output("VarianceOut"),
                         "SavedMean": [sm], "SavedInvStd": [inv_name]},
                attrs={"strides": list(op.attr("strides", [1, 1])),
                       "paddings": list(op.attr("paddings", [0, 0])),
                       "epsilon": bn.attr("epsilon", 1e-5),
                       "momentum": bn.attr("momentum", 0.9),
                       "is_test": bool(bn.attr("is_test", False)),
                       "act": act, "data_format": "NHWC"},
                role=op.role)
            # The fused op must sit at the LAST matched op's position:
            # with a residual, the Residual operand may be produced by
            # ops between the conv and the add (the main path, when the
            # shortcut conv absorbs the add) — inserting at the conv's
            # slot would read it before it exists.
            removed = sorted(kill + [i])
            insert_at = removed[-1] - (len(removed) - 1)
            for idx in reversed(removed):
                block.remove_op(idx, idx + 1)
            block.insert_op(insert_at, fop)
            # ConvOut stays declared (it is the grad residual); the
            # fused-away chain intermediates disappear so a stale fetch
            # fails at resolution, not silently
            du.drop_dead_vars(dead + [sv], keep=(final_y,))
            fused += 1
            # mutation invalidated the def-use index: rebuild and keep
            # scanning at the same index (the conv's slot now holds the
            # op that followed it)
            du = du.__class__(du.fluid_program)
            ops = block.ops
        return fused


class LayoutTranspiler:
    """Apply the NHWC pipeline to a (pre-backward) training or inference
    program.  ``transpile`` returns {pass_name: rewrite count}."""

    def transpile(self, program, startup_program=None, scope=None,
                  data_format="NHWC", fuse_stages=True,
                  pin_bn_dtype=None):
        if data_format == "NCHW":
            return {}
        if data_format != "NHWC":
            raise ValueError("data_format must be NCHW or NHWC, got %r"
                             % (data_format,))
        passes = [NHWCLayoutPass(startup_program, scope)]
        if fuse_stages:
            passes.append(FuseConvBNActPass())
        counts = PassManager(passes).run(program, scope=scope)
        if pin_bn_dtype:
            counts["pin_bn_dtype"] = self._pin_bn_params(
                program, startup_program, scope, pin_bn_dtype)
        _resync_fluid_program(program)
        return counts

    def _pin_bn_params(self, program, startup_program, scope, dtype):
        """Store BN affine parameters (Scale/Bias of fused stages) in the
        fused compute dtype — removes the per-step f32 parameter reads
        and casts from the step graph.  Running statistics stay f32.
        Experimental: optimizer state then lives in ``dtype`` too."""
        if not isinstance(dtype, (str, torch.dtype)):
            dtype = np.dtype(dtype)
        proto_dt = np_dtype_to_proto(dtype)
        block = program.desc.blocks[0]
        n = 0
        for op in block.ops:
            if op.type != "fused_conv2d_bn_act":
                continue
            for slot in ("Scale", "Bias"):
                name = op.input(slot)[0]
                vd = block.vars.get(name)
                if vd is None or vd.dtype == proto_dt:
                    continue
                vd.dtype = proto_dt
                if startup_program is not None:
                    sblock = startup_program.desc.blocks[0]
                    svd = sblock.vars.get(name)
                    if svd is not None:
                        svd.dtype = proto_dt
                    for sop in sblock.ops:
                        if name in sop.output_arg_names() and \
                                sop.has_attr("dtype"):
                            sop.set_attr("dtype", proto_dt)
                if scope is not None and scope.has_var(name):
                    v = _as_tensor(scope.find_var(name))
                    scope.set(name, v.to(proto_to_torch_dtype(proto_dt)))
                n += 1
        return n
