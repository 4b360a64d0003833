"""Helpers of the NHWC layout transpiler.

Counterpart of ``paddle_tpu/fluid/transpiler/layout_transpiler.py``.
Only ``_resync_fluid_program`` is ported so far: the transformer fuse
pass (``transformer_fuse.py``) rewrites descs and needs it.  The layout
pass itself (``NHWCLayoutPass``, ``FuseConvBNActPass``,
``LayoutTranspiler``) comes with the ResNet-50 slice of the port,
together with the conv op set and the fused conv-stage kernel.
"""
from __future__ import annotations

__all__ = []


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
