"""Program debugging helpers.

Parity: reference python/paddle/fluid/debuger.py — pprint_program_codes
(pseudo-code dump) and draw_block_graphviz (DOT graph of vars + ops).
The port's copy of ``paddle_tpu/fluid/debugger.py``: the same text from
the same program.
"""
from __future__ import annotations

__all__ = ["pprint_program", "draw_block_graphviz"]


def pprint_program(program):
    """Readable pseudo-code of every block (reference
    debuger.py:pprint_program_codes)."""
    lines = []
    for blk in program.blocks:
        lines.append("block_%d (parent %d) {" % (blk.idx, blk.parent_idx))
        for name, vd in sorted(blk.desc.vars.items()):
            lines.append("  var %s : %s%s%s" % (
                name, list(vd.shape),
                " persistable" if vd.persistable else "",
                " lod=%d" % vd.lod_level if vd.lod_level else ""))
        for op in blk.desc.ops:
            ins = ", ".join("%s=%s" % (k, v) for k, v in
                            sorted(op.inputs.items()) if v)
            outs = ", ".join("%s=%s" % (k, v) for k, v in
                             sorted(op.outputs.items()) if v)
            lines.append("  %s <- %s(%s)" % (outs, op.type, ins))
        lines.append("}")
    return "\n".join(lines)


def draw_block_graphviz(block, path=None, highlights=None):
    """DOT digraph of a block: op nodes (boxes) wired through var nodes
    (ellipses); parameters shaded (reference debuger.py:
    draw_block_graphviz).  Returns the DOT text; writes it when ``path``
    is given (render with `dot -Tpng`)."""
    highlights = set(highlights or [])
    out = ["digraph G {", '  rankdir=TB;']
    seen_vars = {}

    def var_node(name):
        if name in seen_vars:
            return seen_vars[name]
        nid = "var_%d" % len(seen_vars)
        seen_vars[name] = nid
        vd = block.desc.vars.get(name)
        shape = list(vd.shape) if vd is not None else "?"
        style = 'style=filled, fillcolor="lightgrey", ' \
            if vd is not None and vd.persistable else ""
        color = 'color="red", ' if name in highlights else ""
        out.append('  %s [label="%s\\n%s", shape=ellipse, %s%s];' %
                   (nid, name.replace('"', ""), shape, style, color))
        return nid

    for i, op in enumerate(block.desc.ops):
        op_id = "op_%d" % i
        out.append('  %s [label="%s", shape=box, style=filled, '
                   'fillcolor="lightblue"];' % (op_id, op.type))
        for name in op.input_arg_names():
            if name:
                out.append("  %s -> %s;" % (var_node(name), op_id))
        for name in op.output_arg_names():
            if name:
                out.append("  %s -> %s;" % (op_id, var_node(name)))
    out.append("}")
    dot = "\n".join(out)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
