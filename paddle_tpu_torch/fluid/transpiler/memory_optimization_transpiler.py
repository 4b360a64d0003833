"""Memory-optimization transpiler (API parity).

Counterpart of ``paddle_tpu/fluid/transpiler/memory_optimization_
transpiler.py``.  Parity: reference transpiler/memory_optimization_
transpiler.py:42 (ControlFlowGraph liveness + var reuse) and :361
memory_optimize().

In the port the part of the reference's var reuse is played by PyTorch's
caching allocator, which hands a freed block to the next tensor of its
size, with the executor's free plan (``core/executor_impl._free_plan``)
dropping every value after its last reader; and by a captured step's
graph memory pool (``core/step_graph.py``), in which the graph's
temporaries share blocks.  The API is kept so reference code ports
without edits; ``memory_optimize`` computes and returns the liveness the
reference would have acted on (useful for inspection), mutating nothing.
"""
from __future__ import annotations

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, print_log=False, level=0):
    """Liveness analysis over the global block; returns
    {var: (first_use, last_use)} for non-persistable vars.  No desc
    mutation — the allocator already reuses dead buffers."""
    block = input_program.desc.blocks[0]
    first = {}
    last = {}
    for idx, op in enumerate(block.ops):
        for name in op.input_arg_names() + op.output_arg_names():
            if not name:
                continue
            vd = block.vars.get(name)
            if vd is None or vd.persistable:
                continue
            first.setdefault(name, idx)
            last[name] = idx
    live = {n: (first[n], last[n]) for n in first}
    if print_log:
        for n, (f, l) in sorted(live.items()):
            print("var %s live [%d, %d]" % (n, f, l))
    return live


def release_memory(input_program):
    """No-op (reference release_memory inserts delete ops; a tensor's
    memory goes back to the allocator when its last reference drops)."""
    return input_program
