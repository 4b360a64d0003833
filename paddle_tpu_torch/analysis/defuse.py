"""Per-block def-use chains over a core ProgramDesc.

Counterpart of ``paddle_tpu/analysis/defuse.py``, over the port's
``core/desc.py``.  Role parity: reference
inference/analysis/data_flow_graph.cc — the one indexing structure
every analysis pass and checker shares, instead of each pass
re-walking the op list.  Sub-block references (while/cond/go/
recurrent ``sub_block`` attrs, listen_and_serv ``grad_to_block_id``)
are followed so reachability and concurrent-write analysis see the
whole program, not just block 0.
"""
from __future__ import annotations

import collections

from paddle_tpu_torch.core.desc import AT_BLOCK, AT_BLOCKS, BlockRef

__all__ = ["DefUse", "sub_block_indices", "CONCURRENT_LAUNCH_OPS"]

# int-typed attrs that name a sub-block (the front-end stores plain
# indices; AT_BLOCK BlockRef attrs arrive from parsed protos)
_SUB_BLOCK_ATTR_NAMES = ("sub_block", "block", "forward_block")
# ops whose sub-block executes CONCURRENTLY with the launching block
# (reference go_op.cc ExecuteOnThread; parallel_do's per-place replicas)
CONCURRENT_LAUNCH_OPS = frozenset({"go", "parallel_do"})


def sub_block_indices(op):
    """Every sub-block index an op references, in attr order.

    Handles AT_BLOCK/AT_BLOCKS (BlockRef) attrs, the front-end's plain
    int ``sub_block`` attrs, and listen_and_serv's ``grad_to_block_id``
    "gradname:blockidx" strings.
    """
    out = []
    for name, attr in op.attrs.items():
        v = attr.value
        if attr.type == AT_BLOCK or isinstance(v, BlockRef):
            out.append(int(v.idx))
        elif attr.type == AT_BLOCKS:
            out.extend(int(b.idx) for b in v)
        elif name in _SUB_BLOCK_ATTR_NAMES and isinstance(v, int):
            out.append(int(v))
        elif name == "grad_to_block_id" and isinstance(v, (list, tuple)):
            for s in v:
                if isinstance(s, str) and ":" in s:
                    idx = s.rsplit(":", 1)[1]
                    if idx.lstrip("-").isdigit():
                        out.append(int(idx))
    return out


class DefUse:
    """Def-use chains for every block of a ``ProgramDesc``.

    - ``producers_idx``/``consumers_idx``: name -> [(block_idx, op_idx)]
      in program order — the flat chain view.
    - ``launch_site``: block_idx -> (parent_block_idx, parent_op_idx,
      op_type) for blocks referenced by an op attr; root and unreferenced
      blocks are absent.
    - ``reachable``: block indices reachable from block 0 (or any block
      with no launch site) by following sub-block attrs.
    """

    def __init__(self, program):
        self.program = program
        self.rebuild()

    def rebuild(self):
        self.consumers_idx = collections.defaultdict(list)
        self.producers_idx = collections.defaultdict(list)
        self.launch_site = {}
        blocks = self.program.blocks
        for bi, b in enumerate(blocks):
            for oi, o in enumerate(b.ops):
                # set(): an op reading one var through several slots
                # (elementwise_mul(X=d, Y=d)) is ONE consumer
                for n in set(o.input_arg_names()):
                    if n:
                        self.consumers_idx[n].append((bi, oi))
                for n in set(o.output_arg_names()):
                    if n:
                        self.producers_idx[n].append((bi, oi))
                for sub in sub_block_indices(o):
                    if 0 <= sub < len(blocks) and sub != bi \
                            and sub not in self.launch_site:
                        self.launch_site[sub] = (bi, oi, o.type)
        roots = [bi for bi in range(len(blocks))
                 if bi not in self.launch_site]
        self.reachable = set()
        stack = list(roots)
        while stack:
            bi = stack.pop()
            if bi in self.reachable or not (0 <= bi < len(blocks)):
                continue
            self.reachable.add(bi)
            for o in blocks[bi].ops:
                stack.extend(sub_block_indices(o))

    # --- block helpers -------------------------------------------------
    def block(self, bi=0):
        return self.program.blocks[bi]

    def find_var(self, bi, name):
        """VarDesc of ``name`` visible from block ``bi`` (its own vars,
        then ancestors via parent_idx)."""
        blocks = self.program.blocks
        seen = set()
        while 0 <= bi < len(blocks) and bi not in seen:
            seen.add(bi)
            blk = blocks[bi]
            vd = blk.vars.get(name)
            if vd is not None:
                return vd
            bi = blk.parent_idx
        return None

    def block_reads_writes(self, bi, recursive=True):
        """(reads, writes) name sets of a block; ``recursive`` follows
        its sub-block references (a go routine's nested while loop still
        writes what it writes)."""
        reads, writes = set(), set()
        stack, seen = [bi], set()
        while stack:
            cur = stack.pop()
            if cur in seen or not (0 <= cur < len(self.program.blocks)):
                continue
            seen.add(cur)
            for o in self.program.blocks[cur].ops:
                reads.update(n for n in o.input_arg_names() if n)
                writes.update(n for n in o.output_arg_names() if n)
                if recursive:
                    stack.extend(sub_block_indices(o))
        return reads, writes

    def producers(self, name):
        return list(self.producers_idx.get(name, ()))

    def consumers(self, name):
        return list(self.consumers_idx.get(name, ()))
