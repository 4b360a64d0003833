"""Generated op-builder layers (counterpart of
``paddle_tpu/fluid/layers/ops.py``).

Generated from the port's own registry by the JAX package's rule: every
registered, non-host, non-random, non-grad op whose lowering reads
exactly the ``X`` input slot and writes exactly the ``Out`` output slot
(read off the lowering's source) gets a front-end function
``fluid.layers.<op>(x, **attrs)``, unless a hand-written layer of the
same name already exists in the package (those keep their richer
signatures), and the ``_STRUCTURAL`` ops never.  The set follows the
port's registry, which holds fewer ops than the JAX package's.
"""
from __future__ import annotations

import inspect
import re

from paddle_tpu_torch.core import registry

from ..layer_helper import LayerHelper
from . import nn as _nn
from . import sequence_op as _seq
from . import tensor as _tensor

_CAP_SLOT = re.compile(r'"([A-Z][\w@]*)"\s*:')
_IN_SLOT = re.compile(r'ins(?:\.get\(|\.has\(|\.list\(|\[)"([\w@]+)"')

# X->Out by slot shape, but their hand-written layers (control_flow.py,
# imported after this module) create special var KINDS (TensorArray /
# RankTable) the generic builder cannot — never generate these.
_STRUCTURAL = {
    "increment", "is_empty", "lod_rank_table", "lod_tensor_to_array",
    "array_to_lod_tensor", "lod_array_length", "shrink_rnn_memory",
    "reorder_lod_tensor_by_rank",
}


def unary_op_types():
    """Registered ops whose lowering is a pure X -> Out map (slot usage
    read off the lowering source; unreadable sources are skipped, which
    under-generates — the safe direction)."""
    names = []
    for op in registry.registered_ops():
        if op.endswith("_grad") or op in _STRUCTURAL:
            continue
        info = registry._registry[op]
        if info.host_op or info.stateful:
            continue
        try:
            src = inspect.getsource(info.lower)
        except (OSError, TypeError):
            continue
        ins = set(_IN_SLOT.findall(src))
        outs = set(_CAP_SLOT.findall(src))
        if ins == {"X"} and outs == {"Out"}:
            names.append(op)
    return names


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = ("%s: X -> Out op-builder (generated from the "
                     "registry; reference layer_function_generator.py "
                     "role)" % op_type)
    return layer


_existing = set()
for _mod in (_nn, _seq, _tensor):
    _existing.update(n for n in dir(_mod) if not n.startswith("_"))

_GENERATED = []
for _op in unary_op_types():
    if _op in _existing:
        continue   # a hand-written layer with a richer signature wins
    globals()[_op] = _make_unary(_op)
    _GENERATED.append(_op)

__all__ = list(_GENERATED) + ["uniform_random_like", "unary_op_types"]


def uniform_random_like(x, min=-1.0, max=1.0, seed=0):
    from .nn import uniform_random_batch_size_like
    return uniform_random_batch_size_like(x, shape=list(x.shape),
                                          min=min, max=max, seed=seed)
