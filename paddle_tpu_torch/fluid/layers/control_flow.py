"""Control-flow layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``; ``Print`` only: While,
cond and the tensor arrays need sub-blocks, which are not ported yet,
ROADMAP queue 1 item 7)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["Print"]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """In-graph tensor printing (a host op, ``ops/io_ops.py``): after the
    block's device ops it runs in the postlude; between two device ops
    it makes the executor run the block op by op."""
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
