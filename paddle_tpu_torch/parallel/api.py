"""Sharding annotations on fluid programs.

Counterpart of ``paddle_tpu/parallel/api.py``; the programs they build
serialize as the JAX package's do."""
from __future__ import annotations

from paddle_tpu_torch.fluid.layer_helper import LayerHelper

__all__ = ["sharding_constraint"]


def sharding_constraint(x, spec, name=None):
    """In-graph activation sharding constraint.  The op is the identity
    in the port: the executor runs every op on its own device, and only
    the ring attention op shards over the mesh."""
    helper = LayerHelper("sharding_constraint", **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sharding_constraint", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"spec": [a if a else "" for a in spec]})
    return out
