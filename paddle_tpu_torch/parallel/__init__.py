"""Parallelism of the port — the counterpart of ``paddle_tpu/parallel``
for sequence parallelism.

- ``mesh`` : a named device mesh over a list of ``torch.device``
             (``make_mesh``);
- ``api``  : the ``sharding_constraint`` layer of fluid programs;
- ``ring`` : ring attention over the mesh's ``sp`` axis, each ring step
             one K9 chunk fold (``kernels/flash_attention.py``).

Not ported yet: pipeline, MoE expert parallelism and the ``spmd``
placement runtime.
"""
from .mesh import Mesh, make_mesh  # noqa: F401
from .api import sharding_constraint  # noqa: F401
from .ring import (ring_attention, ring_attention_fwd_lse,  # noqa: F401
                   ring_attention_bwd, causal_step_counts)

__all__ = ["Mesh", "make_mesh", "sharding_constraint", "ring_attention",
           "ring_attention_fwd_lse", "ring_attention_bwd",
           "causal_step_counts"]
