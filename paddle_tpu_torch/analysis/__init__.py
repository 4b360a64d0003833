"""Program analysis of the port (counterpart of ``paddle_tpu/analysis``;
only the def-use index the transpiler passes match on is ported so
far)."""
from .defuse import DefUse, sub_block_indices

__all__ = ["DefUse", "sub_block_indices"]
