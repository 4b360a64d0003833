"""Program-to-program transpilers (counterpart of
``paddle_tpu/fluid/transpiler``; only the transformer block fusion is
ported so far)."""
from .transformer_fuse import (  # noqa: F401
    FuseTransformerBlockPass, TransformerFuseTranspiler)

__all__ = ["FuseTransformerBlockPass", "TransformerFuseTranspiler"]
