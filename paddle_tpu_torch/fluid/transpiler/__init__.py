"""Program-to-program transpilers (counterpart of
``paddle_tpu/fluid/transpiler``; the NHWC layout pipeline and the
transformer block fusion are ported so far)."""
from .layout_transpiler import (  # noqa: F401
    FuseConvBNActPass, LayoutTranspiler, NHWCLayoutPass)
from .transformer_fuse import (  # noqa: F401
    FuseTransformerBlockPass, TransformerFuseTranspiler)

__all__ = ["LayoutTranspiler", "NHWCLayoutPass", "FuseConvBNActPass",
           "FuseTransformerBlockPass", "TransformerFuseTranspiler"]
