"""Program-to-program transpilers (counterpart of
``paddle_tpu/fluid/transpiler``; the bf16 mixed-precision flag, the NHWC
layout pipeline and the transformer block fusion are ported so far)."""
from .float16_transpiler import Float16Transpiler  # noqa: F401
from .layout_transpiler import (  # noqa: F401
    FuseConvBNActPass, LayoutTranspiler, NHWCLayoutPass)
from .transformer_fuse import (  # noqa: F401
    FuseTransformerBlockPass, TransformerFuseTranspiler)

__all__ = ["Float16Transpiler", "LayoutTranspiler", "NHWCLayoutPass",
           "FuseConvBNActPass", "FuseTransformerBlockPass",
           "TransformerFuseTranspiler"]
