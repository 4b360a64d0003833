"""Program-to-program transpilers (counterpart of
``paddle_tpu/fluid/transpiler``; the bf16 mixed-precision flag, the NHWC
layout pipeline, the transformer block fusion, the inference analysis
passes and the memory-optimization API are ported so far)."""
from .float16_transpiler import Float16Transpiler  # noqa: F401
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .layout_transpiler import (  # noqa: F401
    FuseConvBNActPass, LayoutTranspiler, NHWCLayoutPass)
from .memory_optimization_transpiler import (  # noqa: F401
    memory_optimize, release_memory)
from .transformer_fuse import (  # noqa: F401
    FuseTransformerBlockPass, TransformerFuseTranspiler)

__all__ = ["Float16Transpiler", "InferenceTranspiler", "LayoutTranspiler",
           "NHWCLayoutPass", "FuseConvBNActPass", "memory_optimize",
           "release_memory", "FuseTransformerBlockPass",
           "TransformerFuseTranspiler"]
