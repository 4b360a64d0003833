"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  ``KERNELS`` maps each kernel's name (a kernel's bf16 form has
its own) to its wrapper, whose ``launches`` attribute counts kernel
launches.  A wrapper called while a CUDA graph is captured records a
launch instead of making one: ``core/step_graph.py`` takes the counts
the capturing thread recorded (``_build.recording``) back with
``add_launches`` and adds them again at every replay.  The forward
kernels an inference program reaches are also ``torch.library`` custom
ops (``custom_ops``), through which the lowerings call them and
``torch.export`` traces them."""
from __future__ import annotations

from . import _build
from .flash_attention import (chunk_finalize, flash_attention,
                              flash_attention_bwd, flash_attention_chunk,
                              flash_attention_chunk_bwd,
                              flash_attention_fwd_lse, flash_attention_train,
                              flash_bwd_dkv, flash_bwd_dkv_bf16, flash_bwd_dq,
                              flash_bwd_dq_bf16, flash_chunk_bf16,
                              flash_fwd_bf16, paged_attention)
from .matmul_fused import (add_ln, add_ln_bf16, matmul_epilogue,
                           matmul_epilogue_bf16, matmul_int8_dequant)
from .conv_fused import conv2d_nhwc, conv2d_nhwc_bf16
from .fused import fused_softmax_cross_entropy
from . import custom_ops  # noqa: F401  (registers the forward ops)

__all__ = ["KERNELS", "reset_launches", "launch_counts", "add_launches",
           "flash_attention",
           "flash_attention_fwd_lse", "flash_attention_bwd",
           "flash_attention_train", "flash_attention_chunk",
           "chunk_finalize", "flash_attention_chunk_bwd", "paged_attention",
           "flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
           "flash_chunk_bf16", "matmul_epilogue", "add_ln", "matmul_epilogue_bf16",
           "add_ln_bf16", "matmul_int8_dequant",
           "conv2d_nhwc", "conv2d_nhwc_bf16", "fused_softmax_cross_entropy"]

KERNELS = {"flash_fwd": flash_attention_fwd_lse,
           "flash_bwd_dq": flash_bwd_dq,
           "flash_bwd_dkv": flash_bwd_dkv,
           "flash_fwd_bf16": flash_fwd_bf16,
           "flash_bwd_dq_bf16": flash_bwd_dq_bf16,
           "flash_bwd_dkv_bf16": flash_bwd_dkv_bf16,
           "paged_attention": paged_attention,
           "matmul_int8": matmul_int8_dequant,
           "matmul_epilogue": matmul_epilogue,
           "add_ln": add_ln,
           "matmul_epilogue_bf16": matmul_epilogue_bf16,
           "add_ln_bf16": add_ln_bf16,
           "conv_stage": conv2d_nhwc,
           "conv_stage_bf16": conv2d_nhwc_bf16,
           "flash_chunk": flash_attention_chunk,
           "flash_chunk_bf16": flash_chunk_bf16,
           "fused_ce": fused_softmax_cross_entropy}


def reset_launches():
    with _build.COUNT_LOCK:
        for fn in KERNELS.values():
            fn.launches = 0


def launch_counts():
    """{kernel name: launches so far}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launches(counts):
    """Add ``counts`` ({kernel name: n}) to the kernels' counts."""
    with _build.COUNT_LOCK:
        for name, n in counts.items():
            KERNELS[name].launches += n
