"""The forward kernels an inference program reaches, registered as
``torch.library`` custom ops, so that ``torch.export`` traces through them
(``inference/aot.py``).

Each op's implementation is the kernel's wrapper, and its fake
(``register_fake``) gives the output shapes and dtypes alone.  On CUDA
tensors the wrapper makes the kernel's existing ctypes launch, counts it,
records it while a CUDA graph is captured (``_build.recording``) and
raises rather than run anything else; on CPU tensors it checks the
operands as on the card and runs the kernel's plain version, whose
outputs may share storage with an input or with each other, which a
custom op's may not (``_fresh`` copies those).

The ops and their forms (each op takes float32 or bfloat16 operands and
launches the form of their dtype):

- ``paddle_tpu_torch::flash_fwd``: K1 and K1 bf16, ``flash_attention_fwd_
  lse`` (out, lse);
- ``paddle_tpu_torch::matmul_epilogue``: K4 and K4 bf16 (out, pre; pre is
  empty unless ``save_preact``);
- ``paddle_tpu_torch::add_ln``: K5 and K5 bf16 (out, sum, mean, var);
- ``paddle_tpu_torch::conv_stage``: K6 and K6 bf16 without statistics
  (the test-mode stage: affine, residual, relu in the epilogue).

The lowerings of ``ring_attention`` (off a mesh, without autograd),
``fused_qkv_matmul``, ``fused_matmul_bias_act``, ``fused_add_ln`` and the
test-mode ``fused_conv2d_bn_act`` call these ops; no kernel's arithmetic
differs from a call of its wrapper.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from . import conv_fused, matmul_fused
from .flash_attention import flash_attention_fwd_lse

__all__ = ["flash_fwd", "matmul_epilogue", "add_ln", "conv_stage"]

_NS = "paddle_tpu_torch::"


def _fresh(t, *others):
    """``t``, cloned if it shares storage with one of ``others`` (a custom
    op's outputs alias neither its inputs nor each other)."""
    ptr = t.untyped_storage().data_ptr()
    if any(o is not None and o.untyped_storage().data_ptr() == ptr
           for o in others):
        return t.clone()
    return t


# -- K1 -------------------------------------------------------------------

@torch.library.custom_op(_NS + "flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    return flash_attention_fwd_lse(q, k, v, scale, causal)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, scale, causal):
    b, h, t, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, t), dtype=torch.float32)


# -- K4 -------------------------------------------------------------------

@torch.library.custom_op(_NS + "matmul_epilogue", mutates_args=())
def matmul_epilogue(x2: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    residual: Optional[torch.Tensor], act: str,
                    save_preact: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if not save_preact:
        out = matmul_fused.matmul_epilogue(x2, w, bias, residual, act)
        return _fresh(out, x2, w, bias, residual), out.new_empty((0,))
    out, pre = matmul_fused.matmul_epilogue(x2, w, bias, residual, act,
                                            save_preact=True)
    return (_fresh(out, x2, w, bias, residual),
            _fresh(pre, out, x2, w, bias, residual))


@matmul_epilogue.register_fake
def _matmul_epilogue_fake(x2, w, bias, residual, act, save_preact):
    out = x2.new_empty((x2.shape[0], w.shape[1]))
    return out, (torch.empty_like(out) if save_preact
                 else out.new_empty((0,)))


# -- K5 -------------------------------------------------------------------

@torch.library.custom_op(_NS + "add_ln", mutates_args=())
def add_ln(x2: torch.Tensor, y2: torch.Tensor,
           scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
           eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    out, s, mean, var = matmul_fused.add_ln(x2, y2, scale, bias, eps)
    return (_fresh(out, x2, y2, scale, bias), s, mean.contiguous(),
            var.contiguous())


@add_ln.register_fake
def _add_ln_fake(x2, y2, scale, bias, eps):
    m = x2.shape[0]
    return (torch.empty_like(x2), torch.empty_like(x2), x2.new_empty((m,)),
            x2.new_empty((m,)))


# -- K6 -------------------------------------------------------------------

@torch.library.custom_op(_NS + "conv_stage", mutates_args=())
def conv_stage(x: torch.Tensor, w: torch.Tensor, strides: List[int],
               paddings: List[int], a: Optional[torch.Tensor],
               b: Optional[torch.Tensor], residual: Optional[torch.Tensor],
               act: str) -> torch.Tensor:
    y = conv_fused.conv2d_nhwc(x, w, strides, paddings,
                               affine=_affine(a, b), residual=residual,
                               act=act)
    return _fresh(y, x, w, a, b, residual)


@conv_stage.register_fake
def _conv_stage_fake(x, w, strides, paddings, a, b, residual, act):
    n, h, wd, _ = x.shape
    kh, kw, _, co = w.shape
    (sh, sw), (ph, pw) = strides, paddings
    return x.new_empty((n, (h + 2 * ph - kh) // sh + 1,
                        (wd + 2 * pw - kw) // sw + 1, co))


def _affine(a, b):
    if (a is None) != (b is None):
        raise ValueError("conv_stage takes the affine's a and b together")
    return None if a is None else (a, b)
