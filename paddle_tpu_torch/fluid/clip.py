"""Gradient and error clipping (counterpart of paddle_tpu/fluid/clip.py,
class for class).  ``set_gradient_clip`` marks parameters;
``Optimizer.minimize`` then appends each one's clip ops under the
Optimize role: ``clip`` (by value), ``clip_by_norm`` (per gradient), or
for ``GradientClipByGlobalNorm`` one group's ``square`` ->
``reduce_sum`` per gradient, then ``sum``, ``sqrt``, ``elementwise_max``,
``elementwise_div`` and an ``elementwise_mul`` on each gradient."""
from __future__ import annotations

from . import layers
from .framework import default_main_program

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "append_gradient_clip_ops",
           "set_gradient_clip", "error_clip_callback"]


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        grad = block.vars[grad_name]
        block.append_op(type="clip", inputs={"X": grad},
                        outputs={"Out": grad},
                        attrs={"min": self.min, "max": self.max})


def error_clip_callback(block, op_desc):
    pass  # hook point for ErrorClipByValue on activation grads


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        new_grad = layers.clip(x=grad, min=self.min, max=self.max)
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        new_grad = layers.clip_by_norm(x=grad, max_norm=self.clip_norm)
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
            context[self.group_name + "_clip"] = layers.fill_constant(
                shape=[1], dtype="float32", value=self.clip_norm)
        local_norm = layers.reduce_sum(
            layers.square(grad) if hasattr(layers, "square")
            else grad * grad)
        context[self.group_name].append(local_norm)
        self.context = context

    def _create_operators(self, param, grad):
        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm_var = layers.sums(self.context[self.group_name])
            group_norm_var = layers.sqrt(group_norm_var)
            clip_var = self.context[self.group_name + "_clip"]
            group_scale_var = layers.elementwise_div(
                x=clip_var,
                y=layers.elementwise_max(x=clip_var, y=group_norm_var))
            self.context[group_scale_name] = group_scale_var
        new_grad = layers.elementwise_mul(
            x=grad, y=self.context[group_scale_name])
        return param, new_grad


def set_gradient_clip(clip, param_list=None, program=None):
    if program is None:
        program = default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    context = {}
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        clip_attr._process_context(context=context, param=p, grad=g)
    res = []
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        res.append(clip_attr._create_operators(param=p, grad=g))
    return res
