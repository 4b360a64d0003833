"""LayerHelper: parameter creation + op appending shared by all layers.

Counterpart of paddle_tpu/fluid/layer_helper.py — creates parameters in
the startup program (with initializer ops) and the main program, appends
ops to the current block, and applies activations.
"""
from __future__ import annotations

from .framework import (Variable, default_main_program,
                        default_startup_program)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr
from . import unique_name

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    # --- inputs ---
    def input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            inputs = [inputs]
        return inputs

    def input_dtype(self, input_param_name="input"):
        inputs = self.input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("mixed input dtypes: %s vs %s" %
                                 (dtype, each.dtype))
        return dtype

    # --- params ---
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr()
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        elif len(attr) == 1 and length != 1:
            attr = [attr[0]] + [ParamAttr(**attr[0]._to_kwargs())
                                for _ in range(length - 1)]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, attr in zip(inputs, param_attrs):
            yield ipt, attr

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr.to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "b" if is_bias else "w"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = (ConstantInitializer(0.0) if is_bias
                    else XavierInitializer())
        # parameter in the main program's global block
        param = self.main_program.global_block().create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **attr._to_param_kwargs())
        # twin in the startup program, with the initializer op
        startup_param = self.startup_program.global_block().create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            trainable=attr.trainable)
        init(startup_param, self.startup_program.global_block())
        if getattr(attr, "sharding", None) is not None:
            param.set_sharding(attr.sharding)
        return param

    def create_tmp_variable(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.block.create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        gb = self.main_program.global_block()
        if not gb.has_var(name):
            return self.create_global_variable(*args, name=name, **kwargs)
        return gb.var(name)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        twin = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                             persistable=True)
        initializer(twin, sb)

    # --- bias/act ---
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr()
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add", inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
