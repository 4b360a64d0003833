"""Optimizers — build optimize ops from (param, grad) pairs.

Counterpart of paddle_tpu/fluid/optimizer.py (minimize =
append_backward + regularization + clipping +
_create_optimization_pass); SGD, Momentum, Adagrad and Adam are ported
so far.
"""
from __future__ import annotations

from collections import defaultdict

from .framework import (Variable, default_main_program,
                        default_startup_program, program_guard)
from .backward import append_backward
from .layer_helper import LayerHelper
from .initializer import ConstantInitializer
from .regularizer import append_regularization_ops
from .clip import append_gradient_clip_ops, error_clip_callback
from . import unique_name
from . import layers

__all__ = ["SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer",
           "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        # accumulators: {name: {param_name: var}}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # --- learning rate ---
    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._learning_rate_map.get(program)
        if lr is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        name = unique_name.generate("learning_rate")
        lr_var = layers.tensor.create_global_var(
            name=name, shape=[1], value=float(self._learning_rate),
            dtype="float32", persistable=True)
        self._learning_rate_map[program] = lr_var

    def _global_learning_rate(self, program=None):
        if program is None:
            program = default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = getattr(param, "optimize_attr",
                           {"learning_rate": 1.0}).get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        raise NotImplementedError(
            "per-parameter learning rates (ParamAttr.learning_rate != 1) "
            "need the scale op, which is not ported to paddle_tpu_torch yet")

    # --- accumulators ---
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        assert self.helper is not None
        var_name = unique_name.generate("%s_%s_%s" %
                                        (param.name, name, "acc"))
        var = self.helper.create_global_variable(
            name=var_name, persistable=True,
            dtype=dtype or param.dtype,
            shape=shape if shape is not None else param.shape)
        self.helper.set_variable_initializer(
            var, initializer=ConstantInitializer(value=float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # --- the pass ---
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        with program_guard(program, startup_program
                           or default_startup_program()):
            self.helper = LayerHelper(self.__class__.__name__)
            self._create_global_learning_rate()
            block = loss.block
            self._create_accumulators(
                block, [p for p, g in parameters_and_grads if g is not None])
            optimize_ops = []
            with program.optimized_guard(parameters_and_grads):
                for param_and_grad in parameters_and_grads:
                    if param_and_grad[1] is None:
                        continue
                    if getattr(param_and_grad[0], "trainable", True):
                        optimize_ops.append(
                            self._append_optimize_op(block, param_and_grad))
                self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        # clip/regularization ops consume gradients: they must carry the
        # Optimize role or clone(for_test=True) would keep them in
        # inference programs (reading @GRAD vars that no longer exist)
        with loss.block.program.optimized_guard(params_grads):
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
        optimize_ops = self._create_optimization_pass(
            params_grads, loss, startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0]}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str,
                                             param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Velocity": velocity_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "VelocityOut": velocity_acc},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov}, infer_shape=False)


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": moment_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0], "MomentOut": moment_acc},
            attrs={"epsilon": self._epsilon}, infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator(self._beta2_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment1 = self._get_accumulator(self._moment1_acc_str, p)
        moment2 = self._get_accumulator(self._moment2_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": p, "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment1": moment1, "Moment2": moment2,
                    "Beta1Pow": beta1_pow, "Beta2Pow": beta2_pow},
            outputs={"ParamOut": p, "Moment1Out": moment1,
                     "Moment2Out": moment2, "Beta1PowOut": beta1_pow,
                     "Beta2PowOut": beta2_pow},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
