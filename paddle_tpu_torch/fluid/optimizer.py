"""Optimizers — build optimize ops from (param, grad) pairs.

Counterpart of paddle_tpu/fluid/optimizer.py, class for class (minimize
= append_backward + clipping + regularization +
_create_optimization_pass); the same calls build the same descs.
``ModelAverage`` is the port's own: the JAX package's raises at
``apply``.  It follows the reference Fluid's (optimizer.py:818): an
``average_accumulates`` op a parameter in the main program, and an
``apply_program`` / ``restore_program`` pair that swaps the averaged
weights in and the trained ones back.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

from .framework import (Program, Variable, default_main_program,
                        default_startup_program, program_guard)
from .backward import append_backward
from .layer_helper import LayerHelper
from .initializer import ConstantInitializer
from .regularizer import append_regularization_ops
from .clip import append_gradient_clip_ops, error_clip_callback
from . import unique_name
from . import layers

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
           "Adadelta", "RMSProp", "Ftrl", "ModelAverage",
           "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
           "AdamOptimizer", "AdamaxOptimizer", "DecayedAdagradOptimizer",
           "AdadeltaOptimizer", "RMSPropOptimizer", "FtrlOptimizer",
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
        return layers.nn.scale(base, scale=float(param_lr))

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


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": p, "Grad": param_and_grad[1],
                    "LearningRate": self._create_param_lr(param_and_grad),
                    "Moment": moment, "InfNorm": inf_norm,
                    "Beta1Pow": beta1_pow},
            outputs={"ParamOut": p, "MomentOut": moment,
                     "InfNormOut": inf_norm, "Beta1PowOut": beta1_pow},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
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
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1.0e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        avg_squared_grad = self._get_accumulator(
            self._avg_squared_grad_acc_str, param_and_grad[0])
        avg_squared_update = self._get_accumulator(
            self._avg_squared_update_acc_str, param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "AvgSquaredGrad": avg_squared_grad,
                    "AvgSquaredUpdate": avg_squared_update,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "AvgSquaredGradOut": avg_squared_grad,
                     "AvgSquaredUpdateOut": avg_squared_update},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1.0e-6,
                 momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._momentum_acc_str,
                                             param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str,
                                                param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "Moment": momentum_acc, "MeanSquare": mean_square_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "MomentOut": momentum_acc,
                     "MeanSquareOut": mean_square_acc},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum}, infer_shape=False)


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        squared_acc = self._get_accumulator(self._squared_acc_str,
                                            param_and_grad[0])
        linear_acc = self._get_accumulator(self._linear_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": param_and_grad[0], "Grad": param_and_grad[1],
                    "SquaredAccumulator": squared_acc,
                    "LinearAccumulator": linear_acc,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": param_and_grad[0],
                     "SquaredAccumOut": squared_acc,
                     "LinearAccumOut": linear_acc},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power}, infer_shape=False)


class ModelAverage(Optimizer):
    """Parameter averaging over a sliding window (reference Fluid
    optimizer.py:818).  Build it after ``minimize``, in the main
    program's guard: each parameter (unless its ``do_model_average`` is
    False) gets an ``average_accumulates`` op under the Optimize role,
    with sum_1 / sum_2 / sum_3 and three int64 counts as persistables.
    ``apply(executor)`` runs ``apply_program`` (the parameter backed up,
    then set to (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates)); leaving it runs ``restore_program`` (the
    backup put back) unless ``need_restore`` is False."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        program = default_main_program()
        block = program.global_block()
        self.params_grads = []
        for param in block.all_parameters():
            if getattr(param, "do_model_average", None) is False:
                continue
            backup = block.create_var(
                name=unique_name.generate(param.name + ".tmp"),
                dtype=param.dtype, shape=param.shape, persistable=False,
                stop_gradient=True)
            self.params_grads.append((param, backup))
        self.helper = LayerHelper("average_accumulate")
        with program.optimized_guard(self.params_grads):
            for param, _ in self.params_grads:
                self._append_average_accumulate_op(param)
        self.apply_program = Program()
        with program_guard(self.apply_program):
            for param_grad in self.params_grads:
                self._add_average_apply_op(
                    self.apply_program.global_block(), param_grad)
        self.restore_program = Program()
        with program_guard(self.restore_program):
            for param_grad in self.params_grads:
                self._add_average_restore_op(
                    self.restore_program.global_block(), param_grad)

    def _append_average_accumulate_op(self, param):
        sums = [self._add_accumulator("sum_%d" % i, param)
                for i in (1, 2, 3)]
        counts = [self._add_accumulator(name, param, dtype="int64",
                                        shape=[1])
                  for name in ("num_accumulates", "old_num_accumulates",
                               "num_updates")]
        io = dict(zip(("sum_1", "sum_2", "sum_3", "num_accumulates",
                       "old_num_accumulates", "num_updates"),
                      sums + counts))
        self.helper.append_op(
            type="average_accumulates",
            inputs=dict({"Param": param},
                        **{"in_" + k: v for k, v in io.items()}),
            outputs={"out_" + k: v for k, v in io.items()},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window},
            infer_shape=False)

    @staticmethod
    def _clone(block, var):
        """``var`` declared in ``block`` (another program's), persistable:
        the executor reads it from the scope and writes it back."""
        return block.create_var(name=var.name, shape=var.shape,
                                dtype=var.dtype, persistable=True)

    def _add_average_apply_op(self, block, param_grad):
        param = self._clone(block, param_grad[0])
        backup = self._clone(block, param_grad[1])
        acc = [self._clone(block, self._get_accumulator(name,
                                                        param_grad[0]))
               for name in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                            "old_num_accumulates", "num_updates")]
        layers.assign(input=param, output=backup)
        count = layers.cast(layers.sums(acc[3:5]), param.dtype)
        total = layers.sums(acc[:3])
        block.append_op(type="elementwise_div",
                        inputs={"X": [total], "Y": [count]},
                        outputs={"Out": [param]}, attrs={"axis": -1})

    def _add_average_restore_op(self, block, param_grad):
        param = self._clone(block, param_grad[0])
        backup = self._clone(block, param_grad[1])
        layers.assign(input=backup, output=param)

    @contextmanager
    def apply(self, executor, need_restore=True):
        """Swap the averaged parameters in for the body of the
        ``with``; put the trained ones back after it (unless
        ``need_restore`` is False: then ``restore`` does)."""
        executor.run(self.apply_program)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        executor.run(self.restore_program)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
