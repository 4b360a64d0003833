"""In-program learning-rate decay schedules.

Counterpart of paddle_tpu/fluid/layers/learning_rate_scheduler.py,
function for function: each schedule is ops over the persistable float32
step counter '@LR_DECAY_COUNTER@', which ``global_step_counter``
increments by an op it prepends to the block, so the count is 1 at the
first run.  In a prepared step on a card the increment and the schedule
run inside the captured graph, and ``piecewise_decay``'s value table
(``assign_value``) is a device constant made at ``prepare()``.
"""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer
from . import tensor
from . import nn
from . import ops

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "global_step_counter"]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def global_step_counter():
    """Persistable step counter, incremented once per program run."""
    helper = LayerHelper("global_step_counter")
    gb = default_main_program().global_block()
    if gb.has_var(_COUNTER_NAME):
        return gb.var(_COUNTER_NAME)
    counter = helper.create_or_get_global_variable(
        name=_COUNTER_NAME, dtype="float32", shape=[1], persistable=True)
    helper.set_variable_initializer(counter, ConstantInitializer(0.0))
    gb.prepend_op(type="increment", inputs={"X": [counter]},
                  outputs={"Out": [counter]}, attrs={"step": 1.0})
    counter.stop_gradient = True
    return counter


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = global_step_counter()
    div = step / tensor.fill_constant([1], "float32", float(decay_steps))
    if staircase:
        div = ops.floor(div)
    rate = tensor.fill_constant([1], "float32", float(decay_rate))
    return learning_rate * (rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = global_step_counter()
    div = step / tensor.fill_constant([1], "float32", float(decay_steps))
    if staircase:
        div = ops.floor(div)
    return learning_rate * ops.exp(-1.0 * decay_rate * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = global_step_counter()
    div = step / tensor.fill_constant([1], "float32", float(decay_steps))
    if staircase:
        div = ops.floor(div)
    return learning_rate / (1.0 + decay_rate * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = global_step_counter()
    ds = tensor.fill_constant([1], "float32", float(decay_steps))
    if cycle:
        div = ops.ceil(step / ds)
        one = tensor.fill_constant([1], "float32", 1.0)
        # at step 0 the divisor must be 1
        zero_mask = nn.elementwise_max(
            one - step / nn.elementwise_max(step, one), one * 0.0)
        div = nn.elementwise_max(div, one)
        ds = ds * div
    decayed = nn.elementwise_min(step / ds,
                                 tensor.fill_constant([1], "float32", 1.0))
    return (learning_rate - end_learning_rate) * \
        ((1.0 - decayed) ** power) + end_learning_rate


def piecewise_decay(boundaries, values):
    """lr = values[sum(step >= b for b in boundaries)], via compare+gather
    ops (branch-free — XLA-friendly select instead of the reference's
    conditional blocks)."""
    import numpy as np
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = global_step_counter()
    vals = tensor.assign(np.asarray(values, dtype=np.float32))
    idx = None
    for b in boundaries:
        bvar = tensor.fill_constant([1], "float32", float(b))
        ge = tensor.cast(step >= bvar, "float32")
        idx = ge if idx is None else idx + ge
    idx_i = tensor.cast(idx, "int64")
    return nn.gather(vals, idx_i)


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = global_step_counter()
    a = step ** -0.5
    b = (warmup_steps ** -1.5) * step
    return learning_rate * (d_model ** -0.5) * nn.elementwise_min(a, b)
