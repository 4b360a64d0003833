"""fluid-compatible user API of the port.

Counterpart of ``paddle_tpu.fluid`` for the surface the transformer
LM's and ResNet's training reaches, ``ParallelExecutor`` over a
sequence-parallel mesh, persistence (``io``), ``DataFeeder`` and the
high-level ``Trainer`` / ``Inferencer``, ragged (LoD) feeds
(``create_lod_tensor``) with the sequence layers, the metric front end
(``metrics``, ``evaluator``, ``average``), the reader layers over the
reader ops (``layers.io``, ``recordio_writer``, ``core.EOFException``)
and the reference's remaining names (``default_scope_funcs``,
``debugger``, ``FLAGS`` / ``define_flag``, ``Tensor``,
``is_compiled_with_cuda``):

    import paddle_tpu_torch.fluid as fluid
    x = fluid.layers.data(name="x", shape=[13])
    y = fluid.layers.fc(x, size=1)
    ...
    exe = fluid.Executor(fluid.CUDAPlace(0))

Programs built here serialize to the same bytes as the JAX package's.
"""
import paddle_tpu_torch.ops  # noqa: F401  (register the operator library)

from . import framework
from .framework import (Program, Block, Operator, Variable, Parameter,
                        default_main_program, default_startup_program,
                        program_guard, switch_main_program,
                        switch_startup_program)
from . import layers
from . import initializer
from .param_attr import ParamAttr
from . import param_attr
from .layer_helper import LayerHelper
from . import layer_helper
from . import backward
from .backward import append_backward, calc_gradient
from . import optimizer
from . import regularizer
from . import clip
from . import unique_name
from .executor import (Executor, PreparedProgram, global_scope,
                       scope_guard, fetch_var)
from .parallel_executor import ParallelExecutor
from . import io
from .io import (save_vars, save_params, save_persistables, load_vars,
                 load_params, load_persistables, save_inference_model,
                 load_inference_model, get_inference_program,
                 save_checkpoint, load_checkpoint, clean_checkpoint,
                 get_latest_checkpoint_serial)
from . import nets
from . import transpiler
from . import data_feeder
from .data_feeder import DataFeeder
from . import trainer
from .trainer import (Trainer, BeginEpochEvent, EndEpochEvent,
                      BeginStepEvent, EndStepEvent, CheckpointConfig)
from . import inferencer
from .inferencer import Inferencer
from . import lod_tensor
from .lod_tensor import create_lod_tensor, create_random_int_lodtensor
from . import metrics
from . import evaluator
from . import average
from . import debugger
from . import recordio_writer
from . import default_scope_funcs

from paddle_tpu_torch.core.flags import FLAGS, define_flag
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.core import executor_impl as core

Tensor = None  # tensors are torch tensors; kept for import parity


def is_compiled_with_cuda():
    """Whether the torch build has CUDA (the reference's answers False:
    its accelerator is the TPU)."""
    import torch

    return torch.version.cuda is not None


def is_compiled_with_tpu():
    return False

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program",
    "layers", "initializer", "ParamAttr", "LayerHelper",
    "append_backward", "calc_gradient", "optimizer", "regularizer", "clip",
    "unique_name",
    "Executor", "global_scope", "scope_guard", "fetch_var", "io",
    "ParallelExecutor", "nets",
    "transpiler", "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_inference_program", "save_checkpoint",
    "load_checkpoint", "clean_checkpoint", "get_latest_checkpoint_serial",
    "DataFeeder", "Trainer", "BeginEpochEvent", "EndEpochEvent",
    "BeginStepEvent", "EndStepEvent", "CheckpointConfig", "Inferencer",
    "CPUPlace", "CUDAPlace", "Scope", "lod_tensor", "create_lod_tensor",
    "create_random_int_lodtensor", "metrics", "evaluator", "average",
    "PreparedProgram", "recordio_writer", "default_scope_funcs", "debugger",
]
