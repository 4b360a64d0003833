"""Persistence: save/load vars, inference models, training checkpoints.

Counterpart of ``paddle_tpu/fluid/io.py``, writing the same files: a
save or a load is a program of ``save`` / ``load`` (one file a
variable) or ``save_combine`` / ``load_combine`` (one file) host ops
run by the executor (``ops/io_ops.py``), in the JAX package's tensor
format (``utils/serialization.py``), so a directory either package
writes loads in the other.  An inference model is the pruned test
program with ``feed`` / ``fetch`` ops, serialized to ``__model__``,
beside its persistables.  A checkpoint is a serial directory
``checkpoint_<n>`` with ``__model__/`` (the persistables, then the
``_SUCCESS`` marker written atomically) and the trainer's arguments;
the newest 3 serials are kept.

A save first syncs every prepared program of the scope
(``flush_prepared``), so a save in the middle of a prepared loop writes
the state after its last step; a load writes the scope, and a prepared
program re-stages from it before its next step.

``set_scope_arrays`` / ``get_scope_arrays`` move numpy arrays in and out
of a scope (how the tests load the JAX package's startup results: the
two draw different random numbers from one seed).
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from paddle_tpu_torch.core import desc as core_desc
from paddle_tpu_torch.core.executor_impl import flush_prepared
from paddle_tpu_torch.core.fsutil import atomic_write
from paddle_tpu_torch.device import resolve_device

from .executor import _current_scope
from .framework import (Program, Parameter, Variable, default_main_program,
                        program_guard)

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_inference_program", "save_checkpoint",
    "load_checkpoint", "load_trainer_args", "clean_checkpoint",
    "get_latest_checkpoint_serial", "set_scope_arrays", "get_scope_arrays",
]


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def _save_load_vars(executor, dirname, main_program, predicate, op_type,
                    filename=None):
    if main_program is None:
        main_program = default_main_program()
    seen = set()
    uniq = []
    for v in main_program.list_vars():
        if predicate(v) and v.name not in seen:
            seen.add(v.name)
            uniq.append(v)
    prog = Program()
    with program_guard(prog):
        block = prog.global_block()
        for v in uniq:
            block.create_var(name=v.name, shape=v.shape,
                             dtype=v.proto_dtype,
                             persistable=True)
        if filename is None:
            for v in uniq:
                block.append_op(
                    type=op_type,
                    inputs={"X": [v.name]} if op_type == "save" else {},
                    outputs={} if op_type == "save" else {"Out": [v.name]},
                    attrs={"file_path": os.path.join(dirname, v.name)},
                    infer_shape=False)
        else:
            names = [v.name for v in uniq]
            path = {"file_path": os.path.join(dirname, filename)}
            if op_type == "save":
                block.append_op(type="save_combine", inputs={"X": names},
                                outputs={}, attrs=path, infer_shape=False)
            else:
                block.append_op(type="load_combine", inputs={},
                                outputs={"Out": names}, attrs=path,
                                infer_shape=False)
    os.makedirs(dirname, exist_ok=True)
    # a prepared program keeps its state on the device between steps:
    # sync it into the scope first, so a save writes the current values
    # (a load needs nothing: its writes move the scope's versions, and
    # a prepared program re-stages from the scope before its next step)
    flush_prepared(_current_scope())
    executor.run(prog)


def _by_names(vars_):
    names = {v.name if isinstance(v, Variable) else v for v in vars_}
    return lambda v: v.name in names


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    if vars is not None:
        predicate = _by_names(vars)
    _save_load_vars(executor, dirname, main_program, predicate, "save",
                    filename)


def save_params(executor, dirname, main_program=None, filename=None):
    _save_load_vars(executor, dirname, main_program, is_parameter, "save",
                    filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    _save_load_vars(executor, dirname, main_program, is_persistable, "save",
                    filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    if vars is not None:
        predicate = _by_names(vars)
    _save_load_vars(executor, dirname, main_program, predicate, "load",
                    filename)


def load_params(executor, dirname, main_program=None, filename=None):
    _save_load_vars(executor, dirname, main_program, is_parameter, "load",
                    filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    _save_load_vars(executor, dirname, main_program, is_persistable, "load",
                    filename)


# ---------------------------------------------------------------------------
# Inference models
# ---------------------------------------------------------------------------

def get_inference_program(target_vars, main_program=None):
    if main_program is None:
        main_program = default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    return main_program.clone(for_test=True).prune(target_vars)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, aot_feed_specs=None):
    """Write the test program pruned to ``target_vars``, with a ``feed``
    op per name of ``feeded_var_names`` and a ``fetch`` op per target
    (attr ``col``: the position), to ``model_filename`` (``__model__``),
    and the persistables of ``main_program`` beside it.
    ``aot_feed_specs`` ({feed_name: (shape, dtype)}): also trace the
    pruned program for those feed specs and save it beside the model as
    a ``torch.export`` program (``inference/aot.py``, the counterpart of
    the JAX package's serialized executable); the predictor and the
    serving engine then run it without lowering the ops."""
    if main_program is None:
        main_program = default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)
    inference_program = main_program.clone(for_test=True).prune(target_vars)
    # the feed and fetch names, recorded in the program by ops
    blk = inference_program.desc.blocks[0]
    for i, name in enumerate(feeded_var_names):
        blk.ops.insert(i, core_desc.OpDesc("feed", {}, {"Out": [name]},
                                           {"col": i}))
    for i, var in enumerate(target_vars):
        blk.ops.append(core_desc.OpDesc("fetch", {"X": [var.name]}, {},
                                        {"col": i}))
    inference_program.desc.bump_version()
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(inference_program.serialize_to_string())
    save_persistables(executor, dirname, main_program, params_filename)
    if aot_feed_specs:
        from paddle_tpu_torch.inference.aot import save_aot

        save_aot(dirname, inference_program, dict(aot_feed_specs),
                 [v.name for v in target_vars], _current_scope(),
                 executor.place)
    return inference_program


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch Variables) of an inference model
    either package wrote; its persistables go into the current scope."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        program = Program.parse_from_string(f.read())
    blk = program.desc.blocks[0]
    feed_names = [op.output("Out")[0] for op in blk.ops
                  if op.type == "feed"]
    fetch_names = [op.input("X")[0] for op in blk.ops if op.type == "fetch"]
    load_persistables(executor, dirname, program, params_filename)
    fetch_vars = [program.global_block().vars[n] for n in fetch_names
                  if n in program.global_block().vars]
    program._is_test = True
    return program, feed_names, fetch_vars


# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------

SUCCESS_MARK_FILENAME = "_SUCCESS"
CHECKPOINT_PREFIX = "checkpoint"
MODEL_DIR = "__model__"
TRAINER_PREFIX = "trainer"


def _checkpoint_dir(root, serial):
    return os.path.join(root, "%s_%d" % (CHECKPOINT_PREFIX, serial))


def get_latest_checkpoint_serial(checkpoint_dir):
    """The newest serial whose ``_SUCCESS`` marker exists, else -1."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return -1
    best = -1
    for d in os.listdir(checkpoint_dir):
        if not d.startswith(CHECKPOINT_PREFIX + "_"):
            continue
        try:
            serial = int(d.split("_")[-1])
        except ValueError:
            continue
        if os.path.exists(os.path.join(checkpoint_dir, d, MODEL_DIR,
                                       SUCCESS_MARK_FILENAME)):
            best = max(best, serial)
    return best


def _scroll_delete(checkpoint_dir, max_num_checkpoints=3):
    """Keep the newest ``max_num_checkpoints`` serial directories, ranked
    by serial (serials may have holes after a crash or a manual clean),
    and never touch a file that only looks like one."""
    serials = []
    for d in os.listdir(checkpoint_dir):
        if not d.startswith(CHECKPOINT_PREFIX + "_"):
            continue
        if not os.path.isdir(os.path.join(checkpoint_dir, d)):
            continue
        try:
            serials.append(int(d.split("_")[-1]))
        except ValueError:
            pass
    serials.sort(reverse=True)
    for serial in serials[max_num_checkpoints:]:
        shutil.rmtree(_checkpoint_dir(checkpoint_dir, serial),
                      ignore_errors=True)


def save_checkpoint(executor, checkpoint_dir, trainer_id=0,
                    trainer_args=None, main_program=None,
                    max_num_checkpoints=3):
    """Save the persistables of ``main_program`` as the next serial;
    returns the serial."""
    if checkpoint_dir is None:
        raise ValueError("checkpoint_dir is required")
    os.makedirs(checkpoint_dir, exist_ok=True)
    serial = get_latest_checkpoint_serial(checkpoint_dir) + 1
    cur_dir = _checkpoint_dir(checkpoint_dir, serial)
    model_dir = os.path.join(cur_dir, MODEL_DIR)
    os.makedirs(model_dir, exist_ok=True)
    if trainer_args:
        with open(os.path.join(cur_dir, "%s_%d" % (TRAINER_PREFIX,
                                                   trainer_id)), "w") as f:
            json.dump(trainer_args, f)
    save_persistables(executor, model_dir, main_program)
    # the marker commits the serial: written atomically, so a crash in
    # the middle of a save never leaves a torn marker behind
    atomic_write(os.path.join(model_dir, SUCCESS_MARK_FILENAME),
                 str(time.time()))
    _scroll_delete(checkpoint_dir, max_num_checkpoints)
    return serial


def load_checkpoint(executor, checkpoint_dir, serial=None,
                    main_program=None):
    """Load serial ``serial`` (None: the newest complete one); returns
    the serial."""
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir)
    if serial < 0:
        raise ValueError("no checkpoint found in %r" % checkpoint_dir)
    model_dir = os.path.join(_checkpoint_dir(checkpoint_dir, serial),
                             MODEL_DIR)
    load_persistables(executor, model_dir, main_program)
    return serial


def load_trainer_args(checkpoint_dir, serial, trainer_id):
    path = os.path.join(_checkpoint_dir(checkpoint_dir, serial),
                        "%s_%d" % (TRAINER_PREFIX, trainer_id))
    with open(path) as f:
        return json.load(f)


def clean_checkpoint(checkpoint_dir, delete_dir=False):
    _scroll_delete(checkpoint_dir, max_num_checkpoints=0)
    if delete_dir and not os.listdir(checkpoint_dir):
        os.rmdir(checkpoint_dir)


# ---------------------------------------------------------------------------
# numpy arrays in and out of a scope
# ---------------------------------------------------------------------------

def set_scope_arrays(scope, arrays, device=None):
    """Write ``{name: np.ndarray}`` into ``scope`` as tensors on
    ``device`` (None -> cuda, as for every entry point of the port)."""
    dev = resolve_device(device)
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if not arr.flags.writeable:     # torch.from_numpy wants writable
            arr = arr.copy()
        scope.set(name, torch.from_numpy(np.ascontiguousarray(arr)).to(dev))


def get_scope_arrays(scope, names):
    """``{name: np.ndarray}`` of ``names`` read from ``scope``."""
    out = {}
    for name in names:
        val = scope.find_var(name)
        out[name] = (val.detach().cpu().numpy()
                     if isinstance(val, torch.Tensor) else np.asarray(val))
    return out
