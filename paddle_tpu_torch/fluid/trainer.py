"""High-level Trainer: an event-driven training loop with checkpoints
and resume.

Counterpart of ``paddle_tpu/fluid/trainer.py``: the events,
``CheckpointConfig`` and ``Trainer`` (``train``, ``test``, ``stop``,
``save_params``, ``save_inference_model``).  The loop trains through the
prepared step (``Executor.prepare`` / ``run_prepared``; on a card one
CUDA graph replay a step) and runs a program the prepared step refuses
through ``run()``: host ops (ValueError) and, on a card, a step a graph
cannot replay (``Uncapturable``).  A checkpoint records the next step to
run, so a resumed run neither repeats nor skips a step.

The place defaults to ``CUDAPlace(0)`` and, without a card, raises: the
CPU is asked for with ``place=CPUPlace()``.  Not ported: the
``PADDLE_TRAINING_ROLE`` pserver / trainer contract (ROADMAP queue 1
item 10), and the JAX package's metric history sampler and numerics
loss ring (item 11).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np

from paddle_tpu_torch.core.executor_impl import (PreparedShapeMismatch,
                                                 Uncapturable)
from paddle_tpu_torch.core.place import CUDAPlace
from paddle_tpu_torch.core.scope import Scope

from . import framework
from . import io
from . import optimizer as opt_module
from . import unique_name
from .data_feeder import DataFeeder
from .executor import Executor, scope_guard

__all__ = ["Trainer", "BeginEpochEvent", "EndEpochEvent",
           "BeginStepEvent", "EndStepEvent", "CheckpointConfig"]


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        # a handler may turn this off to skip fetching metrics this step
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10):
        self.checkpoint_dir = checkpoint_dir or os.getcwd()
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(1, epoch_interval)
        self.step_interval = step_interval if step_interval >= 1 else 10
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None
        self.is_pserver = False


def check_and_get_place(place):
    """``place``, or ``CUDAPlace(0)`` (the reference's default), which
    raises when an executor resolves it without a card: the port never
    drops to the CPU by itself."""
    return place if place is not None else CUDAPlace(0)


class Trainer:
    """``train_func()`` builds the forward graph and returns [loss, ...];
    ``optimizer_func()`` returns the Optimizer.  The constructor builds
    the train, test and startup programs, runs the startup program, and
    restores the newest checkpoint when ``checkpoint_config`` names a
    directory holding one, then the persistables under ``param_path``."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        if "PADDLE_TRAINING_ROLE" in os.environ:
            raise NotImplementedError(
                "PADDLE_TRAINING_ROLE=%s: the pserver / trainer transpile "
                "is not ported to paddle_tpu_torch yet (ROADMAP queue 1 "
                "item 10)" % os.environ["PADDLE_TRAINING_ROLE"])
        self.__stop = False
        self.parallel = parallel
        self.trainer_id = 0
        self.checkpoint_cfg = checkpoint_config
        if self.checkpoint_cfg:
            assert isinstance(self.checkpoint_cfg, CheckpointConfig)
            serial = io.get_latest_checkpoint_serial(
                self.checkpoint_cfg.checkpoint_dir)
            self.checkpoint_cfg.load_serial = \
                serial if serial >= 0 else None

        self.scope = Scope()
        self.startup_program = framework.Program()
        self.train_program = framework.Program()

        with framework.program_guard(self.train_program,
                                     self.startup_program):
            # a fresh name scope: the names are the same in every
            # Trainer, so a new one resumes from an earlier one's
            # checkpoints
            with unique_name.guard():
                outs = train_func()
                self.train_func_outputs = outs if isinstance(outs, list) \
                    else [outs]
                self.test_program = \
                    self.train_program.clone(for_test=True)
                loss = self.train_func_outputs[0]
                opt = optimizer_func()
                if not isinstance(opt, opt_module.Optimizer):
                    raise TypeError(
                        "optimizer_func must return an Optimizer")
                opt.minimize(loss)

        self.place = check_and_get_place(place)

        with self._prog_and_scope_guard():
            exe = Executor(self.place)
            exe.run(self.startup_program)

        if self.checkpoint_cfg and self.checkpoint_cfg.load_serial \
                is not None:
            with self._prog_and_scope_guard():
                io.load_checkpoint(exe, self.checkpoint_cfg.checkpoint_dir,
                                   self.checkpoint_cfg.load_serial,
                                   self.train_program)
            if not self.checkpoint_cfg.is_pserver:
                args = io.load_trainer_args(
                    self.checkpoint_cfg.checkpoint_dir,
                    self.checkpoint_cfg.load_serial, self.trainer_id)
                self.checkpoint_cfg.epoch_id = int(args["epoch_id"])
                self.checkpoint_cfg.step_id = int(args["step_id"])

        if param_path and os.path.isdir(param_path):
            with self._prog_and_scope_guard():
                io.load_persistables(exe, param_path, self.train_program)

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with framework.program_guard(self.train_program,
                                     self.startup_program):
            with scope_guard(self.scope):
                yield

    # ------------------------------------------------------------------
    def stop(self):
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None,
              feed_order=None):
        self._train_by_executor(num_epochs, event_handler, reader,
                                feed_order)

    def test(self, reader, feed_order=None):
        """The mean of each of train_func's outputs over the test
        reader."""
        feeder = self._feeder(feed_order, self.test_program)
        exe = Executor(self.place)
        totals = None
        count = 0
        with scope_guard(self.scope):
            for minibatch in reader():
                feed = feeder.feed(minibatch)
                outs = exe.run(self.test_program, feed=feed,
                               fetch_list=[v.name for v in
                                           self.train_func_outputs])
                vals = [float(np.ravel(np.asarray(o))[0]) for o in outs]
                totals = vals if totals is None else \
                    [a + b for a, b in zip(totals, vals)]
                count += 1
        return [t / max(count, 1) for t in (totals or [])]

    def save_params(self, param_path):
        with self._prog_and_scope_guard():
            exe = Executor(self.place)
            io.save_persistables(exe, param_path, self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        with self._prog_and_scope_guard():
            exe = Executor(self.place)
            io.save_inference_model(
                param_path, feeded_var_names,
                [self.train_func_outputs[i]
                 for i in target_var_indexes], exe,
                main_program=self.train_program)

    # ------------------------------------------------------------------
    def _feeder(self, feed_order, program):
        if feed_order is None:
            raise ValueError(
                "feed_order is required (list of data-layer names, "
                "matching the reader's sample fields)")
        with framework.program_guard(program):
            return DataFeeder(feed_list=list(feed_order), place=self.place,
                              program=program)

    def _train_by_executor(self, num_epochs, event_handler, reader,
                           feed_order):
        feeder = self._feeder(feed_order, self.train_program)
        exe = Executor(self.place)
        metrics = [v.name for v in self.train_func_outputs]
        start_epoch = (self.checkpoint_cfg.epoch_id
                       if self.checkpoint_cfg else 0)
        # the prepared step keeps the parameters and optimizer state on
        # the device between steps; the metrics come to the host only
        # when the handler asks for them
        prepared = None  # None: not tried yet; False: run() this program
        with scope_guard(self.scope):
            try:
                for epoch_id in range(start_epoch, num_epochs):
                    event_handler(BeginEpochEvent(epoch_id))
                    for step_id, minibatch in enumerate(reader()):
                        if self.__stop:
                            if self.checkpoint_cfg:
                                self._clean_checkpoint()
                            return
                        # resuming in the middle of an epoch: skip the
                        # steps the checkpoint holds
                        if (self.checkpoint_cfg and
                                epoch_id == start_epoch and
                                step_id < self.checkpoint_cfg.step_id):
                            continue
                        begin = BeginStepEvent(epoch_id, step_id)
                        event_handler(begin)
                        feed = feeder.feed(minibatch)
                        if prepared and prepared.is_stale:
                            # the program changed: sync, prepare again
                            prepared.sync_scope()
                            prepared = None
                        if prepared is None:
                            try:
                                prepared = exe.prepare(
                                    self.train_program, feed_specs=feed,
                                    fetch_list=metrics)
                            except (ValueError, Uncapturable):
                                prepared = False
                        vals = self._run_one_step(exe, prepared, feed,
                                                  metrics,
                                                  begin.fetch_metrics)
                        if (self.checkpoint_cfg and
                                step_id %
                                self.checkpoint_cfg.step_interval == 0
                                and epoch_id %
                                self.checkpoint_cfg.epoch_interval == 0):
                            # the cursor is the NEXT step: the parameters
                            # hold this step's update already.  The save
                            # syncs the prepared state first.
                            self._save_checkpoint(epoch_id, step_id + 1)
                        event_handler(EndStepEvent(epoch_id, step_id,
                                                   vals))
                    if self.checkpoint_cfg:
                        # the epoch rolls over: a resume starts at step 0
                        self._save_checkpoint(epoch_id + 1, 0)
                    event_handler(EndEpochEvent(epoch_id))
                if self.checkpoint_cfg:
                    self._clean_checkpoint()
            finally:
                # leave the scope whole for test() and save_params()
                if prepared:
                    prepared.sync_scope()

    def _run_one_step(self, exe, prepared, feed, metrics, fetch_metrics):
        if prepared:
            try:
                outs = prepared.run_prepared(feed,
                                             return_numpy=fetch_metrics)
                return outs if fetch_metrics else []
            except PreparedShapeMismatch:
                # a batch of another shape (a last, partial minibatch):
                # run() takes it from the flushed state
                pass
        if fetch_metrics:
            outs = exe.run(self.train_program, feed=feed,
                           fetch_list=metrics)
            return [np.asarray(o) for o in outs]
        exe.run(self.train_program, feed=feed, fetch_list=[])
        return []

    def _save_checkpoint(self, epoch_id, step_id):
        exe = Executor(self.place)
        io.save_checkpoint(
            exe, self.checkpoint_cfg.checkpoint_dir,
            trainer_id=self.trainer_id,
            trainer_args={"epoch_id": epoch_id, "step_id": step_id},
            main_program=self.train_program,
            max_num_checkpoints=self.checkpoint_cfg.max_num_checkpoints)

    def _clean_checkpoint(self):
        io.clean_checkpoint(self.checkpoint_cfg.checkpoint_dir)
