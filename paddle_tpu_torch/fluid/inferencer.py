"""High-level Inferencer: rebuild the inference graph from
``infer_func``, load the persistables under ``param_path``, run feeds.

Counterpart of ``paddle_tpu/fluid/inferencer.py``.  The place defaults
to ``CUDAPlace(0)``, as the Trainer's does, and raises without a card.
"""
from __future__ import annotations

import contextlib

from paddle_tpu_torch.core.scope import Scope

from . import framework
from . import io
from . import unique_name
from .executor import Executor, scope_guard
from .trainer import check_and_get_place

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(self, infer_func, param_path, place=None,
                 parallel=False):
        self.param_path = param_path
        self.scope = Scope()
        self.parallel = parallel
        self.place = check_and_get_place(place)

        self.inference_program = framework.Program()
        startup = framework.Program()
        with framework.program_guard(self.inference_program, startup):
            with unique_name.guard():
                self.predict_var = infer_func()
        self.inference_program = \
            self.inference_program.clone(for_test=True)

        self.exe = Executor(self.place)
        with self._prog_and_scope_guard():
            self.exe.run(startup)
            io.load_persistables(self.exe, param_path,
                                 self.inference_program)

    def infer(self, inputs, return_numpy=True):
        """inputs: {var name: numpy array}."""
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs must be a dict of {var_name: numpy array}")
        with self._prog_and_scope_guard():
            return self.exe.run(self.inference_program, feed=inputs,
                                fetch_list=[self.predict_var.name],
                                return_numpy=return_numpy)

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with framework.program_guard(self.inference_program):
            with scope_guard(self.scope):
                yield
