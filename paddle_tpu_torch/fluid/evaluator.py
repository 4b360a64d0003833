"""Program-state evaluators.

Counterpart of paddle_tpu/fluid/evaluator.py, a copy (reference
python/paddle/fluid/evaluator.py): an Evaluator appends its metric and
accumulation ops to the MAIN program, over persistable state vars, with
reset / eval programs of their own; ChunkEvaluator and EditDistance.

Deprecated in the reference in favor of fluid.metrics (host-side
accumulation); provided for API parity.  The accumulate ops ride the
train program, so states update on every executor.run like any other
persistable — call ``reset(exe)`` once after the startup program to
zero them.  DetectionMAP has no evaluator here: the reference version
threads accumulation state through detection_map's op attrs; use
layers.detection_map per batch instead."""
from __future__ import annotations

import numpy as np

from . import layers, unique_name
from .framework import Program, Variable, program_guard
from .layer_helper import LayerHelper

__all__ = ["ChunkEvaluator", "EditDistance"]


def _clone_var_(block, var):
    assert isinstance(var, Variable)
    return block.create_var(name=var.name, shape=var.shape,
                            dtype=var.dtype, persistable=True)


class Evaluator(object):
    """Base: subclasses append their metric + accumulation ops in
    __init__ (inside the main program), and implement eval()."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        """Zero every state (run between epochs / eval passes)."""
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                g_var = _clone_var_(reset_program.current_block(), var)
                layers.fill_constant(shape=g_var.shape, value=0.0,
                                     dtype=g_var.dtype, out=g_var)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def create_state(self, suffix, dtype, shape):
        state = self.helper.create_variable(
            name="_".join([unique_name.generate(self.helper.name), suffix]),
            persistable=True, dtype=dtype, shape=list(shape))
        self.states.append(state)
        return state

    def _fetch_states(self, executor, eval_program=None):
        """Read the accumulated state values through a fetch-only
        program (states are persistable: fetching reads the scope)."""
        if eval_program is None:
            eval_program = Program()
        block = eval_program.current_block()
        clones = [_clone_var_(block, s) for s in self.states]
        return [np.asarray(v)
                for v in executor.run(eval_program, fetch_list=clones)]


class ChunkEvaluator(Evaluator):
    """Streaming chunk-level precision/recall/F1 (reference
    evaluator.py:114): accumulates num_infer/num_label/num_correct
    chunk counts across batches."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super().__init__("chunk_eval")
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.num_infer_chunks = self.create_state(
            suffix="num_infer_chunks", dtype="int64", shape=[1])
        self.num_label_chunks = self.create_state(
            suffix="num_label_chunks", dtype="int64", shape=[1])
        self.num_correct_chunks = self.create_state(
            suffix="num_correct_chunks", dtype="int64", shape=[1])
        precision, recall, f1_score, num_infer_chunks, num_label_chunks, \
            num_correct_chunks = layers.chunk_eval(
                input=input, label=label, chunk_scheme=chunk_scheme,
                num_chunk_types=num_chunk_types,
                excluded_chunk_types=excluded_chunk_types)
        layers.sums(input=[self.num_infer_chunks, num_infer_chunks],
                    out=self.num_infer_chunks)
        layers.sums(input=[self.num_label_chunks, num_label_chunks],
                    out=self.num_label_chunks)
        layers.sums(input=[self.num_correct_chunks, num_correct_chunks],
                    out=self.num_correct_chunks)
        self.metrics.extend((precision, recall, f1_score))

    def eval(self, executor, eval_program=None):
        infer, label, correct = (
            float(v.ravel()[0]) for v in
            self._fetch_states(executor, eval_program))
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return np.array([precision], dtype="float32"), \
            np.array([recall], dtype="float32"), \
            np.array([f1], dtype="float32")


class EditDistance(Evaluator):
    """Streaming average edit distance + instance error rate (reference
    evaluator.py:179): accumulates total distance, sequence count and
    the number of sequences with distance > 0."""

    def __init__(self, input, label, ignored_tokens=None):
        super().__init__("edit_distance")
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.total_distance = self.create_state(
            suffix="total_distance", dtype="float32", shape=[1])
        self.seq_num = self.create_state(
            suffix="seq_num", dtype="int64", shape=[1])
        self.instance_error = self.create_state(
            suffix="instance_error", dtype="float32", shape=[1])
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)

        zero = layers.fill_constant(shape=[1], value=0.0, dtype="float32")
        compare_result = layers.greater_than(distances, zero)
        compare_result = layers.cast(compare_result, dtype="float32")
        instance_error = layers.reduce_sum(compare_result)
        total_distance = layers.reduce_sum(distances)
        layers.sums(input=[self.total_distance, total_distance],
                    out=self.total_distance)
        layers.sums(input=[self.seq_num, seq_num], out=self.seq_num)
        layers.sums(input=[self.instance_error, instance_error],
                    out=self.instance_error)
        self.metrics.append(total_distance)
        self.metrics.append(instance_error)

    def eval(self, executor, eval_program=None):
        total, n, err = (
            float(v.ravel()[0]) for v in
            self._fetch_states(executor, eval_program))
        avg_distance = total / n if n else 0.0
        avg_instance_error = err / n if n else 0.0
        return np.array([avg_distance], dtype="float32"), \
            np.array([avg_instance_error], dtype="float32")
