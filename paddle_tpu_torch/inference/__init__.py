"""Inference library: config + predictor API.

Counterpart of ``paddle_tpu/inference/__init__.py``.  Parity: reference
paddle/contrib/inference/paddle_inference_api.h (PaddleTensor:40,
PaddlePredictor:61 with Run/Clone, NativeConfig:89,
create_paddle_predictor factory) and the analysis passes of
paddle/fluid/inference/analysis/ (here: the inference transpiler's
BN fold, attention and layer-norm fusions, and optional bf16, applied
at load time under AnalysisConfig).

A predictor owns one Scope + Executor over the loaded inference
program; ``clone()`` shares the weights scope (the reference's
thread-sharing contract), the executor and the AOT program.  PaddleBuf /
void* disappear — numpy arrays are the buffer type.

The config runs on the card by default (``use_gpu=True``, the original
Paddle's name; the JAX package's ``use_tpu`` is accepted as its alias):
without one, creating the predictor raises RuntimeError, and
``use_gpu=False`` runs it on the CPU.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["PaddleTensor", "NativeConfig", "AnalysisConfig",
           "create_paddle_predictor", "PaddlePredictor"]


class PaddleTensor:
    """name + numpy data (+ optional level-1 LoD offsets)."""

    __slots__ = ("name", "data", "lod")

    def __init__(self, name=None, data=None, lod=None):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        self.lod = lod

    @property
    def shape(self):
        return None if self.data is None else list(self.data.shape)

    @property
    def dtype(self):
        return None if self.data is None else self.data.dtype

    def __repr__(self):
        return "PaddleTensor(%r, shape=%s)" % (self.name, self.shape)


class NativeConfig:
    """reference NativeConfig: model_dir OR (prog_file, param_file);
    ``use_gpu`` (default True: the card) picks the device, ``use_tpu``
    is its alias."""

    def __init__(self, model_dir=None, prog_file=None, param_file=None,
                 use_gpu=True, use_aot=True, use_tpu=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.param_file = param_file
        self.use_gpu = bool(use_gpu if use_tpu is None else use_tpu)
        # load the exported program when the model dir has one
        self.use_aot = use_aot

    @property
    def use_tpu(self):
        return self.use_gpu


class AnalysisConfig(NativeConfig):
    """NativeConfig + analysis passes applied at load: the inference
    transpiler (BN fold, attention and layer-norm fusion) and optional
    bf16 (Float16Transpiler)."""

    def __init__(self, *args, fold_batch_norm=True, use_bf16=False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.fold_batch_norm = fold_batch_norm
        self.use_bf16 = use_bf16


class PaddlePredictor:
    def __init__(self, config, _shared=None):
        import paddle_tpu_torch.fluid as fluid

        self.config = config
        self.place = (fluid.CUDAPlace(0) if config.use_gpu
                      else fluid.CPUPlace())
        if _shared is not None:
            # clone(): share weights scope + program + executor + AOT
            (self.scope, self.program, self.feed_names,
             self.fetch_vars, self.exe, self.aot) = _shared
            return
        self.scope = fluid.Scope()
        # raises RuntimeError for the card when there is none
        self.exe = fluid.Executor(self.place)
        with fluid.scope_guard(self.scope):
            if config.model_dir:
                dirname, mf, pf = config.model_dir, None, None
            else:
                dirname = os.path.dirname(config.prog_file)
                mf = os.path.basename(config.prog_file)
                pf = (os.path.basename(config.param_file)
                      if config.param_file else None)
            prog, feeds, fetches = fluid.io.load_inference_model(
                dirname, self.exe, model_filename=mf,
                params_filename=pf)
            if isinstance(config, AnalysisConfig):
                if config.fold_batch_norm:
                    fluid.transpiler.InferenceTranspiler().transpile(
                        prog, scope=self.scope)
                if config.use_bf16:
                    fluid.transpiler.Float16Transpiler().transpile(prog)
        self.program = prog
        self.feed_names = list(feeds)
        self.fetch_vars = fetches
        # The exported program (save_inference_model aot_feed_specs):
        # serve without lowering the ops when the feed matches.  Skipped
        # when ANY analysis pass ran — BN-fold mutates the parameter
        # scope and bf16 rewrites the program, but the artifact was
        # traced from the exact exported program, so serving it against
        # transpiled state would be silently wrong.
        analyzed = isinstance(config, AnalysisConfig) and (
            config.fold_batch_norm or config.use_bf16)
        self.aot = None
        if getattr(config, "use_aot", True) and not analyzed:
            from .aot import load_aot
            self.aot = load_aot(dirname, self.scope, self.place)

    def run(self, inputs):
        """inputs: list[PaddleTensor] (or dict name->array).  Returns
        list[PaddleTensor] for the model's fetch targets."""
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.core.lod import LoDTensor

        if isinstance(inputs, dict):
            feed = dict(inputs)
        else:
            feed = {}
            for i, t in enumerate(inputs):
                name = t.name or self.feed_names[i]
                feed[name] = (LoDTensor(t.data, t.lod) if t.lod
                              else t.data)
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds %r (model expects %r)" %
                             (missing, self.feed_names))
        if self.aot is not None and self.aot.matches(feed):
            outs = self.aot.run(feed)  # no op lowered
        else:
            with fluid.scope_guard(self.scope):
                outs = self.exe.run(self.program, feed=feed,
                                    fetch_list=self.fetch_vars)
        return [PaddleTensor(name=getattr(v, "name", str(i)),
                             data=np.asarray(o))
                for i, (v, o) in enumerate(zip(self.fetch_vars, outs))]

    # reference PaddlePredictor::Run's output-pointer style
    Run = run

    def clone(self):
        """Predictor sharing this one's weights (reference Clone: the
        cloned predictor is cheap and shares the model)."""
        return PaddlePredictor(
            self.config,
            _shared=(self.scope, self.program, self.feed_names,
                     self.fetch_vars, self.exe, self.aot))

    Clone = clone


def create_paddle_predictor(config):
    """Factory (reference create_paddle_predictor<NativeConfig>)."""
    return PaddlePredictor(config)
