"""The port's operator library: importing this package registers every
op (counterpart of ``paddle_tpu/ops``: ``math``, ``tensor``, ``loss``,
``random``, ``optimizer_ops``, ``parallel_ops``, ``fused_ops``,
``io_ops``, ``sequence``, ``control_flow``, ``nn``, ``metric``,
``crf_ctc``, ``beam_search``, ``detection``, ``misc`` and
``reader_ops``; the concurrency and distributed ops are not ported
yet)."""
from . import math  # noqa: F401
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import metric  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import random  # noqa: F401
from . import parallel_ops  # noqa: F401
from . import fused_ops  # noqa: F401
from . import io_ops  # noqa: F401
from . import sequence  # noqa: F401
from . import control_flow  # noqa: F401
from . import crf_ctc  # noqa: F401
from . import beam_search  # noqa: F401
from . import detection  # noqa: F401
from . import misc  # noqa: F401
from . import reader_ops  # noqa: F401
