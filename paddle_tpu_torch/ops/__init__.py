"""The port's operator library: importing this package registers every
op (counterpart of ``paddle_tpu/ops``: ``math``, ``tensor``, ``loss``,
``random``, ``optimizer_ops``, ``parallel_ops``, ``fused_ops``,
``io_ops``, ``sequence``, ``control_flow``, ``nn`` but the
conv family, ``metric`` but ``auc`` and ``precision_recall``;
``crf_ctc`` and ``beam_search`` whole; ``detection``, ``misc``, the reader,
concurrency and distributed ops are not ported yet)."""
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
