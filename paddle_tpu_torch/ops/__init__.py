"""The port's operator library: importing this package registers every
op (counterpart of ``paddle_tpu/ops``; only the ops that the
transformer LM's and ResNet's training steps, plain and fused, and their
optests reach are ported so far)."""
from . import math  # noqa: F401
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import metric  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import random  # noqa: F401
from . import parallel_ops  # noqa: F401
from . import fused_ops  # noqa: F401
