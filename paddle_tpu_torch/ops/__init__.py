"""The port's operator library: importing this package registers every
op (counterpart of ``paddle_tpu/ops``; only the ops that the
transformer LM's, ResNet's and VGG16-BN's training steps, plain and
fused, sparse embeddings and their optests reach are ported so far,
the host IO ops, the sequence (LoD) ops with ``adagrad``, and the
control-flow ops)."""
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
