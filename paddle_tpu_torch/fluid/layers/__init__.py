"""Layer API: functions that append ops to the current program
(counterpart of paddle_tpu/fluid/layers: every module but
``detection``; ``nn``'s layers whose ops are not ported raise)."""
from . import tensor
from .tensor import *  # noqa: F401,F403
from . import nn
from .nn import *  # noqa: F401,F403
from . import ops
from .ops import *  # noqa: F401,F403
from . import io
from .io import *  # noqa: F401,F403
from . import metric_op
from .metric_op import *  # noqa: F401,F403
from . import control_flow
from .control_flow import *  # noqa: F401,F403
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import sequence_op
from .sequence_op import *  # noqa: F401,F403

__all__ = (tensor.__all__ + nn.__all__ + ops.__all__ + io.__all__
           + metric_op.__all__ + control_flow.__all__
           + learning_rate_scheduler.__all__ + sequence_op.__all__)
