"""Dataset adapters of the port (counterpart of ``paddle_tpu/dataset``:
the modules the book models, the reader pipeline and the bench entry
read, numpy only, each a copy of the JAX package's).

Each module exposes ``train()``/``test()`` reader creators.  With no
network egress, modules parse the real files when cached under
``common.DATA_HOME`` and otherwise fall back to deterministic synthetic
data of the same shapes/dtypes (``<module>.is_synthetic()`` tells), the
reference's samples exactly."""
from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import flowers  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import wmt14  # noqa: F401

__all__ = ["common", "mnist", "cifar", "uci_housing", "flowers",
           "movielens", "conll05", "wmt14"]
