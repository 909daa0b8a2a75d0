"""heat_tpu_torch — heat_tpu's distributed n-D arrays on PyTorch and CUDA.

The PyTorch/CUDA port of heat_tpu, beside it in the same repository and held against it
by the tests. A DNDarray holds this rank's local ``torch.Tensor``; ranks talk over
``torch.distributed``. Usage mirrors heat_tpu::

    import heat_tpu_torch as ht
    x = ht.arange(10, split=0)
    x.sum()

Entry points run on the CUDA card unless the caller asks for the CPU
(``ht.use_device("cpu")`` or ``device="cpu"``). Hand-written kernels are built at their
first launch, so importing the package needs neither CUDA nor nvcc.
"""

from .core import *
from .core import __version__
from . import core
from .core import random
from .core import diagnostics
from .core import forensics
from .core import ops
from .core import profiler
from .core import resilience
from .core import supervision
from . import telemetry
from . import spatial
from . import fft
from . import sparse
from . import preprocessing
from . import naive_bayes
from . import regression
from . import classification
from . import datasets
from . import graph
from . import cluster
from . import nn
from . import optim
from . import interop
from . import utils
from . import testing
from . import serving
