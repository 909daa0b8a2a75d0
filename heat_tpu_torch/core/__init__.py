"""Core of heat_tpu_torch: types, devices, communication, the DNDarray, its operations
and the signature-cached executor they dispatch through, the array API (indexing,
manipulations, the distributed sort, random streams), linear algebra, I/O and
checkpoints, and the observability and supervision planes they report through (diagnostics,
profiler, resilience, forensics, telemetry, supervision, ops)."""

from . import diagnostics
from . import profiler
from . import forensics
from . import resilience
from . import telemetry
from . import supervision
from . import ops
from .forensics import explain
from ._executor import (
    executor_stats,
    reset_executor_stats,
    clear_executor_cache,
    reload_env_knobs,
    executor_warmup,
    executor_save_warmup,
    rebuild_scheduler,
)
from .constants import *
from .types import *
from .devices import *
from .communication import *
from .dndarray import *
from .factories import *
from .arithmetics import *
from .complex_math import *
from .exponential import *
from .indexing import *
from .logical import *
from .manipulations import *
from .memory import *
from .printing import *
from .relational import *
from .rounding import *
from .sanitation import *
from .signal import *
from .stride_tricks import *
from .tiling import *
from .trigonometrics import *
from .statistics import *
from .base import *
from .io import *
from .checkpoint import *
from . import linalg
from .linalg import *  # in the flat namespace too, as heat_tpu does
from .version import __version__
from . import (
    arithmetics,
    base,
    checkpoint,
    communication,
    complex_math,
    constants,
    devices,
    dist_sort,
    dndarray,
    exponential,
    io,
    factories,
    indexing,
    kernels,
    logical,
    manipulations,
    memory,
    printing,
    random,
    relational,
    rounding,
    sanitation,
    signal,
    statistics,
    stride_tricks,
    tiling,
    trigonometrics,
    types,
    version,
)
