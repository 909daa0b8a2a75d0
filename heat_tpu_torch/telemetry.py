"""``ht.telemetry``: public alias of :mod:`heat_tpu_torch.core.telemetry` and the
``python -m heat_tpu_torch.telemetry`` CLI entry point (``merge``, ``top``, ``slow``).

All state lives in :mod:`heat_tpu_torch.core.telemetry` (one instance per process);
this module re-exports its surface so ``ht.telemetry.merge(...)`` and
``python -m heat_tpu_torch.telemetry merge --dir shards/`` both work.
"""

from .core.telemetry import *  # noqa: F401,F403
from .core.telemetry import main  # noqa: F401

if __name__ == "__main__":
    import sys

    sys.exit(main())
