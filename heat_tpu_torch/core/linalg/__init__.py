"""Distributed linear algebra (counterpart of heat_tpu/core/linalg/)."""

from . import basics, comm_plan, solver, svdtools
from . import qr as _qr_mod
from . import svd as _svd_mod

from .basics import *
from .qr import *
from .solver import *
from .svd import *
from .svdtools import *

__all__ = (
    list(basics.__all__) + list(_qr_mod.__all__) + list(solver.__all__)
    + list(_svd_mod.__all__) + list(svdtools.__all__)
)
