"""Data utilities (counterpart of heat_tpu/utils/data/): the input pipeline (``Dataset``,
``DataLoader``, the shuffles, ``PartialH5Dataset``, ``MNISTDataset``, the TFRecord
helpers), ``spherical`` and ``matrixgallery``."""

from .datatools import *
from .mnist import MNISTDataset
from .partial_dataset import *
from . import _utils, datatools, matrixgallery, mnist, partial_dataset, spherical
from .matrixgallery import hermitian, parter, random_known_rank, random_known_singularvalues
