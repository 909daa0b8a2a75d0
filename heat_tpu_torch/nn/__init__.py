"""Neural-network layers of heat_tpu_torch (counterpart of heat_tpu.nn).

The module zoo (:mod:`.modules`: thin subclasses of torch's modules under heat_tpu's names,
starting in eval mode and taking heat_tpu's PRNG keys), ``nn.functional``
(:mod:`.functional`), the recurrent layers (:mod:`.recurrent`), heat_tpu's attention stack
(:mod:`.attention`: the attentions run the flash kernel K2 on the card and its backward
K4/K5 in training; ring, zigzag and Ulysses attention over a sequence split), and the
data-parallel wrappers (:mod:`.data_parallel`).
"""

from .data_parallel import *
from .modules import *
from .attention import *
from .recurrent import *
from . import attention, data_parallel, functional, modules, recurrent
