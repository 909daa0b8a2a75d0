"""Neural-network layers of heat_tpu_torch (counterpart of heat_tpu.nn).

``torch.nn``'s module zoo is re-exported as it is (:mod:`.modules`); what the port adds
is heat_tpu's attention stack (:mod:`.attention`), whose attentions run the flash kernel
K2 on the card and its backward K4/K5 in training, and the data-parallel wrappers
(:mod:`.data_parallel`).
"""

from .data_parallel import *
from .modules import *
from .attention import *
from . import attention, data_parallel, modules
