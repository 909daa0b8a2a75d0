"""Neural-network layers of heat_tpu_torch (counterpart of heat_tpu.nn).

``torch.nn``'s module zoo is re-exported as it is (:mod:`.modules`); what the port adds
is heat_tpu's attention stack (:mod:`.attention`), whose attentions run the flash kernel
K2 on the card.
"""

from .modules import *
from .attention import *
from . import attention, modules
