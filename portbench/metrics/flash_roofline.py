"""flash_roofline: the least time of a training step's attention work (its products,
``lib.work.seq2seq_attention_flops``, at float32 attention's rate on the tensor cores, plus
the D pass's bytes at the HBM bandwidth) over the device time of the step's flash-attention
kernels (K2 or K3, D, K4, K5: every kernel whose name begins ``flash_attention``). Counted
from shapes alone, it reads the same work whatever kernels compute the attention."""

from portbench.lib import work

KERNELS = ("flash_attention",)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    least = (run.work["attention_flops"] / work.F32_ATTENTION_FLOPS
             + run.work["d_bytes"] / work.HBM_BYTES_PER_S)
    return 100.0 * least * run.trace.iterations / seconds
