"""train_mfu: model FLOPs of every step in the window (``lib.work.seq2seq_step_flops``,
from shapes alone) over the window's seconds, as a share of the card's TF32 dense peak, the
fastest rate of any float32 product on it."""

from portbench.lib import work


def read(run):
    if run.trace is not None or not run.iterations:
        return None
    return 100.0 * run.work["model_flops"] * run.iterations / run.window_s / work.TF32_FLOPS
