"""The end-to-end benchmark of heat_tpu_torch on NVIDIA H100 cards.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1`` runs one cell
of ``BENCHMARK.json`` once and prints one JSON line. The harness is driven by data: a cell
names a configuration (``configs/``) and a traffic mix (``traffic/``); the mix names its
driver (``drivers/``); every metric is a reader of its own (``metrics/<name>.py``); every
configuration has a plain reference (``reference/<config>.py``) and every cell the limits
of its comparison (``limits/<cell>.json``). Nothing here imports JAX or heat_tpu.
"""
