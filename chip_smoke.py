#!/usr/bin/env python3
"""Drive heat_tpu_torch's main paths on one CUDA card and check them end to end.

    python3 chip_smoke.py [--json-out FILE]

Three paths, at fixed sizes (the constants below): ``KMeans.fit`` on 10,000,000 x 64 f32,
k = 8; one forward of the Transformer-base model (``heat_tpu_torch.nn.Transformer()`` at
its defaults: d_model 512, 8 heads, 6 + 6 layers, d_ff 2048) on src (8, 4096, 512) and
tgt (8, 2048, 512) f32 with a causal target, which runs the flash kernel K2 18 times; and
one training step of the Transformer-base seq2seq model of
examples/nn/seq2seq_transformer_torch.py (37,000-token vocabulary, 12 sequences of 2048
source and 2048 target tokens, a split=0 batch, ``DataParallel`` and
``DataParallelOptimizer("adam")`` under the paper's warmup schedule), which runs K2, the D
pass, K4 and K5 18 times each. The forward and the step run again with
``HEAT_TPU_FLASH_PIPELINE=1``, which sends every flash forward to K3, the pipelined kernel,
in place of K2; and bench.py's attention A/B times causal attention with the knob off and on.
Then the linear algebra of north-star configs #2 (``matmul`` of a split-0 and a split-1
4096² f32 array) and #4 (``hsvd_rank`` of a rank-10 2048 × 32768 f32 array, split=1), and
the rest of ``heat_tpu_torch.linalg`` at small sizes; the array API, the clustering
estimators, and the FFTs, scalers, GaussianNB, Lasso, KNN and the DCSR matrix at the sizes
their users run; and the training job's state and data: the step under DASO with a
checkpoint and a resume, DASO's sync, and the I/O formats.

Phases, one line each:
  1. the card: nvidia-smi's name and power limit, and torch's device name;
  2. build every ported kernel from the sources in this checkout (one nvcc per source,
     all started together), with each kernel instance's registers and spill bytes (ptxas)
     and its instructions and tensor-core (HMMA) instructions (cuobjdump -sass); every
     instance of K2, K3, K4 and K5 must hold HMMA. The KMeans path (3-5) waits only for
     K1's build, so K3's and the backward's run on beside it; the host-bound k-means++
     path waits for them all; ``[daso_sync]`` and ``[io]`` (12c), which launch no
     kernel, run first;
  3. north-star #1: ``arange(10, split=0).sum()`` on the card is 45;
  4. K1 against its plain PyTorch version and against float64 on the card, within the
     rounding bound of its own summation order (``kmeans.rounding_depths``), at the main
     path's shape and data and at edge shapes (n below one tile and one row past it, d of
     7, 10, 48, 100 and 256, k of 1 and 12, x 4 bytes past a 16-byte boundary, and d = k = 4,
     Spectral's embedding in float32, at 16,384 rows), each also
     on data rounded to integers (where nothing rounds, so the sums must be exact); below
     200,000 rows the sums equal their order replayed on the host bit for bit; every case
     bit-identical across two runs;
  5. the KMeans path, ``KMeans.fit`` at 10M x 64, k = 8, ``max_iter=30``, ``tol=-1``,
     split=0 (the configuration of bench.py's KMeans benchmark): launch counts are zeroed
     just before it and read just after; the result is checked against the blobs' true
     centers and, on a small input, against the port's CPU path; then the fit is timed
     (best of 2 after the counted run, which is its warm-up), and one fit is traced with
     torch.profiler for its device time by kind of kernel, the card's idle share and the
     host's time an iteration beyond the device's; then the same fit with
     ``init="kmeans++"`` (``[kmeans_pp_fit]``): the greedy ++ seeding's picks against the
     CPU path's on a CPU copy (equal, or each difference within the rounding bound of its
     step), launch counts zeroed and read (31 K1), the fit against the blobs' centers
     (where every blob holds a seed; else its inertia at most its seeds'), the Lloyd loop
     from the seeds reading back nothing but n_iter and the inertia, the seeding and the
     fit timed and one fit traced;
  6. K2 against its plain PyTorch version on the card, in O and LSE: at the Transformer
     forward's three attention shapes in f32, at bench.py's attention configuration (b8
     h16 t4096 d64 bf16, causal, and with its padding mask), at small ragged shapes
     with a fully masked row, and around the forwards' tiles and blocks (lengths one off
     them, d of 8, 72 and 96); bit-identical across two runs;
  7. K3 against its plain PyTorch version and against K2 on the card, in O and LSE: at the
     forward's three shapes and the step's two (f32), at bench.py's two, at small ragged
     shapes (d of 32, 33, 100 and 128, f16, causal with Tk > Tq and Tq > Tk, a bool mask
     with a fully masked row), with a float bias and at K2's tile edges; bit-identical
     across two runs; then ``scaled_dot_product_attention``, K2 and K3 timed in turns at
     each large shape (the forward's three, the step's two and bench.py's), and K3's plain
     version at the encoder shape;
  8. the Transformer path: counts zeroed, one forward under ``torch.inference_mode()``,
     counts read (K2 exactly 18 times); the output is finite and of the right shape, and
     a 1 + 1-layer model at T = 512 on the card equals the port's CPU path; then the
     forward is timed (best of 2 after the counted run), K2 timed at each shape, and one
     forward traced with torch.profiler for its device time by kind of kernel; then the
     same with ``HEAT_TPU_FLASH_PIPELINE=1``: counts zeroed, one forward, counts read (K3
     exactly 18 times, K2 none), its output equal to the knob-off one within 1e-4 of its
     largest magnitude, timed and traced;
  9. the D pass, K4 and K5 against the plain backward on the card, in dQ, dK and dV: at
     the training step's three attention shapes in f32, at bench.py's bf16 causal shape
     and at small ragged shapes (causal with Tk > Tq, Tq > Tk, d of 32, 33, 72, 100 and
     128, lengths one off the kernels' tiles, bool masks with a fully masked row in f32,
     bf16 and f16); bit-identical across two runs; and autograd through the port's
     ``flash_attention`` equal to autograd through the plain forward;
 10. the training path: counts zeroed, one step (forward, backward, Adam), counts read
     (K2, D, K4 and K5 exactly 18 times each); TF32 off inside the forward and the
     backward; the loss and every gradient finite and the parameters changed; a
     1 + 1-layer d_model 512 model at T = 512 on the card equal to the port's CPU path in
     the loss and every gradient of one step and in the loss after three SGD steps, and
     its first step with ``HEAT_TPU_FLASH_PIPELINE=1`` equal to the knob-off one by the
     same rules; then the step timed (best of 2 after the counted run) with its tokens/s
     and peak memory, and one step traced with torch.profiler; then one step from the same
     weights with ``HEAT_TPU_FLASH_PIPELINE=1``: counts zeroed and read (K3, D, K4 and K5
     exactly 18 times each, K2 none), its loss within 1e-5 of the knob-off step's and each
     gradient within 1e-2 of its norm (two knob-off steps give the same bits), timed and
     traced;
 11. bench.py's attention A/B (bench.py:252-274): causal scaled_dot_product_attention at
     b8 h16 t4096 d64 bf16 with the knob off (K2) and on (K3), in turns, in ms and TFLOP/s;
 12. the D pass, K4 and K5 timed at the step's two shapes and bench.py's, in turns with the
     backward of ``scaled_dot_product_attention`` on the same inputs;
 12b. the rest of heat_tpu.nn (``nn_phases``): ``[ring_attention]``, ring attention (causal
     and full) and zigzag attention at bench.py's (8, 16, 4096, 64) in f32 and bf16 over
     P = 4 virtual ranks and at (1, 8, 32768, 64) f32 causal over P = 8, the ring's
     rank-local body fed each rank's chunks in its ring order on one card: K2 launched
     exactly P(P+1)/2 (causal), P² (full) or P(2P+1) (zigzag) times, the merged O and LSE
     within 2e-4 of one K2 call on the whole sequence (O in f32 from both; the cast O within
     one rounding in bf16), best of 3 ms beside the whole-sequence K2 and its bound, the
     merge's share of the device time from a trace, and one case under
     ``HEAT_TPU_FLASH_PIPELINE=1`` (K3); ``[ring_attention_bwd]``, every case's backward:
     D launched P times and K4 and K5 once a forward block (writing f32, as the whole
     call's reference does, whose outputs rounded to the input type equal the default
     entry's bit for bit), dQ, dK and dV within 2e-4 of each gradient's largest entry of
     D/K4/K5 on the whole sequence (at 32,768 tokens plus that call's own distance from
     float64, and the ring within 2e-4 of float64 on 512 keys), timed against it;
     ``[ulysses]``, Ulysses at world 1 equal to sdpa, and MultiheadAttention forward and
     backward on a sequence-split DNDarray at world 1 equal to the CPU path; ``[nn_zoo]``,
     heat_tpu's MNIST Net (forward and one SGD step, Dropout2d keyed, batch 256), an LSTM
     (512, 512, 2 layers) on (64, 256, 512) and a TransformerEncoderLayer(512, 8) in training
     mode with dropout 0.1 and a key, each equal to the CPU path within 1e-5 of the largest
     magnitude, with TF32 allowed for the process and seen off in every product,
     convolution and recurrence; each line carries the card's nvidia-smi name and limit;
 12c. the trainer's state and data (``train_resume_phase``, ``daso_sync_phase``,
     ``io_phase``): ``[train_resume]``, the training step's configuration at full width
     under ``DASO`` (world 1, a ``hierarchical(1)`` communicator, ``DataParallelMultiGPU``):
     four steps in a row against two steps, ``CheckpointManager.save`` of the parameters,
     Adam's moments and step counts, the scheduler's and DASO's counters and
     ``ht.random``'s state, a fresh model and optimizer restored from it and two more
     steps: the losses and every parameter equal bit for bit, K2, D, K4 and K5 exactly 18
     times a step; a copy of the step with one flipped byte and one without its manifest
     raise ``CheckpointCorrupt``; under an armed ``checkpoint.chunk_write`` fault plan the
     save degrades to v1 and ``diagnostics.report()`` records one fallback; the state's
     bytes, save, verify, restore and v1-save seconds and GB/s, and the DASO step's best
     of 2 beside ``[train_step_time]``'s; ``[daso_sync]``, DASO's global sync on 2 and 4
     virtual node replicas of the Transformer's parameters (the gather replaced by a
     stack), bit for bit against the CPU with TF32 allowed and seen off, in ms beside its
     bytes bound; ``[io]``, a 1,000,000 x 64 f32 split DNDarray through
     ``save_npy``/``load_npy`` and ``save``/``load`` and a 40,000 x 18 CSV through
     ``save_csv``/``load_csv``, exact and on the card, in MB/s (HDF5 and zarr only where
     h5py and tensorstore import; the line says which ran). ``[daso_sync]`` and ``[io]``
     launch no kernel and run during step 2's builds, on half the host's cores;
     ``tools/train_state_probe.py`` runs the three alone;
 12d. the request-dispatch runtime (``runtime_phases``): ``[runtime_chain]``, heat_tpu's
     dispatch microbenchmark chain (16 cycles of ``x + y``, ``* 0.5``, ``- y``, ``+ 1.0``:
     64 ops) at 4,096 and 16M f32 elements split 0, forced 100 times through the executor
     (one program, captured in a CUDA graph at its first force and replayed after) and
     with ``HEAT_TPU_EAGER_DISPATCH=1``: the results bit-equal, misses 0, hits and graph
     replays 100, per-force wall time both ways and one force's launches from one
     ``torch.profiler`` pass; and the fan-out graph's ``reexecuted_steady`` (0);
     ``[runtime_serving]``, heat_tpu's four serving request shapes at their on-chip sizes
     (benchmarks/serving/workloads.py): ``kmeans_assign`` (predict on 65,536 x 64 against
     the fitted model of step 5), ``cdist_knn`` (1,024 replicated queries against a
     262,144 x 64 corpus split 0, then argmin), ``mlp_infer`` (784 -> 1024 -> 10 on 8,192
     rows split 0) and ``sparse_matvec`` (a 262,144² DCSR matrix of ~34.4M entries from
     seeded indices, never dense), each over 8 staged inputs, 100 requests from 1 thread
     and from 16, each in ``profiler.request``: every result bit-equal to the same request
     under ``HEAT_TPU_EAGER_DISPATCH=1``, p50/p99 from the profiler's histograms,
     requests/s, batches formed, queue depth, no eager fallback or quarantine, and the
     device's idle share from one traced run of 16 requests; ``[runtime_lifecycle]``, an
     expired deadline typed and planning nothing, ``cancel(tag)``, ``drain``/``reopen``
     under 16 threads, ``admitted + shed + failed == offered`` under ``HEAT_TPU_SHED=1``
     and overload, and a fault plan at ``executor.execute`` leaving every bit of the
     fault-free run with eager fallbacks counted; ``tools/runtime_probe.py`` runs the
     three alone;
 12e. the serving plane (``serving_phases``): ``[serving_swap]``, heat_tpu's
     swap_gate.py on a ``ModelPool`` of Transformer-base (the forward path's widths, ~44M parameters,
     a tree of split-None DNDarrays; each request reads ``pool.state`` once and runs
     ``torch.func.functional_call`` on src and tgt of (4, 1024, 512), causal target,
     under ``inference_mode``, then pools the output through the executor): generations
     A and B saved by ``save_checkpoint``, C a copy of B with one chunk's bytes flipped;
     200 requests from 16 threads, ``swap_state`` to B after a third of them and to C
     after two thirds; every result bit-equal to A's or B's answer for its input and B's
     after the first swap returned, ``admitted + shed + failed == offered`` with no untyped
     failure, the swap to C a ``SwapFailed`` at stage ``stage`` with the pool still on B,
     1 swap and 1 rollback in the ledger and the flight recorder's post-mortem written,
     K2 18 times a request; p50/p99 before, during and after the swap, requests/s, the
     swap's drain and total seconds and the traced idle share; ``[serving_failover]``,
     supervision armed over a ``LocalCoordinator`` with a virtual peer that beats and then
     goes silent under 16-thread traffic: the abort, typed refusals, ``on_peer_failure``
     and serving after it; ``[planes]``, the swap's traffic without swaps with every plane
     off and then with forensics, ops (0.5 s) and telemetry on: requests/s, p99 and the
     overhead, ``explain``'s exemplars, the OpenMetrics page round-tripping and a
     one-shard merge; ``[serving_cache]``, heat_tpu's cache_gate.py: a 16M f32 state at
     split 0, twelve registered 64 MB slots drawn Zipf (alpha 1.1), 400 requests of
     ``x_slot * w + w`` from 16 threads with the result cache on (1 GiB) and off and a
     ``swap_state`` A -> B halfway, every result bit-equal to the eager value for its slot
     and generation, a poisoned entry rejected typed and an in-place write into a slot
     never served stale: hit rate, p50/p99 both ways, host-hash bytes; ``[serving_coldstart]``,
     heat_tpu's coldstart_gate.py: three fresh processes of this script (record, cold,
     warm) running ``[runtime_chain]``'s chain at 4,096 and 16M and the fan-out graph,
     warm replaying the recorded manifest (``executor_warmup``) first: every signature
     replayed, ``failed`` 0, ``aot_loaded`` 0, its first requests hits and graph replays,
     a corrupted ``index.json`` a typed rejection with the boot still serving: first-request
     ms and steady p50/p99 cold against warm, the warmup's seconds; ``[supervised_train]``,
     a fresh process joining an NCCL group of one through a file store:
     ``run_supervised`` drives 4 steps of the training step, checkpointing every 2; a
     fault plan's entry at step 3 raises ``PeerFailed``; the restart aborts and destroys
     the group, joins a new one and restores step 2; the parameters and Adam state
     bit-equal to an uninterrupted 4-step run, K2, D, K4 and K5 18 times a step: the
     restart's seconds. ``tools/serving_probe.py`` runs the six alone;
 12f. ``[launch_counts_threaded]``: 16 request threads, each making 64 calls of
     ``KMeans(max_iter=0).fit`` (one K1 launch: the fit's final assignment pass) at
     4,096 x 64, k = 8, and of ``flash_attention`` (causal, (8, 256, 64) f32) in turns,
     the counts zeroed just before: K1's and K2's counts rise by exactly 16 x 64 each (the
     kernels count under a lock); then ``[analysis]``: ``python -m
     heat_tpu_torch.analysis --check --no-cache --json`` in a child process over this
     tree, which must exit 0 with no new finding and no stale baseline entry (modules
     scanned, findings by rule, those pragmas suppressed, seconds);
 13. (13-17 run in a child process of this script, which traces nothing: see
     ``linalg_phases``) config #2 (``[linalg_matmul]``): ``ht.linalg.matmul`` of a (4096, 4096) split=0 and a
     (4096, 4096) split=1 f32 array from a seeded generator, with TF32 allowed for the
     process and seen off inside every ``torch.matmul`` of the call; the product split 0,
     entrywise within γ_4096·(|A||B|) of the float64 product, bit-identical twice; the
     planner's counts empty (one card is one rank: it plans nothing, as heat_tpu's does at
     ``comm.size`` 1); best of 3 in ms, TFLOP/s, the device time against cuBLAS's own
     ``torch.matmul`` and the fp32 FMA bound (2·4096³ at 67 TFLOP/s, 2.05 ms); then a 3-D
     batch product (8 × 1024², batch split 0) within γ_1024·(|A||B|) of float64 and the f64
     4096² product within 2γ_4096·(|A||B|) of another order of the same f64 sums
     (``[linalg_matmul_more]``);
 14. config #4 (``[linalg_hsvd]``): ``ht.linalg.hsvd_rank(A, 10)`` of A = U·V, U 2048 × 10
     and V 10 × 32768 f32 from the generator, A split=1: U 2048 × 10 with ‖UᵀU − I‖ ≤ 1e-4,
     ‖A − UUᵀA‖/‖A‖ ≤ 1e-4 and the error estimate ≤ 1e-4; at 256 × 1024 the card's U spans
     the CPU path's subspace (‖UUᵀ − U_cpu U_cpuᵀ‖ ≤ 1e-4); best of 2 in s, the library SVD
     of A alone (the default driver and ``gesvd``, which the port asks for) and the
     residual ‖A − UUᵀA‖/‖A‖ of the default driver's leading 10 columns, hsvd's device
     time between CUDA events, and the seconds each step of the phase took;
 15. the rest, on the card against the port's CPU path (``[linalg_small]``): ``qr`` of
     4096 × 64 split=0 (R up to row signs, |QR − A|), ``svd`` and ``pinv`` of 96 × 64,
     ``cg`` (64, f64) and ``lanczos`` (48, m = 20, f64, ``v0`` given) within 1e-10,
     ``resplit_`` 0 → 1 → 0 of 40 × 30 × 20, and ``cdist`` of two row-split arrays (squared
     distances within 1e-5 of |x|² + |y|²);
 16. (in the same child process) the array API: heat_tpu's manipulation benchmark
     (benchmarks/cb/manipulations.py) through the port at N = 40,000,000 f32 (Heat's
     1000 x 40,000), the data drawn by ``ht.random.random`` on the card and equal bit for
     bit to the same draw on the CPU (``[manip]`` lines): ``reshape`` to (250, 160,000)
     with ``new_split=1``, ``concatenate`` of three arrays split 1, None and 1 along axis 1,
     ``resplit`` 0 -> 1, ``sort`` of (N,) split 0 (values == x[indices]), ``topk`` 64,
     ``percentile`` [25, 50, 99], ``median`` along axis 0 of (N/128, 128), ``unique`` of
     floor(512 u), ``x[3::7]``, ``x[x > 0.5]`` and ``x[::5] = 0``: each equal to the port's
     CPU path on a CPU copy of its input (percentile and median within 1e-6 relative), its
     result on the card, at most 64 KiB read back to the host from Python (counts and
     splitters, never the array), and timed (best of 3 wall, the device time between CUDA
     events, the bytes it must move at 3.35 TB/s, and the one torch call that computes the
     same at one rank: torch.sort, torch.topk, torch.unique, torch.quantile, torch.cat,
     Tensor.reshape().contiguous()); then the random streams on the card against the
     CPU's (uniform floats, integers and permutations bit for bit, normal within 4 ulp in
     float32 and 32 in float64; ``[random_streams]``), and ``KMeans(init="random",
     random_state=s)`` at 10M x 64, whose initial centers equal the CPU path's
     (``[kmeans_random_init]``). One card is one rank: every ``redistribute`` and the sort
     network are bypassed there (tests/test_torch_distributed.py holds them at 3 and 4
     gloo ranks);
 17. (in the same child process) the clustering slice (``cluster_phases``): heat_tpu's
     cluster benchmark (benchmarks/cb/cluster.py: KMeans, KMedians, KMedoids and
     BatchParallelKMeans, k = 4, on ``create_spherical_dataset`` of 5,000 points a ball),
     each equal to the CPU path on a CPU copy and timed best of 3, data included
     (``[cluster_bench]``); KMedians, KMedoids and BatchParallelKMeans at 10M x 64, k = 8,
     ``max_iter=30``: at 200,000 rows the ++ seeding's picks against the CPU path's and
     the fit from the CPU's seeds equal to the CPU's, then the full size timed
     (``[kmedians_fit]``, ``[kmedoids_fit]``, ``[batchparallel_fit]``); Spectral at its
     defaults (rbf, gamma 1, n_lanczos 300) on 4 x 4096 points, its labels equal to the
     CPU path's at 4 x 512 and recovering the balls (at least 99% of each ball under one
     label, four labels) at full size (``[spectral_fit]``). Spectral's similarity is
     float64, as heat_tpu's (a NumPy float64 sigma), so its KMeans runs no K1;
 18. (in the same child process) the domain estimators (``domain_phases``, ``[domain_*]``
     lines): ``fft`` along axis 1 and along the split axis, ``rfft2`` and ``ifft(fft(x))``
     of 1000 x 40,000 f32 split 0; the five scalers' fit + transform and GaussianNB's fit +
     predict on the KMeans data, 10M x 64 f32 and its 8 labels; Lasso on the sugar table
     and on 1,000,000 x 64 f64 with 8 non-zero coefficients; KNN with 40,000 training rows
     x 18 features, 40,000 queries, k = 5; DCSR add and mul of two 1,000,000² matrices of
     10M random entries and todense of a 20,000² one: each against the port's CPU path on
     a CPU copy (FFTs and scalers within 1e-5 of the largest magnitude, GaussianNB's
     moments and Lasso's coefficients within 1e-10, labels and CSR parts exact; at
     200,000 rows, 20,000 for Lasso and 4,000 queries for KNN where the CPU would take
     minutes), at most 64 KiB read back to the host, timed best of 3 (Lasso and
     GaussianNB best of 2) beside its bytes at 3.35 TB/s; then integer division and
     remainders by zero on the card against the CPU path;
 19. one JSON line listing every ported kernel with its launches on its path (K1's on
     every clustering path too), its time, its bound on this card (f32 attention work at
     the 3xTF32 rate, with the fp32 FMA rate's bound beside it), its plain version's time
     and a library call's time (the linear algebra runs no hand kernel: its products are
     cuBLAS and cuSOLVER; the array API and the clustering none: their torch ops stand in
     for XLA's; the domain steps none either: heat_tpu's fft, sparse and estimators reach
     no pl.pallas_call);
 20. the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script then exits non-zero without the last line. It
also fails when CUDA is not available or when the heat_tpu_torch package is not beside
it. It imports nothing of JAX or heat_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
try:
    from heat_tpu_torch.core.kernels._measure import cuda_ms, fwd_err, k2_inputs, ptxas_summary, sass, sass_counts
except ImportError as exc:
    sys.exit(f"chip_smoke: the heat_tpu_torch package is not beside this script ({exc})")

# the main path: bench.py's KMeans configuration (bench.py:155-160), data from this seed
N, D, K, MAX_ITER, SEED = 10_000_000, 64, 8, 30, 0

# the Transformer path: Transformer-base at its defaults, one request of 8 sequences
BATCH, SRC_T, TGT_T = 8, 4096, 2048
FLASH_PER_FORWARD = 18  # 6 encoder self-, 6 causal decoder self-, 6 cross-attentions
PIPELINE_KNOB = "HEAT_TPU_FLASH_PIPELINE"  # "1": every flash forward runs K3 in place of K2
# bench.py's attention configuration (bench.py:223-224, 248)
BENCH_B, BENCH_H, BENCH_T, BENCH_D = 8, 16, 4096, 64

# the training path: Transformer-base ("Attention Is All You Need", Table 3) on its shared
# 37,000-token vocabulary (§5.1), 12 x 2048 source and 12 x 2048 target tokens per step
# (the paper's ~25,000 + 25,000), Adam under its warmup schedule (§5.3)
VOCAB, TRAIN_B, TRAIN_T, WARMUP = 37_000, 12, 2048, 4000

# NVIDIA's data sheet for the H100 SXM (dense float32 outside the tensor cores, dense TF32
# and bf16 in them, HBM3); a kernel's bound is taken against these, so the script refuses
# any other card. An f32 product keeps fp32's accuracy on the tensor cores in 3xTF32
# (three TF32 products per product, csrc/mma_tf32x3.cuh): the least time of f32 attention
# work is taken at that rate, and the fp32 FMA rate's figure is kept beside it
CARD = "H100 80GB HBM3"
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12

U32, U64 = 2.0**-24, 2.0**-53  # unit roundoff of float32 and float64

# north-star config #2 (BASELINE.md:24): split-0 x split-1 f32 at 4096²; config #4
# (BASELINE.md:26) at bench.py's chip size (bench.py:170-185): hsvd_rank of a rank-10
# 2048 x 32768 f32 matrix, split=1
MM_N = 4096
HSVD_M, HSVD_N, HSVD_RANK = 2048, 8 * 4096, 10

# the kernels, by source, whose every instance takes its products as mma.sync (HMMA in
# its SASS)
TENSOR_CORE_KERNELS = {
    "flash_attention_fwd.cu": ("flash_attention_fwd_kernel",),
    "flash_attention_fwd_pipelined.cu": ("flash_attention_fwd_pipelined_kernel",),
    "flash_attention_bwd.cu": ("flash_attention_bwd_dq_kernel", "flash_attention_bwd_dkv_kernel"),
}


def gamma(h: int, u: float = U32) -> float:
    """Higham's bound h·u / (1 − h·u) on the relative error of h roundings in a row."""
    return h * u / (1.0 - h * u)


def check(ok, message) -> None:
    """Fail the run: a check that, unlike ``assert``, ``python -O`` does not remove."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


@contextlib.contextmanager
def pipelined(on: bool):
    """``HEAT_TPU_FLASH_PIPELINE`` set to "1" (K3) or unset (K2) around a block, then put
    back as it was: the port reads the knob on every call."""
    prior = os.environ.get(PIPELINE_KNOB)
    if on:
        os.environ[PIPELINE_KNOB] = "1"
    else:
        os.environ.pop(PIPELINE_KNOB, None)
    try:
        yield
    finally:
        if prior is None:
            os.environ.pop(PIPELINE_KNOB, None)
        else:
            os.environ[PIPELINE_KNOB] = prior


def blobs(n: int, d: int, k: int, seed: int, device):
    """Gaussian blobs made on the device from a seeded generator: true centers ~ N(0, 2²),
    unit noise, and initial centers at the true ones plus N(0, 0.5²) noise."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    true = 2.0 * torch.randn(k, d, generator=gen, device=device)
    y = torch.randint(0, k, (n,), generator=gen, device=device)
    x = torch.randn(n, d, generator=gen, device=device)
    x += true[y]
    init = (true + 0.5 * torch.randn(k, d, generator=gen, device=device)).contiguous()
    return x, init, true


def placed(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` floats into a fresh buffer (1: 4
    bytes past the 16-byte boundary that the allocator gives)."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def check_k1(k1, x, c, exact: bool) -> dict:
    """K1 against its plain version and against float64 on the same card and inputs.

    Against the plain version: labels may differ only on near-ties (the two smallest d²
    within 1e-5·(|x|²+|c|²)), on at most 1e-6·n rows; counts must agree once those rows
    are moved to the kernel's label; sse within rtol 1e-5.

    Against float64 sums of the same rows grouped by the kernel's labels (a reference
    with no order of its own to speak of): each row's contribution passes through at
    most h fp32 roundings in the kernel's order (``kmeans.rounding_depths``: its tile's
    partial of its cluster, the block's tiles, the blocks), so the sums may be off by
    γ_h·Σ|x| and no more; sse adds each row's error of the quadratic expansion, γ_h_row
    (|x| + max|c|)² a row. Below 200,000 rows the sums must also equal ``kmeans.ordered_sums``,
    the kernel's order replayed on the host from its labels, bit for bit.

    ``exact`` data are small integers: then no product or partial sum rounds, labels and
    counts must equal the plain version's and the sums the float64 ones bit for bit, so
    a row that is dropped or added twice shows at any size. Two runs must be identical.
    """
    import torch

    n, d = x.shape
    k = c.shape[0]
    labels, packed = k1.fused_assign_update_packed(x, c)
    labels2, packed2 = k1.fused_assign_update_packed(x, c)
    torch.cuda.synchronize()
    check(torch.equal(labels, labels2) and torch.equal(packed, packed2), "K1 is not deterministic")
    sums, counts, sse = k1.unpack(packed, k, d)

    # labels, counts and sse against the plain version
    l0, _, n0, e0 = k1.fused_assign_update_reference(x, c)
    rows = torch.nonzero(labels != l0).flatten()
    check(not (exact and rows.numel()), f"{rows.numel()} labels differ from the plain version on exact data")
    if rows.numel():
        xr = x[rows].double()
        d2 = ((xr[:, None, :] - c.double()[None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        scale = (xr * xr).sum(1) + (c.double() ** 2).sum(1).max()
        check(bool(((two[:, 1] - two[:, 0]) <= 1e-5 * scale).all()), "K1 disagrees on a row that is no near-tie")
    check(rows.numel() <= 1e-6 * n, f"{rows.numel()} near-tie rows exceed 1e-6·n")
    ones = torch.ones(rows.numel(), device=x.device)
    n0 = n0.index_add(0, l0[rows], ones, alpha=-1.0).index_add(0, labels[rows], ones)
    check(torch.equal(counts, n0), "K1 counts disagree with the plain version")
    sse_rel = abs(float(sse) - float(e0)) / max(abs(float(e0)), 1e-30)
    check(sse_rel <= 1e-5, f"K1 sse disagrees with the plain version: rel err {sse_rel}")

    # sums and sse against float64, within the kernel's own rounding
    blocks, _ = k1.grid_blocks(n, d, k, x.device)
    h = k1.rounding_depths(n, d, k, labels, blocks)
    lab = labels.long()
    x64, c64 = x.double(), c.double()
    sums64 = torch.zeros(k, d, dtype=torch.float64, device=x.device).index_add_(0, lab, x64)
    abs64 = torch.zeros_like(sums64).index_add_(0, lab, x64.abs())
    err = (sums.double() - sums64).abs()
    tol = (gamma(h["h_sums"]) + gamma(n, U64)) * abs64 + 1e-30
    if exact:
        check(float(abs64.max()) < 2**24, "exact data: a partial sum could round")
        check(torch.equal(sums.double(), sums64), f"K1 sums are not exact on exact data: max err {float(err.max())}")
    check(bool((err <= tol).all()), f"K1 sums off float64 by {float(err.max())}, worst err/tol {float((err / tol).max())}")
    replayed = n < 200_000
    if replayed:
        again = k1.ordered_sums(x.cpu().numpy(), labels.cpu().numpy(), k, blocks)
        check(np.array_equal(sums.cpu().numpy(), again), "K1 sums differ from their order replayed on the host")
    sse64 = float(torch.stack([((x64 - c64[j]) ** 2).sum(1) for j in range(k)], 1).amin(1).sum())
    row_err = gamma(h["h_row"]) * float(((x64.norm(dim=1) + c64.norm(dim=1).max()) ** 2).sum())
    sse_tol = row_err + (gamma(h["h_sse"]) + gamma(n, U64)) * (sse64 + row_err)
    sse_err = abs(float(sse) - sse64)
    check(sse_err <= sse_tol, f"K1 sse off float64 by {sse_err}, tolerance {sse_tol}")
    return {
        "max_abs_err": float(err.max()),
        "sums_err_over_tol": float((err / tol).max()),
        "sse_err_over_tol": sse_err / sse_tol,
        "sse_rel_err_vs_plain": sse_rel,
        "near_tie_rows": int(rows.numel()),
        "blocks": blocks,
        **h,
        "sums_equal_host_replay": replayed,
    }


def attention_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs an attention computes: all of them, or, causal top-left
    aligned, those with key <= query."""
    if not causal:
        return tq * tk
    m = min(tq, tk)
    return m * (m + 1) // 2 + max(tq - tk, 0) * tk


def attention_rate(itemsize: int, simt: bool = False) -> float:
    """The operation rate that bounds attention work on inputs of ``itemsize`` bytes: 3xTF32
    for f32 (the fp32 FMA rate with ``simt``), the bf16 tensor-core rate for 2-byte types."""
    if itemsize == 4:
        return PEAK_FP32_FLOPS if simt else PEAK_TF32X3_FLOPS
    return PEAK_BF16_FLOPS


def roof_ms(nbytes: float, flops: float, rate: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of bytes over the memory rate and
    operations over ``rate``."""
    bytes_ms, flops_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / rate
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def k2_bound_ms(bh: int, tq: int, tk: int, d: int, causal: bool, itemsize: int, simt: bool = False) -> tuple:
    """(bound ms, "bytes" or "operations") of one K2 call: q, k, v read once and O, LSE
    written once, against 4·d operations per (query, key) pair at :func:`attention_rate`."""
    nbytes = itemsize * bh * d * (2 * tq + 2 * tk) + 4 * bh * tq
    flops = 4 * bh * d * attention_pairs(tq, tk, causal)
    return roof_ms(nbytes, flops, attention_rate(itemsize, simt))


def check_dead_rows(name, k2, o, lse, dead_rows) -> None:
    """Fully masked rows give O exactly 0 and LSE exactly NEG_INF/2 + log(1e-30)."""
    import torch

    dead_lse = torch.tensor(k2._NEG_INF / 2, dtype=torch.float32) + torch.log(torch.tensor(1e-30))
    for r in dead_rows:
        check(bool((o[:, r] == 0).all()) and bool((lse[:, r].cpu() == dead_lse).all()), f"{name}'s fully masked row {r}")


def check_k2(k2, q, k, v, causal: bool, mask, dead_rows=()) -> dict:
    """K2 against its plain version on the same card and inputs, in O and LSE.

    f32: both compute in fp32 and differ in summation order only, so O and LSE agree
    within rtol = atol = 2e-4 (the tolerance of heat_tpu's own flash tests). bf16/f16:
    both compute in f32 and round O once to the input type, so O may differ by one
    rounding, 2⁻⁷ relative (the bf16 unit in the last place), plus 2e-4; LSE is f32 in
    both, 2e-4. Rows in ``dead_rows`` (fully masked) must give O exactly 0 and LSE
    exactly NEG_INF/2 + log(1e-30). Two runs must be identical. The plain version runs
    in chunks of batch·heads to bound its memory."""
    import torch

    with torch.no_grad():
        o, lse = k2.flash_attention_fwd(q, k, v, causal, None, mask)
        o2, lse2 = k2.flash_attention_fwd(q, k, v, causal, None, mask)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and torch.equal(lse, lse2), "K2 is not deterministic")
        bh, tq, _ = q.shape
        tk = k.shape[1]
        chunk = max(1, (1 << 28) // (tq * tk))
        bias = k2._as_bias(mask)
        err_o = err_lse = worst = 0.0
        for s0 in range(0, bh, chunk):
            sl = slice(s0, s0 + chunk)
            ro, rl = k2.flash_attention_reference(q[sl], k[sl], v[sl], causal, None, bias)
            e = fwd_err(o[sl], lse[sl], ro, rl)
            err_o, err_lse, worst = max(err_o, e[0]), max(err_lse, e[1]), max(worst, e[2])
        check(worst <= 1.0, f"K2 disagrees with its plain version: err/tol {worst} (O {err_o}, LSE {err_lse})")
        check_dead_rows("K2", k2, o, lse, dead_rows)
        check(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()), "K2 gave a value that is not finite")
    return {"max_abs_err_o": err_o, "max_abs_err_lse": err_lse, "err_over_tol": worst}


def check_k3(k2, q, k, v, causal: bool, mask, dead_rows=()) -> dict:
    """K3 (``flash_attention_fwd`` with ``HEAT_TPU_FLASH_PIPELINE=1``) against its plain
    version, ``flash_attention_pipelined_reference``, and against K2 on the same card and
    inputs, in O and LSE, within :func:`fwd_err`'s tolerances: all three compute in fp32
    and differ in the order of their sums. Fully masked rows as in K2; every value finite;
    two runs identical. The plain version runs in chunks of batch·heads."""
    import torch

    with torch.no_grad():
        with pipelined(True):
            o, lse = k2.flash_attention_fwd(q, k, v, causal, None, mask)
            o2, lse2 = k2.flash_attention_fwd(q, k, v, causal, None, mask)
        with pipelined(False):
            ko, kl = k2.flash_attention_fwd(q, k, v, causal, None, mask)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and torch.equal(lse, lse2), "K3 is not deterministic")
        bh, tq, _ = q.shape
        tk = k.shape[1]
        chunk = max(1, (1 << 28) // (tq * tk))
        bias = k2._as_bias(mask)
        err_o = err_lse = worst = 0.0
        for s0 in range(0, bh, chunk):
            sl = slice(s0, s0 + chunk)
            ro, rl = k2.flash_attention_pipelined_reference(q[sl], k[sl], v[sl], causal, None, bias)
            e = fwd_err(o[sl], lse[sl], ro, rl)
            err_o, err_lse, worst = max(err_o, e[0]), max(err_lse, e[1]), max(worst, e[2])
        check(worst <= 1.0, f"K3 disagrees with its plain version: err/tol {worst} (O {err_o}, LSE {err_lse})")
        vs_k2 = fwd_err(o, lse, ko, kl)
        check(vs_k2[2] <= 1.0, f"K3 disagrees with K2: err/tol {vs_k2[2]} (O {vs_k2[0]}, LSE {vs_k2[1]})")
        check_dead_rows("K3", k2, o, lse, dead_rows)
        check(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()), "K3 gave a value that is not finite")
    return {"max_abs_err_o": err_o, "max_abs_err_lse": err_lse, "err_over_tol": worst,
            "vs_k2_max_abs_err_o": vs_k2[0], "vs_k2_max_abs_err_lse": vs_k2[1], "vs_k2_err_over_tol": vs_k2[2]}


def bwd_bounds_ms(bh: int, tq: int, tk: int, d: int, causal: bool, itemsize: int, simt: bool = False) -> dict:
    """(bound ms, "bytes" or "operations") of the D pass, K4 and K5 for one backward call.
    Operations: 6·d per attended (query, key) pair for K4 (q·kᵀ, dO·vᵀ, dS·k) and 8·d for
    K5 (q·kᵀ, dO·vᵀ, dSᵀ·q, Pᵀ·dO), at :func:`attention_rate`; 2·d per row for D, at the
    fp32 rate. Bytes: each input read once and each output written once (D: O and dO in,
    D out; K4: q, k, v, dO, LSE and D in, dQ out; K5: the same in, dK and dV out)."""
    pairs = attention_pairs(tq, tk, causal)
    peak = attention_rate(itemsize, simt)
    rows = itemsize * bh * d
    work = {
        "flash_attention_bwd_d": (2 * rows * tq + 4 * bh * tq, 2 * bh * tq * d, PEAK_FP32_FLOPS),
        "flash_attention_bwd_dq": (rows * (3 * tq + 2 * tk) + 8 * bh * tq, 6 * bh * d * pairs, peak),
        "flash_attention_bwd_dkv": (rows * (2 * tq + 4 * tk) + 8 * bh * tq, 8 * bh * d * pairs, peak),
    }
    return {name: roof_ms(nbytes, flops, rate) for name, (nbytes, flops, rate) in work.items()}


def check_bwd(k2, q, k, v, causal: bool, mask, seed: int) -> dict:
    """The D pass, K4 and K5 against the plain backward on the same card and inputs, in dQ,
    dK and dV, on O and LSE from K2 and a random output gradient.

    f32: both compute in fp32 and differ in summation order only; each gradient must agree
    within 2e-4 of its largest magnitude (the relative level of heat_tpu's own flash tests).
    bf16/f16: both compute in f32 from the same inputs and round each gradient once to the
    input type, so an element may differ by one unit in the last place of that type (2⁻⁷
    of its magnitude for bf16, 2⁻¹⁰ for f16) on top of that. Key rows that no query attends
    (causal with Tk > Tq) must be exactly 0 and every value finite. Two runs must be
    identical. The plain version runs in chunks of batch·heads to bound its memory."""
    import torch

    gen = torch.Generator(device=q.device).manual_seed(seed)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    with torch.no_grad():
        o, lse = k2.flash_attention_fwd(q, k, v, causal, None, mask)
        got = k2.flash_attention_bwd(q, k, v, o, do, lse, causal, None, mask)
        again = k2.flash_attention_bwd(q, k, v, o, do, lse, causal, None, mask)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)), "the flash backward is not deterministic")
        bh, tq, _ = q.shape
        tk = k.shape[1]
        chunk = max(1, (1 << 28) // (tq * tk))
        bias = k2._as_bias(mask)
        ulp = {torch.float32: 0.0, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}[q.dtype]
        refs = [[], [], []]
        for s0 in range(0, bh, chunk):
            sl = slice(s0, s0 + chunk)
            for acc, r in zip(refs, k2.flash_attention_bwd_reference(q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], causal, None, bias)):
                acc.append(r.float())
        out = {}
        for name, g, parts in zip(("dq", "dk", "dv"), got, refs):
            ref = torch.cat(parts)
            err = (g.float() - ref).abs()
            tol = 2e-4 * float(ref.abs().max()) + ulp * ref.abs() + 1e-30
            out[f"max_abs_err_{name}"] = float(err.max())
            out[f"err_over_tol_{name}"] = float((err / tol).max())
            check(bool(torch.isfinite(g.float()).all()), f"the flash backward gave a {name} that is not finite")
            del ref, err, tol
        worst = max(out[f"err_over_tol_{n}"] for n in ("dq", "dk", "dv"))
        check(worst <= 1.0, f"the flash backward disagrees with its plain version: {out}")
        if causal and tk > tq:
            check(float(got[1][:, tq:].abs().max()) == 0.0 and float(got[2][:, tq:].abs().max()) == 0.0,
                  "key rows that no query attends did not get zero dK and dV")
    return {**out, "err_over_tol": worst}


KERNEL_KINDS = (
    # (kind, substrings of a CUDA kernel's name), the first match wins
    ("k1_kmeans_assign", ("kmeans_assign",)),
    ("k2_flash_attention", ("flash_attention_fwd_kernel",)),
    ("k3_flash_attention_pipelined", ("flash_attention_fwd_pipelined_kernel",)),
    ("d_pass", ("flash_attention_bwd_d_kernel",)),
    ("k4_dq", ("flash_attention_bwd_dq_kernel",)),
    ("k5_dkv", ("flash_attention_bwd_dkv_kernel",)),
    # cuSOLVER's gesvd: Householder bidiagonalisation (labrd, larfg, geqrf, orgqr, its gemv)
    # and the rotations of its host-steered QR iteration (lasr); gesvdj's Jacobi sweeps
    ("svd_cusolver", ("gesvd", "gebrd", "labrd", "bdsqr", "lasr", "orgbr", "ormbr", "geqrf", "geqr2", "orgqr",
                      "ormqr", "larf", "cuds_gemv", "jacobi", "syevj", "svd", "offA", "ormtr", "cusolver")),
    ("matmul_cublas", ("gemm", "xmma", "cutlass", "cublas")),
    ("cross_entropy", ("softmax", "SoftMax", "nll_loss")),
    ("adam", ("multi_tensor_apply", "adam", "Adam")),
    ("embedding_backward", ("embedding", "segment", "grad_weight", "sum_and_scatter", "RadixSort", "radix_sort")),
    ("layer_norm", ("layer_norm",)),
    ("copy_transpose", ("copy", "Copy")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_device(fn, inference: bool = True) -> dict:
    """Device time of one ``fn()`` by kind of kernel, from a ``torch.profiler`` trace:
    ms per kind, the ten largest kernels, the device-busy ms (the sum of the kernels,
    which one stream runs one at a time) and the host wall ms of the traced call. With no
    device events in the trace, says so instead of giving numbers. ``inference`` runs
    ``fn`` under ``torch.inference_mode()``."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        return {"device_trace": "not measured: the profiler recorded no device events", "traced_wall_ms": wall_ms}
    kinds: dict = {}
    other = []
    for kname, (ms, n) in by_name.items():
        kind = next((k for k, subs in KERNEL_KINDS if any(sub in kname for sub in subs)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        if kind == "other":
            other.append([kname[:80], ms, n])
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "device_ms_by_kind": kinds,
        "device_busy_ms": busy,
        "traced_wall_ms": wall_ms,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top_kernels": [[kname[:80], ms, n] for kname, (ms, n) in top],
        "top_other_kernels": sorted(other, key=lambda x: -x[1])[:6],
    }


@contextlib.contextmanager
def tf32_seen(seen: list):
    """TF32 allowed for the whole process around the block (the port must turn it off
    itself), and every ``torch.matmul`` inside records whether cuBLAS may use TF32 then."""
    import torch

    prior, mm = torch.backends.cuda.matmul.allow_tf32, torch.matmul

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return mm(*args, **kwargs)

    torch.backends.cuda.matmul.allow_tf32, torch.matmul = True, spy
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.matmul = prior, mm


def best_s(fn, reps: int) -> tuple:
    """Best and every wall time, in s, of ``fn()`` ending in a device synchronisation."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls), walls


def linalg_phases(ht, dev) -> dict:
    """North-star configs #2 and #4 (BASELINE.md:24, :26) and the rest of the linear
    algebra on the card. One card is one rank: the planner plans nothing (``comm.size`` is
    1) and every product is local cuBLAS with TF32 off; ring, reduce-scatter and all-to-all
    moves across ranks are held at three gloo ranks by tests/test_torch_distributed.py.

    Runs in a process of its own (:func:`linalg_child`): after a torch.profiler session,
    these phases took 550 s and more than 800 s on the H100 machine where a fresh process
    took 7 s, so they trace nothing and follow none (``tools/hsvd_trace.py`` traces hsvd
    alone)."""
    import torch

    from heat_tpu_torch.core.devices import full_fp32_matmul
    from heat_tpu_torch.core.linalg import comm_plan

    res = {}
    n = MM_N
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000)
    a_t = torch.randn(n, n, generator=gen, device=dev)
    b_t = torch.randn(n, n, generator=gen, device=dev)
    a, b = ht.array(a_t, split=0), ht.array(b_t, split=1)

    # 13. config #2: split-0 x split-1 f32 at 4096², TF32 off inside the call
    t_phase = time.perf_counter()
    comm_plan.reset_counters()
    seen = []
    with tf32_seen(seen):
        c = ht.linalg.matmul(a, b)
        c2 = ht.matmul(a, b)
        torch.cuda.synchronize()
    check(seen and not any(seen), f"TF32 was allowed inside the product ({seen})")
    check(comm_plan.COUNTERS == {}, f"one rank planned {comm_plan.COUNTERS}")
    check(c.gshape == (n, n) and c.split == 0 and c.dtype is ht.float32, f"config #2 result {c.gshape} split {c.split}")
    check(torch.equal(c.larray, c2.larray), "config #2 differs between two runs")
    a64, b64 = a_t.double(), b_t.double()
    exact = a64 @ b64
    bound = gamma(n) * (a64.abs() @ b64.abs())
    ratio = float(((c.larray.double() - exact).abs() / bound).max())
    check(ratio <= 1.0, f"config #2 off float64 by {ratio} of gamma_n |A||B|")
    mm_best, mm_walls = best_s(lambda: ht.linalg.matmul(a, b), 3)
    with full_fp32_matmul():
        library_ms = cuda_ms(lambda: torch.matmul(a_t, b_t), reps=10)
    port_ms = cuda_ms(lambda: ht.linalg.matmul(a, b), reps=10)
    flops = 2 * n**3
    bound_ms = max(1e3 * flops / PEAK_FP32_FLOPS, 1e3 * 3 * n * n * 4 / PEAK_BYTES_PER_S)
    phase("linalg_matmul", config="#2", shape=f"{n}x{n}@{n}x{n}", splits="0x1", out_split=c.split,
          tf32_in_call=any(seen), plan_counts=json.dumps(comm_plan.COUNTERS), max_err_over_gamma_bound=ratio,
          deterministic=True, best_of_3_ms=repr(1e3 * mm_best), walls_ms=json.dumps([1e3 * w for w in mm_walls]),
          tflops=repr(flops / mm_best / 1e12), device_ms=repr(port_ms), library_ms=repr(library_ms),
          bound_ms=repr(bound_ms), bound_by="operations (fp32 FMA, 67 TFLOP/s)", phase_s=repr(time.perf_counter() - t_phase))
    res["matmul"] = {"best_of_3_ms": 1e3 * mm_best, "walls_ms": [1e3 * w for w in mm_walls], "device_ms": port_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms, "err_over_bound": ratio}
    del c, c2, exact, bound

    # a 3-D batch product (batch split 0) and the f64 product, each against float64
    xb = torch.randn(8, 1024, 1024, generator=gen, device=dev)
    yb = torch.randn(8, 1024, 1024, generator=gen, device=dev)
    cb = ht.matmul(ht.array(xb, split=0), ht.array(yb, split=0))
    exact = xb.double() @ yb.double()
    ratio_b = float(((cb.larray.double() - exact).abs() / (gamma(1024) * (xb.double().abs() @ yb.double().abs()))).max())
    check(cb.split == 0 and cb.gshape == (8, 1024, 1024) and ratio_b <= 1.0, f"batch product: split {cb.split}, {ratio_b}")
    c64 = ht.matmul(ht.array(a64, split=0), ht.array(b64, split=1))
    # another order of the same float64 sums: four k-panels
    panels = sum(a64[:, i : i + n // 4] @ b64[i : i + n // 4] for i in range(0, n, n // 4))
    ratio_64 = float(((c64.larray - panels).abs() / (2 * gamma(n, U64) * (a64.abs() @ b64.abs()))).max())
    check(c64.dtype is ht.float64 and ratio_64 <= 1.0, f"f64 product off by {ratio_64} of 2 gamma_n |A||B|")
    f64_best, _ = best_s(lambda: ht.matmul(ht.array(a64, split=0), ht.array(b64, split=1)), 3)
    phase("linalg_matmul_more", batch="8x1024x1024@8x1024x1024", batch_split=cb.split, batch_err_over_bound=ratio_b,
          f64=f"{n}x{n}", f64_err_over_bound=ratio_64, f64_best_of_3_ms=repr(1e3 * f64_best))
    res["matmul_f64_best_of_3_ms"] = 1e3 * f64_best
    del a, b, a_t, b_t, a64, b64, c64, panels, xb, yb, cb, exact
    torch.cuda.empty_cache()

    # 14. config #4: hsvd_rank of a rank-10 2048 x 32768 f32 matrix, split=1 (bench.py:170-185)
    t_phase = time.perf_counter()
    m, cols, rank = HSVD_M, HSVD_N, HSVD_RANK
    u_t = torch.randn(m, rank, generator=gen, device=dev)
    v_t = torch.randn(rank, cols, generator=gen, device=dev)
    A = ht.array(u_t @ v_t, split=1)
    steps = {}

    def lap(name):
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t_phase - sum(steps.values())

    lap("data")
    U, err = ht.linalg.hsvd_rank(A, rank)
    lap("first_call")
    Ul = U.larray.double()
    orth = float(torch.linalg.matrix_norm(Ul.T @ Ul - torch.eye(rank, device=dev, dtype=torch.float64)))
    A64 = A.larray.double()
    resid = float(torch.linalg.matrix_norm(A64 - Ul @ (Ul.T @ A64)) / torch.linalg.matrix_norm(A64))
    check(U.gshape == (m, rank) and U.split is None, f"hsvd U {U.gshape} split {U.split}")
    check(orth <= 1e-4 and resid <= 1e-4 and float(err.item()) <= 1e-4,
          f"hsvd: |U'U - I| {orth}, residual {resid}, estimate {float(err.item())}")
    del A64, Ul
    lap("checks")
    small = (u_t[:256] @ v_t[:, :1024]).contiguous()
    Us, _ = ht.linalg.hsvd_rank(ht.array(small, split=1), rank)
    Uc, _ = ht.linalg.hsvd_rank(ht.array(small.cpu(), split=1, device="cpu"), rank)
    Us64, Uc64 = Us.larray.double().cpu(), Uc.larray.double()
    span = float(torch.linalg.matrix_norm(Us64 @ Us64.T - Uc64 @ Uc64.T))
    check(span <= 1e-4, f"hsvd: the card's U spans another subspace than the CPU's ({span})")
    lap("small_vs_cpu")
    h_best, h_walls = best_s(lambda: ht.linalg.hsvd_rank(A, rank), 2)
    lap("best_of_2")
    # the library's SVD of A alone: the default driver (gesvdj) and gesvd, which hsvd asks
    # for; and how far the default driver's leading subspace is off
    Ud = torch.linalg.svd(A.larray, full_matrices=False).U[:, :rank].double()
    A64 = A.larray.double()
    default_resid = float(torch.linalg.matrix_norm(A64 - Ud @ (Ud.T @ A64)) / torch.linalg.matrix_norm(A64))
    del Ud, A64
    svd_ms = cuda_ms(lambda: torch.linalg.svd(A.larray, full_matrices=False), reps=2, warmup=1)
    lap("library_gesvdj")
    gesvd_ms = cuda_ms(lambda: torch.linalg.svd(A.larray, full_matrices=False, driver="gesvd"), reps=2, warmup=1)
    lap("library_gesvd")
    h_ms = cuda_ms(lambda: ht.linalg.hsvd_rank(A, rank), reps=2, warmup=0)
    lap("device_events")
    phase("linalg_hsvd", config="#4", shape=f"{m}x{cols}", rank=rank, split=1, U=f"{U.gshape}", orthonormality=orth,
          relative_residual=resid, error_estimate=float(err.item()), subspace_vs_cpu_256x1024=span,
          best_of_2_s=repr(h_best), walls_s=json.dumps(h_walls), device_event_ms=repr(h_ms),
          svd_library_ms=repr(svd_ms), svd_gesvd_ms=repr(gesvd_ms), default_driver_residual=default_resid,
          steps_s=json.dumps(steps))
    res["hsvd"] = {"best_of_2_s": h_best, "walls_s": h_walls, "device_event_ms": h_ms, "svd_library_ms": svd_ms,
                   "svd_gesvd_ms": gesvd_ms, "default_driver_residual": default_resid,
                   "orthonormality": orth,
                   "residual": resid, "estimate": float(err.item()), "subspace_vs_cpu": span, "steps_s": steps}
    del A, U, u_t, v_t
    torch.cuda.empty_cache()

    # 15. the rest at small sizes, on the card against the port's CPU path
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 1100)

    def both(x, split=None):
        return ht.array(x, split=split), ht.array(x, split=split, device="cpu")

    def close(got, want, rtol, atol, what):
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = float(np.abs(g - w).max())
        check(np.allclose(g, w, rtol=rtol, atol=atol), f"{what}: off the CPU path by {err}")
        return err

    def signs(x, ref, axis):
        s = np.sign(np.sum(x * ref, axis=1 - axis, keepdims=True))
        s[s == 0] = 1
        return x * (s if axis == 0 else s.reshape(1, -1))

    errs = {}
    tall = rng.standard_normal((4096, 64)).astype(np.float32)
    g, c_ = both(tall, 0)
    (qg, rg), (qc, rc) = ht.linalg.qr(g), ht.linalg.qr(c_)
    errs["qr_R"] = close(signs(rg.numpy(), rc.numpy(), 0), rc.numpy(), 0, 1e-5 * np.abs(tall).max() * 10, "qr R")
    errs["qr_QR_minus_A"] = float(np.abs(qg.numpy() @ rg.numpy() - tall).max())
    check(errs["qr_QR_minus_A"] <= 1e-4 * np.abs(tall).max(), f"qr: |QR - A| {errs['qr_QR_minus_A']}")
    sq = rng.standard_normal((96, 64)).astype(np.float32)
    g, c_ = both(sq)
    sg, sc = ht.linalg.svd(g), ht.linalg.svd(c_)
    errs["svd_S"] = close(sg.S.numpy(), sc.S.numpy(), 1e-5 * 10, 0, "svd S")
    errs["pinv"] = close(ht.linalg.pinv(g).numpy(), ht.linalg.pinv(c_).numpy(), 0,
                         1e-3 * np.abs(np.linalg.pinv(sq)).max(), "pinv")
    spd = rng.standard_normal((64, 64))
    spd = spd @ spd.T + 64 * np.eye(64)
    rhs = rng.standard_normal(64)
    (Ag, Ac), (bg, bc), (x0g, x0c) = both(spd), both(rhs), both(np.zeros(64))
    errs["cg"] = close(ht.linalg.cg(Ag, bg, x0g).numpy(), ht.linalg.cg(Ac, bc, x0c).numpy(), 0, 1e-10, "cg")
    sym = rng.standard_normal((48, 48))
    sym = sym + sym.T
    v0 = rng.standard_normal(48)
    (Sg, Sc), (vg, vc) = both(sym), both(v0)
    (Vg, Tg), (Vc, Tc) = ht.linalg.lanczos(Sg, 20, v0=vg), ht.linalg.lanczos(Sc, 20, v0=vc)
    errs["lanczos_T"] = close(Tg.numpy(), Tc.numpy(), 0, 1e-10, "lanczos T")
    errs["lanczos_V"] = close(Vg.numpy(), Vc.numpy(), 0, 1e-10, "lanczos V")
    cube = rng.standard_normal((40, 30, 20)).astype(np.float32)
    x = ht.array(cube, split=0)
    x.resplit_(1)
    check(x.split == 1 and np.array_equal(x.numpy(), cube), "resplit_ 0 -> 1")
    x.resplit_(0)
    check(x.split == 0 and np.array_equal(x.numpy(), cube), "resplit_ 1 -> 0")
    pts, other = rng.standard_normal((500, 16)).astype(np.float32), rng.standard_normal((300, 16)).astype(np.float32)
    (Xg, Xc), (Yg, Yc) = both(pts, 0), both(other, 0)
    dg, dc = ht.spatial.cdist(Xg, Yg).numpy(), ht.spatial.cdist(Xc, Yc).numpy()
    scale = 1e-5 * ((pts * pts).sum(1)[:, None] + (other * other).sum(1)[None, :])
    errs["cdist_squared_over_bound"] = float((np.abs(dg.astype(np.float64) ** 2 - dc.astype(np.float64) ** 2) / scale).max())
    check(errs["cdist_squared_over_bound"] <= 1.0, f"cdist off the CPU path: {errs['cdist_squared_over_bound']}")
    sizes = {"qr": "4096x64 split 0", "svd": "96x64", "pinv": "96x64", "cg": "64 f64", "lanczos": "48 m=20 f64 v0",
             "resplit": "40x30x20 0->1->0", "cdist": "500x16 vs 300x16 split 0"}
    phase("linalg_small", sizes=json.dumps(sizes), errs=json.dumps(errs), phase_s=repr(time.perf_counter() - t_phase))
    res["small"] = errs
    return res


@contextlib.contextmanager
def d2h_bytes(moved: list):
    """Every device-to-host copy the block makes from Python: ``item``, ``tolist``,
    ``cpu``, ``numpy``, ``to`` a host device and the scalar conversions of a CUDA tensor
    append the bytes they move to ``moved``. (The counts torch itself reads back inside a
    boolean mask or ``nonzero`` are not seen; they are counts.)"""
    import torch

    T = torch.Tensor
    names = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")
    saved = {n: getattr(T, n) for n in names + ("to",)}

    def counted(n):
        orig = saved[n]

        def f(self, *args, **kwargs):
            if self.is_cuda:
                moved.append(self.numel() * self.element_size())
            return orig(self, *args, **kwargs)

        return f

    def to(self, *args, **kwargs):
        res = saved["to"](self, *args, **kwargs)
        if self.is_cuda and isinstance(res, torch.Tensor) and not res.is_cuda:
            moved.append(res.numel() * res.element_size())
        return res

    for n in names:
        setattr(T, n, counted(n))
    T.to = to
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(T, n, f)


# the manipulation benchmark (heat_tpu's benchmarks/cb/manipulations.py; Heat's
# benchmarks/cb/manipulations.py:18-32) at the reference's largest size, N = 40,000,000 f32:
# Heat's 1000 x 40,000
MANIP_ROWS, MANIP_COLS = 1000, 40_000
MANIP_N = MANIP_ROWS * MANIP_COLS
D2H_LIMIT = 1 << 16  # bytes an op may read back: counts and splitters, never the array


def array_phases(ht, dev) -> dict:
    """The array API on the card (phase 16): heat_tpu's manipulation benchmark through
    the port at N = 40,000,000 f32, data from the port's ``ht.random`` on the card, each
    op checked against the port's CPU path on a CPU copy of its input (values and indices
    exact; percentile and median within 1e-6 relative), its result on the card, its
    device-to-host bytes counted (:func:`d2h_bytes`), and timed: best of 3 wall, the
    device time between CUDA events, its bytes bound at 3.35 TB/s and the one torch call
    that computes the same at one rank, where there is one. Then the random streams on
    the card against the CPU's, and ``KMeans(init="random", random_state=s)`` at bench.py's
    10M x 64."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card beside this phase's figures
    res = {"ops": {}, "nvidia_smi": smi}
    t_phase = time.perf_counter()

    def record(op, fn, check_fn, nbytes, library=None, library_note=None):
        """Run ``fn()`` once with its device-to-host bytes counted, check it, time it."""
        moved = []
        torch.cuda.synchronize()
        with d2h_bytes(moved):
            out = fn()
            torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            check(not hasattr(o, "larray") or o.larray.is_cuda, f"{op}: a result is not on the card")
        check(sum(moved) <= D2H_LIMIT, f"{op}: {sum(moved)} bytes came back to the host ({moved[:8]})")
        detail = check_fn(out) or {}
        best, walls = best_s(fn, 3)
        dev_ms = cuda_ms(fn, reps=3, warmup=1)
        lib_ms = None
        if library is not None:
            try:
                lib_ms = cuda_ms(library, reps=3, warmup=1)
            except RuntimeError as exc:  # a torch call that refuses this size
                library_note = f"{library_note}: {str(exc).splitlines()[0][:120]}"
        entry = {"best_of_3_ms": 1e3 * best, "walls_ms": [1e3 * w for w in walls], "device_ms": dev_ms,
                 "bytes": nbytes, "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "library_ms": lib_ms,
                 "library": library_note, "d2h_bytes": sum(moved), **detail}
        res["ops"][op] = entry
        phase("manip", op=op, **{k: (json.dumps(v) if isinstance(v, (list, dict)) else v) for k, v in entry.items()})
        return out

    def same(got, want, what, rtol=0.0):
        g, w = got.larray.cpu(), want.larray
        check(got.gshape == want.gshape and got.split == want.split and got.dtype is want.dtype,
              f"{what}: {got.gshape} split {got.split} {got.dtype} against the CPU path's {want.gshape} "
              f"split {want.split} {want.dtype}")
        if rtol:
            err = float(((g.double() - w.double()).abs() / w.double().abs().clamp_min(1e-30)).max())
            check(err <= rtol, f"{what}: {err} relative off the CPU path")
            return {"max_rel_err": err}
        check(torch.equal(g, w), f"{what}: differs from the CPU path")
        return {"equal_to_cpu": True}

    # the data: the port's random stream on the card, the same draw on the CPU bit for bit
    ht.random.seed(SEED + 2000)
    t0 = time.perf_counter()
    x2 = ht.random.random((MANIP_ROWS, MANIP_COLS), split=0)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    ht.random.seed(SEED + 2000)
    x2_cpu = ht.random.random((MANIP_ROWS, MANIP_COLS), split=0, device="cpu")
    check(x2.larray.is_cuda and torch.equal(x2.larray.cpu(), x2_cpu.larray), "the uniform draw differs from the CPU's")
    check(ht.random.get_state()[2] == MANIP_N, "the counter did not advance by the draw's elements")
    res["draw_s"] = draw_s
    x1 = ht.reshape(x2, (MANIP_N,), new_split=0)
    x1_cpu = ht.reshape(x2_cpu, (MANIP_N,), new_split=0)
    # the benchmark's arrays: (1000, 40000) split 0, and three with splits 1, None, 1
    parts = [ht.resplit(x2, 1), ht.array(x2.larray, split=None), ht.resplit(x2, 1)]
    parts_cpu = [ht.resplit(x2_cpu, 1), ht.array(x2_cpu.larray, split=None, device="cpu"), ht.resplit(x2_cpu, 1)]
    B = 4 * MANIP_N  # the payload's bytes

    record("reshape_new_split1", lambda: ht.reshape(x2, (250, 160_000), new_split=1),
           lambda o: same(o, ht.reshape(x2_cpu, (250, 160_000), new_split=1), "reshape") | {
               "note": "a view at one rank: every redistribute is the identity"},
           0, library=lambda: x2.larray.reshape(250, 160_000).contiguous(),
           library_note="Tensor.reshape().contiguous() (a view: no copy)")
    record("concatenate_1_none_1", lambda: ht.concatenate(parts, axis=1),
           lambda o: same(o, ht.concatenate(parts_cpu, axis=1), "concatenate"),
           3 * B + 3 * B, library=lambda: torch.cat([p.larray for p in parts], dim=1), library_note="torch.cat")
    record("resplit_0_1", lambda: ht.resplit(x2, 1), lambda o: same(o, ht.resplit(x2_cpu, 1), "resplit"), 2 * B,
           library=None, library_note="none: at one rank a resplit is a copy")
    sorted_cpu = ht.sort(x1_cpu)

    def sort_checked(o):
        check(torch.equal(o[0].larray, x1.larray[o[1].larray]), "sort: values != x[indices]")
        return same(o[0], sorted_cpu[0], "sort values") | same(o[1], sorted_cpu[1], "sort indices")

    record("sort", lambda: ht.sort(x1), sort_checked, B + B + 2 * B,
           library=lambda: torch.sort(x1.larray, stable=True), library_note="torch.sort(stable=True)")
    del sorted_cpu
    top_cpu = ht.topk(x1_cpu, 64)
    record("topk_64", lambda: ht.topk(x1, 64),
           lambda o: same(o[0], top_cpu[0], "topk values") | same(o[1], top_cpu[1], "topk indices"),
           B, library=lambda: torch.topk(x1.larray, 64), library_note="torch.topk")
    record("percentile_25_50_99", lambda: ht.percentile(x1, [25, 50, 99]),
           lambda o: same(o, ht.percentile(x1_cpu, [25, 50, 99]), "percentile", rtol=1e-6),
           B, library=lambda: torch.quantile(x1.larray, torch.tensor([0.25, 0.5, 0.99], device=dev)),
           library_note="torch.quantile")
    xm = ht.reshape(x1, (MANIP_N // 128, 128), new_split=0)
    xm_cpu = ht.reshape(x1_cpu, (MANIP_N // 128, 128), new_split=0)
    record("median_axis0", lambda: ht.median(xm, axis=0),
           lambda o: same(o, ht.median(xm_cpu, axis=0), "median", rtol=1e-6),
           B, library=lambda: torch.quantile(xm.larray, 0.5, dim=0), library_note="torch.quantile(q=0.5, dim=0)")
    xu, xu_cpu = ht.floor(x1 * 512), ht.floor(x1_cpu * 512)
    record("unique_floor_512u", lambda: ht.unique(xu),
           lambda o: same(o, ht.unique(xu_cpu), "unique") | {"n_unique": o.gshape[0]},
           B, library=lambda: torch.unique(xu.larray, sorted=True), library_note="torch.unique(sorted=True)")
    sel = len(range(3, MANIP_N, 7))
    record("slice_3_7", lambda: x1[3::7], lambda o: same(o, x1_cpu[3::7], "x[3::7]"), 2 * 4 * sel,
           library=lambda: x1.larray[3::7].contiguous(), library_note="Tensor[3::7].contiguous()")
    mask, mask_cpu = x1 > 0.5, x1_cpu > 0.5
    record("mask_gt_half", lambda: x1[mask], lambda o: same(o, x1_cpu[mask_cpu], "x[x > 0.5]"),
           B + MANIP_N + 4 * int(mask.larray.sum()), library=lambda: torch.masked_select(x1.larray, mask.larray),
           library_note="torch.masked_select")

    def assign():
        y = ht.copy(x1)
        y[::5] = 0.0
        return y

    def assign_cpu():
        y = ht.copy(x1_cpu)
        y[::5] = 0.0
        return y

    def assign_library():
        y = x1.larray.clone()
        y[::5] = 0.0
        return y

    record("setitem_step5", assign, lambda o: same(o, assign_cpu(), "x[::5] = 0"), 2 * B,
           library=assign_library, library_note="Tensor.clone() and [::5] = 0 (the copy included, as in the op)")
    # a Python scalar beside an array on the card is filled there as a 0-d tensor (no copy
    # from the host, no wait for the stream): its device time against torch's, and every
    # binary function of the port with the scalar second and first, equal to the CPU path
    # (within 1e-6 relative for the transcendental ones, whose libraries differ by an ulp)
    record("scalar_mul_512", lambda: x1 * 512, lambda o: same(o, x1_cpu * 512, "x * 512"), 2 * B,
           library=lambda: x1.larray * 512, library_note="Tensor * 512")
    srng = np.random.default_rng(SEED + 2500)
    fl, it = srng.uniform(0.5, 4.0, 1000).astype(np.float32), srng.integers(1, 20, 1000).astype(np.int32)
    inexact = {"pow", "hypot", "atan2", "logaddexp", "logaddexp2"}
    scalar_ops = 0
    for names, data, scalar in (("add sub mul div floordiv mod fmod pow maximum minimum hypot atan2 copysign "
                                 "logaddexp logaddexp2 eq ne lt le gt ge isclose logical_and logical_or logical_xor",
                                 fl, 1.5),
                                ("add mul mod fmod floordiv gcd lcm bitwise_and bitwise_or bitwise_xor "
                                 "left_shift right_shift", it, 3)):
        g, c = ht.array(data, split=0), ht.array(data, split=0, device="cpu")
        for name in names.split():
            fn = getattr(ht, name)
            for first in (False, True):
                args_g, args_c = ((scalar, g), (scalar, c)) if first else ((g, scalar), (c, scalar))
                got = fn(*args_g)
                check(got.larray.is_cuda, f"{name} with a scalar: the result is not on the card")
                same(got, fn(*args_c), f"{name} with a scalar {'first' if first else 'second'}",
                     rtol=1e-6 if name in inexact else 0.0)
                scalar_ops += 1
    phase("scalar_operands", calls_equal_to_cpu=scalar_ops)
    res["scalar_operands"] = scalar_ops
    del parts, parts_cpu, xm, xm_cpu, xu, xu_cpu, mask, mask_cpu, x2, x2_cpu, x1, x1_cpu
    torch.cuda.empty_cache()

    # the random streams on the card against the CPU's: uniform, integers and permutations
    # bit for bit, normal within 4 ulp (float32) and 32 (float64)
    streams = {}
    for name, draw in (("rand_f32", lambda d: ht.random.rand(2000, 1000, split=0, device=d)),
                       ("rand_f64", lambda d: ht.random.rand(1000, 1000, dtype=ht.float64, split=1, device=d)),
                       ("randint", lambda d: ht.random.randint(-5, 10**6, (2000, 1000), split=0, device=d)),
                       ("randint_i64", lambda d: ht.random.randint(0, 2**30, (10**6,), dtype=ht.int64, device=d)),
                       ("randperm", lambda d: ht.random.randperm(10**6, device=d)),
                       ("randn_f32", lambda d: ht.random.randn(2000, 1000, split=0, device=d)),
                       ("randn_f64", lambda d: ht.random.randn(1000, 1000, dtype=ht.float64, device=d))):
        ht.random.seed(SEED + 3000)
        t0 = time.perf_counter()
        g = draw("gpu")
        torch.cuda.synchronize()
        t_draw = time.perf_counter() - t0
        ht.random.seed(SEED + 3000)
        c = draw("cpu")
        gv, cv = g.larray.cpu(), c.larray
        if name.startswith("randn"):
            ulps = 4 if name.endswith("f32") else 32
            err = float(((gv.double() - cv.double()).abs() / torch.from_numpy(np.spacing(np.abs(cv.numpy())))
                         .double()).max())
            check(err <= ulps, f"{name}: {err} ulp off the CPU's draw")
            streams[name] = {"max_ulp": err, "first_call_s": t_draw}
        else:
            check(torch.equal(gv, cv), f"{name}: the card's draw differs from the CPU's")
            streams[name] = {"equal": True, "first_call_s": t_draw}
    ht.random.seed(SEED + 3000)
    rand_ms = cuda_ms(lambda: ht.random.rand(MANIP_ROWS, MANIP_COLS, split=0), reps=3, warmup=1)
    streams["rand_40m_device_ms"] = rand_ms
    streams["rand_40m_bound_ms"] = 1e3 * B / PEAK_BYTES_PER_S
    phase("random_streams", **{k: json.dumps(v) if isinstance(v, dict) else v for k, v in streams.items()})
    res["random"] = streams

    # KMeans(init="random", random_state=s) at bench.py's 10M x 64: the card's initial
    # centers are heat_tpu's stream's rows and equal the CPU path's
    x, _, true = blobs(N, D, K, SEED, dev)
    X = ht.array(x, split=0)
    km = ht.cluster.KMeans(n_clusters=K, init="random", random_state=SEED + 4000, max_iter=MAX_ITER, tol=-1.0)
    km._initialize_cluster_centers(X)
    init_card = km._cluster_centers.larray.cpu()
    cpu_km = ht.cluster.KMeans(n_clusters=K, init="random", random_state=SEED + 4000)
    cpu_km._initialize_cluster_centers(ht.array(x.cpu(), split=0, device="cpu"))
    check(torch.equal(init_card, cpu_km._cluster_centers.larray), "KMeans random init differs from the CPU path's")
    from heat_tpu_torch.core import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    km.fit(X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(launches["kmeans_assign"] == MAX_ITER + 1, f"KMeans random init: K1 launches {launches}")
    check(km.cluster_centers_.larray.is_cuda and bool(torch.isfinite(km.cluster_centers_.larray).all()),
          "KMeans random init: fitted centers")
    phase("kmeans_random_init", n=N, d=D, k=K, init_equal_to_cpu=True, k1_launches=launches["kmeans_assign"],
          first_fit_s=repr(fit_s), inertia=repr(km.inertia_))
    res["kmeans_random_init"] = {"first_fit_s": fit_s, "inertia": km.inertia_, "k1_launches": launches["kmeans_assign"]}
    del x, X, true, km
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# the clustering slice: heat_tpu's cluster benchmark (benchmarks/cb/cluster.py: k = 4 on
# create_spherical_dataset of 5,000 points a ball, max_iter 30, random_state 1) and the
# estimators at bench.py's 10M x 64, k = 8
CLUSTER_BENCH_N = 5000
CHECK_ROWS = 200_000  # the 10M paths are held to the CPU path at this many rows
SPECTRAL_N, SPECTRAL_CHECK_N = 4096, 512  # points a ball: 16,384 and 2,048 in all


def pp_seed(ht, X, random_state: int, p: int = 2):
    """The greedy ++ seeding of ``KMeans(init="kmeans++", random_state=...)`` (or, at
    ``p`` = 1, of KMedians) on X: (centers, global row indices, the key's seed)."""
    from heat_tpu_torch.cluster import _kcluster
    from heat_tpu_torch.cluster.batchparallelclustering import _plus_plus
    from heat_tpu_torch.core import random

    random.seed(random_state)
    seed = int(random.randint(0, 2**31 - 1, (1,), device=X.device, comm=X.comm).larray.item())
    centers, picks = _plus_plus(X.larray.float(), K, p, random._key(seed), _kcluster._rows_of(X))
    return centers, picks, seed


def explain_picks(xg, xc, picks_g, picks_c, seed: int, p: int) -> dict:
    """Where the card's and the CPU's ++ picks part: the first step that differs, redone
    on both from the same earlier rows. Its probabilities differ only by the distances'
    rounding, and its cumulative sums are the same scan (``random._xla_cumsum``) on each.
    A candidate that differs is explained when its target lies within
    γ_n·Σp + Σ|p_card − p_cpu| of both cumulative sums (float64 on the card's p) at the
    boundary between the two rows; with equal candidates, a winner that differs is
    explained when the two winners' potentials lie within γ_n of each other."""
    import torch

    from heat_tpu_torch.cluster.batchparallelclustering import _cdist_p
    from heat_tpu_torch.core import random

    step = int(torch.nonzero(picks_g.cpu() != picks_c.cpu())[0])
    keys = random._split(random._key(seed), K)
    m = 2 + int(np.log(K))
    probs, cands, pots = [], [], []
    for x in (xg, xc):
        d = _cdist_p(x, x[picks_c[:step].to(x.device)], p).amin(1) ** 2
        pr = d / torch.clamp_min(torch.sum(d), 1e-30)
        cand = random._key_choice(keys[step], m, pr)
        cd = _cdist_p(x, x[cand], p) ** 2
        probs.append(pr)
        cands.append(cand.cpu())
        pots.append(torch.sum(torch.minimum(d[:, None], cd), 0).double().cpu())
    n = xg.shape[0]
    pg = probs[0].double()
    cum = torch.cumsum(pg, 0).cpu()
    bound = gamma(n) * float(pg.sum()) + float((pg - probs[1].to(pg.device).double()).abs().sum())
    targets = random._choice_draws(keys[step], m, random._xla_cumsum(probs[0])[-1]).double().cpu()
    out = {"step": step, "bound": bound, "candidates_card": cands[0].tolist(), "candidates_cpu": cands[1].tolist()}
    gaps = []
    for j in range(m):
        a, b = sorted((int(cands[0][j]), int(cands[1][j])))
        if a != b:
            r = float(targets[j])
            gaps.append(max(abs(r - float(cum[a])), abs(r - float(cum[b - 1]))))
    if gaps:
        out["gaps"] = gaps
        out["explained"] = max(gaps) <= bound
    else:
        wg, wc = int(torch.argmin(pots[0])), int(torch.argmin(pots[1]))
        rel = abs(float(pots[0][wg] - pots[0][wc])) / max(float(pots[0][wg]), 1e-300)
        out.update(winners=[wg, wc], potential_rel_gap=rel, explained=wg != wc and rel <= gamma(n))
    return out


def against_blobs(centers, true, seeds=None) -> dict:
    """The fit against the blobs' true centers: each true center's nearest fitted one by
    the largest coordinate difference (``center_err``, the worst of them; the fitted
    centers so matched, ``distinct``), and how many blobs hold a seed (a seed row's
    nearest true center)."""
    import torch

    err = (true.double()[:, None, :] - centers.double()[None]).abs().amax(-1)
    near = err.min(1)
    out = {"center_err": float(near.values.max()), "distinct": len(set(near.indices.tolist()))}
    if seeds is not None:
        out["seeded"] = len(set(torch.cdist(seeds.double(), true.double()).argmin(1).tolist()))
    return out


def kmeans_pp_phase(ht, kernels, dev) -> dict:
    """[kmeans_pp_fit]: ``KMeans(n_clusters=8, init="kmeans++", random_state=s,
    max_iter=30, tol=-1)`` at 10M x 64: the seeding's picks against the CPU path's on a
    CPU copy (equal, or each difference explained by :func:`explain_picks`), the fit's
    K1 launches counted (31), its centers against the blobs', its host reads from a
    seeded start (the loop reads nothing before its end), the seeding and the fit timed,
    and one fit traced."""
    import torch

    x, _, true = blobs(N, D, K, SEED, dev)
    X = ht.array(x, split=0)
    rs = SEED + 5000
    t0 = time.perf_counter()
    centers_g, picks_g, seed = pp_seed(ht, X, rs)
    torch.cuda.synchronize()
    seed_first_s = time.perf_counter() - t0
    seed_s, seed_walls = best_s(lambda: pp_seed(ht, X, rs), 2)
    xc = x.cpu()
    _, picks_c, _ = pp_seed(ht, ht.array(xc, split=0, device="cpu"), rs)
    picks_equal = torch.equal(picks_g.cpu(), picks_c)
    picks = {"equal": picks_equal, "card": picks_g.tolist(), "cpu": picks_c.tolist()}
    if not picks_equal:
        picks.update(explain_picks(x, xc, picks_g, picks_c, seed, 2))
        check(picks["explained"], f"k-means++ picks differ from the CPU path's beyond rounding: {picks}")
    km = ht.cluster.KMeans(n_clusters=K, init="kmeans++", random_state=rs, max_iter=MAX_ITER, tol=-1.0)
    km._initialize_cluster_centers(X)
    check(torch.equal(km._cluster_centers.larray, centers_g), "the fit's seeding differs from pp_seed's")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    km.fit(X)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(km.n_iter_ == MAX_ITER and counts["kmeans_assign"] == MAX_ITER + 1,
          f"k-means++ fit: {km.n_iter_} iterations, launches {counts}")
    blobs_fit = against_blobs(km.cluster_centers_.larray, true, x[picks_g])
    if blobs_fit["seeded"] == K:
        # a cluster mean of ~n/k unit-noise rows: 6 standard errors
        check(blobs_fit["distinct"] == K and blobs_fit["center_err"] < 6.0 / (N / K) ** 0.5,
              f"k-means++ fit: a seed in every blob, but {blobs_fit}")
    else:
        # a blob without a seed: Lloyd's finds another optimum; it never raises the objective
        start = ht.cluster.KMeans(n_clusters=K, init=ht.array(centers_g), max_iter=0, tol=-1.0).fit(X)
        check(km.inertia_ <= start.inertia_, f"k-means++ fit: inertia {km.inertia_} above its seeds' {start.inertia_}")
    # from a seeded start the loop reads back only n_iter and the inertia, at its end
    moved: list = []
    seeded = ht.cluster.KMeans(n_clusters=K, init=ht.array(centers_g), max_iter=MAX_ITER, tol=-1.0)
    with d2h_bytes(moved):
        seeded.fit(X)
    check(len(moved) == 2, f"the Lloyd loop read back {moved} bytes")
    fit_s, fit_walls = best_s(lambda: km.fit(X), 2)
    lloyd_s, lloyd_walls = best_s(lambda: seeded.fit(X), 2)
    prof = profile_device(lambda: km.fit(X), inference=False)
    if "device_busy_ms" in prof:
        prof["host_ms_per_iteration"] = (prof["traced_wall_ms"] - prof["device_busy_ms"]) / (MAX_ITER + 1)
    res = {"picks": picks, "seeding_first_s": seed_first_s, "seeding_best_of_2_s": seed_s, "seeding_walls_s": seed_walls,
           "fit_first_s": first_s, "fit_best_of_2_s": fit_s, "fit_walls_s": fit_walls,
           "lloyd_from_seeds_best_of_2_s": lloyd_s, "lloyd_walls_s": lloyd_walls, "k1_launches": counts["kmeans_assign"],
           "blobs": blobs_fit, "inertia": km.inertia_, "loop_reads": moved, "profile": prof}
    phase("kmeans_pp_fit", n=N, d=D, k=K, n_iter=km.n_iter_, k1_launches=counts["kmeans_assign"],
          picks_equal_cpu=picks_equal, picks=json.dumps(picks), seeding_s=repr(seed_s), fit_s=repr(fit_s),
          lloyd_from_seeds_s=repr(lloyd_s), blobs=json.dumps(blobs_fit), loop_host_reads=json.dumps(moved),
          profile=json.dumps(prof))
    return res


def fits_equal(a, b, what: str) -> None:
    """Two fits of one estimator, on the card and on a CPU copy: n_iter and labels equal,
    centers within 1e-5 of their largest magnitude."""
    import torch

    check(a.n_iter_ == b.n_iter_, f"{what}: {a.n_iter_} iterations on the card, {b.n_iter_} on the CPU")
    check(torch.equal(a.labels_.larray.cpu(), b.labels_.larray), f"{what}: labels differ between card and CPU")
    ca, cb = a.cluster_centers_.larray.cpu().double(), b.cluster_centers_.larray.double()
    err = float((ca - cb).abs().max())
    check(err <= 1e-5 * max(1.0, float(cb.abs().max())), f"{what}: centers differ by {err}")


def cluster_phases(ht, dev) -> dict:
    """The clustering slice on the card (phase 17): heat_tpu's cluster benchmark, the
    10M x 64 KMedians, KMedoids and BatchParallelKMeans fits, and Spectral; each against
    the port's CPU path on a CPU copy of its data, with K1's launches counted."""
    import torch

    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.utils.data.spherical import create_spherical_dataset

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    res = {"nvidia_smi": smi}
    t_phase = time.perf_counter()

    # heat_tpu's cluster benchmark: its four functions, data included, best of 3
    bench = {
        "kmeans": lambda m, x: m.cluster.KMeans(n_clusters=4, init="kmeans++", max_iter=30, random_state=1).fit(x),
        "kmedians": lambda m, x: m.cluster.KMedians(n_clusters=4, init="kmedians++", max_iter=30,
                                                    random_state=1).fit(x),
        "kmedoids": lambda m, x: m.cluster.KMedoids(n_clusters=4, init="kmedoids++", random_state=1).fit(x),
        "batchparallel_kmeans": lambda m, x: m.cluster.BatchParallelKMeans(n_clusters=4, init="k-means++", max_iter=30,
                                                                           random_state=1).fit(x),
    }
    res["cluster_bench"] = {}
    for name, fn in bench.items():
        x = create_spherical_dataset(CLUSTER_BENCH_N)
        kernels.reset_launch_counts()
        on_card = fn(ht, x)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["kmeans_assign"]
        check(x.larray.is_cuda and on_card.cluster_centers_.larray.is_cuda, f"{name}: not on the card")
        fits_equal(on_card, fn(ht, ht.array(x.larray.cpu(), split=0, device="cpu")), f"cluster_bench {name}")
        best, walls = best_s(lambda: fn(ht, create_spherical_dataset(CLUSTER_BENCH_N)), 3)
        fit_best, _ = best_s(lambda: fn(ht, x), 3)
        res["cluster_bench"][name] = {"best_of_3_s": best, "walls_s": walls, "fit_alone_best_of_3_s": fit_best,
                                      "n_iter": on_card.n_iter_, "k1_launches": launches}
        phase("cluster_bench", fn=name, n=4 * CLUSTER_BENCH_N, n_iter=on_card.n_iter_, k1_launches=launches,
              equal_to_cpu=True, best_of_3_s=repr(best), fit_alone_best_of_3_s=repr(fit_best))
        del x, on_card
    torch.cuda.empty_cache()

    # the estimators at 10M x 64, k = 8, each held to the CPU path at 200,000 rows; the ++
    # seedings compared on their own, the fits from the CPU's seeds
    fits = {
        "kmedians_fit": (lambda init, rs: ht.cluster.KMedians(n_clusters=K, init=init, max_iter=MAX_ITER,
                                                              random_state=rs), "kmedians++", 1),
        "kmedoids_fit": (lambda init, rs: ht.cluster.KMedoids(n_clusters=K, init=init, max_iter=MAX_ITER,
                                                              random_state=rs), "kmedoids++", 2),
    }
    xs, _, _ = blobs(CHECK_ROWS, D, K, SEED + 6000, dev)
    Xs, Xc = ht.array(xs, split=0), ht.array(xs.cpu(), split=0, device="cpu")
    for name, (make, init, p) in fits.items():
        rs = SEED + 6100
        _, picks_g, seed = pp_seed(ht, Xs, rs, p)
        _, picks_c, _ = pp_seed(ht, Xc, rs, p)
        picks = {"equal": torch.equal(picks_g.cpu(), picks_c)}
        if not picks["equal"]:
            picks.update(explain_picks(xs, xs.cpu(), picks_g, picks_c, seed, p))
            check(picks["explained"], f"{name}: ++ picks differ beyond rounding: {picks}")
        cpu_init = make(init, rs)
        cpu_init._initialize_cluster_centers(Xc)
        seeds = cpu_init._cluster_centers
        a = make(ht.array(seeds.larray.to(dev)), None).fit(Xs)
        b = make(seeds, None).fit(Xc)
        fits_equal(a, b, f"{name} at {CHECK_ROWS} rows")
        res[name] = {"check_rows": CHECK_ROWS, "picks": picks, "check_n_iter": a.n_iter_}
    del xs, Xs, Xc
    torch.cuda.empty_cache()
    # BatchParallelKMeans: one block at one rank, its ++ seeding inside
    xs, _, _ = blobs(CHECK_ROWS, D, K, SEED + 6000, dev)
    bp = lambda: ht.cluster.BatchParallelKMeans(n_clusters=K, max_iter=MAX_ITER, random_state=SEED + 6200)  # noqa: E731
    fits_equal(bp().fit(ht.array(xs, split=0)), bp().fit(ht.array(xs.cpu(), split=0, device="cpu")),
               f"batchparallel_fit at {CHECK_ROWS} rows")
    res["batchparallel_fit"] = {"check_rows": CHECK_ROWS}
    del xs
    torch.cuda.empty_cache()

    x, _, true = blobs(N, D, K, SEED, dev)
    X = ht.array(x, split=0)
    full = {
        "kmedians_fit": lambda: ht.cluster.KMedians(n_clusters=K, init="kmedians++", max_iter=MAX_ITER,
                                                    random_state=SEED + 6300),
        "kmedoids_fit": lambda: ht.cluster.KMedoids(n_clusters=K, init="kmedoids++", max_iter=MAX_ITER,
                                                    random_state=SEED + 6300),
        "batchparallel_fit": lambda: ht.cluster.BatchParallelKMeans(n_clusters=K, max_iter=MAX_ITER,
                                                                    random_state=SEED + 6300),
    }
    for name, make in full.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        est = make().fit(X)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = kernels.launch_counts()["kmeans_assign"]
        centers = est.cluster_centers_.larray
        check(centers.is_cuda and bool(torch.isfinite(centers).all()) and est.labels_.larray.is_cuda,
              f"{name}: centers or labels not finite on the card")
        blobs_fit = against_blobs(centers, true)
        best, walls = best_s(lambda: make().fit(X), 2)
        res[name].update(n=N, n_iter=est.n_iter_, k1_launches=launches, first_s=first_s, best_of_2_s=best,
                         walls_s=walls, blobs=blobs_fit)
        phase(name, n=N, d=D, k=K, n_iter=est.n_iter_, k1_launches=launches, equal_to_cpu_at=CHECK_ROWS,
              picks=json.dumps(res[name].get("picks")), first_s=repr(first_s), best_of_2_s=repr(best),
              blobs=json.dumps(blobs_fit))
        del est
        torch.cuda.empty_cache()
    del x, X, true
    torch.cuda.empty_cache()

    # Spectral at its defaults (rbf, gamma 1, n_lanczos 300) on create_spherical_dataset
    def balls_recovered(labels, per):
        """The share of each ball's points that carry its majority label, and whether the
        four majorities differ."""
        lab = labels.reshape(4, per)
        major = [int(torch.mode(row).values) for row in lab]
        share = min(float((row == m).float().mean()) for row, m in zip(lab, major))
        return share, len(set(major)) == 4

    xs = create_spherical_dataset(SPECTRAL_CHECK_N)
    ht.random.seed(SEED + 6400)
    a = ht.cluster.Spectral(n_clusters=4).fit(xs)
    ht.random.seed(SEED + 6400)
    b = ht.cluster.Spectral(n_clusters=4).fit(ht.array(xs.larray.cpu(), split=0, device="cpu"))
    check(torch.equal(a.labels_.larray.cpu(), b.labels_.larray), "spectral: labels differ between card and CPU")
    del xs, a, b
    x = create_spherical_dataset(SPECTRAL_N)
    ht.random.seed(SEED + 6401)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sp = ht.cluster.Spectral(n_clusters=4).fit(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()["kmeans_assign"]
    share, distinct = balls_recovered(sp.labels_.larray, SPECTRAL_N)
    check(distinct and share >= 0.99, f"spectral: the balls are not recovered (share {share}, distinct {distinct})")
    best, walls = best_s(lambda: ht.cluster.Spectral(n_clusters=4).fit(x), 2)
    res["spectral_fit"] = {"n": 4 * SPECTRAL_N, "first_s": first_s, "best_of_2_s": best, "walls_s": walls,
                           "k1_launches": launches, "ball_share": share, "kmeans_n_iter": sp._cluster.n_iter_,
                           "dtype": sp._cluster.cluster_centers_.dtype.__name__}
    phase("spectral_fit", n=4 * SPECTRAL_N, check_n=4 * SPECTRAL_CHECK_N, equal_to_cpu=True, ball_share=share,
          k1_launches=launches, embedding_dtype=res["spectral_fit"]["dtype"], first_s=repr(first_s),
          best_of_2_s=repr(best))
    del x, sp
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# the domain estimators' sizes (phase 18), the ones their users run: Heat's manipulation
# benchmark size for the FFTs (BASELINE.md:18, N = 40M as 1000 x 40,000), the north-star
# data for the scalers and GaussianNB (BASELINE.md:23-25, config #3), Heat's Lasso demo
# table (sugar.h5) and a synthetic table of the north-star width, and Heat's 2020
# distance-matrix strong-scaling size for KNN (BASELINE.md:11: SUSY, 40k rows, 18 features)
DOMAIN = {
    "fft_rows": 1000, "fft_cols": 40_000,
    "scaler_rows": N, "check_rows": 200_000,
    "lasso_rows": 1_000_000, "lasso_cols": 64, "lasso_check_rows": 20_000, "lasso_nonzero": 8,
    "knn_train": 40_000, "knn_test": 40_000, "knn_check": 4_000, "knn_features": 18, "knn_k": 5,
    "sparse_n": 1_000_000, "sparse_nnz": 10_000_000, "dense_n": 20_000, "dense_nnz": 1_000_000,
}


def blob_labels(n: int, k: int, seed: int, device):
    """The labels :func:`blobs` draws for its points (the same generator steps)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    torch.randn(k, D, generator=gen, device=device)
    return torch.randint(0, k, (n,), generator=gen, device=device)


def domain_phases(ht, dev) -> dict:
    """The L7 estimators, the FFTs and the DCSR matrix on the card (phase 18,
    ``[domain_*]`` lines): each step held to the port's CPU path on a CPU copy of its input
    (at the full size, or at ``check_rows`` rows where a CPU run of the full size would take
    minutes), its result on the card, at most ``D2H_LIMIT`` bytes read back to the host
    (counts and convergence scalars, never an array), timed best of 3 (Lasso and
    GaussianNB best of 2), and printed beside the bytes its work must move at 3.35 TB/s.
    Then integer division by zero on the card against the CPU path. No hand kernel runs
    here: heat_tpu's fft, sparse and estimators reach no pl.pallas_call."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    res = {"nvidia_smi": smi, "steps": {}}
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    def on_cpu(x):
        """A CPU copy of a DNDarray (same split) or tensor."""
        if isinstance(x, torch.Tensor):
            return x.cpu()
        return ht.array(x.larray.cpu(), is_split=x.split, device="cpu") if x.split is not None else \
            ht.array(x.larray.cpu(), device="cpu")

    def close(got, want, what, tol):
        """A card result against the CPU path's: dtype, shape and split equal, values within
        ``tol`` of the CPU result's largest magnitude (0: equal)."""
        g = got.larray if hasattr(got, "larray") else got
        w = want.larray if hasattr(want, "larray") else want
        if hasattr(got, "larray"):
            check(got.gshape == want.gshape and got.split == want.split and got.dtype is want.dtype,
                  f"{what}: {got.gshape} split {got.split} {got.dtype} against the CPU's {want.gshape} "
                  f"split {want.split} {want.dtype}")
        check(g.is_cuda, f"{what}: the result is not on the card")
        g = g.cpu()
        if tol == 0:
            check(torch.equal(g, w), f"{what}: differs from the CPU path")
            return 0.0
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        check(err <= tol * max(scale, 1e-30), f"{what}: {err} off the CPU path (largest magnitude {scale})")
        return err / max(scale, 1e-30)

    def step(name, fn, nbytes, reps=3, flops=0.0, rate=PEAK_FP32_FLOPS, **detail):
        """Run ``fn()`` once with its host readback counted, then time it best of
        ``reps``; print it beside its bytes (and operations) bound."""
        moved = []
        torch.cuda.synchronize()
        with d2h_bytes(moved):
            out = fn()
            torch.cuda.synchronize()
        check(sum(moved) <= D2H_LIMIT, f"{name}: {sum(moved)} bytes came back to the host ({moved[:8]})")
        best, walls = best_s(fn, reps)
        bound = max(1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / rate)
        entry = {"best_ms": 1e3 * best, "walls_ms": [1e3 * w for w in walls], "reps": reps, "bytes": nbytes,
                 "bound_ms": bound, "bound_by": "bytes" if 1e3 * nbytes / PEAK_BYTES_PER_S >= 1e3 * flops / rate
                 else "operations", "d2h_bytes": sum(moved), **detail}
        res["steps"][name] = entry
        phase(f"domain_{name}", **{k: (json.dumps(v) if isinstance(v, (list, dict)) else v) for k, v in entry.items()})
        return out

    # fft: 1000 x 40,000 f32 split 0, along axis 1, along axis 0 (the split axis: the pencil,
    # at one rank a local transform), rfft2 and the round trip ifft(fft(x))
    rows, cols = DOMAIN["fft_rows"], DOMAIN["fft_cols"]
    ht.random.seed(SEED + 8000)
    x = ht.random.random((rows, cols), split=0)
    xc = on_cpu(x)
    B = 4 * rows * cols
    ffts = {
        "fft_axis1": (lambda a: ht.fft.fft(a, axis=1), B + 2 * B),
        "fft_axis0_split": (lambda a: ht.fft.fft(a, axis=0), B + 2 * B),
        "rfft2": (lambda a: ht.fft.rfft2(a), B + 8 * rows * (cols // 2 + 1)),
        "ifft_fft_round_trip": (lambda a: ht.fft.ifft(ht.fft.fft(a, axis=1), axis=1), B + 2 * B + 2 * B + 2 * B),
    }
    for name, (fn, nbytes) in ffts.items():
        err = close(fn(x), fn(xc), name, 1e-5)
        step(name, lambda: fn(x), nbytes, shape=[rows, cols], max_err_over_scale=err, tolerance="1e-5 of max|ref|")
    back = ht.fft.ifft(ht.fft.fft(x, axis=1), axis=1)
    trip = float((back.larray.real - x.larray).abs().max())
    check(trip <= 1e-5, f"ifft(fft(x)) is {trip} off x")
    res["fft_round_trip_err"] = trip
    del x, xc, back
    torch.cuda.empty_cache()

    # the scalers: fit + transform of the north-star data, 10M x 64 f32 split 0
    n, check_rows = DOMAIN["scaler_rows"], DOMAIN["check_rows"]
    xs, _, _ = blobs(n, D, 8, SEED, dev)
    X, Xc = ht.array(xs, split=0), ht.array(xs[:check_rows].cpu(), split=0, device="cpu")
    Xs = ht.array(xs[:check_rows], split=0)
    B = 4 * n * D
    for name in ("StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"):
        make = getattr(ht.preprocessing, name)
        close(make().fit_transform(Xs), make().fit_transform(Xc), f"{name} at {check_rows} rows", 1e-5)
        out = step(name, lambda: make().fit_transform(X), 3 * B, shape=[n, D], equal_to_cpu_at=check_rows)
        check(out.gshape == (n, D) and bool(torch.isfinite(out.larray).all()), f"{name}: result not finite")
        del out
        torch.cuda.empty_cache()
    del X, Xc, Xs

    # GaussianNB: fit + predict of the north-star blobs and their 8 labels (float64 inside)
    y = blob_labels(n, 8, SEED, dev)
    X, Y = ht.array(xs, split=0), ht.array(y, split=0)
    small = (ht.array(xs[:check_rows], split=0), ht.array(y[:check_rows], split=0))
    a = ht.naive_bayes.GaussianNB().fit(*small)
    b = ht.naive_bayes.GaussianNB().fit(*(on_cpu(t) for t in small))
    for attr in ("theta_", "var_", "class_prior_"):
        close(getattr(a, attr), getattr(b, attr), f"GaussianNB {attr} at {check_rows} rows", 1e-10)
    close(a.predict(small[0]), b.predict(on_cpu(small[0])), f"GaussianNB predict at {check_rows} rows", 0)
    fit_predict = lambda: ht.naive_bayes.GaussianNB().fit(X, Y).predict(X)  # noqa: E731
    labels = step("GaussianNB", fit_predict, 2 * B + 8 * n + 8 * n, reps=2, shape=[n, D], classes=8,
                  equal_to_cpu_at=check_rows)
    accuracy = float((labels.larray == y).double().mean())
    check(accuracy > 0.9, f"GaussianNB: {accuracy} of the blobs' labels recovered")
    res["gaussian_nb_accuracy"] = accuracy
    del X, Y, labels, xs, y, small, a, b
    torch.cuda.empty_cache()

    # Lasso: the sugar table (with an intercept column) against the CPU path within 1e-10,
    # then 1,000,000 x 64 f64 with 8 non-zero true coefficients, lam 0.1, max_iter 100
    import heat_tpu_torch.datasets as datasets

    try:
        import h5py

        with h5py.File(datasets.path("sugar.h5"), "r") as fh:
            sx, sy = fh["x"][...], fh["y"][...]
        source = "sugar.h5"
    except ImportError:
        t = datasets.tables()  # the file's tables from their seed (tests/test_torch_datasets.py)
        sx, sy = t["sugar_x"], t["sugar_y"]
        source = "datasets.tables() (no h5py)"
    sx = np.hstack([np.ones((sx.shape[0], 1), np.float32), sx])
    fits = []
    for device in (None, "cpu"):  # the card (the default device), then the CPU path
        est = ht.regression.Lasso(lam=0.1)
        est.fit(ht.array(sx, split=0, device=device), ht.array(sy, split=0, device=device))
        fits.append(est)
    check(fits[0].n_iter == fits[1].n_iter, f"Lasso on sugar: {fits[0].n_iter} sweeps on the card, {fits[1].n_iter} on the CPU")
    sugar_err = close(fits[0].theta, fits[1].theta, "Lasso theta on sugar", 1e-10)
    m, d, nz = DOMAIN["lasso_rows"], DOMAIN["lasso_cols"], DOMAIN["lasso_nonzero"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 8100)
    lx = torch.randn(m, d, generator=gen, device=dev, dtype=torch.float64)
    lx[:, 0] = 1.0
    truth = torch.zeros(d, dtype=torch.float64, device=dev)
    truth[: nz] = torch.linspace(3.0, -2.0, nz, dtype=torch.float64, device=dev)
    ly = lx @ truth + 0.1 * torch.randn(m, generator=gen, device=dev, dtype=torch.float64)
    c_rows = DOMAIN["lasso_check_rows"]
    small = [ht.regression.Lasso(lam=0.1), ht.regression.Lasso(lam=0.1)]
    small[0].fit(ht.array(lx[:c_rows], split=0), ht.array(ly[:c_rows], split=0))
    small[1].fit(ht.array(lx[:c_rows].cpu(), split=0, device="cpu"), ht.array(ly[:c_rows].cpu(), split=0, device="cpu"))
    check(small[0].n_iter == small[1].n_iter, f"Lasso at {c_rows} rows: sweeps {small[0].n_iter} and {small[1].n_iter}")
    close(small[0].theta, small[1].theta, f"Lasso theta at {c_rows} rows", 1e-10)
    LX, LY = ht.array(lx, split=0), ht.array(ly, split=0)
    est = ht.regression.Lasso(lam=0.1, max_iter=100, tol=1e-6)
    est.fit(LX, LY)
    sweeps = est.n_iter
    theta = est.theta.larray.reshape(-1)
    support = int((theta[1:].abs() > 1e-3).sum())
    check(support == nz - 1 and float((theta[:nz] - truth[:nz]).abs().max()) < 0.2,
          f"Lasso at {m} rows: support {support}, theta {theta[:nz].tolist()}")
    step("Lasso", lambda: ht.regression.Lasso(lam=0.1, max_iter=100, tol=1e-6).fit(LX, LY),
         sweeps * d * (8 * m * d + 3 * 8 * m), reps=2, shape=[m, d], sweeps=sweeps, sugar_source=source,
         sugar_sweeps=fits[0].n_iter, sugar_theta_err_over_scale=sugar_err, equal_to_cpu_at=c_rows)
    del lx, ly, LX, LY, est, fits, small
    torch.cuda.empty_cache()

    # KNN: 40,000 training rows x 18 features, 2 classes, 40,000 queries, k = 5
    nt, nq, f, k = DOMAIN["knn_train"], DOMAIN["knn_test"], DOMAIN["knn_features"], DOMAIN["knn_k"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 8200)
    centers = torch.randn(2, f, generator=gen, device=dev)
    ty = torch.randint(0, 2, (nt,), generator=gen, device=dev)
    tx = centers[ty] + 1.5 * torch.randn(nt, f, generator=gen, device=dev)
    qy = torch.randint(0, 2, (nq,), generator=gen, device=dev)
    qx = centers[qy] + 1.5 * torch.randn(nq, f, generator=gen, device=dev)
    knn = ht.classification.KNeighborsClassifier(k).fit(ht.array(tx, split=0), ht.array(ty, split=0))
    knn_cpu = ht.classification.KNeighborsClassifier(k).fit(ht.array(tx.cpu(), split=0, device="cpu"),
                                                            ht.array(ty.cpu(), split=0, device="cpu"))
    q_check = DOMAIN["knn_check"]
    close(knn.predict(ht.array(qx[:q_check], split=0)), knn_cpu.predict(ht.array(qx[:q_check].cpu(), split=0, device="cpu")),
          f"KNN predict of {q_check} queries", 0)
    Q = ht.array(qx, split=0)
    pred = step("KNN", lambda: knn.predict(Q), 2 * 4 * nq * nt, flops=2.0 * nq * nt * f, train=nt, queries=nq,
                features=f, k=k, equal_to_cpu_at=q_check, bytes_of="the distance matrix written and read by topk")
    res["knn_accuracy"] = float((pred.larray == qy).double().mean())
    del knn, knn_cpu, Q, pred, tx, ty, qx, qy
    torch.cuda.empty_cache()

    # sparse: add and mul of two 1,000,000² CSR f32 matrices of 10M random entries each,
    # row-split; todense of a 20,000² one
    def random_csr(n_, nnz, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        r = torch.randint(0, n_, (nnz,), generator=gen, device=dev)
        c = torch.randint(0, n_, (nnz,), generator=gen, device=dev)
        v = torch.randn(nnz, generator=gen, device=dev)
        return ht.sparse.sparse_csr_matrix(torch.sparse_coo_tensor(torch.stack([r, c]), v, (n_, n_)), split=0)

    sn, snz = DOMAIN["sparse_n"], DOMAIN["sparse_nnz"]
    A, Bm = random_csr(sn, snz, SEED + 8300), random_csr(sn, snz, SEED + 8301)
    Ac, Bc = (ht.sparse.sparse_csr_matrix(m_.larray.cpu(), split=0, device="cpu") for m_ in (A, Bm))
    csr_bytes = lambda m_: 8 * (m_.shape[0] + 1) + 12 * m_.nnz  # noqa: E731
    for name, op in (("sparse_add", ht.sparse.add), ("sparse_mul", ht.sparse.mul)):
        got, want = op(A, Bm), op(Ac, Bc)
        check(got.nnz == want.nnz and got.larray.values().is_cuda, f"{name}: {got.nnz} stored on the card, {want.nnz} on the CPU")
        for part in ("crow_indices", "col_indices", "values"):
            check(torch.equal(getattr(got.larray, part)().cpu(), getattr(want.larray, part)()), f"{name}: {part} differ")
        step(name, lambda: op(A, Bm), csr_bytes(A) + csr_bytes(Bm) + csr_bytes(got), n=sn, nnz=[A.nnz, Bm.nnz],
             result_nnz=got.nnz, equal_to_cpu=True)
        del got, want
    del A, Bm, Ac, Bc
    dn = DOMAIN["dense_n"]
    S = random_csr(dn, DOMAIN["dense_nnz"], SEED + 8302)
    close(S.todense(), ht.sparse.sparse_csr_matrix(S.larray.cpu(), split=0, device="cpu").todense(), "todense", 0)
    step("sparse_todense", lambda: S.todense(), csr_bytes(S) + 4 * dn * dn, n=dn, nnz=S.nnz, equal_to_cpu=True)
    del S
    torch.cuda.empty_cache()

    # integer division and remainders by zero on the card: XLA's values, as on the CPU path
    xs_ = np.array([3, -4, 5, 0, 7, -9, 2, -128])
    ys_ = np.array([0, 0, 0, 0, 2, -3, 0, 5])
    div_checked = 0
    for dtype in ("int8", "uint8", "int32", "int64", "bool"):
        xa, ya = xs_.astype(dtype) if dtype != "uint8" else np.abs(xs_).astype(dtype), ys_.astype(dtype) \
            if dtype != "uint8" else np.abs(ys_).astype(dtype)
        for fn in ("floor_divide", "mod", "fmod", "remainder"):
            for yv in (ya, 0):
                got = getattr(ht, fn)(ht.array(xa), yv if np.isscalar(yv) else ht.array(ya))
                want = getattr(ht, fn)(ht.array(xa, device="cpu"), yv if np.isscalar(yv) else ht.array(ya, device="cpu"))
                close(got, want, f"{fn} of {dtype} by zero", 0)
                div_checked += 1
    phase("domain_int_division_by_zero", calls_equal_to_cpu=div_checked)
    res["int_division_by_zero_calls"] = div_checked
    res["phase_s"] = time.perf_counter() - t_phase
    phase("domain", phase_s=repr(res["phase_s"]), steps=len(res["steps"]), nvidia_smi=json.dumps(smi))
    return res


# the long-context paths (bench.py:216-233: causal self-attention at (8, 16, 4096, 64) bf16;
# "on a mesh the identical math runs as ring attention") at P = 4 virtual ranks, and
# Transformer-base heads (h 8, d 64) at 32,768 tokens over P = 8
RING_CASES = {
    # name: (B, H, T, D, dtype, causal, P, schedule)
    "bench_causal_f32": (BENCH_B, BENCH_H, BENCH_T, BENCH_D, "float32", True, 4, "ring"),
    "bench_full_f32": (BENCH_B, BENCH_H, BENCH_T, BENCH_D, "float32", False, 4, "ring"),
    "bench_zigzag_f32": (BENCH_B, BENCH_H, BENCH_T, BENCH_D, "float32", True, 4, "zigzag"),
    "bench_causal_bf16": (BENCH_B, BENCH_H, BENCH_T, BENCH_D, "bfloat16", True, 4, "ring"),
    "bench_full_bf16": (BENCH_B, BENCH_H, BENCH_T, BENCH_D, "bfloat16", False, 4, "ring"),
    "bench_zigzag_bf16": (BENCH_B, BENCH_H, BENCH_T, BENCH_D, "bfloat16", True, 4, "zigzag"),
    "long_causal_f32": (1, 8, 32768, 64, "float32", True, 8, "ring"),
    "long_zigzag_f32": (1, 8, 32768, 64, "float32", True, 8, "zigzag"),
}


def ring_blocks(p: int, causal: bool, schedule: str) -> int:
    """K2 launches of one ring forward over p ranks: P(P+1)/2 causal, P² full, P(2P+1) zigzag."""
    if schedule == "zigzag":
        return p * (2 * p + 1)
    return p * (p + 1) // 2 if causal else p * p


class VirtualRing:
    """P ranks of a ring on one card: the rank-local bodies of heat_tpu_torch's ring
    attention (``_ring_forward``, ``_ring_backward``) fed each rank's chunks in its ring
    order (src = rank − i at step i), as ``TorchCommunication.ring_blocks`` delivers them.
    Zigzag inputs are permuted by ``zigzag_order`` first and the results back."""

    def __init__(self, att, q, k, v, p: int, causal: bool, schedule: str):
        import torch

        self.att, self.p, self.causal, self.schedule = att, p, causal, schedule
        t = q.shape[1]
        self.order = None
        if schedule == "zigzag":
            self.order = torch.as_tensor(att.zigzag_order(t, p).astype(np.int64), device=q.device)
            self.inverse = torch.as_tensor(att.zigzag_inverse(t, p).astype(np.int64), device=q.device)
            q, k, v = (x[:, self.order] for x in (q, k, v))
        c = t // p
        self.c = c
        self.q, self.k, self.v = ([x[:, r * c:(r + 1) * c].contiguous() for r in range(p)] for x in (q, k, v))
        self.scale = 1.0 / math.sqrt(q.shape[-1])

    def blocks(self, my: int):
        if self.schedule == "zigzag":
            return self.att._zigzag_schedule(my, self.c // 2)
        return self.att._ring_schedule(my, self.causal)

    def srcs(self, my: int):
        return [(my - i) % self.p for i in range(self.p)]

    def run(self) -> list:
        """Every rank's ring forward, (O f32, LSE) of its chunk: what is timed."""
        return [self.att._ring_forward(self.q[my], [(self.k[s], self.v[s], s) for s in self.srcs(my)],
                                       self.blocks(my), self.scale) for my in range(self.p)]

    def whole(self, parts):
        """Per-rank chunks along the sequence joined into the whole, in its own order."""
        import torch

        x = torch.cat(parts, 1)
        return x[:, self.inverse] if self.order is not None else x

    def chunks(self, x) -> list:
        """The whole sequence's ``x`` cut into the ranks' chunks (in the ring's layout)."""
        if self.order is not None:
            x = x[:, self.order]
        return [x[:, r * self.c:(r + 1) * self.c].contiguous() for r in range(self.p)]

    def forward(self):
        """(O f32, LSE) of the whole sequence, in its own order."""
        outs = self.run()
        return self.whole([o for o, _ in outs]), self.whole([lse for _, lse in outs])

    def run_backward(self, o, do, lse):
        """Every rank's ring backward from per-rank chunks of O, dO and LSE: dQ chunks and
        the dK/dV accumulators each chunk collected, (2, bh, c, D) f32 a rank."""
        import torch

        accs = [torch.zeros((2,) + self.k[0].shape, dtype=torch.float32, device=o[0].device) for _ in range(self.p)]
        dq = [self.att._ring_backward(self.q[my], o[my], do[my], lse[my],
                                      [(self.k[s], self.v[s], s, accs[s]) for s in self.srcs(my)], self.blocks(my),
                                      self.scale) for my in range(self.p)]
        return dq, accs

    def backward(self, o, do, lse):
        """(dQ, dK, dV) f32 of the whole sequence from the whole O (in q's dtype), dO, LSE."""
        dq, accs = self.run_backward(self.chunks(o), self.chunks(do), self.chunks(lse))
        return self.whole(dq), self.whole([a[0] for a in accs]), self.whole([a[1] for a in accs])


def bwd_f64(q, k, v, do, causal: bool, keys: int = 512, rows: int = 2048) -> tuple:
    """dK and dV in float64 of the first batch·head's first ``keys`` keys, every query
    attending (their sums are the longest), for q, k, v, dO (bh, T, D): each query's LSE,
    O and D = rowsum(dO∘O) from its whole row in float64, ``rows`` queries at a time."""
    import torch

    q0, k0, v0, g0 = (x[0].double() for x in (q, k, v, do))
    t, s = q0.shape[0], 1.0 / math.sqrt(q0.shape[1])
    dk = torch.zeros(keys, q0.shape[1], dtype=torch.float64, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, t, rows):
        sc = (q0[r0:r0 + rows] @ k0.T) * s
        if causal:
            sc = sc.masked_fill(torch.arange(r0, r0 + sc.shape[0], device=q.device)[:, None]
                                < torch.arange(t, device=q.device)[None, :], -math.inf)
        p = torch.softmax(sc, dim=-1)
        dd = ((p @ v0) * g0[r0:r0 + rows]).sum(-1, keepdim=True)
        pk = p[:, :keys]
        dv += pk.T @ g0[r0:r0 + rows]
        dk += ((pk * (g0[r0:r0 + rows] @ v0[:keys].T - dd)).T @ q0[r0:r0 + rows]) * s
    return dk, dv


def rel_err(got, want) -> float:
    """max |got − want| over the largest |want|."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-30)


def nn_phases(ht, kernels, smi: str, dev) -> dict:
    """The slice of heat_tpu.nn beyond the Transformer: ring, zigzag and Ulysses attention,
    keyed dropout, the module zoo and the recurrent layers, on the card.

    ``[ring_attention]``: each RING_CASES shape through P virtual ranks of the ring's
    rank-local body (:class:`VirtualRing`), its K2 launches counted exactly (P(P+1)/2
    causal, P² full, P(2P+1) zigzag), the merged O and LSE held to one K2 call on the
    whole sequence (O in f32 from both) within 2e-4 of the largest magnitude, and the O
    cast to the input type within one rounding of it (2⁻⁸ relative in bf16); best of 3 ms
    beside the whole-sequence K2's ms and their 3xTF32 (bf16: tensor-core) bound, one run
    traced for the merge's share of the device time. One case again under
    ``HEAT_TPU_FLASH_PIPELINE=1`` (K3). ``[ring_attention_bwd]``: every case's backward,
    D = P launches and K4 = K5 = the forward's blocks, dQ, dK and dV (f32 from the ring's
    blocks and from the whole call alike) within 2e-4 of each gradient's largest entry of
    D/K4/K5 on the whole sequence, from the same O and LSE; best of 3 ms beside the whole
    backward's. ``[ulysses]``: Ulysses at world 1 (the all-to-all the identity) equal
    to sdpa, and one MultiheadAttention forward and backward on a sequence-split DNDarray
    (world 1: the local path) equal to the CPU path. ``[nn_zoo]``: heat_tpu's MNIST Net
    (forward and one SGD step, Dropout2d keyed, batch 256), an LSTM(512, 512, 2) on (64,
    256, 512) and a TransformerEncoderLayer(512, 8) in training mode with dropout 0.1 and a
    key, each equal to the CPU path within 1e-5 of the largest magnitude with TF32 allowed
    for the process and seen off inside every product, convolution and recurrence."""
    import torch

    from heat_tpu_torch.nn import attention as att

    k2 = kernels.flash_attention
    flash = ("flash_attention_fwd", "flash_attention_bwd_d", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
             "flash_attention_fwd_pipelined")
    out = {"ring": {}, "ring_bwd": {}}
    for i, (cname, (b, h, t, d, dtype_name, causal, p, schedule)) in enumerate(RING_CASES.items()):
        dtype = getattr(torch, dtype_name)
        q, k, v = k2_inputs(b * h, t, t, d, dtype, SEED + 1000 + i, dev)
        ring = VirtualRing(att, q, k, v, p, causal, schedule)
        blocks = ring_blocks(p, causal, schedule)
        sc = 1.0 / math.sqrt(d)
        with torch.no_grad():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            o, lse = ring.forward()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            check(counts["flash_attention_fwd"] == blocks and all(counts[n] == 0 for n in flash[1:]),
                  f"{cname}: ring launches {counts}, expected {blocks} of K2")
            wo, wl = k2.block_fwd(q, k, v, causal, sc)  # one K2 call, O in f32
            err_o, err_lse = rel_err(o, wo), float((lse - wl).abs().max())
            cast_err = rel_err(o.to(dtype), wo.to(dtype))
            cast_tol = 2e-4 + (2.0**-8 if dtype != torch.float32 else 0.0)
            check(err_o <= 2e-4 and err_lse <= 2e-4 * max(1.0, float(wl.abs().max())) and cast_err <= cast_tol,
                  f"{cname}: the ring's O/LSE are {err_o}/{err_lse} (cast {cast_err}) from one K2 call")
            if i == 0 or dtype != torch.float32:
                # the f32-output entry against the plain version on a few heads, and rounded
                # to the input type, bit for bit the default entry's output
                ro, rl = k2.flash_attention_reference(q[:8].float(), k[:8].float(), v[:8].float(), causal, sc)
                check(rel_err(wo[:8], ro) <= 2e-4, f"{cname}: K2's f32 output disagrees with its plain version")
                od, ld = k2._k2(q, k, v, causal, sc, None)
                check(torch.equal(wo.to(dtype), od) and torch.equal(wl, ld), f"{cname}: K2's two entry points differ")
                del od, ld
            ring_ms = min(cuda_ms(ring.run, reps=1, warmup=1 if r == 0 else 0) for r in range(3))
            whole_ms = cuda_ms(lambda: k2.block_fwd(q, k, v, causal, sc), reps=3, warmup=1)
            bound = k2_bound_ms(b * h, t, t, d, causal, q.element_size())
        row = {"launches": counts["flash_attention_fwd"], "expected": blocks, "max_rel_err_o": err_o,
               "max_abs_err_lse": err_lse, "cast_rel_err": cast_err, "ring_ms": ring_ms, "whole_k2_ms": whole_ms,
               "bound_ms": bound[0], "bound_by": bound[1], "p": p}
        if cname in ("bench_causal_f32", "bench_zigzag_f32", "long_causal_f32"):
            prof = profile_device(ring.run)
            if "device_ms_by_kind" in prof:
                kinds = prof["device_ms_by_kind"]
                k2_dev = kinds.get("k2_flash_attention", 0.0)
                row["device_ms_by_kind"] = kinds
                row["merge_share"] = 1.0 - k2_dev / prof["device_busy_ms"]
                row["copy_ms"] = kinds.get("copy_transpose", 0.0)
                row["device_idle_share"] = prof["device_idle_share"]
            else:
                row["device_trace"] = prof["device_trace"]
        if cname == "bench_causal_f32":
            with pipelined(True), torch.no_grad():
                kernels.reset_launch_counts()
                o3, l3 = ring.forward()
                torch.cuda.synchronize()
                c3 = kernels.launch_counts()
            check(c3["flash_attention_fwd_pipelined"] == blocks and c3["flash_attention_fwd"] == 0,
                  f"{cname} under the knob: launches {c3}")
            row["k3_launches"] = c3["flash_attention_fwd_pipelined"]
            row["k3_max_rel_err_o"] = rel_err(o3, wo)
            check(row["k3_max_rel_err_o"] <= 2e-4, f"{cname}: the K3 ring is {row['k3_max_rel_err_o']} from K2")
            del o3, l3
        out["ring"][cname] = row
        phase("ring_attention", case=cname, shape=f"{b}x{h}x{t}x{d}", dtype=dtype_name, causal=causal,
              schedule=schedule, card=json.dumps(smi), **{k_: json.dumps(v_) if isinstance(v_, dict) else v_
                                                          for k_, v_ in row.items()})
        # the ring's backward and D/K4/K5 on the whole sequence from the same O and LSE
        # (the whole-sequence K2's), so the two differ only in how they sum; both write
        # f32 (bf16 too: the ring's blocks and the whole call round once, at the end)
        torch.manual_seed(SEED + 1100 + i)
        do = torch.randn(q.shape, device=dev).to(dtype)
        o_q = wo.to(dtype)
        with torch.no_grad():
            kernels.reset_launch_counts()
            grads = ring.backward(o_q, do, wl)
            torch.cuda.synchronize()
            bc = kernels.launch_counts()
            check(bc["flash_attention_bwd_d"] == p and bc["flash_attention_bwd_dq"] == blocks
                  and bc["flash_attention_bwd_dkv"] == blocks and bc["flash_attention_fwd"] == 0,
                  f"{cname}: ring backward launches {bc}")
            dd = k2._d_pass(o_q, do)
            want = (k2._k4(q, k, v, do, wl, dd, causal, sc, None, out_f32=True),
                    *k2._k5(q, k, v, do, wl, dd, causal, sc, None, out_f32=True))
            legacy = k2.flash_attention_bwd(q, k, v, o_q, do, wl, causal, sc)
            check(all(torch.equal(w.to(dtype), g) for w, g in zip(want, legacy)),
                  f"{cname}: the f32-output K4/K5 rounded differ from the default entry's")
            del legacy
            errs = [rel_err(g, w) for g, w in zip(grads, want)]
            # at 32,768 tokens both sum each key's dK and dV over up to 32,768 queries, in
            # other orders: both are held to float64 on the keys with the longest sums, and
            # the ring to the whole within 2e-4 plus the whole's own distance from float64
            f64 = {}
            if t >= 32768:
                ref = bwd_f64(q, k, v, do, causal)
                for n_, g_, w_, r_ in (("dk", grads[1], want[1], ref[0]), ("dv", grads[2], want[2], ref[1])):
                    f64[n_] = {"ring": rel_err(g_[0, :512].double(), r_), "whole": rel_err(w_[0, :512].double(), r_)}
                check(all(e["ring"] <= 2e-4 for e in f64.values()),
                      f"{cname}: ring dK/dV against float64 {f64}")
            slack = max((e["whole"] for e in f64.values()), default=0.0)
            check(max(errs) <= 2e-4 + slack,
                  f"{cname}: ring gradients (dQ, dK, dV) are {errs} from D/K4/K5 whole (float64: {f64})")
            # from the ring's own forward (its O and LSE): what a training step sees
            own = [rel_err(g, w) for g, w in zip(ring.backward(o.to(dtype), do, lse), want)]
            parts = ring.chunks(o_q), ring.chunks(do), ring.chunks(wl)
            bwd_ms = min(cuda_ms(lambda: ring.run_backward(*parts), reps=1, warmup=1 if r == 0 else 0)
                         for r in range(3))
            whole_bwd_ms = cuda_ms(lambda: k2.flash_attention_bwd(q, k, v, o_q, do, wl, causal, sc), reps=3,
                                   warmup=1)
        brow = {"launches": {n: bc[n] for n in flash[1:4]}, "max_rel_err": dict(zip(("dq", "dk", "dv"), errs)),
                "max_rel_err_from_own_forward": dict(zip(("dq", "dk", "dv"), own)),
                "rel_err_against_float64_head0_keys512": f64,
                "ring_bwd_ms": bwd_ms, "whole_bwd_ms": whole_bwd_ms,
                "bound_ms": bwd_bounds_ms(b * h, t, t, d, causal, q.element_size())}
        out["ring_bwd"][cname] = brow
        phase("ring_attention_bwd", case=cname, shape=f"{b}x{h}x{t}x{d}", dtype=dtype_name, ranks=p, schedule=schedule,
              card=json.dumps(smi), **{k_: json.dumps(v_) if isinstance(v_, dict) else v_ for k_, v_ in brow.items()})
        del do, o_q, grads, want, parts, dd
        del q, k, v, ring, o, lse, wo, wl
        torch.cuda.empty_cache()

    # Ulysses at world 1, and MultiheadAttention on a sequence-split DNDarray at world 1
    gen = torch.Generator(device=dev).manual_seed(SEED + 1200)
    qu, ku, vu = (torch.randn(2, 8, 2048, 64, generator=gen, device=dev) for _ in range(3))
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = ht.nn.ulysses_attention(qu, ku, vu, is_causal=True)
        torch.cuda.synchronize()
        uc = kernels.launch_counts()
        want = ht.nn.scaled_dot_product_attention(qu, ku, vu, is_causal=True)
    check(uc["flash_attention_fwd"] == 1, f"Ulysses launches {uc}")
    check(torch.equal(got, want), "Ulysses at world 1 differs from sdpa")
    torch.manual_seed(SEED + 1201)
    mha = ht.nn.MultiheadAttention(512, 8)
    mha_cpu = ht.nn.MultiheadAttention(512, 8, device="cpu")
    mha_cpu.load_state_dict({n_: t_.cpu() for n_, t_ in mha.state_dict().items()})
    x = torch.randn(2, 1024, 512, generator=gen, device=dev)
    kernels.reset_launch_counts()
    y = mha(ht.array(x, split=1), is_causal=True)[0]
    (y.larray ** 2).sum().backward()
    torch.cuda.synchronize()
    mc = kernels.launch_counts()
    y_cpu = mha_cpu(ht.array(x.cpu(), split=1, device="cpu"), is_causal=True)[0]
    (y_cpu.larray ** 2).sum().backward()
    check(y.split == 1 and all(mc[n] == 1 for n in flash[:4]), f"sequence-split MHA at world 1: split {y.split}, {mc}")
    mha_err = rel_err(y.larray.cpu(), y_cpu.larray)
    grad_err = max(rel_err(a.grad.cpu(), b_.grad) for a, b_ in zip(mha.parameters(), mha_cpu.parameters()))
    check(mha_err <= 1e-5 and grad_err <= 1e-4, f"sequence-split MHA: card vs CPU {mha_err}, gradients {grad_err}")
    out["ulysses"] = {"launches": uc["flash_attention_fwd"], "mha_launches": {n: mc[n] for n in flash[:4]},
                      "mha_rel_err": mha_err, "mha_grad_rel_err": grad_err}
    phase("ulysses", shape="2x8x2048x64", card=json.dumps(smi), **{k_: json.dumps(v_) for k_, v_ in out["ulysses"].items()})
    del qu, ku, vu, got, want, mha, mha_cpu, x, y, y_cpu
    torch.cuda.empty_cache()

    out["zoo"] = zoo_phase(ht, smi, dev)
    return out


def zoo_phase(ht, smi: str, dev) -> dict:
    """``[nn_zoo]``: the MNIST Net, an LSTM and a TransformerEncoderLayer, card against CPU."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "examples", "nn"))
    import mnist_torch

    seen = []
    patched = {}

    def spy(owner, name):
        fn = getattr(owner, name)
        patched[(owner, name)] = fn

        def wrapped(*args, **kwargs):
            seen.append((name, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return fn(*args, **kwargs)

        setattr(owner, name, wrapped)

    prior = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    for owner, name in ((torch, "matmul"), (torch.nn.functional, "linear"), (torch.nn.functional, "conv2d"),
                        (torch.nn.LSTM, "forward")):
        spy(owner, name)
    key = (0, 42)
    rows = {}
    try:
        def pair(build):
            torch.manual_seed(SEED + 1300)
            a = build(dev)
            b_ = build("cpu")
            b_.load_state_dict({n_: t_.cpu() for n_, t_ in a.state_dict().items()})
            return a, b_

        # heat_tpu's MNIST Net: forward in training mode (Dropout2d keyed) and one SGD step
        net, net_cpu = pair(lambda d_: mnist_torch.Net(device=d_).train())
        xs, ys = mnist_torch.synthetic(256)
        x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)

        def loss_fn(m, xb, yb):
            return ht.nn.functional.nll_loss(m(xb, key=key), yb)

        # the step holds TF32 off through the backward (DataParallelOptimizer.step)
        opts = [ht.optim.DataParallelOptimizer("sgd", lr=0.05) for _ in range(2)]
        ht.nn.DataParallel(net, optimizer=opts[0])
        ht.nn.DataParallel(net_cpu, optimizer=opts[1])
        with torch.no_grad():
            lg, lc = net(x, key=key), net_cpu(x.cpu(), key=key)
        lo = opts[0].step(loss_fn, ht.array(x, split=0), ht.array(y, split=0))
        lo_c = opts[1].step(loss_fn, ht.array(x.cpu(), split=0, device="cpu"), ht.array(y.cpu(), split=0, device="cpu"))
        errs = [rel_err(lg.cpu(), lc)] + [rel_err(a.cpu(), b_) for a, b_ in zip(net.parameters(), net_cpu.parameters())]
        check(max(errs) <= 1e-5 and abs(float(lo) - float(lo_c)) <= 1e-5 * abs(float(lo_c)),
              f"MNIST Net: card vs CPU {max(errs)}, losses {float(lo)} {float(lo_c)}")
        batch = ht.array(x, split=0), ht.array(y, split=0)
        rows["mnist_net"] = {"batch": 256, "max_rel_err": max(errs), "loss": float(lo),
                             "step_best_of_3_ms": 1e3 * best_s(lambda: opts[0].step(loss_fn, *batch), 3)[0]}
        del net, net_cpu, x, y, opts, batch

        lstm, lstm_cpu = pair(lambda d_: ht.nn.LSTM(512, 512, num_layers=2, device=d_))
        xl = torch.randn(64, 256, 512, generator=torch.Generator(device=dev).manual_seed(SEED + 1301), device=dev)
        with torch.no_grad():
            (ol, (hl, cl)), (oc, (hc, cc)) = lstm(xl), lstm_cpu(xl.cpu())
            err = max(rel_err(ol.cpu(), oc), rel_err(hl.cpu(), hc), rel_err(cl.cpu(), cc))
            check(err <= 1e-5, f"LSTM: card vs CPU {err}")
            rows["lstm"] = {"shape": "64x256x512", "max_rel_err": err,
                            "best_of_3_ms": 1e3 * best_s(lambda: lstm(xl), 3)[0]}
        del lstm, lstm_cpu, xl

        enc, enc_cpu = pair(lambda d_: ht.nn.TransformerEncoderLayer(512, 8, dropout=0.1, device=d_).train())
        xe = torch.randn(4, 512, 512, generator=torch.Generator(device=dev).manual_seed(SEED + 1302), device=dev)
        with torch.no_grad():
            oe, ocpu = enc(xe, key=key), enc_cpu(xe.cpu(), key=key)
            err = rel_err(oe.cpu(), ocpu)
            check(err <= 1e-5, f"TransformerEncoderLayer in training mode: card vs CPU {err}")
            rows["encoder_layer_train"] = {"shape": "4x512x512", "dropout": 0.1, "max_rel_err": err,
                                           "best_of_3_ms": 1e3 * best_s(lambda: enc(xe, key=key), 3)[0]}
        del enc, enc_cpu, xe
    finally:
        for (owner, name), fn in patched.items():
            setattr(owner, name, fn)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prior
    check(bool(seen) and not any(a or b_ for _, a, b_ in seen), f"TF32 inside the zoo: {sorted(set(seen))}")
    rows["tf32_seen"] = sorted({f"{n}:{a}:{b_}" for n, a, b_ in seen})
    phase("nn_zoo", card=json.dumps(smi), **{k_: json.dumps(v_) for k_, v_ in rows.items()})
    torch.cuda.empty_cache()
    return rows

def state_tree(ht, model, opt, sched, daso) -> dict:
    """The training state a resume needs: parameters and buffers, Adam's moments and step
    counts, the scheduler's counters, DASO's counters and ht.random's state."""
    return {
        "model": model.state_dict(),
        "adam": opt.local_optimizer.state_dict(),
        "sched": {"last_epoch": sched.last_epoch, "base_lr": sched.base_lr},
        "daso": {"epoch": daso.epoch, "batch": daso._batch_in_epoch, "global_skip": daso.global_skip},
        "random": list(ht.random.get_state()),
    }


def train_resume_phase(ht, kernels, s2s, dev, smi: str, step_s_plain: float) -> dict:
    """``[train_resume]``: the training step's configuration under DASO at world 1, four
    steps in a row (A) against two steps, a checkpoint, a fresh model restored from it and
    two more steps (B): B's losses and parameters equal A's bit for bit, K2, D, K4 and K5
    18 times a step; a copy with one flipped byte and one without its manifest raise
    CheckpointCorrupt; an armed ``checkpoint.chunk_write`` fault degrades the save to v1
    and the report records it; the save, verify and restore rates and the DASO step's
    time."""
    import shutil
    import tempfile

    import torch

    from heat_tpu_torch.core import checkpoint as ckpt, diagnostics, resilience

    t_phase = time.perf_counter()
    steps_s = {}

    def lap(name: str) -> None:
        torch.cuda.synchronize()
        steps_s[name] = time.perf_counter() - t_phase - sum(steps_s.values())

    cfg = dict(vocab=VOCAB, max_len=TRAIN_T, d_model=512, nhead=8, layers=6, dim_feedforward=2048)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    batches = [[ht.array(t, split=0) for t in s2s.reverse_batch(TRAIN_B, TRAIN_T, VOCAB, generator=gen, device=dev)]
               for _ in range(4)]
    flash = ("flash_attention_fwd", "flash_attention_bwd_d", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

    def fresh():
        torch.manual_seed(SEED + 12)
        model = s2s.Seq2Seq(**cfg).train()
        comm = ht.TorchCommunication.hierarchical(1)
        opt = ht.optim.DataParallelOptimizer("adam", lr=1.0)
        ht.nn.DataParallelMultiGPU(model, optimizer=opt, comm=comm)
        daso = ht.optim.DASO(opt, total_epochs=4, warmup_epochs=1, cooldown_epochs=1, comm=comm)
        sched = ht.optim.lr_scheduler.LambdaLR(opt, lambda e: 512**-0.5 * min((e + 1) ** -0.5, (e + 1) * WARMUP**-1.5))
        return model, opt, daso, sched

    def steps(model, daso, sched, which, counts=None) -> list:
        losses = []
        for i in which:
            kernels.reset_launch_counts()
            loss = daso.step(s2s.seq2seq_loss, *batches[i])
            sched.step()
            torch.cuda.synchronize()
            if counts is not None:
                counts.append(kernels.launch_counts())
            losses.append(float(loss))
            if i == 1:
                daso.epoch_end()
        return losses

    # run A: four steps in a row
    model, opt, daso, sched = fresh()
    a_counts = []
    a_losses = steps(model, daso, sched, range(4), a_counts)
    check(all(c[n] == FLASH_PER_FORWARD for c in a_counts for n in flash), f"launches a DASO step: {a_counts}")
    a_params = {n: t.detach().clone() for n, t in model.state_dict().items()}
    del model, opt, daso, sched
    torch.cuda.empty_cache()
    lap("run_a")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # run B: two steps, a checkpoint, a fresh model restored, two more steps
        model, opt, daso, sched = fresh()
        b_counts = []
        b_losses = steps(model, daso, sched, range(2), b_counts)
        lap("run_b_steps_1_2")
        mgr = ht.CheckpointManager(os.path.join(tmp, "run"), max_to_keep=2)
        tree = state_tree(ht, model, opt, sched, daso)
        leaves, _ = ckpt._flatten(tree)
        state_bytes = sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, tree)
        save_s = time.perf_counter() - t0
        step_dir = os.path.join(tmp, "run", "step_2")
        lap("save")
        t0 = time.perf_counter()
        problems = ckpt.verify_checkpoint(step_dir)
        verify_s = time.perf_counter() - t0
        check(problems == [], f"the saved checkpoint does not verify: {problems}")
        manifest = ckpt.read_manifest(step_dir)
        check(manifest["schema"] == ckpt.SCHEMA, f"the save wrote {manifest['schema']}")
        del model, opt, daso, sched, tree
        torch.cuda.empty_cache()
        lap("verify")
        model, opt, daso, sched = fresh()
        # the template: the fresh objects' state, Adam's moments made to the saved shapes
        params = [p for g in opt.local_optimizer.param_groups for p in g["params"]]
        template = state_tree(ht, model, opt, sched, daso)
        template["adam"]["state"] = {i: {"step": torch.zeros(()), "exp_avg": torch.zeros_like(p),
                                         "exp_avg_sq": torch.zeros_like(p)} for i, p in enumerate(params)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        read_bytes = ckpt.last_restore_stats()["read_bytes"]
        check(all(t.device.type == dev.type for t in restored["model"].values()), "restored parameters are not on the card")
        model.load_state_dict(restored["model"])
        opt.local_optimizer.load_state_dict(restored["adam"])
        sched.last_epoch, sched.base_lr = restored["sched"]["last_epoch"], restored["sched"]["base_lr"]
        opt.lr = sched.get_lr()
        daso.epoch, daso._batch_in_epoch = restored["daso"]["epoch"], restored["daso"]["batch"]
        daso.global_skip = restored["daso"]["global_skip"]
        if daso.epoch >= daso.warmup_epochs:
            daso._phase = "cycling"
        ht.random.set_state(tuple(restored["random"]))
        lap("fresh_and_restore")
        b_losses += steps(model, daso, sched, range(2, 4), b_counts)
        check(all(c[n] == FLASH_PER_FORWARD for c in b_counts for n in flash), f"launches a resumed step: {b_counts}")
        check(b_losses == a_losses, f"resumed losses {b_losses} differ from uninterrupted {a_losses}")
        differ = [n for n, t in model.state_dict().items() if not torch.equal(t, a_params[n])]
        check(not differ, f"resumed parameters differ from uninterrupted ones: {differ[:5]}")
        del a_params, restored

        # the DASO step's time: best of 2 after the counted runs
        walls = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            daso.step(s2s.seq2seq_loss, *batches[i])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        lap("run_b_steps_3_4_and_timed")

        # corruption: one flipped byte in a copy of the step, and a copy without its manifest
        # (copies of hard links: the flipped chunk alone is copied whole)
        corrupt = {}
        for case in ("flipped_byte", "missing_manifest"):
            copy = os.path.join(tmp, case)
            shutil.copytree(step_dir, copy, copy_function=os.link)
            if case == "flipped_byte":
                name = max(ckpt._manifest_files(manifest), key=lambda f: f[1])[0]
                victim = os.path.join(copy, name)
                os.unlink(victim)
                shutil.copyfile(os.path.join(step_dir, name), victim)
                with open(victim, "r+b") as fh:
                    fh.seek(17)
                    byte = fh.read(1)
                    fh.seek(17)
                    fh.write(bytes([byte[0] ^ 0x40]))
            else:
                os.unlink(os.path.join(copy, ckpt.MANIFEST_NAME))
            try:
                ht.load_checkpoint(template, copy)
                corrupt[case] = "restored"
            except ht.CheckpointCorrupt as exc:
                corrupt[case] = exc.problems[0][:120]
            shutil.rmtree(copy)
        check(all(v != "restored" for v in corrupt.values()), f"a corrupt checkpoint restored: {corrupt}")
        victim_meta = next(f for f in ckpt._manifest_files(manifest) if f[0] == name)
        check(ckpt._verify_one(step_dir, *victim_meta) is None, "the original step changed with its corrupted copy")
        lap("corruption")

        # the degradation ladder: every chunk write fails, the save of the model's state goes
        # to v1, recorded
        diagnostics.reset()
        diagnostics.enable()
        resilience.set_policy("checkpoint.chunk_write", resilience.Policy(max_attempts=2, backoff_base=0.0))
        resilience.arm_fault_plan([{"site": "checkpoint.chunk_write", "kind": "raise", "on_call": 1, "count": 10**6}])
        tree = {"model": model.state_dict()}
        v1_bytes = sum(t.numel() * t.element_size() for t in tree["model"].values())
        try:
            t0 = time.perf_counter()
            ht.save_checkpoint(tree, os.path.join(tmp, "degraded"))
            v1_s = time.perf_counter() - t0
        finally:
            resilience.disarm_fault_plan()
            resilience.set_policy("checkpoint.chunk_write", None)
            resilience.reset(clear_breakers=True)
        report = diagnostics.report()
        diagnostics.disable()
        v1_schema = ckpt.read_manifest(os.path.join(tmp, "degraded"))["schema"]
        fallbacks = [e for e in report["resilience_events"] if e["kind"] == "fallback"]
        check(v1_schema == ckpt.SCHEMA_V1 and len(fallbacks) == 1
              and report["counters"].get("fallback.checkpoint.save") == 1,
              f"the degraded save: schema {v1_schema}, fallback events {fallbacks}, counters {report['counters']}")
        check(ckpt.verify_checkpoint(os.path.join(tmp, "degraded")) == [], "the v1 checkpoint does not verify")
        del tree
        lap("degraded_v1")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = state_bytes / 1e9
    out = {
        "state_bytes": state_bytes, "leaves": len(leaves), "chunks": len(ckpt._manifest_files(manifest)),
        "save_s": save_s, "save_gb_per_s": gb / save_s, "verify_s": verify_s, "verify_gb_per_s": gb / verify_s,
        "restore_s": restore_s, "restore_gb_per_s": gb / restore_s, "restore_read_bytes": read_bytes,
        "v1_bytes": v1_bytes, "v1_save_s": v1_s, "v1_save_gb_per_s": v1_bytes / 1e9 / v1_s, "losses": a_losses,
        "launches": a_counts[0],
        "daso_step_best_of_2_s": min(walls), "daso_step_walls_s": walls, "train_step_best_of_2_s": step_s_plain,
        "corrupt": corrupt, "fallback_event": fallbacks[0]["detail"][-160:], "steps_s": steps_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    phase("train_resume", card=smi, **{k: json.dumps(v) for k, v in out.items()})
    return out


def daso_sync_phase(ht, s2s, dev, smi: str) -> dict:
    """``[daso_sync]``: DASO's global sync on two and four virtual node replicas of the
    Transformer's parameters on the card, each nudged by a seeded step: the sync's
    rank-local body (``wire_deltas`` a replica, ``synced_params`` on their stack, the
    gather replaced by ``torch.stack``) against the same on the CPU, bit for bit, TF32
    allowed for the process and seen off."""
    import torch

    from heat_tpu_torch.core.devices import full_fp32_matmul
    from heat_tpu_torch.optim.dp_optimizer import synced_params, wire_deltas

    t_phase = time.perf_counter()
    torch.manual_seed(SEED + 14)
    model = s2s.Seq2Seq(vocab=VOCAB, max_len=TRAIN_T, d_model=512, nhead=8, layers=6, dim_feedforward=2048)
    base = [p.detach() for p in model.parameters()]
    numel = sum(p.numel() for p in base)
    out = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for n in (2, 4):
            gen = torch.Generator(device=dev).manual_seed(SEED + 15 + n)
            replicas = [base] + [[p + 1e-3 * torch.randn(p.shape, generator=gen, device=dev) for p in base]
                                 for _ in range(n - 1)]
            with full_fp32_matmul():
                seen = torch.backends.cuda.matmul.allow_tf32

                def body(reps):
                    refs = reps[0]
                    return synced_params(refs, torch.stack([wire_deltas(r, refs, torch.bfloat16) for r in reps]))

                got = body(replicas)
                torch.cuda.synchronize()
                t_cpu = time.perf_counter()
                want = body([[p.cpu() for p in r] for r in replicas])
                cpu_s = time.perf_counter() - t_cpu
                ms = cuda_ms(lambda: body(replicas), reps=5, warmup=1)
            equal = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            check(equal and not seen, f"the DASO sync on {n} virtual replicas: equal {equal}, TF32 seen {seen}")
            moved = float(max((g - b).abs().max() for g, b in zip(got, base)))
            check(0 < moved < 1e-2, f"the synced parameters moved {moved} from the reference replica")
            nbytes = numel * (4 * n + 2 * n + 2 * n + 4 * n)  # replicas in, deltas out and in, n replicas out
            out[n] = {"ms": ms, "bytes_bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "max_move": moved, "cpu_s": cpu_s}
            phase("daso_sync", card=smi, nodes=n, params=numel, bit_equal_to_cpu=equal, tf32_seen=seen, ms=repr(ms),
                  bytes_bound_ms=repr(out[n]["bytes_bound_ms"]), cpu_reference_s=repr(cpu_s),
                  phase_s=repr(time.perf_counter() - t_phase))
            del replicas, got, want
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del model, base
    torch.cuda.empty_cache()
    return out


def io_phase(ht, dev, smi: str) -> dict:
    """``[io]``: a split DNDarray on the card, 1,000,000 x 64 f32, through ``save_npy``/
    ``load_npy`` and ``save``/``load``, and a 40,000 x 18 CSV (SUSY's width) through
    ``save_csv``/``load_csv``: exact round trips landing on the card, MB/s each; HDF5 and
    zarr where ``supports_hdf5()``/``supports_zarr()`` say so."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    big = ht.array(torch.randn(1_000_000, 64, generator=gen, device=dev), split=0)
    susy = ht.array(torch.rand(40_000, 18, generator=gen, device=dev) * 10, split=0)
    formats = {"npy": ("save_npy", "load_npy", ".npy", big), "npy_dispatch": ("save", "load", ".npy", big),
               "csv": ("save_csv", "load_csv", ".csv", susy)}
    if ht.io.supports_hdf5():
        formats["hdf5"] = ("save", "load", ".h5", big)
    if ht.io.supports_zarr():
        formats["zarr"] = ("save", "load", ".zarr", big)
    out = {"formats_run": sorted(formats), "formats_skipped": sorted({"hdf5", "zarr"} - set(formats))}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        for fmt, (save_name, load_name, ext, x) in formats.items():
            path = os.path.join(tmp, "x" + ext)
            extra = ("data",) if ext == ".h5" else ()
            load_kw = {"dtype": ht.float32} if ext in (".h5", ".csv") else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(ht, save_name)(x, path, *extra)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            y = getattr(ht, load_name)(path, *extra, split=0, **load_kw)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            exact = y.gshape == x.gshape and y.split == 0 and bool(torch.equal(y.larray, x.larray))
            on_dev = y.larray.device.type == dev.type
            check(exact and on_dev, f"[io] {fmt}: round trip exact {exact}, on the card {on_dev}")
            mb = x.nbytes / 1e6
            out[fmt] = {"shape": list(x.gshape), "mb": mb, "save_s": save_s, "load_s": load_s,
                        "save_mb_per_s": mb / save_s, "load_mb_per_s": mb / load_s,
                        "file_mb": (sum(os.path.getsize(os.path.join(d_, f_)) for d_, _, fs in os.walk(path) for f_ in fs)
                                    if os.path.isdir(path) else os.path.getsize(path)) / 1e6}
            phase("io", card=smi, format=fmt, **{k: json.dumps(v) for k, v in out[fmt].items()})
            shutil.rmtree(path, ignore_errors=True) if os.path.isdir(path) else os.unlink(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    phase("io", card=smi, formats_run=json.dumps(out["formats_run"]), formats_skipped=json.dumps(out["formats_skipped"]),
          phase_s=repr(out["phase_s"]))
    del big, susy
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------- the request-dispatch runtime
RT_CHAIN_CYCLES, RT_CHAIN_SIZES, RT_FORCES = 16, (4096, 16 * 1024 * 1024), 100  # 100: cut from 200 for time
RT_FANOUT_N, RT_FANOUT_CONSUMERS = 1 << 19, 8
RT_REQUESTS, RT_THREADS, RT_STAGED = 100, 16, 8  # 100 requests: cut from 200 to fit the serving plane


@contextlib.contextmanager
def dispatch_knob(name: str, value):
    """One ``HEAT_TPU_*`` dispatch knob set for the block (the executor memoises them)."""
    from heat_tpu_torch.core import _executor

    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    _executor.reload_env_knobs()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
        _executor.reload_env_knobs()


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def rt_chain(x, y):
    """heat_tpu's dispatch microbenchmark chain (benchmarks/cb/dispatch.py): 16 cycles of
    four binary ops, 64 framework-level ops."""
    for _ in range(RT_CHAIN_CYCLES):
        x = x + y
        x = x * 0.5
        x = x - y
        x = x + 1.0
    return x


def rt_fanout(ht, x, y):
    """dispatch.py's fan-out graph: a 64-op shared subchain (half transcendental) feeding
    8 consumers forced one by one, then a direct read of the shared value."""
    t = x
    for _ in range(RT_CHAIN_CYCLES):
        t = ht.exp(t)
        t = t + y
        t = ht.tanh(t)
        t = t * 0.5
    outs = [t * (1.0 + i) for i in range(RT_FANOUT_CONSUMERS)]
    for o in outs:
        o.larray
    t.larray
    return [o.larray for o in outs] + [t.larray]


def launch_counts(fn) -> dict:
    """Host launch calls and device kernels of one ``fn()`` from one ``torch.profiler``
    pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"device_kernels": 0, "cudaLaunchKernel": 0, "cudaGraphLaunch": 0, "cudaMemcpyAsync": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out["device_kernels"] += 1
        elif e.name in out:
            out[e.name] += 1
    return out


def runtime_chain_phase(ht, dev, smi: str) -> dict:
    """``[runtime_chain]``: the 64-op chain at 4,096 and 16M f32 elements, split 0, forced
    200 times through the executor (its program captured in a CUDA graph at the first
    force, replayed after) and with ``HEAT_TPU_EAGER_DISPATCH=1``: bit-equal results, the
    executor's misses, hits and graph replays, per-force wall time both ways and the
    launches of one force from one profiler pass; then the fan-out graph's
    ``reexecuted_steady`` (0)."""
    import torch

    from heat_tpu_torch.core import _executor

    out = {}
    for n in RT_CHAIN_SIZES:
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        x = ht.array(torch.randn(n, generator=gen, device=dev), split=0)
        y = ht.array(torch.randn(n, generator=gen, device=dev) * 0.1, split=0)
        rec = {}
        results = {}
        for mode, knob in (("executor", None), ("eager", "1")):
            with dispatch_knob("HEAT_TPU_EAGER_DISPATCH", knob):
                _executor.clear_executor_cache()
                first = rt_chain(x, y).larray  # the executor builds and captures here
                torch.cuda.synchronize()
                ht.reset_executor_stats()
                t0 = time.perf_counter()
                for _ in range(RT_FORCES):
                    z = rt_chain(x, y).larray
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = ht.executor_stats()
                launches = launch_counts(lambda: rt_chain(x, y).larray)
            results[mode] = (first, z)
            rec[mode] = {
                "per_force_ms": 1e3 * wall / RT_FORCES,
                "launches_per_force": launches,
                "misses": st["misses"], "hits": st["hits"], "graph_replays": st["graph_replays"],
                "graph_captures": st["graph_captures"], "graphs": st["graphs"],
                "graph_pool_bytes": st["graph_pool_bytes"], "eager_fallbacks": st["eager_fallbacks"],
            }
        check(all(same_bits(a, b) for a, b in zip(results["executor"], results["eager"])),
              f"[runtime_chain] n={n}: executor and eager results differ in bits")
        e = rec["executor"]
        check(e["misses"] == 0 and e["hits"] == RT_FORCES, f"[runtime_chain] n={n}: the {RT_FORCES} forces were not pure replay: {e}")
        check(e["graph_replays"] == RT_FORCES and e["graphs"] == 1, f"[runtime_chain] n={n}: graph replays {e}")
        # the plan drops each interior value after its last reader: the graph's pool holds
        # a few of the chain's tensors (and the static buffers), not one per op
        check(e["graph_pool_bytes"] <= 8 * 4 * n + (64 << 20), f"[runtime_chain] n={n}: graph pool {e['graph_pool_bytes']} B")
        check(e["eager_fallbacks"] == 0, f"[runtime_chain] n={n}: eager fallbacks {e}")
        check(rec["eager"]["hits"] == rec["eager"]["misses"] == 0, "[runtime_chain]: the eager path met the executor")
        rec["speedup"] = rec["eager"]["per_force_ms"] / e["per_force_ms"]
        out[f"chain_{n}"] = rec
        phase("runtime_chain", n=n, ops=4 * RT_CHAIN_CYCLES, bit_equal=True,
              executor_per_force_ms=repr(e["per_force_ms"]), eager_per_force_ms=repr(rec["eager"]["per_force_ms"]),
              speedup=f"{rec['speedup']:.2f}", misses=e["misses"], hits=e["hits"], graph_replays=e["graph_replays"],
              graph_pool_bytes=e["graph_pool_bytes"], executor_launches=json.dumps(e["launches_per_force"]),
              eager_launches=json.dumps(rec["eager"]["launches_per_force"]), card=repr(smi))
        del x, y, results
        _executor.clear_executor_cache()
        torch.cuda.empty_cache()
    # the fan-out graph: the shared subchain runs once, the consumers replay one-op programs
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = ht.array(torch.randn(RT_FANOUT_N, generator=gen, device=dev), split=0)
    y = ht.array(torch.randn(RT_FANOUT_N, generator=gen, device=dev) * 0.1, split=0)
    with dispatch_knob("HEAT_TPU_EAGER_DISPATCH", "1"):
        want = rt_fanout(ht, x, y)
    _executor.clear_executor_cache()
    rt_fanout(ht, x, y)  # warm-up
    ht.reset_executor_stats()
    got = rt_fanout(ht, x, y)
    st = ht.executor_stats()
    check(st["reexecuted"] == 0, f"[runtime_chain] fan-out re-executed {st['reexecuted']} nodes")
    check(all(same_bits(a, b) for a, b in zip(got, want)), "[runtime_chain] fan-out: executor and eager bits differ")
    out["fanout"] = {"reexecuted_steady": st["reexecuted"], "interior_outputs": st["interior_outputs"],
                     "reexec_avoided": st["reexec_avoided"]}
    phase("runtime_chain", case="fanout", n=RT_FANOUT_N, reexecuted_steady=st["reexecuted"],
          interior_outputs=st["interior_outputs"], reexec_avoided=st["reexec_avoided"], bit_equal=True, card=repr(smi))
    _executor.clear_executor_cache()
    torch.cuda.empty_cache()
    return out


def serving_requests(ht, dev, km) -> dict:
    """heat_tpu's four serving request shapes (benchmarks/serving/workloads.py, smoke=False),
    each as ``(request(i) -> tensor, staged inputs)`` at its on-chip size."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def staged(shape, split):
        return [ht.array(torch.randn(shape, generator=gen, device=dev), split=split) for _ in range(RT_STAGED)]

    # kmeans_assign: predict on 65,536 x 64 batches against the main path's fitted model
    km_batches = staged((65_536, D), 0)
    # cdist_knn: 1,024 replicated queries against a 262,144 x 64 corpus split 0, then argmin
    corpus = ht.array(torch.randn(262_144, 64, generator=gen, device=dev), split=0)
    knn_batches = staged((1024, 64), None)
    # mlp_infer: 784 -> 1024 -> 10 on batches of 8,192, split 0
    torch.manual_seed(SEED + 21)
    mlp = ht.nn.Sequential(ht.nn.Linear(784, 1024), ht.nn.ReLU(), ht.nn.Linear(1024, 10))
    mlp_batches = staged((8192, 784), 0)
    # sparse_matvec: a 262,144² DCSR matrix at density 5e-4 (~34.4M entries) made from seeded
    # indices, never dense, against staged vectors
    n = 262_144
    nnz = int(round(n * n * 5e-4))
    rows = torch.randint(0, n, (nnz,), generator=gen, device=dev)
    cols = torch.randint(0, n, (nnz,), generator=gen, device=dev)
    vals = torch.randn(nnz, generator=gen, device=dev)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n)).coalesce()
    del rows, cols, vals
    mat = ht.sparse.sparse_csr_matrix(coo.to_sparse_csr(), split=0)
    del coo
    csr = mat.larray
    vecs = [torch.randn(n, generator=gen, device=dev) for _ in range(RT_STAGED)]
    return {
        "kmeans_assign": (lambda i: km.predict(km_batches[i % RT_STAGED]).larray, {"batch": [65_536, D], "k": K}),
        "cdist_knn": (lambda i: ht.argmin(ht.spatial.cdist(knn_batches[i % RT_STAGED], corpus), axis=1).larray,
                      {"corpus": [262_144, 64], "queries": 1024}),
        "mlp_infer": (lambda i: mlp(mlp_batches[i % RT_STAGED]).larray, {"layers": [784, 1024, 10], "batch": 8192}),
        "sparse_matvec": (lambda i: csr @ vecs[i % RT_STAGED], {"n": n, "nnz": int(mat.gnnz)}),
    }


def request_pool(dev, threads: int):
    """A pool of ``threads`` request threads, each entering the card first."""
    import torch

    return ThreadPoolExecutor(max_workers=threads, initializer=torch.cuda.set_device, initargs=(dev,))


def run_requests(ht, profiler, name, request, threads: int, dev) -> tuple:
    """``RT_REQUESTS`` requests of one shape from ``threads`` threads, each in
    ``profiler.request(name)`` and finished on the card before it returns; the results
    in request order and the wall time."""
    import torch

    def one(i):
        with profiler.request(name):
            r = request(i)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return r

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if threads == 1:
        results = [one(i) for i in range(RT_REQUESTS)]
    else:
        with request_pool(dev, threads) as pool:
            results = list(pool.map(one, range(RT_REQUESTS)))
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def runtime_serving_phase(ht, dev, smi: str, km) -> dict:
    """``[runtime_serving]``: each request shape 200 times from 1 thread and from 16, each
    request in ``profiler.request``: every result bit-equal to the same request with
    ``HEAT_TPU_EAGER_DISPATCH=1``, p50/p99 from the profiler's histograms, requests/s,
    batches formed, queue depth, no eager fallback, nothing quarantined, and the device's
    idle share from one traced run of 16 requests on 16 threads."""
    import torch

    from heat_tpu_torch.core import _executor, profiler

    reqs = serving_requests(ht, dev, km)
    out = {}
    for name, (request, shape) in reqs.items():
        with dispatch_knob("HEAT_TPU_EAGER_DISPATCH", "1"):
            want = [request(i).clone() for i in range(RT_STAGED)]
        _executor.clear_executor_cache()
        for i in range(RT_STAGED):  # warm: first sightings build their programs
            request(i)
        rec = {"shape": shape}
        for threads in (1, RT_THREADS):
            profiler.disable()
            profiler.reset()
            ht.reset_executor_stats()
            profiler.enable()
            results, wall = run_requests(ht, profiler, name, request, threads, dev)
            profiler.disable()
            hist = profiler.report()["histograms"][f"request.{name}"]
            st = ht.executor_stats()
            bad = [i for i, r in enumerate(results) if not same_bits(r, want[i % RT_STAGED])]
            check(not bad, f"[runtime_serving] {name} at {threads} threads: requests {bad[:5]} differ in bits from eager")
            check(hist["count"] == RT_REQUESTS, f"[runtime_serving] {name}: {hist['count']} requests observed")
            check(st["eager_fallbacks"] == 0 and not st["quarantined"],
                  f"[runtime_serving] {name}: fallbacks {st['eager_fallbacks']}, quarantined {st['quarantined']}")
            rec[f"threads_{threads}"] = {
                "p50_ms": 1e3 * hist["p50_s"], "p99_ms": 1e3 * hist["p99_s"], "max_ms": 1e3 * hist["max_s"],
                "requests_per_s": RT_REQUESTS / wall, "batched_requests": st["batched_requests"],
                "batch_width_hist": st["batch_width_hist"], "queue_depth_peak": st["queue_depth_peak"],
                "queued_dispatches": st["queued_dispatches"], "inline_dispatches": st["inline_dispatches"],
                "programs": st["programs"], "hits": st["hits"], "misses": st["misses"],
                "graph_replays": st["graph_replays"],
            }
            del results
        with request_pool(dev, RT_THREADS) as pool:
            trace = profile_device(lambda: list(pool.map(lambda i: request(i), range(RT_THREADS))), inference=False)
        rec["trace_16_requests"] = {k: trace[k] for k in ("device_idle_share", "device_busy_ms", "traced_wall_ms")
                                    if k in trace} or trace
        out[name] = rec
        t1, t16 = rec["threads_1"], rec[f"threads_{RT_THREADS}"]
        phase("runtime_serving", request=name, shape=json.dumps(shape), bit_equal_to_eager=True,
              p50_ms_1=f"{t1['p50_ms']:.4f}", p99_ms_1=f"{t1['p99_ms']:.4f}", rps_1=f"{t1['requests_per_s']:.1f}",
              p50_ms_16=f"{t16['p50_ms']:.4f}", p99_ms_16=f"{t16['p99_ms']:.4f}",
              rps_16=f"{t16['requests_per_s']:.1f}", batches_16=json.dumps(t16["batch_width_hist"]),
              queue_depth_peak_16=t16["queue_depth_peak"], eager_fallbacks=0, quarantined=0,
              idle_share=repr(rec["trace_16_requests"].get("device_idle_share", "not measured")), card=repr(smi))
        del want
        _executor.clear_executor_cache()
        torch.cuda.empty_cache()
    del reqs
    torch.cuda.empty_cache()
    return out


def runtime_lifecycle_phase(ht, dev, smi: str) -> dict:
    """``[runtime_lifecycle]``: an expired deadline raises ``DeadlineExceeded`` and plans
    nothing; ``cancel(tag)``; ``drain``/``reopen`` under 16 threads; under
    ``HEAT_TPU_SHED=1`` and overload, ``admitted + shed + failed == offered`` with typed
    errors; a fault plan armed at ``executor.execute`` leaves the results bit-equal to the
    fault-free run with ``eager_fallbacks`` > 0."""
    import torch

    from heat_tpu_torch.core import _executor, profiler, resilience

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    base = torch.randn(1 << 20, generator=gen, device=dev)
    y = ht.array(torch.randn(1 << 20, generator=gen, device=dev), split=0)

    def request(scale: float):
        return rt_chain(ht.array(base * scale, split=0), y)

    _executor.clear_executor_cache()
    want = request(1.0).larray.clone()
    sched = _executor._get_scheduler()
    # an expired deadline: typed, and nothing planned
    with profiler.request("expired", deadline_s=0.05):
        z = request(1.0)
    time.sleep(0.1)
    before = ht.executor_stats()
    try:
        z.larray
        raise RuntimeError("chip_smoke: [runtime_lifecycle] an expired request ran")
    except resilience.DeadlineExceeded:
        pass
    after = ht.executor_stats()
    check(after["misses"] == before["misses"] and after["retraces"] == before["retraces"]
          and after["expired_requests"] == before["expired_requests"] + 1, "[runtime_lifecycle] expired request planned")
    out["expired"] = {"typed": "DeadlineExceeded", "planned": 0}

    def in_threads(fn, n):
        outcomes = [None] * n

        def w(i):
            try:
                outcomes[i] = ("ok", fn(i))
            except Exception as exc:  # ht: ignore[silent-except] -- not silent: the outcome is recorded per thread and the phase's gates read every one
                outcomes[i] = ("err", exc)

        def entered(i):
            torch.cuda.set_device(dev)
            w(i)

        threads = [threading.Thread(target=entered, args=(i,), daemon=True) for i in range(n)]
        return threads, outcomes

    def join(threads):
        for t in threads:
            t.join(timeout=60)
            check(not t.is_alive(), "[runtime_lifecycle] a request hung")

    def wait_depth(n):
        deadline = time.monotonic() + 30
        while sched.depth() < n and time.monotonic() < deadline:
            time.sleep(0.002)
        check(sched.depth() >= n, "[runtime_lifecycle] requests never queued")

    # cancel(tag): the cancelled tenant's queued force fails typed, the other completes
    def tagged(i):
        with profiler.request(f"c{i}"):
            return request(1.0).larray

    profiler.enable()
    threads, outcomes = in_threads(tagged, 2)
    sched.pause()
    for t in threads:
        t.start()
    wait_depth(2)
    cancelled = sched.cancel("c0")
    sched.resume()
    join(threads)
    check(cancelled == 1 and isinstance(outcomes[0][1], resilience.RequestCancelled)
          and outcomes[1][0] == "ok" and same_bits(outcomes[1][1], want), f"[runtime_lifecycle] cancel: {outcomes}")
    # drain and reopen under 16 threads: every future settles with its value
    threads, outcomes = in_threads(lambda i: request(1.0).larray, RT_THREADS)
    sched.pause()
    for t in threads:
        t.start()
    wait_depth(RT_THREADS // 2)
    drained = sched.drain(timeout=60.0)
    join(threads)
    check(drained["flushed"] and all(o[0] == "ok" and same_bits(o[1], want) for o in outcomes),
          f"[runtime_lifecycle] drain under {RT_THREADS} threads")
    check(sched.draining(), "[runtime_lifecycle] admission open after drain")
    sched.reopen()
    profiler.disable()
    profiler.reset()
    out["cancel"] = {"cancelled": cancelled}
    out["drain"] = {"threads": RT_THREADS, "flushed": True}
    # overload under HEAT_TPU_SHED=1: a queue bound of 2 and 64 deadline-bearing requests
    # from 16 threads against a paused queue; every request is admitted, shed or failed, typed
    ht.reset_executor_stats()
    offered = 64

    def deadline_request(i):
        with profiler.request(f"o{i % 4}", deadline_s=5.0):
            return request(1.0).larray

    with dispatch_knob("HEAT_TPU_SHED", "1"), dispatch_knob("HEAT_TPU_DISPATCH_QUEUE", "2"):
        results = [None] * offered

        def w(i):
            try:
                results[i] = ("ok", deadline_request(i))
            except resilience.Shed as exc:
                results[i] = ("shed", exc)
            except resilience.DeadlineExceeded as exc:
                results[i] = ("failed", exc)

        sched.pause()
        with request_pool(dev, RT_THREADS) as pool:
            futures = [pool.submit(w, i) for i in range(offered)]
            time.sleep(0.5)
            sched.resume()
            for f in futures:
                f.result(timeout=120)
    kinds = {k: sum(1 for r in results if r[0] == k) for k in ("ok", "shed", "failed")}
    st = ht.executor_stats()
    check(sum(kinds.values()) == offered, f"[runtime_lifecycle] overload: {kinds} of {offered}")
    check(kinds["shed"] >= 1 and st["shed_requests"] == kinds["shed"], f"[runtime_lifecycle] overload shed {kinds}, {st['shed_requests']}")
    check(all(same_bits(r[1], want) for r in results if r[0] == "ok"), "[runtime_lifecycle] an admitted request differs")
    out["overload"] = {"offered": offered, "admitted": kinds["ok"], "shed": kinds["shed"], "failed": kinds["failed"],
                       "ledger_shed": st["shed_requests"], "ledger_expired": st["expired_requests"]}
    # a fault plan at executor.execute: the eager replay keeps every bit
    ht.reset_executor_stats()
    resilience.arm_fault_plan([{"site": "executor.execute", "on_call": 1, "count": 2, "kind": "raise"}])
    try:
        faulted = [request(1.0).larray for _ in range(4)]
    finally:
        resilience.disarm_fault_plan()
    st = ht.executor_stats()
    check(all(same_bits(f, want) for f in faulted) and st["eager_fallbacks"] > 0,
          f"[runtime_lifecycle] fault plan: fallbacks {st['eager_fallbacks']}")
    out["fault_plan"] = {"eager_fallbacks": st["eager_fallbacks"], "bit_equal": True}
    phase("runtime_lifecycle", expired="DeadlineExceeded,planned=0", cancelled=cancelled,
          drain=f"flushed,{RT_THREADS}_threads", overload=json.dumps(out["overload"]),
          fault_plan_eager_fallbacks=st["eager_fallbacks"], bit_equal=True, card=repr(smi))
    _executor.clear_executor_cache()
    torch.cuda.empty_cache()
    return out


def runtime_phases(ht, dev, smi: str, km) -> dict:
    """The request-dispatch runtime on the card: ``[runtime_chain]``,
    ``[runtime_serving]`` and ``[runtime_lifecycle]``; ``km`` is the main path's fitted
    KMeans model."""
    return {
        "chain": runtime_chain_phase(ht, dev, smi),
        "serving": runtime_serving_phase(ht, dev, smi, km),
        "lifecycle": runtime_lifecycle_phase(ht, dev, smi),
    }


# ------------------------------------------------------------------ the serving plane
# [serving_swap] / [serving_failover] / [planes]: a ModelPool serving Transformer-base at
# the forward path's widths (N = 6, d_model 512, d_ff 2048, h 8, f32) on src and tgt of (4, 1024, 512)
SV_BATCH, SV_T, SV_INPUTS = 4, 1024, 8
SV_REQUESTS, SV_THREADS = 200, 16
SV_FAILOVER_REQUESTS, SV_FAILOVER_HOLD_S = 64, 10.0
PL_REQUESTS = 100  # [planes]: requests an arm, cut from the swap's 200 for time
# [serving_cache]: a 16M f32 state at split 0, twelve registered 64 MB slots drawn Zipf
# (alpha 1.1) from the seed, 400 requests of ``x_slot * w + w``, cache budget 1 GiB
SC_N, SC_SLOTS, SC_REQUESTS, SC_ALPHA = 16 * 1024 * 1024, 12, 400, 1.1
# [serving_coldstart]: steady requests a workload after the first one
CS_STEADY = 25
# [supervised_train]: run_supervised over the training path's step, checkpoints every 2 steps, a fault at step 3
ST_STEPS, ST_SAVE_EVERY, ST_FAULT_STEP = 4, 2, 3


def percentiles_ms(seconds) -> dict:
    """p50/p99 (and the count) of a list of latencies in seconds, in ms."""
    if not seconds:
        return {"count": 0}
    a = np.asarray(seconds) * 1e3
    return {"count": len(seconds), "p50_ms": float(np.percentile(a, 50)), "p99_ms": float(np.percentile(a, 99))}


class ServedTransformer:
    """Transformer-base served from a ``ModelPool``: the pool's state is a tree of split-None
    DNDarrays named as the model's ``state_dict``; a request reads ``pool.state`` once,
    runs ``torch.func.functional_call`` of a per-thread copy of the module (on ``meta``:
    the call binds the state's tensors) under ``inference_mode``, then pools its output
    through the executor: a fused chain ``o * 2 + 1`` and a mean over the sequence."""

    def __init__(self, ht, dev):
        import copy

        import torch

        torch.manual_seed(SEED + 40)
        model = ht.nn.Transformer()
        self.names = list(model.state_dict())
        self.params = sum(p.numel() for p in model.parameters())
        self.meta = copy.deepcopy(model).to("meta")
        self.first = {n: t.detach().clone() for n, t in model.state_dict().items()}
        del model
        gen = torch.Generator(device=dev).manual_seed(SEED + 41)
        self.inputs = [(torch.randn(SV_BATCH, SV_T, 512, generator=gen, device=dev),
                        torch.randn(SV_BATCH, SV_T, 512, generator=gen, device=dev)) for _ in range(SV_INPUTS)]
        self.local = threading.local()
        self.ht = ht

    def template(self):
        return {n: self.ht.zeros(tuple(t.shape), dtype=self.ht.float32, split=None) for n, t in self.first.items()}

    def generation(self, seed: int) -> dict:
        """A seeded weight set: the model's initial state with every float tensor redrawn."""
        import torch

        gen = torch.Generator(device=self.first[self.names[0]].device).manual_seed(seed)
        out = {}
        for n, t in self.first.items():
            if t.is_floating_point() and t.dim() >= 2:
                out[n] = torch.randn(t.shape, generator=gen, device=t.device) * (1.0 / t.shape[-1]) ** 0.5
            else:
                out[n] = t.clone()
        return {n: self.ht.array(t, split=None) for n, t in out.items()}

    def module(self):
        import copy

        m = getattr(self.local, "m", None)
        if m is None:
            m = self.local.m = copy.deepcopy(self.meta)
        return m

    def request(self, state, i: int):
        import torch

        src, tgt = self.inputs[i % SV_INPUTS]
        tensors = {n: state[n].larray for n in self.names}
        with torch.inference_mode():
            out = torch.func.functional_call(self.module(), tensors, (src, tgt), {"tgt_is_causal": True})
        o = self.ht.array(out.clone())  # leave inference mode: the executor tracks versions
        pooled = self.ht.mean(o * 2.0 + 1.0, axis=1)
        return pooled.larray


def serve(pool, served, n: int, threads: int, dev, on_done=None, tenant: str = "serving"):
    """``n`` requests from ``threads`` threads, each in ``profiler.request(tenant)`` and
    finished on the card; per request: (index, result or the exception, start, end, kind)
    with kind ``ok``, ``typed`` (a lifecycle or supervision error) or ``untyped``.
    ``on_done(k, record)`` is called as the k-th request finishes."""
    import torch

    from heat_tpu_torch.core import profiler, resilience

    typed = (resilience.Shed, resilience.DeadlineExceeded, resilience.RequestCancelled, resilience.DrainTimeout,
             resilience.PeerFailed, resilience.CollectiveTimeout)
    records = [None] * n
    done = [0]
    lock = threading.Lock()

    def one(i):
        t0 = time.perf_counter()
        try:
            with profiler.request(tenant):
                r = served.request(pool.state, i)
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
            rec = (i, r, t0, time.perf_counter(), "ok")
        except typed as exc:
            rec = (i, exc, t0, time.perf_counter(), "typed")
        except Exception as exc:  # ht: ignore[silent-except] -- not silent: the failure is recorded as untyped with the request, and the gates require none
            rec = (i, exc, t0, time.perf_counter(), "untyped")
        records[i] = rec
        with lock:
            done[0] += 1
            k = done[0]
        if on_done is not None:
            on_done(k, rec)

    with request_pool(dev, threads) as ex:
        list(ex.map(one, range(n)))
    return records


def serving_swap_phase(ht, kernels, served, dev, smi: str, tmp: str) -> dict:
    """``[serving_swap]`` (heat_tpu's swap_gate.py on the Transformer): generations A and B
    saved by ``save_checkpoint``, C a copy of B with one chunk's bytes flipped; 200 requests
    from 16 threads; ``swap_state`` to B after about a third of them and to C after about
    two thirds. Gates: ``admitted + shed + failed == offered`` on both sides of each swap
    with 0 untyped failures; every result bit-equal to A's or B's answer for its input
    computed alone beforehand, and B's for every request that starts after the first swap
    returned; the swap to C raises ``SwapFailed`` at stage ``stage``, the pool serves B,
    the ledger holds 1 swap and 1 rollback, and the flight recorder wrote its post-mortem;
    K2 launched 18 times a request."""
    import glob
    import shutil

    import torch

    from heat_tpu_torch.core import checkpoint as ckpt, resilience, telemetry

    gens = {}
    for name, seed in (("A", SEED + 42), ("B", SEED + 43)):
        gens[name] = os.path.join(tmp, f"gen_{name}")
        ht.save_checkpoint(served.generation(seed), gens[name])
    gens["C"] = os.path.join(tmp, "gen_C")
    shutil.copytree(gens["B"], gens["C"])
    victim = max(ckpt._manifest_files(ckpt.read_manifest(gens["C"])), key=lambda f: f[1])[0]
    with open(os.path.join(gens["C"], victim), "r+b") as fh:
        b = fh.read(1)
        fh.seek(0)
        fh.write(bytes([b[0] ^ 0xFF]))
    pool = ht.serving.ModelPool(served.template(), name="transformer").load(gens["A"])
    answers = {"A": [served.request(pool.state, i).clone() for i in range(SV_INPUTS)]}
    staged_b = ht.load_checkpoint(served.template(), gens["B"])
    answers["B"] = [served.request(staged_b, i).clone() for i in range(SV_INPUTS)]
    del staged_b
    check(not any(torch.equal(a, b) for a, b in zip(answers["A"], answers["B"])), "[serving_swap] A and B answer alike")
    flight_dir = os.path.join(tmp, "flight")
    os.environ["HEAT_TPU_FLIGHT_DIR"] = flight_dir
    marks, swap_out, swappers = {}, {}, []
    swap_lock = threading.Lock()

    def on_done(k, _rec):
        for at, to in ((SV_REQUESTS // 3, "B"), (2 * SV_REQUESTS // 3, "C")):
            if k == at:
                t = threading.Thread(target=do_swap, args=(to,), daemon=True)
                swappers.append(t)
                t.start()

    def do_swap(to):
        with swap_lock:  # the swap to C waits for the swap to B
            marks[f"{to}_start"] = time.perf_counter()
            try:
                swap_out[to] = ht.serving.swap_state(pool, gens[to])
            except resilience.SwapFailed as exc:
                swap_out[to] = exc
            marks[f"{to}_end"] = time.perf_counter()

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    records = serve(pool, served, SV_REQUESTS, SV_THREADS, dev, on_done=on_done)
    for t in swappers:
        t.join(timeout=120)
    check(len(swappers) == 2 and not any(t.is_alive() for t in swappers), "[serving_swap] a swap hung")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    kinds = {k: sum(1 for r in records if r[4] == k) for k in ("ok", "typed", "untyped")}
    check(kinds["untyped"] == 0, f"[serving_swap] untyped failures: {[repr(r[1]) for r in records if r[4] == 'untyped'][:3]}")
    check(sum(kinds.values()) == SV_REQUESTS, f"[serving_swap] {kinds} of {SV_REQUESTS}")
    st = ht.executor_stats()
    for side, lo, hi in (("before_B", 0.0, marks["B_start"]), ("after_B", marks["B_end"], marks["C_start"]),
                         ("after_C", marks["C_end"], float("inf"))):
        side_kinds = [r[4] for r in records if lo <= r[2] < hi]
        check(all(k != "untyped" for k in side_kinds), f"[serving_swap] {side}: untyped failure")
    wrong, stale = [], []
    for i, r, start, end, kind in records:
        if kind != "ok":
            continue
        is_a, is_b = same_bits(r, answers["A"][i % SV_INPUTS]), same_bits(r, answers["B"][i % SV_INPUTS])
        if not (is_a or is_b):
            wrong.append(i)
        if start > marks["B_end"] and not is_b:
            stale.append(i)
    check(not wrong, f"[serving_swap] results from no whole generation: {wrong[:5]}")
    check(not stale, f"[serving_swap] requests after the swap to B served A: {stale[:5]}")
    check(isinstance(swap_out["B"], dict) and swap_out["B"]["ok"], f"[serving_swap] swap to B: {swap_out['B']!r}")
    check(isinstance(swap_out["C"], resilience.SwapFailed) and swap_out["C"].stage == "stage",
          f"[serving_swap] swap to C: {swap_out['C']!r}")
    check(pool.generation == gens["B"], f"[serving_swap] the pool serves {pool.generation}")
    ledger = pool.swap_ledger()
    check([e["ok"] for e in ledger] == [True, False] and pool._swaps == 1 and pool._rollbacks == 1,
          f"[serving_swap] ledger {ledger}")
    deadline = time.monotonic() + 10.0
    dumps = []
    while time.monotonic() < deadline and not dumps:
        dumps = glob.glob(os.path.join(flight_dir, "*swap-failed*.json"))
        time.sleep(0.05)
    check(bool(dumps), f"[serving_swap] no flight post-mortem under {flight_dir}")
    with open(dumps[0]) as fh:
        dump = json.load(fh)
    check(any(e.get("kind") == "swap-failed" for e in dump["events"]), "[serving_swap] the post-mortem lacks the rollback")
    check(counts["flash_attention_fwd"] == FLASH_PER_FORWARD * kinds["ok"],
          f"[serving_swap] K2 launched {counts['flash_attention_fwd']} times for {kinds['ok']} requests")
    lat = {"before": [r[3] - r[2] for r in records if r[3] < marks["B_start"]],
           "during": [r[3] - r[2] for r in records if r[3] >= marks["B_start"] and r[2] <= marks["B_end"]],
           "after": [r[3] - r[2] for r in records if r[2] > marks["B_end"]]}
    with request_pool(dev, SV_THREADS) as ex:
        trace = profile_device(lambda: list(ex.map(lambda i: served.request(pool.state, i), range(SV_THREADS))),
                               inference=False)
    out = {
        "params": served.params, "requests": SV_REQUESTS, "threads": SV_THREADS, "kinds": kinds,
        "requests_per_s": SV_REQUESTS / wall, "latency": {k: percentiles_ms(v) for k, v in lat.items()},
        "swap_B": {"drain_s": swap_out["B"]["drain_s"], "total_s": swap_out["B"]["total_s"]},
        "rollback_C": {"stage": swap_out["C"].stage, "total_s": ledger[-1]["total_s"]},
        "k2_launches": counts["flash_attention_fwd"], "k2_per_request": counts["flash_attention_fwd"] / kinds["ok"],
        "queued_dispatches": st["queued_dispatches"], "batched_requests": st["batched_requests"],
        "postmortem": os.path.basename(dumps[0]),
        "device_idle_share": trace.get("device_idle_share", "not measured"),
    }
    phase("serving_swap", params=served.params, requests=SV_REQUESTS, threads=SV_THREADS, kinds=json.dumps(kinds),
          bit_equal_to_a_whole_generation=True, stale_after_swap=0, rps=f"{out['requests_per_s']:.2f}",
          latency_ms=json.dumps(out["latency"]), swap_drain_s=repr(out["swap_B"]["drain_s"]),
          swap_total_s=repr(out["swap_B"]["total_s"]), rollback=json.dumps(out["rollback_C"]),
          k2_per_request=out["k2_per_request"], idle_share=repr(out["device_idle_share"]), card=repr(smi))
    telemetry.reset()
    os.environ.pop("HEAT_TPU_FLIGHT_DIR", None)
    return out, pool


def serving_cache_phase(ht, dev, smi: str, tmp: str) -> dict:
    """``[serving_cache]`` (heat_tpu's cache_gate.py): a pool whose state ``w`` is 16M f32
    at split 0; twelve registered 64 MB slots; the request ``x_slot * w + w``, one fused
    force; slots drawn Zipf (alpha 1.1) from the seed; 400 requests from 16 threads with
    ``HEAT_TPU_RESULT_CACHE=1`` (1 GiB) and with the cache off; ``swap_state`` A -> B after
    half of them. Gates: every result bit-equal to the eager value for its (slot,
    generation) and B's for every request that starts after the swap returned; hits > 0;
    a poisoned entry rejected typed and recomputed; an in-place write into a registered
    slot never served stale."""
    import torch

    from heat_tpu_torch.core import _executor, _result_cache, diagnostics, profiler

    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    gens = {}
    for name in ("A", "B"):
        gens[name] = os.path.join(tmp, f"cache_gen_{name}")
        ht.save_checkpoint({"w": ht.array(torch.randn(SC_N, generator=gen, device=dev), split=0)}, gens[name])
    slots = [ht.array(torch.randn(SC_N, generator=gen, device=dev), split=0) for _ in range(SC_SLOTS)]
    rng = np.random.default_rng(SEED + 51)
    p = 1.0 / np.arange(1, SC_SLOTS + 1) ** SC_ALPHA
    draws = rng.choice(SC_SLOTS, size=SC_REQUESTS, p=p / p.sum())
    eager = {}
    with dispatch_knob("HEAT_TPU_EAGER_DISPATCH", "1"):
        for name in ("A", "B"):
            w = ht.load_checkpoint({"w": ht.zeros((SC_N,), split=0)}, gens[name])["w"]
            eager[name] = [(slots[s] * w + w).larray.clone() for s in range(SC_SLOTS)]
            del w
    out = {}
    for arm, knob in (("cache_on", "1"), ("cache_off", None)):
        old = {k: os.environ.get(k) for k in ("HEAT_TPU_RESULT_CACHE", "HEAT_TPU_RESULT_CACHE_BYTES")}
        if knob:
            os.environ.update(HEAT_TPU_RESULT_CACHE="1", HEAT_TPU_RESULT_CACHE_BYTES=str(1 << 30))
        else:
            os.environ.pop("HEAT_TPU_RESULT_CACHE", None)
        _executor.clear_executor_cache()
        pool = ht.serving.ModelPool({"w": ht.zeros((SC_N,), split=0)}, name=f"cache-{arm}").load(gens["A"])
        for s, x in enumerate(slots):
            _result_cache.register_generation(x.larray, f"{arm}:slot:{s}", 1)
        swap = {}
        records = [None] * SC_REQUESTS
        count = [0]
        lock = threading.Lock()

        def one(i):
            t0 = time.perf_counter()
            with profiler.request("cache"):
                r = (slots[draws[i]] * pool.state["w"] + pool.state["w"]).larray
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
            records[i] = (i, r, t0, time.perf_counter())
            with lock:
                count[0] += 1
                k = count[0]
            if k == SC_REQUESTS // 2:
                swap["start"] = time.perf_counter()
                swap["entry"] = ht.serving.swap_state(pool, gens["B"])
                swap["end"] = time.perf_counter()

        _executor.reset_executor_stats()
        t0 = time.perf_counter()
        with request_pool(dev, SV_THREADS) as ex:
            list(ex.map(one, range(SC_REQUESTS)))
        wall = time.perf_counter() - t0
        rc = ht.executor_stats()["result_cache"]
        wrong, stale = [], []
        for i, r, start, end in records:
            s = draws[i]
            is_a, is_b = same_bits(r, eager["A"][s]), same_bits(r, eager["B"][s])
            if not (is_a or is_b):
                wrong.append(i)
            if start > swap["end"] and not is_b:
                stale.append(i)
        check(not wrong, f"[serving_cache] {arm}: results equal to no generation's eager value: {wrong[:5]}")
        check(not stale, f"[serving_cache] {arm}: stale values after the swap: {stale[:5]}")
        rec = {"requests": SC_REQUESTS, "rps": SC_REQUESTS / wall, "latency": percentiles_ms([r[3] - r[2] for r in records]),
               "hits": rc["hits"], "misses": rc["misses"], "stores": rc["stores"],
               "invalidations": rc["invalidations"], "hit_rate": rc["hits"] / max(1, rc["hits"] + rc["misses"]),
               "host_hash_bytes": _result_cache.host_hash_bytes(), "swap_total_s": swap["entry"]["total_s"]}
        if knob:
            check(rc["hits"] > 0, f"[serving_cache] no hits: {rc}")
            # a poisoned entry: typed rejection, recompute
            s0 = int(draws[-1])
            with profiler.request("cache"):
                (slots[s0] * pool.state["w"] + pool.state["w"]).larray
                poisoned = _result_cache._poison_one()
                r0 = ht.executor_stats()["result_cache"]["rejects"]
                again = (slots[s0] * pool.state["w"] + pool.state["w"]).larray.clone()
            events = [e for e in diagnostics.report()["resilience_events"]
                      if e["site"] == "executor.result_cache" and e["kind"] == "cache-corrupt"]
            check(poisoned >= 1 and ht.executor_stats()["result_cache"]["rejects"] == r0 + 1 and events
                  and same_bits(again, eager["B"][s0]), "[serving_cache] the poisoned entry was not rejected typed")
            # an in-place write into a registered slot: never served stale
            with profiler.request("cache"):
                before = (slots[s0] * pool.state["w"] + pool.state["w"]).larray.clone()
                slots[s0].larray.mul_(2.0)
                after = (slots[s0] * pool.state["w"] + pool.state["w"]).larray.clone()
            with dispatch_knob("HEAT_TPU_EAGER_DISPATCH", "1"):
                w = pool.state["w"]
                want = (slots[s0] * w + w).larray.clone()
            slots[s0].larray.mul_(0.5)
            check(same_bits(after, want) and not same_bits(after, before), "[serving_cache] an in-place write was served stale")
            rec.update(poison_rejected=True, in_place_write_fails_closed=True)
        out[arm] = rec
        del pool, records
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _executor.clear_executor_cache()
    phase("serving_cache", slots=SC_SLOTS, slot_mb=4 * SC_N / 2**20, zipf_alpha=SC_ALPHA, requests=SC_REQUESTS,
          threads=SV_THREADS, bit_equal=True, stale_after_swap=0, hit_rate=f"{out['cache_on']['hit_rate']:.3f}",
          on=json.dumps(out["cache_on"]), off=json.dumps(out["cache_off"]),
          host_hash_bytes=out["cache_on"]["host_hash_bytes"], card=repr(smi))
    del slots, eager
    torch.cuda.empty_cache()
    return out


def coldstart_child(mode: str, manifest: str, out_path: str) -> int:
    """One fresh process of ``[serving_coldstart]``: ``record`` runs the workloads and
    saves the warmup manifest; ``cold`` runs them as they come; ``warm`` replays the
    manifest before its first request (and then shows a corrupted index is a typed
    rejection and a boot that still serves). Each workload is ``[runtime_chain]``'s 64-op
    chain at 4,096 and 16M elements and the fan-out graph: its first request's ms, the
    executor's misses and graph replays in it, and then the steady p50/p99."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import _executor, diagnostics

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    out = {"mode": mode}
    if mode == "warm":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["warmup"] = ht.executor_warmup(manifest)
        torch.cuda.synchronize()
        out["warmup"]["seconds"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    data = {n: (ht.array(torch.randn(n, generator=gen, device=dev), split=0),
                ht.array(torch.randn(n, generator=gen, device=dev) * 0.1, split=0)) for n in RT_CHAIN_SIZES}
    fx = (ht.array(torch.randn(RT_FANOUT_N, generator=gen, device=dev), split=0),
          ht.array(torch.randn(RT_FANOUT_N, generator=gen, device=dev) * 0.1, split=0))
    work = {f"chain_{n}": (lambda xy=data[n]: rt_chain(*xy).larray) for n in RT_CHAIN_SIZES}
    work["fanout"] = lambda: rt_fanout(ht, *fx)
    for name, fn in work.items():
        ht.reset_executor_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        st = ht.executor_stats()
        steady = []
        for _ in range(CS_STEADY):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            steady.append(time.perf_counter() - t0)
        out[name] = {"first_ms": first_ms, "first_misses": st["misses"], "first_graph_replays": st["graph_replays"],
                     "first_graph_captures": st["graph_captures"], "steady": percentiles_ms(steady)}
    if mode == "record":
        out["saved"] = ht.executor_save_warmup(manifest, top=64)
    if mode == "warm":
        bad = os.path.join(os.path.dirname(out_path), "corrupt_manifest")
        os.makedirs(bad, exist_ok=True)
        with open(os.path.join(bad, "index.json"), "w") as fh:
            fh.write('{"schema": "heat-tpu-compile-cache/1", "entries": ')
        _executor.clear_executor_cache()
        stats = ht.executor_warmup(bad)
        events = [e for e in diagnostics.report()["resilience_events"]
                  if e["site"] == "executor.compile_cache" and e["kind"] == "cache-corrupt"]
        still = rt_chain(*data[RT_CHAIN_SIZES[0]]).larray
        want = None
        with dispatch_knob("HEAT_TPU_EAGER_DISPATCH", "1"):
            want = rt_chain(*data[RT_CHAIN_SIZES[0]]).larray
        out["corrupt_index"] = {"typed": bool(events) and "CompileCacheCorrupt" in events[-1]["detail"],
                                "replayed": stats["replayed"], "serves": same_bits(still, want)}
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def serving_coldstart_phase(smi: str, tmp: str) -> dict:
    """``[serving_coldstart]`` (heat_tpu's coldstart_gate.py): three fresh child processes,
    record, cold and warm (:func:`coldstart_child`). Gates: warm replays every recorded
    signature with ``failed == 0`` and ``aot_loaded == 0``, its first request of every
    workload is a hit (0 misses) and a graph replay; a corrupted index.json is a typed
    ``CompileCacheCorrupt`` event and the boot still serves."""
    manifest = os.path.join(tmp, "manifest")
    runs = {}
    for mode in ("record", "cold", "warm"):
        path = os.path.join(tmp, f"coldstart_{mode}.json")
        sys.stdout.flush()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--coldstart-child", mode, manifest, path]).returncode
        check(rc == 0, f"[serving_coldstart] the {mode} child failed (exit code {rc})")
        with open(path) as fh:
            runs[mode] = json.load(fh)
    warm, cold = runs["warm"], runs["cold"]
    saved = runs["record"]["saved"]["saved"]
    check(warm["warmup"]["replayed"] == saved and warm["warmup"]["failed"] == 0 and warm["warmup"]["aot_loaded"] == 0,
          f"[serving_coldstart] warmup {warm['warmup']} of {saved} recorded")
    names = [k for k in warm if k.startswith("chain_") or k == "fanout"]
    for n in names:
        check(warm[n]["first_misses"] == 0 and warm[n]["first_graph_replays"] >= 1,
              f"[serving_coldstart] warm {n}'s first request: {warm[n]}")
    check(warm["corrupt_index"]["typed"] and warm["corrupt_index"]["serves"],
          f"[serving_coldstart] corrupt index: {warm['corrupt_index']}")
    out = {"recorded": saved, "warmup": warm["warmup"], "corrupt_index": warm["corrupt_index"],
           **{n: {"cold_first_ms": cold[n]["first_ms"], "warm_first_ms": warm[n]["first_ms"],
                  "cold_steady": cold[n]["steady"], "warm_steady": warm[n]["steady"],
                  "cold_first_misses": cold[n]["first_misses"]} for n in names}}
    phase("serving_coldstart", recorded=saved, replayed=warm["warmup"]["replayed"], failed=warm["warmup"]["failed"],
          aot_loaded=warm["warmup"]["aot_loaded"], warmup_s=repr(warm["warmup"]["seconds"]),
          first_ms=json.dumps({n: [out[n]["cold_first_ms"], out[n]["warm_first_ms"]] for n in names}),
          steady_ms=json.dumps({n: [out[n]["cold_steady"], out[n]["warm_steady"]] for n in names}),
          corrupt_index=json.dumps(warm["corrupt_index"]), card=repr(smi))
    return out


def serving_failover_phase(ht, served, pool, dev, smi: str) -> dict:
    """``[serving_failover]`` (heat_tpu's failover_gate.py, one process): supervision armed
    over a ``LocalCoordinator`` with a virtual peer that beats and then goes silent; the
    Transformer pool takes 16-thread traffic; the monitor posts the abort, the executor and
    the scheduler refuse work typed until a request reports the failure (the balancer's
    cue), and ``pool.on_peer_failure`` quiesces and reopens. Gates: ``admitted + shed + failed ==
    offered`` with at least one typed refusal and 0 untyped errors; every admitted result
    is the pool's generation's; serving continues afterwards."""
    import torch

    from heat_tpu_torch.core import resilience, supervision

    answers = [served.request(pool.state, i).clone() for i in range(SV_INPUTS)]
    co = supervision.LocalCoordinator()
    mon = supervision.arm(co, rank=0, nprocs=2, peer_timeout_s=0.5)
    stop_beats = threading.Event()

    def virtual_peer():
        seq = 0
        while not stop_beats.is_set():
            seq += 1
            co.set(f"{mon.ns}/hb/1", str(seq))
            time.sleep(0.05)

    threading.Thread(target=virtual_peer, daemon=True).start()
    failover = {}
    refused = threading.Event()

    def on_done(k, rec):
        if k == 1:
            stop_beats.set()  # the peer goes silent early: most of the traffic follows
        if rec[4] == "typed":
            refused.set()

    def watcher():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and supervision.aborted() is None:
            time.sleep(0.01)
        payload = supervision.aborted()
        failover["payload"] = payload
        if payload is not None:
            # the balancer fails over once the pool's requests report the failure (the
            # threads run in rounds: a fixed hold may fall between two rounds' forces)
            refused.wait(timeout=SV_FAILOVER_HOLD_S)
            failover["entry"] = pool.on_peer_failure(resilience.PeerFailed(payload["rank"], payload["last_seen_s"]))

    w = threading.Thread(target=watcher, daemon=True)
    w.start()
    try:
        records = serve(pool, served, SV_FAILOVER_REQUESTS, SV_THREADS, dev, on_done=on_done, tenant="failover")
        w.join(timeout=60)
        after = serve(pool, served, SV_THREADS, SV_THREADS, dev, tenant="failover")
    finally:
        supervision.disarm()
        supervision.reset_abort()
    kinds = {k: sum(1 for r in records if r[4] == k) for k in ("ok", "typed", "untyped")}
    check(failover.get("payload", {}).get("kind") == "peer-failed" and failover.get("entry", {}).get("kind") == "peer-failover",
          f"[serving_failover] no failover: {failover}")
    check(kinds["untyped"] == 0 and kinds["typed"] >= 1 and sum(kinds.values()) == SV_FAILOVER_REQUESTS,
          f"[serving_failover] {kinds}")
    check(all(same_bits(r, answers[i % SV_INPUTS]) for i, r, *_ in (x for x in records if x[4] == "ok")),
          "[serving_failover] an admitted result is not the pool's generation's")
    check(all(r[4] == "ok" and same_bits(r[1], answers[r[0] % SV_INPUTS]) for r in after),
          "[serving_failover] serving did not continue after the failover")
    typed_names = sorted({type(r[1]).__name__ for r in records if r[4] == "typed"})
    out = {"offered": SV_FAILOVER_REQUESTS, "admitted": kinds["ok"], "failed_typed": kinds["typed"],
           "typed_errors": typed_names, "untyped": 0, "after_failover_ok": len(after),
           "failover_total_s": failover["entry"]["total_s"], "shed_at_drain": failover["entry"]["shed_at_drain"]}
    phase("serving_failover", **{k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in out.items()},
          card=repr(smi))
    del answers
    torch.cuda.empty_cache()
    return out


def supervised_child(out_path: str) -> int:
    """``[supervised_train]``'s process: an NCCL group of one joined through a file store
    (``supervision.bootstrap_distributed``); ``run_supervised`` drives 4 steps of the training path's
    seq2seq Transformer-base step (Adam), checkpointing every 2 steps; a fault plan entry
    at the step's site fires at step 3 and the site raises the supervision plane's
    ``PeerFailed`` (a virtual peer's abort); the restart aborts and destroys the group,
    joins a new one over a new store and restores step 2. Then an uninterrupted 4-step
    run from the same seed: its parameters and Adam state equal the supervised run's bit
    for bit; K2, D, K4 and K5 launch 18 times a step."""
    import tempfile

    import torch
    import torch.distributed as dist

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import kernels, resilience, supervision

    sys.path.insert(0, os.path.join(ROOT, "examples", "nn"))
    import seq2seq_transformer_torch as s2s

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    flash = ("flash_attention_fwd", "flash_attention_bwd_d", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_supervised_")
    supervision.bootstrap_distributed(f"file://{tmp}/rdv0", 1, 0, backend="nccl")
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)  # ht: ignore[collective-uncontracted] -- the communicator returns at once at world 1 without reaching NCCL; this raw call is what makes NCCL's communicator exist before the injected fault
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    batches = [[ht.array(t, split=0) for t in s2s.reverse_batch(TRAIN_B, TRAIN_T, VOCAB, generator=gen, device=dev)]
               for _ in range(ST_STEPS)]
    cfg = dict(vocab=VOCAB, max_len=TRAIN_T, d_model=512, nhead=8, layers=6, dim_feedforward=2048)

    def fresh():
        torch.manual_seed(SEED + 71)
        model = s2s.Seq2Seq(**cfg).train()
        opt = ht.optim.DataParallelOptimizer("adam", lr=1e-4)
        ht.nn.DataParallel(model, optimizer=opt)
        return model, opt

    def tree(model, opt):
        return {"model": model.state_dict(), "adam": opt.local_optimizer.state_dict()}

    model, opt = fresh()
    counts, marks = [], {}
    live = [tree(model, opt)]

    def step_fn(step, state):
        if state is not live[0]:  # a restored state: into the model and the optimizer
            model.load_state_dict(state["model"])
            opt.local_optimizer.load_state_dict(state["adam"])
            marks.setdefault("resumed_at", time.perf_counter())
            marks["resumed_step"] = step
        entry = resilience.fault_signal("train.step")
        if entry is not None:  # the plan's entry: a peer of this job failed
            marks["fault_at"] = time.perf_counter()
            supervision.post_abort("peer-failed", site="train.step", rank=1, last_seen_s=0.0)
        supervision.poll("train.step")
        kernels.reset_launch_counts()
        opt.step(s2s.seq2seq_loss, *batches[step])
        torch.cuda.synchronize()
        counts.append(kernels.launch_counts())
        live[0] = tree(model, opt)
        return live[0]

    def template():
        return tree(model, opt)

    mgr = ht.CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=4)
    reinits = []

    def reinit(exc):
        reinits.append(type(exc).__name__)
        return {"coordinator_address": f"file://{tmp}/rdv{len(reinits)}", "num_processes": 1, "process_id": 0}

    resilience.arm_fault_plan([{"site": "train.step", "kind": "raise", "on_call": ST_FAULT_STEP + 1}])
    # the first step's state is the fresh model's: Adam has no moments until it steps
    out = resilience.run_supervised(step_fn, mgr, template=template, state=live[0],
                                    max_steps=ST_STEPS, save_every=ST_SAVE_EVERY, reinit=reinit)
    resilience.disarm_fault_plan()
    world_after = (dist.get_world_size(), dist.get_backend())
    got_model = {n: t.detach().clone() for n, t in model.state_dict().items()}
    got_adam = {i: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                for i, s in opt.local_optimizer.state_dict()["state"].items()}
    del model, opt
    torch.cuda.empty_cache()
    model2, opt2 = fresh()
    for s in range(ST_STEPS):
        opt2.step(s2s.seq2seq_loss, *batches[s])
    torch.cuda.synchronize()
    params_differ = [n for n, t in model2.state_dict().items() if not torch.equal(t, got_model[n])]
    adam2 = opt2.local_optimizer.state_dict()["state"]
    adam_differ = [i for i, s in adam2.items() for k, v in s.items()
                   if torch.is_tensor(v) and not torch.equal(v, got_adam[i][k])]
    res = {
        "steps": out["steps"], "restarts": out["restarts"], "reinit_cause": reinits,
        "resumed_step": marks.get("resumed_step"), "restart_s": marks["resumed_at"] - marks["fault_at"],
        "steps_run": len(counts), "launches": counts, "world_after": list(world_after),
        "params_differ": params_differ[:5], "adam_differ": adam_differ[:5],
        "teardown": [e["detail"] for e in ht.diagnostics.report()["resilience_events"]
                     if e["site"] == "supervision.runtime" and e["kind"] == "teardown"],
    }
    supervision.teardown_distributed(clean=True)
    with open(out_path, "w") as fh:
        json.dump(res, fh)
    return 0


def supervised_train_phase(smi: str, tmp: str) -> dict:
    """``[supervised_train]``: :func:`supervised_child` in a fresh process of this script.
    Gates: one restart, caused by ``PeerFailed``, resuming at step 3 from step 2; the
    final parameters and Adam state bit-equal to the uninterrupted run; K2, D, K4 and K5
    18 times in each of the 5 steps run (4 plus the re-run step 3)."""
    path = os.path.join(tmp, "supervised.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--supervised-child", path]).returncode
    check(rc == 0, f"[supervised_train] the child failed (exit code {rc})")
    with open(path) as fh:
        res = json.load(fh)
    flash = ("flash_attention_fwd", "flash_attention_bwd_d", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    check(res["restarts"] == 1 and res["reinit_cause"] == ["PeerFailed"] and res["steps"] == ST_STEPS
          and res["resumed_step"] == ST_FAULT_STEP, f"[supervised_train] {res}")
    check(not res["params_differ"] and not res["adam_differ"],
          f"[supervised_train] differs from the uninterrupted run: {res['params_differ']} {res['adam_differ']}")
    check(res["steps_run"] == ST_STEPS and all(c[n] == FLASH_PER_FORWARD for c in res["launches"] for n in flash),
          f"[supervised_train] launches {res['launches']}")
    check(res["world_after"] == [1, "nccl"], f"[supervised_train] the group after the restart: {res['world_after']}")
    phase("supervised_train", steps=res["steps"], restarts=res["restarts"], cause=res["reinit_cause"][0],
          resumed_step=res["resumed_step"], restart_s=repr(res["restart_s"]), bit_equal_to_uninterrupted=True,
          launches_per_step=json.dumps({n: FLASH_PER_FORWARD for n in flash}), teardown=json.dumps(res["teardown"]),
          card=repr(smi))
    return res


def planes_phase(ht, served, pool, dev, smi: str, tmp: str) -> dict:
    """``[planes]``: ``[serving_swap]``'s traffic without the swaps (100 requests an arm),
    with every plane off
    and then with ``HEAT_TPU_FORENSICS=1``, ops armed at 0.5 s and telemetry collecting:
    requests/s and p99 of both and the planes' overhead. Gates: ``explain(tenant)``
    returns exemplars with a dominant stage; ``parse_openmetrics(render_openmetrics())``
    round-trips; ``dump_shard`` and ``merge`` of the one shard reproduce its counters."""
    from heat_tpu_torch.core import _executor, diagnostics, forensics, ops, telemetry

    runs = {}
    for arm in ("off", "on"):
        if arm == "on":
            os.environ["HEAT_TPU_FORENSICS"] = "1"
            _executor.reload_env_knobs()
            diagnostics.enable()
            telemetry.enable()
            ops.arm(interval_s=0.5)
        t0 = time.perf_counter()
        records = serve(pool, served, PL_REQUESTS, SV_THREADS, dev, tenant="planes")
        wall = time.perf_counter() - t0
        check(all(r[4] == "ok" for r in records), f"[planes] {arm}: a request failed")
        runs[arm] = {"rps": PL_REQUESTS / wall, **percentiles_ms([r[3] - r[2] for r in records])}
        if arm == "on":  # the serving harness's own counter beside the executor's
            diagnostics.counter("planes.requests", PL_REQUESTS)
    try:
        ex = ht.explain("planes")
        check(ex["records"] > 0 and ex["slowest"] and all(r["dominant"] for r in ex["slowest"]),
              f"[planes] explain: {ex.get('records')} records")
        ops.sample_once()
        page = ops.render_openmetrics()
        parsed = ops.parse_openmetrics(page)
        reparsed = ops.parse_openmetrics(ops.render_openmetrics())
        check(set(reparsed) == set(parsed) and "ht_samples" in parsed and page.endswith("# EOF\n"),
              "[planes] the OpenMetrics page does not round-trip")
        ops.disarm()  # its sampler counts too: the shard is taken with the plane still
        shard_dir = os.path.join(tmp, "shards")
        with open(telemetry.dump_shard(shard_dir)) as fh:
            shard = json.load(fh)
        merged = telemetry.merge(shard_dir)
        check(merged["counters"] == shard["diagnostics"]["counters"] and merged["counters"],
              "[planes] the one-shard merge does not reproduce the shard's counters")
        dominant = ex["dominant_stages"]
    finally:
        ops.disarm()
        telemetry.disable()
        diagnostics.disable()
        os.environ.pop("HEAT_TPU_FORENSICS", None)
        _executor.reload_env_knobs()
        forensics.reset()
    out = {"off": runs["off"], "on": runs["on"], "rps_overhead": 1.0 - runs["on"]["rps"] / runs["off"]["rps"],
           "p99_overhead": runs["on"]["p99_ms"] / runs["off"]["p99_ms"] - 1.0, "dominant_stages": dominant,
           "openmetrics_families": len(parsed), "merged_counters": len(merged["counters"])}
    phase("planes", off=json.dumps(runs["off"]), on=json.dumps(runs["on"]), rps_overhead=f"{out['rps_overhead']:.4f}",
          p99_overhead=f"{out['p99_overhead']:.4f}", explain_dominant=json.dumps(dominant),
          openmetrics_families=out["openmetrics_families"], shard_merge_counters=out["merged_counters"], card=repr(smi))
    return out


def serving_phases(ht, kernels, dev, smi: str) -> dict:
    """The serving plane on the card: ``[serving_swap]``, ``[serving_cache]``,
    ``[serving_coldstart]``, ``[serving_failover]``, ``[supervised_train]`` and
    ``[planes]``; their files under the temporary directory (``TMPDIR``),
    deleted after."""
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        served = ServedTransformer(ht, dev)
        swap, pool = serving_swap_phase(ht, kernels, served, dev, smi, tmp)
        out = {"swap": swap}
        out["failover"] = serving_failover_phase(ht, served, pool, dev, smi)
        out["planes"] = planes_phase(ht, served, pool, dev, smi, tmp)
        del pool, served
        torch.cuda.empty_cache()
        out["cache"] = serving_cache_phase(ht, dev, smi, tmp)
        out["coldstart"] = serving_coldstart_phase(smi, tmp)
        out["supervised_train"] = supervised_train_phase(smi, tmp)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# [launch_counts_threaded]: request threads and the calls each makes through each entry
LC_THREADS, LC_CALLS, LC_ROWS, LC_T = 16, 64, 4096, 256


def analysis_phase(smi: str) -> dict:
    """``[analysis]``: the port's invariant checker, ``python -m heat_tpu_torch.analysis
    --check --no-cache --json``, in a child process over the tree as shipped here. It
    must exit 0 with no new finding and no stale baseline entry; the modules scanned,
    the findings by rule (and those the pragmas suppressed) and its seconds are
    printed."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as td:
        report_path = os.path.join(td, "report.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "heat_tpu_torch.analysis", "--check", "--no-cache", "--json", report_path],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"the invariant checker exited {proc.returncode}:\n{proc.stdout[-4000:]}"
              f"{proc.stderr[-2000:]}")
        with open(report_path) as fh:
            report = json.load(fh)
    check(report["new_findings"] == [] and report["stale_baseline"] == [],
          f"the invariant checker: {len(report['new_findings'])} new findings, "
          f"{len(report['stale_baseline'])} stale baseline entries")
    out = {"modules_scanned": report["modules_scanned"], "rule_counts": report["rule_counts"],
           "suppressed_counts": report["suppressed_counts"], "grandfathered": len(report["grandfathered"]),
           "lock_graph_edges": len(report["lock_graph"]["edges"]), "seconds": seconds}
    phase("analysis", card=smi, **{k_: json.dumps(v) for k_, v in out.items()})
    return out


def launch_counts_threaded_phase(ht, kernels, dev, smi: str) -> dict:
    """``[launch_counts_threaded]``: ``LC_THREADS`` request threads on the card, each
    making ``LC_CALLS`` calls through each of two public entries in turn: K1 by
    KMeans' assignment (``KMeans(max_iter=0).fit`` runs the fit's one final assignment
    pass, one K1 launch, at ``LC_ROWS`` × 64, k = 8, on the thread's own data) and K2
    by ``flash_attention`` (causal, (8, ``LC_T``, 64) f32). One call of each alone
    launches its kernel once; with the counts zeroed just before the threads start,
    each count must rise by exactly ``LC_THREADS`` · ``LC_CALLS``."""
    import threading

    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    data = []
    for _ in range(LC_THREADS):
        x = torch.randn(LC_ROWS, D, generator=gen, device=dev)
        data.append((ht.array(x, split=0), ht.array(x[:K].clone())))
    q, k, v = (torch.randn(8, LC_T, 64, generator=gen, device=dev) for _ in range(3))

    def k1_call(i):
        ht.cluster.KMeans(n_clusters=K, init=data[i][1], max_iter=0).fit(data[i][0])

    def k2_call(i):
        kernels.flash_attention.flash_attention(q, k, v, causal=True)

    entries = {"kmeans_assign": k1_call, "flash_attention_fwd": k2_call}
    for name, fn in entries.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        fn(0)
        torch.cuda.synchronize()
        alone = kernels.launch_counts()
        check(alone[name] == 1 and sum(alone.values()) == 1, f"one call of {name}'s entry launched {alone}")
    start = threading.Barrier(LC_THREADS)

    def worker(i):
        start.wait(timeout=120)
        for _ in range(LC_CALLS):
            k1_call(i)
            k2_call(i)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with request_pool(dev, LC_THREADS) as pool:
        list(pool.map(worker, range(LC_THREADS)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    calls = LC_THREADS * LC_CALLS
    out = {"threads": LC_THREADS, "calls_per_thread": LC_CALLS, "calls": {n: calls for n in entries},
           "launches": {n: counts[n] for n in entries}, "wall_s": wall}
    phase("launch_counts_threaded", card=smi, **{k_: json.dumps(v_) for k_, v_ in out.items()})
    check(all(counts[n] == calls for n in entries) and sum(counts.values()) == 2 * calls,
          f"{LC_THREADS} threads x {LC_CALLS} calls of each entry: launches {counts}, expected {calls} each")
    return out


def linalg_child(out_path: str) -> int:
    """The child process of phases 13-18: the card, the package, :func:`linalg_phases`,
    :func:`array_phases`, :func:`cluster_phases` and :func:`domain_phases`; their results
    go to ``out_path`` as JSON."""
    import torch

    import heat_tpu_torch as ht

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    out = {"linalg": linalg_phases(ht, dev)}
    out["array"] = array_phases(ht, dev)
    out["cluster"] = cluster_phases(ht, dev)
    out["domain"] = domain_phases(ht, dev)
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def run_linalg_child() -> dict:
    """Phases 13-18 in a fresh process of this script (its phase lines go to this
    stdout); fails unless it ends with code 0."""
    import tempfile

    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "linalg.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--linalg-child", out_path]).returncode
        check(rc == 0, f"the linear algebra, array, clustering or domain phases failed (exit code {rc})")
        with open(out_path) as fh:
            return json.load(fh)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None, help="also write the kernels line and the fit's numbers here")
    parser.add_argument("--linalg-child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--coldstart-child", nargs=3, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--supervised-child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 2
    try:
        import heat_tpu_torch as ht
        from heat_tpu_torch.core import kernels
        from heat_tpu_torch.core.kernels import _nvcc

        sys.path.insert(0, os.path.join(ROOT, "examples", "nn"))
        import seq2seq_transformer_torch as s2s
    except ImportError as exc:
        print(f"chip_smoke: the heat_tpu_torch package is not beside this script ({exc})", file=sys.stderr)
        return 2
    if args.linalg_child:
        return linalg_child(args.linalg_child)
    if args.coldstart_child:
        return coldstart_child(*args.coldstart_child)
    if args.supervised_child:
        return supervised_child(args.supervised_child)
    k1 = kernels.kmeans
    k2 = kernels.flash_attention
    os.environ.pop(PIPELINE_KNOB, None)  # K2 wherever a phase does not ask for K3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    check(CARD in name, f"the bounds are for the {CARD}; torch names {name!r}")
    phase("card", torch_name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build every kernel, one nvcc per source, all at once (as later kernels are added);
    #    a step waits for the sources it launches (``built``), so the later sources build
    #    while the KMeans path runs, and the trainer's data phases, which launch no kernel,
    #    run first: [daso_sync] and [io], on the card and half the host's cores
    t0 = time.perf_counter()
    sources = sorted({mod.SOURCE for mod in kernels.KERNELS.values()})
    build_pool = ThreadPoolExecutor(max_workers=len(sources))
    pending, done_at, build_info = {}, {}, {}
    for src in sources:
        pending[src] = build_pool.submit(_nvcc.build, src)
        pending[src].add_done_callback(lambda _f, name=src.name: done_at.__setitem__(name, time.perf_counter()))
    build_pool.shutdown(wait=False)

    def built(*srcs) -> None:
        """Wait for the builds of ``srcs``; report each build once, with its checks, and the
        total when every one is in."""
        for source in srcs:
            if source.name in build_info:
                continue
            b = pending[source].result()
            names = [kname for kname, mod in kernels.KERNELS.items() if mod.SOURCE == source]
            ptxas = ptxas_summary(b["log"])
            mix = {n: sass_counts(lines) for n, lines in sass(b["path"]).items()}
            summary = {n: {"instructions": c["instructions"], "hmma": c["hmma"]} for n, c in mix.items()}
            build_info[source.name] = {"nvcc_s": b["seconds"], "ptxas": ptxas, "sass": summary}
            phase("build", source=source.name, kernels=",".join(names), built=b["built"], nvcc_s=f"{b['seconds']:.2f}",
                  ptxas=json.dumps(ptxas), sass=json.dumps(summary))
            # every instance of K2, K3, K4 and K5 takes its products on the tensor cores
            for kname in TENSOR_CORE_KERNELS.get(source.name, ()):
                mma = [n for n in mix if kname in n]
                check(bool(mma) and all(mix[n]["hmma"] > 0 for n in mma), f"{kname} in {source.name}: no instance, or "
                      f"one without HMMA: {summary}")
        if len(build_info) == len(sources):
            phase("build", total_s=f"{max(done_at.values()) - t0:.2f}")

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    try:
        sync_out = daso_sync_phase(ht, s2s, dev, smi)
        io_out = io_phase(ht, dev, smi)
    finally:
        torch.set_num_threads(threads)
    built(k1.SOURCE)
    lib = k1._lib()
    for d_, k_ in ((D, K), (7, 5), (48, 12), (100, 4), (256, 25), (1, 3000)):
        p_ = k1.plan(d_, k_)
        check(
            lib.kmeans_assign_smem_bytes(d_, k_, p_.threads, p_.stages) == p_.smem_bytes,
            f"the wrapper's shared-memory size for d={d_}, k={k_} disagrees with the kernel source",
        )

    # 3. north-star #1 on the card
    s = ht.arange(10, split=0).sum()
    check(s.larray.is_cuda and s.dtype is ht.int64 and s.item() == 45, f"north-star #1 gave {s}")
    phase("north_star_1", value=s.item(), dtype=s.dtype.__name__, device=str(s.larray.device))

    # 4. K1 against its plain version and float64 on the card, on the main path's data and
    #    on exact (rounded to integers) data, at the main path's shape and edge ones: n below
    #    one tile and one row past it, d of 7, 10, 48, 100 and 256, k of 1 and 12 (the
    #    centers in shared memory), ragged n, and x 4 bytes past a 16-byte boundary
    x, init, true = blobs(N, D, K, SEED, dev)
    tile = k1.plan(D, K).rows_per_tile
    checks = {}
    for n, d, k, offset in [(N, D, K, 0), (tile - 56, D, K, 0), (tile + 1, D, K, 0), (130, 10, 3, 0), (1500, 7, 5, 0),
                            (5000, D, 1, 0), (3000, 48, 12, 0), (2000, 100, 6, 0), (3001, 256, 8, 0),
                            (4099, D, K, 1), (4 * SPECTRAL_N, 4, 4, 0)]:
        if n == N:
            xs, cs = x, init
        else:
            gen = torch.Generator(device=dev).manual_seed(SEED + n)
            xs = placed(torch.randn(n, d, generator=gen, device=dev), offset)
            cs = torch.randn(k, d, generator=gen, device=dev)
        for exact in (False, True):
            data = "exact" if exact else "float"
            xe = placed(torch.round(xs), offset) if exact else xs
            got = check_k1(k1, xe, torch.round(cs) if exact else cs, exact)
            tag = (n, d, k, data + ("_misaligned" if offset else ""))
            checks[tag] = got
            phase("k1_vs_plain_and_f64", shape=f"{n}x{d}x{k}", data=tag[3], **got, deterministic=True)
            del xe
        del xs, cs
    torch.cuda.empty_cache()

    # 5. the KMeans path: KMeans.fit at the benchmark's configuration
    X = ht.array(x, split=0)
    km = ht.cluster.KMeans(n_clusters=K, init=ht.array(init), max_iter=MAX_ITER, tol=-1.0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    km.fit(X)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(km.n_iter_ == MAX_ITER, f"the fit ran {km.n_iter_} iterations")
    check(counts["kmeans_assign"] == MAX_ITER + 1, f"launches on the KMeans path: {counts}")
    centers = km.cluster_centers_.larray
    labels = km.labels_.larray
    check(centers.shape == (K, D) and centers.is_cuda and bool(torch.isfinite(centers).all()), "fitted centers")
    check(labels.shape == (N,) and labels.dtype == torch.int64 and labels.is_cuda, "fitted labels' shape/type")
    check(bool(((labels >= 0) & (labels < K)).all()), "a fitted label is out of range")
    inertia = km.inertia_
    per_row = inertia / N
    check(0.9 * D < per_row < 1.1 * D, f"inertia per row {per_row}, expected ~{D} for unit noise")
    center_err = float((centers - true).abs().max())
    # a cluster mean of ~n/k unit-noise rows: 6 standard errors
    check(center_err < 6.0 / (N / K) ** 0.5, f"fitted centers are {center_err} from the blobs' true centers")
    # the same fit on a small input: the kernel path on the card against the CPU path
    xs, cs, _ = blobs(4096, D, K, SEED + 1, dev)
    on_card = ht.cluster.KMeans(n_clusters=K, init=ht.array(cs), max_iter=10).fit(ht.array(xs, split=0))
    on_cpu = ht.cluster.KMeans(n_clusters=K, init=ht.array(cs.cpu(), device="cpu"), max_iter=10).fit(
        ht.array(xs.cpu(), split=0, device="cpu")
    )
    check(on_card.n_iter_ == on_cpu.n_iter_, "small fit: iterations differ between card and CPU")
    check(torch.equal(on_card.labels_.larray.cpu(), on_cpu.labels_.larray), "small fit: labels differ between card and CPU")
    torch.testing.assert_close(on_card.cluster_centers_.larray.cpu(), on_cpu.cluster_centers_.larray, rtol=0, atol=1e-4)
    phase(
        "kmeans_fit", n=N, d=D, k=K, n_iter=km.n_iter_, launches=json.dumps(counts), inertia=repr(inertia),
        center_err=center_err, small_fit_matches_cpu=True,
    )
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km.fit(X)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    fit_s = min(walls)
    phase("kmeans_fit_time", best_of_2_s=repr(fit_s), per_iteration_ms=repr(1e3 * fit_s / (MAX_ITER + 1)))
    # one fit traced: the device's time by kind of kernel, its idle share, and the host's time
    # a Lloyd iteration beyond the device's (the per-iteration shift readback included)
    fit_profile = profile_device(lambda: km.fit(X), inference=False)
    if "device_busy_ms" in fit_profile:
        idle_ms = fit_profile["traced_wall_ms"] - fit_profile["device_busy_ms"]
        fit_profile["device_idle_ms_per_iteration"] = idle_ms / (MAX_ITER + 1)
        k1_calls = [n_ for name_, _, n_ in fit_profile["top_kernels"] if "kmeans_assign" in name_]
        check(k1_calls == [MAX_ITER + 1], f"the traced fit ran K1 {k1_calls} times")
    phase("kmeans_fit_profile", **{key: json.dumps(v) for key, v in fit_profile.items()})

    serving_km = km  # the fitted model serves [runtime_serving]'s kmeans_assign requests
    del X, km, x, init, true, xs, cs, on_card, on_cpu, labels, centers
    torch.cuda.empty_cache()

    # 5b. the k-means++ path: KMeans(init="kmeans++") at the same configuration (host-bound:
    #     it waits for the last builds, whose nvcc would share its cores)
    built(*sources)
    pp = kmeans_pp_phase(ht, kernels, dev)
    torch.cuda.empty_cache()

    # 6. K2 against its plain version on the card
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # around the forwards' tiles (64 query rows a block; keys in tiles of 64 for K2 and 32
    # for K3 at d <= 64, of 16 for both at d <= 128) and at head dims of 8, 72 and 96
    fwd_edges = {
        "edge_63x65_f32": (2, 63, 65, 64, False, f32, None),
        "edge_65x63_causal_f32": (2, 65, 63, 64, True, f32, None),
        "edge_127x129_causal_f32": (2, 127, 129, 64, True, f32, None),
        "edge_129x127_causal_bf16": (2, 129, 127, 64, True, bf16, None),
        "edge_33x31_f32": (2, 33, 31, 64, False, f32, None),
        "edge_31x97_causal_f32": (2, 31, 97, 64, True, f32, None),
        "edge_d8_causal_f32": (2, 65, 129, 8, True, f32, None),
        "edge_d72_17x15_causal_f32": (2, 17, 15, 72, True, f32, None),
        "edge_d72_dead_row_f16": (2, 100, 140, 72, False, f16, "random"),
        "edge_d96_causal_f32": (2, 130, 33, 96, True, f32, None),
    }
    e_heads = BATCH * 8  # batch x heads of Transformer-base
    k2_cases = {
        # name: (bh, tq, tk, d, causal, dtype, mask)
        "encoder_self": (e_heads, SRC_T, SRC_T, 64, False, f32, None),
        "decoder_self_causal": (e_heads, TGT_T, TGT_T, 64, True, f32, None),
        "decoder_cross": (e_heads, TGT_T, SRC_T, 64, False, f32, None),
        "bench_causal_bf16": (BENCH_B * BENCH_H, BENCH_T, BENCH_T, BENCH_D, True, bf16, None),
        "bench_padding_mask_bf16": (BENCH_B * BENCH_H, BENCH_T, BENCH_T, BENCH_D, False, bf16, "padding"),
        "ragged_causal_dead_row_f32": (3, 37, 53, 8, True, f32, "random"),
        "ragged_d128_dead_row_f32": (2, 70, 100, 128, True, f32, "random"),
        "ragged_dead_row_bf16": (2, 130, 97, 96, False, bf16, "random"),
        "ragged_causal_f16": (2, 64, 33, 64, True, torch.float16, None),
        **fwd_edges,
    }
    k2_checks, k2_data = {}, {}
    for i, (cname, (bh, tq, tk, dh, causal, dtype, mkind)) in enumerate(k2_cases.items()):
        q, k, v = k2_inputs(bh, tq, tk, dh, dtype, SEED + 10 + i, dev)
        mask, dead = None, ()
        if mkind == "padding":  # bench.py:248: the last T/8 keys are padding
            mask = (torch.arange(tk, device=dev)[None, :] < tk - tk // 8).expand(tq, tk).contiguous()
        elif mkind == "random":
            gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
            mask = torch.rand(tq, tk, generator=gen, device=dev) < 0.7
            dead = (3,)
            mask[3] = False
        got = check_k2(k2, q, k, v, causal, mask, dead)
        k2_checks[cname] = got
        phase("k2_vs_plain", case=cname, shape=f"{bh}x{tq}x{tk}x{dh}", dtype=str(dtype).split(".")[-1],
              causal=causal, mask=mkind, **got, deterministic=True)
        if cname in ("encoder_self", "decoder_self_causal", "decoder_cross", "bench_causal_bf16"):
            k2_data[cname] = (q, k, v, causal)
        else:
            del q, k, v
    torch.cuda.empty_cache()

    # 7. K3 against its plain version and against K2 on the card
    t_heads = TRAIN_B * 8  # batch x heads of the training step
    k3_cases = {
        # name: (bh, tq, tk, d, causal, dtype, mask)
        "encoder_self": (e_heads, SRC_T, SRC_T, 64, False, f32, None),
        "decoder_self_causal": (e_heads, TGT_T, TGT_T, 64, True, f32, None),
        "decoder_cross": (e_heads, TGT_T, SRC_T, 64, False, f32, None),
        "bench_causal_bf16": (BENCH_B * BENCH_H, BENCH_T, BENCH_T, BENCH_D, True, bf16, None),
        "bench_padding_mask_bf16": (BENCH_B * BENCH_H, BENCH_T, BENCH_T, BENCH_D, False, bf16, "padding"),
        "step_self": (t_heads, TRAIN_T, TRAIN_T, 64, False, f32, None),
        "step_self_causal": (t_heads, TRAIN_T, TRAIN_T, 64, True, f32, None),
        "ragged_causal_tk_gt_tq_d32_f16": (3, 37, 90, 32, True, f16, None),
        "ragged_causal_tq_gt_tk_d100_f32": (2, 130, 61, 100, True, f32, None),
        "ragged_d128_dead_row_f32": (2, 70, 100, 128, True, f32, "random"),
        "ragged_d100_dead_row_bf16": (2, 130, 97, 100, False, bf16, "random"),
        "ragged_d33_causal_f16": (2, 70, 45, 33, True, f16, None),  # rows not 4-byte aligned: plain-load copies
        "float_bias_dead_row_f32": (4, 300, 260, 64, False, f32, "float"),
        **fwd_edges,
    }
    k3_timed = ("encoder_self", "decoder_self_causal", "decoder_cross", "bench_causal_bf16", "step_self", "step_self_causal")
    k3_checks, k3_data = {}, {}
    for i, (cname, (bh, tq, tk, dh, causal, dtype, mkind)) in enumerate(k3_cases.items()):
        q, k, v = k2_inputs(bh, tq, tk, dh, dtype, SEED + 700 + i, dev)
        mask, dead = None, ()
        gen = torch.Generator(device=dev).manual_seed(SEED + 800 + i)
        if mkind == "padding":  # bench.py:248: the last T/8 keys are padding
            mask = (torch.arange(tk, device=dev)[None, :] < tk - tk // 8).expand(tq, tk).contiguous()
        elif mkind == "random":
            mask = torch.rand(tq, tk, generator=gen, device=dev) < 0.7
            dead = (3,)
            mask[3] = False
        elif mkind == "float":
            mask = torch.randn(tq, tk, generator=gen, device=dev)
            dead = (5,)
            mask[5] = k2._NEG_INF
        got = check_k3(k2, q, k, v, causal, mask, dead)
        k3_checks[cname] = got
        phase("k3_vs_plain_and_k2", case=cname, shape=f"{bh}x{tq}x{tk}x{dh}", dtype=str(dtype).split(".")[-1],
              causal=causal, mask=mkind, **got, deterministic=True)
        if cname in k3_timed:
            k3_data[cname] = (q, k, v, causal)
        else:
            del q, k, v
    # the library call, K2 and K3 in turns (library, K2, K3, K3, K2, library) at each large
    # shape, then K3's plain version at the encoder shape
    k3_ms, k3_k2_ms, k3_bounds, fwd_library_ms = {}, {}, {}, {}
    with torch.no_grad():
        for cname, (q, k, v, causal) in k3_data.items():
            q4, k4, v4 = (t.view(t.shape[0] // 8, 8, t.shape[1], t.shape[2]) for t in (q, k, v))
            runs = [cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                            reps=5, warmup=1)]
            for on in (False, True, True, False):
                with pipelined(on):
                    runs.append(cuda_ms(lambda: k2.flash_attention_fwd(q, k, v, causal), reps=5, warmup=1))
            runs.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                                reps=5, warmup=1))
            del q4, k4, v4
            fwd_library_ms[cname] = (runs[0] + runs[5]) / 2
            k3_ms[cname], k3_k2_ms[cname] = (runs[2] + runs[3]) / 2, (runs[1] + runs[4]) / 2
            bh, tq, dh = q.shape
            k3_bounds[cname] = k2_bound_ms(bh, tq, k.shape[1], dh, causal, q.element_size())
        q, k, v, _ = k3_data["encoder_self"]
        k3_plain_ms = cuda_ms(lambda: k2.flash_attention_pipelined_reference(q, k, v, False), reps=3, warmup=1)
    phase("k3_time", k3_ms=json.dumps(k3_ms), k2_ms_in_turns=json.dumps(k3_k2_ms),
          library_ms_in_turns=json.dumps(fwd_library_ms),
          k3_over_k2=json.dumps({c: k3_ms[c] / k3_k2_ms[c] for c in k3_ms}),
          k2_over_library=json.dumps({c: k3_k2_ms[c] / fwd_library_ms[c] for c in k3_ms}),
          k3_over_library=json.dumps({c: k3_ms[c] / fwd_library_ms[c] for c in k3_ms}),
          bound_ms=json.dumps({c: b[0] for c, b in k3_bounds.items()}),
          k3_share_of_bound=json.dumps({c: k3_bounds[c][0] / k3_ms[c] for c in k3_ms}),
          k2_share_of_bound=json.dumps({c: k3_bounds[c][0] / k3_k2_ms[c] for c in k3_ms}), plain_ms=repr(k3_plain_ms))
    del k3_data
    torch.cuda.empty_cache()

    # 8. the Transformer path: Transformer-base, one forward of src (8, 4096, 512), tgt (8, 2048, 512)
    torch.manual_seed(SEED)
    model = ht.nn.Transformer()  # on the card: the port's default device
    check(all(p.is_cuda for p in model.parameters()), "the model's parameters are not on the card")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    src = torch.randn(BATCH, SRC_T, model.d_model, generator=gen, device=dev)
    tgt = torch.randn(BATCH, TGT_T, model.d_model, generator=gen, device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = model(src, tgt, tgt_is_causal=True)
        torch.cuda.synchronize()
        t_counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(t_counts["flash_attention_fwd"] == FLASH_PER_FORWARD, f"launches on the Transformer path: {t_counts}")
    check(tuple(out.shape) == (BATCH, TGT_T, model.d_model) and out.is_cuda and out.dtype == torch.float32,
          f"forward output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), "the forward gave a value that is not finite")
    # after the decoder's final LayerNorm (weight 1, bias 0) each row has mean 0, variance 1
    row_mean = float(out.mean(-1).abs().max())
    row_var = float((out.var(-1, unbiased=False) - 1).abs().max())
    check(row_mean < 1e-4 and row_var < 1e-3, f"output rows are not normalised: |mean| {row_mean}, |var-1| {row_var}")
    # a 1 + 1-layer Transformer-base at T = 512 on the card against the port's CPU path
    torch.manual_seed(SEED + 3)
    small = ht.nn.Transformer(num_encoder_layers=1, num_decoder_layers=1)
    small_cpu = ht.nn.Transformer(num_encoder_layers=1, num_decoder_layers=1, device="cpu")
    small_cpu.load_state_dict({name: t.cpu() for name, t in small.state_dict().items()})
    xs = torch.randn(2, 512, 512, generator=gen, device=dev)
    xt = torch.randn(2, 512, 512, generator=gen, device=dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        a = small(xs, xt, tgt_is_causal=True)
        torch.cuda.synchronize()
        small_counts = kernels.launch_counts()
        b = small_cpu(xs.cpu(), xt.cpu(), tgt_is_causal=True)
    check(small_counts["flash_attention_fwd"] == 3, f"launches in the small forward: {small_counts}")
    # fp32 on both sides (K2 and cuBLAS without TF32 against the CPU's plain path),
    # summed in other orders: the tolerance of the CPU tests for a 2 + 2-layer model
    small_err = float((a.cpu() - b).abs().max())
    torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    phase("transformer_forward", params=n_params, src=f"{BATCH}x{SRC_T}x{model.d_model}",
          tgt=f"{BATCH}x{TGT_T}x{model.d_model}", launches=json.dumps(t_counts), peak_gb=f"{peak_gb:.2f}",
          small_model_max_abs_err_vs_cpu=small_err)
    del small, small_cpu, xs, xt, a, b
    fwd_walls = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(src, tgt, tgt_is_causal=True)
            torch.cuda.synchronize()
            fwd_walls.append(time.perf_counter() - t0)
    fwd_s = min(fwd_walls)
    # K2 at each shape of the forward (median of CUDA-event runs), and its share
    k2_ms, k2_bounds = {}, {}
    with torch.no_grad():
        for cname, (q, k, v, causal) in k2_data.items():
            k2_ms[cname] = cuda_ms(lambda: k2.flash_attention_fwd(q, k, v, causal), reps=10, warmup=2)
            bh, tq, dh = q.shape
            k2_bounds[cname] = k2_bound_ms(bh, tq, k.shape[1], dh, causal, q.element_size())
    attn_ms = 6 * (k2_ms["encoder_self"] + k2_ms["decoder_self_causal"] + k2_ms["decoder_cross"])
    phase("transformer_forward_time", best_of_2_s=repr(fwd_s), walls_s=json.dumps(fwd_walls),
          k2_ms=json.dumps(k2_ms), k2_in_forward_ms=repr(attn_ms), k2_share=repr(attn_ms / (1e3 * fwd_s)),
          tokens_per_s=repr(BATCH * (SRC_T + TGT_T) / fwd_s))

    # where the forward's device time goes: one forward under torch.profiler, kernels by kind
    breakdown = profile_device(lambda: model(src, tgt, tgt_is_causal=True))
    phase("transformer_forward_profile", **{k: json.dumps(v) for k, v in breakdown.items()})

    # the serving path with HEAT_TPU_FLASH_PIPELINE=1: the same forward, every attention on K3
    with pipelined(True):
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            out_on = model(src, tgt, tgt_is_causal=True)
            torch.cuda.synchronize()
            t_counts_on = kernels.launch_counts()
        peak_on_gb = torch.cuda.max_memory_allocated() / 1e9
        check(t_counts_on["flash_attention_fwd_pipelined"] == FLASH_PER_FORWARD and t_counts_on["flash_attention_fwd"] == 0,
              f"launches on the knob-on Transformer path: {t_counts_on}")
        on_err = float((out_on - out).abs().max())
        check(on_err <= 1e-4 * float(out.abs().max()), f"the knob-on forward is {on_err} from the knob-off one")
        fwd_on_walls = []
        with torch.inference_mode():
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(src, tgt, tgt_is_causal=True)
                torch.cuda.synchronize()
                fwd_on_walls.append(time.perf_counter() - t0)
        fwd_on_s = min(fwd_on_walls)
        breakdown_on = profile_device(lambda: model(src, tgt, tgt_is_causal=True))
    phase("transformer_forward_pipelined", launches=json.dumps(t_counts_on), max_abs_err_vs_knob_off=on_err,
          out_max_abs=float(out.abs().max()), peak_gb=f"{peak_on_gb:.2f}", best_of_2_s=repr(fwd_on_s),
          walls_s=json.dumps(fwd_on_walls), tokens_per_s=repr(BATCH * (SRC_T + TGT_T) / fwd_on_s))
    phase("transformer_forward_pipelined_profile", **{k: json.dumps(v) for k, v in breakdown_on.items()})
    del model, src, tgt, out, out_on
    torch.cuda.empty_cache()

    # 9. the D pass, K4 and K5 against the plain backward on the card
    bwd_cases = {
        # name: (bh, tq, tk, d, causal, dtype, mask)
        "encoder_self": (t_heads, TRAIN_T, TRAIN_T, 64, False, f32, None),
        "decoder_self_causal": (t_heads, TRAIN_T, TRAIN_T, 64, True, f32, None),
        "decoder_cross": (t_heads, TRAIN_T, TRAIN_T, 64, False, f32, None),
        "bench_causal_bf16": (BENCH_B * BENCH_H, BENCH_T, BENCH_T, BENCH_D, True, bf16, None),
        "ragged_causal_tk_gt_tq_f32": (3, 37, 90, 8, True, f32, None),
        "ragged_tq_gt_tk_f32": (2, 130, 61, 64, True, f32, None),
        "ragged_d32_f32": (2, 70, 45, 32, False, f32, None),
        "ragged_d100_dead_row_f32": (2, 70, 100, 100, False, f32, "random"),
        "ragged_d128_causal_dead_row_f32": (2, 70, 100, 128, True, f32, "random"),
        "ragged_dead_row_bf16": (2, 130, 97, 96, False, bf16, "random"),
        "ragged_causal_f16": (2, 64, 33, 64, True, torch.float16, None),
        # around the tiles of K4 and K5 (96 rows a block, tiles of 32 keys or queries), a
        # head dim between 64 and 128, a 2-byte row of odd d (plain loads in place of
        # cp.async) and a fully masked row in f16
        "edge_63x65_f32": (2, 63, 65, 64, False, f32, None),
        "edge_97x95_causal_f32": (2, 97, 95, 64, True, f32, None),
        "edge_65x63_causal_f32": (2, 65, 63, 64, True, f32, None),
        "edge_127x129_causal_f32": (2, 127, 129, 64, True, f32, None),
        "edge_129x127_f32": (2, 129, 127, 64, False, f32, None),
        "edge_d72_causal_f32": (2, 100, 140, 72, True, f32, None),
        "ragged_d33_causal_bf16": (2, 90, 77, 33, True, bf16, None),
        "dead_row_d64_f16": (2, 96, 80, 64, False, torch.float16, "random"),
    }
    bwd_checks, bwd_data = {}, {}
    for i, (cname, (bh, tq, tk, dh, causal, dtype, mkind)) in enumerate(bwd_cases.items()):
        q, k, v = k2_inputs(bh, tq, tk, dh, dtype, SEED + 200 + i, dev)
        mask = None
        if mkind == "random":
            gen = torch.Generator(device=dev).manual_seed(SEED + 300 + i)
            mask = torch.rand(tq, tk, generator=gen, device=dev) < 0.7
            mask[3] = False
        got = check_bwd(k2, q, k, v, causal, mask, SEED + 400 + i)
        bwd_checks[cname] = got
        phase("k2_bwd_vs_plain", case=cname, shape=f"{bh}x{tq}x{tk}x{dh}", dtype=str(dtype).split(".")[-1],
              causal=causal, mask=mkind, **got, deterministic=True)
        if cname in ("encoder_self", "decoder_self_causal", "bench_causal_bf16"):
            bwd_data[cname] = (q, k, v, causal)
        else:
            del q, k, v
    # autograd through the port's flash_attention (K2, then D, K4, K5) against autograd
    # through the plain forward
    qa, ka, va = (t.view(2, 8, 512, 64).requires_grad_() for t in k2_inputs(16, 512, 512, 64, f32, SEED + 500, dev))
    ga = torch.randn(qa.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 501), device=dev)
    got = torch.autograd.grad(k2.flash_attention(qa, ka, va, True), (qa, ka, va), ga)
    want = torch.autograd.grad(k2.flash_attention_reference(qa, ka, va, True)[0], (qa, ka, va), ga)
    autograd_ratio = max(float((a - b).abs().max()) / (2e-4 * float(b.abs().max())) for a, b in zip(got, want))
    check(autograd_ratio <= 1.0, f"autograd through flash_attention disagrees with the plain forward's: err/tol {autograd_ratio}")
    phase("k2_bwd_autograd", shape="2x8x512x512x64", causal=True, err_over_tol=autograd_ratio)
    del qa, ka, va, ga, got, want
    torch.cuda.empty_cache()

    # 10. the training path: one step of the Transformer-base seq2seq model, 12 x 2048 + 12 x 2048 tokens
    torch.manual_seed(SEED)
    model = s2s.Seq2Seq(vocab=VOCAB, max_len=TRAIN_T, d_model=512, nhead=8, layers=6, dim_feedforward=2048).train()
    check(all(p.is_cuda for p in model.parameters()), "the model's parameters are not on the card")
    n_params = sum(p.numel() for p in model.parameters())
    opt = ht.optim.DataParallelOptimizer("adam", lr=1.0)
    ht.nn.DataParallel(model, optimizer=opt)
    sched = ht.optim.lr_scheduler.LambdaLR(opt, lambda e: 512**-0.5 * min((e + 1) ** -0.5, (e + 1) * WARMUP**-1.5))
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    batch = [ht.array(t, split=0) for t in s2s.reverse_batch(TRAIN_B, TRAIN_T, VOCAB, generator=gen, device=dev)]
    tf32_seen = []

    def probed_loss(m, src_, tgt_in_, tgt_):
        tf32_seen.append(("forward", torch.backends.cuda.matmul.allow_tf32))
        logits = m(src_, tgt_in_)
        logits.register_hook(lambda g: tf32_seen.append(("backward", torch.backends.cuda.matmul.allow_tf32)))
        return torch.nn.functional.cross_entropy(logits.reshape(-1, VOCAB), tgt_.reshape(-1))

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.backends.cuda.matmul.allow_tf32 = True  # the step must hold it off for its forward and backward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss = opt.step(probed_loss, *batch)
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tf32_restored = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sched.step()
    flash = ("flash_attention_fwd", "flash_attention_bwd_d", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    check(all(train_counts[n] == FLASH_PER_FORWARD for n in flash), f"launches in one training step: {train_counts}")
    check(tf32_seen == [("forward", False), ("backward", False)] and tf32_restored, f"TF32 in the step: {tf32_seen}")
    loss0 = float(loss)
    check(loss.dim() == 0 and loss.is_cuda and math.isfinite(loss0), f"the step's loss {loss0}")
    # random weights predict about uniformly: the loss starts near log(vocab)
    check(abs(loss0 - math.log(VOCAB)) < 2.0, f"first loss {loss0}, log(vocab) is {math.log(VOCAB)}")
    params = dict(model.named_parameters())
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in params.values()), "a gradient is not finite")
    moved = [n for n, p in params.items() if not torch.equal(p.detach(), before[n])]
    still = [n for n in params if n not in moved and bool(params[n].grad.any())]
    check(not still and len(moved) > 0.9 * len(params), f"parameters with a gradient that did not change: {still}")
    grads_off = {n: p.grad.detach().clone() for n, p in params.items()}
    # a 1 + 1-layer d_model 512 model at T = 512 on the card against the port's CPU path
    torch.manual_seed(SEED + 5)
    small_cfg = dict(vocab=1000, max_len=512, d_model=512, nhead=8, layers=1, dim_feedforward=2048)
    small = s2s.Seq2Seq(**small_cfg).train()
    small_cpu = s2s.Seq2Seq(**small_cfg, device="cpu").train()
    small_cpu.load_state_dict({n: t.cpu() for n, t in small.state_dict().items()})
    small_init = {n: t.clone() for n, t in small.state_dict().items()}
    opt_g, opt_c = (ht.optim.DataParallelOptimizer("sgd", lr=0.1) for _ in range(2))
    ht.nn.DataParallel(small, optimizer=opt_g)
    ht.nn.DataParallel(small_cpu, optimizer=opt_c)
    small_batches = [s2s.reverse_batch(2, 512, 1000, generator=gen, device=dev) for _ in range(3)]
    grad_ratio, small_losses = 0.0, []
    for i, b in enumerate(small_batches):
        kernels.reset_launch_counts()
        lg = opt_g.step(s2s.seq2seq_loss, *(ht.array(t, split=0) for t in b))
        torch.cuda.synchronize()
        small_counts = kernels.launch_counts()
        lc = opt_c.step(s2s.seq2seq_loss, *(ht.array(t.cpu(), split=0, device="cpu") for t in b))
        small_losses.append((float(lg), float(lc)))
        check(all(small_counts[n] == 3 for n in flash), f"launches in the small step: {small_counts}")
        if i == 0:
            small_grads0 = {n: pg.grad.clone() for n, pg in small.named_parameters()}
            # fp32 on both sides (the kernels and cuBLAS without TF32 against the CPU's plain
            # path), summed in other orders: each gradient within 1e-3 of its largest entry
            for (n, pg), (_, pc) in zip(small.named_parameters(), small_cpu.named_parameters()):
                err = float((pg.grad.cpu() - pc.grad).abs().max())
                grad_ratio = max(grad_ratio, err / (1e-3 * float(pc.grad.abs().max()) + 1e-30))
    with torch.no_grad():
        after = (float(s2s.seq2seq_loss(small, *small_batches[0])),
                 float(s2s.seq2seq_loss(small_cpu, *(t.cpu() for t in small_batches[0]))))
    check(grad_ratio <= 1.0, f"the small model's gradients on the card and the CPU differ: err/tol {grad_ratio}")
    check(abs(small_losses[0][0] - small_losses[0][1]) <= 1e-5 * abs(small_losses[0][1]), f"small losses {small_losses}")
    check(abs(after[0] - after[1]) <= 1e-4 * abs(after[1]), f"the small model's loss after three SGD steps: {after}")
    # the small model's first step again with the knob on: K3 in place of K2, held to the
    # knob-off step by the same rules (loss 1e-5, each gradient within 1e-3 of its largest entry)
    small_on = s2s.Seq2Seq(**small_cfg).train()
    small_on.load_state_dict(small_init)
    opt_on = ht.optim.DataParallelOptimizer("sgd", lr=0.1)
    ht.nn.DataParallel(small_on, optimizer=opt_on)
    with pipelined(True):
        kernels.reset_launch_counts()
        lo = float(opt_on.step(s2s.seq2seq_loss, *(ht.array(t, split=0) for t in small_batches[0])))
        torch.cuda.synchronize()
        small_on_counts = kernels.launch_counts()
    check(small_on_counts["flash_attention_fwd_pipelined"] == 3 and small_on_counts["flash_attention_fwd"] == 0,
          f"launches in the small knob-on step: {small_on_counts}")
    small_on_ratio = max(float((p.grad - small_grads0[n]).abs().max()) / (1e-3 * float(small_grads0[n].abs().max()) + 1e-30)
                         for n, p in small_on.named_parameters())
    check(abs(lo - small_losses[0][0]) <= 1e-5 * abs(small_losses[0][0]), f"small knob-on loss {lo}, knob-off {small_losses[0][0]}")
    check(small_on_ratio <= 1.0, f"the small model's knob-on gradients differ from its knob-off ones: err/tol {small_on_ratio}")
    del small_on, opt_on, small_init, small_grads0
    phase("train_step", params=n_params, tokens=f"{TRAIN_B}x{TRAIN_T}+{TRAIN_B}x{TRAIN_T}", vocab=VOCAB,
          launches=json.dumps(train_counts), loss=repr(loss0), lr_after=repr(opt.lr), peak_gb=f"{train_peak_gb:.2f}",
          tf32=json.dumps(tf32_seen), small_grad_err_over_tol=grad_ratio, small_losses=json.dumps(small_losses),
          small_loss_after_3_sgd=json.dumps(after), small_knob_on_loss=repr(lo), small_knob_on_grad_err_over_tol=small_on_ratio)
    del small, small_cpu, opt_g, opt_c, small_batches
    # the step's time: best of 2 after the counted one
    step_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step(s2s.seq2seq_loss, *batch)
        sched.step()
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t0)
    step_s = min(step_walls)
    phase("train_step_time", best_of_2_s=repr(step_s), walls_s=json.dumps(step_walls),
          tokens_per_s=repr(2 * TRAIN_B * TRAIN_T / step_s), peak_gb=f"{train_peak_gb:.2f}")
    train_breakdown = profile_device(lambda: opt.step(s2s.seq2seq_loss, *batch), inference=False)
    phase("train_step_profile", **{k: json.dumps(v) for k, v in train_breakdown.items()})
    del model, opt, sched, params, loss
    torch.cuda.empty_cache()

    # the training path with HEAT_TPU_FLASH_PIPELINE=1: one step of the same model from the
    # same weights and batch, every forward attention on K3
    model = s2s.Seq2Seq(vocab=VOCAB, max_len=TRAIN_T, d_model=512, nhead=8, layers=6, dim_feedforward=2048).train()

    def restore():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(before[n])

    def grad_errors(want: dict) -> dict:
        """Each gradient's max |difference| from ``want`` over 1e-3 of its largest entry, and
        its relative L2 difference."""
        return {n: (float((p.grad - want[n]).abs().max()) / (1e-3 * float(want[n].abs().max()) + 1e-30),
                    float((p.grad - want[n]).norm()) / (float(want[n].norm()) + 1e-30))
                for n, p in model.named_parameters()}

    restore()
    opt = ht.optim.DataParallelOptimizer("adam", lr=1.0)
    ht.nn.DataParallel(model, optimizer=opt)
    sched = ht.optim.lr_scheduler.LambdaLR(opt, lambda e: 512**-0.5 * min((e + 1) ** -0.5, (e + 1) * WARMUP**-1.5))
    with pipelined(True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        loss = opt.step(s2s.seq2seq_loss, *batch)
        torch.cuda.synchronize()
        train_counts_on = kernels.launch_counts()
        train_peak_on_gb = torch.cuda.max_memory_allocated() / 1e9
        sched.step()
        loss_on = float(loss)
        on_errs = grad_errors(grads_off)
        check(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()), "a knob-on gradient is not finite")
    # the same step again with the knob off, from the same weights: two knob-off steps give
    # the same bits, so what differs in the knob-on step comes from K3 alone
    restore()
    opt.step(s2s.seq2seq_loss, *batch)
    aa_errs = grad_errors(grads_off)
    del grads_off, before
    worst = sorted(on_errs, key=lambda n: on_errs[n][0], reverse=True)[:6]
    worst_l2 = max(on_errs, key=lambda n: on_errs[n][1])
    phase("train_step_pipelined_grads", loss_on=repr(loss_on), loss_off=repr(loss0),
          worst_err_over_tol=json.dumps({n: on_errs[n][0] for n in worst}),
          worst_rel_l2=json.dumps([worst_l2, on_errs[worst_l2][1]]), knob_off_again_max_diff=max(v[0] for v in aa_errs.values()))
    flash_on = ("flash_attention_fwd_pipelined", *flash[1:])
    check(all(train_counts_on[n] == FLASH_PER_FORWARD for n in flash_on) and train_counts_on["flash_attention_fwd"] == 0,
          f"launches in one knob-on training step: {train_counts_on}")
    check(max(v[0] for v in aa_errs.values()) == 0.0, "two knob-off steps from the same weights gave other gradients")
    check(abs(loss_on - loss0) <= 1e-5 * abs(loss0), f"knob-on loss {loss_on}, knob-off {loss0}")
    # At this depth and length the entrywise rule of the small model does not hold for any
    # two fp32 forwards that sum in another order: a pre-activation of linear1 within
    # rounding of 0 flips its ReLU, which moves whole entries of linear1's gradients (where
    # the worst entries lie, PERF.md), and the softmax backward's cancellations amplify the
    # rest. So the full step is held to 1e-2 of each gradient's norm; the
    # small model above holds K3 to the entrywise 1e-3.
    on_rel_l2 = on_errs[worst_l2][1]
    check(on_rel_l2 <= 1e-2, f"knob-on gradients differ from the knob-off step's: relative L2 {on_rel_l2} in {worst_l2}")
    with pipelined(True):
        step_on_walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step(s2s.seq2seq_loss, *batch)
            sched.step()
            torch.cuda.synchronize()
            step_on_walls.append(time.perf_counter() - t0)
        step_on_s = min(step_on_walls)
        train_breakdown_on = profile_device(lambda: opt.step(s2s.seq2seq_loss, *batch), inference=False)
    phase("train_step_pipelined", launches=json.dumps(train_counts_on), loss=repr(loss_on),
          grad_rel_l2_vs_knob_off=on_rel_l2, peak_gb=f"{train_peak_on_gb:.2f}", best_of_2_s=repr(step_on_s),
          walls_s=json.dumps(step_on_walls), tokens_per_s=repr(2 * TRAIN_B * TRAIN_T / step_on_s))
    phase("train_step_pipelined_profile", **{k: json.dumps(v) for k, v in train_breakdown_on.items()})
    del model, opt, sched, batch, loss
    torch.cuda.empty_cache()

    # 11. bench.py's attention A/B (bench.py:252-274): causal sdpa at b8 h16 t4096 d64 bf16,
    #     the knob off (K2) and on (K3), in turns; TFLOP/s under bench.py's count
    gen = torch.Generator(device=dev).manual_seed(SEED + 900)
    qb, kb, vb = (torch.randn(BENCH_B, BENCH_H, BENCH_T, BENCH_D, generator=gen, device=dev).to(bf16) for _ in range(3))
    bench_flops = 2 * 2 * BENCH_B * BENCH_H * BENCH_T * BENCH_T * BENCH_D / 2
    ab_runs, ab_counts = [], []
    with torch.no_grad():
        for on in (False, True, True, False):
            with pipelined(on):
                kernels.reset_launch_counts()
                ht.nn.scaled_dot_product_attention(qb, kb, vb, is_causal=True)
                ab_counts.append(kernels.launch_counts())
                ab_runs.append(cuda_ms(lambda: ht.nn.scaled_dot_product_attention(qb, kb, vb, is_causal=True), reps=10))
    check(all(c["flash_attention_fwd"] == (not on) and c["flash_attention_fwd_pipelined"] == on
              for c, on in zip(ab_counts, (False, True, True, False))), f"the A/B's launches: {ab_counts}")
    ab_k2_ms, ab_k3_ms = (ab_runs[0] + ab_runs[3]) / 2, (ab_runs[1] + ab_runs[2]) / 2
    phase("bench_attention_ab", shape=f"{BENCH_B}x{BENCH_H}x{BENCH_T}x{BENCH_D}", dtype="bfloat16", causal=True,
          runs_ms=json.dumps(ab_runs), k2_ms=repr(ab_k2_ms), k3_ms=repr(ab_k3_ms),
          k2_tflops=repr(bench_flops / ab_k2_ms / 1e9), k3_tflops=repr(bench_flops / ab_k3_ms / 1e9))
    del qb, kb, vb
    torch.cuda.empty_cache()

    # the backward's kernels one by one at each shape, each beside the backward of
    # scaled_dot_product_attention on the same inputs, timed in turns (library, kernels,
    # kernels, library); the plain version at the encoder shape
    bwd_ms, bwd_bounds, bwd_simt, bwd_library_ms = {}, {}, {}, {}
    with torch.no_grad():
        for cname, (q, k, v, causal) in bwd_data.items():
            o, lse = k2.flash_attention_fwd(q, k, v, causal)
            do = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 600), device=dev).to(q.dtype)
            dd = k2._d_pass(o, do)
            sc = 1.0 / math.sqrt(q.shape[-1])
            bh, tq, dh = q.shape

            def kernels_ms():
                return {
                    "flash_attention_bwd_d": cuda_ms(lambda: k2._d_pass(o, do), reps=10),
                    "flash_attention_bwd_dq": cuda_ms(lambda: k2._k4(q, k, v, do, lse, dd, causal, sc, None), reps=5, warmup=1),
                    "flash_attention_bwd_dkv": cuda_ms(lambda: k2._k5(q, k, v, do, lse, dd, causal, sc, None), reps=5, warmup=1),
                }

            with torch.enable_grad():
                q4, k4, v4 = (t.view(bh // 8, 8, tq, dh).clone().requires_grad_() for t in (q, k, v))
                o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
                g4 = do.view(o4.shape)

                def library_ms():
                    return cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), reps=5)

                turns = [library_ms(), kernels_ms(), kernels_ms(), library_ms()]
            del q4, k4, v4, o4, g4
            bwd_library_ms[cname] = (turns[0] + turns[3]) / 2
            bwd_ms[cname] = {n: (turns[1][n] + turns[2][n]) / 2 for n in turns[1]}
            if cname != "bench_causal_bf16":
                bwd_ms[cname]["flash_attention_fwd"] = cuda_ms(lambda: k2.flash_attention_fwd(q, k, v, causal), reps=5, warmup=1)
            bwd_bounds[cname] = bwd_bounds_ms(bh, tq, k.shape[1], dh, causal, q.element_size())
            bwd_simt[cname] = bwd_bounds_ms(bh, tq, k.shape[1], dh, causal, q.element_size(), simt=True)
            if cname == "encoder_self":
                bwd_plain_ms = cuda_ms(lambda: k2.flash_attention_bwd_reference(q, k, v, o, do, lse, False), reps=3, warmup=1)
            del o, lse, do, dd
    bwd_total = {c: sum(v[n] for n in flash[1:]) for c, v in bwd_ms.items()}
    phase("k2_bwd_time", ms=json.dumps(bwd_ms), d_k4_k5_ms=json.dumps(bwd_total), plain_ms=repr(bwd_plain_ms),
          library_ms_in_turns=json.dumps(bwd_library_ms),
          over_library=json.dumps({c: bwd_total[c] / bwd_library_ms[c] for c in bwd_total}),
          bounds_ms=json.dumps({c: {n: b[0] for n, b in v.items()} for c, v in bwd_bounds.items()}),
          bounds_simt_ms=json.dumps({c: {n: b[0] for n, b in v.items()} for c, v in bwd_simt.items()}))
    del bwd_data
    torch.cuda.empty_cache()

    # 12b. the rest of heat_tpu.nn: ring, zigzag and Ulysses attention, the module zoo
    nn_out = nn_phases(ht, kernels, smi, dev)

    # 12c. the trainer's state and data: the training step under DASO with a checkpoint and
    #      a resume, DASO's sync on virtual node replicas, and the I/O formats
    #      ([daso_sync] and [io] ran during the builds, step 2)
    resume_out = train_resume_phase(ht, kernels, s2s, dev, smi, step_s)

    # 12d. the request-dispatch runtime: the executor's fused chain against eager dispatch,
    #      heat_tpu's four serving request shapes from 1 and 16 threads, and the request
    #      lifecycle (deadlines, cancel, drain, shedding, a fault plan)
    runtime_out = runtime_phases(ht, dev, smi, serving_km)
    del serving_km
    torch.cuda.empty_cache()

    # 12e. the serving plane: a ModelPool of Transformer-base hot-swapped under 16-thread
    #      traffic, the result cache, the cold start against a warmup manifest, a peer's
    #      failure and failover, run_supervised's elastic restart of the training step, and
    #      the observability planes' cost
    serving_out = serving_phases(ht, kernels, dev, smi)

    # 12f. the launch counters under 16 request threads, and the port's invariant checker
    #      over this tree, in a child process
    counts_out = launch_counts_threaded_phase(ht, kernels, dev, smi)
    analysis_out = analysis_phase(smi)

    # 13-18. distributed linear algebra: config #2's product, config #4's hsvd_rank, the rest
    #        small; then the array API: the manipulation benchmark at N = 40M, the random
    #        streams and KMeans' random init; then the clustering slice; then the domain
    #        estimators; in a child process (linalg_phases, array_phases, cluster_phases,
    #        domain_phases)
    child_out = run_linalg_child()
    linalg_out, array_out, cluster_out = child_out["linalg"], child_out["array"], child_out["cluster"]

    # 19. every ported kernel: launches on its path, time, bound, plain version's and library's time
    x, init, _ = blobs(N, D, K, SEED, dev)
    ms = cuda_ms(lambda: k1.fused_assign_update_packed(x, init), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: k1.fused_assign_update_reference(x, init), reps=5, warmup=1)
    del x, init
    torch.cuda.empty_cache()
    nbytes = 4 * (N * D + K * D) + 4 * N + 4 * (K * D + K + 1)  # x, centers in; labels, record out
    flops = 2 * N * K * D + 3 * N * D + 4 * N * K  # dots, |x|² and sums, d² and compare
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    flops_ms = 1e3 * flops / PEAK_FP32_FLOPS
    q, k, v, _ = k2_data["encoder_self"]
    with torch.no_grad():
        k2_plain_ms = cuda_ms(lambda: k2.flash_attention_reference(q, k, v, False), reps=3, warmup=1)
        q4, k4, v4 = (t.view(BATCH, 8, t.shape[1], t.shape[2]) for t in (q, k, v))
        k2_library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4), reps=10, warmup=2)
    enc_bound, enc_bound_by = k2_bounds["encoder_self"]
    line = {
        "kernels": [
            {
                "name": "kmeans_assign",
                "route": "cuda",
                "source": "heat_tpu_torch/core/kernels/csrc/kmeans_assign.cu",
                "replaces": "heat_tpu/core/kernels/kmeans.py:44",
                "launches": counts["kmeans_assign"],
                "launches_by_path": {
                    "kmeans_fit": counts["kmeans_assign"],
                    "kmeans_pp_fit": pp["k1_launches"],
                    "kmeans_random_init": array_out["kmeans_random_init"]["k1_launches"],
                    **{f"cluster_bench_{n_}": v["k1_launches"] for n_, v in cluster_out["cluster_bench"].items()},
                    **{n_: cluster_out[n_]["k1_launches"] for n_ in ("kmedians_fit", "kmedoids_fit", "batchparallel_fit",
                                                                     "spectral_fit")},
                    "launch_counts_threaded": counts_out["launches"]["kmeans_assign"],
                },
                "launches_note": "KMedians, KMedoids and the batch-parallel solves assign by heat_tpu's generic step, "
                                 "as heat_tpu does; Spectral's embedding is float64 (heat_tpu's rbf of a NumPy "
                                 "float64 sigma), so its KMeans takes the float64 generic step",
                "max_abs_err_at_spectral_shape": checks[(4 * SPECTRAL_N, 4, 4, "float")]["max_abs_err"],
                "max_abs_err": checks[(N, D, K, "float")]["max_abs_err"],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, flops_ms),
                "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                "library_ms": None,
                "library_note": "no single PyTorch call computes labels, sums, counts and sse together",
                "max_abs_err_of": "sums against float64 sums of the same rows grouped by the kernel's labels",
                "err_over_tol": checks[(N, D, K, "float")]["sums_err_over_tol"],
                "shape": [N, D, K],
                "achieved_bytes_per_s": nbytes / (ms * 1e-3),
                "bound_share": max(bytes_ms, flops_ms) / ms,
                "launch": dict(k1.plan(D, K)._asdict(), blocks=k1.grid_blocks(N, D, K, dev)[0]),
            },
            {
                "name": "flash_attention_fwd",
                "route": "cuda",
                "source": "heat_tpu_torch/core/kernels/csrc/flash_attention_fwd.cu",
                "replaces": "heat_tpu/core/kernels/flash_attention.py:156",
                "launches": t_counts["flash_attention_fwd"],
                "max_abs_err": k2_checks["encoder_self"]["max_abs_err_o"],
                "ms": k2_ms["encoder_self"],
                "plain_ms": k2_plain_ms,
                "bound_ms": enc_bound,
                "bound_by": enc_bound_by,
                "bound_simt_ms": k2_bound_ms(e_heads, SRC_T, SRC_T, 64, False, 4, simt=True)[0],
                "library_ms": k2_library_ms,
                "library_note": "torch.nn.functional.scaled_dot_product_attention on the same f32 inputs, timed only",
                "max_abs_err_of": "O against the plain version, encoder shape",
                "err_over_tol": k2_checks["encoder_self"]["err_over_tol"],
                "shape": [e_heads, SRC_T, SRC_T, 64],
                "dtype": "float32",
                "launches_of": "one Transformer-base forward",
                "launches_by_path": {
                    "transformer_forward": t_counts["flash_attention_fwd"],
                    "training_step": train_counts["flash_attention_fwd"],
                    "daso_step_and_resumed_step": resume_out["launches"]["flash_attention_fwd"],
                    **{f"ring_forward_{c_}": r_["launches"] for c_, r_ in nn_out["ring"].items()},
                    "ulysses_world_1": nn_out["ulysses"]["launches"],
                    "mha_sequence_split_world_1": nn_out["ulysses"]["mha_launches"]["flash_attention_fwd"],
                    "serving_swap_per_request": serving_out["swap"]["k2_per_request"],
                    "supervised_train_per_step": serving_out["supervised_train"]["launches"][-1]["flash_attention_fwd"],
                    "launch_counts_threaded": counts_out["launches"]["flash_attention_fwd"],
                },
                "ms_by_shape": k2_ms,
                "bound_ms_by_shape": {c: b[0] for c, b in k2_bounds.items()},
                "achieved_flops_per_s": 4 * e_heads * 64 * attention_pairs(SRC_T, SRC_T, False) / (k2_ms["encoder_self"] * 1e-3),
                "ms_at_training_shapes": {c: bwd_ms[c]["flash_attention_fwd"] for c in ("encoder_self", "decoder_self_causal")},
                "ms_by_shape_in_turns": k3_k2_ms,
                "library_ms_by_shape": fwd_library_ms,
                "bound_ms_by_shape_in_turns": {c: b[0] for c, b in k3_bounds.items()},
            },
            *(
                {
                    "name": kname,
                    "route": "cuda",
                    "source": "heat_tpu_torch/core/kernels/csrc/flash_attention_bwd.cu",
                    "replaces": replaces,
                    "launches": train_counts[kname],
                    "max_abs_err": bwd_checks["encoder_self"][err_key],
                    "ms": bwd_ms["encoder_self"][kname],
                    "plain_ms": bwd_plain_ms,
                    "bound_ms": bwd_bounds["encoder_self"][kname][0],
                    "bound_by": bwd_bounds["encoder_self"][kname][1],
                    "bound_simt_ms": bwd_simt["encoder_self"][kname][0],
                    "library_ms": bwd_library_ms["encoder_self"],
                    "library_note": "backward of torch.nn.functional.scaled_dot_product_attention on the same "
                                    "inputs (dQ, dK and dV together), timed only, in turns with the kernels; set "
                                    "against D + K4 + K5",
                    "library_ms_by_shape": bwd_library_ms,
                    "plain_note": "flash_attention_bwd_reference, all three gradients together",
                    "max_abs_err_of": err_of,
                    "err_over_tol": bwd_checks["encoder_self"]["err_over_tol"],
                    "shape": [t_heads, TRAIN_T, TRAIN_T, 64],
                    "dtype": "float32",
                    "launches_of": "one Transformer-base training step",
                    "launches_by_path": {
                        "training_step": train_counts[kname],
                        "daso_step_and_resumed_step": resume_out["launches"][kname],
                        **{f"ring_backward_{c_}": r_["launches"][kname] for c_, r_ in nn_out["ring_bwd"].items()},
                        "mha_sequence_split_world_1": nn_out["ulysses"]["mha_launches"][kname],
                        "supervised_train_per_step": serving_out["supervised_train"]["launches"][-1][kname],
                    },
                    "ms_by_shape": {c: v[kname] for c, v in bwd_ms.items()},
                    "bound_ms_by_shape": {c: v[kname][0] for c, v in bwd_bounds.items()},
                    "bound_simt_ms_by_shape": {c: v[kname][0] for c, v in bwd_simt.items()},
                    "backward_total_ms": bwd_total["encoder_self"],
                    "backward_total_ms_by_shape": bwd_total,
                }
                for kname, replaces, err_key, err_of in (
                    ("flash_attention_bwd_d", "heat_tpu/core/kernels/flash_attention.py:592",
                     "max_abs_err_dq", "dQ against the plain backward (D feeds K4 and K5), encoder shape"),
                    ("flash_attention_bwd_dq", "heat_tpu/core/kernels/flash_attention.py:422",
                     "max_abs_err_dq", "dQ against the plain backward, encoder shape"),
                    ("flash_attention_bwd_dkv", "heat_tpu/core/kernels/flash_attention.py:480",
                     "max_abs_err_dk", "dK against the plain backward, encoder shape"),
                )
            ),
            {
                "name": "flash_attention_fwd_pipelined",
                "route": "cuda",
                "source": "heat_tpu_torch/core/kernels/csrc/flash_attention_fwd_pipelined.cu",
                "replaces": "heat_tpu/core/kernels/flash_attention.py:238",
                "launches": t_counts_on["flash_attention_fwd_pipelined"],
                "max_abs_err": k3_checks["encoder_self"]["max_abs_err_o"],
                "ms": k3_ms["encoder_self"],
                "plain_ms": k3_plain_ms,
                "bound_ms": k3_bounds["encoder_self"][0],
                "bound_by": k3_bounds["encoder_self"][1],
                "bound_simt_ms": k2_bound_ms(e_heads, SRC_T, SRC_T, 64, False, 4, simt=True)[0],
                "library_ms": fwd_library_ms["encoder_self"],
                "library_note": "torch.nn.functional.scaled_dot_product_attention on the same inputs, timed only, in "
                                "turns with K2 and K3",
                "max_abs_err_of": "O against flash_attention_pipelined_reference, encoder shape",
                "err_over_tol": k3_checks["encoder_self"]["err_over_tol"],
                "shape": [e_heads, SRC_T, SRC_T, 64],
                "dtype": "float32",
                "launches_of": "one Transformer-base forward with HEAT_TPU_FLASH_PIPELINE=1",
                "launches_in_training_step": train_counts_on["flash_attention_fwd_pipelined"],
                "launches_by_path": {
                    "transformer_forward": t_counts_on["flash_attention_fwd_pipelined"],
                    "training_step": train_counts_on["flash_attention_fwd_pipelined"],
                    "ring_forward_bench_causal_f32": nn_out["ring"]["bench_causal_f32"]["k3_launches"],
                },
                "ms_by_shape": k3_ms,
                "k2_ms_by_shape": k3_k2_ms,
                "library_ms_by_shape": fwd_library_ms,
                "bound_ms_by_shape": {c: b[0] for c, b in k3_bounds.items()},
                "achieved_flops_per_s": 4 * e_heads * 64 * attention_pairs(SRC_T, SRC_T, False) / (k3_ms["encoder_self"] * 1e-3),
            },
        ]
    }
    print(json.dumps(line), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"nvidia_smi": smi, "builds": build_info, **line, "fit_best_of_2_s": fit_s, "fit_walls_s": walls,
                       "fit_profile": fit_profile,
                       "inertia": inertia, "checks": {"x".join(map(str, key)): v for key, v in checks.items()},
                       "k2_checks": k2_checks, "forward_best_of_2_s": fwd_s, "forward_walls_s": fwd_walls,
                       "k2_in_forward_ms": attn_ms, "forward_peak_gb": peak_gb,
                       "forward_profile": breakdown, "bwd_checks": bwd_checks, "train_step_loss": loss0,
                       "train_step_launches": train_counts, "train_step_best_of_2_s": step_s,
                       "train_step_walls_s": step_walls, "train_step_peak_gb": train_peak_gb,
                       "train_step_profile": train_breakdown, "small_train_grad_err_over_tol": grad_ratio,
                       "small_train_losses": small_losses, "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms, "bwd_total_ms": bwd_total,
                       "bwd_library_ms": bwd_library_ms, "k3_checks": k3_checks,
                       "forward_pipelined_launches": t_counts_on, "forward_pipelined_best_of_2_s": fwd_on_s,
                       "forward_pipelined_walls_s": fwd_on_walls, "forward_pipelined_profile": breakdown_on,
                       "train_step_pipelined_launches": train_counts_on, "train_step_pipelined_loss": loss_on,
                       "train_step_pipelined_best_of_2_s": step_on_s, "train_step_pipelined_walls_s": step_on_walls,
                       "train_step_pipelined_peak_gb": train_peak_on_gb,
                       "train_step_pipelined_profile": train_breakdown_on, "bench_ab_runs_ms": ab_runs,
                       "bench_ab_k2_ms": ab_k2_ms, "bench_ab_k3_ms": ab_k3_ms, "linalg": linalg_out,
                       "array": array_out, "kmeans_pp": pp, "cluster": cluster_out,
                       "domain": child_out["domain"], "nn": nn_out,
                       "train_resume": resume_out, "daso_sync": sync_out, "io": io_out,
                       "runtime": runtime_out, "serving": serving_out, "launch_counts_threaded": counts_out,
                       "analysis": analysis_out}, fh, indent=1, default=str)

    # 20. the last line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
