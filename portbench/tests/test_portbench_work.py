"""The yardstick's arithmetic against values worked out by hand, and the readers and the
trace reduction on runs and events made up for the test."""

from types import SimpleNamespace

import pytest

from portbench.lib import spec, trace, work
from portbench.lib.harness import Run

BASE = {"d_model": 512, "nhead": 8, "num_encoder_layers": 6, "num_decoder_layers": 6, "dim_feedforward": 2048,
        "vocab_size": 37000}
STEP = {"batch": 6, "src_len": 4096, "tgt_len": 4096}


def test_attention_flops_by_hand():
    # 2 flops x 7 products x 1·1·4·4·2
    assert work.attention_flops(1, 1, 4, 4, 2, causal=False) == 448
    assert work.attention_flops(1, 1, 4, 4, 2, causal=True) == 224
    assert work.attention_flops(1, 1, 4, 4, 2, causal=False, backward=False) == 128
    assert work.attention_flops(2, 3, 5, 7, 11, causal=False) == 2 * 7 * 2 * 3 * 5 * 7 * 11


def test_transformer_base_counts_by_hand():
    # encoder layer: 4·512² + 2·512·2048 = 1,048,576 + 2,097,152; the decoder's cross k, v 2·512²
    source, target = work.seq2seq_dense_params(BASE)
    assert source == 6 * 3_145_728 + 6 * 524_288 == 22_020_096
    # decoder layer: self 4·512², cross q and out 2·512², ffn 2·512·2048; head 512·37,000
    assert target == 6 * (1_048_576 + 524_288 + 2_097_152) + 18_944_000 == 40_964_096
    # one product at B·H = 48, 4096²·64: 2·48·4096·4096·64 = 103,079,215,104 flops
    product = 103_079_215_104
    assert work.seq2seq_attention_flops(BASE, STEP) == 7 * product * (6 + 6 + 3)
    # 6 flops a parameter a token: 6 · 6 · 4096 · (22,020,096 + 40,964,096), plus 15 attentions'
    # worth of products (6 encoder, 6 cross, 6 causal at half)
    assert work.seq2seq_step_flops(BASE, STEP) == 9_287_397_015_552 + 10_823_317_585_920 == 20_110_714_601_472
    assert work.seq2seq_step_tokens(STEP) == 49_152
    # D: O and dO read (2·64 floats) and D written (1) a row, 48·4096 rows an attention, 18 of them
    assert work.seq2seq_d_bytes(BASE, STEP) == 18 * 48 * 4096 * 129 * 4


def test_lloyd_bytes_by_hand():
    cfg = {"n_samples": 11_000_000, "n_features": 28}
    # 31 passes over 1.232 GB and 88 MB of int64 labels
    assert work.lloyd_fit_bytes(cfg, 30) == 31 * 1_232_000_000 + 88_000_000 == 38_280_000_000


def _run(**kw):
    base = dict(config={"n_samples": 1000, "n_features": 4}, traffic=STEP, setup_s=12.5, work={})
    base.update(kw)
    return Run(**base)


def test_end_to_end_readers():
    walls = [0.01 * (i + 1) for i in range(40)]  # 0.01 ... 0.40
    r = _run(window_s=8.2, iterations=40, walls=walls)
    assert spec.reader("setup_s").read(r) == 12.5
    assert spec.reader("fit_s").read(r) == pytest.approx(8.2 / 40)
    # nearest rank: the 38th of 40 (ceil(0.95·40) = 38)
    assert spec.reader("fit_p95_s").read(r) == pytest.approx(0.38)
    r = _run(window_s=10.0, iterations=20, work={"tokens": 49_152, "model_flops": 2e13})
    assert spec.reader("train_tokens_per_s").read(r) == pytest.approx(98_304)
    assert spec.reader("train_mfu").read(r) == pytest.approx(100 * 2e13 * 2 / 495e12)


def _trace(device, window_s=1.0, busy_s=None, iterations=2):
    busy = sum((e - s) for _, s, e in device) / 1e6 if busy_s is None else busy_s
    return trace.Trace(iterations=iterations, window_s=window_s, busy_s=busy, device=device)


def test_per_layer_readers():
    dev = [("flash_attention_fwd_kernel<...>", 0, 100_000), ("Memset (Device)", 100_000, 100_500),
           ("sgemm_128x64", 100_500, 400_500), ("flash_attention_bwd_dkv_kernel", 400_500, 500_500)]
    t = _trace(dev, window_s=0.55, iterations=2)
    r = _run(trace=t, work={"attention_flops": 1.65e12, "d_bytes": 3.35e9, "model_flops": 4.95e12, "n_iter": 3})
    # one reader each for the metric's cells: .fit and .train read alike
    for cell in ("fit", "train"):
        assert spec.reader(f"device_idle.{cell}").read(r) == pytest.approx(100 * (1 - 0.5005 / 0.55))
        assert spec.reader(f"launches.{cell}").read(r) == 1.5  # three kernels, the fill left out, two steps
    # least time a step: 1.65e12 / 165e12 + 3.35e9 / 3.35e12 = 0.011 s; flash kernels 0.2 s for two steps
    assert spec.reader("flash_roofline").read(r) == pytest.approx(100 * 0.011 * 2 / 0.2)
    # a fit of 1000 x 4 with 3 updates: 4·16,000 + 8,000 bytes
    least = (4 * 16_000 + 8_000) / 3.35e12
    assert spec.reader("lloyd_roofline").read(r) == pytest.approx(100 * least * 2 / 0.5005)


def test_readers_are_silent_without_device_events():
    r = _run(trace=_trace([], window_s=0.3, busy_s=0.0), work={"attention_flops": 1.0, "d_bytes": 1.0,
                                                                 "model_flops": 1.0, "n_iter": 1})
    for name in ("device_idle.fit", "launches.train", "lloyd_roofline", "flash_roofline"):
        assert spec.reader(name).read(r) is None
    assert spec.reader("fit_s").read(r) is None  # a traced run reports no end-to-end metric


class _Ev(SimpleNamespace):
    pass


def _ev(name, start, end, device=False, thread=1, parent=None):
    from torch.autograd import DeviceType

    return _Ev(name=name, time_range=SimpleNamespace(start=start, end=end), thread=thread, cpu_parent=parent,
               device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_trace_reduction_takes_the_union_and_names_the_gaps():
    window = _ev("window", 0, 100)
    step = _ev("trainer.step", 6, 95, parent=window)
    item = _ev("aten::item", 60, 80, parent=step)
    events = [window, step, item, _ev("aten::mm", 10, 20, parent=step),
              _ev("k1", 10, 30, device=True), _ev("k2", 20, 40, device=True),  # overlap: busy 10..40
              _ev("k3", 80, 90, device=True), _ev("k4", 95, 120, device=True)]  # clipped at 100
    t = trace.reduce(events, 1, {"trainer.step", "window"})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)  # 10..40, 80..90, 95..100
    assert t.launches == 4
    # gaps: 0..10 (window, python), 40..80 (step, aten::item at 60), 90..95 (step, python)
    assert t.gaps == {"window > python": (pytest.approx(10e-6), 1),
                      "trainer.step > aten::item": (pytest.approx(40e-6), 1),
                      "trainer.step > python": (pytest.approx(5e-6), 1)}
    b = t.breakdown()
    assert {name for name, _ in b["device_ops"][:2]} == {"k1", "k2"}
    assert [s for _, s in b["device_ops"]] == pytest.approx([20e-6, 20e-6, 10e-6, 5e-6])
    assert b["idle_gaps"][0] == ["trainer.step > aten::item (x1)", pytest.approx(40e-6)]
