"""Nothing a run or a reference loads is JAX, its libraries or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the references load
nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lib import harness

ROOT = Path(__file__).resolve().parent.parent.parent
HERE = ROOT / "portbench"


@pytest.mark.parametrize("cell", ["kmeans-lloyd", "s2s-train-4096"])
def test_a_run_loads_no_jax(cell):
    proc = subprocess.run([sys.executable, str(HERE / "tests" / "_tiny.py"), cell], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line, modules = (json.loads(s) for s in proc.stdout.strip().splitlines()[-2:])
    assert line["correct"] is True
    assert "heat_tpu_torch" in modules
    assert not set(modules) & set(harness.FORBIDDEN), sorted(set(modules) & set(harness.FORBIDDEN))


def test_the_references_load_nothing_of_the_port():
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.lib import inputs, spec\n"
        "for p in sorted((spec.HERE / 'reference').glob('*.py')):\n"
        "    spec.load_module(p)\n"
        "km = spec.load_module(spec.HERE / 'reference' / 'kmeans-higgs-k8.py')\n"
        "cfg = {'n_samples': 500, 'n_features': 4, 'n_clusters': 3, 'max_iter': 3, 'tol': -1.0,\n"
        "       'center_spread': 0.35, 'noise': 1.0}\n"
        "x, init = inputs.blobs(cfg, 3, 'cpu')\n"
        "km.fit(x, init, cfg)\n"
        "s2s = spec.load_module(spec.HERE / 'reference' / 'transformer-base-s2s.py')\n"
        "cfg = dict(spec.read_json(spec.HERE / 'configs' / 'transformer-base-s2s.json'), d_model=16, nhead=2,\n"
        "           num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=32, vocab_size=20)\n"
        "tr = {'task': 'reverse', 'batch': 2, 'src_len': 6, 'tgt_len': 6, 'pool': 2}\n"
        "s2s.train(inputs.seq2seq_weights(cfg, 3, 'cpu'), cfg, inputs.token_batches(cfg, tr, 3, 'cpu'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    modules = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not modules & {"heat_tpu_torch", *harness.FORBIDDEN}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        found = _imports(path)
        assert not found & set(harness.FORBIDDEN), (path, found)
        if path.parent.name in ("reference", "metrics") or path.parent == HERE / "lib":
            assert "heat_tpu_torch" not in found, path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    for name in ("heat_tpu_torch", "heat_tpu_torch.core", "jaxtyping", "portbench.lib"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "heat_tpu.core", sys)
    assert harness.forbidden_modules() == ["heat_tpu", "jax"]
