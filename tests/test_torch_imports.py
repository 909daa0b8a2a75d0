"""Import contract of the PyTorch port: heat_tpu_torch (its invariant checker
heat_tpu_torch.analysis included), chip_smoke.py, the example it drives and the scripts
in tools/ import neither JAX nor anything of heat_tpu, and importing the package loads
neither, nor the checker."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "heat_tpu_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "heat_tpu")


def _forbidden(module: str) -> bool:
    """``jax``, ``jax.numpy``, ``heat_tpu``, ``heat_tpu.core`` — but not ``heat_tpu_torch``."""
    return module.split(".")[0] in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_scan_sees_the_package():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert "heat_tpu_torch/__init__.py" in names
    for module in (
        "core/kernels/kmeans.py",
        "core/kernels/flash_attention.py",
        "nn/__init__.py",
        "nn/modules.py",
        "nn/attention.py",
        "nn/data_parallel.py",
        "optim/__init__.py",
        "optim/dp_optimizer.py",
        "optim/lr_scheduler.py",
        "optim/utils.py",
        "interop.py",
        "testing.py",
        "core/tiling.py",
        "core/linalg/__init__.py",
        "core/linalg/basics.py",
        "core/linalg/comm_plan.py",
        "core/linalg/qr.py",
        "core/linalg/svd.py",
        "core/linalg/svdtools.py",
        "core/linalg/solver.py",
        "analysis/__init__.py",
        "analysis/__main__.py",
        "analysis/engine.py",
        "analysis/dataflow.py",
        "analysis/rules.py",
        "analysis/rules_locks.py",
    ):
        assert f"heat_tpu_torch/{module}" in names, module
    assert not _forbidden("heat_tpu_torch") and not _forbidden("heat_tpu_torch.core")
    assert _forbidden("heat_tpu") and _forbidden("heat_tpu.core.dndarray") and _forbidden("jax.numpy")


@pytest.mark.parametrize(
    "path",
    PORT_FILES
    + [REPO / "chip_smoke.py", REPO / "examples" / "nn" / "seq2seq_transformer_torch.py"]
    + sorted((REPO / "tools").glob("*.py")),
    ids=lambda p: p.relative_to(REPO).as_posix(),
)
def test_no_jax_or_heat_tpu_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_loads_neither_jax_nor_heat_tpu():
    code = (
        "import sys, heat_tpu_torch\n"
        "mods = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'heat_tpu'))\n"
        "print(repr(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_import_does_not_load_the_checker():
    """The invariant checker runs as a process of its own: importing the package loads
    none of heat_tpu_torch.analysis, so it adds nothing at run time."""
    code = (
        "import sys, heat_tpu_torch\n"
        "print(repr(sorted(m for m in sys.modules if m.startswith('heat_tpu_torch.analysis'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len([p for p in PORT_FILES if p.parent.name == "analysis"]) == 17


def test_package_data_ships_the_kernel_sources():
    """An installed heat_tpu_torch builds its kernels from the CUDA sources, so the
    packaging must ship every one of them (pyproject.toml's package-data)."""
    import fnmatch
    import tomllib

    from heat_tpu_torch.core import kernels

    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    assert any(fnmatch.fnmatch("heat_tpu_torch.core.kernels", pat) for pat in cfg["packages"]["find"]["include"])
    kdir = REPO / "heat_tpu_torch" / "core" / "kernels"
    shipped = {p for pattern in cfg["package-data"]["heat_tpu_torch.core.kernels"] for p in kdir.glob(pattern)}
    sources = set(kdir.rglob("*.cu")) | set(kdir.rglob("*.cuh"))
    assert sources and sources <= shipped
    assert kdir / "csrc" / "flash_attention_fwd_pipelined.cu" in sources
    assert kdir / "csrc" / "mma_tf32x3.cuh" in sources  # included by flash_tiles.cuh
    assert kdir / "csrc" / "flash_tiles.cuh" in sources  # included by the forwards and the backward
    assert {mod.SOURCE for mod in kernels.KERNELS.values()} <= shipped


def test_editing_a_header_changes_the_library_path(tmp_path):
    """A built library is keyed by its source and every header beside it, so an edited
    header builds anew instead of loading a stale library (no nvcc is needed for the key)."""
    from heat_tpu_torch.core.kernels import _nvcc

    csrc = REPO / "heat_tpu_torch" / "core" / "kernels" / "csrc"
    source = tmp_path / "flash_attention_bwd.cu"
    header = tmp_path / "mma_tf32x3.cuh"
    source.write_bytes((csrc / source.name).read_bytes())
    header.write_bytes((csrc / header.name).read_bytes())
    first = _nvcc._library_path(source)
    assert first == _nvcc._library_path(source) and first.parent == _nvcc.BUILD_DIR
    header.write_text(header.read_text() + "\n// edited\n")
    second = _nvcc._library_path(source)
    assert second != first and second.name.startswith("libflash_attention_bwd-")
    (tmp_path / "another.cuh").write_text("#pragma once\n")
    assert _nvcc._library_path(source) not in (first, second)
