"""The result line's shape, the command's refusals, and BENCHMARK.json against the rules of
its contract."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from _tiny import run_tiny
from portbench.lib import spec

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _units(kind):
    return {m["name"]: m["unit"] for m in BENCH[kind]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_untraced_line(cell):
    line = run_tiny(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = {m["name"] for m in spec.cell(cell).end_to_end}
    assert set(line["metrics"]) == want and "setup_s" in want
    units = _units("end_to_end")
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and math.isfinite(m["value"]) and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_line(cell):
    line = run_tiny(cell, trace=True)
    assert list(line)[-1] == "compared" and line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    # no device here: the per-layer readers find nothing on the card and stay silent
    assert line["metrics"] == {}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def _command(cwd, extra_env=None):
    env = {**os.environ, **(extra_env or {})}
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "kmeans-lloyd", "--seed",
                           str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    proc = _command(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_command_fails_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43_200
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert (ROOT / "portbench" / "reference" / f"{c['name']}.py").is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for name in names:
        assert callable(spec.reader(name).read)
    for cell in cells:
        c = spec.cell(cell)
        assert "setup_s" in {m["name"] for m in c.end_to_end} and len(c.end_to_end) >= 2 and c.per_layer
