"""``BENCHMARK.json`` against the files the harness finds by name, and the
entry's refusals: no card, or no program beside the benchmark, gives a
non-zero exit and no result line."""

import importlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import BENCH_DIR, ROOT, banned_modules
from benchmark.tests.tiny import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_finds_its_files():
    b = bench()
    assert b["command"] == ["python3", "-m", "benchmark.run"] and b["paths"] == ["benchmark"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert callable(importlib.import_module(f"benchmark.reference.{cfg['reference']}").param_shapes)
        assert callable(importlib.import_module(f"benchmark.yardstick.{cfg['work_model']}").roundtrip_work)
    used = set()
    for w in b["workloads"]:
        cell = json.loads((BENCH_DIR / "workloads" / f"{w['name']}.json").read_text())
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert cell["config"] == w["config"] in configs and cell["traffic"] == w["traffic"]
        assert (BENCH_DIR / "traffic" / "mixes" / f"{w['traffic']}.json").is_file()
        drv = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
        assert all(callable(f) for f in (drv.run, drv.program, drv.work, drv.Control)) and drv.FAULTS
        used.add(w["config"])
    assert used == set(configs)
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        reader = importlib.import_module(f"benchmark.metrics.{m['name'].split('.')[0]}")
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for w in cells:
        e2e = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_a_banned_module_is_found_by_its_whole_name(monkeypatch):
    assert banned_modules() == []
    monkeypatch.setitem(sys.modules, "selfc_tpu_torch_like", sys)
    assert banned_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert banned_modules() == ["flax"]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "gmm4x.serve.gop",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_no_card_no_result(card_absent):
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal without one is for a machine without a card")
