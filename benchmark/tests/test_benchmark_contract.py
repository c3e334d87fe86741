"""BENCHMARK.json against the benchmark's contract: names and units from
the allowed characters, every cell's files found by name, no JAX in a
run's process, and no result without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in b["configs"]}) == len(b["configs"])
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for text in ([c["source"] for c in b["configs"]]
                 + [x["why"] for x in b["configs"] + b["workloads"]]
                 + [m["layer"] for m in b["per_layer"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_metrics_shape():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for w in cells:
        reports = [m for m in b["end_to_end"] if w in m.get("workloads",
                                                           [w])]
        assert len(reports) >= 2
        assert any(w in m.get("workloads", [w]) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_resolve(cell):
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    conf = next(c for c in b["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"benchmark/configs/{w['config']}.json"
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == conf["reduced"]
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    assert os.path.exists(os.path.join(BENCH, "drivers",
                                       mix["driver"] + ".py"))
    with open(os.path.join(BENCH, "limits", cell + ".json")) as f:
        assert json.load(f)
    for m in b["per_layer"]:
        if cell in m["workloads"]:
            assert os.path.exists(os.path.join(BENCH, "metrics",
                                               m["name"] + ".py"))


def test_paths_hold_only_the_benchmark():
    b = bench()
    assert b["paths"] == ["benchmark"]
    assert b["command"][1] == "benchmark/run.py"
    assert not any(w.startswith("/") or ".." in w for w in b["command"])


def test_forbidden_compares_whole_names(monkeypatch):
    import run
    import types
    monkeypatch.setitem(sys.modules, "smoe_tpu_torch_fake", types.ModuleType(
        "smoe_tpu_torch_fake"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "smoe_tpu.fit", types.ModuleType(
        "smoe_tpu.fit"))
    assert run.forbidden_modules() == ["smoe_tpu"]


def test_run_loads_no_jax(small):
    """A whole small run in a fresh process: every module the benchmark
    and the port load, and not one of JAX or the JAX package."""
    code = (
        "import sys, json; sys.path.insert(0, 'benchmark');"
        "import torch; torch.set_num_threads(2); import run;"
        f"out = run.run_cell('still4k.decode', 5, 0.5, True, device='cpu',"
        f" overrides={small['still4k.decode']!r});"
        "import glob, importlib.util, os;"
        "[run.load_module(p, 'm_' + os.path.basename(p)[:-3].replace('.', '_'))"
        " for p in glob.glob('benchmark/metrics/*.py')];"
        "print(json.dumps(run.forbidden_modules()))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_refuses_without_a_card():
    """No card here: exit non-zero, no result line, no CPU fallback."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "still512.fit",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "CUDA card" in proc.stderr
