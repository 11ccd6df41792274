"""BENCHMARK.json against the files it names and the contract's limits:
every cell, configuration and per-layer metric it lists is a file of
portbench/, and every such file is listed."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_command_and_paths(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) < 64 * 1024


def test_configs_are_their_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert c["reduced"] == f["reduced"]
        assert all(k in f and not k.endswith(("_dim", "_rank"))
                   for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200


def test_cells_are_their_files(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert sorted(names) == harness.workloads()
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    for w in bench["workloads"]:
        f = harness.workload(w["name"])
        assert NAME.match(w["name"]) and w["chips"] == f["chips"] == 1
        assert (w["config"], w["traffic"], w["why"]) == (
            f["config"], f["traffic"], f["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.py").exists()
        assert 1 <= len(w["why"]) <= 200
        assert set(f["limits"]) == {"logit_gap", "cdf_miss", "audio_err",
                                    "code_errors"}


def test_metrics_are_their_readers(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == set(harness.E2E_UNITS)
    for name, m in e2e.items():
        assert m["unit"] == harness.E2E_UNITS[name]
        assert m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    readers = harness.metric_modules()
    assert sorted(m["name"] for m in bench["per_layer"]) == sorted(readers)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        mod = readers[m["name"]]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER,
                                mod.MOVES)
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
