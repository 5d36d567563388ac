"""`BENCHMARK.json` against the rules a benchmark manifest keeps, and every
name in it found as a file: each configuration, traffic mix, cell's limits
and metric reader."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"] and len(MANIFEST["command"]) <= 32
    assert all(one_line(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
        assert c["reduced"] == []
    assert {c["name"] for c in MANIFEST["configs"]} == {w["config"] for w in MANIFEST["workloads"]}


def test_workloads():
    names = [w["name"] for w in MANIFEST["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        assert (run.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (run.BENCH / "cells" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    workloads = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (run.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= workloads
        if kind == "end_to_end":
            assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
            assert m["moves"] in e2e and one_line(m["layer"])
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        cell = run.load_cell(w["name"])
        e2e = {n for n, _u in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]


def test_limits_name_what_the_method_compares():
    for w in MANIFEST["workloads"]:
        cell = run.load_cell(w["name"])
        limits = cell["limits"]
        assert all(isinstance(v, float) and v > 0 for v in limits.values())
        expected = {"tritd_admm": {"o", "e"}, "tt_trpca": {"z", "s"}}
        assert set(limits) == expected[cell["traffic"]["method"]]
