"""BENCHMARK.json and every file of a configuration, a cell, a traffic and
a per-layer metric: the contract's keys, names and units in the allowed
characters, and every name found by its file."""

import ast
import json
import math
import re

import pytest

from hv_bench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
HV = REPO / "hv_bench"


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hv_bench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to compile,
    # 1200 s spare, with the full 24 cells, within 43200 s
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
    assert c["file"].startswith("hv_bench/") and (REPO / c["file"]).is_file()
    body = json.loads((REPO / c["file"]).read_text())
    assert body["name"] == c["name"] and body["reduced"] == c["reduced"] == []
    assert body["compute_dtype"] in ("bfloat16", "float32")
    assert set(body["work"]) >= {"slice_fwd_flops", "example_flops", "example_conv_flops"}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_entries(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
    assert w["chips"] == 1
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((HV / "traffic" / f"{w['traffic']}.json").read_text())
    assert (HV / "drivers" / f"{traffic['driver']}.py").is_file()
    spec = json.loads((HV / "workloads" / f"{w['name']}.json").read_text())
    assert spec["limits"] and all(isinstance(v, (int, float)) and math.isfinite(v)
                                  for v in spec["limits"].values())
    reports = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
    assert layer


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entries(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_entries(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and line(m["layer"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and m["moves"] != "setup_s"
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    src = (HV / "metrics" / f"{m['name']}.py").read_text()
    funcs = {n.name for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)}
    assert "read" in funcs
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"device", "3D driver", "training driver", "model step", "convs",
                      "attention kernels"}


def test_files_under_paths_named_from_names():
    for p in HV.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(REPO))), p


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_readers_find_nothing_in_nothing(name):
    from hv_bench.run import load_metric

    assert load_metric(REPO, name).read({}) is None
