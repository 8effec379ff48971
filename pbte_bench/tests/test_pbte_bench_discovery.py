"""Discovery by name, and BENCHMARK.json against the benchmark's contract."""

import importlib.util
import json
import re

import pytest

from pbte_bench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pbte_bench"]
    assert BENCH["command"][1] == "pbte_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.REPO / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for n in names:
        assert NAME.match(n), n
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = harness.find_cell(BENCH, cell)
    config = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    cell_file = harness.load_json("workloads", cell)
    assert config["name"] == w["config"]
    mode = harness.load_mode(traffic["mode"])
    for fn in ("setup", "window", "traced", "release", "check"):
        assert callable(getattr(mode, fn))
    assert callable(harness.load_cost(config["sweep"]["cost"]).work)
    assert cell_file["limits"]
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, w, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, w, True)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    path = harness.ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        cells = moved.get("workloads", [w["name"] for w in BENCH["workloads"]])
        assert set(m["workloads"]) <= set(cells), m["name"]


def test_configs_name_their_cuts():
    for c in BENCH["configs"]:
        f = json.loads((harness.REPO / c["file"]).read_text())
        assert f["reduced"] == c["reduced"]
        assert set(f["walls"]) == {"1", "2", "3", "4", "5", "6"}


@pytest.mark.parametrize("traffic,seed", [("steps.f32", 7),
                                          ("solve.f64", 2**31 + 5)])
def test_walls_from_the_seed(traffic, seed):
    config = harness.load_json("configs", "flagship_hex16_p2")
    t = harness.load_json("traffic", traffic)
    a = harness.draw_walls(config, t, seed)
    assert a == harness.draw_walls(config, t, seed)
    assert a != harness.draw_walls(config, t, seed + 1)
    spread = t["walls"]["spread"]
    for attr, base in config["walls"].items():
        assert abs(a[int(attr)] - base) <= spread
