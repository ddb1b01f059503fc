"""BENCHMARK.json against the benchmark's contract, and every cell found by name."""

import json
import re

import harness
import pytest

BENCH = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmarks/")


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    found = harness.find_cell(cell, BENCH)
    assert found["driver"].is_file() and found["limits"]
    assert found["config"]["name"] == found["cell"]["config"]
    driver = harness.load_module(found["driver"], "bench_driver_" + found["traffic"]["driver"])
    assert callable(driver.run)
    e2e = {m["name"] for m in harness.cell_metrics(cell, "end_to_end", BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(cell, "per_layer", BENCH)
    assert layer
    for m in layer:
        reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py", "reader")
        assert reader.read({"kind": "none"}, found["config"]) is None  # finds nothing to read: no number


def test_one_config_per_file_and_pairs_once():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]


def test_a_config_of_another_model_resolves(tmp_path):
    """The harness checks no model's widths; the Zero-TIG drivers do."""
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"name": "other", "enhancer_channels": 32}))
    cell = BENCH["workloads"][0]
    bench = dict(BENCH, configs=[{"name": "other", "file": str(other)}], workloads=[dict(cell, config="other")])
    found = harness.find_cell(cell["name"], bench)
    assert found["config"]["enhancer_channels"] == 32
    from reference import check_widths
    with pytest.raises(ValueError, match="enhancer_channels"):
        check_widths(found["config"])
    check_widths(harness.find_cell(cell["name"], BENCH)["config"])
