"""The benchmark's files: BENCHMARK.json keeps the contract's form, and every
configuration, traffic mix, entry, metric, reference and limits file is
found by its name."""

import json
import math
import re

import pytest

import harness
from smallcells import CELLS, ROOT, levels_of

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_workloads_hold_the_three_cells():
    names = [w["name"] for w in BENCH["workloads"]]
    assert [n for n in names if n in CELLS] == list(CELLS)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"


def test_bounds():
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bounds["setup_s"] == 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert {m["source"] for m in BENCH["end_to_end"]} <= {"host_clock",
                                                        "device_trace"}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = harness.load_cell(ROOT, name)
    entry = harness.load_module(harness.BENCH / "entries"
                                / f"{cell.traffic['entry']}.py")
    assert callable(entry.solve)
    for m in cell.end_to_end + cell.per_layer:
        reader = harness.load_module(harness.BENCH / "metrics"
                                     / f"{m['name']}.py")
        assert callable(reader.read)
    assert (harness.BENCH / "references"
            / f"{cell.config['reference']}.py").exists()
    system = harness.system(cell.config)
    assert callable(system.build) and callable(system.rhs)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == config and entry["reduced"] == cfg["reduced"]
    assert cfg["levels"] == levels_of(cfg)
    mg = cfg["multigrid"]
    assert cfg["levels"][0][0] == 2 ** mg["finest_level"]


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell(ROOT, "no-such-cell")


@pytest.mark.parametrize("name", CELLS)
def test_limits_lie_between_the_readings(name):
    """Each limit is above the program's largest reading and below the
    control's smallest, which is three times the lower reading or more."""
    limits = harness.load_cell(ROOT, name).limits
    for number, spec in limits["compare"].items():
        assert spec["lower"] < spec["limit"] < spec["upper"], number
        assert spec["upper"] >= 3 * spec["lower"], number
        assert math.isfinite(spec["limit"])
