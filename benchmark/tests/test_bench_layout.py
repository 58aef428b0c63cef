"""The benchmark is driven by data: every cell, configuration, driver and
metric that BENCHMARK.json names has its file, found by name."""

import json
import re

import pytest

from benchmark.lib import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(cell):
    wl = harness.load_json(harness.BENCH_DIR / "workloads" / f"{cell['name']}.json")
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    cfg = harness.load_json(harness.ROOT / cfg_entry["file"])
    assert cfg["name"] == cell["config"] and wl["traffic"] == cell["traffic"]
    assert (harness.BENCH_DIR / "traffic" / f"{wl['driver']}.py").exists()
    e2e, per = harness.cell_metrics(BENCH, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    for m in per:
        assert callable(harness.load_reader(m["name"]).read)
        assert m["moves"] in {x["name"] for x in e2e}


def test_every_metric_reader_is_named():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {p.stem for p in (harness.BENCH_DIR / "metrics").glob("*.py")}
    assert names == files


def test_checks_come_last_in_the_result_line():
    result = {"correct": True, "checks": {"x": {"value": 1, "limit": 2}}}
    assert list(json.loads(json.dumps(result)))[-1] == "checks"
