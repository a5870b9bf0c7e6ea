"""BENCHMARK.json against the contract's rules a file can break alone,
and every cell resolved to its files by name."""

from __future__ import annotations

import json
import math

import pytest

from perfbench.core import manifest

BENCH = manifest.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL = manifest.catalog()
ALL_CELLS = [w["name"] for w in ALL["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    raw = (manifest.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]


def test_names_and_units_use_allowed_characters():
    assert manifest.check_names(BENCH) == []
    assert manifest.check_names(ALL) == []


def test_staged_cells_are_ready_to_move_into_the_benchmark():
    """staged.json's entries have BENCHMARK.json's forms (an end-to-end
    metric without its bound, which the change that moves it measures),
    and each per-layer metric moves a rate its cells report."""
    staged = ALL_CELLS[len(CELLS):]
    assert staged and not set(staged) & set(CELLS)
    e2e = {m["name"]: m for m in ALL["end_to_end"]}
    for m in ALL["end_to_end"][len(BENCH["end_to_end"]):]:
        assert set(m) == {"name", "unit", "better", "source", "workloads"}
        assert set(m["workloads"]) <= set(staged)
    for m in ALL["per_layer"][len(BENCH["per_layer"]):]:
        assert set(m["workloads"]) <= set(staged)
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "µs", "",
                                 "x" * 65])
def test_bad_names_are_refused(bad):
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["name"] = bad
    assert manifest.check_names(bench)


def test_a_staged_cell_moves_in_by_added_entries_alone(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    staged = ALL["workloads"][len(CELLS)]
    bench["workloads"].append(staged)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    merged = manifest.catalog(tmp_path)
    names = [w["name"] for w in merged["workloads"]]
    assert names.count(staged["name"]) == 1
    assert manifest.check_names(merged) == []


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_resolves_to_its_files(cell):
    c = manifest.resolve(cell)
    assert c.chips == 1
    assert {m.name for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(c.loop, fn))
    assert c.loop.FAULTS
    assert callable(c.reference.param_spec)
    assert c.limits and all(v >= 0 for v in c.limits.values())


@pytest.mark.parametrize("kind,key,value", [
    ("workloads", "traffic", "no_such_mix"),
    ("workloads", "config", "no_such_config"),
])
def test_missing_piece_fails_with_its_name(kind, key, value):
    bench = json.loads(json.dumps(BENCH))
    bench[kind][0][key] = value
    with pytest.raises(manifest.ManifestError, match=value):
        manifest.resolve(bench[kind][0]["name"], bench=bench)


def test_missing_metric_reader_fails_with_its_name():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["name"] = "no_such_metric.unc_train"
    with pytest.raises(manifest.ManifestError, match="no_such_metric"):
        manifest.resolve(bench["per_layer"][0]["workloads"][0], bench=bench)


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) >= 1 for v in layers.values())


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        e2e = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        per = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
        assert len(e2e) >= 2 and per
        names = {m["name"] for m in per}
        assert any("mfu" in n for n in names)


def test_configs_and_cells():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (manifest.ROOT / c["file"]).exists()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, math.floor(0.25 * len(CELLS)))


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
