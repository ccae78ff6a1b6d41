"""The manifest keeps the benchmark's format and limits, and the harness is driven by its data."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT, make_tiny_bench, run_tiny
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")
MANIFEST = harness.load_json(ROOT / "BENCHMARK.json")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert FILE.match(p) and len(p) <= 200 and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in MANIFEST["command"]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
    if section == "configs":
        for e in entries:
            assert set(e) == {"name", "source", "file", "reduced", "why"}
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
            assert e["file"].startswith("perfbench/") and (ROOT / e["file"]).exists()
    if section == "workloads":
        for e in entries:
            assert set(e) == {"name", "config", "traffic", "chips", "why"} and e["chips"] in (1, 4)
            assert NAME.match(e["traffic"]) and NAME.match(e["config"])
        assert len({(e["config"], e["traffic"]) for e in entries}) == len(entries)
    if section == "end_to_end":
        assert "setup_s" in names
        for e in entries:
            assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
            assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    if section == "per_layer":
        for e in entries:
            assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _reported(metric: dict):
    cells = [w["name"] for w in MANIFEST["workloads"]]
    return metric.get("workloads", cells)


def test_every_moved_metric_is_reported_where_the_layer_metric_is():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(_reported(m)) <= set(_reported(e2e[m["moves"]])), m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if w["name"] in _reported(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in _reported(m) for m in MANIFEST["per_layer"]), w["name"]


def test_every_name_has_its_files():
    bench = ROOT / "perfbench"
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert (bench / "mixes" / f"{w['traffic']}.json").exists()
        limits = harness.load_json(bench / "limits" / f"{w['name']}.json")
        assert limits["limits"] and all(v is not None for v in limits["limits"].values())
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for path in bench.rglob("*"):
        if "__pycache__" not in path.parts:
            assert FILE.match(str(path.relative_to(ROOT))), path


def test_layers_of_one_name_are_spelt_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(_line(x) for x in layers)
    folded = {x.lower().replace(" ", "") for x in layers}
    assert len(folded) == len(layers)


def test_a_new_mix_and_cell_need_only_new_files(tmp_path):
    """A throwaway mix and a cell that names it, added as data to a copy,
    load and run through the same harness with no code changed."""
    bench = make_tiny_bench(tmp_path)
    mix = harness.load_json(bench / "mixes" / "gated.json")
    mix["max_staleness"] = 3
    (bench / "mixes" / "burst-test.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits" / "fleet-100k.gated.json",
                bench / "limits" / "fleet-100k.burst-test.json")
    manifest = harness.load_json(bench.parent / "BENCHMARK.json")
    manifest["workloads"].append(dict(name="fleet-100k.burst-test", config="fleet-100k",
                                      traffic="burst-test", chips=1, why="a throwaway cell"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "fleet-100k.gated" in m.get("workloads", []):
            m["workloads"].append("fleet-100k.burst-test")
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.Cell(manifest, "fleet-100k.burst-test", bench=bench)
    assert cell.mix["max_staleness"] == 3 and cell.driver.__name__ == "perfbench.drivers.fleet"
    assert {m["name"] for m in cell.per_layer} >= {"advance_ms.fleet", "k1_roofline"}
    assert cell.limits == harness.load_json(bench / "limits" / "fleet-100k.gated.json")["limits"]
    res = run_tiny(bench, "fleet-100k.burst-test")
    assert res["correct"] and res["metrics"]["obs_per_s"]["value"] > 0, (res["error"], res["checks"])
