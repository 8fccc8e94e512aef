"""BENCHMARK.json against the contract, and every cell's files found by name."""

import json
import re

import pytest

from portbench.bench import PKG, REPO, entry, load_cell, metric_reader

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "-m"] and BENCH["command"][2].startswith("portbench.")
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_names_and_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = set()
    for section, allowed in keys.items():
        for e in BENCH[section]:
            assert set(e) <= allowed and set(allowed) - {"workloads"} <= set(e), (section, e)
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            for text in ("why", "layer") + (("source",) if section == "configs" else ()):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_every_config_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]} and len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("key", ["TAI_gray", "TAI_color"])
def test_configs_keep_the_published_widths(key):
    """The configuration's model is the registry's key, every width as published."""
    from vfi_tpu_torch.models.registry import model_config

    cfg = next(json.loads((REPO / c["file"]).read_text()) for c in BENCH["configs"]
               if json.loads((REPO / c["file"]).read_text())["model_key"] == key)
    spec = model_config(key)
    assert cfg["model_class"] == spec["class"] and cfg["model_kwargs"] == spec["kwargs"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = load_cell(workload)
    assert entry(cell).run
    assert set(cell.limits) and all(isinstance(v, (int, float)) for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(metric_reader(cell, m["name"]))
        assert m["moves"] in e2e, (workload, m["name"])


def test_no_stray_files():
    """Each traffic, limits and metric file belongs to an entry of BENCHMARK.json."""
    traffic = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (PKG / "traffic").glob("*.json")} == traffic
    assert {p.stem for p in (PKG / "limits").glob("*.json")} == set(WORKLOADS)
    assert {p.name[:-3] for p in (PKG / "metrics").glob("*.py")} == {m["name"] for m in BENCH["per_layer"]}
