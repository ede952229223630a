"""BENCHMARK.json against the contract it is written to: names and units,
the files each entry names, and every per-layer metric's ``moves``."""

from __future__ import annotations

import json
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_and_units():
    m = harness.manifest()
    assert set(m) == KEYS["top"]
    assert m["command"] == ["python3", "benchmark/run.py"] and m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
    for w in m["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == KEYS["e2e"] and NAME.match(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == KEYS["layer"] and NAME.match(p["name"])
        assert UNIT.match(p["unit"]) and p["better"] in ("lower", "higher")
        assert "\n" not in p["layer"] and len(p["layer"]) <= 200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(m)) < 64 * 1024


def test_every_file_a_name_points_to():
    m = harness.manifest()
    for w in m["workloads"]:
        cell = harness.cell(w["name"], m)
        assert (harness.HERE / "drivers" / f"{cell.traffic['kind']}.py").exists()
    for p in m["per_layer"]:
        assert (harness.HERE / "metrics" / f"{p['name']}.py").exists()
    for c in m["configs"]:
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]


def test_moves_names_a_metric_each_cell_reports():
    m = harness.manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for w in cells:
        cell = harness.cell(w, m)
        got = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
    for p in m["per_layer"]:
        assert p["moves"] in e2e and p["moves"] != "setup_s"
        for w in p.get("workloads", sorted(cells)):
            assert w in cells
            target = e2e[p["moves"]]
            assert "workloads" not in target or w in target["workloads"]
    layers = {}
    for p in m["per_layer"]:
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configurations_are_the_published_model():
    """Every width of both configurations is aki_torch's aki_4b(): nothing
    reduced."""
    import dataclasses

    from aki_torch.models.configs import aki_4b

    want = json.loads(json.dumps(dataclasses.asdict(aki_4b())))
    for c in harness.manifest()["configs"]:
        assert harness.load_json(harness.ROOT / c["file"])["model"] == want
