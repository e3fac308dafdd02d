"""BENCHMARK.json against the contract's shape, and every name it holds
against the files that carry it."""

import importlib.util
import json
import re
from pathlib import Path

from wmbench import run
from wmbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _man():
    return run.manifest(REPO)


def _metric(name):
    path = REPO / "wmbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keys_and_names():
    man = _man()
    assert set(man) == KEYS
    assert man["paths"] == ["wmbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (man["run_seconds"] + 60)
    names = ([c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in man["end_to_end"] + man["per_layer"])
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_finds_its_files():
    man = _man()
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["file"].startswith("wmbench/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (REPO / "wmbench" / "systems" / f"{cfg['system']}.py").exists()
    for w in man["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        parts = run.cell_parts(man, w["name"], REPO / "wmbench")
        assert (REPO / "wmbench" / "traffic" / f"{parts.traffic['kind']}.py").exists()
        assert parts.limits and all(v > 0 for v in parts.limits.values())
        reported = {m["name"] for m in parts.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and parts.per_layer


def test_metric_files_agree_with_the_manifest():
    man = _man()
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["end_to_end"] + man["per_layer"]:
        mod = _metric(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"] in SOURCES
        assert m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        mod = _metric(m["name"])
        assert (mod.LAYER, mod.MOVES, mod.WORKLOADS) == (m["layer"], m["moves"], m["workloads"])
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cell_e2e = {x["name"] for x in man["end_to_end"] if w in x.get("workloads", [w])}
            assert m["moves"] in cell_e2e
    layers = {}
    for m in man["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_shares_are_percent_and_named():
    for m in _man()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert Path(REPO / "wmbench" / "metrics" / "k1_roofline.py").exists()
