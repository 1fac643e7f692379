"""BENCHMARK.json against the contract it is checked by, and every file it
names found by name."""

import json
import re

import pytest

from hbbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = harness.load_manifest()


def test_names_units_and_lines():
    names = [m["name"] for m in MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += [w["config"] for w in MANIFEST["workloads"]] + [w["traffic"] for w in MANIFEST["workloads"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    texts = [w["why"] for w in MANIFEST["workloads"]] + [c["why"] for c in MANIFEST["configs"]]
    texts += [m["layer"] for m in MANIFEST["per_layer"]] + MANIFEST["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(MANIFEST).encode()) <= 64 * 1024


def test_bounds_and_run_seconds():
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = len(MANIFEST["workloads"])
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, cells // 4)


@pytest.mark.parametrize("work", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_and_reports(work):
    cell = harness.resolve(work["name"])
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert cell.config["name"] == work["config"] and cell.mix["name"] == work["traffic"]
    assert cell.mix["loop"] in ("closed", "open")


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"] == f"hbbench/configs/{config['name']}.json"
    body = harness.load_json("configs", config["name"])
    # a configuration states its cuts in its file as in the manifest, each
    # a key of the file
    assert body["reduced"] == config["reduced"]
    assert all(key in body for key in config["reduced"])
    assert body["n"] >= 3 * body["f"] + 1 and body["tx_bytes"] >= 8


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_agree_with_the_manifest(metric):
    mod = harness.load_metric(metric["name"])
    assert mod.UNIT == metric["unit"] and mod.SOURCE == metric["source"]
    assert callable(mod.read)
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])


def test_layers_are_named_alike():
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
