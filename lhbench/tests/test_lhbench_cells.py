"""``BENCHMARK.json`` against the rules of its format, and every cell,
configuration, traffic mix and metric found by name from it."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from lhbench import gossip, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["lhbench"]
    assert BENCH["command"] == ["python3", "lhbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", CONFIG_KEYS), ("workloads", CELL_KEYS),
    ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)])
def test_entries_have_the_format_keys_and_names(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        assert keys <= set(entry) <= keys | {"workloads"}, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_config_traffic_and_metrics(cell):
    assert cell["chips"] == 1
    dep = gossip.Deployment.load(cell["config"])
    mix = gossip.Mix.load(cell["traffic"])
    # distinct signers within the run's slots fit in the registry
    assert mix.slots * dep.committees_per_slot * dep.committee_size <= dep.active_validators
    reported = {m["name"] for m in harness.cell_metrics(BENCH, "end_to_end", cell["name"])}
    assert "setup_s" in reported and len(reported) >= 2
    layers = harness.cell_metrics(BENCH, "per_layer", cell["name"])
    assert layers
    for m in layers:
        assert callable(harness.load_reader(m["name"]))
        # a per-layer metric moves an end-to-end metric of every cell it is read in
        assert m["moves"] in reported, (cell["name"], m["name"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_one_named(config):
    path = ROOT / config["file"]
    assert path.parent == ROOT / "lhbench" / "configs"
    raw = json.loads(path.read_text())
    assert raw["name"] == config["name"] and raw["source"] == config["source"]
    assert raw["reduced"] == config["reduced"]
    assert raw["committee_size"] * raw["committees_per_slot"] * raw["slots_per_epoch"] == \
        raw["active_validators"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "lhbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, name)
    if "reference" in path.parts:
        for name in _imports(path):
            assert name.split(".")[0] not in ("lighthouse_tpu_torch", "lhbench", "torch"), \
                (path, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lighthouse_tpu_torch_probe", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "lighthouse_tpu.probe", object())
    assert "lighthouse_tpu" in harness.forbidden_modules()
