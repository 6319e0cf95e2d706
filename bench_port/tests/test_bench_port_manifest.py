"""BENCHMARK.json against the rules the benchmark is held to, and each
name in it against the file that serves it."""

import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w == p or w.startswith(p + "/") for p in manifest["paths"])
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # 24 cells' full check must fit its 43200 s: runs, compiles, spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries(manifest):
    groups = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, keys in groups.items():
        entries = manifest[group]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), group
        for e in entries:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads", "per_layer"):
                    assert _line(e[key]), (e["name"], key)
    assert 1 <= len(manifest["configs"]) <= 24 and 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16 and 1 <= len(manifest["per_layer"]) <= 128


def test_configs_are_files_of_their_own_and_used(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert "assumed" in cfg


def test_workloads_name_their_files(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json"), encoding="utf-8") as fh:
            traffic = json.load(fh)
        assert os.path.exists(os.path.join(BENCH, "engines", traffic["engine"] + ".py"))
        assert traffic["limits"] and traffic["check"]["solves"] >= 1


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])


def test_every_cell_reports_what_the_contract_asks(manifest):
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end_of(manifest, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_of(manifest, w["name"])
    e2e_names = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e_names
        for cell in m.get("workloads", []):
            reported = {x["name"] for x in harness.end_to_end_of(manifest, cell)}
            assert m["moves"] in reported, (m["name"], cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_files_under_paths_are_named_from_name_characters(manifest):
    for p in manifest["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                if "__pycache__" not in rel and not rel.endswith(".pyc"):
                    assert PATH.match(rel), rel


def test_layers_are_named_in_perf_md(manifest):
    with open(os.path.join(ROOT, "PERF.md"), encoding="utf-8") as fh:
        perf = fh.read()
    for m in manifest["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
