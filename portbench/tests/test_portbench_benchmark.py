"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell
    # to compile, 1,200 s spare) fits in 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must():
    from portbench import harness

    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = harness.cell_metrics(BENCH, w, True)
        assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}


def test_every_named_piece_is_a_file_of_its_own():
    from portbench import harness

    for w in BENCH["workloads"]:
        t = harness.traffic_of(w, ROOT)
        assert os.path.exists(os.path.join(ROOT, "portbench", "kinds", t["kind"] + ".py"))
        assert harness.config_of(BENCH, w, ROOT)["name"] == w["config"]
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_configs_keep_the_published_widths():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        from portbench import build

        mc = build.model_config(cfg)
        from ofasys_torch.model.config import GeneralistModelConfig

        preset = GeneralistModelConfig(arch=cfg["arch"])
        assert mc.encoder == preset.encoder and mc.decoder == preset.decoder
        assert c["reduced"] == []
