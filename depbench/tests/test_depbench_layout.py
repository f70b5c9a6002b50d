"""BENCHMARK.json against the benchmark's contract, and every file it names found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from depbench.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = helpers.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "depbench/run.py"]
    assert BENCH["paths"] == ["depbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(helpers.ROOT, "BENCHMARK.json")) <= 64 * 1024
    # a full check of 24 cells fits in 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_found_by_name():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"depbench/configs/{c['name']}.json"
        with open(os.path.join(helpers.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(cfg["levels"]["widths"]) == len(cfg["levels"]["heights"])
        assert os.path.exists(os.path.join(helpers.ROOT, "depbench", "rigs", cfg["rig"]["maker"] + ".py"))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(wl):
    from depbench import harness

    assert set(wl) == {"name", "config", "traffic", "chips", "why"} and wl["chips"] == 1 and _line(wl["why"])
    c = harness.find_cell(wl["name"], BENCH)
    assert c.cell["why"] == wl["why"]
    for sub, name in (("scenes", c.cell["scene"]), ("reference", c.cell["reference"])):
        assert hasattr(harness.load_module(os.path.join(harness.BASE, sub, name + ".py")),
                       "render" if sub == "scenes" else "solve_pyramid")
    assert set(c.cell["compare"]["limits"]) == {"finest_off_share", "coarsest_off_share"}
    assert all(0 < v < 1 for v in c.cell["compare"]["limits"].values())
    assert set(c.levels) <= set(range(len(c.config["levels"]["widths"])))
    # every cell reports setup_s, another end-to-end metric and a per-layer metric
    e2e = [m["name"] for m in c.metrics("end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.metrics("per_layer")


def test_metrics_follow_the_contract():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"]) and UNIT.match(m["unit"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(m):
    from depbench import harness

    assert callable(harness.load_module(os.path.join(harness.BASE, "metrics", m["name"] + ".py")).read)


CELL_FILES = [os.path.join(d, f) for d in (os.path.join(helpers.ROOT, "depbench", "cells"),
                                           os.path.join(helpers.DATA, "cells")) for f in sorted(os.listdir(d))]


@pytest.mark.parametrize("path", CELL_FILES, ids=os.path.basename)
def test_inputs_a_cell_lists_are_known_and_made_by_its_scene(path):
    """Every input layer a cell lists is one the harness writes, and the scene of such a cell makes them."""
    from depbench import harness

    cell = harness.load_json(path)
    inputs = cell.get("inputs", [])
    assert isinstance(inputs, list) and len(set(inputs)) == len(inputs)
    assert set(inputs) <= set(harness.INPUT_LAYERS)
    scene = harness.load_module(os.path.join(harness.BASE, "scenes", cell["scene"] + ".py"))
    assert callable(scene.render) and (not inputs or callable(scene.render_inputs))
