"""The run's entry, its result line and the modules it loads."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from depbench.tests import helpers

ROOT = helpers.ROOT


def _top_level_modules(code: str, cwd: str = ROOT) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "depbench/run.py", "--workload", "sphere16.preview256", "--seed", str(2**31 + 7),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""  # no result, and no run on the CPU


def test_main_never_falls_back_to_the_cpu(monkeypatch, capsys):
    import torch

    from depbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "sphere16.full2k", "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and depbench/, the timed step cannot run."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "depbench"), tmp_path / "depbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from depbench import program; "
                        "program.job('tree', 'out', '000001', '000001', [], 'cpu')"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "facebook360_dep_tpu_torch" in p.stderr


def test_harness_and_reference_load_no_jax():
    names = _top_level_modules("import sys; sys.path.insert(0, '.')\n"
                               "import depbench.harness, depbench.calibrate, depbench.trace, depbench.judge\n"
                               "import depbench.reference.solve, depbench.reference.camera")
    assert not names & {"jax", "jaxlib", "flax", "facebook360_dep_tpu", "facebook360_dep_tpu_torch"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level_modules("import sys; sys.path.insert(0, '.')\n"
                               "import depbench.reference.solve, depbench.reference.camera")
    assert "facebook360_dep_tpu_torch" not in names and "facebook360_dep_tpu" not in names


def test_a_run_loads_no_jax():
    """A whole test-sized run (the program included) in a fresh process loads neither JAX nor the JAX package;
    the check compares whole top-level names, so the port's own name does not count."""
    code = ("import sys; sys.path.insert(0, '.')\nfrom depbench.tests import helpers\n"
            "r = helpers.run_cpu('tiny4.small')\nassert 'forbidden' not in r and r['correct'], r")
    names = _top_level_modules(code)
    assert "facebook360_dep_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "facebook360_dep_tpu"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from depbench import harness

    monkeypatch.setitem(sys.modules, "facebook360_dep_tpu_torch_fake.sub", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("traced", [False, True], ids=["window", "trace"])
def test_result_line_has_the_contract_keys(traced):
    r = helpers.run_cpu("tiny4.small", traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["compared"]
    assert list(r) == keys
    json.dumps(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if traced else set())
    bench = helpers.benchmark()
    if traced:
        assert set(r["metrics"]) <= {m["name"] for m in bench["per_layer"]}
        assert {"finest_level_s", "coarser_levels_s"} <= set(r["metrics"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(r["compared"]) == {"finest_off_share", "coarsest_off_share"}


@pytest.mark.cuda
def test_preview_cell_on_the_card():
    """On the card: one short run of the preview cell is correct (python -m pytest -m cuda depbench/tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "depbench/run.py", "--workload", "sphere16.preview256", "--seed",
                        str(2**31 + 99), "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
