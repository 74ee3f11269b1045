"""The harness: cells found by name, runs at a tiny size on the CPU, the
refusal without a card, the module check, and a cell added by files alone."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from lfmbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TINY = {"genes": 4, "timepoints": 12}


def tiny(cell):
    cell.cfg.update(TINY)
    if cell.mix["kind"] == "fit":
        cell.mix.update(steps=5)
    else:
        cell.mix.update(test_times=10, draws=16, checked=3)
    return cell


def test_spec_names_units_and_files():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert (ROOT / "lfmbench" / "metrics" / f"{m['name']}.py").exists()
    for c in SPEC["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["file"].startswith("lfmbench/") and c["reduced"] == []
    for x in SPEC["configs"] + SPEC["workloads"] + SPEC["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] and "\t" not in x[key]
    assert all(m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) == 0
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(name):
    cell = harness.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_at_a_tiny_size(name, traced):
    cell = tiny(harness.load_cell(name))
    out = harness.run(cell, 2**31 + 5, 0.3, traced, "cpu", time.perf_counter())
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell.limits)
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        # no device on the CPU: the kernel readers find nothing and say nothing
        assert not {"factor_ms.train", "linalg_ms.predict", "gram_roofline.predict"} & set(
            out["metrics"])
        assert {"step_mfu.train", "step_mfu.predict"} & set(out["metrics"])
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(out, allow_nan=False)


def test_the_same_seed_gives_the_same_inputs():
    import torch

    from lfmbench import inputs
    from lfmbench.reference import simm

    cell = tiny(harness.load_cell("simm-dense10k-f64.predict"))
    a = inputs.make(cell.cfg, cell.mix, simm, 2**33 + 1, torch.device("cpu"))
    b = inputs.make(cell.cfg, cell.mix, simm, 2**33 + 1, torch.device("cpu"))
    c = inputs.make(cell.cfg, cell.mix, simm, 2**33 + 2, torch.device("cpu"))
    assert torch.equal(a["y"], b["y"]) and torch.equal(a["draws"]["decay"], b["draws"]["decay"])
    assert not torch.equal(a["y"], c["y"])
    assert a["y"].shape == c["y"].shape


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = subprocess.run([sys.executable, "lfmbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_the_module_check_compares_whole_top_level_names():
    code = ("import sys, types; from lfmbench import harness; "
            "import dis_project_tpu_torch.ops.mll; assert harness.forbidden_modules() == []; "
            "sys.modules['dis_project_tpu.x'] = types.ModuleType('x'); "
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "['dis_project_tpu']"


def test_a_run_loads_no_jax():
    code = ("import time; from lfmbench import harness; "
            "c = harness.load_cell('simm2-dense10k-f64.train'); "
            "c.cfg.update(genes=3, timepoints=8); "
            "c.mix.update(steps=3); o = harness.run(c, 5, 0.2, False, 'cpu', time.perf_counter()); "
            "print(o is not None and o['correct'], harness.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(env, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "True []"


def test_a_cell_a_mix_and_a_metric_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "lfmbench", tmp_path / "lfmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "simm-dense10k-f64.train-short",
                              "config": "simm-dense10k-f64", "traffic": "adam7", "chips": 1,
                              "why": "a shorter fit"})
    spec["per_layer"].append({"name": "host_ops.train", "unit": "ops/step", "better": "lower",
                              "source": "device_trace", "layer": "training loop",
                              "moves": "train_step_ms",
                              "workloads": ["simm-dense10k-f64.train-short"]})
    for m in spec["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("simm-dense10k-f64.train-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = tmp_path / "lfmbench"
    mix = json.loads((bench / "traffic" / "adam150.json").read_text())
    (bench / "traffic" / "adam7.json").write_text(json.dumps(dict(mix, steps=7)))
    shutil.copy(bench / "workloads" / "simm-dense10k-f64.train.json",
                bench / "workloads" / "simm-dense10k-f64.train-short.json")
    (bench / "metrics" / "host_ops.train.py").write_text(
        "def read(r):\n    return len(r.timeline.host) / r.units\n")

    cell = harness.load_cell("simm-dense10k-f64.train-short", root=tmp_path)
    assert cell.mix["steps"] == 7
    cell.cfg.update(TINY)
    out = harness.run(cell, 9, 0.2, True, "cpu", time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["host_ops.train"]["value"] > 0
