"""The harness: cells found by name, runs at a tiny size on the CPU, the
refusal without a card, the module check, and a cell added by files alone."""

import importlib
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
    """``cell`` at the tests' size: ``TINY`` genes and times, and the mix
    as its traffic kind's ``TINY`` sets it."""
    cell.cfg.update(TINY)
    kind = importlib.import_module(f"lfmbench.traffic.{cell.mix['kind']}")
    cell.mix.update(getattr(kind, "TINY", {}))
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
        # what the host's clock gives is read on any device
        host = {m["name"] for m in cell.per_layer if m["source"] == "host_clock"}
        assert host and host <= set(out["metrics"])
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


# A family, its reference, a traffic kind and the family's fault sites, each
# a new file: what a sparse cell at N beyond an exact draw brings.
_STUB_CONFIG = {
    "name": "stub-quad", "source": "a stub", "family": "stub", "data": "quadrature",
    "oversample": 4, "genes": 6, "timepoints": 40, "t_max": 12.0, "dtype": "float64",
    "jitter": 1e-4, "noise_std": 0.1, "start_spread": 0.1,
    "truth": {"basal": [0.01, 0.1], "sensitivity": [0.5, 1.5], "decay": [0.2, 1.0],
              "lengthscale": 2.5},
    "start": {"basal": 0.05, "sensitivity": 1.0, "decay": 0.4, "lengthscale": 2.5,
              "obs_stddev": 1.0}}

_STUB_REFERENCE = '''
"""A stub family's reference: a critically damped response, S t e^{-D t}."""
import torch
from lfmbench.reference.simm import BIJECTORS, LEAVES, PER_GENE, prior_mean  # noqa: F401


def green(p, tau):
    return p["sensitivity"] * tau * torch.exp(-p["decay"] * tau)


def gene_means(y64, genes):
    return y64.reshape(genes, -1).mean(dim=1)
'''

_STUB_FAMILY = '''
"""A stub program: per-gene means of the expression, a minibatch at a time."""
import sys

import torch

from lfmbench import faults

HERE = sys.modules[__name__]


def step(sums, y, genes):
    return sums.index_add(0, genes, y)


def finish(sums, counts):
    return sums / counts


def sweeper(cfg, mix, inp):
    G, T, b = cfg["genes"], cfg["timepoints"], mix["batch"]
    y, order = inp["y"], inp["order"]
    gene = torch.arange(G, device=y.device).repeat_interleave(T)

    def run():
        sums = torch.zeros(G, dtype=y.dtype, device=y.device)
        for a in range(0, order.numel(), b):
            rows = order[a:a + b]
            sums = HERE.step(sums, y[rows], gene[rows])
        return HERE.finish(sums, float(T))

    return run


_step, _finish = step, finish


def _half(sums, y, genes):
    h = y.shape[0] // 2
    return _step(sums, 2.0 * y[:h], genes[:h])


FAULTS = {
    "unchanged": lambda: faults.patched(HERE, "step", lambda sums, y, genes: sums),
    "half": lambda: faults.patched(HERE, "step", _half),
    "altered": lambda: faults.patched(HERE, "finish", lambda s, c: _finish(s, c) * (1 + 1e-3)),
}
'''

_STUB_KIND = '''
"""Traffic kind ``sweep``: whole passes over the rows in a seeded order."""
import torch
from torch.profiler import record_function

from lfmbench import faults
from lfmbench.trace import WINDOW_SPAN


def draw_inputs(cfg, mix, family, truth, gen, dt, device):
    n = cfg["genes"] * cfg["timepoints"]
    return {"order": torch.randperm(n, generator=gen, device=device)}


def setup(family, cfg, mix, inp):
    run = family.sweeper(cfg, mix, inp)
    return {"run": run, "answer": run()}


def window(state, seconds, clock, sync):
    k = 0
    with record_function(WINDOW_SPAN):
        t0 = clock()
        while True:
            state["answer"] = state["run"]()
            k += 1
            if clock() - t0 >= seconds:
                break
        sync()
        span = clock() - t0
    return {"window_s": span, "units": k, "attempted": k, "failed": 0,
            "metrics": {"sweep_ms": 1e3 * span / k}}


def free(state):
    state.pop("run", None)


def _gap(answer, ref):
    return {"mean": float((answer.double() - ref).abs().max() / ref.abs().max())}


def check(state, ref_family, cfg, mix, inp, seed):
    return _gap(state["answer"], ref_family.gene_means(inp["y64"], cfg["genes"]))


def readings(emit, family, ref_family, cfg, mix, inp, seed, control, fault_kinds, seconds,
             sync):
    ref = ref_family.gene_means(inp["y64"], cfg["genes"])
    emit("program", _gap(setup(family, cfg, mix, inp)["answer"], ref))
    if control:
        emit("control", _gap(ref_family.gene_means(inp["y64"].float(), cfg["genes"]), ref))
    for f in fault_kinds:
        with faults.plant(f, family):
            emit(f, _gap(setup(family, cfg, mix, inp)["answer"], ref))
'''

_STUB_DRIVE = '''
import importlib, json, time
from lfmbench import calibrate, faults, harness

cell = harness.load_cell("stub-quad.sweep")
family = importlib.import_module("lfmbench.families.stub")
out = {"sound": harness.run(cell, 2**31 + 13, 0.2, True, "cpu", time.perf_counter()),
       "kinds": list(faults.kinds(family)), "planted": {}}
for kind in faults.kinds(family):
    with faults.plant(kind, family):
        out["planted"][kind] = harness.run(cell, 2**31 + 13, 0.2, False, "cpu",
                                           time.perf_counter())
out["readings"] = calibrate.readings(cell, 17, "cpu", control=True,
                                     fault_kinds=faults.kinds(family), seconds=0.2)
print(json.dumps(out))
'''


def _digests(bench):
    import hashlib

    return {p.relative_to(bench).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(bench.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_quadrature_family_a_traffic_kind_and_fault_sites_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "lfmbench", tmp_path / "lfmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "lfmbench"
    before = _digests(bench)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stub-quad", "source": "a stub",
                            "file": "lfmbench/configs/stub-quad.json", "reduced": [],
                            "why": "a stub family on the quadrature route"})
    spec["workloads"].append({"name": "stub-quad.sweep", "config": "stub-quad",
                              "traffic": "sweep8", "chips": 1, "why": "seeded passes"})
    spec["end_to_end"].append({"name": "sweep_ms", "unit": "ms", "better": "lower",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["stub-quad.sweep"]})
    spec["per_layer"].append({"name": "host_ops.sweep", "unit": "ops/pass", "better": "lower",
                              "source": "device_trace", "layer": "stub", "moves": "sweep_ms",
                              "workloads": ["stub-quad.sweep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    new = {"configs/stub-quad.json": json.dumps(_STUB_CONFIG),
           "reference/stub.py": _STUB_REFERENCE, "families/stub.py": _STUB_FAMILY,
           "traffic/sweep.py": _STUB_KIND,
           "traffic/sweep8.json": json.dumps({"kind": "sweep", "batch": 8}),
           "workloads/stub-quad.sweep.json": json.dumps({"limits": {"mean": 1e-9}}),
           "metrics/host_ops.sweep.py": "def read(r):\n    return len(r.timeline.host) / r.units\n"}
    for rel, text in new.items():
        assert not (bench / rel).exists()
        (bench / rel).write_text(text)
    (tmp_path / "drive.py").write_text(_STUB_DRIVE)

    # the checkout's lfmbench, not this one's, and the port from this root
    p = subprocess.run([sys.executable, "drive.py"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    after = _digests(bench)
    assert {k: after[k] for k in before} == before  # no file that was there changed

    sound = out["sound"]
    assert sound["correct"] is True, sound["checks"]
    assert sound["metrics"]["host_ops.sweep"]["value"] > 0
    assert out["kinds"] == ["unchanged", "half", "altered"]
    for kind, run in out["planted"].items():
        assert run["correct"] is False, (kind, run["checks"])
        assert set(run["metrics"]) == {"setup_s", "peak_mem_gib", "sweep_ms"}
    rows = {r["reading"]: r for r in out["readings"]}
    assert list(rows) == ["program", "control", "unchanged", "half", "altered"]
    assert rows["program"]["mean"] <= 1e-9
    assert all(rows[k]["mean"] > 1e-9 for k in ("control", "unchanged", "half", "altered"))
