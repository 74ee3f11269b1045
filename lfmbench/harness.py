"""One run of one cell: set-up, the measured window, the per-layer readings
of a traced window, the comparison with the reference, the result line.

Everything a cell needs is found by name, so a cell, a configuration, a
traffic mix or a per-layer metric is added by adding files:

- ``BENCHMARK.json`` (the checkout's root): the cell's configuration,
  traffic mix and metrics;
- ``configs/<config>.json``: the sizes, dtype, jitter, the ground truth's
  ranges, the fit's start and the data's route (``data``: an exact draw
  from the prior, or ``"quadrature"`` past the N an exact draw can hold;
  ``lfmbench.inputs``); its ``family`` names ``families/<family>.py`` (the
  program's entries, and in ``FAULTS`` the sites of the faults planted on
  its path, ``lfmbench.faults``) and ``reference/<family>.py`` (the plain
  reference);
- ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names
  ``traffic/<kind>.py``, which draws the inputs of its own, sets up, runs
  the timed window (inside the ``lfmbench.window`` span that a trace is read
  over), compares, and takes the readings its limits are set from
  (``lfmbench.calibrate``);
- ``workloads/<cell>.json``: the limits of the cell's comparison;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(readings)``,
  which returns a number or None when the trace holds nothing to read.

A traced run (``--trace 1``) first runs the untraced window, as a run
without tracing does, for the seconds a unit of work takes there; then a
window under ``torch.profiler`` (CPU and CUDA activity), whose timeline the
readers read. A share of the card's time (``step_mfu``, ``device_idle``) is
taken over the untraced window's seconds, so the profiler's own host cost
does not enter it.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dis_project_tpu")
GIB = float(2**30)
# The traced window is cut to the whole units (fits, requests) of its first
# 8 seconds: the profiler's Chrome trace takes ~1.8 MB a second-order step,
# so a whole 30 s window would write and parse a gigabyte.
TRACED_SECONDS = 8.0


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"lfmbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    bench: Path
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files from
    ``root/lfmbench``."""
    spec = _json(root / "BENCHMARK.json")
    bench = root / HERE.name
    matches = [w for w in spec["workloads"] if w["name"] == name]
    if not matches:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = matches[0]
    entry = [c for c in spec["configs"] if c["name"] == wl["config"]][0]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    assert all(m["moves"] in e2e_names for m in layer), f"{name}: a metric moves no metric of it"
    return Cell(name=name, bench=bench, chips=wl["chips"], cfg=_json(root / entry["file"]),
                mix=_json(bench / "traffic" / f"{wl['traffic']}.json"),
                limits=_json(bench / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=layer)


@dataclass
class Readings:
    """What a per-layer metric reads: the traced window's timeline, the
    units of work it completed (steps or requests), the seconds a unit took
    in the untraced window of the same run, and the cell's sizes."""

    timeline: object
    units: int
    unit_s: float
    cfg: dict
    mix: dict

    @property
    def n(self) -> int:
        return self.cfg["genes"] * self.cfg["timepoints"]

    @property
    def m(self) -> int:
        return self.cfg["genes"] * self.mix.get("test_times", 0)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        clock=time.perf_counter):
    """One run; returns the result line's object, or None (after naming
    them on standard error) when a forbidden module was loaded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dis_project_tpu_torch.ops.precision import default_device
    from lfmbench import inputs, trace as tracing

    cfg, mix = cell.cfg, cell.mix
    family = importlib.import_module(f"lfmbench.families.{cfg['family']}")
    ref_family = importlib.import_module(f"lfmbench.reference.{cfg['family']}")
    kind = importlib.import_module(f"lfmbench.traffic.{mix['kind']}")
    dev = default_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak() -> int:
        return torch.cuda.max_memory_allocated() if on_card else 0

    inp = inputs.make(cfg, mix, ref_family, seed, dev)
    state = kind.setup(family, cfg, mix, inp)
    sync()
    setup_peak = peak()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock() - t_start

    res = kind.window(state, seconds, clock, sync)
    if trace:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = kind.window(state, min(seconds, TRACED_SECONDS), clock, sync)
    window_peak = peak()
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return None

    attempted, failed = res["attempted"], res["failed"]
    if trace:
        attempted, failed = attempted + traced["attempted"], failed + traced["failed"]
    out = {"correct": False, "attempted": attempted, "failed": failed,
           "metrics": {}, "device": {
               "platform": "gpu" if on_card else dev.type,
               "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
               "count": cell.chips, "memory_peak_bytes": max(setup_peak, window_peak)}}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        tl = tracing.from_profiler(prof)
        del prof  # its events are read: free them before the check
        readings = Readings(tl, traced["units"], res["window_s"] / res["units"], cfg, mix)
        for m in cell.per_layer:
            value = _module(cell.bench / "metrics" / f"{m['name']}.py").read(readings)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": units[m["name"]]}
        out["device"]["busy_s"] = tl.busy_s()
        out["device"]["window_s"] = tl.window_s
        out["breakdown"] = tracing.breakdown(tl)
    else:
        values = dict(res["metrics"], setup_s=setup_s, peak_mem_gib=window_peak / GIB)
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}

    kind.free(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = kind.check(state, ref_family, cfg, mix, inp, seed)
    checks = {k: {"value": _number(v), "limit": cell.limits[k]} for k, v in numbers.items()}
    out["correct"] = all(v <= cell.limits[k] for k, v in numbers.items())
    out["checks"] = checks
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    if out is None:
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0
