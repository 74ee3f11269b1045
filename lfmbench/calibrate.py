"""Readings for the limits of a cell's comparison, at the cell's own size.

    python3 lfmbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--fault-seeds 11,12,13] [--seconds 3]

For each seed, one JSON line a reading, each against the float64
reference: ``program``, a sound run of the timed path (set-up through the
fit's own call; for a prediction mix a window of ``--seconds`` at the
cell's own load, the checked requests drawn as a run draws them); on the
control seeds ``control``, the reference computed in float32 with TF32
products put in the program's place; on the fault seeds each fault of
``lfmbench.faults`` planted in the program. The benchmark's own runs do
not run this.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lfmbench import faults, harness, inputs  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(cell, seed, device, control=False, fault_kinds=(), seconds=3.0):
    """The readings of one seed: a list of ``{"seed", "reading", numbers}``."""
    import importlib

    import torch

    cfg, mix = cell.cfg, cell.mix
    family = importlib.import_module(f"lfmbench.families.{cfg['family']}")
    ref_family = importlib.import_module(f"lfmbench.reference.{cfg['family']}")
    kind = importlib.import_module(f"lfmbench.traffic.{mix['kind']}")
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    inp = inputs.make(cfg, mix, ref_family, seed, torch.device(device))
    out = []

    def emit(name, numbers):
        out.append(dict({"seed": seed, "reading": name}, **numbers))

    if mix["kind"] == "fit":
        ref = kind.reference_steps(ref_family, cfg, mix, inp)
        def leaves(first):
            return {"grad": kind.leaf_gaps(first["grad"], ref["grad"], ref["grad"]),
                    "change": kind.leaf_gaps(first["change"], ref["change"], ref["grad"]),
                    "norms": {part: {k: float(v.double().norm()) for k, v in first[part].items()}
                              for part in ("grad", "change")},
                    "losses": first["losses"]}

        first = kind.setup(family, cfg, mix, inp)["first"]
        emit("program", kind.compare(first, ref))
        out[-1]["leaves"] = leaves(first)
        out[-1]["reference"] = {"norms": {part: {k: float(v.double().norm()) for k, v in
                                                 ref[part].items()} for part in ("grad", "change")},
                                "losses": ref["losses"]}
        if control:
            ctrl = kind.reference_steps(ref_family, cfg, mix, inp, precise=False)
            emit("control", kind.compare(ctrl, ref))
            out[-1]["leaves"] = leaves(ctrl)
        for f in fault_kinds:
            with faults.plant(f):
                emit(f, kind.compare(kind.setup(family, cfg, mix, inp)["first"], ref))
    else:
        def run():
            state = kind.setup(family, cfg, mix, inp)
            kind.window(state, seconds, time.perf_counter, sync)
            return state

        refs = {}

        def ref(k, precise=True):
            if precise and k in refs:
                return refs[k]
            a = kind.reference_answer(ref_family, cfg, inp, k % mix["draws"], precise)
            if precise:
                refs[k] = a
            return a

        def worst(answers, picks):
            gaps = [kind.compare_one(answers[k], ref(k)) for k in picks]
            z = [float(((answers[k][0].double() - ref(k)[0]).abs() / ref(k)[1].sqrt()).max())
                 for k in picks]
            rv = [float(((answers[k][1].double() - ref(k)[1]).abs() / ref(k)[1]).max())
                  for k in picks]
            return {"mean": max(g[0] for g in gaps), "var": max(g[1] for g in gaps),
                    "mean_z": max(z), "var_rel": max(rv)}

        state = run()
        picks = kind.sample(state, mix, seed)
        emit("program", worst(state["answers"], picks))
        if control:
            emit("control", worst({k: ref(k, precise=False) for k in picks}, picks))
        for f in fault_kinds:
            with faults.plant(f):
                state = run()
            emit(f, worst(state["answers"], kind.sample(state, mix, seed)))
    del inp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from dis_project_tpu_torch.ops.precision import default_device

    default_device("cuda")
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        kinds = faults.KINDS if seed in args.fault_seeds else ()
        for row in readings(cell, seed, "cuda", seed in args.control_seeds, kinds,
                            args.seconds):
            print(json.dumps(dict(row, s=round(time.perf_counter() - t0, 2))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
