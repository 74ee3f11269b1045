"""Readings for the limits of a cell's comparison, at the cell's own size.

    python3 lfmbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--fault-seeds 11,12,13] [--seconds 3]

For each seed, one JSON line a reading, each against the float64
reference, as the cell's traffic kind takes them (``traffic/<kind>.py``'s
``readings``): ``program``, a sound run of the timed path (set-up through
the fit's own call; for a prediction mix a window of ``--seconds`` at the
cell's own load, the checked requests drawn as a run draws them); on the
control seeds ``control``, the reference computed in float32 with TF32
products put in the program's place; on the fault seeds each fault of
``lfmbench.faults`` planted in the program, at the sites of the cell's
family. The benchmark's own runs do not run this.
"""

import argparse
import gc
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lfmbench import faults, harness, inputs  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _family(cell):
    return importlib.import_module(f"lfmbench.families.{cell.cfg['family']}")


def readings(cell, seed, device, control=False, fault_kinds=(), seconds=3.0):
    """The readings of one seed: a list of ``{"seed", "reading", numbers}``,
    as the cell's traffic kind (``traffic/<kind>.py``'s ``readings``) reads
    them."""
    import torch

    cfg, mix = cell.cfg, cell.mix
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
        return out[-1]

    kind.readings(emit, _family(cell), ref_family, cfg, mix, inp, seed, control, fault_kinds,
                  seconds, sync)
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
        kinds = faults.kinds(_family(cell)) if seed in args.fault_seeds else ()
        for row in readings(cell, seed, "cuda", seed in args.control_seeds, kinds,
                            args.seconds):
            print(json.dumps(dict(row, s=round(time.perf_counter() - t0, 2))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
