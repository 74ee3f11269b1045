"""Run configuration and CLI flags of the port — the subset of
``dis_project_tpu/config.py`` that the ported routes use."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

PORTED_PRESETS = ("p53", "dense10k")
# The JAX package's other presets; the CLI names them and refuses them.
NOT_PORTED_PRESETS = ("p53-replicates", "alfi-parity", "sparse100k")

# Exact-path jitter (reference src/main.py:41).
EXACT_JITTER = 1e-4


@dataclasses.dataclass
class RunConfig:
    # p53 — canonical single-replicate exact pipeline;
    # dense10k — synthetic genes x timepoints exact-GP stress run.
    preset: str = "p53"
    seed: int = 0
    synth_genes: int = 50
    synth_timepoints: int = 200
    num_iters: int = 150
    # f64 (parity tier) unless --no-x64 (f32, the performance tier)
    x64: bool = True
    # None = the card; "cpu" runs the port on the CPU
    device: Optional[str] = None


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    d = RunConfig()
    parser.add_argument("--preset", default=d.preset,
                        choices=PORTED_PRESETS + NOT_PORTED_PRESETS,
                        help="p53 (canonical) or dense10k (N = genes x "
                        "timepoints exact stress run); the other presets are "
                        "not yet ported")
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--synth-genes", type=int, default=d.synth_genes,
                        help=f"dense10k gene count (default {d.synth_genes})")
    parser.add_argument("--synth-timepoints", type=int, default=d.synth_timepoints,
                        help=f"dense10k timepoint count (default {d.synth_timepoints})")
    parser.add_argument("--num-iters", type=int, default=d.num_iters,
                        help=f"Adam steps (default {d.num_iters})")
    parser.add_argument("--no-x64", action="store_true",
                        help="run in float32 (default float64)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs on the CPU)")


def config_from_args(args: argparse.Namespace) -> RunConfig:
    return RunConfig(
        preset=args.preset,
        seed=args.seed,
        synth_genes=args.synth_genes,
        synth_timepoints=args.synth_timepoints,
        num_iters=args.num_iters,
        x64=not args.no_x64,
        device=args.device,
    )
