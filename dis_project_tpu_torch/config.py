"""Run configuration and CLI flags of the port — the subset of
``dis_project_tpu/config.py`` that the ported routes use, with the JAX
package's names, defaults and choices."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from dis_project_tpu_torch.ops.odeint import RESPONSE_NAMES

PORTED_PRESETS = ("p53", "p53-replicates", "alfi-parity", "dense10k", "sparse100k")
# Dense-route engines: 'cholesky' (the row/gridded exact route), 'cg'
# (ops.iterative) and 'ss' (ops.statespace); the JAX package's 'dist' is
# not ported.
PORTED_ENGINES = ("cholesky", "cg", "ss")
NOT_PORTED_ENGINES = ("dist",)
FORCE_KERNELS = ("rbf", "matern12", "matern32", "matern52")
# Model families: the first-order, second-order, multi-force and
# delayed-response exact families and the nonlinear-response family (MAP and
# Laplace; its extended-Kalman marginal on dense10k).
PORTED_MODELS = ("simm", "simm2", "multisimm", "delaysimm", "nlfm")
# The nlfm route's default number of MAP steps (every other route: 150).
NLFM_NUM_ITERS = 2000

# Exact-path jitter (reference src/main.py:41).
EXACT_JITTER = 1e-4
# Sparse-path jitter (tighter: SparseSIMM applies its own float32 Kuu floor).
SPARSE_JITTER = 1e-6
# sparse100k's synthetic shape when --synth-genes / --synth-timepoints are
# not given (BASELINE config 5: 100 x 1000, N = 1e5).
SPARSE_GENES, SPARSE_TIMEPOINTS = 100, 1000


@dataclasses.dataclass
class RunConfig:
    # p53 — canonical single-replicate exact pipeline;
    # p53-replicates — all three replicates (or an ablation) through run;
    # alfi-parity — the port against the independent torch validation stack;
    # dense10k — synthetic genes x timepoints exact-GP stress run;
    # sparse100k — synthetic N = 1e5 sparse variational run.
    preset: str = "p53"
    # model family: simm (first-order exact) | simm2 (second-order exact)
    # | multisimm (R independent latent forces) | delaysimm (per-gene delays)
    # | nlfm (first-order with a nonlinear response g(f): MAP + Laplace)
    model: str = "simm"
    # multisimm routes: number of latent forces
    num_forces: int = 2
    # nlfm route: response nonlinearity and quadrature grid size
    response: str = "exp"
    num_quad: int = 97
    # data
    replicate: Optional[int] = 0  # None = all three replicates
    selected_genes: Optional[Sequence[str]] = None
    data_dir: str = "data"
    data_source: str = "auto"  # auto | csv | synthetic
    seed: int = 0
    synth_genes: int = 50
    synth_timepoints: int = 200
    # sparse variational settings (sparse100k preset)
    num_inducing: int = 128
    batch_size: int = 2048
    num_epochs: int = 25
    # dense10k MLL engine: cholesky (exact) | cg (batched CG + SLQ) | ss
    # (state-space Kalman engine, O(T))
    mll_engine: str = "cholesky"
    # state-space engine: the temporally-sharded filter (not yet ported)
    ss_shard: bool = False
    # state-space engine force prior: rbf (order-10 SDE) or an exact Matern
    force_kernel: str = "rbf"
    # state-space engine: freeze the Kalman gain after this many exact steps
    stationary_after: Optional[int] = None
    # sparse path: data-parallel SVI (not yet ported)
    dp_shard: bool = False
    # None = the path default: 1e-4 exact (exact_jitter), 1e-6 sparse
    # (sparse_jitter)
    jitter: Optional[float] = None
    # tie B/S/D across genes (shared-vs-per-gene kinetics ablation)
    shared_kinetics: bool = False
    # training (reference canonical run: adam lr=0.01, 150 iters, f64)
    num_iters: int = 150
    learning_rate: float = 0.01
    optimizer: str = "adam"
    fix_params: bool = True
    num_steps_per_epoch: int = 1000
    track_parameters: bool = False
    # f64 (parity tier) unless --no-x64 (f32, the performance tier)
    x64: bool = True
    # None = the card; "cpu" runs the port on the CPU
    device: Optional[str] = None
    # reporting
    out_dir: str = "plots"
    save_name: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    metrics_path: Optional[str] = None  # JSONL per-step metrics
    # post-training HMC draws over the hyperparameters (0 = off); seeds the
    # chain at the trained point
    posterior_samples: int = 0
    # independent HMC chains, advanced in lockstep; > 1 adds split-R-hat /
    # ESS convergence diagnostics
    posterior_chains: int = 1

    @property
    def exact_jitter(self) -> float:
        """--jitter, or the exact-path default 1e-4 when not given."""
        return self.jitter if self.jitter is not None else EXACT_JITTER

    @property
    def sparse_jitter(self) -> float:
        """--jitter, or the sparse-path default 1e-6 when not given."""
        return self.jitter if self.jitter is not None else SPARSE_JITTER


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    d = RunConfig()
    parser.add_argument("--preset", default=d.preset,
                        choices=PORTED_PRESETS,
                        help="p53 (canonical), p53-replicates (all replicates), "
                        "alfi-parity (the torch validation stack's gates), "
                        "dense10k (N = genes x timepoints exact stress run) or "
                        "sparse100k (minibatch SVI on a sparse variational bound)")
    parser.add_argument("--model", default=d.model,
                        choices=PORTED_MODELS,
                        help="model family: 'simm' (first-order exact), 'simm2' "
                        "(second-order spring-damper exact), 'multisimm' (R "
                        "independent latent forces), 'delaysimm' (per-gene "
                        "transcriptional delays) or 'nlfm' (nonlinear response)")
    parser.add_argument("--num-forces", type=int, default=d.num_forces,
                        help="multisimm route: number of independent "
                        f"latent forces (default {d.num_forces})")
    parser.add_argument("--response", default=d.response, choices=RESPONSE_NAMES,
                        help="nlfm route: response nonlinearity g(f) "
                        "(default exp, Lawrence et al. 2006 s5's "
                        "positivity-constrained model)")
    parser.add_argument("--num-quad", type=int, default=d.num_quad,
                        help="nlfm route: force quadrature grid size "
                        f"(default {d.num_quad})")
    parser.add_argument("--replicate", type=str, default="0",
                        help="replicate index 0-2, or 'all'")
    parser.add_argument("--genes", type=str, default=None,
                        help="comma-separated gene subset, e.g. p21,DDB2")
    parser.add_argument("--data-dir", default=d.data_dir)
    parser.add_argument("--data-source", default=d.data_source,
                        choices=["auto", "csv", "synthetic"])
    parser.add_argument("--seed", type=int, default=d.seed)
    # Default None: sparse100k has its own shape.
    parser.add_argument("--synth-genes", type=int, default=None,
                        help=f"synthetic gene count (default {d.synth_genes}; "
                        f"sparse100k: {SPARSE_GENES})")
    parser.add_argument("--synth-timepoints", type=int, default=None,
                        help=f"synthetic timepoint count (default {d.synth_timepoints}; "
                        f"sparse100k: {SPARSE_TIMEPOINTS})")
    parser.add_argument("--num-inducing", type=int, default=d.num_inducing)
    parser.add_argument("--batch-size", type=int, default=d.batch_size)
    parser.add_argument("--num-epochs", type=int, default=d.num_epochs)
    parser.add_argument("--mll-engine", default=d.mll_engine,
                        choices=PORTED_ENGINES + NOT_PORTED_ENGINES,
                        help="dense10k MLL engine: 'cholesky' (exact), 'cg' "
                        "(batched CG + stochastic Lanczos quadrature) or 'ss' "
                        "(state-space Kalman engine, O(T) in timepoints via an "
                        "order-10 SDE approximation of the force prior); 'dist' is "
                        "not yet ported")
    parser.add_argument("--ss-shard", action="store_true",
                        help="state-space engine: the temporally-sharded filter "
                        "(not yet ported)")
    parser.add_argument("--force-kernel", default=d.force_kernel, choices=FORCE_KERNELS,
                        help="state-space engine force prior: 'rbf' (order-10 SDE "
                        "approximation) or an exact Matern prior (requires "
                        "--mll-engine ss)")
    parser.add_argument("--stationary-after", type=int, default=d.stationary_after,
                        help="state-space engine: freeze the Kalman gain after this "
                        "many exact warmup steps (requires --mll-engine ss)")
    parser.add_argument("--dp-shard", action="store_true",
                        help="sparse path: data-parallel SVI (not yet ported; "
                        "requires --preset sparse100k)")
    parser.add_argument("--jitter", type=float, default=d.jitter,
                        help="diagonal jitter (default: 1e-4 exact paths, "
                        "1e-6 sparse path)")
    # Default None: the nlfm route's MAP takes NLFM_NUM_ITERS steps.
    parser.add_argument("--num-iters", type=int, default=None,
                        help=f"optimisation steps (default {d.num_iters}; "
                        f"nlfm route: {NLFM_NUM_ITERS})")
    parser.add_argument("--learning-rate", type=float, default=d.learning_rate)
    parser.add_argument("--optimizer", default=d.optimizer, choices=["adam", "lbfgs"])
    parser.add_argument("--no-fix-params", action="store_true",
                        help="disable the p21 identifiability clamp")
    parser.add_argument("--shared-kinetics", action="store_true",
                        help="tie basal/sensitivity/decay across genes "
                        "(ablation; implies --no-fix-params)")
    parser.add_argument("--steps-per-epoch", type=int, default=d.num_steps_per_epoch)
    parser.add_argument("--track-parameters", action="store_true")
    parser.add_argument("--no-x64", action="store_true",
                        help="run in float32 (default float64)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs on the CPU)")
    parser.add_argument("--out-dir", default=d.out_dir)
    parser.add_argument("--save-name", default=None)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                        "--checkpoint-dir (params + optimizer state)")
    parser.add_argument("--metrics-path", default=None)
    parser.add_argument("--posterior-samples", type=int, default=d.posterior_samples,
                        help="after training, draw this many HMC posterior "
                        "samples over the hyperparameters (exact-MLL "
                        "likelihood, flat prior in constrained space) and "
                        "report credible intervals for the kinetics")
    parser.add_argument("--posterior-chains", type=int, default=d.posterior_chains,
                        help="independent HMC chains, advanced in lockstep "
                        "(> 1 adds split-R-hat / ESS convergence "
                        f"diagnostics; default {d.posterior_chains})")


def config_from_args(args: argparse.Namespace) -> RunConfig:
    sparse = args.preset == "sparse100k"
    return RunConfig(
        preset=args.preset,
        model=args.model,
        num_forces=args.num_forces,
        response=args.response,
        num_quad=args.num_quad,
        replicate=None if args.replicate == "all" else int(args.replicate),
        selected_genes=args.genes.split(",") if args.genes else None,
        data_dir=args.data_dir,
        data_source=args.data_source,
        seed=args.seed,
        synth_genes=(args.synth_genes if args.synth_genes is not None
                     else SPARSE_GENES if sparse else RunConfig.synth_genes),
        synth_timepoints=(args.synth_timepoints if args.synth_timepoints is not None
                          else SPARSE_TIMEPOINTS if sparse else RunConfig.synth_timepoints),
        num_inducing=args.num_inducing,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        mll_engine=args.mll_engine,
        ss_shard=args.ss_shard,
        force_kernel=args.force_kernel,
        stationary_after=args.stationary_after,
        dp_shard=args.dp_shard,
        jitter=args.jitter,
        shared_kinetics=args.shared_kinetics,
        num_iters=(args.num_iters if args.num_iters is not None
                   else NLFM_NUM_ITERS if args.model == "nlfm" else RunConfig.num_iters),
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        fix_params=not args.no_fix_params,
        num_steps_per_epoch=args.steps_per_epoch,
        track_parameters=args.track_parameters,
        x64=not args.no_x64,
        device=args.device,
        out_dir=args.out_dir,
        save_name=args.save_name,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        metrics_path=args.metrics_path,
        posterior_samples=args.posterior_samples,
        posterior_chains=args.posterior_chains,
    )
