#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dis_project_tpu_torch``) on one H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX or of the
JAX package. ``python3 chip_smoke.py --times ROOT`` only times K1, K2,
K2's backward, ``blocked_cholesky`` and the dense10k Cholesky route's step
at the dense10k shapes with the package under ``ROOT`` (:func:`times`): run
it on a parent tree and on this one, in turns, to compare them. Phases (each raises on failure):

1. Build the kernels from ``dis_project_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together); print the build seconds, the card's
   ``nvidia-smi`` name and power limit, and every kernel's registers, local
   memory (spills) and static shared memory (``[kernels] attrs``).
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with the tolerance stated beside each check, and
   time kernel, plain version and the library call (where one exists) with
   CUDA events (median of repeats; K1, K2 and K2's backward also back to
   back, :func:`back_to_back_ms`). K1 (``[K1]``) is timed at the dense
   latent posterior's 1e4 x 200 'xf' and the dense expression posterior's
   1e4 x 5000 'xx', and held, every kind in both types, to its two plain
   versions (the closed form and ``cuda_gram.cross_covariance_hoisted``,
   the hoisted arithmetic it implements) on those shapes, on the canonical
   rows against 100 and 500 points, and on ragged row sets (1037 against
   53 and 198, out-of-range genes, force rows, and 50 genes at random).
   K2 (``[K2]``) also on ragged N = 1037
   and 35 for every kind and dtype, and with 50 genes at random (tiles with
   more distinct decays than its tables take). K2's backward kernel (``[K2
   bwd]``) is held per parameter group (decay, sens, lengthscale) to the
   float64 plain VJP: in float32 at N = 1e4 ('xx') on the dense10k MLL's own
   cotangent at the init point, from each engine, and on a random
   non-symmetric one, at most twice the float32 plain VJP's error; in
   float64 on 'mixed' rows at N = 1000 and 1037 and on the canonical N = 35
   rows, within 1e-10; every other kind and dtype at N = 1037 under the same
   limits, also with 50 genes. The plain hoisted arithmetic that K2 and its
   backward implement (``[hoisted]``, ``cuda_gram.gram_sym_hoisted``) is held
   to the plain closed form at N = 1037 and 35, every kind and dtype. K3 (3xTF32
   tensor-core products) is held to its plain version (rel 1e-4) and to an
   f64 product of the same Li, at most twice the plain version's error, at
   N = 1e4 and at the ragged N = 1037 (its 4-byte copies). K3, K4 and K5
   take inputs made from the
   real dense10k Σ at the init parameters; K4 and K5 are held to an f64
   factor computed on the card: their error may be at most twice the plain
   float32 version's; K4 at B = 128 also prints its phases from its own
   %globaltimer stamps and the wrapper's host time per call (``[K4
   phases]``); K5 (a thread-block cluster) at B in {32, 96, 100, 128, 256,
   512}, with its cluster size, timed at every cluster size whose shared
   memory fits, and a block with a negative pivot giving NaN without
   hanging. K6 and K7 factor that whole Σ (N = 1e4): each within twice
   cuSOLVER's distance from the f64 factor of its plain version, its
   reconstruction at most twice cuSOLVER's at the default block, an
   exactly zero upper triangle, two calls bitwise equal, a non-PD Σ giving
   NaN without hanging, the error word 0 after every call; a time for each
   block in {128, 256, 512}; the diagonal chain's timeline from the
   kernels' own %globaltimer stamps, each link split into the TRSM below
   the previous diagonal tile, the lateness of the diagonal tile's own
   corrections, its last correction and its routine; each kernel's CTAs
   per SM. K7's factor must equal K6's bitwise at every block, and K7's
   under the JAX order (depth 0); K7's look-ahead depth is swept (``[K7]
   d=...``), and an order that defers far tiles instead is timed beside it.
3. The main paths, each driven with every launch count set to 0 just
   before it and read just after; each path's kernels must have launched
   (K2's backward on the golden fit and both dense routes), and the plain
   VJP for the rows' gradient (``cuda_gram.PLAIN_X_GRADS``) never, except
   on the delay route, once per gradient evaluation (phase 8):
   - the canonical route (``main.fit_and_predict``, p53, float64, with
     ``--track-parameters``, ``--metrics-path`` and ``--checkpoint-dir`` in
     a temporary directory) and the golden row-path fit (``trainer.fit``)
     held to ``tests/test_golden.py``; ``[canonical report]`` checks the
     metrics, the checkpoint and the trace, and runs ``main.report`` and
     checks its four plots where matplotlib is installed (else it says so);
   - ``[resume]``: 150 canonical steps on the card (float64) straight
     through, twice, against 75 steps, a checkpoint file and 75 resumed
     steps, and against ``fit_checkpointed`` every 50 steps: history, raw
     parameters, Adam moments and guard carry bitwise;
   - ``[lbfgs]``: the p53 route with ``--optimizer lbfgs --num-iters 30``,
     its final loss within rel 1e-8 of JAX's (``LBFGS30_FINAL_LOSS``);
   - ``[p53-replicates]``: 150 steps on all three replicates (N = 105),
     the final loss within 1e-8 of JAX's (``P53_REPLICATES_FINAL_LOSS``),
     K1 and K2 in its posteriors;
   - ``[alfi-parity]``: ``main.alfi_parity`` (100 iterations) and its three
     gates, "Cross-framework parity OK";
   - the blocked engine at N = 1e4 on the real Σ: ``blocked_cholesky_t``
     (K4), ``blocked_cholesky(diag='pallas')`` (K5) and
     ``diag='pallas_inv'`` (K4), each reconstructing Σ no worse than twice
     cuSOLVER's factor (the K5 one also timed), and ``inv_from_factor_tril``
     from the factor's diagonal inverses (K3) against its plain version;
   - the fused factorisations ``fused_cholesky`` (K6) and
     ``fused_cholesky2`` (K7) at N = 1e4 on the real Σ;
   - the dense10k route (``main.run_dense``, 50 x 200 = 1e4, float32,
     10 Adam steps), whose ``'auto'`` engine is ``'xla'``: per-step ms,
     their spread, peak memory (the run's own, above what the script holds);
   - ``latent_predict`` at N = 1e4 on the 200-point training grid (K1
     'xf');
   - ``multi_gene_predict`` at N = 1e4 on ``main.run``'s 100-point grid
     for all 50 genes (K1 'xx' at 1e4 x 5000, K2 at 1e4 and 5000): mean and
     covariance diagonal held to the same call through the plain versions
     in float32 and in float64, the phase's time, its stages and K1's share;
   - the same 10 steps on the same data through
     ``ExactSIMM(chol_impl='blocked')``, with run_dense's training loop.
4. Each dense route's first step against the plain float32 path (loss rel
   1e-5, gradient direction cosine >= 0.999), its stage breakdown, the
   blocked factorisation's host enqueue time beside its device time, and
   the ``[auto]`` line: both step medians, whether the blocked step is
   faster by more than the step spread, and what ``'auto'`` resolves to.
5. ``[dense cg]`` (:func:`dense_cg`): ``main.run_dense`` with ``--mll-engine
   cg`` at 50 x 200 = 1e4, float32, 10 steps: K2 and K2's backward every
   step, the plain VJP never; step ms (median of steps 2-10, interquartile
   spread), CG iterations and converged columns per step with the host
   microseconds per CG iteration, peak memory, stage times at the init
   point, the recovery correlations; the first step with the same probes
   held to the plain float32 versions and to float64 on the card (loss
   within 3x the plain path's distance from float64 of the plain path, at
   most 2x that distance and 1e-3 from float64, gradient cosine >= 0.999
   to the plain path); the CG estimate at
   init within rel 0.05 of the exact MLL. An ``[engines]`` line sets its
   step beside the Cholesky route's.
6. The state-space engine (``ops/statespace.py``; no hand-written kernel
   runs on it, so its drives require no launch): ``[ss parity]``
   (:func:`ss_parity`, float64: ``lfm_mll_ss`` against
   ``ExactSIMM.mll_gridded`` on a p53-shaped draw at orders 8, 10, 12,
   errors under 2e-2, 4e-3, 6e-4 and falling, and at the dense10k shape
   within 5e-3 x max(1, |MLL|) with a raw-gradient cosine >= 0.999);
   ``[dense ss]`` (:func:`dense_ss`: ``main.run_dense --mll-engine ss`` at
   50 x 200, order 10, float32, DENSE_STEPS steps: losses, step ms (median
   of steps 2-10, interquartile spread), host microseconds per filter step,
   host share, peak memory, recovery; the first step against float64 on
   the card, loss rel 1e-4 and gradient cosine 0.999, its host syncs
   counted by ``torch.cuda.set_sync_debug_mode``; stage ms with CUDA
   events and the device's busy time from ``torch.profiler``);
   ``[ss variants]`` (``--force-kernel matern32`` and ``--stationary-after``
   16, 32, 64, three steps each, finite; the tail's float64 error against
   the exact filter falling with K, zero at K = T - 1); ``[ss predict]``
   (bridge against union in float64 and float32 at the trained parameters,
   the force's correlation with the generating one); ``[ss scale]`` (one
   value and gradient at T = 2000, N = 1e5, with and without
   ``stationary_after=256``). ``[engines]`` sets the ss step beside cg and
   xla. Then (:func:`ss_engine_phases`, their total wall seconds on a line
   of its own): ``[ss schedules]`` and ``[ss schedules scale]`` (each
   ``parallel=`` schedule of ``SS_SCHEDULES`` at T = 200 and 2000: step
   ms with spreads, levels, host us per level, device busy share, syncs;
   float64 and float32 agreement with the sequential filter), ``[ss
   predict schedules]`` (union and bridge under each smoother schedule
   against the sequential one, float64), ``[ss auto]`` (what
   ``parallel=None`` picks on the card and the measurement beside it),
   ``[ffbs]`` (64 joint posterior and prior draws against their moments),
   ``[streaming]`` (the series one arrival at a time: the ll against the
   batch MLL, us per arrival, no host sync per arrival) and ``[dense
   metrics]`` (``--metrics-path`` on each dense engine).
7. The second-order (spring-damper) family (:func:`simm2_phases`, their
   total wall seconds on a line of its own): ``[simm2 erf]`` (the complex
   erf on the card against ``scipy.special.erf`` over |Re| <= 26, |Im| <= 5
   where |erf| <= 1e6: complex128 1e-12 and complex64 8.6e-6, times
   max(1, |erf|); its analytic backward against a float64 central
   difference; host us and card ms of one call); ``[simm2 p53]``
   (``main.run_second_order``, 150 steps in float64 on the card and on the
   CPU: final loss rel 1e-6, first step rel 1e-10; wall, kinetics table,
   host syncs per step); ``[dense simm2]`` (``main.run_dense --model
   simm2`` at 50 x 200 = 1e4, float32, DENSE_STEPS steps through the table
   Gram, cuSOLVER and K3 once a step: step ms and spread, peak memory,
   finiteness, alpha/omega recovery; the first step within rel 1e-4 of
   float64 and within rel 1e-5 of the plain SYRK with a raw-gradient cosine
   >= 0.999; stage ms); ``[dense simm2 ss]`` (the same data through
   ``--mll-engine ss``, m = 110: step ms, syncs, device busy share, the
   smoothed force by union and bridge, float64 parity with the exact MLL
   within 5e-3 x max(1, |MLL|) and cosine >= 0.999).
8. The multi-force and delayed-response families (:func:`family_phases`,
   their total wall seconds on a line of its own): ``[multisimm p53]``
   (``main.run_multiforce``, R = 2, 150 float64 steps on the card and on
   the CPU: final loss rel 1e-6, first step rel 1e-10, the per-force
   posteriors (2, 100), no kernel launch; wall, host syncs per step);
   ``[dense multisimm ss]`` (``main.run_dense --model multisimm
   --mll-engine ss`` at 50 x 200, R = 2, m = 70, float32, DENSE_STEPS
   steps: step ms and spread, syncs, device busy share, peak memory, stage
   ms, the matched recovery; the first step within rel 1e-4 of float64; one
   Matern-3/2 loss and gradient finite; float64 against ``ExactMultiSIMM``
   on a 3 x 9 problem at orders 8 and 10, 2e-3 and 5e-4); ``[delay p53]``
   (``main.run_delay``, 150 float64 steps on the card and on the CPU, each
   in a temporary working directory: the ``[simm2 p53]`` limits; K2 and
   K2's backward once per gradient evaluation, K1 in the posterior, the
   rows' plain VJP (the delays' gradient) exactly once per gradient
   evaluation; K2, K2's backward and K1 within 1e-10 of their plain versions
   at the trained warped rows, timed; zero delays bitwise ``ExactSIMM``;
   the delay gradient within 1e-10 of the all-plain path); ``[dense delay
   ss]`` (``main.run_dense --model delaysimm --mll-engine ss`` at 50 x 200
   = 10,000 warped events, float32, DELAY_STEPS steps, DELAY_STEPS_SLOW
   when a step takes more than 5 s: step ms, syncs, busy share, peak
   memory, stage ms, gene 0's delay pinned; float64 on a 3 x 9 problem
   against ``ExactDelaySIMM`` at orders 8 and 12, 5e-3 and 2e-4, gradients
   5e-4, zero delays against ``lfm_mll_ss`` 1e-9). Every other path must
   run no plain VJP for the rows' gradient.
9. The sparse variational route (:func:`sparse_phases`, no hand-written
   kernel: every path launches none; their total wall seconds on a line of
   its own): ``[sparse]`` (``main.main --preset sparse100k --no-x64``:
   100 x 1000 = 1e5 rows, M = 128, B = 2048, 25 epochs; data and fit wall
   apart, the step's ms over 50 steps with CUDA events and their spread,
   host syncs per step (0 required, also over two epochs of
   ``svtrainer.fit``), device busy share, peak memory, the first and last
   epochs' mean neg-ELBO (the last below the first), the recovery
   correlation (|corr| >= 0.9)); ``[sparse parity]`` (20 ``svtrainer.fit``
   steps at 20 x 200 in float64, card against CPU on the same index
   tables: history and raw leaves rel 1e-8; float32's first step rel 1e-4
   of float64's); ``[sparse simm2]`` and ``[sparse multisimm]`` (R = 2)
   at full width with their epochs cut (``SPARSE_VARIANT_EPOCHS``; order
   2 also times one ``erf_complex`` call on a step's 2048 x 128
   arguments); ``[sparse bounds]`` (``collapsed_elbo``, ``optimal_q`` and
   the ELBO at its state, float64, card against CPU, and the ELBO at the
   optimal q against the collapsed bound).
10. The nonlinear-response family (:func:`nlfm_phases`, no hand-written
    kernel: every path launches none; their total wall seconds on a line
    of its own): ``[nlfm p53]`` (``main.run_nonlinear``, Q = 97, exp, the
    p21 pin, float64: its first 150 steps on the card and on the CPU, first
    step rel 1e-10, final loss rel 1e-6; ``laplace_posteriors`` card vs CPU
    at the CPU's MAP point rel 1e-8; then ``main.main(["--model",
    "nlfm"])`` once on the card, 2000 steps, or 500 when a warm step passes
    15 ms: wall, ms a step, host syncs a step, Laplace ms); ``[nlfm ekf
    parity]`` (``nlfm_mll_ekf``, its gradient and ``nlfm_predict_ekf``,
    each response, float64, G = 3, T = 9, card against CPU: 1e-10, the
    smoothed moments 1e-6; the identity against ``lfm_mll_ss`` at the JAX
    package's 5e-4 and 5e-6); ``[dense nlfm ss]`` (``main.main --preset
    dense10k --model nlfm --mll-engine ss --no-x64`` at 50 x 200, m = 60:
    3 steps, or 2 when a step passes 5 s; the first step rel 1e-4 of
    float64; step ms, host us per filter step, host syncs at T = 50 and
    200, peak memory, recovery; kernels per filter step and the busy share
    at T = 10).
11. Hamiltonian Monte Carlo (:func:`hmc_phases`, ``training.hmc`` on every
    ``--posterior-samples`` route; their total wall seconds on a line of
    its own): ``[hmc p53]`` (the canonical route's posterior, 20 draws, f64:
    one K2 and one K2 bwd per gradient, C x (1 + 24 x 2n), and the BMA
    band's K1 and two K2 a component; card against CPU on one table of
    draws made on the CPU, 8 warmup + 8 draws, within rel 1e-8; host syncs
    inside and outside the density's evaluations at n = 4 and 8 (the
    sampler's own must not grow) and peak memory (within 1 MiB); ms per
    gradient, trajectory and draw; 4 chains in lockstep with R-hat and ESS;
    step size 1e3: accept rate 0, no exception, no extra sync); ``[hmc nlfm
    p53]`` and ``[hmc delay p53]`` (the routes through ``run_nonlinear`` /
    ``run_delay``, then card against CPU on fed draws within rel 1e-8, ms a
    draw; the delay route one K2, K2 bwd and plain row VJP per gradient);
    ``[hmc dense ss]`` and ``[hmc dense delay ss]`` (dense10k, 50 x 200,
    f32, 10 leapfrog steps, n = 2 / 1: ms a draw and a gradient, peak
    memory, host syncs inside the likelihood's evaluations by source line
    and none outside them). Then the script's total time.
12. A ``kernels`` JSON line, then the ``ok`` JSON line last.
"""

import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, FP32
# (non-tensor-core) rate and the dense TF32 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

# FP32 operations per covariance entry by kind of the hoisted form that K1
# and K2 evaluate (csrc/simm_gram.cu, cuda_gram._hoisted_entries), each
# exp/erf counted as one operation (a lower bound: CUDA's erff is itself a
# short polynomial): 'xx': delta, delta / l, the four erf arguments, the two
# exp with their products, the four erf, A1 and A2, A1 - r_a e_b and
# A2 - r_b e_a, 1 / (D_a + D_b), U and S_a S_b U: 31; 'ff': delta^2, its
# quotient by 2l and the exp: 4; 'mixed': both, k_xf and k_fx from A1 and
# A2, the four flag weights and their sum: 55. K2 counts them per lower
# entry. K1 counts them per entry of all n m, and its 'xf' (k_xf = C_a A1)
# and 'fx' (C_b A2) entries: delta, delta / l, the two erf arguments, the
# exp with its product, the two erf, A1 (a sum and a product) and the
# product with C: 11. Both add OPS_PER_ROW once for each row (gamma, t / l,
# E = exp(gamma^2), e = exp(-D t), the two erf of r and r: 12), not once
# per tile as the kernels stage them.
OPS_PER_ENTRY = {"xx": 31, "ff": 4, "mixed": 55}
K1_OPS_PER_ENTRY = {**OPS_PER_ENTRY, "xf": 11, "fx": 11}
OPS_PER_ROW = 12
# The operations K2's backward needs per lower 'xx' entry, counted the same
# way for one reverse sweep over the hoisted form (cuda_gram.
# gram_sym_hoisted): its per-entry value without S_a S_b (29), the seed and
# the adjoints of U, E, A1, A2, r and e (14), the four erf derivatives
# (exp and three operations each: 16), the chain into decay (11 + 11, the
# per-row derivative factors read, not recomputed), lengthscale (20) and
# sensitivity (2) partials (108 in all), and the weighting by the
# cotangent and the five float64 sums (11): 119. Per row once (OPS_ROW_BWD):
# OPS_PER_ROW, r's derivatives in D and l and the per-row factors of the
# chain: 33. The forward-mode duals that the earlier kernel ran needed 275
# on their nonzero tangent slots alone.
OPS_PER_XX_ENTRY_BWD = 119
OPS_ROW_BWD = 33

# The dense10k configuration (BASELINE config 4 of the JAX package):
# 50 genes x 200 timepoints, N = 1e4; Adam steps driven on the card.
DENSE_GENES, DENSE_TIMEPOINTS, DENSE_STEPS = 50, 200, 10
# The dense delay route's steps (10,000 warped events a step), and its cut
# when one step takes more than 5 s.
DELAY_STEPS, DELAY_STEPS_SLOW = 5, 2

# Goldens computed on the CPU by the JAX package in float64 (its optax
# L-BFGS and Adam), pinned here and asserted against JAX by
# tests/test_torch_port_training.py and tests/test_torch_port_report.py:
# the p53 route (replicate 0, synthetic seed 0) with 30 L-BFGS iterations
# (its objective evaluations, guard and line search together, its first ten
# losses and its final loss), and the p53-replicates route (N = 105) after
# 150 Adam steps.
LBFGS30_CALLS = 72
LBFGS30_HISTORY_HEAD = [
    43.69118241179048, 18.687752727336484, 13.930060028948546, 11.398154122192821,
    7.989402965817799, 5.965952276514859, 2.422482293815669, -6.6852008494046515,
    -9.735185170405003, -10.393313275398313,
]
LBFGS30_FINAL_LOSS = -18.764290978317575
# L-BFGS amplifies the differences of two float64 gradient computations
# about tenfold every three iterations, and a thousandfold in its first
# update: the port on the CPU ends 3.3e-9 from JAX's final loss, JAX
# compiled at two XLA optimisation levels 1.8e-9 from itself, and the card
# (CUDA's erf and exp in the table Gram) 7.5e-7, its tenth loss 1.9e-7. The
# card's run is held to JAX's objective-evaluation count, its first two
# losses (before and after the first line search) within rel 1e-8 and its
# final loss within rel 1e-5.
LBFGS30_FINAL_RTOL = 1e-5
P53_REPLICATES_FINAL_LOSS = 0.43540257202783295


def bound_ms(n_bytes, n_ops, ops_per_s=FP32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn()`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn):
    """Median over 10 rounds of 20 calls of ``fn`` between one pair of
    CUDA events, per call: the card's time, with the host's time per call
    hidden behind it (one call between two events, :func:`cuda_ms`, waits
    for the host too)."""
    import torch

    calls = 20
    fn()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def times(root):
    """``--times ROOT``: K1 (1e4 x 200 'xf' against the latent grid and
    1e4 x 5000 'xx' against the expression grid), K2 and K2's backward, one
    call (:func:`cuda_ms`) and back to back, ``blocked_cholesky`` (float32,
    block 512, K5 diagonal steps) on the dense10k inputs at the init point
    (N = 1e4, 'xx', the 'xla' engine's MLL cotangent, the real Σ), and
    ``main.run_dense``'s Cholesky-route step (median of steps 2-10 and its
    interquartile spread), with the ``dis_project_tpu_torch`` under
    ``ROOT``: this checkout, or a parent unpacked with ``git archive``, so
    that two trees are timed by the same code. Prints one JSON line with the card's name and power
    limit."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import cuda_build, cuda_gram
    from dis_project_tpu_torch.ops import cuda_cholesky as cc
    from dis_project_tpu_torch.ops import mll as mll_ops
    from dis_project_tpu_torch.ops.precision import default_device
    from dis_project_tpu_torch.utils.test_grids import expression_grid, latent_grid

    dev, f32 = default_device(), torch.float32
    cuda_build.build(["simm_gram", "chol_block", "syrk"])
    G, T = DENSE_GENES, DENSE_TIMEPOINTS
    X, y, _ = train_arrays(port_main.synthetic_dense_data(G, T, seed=0, dtype=f32, device=dev),
                           dev, f32)
    p0 = simm.init_params(G, dtype=f32, device=dev)
    d, s, l = p0.decay, p0.sensitivity, p0.lengthscale
    model = simm.ExactSIMM(num_genes=G, jitter=cfg.EXACT_JITTER, canonical_rows=True)
    K = model.gram(p0, X, "xx").detach().requires_grad_(True)
    sigma = mll_ops.add_diagonal(K, model.jitter + p0.obs_stddev**2)
    loss = -mll_ops.mvn_logpdf(y, model.mean_function(p0, X), sigma, impl="xla")
    g = torch.autograd.grad(loss, K)[0]
    sigma = sigma.detach()
    del K, loss
    grid = latent_grid(T, dtype=f32, device=dev)
    egrid = expression_grid(G, 100, dtype=f32, device=dev)
    calls = {
        f"gram_rect {G * T}x{T} xf": lambda: cuda_gram.gram_rect_kernel(X, grid, d, s, l, "xf"),
        f"gram_rect {G * T}x{G * 100} xx": lambda: cuda_gram.gram_rect_kernel(
            X, egrid, d, s, l, "xx"),
        "gram_sym": lambda: cuda_gram.gram_sym_kernel(X, d, s, l, "xx"),
        "gram_sym_bwd": lambda: cuda_gram.gram_sym_bwd_kernel(X, d, s, l, "xx", g),
    }
    out = {name: {"ms": cuda_ms(fn), "back_to_back_ms": back_to_back_ms(fn)}
           for name, fn in calls.items()}
    out["blocked_cholesky f32 N=1e4 B=512 pallas"] = {"ms": cuda_ms(
        lambda: cc.blocked_cholesky(sigma, block=512, diag="pallas"), reps=5)}
    dense = port_main.run_dense(cfg.RunConfig(preset="dense10k", synth_genes=G,
                                              synth_timepoints=T, num_iters=DENSE_STEPS,
                                              x64=False, device="cuda"))
    step_ms = [1e3 * t for t in dense.step_seconds[1:]]
    q1, _, q3 = statistics.quantiles(step_ms, n=4)
    out["dense10k step, Cholesky route"] = {"median_ms": statistics.median(step_ms),
                                            "spread_ms": q3 - q1}
    print(json.dumps({"times": {"root": root, "card": nvidia_smi_line(), **out}}))


def canonical_report(canon, config, smi):
    """``[canonical report]``: the files of ``main.fit_and_predict`` (the
    metrics JSONL, the checkpoint, the parameter trace) and, where
    matplotlib is installed, ``main.report``'s four plots."""
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.training import checkpoint as ckpt

    n = config.num_iters
    with open(config.metrics_path) as f:
        records = [json.loads(line) for line in f]
    trace = canon.result.param_trace
    print(f"[canonical report] metrics records {len(records)}, last {records[-1]}; checkpoint "
          f"step {ckpt.latest_step(config.checkpoint_dir)}; parameter trace "
          f"{tuple(trace.decay.shape)} ({smi})")
    require(len(records) == n and records[-1]["loss"] == float(canon.result.history[-1]),
            "canonical metrics JSONL")
    require(ckpt.latest_step(config.checkpoint_dir) == n, "canonical checkpoint")
    require(tuple(trace.decay.shape) == (n, 5), "canonical parameter trace")
    if importlib.util.find_spec("matplotlib") is None:
        print("[canonical report] plots are not drawn on this machine: matplotlib is absent; "
              "tests/test_torch_port_report.py holds them on the CPU")
        return
    port_main.report(config, canon)
    pngs = sorted(os.listdir(config.out_dir))
    print(f"[canonical report] plots {pngs}")
    require(pngs == ["comparison.png", "gxpr.png", "lf.png", "param_trace.png"],
            f"canonical plots: {pngs}")


def canonical_variants(drive, smi):
    """The p53 route's other paths on the card, float64: bitwise resume
    (``[resume]``), L-BFGS (``[lbfgs]``), all replicates
    (``[p53-replicates]``) and the validation stack's gates
    (``[alfi-parity]``)."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data, dataset_3d
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.training import checkpoint as ckpt
    from dis_project_tpu_torch.training import trainer as tr

    dev, f64 = torch.device("cuda"), torch.float64
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = dataset_3d(data, dev, f64)
    model = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    grid = (data.timepoints, 1)

    def fit(n, **kw):
        return tr.fit(model, simm.init_params(5, dtype=f64, device=dev), X, y,
                      tr.TrainConfig(num_iters=n), gridded=grid, **kw)

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def same_run(a, hist, b):
        """History, raw parameters, Adam moments and guard carry, bitwise."""
        (ga, oa), sa, ca = a.guard_state
        (gb, ob), sb, cb = b.guard_state
        return (torch.equal(a.history, hist) and same(a.raw_params, b.raw_params)
                and a.opt_state.count == b.opt_state.count
                and same(a.opt_state.mu, b.opt_state.mu) and same(a.opt_state.nu, b.opt_state.nu)
                and same(ga, gb) and same(oa.mu, ob.mu) and same(oa.nu, ob.nu)
                and (sa, ca) == (sb, cb))

    def resume():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
        full, again = fit(150), fit(150)
        half = fit(75)
        ckpt.save(tmp, {"raw": half.raw_params, "opt_state": half.opt_state, "step": 75,
                        "guard": half.guard_state}, step=75)
        back = ckpt.restore(tmp, 75, template={"raw": half.raw_params,
                                               "opt_state": half.opt_state, "step": 0,
                                               "guard": half.guard_state})
        on_card = all(t.device.type == "cuda" for t in back["raw"])
        rest = fit(75, init_state=(back["raw"], back["opt_state"]), step_offset=back["step"],
                   init_guard=back["guard"])
        seg = tr.fit_checkpointed(model, simm.init_params(5, dtype=f64, device=dev), X, y,
                                  tr.TrainConfig(), os.path.join(tmp, "seg"),
                                  checkpoint_every=50, gridded=grid)
        shutil.rmtree(tmp)
        return full, again, half, rest, seg, on_card

    full, again, half, rest, seg, on_card = drive("resume", resume, ())
    checks = {
        "two straight runs": same_run(full, again.history, again),
        "75 + checkpoint + 75": same_run(full, torch.cat([half.history, rest.history]), rest),
        "fit_checkpointed every 50": same_run(full, seg.history, seg),
    }
    print(f"[resume] 150 canonical steps f64 on the card, bitwise (history, raw parameters, "
          f"Adam moments, guard carry): {checks}; restored onto the card: {on_card}; final loss "
          f"{float(full.history[-1])!r} ({smi})")
    require(all(checks.values()) and on_card, f"resume not bitwise: {checks}")

    # The route's objective evaluations, counted on the model class for
    # the length of this phase.
    calls = [0]
    mll_replicated = simm.ExactSIMM.mll_replicated

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return mll_replicated(self, *args, **kwargs)

    simm.ExactSIMM.mll_replicated = counted
    try:
        lb = drive("lbfgs", lambda: port_main.fit_and_predict(cfg.RunConfig(
            preset="p53", device="cuda", optimizer="lbfgs", num_iters=30)),
            ("gram_rect", "gram_sym"))
    finally:
        simm.ExactSIMM.mll_replicated = mll_replicated
    hist = lb.result.history.tolist()
    head = [abs(a - b) / abs(b) for a, b in zip(hist, LBFGS30_HISTORY_HEAD)]
    rel = abs(hist[-1] - LBFGS30_FINAL_LOSS) / abs(LBFGS30_FINAL_LOSS)
    print(f"[lbfgs] 30 iterations, f64: objective evaluations {calls[0]} (JAX's "
          f"{LBFGS30_CALLS}); first ten losses rel to JAX's {[f'{e:.1e}' for e in head]} (first "
          f"two: limit 1e-8); final loss {hist[-1]!r}, JAX's optax L-BFGS "
          f"{LBFGS30_FINAL_LOSS!r}, rel {rel:.3e} (limit {LBFGS30_FINAL_RTOL:g}) ({smi})")
    require(calls[0] == LBFGS30_CALLS, f"lbfgs objective evaluations {calls[0]}")
    require(max(head[:2]) <= 1e-8, f"lbfgs first losses off JAX's: rel {head[:2]}")
    require(rel <= LBFGS30_FINAL_RTOL, f"lbfgs final loss off JAX's: rel {rel}")

    rep = drive("p53-replicates", lambda: port_main.fit_and_predict(cfg.RunConfig(
        preset="p53-replicates", replicate=None, device="cuda")), ("gram_rect", "gram_sym"))
    final = float(rep.result.history[-1])
    err = abs(final - P53_REPLICATES_FINAL_LOSS)
    print(f"[p53-replicates] N={3 * 35}, 150 steps, f64: final loss {final!r}, JAX's "
          f"{P53_REPLICATES_FINAL_LOSS!r}, abs {err:.3e} (limit 1e-8) ({smi})")
    require(rep.data.num_replicates == 3 and err <= 1e-8, f"p53-replicates final loss: {err}")

    alfi_cfg = cfg.RunConfig(preset="alfi-parity", device="cuda", num_iters=100)
    parity = drive("alfi-parity", lambda: port_main.alfi_parity(alfi_cfg),
                   ("gram_rect", "gram_sym", "gram_sym_bwd"))
    print(f"[alfi-parity] |MLL delta| {parity.mll_delta:.3e} (gate 1e-6), fixed-params corr "
          f"{parity.corr0:.6f} (gate 0.999), trained corr {parity.corr:.4f} (gate 0.95) ({smi})")
    port_main.check_alfi_parity(parity)


def dense_cg(drive, smi):
    """``[dense cg]``: ``main.run_dense`` with ``--mll-engine cg`` at
    dense10k's full width (N = 1e4, float32, DENSE_STEPS steps) through K2
    and K2's backward every step; its step times, CG iterations and
    converged columns, peak memory and stages; its first step held to the
    plain float32 path and to float64 with the same probes; the CG estimate
    at init held to the exact MLL."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import cuda_gram, iterative
    from dis_project_tpu_torch.ops import mll as mll_ops
    from dis_project_tpu_torch.training import generic

    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    G, T, steps = DENSE_GENES, DENSE_TIMEPOINTS, DENSE_STEPS
    config = cfg.RunConfig(preset="dense10k", synth_genes=G, synth_timepoints=T,
                           num_iters=steps, x64=False, device="cuda", mll_engine="cg")
    held = {}

    def run():
        torch.cuda.reset_peak_memory_stats(dev)
        held["bytes"] = torch.cuda.memory_allocated(dev)
        return port_main.run_dense(config)

    dense = drive("dense cg", run, ("gram_sym", "gram_sym_bwd"))
    launches = dict(cuda_gram.LAUNCHES)
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    # Every step launches K2 and its backward once; the exact final loss K2 once more.
    require(launches["gram_sym"] == steps + 1 and launches["gram_sym_bwd"] == steps,
            f"dense cg launches {launches}")
    hist = dense.result.history.tolist()
    step_ms = [1e3 * t for t in dense.step_seconds]
    median = statistics.median(step_ms[1:])
    q1, _, q3 = statistics.quantiles(step_ms[1:], n=4)
    stats = dense.cg_stats
    iters = [st["cg_iters"] for st in stats]
    host_us = [1e6 * st["cg_host_s"] / st["cg_iters"] for st in stats]
    b, s, d = dense.data.params_ground_truth()
    corr_d = float(torch.corrcoef(torch.stack([dense.result.params.decay.double().cpu(),
                                               torch.as_tensor(d)]))[0, 1])
    corr_s = float(torch.corrcoef(torch.stack([dense.result.params.sensitivity.double().cpu(),
                                               torch.as_tensor(s)]))[0, 1])
    print(f"[dense cg] N={dense.X.shape[0]} losses {hist}; exact final loss "
          f"{dense.final_loss!r}; recovery corr(decay) {corr_d:.4f} corr(sensitivity) "
          f"{corr_s:.4f} ({smi})")
    print(f"[dense cg] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) {median:.3f}, "
          f"spread (interquartile) {q3 - q1:.3f}; peak memory {peak_gib:.3f} GiB (above the "
          f"{held['bytes'] / 2**30:.3f} GiB held before the run) ({smi})")
    print(f"[dense cg] CG iterations per step {iters} (cap {port_main.CG_MAX_ITERS}); columns "
          f"converged {[st['converged'] for st in stats]} of {stats[0]['columns']}; host us per "
          f"CG iteration (loop wall / iterations, one host sync each) "
          f"{[round(u, 1) for u in host_us]} ({smi})")
    require(all(math.isfinite(v) for v in hist) and math.isfinite(dense.final_loss),
            "dense cg losses not finite")

    # The first step again at the init point with the run's first probes
    # (the generator seeded seed + 1): through the kernels, through the
    # plain float32 versions, and in float64 on the card.
    N = dense.X.shape[0]
    probes = iterative.rademacher(torch.Generator().manual_seed(config.seed + 1),
                                  port_main.CG_PROBES, N, f32, dev)
    kmodel = dense.model
    pmodel = simm.ExactSIMM(num_genes=G, jitter=kmodel.jitter, canonical_rows=True,
                            kernels=False)
    raw0 = simm.unconstrain(simm.init_params(G, dtype=f32, device=dev))

    def first_step(model, X, y, z, raw):
        st = {}
        loss, grads = generic.value_and_grad(
            lambda r: -model.mll_iterative(simm.constrain(r), X, y, z, port_main.CG_LANCZOS_ITERS,
                                           port_main.CG_MAX_ITERS, st), raw)
        return float(loss), torch.cat([g.reshape(-1).double() for g in grads]), st

    lk, gk, stk = first_step(kmodel, dense.X, dense.y, probes, raw0)
    lp, gp, stp = first_step(pmodel, dense.X, dense.y, probes, raw0)
    l64, g64, st64 = first_step(kmodel, dense.X.double(), dense.y.double(), probes.double(),
                                type(raw0)(*(r.double() for r in raw0)))
    # The float32 CG/SLQ value sits ~7e-4 from float64 whichever Gram
    # feeds it (the f32 Krylov loops; a Gram an ulp off moves CG's stopping
    # iteration), so the kernels' loss is held as the expression posterior
    # holds its kernels: at most 2x the plain float32 path's distance from
    # the float64 value, and within 3x that distance of the plain path.
    rel_plain = abs(lk - lp) / abs(l64)
    cos = float(gk @ gp / (gk.norm() * gp.norm()))
    rel64, rel64_plain = abs(lk - l64) / abs(l64), abs(lp - l64) / abs(l64)
    cos64 = float(gk @ g64 / (gk.norm() * g64.norm()))
    print(f"[dense cg] first step, same probes: loss kernels {lk!r} plain f32 {lp!r} f64 on "
          f"the card {l64!r}; kernels vs plain {rel_plain:.3e} (limit 3x the plain's distance "
          f"from f64: {3 * rel64_plain:.3e}); vs f64: kernels {rel64:.3e} (limits 1e-3 and 2x "
          f"the plain's), plain f32 {rel64_plain:.3e}; gradient cosine vs plain {cos:.6f} (limit "
          f"0.999), vs f64 {cos64:.6f}; CG iterations kernels {stk['cg_iters']} plain "
          f"{stp['cg_iters']} f64 {st64['cg_iters']}; run's step 1 {hist[0]!r} ({smi})")
    require(rel_plain <= 3 * rel64_plain, f"dense cg first-step loss vs plain: {rel_plain}")
    require(cos >= 0.999, f"dense cg first-step gradient vs plain: cosine {cos}")
    require(rel64 <= 1e-3 and rel64 <= 2 * rel64_plain,
            f"dense cg first-step loss vs f64: {rel64} (plain {rel64_plain})")
    require(abs(lk - hist[0]) <= 1e-5 * abs(hist[0]), "run_dense cg step 1 loss")

    # The CG estimate at init against the exact MLL (tests/test_iterative.py:118).
    p0 = simm.constrain(raw0)
    with torch.no_grad():
        exact = float(kmodel.mll(p0, dense.X, dense.y))
    rel_exact = abs(-lk - exact) / abs(exact)
    print(f"[dense cg] CG/SLQ estimate at init {-lk!r} vs exact MLL {exact!r}: rel "
          f"{rel_exact:.3e} (limit 0.05) ({smi})")
    require(rel_exact <= 0.05, f"dense cg estimate vs exact MLL: {rel_exact}")

    # Where one step's device time goes, each stage timed alone with CUDA
    # events at the init point (the host syncs of CG's stopping test included).
    with torch.no_grad():
        X, y = dense.X, dense.y
        dd, ss, ll = p0.decay, p0.sensitivity, p0.lengthscale
        K = cuda_gram.gram_sym_kernel(X, dd, ss, ll, "xx")
        sigma = mll_ops.add_diagonal(K, kmodel.jitter + p0.obs_stddev**2)
        yc = y - kmodel.mean_function(p0, X)
        rhs = torch.cat([yc[:, None], probes.T], dim=1)
        sols, _ = iterative.batched_cg(sigma, rhs, max_iters=port_main.CG_MAX_ITERS)
        alpha, zsols = sols[:, 0].contiguous(), sols[:, 1:].contiguous()

        def d_sigma():
            est = zsols @ probes
            out = est + est.T
            del est
            out.mul_(0.25 / probes.shape[0])
            out.addr_(alpha, alpha, alpha=-0.5)
            return out

        dsig = d_sigma()
        stages = {
            "gram K2": lambda: cuda_gram.gram_sym_kernel(X, dd, ss, ll, "xx"),
            "add_diagonal": lambda: mll_ops.add_diagonal(K, kmodel.jitter + p0.obs_stddev**2),
            "SLQ (Lanczos + eigh)": lambda: iterative.slq_logdet(
                sigma, probes, port_main.CG_LANCZOS_ITERS),
            "CG": lambda: iterative.batched_cg(sigma, rhs, max_iters=port_main.CG_MAX_ITERS),
            "N x N estimate and d_sigma": d_sigma,
            "gram backward K2 bwd": lambda: cuda_gram.gram_sym_bwd_kernel(
                X, dd, ss, ll, "xx", dsig),
            "exact final MLL (K2 + cuSOLVER)": lambda: kmodel.mll(p0, X, y),
        }
        stage_ms = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
    step_sum = sum(v for k, v in stage_ms.items() if not k.startswith("exact"))
    print(f"[dense cg] stage ms {json.dumps(stage_ms)}; sum of the step's stages "
          f"{step_sum:.3f} vs step median {median:.3f} ({smi})")
    return dict(median=median, spread=q3 - q1, peak_gib=peak_gib, corr=(corr_d, corr_s))


def _corr(a, b):
    import torch

    return float(torch.corrcoef(torch.stack([torch.as_tensor(a).double().cpu(),
                                             torch.as_tensor(b).double().cpu()]))[0, 1])


def _cosine(ga, gb):
    return float(ga @ gb / (ga.norm() * gb.norm()))


def _flat_grad(grads):
    import torch

    return torch.cat([g.reshape(-1).double() for g in grads])


def count_syncs(fn):
    """``(fn(), n)``: n host synchronisations PyTorch reports during
    ``fn()`` (``torch.cuda.set_sync_debug_mode('warn')``; the mode's own
    one-time notice that it is a prototype is not a synchronisation)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                    for w in caught)


def count_sampler_syncs(fn):
    """``(fn(), per_evaluation, outside, where)``: the host synchronisations
    (as :func:`count_syncs` counts them) of ``fn()``, split into those inside
    each log-density evaluation of ``training.hmc`` (its value and gradient,
    one entry a call) and those outside them, the sampler's own; ``where``
    counts the outside ones and the evaluations' by the source line that
    raised them."""
    import collections
    import warnings

    import torch

    from dis_project_tpu_torch.training import hmc

    real = hmc._value_and_grad
    per_eval, where = [], collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seen = {"n": 0, "i": 0}

        def syncs():
            for w in caught[seen["i"]:]:
                if "synchroniz" in str(w.message) and "prototype" not in str(w.message):
                    seen["n"] += 1
                    where[f"{os.path.basename(w.filename)}:{w.lineno}"] += 1
            seen["i"] = len(caught)
            return seen["n"]

        def counted(*args, **kwargs):
            vg = real(*args, **kwargs)

            def wrapped(q):
                before = syncs()
                out = vg(q)
                per_eval.append(syncs() - before)
                return out

            return wrapped

        hmc._value_and_grad = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            hmc._value_and_grad = real
        total = syncs()
    return out, per_eval, total - sum(per_eval), dict(where)


def device_kernels_and_busy_ms(fn):
    """``(device kernels, busy ms)`` of ``fn()`` from ``torch.profiler``:
    the number of device kernel executions and the milliseconds the card
    spent in kernels and copies (the sum of the device events' own time);
    ``(None, None)`` when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if total_us <= 0:
        return None, None
    return (sum(e.count for e in events if getattr(e, "device_type", None) == DeviceType.CUDA),
            total_us / 1e3)


def device_busy_ms(fn):
    """Milliseconds the card spent in kernels and copies during ``fn()``
    (:func:`device_kernels_and_busy_ms`); None without device time."""
    return device_kernels_and_busy_ms(fn)[1]


def ss_parity(smi):
    """``[ss parity]``, float64 on the card: ``lfm_mll_ss`` against
    ``ExactSIMM.mll_gridded`` on a p53-shaped draw at orders 8, 10 and 12
    (tests/test_statespace.py:81-94: 2e-2, 4e-3, 6e-4, falling), and at the
    dense10k shape (50 x 200) against the exact MLL: the value within 5e-3 x
    max(1, |MLL|), the raw gradients' cosine >= 0.999."""
    import torch

    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f64 = torch.device("cuda"), torch.float64
    data = port_main.synthetic_dense_data(5, 7, 0, f64, dev)
    _, y, _ = train_arrays(data, dev, f64)
    params = simm.init_params(5, dtype=f64, device=dev)
    model = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    exact = float(model.mll_gridded(params, data.timepoints, y))
    errs = {}
    for order in (8, 10, 12):
        errs[order] = abs(float(ss.lfm_mll_ss(params, data.timepoints, y, jitter=1e-4,
                                               order=order, parallel=False)) - exact)
    limits = {8: 2e-2, 10: 4e-3, 12: 6e-4}
    print(f"[ss parity] p53-shaped (5 x 7), f64: exact {exact!r}; |ss - exact| by order "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (limits {limits}) ({smi})")
    for order, err in errs.items():
        require(err < limits[order], f"ss parity order {order}: {err}")
    require(errs[12] < errs[10] < errs[8], f"ss parity error does not fall with the order {errs}")

    G, T = DENSE_GENES, DENSE_TIMEPOINTS
    data = port_main.synthetic_dense_data(G, T, 0, f64, dev)
    _, y, _ = train_arrays(data, dev, f64)
    model = simm.ExactSIMM(num_genes=G, jitter=1e-4, canonical_rows=True)
    raw0 = simm.unconstrain(simm.init_params(G, dtype=f64, device=dev))
    le, ge = generic.value_and_grad(
        lambda r: model.mll_gridded(simm.constrain(r), data.timepoints, y), raw0)
    ls, gs = generic.value_and_grad(
        lambda r: ss.lfm_mll_ss(simm.constrain(r), data.timepoints, y, jitter=1e-4), raw0)
    rel = abs(float(ls) - float(le)) / max(1.0, abs(float(le)))
    cos = _cosine(_flat_grad(gs), _flat_grad(ge))
    print(f"[ss parity] dense10k shape ({G} x {T}), f64: exact {float(le)!r} ss {float(ls)!r}, "
          f"|diff| / max(1, |MLL|) {rel:.3e} (limit 5e-3); raw gradient cosine {cos:.6f} "
          f"(limit 0.999) ({smi})")
    require(rel <= 5e-3, f"ss parity dense10k shape: {rel}")
    require(cos >= 0.999, f"ss parity dense10k gradient cosine {cos}")


def dense_ss(drive, smi):
    """``[dense ss]``, ``[ss variants]``, ``[ss predict]`` and ``[ss
    scale]``: ``main.run_dense --mll-engine ss`` at dense10k's full width
    (50 x 200, order 10, m = 60), float32, DENSE_STEPS steps; its step
    times, host time per filter step, host syncs, device share, stages and
    first step against float64 on the card; the variants; the smoothed
    force by both interpolations; one value+grad at T = 2000."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    G, T, steps = DENSE_GENES, DENSE_TIMEPOINTS, DENSE_STEPS
    held = {}

    def route(num_iters, **kw):
        def run():
            torch.cuda.reset_peak_memory_stats(dev)
            held["bytes"] = torch.cuda.memory_allocated(dev)
            return port_main.run_dense(cfg.RunConfig(
                preset="dense10k", synth_genes=G, synth_timepoints=T, num_iters=num_iters,
                x64=False, device="cuda", mll_engine="ss", **kw))
        return run

    dense = drive("dense ss", route(steps), ())
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    hist = dense.result.history.tolist()
    step_ms = [1e3 * t for t in dense.step_seconds]
    median = statistics.median(step_ms[1:])
    q1, _, q3 = statistics.quantiles(step_ms[1:], n=4)
    fwd_us = [1e6 * st["forward_host_s"] / T for st in dense.ss_stats]
    vg_us = [1e6 * st["value_and_grad_host_s"] / T for st in dense.ss_stats]
    b, s_true, d_true = dense.data.params_ground_truth()
    corr_d = _corr(dense.result.params.decay, d_true)
    corr_s = _corr(dense.result.params.sensitivity, s_true)
    print(f"[dense ss] N={G * T} f32 losses {hist}; recovery corr(decay) {corr_d:.4f} "
          f"corr(sensitivity) {corr_s:.4f} ({smi})")
    pick = _schedule_name(ss._select_schedule(None, T, dev)[0])
    print(f"[dense ss] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) {median:.3f}, "
          f"spread (interquartile) {q3 - q1:.3f}; the route's schedule (parallel=None) {pick}; "
          f"peak memory {peak_gib:.3f} GiB (above the {held['bytes'] / 2**30:.3f} GiB held "
          f"before the run) ({smi})")
    print(f"[dense ss] host us per filter step (enqueue / T = {T}): loss "
          f"{[round(u, 1) for u in fwd_us]}, loss and gradient {[round(u, 1) for u in vg_us]}; "
          f"host share of the step (median) "
          f"{statistics.median(v * T / 1e3 for v in vg_us[1:]) / median:.3f} ({smi})")
    require(all(math.isfinite(v) for v in hist), "dense ss losses not finite")
    require(bool(torch.isfinite(dense.lf_mean).all() and torch.isfinite(dense.lf_var).all()),
            "dense ss smoothed force not finite")

    # The first step at the init point in float32 against float64 on the card.
    y32, t32 = dense.y, dense.data.timepoints
    raw32 = simm.unconstrain(simm.init_params(G, dtype=f32, device=dev))
    raw64 = type(raw32)(*(r.double() for r in raw32))

    def objective(y, t):
        return lambda r: -ss.lfm_mll_ss(simm.constrain(r), t, y, jitter=cfg.EXACT_JITTER)

    # The run's peak above includes the data draw (sample_prior's N x N
    # factor); one loss and gradient alone:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    (l32, g32), syncs = count_syncs(lambda: generic.value_and_grad(objective(y32, t32), raw32))
    step_peak_mib = (torch.cuda.max_memory_allocated(dev) - before) / 2**20
    l64, g64 = generic.value_and_grad(objective(y32.double(), t32.double()), raw64)
    rel = abs(float(l32) - float(l64)) / abs(float(l64))
    cos = _cosine(_flat_grad(g32), _flat_grad(g64))
    print(f"[dense ss] first step: loss f32 {float(l32)!r} f64 {float(l64)!r} rel {rel:.3e} "
          f"(limit 1e-4); gradient cosine {cos:.6f} (limit 0.999); run's step 1 {hist[0]!r}; "
          f"host syncs in one value and gradient (T = {T}) {syncs}, its peak memory "
          f"{step_peak_mib:.1f} MiB ({smi})")
    require(rel <= 1e-4, f"dense ss first-step loss f32 vs f64: {rel}")
    require(cos >= 0.999, f"dense ss first-step gradient cosine {cos}")
    require(abs(float(l32) - hist[0]) <= 1e-5 * abs(hist[0]), "run_dense ss step 1 loss")

    # Where one step's time goes: each stage alone with CUDA events at the
    # init point; the device's busy time in one step from the profiler.
    p0 = simm.constrain(raw32)
    leaves = type(raw32)(*(r.detach().requires_grad_(True) for r in raw32))
    loss = objective(y32, t32)(leaves)
    grid = dense.lf_grid
    nv = dense.var.reshape(G, T).T + cfg.EXACT_JITTER

    def build():
        f_aug, p_inf, _, _ = ss.build_lfm_ssm(p0.decay, p0.sensitivity, p0.lengthscale)
        return ss.discretize(f_aug, p_inf, t32[0]), ss.discretize(f_aug, p_inf, t32[1] - t32[0])

    stages = {
        "build_lfm_ssm + discretize": build,
        "filter forward (lfm_mll_ss)": lambda: objective(y32, t32)(leaves),
        "backward": lambda: torch.autograd.grad(loss, tuple(leaves), retain_graph=True),
        "smoothed force, union (400 steps)": lambda: ss.lfm_predict_ss(
            p0, t32, y32, grid, noise_var=nv),
        "smoothed force, bridge": lambda: ss.lfm_predict_ss(p0, t32, y32, grid, noise_var=nv,
                                                            interp="bridge"),
    }
    stage_ms = {name: cuda_ms(fn, reps=3, warmup=1) for name, fn in stages.items()}
    busy = device_busy_ms(lambda: generic.value_and_grad(objective(y32, t32), raw32))
    share = "not measured (no device time in the trace)" if busy is None else \
        f"{busy:.3f} ms busy in one value and gradient, {busy / median:.3f} of the step median"
    print(f"[dense ss] stage ms {json.dumps(stage_ms)}; step median {median:.3f}; device "
          f"{share} ({smi})")
    del loss, leaves

    # [ss variants]: the exact Matern-3/2 prior and the frozen-gain tail.
    variants = {}
    for label, kw in (("matern32", {"force_kernel": "matern32"}),
                      *((f"stationary_after={k}", {"stationary_after": k}) for k in (16, 32, 64))):
        run = drive(f"ss variants {label}", route(3, **kw), ())
        h = run.result.history.tolist()
        ms = [1e3 * t for t in run.step_seconds]
        require(all(math.isfinite(v) for v in h) and bool(torch.isfinite(run.lf_mean).all()),
                f"ss variant {label} not finite")
        variants[label] = (h, ms)
        print(f"[ss variants] {label}: losses {h}; step ms {[round(t, 3) for t in ms]} ({smi})")
    # The tail's error against the exact filter, float64 at the init point.
    p64 = simm.constrain(raw64)
    y64, t64 = y32.double(), t32.double()
    with torch.no_grad():  # the sequential filter: the tail's exact part runs it
        exact64 = float(ss.lfm_mll_ss(p64, t64, y64, jitter=cfg.EXACT_JITTER, parallel=False))
        tail_err = {k: abs(float(ss.lfm_mll_ss(p64, t64, y64, jitter=cfg.EXACT_JITTER,
                                               stationary_after=k)) - exact64)
                    for k in (16, 32, 64, T - 1)}
    print(f"[ss variants] f64 |MLL(stationary_after=K) - exact| at init {tail_err} "
          f"(must fall with K; K = T - 1 exact) ({smi})")
    require(tail_err[16] > tail_err[32] > tail_err[64], f"tail error does not fall {tail_err}")
    require(tail_err[T - 1] == 0.0, f"stationary_after=T-1 differs from the exact filter")

    # [ss predict]: bridge against union, float64 and float32, at the trained
    # parameters on the route's 200-point grid. The two interpolations
    # differ by more than roundoff in the JAX package itself (on the CPU, f64:
    # at 50 x 200 at init its union and bridge variances sit 1.06e-7 apart;
    # at 6 x 40 after 4 steps its means 1.79e-6 apart, at t = 0, where the
    # port's means sit 3.3e-10 from JAX's on each route), so f64 is held to
    # 1e-5 (means) and 1e-6 (variances). float32: measured on
    # an H100 at this shape after 10 steps 1.07e-2 / 5.0e-5 (CPU: 1.3e-3 /
    # 2.9e-4 at 50 x 200 at init, 1.35e-2 / 3.3e-5 at 6 x 40): limits 5e-2 / 5e-4.
    params = dense.result.params
    limits = {f64: (1e-5, 1e-6), f32: (5e-2, 5e-4)}
    diffs = {}
    for dt in (f64, f32):
        pp = type(params)(*(x.to(dt) for x in params))
        args = (pp, t32.to(dt), y32.to(dt), grid.to(dt))
        u = ss.lfm_predict_ss(*args, noise_var=nv.to(dt))
        br = ss.lfm_predict_ss(*args, noise_var=nv.to(dt), interp="bridge")
        diffs[dt] = [float((a - b).abs().max()) for a, b in zip(u[:2], br[:2])]
    p64_trained = type(params)(*(x.double() for x in params))
    f_at_train = ss.lfm_predict_ss(p64_trained, t64, y64, t64, noise_var=nv.double(),
                                   interp="bridge")[0]
    corr_pred = _corr(f_at_train, dense.data.f_true)
    print(f"[ss predict] bridge vs union max |diff| (f_mean, f_var): f64 {diffs[f64]} (limits "
          f"{limits[f64]}), f32 {diffs[f32]} (limits {limits[f32]}); f_mean at the training "
          f"times (bridge, f64) corr with f_true {corr_pred:.4f}; union "
          f"{stage_ms['smoothed force, union (400 steps)']:.3f} ms, bridge "
          f"{stage_ms['smoothed force, bridge']:.3f} ms (f32) ({smi})")
    for dt in (f64, f32):
        require(all(d <= lim for d, lim in zip(diffs[dt], limits[dt])),
                f"ss predict bridge vs union {dt}: {diffs[dt]}")

    # [ss scale]: one value and gradient at G = 50, T = 2000 (N = 1e5), float32,
    # on seeded data (sample_prior's host factor is N^2).
    T_big = 2000
    gen = torch.Generator().manual_seed(7)
    t_big = torch.linspace(0.0, 12.0 * T_big / T, T_big, dtype=f32, device=dev)
    y_big = (0.125 + torch.randn(G * T_big, generator=gen)).to(f32).to(dev)
    scale = {}
    for k in (None, 256):
        fn = lambda: generic.value_and_grad(lambda r: -ss.lfm_mll_ss(
            simm.constrain(r), t_big, y_big, jitter=cfg.EXACT_JITTER, stationary_after=k), raw32)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lv, _), n_sync = count_syncs(fn)
        wall = 1e3 * (time.perf_counter() - t0)
        scale[k] = wall
        print(f"[ss scale] G={G} T={T_big} (N={G * T_big}) f32 stationary_after={k}: value and "
              f"gradient {wall:.3f} ms ({1e3 * wall / T_big:.1f} us a filter step), loss "
              f"{float(lv)!r}, host syncs {n_sync} ({smi})")
        require(math.isfinite(float(lv)), f"ss scale loss not finite (stationary_after={k})")
    return dict(median=median, spread=q3 - q1, peak_gib=peak_gib, corr=(corr_d, corr_s),
                dense=dense)


# The schedules of parallel= that the ss phases time: the sequential pair,
# the associative scan, the blocked pair at its default block length and at
# one other.
SS_SCHEDULES = {"sequential": False, "associative": True, "blocked": "blocked", "blocked L=8": 8}


def _schedule_name(fil):
    """The name of a schedule's filter (a function or a ``partial`` of one)."""
    return getattr(fil, "__name__", None) or fil.func.__name__


def _median_spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4) if len(values) > 1 else (values[0],) * 3
    return statistics.median(values), q3 - q1


def _levels(fn):
    """``(fn(), n)``: n calls of a schedule's per-level routine during
    ``fn()``, i.e. a sequential filter step's update, a semigroup combine
    or a state application (each wrapped once in ``ops.statespace``)."""
    from dis_project_tpu_torch.ops import statespace as ss

    names = ("_joseph_update", "_joseph_update_sel", "_combine", "_apply_state")
    originals = {name: getattr(ss, name) for name in names}
    calls = [0]

    def counted(f):
        def g(*args, **kw):
            calls[0] += 1
            return f(*args, **kw)
        return g

    for name, f in originals.items():
        setattr(ss, name, counted(f))
    try:
        out = fn()
    finally:
        for name, f in originals.items():
            setattr(ss, name, f)
    return out, calls[0]


def _schedule_times(loss_fn, raw, reps):
    """One schedule's step times (host clock, each ending in a sync):
    ``reps`` losses alone and ``reps`` losses and gradients; their medians
    of steps 2+ with interquartile spreads, the host enqueue time of one
    loss and of one loss and gradient, the levels of one loss, the device's
    busy ms in one loss and gradient and its host syncs."""
    import torch

    from dis_project_tpu_torch.training import generic

    out = {}
    for kind, fn in (("loss", lambda: loss_fn(raw)),
                     ("loss_grad", lambda: generic.value_and_grad(loss_fn, raw))):
        walls, hosts = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            hosts.append(1e3 * (t1 - t0))
        out[kind] = _median_spread(walls[1:])
        out[kind + "_host"] = statistics.median(hosts[1:])
    with torch.no_grad():
        _, out["levels"] = _levels(lambda: loss_fn(raw))
    out["busy"] = device_busy_ms(lambda: generic.value_and_grad(loss_fn, raw))
    _, out["syncs"] = count_syncs(lambda: generic.value_and_grad(loss_fn, raw))
    return out


def _print_schedule_times(tag, T, name, r, smi):
    (lm, ls), (gm, gs) = r["loss"], r["loss_grad"]
    busy = "not measured" if r["busy"] is None else f"{r['busy']:.3f} ms ({r['busy'] / gm:.3f})"
    print(f"[{tag}] T={T} {name}: loss {lm:.3f} ms (spread {ls:.3f}), loss and gradient {gm:.3f} "
          f"ms (spread {gs:.3f}); {r['levels']} levels, host us per level {1e3 * r['loss_host'] / r['levels']:.1f} "
          f"(loss) / {1e3 * r['loss_grad_host'] / r['levels']:.1f} (loss and gradient); device busy "
          f"in one loss and gradient {busy}; host syncs {r['syncs']} ({smi})")


def ss_schedules(dense, smi):
    """``[ss schedules]``: each schedule of ``SS_SCHEDULES`` at the dense10k
    ss shape (50 x 200, order 10, m = 60) on the route's data at the init
    point, float32: its step times (loss alone and loss and gradient, median
    and interquartile spread), levels, host us per level, device
    busy share and host syncs (steps 2-6 of 6 sequential, 2-9 of 9 others);
    in float64 each schedule's MLL within 1e-9 x
    max(1, |MLL|) of the sequential one and its raw gradient within 1e-8 of
    max|g|; in float32 each schedule's loss within twice the sequential
    float32 loss's distance from the float64 one. ``[ss schedules scale]``:
    the loss and gradient of each at T = 2000 (N = 1e5) on seeded data.
    Returns the times by T and schedule."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    G, T = DENSE_GENES, DENSE_TIMEPOINTS
    y32, t32 = dense.y, dense.data.timepoints
    raw32 = simm.unconstrain(simm.init_params(G, dtype=f32, device=dev))
    raw64 = type(raw32)(*(r.double() for r in raw32))

    def loss_fn(y, t, parallel):
        return lambda r: -ss.lfm_mll_ss(simm.constrain(r), t, y, jitter=cfg.EXACT_JITTER,
                                        parallel=parallel)

    times = {T: {}}
    for name, parallel in SS_SCHEDULES.items():
        times[T][name] = r = _schedule_times(loss_fn(y32, t32, parallel), raw32,
                                             reps=6 if name == "sequential" else 9)
        _print_schedule_times("ss schedules", T, name, r, smi)

    ref = {}
    for dt in (f64, f32):
        raw = raw64 if dt == f64 else raw32
        for name, parallel in SS_SCHEDULES.items():
            ref[dt, name] = generic.value_and_grad(loss_fn(y32.to(dt), t32.to(dt), parallel), raw)
    l64, g64 = ref[f64, "sequential"]
    g64 = _flat_grad(g64)
    d32_seq = abs(float(ref[f32, "sequential"][0]) - float(l64))
    for name in SS_SCHEDULES:
        lv, gv = ref[f64, name]
        d_mll = abs(float(lv) - float(l64))
        d_grad = float((_flat_grad(gv) - g64).abs().max() / g64.abs().max())
        d32 = abs(float(ref[f32, name][0]) - float(l64))
        cos32 = _cosine(_flat_grad(ref[f32, name][1]), g64)
        print(f"[ss schedules] {name}: f64 |MLL - sequential| {d_mll:.3e} (limit "
              f"{1e-9 * max(1.0, abs(float(l64))):.3e}), raw gradient max |diff| / max|g| "
              f"{d_grad:.3e} (limit 1e-8); f32 |loss - f64 sequential| {d32:.3e} (limit 2 x the "
              f"sequential's {d32_seq:.3e}), f32 gradient cosine to f64 {cos32:.6f} ({smi})")
        require(d_mll <= 1e-9 * max(1.0, abs(float(l64))), f"ss schedule {name}: f64 MLL {d_mll}")
        require(d_grad <= 1e-8, f"ss schedule {name}: f64 gradient {d_grad}")
        require(d32 <= 2.0 * d32_seq, f"ss schedule {name}: f32 loss {d32} vs {d32_seq}")

    T_big = 2000
    gen = torch.Generator().manual_seed(7)
    t_big = torch.linspace(0.0, 12.0 * T_big / T, T_big, dtype=f32, device=dev)
    y_big = (0.125 + torch.randn(G * T_big, generator=gen)).to(f32).to(dev)
    times[T_big] = {}
    for name, parallel in SS_SCHEDULES.items():
        fn = loss_fn(y_big, t_big, parallel)
        walls = []
        for _ in range(4 if name == "sequential" else 5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lv, _ = generic.value_and_grad(fn, raw32)
            host = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        with torch.no_grad():
            _, levels = _levels(lambda: fn(raw32))
        _, syncs = count_syncs(lambda: generic.value_and_grad(fn, raw32))
        med, spread = _median_spread(walls[1:])
        times[T_big][name] = {"loss_grad": (med, spread)}
        print(f"[ss schedules scale] T={T_big} (N={G * T_big}) {name}: loss and gradient {med:.3f} "
              f"ms (spread {spread:.3f}, steps {[round(w, 1) for w in walls]}); {levels} levels, "
              f"host us per level {1e3 * host / levels:.1f}; loss {float(lv)!r}; host syncs "
              f"{syncs} ({smi})")
        require(math.isfinite(float(lv)), f"ss schedules scale {name}: loss not finite")
    return times


def ss_predict_schedules(dense, smi):
    """``[ss predict schedules]``: ``lfm_predict_ss`` union and bridge under
    each smoother schedule at the route's trained parameters on its 200-point
    grid, against the sequential smoother in float64 at ``[ss predict]``'s
    floor (1e-5 means, 1e-6 variances); each one's float32 time."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch.ops import statespace as ss

    f32, f64 = torch.float32, torch.float64
    G, T = DENSE_GENES, DENSE_TIMEPOINTS
    params = dense.result.params
    nv = dense.var.reshape(G, T).T + cfg.EXACT_JITTER
    t, y, grid = dense.data.timepoints, dense.y, dense.lf_grid
    for interp in ("union", "bridge"):
        def call(dt, parallel):
            pp = type(params)(*(x.to(dt) for x in params))
            return ss.lfm_predict_ss(pp, t.to(dt), y.to(dt), grid.to(dt), noise_var=nv.to(dt),
                                     interp=interp, parallel=parallel)
        seq = call(f64, False)
        for name, parallel in SS_SCHEDULES.items():
            got = call(f64, parallel)
            diffs = [float((a - b).abs().max()) for a, b in zip(got[:2], seq[:2])]
            ms = cuda_ms(lambda: call(f32, parallel), reps=3, warmup=1)
            print(f"[ss predict schedules] {interp} {name}: f64 max |diff| to sequential (f_mean, "
                  f"f_var) {diffs} (limits (1e-05, 1e-06)); f32 {ms:.3f} ms ({smi})")
            require(diffs[0] <= 1e-5 and diffs[1] <= 1e-6,
                    f"ss predict {interp} {name} vs sequential: {diffs}")


def ss_auto(times, smi):
    """``[ss auto]``: what ``parallel=None`` resolves to on the card at
    T = 200 and 2000, beside the blocked and sequential loss-and-gradient
    medians and whether blocked is faster by more than the larger spread."""
    from dis_project_tpu_torch.ops import statespace as ss

    for T, by in times.items():
        (s_med, s_sp), (b_med, b_sp) = by["sequential"]["loss_grad"], by["blocked"]["loss_grad"]
        pick = _schedule_name(ss._select_schedule(None, T, "cuda")[0])
        print(f"[ss auto] T={T}: parallel=None picks {pick} (_AUTO_BLOCKED_MIN_T = "
              f"{ss._AUTO_BLOCKED_MIN_T}); loss and gradient sequential {s_med:.3f} ms (spread "
              f"{s_sp:.3f}), blocked {b_med:.3f} ms (spread {b_sp:.3f}); blocked faster by more "
              f"than the larger spread: {s_med - b_med > max(s_sp, b_sp)} ({smi})")


def ffbs(dense, smi):
    """``[ffbs]``, float64 at the route's trained parameters on the dense10k
    grid (200 train times, the 200-point force grid): 64 joint posterior
    draws (``posterior_sample_ss``) whose marginal mean and variance sit
    within 5 Monte-Carlo standard errors of ``lfm_predict_ss``'s at every
    point; ``sample_trajectory_ss``'s 64 prior draws against the prior
    moments (a filter with every update masked); the ms of S = 1 and 64."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch.ops import statespace as ss

    dev, f64 = torch.device("cuda"), torch.float64
    G, T, S = DENSE_GENES, DENSE_TIMEPOINTS, 64
    params = type(dense.result.params)(*(x.double() for x in dense.result.params))
    nv = (dense.var.reshape(G, T).T + cfg.EXACT_JITTER).double()
    t, y, grid = (x.double() for x in (dense.data.timepoints, dense.y, dense.lf_grid))
    fm, fv, _, _ = ss.lfm_predict_ss(params, t, y, grid, noise_var=nv)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    draws = ss.posterior_sample_ss(params, t, y, grid, gen, noise_var=nv, num_samples=S)
    z_mean = float(((draws.mean(0) - fm).abs() / (fv / S).sqrt()).max())
    z_var = float(((draws.var(0) - fv).abs() / (fv * math.sqrt(2.0 / (S - 1)))).max())
    ms = {s: cuda_ms(lambda s=s: ss.posterior_sample_ss(params, t, y, grid, gen, noise_var=nv,
                                                        num_samples=s), reps=3, warmup=1)
          for s in (1, S)}
    print(f"[ffbs] posterior_sample_ss f64, {S} draws on {grid.shape[0]} points: max z of the "
          f"mean {z_mean:.3f}, of the variance {z_var:.3f} (limit 5); ms S=1 {ms[1]:.3f}, "
          f"S={S} {ms[S]:.3f} ({smi})")
    require(draws.shape == (S, grid.shape[0]) and bool(torch.isfinite(draws).all()),
            "ffbs draws not finite")
    require(z_mean <= 5 and z_var <= 5, f"ffbs moments: z {z_mean}, {z_var}")

    f, x = ss.sample_trajectory_ss(params, t, gen, num_samples=S)
    f_aug, p_inf, p0, h_force = ss.build_lfm_ssm(params.decay, params.sensitivity,
                                                 params.lengthscale)
    a, q = ss.discretize(f_aug, p_inf, torch.diff(t, prepend=torch.zeros(1, dtype=f64,
                                                                        device=dev)))
    h = ss.gene_observation_matrix(p0.shape[0] - G, G, 1, f64, dev)
    _, ps, _ = ss.kalman_filter(a, q, h, 1.0, torch.zeros((T, G), dtype=f64, device=dev), p0,
                                mask=torch.zeros(T))
    f_var = torch.einsum("i,tij,j->t", h_force, ps, h_force)
    zf = float((f.mean(0).abs() / (f_var / S).sqrt()).max())
    zv = float(((f.var(0) - f_var).abs() / (f_var * math.sqrt(2.0 / (S - 1)))).max())
    ms_p = {s: cuda_ms(lambda s=s: ss.sample_trajectory_ss(params, t, gen, num_samples=s),
                       reps=3, warmup=1) for s in (1, S)}
    print(f"[ffbs] sample_trajectory_ss f64, {S} prior draws on {T} points: max z of the force "
          f"mean {zf:.3f}, of its variance {zv:.3f} (limit 5); x {tuple(x.shape)}; ms S=1 "
          f"{ms_p[1]:.3f}, S={S} {ms_p[S]:.3f} ({smi})")
    require(zf <= 5 and zv <= 5, f"prior draws' moments: z {zf}, {zv}")


def streaming(dense, smi):
    """``[streaming]``, float64 at the init point: the dense10k series
    absorbed one arrival at a time (``streaming_update``, inputs already on
    the card), its final ll within 1e-9 relative of the batch ``lfm_mll_ss``
    over the same steps (``uniform=False``); then 64 exact warm-up arrivals
    and the rest through ``streaming_update_frozen``, the ll within 1e-6
    relative of the batch ``stationary_after=64`` MLL (the JAX package's
    limit for this check). Host us and wall us per arrival of each, the
    host us of the gap's sync-free discretization alone, and the host syncs
    per arrival (the arrivals' loops only; they must be 0)."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import statespace as ss

    dev, f64 = torch.device("cuda"), torch.float64
    G, T, K = DENSE_GENES, DENSE_TIMEPOINTS, 64
    params = simm.init_params(G, dtype=f64, device=dev)
    t, y = dense.data.timepoints.double(), dense.y.double()
    ys = y.reshape(G, T).T.contiguous()
    rv = (cfg.EXACT_JITTER + params.obs_stddev**2).reshape(())
    # The batch filter over the same steps (the stream's gaps, each t_i - t_{i-1});
    # the frozen tail at the uniform grid's step, as the batch tail takes it.
    batch = float(ss.lfm_mll_ss(params, t, y, jitter=cfg.EXACT_JITTER, uniform=False))
    batch_k = float(ss.lfm_mll_ss(params, t, y, jitter=cfg.EXACT_JITTER, stationary_after=K))
    dt = float((t[-1] - t[0]) / (T - 1))
    carry0, aux = ss.streaming_init(params)

    def exact(carry, lo, hi):
        for i in range(lo, hi):
            carry = ss.streaming_update(carry, aux, t[i], ys[i], rv)
        return carry

    warm = exact(carry0, 0, K + 1)
    pack = ss.streaming_freeze(warm, aux, dt, rv)

    def frozen(carry):
        for i in range(K + 1, T):
            carry = ss.streaming_update_frozen(carry, pack, ys[i])
        return carry

    def gaps():
        for i in range(1, T):
            ss._discretize_device(aux[0], aux[1], t[i] - t[i - 1])

    out = {}
    for name, fn, n in (("streaming_update", lambda: exact(carry0, 0, T), T),
                        ("streaming_update_frozen", lambda: frozen(warm), T - K - 1),
                        ("the gap's sync-free discretization alone", gaps, T - 1)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, syncs = count_syncs(fn)
        out[name] = (None if res is None else float(res.ll), 1e6 * host / n, 1e6 * wall / n,
                     syncs / n)
        print(f"[streaming] {name}: {n} arrivals of {G} genes, f64: host us per arrival "
              f"{1e6 * host / n:.1f}, wall {1e6 * wall / n:.1f}; host syncs per arrival "
              f"{syncs / n} ({smi})")
    ll, llf = out["streaming_update"][0], out["streaming_update_frozen"][0]
    rel, rel_k = abs(ll - batch) / abs(batch), abs(llf - batch_k) / abs(batch_k)
    print(f"[streaming] ll {ll!r} vs batch lfm_mll_ss {batch!r}: rel {rel:.3e} (limit 1e-9); "
          f"{K} exact then frozen {llf!r} vs batch stationary_after={K} {batch_k!r}: rel "
          f"{rel_k:.3e} (limit 1e-6) ({smi})")
    require(rel <= 1e-9, f"streaming ll vs batch: {rel}")
    require(rel_k <= 1e-6, f"frozen streaming ll vs batch stationary tail: {rel_k}")
    require(all(v[3] == 0 for v in out.values()), f"streaming made host syncs: {out}")


def dense_metrics(drive, smi):
    """``[dense metrics]``: two-step ``main.run_dense`` runs at dense10k with
    ``--metrics-path`` on the cholesky, cg and ss engines (float32): each
    file one ``{"step", "loss"}`` line per step, equal to the run's loss
    history."""
    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main

    tmp = tempfile.mkdtemp(prefix="chip_smoke_metrics_")
    for engine in ("cholesky", "cg", "ss"):
        path = os.path.join(tmp, f"{engine}.jsonl")
        run = drive(f"dense metrics {engine}", lambda: port_main.run_dense(cfg.RunConfig(
            preset="dense10k", synth_genes=DENSE_GENES, synth_timepoints=DENSE_TIMEPOINTS,
            num_iters=2, x64=False, device="cuda", mll_engine=engine, metrics_path=path)), ())
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        want = [{"step": i, "loss": v} for i, v in enumerate(run.result.history.tolist())]
        print(f"[dense metrics] {engine}: {lines} ({smi})")
        require(lines == want and len(lines) == 2, f"dense metrics {engine}: {lines} vs {want}")
    shutil.rmtree(tmp)


def ss_engine_phases(drive, dense, smi):
    """The phases of the ss engine's schedules, samplers and streaming API,
    and the dense metrics files; prints their total wall seconds."""
    t0 = time.perf_counter()
    times = ss_schedules(dense, smi)
    ss_predict_schedules(dense, smi)
    ss_auto(times, smi)
    ffbs(dense, smi)
    streaming(dense, smi)
    dense_metrics(drive, smi)
    print(f"[ss engine phases] schedules, predict schedules, auto, ffbs, streaming and dense "
          f"metrics took {time.perf_counter() - t0:.1f} s")
    return times


def simm2_erf(smi):
    """``[simm2 erf]``: ``ops.special.erf_complex`` on the card against
    ``scipy.special.erf`` on the host over the order-2 kernels' working
    domain (|Re| <= 26, |Im| <= 5), wherever |erf| <= 1e6: complex128 within
    1e-12 x max(1, |erf|), complex64 (40 terms) within the JAX package's
    8.6e-6 x max(1, |erf|); the analytic backward against a float64 central
    difference (1e-6 x max(1, |g|)); the host microseconds and the card's
    milliseconds of one call."""
    import numpy as np
    import scipy.special
    import torch

    from dis_project_tpu_torch.ops.special import erf_complex

    dev = torch.device("cuda")
    re, im = np.meshgrid(np.linspace(-26.0, 26.0, 521), np.linspace(-5.0, 5.0, 101))
    z = (re + 1j * im).ravel()
    for cdtype, limit in ((torch.complex128, 1e-12), (torch.complex64, 8.6e-6)):
        zt = torch.as_tensor(z, dtype=cdtype, device=dev)
        got = erf_complex(zt).cpu().numpy().astype(np.complex128)
        ref = scipy.special.erf(zt.cpu().numpy().astype(np.complex128))
        keep = np.abs(ref) <= 1e6
        err = float(np.max(np.abs(got - ref)[keep] / np.maximum(1.0, np.abs(ref[keep]))))
        print(f"[simm2 erf] {cdtype} on {keep.sum()} of {z.size} points (|erf| <= 1e6): max "
              f"|erf - scipy| / max(1, |erf|) {err:.3e} (limit {limit:g}) ({smi})")
        require(math.isfinite(err) and err <= limit, f"erf_complex {cdtype} vs scipy: {err}")

    # The analytic backward against a central difference, float64: a real
    # loss of erf(x + iy), each point's derivative by x and by y.
    rng = np.random.default_rng(12)
    x0 = torch.as_tensor(rng.uniform(-3.0, 3.0, 64), device=dev)
    y0 = torch.as_tensor(rng.uniform(-2.0, 2.0, 64), device=dev)
    wr, wi = 0.7, -0.4

    def per_point(x, y):
        e = erf_complex(torch.complex(x, y))
        return wr * e.real + wi * e.imag

    xl, yl = x0.clone().requires_grad_(True), y0.clone().requires_grad_(True)
    gx, gy = torch.autograd.grad(per_point(xl, yl).sum(), (xl, yl))
    h = 1e-6
    with torch.no_grad():
        fx = (per_point(x0 + h, y0) - per_point(x0 - h, y0)) / (2 * h)
        fy = (per_point(x0, y0 + h) - per_point(x0, y0 - h)) / (2 * h)
    gerr = max(float(((gx - fx).abs() / gx.abs().clamp(min=1.0)).max()),
               float(((gy - fy).abs() / gy.abs().clamp(min=1.0)).max()))
    print(f"[simm2 erf] backward vs central difference (f64, 64 points, Re and Im): max "
          f"err / max(1, |g|) {gerr:.3e} (limit 1e-6) ({smi})")
    require(gerr <= 1e-6, f"erf_complex backward vs central difference: {gerr}")

    # Host time of one call (enqueue, no sync inside) and the card's time,
    # at the table Gram's argument count (dense10k: 4 tables, 100 rates) and
    # at one p53 row-route call (35 x 35).
    for label, n in (("table Gram (dense10k, 80,000 args)", (4 * 200 - 1) * 100 + 100),
                     ("p53 row route (35 x 35)", 35 * 35)):
        for cdtype in (torch.complex64, torch.complex128):
            zt = torch.as_tensor(z[:n] if n <= z.size else np.resize(z, n), dtype=cdtype,
                                 device=dev)
            erf_complex(zt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                erf_complex(zt)
            host_us = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            dev_ms = back_to_back_ms(lambda: erf_complex(zt))
            print(f"[simm2 erf] one call, {label}, {cdtype}: host {host_us:.1f} us (enqueue), "
                  f"card {dev_ms:.4f} ms (back to back) ({smi})")


def simm2_p53(drive, smi):
    """``[simm2 p53]``: ``main.run_second_order`` (``--model simm2``, the
    p53 synthetic data, float64, 150 iterations) on the card and on the
    CPU in this process: the final loss within rel 1e-6 (150 Adam steps
    amplify last-bit differences of the card's complex exp), the first
    step within rel 1e-10; the wall, the kinetics table (printed by the
    route) and the host syncs per training step."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import simm2
    from dis_project_tpu_torch.training import generic

    tmp = tempfile.mkdtemp(prefix="chip_smoke_simm2_")
    runs = {}
    for device in ("cuda", "cpu"):
        config = cfg.RunConfig(model="simm2", num_iters=150, device=device,
                               out_dir=os.path.join(tmp, device),
                               metrics_path=os.path.join(tmp, f"{device}.jsonl"))
        runs[device] = drive(f"simm2 p53 {device}", lambda: port_main.run_second_order(config),
                             ())
    card, host = runs["cuda"], runs["cpu"]
    hc, hh = card.result.history.tolist(), host.result.history.tolist()
    rel_final = abs(hc[-1] - hh[-1]) / abs(hh[-1])
    rel_first = abs(hc[0] - hh[0]) / abs(hh[0])
    lat = card.latent
    print(f"[simm2 p53] 150 steps f64: final loss card {hc[-1]!r} cpu {hh[-1]!r} rel "
          f"{rel_final:.3e} (limit 1e-6); first step rel {rel_first:.3e} (limit 1e-10); wall card "
          f"{card.wall_s:.3f} s ({1e3 * card.wall_s / 150:.1f} ms a step), cpu {host.wall_s:.3f} s "
          f"({smi})")
    require(rel_final <= 1e-6, f"simm2 p53 final loss card vs cpu: {rel_final}")
    require(rel_first <= 1e-10, f"simm2 p53 first step card vs cpu: {rel_first}")
    require(lat.mean.shape == (100,) and bool(torch.isfinite(lat.mean).all()
                                              and torch.isfinite(lat.cov).all()),
            "simm2 p53 latent force not finite")

    # Host syncs of the training loop per step (the guard reads each step's
    # loss and gradient on the host).
    dev = torch.device("cuda")
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = train_arrays(data, dev, torch.float64)
    model = simm2.SecondOrderSIMM(num_genes=5, jitter=cfg.EXACT_JITTER)
    raw = simm2.unconstrain(simm2.init_params(5, dtype=torch.float64, device=dev))
    _, syncs = count_syncs(lambda: generic.fit_loop(
        lambda r: -model.mll(simm2.constrain(r), X, y), raw, num_iters=3))
    print(f"[simm2 p53] host syncs per training step {syncs / 3:.1f} ({smi})")
    shutil.rmtree(tmp)
    return dict(wall_s=card.wall_s, final=hc[-1])


def dense_simm2(drive, smi):
    """``[dense simm2]``: ``main.run_dense --model simm2`` (cholesky
    engine) at dense10k's full width (50 x 200, N = 1e4), float32,
    DENSE_STEPS steps: the table Gram, cuSOLVER, the MLL's backward with K3
    (once a step); step ms (median of steps 2-10, interquartile spread),
    peak memory, whether every loss is finite, the alpha/omega recovery;
    the first step against float64 (rel 1e-4) and against the plain SYRK
    (``kernels=False``: loss rel 1e-5, raw-gradient cosine >= 0.999); stage
    ms at the init point."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import simm2
    from dis_project_tpu_torch.ops import cuda_cholesky as cc
    from dis_project_tpu_torch.ops import lfm_kernels2 as lfk2
    from dis_project_tpu_torch.ops import mll as mll_ops
    from dis_project_tpu_torch.training import generic

    dev, f32 = torch.device("cuda"), torch.float32
    G, T, steps = DENSE_GENES, DENSE_TIMEPOINTS, DENSE_STEPS
    held = {}

    def run():
        torch.cuda.reset_peak_memory_stats(dev)
        held["bytes"] = torch.cuda.memory_allocated(dev)
        return port_main.run_dense(cfg.RunConfig(
            preset="dense10k", model="simm2", synth_genes=G, synth_timepoints=T,
            num_iters=steps, x64=False, device="cuda"))

    counts = {}

    def counted():
        out = run()
        counts.update(cc.LAUNCHES)
        return out

    dense = drive("dense simm2", counted, ("syrk_ltl_tril",))
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    k3_per_step = counts["syrk_ltl_tril"] / steps
    hist = dense.result.history.tolist()
    finite = all(math.isfinite(v) for v in hist)
    step_ms = [1e3 * t for t in dense.step_seconds]
    median = statistics.median(step_ms[1:])
    q1, _, q3 = statistics.quantiles(step_ms[1:], n=4)
    _, _, a_true, w_true = dense.data.params_ground_truth()
    corr_a = _corr(dense.result.params.alpha, a_true)
    corr_w = _corr(dense.result.params.omega, w_true)
    print(f"[dense simm2] N={G * T} f32 losses {hist}; all {steps} finite: {finite}; recovery "
          f"corr(alpha) {corr_a:.4f} corr(omega) {corr_w:.4f} ({smi})")
    print(f"[dense simm2] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) "
          f"{median:.3f}, spread (interquartile) {q3 - q1:.3f}; peak memory {peak_gib:.3f} GiB "
          f"(above the {held['bytes'] / 2**30:.3f} GiB held before the run); K3 launches per "
          f"step {k3_per_step:g} ({smi})")
    require(k3_per_step == 1, f"dense simm2: K3 launched {k3_per_step} times a step")

    # The first step at the init point: float32 with K3 against float64 and
    # against the plain SYRK, on the run's own data.
    y32, t32 = dense.y, dense.data.timepoints
    raw32 = simm2.unconstrain(simm2.init_params(G, dtype=f32, device=dev))
    raw64 = type(raw32)(*(r.double() for r in raw32))
    jitter = dense.model.jitter
    plain = simm2.SecondOrderSIMM(num_genes=G, jitter=jitter, kernels=False)

    def objective(model, y, t):
        return lambda r: -model.mll_gridded(simm2.constrain(r), t, y)

    # The float64 grid is made anew: a float32 linspace cast up is uniform
    # only to float32's rounding, which the table Gram's float64 check sees.
    t64 = torch.linspace(0.0, float(t32[-1]), T, dtype=torch.float64, device=dev)
    lk, gk = generic.value_and_grad(objective(dense.model, y32, t32), raw32)
    lp, gp = generic.value_and_grad(objective(plain, y32, t32), raw32)
    l64, g64 = generic.value_and_grad(objective(dense.model, y32.double(), t64), raw64)
    rel64 = abs(float(lk) - float(l64)) / abs(float(l64))
    relp = abs(float(lk) - float(lp)) / abs(float(lp))
    cos = _cosine(_flat_grad(gk), _flat_grad(gp))
    cos64 = _cosine(_flat_grad(gk), _flat_grad(g64))
    print(f"[dense simm2] first step: loss K3 {float(lk)!r} plain {float(lp)!r} rel {relp:.3e} "
          f"(limit 1e-5), raw-gradient cosine {cos:.6f} (limit 0.999); f64 {float(l64)!r} rel "
          f"{rel64:.3e} (limit 1e-4), cosine to f64 {cos64:.6f}; run's step 1 {hist[0]!r} ({smi})")
    require(relp <= 1e-5, f"dense simm2 first step K3 vs plain: {relp}")
    require(cos >= 0.999, f"dense simm2 first-step gradient cosine vs plain: {cos}")
    require(rel64 <= 1e-4, f"dense simm2 first step f32 vs f64: {rel64}")
    require(abs(float(lk) - hist[0]) <= 1e-5 * abs(hist[0]), "run_dense simm2 step 1 loss")
    del l64, g64

    # Where one step's device time goes, each stage alone with CUDA events.
    p0 = simm2.constrain(raw32)
    leaves = type(p0)(*(v.detach().requires_grad_(True) for v in p0))

    def gram(p):
        return lfk2.gram_xx2_blocked_fast(t32, p.alpha, p.omega, p.sensitivity, p.lengthscale)

    with torch.no_grad():
        K = gram(p0)
        sigma = mll_ops.add_diagonal(K, jitter + p0.obs_stddev**2)
        yc = y32 - (p0.basal / simm2.spring(p0)).repeat_interleave(T)
        L = mll_ops.cholesky(sigma)
        Li = cc.tri_inv_panels(L).contiguous()
        dsig = 0.5 * torch.outer(yc, yc) - cc.syrk_ltl_tril_kernel(Li)
    k_graph = gram(leaves)
    gram_leaves = (leaves.alpha, leaves.omega, leaves.sensitivity, leaves.lengthscale)
    stages = {
        "table Gram forward": lambda: gram(p0),
        "table Gram backward": lambda: torch.autograd.grad(k_graph, gram_leaves, dsig,
                                                           retain_graph=True),
        "cholesky (cuSOLVER)": lambda: mll_ops.cholesky(sigma),
        "tri_inv_panels (L^-1)": lambda: cc.tri_inv_panels(L).contiguous(),
        "syrk K3": lambda: cc.syrk_ltl_tril_kernel(Li),
        "chol_solve": lambda: mll_ops.chol_solve(L, yc),
    }
    stage_ms = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    with torch.no_grad():
        gram(p0)
    gram_peak = (torch.cuda.max_memory_allocated(dev) - before) / 2**30
    print(f"[dense simm2] stage ms {json.dumps(stage_ms)}; sum {sum(stage_ms.values()):.3f} vs "
          f"step median {median:.3f}; the table Gram forward's own peak {gram_peak:.3f} GiB "
          f"({smi})")
    del K, sigma, L, Li, dsig, k_graph
    return dict(median=median, spread=q3 - q1, peak_gib=peak_gib, corr=(corr_a, corr_w),
                finite=finite, dense=dense)


def dense_simm2_ss(drive, base, smi):
    """``[dense simm2 ss]``: ``main.run_dense --model simm2 --mll-engine ss``
    on the same data (order 10, m = 110, float32, DENSE_STEPS steps on the
    schedule ``parallel=None`` picks): step ms and spread, device busy
    share, host syncs per loss and gradient; the smoothed force from
    ``lfm2_predict_ss`` on 200 points by union and bridge; float64 parity
    at the init point against ``SecondOrderSIMM.mll_gridded``: |ss - exact|
    <= 5e-3 x max(1, |MLL|), raw-gradient cosine >= 0.999."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import simm2
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f32 = torch.device("cuda"), torch.float32
    G, T, steps = DENSE_GENES, DENSE_TIMEPOINTS, DENSE_STEPS
    held = {}

    def run():
        torch.cuda.reset_peak_memory_stats(dev)
        held["bytes"] = torch.cuda.memory_allocated(dev)
        return port_main.run_dense(cfg.RunConfig(
            preset="dense10k", model="simm2", synth_genes=G, synth_timepoints=T,
            num_iters=steps, x64=False, device="cuda", mll_engine="ss"))

    dense = drive("dense simm2 ss", run, ())
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    hist = dense.result.history.tolist()
    step_ms = [1e3 * t for t in dense.step_seconds]
    median = statistics.median(step_ms[1:])
    q1, _, q3 = statistics.quantiles(step_ms[1:], n=4)
    vg_us = [1e6 * st["value_and_grad_host_s"] / T for st in dense.ss_stats]
    pick = _schedule_name(ss._select_schedule(None, T, dev)[0])
    _, _, a_true, w_true = dense.data.params_ground_truth()
    corr_a = _corr(dense.result.params.alpha, a_true)
    corr_w = _corr(dense.result.params.omega, w_true)
    m_dim = 10 + 2 * G
    print(f"[dense simm2 ss] N={G * T} m={m_dim} f32 losses {hist}; recovery corr(alpha) "
          f"{corr_a:.4f} corr(omega) {corr_w:.4f}; loss vs the cholesky route's step 1 "
          f"{base['dense'].result.history[0].item()!r} ({smi})")
    print(f"[dense simm2 ss] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) "
          f"{median:.3f}, spread (interquartile) {q3 - q1:.3f}; schedule (parallel=None) {pick}; "
          f"host us per filter step, loss and gradient {[round(u, 1) for u in vg_us]}; peak "
          f"memory {peak_gib:.3f} GiB ({smi})")
    require(all(math.isfinite(v) for v in hist), "dense simm2 ss losses not finite")

    y32, t32 = dense.y, dense.data.timepoints
    raw32 = simm2.unconstrain(simm2.init_params(G, dtype=f32, device=dev))

    def objective(y, t):
        return lambda r: -ss.lfm2_mll_ss(simm2.constrain(r), t, y, jitter=cfg.EXACT_JITTER)

    _, syncs = count_syncs(lambda: generic.value_and_grad(objective(y32, t32), raw32))
    busy = device_busy_ms(lambda: generic.value_and_grad(objective(y32, t32), raw32))
    share = "not measured (no device time in the trace)" if busy is None else \
        f"{busy:.3f} ms busy in one value and gradient, {busy / median:.3f} of the step median"
    print(f"[dense simm2 ss] host syncs per loss and gradient {syncs}; device {share} ({smi})")

    # The smoothed force on 200 points, both interpolations, at the trained
    # parameters.
    params = dense.result.params
    grid = torch.linspace(float(t32[0]), float(t32[-1]) * 13.0 / 12.0, 200, dtype=f32,
                          device=dev)
    nv = dense.var.reshape(G, T).T + cfg.EXACT_JITTER
    force = {}
    for interp in ("union", "bridge"):
        ms = cuda_ms(lambda: ss.lfm2_predict_ss(params, t32, y32, grid, noise_var=nv,
                                                interp=interp), reps=3, warmup=1)
        force[interp] = ss.lfm2_predict_ss(params, t32, y32, grid, noise_var=nv, interp=interp)
        fm, fv = force[interp][0], force[interp][1]
        require(bool(torch.isfinite(fm).all() and torch.isfinite(fv).all()),
                f"dense simm2 ss smoothed force ({interp}) not finite")
        print(f"[dense simm2 ss] smoothed force {interp}, 200 points: {ms:.3f} ms; variance "
              f"min {float(fv.min()):.3e} ({smi})")
    diffs = {f32: [float((a - b).abs().max()) for a, b in zip(force["union"][:2],
                                                              force["bridge"][:2])]}
    # float64: the [ss predict] limits of the first-order route (1e-5 on the
    # means, 1e-6 on the variances; the JAX package's own union and bridge
    # differ by up to ~2e-6). float32 is reported: the pseudo-solve's eigh
    # at m = 110 sets it.
    p64 = type(params)(*(x.double() for x in params))
    t64 = torch.linspace(0.0, float(t32[-1]), T, dtype=torch.float64, device=dev)
    args64 = (p64, t64, y32.double(), grid.double())
    u64 = ss.lfm2_predict_ss(*args64, noise_var=nv.double())
    b64 = ss.lfm2_predict_ss(*args64, noise_var=nv.double(), interp="bridge")
    diffs[torch.float64] = [float((a - b).abs().max()) for a, b in zip(u64[:2], b64[:2])]
    f_at_train = ss.lfm2_predict_ss(p64, t64, y32.double(), t64, noise_var=nv.double(),
                                    interp="bridge")[0]
    corr_f = _corr(f_at_train, dense.data.f_true)
    print(f"[dense simm2 ss] bridge vs union max |diff| (f_mean, f_var): f64 "
          f"{diffs[torch.float64]} (limits 1e-5, 1e-6), f32 {diffs[f32]}; smoothed force "
          f"(f64, bridge, training grid) corr with the generating force {corr_f:.4f} ({smi})")
    require(diffs[torch.float64][0] <= 1e-5 and diffs[torch.float64][1] <= 1e-6,
            f"dense simm2 ss bridge vs union f64: {diffs[torch.float64]}")

    # float64 parity at the init point with the exact MLL on the same data.
    model = simm2.SecondOrderSIMM(num_genes=G, jitter=cfg.EXACT_JITTER)
    y64 = y32.double()
    raw64 = type(raw32)(*(r.double() for r in raw32))
    le, ge = generic.value_and_grad(
        lambda r: model.mll_gridded(simm2.constrain(r), t64, y64), raw64)
    ls, gs = generic.value_and_grad(
        lambda r: ss.lfm2_mll_ss(simm2.constrain(r), t64, y64, jitter=cfg.EXACT_JITTER), raw64)
    rel = abs(float(ls) - float(le)) / max(1.0, abs(float(le)))
    cos = _cosine(_flat_grad(gs), _flat_grad(ge))
    print(f"[dense simm2 ss] f64 parity at init: exact {float(le)!r} ss {float(ls)!r}, "
          f"|diff| / max(1, |MLL|) {rel:.3e} (limit 5e-3); raw-gradient cosine {cos:.6f} "
          f"(limit 0.999) ({smi})")
    require(rel <= 5e-3, f"dense simm2 ss parity: {rel}")
    require(cos >= 0.999, f"dense simm2 ss parity gradient cosine {cos}")
    return dict(median=median, spread=q3 - q1, peak_gib=peak_gib, corr=(corr_a, corr_w),
                syncs=syncs, busy=busy)


def simm2_phases(drive, smi):
    """The second-order family's phases; prints their total wall seconds."""
    t0 = time.perf_counter()
    simm2_erf(smi)
    p53 = simm2_p53(drive, smi)
    chol = dense_simm2(drive, smi)
    ssr = dense_simm2_ss(drive, chol, smi)
    print(f"[simm2] dense10k step median: cholesky {chol['median']:.3f} ms (spread "
          f"{chol['spread']:.3f}, {chol['peak_gib']:.3f} GiB, all finite {chol['finite']}), ss "
          f"{ssr['median']:.3f} ms (spread {ssr['spread']:.3f}); p53 150 steps "
          f"{p53['wall_s']:.3f} s ({smi})")
    print(f"[simm2 phases] erf, p53, dense cholesky and dense ss took "
          f"{time.perf_counter() - t0:.1f} s")



def multisimm_p53(drive, smi):
    """``[multisimm p53]``: ``main.run_multiforce`` (``--model multisimm``,
    R = 2, the p53 synthetic data, float64, 150 iterations) on the card and
    on the CPU in this process: the final loss within rel 1e-6, the first
    step within rel 1e-10 (the ``[simm2 p53]`` limits), the per-force
    posteriors (R, 100) finite; no kernel launches (the R-force Gram has no
    hand-written kernel; N = 35 in float64 takes no K3); the wall and the
    host syncs per training step."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import multisimm
    from dis_project_tpu_torch.training import generic

    tmp = tempfile.mkdtemp(prefix="chip_smoke_multisimm_")
    runs = {}
    for device in ("cuda", "cpu"):
        config = cfg.RunConfig(model="multisimm", num_forces=2, num_iters=150, device=device,
                               out_dir=os.path.join(tmp, device),
                               metrics_path=os.path.join(tmp, f"{device}.jsonl"))
        runs[device] = drive(f"multisimm p53 {device}",
                             lambda: port_main.run_multiforce(config), (), launch_free=True)
    card, host = runs["cuda"], runs["cpu"]
    hc, hh = card.result.history.tolist(), host.result.history.tolist()
    rel_final = abs(hc[-1] - hh[-1]) / abs(hh[-1])
    rel_first = abs(hc[0] - hh[0]) / abs(hh[0])
    lat = card.latent
    print(f"[multisimm p53] R=2, 150 steps f64: final loss card {hc[-1]!r} cpu {hh[-1]!r} rel "
          f"{rel_final:.3e} (limit 1e-6); first step rel {rel_first:.3e} (limit 1e-10); wall "
          f"card {card.wall_s:.3f} s ({1e3 * card.wall_s / 150:.1f} ms a step), cpu "
          f"{host.wall_s:.3f} s; trained lengthscales "
          f"{[round(float(v), 4) for v in card.result.params.lengthscale]} ({smi})")
    require(rel_final <= 1e-6, f"multisimm p53 final loss card vs cpu: {rel_final}")
    require(rel_first <= 1e-10, f"multisimm p53 first step card vs cpu: {rel_first}")
    require(tuple(lat.mean.shape) == (2, 100) and bool(torch.isfinite(lat.mean).all()
                                                      and torch.isfinite(lat.cov).all()),
            "multisimm p53 per-force posteriors not (2, 100) and finite")

    dev = torch.device("cuda")
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, _ = train_arrays(data, dev, torch.float64)
    model = multisimm.ExactMultiSIMM(num_genes=5, num_forces=2, jitter=cfg.EXACT_JITTER)
    raw = multisimm.unconstrain(multisimm.init_params(5, 2, torch.float64, dev))
    _, syncs = count_syncs(lambda: generic.fit_loop(
        lambda r: -model.mll(multisimm.constrain(r), X, y), raw, num_iters=3))
    print(f"[multisimm p53] host syncs per training step {syncs / 3:.1f} ({smi})")
    shutil.rmtree(tmp)
    return dict(wall_s=card.wall_s)


def dense_multisimm_ss(drive, smi):
    """``[dense multisimm ss]``: ``main.run_dense --model multisimm
    --mll-engine ss`` at dense10k's full width (50 x 200 = 1e4, R = 2,
    order 10, m = 70), float32, DENSE_STEPS steps on the schedule
    ``parallel=None`` picks: step ms and spread, host syncs per loss and
    gradient, device busy share, peak memory, the matched recovery; float64
    on the card against ``ExactMultiSIMM.mll`` on the JAX package's 3 x 9
    problem at orders 8 and 10 (2e-3, 5e-4); the float32 first step within
    rel 1e-4 of float64; one ``--force-kernel matern32`` loss and gradient,
    finite."""
    import numpy as np
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import multisimm
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    G, T, steps = DENSE_GENES, DENSE_TIMEPOINTS, DENSE_STEPS
    held = {}

    def run():
        torch.cuda.reset_peak_memory_stats(dev)
        held["bytes"] = torch.cuda.memory_allocated(dev)
        return port_main.run_dense(cfg.RunConfig(
            preset="dense10k", model="multisimm", num_forces=2, synth_genes=G,
            synth_timepoints=T, num_iters=steps, x64=False, device="cuda", mll_engine="ss"))

    dense = drive("dense multisimm ss", run, (), launch_free=True)
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    hist = dense.result.history.tolist()
    step_ms = [1e3 * t for t in dense.step_seconds]
    median = statistics.median(step_ms[1:])
    q1, _, q3 = statistics.quantiles(step_ms[1:], n=4)
    vg_us = [1e6 * st["value_and_grad_host_s"] / T for st in dense.ss_stats]
    pick = _schedule_name(ss._select_schedule(None, T, dev)[0])
    p = dense.result.params
    corr_d = _corr(p.decay, dense.data.params_true["decay"])
    corr_s = port_main.matched_force_correlations(
        p.sensitivity.detach().cpu().numpy(),
        dense.data.params_true["sensitivity"].detach().cpu().numpy())
    print(f"[dense multisimm ss] N={G * T} R=2 m={20 + G} f32 losses {hist}; recovery "
          f"corr(decay) {corr_d:.4f}, matched corr(S[:, r]) {[round(c, 4) for c in corr_s]} "
          f"({smi})")
    print(f"[dense multisimm ss] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) "
          f"{median:.3f}, spread (interquartile) {q3 - q1:.3f}; schedule (parallel=None) {pick}; "
          f"host us per filter step, loss and gradient {[round(u, 1) for u in vg_us]}; peak "
          f"memory {peak_gib:.3f} GiB ({smi})")
    require(all(math.isfinite(v) for v in hist), "dense multisimm ss losses not finite")

    y32, t32 = dense.y, dense.data.timepoints
    raw32 = multisimm.unconstrain(multisimm.init_params(G, 2, f32, dev))
    raw64 = type(raw32)(*(r.double() for r in raw32))

    def objective(y, t, **kw):
        return lambda r: -ss.multisimm_mll_ss(multisimm.constrain(r), t, y,
                                              jitter=cfg.EXACT_JITTER, **kw)

    (l32, _), syncs = count_syncs(lambda: generic.value_and_grad(objective(y32, t32), raw32))
    busy = device_busy_ms(lambda: generic.value_and_grad(objective(y32, t32), raw32))
    share = "not measured (no device time in the trace)" if busy is None else \
        f"{busy:.3f} ms busy in one value and gradient, {busy / median:.3f} of the step median"
    leaves = type(raw32)(*(r.detach().requires_grad_(True) for r in raw32))
    loss = objective(y32, t32)(leaves)
    stage_ms = {
        "loss (multisimm_mll_ss)": cuda_ms(lambda: objective(y32, t32)(leaves), reps=3),
        "backward": cuda_ms(lambda: torch.autograd.grad(loss, tuple(leaves), retain_graph=True),
                            reps=3),
    }
    print(f"[dense multisimm ss] stage ms {json.dumps(stage_ms)} ({smi})")
    l64, _ = generic.value_and_grad(objective(y32.double(), t32.double()), raw64)
    rel = abs(float(l32) - float(l64)) / abs(float(l64))
    print(f"[dense multisimm ss] first step: loss f32 {float(l32)!r} f64 {float(l64)!r} rel "
          f"{rel:.3e} (limit 1e-4); host syncs per loss and gradient {syncs}; device {share} "
          f"({smi})")
    require(rel <= 1e-4, f"dense multisimm ss first-step loss f32 vs f64: {rel}")
    lm, gm = generic.value_and_grad(objective(y32, t32, force_kernels=("matern32",) * 2), raw32)
    finite = math.isfinite(float(lm)) and all(bool(torch.isfinite(g).all()) for g in gm)
    print(f"[dense multisimm ss] --force-kernel matern32 (both forces): loss {float(lm)!r}, "
          f"gradient finite {finite} ({smi})")
    require(finite, "dense multisimm ss matern32 loss or gradient not finite")

    # float64 parity on the JAX package's multi-force test problem.
    gen = np.random.default_rng(0)
    Gs, Ts = 3, 9
    p64 = multisimm.init_params(Gs, 2, f64, dev)._replace(
        sensitivity=torch.tensor(gen.uniform(0.4, 1.4, (Gs, 2)), dtype=f64, device=dev),
        lengthscale=torch.tensor([1.2, 3.0], dtype=f64, device=dev),
        decay=torch.tensor([0.4, 0.8, 1.2], dtype=f64, device=dev))
    ts = torch.linspace(0.0, 12.0, Ts, dtype=f64, device=dev)
    ys = torch.tensor(np.random.default_rng(1).normal(size=Gs * Ts), dtype=f64, device=dev)
    X = torch.stack([ts.repeat(Gs), torch.arange(Gs, dtype=f64, device=dev).repeat_interleave(Ts),
                     torch.ones(Gs * Ts, dtype=f64, device=dev)], dim=1)
    exact = float(multisimm.ExactMultiSIMM(num_genes=Gs, num_forces=2, jitter=1e-4).mll(
        p64, X, ys))
    errs = {o: abs(float(ss.multisimm_mll_ss(p64, ts, ys, jitter=1e-4, order=o)) - exact)
            for o in (8, 10)}
    print(f"[dense multisimm ss] f64 3 x 9: |ss - exact| order 8 {errs[8]:.3e} (limit 2e-3), "
          f"order 10 {errs[10]:.3e} (limit 5e-4) ({smi})")
    require(errs[8] < 2e-3 and errs[10] < 5e-4, f"dense multisimm ss parity: {errs}")
    return dict(median=median, spread=q3 - q1, peak_gib=peak_gib, syncs=syncs, busy=busy)


def _kernel_check(kernel, plain):
    """``(err, ms, plain_ms)``: the max abs error of ``kernel()`` against
    ``plain()`` (tuples compared leaf by leaf) relative to max(1,
    max|plain|), and both timed."""
    import torch

    got, ref = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(got, ref))
    ms, plain_ms = cuda_ms(kernel, reps=20), cuda_ms(plain, reps=20)
    torch.cuda.synchronize()
    return err, ms, plain_ms


def delay_p53(drive, smi):
    """``[delay p53]``: ``main.run_delay`` (``--model delaysimm``, p21 pinned,
    the p53 synthetic data, float64, 150 iterations) on the card and on the
    CPU in this process, each in its own temporary working directory (the
    route writes ``hyperparams.csv`` there): the final loss within rel
    1e-6, the first step within rel 1e-10; on the card K2 and K2's backward
    once per gradient evaluation, K1 in the latent posterior, and the plain
    VJP of the rows' gradient (the delays') once per gradient evaluation.
    Then at the trained warped rows (genes clamped to t = 0 included) K2,
    K2's backward (on the MLL's own cotangent) and K1 against their plain
    versions within 1e-10, timed; with every delay 0 the MLL bitwise equal
    to ``ExactSIMM.mll``; the delay gradient within 1e-10 relative of the
    all-plain float64 path."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import delaysimm, simm
    from dis_project_tpu_torch.ops import cuda_gram
    from dis_project_tpu_torch.ops import gram as gram_ops
    from dis_project_tpu_torch.ops import mll as mll_ops
    from dis_project_tpu_torch.training import generic
    from dis_project_tpu_torch.utils.test_grids import latent_grid

    tmp = tempfile.mkdtemp(prefix="chip_smoke_delay_")
    cwd = os.getcwd()
    runs, launched = {}, {}

    def grad_evals(out):
        return len(out.result.history) + out.result.guard_count

    def route(config):
        out = port_main.run_delay(config)
        launched[config.device] = dict(cuda_gram.LAUNCHES)
        return out

    try:
        for device in ("cuda", "cpu"):
            os.makedirs(os.path.join(tmp, device))
            os.chdir(os.path.join(tmp, device))
            config = cfg.RunConfig(model="delaysimm", num_iters=150, device=device,
                                   out_dir=os.path.join(tmp, device, "plots"),
                                   metrics_path=os.path.join(tmp, f"{device}.jsonl"))
            launches = ("gram_sym", "gram_sym_bwd", "gram_rect") if device == "cuda" else ()
            runs[device] = drive(f"delay p53 {device}", lambda: route(config), launches,
                                 x_grads=grad_evals if device == "cuda" else None)
    finally:
        os.chdir(cwd)
    card, host = runs["cuda"], runs["cpu"]
    # One K2 and one K2 bwd per gradient evaluation, the posterior's two K2
    # (training and test rows) and one K1.
    want = {"gram_sym": grad_evals(card) + 2, "gram_sym_bwd": grad_evals(card), "gram_rect": 1}
    require(launched["cuda"] == want, f"delay p53 launches {launched['cuda']}, not {want}")
    hc, hh = card.result.history.tolist(), host.result.history.tolist()
    rel_final = abs(hc[-1] - hh[-1]) / abs(hh[-1])
    rel_first = abs(hc[0] - hh[0]) / abs(hh[0])
    params = card.result.params
    print(f"[delay p53] 150 steps f64: final loss card {hc[-1]!r} cpu {hh[-1]!r} rel "
          f"{rel_final:.3e} (limit 1e-6); first step rel {rel_first:.3e} (limit 1e-10); wall "
          f"card {card.wall_s:.3f} s ({1e3 * card.wall_s / 150:.1f} ms a step), cpu "
          f"{host.wall_s:.3f} s; gradient evaluations {grad_evals(card)}; trained delays "
          f"{[round(float(v), 4) for v in params.delay]} ({smi})")
    require(rel_final <= 1e-6, f"delay p53 final loss card vs cpu: {rel_final}")
    require(rel_first <= 1e-10, f"delay p53 first step card vs cpu: {rel_first}")
    require(bool(torch.isfinite(card.latent.mean).all()), "delay p53 latent force not finite")

    # The kernels at the trained warped rows, against their plain versions.
    dev, f64 = torch.device("cuda"), torch.float64
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, var = train_arrays(data, dev, f64)
    model = delaysimm.ExactDelaySIMM(num_genes=5, jitter=cfg.EXACT_JITTER)
    xw = delaysimm.warp_rows(X, params.delay, 5)
    grid = latent_grid(100, dtype=f64, device=dev)
    d, s, ell = params.decay, params.sensitivity, params.lengthscale
    clamped = int((xw[:, 0] == 0).sum())
    K = cuda_gram.gram_sym_plain(xw, d, s, ell, "mixed").requires_grad_(True)
    loss = -mll_ops.mvn_logpdf(y, model.mean_function(params, X),
                               mll_ops.add_diagonal(K, model.jitter + params.obs_stddev**2))
    (g_K,) = torch.autograd.grad(loss, K)
    checks = {
        "K2": _kernel_check(lambda: cuda_gram.gram_sym_kernel(xw, d, s, ell, "mixed"),
                            lambda: cuda_gram.gram_sym_plain(xw, d, s, ell, "mixed")),
        "K2 bwd": _kernel_check(
            lambda: cuda_gram.gram_sym_bwd_kernel(xw, d, s, ell, "mixed", g_K),
            lambda: cuda_gram.gram_sym_vjp_plain(xw, d, s, ell, "mixed", g_K,
                                                 (False, True, True, True))[1:]),
        "K1": _kernel_check(lambda: cuda_gram.gram_rect_kernel(xw, grid, d, s, ell, "mixed"),
                            lambda: gram_ops.cross_covariance_kind(xw, grid, d, s, ell, "mixed")),
    }
    for name, (err, ms, plain_ms) in checks.items():
        shape = "35 x 100-point latent grid" if name == "K1" else "N=35"
        print(f"[delay p53] {name} at the trained warped rows ({shape}, {clamped} rows clamped "
              f"to t = 0) f64: max abs err / max(1, |plain|) {err:.3e} (limit 1e-10); ms "
              f"{ms:.4f} plain_ms {plain_ms:.4f} ({smi})")
        require(err <= 1e-10, f"delay p53 {name} vs plain at the warped rows: {err}")

    # Zero delays: bitwise ExactSIMM.
    p0 = params._replace(delay=torch.zeros_like(params.delay))
    m_delay = model.mll(p0, X, y)
    m_simm = simm.ExactSIMM(num_genes=5, jitter=cfg.EXACT_JITTER).mll(simm.SIMMParams(*p0[:5]),
                                                                      X, y)
    same = bool(torch.equal(m_delay, m_simm))
    print(f"[delay p53] every delay 0: MLL {float(m_delay)!r} vs ExactSIMM {float(m_simm)!r}, "
          f"bitwise equal {same} ({smi})")
    require(same, "delay p53 zero-delay MLL differs from ExactSIMM's")

    # The delay gradient through the kernels against the all-plain path.
    raw = delaysimm.unconstrain(params)
    plain_model = delaysimm.ExactDelaySIMM(num_genes=5, jitter=cfg.EXACT_JITTER, kernels=False)
    _, g_k = generic.value_and_grad(lambda r: -model.mll(delaysimm.constrain(r), X, y), raw)
    _, g_p = generic.value_and_grad(lambda r: -plain_model.mll(delaysimm.constrain(r), X, y), raw)
    rels = {name: float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
            for name, a, b in zip(raw._fields, g_k, g_p)}
    print(f"[delay p53] raw gradient through K2, K2 bwd and the rows' plain VJP vs the all-plain "
          f"f64 path, max abs err / max(1, |plain|): {json.dumps(rels)} (limit 1e-10); delay "
          f"gradient {[float(v) for v in g_k.delay]} ({smi})")
    require(max(rels.values()) <= 1e-10, f"delay p53 gradient vs all-plain: {rels}")
    require(bool((g_k.delay != 0).any()), "delay p53 delay gradient is zero")
    shutil.rmtree(tmp)
    return dict(wall_s=card.wall_s, checks=checks)


def dense_delay_ss(drive, smi):
    """``[dense delay ss]``: ``main.run_dense --model delaysimm --mll-engine
    ss`` at dense10k's full width (50 x 200: 10,000 warped events, order
    10, m = 60), float32, DELAY_STEPS steps (DELAY_STEPS_SLOW when the first
    step takes more than 5 s): step ms and spread, host syncs per loss and
    gradient, device busy share, peak memory, gene 0's delay pinned, the
    recovery; float64 on the card on the JAX package's 3 x 9 problem:
    ``delaysimm_mll_ss`` against ``ExactDelaySIMM.mll`` at orders 8 and 12
    (5e-3, 2e-4), the order-12 raw gradients (delays included) within 5e-4
    relative, and the zero-delay reduction to ``lfm_mll_ss`` within 1e-9."""
    import numpy as np
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import delaysimm, simm
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    G, T = DENSE_GENES, DENSE_TIMEPOINTS
    held = {}

    def run(steps):
        torch.cuda.reset_peak_memory_stats(dev)
        held["bytes"] = torch.cuda.memory_allocated(dev)
        return port_main.run_dense(cfg.RunConfig(
            preset="dense10k", model="delaysimm", synth_genes=G, synth_timepoints=T,
            num_iters=steps, x64=False, device="cuda", mll_engine="ss"))

    # One step first: it decides how many the measured run takes.
    probe = run(1)
    steps = DELAY_STEPS if probe.step_seconds[0] <= 5.0 else DELAY_STEPS_SLOW
    dense = drive("dense delay ss", lambda: run(steps), (), launch_free=True)
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    hist = dense.result.history.tolist()
    step_ms = [1e3 * t for t in dense.step_seconds]
    later = step_ms[1:] or step_ms
    median = statistics.median(later)
    spread = statistics.quantiles(later, n=4)[2] - statistics.quantiles(later, n=4)[0] \
        if len(later) >= 2 else float("nan")
    n_ev = G * T
    vg_us = [1e6 * st["value_and_grad_host_s"] / n_ev for st in dense.ss_stats]
    pick = _schedule_name(ss._select_schedule(None, n_ev, dev)[0])
    p = dense.result.params
    pinned = float(dense.result.raw.delay[0]) == delaysimm.ZERO_DELAY_RAW
    corr_d = _corr(p.decay, dense.data.params_true["decay"])
    corr_del = _corr(p.delay, dense.data.params_true["delay"])
    print(f"[dense delay ss] N={n_ev} warped events, f32, {steps} steps (probe step "
          f"{1e3 * probe.step_seconds[0]:.1f} ms; 5 s limit) losses {hist}; gene 0's raw delay "
          f"pinned at -20: {pinned}; recovery corr(decay) {corr_d:.4f} corr(delay) "
          f"{corr_del:.4f} ({smi})")
    print(f"[dense delay ss] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) "
          f"{median:.3f}, spread (interquartile) {spread:.3f}; schedule (parallel=None) {pick}; "
          f"host us per event, loss and gradient {[round(u, 1) for u in vg_us]}; peak memory "
          f"{peak_gib:.3f} GiB (the batched matrix_exp's backward over {n_ev} {10 + G} x "
          f"{10 + G} matrices) ({smi})")
    require(all(math.isfinite(v) for v in hist), "dense delay ss losses not finite")
    require(pinned, "dense delay ss: gene 0's delay left its pin")

    raw32 = delaysimm.unconstrain(delaysimm.init_params(G, f32, dev))
    t32 = dense.data.timepoints

    def objective(r):
        return -ss.delaysimm_mll_ss(delaysimm.constrain(r), t32, dense.y,
                                    jitter=cfg.EXACT_JITTER)

    _, syncs = count_syncs(lambda: generic.value_and_grad(objective, raw32))
    busy = device_busy_ms(lambda: generic.value_and_grad(objective, raw32))
    share = "not measured (no device time in the trace)" if busy is None else \
        f"{busy:.3f} ms busy in one value and gradient, {busy / median:.3f} of the step median"
    print(f"[dense delay ss] host syncs per loss and gradient {syncs}; device {share} ({smi})")

    # Where the step goes: its stages alone with CUDA events at the init
    # point, and the peak memory of the batched matrix_exp with its backward.
    leaves = type(raw32)(*(r.detach().requires_grad_(True) for r in raw32))
    p0 = delaysimm.constrain(leaves)
    f_aug, p_inf, _, _ = ss.build_lfm_ssm(p0.decay, p0.sensitivity, p0.lengthscale)
    ev_t = ss._delay_event_grid(p0, t32, 1)[0]
    dts = torch.diff(ev_t, prepend=torch.zeros(1, dtype=f32, device=dev))

    def expm_fwd_bwd():
        a, q = ss.discretize(f_aug, p_inf, dts)
        return torch.autograd.grad(a.sum() + q.sum(), tuple(leaves), allow_unused=True,
                                   retain_graph=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    expm_fwd_bwd()
    expm_peak = (torch.cuda.max_memory_allocated(dev) - before) / 2**30
    loss = objective(leaves)
    stages = {
        "discretize (matrix_exp over the events)": lambda: ss.discretize(f_aug, p_inf, dts),
        "discretize forward and backward": expm_fwd_bwd,
        "loss (delaysimm_mll_ss)": lambda: objective(leaves),
        "backward": lambda: torch.autograd.grad(loss, tuple(leaves), retain_graph=True),
    }
    stage_ms = {name: cuda_ms(fn, reps=3, warmup=1) for name, fn in stages.items()}
    print(f"[dense delay ss] stage ms {json.dumps(stage_ms)}; the discretize forward and "
          f"backward's peak memory {expm_peak:.3f} GiB ({smi})")

    # float64 on the card, the JAX package's delay test problem.
    Gs, Ts = 3, 9
    kw = dict(dtype=f64, device=dev)
    ts = torch.linspace(0.0, 12.0, Ts, **kw)
    ys = torch.tensor(np.random.default_rng(5).normal(size=Gs * Ts), **kw)
    pd = delaysimm.init_params(Gs, f64, dev)._replace(
        delay=torch.tensor([0.5, 0.05, 1.3], **kw), decay=torch.tensor([0.4, 0.9, 0.6], **kw),
        sensitivity=torch.tensor([1.0, 0.8, 1.2], **kw))
    X = torch.stack([ts.repeat(Gs), torch.arange(Gs, **kw).repeat_interleave(Ts),
                     torch.ones(Gs * Ts, **kw)], dim=1)
    model = delaysimm.ExactDelaySIMM(num_genes=Gs, jitter=1e-4)
    dense_mll = float(model.mll(pd, X, ys))
    errs = {o: abs(float(ss.delaysimm_mll_ss(pd, ts, ys, jitter=1e-4, order=o)) - dense_mll)
            for o in (8, 12)}
    raw = delaysimm.unconstrain(pd)
    _, gd = generic.value_and_grad(lambda r: model.mll(delaysimm.constrain(r), X, ys), raw)
    _, gs = generic.value_and_grad(lambda r: ss.delaysimm_mll_ss(
        delaysimm.constrain(r), ts, ys, jitter=1e-4, order=12), raw)
    grel = {name: float((a - b).abs().max()) / (float(a.abs().max()) + 1.0)
            for name, a, b in zip(raw._fields, gd, gs)}
    p0 = pd._replace(delay=torch.zeros(Gs, **kw))
    v1 = float(ss.lfm_mll_ss(simm.SIMMParams(*p0[:5]), ts, ys, jitter=1e-4))
    v2 = float(ss.delaysimm_mll_ss(p0, ts, ys, jitter=1e-4))
    zero = abs(v1 - v2) / max(1.0, abs(v1))
    print(f"[dense delay ss] f64 3 x 9 ({_schedule_name(ss._select_schedule(None, 27, dev)[0])} "
          f"scalar chain): |ss - exact| order 8 {errs[8]:.3e} (limit 5e-3), order 12 "
          f"{errs[12]:.3e} (limit 2e-4); order-12 gradients vs exact, max / (max|g| + 1) "
          f"{json.dumps(grel)} (limit 5e-4); zero delays vs lfm_mll_ss {zero:.3e} (limit 1e-9) "
          f"({smi})")
    require(errs[8] < 5e-3 and errs[12] < 2e-4, f"dense delay ss parity: {errs}")
    require(max(grel.values()) < 5e-4, f"dense delay ss gradient parity: {grel}")
    require(zero < 1e-9, f"dense delay ss zero-delay reduction: {zero}")
    return dict(median=median, spread=spread, peak_gib=peak_gib, steps=steps, syncs=syncs,
                busy=busy)


def family_phases(drive, smi):
    """The multi-force and delayed-response families' phases; prints their
    total wall seconds."""
    t0 = time.perf_counter()
    mp = multisimm_p53(drive, smi)
    mss = dense_multisimm_ss(drive, smi)
    dp = delay_p53(drive, smi)
    dss = dense_delay_ss(drive, smi)
    print(f"[families] dense10k ss step median: multisimm (R=2) {mss['median']:.3f} ms (spread "
          f"{mss['spread']:.3f}, {mss['peak_gib']:.3f} GiB), delaysimm {dss['median']:.3f} ms "
          f"(spread {dss['spread']:.3f}, {dss['peak_gib']:.3f} GiB, {dss['steps']} steps); p53 "
          f"150 steps multisimm {mp['wall_s']:.3f} s, delaysimm {dp['wall_s']:.3f} s ({smi})")
    print(f"[family phases] multisimm p53, dense multisimm ss, delay p53 and dense delay ss took "
          f"{time.perf_counter() - t0:.1f} s")


# The sparse100k configuration (BASELINE config 5 of the JAX package): 100
# genes x 1000 timepoints (N = 1e5), M = 128 inducing points, batches of
# 2048, 25 epochs (49 steps an epoch). The order-2 and multi-force variants
# run at the same width with their epochs cut (SPARSE_VARIANT_EPOCHS).
SPARSE_GENES, SPARSE_TIMEPOINTS, SPARSE_M, SPARSE_BS, SPARSE_EPOCHS = 100, 1000, 128, 2048, 25
SPARSE_VARIANT_EPOCHS = {"simm2": 2, "multisimm": 8}
SPARSE_TIMED_STEPS = 50


def _svi_step_times(run, smi, tag):
    """Per-step times of the route's SVI step on its own data at the init
    point (SPARSE_TIMED_STEPS steps, each between CUDA events, batches
    drawn from ``svtrainer.epoch_indices``), the host syncs per step
    (``count_syncs``) and the device-busy share of one step
    (``device_busy_ms``): (median ms, interquartile spread, syncs per step,
    busy ms or None)."""
    import torch

    from dis_project_tpu_torch.models import svlfm
    from dis_project_tpu_torch.training import svtrainer

    model, X, y, var = run.model, run.X, run.y, run.var
    n = X.shape[0]
    config = svtrainer.SVTrainConfig(batch_size=SPARSE_BS)
    init = svlfm.init_params(model.num_genes, model.num_inducing, dtype=X.dtype,
                             order=model.order, num_forces=model.num_forces, device=X.device)
    raw = svlfm.unconstrain(init)
    opt = svtrainer.make_optimizer(config, init)
    state = {"leaves": svtrainer.flatten(raw)}
    state["opt"] = opt.init(state["leaves"])
    idx = svtrainer.epoch_indices(0, 0, n, SPARSE_BS).to(X.device)

    def step(b):
        bidx = idx[b % idx.shape[0]]
        state["leaves"], state["opt"], loss = svtrainer.svi_step(
            model, opt, raw, n, state["leaves"], state["opt"], X[bidx], y[bidx], var[bidx])
        return loss

    for b in range(3):  # warm-up
        step(b)
    torch.cuda.synchronize()
    ms = []
    for b in range(SPARSE_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(b)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    median = statistics.median(ms)
    q1, _, q3 = statistics.quantiles(ms, n=4)
    _, syncs = count_syncs(lambda: [step(b) for b in range(10)])
    busy = device_busy_ms(lambda: step(0))
    share = "not measured (no device time in the trace)" if busy is None else \
        f"{busy:.3f} ms busy in one step, {busy / median:.3f} of the step median"
    print(f"[{tag}] step ms over {SPARSE_TIMED_STEPS} steps (CUDA events): median {median:.3f}, "
          f"spread (interquartile) {q3 - q1:.3f}, min {min(ms):.3f}, max {max(ms):.3f}; host "
          f"syncs per step {syncs / 10:.2f}; device {share} ({smi})")
    return median, q3 - q1, syncs / 10, busy


def _sparse_run(drive, tag, argv):
    """``main.main`` on a sparse100k argv on the card (float32), counts from
    0 (no kernel may launch: the route has none), with the peak memory above
    what the script held before it."""
    import torch

    from dis_project_tpu_torch import main as port_main

    dev = torch.device("cuda")
    held = {}

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held["bytes"] = torch.cuda.memory_allocated(dev)
        return port_main.main(argv)

    out = drive(tag, run, (), launch_free=True)
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    return out, peak_gib


def _sparse_report(tag, out, peak_gib, smi):
    hist = out.history
    first, last = float(hist[0].mean()), float(hist[-1].mean())
    finite = bool(all(math.isfinite(v) for v in hist.reshape(-1).tolist()))
    print(f"[{tag}] N={out.X.shape[0]} M={out.model.num_inducing} R={out.model.num_forces} "
          f"order {out.model.order}, {hist.shape[0]} epochs x {hist.shape[1]} steps f32: data "
          f"{out.data_s:.3f} s, fit {out.fit_s:.3f} s ({1e3 * out.fit_s / hist.size:.3f} ms a "
          f"step, the history's read included); neg-ELBO epoch means "
          f"{[round(float(r.mean()), 1) for r in hist]}; first {first!r} last {last!r}; "
          f"recovery corr {[round(c, 4) for c in out.corrs]}; peak memory {peak_gib:.3f} GiB; "
          f"all finite {finite} ({smi})")
    require(finite, f"{tag}: history not finite")
    require(last < first, f"{tag}: last epoch's mean neg-ELBO {last} not below the first {first}")
    return first, last


def sparse_route(drive, smi, tmp):
    """``[sparse]``: the full sparse100k route (first order, float32) through
    ``main.main``: 100 x 1000 = 1e5 rows, M = 128, B = 2048, 25 epochs (1225
    steps). Data and fit wall seconds apart, the step's time, syncs and busy
    share, peak memory, the first and last epochs' mean neg-ELBO, the
    recovery correlation; requires a finite history, a last epoch below the
    first, |corr| >= 0.9 and no host sync in the steps."""
    argv = ["--preset", "sparse100k", "--no-x64", "--out-dir", tmp,
            "--metrics-path", os.path.join(tmp, "sparse.jsonl")]
    out, peak_gib = _sparse_run(drive, "sparse", argv)
    require((out.X.shape[0], out.model.num_inducing, out.history.shape) ==
            (SPARSE_GENES * SPARSE_TIMEPOINTS, SPARSE_M, (SPARSE_EPOCHS, 49)),
            f"sparse: not the sparse100k shape: {out.X.shape}, {out.history.shape}")
    _sparse_report("sparse", out, peak_gib, smi)
    require(abs(out.corrs[0]) >= 0.9, f"sparse: recovery |corr| {out.corrs[0]} < 0.9")
    with open(os.path.join(tmp, "sparse.jsonl")) as f:
        require(len(f.readlines()) == SPARSE_EPOCHS, "sparse: metrics file not one line an epoch")
    median, spread, syncs, busy = _svi_step_times(out, smi, "sparse")
    require(syncs == 0, f"sparse: {syncs} host syncs per step")
    # The fit itself (the pinned, non-blocking copies of the index tables
    # included) must not wait for the card either.
    import torch

    from dis_project_tpu_torch.models import svlfm
    from dis_project_tpu_torch.training import svtrainer

    init = svlfm.init_params(SPARSE_GENES, SPARSE_M, dtype=torch.float32, device=out.X.device)
    _, fit_syncs = count_syncs(lambda: svtrainer.fit(
        out.model, init, out.X, out.y, out.var,
        svtrainer.SVTrainConfig(num_epochs=2, batch_size=SPARSE_BS)))
    print(f"[sparse] host syncs in svtrainer.fit over 2 epochs (98 steps): {fit_syncs} ({smi})")
    require(fit_syncs == 0, f"sparse: svtrainer.fit synchronised {fit_syncs} times")
    return dict(median=median, spread=spread, busy=busy, fit_s=out.fit_s, data_s=out.data_s,
                peak_gib=peak_gib, corr=out.corrs[0])


def _host_rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1e-300, float(np.max(np.abs(b)))))


def sparse_parity(smi):
    """``[sparse parity]``: 20 steps of ``svtrainer.fit`` (20 x 200 rows,
    M = 128, batches of 400, 2 epochs) in float64 on the card and on the
    CPU, from the same data and the same index tables: the history and every
    raw leaf within rel 1e-8 (leaves: of their largest entry); the float32
    card run's first-step neg-ELBO within rel 1e-4 of float64's."""
    import torch

    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import svlfm
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.training import svtrainer

    G, T, M, bs = 20, 200, 128, 400
    data = port_main.synthetic_sparse_data(G, T, 1, 1, 0, torch.float64, "cpu")
    model = svlfm.SparseSIMM(num_genes=G, num_inducing=M, jitter=1e-6)
    config = svtrainer.SVTrainConfig(num_epochs=2, batch_size=bs)
    runs = {}
    for device, dtype in (("cuda", torch.float64), ("cpu", torch.float64),
                          ("cuda", torch.float32)):
        X, y, var = (a.to(device) for a in train_arrays(data, "cpu", dtype))
        init = svlfm.init_params(G, M, dtype=dtype, device=device)
        t0 = time.perf_counter()
        res = svtrainer.fit(model, init, X, y, var, config)
        runs[(device, dtype)] = (res, res.history.cpu().numpy(), time.perf_counter() - t0)
    card, host = runs[("cuda", torch.float64)], runs[("cpu", torch.float64)]
    rel_hist = _host_rel(card[1], host[1])
    rel_leaf = max(_host_rel(a.cpu().numpy(), b.numpy()) for a, b in zip(
        svtrainer.flatten(card[0].raw_params), svtrainer.flatten(host[0].raw_params)))
    f32 = runs[("cuda", torch.float32)][1]
    rel32 = abs(float(f32[0, 0]) - float(card[1][0, 0])) / abs(float(card[1][0, 0]))
    print(f"[sparse parity] 20 steps f64 card vs cpu: history rel {rel_hist:.3e}, raw leaves "
          f"rel {rel_leaf:.3e} (limit 1e-8); final neg-ELBO card {card[1][-1, -1]!r} cpu "
          f"{host[1][-1, -1]!r}; wall card {card[2]:.3f} s cpu {host[2]:.3f} s; f32 first step "
          f"{float(f32[0, 0])!r} vs f64 {float(card[1][0, 0])!r} rel {rel32:.3e} (limit 1e-4) "
          f"({smi})")
    require(rel_hist <= 1e-8 and rel_leaf <= 1e-8,
            f"sparse parity card vs cpu: history {rel_hist}, leaves {rel_leaf}")
    require(rel32 <= 1e-4, f"sparse parity f32 first step vs f64: {rel32}")


def sparse_variant(drive, smi, tmp, model):
    """``[sparse simm2]`` / ``[sparse multisimm]`` (R = 2): the route's
    other variants at full width (100 x 1000, M = 128, B = 2048, float32)
    with their epochs cut to SPARSE_VARIANT_EPOCHS: step time, spread,
    syncs, busy share, peak memory, the neg-ELBO trajectory and the recovery
    correlation(s) (informational); requires a finite history and a last
    epoch below the first. For order 2 also one ``erf_complex`` call on the
    step's 2048 x 128 arguments."""
    import torch

    epochs = SPARSE_VARIANT_EPOCHS[model]
    tag = f"sparse {model}"
    print(f"[{tag}] epochs cut from {SPARSE_EPOCHS} to {epochs} ({epochs * 49} steps)")
    argv = ["--preset", "sparse100k", "--no-x64", "--model", model, "--num-epochs", str(epochs),
            "--out-dir", tmp]
    out, peak_gib = _sparse_run(drive, tag, argv)
    _sparse_report(tag, out, peak_gib, smi)
    median, spread, syncs, busy = _svi_step_times(out, smi, tag)
    if model == "simm2":
        from dis_project_tpu_torch.ops.special import erf_complex

        # The step's erf arguments (t - z) / l - gamma: one batch's times
        # against the inducing grid at the init point's complex decay rate
        # gamma = (alpha - i omega) l / 2, alpha 0.4, omega 1, l 2.
        gen = torch.Generator().manual_seed(14)
        bidx = torch.randint(0, out.X.shape[0], (SPARSE_BS,), generator=gen).to(out.X.device)
        t = out.X[bidx, 0]
        z = torch.linspace(0.0, 12.0, SPARSE_M, dtype=torch.float32, device=out.X.device)
        args = ((t[:, None] - z[None, :]) / 2.0).to(torch.complex64) - complex(0.4, -1.0)
        erf_ms = cuda_ms(lambda: erf_complex(args), reps=10)
        print(f"[{tag}] erf_complex on {tuple(args.shape)} complex64 arguments: {erf_ms:.3f} ms "
              f"({smi})")
    return dict(median=median, spread=spread, syncs=syncs, busy=busy, peak_gib=peak_gib,
                fit_s=out.fit_s, data_s=out.data_s, corrs=out.corrs, epochs=epochs)


def sparse_bounds(smi):
    """``[sparse bounds]``: the library API in float64 on the card and on
    the CPU at 20 x 200 rows, M = 32: ``collapsed_elbo`` and the full-batch
    ``elbo`` at ``optimal_q``'s state within rel 1e-10 of the CPU, and
    ``optimal_q``'s (q_mu, q_sqrt) within N eps cond(B) of the CPU's (B = I +
    A Λ^{-1} Aᵀ, its 2-norm condition number on the CPU): the card and the
    CPU sum B's and A Λ^{-1} y's inner products of length N in different
    orders, a relative perturbation of at most N eps, which the solve for q
    amplifies by up to cond(B).
    The ELBO at the optimal q equals the collapsed bound but for the floor
    of the marginal variances at the jitter (rows at t = 0 have zero prior
    variance; the JAX package's test_optimal_q_elbo_matches_collapsed holds
    its 27-row problem at abs 2e-4): ELBO - collapsed + the floor's term
    0.5 Σ (max(v, jitter) - v) / noise within rel 1e-10 of the bound."""
    import torch

    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import svlfm

    G, T, M = 20, 200, 32
    data = port_main.synthetic_sparse_data(G, T, 1, 1, 0, torch.float64, "cpu")
    model = svlfm.SparseSIMM(num_genes=G, num_inducing=M, jitter=1e-6)
    vals = {}
    for device in ("cuda", "cpu"):
        X, y, var = (a.to(device) for a in train_arrays(data, "cpu", torch.float64))
        p = svlfm.init_params(G, M, dtype=torch.float64, device=device)
        p = p._replace(kinetics=p.kinetics._replace(
            obs_stddev=torch.tensor(0.1, dtype=torch.float64, device=device)))
        with torch.no_grad():
            opt = model.optimal_q(p, X, y, var)
            A = model._proj(opt, model._luu(opt), X)
            SA = opt.q_sqrt.T @ A
            v = model._prior_var(opt, X) - torch.sum(A * A, 0) + torch.sum(SA * SA, 0)
            noise = opt.kinetics.obs_stddev ** 2 + var
            floor = 0.5 * float(torch.sum((torch.clamp_min(v, model.jitter) - v) / noise))
            B = torch.eye(M, dtype=torch.float64, device=device) + (A / noise) @ A.T
            vals[device] = dict(collapsed=float(model.collapsed_elbo(p, X, y, var)),
                                elbo_opt=float(model.elbo(opt, X, y, var, n_total=X.shape[0])),
                                q_mu=opt.q_mu.cpu().numpy(), q_sqrt=opt.q_sqrt.cpu().numpy(),
                                floor=floor, cond=float(torch.linalg.cond(B.cpu())))
    c, h = vals["cuda"], vals["cpu"]
    rels = {k: abs(c[k] - h[k]) / abs(h[k]) for k in ("collapsed", "elbo_opt")}
    q_rels = {k: _host_rel(c[k], h[k]) for k in ("q_mu", "q_sqrt")}
    q_limit = G * T * 2.220446049250313e-16 * h["cond"]
    gap = c["elbo_opt"] - c["collapsed"]
    rest = abs(gap + c["floor"]) / abs(c["collapsed"])
    print(f"[sparse bounds] f64 N={G * T} M={M}: card vs cpu rel {json.dumps(rels)} (limit "
          f"1e-10); optimal q {json.dumps(q_rels)} (limit N eps cond(B) = {q_limit:.3e}, "
          f"cond(B) {h['cond']:.3e}); collapsed {c['collapsed']!r}, elbo at optimal q "
          f"{c['elbo_opt']!r}, gap {gap:.6e}, the variance floor's term {c['floor']:.6e}, "
          f"rest rel {rest:.3e} (limit 1e-10) ({smi})")
    require(max(rels.values()) <= 1e-10, f"sparse bounds card vs cpu: {rels}")
    require(max(q_rels.values()) <= q_limit, f"sparse bounds optimal q card vs cpu: {q_rels}")
    require(rest <= 1e-10, f"sparse bounds: elbo at optimal q vs collapsed, rest {rest}")


def sparse_phases(drive, smi):
    """The sparse100k route's phases; prints their total wall seconds."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sparse_")
    main_run = sparse_route(drive, smi, tmp)
    sparse_parity(smi)
    variants = {m: sparse_variant(drive, smi, tmp, m) for m in ("simm2", "multisimm")}
    sparse_bounds(smi)
    shutil.rmtree(tmp)
    print(f"[sparse] step median: simm {main_run['median']:.3f} ms (spread "
          f"{main_run['spread']:.3f}), simm2 {variants['simm2']['median']:.3f} ms (spread "
          f"{variants['simm2']['spread']:.3f}), multisimm (R=2) "
          f"{variants['multisimm']['median']:.3f} ms (spread "
          f"{variants['multisimm']['spread']:.3f}); fit 1225 steps {main_run['fit_s']:.3f} s, "
          f"data {main_run['data_s']:.3f} s ({smi})")
    print(f"[sparse phases] sparse, sparse parity, sparse simm2, sparse multisimm and sparse "
          f"bounds took {time.perf_counter() - t0:.1f} s")


# The nonlinear-response family's routes: the p53 MAP route at JAX's
# default of NLFM_STEPS Adam steps (cut to NLFM_STEPS_SLOW when a step of
# the first NLFM_PARITY_STEPS takes more than 15 ms), and the dense10k
# extended-Kalman route at NLFM_DENSE_STEPS steps (cut from 2000; to
# NLFM_DENSE_STEPS_SLOW when a step takes more than 5 s).
NLFM_STEPS, NLFM_STEPS_SLOW, NLFM_PARITY_STEPS = 2000, 500, 150
NLFM_DENSE_STEPS, NLFM_DENSE_STEPS_SLOW = 3, 2
NLFM_RESPONSES = ("identity", "exp", "softplus", "sigmoid")


def _in_dir(path, fn):
    """``fn()`` with ``path`` as the working directory (the nlfm route
    writes ``hyperparams.csv`` there)."""
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _rel(a, b):
    """max |a - b| / max(1, max |b|) over two tensors (any devices)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def nlfm_p53(drive, smi):
    """``[nlfm p53]``: ``main.run_nonlinear`` (``--model nlfm``: Q = 97, exp,
    the p21 pin, float64) for its first NLFM_PARITY_STEPS steps on the card
    and on the CPU in this process, each in its own temporary working
    directory: the first step within rel 1e-10, the final loss within rel
    1e-6; ``laplace_posteriors`` on the card against the CPU at the CPU's
    MAP point, rel 1e-8 (max abs / max(1, max|ref|)). Then the route as a
    user runs it (``main.main(["--model", "nlfm"])``, NLFM_STEPS steps, or
    NLFM_STEPS_SLOW when a warm step, timed over 20 steps of ``nlfm.fit``,
    takes more than 15 ms) once on the card: wall, ms a step, host syncs a
    step, Laplace ms. No kernel launches (the family has no hand-written
    kernel)."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data
    from dis_project_tpu_torch.models import nlfm
    from dis_project_tpu_torch.training import generic

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nlfm_")
    runs = {}
    for device in ("cuda", "cpu"):
        config = cfg.RunConfig(model="nlfm", num_iters=NLFM_PARITY_STEPS, device=device,
                               out_dir=os.path.join(tmp, device, "plots"),
                               metrics_path=os.path.join(tmp, f"{device}.jsonl"))
        runs[device] = drive(f"nlfm p53 {device}", lambda: _in_dir(
            os.path.join(tmp, device), lambda: port_main.run_nonlinear(config)), (),
            launch_free=True)
    card, host = runs["cuda"], runs["cpu"]
    hc, hh = card.result.history.tolist(), host.result.history.tolist()
    rel_final = abs(hc[-1] - hh[-1]) / abs(hh[-1])
    rel_first = abs(hc[0] - hh[0]) / abs(hh[0])
    step_ms = 1e3 * card.wall_s / NLFM_PARITY_STEPS
    print(f"[nlfm p53] Q=97 exp, {NLFM_PARITY_STEPS} steps f64: final negative log-joint card "
          f"{hc[-1]!r} cpu {hh[-1]!r} rel {rel_final:.3e} (limit 1e-6); first step rel "
          f"{rel_first:.3e} (limit 1e-10); wall card {card.wall_s:.3f} s ({step_ms:.2f} ms a "
          f"step, the process's first steps on the card included), cpu {host.wall_s:.3f} s; "
          f"Laplace card {1e3 * card.laplace_s:.1f} ms (its first call in the process), cpu "
          f"{1e3 * host.laplace_s:.1f} ms ({smi})")
    require(rel_final <= 1e-6, f"nlfm p53 final loss card vs cpu: {rel_final}")
    require(rel_first <= 1e-10, f"nlfm p53 first step card vs cpu: {rel_first}")

    # Laplace on the card against the CPU at the CPU's MAP point.
    dev = torch.device("cuda")
    data = P53Data(replicate=0, source="synthetic", seed=0)
    model = nlfm.NonlinearLFM(num_genes=5, response="exp", t_max=12.0, num_quad=97,
                              jitter=cfg.SPARSE_JITTER)
    arrays = (data.timepoints, data.gene_expressions, data.gene_variances)
    p_cpu = host.result.params
    p_card = generic.tree_unflatten(p_cpu, [a.to(dev) for a in generic.tree_leaves(p_cpu)])
    lap_h, band_h = model.laplace_posteriors(p_cpu, *(torch.as_tensor(a) for a in arrays))
    lap_c, band_c = model.laplace_posteriors(p_card, *(torch.as_tensor(a, device=dev)
                                                       for a in arrays))
    rels = {"force mean": _rel(lap_c.mean, lap_h.mean), "force cov": _rel(lap_c.cov, lap_h.cov),
            "bands mean": _rel(band_c.mean, band_h.mean),
            "bands cov": _rel(band_c.cov, band_h.cov)}
    print(f"[nlfm p53] laplace_posteriors card vs cpu at the cpu's MAP point, max abs / "
          f"max(1, max|cpu|): {json.dumps(rels)} (limit 1e-8)")
    require(max(rels.values()) <= 1e-8, f"nlfm p53 Laplace card vs cpu: {rels}")

    # The route as a user runs it, once, cut when a warm step (20 steps of
    # nlfm.fit after the runs above) passes 15 ms.
    t_obs, Y, V = (torch.as_tensor(a, device=dev) for a in arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nlfm.fit(model, nlfm.init_params(5, 97, torch.float64, dev), t_obs, Y, V, num_iters=20,
             fix_params=True)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0) / 20
    steps = NLFM_STEPS if warm_ms <= 15.0 else NLFM_STEPS_SLOW
    print(f"[nlfm p53] warm step {warm_ms:.2f} ms (20 steps of nlfm.fit; the route runs "
          f"{steps} steps{'' if steps == NLFM_STEPS else f', cut from {NLFM_STEPS}: over 15 ms'})"
          f" ({smi})")
    argv = ["--model", "nlfm", "--out-dir", os.path.join(tmp, "full", "plots")]
    if steps != NLFM_STEPS:
        argv += ["--num-iters", str(steps)]
    full = drive("nlfm p53 default route", lambda: _in_dir(
        os.path.join(tmp, "full"), lambda: port_main.main(argv)), (), launch_free=True)
    hist = full.result.history
    require(len(hist) == steps and bool(torch.isfinite(hist).all()),
            "nlfm p53 default route: history not finite or not the expected length")
    require(bool(torch.isfinite(full.latent.cov).all() and torch.isfinite(full.bands.cov).all()),
            "nlfm p53 default route: Laplace posteriors not finite")

    _, syncs = count_syncs(lambda: nlfm.fit(model, nlfm.init_params(5, 97, torch.float64, dev),
                                            t_obs, Y, V, num_iters=3, fix_params=True))
    print(f"[nlfm p53] default route {steps} steps on the card: wall {full.wall_s:.3f} s "
          f"({1e3 * full.wall_s / steps:.2f} ms a step), final negative log-joint "
          f"{float(hist[-1])!r}; host syncs a step {syncs / 3:.1f}; Laplace (one Q x Q Hessian, "
          f"both posteriors) {1e3 * full.laplace_s:.1f} ms ({smi})")
    shutil.rmtree(tmp)
    return dict(wall_s=full.wall_s, steps=steps, step_ms=1e3 * full.wall_s / steps,
                laplace_ms=1e3 * full.laplace_s, syncs=syncs / 3)


def nlfm_ekf_parity(smi):
    """``[nlfm ekf parity]``: ``nlfm_mll_ekf``, its raw gradient and
    ``nlfm_predict_ekf`` on the card against the CPU, float64, each
    response, at G = 3, T = 9 on ``generate_ode_nonlinear`` data: the value
    and gradient within rel 1e-10 (max abs / max(1, max|cpu|)); the
    smoothed moments within 1e-6: the RTS pseudo-solve's relative
    eigenvalue cutoff makes them move with the ``eigh`` (cuSOLVER's against
    LAPACK's, measured up to 1.8e-7 on exp; the CPU tests hold the port to
    the JAX package at 5e-9 with one LAPACK); with the identity
    response the marginal against ``lfm_mll_ss`` on the card within the
    JAX package's 5e-4 and 5e-6 at substeps 4 and 8."""
    import numpy as np
    import torch

    from dis_project_tpu_torch.data import synthetic
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f64 = torch.device("cuda"), torch.float64
    G, T = 3, 9
    scfg = synthetic.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1,
                                     noise_std=0.1)
    base = simm.init_params(G, dtype=f64)._replace(
        decay=torch.tensor([0.4, 0.9, 0.6], dtype=f64),
        sensitivity=torch.tensor([1.0, 0.8, 1.2], dtype=f64))
    tt = torch.linspace(0.0, 13.0, 11, dtype=f64)
    worst = {"mll": 0.0, "grad": 0.0, "predict": 0.0}
    names = ("f_mean", "f_var", "x_mean", "x_var")
    for resp in NLFM_RESPONSES:
        data = synthetic.generate_ode_nonlinear(torch.Generator().manual_seed(3), scfg,
                                                response=resp, oversample=4, device="cpu")
        t, y = data.timepoints, data.gene_expressions.reshape(-1)
        out = {}
        for device in ("cuda", "cpu"):
            raw = generic.tree_unflatten(simm.unconstrain(base), [
                a.to(device) for a in simm.unconstrain(base)])
            td, yd = t.to(device), y.to(device)
            v, g = generic.value_and_grad(lambda r: ss.nlfm_mll_ekf(
                simm.constrain(r), td, yd, response=resp, jitter=1e-4), raw)
            pred = ss.nlfm_predict_ekf(simm.constrain(raw), td, yd, tt.to(device),
                                       response=resp, noise_var=1e-2)
            out[device] = (v, g, pred)
        (vc, gc, pc), (vh, gh, ph) = out["cuda"], out["cpu"]
        pred = {n: _rel(a, b) for n, a, b in zip(names, pc, ph)}
        rel = {"mll": _rel(vc, vh), "grad": max(_rel(a, b) for a, b in zip(gc, gh)),
               "predict": max(pred.values())}
        worst = {k: max(worst[k], rel[k]) for k in worst}
        print(f"[nlfm ekf parity] {resp}: mll card {float(vc)!r} cpu {float(vh)!r}; card vs cpu "
              f"max abs / max(1, max|cpu|): mll {rel['mll']:.3e}, gradient {rel['grad']:.3e}, "
              f"predict {json.dumps(pred)}")
    require(worst["mll"] <= 1e-10 and worst["grad"] <= 1e-10,
            f"nlfm ekf parity: mll or gradient card vs cpu {worst}")
    require(worst["predict"] <= 1e-6, f"nlfm ekf parity: predict card vs cpu {worst}")
    ts = torch.linspace(0.0, 12.0, T, dtype=f64, device=dev)
    ys = torch.tensor(np.random.default_rng(5).normal(size=G * T), dtype=f64, device=dev) + 1.0
    pd = generic.tree_unflatten(base, [a.to(dev) for a in base])
    v_lin = float(ss.lfm_mll_ss(pd, ts, ys, jitter=1e-4, order=10, parallel=False))
    errs = [abs(v_lin - float(ss.nlfm_mll_ekf(pd, ts, ys, response="identity", jitter=1e-4,
                                              order=10, substeps=sub))) for sub in (4, 8)]
    print(f"[nlfm ekf parity] worst card vs cpu {json.dumps(worst)} (limits mll and gradient "
          f"1e-10, predict 1e-6); identity vs lfm_mll_ss on the card: substeps 4 {errs[0]:.3e} "
          f"(limit 5e-4), 8 {errs[1]:.3e} (limit 5e-6) ({smi})")
    require(errs[0] < 5e-4 and errs[1] < 5e-6 and errs[1] < errs[0],
            f"nlfm ekf identity vs lfm_mll_ss: {errs}")
    return worst


def dense_nlfm_ss(drive, smi):
    """``[dense nlfm ss]``: ``main.main(["--preset", "dense10k", "--model",
    "nlfm", "--mll-engine", "ss", "--no-x64"])`` at dense10k's full width
    (``generate_ode_nonlinear`` at 50 x 200, exp, m = 60, float32),
    NLFM_DENSE_STEPS plain Adam steps, cut from 2000 (NLFM_DENSE_STEPS_SLOW
    when a step, estimated as 4x a loss and gradient at T = 50, passes 5 s):
    the finite history; the first step's loss within rel 1e-4 of the float64
    loss at the same point on the card; step ms (median, spread), host us
    per filter step, host syncs per loss and gradient at T = 50 and 200
    (they must not grow with T), peak memory, the recovery correlations;
    device kernels per filter step and the device's busy share from
    ``torch.profiler`` over a loss and gradient at T = 10 (the same work a
    filter step: the profiler's cost grows with its ~1400 kernels a step).
    No kernel launches."""
    import torch

    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import generic

    dev, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    G, T = DENSE_GENES, DENSE_TIMEPOINTS

    def objective(raw, t, y):
        return -ss.nlfm_mll_ekf(simm.constrain(raw), t, y, response="exp",
                                jitter=cfg.EXACT_JITTER)

    data = port_main.synthetic_nlfm_data(G, T, 0, "exp", f32, dev)
    t32, y32 = data.timepoints, data.gene_expressions.reshape(-1)
    raw32 = simm.unconstrain(simm.init_params(G, dtype=f32, device=dev))

    def loss_and_grad(t_len):
        y_t = y32.reshape(G, T)[:, :t_len].reshape(-1)
        return lambda: generic.value_and_grad(lambda r: objective(r, t32[:t_len], y_t), raw32)

    syncs, wall = {}, {}
    for t_len in (50, T):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, syncs[t_len] = count_syncs(loss_and_grad(t_len))
        wall[t_len] = time.perf_counter() - t0
    steps = NLFM_DENSE_STEPS if 4 * wall[50] <= 5.0 else NLFM_DENSE_STEPS_SLOW
    print(f"[dense nlfm ss] cut: {steps} steps of the default 2000 (a step estimated at "
          f"{4e3 * wall[50]:.1f} ms from 4x a loss and gradient at T = 50; "
          f"{NLFM_DENSE_STEPS_SLOW} when it passes 5 s) ({smi})")

    held = {}

    def run():
        torch.cuda.reset_peak_memory_stats(dev)
        held["bytes"] = torch.cuda.memory_allocated(dev)
        return port_main.main(["--preset", "dense10k", "--model", "nlfm", "--mll-engine", "ss",
                               "--no-x64", "--synth-genes", str(G), "--synth-timepoints", str(T),
                               "--num-iters", str(steps)])

    dense = drive("dense nlfm ss", run, (), launch_free=True)
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["bytes"]) / 2**30
    hist = dense.result.history.tolist()
    require(all(math.isfinite(v) for v in hist), f"dense nlfm ss losses not finite: {hist}")
    require(torch.equal(dense.y, y32), "dense nlfm ss: the route's data differ from the phase's")
    step_ms = [1e3 * s for s in dense.step_seconds]
    later = step_ms[1:] or step_ms
    median = statistics.median(later)
    spread = (statistics.quantiles(later, n=4)[2] - statistics.quantiles(later, n=4)[0]
              if len(later) >= 2 else float("nan"))
    vg_us = [1e6 * st["value_and_grad_host_s"] / T for st in dense.ss_stats]
    fwd_us = [1e6 * st["forward_host_s"] / T for st in dense.ss_stats]
    p = dense.result.params
    corr_d = _corr(p.decay, dense.data.params_true["decay"])
    corr_s = _corr(p.sensitivity, dense.data.params_true["sensitivity"])

    # The first step's float32 loss against float64 at the same point.
    raw64 = simm.unconstrain(simm.init_params(G, dtype=f64, device=dev))
    loss64 = float(objective(raw64, t32.double(), y32.double()))
    rel64 = abs(hist[0] - loss64) / abs(loss64)
    print(f"[dense nlfm ss] N={G * T}, f32, {steps} steps: losses {hist}; first step vs f64 at "
          f"the same point {loss64!r}: rel {rel64:.3e} (limit 1e-4); recovery corr(decay) "
          f"{corr_d:.4f} corr(sensitivity) {corr_s:.4f} ({smi})")
    require(rel64 <= 1e-4, f"dense nlfm ss first step f32 vs f64: {rel64}")

    t_prof = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_and_grad(t_prof)()
    torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    kernels, busy = device_kernels_and_busy_ms(loss_and_grad(t_prof))
    share = ("not measured (no device time in the trace)" if busy is None else
             f"{busy:.3f} ms busy of {1e3 * wall_prof:.3f} ms wall, share "
             f"{busy / (1e3 * wall_prof):.3f}; {kernels} device kernels, "
             f"{kernels / t_prof:.0f} per filter step")
    print(f"[dense nlfm ss] step ms {[round(s, 3) for s in step_ms]} median (steps 2+) "
          f"{median:.3f}, spread (interquartile) {spread:.3f}; host us per filter step, loss "
          f"{[round(u, 1) for u in fwd_us]}, loss and gradient {[round(u, 1) for u in vg_us]}; "
          f"host syncs per loss and gradient T=50 {syncs[50]}, T={T} {syncs[T]}; peak memory "
          f"{peak_gib:.3f} GiB; one loss and gradient at T = {t_prof}: {share} ({smi})")
    require(syncs[T] <= syncs[50], f"dense nlfm ss: host syncs grow with T: {syncs}")
    return dict(median=median, spread=spread, steps=steps, peak_gib=peak_gib, busy=busy,
                kernels=kernels, syncs=syncs[T])


def nlfm_phases(drive, smi):
    """The nonlinear-response family's phases; prints their total wall
    seconds."""
    t0 = time.perf_counter()
    p53 = nlfm_p53(drive, smi)
    nlfm_ekf_parity(smi)
    dense = dense_nlfm_ss(drive, smi)
    print(f"[nlfm] p53 default route {p53['steps']} steps {p53['wall_s']:.3f} s "
          f"({p53['step_ms']:.2f} ms a step, Laplace {p53['laplace_ms']:.1f} ms); dense10k EKF "
          f"step median {dense['median']:.3f} ms (spread {dense['spread']:.3f}, "
          f"{dense['peak_gib']:.3f} GiB, {dense['steps']} steps) ({smi})")
    print(f"[nlfm phases] nlfm p53, nlfm ekf parity and dense nlfm ss took "
          f"{time.perf_counter() - t0:.1f} s ({smi})")


# The HMC phases' sizes: the p53 route's --posterior-samples, the fed-draw
# parity runs (card against CPU; 8 takes both warmup windows), the lockstep
# chains, and the dense routes' draws.
HMC_ROUTE_DRAWS, HMC_PARITY_DRAWS, HMC_FAMILY_DRAWS = 20, 8, 4
HMC_CHAINS, HMC_CHAIN_DRAWS = 4, 10
HMC_DENSE_DRAWS, HMC_DENSE_DELAY_DRAWS = 2, 1


def _hmc_rel(card, host):
    """max abs / max(1, max|cpu|) of each HMC output, card against CPU."""
    from dis_project_tpu_torch.training import generic

    rels = {name: _rel(getattr(card, name), getattr(host, name))
            for name in ("accept_rate", "step_size", "log_probs")}
    rels["samples"] = max(_rel(a, b) for a, b in zip(generic.tree_leaves(card.samples),
                                                      generic.tree_leaves(host.samples)))
    return rels


def _hmc_fed_draws(n, dim):
    """One table of draws for n warmup and n sampling trajectories of one
    chain, made on the CPU from a seed: ``(cpu draws, card draws)``."""
    import torch

    from dis_project_tpu_torch.training import hmc

    gen = torch.Generator().manual_seed(11)
    host = tuple(hmc.draw_tables(gen, n, 1, dim, torch.float64, "cpu") for _ in range(2))
    card = tuple(hmc.HMCDraws(*(a.to("cuda") for a in d)) for d in host)
    return host, card


def _to_device(tree, dev):
    from dis_project_tpu_torch.training import generic

    return generic.tree_unflatten(tree, [a.to(dev) for a in generic.tree_leaves(tree)])


def _launched(before):
    """The kernel launches since the snapshot ``before``."""
    from dis_project_tpu_torch.ops import cuda_gram

    now = {**cuda_gram.LAUNCHES, **cuda_gram.PLAIN_X_GRADS}
    return {k: now[k] - before.get(k, 0) for k in now}


def _snapshot():
    from dis_project_tpu_torch.ops import cuda_gram

    return {**cuda_gram.LAUNCHES, **cuda_gram.PLAIN_X_GRADS}


def busy_line(kernels, busy_ms, wall_ms):
    """The device's kernels and busy share over a call, or "not measured"."""
    if busy_ms is None:
        return "device busy share not measured (no device time in the trace)"
    return (f"{kernels} device kernels, busy {busy_ms:.3f} ms, share "
            f"{busy_ms / wall_ms:.3f}")


def _timed(fn):
    """``(fn(), seconds)`` on the host clock, the card synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hmc_p53(drive, smi):
    """``[hmc p53]``: the canonical route's posterior (``main.kinetics_posterior``
    after ``main.fit_and_predict``, 150 f64 steps, ``--posterior-samples``
    HMC_ROUTE_DRAWS): one K2 and one K2 bwd per gradient evaluation, C x (1 +
    24 x 2n) each, and the BMA band's K1 and two K2 per component. Then at
    the trained point: ``kinetics_posterior`` on the card against the CPU on
    one table of draws made on the CPU (HMC_PARITY_DRAWS warmup and draws):
    samples, step size, accept rate and log-probs within rel 1e-8 (so every
    accept decision is the same); host syncs and peak memory of the sampler
    at n = 4 and 8 beside the density's syncs per value and gradient (the
    sampler's own share, the total less evaluations x the density's, must not
    grow with n; the peaks within 1 MiB); ms per gradient, per trajectory and
    per draw from CUDA events; HMC_CHAINS chains in lockstep (R-hat, ESS, ms
    per lockstep draw); a proposal forced into the non-PD region (step size
    1e3): accept rate 0, no exception, no sync beyond the sampler's share."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import bijectors as bij
    from dis_project_tpu_torch.training import hmc

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hmc_")
    n = HMC_ROUTE_DRAWS
    config = cfg.RunConfig(preset="p53", device="cuda", posterior_samples=n,
                           out_dir=os.path.join(tmp, "plots"))
    canon = port_main.fit_and_predict(config)
    route_s = drive("hmc p53 route", lambda: _timed(
        lambda: port_main.kinetics_posterior(config, canon))[1],
        ("gram_sym", "gram_sym_bwd", "gram_rect"))
    got = _launched({})
    evals = 1 + 24 * 2 * n
    comps = min(64, n)
    want = {"gram_sym": evals + 2 * comps, "gram_sym_bwd": evals, "gram_rect": comps}
    print(f"[hmc p53] route (--posterior-samples {n}, 1 chain, f64, N=35): {route_s:.3f} s "
          f"({1e3 * route_s / n:.1f} ms a draw with its warmup trajectory, BMA included); "
          f"accept rate {float(canon.posterior.accept_rate):.3f}, step size "
          f"{float(canon.posterior.step_size):.4f}; launches {got} (want K2 {want['gram_sym']} = "
          f"1 + 24 x 2n + 2 x {comps} BMA components, K2 bwd {evals}, K1 {comps}) ({smi})")
    require(all(got[k] == v for k, v in want.items()), f"hmc p53 route launches {got}, not {want}")
    require(bool(torch.isfinite(canon.posterior.log_probs).all()), "hmc p53: log-probs not finite")
    model, X, y, var, t_grid = canon.model, canon.X, canon.y, canon.var, canon.t_grid
    params = canon.result.params

    # The BMA band alone: its ms and launches.
    before = _snapshot()
    (bma, comp), bma_s = _timed(lambda: hmc.mixture_predict(
        lambda p: model.latent_predict(p, t_grid, X, y, var), canon.posterior.samples))
    bma_launched = _launched(before)
    print(f"[hmc p53] BMA band ({comp.shape[0]} of {comps} components kept): {1e3 * bma_s:.1f} ms, "
          f"launches {bma_launched} ({smi})")
    require(bma_launched["gram_rect"] == comps and bma_launched["gram_sym"] == 2 * comps,
            f"hmc p53 BMA launches {bma_launched}")

    # Card against the CPU on one table of draws.
    np_ = HMC_PARITY_DRAWS
    draws_h, draws_c = _hmc_fed_draws(np_, 17)
    p_cpu = _to_device(params, "cpu")
    host = hmc.kinetics_posterior(model, p_cpu, X.cpu(), y.cpu(), None, num_warmup=np_,
                                  num_samples=np_, draws=draws_h)
    before = _snapshot()
    card, card_s = _timed(lambda: hmc.kinetics_posterior(model, params, X, y, None,
                                                         num_warmup=np_, num_samples=np_,
                                                         draws=draws_c))
    fed = _launched(before)
    rels = _hmc_rel(card, host)
    ev = 1 + 24 * 2 * np_
    print(f"[hmc p53] fed draws ({np_} warmup, {np_} draws), card vs cpu, max abs / max(1, "
          f"max|cpu|): {json.dumps(rels)} (limit 1e-8); accept rate card "
          f"{float(card.accept_rate)!r} cpu {float(host.accept_rate)!r}; K2 {fed['gram_sym']}, "
          f"K2 bwd {fed['gram_sym_bwd']} (want {ev} = 1 + 24 x 2n each) ({smi})")
    require(max(rels.values()) <= 1e-8, f"hmc p53 card vs cpu: {rels}")
    require(fed["gram_sym"] == ev and fed["gram_sym_bwd"] == ev, f"hmc p53 fed launches {fed}")

    # Syncs and peak memory of the sampler at n = 4 and 8, the density's
    # syncs per value and gradient beside them.
    raw = simm.unconstrain(params)

    def logdensity(r):
        return model.mll(simm.constrain(r), X, y) + bij.constrain_log_det(r, simm.SIMM_BIJECTORS)

    flat, unravel = hmc.ravel(raw)
    vg = hmc._value_and_grad(logdensity, unravel)
    _, vg_syncs = count_syncs(lambda: vg(flat[None]))
    own, peak, per = {}, {}, {}
    for k in (4, 8):
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _, per[k], own[k], _ = count_sampler_syncs(lambda: hmc.kinetics_posterior(
            model, params, X, y, gen, num_warmup=k, num_samples=k))
        peak[k] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        require(len(per[k]) == 1 + 48 * k, f"hmc p53: {len(per[k])} evaluations at n={k}")
    grad_ms = cuda_ms(lambda: vg(flat[None]), reps=20)
    grad_kernels, grad_busy = device_kernels_and_busy_ms(lambda: vg(flat[None]))
    run_ms = cuda_ms(lambda: hmc.kinetics_posterior(
        model, params, X, y, torch.Generator(device=dev).manual_seed(7), num_warmup=8,
        num_samples=8), reps=3, warmup=0)
    print(f"[hmc p53] host syncs: the density's per value and gradient {vg_syncs} alone, "
          f"{sorted(set(per[4] + per[8]))} inside the sampler's {len(per[4])} / {len(per[8])} "
          f"evaluations; the sampler's own n=4 {own[4]} n=8 {own[8]}; peak memory n=4 "
          f"{peak[4]:.3f} MiB n=8 {peak[8]:.3f} MiB (limit: equal within 1 MiB); ms per gradient "
          f"{grad_ms:.3f} ({busy_line(grad_kernels, grad_busy, grad_ms)}), per trajectory (24 "
          f"gradients) {run_ms / 16:.3f}, per draw with its warmup trajectory {run_ms / 8:.3f} "
          f"(n=8 run {run_ms:.1f} ms) ({smi})")
    require(own[8] <= own[4], f"hmc p53: the sampler's syncs grow with draws: {own}")
    require(abs(peak[8] - peak[4]) <= 1.0, f"hmc p53: peak memory grows with draws: {peak}")

    # Chains in lockstep.
    C, nc = HMC_CHAINS, HMC_CHAIN_DRAWS
    chains_s = {}

    def chains():
        gen = torch.Generator(device=dev).manual_seed(8)
        res, chains_s["s"] = _timed(lambda: hmc.kinetics_posterior(
            model, params, X, y, gen, num_warmup=nc, num_samples=nc, num_chains=C))
        return res

    res = drive("hmc p53 chains", chains, ("gram_sym", "gram_sym_bwd"))
    got = _launched({})
    rhat, ess = hmc.pytree_diagnostics(res.samples)
    want_c = C * (1 + 24 * 2 * nc)
    print(f"[hmc p53] {C} chains in lockstep, {nc} warmup + {nc} draws each: "
          f"{chains_s['s']:.3f} s ({1e3 * chains_s['s'] / nc:.1f} ms a lockstep draw with its "
          f"warmup); accept rates {[round(a, 3) for a in res.accept_rate.tolist()]}; max "
          f"split-R-hat {rhat:.4f}, min ESS {ess:.1f} of {C * nc}; K2 {got['gram_sym']} K2 bwd "
          f"{got['gram_sym_bwd']} (want {want_c} = C x (1 + 24 x 2n)) ({smi})")
    require(got["gram_sym"] == want_c and got["gram_sym_bwd"] == want_c,
            f"hmc p53 chains launches {got}")

    # A proposal forced into the non-PD region.
    gen = torch.Generator(device=dev).manual_seed(9)
    bad, bad_per, bad_own, _ = count_sampler_syncs(lambda: hmc.sample(
        logdensity, raw, gen, num_warmup=0, num_samples=2, initial_step_size=1e3))
    print(f"[hmc p53] step size 1e3 (proposals in the non-PD region): accept rate "
          f"{float(bad.accept_rate)!r}, log-probs {bad.log_probs.tolist()}; host syncs inside "
          f"the {len(bad_per)} evaluations {sum(bad_per)}, the sampler's own {bad_own} (limit "
          f"{own[4]}) ({smi})")
    require(float(bad.accept_rate) == 0.0, "hmc p53: a non-PD proposal was accepted")
    require(bool(torch.isfinite(bad.log_probs).all()), "hmc p53: the chain left its finite state")
    require(bad_own <= own[4], f"hmc p53: the non-PD run synced {bad_own} times")
    shutil.rmtree(tmp)
    return dict(draw_ms=run_ms / 8, grad_ms=grad_ms, route_s=route_s, rhat=rhat, ess=ess)


def hmc_family_p53(drive, smi, model_name):
    """``[hmc nlfm p53]`` / ``[hmc delay p53]``: the route through its entry
    point (``main.run_nonlinear``: Q = 97, exp, 200 MAP steps; ``main.run_delay``:
    150 steps; float64, ``--posterior-samples`` HMC_FAMILY_DRAWS) on the card,
    then the posterior at the trained point on the card against the CPU on one
    table of draws made on the CPU (HMC_FAMILY_DRAWS warmup and draws):
    samples, step size, accept rate and log-probs within rel 1e-8; ms per
    draw. nlfm launches no kernel; the delay route's every gradient launches
    one K2, one K2 bwd and one plain VJP of the rows (the delays')."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import delaysimm, nlfm

    tag = f"hmc {'nlfm' if model_name == 'nlfm' else 'delay'} p53"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hmc_")
    n = HMC_FAMILY_DRAWS
    evals = 1 + 24 * 2 * n
    config = cfg.RunConfig(model=model_name, device="cuda", posterior_samples=n,
                           num_iters=200 if model_name == "nlfm" else 150,
                           out_dir=os.path.join(tmp, "plots"))
    data = P53Data(replicate=0, source="synthetic", seed=0)
    if model_name == "nlfm":
        route = port_main.run_nonlinear
        must, kw = (), dict(launch_free=True)
        model = nlfm.NonlinearLFM(num_genes=5, response="exp", t_max=12.0, num_quad=97,
                                  jitter=cfg.SPARSE_JITTER)
        arrays = {dev: tuple(torch.as_tensor(a, device=dev) for a in (
            data.timepoints, data.gene_expressions, data.gene_variances))
            for dev in ("cuda", "cpu")}

        def posterior(p, dev, draws):
            return nlfm.force_posterior_hmc(model, p, *arrays[dev], None, num_warmup=n,
                                            num_samples=n, draws=draws)
        dim = 17 + 97
    else:
        route = port_main.run_delay
        must = ("gram_sym", "gram_sym_bwd", "gram_rect")
        kw = dict(x_grads=lambda out: len(out.result.history) + out.result.guard_count + evals)
        model = delaysimm.ExactDelaySIMM(num_genes=5, jitter=cfg.EXACT_JITTER)
        arrays = {dev: train_arrays(data, dev, torch.float64)[:2] for dev in ("cuda", "cpu")}

        def posterior(p, dev, draws):
            return delaysimm.kinetics_posterior(model, p, *arrays[dev], None, num_warmup=n,
                                                num_samples=n, draws=draws)
        dim = 22
    out = drive(f"{tag} route", lambda: _in_dir(tmp, lambda: route(config)), must, **kw)
    post = out.posterior
    print(f"[{tag}] route (--posterior-samples {n}, f64): accept rate "
          f"{float(post.accept_rate):.3f}, step size {float(post.step_size):.4f}, band "
          f"{'kept' if out.bma is not None else 'skipped'} ({smi})")
    require(bool(torch.isfinite(post.log_probs).all()), f"{tag}: log-probs not finite")

    draws_h, draws_c = _hmc_fed_draws(n, dim)
    params = out.result.params
    host = posterior(_to_device(params, "cpu"), "cpu", draws_h)
    before = _snapshot()
    card, card_s = _timed(lambda: posterior(params, "cuda", draws_c))
    fed = _launched(before)
    rels = _hmc_rel(card, host)
    per_grad = {k: v / evals for k, v in fed.items()}
    print(f"[{tag}] fed draws ({n} warmup, {n} draws), card vs cpu, max abs / max(1, "
          f"max|cpu|): {json.dumps(rels)} (limit 1e-8); {1e3 * card_s / n:.1f} ms a draw with "
          f"its warmup trajectory ({1e3 * card_s / evals:.2f} ms a gradient); launches per "
          f"gradient {json.dumps(per_grad)} ({smi})")
    require(max(rels.values()) <= 1e-8, f"{tag} card vs cpu: {rels}")
    if model_name == "nlfm":
        require(not any(fed.values()), f"{tag}: a kernel was launched: {fed}")
    else:
        require(fed["gram_sym"] == fed["gram_sym_bwd"] == fed["gram_sym_x"] == evals
                and fed["gram_rect"] == 0, f"{tag}: launches {fed}, want {evals} each")
    shutil.rmtree(tmp)
    return dict(draw_ms=1e3 * card_s / n)


def hmc_dense(drive, smi, model_name):
    """``[hmc dense ss]`` / ``[hmc dense delay ss]`` at dense10k's full width
    (50 x 200, float32, order 10, 10 leapfrog steps as in the JAX package).
    simm: ``main.run_dense`` (--mll-engine ss, 3 steps) and
    ``main.dense_ss_posterior`` (--posterior-samples HMC_DENSE_DRAWS, the BMA
    band of the smoothed force) as the route; delaysimm: the route's sampler
    ``hmc.delay_posterior_ss`` at the generator's data and the initial point
    (HMC_DENSE_DELAY_DRAWS; its step is ~1 s). Then the sampler alone in
    ``count_syncs``: ms per draw and per gradient, peak memory, and its host
    syncs, which must equal the evaluations (1 + 10 x 2n) x the likelihood's
    own syncs per loss and gradient (the sampler adds none). No kernel
    launches."""
    import torch

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import train_arrays
    from dis_project_tpu_torch.models import delaysimm, simm
    from dis_project_tpu_torch.ops import bijectors as bij
    from dis_project_tpu_torch.ops import statespace as ss
    from dis_project_tpu_torch.training import hmc

    dev, f32 = torch.device("cuda"), torch.float32
    G, T = DENSE_GENES, DENSE_TIMEPOINTS
    jitter = cfg.EXACT_JITTER
    if model_name == "simm":
        tag, n = "hmc dense ss", HMC_DENSE_DRAWS
        tmp = tempfile.mkdtemp(prefix="chip_smoke_hmc_")
        config = cfg.RunConfig(preset="dense10k", mll_engine="ss", x64=False, device="cuda",
                               num_iters=3, posterior_samples=n, synth_genes=G,
                               synth_timepoints=T, out_dir=tmp)
        route_s = {}

        def route():
            out = port_main.run_dense(config)
            _, route_s["s"] = _timed(lambda: port_main.dense_ss_posterior(config, out))
            return out

        out = drive(f"{tag} route", route, (), launch_free=True)
        shutil.rmtree(tmp)
        print(f"[{tag}] route (--posterior-samples {n}, N={G * T}, f32): posterior and BMA band "
              f"{route_s['s']:.3f} s; accept rate {float(out.posterior.accept_rate):.3f}, "
              f"step size {float(out.posterior.step_size):.4f}, band "
              f"{'kept' if out.bma is not None else 'skipped'} ({smi})")
        params, y = out.result.params, out.y
        t = torch.as_tensor(out.data.timepoints, dtype=f32, device=dev)

        def logdensity(r):
            return ss.lfm_mll_ss(simm.constrain(r), t, y, jitter=jitter) + bij.constrain_log_det(
                r, simm.SIMM_BIJECTORS)

        def sampler(gen):
            return hmc.kinetics_posterior_ss(params, t, y, gen, jitter=jitter, num_warmup=n,
                                             num_samples=n)
        raw = simm.unconstrain(params)
    else:
        tag, n = "hmc dense delay ss", HMC_DENSE_DELAY_DRAWS
        data = port_main.synthetic_delay_data(G, T, 0, f32, dev)
        _, y, _ = train_arrays(data, dev, f32)
        t = torch.as_tensor(data.timepoints, dtype=f32, device=dev)
        params = delaysimm.init_params(G, f32, dev)

        def logdensity(r):
            return ss.delaysimm_mll_ss(delaysimm.constrain(r), t, y, jitter=jitter) + \
                bij.constrain_log_det(r, delaysimm.DELAY_BIJECTORS)

        def sampler(gen):
            return hmc.delay_posterior_ss(params, t, y, gen, jitter=jitter, num_warmup=n,
                                          num_samples=n)
        raw = delaysimm.unconstrain(params)
    flat, unravel = hmc.ravel(raw)
    vg = hmc._value_and_grad(logdensity, unravel)
    (_, first_syncs), _ = _timed(lambda: count_syncs(lambda: vg(flat[None])))
    (_, vg_syncs), vg_s = _timed(lambda: count_syncs(lambda: vg(flat[None])))
    evals = 1 + 10 * 2 * n
    held = {}

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held["base"] = torch.cuda.memory_allocated(dev)
        (res, held["per"], held["own"], held["where"]), held["s"] = _timed(
            lambda: count_sampler_syncs(lambda: sampler(torch.Generator(device=dev).manual_seed(7))))
        return res

    res = drive(f"{tag} sampler", run, (), launch_free=True)
    peak_gib = (torch.cuda.max_memory_allocated(dev) - held["base"]) / 2**30
    wall, per = held["s"], held["per"]
    print(f"[{tag}] sampler ({n} warmup + {n} draws, {evals} gradient evaluations, N={G * T}, "
          f"f32): {wall:.3f} s, {1e3 * wall / n:.1f} ms a draw with its warmup trajectory, "
          f"{1e3 * wall / evals:.1f} ms a gradient (one loss and gradient alone "
          f"{1e3 * vg_s:.1f} ms); accept rate {float(res.accept_rate):.3f}; peak memory "
          f"{peak_gib:.3f} GiB; host syncs inside the {len(per)} evaluations {sum(per)} (each "
          f"{sorted(set(per))}; one loss and gradient alone {vg_syncs}, the process's first "
          f"{first_syncs}), {sum(per) / n:.1f} a draw, the sampler's own {held['own']} (limit 0); "
          f"by line {json.dumps(held['where'])} ({smi})")
    require(len(per) == evals, f"{tag}: {len(per)} evaluations, not {evals}")
    require(held["own"] == 0, f"{tag}: the sampler synced {held['own']} times")
    require(bool(torch.isfinite(res.log_probs).all()), f"{tag}: log-probs not finite")
    return dict(draw_ms=1e3 * wall / n, peak_gib=peak_gib)


def hmc_phases(drive, smi):
    """The HMC phases (``training.hmc`` on every --posterior-samples route);
    prints their total wall seconds."""
    t0 = time.perf_counter()
    p53 = hmc_p53(drive, smi)
    fam = {m: hmc_family_p53(drive, smi, m) for m in ("nlfm", "delaysimm")}
    dense = {m: hmc_dense(drive, smi, m) for m in ("simm", "delaysimm")}
    print(f"[hmc] ms a draw with its warmup trajectory: p53 {p53['draw_ms']:.1f} (a gradient "
          f"{p53['grad_ms']:.3f}), nlfm p53 {fam['nlfm']['draw_ms']:.1f}, delay p53 "
          f"{fam['delaysimm']['draw_ms']:.1f}, dense ss {dense['simm']['draw_ms']:.1f} "
          f"({dense['simm']['peak_gib']:.3f} GiB), dense delay ss "
          f"{dense['delaysimm']['draw_ms']:.1f} ({dense['delaysimm']['peak_gib']:.3f} GiB) ({smi})")
    print(f"[hmc phases] hmc p53, hmc nlfm p53, hmc delay p53, hmc dense ss and hmc dense delay "
          f"ss took {time.perf_counter() - t0:.1f} s ({smi})")


def main():
    import torch

    started = time.perf_counter()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import cuda_build, cuda_gram
    from dis_project_tpu_torch.ops import cuda_cholesky as cc
    from dis_project_tpu_torch.ops import cuda_cholesky_fused as cf
    from dis_project_tpu_torch.ops import gram as gram_ops
    from dis_project_tpu_torch.ops import mll as mll_ops
    from dis_project_tpu_torch.ops.precision import default_device
    from dis_project_tpu_torch.training import generic
    from dis_project_tpu_torch.training import trainer as tr
    from dis_project_tpu_torch.utils.test_grids import expression_grid, latent_grid

    dev = default_device()
    f32, f64 = torch.float32, torch.float64

    # -- phase 1: build ----------------------------------------------------
    build_s = cuda_build.build(["simm_gram", "syrk", "chol_block", "chol_fused"])
    smi = nvidia_smi_line()
    print(f"[build] kernels built in {build_s:.1f}s")
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    # Registers a thread, local memory a thread (spills) and static shared
    # memory a CTA of every kernel (cudaFuncGetAttributes).
    for name, signatures in (("simm_gram", cuda_gram.SIGNATURES), ("syrk", cc.SYRK_SIGNATURES),
                             ("chol_block", cc.CHOL_SIGNATURES),
                             ("chol_fused", cf.FUSED_SIGNATURES)):
        for kernel, regs, local, shared in cuda_build.kernel_attributes(name, signatures):
            print(f"[kernels] attrs {kernel}: numRegs {regs}, localSizeBytes {local}, "
                  f"sharedSizeBytes {shared}")

    # -- phase 2: kernels against their plain versions -----------------------
    gen = torch.Generator().manual_seed(1234)

    # The 50-gene checks draw from their own generator: the shared one's
    # sequence stays as it was before they were added, so that the 'ff'
    # float32 check of K2's backward at N = 1037 gets the draw on which an
    # earlier form of the kernel failed (PERF.md, Findings).
    gen50 = torch.Generator().manual_seed(50)

    def kinetics(G, dtype, rng=gen):
        decay = (0.2 + 0.8 * torch.rand(G, generator=rng, dtype=f64)).to(dtype).to(dev)
        sens = (0.5 + torch.rand(G, generator=rng, dtype=f64)).to(dtype).to(dev)
        return decay, sens, torch.tensor(2.5, dtype=dtype, device=dev)

    def dense_rows(G, T, dtype):
        t = torch.linspace(0.0, 12.0, T, dtype=dtype, device=dev).repeat(G)
        g = torch.arange(G, dtype=dtype, device=dev).repeat_interleave(T)
        return torch.stack([t, g, torch.ones_like(t)], dim=-1)

    def mixed_rows(n, G, dtype, rng=gen):
        t = 12.0 * torch.rand(n, generator=rng, dtype=f64)
        f = (torch.rand(n, generator=rng) < 0.5).to(f64)
        g = torch.randint(0, G, (n,), generator=rng).to(f64)
        g = torch.where(f == 0, -torch.ones_like(g), g)  # force rows carry -1
        return torch.stack([t, g, f], dim=-1).to(dtype).to(dev)

    def kind_rows(n, G, dtype, kind, rng=gen):
        """mixed_rows, or all expression rows ('xx') or all force rows
        ('ff') with random genes."""
        xm = mixed_rows(n, G, dtype, rng)
        if kind != "mixed":
            xm[:, 2] = float(kind == "xx")
            xm[:, 1] = torch.randint(0, G, (n,), generator=rng).to(dtype).to(dev)
        return xm

    def input_bytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    records = {}

    def check_k1(label, x1, x2, d, s, l, kind, atol):
        """K1 against both of its plain versions: the closed form
        (``cross_covariance_kind``) and the hoisted arithmetic it
        implements (``cross_covariance_hoisted``)."""
        ker = cuda_gram.gram_rect_kernel(x1, x2, d, s, l, kind)
        ref = gram_ops.cross_covariance_kind(x1, x2, d, s, l, kind)
        hoisted = cuda_gram.cross_covariance_hoisted(x1, x2, d, s, l, kind)
        torch.cuda.synchronize()
        err = float((ker - ref).abs().max())
        err_h = float((ker - hoisted).abs().max())
        print(f"[K1] gram_rect {label} {x1.shape[0]}x{x2.shape[0]} {kind} {x1.dtype}: max abs err "
              f"vs closed form {err:.3e}, vs hoisted {err_h:.3e} (atol {atol:g}), max rel err "
              f"{err / max(float(ref.abs().max()), 1e-300):.3e}")
        require(math.isfinite(err) and err <= atol, f"K1 {label} {kind} disagrees: {err}")
        require(math.isfinite(err_h) and err_h <= atol, f"K1 {label} {kind} vs hoisted: {err_h}")
        return err

    def time_k1(x1, x2, d, s, l, kind):
        """One K1 record: one call and back to back, the plain closed form,
        the bound of the hoisted form's operations and bytes."""
        n, m = x1.shape[0], x2.shape[0]
        call = lambda: cuda_gram.gram_rect_kernel(x1, x2, d, s, l, kind)  # noqa: E731
        err = check_k1("timed", x1, x2, d, s, l, kind, 5e-5)
        b, by = bound_ms(input_bytes(x1, x2, d, s, l) + n * m * x1.element_size(),
                         n * m * K1_OPS_PER_ENTRY[kind] + (n + m) * OPS_PER_ROW)
        rec = dict(max_abs_err=err, ms=cuda_ms(call), back_to_back_ms=back_to_back_ms(call),
                   plain_ms=cuda_ms(lambda: gram_ops.cross_covariance_kind(x1, x2, d, s, l, kind)),
                   bound_ms=b, bound_by=by, library_ms=None, shape=f"{n}x{m} {kind} f32")
        print(f"[K1] {rec['shape']}: ms {rec['ms']:.4f} back_to_back_ms "
              f"{rec['back_to_back_ms']:.4f} plain_ms {rec['plain_ms']:.4f} bound_ms {b:.5f} ({by})")
        return rec

    def check_k2(x, d, s, l, kind, atol, timed):
        ker = cuda_gram.gram_sym_kernel(x, d, s, l, kind)
        ref = cuda_gram.gram_sym_plain(x, d, s, l, kind)
        torch.cuda.synchronize()
        err = float((ker - ref).abs().max())
        symmetric = bool(torch.equal(ker, ker.T))
        print(f"[K2] gram_sym {x.shape[0]} {kind} {x.dtype}: max abs err {err:.3e} "
              f"(atol {atol:g}), max rel err {err / float(ref.abs().max()):.3e}, "
              f"exactly symmetric: {symmetric}")
        require(math.isfinite(err) and err <= atol, f"K2 {kind} disagrees: {err}")
        require(symmetric, "K2 output is not exactly symmetric")
        if timed:
            n = x.shape[0]
            b, by = bound_ms(input_bytes(x, d, s, l) + ker.numel() * ker.element_size(),
                             n * (n + 1) // 2 * OPS_PER_ENTRY[kind] + n * OPS_PER_ROW)
            records["K2"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: cuda_gram.gram_sym_kernel(x, d, s, l, kind)),
                back_to_back_ms=back_to_back_ms(
                    lambda: cuda_gram.gram_sym_kernel(x, d, s, l, kind)),
                plain_ms=cuda_ms(lambda: cuda_gram.gram_sym_plain(x, d, s, l, kind)),
                bound_ms=b, bound_by=by, library_ms=None,
                shape=f"{n}x{n} {kind} f32",
            )

    # On the card both sides evaluate the same closed form with CUDA's own
    # erf/exp, differing only in operation order and FMA contraction: f32
    # within 5e-5 absolute on entries up to ~10 (the bound the JAX package
    # holds its kernels to against XLA), f64 within 1e-10.
    G, T = DENSE_GENES, DENSE_TIMEPOINTS
    Xd = dense_rows(G, T, f32)
    d32, s32, l32 = kinetics(G, f32)
    grid = latent_grid(200, dtype=f32, device=dev)
    egrid = expression_grid(G, 100, dtype=f32, device=dev)
    # K1 at the main path's two shapes: the dense latent posterior's
    # 1e4 x 200 'xf' and the dense expression posterior's 1e4 x 5000 'xx'.
    k1_records = {rec["shape"]: rec for rec in (time_k1(Xd, grid, d32, s32, l32, "xf"),
                                                time_k1(Xd, egrid, d32, s32, l32, "xx"))}
    records["K1"] = {**k1_records[f"{Xd.shape[0]}x{egrid.shape[0]} xx f32"],
                     "shapes": k1_records}
    for dtype, atol in ((f32, 5e-5), (f64, 1e-10)):
        d5, s5, l5 = kinetics(5, dtype)
        check_k2(mixed_rows(1000, 5, dtype), d5, s5, l5, "mixed", atol, timed=False)
        # Ragged N: the 64-row tiles' masked edges and the scalar stores of a
        # row length that is not a whole number of 16-byte units. With 50
        # genes at random a tile holds more than cuda_gram's GCAP = 8
        # distinct decays on a side, and takes the per-entry erf path.
        kin50 = kinetics(50, dtype, gen50)
        for n_rows, kin, rng in ((1037, (d5, s5, l5), gen), (35, (d5, s5, l5), gen),
                                 (1037, kin50, gen50)):
            for kind in cuda_gram.SYM_KINDS:
                check_k2(kind_rows(n_rows, kin[0].shape[0], dtype, kind, rng), *kin, kind, atol,
                         timed=False)
    check_k2(Xd, d32, s32, l32, "xx", 5e-5, timed=True)

    # K1, every kind in both types against both plain versions, on the main
    # path's shapes (the dense rows against the latent and the expression
    # grids; the canonical rows against 100 and 500 points) and on ragged
    # ones: n = 1037 (masked row edges) against m = 53 (no 16-byte row in
    # either type) and m = 198 (none in float32, a mostly full last tile),
    # with genes G and G + 1 that clamp to G - 1 and force rows (gene -1);
    # and with 50 genes at random (more than GCAP = 8 distinct decays a
    # tile side: the per-entry erf path). Its own generator keeps the
    # shared one's sequence as it was.
    genk1 = torch.Generator().manual_seed(8)

    def k1_rows(n, genes, dtype):
        xm = mixed_rows(n, genes, dtype, genk1)
        expr = xm[:, 2] == 1
        xm[expr, 1] = torch.randint(0, genes + 2, (int(expr.sum()),), generator=genk1).to(
            dtype).to(dev)
        return xm

    for dtype, atol in ((f32, 5e-5), (f64, 1e-10)):
        kin5, kin50 = kinetics(5, dtype, genk1), kinetics(50, dtype, genk1)
        Xc, _, _ = train_arrays(P53Data(replicate=0, source="synthetic", seed=0), dev, dtype)
        Xdd = dense_rows(G, T, dtype)
        shapes = (
            ("dense latent", Xdd, latent_grid(T, dtype=dtype, device=dev), kin50),
            ("dense expression", Xdd, expression_grid(G, 100, dtype=dtype, device=dev), kin50),
            ("canonical latent", Xc, latent_grid(100, dtype=dtype, device=dev), kin5),
            ("canonical expression", Xc, expression_grid(5, 100, dtype=dtype, device=dev), kin5),
            ("ragged", k1_rows(1037, 5, dtype), k1_rows(53, 5, dtype), kin5),
            ("ragged, 50 genes", k1_rows(1037, 50, dtype), k1_rows(53, 50, dtype), kin50),
            ("ragged, m = 198", k1_rows(1037, 5, dtype), k1_rows(198, 5, dtype), kin5),
        )
        for label, x1, x2, kin in shapes:
            for kind in cuda_gram.KIND_CODES:
                check_k1(label, x1, x2, *kin, kind, atol)

    # K3, K4 and K5 on inputs from a REAL dense10k Sigma at the init params
    # (random A A^T + n I matrices are far better conditioned than a SIMM
    # Gram and prove little).
    dense_data = port_main.synthetic_dense_data(G, T, seed=0, dtype=f32, device=dev)
    Xr, yr, _ = train_arrays(dense_data, dev, f32)
    p0 = simm.init_params(G, dtype=f32, device=dev)
    model32 = simm.ExactSIMM(num_genes=G, jitter=cfg.EXACT_JITTER, canonical_rows=True)
    with torch.no_grad():
        sigma = mll_ops.add_diagonal(model32.gram(p0, Xr, "xx"),
                                     model32.jitter + p0.obs_stddev**2)
        L_cusolver = mll_ops.cholesky(sigma)
        Li = cc.tri_inv(L_cusolver)
    # FP32 sums over up to 1e4 terms in another order than cuBLAS:
    # ~sqrt(n) eps relative to the largest entry; 1e-4 leaves room. Against
    # the f64 product, the split 3xTF32 products may lose at most twice the
    # plain FP32 version's accuracy.
    K3_REL_LIMIT = 1e-4

    def check_k3(Li, label):
        ker = cc.syrk_ltl_tril_kernel(Li)
        ref = cc.syrk_ltl_tril_plain(Li)
        truth = torch.tril(Li.double().T @ Li.double())
        torch.cuda.synchronize()
        err = float((ker - ref).abs().max())
        rel = err / float(ref.abs().max())
        truth_max = float(truth.abs().max())
        e_ker = float((ker.double() - truth).abs().max()) / truth_max
        e_plain = float((ref.double() - truth).abs().max()) / truth_max
        print(f"[K3] syrk_ltl_tril {Li.shape[0]} f32 ({label}, 3xTF32 wgmma): max abs err "
              f"{err:.3e}, rel to max {rel:.3e} (limit {K3_REL_LIMIT:g}); vs the f64 product: "
              f"kernel {e_ker:.3e}, plain FP32 {e_plain:.3e} (limit 2x the plain's)")
        require(math.isfinite(rel) and rel <= K3_REL_LIMIT, f"K3 {label} disagrees: rel {rel}")
        require(e_ker <= 2 * e_plain, f"K3 {label} vs f64: {e_ker} > 2 x {e_plain}")
        require(bool(torch.all(torch.triu(ker, 1) == 0)), f"K3 {label} wrote above the diagonal")
        return err

    # A ragged n (not a multiple of 4) takes the kernel's 4-byte copies: Li
    # of the real Sigma's leading 1037 rows.
    check_k3(cc.tri_inv(mll_ops.cholesky(sigma[:1037, :1037])), "real Sigma, leading 1037 rows")
    err = check_k3(Li, "real Sigma")
    n = Li.shape[0]
    syrk_flops = 2 * sum((a + 1) * (n - a) for a in range(n))
    # Three split passes on the tensor cores at the dense TF32 peak.
    b, by = bound_ms(n * (n + 1) // 2 * 4 + n * n * 4, 3 * syrk_flops, TF32_FLOP_PER_S)
    records["K3"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: cc.syrk_ltl_tril_kernel(Li)),
        plain_ms=cuda_ms(lambda: cc.syrk_ltl_tril_plain(Li)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.tril(Li.T @ Li)),
        shape=f"{n}x{n} f32", peak="TF32 tensor cores, 495e12 FLOP/s, 3 passes",
    )
    print(f"[K3] ms {records['K3']['ms']:.4f} plain_ms {records['K3']['plain_ms']:.4f} "
          f"bound_ms {b:.4f} ({by}; {records['K3']['peak']}) library_ms "
          f"{records['K3']['library_ms']:.4f} (torch.tril(Li.T @ Li), timed only)")
    del Li

    # K2's backward, per parameter group against the float64 plain VJP
    # (max|kernel - f64 plain| / max|f64 plain|), beside the float32 plain
    # VJP's figure on the same inputs.
    def grad_errors(x, d, s, l, kind, g, ker=None):
        """Per group: (error of ``ker``, by default the kernel's gradient,
        error of the f32 plain VJP or None in f64), each against the f64
        plain VJP, relative to its largest entry."""
        needs = (False, True, True, True)
        if ker is None:
            ker = cuda_gram.gram_sym_bwd_kernel(x, d, s, l, kind, g)
        ref = cuda_gram.gram_sym_vjp_plain(x.double(), d.double(), s.double(), l.double(),
                                           kind, g.double(), needs)[1:]
        plain = (None,) * 3
        if x.dtype == f32:
            plain = cuda_gram.gram_sym_vjp_plain(x, d, s, l, kind, g, needs)[1:]
        torch.cuda.synchronize()
        out = {}
        for name, k, r, p in zip(("decay", "sens", "lengthscale"), ker, ref, plain):
            if kind == "ff" and name != "lengthscale":
                continue
            m = float(r.abs().max())
            out[name] = (float((k.double() - r).abs().max()) / m,
                         None if p is None else float((p.double() - r).abs().max()) / m)
        return out

    def check_k2_bwd(label, x, d, s, l, kind, g):
        errs = grad_errors(x, d, s, l, kind, g)
        shown = "; ".join(f"{k} kernel {e:.3e}" + ("" if p is None else f" plain f32 {p:.3e}")
                          for k, (e, p) in errs.items())
        limit = "2x the f32 plain VJP's" if x.dtype == f32 else "1e-10"
        print(f"[K2 bwd] {label} N={x.shape[0]} {kind} {x.dtype}: vs f64 plain VJP, "
              f"rel to max: {shown} (limit {limit})")
        for k, (e, p) in errs.items():
            bad = not math.isfinite(e) or (e > 2 * p if p is not None else e > 1e-10)
            require(not bad, f"K2 bwd {label} {kind} {k}: {e} (plain {p})")

    def mll_cotangent(impl):
        """The cotangent the dense10k MLL backward hands to the Gram at
        the init point (the lower-triangle form at this size)."""
        K = model32.gram(p0, Xr, "xx").detach().requires_grad_(True)
        sig = mll_ops.add_diagonal(K, model32.jitter + p0.obs_stddev**2)
        loss = -mll_ops.mvn_logpdf(yr, model32.mean_function(p0, Xr), sig, impl=impl)
        return torch.autograd.grad(loss, K)[0]

    d0, s0, l0 = p0.decay, p0.sensitivity, p0.lengthscale
    g_xla = mll_cotangent("xla")
    for impl, g in (("xla", g_xla), ("blocked", mll_cotangent("blocked"))):
        check_k2_bwd(f"dense10k MLL cotangent ({impl})", Xr, d0, s0, l0, "xx", g)
    g_rand = torch.randn(Xr.shape[0], Xr.shape[0], generator=gen).to(dev)
    check_k2_bwd("random non-symmetric cotangent", Xd, d32, s32, l32, "xx", g_rand)
    del g_rand
    for n_rows in (1000, 1037):
        d5, s5, l5 = kinetics(5, f64)
        xm = mixed_rows(n_rows, 5, f64)
        check_k2_bwd("random cotangent", xm, d5, s5, l5, "mixed",
                     torch.randn(n_rows, n_rows, generator=gen, dtype=f64).to(dev))
    # Every other template instance (kind x dtype) at the ragged N = 1037;
    # with 50 genes at random, the per-entry erf path of 'xx' and 'mixed'.
    for dtype, kind, genes in ((f32, "mixed", 5), (f32, "ff", 5), (f64, "ff", 5), (f64, "xx", 5),
                               (f32, "xx", 50), (f32, "mixed", 50), (f64, "xx", 50),
                               (f64, "mixed", 50)):
        rng = gen50 if genes == 50 else gen
        dk, sk, lk = kinetics(genes, dtype, rng)
        xm = kind_rows(1037, genes, dtype, kind, rng)
        check_k2_bwd(f"random cotangent, {genes} genes", xm, dk, sk, lk, kind,
                     torch.randn(1037, 1037, generator=rng, dtype=f64).to(dtype).to(dev))
    # The plain hoisted arithmetic that the kernels implement
    # (cuda_gram.gram_sym_hoisted: per-row tables, per-entry terms,
    # hand-derived adjoints) against the plain closed form on the card:
    # the Gram within the kernels' limits (5e-5 f32, 1e-10 f64), exactly
    # symmetric; the gradient per group against the f64 plain VJP within
    # 1e-10 in f64, and in f32 within twice the f32 plain VJP's error or
    # 4 f32 ulps (2.4e-7), whichever is larger: where neither sum cancels
    # ('ff', N = 35) both sit at rounding level, and the plain's can land
    # on the nearest float by chance.
    HOISTED_F32_FLOOR = 4 * 2.0**-24
    for dtype, atol in ((f32, 5e-5), (f64, 1e-10)):
        for n_rows in (1037, 35):
            for kind in cuda_gram.SYM_KINDS:
                d5, s5, l5 = kinetics(5, dtype)
                xm = kind_rows(n_rows, 5, dtype, kind)
                g = torch.randn(n_rows, n_rows, generator=gen, dtype=f64).to(dtype).to(dev)
                K, grads = cuda_gram.gram_sym_hoisted(xm, d5, s5, l5, kind, g)
                ref = cuda_gram.gram_sym_plain(xm, d5, s5, l5, kind)
                err = float((K - ref).abs().max())
                symmetric = bool(torch.equal(K, K.T))
                errs = grad_errors(xm, d5, s5, l5, kind, g, grads)
                shown = "; ".join(f"{k} {e:.3e}" + ("" if p is None else f" (plain f32 {p:.3e})")
                                  for k, (e, p) in errs.items())
                print(f"[hoisted] plain hoisted form N={n_rows} {kind} {dtype}: Gram vs plain "
                      f"closed form max abs err {err:.3e} (atol {atol:g}), exactly symmetric: "
                      f"{symmetric}; gradient vs f64 plain VJP, rel to max: {shown}")
                require(math.isfinite(err) and err <= atol and symmetric,
                        f"hoisted {kind} {dtype} N={n_rows}: Gram {err}")
                for k, (e, p) in errs.items():
                    limit = 1e-10 if p is None else max(2 * p, HOISTED_F32_FLOOR)
                    require(math.isfinite(e) and e <= limit,
                            f"hoisted {kind} {dtype} N={n_rows} {k}: {e} (limit {limit})")
    # Force rows carry gene -1, clamped to 0 by the gathers: with no
    # expression row of gene 0, the kernel must credit gene 0 nothing.
    for dtype in (f32, f64):
        xm = mixed_rows(1037, 5, dtype)
        xm[:, 1] = torch.where(xm[:, 2] == 1, xm[:, 1].clamp(min=1), xm[:, 1])
        d5, s5, l5 = kinetics(5, dtype)
        gd, gs, _ = cuda_gram.gram_sym_bwd_kernel(
            xm, d5, s5, l5, "mixed", torch.randn(1037, 1037, generator=gen).to(dtype).to(dev))
        clean = float(gd[0]) == 0 and float(gs[0]) == 0 and bool(torch.all(gd[1:] != 0))
        print(f"[K2 bwd] mixed N=1037 {dtype}, force rows (gene -1) and no gene-0 expression "
              f"row: gene 0's decay and sens gradients exactly 0: {clean}")
        require(clean, "K2 bwd credited a force row to gene 0")
    Xc, _, _ = train_arrays(P53Data(replicate=0, source="synthetic", seed=0), dev, f64)
    pc = simm.init_params(5, dtype=f64, device=dev)
    check_k2_bwd("canonical rows, random cotangent", Xc, pc.decay, pc.sensitivity,
                 pc.lengthscale, "mixed",
                 torch.randn(Xc.shape[0], Xc.shape[0], generator=gen, dtype=f64).to(dev))
    n = Xr.shape[0]
    needs = (False, True, True, True)
    b, by = bound_ms(input_bytes(Xr, d0, s0, l0, g_xla) + (2 * G + 1) * 8,
                     n * (n + 1) // 2 * OPS_PER_XX_ENTRY_BWD + n * OPS_ROW_BWD)
    records["K2bwd"] = dict(
        max_abs_err=max(float((k - r).abs().max()) for k, r in zip(
            cuda_gram.gram_sym_bwd_kernel(Xr, d0, s0, l0, "xx", g_xla),
            cuda_gram.gram_sym_vjp_plain(Xr, d0, s0, l0, "xx", g_xla, needs)[1:])),
        ms=cuda_ms(lambda: cuda_gram.gram_sym_bwd_kernel(Xr, d0, s0, l0, "xx", g_xla)),
        back_to_back_ms=back_to_back_ms(
            lambda: cuda_gram.gram_sym_bwd_kernel(Xr, d0, s0, l0, "xx", g_xla)),
        plain_ms=cuda_ms(lambda: cuda_gram.gram_sym_vjp_plain(Xr, d0, s0, l0, "xx", g_xla, needs),
                         reps=5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"{n}x{n} xx f32, the dense10k MLL cotangent",
    )
    print(f"[K2 bwd] ms {records['K2bwd']['ms']:.4f} back_to_back_ms "
          f"{records['K2bwd']['back_to_back_ms']:.4f} plain_ms {records['K2bwd']['plain_ms']:.4f} "
          f"bound_ms {b:.4f} ({by}) library_ms None")
    del g_xla

    # K4 / K5 on diagonal blocks of the real Sigma, held to an f64 factor
    # computed on the card: each kernel's error may be at most twice the
    # plain float32 version's (cuSOLVER), for L and for Li L - I.
    def block_errors(L, Li, A):
        truth = torch.linalg.cholesky(A.double())
        e_l = float((L.double() - truth).abs().max())
        if Li is None:
            return e_l, None
        eye = torch.eye(A.shape[0], dtype=f64, device=dev)
        return e_l, float((Li.double() @ L.double() - eye).abs().max())

    def check_block_kernel(key, B, timed):
        off = (sigma.shape[0] // 2) // B * B  # a block from the middle of Sigma
        A = sigma[off:off + B, off:off + B].contiguous()
        if key == "K4":
            kout, pout = cc.chol_inv_unblocked_kernel(A), cc.chol_inv_unblocked_plain(A)
            how = ""
        else:
            kout, pout = (cc.chol_unblocked_kernel(A), None), (cc.cholesky_nan(A), None)
            how = f", a cluster of {cc.k5_cluster_size(B)} CTAs"
        torch.cuda.synchronize()
        ek, pk = block_errors(*kout, A), block_errors(*pout, A)
        vs_plain = max(float((k - p).abs().max()) for k, p in zip(kout, pout) if k is not None)
        print(f"[{key}] B={B} (real Sigma block at {off}{how}): kernel vs f64 L {ek[0]:.3e}, "
              f"LiL-I {ek[1]}; plain f32 vs f64 L {pk[0]:.3e}, LiL-I {pk[1]}; "
              f"kernel vs plain {vs_plain:.3e} (limit: 2x the plain error)")
        for e, p, what in zip(ek, pk, ("L", "LiL-I")):
            if e is not None:
                require(math.isfinite(e) and e <= 2 * p, f"{key} B={B} {what}: {e} > 2 x {p}")
        require(bool(torch.all(torch.triu(kout[0], 1) == 0)), f"{key} wrote above the diagonal")
        if not timed:
            return
        if key == "K4":
            fn, plain = cc.chol_inv_unblocked_kernel, cc.chol_inv_unblocked_plain
            b, by = bound_ms(3 * B * B * 4, 2 * B**3 / 3)
        else:
            fn, plain = cc.chol_unblocked_kernel, cc.cholesky_nan
            b, by = bound_ms(2 * B * B * 4, B**3 / 3)
        rec = dict(max_abs_err=vs_plain, ms=cuda_ms(lambda: fn(A), reps=20),
                   plain_ms=cuda_ms(lambda: plain(A), reps=20), bound_ms=b, bound_by=by,
                   shape=f"{B}x{B} f32")
        if key == "K5":
            rec["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(A), reps=20)
        else:
            # K4's function, L and L^{-1} of one block, in library calls:
            # cuSOLVER's factor (cholesky_ex, no host check) and cuBLAS's
            # triangular solve against the identity.
            eye = torch.eye(B, dtype=f32, device=dev)
            rec["library_ms"] = cuda_ms(lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(A)[0], eye, upper=False), reps=20)
        print(f"[{key}] B={B}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
              f"bound_ms {b:.5f} ({by}) library_ms {rec['library_ms']:.4f}")
        if key == "K4" and B == 128:
            k4_phases(A)
        if timed == "main":
            records[key] = rec

    def k4_phases(A):
        """K4's phases from its own %globaltimer stamps (median of 20
        launches, each read back), and the wrapper's host time per call
        (200 calls enqueued back to back)."""
        rows = []
        for _ in range(20):
            cc.chol_inv_unblocked_kernel(A)
            rows.append(cc.k4_phase_stamps(A.device).double().cpu() / 1e3)
        st = torch.stack(rows)
        phases = (st[:, 1:] - st[:, :-1]).median(dim=0).values.tolist()
        device_us = float((st[:, -1] - st[:, 0]).median())
        torch.cuda.synchronize()
        calls = 200
        t0 = time.perf_counter()
        for _ in range(calls):
            cc.chol_inv_unblocked_kernel(A)
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        named = ", ".join(f"{name} {us:.2f}" for name, us in zip(cc.K4_PHASES[1:], phases))
        print(f"[K4 phases] B={A.shape[0]} us (each from the previous stamp): {named}; "
              f"device (entry to stored) {device_us:.2f} us; host us per call {host_us:.1f} "
              f"({'above' if host_us > device_us else 'below'} the device time)")

    # The shapes of the main path: K4 at B=128 (blocked_cholesky_t's
    # diagonal step), K5 at B=512 (blocked_cholesky's); the others checked
    # (K4 at 512 and K5 at 96 also timed).
    for key, B, timed in (("K4", 128, "main"), ("K4", 512, "shown"), ("K5", 32, None),
                          ("K5", 96, "shown"), ("K5", 100, None), ("K5", 128, None),
                          ("K5", 256, None), ("K5", 512, "main")):
        check_block_kernel(key, B, timed)
    # K5's cluster-size rule (one CTA per 32-row block, at most 8) against the other
    # sizes whose shared memory fits, through the C entry point (these
    # launches are not counted).
    lib = cuda_build.load("chol_block", cc.CHOL_SIGNATURES)
    for B in (96, 128, 256, 512):
        A = sigma[:B, :B].contiguous()
        L = torch.empty_like(A)
        times = {}
        row_blocks = -(-B // 32)
        for C in range(1, 9):
            if -(-row_blocks // C) > 2 or C > row_blocks:
                continue  # more than 64 rows a CTA does not fit; or CTAs without rows
            times[C] = cuda_ms(lambda: cuda_build.check(lib.chol_block_f32(
                A.data_ptr(), B, B, L.data_ptr(), C, cuda_build.stream_handle(dev)), "K5"),
                reps=20)
        print(f"[K5] B={B} ms by cluster size {times} (rule: {cc.k5_cluster_size(B)})")
    # Shared-memory sizes that shrink and grow again between launches.
    for B in (512, 32, 96, 512):
        cc.chol_unblocked_kernel(sigma[:B, :B])
    torch.cuda.synchronize()
    # K5 on a block with a negative pivot: a NaN factor, and the launch ends
    # (no control flow depends on the data, so no cluster barrier is missed).
    bad = sigma[:512, :512].clone()
    bad[300, 300] = -1.0
    t0 = time.perf_counter()
    L_bad = cc.chol_unblocked_kernel(bad)
    torch.cuda.synchronize()
    nan = bool(torch.isnan(L_bad[300:]).any()) and bool(torch.isfinite(L_bad[:288]).all())
    print(f"[K5] B=512 with a negative pivot at row 300: NaN from there on, finite before: {nan} "
          f"in {time.perf_counter() - t0:.3f} s")
    require(nan, "K5: a negative pivot did not give NaN")
    del bad, L_bad

    # K6 / K7 on the whole real Sigma (N = 1e4). Reconstruction
    # max|LL^T - Sigma| / max|Sigma| at most twice cuSOLVER's at the default
    # block (the blocked engine's rule); kernel vs plain version within twice
    # cuSOLVER's distance from the f64 factor: both are f32 factors of the
    # same tile algorithm that differ only in the order of their sums, so a
    # wrong tile or a race shows as an O(1) difference, roundoff as one at
    # cuSOLVER's level.
    sigma_max = float(sigma.abs().max())

    def chain_line(key, label, stamps, kernel_ms):
        """The diagonal chain of one launch from its stamps (rows
        cf.CHAIN_ROWS). Link k-1 -> k, from diagonal flag to diagonal flag,
        splits into: the previous TRSM (diagonal flag k-1 to the flag of
        the sub-diagonal tile (k-1, k), its own corrections' lateness
        included); the diagonal tile's lateness (its corrections j < k-1
        still running at that flag); its last correction step; its routine."""
        ticket, early, start, flag, subdiag = stamps.double().cpu() / 1e3  # microseconds
        links = flag[1:] - flag[:-1]
        trsm = subdiag[1:] - flag[:-1]
        late = (early[1:] - subdiag[1:]).clamp(min=0)
        last = start[1:] - torch.maximum(early[1:], subdiag[1:])
        routine = flag - start
        share = float(routine.sum()) / 1e3 / kernel_ms
        print(f"[{key} chain] {label}: {stamps.shape[1] - 1} links, mean {float(links.mean()):.1f} us "
              f"(max {float(links.max()):.1f}) = previous TRSM {float(trsm.mean()):.1f} + "
              f"late corrections {float(late.mean()):.1f} (in {int((late > 0).sum())} links) + "
              f"last correction {float(last.mean()):.1f} + routine {float(routine[1:].mean()):.1f}; "
              f"routines {float(routine.sum()) / 1e3:.3f} ms = {100 * share:.1f} % of "
              f"{kernel_ms:.3f} ms; ticket to routine mean {float((start - ticket).mean()):.1f} us")

    def k7_with_table(A, B, table):
        """K7 through its C entry point with any (tickets, 2) int32 order
        table on the card (not counted): its factor, sync words and chain
        stamps."""
        lib = cuda_build.load("chol_fused", cf.FUSED_SIGNATURES)
        nb = A.shape[0] // B
        L = torch.empty_like(A)
        diag = torch.empty((nb, 3, B, B), dtype=f32, device=dev)
        sync = torch.zeros(2 + nb * nb, dtype=torch.int32, device=dev)
        stamps = torch.zeros((len(cf.CHAIN_ROWS), nb), dtype=torch.int64, device=dev)
        cuda_build.check(lib.fused_chol2_f32(
            A.data_ptr(), A.shape[0], B, L.data_ptr(), diag.data_ptr(), sync.data_ptr(),
            stamps.data_ptr(), table.data_ptr(), cuda_build.stream_handle(dev)), "K7")
        return L, sync, stamps

    def recon(L):
        L64 = L.double()
        return float((L64 @ L64.T - sigma.double()).abs().max()) / sigma_max

    rec_cusolver = recon(L_cusolver)
    print(f"[K6/K7] CTAs per SM: K6 {cf.occupancy('fused_cholesky')}, "
          f"K7 {cf.occupancy('fused_cholesky2')}")
    n = sigma.shape[0]
    L_f64 = torch.linalg.cholesky(sigma.double())
    e_cusolver = float((L_cusolver.double() - L_f64).abs().max())
    library_ms = cuda_ms(lambda: torch.linalg.cholesky(sigma), reps=5, warmup=1)
    # N^3/3 FP32 operations; each input byte read once, the factor written once.
    b, by = bound_ms(2 * n * n * 4, n**3 / 3)
    pads, factors = {}, {}
    for key, fn, kernel, what, quantum, default in (
        ("K6", cf.fused_cholesky, cf.fused_cholesky_kernel, "fused_cholesky", cf._CHUNK,
         cf.DEFAULT_BLOCK),
        ("K7", cf.fused_cholesky2, cf.fused_cholesky2_kernel, "fused_cholesky2", cf._CHUNK2,
         cf.DEFAULT_BLOCK2),
    ):
        L = fn(sigma)
        require(cf.error_word(what) == 0, f"{key}: error word set")
        require(bool(torch.isfinite(L).all()), f"{key}: factor not finite")
        require(bool(torch.all(torch.triu(L, 1) == 0)), f"{key} wrote above the diagonal")
        plain = cf.fused_cholesky_plain(sigma, default)
        torch.cuda.synchronize()
        vs_plain = float((L - plain).abs().max())
        e_ker = float((L.double() - L_f64).abs().max())
        e_plain = float((plain.double() - L_f64).abs().max())
        r_ker, r_plain = recon(L), recon(plain)
        print(f"[{key}] {what} N={n} B={default} (real Sigma): vs f64 L {e_ker:.3e}, plain "
              f"{e_plain:.3e}, cuSOLVER {e_cusolver:.3e}; kernel vs plain {vs_plain:.3e} "
              f"(limit 2x cuSOLVER's: {2 * e_cusolver:.3e}); max|LL^T - Sigma|/max|Sigma| "
              f"{r_ker:.3e} (plain {r_plain:.3e}, cuSOLVER {rec_cusolver:.3e}, limit 2x)")
        require(vs_plain <= 2 * e_cusolver, f"{key} vs plain: {vs_plain} > 2 x {e_cusolver}")
        require(r_ker <= 2 * rec_cusolver, f"{key}: reconstruction {r_ker} > 2 x {rec_cusolver}")
        repeat = fn(sigma)
        same = bool(torch.equal(repeat, L))
        print(f"[{key}] two calls bitwise equal: {same}; error word {cf.error_word(what)}")
        require(same and cf.error_word(what) == 0, f"{key}: repeat differs or error word set")
        del repeat
        bad = sigma.clone()
        bad[n // 2, n // 2] = -1.0
        t0 = time.perf_counter()
        L_bad = fn(bad)
        torch.cuda.synchronize()
        t_bad = time.perf_counter() - t0
        nan = bool(torch.isnan(L_bad).any())
        print(f"[{key}] non-PD Sigma: NaN factor {nan} in {t_bad:.3f} s; "
              f"error word {cf.error_word(what)}")
        require(nan and cf.error_word(what) == 0, f"{key}: non-PD input not NaN or error word set")
        del bad, L_bad
        # Each block's time (kernel alone on the padded input) and reconstruction;
        # the default is the fastest block that holds 2x cuSOLVER's.
        block_ms = {}
        for B in (128, 256, 512):
            npad = -(-n // (B * quantum)) * (B * quantum)
            A_pad = cc._pad_identity(sigma, npad)
            L_b = kernel(A_pad, B)
            pads[B] = npad
            r_b = recon(L_b[:n, :n])
            block_ms[B] = cuda_ms(lambda: kernel(A_pad, B), reps=5, warmup=1)
            print(f"[{key}] block {B}: ms {block_ms[B]:.4f}, max|LL^T - Sigma|/max|Sigma| "
                  f"{r_b:.3e} ({r_b / rec_cusolver:.2f}x cuSOLVER's), error word "
                  f"{cf.error_word(what)}")
            require(cf.error_word(what) == 0, f"{key} block {B}: error word set")
            if r_b > 2 * rec_cusolver:
                block_ms[B] = math.inf
            chain_line(key, f"B={B}", cf.chain_stamps(what), block_ms[B])
            factors[key, B] = L_b
            if B == default:
                A_def = A_pad
            del A_pad, L_b
        best = min(block_ms, key=block_ms.get)
        print(f"[{key}] fastest block holding 2x cuSOLVER's: {best} (module default {default})")
        records[key] = dict(
            max_abs_err=vs_plain, ms=block_ms[default],
            plain_ms=cuda_ms(lambda: cf.fused_cholesky_plain(A_def, default), reps=5, warmup=1),
            bound_ms=b, bound_by=by, library_ms=library_ms,
            shape=f"{n}x{n} f32 (padded to {A_def.shape[0]}), B={default}",
        )
        del L, plain, A_def

    # K7 runs K6's tile program in another ticket order: its factor must be
    # K6's bitwise at every block (both pad 10000 to the same size), and the
    # same bitwise under the JAX order (depth 0). A difference means a
    # missing wait or a wrong table.
    for B in (128, 256, 512):
        require(pads[B] == -(-n // (B * cf._CHUNK)) * (B * cf._CHUNK), "K6/K7 padding differs")
        A_pad = cc._pad_identity(sigma, pads[B])
        L_jax = cf.fused_cholesky2_kernel(A_pad, B, 0)
        same_k6 = bool(torch.equal(factors["K7", B], factors["K6", B]))
        same_jax = bool(torch.equal(factors["K7", B], L_jax))
        print(f"[K7] B={B} depth {cf._LOOKAHEAD}: bitwise equal to K6 {same_k6}, to K7 under the "
              f"JAX order {same_jax}; error word {cf.error_word('fused_cholesky2')}")
        require(same_k6 and same_jax and cf.error_word("fused_cholesky2") == 0,
                f"K7 B={B}: factor differs from K6's or from the JAX order's")
        del A_pad, L_jax
    # The look-ahead depth: each depth's time and chain at the default block
    # (depth 0 is the JAX order, 1 the same order, nb row order); the
    # module's depth should be the fastest. Then, for comparison, the
    # order (max(k, i - d), k, i), which defers far tiles to later waves
    # instead of hoisting the diagonal ones, through the C entry point.
    B = cf.DEFAULT_BLOCK2
    A_pad = cc._pad_identity(sigma, pads[B])
    nb = pads[B] // B
    L_ref = factors["K7", B]
    depth_ms = {}
    for d in (0, 2, 3, 4, 6, 8, nb):
        L_d = cf.fused_cholesky2_kernel(A_pad, B, d)
        same = bool(torch.equal(L_d, L_ref))
        require(same and cf.error_word("fused_cholesky2") == 0, f"K7 depth {d}: factor differs")
        depth_ms[d] = cuda_ms(lambda: cf.fused_cholesky2_kernel(A_pad, B, d), reps=5, warmup=1)
        print(f"[K7] d={d} ms {depth_ms[d]:.4f}; bitwise equal to depth {cf._LOOKAHEAD}: {same}")
        chain_line("K7", f"B={B} d={d}", cf.chain_stamps("fused_cholesky2"), depth_ms[d])
    print(f"[K7] fastest depth {min(depth_ms, key=depth_ms.get)} (module depth {cf._LOOKAHEAD})")
    tiles = [(k, i) for k in range(nb) for i in range(k, nb)]
    for d in (2, 8):
        table = torch.tensor(sorted(tiles, key=lambda t: (max(t[0], t[1] - d), t[0], t[1])),
                             dtype=torch.int32, device=dev)
        L_d, sync, stamps = k7_with_table(A_pad, B, table)
        same = bool(torch.equal(L_d, L_ref))
        require(same and int(sync[1]) == 0, f"K7 deferring order d={d}: factor differs")
        t_ms = cuda_ms(lambda: k7_with_table(A_pad, B, table), reps=5, warmup=1)
        print(f"[K7] deferring order (max(k, i - d), k, i) d={d}: ms {t_ms:.4f}; bitwise equal: "
              f"{same}")
        chain_line("K7", f"B={B} deferring d={d}", stamps, t_ms)
    del A_pad, L_ref, L_d, factors
    del L_f64

    for name, r in records.items():
        b2b = f" back_to_back_ms {r['back_to_back_ms']:.4f}" if "back_to_back_ms" in r else ""
        print(f"[{name}] {r['shape']}: ms {r['ms']:.4f}{b2b} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) library_ms {r['library_ms']}")

    # -- phase 3: the main paths, counts from 0 before each ------------------
    counters = (cuda_gram.LAUNCHES, cc.LAUNCHES, cf.LAUNCHES)
    main_counts = {k: 0 for c in counters for k in c}

    def drive(what, fn, must_launch, x_grads=None, launch_free=False):
        """Run ``fn`` with every count at 0: each kernel of ``must_launch``
        must launch (``launch_free``: none may); the plain VJP of the rows'
        gradient must run ``x_grads(out)`` times (None: never)."""
        for counts in (*counters, cuda_gram.PLAIN_X_GRADS):
            for k in counts:
                counts[k] = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for c in counters for k, v in c.items()}
        for k, v in got.items():
            main_counts[k] += v
        print(f"[{what}] launches {got}; plain VJPs for the rows' gradient "
              f"{cuda_gram.PLAIN_X_GRADS}")
        for k in must_launch:
            require(got[k] > 0, f"{what}: kernel {k} was not launched")
        require(not launch_free or not any(got.values()), f"{what}: a kernel was launched")
        want = 0 if x_grads is None else x_grads(out)
        require(cuda_gram.PLAIN_X_GRADS["gram_sym_x"] == want,
                f"{what}: the rows' gradient went through the plain VJP "
                f"{cuda_gram.PLAIN_X_GRADS['gram_sym_x']} times, not {want}")
        return out

    # Canonical route through the CLI's entry point (its device work,
    # main.fit_and_predict), float64, with --track-parameters, --metrics-path
    # and --checkpoint-dir in a temporary directory, and the golden row path
    # (tests/test_golden.py), whose training Gram is K2.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    canon_cfg = cfg.RunConfig(preset="p53", device="cuda", track_parameters=True,
                              metrics_path=os.path.join(tmp, "metrics.jsonl"),
                              checkpoint_dir=os.path.join(tmp, "ckpt"),
                              out_dir=os.path.join(tmp, "plots"))

    def canonical_route():
        canon = port_main.fit_and_predict(canon_cfg)
        data = P53Data(replicate=0, source="synthetic", seed=0)
        X, y, var = train_arrays(data, dev, f64)
        golden_model = simm.ExactSIMM(num_genes=5, jitter=1e-4)
        mll0 = float(golden_model.mll(simm.init_params(5, dtype=f64, device=dev), X, y))
        res = tr.fit(golden_model, simm.init_params(5, dtype=f64, device=dev), X, y,
                     tr.TrainConfig())
        rows = torch.tensor([[2.0, -1.0, 0.0], [6.0, -1.0, 0.0], [11.0, -1.0, 0.0]],
                            dtype=f64, device=dev)
        probe = golden_model.latent_predict(res.params, rows, X, y, var).mean.cpu().tolist()
        return canon, mll0, res, probe

    canon, mll0, res, probe = drive("canonical", canonical_route,
                                    ("gram_rect", "gram_sym", "gram_sym_bwd"))
    for what, dist, n_pts in (("latent", canon.latent, 100),
                              ("expression", canon.expression, 500)):
        require(dist.mean.shape == (n_pts,) and dist.cov.shape == (n_pts, n_pts),
                f"canonical {what} posterior has shape {tuple(dist.mean.shape)}")
        require(bool(torch.isfinite(dist.mean).all() and torch.isfinite(dist.cov).all()),
                f"canonical {what} posterior is not finite")
    gridded_final = float(canon.result.history[-1])
    print(f"[canonical] gridded route final loss {gridded_final!r} (golden 4.810708070243)")
    require(abs(gridded_final - 4.810708070243) <= 1e-6, "gridded final loss off golden")
    final = float(res.history[-1])
    decay = res.params.decay.detach().cpu().tolist()
    print(f"[golden] mll@init {mll0!r} final loss {final!r} decay {decay} probe {probe}")
    require(abs(mll0 - -43.69118241179048) <= 1e-8, "MLL at init off golden (abs 1e-8)")
    require(abs(final - 4.810708070243) <= 1e-6, "final loss off golden (abs 1e-6)")
    require(all(abs(a - b) <= 2e-4 for a, b in zip(
        decay, [0.31840186, 0.41880947, 0.36782237, 0.8, 0.36906359])),
        "trained decays off golden (atol 2e-4)")
    require(all(abs(a - b) <= 2e-4 for a, b in zip(
        probe, [1.34483514, 1.31897536, 0.1286597])),
        "latent probe means off golden (atol 2e-4)")
    canonical_report(canon, canon_cfg, smi)
    canonical_variants(drive, smi)
    shutil.rmtree(tmp)

    # The blocked engine at N = 1e4 on the real Sigma: each factor finite
    # and reconstructing Sigma no worse than twice cuSOLVER's factor.
    Lt, dinvs = drive("blocked_cholesky_t N=1e4",
                      lambda: cc.blocked_cholesky_t(sigma, return_diag_inv=True),
                      ("chol_inv_unblocked",))
    L_t = Lt.T.contiguous()
    del Lt
    L_k5 = drive("blocked_cholesky pallas N=1e4",
                 lambda: cc.blocked_cholesky(sigma, block=512, diag="pallas"),
                 ("chol_unblocked",))
    L_k4 = drive("blocked_cholesky pallas_inv N=1e4",
                 lambda: cc.blocked_cholesky(sigma, block=512, diag="pallas_inv"),
                 ("chol_inv_unblocked",))
    tril_inv = drive("inv_from_factor_tril N=1e4",
                     lambda: cc.inv_from_factor_tril(L_t, diag_inv=dinvs), ("syrk_ltl_tril",))
    L_k6 = drive("fused_cholesky N=1e4", lambda: cf.fused_cholesky(sigma), ("fused_cholesky",))
    L_k7 = drive("fused_cholesky2 N=1e4", lambda: cf.fused_cholesky2(sigma),
                 ("fused_cholesky2",))
    for what in ("fused_cholesky", "fused_cholesky2"):
        require(cf.error_word(what) == 0, f"{what} N=1e4: error word set")
    for tag, what, L in (("blocked engine", "blocked_cholesky_t (K4)", L_t),
                         ("blocked engine", "blocked_cholesky pallas (K5)", L_k5),
                         ("blocked engine", "blocked_cholesky pallas_inv (K4)", L_k4),
                         ("fused", "fused_cholesky (K6)", L_k6),
                         ("fused", "fused_cholesky2 (K7)", L_k7)):
        require(bool(torch.isfinite(L).all()), f"{what}: factor not finite")
        r = recon(L)
        print(f"[{tag}] {what}: max|LL^T - Sigma|/max|Sigma| {r:.3e} "
              f"(cuSOLVER {rec_cusolver:.3e}, limit 2x)")
        require(r <= 2 * rec_cusolver, f"{what}: reconstruction {r} > 2 x {rec_cusolver}")
    # The same left-looking algorithm with cuSOLVER diagonal steps, for
    # information: the share of the error that is the algorithm's (its
    # TRSM is a product with the diagonal inverse), not the kernels'.
    print(f"[blocked engine] blocked_cholesky xla diag (no kernel): "
          f"{recon(cc.blocked_cholesky(sigma, block=512, diag='xla')):.3e}")
    print(f"[blocked engine] blocked_cholesky pallas (K5) f32 N=1e4 B=512: ms "
          f"{cuda_ms(lambda: cc.blocked_cholesky(sigma, block=512, diag='pallas'), reps=5):.4f} "
          f"(its correction in float64)")
    del L_k5, L_k4, L_k6, L_k7
    plain_tril = cc.inv_from_factor_tril(L_t, diag_inv=dinvs, kernels=False)
    rel = float((tril_inv - plain_tril).abs().max()) / float(plain_tril.abs().max())
    print(f"[blocked engine] inv_from_factor_tril(diag_inv) K3 vs plain: rel to max {rel:.3e} "
          f"(limit {K3_REL_LIMIT:g})")
    require(math.isfinite(rel) and rel <= K3_REL_LIMIT, "inv_from_factor_tril K3 vs plain")
    del plain_tril, tril_inv, L_t, dinvs, L_cusolver, sigma

    # The dense route, float32, through each engine of the MLL: 'xla' (what
    # 'auto' resolves to) through the CLI's entry point, 'blocked' through
    # the library API on the same data, with run_dense's training loop.
    def blocked_dense_steps(base):
        model = simm.ExactSIMM(num_genes=G, jitter=cfg.EXACT_JITTER, canonical_rows=True,
                               chol_impl="blocked")
        optimizer = generic.Adam(0.01)
        raw = simm.unconstrain(simm.init_params(G, dtype=f32, device=dev))
        opt_state = optimizer.init(raw)
        losses, norms, step_seconds = [], [], []
        for _ in range(DENSE_STEPS):
            ts = time.perf_counter()
            loss, grads = generic.value_and_grad(
                lambda r: -model.mll(simm.constrain(r), base.X, base.y), raw)
            updates, opt_state = optimizer.update(grads, opt_state)
            raw = generic.apply_updates(raw, updates)
            losses.append(float(loss))  # host fetch: the step has finished
            norms.append(float(generic.global_norm(grads)))
            step_seconds.append(time.perf_counter() - ts)
        result = tr.TrainResult(params=simm.constrain(raw), history=torch.tensor(losses, dtype=f64),
                                grad_norms=torch.tensor(norms, dtype=f64), raw_params=raw,
                                opt_state=opt_state)
        return port_main.DenseRun(result, model, base.data, base.X, base.y, base.var,
                                  step_seconds)

    # Peak memory of a dense route: the allocator's peak during the run less
    # what this script already held when the run began (the peak counter
    # counts both).
    held = {}

    def dense_route(impl, base=None):
        def run():
            torch.cuda.reset_peak_memory_stats(dev)
            held[impl] = torch.cuda.memory_allocated(dev)
            if impl == "blocked":
                return blocked_dense_steps(base)
            return port_main.run_dense(cfg.RunConfig(
                preset="dense10k", synth_genes=G, synth_timepoints=T,
                num_iters=DENSE_STEPS, x64=False, device="cuda",
            ))
        must = ("gram_sym", "gram_sym_bwd", "syrk_ltl_tril")
        if impl == "blocked":
            must += ("chol_inv_unblocked",)
        dense = drive(f"dense {impl}", run, must)
        peak_gib = (torch.cuda.max_memory_allocated(dev) - held[impl]) / 2**30
        hist = dense.result.history.tolist()
        step_ms = [1e3 * s for s in dense.step_seconds]
        steady = statistics.median(step_ms[1:])
        q1, _, q3 = statistics.quantiles(step_ms[1:], n=4)
        print(f"[dense {impl}] N={dense.X.shape[0]} losses {hist}")
        print(f"[dense {impl}] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) "
              f"{steady:.3f}, spread (interquartile) {q3 - q1:.3f}; peak memory {peak_gib:.3f} GiB "
              f"(above the {held[impl] / 2**30:.3f} GiB held before the run)")
        require(all(math.isfinite(v) for v in hist), f"dense {impl} losses not finite")
        return dense, steady, q3 - q1, peak_gib

    dense, steady_xla, spread_xla, peak_xla = dense_route("xla")
    _, s_true, d_true = dense.data.params_ground_truth()
    xla_corr = tuple(float(torch.corrcoef(torch.stack([fitted.double().cpu(),
                                                       torch.as_tensor(true)]))[0, 1])
                     for fitted, true in ((dense.result.params.decay, d_true),
                                          (dense.result.params.sensitivity, s_true)))

    # latent_predict at N = 1e4 on the 200-point training grid, through K1.
    def latent_route():
        t_train = dense.data.timepoints
        rows = torch.stack([t_train, -torch.ones_like(t_train), torch.zeros_like(t_train)], -1)
        with torch.no_grad():
            return dense.model.latent_predict(dense.result.params, rows, dense.X, dense.y,
                                              dense.var)

    post = drive("dense latent posterior", latent_route, ("gram_rect",))
    pmean, pvar = post.mean, post.variance()
    require(pmean.shape == (T,) and bool(torch.isfinite(pmean).all()
                                           and torch.isfinite(pvar).all()),
            "dense latent posterior not finite")
    corr = float(torch.corrcoef(torch.stack([pmean, dense.data.f_true]))[0, 1])
    print(f"[dense] latent posterior at N={dense.X.shape[0]}: finite, "
          f"corr with generating force {corr:.4f}")

    # The expression posterior at N = 1e4 on main.run's 100-point grid for
    # every gene (50 x 100 = 5000 rows): K2 builds Kxx (1e4) and Ktt (5000),
    # K1 the 1e4 x 5000 'xx' cross-covariance.
    egrid = expression_grid(G, 100, dtype=f32, device=dev)
    params = dense.result.params

    def expression_route():
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dense.model.multi_gene_predict(params, egrid, dense.X, dense.y, dense.var)
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)

    epost, phase_ms = drive("dense expression posterior", expression_route,
                            ("gram_rect", "gram_sym"))
    n_e = egrid.shape[0]
    require(epost.mean.shape == (n_e,) and epost.cov.shape == (n_e, n_e),
            f"dense expression posterior has shape {tuple(epost.mean.shape)}")
    require(bool(torch.isfinite(epost.mean).all() and torch.isfinite(epost.cov).all()),
            "dense expression posterior not finite")
    # Held to the same call through the plain versions on the card (float32)
    # and to that call in float64: the kernels' mean and covariance diagonal
    # may stand at most twice as far from the float64 call as the plain
    # float32 call does, and their gap to the plain float32 call at most
    # three times that distance (two float32 evaluations whose roundings
    # differ, each amplified by the solve against Sigma).
    plain_model = simm.ExactSIMM(num_genes=G, jitter=dense.model.jitter, canonical_rows=True,
                                 kernels=False)
    with torch.no_grad():
        ref32 = plain_model.multi_gene_predict(params, egrid, dense.X, dense.y, dense.var)
        ref64 = plain_model.multi_gene_predict(
            type(params)(*(p.double() for p in params)), egrid.double(), dense.X.double(),
            dense.y.double(), dense.var.double())
    for what, ker, p32, p64 in (
            ("mean", epost.mean, ref32.mean, ref64.mean),
            ("covariance diagonal", torch.diagonal(epost.cov), torch.diagonal(ref32.cov),
             torch.diagonal(ref64.cov))):
        scale = float(p64.abs().max())
        gap = float((ker.double() - p32.double()).abs().max()) / scale
        e_ker = float((ker.double() - p64).abs().max()) / scale
        e_plain = float((p32.double() - p64).abs().max()) / scale
        print(f"[dense expression posterior] {what}: kernels vs plain f32 {gap:.3e} (limit 3x "
              f"the plain's distance from f64: {3 * e_plain:.3e}); vs the f64 plain call: "
              f"kernels {e_ker:.3e}, plain f32 {e_plain:.3e} (limit 2x); relative to "
              f"max|f64| {scale:.4g}")
        require(math.isfinite(gap) and gap <= 3 * e_plain,
                f"expression posterior {what}: kernels vs plain {gap} > 3 x {e_plain}")
        require(e_ker <= 2 * e_plain,
                f"expression posterior {what} vs f64: kernels {e_ker} > 2 x {e_plain}")
    del ref32, ref64, ker, p32, p64  # the diagonals are views of the covariances
    # The phase's stages, each timed alone with CUDA events at the fit's
    # parameters, and K1's share of the phase.
    with torch.no_grad():
        pd, ps, pl = params.decay, params.sensitivity, params.lengthscale
        Kxx = cuda_gram.gram_sym_kernel(dense.X, pd, ps, pl, "xx")
        sig_e = mll_ops.add_diagonal(Kxx, dense.var.reshape(-1) + params.obs_stddev**2)
        L_e = mll_ops.cholesky(sig_e)
        Ktt = cuda_gram.gram_sym_kernel(egrid, pd, ps, pl, "xx")
        Kxt = cuda_gram.gram_rect_kernel(dense.X, egrid, pd, ps, pl, "xx")
        solved = mll_ops.chol_solve(L_e, Kxt)
        resid = dense.y.reshape(-1) - dense.model.mean_function(params, dense.X)
        e_stages = {
            "gram Kxx K2 (1e4)": lambda: cuda_gram.gram_sym_kernel(dense.X, pd, ps, pl, "xx"),
            "add_diagonal": lambda: mll_ops.add_diagonal(
                Kxx, dense.var.reshape(-1) + params.obs_stddev**2),
            "cholesky (cuSOLVER)": lambda: mll_ops.cholesky(sig_e),
            "gram Ktt K2 (5000)": lambda: cuda_gram.gram_sym_kernel(egrid, pd, ps, pl, "xx"),
            "cross-covariance Kxt K1 (1e4 x 5000)": lambda: cuda_gram.gram_rect_kernel(
                dense.X, egrid, pd, ps, pl, "xx"),
            "chol_solve (5000 right-hand sides)": lambda: mll_ops.chol_solve(L_e, Kxt),
            "mean (solved^T r)": lambda: solved.T @ resid,
            "covariance (Ktt - Kxt^T solved)": lambda: Ktt - Kxt.T @ solved,
        }
        e_ms = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in e_stages.items()}
    k1_ms = e_ms["cross-covariance Kxt K1 (1e4 x 5000)"]
    print(f"[dense expression posterior] N={dense.X.shape[0]} x {n_e}: phase {phase_ms:.3f} ms "
          f"(host clock, one call); stage ms {json.dumps(e_ms)}; sum "
          f"{sum(e_ms.values()):.3f}; K1 {k1_ms:.4f} ms = {100 * k1_ms / phase_ms:.2f} % of "
          f"the phase")
    del epost, e_stages, Kxx, sig_e, L_e, Ktt, Kxt, solved

    dense_b, steady_blocked, spread_blocked, peak_blocked = dense_route("blocked", base=dense)

    # -- phase 4: each engine's first dense step vs the plain f32 path ------
    plain_model = simm.ExactSIMM(num_genes=G, jitter=dense.model.jitter, canonical_rows=True,
                                 kernels=False, chol_impl="xla")
    raw0 = simm.unconstrain(simm.init_params(G, dtype=f32, device=dev))
    lp, gp = generic.value_and_grad(
        lambda r: -plain_model.mll(simm.constrain(r), dense.X, dense.y), raw0)
    gp_v = torch.cat([g.reshape(-1) for g in gp])
    for impl, run in (("xla", dense), ("blocked", dense_b)):
        lk, gk = generic.value_and_grad(
            lambda r: -run.model.mll(simm.constrain(r), run.X, run.y), raw0)
        gk_v = torch.cat([g.reshape(-1) for g in gk])
        cos = float(gk_v @ gp_v / (gk_v.norm() * gp_v.norm()))
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        print(f"[dense {impl}] first step: loss kernels {float(lk)!r} plain {float(lp)!r} "
              f"rel {loss_rel:.3e} (limit 1e-5); gradient cosine {cos:.6f} (limit 0.999)")
        require(loss_rel <= 1e-5, f"dense {impl} first-step loss: kernels vs plain")
        require(cos >= 0.999, f"dense {impl} first-step gradient direction: kernels vs plain")
        hist0 = float(run.result.history[0])
        require(abs(float(lk) - hist0) <= 1e-5 * abs(hist0), f"run_dense {impl} step 1 loss")

    # Where one dense step's device time goes: each stage of the loss and
    # its backward, timed alone with CUDA events at the init point.
    with torch.no_grad():
        p = simm.constrain(raw0)
        dd, ss, ll = p.decay, p.sensitivity, p.lengthscale
        c = dense.model.jitter + p.obs_stddev**2
        K = cuda_gram.gram_sym_kernel(dense.X, dd, ss, ll, "xx")
        sigma = mll_ops.add_diagonal(K, c)
        yc = dense.y - dense.model.mean_function(p, dense.X)
        L = mll_ops.cholesky(sigma)
        alpha = mll_ops.chol_solve(L, yc)
        Li = cc.tri_inv_panels(L).contiguous()
        tril_inv = cc.syrk_ltl_tril_kernel(Li)
        Lt, dinvs = cc.blocked_cholesky_t(sigma, return_diag_inv=True)
        L_b = Lt.mT

        def d_sigma():
            out = 0.5 * torch.outer(alpha, alpha) - tril_inv
            out.diagonal().add_(0.5 * torch.diagonal(tril_inv))
            return out

        def lt_solve():
            z = torch.linalg.solve_triangular(Lt.mT, yc[:, None], upper=False)
            return torch.linalg.solve_triangular(Lt, z, upper=True)

        dsig = d_sigma()
    shared = {
        "gram K2": lambda: cuda_gram.gram_sym_kernel(dense.X, dd, ss, ll, "xx"),
        "add_diagonal": lambda: mll_ops.add_diagonal(K, c),
    }
    tail = {
        "syrk K3": lambda: cc.syrk_ltl_tril_kernel(Li),
        "d_sigma": d_sigma,
        "gram backward K2 bwd": lambda: cuda_gram.gram_sym_bwd_kernel(
            dense.X, dd, ss, ll, "xx", dsig),
    }
    stage_tables = {
        "xla": {**shared,
                "cholesky (cuSOLVER)": lambda: mll_ops.cholesky(sigma),
                "chol_solve": lambda: mll_ops.chol_solve(L, yc),
                "tri_inv_panels": lambda: cc.tri_inv_panels(L).contiguous(),
                **tail},
        "blocked": {**shared,
                    "blocked_cholesky_t (K4 x80)": lambda: cc.blocked_cholesky_t(
                        sigma, return_diag_inv=True),
                    "solve against Lt": lt_solve,
                    "tri_inv_from_diag": lambda: cc.tri_inv_from_diag(L_b, dinvs).contiguous(),
                    **tail},
    }
    # Does the host set the pace of the blocked factorisation (80 K4
    # launches, each ~30 us of Python and launch)? Its enqueue time on the
    # host clock (no synchronisation inside) beside its CUDA-event time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cc.blocked_cholesky_t(sigma, return_diag_inv=True)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    print(f"[dense blocked] blocked_cholesky_t host enqueue {enqueue_ms:.3f} ms vs device "
          f"{cuda_ms(lambda: cc.blocked_cholesky_t(sigma, return_diag_inv=True), reps=5):.3f} ms")
    stage_ms = {}
    for impl, stages in stage_tables.items():
        stage_ms[impl] = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
        steady = steady_xla if impl == "xla" else steady_blocked
        print(f"[dense {impl}] stage ms {json.dumps(stage_ms[impl])}; "
              f"sum {sum(stage_ms[impl].values()):.3f} vs step median {steady:.3f}")
    del K, sigma, L, Li, tril_inv, dsig, Lt, dinvs, L_b
    # 'auto' may take 'blocked' on the card only where a run shows the
    # blocked step faster than the xla step by more than the larger of the
    # two step spreads (ops/mll.py, resolve_chol_impl).
    spread = max(spread_xla, spread_blocked)
    beyond = steady_xla - steady_blocked > spread
    print(f"[auto] dense10k step median: xla {steady_xla:.3f} ms ({peak_xla:.3f} GiB), "
          f"blocked {steady_blocked:.3f} ms ({peak_blocked:.3f} GiB); xla - blocked "
          f"{steady_xla - steady_blocked:.3f} ms, spread {spread:.3f} ms: blocked faster by more "
          f"than the spread: {beyond}; 'auto' resolves to "
          f"{mll_ops.resolve_chol_impl(G * T, f32, dev)!r} on the card")

    cg = dense_cg(drive, smi)
    print(f"[engines] dense10k step median: cg {cg['median']:.3f} ms (spread {cg['spread']:.3f}, "
          f"{cg['peak_gib']:.3f} GiB, recovery corr {cg['corr'][0]:.4f}/{cg['corr'][1]:.4f}), "
          f"xla {steady_xla:.3f} ms (spread {spread_xla:.3f}, {peak_xla:.3f} GiB, recovery corr "
          f"{xla_corr[0]:.4f}/{xla_corr[1]:.4f}); cg / xla {cg['median'] / steady_xla:.3f} ({smi})")

    ss_parity(smi)
    ssr = dense_ss(drive, smi)
    print(f"[engines] dense10k step median: ss {ssr['median']:.3f} ms (spread "
          f"{ssr['spread']:.3f}, {ssr['peak_gib']:.3f} GiB, recovery corr {ssr['corr'][0]:.4f}/"
          f"{ssr['corr'][1]:.4f}), cg {cg['median']:.3f} ms, xla {steady_xla:.3f} ms; ss / xla "
          f"{ssr['median'] / steady_xla:.3f} ({smi})")
    ss_engine_phases(drive, ssr["dense"], smi)
    simm2_phases(drive, smi)
    family_phases(drive, smi)
    sparse_phases(drive, smi)
    nlfm_phases(drive, smi)
    hmc_phases(drive, smi)

    # -- phase 5: summary lines -------------------------------------------
    for k, v in main_counts.items():
        require(v > 0, f"kernel {k} was not launched on the main paths")
    print(f"[main path] launches {main_counts}")
    sources = {
        "K1": ("gram_rect", "dis_project_tpu_torch/csrc/simm_gram.cu",
               "dis_project_tpu/ops/pallas_gram.py:82"),
        "K2": ("gram_sym", "dis_project_tpu_torch/csrc/simm_gram.cu",
               "dis_project_tpu/ops/pallas_gram.py:298"),
        "K2bwd": ("gram_sym_bwd", "dis_project_tpu_torch/csrc/simm_gram.cu",
                  "dis_project_tpu/ops/pallas_gram.py:478 (_gram_sym_bwd, XLA fusion)"),
        "K3": ("syrk_ltl_tril", "dis_project_tpu_torch/csrc/syrk.cu",
               "dis_project_tpu/ops/pallas_cholesky.py:886"),
        "K4": ("chol_inv_unblocked", "dis_project_tpu_torch/csrc/chol_block.cu",
               "dis_project_tpu/ops/pallas_cholesky.py:258"),
        "K5": ("chol_unblocked", "dis_project_tpu_torch/csrc/chol_block.cu",
               "dis_project_tpu/ops/pallas_cholesky.py:143"),
        "K6": ("fused_cholesky", "dis_project_tpu_torch/csrc/chol_fused.cu",
               "dis_project_tpu/ops/pallas_cholesky_fused.py:108"),
        "K7": ("fused_cholesky2", "dis_project_tpu_torch/csrc/chol_fused.cu",
               "dis_project_tpu/ops/pallas_cholesky_fused.py:333"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        r = records[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
            **{k: r[k] for k in ("back_to_back_ms", "peak", "shapes") if k in r},
        })
    print(f"[dense] step_ms_median xla {steady_xla!r} blocked {steady_blocked!r} "
          f"peak_memory_gib xla {peak_xla!r} blocked {peak_blocked!r}")
    print(f"[chip_smoke] total {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--times"] and len(sys.argv) == 3:
        times(sys.argv[2])
    elif len(sys.argv) == 1:
        main()
    else:
        fail(f"usage: {sys.argv[0]} [--times ROOT]")
