#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dis_project_tpu_torch``) on one H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX or of the
JAX package. Phases (each raises on failure):

1. Build the kernels from ``dis_project_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together); print the build seconds and the card's
   ``nvidia-smi`` name and power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with the tolerance stated beside each check, and
   time kernel, plain version and (K3) the library product with CUDA
   events (median of repeats).
3. The main path, with every launch count set to 0 first:
   - the canonical route (``main.run``, p53, float64) and the golden
     row-path fit (``trainer.fit``) held to ``tests/test_golden.py``;
   - the dense10k route (``main.run_dense``, 50 x 200 = 1e4, float32,
     10 Adam steps): per-step ms, peak memory, losses finite;
   - ``latent_predict`` at N = 1e4 on the 200-point training grid.
   The counts are read just after; each kernel must have launched.
4. The dense route's first step through the kernels against the plain
   float32 path (loss rel 1e-5, gradient direction cosine >= 0.999).
5. A ``kernels`` JSON line, then the ``ok`` JSON line last.
"""

import json
import math
import statistics
import subprocess
import sys


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32
# (non-tensor-core) rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# FP32 operations per covariance entry by kind, counted from the closed
# forms in ops/lfm_kernels.py with each exp/erf as one operation (a lower
# bound: CUDA's erff is itself a short polynomial).
OPS_PER_ENTRY = {"xx": 67, "ff": 6, "xf": 20, "fx": 20, "mixed": 128}

# The dense10k configuration (BASELINE config 4 of the JAX package):
# 50 genes x 200 timepoints, N = 1e4; Adam steps driven on the card.
DENSE_GENES, DENSE_TIMEPOINTS, DENSE_STEPS = 50, 200, 10


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
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


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")

    from dis_project_tpu_torch import config as cfg
    from dis_project_tpu_torch import main as port_main
    from dis_project_tpu_torch.data.dataset import P53Data, train_arrays
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import cuda_build, cuda_cholesky, cuda_gram
    from dis_project_tpu_torch.ops import gram as gram_ops
    from dis_project_tpu_torch.ops import mll as mll_ops
    from dis_project_tpu_torch.ops.precision import default_device
    from dis_project_tpu_torch.training import generic
    from dis_project_tpu_torch.training import trainer as tr
    from dis_project_tpu_torch.utils.test_grids import expression_grid, latent_grid

    dev = default_device()
    f32, f64 = torch.float32, torch.float64

    # -- phase 1: build ----------------------------------------------------
    build_s = cuda_build.build(["simm_gram", "syrk"])
    smi = nvidia_smi_line()
    print(f"[build] kernels built in {build_s:.1f}s")
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: kernels against their plain versions -----------------------
    gen = torch.Generator().manual_seed(1234)

    def kinetics(G, dtype):
        decay = (0.2 + 0.8 * torch.rand(G, generator=gen, dtype=f64)).to(dtype).to(dev)
        sens = (0.5 + torch.rand(G, generator=gen, dtype=f64)).to(dtype).to(dev)
        return decay, sens, torch.tensor(2.5, dtype=dtype, device=dev)

    def dense_rows(G, T, dtype):
        t = torch.linspace(0.0, 12.0, T, dtype=dtype, device=dev).repeat(G)
        g = torch.arange(G, dtype=dtype, device=dev).repeat_interleave(T)
        return torch.stack([t, g, torch.ones_like(t)], dim=-1)

    def mixed_rows(n, G, dtype):
        t = 12.0 * torch.rand(n, generator=gen, dtype=f64)
        f = (torch.rand(n, generator=gen) < 0.5).to(f64)
        g = torch.randint(0, G, (n,), generator=gen).to(f64)
        g = torch.where(f == 0, -torch.ones_like(g), g)  # force rows carry -1
        return torch.stack([t, g, f], dim=-1).to(dtype).to(dev)

    def input_bytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    records = {}

    def check_k1(x1, x2, d, s, l, kind, atol, timed):
        ker = cuda_gram.gram_rect_kernel(x1, x2, d, s, l, kind)
        ref = gram_ops.cross_covariance_kind(x1, x2, d, s, l, kind)
        torch.cuda.synchronize()
        err = float((ker - ref).abs().max())
        print(f"[K1] gram_rect {x1.shape[0]}x{x2.shape[0]} {kind} {x1.dtype}: "
              f"max abs err {err:.3e} (atol {atol:g}), "
              f"max rel err {err / float(ref.abs().max()):.3e}")
        require(math.isfinite(err) and err <= atol, f"K1 {kind} disagrees: {err}")
        if timed:
            n, m = ker.shape
            b, by = bound_ms(input_bytes(x1, x2, d, s, l) + ker.numel() * ker.element_size(),
                             n * m * OPS_PER_ENTRY[kind])
            records["K1"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: cuda_gram.gram_rect_kernel(x1, x2, d, s, l, kind)),
                plain_ms=cuda_ms(lambda: gram_ops.cross_covariance_kind(x1, x2, d, s, l, kind)),
                bound_ms=b, bound_by=by, library_ms=None,
                shape=f"{n}x{m} {kind} f32",
            )

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
                             n * (n + 1) // 2 * OPS_PER_ENTRY[kind])
            records["K2"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: cuda_gram.gram_sym_kernel(x, d, s, l, kind)),
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
    check_k1(Xd, grid, d32, s32, l32, "xf", 5e-5, timed=True)
    for dtype, atol in ((f32, 5e-5), (f64, 1e-10)):
        Xc = dense_rows(5, 7, dtype)
        d5, s5, l5 = kinetics(5, dtype)
        check_k1(Xc, expression_grid(5, 100, dtype=dtype, device=dev), d5, s5, l5,
                 "xx", atol, timed=False)
        xm = mixed_rows(1000, 5, dtype)
        check_k2(xm, d5, s5, l5, "mixed", atol, timed=False)
        check_k2(mixed_rows(1037, 5, dtype), d5, s5, l5, "mixed", atol, timed=False)
    check_k2(Xd, d32, s32, l32, "xx", 5e-5, timed=True)

    # K3 on the inverse factor of a REAL dense10k Sigma at the init params
    # (random A A^T + n I matrices are far better conditioned than a SIMM
    # Gram and prove little).
    dense_data = port_main.synthetic_dense_data(G, T, seed=0, dtype=f32, device=dev)
    Xr, _, _ = train_arrays(dense_data, dev, f32)
    p0 = simm.init_params(G, dtype=f32, device=dev)
    model32 = simm.ExactSIMM(num_genes=G, jitter=cfg.EXACT_JITTER, canonical_rows=True)
    with torch.no_grad():
        sigma = mll_ops.add_diagonal(model32.gram(p0, Xr, "xx"),
                                     model32.jitter + p0.obs_stddev**2)
        L = mll_ops.cholesky(sigma)
        Li = cuda_cholesky.tri_inv(L)
    del sigma, L
    ker = cuda_cholesky.syrk_ltl_tril_kernel(Li)
    ref = cuda_cholesky.syrk_ltl_tril_plain(Li)
    torch.cuda.synchronize()
    err = float((ker - ref).abs().max())
    rel = err / float(ref.abs().max())
    # FP32 FMA sums over up to 1e4 terms in another order than cuBLAS:
    # ~sqrt(n) eps relative to the largest entry; 1e-4 leaves room.
    print(f"[K3] syrk_ltl_tril {Li.shape[0]} f32 (real Sigma): max abs err {err:.3e}, "
          f"rel to max {rel:.3e} (limit 1e-4)")
    require(math.isfinite(rel) and rel <= 1e-4, f"K3 disagrees: rel {rel}")
    require(bool(torch.all(torch.triu(ker, 1) == 0)), "K3 wrote above the diagonal")
    n = Li.shape[0]
    syrk_flops = 2 * sum((a + 1) * (n - a) for a in range(n))
    b, by = bound_ms(n * (n + 1) // 2 * 4 + n * n * 4, syrk_flops)
    records["K3"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: cuda_cholesky.syrk_ltl_tril_kernel(Li)),
        plain_ms=cuda_ms(lambda: cuda_cholesky.syrk_ltl_tril_plain(Li)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.tril(Li.T @ Li)),
        shape=f"{n}x{n} f32",
    )
    del ker, ref, Li
    for name, r in records.items():
        print(f"[{name}] {r['shape']}: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']}")

    # -- phase 3: the main path, counts from 0 ----------------------------
    for counts in (cuda_gram.LAUNCHES, cuda_cholesky.LAUNCHES):
        for k in counts:
            counts[k] = 0

    def launches():
        return {**cuda_gram.LAUNCHES, **cuda_cholesky.LAUNCHES}

    # Canonical route through the CLI's entry point, float64.
    canon = port_main.run(cfg.RunConfig(preset="p53", device="cuda"))
    for what, dist, n_pts in (("latent", canon.latent, 100),
                              ("expression", canon.expression, 500)):
        require(dist.mean.shape == (n_pts,) and dist.cov.shape == (n_pts, n_pts),
                f"canonical {what} posterior has shape {tuple(dist.mean.shape)}")
        require(bool(torch.isfinite(dist.mean).all() and torch.isfinite(dist.cov).all()),
                f"canonical {what} posterior is not finite")
    gridded_final = float(canon.result.history[-1])
    print(f"[canonical] gridded route final loss {gridded_final!r} (golden 4.810708070243)")
    require(abs(gridded_final - 4.810708070243) <= 1e-6, "gridded final loss off golden")

    # The golden row path (tests/test_golden.py): the training Gram is K2.
    data = P53Data(replicate=0, source="synthetic", seed=0)
    X, y, var = train_arrays(data, dev, f64)
    golden_model = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    mll0 = float(golden_model.mll(simm.init_params(5, dtype=f64, device=dev), X, y))
    res = tr.fit(golden_model, simm.init_params(5, dtype=f64, device=dev), X, y, tr.TrainConfig())
    final = float(res.history[-1])
    decay = res.params.decay.detach().cpu().tolist()
    rows = torch.tensor([[2.0, -1.0, 0.0], [6.0, -1.0, 0.0], [11.0, -1.0, 0.0]],
                        dtype=f64, device=dev)
    probe = golden_model.latent_predict(res.params, rows, X, y, var).mean.cpu().tolist()
    print(f"[golden] mll@init {mll0!r} final loss {final!r} decay {decay} probe {probe}")
    require(abs(mll0 - -43.69118241179048) <= 1e-8, "MLL at init off golden (abs 1e-8)")
    require(abs(final - 4.810708070243) <= 1e-6, "final loss off golden (abs 1e-6)")
    require(all(abs(a - b) <= 2e-4 for a, b in zip(
        decay, [0.31840186, 0.41880947, 0.36782237, 0.8, 0.36906359])),
        "trained decays off golden (atol 2e-4)")
    require(all(abs(a - b) <= 2e-4 for a, b in zip(
        probe, [1.34483514, 1.31897536, 0.1286597])),
        "latent probe means off golden (atol 2e-4)")
    canonical_counts = launches()
    print(f"[canonical] launches {canonical_counts}")

    # Dense route, float32, through K2 and K3.
    torch.cuda.reset_peak_memory_stats(dev)
    dense = port_main.run_dense(cfg.RunConfig(
        preset="dense10k", synth_genes=G, synth_timepoints=T, num_iters=DENSE_STEPS,
        x64=False, device="cuda",
    ))
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    hist = dense.result.history.tolist()
    step_ms = [1e3 * s for s in dense.step_seconds]
    steady_ms = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    dense_counts = {k: v - canonical_counts[k] for k, v in launches().items()}
    print(f"[dense] N={dense.X.shape[0]} losses {hist}")
    print(f"[dense] step ms {[round(t, 3) for t in step_ms]} median (steps 2+) {steady_ms:.3f}; "
          f"peak memory {peak_gib:.3f} GiB; launches {dense_counts}")
    require(all(math.isfinite(v) for v in hist), "dense losses not finite")
    require(dense_counts["gram_sym"] > 0 and dense_counts["syrk_ltl_tril"] > 0,
            "dense route did not launch K2 and K3")

    # latent_predict at N = 1e4 on the 200-point training grid, through K1.
    t_train = dense.data.timepoints
    rows = torch.stack([t_train, -torch.ones_like(t_train), torch.zeros_like(t_train)], -1)
    with torch.no_grad():
        post = dense.model.latent_predict(dense.result.params, rows, dense.X, dense.y, dense.var)
    pmean, pvar = post.mean, post.variance()
    require(pmean.shape == (T,) and bool(torch.isfinite(pmean).all()
                                           and torch.isfinite(pvar).all()),
            "dense latent posterior not finite")
    corr = float(torch.corrcoef(torch.stack([pmean, dense.data.f_true]))[0, 1])
    print(f"[dense] latent posterior at N={dense.X.shape[0]}: finite, "
          f"corr with generating force {corr:.4f}")
    main_counts = launches()
    print(f"[main path] launches {main_counts}")
    for k, v in main_counts.items():
        require(v > 0, f"kernel {k} was not launched on the main path")

    # -- phase 4: first dense step, kernels vs the plain f32 path ----------
    plain_model = simm.ExactSIMM(num_genes=dense.model.num_genes, jitter=dense.model.jitter,
                                 canonical_rows=True, kernels=False)
    raw0 = simm.unconstrain(simm.init_params(dense.model.num_genes, dtype=f32, device=dev))
    lk, gk = generic.value_and_grad(
        lambda r: -dense.model.mll(simm.constrain(r), dense.X, dense.y), raw0)
    lp, gp = generic.value_and_grad(
        lambda r: -plain_model.mll(simm.constrain(r), dense.X, dense.y), raw0)
    gk_v, gp_v = torch.cat([g.reshape(-1) for g in gk]), torch.cat([g.reshape(-1) for g in gp])
    cos = float(gk_v @ gp_v / (gk_v.norm() * gp_v.norm()))
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    print(f"[dense] first step: loss kernels {float(lk)!r} plain {float(lp)!r} "
          f"rel {loss_rel:.3e} (limit 1e-5); gradient cosine {cos:.6f} (limit 0.999)")
    require(loss_rel <= 1e-5, "dense first-step loss: kernels vs plain")
    require(cos >= 0.999, "dense first-step gradient direction: kernels vs plain")
    require(abs(float(lk) - hist[0]) <= 1e-5 * abs(hist[0]), "run_dense step 1 loss")

    # Where one dense step's device time goes: each stage of the loss and
    # its backward, timed alone with CUDA events at the init point.
    with torch.no_grad():
        p = simm.constrain(raw0)
        dd, ss, ll = p.decay, p.sensitivity, p.lengthscale
        c = dense.model.jitter + p.obs_stddev**2
        K = cuda_gram.gram_sym_kernel(dense.X, dd, ss, ll, "xx")
        sigma = mll_ops.add_diagonal(K, c)
        L = mll_ops.cholesky(sigma)
        yc = dense.y - dense.model.mean_function(p, dense.X)
        alpha = mll_ops.chol_solve(L, yc)
        Li = cuda_cholesky.tri_inv(L)
        tril_inv = cuda_cholesky.syrk_ltl_tril_kernel(Li)

        def d_sigma():
            out = 0.5 * torch.outer(alpha, alpha) - tril_inv
            out.diagonal().add_(0.5 * torch.diagonal(tril_inv))
            return out

        dsig = d_sigma()
    stages = {
        "gram K2": lambda: cuda_gram.gram_sym_kernel(dense.X, dd, ss, ll, "xx"),
        "add_diagonal": lambda: mll_ops.add_diagonal(K, c),
        "cholesky": lambda: mll_ops.cholesky(sigma),
        "chol_solve": lambda: mll_ops.chol_solve(L, yc),
        "tri_inv": lambda: cuda_cholesky.tri_inv(L),
        "syrk K3": lambda: cuda_cholesky.syrk_ltl_tril_kernel(Li),
        "d_sigma": d_sigma,
        "gram backward (plain VJP)": lambda: cuda_gram.plain_vjp(
            lambda x, d, s, l: gram_ops.cross_covariance_kind(x, x, d, s, l, "xx"),
            (dense.X, dd, ss, ll), (False, True, True, True), dsig),
    }
    stage_ms = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
    del K, sigma, L, Li, tril_inv, dsig
    print(f"[dense] stage ms {json.dumps(stage_ms)}; sum {sum(stage_ms.values()):.3f} "
          f"vs step median {steady_ms:.3f}")

    # -- phase 5: summary lines -------------------------------------------
    sources = {
        "K1": ("gram_rect", "dis_project_tpu_torch/csrc/simm_gram.cu",
               "dis_project_tpu/ops/pallas_gram.py:82"),
        "K2": ("gram_sym", "dis_project_tpu_torch/csrc/simm_gram.cu",
               "dis_project_tpu/ops/pallas_gram.py:298"),
        "K3": ("syrk_ltl_tril", "dis_project_tpu_torch/csrc/syrk.cu",
               "dis_project_tpu/ops/pallas_cholesky.py:886"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        r = records[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
        })
    print(f"[dense] step_ms_median {steady_ms!r} peak_memory_gib {peak_gib!r}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
