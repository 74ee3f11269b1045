"""The port's CG/Lanczos engine (``ops/iterative.py``,
``ExactSIMM.mll_iterative`` and the dense route's ``--mll-engine cg``) held
to the JAX package's on the CPU.

The probes are JAX's: ``jax.random.rademacher`` draws, passed as numpy to
the port, which takes its probes as an argument. float64 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.data.dataset import P53Data as JP53Data
from dis_project_tpu.data.dataset import train_arrays as jtrain_arrays
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import iterative as jit_
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import iterative
from dis_project_tpu_torch.training import generic

F32, F64 = torch.float32, torch.float64
# The JAX references compile at XLA's lowest CPU optimisation level.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


@pytest.fixture(scope="module")
def canonical():
    jdata = JP53Data(replicate=0, source="synthetic", seed=0)
    X, y, var = jtrain_arrays(jdata)
    return (X, y), convert.arrays_from_numpy(X, y, var, device="cpu")[:2]


@pytest.fixture(scope="module")
def sigma_np(canonical):
    """The canonical rows' Sigma (N = 35, cond ~1e3) at perturbed
    parameters: a real SIMM Gram, not a random SPD matrix."""
    (X, _), _ = canonical
    p = jsimm.init_params(5)._replace(lengthscale=jnp.asarray(1.7),
                                      obs_stddev=jnp.asarray(0.3))
    model = jsimm.ExactSIMM(num_genes=5, jitter=1e-4)
    K = model.gram(p, X, "mixed")
    return np.asarray(K + (1e-4 + 0.09) * jnp.eye(K.shape[0]))


def _probes(seed, n_probes, n, dtype=jnp.float64):
    return np.asarray(jax.random.rademacher(jax.random.PRNGKey(seed), (n_probes, n)).astype(dtype))


@pytest.mark.parametrize("which", ["random SPD", "SIMM Sigma"])
def test_batched_cg_matches_jax(sigma_np, which):
    rng = np.random.default_rng(0)
    if which == "random SPD":
        a = rng.normal(size=(60, 60))
        sigma = a @ a.T / 60 + 0.5 * np.eye(60)
    else:
        sigma = sigma_np
    b = rng.normal(size=(sigma.shape[0], 5))
    ref, ref_it = _jit(lambda s, b: jit_.batched_cg(lambda x: s @ x, b))(
        jnp.asarray(sigma), jnp.asarray(b))
    stats = {}
    got, it = iterative.batched_cg(torch.tensor(sigma), torch.tensor(b), stats=stats)
    assert it == int(ref_it) and stats["cg_iters"] == it
    assert stats["converged"] == 5 and stats["columns"] == 5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-10)
    # The cap: fewer iterations than convergence needs stop at max_iters.
    _, it_cap = iterative.batched_cg(torch.tensor(sigma), torch.tensor(b), max_iters=3)
    assert it_cap == 3


def test_lanczos_batched_matches_vmapped_jax(sigma_np):
    n = sigma_np.shape[0]
    z = _probes(1, 4, n)
    ref_a, ref_b = _jit(lambda s, z: jax.vmap(lambda v: jit_.lanczos(lambda x: s @ x, v, 12))(z))(
        jnp.asarray(sigma_np), jnp.asarray(z))
    a, b = iterative.lanczos(torch.tensor(sigma_np), torch.tensor(z).T, 12)
    assert a.shape == (4, 12) and b.shape == (4, 11)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), rtol=0, atol=1e-10)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), rtol=0, atol=1e-10)


def test_slq_logdet_matches_jax(sigma_np):
    n = sigma_np.shape[0]
    key = jax.random.PRNGKey(2)
    ref, z = _jit(lambda s: jit_.slq_logdet(lambda x: s @ x, n, key, num_probes=8, m=20,
                                            dtype=jnp.float64))(jnp.asarray(sigma_np))
    got = iterative.slq_logdet(torch.tensor(sigma_np), torch.tensor(np.asarray(z)), 20)
    assert float(got) == pytest.approx(float(ref), rel=0, abs=1e-10)


def test_mvn_logpdf_cg_value_and_grads_match_jax(sigma_np):
    n = sigma_np.shape[0]
    key = jax.random.PRNGKey(3)
    yc = np.random.default_rng(3).normal(size=n)
    ref, (ref_dy, ref_ds) = _jit(jax.value_and_grad(
        lambda y, s: jit_.mvn_logpdf_cg(y, s, key, 16, 20, 100), argnums=(0, 1)))(
        jnp.asarray(yc), jnp.asarray(sigma_np))
    y_t = torch.tensor(yc, requires_grad=True)
    s_t = torch.tensor(sigma_np, requires_grad=True)
    # The probes slq_logdet draws from `key`.
    got = iterative.mvn_logpdf_cg(y_t, s_t, torch.tensor(_probes(3, 16, n)), 20, 100)
    got.backward()
    assert float(got) == pytest.approx(float(ref), rel=0, abs=1e-9)
    np.testing.assert_allclose(y_t.grad.numpy(), np.asarray(ref_dy), rtol=0, atol=1e-9)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(ref_ds), rtol=0, atol=1e-9)
    # d_sigma is the symmetrised estimate.
    np.testing.assert_allclose(s_t.grad.numpy(), s_t.grad.numpy().T, rtol=0, atol=1e-12)


def test_iterative_refuses_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            iterative.batched_cg(torch.eye(3, dtype=F64), torch.ones(3, 1, dtype=F64))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_rademacher_is_seeded_on_the_host():
    a = iterative.rademacher(torch.Generator().manual_seed(5), 16, 100, F32, "cpu")
    b = iterative.rademacher(torch.Generator().manual_seed(5), 16, 100, F32, "cpu")
    assert a.shape == (16, 100) and a.dtype == F32
    assert torch.equal(a, b) and set(a.unique().tolist()) == {-1.0, 1.0}


def _raw_perturbed():
    p = jsimm.init_params(5)
    return jsimm.unconstrain(p._replace(decay=p.decay * jnp.linspace(0.8, 1.3, 5),
                                        lengthscale=jnp.asarray(1.9)))


def test_mll_iterative_and_raw_grads_match_jax(canonical):
    """The p53 rows (kind 'mixed'): value and raw-parameter gradients."""
    (X, y), (tX, ty) = canonical
    key = jax.random.PRNGKey(4)
    jmodel = jsimm.ExactSIMM(num_genes=5, jitter=1e-4)
    tmodel = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    raw = _raw_perturbed()
    ref_v, ref_g = _jit(jax.value_and_grad(
        lambda r: jmodel.mll_iterative(jsimm.constrain(r), X, y, key, 16, 24, 128)))(raw)
    z = torch.tensor(_probes(4, 16, X.shape[0]))  # the probes of `key`
    got_v, got_g = generic.value_and_grad(
        lambda r: tmodel.mll_iterative(simm.constrain(r), tX, ty, z, 24, 128),
        convert.params_from_numpy(_np(raw), device="cpu"))
    assert float(got_v) == pytest.approx(float(ref_v), rel=0, abs=1e-9)
    for name in got_g._fields:
        np.testing.assert_allclose(getattr(got_g, name).numpy(), np.asarray(getattr(ref_g, name)),
                                   rtol=0, atol=1e-9, err_msg=name)


def test_mll_iterative_float32_matches_jax_float32(canonical):
    (X, y), _ = canonical
    key = jax.random.PRNGKey(5)
    X32, y32 = X.astype(jnp.float32), y.astype(jnp.float32)
    p = jax.tree.map(lambda a: a.astype(jnp.float32), jsimm.constrain(_raw_perturbed()))
    ref = _jit(lambda p: jsimm.ExactSIMM(num_genes=5, jitter=1e-4).mll_iterative(
        p, X32, y32, key, 16, 24, 128))(p)
    assert ref.dtype == jnp.float32
    z = torch.tensor(np.asarray(jax.random.rademacher(key, (16, X.shape[0])).astype(jnp.float32)))
    got = simm.ExactSIMM(num_genes=5, jitter=1e-4).mll_iterative(
        convert.params_from_numpy(_np(p), device="cpu", dtype=F32),
        torch.tensor(np.asarray(X32)), torch.tensor(np.asarray(y32)), z, 24, 128)
    assert got.dtype == F32
    assert float(got) == pytest.approx(float(ref), rel=1e-4)


def _jax_cg_route(X, y, G, seed, steps):
    """The JAX package's CG training loop (dis_project_tpu/main.py:1256-1279)
    on its own data, compiled at the fast level."""
    model = jsimm.ExactSIMM(num_genes=G, jitter=1e-4, canonical_rows=True)
    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(0.01))

    def fit_cg(raw):
        opt_state = optimizer.init(raw)

        def step(carry, key):
            raw, opt_state = carry
            loss, grads = jax.value_and_grad(
                lambda r: -model.mll_iterative(jsimm.constrain(r), X, y, key, num_probes=16,
                                               lanczos_iters=24, cg_iters=128))(raw)
            updates, opt_state = optimizer.update(grads, opt_state)
            return (optax.apply_updates(raw, updates), opt_state), loss

        keys = jax.random.split(jax.random.PRNGKey(seed + 1), steps)
        (raw, _), hist = jax.lax.scan(step, (raw, opt_state), keys)
        return raw, hist

    return _jit(fit_cg)(jsimm.unconstrain(jsimm.init_params(G)))


def test_dense_cg_route_matches_jax():
    """The dense route's CG engine at 10 genes x 40 times, 5 steps: the JAX
    route's per-step losses and trained decays, with JAX's data and
    per-step probes (``split(PRNGKey(seed + 1), n)``) fed to the port's
    loop (``main.fit_cg``)."""
    seed, G, T, steps = 0, 10, 40, 5
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1, noise_std=0.1)
    X, y, _ = jtrain_arrays(jsynth.sample_prior(jax.random.PRNGKey(seed), scfg))
    ref_raw, ref_hist = _jax_cg_route(X, y, G, seed, steps)
    tX, ty, _ = convert.arrays_from_numpy(X, y, y, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), steps)
    probes = [torch.tensor(np.asarray(jax.random.rademacher(k, (tmain.CG_PROBES, G * T)).astype(
        jnp.float64))) for k in keys]
    model = simm.ExactSIMM(num_genes=G, jitter=1e-4, canonical_rows=True)
    raw0 = simm.unconstrain(simm.init_params(G))
    raw, _, losses, stats, _ = tmain.fit_cg(model, raw0, tX, ty, steps, 0.01, probes.__getitem__)
    np.testing.assert_allclose(losses, np.asarray(ref_hist), rtol=1e-8)
    assert len(stats) == steps and all(0 < s["cg_iters"] <= tmain.CG_MAX_ITERS for s in stats)
    np.testing.assert_allclose(raw.decay.numpy(), np.asarray(ref_raw.decay), rtol=1e-8)


def test_cli_dense_cg_route_on_cpu(capsys):
    out = tmain.main(["--preset", "dense10k", "--mll-engine", "cg", "--device", "cpu",
                      "--no-x64", "--synth-genes", "4", "--synth-timepoints", "12",
                      "--num-iters", "3"])
    assert out.X.dtype == F32 and len(out.cg_stats) == 3
    assert np.all(np.isfinite(out.result.history.numpy()))
    assert float(out.result.grad_norms.abs().sum()) == 0.0
    with torch.no_grad():
        exact = -float(out.model.mll(out.result.params, out.X, out.y))
    assert out.final_loss == pytest.approx(exact, rel=1e-6)
    assert "CG iterations per step" in capsys.readouterr().out
