"""The PyTorch port's exact-SIMM slice held to the JAX package on the CPU.

Data, parameters and the (JAX-made) random draws go from numpy into both
packages (``dis_project_tpu_torch.convert``); the port runs with
``device="cpu"``, where every kernel wrapper takes its plain version. f64
throughout, as the JAX package's own parity tests run. The CUDA kernels are
held to these plain versions on the card by ``chip_smoke.py``.
"""

import ast
import pathlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.data import barenco as jbarenco
from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.data.dataset import P53Data as JP53Data
from dis_project_tpu.data.dataset import train_arrays as jtrain_arrays
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import gram as jgram
from dis_project_tpu.training import generic as jgeneric
from dis_project_tpu.training import trainer as jtr
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import barenco as tbarenco
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.data.dataset import P53Data, dataset_3d, train_arrays
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import gram as tgram
from dis_project_tpu_torch.ops import precision
from dis_project_tpu_torch.training import generic
from dis_project_tpu_torch.training import trainer as tr
from dis_project_tpu_torch.utils import test_grids

REPO = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _port_params(jparams):
    return convert.params_from_numpy(_np(jparams), device="cpu")


def _assert_tree_close(got, ref, rtol, atol=0.0):
    for name in got._fields:
        np.testing.assert_allclose(
            getattr(got, name).detach().numpy(), np.asarray(getattr(ref, name)),
            rtol=rtol, atol=atol, err_msg=name,
        )


@pytest.fixture(scope="module")
def canonical():
    """Replicate 0 of the seed-0 synthetic Barenco data, in both packages."""
    jdata = JP53Data(replicate=0, source="synthetic", seed=0)
    X, y, var = jtrain_arrays(jdata)
    tX, ty, tvar = convert.arrays_from_numpy(X, y, var, device="cpu")
    return jdata, (X, y, var), (tX, ty, tvar)


def _perturbed(seed=0):
    rng = np.random.default_rng(seed)
    p = jsimm.init_params(5)
    return p._replace(
        basal=p.basal + 0.02 * jnp.asarray(rng.uniform(size=5)),
        sensitivity=p.sensitivity * jnp.asarray(rng.uniform(0.8, 1.2, 5)),
        decay=p.decay * jnp.asarray(rng.uniform(0.7, 1.5, 5)),
        lengthscale=jnp.asarray(1.7),
        obs_stddev=jnp.asarray(0.3),
    )


# ---------------------------------------------------------------------------
# The port stands alone.
# ---------------------------------------------------------------------------

PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "dis_project_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_port_file_imports_neither_jax_nor_the_jax_package(relpath):
    tree = ast.parse((REPO / relpath).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "dis_project_tpu", "optax"), (
                f"{relpath} imports {name}"
            )


ENTRY_POINTS = (
    "arrays_from_numpy", "cli", "dataset_3d", "expression_grid", "fit_and_predict",
    "latent_grid", "params_from_numpy", "run", "run_alfi_parity", "run_dense",
    "run_dense_cg", "sample_prior", "train_arrays",
)


def _entry_points():
    cfg = tmain.cfg
    data = P53Data(replicate=0, source="synthetic")
    return {
        "dataset_3d": lambda: dataset_3d(data),
        "train_arrays": lambda: train_arrays(data),
        "latent_grid": lambda: test_grids.latent_grid(),
        "expression_grid": lambda: test_grids.expression_grid(5),
        "sample_prior": lambda: tsynth.sample_prior(torch.Generator().manual_seed(0)),
        "params_from_numpy": lambda: convert.params_from_numpy(
            _np(jsimm.init_params(5))),
        "arrays_from_numpy": lambda: convert.arrays_from_numpy(
            np.zeros((2, 3)), np.zeros(2), np.zeros(2)),
        "run": lambda: tmain.run(cfg.RunConfig(num_iters=1)),
        "fit_and_predict": lambda: tmain.fit_and_predict(cfg.RunConfig(num_iters=1)),
        "run_alfi_parity": lambda: tmain.run_alfi_parity(cfg.RunConfig(
            preset="alfi-parity", num_iters=1)),
        "run_dense": lambda: tmain.run_dense(cfg.RunConfig(
            preset="dense10k", synth_genes=2, synth_timepoints=3, num_iters=1)),
        "run_dense_cg": lambda: tmain.run_dense(cfg.RunConfig(
            preset="dense10k", synth_genes=2, synth_timepoints=3, num_iters=1,
            mll_engine="cg")),
        "cli": lambda: tmain.main(["--num-iters", "1"]),
    }


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_raises_without_a_card(entry):
    """Entry points default to the card; without one, and without
    device='cpu', they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    calls = _entry_points()
    assert sorted(calls) == sorted(ENTRY_POINTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_precision_pins_full_fp32_matmuls():
    precision.default_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------


def test_barenco_synthetic_bit_identical():
    ref, got = jbarenco.synthetic(seed=0), tbarenco.synthetic(seed=0)
    assert got["gene_names"] == ref["gene_names"]
    for key in ("gene_expressions", "gene_variances", "p53_expressions", "p53_variances"):
        np.testing.assert_array_equal(got[key], ref[key])


def test_barenco_csv_pipeline_identical():
    ref = jbarenco.load_csv(str(REPO / "tests" / "fixtures"))
    got = tbarenco.load_csv(str(REPO / "tests" / "fixtures"))
    for key in ("gene_expressions", "gene_variances", "p53_expressions", "p53_variances"):
        np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("replicate", [0, None])
def test_train_arrays_identical(replicate):
    ref = jtrain_arrays(JP53Data(replicate=replicate, source="synthetic"))
    got = train_arrays(P53Data(replicate=replicate, source="synthetic"), "cpu")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_gene_subset_validation():
    with pytest.raises(ValueError, match="Invalid gene names"):
        P53Data(selected_genes=["FAKE"], source="synthetic")
    data = P53Data(selected_genes=["p21", "DDB2"], source="synthetic")
    assert data.gene_names == ["DDB2", "p21"]


def test_bijectors_match_jax():
    raw = jsimm.unconstrain(_perturbed())
    ref_c = jsimm.constrain(raw)
    got_c = simm.constrain(_port_params(raw))
    _assert_tree_close(got_c, ref_c, rtol=1e-15, atol=1e-15)
    _assert_tree_close(simm.unconstrain(got_c), raw, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# Model: MLL, gradients, predictions (f64, 1e-10 / 1e-8).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["init", "perturbed"])
@pytest.mark.parametrize("canonical_rows", [False, True])
def test_mll_and_raw_grads_match_jax(canonical, which, canonical_rows):
    _, (X, y, _), (tX, ty, _) = canonical
    p = jsimm.init_params(5) if which == "init" else _perturbed()
    jmodel = jsimm.ExactSIMM(num_genes=5, jitter=1e-4, canonical_rows=canonical_rows)
    tmodel = simm.ExactSIMM(num_genes=5, jitter=1e-4, canonical_rows=canonical_rows)
    raw = jsimm.unconstrain(p)
    ref_v, ref_g = jax.jit(jax.value_and_grad(
        lambda r: jmodel.mll(jsimm.constrain(r), X, y)))(raw)
    got_v, got_g = generic.value_and_grad(
        lambda r: tmodel.mll(simm.constrain(r), tX, ty), _port_params(raw))
    assert float(got_v) == pytest.approx(float(ref_v), rel=1e-10)
    _assert_tree_close(got_g, ref_g, rtol=1e-10, atol=1e-12)


def test_mll_replicated_matches_jax():
    """All three replicates through the Kronecker route, value and grads."""
    jdata = JP53Data(replicate=None, source="synthetic")
    _, y, _ = jtrain_arrays(jdata)
    t = jnp.asarray(jdata.timepoints)
    jmodel = jsimm.ExactSIMM(num_genes=5, jitter=1e-4)
    tmodel = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    raw = jsimm.unconstrain(_perturbed(1))
    ref_v, ref_g = jax.jit(jax.value_and_grad(
        lambda r: jmodel.mll_replicated(jsimm.constrain(r), t, y, 3)))(raw)
    ty, tt = torch.as_tensor(np.asarray(y)), torch.as_tensor(np.asarray(t))
    got_v, got_g = generic.value_and_grad(
        lambda r: tmodel.mll_replicated(simm.constrain(r), tt, ty, 3), _port_params(raw))
    assert float(got_v) == pytest.approx(float(ref_v), rel=1e-10)
    _assert_tree_close(got_g, ref_g, rtol=1e-10, atol=1e-12)


def test_table_gram_matches_jax_and_guards_grid():
    t = np.linspace(0.0, 12.0, 9)
    d, s = np.linspace(0.3, 0.9, 4), np.linspace(0.6, 1.4, 4)
    ref = jgram.gram_xx_blocked_fast(jnp.asarray(t), jnp.asarray(d), jnp.asarray(s), 2.1)
    got = tgram.gram_xx_blocked_fast(*(torch.as_tensor(a) for a in (t, d, s)),
                                     torch.tensor(2.1, dtype=F64))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    assert tgram.is_uniform_grid(np.linspace(0, 12, 200, dtype=np.float32))
    irregular = torch.tensor([0.0, 1.0, 3.0], dtype=F64)
    assert not tgram.is_uniform_grid(irregular)
    with pytest.raises(ValueError, match="UNIFORM"):
        tgram.gram_xx_blocked_fast(irregular, *(torch.as_tensor(a[:1]) for a in (d, s)),
                                   torch.tensor(2.1, dtype=F64))


def test_latent_predict_matches_jax(canonical):
    _, (X, y, var), (tX, ty, tvar) = canonical
    p = _perturbed(2)
    jmodel = jsimm.ExactSIMM(num_genes=5, jitter=1e-4)
    tmodel = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    rows = np.stack([np.linspace(0, 13, 40), -np.ones(40), np.zeros(40)], -1)
    ref = jax.jit(lambda p: jmodel.latent_predict(p, jnp.asarray(rows), X, y, var))(p)
    got = tmodel.latent_predict(_port_params(p), torch.as_tensor(rows), tX, ty, tvar)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(ref.cov), rtol=1e-8, atol=1e-10)


def test_multi_gene_predict_matches_jax(canonical):
    _, (X, y, var), (tX, ty, tvar) = canonical
    p = _perturbed(3)
    jmodel = jsimm.ExactSIMM(num_genes=5, jitter=1e-4)
    tmodel = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    rows = np.asarray(jnp.stack([jnp.tile(jnp.linspace(0, 13, 20), 5),
                                 jnp.repeat(jnp.arange(5.0), 20), jnp.zeros(100)], -1))
    ref = jax.jit(lambda p: jmodel.multi_gene_predict(p, jnp.asarray(rows), X, y, var))(p)
    got = tmodel.multi_gene_predict(_port_params(p), torch.as_tensor(rows), tX, ty, tvar)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(ref.cov), rtol=1e-8, atol=1e-10)


def test_legacy_block_mean_and_shared_kinetics_match_jax(canonical):
    _, (X, _, _), (tX, _, _) = canonical
    p = _perturbed(4)
    for kw in ({"legacy_block_mean": True}, {"shared_kinetics": True}):
        jp = p if not kw.get("shared_kinetics") else p._replace(
            basal=p.basal[:1], sensitivity=p.sensitivity[:1], decay=p.decay[:1])
        ref = jsimm.ExactSIMM(num_genes=5, **kw).mean_function(jp, X)
        got = simm.ExactSIMM(num_genes=5, **kw).mean_function(_port_params(jp), tX)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14)


def test_clamp_params_sets_and_refuses_out_of_bounds():
    p = simm.init_params(5)
    c = simm.clamp_params(p, gene_index=3, sensitivity=1.0, decay=0.8)
    assert float(c.sensitivity[3]) == 1.0 and float(c.decay[3]) == 0.8
    assert float(p.decay[3]) == 0.4  # the input is not modified
    with pytest.raises(ValueError, match="out of bounds"):
        simm.clamp_params(simm.init_params(5, shared_kinetics=True))


# ---------------------------------------------------------------------------
# Training: Adam steps, the guard, the goldens.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gridded", [False, True])
def test_adam_steps_match_jax_fit(canonical, gridded):
    """Five steps with the step-0 raw clamp: history and gradient norms at
    rel 1e-9, trained parameters at 1e-9."""
    jdata, (X, y, _), (tX, ty, _) = canonical
    grid = (jdata.timepoints, 1) if gridded else None
    cfg_kw = dict(num_iters=5)
    ref = jtr.fit(jsimm.ExactSIMM(num_genes=5, jitter=1e-4), jsimm.init_params(5),
                  X, y, jtr.TrainConfig(**cfg_kw), gridded=grid)
    got = tr.fit(simm.ExactSIMM(num_genes=5, jitter=1e-4), simm.init_params(5),
                 tX, ty, tr.TrainConfig(**cfg_kw),
                 gridded=(np.asarray(jdata.timepoints), 1) if gridded else None)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-9)
    np.testing.assert_allclose(got.grad_norms.numpy(), np.asarray(ref.grad_norms), rtol=1e-9)
    _assert_tree_close(got.params, ref.params, rtol=1e-9)


class _P(NamedTuple):
    x: torch.Tensor


def _pocket_loss(lib, where):
    def loss(x):
        val = (x - 5.0) ** 2
        return where((x > 2.3) & (x < 2.6), lib.nan, val).sum()
    return loss


def test_finite_guard_matches_jax_fit_loop():
    """A NaN pocket on the path: the backtrack-and-rescale ladder takes the
    same steps as the JAX guard (losses, guard events, final point)."""
    ref = jgeneric.fit_loop(_pocket_loss(jnp, jnp.where), jnp.zeros(()),
                            num_iters=60, learning_rate=0.5)
    loss_t = _pocket_loss(torch, lambda c, a, b: torch.where(c, torch.tensor(a, dtype=F64), b))
    opt = generic.Adam(0.5)
    raw = _P(torch.zeros((), dtype=F64))
    state = opt.init(raw)
    good, streak, count = (raw, state), 0, 0
    hist, flags = [], []
    for _ in range(60):
        raw, state, good, streak, count, loss, _, fired = generic.guarded_transition(
            lambda r: generic.value_and_grad(lambda p: loss_t(p.x), r),
            opt.update, raw, state, good, streak, count)
        hist.append(float(loss))
        flags.append(fired)
    assert ref.guard_count >= 1 and sum(flags) == ref.guard_count
    np.testing.assert_array_equal(np.asarray(flags), np.asarray(ref.guard_flags))
    np.testing.assert_allclose(hist, np.asarray(ref.history), rtol=1e-12)
    assert float(raw.x) == pytest.approx(float(ref.raw), rel=1e-12)


def test_finite_guard_freezes_on_nonfinite_start():
    opt = generic.Adam(0.5)
    raw = _P(torch.zeros((), dtype=F64))
    state = opt.init(raw)
    good, streak, count = (raw, state), 0, 0

    def vg(r):
        return generic.value_and_grad(lambda p: torch.where(
            p.x < 100.0, torch.tensor(float("nan"), dtype=F64), (p.x - 100.0) ** 2), r)

    for _ in range(5):
        raw, state, good, streak, count, loss, _, fired = generic.guarded_transition(
            vg, opt.update, raw, state, good, streak, count)
        assert fired and not torch.isfinite(loss)
    assert count == 5 and float(raw.x) == 0.0


@pytest.fixture(scope="module")
def golden_fit(canonical):
    _, _, (tX, ty, tvar) = canonical
    model = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    return model, tr.fit(model, simm.init_params(5), tX, ty, tr.TrainConfig())


class TestGoldenValues:
    """tests/test_golden.py's four values from the port's own fit (CPU f64,
    the golden tolerances)."""

    def test_mll_at_reference_init(self, canonical):
        _, _, (tX, ty, _) = canonical
        got = float(simm.ExactSIMM(num_genes=5, jitter=1e-4).mll(simm.init_params(5), tX, ty))
        assert got == pytest.approx(-43.69118241179048, abs=1e-8)

    def test_canonical_training_final_loss(self, golden_fit):
        assert float(golden_fit[1].history[-1]) == pytest.approx(4.810708070243, abs=1e-6)
        assert golden_fit[1].guard_count == 0

    def test_trained_kinetics(self, golden_fit):
        params = golden_fit[1].params
        np.testing.assert_allclose(
            params.decay.numpy(),
            [0.31840186, 0.41880947, 0.36782237, 0.8, 0.36906359], atol=2e-4,
        )
        assert float(params.sensitivity[3]) == 1.0
        assert float(params.decay[3]) == pytest.approx(0.8)

    def test_latent_posterior_golden_probe(self, canonical, golden_fit):
        _, _, (tX, ty, tvar) = canonical
        model, res = golden_fit
        rows = torch.tensor([[2.0, -1.0, 0.0], [6.0, -1.0, 0.0], [11.0, -1.0, 0.0]],
                            dtype=F64)
        post = model.latent_predict(res.params, rows, tX, ty, tvar)
        np.testing.assert_allclose(post.mean.numpy(), [1.34483514, 1.31897536, 0.1286597],
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# The dense route at a small size (G=4, T=12).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_dense():
    cfg_kw = dict(num_genes=4, num_timepoints=12, num_replicates=2)
    jcfg = jsynth.SyntheticConfig(**cfg_kw)
    key = jax.random.PRNGKey(3)
    ranges = (jcfg.basal_range, jcfg.sensitivity_range, jcfg.decay_range)
    draws = jsynth._prior_rng(key, 4, 48, 2, ranges, jnp.float64)
    ref = jsynth.sample_prior(key, jcfg, dtype=jnp.float64)
    got = tsynth.prior_from_draws(*(np.asarray(a) for a in draws),
                                  tsynth.SyntheticConfig(**cfg_kw))
    return ref, got


def test_small_dense_prior_matches_jax(small_dense):
    """The prior draw from the same (JAX-made) random numbers: data and
    generating force to 1e-9 (two f64 Cholesky/solve routes)."""
    ref, got = small_dense
    np.testing.assert_allclose(got.timepoints.numpy(), np.asarray(ref.timepoints), rtol=1e-15)
    np.testing.assert_allclose(got.gene_expressions.numpy(),
                               np.asarray(ref.gene_expressions), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.f_true.numpy(), np.asarray(ref.f_true), rtol=1e-9, atol=1e-9)
    for g, r in zip(got.params_ground_truth(), ref.params_ground_truth()):
        np.testing.assert_array_equal(g, r)


def test_small_dense_mll_matches_jax_xla(small_dense):
    """The dense route's row-path MLL (canonical_rows, kind 'xx') vs the
    JAX gram_impl='xla' MLL: value and raw gradients at 1e-10."""
    ref_data, got_data = small_dense
    X, y, _ = jtrain_arrays(ref_data)
    tX, ty, _ = train_arrays(got_data, "cpu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-9, atol=1e-9)
    ty = torch.as_tensor(np.asarray(y))  # identical observations on both sides
    jmodel = jsimm.ExactSIMM(num_genes=4, jitter=1e-4, canonical_rows=True, gram_impl="xla")
    tmodel = simm.ExactSIMM(num_genes=4, jitter=1e-4, canonical_rows=True)
    raw = jsimm.unconstrain(jsimm.init_params(4))
    ref_v, ref_g = jax.jit(jax.value_and_grad(
        lambda r: jmodel.mll(jsimm.constrain(r), X, y)))(raw)
    got_v, got_g = generic.value_and_grad(
        lambda r: tmodel.mll(simm.constrain(r), tX, ty), _port_params(raw))
    assert float(got_v) == pytest.approx(float(ref_v), rel=1e-10)
    _assert_tree_close(got_g, ref_g, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


def test_cli_canonical_route_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the route writes hyperparams.csv to the cwd
    out = tmain.main(["--device", "cpu", "--num-iters", "3"])
    assert out.result.history.shape == (3,)
    assert out.latent.mean.shape == (100,) and out.expression.cov.shape == (500, 500)
    assert torch.isfinite(out.latent.cov).all() and torch.isfinite(out.expression.mean).all()
    assert (tmp_path / "hyperparams.csv").read_text().startswith("Gene Name")


def test_cli_dense_route_on_cpu():
    out = tmain.main(["--preset", "dense10k", "--device", "cpu", "--no-x64",
                      "--synth-genes", "3", "--synth-timepoints", "10", "--num-iters", "3"])
    assert out.X.shape == (30, 3) and out.X.dtype == torch.float32
    hist = out.result.history.numpy()
    assert np.all(np.isfinite(hist)) and hist[-1] < hist[0]


@pytest.mark.parametrize("argv", [
    # The sparse100k routes are ported; their data-parallel SVI is not.
    pytest.param(["--model", "simm2", "--preset", "sparse100k", "--dp-shard"],
                 id="--model simm2"),
    ["--preset", "dense10k", "--mll-engine", "dist"],
    ["--preset", "sparse100k", "--dp-shard"],
    ["--preset", "p53-replicates", "--ensemble"],
])
def test_cli_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        tmain.main(argv + ["--device", "cpu"])


def test_cli_replicates_posterior_reaches_the_sampler(tmp_path, monkeypatch):
    """``--preset p53-replicates --posterior-samples 5 --posterior-chains
    2``: the route samples all three replicates' kinetics (N = 105) on two
    chains, with JAX's arguments (24 leapfrog steps, --seed + 7)."""
    from test_torch_port_hmc_routes import sampler_call

    monkeypatch.chdir(tmp_path)
    seen = sampler_call(monkeypatch, ["--preset", "p53-replicates", "--posterior-samples", "5",
                                      "--posterior-chains", "2", "--num-iters", "2"])
    assert seen["num_warmup"] == seen["num_samples"] == 5
    assert (seen["num_leapfrog"], seen["num_chains"], seen["seed"]) == (24, 2, 7)
