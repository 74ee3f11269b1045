"""The port's sparse100k route held to the JAX package's on the CPU, in
float64: the first-order quadrature generator (``data/synthetic.py``
``ode_from_draws`` on JAX's draws), the SVI trainer
(``training/svtrainer.py``: its shuffle tables, ``fit`` on JAX's tables in
the three variants, the frozen-z optimizer, a JAX state continued through
``convert.py``, ``fit_checkpointed``'s resume), ``main.run_sparse`` against
JAX's ``run_sparse`` through the same seams, and the CLI guards with JAX's
messages.

Tolerances: the generator 1e-12 x max(1, max|ref|); trajectories (the
per-step negative ELBO, the metrics file and every final raw leaf) rel 1e-9,
leaves as 1e-9 x max(1, max|ref|); resumed runs bitwise. JAX's routes are
compiled at XLA's lowest CPU optimisation level (``jax.jit`` patched, optax
imported first: its jits nest in the routes' programs).
"""

import functools
import json

import jax
import jax.numpy as jnp
from jax._src import core as jax_core
import numpy as np
import pytest
import torch

from dis_project_tpu import config as jcfg
from dis_project_tpu import main as jmain
from dis_project_tpu.data import synthetic as jsynth
from dis_project_tpu.data.dataset import train_arrays as jtrain_arrays
from dis_project_tpu.models import svlfm as jsv
from dis_project_tpu.training import svtrainer as jsvt
from dis_project_tpu_torch import convert
from dis_project_tpu_torch import main as tmain
from dis_project_tpu_torch.data import synthetic as tsynth
from dis_project_tpu_torch.models import svlfm
from dis_project_tpu_torch.training import svtrainer

F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# The toy route: 5 x 20 = 100 rows, M = 8, batches of 32 (4 a epoch, the
# last wrapping), 2 epochs.
TOY = ["--preset", "sparse100k", "--synth-genes", "5", "--synth-timepoints", "20",
       "--num-inducing", "8", "--batch-size", "32", "--num-epochs", "2"]
G, T, M, BS, EPOCHS = 5, 20, 8, 32, 2
MODELS = ("simm", "simm2", "multisimm")


@pytest.fixture(scope="module")
def fast_jit():
    """Every ``jax.jit`` compiles at XLA's lowest CPU optimisation level
    while the module's JAX references run."""
    import optax  # noqa: F401

    mp = pytest.MonkeyPatch()
    real = jax.jit

    def jit(fun=None, **kw):
        if fun is None:
            return functools.partial(jit, **kw)
        if not jax_core.trace_state_clean():  # a nested jit takes no compiler options
            return real(fun, **kw)
        return real(fun, compiler_options=FAST_COMPILE, **kw)

    mp.setattr(jax, "jit", jit)
    yield
    mp.undo()


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, ref, tol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    assert err <= tol * scale, f"{what}: max abs error {err:.3e} > {tol * scale:.3e}"


def _raw_close(got_raw, ref_raw, tol, what):
    """Every leaf of the port's raw SVLFMParams against JAX's."""
    got = svtrainer.flatten(got_raw)
    ref = [np.asarray(v) for v in jax.tree.leaves(ref_raw)]
    assert len(got) == len(ref)
    for g, r, name in zip(got, ref, got._fields):
        _close(g, r, tol, f"{what} raw {name}")


def jax_tables(seed, epoch, n, bs):
    """JAX's fit's (batches, bs) table of absolute epoch ``epoch``."""
    bs = min(bs, n)
    batches = -(-n // bs)
    perm = jax.random.permutation(jax.random.fold_in(jax.random.PRNGKey(seed), epoch), n)
    perm = jnp.concatenate([perm, perm[: batches * bs - n]])
    return torch.as_tensor(np.array(perm.reshape(batches, bs)), dtype=torch.long)


def _port_data(jdata):
    """JAX's SyntheticLFMData as the port's, on the CPU in float64."""
    return tsynth.SyntheticLFMData(
        _t(jdata.timepoints), _t(jdata.gene_expressions), _t(jdata.gene_variances),
        {k: _t(v) for k, v in jdata.params_true.items()}, _t(jdata.f_true))


def _jax_data(model, seed=0):
    """The data JAX's run_sparse draws for ``model`` at the toy shape."""
    scfg = jsynth.SyntheticConfig(num_genes=G, num_timepoints=T, num_replicates=1,
                                  noise_std=0.1)
    key = jax.random.PRNGKey(seed)
    if model == "multisimm":
        return jsynth.generate_ode_multi(key, scfg, num_forces=2, oversample=4)
    if model == "simm2":
        return jsynth.generate_ode2(key, scfg, oversample=4)
    return jsynth.generate_ode(key, scfg, oversample=4)


def _records(path):
    return [json.loads(line) for line in open(path)]


# ---------------------------------------------------------------------------
# generate_ode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("oversample, response", [(4, None), (16, None), (4, "exp")])
def test_ode_from_draws_matches_generate_ode(oversample, response):
    """``ode_from_draws`` on JAX's draws (split kp, kf, kn) equals JAX's
    ``generate_ode`` (1e-12); with ``response=np.exp`` it equals
    ``generate_ode_nonlinear(response='exp')``, the seam of the nonlinear
    generator."""
    cfg = jsynth.SyntheticConfig(num_genes=4, num_timepoints=15, num_replicates=2,
                                 noise_std=0.1)
    key = jax.random.PRNGKey(7)
    kp, kf, kn = jax.random.split(key, 3)
    kin = jsynth._sample_kinetics(kp, cfg, jnp.float64)
    n_fine = (cfg.num_timepoints - 1) * oversample + 1
    eps = jax.random.normal(kf, (n_fine,), jnp.float32)
    noise = jax.random.normal(kn, (2, 4, 15), jnp.float32)
    if response is None:
        ref = jsynth.generate_ode(key, cfg, oversample=oversample)
        fn = None
    else:
        ref = jsynth.generate_ode_nonlinear(key, cfg, response=response, oversample=oversample)
        fn = np.exp
    tcfg = tsynth.SyntheticConfig(num_genes=4, num_timepoints=15, num_replicates=2,
                                  noise_std=0.1)
    got = tsynth.ode_from_draws(*(np.asarray(a) for a in (kin["basal"], kin["sensitivity"],
                                                          kin["decay"], eps, noise)),
                                tcfg, oversample, response=fn, dtype=F64, device="cpu")
    for name in ("timepoints", "gene_expressions", "gene_variances", "f_true"):
        _close(getattr(got, name), getattr(ref, name), 1e-12, name)
    for k in ("basal", "sensitivity", "decay", "lengthscale"):
        _close(got.params_true[k], ref.params_true[k], 1e-12, k)
    assert got.num_genes == 4 and got.num_replicates == 2


def test_generate_ode_draws_on_the_cpu_and_runs_where_asked():
    """The port's own draws: a seed gives the same data twice; the data lie
    on the device asked for."""
    cfg = tsynth.SyntheticConfig(num_genes=3, num_timepoints=9, noise_std=0.1)
    a = tsynth.generate_ode(torch.Generator().manual_seed(3), cfg, oversample=4, device="cpu")
    b = tsynth.generate_ode(torch.Generator().manual_seed(3), cfg, oversample=4, device="cpu")
    assert torch.equal(a.gene_expressions, b.gene_expressions)
    assert a.gene_expressions.shape == (1, 3, 9) and a.f_true.shape == (9,)
    assert bool(torch.isfinite(a.gene_expressions).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsynth.generate_ode(torch.Generator().manual_seed(3), cfg)


# ---------------------------------------------------------------------------
# The shuffle tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, bs", [(10, 4), (12, 4), (7, 20), (100, 32)])
def test_epoch_indices_permute_then_wrap(n, bs):
    table = svtrainer.epoch_indices(3, 5, n, bs)
    b = min(bs, n)
    batches = -(-n // b)
    assert table.shape == (batches, b) and table.dtype == torch.long
    flat = table.reshape(-1)
    assert sorted(flat[:n].tolist()) == list(range(n))
    assert torch.equal(flat[n:], flat[: batches * b - n])
    assert torch.equal(table, svtrainer.epoch_indices(3, 5, n, bs))
    others = [svtrainer.epoch_indices(3, e, n, bs) for e in (4, 6)]
    others.append(svtrainer.epoch_indices(4, 5, n, bs))
    assert all(not torch.equal(table, o) for o in others)


# ---------------------------------------------------------------------------
# run_sparse and svtrainer.fit against JAX's, on JAX's data and tables
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_routes(fast_jit, tmp_path_factory):
    """JAX's run_sparse at the toy shape for each model: its result, its
    metrics file, its printed lines and its data."""
    import contextlib
    import io

    out = {}
    for model in MODELS:
        d = tmp_path_factory.mktemp(f"jax_{model}")
        config = jcfg.config_from_args(_jax_parser().parse_args(
            TOY + ["--model", model, "--metrics-path", str(d / "m.jsonl"),
                   "--out-dir", str(d)]))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = jmain.run_sparse(config)
        out[model] = dict(history=np.asarray(res.history), raw=res.raw_params,
                          metrics=_records(d / "m.jsonl"), text=buf.getvalue(),
                          data=_jax_data(model))
    return out


def _jax_parser():
    import argparse

    parser = argparse.ArgumentParser()
    jcfg.add_cli_args(parser)
    return parser


@pytest.fixture
def jax_seams(monkeypatch, jax_routes):
    """The port's data seam and shuffle stream replaced by JAX's."""
    def data(genes, timepoints, order, num_forces, seed, dtype, device):
        model = "multisimm" if num_forces > 1 else "simm2" if order == 2 else "simm"
        return _port_data(jax_routes[model]["data"])

    monkeypatch.setattr(tmain, "synthetic_sparse_data", data)
    monkeypatch.setattr(svtrainer, "epoch_indices", jax_tables)


def _lines(text, start):
    return [line for line in text.splitlines() if line.startswith(start)]


@pytest.mark.parametrize("model", MODELS)
def test_run_sparse_matches_jax(model, jax_routes, jax_seams, tmp_path, capsys):
    """``main.main`` on the toy sparse100k argv on the CPU against JAX's
    ``run_sparse`` on the same data and shuffles: the (2, 4) history, the
    metrics file and the final raw parameters within rel 1e-9, and the same
    recovery lines."""
    ref = jax_routes[model]
    path = tmp_path / "m.jsonl"
    out = tmain.main(TOY + ["--model", model, "--device", "cpu", "--metrics-path", str(path),
                            "--out-dir", str(tmp_path)])
    assert isinstance(out, tmain.SparseRun)
    assert out.history.shape == (EPOCHS, 4)
    np.testing.assert_allclose(out.history, ref["history"], rtol=1e-9)
    got = _records(path)
    assert [sorted(r) for r in got] == [["epoch", "neg_elbo_mean"]] * EPOCHS
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref["metrics"]]
    np.testing.assert_allclose([r["neg_elbo_mean"] for r in got],
                               [r["neg_elbo_mean"] for r in ref["metrics"]], rtol=1e-9)
    _raw_close(out.result.raw_params, ref["raw"], 1e-9, model)
    text = capsys.readouterr().out
    for start in ("Latent force ", "Latent-force recovery correlation", "Sampling",
                  "Training SVI"):
        assert _lines(text, start) == _lines(ref["text"], start), start
    assert len(out.latent) == len(out.corrs) == (2 if model == "multisimm" else 1)


def _fit_args(model, jax_routes):
    """The toy route's model, initial parameters and rows, in the port."""
    data = _port_data(jax_routes[model]["data"])
    from dis_project_tpu_torch.data.dataset import train_arrays

    X, y, var = train_arrays(data, "cpu", F64)
    order = 2 if model == "simm2" else 1
    R = 2 if model == "multisimm" else 1
    sm = svlfm.SparseSIMM(num_genes=G, num_inducing=M, jitter=1e-6, order=order, num_forces=R)
    return sm, svlfm.init_params(G, M, order=order, num_forces=R, dtype=F64), X, y, var


@pytest.mark.parametrize("model", MODELS)
def test_svtrainer_fit_matches_jax_fit(model, jax_routes, monkeypatch):
    """``svtrainer.fit`` called directly (2 epochs of 4 batches) on JAX's
    tables: history and final raw leaves within rel 1e-9 of JAX's ``fit``
    (run inside JAX's route)."""
    monkeypatch.setattr(svtrainer, "epoch_indices", jax_tables)
    sm, params, X, y, var = _fit_args(model, jax_routes)
    res = svtrainer.fit(sm, params, X, y, var,
                        svtrainer.SVTrainConfig(num_epochs=EPOCHS, batch_size=BS, seed=0))
    np.testing.assert_allclose(res.history.numpy(), jax_routes[model]["history"], rtol=1e-9)
    _raw_close(res.raw_params, jax_routes[model]["raw"], 1e-9, model)
    assert res.opt_state.count == EPOCHS * 4


@pytest.fixture(scope="module")
def jax_fits(fast_jit, jax_routes):
    """JAX's fit of the first-order toy problem: 2 epochs with z frozen, and
    1 epoch with and without z frozen (whose states the port continues)."""
    jdata = jax_routes["simm"]["data"]
    X, y, var = jtrain_arrays(jdata)
    model = jsv.SparseSIMM(num_genes=G, num_inducing=M, jitter=1e-6)
    params = jsv.init_params(G, M, dtype=jnp.float64)
    out = {}
    for name, epochs, train_z in (("frozen2", 2, False), ("frozen1", 1, False),
                                  ("trained1", 1, True)):
        res = jsvt.fit(model, params, X, y, var, jsvt.SVTrainConfig(
            num_epochs=epochs, batch_size=BS, seed=0, train_z=train_z))
        out[name] = dict(history=np.asarray(res.history), raw=res.raw_params,
                         state=res.opt_state)
    return out


def test_frozen_z_is_bitwise_unchanged_and_the_rest_matches_jax(jax_routes, jax_fits,
                                                               monkeypatch):
    monkeypatch.setattr(svtrainer, "epoch_indices", jax_tables)
    sm, params, X, y, var = _fit_args("simm", jax_routes)
    res = svtrainer.fit(sm, params, X, y, var, svtrainer.SVTrainConfig(
        num_epochs=EPOCHS, batch_size=BS, seed=0, train_z=False))
    assert torch.equal(res.raw_params.z, params.z) and torch.equal(res.params.z, params.z)
    # z carries no moments.
    assert len(res.opt_state.mu) == len(res.opt_state.nu) == len(svtrainer.flatten(params)) - 1
    np.testing.assert_allclose(res.history.numpy(), jax_fits["frozen2"]["history"], rtol=1e-9)
    _raw_close(res.raw_params, jax_fits["frozen2"]["raw"], 1e-9, "frozen z")


def _jax_adam(state, train_z):
    """optax's Adam state of JAX's SVI optimizer as (count, mu, nu) mappings."""
    adam = (state if train_z else state.inner_states["opt"].inner_state)[0]

    def mapping(tree):
        m = {"kinetics": tree.kinetics._asdict(), "q_mu": tree.q_mu, "q_sqrt": tree.q_sqrt}
        if train_z:
            m["z"] = tree.z
        return m

    return adam.count, mapping(adam.mu), mapping(adam.nu)


@pytest.mark.parametrize("train_z", [True, False], ids=["trained z", "frozen z"])
def test_fit_continues_a_jax_state(train_z, jax_routes, jax_fits, monkeypatch):
    """JAX's state after one epoch (raw parameters and optax's Adam state,
    the frozen-z layout too), carried over by ``convert.py``: one more epoch
    in the port (``epoch_offset=1``) lands on JAX's two-epoch run (rel
    1e-9)."""
    monkeypatch.setattr(svtrainer, "epoch_indices", jax_tables)
    sm, params, X, y, var = _fit_args("simm", jax_routes)
    one = jax_fits["trained1" if train_z else "frozen1"]
    two_raw = jax_routes["simm"]["raw"] if train_z else jax_fits["frozen2"]["raw"]
    two_hist = jax_routes["simm"]["history"] if train_z else jax_fits["frozen2"]["history"]
    raw = one["raw"]
    raw0 = convert.svlfm_params_from_numpy(
        {"kinetics": raw.kinetics._asdict(), "z": raw.z, "q_mu": raw.q_mu,
         "q_sqrt": raw.q_sqrt}, device="cpu")
    state = convert.sv_adam_state_from_numpy(*_jax_adam(one["state"], train_z),
                                             train_z=train_z, device="cpu")
    config = svtrainer.SVTrainConfig(num_epochs=1, batch_size=BS, seed=0, train_z=train_z)
    res = svtrainer.fit(sm, params, X, y, var, config, init_state=(raw0, state), epoch_offset=1)
    np.testing.assert_allclose(res.history.numpy(), two_hist[1:], rtol=1e-9)
    _raw_close(res.raw_params, two_raw, 1e-9, "continued")
    assert res.opt_state.count == 8


@pytest.mark.parametrize("train_z", [True, False], ids=["trained z", "frozen z"])
def test_fit_checkpointed_resume_is_bitwise(train_z, jax_routes, tmp_path):
    """``fit_checkpointed`` every epoch for 2 epochs, then a rerun asking for
    3 that resumes from the epoch-2 checkpoint: bitwise the unsegmented
    3-epoch ``fit`` (the port's own shuffle stream)."""
    sm, params, X, y, var = _fit_args("simm", jax_routes)
    cfg3 = svtrainer.SVTrainConfig(num_epochs=3, batch_size=BS, seed=4, train_z=train_z)
    full = svtrainer.fit(sm, params, X, y, var, cfg3)
    import dataclasses

    first = svtrainer.fit_checkpointed(sm, params, X, y, var,
                                       dataclasses.replace(cfg3, num_epochs=2), str(tmp_path),
                                       checkpoint_every=1)
    assert torch.equal(first.history, full.history[:2])
    resumed = svtrainer.fit_checkpointed(sm, params, X, y, var, cfg3, str(tmp_path),
                                         checkpoint_every=1)
    assert torch.equal(resumed.history, full.history[2:])
    for a, b in zip(svtrainer.flatten(resumed.raw_params), svtrainer.flatten(full.raw_params)):
        assert torch.equal(a, b)
    for a, b in zip(resumed.opt_state.mu + resumed.opt_state.nu,
                    full.opt_state.mu + full.opt_state.nu):
        assert torch.equal(a, b)
    assert resumed.opt_state.count == full.opt_state.count == 12
    done = svtrainer.fit_checkpointed(sm, params, X, y, var, cfg3, str(tmp_path))
    assert done.history.shape == (0, 1)
    for a, b in zip(svtrainer.flatten(done.raw_params), svtrainer.flatten(full.raw_params)):
        assert torch.equal(a, b)


def test_fit_refuses_a_mesh():
    sm, params = svlfm.SparseSIMM(num_genes=2, num_inducing=3), svlfm.init_params(2, 3)
    x = torch.zeros((4, 3), dtype=F64)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        svtrainer.fit(sm, params, x, x[:, 0], x[:, 0], mesh=object())


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


GUARDS = [
    ["--dp-shard"],
    ["--preset", "dense10k", "--dp-shard"],
    ["--preset", "sparse100k", "--mll-engine", "ss"],
    ["--preset", "sparse100k", "--mll-engine", "cg"],
    ["--preset", "sparse100k", "--posterior-samples", "4"],
    ["--preset", "sparse100k", "--model", "delaysimm"],
    ["--preset", "sparse100k", "--model", "nlfm"],
]


@pytest.mark.parametrize("argv", GUARDS, ids=lambda a: " ".join(a))
def test_cli_guards_match_jax(argv):
    """Each of the JAX CLI's refusals around the sparse route, word for word
    (JAX's ``main`` refuses them before it computes anything)."""
    with pytest.raises(SystemExit) as ref:
        jmain.main(argv)
    with pytest.raises(SystemExit) as got:
        tmain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value) and str(ref.value)


def test_cli_refuses_dp_shard_on_the_sparse_route():
    with pytest.raises(SystemExit, match=r"--dp-shard \(data-parallel SVI\) is not yet ported"):
        tmain.main(TOY + ["--dp-shard", "--device", "cpu"])


def test_sparse_route_needs_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the route runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(TOY)


def test_sparse100k_default_shape_is_baseline_config_5():
    import argparse

    from dis_project_tpu_torch import config as cfg

    parser = argparse.ArgumentParser()
    cfg.add_cli_args(parser)
    c = cfg.config_from_args(parser.parse_args(["--preset", "sparse100k"]))
    assert (c.synth_genes, c.synth_timepoints, c.num_inducing, c.batch_size, c.num_epochs) == \
        (100, 1000, 128, 2048, 25)
    assert c.sparse_jitter == 1e-6 and c.exact_jitter == 1e-4
    d = cfg.config_from_args(parser.parse_args(["--preset", "dense10k"]))
    assert (d.synth_genes, d.synth_timepoints) == (50, 200)
