"""The port's sparse variational family (``dis_project_tpu_torch/models/
svlfm.py``) held to the JAX package's ``models/svlfm.py`` on the CPU, in
float64, for order 1, order 2 and R = 2 forces, on one row set that mixes
expression rows (genes 0..G-1), force rows (gene -1, force indices 0 and 1),
a gene index past the last gene and a fractional one.

Tolerances: ``init_params``, ``constrain`` and ``unconstrain`` 1e-12;
``mean_function``, ``_luu`` (also the float32 jitter floor), ``_proj``,
``_prior_var`` and ``_marginals`` 1e-12 x max(1, max|ref|); ``kl``,
``elbo`` (with an ``n_total`` scale), ``collapsed_elbo`` and ``optimal_q``
rel 1e-10; the raw gradients of ``elbo`` and ``collapsed_elbo`` (every
leaf, z and q_sqrt included) 1e-9 x max(1, max|ref|); the predictions
1e-10 x max(1, max|ref|); the float32 ``elbo`` rel 1e-4 of JAX's float32.
The JAX references are one program per variant, compiled at XLA's lowest
CPU optimisation level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.models import multisimm as jmulti
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.models import simm2 as jsimm2
from dis_project_tpu.models import svlfm as jsv
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.models import svlfm
from dis_project_tpu_torch.training import svtrainer

F64, F32 = torch.float64, torch.float32
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
VARIANTS = ("order1", "order2", "forces2")
G, M, N_TOTAL = 3, 6, 1000
# float32 factors of Kuu + 1e-4 I (condition up to ~1e4 at these z).
LUU32_TOL = 1e-5
SPEC = {"order1": (1, 1), "order2": (2, 1), "forces2": (1, 2)}  # (order, num_forces)


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _close(got, ref, tol, what, rel_to_max=True):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    peak = float(np.abs(ref).max())
    scale = max(1.0, peak) if rel_to_max else max(1e-300, peak)
    assert err <= tol * scale, f"{what}: max abs error {err:.3e} > {tol * scale:.3e}"


def _rel(got, ref, tol, what):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= tol * abs(ref), f"{what}: {got!r} vs {ref!r}"


def _rows(rng, R):
    """Mixed (t, gene, flag) rows: expression rows of every gene, force rows
    (gene -1 and, for R forces, each force index), a gene past the last
    (clipped) and a fractional gene index (truncated)."""
    t = np.linspace(0.0, 12.0, 7)
    expr = np.stack([np.tile(t, G), np.repeat(np.arange(G), 7).astype(float),
                     np.ones(7 * G)], axis=1)
    tf = rng.uniform(0.0, 13.0, 5)
    force = [np.stack([tf, np.full(5, -1.0), np.zeros(5)], axis=1)]
    force += [np.stack([tf + 0.3 * r, np.full(5, float(r)), np.zeros(5)], axis=1)
              for r in range(R)]
    odd = np.array([[5.5, float(G + 2), 1.0], [7.25, 1.7, 1.0], [2.0, 1.7, 0.0]])
    return np.concatenate([expr, *force, odd])


def _problem(variant):
    """Kinetics in the bijectors' support, perturbed inducing times, a random
    whitened mean and lower-triangular square root, the mixed rows with
    targets and per-point variances."""
    order, R = SPEC[variant]
    rng = np.random.default_rng({"order1": 1, "order2": 2, "forces2": 3}[variant])
    if R > 1:
        kin = dict(basal=rng.uniform(0.02, 0.1, G), sensitivity=rng.uniform(0.4, 1.4, (G, R)),
                   decay=rng.uniform(0.3, 1.2, G), lengthscale=np.array([1.3, 2.7]),
                   obs_stddev=np.array(0.3))
    elif order == 2:
        kin = dict(basal=rng.uniform(0.02, 0.1, G), sensitivity=rng.uniform(0.4, 1.4, G),
                   alpha=rng.uniform(0.3, 0.8, G), omega=rng.uniform(0.6, 1.4, G),
                   lengthscale=np.array(1.8), obs_stddev=np.array(0.3))
    else:
        kin = dict(basal=rng.uniform(0.02, 0.1, G), sensitivity=rng.uniform(0.4, 1.4, G),
                   decay=rng.uniform(0.3, 1.2, G), lengthscale=np.array(2.2),
                   obs_stddev=np.array(0.3))
    mr = M * R
    q_sqrt = np.tril(rng.normal(scale=0.3, size=(mr, mr)), -1) + np.diag(
        rng.uniform(0.3, 1.0, mr))
    p = dict(kinetics=kin, z=np.linspace(0.0, 12.0, M) + rng.uniform(-0.4, 0.4, M),
             q_mu=rng.normal(size=mr), q_sqrt=q_sqrt)
    X = _rows(rng, R)
    y = rng.normal(size=len(X))
    var = rng.uniform(1e-3, 1e-2, len(X))
    return p, X, y, var


def _jax_params(p, order, R, dtype=jnp.float64):
    kin = {k: jnp.asarray(v, dtype) for k, v in p["kinetics"].items()}
    cls = jmulti.MultiSIMMParams if R > 1 else jsimm2.SIMM2Params if order == 2 else \
        jsimm.SIMMParams
    return jsv.SVLFMParams(cls(**kin), *(jnp.asarray(p[f], dtype) for f in ("z", "q_mu", "q_sqrt")))


def _jmodel(variant, jitter=1e-6):
    order, R = SPEC[variant]
    return jsv.SparseSIMM(num_genes=G, num_inducing=M, jitter=jitter, order=order, num_forces=R)


def _model(variant, jitter=1e-6):
    order, R = SPEC[variant]
    return svlfm.SparseSIMM(num_genes=G, num_inducing=M, jitter=jitter, order=order,
                            num_forces=R)


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of one variant in one compiled program, float64,
    plus the float32 ELBO and the non-PD ELBO."""
    out = {}
    for variant in VARIANTS:
        order, R = SPEC[variant]
        p, X, y, var = _problem(variant)
        jm = _jmodel(variant)

        def program(jp, X, y, var, X32, y32, var32, jp32):
            raw = jsv.unconstrain(jp)
            luu = jm._luu(jp)
            lat = [jm.latent_predict(jp, jnp.linspace(0.0, 13.0, 9), force=r) for r in range(R)]
            gene = jm.gene_predict(jp, X[:G * 7])
            opt = jm.optimal_q(jp, X, y, var)
            nonpd = _jmodel(variant, jitter=-1.0)
            return dict(
                init=jsv.init_params(G, M, t_max=12.0, dtype=jnp.float64, order=order,
                                     num_forces=R),
                raw=raw, constrained=jsv.constrain(raw),
                mean_fn=jm.mean_function(jp, X), luu=luu,
                luu32=jm._luu(jp32), proj=jm._proj(jp, luu, X),
                prior_var=jm._prior_var(jp, X), marginals=jm._marginals(jp, X),
                kl=jm.kl(jp), elbo=jm.elbo(jp, X, y, var, n_total=N_TOTAL),
                collapsed=jm.collapsed_elbo(jp, X, y, var),
                opt_mu=opt.q_mu, opt_sqrt=opt.q_sqrt,
                elbo_at_opt=jm.elbo(opt, X, y, var, n_total=X.shape[0]),
                grad_elbo=jax.grad(lambda r: jm.elbo(jsv.constrain(r), X, y, var,
                                                     n_total=N_TOTAL))(raw),
                grad_collapsed=jax.grad(lambda r: jm.collapsed_elbo(jsv.constrain(r), X, y,
                                                                    var))(raw),
                lat_mean=[g.mean for g in lat], lat_var=[jnp.diagonal(g.cov) for g in lat],
                gene_mean=gene.mean, gene_var=jnp.diagonal(gene.cov),
                elbo32=jm.elbo(jp32, X32, y32, var32, n_total=N_TOTAL),
                elbo_nonpd=nonpd.elbo(jp, X, y, var, n_total=N_TOTAL),
            )

        f32 = jnp.float32
        args = (_jax_params(p, order, R), jnp.asarray(X), jnp.asarray(y), jnp.asarray(var),
                jnp.asarray(X, f32), jnp.asarray(y, f32), jnp.asarray(var, f32),
                _jax_params(p, order, R, f32))
        out[variant] = jax.tree.map(np.asarray, _jit(program)(*args))
    return out


def _port(variant, dtype=F64):
    p, X, y, var = _problem(variant)
    params = convert.svlfm_params_from_numpy(p, device="cpu", dtype=dtype)
    return params, *(torch.as_tensor(a, dtype=dtype) for a in (X, y, var))


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_matches_jax(refs, variant):
    order, R = SPEC[variant]
    got = svlfm.init_params(G, M, t_max=12.0, dtype=F64, order=order, num_forces=R)
    want = _leaves(refs[variant]["init"])
    flat = svtrainer.flatten(got)
    assert len(flat) == len(want)
    for g, w, name in zip(flat, want, flat._fields):
        _close(g, w, 1e-12, f"init {name}")


def test_init_params_refuses_order2_with_forces():
    with pytest.raises(ValueError) as got:
        svlfm.init_params(G, M, order=2, num_forces=2)
    with pytest.raises(ValueError) as ref:
        jsv.init_params(G, M, order=2, num_forces=2)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("variant", VARIANTS)
def test_constrain_unconstrain_round_trip_and_match_jax(refs, variant):
    params, *_ = _port(variant)
    raw = svlfm.unconstrain(params)
    for g, w, name in zip(svtrainer.flatten(raw), _leaves(refs[variant]["raw"]),
                          svtrainer.flatten(raw)._fields):
        _close(g, w, 1e-12, f"unconstrain {name}")
    back = svlfm.constrain(raw)
    for g, w, name in zip(svtrainer.flatten(back), _leaves(refs[variant]["constrained"]),
                          svtrainer.flatten(back)._fields):
        _close(g, w, 1e-12, f"constrain {name}")
    for g, w in zip(svtrainer.flatten(back), svtrainer.flatten(params)):
        _close(g, w.numpy(), 1e-12, "round trip")
    assert type(back.kinetics) is type(params.kinetics)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("piece", ["mean_fn", "luu", "luu32", "proj", "prior_var", "marginals"])
def test_shared_pieces_match_jax(refs, variant, piece):
    params, X, y, var = _port(variant)
    model = _model(variant)
    ref = refs[variant]
    if piece == "mean_fn":
        pairs = [(model.mean_function(params, X), ref["mean_fn"])]
    elif piece == "luu":
        pairs = [(model._luu(params), ref["luu"])]
    elif piece == "luu32":
        # In float32 the jitter has a floor of 1e-4 (the model's is 1e-6): the
        # float32 factor against JAX's float32 one, and against the float64
        # factor of the same parameters under jitter 1e-4.
        p32, *_ = _port(variant, F32)
        got = model._luu(p32)
        assert got.dtype == F32
        _close(got, ref["luu32"], LUU32_TOL, f"{variant} luu f32 vs JAX f32")
        _close(got, _model(variant, jitter=1e-4)._luu(params), LUU32_TOL,
               f"{variant} luu f32 vs f64 at the floor")
        pairs = []
    elif piece == "proj":
        pairs = [(model._proj(params, model._luu(params), X), ref["proj"])]
    elif piece == "prior_var":
        pairs = [(model._prior_var(params, X), ref["prior_var"])]
    else:
        mean, v = model._marginals(params, X)
        pairs = [(mean, ref["marginals"][0]), (v, ref["marginals"][1])]
    for got, want in pairs:
        _close(got, want, 1e-12, f"{variant} {piece}")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("what", ["kl", "elbo", "collapsed", "optimal_q"])
def test_objectives_match_jax(refs, variant, what):
    params, X, y, var = _port(variant)
    model = _model(variant)
    ref = refs[variant]
    if what == "kl":
        _rel(model.kl(params), ref["kl"], 1e-10, "kl")
    elif what == "elbo":
        _rel(model.elbo(params, X, y, var, n_total=N_TOTAL), ref["elbo"], 1e-10, "elbo")
    elif what == "collapsed":
        _rel(model.collapsed_elbo(params, X, y, var), ref["collapsed"], 1e-10, "collapsed")
    else:
        opt = model.optimal_q(params, X, y, var)
        _close(opt.q_mu, ref["opt_mu"], 1e-10, "optimal q_mu", rel_to_max=False)
        _close(opt.q_sqrt, ref["opt_sqrt"], 1e-10, "optimal q_sqrt", rel_to_max=False)
        # The full-batch ELBO at the optimal q is the collapsed bound, up to
        # the marginal variance's floor at the jitter (JAX's
        # test_optimal_q_elbo_matches_collapsed: abs 2e-4).
        at_opt = model.elbo(opt, X, y, var, n_total=X.shape[0])
        _rel(at_opt, ref["elbo_at_opt"], 1e-10, "elbo at optimal q")
        gap = abs(float(at_opt) - float(model.collapsed_elbo(params, X, y, var)))
        assert gap <= 2e-4, f"elbo at q* vs collapsed: {gap:.3e}"


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("objective", ["elbo", "collapsed"])
def test_raw_gradients_match_jax(refs, variant, objective):
    params, X, y, var = _port(variant)
    model = _model(variant)
    raw = svlfm.unconstrain(params)
    leaves = svtrainer.flatten(raw)

    def fn(lv):
        p = svlfm.constrain(svtrainer.unflatten(lv, raw))
        if objective == "elbo":
            return model.elbo(p, X, y, var, n_total=N_TOTAL)
        return model.collapsed_elbo(p, X, y, var)

    # collapsed_elbo does not read q_mu or q_sqrt: their gradient is zero.
    leaves = type(leaves)(*(p.detach().requires_grad_(True) for p in leaves))
    grads = torch.autograd.grad(fn(leaves), tuple(leaves), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    want = _leaves(refs[variant]["grad_elbo" if objective == "elbo" else "grad_collapsed"])
    for g, w, name in zip(grads, want, leaves._fields):
        _close(g, w, 1e-9, f"{variant} d{objective}/d{name}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_predictions_match_jax(refs, variant):
    params, X, *_ = _port(variant)
    model = _model(variant)
    ref = refs[variant]
    t = torch.linspace(0.0, 13.0, 9, dtype=F64)
    for r in range(SPEC[variant][1]):
        lat = model.latent_predict(params, t, force=r)
        _close(lat.mean, ref["lat_mean"][r], 1e-10, f"latent mean force {r}")
        _close(lat.variance(), ref["lat_var"][r], 1e-10, f"latent variance force {r}")
    rows = X[:G * 7].clone()
    rows[:, 2] = 0.0  # gene_predict forces the flag to 1 and leaves its input alone
    gene = model.gene_predict(params, rows)
    assert bool((rows[:, 2] == 0.0).all())
    _close(gene.mean, ref["gene_mean"], 1e-10, "gene mean")
    _close(gene.variance(), ref["gene_var"], 1e-10, "gene variance")


@pytest.mark.parametrize("variant", VARIANTS)
def test_float32_elbo_matches_jax_float32(refs, variant):
    params, X, y, var = _port(variant, F32)
    got = _model(variant).elbo(params, X, y, var, n_total=N_TOTAL)
    assert got.dtype == F32
    _rel(got, refs[variant]["elbo32"], 1e-4, "f32 elbo")


@pytest.mark.parametrize("variant", VARIANTS)
def test_non_pd_kuu_gives_nan_not_an_exception(refs, variant):
    """A negative jitter makes Kuu non-PD: the factor, and so the bound, is
    NaN in both packages; the port raises nothing."""
    params, X, y, var = _port(variant)
    model = _model(variant, jitter=-1.0)
    assert bool(torch.isnan(model._luu(params)).all())
    assert np.isnan(refs[variant]["elbo_nonpd"])
    assert torch.isnan(model.elbo(params, X, y, var, n_total=N_TOTAL))
    assert torch.isnan(model.collapsed_elbo(params, X, y, var))
