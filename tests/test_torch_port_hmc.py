"""The port's HMC sampler (``dis_project_tpu_torch/training/hmc.py``), the
bijectors' Jacobians and the rest of the JAX package's data/Gram library
API, held to the JAX package on the CPU in float64.

The sampler runs on JAX's own random numbers: the tests rebuild the draws
of ``dis_project_tpu.training.hmc.sample`` from its key with its split
structure (``split(key, num_warmup + 1)``; each trajectory key split in
three: momenta, jitter, accept; the sampling keys from the last warmup key;
for ``sample_chains`` one key per chain and the last for the starting
noise) and feed them to the port through ``convert.hmc_draws_from_numpy``.

Tolerances: the bijectors' log-Jacobians 1e-14 x max(1, |ref|); the
leapfrog 1e-10; ``sample`` and ``sample_chains`` (samples, step sizes,
accept rates, log-probs) 1e-10 x max(1, max|ref|); the diagnostics and
``mixture_predict`` 1e-12; the data and Gram library API exactly or at
1e-12 (the hybrid Gram's gradient 1e-10). ``kinetics_posterior`` (p53, N
= 35) at 1e-9 (measured 2e-12 to 6e-11: the packages' erf differ by an
ulp that the closed form's exp(D t) amplifies to ~1e-11 in the Gram, and
a chain carries that along; from a point far from the data's kinetics,
where the adapted step is large, the leapfrog amplifies it further, so the
chains start at the published Barenco kinetics, as a trained point
would); ``nlfm.force_posterior_hmc`` (Q = 25) at 1e-8 (its raw gradient
matches JAX's only to eps cond(K_ff) = 1.6e-9 relative,
tests/test_torch_port_nlfm.py; measured 6.6e-9). The JAX references
compile at XLA's lowest CPU optimisation level.
"""

from typing import NamedTuple

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.data import dataset as jds
from dis_project_tpu.models import delaysimm as jdelay
from dis_project_tpu.models import nlfm as jnlfm
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.models.base import Gaussian as JGaussian
from dis_project_tpu.ops import bijectors as jbij
from dis_project_tpu.ops import gram as jgram
from dis_project_tpu.training import hmc as jhmc
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.data import dataset as tds
from dis_project_tpu_torch.models import delaysimm, nlfm, simm
from dis_project_tpu_torch.models.base import Gaussian
from dis_project_tpu_torch.ops import bijectors as bij
from dis_project_tpu_torch.ops import gram as tgram
from dis_project_tpu_torch.training import hmc

F64 = torch.float64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its routes and chains are
    thousands of small operations, and test workers that each run a thread
    per core oversubscribe the cores (six workers at 8 threads each ran
    these route tests ~20x slower than at 1 thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, ref, rtol, what):
    """|got - ref| <= rtol x max(1, max|ref|), NaN exactly where ref is NaN."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan), f"{what}: NaN pattern differs"
    got, ref = got[~nan], ref[~nan]
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    tol = rtol * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    assert err <= tol, f"{what}: max abs error {err:.3e} > {tol:.3e}"


# ---------------------------------------------------------------------------
# JAX's draws, rebuilt with hmc.py's split structure
# ---------------------------------------------------------------------------


def jax_tables(keys, dim):
    """Momenta, jitter factors and accept uniforms of ``hmc_step`` for each
    trajectory key (traced: call inside a jitted function)."""

    def one(k):
        k_mom, k_jit, k_acc = jax.random.split(k, 3)
        return (jax.random.normal(k_mom, (dim,), jnp.float64),
                jax.random.uniform(k_jit, (), jnp.float64, minval=0.67, maxval=1.33),
                jax.random.uniform(k_acc, (), jnp.float64))

    return jax.vmap(one)(keys)


def jax_draws(key, num_warmup, num_samples, dim):
    """The (warmup, sampling) tables of ``sample(..., key)``."""
    keys_w = jax.random.split(key, num_warmup + 1)
    return (jax_tables(keys_w[:num_warmup], dim),
            jax_tables(jax.random.split(keys_w[-1], num_samples), dim))


def jax_chain_draws(key, num_chains, num_warmup, num_samples, dim):
    """``sample_chains``'s starting noise (C, d) and each chain's tables."""
    keys = jax.random.split(key, num_chains + 1)
    noise = jax.random.normal(keys[-1], (num_chains, dim), jnp.float64)
    per_chain = [jax_draws(keys[c], num_warmup, num_samples, dim) for c in range(num_chains)]
    return noise, per_chain


def port_draws(tables):
    """The port's ``(warmup, sampling)`` HMCDraws from one chain's numpy
    tables, or from a list of chains' (stacked on the chain axis)."""
    if isinstance(tables, list):
        phases = []
        for phase in range(2):
            mom, jit_, acc = (np.stack([np.asarray(c[phase][i]) for c in tables], axis=1)
                              for i in range(3))
            phases.append(convert.hmc_draws_from_numpy(mom, jit_, acc, device="cpu"))
        return tuple(phases)
    return tuple(convert.hmc_draws_from_numpy(*(np.asarray(a) for a in t), device="cpu")
                 for t in tables)


# ---------------------------------------------------------------------------
# ops/bijectors.py
# ---------------------------------------------------------------------------

X_BIJ = np.concatenate([np.linspace(-40.0, 40.0, 161), [-700.0, -1e-12, 0.0, 1e-12, 700.0]])


@pytest.mark.parametrize("name", ["Identity", "Softplus", "SigmoidBounded"])
def test_bijector_log_det_grad_matches_jax(name):
    """``log_det_grad`` through the stable forms (-logaddexp(-x, 0);
    log(high - low) - logaddexp(x, 0) - logaddexp(-x, 0)), out to |x| =
    700, and ``forward``/``inverse`` unchanged."""
    args = (0.5, 3.5) if name == "SigmoidBounded" else ()
    jb, tb = getattr(jbij, name)(*args), getattr(bij, name)(*args)
    ref = np.asarray(jb.log_det_grad(jnp.asarray(X_BIJ)))
    got = tb.log_det_grad(_t(X_BIJ))
    assert np.all(np.isfinite(ref))
    _close(got, ref, 1e-14, f"{name}.log_det_grad")
    _close(tb.forward(_t(X_BIJ)), jb.forward(jnp.asarray(X_BIJ)), 1e-14, f"{name}.forward")
    assert isinstance(tb, bij.Bijector)


def test_constrain_log_det_matches_jax():
    """Summed over every element of every field, for the SIMM, delay and
    nlfm-kinetics bijector tuples at a random raw point (with a (1,)
    shared-kinetics variant)."""
    rng = np.random.default_rng(3)
    raw = {k: rng.normal(scale=3.0, size=s) for k, s in
           (("basal", 5), ("sensitivity", 5), ("decay", 5), ("lengthscale", ()),
            ("obs_stddev", ()), ("delay", 5))}
    simm_raw = {k: raw[k] for k in jsimm.SIMMParams._fields}
    cases = [
        (jsimm.SIMMParams(**simm_raw), jsimm.SIMM_BIJECTORS,
         convert.params_from_numpy(simm_raw, device="cpu"), simm.SIMM_BIJECTORS),
        (jdelay.DelaySIMMParams(**raw), jdelay.DELAY_BIJECTORS,
         convert.delaysimm_params_from_numpy(raw, device="cpu"), delaysimm.DELAY_BIJECTORS),
    ]
    shared = {**simm_raw, **{k: simm_raw[k][:1] for k in ("basal", "sensitivity", "decay")}}
    cases.append((jsimm.SIMMParams(**shared), jsimm.SIMM_BIJECTORS,
                  convert.params_from_numpy(shared, device="cpu"), simm.SIMM_BIJECTORS))
    for jraw, jb, traw, tb in cases:
        ref = float(jbij.constrain_log_det(jax.tree.map(jnp.asarray, jraw), jb))
        got = bij.constrain_log_det(traw, tb)
        _close(got, ref, 1e-14, "constrain_log_det")


# ---------------------------------------------------------------------------
# item 2: the data and Gram library API
# ---------------------------------------------------------------------------


def test_p53data_getitem_shape_and_flatten_blocked_match_jax():
    jdata = jds.P53Data(replicate=None, source="synthetic", seed=0)
    tdata = tds.P53Data(replicate=None, source="synthetic", seed=0)
    assert tdata.shape == jdata.shape == (15, 2, 7)
    for i in range(len(tdata)):
        (tt, te), (jt, je) = tdata[i], jdata[i]
        assert np.array_equal(tt, np.asarray(jt)) and np.array_equal(te, np.asarray(je))
    for bad in (-1, len(tdata)):
        with pytest.raises(IndexError, match="Index out of range"):
            tdata[bad]
    one = tds.P53Data(replicate=1, source="synthetic", seed=0)
    assert one.shape == (5, 2, 7) and np.array_equal(one[4][1], tdata[9][1])
    for data, jd in ((tdata, jdata), (one, jds.P53Data(replicate=1, source="synthetic"))):
        got = tds.flatten_blocked(data, device="cpu")
        ref = jds.flatten_blocked(jd)
        for g, r in zip(got, ref):
            assert torch.equal(g, _t(r))


def _grid_kin():
    rng = np.random.default_rng(11)
    t = np.linspace(0.0, 12.0, 7)
    return (t, rng.uniform(0.3, 1.2, 4), rng.uniform(0.5, 1.5, 4), np.array(2.3),
            rng.normal(size=(28, 28)))


@pytest.mark.parametrize("replicates", [1, 3])
def test_gram_xx_blocked_matches_jax(replicates):
    t, d, s, ell, _ = _grid_kin()
    ref = _jit(jgram.gram_xx_blocked, static_argnames="replicates")(
        *(jnp.asarray(a) for a in (t, d, s, ell)), replicates=replicates)
    got = tgram.gram_xx_blocked(*(_t(a) for a in (t, d, s, ell)), replicates=replicates)
    _close(got, ref, 1e-12, "gram_xx_blocked")


def test_gram_xx_blocked_hybrid_matches_jax():
    """Forward: the port's table Gram bit for bit, and JAX's hybrid at
    1e-12. Backward: the row algebra's VJP, JAX's hybrid VJP at 1e-10, for
    every input (the grid's gradient too)."""
    t, d, s, ell, W = _grid_kin()
    def ref_fn(w, *jin):
        out, vjp = jax.vjp(jgram.gram_xx_blocked_hybrid, *jin)
        return out, vjp(w)

    ref, ref_g = _jit(ref_fn)(jnp.asarray(W), *(jnp.asarray(a) for a in (t, d, s, ell)))
    tin = [_t(a).requires_grad_() for a in (t, d, s, ell)]
    got = tgram.gram_xx_blocked_hybrid(*tin)
    assert torch.equal(got.detach(), tgram.gram_xx_blocked_fast(*(a.detach() for a in tin)))
    _close(got, ref, 1e-12, "hybrid forward")
    grads = torch.autograd.grad(got, tin, _t(W))
    for name, g, r in zip(("t", "decay", "sens", "lengthscale"), grads, ref_g):
        _close(g, r, 1e-10, f"hybrid d{name}")
    # Only the inputs that ask for a gradient get one.
    d_only = _t(d).requires_grad_()
    (gd,) = torch.autograd.grad(tgram.gram_xx_blocked_hybrid(_t(t), d_only, _t(s), _t(ell)),
                                d_only, _t(W))
    _close(gd, ref_g[1], 1e-10, "hybrid ddecay alone")


# ---------------------------------------------------------------------------
# training/hmc.py: flattening, the leapfrog, sample, sample_chains
# ---------------------------------------------------------------------------


class Pos(NamedTuple):
    """A two-leaf position (a vector and a scalar) for both packages."""

    a: object
    b: object


PREC = np.array([[2.0, 0.6, 0.0], [0.6, 0.5, 0.1], [0.0, 0.1, 4.0]])
POS0 = Pos(a=np.array([0.3, -1.1]), b=np.array(0.7))


def _gauss_j(pos):
    q = jnp.concatenate([pos.a, pos.b[None]])
    return -0.5 * q @ jnp.asarray(PREC) @ q + 0.1 * jnp.sum(jnp.sin(q))


def _gauss_t(pos):
    q = torch.cat([pos.a, pos.b[None]])
    return -0.5 * q @ _t(PREC) @ q + 0.1 * torch.sum(torch.sin(q))


def _tpos(p):
    return Pos(*(_t(v) for v in p))


def test_ravel_order_matches_ravel_pytree():
    """The flat order of a nested NamedTuple (NLFMParams: SIMMParams, then
    w) is ``ravel_pytree``'s, and unravel carries leading axes."""
    from dis_project_tpu.models import nlfm as jnlfm

    rng = np.random.default_rng(0)
    kin = {k: rng.normal(size=s) for k, s in (("basal", 5), ("sensitivity", 5), ("decay", 5),
                                             ("lengthscale", ()), ("obs_stddev", ()))}
    w = rng.normal(size=7)
    jp = jnlfm.NLFMParams(kinetics=jsimm.SIMMParams(**{k: jnp.asarray(v) for k, v in kin.items()}),
                          w=jnp.asarray(w))
    tp = convert.nlfm_params_from_numpy({"kinetics": kin, "w": w}, device="cpu")
    ref, _ = jax.flatten_util.ravel_pytree(jp)
    flat, unravel = hmc.ravel(tp)
    assert torch.equal(flat, _t(ref))
    back = unravel(torch.stack([flat, 2 * flat]))
    assert isinstance(back, nlfm.NLFMParams) and back.kinetics.lengthscale.shape == (2,)
    assert torch.equal(back.w[1], 2 * tp.w)
    assert torch.equal(back.kinetics.decay[0], tp.kinetics.decay)


@pytest.fixture(scope="module")
def p53_density():
    """The exact SIMM kinetics log-density on the p53 synthetic data (N =
    35) at a point off the init, in both packages: ``(jax flat density,
    jax flat q0, port density, port raw0)``."""
    jdata = jds.P53Data(replicate=0, source="synthetic", seed=0)
    X, y, var = jds.train_arrays(jdata)
    jm = jsimm.ExactSIMM(num_genes=5, jitter=1e-4)
    rng = np.random.default_rng(2)
    pt = dict(basal=rng.uniform(0.02, 0.1, 5), sensitivity=rng.uniform(0.6, 1.4, 5),
              decay=rng.uniform(0.3, 0.9, 5), lengthscale=np.array(2.4),
              obs_stddev=np.array(0.3))
    jraw = jsimm.unconstrain(jsimm.SIMMParams(**{k: jnp.asarray(v) for k, v in pt.items()}))
    q0, unravel = jax.flatten_util.ravel_pytree(jraw)

    def jld(q):
        raw = unravel(q)
        return jm.mll(jsimm.constrain(raw), X, y.reshape(-1)) + jbij.constrain_log_det(
            raw, jsimm.SIMM_BIJECTORS)

    tm = simm.ExactSIMM(num_genes=5, jitter=1e-4)
    tX, ty, _ = convert.arrays_from_numpy(X, y, var, device="cpu")

    def tld(raw):
        return tm.mll(simm.constrain(raw), tX, ty) + bij.constrain_log_det(raw,
                                                                           simm.SIMM_BIJECTORS)

    return jld, q0, tld, simm.unconstrain(convert.params_from_numpy(pt, device="cpu"))


@pytest.mark.parametrize("density", ["gaussian", "p53"])
def test_leapfrog_matches_jax(density, p53_density):
    """Eight leapfrog steps from fed momenta, under a diagonal mass: (q, p,
    logp, grad) at 1e-10 of JAX's ``_leapfrog``."""
    if density == "gaussian":
        q0j, unravel_j = jax.flatten_util.ravel_pytree(jax.tree.map(jnp.asarray, POS0))
        jld = lambda q: _gauss_j(unravel_j(q))  # noqa: E731
        tld, tpos0, eps = _gauss_t, _tpos(POS0), 0.3
    else:
        jld, q0j, tld, tpos0 = p53_density
        eps = 0.02
    dim = q0j.shape[0]
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=dim)
    inv_mass = rng.uniform(0.5, 2.0, dim)

    def ref_fn(q0, p, m):
        vg = jax.value_and_grad(jld)
        v0, g0 = vg(q0)
        return jhmc._leapfrog(vg, q0, p, v0, g0, eps, m, 8)

    ref = _jit(ref_fn)(q0j, jnp.asarray(p0), jnp.asarray(inv_mass))
    flat, unravel = hmc.ravel(tpos0)
    vg = hmc._value_and_grad(tld, unravel)
    v0, g0 = vg(flat[None])
    got = hmc._leapfrog(vg, flat[None], _t(p0)[None], v0, g0, eps, _t(inv_mass)[None], 8)
    for name, g, r in zip(("q", "p", "logp", "grad"), got, ref):
        _close(g[0], r, 1e-10, f"{density} leapfrog {name}")


def _assert_result(got, ref, what, rtol=1e-10):
    for name in ("accept_rate", "step_size", "log_probs"):
        _close(getattr(got, name), getattr(ref, name), rtol, f"{what} {name}")
    for i, (g, r) in enumerate(zip(jax.tree.leaves(ref.samples),
                                   hmc.checkpoint.tree_leaves(got.samples))):
        _close(r, g, rtol, f"{what} samples leaf {i}")


SAMPLE_CASES = {"two windows": (8, 6, 3), "one window": (4, 6, 3)}


@pytest.fixture(scope="module")
def gauss_refs():
    """JAX's ``sample`` at both warmup cases, ``sample_chains`` at C = 2,
    and their draw tables, on the Gaussian-plus-sine density, in one
    compiled program."""
    key = jax.random.PRNGKey(5)
    dim = 3

    def all_refs(pos0):
        out = {}
        for name, (nw, ns, nl) in SAMPLE_CASES.items():
            out[name] = (jhmc.sample(_gauss_j, pos0, key, num_warmup=nw, num_samples=ns,
                                     num_leapfrog=nl),
                         jax_draws(key, nw, ns, dim))
        out["chains"] = (jhmc.sample_chains(_gauss_j, pos0, key, num_chains=2, num_warmup=8,
                                            num_samples=6, num_leapfrog=3),
                         jax_chain_draws(key, 2, 8, 6, dim))
        return out

    return jax.tree.map(np.asarray, _jit(all_refs)(jax.tree.map(jnp.asarray, POS0)))


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_matches_jax_on_its_draws(case, gauss_refs):
    """Samples, step size, accept rate and log-probs at rel 1e-10 of JAX's
    ``sample`` on the same random numbers, with both warmup windows (8
    warmup draws) and with one (4)."""
    ref, tables = gauss_refs[case]
    nw, ns, nl = SAMPLE_CASES[case]
    got = hmc.sample(_gauss_t, _tpos(POS0), None, num_warmup=nw, num_samples=ns,
                     num_leapfrog=nl, draws=port_draws(tables))
    assert isinstance(got.samples, Pos) and got.samples.b.shape == (ns,)
    _assert_result(got, ref, f"sample {case}")
    # The chain moved away from its seed point.
    assert not torch.equal(got.samples.a[-1], _t(POS0.a))


def test_sample_chains_matches_jax_on_its_draws(gauss_refs):
    """C = 2 chains in lockstep against JAX's vmapped chains: chain 0 at
    the seed point, chain 1 jittered; per-chain step sizes and accept
    rates, (C, S) samples and log-probs at rel 1e-10."""
    ref, (noise, per_chain) = gauss_refs["chains"]
    got = hmc.sample_chains(_gauss_t, _tpos(POS0), None, num_chains=2, num_warmup=8,
                            num_samples=6, num_leapfrog=3, draws=port_draws(list(per_chain)),
                            init_noise=_t(noise))
    assert got.samples.a.shape == (2, 6, 2) and got.step_size.shape == (2,)
    _assert_result(got, ref, "sample_chains")


def test_sample_chains_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        hmc.sample_chains(_gauss_t, _tpos(POS0), torch.Generator(), num_chains=2,
                          mesh=object(), num_warmup=2, num_samples=2)


def test_generator_draws_are_reproducible_and_in_range():
    """Without ready-made draws the generator's tables drive the chain: the
    same seed gives the same chain bitwise, the jitter lies in [0.67,
    1.33), and C chains start at the seed point (chain 0) and jittered."""
    tab = hmc.draw_tables(torch.Generator().manual_seed(0), 500, 3, 2, F64, "cpu")
    assert tab.momenta.shape == (500, 3, 2) and tab.jitter.shape == tab.accept.shape == (500, 3)
    assert float(tab.jitter.min()) >= 0.67 and float(tab.jitter.max()) < 1.33
    assert 0.0 <= float(tab.accept.min()) and float(tab.accept.max()) < 1.0
    runs = [hmc.sample_chains(_gauss_t, _tpos(POS0), torch.Generator().manual_seed(9),
                              num_chains=3, num_warmup=4, num_samples=3, num_leapfrog=2)
            for _ in range(2)]
    for a, b in zip(hmc.checkpoint.tree_leaves(runs[0]), hmc.checkpoint.tree_leaves(runs[1])):
        for x, y in zip(hmc.checkpoint.tree_leaves(a), hmc.checkpoint.tree_leaves(b)):
            assert torch.equal(x, y)


def test_non_finite_proposals_are_rejected_without_an_exception():
    """A density that is NaN beyond |q| > 2 and a step size of 1e3: every
    proposal lands there, alpha is 0, the chain stays at its seed point and
    nothing raises (the Metropolis test is a where, as in JAX)."""

    def ld(pos):
        q = torch.cat([pos.a, pos.b[None]])
        v = -0.5 * torch.sum(q * q)
        return torch.where(torch.all(q.abs() < 2.0), v, torch.full_like(v, float("nan")))

    res = hmc.sample(ld, _tpos(POS0), torch.Generator().manual_seed(1), num_warmup=0,
                     num_samples=3, num_leapfrog=2, initial_step_size=1e3)
    assert float(res.accept_rate) == 0.0 and torch.isfinite(res.log_probs).all()
    assert torch.equal(res.samples.a, _t(POS0.a).expand(3, 2))


# ---------------------------------------------------------------------------
# diagnostics and the BMA mixture
# ---------------------------------------------------------------------------


def test_diagnostics_match_jax():
    """split-R-hat and ESS per coordinate (trailing shapes (), (2,), (2,
    3)), one chain and a too-short chain included, and
    ``pytree_diagnostics`` over a two-leaf tree, at 1e-12 of JAX's."""
    rng = np.random.default_rng(7)
    ar = np.zeros((3, 41, 2, 3))
    for t in range(1, 41):  # autocorrelated chains with different offsets
        ar[:, t] = 0.7 * ar[:, t - 1] + rng.normal(size=(3, 2, 3))
    ar += np.arange(3)[:, None, None, None] * 0.2
    cases = [ar, ar[:, :, 0, 0], ar[:, :, 1], ar[:1], ar[:, :3], np.ones((2, 10))]
    for x in cases:
        with np.errstate(all="ignore"):
            _close(hmc.split_rhat(x), jhmc.split_rhat(x), 1e-12, f"split_rhat {x.shape}")
            _close(hmc.effective_sample_size(x), jhmc.effective_sample_size(x), 1e-12,
                   f"ess {x.shape}")
    tree_t = Pos(a=_t(ar[:, :, 0]), b=_t(ar[:, :, 1, 2]))
    tree_j = Pos(a=jnp.asarray(ar[:, :, 0]), b=jnp.asarray(ar[:, :, 1, 2]))
    got, ref = hmc.pytree_diagnostics(tree_t), jhmc.pytree_diagnostics(tree_j)
    _close(np.array(got), np.array(ref), 1e-12, "pytree_diagnostics")


def _components(n, N, rng):
    m = rng.normal(size=(n, N))
    a = rng.normal(size=(n, N, N))
    c = a @ np.transpose(a, (0, 2, 1)) / N + 0.1 * np.eye(N)
    return m, c


@pytest.mark.parametrize("max_components", [64, 7])
def test_mixture_predict_matches_jax_with_the_drop_rules(max_components):
    """Thinning ``round(linspace(0, n-1, take))``, a non-finite mean, a
    non-finite covariance and a negative variance dropped, then the moment
    matching: mean, covariance and the kept component means at 1e-12."""
    rng = np.random.default_rng(8)
    m, c = _components(10, 4, rng)
    m[2, 1] = np.nan
    c[4, 0, 3] = np.inf
    c[6, 2, 2] = -1e-3
    jtree = Pos(a=jnp.asarray(m), b=jnp.asarray(c))
    ref, ref_comp = jhmc.mixture_predict(lambda p: JGaussian(mean=p.a, cov=p.b), jtree,
                                         max_components=max_components)
    got, comp = hmc.mixture_predict(lambda p: Gaussian(mean=p.a, cov=p.b),
                                    Pos(a=_t(m), b=_t(c)), max_components=max_components)
    assert comp.shape == np.asarray(ref_comp).shape and comp.shape[0] < min(10, max_components)
    _close(comp, ref_comp, 1e-12, "component means")
    _close(got.mean, ref.mean, 1e-12, "BMA mean")
    _close(got.cov, ref.cov, 1e-12, "BMA cov")


def test_mixture_predict_with_every_component_dropped_is_nan():
    rng = np.random.default_rng(9)
    m, c = _components(3, 4, rng)
    m[:, 0] = np.nan
    got, comp = hmc.mixture_predict(lambda p: Gaussian(mean=p.a, cov=p.b),
                                    Pos(a=_t(m), b=_t(c)))
    ref, ref_comp = jhmc.mixture_predict(lambda p: JGaussian(mean=p.a, cov=p.b),
                                         Pos(a=jnp.asarray(m), b=jnp.asarray(c)))
    assert comp.shape == np.asarray(ref_comp).shape == (0, 4)
    assert got.mean.shape == (4,) and got.cov.shape == (4, 4)
    assert torch.isnan(got.mean).all() and torch.isnan(got.cov).all()
    assert np.isnan(np.asarray(ref.mean)).all()


# ---------------------------------------------------------------------------
# the exact posteriors against JAX's on JAX's draws (the delay and
# state-space ones: test_torch_port_hmc_routes.py)
# ---------------------------------------------------------------------------

NW, NS = 4, 4  # warmup and sampling draws of the posteriors (both warmup
# windows are held above)


def _jtree(cls, mapping):
    return cls(**{k: jnp.asarray(v) for k, v in mapping.items()})


def _p53(replicate=0):
    return jds.train_arrays(jds.P53Data(replicate=replicate, source="synthetic", seed=0))


def _kin():
    """The published kinetics, lengthscale 2.5 and noise 0.3."""
    b, s, d = jds.P53Data(replicate=0, source="synthetic", seed=0).params_ground_truth()
    return dict(basal=np.asarray(b), sensitivity=np.asarray(s), decay=np.asarray(d),
                lengthscale=np.array(2.5), obs_stddev=np.array(0.3))


def _run_jax(fn, dim, nw, ns, *args):
    """JAX's posterior and its draw tables in one compiled program."""
    key = jax.random.PRNGKey(3)

    def both(*a):
        return fn(*a, key, nw, ns), jax_draws(key, nw, ns, dim)

    ref, tables = _jit(both)(*args)
    return jax.tree.map(np.asarray, ref), port_draws(jax.tree.map(np.asarray, tables))


def test_kinetics_posterior_matches_jax():
    pt = _kin()
    X, y, var = _p53()
    jm = jsimm.ExactSIMM(num_genes=5, jitter=1e-4)
    ref, draws = _run_jax(
        lambda p, k, nw, ns: jhmc.kinetics_posterior(jm, p, X, y, k, num_warmup=nw,
                                                     num_samples=ns),
        17, NW, NS, _jtree(jsimm.SIMMParams, pt))
    tX, ty, _ = convert.arrays_from_numpy(X, y, var, device="cpu")
    got = hmc.kinetics_posterior(simm.ExactSIMM(num_genes=5, jitter=1e-4),
                                 convert.params_from_numpy(pt, device="cpu"), tX, ty, None,
                                 num_warmup=NW, num_samples=NS, draws=draws)
    assert isinstance(got.samples, simm.SIMMParams) and got.samples.decay.shape == (NS, 5)
    _assert_result(got, ref, "kinetics_posterior", rtol=1e-9)


def test_force_posterior_hmc_matches_jax():
    rng = np.random.default_rng(4)
    Q = 25
    pt = dict(kinetics=_kin(), w=0.5 * rng.normal(size=Q))
    data = jds.P53Data(replicate=None, source="synthetic", seed=0)
    t, Y, V = (np.asarray(a) for a in (data.timepoints, data.gene_expressions,
                                       data.gene_variances))
    jm = jnlfm.NonlinearLFM(num_genes=5, response="exp", t_max=12.0, num_quad=Q)
    jp = jnlfm.NLFMParams(kinetics=_jtree(jsimm.SIMMParams, pt["kinetics"]), w=jnp.asarray(pt["w"]))
    ref, draws = _run_jax(
        lambda p, k, nw, ns: jnlfm.force_posterior_hmc(jm, p, t, Y, V, k, num_warmup=nw,
                                                       num_samples=ns),
        17 + Q, NW, NS, jp)
    tm = nlfm.NonlinearLFM(num_genes=5, response="exp", t_max=12.0, num_quad=Q)
    got = nlfm.force_posterior_hmc(tm, convert.nlfm_params_from_numpy(pt, device="cpu"),
                                   *(torch.as_tensor(a) for a in (t, Y, V)), None,
                                   num_warmup=NW, num_samples=NS, draws=draws)
    assert got.samples.w.shape == (NS, Q)
    _assert_result(got, ref, "force_posterior_hmc", rtol=1e-8)
