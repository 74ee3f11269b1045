"""K1's hoisted arithmetic and the dense-shaped posteriors held to the JAX
package on the CPU.

``cuda_gram.cross_covariance_hoisted`` writes out in PyTorch what the CUDA
kernel ``gram_rect_kernel`` (K1) computes: the one-index terms of both row
sets once per row, then the per-entry terms of the kind. Here it is held in
float64 to JAX's closed form (``ops.gram.cross_covariance_kind``) and in
float32 to the Pallas kernel in interpret mode; the kernel is held to it
and to the plain closed form on the card by ``chip_smoke.py``. The port's
``latent_predict`` and ``multi_gene_predict``, whose cross-covariances K1
builds on the card, are held to JAX's on rows laid out as the dense route
lays them out. Inputs are made with numpy from a seed and handed to both
packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import gram as jgram
from dis_project_tpu.ops import pallas_gram as pg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import cuda_gram
from dis_project_tpu_torch.ops import gram as tgram

KINDS = list(cuda_gram.KIND_CODES)
# The JAX references compile at XLA's lowest CPU optimisation level, about
# twice as fast as at the default; their values move by at most ~5e-15.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# Float32 closed forms sit up to ~3e-4 from their float64 value on rows over
# [0, 13] (cancelling erfs under exp(D |t - t'|)), whichever evaluates them:
# the limit of tests/test_torch_port_kernels.py.
F32_ATOL = 1e-3


def _gene_major(genes, times, t_max, flag):
    """Rows of ``genes`` genes x ``times`` times, gene-major, as the dense
    route and the expression grids lay them out (a 64-row tile holds one or
    two genes: the kernel's (gamma, time) tables)."""
    t = np.tile(np.linspace(0.0, t_max, times), genes)
    g = np.repeat(np.arange(genes, dtype=np.float64), times) if flag else -np.ones_like(t)
    return np.stack([t, g, np.full_like(t, flag)], axis=1)


def _random_rows(rng, n, genes):
    """Mixed rows over [0, 12]: expression rows draw genes 0..genes+1 (the
    last two out of range, clamped to genes-1), force rows carry gene -1."""
    t = rng.uniform(0, 12, n)
    f = rng.integers(0, 2, n).astype(np.float64)
    g = np.where(f == 1, rng.integers(0, genes + 2, n), -1)
    return np.stack([t, g, f], axis=1)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(x1, x2, decay, sens, lengthscale) of each row-set case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    genes = 50 if "50" in name else 5
    d, s = rng.uniform(0.2, 1.0, genes), rng.uniform(0.5, 1.5, genes)
    if name == "canonical 35x100":  # expression rows against force columns
        x1, x2 = _gene_major(5, 7, 12.0, 1), _gene_major(1, 100, 13.0, 0)
    elif name == "clamped 37x53":
        x1, x2 = _random_rows(rng, 37, genes), _random_rows(rng, 53, genes)
    elif name == "gene-major 70x83":
        x1, x2 = _gene_major(5, 14, 12.0, 1), _random_rows(rng, 83, genes)
    else:  # "50 genes 70x83": more distinct decays a tile side than the tables take
        x1, x2 = _random_rows(rng, 70, genes), _random_rows(rng, 83, genes)
    return x1, x2, d, s, np.float64(rng.uniform(1.5, 3.0))


CASES = ["canonical 35x100", "clamped 37x53", "gene-major 70x83", "50 genes 70x83"]


def _port(arrays, dtype=torch.float64):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_closed_forms():
    """JAX's closed form of every kind on every case, in one compiled call."""
    fn = jax.jit(lambda cases: [{k: jgram.cross_covariance_kind(*a, kind=k) for k in KINDS}
                                for a in cases], compiler_options=FAST_COMPILE)
    out = fn([tuple(jnp.asarray(a) for a in _case(c)) for c in CASES])
    return {c: {k: np.asarray(v) for k, v in o.items()} for c, o in zip(CASES, out)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_hoisted_cross_covariance_matches_jax_closed_form(kind, case):
    """float64: the hoisted arithmetic against the port's plain closed form
    at 1e-12 (the same erf), and against JAX's closed form no further than
    that closed form is from it, within 1e-13 of the largest entry. The two
    packages' erf differ by an ulp near +-1, which exp(D |t - t'|) <= e^12
    amplifies to up to ~1e-11 on single entries of these rows, whichever
    form evaluates them."""
    args = _case(case)
    got = cuda_gram.cross_covariance_hoisted(*_port(args), kind).numpy()
    plain = tgram.cross_covariance_kind(*_port(args), kind).numpy()
    ref = _jax_closed_forms()[case][kind]
    assert got.shape == ref.shape == (args[0].shape[0], args[1].shape[0])
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12)
    gap, plain_gap = np.abs(got - ref).max(), np.abs(plain - ref).max()
    assert gap <= max(1e-12, plain_gap + 1e-13 * np.abs(ref).max()), (gap, plain_gap)


@functools.lru_cache(maxsize=None)
def _pallas_interpret():
    """The Pallas K1 in interpret mode, every kind, float32, ragged rows."""
    fn = jax.jit(lambda *a: {k: pg.cross_covariance(*a, kind=k, tile_m=32, tile_n=128,
                                                    interpret=True) for k in KINDS},
                 compiler_options=FAST_COMPILE)
    out = fn(*(jnp.asarray(a, jnp.float32) for a in _case("clamped 37x53")))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_hoisted_cross_covariance_matches_pallas_interpret(kind):
    """float32 against the Pallas K1 in interpret mode, ragged rows."""
    got = cuda_gram.cross_covariance_hoisted(*_port(_case("clamped 37x53"), torch.float32), kind)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas_interpret()[kind], rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("kind", list(cuda_gram.SYM_KINDS))
def test_hoisted_cross_covariance_shares_k2s_arithmetic(kind):
    """On one row set, K1's and K2's plain hoisted versions share their
    per-entry helper: the lower triangles are bitwise equal."""
    x, _, d, s, l = _case("clamped 37x53")
    args = _port((x, d, s, l))
    rect = cuda_gram.cross_covariance_hoisted(args[0], *args, kind)
    sym = cuda_gram.gram_sym_hoisted(*args, kind)
    assert torch.equal(torch.tril(rect), torch.tril(sym))


def test_hoisted_cross_covariance_refuses_unknown_kind():
    args = _port(_case("clamped 37x53"))
    with pytest.raises(ValueError, match="unknown kind"):
        cuda_gram.cross_covariance_hoisted(*args, "xy")


# ---------------------------------------------------------------------------
# The posteriors whose cross-covariances K1 builds on the card, on a small
# dense-shaped case: 5 genes x 20 times, gene-major, against a 5 x 30
# expression grid and a 30-point latent grid; f64 at 1e-10.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dense_case():
    rng = np.random.default_rng(20)
    X = _gene_major(5, 20, 12.0, 1)
    y = rng.standard_normal(100)
    var = rng.uniform(0.01, 0.05, 100)
    p = jsimm.init_params(5)
    p = p._replace(basal=p.basal + 0.02 * jnp.asarray(rng.uniform(size=5)),
                   sensitivity=p.sensitivity * jnp.asarray(rng.uniform(0.8, 1.2, 5)),
                   decay=p.decay * jnp.asarray(rng.uniform(0.7, 1.5, 5)),
                   lengthscale=jnp.asarray(2.1), obs_stddev=jnp.asarray(0.2))
    return X, y, var, p


GRIDS = {"multi_gene_predict": _gene_major(5, 30, 13.0, 1),
         "latent_predict": _gene_major(1, 30, 13.0, 0)}


@functools.lru_cache(maxsize=None)
def _jax_posteriors():
    X, y, var, p = _dense_case()
    jmodel = jsimm.ExactSIMM(num_genes=5, jitter=1e-4, canonical_rows=True)
    fn = jax.jit(lambda p: {m: getattr(jmodel, m)(p, jnp.asarray(rows), jnp.asarray(X),
                                                  jnp.asarray(y), jnp.asarray(var))
                            for m, rows in GRIDS.items()}, compiler_options=FAST_COMPILE)
    return {m: (np.asarray(g.mean), np.asarray(g.cov)) for m, g in fn(p).items()}


@pytest.mark.parametrize("method", list(GRIDS))
def test_dense_shaped_posteriors_match_jax(method):
    X, y, var, p = _dense_case()
    rows = GRIDS[method]
    tmodel = simm.ExactSIMM(num_genes=5, jitter=1e-4, canonical_rows=True)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in p._asdict().items()},
                                   device="cpu")
    got = getattr(tmodel, method)(tp, *_port((rows, X, y, var)))
    ref_mean, ref_cov = _jax_posteriors()[method]
    assert got.mean.shape == (rows.shape[0],)
    np.testing.assert_allclose(got.mean.numpy(), ref_mean, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.cov.numpy(), ref_cov, rtol=1e-10, atol=1e-10)
