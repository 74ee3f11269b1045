"""K2's backward, K3's split 3xTF32 numerics and the engine of the port's
predictions, held to the JAX package on the CPU.

On the CPU, ``cuda_gram.gram_sym``'s backward takes its plain version,
``gram_sym_vjp_plain``; it is held here to the VJP of JAX's
``pallas_gram.gram_sym`` (Pallas in interpret mode, backward through the
XLA closed form) in float64. The CUDA kernel ``gram_sym_bwd_kernel`` is
held to the plain version on the card by ``chip_smoke.py``. K3's
tensor-core products cannot run here; a numpy emulation of their split
pins the numerics the kernel relies on. Inputs are made with numpy from a
seed and handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_project_tpu.data.dataset import P53Data as JP53Data
from dis_project_tpu.data.dataset import train_arrays as jtrain_arrays
from dis_project_tpu.models import simm as jsimm
from dis_project_tpu.ops import pallas_gram as pg
from dis_project_tpu_torch import convert
from dis_project_tpu_torch.models import simm
from dis_project_tpu_torch.ops import cuda_cholesky, cuda_gram
from dis_project_tpu_torch.ops import gram as tgram

G = 5
F64 = torch.float64


def _rows(rng, n, kind, genes=(0, G + 1)):
    """(n, 3) rows of the kind's population; expression rows draw genes
    from ``genes`` (G is out of range and must clamp to G-1), force rows
    carry gene -1."""
    t = rng.uniform(0, 12, n)
    f = {"xx": np.ones(n), "ff": np.zeros(n), "mixed": rng.integers(0, 2, n)}[kind]
    g = np.where(f == 1, rng.integers(*genes, n), -1)
    return np.stack([t, g, f], axis=1).astype(np.float64)


def _kinetics(rng):
    return rng.uniform(0.2, 1.0, G), rng.uniform(0.5, 1.5, G), np.float64(1.7)


# ---------------------------------------------------------------------------
# K2's backward: the port's gram_sym gradient (plain VJP on the CPU) vs the
# VJP of JAX's gram_sym, float64, on a NON-symmetric cotangent (the MLL
# backward hands over a lower-triangle form), for subsets of the inputs.
# ---------------------------------------------------------------------------

NEEDS = {
    "all": (True, True, True, True),
    "kinetics": (False, True, True, True),
    "lengthscale": (False, False, False, True),
    "decay": (False, True, False, False),
}


@functools.lru_cache(maxsize=None)
def _case(kind):
    """Rows, kinetics, a non-symmetric cotangent and JAX's VJP of gram_sym
    against it (x, decay, sens, lengthscale), one per kind."""
    rng = np.random.default_rng(11)
    n = 45
    x, (d, s, l) = _rows(rng, n, kind), _kinetics(rng)
    g = rng.standard_normal((n, n))
    _, vjp = jax.vjp(
        lambda *a: pg.gram_sym(*a, kind=kind, tile=32, interpret=True),
        *(jnp.asarray(a) for a in (x, d, s, l)),
    )
    return (x, d, s, l), g, [np.asarray(r) for r in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("needs", list(NEEDS))
@pytest.mark.parametrize("kind", list(cuda_gram.SYM_KINDS))
def test_gram_sym_backward_matches_jax_vjp(kind, needs):
    """Through autograd (``_GramSym.backward``): the gradient of every input
    asked for at 1e-10 relative to its largest entry; None for the others."""
    (x, d, s, l), g, ref = _case(kind)
    leaves = [torch.tensor(a, dtype=F64, requires_grad=nd)
              for a, nd in zip((x, d, s, l), NEEDS[needs])]
    out = cuda_gram.gram_sym(*leaves, kind)
    wanted = [a for a in leaves if a.requires_grad]
    got = iter(torch.autograd.grad(out, wanted, torch.tensor(g), allow_unused=True))
    for name, nd, r in zip(("x", "decay", "sens", "lengthscale"), NEEDS[needs], ref):
        if not nd:
            continue
        gt = next(got)
        gt = np.zeros_like(r) if gt is None else gt.numpy()
        np.testing.assert_allclose(gt, r, rtol=0, atol=1e-10 * max(np.abs(r).max(), 1e-300),
                                   err_msg=name)


@pytest.mark.parametrize("kind", list(cuda_gram.SYM_KINDS))
def test_gram_sym_backward_shapes_follow_the_inputs(kind):
    """Shared kinetics (one decay and sensitivity expanded to every gene)
    and a lengthscale of shape (1,): ``_GramSym.backward`` hands autograd
    gradients it reduces to each leaf's own shape, equal at 1e-12 to
    autograd through the plain version's own tril-and-mirror graph."""
    (x, d, s, l), g, _ = _case(kind)
    tx, tg = torch.as_tensor(x), torch.as_tensor(g)

    def grads(fn):
        leaves = [torch.tensor(v, dtype=F64, requires_grad=True)
                  for v in ([d[0]], [s[0]], [l])]
        out = fn(tx, leaves[0].expand(G), leaves[1].expand(G), leaves[2], kind)
        return torch.autograd.grad(out, leaves, tg, allow_unused=True)

    for got, want in zip(grads(cuda_gram.gram_sym), grads(cuda_gram.gram_sym_plain)):
        if want is None:  # 'ff' depends on no decay or sensitivity
            assert got is None or torch.all(got == 0)
            continue
        assert got.shape == (1,)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0)


def test_force_rows_credit_no_gene():
    """Force rows carry gene -1, which the gathers clamp to gene 0. With no
    expression row of gene 0, gene 0's decay and sensitivity gradients are
    exactly 0; and with the cotangent zero on every entry that touches a
    force row, the other genes' gradients are those of the expression rows
    alone under kind 'xx'."""
    rng = np.random.default_rng(13)
    n = 50
    x = _rows(rng, n, "mixed", genes=(1, G))
    d, s, l = _kinetics(rng)
    g = rng.standard_normal((n, n))
    expr = x[:, 2] == 1
    g_expr = g * np.outer(expr, expr)
    args = [torch.as_tensor(a) for a in (x, d, s, l)]
    needs = NEEDS["kinetics"]
    _, gd, gs, gl = cuda_gram.gram_sym_vjp_plain(*args, "mixed", torch.as_tensor(g), needs)
    assert gd[0] == 0 and gs[0] == 0
    assert torch.all(gd[1:] != 0) and torch.all(gs[1:] != 0)
    mixed = cuda_gram.gram_sym_vjp_plain(*args, "mixed", torch.as_tensor(g_expr), needs)
    alone = cuda_gram.gram_sym_vjp_plain(
        torch.as_tensor(x[expr]), *args[1:], "xx", torch.as_tensor(g_expr[np.ix_(expr, expr)]),
        needs)
    for a, b in zip(mixed[1:], alone[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("fn", ["kernel", "apply"])
def test_gram_sym_backward_kernel_refuses_cpu_tensors(fn):
    """The backward kernel's wrapper runs on CUDA tensors or raises; on a
    CPU tensor only the autograd backward takes the plain version."""
    x = torch.zeros(4, 3, dtype=F64)
    d = torch.ones(G, dtype=F64)
    if fn == "kernel":
        with pytest.raises(ValueError, match="CUDA"):
            cuda_gram.gram_sym_bwd_kernel(x, d, d, torch.tensor(1.0, dtype=F64), "xx",
                                          torch.ones(4, 4, dtype=F64))
    else:
        dd = d.clone().requires_grad_(True)
        out = cuda_gram.gram_sym(x, dd, d, torch.tensor(1.0, dtype=F64), "xx")
        (gd,) = torch.autograd.grad(out.sum(), (dd,))
        assert gd.shape == (G,) and torch.isfinite(gd).all()


# ---------------------------------------------------------------------------
# K3's split 3xTF32 products, emulated in numpy: each operand split into
# hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away, 10
# mantissa bits, as cvt.rna.tf32.f32), products lo*hi + hi*lo + hi*hi exact
# in float32 (11 x 11 significant bits), summed in float32 over each 32-deep
# k slice and the slices added in float32, as csrc/syrk.cu does. On a real
# SIMM Li its error against the f64 product is at most twice the plain
# float32 product's: the split itself keeps f32 faithfulness (the card's
# tensor-core accumulation is checked against the same limit there).
# ---------------------------------------------------------------------------

K3_SLICE = 32


def _tf32(x):
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _syrk_3xtf32_emulated(Li):
    hi = _tf32(Li)
    lo = _tf32(Li - hi)
    n = Li.shape[0]
    acc = np.zeros((n, n), np.float32)
    for k0 in range(0, n, K3_SLICE):
        k = slice(k0, k0 + K3_SLICE)
        acc += (lo[k].T @ hi[k] + hi[k].T @ lo[k]) + hi[k].T @ hi[k]
    return np.tril(acc)


def _real_li(n_genes, n_times):
    """float32 L^-1 of a real dense-route Sigma (gene-major rows on a
    shared grid, init kinetics, unit noise)."""
    t = torch.linspace(0, 12, n_times, dtype=F64).repeat(n_genes)
    g = torch.arange(n_genes, dtype=F64).repeat_interleave(n_times)
    x = torch.stack([t, g, torch.ones_like(t)], -1)
    K = tgram.cross_covariance_kind(x, x, torch.full((n_genes,), 0.4, dtype=F64),
                                    torch.ones(n_genes, dtype=F64), torch.tensor(2.5, dtype=F64),
                                    "xx")
    n = x.shape[0]
    L = torch.linalg.cholesky((K + (1 + 1e-6) * torch.eye(n, dtype=F64)).float())
    Li = torch.linalg.solve_triangular(L, torch.eye(n), upper=False)
    return Li.numpy()


def test_tf32_rounding_is_nearest_ties_away():
    """The emulation's rounding: 10 mantissa bits kept, halfway cases away
    from zero, both signs."""
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)
    xs = np.array([1 + ulp / 2, 1 + ulp / 2 - 2.0**-20, -(1 + ulp / 2), 1 + 3 * ulp / 2],
                  dtype=np.float32)
    np.testing.assert_array_equal(
        _tf32(xs), np.array([one + ulp, one, -(one + ulp), one + 2 * ulp], dtype=np.float32))
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0**-11)
    assert np.all(np.abs(x - hi - lo) <= np.abs(x) * 2.0**-21)


@pytest.mark.parametrize("n_genes,n_times", [(5, 60), (3, 101)])
def test_k3_split_3xtf32_error_within_twice_fp32(n_genes, n_times):
    Li = _real_li(n_genes, n_times)
    truth = np.tril(Li.astype(np.float64).T @ Li.astype(np.float64))
    scale = np.abs(truth).max()
    e_split = np.abs(_syrk_3xtf32_emulated(Li) - truth).max() / scale
    e_plain = np.abs(np.tril(Li.T @ Li) - truth).max() / scale
    assert e_split <= 2 * e_plain, (e_split, e_plain)
    # Single-pass TF32 is what the split exists to avoid: far outside.
    e_tf32 = np.abs(np.tril(_tf32(Li).T @ _tf32(Li)) - truth).max() / scale
    assert e_tf32 > 10 * e_plain


# ---------------------------------------------------------------------------
# F1: the predictions factor with the model's engine, as JAX's do.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def canonical():
    X, y, var = jtrain_arrays(JP53Data(replicate=0, source="synthetic", seed=0))
    return (X, y, var), convert.arrays_from_numpy(X, y, var, device="cpu")


def _params():
    rng = np.random.default_rng(5)
    p = jsimm.init_params(5)
    return p._replace(
        decay=p.decay * jnp.asarray(rng.uniform(0.7, 1.5, 5)),
        sensitivity=p.sensitivity * jnp.asarray(rng.uniform(0.8, 1.2, 5)),
        lengthscale=jnp.asarray(1.9),
    )


@pytest.mark.parametrize("method", ["latent_predict", "multi_gene_predict"])
def test_blocked_predictions_take_the_blocked_engine_and_match_jax(canonical, method,
                                                                  monkeypatch):
    (X, y, var), (tX, ty, tvar) = canonical
    rows = np.stack([np.linspace(0, 13, 30), -np.ones(30), np.zeros(30)], -1)
    if method == "multi_gene_predict":
        rows = np.stack([np.tile(np.linspace(0, 13, 8), 5), np.repeat(np.arange(5.0), 8),
                         np.zeros(40)], -1)
    p = _params()
    jmodel = jsimm.ExactSIMM(num_genes=5, jitter=1e-4, chol_impl="blocked")
    ref = jax.jit(lambda p: getattr(jmodel, method)(p, jnp.asarray(rows), X, y, var))(p)

    calls = []
    blocked = cuda_cholesky.blocked_cholesky

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return blocked(*args, **kwargs)

    monkeypatch.setattr(cuda_cholesky, "blocked_cholesky", spy)
    tmodel = simm.ExactSIMM(num_genes=5, jitter=1e-4, chol_impl="blocked")
    got = getattr(tmodel, method)(convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, device="cpu"),
        torch.as_tensor(rows), tX, ty, tvar)
    assert calls == [(X.shape[0], X.shape[0])]
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(ref.cov), rtol=1e-8, atol=1e-10)
