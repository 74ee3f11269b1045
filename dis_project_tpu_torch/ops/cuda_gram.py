"""SIMM covariance kernels K1 (rectangular) and K2 (symmetric), K2's
backward kernel, and their plain PyTorch versions.

Port of ``dis_project_tpu/ops/pallas_gram.py``:

- :func:`cross_covariance` — K1, ``csrc/simm_gram.cu::gram_rect_kernel``,
  replacing ``pallas_gram.py::_gram_kernel``: the dense (N, M) covariance.
- :func:`gram_sym` — K2, ``csrc/simm_gram.cu::gram_sym_kernel``, replacing
  ``pallas_gram.py::_gram_sym_kernel``: the square Gram over lower-triangle
  tiles only, each off-diagonal tile mirrored by a transposed second write.
- K2's gradient — ``csrc/simm_gram.cu::gram_sym_bwd_kernel``
  (:func:`gram_sym_bwd_kernel`), replacing the XLA fusion of
  ``pallas_gram.py::_gram_sym_bwd``: the gradient with respect to decay,
  sensitivity and lengthscale over the same lower tiles, reading both
  triangles of the (not necessarily symmetric) cotangent, in reverse mode
  written by hand.

All three evaluate the closed form in a hoisted arrangement: the terms that
depend on one row only once per row, the rest per entry.
:func:`cross_covariance_hoisted` (K1) and :func:`gram_sym_hoisted` (K2 and
its backward, adjoints included) write that arithmetic out in PyTorch, on
one shared helper; tests and ``chip_smoke.py`` hold it to the closed form.

All take (t, gene, flag) rows, gene indices clamped as ``ops.gram`` clamps
them, and evaluate the closed form of ``kind`` ∈ {'xx', 'ff', 'xf', 'fx',
'mixed'}. K2 and its backward take per-row ``[t, decay, sens, flag]``
metadata packed here (:func:`pack_meta`); K1 takes the rows as they are and
gathers decay and sensitivity in the kernel.

Dispatch: on a CUDA tensor the wrapper launches the kernel (float32 or
float64) or raises; on a CPU tensor it takes the plain version — never a
fallback from one to the other. Each launch adds one to ``LAUNCHES``.

Gradients: ``torch.autograd.Function``s. K1's backward differentiates the
plain ``ops.gram.cross_covariance_kind`` closed form, as the JAX package's
``_ccov_bwd`` does. K2's backward launches ``gram_sym_bwd_kernel`` on a
CUDA tensor; the gradient with respect to the rows ``x`` (which no main
path asks for) is the plain VJP, counted in ``PLAIN_X_GRADS``. Flag
columns carry no gradient under a declared kind.
"""

from __future__ import annotations

import ctypes

import torch

from dis_project_tpu_torch.ops import cuda_build
from dis_project_tpu_torch.ops import gram as gram_ops
from dis_project_tpu_torch.ops import lfm_kernels as lfk

KIND_CODES = {"xx": 0, "ff": 1, "xf": 2, "fx": 3, "mixed": 4}
# A square Gram is a covariance only for these populations; 'xf'/'fx' on one
# row set is not symmetric, and the JAX kernel's answer for it depends on its
# tile size (diagonal tiles are computed whole, off-diagonal ones mirrored).
SYM_KINDS = ("xx", "ff", "mixed")

# Plain-integer launch counters, one per kernel.
LAUNCHES = {"gram_rect": 0, "gram_sym": 0, "gram_sym_bwd": 0}
# Plain VJPs that K2's backward runs on a CUDA tensor for the gradient with
# respect to the rows x (the kernel gives decay, sens and lengthscale only).
PLAIN_X_GRADS = {"gram_sym_x": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # (x1, n, x2, m, decay, sens, G, ell, out, kind, stream)
    "simm_gram_rect_f32": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P],
    "simm_gram_rect_f64": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P],
    "simm_gram_sym_f32": [_P, _I, _P, _P, _I, _P],
    "simm_gram_sym_f64": [_P, _I, _P, _P, _I, _P],
    # (meta, gene, n, G, ell, g, grad, kind, stream)
    "simm_gram_sym_bwd_f32": [_P, _P, _I, _I, _P, _P, _P, _I, _P],
    "simm_gram_sym_bwd_f64": [_P, _P, _I, _I, _P, _P, _P, _I, _P],
}
# Largest dynamic shared memory of the backward's 2G+1 float64 bins.
_BWD_BINS_MAX_BYTES = 160 * 1024
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def pack_meta(x, decay, sens):
    """(N, 3) rows -> contiguous (4, N) ``[t, decay, sens, flag]``."""
    t, g, f = gram_ops.split_rows(x)
    return torch.stack(
        [t, gram_ops._gather(decay, g), gram_ops._gather(sens, g), f]
    ).contiguous()


def _check_cuda_inputs(xs, decay, sens, lengthscale, kind):
    tensors = (*xs, decay, sens, lengthscale)
    dev = xs[0].device
    dtype = xs[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"SIMM Gram kernel runs on CUDA tensors, not {dev}")
    for a in tensors:
        if a.device != dev:
            raise ValueError(f"SIMM Gram kernel: tensors on {a.device} and {dev}")
        if a.dtype != dtype:
            raise ValueError(f"SIMM Gram kernel: dtypes {a.dtype} and {dtype} differ")
    if dtype not in _SUFFIX:
        raise TypeError(f"SIMM Gram kernel takes float32 or float64, not {dtype}")
    for x in xs:
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"rows must be (N, 3), got {tuple(x.shape)}")
    if decay.dim() != 1 or sens.shape != decay.shape or decay.numel() == 0:
        raise ValueError("decay and sens must be matching non-empty (G,) vectors")
    if lengthscale.numel() != 1:
        raise ValueError("lengthscale must be a scalar")
    if kind not in KIND_CODES:
        raise ValueError(f"unknown kind {kind!r}")
    return dev, dtype


def gram_rect_kernel(x1, x2, decay, sens, lengthscale, kind="mixed"):
    """Launch K1 on CUDA tensors: the (N, M) covariance. The kernel reads
    the rows and gathers decay and sensitivity itself: no launch besides
    its own and the output's allocation for contiguous inputs."""
    dev, dtype = _check_cuda_inputs((x1, x2), decay, sens, lengthscale, kind)
    x1, x2 = x1.contiguous(), x2.contiguous()
    decay, sens = decay.contiguous(), sens.contiguous()
    ell = lengthscale.reshape(1).contiguous()
    n, m = x1.shape[0], x2.shape[0]
    out = torch.empty((n, m), dtype=dtype, device=dev)
    lib = cuda_build.load("simm_gram", SIGNATURES)
    fn = getattr(lib, f"simm_gram_rect_{_SUFFIX[dtype]}")
    with torch.cuda.device(dev):
        code = fn(x1.data_ptr(), n, x2.data_ptr(), m, decay.data_ptr(), sens.data_ptr(),
                  decay.shape[0], ell.data_ptr(), out.data_ptr(), KIND_CODES[kind],
                  cuda_build.stream_handle(dev))
    LAUNCHES["gram_rect"] += 1
    cuda_build.check(code, "simm_gram_rect")
    return out


def _check_sym_kind(kind):
    if kind not in SYM_KINDS:
        raise ValueError(f"a square Gram takes kind in {SYM_KINDS}, not {kind!r}")


def gram_sym_kernel(x, decay, sens, lengthscale, kind="mixed"):
    """Launch K2 on CUDA tensors: the (N, N) Gram from its lower triangle."""
    _check_sym_kind(kind)
    dev, dtype = _check_cuda_inputs((x,), decay, sens, lengthscale, kind)
    meta = pack_meta(x, decay, sens)
    ell = lengthscale.reshape(1).contiguous()
    n = x.shape[0]
    out = torch.empty((n, n), dtype=dtype, device=dev)
    lib = cuda_build.load("simm_gram", SIGNATURES)
    fn = getattr(lib, f"simm_gram_sym_{_SUFFIX[dtype]}")
    with torch.cuda.device(dev):
        code = fn(meta.data_ptr(), n, ell.data_ptr(), out.data_ptr(),
                  KIND_CODES[kind], cuda_build.stream_handle(dev))
    LAUNCHES["gram_sym"] += 1
    cuda_build.check(code, "simm_gram_sym")
    return out


def gram_sym_plain(x, decay, sens, lengthscale, kind="mixed"):
    """Plain version of K2: the closed form's lower triangle, mirrored —
    exactly what the kernel writes."""
    _check_sym_kind(kind)
    K = gram_ops.cross_covariance_kind(x, x, decay, sens, lengthscale, kind)
    return torch.tril(K) + torch.tril(K, -1).T


def gram_sym_bwd_kernel(x, decay, sens, lengthscale, kind, g):
    """Launch K2's backward on CUDA tensors: the gradient of
    ``<g, gram_sym(x, decay, sens, lengthscale, kind)>`` with respect to
    ``decay`` (G,), ``sens`` (G,) and ``lengthscale`` (shaped like it), for
    an (N, N) cotangent ``g`` that need not be symmetric. Each entry's
    partials are in the working dtype, every sum in float64; the result
    comes back in the working dtype."""
    _check_sym_kind(kind)
    dev, dtype = _check_cuda_inputs((x,), decay, sens, lengthscale, kind)
    n, G = x.shape[0], decay.shape[0]
    if g.shape != (n, n):
        raise ValueError(f"cotangent must be ({n}, {n}), got {tuple(g.shape)}")
    if (2 * G + 1) * 8 > _BWD_BINS_MAX_BYTES:
        raise ValueError(f"K2 backward: {G} genes need more shared memory than a CTA has")
    meta = pack_meta(x, decay, sens)
    gene = x[:, 1].to(torch.int32).contiguous()  # unclamped; the kernel clamps
    ell = lengthscale.reshape(1).contiguous()
    g = g.to(dtype).contiguous()
    grad = torch.zeros(2 * G + 1, dtype=torch.float64, device=dev)
    lib = cuda_build.load("simm_gram", SIGNATURES)
    fn = getattr(lib, f"simm_gram_sym_bwd_{_SUFFIX[dtype]}")
    with torch.cuda.device(dev):
        code = fn(meta.data_ptr(), gene.data_ptr(), n, G, ell.data_ptr(), g.data_ptr(),
                  grad.data_ptr(), KIND_CODES[kind], cuda_build.stream_handle(dev))
    LAUNCHES["gram_sym_bwd"] += 1
    cuda_build.check(code, "simm_gram_sym_bwd")
    grad = grad.to(dtype)
    return grad[:G], grad[G:2 * G], grad[2 * G].reshape(lengthscale.shape)


def gram_sym_vjp_plain(x, decay, sens, lengthscale, kind, g, needs):
    """Plain version of K2's backward: the VJP of the closed form
    ``cross_covariance_kind(x, x, ...)`` against ``g`` for the inputs
    flagged in ``needs`` (x, decay, sens, lengthscale; None for the
    others), as the JAX package's ``_gram_sym_bwd`` takes it."""
    _check_sym_kind(kind)
    return plain_vjp(
        lambda x, d, s, l: gram_ops.cross_covariance_kind(x, x, d, s, l, kind),
        (x, decay, sens, lengthscale), needs, g,
    )


_TWO_OVER_SQRT_PI = 1.1283791670955126


def _hoisted_rows(x, decay, sens, lengthscale):
    """The one-index quantities the kernels stage per row (their ``RowQ``):
    t, t/l, D, S, flag, gamma = D l / 2, E = exp(gamma^2), e = exp(-D t),
    r = e (erf(t/l - gamma) + erf(gamma)), K1's C = c l S E, and r's
    derivatives in D and l (K2's backward)."""
    t, gi, f = gram_ops.split_rows(x)
    l = lengthscale
    D, S = gram_ops._gather(decay, gi), gram_ops._gather(sens, gi)
    gam = D * l * 0.5
    tl = t / l
    E = torch.exp(gam * gam)
    e = torch.exp(-D * t)
    u = tl - gam
    r = e * (torch.erf(u) + torch.erf(gam))
    C = (0.5 * lfk.SQRT_PI) * l * S * E
    phi_u = _TWO_OVER_SQRT_PI * torch.exp(-(u * u))
    phi_g = _TWO_OVER_SQRT_PI / E
    r_D = -t * r + e * (l * 0.5) * (phi_g - phi_u)
    r_l = e * (phi_u * (-tl / l - D * 0.5) + phi_g * (D * 0.5))
    return dict(t=t, tl=tl, D=D, S=S, f=f, gam=gam, E=E, e=e, r=r, C=C, r_D=r_D, r_l=r_l)


def _hoisted_entries(rows, cols, lengthscale, kind):
    """The per-entry terms of K1 and K2 (``csrc/simm_gram.cu``: ``mid``,
    ``sym_value``, ``entry_value``) between the row tables ``rows`` (N) and
    ``cols`` (M) of :func:`_hoisted_rows`, in the kernels' order: a dict of
    the (N, M) terms the kind needs, its value under ``"K"``, and the
    broadcast tables under ``"a"`` (rows) and ``"b"`` (columns).

    Entry (a, b), with delta = t_a - t_b, x = delta / l, q = 1/(D_a + D_b):
    A1 = exp(-D_a delta) (erf(x - gamma_a) + erf(t_b/l + gamma_a)),
    A2 = exp(D_b delta) (erf(-x - gamma_b) + erf(t_a/l + gamma_b)),
    U = c l q (E_a (A1 - r_a e_b) + E_b (A2 - r_b e_a)), c = sqrt(pi)/2:
    k_xx = S_a S_b U, k_xf = C_a A1 (K1; 'mixed' takes S_a c l E_a A1),
    k_fx = C_b A2. The kernels read erf(t_b/l + gamma_a) and erf(t_a/l +
    gamma_b) from per-tile tables of (gamma, time) pairs where a tile side
    holds few distinct gammas: the same values, so not repeated here; and
    they take q from the hardware reciprocal and one Newton step (within an
    ulp of the quotient here)."""
    l = lengthscale
    a = {k: v[:, None] for k, v in rows.items()}
    b = {k: v[None, :] for k, v in cols.items()}
    delta = a["t"] - b["t"]
    m = dict(a=a, b=b, delta=delta, cl=(0.5 * lfk.SQRT_PI) * l)
    if kind != "xx":
        m["kff"] = torch.exp(-(delta * delta) / (2.0 * l))
    if kind == "ff":
        m["K"] = m["kff"]
        return m
    xq = delta / l
    if kind == "xf":
        m["K"] = a["C"] * (torch.exp(-a["D"] * delta)
                           * (torch.erf(xq - a["gam"]) + torch.erf(b["tl"] + a["gam"])))
        return m
    if kind == "fx":
        m["K"] = b["C"] * (torch.exp(b["D"] * delta)
                           * (torch.erf(-xq - b["gam"]) + torch.erf(a["tl"] + b["gam"])))
        return m
    cl = m["cl"]
    u1, u2 = xq - a["gam"], b["tl"] + a["gam"]
    u3, u4 = -xq - b["gam"], a["tl"] + b["gam"]
    X1, X2 = torch.exp(-a["D"] * delta), torch.exp(b["D"] * delta)
    A1 = X1 * (torch.erf(u1) + torch.erf(u2))
    A2 = X2 * (torch.erf(u3) + torch.erf(u4))
    Pa, Pb = A1 - a["r"] * b["e"], A2 - b["r"] * a["e"]
    q = 1.0 / (a["D"] + b["D"])
    U = cl * q * (a["E"] * Pa + b["E"] * Pb)
    m.update(xq=xq, u1=u1, u2=u2, u3=u3, u4=u4, X1=X1, X2=X2, A1=A1, A2=A2, Pa=Pa, Pb=Pb,
             q=q, U=U)
    if kind == "xx":
        m["K"] = a["S"] * b["S"] * U
        return m
    fa, fb = a["f"], b["f"]
    w = {"xx": fa * fb, "ff": (1.0 - fa) * (1.0 - fb), "xf": fa * (1.0 - fb),
         "fx": (1.0 - fa) * fb}
    Q1, Q2 = cl * a["E"] * A1, cl * b["E"] * A2
    m.update(w=w, Q1=Q1, Q2=Q2)
    m["K"] = (w["xx"] * (a["S"] * b["S"] * U) + w["ff"] * m["kff"] + w["xf"] * (a["S"] * Q1)
              + w["fx"] * (b["S"] * Q2))
    return m


def cross_covariance_hoisted(x1, x2, decay, sens, lengthscale, kind="mixed"):
    """Plain PyTorch version of K1's arithmetic (``csrc/simm_gram.cu``,
    ``gram_rect_kernel``): per-row tables of both row sets, then the
    per-entry terms of ``kind``, in the kernel's order. The (N, M)
    covariance; no gradient. Only tests and ``chip_smoke.py`` call it."""
    if kind not in KIND_CODES:
        raise ValueError(f"unknown kind {kind!r}")
    with torch.no_grad():
        return _hoisted_entries(_hoisted_rows(x1, decay, sens, lengthscale),
                                _hoisted_rows(x2, decay, sens, lengthscale),
                                lengthscale, kind)["K"]


def gram_sym_hoisted(x, decay, sens, lengthscale, kind="mixed", g=None):
    """Plain PyTorch version of the arithmetic of K2 and K2's backward in
    ``csrc/simm_gram.cu``: the per-row tables, the per-entry terms
    (:func:`_hoisted_entries`, shared with K1's version) and the
    hand-derived reverse-mode adjoints, in the kernels' order. Only tests
    and ``chip_smoke.py`` call it; it holds the derivation to the closed
    form before any kernel runs.

    Returns the exactly symmetric (N, N) Gram and, when a cotangent ``g``
    (N, N, need not be symmetric) is given, also the gradient of
    ``<g, K>`` with respect to ``(decay, sens, lengthscale)``: each entry's
    partials in the working dtype, their products with the cotangent and
    every sum after in float64, decay and sensitivity credited only from
    the kind's expression rows, each to its clamped gene."""
    _check_sym_kind(kind)
    l = lengthscale
    rows = _hoisted_rows(x, decay, sens, l)
    m = _hoisted_entries(rows, rows, l, kind)
    K = torch.tril(m["K"]) + torch.tril(m["K"], -1).T
    if g is None:
        return K
    a, b, delta, cl = m["a"], m["b"], m["delta"], m["cl"]
    zero = torch.zeros_like(delta)
    kff = m.get("kff", zero)

    # Reverse sweep from the seeds (adjoints of U, k_xf_u, k_fx_u, k_ff):
    # each entry's partials of K, in the working dtype.
    if kind == "xx":
        Ub, Q1b, Q2b, Fb = a["S"] * b["S"], zero, zero, zero
    elif kind == "ff":
        Ub, Q1b, Q2b, Fb = zero, zero, zero, torch.ones_like(delta)
    else:
        w = m["w"]
        Ub, Q1b, Q2b, Fb = w["xx"] * a["S"] * b["S"], w["xf"] * a["S"], w["fx"] * b["S"], w["ff"]
    il = 1.0 / l
    p_l = Fb * kff * ((delta * delta) / (2.0 * l) / l)
    p_Da = p_Db = p_Sa = p_Sb = zero
    if kind != "ff":
        xq, u1, u2, u3, u4, X1, X2, A1, A2, Pa, Pb, q, U = (m[k] for k in (
            "xq", "u1", "u2", "u3", "u4", "X1", "X2", "A1", "A2", "Pa", "Pb", "q", "U"))
        Q1, Q2 = m.get("Q1", zero), m.get("Q2", zero)
        Vb = Ub * cl * q
        p_Da = p_Db = -Ub * U * q
        p_l = p_l + (Ub * U + Q1b * Q1 + Q2b * Q2) * il
        Ab1 = a["E"] * (Vb + Q1b * cl)
        Ab2 = b["E"] * (Vb + Q2b * cl)
        Eba = Vb * Pa + Q1b * cl * A1
        Ebb = Vb * Pb + Q2b * cl * A2
        Pba, Pbb = Vb * a["E"], Vb * b["E"]
        rba, eb_b = -Pba * b["e"], -Pba * a["r"]
        rbb, eb_a = -Pbb * a["e"], -Pbb * b["r"]
        Fb12, Fb34 = Ab1 * X1, Ab2 * X2
        phi = lambda u: _TWO_OVER_SQRT_PI * torch.exp(-(u * u))  # noqa: E731
        ub1, ub2, ub3, ub4 = Fb12 * phi(u1), Fb12 * phi(u2), Fb34 * phi(u3), Fb34 * phi(u4)
        s12, s34 = ub2 - ub1, ub4 - ub3
        p_Da = (p_Da - delta * Ab1 * A1 + (l * 0.5) * s12
                + Eba * (a["E"] * a["gam"] * l) + rba * a["r_D"] + eb_a * (-a["t"] * a["e"]))
        p_Db = (p_Db + delta * Ab2 * A2 + (l * 0.5) * s34
                + Ebb * (b["E"] * b["gam"] * l) + rbb * b["r_D"] + eb_b * (-b["t"] * b["e"]))
        p_l = (p_l - (xq * (ub1 - ub3) + b["tl"] * ub2 + a["tl"] * ub4) * il
               + (a["D"] * 0.5) * s12 + (b["D"] * 0.5) * s34
               + Eba * (a["E"] * a["gam"] * a["D"]) + Ebb * (b["E"] * b["gam"] * b["D"])
               + rba * a["r_l"] + rbb * b["r_l"])
        if kind == "xx":
            p_Sa, p_Sb = b["S"] * U, a["S"] * U
        else:
            p_Sa = w["xx"] * b["S"] * U + w["xf"] * Q1
            p_Sb = w["xx"] * a["S"] * U + w["fx"] * Q2

    # K2 writes tril(K) + tril(K, -1)^T: entry (a, b), a > b, carries
    # g_ab + g_ba, the diagonal g_aa; float64 from here on.
    g64 = g.to(torch.float64)
    W = torch.tril(g64, -1) + torch.tril(g64.T, -1) + torch.diag(torch.diagonal(g64))
    G = decay.shape[0]
    gene = torch.clamp(x[:, 1].to(torch.long), 0, G - 1)
    expr = torch.ones_like(rows["f"], dtype=torch.bool) if kind == "xx" else rows["f"] != 0
    by_row = lambda pa, pb: (W * pa.double()).sum(1) + (W * pb.double()).sum(0)  # noqa: E731
    grads = []
    for pa, pb in ((p_Da, p_Db), (p_Sa, p_Sb)):
        acc = torch.zeros(G, dtype=torch.float64, device=x.device)
        if kind != "ff":
            acc.index_add_(0, gene[expr], by_row(pa, pb)[expr])
        grads.append(acc.to(x.dtype))
    gl = (W * p_l.double()).sum().to(x.dtype).reshape(lengthscale.shape)
    return K, (grads[0], grads[1], gl)


def plain_vjp(fn, inputs, needs_grad, grad_out):
    """Gradients of ``fn(*inputs)`` against ``grad_out`` for the inputs
    flagged in ``needs_grad`` (None for the others) — the backward of every
    kernel wrapper: differentiate the plain version."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(bool(nd)) for a, nd in zip(inputs, needs_grad)]
        out = fn(*leaves)
        wanted = [a for a, nd in zip(leaves, needs_grad) if nd]
        # An output that depends on none of them (k_ff and the kinetics)
        # has no graph: every gradient is None.
        grads = iter(torch.autograd.grad(
            out, wanted, grad_out.to(out.dtype), allow_unused=True
        ) if out.requires_grad else [None] * len(wanted))
    return tuple(next(grads) if nd else None for nd in needs_grad)


class _CrossCovariance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, decay, sens, lengthscale, kind):
        ctx.save_for_backward(x1, x2, decay, sens, lengthscale)
        ctx.kind = kind
        if x1.is_cuda:
            return gram_rect_kernel(x1, x2, decay, sens, lengthscale, kind)
        return gram_ops.cross_covariance_kind(x1, x2, decay, sens, lengthscale, kind)

    @staticmethod
    def backward(ctx, g):
        kind = ctx.kind
        grads = plain_vjp(
            lambda *a: gram_ops.cross_covariance_kind(*a, kind),
            ctx.saved_tensors, ctx.needs_input_grad[:5], g,
        )
        return (*grads, None)


class _GramSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, decay, sens, lengthscale, kind):
        ctx.save_for_backward(x, decay, sens, lengthscale)
        ctx.kind = kind
        if x.is_cuda:
            return gram_sym_kernel(x, decay, sens, lengthscale, kind)
        return gram_sym_plain(x, decay, sens, lengthscale, kind)

    @staticmethod
    def backward(ctx, g):
        x, decay, sens, lengthscale = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        if not x.is_cuda:
            grads = gram_sym_vjp_plain(x, decay, sens, lengthscale, ctx.kind, g, needs)
            return (*grads, None)
        gx = None
        if needs[0]:
            # The rows' gradient has no kernel: the plain VJP, counted.
            PLAIN_X_GRADS["gram_sym_x"] += 1
            gx = gram_sym_vjp_plain(x, decay, sens, lengthscale, ctx.kind, g,
                                    (True, False, False, False))[0]
        gd = gs = gl = None
        if any(needs[1:]):
            gd, gs, gl = gram_sym_bwd_kernel(x, decay, sens, lengthscale, ctx.kind, g)
        return (gx, gd if needs[1] else None, gs if needs[2] else None,
                gl if needs[3] else None, None)


def cross_covariance(x1, x2, decay, sens, lengthscale, kind="mixed"):
    """Dense (N, M) SIMM covariance (K1 on CUDA, plain on CPU);
    differentiable."""
    return _CrossCovariance.apply(x1, x2, decay, sens, lengthscale, kind)


def gram_sym(x, decay, sens, lengthscale, kind="mixed"):
    """Symmetric (N, N) SIMM Gram from lower-triangle tiles (K2 on CUDA,
    plain on CPU); exactly symmetric, differentiable."""
    return _GramSym.apply(x, decay, sens, lengthscale, kind)
