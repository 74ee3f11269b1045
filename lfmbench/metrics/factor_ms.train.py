"""Device milliseconds per training step of the exact MLL engine
(``ops.mll``): every kernel launched inside its log-density's forward and
backward (the custom autograd function ``_MvnLogpdfCentered``): cuSOLVER's
factor, L^-1's products, the solves, Sigma^-1 and the cotangent's
assembly. The hand-written Sigma^-1 kernel of the float32 route (K3) is
left out, for a roofline of its own. None when no kernel was launched
there."""

MLL_OPS = r"_MvnLogpdfCentered"
K3 = r"syrk_ltl_tril_kernel"


def read(r):
    spent = r.timeline.launched_under(MLL_OPS, exclude=K3)
    if spent <= 0.0 or r.units <= 0:
        return None
    return 1e3 * spent / r.units
