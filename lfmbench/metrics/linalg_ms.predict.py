"""Device milliseconds per request of the posterior's linear algebra
(``ops.mll.cholesky`` and ``chol_solve``, and the products of the mean and
the covariance in ``ExactSIMM.multi_gene_predict``): every kernel launched
inside the Cholesky, triangular-solve and matrix-product operators. None
when no kernel was launched there."""

LINALG_OPS = (r"aten::linalg_cholesky_ex|aten::linalg_solve_triangular"
              r"|aten::matmul|aten::mm$|aten::mv$")


def read(r):
    spent = r.timeline.launched_under(LINALG_OPS)
    if spent <= 0.0 or r.units <= 0:
        return None
    return 1e3 * spent / r.units
