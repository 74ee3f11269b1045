"""K1 and K2 (``ops.cuda_gram`` -> ``csrc/simm_gram.cu``) against the bytes a
request needs: the N x N training Gram, the N x M cross-covariance and the
M x M test Gram, each written once in the configuration's dtype, at
3.35 TB/s. Percent; None without them."""

from lfmbench import counts

GRAMS = r"gram_sym_kernel|gram_rect_kernel"


def read(r):
    spent = r.timeline.kernel_seconds(GRAMS)
    if spent <= 0.0:
        return None
    dt = r.cfg["dtype"]
    nbytes = (counts.gram_bytes(r.n, r.n, dt) + counts.gram_bytes(r.n, r.m, dt)
              + counts.gram_bytes(r.m, r.m, dt))
    return 100.0 * r.units * counts.bound_seconds(nbytes=nbytes, dtype=dt) / spent
