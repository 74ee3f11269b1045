"""The whole request's share of the card's peak in the configuration's
dtype (165 TFLOP/s f32-faithful; 67 TFLOP/s float64): the request's flops
counted from its shapes (``counts.predict_flops``) over the seconds a
request took in the run's untraced window. Percent."""

from lfmbench import counts


def read(r):
    flops = counts.predict_flops(r.n, r.m)
    return 100.0 * flops / (r.unit_s * counts.PEAK_FLOPS[r.cfg["dtype"]])
