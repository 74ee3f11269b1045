"""The whole training step's share of the card's peak in the
configuration's dtype (165 TFLOP/s f32-faithful; 67 TFLOP/s float64):
the step's flops counted from its shape (``counts.train_step_flops``)
over the seconds a step took in the run's untraced window. Percent."""

from lfmbench import counts


def read(r):
    return 100.0 * counts.train_step_flops(r.n) / (r.unit_s * counts.PEAK_FLOPS[r.cfg["dtype"]])
