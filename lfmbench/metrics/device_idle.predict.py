"""The share of a request in which the device runs no kernel, copy or set:
one less the union of its intervals per request in the traced window over
the seconds a request took in the run's untraced window. Percent."""


def read(r):
    if r.units <= 0:
        return None
    return 100.0 * (1.0 - r.timeline.busy_s() / r.units / r.unit_s)
