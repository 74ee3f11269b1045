"""Faults planted under the timed path, to show that the comparison sees them.

Each is a context manager that patches the program while it is open. Every
program family module (``families/<family>.py``) names the sites on its own
path in ``FAULTS``, a dict from a fault kind to a function of no arguments
that returns the context manager (``patched`` helps). The dense families
(``simm``, ``simm2``) name ``dense``, the kinds below at the dense routes'
sites:

- ``unchanged``: an optimizer step returns the parameters it was given
  (``training.generic.apply_updates``); a prediction returns the answer to
  the first request it was asked;
- ``half``: half of the rows left out and the rest counted double (the
  log-density over the first half of its rows, times two; a prediction
  conditioned on the first half of the training rows);
- ``altered``: an answer altered where it is produced (the log-density
  scaled by 1 + 1e-3; the first entry of a prediction's mean moved by a
  hundredth of the largest).

A single card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

KINDS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` while the context is open."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def kinds(family) -> tuple:
    """The fault kinds that a cell of the family module ``family`` can have."""
    return tuple(family.FAULTS)


def plant(kind: str, family):
    """The context manager of fault ``kind``, at the sites that the family
    module ``family`` names."""
    return family.FAULTS[kind]()


def dense(kind: str):
    """The context manager of fault ``kind`` at the dense routes' sites."""
    from dis_project_tpu_torch.models import simm
    from dis_project_tpu_torch.ops import mll
    from dis_project_tpu_torch.training import generic

    logpdf = mll.mvn_logpdf
    predict = simm.ExactSIMM.multi_gene_predict
    stack = contextlib.ExitStack()
    if kind == "unchanged":
        first = {}

        def stale(self, params, test_rows, x, y, variances):
            return first.setdefault("answer", predict(self, params, test_rows, x, y, variances))

        stack.enter_context(patched(generic, "apply_updates", lambda params, updates: params))
        stack.enter_context(patched(simm.ExactSIMM, "multi_gene_predict", stale))
    elif kind == "half":
        def half_logpdf(y, mean, sigma, impl="xla", kernels=True):
            h = y.shape[0] // 2
            return 2.0 * logpdf(y[:h], mean[:h], sigma[:h, :h].contiguous(), impl, kernels)

        def half_predict(self, params, test_rows, x, y, variances):
            h = x.shape[0] // 2
            return predict(self, params, test_rows, x[:h], y.reshape(-1)[:h],
                           variances.reshape(-1)[:h])

        stack.enter_context(patched(mll, "mvn_logpdf", half_logpdf))
        stack.enter_context(patched(simm.ExactSIMM, "multi_gene_predict", half_predict))
    elif kind == "altered":
        def altered_logpdf(*args, **kwargs):
            return logpdf(*args, **kwargs) * (1.0 + 1e-3)

        def altered_predict(self, *args):
            post = predict(self, *args)
            mean = post.mean.clone()
            mean[0] += 1e-2 * mean.abs().max()
            return post._replace(mean=mean)

        stack.enter_context(patched(mll, "mvn_logpdf", altered_logpdf))
        stack.enter_context(patched(simm.ExactSIMM, "multi_gene_predict", altered_predict))
    else:
        raise ValueError(f"unknown fault {kind!r}")
    return stack
