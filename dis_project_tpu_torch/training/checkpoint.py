"""Checkpoints of training state (parameters, optimizer state, step) with
resume.

Port of ``dis_project_tpu/training/checkpoint.py``: :func:`save` /
:func:`restore` round-trip a tree and :func:`latest_step` supports resume.
orbax is not available to the port, so a checkpoint is one ``torch.save``
file, ``directory/step_{step}.pt``, written to a temporary name and moved
into place with ``os.replace``: a killed process never leaves half a
checkpoint behind. Tensors round-trip bitwise and load onto the device the
caller names.

A tree is any nesting of dicts, lists, tuples and NamedTuples over
tensors, numbers and None. The file holds the tree's leaves and a
description of its structure; :func:`restore` with a ``template`` puts the
leaves into the template's structure and raises ``ValueError`` when the
two structures differ (the caller's cue for a legacy layout, as orbax's
restore raises on a tree-structure mismatch).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch


def _flatten(tree, leaves):
    """Append ``tree``'s leaves to ``leaves``; return its structure as
    plain containers (kept in the file; no classes are pickled)."""
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"namedtuple": [type(tree).__name__, list(tree._fields),
                               [_flatten(v, leaves) for v in tree]]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, leaves) for v in tree]}
    leaves.append(tree)
    return {"leaf": len(leaves) - 1}


def _plain(structure, leaves):
    """The tree of ``structure`` with plain containers (no template)."""
    (kind, body), = structure.items()
    if kind == "leaf":
        return leaves[body]
    if kind == "dict":
        return {k: _plain(v, leaves) for k, v in body.items()}
    if kind == "namedtuple":
        return dict(zip(body[1], (_plain(v, leaves) for v in body[2])))
    items = [_plain(v, leaves) for v in body]
    return tuple(items) if kind == "tuple" else items


def _fill(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _fill(v, leaves) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_fill(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(v, leaves) for v in template)
    return next(leaves)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order (depth first, fields in order, as
    ``jax.tree.leaves``)."""
    leaves = []
    _flatten(tree, leaves)
    return leaves


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` in order."""
    return _fill(like, iter(leaves))


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.pt")


def save(directory: str, tree: Any, step: int) -> str:
    """Save ``tree`` as ``directory/step_{step}.pt``. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    leaves = []
    structure = _flatten(tree, leaves)
    leaves = [leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf
              for leaf in leaves]
    path = _path(directory, step)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save({"structure": structure, "leaves": leaves}, tmp)
    os.replace(tmp, path)
    return path


def restore(directory: str, step: int, template: Optional[Any] = None,
            device=None) -> Any:
    """The tree saved at ``step``: in ``template``'s structure when one is
    given (``ValueError`` when the saved structure differs), else in plain
    dicts, lists and tuples. Tensors load onto ``device`` (default: the
    device of the template's first tensor, else the CPU)."""
    want = []
    structure = None if template is None else _flatten(template, want)
    if device is None:
        device = next((t.device for t in want if isinstance(t, torch.Tensor)), "cpu")
    payload = torch.load(_path(directory, step), map_location=device, weights_only=True)
    if template is None:
        return _plain(payload["structure"], payload["leaves"])
    if structure != payload["structure"]:
        raise ValueError(
            f"checkpoint step {step} in {directory} does not have the template's structure"
        )
    return _fill(template, iter(payload["leaves"]))


def latest_step(directory: str) -> Optional[int]:
    """The largest step saved in ``directory``; None when there is none."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)\.pt", name))]
    return max(steps) if steps else None
