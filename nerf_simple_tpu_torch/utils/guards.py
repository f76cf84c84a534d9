"""Numerical-health guards (port of nerf_simple_tpu/utils/guards.py).

- ``finite_guard(step, named)``: the train step's check under
  ``debug_nan: true`` (the part JAX's ``checkify`` plays): one host sync
  for all the named tensors, and the first NaN or Inf raises
  ``FloatingPointError`` naming the tensor and the step;
- ``assert_finite(tree, name)``: a host-side check of a nested dict, list
  or tuple of tensors and arrays, raising ``ValueError`` with the leaf's
  path and its counts.
"""

from __future__ import annotations

import numpy as np
import torch


def finite_guard(step: int, named, stage: str = "before Adam") -> None:
    """Raise on the first of the ``(name, tensor)`` pairs (None tensors
    skipped) that holds a NaN or an Inf."""
    named = [(n, t) for n, t in named if t is not None]
    ok = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    if bool(ok.all()):
        return
    name, t = named[int(torch.nonzero(~ok)[0])]
    raise FloatingPointError(
        f"NaN/Inf in {name} at step {step} ({stage}): {int(torch.isnan(t).sum())} NaN, "
        f"{int(torch.isinf(t).sum())} Inf")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, str(i)))
    else:
        yield path, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ValueError if any leaf of ``tree`` holds a NaN or an Inf."""
    for path, leaf in _leaves(tree):
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.isfinite(a).all():
            raise ValueError(f"non-finite values in {name}[{'/'.join(path)}]: {int(np.isnan(a).sum())} NaN, "
                             f"{int(np.isinf(a).sum())} Inf")
