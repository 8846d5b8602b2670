"""Weights and train state across the two packages: ``repro``'s parameter
pytree, with every leaf passed through ``np.asarray``, becomes the port's
params (the same nesting of dicts, lists and tuples of tensors, layer
leaves keeping their leading L axis), so both packages compute the same
function on the same weights. A whole train state crosses the same way in
both directions: ``{"params", "opt": {"m", "v", "count"}, "step"}``, the
layout of both packages' ``init_train_state``."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dicts, lists and tuples of array-likes -> the same nesting of
    tensors on ``device`` (dtypes kept, so a train state's ``count`` and
    ``step`` stay int32; leaves are copied)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    """The port's params or train state -> the same nesting of host numpy
    arrays (``jax.numpy.asarray`` of each leaf gives ``repro``'s)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
