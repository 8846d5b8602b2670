"""Weights across the two packages: ``repro``'s parameter pytree, with every
leaf passed through ``np.asarray``, becomes the port's params (the same
nesting of dicts, lists and tuples of tensors, layer leaves keeping their
leading L axis), so both packages compute the same function on the same
weights."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dicts, lists and tuples of array-likes -> the same nesting of
    tensors on ``device`` (dtypes kept; leaves are copied)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
