"""AdamW with decoupled weight decay, global-norm clipping and schedule
support over the port's param trees, as ``repro/optim/adamw.py``: not
``torch.optim``, so that the state keeps the reference's ``{"m", "v",
"count"}`` layout (``count`` int32) and a checkpoint moves between the
packages. Every step keeps the reference's order of operations and
dtypes: the clip scale, the moments, the bias corrections computed in
fp32 from ``count``, then the update."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _lr(self, count):
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=count.device)

    def update(self, grads, state, params, shardings=None):
        """(updates, new state, the gradient's global norm before
        clipping). With ``shardings`` (a tree of ``specs.NamedSharding``)
        the leaves are this rank's blocks and the norm is the whole
        mesh's."""
        count = state["count"] + 1
        gn = global_norm(grads, shardings)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                                max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, state["v"],
                     grads)
        c = count.float()
        mhat_scale = 1.0 / (1 - b1 ** c)
        vhat_scale = 1.0 / (1 - b2 ** c)
        lr = self._lr(count)

        def upd(p, mm, vv):
            u = (mm * mhat_scale) / (torch.sqrt(vv * vhat_scale) + self.eps)
            u = u + self.weight_decay * p
            return (-lr * u).to(p.dtype)

        updates = tree_map(upd, params, m, v)
        return updates, {"m": m, "v": v, "count": count}, gn


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``jax.tree.leaves`` order) of each
    leaf's fp32 sum of squares. With ``shardings`` each leaf is a rank's
    block: a block counts on the ranks at coordinate 0 of every mesh dim
    it is replicated over (so once), and the sum is reduced over the whole
    mesh."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in tree_leaves(tree)))
    from torch.distributed.tensor import Shard
    from repro_torch.sharding import specs
    total, mesh = 0.0, None
    for leaf, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        mesh = sh.mesh
        counted = all(isinstance(p, Shard) or mesh.get_local_rank(i) == 0
                      for i, p in enumerate(sh.placements))
        sq = torch.sum(torch.square(leaf.float()))
        total = total + (sq if counted else torch.zeros_like(sq))
    return torch.sqrt(specs.all_reduce(total, mesh,
                                       range(mesh.ndim)))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
