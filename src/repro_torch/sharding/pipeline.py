"""Pipeline parallelism over the "pod" (or any) mesh axis: the GPipe
schedule of ``repro/sharding/pipeline.py``, SPMD over ``torch.distributed``
(one process per stage rank) where ``repro`` runs a ``shard_map`` with
``collective_permute``.

Each stage owns L/P contiguous layers (stage-stacked params). The
microbatches run over n_micro + P - 1 ticks; at each tick a stage applies
its layers to the activation it holds and sends the result to the next
stage. Bubble fraction = (P-1)/(n_micro+P-1), the GPipe bound. A library
function, as in ``repro``: ``specs.PIPELINE_RULES`` maps "batch" to the
data axis only and the stage params onto "stage".
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding import specs
from repro_torch.tree import tree_map


def _send_next(y, buf, mesh, axis: str, stage: int, n_stages: int):
    """Stage ``stage`` sends ``y`` to the next stage and receives the
    previous stage's into ``buf`` (the ring's wraparound is unused, so the
    last stage sends nothing and the first receives nothing); through the
    host where the group is gloo's."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    staged = specs._host_staged(y, group)
    reqs, recv = [], None
    if stage + 1 < n_stages:
        src = y.detach().to("cpu", copy=True) if staged else y.contiguous()
        reqs.append(dist.isend(src, dist.get_global_rank(group, stage + 1),
                               group=group))
    if stage > 0:
        recv = torch.empty_like(buf, device="cpu") if staged else \
            torch.empty_like(buf)
        reqs.append(dist.irecv(recv, dist.get_global_rank(group, stage - 1),
                               group=group))
    for r in reqs:
        r.wait()
    return buf if recv is None else recv.to(buf.device)


def make_pipeline(mesh, stage_fn: Callable, params_spec=None, *,
                  stage_axis: str = "pod", n_micro: int):
    """GPipe pipeline for stage-stacked params.

    stage_fn(stage_params, x) -> x applies ONE stage's layers.

    Returns pipe(stage_params, x_micro), called by every rank of the
    mesh alike:
      stage_params leaves: [P, ...] on their leading dim over stage_axis;
        with ``params_spec`` (a tree of ``specs.NamedSharding``) the full
        tensors, else DTensors or each rank's [1, ...] block
      x_micro: (n_micro, B_micro, ...), the same on every rank
      -> (n_micro, B_micro, ...) the last stage's outputs, on every rank
    """
    n_stages = specs.mesh_shape(mesh)[stage_axis]

    def block(t, sh=None):
        if sh is not None:
            t = specs.local_block(t, sh)
        elif specs.sharding_of(t) is not None:
            t = t.to_local()
        return t[0]

    def pipe(stage_params, x_micro):
        params = (tree_map(block, stage_params) if params_spec is None else
                  tree_map(block, stage_params, params_spec))
        stage = mesh.get_local_rank(stage_axis)
        buf = torch.zeros_like(x_micro[0])
        outs = torch.zeros_like(x_micro)
        for t in range(n_micro + n_stages - 1):
            x_in = x_micro[t if t < n_micro else 0] if stage == 0 else buf
            active = 0 <= t - stage < n_micro
            y = stage_fn(params, x_in) if active else x_in
            if active and stage == n_stages - 1:
                outs[t - (n_stages - 1)] = y
            buf = _send_next(y, buf, mesh, stage_axis, stage, n_stages)
        # every rank gets the last stage's outputs (a masked sum, as the
        # reference broadcasts them)
        mine = outs if stage == n_stages - 1 else torch.zeros_like(outs)
        return specs.all_reduce(mine, mesh, (stage_axis,))
    return pipe


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
