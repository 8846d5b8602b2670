"""Gradient compression for the data-parallel all-reduce, with error
feedback, as ``repro/optim/grad_compress.py``.

At scale the data-parallel gradient reduction is the dominant collective;
int8 values cut its bytes 4x against fp32. SPMD over ``torch.distributed``
(one process per rank, where ``repro`` runs a ``shard_map`` over the data
axes): each rank adds its error feedback, quantizes its gradient on a scale
common to the data ranks (an all-reduce max), sums the int8 values as
int32 over the data ranks, dequantizes and takes the mean, and keeps its
own quantization residual as the next step's error feedback (EF-SGD).
A library function: the trainer does not call it, as in ``repro``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.sharding import specs
from repro_torch.tree import tree_map


def quantize_int8(g, scale_floor: float = 1e-12):
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=scale_floor) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_tree(grads, error, mesh, axis_names: Tuple[str, ...],
                         n_shards: int):
    """Per leaf (this rank's gradient and error feedback): EF-add -> int8
    on a scale common to ``axis_names``' ranks -> int32 sum over them ->
    dequantize -> mean. The shared scale makes sum(q_i) * scale ==
    sum(q_i * scale); the wire carries int32 instead of fp32. Returns
    (mean_grads, new_error)."""
    def one(g, e):
        g = g + e
        amax = specs.all_reduce(torch.max(torch.abs(g)), mesh, axis_names,
                                "max")
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        total = specs.all_reduce(q.to(torch.int32), mesh, axis_names)
        new_e = g - q.float() * scale          # the local residual
        mean = total.float() * scale / n_shards
        return mean.to(g.dtype), new_e.to(g.dtype)
    pairs = tree_map(one, grads, error)
    mean = tree_map(lambda g, p: p[0], grads, pairs)
    new_e = tree_map(lambda g, p: p[1], grads, pairs)
    return mean, new_e


def make_compressed_allreduce(mesh, param_specs=None,
                              dp_axes=("pod", "data")):
    """``allreduce(grads, error) -> (mean_grads, new_error)``, the
    compressed reduction over ``dp_axes`` of ``mesh`` (those it has).
    Leaves are each rank's gradient blocks: DTensors, or local tensors;
    with ``param_specs`` (a tree of ``specs.NamedSharding``) the results
    are DTensors of those shardings."""
    names = specs.axis_names(mesh)
    axes = tuple(a for a in dp_axes if a in names)
    n = 1
    for a in axes:
        n *= specs.mesh_shape(mesh)[a]

    def local(t):
        return t.to_local() if specs.sharding_of(t) is not None else t

    def allreduce(grads, error):
        mean, new_e = compressed_psum_tree(
            tree_map(local, grads), tree_map(local, error), mesh, axes, n)
        if param_specs is None:
            return mean, new_e
        from torch.distributed.tensor import DTensor

        def wrap(t, sh):
            return DTensor.from_local(t, sh.mesh, sh.placements,
                                      run_check=False)
        return (tree_map(wrap, mean, param_specs),
                tree_map(wrap, new_e, param_specs))
    return allreduce


def init_error(params):
    return tree_map(torch.zeros_like, params)
