"""Logical-axis sharding, as in ``repro/sharding/specs.py``: model code
names *logical* axes and a rule table maps them onto the axes of a mesh, a
``torch.distributed.device_mesh.DeviceMesh`` here.

What the serving path needs is ported: the rule tables, the mesh context
(``use_mesh`` / ``active_mesh``), the resolution (``resolve``,
``axis_size``, ``_fit_axes``) and the tensor-parallel serving helpers.
Tensor parallelism runs SPMD over ``torch.distributed``, one process per
rank: every rank holds the replicated weights and runs the same engine on
the same inputs, but holds only its kv-head slab of the page pool, runs
the attention core on its own query heads (``head_shard_axis``,
``head_slab``) and all-gathers the head outputs before the output
projection (``replicate``). That is the torch form of the reference's
``shard_map`` design, and like it keeps every float reduction un-split, so
tp > 1 serves bit for bit what tp = 1 serves. ``shard``, ``spec_tree`` and
``shardings_for`` (GSPMD constraints for training) are not ported.

Outside a mesh context every helper is the identity, so models run
untouched on one device."""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Tuple, Union

import torch

Logical = Union[str, None, Tuple[str, ...]]

# logical axis -> mesh axis (or tuple of mesh axes); entries whose mesh
# axes are absent from the active mesh drop at resolution time
DEFAULT_RULES: Tuple[Tuple[str, Logical], ...] = (
    ("batch", ("pod", "data")),      # data parallel over pod x data
    ("seq_sp", "model"),             # sequence parallelism
    ("heads", "model"),              # tensor-parallel attention heads
    ("kv_heads", "model"),
    ("d_ff", "model"),               # tensor-parallel MLP
    ("vocab", "model"),
    ("expert", "model"),             # expert parallel
    ("fsdp", "data"),                # ZeRO-3 weight sharding
    ("kv_seq", None),                # the KV cache's sequence dim
    ("stage", "pod"),                # pipeline axis
)

# pipeline-parallel pods: batch over "data" only, stage over "pod"
PIPELINE_RULES: Tuple[Tuple[str, Logical], ...] = tuple(
    ("batch", "data") if k == "batch" else (k, v) for k, v in DEFAULT_RULES
)

# serving: weights sharded over the model axis only (no optimizer state
# exists at serve time, so ZeRO-3 sharding buys nothing)
SERVE_RULES: Tuple[Tuple[str, Logical], ...] = tuple(
    (k, None) if k == "fsdp" else (k, v) for k, v in DEFAULT_RULES
)

# tensor-parallel serving: every logical axis resolves to None, so the
# whole dataflow outside the head-sharded attention core stays replicated.
# Replicated projections, per-head attention and an all-gather of the head
# outputs before the output projection make a tp > 1 tick bitwise equal to
# tp = 1 (no float sum is split across ranks).
TP_SERVE_RULES: Tuple[Tuple[str, Logical], ...] = tuple(
    (k, None) for k, _ in DEFAULT_RULES
)

# rules used only to place the paged KV pool: the kv-head axis shards over
# 'model'; page ids and page rows are shard-invariant, so block tables and
# the host-side allocator and prefix index stay replicated
TP_POOL_RULES: Tuple[Tuple[str, Logical], ...] = (("kv_heads", "model"),)

# logical axes of one paged K/V pool leaf (L, num_pages, page_size, KV, hd)
KV_POOL_AXES: Tuple[Logical, ...] = (None, None, None, "kv_heads", None)

# the mesh axis the serve engine uses for tensor parallelism, checked
# against the mesh's names directly (the tp serving rules map every
# logical axis to None); "replica" groups the tp groups of a larger world
TP_AXIS = "model"
REPLICA_AXIS = "replica"


class _Ctx:
    def __init__(self, mesh, rules):
        self.mesh = mesh
        self.rules = dict(rules) if rules else {}


_CTX: contextvars.ContextVar[_Ctx] = contextvars.ContextVar(
    "shard_ctx", default=_Ctx(None, DEFAULT_RULES))


@contextlib.contextmanager
def use_mesh(mesh, rules=DEFAULT_RULES):
    token = _CTX.set(_Ctx(mesh, rules))
    try:
        yield mesh
    finally:
        _CTX.reset(token)


def active_mesh():
    return _CTX.get().mesh


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> dict:
    """Mesh axis name -> size."""
    return dict(zip(axis_names(mesh), mesh.shape))


def _resolve_one(logical: Logical, mesh) -> Logical:
    if logical is None:
        return None
    rules = _CTX.get().rules
    mapped = rules.get(logical, None) if isinstance(logical, str) else logical
    if mapped is None:
        return None
    if isinstance(mapped, str):
        mapped = (mapped,)
    names = axis_names(mesh)
    present = tuple(a for a in mapped if a in names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def resolve(*logical_axes: Logical) -> tuple:
    """The mesh axes each logical axis resolves to under the active mesh
    (the entries of the reference's ``PartitionSpec``): None, an axis name
    or a tuple of names."""
    mesh = active_mesh()
    if mesh is None:
        return (None,) * len(logical_axes)
    return tuple(_resolve_one(a, mesh) for a in logical_axes)


def axis_size(logical: Logical) -> int:
    """Product of the mesh-axis sizes a logical axis resolves to (1 if
    unmapped)."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    resolved = _resolve_one(logical, mesh)
    if resolved is None:
        return 1
    if isinstance(resolved, str):
        resolved = (resolved,)
    sizes = mesh_shape(mesh)
    size = 1
    for a in resolved:
        size *= sizes[a]
    return size


def _fit_axes(shape, logical_axes):
    """Drop logical axes whose resolved mesh size does not divide the dim
    (or is 1): the shape-aware fallback to replication."""
    out = []
    for dim, ax in zip(shape, logical_axes):
        out.append(ax if (ax is not None and dim % max(axis_size(ax), 1) == 0
                          and axis_size(ax) > 1) else None)
    return tuple(out)


def tp_degree(mesh) -> int:
    """Size of ``mesh``'s tensor-parallel axis (1 without one)."""
    if mesh is None:
        return 1
    return mesh_shape(mesh).get(TP_AXIS, 1)


def head_shard_axis(num_heads: int, num_kv_heads: int):
    """The head-sharding decision of a paged-attention call site:
    ``(mesh, axis_name)`` when the active mesh has a >1-sized
    :data:`TP_AXIS` dividing both head counts (each rank then owns whole
    GQA groups: kv head ``k`` and its query heads ``k*G .. k*G+G-1`` stay
    together), else ``(None, None)`` (the single-device dispatch)."""
    mesh = active_mesh()
    if mesh is None or TP_AXIS not in axis_names(mesh):
        return None, None
    tp = tp_degree(mesh)
    if tp <= 1 or num_kv_heads % tp or num_heads % tp:
        return None, None
    return mesh, TP_AXIS


def latent_head_shard_axis(num_heads: int):
    """``head_shard_axis`` for the MLA latent path: the latent pool has no
    kv-head axis, so only the query-head count needs to divide the mesh."""
    mesh = active_mesh()
    if mesh is None or TP_AXIS not in axis_names(mesh):
        return None, None
    tp = tp_degree(mesh)
    if tp <= 1 or num_heads % tp:
        return None, None
    return mesh, TP_AXIS


def head_slab(n: int, mesh, axis: str = TP_AXIS) -> slice:
    """This rank's contiguous share of ``n`` heads (``n`` divisible by the
    axis size): rank r of the axis holds heads r * n / tp .. (r+1) * n / tp
    - 1, so a concatenation in rank order is the head order."""
    tp = mesh_shape(mesh)[axis]
    r = mesh.get_local_rank(axis)
    return slice(r * (n // tp), (r + 1) * (n // tp))


def serve_trace(mesh, fn):
    """Wrap a step function so it runs inside the tensor-parallel serving
    mesh context (identity when mesh is None): every
    ``head_shard_axis`` / ``replicate`` in model code then resolves
    against ``mesh`` under :data:`TP_SERVE_RULES`."""
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with use_mesh(mesh, TP_SERVE_RULES):
            return fn(*args, **kwargs)
    return wrapped


def check_serve_group(tp: int, device_type: str = "cuda") -> None:
    """Hold a serving ``tp`` against the current process group (one process
    per rank): tp must lie in 1 .. its size and divide it. With no process
    group, tp = 1 makes a one-rank group from an in-process store (no
    network: NCCL for CUDA, gloo for the CPU)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp < 1 or tp > world or world % tp:
        raise ValueError(
            f"tp={tp} needs 1..{world} ranks in the process group, dividing "
            f"its size (one process per rank: init_process_group, or "
            f"torchrun --nproc-per-node=N with each rank's own device)")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)


def serve_mesh(tp: int, device_type: str = "cuda"):
    """The 1-axis serving mesh named :data:`TP_AXIS` over this rank's group
    of ``tp`` consecutive ranks of the current process group (ranks r // tp
    * tp .. + tp - 1: a world of N ranks holds N / tp tp groups, each
    serving on its own). Every rank of the world must call it, with the
    same ``tp``, in the same order: the groups are made collectively."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} must divide the process group's "
                         f"{world} ranks")
    if world == tp:
        return init_device_mesh(device_type, (tp,),
                                mesh_dim_names=(TP_AXIS,))
    return init_device_mesh(device_type, (world // tp, tp),
                            mesh_dim_names=(REPLICA_AXIS, TP_AXIS))[TP_AXIS]


def _host_staged(x, group) -> bool:
    """gloo moves host memory: a CUDA tensor goes through the host."""
    import torch.distributed as dist
    return x.is_cuda and str(dist.get_backend(group)) == "gloo"


def all_gather(x, dim: int, mesh, axis: str = TP_AXIS):
    """Every rank's ``x`` of ``mesh``'s ``axis`` group, concatenated along
    ``dim`` in rank order (through the host where the group is gloo's)."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    staged = _host_staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def replicate(x, dim: int = -1):
    """The head-sharded attention output, all-gathered along its head axis
    ``dim`` and concatenated in rank order, under a tp > 1 mesh (the
    identity otherwise). The tensor-parallel serving path calls it right
    BEFORE the output projection: the one collective of a layer, and
    putting it before ``wo`` (not a sum of partial projections after it)
    keeps the contraction un-split and the tick bitwise equal to tp = 1."""
    mesh = active_mesh()
    if mesh is None or tp_degree(mesh) <= 1:
        return x
    return all_gather(x, dim, mesh)


def replicate_params(params, mesh):
    """Make every rank of ``mesh``'s tp group hold the first rank's
    parameters (a broadcast of each tensor leaf, in place; identity
    without a mesh or at tp = 1). Replicated weights keep every
    contraction un-split, which makes a tp > 1 tick bitwise equal to
    tp = 1."""
    if mesh is None or tp_degree(mesh) <= 1:
        return params
    import torch.distributed as dist
    from repro_torch.tree import tree_leaves
    group = mesh.get_group(TP_AXIS)
    src = dist.get_global_rank(group, 0)
    for leaf in tree_leaves(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        if _host_staged(leaf, group):
            tmp = leaf.cpu()
            dist.broadcast(tmp, src, group=group)
            leaf.copy_(tmp)
        else:
            dist.broadcast(leaf, src, group=group)
    return params
