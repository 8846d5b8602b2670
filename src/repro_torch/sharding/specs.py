"""Logical-axis sharding, as in ``repro/sharding/specs.py``: model code
names *logical* axes and a rule table maps them onto the axes of a mesh, a
``torch.distributed.device_mesh.DeviceMesh`` here.

The rule tables, the mesh context (``use_mesh`` / ``active_mesh``) and
the resolution (``resolve``, ``axis_size``, ``_fit_axes``) serve both
halves. Tensor-parallel serving runs SPMD over ``torch.distributed``, one process per
rank: every rank holds the replicated weights and runs the same engine on
the same inputs, but holds only its kv-head slab of the page pool, runs
the attention core on its own query heads (``head_shard_axis``,
``head_slab``) and all-gathers the head outputs before the output
projection (``replicate``). That is the torch form of the reference's
``shard_map`` design, and like it keeps every float reduction un-split, so
tp > 1 serves bit for bit what tp = 1 serves.

The training half places arrays on the mesh as DTensors: ``placements``
turns logical axes into one DTensor ``Placement`` per mesh dim,
``sharding_for`` / ``spec_tree`` / ``shardings_for`` build
:class:`NamedSharding` trees (shape-aware through ``_fit_axes``),
``distribute`` keeps each rank's block of a full tensor and
``full_tensor`` gathers one back. ``shard`` redistributes a DTensor (the
reference's sharding constraint); the sharded steps themselves live in
``sharding.spmd``. Collectives on CUDA tensors over a gloo group go
through the host, so one code path serves gloo and NCCL. The collectives
a step runs (``all_gather``, ``reduce_scatter``, ``all_reduce`` and the
neighbour send ``shift``) report what they move to ``COLLECTIVES`` while
the dry run records them (``launch.hlo_stats.collectives``).

Outside a mesh context every helper is the identity, so models run
untouched on one device."""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Optional, Tuple, Union

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


# while ``launch.hlo_stats.collectives`` records: the list that every
# collective below appends its (kind, result bytes, group size) to
COLLECTIVES: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "collectives", default=None)


def _record(kind: str, result, group) -> None:
    records = COLLECTIVES.get()
    if records is not None:
        import torch.distributed as dist
        records.append((kind, result.numel() * result.element_size(),
                        dist.get_world_size(group)))


def _host_staged(x, group) -> bool:
    """gloo moves host memory: a CUDA tensor goes through the host."""
    import torch.distributed as dist
    return x.is_cuda and str(dist.get_backend(group)) == "gloo"


def all_gather(x, dim: int, mesh, axis=TP_AXIS):
    """Every rank's ``x`` of ``mesh``'s ``axis`` group (a mesh dim's name
    or index), concatenated along ``dim`` in rank order (through the host
    where the group is gloo's)."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    staged = _host_staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    _record("all-gather", out, group)
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


# ------------------------------------------------------------------ training
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one DTensor placement per mesh dim: the port's
    ``jax.sharding.NamedSharding``."""
    mesh: Any
    placements: tuple


def placements(*logical_axes: Logical) -> tuple:
    """One DTensor placement per dim of the active mesh: ``Shard(d)`` on
    each mesh dim that tensor dim ``d``'s logical axis resolves to (a
    logical axis over two mesh dims, "batch" over ("pod", "data"), shards
    one tensor dim over both, the outer first), ``Replicate()`` elsewhere.
    Not divisibility-aware: see :func:`sharding_for`."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = active_mesh()
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(resolve(*logical_axes)):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two tensor dims "
                                 f"of {logical_axes}")
            out[i] = Shard(dim)
    return tuple(out)


def named_sharding(*logical_axes: Logical) -> Optional[NamedSharding]:
    mesh = active_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, placements(*logical_axes))


def shard(x, *logical_axes: Logical):
    """The reference's sharding constraint: identity without a mesh (the
    rank is then never checked); under one, a rank mismatch raises, a
    DTensor is redistributed to the fitted placements and a local tensor
    is returned unchanged (SPMD code already holds its block)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(f"rank mismatch: array rank {x.ndim} vs "
                         f"{len(logical_axes)} logical axes")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(*_fit_axes(x.shape,
                                                      logical_axes)))


def sharding_for(shape, logical_axes) -> Optional[NamedSharding]:
    """Shape-aware ``named_sharding`` for one array: logical axes whose
    mesh size does not divide the dim drop (replicated). None without a
    mesh."""
    if active_mesh() is None:
        return None
    return named_sharding(*_fit_axes(tuple(shape), logical_axes))


def _is_logical_leaf(v) -> bool:
    return isinstance(v, tuple) and all(
        isinstance(a, (str, type(None), tuple)) for a in v)


def spec_tree(tree_of_logical):
    """A tree of logical-axis tuples -> the same tree of
    :class:`NamedSharding` (None without a mesh)."""
    if _is_logical_leaf(tree_of_logical):
        return named_sharding(*tree_of_logical)
    if isinstance(tree_of_logical, dict):
        return {k: spec_tree(v) for k, v in tree_of_logical.items()}
    return type(tree_of_logical)(spec_tree(v) for v in tree_of_logical)


def shardings_for(tree_of_logical, shapes_tree):
    """Shape-aware :func:`spec_tree`: one :class:`NamedSharding` per leaf
    of ``shapes_tree`` (tensors, meta tensors included), its logical axes
    fitted to that leaf's shape. The result takes ``shapes_tree``'s
    nesting."""
    if _is_logical_leaf(tree_of_logical):
        return sharding_for(shapes_tree.shape, tree_of_logical)
    if isinstance(shapes_tree, dict):
        if set(shapes_tree) != set(tree_of_logical):
            raise ValueError(f"trees differ: {sorted(shapes_tree)} vs "
                             f"{sorted(tree_of_logical)}")
        return {k: shardings_for(tree_of_logical[k], v)
                for k, v in shapes_tree.items()}
    if len(shapes_tree) != len(tree_of_logical):
        raise ValueError("trees differ in length")
    return type(shapes_tree)(shardings_for(lg, v) for lg, v in
                             zip(tree_of_logical, shapes_tree))


def shard_dims(sharding: NamedSharding) -> list:
    """[(mesh dim, tensor dim)] of every ``Shard`` placement, outer mesh
    dims first."""
    from torch.distributed.tensor import Shard
    return [(i, p.dim) for i, p in enumerate(sharding.placements)
            if isinstance(p, Shard)]


def local_block(full, sharding: NamedSharding):
    """This rank's block of ``full`` (a view): each ``Shard(d)`` mesh dim,
    outer first, cuts dim d into equal blocks and keeps the rank's."""
    out = full
    for i, d in shard_dims(sharding):
        n = sharding.mesh.size(i)
        r = sharding.mesh.get_local_rank(i)
        size = out.shape[d] // n
        out = out.narrow(d, r * size, size)
    return out


def distribute(full, sharding: Optional[NamedSharding], device=None):
    """``full`` (the same on every rank) as a DTensor that holds only this
    rank's block, copied to ``device`` (``full``'s by default; no
    communication). A sharding of None gives ``full`` on ``device``."""
    device = device or full.device
    if sharding is None:
        return full.to(device)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        local_block(full, sharding).to(device, copy=True), sharding.mesh,
        sharding.placements, run_check=False)


def sharding_of(x) -> Optional[NamedSharding]:
    """A DTensor's :class:`NamedSharding` (None for a local tensor)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return None
    return NamedSharding(x.device_mesh, tuple(x.placements))


def full_tensor(local, sharding: Optional[NamedSharding]):
    """The full tensor whose rank block is ``local``: gathered over each
    ``Shard`` mesh dim, inner first (a collective over the mesh)."""
    if sharding is None:
        return local
    out = local
    for i, d in reversed(shard_dims(sharding)):
        out = all_gather(out, d, sharding.mesh, i)
    return out


def relayout(local, src: NamedSharding, dst: NamedSharding):
    """A block under ``src`` as the block under ``dst`` of the same full
    tensor (gathered, then cut; identity when the two agree)."""
    if tuple(src.placements) == tuple(dst.placements):
        return local
    return local_block(full_tensor(local, src), dst)


def reduce_scatter(x, dim: int, mesh, mesh_dim):
    """``x`` summed over ``mesh``'s ``mesh_dim`` group (name or index), and
    of that sum this rank's block along ``dim`` (the group's ranks in
    order); through the host where the group is gloo's."""
    import torch.distributed as dist
    group = mesh.get_group(mesh_dim)
    n = dist.get_world_size(group)
    staged = _host_staged(x, group)
    src = (x.detach().to("cpu") if staged else x.detach()).movedim(
        dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    _record("reduce-scatter", out, group)
    out = out.movedim(0, dim)
    return out.to(x.device) if staged else out


def all_reduce(x, mesh, mesh_dims, op: str = "sum"):
    """``x`` reduced (``op``: "sum" or "max") over the groups of
    ``mesh_dims`` (names or indices) in turn; a new tensor, through the
    host where the group is gloo's."""
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = x
    for md in mesh_dims:
        group = mesh.get_group(md)
        staged = _host_staged(out, group)
        buf = out.detach().to("cpu", copy=True) if staged else \
            out.detach().clone()
        dist.all_reduce(buf, op=red, group=group)
        _record("all-reduce", buf, group)
        out = buf.to(x.device) if staged else buf
    return out


def shift(x, mesh, axis=TP_AXIS, step: int = 1):
    """The neighbour send of ``ppermute`` with ``perm = [(s, s + 1)]``: rank
    r of ``mesh``'s ``axis`` group gets rank r - 1's ``x`` and rank 0 gets
    zeros (``step=-1``: rank r + 1's, the last rank zeros); point to
    point, through the host where the group is gloo's."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    r = mesh.get_local_rank(axis)
    staged = _host_staged(x, group)
    src = (x.detach().cpu() if staged else x.detach()).contiguous()
    out = torch.zeros_like(src)
    ops = []
    if 0 <= r + step < n:
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(group, r + step), group))
    if 0 <= r - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, r - step), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _record("collective-permute", out, group)
    return out.to(x.device) if staged else out
