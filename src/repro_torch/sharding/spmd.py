"""SPMD training over a ``("data", "model")`` DeviceMesh (``("pod", "data",
"model")`` where asked): one process per rank, each holding its block of
every train-state leaf (``launch.steps.train_state_logical`` placed by
``sharding.specs``) and its rows of the global batch.

Inside the sharded train step (``launch.steps.make_train_step``) the
model's code runs on :class:`LazyParams`: a leaf is gathered where the
model reads it, layer by layer (ZeRO-3's per-layer all-gather), through
:func:`materialize`, whose backward sums the gradient over the mesh dims
whose ranks each gave a part (:func:`reduce_dims_of`) and keeps the
rank's block. While the loss runs, autograd saves each gathered weight as
its block plus the recipe to gather it again, so a rank never holds the
whole gathered model (:func:`regather_saved`).

The dense, MoE and recurrent families' weights keep their ``"model"``
blocks (heads, kv heads, d_ff, vocab, experts; rwkv6's time-mix heads and
channel-mix d_ff, hymba's mamba channels, which share "d_ff" with its
MLP; :func:`tp_keeps`), and the layers run tensor-parallel on them: K5 /
K6 run on the rank's heads or channels. With more than one row dividing
"model" (:func:`seq_split`, the step's ``sp``) the residual keeps the
rank's rows of the sequence between layers, where ``repro`` shards it
over "seq_sp": the rows are gathered before a split product
(:func:`sp_gather`: heads, d_ff, experts, the vocab head, and every
recurrence, which needs each row) and the split products reduce-scattered
back onto the rank's rows (:func:`sp_scatter`: after ``wo``, ``w_down``,
the experts' combine, rwkv6's ``cv``, hymba's ``w_out`` and the vocab
lookup). A token shift on the rank's rows reads the previous rank's last
row (:func:`halo`). Attention whose heads do not divide "model" runs the
rank's query rows against every rank's K / V rows (context parallelism;
a band that fits reads only the rank's rows and a halo), and every weight
the rows reach whole sums its gradient over "model" too. Without ``sp``
(one row, or rows not dividing "model") the residual stays replicated
over "model": :func:`tp_copy` where it enters a split product (identity
forward, sum over "model" backward) and :func:`tp_sum` where the split
products meet; a tensor whole on every rank that a split compute reads
in part (rwkv6's decay, hymba's ``w_B`` rows) is cut by
:func:`tp_narrow`. A MoE layer routes the rank's own dispatch groups where
they divide the batch's ranks (:func:`moe_groups_split`; its aux
statistics summed over those ranks, :func:`batch_sum`), else the groups
of the whole (micro)batch (:func:`gather_rows`); its routing statistics,
whole on every "model" rank, send their gradient once
(:func:`tp_once`). The encoder-decoder and the VLM gather their weights
over the whole mesh, split only the batch and keep the residual
replicated. A windowed attention on a replicated residual (hymba's,
where its rows do not divide "model") runs the banded form over each
"model" rank's own chunks (:func:`sp_own`, :func:`halo`,
:func:`sp_replicate`).

The sharded serving steps (``launch.steps``' prefill and lockstep decode
on params and a dense cache of DTensors) run in the same context without
autograd: a vocab-split head is gathered back to whole logits
(:func:`tp_gather`); a self-attention cache whose sequence is split over
"model" stays the rank's block and the attention runs as flash decode,
each rank's partial softmax merged by :func:`cp_merge` (the step's
``cp_cache``); a recurrent state split over the heads or channels the
rank runs (rwkv6's ``S``, hymba's ``h``) stays the rank's block; another
cache leaf split over a mesh dim that the compute needs whole is read one
layer at a time through :class:`GatheredStack`.

Outside the step nothing here is active and every helper is the
identity."""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Optional, Tuple

import torch

from repro_torch.sharding import specs


@dataclasses.dataclass(frozen=True)
class _Ctx:
    mesh: object
    batch_dims: Tuple[int, ...]     # mesh dims the batch rows split over
    tp: bool                        # tp_keeps keeps a block, "model" > 1
    sp: bool = False                # the residual's rows split over "model"
    cp_cache: bool = False          # the K/V cache's sequence over "model"


_CTX: contextvars.ContextVar[Optional[_Ctx]] = contextvars.ContextVar(
    "spmd_ctx", default=None)


@contextlib.contextmanager
def training(mesh, batch_dims, tp: bool, sp: bool = False,
             cp_cache: bool = False):
    """The sharded step's context (training, and the serving steps too):
    its mesh, the mesh dims its batch rows split over, whether the family
    runs tensor-parallel (:func:`tp_keeps`), whether its residual keeps the
    rank's rows between layers (``sp``, :func:`seq_split`) and whether the
    dense K/V cache holds the rank's block of the sequence (``cp_cache``:
    the lockstep decode's flash-decode form)."""
    token = _CTX.set(_Ctx(mesh, tuple(batch_dims), tp, sp, cp_cache))
    try:
        yield
    finally:
        _CTX.reset(token)


def _ctx() -> Optional[_Ctx]:
    return _CTX.get()


def checkpointed(fn):
    """``fn`` set to run inside the context active now, also when the
    backward recomputes it (``torch.utils.checkpoint``) on autograd's
    device thread, which sees no context of the caller's."""
    c = _ctx()
    if c is None:
        return fn

    def run(*args):
        token = _CTX.set(c)
        try:
            return fn(*args)
        finally:
            _CTX.reset(token)
    return run


# ------------------------------------------------------------- collectives
def _own(x, dim: int, mesh, mesh_dim):
    if isinstance(mesh_dim, str):
        mesh_dim = specs.axis_names(mesh).index(mesh_dim)
    n = mesh.size(mesh_dim)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(mesh_dim) * size, size)


class _Materialize(torch.autograd.Function):
    """Forward: ``local`` gathered along each (mesh dim, tensor dim) of
    ``gathers`` (inner mesh dims first). Backward: the gradient summed
    over ``reduce_dims`` (the batch's mesh dims: each rank's rows gave a
    part) and cut back to the rank's block: a reduce-scatter over each
    mesh dim that is both gathered and reduced (ZeRO-3's "fsdp" over
    "data"), an all-reduce over the other reduced ones, a cut over the
    other gathered ones."""

    @staticmethod
    def forward(ctx, local, mesh, gathers, reduce_dims):
        ctx.mesh, ctx.gathers, ctx.reduce_dims = mesh, gathers, reduce_dims
        out = local
        for i, d in gathers:
            out = specs.all_gather(out, d, mesh, i)
        return out if gathers else out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        gathered = {i for i, _ in ctx.gathers}
        rest = [i for i in ctx.reduce_dims if i not in gathered]
        if rest:
            g = specs.all_reduce(g, ctx.mesh, rest)
        for i, d in reversed(ctx.gathers):
            g = (specs.reduce_scatter(g, d, ctx.mesh, i)
                 if i in ctx.reduce_dims else _own(g, d, ctx.mesh, i))
        return g.contiguous(), None, None, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return specs.all_reduce(g, ctx.mesh, (specs.TP_AXIS,)), None


class _SumTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return specs.all_reduce(x, mesh, (specs.TP_AXIS,))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _OnceTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.first = mesh.get_local_rank(specs.TP_AXIS) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


class _SumBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return specs.all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return specs.all_reduce(g, ctx.mesh, ctx.dims), None, None


class _GatherRows(torch.autograd.Function):
    """Rows (dim 0) of every rank of the batch's mesh dims, in the
    placement's order; backward sums the row gradients over those ranks and
    keeps the rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        out = x
        for i in reversed(dims):
            out = specs.all_gather(out, 0, mesh, i)
        return out

    @staticmethod
    def backward(ctx, g):
        g = specs.all_reduce(g, ctx.mesh, ctx.dims)
        for i in ctx.dims:
            g = _own(g, 0, ctx.mesh, i)
        return g.contiguous(), None, None


def tp_split(w) -> Optional[int]:
    """The dim of a gathered weight that stays split over "model" for the
    tensor-parallel compute (None: the weight is whole)."""
    return getattr(w, "_tp_split", None)


def tp_copy(x):
    """A replicated activation entering a product split over "model"."""
    c = _ctx()
    return _CopyToTP.apply(x, c.mesh) if c is not None and c.tp else x


def tp_sum(x):
    """The products split over "model", summed on every rank."""
    c = _ctx()
    return _SumTP.apply(x, c.mesh) if c is not None and c.tp else x


def tp_once(x):
    """A value computed whole on every "model" rank from rows whose
    gradients are the ranks' parts (the MoE's routing statistics under
    :func:`sp_on`): identity forward; the backward keeps the gradient on
    "model" rank 0 and gives zeros elsewhere, so it is counted once where
    the parts are summed."""
    c = _ctx()
    return _OnceTP.apply(x, c.mesh) if c is not None and c.sp else x


def tp_narrow(x, dim: int, n: int):
    """The rank's ``n`` entries along ``dim`` of a tensor whole on every
    "model" rank that a compute split over "model" reads in part (rwkv6's
    decay before the rank's heads, hymba's ``w_B`` / ``w_C`` / ``w_dtA``
    rows at the rank's channels): under :func:`sp_on` a plain narrow, whose
    gradient stays the rank's part (summed where the rows were gathered or
    the leaf is read, :func:`reduce_dims_of`); otherwise through
    :func:`tp_copy`, so its gradient is whole on every rank."""
    c = _ctx()
    if c is None or not c.tp:
        return x
    if not c.sp:
        x = _CopyToTP.apply(x, c.mesh)
    return x.narrow(dim, model_rank() * n, n)


def tp_max(x):
    """The max over "model" (no gradient: a shift for a stable exp)."""
    c = _ctx()
    if c is None or not c.tp:
        return x
    return specs.all_reduce(x.detach(), c.mesh, (specs.TP_AXIS,), "max")


def tp_gather(x, w, dim: int = -1):
    """The products of a weight ``w`` split over "model" along its output
    columns (a vocab-split head, hymba's conv carry from ``w_in``),
    gathered along ``dim`` on every rank; identity for a whole ``w``.
    Serving only: no gradient."""
    c = _ctx()
    if c is None or not c.tp or tp_split(w) is None:
        return x
    return specs.all_gather(x, dim, c.mesh, specs.TP_AXIS)


def vocab_lookup(table, ids):
    """Embedding lookup in a vocab-split table: the rank's rows, zero for
    ids it does not hold, summed over "model" (under :func:`sp_on`
    reduce-scattered onto the rank's rows of the sequence)."""
    vl = table.shape[0]
    local = ids.long() - model_rank() * vl
    ok = (local >= 0) & (local < vl)
    rows = torch.where(ok[..., None], table[local.clamp(0, vl - 1)], 0)
    return sp_scatter(rows) if sp_on() else tp_sum(rows)


def batch_split() -> int:
    """How many ways the batch rows split (1 outside the step)."""
    c = _ctx()
    n = 1
    if c is not None:
        for i in c.batch_dims:
            n *= c.mesh.size(i)
    return n


def batch_sum(x):
    """``x`` summed over the batch's ranks (an all-reduce; identity when
    the batch is not split). Every rank's loss reads the sum, each at 1 /
    ``batch_split`` of the global loss, so the backward all-reduces too."""
    c = _ctx()
    if c is None or not c.batch_dims:
        return x
    return _SumBatch.apply(x, c.mesh, c.batch_dims)


def moe_groups_split(tokens: int, group_size: int) -> bool:
    """Whether a MoE call on the rank's ``tokens`` routes only its own
    dispatch groups, as ``repro`` shards its (G, Sg, D) groups over
    "batch" where ``_fit_axes`` lets it: the batch split n > 1 divides G =
    max(1, T // group_size) of the global T = ``tokens`` * n. The rank
    then holds G / n whole groups of ``repro``'s Sg and capacity;
    otherwise the call gathers every rank's rows (:func:`gather_rows`)."""
    n = batch_split()
    return n > 1 and max(1, tokens * n // group_size) % n == 0


def gather_rows(x):
    """Every rank's rows of ``x`` (the whole (micro)batch), identity when
    the batch is not split."""
    c = _ctx()
    if c is None or not c.batch_dims:
        return x
    return _GatherRows.apply(x, c.mesh, c.batch_dims)


def own_rows(x):
    """This rank's rows of a whole-batch ``x`` (:func:`gather_rows`)."""
    c = _ctx()
    if c is None or not c.batch_dims:
        return x
    for i in c.batch_dims:
        x = _own(x, 0, c.mesh, i)
    return x


# ---------------------------------------------------- rows over "model"
# Inside a step whose residual keeps the rank's rows of the sequence
# (``sp``), a (B, S, ...) activation on a rank holds rows
# [r * S / M, (r + 1) * S / M) of "model" rank r of M. Two pairs of
# functions move rows. ``sp_gather`` / ``sp_scatter`` border a split
# compute (heads, d_ff or vocab over "model", or a rank's own query rows),
# whose gradients are the ranks' parts and are summed where they meet, as
# every weight that the rows reach whole is summed over "model" too
# (:func:`reduce_dims_of`). ``sp_own`` / ``sp_replicate`` border a
# compute on the rank's rows inside a replicated one (the banded form's
# chunks of a replicated residual), whose gradients are whole on every
# rank. ``halo`` is the banded form's neighbour send.
class _GatherSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return specs.all_gather(x, dim, mesh, specs.TP_AXIS)

    @staticmethod
    def backward(ctx, g):
        return (specs.reduce_scatter(g, ctx.dim, ctx.mesh, specs.TP_AXIS)
                .contiguous(), None, None)


class _ScatterSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return specs.reduce_scatter(x, dim, mesh, specs.TP_AXIS)

    @staticmethod
    def backward(ctx, g):
        return specs.all_gather(g, ctx.dim, ctx.mesh, specs.TP_AXIS), None, \
            None


class _OwnSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _own(x, dim, mesh, specs.TP_AXIS).contiguous()

    @staticmethod
    def backward(ctx, g):
        return specs.all_gather(g, ctx.dim, ctx.mesh, specs.TP_AXIS), None, \
            None


class _ReplicateSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return specs.all_gather(x, dim, mesh, specs.TP_AXIS)

    @staticmethod
    def backward(ctx, g):
        return (_own(g, ctx.dim, ctx.mesh, specs.TP_AXIS).contiguous(), None,
                None)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, width):
        ctx.mesh, ctx.shape = mesh, x.shape
        return specs.shift(x[:, x.shape[1] - width:], mesh)

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out[:, ctx.shape[1] - g.shape[1]:] = specs.shift(g, ctx.mesh,
                                                         step=-1)
        return out, None, None


def model_ways() -> int:
    """The "model" size inside the step (1 outside it)."""
    c = _ctx()
    return 1 if c is None else specs.tp_degree(c.mesh)


def model_rank() -> int:
    """This rank's index along "model" (0 outside the step)."""
    c = _ctx()
    if c is None or model_ways() <= 1:
        return 0
    return c.mesh.get_local_rank(specs.TP_AXIS)


def sp_on() -> bool:
    c = _ctx()
    return c is not None and c.sp


def cp_cache() -> bool:
    c = _ctx()
    return c is not None and c.cp_cache


def seq_split(cfg, mesh, seq_len: int) -> bool:
    """Whether the residual keeps the rank's rows between layers, decided
    as ``_fit_axes`` decides "seq_sp": the families :func:`tp_keeps`
    covers (the dense, MoE, rwkv6 and hymba decoders), "model" > 1, more
    than one row and the rows dividing "model"; otherwise the residual
    stays replicated."""
    m = specs.tp_degree(mesh)
    return bool(tp_keeps(cfg, mesh)) and seq_len > 1 and seq_len % m == 0


def cp_cache_dims(logical, sharding) -> tuple:
    """The dims of a self-attention K / V cache leaf (its logical axes and
    sharding) that lie along "seq_sp" on "model": the sequence that the
    lockstep decode keeps as the rank's block and reads by flash decode
    (the step's ``cp_cache``). Empty where the sequence is whole."""
    names = specs.axis_names(sharding.mesh)
    return tuple(d for i, d in specs.shard_dims(sharding)
                 if names[i] == specs.TP_AXIS and logical[d] == "seq_sp")


def seq_rows(n: int) -> Tuple[int, int]:
    """The global row range [lo, hi) of a rank's ``n`` rows: its block
    under :func:`sp_on`, all of them otherwise."""
    lo = model_rank() * n if sp_on() else 0
    return lo, lo + n


def full_positions(positions):
    """(B, S) positions of every rank's rows, from the rank's (B, S / M)
    contiguous ones (identity without :func:`sp_on`)."""
    if not sp_on():
        return positions
    n = positions.shape[1]
    base = positions[:, :1] - seq_rows(n)[0]
    return base + torch.arange(n * model_ways(), device=positions.device)


def sp_gather(x, dim: int = 1):
    """Every rank's rows along ``dim`` (an all-gather over "model"); the
    backward reduce-scatters the ranks' gradient parts."""
    return _GatherSP.apply(x, _ctx().mesh, dim)


def sp_scatter(x, dim: int = 1):
    """Partial sums over "model" reduce-scattered onto the rank's rows
    along ``dim``; the backward all-gathers."""
    return _ScatterSP.apply(x, _ctx().mesh, dim)


def sp_own(x, dim: int = 1):
    """The rank's rows along ``dim`` of a replicated tensor; the backward
    all-gathers (the replicated tensor's gradient is whole)."""
    return _OwnSP.apply(x, _ctx().mesh, dim)


def sp_replicate(x, dim: int = 1):
    """Every rank's rows along ``dim``, for a replicated compute after it
    (:func:`sp_own`'s inverse); the backward keeps the rank's rows."""
    return _ReplicateSP.apply(x, _ctx().mesh, dim)


def sp_narrow(x, dim: int = 1):
    """The rank's rows along ``dim`` of a tensor that every rank computed
    whole from :func:`sp_gather`'s rows (MLA attention, cross-attention):
    a plain narrow, whose backward leaves zeros elsewhere, so the
    gradients stay the ranks' parts."""
    n = x.shape[dim] // model_ways()
    return x.narrow(dim, model_rank() * n, n)


def halo(x, width: int):
    """The previous "model" rank's last ``width`` rows (dim 1) of ``x``,
    zeros on rank 0 (``specs.shift``); the backward sends the gradient
    back."""
    return _Halo.apply(x, _ctx().mesh, width)


def cp_merge(m, l, acc):
    """``repro``'s flash-decode merge of every "model" rank's partial
    softmax over its rows: m_g = max m, corr = exp(m - m_g), l_g = sum l *
    corr, acc_g = sum acc * corr, then acc_g / max(l_g, 1e-30). One max
    and two sum all-reduces; no gradient (serving)."""
    mesh, axes = _ctx().mesh, (specs.TP_AXIS,)
    m_g = specs.all_reduce(m, mesh, axes, "max")
    corr = torch.exp(m - m_g)
    l_g = specs.all_reduce(l * corr, mesh, axes)
    acc_g = specs.all_reduce(acc * corr[..., None], mesh, axes)
    return acc_g / torch.clamp_min(l_g, 1e-30)[..., None]


# ------------------------------------------------------------ ZeRO-3 params
@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one param leaf is read inside the step: ``gathers`` the (mesh
    dim, tensor dim) pairs gathered, inner mesh dims first, tensor dims
    counted without the ``stack`` leading layer axes; ``tp_dim`` the dim
    left split over "model" (None: whole)."""
    gathers: tuple
    tp_dim: Optional[int]
    stack: int


def tp_keeps(cfg, mesh) -> frozenset:
    """The logical axes whose "model" blocks the tensor-parallel compute
    keeps: the dense decoder's d_ff and vocab, the MoE decoder's vocab and
    its experts when their count divides the "model" size, rwkv6's (SSM)
    d_ff, vocab and time-mix heads when their count divides it, hymba's
    (HYBRID) d_ff (its MLP and its mamba channels) and vocab, and the
    dense, MoE and hybrid attention's heads and kv heads when both counts
    divide it (MLA attention runs whole). A dim that does not divide
    stays gathered, as ``_fit_axes`` leaves it whole. Empty for the
    encoder-decoder and the VLM, or without a "model" axis above 1."""
    from repro_torch.configs.base import Family
    m = specs.tp_degree(mesh)
    if m <= 1:
        return frozenset()
    if cfg.family == Family.DENSE and not cfg.moe:
        keep = {"d_ff", "vocab"}
    elif cfg.family == Family.MOE and cfg.moe:
        keep = {"vocab"} | ({"expert"} if cfg.moe.num_experts % m == 0
                            else set())
    elif cfg.family == Family.SSM:
        return frozenset({"d_ff", "vocab"} | (
            {"heads"} if cfg.num_heads % m == 0 else set()))
    elif cfg.family == Family.HYBRID:
        keep = {"d_ff", "vocab"}
    else:
        return frozenset()
    if (not cfg.kv_lora_rank and cfg.num_heads % m == 0
            and cfg.num_kv_heads % m == 0):
        keep |= {"heads", "kv_heads"}
    return frozenset(keep)


def leaf_plan(sharding, logical, stack: int, keeps) -> LeafPlan:
    names = specs.axis_names(sharding.mesh)
    gathers, tp_dim = [], None
    for i, d in specs.shard_dims(sharding):
        if names[i] == specs.TP_AXIS and logical[d] in keeps:
            tp_dim = d - stack
        else:
            gathers.append((i, d - stack))
    return LeafPlan(tuple(reversed(gathers)), tp_dim, stack)


class _Leaf:
    __slots__ = ("local", "plan", "left")

    def __init__(self, local, plan: LeafPlan, left: int):
        self.local, self.plan, self.left = local, plan, left


class LazyParams(dict):
    """A param tree whose leaves are this rank's blocks, read through
    :func:`materialize` on access. ``layer(i)`` (``layers.layer_params``)
    indexes a layer stack; leaves whose stack axes are all indexed are read
    whole, anew on each access (a layer body that ``remat`` recomputes
    gathers them again). A leaf outside the layer stacks is gathered once
    per loss and kept (the tied embedding table serves the lookup and the
    head: one gather, one gradient reduction)."""

    def __init__(self, mesh, reduce_dims, tree, kept=None):
        super().__init__(tree)
        self.mesh, self.reduce_dims, self.kept = mesh, reduce_dims, kept

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        if isinstance(v, dict):
            return LazyParams(self.mesh, self.reduce_dims, v, self.kept)
        if v.left:
            raise KeyError(f"{k!r} is a layer stack: index it with "
                           f"layers.layer_params")
        if self.kept is None:
            return materialize(v.local, self.mesh, v.plan, self.reduce_dims)
        if id(v) not in self.kept:
            self.kept[id(v)] = materialize(v.local, self.mesh, v.plan,
                                           self.reduce_dims)
        return self.kept[id(v)]

    def layer(self, i: int):
        def index(v):
            if isinstance(v, dict):
                return {k: index(x) for k, x in v.items()}
            return _Leaf(v.local[i], v.plan, v.left - 1)
        return LazyParams(self.mesh, self.reduce_dims,
                          {k: index(v) for k, v in dict.items(self)})


def lazy_params(params, plans, mesh, reduce_dims) -> LazyParams:
    """``params`` (this rank's blocks) and their :class:`LeafPlan` tree as
    :class:`LazyParams`."""
    def wrap(p, plan):
        if isinstance(p, dict):
            return {k: wrap(v, plan[k]) for k, v in p.items()}
        return _Leaf(p, plan, plan.stack)
    return LazyParams(mesh, reduce_dims,
                      {k: wrap(v, plans[k]) for k, v in params.items()}, {})


# id of a gathered weight's storage (the same Python object while the
# storage lives, for real and fake tensors alike) -> (the weight, its
# block, mesh, plan), while the sharded step's loss runs (regather_saved)
_GATHERED: dict = {}


def reduce_dims_of(plan: LeafPlan, mesh, reduce_dims) -> tuple:
    """The mesh dims a leaf's gradient is summed over: the batch's, and
    under :func:`sp_on` "model" too where the leaf is read whole (not
    kept: each rank's rows give a part)."""
    c = _ctx()
    if c is None or not c.sp or plan.tp_dim is not None:
        return tuple(reduce_dims)
    i = specs.axis_names(mesh).index(specs.TP_AXIS)
    return tuple(reduce_dims) + ((i,) if i not in reduce_dims else ())


def materialize(local, mesh, plan: LeafPlan, reduce_dims):
    """A leaf as the step's compute reads it (gathered per ``plan``,
    marked with its tensor-parallel dim); its gradient summed over
    :func:`reduce_dims_of`."""
    reduce_dims = reduce_dims_of(plan, mesh, reduce_dims)
    if not plan.gathers and not reduce_dims:
        out = local
    else:
        out = _Materialize.apply(local, mesh, plan.gathers, reduce_dims)
    if plan.gathers:
        key = id(out.untyped_storage())
        _GATHERED[key] = (weakref.ref(out), local, mesh, plan.gathers)
        weakref.finalize(out, _GATHERED.pop, key, None)
    if plan.tp_dim is not None:
        out._tp_split = plan.tp_dim
    return out


def _pack(t):
    entry = _GATHERED.get(id(t.untyped_storage()))
    if entry is None or entry[0]() is None:
        return t
    return (_GATHERED, entry[1:], t.size(), t.stride(), t.storage_offset())


def _unpack(saved):
    if not (isinstance(saved, tuple) and saved[0] is _GATHERED):
        return saved
    (local, mesh, gathers), size, stride, offset = saved[1:]
    full = local.detach()
    for i, d in gathers:
        full = specs.all_gather(full, d, mesh, i)
    return full.as_strided(size, stride, offset)


def regather_saved():
    """While the loss runs: autograd saves a gathered weight as its block
    and gathers it again in the backward (ZeRO-3), so no rank keeps every
    layer's gathered weights alive at once."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


# ------------------------------------------------------------ serving caches
class GatheredStack:
    """A serving cache leaf stacked along layers, (L, ...), whose rank
    block is split over mesh dims the step's compute needs whole (an
    encoder-decoder's cross K / V; not a self-attention K / V sequence over
    "model", which flash decode reads as the rank's block, nor a recurrent
    state over the heads or channels the rank runs): ``stack[i]`` is
    layer i gathered over ``gathers`` ((mesh dim, leaf dim) pairs, outer
    first), the same tensor until another layer is read;
    then, or at ``flush``, the rank's block of it is written back in
    place, so the model's in-place writes land in the rank's block. One
    layer is gathered at a time."""

    def __init__(self, local, mesh, gathers):
        self.local, self.mesh, self.gathers = local, mesh, tuple(gathers)
        self._open = None

    @property
    def shape(self):
        s = list(self.local.shape)
        for i, d in self.gathers:
            s[d] *= self.mesh.size(i)
        return torch.Size(s)

    def __getitem__(self, i: int):
        if self._open is not None:
            if self._open[0] == i:
                return self._open[1]
            self.flush()
        full = self.local[i]
        for md, d in reversed(self.gathers):
            full = specs.all_gather(full, d - 1, self.mesh, md)
        self._open = (i, full)
        return full

    def flush(self):
        if self._open is None:
            return
        i, own = self._open
        for md, d in self.gathers:
            own = _own(own, d - 1, self.mesh, md)
        self.local[i].copy_(own)
        self._open = None
