"""The step factories of ``repro/launch/steps.py``: the training step
(loss, gradients, AdamW, microbatch accumulation, remat) and the serving
steps. PyTorch runs eagerly, so each ``make_*`` returns a plain function
where ``repro`` returned one to be jitted, and a Python loop takes the
place of ``lax.scan``. They go through the ``Model`` facade, so they
serve every family alike: for rwkv6 and hymba the scan anchor threads the
recurrent state through ``decode_step`` token by token, and a prefill
chunk carries it across chunks in the transient cache; a VLM batch carries
its ``image_embeds``; for whisper the first chunk (and the scan anchor)
runs the encoder and the cross K/V exactly once per request group."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import Family
from repro_torch.kernels.ref import mask_value
from repro_torch.models import encdec
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamW, apply_updates
from repro_torch.sharding import specs, spmd
from repro_torch.tree import tree_leaves, tree_map

MOE_AUX_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3


# ------------------------------------------------------------------ loss
CE_CHUNK = 1024


def cross_entropy(logits, labels):
    """logits: (B, S, V) fp32; labels: (B, S) int. The mean over tokens of
    logsumexp - the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def head_ce_chunk(x_c, head_w, labels_c, vocab: int, tied: bool,
                  split: bool = False):
    """CE summed over one sequence chunk without keeping logits alive.
    x_c: (B, C, D); head_w: (D, Vp) or the tied table (Vp, D); labels_c:
    (B, C). Padded vocab columns are masked at ``mask_value``. Inside the
    sharded step a head split over "model" (``split``: ``spmd.tp_split``)
    gives the rank's vocab columns and the CE is reduced over the ranks;
    with the rows over "model" (``spmd.sp_on``) x_c is the rank's rows,
    gathered first, and ``labels_c`` those of every rank in rank order."""
    if split:
        x_c = spmd.sp_gather(x_c) if spmd.sp_on() else spmd.tp_copy(x_c)
    w = head_w.to(x_c.dtype)
    logits = (x_c @ w.T if tied else x_c @ w).float()
    vp = logits.shape[-1]
    lo = spmd.model_rank() * vp if split else 0
    if vocab < lo + vp:
        keep = torch.arange(lo, lo + vp, device=logits.device) < vocab
        logits = torch.where(keep, logits, mask_value(logits.dtype))
    if not split:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
        return torch.sum(lse - gold)
    # vocab over "model" (training): the max, the sum of exponentials and
    # the label's logit each reduced over the rank's columns, then "model"
    m = spmd.tp_max(logits.amax(dim=-1))
    lse = torch.log(spmd.tp_sum(torch.exp(logits - m[..., None]).sum(-1))) + m
    local = labels_c.long() - lo
    ok = (local >= 0) & (local < vp)
    gold = torch.gather(logits, -1, local.clamp(0, vp - 1)[..., None])[..., 0]
    return torch.sum(lse - spmd.tp_sum(torch.where(ok, gold, 0.0)))


def chunked_cross_entropy(features, head_w, labels, vocab: int, tied: bool,
                          chunk: int = CE_CHUNK):
    """Never materializes (B, S, V) logits: S in chunks, each chunk's body
    checkpointed (its logits recomputed in the backward, as ``repro``'s
    ``nothing_saveable`` remat does), the chunk sums added in order, then
    divided by B * S.

    Inside the sharded step with the rows over "model" (``spmd.sp_on``)
    ``features`` are the rank's S / M rows and ``labels`` all S: the
    chunks are of the rank's rows, a vocab-split head gathers each
    chunk's rows of every rank (their labels taken in the same order),
    and a whole head's sums of the rank's rows are added over "model", so
    each rank's loss is the mean over every row."""
    B, n, D = features.shape
    S = labels.shape[1]
    sp = spmd.sp_on()
    ways = S // n if sp else 1
    chunk = max(1, min(chunk, S) // ways)
    split = spmd.tp_split(head_w) is not None
    chunk_fn = spmd.checkpointed(head_ce_chunk)
    lo = spmd.seq_rows(n)[0]

    def body(a, b):
        if not sp:
            l_c = labels[:, a:b]
        elif split:
            l_c = torch.cat([labels[:, r * n + a:r * n + b]
                             for r in range(ways)], dim=1)
        else:
            l_c = labels[:, lo + a:lo + b]
        return checkpoint(chunk_fn, features[:, a:b], head_w, l_c, vocab,
                          tied, split, use_reentrant=False)

    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for a in range(0, n - n % chunk, chunk):
        total = total + body(a, a + chunk)
    if n % chunk:
        total = total + body(n - n % chunk, n)
    if sp and not split:
        total = spmd.tp_sum(total)
    return total / (B * S)


def _batch_extras(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The frontend stub inputs a batch carries (a VLM's ``image_embeds``,
    an encoder-decoder's ``frames``), passed on to the model."""
    return {k: batch[k] for k in ("image_embeds", "frames") if k in batch}


def _with_cross_kv(model: Model, params, cache, frames, compute_dtype):
    """An encoder-decoder's transient cache with its cross K/V: the encoder
    runs once on ``frames`` (the model's zero stub when None) through the
    einsum attention, as ``repro``'s builders run it, and every decoder
    layer's cross K/V replace the cache's zero "xk" / "xv"."""
    if frames is None:
        frames = model.extra_inputs(cache["k"].shape[1], compute_dtype,
                                    cache["k"].device)["frames"]
    enc_out = encdec.encode(params, model.cfg, frames.to(compute_dtype),
                            compute_dtype=compute_dtype, attn_impl="einsum")
    xk, xv = encdec.precompute_cross_kv(params, model.cfg, enc_out)
    cache["xk"] = xk.to(cache["xk"].dtype)
    cache["xv"] = xv.to(cache["xv"].dtype)
    return cache


def head_weight(model: Model, params):
    """(weights, tied?) for the LM head."""
    if "unembed" in params:
        return params["unembed"]["w"], False
    return params["embed"]["table"], True


def _scan_kw(model: Model, scan_impl: Optional[str]) -> dict:
    """``scan_impl`` for the recurrent families, where one is given."""
    if scan_impl is None or model.cfg.family not in (Family.SSM,
                                                     Family.HYBRID):
        return {}
    return {"scan_impl": scan_impl}


def make_prefill(model: Model, *, compute_dtype=torch.bfloat16,
                 attn_impl: str = "chunked", batch_chunks: int = 1,
                 return_cache: bool = False, s_max: int = 0,
                 cache_dtype=torch.float32, scan_impl: Optional[str] = None,
                 sharded: bool = False):
    """Prefill step builder.

    Default: ``prefill(params, batch) -> (B, 1, Vp)`` float32 last-position
    logits of a full-sequence forward (``attn_impl`` as in
    ``layers.attention``); the padded vocab columns are not masked, as in
    ``repro``. ``batch_chunks`` > 1 runs the batch in that many sequential
    slices of its rows (bounding the activations, as microbatches do in
    training) and concatenates their logits. ``scan_impl`` as in
    ``make_decode_step``. ``sharded=True`` builds the step for params of
    DTensors (``place`` with ``param_shardings``), run on their mesh
    (``_sharded_prefill``).

    ``return_cache=True``: the scan anchor. ``prefill(params, batch) ->
    (last_logits, cache)`` teacher-forces the prompt through
    ``decode_step`` one position at a time into a fresh dense cache of
    ``s_max`` rows (scalar pos), which ends at pos == prompt_len."""
    if return_cache:
        if s_max <= 0:
            raise ValueError("return_cache=True requires s_max > 0")

        def prefill_cache(params, batch):
            tokens = batch["tokens"]
            B, S = tokens.shape
            cache = model.init_cache(B, s_max, cache_dtype,
                                     device=tokens.device)
            extras = _batch_extras(batch)
            if model.cfg.family == Family.ENCDEC:
                cache = _with_cross_kv(model, params, cache,
                                       extras.pop("frames", None),
                                       compute_dtype)
            logits = torch.zeros((B, 1, model.cfg.padded_vocab),
                                 device=tokens.device)
            for t in range(S):
                logits, cache = model.decode_step(
                    params, tokens[:, t:t + 1], cache,
                    compute_dtype=compute_dtype, **extras)
            return logits, cache
        return prefill_cache

    def one(params, batch):
        feats, _ = model.forward(params, batch["tokens"],
                                 compute_dtype=compute_dtype,
                                 attn_impl=attn_impl, return_features=True,
                                 **_scan_kw(model, scan_impl),
                                 **_batch_extras(batch))
        w, tied = head_weight(model, params)
        last = feats[:, -1:]
        if spmd.sp_on():    # the last row is the last "model" rank's
            last = spmd.sp_gather(last)[:, -1:]
        wd = w.to(last.dtype)
        return spmd.tp_gather((last @ wd.T if tied else last @ wd).float(),
                              w)

    if sharded:
        return _sharded_prefill(model, one, batch_chunks)

    def prefill(params, batch):
        if batch_chunks == 1:
            return one(params, batch)
        size = batch["tokens"].shape[0] // batch_chunks
        return torch.cat([one(params, {k: v[i * size:(i + 1) * size]
                                       for k, v in batch.items()})
                          for i in range(batch_chunks)])
    return prefill


def make_prefill_chunk(model: Model, *, compute_dtype=torch.bfloat16,
                       s_max: int = 0, cache_dtype=torch.float32,
                       first: bool = False, attn_impl: str = "einsum"):
    """Parallel chunked prefill into a dense transient request cache.

    ``first=True``: ``first_chunk(params, batch) -> (logits, cache)``
    creates the (K, s_max) cache (for an encoder-decoder, with the cross
    K/V of one encoder pass over ``batch["frames"]``) and runs the chunk at
    position 0, where ``attn_impl='pallas'`` sends the attention through
    the flash kernel. ``first=False``: ``chunk(params, cache, batch) ->
    (logits, cache)`` continues at ``cache['pos']``. The cache is written
    in place."""
    if s_max <= 0 and first:
        raise ValueError("first=True requires s_max > 0")

    def run_chunk(params, cache, batch):
        return model.prefill_chunk(params, batch["tokens"], cache,
                                   compute_dtype=compute_dtype,
                                   attn_impl=attn_impl, first=first,
                                   **_batch_extras(batch))

    if not first:
        return run_chunk

    def first_chunk(params, batch):
        tokens = batch["tokens"]
        cache = model.init_cache(tokens.shape[0], s_max, cache_dtype,
                                 device=tokens.device)
        if model.cfg.family == Family.ENCDEC:
            cache = _with_cross_kv(model, params, cache, batch.get("frames"),
                                   compute_dtype)
            batch = {k: v for k, v in batch.items() if k != "frames"}
        return run_chunk(params, cache, batch)
    return first_chunk


def make_prefill_chunk_paged(model: Model, *, compute_dtype=torch.bfloat16,
                             attn_impl: str = "kernel"):
    """Incremental paged prefill: returns ``chunk(params, cache, batch) ->
    (last_logits, cache)``. ``batch`` carries ``tokens`` (K, C), ``bt``
    (K, mps) block-table rows, ``start`` (the chunk's first absolute
    position, shared by the group) and ``floor`` (the first row the group
    may write). The chunk's K/V land in the resident pools in place."""
    def chunk(params, cache, batch):
        return model.prefill_chunk_paged(
            params, batch["tokens"], cache, bt_rows=batch["bt"],
            start=batch["start"], write_floor=batch["floor"],
            compute_dtype=compute_dtype, attn_impl=attn_impl,
            **_batch_extras(batch))
    return chunk


def make_decode_step(model: Model, *, compute_dtype=torch.bfloat16,
                     paged_attn_impl: Optional[str] = None,
                     scan_impl: Optional[str] = None, sharded: bool = False):
    """One-token decode against the serving cache, updated in place.
    ``paged_attn_impl`` ('kernel' | 'einsum') selects the paged read path;
    None keeps the model's default (the masked-einsum reference). A dense
    cache ignores it. ``scan_impl`` picks a recurrent family's scan
    ('scan': the plain recurrence; None keeps the model's 'auto').

    ``sharded=True`` builds the step for params and a dense cache with a
    scalar pos of DTensors (``place`` with ``param_shardings`` /
    ``cache_shardings``): the lockstep decode run on their mesh
    (``_sharded_decode``), the cache's blocks written in place."""
    extra = _scan_kw(model, scan_impl)
    if paged_attn_impl is not None:
        extra["paged_attn_impl"] = paged_attn_impl

    def decode(params, cache, batch):
        return model.decode_step(params, batch["token"], cache,
                                 compute_dtype=compute_dtype, **extra,
                                 **_batch_extras(batch))
    return _sharded_decode(model, decode) if sharded else decode


# ------------------------------------------------------------------ train
def _train_kw(model: Model) -> dict:
    """The recurrent families train through their plain scans: K5 and K6
    have no backward (``repro``'s Pallas scans have none either)."""
    return _scan_kw(model, "scan")


def make_loss_fn(model: Model, *, compute_dtype=torch.bfloat16,
                 attn_impl: str = "einsum", remat=True):
    """``loss_fn(params, batch) -> (loss, metrics)``: the chunked CE of the
    head over the final features, plus the MoE's aux and z losses at
    ``MOE_AUX_WEIGHT`` / ``MOE_Z_WEIGHT``."""
    def loss_fn(params, batch):
        feats, aux = model.forward(params, batch["tokens"],
                                   compute_dtype=compute_dtype,
                                   attn_impl=attn_impl, remat=remat,
                                   return_features=True, **_train_kw(model),
                                   **_batch_extras(batch))
        w, tied = head_weight(model, params)
        ce = chunked_cross_entropy(feats, w, batch["labels"],
                                   model.cfg.vocab_size, tied)
        loss = (ce + MOE_AUX_WEIGHT * aux["moe_aux"]
                + MOE_Z_WEIGHT * aux["moe_z"])
        return loss, {"ce": ce, **aux}
    return loss_fn


def value_and_grad(loss_fn):
    """``repro``'s ``jax.value_and_grad(loss_fn, has_aux=True)`` over a
    param tree: ``((loss, metrics), grads)`` with grads in the params'
    nesting (zeros for a leaf the loss does not reach) and everything
    returned detached."""
    def run(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(p): (torch.zeros_like(p) if g is None else g)
                 for p, g in zip(flat, grads)}
        return ((loss.detach(), tree_map(torch.Tensor.detach, metrics)),
                tree_map(lambda p: by_id[id(p)], leaves))
    return run


def init_train_state(model: Model, optimizer: AdamW, gen: torch.Generator,
                     device) -> Dict[str, Any]:
    """Params drawn from ``gen`` on ``device``, AdamW's zero state and step
    0 (int32), ``repro``'s layout."""
    params = model.init(gen, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def train_state_shapes(model: Model, optimizer: AdamW) -> Dict[str, Any]:
    """The train state's leaves as meta tensors (shapes and dtypes only,
    ``repro``'s ``jax.eval_shape`` of ``init_train_state``)."""
    return init_train_state(model, optimizer, torch.Generator(), "meta")


def _strip_fsdp(tree):
    """The logical tree without its "fsdp" (data-axis) factor: ZeRO-1's
    params, replicated over data and sharded over model only."""
    if specs._is_logical_leaf(tree):
        return tuple(None if a == "fsdp" else a for a in tree)
    return {k: _strip_fsdp(v) for k, v in tree.items()}


def train_state_logical(model: Model, zero_stage: int = 3) -> Dict[str, Any]:
    """zero_stage=3: params and AdamW's m / v sharded over data x model
    (ZeRO-3; weights gathered per layer). zero_stage=1: params sharded over
    model only (resident on every data rank); m / v as at 3."""
    pl = model.param_logical()
    p_log = pl if zero_stage >= 3 else _strip_fsdp(pl)
    return {"params": p_log, "opt": {"m": pl, "v": pl, "count": ()},
            "step": ()}


def batch_logical(model: Model, batch_keys) -> Dict[str, Any]:
    out = {}
    for k in batch_keys:
        if k in ("tokens", "labels", "token"):
            out[k] = ("batch", None)
        elif k in ("image_embeds", "frames"):
            out[k] = ("batch", None, None)
        else:
            raise KeyError(k)
    return out


# Shape-aware sharding trees (``specs.shardings_for``): a logical axis
# that does not divide a leaf's dim drops for that leaf. Each takes a tree
# of tensors (meta tensors do) and gives the same tree of
# ``specs.NamedSharding`` on the active mesh.
def state_shardings(model: Model, state_shapes, zero_stage: int = 3):
    return specs.shardings_for(train_state_logical(model, zero_stage),
                               state_shapes)


def param_shardings(model: Model, params_shapes):
    return specs.shardings_for(model.param_logical(), params_shapes)


def batch_shardings(model: Model, batch_shapes):
    return specs.shardings_for(batch_logical(model, batch_shapes.keys()),
                               batch_shapes)


def cache_shardings(model: Model, cache_shapes):
    return specs.shardings_for(model.cache_logical(), cache_shapes)


def place(tree, shardings):
    """A tree of full tensors (the same on every rank) as DTensors that hold
    each rank's block only (``specs.distribute``; no communication)."""
    return tree_map(specs.distribute, tree, shardings)


# params subtrees stacked along leading layer axes, and how many
_STACKS = {"layers": 1, "enc_layers": 1, "dec_layers": 1,
           "super": {"blocks": 2, "cross": 1}}


def _plans(model: Model, shardings, keeps):
    def go(logical, sh, stack):
        if isinstance(sh, dict):
            return {k: go(logical[k], v, stack.get(k, 0)
                          if isinstance(stack, dict) else stack)
                    for k, v in sh.items()}
        return spmd.leaf_plan(sh, logical, stack, keeps)
    return go(model.param_logical(), shardings, _STACKS)


def _to_dtensor(t, sh):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, sh.mesh, sh.placements, run_check=False)


def _batch_dims(sh) -> tuple:
    return tuple(i for i, _ in specs.shard_dims(sh))


def _microbatches(model: Model, batch, mesh, microbatches: int):
    """[(the rank's rows of microbatch i, the mesh dims they split
    over)]. The global batch is cut into microbatches first and each is
    then sharded over "batch", as ``repro``'s reshape of a sharded batch
    computes; a batch of DTensors is gathered first where it must be."""
    ids = "tokens" if "tokens" in batch else "token"
    sh = {k: specs.sharding_of(v) for k, v in batch.items()}
    if microbatches == 1 and all(v is not None for v in sh.values()):
        return [({k: v.to_local() for k, v in batch.items()},
                 _batch_dims(sh[ids]))]
    full = {k: v if sh[k] is None else
            specs.full_tensor(v.to_local(), sh[k]) for k, v in batch.items()}
    size = full[ids].shape[0] // microbatches
    out = []
    for i in range(microbatches):
        mb = {k: v[i * size:(i + 1) * size] for k, v in full.items()}
        with specs.use_mesh(mesh):
            msh = batch_shardings(model, mb)
        out.append(({k: specs.local_block(v, msh[k]) for k, v in mb.items()},
                    _batch_dims(msh[ids])))
    return out


def _local_params(model: Model, params):
    """(mesh, the logical axes the tensor-parallel compute keeps, this
    rank's blocks, their ``spmd.LeafPlan`` tree): params of DTensors as
    the sharded steps read them."""
    sh = tree_map(specs.sharding_of, params)
    mesh = tree_leaves(sh)[0].mesh
    keeps = spmd.tp_keeps(model.cfg, mesh)
    return (mesh, keeps, tree_map(lambda t: t.to_local(), params),
            _plans(model, sh, keeps))


def _sharded_prefill(model: Model, one, batch_chunks: int):
    """The prefill on params of DTensors (SPMD, no autograd): each rank
    runs its rows of each of the ``batch_chunks`` slices of the global
    batch on weights gathered per layer (the dense, MoE and recurrent
    decoders' heads, d_ff, experts, mamba channels and vocab over "model"
    where ``spmd.tp_keeps`` keeps them, the residual on the rank's rows of
    the sequence where ``spmd.seq_split`` says so, a MoE layer's own
    dispatch groups where they divide the batch's ranks), and the logits
    of every row are
    gathered to every rank: ``(B, 1, Vp)``, equal to the mesh-free step's
    within fp32 sum order."""
    def run(params, batch):
        mesh, keeps, local, plans = _local_params(model, params)
        sp = spmd.seq_split(model.cfg, mesh, batch["tokens"].shape[1])
        outs = []
        for mb, dims in _microbatches(model, batch, mesh, batch_chunks):
            with spmd.training(mesh, dims, bool(keeps), sp=sp):
                outs.append(spmd.gather_rows(one(
                    spmd.lazy_params(local, plans, mesh, dims), mb)))
        return torch.cat(outs)
    return run


def _sharded_decode(model: Model, decode):
    """The lockstep decode on params and a dense cache of DTensors (SPMD,
    no autograd): each rank runs its batch rows against its block of the
    cache, the dense and MoE decoders' heads over "model" with the
    cache's kv heads and a MoE layer's experts over "model" (one token a
    row: its one dispatch group gathers every rank's rows). A
    self-attention K / V leaf whose sequence is split over
    "model" stays the rank's block, and the attention runs as flash
    decode over it (``layers.attention_decode``, ``spmd.cp_cache``). A
    recurrent state split over the heads or channels that the rank runs
    (rwkv6's ``S`` over "heads", hymba's ``h`` over "d_ff": kept by
    ``spmd.tp_keeps``) stays the rank's block too: K5 / K6 read it and
    the new state is written into it in place. A leaf split over a mesh
    dim that the compute needs whole (whisper's cross K / V ``xk`` /
    ``xv``) is gathered one layer at a time and its block written back
    (:class:`spmd.GatheredStack`). Returns (the logits of every row on
    every rank, ``(B, 1, Vp)``, the cache written in place)."""
    def run(params, cache, batch):
        mesh, keeps, local_params, plans = _local_params(model, params)
        ((mb, dims),) = _microbatches(model, batch, mesh, 1)
        with specs.use_mesh(mesh):
            logical = model.cache_logical()
        names = specs.axis_names(mesh)
        local, stacks, cp = {}, [], False
        for k, v in cache.items():
            sh = specs.sharding_of(v)
            if sh is None:
                local[k] = v
                continue
            loc = v.to_local()
            seq = (spmd.cp_cache_dims(logical[k], sh) if k in ("k", "v")
                   else ())
            cp = cp or bool(seq)
            gathers = [(i, d) for i, d in specs.shard_dims(sh)
                       if d not in seq and i not in dims
                       and not (names[i] == specs.TP_AXIS
                                and logical[k][d] in keeps)]
            if gathers:
                loc = spmd.GatheredStack(loc, mesh, gathers)
                stacks.append(loc)
            local[k] = loc
        with spmd.training(mesh, dims, bool(keeps), cp_cache=cp):
            logits, local = decode(spmd.lazy_params(
                local_params, plans, mesh, dims), local, mb)
            for st in stacks:
                st.flush()
            logits = spmd.gather_rows(logits)
        sh = specs.sharding_of(cache["pos"])
        cache["pos"] = (local["pos"] if sh is None
                        else _to_dtensor(local["pos"], sh))
        return logits, cache
    return run


def sharded_value_and_grad(model: Model, loss_fn, microbatches: int = 1):
    """``value_and_grad`` on params of DTensors (SPMD: every rank of their
    mesh calls it alike): ``((loss, metrics), grads)`` with the global
    loss and "ce" and each gradient as the rank's block of the params'
    layout. Each rank computes the loss of its rows of every microbatch on
    weights gathered per layer (``sharding.spmd``), divided by the number
    of ways the batch rows split, so the ranks' losses sum to the global
    mean; the gradients come back summed over the batch's ranks. The
    dense, MoE and recurrent decoders keep their residual on the rank's
    rows of the sequence where ``spmd.seq_split`` says so; the loss,
    summed over "model" in the chunked CE, is then every row's on each
    "model" rank,
    and a MoE layer's aux losses, reduced over the batch's ranks where
    its groups split, are the global ones on every rank."""
    def run(params, batch):
        mesh, keeps, local, plans = _local_params(model, params)
        grads, loss, ce, metrics = None, 0.0, 0.0, {}
        for mb, dims in _microbatches(model, batch, mesh, microbatches):
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              local)
            sp = spmd.seq_split(model.cfg, mesh, mb["tokens"].shape[1])
            with spmd.training(mesh, dims, bool(keeps), sp=sp), \
                    spmd.regather_saved():
                n = spmd.batch_split()
                mloss, metrics = loss_fn(
                    spmd.lazy_params(leaves, plans, mesh, dims), mb)
                flat = tree_leaves(leaves)
                got = torch.autograd.grad(mloss / n, flat, allow_unused=True)
            by_id = {id(p): torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, got)}
            mgrads = tree_map(lambda p: by_id[id(p)], leaves)
            grads = mgrads if grads is None else tree_map(torch.add, grads,
                                                          mgrads)
            loss = loss + specs.all_reduce(mloss.detach() / n, mesh, dims)
            ce = ce + specs.all_reduce(metrics["ce"].detach() / n, mesh, dims)
        if microbatches > 1:
            loss, ce = loss / microbatches, ce / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["ce"] = ce
        return (loss, metrics), grads
    return run


def sharded_update(optimizer: AdamW, state, grads):
    """A state of DTensors and ``sharded_value_and_grad``'s gradients ->
    (the next state, the gradient's global norm): AdamW on the blocks of
    m / v's layout (under ZeRO-1 the update is gathered back to the
    params')."""
    sh = tree_map(specs.sharding_of, state)
    local = tree_map(lambda t: t.to_local(), state)
    p_sh, m_sh = sh["params"], sh["opt"]["m"]
    updates, opt, gnorm = optimizer.update(
        tree_map(specs.relayout, grads, p_sh, m_sh), local["opt"],
        tree_map(specs.relayout, local["params"], p_sh, m_sh),
        shardings=m_sh)
    params = apply_updates(local["params"], tree_map(
        specs.relayout, updates, m_sh, p_sh))
    new = {"params": params, "opt": opt, "step": local["step"] + 1}
    return tree_map(_to_dtensor, new, sh), gnorm


def _sharded_train_step(model: Model, optimizer: AdamW, loss_fn,
                        microbatches: int):
    """The train step on a state of DTensors: ``sharded_value_and_grad``,
    then ``sharded_update``."""
    grad_fn = sharded_value_and_grad(model, loss_fn, microbatches)

    def train_step(state, batch):
        (loss, metrics), grads = grad_fn(state["params"], batch)
        state, gnorm = sharded_update(optimizer, state, grads)
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def make_train_step(model: Model, optimizer: AdamW, *,
                    compute_dtype=torch.bfloat16, attn_impl: str = "einsum",
                    remat=True, microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    With microbatches > 1 the batch is split along its first axis and the
    gradients (and losses) of the slices are summed in order from zero,
    then divided by ``microbatches``, as ``repro``'s ``lax.scan`` does;
    the other metrics are the last slice's.

    A state of DTensors (``place`` with ``state_shardings``) runs the
    sharded step on its mesh (``_sharded_train_step``): the batch is then
    either DTensors (each rank's rows, ``batch_shardings``) or the whole
    batch on every rank, and the function is ``repro``'s single-device
    one."""
    loss_fn = make_loss_fn(model, compute_dtype=compute_dtype,
                           attn_impl=attn_impl, remat=remat)
    grad_fn = value_and_grad(loss_fn)
    sharded = _sharded_train_step(model, optimizer, loss_fn, microbatches)

    def train_step(state, batch):
        if specs.sharding_of(state["step"]) is not None:
            return sharded(state, batch)
        params = state["params"]
        if microbatches == 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            size = next(iter(batch.values())).shape[0] // microbatches
            loss = torch.zeros((), device=state["step"].device)
            grads = tree_map(torch.zeros_like, params)
            for i in range(microbatches):
                mbatch = {k: v[i * size:(i + 1) * size]
                          for k, v in batch.items()}
                (mloss, metrics), mgrads = grad_fn(params, mbatch)
                grads = tree_map(torch.add, grads, mgrads)
                loss = loss + mloss
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        updates, opt, gnorm = optimizer.update(grads, state["opt"], params)
        params = apply_updates(params, updates)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step
