"""Continuous-batching serve engine over a dense or a paged KV cache — the
port of ``repro/serve/engine.py``:

* **The cache.** ``page_size=None`` (the default) keeps per-slot (B, s_max)
  rows. With a page size, K/V live in a shared page pool (L, num_pages,
  page_size, KV, hd) addressed through per-slot block tables — fp32, or
  int8 with per-page scales (``kv_backend="paged_int8"``); an MLA arch
  caches one latent row per token instead (dense, or latent pages). The
  recurrent families carry their state per slot: rwkv6 (SSM) keeps only
  that O(1) state and ignores a page size with a warning; hymba (HYBRID)
  keeps a window-wide KV ring, dense or paged, beside it. The
  ``KVBackend`` owns the representation and the engine carries whatever
  leaves it declares. A host-side
  refcounted ``PageAllocator`` hands pages out at admission (the request's
  worst case, all or nothing) and takes them back on completion. Admission
  peeks and defers in strict priority/FIFO order when the free list is short.
* **Parallel chunked prefill.** Prompts are ingested in bucketed chunks
  (the chunk size and the powers of two below it), at most
  ``prefill_chunk_tokens`` positions between two decode ticks. With the
  paged-attention kernel (``paged_attn_impl`` 'kernel', the 'auto' choice
  for multi-page slots) each chunk writes its K/V straight into the group's
  pages (the incremental splice), so completion only flips the group's
  positions. Otherwise (the dense cache, 'einsum', ``page_size == s_max``)
  the chunks fill a transient dense request cache — the first chunk
  through the flash-attention kernel with ``prefill_attn_impl`` 'pallas',
  the 'auto' choice on the card — which completion splices into the
  group's rows or pages.
* **Scan prefill** (``prefill_mode='scan'``): the prompt is teacher-forced
  through ``decode_step`` at admission, the bit-exactness anchor.
* **Prefix cache (on by itself when paged with parallel prefill).**
  Completed prompt pages are chain-hashed into a ``PrefixIndex``; admission
  aliases the longest cached page-aligned prefix into the block table and
  runs only the uncached tail. A partial hit's shared rows are copied into
  a fresh page (copy-on-write), by the pool copy on the incremental path
  and by the completion splice on the transient one (whose cache is seeded
  from the pages); LRU index-only pages are evicted before admission
  defers.
* **Decode and sampling.** One decode tick per step for every running
  slot. ``temperature == 0`` takes ``argmax`` (the first index on ties,
  like ``jnp.argmax``); ``temperature > 0`` filters the scaled logits to
  the top-k and the top-p nucleus (``_filter_logits``, ``repro``'s kept
  sets exactly) and draws by Gumbel-max from a ``torch.Generator`` on the
  engine's device, seeded from ``seed`` and advanced once per sampling
  event. Freed slots are parked at ``layers.INACTIVE_POS`` (and, paged, an
  all--1 block table), so their writes drop.
* **Scheduling policy** (``SchedPolicy``, every knob off by default):
  deficit round-robin over prefill jobs, the decode-starvation guard,
  recompute preemption under pool pressure, shed or defer at the head
  below a low-water mark, and EDF order within a priority level — the
  reference's decisions, step for step.
* **Cancellation and failure release.** ``cancel`` works from every state
  and ``release_job`` frees a job's slots, pages and aliased prefix
  references through ``_finish``, the path completion takes. A chunk
  dispatch that raises is logged and its job FAILED; on the card the
  device is synchronised first, and a CUDA error there (the context is
  lost) leaves ``step``. The port donates no buffer: a chunk writes only
  its own job's pages above ``write_floor``, so a failed chunk cannot
  touch a bystander's K/V and no pool reset exists.

Tensor parallelism and the MoE, VLM and encdec families raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import Family
from repro_torch.core.quantize import dequantize_params, quantize_params
from repro_torch.launch import steps as steps_mod
from repro_torch.models.layers import INACTIVE_POS
from repro_torch.models.registry import Model, get_model, reduced_config
from repro_torch.serve.config import ServeConfig, resolve_device
from repro_torch.serve.kvcache import (PAGED_KERNEL_FAMILIES,
                                       PREFIX_CACHE_FAMILIES, KVBackend,
                                       make_backend)
from repro_torch.serve.metrics import MetricsRecorder
from repro_torch.serve.prefix import PrefixIndex, PrefixPlan
from repro_torch.serve.scheduler import (Request, RequestState, SchedPolicy,
                                         Scheduler)

log = logging.getLogger("repro_torch.serve.engine")


def chunk_ladder(chunk_tokens: int) -> List[int]:
    """The bucketed chunk-length ladder: the chunk size plus every power of
    two below it, descending."""
    if chunk_tokens < 1:
        raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
    ladder = {chunk_tokens}
    p = 1
    while p < chunk_tokens:
        ladder.add(p)
        p <<= 1
    return sorted(ladder, reverse=True)


def chunk_plan(prompt_len: int, ladder: List[int]) -> List[int]:
    """Greedy largest-first decomposition of a prompt into ladder chunks."""
    plan, rem = [], prompt_len
    for c in ladder:
        while rem >= c:
            plan.append(c)
            rem -= c
    return plan


@dataclasses.dataclass
class _PrefillJob:
    """One in-flight chunked prefill: K same-length requests ingested
    jointly. ``cache`` is the transient dense request cache (None on the
    incremental path, and until the first chunk runs unless a prefix hit
    seeded it). ``prompts`` holds only the TAIL the chunks compute
    (positions ``tail_start`` onward); ``write_floor`` is the first cache
    row the chunks or the completion splice may write — rows below it live
    in shared immutable prefix pages."""
    slots: List[int]
    reqs: List[Request]
    prompts: np.ndarray            # (K, P - tail_start) uncached tail tokens
    plan: List[int]                # bucketed chunk lengths, sums to the tail
    idx: int = 0                   # next chunk index
    filled: int = 0                # tail tokens already ingested
    tail_start: int = 0            # first prompt position the chunks compute
    write_floor: int = 0
    prefix_plans: Optional[List[PrefixPlan]] = None
    cache: Optional[dict] = None
    deficit: int = 0               # DRR chunk-token credit (policy.drr only)


class PageAllocator:
    """Host-side REFCOUNTED free-list allocator over a fixed pool of KV
    pages (a copy of ``repro``'s): ``alloc`` is all-or-nothing at refcount
    1, ``share`` adds a reference, ``release`` drops one and frees a page
    at zero; releasing a free page raises."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def held(self) -> set:
        return set(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def share(self, page: int):
        if page not in self._ref:
            raise ValueError(f"share of unheld page {page}")
        self._ref[page] += 1

    def release(self, pages: List[int]):
        for p in pages:
            n = self._ref.get(p, 0)
            if n <= 0:
                raise ValueError(f"double free of page {p}")
            if n == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = n - 1


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 "
                               f"item {item})")


class ServeEngine:
    """Slot-based continuous-batching engine over a dense or paged cache,
    on ``device`` (``"cuda"`` unless ``"cpu"`` is passed).

    sampling: ``temperature == 0`` is greedy argmax; ``temperature > 0``
    samples from softmax(logits / temperature), optionally restricted to
    the ``top_k`` highest logits and/or the smallest ``top_p`` nucleus,
    reproducibly for a fixed ``seed``. ``prefill_attn_impl='auto'``
    resolves to the flash-attention kernel ('pallas') on the card and to
    the einsum reference on the CPU, as ``repro`` resolves it on and off
    the TPU."""

    def __init__(self, model: Model, params, *, batch_slots: int, s_max: int,
                 compute_dtype=torch.float32,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_backend=None,
                 prefix_cache: Optional[bool] = None,
                 prefill_mode: str = "parallel",
                 prefill_chunk_tokens: int = 64,
                 prefill_attn_impl: str = "auto",
                 paged_attn_impl: str = "auto",
                 scheduler: Optional[Scheduler] = None,
                 metrics: Optional[MetricsRecorder] = None,
                 policy: Optional[SchedPolicy] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.batch_slots = batch_slots
        self.s_max = s_max
        self.compute_dtype = compute_dtype
        self.temperature = float(temperature)
        if int(top_k) < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
        if not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        if prefill_mode not in ("parallel", "scan"):
            raise ValueError(f"prefill_mode must be 'parallel' or 'scan', "
                             f"got {prefill_mode!r}")
        if paged_attn_impl not in ("auto", "kernel", "einsum"):
            raise ValueError(f"paged_attn_impl must be 'auto', 'kernel' or "
                             f"'einsum', got {paged_attn_impl!r}")
        if self.cfg.family not in (Family.DENSE, Family.SSM, Family.HYBRID):
            raise _not_ported(f"serving the {self.cfg.family.value} family",
                              "5")
        self.prefill_mode = prefill_mode
        self.prefill_chunk_tokens = min(int(prefill_chunk_tokens), s_max)
        self.prefill_ladder = chunk_ladder(self.prefill_chunk_tokens)
        if prefill_attn_impl == "auto":
            prefill_attn_impl = ("pallas" if self.device.type == "cuda"
                                 else "einsum")
        self.prefill_attn_impl = prefill_attn_impl
        self._jobs: List[_PrefillJob] = []
        self.max_prefill_tokens_per_tick = 0   # head-of-line bound witness
        # every SchedPolicy default is off: policy=None keeps today's greedy
        # FIFO path. Resolved before the scheduler, so a default-built
        # Scheduler inherits policy.edf (an empty Scheduler is falsy, hence
        # the explicit None checks)
        self.policy = SchedPolicy() if policy is None else policy
        self.scheduler = (Scheduler(edf=self.policy.edf)
                          if scheduler is None else scheduler)
        self.metrics = MetricsRecorder() if metrics is None else metrics
        self._drr_cursor = 0          # rotates the DRR starting job per tick
        self._consec_prefill_ticks = 0  # starvation-guard state

        if page_size is not None and self.cfg.family == Family.SSM:
            log.warning("ssm/rwkv state is O(1) in s_max — ignoring paging")
            page_size = None
        self.page_size = page_size
        self.paged = page_size is not None
        if self.paged:
            if s_max % page_size:
                raise ValueError(f"s_max {s_max} must be a multiple of "
                                 f"page_size {page_size}")
            self.max_pages_per_slot = s_max // page_size
            self.num_pages = (num_pages if num_pages is not None
                              else batch_slots * self.max_pages_per_slot)
            self.backend: KVBackend = make_backend(
                kv_backend, family=self.cfg.family, page_size=page_size,
                num_pages=self.num_pages)
            self.capacity = self.backend.capacity(self.cfg, s_max)
            self.allocator = PageAllocator(self.num_pages)
            self.slot_pages: List[List[int]] = [[] for _ in
                                                range(batch_slots)]
            self._bt_host = np.full((batch_slots, self.max_pages_per_slot),
                                    -1, np.int32)
        else:
            self.backend = make_backend(kv_backend, family=self.cfg.family)
        self.cache = self.backend.init_cache(model, batch_slots, s_max,
                                             compute_dtype, self.device)

        # prefix cache: paged + parallel prefill + an attention-only family
        # (None = on where supported; an explicit True elsewhere warns and
        # falls back to full prefill, as repro does)
        supported = (self.paged and prefill_mode == "parallel"
                     and self.cfg.family in PREFIX_CACHE_FAMILIES)
        if prefix_cache is None:
            prefix_cache = supported
        elif prefix_cache and not supported:
            log.warning("prefix_cache unsupported here (needs paged cache, "
                        "parallel prefill, and a dense/MoE/VLM family; got "
                        "paged=%s mode=%s family=%s) — falling back to full "
                        "prefill", self.paged, prefill_mode, self.cfg.family)
            prefix_cache = False
        self.prefix_cache = bool(prefix_cache)
        self.prefix_index = (PrefixIndex(self.allocator, self.page_size)
                             if self.prefix_cache else None)

        kernel_ok = self.paged and self.cfg.family in PAGED_KERNEL_FAMILIES
        if paged_attn_impl == "auto":
            # the one-page-per-slot config (page_size == s_max) stays on the
            # einsum path: it is the dense bit-exactness anchor
            paged_attn_impl = (self.backend.resolve_attn_impl(
                self.cfg.family, self.max_pages_per_slot > 1)
                if self.paged else "einsum")
        elif paged_attn_impl == "kernel" and not kernel_ok:
            log.warning("paged_attn_impl='kernel' unsupported here (needs a "
                        "paged cache on a dense/MoE/VLM/encdec family; got "
                        "paged=%s family=%s) — using the masked-einsum path",
                        self.paged, self.cfg.family)
            paged_attn_impl = "einsum"
        self.paged_attn_impl = paged_attn_impl
        # incremental splice: chunks write K/V straight into their pages and
        # attend them through the block table; no transient request cache
        self.incremental_splice = (self.paged and prefill_mode == "parallel"
                                   and paged_attn_impl == "kernel")
        self.prefill_failures = 0
        self.max_transient_cache_bytes = 0
        self._cancel_at_splice: set = set()
        self._decode = steps_mod.make_decode_step(
            model, compute_dtype=compute_dtype,
            paged_attn_impl=paged_attn_impl if self.paged else None)
        self._chunk_paged = steps_mod.make_prefill_chunk_paged(
            model, compute_dtype=compute_dtype, attn_impl=paged_attn_impl)
        self._chunk_first = steps_mod.make_prefill_chunk(
            model, compute_dtype=compute_dtype, s_max=s_max,
            cache_dtype=compute_dtype, first=True,
            attn_impl=prefill_attn_impl)
        self._chunk_cont = steps_mod.make_prefill_chunk(
            model, compute_dtype=compute_dtype, attn_impl=prefill_attn_impl)
        self._prefill_scan = steps_mod.make_prefill(
            model, compute_dtype=compute_dtype, return_cache=True,
            s_max=s_max, cache_dtype=compute_dtype)

        # (head rid, free pages, index version) at the last deferral: admit()
        # short-circuits while nothing that could change the outcome moved
        self._defer_state: Optional[tuple] = None
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.cur_token = np.zeros((batch_slots, 1), np.int64)
        self.requests: Dict[int, Request] = {}
        self.deferrals = 0    # admissions postponed for lack of free pages
        self._next_rid = 0
        # sampling draws: one generator on the engine's device, advanced by
        # one draw per sampling event (repro folds its key per event)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))

    # ------------------------------------------------------------ factory
    @classmethod
    def build(cls, arch: str = "hymba-1.5b", *,
              config: Optional[ServeConfig] = None,
              **legacy) -> "ServeEngine":
        """Construct model + random params (from ``config.seed``) on
        ``config.device`` and the engine over them; ``config.validate`` runs
        before any weights are built. ``cfg_overrides`` are applied after
        reduction (``reduced=False, cfg_overrides={"num_layers": 4}`` keeps
        every width of the arch and cuts its depth).

        DEPRECATED spelling, kept because ``repro``'s callers use it:
        ``build(arch, page_size=..., s_max=...)``. Each keyword maps onto
        the ``ServeConfig`` field of the same name, with a
        ``DeprecationWarning``; passing both ``config`` and keywords, or an
        unknown keyword, raises as ``repro`` does."""
        if legacy:
            if config is not None:
                raise ValueError(
                    "pass either config=ServeConfig(...) or the legacy "
                    "keyword arguments, not both; the legacy kwargs are "
                    f"deprecated (got {sorted(legacy)})")
            known = {f.name for f in dataclasses.fields(ServeConfig)}
            unknown = sorted(set(legacy) - known)
            if unknown:
                raise TypeError(f"unknown ServeEngine.build arguments "
                                f"{unknown}; ServeConfig fields: "
                                f"{sorted(known)}")
            warnings.warn(
                "ServeEngine.build(**kwargs) is deprecated; pass "
                "config=ServeConfig(...) instead (same field names)",
                DeprecationWarning, stacklevel=2)
            config = ServeConfig(**legacy)
        elif config is None:
            config = ServeConfig()
        device = resolve_device(config.device)
        cfg = configs.get_config(arch)
        if config.reduced:
            cfg = reduced_config(cfg)
        if config.cfg_overrides:
            cfg = dataclasses.replace(cfg, **config.cfg_overrides)
        config.validate(cfg)
        model = get_model(cfg)
        gen = torch.Generator(device=device).manual_seed(config.seed)
        params = model.init(gen, device)
        if config.quantize_int8:
            params = dequantize_params(quantize_params(params),
                                       config.compute_dtype)
        return cls(model, params, **config.engine_kwargs())

    # ------------------------------------------------------------ sampling
    def _filter_logits(self, scaled):
        """Restrict temperature-scaled logits (B, V) to the top-k highest
        and then the nucleus (the smallest prefix of the remaining sorted
        distribution whose cumulative probability reaches top_p); masked
        entries go to -inf. Top-k alone is one ``topk`` threshold (ties at
        the k-th value are kept); with top_p one descending sort serves
        both filters, and the kept set, a prefix of the sorted order, masks
        the unsorted row through one scalar threshold per row — the
        reference's sets exactly."""
        V = scaled.shape[-1]
        neg = torch.tensor(-torch.inf, dtype=scaled.dtype,
                           device=scaled.device)
        use_k = 0 < self.top_k < V
        if self.top_p >= 1.0:
            if not use_k:
                return scaled
            kth = torch.topk(scaled, self.top_k, dim=-1).values[:, -1:]
            return torch.where(scaled < kth, neg, scaled)
        srt = torch.sort(scaled, dim=-1, descending=True).values
        if use_k:
            keep_k = torch.arange(V, device=scaled.device) < self.top_k
            srt = torch.where(keep_k, srt, neg)
        probs = torch.softmax(srt, dim=-1)      # -inf entries carry no mass
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < self.top_p         # minimal prefix reaching p
        thresh = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
        return torch.where(scaled < thresh, neg, scaled)

    def _sample_rows(self, logits) -> np.ndarray:
        """logits: (B, 1, V_padded) -> (B,) sampled token per row: argmax at
        temperature 0, else the argmax of the filtered row plus Gumbel
        noise (one categorical draw per row, as ``jax.random.categorical``
        draws)."""
        row = logits[:, 0, : self.cfg.vocab_size]
        if self.temperature <= 0.0:
            return torch.argmax(row, dim=-1).cpu().numpy()
        u = torch.rand(row.shape, generator=self._gen, device=row.device,
                       dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u))      # u == 0 gives -inf: no draw
        filtered = self._filter_logits(row / self.temperature)
        return torch.argmax(filtered + gumbel, dim=-1).cpu().numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ paging
    @staticmethod
    def _rows_needed(prompt_len: int, gen_len: int) -> int:
        """Cache rows a request writes: the prompt plus the gen_len - 1
        fed-back decode tokens (the final sampled token is never written)."""
        return prompt_len + max(int(gen_len) - 1, 0)

    def _pages_for_rows(self, rows: int) -> int:
        return -(-min(rows, self.capacity) // self.page_size)

    def _pages_needed(self, req: Request) -> int:
        return self._pages_for_rows(
            self._rows_needed(len(req.prompt), req.remaining))

    def _upload_block_tables(self):
        self.cache["block_tables"].copy_(torch.from_numpy(self._bt_host))

    def _phys_rows(self, slots: List[int], floor: int = 0) -> np.ndarray:
        """(K, capacity) flattened pool row per logical cache row of a
        prefill group; rows beyond a slot's reservation, and rows below
        ``floor`` (shared immutable prefix pages), map out of bounds and
        are dropped by the paged splice."""
        ps = self.page_size
        C = self.capacity
        oob = self.num_pages * ps
        phys = np.full((len(slots), C), oob, np.int64)
        j = np.arange(C)
        for i, slot in enumerate(slots):
            pages = np.asarray(self.slot_pages[slot], np.int64)
            cov = min(C, len(pages) * ps)
            phys[i, :cov] = pages[j[:cov] // ps] * ps + j[:cov] % ps
        if floor > 0:
            phys[:, :min(floor, C)] = oob
        return phys

    def _prefix_gather_rows(self, plans: List[PrefixPlan], cached_len: int):
        """(K, s_max) flattened pool rows and validity mask covering each
        request's cached prefix: rows [0, cached_len) map through the hit's
        full pages and a partial hit's copy-on-write SOURCE page (not the
        fresh page the block table holds in its place)."""
        ps = self.page_size
        K = len(plans)
        phys = np.zeros((K, self.s_max), np.int64)
        ok = np.zeros((K, self.s_max), bool)
        j = np.arange(cached_len)
        for i, plan in enumerate(plans):
            pages = list(plan.shared_pages)
            if plan.partial is not None:
                pages.append(plan.partial[0])
            pages = np.asarray(pages, np.int64)
            phys[i, :cached_len] = pages[j // ps] * ps + j % ps
            ok[i, :cached_len] = True
        return phys, ok

    @property
    def free_pages(self) -> int:
        return self.allocator.free if self.paged else 0

    # ------------------------------------------------------------ lifecycle
    def submit(self, prompt, gen_len: int, priority: int = 0,
               deadline: Optional[float] = None) -> Request:
        """Enqueue a request; admission happens on the next step()/run().
        Rejects up front what can never be served (empty prompt, negative
        gen_len, rows beyond s_max or beyond the whole pool), so admission
        is infallible. ``deadline``: an absolute completion deadline on the
        caller's clock, which an EDF scheduler (``SchedPolicy.edf``) orders
        by within a priority level; inert otherwise."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be a 1-D token vector, got shape "
                             f"{prompt.shape}")
        if prompt.size == 0:
            raise ValueError("empty prompt: prefill needs at least one token")
        if int(gen_len) < 0:
            raise ValueError(f"gen_len must be >= 0, got {gen_len}")
        rows = self._rows_needed(len(prompt), gen_len)
        if len(prompt) > self.s_max or rows > self.s_max:
            raise ValueError(
                f"prompt_len {len(prompt)} + gen_len {gen_len} does not fit "
                f"s_max {self.s_max}; raise s_max or shorten the request")
        if self.paged:
            need = self._pages_for_rows(rows)
            if need > self.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.num_pages}; grow num_pages")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, gen_len=int(gen_len),
                      priority=priority)
        if deadline is not None:
            req.deadline = float(deadline)
        if (self.prefix_index is not None
                and getattr(self.scheduler, "prefix_aware", False)):
            req.prefix_hint = self.prefix_index.probe_len(prompt)
        self.requests[rid] = req
        self.metrics.on_submit(rid, len(req.prompt), priority)
        self.scheduler.submit(req)
        return req

    @property
    def free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is None]

    @property
    def active(self) -> int:
        return sum(1 for r in self.slot_req if r is not None)

    @property
    def running(self) -> int:
        return sum(1 for r in self.slot_req
                   if r is not None and r.state == RequestState.RUNNING)

    def admit(self) -> int:
        """Admit waiting requests into free slots; returns #admitted.

        A head the policy sheds is FAILED and the next one peeked; a head
        it defers stops admission. Paged admission PEEKS before popping:
        when the free list cannot cover the head request's worst case
        (after LRU eviction of index-only prefix pages, and with
        ``policy.preemption`` after pausing lower-priority RUNNING slots),
        it stops and the head stays queued. With the prefix cache, the
        longest cached page-aligned prefix aliases into the block table and
        only the rest is freshly allocated.
        Admitted requests are grouped by (prompt_len, cached_len): in
        ``parallel`` mode each group becomes a chunked prefill job, in
        ``scan`` mode it is prefilled here in one teacher-forced pass."""
        pairs = []
        plans: Dict[int, Optional[PrefixPlan]] = {}
        for slot in self.free_slots:
            req = self.scheduler.peek()
            while req is not None and self._shed_head(req):
                req = self.scheduler.peek()
            if req is None:
                break
            if self._defer_head(req):
                break
            plan = None
            if self.paged:
                defer_state = (req.rid, self.allocator.free,
                               self.prefix_index.version
                               if self.prefix_index is not None else 0)
                if defer_state == self._defer_state:
                    break   # same head, same pages, same index: still short
                shared: List[int] = []
                refs: List[int] = []
                if self.prefix_index is not None:
                    plan = self.prefix_index.lookup(req.prompt)
                    shared = list(plan.shared_pages)
                    # ref every page the plan READS (aliases and the partial
                    # COW source) so eviction for a later slot in this loop
                    # cannot free them; the partial ref drops after the COW
                    # copy (or the transient path's seed gather)
                    refs = shared + ([plan.partial[0]] if plan.partial
                                     else [])
                    for pg in refs:
                        self.allocator.share(pg)
                need = self._pages_needed(req) - len(shared)
                fresh = self.allocator.alloc(need)
                if fresh is None and self.prefix_index is not None:
                    evicted = self.prefix_index.evict(
                        need - self.allocator.free)
                    if evicted:
                        self.metrics.on_prefix_evict(evicted)
                    fresh = self.allocator.alloc(need)
                if fresh is None and self.policy.preemption:
                    # pause strictly-lower-priority RUNNING slots until the
                    # head fits; each pause demotes the victim's registered
                    # prompt pages to index-only, so eviction runs again
                    while fresh is None and \
                            self._preempt_lowest(below=req.priority):
                        if (self.prefix_index is not None
                                and need > self.allocator.free):
                            evicted = self.prefix_index.evict(
                                need - self.allocator.free)
                            if evicted:
                                self.metrics.on_prefix_evict(evicted)
                        fresh = self.allocator.alloc(need)
                if fresh is None:
                    if refs:
                        self.allocator.release(refs)
                    self.deferrals += 1
                    self._defer_state = (req.rid, self.allocator.free,
                                         self.prefix_index.version
                                         if self.prefix_index is not None
                                         else 0)
                    break
                if plan is not None:
                    self.metrics.on_prefix_lookup(plan.cached_len,
                                                  len(shared), plan.cow)
                pages = shared + fresh
                self.slot_pages[slot] = pages
                self._bt_host[slot, :] = -1
                self._bt_host[slot, :len(pages)] = pages
            self.scheduler.next_request()       # pop the peeked head
            req.state = RequestState.PREFILLING
            req.slot = slot
            self.slot_req[slot] = req
            self.metrics.on_admit(req.rid)
            self.metrics.on_prefill(req.rid, len(req.prompt))
            plans[slot] = plan
            pairs.append((slot, req))
        if self.paged and pairs:
            self._upload_block_tables()
        groups: Dict[tuple, list] = {}
        for slot, req in pairs:
            plan = plans[slot]
            cached = plan.cached_len if plan is not None else 0
            groups.setdefault((len(req.prompt), cached), []).append(
                (slot, req))
        for (plen, cached), group in groups.items():
            if self.prefill_mode == "scan":
                self._prefill_group_scan(group)
                continue
            # at least one position always runs: the last prompt position's
            # logits sample the first token, so a full hit recomputes it
            tail_start = min(cached, plen - 1)
            job = _PrefillJob(
                slots=[s for s, _ in group],
                reqs=[r for _, r in group],
                prompts=np.stack([r.prompt[tail_start:] for _, r in group]),
                plan=chunk_plan(plen - tail_start, self.prefill_ladder),
                tail_start=tail_start,
                write_floor=(cached // self.page_size * self.page_size
                             if cached else 0),
                prefix_plans=([plans[s] for s, _ in group]
                              if self.prefix_index is not None else None))
            if cached:
                if self.incremental_splice:
                    # aliased full pages are read in place by the paged
                    # chunk attention: only a partial hit's page is copied
                    self._cow_materialise_job(job, cached)
                else:
                    self._seed_prefix_job(job, cached)
            self._jobs.append(job)
        return len(pairs)

    # ------------------------------------------- admission control / preempt
    def _admission_pressure(self) -> bool:
        """True when the available-page fraction (the free list plus the
        prefix index's reclaimable pages) is below the policy's low-water
        mark. Always False for dense caches and with the default policy."""
        pol = self.policy
        if not (self.paged and pol.admission_low_water > 0.0):
            return False
        avail = self.allocator.free
        if self.prefix_index is not None:
            avail += self.prefix_index.reclaimable
        return avail < pol.admission_low_water * self.num_pages

    def _gated(self, req: Request) -> bool:
        pol = self.policy
        return (pol.admission_shed_priority is not None
                and req.priority >= pol.admission_shed_priority
                and self._admission_pressure())

    def _shed_head(self, req: Request) -> bool:
        """Under pool pressure a queued head at or below the shed priority
        is popped and FAILED. Returns True when the head was shed."""
        if not (self.policy.admission_shed and self._gated(req)):
            return False
        self.scheduler.next_request()
        req.state = RequestState.FAILED
        req.error = "shed: free pages below admission low water"
        self.metrics.on_shed(req.rid)
        self.metrics.on_aborted(req.rid)
        return True

    def _defer_head(self, req: Request) -> bool:
        """``admission_shed=False``: the gated head stays queued (strict
        order) until completions lift the pool over the low-water mark."""
        return (not self.policy.admission_shed) and self._gated(req)

    def _preempt_lowest(self, below: int) -> bool:
        """Preempt the worst-priority RUNNING slot whose priority is
        strictly worse than ``below``; among equals the most recently
        submitted. Returns False when no victim exists."""
        victim_slot, victim = None, None
        for slot, r in enumerate(self.slot_req):
            if r is None or r.state is not RequestState.RUNNING:
                continue
            if r.priority <= below:
                continue
            if victim is None or (r.priority, r.rid) > (victim.priority,
                                                        victim.rid):
                victim_slot, victim = slot, r
        if victim is None:
            return False
        self._preempt(victim_slot)
        return True

    def _preempt(self, slot: int):
        """Pause a RUNNING request recompute-style: release its slot and
        pages, fold the tokens generated since the last fold into the
        prompt (``Request.folded`` watermark) and re-queue it under its
        original arrival seq. Re-admission re-prefills the folded prompt
        and the splice samples the token the uninterrupted decode would
        have, so greedy streams are unchanged by a pause."""
        req = self.slot_req[slot]
        fresh = req.tokens[req.folded:]
        if fresh:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(fresh, np.int32)])
            req.folded = len(req.tokens)
        req.state = RequestState.QUEUED
        req.slot = None
        self.slot_req[slot] = None
        self.cur_token[slot, 0] = 0
        self.cache["pos"][slot] = INACTIVE_POS
        if self.paged:
            self.allocator.release(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self._bt_host[slot, :] = -1
            self._upload_block_tables()
        self.metrics.on_preempt(req.rid)
        self._defer_state = None      # freed pages can change the outcome
        self.scheduler.submit(req)

    def _seed_prefix_job(self, job: _PrefillJob, cached_len: int):
        """Transient-path half of a prefix hit: gather the cached rows (full
        pages and the partial copy-on-write source) into a fresh dense
        batch-K cache positioned at the tail start, so every chunk is a
        continuation; the completion splice lands the partial rows in the
        fresh page. The gather wall is charged to prefill."""
        phys, ok = self._prefix_gather_rows(job.prefix_plans, cached_len)
        t0 = self.metrics.now()
        job.cache = self.backend.seed_prefix(
            self.model, self.s_max, self.compute_dtype)(
            self.cache, torch.from_numpy(phys).to(self.device),
            torch.from_numpy(ok).to(self.device), job.tail_start)
        self._sync()
        self.metrics.on_prefix_gather(self.metrics.now() - t0)
        for plan in job.prefix_plans:
            if plan.partial is not None:
                self.allocator.release([plan.partial[0]])

    def _cow_materialise_job(self, job: _PrefillJob, cached_len: int):
        """Prefix-hit half of admission: aliased FULL pages need no work
        (the chunks read them through the block table), but a partial hit's
        rows ``[write_floor, cached_len)`` live in a shared SOURCE page
        while the block table holds a fresh page in its place — copy them
        across, then drop the admission-time source references. The copy
        wall is charged to prefill."""
        ps = self.page_size
        n = cached_len - job.write_floor          # partial rows to copy
        if n > 0:
            oob = self.num_pages * ps
            K = len(job.slots)
            src = np.zeros((K, ps), np.int64)
            dst = np.full((K, ps), oob, np.int64)
            offs = np.arange(ps)
            for i, (slot, plan) in enumerate(zip(job.slots,
                                                 job.prefix_plans)):
                if plan.partial is None:
                    continue
                fresh = self.slot_pages[slot][cached_len // ps]
                src[i, :n] = plan.partial[0] * ps + offs[:n]
                dst[i, :n] = fresh * ps + offs[:n]
            t0 = self.metrics.now()
            self.backend.copy_rows(self.cache,
                                   torch.from_numpy(src).to(self.device),
                                   torch.from_numpy(dst).to(self.device))
            self._sync()
            self.metrics.on_prefix_gather(self.metrics.now() - t0)
        for plan in job.prefix_plans:
            if plan.partial is not None:
                self.allocator.release([plan.partial[0]])

    def _prefill_group_scan(self, group):
        """Prefill K same-length requests jointly in one teacher-forced pass
        through ``decode_step`` (the bit-exactness anchor), then splice."""
        plen = len(group[0][1].prompt)
        prompts = torch.from_numpy(np.stack(
            [r.prompt for _, r in group]).astype(np.int64)).to(self.device)
        t0 = self.metrics.now()
        logits, rcache = self._prefill_scan(self.params, {"tokens": prompts})
        self._sync()
        self.metrics.on_prefill_chunk(len(group) * plen,
                                      self.metrics.now() - t0)
        self._splice_and_start([s for s, _ in group], [r for _, r in group],
                               rcache, logits)

    # ------------------------------------------------- chunked prefill
    def _prefill_tick(self) -> int:
        """Ingest at most ``prefill_chunk_tokens`` prompt positions of
        queued prefill work: ladder chunks that fit the remaining budget
        run back to back, in strict job-FIFO order, or by deficit
        round-robin across jobs with ``policy.drr``. A chunk whose dispatch
        raised has had its job released; the tick moves on. Returns
        positions ingested."""
        budget = self.prefill_chunk_tokens
        if self.policy.drr and len(self._jobs) > 1:
            ingested = self._prefill_tick_drr(budget)
        else:
            ingested = 0
            while self._jobs and budget > 0:
                job = self._jobs[0]
                if job.plan[job.idx] > budget:
                    break
                got = self._run_chunk(job)
                if got is None:     # dispatch raised; the job was released
                    continue
                budget -= got
                ingested += got
        self.max_prefill_tokens_per_tick = max(
            self.max_prefill_tokens_per_tick, ingested)
        return ingested

    def _prefill_tick_drr(self, budget: int) -> int:
        """Deficit round-robin across pending prefill jobs: each earns a
        quantum of chunk-token credit per tick (carry capped at twice the
        tick budget) and spends it in a rotation whose start advances every
        tick. The per-tick budget is unchanged; DRR only shares it."""
        ingested = 0
        q = self.policy.drr_quantum or max(1, budget // len(self._jobs))
        for job in self._jobs:
            job.deficit = min(job.deficit + q, 2 * self.prefill_chunk_tokens)
        self._drr_cursor += 1
        while budget > 0 and self._jobs:
            n = len(self._jobs)
            order = [self._jobs[(self._drr_cursor + k) % n] for k in range(n)]
            ran = False
            for job in order:
                if budget <= 0 or job not in self._jobs:
                    continue        # completed or released by an earlier chunk
                C = job.plan[job.idx]
                if C > budget or C > job.deficit:
                    continue
                got = self._run_chunk(job)
                ran = True
                if got is None:     # the job list changed: rebuild the order
                    break
                job.deficit -= got
                budget -= got
                ingested += got
            if not ran:
                break               # nobody could spend: credit accrues
        return ingested

    def _run_chunk(self, job: _PrefillJob) -> Optional[int]:
        """Run ``job``'s next chunk: on the incremental path its K/V go
        straight into the group's pages; otherwise into the job's transient
        cache (created by the first chunk). On the final chunk, splice and
        start the group. Returns the chunk length, or None when the
        dispatch raised: the error is logged, counted in
        ``prefill_failures`` and the job released as FAILED. On the card
        the device is synchronised first; if that raises, the CUDA context
        is lost and the error leaves ``step``."""
        C = job.plan[job.idx]
        K = len(job.slots)
        dev = self.device
        toks = torch.from_numpy(
            job.prompts[:, job.filled:job.filled + C].astype(np.int64)).to(dev)
        t0 = self.metrics.now()
        try:
            if self.incremental_splice:
                batch = {"tokens": toks,
                         "bt": torch.from_numpy(
                             self._bt_host[job.slots]).to(dev),
                         "start": job.tail_start + job.filled,
                         "floor": job.write_floor}
                logits, self.cache = self._chunk_paged(self.params,
                                                       self.cache, batch)
            elif job.cache is None:
                logits, job.cache = self._chunk_first(self.params,
                                                      {"tokens": toks})
            else:
                logits, job.cache = self._chunk_cont(self.params, job.cache,
                                                     {"tokens": toks})
            self._sync()
        except Exception as err:  # noqa: BLE001 — released, not resumed
            log.exception("prefill chunk failed for rids %s; releasing "
                          "the job", [r.rid for r in job.reqs])
            self.prefill_failures += 1
            # a chunk writes only its own pages above write_floor (nothing
            # is donated), so bystanders' K/V are intact; only a lost CUDA
            # context could take them, and that raises here
            self._sync()
            self.release_job(job, error=err)
            return None
        self.metrics.on_prefill_chunk(K * C, self.metrics.now() - t0)
        self.max_transient_cache_bytes = max(
            self.max_transient_cache_bytes, self.transient_cache_bytes())
        job.idx += 1
        job.filled += C
        if job.idx == len(job.plan):
            self._jobs.remove(job)
            self._splice_and_start(job.slots, job.reqs, job.cache, logits,
                                   write_floor=job.write_floor,
                                   prefix_plans=job.prefix_plans)
        return C

    def _splice_and_start(self, slot_ids, reqs, rcache, logits, *,
                          write_floor: int = 0, prefix_plans=None):
        """Complete a group prefill: land its K/V in the resident cache,
        register the freshly computed prompt pages in the prefix index,
        sample each request's first token from the prefill logits and mark
        the group RUNNING.

        ``rcache`` is the group's transient request cache, spliced into its
        rows (dense) or pages (paged; rows below ``write_floor``, in shared
        prefix pages, are dropped, and a partial hit's rows land in the
        fresh page) — or None on the incremental path, where the chunks
        already wrote the pages and completion only flips the group's
        ``pos`` from INACTIVE_POS to prompt_len."""
        slots = torch.as_tensor(slot_ids, dtype=torch.int64,
                                device=self.device)
        if rcache is None:
            plens = torch.as_tensor([len(r.prompt) for r in reqs],
                                    dtype=torch.int32, device=self.device)
            self.cache["pos"][slots] = plens
        elif self.paged:
            phys = torch.from_numpy(self._phys_rows(slot_ids, write_floor))
            self.cache = self.backend.insert_rows(self.cache, rcache, slots,
                                                  phys.to(self.device))
        else:
            self.cache = self.backend.insert_rows(self.cache, rcache, slots)
        if self.prefix_index is not None and prefix_plans is not None:
            for slot, req, plan in zip(slot_ids, reqs, prefix_plans):
                self.prefix_index.register(plan, self.slot_pages[slot],
                                           len(req.prompt))
        toks = self._sample_rows(logits)
        for i, (slot, req) in enumerate(zip(slot_ids, reqs)):
            req.state = RequestState.RUNNING
            if req.rid in self._cancel_at_splice:   # a grouped member's
                self._cancel_at_splice.discard(req.rid)   # cancel lands here
                self._finish(slot, RequestState.CANCELLED)
                continue
            if req.gen_len <= 0:
                self._finish(slot)
                continue
            # a request resumed after preemption already streamed tokens:
            # this sample is its next token, not its first
            resumed = bool(req.tokens)
            req.tokens.append(int(toks[i]))
            self.cur_token[slot, 0] = int(toks[i])
            if resumed:
                self.metrics.on_token(req.rid)
            else:
                self.metrics.on_first_token(req.rid)
            if req.done:
                self._finish(slot)

    def _finish(self, slot: int, state: RequestState = RequestState.DONE):
        """Retire a slot: park its position at INACTIVE_POS (its writes drop
        from now on), zero its feedback token and return its pages, aliased
        prefix pages included. ``state`` records why (DONE, FAILED or
        CANCELLED); the release is the same. A second call is a no-op."""
        req = self.slot_req[slot]
        if req is None:
            return
        req.state = state
        if state is RequestState.DONE:
            self.metrics.on_done(req.rid)
        else:
            self.metrics.on_aborted(req.rid)
        self.slot_req[slot] = None
        self.cur_token[slot, 0] = 0
        self.cache["pos"][slot] = INACTIVE_POS
        if self.paged:
            self.allocator.release(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self._bt_host[slot, :] = -1
            self._upload_block_tables()

    def release_job(self, job: _PrefillJob, error=None,
                    state: RequestState = RequestState.FAILED):
        """Abort an in-flight prefill job and reclaim everything it holds:
        the group's slots, reserved pages and aliased prefix references
        (through ``_finish``), and the transient request cache. Called when
        a chunk dispatch raises and by :meth:`cancel`."""
        if job in self._jobs:
            self._jobs.remove(job)
        job.cache = None
        msg = "cancelled" if state is RequestState.CANCELLED else repr(error)
        for slot, req in zip(job.slots, job.reqs):
            req.error = msg
            self._cancel_at_splice.discard(req.rid)
            self._finish(slot, state)

    def cancel(self, rid: int) -> bool:
        """Cancel a request; returns True if it was still live. A QUEUED
        request is marked and skipped at admission; a PREFILLING one aborts
        at once when it is its job's only member and at the group's splice
        otherwise (the group's batch cannot change mid-stream); a RUNNING
        one retires its slot on the spot. Every reserved page and aliased
        prefix reference is released."""
        req = self.requests.get(rid)
        if req is None or req.state in (RequestState.DONE,
                                        RequestState.FAILED,
                                        RequestState.CANCELLED):
            return False
        if req.state is RequestState.QUEUED:
            req.state = RequestState.CANCELLED
            req.error = "cancelled"
            self.metrics.on_aborted(rid)
            return True
        if req.state is RequestState.PREFILLING:
            job = next((j for j in self._jobs if req in j.reqs), None)
            if job is None:                  # no chunk job (scan mode)
                self._finish(req.slot, RequestState.CANCELLED)
                req.error = "cancelled"
                return True
            if len(job.reqs) == 1:
                self.release_job(job, state=RequestState.CANCELLED)
            else:
                req.error = "cancelled"
                self._cancel_at_splice.add(rid)
            return True
        self._finish(req.slot, RequestState.CANCELLED)   # RUNNING
        req.error = "cancelled"
        return True

    def drain_completed(self) -> List[Request]:
        """Remove and return finished requests (DONE, FAILED, CANCELLED);
        the engine otherwise keeps every request for its lifetime. Metric
        records stay, so summary() percentiles stay complete."""
        done = [r for r in self.requests.values()
                if r.state in (RequestState.DONE, RequestState.FAILED,
                               RequestState.CANCELLED)]
        for r in done:
            del self.requests[r.rid]
        return done

    def resident_cache_bytes(self) -> int:
        """Device bytes of the resident serving cache: every leaf the
        backend built (pools, per-page scales, block tables, positions),
        not a fixed k/v pair, so int8 scales and a single latent pool
        count as they are."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def transient_cache_bytes(self) -> int:
        """Device bytes held right now by in-flight prefill jobs' transient
        request caches: 0 on the incremental path by construction."""
        return sum(t.numel() * t.element_size() for job in self._jobs
                   if job.cache is not None for t in job.cache.values())

    def assert_page_invariants(self):
        """Raise on violated page bookkeeping: no page both free and
        referenced, every live block-table or index page referenced, free +
        held partitions the pool, and the backend's per-page metadata (the
        int8 scales) is well formed. Nothing to check when dense."""
        if not self.paged:
            return
        free = set(self.allocator._free)
        held = self.allocator.held
        assert not (free & held), f"pages both free and referenced: {free & held}"
        assert free | held == set(range(self.num_pages)), "page leaked"
        live = {pg for pages in self.slot_pages for pg in pages}
        assert not (free & live), "page both free and in a live block table"
        for pg in live:
            assert self.allocator.refcount(pg) >= 1, f"live page {pg} unref'd"
        if self.prefix_index is not None:
            idx = set(self.prefix_index.pages)
            assert not (free & idx), "page both free and in the prefix index"
            for pg in idx:
                assert self.allocator.refcount(pg) >= 1, \
                    f"indexed page {pg} unref'd"
        self.backend.check_page_meta(self.cache, self.num_pages)

    def step(self) -> int:
        """One engine tick: admit, ingest at most one prefill-chunk budget,
        one decode tick for every RUNNING slot, admit again into slots freed
        on this tick. Returns #active after the tick. With
        ``policy.max_consecutive_prefill_ticks`` set, the starvation guard
        skips the prefill interleave for one tick after that many
        consecutive ticks in which prefill ran while slots were decoding."""
        self.admit()
        pol = self.policy
        if (pol.max_consecutive_prefill_ticks > 0 and self._jobs
                and self.running > 0
                and self._consec_prefill_ticks
                >= pol.max_consecutive_prefill_ticks):
            self._consec_prefill_ticks = 0
            self.metrics.on_starvation_skip()
        else:
            ingested = self._prefill_tick()
            if ingested > 0 and self.running > 0:
                self._consec_prefill_ticks += 1
            else:
                self._consec_prefill_ticks = 0
        if self.running:
            batch = {"token": torch.from_numpy(self.cur_token).to(self.device)}
            logits, self.cache = self._decode(self.params, self.cache, batch)
            self.metrics.on_decode_step()
            nxt = self._sample_rows(logits)
            for slot, req in enumerate(self.slot_req):
                if req is None or req.state != RequestState.RUNNING:
                    continue
                req.tokens.append(int(nxt[slot]))
                self.cur_token[slot, 0] = int(nxt[slot])
                self.metrics.on_token(req.rid)
                if req.done:
                    self._finish(slot)
        self.admit()
        return self.active

    def run(self) -> dict:
        """Serve until queue and slots drain; returns the metrics summary."""
        self.metrics.on_start()
        while self.scheduler.waiting or self.active:
            self.step()
        self._sync()
        self.metrics.on_stop()
        return self.metrics.summary()
