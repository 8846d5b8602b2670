"""KV-cache backends: the seam between the serving engine's orchestration
and the cache's representation, as in ``repro/serve/kvcache.py``.

* :class:`DenseBackend`: per-slot (B, s_max) rows.
* :class:`PagedFP32Backend`: the vLLM-style shared fp32 page pool.
* :class:`PagedInt8Backend`: int8 page pools with one symmetric f32 scale
  per page and kv-head group (the page is the quantization block), in
  (L, P, tp) "k_scale"/"v_scale" leaves beside the pools: group t covers
  the KV / tp kv heads rank t holds, so each scale is an amax over
  rank-local values. Writes re-quantize the page they touch; reads
  dequantize inside the paged kernel's gather. A prefix hit aliases a
  page's scales with its payload; copy-on-write carries the source page's
  scale and the next splice re-quantizes the fresh page once.
* :class:`PagedLatentBackend`: MLA latent pages, one (c + r)-wide row per
  token shared by every head, in a single "k" pool.

Sharding is a property of the backend, as in the reference:
``pool_axes()`` declares each leaf's logical axes, ``place(cache, mesh)``
keeps of each leaf declared on "kv_heads" only this rank's slab (the K/V
pools (L, P, ps, KV / tp, hd), the int8 scales (L, P, 1), this rank's
column of the reference's (L, P, tp)) and every other leaf whole, and
``tp_compatible`` is the capability query ``ServeConfig.validate`` and
:func:`make_backend` consult. A backend that declares nothing serves under
tp with its cache whole on every rank (and a warning). Page ids are
shard-invariant, so block tables, positions and the host-side allocator
and prefix index are the same on every rank. The splices write the
resident cache in place and return it; under tp the completion splice
writes the rank's slab of the transient rows and the prefix seed
all-gathers the slabs it reads back.
"""
from __future__ import annotations

import functools
import logging

import torch

from repro_torch.configs.base import ArchConfig, Family
from repro_torch.core.quantize import page_scale
from repro_torch.models.registry import (Model, cache_capacity, copy_pool_rows,
                                         init_paged_cache, insert_cache_rows,
                                         insert_cache_rows_paged,
                                         seed_prefix_cache,
                                         vectorize_cache_pos)
from repro_torch.sharding import specs as _sp

log = logging.getLogger("repro_torch.serve")

# families whose transient prefill state is exactly (k, v, pos): the ones
# page-level prefix caching can serve
PREFIX_CACHE_FAMILIES = (Family.DENSE, Family.MOE, Family.VLM)

# families whose paged decode/prefill can route through the paged kernel
PAGED_KERNEL_FAMILIES = (Family.DENSE, Family.MOE, Family.VLM, Family.ENCDEC)

# families the int8 backend supports (the quantized writes live in the
# transformer's attention; other families keep fp32 pages)
INT8_KV_FAMILIES = PREFIX_CACHE_FAMILIES


# ------------------------------------------------------------ int8 splices
def _quantize_pool_rows(req, C: int, ps: int, groups: int = 1):
    """Quantize a transient-cache leaf (L, K, >=C, KV, hd) page block by
    page block. Returns (q (L, K, C, KV, hd) int8, scale (L, K, C // ps,
    groups) f32): one symmetric scale per logical page and kv-head group.
    The engine's write floor is page-aligned, so a splice drops whole
    pages and payload and scale stay consistent."""
    rows = req[:, :, :C].float()
    Lr, K = rows.shape[:2]
    KV, hd = rows.shape[3], rows.shape[4]
    blocks = rows.reshape(Lr, K, C // ps, ps, groups, KV // groups, hd)
    scale = page_scale(blocks.abs().amax(dim=(3, 5, 6)))
    q = torch.clamp(torch.round(blocks / scale[:, :, :, None, :, None, None]),
                    -127, 127).to(torch.int8)
    return q.reshape(Lr, K, C, KV, hd), scale


def insert_cache_rows_paged_q8(cache, request_cache, slots, phys_rows):
    """Int8 completion splice, in place: as
    ``registry.insert_cache_rows_paged``, but the fp32 transient K/V rows
    are quantized page by page on the way into the int8 pools and each
    written page's scales land in the (L, P, T) scale leaves (T groups of
    kv heads: the leaf's trailing dim). Rows and
    pages outside the request's reservation (phys >= P * ps, everything
    below a page-aligned write floor included) drop from payload and scale
    alike. Returns ``cache``."""
    for key, leaf in cache.items():
        if key == "block_tables" or key.endswith("_scale"):
            continue                        # scales are written with k/v
        req = request_cache[key]
        if key in ("k", "v"):
            Lr, P, ps = leaf.shape[:3]
            C = phys_rows.shape[1]
            q, scale = _quantize_pool_rows(req, C, ps,
                                           cache[key + "_scale"].shape[-1])
            flat = leaf.view((Lr, P * ps) + tuple(leaf.shape[3:]))
            keep = (phys_rows >= 0) & (phys_rows < P * ps)
            flat[:, phys_rows[keep]] = q[:, keep]
            # a logical page's rows are pool-contiguous: its page id is its
            # first row's phys // ps (out-of-range rows land on page P)
            page_idx = phys_rows[:, ::ps] // ps              # (K, C // ps)
            pkeep = page_idx < P
            cache[key + "_scale"][:, page_idx[pkeep]] = scale[:, pkeep]
        elif key == "pos":
            leaf[slots] = req.to(leaf.dtype)
        else:
            leaf[:, slots] = req.to(leaf.dtype)
    return cache


def copy_pool_rows_q8(cache, src_rows, dst_rows):
    """Int8 copy-on-write, in place: the int8 rows copy verbatim and the
    DESTINATION page takes the SOURCE page's scale, the only one its
    payload decodes under. The tail chunk's splice then re-quantizes the
    fresh page, payload and scale together, once."""
    copy_pool_rows(cache, src_rows, dst_rows)
    for key in ("k", "v"):
        P, ps = cache[key].shape[1:3]
        src_pg = (src_rows[:, 0] // ps).clamp(0, P - 1)
        keep = dst_rows[:, 0] < P * ps
        sc = cache[key + "_scale"]
        sc[:, dst_rows[:, 0][keep] // ps] = sc[:, src_pg[keep]]
    return cache


def seed_prefix_cache_q8(model: Model, cache, phys_rows, row_ok, pos,
                         s_max: int, dtype=torch.float32):
    """Int8 prefix seed: gather the shared prefix rows as
    ``registry.seed_prefix_cache`` does and DEQUANTIZE them with each
    row's page scales, so the transient tail-prefill cache is an f32 view
    of the aliased int8 pages."""
    K = phys_rows.shape[0]
    out = model.init_cache(K, s_max, dtype, device=cache["k"].device)
    idx = torch.where(row_ok, phys_rows, 0)
    for key in ("k", "v"):
        pool = cache[key]                   # (L, P, ps, KV, hd) int8
        Lr, P, ps = pool.shape[:3]
        T = cache[key + "_scale"].shape[-1]
        flat = pool.view((Lr, P * ps) + tuple(pool.shape[3:]))
        pg = (idx // ps).clamp(0, P - 1)
        raw = flat[:, idx].float()                  # (L, K, S, KV, hd)
        KV, hd = raw.shape[-2:]
        grouped = raw.reshape(raw.shape[:3] + (T, KV // T, hd))
        sc = cache[key + "_scale"][:, pg]           # (L, K, S, T)
        rows = (grouped * sc[..., None, None]).reshape(raw.shape)
        out[key] = torch.where(row_ok[None, :, :, None, None], rows,
                               0.0).to(out[key].dtype)
    out["pos"] = torch.tensor(int(pos), dtype=torch.int32,
                              device=cache["k"].device)
    return out


# string-keyed registry: name -> KVBackend subclass
BACKENDS: dict = {}


def register_backend(cls=None, *, aliases=()):
    """Class decorator registering a :class:`KVBackend` subclass under its
    ``name`` (plus any ``aliases``). Re-registering a key raises."""
    def _register(cls):
        for key in (cls.name, *aliases):
            if key in BACKENDS:
                raise ValueError(
                    f"KV backend name {key!r} already registered "
                    f"(by {BACKENDS[key].__name__}); pick a fresh key")
            BACKENDS[key] = cls
        return cls
    return _register(cls) if cls is not None else _register


class KVBackend:
    """Protocol every cache representation implements. Attributes:
    ``name`` (registry key), ``paged`` (pool + block tables vs per-slot
    rows)."""

    name = "abstract"
    paged = False

    @staticmethod
    def capacity(cfg: ArchConfig, s_max: int) -> int:
        """Per-slot row capacity the page allocator must cover."""
        return cache_capacity(cfg, s_max)

    def init_cache(self, model: Model, batch_slots: int, s_max: int, dtype,
                   device):
        raise NotImplementedError

    def insert_rows(self, cache, request_cache, slots, phys_rows=None):
        """Completion splice of a transient batch-K prefill cache into the
        resident cache (phys_rows: the paged row map, None for dense)."""
        raise NotImplementedError

    def copy_rows(self, cache, src_rows, dst_rows):
        """COW re-materialisation of a partial prefix page (paged only)."""
        raise NotImplementedError(f"{self.name} backend has no pages")

    def seed_prefix(self, model: Model, s_max: int, dtype):
        """-> fn(cache, phys_rows, row_ok, pos) building the dense transient
        cache of a prefix-hit tail prefill (paged only)."""
        raise NotImplementedError(f"{self.name} backend has no pages")

    def resolve_attn_impl(self, family: Family, multi_page: bool) -> str:
        """'auto' policy: which paged read path serves this config."""
        return "einsum"

    def check_page_meta(self, cache, num_pages: int) -> None:
        """Invariant hook for per-page metadata (assert_page_invariants)."""

    # ------------------------------------------------------ sharding hooks
    # leaf name -> the dim this rank holds a slab of (set by place())
    sharded: dict = {}

    @classmethod
    def pool_axes(cls) -> dict:
        """Logical sharding axes per cache leaf (leaf name -> logical-axis
        tuple, resolved under ``specs.TP_POOL_RULES``), scale leaves
        included. The base declares nothing: every leaf stays whole."""
        return {}

    @classmethod
    def tp_compatible(cls, mesh) -> bool:
        """Can this representation serve under the given tensor
        parallelism? ``mesh``: a mesh, None or a plain int tp degree
        (``ServeConfig.validate`` runs before any mesh exists)."""
        return True

    def place(self, cache, mesh):
        """Keep of each leaf named in :meth:`pool_axes` this rank's slab on
        its declared axes (resolved under ``specs.TP_POOL_RULES``; a dim the
        axis does not divide stays whole) and every other leaf whole;
        records the sliced dims in ``self.sharded``. No-op without a mesh.
        A backend that never overrode :meth:`pool_axes` keeps its whole
        cache on every rank under tp > 1, with a warning: correct, but the
        pool does not shrink per rank."""
        self.sharded = {}
        if mesh is None:
            return cache
        if (type(self).pool_axes.__func__ is KVBackend.pool_axes.__func__
                and _tp_degree(mesh) > 1):
            log.warning(
                "KV backend %r declares no pool_axes(); placing its cache "
                "fully replicated on the tp=%d mesh (correct, but the pool "
                "does not shrink per shard)", self.name, _tp_degree(mesh))
        axes_map = self.pool_axes()
        with _sp.use_mesh(mesh, _sp.TP_POOL_RULES):
            for key, leaf in cache.items():
                axes = axes_map.get(key)
                if axes is None or len(axes) != leaf.dim():
                    continue
                for d, ax in enumerate(_sp._fit_axes(leaf.shape, axes)):
                    if ax is None:
                        continue
                    mesh_ax = _sp.resolve(ax)[0]
                    idx = [slice(None)] * leaf.dim()
                    idx[d] = _sp.head_slab(leaf.shape[d], mesh, mesh_ax)
                    leaf = cache[key] = leaf[tuple(idx)].contiguous()
                    self.sharded[key] = d
        return cache

    def _local_rows(self, request_cache):
        """A transient request cache with this rank's slab of every leaf
        the resident cache holds a slab of (same dims: the transient
        (L, K, S, KV, hd) rows against the pool's (L, P, ps, KV, hd))."""
        if not self.sharded:
            return request_cache
        out = dict(request_cache)
        for key, d in self.sharded.items():
            if key in out:
                idx = [slice(None)] * out[key].dim()
                idx[d] = _sp.head_slab(out[key].shape[d], self.mesh)
                out[key] = out[key][tuple(idx)]
        return out

    def _gathered(self, seed):
        """``seed`` (a prefix seed over this rank's slab) followed by an
        all-gather of every slab leaf it returns: the transient cache
        every rank prefills with holds every kv head."""
        if not self.sharded:
            return seed

        def gathered(*args, **kwargs):
            out = seed(*args, **kwargs)
            for key, d in self.sharded.items():
                if key in out:
                    out[key] = _sp.all_gather(out[key], d, self.mesh)
            return out
        return gathered


@register_backend
class DenseBackend(KVBackend):
    """The page_size == None layout: per-slot (B, s_max) rows, a batch-axis
    completion splice, no pages, COW or prefix sharing."""

    name = "dense"

    def init_cache(self, model: Model, batch_slots: int, s_max: int, dtype,
                   device):
        return vectorize_cache_pos(
            model.init_cache(batch_slots, s_max, dtype, device), batch_slots,
            inactive=True)

    def insert_rows(self, cache, request_cache, slots, phys_rows=None):
        return insert_cache_rows(cache, request_cache, slots)

    @classmethod
    def tp_compatible(cls, mesh) -> bool:
        # tensor-parallel serving shards the PAGED pool (page ids are
        # shard-invariant); the per-slot dense cache has no mesh layout
        return _tp_degree(mesh) <= 1


def _tp_degree(mesh) -> int:
    """Size of the serving mesh's tensor-parallel axis (1 if no mesh); a
    plain int is taken as the degree itself."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    return _sp.tp_degree(mesh)


def _shards_kv_heads(cls) -> bool:
    """Does this backend's declared pool layout shard the kv-head axis?
    (Gates the num_kv_heads % tp requirement: a whole or head-free pool,
    e.g. paged_latent, has none.)"""
    return any("kv_heads" in axes for axes in cls.pool_axes().values())


def check_tp_support(spec, tp: int) -> None:
    """Raise the reference's tp-incompatibility error when ``spec``'s (a
    registry name or KVBackend class) capability query refuses the tp
    degree. Shared by ``ServeConfig.validate`` and :func:`make_backend`."""
    cls = BACKENDS[spec] if isinstance(spec, str) else spec
    if tp > 1 and not cls.tp_compatible(tp):
        raise ValueError(
            f"kv_backend={cls.name!r} reports tp_compatible=False for "
            f"tp={tp}: this cache representation does not compose with "
            f"tensor-parallel serving; use kv_backend='paged' with tp>1 "
            f"or drop tp")


@register_backend(aliases=("paged_fp32",))
class PagedFP32Backend(KVBackend):
    """The shared fp32 page pool. Page ids index the pool's page axis; the
    engine owns the allocator and block tables.

    ``mesh``: the serving mesh, if any. ``init_cache`` then keeps this
    rank's (L, P, ps, KV / tp, hd) slab of the K/V pools and every other
    leaf whole; the splice, copy-on-write and prefix seed work on the slab
    with the replicated page ids."""

    name = "paged"
    paged = True

    def __init__(self, page_size: int, num_pages: int, mesh=None):
        self.page_size = page_size
        self.num_pages = num_pages
        self.mesh = mesh

    @classmethod
    def pool_axes(cls) -> dict:
        return {"k": _sp.KV_POOL_AXES, "v": _sp.KV_POOL_AXES}

    def init_cache(self, model: Model, batch_slots: int, s_max: int, dtype,
                   device):
        cache = init_paged_cache(model, batch_slots, s_max,
                                 page_size=self.page_size,
                                 num_pages=self.num_pages, dtype=dtype,
                                 device=device)
        return self.place(cache, self.mesh)

    def insert_rows(self, cache, request_cache, slots, phys_rows=None):
        return insert_cache_rows_paged(cache, self._local_rows(request_cache),
                                       slots, phys_rows)

    def copy_rows(self, cache, src_rows, dst_rows):
        return copy_pool_rows(cache, src_rows, dst_rows)

    def seed_prefix(self, model: Model, s_max: int, dtype):
        return self._gathered(functools.partial(
            seed_prefix_cache, model, s_max=s_max, dtype=dtype))

    def resolve_attn_impl(self, family: Family, multi_page: bool) -> str:
        # the one-page-per-slot config stays on the einsum path: it is the
        # dense bit-exactness anchor
        if family in PAGED_KERNEL_FAMILIES and multi_page:
            return "kernel"
        return "einsum"


@register_backend
class PagedInt8Backend(PagedFP32Backend):
    """Int8 page pools and per-page symmetric f32 scales. Block tables, the
    allocator contract and the attention dispatch are the fp32 pool's; the
    representation ops quantize (the splice), carry the scale (COW) and
    dequantize (the prefix seed, the reads)."""

    name = "paged_int8"

    @classmethod
    def pool_axes(cls) -> dict:
        axes = dict(super().pool_axes())
        # scale leaves (L, P, tp): one scale per page per kv-head group,
        # group t covering the KV / tp kv heads rank t holds, so the
        # group column shards with its kv heads and each rank computes
        # its scales from its own slab
        axes["k_scale"] = (None, None, "kv_heads")
        axes["v_scale"] = (None, None, "kv_heads")
        return axes

    def init_cache(self, model: Model, batch_slots: int, s_max: int, dtype,
                   device):
        cache = init_paged_cache(model, batch_slots, s_max,
                                 page_size=self.page_size,
                                 num_pages=self.num_pages, dtype=dtype,
                                 device=device)
        tp = _tp_degree(self.mesh)
        for key in ("k", "v"):
            shape = cache[key].shape
            cache[key] = torch.zeros(shape, dtype=torch.int8, device=device)
            # scale 1.0 everywhere: a never-written page dequantizes to
            # exact zeros, as the fp32 pool's zero init reads
            cache[key + "_scale"] = torch.ones(tuple(shape[:2]) + (tp,),
                                               dtype=torch.float32,
                                               device=device)
        return self.place(cache, self.mesh)

    def insert_rows(self, cache, request_cache, slots, phys_rows=None):
        return insert_cache_rows_paged_q8(
            cache, self._local_rows(request_cache), slots, phys_rows)

    def copy_rows(self, cache, src_rows, dst_rows):
        return copy_pool_rows_q8(cache, src_rows, dst_rows)

    def seed_prefix(self, model: Model, s_max: int, dtype):
        return self._gathered(functools.partial(
            seed_prefix_cache_q8, model, s_max=s_max, dtype=dtype))

    def check_page_meta(self, cache, num_pages: int) -> None:
        # this rank's column of the reference's (L, P, tp) groups
        for key in ("k_scale", "v_scale"):
            sc = cache[key]
            want = (cache[key[0]].shape[0], num_pages, 1)
            assert tuple(sc.shape) == want, \
                f"{key} shape {tuple(sc.shape)} != {want}"
            assert bool(torch.isfinite(sc).all() and (sc > 0).all()), \
                f"{key} has non-finite or non-positive entries"


@register_backend
class PagedLatentBackend(PagedFP32Backend):
    """MLA latent pages: each pool row is one per-token (kv_lora_rank +
    qk_rope_head_dim)-wide latent that every query head reads (the absorb
    path), so the cache holds a single "k" pool (L, P, page_size, 1, c + r)
    and no "v". The splice, COW and seed are the fp32 pool's, which are
    generic over the pool leaves: COW copies latent rows."""

    name = "paged_latent"

    @classmethod
    def pool_axes(cls) -> dict:
        # a latent row has no kv-head axis (every query head reads the same
        # compressed row) and is small: the pool stays whole on every rank,
        # and tp shards the absorbed queries' head axis instead
        return {}

    def init_cache(self, model: Model, batch_slots: int, s_max: int, dtype,
                   device):
        if getattr(model.cfg, "kv_lora_rank", 0) <= 0:
            raise ValueError(
                f"kv_backend='paged_latent' needs an MLA arch "
                f"(kv_lora_rank > 0); {model.cfg.name!r} caches per-head "
                f"K/V — use kv_backend='paged' (its pages would hold the "
                f"same rows anyway)")
        return super().init_cache(model, batch_slots, s_max, dtype, device)


def make_backend(spec, *, family: Family, page_size=None, num_pages=None,
                 mesh=None, num_kv_heads=None):
    """Resolve an engine ``kv_backend`` spec: None (layout follows
    page_size), a name registered in :data:`BACKENDS`, or a ready
    KVBackend instance. Int8 on a family outside
    :data:`INT8_KV_FAMILIES` falls back to fp32 pages with a warning, as
    the reference does. ``mesh``: the serving mesh the backend places its
    pool on; ``num_kv_heads``, given with a tp > 1 mesh, is checked
    against the backend's layout (a kv-head-sharded pool needs tp to
    divide it), so a direct ``ServeEngine(...)`` meets the preflight of
    ``ServeConfig.validate``."""
    if isinstance(spec, KVBackend):
        if mesh is not None and getattr(spec, "mesh", None) is not mesh:
            raise ValueError("a ready KVBackend instance must be built with "
                             "the engine's mesh (pass mesh= to its ctor)")
        return spec
    if spec is None:
        spec = "paged" if page_size is not None else "dense"
    cls = BACKENDS.get(spec)
    if cls is None:
        raise ValueError(f"unknown kv_backend {spec!r}; available: "
                         f"{sorted(BACKENDS)}")
    tp = _tp_degree(mesh)
    if not cls.paged:
        if page_size is not None:
            raise ValueError(f"kv_backend={spec!r} conflicts with page_size="
                             f"{page_size}; drop one of them")
        if tp > 1:
            raise ValueError("tensor-parallel serving shards the PAGED pool "
                             "(page indices are shard-invariant); the dense "
                             "backend has no mesh layout — pass page_size=")
        return cls()
    if page_size is None:
        raise ValueError(f"kv_backend={spec!r} needs page_size")
    if cls is PagedInt8Backend and family not in INT8_KV_FAMILIES:
        log.warning("paged_int8 KV backend supports %s (got %s); "
                    "falling back to fp32 pages",
                    [f.name for f in INT8_KV_FAMILIES], family)
        cls = PagedFP32Backend
    check_tp_support(cls, tp)
    if (tp > 1 and num_kv_heads is not None and _shards_kv_heads(cls)
            and num_kv_heads % tp):
        raise ValueError(
            f"num_kv_heads={num_kv_heads} is not divisible by tp={tp}; "
            f"pick a tp dividing the kv-head count (whole GQA groups must "
            f"stay shard-local)")
    return cls(page_size, num_pages, mesh=mesh)
