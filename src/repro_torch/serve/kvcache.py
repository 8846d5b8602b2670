"""KV-cache backends: the seam between the serving engine's orchestration
and the cache's representation, as in ``repro/serve/kvcache.py``.

The port implements :class:`DenseBackend` (per-slot rows) and
:class:`PagedFP32Backend` (the vLLM-style shared fp32 page pool). The other
backends keep their registry names, so ``ServeConfig`` resolves and
validates them as ``repro`` does, but constructing one raises
``NotImplementedError`` naming its ROADMAP item. The splices write the
resident cache in place and return it.
"""
from __future__ import annotations

import functools

from repro_torch.configs.base import ArchConfig, Family
from repro_torch.models.registry import (Model, cache_capacity, copy_pool_rows,
                                         init_paged_cache, insert_cache_rows,
                                         insert_cache_rows_paged,
                                         seed_prefix_cache,
                                         vectorize_cache_pos)

# families whose transient prefill state is exactly (k, v, pos): the ones
# page-level prefix caching can serve
PREFIX_CACHE_FAMILIES = (Family.DENSE, Family.MOE, Family.VLM)

# families whose paged decode/prefill can route through the paged kernel
PAGED_KERNEL_FAMILIES = (Family.DENSE, Family.MOE, Family.VLM, Family.ENCDEC)

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


class _NotPorted(KVBackend):
    roadmap = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"kv_backend={self.name!r} is not ported "
                                  f"yet ({self.roadmap})")


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


@register_backend(aliases=("paged_fp32",))
class PagedFP32Backend(KVBackend):
    """The shared fp32 page pool. Page ids index the pool's page axis; the
    engine owns the allocator and block tables."""

    name = "paged"
    paged = True

    def __init__(self, page_size: int, num_pages: int):
        self.page_size = page_size
        self.num_pages = num_pages

    def init_cache(self, model: Model, batch_slots: int, s_max: int, dtype,
                   device):
        return init_paged_cache(model, batch_slots, s_max,
                                page_size=self.page_size,
                                num_pages=self.num_pages, dtype=dtype,
                                device=device)

    def insert_rows(self, cache, request_cache, slots, phys_rows=None):
        return insert_cache_rows_paged(cache, request_cache, slots, phys_rows)

    def copy_rows(self, cache, src_rows, dst_rows):
        return copy_pool_rows(cache, src_rows, dst_rows)

    def seed_prefix(self, model: Model, s_max: int, dtype):
        return functools.partial(seed_prefix_cache, model, s_max=s_max,
                                 dtype=dtype)

    def resolve_attn_impl(self, family: Family, multi_page: bool) -> str:
        # the one-page-per-slot config stays on the einsum path: it is the
        # dense bit-exactness anchor
        if family in PAGED_KERNEL_FAMILIES and multi_page:
            return "kernel"
        return "einsum"


@register_backend
class PagedInt8Backend(_NotPorted):
    name = "paged_int8"
    paged = True
    roadmap = "ROADMAP queue 1 item 7"


@register_backend
class PagedLatentBackend(_NotPorted):
    name = "paged_latent"
    paged = True
    roadmap = "ROADMAP queue 1 item 7"


def make_backend(spec, *, family: Family, page_size=None, num_pages=None):
    """Resolve an engine ``kv_backend`` spec: None (layout follows
    page_size), a name registered in :data:`BACKENDS`, or a ready
    KVBackend instance."""
    if isinstance(spec, KVBackend):
        return spec
    if spec is None:
        spec = "paged" if page_size is not None else "dense"
    cls = BACKENDS.get(spec)
    if cls is None:
        raise ValueError(f"unknown kv_backend {spec!r}; available: "
                         f"{sorted(BACKENDS)}")
    if not cls.paged:
        if page_size is not None:
            raise ValueError(f"kv_backend={spec!r} conflicts with page_size="
                             f"{page_size}; drop one of them")
        return cls()
    if page_size is None:
        raise ValueError(f"kv_backend={spec!r} needs page_size")
    return cls(page_size, num_pages)
