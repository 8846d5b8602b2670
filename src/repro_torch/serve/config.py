"""Validated serving build configuration, as in ``repro/serve/config.py``:
the same fields with the same ``validate()`` messages, plus the ``device``
the port runs on (``"cuda"`` unless the caller asks for ``"cpu"``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.serve.kvcache import BACKENDS, KVBackend


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. Asking for CUDA on a host
    without it raises: nothing moves to the CPU unless the caller says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available here; the port runs on the card unless "
            "the caller passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


@dataclasses.dataclass
class ServeConfig:
    """Everything ``ServeEngine.build`` needs beyond the arch id.

    * model: ``reduced`` (CI-size config), ``cfg_overrides`` (post-reduction
      ``dataclasses.replace`` fields), ``quantize_int8``, ``compute_dtype``,
      ``seed``;
    * capacity: ``batch_slots``, ``s_max``;
    * sampling: ``temperature``, ``top_k``, ``top_p``;
    * cache: ``page_size``/``num_pages``, ``kv_backend``, ``prefix_cache``
      (None = auto);
    * paths: ``prefill_mode``, ``prefill_chunk_tokens``,
      ``prefill_attn_impl``, ``paged_attn_impl``;
    * scheduling: ``policy``; parallelism: ``tp``;
    * ``device``: where the engine runs.
    """

    reduced: bool = True
    batch_slots: int = 4
    s_max: int = 64
    seed: int = 0
    quantize_int8: bool = False
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    kv_backend: Any = None
    prefix_cache: Optional[bool] = None
    prefill_mode: str = "parallel"
    prefill_chunk_tokens: int = 64
    prefill_attn_impl: str = "auto"
    paged_attn_impl: str = "auto"
    policy: Any = None
    compute_dtype: Any = torch.float32
    tp: Optional[int] = None
    cfg_overrides: Optional[dict] = None
    device: str = "cuda"

    def _backend_name(self) -> Optional[str]:
        if isinstance(self.kv_backend, KVBackend):
            return self.kv_backend.name
        return self.kv_backend

    def validate(self, cfg=None) -> "ServeConfig":
        """Raise ValueError on any inconsistent field combination (messages
        equal to ``repro``'s); returns self. Tensor parallelism raises
        ``NotImplementedError``."""
        if self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got "
                             f"{self.batch_slots}")
        if self.s_max < 1:
            raise ValueError(f"s_max must be >= 1, got {self.s_max}")
        if int(self.top_k) < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got "
                             f"{self.top_k}")
        if not 0.0 < float(self.top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.prefill_mode not in ("parallel", "scan"):
            raise ValueError(f"prefill_mode must be 'parallel' or 'scan', "
                             f"got {self.prefill_mode!r}")
        if self.paged_attn_impl not in ("auto", "kernel", "einsum"):
            raise ValueError(f"paged_attn_impl must be 'auto', 'kernel' or "
                             f"'einsum', got {self.paged_attn_impl!r}")
        if self.prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, got "
                             f"{self.prefill_chunk_tokens}")

        name = self._backend_name()
        if isinstance(self.kv_backend, KVBackend):
            paged_backend = self.kv_backend.paged
        elif isinstance(name, str):
            if name not in BACKENDS:
                raise ValueError(f"unknown kv_backend {name!r}; available: "
                                 f"{sorted(BACKENDS)}")
            paged_backend = BACKENDS[name].paged
        else:
            paged_backend = None
        if self.page_size is not None:
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got "
                                 f"{self.page_size}")
            if self.s_max % self.page_size:
                raise ValueError(f"s_max {self.s_max} must be a multiple of "
                                 f"page_size {self.page_size}")
            if paged_backend is False:
                raise ValueError(f"kv_backend={name!r} conflicts with "
                                 f"page_size={self.page_size}; drop one of "
                                 f"them")
        elif paged_backend:
            raise ValueError(f"kv_backend={name!r} needs page_size")

        if self.tp is not None:
            raise NotImplementedError("tensor-parallel serving is not ported "
                                      "yet (ROADMAP queue 1 item 12)")
        if (cfg is not None and name == "paged_latent"
                and getattr(cfg, "kv_lora_rank", 0) <= 0):
            raise ValueError(
                f"kv_backend='paged_latent' needs an MLA arch "
                f"(kv_lora_rank > 0); {cfg.name!r} caches per-head K/V — "
                f"use kv_backend='paged'")
        return self

    def engine_kwargs(self) -> dict:
        """The ``ServeEngine.__init__`` keyword subset (build() resolves
        reduced, quantize_int8, tp and cfg_overrides itself)."""
        return dict(
            batch_slots=self.batch_slots, s_max=self.s_max,
            compute_dtype=self.compute_dtype, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, page_size=self.page_size,
            num_pages=self.num_pages, kv_backend=self.kv_backend,
            prefix_cache=self.prefix_cache, prefill_mode=self.prefill_mode,
            prefill_chunk_tokens=self.prefill_chunk_tokens,
            prefill_attn_impl=self.prefill_attn_impl,
            paged_attn_impl=self.paged_attn_impl, policy=self.policy,
            seed=self.seed, device=self.device)
