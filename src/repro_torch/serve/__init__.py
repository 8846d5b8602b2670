"""Serving subsystem of the port: the paged continuous-batching engine, its
KV backend seam, scheduler, prefix cache and metrics (counterparts of
``repro.serve``)."""
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import PageAllocator, ServeEngine
from repro_torch.serve.kvcache import (BACKENDS, KVBackend, PagedFP32Backend,
                                       make_backend, register_backend)
from repro_torch.serve.metrics import MetricsRecorder
from repro_torch.serve.prefix import PrefixIndex, PrefixPlan, chain_hash
from repro_torch.serve.scheduler import (Request, RequestState, SchedPolicy,
                                         Scheduler)

__all__ = ["ServeEngine", "ServeConfig", "PageAllocator", "MetricsRecorder",
           "KVBackend", "BACKENDS", "PagedFP32Backend", "register_backend",
           "make_backend", "PrefixIndex", "PrefixPlan", "chain_hash",
           "Request", "RequestState", "SchedPolicy", "Scheduler"]
