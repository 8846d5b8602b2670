"""Serving subsystem of the port: the paged continuous-batching engine, its
KV backend seam, scheduler and scheduling policy, prefix cache, metrics
with goodput, the open-loop traffic harness and the replica router
(counterparts of ``repro.serve``, which this package exports name for
name)."""
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import PageAllocator, ServeEngine
from repro_torch.serve.kvcache import (BACKENDS, DenseBackend, KVBackend,
                                       PagedFP32Backend, PagedInt8Backend,
                                       PagedLatentBackend, make_backend,
                                       register_backend)
from repro_torch.serve.metrics import (SLO, MetricsRecorder, ReplaySummary,
                                       merged_summary)
from repro_torch.serve.prefix import PrefixIndex, PrefixPlan, chain_hash
from repro_torch.serve.router import ReplicaRouter
from repro_torch.serve.scheduler import (Request, RequestState, SchedPolicy,
                                         Scheduler)
from repro_torch.serve.workload import (ArrivalEvent, WorkloadSpec, generate,
                                        replay)

__all__ = ["ServeEngine", "ServeConfig", "PageAllocator",
           "MetricsRecorder", "SLO", "ReplaySummary", "merged_summary",
           "KVBackend", "BACKENDS", "register_backend", "make_backend",
           "DenseBackend", "PagedFP32Backend", "PagedInt8Backend",
           "PagedLatentBackend",
           "PrefixIndex", "PrefixPlan", "chain_hash", "ReplicaRouter",
           "Request", "RequestState",
           "SchedPolicy", "Scheduler", "ArrivalEvent", "WorkloadSpec",
           "generate", "replay"]
