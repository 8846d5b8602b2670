"""A copy of ``repro/core/planner.py``: the same plans, field by field.

Capacity-aware partition planner — the Tensil compiler's stage/partition
model (paper §4.3-4.4) reimplemented against TPU VMEM.

Given a layer (GEMM), a local-memory budget, and a strategy, the planner:
  1. enumerates MXU-aligned tile shapes that fit the budget (with double
     buffering when the strategy overlaps movement and compute),
  2. prices each (tiling, dataflow) by its HBM traffic (core/dataflow.py),
  3. emits a MemoryPlan: tile shapes for the Pallas kernel, the Tensil-style
     (stages, partitions) decomposition, predicted traffic and arithmetic
     intensity.

A whole-network plan (plan_network) reproduces the paper's compilation story:
small budget -> multi-stage multi-partition (Fig 3); large budget -> single
stage/partition (Fig 4); 'compiler_large_local' additionally pins weights
resident when the whole layer fits (§4.4).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.dataflow import DATAFLOWS, Gemm, Tiling, reload_factor, traffic_bytes

MXU_DIM = 128   # v5e systolic array edge (paper's array is 32x32)


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    vmem_budget: int            # bytes of local memory available to one op
    overlap: bool               # dual-clock analogue: double-buffer + overlap
    dataflow: str = "auto"      # force a dataflow or 'auto'
    allow_resident: bool = False  # §4.4 whole-layer residency
    mxu: int = MXU_DIM


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    gemm: Gemm
    tiling: Tiling
    dataflow: str
    stages: int                 # Tensil: unique weight subsets loaded
    partitions: int             # Tensil: activation/output splits per stage
    traffic: int                # predicted HBM bytes
    vmem_used: int
    reload: float               # traffic / resident-optimum

    @property
    def arithmetic_intensity(self) -> float:
        return self.gemm.flops / max(self.traffic, 1)


def _aligned_sizes(dim: int, mxu: int) -> List[int]:
    """Candidate tile sizes: MXU multiples up to dim (plus dim itself)."""
    out = []
    step = mxu
    s = step
    while s < dim:
        out.append(s)
        s *= 2
    out.append(_round_up(dim, mxu) if dim > mxu else mxu)
    return sorted(set(out))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_gemm(g: Gemm, cfg: PlannerConfig) -> MemoryPlan:
    """Choose (tiling, dataflow) minimizing traffic under the VMEM budget."""
    # §4.4 residency: whole layer fits -> single stage, single partition
    whole = (g.a_size + g.w_size + g.m * g.n * g.acc_bytes)
    if cfg.allow_resident and whole <= cfg.vmem_budget:
        t = Tiling(_round_up(g.m, cfg.mxu), _round_up(g.k, cfg.mxu),
                   _round_up(g.n, cfg.mxu))
        return MemoryPlan(g, t, "resident", 1, 1, traffic_bytes(g, t, "resident"),
                          whole, 1.0)

    flows = DATAFLOWS[:-1] if cfg.dataflow == "auto" else (cfg.dataflow,)
    best: Optional[MemoryPlan] = None
    for bm in _aligned_sizes(g.m, cfg.mxu):
        for bk in _aligned_sizes(g.k, cfg.mxu):
            for bn in _aligned_sizes(g.n, cfg.mxu):
                t = Tiling(bm, bk, bn)
                used = t.vmem_bytes(g, double_buffer=cfg.overlap)
                if used > cfg.vmem_budget:
                    continue
                for df in flows:
                    traf = traffic_bytes(g, t, df)
                    if best is None or traf < best.traffic or (
                            traf == best.traffic and used > best.vmem_used):
                        nm, nk, nn = t.grid(g)
                        # Tensil semantics: a stage loads one unique weight
                        # subset (one (bk,bn) tile); each stage splits the
                        # activation side into partitions ((bm) tiles).
                        stages = nk * nn
                        partitions = nm
                        best = MemoryPlan(g, t, df, max(stages, 1),
                                          max(partitions, 1), traf, used,
                                          reload_factor(g, t, df))
    if best is None:
        raise ValueError(
            f"no tiling of {g.name} ({g.m}x{g.k}x{g.n}) fits budget "
            f"{cfg.vmem_budget} bytes (min tile {cfg.mxu})")
    return best


def plan_network(gemms: Sequence[Gemm], cfg: PlannerConfig) -> List[MemoryPlan]:
    return [plan_gemm(g, cfg) for g in gemms]


def network_traffic(plans: Sequence[MemoryPlan]) -> int:
    return sum(p.traffic for p in plans)


def network_flops(plans: Sequence[MemoryPlan]) -> int:
    return sum(p.gemm.flops for p in plans)
