"""A copy of ``repro/core/perfmodel.py``: the same ladder and fit. Its
numbers are the model's predictions for the FPGA, not measurements.

Analytic performance model reproducing the paper's FPS ladder (Fig. 6).

The model is a *network-level* traffic/compute model on top of the capacity
planner, mirroring how the Tensil compiler actually schedules per strategy:

  baseline              every layer round-trips DRAM (weights + in/out
                        activations per image), movement NOT overlapped with
                        compute, slow (100 MHz) memory path, per load-compute-
                        save block a fixed DRAM/instruction overhead.
  dual_clock            same traffic, but movement overlaps compute (second
                        clock domain + wider AXI -> faster memory path).
  ultra_ram             larger local memory: inter-layer activations that fit
                        stay on chip (no spill), partition reloads vanish.
  compiler_large_local  whole-model residency (§4.4): weights pinned on-chip
                        and amortized across images; only the input image and
                        the logits cross DRAM.

time(strategy) = sum_l combine(t_c, t_m) + n_dram_blocks * block_overhead
  t_c = flops_l / (peak * efficiency); t_m = traffic_l / bw(strategy)
  combine = '+' for baseline (no overlap), 'max' otherwise.

Hardware constants (efficiency, bw_slow, bw_fast, block_overhead) are fitted
once against the paper's four measured FPS points (calibrate()); the planner's
traffic/stage structure is NOT fitted — so the fit quality directly validates
the paper's mechanism. The v5e projection uses independent datasheet constants.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import List, Sequence

from repro_torch.configs.base import MemoryStrategy
from repro_torch.core.dataflow import Gemm
from repro_torch.core.planner import PlannerConfig, plan_gemm
from repro_torch.core.strategies import HardwareProfile, ZCU104, planner_config

LADDER_ORDER = (MemoryStrategy.BASELINE, MemoryStrategy.DUAL_CLOCK,
                MemoryStrategy.ULTRA_RAM, MemoryStrategy.COMPILER_LARGE_LOCAL)

# Paper-reported reference points (Fig. 6 / Tables 2-3) for validation.
PAPER_FPS = {
    "baseline": 133.54,
    "dual_clock": 152.04,
    "ultra_ram": 170.16,
    "compiler_large_local": 293.58,
}
PAPER_GOPS = 21.12
PAPER_WATTS = 5.21
PAPER_ACCURACY = {"fp32": 0.92, "fixed16": 0.90}


@dataclasses.dataclass(frozen=True)
class FitConstants:
    efficiency: float        # achieved fraction of peak MACs
    bw_slow: float           # bytes/s, single-clock path
    bw_fast: float           # bytes/s, dual-clock/wide path
    block_overhead: float    # s per load-compute-save block (DRAM latency+issue)


# Defaults in the right physical regime before calibration
# (AXI 128b@100MHz ~1.1 GB/s effective; 333 MHz ~2.5x; Tensil eff ~0.12).
DEFAULT_FIT = FitConstants(efficiency=0.12, bw_slow=1.1e9, bw_fast=2.6e9,
                           block_overhead=20e-6)

V5E_FIT = FitConstants(efficiency=0.55, bw_slow=819e9, bw_fast=819e9,
                       block_overhead=2e-6)


@dataclasses.dataclass(frozen=True)
class StrategyEval:
    strategy: str
    fps: float
    gops: float
    gops_per_watt: float
    t_compute: float
    t_mem: float
    traffic: int
    blocks: int
    bottleneck: str


@functools.lru_cache(maxsize=None)
def _layer_traffic(g: Gemm, strategy: MemoryStrategy, cfg: PlannerConfig,
                   amortize_weights: bool) -> tuple:
    """(bytes moved for this layer per image, dram blocks).

    Memoized: traffic depends only on (gemm, strategy, planner config) — all
    frozen/hashable — and NOT on the FitConstants being searched, so
    ``calibrate()``'s grid search prices thousands of candidate fits without
    re-running the partition planner (~20x faster calibration)."""
    plan = plan_gemm(g, cfg)
    p = plan.partitions
    w = 0 if amortize_weights else g.w_size
    ws_layer = g.w_size + g.in_raw + g.out_raw
    resident_ok = ws_layer <= cfg.vmem_budget
    if strategy in (MemoryStrategy.BASELINE, MemoryStrategy.DUAL_CLOCK):
        # always spills activations; partitions reload inputs (paper Fig. 3)
        traffic = w + p * g.in_raw + g.out_raw
        blocks = max(p, 1) * max(plan.stages, 1)
    elif strategy == MemoryStrategy.ULTRA_RAM:
        # larger memory: single partition for anything that fits; activations
        # still round-trip (weight-stationary compiler, §4.3)
        traffic = w + g.in_raw + g.out_raw
        blocks = max(plan.stages, 1)
    else:  # COMPILER_LARGE_LOCAL
        traffic = (0 if resident_ok else w + g.in_raw + g.out_raw)
        blocks = 1
    return traffic, blocks


def evaluate(gemms: Sequence[Gemm], strategy: MemoryStrategy,
             hw: HardwareProfile = ZCU104, fit: FitConstants = DEFAULT_FIT,
             *, io_bytes: int = 32 * 32 * 3 * 2 + 10 * 4) -> StrategyEval:
    strategy = MemoryStrategy(strategy)
    cfg = planner_config(strategy, hw)
    overlap = strategy != MemoryStrategy.BASELINE
    bw = fit.bw_slow if strategy == MemoryStrategy.BASELINE else fit.bw_fast
    amortize = strategy == MemoryStrategy.COMPILER_LARGE_LOCAL
    t_total = t_c_sum = t_m_sum = 0.0
    traffic_sum = 0
    blocks_sum = 0
    for g in gemms:
        traffic, blocks = _layer_traffic(g, strategy, cfg, amortize)
        t_c = g.flops / (hw.peak_flops * fit.efficiency)
        t_m = traffic / bw
        t_total += max(t_c, t_m) if overlap else (t_c + t_m)
        t_c_sum += t_c
        t_m_sum += t_m
        traffic_sum += traffic
        blocks_sum += blocks
    t_total += blocks_sum * fit.block_overhead + io_bytes / bw
    fps = 1.0 / t_total
    flops = sum(g.flops for g in gemms)
    gops = flops * fps / 1e9
    return StrategyEval(strategy=strategy.value, fps=fps, gops=gops,
                        gops_per_watt=gops / hw.watts, t_compute=t_c_sum,
                        t_mem=t_m_sum, traffic=traffic_sum, blocks=blocks_sum,
                        bottleneck="compute" if t_c_sum >= t_m_sum else "memory")


def ladder(gemms: Sequence[Gemm], hw: HardwareProfile = ZCU104,
           fit: FitConstants = DEFAULT_FIT) -> List[StrategyEval]:
    return [evaluate(gemms, s, hw, fit) for s in LADDER_ORDER]


def calibrate(gemms: Sequence[Gemm], hw: HardwareProfile = ZCU104,
              targets=PAPER_FPS) -> FitConstants:
    """Fit the four hardware constants to the paper's measured ladder by
    coarse-to-fine grid search on relative FPS error."""
    best, best_err = DEFAULT_FIT, float("inf")
    effs = [0.06, 0.08, 0.10, 0.117, 0.13, 0.15, 0.2, 0.3]
    slows = [0.1e9, 0.2e9, 0.35e9, 0.6e9, 0.9e9, 1.1e9, 1.4e9, 1.8e9]
    fasts = [0.2e9, 0.35e9, 0.6e9, 1.0e9, 1.4e9, 2.0e9, 2.6e9, 3.4e9, 5.0e9]
    ovhs = [2e-6, 5e-6, 10e-6, 20e-6, 40e-6, 80e-6, 160e-6]
    for eff, bs, bf, ov in itertools.product(effs, slows, fasts, ovhs):
        # physical constraint: dual-clock path is 1-3.4x the single-clock path
        if not (bs <= bf <= 3.4 * bs):
            continue
        fit = FitConstants(eff, bs, bf, ov)
        err = 0.0
        for s in LADDER_ORDER:
            pred = evaluate(gemms, s, hw, fit).fps
            tgt = targets[s.value]
            err += ((pred - tgt) / tgt) ** 2
        if err < best_err:
            best, best_err = fit, err
    # refine efficiency & overhead locally (keep fast path >= slow path)
    for eff in [best.efficiency * f for f in (0.85, 0.93, 1.0, 1.08, 1.15)]:
        for ov in [best.block_overhead * f for f in (0.5, 0.75, 1.0, 1.33, 2.0)]:
            for bs in [best.bw_slow * f for f in (0.8, 0.9, 1.0, 1.1, 1.25)]:
                for bf in [best.bw_fast * f for f in (0.8, 0.9, 1.0, 1.1, 1.25)]:
                    if bf < bs:
                        continue
                    fit = FitConstants(eff, bs, bf, ov)
                    err = sum(((evaluate(gemms, s, hw, fit).fps - targets[s.value])
                               / targets[s.value]) ** 2 for s in LADDER_ORDER)
                    if err < best_err:
                        best, best_err = fit, err
    return best


# ---------------------------------------------------------------- serving
def decode_roofline(n_params: int, hw: HardwareProfile = ZCU104,
                    fit: FitConstants = DEFAULT_FIT,
                    bytes_per_param: int = 2) -> dict:
    """Analytic tokens/s ceiling for batch-1 autoregressive decode — the
    serving-side counterpart of the FPS ladder. Each generated token
    touches every live parameter once: 2 FLOPs per MAC on the compute
    side, ``bytes_per_param`` of weight traffic on the memory side (KV
    reads are second-order for the model sizes served here), so

        compute_bound = peak_flops * efficiency / (2 * n_params)
        memory_bound  = bw_fast / (n_params * bytes_per_param)

    and the roofline is their min. The serve bench uses this as a sanity
    ceiling: measured open-loop GOODPUT can never exceed the roofline of a
    profile calibrated from the same machine's closed-loop capacity —
    queueing and SLO misses only ever subtract."""
    if n_params <= 0:
        raise ValueError(f"n_params must be positive, got {n_params}")
    compute = hw.peak_flops * fit.efficiency / (2.0 * n_params)
    memory = fit.bw_fast / (n_params * bytes_per_param)
    return {
        "n_params": int(n_params),
        "compute_tokens_per_s": compute,
        "memory_tokens_per_s": memory,
        "tokens_per_s": min(compute, memory),
        "bound": "compute" if compute <= memory else "memory",
    }
