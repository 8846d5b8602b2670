"""A copy of ``repro/core/strategies.py``, both hardware profiles kept
(``examples/quickstart.py`` plans with the TPU one); neither profile
describes the port's card.

The paper's four optimization rungs as planner configurations.

Budgets are scaled analogues of the paper's on-chip memory ladder
(§4.1: 16 KV local + 4 KV acc BRAM; §4.3: +48 KV URAM => 3.4x capacity):

  baseline              small budget, no overlap   (§4.1, 133.54 FPS)
  dual_clock            small budget, overlap      (§4.2, 152.04 FPS)
  ultra_ram             large budget, overlap      (§4.3, 170.16 FPS)
  compiler_large_local  large budget, overlap, residency (§4.4, 293.58 FPS)

On the FPGA the budgets are BRAM/URAM KV counts; on TPU they are VMEM bytes.
Both hardware profiles are exposed so the analytic perf model (perfmodel.py)
can reproduce the paper's ladder on ZCU104 constants and project it on v5e.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import MemoryStrategy
from repro_torch.core.planner import PlannerConfig

KV_BYTES = 1024 * 32 * 2          # paper: 1 KV = 1024 vectors x 32 lanes x 16 bit


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float             # at the op's compute dtype
    hbm_bw: float                 # bytes/s (baseline clock domain)
    hbm_bw_fast: float            # bytes/s with the dual-clock/wide-port path
    local_small: int              # bytes: baseline local memory
    local_large: int              # bytes: ultra-RAM-augmented local memory
    mxu: int                      # systolic array edge
    watts: float                  # on-chip power for GOPs/W projections


# ZCU104 / Tensil (paper §4-5): 32x32 MAC @ 100 MHz, 16-bit => 204.8 GOP/s peak.
# AXI 128-bit @ 100 MHz x 2 ports = 3.2 GB/s; dual clock 333 MHz => 10.66 GB/s.
# Local: 16 KV + 4 KV = 20 KV BRAM; + 48 KV URAM = 68 KV (§4.3, Table 1).
ZCU104 = HardwareProfile(
    name="zcu104-tensil",
    peak_flops=32 * 32 * 2 * 100e6,
    hbm_bw=3.2e9, hbm_bw_fast=10.66e9,
    local_small=20 * KV_BYTES, local_large=68 * KV_BYTES,
    mxu=32, watts=5.21,
)

# TPU v5e (assignment constants): 197 TFLOP/s bf16, 819 GB/s HBM.
# VMEM budgets: a conservative 1/4 of VMEM for the baseline rung and the
# full ~64 MiB working budget for the ultra_ram rung.
TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9, hbm_bw_fast=819e9,   # no second clock domain on TPU
    local_small=16 * 2**20, local_large=64 * 2**20,
    mxu=128, watts=200.0,
)

HW_PROFILES = {p.name: p for p in (ZCU104, TPU_V5E)}


def planner_config(strategy: MemoryStrategy, hw: HardwareProfile) -> PlannerConfig:
    s = MemoryStrategy(strategy)
    if s == MemoryStrategy.BASELINE:
        return PlannerConfig(vmem_budget=hw.local_small, overlap=False,
                             dataflow="weight_stationary", mxu=hw.mxu)
    if s == MemoryStrategy.DUAL_CLOCK:
        return PlannerConfig(vmem_budget=hw.local_small, overlap=True,
                             dataflow="weight_stationary", mxu=hw.mxu)
    if s == MemoryStrategy.ULTRA_RAM:
        return PlannerConfig(vmem_budget=hw.local_large, overlap=True,
                             dataflow="weight_stationary", mxu=hw.mxu)
    if s == MemoryStrategy.COMPILER_LARGE_LOCAL:
        return PlannerConfig(vmem_budget=hw.local_large, overlap=True,
                             dataflow="auto", allow_resident=True, mxu=hw.mxu)
    raise ValueError(strategy)


def mem_bandwidth(strategy: MemoryStrategy, hw: HardwareProfile) -> float:
    """Dual-clock and later rungs use the fast (wide/2nd-clock) memory path."""
    return hw.hbm_bw if MemoryStrategy(strategy) == MemoryStrategy.BASELINE \
        else hw.hbm_bw_fast
