"""A copy of ``repro/core/dataflow.py`` (no framework in it): the port
prices a tiling exactly as the reference does.

Dataflow traffic models for tiled GEMM on a systolic array.

Exact HBM(DRAM)<->local-memory byte counts for each dataflow of a tiled
(M,K)x(K,N) matmul with tiles (bm, bk, bn) — the quantities the Tensil
compiler implicitly trades when it splits a layer into stages/partitions
(paper §4.3 Figs 3-4), made explicit:

  output_stationary: A streamed once per N-tile, W once per M-tile, O written once.
  weight_stationary: W loaded ONCE (Tensil's dataflow: "weights loaded only
      once, activations re-loaded"), A re-streamed per N-tile, O partials
      re-streamed per K-tile (read+write).
  input_stationary:  A loaded once (the paper's future-work dataflow), W
      re-streamed per M-tile, O partials re-streamed per K-tile.
  resident:          everything fits local memory -> each tensor moves once
      (paper §4.4, the "compiler strategy with large local memory").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

DATAFLOWS = ("output_stationary", "weight_stationary", "input_stationary",
             "resident")


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One layer as a GEMM (convs arrive here via im2col, attention via
    per-head GEMMs). ``in_elems``/``out_elems`` are the *raw* inter-layer
    activation element counts (pre-im2col) used by the network-level
    residency/spill model; they default to the GEMM operand sizes."""
    name: str
    m: int
    k: int
    n: int
    act_bytes: int = 2      # bf16 activations (paper: 16-bit fixed)
    weight_bytes: int = 2   # bf16 / int8 (quantized) weights
    out_bytes: int = 2
    acc_bytes: int = 4      # fp32 accumulators
    in_elems: int = 0       # raw input activation elements (0 => m*k)
    out_elems: int = 0      # raw output activation elements (0 => m*n)

    @property
    def in_raw(self) -> int:
        return (self.in_elems or self.m * self.k) * self.act_bytes

    @property
    def out_raw(self) -> int:
        return (self.out_elems or self.m * self.n) * self.out_bytes

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def a_size(self) -> int:
        return self.m * self.k * self.act_bytes

    @property
    def w_size(self) -> int:
        return self.k * self.n * self.weight_bytes

    @property
    def o_size(self) -> int:
        return self.m * self.n * self.out_bytes


@dataclasses.dataclass(frozen=True)
class Tiling:
    bm: int
    bk: int
    bn: int

    def grid(self, g: Gemm) -> Tuple[int, int, int]:
        return (math.ceil(g.m / self.bm), math.ceil(g.k / self.bk),
                math.ceil(g.n / self.bn))

    def vmem_bytes(self, g: Gemm, double_buffer: bool) -> int:
        """Working set: one tile of each operand + fp32 accumulator tile.
        Double buffering doubles the *streamed* operands (not the accumulator),
        exactly like the paper's dual-clock second bank."""
        mult = 2 if double_buffer else 1
        a = self.bm * self.bk * g.act_bytes * mult
        w = self.bk * self.bn * g.weight_bytes * mult
        o = self.bm * self.bn * g.acc_bytes
        return a + w + o


def traffic_bytes(g: Gemm, t: Tiling, dataflow: str) -> int:
    """Total HBM bytes moved for the full GEMM under a dataflow."""
    nm, nk, nn = t.grid(g)
    if dataflow == "resident":
        return g.a_size + g.w_size + g.o_size
    if dataflow == "output_stationary":
        return g.a_size * nn + g.w_size * nm + g.o_size
    if dataflow == "weight_stationary":
        partial = g.m * g.n * g.acc_bytes
        return g.w_size + g.a_size * nn + partial * nk + partial * max(nk - 1, 0)
    if dataflow == "input_stationary":
        partial = g.m * g.n * g.acc_bytes
        return g.a_size + g.w_size * nm + partial * nk + partial * max(nk - 1, 0)
    raise ValueError(dataflow)


def reload_factor(g: Gemm, t: Tiling, dataflow: str) -> float:
    """How many times the average byte is moved vs the resident optimum —
    the paper's Fig 3 'same input activations are loaded multiple times'."""
    opt = g.a_size + g.w_size + g.o_size
    return traffic_bytes(g, t, dataflow) / opt
