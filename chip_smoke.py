#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card:

    python3 chip_smoke.py

It needs CUDA and the checkout's ``src/``; without either it exits nonzero
before printing any result. Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``); build every kernel of
   the port from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source,
   started together) and time the build.
2. every kernel against its plain PyTorch version on the card: paged
   attention over fp32 pools (K1) and over int8 pools (K3) on the test
   cases at head_dim 128 (and 16 / 64 / 256) and at the edges of their
   split over keys (``SPLIT_EDGES``), latent paged attention (K4)
   at latent widths 10/8, 64/48, 576/512 and 1024/512, and flash attention
   (K2); then each at the full-width shapes the serving and forward paths
   give it (qwen2.5-32b, qwen2.5-32b-mla; K2 also at hymba-1.5b's first
   chunk and forward), with the kernel's, the plain version's and one
   library call's times and the bound (K1's, K3's and K4's decode time
   is their two launches, the split over keys and the merge, summed). The
   systolic GEMM (K7) in its three dataflows and the int8-weight GEMM (K8)
   on the CPU tests' shapes, a K of 5120 (several K-chunks), ResNet20's 21
   im2col GEMMs at batch 1 and 256 (K8 on per-channel int8 weights),
   qwen2.5-32b's wo at M = 8 and bf16 cases; then both timed over the 21
   GEMMs of a batch-256 forward, and at wo. Every kernel's time and every
   library call's is its device time under ``torch.profiler``
   (``device_times``); the plain versions' are between CUDA events. The
   wkv6 scan (K5) and the selective scan (K6) on the CPU tests' cases
   (strong decay, T = 33 with chunk 16, T = 1), then at rwkv6-7b's and
   hymba-1.5b's widths for the forward (B=4, T=1024), a decode tick and a
   64-token prefill chunk of 8 slots and of one request (the shape of most
   serving chunks; there other staging depths must give equal bits) and a
   tick of one request, timed beside their bounds.
3. qwen2.5-32b at full width cut to 4 layers (the weights of
   ``ServeEngine.build``, built once for phases 3-5): one paged prefill
   chunk plus 8 decode steps through ``impl="kernel"`` and
   ``impl="einsum"``, on fp32 pages and (3c) on int8 pages; (3b) the
   full-sequence prefill step and a dense prefill chunk plus 8 dense
   decode steps through the flash kernel and through the einsum. Logits
   allclose and greedy tokens equal.
4. paged serving: 16 requests (100-700 prompt tokens, half sharing a
   256-token prefix, 32 generated each) through the paged engine; (4b)
   the same requests on int8 pages (``kv_backend="paged_int8"``), every
   attention through K3, tokens against phase 4's reported.
5. the main path: ``ServeEngine.build("qwen2.5-32b", ...)`` with the
   default dense cache serving the same 16 requests; its tokens against
   phase 4's.
6. the prefill anchors at the reduced width: dense parallel, dense scan,
   paged one-page einsum and paged kernel give equal greedy streams; int8
   pages read through K3 and through the q8 einsum give equal streams;
   the MLA dense latent cache, one-page latent einsum and multi-page K4
   give equal streams; rwkv6 (parallel and scan prefill, through K5) and
   hymba (dense and paged ring, parallel and scan, through K6) give equal
   streams, on perturbed weights (below).
7. qwen2.5-32b-mla at full width cut to 4 layers (after the qwen2.5-32b
   weights are freed): paged latent prefill chunk plus 8 decode steps
   through K4 and through the latent einsum; the 16 requests on the dense
   latent cache and on latent pages, every paged attention through K4,
   streams compared.
8. ResNet20 / CIFAR at the paper's widths (random weights and BN stats
   from a seeded generator, a head fitted to synthetic training images),
   folded, on synthetic CIFAR images at batch 1 and 256: ``lax`` (cuDNN),
   im2col with the plain ``@`` and im2col through K7 in each dataflow;
   logits against ``lax`` with top-1 equal, 21 K7 launches per forward,
   then ms per forward, FPS, GOP/s and (power.draw sampled) GOP/s per W,
   and at batch 256 each route's device time split into the port's GEMMs,
   im2col and the rest.
   (8b) int8 PTQ over 10,000 synthetic images in batches of 1,000: fp32
   against 16-bit fixed point and int8, then every conv GEMM through K8
   on the int8 weights against the dequant-on-load forward.
9. rwkv6-7b at full width and depth (32 layers, 30.3 GB fp32): the
   forward on (2, 512) tokens through K5 against the plain recurrence,
   one prefill chunk plus 8 decode steps through K5 ('auto') against
   'scan' (logits, state leaves, greedy tokens), then the 16 requests of
   phases 4-5 on the dense cache (rwkv has nothing to page), K5 launched
   once per layer per chunk and per tick (the (B, T) of every launch
   counted and printed).
10. hymba-1.5b at full width and depth (32 layers, 5.3 GB): the same
   forward and step comparisons through K6, then the 16 requests plus 4
   of 1,100-1,500 tokens (s_max 2048, so the 1024-row ring wraps) on the
   dense ring and on the paged ring (pages of 16 rows), every selective
   scan through K6 (its launches by (B, T) printed) and every first
   chunk's attention through K2; the two caches' streams equal.
11. run right after phase 5, on its qwen2.5-32b weights, every engine
   on fp32 pages of 16, so K1 carries every decode tick and chunk (its
   launches counted in each run): (11a) the 16 requests sampled at
   temperature 0.8 with top_k=1 (streams equal to phase 4's greedy
   ones), with top-k 50 / top-p 0.9 at seed 7 twice (equal streams, every
   token in its filtered row's kept set) and at seed 8 (other streams),
   tok/s and ITL p50 against phase 4's, and the time a tick takes to
   choose its 8 tokens from the logits each way; (11b) the reference bench's burst
   cell (``GOODPUT_POLICY_KW``, 4 slots, s_max 96, 8 pages): capacity and
   the SLO calibrated on the card, then one bursty three-priority
   schedule at 2x the sustainable rate replayed to warm up, under FIFO
   and under the policy, goodput, attainment and TTFT p95 by priority
   printed; the policy must preempt and shed, and each preempted request
   that completed gives its uninterrupted greedy stream; (11c) two
   replicas over the same weight tensors behind ``ReplicaRouter``: the
   header-sharing prompts on one replica, phase 4's streams; (11d)
   cancels from RUNNING, PREFILLING, QUEUED and one member of a grouped
   prefill, every page back, the survivors' streams against phase 4's;
   (11e) ``python -m repro_torch.serve.workload`` and ``python -m
   repro_torch.launch.serve --temperature 0.7 --top-p 0.9`` in their own
   processes exit 0, and their summaries show no failed prefill chunk and
   no request aborted but by a shed.

The recurrent phases perturb the leaves ``repro``'s init leaves constant
(rwkv's u, mu, mu_x, lora_B, wB; hymba's logA) with seeded noise, so the
decay, the bonus and the per-channel A depend on the data. Each serving
path (3b's forward, 4, 4b, 5, 7, 9, 10, 11) and each forward of phases 8,
8b, 9 and 10 runs with the kernels' launch counts set to 0 just before
and read just after, and every serving run requires that no prefill
chunk failed (the engine catches a chunk that raises and fails its job).
Then one JSON line
describing each kernel, and as the last line ``{"ok": true, "device":
{...}}``. TF32 is off throughout: every number is fp32, as the reference
computes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.resnet20_cifar import CONFIG as RESNET  # noqa: E402
from repro_torch.core.quantize import (QuantizedTensor,  # noqa: E402
                                       dequantize_params, fixed_point_tree,
                                       page_scale, quantize_params,
                                       quantize_per_channel)
from repro_torch.data.synthetic import synthetic_cifar  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models.registry import init_paged_cache  # noqa: E402
from repro_torch.serve import (SLO, ReplicaRouter, SchedPolicy,  # noqa: E402
                               ServeConfig, ServeEngine, WorkloadSpec,
                               merged_summary)
from repro_torch.serve import workload  # noqa: E402
from repro_torch.serve.metrics import percentile  # noqa: E402
from repro_torch.serve.scheduler import RequestState  # noqa: E402
from repro_torch.serve.kvcache import (PagedInt8Backend,  # noqa: E402
                                       PagedLatentBackend)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # same fp32 math, other sum order
MODEL_TOL = 1e-3                 # logits after 4 full-width fp32 layers
# int8 pages: the two read paths write K/V rows that differ in the last
# bit from layer 2 on, and a row value on a rounding tie then lands one
# int8 step (a page's amax / 127) apart; such flips, not the kernel, set
# the logits gap of the int8 model comparison
Q8_MODEL_TOL = 1e-2
INACTIVE = 1 << 30
ARCH = "qwen2.5-32b"
MLA_ARCH = "qwen2.5-32b-mla"
RWKV, HYMBA = "rwkv6-7b", "hymba-1.5b"
LAYERS = 4
SLOTS, S_MAX, PS = 8, 1024, 16
# phase 3b's full-sequence prefill step (B, S), also hymba's in phase 10
FORWARD_BATCH = (2, 512)
# K2 at full width, by row of the kernels line: (arch, B, S) of a serving
# first chunk (B slots x C) and of a forward
FLASH_SHAPES = {"prefill": (ARCH, SLOTS, 64), "forward": (ARCH, 4, 1024),
                "prefill_hymba": (HYMBA, SLOTS, 64),
                "forward_hymba": (HYMBA, *FORWARD_BATCH)}
# K1 / K3's and K4's launches as the profiler names them: the kernel, and
# where it splits a call over keys (a decode tick) the merge of its splits
# (``split_merge_kernel``; "merge_kernel" also names an older tree's
# ``latent_merge_kernel``, so chip_ab.py times a parent the same way)
PAGED_KERNELS = ("paged_attention_kernel", "merge_kernel")
LATENT_KERNELS = ("latent_attention_kernel", "merge_kernel")
# K7 / K8: 1e-4 of the output's largest magnitude (the kernel's one FMA
# chain per element against the library's blocked fp32 sum); a bf16 output
# may round one bf16 step apart
GEMM_TOL, GEMM_BF16_TOL = 1e-4, 2e-2
# K7's and K8's CUDA kernels, as the profiler names them
GEMM_KERNEL = "systolic_gemm"
# phase 8: ResNet20 at batch 1 (the paper's per-frame setting) and 256;
# 8b: the 10,000-image synthetic test set in batches of 1,000
RESNET_BATCHES, PTQ_IMAGES, PTQ_BATCH = (1, 256), 10_000, 1_000
# the LM projection K8 is also held at: qwen2.5-32b's wo (M = 8 slots)
LM_PROJ = (8, 5120, 5120)
DATAFLOWS = mm.DATAFLOWS
# the recurrent families (phases 6, 9, 10): repro's init leaves these at
# zero (a constant decay, no bonus, A = -1 everywhere), which would hide
# the recurrences; seeded noise of this scale is added to them
RECURRENT_NOISE = {
    RWKV: {"u": 0.1, "mu": 0.1, "mu_x": 0.1, "lora_B": 0.01, "wB": 0.01},
    HYMBA: {"logA": 0.5},
}
RWKV_LAYERS = HYMBA_LAYERS = 32          # full depth: 30 GB and 5.3 GB fp32
HYMBA_S_MAX = 2048                       # the ring (1024 rows) wraps
# K5 / K6 at full width: (B, T) of the forward, a decode tick and a
# 64-token chunk of 8 slots, and a chunk and a tick of one request (the
# engine prefills each group of equal prompts as one job, so most serving
# chunks are B = 1)
SCAN_SHAPES = {"forward": (4, 1024), "decode": (SLOTS, 1),
               "prefill": (SLOTS, 64), "prefill_b1": (1, 64),
               "decode_b1": (1, 1)}
# each scan's kernels as the profiler names them (K6 runs T = 1 in a kernel
# of its own)
SCAN_KERNELS = {"wkv6": ("wkv6_kernel",),
                "selective_scan": ("selective_scan_kernel",
                                   "selective_scan_tick_kernel")}
# full-width recurrent outputs (logits, state), as a share of their
# largest magnitude: fp32 layers whose scans sum in another order; top-1 is
# held where the best two logits are further apart
RECURRENT_TOL = 1e-3
# depth of phases 9-10's forward and step comparisons: the random
# rwkv6-7b with its perturbed leaves amplifies the scans' fp32 rounding
# layer by layer, past RECURRENT_TOL by its fourth layer, so rwkv is
# compared on its first 2 layers; hymba resolves it at full depth
CHECK_LAYERS = {RWKV: 2, HYMBA: HYMBA_LAYERS}
DEV = torch.device("cuda")


def log(msg):
    print(msg, flush=True)


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
_FLUSH = None
# the flush's kernel as the profiler names it (PyTorch's int32 max)
FLUSH_KERNEL = "MaxNanFunctor<int>"


def flush_l2():
    """Read 64 MB, which evicts the 50 MB L2 (the serving path finds K/V
    pages cold: the layer weights stream in between). A read and not a
    write: a flush that writes leaves up to 50 MB of dirty lines, whose
    write-back then falls into the timed launch. Its kernel, an int32 max
    (``FLUSH_KERNEL``, after a memset), is one that nothing timed here
    launches, so ``split_calls`` can tell it apart."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.zeros(16 << 20, dtype=torch.int32, device=DEV)
    _FLUSH.max()


def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` in ms over ``iters`` launches between CUDA
    events, each after the L2 flush (``flush_l2``): what a caller waits
    for, the host's enqueue delay included."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def profiled_calls(fn, iters: int, attempts: int = 3) -> list:
    """Run ``fn`` ``iters`` times, each call after the L2 flush, under one
    ``torch.profiler`` session; the (name, device us) of every kernel, copy
    and memset each call launched, in order (``split_calls``). A session
    now and then comes back without its device events: it is run again, up
    to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    time_ms(fn, 1)
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush_l2()  # a lead-in: the profiler may miss a session's
            flush_l2()  # first events
            for _ in range(iters):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        try:
            return split_calls([(e.name, e.time_range.elapsed_us())
                                for e in events], iters)
        except AssertionError as err:
            if attempt + 1 == attempts:
                raise
            log(f"  (profiler session {attempt + 1} incomplete: {err}; "
                f"again)")


def split_calls(events, iters: int) -> list:
    """(name, us) device events in launch order split into calls at each
    flush (its int32 max kernel and the memset right before it): what
    follows a flush up to the next one. The profiler sometimes misses
    events, so only calls with the most common count of launches are
    kept, and at least half of the ``iters`` must be."""
    calls = None
    for i, (name, us) in enumerate(events):
        if FLUSH_KERNEL in name:
            calls = (calls or []) + [[]]
        elif calls is not None and not (
                name.startswith("Memset") and i + 1 < len(events)
                and FLUSH_KERNEL in events[i + 1][0]):
            calls[-1].append((name, us))
    calls = [c for c in calls or [] if c]
    counts = [len(c) for c in calls]
    n = max(set(counts), key=counts.count) if counts else 0
    kept = [c for c in calls if len(c) == n]
    if 2 * len(kept) < iters or len(kept) > iters:
        raise AssertionError(f"profiler: {len(kept)} whole calls of {iters} "
                             f"(launches per call {sorted(counts)})")
    return kept


def device_times(fns, iters: int, kernel=None) -> list:
    """Per entry of ``fns``, the mean device time in ms of what one call
    launches (``profiled_calls``; no host enqueue delay, which an event
    pair around a tick-sized launch holds). With ``kernel`` (a name, or a
    tuple of names for a port kernel that may be a set of launches, such
    as K4's split over keys and its merge), only the CUDA kernels whose
    name holds one of them count, and their times are summed; every call
    must launch the same named kernels in the same order, at least one (a
    set of more than one logs each launch's time); without, everything a
    call launched counts (a library call, which may launch several
    kernels)."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    out = []
    for fn in fns:
        calls = profiled_calls(fn, iters)
        if names is not None:
            calls = [[(next(k for k in names if k in name), us)
                      for name, us in c if any(k in name for k in names)]
                     for c in calls]
            seen = {tuple(name for name, _ in c) for c in calls}
            if len(seen) != 1 or not calls[0]:
                raise AssertionError(f"profiler: {names} launched as "
                                     f"{sorted(seen)} per call")
            if len(calls[0]) > 1:
                each = [sum(c[i][1] for c in calls) / len(calls) / 1e3
                        for i in range(len(calls[0]))]
                log("    (" + " + ".join(
                    f"{name} {t:.4f}" for (name, _), t in
                    zip(calls[0], each)) + " ms)")
        out.append(sum(us for c in calls for _, us in c) / len(calls) / 1e3)
    return out


def device_ms(fn, iters: int, kernel=None) -> float:
    """``device_times`` of one call: the kernel's own time (``kernel``) or
    a library call's."""
    return device_times([fn], iters, kernel)[0]


# ------------------------------------------------------------- phase 2 data
def paged_case(seed, B, Sq, H, KV, hd, P, ps, mps, fill):
    """Random q / pools and block tables giving slot b ceil(fill[b] / ps)
    distinct pages in a shuffled order (the CPU tests' generator)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    pk = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    bt = np.full((B, mps), -1, np.int32)
    perm = rng.permutation(P)
    nxt = 0
    for b in range(B):
        need = -(-fill[b] // ps)
        bt[b, :need] = perm[nxt:nxt + need]
        nxt += need
    return q, pk, pv, bt


# K1 / K3 at the edges of their split over keys (the card tests' cases):
# (Sq, hd, B, page_size, mps, starts, holes, spare, window). Decode over
# 700+ rows with a freed slot beside a full one and a slot whose splits
# hold only -1 pages and whose spare pages lie past its frontier; a window
# starting inside a key tile; a split 37-row chunk with a window; pages of
# 8, 32, 64 rows and page_size == s_max; fills ending mid-page.
SPLIT_EDGES = [
    (1, 128, 4, 16, 64, [731, INACTIVE, 1023, 99], {3: range(2, 6)},
     {3: 8}, 0),
    (1, 128, 2, 16, 64, [700, 400], None, {1: 2}, 300),
    (37, 128, 3, 8, 32, [INACTIVE, 256 - 37, 45], None, {2: 3}, 50),
    (1, 128, 3, 8, 128, [900, 13, 333], {0: [7, 40]}, {1: 1}, 0),
    (16, 128, 3, 32, 32, [600, 17, 100], None, {2: 2}, 0),
    (64, 128, 2, 64, 16, [300, 0], None, None, 0),
    (1, 128, 3, 256, 1, [255, 100, INACTIVE], None, None, 0),
]


def split_edge(seed, case):
    """One SPLIT_EDGES case at 40 heads over 8 kv heads: slot b holds the
    pages its rows up to start[b] + Sq - 1 need (none when INACTIVE),
    ``holes`` unallocated inside, ``spare`` pages past its frontier.
    Returns (q, pool_k, pool_v, bt, start) on the card and ``seen``, the
    pool rows some query can see (causal and window), as a numpy mask."""
    Sq, hd, B, ps, mps, start, holes, spare, window = case
    rng = np.random.default_rng(seed)
    P = B * mps + 4
    q = rng.standard_normal((B, Sq, 40, hd)).astype(np.float32)
    pk = rng.standard_normal((P, ps, 8, hd)).astype(np.float32)
    pv = rng.standard_normal((P, ps, 8, hd)).astype(np.float32)
    bt = np.full((B, mps), -1, np.int32)
    free = list(rng.permutation(P))
    for b in range(B):
        if start[b] < INACTIVE:
            need = -(-(start[b] + Sq) // ps) + (spare or {}).get(b, 0)
            bt[b, :need] = free[:need]
            free = free[need:]
    for b, idx in (holes or {}).items():
        bt[b, list(idx)] = -1
    seen = np.zeros((P, ps), bool)
    for b in range(B):
        if start[b] < INACTIVE:
            first = start[b] - window + 1 if window else 0
            for r in range(max(first, 0), start[b] + Sq):
                if bt[b, r // ps] >= 0:
                    seen[bt[b, r // ps], r % ps] = True
    return on_card(q, pk, pv, bt, np.asarray(start, np.int32)), seen


def zero_where_freed(name, got, start):
    for b, st in enumerate(start.tolist()):
        if st >= INACTIVE and not torch.all(got[b] == 0):
            raise AssertionError(f"{name}: freed slot {b} not exactly 0")


def on_card(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(DEV) for a in arrays]


def held(name, got, want):
    """A kernel's output against its plain version's on the same inputs,
    within KERNEL_TOL; returns (got, max |diff|)."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, **KERNEL_TOL):
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max abs err {err}")
    log(f"  {name}: max abs err {err:.3e}")
    return got, err


def check_case(name, args, window=0, kind="prefill", **scales):
    """Paged attention (K1, or K3 given int8 pools and their scales) vs
    its plain version on the card; returns (out, max |diff|)."""
    return held(name, pa.paged_attention(*args, window=window, kind=kind,
                                         **scales),
                ref.paged_attention(*args, window=window, **scales))


def roofline(nbytes, flops) -> tuple:
    """The least time for the work: bytes at the HBM rate against fp32
    operations at the fp32 peak. Returns (ms, 'bytes' | 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase2_cases():
    """The CPU test cases, on the card, at head_dim 128 and beyond."""
    errs = {"decode": 0.0, "prefill": 0.0}
    cases = [dict(Sq=8, H=4, KV=2, ps=8, mps=4, window=0),
             dict(Sq=1, H=4, KV=4, ps=8, mps=4, window=0),
             dict(Sq=16, H=8, KV=2, ps=4, mps=8, window=6),
             dict(Sq=8, H=2, KV=1, ps=16, mps=2, window=0)]
    for hd in (128, 16, 64, 256):
        for i, c in enumerate(cases if hd == 128 else cases[:2]):
            B, P = 2, 2 * c["mps"] + 3
            fill = [c["ps"] + c["ps"] // 2 + c["Sq"], c["ps"] // 2 + c["Sq"]]
            q, pk, pv, bt = paged_case(3, B, c["Sq"], c["H"], c["KV"], hd, P,
                                       c["ps"], c["mps"], fill)
            start = np.asarray([f - c["Sq"] for f in fill], np.int32)
            kind = "decode" if c["Sq"] == 1 else "prefill"
            _, err = check_case(f"case{i} hd={hd}",
                                on_card(q, pk, pv, bt, start), c["window"],
                                kind)
            errs[kind] = max(errs[kind], err)

    hd = 128
    # poisoned rows (no valid key of any slot) never contribute, bitwise
    B, Sq, H, KV, P, ps, mps = 2, 4, 4, 2, 8, 8, 4
    q, pk, pv, bt = paged_case(4, B, Sq, H, KV, hd, P, ps, mps, [12, 4])
    start = np.asarray([8, 0], np.int32)
    base, err = check_case("poison base", on_card(q, pk, pv, bt, start))
    valid = np.zeros(P * ps, bool)
    for b, last in enumerate([11, 3]):
        for r in range(last + 1):
            valid[bt[b, r // ps] * ps + r % ps] = True
    poison = lambda a: np.where(valid[:, None, None],  # noqa: E731
                                a.reshape(P * ps, KV, hd),
                                1e9).astype(np.float32).reshape(a.shape)
    got, _ = check_case("poisoned", on_card(q, poison(pk), poison(pv), bt,
                                            start))
    if not torch.equal(got, base):
        raise AssertionError("poisoned rows changed the kernel's output")
    errs["prefill"] = max(errs["prefill"], err)

    # a freed slot (all -1 table, INACTIVE position) returns exact zeros;
    # a mid-prefill slot (pages held, INACTIVE position) stays finite
    q, pk, pv, bt = paged_case(6, 3, 1, 40, 8, hd, 10, 16, 4, [40, 20, 0])
    start = np.asarray([39, INACTIVE, INACTIVE + 5], np.int32)
    got, err = check_case("freed + mid-prefill slots",
                          on_card(q, pk, pv, bt, start), kind="decode")
    if not (torch.all(got[2] == 0) and torch.isfinite(got).all()):
        raise AssertionError("freed slot not exactly 0 / non-finite output")
    errs["decode"] = max(errs["decode"], err)

    # two slots aliasing one prefix page, equal tails: equal outputs
    rng = np.random.default_rng(7)
    q1 = rng.standard_normal((1, 4, 4, hd)).astype(np.float32)
    pk = rng.standard_normal((6, 8, 2, hd)).astype(np.float32)
    pv = rng.standard_normal((6, 8, 2, hd)).astype(np.float32)
    pk[4], pv[4] = pk[0], pv[0]
    bt = np.asarray([[2, 0, -1], [2, 4, -1]], np.int32)
    got, err = check_case("aliased prefix pages", on_card(
        np.concatenate([q1, q1]), pk, pv, bt, np.asarray([10, 10], np.int32)))
    if not torch.equal(got[0], got[1]):
        raise AssertionError("aliased prefix pages gave different outputs")
    errs["prefill"] = max(errs["prefill"], err)

    # one page per slot (page_size == s_max, 64 rows: several smem tiles)
    q, pk, pv, bt = paged_case(8, 2, 64, 8, 2, hd, 2, 64, 1, [64, 64])
    _, err = check_case("one page spans s_max",
                        on_card(q, pk, pv, bt, np.zeros(2, np.int32)))
    errs["prefill"] = max(errs["prefill"], err)

    # the split's edges: rows no query can see are NaN in the kernel's
    # pools (never read), the plain version runs on the clean ones
    for n, case in enumerate(SPLIT_EDGES):
        args, seen = split_edge(30 + n, case)
        mask = torch.from_numpy(seen).to(DEV)[:, :, None, None]
        bad = [torch.where(mask, a, float("nan")) for a in args[1:3]]
        kind = "decode" if case[0] == 1 else "prefill"
        plan = pa.paged_plan(*args[0].shape[:3], 8, case[1],
                             case[3] * case[4])
        name = (f"split edge {n} (Sq={case[0]}, ps={case[3]}, window="
                f"{case[8]}, {plan.splits} splits)")
        got, err = held(name, pa.paged_attention(
            args[0], *bad, *args[3:], window=case[8], kind=kind),
            ref.paged_attention(*args, window=case[8]))
        zero_where_freed(name, got, args[4])
        errs[kind] = max(errs[kind], err)
    return errs


def full_width_case(Sq, seed):
    """The serving shapes of qwen2.5-32b: 8 slots, 40 query heads over 8 kv
    heads, head_dim 128, page_size 16, s_max 1024; each slot holds 100-732
    rows (a 100-700 token prompt plus up to 32 generated tokens)."""
    cfg = configs.get_config(ARCH)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mps = S_MAX // PS
    rng = np.random.default_rng(seed)
    fill = rng.integers(100, 733, SLOTS)
    q, pk, pv, bt = paged_case(seed, SLOTS, Sq, H, KV, hd, SLOTS * mps, PS,
                               mps, fill)
    start = (fill - Sq).astype(np.int32)
    return on_card(q, pk, pv, bt, start), fill


def visible_pairs(fill, Sq) -> int:
    """(query row, key) pairs the causal mask lets through, per head, for
    slots whose last query sees fill[b] rows."""
    return sum(int(f - Sq + i + 1) for f in fill for i in range(Sq))


def bound_ms(args, fill, kv_bytes=4) -> tuple:
    """Least time for the work this data needs: every live K/V row a query
    can see read once (``kv_bytes`` per element; int8 pools add one f32
    scale per live page for K and for V), q read once, out written once,
    at the HBM rate; against the fp32 FMAs of the valid (query, key) pairs
    (score and value products) at the fp32 peak."""
    q = args[0]
    B, Sq, H, hd = q.shape
    ps, KV = args[1].shape[1:3]
    rows = int(np.sum(fill))                          # keys up to last query
    scales = 0 if kv_bytes == 4 else 2 * 4 * sum(-(-int(f) // ps)
                                                 for f in fill)
    nbytes = (2 * rows * KV * hd * kv_bytes + scales + 2 * q.numel() * 4
              + args[3].numel() * 4 + args[4].numel() * 4)
    return roofline(nbytes, 4 * visible_pairs(fill, Sq) * H * hd)


def sdpa_call(args):
    """One library call for the same function on the gathered view:
    ``scaled_dot_product_attention`` with GQA and a boolean mask. Timed as
    a yardstick only; the port never calls it."""
    q, pk, pv, bt, start = args
    B, Sq, H, hd = q.shape
    P, ps, KV, _ = pk.shape
    n = bt.shape[1] * ps
    j = torch.arange(n, device=DEV)
    page = bt.long()[:, j // ps]
    ok = page >= 0
    phys = torch.where(ok, page * ps + j % ps, 0)
    k = pk.reshape(P * ps, KV, hd)[phys].transpose(1, 2).contiguous()
    v = pv.reshape(P * ps, KV, hd)[phys].transpose(1, 2).contiguous()
    qpos = start.long()[:, None] + torch.arange(Sq, device=DEV)
    mask = (ok[:, None, :] & (j[None, None, :] <= qpos[:, :, None]))[:, None]
    qt = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def phase2_full_width():
    out = {}
    for kind, Sq, seed in (("decode", 1, 11), ("prefill", 64, 12)):
        args, fill = full_width_case(Sq, seed)
        _, err = check_case(f"full width {kind} (B={SLOTS}, Sq={Sq}, H=40, "
                            f"KV=8, hd=128, ps={PS})", args, kind=kind)
        lib = sdpa_call(args)
        want = ref.paged_attention(*args)
        lib_err = (lib().transpose(1, 2) - want).abs().max().item()
        ms = device_ms(lambda: pa.paged_attention(*args, kind=kind), 50,
                       PAGED_KERNELS)
        plain = time_ms(lambda: ref.paged_attention(*args), 10)
        lib_ms = device_ms(lib, 10)
        bms, by = bound_ms(args, fill)
        log(f"  {kind}: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
            f"sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}) | bound "
            f"{bms:.4f} ms ({by}) | live rows {int(np.sum(fill))}")
        out[kind] = dict(err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by)
    return out


# ----------------------------------------------- phase 2: int8 pages (K3)
def quantize_pages(pool):
    """Each page of an fp32 pool as int8 with its own symmetric scale (the
    int8 backend's block): returns (int8 pool, (P,) f32 scales)."""
    scale = page_scale(pool.abs().amax(dim=(1, 2, 3)))
    q = torch.clamp(torch.round(pool / scale[:, None, None, None]),
                    -127, 127).to(torch.int8)
    return q, scale


def q8_args(args):
    """fp32 (q, pool_k, pool_v, bt, start) -> the same with int8 pools,
    and the scales as keyword arguments."""
    q, pk, pv, bt, start = args
    (pkq, ks), (pvq, vs) = quantize_pages(pk), quantize_pages(pv)
    return [q, pkq, pvq, bt, start], dict(k_scale=ks, v_scale=vs)


def phase2_q8_cases():
    """K1's cases over int8 pools: head_dim 128 (and 16 / 64 / 256), a
    window, a freed slot (exact zeros) and NaN scales on every page no
    slot visits (never read: the output is unchanged bit for bit)."""
    errs = {"decode_q8": 0.0, "prefill_q8": 0.0}
    cases = [dict(Sq=8, H=4, KV=2, ps=8, mps=4, window=0),
             dict(Sq=1, H=4, KV=4, ps=8, mps=4, window=0),
             dict(Sq=16, H=8, KV=2, ps=4, mps=8, window=6),
             dict(Sq=8, H=2, KV=1, ps=16, mps=2, window=0)]
    for hd in (128, 16, 64, 256):
        for i, c in enumerate(cases if hd == 128 else cases[:2]):
            B, P = 2, 2 * c["mps"] + 3
            fill = [c["ps"] + c["ps"] // 2 + c["Sq"], c["ps"] // 2 + c["Sq"]]
            q, pk, pv, bt = paged_case(3, B, c["Sq"], c["H"], c["KV"], hd, P,
                                       c["ps"], c["mps"], fill)
            start = np.asarray([f - c["Sq"] for f in fill], np.int32)
            args, sc = q8_args(on_card(q, pk, pv, bt, start))
            kind = "decode_q8" if c["Sq"] == 1 else "prefill_q8"
            _, err = check_case(f"q8 case{i} hd={hd}", args, c["window"],
                                kind, **sc)
            errs[kind] = max(errs[kind], err)

    q, pk, pv, bt = paged_case(6, 3, 1, 40, 8, 128, 12, 16, 4, [40, 20, 0])
    start = np.asarray([39, 19, INACTIVE], np.int32)
    args, sc = q8_args(on_card(q, pk, pv, bt, start))
    base, err = check_case("q8 freed slot", args, kind="decode_q8", **sc)
    if not torch.all(base[2] == 0):
        raise AssertionError("q8: freed slot not exactly 0")
    unused = torch.ones(12, dtype=torch.bool, device=DEV)
    unused[args[3][args[3] >= 0].long()] = False
    nan_sc = {k: torch.where(unused, float("nan"), v) for k, v in sc.items()}
    got = pa.paged_attention(*args, kind="decode_q8", **nan_sc)
    torch.cuda.synchronize()
    if not torch.equal(got, base):
        raise AssertionError("q8: a scale of an unvisited page was read")
    log("  q8 NaN scales on unvisited pages: output unchanged")
    errs["decode_q8"] = max(errs["decode_q8"], err)

    # the split's edges, with NaN scales on every page no query can see
    for n, case in enumerate(SPLIT_EDGES):
        f32_args, seen = split_edge(30 + n, case)
        args, sc = q8_args(f32_args)
        unseen = torch.from_numpy(~seen.any(axis=1)).to(DEV)
        nan_sc = {k: torch.where(unseen, float("nan"), v)
                  for k, v in sc.items()}
        kind = "decode_q8" if case[0] == 1 else "prefill_q8"
        name = f"q8 split edge {n} (Sq={case[0]}, ps={case[3]})"
        got, err = check_case(name, args, case[8], kind, **sc)
        if not torch.equal(pa.paged_attention(*args, window=case[8],
                                              kind=kind, **nan_sc), got):
            raise AssertionError(f"{name}: a scale of an unvisited page "
                                 f"was read")
        zero_where_freed(name, got, args[4])
        errs[kind] = max(errs[kind], err)
    return errs


def phase2_q8_full_width():
    """K3 at qwen2.5-32b's serving shapes, int8 pools. The library call is
    SDPA on the pre-gathered, pre-dequantized view, timed alone."""
    out = {}
    for kind, Sq, seed in (("decode_q8", 1, 13), ("prefill_q8", 64, 14)):
        f32_args, fill = full_width_case(Sq, seed)
        args, sc = q8_args(f32_args)
        _, err = check_case(f"full width {kind} (B={SLOTS}, Sq={Sq}, H=40, "
                            f"KV=8, hd=128, ps={PS}, int8)", args, kind=kind,
                            **sc)
        deq = [args[0]] + [p.float() * s[:, None, None, None] for p, s in
                           ((args[1], sc["k_scale"]),
                            (args[2], sc["v_scale"]))] + args[3:]
        lib = sdpa_call(deq)
        want = ref.paged_attention(*args, **sc)
        lib_err = (lib().transpose(1, 2) - want).abs().max().item()
        ms = device_ms(lambda: pa.paged_attention(*args, kind=kind, **sc),
                       50, PAGED_KERNELS)
        plain = time_ms(lambda: ref.paged_attention(*args, **sc), 10)
        lib_ms = device_ms(lib, 10)
        bms, by = bound_ms(args, fill, kv_bytes=1)
        log(f"  {kind}: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
            f"sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}) | bound "
            f"{bms:.4f} ms ({by}) | live rows {int(np.sum(fill))}")
        out[kind] = dict(err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by)
        del f32_args, args, deq, want
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- phase 2: latent pages (K4)
def latent_case(seed, B, Sq, H, Lw, P, ps, mps, fill):
    """Random absorbed queries, a latent pool (P, ps, 1, Lw) and tables
    giving slot b ceil(fill[b] / ps) shuffled pages (none for fill 0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Lw)).astype(np.float32)
    pool = rng.standard_normal((P, ps, 1, Lw)).astype(np.float32)
    bt = np.full((B, mps), -1, np.int32)
    perm = rng.permutation(P)
    nxt = 0
    for b in range(B):
        need = -(-int(fill[b]) // ps)
        bt[b, :need] = perm[nxt:nxt + need]
        nxt += need
    return q, pool, bt


def check_latent(name, args, scale_dim, d_v, kind="prefill_latent"):
    return held(name, pa.paged_attention_latent(
        *args, scale_dim=scale_dim, d_v=d_v, kind=kind),
        ref.paged_attention_latent(*args, scale_dim=scale_dim, d_v=d_v))


def phase2_latent_cases():
    """K4 at latent widths 10/8 (the reduced config), 64/48, 576/512 (full
    width) and 1024/512 (the widest it takes), decode and chunk shapes,
    two live slots at mid-page frontiers and a freed slot (exact zeros)."""
    errs = {"decode_latent": 0.0, "prefill_latent": 0.0}
    for Lw, d_v, scale_dim in ((10, 8, 18), (64, 48, 96), (576, 512, 192),
                               (1024, 512, 192)):
        for Sq in (1, 4, 37):
            ps, mps = 16, 4
            fill = [ps + ps // 2 + Sq, ps // 2 + Sq, 0]
            q, pool, bt = latent_case(50 + Sq, 3, Sq, 40, Lw, 12, ps, mps,
                                      fill)
            start = np.asarray([fill[0] - Sq, fill[1] - Sq, INACTIVE],
                               np.int32)
            kind = "decode_latent" if Sq == 1 else "prefill_latent"
            got, err = check_latent(f"latent {Lw}/{d_v} Sq={Sq}",
                                    on_card(q, pool, bt, start), scale_dim,
                                    d_v, kind)
            if not torch.all(got[2] == 0):
                raise AssertionError("latent: freed slot not exactly 0")
            errs[kind] = max(errs[kind], err)
    return errs


def phase2_latent_full_width():
    """K4 at qwen2.5-32b-mla's serving shapes: 8 slots of 100-732 latent
    rows (576 floats; values the first 512), 40 heads, page_size 16, the
    softmax scaled by 1/sqrt(192). The library call is SDPA with q
    (B, 40, Sq, 576), the gathered latent view as its one K head and the
    view's first 512 columns as V, timed alone."""
    cfg = configs.get_config(MLA_ARCH)
    H, c, r = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Lw, scale_dim = c + r, cfg.head_dim + r
    mps = S_MAX // PS
    out = {}
    for kind, Sq, seed in (("decode_latent", 1, 15),
                           ("prefill_latent", 64, 16)):
        fill = np.random.default_rng(seed).integers(100, 733, SLOTS)
        q, pool, bt = latent_case(seed, SLOTS, Sq, H, Lw, SLOTS * mps, PS,
                                  mps, fill)
        args = on_card(q, pool, bt, (fill - Sq).astype(np.int32))
        _, err = check_latent(f"full width {kind} (B={SLOTS}, Sq={Sq}, "
                              f"H={H}, {Lw}/{c}, ps={PS})", args, scale_dim,
                              c, kind)
        qd, pool_d, bt_d, st_d = args
        n = mps * PS
        j = torch.arange(n, device=DEV)
        page = bt_d.long()[:, j // PS]
        ok = page >= 0
        view = pool_d.reshape(-1, Lw)[torch.where(ok, page * PS + j % PS, 0)]
        k = view[:, None].contiguous()                   # (B, 1, n, Lw)
        v = view[:, None, :, :c].contiguous()
        qpos = st_d.long()[:, None] + torch.arange(Sq, device=DEV)
        mask = ok[:, None, :] & (j[None, None, :] <= qpos[:, :, None])
        mask = mask[:, None]
        qt = qd.transpose(1, 2).contiguous()
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, k, v, attn_mask=mask, scale=scale_dim ** -0.5,
            enable_gqa=True)
        want = ref.paged_attention_latent(*args, scale_dim=scale_dim, d_v=c)
        lib_err = (lib().transpose(1, 2) - want).abs().max().item()
        ms = device_ms(lambda: pa.paged_attention_latent(
            *args, scale_dim=scale_dim, d_v=c, kind=kind), 50,
            LATENT_KERNELS)
        plain = time_ms(lambda: ref.paged_attention_latent(
            *args, scale_dim=scale_dim, d_v=c), 10)
        lib_ms = device_ms(lib, 10)
        # each slot's latent rows read once for all heads; q read and the
        # output written once; (Lw + c) FMAs per visible (row, head, key)
        rows = int(np.sum(fill))
        nbytes = 4 * (rows * Lw + qd.numel() + SLOTS * Sq * H * c
                      + bt_d.numel() + st_d.numel())
        bms, by = roofline(nbytes,
                           2 * (Lw + c) * visible_pairs(fill, Sq) * H)
        log(f"  {kind}: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
            f"sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}) | bound "
            f"{bms:.4f} ms ({by}) | live rows {rows}")
        out[kind] = dict(err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by)
        del args, qd, pool_d, view, k, v, qt, want
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------- phase 2: flash (K2)
def flash_case(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return on_card(rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
                   rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
                   rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


def check_flash(name, args, causal=True, window=0, kind="forward"):
    """K2 vs its plain version on the card; returns max |diff|."""
    got = fa.flash_attention(*args, causal=causal, window=window, kind=kind)
    want = ref.flash_attention(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, **KERNEL_TOL):
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max abs err {err}")
    log(f"  {name}: max abs err {err:.3e}")
    return err


def phase2_flash_cases():
    """The CPU tests' cases and more: causal and not, G = 1 / 5 / 8, a
    window of 64 (whose first tiles are wholly masked for late rows),
    Sq != Sk, the engine's chunk lengths, head_dim 16 / 64 / 128 / 256.
    Chunk-shaped cases count toward the prefill row, the rest toward the
    forward row."""
    errs = {"prefill": 0.0, "forward": 0.0}
    cases = [dict(Sq=256, Sk=256, H=8, KV=8, causal=True, window=0),
             dict(Sq=256, Sk=256, H=40, KV=8, causal=False, window=0),
             dict(Sq=256, Sk=256, H=16, KV=2, causal=True, window=64),
             dict(Sq=128, Sk=512, H=8, KV=1, causal=False, window=0),
             dict(Sq=300, Sk=300, H=40, KV=8, causal=True, window=64)]
    for hd in (128, 16, 64, 256):
        for i, c in enumerate(cases if hd == 128 else cases[:4]):
            args = flash_case(20 + i, 2, c["Sq"], c["Sk"], c["H"], c["KV"],
                              hd)
            errs["forward"] = max(errs["forward"], check_flash(
                f"flash case{i} hd={hd}", args, c["causal"], c["window"]))
    for C in (1, 2, 37, 64, 100):
        for window in (0, 64):
            args = flash_case(30 + C, 3, C, C, 40, 8, 128)
            errs["prefill"] = max(errs["prefill"], check_flash(
                f"flash chunk C={C} window={window}", args, window=window,
                kind="prefill"))
    return errs


def flash_bound_ms(args, causal=True, window=0) -> tuple:
    """Least time for K2's work on these inputs: q, K and V read once and
    the output written once at the HBM rate, against the fp32 FMAs of the
    visible (query, key) pairs (score and value products) at the fp32
    peak. Returns (ms, 'bytes' | 'operations')."""
    q, k, v = args
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    i = np.arange(Sq)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(i, Sk - 1) if causal else np.full_like(i, Sk - 1)
    pairs = B * H * int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    return roofline(nbytes, 4 * pairs * hd)


def phase2_flash_full_width():
    """K2 at the shapes the models give it (``FLASH_SHAPES``), a serving
    first chunk and a forward each: qwen2.5-32b's 40 query heads over 8 kv
    heads at head_dim 128, causal, and hymba-1.5b's 25 over 5 at head_dim
    64 with its 1024-row window, which phase 10 runs. The library call is
    SDPA, causal (the window is wider than the sequence, so it masks
    nothing more)."""
    out = {}
    for kind, (arch, B, S) in FLASH_SHAPES.items():
        cfg = configs.get_config(arch)
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        window = cfg.window or 0
        if window and window < S:
            raise AssertionError(f"{arch}: the SDPA yardstick is causal, but "
                                 f"the window {window} < S = {S}")
        args = flash_case(40, B, S, S, H, KV, hd)
        count = kind.split("_")[0]
        err = check_flash(f"full width flash {kind} ({arch}: B={B}, S={S}, "
                          f"H={H}, KV={KV}, hd={hd}, window={window})", args,
                          window=window, kind=count)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in args)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        want = ref.flash_attention(*args, window=window)
        lib_err = (lib().transpose(1, 2) - want).abs().max().item()
        del want
        iters = 50 if count == "prefill" else 10
        ms = device_ms(lambda: fa.flash_attention(
            *args, window=window, kind=count), iters,
            "flash_attention_kernel")
        plain = time_ms(lambda: ref.flash_attention(*args, window=window), 5)
        lib_ms = device_ms(lib, iters)
        bms, by = flash_bound_ms(args, window=window)
        log(f"  flash {kind}: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
            f"sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}) | bound "
            f"{bms:.4f} ms ({by})")
        out[kind] = dict(err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by)
        del args, qt, kt, vt
    torch.cuda.empty_cache()
    return out


# --------------------------------------------- phase 2: scans (K5, K6)
def wkv_case(seed, B, T, H, N, decay=None):
    """The CPU tests' distributions (tests/test_kernels.py): r, k, v ~
    0.5 N, w = sigmoid(N) / 2 + 1/2 (or a constant strong ``decay``),
    u ~ 0.1 N, s0 ~ 0.1 N (zeros with a constant decay), on the card."""
    gen = torch.Generator(DEV).manual_seed(seed)
    r, k, v = (0.5 * rand_on_card(gen, B, T, H, N) for _ in range(3))
    if decay is None:
        w = 0.5 * torch.sigmoid(rand_on_card(gen, B, T, H, N)) + 0.5
        s0 = 0.1 * rand_on_card(gen, B, H, N, N)
    else:
        w = torch.full((B, T, H, N), decay, device=DEV)
        s0 = torch.zeros((B, H, N, N), device=DEV)
    return [r, k, v, w, 0.1 * rand_on_card(gen, H, N), s0]


def sscan_case(seed, B, T, D, N):
    """x ~ N, dt = softplus(N), b, c ~ N, a = -exp(0.5 N), h0 ~ 0.1 N."""
    gen = torch.Generator(DEV).manual_seed(seed)
    x, dt, b, c = (rand_on_card(gen, B, T, D), F.softplus(rand_on_card(
        gen, B, T, D)), rand_on_card(gen, B, T, N), rand_on_card(gen, B, T, N))
    return [x, dt, b, c, -torch.exp(0.5 * rand_on_card(gen, D, N)),
            0.1 * rand_on_card(gen, B, D, N)]


def scan_held(name, got, want):
    """(y, final state) of a scan kernel against its plain version's, each
    within KERNEL_TOL; returns the max |diff|."""
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: bad output {tuple(g.shape)}")
        err = max(err, (g - w).abs().max().item())
        if not torch.allclose(g, w, **KERNEL_TOL):
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"version, max abs err {err}")
    log(f"  {name}: max abs err {err:.3e}")
    return err


def phase2_scan_cases():
    """K5 and K6 on the CPU tests' cases (tests/test_kernels.py:225-264):
    T = 64, 128 and 33 with chunks 16 / 32 / 64, the strong decay, T = 1."""
    errs = {"wkv6": 0.0, "selective_scan": 0.0}
    for seed, (T, chunk, decay) in enumerate(
            [(64, 16, None), (64, 32, None), (128, 64, None), (33, 16, None),
             (1, 32, None), (64, 16, 0.05), (1, 16, 0.05)]):
        B, H, N = (1, 2, 8) if decay else (2, 3, 16)
        args = wkv_case(60 + seed, B, T, H, N, decay)
        errs["wkv6"] = max(errs["wkv6"], scan_held(
            f"wkv6 T={T} chunk={chunk}" + (f" w={decay}" if decay else ""),
            ls.wkv6(*args, chunk=chunk), ref.wkv6(*args)))
    for seed, (T, chunk) in enumerate([(64, 16), (128, 64), (33, 16),
                                       (1, 64)]):
        args = sscan_case(70 + seed, 2, T, 32, 8)
        errs["selective_scan"] = max(errs["selective_scan"], scan_held(
            f"selective_scan T={T} chunk={chunk}",
            ls.selective_scan(*args, chunk=chunk),
            ref.selective_scan(*args)))
    return errs


def wkv_bound(B, T, H, N) -> tuple:
    """Least time for K5's work: r, k, v, w and y (B*T*H*N each), u, s0
    and sT once at the HBM rate, against the fp32 operations the function
    needs at the fp32 peak: 5 per state element and step (k*v, the FMA
    w*S + kv, r's FMA into y), the bonus factored out of the sum,
    v_j * sum_i r_i u_i k_i, being 5 per step and channel (two products
    and the sum over i, the FMA into y)."""
    return roofline(4 * (5 * B * T * H * N + H * N + 2 * B * H * N * N),
                    5 * B * T * H * N * N + 5 * B * T * H * N)


def sscan_bound(B, T, D, N) -> tuple:
    """Least time for K6's work: x, dt, y (B*T*D), b, c (B*T*N), a, h0 and
    hT once, against 7 fp32 operations per (step, channel, state) (a*dt,
    its exp, dt*x times b, the FMA into h, h*c's FMA into y) and dt*x once
    per (step, channel)."""
    return roofline(4 * (3 * B * T * D + 2 * B * T * N + D * N
                         + 2 * B * D * N), 7 * B * T * D * N + B * T * D)


def phase2_scan_full_width():
    """K5 at rwkv6-7b's shapes (64 heads of 64) and K6 at hymba-1.5b's
    (1600 channels, state 16), at each of ``SCAN_SHAPES``: the kernel's
    device time (``device_ms``), the plain version's time between events
    (its many launches as a caller waits for them) and the bound; at the
    one-request chunk the outputs of other staging depths must equal the
    default's bit for bit. No single PyTorch call computes either
    recurrence, so there is no library time. Returns {(kernel, shape
    name): {err, ms, plain_ms, bound_ms, bound_by}}."""
    rwkv, hymba = configs.get_config(RWKV), configs.get_config(HYMBA)
    out = {}
    for kind, (B, T) in SCAN_SHAPES.items():
        H, N = rwkv.num_heads, rwkv.head_dim
        D, Ns = hymba.d_model, hymba.ssm_state
        for name, args, bound, fn, plain in (
                ("wkv6", wkv_case(80, B, T, H, N), wkv_bound(B, T, H, N),
                 ls.wkv6, ref.wkv6),
                ("selective_scan", sscan_case(81, B, T, D, Ns),
                 sscan_bound(B, T, D, Ns), ls.selective_scan,
                 ref.selective_scan)):
            shape = (B, T, H, N) if name == "wkv6" else (B, T, D, Ns)
            got = fn(*args)
            err = scan_held(f"full width {name}[{kind}] {shape}", got,
                            plain(*args))
            if kind == "prefill_b1":
                for chunk in (1, 16, 64):
                    again = fn(*args, chunk=chunk)
                    if not all(torch.equal(a, g) for a, g in zip(again, got)):
                        raise AssertionError(f"{name}[{kind}]: chunk={chunk} "
                                             f"changes the result")
            ms = device_ms(lambda: fn(*args),
                           20 if kind == "forward" else 50,
                           SCAN_KERNELS[name])
            plain_ms = time_ms(lambda: plain(*args),
                               2 if kind == "forward" else 5)
            bms, by = bound
            log(f"  {name}[{kind}]: kernel {ms:.4f} ms | plain "
                f"{plain_ms:.4f} ms | bound {bms:.4f} ms ({by}) | "
                f"{ms / bms:.1f}x the bound")
            out[(name, kind)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bms, bound_by=by)
            del args
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 3
def phase3_model(model, params, backend=None, label="fp32 pages",
                 tol=MODEL_TOL):
    """Full-width model, 4 layers: one 64-token prefill chunk for 8 slots
    on a fresh paged cache (fp32 pages, or the cache ``backend`` builds),
    then 8 greedy decode steps, through the kernel and through the
    masked-einsum reference read; logits (within ``tol``) and tokens
    compared, and how far the two final caches' pools differ reported."""
    cfg = model.cfg
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.name} x {LAYERS} layers: {n / 1e9:.3f} B params fp32, "
        f"{label}")
    mps = S_MAX // PS
    bt = torch.arange(SLOTS * mps, dtype=torch.int32,
                      device=DEV).reshape(SLOTS, mps)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, 64))
                            ).to(DEV)
    runs, caches = {}, {}
    for impl in ("kernel", "einsum"):
        if backend is None:
            cache = init_paged_cache(model, SLOTS, S_MAX, page_size=PS,
                                     num_pages=SLOTS * mps, device=DEV)
        else:
            cache = backend.init_cache(model, SLOTS, S_MAX, torch.float32,
                                       DEV)
        cache["block_tables"].copy_(bt)
        pa.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill_chunk_paged(
            params, toks, cache, bt_rows=bt, start=0, write_floor=0,
            attn_impl=impl)
        cache["pos"].fill_(64)
        seq, tok = [logits], logits[:, :, :cfg.vocab_size].argmax(-1)
        tokens = [tok]
        for _ in range(8):
            logits, cache = model.decode_step(params, tok, cache,
                                              paged_attn_impl=impl)
            tok = logits[:, :, :cfg.vocab_size].argmax(-1)
            seq.append(logits)
            tokens.append(tok)
        torch.cuda.synchronize()
        launched = sum(pa.LAUNCHES.values())
        if launched != (9 * LAYERS if impl == "kernel" else 0):
            raise AssertionError(f"impl={impl}: {pa.LAUNCHES} paged "
                                 f"attention launches for 1 chunk + 8 steps "
                                 f"x {LAYERS} layers")
        log(f"  impl={impl}: prefill + 8 decode steps in "
            f"{time.perf_counter() - t0:.3f} s (host clock), "
            f"{launched} kernel launches")
        runs[impl] = (seq, torch.cat(tokens, 1))
        caches[impl] = cache
    for key in ("k", "v"):
        if key in caches["kernel"]:
            a, b = caches["kernel"][key], caches["einsum"][key]
            diff = (a.float() - b.float()).abs()
            log(f"  final {key} pool: {(diff == 0).float().mean().item():.6f}"
                f" of entries equal, max |diff| {diff.max().item():.3e}")
    del caches
    compare_runs(runs, cfg, "kernel", "einsum", tol)
    del runs
    torch.cuda.empty_cache()


def compare_runs(runs, cfg, a_name, b_name, tol=MODEL_TOL):
    """Two runs of (logits per step, greedy tokens): finite logits of the
    right shape, allclose within ``tol``, and equal tokens."""
    (sa, ta), (sb, tb) = runs[a_name], runs[b_name]
    worst, close = 0.0, True
    for a, b in zip(sa, sb):
        if a.shape[-1] != cfg.padded_vocab or not torch.isfinite(
                a[..., :cfg.vocab_size]).all():
            raise AssertionError(f"bad logits {tuple(a.shape)}")
        worst = max(worst, (a - b).abs().max().item())
        close &= torch.allclose(a, b, rtol=tol, atol=tol)
    same = torch.equal(ta, tb)
    log(f"  logits max abs diff {a_name} vs {b_name} {worst:.3e} (tol "
        f"{tol}); greedy tokens {'equal' if same else 'DIFFER'}, "
        f"{tuple(ta.shape)} (rows x steps)")
    if not close:
        raise AssertionError(f"{a_name} vs {b_name} logits differ: {worst}")
    if not same:
        raise AssertionError(f"{a_name} and {b_name} greedy tokens differ")


def phase3b_flash_model(model, params):
    """The flash kernel in the model at full width, 4 layers: the
    full-sequence prefill step (last-position logits; the forward's K2
    launches are counted here) and a dense first chunk plus 8 dense decode
    steps, each through 'pallas' and through 'einsum'."""
    cfg = model.cfg
    B, S = FORWARD_BATCH
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(DEV)
    runs, launches = {}, None
    for impl in ("pallas", "einsum"):
        fa.reset_launches()
        t0 = time.perf_counter()
        logits = steps.make_prefill(model, attn_impl=impl)(
            params, {"tokens": toks})
        torch.cuda.synchronize()
        if impl == "pallas":
            launches = fa.LAUNCHES["forward"]
            if launches != LAYERS:
                raise AssertionError(f"forward launched K2 {launches} times, "
                                     f"not once per layer ({LAYERS})")
        log(f"  make_prefill attn_impl={impl} (B={B}, S={S}): "
            f"{time.perf_counter() - t0:.3f} s (host clock)")
        runs[impl] = ([logits], logits[..., :cfg.vocab_size].argmax(-1))
    compare_runs(runs, cfg, "pallas", "einsum")

    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, 64))
                            ).to(DEV)
    runs = {}
    for impl in ("pallas", "einsum"):
        fa.reset_launches()
        first = steps.make_prefill_chunk(model, s_max=S_MAX, first=True,
                                         attn_impl=impl)
        logits, cache = first(params, {"tokens": toks})
        if fa.LAUNCHES["prefill"] != (LAYERS if impl == "pallas" else 0):
            raise AssertionError(f"dense first chunk ({impl}) launched K2 "
                                 f"{fa.LAUNCHES['prefill']} times")
        seq, tok = [logits], logits[:, :, :cfg.vocab_size].argmax(-1)
        tokens = [tok]
        for _ in range(8):
            logits, cache = model.decode_step(params, tok, cache)
            tok = logits[:, :, :cfg.vocab_size].argmax(-1)
            seq.append(logits)
            tokens.append(tok)
        torch.cuda.synchronize()
        runs[impl] = (seq, torch.cat(tokens, 1))
        del cache
    compare_runs(runs, cfg, "pallas", "einsum")
    del runs
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ------------------------------------------------------------ phases 4, 5
def serve_prompts(vocab):
    """16 prompts of 100-700 tokens; every other one starts with a shared
    256-token header."""
    rng = np.random.default_rng(2)
    header = rng.integers(0, vocab, 256)
    prompts = []
    for i in range(16):
        n = int(rng.integers(100, 701))
        if i % 2:
            n = max(n, 257)
            prompts.append(np.concatenate([header,
                                           rng.integers(0, vocab, n - 256)]))
        else:
            prompts.append(rng.integers(0, vocab, n))
    return prompts


def keep_firsts(engine, firsts):
    """Keep each request's first-token logits (rid -> row) as its group's
    splice samples them; returns a function that removes the hook."""
    splice = engine._splice_and_start

    def keep_first(slot_ids, reqs, rcache, logits, **kw):
        for r, row in zip(reqs, logits[:, 0, :engine.cfg.vocab_size]):
            firsts.setdefault(r.rid, row.clone())
        return splice(slot_ids, reqs, rcache, logits, **kw)

    engine._splice_and_start = keep_first
    return lambda: setattr(engine, "_splice_and_start", splice)


def no_failures(engine, what):
    """The engine catches a prefill chunk that raises and fails its job;
    every serving run here requires that no chunk failed, so a kernel that
    does not build or launch cannot hide behind that catch."""
    if engine.prefill_failures:
        raise AssertionError(f"{what}: {engine.prefill_failures} prefill "
                             f"chunk(s) failed")


def served_in_full(reqs, vocab, gen=32):
    bad = [r.rid for r in reqs if r.state.value != "done"
           or len(r.tokens) != gen
           or not all(0 <= t < vocab for t in r.tokens)]
    if bad:
        raise AssertionError(f"requests not served in full: {bad}")


def serve(engine, prompts):
    """Submit, run; every request served in full with in-vocab tokens and
    no prefill chunk failed. Also returns each request's first-token
    logits (rid -> row)."""
    firsts = {}
    unhook = keep_firsts(engine, firsts)
    reqs = [engine.submit(p, 32) for p in prompts]
    m = engine.run()
    unhook()
    no_failures(engine, "serving")
    served_in_full(reqs, engine.cfg.vocab_size)
    return reqs, m, [firsts[r.rid] for r in reqs]


def log_serving(m, card):
    log(f"  served {m['completed']}/{m['requests']} requests, "
        f"{m['total_tokens']} tokens "
        f"in {m['wall_s']:.3f} s: {m['throughput_tokens_per_s']:.1f} tok/s | "
        f"TTFT p50 {m['ttft_s']['p50'] * 1e3:.1f} ms | ITL p50 "
        f"{m['itl_s']['p50'] * 1e3:.2f} ms | prefill "
        f"{m['prefill_tokens_per_s']:.0f} tok/s ({card})")


def phase4_serve(model, params, prompts, card):
    """Paged serving (the first slice's path) over the main path's
    weights. Returns the launch counts, the requests, their first-token
    logits, the resident cache bytes and the serving metrics."""
    engine = ServeEngine(model, params, **ServeConfig(
        reduced=False, page_size=PS, s_max=S_MAX,
        batch_slots=SLOTS).engine_kwargs())
    log(f"  paged engine: attn {engine.paged_attn_impl}, prefix cache "
        f"{engine.prefix_cache}, {engine.num_pages} pages")
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, firsts = serve(engine, prompts)
    launches = check_paged_launches(("decode", "prefill"), m,
                                    "paged-attention (K1)")
    engine.assert_page_invariants()
    log_serving(m, card)
    log(f"  prefix: {m['prefix']['hits']} hits of {m['prefix']['lookups']} "
        f"lookups, {m['prefix']['hit_tokens']} tokens, "
        f"{m['prefix']['cow_copies']} COW copies")
    nbytes = engine.resident_cache_bytes()
    del engine
    torch.cuda.empty_cache()
    return launches, reqs, firsts, nbytes, m


def check_paged_launches(kinds, m, what):
    """Every multi-page attention of a paged serving run went through the
    kernel: ``kinds`` = (decode key, prefill key) of ``pa.LAUNCHES`` equal
    layers x decode steps and layers x prefill chunks, and no other kernel
    was launched. Returns the counts."""
    launches = dict(pa.LAUNCHES)
    others = {k: v for k, v in launches.items() if k not in kinds}
    if sum(others.values()) or sum(fa.LAUNCHES.values()):
        raise AssertionError(f"{what} launched other kernels: {others}, "
                             f"{fa.LAUNCHES}")
    dec, pre = kinds
    if (launches[dec] != m["decode_steps"] * LAYERS
            or launches[pre] != m["prefill_chunks"] * LAYERS
            or not launches[dec] or not launches[pre]):
        raise AssertionError(f"{what}: launches {launches} != one per layer "
                             f"per decode step ({m['decode_steps']}) / "
                             f"prefill chunk ({m['prefill_chunks']})")
    log(f"  {what} launches: {dec} {launches[dec]} ({m['decode_steps']} "
        f"steps x {LAYERS} layers), {pre} {launches[pre]} "
        f"({m['prefill_chunks']} chunks x {LAYERS} layers)")
    return {"decode": launches[dec], "prefill": launches[pre]}


def phase4b_serve_int8(model, params, prompts, card, fp32):
    """The same 16 requests on int8 pages (``kv_backend="paged_int8"``,
    page_size 16), every attention through K3. Int8 tokens differ from
    fp32 tokens by design: the match against phase 4 is reported. Returns
    the launch counts and the serving metrics."""
    engine = ServeEngine(model, params, **ServeConfig(
        reduced=False, page_size=PS, s_max=S_MAX, batch_slots=SLOTS,
        kv_backend="paged_int8").engine_kwargs())
    log(f"  int8 engine: {type(engine.backend).__name__}, attn "
        f"{engine.paged_attn_impl}, prefix cache {engine.prefix_cache}")
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, firsts = serve(engine, prompts)
    launches = check_paged_launches(("decode_q8", "prefill_q8"), m,
                                    "int8 paged-attention (K3)")
    engine.assert_page_invariants()
    log_serving(m, card)
    log(f"  prefix: {m['prefix']['hits']} hits of {m['prefix']['lookups']} "
        f"lookups, {m['prefix']['cow_copies']} COW copies; resident cache "
        f"{engine.resident_cache_bytes()} bytes = "
        f"{engine.resident_cache_bytes() / fp32[2]:.4f} x the fp32 pages'")
    compare_streams("int8", (reqs, firsts), "fp32 pages", fp32[:2],
                    strict=False)
    del engine
    torch.cuda.empty_cache()
    return launches, m


def compare_streams(a_name, a, b_name, b, strict=True):
    """Two engines' streams for the same requests: first tokens equal
    unless the two logits sit within 1e-3 of a tie (raises otherwise when
    ``strict``); logs how many first tokens and tokens agree."""
    same_first = same_tok = 0
    for ra, rb, fa_, fb in zip(a[0], b[0], a[1], b[1]):
        same_tok += sum(x == y for x, y in zip(ra.tokens, rb.tokens))
        x, y = ra.tokens[0], rb.tokens[0]
        if x == y:
            same_first += 1
            continue
        gap = max((fa_[x] - fa_[y]).item(), (fb[y] - fb[x]).item())
        log(f"  request {ra.rid}: first token {x} ({a_name}) vs {y} "
            f"({b_name}), logit gap {gap:.2e}")
        if strict and gap > 1e-3:
            raise AssertionError(f"request {ra.rid}: {a_name} and {b_name} "
                                 f"first tokens differ by a logit gap of "
                                 f"{gap}")
    total = sum(len(r.tokens) for r in a[0])
    log(f"  {a_name} vs {b_name}: first token equal for {same_first}/"
        f"{len(a[0])} requests, {same_tok}/{total} tokens equal")
    return same_first, same_tok, total


def phase5_serve_dense(engine, prompts, card, paged):
    """The main path: the default dense cache, its first chunks through the
    flash kernel. Then its tokens against the paged engine's (phase 4)."""
    log(f"  dense engine: prefill attn {engine.prefill_attn_impl}, prefix "
        f"cache {engine.prefix_cache}, transient prefill caches")
    n_first = [0]
    first = engine._chunk_first

    def counted(*args):
        n_first[0] += 1
        return first(*args)

    engine._chunk_first = counted
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, firsts = serve(engine, prompts)
    launches = dict(fa.LAUNCHES)
    engine._chunk_first = first
    if sum(pa.LAUNCHES.values()) or launches["forward"]:
        raise AssertionError(f"dense serving launched {pa.LAUNCHES} (K1), "
                             f"{launches} (K2)")
    if launches["prefill"] != n_first[0] * LAYERS or not n_first[0]:
        raise AssertionError(f"K2 prefill launches {launches['prefill']} != "
                             f"{n_first[0]} first chunks x {LAYERS} layers")
    log_serving(m, card)
    log(f"  flash-attention launches: prefill {launches['prefill']} "
        f"({n_first[0]} first chunks x {LAYERS} layers) of "
        f"{m['prefill_chunks']} chunks; {engine.max_transient_cache_bytes} "
        f"transient cache bytes at most")

    compare_streams("dense", (reqs, firsts), "paged", paged)
    return launches


# ------------------------------------------------------------ phase 11
# 11a: the nucleus setting of the sampled runs
SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.9)
# 11b: the reference bench's burst cell (benchmarks/serve_bench.py:563-575
# and :620-662): its policy, its pool and its traffic, on the full-width
# model; the base rate is a multiple of the rate the card sustains
GOODPUT_POLICY_KW = dict(drr=True, max_consecutive_prefill_ticks=2,
                         preemption=True, admission_low_water=0.15,
                         admission_shed_priority=2)
BURST_POOL = dict(batch_slots=4, s_max=96, page_size=PS, num_pages=8)
BURST_LENGTHS = dict(prompt_len_median=24, prompt_len_sigma=0.5,
                     prompt_len_max=48, gen_len_median=10, gen_len_sigma=0.5,
                     gen_len_max=24,
                     priority_weights=((0, 0.2), (1, 0.2), (2, 0.6)))
BURST_CAL, BURST_REQUESTS = 12, 32     # calibration and burst schedules
# base rate x sustainable: 2x as the bench; raised only if the policy run
# neither preempts nor sheds there (the policy itself never changes)
BURST_OVER = (2.0, 4.0, 8.0)
SLO_TTFT_MULT, SLO_ITL_MULT = 2.5, 8.0   # x the unloaded p95s, as the bench
ROOT = pathlib.Path(__file__).resolve().parent


def paged_engine(model, params, **fields):
    """An engine on fp32 pages of 16 over the main path's weights, with
    phase 4's slots and s_max unless ``fields`` say otherwise."""
    fields = dict(dict(page_size=PS, s_max=S_MAX, batch_slots=SLOTS),
                  **fields)
    return ServeEngine(model, params, **ServeConfig(
        reduced=False, **fields).engine_kwargs())


def check_kept(engine, counts):
    """Wrap the engine's filter and sampler: every token a sampling event
    draws lies in its filtered row's kept set and below vocab_size."""
    kept = []
    filt, sample = engine._filter_logits, engine._sample_rows

    def keep(scaled):
        out = filt(scaled)
        kept.append(torch.isfinite(out))
        return out

    def checked(logits):
        toks = sample(logits)
        ok = kept.pop()
        t = torch.as_tensor(toks, device=ok.device)
        if (t >= engine.cfg.vocab_size).any() or not bool(
                ok[torch.arange(len(toks), device=ok.device), t].all()):
            raise AssertionError(f"a sampled token left the kept set: "
                                 f"{toks}")
        counts["events"] += 1
        counts["tokens"] += len(toks)
        counts["kept"] += int(ok.sum())
        return toks

    engine._filter_logits, engine._sample_rows = keep, checked


def phase11a_sampling(model, params, prompts, card, greedy):
    """The 16 requests on fp32 pages, sampled: at temperature 0.8 with
    top_k=1 the streams equal phase 4's greedy ones; with top-k 50 and
    top-p 0.9 seed 7 gives one stream twice (every token of the first run
    checked against its filtered row's kept set) and seed 8 another.
    Every run's attention goes through K1. Returns the sampled run's
    metrics."""
    engine = paged_engine(model, params, temperature=0.8, top_k=1, seed=7)
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, firsts = serve(engine, prompts)
    check_paged_launches(("decode", "prefill"), m, "top_k=1 (K1)")
    engine.assert_page_invariants()
    _, same, total = compare_streams("top_k=1", (reqs, firsts),
                                     "greedy", greedy[:2])
    if same != total:
        raise AssertionError(f"top_k=1 streams differ from greedy in "
                             f"{total - same} tokens")
    top1 = m
    del engine
    streams, runs = {}, {}
    for label, seed in (("seed 7", 7), ("seed 7 again", 7),
                        ("seed 8", 8)):
        engine = paged_engine(model, params, seed=seed, **SAMPLE)
        counts = {"events": 0, "tokens": 0, "kept": 0}
        if label == "seed 7":
            check_kept(engine, counts)
        pa.reset_launches()
        fa.reset_launches()
        reqs, m, _ = serve(engine, prompts)
        check_paged_launches(("decode", "prefill"), m, f"{label} (K1)")
        engine.assert_page_invariants()
        streams[label] = [list(r.tokens) for r in reqs]
        runs[label] = m
        if counts["events"]:
            log(f"  {label}: {counts['tokens']} sampled tokens of "
                f"{counts['events']} events all in their kept sets (mean "
                f"{counts['kept'] / counts['tokens']:.1f} kept of "
                f"{engine.cfg.vocab_size})")
        del engine
    if streams["seed 7"] != streams["seed 7 again"]:
        raise AssertionError("seed 7 gave two different streams")
    differ = sum(a != b for a, b in zip(streams["seed 7"],
                                        streams["seed 8"]))
    if not differ:
        raise AssertionError("seeds 7 and 8 gave the same streams")
    log(f"  seed 7 twice: equal streams; seed 8: {differ}/16 streams "
        f"differ")
    m, g = runs["seed 7 again"], greedy[2]
    log(f"  sampled (T 0.8, top-k 50, top-p 0.9): "
        f"{m['throughput_tokens_per_s']:.1f} tok/s, ITL p50 "
        f"{m['itl_s']['p50'] * 1e3:.2f} ms; top_k=1 "
        f"{top1['throughput_tokens_per_s']:.1f} tok/s, "
        f"{top1['itl_s']['p50'] * 1e3:.2f} ms; greedy (phase 4) "
        f"{g['throughput_tokens_per_s']:.1f} tok/s, "
        f"{g['itl_s']['p50'] * 1e3:.2f} ms ({card})")
    # what one decode tick pays to pick its tokens from (8, V) logits,
    # the copy of the tokens to the host included
    logits = 4 * torch.randn(SLOTS, 1, model.cfg.vocab_size, device=DEV,
                             generator=torch.Generator(DEV).manual_seed(4))
    cost = {}
    for label, fields in (("greedy", {}),
                          ("top_k=1", dict(temperature=0.8, top_k=1)),
                          ("top-k 50, top-p 0.9", SAMPLE)):
        engine = paged_engine(model, params, s_max=2 * PS, **fields)
        cost[label] = time_ms(lambda: engine._sample_rows(logits), 50)
        del engine
    log("  token choice per tick (8 rows): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in cost.items()) + f" ({card})")
    torch.cuda.empty_cache()
    return m


def burst_replay(model, params, policy, events, slo, label):
    """Replay ``events`` open loop on a fresh engine of the burst pool:
    every request completed or aborted, the pages sound, no chunk failed,
    every attention through K1. Returns (engine, summary)."""
    engine = ServeEngine(model, params, **ServeConfig(
        reduced=False, **BURST_POOL,
        policy=None if policy is None else SchedPolicy(**policy)
    ).engine_kwargs())
    pa.reset_launches()
    fa.reset_launches()
    s = workload.replay(engine, events, slo)
    n = len(events)
    if s["requests"] != n or s["completed"] + s["aborted"] != n:
        raise AssertionError(f"{label}: {s['completed']} completed + "
                             f"{s['aborted']} aborted of {n}")
    engine.assert_page_invariants()
    no_failures(engine, label)
    check_paged_launches(("decode", "prefill"), s.metrics, f"{label} (K1)")
    return engine, s


def ttft_p95_by_priority(engine) -> dict:
    recs = [r for r in engine.metrics.requests.values()
            if r.ttft_s is not None and not r.aborted]
    return {p: percentile([r.ttft_s for r in recs if r.priority == p], 95)
            for p in sorted({r.priority for r in recs})}


def log_goodput(label, engine, s, card):
    g = s["goodput"]
    att = ", ".join(f"p{p} {c['slo_attainment']:.2f} (TTFT "
                    f"{c['ttft_attainment']:.2f})"
                    for p, c in g["by_priority"].items())
    ttft = ", ".join(f"p{p} {t * 1e3:.1f} ms"
                     for p, t in ttft_p95_by_priority(engine).items())
    log(f"  {label}: goodput {g['goodput_tokens_per_s']:.1f} tok/s of "
        f"{s['throughput_tokens_per_s']:.1f}, SLO met {g['slo_met']}/"
        f"{g['submitted']}; attainment {att}; TTFT p95 {ttft}; "
        f"{s['preemptions']} preemptions, {s['shed_requests']} shed, "
        f"{engine.deferrals} deferrals, {s['starvation_guard_skips']} "
        f"guard skips ({card})")


def phase11b_burst(model, params, card):
    """The bench's burst cell on the card: calibrate capacity (closed
    loop) and the SLO (an unloaded 2-request replay), then one bursty
    schedule at 2x the sustainable rate replayed to warm up, under FIFO
    and under the policy, goodput and attainment by priority printed.
    The policy run must preempt and shed (the rate is raised, never the
    policy changed, until it does), and every preempted request that
    completed must give its uninterrupted greedy stream."""
    vocab = model.cfg.vocab_size
    cal = workload.generate(WorkloadSpec(n_requests=BURST_CAL, rate_rps=1e9,
                                         seed=0, **BURST_LENGTHS), vocab)
    burst_replay(model, params, GOODPUT_POLICY_KW, cal, None, "warm-up")
    _, cap = burst_replay(model, params, None, cal, None, "capacity")
    capacity = cap["throughput_tokens_per_s"]
    un_events = workload.generate(WorkloadSpec(
        n_requests=2, rate_rps=1e9, seed=1, **BURST_LENGTHS), vocab)
    _, un = burst_replay(model, params, None, un_events, None, "unloaded")
    mean_gen = float(np.mean([e.gen_len for e in cal]))
    sustainable = capacity / max(mean_gen, 1.0)
    slo = SLO(ttft_s=max(SLO_TTFT_MULT * un["ttft_s"]["p95"], 0.02),
              itl_p95_s=max(SLO_ITL_MULT * un["itl_s"]["p95"], 0.005))
    log(f"  capacity {capacity:.1f} tok/s (closed loop, {BURST_CAL} "
        f"requests), sustainable {sustainable:.2f} req/s; SLO TTFT <= "
        f"{slo.ttft_s * 1e3:.1f} ms, ITL p95 <= {slo.itl_p95_s * 1e3:.2f} "
        f"ms ({card})")
    for over in BURST_OVER:
        events = workload.generate(WorkloadSpec(
            n_requests=BURST_REQUESTS, rate_rps=over * sustainable, seed=3,
            burst_start_frac=0.1, burst_len_frac=0.5, burst_mult=2.5,
            **BURST_LENGTHS), vocab)
        burst_replay(model, params, GOODPUT_POLICY_KW, events, slo,
                     "burst warm-up")
        fifo_eng, fifo = burst_replay(model, params, None, events, slo,
                                      "FIFO")
        pol_eng, pol = burst_replay(model, params, GOODPUT_POLICY_KW,
                                    events, slo, "policy")
        log(f"  burst at {over:g} x sustainable ({BURST_REQUESTS} "
            f"requests, 2.5x over 0.1-0.6 of the horizon):")
        log_goodput("FIFO", fifo_eng, fifo, card)
        log_goodput("policy", pol_eng, pol, card)
        if pol["preemptions"] and pol["shed_requests"]:
            break
        log(f"  the policy neither preempted and shed at {over:g} x: "
            f"raising the rate")
    else:
        raise AssertionError("the policy run never both preempted and shed")
    resumed = [r for r in pol_eng.requests.values()
               if r.folded and r.state is RequestState.DONE]
    closed = ServeEngine(model, params, **ServeConfig(
        reduced=False, **BURST_POOL).engine_kwargs())
    alone = [closed.submit(events[r.rid].prompt, events[r.rid].gen_len)
             for r in resumed]
    closed.run()
    no_failures(closed, "closed loop")
    for r, a in zip(resumed, alone):
        if list(r.tokens) != list(a.tokens):
            raise AssertionError(f"preempted request {r.rid} resumed to "
                                 f"{r.tokens}, uninterrupted {a.tokens}")
    paused = sum(r.folded > 0 for r in pol_eng.requests.values())
    log(f"  {len(resumed)} preempted requests completed with their "
        f"uninterrupted greedy streams ({paused} preempted in all)")
    torch.cuda.empty_cache()
    return fifo, pol


def phase11c_router(model, params, prompts, card, greedy):
    """Two replicas over the same weight tensors behind a prefix-affinity
    router: the 16 requests complete, the header-sharing ones on one
    replica, with phase 4's streams. Returns the tier's pooled summary."""
    engines = [paged_engine(model, params) for _ in range(2)]
    if engines[0].params is not engines[1].params:
        raise AssertionError("the replicas hold copies of the weights")
    router = ReplicaRouter(engines, affinity=True)
    firsts = [{}, {}]
    unhook = [keep_firsts(e, f) for e, f in zip(engines, firsts)]
    pa.reset_launches()
    fa.reset_launches()
    for e in engines:
        e.metrics.on_start()
    routed = [router.submit(p, 32) for p in prompts]
    router.drain()
    torch.cuda.synchronize()
    for e in engines:
        e.metrics.on_stop()
    for u in unhook:
        u()
    m = merged_summary([e.metrics for e in engines])
    reqs = [r for r, _ in routed]
    served_in_full(reqs, model.cfg.vocab_size)
    for i, e in enumerate(engines):
        no_failures(e, f"replica {i}")
        e.assert_page_invariants()
    header = {t for i, (_, t) in enumerate(routed) if i % 2}
    if len(header) != 1:
        raise AssertionError(f"header-sharing prompts spread over replicas "
                             f"{header}")
    check_paged_launches(("decode", "prefill"), m, "router tier (K1)")
    log(f"  router: {router.stats()}; header prompts on replica "
        f"{header.pop()}; prefix hits {m['prefix']['hits']} of "
        f"{m['prefix']['lookups']}")
    log_serving(m, card)
    compare_streams("router", (reqs, [firsts[t][r.rid] for r, t in routed]),
                    "paged", greedy[:2])
    del engines, router
    torch.cuda.empty_cache()
    return m


def phase11d_cancel(model, params, prompts, greedy):
    """One engine (4 slots, prefix cache off) cancels a RUNNING, a
    PREFILLING, a QUEUED request and one member of a grouped prefill; the
    survivors' streams against phase 4's, every page back, invariants."""
    engine = paged_engine(model, params, batch_slots=4, prefix_cache=False)
    firsts = {}
    unhook = keep_firsts(engine, firsts)
    pa.reset_launches()
    fa.reset_launches()
    rng = np.random.default_rng(11)
    running = engine.submit(prompts[0], 32)
    while running.state is not RequestState.RUNNING:
        engine.step()
    member = engine.submit(prompts[2], 32)
    mate = engine.submit(rng.integers(0, model.cfg.vocab_size,
                                      len(prompts[2])), 32)
    prefilling = engine.submit(prompts[4], 32)
    queued = engine.submit(prompts[6], 32)
    survivor = engine.submit(prompts[8], 32)
    engine.step()
    jobs = [[r.rid for r in j.reqs] for j in engine._jobs]
    if ([member.rid, mate.rid] not in jobs or [prefilling.rid] not in jobs
            or queued.state is not RequestState.QUEUED):
        raise AssertionError(f"unexpected admission: jobs {jobs}")
    for r in (running, prefilling, mate, queued):
        if not engine.cancel(r.rid):
            raise AssertionError(f"cancel of {r.rid} returned False")
    if mate.state is not RequestState.PREFILLING:
        raise AssertionError("a grouped member's cancel landed before the "
                             "splice")
    m = engine.run()
    unhook()
    no_failures(engine, "cancel")
    engine.assert_page_invariants()
    states = [r.state for r in (running, prefilling, mate, queued)]
    if (states != [RequestState.CANCELLED] * 4 or mate.tokens
            or queued.tokens):
        raise AssertionError(f"cancelled requests ended {states}")
    served_in_full([member, survivor], model.cfg.vocab_size)
    if engine.free_pages != engine.num_pages:
        raise AssertionError(f"{engine.free_pages} of {engine.num_pages} "
                             f"pages free after the cancels")
    check_paged_launches(("decode", "prefill"), m, "cancel run (K1)")
    log(f"  cancelled RUNNING, PREFILLING, QUEUED and a grouped member; "
        f"{m['aborted']} aborted, {m['completed']} completed, "
        f"{engine.free_pages}/{engine.num_pages} pages free")
    compare_streams("survivors", ([member, survivor],
                                  [firsts[member.rid], firsts[survivor.rid]]),
                    "paged", ([greedy[0][2], greedy[0][8]],
                              [greedy[1][2], greedy[1][8]]))
    del engine
    torch.cuda.empty_cache()


def phase11e_cli(card):
    """The traffic harness and the serving CLI as a user runs them, each
    in its own process on the card. Both exit 0, and their summaries show
    no failed prefill chunk and no request aborted but by a shed: the
    engines there catch a chunk that raises, so the exit code alone could
    hide a kernel that does not build or launch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for cmd in (["-m", "repro_torch.serve.workload"],
                ["-m", "repro_torch.launch.serve", "--temperature", "0.7",
                 "--top-p", "0.9", "--json"]):
        what = " ".join(cmd[1:])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                              text=True, timeout=600, env=env, cwd=ROOT)
        took = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"{what} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        # the summary JSON comes first (the CLI prints its line after it)
        s, end = json.JSONDecoder().raw_decode(proc.stdout.lstrip())
        shed = s["shed_requests"]
        if (s["prefill_failures"] or s["aborted"] != shed
                or s["completed"] + s["aborted"] != s["requests"]):
            raise AssertionError(
                f"{what}: {s['prefill_failures']} prefill chunk(s) failed, "
                f"{s['completed']} completed and {s['aborted']} aborted "
                f"({shed} shed) of {s['requests']}:\n{proc.stderr[-3000:]}")
        if cmd[1].endswith("workload"):
            g = s["goodput"]
            log(f"  {what}: {s['completed']} completed + {s['aborted']} "
                f"shed of {s['requests']}, 0 prefill failures, goodput "
                f"{g['goodput_tokens_per_s']:.1f} tok/s, {took:.1f} s "
                f"({card})")
        else:
            log(f"  {what}: {proc.stdout.lstrip()[end:].strip()}, "
                f"{s['completed']}/{s['requests']} completed, 0 prefill "
                f"failures ({took:.1f} s, {card})")


def phase11(model, params, prompts, card, greedy):
    """Phase 11 on phase 4's weights and prompts; ``greedy`` = phase 4's
    (requests, first-token logits, metrics)."""
    t0 = time.perf_counter()
    log("phase 11a: sampling on fp32 pages")
    phase11a_sampling(model, params, prompts, card, greedy)
    log("phase 11b: scheduling policy under the bench's burst")
    phase11b_burst(model, params, card)
    log("phase 11c: two replicas behind the prefix-affinity router")
    phase11c_router(model, params, prompts, card, greedy)
    log("phase 11d: cancellation in every state")
    phase11d_cancel(model, params, prompts, greedy)
    log("phase 11e: the workload harness and the serving CLI")
    phase11e_cli(card)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phase 6
def phase6_anchors():
    """Reduced qwen2.5-32b on the card: the dense cache (parallel prefill,
    its first chunk through K2, and the scan anchor), the paged one-page
    einsum anchor and the paged kernel path give equal greedy streams."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n) for n in (5, 17, 40, 64 - 15, 3, 30)]
    streams = {}
    for name, fields in (
            ("dense parallel", dict()),
            ("dense scan", dict(prefill_mode="scan")),
            ("paged one-page einsum", dict(page_size=64)),
            ("paged kernel", dict(page_size=16))):
        engine = ServeEngine.build(ARCH, config=ServeConfig(
            s_max=64, batch_slots=4, **fields))
        reqs = [engine.submit(p, 16) for p in prompts]
        engine.run()
        no_failures(engine, name)
        streams[name] = [list(r.tokens) for r in reqs]
        log(f"  {name}: paged attn {engine.paged_attn_impl}, prefill attn "
            f"{engine.prefill_attn_impl}, {sum(map(len, streams[name]))} "
            f"tokens")
    equal_streams(streams)

    # int8 pages: the same engine (incremental splice) reading through K3
    # and, with the step functions swapped, through the q8 einsum
    streams = {}
    for impl in ("kernel", "einsum"):
        engine = ServeEngine.build(ARCH, config=ServeConfig(
            s_max=64, batch_slots=4, page_size=16, kv_backend="paged_int8"))
        if impl == "einsum":
            engine._decode = steps.make_decode_step(
                engine.model, paged_attn_impl="einsum")
            engine._chunk_paged = steps.make_prefill_chunk_paged(
                engine.model, attn_impl="einsum")
        pa.reset_launches()
        reqs = [engine.submit(p, 16) for p in prompts]
        engine.run()
        no_failures(engine, f"int8 {impl}")
        q8 = pa.LAUNCHES["decode_q8"] + pa.LAUNCHES["prefill_q8"]
        if (q8 > 0) != (impl == "kernel"):
            raise AssertionError(f"int8 {impl}: {pa.LAUNCHES}")
        streams[f"int8 {impl}"] = [list(r.tokens) for r in reqs]
        log(f"  int8 {impl}: {q8} K3 launches, "
            f"{sum(map(len, streams[f'int8 {impl}']))} tokens")
    equal_streams(streams)

    streams = {}
    for name, fields in (
            ("MLA dense latent", dict()),
            ("MLA one-page latent einsum", dict(page_size=64,
                                                kv_backend="paged_latent")),
            ("MLA latent pages (K4)", dict(page_size=16))):
        engine = ServeEngine.build(MLA_ARCH, config=ServeConfig(
            s_max=64, batch_slots=4, **fields))
        pa.reset_launches()
        reqs = [engine.submit(p, 16) for p in prompts]
        engine.run()
        no_failures(engine, name)
        streams[name] = [list(r.tokens) for r in reqs]
        log(f"  {name}: paged attn {engine.paged_attn_impl}, "
            f"{pa.LAUNCHES['decode_latent'] + pa.LAUNCHES['prefill_latent']}"
            f" K4 launches, {sum(map(len, streams[name]))} tokens")
    equal_streams(streams)
    phase6_recurrent_anchors(prompts)


def perturb_recurrent(params, arch, seed):
    """Test data only: seeded noise (``RECURRENT_NOISE``) added in place to
    the layer leaves ``repro``'s init leaves constant, so that the decay,
    rwkv's bonus and hymba's per-channel A depend on the data."""
    gen = torch.Generator(DEV).manual_seed(seed)
    for key, scale in RECURRENT_NOISE[arch].items():
        leaf = params["layers"][key]
        leaf.add_(scale * torch.randn(leaf.shape, generator=gen,
                                      device=leaf.device))
    return params


def scan_kernel(arch):
    return "wkv6" if arch == RWKV else "selective_scan"


def phase6_recurrent_anchors(prompts):
    """rwkv6 and hymba reduced on perturbed weights, every recurrence
    through K5 / K6: parallel chunked prefill and the scan anchor give
    equal greedy streams, and so do hymba's dense ring and paged ring
    (pages of 4 rows, 2 per 8-row ring, which the prompts wrap). Each run
    launches its kernel once per layer per chunk, per anchor token and per
    decode tick."""
    for arch, paths in (
            (RWKV, (("dense parallel", {}),
                    ("dense scan", dict(prefill_mode="scan")))),
            (HYMBA, (("dense ring parallel", {}),
                     ("dense ring scan", dict(prefill_mode="scan")),
                     ("paged ring parallel", dict(page_size=4)),
                     ("paged ring scan", dict(page_size=4,
                                              prefill_mode="scan"))))):
        streams = {}
        for name, fields in paths:
            engine = ServeEngine.build(arch, config=ServeConfig(
                s_max=64, batch_slots=4, **fields))
            perturb_recurrent(engine.params, arch, 6)
            ls.reset_launches()
            reqs = [engine.submit(p, 16) for p in prompts]
            m = engine.run()
            no_failures(engine, f"{arch} {name}")
            kernel = scan_kernel(arch)
            steps_run = m["decode_steps"] + (
                sum(len(p) for p in prompts)
                if engine.prefill_mode == "scan" else m["prefill_chunks"])
            want = engine.cfg.num_layers * steps_run
            if ls.LAUNCHES[kernel] != want or sum(ls.LAUNCHES.values()) \
                    != want:
                raise AssertionError(f"{arch} {name}: {ls.LAUNCHES}, want "
                                     f"{want} {kernel} launches")
            streams[f"{arch} {name}"] = [list(r.tokens) for r in reqs]
            log(f"  {arch} {name}: paged {engine.paged}, {want} {kernel} "
                f"launches, {sum(map(len, streams[f'{arch} {name}']))} "
                f"tokens")
        equal_streams(streams)


def equal_streams(streams):
    first_name, first = next(iter(streams.items()))
    for name, got in streams.items():
        if got != first:
            raise AssertionError(f"{name} greedy stream differs from "
                                 f"{first_name}")
    log(f"  greedy streams equal across {len(streams)} paths")


# ------------------------------------------------------------ phase 7
def phase7_mla(card):
    """qwen2.5-32b-mla at full width cut to 4 layers: the model step on
    latent pages through K4 against the latent einsum, then the 16
    requests on the dense latent cache (einsum only, no kernel) and on
    latent pages (every paged attention through K4); streams compared.
    Returns K4's launches and each cache's serving metrics."""
    t0 = time.perf_counter()
    dense = ServeEngine.build(MLA_ARCH, config=ServeConfig(
        reduced=False, cfg_overrides={"num_layers": LAYERS}, s_max=S_MAX,
        batch_slots=SLOTS))
    torch.cuda.synchronize()
    model, params = dense.model, dense.params
    log(f"  engine built in {time.perf_counter() - t0:.2f} s (dense latent "
        f"cache {dense.resident_cache_bytes()} bytes)")
    mps = S_MAX // PS
    phase3_model(model, params, PagedLatentBackend(PS, SLOTS * mps),
                 "latent pages")
    served = {}
    prompts = serve_prompts(model.cfg.vocab_size)

    pa.reset_launches()
    fa.reset_launches()
    d_reqs, m, d_firsts = serve(dense, prompts)
    if sum(pa.LAUNCHES.values()) or sum(fa.LAUNCHES.values()):
        raise AssertionError(f"the dense latent cache launched a kernel: "
                             f"{pa.LAUNCHES}, {fa.LAUNCHES}")
    log("  dense latent cache (no kernel):")
    log_serving(m, card)
    served["dense_latent"] = m
    del dense
    torch.cuda.empty_cache()

    paged = ServeEngine(model, params, **ServeConfig(
        reduced=False, page_size=PS, s_max=S_MAX, batch_slots=SLOTS,
        kv_backend="paged_latent").engine_kwargs())
    log(f"  latent pages: attn {paged.paged_attn_impl}, prefix cache "
        f"{paged.prefix_cache}, {paged.num_pages} pages, resident cache "
        f"{paged.resident_cache_bytes()} bytes")
    pa.reset_launches()
    fa.reset_launches()
    p_reqs, m, p_firsts = serve(paged, prompts)
    launches = check_paged_launches(("decode_latent", "prefill_latent"), m,
                                    "latent paged-attention (K4)")
    paged.assert_page_invariants()
    log_serving(m, card)
    served["latent_pages"] = m
    log(f"  prefix: {m['prefix']['hits']} hits of {m['prefix']['lookups']} "
        f"lookups, {m['prefix']['cow_copies']} COW copies")
    compare_streams("dense latent", (d_reqs, d_firsts), "latent pages",
                    (p_reqs, p_firsts))
    del paged, model, params
    torch.cuda.empty_cache()
    return launches, served


# ------------------------------------------------ phase 2: GEMMs (K7, K8)
def gemm_held(name, got, want, tol=GEMM_TOL):
    """A GEMM kernel's output against its plain version's, within ``tol``
    of the output's largest magnitude; returns max |diff|."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item() if want.numel() else 0.0
    atol = tol * max(1.0, want.abs().max().item() if want.numel() else 0.0)
    if not torch.allclose(got, want, rtol=tol, atol=atol):
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max abs err {err} (atol {atol:.2e})")
    return err


def rand_on_card(gen, *shape):
    return torch.randn(shape, generator=gen, device=DEV)


def resnet_weight(gen, K, N):
    """A He-scaled (K, N) im2col weight and its per-output-channel int8
    form from ``quantize_per_channel``: (w, w_q, scales (N,))."""
    w = rand_on_card(gen, K, N) * (2.0 / K) ** 0.5
    qt = quantize_per_channel(w)
    return w, qt.q, qt.scale.reshape(-1)


def gemm_cases():
    """(label, M, K, N): the CPU tests' shapes, a K that takes several
    K-chunks, then each of ResNet20's 21 im2col GEMMs at batch 1 and 256."""
    cases = [(f"test {m}x{k}x{n}", m, k, n) for m, k, n in
             ((256, 256, 256), (192, 320, 128), (130, 70, 200),
              (64, 512, 96), (4096, 5120, 64))]
    for B in RESNET_BATCHES:
        cases += [(f"{name} B={B}", m, k, n) for name, m, k, n in
                  resnet.conv_layer_shapes(RESNET, B)]
    return cases


def phase2_gemm_cases():
    """K7 in every dataflow and K8 against their plain versions: the test
    shapes, the 21 ResNet20 GEMMs at batch 1 and 256 (K8 on per-channel
    int8 weights), qwen2.5-32b's wo at M = 8, and bf16 cases. The
    three dataflows must give the same bits, and K8 the bits of K7 on the
    dequantized weight. Returns max |diff| per kernel row."""
    gen = torch.Generator(DEV).manual_seed(20)
    errs = {df: 0.0 for df in DATAFLOWS}
    errs["quant_matmul"] = 0.0
    worst = {}
    for label, M, K, N in gemm_cases() + [("lm wo",) + LM_PROJ]:
        x = rand_on_card(gen, M, K)
        w, w_q, sc = resnet_weight(gen, K, N)
        want = ref.matmul(x, w)
        outs = [mm.matmul(x, w, dataflow=df) for df in DATAFLOWS]
        for df, got in zip(DATAFLOWS, outs):
            errs[df] = max(errs[df], gemm_held(f"K7 {df} {label}", got,
                                               want))
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"K7 {label}: dataflows differ in bits")
        got = qm.quant_matmul(x, w_q, sc)
        err = gemm_held(f"K8 {label}", got, ref.quant_matmul(x, w_q, sc))
        errs["quant_matmul"] = max(errs["quant_matmul"], err)
        deq = w_q.float() * sc[None, :]
        if not torch.equal(got, mm.matmul(x, deq)):
            raise AssertionError(f"K8 {label}: not K7's bits on the "
                                 f"dequantized weight")
        worst[label] = err
    log(f"  K7 x {len(DATAFLOWS)} dataflows and K8 on {len(worst)} shapes: "
        f"max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; dataflows bit-equal; K8 == K7 on the dequantized weight")
    for label, M, K, N in (("test 256x256x256", 256, 256, 256),
                           ("s1b0c2 B=256", 65536, 288, 32)):
        x, (w, w_q, sc) = rand_on_card(gen, M, K), resnet_weight(gen, K, N)
        xb, wb = x.bfloat16(), w.bfloat16()
        for df in DATAFLOWS:
            got = mm.matmul(xb, wb, dataflow=df)
            if got.dtype != torch.bfloat16:
                raise AssertionError("K7 bf16: output is not bf16")
            gemm_held(f"K7 {df} bf16 {label}", got, ref.matmul(xb, wb),
                      GEMM_BF16_TOL)
        gemm_held(f"K8 bf16 {label}", qm.quant_matmul(xb, w_q, sc),
                  ref.quant_matmul(xb, w_q, sc), GEMM_BF16_TOL)
    log(f"  bf16 K7 (3 dataflows) and K8 held at {GEMM_BF16_TOL}")
    return errs


def gemm_bound(M, K, N, w_bytes=4, extra_ops=0) -> tuple:
    """Least time for one GEMM: x, w (and K8's scales) read once and the
    output written once at the HBM rate, against 2 M K N operations (plus
    ``extra_ops``) at the fp32 peak."""
    scales = 4 * N if w_bytes == 1 else 0
    nbytes = 4 * M * K + w_bytes * K * N + scales + 4 * M * N
    return roofline(nbytes, 2 * M * K * N + extra_ops)


def sum_bounds(bounds) -> tuple:
    """Sequential GEMMs: the sum of their bounds, named by what bounds
    most of that time."""
    total = sum(b for b, _ in bounds)
    by_bytes = sum(b for b, by in bounds if by == "bytes")
    return total, "bytes" if by_bytes >= total / 2 else "operations"


def phase2_gemm_full_width():
    """K7 in each dataflow and K8 timed at the 21 GEMMs of one batch-256
    ResNet20 forward (the largest of ``RESNET_BATCHES``), each summed over
    the 21: the kernel's and one ``torch.matmul``'s device time
    (``device_times``, TF32 off) and the plain version's between events,
    every launch after an L2 flush; and K7 and K8 at qwen2.5-32b's wo.
    K8's library call is ``torch.matmul`` on the weight dequantized
    beforehand; the dequantization is timed apart."""
    gen = torch.Generator(DEV).manual_seed(21)
    B = max(RESNET_BATCHES)
    shapes = resnet.conv_layer_shapes(RESNET, B)
    data = []
    for _, M, K, N in shapes:
        x = rand_on_card(gen, M, K)
        w, w_q, sc = resnet_weight(gen, K, N)
        data.append((x, w, w_q, sc, w_q.float() * sc[None, :]))
    k7 = {df: device_times([lambda x=x, w=w, df=df: mm.matmul(
        x, w, dataflow=df) for x, w, *_ in data], 10, GEMM_KERNEL)
        for df in DATAFLOWS}
    k8 = device_times([lambda x=x, q=q, sc=sc: qm.quant_matmul(x, q, sc)
                       for x, _, q, sc, _ in data], 10, GEMM_KERNEL)
    lib = device_times([lambda x=x, w=w: torch.matmul(x, w)
                        for x, w, *_ in data], 10)
    qlib = device_times([lambda x=x, d=d: torch.matmul(x, d)
                         for x, _, _, _, d in data], 10)
    dequant = device_times([lambda q=q, sc=sc: q.float() * sc[None, :]
                            for _, _, q, sc, _ in data], 10)
    plain = [time_ms(lambda x=x, w=w: ref.matmul(x, w), 10)
             for x, w, *_ in data]
    qplain = [time_ms(lambda x=x, q=q, sc=sc: ref.quant_matmul(x, q, sc), 10)
              for x, _, q, sc, _ in data]
    bounds = [gemm_bound(M, K, N) for _, M, K, N in shapes]
    qbounds = [gemm_bound(M, K, N, 1, K * N) for _, M, K, N in shapes]
    log(f"  per GEMM of a batch-{B} forward, device ms: "
        + " / ".join(DATAFLOWS) + " / quant_matmul | torch.matmul | bound")
    for i, (name, M, K, N) in enumerate(shapes):
        log(f"    {name} ({M}x{K}x{N}): "
            + " / ".join(f"{k7[df][i]:.4f}" for df in DATAFLOWS)
            + f" / {k8[i]:.4f} | {lib[i]:.4f} | {bounds[i][0]:.4f} "
            f"({bounds[i][1]})")
    rows = {df: dict(ms=sum(k7[df]), plain_ms=sum(plain),
                     library_ms=sum(lib)) for df in DATAFLOWS}
    rows["quant_matmul"] = dict(ms=sum(k8), plain_ms=sum(qplain),
                                library_ms=sum(qlib),
                                dequant_ms=sum(dequant))
    for key, bnd in [(df, bounds) for df in DATAFLOWS] + [("quant_matmul",
                                                           qbounds)]:
        rows[key]["bound_ms"], rows[key]["bound_by"] = sum_bounds(bnd)
        r = rows[key]
        log(f"  {key}, 21 GEMMs of a batch-{B} forward: kernel "
            f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | torch.matmul "
            f"{r['library_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | {r['ms'] / r['library_ms']:.2f}x the "
            f"library, {r['ms'] / r['bound_ms']:.2f}x the bound"
            + (f" | dequant alone {r['dequant_ms']:.4f} ms"
               if "dequant_ms" in r else ""))
    del data
    M, K, N = LM_PROJ
    x = rand_on_card(gen, M, K)
    w, w_q, sc = resnet_weight(gen, K, N)
    deq = w_q.float() * sc[None, :]
    ms, k7_ms = device_times([lambda: qm.quant_matmul(x, w_q, sc),
                              lambda: mm.matmul(x, deq)], 50, GEMM_KERNEL)
    lib, dq = device_times([lambda: torch.matmul(x, deq),
                            lambda: w_q.float() * sc[None, :]], 50)
    plain = time_ms(lambda: ref.quant_matmul(x, w_q, sc), 50)
    bms, by = gemm_bound(M, K, N, 1, K * N)
    log(f"  quant_matmul at qwen2.5-32b wo ({M}x{K}x{N}): kernel {ms:.4f} ms "
        f"| plain {plain:.4f} ms | torch.matmul on the dequantized weight "
        f"{lib:.4f} ms | dequant alone {dq:.4f} ms | bound {bms:.4f} ms "
        f"({by}) | K7 on the dequantized weight {k7_ms:.4f} ms (bound "
        f"{gemm_bound(M, K, N)[0]:.4f} ms)")
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------- phase 8: ResNet20
def fit_head(folded, n=4096):
    """Test data only: the head replaced by a ridge regression of one-hot
    labels on the pooled features of ``n`` synthetic training images
    (seed 1), so that predictions vary by image (an untrained network's
    logits are nearly the same for every image, and its top-1 agreements
    would say nothing). The features are the forward's output under an
    identity head."""
    width = folded["head"]["w"].shape[0]
    probe = dict(folded, head={"w": torch.eye(width, device=DEV),
                               "b": torch.zeros(width, device=DEV)})
    xs, ys = synthetic_cifar(n, seed=1)
    feats = torch.cat([resnet.forward(
        probe, RESNET, torch.from_numpy(xs[i:i + 1024]).to(DEV), folded=True)
        for i in range(0, n, 1024)])
    mu, sd = feats.mean(0), feats.std(0) + 1e-6
    z = (feats - mu) / sd
    y = F.one_hot(torch.from_numpy(ys).long().to(DEV),
                  RESNET.num_classes).float()
    w = torch.linalg.solve(z.T @ z + 1e-3 * n * torch.eye(width, device=DEV),
                           z.T @ (y - y.mean(0)))
    folded["head"] = {"w": w / sd[:, None], "b": -(mu / sd) @ w}
    return folded


def resnet_params(seed):
    """ResNet20 from ``resnet.init`` with a seeded generator on the card,
    BN running stats and affine terms drawn from the same generator
    (mean != 0, var != 1, scale != 1) so that folding is not the identity,
    and a fitted head (:func:`fit_head`); returns the folded params."""
    gen = torch.Generator(DEV).manual_seed(seed)
    params = resnet.init(RESNET, gen, DEV)
    convs = [params["stem"]] + [blk[k] for blocks in params["stages"]
                                for blk in blocks for k in blk]
    for cb in convs:
        c = cb["w"].shape[-1]
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
            c, generator=gen, device=DEV)
        cb["bn"] = {"scale": u(0.5, 1.5), "var": u(0.5, 2.0),
                    "bias": 0.1 * rand_on_card(gen, c),
                    "mean": 0.1 * rand_on_card(gen, c)}
    return fit_head(resnet.fold_bn(params))


def resnet_paths():
    """Phase 8's routes: ``lax`` (cuDNN, the oracle), im2col with the plain
    ``@``, im2col through K7 in each dataflow."""
    paths = {"lax": dict(impl="lax"), "im2col @": dict(impl="im2col")}
    for df in DATAFLOWS:
        paths[f"K7 {df}"] = dict(impl="im2col", matmul_fn=lambda a, b, d=df:
                                 ops.matmul(a, b, dataflow=d))
    return paths


def logits_held(name, got, want, tol=GEMM_TOL):
    """Logits of two routes: finite, allclose within ``tol`` of the largest
    logit, and the same top-1 wherever ``want``'s two best logits are more
    than that apart. Returns (max |diff|, near ties)."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite logits")
    atol = tol * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=atol):
        raise AssertionError(f"{name}: logits differ by {err}")
    top2 = want.topk(2, dim=-1).values
    decided = top2[:, 0] - top2[:, 1] > atol
    if not torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided]):
        raise AssertionError(f"{name}: top-1 differs")
    return err, int((~decided).sum())


def power_rate(fn, images_per_call, seconds=1.5):
    """Run ``fn`` back to back for ``seconds`` while ``nvidia-smi`` samples
    power.draw every 100 ms; returns (images/s on the host clock, mean W)
    or None for the power if no sample came back."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        fn()
        torch.cuda.synchronize()
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(4):
                fn()
            n += 4
            torch.cuda.synchronize()
        rate = n * images_per_call / (time.perf_counter() - t0)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    watts = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    return rate, (sum(watts) / len(watts) if watts else None)


def forward_breakdown(fn, iters: int = 5) -> dict:
    """Device time of one ResNet20 forward by kind of work, in ms: the
    port's GEMMs (kernels named ``GEMM_KERNEL``), im2col (the pad's fill
    and copy, the concatenation of the shifted views) and the rest (the
    folded BN's bias, ReLU, residual adds, pooling, the head, and cuDNN's
    or cuBLAS's kernels on the library routes); with the port's GEMM
    launches per forward."""
    parts = dict(gemm=0.0, im2col=0.0, rest=0.0, gemm_launches=0)
    calls = profiled_calls(fn, iters)
    for name, us in (e for c in calls for e in c):
        if GEMM_KERNEL in name:
            part = "gemm"
            parts["gemm_launches"] += 1
        elif "CatArray" in name or "copy" in name.lower() or "Fill" in name:
            part = "im2col"
        else:
            part = "rest"
        parts[part] += us / len(calls) / 1e3
    parts["gemm_launches"] //= len(calls)
    parts["busy"] = parts["gemm"] + parts["im2col"] + parts["rest"]
    return parts


def phase8_resnet(card):
    """ResNet20 at the paper's widths (16 / 32 / 64, 3x3 blocks, 32x32x3,
    10 classes), folded, on synthetic CIFAR images: lax, im2col with the
    plain ``@`` and im2col through K7 in each dataflow, at batch 1 and
    256. Logits against lax; K7 launched once per conv GEMM; the three
    dataflows give the same bits. Then ms per forward, FPS and GOP/s for
    each route (and GOP/s per W at batch 256 where the power can be read),
    and at batch 256 the device time of a forward of lax, im2col with
    ``@`` and K7 (output-stationary) split by ``forward_breakdown``.
    Returns K7's launches per dataflow and the timings."""
    folded = resnet_params(30)
    images = torch.from_numpy(synthetic_cifar(max(RESNET_BATCHES),
                                              seed=3)[0]).to(DEV)
    flops = sum(2 * m * k * n for _, m, k, n in
                resnet.conv_layer_shapes(RESNET, 1))
    paths = resnet_paths()
    launches = {df: 0 for df in DATAFLOWS}
    timings = {}
    for B in RESNET_BATCHES:
        x = images[:B]
        fwd = {name: (lambda kw=kw: resnet.forward(
            folded, RESNET, x, folded=True, **kw)) for name, kw in
            paths.items()}
        logits = {}
        for name, fn in fwd.items():
            mm.reset_launches()
            qm.reset_launches()
            logits[name] = fn()
            torch.cuda.synchronize()
            want = {df: int(name == f"K7 {df}") * 21 for df in DATAFLOWS}
            if mm.LAUNCHES != want or qm.LAUNCHES["quant_matmul"]:
                raise AssertionError(f"B={B} {name}: launches {mm.LAUNCHES},"
                                     f" {qm.LAUNCHES}; want {want}")
            for df in DATAFLOWS:
                launches[df] += mm.LAUNCHES[df]
        if tuple(logits["lax"].shape) != (B, RESNET.num_classes):
            raise AssertionError(f"logits shape {tuple(logits['lax'].shape)}")
        for name in list(paths)[1:]:
            err, ties = logits_held(f"B={B} {name}", logits[name],
                                    logits["lax"])
            log(f"  B={B} {name} vs lax: max abs diff {err:.3e}, top-1 "
                f"equal ({ties} near ties undecided)")
        k7 = [logits[f"K7 {df}"] for df in DATAFLOWS]
        if not all(torch.equal(k7[0], o) for o in k7[1:]):
            raise AssertionError(f"B={B}: K7 dataflows differ in bits")
        log(f"  B={B}: K7's 21 launches per forward in each dataflow; the "
            f"three dataflows' logits bit-equal")
        for name, fn in fwd.items():
            ms = time_ms(fn, 20 if B == 1 else 10)
            row = dict(ms=ms, fps=B * 1e3 / ms,
                       gops=flops * B / (ms * 1e-3) / 1e9)
            if B == max(RESNET_BATCHES):
                rate, watts = power_rate(fn, B)
                if watts:
                    row.update(loop_gops=flops * rate / 1e9, watts=watts,
                               gops_per_w=flops * rate / 1e9 / watts)
            timings[(B, name)] = row
            log(f"  B={B} {name}: {ms:.4f} ms per forward, {row['fps']:.1f} "
                f"FPS, {row['gops']:.1f} GOP/s"
                + (f" | back to back {row['loop_gops']:.1f} GOP/s at "
                   f"{row['watts']:.1f} W: {row['gops_per_w']:.2f} GOP/s/W"
                   if "watts" in row else "") + f" ({card})")
    B = max(RESNET_BATCHES)
    x = images[:B]
    for name in ("lax", "im2col @", "K7 output_stationary"):
        parts = forward_breakdown(lambda kw=paths[name]: resnet.forward(
            folded, RESNET, x, folded=True, **kw))
        timings[(B, name)]["breakdown"] = parts
        log(f"  B={B} {name}, device time of a forward: busy "
            f"{parts['busy']:.4f} ms of {timings[(B, name)]['ms']:.4f} ms "
            f"between events | port GEMMs {parts['gemm']:.4f} ms "
            f"({parts['gemm_launches']} launches) | im2col "
            f"{parts['im2col']:.4f} ms | rest {parts['rest']:.4f} ms")
    log(f"  {flops / 1e6:.3f} MFLOP per image (2 M K N over the 21 conv "
        f"GEMMs)")
    del images, folded
    torch.cuda.empty_cache()
    return launches, timings


def int8_matmul_fn(qparams, deq):
    """A ``matmul_fn`` that runs each conv GEMM through K8 on the int8
    weights: the forward hands it the dequantized weight (a view of one
    leaf of ``deq``), which names its int8 tensor and scales."""
    table = {}

    def walk(q, d):
        if isinstance(q, QuantizedTensor):
            if q.q.dim() == 4:
                n = q.q.shape[-1]
                table[d.data_ptr()] = (q.q.reshape(-1, n), q.scale.reshape(n))
        elif isinstance(q, dict):
            for k in q:
                walk(q[k], d[k])
        elif isinstance(q, list):
            for a, b in zip(q, d):
                walk(a, b)
    walk(qparams, deq)

    def fn(lhs, wm):
        w_q, sc = table[wm.data_ptr()]
        return ops.quant_matmul(lhs, w_q, sc)
    return fn, len(table)


def phase8b_ptq(card):
    """The paper's quantization ladder on the 10,000-image synthetic test
    set, in batches of 1,000, every conv through K7 (output-stationary):
    fp32 against 16-bit fixed point and against int8 PTQ dequantized to
    f32 (top-1 agreement, max |dlogit|); then the int8 forward with every
    conv GEMM through K8 on the int8 weights, held against the
    dequant-on-load forward, K8 launched 21 times per forward. Returns
    K8's launches."""
    folded = resnet_params(30)
    xs, ys = synthetic_cifar(PTQ_IMAGES, seed=2)
    k7 = lambda a, b: ops.matmul(a, b)  # noqa: E731
    qparams = quantize_params(folded)
    trees = {"fp32": folded, "fixed16": fixed_point_tree(folded),
             "int8": dequantize_params(qparams, torch.float32)}
    k8_fn, n_convs = int8_matmul_fn(qparams, trees["int8"])
    if n_convs != 21:
        raise AssertionError(f"{n_convs} int8 conv weights, not 21")
    logits = {name: [] for name in list(trees) + ["int8 K8"]}
    mm.reset_launches()
    qm.reset_launches()
    batches = range(0, PTQ_IMAGES, PTQ_BATCH)
    for i in batches:
        x = torch.from_numpy(xs[i:i + PTQ_BATCH]).to(DEV)
        for name, tree in trees.items():
            logits[name].append(resnet.forward(tree, RESNET, x, folded=True,
                                               impl="im2col", matmul_fn=k7))
        logits["int8 K8"].append(resnet.forward(
            trees["int8"], RESNET, x, folded=True, impl="im2col",
            matmul_fn=k8_fn))
    torch.cuda.synchronize()
    launches = qm.LAUNCHES["quant_matmul"]
    if launches != 21 * len(batches) or mm.LAUNCHES[
            "output_stationary"] != 3 * 21 * len(batches):
        raise AssertionError(f"K8 launches {launches}, K7 {mm.LAUNCHES} for "
                             f"{len(batches)} batches")
    logits = {k: torch.cat(v) for k, v in logits.items()}
    labels = torch.from_numpy(ys).to(DEV)
    ref_top = logits["fp32"].argmax(-1)
    for name in ("fp32", "fixed16", "int8"):
        lg = logits[name]
        log(f"  {name}: accuracy on the synthetic labels "
            f"{(lg.argmax(-1) == labels).float().mean().item():.4f}, top-1 "
            f"agreement with fp32 {(lg.argmax(-1) == ref_top).float().mean().item():.4f}"
            f", max |dlogit| {(lg - logits['fp32']).abs().max().item():.4e}")
    err, ties = logits_held("int8 K8 vs dequant-on-load K7",
                            logits["int8 K8"], logits["int8"])
    same = torch.equal(logits["int8 K8"], logits["int8"])
    log(f"  int8 through K8 ({launches} launches = 21 x {len(batches)} "
        f"batches) vs dequant-on-load K7: max abs diff {err:.3e}, "
        f"{'bit-equal' if same else 'not bit-equal'}, top-1 equal ({ties} "
        f"near ties undecided)")
    x = torch.from_numpy(xs[:PTQ_BATCH]).to(DEV)
    for name, fn in (("int8 K8", k8_fn), ("dequant-on-load K7", k7)):
        ms = time_ms(lambda: resnet.forward(trees["int8"], RESNET, x,
                                            folded=True, impl="im2col",
                                            matmul_fn=fn), 5)
        log(f"  {name}: {ms:.4f} ms per {PTQ_BATCH}-image forward, "
            f"{PTQ_BATCH * 1e3 / ms:.1f} FPS ({card})")
    del logits, trees, qparams, folded
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- phases 9, 10: recurrent
def build_recurrent(arch, layers, s_max):
    """``ServeEngine.build`` of a recurrent arch at full width on the dense
    cache (8 slots, chunk 64), its weights perturbed
    (``perturb_recurrent``)."""
    t0 = time.perf_counter()
    engine = ServeEngine.build(arch, config=ServeConfig(
        reduced=False, cfg_overrides={"num_layers": layers}, s_max=s_max,
        batch_slots=SLOTS))
    perturb_recurrent(engine.params, arch, 9)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(engine.params))
    log(f"  {arch} x {layers} layers: {n / 1e9:.3f} B params, "
        f"{4 * n / 1e9:.2f} GB fp32; engine built in "
        f"{time.perf_counter() - t0:.2f} s")
    return engine


def cut_depth(model, layers):
    """``model`` run on the first ``layers`` layers of its weights (the
    layer loops and caches follow ``cfg.num_layers``)."""
    return dataclasses.replace(model, cfg=dataclasses.replace(
        model.cfg, num_layers=layers))


def recurrent_forward(model, params):
    """The full-sequence forward on (2, 512) tokens through the scan kernel
    and K2 ('pallas' for both: one launch of each per layer; rwkv has no
    attention) against the plain recurrence and the einsum attention;
    logits held by ``logits_held`` at RECURRENT_TOL. Returns the (scan,
    K2) launches."""
    cfg = model.cfg
    kernel = scan_kernel(cfg.name)
    flash = cfg.num_layers if cfg.name == HYMBA else 0
    B, S = FORWARD_BATCH
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(DEV)

    def logits_of(scan_impl, attn_impl):
        t0 = time.perf_counter()
        lg, _ = model.forward(params, toks, scan_impl=scan_impl,
                              attn_impl=attn_impl)
        torch.cuda.synchronize()
        log(f"  forward scan_impl={scan_impl} attn_impl={attn_impl} "
            f"(B={B}, S={S}, {cfg.num_layers} layers): "
            f"{time.perf_counter() - t0:.3f} s (host clock)")
        return lg[..., :cfg.vocab_size].reshape(B * S, -1)

    ls.reset_launches()
    fa.reset_launches()
    got = logits_of("pallas", "pallas")
    if ls.LAUNCHES[kernel] != cfg.num_layers or sum(
            ls.LAUNCHES.values()) != cfg.num_layers or fa.LAUNCHES != {
                "prefill": 0, "forward": flash}:
        raise AssertionError(f"forward: {ls.LAUNCHES}, {fa.LAUNCHES}; want "
                             f"{cfg.num_layers} {kernel} and {flash} K2 "
                             f"forward launches")
    want = logits_of("scan", "einsum")
    err, ties = logits_held(f"{cfg.name} forward logits", got, want,
                            RECURRENT_TOL)
    log(f"  forward logits kernel vs plain max |diff| {err:.3e} (largest "
        f"{want.abs().max().item():.3e}, tol {RECURRENT_TOL} of it); top-1 "
        f"equal ({ties} near ties); {cfg.num_layers} {kernel} and {flash} "
        f"K2 launches")
    del got, want
    torch.cuda.empty_cache()
    return cfg.num_layers, flash


def recurrent_steps(model, params, s_max, leaves):
    """One 64-token prefill chunk for 8 slots on a fresh cache, then 8
    greedy decode steps, each run feeding back its own greedy tokens,
    through ``scan_impl='auto'`` (the kernel, 9 launches per layer) and
    'scan' (the plain recurrence): logits held by ``logits_held`` and the
    float cache ``leaves`` within RECURRENT_TOL of their largest
    magnitude, greedy tokens and integer leaves (ring positions) equal."""
    cfg = model.cfg
    kernel = scan_kernel(cfg.name)
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, 64))
                            ).to(DEV)

    def run(impl):
        cache = model.init_cache(SLOTS, s_max, torch.float32, DEV)
        t0 = time.perf_counter()
        logits, cache = model.prefill_chunk(params, toks, cache, first=True,
                                            scan_impl=impl)
        seq, tok = [logits], logits[:, :, :cfg.vocab_size].argmax(-1)
        tokens = [tok]
        for _ in range(8):
            logits, cache = model.decode_step(params, tok, cache,
                                              scan_impl=impl)
            tok = logits[:, :, :cfg.vocab_size].argmax(-1)
            seq.append(logits)
            tokens.append(tok)
        torch.cuda.synchronize()
        log(f"  scan_impl={impl}: prefill chunk + 8 decode steps "
            f"({cfg.num_layers} layers) in {time.perf_counter() - t0:.3f} s "
            f"(host clock)")
        return (torch.cat(seq, 1)[..., :cfg.vocab_size].reshape(
            -1, cfg.vocab_size), torch.cat(tokens, 1), cache)

    ls.reset_launches()
    got = run("auto")
    if ls.LAUNCHES[kernel] != 9 * cfg.num_layers or sum(
            ls.LAUNCHES.values()) != 9 * cfg.num_layers:
        raise AssertionError(f"steps: {ls.LAUNCHES}, want "
                             f"{9 * cfg.num_layers} {kernel} launches")
    want = run("scan")
    err, _ = logits_held(f"{cfg.name} step logits", got[0], want[0],
                         RECURRENT_TOL)
    if not torch.equal(got[1], want[1]):
        raise AssertionError("kernel and plain greedy tokens differ")
    log(f"  step logits kernel vs plain max |diff| {err:.3e}; greedy tokens "
        f"(8 slots x 9 steps) equal")
    for key in leaves:
        a, b = got[2][key], want[2][key]
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"final {key} differs")
            continue
        scale = max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        if not (torch.isfinite(a).all() and torch.allclose(
                a, b, rtol=RECURRENT_TOL, atol=RECURRENT_TOL * scale)):
            raise AssertionError(f"final {key} differs by {err} of {scale}")
        log(f"  final {key}: max |diff| {err:.3e} (largest {scale:.3e})")
    del got, want
    torch.cuda.empty_cache()


def host_and_device(fn, label, card) -> dict:
    """Where one call of ``fn`` spends its time: the host wall clock (mean
    of 3 synchronised calls), the device's busy time in one call (the sum
    of its kernels' times under ``torch.profiler``), the share of the wall
    the device sat idle, and the kernel launches the call made; returned
    as {wall_ms, busy_ms, idle, launches}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    log(f"  {label}: {wall_ms:.2f} ms host wall, device busy {busy_ms:.4f} "
        f"ms (idle {1 - busy_ms / wall_ms:.1%}), {launches} kernel launches "
        f"({card})")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle=1 - busy_ms / wall_ms, launches=launches)


def tick_and_chunk(engine, prompt, card, label) -> dict:
    """``host_and_device`` of one decode tick of an idle engine (every slot
    parked: a tick runs every op of a live one, and its writes drop) and of
    one 64-token first chunk of ``prompt`` (one request, B = 1)."""
    tok = torch.zeros((engine.batch_slots, 1), dtype=torch.long, device=DEV)
    tick = host_and_device(
        lambda: engine._decode(engine.params, engine.cache, {"token": tok}),
        f"{label}: one decode tick ({engine.batch_slots} slots)", card)
    chunk = torch.from_numpy(prompt[:64]).long()[None].to(DEV)
    first = host_and_device(
        lambda: engine._chunk_first(engine.params, {"tokens": chunk}),
        f"{label}: one 64-token first chunk", card)
    return {"tick": tick, "chunk": first}


def scan_shapes_of(fn, hist):
    """``fn`` (``ls.wkv6`` or ``ls.selective_scan``) that also counts the
    (B, T) of each call in ``hist``."""
    def counted(*args, **kwargs):
        key = tuple(args[0].shape[:2])
        hist[key] = hist.get(key, 0) + 1
        return fn(*args, **kwargs)
    return counted


def serve_recurrent(engine, prompts, card, label):
    """Serve ``prompts`` (32 tokens each) with the launch counts set to 0
    just before and read just after: the scan kernel once per layer per
    prefill chunk and per decode tick, K2 once per layer per first chunk
    (hymba; rwkv has no attention), no other kernel; the (B, T) of every
    scan launch is counted and printed. Returns (requests, first-token
    logits, scan launches {"chunk": prefill chunks', "tick": decode
    ticks'}, K2 launches)."""
    cfg = engine.cfg
    kernel = scan_kernel(cfg.name)
    n_first = [0]
    first = engine._chunk_first

    def counted(*args):
        n_first[0] += 1
        return first(*args)

    hist = {}
    scan = getattr(ls, kernel)
    engine._chunk_first = counted
    setattr(ls, kernel, scan_shapes_of(scan, hist))
    ls.reset_launches()
    fa.reset_launches()
    pa.reset_launches()
    try:
        reqs, m, firsts = serve(engine, prompts)
    finally:
        engine._chunk_first = first
        setattr(ls, kernel, scan)
    layers = cfg.num_layers
    want = layers * (m["prefill_chunks"] + m["decode_steps"])
    flash = layers * n_first[0] if cfg.name == HYMBA else 0
    if (ls.LAUNCHES[kernel] != want or sum(ls.LAUNCHES.values()) != want
            or fa.LAUNCHES != {"prefill": flash, "forward": 0}
            or sum(pa.LAUNCHES.values())):
        raise AssertionError(f"{label}: {ls.LAUNCHES}, {fa.LAUNCHES}, "
                             f"{pa.LAUNCHES}; want {want} {kernel} and "
                             f"{flash} K2 prefill launches")
    if engine.paged:
        engine.assert_page_invariants()
    log(f"  {label}: paged {engine.paged}, prefix cache "
        f"{engine.prefix_cache}, resident cache "
        f"{engine.resident_cache_bytes()} bytes")
    log_serving(m, card)
    log(f"  {kernel} launches {want} (({m['prefill_chunks']} chunks + "
        f"{m['decode_steps']} ticks) x {layers} layers)" + (
            f"; K2 prefill launches {flash} ({n_first[0]} first chunks x "
            f"{layers} layers)" if flash else ""))
    if sum(hist.values()) != want:
        raise AssertionError(f"{label}: {sum(hist.values())} {kernel} calls "
                             f"counted by shape, {want} launches")
    log(f"  {kernel} launches by (B, T): " + ", ".join(
        f"{key}: {n}" for key, n in sorted(hist.items(),
                                           key=lambda kv: -kv[1])))
    tick_and_chunk(engine, prompts[0], card, label)
    return reqs, firsts, {"chunk": layers * m["prefill_chunks"],
                          "tick": layers * m["decode_steps"]}, flash


def phase9_rwkv(card):
    """rwkv6-7b at full width: the forward and the step path through K5
    against the plain recurrence on the first CHECK_LAYERS layers, then
    the 16 requests at full depth on the dense cache (rwkv has nothing to
    page), every recurrence through K5. Returns K5's launches by path
    (forward, chunk, tick)."""
    engine = build_recurrent(RWKV, RWKV_LAYERS, S_MAX)
    model, params = engine.model, engine.params
    check = cut_depth(model, CHECK_LAYERS[RWKV])
    forward, _ = recurrent_forward(check, params)
    recurrent_steps(check, params, S_MAX, ("S", "x_tm", "x_cm"))
    prompts = serve_prompts(engine.cfg.vocab_size)
    _, _, serving, _ = serve_recurrent(engine, prompts, card,
                                       "rwkv6 dense serving")
    del engine, model, params
    torch.cuda.empty_cache()
    return dict(serving, forward=forward)


def long_prompts(vocab):
    """4 prompts of 1,100-1,500 tokens: longer than hymba's 1024-row ring,
    which they wrap."""
    rng = np.random.default_rng(12)
    return [rng.integers(0, vocab, int(rng.integers(1100, 1501)))
            for _ in range(4)]


def phase10_hymba(card):
    """hymba-1.5b at full width and depth: the forward and the step path
    through K6 against the plain recurrence, then the 16 requests plus 4
    ring-wrapping ones on the dense ring and on the paged ring (pages of
    16 rows), every selective scan through K6 and every first chunk's
    attention through K2; the two caches' streams equal. Returns K6's
    launches by path (forward, chunk, tick: the two engines' sum) and K2's
    (forward, first chunks of both engines)."""
    engine = build_recurrent(HYMBA, HYMBA_LAYERS, HYMBA_S_MAX)
    model, params = engine.model, engine.params
    check = cut_depth(model, CHECK_LAYERS[HYMBA])
    forward, flash_forward = recurrent_forward(check, params)
    recurrent_steps(check, params, HYMBA_S_MAX,
                    ("k", "v", "slot_pos", "h", "conv"))
    prompts = serve_prompts(engine.cfg.vocab_size) + long_prompts(
        engine.cfg.vocab_size)
    d_reqs, d_firsts, dense, d_flash = serve_recurrent(
        engine, prompts, card, "hymba dense ring")
    del engine
    torch.cuda.empty_cache()
    # as many pages as the dense rings hold: 8 slots x 1024 rows
    paged = ServeEngine(model, params, **ServeConfig(
        reduced=False, page_size=PS, s_max=HYMBA_S_MAX, batch_slots=SLOTS,
        num_pages=SLOTS * model.cfg.window // PS).engine_kwargs())
    if paged.capacity != model.cfg.window:
        raise AssertionError(f"paged ring capacity {paged.capacity}")
    p_reqs, p_firsts, paged_n, p_flash = serve_recurrent(
        paged, prompts, card, "hymba paged ring")
    same = [a.tokens == b.tokens for a, b in zip(d_reqs, p_reqs)]
    if not all(same):
        compare_streams("dense ring", (d_reqs, d_firsts), "paged ring",
                        (p_reqs, p_firsts))
        raise AssertionError(f"dense and paged ring streams differ for "
                             f"{same.count(False)} requests")
    log(f"  dense ring vs paged ring: all {len(same)} streams equal")
    del paged, model, params
    torch.cuda.empty_cache()
    return ({"forward": forward, "chunk": dense["chunk"] + paged_n["chunk"],
             "tick": dense["tick"] + paged_n["tick"]},
            {"forward": flash_forward, "prefill": d_flash + p_flash})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 1: card and build")
    card = card_name()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    took = _build.build(["paged_attention", "paged_attention_latent",
                         "flash_attention", "matmul", "linear_scan"])
    log(f"  built {sorted(took) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels against their plain versions")
    errs = phase2_cases()
    full = phase2_full_width()
    errs.update(phase2_q8_cases())
    full.update(phase2_q8_full_width())
    errs.update(phase2_latent_cases())
    full.update(phase2_latent_full_width())
    flash_errs = phase2_flash_cases()
    flash_full = phase2_flash_full_width()
    gemm_errs = phase2_gemm_cases()
    gemm_full = phase2_gemm_full_width()
    scan_errs = phase2_scan_cases()
    scan_full = phase2_scan_full_width()

    t0 = time.perf_counter()
    dense = ServeEngine.build(ARCH, config=ServeConfig(
        reduced=False, cfg_overrides={"num_layers": LAYERS}, s_max=S_MAX,
        batch_slots=SLOTS))
    torch.cuda.synchronize()
    log(f"main path engine built in {time.perf_counter() - t0:.2f} s "
        f"(dense cache, weights shared by phases 3-5)")
    model, params = dense.model, dense.params
    log("phase 3: full width, 4 layers, paged kernel vs einsum")
    phase3_model(model, params)
    log("phase 3b: full width, 4 layers, flash kernel vs einsum")
    forward_launches = phase3b_flash_model(model, params)
    log("phase 3c: full width, 4 layers, int8 pages, K3 vs q8 einsum")
    phase3_model(model, params, PagedInt8Backend(PS, SLOTS * S_MAX // PS),
                 "int8 pages", Q8_MODEL_TOL)
    prompts = serve_prompts(dense.cfg.vocab_size)
    log("phase 4: paged serving")
    launches, p_reqs, p_firsts, p_bytes, p_m = phase4_serve(
        model, params, prompts, card)
    log("phase 4b: int8 pages serving")
    q8_launches, _ = phase4b_serve_int8(model, params, prompts, card,
                                        (p_reqs, p_firsts, p_bytes))
    log("phase 5: ServeEngine main path (dense cache)")
    flash_launches = phase5_serve_dense(dense, prompts, card,
                                        (p_reqs, p_firsts))
    flash_launches["forward"] = forward_launches
    log("phase 11: sampling, scheduling policy, router, cancellation and "
        "the CLIs on fp32 pages (full width, 4 layers)")
    phase11(model, params, prompts, card, (p_reqs, p_firsts, p_m))
    del dense, model, params
    torch.cuda.empty_cache()
    log("phase 6: prefill anchors at reduced width")
    phase6_anchors()
    log("phase 7: qwen2.5-32b-mla at full width, 4 layers")
    latent_launches, _ = phase7_mla(card)
    log("phase 8: ResNet20 / CIFAR at the paper's widths, lax vs im2col "
        "vs K7")
    gemm_launches, _ = phase8_resnet(card)
    log("phase 8b: int8 PTQ over 10,000 synthetic images, K8")
    gemm_launches["quant_matmul"] = phase8b_ptq(card)
    log(f"phase 9: {RWKV} at full width, {RWKV_LAYERS} layers (compared "
        f"on {CHECK_LAYERS[RWKV]}), K5")
    scan_launches = {"wkv6": phase9_rwkv(card)}
    log(f"phase 10: {HYMBA} at full width, {HYMBA_LAYERS} layers, K6")
    scan_launches["selective_scan"], hymba_flash = phase10_hymba(card)
    flash_launches["prefill_hymba"] = hymba_flash["prefill"]
    flash_launches["forward_hymba"] = hymba_flash["forward"]

    kernels = []
    paged_rows = (("", "paged_attention.cu", 52, launches),
                  ("_q8", "paged_attention.cu", 112, q8_launches),
                  ("_latent", "paged_attention_latent.cu", 168,
                   latent_launches))
    for suffix, source, line, counts in paged_rows:
        for kind in ("decode", "prefill"):
            f = full[kind + suffix]
            kernels.append({
                "name": f"paged_attention{suffix}[{kind}]", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": f"src/repro/kernels/paged_attention.py:{line}",
                "launches": counts[kind],
                "max_abs_err": max(errs[kind + suffix], f["err"]),
                "ms": f["ms"], "plain_ms": f["plain_ms"],
                "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                "library_ms": f["library_ms"]})
    for kind in FLASH_SHAPES:
        f = flash_full[kind]
        kernels.append({
            "name": f"flash_attention[{kind}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:26",
            "launches": flash_launches[kind],
            "max_abs_err": max(flash_errs[kind.split("_")[0]], f["err"]),
            "ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": f["library_ms"]})
    for key in DATAFLOWS + ("quant_matmul",):
        f = gemm_full[key]
        k7 = key in DATAFLOWS
        kernels.append({
            "name": f"matmul[{key}]" if k7 else "quant_matmul[resnet20 int8]",
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
            "replaces": ("src/repro/kernels/matmul.py:"
                         + ("29" if key == "output_stationary" else "46"))
            if k7 else "src/repro/kernels/quant_matmul.py:16",
            "launches": gemm_launches[key], "max_abs_err": gemm_errs[key],
            "ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": f["library_ms"]})
    for name, line in (("wkv6", 30), ("selective_scan", 105)):
        counts = scan_launches[name]
        # serving's launches by path: decode ticks, timed at 8 slots, and
        # prefill chunks, timed at one request's 64 tokens (the most
        # frequent chunk, phases 9 and 10's histograms)
        timed = {"forward": "forward", "tick": "decode",
                 "chunk": "prefill_b1"}
        err = max([scan_errs[name]] + [
            scan_full[(name, k)]["err"] for k in SCAN_SHAPES])
        for kind, shape in timed.items():
            f = scan_full[(name, shape)]
            kernels.append({
                "name": f"{name}[{kind}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
                "replaces": f"src/repro/kernels/linear_scan.py:{line}",
                "launches": counts[kind], "max_abs_err": err,
                "ms": f["ms"], "plain_ms": f["plain_ms"],
                "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
