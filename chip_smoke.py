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
   give it (qwen2.5-32b, qwen2.5-32b-mla; K1 also at dbrx-132b's decode
   and prefill shapes, 48 heads over 8, and at whisper-large-v3's, 20 over
   20 at head_dim 64; K2 also at hymba-1.5b's first chunk and forward, at
   the first chunks of dbrx's dense cache and whisper's decoder, causal,
   and at whisper's encoder, B 2 x 1500 frames, not causal), with the
   kernel's, the plain version's and one library call's times and the
   bound (K1's, K3's and K4's decode time
   is their two launches, the split over keys and the merge, summed). The
   systolic GEMM (K7) in its three dataflows and the int8-weight GEMM (K8)
   on the CPU tests' shapes, a K of 5120 (several K-chunks), ResNet20's 21
   im2col GEMMs at batch 1 and 256 (K8 on per-channel int8 weights),
   qwen2.5-32b's wo at M = 8, the 41 gradient GEMMs of phase 16's step on
   the backward's transposed views (dW through the split schedule, dX
   wider than 64 columns through the wide one: the dataflows, a second
   launch and K8 on the dequantized operand all bit-equal) and bf16 cases; then both timed over
   the 21 GEMMs of a batch-256 forward, and at wo, and K7 at the gradient
   GEMMs of phase 16's training step (16e: a split GEMM's two launches
   counted and summed, each GEMM's schedule logged). Every kernel's time
   and every library call's is its device time under ``torch.profiler``
   (``device_times``; where six sessions in a row come back without
   their events, between CUDA events behind a sleep queued on the card,
   logged, and counted at the end); the plain versions' are between CUDA
   events. The
   wkv6 scan (K5) and the selective scan (K6) on the CPU tests' cases
   (strong decay, T = 33 with chunk 16, T = 1), then at rwkv6-7b's and
   hymba-1.5b's widths for the forward (B=4, T=1024), a decode tick and a
   64-token prefill chunk of 8 slots and of one request (the shape of most
   serving chunks; there other staging depths must give equal bits) and a
   tick of one request, timed beside their bounds. Then the bf16 entries
   (``phase2_bf16_cases``): K1 at every ``SPLIT_EDGES`` case with bf16 q
   over bf16 pools, over fp32 pools and fp32 q over bf16 pools, K3 with
   bf16 q over int8 pools, K4 at its latent widths for each pair, K2 with
   q, k, v in bf16, each within one bf16 step of its plain version's
   element; and timed at the full-width shapes of their fp32 rows (bytes
   at bf16 width in the bound, SDPA on the same bf16 tensors).
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
   attention through K3, tokens against phase 4's reported. (18, run
   right after phase 11 on the same weights) bf16 serving:
   ``compute_dtype=bfloat16`` with the cache in bf16: (a) the model step
   on bf16 pages, fp32 pages and int8 pages, kernel against einsum in
   lockstep (both take the einsum's greedy tokens; logits within
   ``BF16_MODEL_TOL``, tokens equal where the top-2 gap exceeds it); (d)
   the bf16 forward through K2 against the einsum; (b) the 16 requests on
   bf16 pages (K1), int8 pages (K3) and the dense cache (K2's first
   chunks), each bf16 entry launched layers x ticks and chunks, ITL p50 /
   p99 and an idle tick's idle share beside phase 4's fp32 figures; (c) a
   tick with every slot freed gives finite logits.
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
   streams compared; then its bf16 leg: the model step on bf16 latent
   pages (K4 against the latent einsum in lockstep) and the 16 requests
   on bf16 latent pages through K4's bf16 entry.
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
9. rwkv6-7b at full width, 8 of its 32 layers (cut from full depth so
   that phases 20-24 fit the script's time): the
   forward on (2, 512) tokens through K5 against the plain recurrence,
   one prefill chunk plus 8 decode steps through K5 ('auto') against
   'scan' (logits, state leaves, greedy tokens), then the 16 requests of
   phases 4-5 on the dense cache (rwkv has nothing to page), K5 launched
   once per layer per chunk and per tick (the (B, T, H) of every launch
   counted and printed).
10. hymba-1.5b at full width, 4 of its 32 layers (cut from full depth,
   as phase 9): the same
   forward and step comparisons through K6, then the 16 requests plus 4
   of 1,100-1,500 tokens (s_max 2048, so the 1024-row ring wraps) on the
   dense ring and on the paged ring (pages of 16 rows), every selective
   scan through K6 (its launches by (B, T, D) printed) and every first
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

12-15. the other families at full width, each after the earlier weights
   are freed, with every cut of depth in its log line: (12) command-r-35b
   (LayerNorm), 4 of 40 layers (28.1 GB); (13) dbrx-132b (16 experts,
   top 4, GShard capacity), 2 of 40 layers (31.0 GB); (14)
   llama-3.2-vision-11b, 10 of 40 layers (2 super-layers of 5 blocks and a
   gated cross block over 1601 image tokens; 13.3 GB); (15)
   whisper-large-v3 whole (32 encoder and 32 decoder layers, 6.2 GB).
   Each: a model step (a paged 64-token chunk for 8 slots and 8 decode
   steps) through K1 and through the einsum, logits within MODEL_TOL and
   greedy tokens equal; for whisper the transient first chunk (one encoder
   pass) runs through K2 and through the einsum, its logits and cache
   leaves within MODEL_TOL, and each run's cache, spliced into pages,
   decodes through K1 and through the einsum; dbrx also on int8 pages (K3
   against the q8 einsum, Q8_MODEL_TOL), with its routing traced
   (dropped (token, k) choices per call, choices that differ between the
   two runs, and at a stream mismatch the router's top-k / top-(k+1)
   gap). Then the 16 requests on fp32 pages of 16, K1 launched layers x
   ticks and (but for
   whisper, which prefills through the transient path with its first
   chunks through K2) layers x chunks; dbrx also on int8 pages (K3) and on
   the dense cache (first chunks through K2), with its serving drops by
   call (the routings of the fp32 pages run alone, each tagged with the
   tick or chunk that made it) and the MoE's share of a tick. Each run
   prints ITL p50, TTFT p50, tok/s and an idle tick's host wall and
   device idle share beside the tick's floor (``tick_floor``: the weights
   and whisper's cross K/V it reads, the VLM's image re-projection). The
   VLM's cross gates carry seeded noise (``repro`` starts them at 0) and
   its forward and model step take seeded image embeddings; it serves on
   zero ones, as ``repro`` does. Whisper's encoder runs through K2, not
   causal, against the einsum.
16. ResNet20 trained at the paper's widths (16 / 32 / 64), batch 128, on
   synthetic_cifar(4096, seed=1) with the example's AdamW, TF32 off, from
   one seeded init through K7 (im2col, output-stationary: forward, dX and
   dW GEMMs) and through the plain route (im2col with ``@``): (a) step 1's
   loss and every gradient leaf held (``TRAIN_GRAD_TOL``); (b) 20 steps,
   the losses held step by step (``TRAIN_TRAJ_TOL``) and falling; (c) K7's
   launches by role (``gemm_role``), 62 a step: 21 forward, 20 dX (the
   stem's input needs no gradient), 21 dW; (d) a step's host wall, device
   busy time and idle share per route; (e) the dX and dW GEMMs of a step
   timed by device time, each group summed, beside their bound, the plain
   version's and ``torch.matmul``'s time (run with phase 2's timings,
   early: late in the run, after profiles of whole training steps, the
   profiler dropped most calls' events); (f) BN folded, fp32 / fixed16 /
   int8 accuracy on synthetic_cifar(1024, seed=2), then ``python -m
   repro_torch.examples.train_resnet20_cifar --steps 50`` in its own
   process.
17. the LM trainer: minicpm-2b at full width cut to 4 of its 40 layers
   (0.53 B params), fp32, remat, batch 4 x 512 from TokenStream, the
   trainer's cosine schedule, 6 steps under deterministic algorithms
   (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts) with a checkpoint
   after step 3; a second trainer restored from it gives steps 4-6
   bit-equal (losses, params, m, v); peak device memory and a step's host
   wall and idle share. (17b) ``python -m repro_torch.launch.train --arch
   codeqwen1.5-7b --reduced --steps 20 --ckpt-dir <tmp>`` in its own
   process, then ``--steps 25``, which resumes from step 20; both exit 0
   with a finite final loss.
19. tensor-parallel serving, run after phase 18 on phase 4's weights:
   (19a) K1 (fp32 and bf16), K3 and K4 at full width on every rank's head
   slab at tp 2, 4 and 8 (``SlabMesh``: every rank's slab in this one
   process), each launched with the whole launch's plan: the slabs
   concatenated are the whole launch bit for bit, each slab within
   KERNEL_TOL of its plain version; rank 0's slab timed beside the plan
   the slab alone would take, the bound and SDPA on the slab; (19b)
   phase 4's 16 requests through a one-rank NCCL mesh (from an in-process
   store): tokens and first-token logits bit-equal to phase 4's, K1
   launched layers x ticks and chunks; (19c) two ranks serving them at
   tp = 2 (``chip_smoke.py --tp-rank``: one card each over NCCL where
   there are two, else both on cuda:0 over gloo, the all-gather staged
   through the host): tokens equal to phase 4's, each rank's pool half of
   tp = 1's, every attention through K1's slabs; then on int8 pages
   through K3's slabs, phase 3c's model step held to one device's
   (L, P, 2) scale groups within Q8_MODEL_TOL, and the served streams'
   greedy prefix match with phase 4b's reported beside 4b's own with
   phase 4.
20. sharded training, after phase 17: minicpm-2b at full width cut to
   2 layers (0.405 B params, 4.86 GB of params, m and v), fp32, no remat,
   the trainer's data and optimizer; ranks are processes (``chip_smoke.py
   --train-rank``: one card each over NCCL where there are enough, else
   all on cuda:0 over gloo, every collective staged through the host; the
   2 and the 4 ranks run at once, so their walls share the host).
   (20a) 2 steps mesh-free, then on (2, 1), (1, 2) and (2, 2) from the
   same initial state: losses within TRAIN20_TOL, step-1 gradients within
   GRAD20_TOL of each leaf's largest, each rank's resident share of the
   state and its peak memory; (20b) saved after a step on (2, 2),
   restored on (2, 2), (4, 1) and (1, 4), a step each within ELASTIC_TOL;
   (20c) the compressed all-reduce and the GPipe pipeline on CUDA tensors
   over 4 ranks, to ``tests/test_distributed.py``'s bounds; (20d) the
   trainer at mesh_shape (2, 1), its losses equal to 20a's (2, 1) run.
21. the dry run against the card, TF32 off: (21a) minicpm-2b at full
   width cut to 2 layers, a train step at B 8 x S 1024 in fp32, and
   (21b) qwen2.5-32b cut to 4 layers, the lockstep decode at B 8 over a
   dense bf16 cache of 4096 rows with bf16 serve params; each predicted
   on fake tensors over a one-rank fake mesh (``launch.dryrun``), then
   the same ``build_gate`` step run on a one-rank NCCL mesh: the
   predicted footprint above the arguments against
   ``max_memory_allocated`` above what was resident (``FOOTPRINT_REL``),
   the dot FLOPs counted on the card equal to the prediction and to
   ``torch.profiler``'s ``with_flops`` op by op, the device time and the
   compute and memory terms at the data sheet's peaks. (The
   production-mesh dry run takes longer than this script can spend:
   ``python -m repro_torch.launch.dryrun``, PERF.md.)
22. the sequence over "model", after phase 21, TF32 off: (22a)
   qwen2.5-32b at full width cut to 2 layers, fp32, mesh-free here and
   then on (1, 3) ranks (``chip_smoke.py --cp-rank``, gloo on cuda:0
   with one card; 40 heads over 8 kv heads divide no 3, so the rows and
   the cache's sequence run context-parallel): a sharded prefill of 8 x
   3072 rows and 16 greedy lockstep decode steps over a cache of 3072
   rows holding 2040 (flash decode, the steps crossing from rank 1's
   rows into rank 2's): logits within CP_TOL, tokens equal, the rows the
   steps wrote equal in each rank's block; each rank's collective bytes a
   decode step beside what a gather of each layer's K and V would move,
   its wall and device busy a step; (22b) hymba-1.5b cut to 2 layers,
   its prefill of 2 x 4096 through the banded form at (1, 2) (each
   rank's chunks and a halo from its neighbour) within CP_TOL of
   mesh-free.
23. the MoE family over the mesh, after phase 22, TF32 off, fp32, gloo
   ranks on cuda:0 as phase 22's (``chip_smoke.py --ep-rank``): (23a)
   moonshot-v1-16b-a3b at full width cut to 2 layers, one sharded train
   step of 4 x 512 at (1, 2) (32 of 64 experts a rank, 16 heads over 16
   kv heads over "model", the rows split): each rank computes the
   mesh-free step-1 loss and gradients in turn and keeps its blocks; the
   sharded loss within TRAIN20_TOL, its gradient blocks within
   GRAD20_TOL of each leaf's largest; (23b) dbrx-132b at full width cut
   to 1 layer, params over "model" only (the serving rules): a sharded
   prefill of 8 x 512 at (2, 2) (4,096 tokens: 16 of 32 dispatch groups
   and 8 of 16 experts a rank, 48 heads over 8 kv heads over "model")
   and 8 greedy lockstep decode steps, logits within CP_TOL of
   mesh-free's, tokens equal. Each leg prints each rank's MoE forward
   dot FLOPs (``torch.profiler``'s ``with_flops``) beside mesh-free's,
   its collective bytes by kind, its wall and device busy.
24. the recurrent families over the mesh, after phase 23, TF32 off,
   fp32: (24a) K5 at rwkv6-7b's width (64 heads of 64) and K6 at
   hymba-1.5b's (1600 channels, state 16), a one-request 64-token chunk
   and an 8-slot tick, on every rank's slab at 2, 4 and 16 "model" ranks
   (32 / 16 / 4 heads, 800 / 400 / 100 channels), each launched alone
   and bit-equal to the same heads' or channels' y and state of the
   whole launch, rank 0's slab timed beside the whole launch and the
   bound; (24b) rwkv6-7b, then hymba-1.5b, at full width cut to 2
   layers, at (1, 2) (``chip_smoke.py --rec-rank``, gloo on cuda:0 with
   one card): a sharded prefill of 4 x 256 (the rows and the heads or
   channels over "model") and 8 greedy lockstep decode steps over the
   rank's block of the state, logits within CP_TOL of mesh-free's, tokens
   equal, no cache leaf gathered; each rank's K5 / K6 launches by (B, T,
   heads or channels), collective bytes by kind, a decode step's wall
   and device busy, and the state bytes a step no longer gathers; (24c)
   one sharded train step of rwkv6-7b (2 layers) on 2 x 256 at (1, 2)
   (plain scan: K5 has no backward): the fp32 loss within TRAIN20_TOL of
   mesh-free's, the step-1 gradients in float64 (``launch.witness``)
   within GRAD20_TOL of mesh-free's, and in fp32 about as far from
   float64's as mesh-free's fp32 ones are (REC_FP32_SPREAD).

The recurrent phases perturb the leaves ``repro``'s init leaves constant
(rwkv's u, mu, mu_x, lora_B, wB; hymba's logA) with seeded noise, so the
decay, the bonus and the per-channel A depend on the data. Each serving
path (3b's forward, 4, 4b, 5, 7, 9, 10, 11, 18, 19b, 19c, 24b), each
forward of phases 8,
8b, 9 and 10 and phase 16's training runs run with the kernels' launch
counts set to 0 just before and read just after, and every serving run requires that no prefill
chunk failed (the engine catches a chunk that raises and fails its job);
so do phases 12-15.
Then one JSON line
describing each kernel, and as the last line ``{"ok": true, "device":
{...}}``. TF32 is off throughout: every number is fp32, as the reference
computes, but for the bf16 legs of phases 2, 7 and 18, which compute in
bf16 as the reference does at ``compute_dtype=bfloat16``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

# phase 17 runs under torch.use_deterministic_algorithms(True), which needs
# cuBLAS's workspace fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.resnet20_cifar import CONFIG as RESNET  # noqa: E402
from repro_torch.core.quantize import (QuantizedTensor,  # noqa: E402
                                       dequantize_params, fixed_point_tree,
                                       page_scale, quantize_params,
                                       quantize_per_channel)
from repro_torch.data.synthetic import (TokenStream,  # noqa: E402
                                        synthetic_cifar)
from repro_torch.examples import train_resnet20_cifar as resnet_example  # noqa: E402,E501
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models.registry import (get_model,  # noqa: E402
                                         init_paged_cache,
                                         insert_cache_rows_paged)
from repro_torch.optim.adamw import AdamW, apply_updates  # noqa: E402
from repro_torch.serve import (SLO, ReplicaRouter, SchedPolicy,  # noqa: E402
                               ServeConfig, ServeEngine, WorkloadSpec,
                               merged_summary)
from repro_torch.serve import workload  # noqa: E402
from repro_torch.serve.metrics import percentile  # noqa: E402
from repro_torch.serve.scheduler import RequestState  # noqa: E402
from repro_torch.serve.kvcache import (PagedInt8Backend,  # noqa: E402
                                       PagedLatentBackend)
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # same fp32 math, other sum order
MODEL_TOL = 1e-3                 # logits after 4 full-width fp32 layers
# int8 pages: the two read paths write K/V rows that differ in the last
# bit from layer 2 on, and a row value on a rounding tie then lands one
# int8 step (a page's amax / 127) apart; such flips, not the kernel, set
# the logits gap of the int8 model comparison
Q8_MODEL_TOL = 1e-2
# bf16 (phases 2 and 18): every kernel computes in fp32 and rounds its
# output once, so a bf16 kernel is held to its plain version within
# KERNEL_TOL and one bf16 step of each element (``kernel_held``). Model logits of two routes
# in bf16 (phase 18: the kernel, fp32 inside, against the einsum, which
# rounds scores and probabilities to bf16 as the reference's einsum does)
# are held within BF16_MODEL_TOL of the step's largest magnitude, on one
# trajectory (both take the einsum route's greedy tokens), and their
# tokens where the top-2 gap exceeds that: at full width 1.6-1.8e-2 apart
# (qwen2.5-32b on bf16, fp32 and int8 pages, qwen2.5-32b-mla on latent
# pages, the forward), so 3e-2 leaves room for another card's library
# choices; the einsum's rounded scores, not the kernels, set the gap
BF16 = torch.bfloat16
BF16_MODEL_TOL = 3e-2
INACTIVE = 1 << 30
ARCH = "qwen2.5-32b"
MLA_ARCH = "qwen2.5-32b-mla"
RWKV, HYMBA = "rwkv6-7b", "hymba-1.5b"
CMDR, DBRX = "command-r-35b", "dbrx-132b"
VISION, WHISPER = "llama-3.2-vision-11b", "whisper-large-v3"
LAYERS = 4
SLOTS, S_MAX, PS = 8, 1024, 16
# phase 3b's full-sequence prefill step (B, S), also hymba's in phase 10
FORWARD_BATCH = (2, 512)
# K2 at full width, by row of the kernels line: (arch, B, S) of a serving
# first chunk (B slots x C) and of a forward
FLASH_SHAPES = {"prefill": (ARCH, SLOTS, 64), "forward": (ARCH, 4, 1024),
                "prefill_hymba": (HYMBA, SLOTS, 64),
                "forward_hymba": (HYMBA, *FORWARD_BATCH),
                "prefill_dbrx": (DBRX, SLOTS, 64),
                "prefill_whisper": (WHISPER, SLOTS, 64),
                "forward_whisper": (WHISPER, 2, 1500)}
# the shapes whose attention is not causal: whisper's encoder over its 1500
# frames (not a multiple of the key tile)
FLASH_NOT_CAUSAL = ("forward_whisper",)
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
# K7's and K8's CUDA kernels, as the profiler names them (every one of
# them: a split GEMM's partials and, named apart, their sum)
GEMM_KERNEL, SPLIT_SUM_KERNEL = "systolic_gemm", "systolic_gemm_split_sum"
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
# depth cut so that phases 20-24 fit the script's time (of 32 layers each)
RWKV_LAYERS, HYMBA_LAYERS = 8, 4
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
# compared on its first 2 layers; hymba resolves it at HYMBA_LAYERS
CHECK_LAYERS = {RWKV: 2, HYMBA: HYMBA_LAYERS}
DEV = torch.device("cuda")
T_START = time.perf_counter()           # the whole script's clock


def log(msg):
    if msg.startswith("phase "):    # each phase's start on the script's clock
        msg += f" [{time.perf_counter() - T_START:.1f} s in]"
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


def profiled_calls(fn, iters: int, attempts: int = 6) -> list:
    """Run ``fn`` ``iters`` times, each call after the L2 flush, under one
    ``torch.profiler`` session; the (name, device us) of every kernel, copy
    and memset each call launched, in order (``split_calls``). A session
    now and then comes back without its device events (its launches are
    recorded on the host, and no kernel is), several in a row at times:
    it is run again after a pause that doubles each time, up to
    ``attempts`` sessions in all."""
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
            time.sleep(0.05 * 2 ** attempt)


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


# device times that the profiler could not give (``device_times``)
FALLBACKS = []


def queued_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` in ms between CUDA events, each call after the
    L2 flush and behind a ~2.5 ms sleep queued on the card, so that the
    host has enqueued the whole call before the card reaches it: device
    time of everything the call launches, without the host's enqueue
    delay. ``device_times``' way when the profiler gives no events."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def device_times(fns, iters: int, kernel=None, launched=None) -> list:
    """Per entry of ``fns``, the mean device time in ms of what one call
    launches (``profiled_calls``; no host enqueue delay, which an event
    pair around a tick-sized launch holds). With ``kernel`` (a name, or a
    tuple of names for a port kernel that may be a set of launches, such
    as K4's split over keys and its merge), only the CUDA kernels whose
    name holds one of them count, and their times are summed; every call
    must launch the same named kernels in the same order, at least one (a
    set of more than one logs each launch's time); without, everything a
    call launched counts (a library call, which may launch several
    kernels). Where no profiler session of ``fn`` comes back whole, its
    time is ``queued_ms``', logged and counted in ``FALLBACKS``. A list
    ``launched`` receives, per entry, the count of (named) kernel launches
    of one call, None where the profiler gave none."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    out = []
    for fn in fns:
        try:
            calls = profiled_calls(fn, iters)
        except AssertionError as err:
            ms = queued_ms(fn, iters)
            FALLBACKS.append(ms)
            log(f"  (profiler: {err} in every session; timed between "
                f"events behind a queued sleep instead, everything the "
                f"call launched: {ms:.4f} ms)")
            out.append(ms)
            if launched is not None:
                launched.append(None)
            continue
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
        if launched is not None:
            launched.append(len(calls[0]))
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


def bf16_step(x):
    """The spacing of bf16 values at magnitude |x| (below the smallest
    normal, the smallest normal's)."""
    big = x.abs().clamp_min(torch.finfo(BF16).smallest_normal)
    return torch.exp2(torch.floor(torch.log2(big)) - 7)


def kernel_held(name, got, want):
    """A kernel's output against its plain version's on the same inputs:
    fp32 outputs within KERNEL_TOL (``held``); bf16 outputs within
    KERNEL_TOL plus one bf16 step of each element (both compute in fp32,
    their sums in other orders, as the fp32 outputs do, and each rounds
    once to bf16, which adds at most one step). Returns (got, max
    |diff|)."""
    if got.dtype != BF16:
        return held(name, got, want)
    torch.cuda.synchronize()
    if want.dtype != BF16:
        raise AssertionError(f"{name}: plain version gave {want.dtype}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    allowed = (bf16_step(torch.maximum(g.abs(), w.abs()))
               + KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * w.abs())
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()) or (
            diff > allowed).any():
        i = torch.argmax(diff - allowed)
        raise AssertionError(f"{name}: bf16 kernel further than KERNEL_TOL "
                             f"and a bf16 step from the plain version at "
                             f"{int((diff > allowed).sum())} elements (worst "
                             f"{g.flatten()[i].item()} against "
                             f"{w.flatten()[i].item()}), max abs err {err}")
    log(f"  {name}: max abs err {err:.3e} (within KERNEL_TOL and a bf16 "
        f"step)")
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


def full_width_case(Sq, seed, arch=ARCH):
    """The serving shapes of ``arch`` (qwen2.5-32b: 40 query heads over 8
    kv heads, head_dim 128): 8 slots, page_size 16, s_max 1024; each slot
    holds 100-732 rows (a 100-700 token prompt plus up to 32 generated
    tokens)."""
    cfg = configs.get_config(arch)
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
    scale per live page for K and for V), q read once and out written once
    in q's dtype, at the HBM rate; against the fp32 FMAs of the valid
    (query, key) pairs (score and value products) at the fp32 peak (the
    kernels keep the TPU kernels' fp32 arithmetic whatever the operands'
    dtype)."""
    q = args[0]
    B, Sq, H, hd = q.shape
    ps, KV = args[1].shape[1:3]
    rows = int(np.sum(fill))                          # keys up to last query
    scales = 0 if kv_bytes != 1 else 2 * 4 * sum(-(-int(f) // ps)
                                                 for f in fill)
    nbytes = (2 * rows * KV * hd * kv_bytes + scales
              + 2 * q.numel() * q.element_size()
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


def phase2_full_width(arch=ARCH, q_dtype=torch.float32,
                      pool_dtype=torch.float32):
    """K1 at ``arch``'s decode and prefill shapes (8 slots; a 64-row
    chunk), q and the pools in the given dtypes: against the plain
    version, then the kernel's, the plain version's and SDPA's times
    beside the bound. The rows are keyed by kind and ``launch_suffix``
    (SDPA takes one dtype: for a mixed pair, q cast to the pools')."""
    out = {}
    cfg = configs.get_config(arch)
    mixed = (q_dtype, pool_dtype) != (torch.float32, torch.float32)
    suffix = pa.launch_suffix(q_dtype, pool_dtype) if mixed else ""
    for kind, Sq, seed in (("decode", 1, 11), ("prefill", 64, 12)):
        args, fill = full_width_case(Sq, seed, arch)
        name = (f"full width {kind}{suffix} {arch} (B={SLOTS}, Sq={Sq}, "
                f"H={cfg.num_heads}, KV={cfg.num_kv_heads}, "
                f"hd={cfg.head_dim}, ps={PS})")
        if mixed:
            args = [args[0].to(q_dtype), args[1].to(pool_dtype),
                    args[2].to(pool_dtype), *args[3:]]
            _, err = kernel_held(name, pa.paged_attention(*args, kind=kind),
                                 ref.paged_attention(*args))
            lib = sdpa_call([args[0].to(pool_dtype), *args[1:]])
        else:
            _, err = check_case(name, args, kind=kind)
            lib = sdpa_call(args)
        want = ref.paged_attention(*args)
        lib_err = (lib().transpose(1, 2).float() - want.float()
                   ).abs().max().item()
        ms = device_ms(lambda: pa.paged_attention(*args, kind=kind), 50,
                       PAGED_KERNELS)
        plain = time_ms(lambda: ref.paged_attention(*args), 10)
        lib_ms = device_ms(lib, 10)
        bms, by = bound_ms(args, fill, kv_bytes=args[1].element_size())
        log(f"  {kind}{suffix} {arch}: kernel {ms:.4f} ms | plain "
            f"{plain:.4f} ms | sdpa {lib_ms:.4f} ms (max abs diff "
            f"{lib_err:.2e}) | bound {bms:.4f} ms ({by}) | live rows "
            f"{int(np.sum(fill))}")
        out[kind + suffix] = dict(err=err, ms=ms, plain_ms=plain,
                                  library_ms=lib_ms, bound_ms=bms,
                                  bound_by=by)
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


def phase2_q8_full_width(q_dtype=torch.float32):
    """K3 at qwen2.5-32b's serving shapes, int8 pools, q in ``q_dtype``.
    The library call is SDPA on the pre-gathered view dequantized to q's
    dtype, timed alone."""
    out = {}
    suffix = "" if q_dtype == torch.float32 else "_bf16"
    for kind, Sq, seed in (("decode_q8", 1, 13), ("prefill_q8", 64, 14)):
        f32_args, fill = full_width_case(Sq, seed)
        args, sc = q8_args(f32_args)
        name = (f"full width {kind}{suffix} (B={SLOTS}, Sq={Sq}, H=40, "
                f"KV=8, hd=128, ps={PS}, int8)")
        if suffix:
            args[0] = args[0].to(q_dtype)
            _, err = kernel_held(name, pa.paged_attention(*args, kind=kind,
                                                          **sc),
                                 ref.paged_attention(*args, **sc))
        else:
            _, err = check_case(name, args, kind=kind, **sc)
        deq = [args[0]] + [(p.float() * s[:, None, None, None]).to(q_dtype)
                           for p, s in ((args[1], sc["k_scale"]),
                                        (args[2], sc["v_scale"]))] + args[3:]
        lib = sdpa_call(deq)
        want = ref.paged_attention(*args, **sc)
        lib_err = (lib().transpose(1, 2).float() - want.float()
                   ).abs().max().item()
        ms = device_ms(lambda: pa.paged_attention(*args, kind=kind, **sc),
                       50, PAGED_KERNELS)
        plain = time_ms(lambda: ref.paged_attention(*args, **sc), 10)
        lib_ms = device_ms(lib, 10)
        bms, by = bound_ms(args, fill, kv_bytes=1)
        log(f"  {kind}{suffix}: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
            f"sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}) | bound "
            f"{bms:.4f} ms ({by}) | live rows {int(np.sum(fill))}")
        out[kind + suffix] = dict(err=err, ms=ms, plain_ms=plain,
                                  library_ms=lib_ms, bound_ms=bms,
                                  bound_by=by)
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


def phase2_latent_full_width(q_dtype=torch.float32,
                             pool_dtype=torch.float32):
    """K4 at qwen2.5-32b-mla's serving shapes: 8 slots of 100-732 latent
    rows (576 floats; values the first 512), 40 heads, page_size 16, the
    softmax scaled by 1/sqrt(192); q and the pool in the given dtypes. The
    library call is SDPA with q (B, 40, Sq, 576), the gathered latent view
    as its one K head and the view's first 512 columns as V, timed
    alone."""
    cfg = configs.get_config(MLA_ARCH)
    H, c, r = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Lw, scale_dim = c + r, cfg.head_dim + r
    mps = S_MAX // PS
    out = {}
    mixed = (q_dtype, pool_dtype) != (torch.float32, torch.float32)
    suffix = pa.launch_suffix(q_dtype, pool_dtype) if mixed else ""
    for kind, Sq, seed in (("decode_latent", 1, 15),
                           ("prefill_latent", 64, 16)):
        fill = np.random.default_rng(seed).integers(100, 733, SLOTS)
        q, pool, bt = latent_case(seed, SLOTS, Sq, H, Lw, SLOTS * mps, PS,
                                  mps, fill)
        args = on_card(q, pool, bt, (fill - Sq).astype(np.int32))
        name = (f"full width {kind}{suffix} (B={SLOTS}, Sq={Sq}, H={H}, "
                f"{Lw}/{c}, ps={PS})")
        if mixed:
            args = [args[0].to(q_dtype), args[1].to(pool_dtype), *args[2:]]
            _, err = kernel_held(name, pa.paged_attention_latent(
                *args, scale_dim=scale_dim, d_v=c, kind=kind),
                ref.paged_attention_latent(*args, scale_dim=scale_dim,
                                           d_v=c))
        else:
            _, err = check_latent(name, args, scale_dim, c, kind)
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
        qt = qd.transpose(1, 2).to(pool_dtype).contiguous()
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, k, v, attn_mask=mask, scale=scale_dim ** -0.5,
            enable_gqa=True)
        want = ref.paged_attention_latent(*args, scale_dim=scale_dim, d_v=c)
        lib_err = (lib().transpose(1, 2).float() - want.float()
                   ).abs().max().item()
        ms = device_ms(lambda: pa.paged_attention_latent(
            *args, scale_dim=scale_dim, d_v=c, kind=kind), 50,
            LATENT_KERNELS)
        plain = time_ms(lambda: ref.paged_attention_latent(
            *args, scale_dim=scale_dim, d_v=c), 10)
        lib_ms = device_ms(lib, 10)
        # each slot's latent rows read once for all heads; q read and the
        # output written once; (Lw + c) FMAs per visible (row, head, key)
        rows = int(np.sum(fill))
        nbytes = (rows * Lw * pool_d.element_size()
                  + (qd.numel() + SLOTS * Sq * H * c) * qd.element_size()
                  + 4 * (bt_d.numel() + st_d.numel()))
        bms, by = roofline(nbytes,
                           2 * (Lw + c) * visible_pairs(fill, Sq) * H)
        log(f"  {kind}{suffix}: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
            f"sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}) | bound "
            f"{bms:.4f} ms ({by}) | live rows {rows}")
        out[kind + suffix] = dict(err=err, ms=ms, plain_ms=plain,
                                  library_ms=lib_ms, bound_ms=bms,
                                  bound_by=by)
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
    """K2 vs its plain version on the card (``kernel_held``); returns max
    |diff|."""
    return kernel_held(name, fa.flash_attention(*args, causal=causal,
                                                window=window, kind=kind),
                       ref.flash_attention(*args, causal=causal,
                                           window=window))[1]


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
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return roofline(nbytes, 4 * pairs * hd)


def phase2_flash_full_width(dtype=torch.float32, shapes=FLASH_SHAPES):
    """K2 at the shapes the models give it (``FLASH_SHAPES``), a serving
    first chunk and a forward each: qwen2.5-32b's 40 query heads over 8 kv
    heads at head_dim 128, causal, hymba-1.5b's 25 over 5 at head_dim 64
    with its 1024-row window, which phase 10 runs; the first chunks of
    dbrx-132b's dense cache (48 over 8 at head_dim 128, phase 13) and of
    whisper-large-v3's decoder (20 over 20 at head_dim 64, phase 15),
    causal; and whisper's encoder, 20 over 20 at head_dim 64 over 1500
    frames, not causal, which phase 15 runs. The library call is SDPA,
    causal where the kernel is (the window is wider than the sequence, so
    it masks nothing more). q, k and v in ``dtype``; bf16 rows are keyed
    with "_bf16" after the kind, as their launches are counted."""
    out = {}
    tag = "" if dtype == torch.float32 else "_bf16"
    for kind, (arch, B, S) in shapes.items():
        cfg = configs.get_config(arch)
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        window = cfg.window or 0
        causal = kind not in FLASH_NOT_CAUSAL
        if window and window < S:
            raise AssertionError(f"{arch}: the SDPA yardstick is causal, but "
                                 f"the window {window} < S = {S}")
        args = [t.to(dtype) for t in flash_case(40, B, S, S, H, KV, hd)]
        count = kind.split("_")[0]
        err = check_flash(f"full width flash {kind}{tag} ({arch}: B={B}, "
                          f"S={S}, H={H}, KV={KV}, hd={hd}, window={window}, "
                          f"causal={causal})", args, causal=causal,
                          window=window, kind=count)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in args)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        want = ref.flash_attention(*args, causal=causal, window=window)
        lib_err = (lib().transpose(1, 2).float() - want.float()
                   ).abs().max().item()
        del want
        iters = 50 if count == "prefill" else 10
        ms = device_ms(lambda: fa.flash_attention(
            *args, causal=causal, window=window, kind=count), iters,
            "flash_attention_kernel")
        plain = time_ms(lambda: ref.flash_attention(
            *args, causal=causal, window=window), 5)
        lib_ms = device_ms(lib, iters)
        bms, by = flash_bound_ms(args, causal=causal, window=window)
        log(f"  flash {kind}{tag}: kernel {ms:.4f} ms | plain {plain:.4f} "
            f"ms | sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}) | bound "
            f"{bms:.4f} ms ({by})")
        out[kind + tag] = dict(err=err, ms=ms, plain_ms=plain,
                               library_ms=lib_ms, bound_ms=bms, bound_by=by)
        del args, qt, kt, vt
    torch.cuda.empty_cache()
    return out


# ---------------------------------------- phase 2: bf16 entries (K1-K4)
# the (q, pool) dtype pairs of the paged kernels' bf16 entries: bf16
# compute over bf16 pages (cache_dtype None), over fp32 pages (repro's
# step default) and fp32 q over bf16 pages
PAGED_BF16_PAIRS = ((BF16, BF16), (BF16, torch.float32),
                    (torch.float32, BF16))
# the full-width bf16 rows of the kernels line and the pairs they time
PAGED_BF16_ROWS = ((BF16, BF16), (BF16, torch.float32))


def phase2_bf16_cases():
    """The bf16 entries against their plain versions on the card: K1 at
    every SPLIT_EDGES case for each (q, pool) pair of PAGED_BF16_PAIRS
    (rows no query sees NaN in the kernel's pools), K3 at the same cases
    with bf16 q over int8 pools (NaN scales on pages no query sees), K4 at
    latent widths 10/8, 64/48, 576/512 and 1024/512 for each pair (a freed
    slot exact zeros), and K2 with q, k and v in bf16 on phase 2's forward
    cases and chunk lengths. Returns the worst error by launch key."""
    errs = {}

    def note(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    for qd, pd in PAGED_BF16_PAIRS:
        suffix = pa.launch_suffix(qd, pd)
        for n, case in enumerate(SPLIT_EDGES):
            args, seen = split_edge(30 + n, case)
            args = [args[0].to(qd), args[1].to(pd), args[2].to(pd),
                    *args[3:]]
            mask = torch.from_numpy(seen).to(DEV)[:, :, None, None]
            bad = [torch.where(mask, a, float("nan")) for a in args[1:3]]
            kind = "decode" if case[0] == 1 else "prefill"
            name = f"split edge {n} {kind}{suffix}"
            got, err = kernel_held(name, pa.paged_attention(
                args[0], *bad, *args[3:], window=case[8], kind=kind),
                ref.paged_attention(*args, window=case[8]))
            zero_where_freed(name, got, args[4])
            note(kind + suffix, err)

    for n, case in enumerate(SPLIT_EDGES):
        f32_args, seen = split_edge(30 + n, case)
        args, sc = q8_args(f32_args)
        args[0] = args[0].to(BF16)
        unseen = torch.from_numpy(~seen.any(axis=1)).to(DEV)
        nan_sc = {k: torch.where(unseen, float("nan"), v)
                  for k, v in sc.items()}
        kind = "decode_q8" if case[0] == 1 else "prefill_q8"
        name = f"q8 split edge {n} {kind}_bf16"
        got, err = kernel_held(name, pa.paged_attention(
            *args, window=case[8], kind=kind, **sc),
            ref.paged_attention(*args, window=case[8], **sc))
        if not torch.equal(pa.paged_attention(*args, window=case[8],
                                              kind=kind, **nan_sc), got):
            raise AssertionError(f"{name}: a scale of an unvisited page "
                                 f"was read")
        zero_where_freed(name, got, args[4])
        note(kind + "_bf16", err)

    for qd, pd in PAGED_BF16_PAIRS:
        suffix = pa.launch_suffix(qd, pd)
        for Lw, d_v, scale_dim in ((10, 8, 18), (64, 48, 96),
                                   (576, 512, 192), (1024, 512, 192)):
            for Sq in (1, 37):
                ps, mps = 16, 4
                fill = [ps + ps // 2 + Sq, ps // 2 + Sq, 0]
                q, pool, bt = latent_case(50 + Sq, 3, Sq, 40, Lw, 12, ps,
                                          mps, fill)
                start = np.asarray([fill[0] - Sq, fill[1] - Sq, INACTIVE],
                                   np.int32)
                args = on_card(q, pool, bt, start)
                args = [args[0].to(qd), args[1].to(pd), *args[2:]]
                kind = "decode_latent" if Sq == 1 else "prefill_latent"
                got, err = kernel_held(
                    f"latent {Lw}/{d_v} Sq={Sq} {kind}{suffix}",
                    pa.paged_attention_latent(*args, scale_dim=scale_dim,
                                              d_v=d_v, kind=kind),
                    ref.paged_attention_latent(*args, scale_dim=scale_dim,
                                               d_v=d_v))
                if not torch.all(got[2] == 0):
                    raise AssertionError("latent bf16: freed slot not "
                                         "exactly 0")
                note(kind + suffix, err)

    cases = [dict(Sq=256, Sk=256, H=8, KV=8, causal=True, window=0),
             dict(Sq=256, Sk=256, H=40, KV=8, causal=False, window=0),
             dict(Sq=256, Sk=256, H=16, KV=2, causal=True, window=64),
             dict(Sq=128, Sk=512, H=8, KV=1, causal=False, window=0)]
    for hd in (128, 16, 64, 256):
        for i, c in enumerate(cases if hd == 128 else cases[:2]):
            args = [t.to(BF16) for t in flash_case(
                20 + i, 2, c["Sq"], c["Sk"], c["H"], c["KV"], hd)]
            note("flash_forward_bf16", check_flash(
                f"flash bf16 case{i} hd={hd}", args, c["causal"],
                c["window"]))
    for C in (1, 37, 64, 100):
        for window in (0, 64):
            args = [t.to(BF16) for t in flash_case(30 + C, 3, C, C, 40, 8,
                                                    128)]
            note("flash_prefill_bf16", check_flash(
                f"flash bf16 chunk C={C} window={window}", args,
                window=window, kind="prefill"))
    return errs


def phase2_bf16_full_width():
    """The bf16 entries at the full-width shapes of the fp32 rows: K1 at
    qwen2.5-32b's decode and prefill over bf16 pages and, with bf16 q,
    over fp32 pages; K3 with bf16 q; K4 at qwen2.5-32b-mla's; K2 at
    qwen2.5-32b's first chunk and forward. Timed as the fp32 rows are
    (device time after the L2 flush); the bound counts bytes at bf16
    width and the fp32 FMAs the kernels keep; the library call is SDPA on
    the same bf16 tensors. Rows keyed as their launches are counted."""
    out = {}
    for qd, pd in PAGED_BF16_ROWS:
        out.update(phase2_full_width(ARCH, qd, pd))
    out.update(phase2_q8_full_width(BF16))
    out.update(phase2_latent_full_width(BF16, BF16))
    return out, phase2_flash_full_width(BF16, {
        kind: FLASH_SHAPES[kind] for kind in ("prefill", "forward")})


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
                 tol=MODEL_TOL, extras=None):
    """Full-width model at its cut depth: one 64-token prefill chunk for 8
    slots on a fresh paged cache (fp32 pages, or the cache ``backend``
    builds), then 8 greedy decode steps, through the kernel and through the
    masked-einsum reference read; logits (within ``tol``) and tokens
    compared, and how far the two final caches' pools differ reported.
    ``extras``: the stub inputs every call takes (a VLM's image
    embeddings, 8 rows). An MoE model's routing is traced in both runs:
    the (token, k) choices its capacity dropped, call by call, and the
    choices on which the two runs differ."""
    cfg = model.cfg
    layers = cfg.num_layers
    extras = extras or {}
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.name} x {layers} layers: {n / 1e9:.3f} B params fp32, "
        f"{label}")
    mps = S_MAX // PS
    bt = torch.arange(SLOTS * mps, dtype=torch.int32,
                      device=DEV).reshape(SLOTS, mps)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, 64))
                            ).to(DEV)
    runs, caches, traces = {}, {}, {}
    for impl in ("kernel", "einsum"):
        if backend is None:
            cache = init_paged_cache(model, SLOTS, S_MAX, page_size=PS,
                                     num_pages=SLOTS * mps, device=DEV)
        else:
            cache = backend.init_cache(model, SLOTS, S_MAX, torch.float32,
                                       DEV)
        cache["block_tables"].copy_(bt)
        pa.reset_launches()
        traces[impl] = layers_mod.MOE_TRACE = [] if cfg.moe else None
        t0 = time.perf_counter()
        try:
            logits, cache = model.prefill_chunk_paged(
                params, toks, cache, bt_rows=bt, start=0, write_floor=0,
                attn_impl=impl, **extras)
            cache["pos"].fill_(64)
            seq, tok = [logits], logits[:, :, :cfg.vocab_size].argmax(-1)
            tokens = [tok]
            for _ in range(8):
                logits, cache = model.decode_step(params, tok, cache,
                                                  paged_attn_impl=impl,
                                                  **extras)
                tok = logits[:, :, :cfg.vocab_size].argmax(-1)
                seq.append(logits)
                tokens.append(tok)
            torch.cuda.synchronize()
        finally:
            layers_mod.MOE_TRACE = None
        launched = sum(pa.LAUNCHES.values())
        if launched != (9 * layers if impl == "kernel" else 0):
            raise AssertionError(f"impl={impl}: {pa.LAUNCHES} paged "
                                 f"attention launches for 1 chunk + 8 steps "
                                 f"x {layers} layers")
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
    if cfg.moe:
        moe_report(traces, layers, runs)
    compare_runs(runs, cfg, "kernel", "einsum", tol)
    del runs
    torch.cuda.empty_cache()


def moe_report(traces, layers, runs):
    """The routing of the two runs of ``phase3_model`` (a chunk, then 8
    decode steps; one trace entry per layer per call): dropped (token, k)
    choices per call and of how many, and the choices on which the kernel
    run and the einsum run differ. Where the greedy tokens differ, the
    smallest gap between a token's k-th and (k+1)-th router probability
    up to the first call whose routing differs: a near-tie there is what
    lets last-bit attention differences reroute a token."""
    a, b = traces["kernel"], traces["einsum"]
    drops, differ, first = [], 0, None
    for c in range(len(a) // layers):
        calls = a[c * layers:(c + 1) * layers]
        drops.append((sum(int((~t["kept"]).sum()) for t in calls),
                      sum(t["kept"].numel() for t in calls)))
        for ta, tb in zip(calls, b[c * layers:(c + 1) * layers]):
            d = int((ta["expert"] != tb["expert"]).sum())
            differ += d
            if d and first is None:
                first = c
    log(f"  MoE drops per call (dropped of routed (token, k) choices, "
        f"{layers} layers): chunk {drops[0][0]}/{drops[0][1]}, decode "
        + ", ".join(f"{x}/{n}" for x, n in drops[1:]))
    log(f"  routing choices differing between kernel and einsum runs: "
        f"{differ} of {sum(t['expert'].numel() for t in a)}")
    if not torch.equal(runs["kernel"][1], runs["einsum"][1]):
        upto = a[:((first if first is not None else len(a) // layers) + 1)
                 * layers]
        k = a[0]["expert"].shape[1]
        gaps = []
        for t in upto:
            srt = t["probs"].sort(dim=-1, descending=True).values
            gaps.append((srt[:, k - 1] - srt[:, k]).min().item())
        log(f"  greedy streams differ; first call whose routing differs: "
            f"{first}; smallest top-{k} / top-{k + 1} router probability "
            f"gap up to it: {min(gaps):.3e}")


def routing_divergence(a_name, a, b_name, b):
    """Two serving runs' MoE traces (``serve_family``'s, one entry per
    layer per call), walked in step: the first entry whose call or shape
    differs (from there on the two engines batch differently, so capacity
    differs by construction), or else the first whose routing differs,
    with the smallest top-k / top-(k+1) router probability gap (in run
    ``a``) among the tokens it reroutes: a near-tie there is what lets a
    last-bit difference upstream reroute a token."""
    for i, (ta, tb) in enumerate(zip(a, b)):
        if ta["call"] != tb["call"] or ta["expert"].shape != tb[
                "expert"].shape:
            log(f"  routing {a_name} vs {b_name}: equal for {i} MoE calls, "
                f"then a {ta['call']} of {ta['expert'].shape[0]} tokens "
                f"against a {tb['call']} of {tb['expert'].shape[0]}")
            return
        moved = (ta["expert"] != tb["expert"]).any(-1)
        if moved.any():
            k = ta["expert"].shape[1]
            srt = ta["probs"][moved].sort(dim=-1, descending=True).values
            gap = (srt[:, k - 1] - srt[:, k]).min().item()
            log(f"  routing {a_name} vs {b_name}: equal for {i} MoE calls, "
                f"then a {ta['call']} reroutes {int(moved.sum())} of "
                f"{moved.numel()} tokens; smallest top-{k} / top-{k + 1} "
                f"router probability gap among them {gap:.3e}")
            return
    log(f"  routing {a_name} vs {b_name}: equal over all "
        f"{min(len(a), len(b))} MoE calls ({len(a)} and {len(b)} traced)")


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
        logits = steps.make_prefill(model, attn_impl=impl,
                                    compute_dtype=torch.float32)(
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
                                         attn_impl=impl,
                                         compute_dtype=torch.float32)
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
    m["itl_s"]["p99"] = itl_p99(engine)
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


def check_paged_launches(kinds, m, what, layers=LAYERS):
    """Every multi-page attention of a paged serving run went through the
    kernel: ``kinds`` = (decode key, prefill key) of ``pa.LAUNCHES`` equal
    ``layers`` x decode steps and ``layers`` x prefill chunks, and no other
    kernel was launched. Returns the counts."""
    launches = dict(pa.LAUNCHES)
    others = {k: v for k, v in launches.items() if k not in kinds}
    if sum(others.values()) or sum(fa.LAUNCHES.values()):
        raise AssertionError(f"{what} launched other kernels: {others}, "
                             f"{fa.LAUNCHES}")
    dec, pre = kinds
    if (launches[dec] != m["decode_steps"] * layers
            or launches[pre] != m["prefill_chunks"] * layers
            or not launches[dec] or not launches[pre]):
        raise AssertionError(f"{what}: launches {launches} != one per layer "
                             f"per decode step ({m['decode_steps']}) / "
                             f"prefill chunk ({m['prefill_chunks']})")
    log(f"  {what} launches: {dec} {launches[dec]} ({m['decode_steps']} "
        f"steps x {layers} layers), {pre} {launches[pre]} "
        f"({m['prefill_chunks']} chunks x {layers} layers)")
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
    return launches, m, reqs


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
                engine.model, compute_dtype=engine.compute_dtype,
                paged_attn_impl="einsum")
            engine._chunk_paged = steps.make_prefill_chunk_paged(
                engine.model, compute_dtype=engine.compute_dtype,
                attn_impl="einsum")
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
def phase7_mla(card, bf16=False):
    """qwen2.5-32b-mla at full width cut to 4 layers: the model step on
    latent pages through K4 against the latent einsum, then the 16
    requests on the dense latent cache (einsum only, no kernel) and on
    latent pages (every paged attention through K4); streams compared.
    With ``bf16``, then the bf16 leg on the same weights: the model step
    on bf16 latent pages, kernel against einsum in lockstep, and the 16
    requests on bf16 latent pages through K4's bf16 entry (a tick with
    every slot freed finite after). Returns K4's launches (the bf16 ones
    as "decode_bf16" / "prefill_bf16") and each run's serving metrics."""
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
    del paged
    torch.cuda.empty_cache()
    if bf16:
        phase18_model_step(model, params, "bf16 latent pages",
                           PagedLatentBackend(PS, SLOTS * mps))
        got, b_reqs, b_firsts, m, _ = serve_bf16(
            model, params, prompts, card, "bf16 latent pages",
            ("decode_latent_bf16", "prefill_latent_bf16"), page_size=PS,
            kv_backend="paged_latent")
        launches.update({f"{k}_bf16": v for k, v in got.items()})
        served["bf16_latent_pages"] = m
        compare_streams("bf16 latent pages", (b_reqs, b_firsts),
                        "latent pages", (p_reqs, p_firsts), strict=False)
    del model, params
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


def gemm_bits_held(label, x, w, errs):
    """K7 on (x, w) in every dataflow against the plain version (each
    dataflow's worst error kept in ``errs``): the dataflows give the same
    bits, and so does a second launch; then K8 on w's per-channel int8
    form gives K7's bits on the dequantized operand (``errs``'s
    "quant_matmul" kept too)."""
    want = ref.matmul(x, w)
    outs = [mm.matmul(x, w, dataflow=df) for df in DATAFLOWS]
    for df, got in zip(DATAFLOWS, outs):
        errs[df] = max(errs[df], gemm_held(f"K7 {df} {label}", got, want))
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError(f"K7 {label}: dataflows differ in bits")
    if not torch.equal(outs[0], mm.matmul(x, w)):
        raise AssertionError(f"K7 {label}: a second launch differs in bits")
    qt = quantize_per_channel(w)
    w_q, sc = qt.q, qt.scale.reshape(-1)
    got = qm.quant_matmul(x, w_q, sc)
    errs["quant_matmul"] = max(errs["quant_matmul"], gemm_held(
        f"K8 {label}", got, ref.quant_matmul(x, w_q, sc)))
    if not torch.equal(got, mm.matmul(x, w_q.float() * sc[None, :])):
        raise AssertionError(f"K8 {label}: not K7's bits on the dequantized "
                             f"weight")


def phase2_gemm_cases():
    """K7 in every dataflow and K8 against their plain versions
    (``gemm_bits_held``): the test shapes, the 21 ResNet20 GEMMs at batch
    1 and 256 (K8 on per-channel int8 weights), qwen2.5-32b's wo at M = 8,
    the 41 gradient GEMMs of a batch-TRAIN_BATCH training step on the
    backward's transposed views, and bf16 cases. The three dataflows and a
    second launch must give the same bits, and K8 the bits of K7 on the
    dequantized weight. Returns max |diff| per kernel row."""
    gen = torch.Generator(DEV).manual_seed(20)
    errs = {df: 0.0 for df in DATAFLOWS}
    errs["quant_matmul"] = 0.0
    cases = gemm_cases() + [("lm wo",) + LM_PROJ]
    for label, M, K, N in cases:
        x = rand_on_card(gen, M, K)
        gemm_bits_held(label, x, rand_on_card(gen, K, N) * (2.0 / K) ** 0.5,
                       errs)
    backward = 0
    for gemms in backward_gemms(gen, TRAIN_BATCH).values():
        for label, x, w in gemms:
            gemm_bits_held(label, x, w, errs)
            backward += 1
    log(f"  K7 x {len(DATAFLOWS)} dataflows and K8 on {len(cases)} shapes "
        f"and the {backward} dW / dX GEMMs of a batch-{TRAIN_BATCH} ResNet20 "
        f"step (split and wide schedules, the backward's transposed views): "
        f"max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; dataflows bit-equal; a second launch bit-equal; K8 == K7 on "
        "the dequantized weight")
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
            ls.LAUNCHES.values()) != cfg.num_layers or fa.LAUNCHES != \
            flash_counts(forward=flash):
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
    for attempt in range(6):  # a session may come back without events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation) / 1e3
        if busy_ms > 0:
            break
        log(f"  (profiler session {attempt + 1} of {label} without device "
            f"events; again)")
        time.sleep(0.05 * 2 ** attempt)
    else:
        raise AssertionError(f"{label}: no profiler session with device "
                             f"events")
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
    batch = {"token": tok, **engine._prefill_extras(engine.batch_slots)}
    tick = host_and_device(
        lambda: engine._decode(engine.params, engine.cache, batch),
        f"{label}: one decode tick ({engine.batch_slots} slots)", card)
    chunk = {"tokens": torch.from_numpy(prompt[:64]).long()[None].to(DEV),
             **engine._prefill_extras(1)}
    first = host_and_device(
        lambda: engine._chunk_first(engine.params, chunk),
        f"{label}: one 64-token first chunk", card)
    return {"tick": tick, "chunk": first}


def scan_shapes_of(fn, hist):
    """``fn`` (``ls.wkv6`` or ``ls.selective_scan``) that also counts the
    (B, T, heads or channels) of each call in ``hist``."""
    def counted(*args, **kwargs):
        key = tuple(args[0].shape[:3])
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
            or fa.LAUNCHES != flash_counts(prefill=flash)
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
    log(f"  {kernel} launches by (B, T, heads or channels): " + ", ".join(
        f"{key}: {n}" for key, n in sorted(hist.items(),
                                           key=lambda kv: -kv[1])))
    tick_and_chunk(engine, prompts[0], card, label)
    return reqs, firsts, {"chunk": layers * m["prefill_chunks"],
                          "tick": layers * m["decode_steps"]}, flash


def phase9_rwkv(card):
    """rwkv6-7b at full width: the forward and the step path through K5
    against the plain recurrence on the first CHECK_LAYERS layers, then
    the 16 requests at RWKV_LAYERS on the dense cache (rwkv has nothing to
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


# ------------------------------------------------------- phases 12-15
# the depth each is served at: memory cuts dbrx (13.0 GB a layer) and
# command-r (2.8 GB a layer beside two 8.4 GB vocab tables); the VLM keeps
# 2 of its 8 super-layers (depth a multiple of cross_attn_every = 5);
# whisper runs whole (32 encoder and 32 decoder layers)
FAMILY_LAYERS = {CMDR: 4, DBRX: 2, VISION: 10, WHISPER: 32}


def build_family(arch):
    """``ServeEngine.build`` of ``arch`` at full width, cut to
    FAMILY_LAYERS (the dense-cache engine is dropped; the phases build
    their own over its weights). Returns (model, params)."""
    layers = FAMILY_LAYERS[arch]
    t0 = time.perf_counter()
    engine = ServeEngine.build(arch, config=ServeConfig(
        reduced=False, cfg_overrides={"num_layers": layers}, s_max=S_MAX,
        batch_slots=SLOTS))
    torch.cuda.synchronize()
    model, params = engine.model, engine.params
    del engine
    torch.cuda.empty_cache()
    n = sum(t.numel() for t in _leaves(params))
    full = configs.get_config(arch).num_layers
    log(f"  {arch} at full width, {layers} of {full} layers"
        + (f" (+ {model.cfg.encoder_layers} encoder layers)"
           if model.cfg.encoder_layers else "")
        + f": {n / 1e9:.3f} B params, {4 * n / 1e9:.2f} GB fp32; built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model, params


def tick_floor(model, params, batch=SLOTS) -> dict:
    """The least time of one decode tick of ``batch`` slots: the bytes it
    must read once (every weight but the encoder's; of an untied embedding
    table and of whisper's position table only the batch's rows; every
    expert, since the dense GShard dispatch reads them all; whisper's
    cross K/V of every slot; the VLM's image embeddings) at the HBM rate,
    against the VLM's image re-projection (each cross block projects every
    slot's image tokens through wk and wv) at the fp32 peak. The K/V of an
    idle engine's tick are not counted."""
    cfg = model.cfg
    nbytes = 0
    for key, tree in params.items():
        leaves = list(_leaves(tree)) if isinstance(tree, dict) else [tree]
        if key in ("enc_layers", "enc_norm"):
            continue
        if key == "pos_dec" or (key == "embed" and "unembed" in params):
            nbytes += batch * leaves[0].shape[-1] * leaves[0].element_size()
        else:
            nbytes += sum(t.numel() * t.element_size() for t in leaves)
    kvw = cfg.num_kv_heads * cfg.head_dim
    flops = 0
    if cfg.encoder_layers:
        nbytes += 2 * cfg.num_layers * batch * encdec.ENC_LEN * kvw * 4
    if cfg.cross_attn_every:
        t_img = cfg.num_image_tokens
        nbytes += batch * t_img * cfg.d_model * 4
        flops = (cfg.num_layers // cfg.cross_attn_every) * 2 * (
            2 * batch * t_img * cfg.d_model * kvw)
    ms, by = roofline(nbytes, flops)
    log(f"  {cfg.name}: a decode tick of {batch} slots reads at least "
        f"{nbytes / 1e9:.2f} GB ({nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
        + (f" and computes {flops / 1e9:.0f} GFLOP of image re-projection "
           f"({flops / FP32_FLOPS * 1e3:.2f} ms at "
           f"{FP32_FLOPS / 1e12:.0f} TFLOP/s)" if flops else "")
        + f": floor {ms:.2f} ms ({by})")
    return dict(ms=ms, by=by, bytes=nbytes, flops=flops)


def flash_counts(**want) -> dict:
    """``fa.LAUNCHES`` as it should read: the named counts, every other
    key (the bf16 entries' among them) 0."""
    return {k: want.get(k, 0) for k in fa.LAUNCHES}


def launches_held(label, want_paged, want_flash):
    """The launch counts of a run against the wanted ones: every key of
    ``pa.LAUNCHES`` / ``fa.LAUNCHES`` not named is 0, every named one
    equals its count, which is > 0 (the dense cache's and whisper's runs,
    where K2 takes the first chunks)."""
    got_p, got_f = dict(pa.LAUNCHES), dict(fa.LAUNCHES)
    want_p = {k: want_paged.get(k, 0) for k in got_p}
    want_f = {k: want_flash.get(k, 0) for k in got_f}
    if (got_p != want_p or got_f != want_f or not all(
            list(want_paged.values()) + list(want_flash.values()))):
        raise AssertionError(f"{label}: launches {got_p}, {got_f}; want "
                             f"{want_p}, {want_f}")
    log(f"  {label} launches: " + ", ".join(
        f"{k} {v}" for k, v in list(want_paged.items())
        + [(f"flash {k}", v) for k, v in want_flash.items()]))


# the engine's step functions, by the kind of call that makes them: the
# decode tick and the prefill chunks
ENGINE_STEPS = {"_decode": "tick", "_chunk_paged": "chunk",
                "_chunk_first": "chunk", "_chunk_cont": "chunk",
                "_prefill_scan": "chunk"}


def tag_moe_calls(engine, trace):
    """Wraps the engine's step functions so that the ``moe`` routings each
    appends to ``trace`` carry the call that made them ("tick" or
    "chunk"). Returns the unhook."""
    saved = {attr: getattr(engine, attr) for attr in ENGINE_STEPS}

    def tagged(fn, call):
        def step(*args):
            n = len(trace)
            out = fn(*args)
            for t in trace[n:]:
                t["call"] = call
            return out
        return step

    for attr, call in ENGINE_STEPS.items():
        setattr(engine, attr, tagged(saved[attr], call))

    def unhook():
        for attr, fn in saved.items():
            setattr(engine, attr, fn)
    return unhook


def serve_family(model, params, prompts, card, label, floor, moe_trace=None,
                 **fields):
    """The 16 requests on an engine of ``fields`` (8 slots, s_max 1024)
    over the family's weights, the launch counts set to 0 just before and
    read just after, the MoE routings of that run alone appended to
    ``moe_trace`` (a list, or None for no trace) tagged by call; then one
    tick and one first chunk profiled (``tick_and_chunk``) and ITL p50 set
    beside the tick's ``floor``. Returns (requests, first-token logits,
    metrics, first chunks run, the profile)."""
    engine = ServeEngine(model, params, **ServeConfig(
        reduced=False, s_max=S_MAX, batch_slots=SLOTS,
        **fields).engine_kwargs())
    n_first = [0]
    first = engine._chunk_first

    def counted(*args):
        n_first[0] += 1
        return first(*args)

    engine._chunk_first = counted
    unhook = (tag_moe_calls(engine, moe_trace) if moe_trace is not None
              else lambda: None)
    pa.reset_launches()
    fa.reset_launches()
    layers_mod.MOE_TRACE = moe_trace
    try:
        reqs, m, firsts = serve(engine, prompts)
    finally:
        layers_mod.MOE_TRACE = None
        unhook()
        engine._chunk_first = first
    if engine.paged:
        engine.assert_page_invariants()
    log(f"  {label}: {type(engine.backend).__name__}, attn "
        f"{engine.paged_attn_impl}, incremental splice "
        f"{engine.incremental_splice}, prefix cache {engine.prefix_cache}, "
        f"resident cache {engine.resident_cache_bytes()} bytes")
    log_serving(m, card)
    if engine.prefix_cache:
        log(f"  prefix: {m['prefix']['hits']} hits of "
            f"{m['prefix']['lookups']} lookups, {m['prefix']['cow_copies']} "
            f"COW copies")
    saved = dict(pa.LAUNCHES), dict(fa.LAUNCHES)
    prof = tick_and_chunk(engine, prompts[0], card, label)
    pa.LAUNCHES.update(saved[0])
    fa.LAUNCHES.update(saved[1])
    log(f"  {label}: ITL p50 {m['itl_s']['p50'] * 1e3:.2f} ms, one idle "
        f"tick {prof['tick']['wall_ms']:.2f} ms host wall (device idle "
        f"{prof['tick']['idle']:.1%}), against the tick's floor "
        f"{floor['ms']:.2f} ms ({floor['by']}) ({card})")
    del engine
    torch.cuda.empty_cache()
    return reqs, firsts, m, n_first[0], prof


def paged_family(model, params, prompts, card, label, floor, **fields):
    """``serve_family`` on pages of 16 through the incremental splice:
    the paged kernel (K1; K3 on int8 pages) launched layers x decode steps
    and layers x prefill chunks, nothing else. Returns (requests,
    first-token logits, metrics, the kernel's launches {"decode",
    "prefill"}, the profile)."""
    reqs, firsts, m, _, prof = serve_family(
        model, params, prompts, card, label, floor, page_size=PS, **fields)
    q8 = "_q8" if fields.get("kv_backend") == "paged_int8" else ""
    launches = check_paged_launches(("decode" + q8, "prefill" + q8), m,
                                    label, model.cfg.num_layers)
    return reqs, firsts, m, launches, prof


def phase12_command_r(card):
    """command-r-35b (LayerNorm, 64 query heads over 8 kv heads) at full
    width, 4 layers: the model step through K1 against the einsum, then
    the 16 requests on fp32 pages. Returns K1's launches and the serving
    metrics."""
    model, params = build_family(CMDR)
    phase3_model(model, params)
    prompts = serve_prompts(model.cfg.vocab_size)
    floor = tick_floor(model, params)
    _, _, m, launches, _ = paged_family(model, params, prompts, card,
                                        "command-r fp32 pages", floor)
    del model, params
    torch.cuda.empty_cache()
    return launches, m


def moe_share(model, params, tick_ms, card):
    """The MoE layers' device time at a decode tick's shape (8 slots, one
    token each; CUDA events around each layer's ``moe``) and their share
    of the tick's host wall."""
    cfg = model.cfg
    x = torch.randn((SLOTS, 1, cfg.d_model), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(4))
    dims = layers_mod.MoEDims(cfg.d_model, cfg.d_ff, cfg.moe.num_experts,
                              cfg.moe.top_k, cfg.moe.capacity_factor)
    ms = sum(time_ms(lambda: layers_mod.moe(
        layers_mod.layer_params(params["layers"], i)["moe"], x, dims), 10)
        for i in range(cfg.num_layers))
    log(f"  MoE dispatch and experts at a tick ({SLOTS} tokens, "
        f"{cfg.num_layers} layers): {ms:.3f} ms, {ms / tick_ms:.1%} of the "
        f"tick's {tick_ms:.2f} ms host wall ({card})")
    return ms


def phase13_dbrx(card):
    """dbrx-132b (16 experts, top 4, GShard capacity) at full width, 2
    layers: the model step through K1 and on int8 pages through K3, each
    against its einsum, with the routing traced; then the 16 requests on
    fp32 pages (K1), on int8 pages (K3) and on the dense cache (first
    chunks through K2), the capacity drops of the fp32 run counted by
    call. Returns K1's launches, K2's on the dense cache's first chunks
    and each run's metrics."""
    model, params = build_family(DBRX)
    layers = model.cfg.num_layers
    phase3_model(model, params)
    phase3_model(model, params, PagedInt8Backend(PS, SLOTS * S_MAX // PS),
                 "int8 pages", Q8_MODEL_TOL)
    prompts = serve_prompts(model.cfg.vocab_size)
    floor = tick_floor(model, params)
    trace = []
    p_reqs, p_firsts, m, launches, prof = paged_family(
        model, params, prompts, card, "dbrx fp32 pages", floor,
        moe_trace=trace)
    served = {"fp32_pages": m}
    ticks = [t for t in trace if t["call"] == "tick"]
    chunks = [t for t in trace if t["call"] == "chunk"]
    for name, ts in (("decode ticks", ticks), ("prefill chunks", chunks)):
        drops = sum(int((~t["kept"]).sum()) for t in ts)
        choices = sum(t["kept"].numel() for t in ts)
        log(f"  dbrx serving, {name}: {drops} of {choices} routed (token, "
            f"k) choices dropped ({drops / max(choices, 1):.2%}) over "
            f"{len(ts) // layers} calls x {layers} layers")
    del ticks, chunks
    moe_share(model, params, prof["tick"]["wall_ms"], card)
    q_trace, d_trace = [], []
    q_reqs, q_firsts, m, _, _ = paged_family(
        model, params, prompts, card, "dbrx int8 pages", floor,
        kv_backend="paged_int8", moe_trace=q_trace)
    served["int8_pages"] = m
    d_reqs, d_firsts, m, n_first, _ = serve_family(
        model, params, prompts, card, "dbrx dense cache", floor,
        moe_trace=d_trace)
    flash = layers * n_first
    launches_held("dbrx dense cache", {}, {"prefill": flash})
    served["dense"] = m
    # MoE streams across caches agree only as far as their routing does:
    # the streams are reported, not held, and where the routing parts the
    # trace says why (a near-tie, or calls batched otherwise)
    compare_streams("fp32 pages", (p_reqs, p_firsts), "int8 pages",
                    (q_reqs, q_firsts), strict=False)
    routing_divergence("fp32 pages", trace, "int8 pages", q_trace)
    compare_streams("fp32 pages", (p_reqs, p_firsts), "dense cache",
                    (d_reqs, d_firsts), strict=False)
    routing_divergence("fp32 pages", trace, "dense cache", d_trace)
    del trace, q_trace, d_trace
    del model, params
    torch.cuda.empty_cache()
    return launches, flash, served


def phase14_vision(card):
    """llama-3.2-vision-11b at full width, 10 layers (2 super-layers of 5
    blocks and a cross block), its cross gates perturbed (``repro`` starts
    them at 0): the forward on seeded image embeddings through K2 against
    the einsum, the model step through K1 against the einsum on seeded
    image embeddings, then the 16 requests on fp32 pages, served on zero
    image embeddings as ``repro`` serves them. Returns K1's launches and
    the serving metrics."""
    model, params = build_family(VISION)
    cfg = model.cfg
    gen = torch.Generator(device=DEV).manual_seed(14)
    gate = params["super"]["cross"]["gate"]
    gate.copy_(torch.randn(gate.shape, device=DEV, generator=gen))

    def images(batch):
        return {"image_embeds": torch.randn(
            (batch, cfg.num_image_tokens, cfg.d_model), device=DEV,
            generator=gen)}

    B, S = FORWARD_BATCH
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=DEV,
                         generator=gen)
    img = images(B)
    runs = {}
    for impl in ("pallas", "einsum"):
        fa.reset_launches()
        logits, _ = model.forward(params, toks, attn_impl=impl, **img)
        torch.cuda.synchronize()
        if fa.LAUNCHES["forward"] != (cfg.num_layers if impl == "pallas"
                                      else 0):
            raise AssertionError(f"VLM forward ({impl}) launched K2 "
                                 f"{fa.LAUNCHES} times")
        runs[impl] = ([logits], logits[..., :cfg.vocab_size].argmax(-1))
    log(f"  VLM forward (B={B}, S={S}, {cfg.num_image_tokens} image "
        f"tokens, seeded gates): K2 launched {cfg.num_layers} times")
    compare_runs(runs, cfg, "pallas", "einsum")
    del runs, img
    phase3_model(model, params, label="fp32 pages, seeded image embeddings",
                 extras=images(SLOTS))
    prompts = serve_prompts(cfg.vocab_size)
    floor = tick_floor(model, params)
    _, _, m, launches, _ = paged_family(model, params, prompts, card,
                                        "vision fp32 pages", floor)
    del model, params
    torch.cuda.empty_cache()
    return launches, m


def whisper_step(model, params):
    """Whisper's serving step at full width, twice: the transient first
    chunk of 8 slots x 64 tokens (one encoder pass over seeded frames, the
    cross K/V, the decoder's self-attention through K2, then through the
    einsum), its logits and cache leaves within MODEL_TOL of each other;
    each run's cache spliced into fp32 pages, then 8 greedy decode steps
    from it, through K1 after the K2 chunk and through the einsum after
    the einsum chunk; logits within MODEL_TOL and tokens equal."""
    cfg = model.cfg
    layers = cfg.num_layers
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, 64))
                            ).to(DEV)
    frames = torch.from_numpy(rng.standard_normal(
        (SLOTS, encdec.ENC_LEN, cfg.d_model)).astype(np.float32)).to(DEV)
    firsts = {}
    for impl in ("pallas", "einsum"):
        fa.reset_launches()
        first = steps.make_prefill_chunk(model, s_max=S_MAX, first=True,
                                         attn_impl=impl,
                                         compute_dtype=torch.float32)
        firsts[impl] = first(params, {"tokens": toks, "frames": frames})
        torch.cuda.synchronize()
        want = layers if impl == "pallas" else 0
        if fa.LAUNCHES != flash_counts(prefill=want):
            raise AssertionError(f"whisper first chunk ({impl}) launched K2 "
                                 f"{fa.LAUNCHES}")
    del frames
    (_, a), (_, b) = firsts["pallas"], firsts["einsum"]
    for leaf in ("k", "v", "xk", "xv"):
        err = (a[leaf] - b[leaf]).abs().max().item()
        log(f"  whisper first chunk cache {leaf!r}: max abs diff K2 vs "
            f"einsum {err:.3e} (tol {MODEL_TOL})")
        if not (torch.isfinite(a[leaf]).all() and torch.allclose(
                a[leaf], b[leaf], rtol=MODEL_TOL, atol=MODEL_TOL)):
            raise AssertionError(f"whisper first chunk cache {leaf}: {err}")
    del a, b
    mps = S_MAX // PS
    bt = torch.arange(SLOTS * mps, dtype=torch.int32,
                      device=DEV).reshape(SLOTS, mps)
    slots = torch.arange(SLOTS, device=DEV)
    phys = (bt.long()[:, :, None] * PS
            + torch.arange(PS, device=DEV)).reshape(SLOTS, S_MAX)
    runs = {}
    for chunk_impl, impl in (("pallas", "kernel"), ("einsum", "einsum")):
        logits0, rcache = firsts.pop(chunk_impl)
        cache = init_paged_cache(model, SLOTS, S_MAX, page_size=PS,
                                 num_pages=SLOTS * mps, device=DEV)
        cache["block_tables"].copy_(bt)
        insert_cache_rows_paged(cache, rcache, slots, phys)
        del rcache
        cache["pos"].fill_(64)
        pa.reset_launches()
        t0 = time.perf_counter()
        seq, tok = [logits0], logits0[:, :, :cfg.vocab_size].argmax(-1)
        tokens = [tok]
        for _ in range(8):
            logits, cache = model.decode_step(params, tok, cache,
                                              paged_attn_impl=impl)
            tok = logits[:, :, :cfg.vocab_size].argmax(-1)
            seq.append(logits)
            tokens.append(tok)
        torch.cuda.synchronize()
        if pa.LAUNCHES["decode"] != (8 * layers if impl == "kernel" else 0):
            raise AssertionError(f"whisper decode ({impl}): {pa.LAUNCHES}")
        log(f"  whisper first chunk {chunk_impl}, decode impl={impl}: 8 "
            f"paged decode steps in {time.perf_counter() - t0:.3f} s (host "
            f"clock), {pa.LAUNCHES['decode']} K1 launches")
        runs[impl] = (seq, torch.cat(tokens, 1))
        del cache
    compare_runs(runs, cfg, "kernel", "einsum")
    del runs
    torch.cuda.empty_cache()


def phase15_whisper(card):
    """whisper-large-v3 whole (32 encoder, 32 decoder layers): the encoder
    on seeded frames (2 x 1500) through K2, not causal, against the
    einsum; the serving step (``whisper_step``); then the 16 requests on
    fp32 pages: prefill through the transient path (an encoder pass per
    request group, the first chunks' self-attention through K2), decode
    through K1, as ``repro`` serves whisper. Returns K1's decode launches,
    K2's ({"prefill": serving's first chunks, "forward": the encoder
    forward}) and the serving metrics."""
    model, params = build_family(WHISPER)
    cfg = model.cfg
    B, S = FLASH_SHAPES["forward_whisper"][1:]
    frames = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).to(DEV)
    outs = {}
    for impl in ("pallas", "einsum"):
        fa.reset_launches()
        outs[impl] = encdec.encode(params, cfg, frames, attn_impl=impl)
        torch.cuda.synchronize()
        if impl == "pallas":
            enc_launches = fa.LAUNCHES["forward"]
            if enc_launches != cfg.encoder_layers or fa.LAUNCHES["prefill"]:
                raise AssertionError(f"whisper encoder launched K2 "
                                     f"{fa.LAUNCHES}")
    err = (outs["pallas"] - outs["einsum"]).abs().max().item()
    log(f"  whisper encoder (B={B}, {S} frames, not causal): K2 launched "
        f"{enc_launches} times; features max abs diff K2 vs einsum "
        f"{err:.3e} (tol {MODEL_TOL})")
    if not (torch.isfinite(outs["pallas"]).all() and torch.allclose(
            outs["pallas"], outs["einsum"], rtol=MODEL_TOL, atol=MODEL_TOL)):
        raise AssertionError(f"whisper encoder: K2 vs einsum {err}")
    del outs, frames
    whisper_step(model, params)
    prompts = serve_prompts(cfg.vocab_size)
    floor = tick_floor(model, params)
    _, _, m, n_first, _ = serve_family(model, params, prompts, card,
                                       "whisper fp32 pages", floor,
                                       page_size=PS)
    layers = cfg.num_layers
    launches = {"decode": layers * m["decode_steps"]}
    flash = {"prefill": layers * n_first, "forward": enc_launches}
    launches_held("whisper fp32 pages", launches,
                  {"prefill": flash["prefill"]})
    del model, params
    torch.cuda.empty_cache()
    return launches, flash, m


# ---------------------------------------------- phase 16: ResNet20 training
# the paper's ResNet20 trained at batch TRAIN_BATCH on synthetic_cifar(4096,
# seed=1) with the example's AdamW, through K7 (im2col, output-stationary)
# and through the plain route (im2col with ``@``)
TRAIN_BATCH, TRAIN_STEPS = 128, 20
# step 1, K7 against the plain route: the loss, and every gradient leaf
# within TRAIN_GRAD_TOL of the leaf's largest magnitude. The routes differ
# only in how each GEMM sums (K7 one FMA chain per element, cuBLAS blocked),
# and the dW GEMMs sum 131,072 products at stage 1: GEMM_TOL's margin
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, GEMM_TOL
# the two routes' losses over TRAIN_STEPS steps: AdamW's sign-like first
# steps turn last-bit gradient differences into update differences of the
# learning rate's order where a gradient is near zero, so the trajectories
# part slowly; a CPU run of the reference against the port (the same
# network through other convolutions) stayed within 2e-4 over 20 steps
TRAIN_TRAJ_TOL = 1e-3
GEMM_ROLES = ("forward", "dX", "dW")


def gemm_role(x, w) -> str:
    """Which GEMM of a training step a K7 call is: the backward runs
    dX = g W^T on w's transposed view and dW = X^T g on x's (``ops._Matmul``),
    the forward on the contiguous im2col patches and weight."""
    if w.dim() == 2 and w.stride(0) == 1 and w.stride(1) != 1:
        return "dX"
    if x.dim() == 2 and x.stride(0) == 1 and x.stride(1) != 1:
        return "dW"
    return "forward"


@contextlib.contextmanager
def gemm_roles():
    """Count the K7 calls by role (``gemm_role``) while the block runs; the
    counts must add up to ``mm.LAUNCHES``'s, which the wrapper raises where
    it launches the kernel."""
    roles = dict.fromkeys(GEMM_ROLES, 0)
    orig = mm.matmul

    def counted(x, w, **kw):
        roles[gemm_role(x, w)] += 1
        return orig(x, w, **kw)
    mm.matmul = counted
    try:
        yield roles
    finally:
        mm.matmul = orig


def resnet_routes():
    """Phase 16's two routes: every conv GEMM through K7, or through ``@``."""
    return {"K7": dict(impl="im2col", matmul_fn=ops.matmul),
            "plain": dict(impl="im2col")}


def resnet_trainer(route):
    """``step(params, opt_state, i) -> (params, opt_state, loss)``: one
    AdamW step (the example's: lr 3e-3, weight decay 1e-4) on batch i of
    the training images, and ``grads(params, i)``."""
    xs, ys = (torch.from_numpy(a).to(DEV)
              for a in synthetic_cifar(4096, seed=1))
    grad_fn = steps.value_and_grad(resnet_example.loss_fn(RESNET, route))
    opt = AdamW(learning_rate=3e-3, weight_decay=1e-4)

    def batch(i):
        j = (i * TRAIN_BATCH) % (len(ys) - TRAIN_BATCH)
        return {"x": xs[j:j + TRAIN_BATCH], "y": ys[j:j + TRAIN_BATCH]}

    def step(params, opt_state, i):
        (loss, _), grads = grad_fn(params, batch(i))
        updates, opt_state, _ = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss
    return opt, step, lambda params, i: grad_fn(params, batch(i))


def named_leaves(tree, prefix=""):
    """(name, leaf) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree)
                for nl in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [nl for i, v in enumerate(tree)
                for nl in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def grads_held(got, want) -> float:
    """Every leaf of ``got`` within TRAIN_GRAD_TOL of the largest magnitude
    of ``want``'s leaf; returns the worst such ratio."""
    worst = 0.0
    for (name, g), (_, w) in zip(named_leaves(got), named_leaves(want)):
        scale = max(w.abs().max().item(), 1e-30)
        ratio = (g - w).abs().max().item() / scale
        if not torch.isfinite(g).all() or ratio > TRAIN_GRAD_TOL:
            raise AssertionError(f"step 1 gradient {name}: K7 differs from "
                                 f"the plain route by {ratio:.3e} of its "
                                 f"largest magnitude")
        worst = max(worst, ratio)
    return worst


def backward_gemms(gen, batch):
    """Seeded operands of the two gradient GEMMs of each conv at ``batch``,
    with the strides the backward gives them: dX = g @ W^T (not for the
    stem, whose input needs no gradient) and dW = X^T @ g, X the im2col
    patches. Returns {role: [(label, x, w), ...]}."""
    out = {"dX": [], "dW": []}
    for i, (name, M, K, N) in enumerate(resnet.conv_layer_shapes(RESNET,
                                                                 batch)):
        x = rand_on_card(gen, M, K)
        w = rand_on_card(gen, K, N) * (2.0 / K) ** 0.5
        g = rand_on_card(gen, M, N) * 1e-3
        if i:
            out["dX"].append((f"{name} dX ({M}x{N}x{K})", g, w.t()))
        out["dW"].append((f"{name} dW ({K}x{M}x{N})", x.t(), g))
    return out


def describe_plan(plan) -> str:
    """K7's schedule, grid and staging for a GEMM, as ``mm.tile_plan``
    gives it (an older tree's plan, timed by chip_ab.py, has no schedule
    field but ``skinny``, and no split)."""
    schedule = getattr(plan, "schedule",
                       "skinny" if plan.skinny else "tiled")
    what = f"{schedule}: {plan.blocks} blocks of {plan.bm}x{plan.bn}"
    if getattr(plan, "splits", 1) > 1:
        what += f", {plan.splits} ranges of {plan.kc} rows"
    elif schedule == "wide":
        what += f", {plan.group} M-tile(s) each, w resident"
    else:
        what += f", {plan.chunks} K-chunk(s)"
    return what + f", x {'16-byte' if plan.vec_x else '4-byte'} copies"


def phase2_backward_gemms(card):
    """Phase 16e, run with phase 2's timings: K7's dX and dW GEMMs of one
    batch-TRAIN_BATCH ResNet20 training step, each group summed: the
    kernel's and ``torch.matmul``'s device time after the L2 flush
    (``device_times``: every kernel launch of a call, so a split GEMM's
    partials and their sum, whose launches are counted and must be two),
    the plain version's between events, and the bound (bytes at the HBM
    rate or fp32 FMAs at the fp32 peak, the larger, per GEMM, summed).
    Each GEMM held against the plain version; its schedule logged. Timed
    here, early in the run: late in a long run, after phase 16's profiles
    of whole training steps, the profiler came back with 2 of 10 calls in
    session after session. Returns {role: row}."""
    gen = torch.Generator(DEV).manual_seed(16)
    rows = {}
    for role, gemms in backward_gemms(gen, TRAIN_BATCH).items():
        err = max(gemm_held(f"K7 {label}", mm.matmul(x, w),
                            ref.matmul(x, w)) for label, x, w in gemms)
        launched = []
        ms = device_times([lambda x=x, w=w: mm.matmul(x, w)
                           for _, x, w in gemms], 10,
                          (SPLIT_SUM_KERNEL, GEMM_KERNEL), launched)
        lib = device_times([lambda x=x, w=w: torch.matmul(x, w)
                            for _, x, w in gemms], 10)
        plain = [time_ms(lambda x=x, w=w: ref.matmul(x, w), 10)
                 for _, x, w in gemms]
        bounds = [gemm_bound(x.shape[0], x.shape[1], w.shape[1])
                  for _, x, w in gemms]
        log(f"  {role} GEMMs of a batch-{TRAIN_BATCH} step, device ms: K7 | "
            f"torch.matmul | bound; K7's plan and kernel launches a call")
        for i, (label, x, w) in enumerate(gemms):
            plan = mm.plan_for(x, w, mm.launch_geometry(x, w))
            want = 2 if getattr(plan, "splits", 1) > 1 else 1
            if launched[i] not in (None, want):
                raise AssertionError(f"K7 {label}: {launched[i]} kernel "
                                     f"launches a call, want {want}")
            log(f"    {label}: {ms[i]:.4f} | {lib[i]:.4f} | "
                f"{bounds[i][0]:.4f} ({bounds[i][1]}); {describe_plan(plan)}"
                f"; {launched[i]} launch(es)")
        row = dict(ms=sum(ms), plain_ms=sum(plain), library_ms=sum(lib),
                   err=err, gemms=len(gemms), launches_per_step=sum(
                       n for n in launched if n is not None))
        row["bound_ms"], row["bound_by"] = sum_bounds(bounds)
        log(f"  K7 [{role}], {len(gemms)} GEMMs: kernel {row['ms']:.4f} ms | "
            f"plain {row['plain_ms']:.4f} ms | torch.matmul "
            f"{row['library_ms']:.4f} ms | bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) | {row['ms'] / row['library_ms']:.2f}x "
            f"the library, {row['ms'] / row['bound_ms']:.2f}x the bound | "
            f"max abs err {err:.3e} ({card})")
        rows[role] = row
    torch.cuda.empty_cache()
    return rows


def phase16_step_cost(card, init=None, trainers=None) -> dict:
    """Phase 16(d): one AdamW step from ``init`` (phase 16's seeded init
    where None) through K7 and through the plain route (``trainers``, as
    ``resnet_trainer`` builds them where None): the host wall, the device's
    busy time and idle share (``host_and_device``). Returns {route:
    cost}."""
    if init is None:
        init = resnet.init(RESNET, torch.Generator(DEV).manual_seed(16), DEV)
    if trainers is None:
        trainers = {name: resnet_trainer(route)
                    for name, route in resnet_routes().items()}
    cost = {}
    for name in ("K7", "plain"):
        opt, step_fn, _ = trainers[name]
        opt_state = opt.init(init)
        cost[name] = host_and_device(
            lambda: step_fn(init, opt_state, 0),
            f"(d) one training step through {name}, batch {TRAIN_BATCH}",
            card)
    return cost


def phase16_resnet_training(card):
    """ResNet20 at the paper's widths (16 / 32 / 64) trained with AdamW at
    batch TRAIN_BATCH, TF32 off, from one seeded init through K7 and
    through the plain route: (a) step 1's loss and every gradient leaf
    held; (b) TRAIN_STEPS steps each, losses held step by step and falling;
    (c) K7's launches by role, per step, counted in (b)'s run (the main
    path); (d) a step's host wall, device busy time and idle share; (f) BN
    folded and fp32 / fixed16 / int8 accuracy on synthetic_cifar(1024,
    seed=2), then the example in its own process. (e), the backward GEMMs
    timed, runs with phase 2 (``phase2_backward_gemms``). Returns (K7
    launches by role in (b), the step costs)."""
    init = resnet.init(RESNET, torch.Generator(DEV).manual_seed(16), DEV)
    routes = resnet_routes()
    trainers = {name: resnet_trainer(route) for name, route in
                routes.items()}
    mm.reset_launches()
    with gemm_roles() as roles:
        (k7_loss, _), k7_grads = trainers["K7"][2](init, 0)
        torch.cuda.synchronize()
    (plain_loss, _), plain_grads = trainers["plain"][2](init, 0)
    want = {"forward": 21, "dX": 20, "dW": 21}
    if roles != want or mm.LAUNCHES["output_stationary"] != 62:
        raise AssertionError(f"one K7 step launched {mm.LAUNCHES} by role "
                             f"{roles}; want {want}")
    dl = abs(k7_loss.item() - plain_loss.item())
    if not torch.isfinite(k7_loss) or dl > TRAIN_LOSS_TOL:
        raise AssertionError(f"step 1 loss: K7 {k7_loss.item()} against "
                             f"plain {plain_loss.item()}")
    worst = grads_held(k7_grads, plain_grads)
    log(f"  (a) step 1: loss {k7_loss.item():.6f} (K7) vs "
        f"{plain_loss.item():.6f} (plain), |diff| {dl:.3e}; "
        f"{len(named_leaves(k7_grads))} gradient leaves, worst "
        f"{worst:.3e} of a leaf's largest magnitude (tolerance "
        f"{TRAIN_GRAD_TOL})")
    log(f"  (c) one K7 step: {roles['forward']} forward + {roles['dX']} dX "
        f"(the stem's input needs no gradient) + {roles['dW']} dW = "
        f"{sum(roles.values())} launches")
    del k7_grads, plain_grads

    losses, trained = {}, {}
    for name in ("plain", "K7"):
        opt, step_fn, _ = trainers[name]
        params, opt_state, run = init, opt.init(init), []
        mm.reset_launches()
        with gemm_roles() as roles:
            for i in range(TRAIN_STEPS):
                params, opt_state, loss = step_fn(params, opt_state, i)
                run.append(loss)
            torch.cuda.synchronize()
        losses[name], trained[name] = torch.stack(run), params
        if name == "K7":
            launches = dict(roles)
            if (sum(roles.values()) != mm.LAUNCHES["output_stationary"]
                    or roles != {k: v * TRAIN_STEPS for k, v in
                                 want.items()}):
                raise AssertionError(f"{TRAIN_STEPS} K7 steps launched "
                                     f"{mm.LAUNCHES} by role {roles}")
        elif mm.LAUNCHES["output_stationary"]:
            raise AssertionError(f"the plain route launched K7: "
                                 f"{mm.LAUNCHES}")
    k7, plain = losses["K7"], losses["plain"]
    gap = (k7 - plain).abs().max().item()
    if not torch.isfinite(k7).all() or gap > TRAIN_TRAJ_TOL:
        raise AssertionError(f"{TRAIN_STEPS} steps: losses K7 {k7.tolist()}"
                             f" against plain {plain.tolist()}")
    if not k7[-1] < k7[0]:
        raise AssertionError(f"the loss did not fall: {k7.tolist()}")
    log(f"  (b) {TRAIN_STEPS} steps: loss {k7[0].item():.4f} -> "
        f"{k7[-1].item():.4f} (K7), {plain[0].item():.4f} -> "
        f"{plain[-1].item():.4f} (plain); largest gap between the routes "
        f"{gap:.3e} (tolerance {TRAIN_TRAJ_TOL}); K7 launched "
        f"{launches} ({sum(launches.values()) // TRAIN_STEPS} a step)")

    cost = phase16_step_cost(card, init, trainers)

    folded = resnet.fold_bn(trained["K7"])
    xt, yt = (torch.from_numpy(a).to(DEV)
              for a in synthetic_cifar(1024, seed=2))
    route = routes["K7"]
    acc = {"fp32": resnet_example.accuracy(RESNET, folded, xt, yt, route,
                                           folded=True),
           "fixed16": resnet_example.accuracy(
               RESNET, fixed_point_tree(folded), xt, yt, route, folded=True),
           "int8": resnet_example.accuracy(
               RESNET, dequantize_params(quantize_params(folded),
                                         torch.float32),
               xt, yt, route, folded=True)}
    if not all(0.0 <= a <= 1.0 for a in acc.values()):
        raise AssertionError(f"accuracies {acc}")
    log(f"  (f) after {TRAIN_STEPS} steps, BN folded, on 1,024 synthetic "
        f"test images through K7: fp32 {acc['fp32']:.3f} | fixed16 "
        f"{acc['fixed16']:.3f} | int8 {acc['int8']:.3f}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = ["-m", "repro_torch.examples.train_resnet20_cifar", "--steps",
           "50"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    if proc.returncode:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    log(f"  (f) {' '.join(cmd[1:])}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; "
        + " | ".join(ln.strip() for ln in lines if ln.startswith(
            ("step 50", "trained", "accuracy", "measured"))))
    del trained, init, folded
    torch.cuda.empty_cache()
    return launches, cost


# ------------------------------------------------ phase 17: the LM trainer
# minicpm-2b (the reference trainer's default arch) at full width, cut to
# TRAIN_LAYERS of its 40 layers; fp32, batch x tokens TRAIN_LM_BATCH from
# TokenStream, the trainer's cosine schedule over TRAIN_LM_STEPS steps (2 of
# warmup), a checkpoint after TRAIN_LM_SAVE
TRAIN_ARCH, TRAIN_LAYERS = "minicpm-2b", 4
TRAIN_LM_BATCH, TRAIN_LM_STEPS, TRAIN_LM_SAVE = (4, 512), 6, 3


def phase17_trainer(card):
    """The LM train step at full width under deterministic algorithms:
    TRAIN_LM_STEPS steps uninterrupted, a checkpoint (``CheckpointManager``,
    async) after TRAIN_LM_SAVE, and a second trainer restored from it whose
    steps give losses, params and AdamW state bit-equal to the
    uninterrupted run's; peak device memory, a step's host wall and idle
    share. Then (17b) the training CLI in its own process, 20 steps then
    resumed to 25."""
    tc = train_mod.TrainConfig(arch=TRAIN_ARCH, reduced=False,
                               steps=TRAIN_LM_STEPS, warmup=2,
                               device="cuda")
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAYERS)
    model = get_model(cfg)
    opt = train_mod.make_optimizer(tc)
    step_fn = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                    attn_impl="einsum", remat=True)
    B, S = TRAIN_LM_BATCH
    stream = TokenStream(cfg.vocab_size, B, S, tc.seed)

    def batch(i):
        return {k: torch.from_numpy(v.copy()).to(DEV)
                for k, v in stream.batch_at(i).items()}

    torch.use_deterministic_algorithms(True)
    try:
        state = steps.init_train_state(
            model, opt, torch.Generator(DEV).manual_seed(17), DEV)
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        log(f"  {TRAIN_ARCH}: d_model {cfg.d_model}, {cfg.num_heads} heads, "
            f"vocab {cfg.vocab_size:,}"
            f"{' (tied)' if cfg.tie_embeddings else ''}, cut to {TRAIN_LAYERS} of 40 "
            f"layers: {n_params / 1e9:.3f} B params, "
            f"{4 * 4 * n_params / 1e9:.1f} GB with gradients and AdamW's m "
            f"and v in fp32; batch {B} x {S}, remat on")
        torch.cuda.reset_peak_memory_stats()
        losses = []
        with tempfile.TemporaryDirectory() as ckpt:
            mgr = CheckpointManager(ckpt)
            for i in range(TRAIN_LM_STEPS):
                state, metrics = step_fn(state, batch(i))
                losses.append(metrics["loss"])
                if i + 1 == TRAIN_LM_SAVE:
                    mgr.save(TRAIN_LM_SAVE, state)
            mgr.wait()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            resumed, meta = mgr.restore(device=DEV)
        if meta["step"] != TRAIN_LM_SAVE or int(resumed["step"]) != \
                TRAIN_LM_SAVE:
            raise AssertionError(f"restored step {meta['step']}, state step "
                                 f"{int(resumed['step'])}")
        again = []
        for i in range(TRAIN_LM_SAVE, TRAIN_LM_STEPS):
            resumed, metrics = step_fn(resumed, batch(i))
            again.append(metrics["loss"])
        losses, again = torch.stack(losses), torch.stack(again)
        if not torch.isfinite(losses).all():
            raise AssertionError(f"losses {losses.tolist()}")
        if not torch.equal(losses[TRAIN_LM_SAVE:], again):
            raise AssertionError(f"resumed losses {again.tolist()} against "
                                 f"{losses[TRAIN_LM_SAVE:].tolist()}")
        a, b = named_leaves(state), named_leaves(resumed)
        if [n for n, _ in a] != [n for n, _ in b]:
            raise AssertionError("the restored state's leaves differ")
        unequal = [n for (n, x), (_, y) in zip(a, b) if not torch.equal(x, y)]
        if unequal:
            raise AssertionError(f"after step {TRAIN_LM_STEPS} the resumed "
                                 f"state differs at {unequal[:5]}")
        log(f"  losses {[round(x, 4) for x in losses.tolist()]}; resumed "
            f"from the step-{TRAIN_LM_SAVE} checkpoint, steps "
            f"{TRAIN_LM_SAVE + 1}-{TRAIN_LM_STEPS} bit-equal: losses and "
            f"all {len(a)} leaves of params, m, v, count and step "
            f"(deterministic algorithms on)")
        log(f"  peak device memory {peak / 2**30:.2f} GiB ({card})")
        del resumed
        cost = host_and_device(lambda: step_fn(state, batch(0)),
                               f"one {TRAIN_ARCH} step ({TRAIN_LAYERS} "
                               f"layers, fp32, {B} x {S})", card)
    finally:
        torch.use_deterministic_algorithms(False)
    del state
    torch.cuda.empty_cache()
    phase17b_cli(card)
    return dict(cost, peak_gib=peak / 2**30)


def phase17b_cli(card):
    """``python -m repro_torch.launch.train`` as a user runs it, in its own
    process: codeqwen1.5-7b reduced, 20 steps with a checkpoint directory,
    then again with 25 steps, which must resume from step 20; both exit 0
    with a finite final loss."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as ckpt:
        for n in (20, 25):
            cmd = ["-m", "repro_torch.launch.train", "--arch",
                   "codeqwen1.5-7b", "--reduced", "--steps", str(n),
                   "--ckpt-dir", ckpt]
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                                  text=True, timeout=600, env=env, cwd=ROOT)
            what = " ".join(cmd[1:])
            if proc.returncode:
                raise AssertionError(f"{what} exited {proc.returncode}:\n"
                                     f"{proc.stdout[-2000:]}\n"
                                     f"{proc.stderr[-3000:]}")
            final = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("final_loss=")]
            if not final or not np.isfinite(float(final[-1].split("=")[1])):
                raise AssertionError(f"{what}: no finite final loss in "
                                     f"{proc.stdout[-2000:]}")
            resumed = "resumed from step 20" in proc.stderr
            if resumed != (n == 25):
                raise AssertionError(f"{what}: resumed {resumed}:\n"
                                     f"{proc.stderr[-2000:]}")
            log(f"  (17b) {what.replace(ckpt, '<tmp>')}: exit 0, "
                f"{final[-1]}{', resumed from step 20' if resumed else ''} "
                f"({time.perf_counter() - t0:.1f} s, {card})")


# ------------------------------------------------------------ phase 18
def bf16_logits_held(label, got, want, cfg, tol=None):
    """Logits of two routes on one trajectory (``want`` the reference
    route's): finite, of the padded vocab's width, within ``tol`` of the
    reference's largest magnitude at every step, and the same greedy token
    wherever the reference's top-2 gap exceeds that. Logs and returns
    (worst |diff| / largest magnitude, tokens compared, rows)."""
    tol = BF16_MODEL_TOL if tol is None else tol
    worst, compared, rows = 0.0, 0, 0
    for g, w in zip(got, want):
        g = g[..., :cfg.vocab_size].float().reshape(-1, cfg.vocab_size)
        w = w[..., :cfg.vocab_size].float().reshape(-1, cfg.vocab_size)
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{label}: non-finite logits")
        top = w.abs().max().item()
        diff = (g - w).abs().max().item()
        worst = max(worst, diff / top)
        top2 = w.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > tol * top
        if not torch.equal(g.argmax(-1)[clear], w.argmax(-1)[clear]):
            raise AssertionError(f"{label}: greedy tokens differ where the "
                                 f"top-2 gap exceeds {tol} of the largest "
                                 f"logit")
        compared += int(clear.sum())
        rows += len(w)
    log(f"  {label}: logits within {worst:.3e} of the largest magnitude "
        f"(tol {tol}); greedy tokens equal on the {compared} of {rows} "
        f"rows whose top-2 gap exceeds it")
    if worst > tol:
        raise AssertionError(f"{label}: logits {worst:.3e} apart")
    return worst, compared, rows


def phase18_model_step(model, params, label, backend=None, cache_dtype=None):
    """bf16 compute at full width: one 64-token chunk for 8 slots on fresh
    pages (bf16 unless ``cache_dtype``, or the cache ``backend`` builds),
    then 8 greedy decode steps, through the kernel and through the masked
    einsum in lockstep: both take the einsum run's greedy token each step,
    so they stay on one trajectory (``bf16_logits_held``). Returns the
    paged kernel's launches (the chunk and the 8 steps x layers)."""
    cfg = model.cfg
    layers = cfg.num_layers
    dtype = cache_dtype or BF16
    mps = S_MAX // PS
    bt = torch.arange(SLOTS * mps, dtype=torch.int32,
                      device=DEV).reshape(SLOTS, mps)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SLOTS, 64))).to(DEV)
    caches = {}
    for impl in ("kernel", "einsum"):
        caches[impl] = (init_paged_cache(model, SLOTS, S_MAX, page_size=PS,
                                         num_pages=SLOTS * mps, dtype=dtype,
                                         device=DEV)
                        if backend is None else
                        backend.init_cache(model, SLOTS, S_MAX, dtype, DEV))
        caches[impl]["block_tables"].copy_(bt)
    pa.reset_launches()
    seqs = {"kernel": [], "einsum": []}
    t0 = time.perf_counter()
    for impl in ("kernel", "einsum"):
        logits, caches[impl] = model.prefill_chunk_paged(
            params, toks, caches[impl], bt_rows=bt, start=0, write_floor=0,
            compute_dtype=BF16, attn_impl=impl)
        caches[impl]["pos"].fill_(64)
        seqs[impl].append(logits)
    for _ in range(8):
        tok = seqs["einsum"][-1][:, :, :cfg.vocab_size].argmax(-1)
        for impl in ("kernel", "einsum"):
            logits, caches[impl] = model.decode_step(
                params, tok, caches[impl], compute_dtype=BF16,
                paged_attn_impl=impl)
            seqs[impl].append(logits)
    torch.cuda.synchronize()
    launches = {k: v for k, v in pa.LAUNCHES.items() if v}
    pool = caches["kernel"]["k"]
    log(f"  {label}: pools {pool.dtype}, a chunk + 8 decode steps on each "
        f"route in {time.perf_counter() - t0:.3f} s (host clock), paged "
        f"kernel launches {launches}")
    kinds = sorted(launches)
    if (len(kinds) != 2 or launches[kinds[0]] != 8 * layers
            or launches[kinds[1]] != layers
            or not kinds[0].startswith("decode")):
        raise AssertionError(f"{label}: launches {launches}, not {layers} "
                             f"chunks and {8 * layers} ticks of one entry")
    bf16_logits_held(f"{label}, kernel vs einsum", seqs["kernel"],
                     seqs["einsum"], cfg)
    del caches, seqs
    torch.cuda.empty_cache()
    return launches


def phase18_forward(model, params):
    """The full-sequence prefill step (``FORWARD_BATCH``) in bf16 through
    K2 ('pallas') and through the einsum; K2's bf16 launches counted."""
    cfg = model.cfg
    B, S = FORWARD_BATCH
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S))).to(DEV)
    out = {}
    for impl in ("pallas", "einsum"):
        fa.reset_launches()
        pa.reset_launches()
        out[impl] = steps.make_prefill(model, attn_impl=impl,
                                       compute_dtype=BF16)(
            params, {"tokens": toks})
        torch.cuda.synchronize()
        if impl == "pallas":
            launches = fa.LAUNCHES["forward_bf16"]
            if launches != LAYERS or sum(fa.LAUNCHES.values()) != LAYERS:
                raise AssertionError(f"bf16 forward launched {fa.LAUNCHES}, "
                                     f"not forward_bf16 once per layer")
    bf16_logits_held(f"bf16 forward (B={B}, S={S}), pallas vs einsum",
                     [out["pallas"]], [out["einsum"]], cfg)
    return launches


def itl_p99(engine) -> float:
    """The 99th percentile of the engine's inter-token latencies (s)."""
    return percentile([g for r in engine.metrics.requests.values()
                       if r.t_done is not None and not r.aborted
                       for g in r.itl_s], 99)


def freed_tick_finite(engine, label):
    """``tests/test_serve.py:512-530`` on the card: with every slot freed
    (positions parked at INACTIVE_POS, block tables all -1) a bf16 decode
    tick gives finite logits."""
    if any(r is not None for r in engine.slot_req):
        raise AssertionError(f"{label}: a slot is still held")
    logits, engine.cache = engine._decode(engine.params, engine.cache, {
        "token": torch.from_numpy(engine.cur_token).to(DEV),
        **engine._prefill_extras(engine.batch_slots)})
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: a tick with every slot freed gave "
                             f"non-finite logits")
    log(f"  {label}: a bf16 tick with every slot freed: finite logits")


def serve_bf16(model, params, prompts, card, label, kinds, **fields):
    """The 16 requests at bf16 compute (the cache in bf16), every paged
    attention through the bf16 entry ``kinds`` (K1, K3, K4), or on the
    dense cache (``kinds`` None: first chunks through K2's bf16 entry,
    ticks through the einsum). Then the freed-slot tick and an idle tick's
    host wall and device idle share. Returns (launches, requests, first
    logits, metrics, idle tick)."""
    engine = ServeEngine(model, params, **ServeConfig(
        reduced=False, s_max=S_MAX, batch_slots=SLOTS, compute_dtype=BF16,
        **fields).engine_kwargs())
    pool = engine.cache["k"].dtype
    pool_want = (torch.int8 if fields.get("kv_backend") == "paged_int8"
                 else BF16)
    if pool != pool_want or engine.cache_dtype != BF16:
        raise AssertionError(f"{label}: cache {pool}, not {pool_want}")
    n_first = [0]
    first = engine._chunk_first

    def counted(*args):
        n_first[0] += 1
        return first(*args)

    engine._chunk_first = counted
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, firsts = serve(engine, prompts)
    engine._chunk_first = first
    if kinds is not None:
        launches = check_paged_launches(kinds, m, f"{label} ({kinds[0]})")
        engine.assert_page_invariants()
    else:
        launches = dict(fa.LAUNCHES)
        want = n_first[0] * LAYERS
        if (sum(pa.LAUNCHES.values()) or launches["prefill_bf16"] != want
                or sum(launches.values()) != want or not n_first[0]):
            raise AssertionError(f"{label}: launches {pa.LAUNCHES}, "
                                 f"{launches}; {n_first[0]} first chunks")
        log(f"  {label}: flash-attention launches prefill_bf16 "
            f"{launches['prefill_bf16']} ({n_first[0]} first chunks x "
            f"{LAYERS} layers) of {m['prefill_chunks']} chunks")
    log_serving(m, card)
    log(f"  {label}: ITL p50 {m['itl_s']['p50'] * 1e3:.2f} ms, p99 "
        f"{m['itl_s']['p99'] * 1e3:.2f} ms ({card})")
    freed_tick_finite(engine, label)
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=DEV)
    tick = host_and_device(
        lambda: engine._decode(engine.params, engine.cache, {"token": tok}),
        f"{label}: one idle decode tick ({SLOTS} slots)", card)
    del engine
    torch.cuda.empty_cache()
    return launches, reqs, firsts, m, tick


def phase18_bf16(model, params, prompts, card, fp32):
    """bf16 serving at full width on phases 3-5's qwen2.5-32b (4 layers):
    (a) the model step, kernel against einsum in lockstep, on bf16 pages
    (K1's bf16 entry), on fp32 pages with bf16 compute (bf16 q over fp32
    pools) and on int8 pages with bf16 compute (K3); (d) the bf16 forward
    through K2; (b) the 16 requests on bf16 pages (K1), int8 pages (K3)
    and the dense cache (K2's first chunks), each run's launches layers x
    ticks and chunks of one bf16 entry, ITL p50 / p99 and an idle tick's
    idle share beside phase 4's fp32 figures (an fp32 paged engine's idle
    tick measured here), streams against phase 4's reported; (c) after
    each run, a tick with every slot freed gives finite logits. Returns
    the launches by kernels-line key."""
    mps = S_MAX // PS
    launches = {}
    log("  (18a) model step, kernel vs einsum, bf16 compute")
    launches.update(phase18_model_step(model, params, "bf16 pages"))
    launches.update(phase18_model_step(model, params,
                                       "fp32 pages, bf16 compute",
                                       cache_dtype=torch.float32))
    launches.update(phase18_model_step(
        model, params, "int8 pages, bf16 compute",
        PagedInt8Backend(PS, SLOTS * mps)))
    log("  (18d) the bf16 forward through K2")
    launches["forward_bf16"] = phase18_forward(model, params)
    log("  (18b, 18c) serving the 16 requests in bf16")
    ref32 = ServeEngine(model, params, **ServeConfig(
        reduced=False, page_size=PS, s_max=S_MAX,
        batch_slots=SLOTS).engine_kwargs())
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device=DEV)
    tick32 = host_and_device(
        lambda: ref32._decode(ref32.params, ref32.cache, {"token": tok}),
        f"fp32 pages: one idle decode tick ({SLOTS} slots)", card)
    del ref32
    torch.cuda.empty_cache()
    p_reqs, p_firsts, p_m = fp32
    runs = {}
    for label, kinds, fields in (
            ("bf16 pages", ("decode_bf16", "prefill_bf16"),
             dict(page_size=PS)),
            ("int8 pages, bf16", ("decode_q8_bf16", "prefill_q8_bf16"),
             dict(page_size=PS, kv_backend="paged_int8")),
            ("dense, bf16", None, dict())):
        got, reqs, firsts, m, tick = serve_bf16(model, params, prompts,
                                                card, label, kinds, **fields)
        runs[label] = (reqs, firsts, m, tick)
        if kinds is None:
            launches["prefill_bf16_flash"] = got["prefill_bf16"]
        else:
            launches.update({kinds[0]: got["decode"],
                             kinds[1]: got["prefill"]})
    log(f"  fp32 pages (phase 4): ITL p50 {p_m['itl_s']['p50'] * 1e3:.2f} "
        f"ms, p99 {p_m['itl_s']['p99'] * 1e3:.2f} ms, idle tick "
        f"{tick32['wall_ms']:.2f} ms host wall, {tick32['idle']:.1%} idle")
    for label, (reqs, firsts, m, tick) in runs.items():
        log(f"  {label}: ITL p50 {m['itl_s']['p50'] * 1e3:.2f} ms, p99 "
            f"{m['itl_s']['p99'] * 1e3:.2f} ms, idle tick "
            f"{tick['wall_ms']:.2f} ms host wall, {tick['idle']:.1%} idle "
            f"({card})")
    bf = runs["bf16 pages"]
    compare_streams("bf16 pages", bf[:2], "fp32 pages", (p_reqs, p_firsts),
                    strict=False)
    compare_streams("dense, bf16", runs["dense, bf16"][:2], "bf16 pages",
                    bf[:2], strict=False)
    return launches



# ------------------------------------------------------------ phase 19
TP_DEGREES = (2, 4, 8)
TP_SERVE = 2                  # 19c: ranks serving phase 4's requests
TP_TIMEOUT = 420              # s, 19c's two ranks together


class SlabMesh:
    """Rank ``r``'s view of a 1-axis "model" mesh of ``tp`` ranks: what the
    head-sharded wrappers read (``specs.head_slab``). 19a launches every
    rank's slab in this one process; no collective runs."""

    def __init__(self, r, tp):
        self.mesh_dim_names, self.shape, self.r = (specs.TP_AXIS,), (tp,), r

    def get_local_rank(self, axis):
        return self.r


def slab(t, r, tp, dim=2):
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n).contiguous()


def quiet(r):
    """Rank 0's check logs its line; the other ranks' checks only raise."""
    return (contextlib.nullcontext() if r == 0
            else contextlib.redirect_stdout(io.StringIO()))


def match_frac(a, b) -> float:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n / max(len(a), len(b), 1)


def paged_slab_rows(card, kind, Sq, seed, variant):
    """K1 (fp32 or bf16) or K3 at qwen2.5-32b's ``kind`` shape: every
    rank's slab at tp 2, 4, 8 with the whole launch's plan concatenates to
    the whole launch bit for bit, each slab is held to its plain version,
    and rank 0's slab is timed (not the bf16 one) beside the plan the slab
    alone would take."""
    args, fill = full_width_case(Sq, seed)
    sc, kv_bytes = {}, 4
    if variant == "_q8":
        args, sc = q8_args(args)
        kv_bytes = 1
    elif variant == "_bf16":
        args = [args[0].to(BF16), args[1].to(BF16), args[2].to(BF16),
                *args[3:]]
        kv_bytes = 2
    q, pk, pv, bt, st = args
    B, _, H, hd = q.shape
    KV = pk.shape[2]
    key = kind + variant
    kkind = kind + ("_q8" if variant == "_q8" else "")
    whole = pa.paged_attention(*args, kind=kkind, **sc)
    whole_plan = pa.paged_plan(B, Sq, H, KV, hd, bt.shape[1] * PS,
                               elem=pk.element_size())
    rows = {}
    for tp in TP_DEGREES:
        parts, err = [], 0.0
        for r in range(tp):
            sa = [q, slab(pk, r, tp), slab(pv, r, tp), bt, st]
            got = pa.paged_attention_head_sharded(
                SlabMesh(r, tp), specs.TP_AXIS, *sa, kind=kkind, **sc)
            with quiet(r):
                _, e = kernel_held(f"  {key} tp={tp} rank {r} slab", got,
                                   ref.paged_attention(slab(q, r, tp),
                                                       *sa[1:], **sc))
            parts.append(got)
            err = max(err, e)
        if not torch.equal(torch.cat(parts, dim=2), whole):
            raise AssertionError(f"{key} tp={tp}: the slabs concatenated "
                                 f"differ from the whole launch")
        s0 = [slab(q, 0, tp), slab(pk, 0, tp), slab(pv, 0, tp), bt, st]
        own_plan = pa.paged_plan(B, Sq, H // tp, KV // tp, hd,
                                 bt.shape[1] * PS, elem=pk.element_size())
        own = pa.paged_attention(*s0, kind=kkind, **sc)
        own_same = torch.equal(own, parts[0])
        log(f"  {key} tp={tp}: {tp} slabs bit-equal to the whole launch "
            f"(plan: rows {whole_plan.rows}, key tile "
            f"{whole_plan.key_tile}, {whole_plan.stages} stages, "
            f"{whole_plan.splits} splits); the slab's own plan would take "
            f"{own_plan.splits} splits and give "
            f"{'the same' if own_same else 'other'} bits")
        row = dict(err=err, own_splits=own_plan.splits,
                   whole_splits=whole_plan.splits, own_same=own_same)
        if variant != "_bf16":
            call = lambda: pa.paged_attention(  # noqa: E731
                *s0, kind=kkind, plan_heads=(H, KV), **sc)
            ms = device_ms(call, 20, PAGED_KERNELS)
            own_ms = device_ms(lambda: pa.paged_attention(
                *s0, kind=kkind, **sc), 20, PAGED_KERNELS)
            plain = time_ms(lambda: ref.paged_attention(*s0, **sc), 5)
            lib_args = s0
            if sc:
                lib_args = [s0[0]] + [
                    (p.float() * s[:, None, None, None])
                    for p, s in ((s0[1], sc["k_scale"]),
                                 (s0[2], sc["v_scale"]))] + s0[3:]
            lib_ms = device_ms(sdpa_call(lib_args), 5)
            bms, by = bound_ms(s0, fill, kv_bytes=kv_bytes)
            log(f"  {key} tp={tp} rank-0 slab: kernel {ms:.4f} ms (its own "
                f"plan {own_ms:.4f} ms) | plain {plain:.4f} ms | sdpa "
                f"{lib_ms:.4f} ms | bound {bms:.4f} ms ({by}) ({card})")
            row.update(ms=ms, own_ms=own_ms, plain_ms=plain,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by)
        rows[(key, tp)] = row
    return rows


def latent_slab_rows(card, kind, Sq, seed):
    """K4 at qwen2.5-32b-mla's ``kind`` shape (40 heads over the whole
    latent pool): the same as ``paged_slab_rows``."""
    cfg = configs.get_config(MLA_ARCH)
    H, c, r_ = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Lw, scale_dim = c + r_, cfg.head_dim + r_
    mps = S_MAX // PS
    fill = np.random.default_rng(seed).integers(100, 733, SLOTS)
    args = on_card(*latent_case(seed, SLOTS, Sq, H, Lw, SLOTS * mps, PS,
                                mps, fill), (fill - Sq).astype(np.int32))
    q, pool, bt, st = args
    kw = dict(scale_dim=scale_dim, d_v=c, kind=kind)
    whole = pa.paged_attention_latent(*args, **kw)
    whole_plan = pa.latent_plan(SLOTS, H * Sq, Lw, c, mps * PS)
    rows = {}
    for tp in TP_DEGREES:
        parts, err = [], 0.0
        for r in range(tp):
            got = pa.paged_attention_latent_head_sharded(
                SlabMesh(r, tp), specs.TP_AXIS, *args, **kw)
            with quiet(r):
                _, e = held(f"  {kind} tp={tp} rank {r} slab", got,
                            ref.paged_attention_latent(
                                slab(q, r, tp), pool, bt, st,
                                scale_dim=scale_dim, d_v=c))
            parts.append(got)
            err = max(err, e)
        if not torch.equal(torch.cat(parts, dim=2), whole):
            raise AssertionError(f"{kind} tp={tp}: the slabs concatenated "
                                 f"differ from the whole launch")
        q0 = slab(q, 0, tp)
        own_plan = pa.latent_plan(SLOTS, H // tp * Sq, Lw, c, mps * PS)
        own = pa.paged_attention_latent(q0, pool, bt, st, **kw)
        own_same = torch.equal(own, parts[0])
        ms = device_ms(lambda: pa.paged_attention_latent(
            q0, pool, bt, st, plan_heads=H, **kw), 20, LATENT_KERNELS)
        own_ms = device_ms(lambda: pa.paged_attention_latent(
            q0, pool, bt, st, **kw), 20, LATENT_KERNELS)
        plain = time_ms(lambda: ref.paged_attention_latent(
            q0, pool, bt, st, scale_dim=scale_dim, d_v=c), 5)
        n = mps * PS
        j = torch.arange(n, device=DEV)
        page = bt.long()[:, j // PS]
        ok = page >= 0
        view = pool.reshape(-1, Lw)[torch.where(ok, page * PS + j % PS, 0)]
        kk, vv = view[:, None].contiguous(), view[:, None, :, :c].contiguous()
        qpos = st.long()[:, None] + torch.arange(Sq, device=DEV)
        mask = (ok[:, None, :] & (j[None, None, :] <= qpos[:, :, None]))[:,
                                                                         None]
        qt = q0.transpose(1, 2).contiguous()
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kk, vv, attn_mask=mask, scale=scale_dim ** -0.5,
            enable_gqa=True), 5)
        Hs = H // tp
        nbytes = (int(np.sum(fill)) * Lw * 4 + (q0.numel() + SLOTS * Sq * Hs
                                                * c) * 4
                  + 4 * (bt.numel() + st.numel()))
        bms, by = roofline(nbytes, 2 * (Lw + c) * visible_pairs(fill, Sq) * Hs)
        log(f"  {kind} tp={tp}: {tp} slabs bit-equal to the whole launch "
            f"(plan: rows {whole_plan.rows}, {whole_plan.splits} splits; the "
            f"slab's own: rows {own_plan.rows}, {own_plan.splits} splits, "
            f"{'the same' if own_same else 'other'} bits); rank-0 slab: "
            f"kernel {ms:.4f} ms (own plan {own_ms:.4f} ms) | plain "
            f"{plain:.4f} ms | sdpa {lib_ms:.4f} ms | bound {bms:.4f} ms "
            f"({by}) ({card})")
        rows[(kind, tp)] = dict(err=err, ms=ms, own_ms=own_ms,
                                plain_ms=plain, library_ms=lib_ms,
                                bound_ms=bms, bound_by=by,
                                own_splits=own_plan.splits,
                                whole_splits=whole_plan.splits,
                                own_same=own_same)
    return rows


def phase19a_slabs(card):
    """19a: K1 (fp32, bf16), K3 and K4 at full width on each rank's head
    slab at tp 2, 4 and 8, with the whole launch's plan: bit-equal to the
    whole launch, each slab within KERNEL_TOL of its plain version (a bf16
    step more for bf16), rank 0's slab timed beside the slab's own plan."""
    t0 = time.perf_counter()
    rows = {}
    for kind, Sq, seed in (("decode", 1, 11), ("prefill", 64, 12)):
        for variant in ("", "_bf16", "_q8"):
            rows.update(paged_slab_rows(card, kind, Sq, seed, variant))
            torch.cuda.empty_cache()
    for kind, Sq, seed in (("decode_latent", 1, 15),
                           ("prefill_latent", 64, 16)):
        rows.update(latent_slab_rows(card, kind, Sq, seed))
    torch.cuda.empty_cache()
    log(f"  19a took {time.perf_counter() - t0:.1f} s")
    return rows


def phase19b_tp1(model, params, prompts, card, phase4):
    """19b: phase 4's 16 requests through a one-rank NCCL mesh (made from an
    in-process store): tokens and first-token logits bit-equal to phase
    4's mesh-free stream, K1 launched layers x ticks and chunks. Returns
    the pool bytes (tp = 1's, every kv head)."""
    import torch.distributed as dist
    p_reqs, p_firsts, p_m = phase4
    specs.check_serve_group(1, "cuda")
    log(f"  process group: {dist.get_backend()}, {dist.get_world_size()} "
        f"rank")
    mesh = specs.serve_mesh(1, "cuda")
    engine = ServeEngine(model, params, mesh=mesh, **ServeConfig(
        reduced=False, page_size=PS, s_max=S_MAX,
        batch_slots=SLOTS).engine_kwargs())
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, firsts = serve(engine, prompts)
    check_paged_launches(("decode", "prefill"), m, "tp=1 mesh K1")
    if [r.tokens for r in reqs] != [r.tokens for r in p_reqs]:
        raise AssertionError("tp=1 mesh: tokens differ from phase 4's")
    if not all(torch.equal(a, b) for a, b in zip(firsts, p_firsts)):
        raise AssertionError("tp=1 mesh: first-token logits differ from "
                             "phase 4's")
    log_serving(m, card)
    log(f"  tp=1 mesh: tokens and first-token logits bit-equal to phase "
        f"4's; ITL p50 {m['itl_s']['p50'] * 1e3:.2f} ms against phase 4's "
        f"{p_m['itl_s']['p50'] * 1e3:.2f} ms")
    pool = engine.per_shard_kv_bytes()
    del engine
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return pool


def start_ranks(world, out_dir, flag):
    """Starts ``chip_smoke.py FLAG R WORLD DIR FORM`` as ``world``
    processes (FORM NCCL with a card each where there are enough, else
    gloo on cuda:0); ``wait_ranks`` takes what this returns."""
    form = "nccl" if torch.cuda.device_count() >= world else "gloo"
    return {"flag": flag, "form": form, "out_dir": out_dir,
            "t0": time.perf_counter(), "procs": [subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()), flag,
                 str(r), str(world), str(out_dir), form])
                for r in range(world)]}


def wait_ranks(groups, timeout):
    """Waits for every process of ``groups`` (``start_ranks``' results,
    running at once); fails if one fails or the timeout passes. Returns,
    for each group, (FORM, each rank's DIR/rank<R>.json, the seconds from
    its start to its last process's end)."""
    procs = [p for g in groups for p in g["procs"]]
    deadline = time.monotonic() + timeout
    took = {}

    def ended():
        for i, g in enumerate(groups):
            if i not in took and all(p.poll() is not None
                                     for p in g["procs"]):
                took[i] = time.perf_counter() - g["t0"]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{[g['flag'] for g in groups]}: ranks still running "
                    f"after {timeout} s")
            ended()
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    ended()
    for g in groups:
        bad = [(r, p.returncode) for r, p in enumerate(g["procs"])
               if p.returncode]
        if bad:
            raise AssertionError(f"{g['flag']}: ranks failed {bad}")
    return [(g["form"], [json.loads((pathlib.Path(g["out_dir"])
                                     / f"rank{r}.json").read_text())
                         for r in range(len(g["procs"]))], took[i])
            for i, g in enumerate(groups)]


def spawn_ranks(world, out_dir, flag, timeout):
    """One group of ``start_ranks``, waited for: (FORM, each rank's
    DIR/rank<R>.json)."""
    form, ranks, _ = wait_ranks([start_ranks(world, out_dir, flag)],
                                timeout)[0]
    return form, ranks


def phase19c_tp2(card, p_reqs, q8_reqs, pool_bytes):
    """19c: two ranks (one card each over NCCL where there are two, else
    both on cuda:0 over gloo, the all-gather staged through the host) serve
    phase 4's requests at tp = 2: tokens equal to tp = 1's (phase 4's),
    each rank holding half the pool. The int8 leg serves them through K3's
    slabs, reporting the greedy prefix match against phase 4b's tp = 1
    stream beside 4b's own against phase 4 (int8 against fp32), and holds
    phase 3c's model step at tp = 2 to tp = 1 within Q8_MODEL_TOL
    (``int8_step_tp``). Returns rank 0's counts."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        form, ranks = spawn_ranks(TP_SERVE, d, "--tp-rank", TP_TIMEOUT)
    log(f"  19c form: {form}, " + (
        f"one card per rank" if form == "nccl" else
        "both ranks on cuda:0, the all-gather staged through the host"))
    want = [list(r.tokens) for r in p_reqs]
    q8_want = [list(r.tokens) for r in q8_reqs]
    base = float(np.mean([match_frac(a, b) for a, b in zip(q8_want, want)]))
    for r, got in enumerate(ranks):
        if got["tokens"] != want:
            raise AssertionError(f"19c rank {r}: tp=2 tokens differ from "
                                 f"tp=1's")
        if got["pool_bytes"] * TP_SERVE != pool_bytes:
            raise AssertionError(f"19c rank {r}: {got['pool_bytes']} pool "
                                 f"bytes, not {pool_bytes} / {TP_SERVE}")
        frac = float(np.mean([match_frac(a, b) for a, b in
                              zip(got["tokens_q8"], q8_want)]))
        log(f"  rank {r} ({got['device']}): tokens equal to tp=1's; pool "
            f"{got['pool_bytes']} bytes = tp=1's / {TP_SERVE}; ITL p50 "
            f"{got['itl_p50'] * 1e3:.2f} ms, tok/s {got['tok_s']:.1f}; "
            f"int8 pages: model step within {got['q8_step_diff'][0]:.3e} of "
            f"one device's {TP_SERVE} scale groups (of tp=1's whole-page "
            f"scales {got['q8_step_diff'][1]:.3e}), served streams' greedy "
            f"prefix match with tp=1's "
            f"{frac:.3f} (int8 against fp32 at tp=1: {base:.3f}), ITL p50 "
            f"{got['itl_p50_q8'] * 1e3:.2f} ms; K1 slab launches "
            f"{got['launches']}, K3 {got['launches_q8']}; engine built "
            f"(weights made and broadcast) in {got['build_s']:.2f} s")
    if form == "gloo":
        log(f"  gloo all_gather of CUDA tensors on this card's torch: "
            f"{ranks[0]['gloo_cuda']}")
    log(f"  19c took {time.perf_counter() - t0:.1f} s ({card})")
    return ranks[0]


def int8_step_tp(model, params, mesh):
    """Phase 3c's model step (a 64-token paged chunk for 8 slots, then 8
    greedy decode steps) on int8 pages at ``mesh``'s tp through K3's slabs,
    each rank quantizing its slab with its own scale group, against the
    same step on one device with the reference's (L, P, tp) group scales
    read by the masked einsum: logits within Q8_MODEL_TOL and equal tokens
    (phase 3c's means: int8 read paths part by int8 steps at rounding
    ties). Also reports the step against one device's whole-page scales
    (tp = 1), which differ by design. Every rank runs it; the tp run's
    all-gathers pair them up. Returns (max |diff| against the groups,
    against tp = 1)."""
    cfg = model.cfg
    tp = specs.tp_degree(mesh)
    mps = S_MAX // PS
    bt = torch.arange(SLOTS * mps, dtype=torch.int32,
                      device=DEV).reshape(SLOTS, mps)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SLOTS, 64))).to(DEV)
    runs = {}
    for name, m, impl, groups in ((f"tp={tp} K3", mesh, "kernel", 1),
                                  (f"{tp} groups einsum", None, "einsum", tp),
                                  ("tp=1 K3", None, "kernel", 1)):
        cache = PagedInt8Backend(PS, SLOTS * mps, mesh=m).init_cache(
            model, SLOTS, S_MAX, torch.float32, DEV)
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.ones(tuple(cache[key].shape[:2]) + (groups,),
                                    device=DEV)
        cache["block_tables"].copy_(bt)
        with specs.use_mesh(m, specs.TP_SERVE_RULES):
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
        runs[name] = (seq, torch.cat(tokens, 1))
        del cache
    tp_run, grouped, whole = runs
    diff = {b: max((x - y).abs().max().item() for x, y in
                   zip(runs[tp_run][0], runs[b][0])) for b in (grouped, whole)}
    log(f"  int8 model step {tp_run} against tp=1's whole-page scales: "
        f"logits max abs diff {diff[whole]:.3e}, greedy tokens "
        f"{'equal' if torch.equal(runs[tp_run][1], runs[whole][1]) else 'differ'}"
        f" (other scale groups, by design)")
    compare_runs(runs, cfg, tp_run, grouped, Q8_MODEL_TOL)
    return diff[grouped], diff[whole]


def tp_rank(rank: int, world: int, out_dir: str, form: str) -> int:
    """One rank of 19c (``chip_smoke.py --tp-rank R N DIR FORM``): build
    qwen2.5-32b at full width (4 layers, phase 4's seed) at tp = N, serve
    phase 4's requests on fp32 pages and then on int8 pages, and write
    what it saw to DIR/rank<R>.json."""
    import datetime
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if form == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(form, init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    gloo_cuda = None
    if form == "gloo":
        try:
            parts = [torch.empty(2, device=dev) for _ in range(world)]
            dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
            gloo_cuda = ("takes them" if [p[0].item() for p in parts]
                         == [float(r) for r in range(world)] else
                         "gathers wrong values")
        except Exception as err:  # noqa: BLE001 — reported, staging serves
            gloo_cuda = f"refuses them ({type(err).__name__})"
    base = dict(reduced=False, s_max=S_MAX, batch_slots=SLOTS, page_size=PS,
                device=str(dev))
    t0 = time.perf_counter()
    engine = ServeEngine.build(ARCH, config=ServeConfig(
        cfg_overrides={"num_layers": LAYERS}, tp=world, **base))
    torch.cuda.synchronize()
    built = time.perf_counter() - t0       # the weights' broadcast included
    prompts = serve_prompts(engine.cfg.vocab_size)
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, _ = serve(engine, prompts)
    launches = check_paged_launches(("decode", "prefill"), m,
                                    f"rank {rank} K1 slabs")
    out = dict(device=str(dev), gloo_cuda=gloo_cuda, build_s=built,
               tokens=[list(r.tokens) for r in reqs],
               pool_bytes=engine.per_shard_kv_bytes(), launches=launches,
               itl_p50=m["itl_s"]["p50"],
               tok_s=m["throughput_tokens_per_s"])
    q8 = ServeEngine(engine.model, engine.params, mesh=engine.mesh,
                     **ServeConfig(kv_backend="paged_int8",
                                   **base).engine_kwargs())
    pa.reset_launches()
    fa.reset_launches()
    reqs, m, _ = serve(q8, prompts)
    q8.assert_page_invariants()
    out.update(tokens_q8=[list(r.tokens) for r in reqs],
               itl_p50_q8=m["itl_s"]["p50"],
               launches_q8=check_paged_launches(
                   ("decode_q8", "prefill_q8"), m, f"rank {rank} K3 slabs"))
    del q8
    out["q8_step_diff"] = int8_step_tp(engine.model, engine.params,
                                       engine.mesh)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0

# ------------------------------------------------------------ phase 20
# sharded training: minicpm-2b at full width cut to TRAIN20_LAYERS layers,
# fp32, no remat, the trainer's data (TokenStream, batch x tokens
# TRAIN20_BATCH) and optimizer (make_optimizer: cosine, warmup 10); ranks
# are processes (one card each over NCCL where there are enough, else all
# on cuda:0 over gloo, every collective staged through the host)
TRAIN20_ARCH, TRAIN20_LAYERS, TRAIN20_BATCH = "minicpm-2b", 2, (8, 128)
TRAIN20_STEPS = 2          # a (2, 1) step takes 10-12 s of the script
TRAIN20_MESHES = ((2, 1), (1, 2), (2, 2))
ELASTIC_MESHES = ((2, 2), (4, 1), (1, 4))
TRAIN20_TOL = 1e-3          # the reference's sharded-vs-single loss bound
GRAD20_TOL = 1e-5           # of each leaf's largest |gradient|
ELASTIC_TOL = 1e-4          # the reference's elastic-restore bound
TRAIN20_TIMEOUT = 900
PIPE_STAGES, PIPE_MICRO, PIPE_B, PIPE_D = 4, 8, 2, 16


def train20_setup():
    """(TrainConfig, model, optimizer, the steps' batches as numpy) of
    phase 20: the trainer's config with ``reduced_config`` standing for the
    depth cut (full width, TRAIN20_LAYERS layers, fp32, no remat)."""
    B, S = TRAIN20_BATCH
    tc = train_mod.TrainConfig(arch=TRAIN20_ARCH, reduced=True,
                               steps=TRAIN20_STEPS, batch=B, seq_len=S,
                               log_every=1, device="cuda")
    model = get_model(train20_config(configs.get_config(TRAIN20_ARCH)))
    stream = TokenStream(model.cfg.vocab_size, B, S, tc.seed)
    return (tc, model, train_mod.make_optimizer(tc),
            [stream.batch_at(i) for i in range(TRAIN20_STEPS)])


def train20_config(cfg):
    return dataclasses.replace(cfg, num_layers=TRAIN20_LAYERS)


def train20_batch(raw, dev):
    return {k: torch.from_numpy(v.copy()).to(dev) for k, v in raw.items()}


def phase20_sharded_training(card):
    """20a: TRAIN20_STEPS steps mesh-free here, then on each of
    TRAIN20_MESHES from the same initial state in spawned ranks: every
    mesh's losses within TRAIN20_TOL of mesh-free, the step-1 gradients
    (each rank's blocks) within GRAD20_TOL of each leaf's largest
    magnitude, each rank's resident share of the state and its peak
    memory. 20b: saved after one step on (2, 2), restored on
    ELASTIC_MESHES (``elastic_restore``), one step each within
    ELASTIC_TOL. 20c: the compressed all-reduce and the GPipe pipeline on
    CUDA tensors over 4 ranks, to ``tests/test_distributed.py``'s bounds.
    20d: the trainer at mesh_shape (2, 1) in the spawned ranks, its losses
    equal to 20a's (2, 1) run. Deterministic algorithms on."""
    t20 = time.perf_counter()
    tc, model, opt, raws = train20_setup()
    cfg = model.cfg
    torch.use_deterministic_algorithms(True)
    try:
        state = steps.init_train_state(
            model, opt, torch.Generator(DEV).manual_seed(tc.seed), DEV)
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        log(f"  {TRAIN20_ARCH}: d_model {cfg.d_model}, {cfg.num_heads} over "
            f"{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, padded vocab "
            f"{cfg.padded_vocab:,}, {TRAIN20_LAYERS} layers: "
            f"{n_params / 1e9:.3f} B params, state (params, m, v) "
            f"{3 * 4 * n_params / 1e9:.2f} GB fp32; batch "
            f"{TRAIN20_BATCH[0]} x {TRAIN20_BATCH[1]}, no remat")
        loss_fn = steps.make_loss_fn(model, compute_dtype=torch.float32,
                                     remat=False)
        grads = steps.value_and_grad(loss_fn)(
            state["params"], train20_batch(raws[0], DEV))[1]
        step_fn = steps.make_train_step(model, opt,
                                        compute_dtype=torch.float32,
                                        remat=False)
        with tempfile.TemporaryDirectory() as d:
            torch.save({n: g.cpu() for n, g in named_leaves(grads)},
                       os.path.join(d, "grads.pt"))
            del grads
            losses, times = [], []
            for raw in raws:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fn(state, train20_batch(raw, DEV))
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t0)
            del state, m
            torch.cuda.empty_cache()
            log(f"  20a mesh-free: losses {losses}, step wall "
                f"{[round(t, 4) for t in times]} s ({card})")
            # both groups at once (their step walls then share the host)
            groups = []
            for world in (2, 4):
                run = os.path.join(d, f"world{world}")
                os.mkdir(run)
                groups.append(start_ranks(world, run, "--train-rank"))
            ranks = {}
            for world, (form, ranks[world], took) in zip(
                    (2, 4), wait_ranks(groups, TRAIN20_TIMEOUT)):
                log(f"  {world} ranks ({form}"
                    + (", all on cuda:0, the collectives staged through "
                       "the host" if form == "gloo" else "") + f") took "
                    f"{took:.1f} s, the 2 and 4 ranks running at once")
    finally:
        torch.use_deterministic_algorithms(False)
    meshes = {}
    for world, rs in ranks.items():
        for shape in TRAIN20_MESHES:
            key = str(shape)
            if key not in rs[0]:
                continue
            got = [r[key] for r in rs]
            if any(g["losses"] != got[0]["losses"] for g in got):
                raise AssertionError(f"20a {shape}: ranks disagree")
            diff = max(abs(a - b) for a, b in zip(got[0]["losses"], losses))
            gerr = max(g["grad_err"] for g in got)
            if not diff < TRAIN20_TOL or not gerr < GRAD20_TOL:
                raise AssertionError(f"20a {shape}: losses "
                                     f"{got[0]['losses']} vs mesh-free "
                                     f"{losses} (max diff {diff:.3e}), "
                                     f"step-1 gradients {gerr:.3e}")
            meshes[key] = got[0]["losses"]
            log(f"  20a {shape}: losses {got[0]['losses']} (max diff "
                f"{diff:.3e} of mesh-free, bound {TRAIN20_TOL}); step-1 "
                f"gradients within {gerr:.3e} of each leaf's largest "
                f"(bound {GRAD20_TOL}); step wall "
                f"{[round(t, 3) for t in got[0]['times']]} s; per rank "
                f"resident state share "
                f"{[round(g['resident'], 4) for g in got]}, peak memory "
                f"{[round(g['peak_gib'], 2) for g in got]} GiB ({card})")
            prof = got[0]["profile"]
            log(f"  20a {shape} rank 0's step {TRAIN20_STEPS} under "
                f"torch.profiler: "
                f"{prof['wall']:.3f} s wall, device busy {prof['busy']:.3f} s "
                f"(idle {1 - prof['busy'] / prof['wall']:.1%}); host self "
                f"time in copies {prof['copies']:.3f} s, in the weight "
                f"gathers and gradient reductions {prof['collectives']:.3f} "
                f"s; most self time: " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in prof["top"]))
    el = [r["elastic"] for r in ranks[4]]
    if any(e["losses"] != el[0]["losses"] for e in el):
        raise AssertionError("20b: ranks disagree")
    vals = list(el[0]["losses"].values())
    if not max(vals) - min(vals) < ELASTIC_TOL or el[0]["mesh6"] != 6:
        raise AssertionError(f"20b: losses {el[0]['losses']}, "
                             f"choose_mesh_shape(6) gives {el[0]['mesh6']}")
    log(f"  20b elastic: saved after step 1 on (2, 2) "
        f"({el[0]['save_s']:.1f} s), one step restored on each: "
        f"{el[0]['losses']} (spread {max(vals) - min(vals):.3e}, bound "
        f"{ELASTIC_TOL}); restores took {el[0]['restore_s']} s; "
        f"choose_mesh_shape(6, model_parallel=4) = {el[0]['mesh6_shape']}")
    c = ranks[4][0]["collectives"]
    log(f"  20c compressed all-reduce over 4 ranks on CUDA tensors: mean "
        f"within {c['mean_err']:.3e} (bound 0.04), residual "
        f"{c['resid']:.3f} of a step (bound 0.51), the mean of 8 EF steps "
        f"within rtol 0.02 / atol 0.002 of the true mean: {c['ef_ok']}; "
        f"pipeline "
        f"{PIPE_STAGES} stages x {PIPE_MICRO} microbatches within "
        f"{c['pipe_err']:.3e} of the sequential stages (bound 2e-5), "
        f"bubble {c['bubble']:.4f}")
    trainer = [r["trainer"] for r in ranks[2]]
    if any(t != meshes["(2, 1)"] for t in trainer):
        raise AssertionError(f"20d: the trainer's losses {trainer} differ "
                             f"from 20a's (2, 1) {meshes['(2, 1)']}")
    log(f"  20d trainer at mesh_shape (2, 1): losses {trainer[0]} equal to "
        f"20a's (2, 1) run on both ranks")
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s ({card})")


def train20_mesh(model, opt, raws, shape, dev, ref_grads):
    """One 20a mesh on this rank: step-1 gradient error of its blocks, the
    steps' losses and walls, its resident state share and peak memory."""
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), dev.type)
    torch.cuda.reset_peak_memory_stats(dev)
    with specs.use_mesh(mesh):
        full = steps.init_train_state(
            model, opt, torch.Generator(dev).manual_seed(0), dev)
        whole = sum(t.numel() * t.element_size() for t in tree_leaves(full))
        state = steps.place(full, steps.state_shardings(model, full))
        del full
        batches = [steps.place(train20_batch(raw, dev), steps.batch_shardings(
            model, train20_batch(raw, dev))) for raw in raws]
    held = sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(state))
    # step 1 as make_train_step computes it (value and gradients, then the
    # update), with its gradients held to the mesh-free ones on the way
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, _), got = steps.sharded_value_and_grad(model, steps.make_loss_fn(
        model, compute_dtype=torch.float32, remat=False))(
            state["params"], batches[0])
    state, _ = steps.sharded_update(opt, state, got)
    losses, times = [float(loss)], [time.perf_counter() - t0]
    err = 0.0
    for (name, g), leaf in zip(named_leaves(got),
                               tree_leaves(state["params"])):
        want = specs.local_block(ref_grads[name],
                                 specs.sharding_of(leaf)).to(dev)
        err = max(err, float((g - want).abs().max() / want.abs().max()))
    del got
    step_fn = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                    remat=False)
    for b in batches[1:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, batches[-1])
        losses.append(float(m["loss"]))
    times.append(time.perf_counter() - t0)
    return {"losses": losses, "times": times, "grad_err": err,
            "resident": held / whole,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "profile": step_breakdown(prof, times[-1])}


def step_breakdown(prof, wall) -> dict:
    """A profiled step's device busy share and its host time by op: the
    copies (``aten::copy_``, ``cudaMemcpyAsync``: the host staging of the
    gloo collectives among them), the weight gathers and gradient
    reductions (``_Materialize`` and its backward, whose self time is the
    wait on gloo), and the five ops of most self CPU time (s)."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e6
    cpu = {e.key: e.self_cpu_time_total / 1e6 for e in events
           if e.device_type == DeviceType.CPU}
    return {"wall": wall, "busy": busy,
            "copies": cpu.get("aten::copy_", 0) + cpu.get(
                "cudaMemcpyAsync", 0),
            "collectives": cpu.get("_Materialize", 0) + cpu.get(
                "_MaterializeBackward", 0),
            "top": sorted(cpu.items(), key=lambda kv: -kv[1])[:5]}


def train20_elastic(model, opt, raws, dev, out_dir):
    """20b on this rank: one step on (2, 2), saved; restored on each of
    ELASTIC_MESHES and one step taken there."""
    from repro_torch.runtime import elastic
    step_fn = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                    remat=False)
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), async_save=False)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), dev.type)
    with specs.use_mesh(mesh):
        full = steps.init_train_state(
            model, opt, torch.Generator(dev).manual_seed(0), dev)
        state = steps.place(full, steps.state_shardings(model, full))
        del full
        b = train20_batch(raws[0], dev)
        state, _ = step_fn(state, steps.place(b, steps.batch_shardings(
            model, b)))
    t0 = time.perf_counter()
    mgr.save(1, state)
    save_s = time.perf_counter() - t0
    del state
    losses, restore_s = {}, []
    for shape in ELASTIC_MESHES:
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), dev.type)
        t0 = time.perf_counter()
        restored, meta = elastic.elastic_restore(mgr, model, opt, mesh=mesh,
                                                 device=dev)
        restore_s.append(round(time.perf_counter() - t0, 2))
        if meta["step"] != 1:
            raise AssertionError(f"20b restored step {meta['step']}")
        b = train20_batch(raws[1], dev)
        with specs.use_mesh(mesh):
            b = steps.place(b, steps.batch_shardings(model, b))
        _, m = step_fn(restored, b)
        losses[str(shape)] = float(m["loss"])
        del restored
    shape6, _ = elastic.choose_mesh_shape(6, model_parallel=4)
    return {"losses": losses, "save_s": save_s, "restore_s": restore_s,
            "mesh6": int(np.prod(shape6)), "mesh6_shape": list(shape6)}


def train20_collectives(rank, world, dev):
    """20c on this rank: the compressed all-reduce (tests/
    test_distributed.py's case at ``world`` data ranks) and the GPipe
    pipeline, on CUDA tensors; the contract's bounds checked here."""
    from repro_torch.optim.grad_compress import (init_error,
                                                 make_compressed_allreduce)
    from repro_torch.sharding.pipeline import bubble_fraction, make_pipeline
    g_all = np.random.default_rng(0).standard_normal(
        (world, 64, 32)).astype(np.float32)
    mesh = mesh_mod.make_mesh((world,), ("data",), dev.type)
    grads = {"w": torch.from_numpy(g_all[rank]).to(dev)}
    ar = make_compressed_allreduce(mesh, None, dp_axes=("data",))
    mean, err = ar(grads, init_error(grads))
    want = g_all.mean(0)
    diff = np.abs(mean["w"].cpu().numpy() - want)
    mean_err = float(diff.max())
    resid = float(err["w"].abs().max()) / float(np.abs(g_all).max() / 127.0)
    err, total = init_error(grads), np.zeros_like(want)
    for _ in range(8):
        mean, err = ar(grads, err)
        total += mean["w"].cpu().numpy()
    ef_ok = bool(np.allclose(total / 8, want, rtol=0.02, atol=0.002))
    if not (np.all(diff <= 0.04 + 0.04 * np.abs(want))
            and resid <= 0.51 + 1e-6 and ef_ok):
        raise AssertionError(f"20c compressed all-reduce: mean err "
                             f"{mean_err}, residual {resid}, EF {ef_ok}")
    rng = np.random.default_rng(1)
    ws = (rng.standard_normal((PIPE_STAGES, PIPE_D, PIPE_D))
          / np.sqrt(PIPE_D)).astype(np.float32)
    x = rng.standard_normal((PIPE_MICRO, PIPE_B, PIPE_D)).astype(np.float32)
    pmesh = mesh_mod.make_mesh((PIPE_STAGES,), ("pod",), dev.type)
    with specs.use_mesh(pmesh):
        spec = {"w": specs.sharding_for(ws.shape, ("stage", None, None))}
    pipe = make_pipeline(pmesh, lambda p, h: torch.tanh(h @ p["w"]), spec,
                         stage_axis="pod", n_micro=PIPE_MICRO)
    got = pipe({"w": torch.from_numpy(ws).to(dev)},
               torch.from_numpy(x).to(dev))
    ref_out = torch.from_numpy(x).to(dev)
    for s in range(PIPE_STAGES):
        ref_out = torch.tanh(ref_out @ torch.from_numpy(ws[s]).to(dev))
    pipe_err = float((got - ref_out).abs().max())
    bubble = bubble_fraction(PIPE_STAGES, PIPE_MICRO)
    if not torch.all((got - ref_out).abs() <= 2e-5 + 2e-5 * ref_out.abs()) \
            or abs(bubble - 3 / 11) > 1e-9:
        raise AssertionError(f"20c pipeline: err {pipe_err}, bubble {bubble}")
    return {"mean_err": mean_err, "resid": resid, "ef_ok": ef_ok,
            "pipe_err": pipe_err, "bubble": bubble}


def rank_device(rank: int, form: str):
    """A spawned rank's card: its own over NCCL, cuda:0 over gloo."""
    dev = torch.device("cuda", rank if form == "nccl" else 0)
    torch.cuda.set_device(dev)
    return dev


def train_rank(rank: int, world: int, out_dir: str, form: str) -> int:
    """One rank of phase 20 (``chip_smoke.py --train-rank R N DIR FORM``):
    the 20a meshes of N ranks; with 4 ranks 20b and 20c, with 2 the
    trainer (20d). Reads the mesh-free step-1 gradients from
    DIR/../grads.pt; writes DIR/rank<R>.json."""
    import datetime
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    dev = rank_device(rank, form)
    dist.init_process_group(form, init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    tc, model, opt, raws = train20_setup()
    ref_grads = torch.load(os.path.join(out_dir, "..", "grads.pt"),
                           mmap=True)
    out = {}
    for shape in TRAIN20_MESHES:
        if int(np.prod(shape)) == world:
            out[str(shape)] = train20_mesh(model, opt, raws, shape, dev,
                                           ref_grads)
            torch.cuda.empty_cache()
    if world == 4:
        out["elastic"] = train20_elastic(model, opt, raws, dev, out_dir)
        out["collectives"] = train20_collectives(rank, world, dev)
    else:
        train_mod.reduced_config = train20_config
        stats = train_mod.train(dataclasses.replace(tc, mesh_shape=(2, 1),
                                                    device=dev.type))
        out["trainer"] = stats["losses"]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------ phase 21
DRY_TRAIN = ("minicpm-2b", 2, 8, 1024)       # phase 20's cut: arch, layers, B, S
DRY_DECODE = (ARCH, LAYERS, SLOTS, 4096)     # phase 4's cut, a 4096-row cache
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
# the prediction counts every storage the step's ops make; the card also
# holds what a CUDA kernel allocates for itself and the caching
# allocator's rounding (512-byte blocks), neither of which is an op's
# output: the measured memory above what was resident is held to the
# predicted memory above the arguments within 2 % of that prediction plus
# 8 MiB (measured on an H100: 21a +0.000 GiB of 24.032, 21b +0.001 GiB of
# 0.075, whose 0.071 GiB of temporaries the bound is well inside)
FOOTPRINT_REL = 0.02
FOOTPRINT_SLACK = 8 * 2**20
# dot products the profiler computes FLOPs for (``with_flops``)
PROFILER_DOTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
                 "aten::conv2d")


def profiled_flops(fn, label) -> dict:
    """{op name: FLOPs} of one call of ``fn`` under ``torch.profiler``'s
    ``with_flops`` (a session without events is run again)."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            fn()
            torch.cuda.synchronize()
        got = {e.key: int(e.flops) for e in prof.key_averages() if e.flops}
        if got:
            return got
        log(f"  (profiler session {attempt + 1} of {label} without flops; "
            f"again)")
        time.sleep(0.05 * 2 ** attempt)
    raise AssertionError(f"{label}: no profiler session with flops")


def dry_run_against_card(label, model, shape, card, compute_dtype, remat,
                         peak) -> dict:
    """The dry run's prediction of one step (fake tensors on a one-rank
    fake mesh), then the same ``build_gate`` step on the card on a
    one-rank NCCL mesh from an in-process store: its memory above what
    was resident before it, its dot FLOPs counted on the card and under
    ``torch.profiler``, its device time and its compute and memory terms
    at ``peak`` and 3.35 TB/s."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, hlo_stats
    t0 = time.perf_counter()
    with dryrun.fake_mesh((1, 1)) as (mesh, _), \
            FakeTensorMode(allow_non_fake_inputs=True):
        step, args = dryrun.build_gate(model, shape, mesh, remat=remat,
                                       compute_dtype=compute_dtype)
        cost, mem, _, _ = dryrun.count_step(step, args)
        del step, args
    pred_s = time.perf_counter() - t0
    fp = dryrun.footprint(mem)
    pred_above = fp - mem["argument_bytes"]
    bound = FOOTPRINT_REL * pred_above + FOOTPRINT_SLACK
    specs.check_serve_group(1, "cuda")
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda")
        step, args = dryrun.build_gate(model, shape, mesh, device="cuda",
                                       remat=remat,
                                       compute_dtype=compute_dtype)
        step(*args)                              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = step(*args)
        torch.cuda.synchronize()
        above = torch.cuda.max_memory_allocated() - before
        del out
        counter = hlo_stats.OpCounter()
        with counter:
            step(*args)
        flops = profiled_flops(lambda: step(*args), label)
        times = host_and_device(lambda: step(*args), label, card)
        del step, args
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    log(f"  {label}: predicted footprint {fp / 2**30:.3f} GiB (argument "
        f"{mem['argument_bytes'] / 2**30:.3f} + temp "
        f"{mem['temp_bytes'] / 2**30:.3f} + output "
        f"{mem['output_bytes'] / 2**30:.3f} - alias "
        f"{mem['alias_bytes'] / 2**30:.3f}), {pred_above / 2**30:.3f} GiB "
        f"above the arguments; on the card max_memory_allocated "
        f"{above / 2**30:.3f} GiB above what was resident (diff "
        f"{(above - pred_above) / 2**20:+.3f} MiB, bound "
        f"{bound / 2**20:.3f}); prediction took {pred_s:.1f} s "
        f"({card})")
    if abs(above - pred_above) > bound:
        raise AssertionError(f"{label}: the card's footprint above the "
                             f"resident {above} B is not the predicted "
                             f"{pred_above} B within {bound:.0f} B")
    if int(counter.dot_flops) != int(cost["dot_flops"]):
        raise AssertionError(f"{label}: dot FLOPs counted on the card "
                             f"{counter.dot_flops} differ from the "
                             f"prediction {cost['dot_flops']}")
    prof_dots = {k: v for k, v in flops.items() if k in PROFILER_DOTS}
    mine = {f"aten::{k}": v for k, v in counter.by_op.items()}
    rest = {k: v for k, v in flops.items() if k not in PROFILER_DOTS}
    log(f"  {label}: dot FLOPs counted {int(cost['dot_flops']):,} (fake "
        f"prediction = the card's own count; by op {mine}); torch.profiler "
        f"with_flops: dots {prof_dots}, elementwise {rest}")
    if prof_dots != mine:
        differ = sorted(k for k in set(prof_dots) | set(mine)
                        if prof_dots.get(k) != mine.get(k))
        raise AssertionError(f"{label}: the profiler's dot FLOPs differ "
                             f"from the count at {differ}: {prof_dots} "
                             f"against {mine}")
    compute_ms = cost["dot_flops"] / peak * 1e3
    memory_ms = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"  {label}: device busy {times['busy_ms']:.3f} ms a step (host "
        f"wall {times['wall_ms']:.3f}); compute term {compute_ms:.4f} ms "
        f"(dot FLOPs at {peak / 1e12:.0f} TFLOP/s), memory term "
        f"{memory_ms:.4f} ms ({cost['bytes'] / 1e9:.3f} GB of op inputs "
        f"and outputs, unfused, at 3.35 TB/s); the step's share of the "
        f"compute term {compute_ms / times['busy_ms']:.1%} of its busy time "
        f"({card})")
    return dict(footprint=fp, pred_above=pred_above, above=above,
                dot_flops=cost["dot_flops"], busy_ms=times["busy_ms"],
                compute_ms=compute_ms, memory_ms=memory_ms)


def phase21_dry_run(card):
    """21a: minicpm-2b at full width cut to 2 layers (phase 20's cut), a
    train step at B 8 x S 1024 in fp32; 21b: qwen2.5-32b at full width cut
    to 4 layers (phase 4's cut), the lockstep decode step at B 8 over a
    dense bf16 cache of 4096 rows with bf16 serve params. Each predicted
    by the dry run, then run on the card (``dry_run_against_card``)."""
    t21 = time.perf_counter()
    arch, layers, B, S = DRY_TRAIN
    model = get_model(dataclasses.replace(configs.get_config(arch),
                                          num_layers=layers))
    dry_run_against_card(
        f"21a {arch} ({layers} layers) train B {B} x S {S} fp32", model,
        configs.ShapeConfig("train", S, B, "train"), card, torch.float32,
        False, FP32_FLOPS)
    arch, layers, B, S = DRY_DECODE
    model = get_model(dataclasses.replace(configs.get_config(arch),
                                          num_layers=layers))
    dry_run_against_card(
        f"21b {arch} ({layers} layers) decode B {B} over {S} rows, bf16",
        model, configs.ShapeConfig("decode", S, B, "decode"), card,
        torch.bfloat16, False, BF16_FLOPS)
    from repro_torch.launch import dryrun
    free, total = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    slack = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    log(f"  the card's memory outside the caching allocator "
        f"{outside / 2**30:.3f} GiB, the allocator's cached and unused "
        f"{slack / 2**30:.3f} GiB: the dry run's reserve "
        f"{dryrun.RESERVE_GIB} GiB leaves a budget of "
        f"{dryrun.hbm_budget() / 2**30:.3f} GiB of "
        f"{total / 2**30:.3f} ({card})")
    log(f"  phase 21 took {time.perf_counter() - t21:.1f} s ({card})")


# ------------------------------------------------------------ phase 22
# the sequence over "model": qwen2.5-32b at full width cut to CP_LAYERS
# layers, fp32, on CP_MESH gloo ranks (40 heads over 8 kv heads divide no
# 3: the context-parallel form of the rows and the cache), a sharded
# prefill of CP_PREFILL rows and CP_STEPS lockstep decode steps over a
# cache of its CP_PREFILL[1] rows holding the first CP_PROMPT (the steps
# cross row 2048, from rank 1's block into rank 2's); hymba-1.5b cut to
# CP_LAYERS layers through the banded form at CP_HYMBA_MESH over
# CP_HYMBA rows
CP_LAYERS = 2
CP_MESH, CP_PREFILL, CP_PROMPT, CP_STEPS = (1, 3), (8, 3072), 2040, 16
CP_CHUNK = 1020                  # the mesh-free cache's prefill chunks
CP_HYMBA_MESH, CP_HYMBA = (1, 2), (2, 4096)
CP_TOL = 1e-4                    # the CPU tests' SERVE_TOL
CP_TIMEOUT = 300
CP_PROFILED = 8                  # decode steps under torch.profiler


def cp_model(arch):
    return get_model(dataclasses.replace(configs.get_config(arch),
                                         num_layers=CP_LAYERS))


def cp_params(model, dev):
    return model.init(torch.Generator(dev).manual_seed(0), dev)


def cp_tokens(vocab, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32))


def phase22_sequence_split(card):
    """22a: qwen2.5-32b (CP_LAYERS layers, fp32) mesh-free here: the
    prefill's logits over CP_PREFILL rows, then a cache of CP_PREFILL[1]
    rows prefilled to CP_PROMPT and CP_STEPS greedy decode steps; the same
    on CP_MESH spawned ranks (``chip_smoke.py --cp-rank``), the rows and
    the cache's sequence split over "model": logits within CP_TOL, tokens
    equal, the rows the steps wrote equal in each rank's block; each
    rank's collective bytes a decode step beside the per-layer cache
    gather's, its wall and device busy a step. 22b: hymba-1.5b's prefill
    through the banded form at CP_HYMBA_MESH within CP_TOL of mesh-free,
    its ranks running beside 22a's."""
    t22 = time.perf_counter()
    f32 = dict(compute_dtype=torch.float32)
    model = cp_model(ARCH)
    cfg = model.cfg
    B, S = CP_PREFILL
    with tempfile.TemporaryDirectory() as d:
        with torch.no_grad():
            params = cp_params(model, DEV)
            tokens = cp_tokens(cfg.vocab_size, CP_PREFILL, 22)
            toks = tokens.to(DEV)
            ref = steps.make_prefill(model, attn_impl="chunked", **f32)(
                params, {"tokens": toks})
            cache = model.init_cache(B, S, torch.float32, device=DEV)
            for a in range(0, CP_PROMPT, CP_CHUNK):
                _, cache = model.prefill_chunk(
                    params, toks[:, a:a + CP_CHUNK], cache,
                    attn_impl="einsum", first=a == 0, **f32)
            start = {k: v.cpu() for k, v in cache.items()}
            decode = steps.make_decode_step(model, **f32)
            tok, dec_logits, dec_tokens = toks[:, CP_PROMPT:CP_PROMPT + 1], \
                [], []
            for _ in range(CP_STEPS):
                out, cache = decode(params, cache, {"token": tok})
                tok = out[:, -1].argmax(-1, keepdim=True).int()
                dec_logits.append(out.cpu())
                dec_tokens.append(tok[:, 0].tolist())
            rows = slice(CP_PROMPT, CP_PROMPT + CP_STEPS)
            torch.save({"tokens": tokens, "prefill": ref.cpu(),
                        "cache": start, "logits": dec_logits,
                        "tokens_out": dec_tokens,
                        "rows": {k: cache[k][:, :, rows].cpu()
                                 for k in ("k", "v")}},
                       os.path.join(d, "qwen.pt"))
        del params, cache, ref, start
        torch.cuda.empty_cache()
        gather = 2 * cfg.num_layers * B * S * cfg.num_kv_heads \
            * cfg.head_dim * 4
        model = cp_model(HYMBA)
        kw = dict(attn_impl="banded", scan_impl="scan", **f32)
        with torch.no_grad():
            params = cp_params(model, DEV)
            tokens = cp_tokens(model.cfg.vocab_size, CP_HYMBA, 23)
            ref = steps.make_prefill(model, **kw)(params,
                                                  {"tokens": tokens.to(DEV)})
            torch.save({"tokens": tokens, "prefill": ref.cpu()},
                       os.path.join(d, "hymba.pt"))
        del params, ref
        torch.cuda.empty_cache()
        log(f"  22a {ARCH} ({CP_LAYERS} layers, fp32) mesh-free: prefill "
            f"{B} x {S}, a cache of {S} rows to {CP_PROMPT}, {CP_STEPS} "
            f"greedy steps; 22b's mesh-free prefill; spawning "
            f"{int(np.prod(CP_MESH))} ranks at {CP_MESH} and "
            f"{int(np.prod(CP_HYMBA_MESH))} at {CP_HYMBA_MESH} at once "
            f"({time.perf_counter() - t22:.1f} s so far)")
        groups = []
        for name, mesh in (("qwen", CP_MESH), ("hymba", CP_HYMBA_MESH)):
            run = os.path.join(d, name)
            os.mkdir(run)
            groups.append(start_ranks(int(np.prod(mesh)), run, "--cp-rank"))
        (form, ranks, took), (hform, hranks, htook) = wait_ranks(groups,
                                                                 CP_TIMEOUT)
        for r, got in enumerate(ranks):
            if not (got["prefill_err"] < CP_TOL and got["logits_err"] < CP_TOL
                    and got["rows_err"] < CP_TOL
                    and got["tokens"] == dec_tokens):
                raise AssertionError(f"22a rank {r}: {got}")
        log(f"  22a {CP_MESH} ({form}"
            + (", all on cuda:0, the collectives staged through the host"
               if form == "gloo" else "")
            + f", {took:.1f} s): prefill logits within "
            f"{max(g['prefill_err'] for g in ranks):.3e}, decode logits "
            f"within {max(g['logits_err'] for g in ranks):.3e} (bound "
            f"{CP_TOL}), greedy tokens equal over {CP_STEPS} steps, the "
            f"written rows within {max(g['rows_err'] for g in ranks):.3e}")
        for r, got in enumerate(ranks):
            log(f"  22a rank {r}: prefill wall {got['prefill_s']:.3f} s, "
                f"collectives {got['prefill_coll']}; a decode step's "
                f"collectives {got['step_coll']} B, where a gather of "
                f"each layer's K and V would have moved {gather:,} B; "
                f"decode wall a step {got['walls']} s; over the last "
                f"{CP_PROFILED} steps {got['busy'] * 1e3:.3f} ms device "
                f"busy a step of {got['wall'] * 1e3:.3f} ms wall "
                f"({card})")
        for r, got in enumerate(hranks):
            if not got["err"] < CP_TOL or not got["permutes"]:
                raise AssertionError(f"22b rank {r}: {got}")
        log(f"  22b {HYMBA} ({CP_LAYERS} layers, fp32) prefill {CP_HYMBA[0]}"
            f" x {CP_HYMBA[1]} through the banded form at {CP_HYMBA_MESH} "
            f"({hform}, {htook:.1f} s, beside 22a's ranks): logits within "
            f"{max(g['err'] for g in hranks):.3e} of mesh-free (bound "
            f"{CP_TOL}); rank 0's collectives {hranks[0]['coll']} B, "
            f"prefill wall {[round(g['wall'], 3) for g in hranks]} s")
    log(f"  phase 22 took {time.perf_counter() - t22:.1f} s ({card})")


def cp_qwen_rank(dev, out_dir):
    """22a on this rank (CP_MESH): the sharded prefill and the greedy
    decode over the rank's block of the cache (``sharded_serve``), held to
    the mesh-free run in DIR/../qwen.pt, and the rows the steps wrote in
    the rank's block."""
    ref = torch.load(os.path.join(out_dir, "..", "qwen.pt"), mmap=True)
    model = cp_model(ARCH)
    mesh = mesh_mod.make_mesh(CP_MESH, ("data", "model"), dev.type)
    with torch.no_grad():
        params = cp_params(model, dev)
        with specs.use_mesh(mesh):
            p = steps.place(params, steps.param_shardings(model, params))
        del params
        torch.cuda.empty_cache()
    prefill = steps.make_prefill(model, attn_impl="chunked", sharded=True,
                                 compute_dtype=torch.float32)
    first = ref["tokens"][:, CP_PROMPT:CP_PROMPT + 1].to(dev)
    out, c = sharded_serve(model, mesh, p, ref, prefill, first, CP_STEPS,
                           CP_PROFILED)
    rows_err = 0.0
    for k in ("k", "v"):
        own = c[k].to_local()
        s_loc = own.shape[2]
        lo = mesh.get_local_rank("model") * s_loc
        for j in range(CP_STEPS):
            row = CP_PROMPT + j
            if lo <= row < lo + s_loc:
                rows_err = max(rows_err, float(
                    (own[:, :, row - lo].cpu() - ref["rows"][k][:, :, j])
                    .abs().max()))
    return dict(out, rows_err=rows_err)


def cp_hymba_rank(dev, out_dir):
    """22b on this rank (CP_HYMBA_MESH): hymba's sharded prefill through
    the banded form, held to DIR/../hymba.pt."""
    from repro_torch.launch import hlo_stats
    ref = torch.load(os.path.join(out_dir, "..", "hymba.pt"))
    model = cp_model(HYMBA)
    mesh = mesh_mod.make_mesh(CP_HYMBA_MESH, ("data", "model"), dev.type)
    with torch.no_grad():
        params = cp_params(model, dev)
        tokens = ref["tokens"].to(dev)
        with specs.use_mesh(mesh):
            p = steps.place(params, steps.param_shardings(model, params))
            b = steps.place({"tokens": tokens}, steps.batch_shardings(
                model, {"tokens": tokens}))
        del params
        prefill = steps.make_prefill(model, attn_impl="banded",
                                     scan_impl="scan", sharded=True,
                                     compute_dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with hlo_stats.collectives() as records:
            logits = prefill(p, b)
        torch.cuda.synchronize()
    return {"err": float((logits.cpu() - ref["prefill"]).abs().max()),
            "wall": time.perf_counter() - t0,
            "coll": hlo_stats.collective_bytes(records),
            "permutes": sum(1 for kind, _, _ in records
                            if kind == "collective-permute")}


def cp_rank(rank: int, world: int, out_dir: str, form: str) -> int:
    """One rank of phase 22 (``chip_smoke.py --cp-rank R N DIR FORM``):
    22a with CP_MESH's ranks, 22b with CP_HYMBA_MESH's; writes
    DIR/rank<R>.json."""
    import datetime
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(rank, form)
    dist.init_process_group(form, init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    out = (cp_qwen_rank(dev, out_dir) if world == int(np.prod(CP_MESH))
           else cp_hymba_rank(dev, out_dir))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------ phase 23
# the MoE family over the mesh, fp32, TF32 off, ranks spawned as phase
# 22's (gloo on cuda:0 with one card): (23a) moonshot-v1-16b-a3b at full
# width cut to EP_TRAIN_LAYERS layers, one sharded train step at
# EP_TRAIN_MESH on EP_TRAIN_BATCH (64 experts: 32 a rank; 16 heads over
# 16 kv heads over "model"; the rows over "model"); (23b) dbrx-132b at full
# width cut to EP_SERVE_LAYERS layer, the params placed by the serving
# rules (over "model" only), a sharded prefill of EP_PREFILL at
# EP_SERVE_MESH (the global 4,096 tokens: 32 groups, 16 a data rank; 16
# experts: 8 a rank; 48 heads over 8 kv heads over "model") and
# EP_STEPS greedy lockstep decode steps (one token a row: one group,
# every rank's rows gathered)
EP_TRAIN_ARCH, EP_TRAIN_LAYERS = "moonshot-v1-16b-a3b", 2
EP_TRAIN_MESH, EP_TRAIN_BATCH = (1, 2), (4, 512)
EP_SERVE_LAYERS, EP_SERVE_MESH, EP_PREFILL, EP_STEPS = 1, (2, 2), (8, 512), 8
EP_TIMEOUT = 400
EP_SCOPE = "moe"                 # the profiler range around layers.moe


def ep_model(arch, layers):
    return get_model(dataclasses.replace(configs.get_config(arch),
                                         num_layers=layers))


@contextlib.contextmanager
def moe_scoped():
    """Every ``layers.moe`` call inside a profiler range named EP_SCOPE."""
    moe = layers_mod.moe

    def scoped(*args, **kw):
        with torch.profiler.record_function(EP_SCOPE):
            return moe(*args, **kw)
    layers_mod.moe = scoped
    try:
        yield
    finally:
        layers_mod.moe = moe


def moe_profiled(fn):
    """(``fn()``, its profile with FLOPs, the dot FLOPs that
    ``torch.profiler``'s ``with_flops`` gives the ops under EP_SCOPE: the
    MoE layers' forward; a backward runs on autograd's thread, outside)."""
    from torch.profiler import ProfilerActivity, profile
    with moe_scoped(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA],
                               with_flops=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    flops = 0
    for e in prof.events():
        if e.flops and e.name in PROFILER_DOTS:
            p = e.cpu_parent
            while p is not None and p.name != EP_SCOPE:
                p = p.cpu_parent
            flops += int(e.flops) if p is not None else 0
    return out, prof, flops


def one_rank_at_a_time(fn):
    """``fn()`` on each rank in turn (a barrier after each), so that only
    one rank at a time holds the whole model it cuts its blocks from."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def zero_blocks(placed):
    """Zeros of each DTensor's block, as DTensors of its placement."""
    from torch.distributed.tensor import DTensor
    return {k: zero_blocks(v) if isinstance(v, dict) else DTensor.from_local(
        torch.zeros_like(v.to_local()), v.device_mesh, v.placements,
        run_check=False) for k, v in placed.items()}


def profiled_call(fn):
    """(``fn()``, its profile (host and device), no FLOPs): the plain
    form of ``moe_profiled``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof, None


def sharded_serve(model, mesh, p, ref, prefill, first, n_steps, profiled,
                  run=None):
    """Phases 22-24's serving leg on this rank, the params ``p`` placed on
    ``mesh``: ``prefill`` (a sharded prefill step) of ref["tokens"] held
    to ref["prefill"], under ``run`` where given (``fn -> (fn(), profile,
    FLOPs)``: its device busy and FLOPs kept); then ``n_steps`` greedy
    lockstep decode steps from the token ``first`` over ref["cache"]
    (placed by the cache shardings), held to ref["logits"], the last
    ``profiled`` of them under ``run`` (default ``profiled_call``).
    Returns ({prefill_s, prefill_coll, prefill_err, [prefill_busy,
    prefill_flops], step_coll (the first step's collective bytes),
    logits_err, tokens, walls, busy and wall a profiled step, step_flops
    (the profiled steps'), }, the cache after the steps)."""
    from repro_torch.launch import hlo_stats
    dev = first.device
    out = {}
    with torch.no_grad():
        tokens = ref["tokens"].to(dev)
        with specs.use_mesh(mesh):
            b = steps.place({"tokens": tokens}, steps.batch_shardings(
                model, {"tokens": tokens}))
            csh = steps.cache_shardings(model, ref["cache"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with hlo_stats.collectives() as records:
            if run is None:
                logits = prefill(p, b)
                torch.cuda.synchronize()
            else:
                logits, prof, flops = run(lambda: prefill(p, b))
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_coll"] = hlo_stats.collective_bytes(records)
        out["prefill_err"] = float((logits.cpu() - ref["prefill"]).abs()
                                   .max())
        if run is not None:
            out["prefill_busy"] = step_breakdown(prof, out["prefill_s"])[
                "busy"]
            out["prefill_flops"] = flops
        del logits
        cache = {k: specs.distribute(v, csh[k], dev)
                 for k, v in ref["cache"].items()}
        decode = steps.make_decode_step(model, sharded=True,
                                        compute_dtype=torch.float32)
        now = {"tok": first, "cache": cache, "err": 0.0}
        toks, walls = [], []

        def step(i):
            tok = now["tok"]
            with specs.use_mesh(mesh):
                bt = steps.place({"token": tok}, steps.batch_shardings(
                    model, {"token": tok}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hlo_stats.collectives() as records:
                logits, now["cache"] = decode(p, now["cache"], bt)
            torch.cuda.synchronize()
            walls.append(round(time.perf_counter() - t0, 4))
            if i == 0:
                out["step_coll"] = hlo_stats.collective_bytes(records)
            now["err"] = max(now["err"], float(
                (logits.cpu() - ref["logits"][i]).abs().max()))
            now["tok"] = logits[:, -1].argmax(-1, keepdim=True).int()
            toks.append(now["tok"][:, 0].tolist())
        for i in range(n_steps - profiled):
            step(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, prof, flops = (run or profiled_call)(
            lambda: [step(i) for i in range(n_steps - profiled, n_steps)])
        wall = time.perf_counter() - t0
    out.update(logits_err=now["err"], tokens=toks, walls=walls,
               step_flops=flops,
               busy=step_breakdown(prof, wall)["busy"] / profiled,
               wall=wall / profiled)
    return out, now["cache"]


def sharded_train(model, mesh, batch, make_params, run=None,
                  float64=False):
    """Phases 23-24's train leg on this rank: the mesh-free step-1 loss,
    metrics and gradients of ``make_params()`` on ``batch`` (one rank at
    a time; the rank keeps its blocks), then one sharded train step from
    the same params, its gradients under ``run`` where given (``fn ->
    (fn(), profile, FLOPs)``: the FLOPs of both runs and the step's busy
    kept). With ``float64`` both step-1 gradients are also taken under
    ``witness.float64``. Returns {params (count), loss, ref_loss,
    loss_diff, metrics, ref_metrics, errs: {leaf: {fp32 (of the mesh-free
    fp32 block's largest), and with ``float64`` float64, fp32_truth and
    free_truth (the sharded and mesh-free fp32 blocks against the float64
    mesh-free one), each of the float64 block's largest}}, zero (the
    leaves whose gradient is zero in both), flops, ref_flops, coll, wall,
    busy, peak_gib}, and the placed params after the update."""
    from repro_torch.launch import hlo_stats, witness
    dev = batch["tokens"].device
    run = run or (lambda fn: (fn(), None, None))
    opt = AdamW(learning_rate=1e-3)
    loss_fn = steps.make_loss_fn(model, compute_dtype=torch.float32,
                                 remat=False)
    loss64 = steps.make_loss_fn(model, compute_dtype=torch.float64,
                                remat=False)
    with specs.use_mesh(mesh):
        sh = steps.state_shardings(model, steps.train_state_shapes(model,
                                                                   opt))
        pbatch = steps.place(batch, steps.batch_shardings(model, batch))

    def blocks(grads):
        return {n: specs.local_block(g, s).clone() for (n, g), (_, s) in
                zip(named_leaves(grads), named_leaves(sh["params"]))}

    def setup():
        params = make_params()
        ((loss, metrics), grads), _, flops = run(
            lambda: steps.value_and_grad(loss_fn)(params, batch))
        ref = {"loss": float(loss), "flops": flops, "grads": blocks(grads),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "params": sum(t.numel() for t in tree_leaves(params))}
        del grads
        if float64:
            with witness.float64():
                p64 = witness.to_float64(params)
                ref["grads64"] = blocks(steps.value_and_grad(loss64)(
                    p64, batch)[1])
                ref["placed64"] = steps.place(p64, sh["params"])
            del p64
        ref["placed"] = steps.place(params, sh["params"])
        return ref
    ref = one_rank_at_a_time(setup)
    placed = ref["placed"]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = {"params": placed,
             "opt": {"m": zero_blocks(placed), "v": zero_blocks(placed),
                     "count": specs.distribute(zero, sh["opt"]["count"])},
             "step": specs.distribute(zero, sh["step"])}
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with hlo_stats.collectives() as records:
        ((loss, metrics), grads), prof, flops = run(
            lambda: steps.sharded_value_and_grad(model, loss_fn)(
                state["params"], pbatch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def rel(a, b, big):       # in the wider of the two dtypes
        return float((a - b).abs().max()) / big
    errs, zeros = {}, []
    got = dict(named_leaves(grads))
    for name, g in got.items():
        want = ref["grads"][name]
        big = float(want.abs().max())
        if big == 0 and float(g.abs().max()) == 0:
            zeros.append(name)
        errs[name] = {"fp32": rel(g, want, max(big, 1e-30))}
    if float64:
        with witness.float64():
            _, got64 = steps.sharded_value_and_grad(model, loss64)(
                ref.pop("placed64"), pbatch)
        for name, g64 in named_leaves(got64):
            want64 = ref["grads64"][name]
            big = max(float(want64.abs().max()), 1e-300)
            errs[name].update(
                float64=rel(g64, want64, big),
                fp32_truth=rel(got[name], want64, big),
                free_truth=rel(ref["grads"][name], want64, big))
        del got64
    ref = {k: ref[k] for k in ("params", "loss", "metrics", "flops")}
    del got
    torch.cuda.empty_cache()
    state, _ = steps.sharded_update(opt, state, grads)
    torch.cuda.synchronize()
    return {"params": ref["params"], "loss": float(loss),
            "ref_loss": ref["loss"],
            "loss_diff": abs(float(loss) - ref["loss"]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "ref_metrics": ref["metrics"], "errs": errs, "zero": zeros,
            "flops": flops, "ref_flops": ref["flops"],
            "coll": hlo_stats.collective_bytes(records), "wall": wall,
            "busy": None if prof is None else step_breakdown(prof, wall)[
                "busy"],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}, \
        state["params"]


def phase23_moe_mesh(card):
    """23a: EP_TRAIN_ARCH on EP_TRAIN_MESH spawned ranks (``chip_smoke.py
    --ep-rank``): each computes the mesh-free step-1 loss and gradients in
    turn (keeping its blocks), then the sharded train step: its loss
    within TRAIN20_TOL, its step-1 gradient blocks within GRAD20_TOL of
    each leaf's largest, the aux losses beside mesh-free's. 23b: dbrx-132b
    mesh-free here (the prefill's logits, a cache prefilled with the
    prompt, EP_STEPS greedy decode steps), then on EP_SERVE_MESH ranks:
    the sharded prefill's and decode's logits within CP_TOL, tokens
    equal. Each leg prints each rank's MoE forward dot FLOPs (the
    profiler's ``with_flops``) against mesh-free's, its collective bytes
    by kind, its wall and device busy."""
    t23 = time.perf_counter()
    f32 = dict(compute_dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        run = os.path.join(d, "train")
        os.mkdir(run)
        form, ranks = spawn_ranks(int(np.prod(EP_TRAIN_MESH)), run,
                                  "--ep-rank", EP_TIMEOUT)
        for r, got in enumerate(ranks):
            if not (got["loss_diff"] < TRAIN20_TOL
                    and got["grad_err"] < GRAD20_TOL):
                raise AssertionError(f"23a rank {r}: {got}")
        log(f"  23a {EP_TRAIN_ARCH} ({EP_TRAIN_LAYERS} layers, "
            f"{ranks[0]['params'] / 1e9:.3f} B params, fp32) one train step"
            f" of {EP_TRAIN_BATCH[0]} x {EP_TRAIN_BATCH[1]} at "
            f"{EP_TRAIN_MESH} ({form}"
            + (", all on cuda:0, the collectives staged through the host"
               if form == "gloo" else "")
            + f", {time.perf_counter() - t0:.1f} s): loss "
            f"{ranks[0]['loss']:.6f} against mesh-free "
            f"{ranks[0]['ref_loss']:.6f} (diff "
            f"{max(g['loss_diff'] for g in ranks):.3e}, bound "
            f"{TRAIN20_TOL}); step-1 gradients within "
            f"{max(g['grad_err'] for g in ranks):.3e} of each leaf's "
            f"largest (bound {GRAD20_TOL}; router, w_gate, w_up, w_down: "
            f"{ranks[0]['moe_err']}); moe_aux / moe_z within "
            f"{max(g['aux_diff'] for g in ranks):.3e} of mesh-free's")
        for r, got in enumerate(ranks):
            log(f"  23a rank {r}: keeps {got['keeps']}, {got['experts']} "
                f"experts; MoE forward dot FLOPs {got['moe_flops']:,} "
                f"against mesh-free's {got['ref_moe_flops']:,} "
                f"({got['moe_flops'] / max(got['ref_moe_flops'], 1):.4f}); "
                f"collectives {got['coll']} B; the step (gradients under "
                f"the profiler) {got['wall']:.3f} s wall, "
                f"{got['busy']:.3f} s device busy; peak memory "
                f"{got['peak_gib']:.2f} GiB ({card})")

        t0 = time.perf_counter()
        model = ep_model(DBRX, EP_SERVE_LAYERS)
        cfg = model.cfg
        B, S = EP_PREFILL
        with torch.no_grad():
            params = cp_params(model, DEV)
            tokens = cp_tokens(cfg.vocab_size, EP_PREFILL, 24)
            toks = tokens.to(DEV)
            ref, _, ref_flops = moe_profiled(lambda: steps.make_prefill(
                model, attn_impl="einsum", **f32)(params, {"tokens": toks}))
            cache = model.init_cache(B, S + EP_STEPS, torch.float32,
                                     device=DEV)
            _, cache = model.prefill_chunk(params, toks, cache,
                                           attn_impl="einsum", first=True,
                                           **f32)
            start = {k: v.cpu() for k, v in cache.items()}
            decode = steps.make_decode_step(model, **f32)
            first = ref[:, -1].argmax(-1, keepdim=True).int()
            tok, dec_logits, dec_tokens = first, [], []
            for i in range(EP_STEPS):
                (out, cache), _, flops = moe_profiled(
                    lambda: decode(params, cache, {"token": tok}))
                tok = out[:, -1].argmax(-1, keepdim=True).int()
                dec_logits.append(out.cpu())
                dec_tokens.append(tok[:, 0].tolist())
            torch.save({"tokens": tokens, "prefill": ref.cpu(),
                        "cache": start, "first": first.cpu(),
                        "logits": dec_logits, "tokens_out": dec_tokens},
                       os.path.join(d, "dbrx.pt"))
        n_params = sum(t.numel() for t in tree_leaves(params))
        del params, cache, ref, start
        torch.cuda.empty_cache()
        log(f"  23b {DBRX} ({EP_SERVE_LAYERS} layer, {n_params / 1e9:.3f} B "
            f"params, fp32) mesh-free: prefill {B} x {S} (MoE forward dot "
            f"FLOPs {ref_flops:,}), {EP_STEPS} greedy decode steps (the "
            f"last's MoE {flops:,}); spawning {int(np.prod(EP_SERVE_MESH))} "
            f"ranks at {EP_SERVE_MESH} ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        run = os.path.join(d, "serve")
        os.mkdir(run)
        form, ranks = spawn_ranks(int(np.prod(EP_SERVE_MESH)), run,
                                  "--ep-rank", EP_TIMEOUT)
        for r, got in enumerate(ranks):
            if not (got["prefill_err"] < CP_TOL and got["logits_err"] < CP_TOL
                    and got["tokens"] == dec_tokens):
                raise AssertionError(f"23b rank {r}: {got}")
        log(f"  23b {EP_SERVE_MESH} ({form}, {time.perf_counter() - t0:.1f} "
            f"s): prefill logits within "
            f"{max(g['prefill_err'] for g in ranks):.3e}, decode logits "
            f"within {max(g['logits_err'] for g in ranks):.3e} (bound "
            f"{CP_TOL}), greedy tokens equal over {EP_STEPS} steps")
        for r, got in enumerate(ranks):
            log(f"  23b rank {r}: keeps {got['keeps']}, {got['experts']} "
                f"experts, routed {got['routed']} tokens of {B * S}; "
                f"prefill MoE forward dot FLOPs {got['moe_flops']:,} "
                f"against mesh-free's {ref_flops:,} "
                f"({got['moe_flops'] / max(ref_flops, 1):.4f}), collectives "
                f"{got['prefill_coll']} B, {got['prefill_s']:.3f} s wall "
                f"(under the profiler), {got['prefill_busy']:.3f} s busy; "
                f"a decode step's MoE {got['step_flops']:,} against "
                f"{flops:,}, collectives {got['step_coll']} B, wall "
                f"{got['walls']} s, the last step {got['busy'] * 1e3:.3f} "
                f"ms busy ({card})")
    log(f"  phase 23 took {time.perf_counter() - t23:.1f} s ({card})")


def ep_train_rank(dev, out_dir):
    """23a on this rank: the mesh-free step-1 loss and gradients (one rank
    at a time; the rank keeps its blocks), then the sharded step
    (``sharded_train``), the MoE layers' forward FLOPs of both counted."""
    from repro_torch.sharding import spmd
    model = ep_model(EP_TRAIN_ARCH, EP_TRAIN_LAYERS)
    mesh = mesh_mod.make_mesh(EP_TRAIN_MESH, ("data", "model"), dev.type)
    toks = cp_tokens(model.cfg.vocab_size, EP_TRAIN_BATCH, 23)
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, 1).to(dev)}
    out, placed = sharded_train(
        model, mesh, batch,
        lambda: model.init(torch.Generator(dev).manual_seed(0), dev),
        run=moe_profiled)
    errs = {name: e["fp32"] for name, e in out.pop("errs").items()}
    return dict(
        out, grad_err=max(errs.values()),
        moe_err={name.split("/")[-1]: float(f"{e:.3e}")
                 for name, e in errs.items() if name.split("/")[-1] in
                 ("router", "w_gate", "w_up", "w_down")},
        aux_diff=max(abs(out["metrics"][k] - out["ref_metrics"][k])
                     for k in ("moe_aux", "moe_z")),
        keeps=sorted(spmd.tp_keeps(model.cfg, mesh)),
        experts=placed["layers"]["moe"]["w_gate"].to_local().shape[1],
        moe_flops=out["flops"], ref_moe_flops=out["ref_flops"])


def ep_serve_rank(dev, out_dir):
    """23b on this rank: the params placed one rank at a time, the sharded
    prefill and EP_STEPS lockstep decode steps against DIR/../dbrx.pt
    (``sharded_serve``), the MoE layers' forward FLOPs of the prefill and
    the last step counted, the tokens each MoE layer routed."""
    from repro_torch.sharding import spmd
    ref = torch.load(os.path.join(out_dir, "..", "dbrx.pt"))
    model = ep_model(DBRX, EP_SERVE_LAYERS)
    mesh = mesh_mod.make_mesh(EP_SERVE_MESH, ("data", "model"), dev.type)
    with specs.use_mesh(mesh, specs.SERVE_RULES):
        psh = steps.param_shardings(model, model.init(torch.Generator(),
                                                      "meta"))
    p = one_rank_at_a_time(lambda: steps.place(cp_params(model, dev), psh))
    prefill = steps.make_prefill(model, attn_impl="einsum", sharded=True,
                                 compute_dtype=torch.float32)
    routed = []

    def traced(p, b):
        layers_mod.MOE_TRACE = []
        try:
            return prefill(p, b)
        finally:
            routed.extend(t["kept"].shape[0] for t in layers_mod.MOE_TRACE)
            layers_mod.MOE_TRACE = None
    out, _ = sharded_serve(model, mesh, p, ref, traced, ref["first"].to(dev),
                           EP_STEPS, 1, run=moe_profiled)
    return dict(out, keeps=sorted(spmd.tp_keeps(model.cfg, mesh)),
                experts=p["layers"]["moe"]["w_gate"].to_local().shape[1],
                routed=routed, moe_flops=out["prefill_flops"])


def ep_rank(rank: int, world: int, out_dir: str, form: str) -> int:
    """One rank of phase 23 (``chip_smoke.py --ep-rank R N DIR FORM``): 23a
    with EP_TRAIN_MESH's ranks, 23b with EP_SERVE_MESH's; writes
    DIR/rank<R>.json."""
    import datetime
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(rank, form)
    dist.init_process_group(form, init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    out = (ep_train_rank(dev, out_dir)
           if world == int(np.prod(EP_TRAIN_MESH))
           else ep_serve_rank(dev, out_dir))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------ phase 24
# the recurrent families over the mesh, fp32, TF32 off: (24a) K5 at
# rwkv6-7b's width and K6 at hymba-1.5b's on each rank's slab at every
# "model" size of SLAB_WAYS, in this process, at SLAB_SHAPES' (B, T);
# (24b) rwkv6-7b, then hymba-1.5b, at full width cut to REC_LAYERS
# layers (noise on the constant leaves, as phases 9 and 10), a sharded
# prefill of REC_PREFILL and REC_STEPS greedy lockstep decode steps at
# REC_MESH: the heads (rwkv6) or channels (hymba) over "model", the rows
# too in the prefill; (24c) one sharded train step of rwkv6-7b (its
# REC_LAYERS, the same noise) on REC_TRAIN_BATCH at REC_MESH. 24b and 24c
# run in one spawn of REC_MESH's ranks (gloo on cuda:0 with one card)
SLAB_WAYS = (2, 4, 16)
SLAB_SHAPES = {"chunk": (1, 64), "tick": (SLOTS, 1)}
REC_LAYERS, REC_MESH, REC_PREFILL, REC_STEPS = 2, (1, 2), (4, 256), 8
REC_TRAIN_BATCH = (2, 256)
# 24c's step-1 gradients are held in float64 (``launch.witness``) to
# GRAD20_TOL; in fp32 rwkv6's sit from float64's by more than that, the
# mesh-free ones too (its gradients are ill-conditioned: a relative
# 2^-24 on every weight moves them by as much, ``rwkv_rounding.py
# --grads``), so the sharded fp32 ones are held to sit no farther from
# float64's than GRAD20_TOL or REC_FP32_SPREAD times the mesh-free fp32
# ones' distance, whichever is larger
REC_FP32_SPREAD = 2
# the leaves a split compute reads in part, or whose gradient crosses the
# rows over "model", printed by name
REC_NAMED = ("mu_x", "mu", "lora_A", "lora_B", "w0", "wA", "wB", "u",
             "gn_scale", "cr", "wr", "wo", "ck", "cv", "cmu_k", "cmu_r")
REC_PROFILED = 4                 # decode steps under torch.profiler
REC_TIMEOUT = 400


def scan_slab(name, args, lo, n):
    """A rank's contiguous slab of a K5 / K6 launch's inputs: its heads
    [lo, lo + n) of r, k, v, w, u, s0 (K5) or its channels of x, dt, a,
    h0 with b and c whole (K6)."""
    if name == "wkv6":
        r, k, v, w, u, s0 = args
        return [t[:, :, lo:lo + n].contiguous() for t in (r, k, v, w)] + [
            u[lo:lo + n].contiguous(), s0[:, lo:lo + n].contiguous()]
    x, dt, b, c, a, h0 = args
    return [x[..., lo:lo + n].contiguous(), dt[..., lo:lo + n].contiguous(),
            b, c, a[lo:lo + n].contiguous(), h0[:, lo:lo + n].contiguous()]


def scan_cut(name, out, lo, n):
    """The same heads / channels of a whole launch's (y, final state)."""
    y, state = out
    if name == "wkv6":
        return y[:, :, lo:lo + n], state[:, lo:lo + n]
    return y[..., lo:lo + n], state[:, lo:lo + n]


def phase24a_slabs(card):
    """K5 at rwkv6-7b's width (64 heads of 64) and K6 at hymba-1.5b's (1600
    channels, state 16) at each of SLAB_SHAPES: every rank's slab at each
    "model" size of SLAB_WAYS (H / M heads, D / M channels, contiguous)
    launched alone must equal the same heads' or channels' y and final
    state of the whole launch bit for bit; rank 0's slab against its plain
    version (KERNEL_TOL), its device time beside the whole launch's and
    the slab's bound. Returns {(kernel, shape, M): {err, ms, plain_ms,
    bound_ms, bound_by}} (M = 1: the whole launch)."""
    rwkv, hymba = configs.get_config(RWKV), configs.get_config(HYMBA)
    out = {}
    for kind, (B, T) in SLAB_SHAPES.items():
        for name, W, N, case, fn, plain, bound in (
                ("wkv6", rwkv.num_heads, rwkv.head_dim, wkv_case, ls.wkv6,
                 ref.wkv6, wkv_bound),
                ("selective_scan", hymba.d_model, hymba.ssm_state,
                 sscan_case, ls.selective_scan, ref.selective_scan,
                 sscan_bound)):
            args = case(240, B, T, W, N)
            whole = fn(*args)
            for ways in (1,) + SLAB_WAYS:
                n = W // ways
                slabs = [scan_slab(name, args, r * n, n) for r in range(ways)]
                for r, sa in enumerate(slabs):
                    got = fn(*sa)
                    if not all(torch.equal(g, w) for g, w in zip(
                            got, scan_cut(name, whole, r * n, n))):
                        raise AssertionError(f"24a {name}[{kind}] rank {r} "
                                             f"of {ways}: its slab differs "
                                             f"from the whole launch's")
                err = scan_held(f"24a {name}[{kind}] {ways} ways, rank 0's "
                                f"slab ({n} of {W})", fn(*slabs[0]),
                                plain(*slabs[0]))
                ms = device_ms(lambda: fn(*slabs[0]), 30, SCAN_KERNELS[name])
                plain_ms = time_ms(lambda: plain(*slabs[0]), 3)
                bms, by = bound(B, T, n, N)
                out[(name, kind, ways)] = dict(err=err, ms=ms,
                                               plain_ms=plain_ms,
                                               bound_ms=bms, bound_by=by)
            log(f"  24a {name}[{kind}] B={B} T={T}: every slab at "
                f"{SLAB_WAYS} ways bit-equal to the whole launch's; "
                "device ms (bound ms) whole / " + " / ".join(
                    f"{W // m} {'heads' if name == 'wkv6' else 'channels'}"
                    for m in SLAB_WAYS) + ": " + " / ".join(
                    f"{out[(name, kind, m)]['ms']:.4f} "
                    f"({out[(name, kind, m)]['bound_ms']:.4f})"
                    for m in (1,) + SLAB_WAYS) + f" ({card})")
            del args, whole
    torch.cuda.empty_cache()
    return out


def rec_model(arch, layers=REC_LAYERS):
    return get_model(dataclasses.replace(configs.get_config(arch),
                                         num_layers=layers))


def rec_params(model, arch, dev):
    """The seed-0 init with phases 9 / 10's noise on the constant leaves,
    and for rwkv6 on the channel mix's token-shift mix too (at zero the
    shift, which reads the previous rank's last row, changes nothing), on
    ``dev``."""
    params = perturb_recurrent(cp_params(model, dev), arch, 24)
    if arch == RWKV:
        gen = torch.Generator(DEV).manual_seed(240)
        for key in ("cmu_k", "cmu_r"):
            leaf = params["layers"][key]
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen,
                                        device=leaf.device))
    return params


def rec_state_bytes(cfg, B) -> int:
    """The recurrent state a sharded decode step would gather, one layer
    at a time, if the compute needed it whole (the layout before the
    heads / channels over "model"): rwkv6's S, hymba's h, fp32."""
    per = (cfg.num_heads * cfg.head_dim ** 2 if cfg.family.value == "ssm"
           else cfg.d_model * cfg.ssm_state)
    return cfg.num_layers * B * per * 4


def phase24_recurrent_mesh(card):
    """24a in this process; 24b's mesh-free references here (the prefill's
    logits, a cache prefilled with the prompt, REC_STEPS greedy decode
    steps); then 24b and 24c on REC_MESH spawned ranks (``chip_smoke.py
    --rec-rank``). Returns (24a's rows, the ranks' scan launches summed
    {kernel: n})."""
    t24 = time.perf_counter()
    slab_rows = phase24a_slabs(card)
    log(f"  24a took {time.perf_counter() - t24:.1f} s")
    f32 = dict(compute_dtype=torch.float32)
    B, S = REC_PREFILL
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for arch in (RWKV, HYMBA):
            model = rec_model(arch)
            with torch.no_grad():
                params = rec_params(model, arch, DEV)
                tokens = cp_tokens(model.cfg.vocab_size, REC_PREFILL, 25)
                toks = tokens.to(DEV)
                ref_logits = steps.make_prefill(model, **f32)(
                    params, {"tokens": toks})
                cache = model.init_cache(B, S + REC_STEPS, torch.float32,
                                         device=DEV)
                _, cache = model.prefill_chunk(params, toks, cache,
                                               first=True, **f32)
                start = {k: v.to("cpu", copy=True) for k, v in cache.items()}
                decode = steps.make_decode_step(model, **f32)
                tok = ref_logits[:, -1].argmax(-1, keepdim=True).int()
                first, logits, toks_out = tok.cpu(), [], []
                for _ in range(REC_STEPS):
                    out, cache = decode(params, cache, {"token": tok})
                    tok = out[:, -1].argmax(-1, keepdim=True).int()
                    logits.append(out.cpu())
                    toks_out.append(tok[:, 0].tolist())
                torch.save({"tokens": tokens, "prefill": ref_logits.cpu(),
                            "cache": start, "first": first,
                            "logits": logits, "tokens_out": toks_out},
                           os.path.join(d, f"{arch}.pt"))
            del params, cache, ref_logits, start
            torch.cuda.empty_cache()
        log(f"  24b mesh-free {RWKV} and {HYMBA} ({REC_LAYERS} layers, fp32): "
            f"prefill {B} x {S}, a cache prefilled with it, {REC_STEPS} "
            f"greedy decode steps ({time.perf_counter() - t0:.1f} s); "
            f"spawning {int(np.prod(REC_MESH))} ranks at {REC_MESH}")
        t0 = time.perf_counter()
        run = os.path.join(d, "ranks")
        os.mkdir(run)
        form, ranks = spawn_ranks(int(np.prod(REC_MESH)), run, "--rec-rank",
                                  REC_TIMEOUT)
    launched = {"wkv6": 0, "selective_scan": 0}
    for arch in (RWKV, HYMBA):
        for r, rank in enumerate(ranks):
            got = rank[arch]
            if not (got["prefill_err"] < CP_TOL and got["logits_err"] < CP_TOL
                    and got["tokens"] == got["ref_tokens"]
                    and got["stacks"] == 0):
                raise AssertionError(f"24b {arch} rank {r}: {got}")
            for kernel, n in got["launches"].items():
                launched[kernel] += n
        log(f"  24b {arch} ({REC_LAYERS} layers, fp32) at {REC_MESH} ({form}"
            + (", all on cuda:0, the collectives staged through the host"
               if form == "gloo" else "")
            + f"): prefill logits within "
            f"{max(g[arch]['prefill_err'] for g in ranks):.3e}, decode "
            f"logits within {max(g[arch]['logits_err'] for g in ranks):.3e} "
            f"(bound {CP_TOL}), greedy tokens equal over {REC_STEPS} steps; "
            f"no cache leaf gathered; a decode step no longer gathers "
            f"{rec_state_bytes(rec_model(arch).cfg, B):,} B of state")
        for r, rank in enumerate(ranks):
            got = rank[arch]
            log(f"  24b {arch} rank {r}: state block {got['state_block']}, "
                f"keeps {got['keeps']}; scan launches by (B, T, heads or "
                f"channels) {got['shapes']}; prefill {got['prefill_s']:.3f} s "
                f"wall, collectives {got['prefill_coll']}; a decode step's "
                f"collectives {got['step_coll']} B, wall {got['walls']} s, "
                f"over the last {REC_PROFILED} steps "
                f"{got['busy'] * 1e3:.3f} ms device busy a step of "
                f"{got['wall'] * 1e3:.3f} ms wall ({card})")
    for r, rank in enumerate(ranks):
        got = rank["train"]
        if not (got["loss_diff"] < TRAIN20_TOL
                and got["float64"] < GRAD20_TOL
                and got["fp32_truth"] <= max(
                    GRAD20_TOL, REC_FP32_SPREAD * got["free_truth"])):
            raise AssertionError(f"24c rank {r}: {got}")
    got = ranks[0]["train"]

    def most(key):
        return f"{max(g['train'][key] for g in ranks):.3e}"
    log(f"  24c {RWKV} ({REC_LAYERS} layers, {got['params'] / 1e9:.3f} B "
        f"params) one train step of {REC_TRAIN_BATCH[0]} x "
        f"{REC_TRAIN_BATCH[1]} at {REC_MESH}: fp32 loss {got['loss']:.6f} "
        f"against mesh-free {got['ref_loss']:.6f} (diff {most('loss_diff')}"
        f", bound {TRAIN20_TOL}); step-1 gradients, of each leaf's largest: "
        f"in float64 within {most('float64')} of mesh-free's (bound "
        f"{GRAD20_TOL}; rank 0's worst {got['worst']['float64']}; the named "
        f"leaves {got['named']}); in fp32 within {most('fp32_truth')} of "
        f"float64's, mesh-free's fp32 within {most('free_truth')} (bound "
        f"the larger of {GRAD20_TOL} and {REC_FP32_SPREAD} x the latter), "
        f"sharded fp32 against mesh-free fp32 {most('fp32')} (rank 0's "
        f"worst {got['worst']['fp32']}; of float64's "
        f"{got['worst']['fp32_truth']} / {got['worst']['free_truth']}); "
        f"exactly zero on both: "
        f"{got['zero']}; collectives {got['coll']} B; the fp32 gradients "
        f"{[round(g['train']['wall'], 3) for g in ranks]} s wall")
    log(f"  24b / 24c ranks took {time.perf_counter() - t0:.1f} s; phase 24 "
        f"took {time.perf_counter() - t24:.1f} s ({card})")
    return slab_rows, launched


def rec_serve_rank(arch, dev, out_dir):
    """24b on this rank: the sharded prefill and REC_STEPS lockstep decode
    steps from the mesh-free cache in DIR/../ARCH.pt (``sharded_serve``),
    the scan launches counted from 0 over both with their shapes, and the
    cache leaves gathered a layer at a time (``GatheredStack``)
    counted."""
    from repro_torch.sharding import spmd
    ref_ = torch.load(os.path.join(out_dir, "..", f"{arch}.pt"))
    model = rec_model(arch)
    mesh = mesh_mod.make_mesh(REC_MESH, ("data", "model"), dev.type)
    stacks = [0]
    gathered = spmd.GatheredStack

    class Counted(gathered):
        def __init__(self, *args):
            stacks[0] += 1
            super().__init__(*args)
    hist = {}
    kernel = scan_kernel(arch)
    scan = getattr(ls, kernel)
    with torch.no_grad():
        params = rec_params(model, arch, dev)
        with specs.use_mesh(mesh):
            p = steps.place(params, steps.param_shardings(model, params))
        del params
        torch.cuda.empty_cache()
    prefill = steps.make_prefill(model, sharded=True,
                                 compute_dtype=torch.float32)
    ls.reset_launches()
    spmd.GatheredStack = Counted
    setattr(ls, kernel, scan_shapes_of(scan, hist))
    try:
        out, c = sharded_serve(model, mesh, p, ref_, prefill,
                               ref_["first"].to(dev), REC_STEPS,
                               REC_PROFILED)
    finally:
        spmd.GatheredStack = gathered
        setattr(ls, kernel, scan)
    key = "S" if arch == RWKV else "h"
    return dict(out, keeps=sorted(spmd.tp_keeps(model.cfg, mesh)),
                ref_tokens=ref_["tokens_out"], launches=dict(ls.LAUNCHES),
                shapes={str(k): n for k, n in hist.items()},
                stacks=stacks[0], state_block=list(c[key].to_local().shape))


def rec_train_rank(dev):
    """24c on this rank: the mesh-free step-1 loss and gradients (one rank
    at a time; the rank keeps its blocks), then one sharded train step,
    both step-1 gradients also in float64 (``sharded_train``)."""
    model = rec_model(RWKV)
    mesh = mesh_mod.make_mesh(REC_MESH, ("data", "model"), dev.type)
    toks = cp_tokens(model.cfg.vocab_size, REC_TRAIN_BATCH, 26)
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, 1).to(dev)}
    out, _ = sharded_train(model, mesh, batch,
                           lambda: rec_params(model, RWKV, dev),
                           float64=True)
    errs = out.pop("errs")
    worst = {key: max(errs, key=lambda n: errs[n][key])
             for key in ("float64", "fp32_truth", "free_truth", "fp32")}
    return dict(out, **{key: errs[n][key] for key, n in worst.items()},
                worst=worst, named={
                    n.split("/")[-1]: float(f"{e['float64']:.3e}")
                    for n, e in errs.items()
                    if n.split("/")[-1] in REC_NAMED})


def rec_rank(rank: int, world: int, out_dir: str, form: str) -> int:
    """One rank of phase 24 (``chip_smoke.py --rec-rank R N DIR FORM``):
    24b for rwkv6-7b and hymba-1.5b, then 24c; writes DIR/rank<R>.json."""
    import datetime
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(rank, form)
    dist.init_process_group(form, init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    out = {}
    for arch in (RWKV, HYMBA):
        out[arch] = rec_serve_rank(arch, dev, out_dir)
        torch.cuda.empty_cache()
    out["train"] = rec_train_rank(dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


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
    family_full = {arch: phase2_full_width(arch) for arch in (DBRX, WHISPER)}
    errs.update(phase2_q8_cases())
    full.update(phase2_q8_full_width())
    errs.update(phase2_latent_cases())
    full.update(phase2_latent_full_width())
    flash_errs = phase2_flash_cases()
    flash_full = phase2_flash_full_width()
    gemm_errs = phase2_gemm_cases()
    gemm_full = phase2_gemm_full_width()
    log(f"  phase 16e: K7's gradient GEMMs of a batch-{TRAIN_BATCH} ResNet20 "
        f"training step")
    train_rows = phase2_backward_gemms(card)
    scan_errs = phase2_scan_cases()
    scan_full = phase2_scan_full_width()
    log("  the bf16 entries (K1, K3, K4, K2) against their plain versions")
    t0 = time.perf_counter()
    bf16_errs = phase2_bf16_cases()
    bf16_full, bf16_flash = phase2_bf16_full_width()
    log(f"  the bf16 legs took {time.perf_counter() - t0:.1f} s")

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
    q8_launches, _, q8_reqs = phase4b_serve_int8(model, params, prompts,
                                                 card, (p_reqs, p_firsts,
                                                        p_bytes))
    log("phase 5: ServeEngine main path (dense cache)")
    flash_launches = phase5_serve_dense(dense, prompts, card,
                                        (p_reqs, p_firsts))
    flash_launches["forward"] = forward_launches
    log("phase 11: sampling, scheduling policy, router, cancellation and "
        "the CLIs on fp32 pages (full width, 4 layers)")
    phase11(model, params, prompts, card, (p_reqs, p_firsts, p_m))
    log("phase 18: bf16 serving at full width, 4 layers (K1, K3 and K2's "
        "bf16 entries)")
    t0 = time.perf_counter()
    bf16_launches = phase18_bf16(model, params, prompts, card,
                                 (p_reqs, p_firsts, p_m))
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s")
    log("phase 19: tensor-parallel serving (head slabs, a one-rank mesh, "
        "two ranks)")
    t19 = time.perf_counter()
    slab_rows = phase19a_slabs(card)
    pool_bytes = phase19b_tp1(model, params, prompts, card,
                              (p_reqs, p_firsts, p_m))
    del dense, model, params
    torch.cuda.empty_cache()
    tp2 = phase19c_tp2(card, p_reqs, q8_reqs, pool_bytes)
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s")
    log("phase 6: prefill anchors at reduced width")
    phase6_anchors()
    log("phase 7: qwen2.5-32b-mla at full width, 4 layers (fp32, then "
        "bf16)")
    latent_launches, _ = phase7_mla(card, bf16=True)
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
    log(f"phase 12: {CMDR} at full width, {FAMILY_LAYERS[CMDR]} layers, K1")
    phase12_command_r(card)
    log(f"phase 13: {DBRX} at full width, {FAMILY_LAYERS[DBRX]} layers, "
        f"K1, K3 and K2")
    family_launches = {}
    family_launches[DBRX], flash_launches["prefill_dbrx"], _ = \
        phase13_dbrx(card)
    log(f"phase 14: {VISION} at full width, {FAMILY_LAYERS[VISION]} layers "
        f"(2 super-layers), K1 and K2")
    phase14_vision(card)
    log(f"phase 15: {WHISPER} whole, K2 (encoder, first chunks) and K1")
    family_launches[WHISPER], whisper_flash, _ = phase15_whisper(card)
    flash_launches["prefill_whisper"] = whisper_flash["prefill"]
    flash_launches["forward_whisper"] = whisper_flash["forward"]
    log(f"phase 16: ResNet20 trained at the paper's widths, batch "
        f"{TRAIN_BATCH}, through K7's forward and backward and the plain "
        f"route")
    t0 = time.perf_counter()
    train_launches, _ = phase16_resnet_training(card)
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    log(f"phase 17: the LM trainer, {TRAIN_ARCH} at full width, "
        f"{TRAIN_LAYERS} of 40 layers, restart from a checkpoint")
    t0 = time.perf_counter()
    phase17_trainer(card)
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    log(f"phase 20: sharded training, {TRAIN20_ARCH} at full width, "
        f"{TRAIN20_LAYERS} layers, on (data, model) meshes of gloo ranks; "
        f"elastic restore, the compressed all-reduce and the pipeline")
    phase20_sharded_training(card)
    log("phase 21: the dry run against the card (minicpm-2b train, "
        "qwen2.5-32b decode)")
    phase21_dry_run(card)
    log(f"phase 22: the sequence over \"model\": {ARCH} at full width, "
        f"{CP_LAYERS} layers, prefill and flash decode at {CP_MESH}; "
        f"{HYMBA}'s banded form at {CP_HYMBA_MESH}")
    phase22_sequence_split(card)
    log(f"phase 23: the MoE family over the mesh: {EP_TRAIN_ARCH} at full "
        f"width, {EP_TRAIN_LAYERS} layers, a sharded train step at "
        f"{EP_TRAIN_MESH}; {DBRX}, {EP_SERVE_LAYERS} layer, prefill and "
        f"decode at {EP_SERVE_MESH}")
    phase23_moe_mesh(card)
    log(f"phase 24: the recurrent families over the mesh: K5 / K6 on each "
        f"rank's slab; {RWKV} and {HYMBA} at full width, {REC_LAYERS} "
        f"layers, prefill and decode at {REC_MESH}; a {RWKV} train step "
        f"(fp32 and float64)")
    rec_slabs, rec_launches = phase24_recurrent_mesh(card)

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
    # K1 at the MoE's and whisper's shapes, launched by their serving runs
    # (whisper prefills through its transient path: K1 serves its decode
    # ticks only, so its prefill shape is timed in phase 2 but has no row)
    for arch, kinds in ((DBRX, ("decode", "prefill")), (WHISPER, ("decode",))):
        for kind in kinds:
            f = family_full[arch][kind]
            kernels.append({
                "name": f"paged_attention[{kind} {arch}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:52",
                "launches": family_launches[arch][kind],
                "max_abs_err": max(errs[kind], f["err"]),
                "ms": f["ms"], "plain_ms": f["plain_ms"],
                "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                "library_ms": f["library_ms"]})
    # the bf16 entries, launched by phase 18 (K4's by phase 7's bf16 leg)
    for suffix, source, line, counts in (
            ("", "paged_attention.cu", 52, bf16_launches),
            ("_q8", "paged_attention.cu", 112, bf16_launches),
            ("_latent", "paged_attention_latent.cu", 168,
             {f"{k}_latent_bf16": latent_launches[f"{k}_bf16"]
              for k in ("decode", "prefill")})):
        pairs = PAGED_BF16_ROWS if suffix == "" else ((BF16, BF16),)
        for qd, pd in pairs:
            for kind in ("decode", "prefill"):
                key = kind + suffix + pa.launch_suffix(qd, pd)
                f = bf16_full[key]
                what = ("bf16" if pd == BF16 or suffix == "_q8"
                        else "bf16 q, fp32 pages")
                kernels.append({
                    "name": f"paged_attention{suffix}[{kind} {what}]",
                    "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{source}",
                    "replaces": f"src/repro/kernels/paged_attention.py:"
                                f"{line}",
                    "launches": counts[key],
                    "max_abs_err": max(bf16_errs[key], f["err"]),
                    "ms": f["ms"], "plain_ms": f["plain_ms"],
                    "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                    "library_ms": f["library_ms"]})
    for kind, launched in (("prefill", bf16_launches["prefill_bf16_flash"]),
                           ("forward", bf16_launches["forward_bf16"])):
        f = bf16_flash[kind + "_bf16"]
        kernels.append({
            "name": "flash_attention[%s bf16]" % (
                "first chunk" if kind == "prefill" else kind),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:26",
            "launches": launched,
            "max_abs_err": max(bf16_errs[f"flash_{kind}_bf16"], f["err"]),
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
    # K7's gradient GEMMs, launched by phase 16's training run through K7
    for role in ("dX", "dW"):
        f = train_rows[role]
        kernels.append({
            "name": f"matmul[{role} resnet20 B={TRAIN_BATCH}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:29",
            "launches": train_launches[role], "max_abs_err": f["err"],
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
    # K1 and K3 on a rank's head slab (19a), launched by 19c's two ranks
    for suffix, line, counts in (("", 52, tp2["launches"]),
                                 ("_q8", 112, tp2["launches_q8"])):
        for kind in ("decode", "prefill"):
            f = slab_rows[(kind + suffix, 2)]
            kernels.append({
                "name": f"paged_attention{suffix}[{kind} tp=2 slab]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                "replaces": f"src/repro/kernels/paged_attention.py:{line}",
                "launches": counts[kind],
                "max_abs_err": f["err"], "ms": f["ms"],
                "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                "bound_by": f["bound_by"], "library_ms": f["library_ms"]})
    # K5 and K6 on a rank's slab (24a: the tick's shape, REC_MESH's heads
    # or channels), launched by 24b's ranks (their prefills and ticks)
    ways = REC_MESH[1]
    for name, line in (("wkv6", 30), ("selective_scan", 105)):
        f = rec_slabs[(name, "tick", ways)]
        kernels.append({
            "name": f"{name}[slab]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
            "replaces": f"src/repro/kernels/linear_scan.py:{line}",
            "launches": rec_launches[name],
            "max_abs_err": max(rec_slabs[(name, k, m)]["err"]
                               for k in SLAB_SHAPES for m in SLAB_WAYS),
            "ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None})
    log(f"device times the profiler could not give, timed between events "
        f"instead: {len(FALLBACKS)}")
    log(f"the whole script took {time.perf_counter() - T_START:.1f} s "
        f"({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5]))
    if sys.argv[1:2] == ["--train-rank"]:
        sys.exit(train_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                            sys.argv[5]))
    if sys.argv[1:2] == ["--cp-rank"]:
        sys.exit(cp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5]))
    if sys.argv[1:2] == ["--ep-rank"]:
        sys.exit(ep_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5]))
    if sys.argv[1:2] == ["--rec-rank"]:
        sys.exit(rec_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          sys.argv[5]))
    sys.exit(main())
