"""Multi-pod dry run, the counterpart of ``repro/launch/dryrun.py``: every
(architecture x input-shape) cell's step on the production mesh, counted
per rank (FLOPs, bytes, peak memory, collective bytes) and recorded as
JSON with ``repro``'s fields, plus per-layer probes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k --hbm-budget-gib 78
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --hbm-budget-gib 78

It needs no card and no memory: ``run_cell`` makes a ``"fake"`` process
group as large as the mesh (256 or 512 ranks), builds the state, params,
cache and batch as fake tensors (``FakeTensorMode``), places them with
the port's shardings, runs the step once and records rank 0's program.
PyTorch runs eagerly, so every layer and every recurrence step is
dispatched and counted: ``gate`` is the whole step
(``gate_is_whole_step``), and the probes a per-layer breakdown of it.
The budget a cell must fit is the visible card's memory less
``RESERVE_GIB``; without a card ``--hbm-budget-gib`` gives it.
Records go to ``artifacts/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import hlo_stats, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.probes import (PROBE_STACKS, probes_for,
                                      recurrence_extra)
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import cosine
from repro_torch.sharding import specs, spmd
from repro_torch.tree import tree_map

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")

# what a step cannot use of the card's total memory: on an H100 80GB HBM3
# (79.18 GiB) 1.03 GiB lay outside the caching allocator at the end of
# chip_smoke.py (the CUDA context, the libraries' handles, the port's
# kernels), which prints it in phase 21; the rest is room for the
# allocator's blocks cached but unused
RESERVE_GIB = 2.0
# serving replicates its weights over the data axis (SERVE_RULES) when the
# bf16 model's 1/16 tensor-parallel slice takes at most this share of the
# budget (``repro``'s threshold, as a share of its budget)
SERVE_RULES_SHARE = 0.3871


def _attn_impl_for(shape):
    # chunked attention bounds live scores to O(q_chunk * S); einsum
    # attention at S >= 2k materializes multi-GB score tensors
    return "chunked" if shape.seq_len >= 2048 else "einsum"


def _serve_param_sds(model, int8: bool = False, device="cpu"):
    """Serve-time params: floating leaves in bf16, or int8 for >= 2-D
    (matmul / embedding) weights with ``int8``; the models upcast them
    where they use them."""
    p = model.init(torch.Generator(device), device)

    def conv(t):
        if not t.is_floating_point():
            return t
        if int8 and t.dim() >= 2:
            return t.to(torch.int8)
        return t.to(torch.bfloat16)
    return tree_map(conv, p)


def hbm_budget(gib=None) -> int:
    """Bytes a cell's per-rank footprint must fit: ``gib`` where given,
    else the visible card's total memory less ``RESERVE_GIB``."""
    if gib is not None:
        return int(gib * 2**30)
    if not torch.cuda.is_available():
        raise ValueError("no card visible: give the budget "
                         "(--hbm-budget-gib)")
    total = torch.cuda.get_device_properties(0).total_memory
    return int(total - RESERVE_GIB * 2**30)


def build_gate(model, shape, mesh, *, microbatches: int = 1,
               int8_weights: bool = False, zero_stage: int = 3,
               remat="nothing", device="cpu", rules=specs.DEFAULT_RULES,
               compute_dtype=torch.bfloat16):
    """(step, args) of the cell's step: ``step(*args)`` runs it. With a
    mesh the args are placed with the port's shardings (DTensors, under
    ``rules``) and the step runs sharded on it; without one they are
    whole. Call under a ``FakeTensorMode`` to count at full size; on
    real tensors the batch holds seeded ids (and zero frontend
    stubs)."""
    from torch._subclasses.fake_tensor import is_fake
    batch = model.input_specs(shape, compute_dtype, device)
    if not is_fake(next(iter(batch.values()))):     # a real run: real ids
        gen = torch.Generator(device).manual_seed(0)
        for t in batch.values():
            if t.is_floating_point():
                t.zero_()
            else:
                t.random_(0, model.cfg.vocab_size, generator=gen)

    def placed(tree, shardings_fn, *args):
        if mesh is None:
            return tree
        with specs.use_mesh(mesh, rules):
            return steps.place(tree, shardings_fn(model, tree, *args))

    batch = placed(batch, steps.batch_shardings)
    if shape.kind == "train":
        opt = AdamW(learning_rate=cosine(3e-4, 100, 10000))
        state = placed(steps.init_train_state(
            model, opt, torch.Generator(device), device),
            steps.state_shardings, zero_stage)
        step = steps.make_train_step(model, opt,
                                     compute_dtype=compute_dtype,
                                     attn_impl=_attn_impl_for(shape),
                                     remat=remat, microbatches=microbatches)
        return step, (state, batch)
    params = placed(_serve_param_sds(model, int8_weights, device),
                    steps.param_shardings)
    if shape.kind == "prefill":
        step = steps.make_prefill(model, compute_dtype=compute_dtype,
                                  attn_impl=_attn_impl_for(shape),
                                  batch_chunks=microbatches,
                                  scan_impl="scan", sharded=mesh is not None)
        return step, (params, batch)
    # decode: int8 serving quantizes the KV cache too
    kv_dtype = torch.int8 if int8_weights else torch.bfloat16
    cache = model.init_cache(shape.global_batch, shape.seq_len, kv_dtype,
                             device=device)
    pos = cache["pos"]
    cache = placed(cache, steps.cache_shardings)
    # the scalar pos stays whole: the lockstep decode reads its value (a
    # fake tensor made by torch.tensor keeps it)
    cache["pos"] = (torch.tensor(0, dtype=torch.int32) if is_fake(pos)
                    else pos)
    step = steps.make_decode_step(model, compute_dtype=compute_dtype,
                                  scan_impl="scan", sharded=mesh is not None)
    return step, (params, cache, batch)


def count_step(step, args, limit=None):
    """Run ``step(*args)`` once under the counters: (cost, memory,
    collectives, the step's output). ``limit``: stop with
    ``hlo_stats.OverBudget`` once the live bytes pass it."""
    tracker = hlo_stats.LiveBytes(limit)
    counter = hlo_stats.OpCounter()
    tracker.arguments(args)
    with hlo_stats.collectives() as records, tracker, counter:
        out = step(*args)
    tracker.outputs(out)
    return (hlo_stats.cost_stats(counter), hlo_stats.memory_stats(tracker),
            hlo_stats.collective_bytes(records), out)


def footprint(m) -> int:
    return (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
            - m["alias_bytes"])


# ------------------------------------------------------------ probes
def _compute_block(t, sh, logical, mesh, dims, keeps):
    """This rank's block of a whole probe argument as the sharded step's
    compute reads it: its rows over the batch's mesh dims and its "model"
    dims of kept logical axes (the dense and MoE decoders', and "seq_sp"
    where the step keeps the rank's rows); every other split gathered back
    (recorded as the step's gathers are)."""
    if sh is None:
        return t
    names = specs.axis_names(mesh)
    out = specs.local_block(t, sh)
    for i, d in reversed(specs.shard_dims(sh)):
        if i in dims or (names[i] == specs.TP_AXIS and logical[d] in keeps):
            continue
        out = specs.all_gather(out, d, mesh, i)
    return out


def _stack_plans(model, key, logical, shardings, keeps, stacks):
    def go(lg, sh, stack):
        if isinstance(sh, dict):
            return {k: go(lg[k], v, stack.get(k, 0) if isinstance(stack, dict)
                          else stack) for k, v in sh.items()}
        return spmd.leaf_plan(sh, lg, stack, keeps)
    return go(logical, shardings, stacks)


def run_probe(pr, model, mesh, rules):
    """One probe on this rank (SPMD, as the sharded step runs a layer):
    (cost, collectives)."""
    with specs.use_mesh(mesh, rules):
        shs = tuple(specs.shardings_for(lg, a)
                    for lg, a in zip(pr.shardings, pr.args))
    keeps = spmd.tp_keeps(model.cfg, mesh)
    dims = tuple(i for i, d in specs.shard_dims(shs[0]) if d == 0)
    key = next((k for k in PROBE_STACKS if k in model.param_logical()
                and isinstance(pr.args[1], dict)
                and set(pr.args[1]) == set(model.param_logical()[k])), None)
    if isinstance(pr.args[1], dict):
        lp = tree_map(lambda t, sh: specs.local_block(t, sh), pr.args[1],
                      shs[1])
        plans = _stack_plans(model, key, pr.shardings[1], shs[1], keeps,
                             PROBE_STACKS[key])
    else:           # the CE head's weight
        lp = specs.local_block(pr.args[1], shs[1])
        plans = spmd.leaf_plan(shs[1], pr.shardings[1], 0, keeps)

    def view(leaves):
        if isinstance(leaves, dict):
            return spmd.lazy_params(leaves, plans, mesh, dims)
        return spmd.materialize(leaves, mesh, plans, dims)

    def block(a, sh, lg, kept):
        if isinstance(a, dict):
            return {k: block(a[k], sh[k], lg[k], kept) for k in a}
        return _compute_block(a, sh, lg, mesh, dims, kept)

    # the step's rows over "model": the dense / MoE residual (sp) and
    # a self-attention cache's sequence (the lockstep decode's flash form)
    sp = spmd.seq_split(model.cfg, mesh, pr.args[0].shape[1])
    cp = any(spmd.cp_cache_dims(pr.shardings[j], shs[j])
             for j in pr.cache_args)
    seq = keeps | {"seq_sp"}
    rest = [block(a, sh, lg, seq if j in pr.cache_args and cp else keeps)
            for j, (a, sh, lg) in enumerate(
                zip(pr.args[2:], shs[2:], pr.shardings[2:]), 2)]
    x = block(pr.args[0], shs[0], pr.shardings[0], seq if sp else keeps)
    counter = hlo_stats.OpCounter()
    with hlo_stats.collectives() as records, \
            spmd.training(mesh, dims, bool(keeps), sp=sp, cp_cache=cp):
        with counter:
            if getattr(pr.fn, "takes_view", False):
                pr.fn(x, lp, *rest, view=view)
            else:
                pr.fn(x, view(lp), *rest)
    return hlo_stats.cost_stats(counter), hlo_stats.collective_bytes(records)


# ------------------------------------------------------------ cells
@contextlib.contextmanager
def fake_mesh(mesh_shape=None, multi_pod: bool = False):
    """(mesh, its name) over a ``"fake"`` process group of the mesh's size,
    made here and destroyed on leaving: ``mesh_shape`` over the last of
    ("pod", "data", "model"), else the production mesh. A process that
    already has a default group is refused. The fake backend comes from
    ``torch.testing``, imported here so that importing this module touches
    no process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "this process already has a default one")
    if mesh_shape:
        shape = tuple(mesh_shape)
        axes = ("pod", "data", "model")[-len(shape):]
        name = "pod" + "x".join(map(str, shape))
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        name = "pod2x16x16" if multi_pod else "pod16x16"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        if mesh_shape:
            yield mesh_mod.make_mesh(shape, axes, "cpu"), name
        else:
            yield mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                device_type="cpu"), name
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             with_probes: bool = True, verbose: bool = True,
             int8_weights: bool = False, zero_stage: int = 3,
             remat="nothing", mesh_shape=None,
             hbm_budget_gib=None) -> dict:
    """The cell's record, counted on rank 0 of a fake process group of the
    mesh's size (``fake_mesh``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_config(arch)
    shape = configs.get_shape(shape_name)
    model = get_model(cfg)
    budget = hbm_budget(hbm_budget_gib)
    with fake_mesh(mesh_shape, multi_pod) as (mesh, mesh_name):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "kind": shape.kind, "chips": mesh.mesh.numel(),
               "params_total": cfg.total_params(),
               "params_active": cfg.active_params(),
               "int8_weights": int8_weights, "zero_stage": zero_stage,
               "remat": remat}
        t0 = time.time()
        rules = specs.DEFAULT_RULES
        if shape.kind in ("prefill", "decode"):
            model_axis = 16
            if 2 * cfg.total_params() / model_axis <= \
                    SERVE_RULES_SHARE * budget:
                rules = specs.SERVE_RULES
                rec["serve_rules"] = "model_only"
        with specs.use_mesh(mesh, rules), \
                FakeTensorMode(allow_non_fake_inputs=True):
            # auto-microbatching: more gradient-accumulation (or prefill
            # chunk) splits until the per-rank footprint fits the budget;
            # a split is valid only where each slice's rows still divide
            # the data axes
            dp = 1
            for ax in ("pod", "data"):
                dp *= specs.mesh_shape(mesh).get(ax, 1)
            mb_candidates = tuple(
                m for m in (1, 2, 4, 8)
                if (shape.global_batch // m) % dp == 0) or (1,)
            if shape.kind not in ("train", "prefill"):
                mb_candidates = (1,)
            for mb in mb_candidates:
                last = mb == mb_candidates[-1]
                step, args = build_gate(model, shape, mesh, microbatches=mb,
                                        int8_weights=int8_weights,
                                        zero_stage=zero_stage, remat=remat,
                                        rules=rules)
                try:
                    cost, memory, coll, _ = count_step(
                        step, args, None if last else budget)
                except hlo_stats.OverBudget:
                    cost = None
                del step, args
                if cost is not None and (footprint(memory) <= budget
                                         or last):
                    break
                if verbose:
                    print(f"  [mb] {arch} x {shape_name}: mb={mb} footprint"
                          f" > budget {budget / 2**30:.1f} GiB; retrying "
                          f"mb={mb * 2}", flush=True)
            rec["microbatches"] = mb
            rec["gate"] = {"cost": cost, "memory": memory,
                           "collectives": coll,
                           "compile_s": round(time.time() - t0, 1)}
            rec["gate_is_whole_step"] = True
            if with_probes:
                rec["probes"] = []
                # windowed archs probe with banded attention, the others
                # with einsum
                probe_attn = "banded" if cfg.window else "einsum"
                for pr in probes_for(
                        model, shape, attn_impl=probe_attn,
                        remat=(remat if shape.kind == "train" else False),
                        microbatches=mb, zero_stage=zero_stage):
                    t1 = time.time()
                    pcost, pcoll = run_probe(pr, model, mesh, rules)
                    rec["probes"].append({
                        "name": pr.name, "mult": pr.mult, "cost": pcost,
                        "collectives": pcoll,
                        "compile_s": round(time.time() - t1, 1)})
                rec["recurrence_extra"] = recurrence_extra(cfg, shape,
                                                           shape.kind)
    rec["wall_s"] = round(time.time() - t0, 1)
    if verbose:
        g = rec["gate"]
        fp = footprint(g["memory"])
        print(f"[OK] {arch} x {shape_name} x {mesh_name}: "
              f"flops={g['cost']['flops']:.3g} "
              f"dot_flops={g['cost']['dot_flops']:.3g} "
              f"bytes={g['cost']['bytes']:.3g} "
              f"coll={g['collectives'].get('total', 0):.3g}B "
              f"arg={g['memory']['argument_bytes'] / 2**30:.2f}GiB/rank "
              f"temp={g['memory']['temp_bytes'] / 2**30:.2f}GiB/rank "
              f"footprint={fp / 2**30:.2f}GiB/rank "
              f"(budget {budget / 2**30:.2f}, "
              f"{'fits' if fp <= budget else 'does not fit'}; "
              f"{rec['wall_s']}s)", flush=True)
    return rec


def save(rec: dict):
    ART_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (ART_DIR / name).write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="run the 2x16x16 multi-pod mesh (default single-pod)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--int8-weights", action="store_true")
    ap.add_argument("--zero", type=int, default=3)
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--mesh-shape", type=int, nargs="*", default=None)
    ap.add_argument("--hbm-budget-gib", type=float, default=None,
                    help="per-rank memory budget in GiB (default: the "
                         "visible card's memory less the reserve; "
                         "required without a card)")
    args = ap.parse_args(argv)
    hbm_budget(args.hbm_budget_gib)     # refuse early without a budget

    cells = []
    if args.all:
        for cfg, shape, skipped in configs.cells(include_skips=True):
            if skipped:
                print(f"[SKIP] {cfg.name} x {shape.name}: rule-based skip "
                      f"({cfg.notes.split(';')[-1].strip()})", flush=True)
                continue
            cells.append((cfg.name, shape.name))
    else:
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            out = ART_DIR / f"{arch}__{shape}__{mesh_name}.json"
            if args.skip_existing and out.exists():
                print(f"[CACHED] {arch} x {shape} x {mesh_name}", flush=True)
                continue
            try:
                # probes only on the single-pod mesh
                rec = run_cell(arch, shape, multi_pod=mp,
                               with_probes=(not args.no_probes and not mp),
                               int8_weights=args.int8_weights,
                               zero_stage=args.zero, remat=args.remat,
                               mesh_shape=args.mesh_shape,
                               hbm_budget_gib=args.hbm_budget_gib)
                save(rec)
            except Exception as e:
                failures.append((arch, shape, mesh_name, repr(e)))
                print(f"[FAIL] {arch} x {shape} x {mesh_name}: {e}",
                      flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", *f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nAll dry-run cells ran.")


if __name__ == "__main__":
    main()
