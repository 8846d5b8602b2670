"""The MoE family over the ("data", "model") mesh in the port
(``sharding.spmd``'s experts over "model" and dispatch groups over the
batch's ranks, ``layers.moe``) against mesh-free runs and ``repro``:

* (a) reduced dbrx-132b (4 experts top-2, 4 heads over 1 kv head: the
  rows over "model" context-parallel) and reduced moonshot-v1-16b-a3b (4
  experts, 4 heads over 4: the heads over "model", sequence-parallel
  rows) at (1, 2), (2, 2) and (1, 4) on a batch of 4 x 64 (T = 256: G =
  2 groups, which divide the data ranks): the forward's logits of every
  row and the sharded prefill's within ``SERVE_TOL`` of mesh-free and of
  ``repro``'s jitted forward and prefill; 3 fp32 train steps' losses
  within ``LOSS_TOL`` and the step-1 gradient blocks within ``GRAD_TOL``
  of mesh-free and of ``repro`` (the router and every expert weight
  named); ``moe_aux`` / ``moe_z`` within ``AUX_TOL`` of mesh-free's on
  every rank; two lockstep decode steps within ``SERVE_TOL``; each rank
  keeps E / M experts and routes its own groups only;
* (b) capacity that binds (dbrx at ``capacity_factor`` 0.5, (2, 2)):
  each rank's kept masks (``layers.MOE_TRACE``) equal mesh-free's rows of
  the same groups, and some choices are dropped;
* (c) the fallback: a batch of 2 x 64 at (2, 2) (T = 128: G = 1 does not
  divide 2 data ranks) routes every rank's rows, and is exact all the
  same; a batch of 4 x 65 at (2, 2) (rows that do not divide "model")
  keeps the residual replicated over "model" and still routes the
  rank's own groups;
* (d) on a fake (2, 4) mesh the MoE layer's prefill probe counts an
  eighth of the mesh-free layer's dot FLOPs, the router's excepted (it
  runs on the rank's rows of every "model" rank: half), and records no
  all-gather of an expert weight over "model" and none of the tokens over
  "data"; ``tp_keeps`` and ``moe_groups_split`` by case.

The ranks are two spawns of this file run as a script (2 and 4 gloo
ranks, ``python tests/test_torch_ep.py RANK WORLD DIR``), started
together when the first test asks; each writes rank<R>.json and its
step-1 gradient blocks. ``repro``'s results are computed in the test
process meanwhile, on the port's seed-0 init (bridged) and the ranks'
inputs."""
import datetime
import json
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 300
SERVE_TOL = 1e-4
LOSS_TOL = 1e-3                 # test_torch_sharded_train.py's bounds
GRAD_TOL = 1e-5
AUX_TOL = 1e-6
STEPS = 3
BATCH = (4, 64)                 # T = 256: two dispatch groups of 128
FALLBACK_BATCH = (2, 64)        # T = 128: one group
ODD_BATCH = (4, 65)             # 65 rows a sequence: not split over "model"
PROMPT, S_MAX, DECODE_STEPS = 8, 16, 2
ARCHS = {"dbrx": "dbrx-132b", "moonshot": "moonshot-v1-16b-a3b"}
MESHES = ((1, 2), (2, 2), (1, 4))
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")
# (name, model, config overrides, mesh, batch): the main cases, capacity
# that binds and the fallback
CASES = tuple((f"{m} {s}", m, {}, s, BATCH) for m in ARCHS for s in MESHES) \
    + (("capacity (2, 2)", "dbrx", {"capacity_factor": 0.5}, (2, 2), BATCH),
       ("fallback (2, 2)", "dbrx", {}, (2, 2), FALLBACK_BATCH),
       ("replicated (2, 2)", "moonshot", {}, (2, 2), ODD_BATCH))


def _tmodel(name, **over):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.registry import get_model, reduced_config
    cfg = reduced_config(configs.get_config(ARCHS[name]))
    if over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **over))
    return get_model(cfg)


def _batch(vocab, shape):
    toks = np.random.default_rng(1).integers(0, vocab, shape)
    return toks, np.roll(toks, -1, 1)


def _mesh(shape):
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.make_mesh(shape, ("data", "model"), "cpu")


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _named(tree, prefix=""):
    """[(path, leaf)] in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _grads_file(out_dir, name, rank):
    return os.path.join(out_dir, f"grads{[c[0] for c in CASES].index(name)}"
                                 f"_rank{rank}.npz")


# ------------------------------------------------------------- the ranks
def _traced(fn, *args):
    """``fn(*args)`` and the MoE calls' kept masks (``MOE_TRACE``)."""
    from repro_torch.models import layers as L
    L.MOE_TRACE = []
    try:
        out = fn(*args)
        return out, [t["kept"] for t in L.MOE_TRACE]
    finally:
        L.MOE_TRACE = None


def _sharded_forward(model, params, tokens):
    """Every row's logits and the aux losses of the forward on the mesh of
    ``params``, run as the sharded prefill runs its rows (the logits of
    each rank's rows gathered)."""
    from repro_torch.launch import steps
    from repro_torch.sharding import spmd
    mesh, keeps, local, plans = steps._local_params(model, params)
    ((mb, dims),) = steps._microbatches(model, tokens, mesh, 1)
    sp = spmd.seq_split(model.cfg, mesh, tokens["tokens"].shape[1])
    with spmd.training(mesh, dims, bool(keeps), sp=sp):
        logits, aux = model.forward(spmd.lazy_params(local, plans, mesh, dims),
                                    mb["tokens"], compute_dtype=torch.float32)
        return spmd.gather_rows(logits), aux


def _free(name, over, batch_shape):
    """The mesh-free run of a case's model and batch."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    model = _tmodel(name, **over)
    opt = AdamW(learning_rate=1e-3)
    toks, labels = _batch(model.cfg.vocab_size, batch_shape)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    full = steps.init_train_state(model, opt,
                                  torch.Generator().manual_seed(0), "cpu")
    loss_fn = steps.make_loss_fn(model, compute_dtype=torch.float32,
                                 remat=False)
    (_, metrics), grads = steps.value_and_grad(loss_fn)(full["params"], batch)
    step = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                 remat=False)
    state, losses = full, []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    (logits, aux), kept = _traced(
        lambda: model.forward(full["params"], batch["tokens"],
                              compute_dtype=torch.float32))
    f32 = dict(compute_dtype=torch.float32)
    prefill = steps.make_prefill(model, attn_impl="einsum", **f32)(
        full["params"], {"tokens": batch["tokens"]})
    prompt = {"tokens": batch["tokens"][:, :PROMPT]}
    _, cache = steps.make_prefill(model, return_cache=True, s_max=S_MAX,
                                  **f32)(full["params"], prompt)
    return {"model": model, "opt": opt, "batch": batch, "full": full,
            "loss_fn": loss_fn, "grads": grads, "metrics": metrics,
            "losses": losses, "logits": logits, "aux": aux, "kept": kept,
            "prefill": prefill, "cache": cache}


def _decode(model, params, cache, first, place=lambda b: b, sharded=False):
    from repro_torch.launch import steps
    decode = steps.make_decode_step(model, compute_dtype=torch.float32,
                                    sharded=sharded)
    tok, out = first, []
    for _ in range(DECODE_STEPS):
        logits, cache = decode(params, cache, place({"token": tok}))
        out.append(logits)
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
    return out


def _case(case, free, out_dir):
    """A case on its mesh against mesh-free: the step-1 gradients (the
    rank's blocks to a file, each beside its elements' flat indices), the
    aux losses, 3 steps' losses, the forward (with its kept masks), the
    sharded prefill and two decode steps."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.sharding import specs, spmd
    from repro_torch.tree import tree_map
    name, _, _, shape, _ = case
    model, batch, full = free["model"], free["batch"], free["full"]
    mesh = _mesh(shape)

    def place(tree):
        with specs.use_mesh(mesh):
            return steps.place(tree, steps.batch_shardings(model, tree))
    with specs.use_mesh(mesh):
        sh = steps.state_shardings(model, full)
        placed = steps.place(full, sh)
        cache = steps.place(tree_map(torch.clone, free["cache"]),
                            steps.cache_shardings(model, free["cache"]))
    pbatch = place(batch)
    (_, metrics), got = steps.sharded_value_and_grad(model, free["loss_fn"])(
        placed["params"], pbatch)
    errs, blocks = {}, {}
    for n, ((path, g), want, s) in enumerate(zip(
            _named(got), [w for _, w in _named(free["grads"])],
            [s for _, s in _named(sh["params"])])):
        want_b = specs.local_block(want, s)
        errs[path] = _max_diff(g, want_b) / max(float(want_b.abs().max()),
                                                1e-30)
        blocks[f"g{n}"] = g.numpy()
        blocks[f"i{n}"] = specs.local_block(
            torch.arange(want.numel()).reshape(want.shape), s).numpy()
    np.savez(_grads_file(out_dir, name, dist.get_rank()), **blocks)
    step = steps.make_train_step(model, free["opt"],
                                 compute_dtype=torch.float32, remat=False)
    state, losses = placed, []
    for _ in range(STEPS):
        state, m = step(state, pbatch)
        losses.append(float(m["loss"]))
    tokens = place({"tokens": batch["tokens"]})
    (logits, aux), kept = _traced(_sharded_forward, model, placed["params"],
                                  tokens)
    d_rank = mesh.get_local_rank("data")
    kept_eq = []
    for k, want in zip(kept, free["kept"]):
        n = k.shape[0]
        lo = d_rank * n if n < want.shape[0] else 0
        kept_eq.append(bool(torch.equal(k, want[lo:lo + n])))
    prefill = steps.make_prefill(model, compute_dtype=torch.float32,
                                 attn_impl="einsum", sharded=True)(
        placed["params"], tokens)
    first = batch["tokens"][:, PROMPT - 1:PROMPT].int()
    want_dec = _decode(model, full["params"],
                       tree_map(torch.clone, free["cache"]), first)
    dec = _decode(model, placed["params"], cache, first, place, sharded=True)
    keeps = spmd.tp_keeps(model.cfg, mesh)
    w_gate = placed["params"]["layers"]["moe"]["w_gate"].to_local()
    return {"keeps": sorted(keeps),
            "sp": spmd.seq_split(model.cfg, mesh, batch["tokens"].shape[1]),
            "experts": w_gate.shape[1], "grad_err": errs,
            "aux_err": max(abs(float(metrics[k]) - float(free["metrics"][k]))
                           for k in ("moe_aux", "moe_z")),
            "forward_aux_err": max(abs(float(aux[k]) - float(free["aux"][k]))
                                   for k in ("moe_aux", "moe_z")),
            "losses": losses, "ref_losses": free["losses"],
            "logits": logits.tolist(),
            "logits_err": _max_diff(logits, free["logits"]),
            "routed": [k.shape[0] for k in kept],
            "kept_equal": kept_eq,
            "dropped": [int((~k).sum()) for k in free["kept"]],
            "prefill": prefill.tolist(),
            "prefill_err": _max_diff(prefill, free["prefill"]),
            "decode_err": max(_max_diff(a, b) for a, b in zip(dec, want_dec))}


def _rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    frees, out = {}, {}
    for case in CASES:
        name, model, over, shape, batch = case
        if int(np.prod(shape)) != world:
            continue
        key = (model, tuple(sorted(over.items())), batch)
        if key not in frees:
            frees[key] = _free(model, over, batch)
        out[name] = _case(case, frees[key], out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from test_torch_sharding import start_ranks, wait_ranks
    dirs = {world: tmp_path_factory.mktemp(f"ep{world}") for world in (2, 4)}
    started = {world: (start_ranks(world, d, __file__), d)
               for world, d in dirs.items()}
    done = {}

    def get(world):
        if world not in done:
            done[world] = wait_ranks(*started[world], timeout=TIMEOUT)
        return done[world]
    get.dirs = dirs
    yield get
    for procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


def _ref(name):
    """``repro`` on the port's seed-0 init of a model and the ranks'
    batch: 3 jitted fp32 steps' losses, the step-1 gradients (flat, in
    ``tree_leaves`` order), the forward's logits and the prefill's."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models.registry import get_model, reduced_config
    from repro.optim.adamw import AdamW as JAdamW
    from repro_torch import bridge
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    model = _tmodel(name)
    params = jax.tree.map(jnp.asarray, bridge.to_numpy(steps.init_train_state(
        model, AdamW(learning_rate=1e-3), torch.Generator().manual_seed(0),
        "cpu")["params"]))
    jmodel = get_model(reduced_config(jconfigs.get_config(ARCHS[name])))
    opt = JAdamW(learning_rate=1e-3)
    toks, labels = _batch(model.cfg.vocab_size, BATCH)
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    loss_fn = jsteps.make_loss_fn(jmodel, compute_dtype=jnp.float32,
                                  remat=False)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch)[0]))(params)
    step = jax.jit(jsteps.make_train_step(jmodel, opt,
                                          compute_dtype=jnp.float32,
                                          remat=False))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    forward = jax.jit(lambda p, t: jmodel.forward(
        p, t, compute_dtype=jnp.float32)[0])
    prefill = jax.jit(jsteps.make_prefill(jmodel, compute_dtype=jnp.float32,
                                          attn_impl="einsum"))
    return {"losses": losses,
            "grads": [np.asarray(g).ravel() for g in jax.tree.leaves(grads)],
            "forward": np.asarray(forward(params, batch["tokens"])),
            "prefill": np.asarray(prefill(params,
                                          {"tokens": batch["tokens"]}))}


@pytest.fixture(scope="module")
def reference():
    """``reference(name)``: ``repro``'s results for a model, computed once
    when first asked (after the ranks were started, so both run
    together)."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _ref(name)
        return done[name]
    return get


def _ranks(spawned, name):
    case = next(c for c in CASES if c[0] == name)
    return case, spawned(int(np.prod(case[3])))


MAIN = [c[0] for c in CASES[:2 * len(MESHES)]]


@pytest.mark.parametrize("name", MAIN)
def test_forward_and_prefill_equal_mesh_free_and_the_reference(
        spawned, reference, name):
    case, ranks = _ranks(spawned, name)
    want = reference(case[1])
    for r in ranks:
        got = r[name]
        assert got["logits_err"] < SERVE_TOL, got["logits_err"]
        np.testing.assert_allclose(np.array(got["logits"]), want["forward"],
                                   rtol=0, atol=SERVE_TOL)
        assert got["prefill_err"] < SERVE_TOL, got["prefill_err"]
        np.testing.assert_allclose(np.array(got["prefill"]), want["prefill"],
                                   rtol=0, atol=SERVE_TOL)
        assert got["forward_aux_err"] < AUX_TOL, got["forward_aux_err"]


@pytest.mark.parametrize("name", MAIN)
def test_training_equals_mesh_free_and_the_reference(spawned, reference,
                                                     name):
    """Losses, the step-1 gradient blocks (each relative to the largest
    magnitude of its mesh-free block, and of ``repro``'s), and the aux
    losses on every rank."""
    case, ranks = _ranks(spawned, name)
    want = reference(case[1])
    world = len(ranks)
    for rank, r in enumerate(ranks):
        got = r[name]
        assert got["losses"] == ranks[0][name]["losses"]
        np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=LOSS_TOL)
        moe = {k: v for k, v in got["grad_err"].items()
               if k.split("/")[-1] in MOE_LEAVES}
        assert len(moe) == len(MOE_LEAVES), sorted(got["grad_err"])
        assert max(got["grad_err"].values()) < GRAD_TOL, got["grad_err"]
        assert got["aux_err"] < AUX_TOL, got["aux_err"]
        blocks = np.load(_grads_file(spawned.dirs[world], name, rank))
        assert len(blocks.files) == 2 * len(want["grads"])
        for n, flat in enumerate(want["grads"]):
            w = flat[blocks[f"i{n}"]]
            err = np.abs(blocks[f"g{n}"] - w).max() / max(np.abs(w).max(),
                                                           1e-30)
            assert err < GRAD_TOL, (n, err)


@pytest.mark.parametrize("name", MAIN)
def test_rank_runs_its_experts_and_its_groups(spawned, name):
    """"expert" and "vocab" kept, the heads where 4 and the kv heads
    divide "model"; E / M experts a rank; a rank routes its own half of
    the 256 tokens where the data ranks are 2, all of them otherwise."""
    case, ranks = _ranks(spawned, name)
    _, model, _, (data, ways), batch = case
    heads = model == "moonshot"
    for r in ranks:
        got = r[name]
        assert got["keeps"] == sorted({"expert", "vocab"} | (
            {"heads", "kv_heads"} if heads else set()))
        assert got["sp"]
        assert got["experts"] == 4 // ways
        assert got["routed"] == [batch[0] * batch[1] // data] * 2
        assert all(got["kept_equal"]), got["kept_equal"]


@pytest.mark.parametrize("name", MAIN)
def test_lockstep_decode_equals_mesh_free(spawned, name):
    _, ranks = _ranks(spawned, name)
    for r in ranks:
        assert r[name]["decode_err"] < SERVE_TOL, r[name]["decode_err"]


@pytest.mark.parametrize("name", [c[0] for c in CASES[2 * len(MESHES):]])
def test_binding_capacity_fallback_and_replicated_rows_are_exact(spawned,
                                                                 name):
    """Capacity that drops choices keeps each rank's masks equal to
    mesh-free's rows of its groups; a batch whose one group does not
    divide the data ranks routes every row on every rank; rows that do
    not divide "model" stay replicated over it (the experts' products
    entered through ``tp_copy`` and summed by ``tp_sum``). Each equals
    mesh-free's forward, prefill, decode, losses and gradients."""
    case, ranks = _ranks(spawned, name)
    batch = case[4]
    own = name.split()[0] != "fallback"
    for r in ranks:
        got = r[name]
        assert all(got["kept_equal"]), got["kept_equal"]
        assert got["sp"] == (name.split()[0] != "replicated")
        assert got["routed"] == [batch[0] * batch[1] // (2 if own else 1)] * 2
        if name.startswith("capacity"):
            assert min(got["dropped"]) > 0, got["dropped"]
        for key, tol in (("logits_err", SERVE_TOL),
                         ("prefill_err", SERVE_TOL),
                         ("decode_err", SERVE_TOL), ("aux_err", AUX_TOL),
                         ("forward_aux_err", AUX_TOL)):
            assert got[key] < tol, (key, got[key])
        np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=0,
                                   atol=LOSS_TOL)
        assert max(got["grad_err"].values()) < GRAD_TOL, got["grad_err"]


# ------------------------------------------------------------------ (d)
def _fake_group(world):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@pytest.mark.parametrize("name", list(ARCHS))
def test_fake_mesh_probe_counts_the_ranks_experts(monkeypatch, name):
    """Fake (2, 4), batch 4 x 64: the layer probe's dot FLOPs a rank,
    times 8, are the mesh-free layer's plus three times its router's (the
    router runs on the rank's rows of the sequence gathered over "model":
    half the tokens, not an eighth); no all-gather has an expert weight's
    E rows or the microbatch's 4 token rows over "data"."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.launch import dryrun, hlo_stats, probes
    from repro_torch.sharding import specs
    model = _tmodel(name)
    cfg = model.cfg
    shape = configs.ShapeConfig("t", BATCH[1], BATCH[0], "prefill")
    seen, record = [], specs._record

    def log(kind, result, group):
        seen.append((kind, tuple(result.shape), dist.get_world_size(group)))
        return record(kind, result, group)
    monkeypatch.setattr(specs, "_record", log)
    with FakeTensorMode(allow_non_fake_inputs=True):
        (pr,) = probes.probes_for(model, shape)
        counter = hlo_stats.OpCounter()
        with counter:
            pr.fn(*pr.args)
    free = counter.dot_flops
    _fake_group(8)
    try:
        mesh = _mesh((2, 4))
        with FakeTensorMode(allow_non_fake_inputs=True):
            cost, _ = dryrun.run_probe(pr, model, mesh, specs.DEFAULT_RULES)
    finally:
        dist.destroy_process_group()
    T, D, E, F = BATCH[0] * BATCH[1], cfg.d_model, cfg.moe.num_experts, \
        cfg.d_ff
    router = 2 * T * D * E
    assert 8 * int(cost["dot_flops"]) == free + 3 * router, (cost, free)
    assert seen
    for kind, s, group in seen:
        if kind != "all-gather":
            continue
        assert s not in ((E, D, F), (E, F, D)), (s, group)
        assert not (group == 2 and s[0] == BATCH[0] and len(s) == 3), s


def test_keeps_and_group_split_by_case():
    """``tp_keeps`` on a fake (2, 4) mesh for the full and reduced MoE
    configs, and ``moe_groups_split`` inside a step on it."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.sharding import spmd
    _fake_group(8)
    try:
        mesh = _mesh((2, 4))
        full = {a: spmd.tp_keeps(configs.get_config(a), mesh)
                for a in ARCHS.values()}
        reduced = {n: spmd.tp_keeps(_tmodel(n).cfg, mesh) for n in ARCHS}
        with spmd.training(mesh, (0,), True):
            split = {t: spmd.moe_groups_split(t, 128)
                     for t in (64, 128, 192, 256)}
    finally:
        dist.destroy_process_group()
    both = {"expert", "vocab", "heads", "kv_heads"}
    assert full == {"dbrx-132b": both, "moonshot-v1-16b-a3b": both}
    assert reduced == {"dbrx": {"expert", "vocab"}, "moonshot": both}
    # the global T is twice the rank's: G = 1, 2, 3, 4
    assert split == {64: False, 128: True, 192: False, 256: True}


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
