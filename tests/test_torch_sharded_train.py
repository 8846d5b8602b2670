"""Sharded training of the port (``launch.steps``' sharded step over a
``("data", "model")`` DeviceMesh, ``sharding.spmd``) against ``repro``:

* the logical trees: every model's ``param_logical`` / ``cache_logical``
  (with no mesh and under a (data 2, model 2) mesh), ``train_state_logical``
  at ZeRO-3 and ZeRO-1 and ``batch_logical`` equal ``repro``'s for every
  arch of ``repro_torch.configs``;
* placements: on a 2x2 gloo mesh, ``state_shardings`` shards each leaf of
  every arch's train state over the mesh dims that ``repro``'s
  ``_fit_axes`` and ``resolve`` give, and a placed state holds only each
  rank's block;
* reduced codeqwen1.5-7b from ``repro``'s init (carried across), 3 fp32
  steps on (2, 1), (1, 2) and (2, 2) with the batch 8 x 32 of the
  reference's test: losses within 1e-3 of the mesh-free port's and of
  ``repro``'s jitted single-device step, step-1 gradients within 1e-5 of
  each leaf's largest magnitude; at (1, 2) the dense decoder runs
  tensor-parallel: the ranks read wq / wk / wv / wo / w_up / w_gate /
  w_down and the vocab on their "model" blocks, and the forward
  reduce-scatters over "model" onto the rank's rows of the sequence
  after the lookup, every ``wo`` and every ``w_down``;
* one (2, 1) case within 1e-3 of mesh-free for each of reduced dbrx-132b
  (also with 2 microbatches), rwkv6-7b, hymba-1.5b, whisper-large-v3 and
  llama-3.2-vision-11b; ZeRO-1 once;
* the trainer at ``mesh_shape=(2, 1)`` equals the step-level run, and
  without a process group it raises.

The ranks are two spawns of this file run as a script (2 and 4 gloo
ranks, torch only, one thread each, a file store, a timeout), started
together when the first test asks; each writes rank<R>.json."""
import datetime
import json
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240
ARCH = "codeqwen1.5-7b"
FAMILIES = ("dbrx-132b", "rwkv6-7b", "hymba-1.5b", "whisper-large-v3",
            "llama-3.2-vision-11b")
BATCH = (8, 32)
STEPS = 3
LR = 1e-3
LOSS_TOL = 1e-3
GRAD_TOL = 1e-5
TRAIN = dict(arch=ARCH, reduced=True, steps=3, batch=4, seq_len=16,
             log_every=1, device="cpu")


def _batch(model):
    from repro_torch.launch.train import extras_for
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size, BATCH)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    batch.update(extras_for(model, {"tokens": toks}))
    return batch


# ------------------------------------------------------------- the ranks
def _setup(arch):
    from repro_torch import configs
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.optim.adamw import AdamW
    model = get_model(reduced_config(configs.get_config(arch)))
    return model, AdamW(learning_rate=LR)


def _init(model, opt, out_dir):
    """``repro``'s init for ARCH (written by the test process), else the
    port's seed-0 init."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import steps
    if model.cfg.name == ARCH:
        return CheckpointManager(os.path.join(out_dir, "init")).restore(
            device="cpu")[0]
    return steps.init_train_state(model, opt,
                                  torch.Generator().manual_seed(0), "cpu")


def _mesh_free(model, opt, state, batch, microbatches=1):
    from repro_torch.launch import steps
    step = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                 remat=False, microbatches=microbatches)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def _on_mesh(model, opt, full, batch, shape, zero_stage=3, microbatches=1,
             grads_ref=None):
    """3 steps on ``shape``; the step-1 gradient error against
    ``grads_ref`` and each state leaf's (path, full shape, local shape)."""
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.sharding import specs
    from repro_torch.tree import tree_leaves
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
    with specs.use_mesh(mesh):
        sh = steps.state_shardings(model, full, zero_stage)
        state = steps.place(full, sh)
        batch = steps.place(batch, steps.batch_shardings(model, batch))
    out = {"blocks": [[list(f.shape), list(s.to_local().shape)] for f, s in
                      zip(tree_leaves(full), tree_leaves(state))]}
    if grads_ref is not None:
        (_, _), got = steps.sharded_value_and_grad(model, steps.make_loss_fn(
            model, compute_dtype=torch.float32, remat=False))(
                state["params"], batch)
        err = 0.0
        for g, want, s in zip(tree_leaves(got), tree_leaves(grads_ref),
                              tree_leaves(sh["params"])):
            want = specs.local_block(want, s)
            err = max(err, float((g - want).abs().max())
                      / max(float(want.abs().max()), 1e-30))
        out["grad_err"] = err
    step = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                 remat=False, microbatches=microbatches)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    return out


def _tp_trace(model, opt, out_dir):
    """At (1, 2): the shapes and "model" dims the forward reads its weights
    with, and the shapes of the forward's reduce-scatters over "model"
    onto the rank's rows (the residual keeps them: ``spmd.seq_split``)."""
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.sharding import specs, spmd
    full = _init(model, opt, out_dir)
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), "cpu")
    with specs.use_mesh(mesh):
        params = steps.place(full["params"], steps.param_shardings(
            model, full["params"]))
    read, sums = [], []
    materialize, apply = spmd.materialize, spmd._ScatterSP.apply

    def traced_materialize(local, mesh, plan, reduce_dims):
        out = materialize(local, mesh, plan, reduce_dims)
        read.append([list(out.shape), plan.tp_dim])
        return out

    def traced_scatter(x, m, dim):
        sums.append(list(x.shape))
        return apply(x, m, dim)
    spmd.materialize, spmd._ScatterSP.apply = (traced_materialize,
                                                traced_scatter)
    sp = spmd.seq_split(model.cfg, mesh, BATCH[1])
    try:
        with torch.no_grad(), spmd.training(mesh, (), True, sp=sp):
            steps.make_loss_fn(model, compute_dtype=torch.float32,
                               remat=False)(
                spmd.lazy_params(_locals(params), steps._plans(
                    model, _shardings(params), spmd.tp_keeps(model.cfg,
                                                             mesh)),
                    mesh, ()), _batch(model))
    finally:
        spmd.materialize, spmd._ScatterSP.apply = materialize, apply
    return {"read": read, "sums": sums, "sp": sp}


def _locals(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to_local(), tree)


def _shardings(tree):
    from repro_torch.sharding import specs
    from repro_torch.tree import tree_map
    return tree_map(specs.sharding_of, tree)


def _placements(world):
    """Every arch's train-state placements on the 2x2 mesh: per leaf (its
    path, shape, the (mesh dim, tensor dim) pairs it is sharded over)."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import specs
    from repro_torch.checkpoint.manager import _flatten
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch in configs.list_archs():
        cfg = configs.get_config(arch)
        if cfg.family.name == "CNN":
            continue
        model = get_model(reduced_config(cfg))
        for zero in (3, 1):
            shapes = steps.train_state_shapes(model, AdamW())
            with specs.use_mesh(mesh):
                sh = steps.state_shardings(model, shapes, zero)
            flat_sh, flat_shape = _flatten(sh), _flatten(shapes)
            out[f"{arch}/{zero}"] = {
                k: [list(flat_shape[k].shape),
                    [list(p) for p in specs.shard_dims(v)]]
                for k, v in flat_sh.items()}
    return out


def _trainer(out_dir):
    """The trainer at (2, 1) and the same run through the step."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.launch.train import (TrainConfig, extras_for,
                                          make_optimizer, train)
    from repro_torch.sharding import specs
    tc = TrainConfig(mesh_shape=(2, 1),
                     ckpt_dir=os.path.join(out_dir, "trainer"), **TRAIN)
    got = train(tc)
    model, _ = _setup(ARCH)
    opt = make_optimizer(tc)
    mesh = mesh_mod.make_mesh((2, 1), ("data", "model"), "cpu")
    stream = TokenStream(model.cfg.vocab_size, tc.batch, tc.seq_len, tc.seed)
    step = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                 remat=False)
    with specs.use_mesh(mesh):
        state = steps.init_train_state(
            model, opt, torch.Generator("cpu").manual_seed(tc.seed), "cpu")
        state = steps.place(state, steps.state_shardings(model, state))
        losses = []
        for i in range(tc.steps):
            raw = stream.batch_at(i)
            batch = {k: torch.from_numpy(v.copy()) for k, v in raw.items()}
            batch.update(extras_for(model, raw))
            state, m = step(state, steps.place(
                batch, steps.batch_shardings(model, batch)))
            losses.append(float(m["loss"]))
    return {"train": got["losses"], "steps": losses}


def _edges():
    """At (2, 1): ``make_lm_pipeline(mesh=)``'s rows, ``shard`` of a
    replicated DTensor and ``spec_tree`` of the batch's logical axes."""
    from repro_torch.data.synthetic import TokenStream, make_lm_pipeline
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.sharding import specs
    mesh = mesh_mod.make_mesh((2, 1), ("data", "model"), "cpu")
    pipe = make_lm_pipeline(512, 4, 16, seed=3, start_step=5, mesh=mesh)
    got = next(pipe)
    pipe.close()
    r = mesh.get_local_rank("data")
    want = TokenStream(512, 4, 16, 3).batch_at(5)
    rows = all(np.array_equal(got[k].to_local().numpy(),
                              want[k][2 * r:2 * r + 2]) for k in want)
    model, _ = _setup(ARCH)
    with specs.use_mesh(mesh):
        x = specs.distribute(torch.arange(32.).reshape(4, 8),
                             specs.named_sharding(None, None))
        y = specs.shard(x, "batch", None)
        tree = specs.spec_tree({"tokens": ("batch", None)})
        cache = steps.cache_shardings(model, model.init_cache(
            2, 8, device="meta"))
    return {"rows": rows, "shard": [list(y.to_local().shape),
                                    str(y.placements)],
            "spec_tree": str(tree["tokens"].placements),
            "cache": str(cache["k"].placements)}


def _rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.launch import steps
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    model, opt = _setup(ARCH)
    batch = _batch(model)
    full = _init(model, opt, out_dir)
    grads = steps.value_and_grad(steps.make_loss_fn(
        model, compute_dtype=torch.float32, remat=False))(
            full["params"], batch)[1]
    out = {"ref": _mesh_free(model, opt, full, batch)}
    if world == 4:
        out["(2, 2)"] = _on_mesh(model, opt, full, batch, (2, 2),
                                 grads_ref=grads)
        out["placements"] = _placements(world)
    else:
        for shape in ((2, 1), (1, 2)):
            out[str(shape)] = _on_mesh(model, opt, full, batch, shape,
                                       grads_ref=grads)
        out["zero1"] = _on_mesh(model, opt, full, batch, (2, 1),
                                zero_stage=1)
        out["tp"] = _tp_trace(model, opt, out_dir)
        out["families"] = {}
        for arch in FAMILIES:
            m, o = _setup(arch)
            b, s = _batch(m), _init(m, o, out_dir)
            out["families"][arch] = {
                "ref": _mesh_free(m, o, s, b),
                "(2, 1)": _on_mesh(m, o, s, b, (2, 1))["losses"]}
        m, o = _setup("dbrx-132b")
        b, s = _batch(m), _init(m, o, out_dir)
        out["microbatches"] = {
            "ref": _mesh_free(m, o, s, b, microbatches=2),
            "(2, 1)": _on_mesh(m, o, s, b, (2, 1), microbatches=2)["losses"]}
        out["trainer"] = _trainer(out_dir)
        out["edges"] = _edges()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- the tests
def _reference_init(out_dirs):
    """``repro``'s seed-0 train state of reduced ARCH, as a checkpoint the
    ranks restore (full arrays, the format both packages share), in each
    of ``out_dirs``."""
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint.manager import CheckpointManager
    from repro.launch import steps as jsteps
    from repro.models.registry import get_model, reduced_config
    from repro.optim.adamw import AdamW
    model = get_model(reduced_config(jconfigs.get_config(ARCH)))
    state = jsteps.init_train_state(model, AdamW(learning_rate=LR),
                                    jax.random.PRNGKey(0))
    for out_dir in out_dirs:
        CheckpointManager(out_dir / "init", async_save=False).save(0, state)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from test_torch_sharding import start_ranks, wait_ranks
    dirs = {world: tmp_path_factory.mktemp(f"sharded{world}")
            for world in (2, 4)}
    _reference_init(dirs.values())
    started = {world: (start_ranks(world, d, __file__), d)
               for world, d in dirs.items()}
    done = {}

    def get(world):
        if world not in done:
            done[world] = wait_ranks(*started[world], timeout=TIMEOUT)
        return done[world]
    yield get
    for procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def reference_losses():
    """``repro``'s jitted single-device step, 3 fp32 steps of reduced ARCH
    from its seed-0 init on the batch the ranks use."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models.registry import get_model, reduced_config
    from repro.optim.adamw import AdamW
    model = get_model(reduced_config(jconfigs.get_config(ARCH)))
    opt = AdamW(learning_rate=LR)
    state = jsteps.init_train_state(model, opt, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size, BATCH)
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}
    step = jax.jit(jsteps.make_train_step(model, opt,
                                          compute_dtype=jnp.float32,
                                          remat=False))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def _all_equal(ranks, key):
    for r in ranks[1:]:
        assert r[key] == ranks[0][key], f"ranks disagree on {key}"


@pytest.mark.parametrize("shape", ["(2, 1)", "(1, 2)", "(2, 2)"])
def test_sharded_training_matches_single_device(spawned, reference_losses,
                                                shape):
    ranks = spawned(4 if shape == "(2, 2)" else 2)
    got = ranks[0][shape]
    for r in ranks[1:]:
        assert r[shape]["losses"] == got["losses"], "ranks disagree"
    np.testing.assert_allclose(got["losses"], ranks[0]["ref"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got["losses"], reference_losses, rtol=0,
                               atol=LOSS_TOL)
    for r in ranks:
        assert r[shape]["grad_err"] < GRAD_TOL, r[shape]["grad_err"]
    dims = [int(d) for d in shape.strip("()").split(",")]
    # every rank holds a block: the whole state over the ranks is the
    # state, not more, for the leaves that divide
    held = sum(np.prod(local) for _, local in got["blocks"])
    whole = sum(np.prod(full) for full, _ in got["blocks"])
    assert held < whole or dims == [1, 1]


def test_state_placements_follow_the_reference_rules(spawned):
    """Per leaf of every arch's train state (ZeRO-3 and ZeRO-1): the mesh
    dims the port shards it over are those of ``repro``'s ``_fit_axes`` and
    ``resolve`` on a mesh of the same axes."""
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models.registry import get_model, reduced_config
    from repro.sharding import specs as jspecs
    from test_torch_sharding import _Mesh
    ranks = spawned(4)
    _all_equal(ranks, "placements")
    names = ("data", "model")
    for key, leaves in ranks[0]["placements"].items():
        arch, zero = key.rsplit("/", 1)
        model = get_model(reduced_config(jconfigs.get_config(arch)))
        logical = _flatten_logical(jsteps.train_state_logical(
            model, int(zero)))
        with jspecs.use_mesh(_Mesh((2, 2), names)):
            for path, (shape, got) in leaves.items():
                ax = logical[path]
                fitted = jspecs._fit_axes(tuple(shape), ax)
                spec = jspecs.resolve(*fitted)
                want = []
                for d, a in enumerate(spec):
                    for m in (() if a is None else (a,) if isinstance(a, str)
                              else a):
                        want.append([names.index(m), d])
                assert sorted(got) == sorted(want), (key, path, got, want)


def _flatten_logical(tree, prefix=""):
    """A logical tree flattened like checkpoint keys (tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_logical(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_rank_blocks_divide_the_state(spawned):
    """Each rank's block of each leaf is the full leaf cut by the mesh sizes
    of the dims it is sharded over (and only divisible dims are cut)."""
    for world, shape in ((2, "(2, 1)"), (2, "(1, 2)"), (4, "(2, 2)")):
        for r in spawned(world):
            for full, local in r[shape]["blocks"]:
                assert all(f % l == 0 for f, l in zip(full, local))
                assert np.prod(full) // np.prod(local) <= world


def test_zero1_keeps_params_whole_over_data(spawned):
    ranks = spawned(2)
    got = ranks[0]["zero1"]
    np.testing.assert_allclose(got["losses"], ranks[0]["ref"], rtol=0,
                               atol=LOSS_TOL)
    # the train state's leaves in sorted order: opt (count, m, v), params,
    # step; ZeRO-1 params are whole on each data rank, m and v are cut
    n = len(got["blocks"])
    per = (n - 2) // 3
    m_blocks = got["blocks"][1:1 + per]
    p_blocks = got["blocks"][1 + 2 * per:1 + 3 * per]
    assert all(full == local for full, local in p_blocks)
    assert any(full != local for full, local in m_blocks)


def test_dense_decoder_runs_tensor_parallel(spawned):
    """At (1, 2): the ranks read the attention, MLP and vocab weights on
    their "model" blocks, and the forward reduce-scatters over "model"
    onto the rank's rows of the sequence once after the lookup and after
    each layer's wo and w_down (2 layers: 5 d_model-wide reduce-scatters
    of every row), where the residual was replicated and these were
    all-reduces; the CE's vocab reductions stay all-reduces."""
    from repro_torch import configs
    from repro_torch.models.registry import reduced_config
    cfg = reduced_config(configs.get_config(ARCH))
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hq = cfg.num_heads * cfg.head_dim
    for r in spawned(2):
        read = r["tp"]["read"]
        for shape, dim in (((D, hq // 2), 1),      # wq, wk, wv (KV == H)
                           ((hq // 2, D), 0),      # wo
                           ((D, F // 2), 1),       # w_up, w_gate
                           ((F // 2, D), 0),       # w_down
                           ((D, V // 2), 1),       # the untied head
                           ((V // 2, D), 0)):      # the embedding table
            assert [list(shape), dim] in read, (shape, dim, read)
        assert r["tp"]["sp"]
        wide = [s for s in r["tp"]["sums"] if s[-1] == D]
        assert len(wide) == 1 + 2 * cfg.num_layers, r["tp"]["sums"]
        assert all(s[:2] == list(BATCH) for s in wide), wide


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_train_on_a_data_mesh(spawned, arch):
    ranks = spawned(2)
    got = ranks[0]["families"][arch]
    for r in ranks[1:]:
        assert r["families"][arch] == got
    np.testing.assert_allclose(got["(2, 1)"], got["ref"], rtol=0,
                               atol=LOSS_TOL)


def test_microbatches_keep_the_reference_row_order(spawned):
    """dbrx at (2, 1) with 2 microbatches: each microbatch is sharded after
    the split, so every MoE call routes the tokens it routes mesh-free."""
    got = spawned(2)[0]["microbatches"]
    np.testing.assert_allclose(got["(2, 1)"], got["ref"], rtol=0,
                               atol=LOSS_TOL)


def test_trainer_on_a_mesh_equals_the_step(spawned):
    for r in spawned(2):
        assert r["trainer"]["train"] == r["trainer"]["steps"]
        assert len(r["trainer"]["train"]) == TRAIN["steps"]


def test_pipeline_shard_and_spec_tree_on_a_mesh(spawned):
    """Each rank's pipeline batch is its "batch" rows of the stream's;
    ``shard`` redistributes a replicated DTensor to its rows; ``spec_tree``
    and ``cache_shardings`` give the batch's and the cache's placements."""
    for r in spawned(2):
        got = r["edges"]
        assert got["rows"]
        assert got["shard"] == [[2, 8], "(Shard(dim=0), Replicate())"]
        assert got["spec_tree"] == "(Shard(dim=0), Replicate())"
        # the cache's batch dim over "data" (cache_shardings)
        assert got["cache"] == "(Shard(dim=1), Replicate())"


def test_shard_without_a_mesh_is_identity_and_checks_rank_under_one():
    from repro_torch.sharding import specs

    class TMesh:     # the port's resolution reads these two
        mesh_dim_names = ("model",)
        shape = (1,)
    x = torch.ones(4, 4)
    assert specs.shard(x, "batch", None) is x
    assert specs.shard(x, "batch", None, "heads") is x   # rank unchecked
    with specs.use_mesh(TMesh):
        with pytest.raises(ValueError, match="rank mismatch"):
            specs.shard(x, "batch", None, "heads")
        assert specs.shard(x, "batch", None) is x          # a local tensor


def test_trainer_without_a_process_group_raises(monkeypatch):
    from repro_torch.launch.train import TrainConfig, train
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs a process group"):
        train(TrainConfig(mesh_shape=(2, 1), **TRAIN))


@pytest.mark.parametrize("arch", sorted(
    a for a in ("codeqwen1.5-7b", "qwen2.5-32b", "qwen2.5-32b-mla",
                "minicpm-2b", "command-r-35b", "dbrx-132b",
                "moonshot-v1-16b-a3b", "rwkv6-7b", "hymba-1.5b",
                "whisper-large-v3", "llama-3.2-vision-11b")))
def test_logical_trees_equal_the_reference(arch):
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models.registry import get_model as jget, reduced_config as jred
    from repro.sharding import specs as jspecs
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.sharding import specs
    from test_torch_sharding import _Mesh
    for reduce in (False, True):
        jm = jget(jred(jconfigs.get_config(arch)) if reduce
                  else jconfigs.get_config(arch))
        tm = get_model(reduced_config(configs.get_config(arch)) if reduce
                       else configs.get_config(arch))
        assert tm.param_logical() == jm.param_logical()
        assert tm.cache_logical() == jm.cache_logical()
        for zero in (3, 1):
            assert (steps.train_state_logical(tm, zero)
                    == jsteps.train_state_logical(jm, zero))
        keys = ("tokens", "labels", "token", "image_embeds", "frames")
        assert steps.batch_logical(tm, keys) == jsteps.batch_logical(jm, keys)
        for shape in ((2, 2), (1, 8)):
            class TMesh:       # the port's resolution reads these two
                mesh_dim_names = ("data", "model")
            TMesh.shape = shape
            with jspecs.use_mesh(_Mesh(shape, ("data", "model"))):
                want = jm.cache_logical()
            with specs.use_mesh(TMesh):
                assert tm.cache_logical() == want


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
