"""The sequence over "model" in the port (``sharding.spmd``'s rows over
"model", ``layers``' flash decode, context-parallel rows and banded form)
against mesh-free runs and ``repro``:

* (a) on each rank's slice of a cache, the port's partial softmax
  ``(m, l, acc)`` equals ``repro.models.layers._decode_sdpa_local`` of
  the same slice (JAX on the CPU, no mesh) within 1e-6;
* (b) the lockstep decode of reduced qwen2.5-32b (4 heads over 1 kv head)
  over a cache whose sequence is split over "model", 8 greedy steps at
  (1, 2) and (1, 3), and of reduced whisper-large-v3 (4 kv heads, its
  cross K / V gathered) at (1, 3): logits within ``SERVE_TOL`` of
  mesh-free and of ``repro``'s prefill and decode steps, tokens equal to
  both, each rank's cache block equal to mesh-free's rows, and no
  all-gather of a self-attention cache layer;
* (c) ``_sdpa_banded_cp`` at 2 and 4 ranks equals ``repro``'s mesh-free
  ``_sdpa_banded`` within 1e-5 (a halo wider than a rank's rows falls
  back), its gradients the mesh-free form's, its halo recorded as one
  ``collective-permute`` of W rows per tensor;
* (d) the dense decoder's train step (losses and step-1 gradients, the
  bounds of ``test_torch_sharded_train.py``) and sharded prefill
  (``SERVE_TOL``) equal mesh-free and ``repro``'s jitted single-device
  step and prefill in three modes: context-parallel (reduced qwen at
  (1, 2) and (1, 3)), sequence-parallel (``num_kv_heads=2`` at (1, 2)
  and (2, 2)) and MLA (reduced qwen2.5-32b-mla at (1, 2): its attention
  runs whole on every rank's rows, each weight's gradient summed over
  "model");
* (e) hymba-1.5b's prefill through the banded form at (1, 2) within
  ``SERVE_TOL`` of mesh-free and of ``repro``'s banded prefill;
* (f) on a fake (1, 4) mesh: a decode step records no all-gather of the
  cache and three fp32 all-reduces per layer for its attention, also in
  ``dryrun.run_cell``'s record; a context-parallel prefill's layer counts
  a quarter of the mesh-free layer's dot FLOPs on each rank.

The ranks are three spawns of this file run as a script (2, 3 and 4 gloo
ranks, ``python tests/test_torch_cp.py RANK WORLD DIR``), started
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
ARCH = "qwen2.5-32b"
HYBRID = "hymba-1.5b"
SERVE_TOL = 1e-4
BANDED_TOL = 1e-5
PARTIAL_TOL = 1e-6
LOSS_TOL = 1e-3                 # test_torch_sharded_train.py's bounds
GRAD_TOL = 1e-5
STEPS = 3
DECODE_STEPS = 8
PROMPT, S_MAX, SLOTS = 6, 24, 2          # s_max divides 2 and 3 ranks
TRAIN_BATCH = (4, 24)                    # rows divide 2 and 3 ranks
HYMBA_BATCH = (1, 2048)                  # two chunks of 1024: one a rank
MLA = "qwen2.5-32b-mla"
# (mode, arch, config overrides, mesh): kv heads 1 keep the heads whole
# (context-parallel rows), kv heads 2 put them over "model" (sequence
# parallelism); MLA runs its heads whole on every rank's rows and keeps
# the rank's after
TRAIN_CASES = (("cp", ARCH, {}, (1, 2)), ("cp", ARCH, {}, (1, 3)),
               ("sp", ARCH, {"num_kv_heads": 2}, (1, 2)),
               ("sp", ARCH, {"num_kv_heads": 2}, (2, 2)),
               ("mla", MLA, {}, (1, 2)))
# (arch, mesh): whisper's self-attention cache decodes in the flash form
# while its cross K / V are gathered a layer at a time
DECODE_CASES = ((ARCH, (1, 2)), (ARCH, (1, 3)),
                ("whisper-large-v3", (1, 3)))
# (name, window, q_chunk): at 4 ranks the second's halo (24 rows) is
# wider than a rank's 16 rows, and the form falls back
BANDED_CASES = (("halo", 8, 8), ("wide", 24, 8))
BANDED_SHAPE = (2, 64, 4, 2, 8)          # B, S, H, KV, hd


def _tmodel(arch, **over):
    from repro_torch import configs
    from repro_torch.models.registry import get_model, reduced_config
    return get_model(reduced_config(configs.get_config(arch), **over))


def _train_batch(vocab):
    toks = np.random.default_rng(1).integers(0, vocab, TRAIN_BATCH)
    return toks, np.roll(toks, -1, 1)


def _prompt(vocab):
    return np.random.default_rng(3).integers(
        0, vocab, (SLOTS, PROMPT)).astype(np.int32)


def _hymba_tokens(vocab):
    return np.random.default_rng(4).integers(
        0, vocab, HYMBA_BATCH).astype(np.int32)


def _grads_file(out_dir, case, rank):
    return os.path.join(out_dir, f"grads{TRAIN_CASES.index(case)}"
                                 f"_rank{rank}.npz")


def _mesh(shape):
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.make_mesh(shape, ("data", "model"), "cpu")


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------- the ranks
def _train_case(case, out_dir):
    """Step-1 gradient error and 3 fp32 steps' losses on the case's mesh
    against mesh-free, the sharded prefill's logits and their error, and
    whether the residual kept the rank's rows with the heads over "model"
    or not. The rank's step-1 gradient blocks go to a file, each beside
    its elements' flat indices in the whole leaf."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import specs, spmd
    from repro_torch.tree import tree_leaves
    _, arch, over, shape = case
    model = _tmodel(arch, **over)
    opt = AdamW(learning_rate=1e-3)
    toks, labels = _train_batch(model.cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    full = steps.init_train_state(model, opt,
                                  torch.Generator().manual_seed(0), "cpu")
    loss_fn = steps.make_loss_fn(model, compute_dtype=torch.float32,
                                 remat=False)
    ref_grads = steps.value_and_grad(loss_fn)(full["params"], batch)[1]
    step = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                 remat=False)
    state, ref = full, []
    for _ in range(STEPS):
        state, m = step(state, batch)
        ref.append(float(m["loss"]))
    prefill = {sh: steps.make_prefill(model, compute_dtype=torch.float32,
                                      attn_impl="einsum", sharded=sh)
               for sh in (False, True)}
    ref_logits = prefill[False](full["params"], {"tokens": batch["tokens"]})

    mesh = _mesh(shape)
    with specs.use_mesh(mesh):
        sh = steps.state_shardings(model, full)
        placed = steps.place(full, sh)
        pbatch = steps.place(batch, steps.batch_shardings(model, batch))
        tokens = steps.place({"tokens": batch["tokens"]},
                             steps.batch_shardings(
                                 model, {"tokens": batch["tokens"]}))
    keeps = spmd.tp_keeps(model.cfg, mesh)
    got = steps.sharded_value_and_grad(model, loss_fn)(placed["params"],
                                                       pbatch)[1]
    err, blocks = 0.0, {}
    for n, (g, full, s) in enumerate(zip(tree_leaves(got),
                                         tree_leaves(ref_grads),
                                         tree_leaves(sh["params"]))):
        want = specs.local_block(full, s)
        err = max(err, _max_diff(g, want) / max(float(want.abs().max()),
                                                1e-30))
        blocks[f"g{n}"] = g.numpy()
        blocks[f"i{n}"] = specs.local_block(
            torch.arange(full.numel()).reshape(full.shape), s).numpy()
    np.savez(_grads_file(out_dir, case, dist.get_rank()), **blocks)
    state, losses = placed, []
    for _ in range(STEPS):
        state, m = step(state, pbatch)
        losses.append(float(m["loss"]))
    logits = prefill[True](placed["params"], tokens)
    return {"sp": spmd.seq_split(model.cfg, mesh, TRAIN_BATCH[1]),
            "heads_split": "heads" in keeps, "grad_err": err,
            "losses": losses, "ref": ref, "prefill": logits.tolist(),
            "prefill_err": _max_diff(logits, ref_logits)}


def _decode_case(arch, shape):
    """8 greedy lockstep steps over a cache whose sequence is split over
    "model", against mesh-free: the logits error, both token streams, the
    rank's cache blocks' error and how many all-gathers had a gathered
    cache layer's bytes."""
    from repro_torch.launch import hlo_stats, steps
    from repro_torch.sharding import specs
    from repro_torch.tree import tree_map
    model = _tmodel(arch)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    f32 = dict(compute_dtype=torch.float32)
    prompt = torch.from_numpy(_prompt(model.cfg.vocab_size))
    _, cache = steps.make_prefill(model, return_cache=True, s_max=S_MAX,
                                  **f32)(params, {"tokens": prompt})
    first = prompt[:, -1:]

    def greedy(decode, p, c, place=lambda b: b):
        tok, logits, toks = first, [], []
        for _ in range(DECODE_STEPS):
            out, c = decode(p, c, place({"token": tok}))
            logits.append(out)
            tok = out[:, -1].argmax(-1, keepdim=True).int()
            toks.append(tok[:, 0].tolist())
        return logits, toks, c

    ref_logits, ref_toks, ref_cache = greedy(
        steps.make_decode_step(model, **f32), params,
        tree_map(torch.clone, cache))
    mesh = _mesh(shape)
    with specs.use_mesh(mesh):
        p = steps.place(params, steps.param_shardings(model, params))
        c = steps.place(tree_map(torch.clone, cache),
                        steps.cache_shardings(model, cache))

    def place(b):
        with specs.use_mesh(mesh):
            return steps.place(b, steps.batch_shardings(model, b))
    decode = steps.make_decode_step(model, sharded=True, **f32)
    with hlo_stats.collectives() as records:
        logits, toks, c = greedy(decode, p, c, place)
    block = {k: _max_diff(v.to_local(), specs.local_block(
        ref_cache[k], specs.sharding_of(v))) for k, v in c.items()
        if k != "pos"}
    layer_kv = cache["k"][0].numel() * cache["k"].element_size()
    return {"logits_err": max(_max_diff(a, b) for a, b in
                              zip(logits, ref_logits)),
            "logits": [t.tolist() for t in logits],
            "tokens": toks, "ref_tokens": ref_toks, "block_err": block,
            "split": str(c["k"].placements),
            "cache_gathers": sum(1 for kind, n, _ in records
                                 if kind == "all-gather" and n == layer_kv)}


def _banded_case(world, window, q_chunk):
    """``_sdpa_banded_cp`` on a (1, world) mesh: its output and gradients
    against the mesh-free ``_sdpa_banded``, and its collectives."""
    from repro_torch.launch import hlo_stats
    from repro_torch.models import layers as L
    from repro_torch.sharding import spmd
    B, S, H, KV, hd = BANDED_SHAPE
    q, k, v = _banded_inputs()
    dims = L.AttnDims(d_model=H * hd, num_heads=H, num_kv_heads=KV,
                      head_dim=hd, window=window)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, S, H, hd)).astype(np.float32))

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, dims, q_chunk)
        grads = torch.autograd.grad((out * w).sum(), leaves)
        return out.detach(), grads

    ref, ref_grads = run(L._sdpa_banded)
    mesh = _mesh((1, world))
    with hlo_stats.collectives() as records, \
            spmd.training(mesh, (), False):
        out, grads = run(L._sdpa_banded_cp)
    return {"out": out.numpy().tolist(),
            "grad_err": max(_max_diff(a, b) for a, b in
                            zip(grads, ref_grads)),
            "collectives": [[kind, n] for kind, n, _ in records]}


def _banded_inputs():
    B, S, H, KV, hd = BANDED_SHAPE
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _hymba_case():
    """hymba's prefill through the banded form at (1, 2) against
    mesh-free, and the halo sends it made."""
    from repro_torch.launch import hlo_stats, steps
    from repro_torch.sharding import specs
    model = _tmodel(HYBRID)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_hymba_tokens(model.cfg.vocab_size))
    kw = dict(compute_dtype=torch.float32, attn_impl="banded",
              scan_impl="scan")
    ref = steps.make_prefill(model, **kw)(params, {"tokens": tokens})
    mesh = _mesh((1, 2))
    with specs.use_mesh(mesh):
        p = steps.place(params, steps.param_shardings(model, params))
        b = steps.place({"tokens": tokens}, steps.batch_shardings(
            model, {"tokens": tokens}))
    with hlo_stats.collectives() as records:
        got = steps.make_prefill(model, sharded=True, **kw)(p, b)
    return {"err": _max_diff(got, ref), "logits": got.tolist(),
            "permutes": sum(1 for kind, _, _ in records
                            if kind == "collective-permute")}


def _rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    out = {"train": {}, "decode": {}, "banded": {}}
    for case in TRAIN_CASES:
        if int(np.prod(case[3])) == world:
            out["train"][_train_key(case)] = _train_case(case, out_dir)
    for arch, shape in DECODE_CASES:
        if int(np.prod(shape)) == world:
            out["decode"][f"{arch} {shape}"] = _decode_case(arch, shape)
    if world in (2, 4):
        for name, window, q_chunk in BANDED_CASES:
            out["banded"][name] = _banded_case(world, window, q_chunk)
    if world == 2:
        out["hymba"] = _hymba_case()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _train_key(case):
    return f"{case[0]} {case[3]}"


# ------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from test_torch_sharding import start_ranks, wait_ranks
    dirs = {world: tmp_path_factory.mktemp(f"cp{world}")
            for world in (2, 3, 4)}
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


def _jmodel(arch, **over):
    from repro import configs
    from repro.models.registry import get_model, reduced_config
    return get_model(reduced_config(configs.get_config(arch), **over))


def _bridged(params):
    """The port's params as ``repro``'s (the same nesting, jax arrays)."""
    import jax
    import jax.numpy as jnp
    from repro_torch import bridge
    return jax.tree.map(jnp.asarray, bridge.to_numpy(params))


def _ref_train(arch, over):
    """``repro`` on the port's seed-0 init of a train case's model and
    its batch: 3 jitted fp32 steps' losses, the step-1 gradients (flat,
    in ``tree_leaves`` order) and the prefill's last-row logits."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamW as JAdamW
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    model = _tmodel(arch, **over)
    params = _bridged(steps.init_train_state(
        model, AdamW(learning_rate=1e-3), torch.Generator().manual_seed(0),
        "cpu")["params"])
    jmodel, opt = _jmodel(arch, **over), JAdamW(learning_rate=1e-3)
    toks, labels = _train_batch(model.cfg.vocab_size)
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
    prefill = jax.jit(jsteps.make_prefill(jmodel, compute_dtype=jnp.float32,
                                          attn_impl="einsum"))
    return {"losses": losses,
            "grads": [np.asarray(g).ravel() for g in jax.tree.leaves(grads)],
            "prefill": np.asarray(prefill(params,
                                          {"tokens": batch["tokens"]}))}


def _ref_decode(arch):
    """``repro``'s prefill into a dense cache and 8 greedy lockstep
    decode steps on the port's seed-0 init and the ranks' prompt."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    model = _tmodel(arch)
    params = _bridged(model.init(torch.Generator().manual_seed(0), "cpu"))
    jmodel = _jmodel(arch)
    prompt = jnp.asarray(_prompt(model.cfg.vocab_size))
    _, cache = jax.jit(jsteps.make_prefill(
        jmodel, return_cache=True, s_max=S_MAX,
        compute_dtype=jnp.float32))(params, {"tokens": prompt})
    decode = jax.jit(jsteps.make_decode_step(jmodel,
                                             compute_dtype=jnp.float32))
    tok, logits, toks = prompt[:, -1:], [], []
    for _ in range(DECODE_STEPS):
        out, cache = decode(params, cache, {"token": tok})
        logits.append(np.asarray(out))
        tok = jnp.argmax(out[:, -1], -1, keepdims=True).astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]).tolist())
    return {"logits": logits, "tokens": toks}


def _ref_hymba():
    """``repro``'s banded prefill of hymba on the port's seed-0 init."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    model = _tmodel(HYBRID)
    params = _bridged(model.init(torch.Generator().manual_seed(0), "cpu"))
    tokens = jnp.asarray(_hymba_tokens(model.cfg.vocab_size))
    return np.asarray(jax.jit(jsteps.make_prefill(
        _jmodel(HYBRID), compute_dtype=jnp.float32, attn_impl="banded"))(
            params, {"tokens": tokens}))


@pytest.fixture(scope="module")
def reference():
    """``reference(kind, *key)``: ``repro``'s results for a train case's
    model (arch, overrides), a decode case's arch or hymba, each computed
    once when first asked (after the ranks were started, so both run
    together)."""
    done = {}
    make = {"train": lambda arch, over: _ref_train(arch, dict(over)),
            "decode": _ref_decode, "hymba": _ref_hymba}

    def get(kind, *key):
        if (kind, key) not in done:
            done[kind, key] = make[kind](*key)
        return done[kind, key]
    return get


@pytest.mark.parametrize("ways", [2, 3])
@pytest.mark.parametrize("window", [0, 5])
def test_partials_equal_the_reference_on_each_slice(ways, window):
    import jax.numpy as jnp
    from repro.models import layers as jL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(ways * 10 + window)
    B, S, KV, G, hd, pos = 2, 24, 2, 3, 8, 13
    q = rng.standard_normal((B, 1, KV, G, hd)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
              for _ in range(2))
    s_loc = S // ways
    for r in range(ways):
        sl = slice(r * s_loc, (r + 1) * s_loc)
        kpos = r * s_loc + np.arange(s_loc)
        got = L._decode_sdpa_local(
            torch.from_numpy(q), torch.from_numpy(ck[:, sl]),
            torch.from_numpy(cv[:, sl]), pos,
            torch.from_numpy(kpos)[None, :], window, hd)
        want = jL._decode_sdpa_local(jnp.asarray(q), jnp.asarray(ck[:, sl]),
                                     jnp.asarray(cv[:, sl]), pos,
                                     jnp.asarray(kpos), window, hd)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=PARTIAL_TOL, atol=PARTIAL_TOL)


@pytest.mark.parametrize("case", [f"{a} {s}" for a, s in DECODE_CASES])
def test_decode_over_a_sequence_split_cache(spawned, reference, case):
    arch, shape = case.split(" ", 1)
    ranks = spawned(int(np.prod(eval(shape))))
    want = reference("decode", arch)
    for r in ranks:
        got = r["decode"][case]
        assert "Shard(dim=2)" in got["split"], got["split"]
        assert got["logits_err"] < SERVE_TOL, got["logits_err"]
        assert got["tokens"] == got["ref_tokens"] == want["tokens"]
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(np.array(a), b, rtol=0,
                                       atol=SERVE_TOL)
        assert max(got["block_err"].values()) < SERVE_TOL, got["block_err"]
        assert got["cache_gathers"] == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", [c[0] for c in BANDED_CASES])
def test_banded_cp_equals_the_reference(spawned, world, case):
    import jax.numpy as jnp
    from repro.models import layers as jL
    _, window, q_chunk = next(c for c in BANDED_CASES if c[0] == case)
    B, S, H, KV, hd = BANDED_SHAPE
    dims = jL.AttnDims(d_model=H * hd, num_heads=H, num_kv_heads=KV,
                       head_dim=hd, window=window)
    want = np.asarray(jL._sdpa_banded(
        *(jnp.asarray(t.numpy()) for t in _banded_inputs()), dims, q_chunk))
    n_chunks = S // q_chunk
    falls_back = window > q_chunk * (n_chunks // world)
    halo = B * window * KV * hd * 4
    for r in spawned(world):
        got = r["banded"][case]
        np.testing.assert_allclose(np.array(got["out"]), want,
                                   rtol=BANDED_TOL, atol=BANDED_TOL)
        assert got["grad_err"] < BANDED_TOL, got["grad_err"]
        permutes = [n for kind, n in got["collectives"]
                    if kind == "collective-permute"]
        # forward: K's halo and V's; backward: each sent back
        assert permutes == ([] if falls_back else [halo] * 4), permutes


@pytest.mark.parametrize("case", [_train_key(c) for c in TRAIN_CASES])
def test_training_and_prefill_with_the_rows_over_model(spawned, reference,
                                                       case):
    """Every rank against mesh-free (on the rank) and against ``repro``:
    the losses, each step-1 gradient block relative to the largest
    magnitude of ``repro``'s block, the sharded prefill's logits."""
    full = next(c for c in TRAIN_CASES if _train_key(c) == case)
    mode, arch, over, shape = full
    world = int(np.prod(shape))
    ranks = spawned(world)
    want = reference("train", arch, tuple(sorted(over.items())))
    for rank, r in enumerate(ranks):
        got = r["train"][case]
        assert got["sp"]
        assert got["heads_split"] == (mode == "sp")
        assert got["losses"] == ranks[0]["train"][case]["losses"]
        np.testing.assert_allclose(got["losses"], got["ref"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=LOSS_TOL)
        assert got["grad_err"] < GRAD_TOL, got["grad_err"]
        blocks = np.load(_grads_file(spawned.dirs[world], full, rank))
        assert len(blocks.files) == 2 * len(want["grads"])
        for n, flat in enumerate(want["grads"]):
            w = flat[blocks[f"i{n}"]]
            err = np.abs(blocks[f"g{n}"] - w).max() / max(np.abs(w).max(),
                                                           1e-30)
            assert err < GRAD_TOL, (n, err)
        assert got["prefill_err"] < SERVE_TOL, got["prefill_err"]
        np.testing.assert_allclose(np.array(got["prefill"]), want["prefill"],
                                   rtol=0, atol=SERVE_TOL)


def test_hymba_prefill_through_the_banded_form(spawned, reference):
    ranks = spawned(2)
    want = reference("hymba")
    for r in ranks:
        assert r["hymba"]["permutes"] > 0
        assert r["hymba"]["err"] < SERVE_TOL, r["hymba"]["err"]
        np.testing.assert_allclose(np.array(r["hymba"]["logits"]), want,
                                   rtol=0, atol=SERVE_TOL)


# ------------------------------------------------------------------ (f)
def _recorded(monkeypatch):
    """(kind, shape, dtype) of every collective ``specs`` records."""
    from repro_torch.sharding import specs
    seen, record = [], specs._record

    def log(kind, result, group):
        seen.append((kind, tuple(result.shape), result.dtype))
        return record(kind, result, group)
    monkeypatch.setattr(specs, "_record", log)
    return seen


def test_decode_records_the_merge_not_the_cache(monkeypatch):
    """Fake (1, 4): reduced qwen's decode step gathers no cache layer; its
    all-reduces are each layer's three of the merge (fp32 (B, KV, G, 1)
    twice and (B, KV, G, 1, hd)) and the vocab lookup's and each MLP's
    sum; every all-gather is a weight's or the logits'."""
    import torch.distributed as dist
    from test_torch_dryrun import _fake_group, _shapes, _tstep
    model = _tmodel(ARCH)
    cfg = model.cfg
    _, shape = _shapes("decode", S=16, B=4)
    seen = _recorded(monkeypatch)
    _fake_group(4)
    try:
        _tstep(model, shape, 1, False, _mesh((1, 4)))
    finally:
        dist.destroy_process_group()
    B, KV, hd = 4, cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    merge = [((B, KV, G, 1), torch.float32), ((B, KV, G, 1),
                                              torch.float32),
             ((B, KV, G, 1, hd), torch.float32)]
    sums = [((B, 1, cfg.d_model), torch.bfloat16)]
    want = sums + (merge + sums) * cfg.num_layers
    assert [(s, d) for k, s, d in seen if k == "all-reduce"] == want
    weights = {tuple(t.shape[1:]) for t in _leaves(model.init(
        torch.Generator(), "meta")["layers"])}
    for kind, s, _ in seen:
        if kind == "all-gather":
            assert s in weights or s == (B, 1, cfg.padded_vocab), s
            assert s != (B, shape.seq_len, KV, hd)


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def test_run_cell_records_the_merge(monkeypatch):
    """``dryrun.run_cell`` on a fake (1, 4) mesh records the decode
    step's merge and its layer probe's."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import reduced_config
    real = configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config",
                        lambda n: reduced_config(real(n)))
    monkeypatch.setattr(dryrun.configs, "get_shape",
                        lambda n: configs.ShapeConfig(n, 16, 4, "decode"))
    rec = dryrun.run_cell(ARCH, "t", mesh_shape=(1, 4), hbm_budget_gib=1,
                          verbose=False)
    cfg = reduced_config(real(ARCH))
    B, KV, hd, D = 4, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    G = cfg.num_heads // KV
    merge = 4 * (2 * B * KV * G + B * KV * G * hd)
    mlp = 2 * B * D
    assert rec["gate"]["collectives"]["all-reduce"] == \
        mlp + cfg.num_layers * (merge + mlp)
    (probe,) = rec["probes"]
    assert probe["collectives"]["all-reduce"] == merge + mlp


def test_cp_prefill_layer_is_a_quarter_of_the_flops():
    """Fake (1, 4), reduced qwen (heads whole): a layer's dot FLOPs per
    rank (the step at 2 layers less the step at 1) times 4 equal the
    mesh-free layer's, exactly."""
    import torch.distributed as dist
    from test_torch_dryrun import _fake_group, _shapes, _tstep
    _, shape = _shapes("prefill", S=16, B=4)

    def layer(mesh_fn):
        flops = []
        for n in (2, 1):
            mesh = None
            if mesh_fn:
                _fake_group(4)
                mesh = _mesh((1, 4))
            try:
                flops.append(int(_tstep(_tmodel(ARCH, num_layers=n), shape,
                                        1, False, mesh)[0]["dot_flops"]))
            finally:
                if mesh_fn:
                    dist.destroy_process_group()
        return flops[0] - flops[1]
    free, per_rank = layer(False), layer(True)
    assert per_rank > 0 and 4 * per_rank == free, (per_rank, free)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
