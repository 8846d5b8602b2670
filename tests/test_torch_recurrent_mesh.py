"""The recurrent families over the ("data", "model") mesh in the port
(``sharding.spmd``'s rwkv6 heads and d_ff, hymba's channels and MLP over
"model"; ``models.ssm`` / ``models.hybrid``) against mesh-free runs and
``repro``:

* (a) reduced rwkv6-7b (4 heads of 16, d_ff 128: the heads divide
  "model") and reduced hymba-1.5b (4 heads over 1 kv head, so its
  attention stays whole and runs the rank's query rows; 64 channels,
  window 8), 2 layers each, at (1, 2), (2, 2) and (1, 4) on a batch of
  4 x 32 (the rows divide "model"): the forward's logits of every row
  and the sharded prefill's within ``SERVE_TOL`` of mesh-free and of
  ``repro``'s jitted forward and prefill; 3 fp32 train steps' losses
  within ``LOSS_TOL`` of both; the step-1 gradient blocks in float64
  (``launch.witness``; ``repro`` with x64) within ``GRAD_TOL`` of both,
  and in fp32 about as far from float64's as mesh-free's fp32 ones are
  (``_training_held``: at 2 layers the reduced rwkv6's fp32 gradients,
  mesh-free's and ``repro``'s alike, sit some 5e-5 of a leaf's largest
  from float64's, so GRAD_TOL between two fp32 sum orders would hold
  the rounding, not the layout), every leaf that a split compute reads
  in part named; three lockstep decode steps after the prefill within
  ``SERVE_TOL`` of both, tokens equal; each rank runs the scans on its
  H / M heads or D / M channels, holds that block of the state, and
  builds no ``GatheredStack``;
* (b) rows that do not divide "model" (4 x 33 at (1, 2)): the residual
  stays replicated over "model" and every result is held against
  mesh-free as in (a); hymba with 4 heads over 2 kv heads at (1, 2) puts
  its attention's heads over "model" too and is held so too;
* (c) on a fake (2, 4) mesh each recurrent layer's probe counts its
  split products at an eighth of the mesh-free layer's dot FLOPs (the
  rows over "data", the heads or channels over "model"), and gathers no
  weight over "model" but hymba's attention's; ``tp_keeps`` by case.

The weights are the port's seed-0 init with seeded noise on the leaves
that init leaves constant (``NOISE``), so that every gradient named is
nonzero. The ranks are two spawns of this file run as a script (2 and 4
gloo ranks, ``python tests/test_torch_recurrent_mesh.py RANK WORLD
DIR``), started together when the first test asks; each writes
rank<R>.json and its step-1 gradient blocks. ``repro``'s results are
computed in the test process meanwhile, on the same weights (bridged)
and inputs."""
import contextlib
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
# the fp32 step-1 gradients' distance from float64's, sharded against
# mesh-free (``_training_held``)
FP32_SPREAD = 2
STEPS = 3
BATCH = (4, 32)                 # 32 rows divide 2 and 4 "model" ranks
ODD_BATCH = (4, 33)             # 33 rows: the residual stays replicated
PROMPT, S_MAX, DECODE_STEPS = 8, 16, 3
ARCHS = {"rwkv6": "rwkv6-7b", "hymba": "hymba-1.5b"}
# (arch, config overrides) of each model the ranks run, each at the
# reduced config's 2 layers; hymba with 4 heads over 2 kv heads also puts
# its attention's heads over "model" at (1, 2) (the decode's ring holds
# the rank's kv heads)
MODELS = {"rwkv6": ("rwkv6", {}), "hymba": ("hymba", {}),
          "hymba-heads": ("hymba", {"num_kv_heads": 2})}
MESHES = ((1, 2), (2, 2), (1, 4))
# seeded N(0, 1) noise times these on the leaves init leaves constant (the
# channel mix's token shift reads the previous rank's row only where cmu_k
# and cmu_r are not zero)
NOISE = {"rwkv6": {"u": 0.1, "mu": 0.1, "mu_x": 0.1, "lora_B": 0.01,
                   "wB": 0.01, "cmu_k": 0.1, "cmu_r": 0.1},
         "hymba": {"logA": 0.5, "dt_bias": 0.5, "d_skip": 0.1}}
# the leaves a split compute reads in part, or whose gradient crosses the
# rows over "model" (whole on every rank, or the rank's part)
NAMED = {"rwkv6": ("mu_x", "mu", "lora_A", "lora_B", "w0", "wA", "wB", "u",
                   "gn_scale", "cr"),
         "hymba": ("w_B", "w_C", "w_dtA", "w_dtB", "conv", "logA")}
# (name, model, mesh, batch)
CASES = tuple((f"{m} {s}", m, s, BATCH) for m in ARCHS for s in MESHES) \
    + tuple((f"{m} replicated (1, 2)", m, (1, 2), ODD_BATCH) for m in ARCHS) \
    + (("hymba-heads (1, 2)", "hymba-heads", (1, 2), BATCH),)
MAIN = [c[0] for c in CASES if c[3] == BATCH and c[1] in ARCHS]


def _tmodel(name):
    from repro_torch import configs
    from repro_torch.models.registry import get_model, reduced_config
    arch, over = MODELS[name]
    return get_model(reduced_config(configs.get_config(ARCHS[arch]),
                                    **over))


def _noisy(name, params):
    """``params`` (the port's init) with ``NOISE[name]`` added in place."""
    rng = np.random.default_rng(7)
    for key, scale in NOISE[MODELS[name][0]].items():
        leaf = params["layers"][key]
        leaf.add_(torch.from_numpy(
            (scale * rng.standard_normal(leaf.shape)).astype(np.float32)))
    return params


def _init(name, model, opt):
    from repro_torch.launch import steps
    state = steps.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0), "cpu")
    _noisy(name, state["params"])
    return state


def _batch(vocab, shape):
    toks = np.random.default_rng(1).integers(0, vocab, shape)
    return toks, np.roll(toks, -1, 1)


def _mesh(shape):
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.make_mesh(shape, ("data", "model"), "cpu")


def _max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


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
class _Scans:
    """The (B, T, heads or channels) of every plain scan called while
    active (the CPU's K5 / K6), and how many ``GatheredStack``s were
    built."""

    def __enter__(self):
        from repro_torch.kernels import ref
        from repro_torch.sharding import spmd
        self.shapes, self.stacks = [], 0
        self._saved = (ref.wkv6, ref.selective_scan, spmd.GatheredStack)
        wkv, sscan, stack = self._saved

        def wkv6(r, *a):
            self.shapes.append(list(r.shape[:3]))
            return wkv(r, *a)

        def selective_scan(x, *a):
            self.shapes.append(list(x.shape))
            return sscan(x, *a)

        outer = self

        class Stack(stack):
            def __init__(self, *a):
                outer.stacks += 1
                super().__init__(*a)
        ref.wkv6, ref.selective_scan, spmd.GatheredStack = \
            wkv6, selective_scan, Stack
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        from repro_torch.sharding import spmd
        ref.wkv6, ref.selective_scan, spmd.GatheredStack = self._saved


def _sharded_forward(model, params, tokens):
    """Every row's logits of the forward on the mesh of ``params``, run as
    the sharded prefill runs its rows (each rank's rows gathered)."""
    from repro_torch.launch import steps
    from repro_torch.sharding import spmd
    mesh, keeps, local, plans = steps._local_params(model, params)
    ((mb, dims),) = steps._microbatches(model, tokens, mesh, 1)
    sp = spmd.seq_split(model.cfg, mesh, tokens["tokens"].shape[1])
    with spmd.training(mesh, dims, bool(keeps), sp=sp):
        logits, _ = model.forward(spmd.lazy_params(local, plans, mesh, dims),
                                  mb["tokens"], compute_dtype=torch.float32)
        return spmd.gather_rows(logits)


def _free(name, batch_shape):
    """The mesh-free run of a model on a batch."""
    from repro_torch.launch import steps, witness
    from repro_torch.optim.adamw import AdamW
    model = _tmodel(name)
    opt = AdamW(learning_rate=1e-3)
    toks, labels = _batch(model.cfg.vocab_size, batch_shape)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    full = _init(name, model, opt)
    loss_fn = steps.make_loss_fn(model, compute_dtype=torch.float32,
                                 remat=False)
    _, grads = steps.value_and_grad(loss_fn)(full["params"], batch)
    with witness.float64():
        params64 = witness.to_float64(full["params"])
        loss64 = steps.make_loss_fn(model, compute_dtype=torch.float64,
                                    remat=False)
        _, grads64 = steps.value_and_grad(loss64)(params64, batch)
    step = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                 remat=False)
    state, losses = full, []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    f32 = dict(compute_dtype=torch.float32)
    logits, _ = model.forward(full["params"], batch["tokens"], **f32)
    prefill = steps.make_prefill(model, **f32)(full["params"],
                                               {"tokens": batch["tokens"]})
    prompt = {"tokens": batch["tokens"][:, :PROMPT]}
    _, cache = steps.make_prefill(model, return_cache=True, s_max=S_MAX,
                                  **f32)(full["params"], prompt)
    return {"model": model, "opt": opt, "batch": batch, "full": full,
            "loss_fn": loss_fn, "grads": grads, "losses": losses,
            "params64": params64, "loss64": loss64, "grads64": grads64,
            "logits": logits, "prefill": prefill, "cache": cache}


def _decode(model, params, cache, first, place=lambda b: b, sharded=False):
    from repro_torch.launch import steps
    decode = steps.make_decode_step(model, compute_dtype=torch.float32,
                                    sharded=sharded)
    tok, logits, toks = first, [], []
    for _ in range(DECODE_STEPS):
        out, cache = decode(params, cache, place({"token": tok}))
        logits.append(out)
        tok = out[:, -1].argmax(-1, keepdim=True).int()
        toks.append(tok[:, 0].tolist())
    return logits, toks, cache


def _case(case, free, out_dir):
    """A case on its mesh against mesh-free: the step-1 gradients (the
    rank's blocks to a file, each beside its elements' flat indices), 3
    steps' losses, the forward, the sharded prefill and the lockstep
    decode, with the scans' shapes and the state's blocks."""
    import torch.distributed as dist
    from repro_torch.launch import steps, witness
    from repro_torch.sharding import specs, spmd
    from repro_torch.tree import tree_map
    name, arch, shape, _ = case
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
    with _Scans() as train_scans:
        _, got = steps.sharded_value_and_grad(model, free["loss_fn"])(
            placed["params"], pbatch)
    with witness.float64():
        with specs.use_mesh(mesh):
            placed64 = steps.place(free["params64"], sh["params"])
        _, got64 = steps.sharded_value_and_grad(model, free["loss64"])(
            placed64, pbatch)
    errs, blocks = {}, {}
    for n, ((path, g), (_, g64), whole64, free32, s) in enumerate(zip(
            _named(got), _named(got64),
            *[[w for _, w in _named(t)] for t in (
                free["grads64"], free["grads"], sh["params"])])):
        want64 = specs.local_block(whole64, s)
        big = max(float(want64.abs().max()), 1e-300)
        errs[path] = {
            "float64": _max_diff(g64, want64) / big,
            "fp32": _max_diff(g, want64) / big,
            "fp32_free": _max_diff(specs.local_block(free32, s),
                                   want64) / big}
        blocks[f"g{n}"] = g.numpy()
        blocks[f"d{n}"] = g64.numpy()
        blocks[f"i{n}"] = specs.local_block(
            torch.arange(whole64.numel()).reshape(whole64.shape), s).numpy()
    np.savez(_grads_file(out_dir, name, dist.get_rank()), **blocks)
    step = steps.make_train_step(model, free["opt"],
                                 compute_dtype=torch.float32, remat=False)
    state, losses = placed, []
    for _ in range(STEPS):
        state, m = step(state, pbatch)
        losses.append(float(m["loss"]))
    tokens = place({"tokens": batch["tokens"]})
    logits = _sharded_forward(model, placed["params"], tokens)
    prefill = steps.make_prefill(model, compute_dtype=torch.float32,
                                 sharded=True)(placed["params"], tokens)
    first = batch["tokens"][:, PROMPT - 1:PROMPT].int()
    want_dec, want_toks, _ = _decode(model, full["params"],
                                     tree_map(torch.clone, free["cache"]),
                                     first)
    with _Scans() as dec_scans:
        dec, toks, cache = _decode(model, placed["params"], cache, first,
                                   place, sharded=True)
    state_key = "S" if arch == "rwkv6" else "h"
    p = placed["params"]["layers"]
    return {"keeps": sorted(spmd.tp_keeps(model.cfg, mesh)),
            "sp": spmd.seq_split(model.cfg, mesh, batch["tokens"].shape[1]),
            "grad_err": errs, "losses": losses, "ref_losses": free["losses"],
            "logits": logits.tolist(),
            "logits_err": _max_diff(logits, free["logits"]),
            "prefill": prefill.tolist(),
            "prefill_err": _max_diff(prefill, free["prefill"]),
            "decode_err": max(_max_diff(a, b)
                              for a, b in zip(dec, want_dec)),
            "decode_logits": [d.tolist() for d in dec],
            "tokens": toks, "ref_tokens": want_toks,
            "train_scans": train_scans.shapes,
            "decode_scans": dec_scans.shapes,
            "stacks": dec_scans.stacks,
            "state_block": list(cache[state_key].to_local().shape),
            "ring_kv": (cache["k"].to_local().shape[3] if "k" in cache
                        else None),
            "split_block": list((p["wr"] if arch == "rwkv6"
                                 else p["w_in"]).to_local().shape)}


def _rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    frees, out = {}, {}
    for case in CASES:
        name, arch, shape, batch = case
        if int(np.prod(shape)) != world:
            continue
        if (arch, batch) not in frees:
            frees[(arch, batch)] = _free(arch, batch)
        out[name] = _case(case, frees[(arch, batch)], out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from test_torch_sharding import start_ranks, wait_ranks
    dirs = {world: tmp_path_factory.mktemp(f"rec{world}") for world in (2, 4)}
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


@contextlib.contextmanager
def _jax_float64():
    """``witness.float64`` for ``repro``: x64 on, ``jnp.float32`` naming
    float64, so its fp32 upcasts run in float64 too."""
    import jax
    import jax.numpy as jnp
    saved = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = saved


def _ref(name, shape):
    """``repro`` on the ranks' weights (bridged) and batch: the jitted
    fp32 forward's and prefill's logits, 3 jitted fp32 train steps'
    losses, the step-1 gradients in float64 (``_jax_float64``; flat, in
    ``tree_leaves`` order), and the greedy lockstep decode's logits and
    tokens after the prompt's prefill, fp32."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models.registry import get_model, reduced_config
    from repro.optim.adamw import AdamW as JAdamW
    from repro_torch import bridge
    from repro_torch.optim.adamw import AdamW
    model = _tmodel(name)
    weights = bridge.to_numpy(_init(name, model, AdamW(learning_rate=1e-3))
                              ["params"])
    params = jax.tree.map(jnp.asarray, weights)
    arch, over = MODELS[name]
    jmodel = get_model(reduced_config(jconfigs.get_config(ARCHS[arch]),
                                      **over))
    toks, labels = _batch(model.cfg.vocab_size, shape)
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    f32 = dict(compute_dtype=jnp.float32)
    forward = jax.jit(lambda p, t: jmodel.forward(p, t, **f32)[0])
    prefill = jax.jit(jsteps.make_prefill(jmodel, **f32))
    out = {"forward": np.asarray(forward(params, batch["tokens"])),
           "prefill": np.asarray(prefill(params,
                                         {"tokens": batch["tokens"]}))}
    opt = JAdamW(learning_rate=1e-3)
    step = jax.jit(jsteps.make_train_step(jmodel, opt, remat=False, **f32))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    out["losses"] = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        out["losses"].append(float(m["loss"]))
    with _jax_float64():
        loss_fn = jsteps.make_loss_fn(jmodel, compute_dtype=jnp.float64,
                                      remat=False)
        grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch)[0]))(
            jax.tree.map(lambda w: jnp.asarray(w, jnp.float64), weights))
        out["grads64"] = [np.asarray(g).ravel()
                          for g in jax.tree.leaves(grads)]
    _, cache = jax.jit(jsteps.make_prefill(
        jmodel, return_cache=True, s_max=S_MAX, **f32))(
            params, {"tokens": batch["tokens"][:, :PROMPT]})
    decode = jax.jit(jsteps.make_decode_step(jmodel, **f32))
    tok, out["decode"], out["tokens"] = (batch["tokens"][:, PROMPT - 1:PROMPT],
                                         [], [])
    for _ in range(DECODE_STEPS):
        logits, cache = decode(params, cache, {"token": tok})
        out["decode"].append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
        out["tokens"].append(np.asarray(tok[:, 0]).tolist())
    return out


@pytest.fixture(scope="module")
def reference():
    """``reference(name, shape)``: ``repro``'s results for a model on a
    batch, computed once when first asked (after the ranks were started,
    so both run together)."""
    done = {}

    def get(name, shape):
        if (name, shape) not in done:
            done[name, shape] = _ref(name, shape)
        return done[name, shape]
    return get


def _ranks(spawned, name):
    case = next(c for c in CASES if c[0] == name)
    return case, spawned(int(np.prod(case[2])))


def _prefill_held(ranks, name, want=None):
    """Every rank's forward (every row) and sharded prefill within
    SERVE_TOL of mesh-free's and of ``repro``'s (``want``, where given)."""
    for r in ranks:
        got = r[name]
        assert got["logits_err"] < SERVE_TOL, got["logits_err"]
        assert got["prefill_err"] < SERVE_TOL, got["prefill_err"]
        if want is not None:
            for key, ref in (("logits", "forward"), ("prefill", "prefill")):
                np.testing.assert_allclose(np.array(got[key]), want[ref],
                                           rtol=0, atol=SERVE_TOL)


def _decode_held(ranks, name, want=None):
    """Every rank's lockstep decode within SERVE_TOL of mesh-free's and of
    ``repro``'s (``want``, where given), its tokens equal to both."""
    for r in ranks:
        got = r[name]
        assert got["decode_err"] < SERVE_TOL, got["decode_err"]
        assert got["tokens"] == got["ref_tokens"]
        if want is not None:
            np.testing.assert_allclose(np.array(got["decode_logits"]),
                                       np.array(want["decode"]), rtol=0,
                                       atol=SERVE_TOL)
            assert got["tokens"] == want["tokens"]


def _training_held(spawned, ranks, name, want=None):
    """Every rank's 3 fp32 losses within LOSS_TOL of mesh-free's and of
    ``repro``'s (``want``, where given); its step-1 gradient blocks, each
    relative to the largest magnitude of the float64 mesh-free block: in
    float64 (``witness.float64``) within GRAD_TOL of mesh-free's and of
    ``repro``'s float64 blocks, and in fp32 no farther from float64's
    than GRAD_TOL or FP32_SPREAD times the mesh-free fp32 gradients'
    distance from it, whichever is larger."""
    world = len(ranks)
    for rank, r in enumerate(ranks):
        got = r[name]
        assert got["losses"] == ranks[0][name]["losses"]
        for ref in (got["ref_losses"],) + (
                () if want is None else (want["losses"],)):
            np.testing.assert_allclose(got["losses"], ref, rtol=0,
                                       atol=LOSS_TOL)
        err = {key: max(e[key] for e in got["grad_err"].values())
               for key in ("float64", "fp32", "fp32_free")}
        assert err["float64"] < GRAD_TOL, got["grad_err"]
        assert err["fp32"] <= max(GRAD_TOL, FP32_SPREAD * err["fp32_free"]), \
            err
        if want is None:
            continue
        blocks = np.load(_grads_file(spawned.dirs[world], name, rank))
        assert len(blocks.files) == 3 * len(want["grads64"])
        for n, flat in enumerate(want["grads64"]):
            w = flat[blocks[f"i{n}"]]
            e = np.abs(blocks[f"d{n}"] - w).max() / max(np.abs(w).max(),
                                                         1e-300)
            assert e < GRAD_TOL, (n, e)


@pytest.mark.parametrize("name", MAIN)
def test_forward_and_prefill_equal_mesh_free_and_the_reference(
        spawned, reference, name):
    case, ranks = _ranks(spawned, name)
    assert all(r[name]["sp"] for r in ranks)
    _prefill_held(ranks, name, reference(case[1], case[3]))


@pytest.mark.parametrize("name", MAIN)
def test_training_equals_mesh_free(spawned, reference, name):
    """``_training_held``, with the leaves of ``NAMED`` among the checked
    ones, each nonzero (so its bound is not met by zeros)."""
    case, ranks = _ranks(spawned, name)
    arch = case[1]
    _training_held(spawned, ranks, name, reference(arch, case[3]))
    paths = list(ranks[0][name]["grad_err"])
    named = {k.split("/")[-1] for k in paths if k.startswith("layers/")}
    assert set(NAMED[arch]) <= named, sorted(named)
    blocks = [np.load(_grads_file(spawned.dirs[len(ranks)], name, rank))
              for rank in range(len(ranks))]
    for leaf in NAMED[arch]:
        n = paths.index(f"layers/{leaf}")
        for kind in "gd":       # fp32 and float64
            assert max(np.abs(b[f"{kind}{n}"]).max() for b in blocks) > 0, \
                leaf


@pytest.mark.parametrize("name", MAIN)
def test_lockstep_decode_equals_mesh_free(spawned, reference, name):
    case, ranks = _ranks(spawned, name)
    _decode_held(ranks, name, reference(case[1], case[3]))


@pytest.mark.parametrize("name", MAIN)
def test_rank_runs_its_heads_or_channels(spawned, name):
    """rwkv6 keeps "heads", "d_ff" and "vocab", hymba "d_ff" and "vocab"
    (its 4 heads over 1 kv head do not divide "model"); every scan of the
    train step and of the decode runs on the rank's H / M heads or D / M
    channels; the decode's state leaf is the rank's block of them and no
    cache leaf is gathered (``GatheredStack``)."""
    case, ranks = _ranks(spawned, name)
    _, arch, (data, ways), (B, S) = case
    cfg = _tmodel(arch).cfg
    width = cfg.num_heads if arch == "rwkv6" else cfg.d_model
    rows = B // data
    for r in ranks:
        got = r[name]
        assert got["keeps"] == (["d_ff", "heads", "vocab"] if arch == "rwkv6"
                                else ["d_ff", "vocab"])
        assert got["train_scans"] == [[rows, S, width // ways]] \
            * cfg.num_layers, got["train_scans"]
        assert got["decode_scans"] == [[rows, 1, width // ways]] \
            * (cfg.num_layers * DECODE_STEPS), got["decode_scans"]
        assert got["stacks"] == 0
        assert got["state_block"][2] == width // ways
        assert got["split_block"][-1] == cfg.d_model // ways


def test_hymba_heads_over_model(spawned):
    """hymba with 4 heads over 2 kv heads at (1, 2): its attention's heads
    go over "model" too (sequence-parallel rows; the decode's ring holds
    the rank's kv head), and the forward, prefill, decode, losses and
    gradients are held against mesh-free as the main cases' are."""
    name = "hymba-heads (1, 2)"
    _, ranks = _ranks(spawned, name)
    for r in ranks:
        got = r[name]
        assert got["keeps"] == ["d_ff", "heads", "kv_heads", "vocab"]
        assert got["sp"] and got["ring_kv"] == 1 and got["stacks"] == 0
    _prefill_held(ranks, name)
    _decode_held(ranks, name)
    _training_held(spawned, ranks, name)


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[3] != BATCH])
def test_replicated_rows_are_exact(spawned, name):
    """Rows that do not divide "model": the residual stays replicated over
    it (the split products entered through ``tp_copy`` and summed by
    ``tp_sum``), the scans still run on the rank's slab, and the forward,
    prefill, decode, losses and gradients are held against mesh-free as
    the main cases' are."""
    case, ranks = _ranks(spawned, name)
    _, arch, (_, ways), (B, S) = case
    cfg = _tmodel(arch).cfg
    width = cfg.num_heads if arch == "rwkv6" else cfg.d_model
    for r in ranks:
        got = r[name]
        assert not got["sp"]
        assert got["train_scans"] == [[B, S, width // ways]] * cfg.num_layers
    _prefill_held(ranks, name)
    _decode_held(ranks, name)
    _training_held(spawned, ranks, name)


def test_float64_witness_runs_fp32_upcasts_in_float64_and_restores():
    """``witness.float64`` makes ``Tensor.float`` and ``torch.float32``
    float64 while active, and restores both on exit, an exception's too;
    ``to_float64`` leaves integer leaves as they are."""
    from repro_torch.launch import witness
    x = torch.ones(2, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        with witness.float64():
            assert x.float().dtype == torch.float64
            assert torch.zeros(1, dtype=torch.float32).dtype == torch.float64
            raise RuntimeError
    assert x.float().dtype == torch.float32 != torch.float64
    tree = witness.to_float64({"w": x, "n": {"i": torch.zeros(1, dtype=
                                                             torch.int32)}})
    assert (tree["w"].dtype, tree["n"]["i"].dtype) == (torch.float64,
                                                       torch.int32)


# ------------------------------------------------------------------ (c)
def _fake_group(world):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@pytest.mark.parametrize("name", list(ARCHS))
def test_fake_mesh_probe_counts_the_ranks_slab(monkeypatch, name):
    """Fake (2, 4), a prefill of 4 x 64: the layer probe's dot FLOPs a
    rank, times 8, are the mesh-free layer's plus three times what runs
    whole on every "model" rank's rows of the sequence (rwkv6's DDLerp and
    decay LoRAs: a half, not an eighth; hymba runs nothing whole); the
    only weights gathered over "model" are hymba's attention's (wr, ck,
    w_in, the MLP and the rest stay the rank's blocks); the rows are
    gathered and reduce-scattered over "model", and hymba's mamba
    products summed there."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.launch import dryrun, hlo_stats, probes
    from repro_torch.models import hybrid, ssm
    from repro_torch.sharding import specs
    model = _tmodel(name)
    cfg = model.cfg
    B, S = 4, 64
    shape = configs.ShapeConfig("t", S, B, "prefill")
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
    T, D = B * S, cfg.d_model
    whole = (2 * 2 * T * D * ssm.LORA_R * 5 + 2 * 2 * T * D * ssm.DECAY_R
             if name == "rwkv6" else 0)
    assert 8 * int(cost["dot_flops"]) == free + 3 * whole, (cost, free)
    assert any(kind == "all-gather" for kind, _, _ in seen)
    # 2-D all-gathers over "model": hymba's wq, wk, wv and wo only (its
    # heads stay whole); none of wr, ck, cv, w_in, w_out, conv or the MLP
    weights = [s for kind, s, group in seen
               if kind == "all-gather" and group == 4 and len(s) == 2]
    assert len(weights) == (4 if name == "hymba" else 0), weights
    # the rows over "model": a data rank's 2 rows of 64 gathered before
    # the split products, their sums scattered onto the rank's 16
    # (recorded with the scattered dim first); and hymba's w_dtA / w_B /
    # w_C products summed in one all-reduce
    over_model = {(kind, s) for kind, s, group in seen if group == 4}
    assert ("all-gather", (2, S, D)) in over_model, over_model
    assert ("reduce-scatter", (S // 4, 2, D)) in over_model, over_model
    sums = ("all-reduce", (2, S, hybrid.DT_RANK + 2 * cfg.ssm_state))
    assert (sums in over_model) == (name == "hymba"), over_model


def test_keeps_by_case():
    """``tp_keeps`` on a fake (2, 4) mesh: rwkv6 keeps its heads where they
    divide "model"; hymba its heads and kv heads only where both do."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.sharding import spmd
    _fake_group(8)
    try:
        mesh = _mesh((2, 4))
        keeps = {n: spmd.tp_keeps(cfg, mesh) for n, cfg in (
            ("rwkv6", configs.get_config(ARCHS["rwkv6"])),
            ("rwkv6 reduced", _tmodel("rwkv6").cfg),
            ("rwkv6 2 heads", dataclasses.replace(_tmodel("rwkv6").cfg,
                                                  num_heads=2,
                                                  head_dim=32)),
            ("hymba", configs.get_config(ARCHS["hymba"])),
            ("hymba reduced", _tmodel("hymba").cfg),
            ("hymba 4 over 4", dataclasses.replace(_tmodel("hymba").cfg,
                                                   num_kv_heads=4)))}
    finally:
        dist.destroy_process_group()
    both = {"d_ff", "vocab"}
    assert keeps == {"rwkv6": both | {"heads"},
                     "rwkv6 reduced": both | {"heads"},
                     "rwkv6 2 heads": both,
                     "hymba": both, "hymba reduced": both,
                     "hymba 4 over 4": both | {"heads", "kv_heads"}}


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
