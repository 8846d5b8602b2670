"""Tensor-parallel serving in the port, held to the reference's contract
(``tests/test_tp.py``) on ``repro``'s workload: prompts of 19, 35 and 7
tokens, 2 slots, s_max 64, pages of 16, the reference's head overrides.

* tp = 1, a one-rank mesh made in this process from an in-process store,
  equals the mesh-free port, which equals ``repro``'s mesh-free engine,
  in tokens (and the port's two in every logit), for dense, MoE and VLM.
* tp = 2 and tp = 4 equal tp = 1 in tokens and in every step's logits, bit
  for bit, for dense, MoE and VLM, on the einsum anchor (page_size ==
  s_max), with prefix caching and copy-on-write (on the kernel path and on
  the transient path, whose prefix seed all-gathers the slabs), for latent
  pages (the pool whole on every rank), for whisper (the transient prefill
  spliced slab by slab) and hymba's paged ring; every rank serves the same
  tokens. Per-rank KV bytes are the global bytes / tp (latent: equal).
* int8 pages: a rank's (P, 1) scale column and its slab of the pages
  equal ``repro``'s ``_requant_page(..., groups=tp)``,
  ``paged_append_row_q8`` and ``paged_splice_chunk_q8`` on (P, tp)
  scales, bit for bit; tp = 2 and 4 serve what one engine with (L, P, tp)
  scale groups serves, bit for bit; tp = 2 streams keep a mean greedy
  prefix match of at least 0.6 against tp = 1 (the reference's gate).
* A head slab of the paged kernels' plain versions (K1, K3, K4, decode and
  prefill) through the head-sharded wrappers equals the same heads of the
  whole call, bit for bit; on the card (``gpu``) the kernels do with the
  whole call's plan, and a one-rank NCCL engine serves the mesh-free
  engine's stream.
* The reference's build validation errors, in this process.

The multi-rank cases are two spawns (2 and 4 ranks) of this file run as a
script: gloo over a file store, torch only (no jax), one thread per rank,
each rank running every case and reporting to the test process."""
import dataclasses
import datetime
import json
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PS, S_MAX, GEN, SLOTS = 16, 64, 8, 2
TIMEOUT = 240
# reduced configs collapse qwen's and the VLM's kv heads to 1: the tp
# engines override the head counts, as the reference's tests do
FAMILIES = {
    "dense": ("qwen2.5-32b", dict(num_heads=8, num_kv_heads=4)),
    "moe": ("moonshot-v1-16b-a3b", None),
    "vlm": ("llama-3.2-vision-11b", dict(num_heads=8, num_kv_heads=4)),
}
# other caches and families, served at every spawn's tp: (arch,
# overrides, ServeConfig fields)
OTHERS = {
    "anchor": ("qwen2.5-32b", FAMILIES["dense"][1], dict(page_size=S_MAX)),
    "latent": ("qwen2.5-32b-mla", None, dict(kv_backend="paged_latent")),
    "encdec": ("whisper-large-v3", None, {}),
    "hybrid": ("hymba-1.5b", dict(num_kv_heads=2), dict(page_size=4)),
}


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 400, n).astype(np.int32) for n in (19, 35, 7)]


def match_frac(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n / max(len(a), len(b), 1)


# ------------------------------------------------------------- the ranks
def _record(engine):
    """Keep the logits of every step the engine takes."""
    seen = []
    for name in ("_decode", "_chunk_paged", "_chunk_first", "_chunk_cont"):
        fn = getattr(engine, name)

        def wrapped(*args, _fn=fn, **kwargs):
            out = _fn(*args, **kwargs)
            seen.append(out[0].clone())
            return out
        setattr(engine, name, wrapped)
    return seen


def _serve(arch, overrides, tp, prompts=None, sequential=False, **fields):
    from repro_torch.serve import ServeConfig, ServeEngine
    config = dict(batch_slots=SLOTS, s_max=S_MAX, page_size=PS,
                  cfg_overrides=overrides, tp=tp, device="cpu")
    config.update(fields)
    eng = ServeEngine.build(arch, config=ServeConfig(**config))
    logits = _record(eng)
    reqs = []
    for p in prompts if prompts is not None else _prompts():
        reqs.append(eng.submit(p, GEN))
        if sequential:
            eng.run()
    eng.run()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert eng.prefill_failures == 0
    return eng, [list(map(int, r.tokens)) for r in reqs], logits


def _bitwise(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _against_tp1(tp, run):
    """Serve with ``run(tp)`` at tp = 1 and at ``tp``: tokens, whether every
    step's logits are equal, the per-rank and global KV bytes."""
    e1, t1, l1 = run(1)
    e, t, lg = run(tp)
    return {"tokens": t, "tokens1": t1, "logits_equal": _bitwise(lg, l1),
            "steps": len(lg), "bytes": e.per_shard_kv_bytes(),
            "bytes1": e1.per_shard_kv_bytes(),
            "global": e.resident_cache_bytes(),
            "global1": e1.resident_cache_bytes(),
            "shapes": {k: list(v.shape) for k, v in e.cache.items()}}


def _prefix_case(tp, impl):
    """Requests sharing a two-page header, served one after the other so
    each later one hits the index: two full pages aliased, then a 20-token
    prompt whose partial last page the next prompt copies on write;
    mesh-free and at ``tp``."""
    header = np.arange(1, 33, dtype=np.int32)
    prompts = [np.concatenate([header, np.full(5, 7, np.int32)]),
               np.concatenate([header, np.full(9, 11, np.int32)]),
               header[:20],
               np.concatenate([header[:20], np.full(3, 5, np.int32)])]
    arch, ov = FAMILIES["dense"]
    out = {}
    for key, t in (("base", None), ("tp", tp)):
        e, toks, lg = _serve(arch, ov, t, prompts, sequential=True,
                             prefix_cache=True, paged_attn_impl=impl)
        m = e.metrics.summary()["prefix"]
        out[key] = dict(tokens=toks, logits=lg, pages=len(
            e.prefix_index.pages), hits=m["hits"], cow=m["cow_copies"])
    b, t = out["base"], out["tp"]
    return {"tokens": t["tokens"], "tokens1": b["tokens"],
            "logits_equal": _bitwise(t["logits"], b["logits"]),
            "counters": [t["pages"], t["hits"], t["cow"]],
            "counters1": [b["pages"], b["hits"], b["cow"]]}


def _int8_case(tp, family):
    arch, ov = FAMILIES[family]
    e1, t1, _ = _serve(arch, ov, 1, _prompts(3), kv_backend="paged_int8")
    e, t, _ = _serve(arch, ov, tp, _prompts(3), kv_backend="paged_int8")
    e.assert_page_invariants()
    fr = [match_frac(a, b) for a, b in zip(t, t1)]
    return {"tokens": t, "match": sum(fr) / len(fr),
            "scale": list(e.cache["k_scale"].shape),
            "bytes": e.per_shard_kv_bytes(),
            "global": e.resident_cache_bytes(),
            "global1": e1.resident_cache_bytes()}


def _int8_groups_case(tp):
    """Int8 pages at ``tp`` against ONE engine whose scale leaves hold the
    reference's (L, P, tp) groups, both on the masked-einsum read path
    (which takes any number of groups), with the prefix cache hitting
    full and partial pages: the rank-local scale columns serve what the
    grouped layout serves, tokens and logits bit for bit."""
    from repro_torch.serve import ServeConfig, ServeEngine
    arch, ov = FAMILIES["dense"]
    header = np.arange(1, 33, dtype=np.int32)
    prompts = _prompts(3) + [
        np.concatenate([header, np.full(5, 7, np.int32)]),
        np.concatenate([header, np.full(9, 11, np.int32)]), header[:20],
        np.concatenate([header[:20], np.full(3, 5, np.int32)])]
    fields = dict(kv_backend="paged_int8", paged_attn_impl="einsum",
                  prefix_cache=True)
    e, t, lg = _serve(arch, ov, tp, prompts, sequential=True, **fields)
    g = ServeEngine(e.model, e.params, **ServeConfig(
        batch_slots=SLOTS, s_max=S_MAX, page_size=PS, device="cpu",
        **fields).engine_kwargs())
    for key in ("k_scale", "v_scale"):
        g.cache[key] = torch.ones(tuple(g.cache[key].shape[:2]) + (tp,))
    seen = _record(g)
    reqs = []
    for p in prompts:
        reqs.append(g.submit(p, GEN))
        g.run()
    return {"tokens": t, "tokens1": [list(map(int, r.tokens)) for r in reqs],
            "logits_equal": _bitwise(lg, seen),
            "hits": e.metrics.summary()["prefix"]["hits"]}


def _rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=90))
    tp = world
    out = {}
    for fam, (arch, ov) in FAMILIES.items():
        out[fam] = _against_tp1(tp, lambda t: _serve(arch, ov, t))
        if tp == 2:     # the reference's prefix gate, at the tp it names
            out[f"int8/{fam}"] = _int8_case(tp, fam)
    out["int8/groups"] = _int8_groups_case(tp)
    for name, (arch, ov, fields) in OTHERS.items():
        if name in ("encdec", "hybrid") and tp != 2:
            continue        # one tp is enough for the transient families
        out[name] = _against_tp1(
            tp, lambda t: _serve(arch, ov, t, **fields))
    if tp == 2:
        out["prefix"] = _prefix_case(tp, "kernel")
        out["prefix/einsum"] = _prefix_case(tp, "einsum")
    else:   # two tp = 2 groups in a world of 4, each serving alike
        arch, ov = FAMILIES["dense"]
        out["replicas"] = _against_tp1(2, lambda t: _serve(arch, ov, t))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """The two spawns (2 and 4 ranks), started together; the first test of
    this file asks for them, so they run while the in-process tests do."""
    from test_torch_sharding import start_ranks
    started = {}
    for world in (2, 4):
        out_dir = tmp_path_factory.mktemp(f"tp{world}")
        started[world] = (start_ranks(world, out_dir, __file__), out_dir)
    yield started
    for procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def spawned(rank_runs):
    """world -> each rank's report."""
    from test_torch_sharding import wait_ranks
    done = {}

    def get(world):
        if world not in done:
            done[world] = wait_ranks(*rank_runs[world], timeout=TIMEOUT)
        return done[world]
    return get


def _case(spawned, tp, name):
    ranks = spawned(tp)
    got = [r[name] for r in ranks]
    for r in got[1:]:
        assert r["tokens"] == got[0]["tokens"], f"ranks disagree on {name}"
    return got


# ------------------------------------------------------ in-process tests
@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank gloo group from an in-process store, as the engine makes
    it where no group exists, destroyed with the module."""
    import torch.distributed as dist
    from repro_torch.sharding import specs
    made = not dist.is_initialized()
    specs.check_serve_group(1, "cpu")
    yield specs.serve_mesh(1, "cpu")
    if made:
        dist.destroy_process_group()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp1_mesh_equals_mesh_free_and_reference(rank_runs, one_rank_mesh,
                                                family):
    """The one-rank mesh engine (the whole mesh path: the backend's place,
    the traced steps) serves the mesh-free port's tokens and logits, and
    both serve ``repro``'s mesh-free tokens on its weights."""
    import jax
    from repro.serve import ServeConfig as JConfig
    from repro.serve import ServeEngine as JEngine
    from repro_torch import bridge
    from repro_torch import configs as tconfigs
    from repro_torch.models import registry as treg
    from repro_torch.serve import ServeConfig, ServeEngine
    arch, ov = FAMILIES[family]
    ref = JEngine.build(arch, config=JConfig(
        batch_slots=SLOTS, s_max=S_MAX, page_size=PS, cfg_overrides=ov))
    jreqs = [ref.submit(p, GEN) for p in _prompts()]
    ref.run()
    cfg = treg.reduced_config(tconfigs.get_config(arch))
    cfg = dataclasses.replace(cfg, **(ov or {}))
    model = treg.get_model(cfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                      "cpu")
    kwargs = ServeConfig(batch_slots=SLOTS, s_max=S_MAX, page_size=PS,
                         device="cpu").engine_kwargs()
    streams, logits = [], []
    for mesh in (None, one_rank_mesh):
        eng = ServeEngine(model, params, mesh=mesh, **kwargs)
        seen = _record(eng)
        reqs = [eng.submit(p, GEN) for p in _prompts()]
        eng.run()
        streams.append([list(map(int, r.tokens)) for r in reqs])
        logits.append(seen)
        assert eng.tp == 1 and eng.paged_attn_impl == "kernel"
    want = [list(map(int, r.tokens)) for r in jreqs]
    assert streams[0] == want and streams[1] == want
    assert _bitwise(logits[1], logits[0])


def test_tp1_build_makes_a_one_rank_group(one_rank_mesh):
    """``ServeConfig(tp=1)`` builds and serves; its pool is whole."""
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine.build("qwen2.5-32b", config=ServeConfig(
        page_size=PS, s_max=S_MAX, tp=1, device="cpu"))
    r = eng.submit(_prompts()[0], 3)
    eng.run()
    assert len(r.tokens) == 3 and eng.mesh is not None
    assert eng.per_shard_kv_bytes() == sum(
        eng.cache[k].numel() * 4 for k in ("k", "v"))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fn", ["requant", "append", "splice"])
def test_int8_groups_equal_the_reference(fn, tp):
    """A rank's int8 writes on its kv-head slab with its (P, 1) scale
    column, concatenated over the ranks, equal ``repro``'s on the whole
    pool with (P, tp) group scales, payload and scales bit for bit."""
    import jax.numpy as jnp
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    KV, hd, ps, P, B = 8, 4, 8, 6, 3
    rng = np.random.default_rng(11 + tp)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    k = KV // tp
    slabs = [slice(r * k, (r + 1) * k) for r in range(tp)]
    if fn == "requant":
        blk = f(B, ps, KV, hd) * 3
        content = rng.random((B, ps)) < 0.7
        jq, js = jl._requant_page(jnp.asarray(blk), jnp.asarray(content), tp)
        got = [tl._requant_page(torch.from_numpy(blk[:, :, s].copy()),
                                torch.from_numpy(content)) for s in slabs]
        q = torch.cat([g[0] for g in got], dim=2)
        sc = torch.cat([g[1] for g in got], dim=1)
        assert torch.equal(q, torch.from_numpy(np.array(jq)))
        assert torch.equal(sc, torch.from_numpy(np.array(js)))
        return
    pool = np.clip(np.round(f(P, ps, KV, hd) * 40), -127, 127).astype(np.int8)
    scale = (rng.random((P, tp)) + 0.5).astype(np.float32) / 40
    bt = np.asarray([[0, 3, -1], [1, 2, 4], [-1, -1, -1]], np.int32)
    if fn == "append":
        rows = f(B, KV, hd)
        safe = np.asarray([12, 17, 0], np.int32)
        valid = np.asarray([True, True, False])
        jp, js = jl.paged_append_row_q8(
            jnp.asarray(pool), jnp.asarray(scale), jnp.asarray(rows),
            jnp.asarray(bt), jnp.asarray(safe), jnp.asarray(valid))
        call = lambda p, s, sl: tl.paged_append_row_q8(  # noqa: E731
            p, s, torch.from_numpy(rows[:, sl].copy()), torch.from_numpy(bt),
            torch.from_numpy(safe), torch.from_numpy(valid))
    else:
        C = 11
        rows = f(B, C, KV, hd)
        positions = np.asarray([np.arange(5, 5 + C)] * B, np.int32)
        jp, js = jl.paged_splice_chunk_q8(
            jnp.asarray(pool), jnp.asarray(scale), jnp.asarray(rows),
            jnp.asarray(bt), jnp.asarray(positions), 8)
        call = lambda p, s, sl: tl.paged_splice_chunk_q8(  # noqa: E731
            p, s, torch.from_numpy(rows[:, :, sl].copy()),
            torch.from_numpy(bt), torch.from_numpy(positions), 8)
    pools, scales = [], []
    for r, sl in enumerate(slabs):
        p, s = call(torch.from_numpy(pool[:, :, sl].copy()),
                    torch.from_numpy(scale[:, r:r + 1].copy()), sl)
        pools.append(p)
        scales.append(s)
    assert torch.equal(torch.cat(pools, dim=2),
                       torch.from_numpy(np.array(jp)))
    assert torch.equal(torch.cat(scales, dim=1),
                       torch.from_numpy(np.array(js)))


class _RankMesh:
    """A stand-in 1-axis "model" mesh seen from rank ``r`` of ``tp``: what
    ``specs.head_slab`` reads."""

    def __init__(self, r, tp):
        self.mesh_dim_names, self.shape, self._r = ("model",), (tp,), r

    def get_local_rank(self, axis):
        return self._r


def _paged_args(seed, B, Sq, H, KV, hd, ps=8, mps=6):
    rng = np.random.default_rng(seed)
    P = B * mps
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, hd)).astype(
        np.float32))
    pk, pv = (torch.from_numpy(rng.standard_normal((P, ps, KV, hd)).astype(
        np.float32)) for _ in range(2))
    bt = torch.from_numpy(rng.permutation(P).reshape(B, mps).astype(
        np.int32))
    bt[-1, 3:] = -1
    start = torch.tensor([40 - Sq, 17, 9][:B], dtype=torch.int32)
    return q, pk, pv, bt, start


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("kind", ["decode", "prefill", "decode_q8",
                                  "prefill_latent"])
def test_head_slabs_concatenate_to_the_whole_call(kind, tp):
    """Each rank's slab through the head-sharded wrapper (the plain
    versions here), concatenated in rank order, is the whole call."""
    from repro_torch.kernels import paged_attention as pa
    Sq = 1 if kind.startswith("decode") else 5
    if kind == "prefill_latent":
        q, pool = _paged_args(7, 3, Sq, 16, 1, 20)[:2]
        bt, start = _paged_args(7, 3, Sq, 16, 1, 20)[3:]
        whole = pa.paged_attention_latent(q, pool, bt, start, scale_dim=12,
                                          d_v=16, kind=kind)
        parts = [pa.paged_attention_latent_head_sharded(
            _RankMesh(r, tp), "model", q, pool, bt, start, scale_dim=12,
            d_v=16, kind=kind) for r in range(tp)]
    else:
        q, pk, pv, bt, start = _paged_args(5, 3, Sq, 16, 8, 16)
        sc = {}
        if kind == "decode_q8":
            pk, pv = (torch.clamp(torch.round(t * 30), -127, 127).to(
                torch.int8) for t in (pk, pv))
            sc = dict(k_scale=torch.rand(pk.shape[0]) + 0.1,
                      v_scale=torch.rand(pk.shape[0]) + 0.1)
        whole = pa.paged_attention(q, pk, pv, bt, start, window=0, kind=kind,
                                   **sc)
        k = 8 // tp
        parts = [pa.paged_attention_head_sharded(
            _RankMesh(r, tp), "model", q, pk[:, :, r * k:(r + 1) * k],
            pv[:, :, r * k:(r + 1) * k], bt, start, kind=kind, **sc)
            for r in range(tp)]
    assert torch.equal(torch.cat(parts, dim=2), whole)


def test_tp_build_validation():
    """tp outside 1 .. the process group's ranks fails at build, before
    any weights (here the group has one rank, or none)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    for tp in (2, 0):
        with pytest.raises(ValueError, match="ranks in the process group"):
            ServeEngine.build("qwen2.5-32b", config=ServeConfig(
                page_size=PS, tp=tp, device="cpu"))


def test_tp_requires_paged_and_divisible_heads():
    """``ServeConfig.validate`` and the engine refuse what the reference
    refuses, with its messages: tp > 1 on the dense cache, and a
    kv-head-sharded pool whose kv heads tp does not divide; int8 pages and
    latent pages compose."""
    from repro.serve import ServeConfig as JConfig
    from repro_torch import configs as tconfigs
    from repro_torch.models import registry as treg
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import kvcache as tkv
    from repro_torch.configs.base import Family
    cfg = treg.reduced_config(tconfigs.get_config("qwen2.5-32b"))
    wide = dataclasses.replace(cfg, num_heads=8, num_kv_heads=4)
    mla = treg.reduced_config(tconfigs.get_config("qwen2.5-32b-mla"))
    for fields, c, frag in ((dict(tp=2), cfg, "PAGED"),
                            (dict(tp=2, page_size=PS), cfg, "divisible"),
                            (dict(tp=8, page_size=PS), wide, "divisible")):
        for config in (ServeConfig(**fields), JConfig(**fields)):
            with pytest.raises(ValueError, match=frag):
                config.validate(c)
    for fields, c in ((dict(tp=2, page_size=PS, kv_backend="paged_int8"),
                       wide),
                      (dict(tp=4, page_size=PS, kv_backend="paged_latent"),
                       mla),
                      (dict(tp=8, page_size=PS, kv_backend="paged_latent"),
                       mla)):
        ServeConfig(**fields).validate(c)
    with pytest.raises(ValueError, match="PAGED"):
        tkv.make_backend("dense", family=Family.DENSE, mesh=2)
    with pytest.raises(ValueError, match="divisible"):
        tkv.make_backend("paged", family=Family.DENSE, page_size=PS,
                         num_pages=4, mesh=3, num_kv_heads=4)
    model = treg.get_model(cfg)
    with pytest.raises(ValueError, match="PAGED"):
        ServeEngine(model, {}, batch_slots=2, s_max=S_MAX, device="cpu",
                    mesh=_RankMesh(0, 2))


def test_clock_replays_refuse_tp():
    """Open-loop replay and the router's replay read a clock on each rank,
    so under tp > 1 ranks could submit at different ticks: both refuse."""
    from repro_torch.serve import ReplicaRouter, workload

    class _Engine:
        tp = 2
    with pytest.raises(ValueError, match="tp"):
        workload.replay(_Engine(), [])
    with pytest.raises(ValueError, match="tp"):
        ReplicaRouter([_Engine()], affinity=False).replay([])


# ------------------------------------------------------- multi-rank tests
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp_greedy_bitwise_equal(spawned, family, tp):
    """tp > 1 == tp = 1 in tokens and in every step's logits, on the kernel
    path, with each rank's pool bytes exactly global / tp."""
    for r in _case(spawned, tp, family):
        assert r["tokens"] == r["tokens1"]
        assert r["logits_equal"] and r["steps"] > GEN
        assert r["bytes"] * tp == r["bytes1"]
        assert r["global"] == r["global1"]
        assert r["shapes"]["k"][3] * tp == 4        # every family's kv heads


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_degenerate_einsum_anchor(spawned, tp):
    """page_size == s_max: the masked-einsum path on each rank's slab."""
    for r in _case(spawned, tp, "anchor"):
        assert r["tokens"] == r["tokens1"] and r["logits_equal"]
        assert r["bytes"] * tp == r["bytes1"]


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_tp_prefix_cache_and_cow(spawned, impl):
    """Prefix aliasing and copy-on-write against a sharded pool: tp = 2
    serves the mesh-free engine's tokens and logits with the same index
    pages, hits and copies. 'einsum' takes the transient path, whose
    prefix seed gathers every rank's slab."""
    name = "prefix" if impl == "kernel" else "prefix/einsum"
    for r in _case(spawned, 2, name):
        assert r["tokens"] == r["tokens1"] and r["logits_equal"]
        assert r["counters"] == r["counters1"]
        pages, hits, cow = r["counters"]
        assert pages and hits >= 2 and cow >= 1


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_latent_bitwise(spawned, tp):
    """Latent pages: the pool stays whole on every rank (bytes equal to
    tp = 1's), the absorbed heads shard, and the streams are bitwise."""
    for r in _case(spawned, tp, "latent"):
        assert r["tokens"] == r["tokens1"] and r["logits_equal"]
        assert r["bytes"] == r["bytes1"] and r["global"] == r["global1"]


@pytest.mark.parametrize("name", ["encdec", "hybrid"])
def test_tp_transient_families_bitwise(spawned, name):
    """whisper (its prefill spliced into pages slab by slab, decode through
    the head-sharded kernel) and hymba's paged ring at tp = 2."""
    for r in _case(spawned, 2, name):
        assert r["tokens"] == r["tokens1"] and r["logits_equal"]
        assert r["bytes"] < r["bytes1"]


def test_tp_replica_groups(spawned):
    """A world of 4 at tp = 2 holds two groups of 2 ranks; each serves
    tp = 1's tokens."""
    for r in _case(spawned, 4, "replicas"):
        assert r["tokens"] == r["tokens1"] and r["logits_equal"]
        assert r["bytes"] * 2 == r["bytes1"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp_int8_greedy_prefix_match(spawned, family):
    """Int8 pages at tp = 2: each rank holds its (L, P, 1) column of the
    (L, P, tp) scale groups (the global bytes count tp columns), and the
    streams keep a mean greedy prefix match of at least 0.6 against
    tp = 1. (tp = 4's int8 streams are held bit for bit to the grouped
    layout by the test below.)"""
    tp = 2
    for r in _case(spawned, tp, f"int8/{family}"):
        L = r["scale"][0]
        assert r["scale"][2] == 1
        assert r["match"] >= 0.6, r["match"]
        scale_cols = 2 * L * r["scale"][1] * 4 * (tp - 1)
        assert r["global"] == r["global1"] + scale_cols


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_int8_equals_one_engine_with_tp_scale_groups(spawned, tp):
    """What tp ranks serve on int8 pages is what one engine serves with the
    reference's (L, P, tp) scale groups, bit for bit, prefix hits and
    copy-on-write included."""
    for r in _case(spawned, tp, "int8/groups"):
        assert r["tokens"] == r["tokens1"] and r["logits_equal"]
        assert r["hits"] >= 3


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_slab_plan_launches_equal_the_whole_launch_on_the_card(tp):
    """On the card each slab launch (K1, K3, K4; decode, where the slab's
    own plan would take more splits, and prefill) with the whole call's
    plan concatenates to the whole launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    for Sq in (1, 9):
        q, pk, pv, bt, start = (t.to(dev) for t in _paged_args(
            3, 3, Sq, 16, 8, 128, ps=16, mps=8))
        k = 8 // tp
        for sc in ({}, "q8"):
            kpk, kpv, kw = pk, pv, {}
            if sc:
                kpk, kpv = (torch.clamp(torch.round(t * 30), -127, 127).to(
                    torch.int8) for t in (pk, pv))
                kw = dict(k_scale=torch.rand(pk.shape[0], device=dev) + .1,
                          v_scale=torch.rand(pk.shape[0], device=dev) + .1)
            kind = ("decode" if Sq == 1 else "prefill") + ("_q8" if sc
                                                          else "")
            whole = pa.paged_attention(q, kpk, kpv, bt, start, kind=kind,
                                       **kw)
            parts = [pa.paged_attention_head_sharded(
                _RankMesh(r, tp), "model", q,
                kpk[:, :, r * k:(r + 1) * k].contiguous(),
                kpv[:, :, r * k:(r + 1) * k].contiguous(), bt, start,
                kind=kind, **kw) for r in range(tp)]
            assert torch.equal(torch.cat(parts, dim=2), whole), (kind, tp)
        lq = torch.randn(3, Sq, 16, 192, device=dev)
        pool = torch.randn(pk.shape[0], 16, 1, 192, device=dev)
        kind = "decode_latent" if Sq == 1 else "prefill_latent"
        whole = pa.paged_attention_latent(lq, pool, bt, start, scale_dim=64,
                                          d_v=128, kind=kind)
        parts = [pa.paged_attention_latent_head_sharded(
            _RankMesh(r, tp), "model", lq, pool, bt, start, scale_dim=64,
            d_v=128, kind=kind) for r in range(tp)]
        assert torch.equal(torch.cat(parts, dim=2), whole), (kind, tp)


@pytest.mark.gpu
def test_one_rank_nccl_engine_serves_the_mesh_free_stream():
    """tp = 1 over a one-rank NCCL group on the card: the mesh-free
    engine's tokens and logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.sharding import specs
    made = not dist.is_initialized()
    try:
        specs.check_serve_group(1, "cuda")
        arch, ov = FAMILIES["dense"]
        free = ServeEngine.build(arch, config=ServeConfig(
            batch_slots=SLOTS, s_max=S_MAX, page_size=PS, cfg_overrides=ov))
        mesh = specs.serve_mesh(1, "cuda")
        eng = ServeEngine(free.model, free.params, mesh=mesh,
                          **ServeConfig(batch_slots=SLOTS, s_max=S_MAX,
                                        page_size=PS).engine_kwargs())
        out = []
        for e in (free, eng):
            seen = _record(e)
            reqs = [e.submit(p, GEN) for p in _prompts()]
            e.run()
            out.append(([list(r.tokens) for r in reqs], seen))
        assert out[0][0] == out[1][0] and _bitwise(out[0][1], out[1][1])
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
