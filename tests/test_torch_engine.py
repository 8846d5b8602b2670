"""The port's serving engine against ``repro.serve.ServeEngine`` on the
reduced qwen2.5-32b (s_max 64, 4 slots) with bridged weights: greedy token
streams are equal over mixed prompt lengths and shared prefixes, on the
paged kernel path (page_size 16) with the prefix cache on and off — and so
are the prefix-hit / copy-on-write counters — and on the transient paths:
the dense cache with the einsum or the flash kernel on the first chunk,
the scan prefill, the paged einsum path with the prefix cache on and off,
and the ``page_size == s_max`` anchor, which the port also holds bit for
bit to its own dense engine. The same for int8 pages
(``kv_backend="paged_int8"``: streams and counters equal to the
reference's with the prefix cache on and off; a prefix hit aliases pages
and their scales; copy-on-write hands the fresh page the source's scale
and the tail splice re-quantizes it) and for the reduced qwen2.5-32b-mla
(the dense latent cache, latent pages with the backend implicit or
explicit, prefix on and off; one-page latent pages bit-equal to the dense
latent cache in the port), and for int8 weight quantization
(``quantize_int8``: the reference's quantized engine against the port's
engine over the same weights quantized in the port, dense and paged, for
qwen, rwkv6 and hymba's dense and paged ring; the port's own build and
``--quantize-int8``). codeqwen1.5-7b and minicpm-2b (tied embeddings)
give the reference's streams on pages of 16 and on the dense cache. The recurrent families on
perturbed weights: rwkv6 (dense parallel and scan prefill, its ignored
page size) and hymba (dense ring with parallel, flash-path and scan
prefill; the paged ring with pages of 4 rows) give the reference's
streams, rwkv's page size warns as the reference does, the prefix cache
stays off for them, and the default arch is the reference's (hymba-1.5b)
in the build and the CLI. Also: ``chain_hash`` keys are byte-equal,
``ServeConfig.validate()`` messages are equal, the prefix-cache rule falls
back with a warning where unsupported, int8 on an unported family falls
back to fp32 pages with the reference's warning, latent pages on a
per-head arch raise the reference's error, and an entry point with no
device given raises on a host without CUDA."""
import logging

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro.serve import prefix as jprefix  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import Family  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import ServeConfig as TConfig  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.serve import prefix as tprefix  # noqa: E402
from repro_torch.serve.scheduler import RequestState  # noqa: E402

PS, S_MAX, GEN = 16, 64, 8


@pytest.fixture(scope="module")
def reference():
    """The reference engine as a user builds it, and its weights."""
    eng = JEngine.build("qwen2.5-32b",
                        config=JConfig(page_size=PS, s_max=S_MAX))
    assert eng.paged_attn_impl == "kernel" and eng.incremental_splice
    assert eng.prefix_cache
    return eng


def _waves(vocab):
    """Two waves of requests. A 20-token header X (one full page plus 4
    rows) is shared: wave 1 registers X itself and longer X-prompts; wave 2
    hits the full page and the partial page (copy-on-write), next to
    prompts that share nothing. Lengths mix 1..57 tokens."""
    rng = np.random.default_rng(31)
    X = rng.integers(0, vocab, 20)
    tail = lambda n: rng.integers(0, vocab, n)  # noqa: E731
    wave1 = [X, np.concatenate([X, tail(13)]), tail(9), tail(37), tail(1)]
    wave2 = [np.concatenate([X, tail(5)]), X, np.concatenate([X, tail(37)]),
             tail(16), np.concatenate([X[:16], tail(3)])]
    return wave1, wave2


def _serve(engine, waves):
    streams = []
    for wave in waves:
        reqs = [engine.submit(p, GEN) for p in wave]
        engine.run()
        streams += [list(r.tokens) for r in reqs]
    return streams


def _port_engine(ref, prefix_cache=None, **fields):
    """The port's engine over the reference's weights, built from the same
    ServeConfig fields the reference was (plus device='cpu')."""
    model = treg.get_model(treg.reduced_config(
        tconfigs.get_config(ref.cfg.name)))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                      "cpu")
    fields = dict(dict(page_size=PS, s_max=S_MAX), **fields)
    return TEngine(model, params, **TConfig(
        prefix_cache=prefix_cache, device="cpu", **fields).engine_kwargs())


@pytest.fixture(scope="module")
def references(reference):
    """arch -> the reference engine as a user builds it (pages of 16),
    built once."""
    built = {reference.cfg.name: reference}

    def get(arch):
        if arch not in built:
            built[arch] = JEngine.build(
                arch, config=JConfig(page_size=PS, s_max=S_MAX))
        return built[arch]
    return get


# (arch, page_size, prefix_cache): qwen with the prefix cache on by itself
# and off; the other dense archs (codeqwen, and minicpm's tied embeddings)
# on pages of 16 and on the dense cache
GREEDY_CASES = [
    pytest.param("qwen2.5-32b", PS, None, id="None"),
    pytest.param("qwen2.5-32b", PS, False, id="False"),
] + [pytest.param(arch, ps, None, id=f"{arch}-{name}")
     for arch in ("codeqwen1.5-7b", "minicpm-2b")
     for name, ps in (("paged", PS), ("dense", None))]


@pytest.mark.parametrize("arch,page_size,prefix_cache", GREEDY_CASES)
def test_greedy_streams_equal_reference(references, arch, page_size,
                                        prefix_cache):
    """Same weights, same requests: identical greedy streams and, on
    pages, identical prefix-cache counters (lookups, hits, hit tokens,
    shared pages, COW copies, evictions), with the prefix cache on by
    itself and off."""
    ref = references(arch)
    jeng = JEngine(ref.model, ref.params, **JConfig(
        page_size=page_size, s_max=S_MAX,
        prefix_cache=prefix_cache).engine_kwargs())
    teng = _port_engine(ref, prefix_cache=prefix_cache, page_size=page_size)
    assert (teng.paged, teng.prefix_cache) == (jeng.paged, jeng.prefix_cache)
    assert teng.paged == (page_size is not None)
    waves = _waves(ref.cfg.vocab_size)
    want = _serve(jeng, waves)
    got = _serve(teng, waves)
    assert got == want
    assert all(len(s) == GEN for s in got)
    if not teng.paged:
        return
    jp, tp = jeng.metrics.summary()["prefix"], teng.metrics.summary()["prefix"]
    assert {k: v for k, v in tp.items() if k != "hit_rate"} == \
        {k: v for k, v in jp.items() if k != "hit_rate"}
    if prefix_cache is None:
        assert tp["hits"] >= 3 and tp["cow_copies"] >= 1
    teng.assert_page_invariants()
    assert teng.allocator.free + len(teng.prefix_index.pages if
                                     teng.prefix_index else []) \
        == teng.num_pages


# the transient paths: (ServeConfig fields, the path the engine must take)
TRANSIENT = {
    "dense-einsum": dict(page_size=None, prefill_attn_impl="einsum"),
    "dense-pallas": dict(page_size=None, prefill_attn_impl="pallas"),
    "dense-scan": dict(page_size=None, prefill_mode="scan"),
    "paged-einsum-prefix": dict(paged_attn_impl="einsum"),
    "paged-einsum-noprefix": dict(paged_attn_impl="einsum",
                                  prefix_cache=False),
    "paged-one-page": dict(page_size=S_MAX, prefill_attn_impl="pallas"),
}


@pytest.mark.parametrize("name", list(TRANSIENT))
def test_transient_paths_greedy_streams_equal_reference(reference, name):
    """The dense cache, the scan prefill and the paged einsum path (with
    a transient request cache and a completion splice; prefix hits seed it
    from the pages) give the reference's greedy streams and counters."""
    ref = reference
    fields = dict(dict(page_size=PS, s_max=S_MAX), **TRANSIENT[name])
    jeng = JEngine(ref.model, ref.params,
                   **JConfig(**fields).engine_kwargs())
    teng = _port_engine(ref, **fields)
    assert not teng.incremental_splice and not jeng.incremental_splice
    assert (teng.paged, teng.prefix_cache, teng.prefill_attn_impl,
            teng.paged_attn_impl) == (jeng.paged, jeng.prefix_cache,
                                      jeng.prefill_attn_impl,
                                      jeng.paged_attn_impl)
    waves = _waves(ref.cfg.vocab_size)
    want = _serve(jeng, waves)
    assert _serve(teng, waves) == want
    jp, tp = jeng.metrics.summary()["prefix"], teng.metrics.summary()["prefix"]
    assert {k: v for k, v in tp.items() if k != "hit_rate"} == \
        {k: v for k, v in jp.items() if k != "hit_rate"}
    if name == "paged-einsum-prefix":
        assert tp["hits"] >= 3 and tp["cow_copies"] >= 1
    assert teng.transient_cache_bytes() == 0
    assert teng.max_transient_cache_bytes == jeng.max_transient_cache_bytes
    teng.assert_page_invariants()


def _record_logits(engine):
    """Wrap the engine so every sampled logits row is kept: each prefill
    group's rows and each decode tick's rows of RUNNING slots."""
    seen = []
    decode, splice = engine._decode, engine._splice_and_start

    def rec_decode(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        run = [i for i, r in enumerate(engine.slot_req)
               if r is not None and r.state == RequestState.RUNNING]
        seen.append(logits[run].clone())
        return logits, cache

    def rec_splice(slot_ids, reqs, rcache, logits, **kw):
        seen.append(logits.clone())
        return splice(slot_ids, reqs, rcache, logits, **kw)

    engine._decode, engine._splice_and_start = rec_decode, rec_splice
    return seen


def test_one_page_anchor_equals_dense_bit_for_bit(reference):
    """Within the port, the paged einsum path at page_size == s_max (one
    page per slot) computes exactly what the dense cache computes: every
    sampled logits row is bit-equal."""
    dense = _port_engine(reference, page_size=None)
    paged = _port_engine(reference, prefix_cache=False, page_size=S_MAX)
    assert paged.paged_attn_impl == "einsum" and not paged.incremental_splice
    seen = [_record_logits(e) for e in (dense, paged)]
    waves = _waves(reference.cfg.vocab_size)
    assert _serve(dense, waves) == _serve(paged, waves)
    assert len(seen[0]) == len(seen[1]) > 20
    for a, b in zip(*seen):
        assert torch.equal(a, b)


def test_prefix_cache_rule_matches_reference(reference, caplog):
    """The prefix cache needs a paged cache and parallel prefill: None
    turns it on only there, and an explicit True elsewhere warns and falls
    back, as the reference does."""
    for fields in (dict(), dict(page_size=None), dict(prefill_mode="scan"),
                   dict(paged_attn_impl="einsum")):
        for prefix_cache in (None, True, False):
            jfields = dict(dict(page_size=PS, s_max=S_MAX), **fields)
            jeng = JEngine(reference.model, reference.params,
                           **JConfig(prefix_cache=prefix_cache,
                                     **jfields).engine_kwargs())
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                teng = _port_engine(reference, prefix_cache=prefix_cache,
                                    **fields)
            assert teng.prefix_cache == jeng.prefix_cache, (fields,
                                                           prefix_cache)
            warned = any("prefix_cache unsupported" in r.getMessage()
                         for r in caplog.records)
            assert warned == bool(prefix_cache and not teng.prefix_cache)


def test_chain_hash_keys_byte_equal():
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 152064, 53).astype(np.int32)
    h = b"seed"
    for n in (1, 7, 16):
        assert tprefix.chain_hash(h, prompt[:n]) == \
            jprefix.chain_hash(h, prompt[:n])
    jidx = jprefix.PrefixIndex(None, 16)
    tidx = tprefix.PrefixIndex(None, 16)
    jplan, tplan = jidx.lookup(prompt), tidx.lookup(prompt)
    assert tplan.full_hashes == jplan.full_hashes
    assert tplan.partial_key == jplan.partial_key


BAD_CONFIGS = [
    dict(batch_slots=0), dict(s_max=0), dict(top_k=-1), dict(top_p=0.0),
    dict(prefill_mode="eager"), dict(paged_attn_impl="flash"),
    dict(prefill_chunk_tokens=0), dict(kv_backend="nope"),
    dict(page_size=0), dict(page_size=16, s_max=60),
    dict(kv_backend="dense", page_size=16), dict(kv_backend="paged"),
    dict(kv_backend="paged_latent", page_size=16),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_validate_messages_equal_reference(reference, kw):
    cfg = reference.cfg
    with pytest.raises(ValueError) as jerr:
        JConfig(**kw).validate(cfg)
    tcfg = tconfigs.get_config("qwen2.5-32b")
    with pytest.raises(ValueError) as terr:
        TConfig(**kw).validate(tcfg)
    assert str(terr.value) == str(jerr.value)


def test_entry_points_raise_without_cuda_unless_cpu_asked(monkeypatch,
                                                          reference):
    """With no CUDA, the build, the constructor and the CLI raise when no
    device is given; nothing falls back to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine.build("qwen2.5-32b", config=TConfig(page_size=PS))
    teng = _port_engine(reference)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(teng.model, teng.params, batch_slots=2, s_max=S_MAX,
                page_size=PS)
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine.build("qwen2.5-32b", config=TConfig())
    for arch, config in (("qwen2.5-32b", TConfig(page_size=PS,
                                                 kv_backend="paged_int8")),
                         ("qwen2.5-32b-mla", TConfig()),
                         ("qwen2.5-32b-mla", TConfig(page_size=PS))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine.build(arch, config=config)
    for config in (TConfig(page_size=PS, device="cpu"),
                   TConfig(device="cpu")):
        cpu = TEngine.build("qwen2.5-32b", config=config)
        assert cpu.device.type == "cpu"
        assert cpu.cache["k"].device.type == "cpu"
        assert cpu.paged == (config.page_size is not None)
    assert cpu.prefill_attn_impl == "einsum"    # 'auto' off the card
    assert tuple(cpu.cache["k"].shape) == (2, 4, 64, 1, 16)


def test_configs_outside_the_slice_name_their_roadmap_item():
    """Tensor-parallel serving is not ported: it raises naming its item
    before any weights are built (sampling and every SchedPolicy knob
    serve, held in test_torch_sampling.py and test_torch_scheduling.py)."""
    for tp in (1, 2):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 12"):
            TEngine.build("qwen2.5-32b", config=TConfig(
                page_size=PS, tp=tp, device="cpu"))


def test_cli_defaults_to_the_dense_cache(monkeypatch, capsys):
    """The CLI builds its ServeConfig as the reference CLI does from
    ServeConfig's defaults: a dense cache unless --page-size is given, and
    --prefill-mode / --prefill-attn-impl reach the engine."""
    from repro_torch.launch import serve as cli
    built = []
    build = TEngine.build.__func__

    def spy(cls, arch, *, config):
        built.append(config)
        return build(cls, arch, config=config)

    monkeypatch.setattr(TEngine, "build", classmethod(spy))
    args = ["--device", "cpu", "--requests", "2", "--prompt-len", "5",
            "--gen-len", "3"]
    cli.main(args)
    cli.main(args + ["--page-size", "16", "--prefill-mode", "scan",
                     "--prefill-attn-impl", "pallas"])
    dense, paged = built
    assert dense.page_size is None and dense.page_size == \
        JConfig().page_size
    assert (dense.prefill_mode, dense.prefill_attn_impl) == \
        (JConfig().prefill_mode, JConfig().prefill_attn_impl)
    assert (paged.page_size, paged.prefill_mode, paged.prefill_attn_impl) \
        == (16, "scan", "pallas")
    assert capsys.readouterr().out.count("served 2 requests on cpu") == 2


def test_cli_kv_backend_reaches_the_engine(monkeypatch, capsys):
    """--kv-backend takes the reference's backend names (default None:
    the layout follows --page-size) and ends in ServeConfig.kv_backend."""
    from repro_torch.launch import serve as cli
    built = []
    build = TEngine.build.__func__

    def spy(cls, arch, *, config):
        built.append(config)
        engine = build(cls, arch, config=config)
        built.append(engine)
        return engine

    monkeypatch.setattr(TEngine, "build", classmethod(spy))
    args = ["--device", "cpu", "--requests", "2", "--prompt-len", "5",
            "--gen-len", "3", "--page-size", "16", "--arch", "qwen2.5-32b"]
    cli.main(args)
    cli.main(args + ["--kv-backend", "paged_int8"])
    cli.main(args + ["--kv-backend", "paged_latent", "--arch",
                     "qwen2.5-32b-mla"])
    (implicit, e0), (int8, e1), (latent, e2) = zip(built[::2], built[1::2])
    assert implicit.kv_backend is None and JConfig().kv_backend is None
    assert (int8.kv_backend, type(e1.backend)) == ("paged_int8",
                                                   tkv.PagedInt8Backend)
    assert (latent.kv_backend, type(e2.backend)) == ("paged_latent",
                                                     tkv.PagedLatentBackend)
    assert type(e0.backend) is tkv.PagedFP32Backend
    assert set(tkv.BACKENDS) == set(jkv.BACKENDS)
    assert capsys.readouterr().out.count("served 2 requests on cpu") == 3
    with pytest.raises(SystemExit):
        cli.main(args + ["--kv-backend", "latent"])


# ------------------------------------------------- int8 weight quantization
# (arch, page_size): qwen paged and dense; rwkv6 dense (it has nothing to
# page); hymba's dense ring and its paged ring (pages of 4 rows)
QUANT_CASES = [pytest.param("qwen2.5-32b", PS, id=str(PS)),
               pytest.param("qwen2.5-32b", None, id="None"),
               pytest.param("rwkv6-7b", None, id="rwkv6-7b-None"),
               pytest.param("hymba-1.5b", None, id="hymba-1.5b-None"),
               pytest.param("hymba-1.5b", 4, id="hymba-1.5b-4")]


@pytest.mark.parametrize("arch,page_size", QUANT_CASES)
def test_quantize_int8_streams_equal_reference(arch, page_size):
    """The reference engine built with ``quantize_int8=True`` against the
    port's engine over the reference's ``model.init`` weights, bridged and
    quantized in the port (per-channel int8, then dequantized to f32):
    the served weights are bit-equal and the greedy streams equal, on the
    paged cache and on the dense one, for the dense, SSM and hybrid
    families."""
    fields = dict(page_size=page_size, s_max=S_MAX)
    jeng = JEngine.build(arch, config=JConfig(quantize_int8=True, **fields))
    raw = jeng.model.init(jax.random.PRNGKey(JConfig().seed))
    params = tq.dequantize_params(tq.quantize_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, raw), "cpu")),
        torch.float32)
    served = jax.tree.leaves(jax.tree.map(np.asarray, jeng.params))
    mine = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    assert len(served) == len(mine)
    for a, b in zip(mine, served):
        np.testing.assert_array_equal(a, b)
    model = treg.get_model(treg.reduced_config(tconfigs.get_config(arch)))
    teng = TEngine(model, params, **TConfig(device="cpu",
                                            **fields).engine_kwargs())
    assert teng.paged == jeng.paged
    waves = _waves(jeng.cfg.vocab_size)
    assert _serve(teng, waves) == _serve(jeng, waves)


def test_quantize_int8_build_and_cli(monkeypatch, capsys):
    """``ServeEngine.build(quantize_int8=True)`` serves the quantized-then-
    dequantized weights of the plain build (same seed), 1-D leaves as they
    are; ``--quantize-int8`` reaches ``ServeConfig.quantize_int8``."""
    plain = TEngine.build("qwen2.5-32b", config=TConfig(device="cpu"))
    quant = TEngine.build("qwen2.5-32b", config=TConfig(device="cpu",
                                                        quantize_int8=True))
    want = tq.dequantize_params(tq.quantize_params(plain.params),
                                torch.float32)
    for a, b in zip(jax.tree.leaves(quant.params), jax.tree.leaves(want)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    changed = [not torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(quant.params), jax.tree.leaves(plain.params))]
    assert any(changed) and not all(changed)      # norms stay unquantized
    from repro_torch.launch import serve as cli
    built = []
    build = TEngine.build.__func__

    def spy(cls, arch, *, config):
        built.append(config)
        return build(cls, arch, config=config)

    monkeypatch.setattr(TEngine, "build", classmethod(spy))
    args = ["--device", "cpu", "--requests", "2", "--prompt-len", "5",
            "--gen-len", "3"]
    cli.main(args)
    cli.main(args + ["--quantize-int8"])
    assert [c.quantize_int8 for c in built] == [False, True]
    assert capsys.readouterr().out.count("served 2 requests on cpu") == 2


# ------------------------------------------------------------ int8 pages
@pytest.mark.parametrize("prefix_cache", [None, False])
def test_int8_greedy_streams_equal_reference(reference, prefix_cache):
    """int8 pages (page_size 16) over the reference's weights: the same
    greedy streams and prefix counters as the reference's int8 engine,
    with the prefix cache on by itself and off; scale tables well formed."""
    fields = dict(page_size=PS, s_max=S_MAX, kv_backend="paged_int8",
                  prefix_cache=prefix_cache)
    jeng = JEngine(reference.model, reference.params,
                   **JConfig(**fields).engine_kwargs())
    teng = _port_engine(reference, **fields)
    assert isinstance(teng.backend, tkv.PagedInt8Backend)
    assert teng.incremental_splice and teng.paged_attn_impl == "kernel"
    assert teng.cache["k"].dtype == torch.int8
    assert tuple(teng.cache["k_scale"].shape) == \
        tuple(jeng.cache["k_scale"].shape)
    waves = _waves(reference.cfg.vocab_size)
    assert _serve(teng, waves) == _serve(jeng, waves)
    jp, tp = jeng.metrics.summary()["prefix"], teng.metrics.summary()["prefix"]
    assert {k: v for k, v in tp.items() if k != "hit_rate"} == \
        {k: v for k, v in jp.items() if k != "hit_rate"}
    if prefix_cache is None:
        assert tp["hits"] >= 3 and tp["cow_copies"] >= 1
    teng.assert_page_invariants()
    assert teng.resident_cache_bytes() < _port_engine(
        reference, page_size=PS, s_max=S_MAX).resident_cache_bytes()


def _scales(engine):
    return {k: engine.cache[k].clone() for k in ("k_scale", "v_scale")}


def test_int8_prefix_hit_aliases_pages_and_scales(reference):
    """A repeat prompt aliases the donor's prefix pages: their int8
    payload and their scales are untouched by the second request, and its
    stream equals the first's."""
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, reference.cfg.vocab_size, 16)
    teng = _port_engine(reference, page_size=PS, s_max=S_MAX,
                        kv_backend="paged_int8")
    r1 = teng.submit(prompt, 5)
    teng.run()
    donor = sorted(teng.prefix_index.pages)
    assert donor
    before = _scales(teng)
    payload = teng.cache["k"][:, donor].clone()
    r2 = teng.submit(prompt, 5)
    teng.run()
    assert r1.tokens == r2.tokens
    assert teng.metrics.summary()["prefix"]["hits"] == 1
    for key, sc in _scales(teng).items():
        assert torch.equal(sc[:, donor], before[key][:, donor]), key
    assert torch.equal(teng.cache["k"][:, donor], payload)
    teng.assert_page_invariants()
    teng.cache["k_scale"][0, 0] = 0.0
    with pytest.raises(AssertionError, match="k_scale"):
        teng.assert_page_invariants()


def test_int8_cow_requantizes_the_fresh_page_once(reference):
    """An unaligned repeat (the cached prefix ends mid-page): the COW copy
    hands the fresh page the SOURCE page's scale, then the tail's chunk
    splice re-quantizes that page once, with its own rows; the streams
    equal the prefix-off int8 engine's."""
    rng = np.random.default_rng(42)
    head = rng.integers(0, reference.cfg.vocab_size, 20)  # 1 page + 4 rows
    tail = rng.integers(0, reference.cfg.vocab_size, 6)
    work = [(head, 5), (np.concatenate([head, tail]), 5)]
    streams = {}
    for prefix_cache in (None, False):
        teng = _port_engine(reference, prefix_cache=prefix_cache,
                            page_size=PS, s_max=S_MAX,
                            kv_backend="paged_int8")
        seen, splices = [], []
        copy, chunk = teng.backend.copy_rows, teng._chunk_paged

        def rec_copy(cache, src, dst, teng=teng, seen=seen, copy=copy):
            out = copy(cache, src, dst)
            live = dst[:, 0] < teng.num_pages * PS
            s_pg, d_pg = src[live, 0] // PS, dst[live, 0] // PS
            seen.append((d_pg, [torch.equal(cache[k][:, d_pg],
                                            cache[k][:, s_pg])
                                for k in ("k_scale", "v_scale")]))
            return out

        def rec_chunk(params, cache, batch, splices=splices, chunk=chunk):
            splices.append(cache["k_scale"].clone())
            return chunk(params, cache, batch)

        teng.backend.copy_rows, teng._chunk_paged = rec_copy, rec_chunk
        out = []
        for prompt, gen in work:
            r = teng.submit(prompt, gen)
            teng.run()
            out.append(r.tokens)
            teng.assert_page_invariants()
        streams[prefix_cache] = out
        if prefix_cache is None:
            assert teng.metrics.summary()["prefix"]["cow_copies"] == 1
            (fresh, same), = seen
            assert same == [True, True]
            # after the tail chunk, the fresh page holds its own scale
            assert not torch.equal(teng.cache["k_scale"][:, fresh],
                                   splices[-1][:, fresh])
    assert streams[None] == streams[False]


def test_int8_seed_prefix_dequantizes_the_aliased_pages(reference):
    """The transient path's prefix seed over int8 pages (the einsum read
    path): the seeded rows are the int8 rows times their page scales, the
    fp32 seed of the dequantized pool bit for bit."""
    teng = _port_engine(reference, page_size=PS, s_max=S_MAX,
                        kv_backend="paged_int8", paged_attn_impl="einsum")
    rng = np.random.default_rng(43)
    for key in ("k", "v"):
        teng.cache[key].copy_(torch.from_numpy(rng.integers(
            -127, 128, tuple(teng.cache[key].shape)).astype(np.int8)))
        teng.cache[key + "_scale"].uniform_(0.01, 0.1)
    phys = torch.from_numpy(rng.integers(0, teng.num_pages * PS,
                                         (2, S_MAX)))
    ok = torch.arange(S_MAX)[None, :] < torch.tensor([[20], [37]])
    got = teng.backend.seed_prefix(teng.model, S_MAX, torch.float32)(
        teng.cache, phys, ok, 20)
    deq = {key: teng.cache[key].float()
           * teng.cache[key + "_scale"][:, :, None, None, :]
           for key in ("k", "v")}
    want = treg.seed_prefix_cache(teng.model, deq, phys, ok, 20, S_MAX)
    for key in ("k", "v", "pos"):
        assert torch.equal(got[key], want[key]), key


def test_int8_on_an_unported_family_falls_back_with_a_warning(caplog):
    """As the reference: int8 pages on a family outside INT8_KV_FAMILIES
    give fp32 pages and a warning, not an error."""
    assert [f.name for f in tkv.INT8_KV_FAMILIES] == \
        [f.name for f in jkv.INT8_KV_FAMILIES]
    jfam = jkv.Family.HYBRID
    with caplog.at_level(logging.WARNING):
        tbe = tkv.make_backend("paged_int8", family=Family.HYBRID,
                               page_size=8, num_pages=8)
        jbe = jkv.make_backend("paged_int8", family=jfam, page_size=8,
                               num_pages=8)
    assert type(tbe) is tkv.PagedFP32Backend
    assert type(jbe) is jkv.PagedFP32Backend
    warned = [r.getMessage() for r in caplog.records
              if "falling back" in r.getMessage()]
    assert len(warned) == 2 and warned[0].startswith("paged_int8 KV backend")
    be = tkv.make_backend("paged_int8", family=Family.DENSE, page_size=8,
                          num_pages=8)
    assert type(be) is tkv.PagedInt8Backend


# ------------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def mla_reference():
    eng = JEngine.build("qwen2.5-32b-mla",
                        config=JConfig(page_size=PS, s_max=S_MAX))
    assert eng.paged_attn_impl == "kernel" and eng.prefix_cache
    return eng


MLA_PATHS = {
    "dense": dict(page_size=None),
    "paged-implicit": dict(),
    "paged-latent": dict(kv_backend="paged_latent"),
    "paged-latent-noprefix": dict(kv_backend="paged_latent",
                                  prefix_cache=False),
}


@pytest.mark.parametrize("name", list(MLA_PATHS))
def test_mla_greedy_streams_equal_reference(mla_reference, name):
    """qwen2.5-32b-mla reduced: the dense latent cache and multi-page
    latent pages (backend implicit or explicit, prefix cache on and off)
    give the reference's greedy streams and prefix counters; the latent
    cache holds one "k" leaf and no "v"."""
    ref = mla_reference
    fields = dict(dict(page_size=PS, s_max=S_MAX), **MLA_PATHS[name])
    jeng = JEngine(ref.model, ref.params, **JConfig(**fields).engine_kwargs())
    teng = _port_engine(ref, **fields)
    assert "v" not in teng.cache and teng.cache["k"].shape[-2:] == (1, 10)
    assert (teng.paged, teng.prefix_cache, teng.paged_attn_impl,
            teng.incremental_splice) == (jeng.paged, jeng.prefix_cache,
                                         jeng.paged_attn_impl,
                                         jeng.incremental_splice)
    assert type(teng.backend).__name__ == type(jeng.backend).__name__
    waves = _waves(ref.cfg.vocab_size)
    assert _serve(teng, waves) == _serve(jeng, waves)
    jp, tp = jeng.metrics.summary()["prefix"], teng.metrics.summary()["prefix"]
    assert {k: v for k, v in tp.items() if k != "hit_rate"} == \
        {k: v for k, v in jp.items() if k != "hit_rate"}
    if teng.prefix_cache:
        assert tp["hits"] >= 3 and tp["cow_copies"] >= 1
    teng.assert_page_invariants()


def test_mla_one_page_latent_equals_dense_latent_bit_for_bit(mla_reference):
    """Within the port, latent pages at page_size == s_max (the einsum
    anchor) compute exactly what the dense latent cache computes."""
    dense = _port_engine(mla_reference, page_size=None)
    paged = _port_engine(mla_reference, prefix_cache=False, page_size=S_MAX,
                         kv_backend="paged_latent")
    assert paged.paged_attn_impl == "einsum"
    seen = [_record_logits(e) for e in (dense, paged)]
    waves = _waves(mla_reference.cfg.vocab_size)
    assert _serve(dense, waves) == _serve(paged, waves)
    assert len(seen[0]) == len(seen[1]) > 20
    for a, b in zip(*seen):
        assert torch.equal(a, b)


def test_latent_pages_on_a_per_head_arch_raise_the_reference_error(
        reference):
    """kv_backend='paged_latent' on qwen2.5-32b (per-head K/V): the same
    ValueError as the reference, message for message, from the engine
    and from ServeConfig.validate."""
    kw = dict(batch_slots=2, s_max=S_MAX, page_size=PS,
              kv_backend="paged_latent")
    with pytest.raises(ValueError) as jerr:
        JEngine(reference.model, reference.params, **kw)
    teng = _port_engine(reference)
    with pytest.raises(ValueError) as terr:
        TEngine(teng.model, teng.params, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert "kv_lora_rank" in str(terr.value)
    with pytest.raises(ValueError) as jerr:
        JEngine.build("qwen2.5-32b", config=JConfig(page_size=PS,
                                                    kv_backend="paged_latent"))
    with pytest.raises(ValueError) as terr:
        TEngine.build("qwen2.5-32b", config=TConfig(
            page_size=PS, kv_backend="paged_latent", device="cpu"))
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------- recurrent families
# repro's init leaves these at zero (constant decay, no bonus, A = -1);
# seeded noise, the same in both packages, makes the recurrences data-
# dependent (see tests/test_torch_ssm.py and test_torch_hybrid.py)
RECURRENT_NOISE = {
    "rwkv6-7b": {"u": 0.1, "mu": 0.1, "mu_x": 0.1, "lora_B": 0.01,
                 "wB": 0.01},
    "hymba-1.5b": {"logA": 0.5},
}
REC_S_MAX, REC_PS = 32, 4


@pytest.fixture(scope="module")
def recurrent():
    """arch -> (reference model, its perturbed weights, the port's model,
    the same weights bridged)."""
    from test_torch_ssm import perturbed
    out = {}
    for arch, noise in RECURRENT_NOISE.items():
        jeng = JEngine.build(arch, config=JConfig(s_max=REC_S_MAX))
        numpy_params = perturbed(jeng.params, noise)
        tmodel = treg.get_model(treg.reduced_config(
            tconfigs.get_config(arch)))
        out[arch] = (jeng.model, jax.tree.map(jnp.asarray, numpy_params),
                     tmodel, bridge.params_from_numpy(numpy_params, "cpu"))
    return out


def _recurrent_prompts(vocab):
    """Seven prompts of 1-25 tokens (most longer than hymba's 8-row
    window, so the ring wraps in prefill and in decode) for 3 slots: slots
    recycle mid-run."""
    rng = np.random.default_rng(41)
    return [rng.integers(0, vocab, n) for n in (25, 3, 12, 1, 19, 9, 16)]


RECURRENT_PATHS = [
    ("rwkv6-7b", "dense-parallel", dict()),
    ("rwkv6-7b", "dense-scan", dict(prefill_mode="scan")),
    ("rwkv6-7b", "page-size-ignored", dict(page_size=REC_PS)),
    ("hymba-1.5b", "dense-parallel", dict()),
    ("hymba-1.5b", "dense-parallel-flash", dict(prefill_attn_impl="pallas")),
    ("hymba-1.5b", "dense-scan", dict(prefill_mode="scan")),
    ("hymba-1.5b", "paged-ring", dict(page_size=REC_PS)),
    ("hymba-1.5b", "paged-ring-scan", dict(page_size=REC_PS,
                                           prefill_mode="scan")),
]


@pytest.mark.parametrize("arch,name,fields", RECURRENT_PATHS,
                         ids=[f"{a}-{n}" for a, n, _ in RECURRENT_PATHS])
def test_recurrent_greedy_streams_equal_reference(recurrent, arch, name,
                                                  fields):
    """rwkv6 and hymba reduced on perturbed weights: the dense cache with
    parallel chunked prefill (hymba's first chunks also through the flash
    kernel's path) and with the scan anchor, rwkv's ignored page size, and
    hymba's paged ring (pages of 4 rows, 2 per 8-row ring) give the
    reference's greedy streams, with the same resolved paths."""
    jmodel, jparams, tmodel, tparams = recurrent[arch]
    fields = dict(dict(s_max=REC_S_MAX, batch_slots=3), **fields)
    jeng = JEngine(jmodel, jparams, **JConfig(**fields).engine_kwargs())
    teng = TEngine(tmodel, tparams, **TConfig(device="cpu",
                                              **fields).engine_kwargs())
    assert (teng.paged, teng.prefix_cache, teng.prefill_attn_impl,
            teng.paged_attn_impl, teng.prefill_mode) == \
        (jeng.paged, jeng.prefix_cache, jeng.prefill_attn_impl,
         jeng.paged_attn_impl, jeng.prefill_mode)
    if teng.paged:
        assert teng.capacity == jeng.capacity == 8
        assert teng.cache["ring_iota"].shape == (8,)
    prompts = _recurrent_prompts(tmodel.cfg.vocab_size)
    want = _serve(jeng, [prompts])
    got = _serve(teng, [prompts])
    assert got == want and all(len(s) == GEN for s in got)
    if teng.paged:
        teng.assert_page_invariants()
        assert teng.allocator.free == teng.num_pages


def test_rwkv_page_size_warns_and_serves_dense(recurrent, caplog):
    """As the reference: a page size on the SSM family logs that the state
    is O(1) in s_max, and the engine serves the dense cache, prefix cache
    off (tests/test_paged.py:145, tests/test_prefix.py:106)."""
    jmodel, jparams, tmodel, tparams = recurrent["rwkv6-7b"]
    kw = dict(batch_slots=2, s_max=16, page_size=8)
    with caplog.at_level(logging.WARNING):
        jeng = JEngine(jmodel, jparams, **kw)
        teng = TEngine(tmodel, tparams, device="cpu", **kw)
    warned = [r.getMessage() for r in caplog.records
              if "ignoring paging" in r.getMessage()]
    assert len(warned) == 2 and warned[0] == warned[1]
    assert not teng.paged and not teng.prefix_cache and not jeng.paged
    assert set(teng.cache) == {"S", "x_tm", "x_cm", "pos"}
    req = teng.submit(np.array([1, 2, 3], np.int32), 4)
    teng.run()
    assert req.done and len(req.tokens) == 4


@pytest.mark.parametrize("prefix_cache", [None, True])
def test_prefix_cache_stays_off_for_recurrent_families(recurrent, caplog,
                                                       prefix_cache):
    """The prefix cache needs an attention-only family: on hymba's paged
    ring it stays off by itself (None) or warns and falls back (True), as
    the reference does, and the streams equal prefix-off streams."""
    jmodel, jparams, tmodel, tparams = recurrent["hymba-1.5b"]
    kw = dict(batch_slots=2, s_max=REC_S_MAX, page_size=REC_PS)
    with caplog.at_level(logging.WARNING):
        jeng = JEngine(jmodel, jparams, prefix_cache=prefix_cache, **kw)
        teng = TEngine(tmodel, tparams, device="cpu",
                       prefix_cache=prefix_cache, **kw)
    assert not teng.prefix_cache and not jeng.prefix_cache
    warned = [r for r in caplog.records
              if "prefix_cache unsupported" in r.getMessage()]
    assert len(warned) == (2 if prefix_cache else 0)
    off = TEngine(tmodel, tparams, device="cpu", prefix_cache=False, **kw)
    prompts = _recurrent_prompts(tmodel.cfg.vocab_size)[:4]
    assert _serve(teng, [prompts]) == _serve(off, [prompts])
    assert teng.metrics.summary()["prefix"]["lookups"] == 0


def test_defaults_serve_the_reference_default_arch(monkeypatch, capsys):
    """``ServeEngine.build()`` and the CLI serve the reference's default
    arch, hymba-1.5b."""
    import inspect

    from repro.launch import serve as jcli
    from repro_torch.launch import serve as cli
    jdefault = inspect.signature(JEngine.build).parameters["arch"].default
    assert inspect.signature(TEngine.build).parameters["arch"].default == \
        jdefault == jcli.ServeConfig().arch == "hymba-1.5b"
    archs = []
    build = TEngine.build.__func__

    def spy(cls, arch=jdefault, *, config=None):
        archs.append(arch)
        return build(cls, arch, config=config)

    monkeypatch.setattr(TEngine, "build", classmethod(spy))
    cli.main(["--device", "cpu", "--requests", "1", "--prompt-len", "3",
              "--gen-len", "2"])
    assert archs == [jdefault]
    engine = TEngine.build(config=TConfig(device="cpu"))
    assert engine.cfg.name == jdefault and "slot_pos" in engine.cache
    assert "served 1 requests on cpu" in capsys.readouterr().out


def test_cli_fails_when_a_prefill_chunk_fails(monkeypatch, capsys):
    """The engine catches a chunk that raises and aborts its request; the
    CLI exits 1 on that and counts the failures in its ``--json``
    summary, so a kernel that does not launch cannot pass as a run."""
    import json

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve as cli
    args = ["--device", "cpu", "--arch", "qwen2.5-32b", "--page-size", "16",
            "--requests", "2", "--prompt-len", "20", "--gen-len", "2",
            "--json"]
    assert cli.main(args) == 0
    s, _ = json.JSONDecoder().raw_decode(capsys.readouterr().out)
    assert (s["prefill_failures"], s["completed"]) == (0, 2)

    def fails(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(kops, "paged_prefill", fails)
    assert cli.main(args) == 1
    out = capsys.readouterr().out
    s, _ = json.JSONDecoder().raw_decode(out)
    # both prompts have one length, so they share one grouped job
    assert (s["prefill_failures"], s["completed"], s["aborted"]) == (1, 0, 2)
    assert "2 of 2 requests not completed, 1 prefill chunk(s) failed" in out


@pytest.mark.parametrize("arch", ["dbrx-132b", "whisper-large-v3"])
def test_families_outside_the_port_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        TEngine.build(arch, config=TConfig(device="cpu"))


# ---------------------------------------- cancellation and failure release
def _lockstep_pair(reference, **kw):
    """The reference engine and the port's over the same weights."""
    jeng = JEngine(reference.model, reference.params, **kw)
    teng = _port_engine(reference, **dict(dict(page_size=None), **kw))
    return jeng, teng


def _same(jeng, teng, pairs):
    """Request states, slots, tokens and errors, free pages, the aborted /
    completed counts and the page invariants agree."""
    for a, b in pairs:
        assert (a.state.value, a.slot, list(a.tokens), a.error) == \
            (b.state.value, b.slot, list(b.tokens), b.error), a.rid
    assert (jeng.free_pages, jeng.active, jeng.scheduler.waiting,
            len(jeng._jobs), jeng.prefill_failures) == \
        (teng.free_pages, teng.active, teng.scheduler.waiting,
         len(teng._jobs), teng.prefill_failures)
    js, ts = jeng.metrics.summary(), teng.metrics.summary()
    assert (js["aborted"], js["completed"], js["aborted_tokens"]) == \
        (ts["aborted"], ts["completed"], ts["aborted_tokens"])
    jeng.assert_page_invariants()
    teng.assert_page_invariants()


def _until(jeng, teng, pairs, done, ticks=200):
    for _ in range(ticks):
        if done():
            return
        jeng.step()
        teng.step()
        _same(jeng, teng, pairs)
    raise AssertionError("condition not reached")


def _both(jeng, teng, pairs, prompt, gen):
    prompt = np.asarray(prompt, np.int32)
    pairs.append((jeng.submit(prompt, gen), teng.submit(prompt, gen)))
    return pairs[-1][1]


def test_cancel_in_every_state_equals_reference(reference):
    """cancel() from RUNNING, PREFILLING (a job's only member) and QUEUED,
    then double cancels and a cancel after completion, step for step with
    the reference: slots, pages and counts are released alike and the
    survivor's stream is unchanged."""
    jeng, teng = _lockstep_pair(reference, batch_slots=1, s_max=32,
                                page_size=8, prefill_chunk_tokens=2,
                                prefix_cache=False)
    pairs = []
    rng = np.random.default_rng(4)
    running = _both(jeng, teng, pairs, rng.integers(0, 512, 5), 8)
    _until(jeng, teng, pairs, lambda: running.state is RequestState.RUNNING)
    prefilling = _both(jeng, teng, pairs, np.arange(1, 13), 4)
    queued = _both(jeng, teng, pairs, rng.integers(0, 512, 7), 4)
    survivor = _both(jeng, teng, pairs, rng.integers(0, 512, 5), 3)
    assert jeng.cancel(pairs[0][0].rid) and teng.cancel(running.rid)
    _same(jeng, teng, pairs)
    jeng.step()
    teng.step()
    _same(jeng, teng, pairs)
    assert prefilling.state is RequestState.PREFILLING
    for i in (1, 2, 2):
        assert jeng.cancel(pairs[i][0].rid) == teng.cancel(pairs[i][1].rid)
        _same(jeng, teng, pairs)
    assert teng.free_pages == teng.num_pages
    _until(jeng, teng, pairs, lambda: survivor.state is RequestState.DONE)
    assert (running.state, prefilling.state, queued.state) == \
        (RequestState.CANCELLED,) * 3
    assert not queued.tokens and queued.error == "cancelled"
    assert not teng.cancel(survivor.rid) and not teng.cancel(10_000)
    assert teng.free_pages == teng.num_pages
    assert sorted(r.rid for r in teng.drain_completed()) == \
        sorted(r.rid for r in jeng.drain_completed()) == [0, 1, 2, 3]
    assert not teng.requests and len(teng.metrics.requests) == 4


@pytest.mark.parametrize("page_size", [8, None], ids=["paged", "dense"])
def test_cancel_grouped_prefill_member_lands_at_splice(reference, page_size):
    """Cancelling one member of a batch-2 prefill job retires it at the
    group's splice without a token; its group-mate runs on."""
    jeng, teng = _lockstep_pair(reference, batch_slots=2, s_max=32,
                                page_size=page_size, prefill_chunk_tokens=2,
                                prefix_cache=False)
    pairs = []
    a = _both(jeng, teng, pairs, np.arange(1, 13), 4)
    b = _both(jeng, teng, pairs, np.arange(21, 33), 4)
    jeng.step()
    teng.step()
    _same(jeng, teng, pairs)
    assert a.state is b.state is RequestState.PREFILLING
    assert jeng.cancel(pairs[1][0].rid) and teng.cancel(b.rid)
    _same(jeng, teng, pairs)
    assert b.state is RequestState.PREFILLING       # lands at the splice
    _until(jeng, teng, pairs, lambda: a.state is RequestState.DONE)
    assert b.state is RequestState.CANCELLED and not b.tokens
    assert len(a.tokens) == 4
    assert teng.free_pages == (teng.num_pages if page_size else 0)


def test_prefill_failure_releases_the_job_as_the_reference_does(
        reference, monkeypatch):
    """A chunk dispatch that raises mid-prefill FAILS its job through
    release_job on both engines: the same error, pages and slot back, one
    prefill failure counted, the engine serving on."""
    jeng, teng = _lockstep_pair(reference, batch_slots=2, s_max=32,
                                page_size=8, prefill_chunk_tokens=4,
                                prefix_cache=False)
    assert jeng.incremental_splice and teng.incremental_splice
    calls = {"j": 0, "t": 0}
    jreal = jeng._chunk_paged_fn
    treal = teng._chunk_paged

    def jflaky():
        fn = jreal()

        def wrapped(params, cache, batch):
            calls["j"] += 1
            if calls["j"] == 2:
                raise RuntimeError("injected chunk failure")
            return fn(params, cache, batch)
        return wrapped

    def tflaky(params, cache, batch):
        calls["t"] += 1
        if calls["t"] == 2:
            raise RuntimeError("injected chunk failure")
        return treal(params, cache, batch)

    monkeypatch.setattr(jeng, "_chunk_paged_fn", jflaky)
    teng._chunk_paged = tflaky
    pairs = []
    doomed = _both(jeng, teng, pairs, np.arange(1, 14), 4)
    for _ in range(2):
        jeng.step()
        teng.step()
        _same(jeng, teng, pairs)
    assert doomed.state is RequestState.FAILED
    assert "injected chunk failure" in doomed.error
    assert teng.prefill_failures == 1 and not teng._jobs
    assert teng.free_pages == teng.num_pages
    ok = _both(jeng, teng, pairs, np.arange(40, 47), 4)
    _until(jeng, teng, pairs, lambda: ok.state is RequestState.DONE)
    assert len(ok.tokens) == 4


def test_failed_chunk_leaves_a_running_bystander_serving(reference,
                                                        monkeypatch):
    """The held difference from the reference's poisoned-cache failover:
    the port donates no buffer, and a chunk writes only its own job's
    pages above ``write_floor``. A chunk that raises inside its second
    layer (after both layers wrote K/V into the doomed job's pages) fails
    only its job; the RUNNING bystander serves on with the stream of an
    undisturbed run, and the pool is whole afterwards."""
    from repro_torch.kernels import ops as kops
    kw = dict(batch_slots=2, s_max=32, page_size=8, prefill_chunk_tokens=4)
    rng = np.random.default_rng(9)
    by_prompt = rng.integers(0, 512, 6)
    alone = _port_engine(reference, **kw)
    want = alone.submit(by_prompt, 12)
    alone.run()

    teng = _port_engine(reference, **kw)
    assert teng.incremental_splice and teng.prefix_cache
    bystander = teng.submit(by_prompt, 12)
    while bystander.state is not RequestState.RUNNING:
        teng.step()
    real = kops.paged_prefill
    calls = {"n": 0}

    def fails_in_layer_1(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("kernel launch failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(kops, "paged_prefill", fails_in_layer_1)
    doomed = teng.submit(rng.integers(0, 512, 13), 4)
    teng.step()
    assert calls["n"] == 2 and doomed.state is RequestState.FAILED
    assert "kernel launch failed" in doomed.error
    assert bystander.state is RequestState.RUNNING
    assert teng.prefill_failures == 1
    teng.assert_page_invariants()
    monkeypatch.undo()
    after = teng.submit(rng.integers(0, 512, 9), 3)
    teng.run()
    assert list(bystander.tokens) == list(want.tokens)
    assert after.state is RequestState.DONE and len(after.tokens) == 3
    assert teng.free_pages + len(set(teng.prefix_index.pages)) == \
        teng.num_pages
    s = teng.metrics.summary()
    assert (s["aborted"], s["completed"]) == (1, 2)


def test_transient_path_failure_releases_a_grouped_job(references,
                                                      monkeypatch):
    """The transient (first-chunk) path, hymba's paged ring: a batch-2 job
    whose first chunk raises FAILS both members and frees every page."""
    teng = _port_engine(references("hymba-1.5b"), page_size=8)
    assert not teng.incremental_splice

    def boom(*a, **k):
        raise RuntimeError("boom")

    teng._chunk_first = boom
    a = teng.submit(np.arange(1, 9), 4)
    b = teng.submit(np.arange(1, 9), 4)
    teng.step()
    assert a.state is b.state is RequestState.FAILED
    assert teng.prefill_failures == 1
    assert teng.free_pages == teng.num_pages
    assert teng.transient_cache_bytes() == 0
    teng.assert_page_invariants()


def test_a_lost_device_after_a_failed_chunk_leaves_step(reference):
    """After a caught chunk failure the engine synchronises the device; if
    that raises too (on the card: a sticky CUDA error, the context is
    lost), the error leaves step() instead of being failed over."""
    teng = _port_engine(reference, batch_slots=2, s_max=32, page_size=8)

    def chunk(*a, **k):
        raise RuntimeError("an illegal memory access was encountered")

    def lost_sync():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    teng._chunk_paged = chunk
    teng._sync = lost_sync
    teng.submit(np.arange(1, 9), 4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        teng.step()
    assert teng.prefill_failures == 1


def test_build_keyword_spelling_is_deprecated_as_in_reference():
    """``ServeEngine.build(arch, **fields)``: a DeprecationWarning and the
    same engine as ``config=``; both spellings at once, or an unknown
    keyword, raise the reference's errors."""
    with pytest.warns(DeprecationWarning, match="deprecated"):
        eng = TEngine.build("qwen2.5-32b", page_size=PS, s_max=S_MAX,
                            batch_slots=2, device="cpu")
    assert (eng.page_size, eng.s_max, eng.batch_slots) == (PS, S_MAX, 2)
    for kwargs in (dict(config=TConfig(device="cpu"), page_size=PS),
                   dict(bogus=1)):
        jkw = {k: (JConfig() if k == "config" else v)
               for k, v in kwargs.items()}
        with pytest.raises((ValueError, TypeError)) as want:
            JEngine.build("qwen2.5-32b", **jkw)
        with pytest.raises(type(want.value)) as got:
            TEngine.build("qwen2.5-32b", **kwargs)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
