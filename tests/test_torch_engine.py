"""The port's serving engine against ``repro.serve.ServeEngine`` on the
reduced qwen2.5-32b (s_max 64, 4 slots) with bridged weights: greedy token
streams are equal over mixed prompt lengths and shared prefixes, on the
paged kernel path (page_size 16) with the prefix cache on and off — and so
are the prefix-hit / copy-on-write counters — and on the transient paths:
the dense cache with the einsum or the flash kernel on the first chunk,
the scan prefill, the paged einsum path with the prefix cache on and off,
and the ``page_size == s_max`` anchor, which the port also holds bit for
bit to its own dense engine. Also: ``chain_hash`` keys are byte-equal,
``ServeConfig.validate()`` messages are equal, the prefix-cache rule falls
back with a warning where unsupported, and an entry point with no device
given raises on a host without CUDA."""
import logging

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import prefix as jprefix  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import ServeConfig as TConfig  # noqa: E402
from repro_torch.serve import SchedPolicy as TPolicy  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
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
        tconfigs.get_config("qwen2.5-32b")))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                      "cpu")
    fields = dict(dict(page_size=PS, s_max=S_MAX), **fields)
    return TEngine(model, params, **TConfig(
        prefix_cache=prefix_cache, device="cpu", **fields).engine_kwargs())


@pytest.mark.parametrize("prefix_cache", [None, False])
def test_greedy_streams_equal_reference(reference, prefix_cache):
    """Same weights, same requests: identical greedy streams and identical
    prefix-cache counters (lookups, hits, hit tokens, shared pages, COW
    copies, evictions), with the prefix cache on by itself and off."""
    ref = reference
    jeng = JEngine(ref.model, ref.params, **JConfig(
        page_size=PS, s_max=S_MAX, prefix_cache=prefix_cache).engine_kwargs())
    teng = _port_engine(ref, prefix_cache=prefix_cache)
    assert teng.prefix_cache == jeng.prefix_cache
    waves = _waves(ref.cfg.vocab_size)
    want = _serve(jeng, waves)
    got = _serve(teng, waves)
    assert got == want
    assert all(len(s) == GEN for s in got)
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
    for config in (TConfig(page_size=PS, device="cpu"),
                   TConfig(device="cpu")):
        cpu = TEngine.build("qwen2.5-32b", config=config)
        assert cpu.device.type == "cpu"
        assert cpu.cache["k"].device.type == "cpu"
        assert cpu.paged == (config.page_size is not None)
    assert cpu.prefill_attn_impl == "einsum"    # 'auto' off the card
    assert tuple(cpu.cache["k"].shape) == (2, 4, 64, 1, 16)


@pytest.mark.parametrize("kw", [dict(temperature=0.5),
                                dict(kv_backend="paged_int8"),
                                dict(kv_backend="paged_latent"),
                                dict(policy=TPolicy(drr=True)),
                                dict(policy=TPolicy(
                                    max_consecutive_prefill_ticks=2))])
def test_configs_outside_the_slice_name_their_roadmap_item(reference, kw):
    teng = _port_engine(reference)
    args = dict(batch_slots=2, s_max=S_MAX, page_size=PS, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        TEngine(teng.model, teng.params, **args)


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
