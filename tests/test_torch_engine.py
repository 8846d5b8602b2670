"""The port's serving engine against ``repro.serve.ServeEngine`` on the
reduced qwen2.5-32b (page_size 16, s_max 64, 4 slots) with bridged weights:
greedy token streams are equal over mixed prompt lengths and shared
prefixes, with the prefix cache on and off, and so are the prefix-hit /
copy-on-write counters. Also: ``chain_hash`` keys are byte-equal,
``ServeConfig.validate()`` messages are equal, and an entry point with no
device given raises on a host without CUDA."""
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
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve import prefix as tprefix  # noqa: E402

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


def _port_engine(ref, prefix_cache=None):
    """The port's engine over the reference's weights, built from the same
    ServeConfig fields the reference was (plus device='cpu')."""
    model = treg.get_model(treg.reduced_config(
        tconfigs.get_config("qwen2.5-32b")))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                      "cpu")
    return TEngine(model, params, **TConfig(
        page_size=PS, s_max=S_MAX, prefix_cache=prefix_cache,
        device="cpu").engine_kwargs())


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
    cpu = TEngine.build("qwen2.5-32b", config=TConfig(page_size=PS,
                                                      device="cpu"))
    assert cpu.device.type == "cpu" and cpu.cache["k"].device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(temperature=0.5), dict(page_size=None),
                                dict(prefill_mode="scan"),
                                dict(paged_attn_impl="einsum"),
                                dict(page_size=S_MAX)])
def test_configs_outside_the_slice_name_their_roadmap_item(reference, kw):
    teng = _port_engine(reference)
    args = dict(batch_slots=2, s_max=S_MAX, page_size=PS, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        TEngine(teng.model, teng.params, **args)
