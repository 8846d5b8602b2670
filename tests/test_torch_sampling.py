"""Sampling in the port's engine against ``repro``'s.

``_filter_logits`` has no randomness: on seeded logits with planted ties
(V = 512, and a row at qwen2.5-32b's 152,064) its finite mask and kept
values equal the reference's exactly over a grid of ``top_k`` x ``top_p``.
Torch cannot replay JAX's PRNG, so sampled tokens are held by their
properties, on the reduced qwen2.5-32b and hymba-1.5b with the reference's
weights bridged through numpy: ``top_k=1`` and a vanishing ``top_p`` give
the reference's greedy stream, one seed gives one stream twice and
another seed another, every sampled token lies in the filtered row's kept
set, and the Gumbel-max draw follows softmax(logits / temperature).
``temperature == 0`` stays the argmax stream, and the argument checks
raise the reference's messages."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import ServeConfig as TConfig  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

S_MAX, PS = 64, 16
QWEN_VOCAB = 152_064


def _rows(V, seed):
    """(5, V) float32 logits: normal rows at three scales, a row of small
    integers (ties everywhere, at the k-th value too) and a normal row
    whose top values are planted in pairs and triples."""
    rng = np.random.default_rng(seed)
    rows = [rng.normal(0, s, V) for s in (0.5, 2.0, 6.0)]
    rows.append(rng.integers(-4, 5, V).astype(np.float64))
    tied = rng.normal(0, 2.0, V)
    top = np.argsort(-tied)[:9]
    tied[top[:2]] = tied[top[0]]
    tied[top[2:5]] = tied[top[2]]
    tied[top[5:9]] = tied[top[5]]
    rows.append(tied)
    return np.stack(rows).astype(np.float32)


def _filter_both(x, top_k, top_p):
    ns = types.SimpleNamespace(top_k=top_k, top_p=top_p)
    want = np.asarray(JEngine._filter_logits(ns, jnp.asarray(x)))
    got = TEngine._filter_logits(ns, torch.from_numpy(x)).numpy()
    return got, want


def _assert_same_filter(got, want):
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(np.where(np.isfinite(want), got, 0.0),
                          np.where(np.isfinite(want), want, 0.0))
    assert np.isfinite(got).any(axis=-1).all()   # a row never empties


@pytest.mark.parametrize("top_k", [0, 1, 2, 5, 50, 511, 512, 600])
@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.9, 0.5, 0.1, 1e-9])
def test_filter_logits_equals_reference(top_k, top_p):
    x = _rows(512, seed=3)
    got, want = _filter_both(x, top_k, top_p)
    _assert_same_filter(got, want)
    if top_k == 1 and top_p == 1.0:
        # ties at the k-th value are kept: the planted pair keeps both
        assert (np.isfinite(got[4]).sum(), np.isfinite(got[0]).sum()) == \
            (2, 1)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (50, 1.0), (50, 0.9),
                                         (0, 1e-9)])
def test_filter_logits_equals_reference_at_qwen_vocab(top_k, top_p):
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 4.0, (1, QWEN_VOCAB))).astype(np.float32)
    got, want = _filter_both(x, top_k, top_p)
    _assert_same_filter(got, want)


# ------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def references():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = JEngine.build(arch, config=JConfig(s_max=S_MAX))
        return built[arch]
    return get


def _port(ref, **kw):
    """The port's engine over the reference engine's weights."""
    model = treg.get_model(treg.reduced_config(
        tconfigs.get_config(ref.cfg.name)))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                      "cpu")
    return TEngine(model, params, **TConfig(s_max=S_MAX, device="cpu",
                                            **kw).engine_kwargs())


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n) for n in (8, 21, 8, 40)]


def _streams(engine, prompts, gen=8):
    reqs = [engine.submit(p, gen) for p in prompts]
    engine.run()
    assert all(r.state.value == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


def _reference_greedy(ref, prompts):
    jeng = JEngine(ref.model, ref.params, batch_slots=4, s_max=S_MAX)
    return _streams(jeng, prompts)


ARCHS = ["qwen2.5-32b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_p=1e-9)],
                         ids=["top_k=1", "top_p=1e-9"])
def test_degenerate_filters_give_the_reference_greedy_stream(references,
                                                             arch, kw):
    ref = references(arch)
    prompts = _prompts(ref.cfg.vocab_size)
    want = _reference_greedy(ref, prompts)
    got = _streams(_port(ref, temperature=0.8, seed=3, **kw), prompts)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_temperature_zero_is_the_reference_greedy_stream(references, arch):
    ref = references(arch)
    prompts = _prompts(ref.cfg.vocab_size)
    eng = _port(ref, top_k=5, top_p=0.5, seed=9)
    seeded = eng._gen.get_state()
    assert _streams(eng, prompts) == _reference_greedy(ref, prompts)
    assert torch.equal(eng._gen.get_state(), seeded)   # no draw was made


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_sampling_is_reproducible_and_in_the_kept_set(references,
                                                             arch):
    ref = references(arch)
    prompts = _prompts(ref.cfg.vocab_size)
    V = ref.cfg.vocab_size

    def sampled(seed):
        eng = _port(ref, temperature=0.9, top_k=50, top_p=0.9, seed=seed)
        kept = []
        filt, sample = eng._filter_logits, eng._sample_rows

        def keep_filtered(scaled):
            out = filt(scaled)
            kept.append(torch.isfinite(out))
            return out

        def checked(logits):
            toks = sample(logits)
            ok = kept.pop()
            assert ok.shape[-1] == V
            assert all(0 <= t < V and ok[i, t] for i, t in enumerate(toks))
            return toks

        eng._filter_logits, eng._sample_rows = keep_filtered, checked
        seeded = eng._gen.get_state()
        streams = _streams(eng, prompts, gen=10)
        assert not kept and not torch.equal(eng._gen.get_state(), seeded)
        return streams

    a, b, c = sampled(7), sampled(7), sampled(8)
    assert a == b
    assert a != c
    assert a != _reference_greedy(ref, prompts)


def test_gumbel_draw_follows_the_softmax(references):
    """Many draws over one filtered row land on each token at its softmax
    probability: top_k=3 of 6 logits at temperature 2, 40,000 rows."""
    eng = _port(references("qwen2.5-32b"), temperature=2.0, top_k=3, seed=1)
    eng.cfg = types.SimpleNamespace(vocab_size=6)
    base = torch.tensor([0.0, 1.0, 3.0, 2.0, -1.0, 2.5])
    logits = base.expand(40_000, 1, 6).clone()
    toks = eng._sample_rows(logits)
    freq = np.bincount(toks, minlength=6) / len(toks)
    kept = base.clone()
    kept[[0, 1, 4]] = -torch.inf
    want = torch.softmax(kept / 2.0, dim=-1).numpy()
    assert freq[[0, 1, 4]].sum() == 0
    assert np.abs(freq - want).max() < 0.01


def test_sampling_arguments_raise_the_reference_messages(references):
    ref = references("qwen2.5-32b")
    teng = _port(ref)
    for kw in (dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5),
               dict(prefill_mode="bogus")):
        with pytest.raises(ValueError) as want:
            JEngine(ref.model, ref.params, batch_slots=1, s_max=S_MAX, **kw)
        with pytest.raises(ValueError) as got:
            TEngine(teng.model, teng.params, batch_slots=1, s_max=S_MAX,
                    device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_seed_reaches_the_engine():
    """ServeConfig.engine_kwargs passes the reference's keys (seed among
    them) plus the device."""
    tk = TConfig(seed=5, device="cpu").engine_kwargs()
    jk = JConfig(seed=5).engine_kwargs()
    assert set(tk) - set(jk) == {"device"}
    assert set(jk) <= set(tk)
    assert tk["seed"] == jk["seed"] == 5
