"""The five architectures the port serves beside the dense, MLA and
recurrent ones, each against ``repro`` on its reduced config with bridged
weights: command-r-35b (dense, LayerNorm), dbrx-132b and moonshot-v1-16b-a3b
(MoE: 4 experts, top 2, GShard capacity), llama-3.2-vision-11b (VLM: 2
super-layers of 5 blocks and a gated cross block over 8 image tokens) and
whisper-large-v3 (encoder-decoder: 2 + 2 layers, the encoder over 1500
frames, cross K/V in the cache).

* the forward (the VLM on seeded nonzero image embeddings with seeded
  gates, whisper on seeded frames), the port's flash route included;
* dense prefill chunks (a first chunk through the step builder, which for
  whisper runs the encoder and the cross K/V, then a continuation) and
  decode steps, logits and every cache leaf;
* a paged prefill chunk and decode steps through the kernel and the
  einsum read paths (whisper: its transient first chunk spliced into
  pages, then paged decode);
* engine streams on the dense cache, on pages of 16 with the prefix cache
  on and off, and on int8 pages for the families that take them;
* a dbrx decode tick whose first row is a freed slot, where capacity
  binds.

The VLM's cross gates start at 0 in ``repro`` (tanh(0) = 0) and serving
passes zero image embeddings, which leave nothing of the cross block to
check; the weights here carry seeded gates, and the model tests feed
seeded image embeddings. Serving keeps ``repro``'s zero stub.

Logits and cache leaves are allclose at rtol 1e-4, atol 1e-5 (the same
fp32 network, summed in another order); greedy streams are equal. MoE
routing is discontinuous, so equal streams also say every routing choice
and every capacity drop agreed. Int8 pages are held as the other int8
tests hold them: streams and prefix counters equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import ServeConfig as TConfig  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
PS, S_MAX, P = 16, 64, 12
INACTIVE = 1 << 30
ARCHS = ["command-r-35b", "dbrx-132b", "moonshot-v1-16b-a3b",
         "llama-3.2-vision-11b", "whisper-large-v3"]
PAGED_ARCHS = ARCHS[:4]          # whisper has no paged prefill chunk
INT8_ARCHS = ("command-r-35b", "dbrx-132b", "llama-3.2-vision-11b")


@pytest.fixture(scope="module")
def fam():
    """arch -> (reference model, its weights, the port's model, the same
    weights bridged), built once; the VLM's cross gates seeded."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jreg.reduced_config(jconfigs.get_config(arch))
            tcfg = treg.reduced_config(tconfigs.get_config(arch))
            jmodel = jreg.get_model(jcfg)
            params = jax.tree.map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
            if jcfg.cross_attn_every:
                gate = params["super"]["cross"]["gate"]
                params["super"]["cross"]["gate"] = np.random.default_rng(
                    7).normal(0, 1, gate.shape).astype(np.float32)
            built[arch] = (jmodel, jax.tree.map(jnp.asarray, params),
                           treg.get_model(tcfg),
                           bridge.params_from_numpy(params, "cpu"))
        return built[arch]
    return get


_JITTED = {}


def _ref(jmodel, name, **static):
    """``jmodel.<name>`` compiled once per (model, name, static kwargs)
    and kept: the reference as its engine runs it, and each step after
    the first without tracing again."""
    key = (jmodel, name, tuple(sorted(static.items())))
    if key not in _JITTED:
        fn = getattr(jmodel, name)
        _JITTED[key] = jax.jit(lambda *a, **k: fn(*a, **static, **k))
    return _JITTED[key]


def _extras(cfg, rng, batch):
    """Seeded stub inputs: image embeddings for the VLM, frames for
    whisper (numpy)."""
    if cfg.cross_attn_every:
        return {"image_embeds": rng.normal(
            0, 1, (batch, cfg.num_image_tokens, cfg.d_model)
        ).astype(np.float32)}
    if cfg.encoder_layers:
        return {"frames": rng.normal(0, 1, (batch, 1500, cfg.d_model)
                                     ).astype(np.float32)}
    return {}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_leaves(jc, tc, keys=("k", "v", "xk", "xv")):
    for key in keys:
        if key in jc:
            _close(tc[key], jc[key])


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(fam, arch, impl):
    """The full-sequence forward on (2, 16) tokens: logits and the MoE
    losses. The reference runs its einsum; the port its einsum and its
    flash route ('pallas', the plain version off the card), which for
    whisper takes the encoder's 1500 frames, not causal."""
    jmodel, jparams, tmodel, tparams = fam(arch)
    cfg = jmodel.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    extras = _extras(cfg, rng, 2)
    jl, jaux = _ref(jmodel, "forward", compute_dtype=jnp.float32)(
        jparams, jnp.asarray(toks), **_j(extras))
    tl, taux = tmodel.forward(tparams, torch.from_numpy(toks).long(),
                              attn_impl=impl, **_t(extras))
    _close(tl, jl)
    for key in ("moe_aux", "moe_z"):
        _close(taux[key], jaux[key])
    if cfg.moe:
        assert float(taux["moe_aux"]) > 0 and float(taux["moe_z"]) > 0


def test_vlm_cross_block_is_live(fam):
    """The seeded gates and image embeddings reach the logits: other
    image embeddings give other logits (with repro's zero gates they would
    not)."""
    jmodel, _, tmodel, tparams = fam("llama-3.2-vision-11b")
    cfg = tmodel.cfg
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 6)))
    a, b = (_t(_extras(cfg, rng, 1)) for _ in range(2))
    la, _ = tmodel.forward(tparams, toks, **a)
    lb, _ = tmodel.forward(tparams, toks, **b)
    assert (la - lb).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_chunks_then_decode_match_reference(fam, arch):
    """Dense cache, 2 requests: a 12-token first chunk through the step
    builder (whisper: one encoder pass and the cross K/V inside it), a
    5-token continuation, then 4 decode steps on the reference's greedy
    tokens; logits and every cache leaf allclose after each call."""
    jmodel, jparams, tmodel, tparams = fam(arch)
    cfg = jmodel.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    extras = _extras(cfg, rng, 2)
    step_extras = {k: v for k, v in extras.items() if k != "frames"}
    jfirst = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32,
                                       s_max=S_MAX, first=True)
    tfirst = tsteps.make_prefill_chunk(tmodel, s_max=S_MAX, first=True,
                                       compute_dtype=torch.float32)
    jl, jc = jfirst(jparams, {"tokens": jnp.asarray(toks[:, :12]),
                              **_j(extras)})
    tl, tc = tfirst(tparams, {"tokens": torch.from_numpy(toks[:, :12]),
                              **_t(extras)})
    _close(tl, jl)
    _cache_leaves(jc, tc)
    jl, jc = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32)(
        jparams, jc, {"tokens": jnp.asarray(toks[:, 12:]),
                      **_j(step_extras)})
    tl, tc = tsteps.make_prefill_chunk(tmodel,
                                       compute_dtype=torch.float32)(
        tparams, tc, {"tokens": torch.from_numpy(toks[:, 12:]),
                      **_t(step_extras)})
    _close(tl, jl)
    _cache_leaves(jc, tc)
    assert int(tc["pos"]) == int(jc["pos"]) == 17
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl[:, 0, :cfg.vocab_size], -1),
                         np.int32)[:, None]
        assert np.array_equal(
            tl[:, 0, :cfg.vocab_size].argmax(-1).numpy(), nxt[:, 0])
        jl, jc = _ref(jmodel, "decode_step", compute_dtype=jnp.float32)(
            jparams, jnp.asarray(nxt), jc, **_j(step_extras))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt).long(),
                                    tc, **_t(step_extras))
        _close(tl, jl)
        _cache_leaves(jc, tc)


def _paged_pair(jmodel, tmodel, bt, pos, batch=3, **kw):
    jc = jreg.init_paged_cache(jmodel, batch, S_MAX, page_size=PS,
                               num_pages=P, dtype=jnp.float32)
    jc = dict(jc, block_tables=jnp.asarray(bt), pos=jnp.asarray(pos))
    tc = treg.init_paged_cache(tmodel, batch, S_MAX, page_size=PS,
                               num_pages=P, device="cpu")
    tc["block_tables"].copy_(torch.from_numpy(bt))
    tc["pos"].copy_(torch.from_numpy(pos))
    assert set(jc) == set(tc)
    for key in jc:
        assert tuple(jc[key].shape) == tuple(tc[key].shape), key
    return jc, tc


def _paged_decode(jmodel, jparams, tmodel, tparams, jc, tc, jl, live, impl,
                  extras, steps=4):
    """``steps`` decode steps fed the reference's greedy tokens; logits of
    every row (live and parked) and every cache leaf allclose."""
    cfg = jmodel.cfg
    B = tc["pos"].shape[0]
    nxt = np.zeros((B, 1), np.int32)
    nxt[live, 0] = np.asarray(jnp.argmax(jl[:, 0, :cfg.vocab_size], -1))
    for _ in range(steps):
        jl, jc = _ref(jmodel, "decode_step", compute_dtype=jnp.float32,
                      paged_attn_impl=impl)(jparams, jnp.asarray(nxt), jc,
                                            **_j(extras))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt).long(),
                                    tc, paged_attn_impl=impl, **_t(extras))
        _close(tl, jl)
        _cache_leaves(jc, tc)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        nxt[live, 0] = np.asarray(jnp.argmax(jl[live, 0, :cfg.vocab_size],
                                             -1))
        assert np.array_equal(
            tl[live, 0, :cfg.vocab_size].argmax(-1).numpy(), nxt[live, 0])
    return jc, tc


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_chunk_then_decode_match_reference(fam, arch, impl):
    """Slots 0 and 1 prefill a 24-token chunk jointly (two pages each);
    slot 2 holds pages but is still at INACTIVE_POS, so its writes drop
    but its row still routes through the experts. Then 4 decode steps, the
    three rows' logits and both pools allclose throughout."""
    jmodel, jparams, tmodel, tparams = fam(arch)
    cfg = jmodel.cfg
    bt = np.asarray([[3, 7, 1, 10], [0, 5, 9, 2], [4, 6, -1, -1]], np.int32)
    jc, tc = _paged_pair(jmodel, tmodel, bt, np.full((3,), INACTIVE,
                                                     np.int32))
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    chunk_x, decode_x = _extras(cfg, rng, 2), _extras(cfg, rng, 3)
    jl, jc = _ref(jmodel, "prefill_chunk_paged", compute_dtype=jnp.float32,
                  attn_impl=impl)(
        jparams, jnp.asarray(toks), jc, bt_rows=jnp.asarray(bt[:2]),
        start=0, write_floor=0, **_j(chunk_x))
    tl, tc = tmodel.prefill_chunk_paged(
        tparams, torch.from_numpy(toks).long(), tc,
        bt_rows=torch.from_numpy(bt[:2]), start=0, write_floor=0,
        attn_impl=impl, **_t(chunk_x))
    _close(tl, jl)
    _cache_leaves(jc, tc)
    pos = np.asarray([24, 24, INACTIVE], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"].copy_(torch.from_numpy(pos))
    _paged_decode(jmodel, jparams, tmodel, tparams, jc, tc, jl, [0, 1],
                  impl, decode_x)


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_whisper_transient_chunk_spliced_into_pages(fam, impl):
    """Whisper prefills through the transient path on pages too: a
    20-token first chunk (encoder and cross K/V included) for two
    requests, spliced into slots 0 and 2 of a paged cache by
    ``insert_cache_rows_paged`` (the cross K/V on the batch axis, the
    self-attention rows into their pages), then 4 paged decode steps."""
    jmodel, jparams, tmodel, tparams = fam("whisper-large-v3")
    cfg = jmodel.cfg
    bt = np.asarray([[3, 7, 1, 10], [4, 6, -1, -1], [0, 5, 9, 2]], np.int32)
    jc, tc = _paged_pair(jmodel, tmodel, bt, np.full((3,), INACTIVE,
                                                     np.int32))
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    frames = _extras(cfg, rng, 2)
    jl, jr = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32,
                                       s_max=S_MAX, first=True)(
        jparams, {"tokens": jnp.asarray(toks), **_j(frames)})
    tl, tr = tsteps.make_prefill_chunk(tmodel, s_max=S_MAX, first=True,
                                       compute_dtype=torch.float32)(
        tparams, {"tokens": torch.from_numpy(toks), **_t(frames)})
    _close(tl, jl)
    slots = np.asarray([0, 2])
    j = np.arange(S_MAX)
    phys = (bt[slots][:, j // PS] * PS + j % PS).astype(np.int64)
    jc = jreg.insert_cache_rows_paged(jc, jr, jnp.asarray(slots),
                                      jnp.asarray(phys))
    tc = treg.insert_cache_rows_paged(tc, tr, torch.from_numpy(slots),
                                      torch.from_numpy(phys))
    _cache_leaves(jc, tc)
    _paged_decode(jmodel, jparams, tmodel, tparams, jc, tc, jl,
                  list(slots), impl, {})


def test_dbrx_tick_with_a_freed_slot_ahead_where_capacity_binds(fam):
    """A decode tick of 8 slots whose first row is a freed slot (all--1
    block table, INACTIVE_POS): it still routes, first in the group's
    token order, and takes capacity (4 experts x cap 5 for 16 choices)
    from the live rows after it. Through both read paths the logits of
    all 8 rows equal the reference's, and in some layer a live row's
    choice was dropped."""
    jmodel, jparams, tmodel, tparams = fam("dbrx-132b")
    cfg = jmodel.cfg
    B, mps = 8, S_MAX // PS
    bt = np.full((B, mps), -1, np.int32)
    bt[1:, :2] = np.arange(14, dtype=np.int32).reshape(7, 2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (7, 20)).astype(np.int32)
    for impl in ("kernel", "einsum"):
        jc = jreg.init_paged_cache(jmodel, B, S_MAX, page_size=PS,
                                   num_pages=16, dtype=jnp.float32)
        jc = dict(jc, block_tables=jnp.asarray(bt))
        tc = treg.init_paged_cache(tmodel, B, S_MAX, page_size=PS,
                                   num_pages=16, device="cpu")
        tc["block_tables"].copy_(torch.from_numpy(bt))
        jl, jc = _ref(jmodel, "prefill_chunk_paged",
                      compute_dtype=jnp.float32, attn_impl=impl)(
            jparams, jnp.asarray(toks), jc, bt_rows=jnp.asarray(bt[1:]),
            start=0, write_floor=0)
        tl, tc = tmodel.prefill_chunk_paged(
            tparams, torch.from_numpy(toks).long(), tc,
            bt_rows=torch.from_numpy(bt[1:]), start=0, write_floor=0,
            attn_impl=impl)
        _close(tl, jl)
        pos = np.asarray([INACTIVE] + [20] * 7, np.int32)
        jc = dict(jc, pos=jnp.asarray(pos))
        tc["pos"].copy_(torch.from_numpy(pos))
        trace = []
        tL.MOE_TRACE = trace
        try:
            _paged_decode(jmodel, jparams, tmodel, tparams, jc, tc, jl,
                          list(range(1, 8)), impl, {}, steps=2)
        finally:
            tL.MOE_TRACE = None
        assert [t["cap"] for t in trace] == [5] * (2 * cfg.num_layers)
        assert any(not bool(t["kept"][1:].all()) for t in trace)


# ------------------------------------------------------------- serving
def _prompts(vocab):
    """Seven prompts of 1-40 tokens for 4 slots in two waves; four share
    a 20-token header X (one full page plus 4 rows): wave 1 registers X,
    wave 2 hits its full page and copies its partial one."""
    rng = np.random.default_rng(31)
    X = rng.integers(0, vocab, 20)
    tail = lambda n: rng.integers(0, vocab, n)  # noqa: E731
    return [[X, np.concatenate([X, tail(9)]), tail(13), tail(1)],
            [np.concatenate([X, tail(5)]), X, tail(40)]]


STREAM_CASES = [
    pytest.param(arch, name, fields, id=f"{arch}-{name}")
    for arch in ARCHS
    for name, fields in (
        ("dense", dict(page_size=None)),
        ("paged", dict()),
        ("paged-noprefix", dict(prefix_cache=False)),
        ("paged-int8", dict(kv_backend="paged_int8")))
    if not (arch == "whisper-large-v3" and name == "paged-noprefix")
    and not (name == "paged-int8" and arch not in INT8_ARCHS)]


@pytest.mark.parametrize("arch,name,fields", STREAM_CASES)
def test_engine_streams_equal_reference(fam, arch, name, fields):
    """Both engines over the same weights and requests, in two waves:
    equal greedy streams, equal resolved paths, and on pages equal prefix
    counters (on by itself for the attention families, off for whisper,
    whose encoder state is not page-resident and which prefills through the
    transient path with its decode through the paged kernel)."""
    jmodel, jparams, tmodel, tparams = fam(arch)
    fields = dict(dict(page_size=PS, s_max=S_MAX), **fields)
    jeng = JEngine(jmodel, jparams, **JConfig(**fields).engine_kwargs())
    teng = TEngine(tmodel, tparams, **TConfig(device="cpu",
                                              **fields).engine_kwargs())
    assert (teng.paged, teng.prefix_cache, teng.paged_attn_impl,
            teng.incremental_splice, type(teng.backend).__name__) == \
        (jeng.paged, jeng.prefix_cache, jeng.paged_attn_impl,
         jeng.incremental_splice, type(jeng.backend).__name__)
    if arch == "whisper-large-v3" and teng.paged:
        assert teng.paged_attn_impl == "kernel"
        assert not teng.incremental_splice and not teng.prefix_cache
    streams = []
    for eng in (jeng, teng):
        got = []
        for wave in _prompts(jmodel.cfg.vocab_size):
            reqs = [eng.submit(np.asarray(p, np.int32), 6) for p in wave]
            eng.run()
            got += [list(r.tokens) for r in reqs]
        streams.append(got)
        assert eng.prefill_failures == 0
    assert streams[1] == streams[0]
    assert all(len(s) == 6 for s in streams[1])
    if teng.paged:
        jp = jeng.metrics.summary()["prefix"]
        tp = teng.metrics.summary()["prefix"]
        assert {k: v for k, v in tp.items() if k != "hit_rate"} == \
            {k: v for k, v in jp.items() if k != "hit_rate"}
        if teng.prefix_cache:
            assert tp["hits"] >= 2 and tp["cow_copies"] >= 1
        teng.assert_page_invariants()


@pytest.mark.parametrize("arch", ARCHS)
def test_build_serves_every_family(arch):
    """``ServeEngine.build`` on the CPU builds each of the five archs
    (reduced) with its default dense cache and serves a request."""
    eng = TEngine.build(arch, config=TConfig(device="cpu"))
    r = eng.submit(np.arange(1, 6, dtype=np.int32), 3)
    eng.run()
    assert len(r.tokens) == 3 and eng.prefill_failures == 0
