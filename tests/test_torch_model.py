"""The port's dense transformer against ``repro.models.transformer`` on the
reduced qwen2.5-32b (2 layers, d_model 64, 4 query heads over 1 kv head,
head_dim 16, vocab 512, QKV bias) with bridged weights: one paged prefill
chunk, then 4 paged decode steps, through both read paths; the
full-sequence forward in every attention impl and the prefill step built
on it; dense-cache prefill chunks (a first chunk through the flash kernel
or the einsum, then a continuation) followed by dense decode steps; the
scan prefill. Then the same for int8 pages (a paged prefill chunk and
decode steps through both read paths) and for the reduced
qwen2.5-32b-mla (2 layers, 4 heads, kv_lora_rank 8, qk_rope_head_dim 2):
the forward, dense latent-cache chunks and decode, and latent pages on
both read paths.

Logits and page pools must be allclose at rtol 1e-4, atol 1e-5: each
package computes the same fp32 network, but XLA and PyTorch sum every
matmul and softmax in their own order, and those last-bit differences
compound through two layers, the final norm and the vocab projection.
Int8 payloads quantized from such last-bit-different rows are equal except
where a value sits on a rounding tie (.5), which may flip by one: at least
99.9 % equal, none off by more than 1; the scales are allclose at 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
PS, S_MAX, P = 16, 64, 12
INACTIVE = 1 << 30


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.reduced_config(jconfigs.get_config("qwen2.5-32b"))
    tcfg = treg.reduced_config(tconfigs.get_config("qwen2.5-32b"))
    assert (jcfg.num_layers, jcfg.d_model, jcfg.num_heads, jcfg.num_kv_heads,
            jcfg.head_dim, jcfg.vocab_size, jcfg.qkv_bias) == \
        (tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads,
         tcfg.head_dim, tcfg.vocab_size, tcfg.qkv_bias) == \
        (2, 64, 4, 1, 16, 512, True)
    jparams = jtf.init(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    return jcfg, jparams, tcfg, tparams


def _cache_pair(jcfg, tcfg, bt, pos):
    jmodel = jreg.get_model(jcfg)
    jc = jreg.init_paged_cache(jmodel, 3, S_MAX, page_size=PS, num_pages=P,
                               dtype=jnp.float32)
    jc = dict(jc, block_tables=jnp.asarray(bt), pos=jnp.asarray(pos))
    tc = treg.init_paged_cache(treg.get_model(tcfg), 3, S_MAX, page_size=PS,
                               num_pages=P, device="cpu")
    tc["block_tables"].copy_(torch.from_numpy(bt))
    tc["pos"].copy_(torch.from_numpy(pos))
    assert set(jc) == set(tc)
    for key in jc:
        assert tuple(jc[key].shape) == tuple(tc[key].shape), key
    return jc, tc


def _assert_pools(jc, tc):
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_prefill_chunk_then_decode_matches_reference(models, impl):
    """Slots 0 and 1 prefill a 24-token chunk jointly (it spans two pages);
    slot 2 holds pages but is still at INACTIVE_POS (mid-prefill), so its
    decode writes drop. Then 4 decode steps feed the reference's greedy
    tokens to both packages. Logits of the live slots and both pools stay
    allclose throughout."""
    jcfg, jparams, tcfg, tparams = models
    bt = np.asarray([[3, 7, 1, 10], [0, 5, 9, 2], [4, 6, -1, -1]], np.int32)
    jc, tc = _cache_pair(jcfg, tcfg, bt, np.full((3,), INACTIVE, np.int32))
    rng = np.random.default_rng(21)
    C = 24
    toks = rng.integers(0, jcfg.vocab_size, (2, C)).astype(np.int32)

    jl, jc = jtf.prefill_chunk_paged(
        jparams, jcfg, jnp.asarray(toks), jc, bt_rows=jnp.asarray(bt[:2]),
        start=0, write_floor=0, compute_dtype=jnp.float32, attn_impl=impl)
    tl, tc = ttf.prefill_chunk_paged(
        tparams, tcfg, torch.from_numpy(toks).long(), tc,
        bt_rows=torch.from_numpy(bt[:2]), start=0, write_floor=0,
        attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jc, tc)

    pos = np.asarray([C, C, INACTIVE], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"].copy_(torch.from_numpy(pos))
    nxt = np.zeros((3, 1), np.int32)
    nxt[:2, 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(4):
        jl, jc = jtf.decode_step(jparams, jcfg, jnp.asarray(nxt), jc,
                                 compute_dtype=jnp.float32,
                                 paged_attn_impl=impl)
        tl, tc = ttf.decode_step(tparams, tcfg, torch.from_numpy(nxt).long(),
                                 tc, paged_attn_impl=impl)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl[:2]), **TOL)
        _assert_pools(jc, tc)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        nxt[:2, 0] = np.asarray(jnp.argmax(jl[:2, 0, :jcfg.vocab_size], -1))
        assert (tl[:2, 0, :tcfg.vocab_size].argmax(-1).numpy()
                == nxt[:2, 0]).all()


@pytest.mark.parametrize("impl", ["einsum", "chunked", "pallas"])
def test_forward_matches_reference(models, impl):
    """Full-sequence logits (B=2, S=24) and the last-position prefill step
    built on the forward."""
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(22).integers(0, jcfg.vocab_size, (2, 24))
    jl, jaux = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                           compute_dtype=jnp.float32, attn_impl=impl)
    tl, taux = ttf.forward(tparams, tcfg, torch.from_numpy(toks),
                           attn_impl=impl)
    assert tl.shape == (2, 24, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(taux) == set(jaux)
    jpre = jsteps.make_prefill(jreg.get_model(jcfg), attn_impl=impl,
                               compute_dtype=jnp.float32)
    tpre = tsteps.make_prefill(treg.get_model(tcfg), attn_impl=impl,
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(
        tpre(tparams, {"tokens": torch.from_numpy(toks)}).numpy(),
        np.asarray(jpre(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})),
        **TOL)


def _assert_dense(jc, tc):
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("attn_impl", ["pallas", "einsum"])
def test_dense_prefill_chunks_then_decode_matches(models, attn_impl):
    """Two slots prefill a 16-token first chunk (through the flash kernel
    with 'pallas') and an 8-token continuation into a fresh dense cache
    (the engine's transient cache); the cache then serves 4 decode steps at
    per-slot positions, next to a freed slot at INACTIVE_POS. Logits and
    the cache leaves stay allclose throughout."""
    jcfg, jparams, tcfg, tparams = models
    jmodel, tmodel = jreg.get_model(jcfg), treg.get_model(tcfg)
    rng = np.random.default_rng(23)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24))
    jfirst = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32,
                                       s_max=S_MAX, first=True,
                                       attn_impl=attn_impl)
    jcont = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32,
                                      s_max=S_MAX, attn_impl=attn_impl)
    tfirst = tsteps.make_prefill_chunk(tmodel, s_max=S_MAX, first=True,
                                       attn_impl=attn_impl,
                                       compute_dtype=torch.float32)
    tcont = tsteps.make_prefill_chunk(tmodel, s_max=S_MAX,
                                      attn_impl=attn_impl,
                                      compute_dtype=torch.float32)
    jl, jc = jfirst(jparams, {"tokens": jnp.asarray(toks[:, :16], jnp.int32)})
    tl, tc = tfirst(tparams, {"tokens": torch.from_numpy(toks[:, :16])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_dense(jc, tc)
    jl, jc = jcont(jparams, jc, {"tokens": jnp.asarray(toks[:, 16:],
                                                       jnp.int32)})
    tl, tc = tcont(tparams, tc, {"tokens": torch.from_numpy(toks[:, 16:])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_dense(jc, tc)

    # a 3-slot serving cache: slots 0 and 2 take the prefill, slot 1 is free
    jserve = jreg.vectorize_cache_pos(
        jtf.init_cache(jcfg, 3, S_MAX, jnp.float32), 3, inactive=True)
    tserve = treg.vectorize_cache_pos(
        ttf.init_cache(tcfg, 3, S_MAX, device="cpu"), 3, inactive=True)
    _assert_dense(jserve, tserve)
    jserve = jreg.insert_cache_rows(jserve, jc, jnp.asarray([0, 2]))
    tserve = treg.insert_cache_rows(tserve, tc, torch.tensor([0, 2]))
    _assert_dense(jserve, tserve)
    nxt = np.zeros((3, 1), np.int32)
    nxt[[0, 2], 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(4):
        jl, jserve = jtf.decode_step(jparams, jcfg, jnp.asarray(nxt), jserve,
                                     compute_dtype=jnp.float32)
        tl, tserve = ttf.decode_step(tparams, tcfg,
                                     torch.from_numpy(nxt).long(), tserve)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_dense(jserve, tserve)
        nxt[[0, 2], 0] = np.asarray(
            jnp.argmax(jl[[0, 2], 0, :jcfg.vocab_size], -1))


def test_scan_prefill_matches_reference(models):
    """The scan anchor: a 12-token prompt teacher-forced through
    decode_step into a fresh dense cache (scalar position)."""
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(24).integers(0, jcfg.vocab_size, (2, 12))
    jpre = jsteps.make_prefill(jreg.get_model(jcfg),
                               compute_dtype=jnp.float32, return_cache=True,
                               s_max=S_MAX)
    tpre = tsteps.make_prefill(treg.get_model(tcfg), return_cache=True,
                               s_max=S_MAX,
                               compute_dtype=torch.float32)
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tpre(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_dense(jc, tc)


# ------------------------------------------------------------ int8 pages
def _assert_q8(jc, tc):
    for key in ("k", "v"):
        got, want = tc[key].numpy().astype(np.int32), np.asarray(jc[key],
                                                                 np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, key
        np.testing.assert_allclose(tc[key + "_scale"].numpy(),
                                   np.asarray(jc[key + "_scale"]), rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_int8_prefill_chunk_then_decode_matches_reference(models, impl):
    """The paged test above over int8 pools (the int8 backend's cache): a
    24-token chunk for two slots, then 4 greedy decode steps."""
    jcfg, jparams, tcfg, tparams = models
    bt = np.asarray([[3, 7, 1, 10], [0, 5, 9, 2], [4, 6, -1, -1]], np.int32)
    pos = np.full((3,), INACTIVE, np.int32)
    jc = jkv.PagedInt8Backend(PS, P).init_cache(jreg.get_model(jcfg), 3,
                                                S_MAX, jnp.float32)
    jc = dict(jc, block_tables=jnp.asarray(bt), pos=jnp.asarray(pos))
    tc = tkv.PagedInt8Backend(PS, P).init_cache(treg.get_model(tcfg), 3,
                                                S_MAX, torch.float32, "cpu")
    tc["block_tables"].copy_(torch.from_numpy(bt))
    assert set(jc) == set(tc) and tc["k"].dtype == torch.int8
    for key in jc:
        assert tuple(jc[key].shape) == tuple(tc[key].shape), key
    C = 24
    toks = np.random.default_rng(25).integers(0, jcfg.vocab_size, (2, C))
    jl, jc = jtf.prefill_chunk_paged(
        jparams, jcfg, jnp.asarray(toks, jnp.int32), jc,
        bt_rows=jnp.asarray(bt[:2]), start=0, write_floor=0,
        compute_dtype=jnp.float32, attn_impl=impl)
    tl, tc = ttf.prefill_chunk_paged(
        tparams, tcfg, torch.from_numpy(toks), tc,
        bt_rows=torch.from_numpy(bt[:2]), start=0, write_floor=0,
        attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_q8(jc, tc)
    pos = np.asarray([C, C, INACTIVE], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"].copy_(torch.from_numpy(pos))
    nxt = np.zeros((3, 1), np.int32)
    nxt[:2, 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(4):
        jl, jc = jtf.decode_step(jparams, jcfg, jnp.asarray(nxt), jc,
                                 compute_dtype=jnp.float32,
                                 paged_attn_impl=impl)
        tl, tc = ttf.decode_step(tparams, tcfg, torch.from_numpy(nxt).long(),
                                 tc, paged_attn_impl=impl)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl[:2]), **TOL)
        _assert_q8(jc, tc)
        nxt[:2, 0] = np.asarray(jnp.argmax(jl[:2, 0, :jcfg.vocab_size], -1))


# ------------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def mla_models():
    jcfg = jreg.reduced_config(jconfigs.get_config("qwen2.5-32b-mla"))
    tcfg = treg.reduced_config(tconfigs.get_config("qwen2.5-32b-mla"))
    assert (tcfg.kv_lora_rank, tcfg.qk_rope_head_dim, tcfg.num_heads) == \
        (jcfg.kv_lora_rank, jcfg.qk_rope_head_dim, jcfg.num_heads) == (8, 2, 4)
    jparams = jtf.init(jcfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    assert set(tparams["layers"]["attn"]) == {"wq", "wkv_a", "kv_norm",
                                              "wkv_b", "wo"}
    fresh = ttf.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    for key, leaf in tparams["layers"]["attn"].items():
        assert fresh["layers"]["attn"][key].shape == leaf.shape, key
    return jcfg, jparams, tcfg, tparams


def test_mla_forward_matches_reference(mla_models):
    jcfg, jparams, tcfg, tparams = mla_models
    toks = np.random.default_rng(26).integers(0, jcfg.vocab_size, (2, 20))
    jl, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                        compute_dtype=jnp.float32)
    tl, _ = ttf.forward(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_mla_dense_prefill_chunks_then_decode_matches(mla_models):
    """A 16-token first chunk and an 8-token continuation into a fresh
    dense latent cache ("k" only, no "v"), spliced into a 3-slot serving
    cache next to a free slot, then 4 decode steps."""
    jcfg, jparams, tcfg, tparams = mla_models
    jmodel, tmodel = jreg.get_model(jcfg), treg.get_model(tcfg)
    toks = np.random.default_rng(27).integers(0, jcfg.vocab_size, (2, 24))
    jc = jtf.init_cache(jcfg, 2, S_MAX, jnp.float32)
    tc = ttf.init_cache(tcfg, 2, S_MAX, device="cpu")
    assert set(tc) == set(jc) == {"k", "pos"}
    for sl, first in ((slice(0, 16), True), (slice(16, 24), False)):
        jl, jc = jtf.prefill_chunk(jparams, jcfg, jnp.asarray(toks[:, sl],
                                                              jnp.int32),
                                   jc, compute_dtype=jnp.float32, first=first)
        tl, tc = ttf.prefill_chunk(tparams, tcfg,
                                   torch.from_numpy(toks[:, sl]), tc,
                                   first=first)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_dense_latent(jc, tc)
    jserve = jreg.vectorize_cache_pos(jtf.init_cache(jcfg, 3, S_MAX,
                                                     jnp.float32), 3,
                                      inactive=True)
    tserve = treg.vectorize_cache_pos(ttf.init_cache(tcfg, 3, S_MAX,
                                                     device="cpu"), 3,
                                      inactive=True)
    jserve = jreg.insert_cache_rows(jserve, jc, jnp.asarray([0, 2]))
    tserve = treg.insert_cache_rows(tserve, tc, torch.tensor([0, 2]))
    nxt = np.zeros((3, 1), np.int32)
    nxt[[0, 2], 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(4):
        jl, jserve = jtf.decode_step(jparams, jcfg, jnp.asarray(nxt), jserve,
                                     compute_dtype=jnp.float32)
        tl, tserve = ttf.decode_step(tparams, tcfg,
                                     torch.from_numpy(nxt).long(), tserve)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_dense_latent(jserve, tserve)
        nxt[[0, 2], 0] = np.asarray(
            jnp.argmax(jl[[0, 2], 0, :jcfg.vocab_size], -1))


def _assert_dense_latent(jc, tc):
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_mla_paged_prefill_chunk_then_decode_matches(mla_models, impl):
    """The paged test above on latent pages (one "k" pool of c + r = 10
    wide rows): a 24-token chunk for two slots next to a mid-prefill slot,
    then 4 decode steps; logits and the latent pool stay allclose."""
    jcfg, jparams, tcfg, tparams = mla_models
    bt = np.asarray([[3, 7, 1, 10], [0, 5, 9, 2], [4, 6, -1, -1]], np.int32)
    jc, tc = _cache_pair(jcfg, tcfg, bt, np.full((3,), INACTIVE, np.int32))
    assert "v" not in tc and tuple(tc["k"].shape) == (2, P, PS, 1, 10)
    C = 24
    toks = np.random.default_rng(28).integers(0, jcfg.vocab_size, (2, C))
    jl, jc = jtf.prefill_chunk_paged(
        jparams, jcfg, jnp.asarray(toks, jnp.int32), jc,
        bt_rows=jnp.asarray(bt[:2]), start=0, write_floor=0,
        compute_dtype=jnp.float32, attn_impl=impl)
    tl, tc = ttf.prefill_chunk_paged(
        tparams, tcfg, torch.from_numpy(toks), tc,
        bt_rows=torch.from_numpy(bt[:2]), start=0, write_floor=0,
        attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    pos = np.asarray([C, C, INACTIVE], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"].copy_(torch.from_numpy(pos))
    nxt = np.zeros((3, 1), np.int32)
    nxt[:2, 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(4):
        jl, jc = jtf.decode_step(jparams, jcfg, jnp.asarray(nxt), jc,
                                 compute_dtype=jnp.float32,
                                 paged_attn_impl=impl)
        tl, tc = ttf.decode_step(tparams, tcfg, torch.from_numpy(nxt).long(),
                                 tc, paged_attn_impl=impl)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl[:2]), **TOL)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   **TOL)
        nxt[:2, 0] = np.asarray(jnp.argmax(jl[:2, 0, :jcfg.vocab_size], -1))
