"""Each ported ``layers`` function against ``repro.models.layers`` on the
same numpy inputs, fp32: norms, RoPE, the QKV projection, decode
positions, the paged row helpers and writes, both read paths (``kernel``
and ``einsum``) of paged decode and paged prefill-chunk attention, the
full-sequence attention in every impl, dense-cache decode (scalar and
per-slot positions) and dense prefill-chunk attention with and without
the flash kernel, the gated MLP, embeddings and logits. Then the int8
page writes (re-quantize, decode append and chunk splice, with a write
below the floor and a recycled page's stale rows) and both read paths
over int8 pools, and every MLA function (projections, dense latent cache,
latent pages on both read paths, the absorb path against the naive
expansion).

Tolerance rtol = 1e-5 (atol 1e-6 for entries near zero): the same fp32
arithmetic summed in a different order by XLA and PyTorch. Int8 payloads
written from the same f32 inputs are compared for equality, their scales
at 1e-6."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
RNG_SEED = 11
D, H, KV, HD = 64, 4, 1, 16
DIMS = dict(d_model=D, num_heads=H, num_kv_heads=KV, head_dim=HD,
            qkv_bias=True)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_params(rng):
    return {"wq": _rand(rng, D, H * HD, scale=D ** -0.5),
            "wk": _rand(rng, D, KV * HD, scale=D ** -0.5),
            "wv": _rand(rng, D, KV * HD, scale=D ** -0.5),
            "wo": _rand(rng, H * HD, D, scale=(H * HD) ** -0.5),
            "bq": _rand(rng, H * HD, scale=0.1),
            "bk": _rand(rng, KV * HD, scale=0.1),
            "bv": _rand(rng, KV * HD, scale=0.1)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_rmsnorm_rope_qkv_mlp_embed_logits():
    rng = np.random.default_rng(RNG_SEED)
    x = _rand(rng, 2, 5, D)
    scale = _rand(rng, D, scale=0.1)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))

    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    xr = _rand(rng, 2, 5, H, HD)
    _close(TL.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e4))

    p = _attn_params(rng)
    got = TL._qkv(_t(p), torch.from_numpy(x), TL.AttnDims(**DIMS),
                  torch.from_numpy(pos))
    want = JL._qkv(_j(p), jnp.asarray(x), JL.AttnDims(**DIMS),
                   jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)

    mp = {"w_up": _rand(rng, D, 128, scale=D ** -0.5),
          "w_gate": _rand(rng, D, 128, scale=D ** -0.5),
          "w_down": _rand(rng, 128, D, scale=128 ** -0.5)}
    _close(TL.mlp(_t(mp), torch.from_numpy(x)), JL.mlp(_j(mp), jnp.asarray(x)))

    table = _rand(rng, 512, D, scale=0.02)
    ids = rng.integers(0, 500, (2, 5))
    emb_t = TL.embed_lookup({"table": torch.from_numpy(table)},
                            torch.from_numpy(ids), torch.float32)
    _close(emb_t, JL.embed_lookup({"table": jnp.asarray(table)},
                                  jnp.asarray(ids), jnp.float32))
    unemb = _rand(rng, D, 512, scale=D ** -0.5)
    for w in (None, unemb):
        _close(TL.lm_logits({"table": torch.from_numpy(table)},
                            torch.from_numpy(x),
                            None if w is None else torch.from_numpy(w),
                            vocab=500),
               JL.lm_logits({"table": jnp.asarray(table)}, jnp.asarray(x),
                            None if w is None else jnp.asarray(w),
                            vocab=500))
    assert TL.mask_value(torch.float16) == JL.mask_value(jnp.float16)
    assert TL.mask_value(torch.float32) == JL.mask_value(jnp.float32)


def test_decode_positions_and_paged_row_helpers():
    pos = np.asarray([3, 17, JL.INACTIVE_POS], np.int32)
    assert TL.INACTIVE_POS == JL.INACTIVE_POS
    np.testing.assert_array_equal(
        TL.decode_positions(torch.from_numpy(pos), 3).numpy(),
        np.asarray(JL.decode_positions(jnp.asarray(pos), 3)))
    np.testing.assert_array_equal(
        TL.decode_positions(torch.tensor(5), 3).numpy(),
        np.asarray(JL.decode_positions(jnp.asarray(5), 3)))

    bt = np.asarray([[4, 1, -1, -1], [0, -1, -1, -1], [-1] * 4], np.int32)
    for a, b in zip(TL.paged_row_indices(torch.from_numpy(bt), 8, 32),
                    JL.paged_row_indices(jnp.asarray(bt), 8, 32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = np.asarray([9, 3, 0], np.int32)
    for a, b in zip(TL.paged_write_target(torch.from_numpy(bt),
                                          torch.from_numpy(idx), 8),
                    JL.paged_write_target(jnp.asarray(bt), jnp.asarray(idx),
                                          8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    rng = np.random.default_rng(RNG_SEED)
    pool = _rand(rng, 6, 8, KV, HD)
    rows = _rand(rng, 3, KV, HD)
    row_idx = np.asarray([9, 3, 47], np.int32)
    valid = np.asarray([True, True, False])
    got = TL.paged_write_rows(torch.from_numpy(pool.copy()),
                              torch.from_numpy(rows),
                              torch.from_numpy(row_idx).long(),
                              torch.from_numpy(valid))
    want = JL.paged_write_rows(jnp.asarray(pool), jnp.asarray(rows),
                               jnp.asarray(row_idx), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _paged_state(rng, P=10, ps=8, mps=4):
    """Pools with content, block tables for a live slot, a freed slot and a
    mid-prefill slot (pages held, position INACTIVE_POS)."""
    pk = _rand(rng, P, ps, KV, HD)
    pv = _rand(rng, P, ps, KV, HD)
    bt = np.asarray([[3, 7, 1, -1], [-1, -1, -1, -1], [5, 0, -1, -1]],
                    np.int32)
    return pk, pv, bt


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_attention_decode_paged_matches(impl):
    """Decode against the paged pool, both read paths: the output of the
    live slot and the pools after the write (the freed and mid-prefill
    slots' writes drop)."""
    rng = np.random.default_rng(RNG_SEED + 1)
    p = _attn_params(rng)
    pk, pv, bt = _paged_state(rng)
    x = _rand(rng, 3, 1, D)
    cache_pos = np.asarray([19, JL.INACTIVE_POS + 3, JL.INACTIVE_POS],
                           np.int32)
    positions = cache_pos[:, None]
    got, gk, gv = TL.attention_decode_paged(
        _t(p), torch.from_numpy(x), TL.AttnDims(**DIMS),
        torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
        torch.from_numpy(bt), torch.from_numpy(cache_pos),
        torch.from_numpy(positions), impl=impl)
    want, wk, wv = JL.attention_decode_paged(
        _j(p), jnp.asarray(x), JL.AttnDims(**DIMS), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(cache_pos),
        jnp.asarray(positions), impl=impl)
    _close(got[0], want[0])
    _close(gk, wk)
    _close(gv, wv)
    if impl == "kernel":   # the freed slot attends nothing: out = 0 @ wo
        _close(got[1], want[1])


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("write_floor", [0, 16])
def test_attention_prefill_chunk_paged_matches(impl, write_floor):
    """A prefill chunk of two slots sharing start 10: rows below
    ``write_floor`` are not written (shared prefix pages), the rest land in
    the slots' pages, and attention reads them through the block table."""
    rng = np.random.default_rng(RNG_SEED + 2)
    p = _attn_params(rng)
    pk, pv, _ = _paged_state(rng)
    bt = np.asarray([[3, 7, 1, -1], [3, 2, 9, -1]], np.int32)  # page 3 shared
    C, start = 12, 10
    x = _rand(rng, 2, C, D)
    positions = np.broadcast_to(np.arange(start, start + C, dtype=np.int32),
                                (2, C)).copy()
    got, gk, gv = TL.attention_prefill_chunk_paged(
        _t(p), torch.from_numpy(x), TL.AttnDims(**DIMS),
        torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
        torch.from_numpy(bt), torch.from_numpy(positions), write_floor,
        impl=impl)
    want, wk, wv = JL.attention_prefill_chunk_paged(
        _j(p), jnp.asarray(x), JL.AttnDims(**DIMS), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(positions),
        jnp.asarray(write_floor, jnp.int32), impl=impl)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_mask_bias_matches():
    q_pos = np.asarray([[0, 1, 2, 9], [4, 5, 6, 7]], np.int32)
    k_pos = np.asarray([[0, 1, 2, 3, 4, 5, 6, 9], [0, 1, 2, 3, 4, 5, 6, 7]],
                       np.int32)
    for window, causal in ((0, True), (3, True), (3, False), (0, False)):
        np.testing.assert_array_equal(
            TL._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                          window, causal).numpy(),
            np.asarray(JL._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                     window, causal)))


@pytest.mark.parametrize("impl", ["einsum", "chunked", "banded", "pallas"])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_full_sequence_matches(impl, window):
    """``layers.attention`` over a 40-token sequence in every impl (the
    reference's 'pallas' with positions runs its oracle; the port's runs
    the kernel wrapper, which takes the plain version on the CPU)."""
    rng = np.random.default_rng(RNG_SEED + 3)
    p = _attn_params(rng)
    x = _rand(rng, 2, 40, D)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    dims = dict(DIMS, window=window)
    got = TL.attention(_t(p), torch.from_numpy(x), TL.AttnDims(**dims),
                       torch.from_numpy(pos), impl=impl)
    want = JL.attention(_j(p), jnp.asarray(x), JL.AttnDims(**dims),
                        jnp.asarray(pos), impl=impl)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_and_banded_sdpa_over_several_chunks(causal):
    """The query-chunk loops with 16-row chunks over 48 rows (three
    chunks), GQA 4 over 2 heads, a window of 8 for the band."""
    rng = np.random.default_rng(RNG_SEED + 4)
    q = _rand(rng, 2, 48, 4, HD)
    k = _rand(rng, 2, 48, 2, HD)
    v = _rand(rng, 2, 48, 2, HD)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48)).copy()
    dims = dict(DIMS, num_kv_heads=2, window=8, causal=causal)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    _close(TL._sdpa_chunked(tq, tk, tv, tp, tp, TL.AttnDims(**dims), 16),
           JL._sdpa_chunked(jq, jk, jv, jp, jp, JL.AttnDims(**dims), 16))
    _close(TL._sdpa_banded(tq, tk, tv, TL.AttnDims(**dims), 16),
           JL._sdpa_banded(jq, jk, jv, JL.AttnDims(**dims), 16))


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode_dense_matches(vector, window):
    """Decode against a dense cache: per-slot positions with a freed slot
    at INACTIVE_POS (its write drops) and a slot at the last row, or one
    scalar position for the whole batch. The outputs and both caches after
    the write."""
    rng = np.random.default_rng(RNG_SEED + 5)
    p = _attn_params(rng)
    S_max = 32
    ck = _rand(rng, 3, S_max, KV, HD)
    cv = _rand(rng, 3, S_max, KV, HD)
    x = _rand(rng, 3, 1, D)
    if vector:
        cache_pos = np.asarray([19, JL.INACTIVE_POS, S_max - 1], np.int32)
        positions = cache_pos[:, None]
    else:
        cache_pos = np.asarray(7, np.int32)
        positions = np.full((3, 1), 7, np.int32)
    dims = dict(DIMS, window=window)
    got, gk, gv = TL.attention_decode(
        _t(p), torch.from_numpy(x), TL.AttnDims(**dims),
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.from_numpy(cache_pos), torch.from_numpy(positions))
    # the reference compiled, as its model and serving paths run it: XLA's
    # compiled float32 power gives RoPE frequencies one ulp from its
    # op-by-op one, which the freed slot's position (2^30) turns into
    # whole radians (layers.rope_freqs)
    want, wk, wv = jax.jit(JL.attention_decode, static_argnums=2)(
        _j(p), jnp.asarray(x), JL.AttnDims(**dims), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(cache_pos), jnp.asarray(positions))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    if vector:      # the freed slot's row is untouched bit for bit
        np.testing.assert_array_equal(gk[1].numpy(), ck[1])


def _served_rope_pairs():
    """(rotated width, theta) of every arch with RoPE, full and reduced:
    the head_dim, or an MLA's decoupled qk_rope_head_dim."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models.registry import reduced_config
    pairs = set()
    for arch in list_archs():
        full = get_config(arch)
        if not full.rope_theta or not full.num_heads:
            continue
        for cfg in (full, reduced_config(full)):
            pairs.add((cfg.qk_rope_head_dim or cfg.head_dim, cfg.rope_theta))
    return sorted(pairs)


# (width, theta) pairs of the grid below where the port's frequencies and
# the compiled reference's differ, each by one ulp at one frequency (XLA's
# CPU power, at the jax these tests run with); no arch rotates such a width
ROPE_ULP_PAIRS = {(174, 1e6), (184, 1e4), (202, 5e5), (220, 1e4),
                  (252, 1e4)}


def _compiled_rope_freqs(hd, theta):
    return np.asarray(jax.jit(JL.rope_freqs, static_argnums=(0, 1))(
        hd, theta))


@pytest.mark.parametrize("hd,theta", _served_rope_pairs())
def test_rope_freqs_equal_the_compiled_reference(hd, theta):
    """At every rotated width and theta an arch serves, the frequencies
    equal the compiled reference's bit for bit (an inactive slot's angle,
    at position 2^30, magnifies any ulp into radians), on every call."""
    want = _compiled_rope_freqs(hd, theta)
    np.testing.assert_array_equal(TL.rope_freqs(hd, theta).numpy(), want)
    assert TL.rope_freqs(hd, theta) is TL.rope_freqs(hd, theta)


def test_rope_freqs_differ_only_at_the_listed_pairs():
    """Over every even width 2-256 and the thetas of public models (1e4,
    5e5, 1e6), the port's frequencies equal the compiled reference's but
    at ``ROPE_ULP_PAIRS``, and there by one ulp."""
    differ = set()
    for theta in (1e4, 5e5, 1e6):
        for hd in range(2, 258, 2):
            want = _compiled_rope_freqs(hd, theta)
            got = TL.rope_freqs(hd, theta).numpy()
            if not np.array_equal(got, want):
                differ.add((hd, theta))
                ulps = np.abs(got.view(np.int32) - want.view(np.int32))
                assert ulps.max() == 1, (hd, theta, ulps.max())
    assert differ == ROPE_ULP_PAIRS
    assert not differ & set(_served_rope_pairs())


@pytest.mark.parametrize("use_kernel,start", [(True, 0), (False, 0),
                                              (False, 10), (False, 28)])
def test_attention_prefill_chunk_dense_matches(use_kernel, start):
    """A 12-row chunk into a dense cache holding older rows: a first chunk
    through the flash kernel and through the einsum, a continuation, and a
    start past S_max - C, which ``dynamic_update_slice`` clamps (and the
    port with it)."""
    rng = np.random.default_rng(RNG_SEED + 6)
    p = _attn_params(rng)
    S_max, C = 32, 12
    ck = _rand(rng, 2, S_max, KV, HD)
    cv = _rand(rng, 2, S_max, KV, HD)
    x = _rand(rng, 2, C, D)
    positions = np.broadcast_to(np.arange(start, start + C, dtype=np.int32),
                                (2, C)).copy()
    dims = dict(DIMS, window=8)
    got, gk, gv = TL.attention_prefill_chunk(
        _t(p), torch.from_numpy(x), TL.AttnDims(**dims),
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), start,
        torch.from_numpy(positions), use_kernel=use_kernel)
    want, wk, wv = JL.attention_prefill_chunk(
        _j(p), jnp.asarray(x), JL.AttnDims(**dims), jnp.asarray(ck),
        jnp.asarray(cv), start, jnp.asarray(positions),
        use_kernel=use_kernel)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


# ------------------------------------------------------------ int8 pages
SCALE_TOL = dict(rtol=1e-6, atol=0)


def _q8_state(rng, P=10, ps=8, kv=KV):
    """Int8 pools full of payload (every row of every page, so rows past a
    slot's frontier are a recycled page's stale content) and their (P, 1)
    scales."""
    pk = rng.integers(-127, 128, (P, ps, kv, HD)).astype(np.int8)
    pv = rng.integers(-127, 128, (P, ps, kv, HD)).astype(np.int8)
    # dequantized entries within about +-1, as the fp32 cases' pools
    ks = rng.uniform(0.002, 0.01, (P, 1)).astype(np.float32)
    vs = rng.uniform(0.002, 0.01, (P, 1)).astype(np.float32)
    return pk, pv, ks, vs


def _eq_q8(got, want):
    """(pool, scale) pairs: payload equal, scales allclose at 1e-6."""
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **SCALE_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_requant_and_dequant_page_match(groups):
    rng = np.random.default_rng(RNG_SEED + 7)
    blk = _rand(rng, 3, 8, 2, HD, scale=3.0)
    content = np.arange(8)[None, :] <= np.asarray([7, 2, -1])[:, None]
    got = TL._requant_page(torch.from_numpy(blk), torch.from_numpy(content),
                           groups)
    want = JL._requant_page(jnp.asarray(blk), jnp.asarray(content), groups)
    _eq_q8(got, want)
    assert np.all(got[1].numpy()[2] == 1.0)       # a page with no content
    _close(TL._dequant_page_block(*got), JL._dequant_page_block(*want))


def test_paged_append_row_q8_matches():
    """Decode appends for a slot mid-page (a recycled page: stale rows past
    the offset are zeroed), a slot at a page's first row, a freed slot and
    a slot whose page is unallocated (both dropped, page and scale)."""
    rng = np.random.default_rng(RNG_SEED + 8)
    pk, _, ks, _ = _q8_state(rng)
    bt = np.asarray([[3, 7, 1, -1], [4, 2, -1, -1], [-1] * 4, [5, -1, -1, -1]],
                    np.int32)
    rows = _rand(rng, 4, KV, HD, scale=2.0)
    pos = np.asarray([11, 8, JL.INACTIVE_POS, 9], np.int32)
    safe = np.clip(pos, 0, 31)
    valid = np.asarray([True, True, False, True])
    got = TL.paged_append_row_q8(
        torch.from_numpy(pk.copy()), torch.from_numpy(ks.copy()),
        torch.from_numpy(rows), torch.from_numpy(bt), torch.from_numpy(safe),
        torch.from_numpy(valid))
    want = JL.paged_append_row_q8(
        jnp.asarray(pk), jnp.asarray(ks), jnp.asarray(rows), jnp.asarray(bt),
        jnp.asarray(safe), jnp.asarray(valid))
    _eq_q8(got, want)
    assert not np.array_equal(got[0].numpy()[7], pk[7])      # page written
    np.testing.assert_array_equal(got[0].numpy()[5], pk[5])  # unallocated


@pytest.mark.parametrize("write_floor", [0, 16])
def test_paged_splice_chunk_q8_matches(write_floor):
    """A 12-row chunk at position 10 for two slots: pages 0-2 of each are
    re-quantized where the chunk writes them; below ``write_floor`` the
    shared prefix page keeps its payload and scale."""
    rng = np.random.default_rng(RNG_SEED + 9)
    pk, _, ks, _ = _q8_state(rng)
    bt = np.asarray([[3, 7, 1, -1], [3, 2, 9, -1]], np.int32)
    C, start = 12, 10
    rows = _rand(rng, 2, C, KV, HD, scale=2.0)
    positions = np.broadcast_to(np.arange(start, start + C, dtype=np.int32),
                                (2, C)).copy()
    got = TL.paged_splice_chunk_q8(
        torch.from_numpy(pk.copy()), torch.from_numpy(ks.copy()),
        torch.from_numpy(rows), torch.from_numpy(bt),
        torch.from_numpy(positions), write_floor)
    want = JL.paged_splice_chunk_q8(
        jnp.asarray(pk), jnp.asarray(ks), jnp.asarray(rows), jnp.asarray(bt),
        jnp.asarray(positions), jnp.asarray(write_floor, jnp.int32))
    _eq_q8(got, want)
    if write_floor:
        np.testing.assert_array_equal(got[0].numpy()[7], pk[7])
        assert got[1].numpy()[7] == ks[7]


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_attention_decode_paged_q8_matches(impl):
    """Decode over int8 pools, both read paths: the live slot's output and
    the pools and scales after the append."""
    rng = np.random.default_rng(RNG_SEED + 10)
    p = _attn_params(rng)
    pk, pv, ks, vs = _q8_state(rng)
    _, _, bt = _paged_state(rng)
    x = _rand(rng, 3, 1, D)
    cache_pos = np.asarray([19, JL.INACTIVE_POS + 3, JL.INACTIVE_POS],
                           np.int32)
    positions = cache_pos[:, None]
    got = TL.attention_decode_paged(
        _t(p), torch.from_numpy(x), TL.AttnDims(**DIMS),
        torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
        torch.from_numpy(bt), torch.from_numpy(cache_pos),
        torch.from_numpy(positions), impl=impl,
        k_scale=torch.from_numpy(ks.copy()),
        v_scale=torch.from_numpy(vs.copy()))
    want = JL.attention_decode_paged(
        _j(p), jnp.asarray(x), JL.AttnDims(**DIMS), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(cache_pos),
        jnp.asarray(positions), impl=impl, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    _close(got[0][0], want[0][0])
    _eq_q8(got[1:], want[1:])


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("write_floor", [0, 16])
def test_attention_prefill_chunk_paged_q8_matches(impl, write_floor):
    rng = np.random.default_rng(RNG_SEED + 11)
    p = _attn_params(rng)
    pk, pv, ks, vs = _q8_state(rng)
    bt = np.asarray([[3, 7, 1, -1], [3, 2, 9, -1]], np.int32)
    C, start = 12, 10
    x = _rand(rng, 2, C, D)
    positions = np.broadcast_to(np.arange(start, start + C, dtype=np.int32),
                                (2, C)).copy()
    got = TL.attention_prefill_chunk_paged(
        _t(p), torch.from_numpy(x), TL.AttnDims(**DIMS),
        torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
        torch.from_numpy(bt), torch.from_numpy(positions), write_floor,
        impl=impl, k_scale=torch.from_numpy(ks.copy()),
        v_scale=torch.from_numpy(vs.copy()))
    want = JL.attention_prefill_chunk_paged(
        _j(p), jnp.asarray(x), JL.AttnDims(**DIMS), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(positions),
        jnp.asarray(write_floor, jnp.int32), impl=impl,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    _close(got[0], want[0])
    _eq_q8(got[1:], want[1:])


def test_dequant_paged_view_matches():
    rng = np.random.default_rng(RNG_SEED + 12)
    pk, _, ks, _ = _q8_state(rng, kv=2)
    bt = np.asarray([[3, 7, -1, -1], [0, -1, -1, -1]], np.int32)
    phys, _ = JL.paged_row_indices(jnp.asarray(bt), 8, 32)
    phys = np.array(phys)
    view = pk.reshape(80, 2, HD)[phys]
    for scale in (ks, np.concatenate([ks, ks * 2], 1)):
        _close(TL.dequant_paged_view(torch.from_numpy(view),
                                     torch.from_numpy(phys),
                                     torch.from_numpy(scale), 8,
                                     torch.float32),
               JL.dequant_paged_view(jnp.asarray(view), jnp.asarray(phys),
                                     jnp.asarray(scale), 8, jnp.float32))


# ------------------------------------------------------------------- MLA
MLA = dict(d_model=D, num_heads=H, kv_lora_rank=8, qk_rope_head_dim=2,
           head_dim=HD)
LAT = 10                                         # c + r


def _mla_params(rng):
    c, r = MLA["kv_lora_rank"], MLA["qk_rope_head_dim"]
    return {"wq": _rand(rng, D, H * (HD + r), scale=D ** -0.5),
            "wkv_a": _rand(rng, D, c + r, scale=D ** -0.5),
            "kv_norm": _rand(rng, c, scale=0.1),
            "wkv_b": _rand(rng, c, H * 2 * HD, scale=c ** -0.5),
            "wo": _rand(rng, H * HD, D, scale=(H * HD) ** -0.5)}


def test_mla_projections_match():
    rng = np.random.default_rng(RNG_SEED + 13)
    p = _mla_params(rng)
    x = _rand(rng, 2, 5, D)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    tdims, jdims = TL.MLADims(**MLA), JL.MLADims(**MLA)
    assert (tdims.latent_dim, tdims.scale_dim) == (jdims.latent_dim,
                                                   jdims.scale_dim)
    _close(TL.mla_absorbed_queries(_t(p), torch.from_numpy(x), tdims,
                                   torch.from_numpy(pos)),
           JL.mla_absorbed_queries(_j(p), jnp.asarray(x), jdims,
                                   jnp.asarray(pos)))
    _close(TL.mla_latent_rows(_t(p), torch.from_numpy(x), tdims,
                              torch.from_numpy(pos)),
           JL.mla_latent_rows(_j(p), jnp.asarray(x), jdims, jnp.asarray(pos)))
    for a, b in zip(TL._mla_wkv_b(_t(p), tdims, torch.float32),
                    JL._mla_wkv_b(_j(p), jdims, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    attn = _rand(rng, 2, 5, H, MLA["kv_lora_rank"])
    _close(TL._mla_out(_t(p), torch.from_numpy(attn), tdims,
                       torch.from_numpy(x)),
           JL._mla_out(_j(p), jnp.asarray(attn), jdims, jnp.asarray(x)))


@pytest.mark.parametrize("vector", [True, False])
def test_mla_attention_decode_dense_matches(vector):
    """Decode against a dense latent cache: per-slot positions with a freed
    slot (its write drops), or one scalar position."""
    rng = np.random.default_rng(RNG_SEED + 14)
    p = _mla_params(rng)
    cache = _rand(rng, 3, 32, 1, LAT)
    x = _rand(rng, 3, 1, D)
    if vector:
        cache_pos = np.asarray([19, JL.INACTIVE_POS, 31], np.int32)
        positions = cache_pos[:, None]
    else:
        cache_pos = np.asarray(7, np.int32)
        positions = np.full((3, 1), 7, np.int32)
    got, gc = TL.mla_attention_decode(
        _t(p), torch.from_numpy(x), TL.MLADims(**MLA),
        torch.from_numpy(cache.copy()), torch.from_numpy(cache_pos),
        torch.from_numpy(positions))
    want, wc = JL.mla_attention_decode(
        _j(p), jnp.asarray(x), JL.MLADims(**MLA), jnp.asarray(cache),
        jnp.asarray(cache_pos), jnp.asarray(positions))
    _close(got, want)
    _close(gc, wc)


@pytest.mark.parametrize("start", [0, 10, 28])
def test_mla_attention_prefill_chunk_dense_matches(start):
    rng = np.random.default_rng(RNG_SEED + 15)
    p = _mla_params(rng)
    cache = _rand(rng, 2, 32, 1, LAT)
    C = 12
    x = _rand(rng, 2, C, D)
    positions = np.broadcast_to(np.arange(start, start + C, dtype=np.int32),
                                (2, C)).copy()
    got, gc = TL.mla_attention_prefill_chunk(
        _t(p), torch.from_numpy(x), TL.MLADims(**MLA),
        torch.from_numpy(cache.copy()), start, torch.from_numpy(positions))
    want, wc = JL.mla_attention_prefill_chunk(
        _j(p), jnp.asarray(x), JL.MLADims(**MLA), jnp.asarray(cache),
        start, jnp.asarray(positions))
    _close(got, want)
    _close(gc, wc)


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_mla_paged_decode_and_prefill_chunk_match(impl):
    """Latent pages, both read paths: a decode step (live, freed and
    mid-prefill slots) and a prefill chunk with a write floor."""
    rng = np.random.default_rng(RNG_SEED + 16)
    p = _mla_params(rng)
    pool = _rand(rng, 10, 8, 1, LAT)
    tdims, jdims = TL.MLADims(**MLA), JL.MLADims(**MLA)
    _, _, bt = _paged_state(rng)
    x = _rand(rng, 3, 1, D)
    cache_pos = np.asarray([19, JL.INACTIVE_POS + 3, JL.INACTIVE_POS],
                           np.int32)
    got, gp = TL.mla_attention_decode_paged(
        _t(p), torch.from_numpy(x), tdims, torch.from_numpy(pool.copy()),
        torch.from_numpy(bt), torch.from_numpy(cache_pos),
        torch.from_numpy(cache_pos[:, None]), impl=impl)
    want, wp = JL.mla_attention_decode_paged(
        _j(p), jnp.asarray(x), jdims, jnp.asarray(pool), jnp.asarray(bt),
        jnp.asarray(cache_pos), jnp.asarray(cache_pos[:, None]), impl=impl)
    _close(got[0], want[0])
    _close(gp, wp)

    bt = np.asarray([[3, 7, 1, -1], [3, 2, 9, -1]], np.int32)
    C, start = 12, 10
    x = _rand(rng, 2, C, D)
    positions = np.broadcast_to(np.arange(start, start + C, dtype=np.int32),
                                (2, C)).copy()
    got, gp = TL.mla_attention_prefill_chunk_paged(
        _t(p), torch.from_numpy(x), tdims, torch.from_numpy(pool.copy()),
        torch.from_numpy(bt), torch.from_numpy(positions), 16, impl=impl)
    want, wp = JL.mla_attention_prefill_chunk_paged(
        _j(p), jnp.asarray(x), jdims, jnp.asarray(pool), jnp.asarray(bt),
        jnp.asarray(positions), jnp.asarray(16, jnp.int32), impl=impl)
    _close(got, want)
    _close(gp, wp)


def test_mla_absorb_path_matches_naive_expansion():
    """The absorbed prefill attention equals the naive per-head expansion
    (``ref.mla_attention_naive``) through ``wo``, in the port, and the
    port's naive oracle equals the reference's on the same inputs."""
    rng = np.random.default_rng(RNG_SEED + 17)
    p = _t(_mla_params(rng))
    dims = TL.MLADims(**MLA)
    B, S = 2, 12
    x = torch.from_numpy(_rand(rng, B, S, D))
    pos = torch.arange(S).expand(B, S)
    absorbed, _ = TL.mla_attention_prefill_chunk(
        p, x, dims, torch.zeros(B, S, 1, LAT), 0, pos)
    r = MLA["qk_rope_head_dim"]
    q = (x @ p["wq"]).reshape(B, S, H, HD + r)
    q_nope, q_pe = q[..., :HD], TL.apply_rope(q[..., HD:], pos, 1e4)
    wb_k, wb_v = TL._mla_wkv_b(p, dims, torch.float32)
    latent = TL.mla_latent_rows(p, x, dims, pos)[:, :, 0]
    args = (q_nope, q_pe, latent, wb_k, wb_v, pos, pos)
    attn = tref.mla_attention_naive(*args)
    naive = attn.reshape(B, S, H * HD) @ p["wo"]
    np.testing.assert_allclose(absorbed.numpy(), naive.numpy(), rtol=2e-5,
                               atol=2e-5)
    _close(attn, jref.mla_attention_naive(*(jnp.asarray(a.numpy())
                                            for a in args)))
