"""Each ported ``layers`` function against ``repro.models.layers`` on the
same numpy inputs, fp32: norms, RoPE, the QKV projection, decode
positions, the paged row helpers and writes, both read paths (``kernel``
and ``einsum``) of paged decode and paged prefill-chunk attention, the
full-sequence attention in every impl, dense-cache decode (scalar and
per-slot positions) and dense prefill-chunk attention with and without
the flash kernel, the gated MLP, embeddings and logits.

Tolerance rtol = 1e-5 (atol 1e-6 for entries near zero): the same fp32
arithmetic summed in a different order by XLA and PyTorch."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
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
    want, wk, wv = JL.attention_decode(
        _j(p), jnp.asarray(x), JL.AttnDims(**dims), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(cache_pos), jnp.asarray(positions))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    if vector:      # the freed slot's row is untouched bit for bit
        np.testing.assert_array_equal(gk[1].numpy(), ck[1])


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
