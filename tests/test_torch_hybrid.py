"""The port's hymba (``models/hybrid.py``) against ``repro.models.hybrid``
on the reduced hymba-1.5b (2 layers, d_model 64, 4 query heads over 1 kv
head of 16, window 8, ssm_state 4, vocab 512) with bridged weights: the
parameter layout, the associative scan, the full-sequence forward through
every ``scan_impl`` and attention impl, dense-ring prefill chunks (the
first through the flash kernel or the einsum, a continuation that wraps the
ring) then decode steps at per-slot positions next to a freed slot, the
paged ring (pages of 4 rows, the ring wrapping while it decodes), decode
against the forward, the scan anchor, and the paged cache's layout.

``repro``'s init sets ``logA`` to zeros, so A = -1 for every channel; the
weights here add seeded numpy noise to it (logA ~ 0.5 N(0, 1)), the same
in both packages, so that per-channel decay is exercised.

Logits, ring rows and state leaves must be allclose at rtol 1e-4, atol
1e-5 (two fp32 networks summing in their own orders; ring positions are
equal exactly). The associative scan is held to ``lax.associative_scan``
at rtol = atol = 1e-6: the port takes the same products in the same
recursion, and only XLA's fusion of a product into a sum may round
apart."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import hybrid as jhy  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import linear_scan as tls  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import hybrid as thy  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

from test_torch_ssm import perturbed  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
INACTIVE = 1 << 30
S_MAX, PS = 32, 4
STATE = ("k", "v", "h", "conv")


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.reduced_config(jconfigs.get_config("hymba-1.5b"))
    tcfg = treg.reduced_config(tconfigs.get_config("hymba-1.5b"))
    assert (jcfg.num_layers, jcfg.d_model, jcfg.num_heads, jcfg.num_kv_heads,
            jcfg.head_dim, jcfg.window, jcfg.ssm_state, jcfg.vocab_size) == \
        (tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads,
         tcfg.head_dim, tcfg.window, tcfg.ssm_state, tcfg.vocab_size) == \
        (2, 64, 4, 1, 16, 8, 4, 512)
    numpy_params = perturbed(jhy.init(jcfg, jax.random.PRNGKey(0)),
                             {"logA": 0.5})
    jparams = jax.tree.map(jnp.asarray, numpy_params)
    tparams = bridge.params_from_numpy(numpy_params, "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _assert_cache(jc, tc, keys=STATE):
    assert set(jc) == set(tc)
    for key in keys:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL, err_msg=key)
    for key in ("slot_pos", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=key)


def test_init_has_the_reference_layout(models):
    jcfg, _, tcfg, _ = models
    jp = jax.tree.map(np.asarray, jhy.init(jcfg, jax.random.PRNGKey(1)))
    tp = thy.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert set(jflat) == set(tflat)
    for path, a in jflat.items():
        b = tflat[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if np.all(a == a.flat[0]):
            np.testing.assert_array_equal(b, a, err_msg=str(path))


@pytest.mark.parametrize("T", [1, 2, 5, 8, 13])
def test_associative_scan_matches_reference(T):
    """``_ssm_scan_assoc`` against ``repro``'s (``lax.associative_scan``)
    and against the sequential plain scan, odd and even lengths."""
    rng = np.random.default_rng(T)
    B, D, N = 2, 6, 4
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D)))).astype(np.float32)
    b = rng.standard_normal((B, T, N)).astype(np.float32)
    c = rng.standard_normal((B, T, N)).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((D, N))).astype(np.float32)
    h0 = 0.1 * rng.standard_normal((B, D, N)).astype(np.float32)
    args = (x, dt, b, c, a, h0)
    ty, th = thy._ssm_scan_assoc(*map(torch.from_numpy, args))
    jy, jh = jhy._ssm_scan_assoc(*map(jnp.asarray, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    sy, sh = jhy._ssm_scan(*map(jnp.asarray, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(sy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(sh), **TOL)


@pytest.mark.parametrize("scan_impl,attn_impl", [
    ("scan", "einsum"), ("assoc", "einsum"), ("pallas", "einsum"),
    ("auto", "einsum"), ("scan", "pallas"), ("scan", "chunked")])
def test_forward_matches_reference(models, scan_impl, attn_impl):
    """Full-sequence logits (B=2, S=19, longer than the window) through
    each scan route and attention impl ('pallas': the flash kernel's path
    with the window; on the CPU the scan's 'pallas' and 'auto' run the
    plain version behind the wrapper), against ``repro`` through the same
    names ('auto' against ``repro``'s default 'scan'); then the prefill
    step."""
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(1, (2, 19))
    jimpl = "scan" if scan_impl == "auto" else scan_impl
    jl, _ = jhy.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                        compute_dtype=jnp.float32, attn_impl=attn_impl,
                        scan_impl=jimpl)
    tls.reset_launches()
    tl, _ = thy.forward(tparams, tcfg, torch.from_numpy(toks),
                        attn_impl=attn_impl, scan_impl=scan_impl)
    assert tls.LAUNCHES["selective_scan"] == 0
    assert tl.shape == (2, 19, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jpre = jsteps.make_prefill(jreg.get_model(jcfg), attn_impl=attn_impl,
                               compute_dtype=jnp.float32)
    tpre = tsteps.make_prefill(treg.get_model(tcfg), attn_impl=attn_impl,
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(
        tpre(tparams, {"tokens": torch.from_numpy(toks)}).numpy(),
        np.asarray(jpre(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})),
        **TOL)


@pytest.mark.parametrize("attn_impl", ["pallas", "einsum"])
def test_prefill_chunks_then_decode_match_reference(models, attn_impl):
    """Two slots prefill a 6-token first chunk (through the flash kernel's
    path with 'pallas') and a 7-token continuation that wraps the 8-row
    ring, into a fresh ring cache; the cache is spliced into rows 0 and 2
    of a 3-slot serving cache whose slot 1 is free, and 5 decode steps run
    at per-slot positions. Logits, the ring (rows and positions) and the
    SSM state stay allclose; the freed slot's rows stay untouched."""
    jcfg, jparams, tcfg, tparams = models
    jmodel, tmodel = jreg.get_model(jcfg), treg.get_model(tcfg)
    toks = _tokens(2, (2, 13))
    jfirst = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32,
                                       s_max=S_MAX, first=True,
                                       attn_impl=attn_impl)
    jcont = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32,
                                      attn_impl=attn_impl)
    tfirst = tsteps.make_prefill_chunk(tmodel, s_max=S_MAX, first=True,
                                       attn_impl=attn_impl,
                                       compute_dtype=torch.float32)
    tcont = tsteps.make_prefill_chunk(tmodel, attn_impl=attn_impl,
                                      compute_dtype=torch.float32)
    jl, jc = jfirst(jparams, {"tokens": jnp.asarray(toks[:, :6], jnp.int32)})
    tl, tc = tfirst(tparams, {"tokens": torch.from_numpy(toks[:, :6])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache(jc, tc)
    jl, jc = jcont(jparams, jc, {"tokens": jnp.asarray(toks[:, 6:],
                                                       jnp.int32)})
    tl, tc = tcont(tparams, tc, {"tokens": torch.from_numpy(toks[:, 6:])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache(jc, tc)
    assert (tc["slot_pos"].numpy() >= 8).any()            # the ring wrapped

    jserve = jreg.vectorize_cache_pos(
        jhy.init_cache(jcfg, 3, S_MAX, jnp.float32), 3, inactive=True)
    tserve = treg.vectorize_cache_pos(
        thy.init_cache(tcfg, 3, S_MAX, device="cpu"), 3, inactive=True)
    jserve = jreg.insert_cache_rows(jserve, jc, jnp.asarray([0, 2]))
    tserve = treg.insert_cache_rows(tserve, tc, torch.tensor([0, 2]))
    _assert_cache(jserve, tserve)
    nxt = np.zeros((3, 1), np.int32)
    nxt[[0, 2], 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(5):
        jl, jserve = jhy.decode_step(jparams, jcfg, jnp.asarray(nxt), jserve,
                                     compute_dtype=jnp.float32)
        tl, tserve = thy.decode_step(tparams, tcfg,
                                     torch.from_numpy(nxt).long(), tserve)
        np.testing.assert_allclose(tl[[0, 2]].numpy(),
                                   np.asarray(jl)[[0, 2]], **TOL)
        _assert_cache(jserve, tserve)
        assert (tserve["slot_pos"][:, 1] == -1).all()
        for key in STATE:
            assert not tserve[key][:, 1].any(), key
        nxt[[0, 2], 0] = np.asarray(
            jnp.argmax(jl[[0, 2], 0, :jcfg.vocab_size], -1))


def test_paged_ring_decode_matches_reference(models):
    """The paged ring: a prefilled 10-token ring spliced into pages of 4
    rows (2 pages per slot, in shuffled pool order) for slots 0 and 2 of a
    3-slot paged cache whose slot 1 holds no pages; 7 decode steps wrap the
    ring again. Logits, the pools (K, V and ring positions) and the SSM
    state against ``repro``'s; the dense ring gives the same logits."""
    jcfg, jparams, tcfg, tparams = models
    jmodel, tmodel = jreg.get_model(jcfg), treg.get_model(tcfg)
    toks = _tokens(3, (2, 10))
    jl, jc = jsteps.make_prefill_chunk(
        jmodel, compute_dtype=jnp.float32, s_max=S_MAX, first=True)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tsteps.make_prefill_chunk(tmodel, s_max=S_MAX, first=True,
                                       compute_dtype=torch.float32)(
        tparams, {"tokens": torch.from_numpy(toks)})
    W = treg.cache_capacity(tcfg, S_MAX)
    assert W == jreg.cache_capacity(jcfg, S_MAX) == 8
    P = 6
    jpc = jreg.init_paged_cache(jmodel, 3, S_MAX, page_size=PS, num_pages=P,
                                dtype=jnp.float32)
    tpc = treg.init_paged_cache(tmodel, 3, S_MAX, page_size=PS, num_pages=P,
                                device="cpu")
    assert set(jpc) == set(tpc)
    for key in jpc:
        assert tuple(jpc[key].shape) == tuple(tpc[key].shape), key
        np.testing.assert_array_equal(tpc[key].numpy(), np.asarray(jpc[key]))
    bt = np.full((3, S_MAX // PS), -1, np.int32)
    bt[0, :2], bt[2, :2] = [4, 1], [0, 5]
    phys = np.full((2, W), P * PS, np.int64)
    for i, slot in enumerate((0, 2)):
        phys[i] = bt[slot][np.arange(W) // PS] * PS + np.arange(W) % PS
    jpc = jreg.insert_cache_rows_paged(
        dict(jpc, block_tables=jnp.asarray(bt)), jc, jnp.asarray([0, 2]),
        jnp.asarray(phys, jnp.int32))
    tpc["block_tables"].copy_(torch.from_numpy(bt))
    tpc = treg.insert_cache_rows_paged(tpc, tc, torch.tensor([0, 2]),
                                       torch.from_numpy(phys))
    _assert_cache(jpc, tpc)
    dense = treg.insert_cache_rows(treg.vectorize_cache_pos(
        thy.init_cache(tcfg, 3, S_MAX, device="cpu"), 3, inactive=True),
        tc, torch.tensor([0, 2]))
    nxt = np.zeros((3, 1), np.int32)
    nxt[[0, 2], 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(7):
        jl, jpc = jhy.decode_step(jparams, jcfg, jnp.asarray(nxt), jpc,
                                  compute_dtype=jnp.float32)
        tl, tpc = thy.decode_step(tparams, tcfg, torch.from_numpy(nxt).long(),
                                  tpc)
        dl, dense = thy.decode_step(tparams, tcfg,
                                    torch.from_numpy(nxt).long(), dense)
        np.testing.assert_allclose(tl[[0, 2]].numpy(),
                                   np.asarray(jl)[[0, 2]], **TOL)
        assert torch.equal(tl[[0, 2]], dl[[0, 2]])
        _assert_cache(jpc, tpc)
        nxt[[0, 2], 0] = np.asarray(
            jnp.argmax(jl[[0, 2], 0, :jcfg.vocab_size], -1))
    assert int(tpc["slot_pos"].max()) == 16


def test_decode_matches_forward(models):
    """Token-by-token decode on a lockstep ring cache reproduces the
    forward's logits past the window (the port alone)."""
    _, _, tcfg, tparams = models
    toks = torch.from_numpy(_tokens(4, (2, 14)))
    full, _ = thy.forward(tparams, tcfg, toks)
    cache = thy.init_cache(tcfg, 2, S_MAX, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = thy.decode_step(tparams, tcfg, toks[:, t:t + 1], cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_scan_prefill_matches_reference(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(5, (2, 11))
    jpre = jsteps.make_prefill(jreg.get_model(jcfg), return_cache=True,
                               s_max=S_MAX, compute_dtype=jnp.float32)
    tpre = tsteps.make_prefill(treg.get_model(tcfg), return_cache=True,
                               s_max=S_MAX,
                               compute_dtype=torch.float32)
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tpre(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache(jc, tc)


def test_paged_decode_takes_only_the_einsum_read(models):
    """The hybrid ring is not a paged-kernel family: asking its decode for
    the kernel read raises instead of running another path."""
    _, _, tcfg, tparams = models
    cache = treg.init_paged_cache(treg.get_model(tcfg), 2, S_MAX,
                                  page_size=PS, num_pages=4, device="cpu")
    with pytest.raises(ValueError, match="masked einsum only"):
        thy.decode_step(tparams, tcfg, torch.zeros((2, 1), dtype=torch.long),
                        cache, paged_attn_impl="kernel")
