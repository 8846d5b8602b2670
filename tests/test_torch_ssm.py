"""The port's rwkv6 (``models/ssm.py``) against ``repro.models.ssm`` on the
reduced rwkv6-7b (2 layers, d_model 64, 4 heads of 16, vocab 512) with
bridged weights: the parameter layout, the full-sequence forward through
every ``scan_impl`` and the prefill step built on it, prefill chunks then
decode steps at per-slot positions next to a freed slot (logits and every
state leaf), decode against the forward, and the scan anchor.

``repro``'s init leaves ``u``, ``mu``, ``mu_x``, ``lora_B`` and ``wB`` at
zero, which makes the decay a constant exp(-exp(-2)) and drops the bonus
term; the weights here carry seeded numpy noise on those leaves (u, mu,
mu_x ~ 0.1 N(0, 1); lora_B, wB ~ 0.01 N(0, 1)), the same in both packages,
so that data-dependent decay, the bonus and the DDLerp mix are exercised.

Logits and state leaves must be allclose at rtol 1e-4, atol 1e-5: each
package computes the same fp32 network, but XLA and PyTorch sum every
matmul, einsum and norm in their own order, and those last-bit
differences compound through two layers, the final norm and the vocab
projection. Decode against the forward (one package) is held to the same
tolerance; ``repro``'s own test allows 3e-3."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import linear_scan as tls  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
INACTIVE = 1 << 30
NOISE = {"u": 0.1, "mu": 0.1, "mu_x": 0.1, "lora_B": 0.01, "wB": 0.01}


def perturbed(jparams, noise, seed=0):
    """``jparams`` with seeded N(0, 1) noise times ``noise[leaf]`` added to
    those layer leaves, as numpy arrays (both packages get these)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jparams)
    layers = dict(params["layers"])
    for key, scale in noise.items():
        layers[key] = (layers[key] + scale * rng.standard_normal(
            layers[key].shape)).astype(np.float32)
    return dict(params, layers=layers)


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.reduced_config(jconfigs.get_config("rwkv6-7b"))
    tcfg = treg.reduced_config(tconfigs.get_config("rwkv6-7b"))
    assert (jcfg.num_layers, jcfg.d_model, jcfg.num_heads, jcfg.head_dim,
            jcfg.vocab_size, jcfg.d_ff) == \
        (tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.head_dim,
         tcfg.vocab_size, tcfg.d_ff) == (2, 64, 4, 16, 512, 128)
    numpy_params = perturbed(jssm.init(jcfg, jax.random.PRNGKey(0)), NOISE)
    jparams = jax.tree.map(jnp.asarray, numpy_params)
    tparams = bridge.params_from_numpy(numpy_params, "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _assert_state(jc, tc):
    assert set(jc) == set(tc)
    for key in ("S", "x_tm", "x_cm"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL, err_msg=key)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_init_has_the_reference_layout(models):
    """Same leaf names, layer-stacked shapes, dtypes and constant leaves
    (zeros, ones, -2) as ``repro``'s init, so weights bridge unchanged."""
    jcfg, _, tcfg, _ = models
    jp = jax.tree.map(np.asarray, jssm.init(jcfg, jax.random.PRNGKey(1)))
    tp = tssm.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert set(jflat) == set(tflat)
    for path, a in jflat.items():
        b = tflat[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if np.all(a == a.flat[0]):          # a constant leaf
            np.testing.assert_array_equal(b, a, err_msg=str(path))
    std = tflat[(jax.tree_util.DictKey("layers"),
                 jax.tree_util.DictKey("lora_A"))].std()
    assert abs(std - 5 ** -0.5) < 0.05      # repro's fan-in: the first axis


@pytest.mark.parametrize("scan_impl", ["scan", "pallas", "auto"])
def test_forward_matches_reference(models, scan_impl):
    """Full-sequence logits (B=2, S=21) through each route (on the CPU
    'pallas' and 'auto' run the plain recurrence behind the wrapper, with
    no launch), against ``repro`` through the same impl name ('auto' is
    held to ``repro``'s default, 'scan'); then the prefill step."""
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(1, (2, 21))
    jimpl = "scan" if scan_impl == "auto" else scan_impl
    jl, _ = jssm.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                         compute_dtype=jnp.float32, scan_impl=jimpl)
    tls.reset_launches()
    tl, aux = tssm.forward(tparams, tcfg, torch.from_numpy(toks),
                           scan_impl=scan_impl)
    assert tls.LAUNCHES["wkv6"] == 0
    assert tl.shape == (2, 21, tcfg.padded_vocab) and set(aux) == {
        "moe_aux", "moe_z"}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jpre = jsteps.make_prefill(jreg.get_model(jcfg),
                               compute_dtype=jnp.float32)
    tpre = tsteps.make_prefill(treg.get_model(tcfg),
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(
        tpre(tparams, {"tokens": torch.from_numpy(toks)}).numpy(),
        np.asarray(jpre(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})),
        **TOL)


def test_prefill_chunks_then_decode_match_reference(models):
    """Two slots prefill a 9-token first chunk and a 5-token continuation
    into a fresh cache (the engine's transient cache); the state is then
    spliced into rows 0 and 2 of a 3-slot serving cache whose slot 1 is
    free, and 4 decode steps run at per-slot positions. Logits and every
    state leaf stay allclose; the freed slot's state stays zero bit for
    bit."""
    jcfg, jparams, tcfg, tparams = models
    jmodel, tmodel = jreg.get_model(jcfg), treg.get_model(tcfg)
    toks = _tokens(2, (2, 14))
    jfirst = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32,
                                       s_max=32, first=True)
    jcont = jsteps.make_prefill_chunk(jmodel, compute_dtype=jnp.float32)
    tfirst = tsteps.make_prefill_chunk(tmodel, s_max=32, first=True,
                                       compute_dtype=torch.float32)
    tcont = tsteps.make_prefill_chunk(tmodel,
                                      compute_dtype=torch.float32)
    jl, jc = jfirst(jparams, {"tokens": jnp.asarray(toks[:, :9], jnp.int32)})
    tl, tc = tfirst(tparams, {"tokens": torch.from_numpy(toks[:, :9])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_state(jc, tc)
    jl, jc = jcont(jparams, jc, {"tokens": jnp.asarray(toks[:, 9:],
                                                       jnp.int32)})
    tl, tc = tcont(tparams, tc, {"tokens": torch.from_numpy(toks[:, 9:])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_state(jc, tc)

    jserve = jreg.vectorize_cache_pos(
        jssm.init_cache(jcfg, 3, 32, jnp.float32), 3, inactive=True)
    tserve = treg.vectorize_cache_pos(
        tssm.init_cache(tcfg, 3, 32, device="cpu"), 3, inactive=True)
    jserve = jreg.insert_cache_rows(jserve, jc, jnp.asarray([0, 2]))
    tserve = treg.insert_cache_rows(tserve, tc, torch.tensor([0, 2]))
    _assert_state(jserve, tserve)
    nxt = np.zeros((3, 1), np.int32)
    nxt[[0, 2], 0] = np.asarray(jnp.argmax(jl[:, 0, :jcfg.vocab_size], -1))
    for _ in range(4):
        jl, jserve = jssm.decode_step(jparams, jcfg, jnp.asarray(nxt), jserve,
                                      compute_dtype=jnp.float32)
        tl, tserve = tssm.decode_step(tparams, tcfg,
                                      torch.from_numpy(nxt).long(), tserve)
        np.testing.assert_allclose(tl[[0, 2]].numpy(),
                                   np.asarray(jl)[[0, 2]], **TOL)
        _assert_state(jserve, tserve)
        for key in ("S", "x_tm", "x_cm"):
            assert not tserve[key][:, 1].any(), key
        nxt[[0, 2], 0] = np.asarray(
            jnp.argmax(jl[[0, 2], 0, :jcfg.vocab_size], -1))


def test_decode_matches_forward(models):
    """Token-by-token decode on a lockstep (scalar pos) cache reproduces
    the forward's logits at every position (tests/test_models.py's check,
    in the port alone)."""
    _, _, tcfg, tparams = models
    toks = torch.from_numpy(_tokens(3, (2, 10)))
    full, _ = tssm.forward(tparams, tcfg, toks)
    cache = tssm.init_cache(tcfg, 2, 16, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = tssm.decode_step(tparams, tcfg, toks[:, t:t + 1], cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)
    assert int(cache["pos"]) == 10


def test_scan_prefill_matches_reference(models):
    """The scan anchor: the prompt teacher-forced through decode_step into
    a fresh cache, last logits and state against ``repro``'s."""
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(4, (2, 7))
    jpre = jsteps.make_prefill(jreg.get_model(jcfg), return_cache=True,
                               s_max=16, compute_dtype=jnp.float32)
    tpre = tsteps.make_prefill(treg.get_model(tcfg), return_cache=True,
                               s_max=16,
                               compute_dtype=torch.float32)
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tpre(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_state(jc, tc)


def test_paged_cache_raises_the_reference_error(models):
    """rwkv has nothing to page: ``init_paged_cache`` raises ``repro``'s
    ValueError, and the cache capacity is s_max in both packages."""
    jcfg, _, tcfg, _ = models
    with pytest.raises(ValueError) as jerr:
        jreg.init_paged_cache(jreg.get_model(jcfg), 2, 32, page_size=8,
                              num_pages=8)
    with pytest.raises(ValueError) as terr:
        treg.init_paged_cache(treg.get_model(tcfg), 2, 32, page_size=8,
                              num_pages=8)
    assert str(terr.value) == str(jerr.value)
    assert treg.cache_capacity(tcfg, 32) == jreg.cache_capacity(jcfg, 32)
