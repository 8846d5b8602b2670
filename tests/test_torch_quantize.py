"""The port's quantization against ``repro.core.quantize``. The KV page:
the int8 payload and the f32 scale of ``quantize_page`` are bit-equal to
the reference's on seeded pages (whole, partial-valid, all-zero, and one
with exact .5 ties that round half to even), and ``page_scale`` is
bit-equal on amax tables with zeros. The paper's pipeline: ``fixed_point``
and ``fixed_point_tree`` (half-quantum ties, values outside the clip
range), ``quantize_per_channel``, ``quantize_params`` (the same leaves and
the same names, with and without a predicate) and ``dequantize_params``
(f32 and bf16) bit-equal; ``quantized_bytes`` and
``calibrate_activation_scale`` equal; ``quantization_error`` with the same
keys in the same order, values within 1e-5 (f32 norms summed in other
orders); and the quantization ladder of a small ResNet trained in JAX
(fp32, folded, fixed16, int8) giving the reference's accuracies. No
tolerance elsewhere: both sides divide in f32 and round half to even."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quantize as jq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402


def _both(x, valid=None):
    got = tq.quantize_page(torch.from_numpy(x),
                           None if valid is None else torch.from_numpy(valid))
    want = jq.quantize_page(jnp.asarray(x),
                            None if valid is None else jnp.asarray(valid))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _pages():
    rng = np.random.default_rng(13)
    # amax 127 gives scale 1.0 exactly, so x / scale = x lands on the ties
    tie_page = np.zeros((16, 2, 4), np.float32)
    tie_page.flat[:18] = np.arange(-9, 9, dtype=np.float32) + 0.5
    tie_page.flat[18] = 127.0
    return {
        "gaussian": rng.standard_normal((16, 2, 8)).astype(np.float32),
        "wide": (rng.standard_normal((16, 8, 128)) * 40).astype(np.float32),
        "ties": tie_page,
        "zero": np.zeros((16, 1, 16), np.float32),
    }


@pytest.mark.parametrize("name", list(_pages()))
def test_quantize_page_bit_equal(name):
    x = _pages()[name]
    (q, s), (wq, ws) = _both(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, wq)
    np.testing.assert_array_equal(s, ws)
    if name == "zero":
        assert s == 1.0 and not q.any()


@pytest.mark.parametrize("n_valid", [0, 1, 7, 16])
def test_quantize_partial_page_bit_equal(n_valid):
    """Rows past the write frontier are out of the amax and stored as 0;
    a page with no valid row gets scale 1.0."""
    rng = np.random.default_rng(14 + n_valid)
    x = (rng.standard_normal((16, 2, 8)) * 5).astype(np.float32)
    x[n_valid:] *= 100.0            # stale rows would dominate the amax
    valid = np.arange(16) < n_valid
    (q, s), (wq, ws) = _both(x, valid)
    np.testing.assert_array_equal(q, wq)
    np.testing.assert_array_equal(s, ws)
    assert not q[n_valid:].any()
    if n_valid == 0:
        assert s == 1.0


def test_page_scale_bit_equal():
    rng = np.random.default_rng(15)
    amax = np.abs(rng.standard_normal((4, 9))).astype(np.float32)
    amax[0, :3] = 0.0
    np.testing.assert_array_equal(
        tq.page_scale(torch.from_numpy(amax)).numpy(),
        np.asarray(jq.page_scale(jnp.asarray(amax))))


# ----------------------------------------------------- the paper's pipeline

def _fixed_point_inputs():
    """Random values, every half-quantum tie (2j + 1) / 2^12 near 0 and at
    the range's ends, and values far outside the Q4.11 range."""
    rng = np.random.default_rng(16)
    ties = (2 * np.arange(-40, 40) + 1) / 4096.0
    edge = np.array([16.0, -16.0, 15.99951171875, 15.999755859375,
                     -15.999755859375, -16.000244140625, 1e6, -1e6, 17.5,
                     -300.25, 0.0, -0.0])
    return np.concatenate([rng.standard_normal(200) * 6, ties, edge,
                           ties + 8.0]).astype(np.float32)


@pytest.mark.parametrize("bits", [(4, 11), (2, 5), (7, 8)])
def test_fixed_point_bit_equal(bits):
    x = _fixed_point_inputs()
    got = tq.fixed_point(torch.from_numpy(x), *bits).numpy()
    want = np.asarray(jq.fixed_point(jnp.asarray(x), *bits))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # ties round half to even and out-of-range values clip
    lo, hi = -(2.0 ** (bits[0] + bits[1])), 2.0 ** (bits[0] + bits[1]) - 1
    assert got.min() >= lo / 2 ** bits[1] and got.max() <= hi / 2 ** bits[1]


def _tree(seed):
    """A small folded ResNet-shaped tree with a tuple, an int leaf and 1-D
    leaves: numpy leaves, handed to both packages."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    zero_channel = f(3, 3, 4, 8)
    zero_channel[..., 5] = 0.0
    # every column's amax is 127 (scale 1.0), so the second row's values
    # sit on .5 ties after the division
    ties = np.stack([np.full(6, 127.0), [0.5, -1.5, 2.5, 3.5, -0.5, 126.5]]
                    ).astype(np.float32)
    return {"stem": {"w": f(3, 3, 3, 4), "b": f(4)},
            "stages": [[{"conv1": {"w": zero_channel, "b": f(8)},
                         "proj": {"w": f(1, 1, 4, 8), "b": f(8)}}],
                       [{"conv1": {"w": f(3, 3, 8, 8), "b": f(8)}}]],
            "head": {"w": f(8, 10), "b": f(10)},
            "extra": (ties, np.arange(6, dtype=np.int32)),
            "scalar_table": f(5)}


def _both_trees(seed=17):
    tree = _tree(seed)
    return (bridge.params_from_numpy(tree, "cpu"),
            jax.tree.map(jnp.asarray, tree))


def _leaves(tree):
    """Flattened leaves as numpy, QuantizedTensors as (q, scale)."""
    out = []
    for leaf in jax.tree.leaves(tree, is_leaf=lambda t: isinstance(
            t, (tq.QuantizedTensor, jq.QuantizedTensor))):
        if isinstance(leaf, (tq.QuantizedTensor, jq.QuantizedTensor)):
            out.append(tuple(np.asarray(x) for x in (leaf.q, leaf.scale)))
        else:
            out.append(np.asarray(leaf))
    return out


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert type(a) is type(b)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_fixed_point_tree_bit_equal():
    t, j = _both_trees()
    got = jax.tree.map(lambda x: x.numpy(), tq.fixed_point_tree(t))
    _assert_trees_equal(got, jq.fixed_point_tree(j))


@pytest.mark.parametrize("shape,axis", [((8, 16), -1), ((3, 3, 4, 8), -1),
                                        ((3, 3, 4, 8), 0), ((7,), -1),
                                        ((2, 6), -1)])
def test_quantize_per_channel_bit_equal(shape, axis):
    """Random weights with one all-zero channel (scale 1.0), and a tensor
    whose values sit on .5 ties (rounded half to even)."""
    rng = np.random.default_rng(18)
    w = (rng.standard_normal(shape) * 3).astype(np.float32)
    if shape == (2, 6):
        w = _tree(17)["extra"][0]
    elif len(shape) > 1:
        np.moveaxis(w, axis, 0)[0] = 0.0
    got = tq.quantize_per_channel(torch.from_numpy(w), axis)
    want = jq.quantize_per_channel(jnp.asarray(w), axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequant().numpy(),
                                  np.asarray(want.dequant()))


@pytest.mark.parametrize("select", ["all", "convs only", "none"])
def test_quantize_params_same_leaves_and_names(select):
    """The same leaves quantized, bit for bit, and the predicate sees the
    same names, in the same order, as the reference's."""
    t, j = _both_trees()
    seen = {"port": [], "ref": []}

    def predicate(side):
        def pick(name, leaf):
            seen[side].append((name, tuple(leaf.shape)))
            return select == "convs only" and "['head']" not in name
        return None if select == "all" else pick
    got = tq.quantize_params(t, predicate=predicate("port"))
    want = jq.quantize_params(j, predicate=predicate("ref"))
    _assert_trees_equal(got, want)
    assert seen["port"] == seen["ref"]
    if select != "all":
        assert "['stages']/[0]/[0]/['conv1']/['w']" in dict(seen["port"])
    n_q = sum(isinstance(x, tuple) for x in _leaves(got))
    assert n_q == {"all": 6, "convs only": 5, "none": 0}[select]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_params_bit_equal(dtype):
    t, j = _both_trees()
    args = () if dtype == "bfloat16" else (getattr(torch, dtype),)
    jargs = () if dtype == "bfloat16" else (getattr(jnp, dtype),)
    got = tq.dequantize_params(tq.quantize_params(t), *args)
    want = jq.dequantize_params(jq.quantize_params(j), *jargs)
    assert got["head"]["w"].dtype == getattr(torch, dtype)
    g = [x.float().numpy() for x in jax.tree.leaves(got)]
    w = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


def test_quantized_bytes_and_errors_equal():
    """quantized_bytes equal; quantization_error has the same keys in the
    same order and values within 1e-5 (f32 norms summed in other orders)."""
    t, j = _both_trees()
    qt, qj = tq.quantize_params(t), jq.quantize_params(j)
    assert tq.quantized_bytes(qt) == jq.quantized_bytes(qj)
    assert tq.quantized_bytes(t) == jq.quantized_bytes(j)
    got, want = tq.quantization_error(t, qt), jq.quantization_error(j, qj)
    assert list(got) == list(want) and len(got) == 6
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("percentile", [99.9, 99.0, 50.0, 100.0])
def test_calibrate_activation_scale_equal(percentile):
    x = np.random.default_rng(19).standard_normal((4, 33, 17)).astype(
        np.float32) * 3
    got = tq.calibrate_activation_scale(torch.from_numpy(x), percentile)
    want = jq.calibrate_activation_scale(jnp.asarray(x), percentile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def trained_resnet():
    """A small ResNet (one block per stage, widths 4, 8, 16) trained in JAX
    on the synthetic CIFAR task, as ``tests/test_quantize.py`` trains its
    model, cut to 120 steps of 128 images."""
    from repro.configs.resnet20_cifar import ResNetConfig
    from repro.data.synthetic import synthetic_cifar
    from repro.models import resnet
    from repro.optim.adamw import AdamW, apply_updates

    cfg = ResNetConfig(num_blocks=(1, 1, 1), widths=(4, 8, 16))
    params = resnet.init(cfg, jax.random.PRNGKey(0))
    opt = AdamW(learning_rate=2e-2, weight_decay=1e-4)
    opt_state = opt.init(params)
    xs, ys = synthetic_cifar(1024, seed=1)

    @jax.jit
    def step(params, opt_state, bx, by):
        def loss_fn(p):
            logits = resnet.forward(p, cfg, bx)
            onehot = jax.nn.one_hot(by, cfg.num_classes)
            return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))
        grads = jax.grad(loss_fn)(params)
        updates, opt_state, _ = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state

    bs = 128
    for i in range(120):
        j = (i * bs) % (len(ys) - bs)
        params, opt_state = step(params, opt_state, xs[j:j + bs],
                                 ys[j:j + bs])
    return cfg, jax.tree.map(np.asarray, params)


def test_quantization_ladder_equals_reference(trained_resnet):
    """The paper's ladder (fp32, BN folded, 16-bit fixed point, int8 PTQ)
    on held-out synthetic images: the port's accuracies equal the
    reference's, and its predictions differ only where the reference's two
    best logits lie within 1e-4."""
    from repro.models import resnet as jresnet
    from repro_torch.configs.resnet20_cifar import ResNetConfig
    from repro_torch.data.synthetic import synthetic_cifar
    from repro_torch.models import resnet as tresnet

    jcfg, params = trained_resnet
    tcfg = ResNetConfig(num_blocks=(1, 1, 1), widths=(4, 8, 16))
    xt, yt = synthetic_cifar(256, seed=2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.params_from_numpy(params, "cpu")
    jf, tf = jresnet.fold_bn(jp), tresnet.fold_bn(tp)
    ladder = {
        "fp32": ((tp, False), (jp, False)),
        "folded": ((tf, True), (jf, True)),
        "fixed16": ((tq.fixed_point_tree(tf), True),
                    (jq.fixed_point_tree(jf), True)),
        "int8": ((tq.dequantize_params(tq.quantize_params(tf),
                                       torch.float32), True),
                 (jq.dequantize_params(jq.quantize_params(jf), jnp.float32),
                  True)),
    }
    acc = {}
    for rung, ((tparams, tfold), (jparams, jfold)) in ladder.items():
        got = tresnet.forward(tparams, tcfg, torch.from_numpy(xt),
                              folded=tfold).numpy()
        want = np.asarray(jresnet.forward(jparams, jcfg, jnp.asarray(xt),
                                          folded=jfold))
        top2 = np.sort(want, -1)[:, -2:]
        near_tie = top2[:, 1] - top2[:, 0] <= 1e-4
        differ = got.argmax(-1) != want.argmax(-1)
        assert not (differ & ~near_tie).any(), rung
        acc[rung] = (float(np.mean(got.argmax(-1) == yt)),
                     float(np.mean(want.argmax(-1) == yt)))
        if not differ.any():
            assert acc[rung][0] == acc[rung][1]
    assert acc["fp32"][1] > 0.8, acc             # the model did train
