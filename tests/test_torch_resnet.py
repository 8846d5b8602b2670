"""The port's ResNet20 / CIFAR path against ``repro``'s: params in the
reference's layout drawn from a seeded numpy generator, BN running
statistics included (so folding is not the identity), go to both
packages; then ``_im2col`` (bit-equal: slices and a concatenation), the
per-conv GEMM table, ``fold_bn`` and ``forward`` for ``impl="lax"``,
``impl="im2col"`` with the plain ``@`` and through each dataflow of
``ops.matmul`` (the reference's Pallas kernel in interpret mode), folded
and unfolded, agree, on a small config (one block per stage, widths 4, 8,
16) and on the full ResNet20, at batch 2. Also the synthetic CIFAR task
(bit-equal arrays) and the CIFAR binary format (bytes written, and arrays
read back, equal to the reference's).

Tolerance for logits: rtol = atol = 1e-4 (fp32 convolutions and GEMMs
summed in other orders through up to 21 layers); top-1 equal wherever the
reference's two best logits are more than 1e-4 apart."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.resnet20_cifar import ResNetConfig as JConfig  # noqa: E402
from repro.data import cifar as jcifar  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.resnet20_cifar import CONFIG  # noqa: E402
from repro_torch.configs.resnet20_cifar import ResNetConfig  # noqa: E402
from repro_torch.data import cifar as tcifar  # noqa: E402
from repro_torch.data import synthetic as tsynth  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import resnet as tresnet  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = {"small": dict(num_blocks=(1, 1, 1), widths=(4, 8, 16)),
           "resnet20": {}}
DATAFLOWS = ("output_stationary", "weight_stationary", "input_stationary")


def numpy_params(cfg, seed):
    """Params in the reference's layout (``resnet.init``'s tree, traced for
    its shapes only) drawn from numpy: He-scaled convs, a small head, and
    BN running stats and affine terms away from the identity (mean != 0,
    var != 1, scale != 1) so that folding is not the identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jresnet.init(cfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)

    def conv(w):
        fan_in = int(np.prod(w.shape[:3]))
        return (rng.standard_normal(w.shape)
                * np.sqrt(2.0 / fan_in)).astype(np.float32)

    def bn(c):
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    for cb in [tree["stem"]] + [blk[k] for blocks in tree["stages"]
                                for blk in blocks for k in blk]:
        cb["w"] = conv(cb["w"])
        cb["bn"] = bn(cb["w"].shape[-1])
    tree["head"]["w"] = (0.1 * rng.standard_normal(
        tree["head"]["w"].shape)).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _model(name):
    """(port config, reference config, numpy params, images)."""
    kw = CONFIGS[name]
    params = numpy_params(JConfig(**kw), 4)
    images = np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    return ResNetConfig(**kw), JConfig(**kw), params, images


def _close_with_top1(got, want):
    np.testing.assert_allclose(got, want, **TOL)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > TOL["atol"]
    assert decided.any()
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided])


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2), (1, 1)])
def test_im2col_equal(k, stride):
    x = np.random.default_rng(6).standard_normal((2, 8, 8, 5)).astype(
        np.float32)
    pad = (k - 1) // 2
    got = tresnet._im2col(torch.from_numpy(x), k, stride, pad)
    want = jresnet._im2col(jnp.asarray(x), k, stride, pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch", [1, 256])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_conv_layer_shapes_equal(name, batch):
    tcfg, jcfg, _, _ = _model(name)
    got = tresnet.conv_layer_shapes(tcfg, batch)
    assert got == jresnet.conv_layer_shapes(jcfg, batch)
    if tcfg == CONFIG:
        assert len(got) == 21
        assert sum(2 * m * k * n for _, m, k, n in got) == 81_625_088 * batch


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fold_bn_allclose(name):
    params = _model(name)[2]
    got = tresnet.fold_bn(bridge.params_from_numpy(params, "cpu"))
    want = jresnet.fold_bn(jax.tree.map(jnp.asarray, params))
    got_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


# (port matmul_fn, reference matmul_fn) per im2col route
ROUTES = {"plain @": (None, None)}
for _df in DATAFLOWS:
    ROUTES[_df] = (
        lambda a, b, df=_df: tops.matmul(a, b, dataflow=df),
        lambda a, b, df=_df: jops.matmul(a, b, block_m=128, block_n=64,
                                         block_k=64, dataflow=df))


# every route on the small config; on the full ResNet20 the Pallas
# dataflows run weight-stationary only (each interpret-mode route costs
# seconds there)
FORWARD_CASES = ([("small", r) for r in ["lax"] + list(ROUTES)]
                 + [("resnet20", r) for r in ("lax", "plain @",
                                              "weight_stationary")])


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("name,route", FORWARD_CASES)
def test_forward_matches_reference(name, route, folded):
    tcfg, jcfg, params, images = _model(name)
    tp = bridge.params_from_numpy(params, "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    if folded:
        tp, jp = tresnet.fold_bn(tp), jresnet.fold_bn(jp)
    impl = "lax" if route == "lax" else "im2col"
    t_fn, j_fn = ROUTES.get(route, (None, None))
    got = tresnet.forward(tp, tcfg, torch.from_numpy(images), folded=folded,
                          impl=impl, matmul_fn=t_fn)
    want = jresnet.forward(jp, jcfg, jnp.asarray(images), folded=folded,
                           impl=impl, matmul_fn=j_fn)
    assert tuple(got.shape) == (2, tcfg.num_classes)
    _close_with_top1(got.numpy(), np.asarray(want))


def test_init_layout_matches_reference():
    """The port's own init: the reference's nesting, shapes and identity
    BN, on the generator's device."""
    gen = torch.Generator().manual_seed(0)
    got = tresnet.init(CONFIG, gen, "cpu")
    want = jax.eval_shape(lambda: jresnet.init(JConfig(),
                                               jax.random.PRNGKey(0)))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, want))
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                    jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    assert float(got["stem"]["bn"]["var"].min()) == 1.0
    assert float(got["head"]["b"].abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 2])
def test_synthetic_cifar_bit_equal(seed):
    got = tsynth.synthetic_cifar(64, seed=seed)
    want = jsynth.synthetic_cifar(64, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_cifar_binary_round_trip(tmp_path):
    """write_binary bytes equal the reference's; read_binary, normalize and
    an ordered pass of batches give equal arrays."""
    images, labels = tsynth.synthetic_cifar(10, seed=3)
    images = (images - images.min()) / (images.max() - images.min())
    tcifar.write_binary(tmp_path / "t.bin", images, labels)
    jcifar.write_binary(tmp_path / "j.bin", images, labels)
    raw = (tmp_path / "t.bin").read_bytes()
    assert raw == (tmp_path / "j.bin").read_bytes()
    assert len(raw) == 10 * tcifar.RECORD_BYTES
    got, want = (tcifar.read_binary(tmp_path / "t.bin"),
                 jcifar.read_binary(tmp_path / "t.bin"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tcifar.normalize(got[0]),
                                  jcifar.normalize(want[0]))
    for (gx, gy), (wx, wy) in zip(
            tcifar.batches(*got, 4, train=False),
            jcifar.batches(*want, 4, train=False)):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    (tmp_path / "bad.bin").write_bytes(raw[:-1])
    with pytest.raises(ValueError, match="corrupt CIFAR binary"):
        tcifar.read_binary(tmp_path / "bad.bin")
