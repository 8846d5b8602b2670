"""The port's GEMMs against the reference. ``ops.matmul`` (the systolic
GEMM, K7) and ``ops.quant_matmul`` (the int8-weight GEMM, K8) run their
plain versions on CPU tensors; they are held against ``repro``'s
``ops.matmul`` / ``ops.quant_matmul`` (the Pallas kernels in interpret
mode, padding to block multiples) on ``tests/test_kernels.py``'s shapes in
every dataflow, fp32 and bf16, against ``repro.kernels.ref``, and, for the
autograd Function's gradients, against ``jax.grad`` of ``repro``'s custom
VJP. The reference's errors (unknown dataflow, K mismatch) are kept, and a
K mismatch that the reference's padding hides is an error in the port.
``gpu``-marked cases hold the CUDA kernels against the plain versions on
the card and skip themselves without one.

Tolerances: rtol = atol = 1e-4 for fp32 (the reference tests' own: both
sides accumulate in f32 in different orders), 2e-2 for bf16 outputs (one
bf16 rounding of the same f32 sum can land one ulp apart), atol 1e-3 for
the int8-weight GEMM (the reference test's). Inputs are seeded numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the card's machine has no JAX: there only the gpu-marked tests run
# (``pytest -m gpu``) and the reference comparisons skip themselves
try:
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = None


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference is not installed")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


DATAFLOWS = ("output_stationary", "weight_stationary", "input_stationary")
SHAPES = [(256, 256, 256), (192, 320, 128), (130, 70, 200), (64, 512, 96)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _xw(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _q8(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.integers(-127, 127, (k, n)).astype(np.int8),
            rng.uniform(0.01, 0.1, n).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("mkn", SHAPES)
def test_matmul_matches_reference(dataflow, mkn):
    x, w = _xw(1, *mkn)
    got = tops.matmul(_t(x), _t(w), dataflow=dataflow)
    want = jops.matmul(jnp.asarray(x), jnp.asarray(w), block_m=64,
                       block_n=64, block_k=64, dataflow=dataflow)
    assert got.dtype == torch.float32 and tuple(got.shape) == mkn[::2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_dtypes(dtype):
    """The output keeps x's dtype; bf16 inputs accumulate in f32."""
    x, w = _xw(2, 128, 128, 128)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tops.matmul(_t(x).to(tdt), _t(w).to(tdt))
    want = jops.matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt), block_m=64,
                       block_n=64, block_k=64)
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", [(128, 256, 192), (256, 128, 64)])
def test_quant_matmul_matches_reference(shape):
    x, wq, sc = _q8(3, *shape)
    got = tops.quant_matmul(_t(x), _t(wq), _t(sc))
    want = jops.quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                             jnp.asarray(sc), block_m=64, block_n=64,
                             block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("case", ["matmul", "matmul_bf16", "quant_matmul"])
def test_plain_versions_match_reference_oracles(case):
    """``ref.matmul`` / ``ref.quant_matmul`` against ``repro.kernels.ref``
    on a ragged shape."""
    if case == "quant_matmul":
        x, wq, sc = _q8(4, 37, 53, 29)
        got = tref.quant_matmul(_t(x), _t(wq), _t(sc)).numpy()
        want = np.asarray(jref.quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                            jnp.asarray(sc)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    x, w = _xw(5, 37, 53, 29)
    if case == "matmul":
        got = tref.matmul(_t(x), _t(w)).numpy()
        want = np.asarray(jref.matmul(jnp.asarray(x), jnp.asarray(w)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        got = tref.matmul(_t(x).bfloat16(), _t(w).bfloat16())
        want = jref.matmul(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_matmul_gradients_match_jax_grad(dataflow):
    """The autograd Function's dx = g @ w^T and dw = x^T @ g against
    ``jax.grad`` through ``repro``'s custom VJP, for a weighted sum."""
    x, w = _xw(6, 130, 70, 96)
    c = np.random.default_rng(7).standard_normal((130, 96)).astype(np.float32)
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    (tops.matmul(tx, tw, dataflow=dataflow) * _t(c)).sum().backward()

    def loss(a, b):
        return jnp.sum(jops.matmul(a, b, block_m=64, block_n=64, block_k=64,
                                   dataflow=dataflow) * jnp.asarray(c))
    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **TOL)


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("case", ["dataflow", "k_mismatch", "quant_k"])
def test_errors_equal_the_reference(case):
    """An unknown dataflow raises the reference's ValueError message; a K
    mismatch raises AssertionError, as the reference's ``assert K == K2``
    does (its message holds the padded shapes, the port's the given ones)."""
    if case == "dataflow":
        args = (np.ones((8, 16), np.float32), np.ones((16, 8), np.float32))
        want = _raised(lambda: jops.matmul(*map(jnp.asarray, args),
                                           dataflow="diagonal"))
        got = _raised(lambda: tops.matmul(*map(_t, args),
                                          dataflow="diagonal"))
        assert type(got) is type(want) is ValueError
        assert str(got) == str(want) == "unknown dataflow 'diagonal'"
        return
    if case == "k_mismatch":
        args = (np.ones((8, 100), np.float32), np.ones((120, 16), np.float32))
        want = _raised(lambda: jops.matmul(*map(jnp.asarray, args)))
        got = _raised(lambda: tops.matmul(*map(_t, args)))
        assert str(got) == str(((8, 100), (120, 16)))
    else:
        args = (np.ones((8, 100), np.float32), np.ones((120, 16), np.int8),
                np.ones(16, np.float32))
        want = _raised(lambda: jops.quant_matmul(*map(jnp.asarray, args)))
        got = _raised(lambda: tops.quant_matmul(*map(_t, args)))
    assert type(got) is type(want) is AssertionError


def test_k_mismatch_the_reference_pads_away_raises():
    """repro pads x's K (130) and w's K (150) to the same block multiple
    (256 at block_k 128) and multiplies the zero-padded operands without a
    word; the port raises on every K mismatch."""
    x, w = np.ones((8, 130), np.float32), np.ones((150, 16), np.float32)
    want = jops.matmul(jnp.asarray(x), jnp.asarray(w))
    assert want.shape == (8, 16) and float(want[0, 0]) == 130.0
    with pytest.raises(AssertionError):
        tops.matmul(_t(x), _t(w))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(monkeypatch):
    """On CPU tensors nothing is built or counted, for every dataflow, the
    backward and the int8 GEMM."""
    from repro_torch.kernels import _build

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")
    monkeypatch.setattr(_build, "load", no_build)
    tmm.reset_launches()
    tqm.reset_launches()
    x, w = _xw(8, 33, 20, 17)
    for df in DATAFLOWS:
        tx = _t(x).requires_grad_()
        out = tops.matmul(tx, _t(w), dataflow=df)
        out.sum().backward()
        assert torch.equal(out, tref.matmul(_t(x), _t(w)))
    xq, wq, sc = _q8(9, 33, 20, 17)
    tops.quant_matmul(_t(xq), _t(wq), _t(sc))
    assert sum(tmm.LAUNCHES.values()) == 0 and tqm.LAUNCHES["quant_matmul"] == 0


# ------------------------------------------------------- the tile plan
# one GEMM of each of ResNet20's shape classes at batch 256, then a K that
# takes several K-chunks and qwen2.5-32b's wo at M = 8
RESNET_B256 = [(262144, 27, 16), (262144, 144, 16), (65536, 144, 32),
               (65536, 288, 32), (65536, 16, 32), (16384, 288, 64),
               (16384, 576, 64), (16384, 32, 64)]
BIG_K, WO = (4096, 5120, 64), (8, 5120, 5120)


def _plan(m, k, n, dataflow="output_stationary", **kw):
    """The plan for contiguous operands (x strides (k, 1), w (n, 1))."""
    return tmm.tile_plan(m, k, n, k, 1, n, 1, dataflow=dataflow, **kw)


@pytest.mark.parametrize("w_bytes", [4, 1])
@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("mkn", RESNET_B256 + SHAPES + [
    BIG_K, WO, (16, 5120, 5120), (17, 5120, 5120), (3, 0, 5),
    (100_000, 27, 1000), (64, 100_000, 8)])
def test_tile_plan_fits_shared_memory(mkn, dataflow, w_bytes):
    """Every plan fits a block's 232,448 bytes of shared memory, its
    K-chunks (a split plan's ranges) cover K, and its grid covers the
    output (a wide plan's blocks sweep M-tiles through every N-panel)."""
    m, k, n = mkn
    p = _plan(m, k, n, dataflow, w_bytes=w_bytes)
    assert p.smem <= tmm.SMEM_MAX == 232_448
    assert p.kc >= 1 and p.chunks * p.kc >= k and p.chunks == -(-k // p.kc)
    if p.skinny:
        assert p.grid == (-(-n // tmm.SK_COLS), 1) and p.bm == m
        return
    assert p.kc % tmm.BK == 0 and p.bm == p.tm * 1024 // p.bn
    if p.schedule == "split":
        tiles = -(-m // p.bm) * -(-n // p.bn)
        assert p.grid == (tiles, p.splits) and p.chunks == p.splits
    elif p.schedule == "wide":
        assert p.grid[0] * p.group * p.bm >= m and p.grid[1] == 1
    elif dataflow == "input_stationary":
        assert p.grid[0] * p.bm >= m and p.grid[1] * p.group * p.bn >= n
    else:
        assert p.grid[0] * p.group * p.bm >= m and p.grid[1] * p.bn >= n


@pytest.mark.parametrize("n", [1, 10, 16, 17, 32, 33, 64])
def test_tile_plan_one_n_tile_up_to_64(n):
    """N <= 64 is one N-tile of the smallest width that covers it."""
    for dataflow in DATAFLOWS:
        p = _plan(65536, 144, n, dataflow)
        assert p.bn == next(t for t in (16, 32, 64) if n <= t)
        assert p.grid[1] == 1


@pytest.mark.parametrize("dataflow", DATAFLOWS + ("quant",))
def test_tile_plan_fills_the_card_at_batch_256(dataflow):
    """Every GEMM of a batch-256 ResNet20 forward runs in one K-chunk (no
    re-streaming of partial sums), at a 4 x 4 micro-tile or larger, on a
    grid of at least one block per SM, or, where the shape has fewer tiles
    than SMs (N = 64 at M = 16384: 128 tiles of 128 x 64), one block per
    tile in a single wave; the batch-1 forward still spreads its GEMMs
    over at least as many blocks as 64 x 64 tiles would."""
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.models import resnet
    kw = (dict(w_bytes=1) if dataflow == "quant"
          else dict(dataflow=dataflow))
    for _, m, k, n in resnet.conv_layer_shapes(CONFIG, 256):
        p = _plan(m, k, n, **kw)
        tiles = -(-m // p.bm) * -(-n // p.bn)
        one_wave = tmm.FILL <= p.blocks == tiles <= tmm.SMS
        assert p.blocks >= tmm.SMS or one_wave, (m, k, n)
        assert p.chunks == 1 and p.tm >= 4, (m, k, n)
    for _, m, k, n in resnet.conv_layer_shapes(CONFIG, 1):
        p = _plan(m, k, n, **kw)
        assert p.blocks >= -(-m // 64) * -(-n // 64), (m, k, n)


@pytest.mark.parametrize("case", ["contiguous", "stem_k27", "misaligned",
                                  "transposed", "bf16"])
def test_tile_plan_takes_16_byte_copies_only_where_x_allows(case):
    """x is staged by 16-byte copies only for fp32 rows that start on 16
    bytes with a unit k stride; the stem's K = 27, a base 4 bytes off, a
    transposed view (the backward's x.t()) and bf16 take the 4-byte or
    plain path."""
    m, k, n = 262144, 144, 16
    kw = dict(x_ptr=256)
    if case == "stem_k27":
        k = 27
    elif case == "misaligned":
        kw = dict(x_ptr=260)
    elif case == "transposed":
        p = tmm.tile_plan(m, k, n, 1, m, n, 1)
        assert not p.vec_x
        return
    elif case == "bf16":
        kw.update(x_bytes=2, w_bytes=2)
    p = _plan(m, k, n, **kw)
    assert p.vec_x == (case == "contiguous")


@pytest.mark.parametrize("m", [1, 8, 16, 17, 64])
def test_tile_plan_skinny_at_m_up_to_16(m):
    """M <= 16 takes the skinny schedule in every dataflow and for K8;
    qwen2.5-32b's wo (M = 8, K = 5120) keeps x resident in one K-chunk and
    streams int8 w by 16-byte copies."""
    for kw in [dict(dataflow=df) for df in DATAFLOWS] + [dict(w_bytes=1)]:
        p = _plan(m, 5120, 5120, **kw)
        assert p.skinny == (m <= 16)
    if m == 8:
        p = _plan(*WO, w_bytes=1)
        assert p.chunks == 1 and p.vec_w and p.blocks == 5120 // 32


# ------------------------------------------------------------- on the card
CARD_SHAPES = SHAPES + [(1, 1, 1), (1024, 27, 16), (1000, 144, 16),
                        (257, 576, 64), (63, 16, 32), (8, 5120, 100),
                        (3, 0, 5)] + [(262144, 27, 16), (262144, 144, 16),
                                      (65536, 288, 32), (65536, 16, 32),
                                      (16384, 576, 64), BIG_K, WO]


def _card_tol(want, tol=1e-4):
    """1e-4 of the output's largest magnitude (fp32 sums in another order:
    the kernel's FMA chain against the library's blocked sum)."""
    return dict(rtol=tol, atol=tol * max(1.0, float(want.abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("mkn", CARD_SHAPES)
def test_matmul_kernel_matches_plain_version_on_card(card, dataflow, mkn):
    """K7 against its plain version on ragged shapes (ResNet20's GEMMs, a
    zero K); the three dataflows give the same bits, and the launch is
    counted."""
    x, w = (a.to(card) for a in map(_t, _xw(10, *mkn)))
    tmm.reset_launches()
    got = tmm.matmul(x, w, dataflow=dataflow)
    others = [tmm.matmul(x, w, dataflow=df) for df in DATAFLOWS]
    want = tref.matmul(x, w)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES[dataflow] == 2
    torch.testing.assert_close(got, want, **_card_tol(want))
    assert all(torch.equal(got, o) for o in others)


@pytest.mark.gpu
@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_matmul_kernel_bf16_and_strided_on_card(card, dataflow):
    """bf16 in and out (f32 accumulation, one rounding), and transposed
    views read through their strides with no copy."""
    x, w = (a.to(card) for a in map(_t, _xw(11, 130, 70, 200)))
    xb, wb = x.bfloat16(), w.bfloat16()
    got = tmm.matmul(xb, wb, dataflow=dataflow)
    assert got.dtype == torch.bfloat16
    want = tref.matmul(xb, wb)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    xt, wt = x.t().contiguous().t(), w.t().contiguous().t()
    assert not xt.is_contiguous() and not wt.is_contiguous()
    got = tmm.matmul(xt, wt, dataflow=dataflow)
    assert torch.equal(got, tmm.matmul(x, w, dataflow=dataflow))


@pytest.mark.gpu
@pytest.mark.parametrize("dataflow", DATAFLOWS)
@pytest.mark.parametrize("mkn", [BIG_K, WO])
def test_matmul_kernel_bf16_strided_large_k_on_card(card, dataflow, mkn):
    """bf16 where the running sum crosses K-chunks (weight- and
    input-stationary re-stream it through an f32 buffer) and on the
    skinny schedule; transposed views on both."""
    x, w = (a.to(card) for a in map(_t, _xw(15, *mkn)))
    xb, wb = x.bfloat16(), w.bfloat16()
    got = tmm.matmul(xb, wb, dataflow=dataflow)
    want = tref.matmul(xb, wb).float()
    torch.testing.assert_close(got.float(), want, rtol=2e-2,
                               atol=2e-2 * max(1.0, float(want.abs().max())))
    xt, wt = x.t().contiguous().t(), w.t().contiguous().t()
    got = tmm.matmul(xt, wt, dataflow=dataflow)
    assert torch.equal(got, tmm.matmul(x, w, dataflow=dataflow))


@pytest.mark.gpu
def test_matmul_backward_on_card(card):
    """The gradients through the kernel against the plain version's."""
    x, w = (a.to(card) for a in map(_t, _xw(12, 300, 144, 32)))
    g = torch.randn(300, 32, device=card, generator=torch.Generator(
        card).manual_seed(0))
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    tmm.reset_launches()
    tops.matmul(tx, tw, dataflow="weight_stationary").backward(g)
    assert tmm.LAUNCHES["weight_stationary"] == 3
    want_dx, want_dw = tref.matmul(g, w.t()), tref.matmul(x.t(), g)
    torch.testing.assert_close(tx.grad, want_dx, **_card_tol(want_dx))
    torch.testing.assert_close(tw.grad, want_dw, **_card_tol(want_dw))


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", [(128, 256, 192), (256, 128, 64),
                                 (1000, 144, 16), (8, 5120, 5120),
                                 (33, 17, 70), (262144, 27, 16),
                                 (262144, 144, 16), (65536, 288, 32),
                                 (65536, 16, 32), (16384, 576, 64), BIG_K,
                                 (8, 5120, 100)])
def test_quant_matmul_kernel_matches_plain_version_on_card(card, mkn):
    """K8 against its plain version; on the same dequantized weight it
    equals K7 bit for bit (the same per-element dequantization, the same
    FMA chain)."""
    x, wq, sc = (a.to(card) for a in map(_t, _q8(13, *mkn)))
    tqm.reset_launches()
    got = tqm.quant_matmul(x, wq, sc)
    want = tref.quant_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES["quant_matmul"] == 1
    torch.testing.assert_close(got, want, **_card_tol(want))
    w = wq.float() * sc[None, :]
    assert torch.equal(got, tmm.matmul(x, w))
    xb = tqm.quant_matmul(x.bfloat16(), wq, sc)
    assert xb.dtype == torch.bfloat16
    torch.testing.assert_close(xb.float(), tref.quant_matmul(
        x.bfloat16(), wq, sc).float(), rtol=2e-2, atol=2e-2 * max(
        1.0, float(want.abs().max())))


@pytest.mark.gpu
def test_other_dtypes_raise_on_card(card):
    x, w = (a.to(card) for a in map(_t, _xw(14, 16, 16, 16)))
    with pytest.raises(TypeError):
        tmm.matmul(x.half(), w.half())
    with pytest.raises(TypeError):
        tmm.matmul(x, w.bfloat16())
    with pytest.raises(TypeError):
        tqm.quant_matmul(x, w, torch.ones(16, device=card))


# the distinct conv GEMMs (M, K, N) of a batch-128 ResNet20 training step:
# the stem (K = 27), the 3x3 convs and the 1x1 projections of each stage
TRAIN_B128 = [(131072, 27, 16), (131072, 144, 16), (32768, 144, 32),
              (32768, 288, 32), (32768, 16, 32), (8192, 288, 64),
              (8192, 576, 64), (8192, 32, 64)]


@pytest.mark.parametrize("mkn", TRAIN_B128)
def test_tile_plan_at_the_gradient_gemms_of_resnet20_training(mkn):
    """The backward's operands as ``ops._Matmul`` passes them: dX = g @
    W^T reads w's transpose (strides (1, N)), dW = X^T @ g reads x's
    (strides (1, K)), over a reduction of M = 8,192-131,072 rows. Each
    plan fits shared memory, its K-chunks cover the reduction, and a
    transposed x is staged by 16-byte copies along its unit-stride axis
    where its k stride allows (K % 4 == 0: not the stem's 27)."""
    m, k, n = mkn
    dx = tmm.tile_plan(m, n, k, n, 1, 1, n)          # g (m, n) @ w.t()
    dw = tmm.tile_plan(k, m, n, 1, k, n, 1)          # x.t() (k, m) @ g
    for plan, reduction in ((dx, n), (dw, m)):
        assert plan.smem <= tmm.SMEM_MAX
        assert plan.kc * plan.chunks >= reduction
        assert plan.kc % tmm.BK == 0 or plan.skinny
    assert dw.vec_x == (k % 4 == 0) and not dx.vec_w
    assert dw.grid[0] == -(-k // dw.bm)


def _dw_plan(m, k, n, **kw):
    """The plan of dW = X^T g for a conv GEMM (m, k, n) of the forward."""
    return tmm.tile_plan(k, m, n, 1, k, n, 1, **kw)


def _dx_plan(m, k, n, **kw):
    """The plan of dX = g W^T for a conv GEMM (m, k, n) of the forward."""
    return tmm.tile_plan(m, n, k, n, 1, 1, n, **kw)


@pytest.mark.parametrize("mkn", TRAIN_B128)
def test_split_plan_at_the_dw_gemms_of_resnet20_training(mkn):
    """Every dW GEMM of a batch-128 step splits its reduction: the ranges
    are multiples of BK of at least SPLIT_MIN rows (but the last), cover
    the reduction exactly, and fill the card in one wave (of at most two
    blocks per SM), or are as many as the reduction's length allows; the
    plan fits shared memory, and the scratch is (splits, M, N) fp32."""
    m, k, n = mkn
    p = _dw_plan(m, k, n)
    assert p.schedule == "split" and p.splits >= tmm.MIN_SPLITS
    assert p.kc % tmm.BK == 0 and p.kc >= tmm.SPLIT_MIN
    assert (p.splits - 1) * p.kc < m <= p.splits * p.kc
    assert (tmm.FILL <= p.blocks <= 2 * tmm.SMS
            or p.splits == m // tmm.SPLIT_MIN)
    assert p.smem <= tmm.SMEM_MAX and p.group == 1
    part = tmm.scratch(p, k, n, "output_stationary", torch.float32, "cpu")
    assert tuple(part.shape) == (p.splits, k, n)
    assert part.dtype == torch.float32


@pytest.mark.parametrize("mkn", TRAIN_B128)
def test_wide_plan_at_the_dx_gemms_of_resnet20_training(mkn):
    """A dX GEMM whose output is wider than one N-tile (K > 64) keeps all
    of W^T resident (N-panels of pitch BN + 4) with room for two x tiles,
    covers its rows with blocks that sweep M-tiles, and fills the card; a
    narrower one is one N-tile of the tiled schedule, which reads g's rows
    once as it is."""
    m, k, n = mkn
    p = _dx_plan(m, k, n)
    if k <= 64:
        assert p.schedule == "tiled" and p.grid[1] == 1 and p.chunks == 1
        return
    assert p.schedule == "wide" and p.kc >= n and p.kc % tmm.BK == 0
    panels = 4 * p.kc * -(-k // p.bn) * (p.bn + 4)
    assert p.smem == panels + 4 * 2 * p.bm * (p.kc + 4) <= tmm.SMEM_MAX
    assert p.grid[1] == 1 and p.grid[0] * p.group * p.bm >= m
    assert min(-(-m // p.bm), tmm.SMS) >= tmm.FILL // 2
    assert tmm.scratch(p, m, k, "output_stationary", torch.float32,
                       "cpu") is None


@pytest.mark.parametrize("mkn", TRAIN_B128)
def test_backward_plans_equal_across_dataflows_and_int8(mkn):
    """The split (dW) and wide (dX) plans depend on the shape alone: every
    dataflow and an int8 weight (K8) get the same one, so they give the
    same bits."""
    m, k, n = mkn
    for plan_of in (_dw_plan, _dx_plan):
        want = plan_of(m, k, n)
        if want.schedule == "tiled":
            continue
        for kw in [dict(dataflow=df) for df in DATAFLOWS[1:]] + [
                dict(w_bytes=1)]:
            assert plan_of(m, k, n, **kw) == want, (plan_of.__name__, kw)


@pytest.mark.parametrize("dataflow", DATAFLOWS + ("quant",))
def test_forward_plans_keep_one_range(dataflow):
    """No GEMM of a ResNet20 forward, at batch 256 or 1, splits its
    reduction or takes the wide schedule: the forward path's plans, bits
    and times stay those of the tiled schedule."""
    from repro_torch.configs.resnet20_cifar import CONFIG
    from repro_torch.models import resnet
    kw = (dict(w_bytes=1) if dataflow == "quant"
          else dict(dataflow=dataflow))
    for batch in (256, 1):
        for _, m, k, n in resnet.conv_layer_shapes(CONFIG, batch):
            p = _plan(m, k, n, **kw)
            assert p.schedule == "tiled" and p.splits == 1, (m, k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", TRAIN_B128)
def test_backward_gemm_bits_on_card(card, mkn):
    """dW (the split schedule) and dX (wide where K > 64) at a batch-128
    step's shapes, on the backward's transposed views: within the tolerance
    of the plain version, the same bits when run again, in every dataflow,
    and from K8 on an int8 operand against K7 on its dequantized form."""
    m, k, n = mkn
    gen = torch.Generator(card).manual_seed(2)
    x = torch.randn(m, k, device=card, generator=gen)
    w = torch.randn(k, n, device=card, generator=gen)
    g = torch.randn(m, n, device=card, generator=gen)
    q = torch.randint(-127, 127, (m, n), device=card, dtype=torch.int8,
                      generator=gen)
    sc = torch.rand(n, device=card, generator=gen) * 0.1 + 0.01
    wq = torch.randint(-127, 127, (k, n), device=card, dtype=torch.int8,
                       generator=gen)
    wsc = torch.rand(k, device=card, generator=gen) * 0.1 + 0.01
    cases = [(x.t(), g, q, sc), (g, w.t(), wq.t(), wsc)]
    for a, b, bq, bsc in cases[:1] if k == 27 else cases:
        got = tmm.matmul(a, b)
        want = tref.matmul(a, b)
        torch.testing.assert_close(got, want, **_card_tol(want))
        assert torch.equal(got, tmm.matmul(a, b))
        assert all(torch.equal(got, tmm.matmul(a, b, dataflow=df))
                   for df in DATAFLOWS[1:])
        assert torch.equal(tqm.quant_matmul(a, bq, bsc),
                           tmm.matmul(a, bq.float() * bsc[None, :]))


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", TRAIN_B128)
def test_matmul_backward_at_resnet20_training_shapes_on_card(card, mkn):
    """The gradient GEMMs of a batch-128 training step through the kernel
    (its transposed views, reductions over up to 131,072 rows) against the
    plain version's; the stem's input needs no gradient, so its step
    launches two GEMMs, the others three."""
    m, k, n = mkn
    x, w = (a.to(card) for a in map(_t, _xw(16, m, k, n)))
    g = torch.randn(m, n, device=card, generator=torch.Generator(
        card).manual_seed(1))
    stem = k == 27
    tx = x.clone().requires_grad_(not stem)
    tw = w.clone().requires_grad_()
    tmm.reset_launches()
    tops.matmul(tx, tw).backward(g)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES["output_stationary"] == (2 if stem else 3)
    want_dw = tref.matmul(x.t(), g)
    torch.testing.assert_close(tw.grad, want_dw, **_card_tol(want_dw))
    if not stem:
        want_dx = tref.matmul(g, w.t())
        torch.testing.assert_close(tx.grad, want_dx, **_card_tol(want_dx))
