"""The port's two scans against the reference. ``ops.wkv6`` (the RWKV6
recurrence, K5) and ``ops.selective_scan`` (the mamba scan, K6) run their
plain versions on CPU tensors; they are held against ``repro.kernels.ref``
(the same step-by-step recurrence) and against ``repro``'s ``ops`` (the
Pallas kernels in interpret mode, which compute the wkv chunks in a
log-space closed form; ``repro`` sends a T that is not a chunk multiple to
its oracle) on ``tests/test_kernels.py``'s cases plus T = 1 and a strong
decay. ``gpu``-marked cases hold the CUDA kernels against the plain
versions on the card and skip themselves without one.

Tolerances: 1e-5 (rtol and atol) against ``repro.kernels.ref``, the same
fp32 recurrence with its sums in another order; against the interpret-mode
kernels the reference tests' own, 3e-4 for wkv6 (the closed form rounds
exps of log-decay differences) and 1e-3 at strong decay, 2e-4 for the
selective scan. On the card the kernels keep the plain versions'
per-element order, and only the sums over the state axis differ:
rtol = atol = 2e-5. Inputs are seeded numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import linear_scan as tls  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the card's machine has no JAX: there only the gpu-marked tests run
# (``pytest -m gpu``) and the reference comparisons skip themselves
try:
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
    return torch.device("cuda")


REF_TOL = dict(rtol=1e-5, atol=1e-5)
CARD_TOL = dict(rtol=2e-5, atol=2e-5)


def wkv_inputs(seed, B, T, H, N, decay=None):
    """tests/test_kernels.py's distributions: r, k, v ~ 0.5 N(0, 1), w =
    sigmoid(N(0, 1)) / 2 + 1/2 (or the constant ``decay``), u ~ 0.1 N,
    s0 ~ 0.1 N (zeros with a constant decay)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)) for _ in range(3))
    if decay is None:
        w = 0.5 / (1.0 + np.exp(-rng.standard_normal((B, T, H, N)))) + 0.5
        s0 = 0.1 * rng.standard_normal((B, H, N, N))
    else:
        w = np.full((B, T, H, N), decay)
        s0 = np.zeros((B, H, N, N))
    u = 0.1 * rng.standard_normal((H, N))
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def sscan_inputs(seed, B, T, D, N):
    """x ~ N, dt = softplus(N), b, c ~ N, a = -exp(0.5 N), h0 ~ 0.1 N."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D))))
    b = rng.standard_normal((B, T, N))
    c = rng.standard_normal((B, T, N))
    a = -np.exp(0.5 * rng.standard_normal((D, N)))
    h0 = 0.1 * rng.standard_normal((B, D, N))
    return [t.astype(np.float32) for t in (x, dt, b, c, a, h0)]


def _t(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("T,chunk", [(64, 16), (64, 32), (128, 64),
                                     (33, 16), (1, 32)])
def test_wkv6_matches_reference(T, chunk):
    args = wkv_inputs(0, 2, T, 3, 16)
    got = [t.numpy() for t in tops.wkv6(*_t(args), chunk=chunk)]
    jargs = [jnp.asarray(a) for a in args]
    _close(got, jref.wkv6(*jargs), REF_TOL)
    _close(got, jops.wkv6(*jargs, chunk=chunk), dict(rtol=3e-4, atol=3e-4))
    assert got[0].shape == (2, T, 3, 16) and got[1].shape == (2, 3, 16, 16)


@pytest.mark.parametrize("T", [64, 1])
def test_wkv6_strong_decay(T):
    """w = 0.05 everywhere (the numerically hard case of the TPU's
    log-space form): finite and equal to both references."""
    args = wkv_inputs(1, 1, T, 2, 8, decay=0.05)
    got = [t.numpy() for t in tops.wkv6(*_t(args), chunk=16)]
    assert all(np.isfinite(g).all() for g in got)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, jref.wkv6(*jargs), REF_TOL)
    _close(got, jops.wkv6(*jargs, chunk=16), dict(rtol=1e-3, atol=1e-3))


@pytest.mark.parametrize("T,chunk", [(64, 16), (128, 64), (33, 16), (1, 64)])
def test_selective_scan_matches_reference(T, chunk):
    args = sscan_inputs(2, 2, T, 32, 8)
    got = [t.numpy() for t in tops.selective_scan(*_t(args), chunk=chunk)]
    jargs = [jnp.asarray(a) for a in args]
    _close(got, jref.selective_scan(*jargs), REF_TOL)
    _close(got, jops.selective_scan(*jargs, chunk=chunk),
           dict(rtol=2e-4, atol=2e-4))
    assert got[0].shape == (2, T, 32) and got[1].shape == (2, 32, 8)


def test_scan_wrappers_reject_bad_arguments():
    """Mismatched shapes and a chunk below 1 raise before any route is
    taken; the CPU route counts no launch."""
    r, k, v, w, u, s0 = _t(wkv_inputs(3, 1, 4, 2, 8))
    tls.reset_launches()
    with pytest.raises(ValueError, match="u has shape"):
        tops.wkv6(r, k, v, w, u[:, :4], s0)
    with pytest.raises(ValueError, match="chunk"):
        tops.wkv6(r, k, v, w, u, s0, chunk=0)
    x, dt, b, c, a, h0 = _t(sscan_inputs(3, 1, 4, 6, 4))
    with pytest.raises(ValueError, match="h0 has shape"):
        tops.selective_scan(x, dt, b, c, a, h0[:, :5])
    with pytest.raises(ValueError, match="selective_scan wants"):
        tops.selective_scan(x[0], dt, b, c, a, h0)
    tops.wkv6(r, k, v, w, u, s0)
    tops.selective_scan(x, dt, b, c, a, h0)
    assert tls.LAUNCHES == {"wkv6": 0, "selective_scan": 0}


# ------------------------------------------------------------ the plan
# (kernel, B, T, H or D, N): rwkv6-7b's and hymba-1.5b's serving chunk of
# one request (most of the main path's chunks), a chunk of 8 slots, a
# decode tick and the forward, then the card cases below
PLAN_SHAPES = [("wkv6", 1, 64, 64, 64), ("wkv6", 8, 64, 64, 64),
               ("wkv6", 8, 1, 64, 64), ("wkv6", 4, 1024, 64, 64),
               ("wkv6", 3, 19, 2, 24), ("wkv6", 1, 5, 1, 1),
               ("selective_scan", 1, 64, 1600, 16),
               ("selective_scan", 8, 64, 1600, 16),
               ("selective_scan", 8, 1, 1600, 16),
               ("selective_scan", 4, 1024, 1600, 16),
               ("selective_scan", 2, 9, 33, 3),
               ("selective_scan", 1, 3, 300, 1),
               ("selective_scan", 1, 7, 5, 32)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "-".join(
    map(str, s)))
def test_scan_plan(shape):
    """Full-width serving shapes launch at least a block per SM (a chunk
    of one request included); every plan fits the card's shared memory,
    stages at most T steps and at most ``chunk``, and sizes its blocks as
    the kernel does."""
    kernel, B, T, W, N = shape
    for chunk in (1, 16, 32, 64, 200):
        plan = tls.scan_plan(kernel, B, T, W, N, chunk=chunk,
                             ptrs=(0, 16, 32, 48))
        assert plan.kernel == kernel
        assert 0 <= plan.smem <= _build.SMEM_MAX
        assert 1 <= plan.steps <= min(chunk, T)
        assert plan.cols & (plan.cols - 1) == 0
        if W in (64, 1600):
            assert plan.blocks >= _build.SMS
        if kernel == "wkv6":
            assert plan.thread_cols in (1, 2)
            assert plan.threads == (tls.WKV_GROUPS * plan.cols
                                    // plan.thread_cols) >= 32
            assert plan.vec == (N % 4 == 0)
            assert 2 * plan.smem <= _build.SMEM_MAX or plan.steps == 1
        else:
            assert 32 <= plan.threads <= tls.SS_MAX_THREADS
            assert (plan.smem == 0) == (T == 1) and not plan.vec
    # the main path's chunk of one request: rwkv6 splits each head's
    # value columns 4 ways, hymba uses blocks of 8 channels
    if shape[:3] == ("wkv6", 1, 64):
        assert (plan.cols, plan.blocks) == (16, 256)
    if shape[:3] == ("selective_scan", 1, 64):
        assert (plan.cols, plan.blocks) == (8, 200)


def test_scan_plan_rejects_what_the_kernels_cannot_take():
    """B past 65535, N past the kernel's widest state, T, H, D or chunk
    below 1 and an unknown kernel raise; so do plans the kernel would
    refuse (column blocks not a power of two, 16-byte copies of rows that
    are not a multiple of 16 bytes, blocks past 256 threads)."""
    bad = [("wkv6", 65536, 1, 1, 1), ("wkv6", 1, 1, 1, 65),
           ("wkv6", 1, 0, 1, 1), ("wkv6", 1, 1, 0, 1),
           ("selective_scan", 65536, 1, 1, 1),
           ("selective_scan", 1, 1, 1, 33), ("selective_scan", 1, 1, 0, 4),
           ("linear_attention", 1, 1, 1, 1)]
    for args in bad:
        with pytest.raises(ValueError):
            tls.scan_plan(*args, chunk=32)
    with pytest.raises(ValueError):
        tls.scan_plan("wkv6", 1, 4, 2, 16, chunk=0)
    with pytest.raises(ValueError):
        tls._plan("wkv6", 1, 4, 2, 16, cols=12, steps=4)
    with pytest.raises(ValueError):
        tls._plan("wkv6", 1, 4, 2, 16, cols=2, steps=4)
    with pytest.raises(ValueError):
        tls._plan("wkv6", 1, 4, 2, 18, cols=4, steps=4, vec=True)
    with pytest.raises(ValueError):
        tls._plan("selective_scan", 1, 4, 64, 16, cols=32, steps=4)
    with pytest.raises(ValueError):
        tls._plan("selective_scan", 1, 4, 64, 4, cols=4, steps=4)


# ------------------------------------------------------------ on the card
WKV_CASES = [dict(B=2, T=64, H=3, N=16, chunk=16),
             dict(B=2, T=33, H=3, N=16, chunk=16),
             dict(B=2, T=1, H=3, N=16, chunk=32),
             dict(B=1, T=64, H=2, N=8, chunk=16, decay=0.05),
             dict(B=2, T=40, H=5, N=64, chunk=32),
             dict(B=3, T=19, H=2, N=24, chunk=7),
             dict(B=1, T=5, H=1, N=1, chunk=32),
             # full width: the main path's chunk of one request and its
             # tick, then steps across the staging boundaries
             dict(B=1, T=64, H=64, N=64, chunk=32),
             dict(B=1, T=1, H=64, N=64, chunk=32),
             dict(B=2, T=65, H=64, N=64, chunk=32),
             dict(B=1, T=129, H=64, N=64, chunk=32),
             dict(B=2, T=65, H=5, N=24, chunk=16)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_wkv6_kernel_matches_plain(card, case):
    c = dict(case)
    chunk = c.pop("chunk")
    args = _t(wkv_inputs(4, **c), card)
    tls.reset_launches()
    got = tops.wkv6(*args, chunk=chunk)
    assert tls.LAUNCHES["wkv6"] == 1
    want = tref.wkv6(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert torch.allclose(g, w, **CARD_TOL), (g - w).abs().max().item()
    # the staging depth is not part of the result
    for other in (1, 3, 64):
        again = tops.wkv6(*args, chunk=other)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


SSCAN_CASES = [dict(B=2, T=64, D=32, N=8, chunk=16),
               dict(B=2, T=33, D=32, N=8, chunk=16),
               dict(B=4, T=1, D=1600, N=16, chunk=64),
               dict(B=2, T=20, D=70, N=4, chunk=64),
               dict(B=2, T=9, D=33, N=3, chunk=5),
               dict(B=1, T=7, D=5, N=32, chunk=64),
               dict(B=1, T=3, D=300, N=1, chunk=64),
               dict(B=1, T=64, D=1600, N=16, chunk=64),
               dict(B=1, T=1, D=1600, N=16, chunk=64),
               dict(B=2, T=65, D=1600, N=16, chunk=64),
               dict(B=1, T=129, D=1600, N=16, chunk=64),
               dict(B=2, T=129, D=70, N=5, chunk=64),
               dict(B=1, T=65, D=40, N=1, chunk=64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSCAN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_selective_scan_kernel_matches_plain(card, case):
    c = dict(case)
    chunk = c.pop("chunk")
    args = _t(sscan_inputs(5, **c), card)
    tls.reset_launches()
    got = tops.selective_scan(*args, chunk=chunk)
    assert tls.LAUNCHES["selective_scan"] == 1
    want = tref.selective_scan(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert torch.allclose(g, w, **CARD_TOL), (g - w).abs().max().item()
    for other in (1, 3, 200):
        again = tops.selective_scan(*args, chunk=other)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.gpu
def test_scan_kernels_raise_on_what_they_cannot_take(card):
    """Wider states, other dtypes, strided views and mixed devices raise;
    nothing falls back to the plain version."""
    wkv = _t(wkv_inputs(6, 1, 4, 2, 65), card)
    with pytest.raises(ValueError, match="N <= 64"):
        tops.wkv6(*wkv)
    wkv = _t(wkv_inputs(6, 1, 4, 2, 16), card)
    with pytest.raises(TypeError, match="float32"):
        tops.wkv6(*[t.double() for t in wkv])
    r = wkv[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tops.wkv6(r, *wkv[1:])
    with pytest.raises(ValueError, match="one device"):
        tops.wkv6(*wkv[:5], wkv[5].cpu())
    ss = _t(sscan_inputs(6, 1, 4, 8, 33), card)
    with pytest.raises(ValueError, match="N <= 32"):
        tops.selective_scan(*ss)
    ss = _t(sscan_inputs(6, 1, 4, 8, 4), card)
    with pytest.raises(TypeError, match="float32"):
        tops.selective_scan(ss[0].half(), *ss[1:])


def _plans(kernel, B, T, W, N):
    """Every column split or channel block the plan can choose at this
    shape (K5 with 1 or 2 columns a thread), at staging depths across
    the SS_U groups and stage boundaries, with 4- and 16-byte copies
    (K5)."""
    widths = [1 << i for i in range(9)]
    if kernel == "wkv6":
        vecs = (False, True) if N % 4 == 0 else (False,)
        per_thread = (1, 2)
    else:
        vecs, per_thread = (False,), (1,)
    out = []
    for cols in widths:
        for tc in per_thread:
            for steps in (1, 3, 16, 17, 64, T):
                for vec in vecs:
                    try:
                        out.append(tls._plan(kernel, B, T, W, N, cols,
                                             min(steps, T), vec, tc))
                    except ValueError:
                        pass
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [("wkv6", 1, 64, 64, 64),
                                   ("wkv6", 2, 33, 3, 24),
                                   ("wkv6", 1, 1, 8, 16),
                                   ("selective_scan", 1, 64, 1600, 16),
                                   ("selective_scan", 2, 40, 70, 5),
                                   ("selective_scan", 8, 1, 1600, 16),
                                   ("selective_scan", 1, 20, 40, 1)],
                         ids=lambda s: "-".join(map(str, s)))
def test_every_plan_gives_equal_bits(card, shape):
    """No column split, channel block, staging depth or copy width the
    kernels take changes a bit of y or of the final state."""
    kernel, B, T, W, N = shape
    if kernel == "wkv6":
        args = _t(wkv_inputs(7, B, T, W, N), card)
        want = tops.wkv6(*args)
    else:
        args = _t(sscan_inputs(8, B, T, W, N), card)
        want = tops.selective_scan(*args)
    plans = _plans(kernel, B, T, W, N)
    assert len(plans) >= 6
    for plan in plans:
        got = tls.run_plan(plan, args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), plan


@pytest.mark.gpu
def test_scan_kernels_raise_past_their_batch(card):
    """B = 65536 is past the kernels' grid: both raise, and neither runs
    the plain version or counts a launch."""
    tls.reset_launches()
    with pytest.raises(ValueError, match="B <= 65535"):
        tops.wkv6(*_t(wkv_inputs(9, 65536, 1, 1, 1), card))
    with pytest.raises(ValueError, match="B <= 65535"):
        tops.selective_scan(*_t(sscan_inputs(9, 65536, 1, 1, 1), card))
    assert tls.LAUNCHES == {"wkv6": 0, "selective_scan": 0}
