"""The port's paged attention against the reference: the plain PyTorch
version (what CPU tensors run) against ``repro.kernels.ref.paged_attention``
and against ``repro.kernels.ops.paged_prefill`` (the Pallas kernel in
interpret mode), on the reference's own kernel cases plus poisoned and
unallocated pages, freed-slot zeros, aliased prefix pages, a mid-prefill
slot seen by decode and the degenerate one-page table. Inputs are made with
numpy from a seed and handed to both packages.

Tolerance rtol = atol = 2e-5: both sides compute the same fp32 masked
softmax, but sum in different orders (XLA's einsum against PyTorch's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the card's machine has no JAX: there only the gpu-marked test runs
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


TOL = dict(rtol=2e-5, atol=2e-5)
INACTIVE = 1 << 30


def _setup(seed, B, Sq, H, KV, hd, P, ps, mps, fill):
    """Random q/pools and block tables giving slot b ceil(fill[b]/ps)
    distinct pages in a shuffled order."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    pk = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    bt = np.full((B, mps), -1, np.int32)
    perm = rng.permutation(P)
    nxt = 0
    for b in range(B):
        need = -(-fill[b] // ps)
        bt[b, :need] = perm[nxt:nxt + need]
        nxt += need
    return q, pk, pv, bt


def _both(q, pk, pv, bt, start, window=0):
    """(port plain version, repro oracle) on the same numpy inputs."""
    got = tref.paged_attention(*map(torch.from_numpy, (q, pk, pv, bt, start)),
                               window=window).numpy()
    want = np.asarray(jref.paged_attention(*map(jnp.asarray,
                                                (q, pk, pv, bt, start)),
                                           window=window))
    return got, want


KERNEL_CASES = [
    dict(Sq=8, H=4, KV=2, ps=8, mps=4, window=0),     # GQA prefill chunk
    dict(Sq=1, H=4, KV=4, ps=8, mps=4, window=0),     # decode shape
    dict(Sq=16, H=8, KV=2, ps=4, mps=8, window=6),    # sliding window
    dict(Sq=8, H=2, KV=1, ps=16, mps=2, window=0),    # page > chunk
]


@pytest.mark.parametrize("cfg", KERNEL_CASES)
def test_plain_matches_reference_oracle_and_pallas_kernel(cfg):
    """The reference's kernel cases (GQA, decode width, sliding window,
    page larger than the chunk; last pages partially filled): the port's
    plain version equals repro's oracle and repro's Pallas kernel."""
    Sq, H, KV, ps, mps = (cfg["Sq"], cfg["H"], cfg["KV"], cfg["ps"],
                          cfg["mps"])
    B, hd, P = 2, 16, 2 * mps + 3
    fill = [ps + ps // 2 + Sq, ps // 2 + Sq]
    q, pk, pv, bt = _setup(3, B, Sq, H, KV, hd, P, ps, mps, fill)
    start = np.asarray([f - Sq for f in fill], np.int32)
    got, want = _both(q, pk, pv, bt, start, cfg["window"])
    np.testing.assert_allclose(got, want, **TOL)
    kern = np.asarray(jops.paged_prefill(
        *map(jnp.asarray, (q, pk, pv, bt, start)), window=cfg["window"]))
    np.testing.assert_allclose(got, kern, **TOL)


def test_poisoned_unallocated_and_future_rows_never_contribute():
    """Rows that are no valid key of any slot (unallocated pages, pages
    beyond the causal frontier, the tail of a partial page) are poisoned
    with 1e9: the output is unchanged bit for bit."""
    B, Sq, H, KV, hd, P, ps, mps = 2, 4, 4, 2, 16, 8, 8, 4
    q, pk, pv, bt = _setup(4, B, Sq, H, KV, hd, P, ps, mps, [12, 4])
    start = np.asarray([8, 0], np.int32)
    base, want = _both(q, pk, pv, bt, start)
    np.testing.assert_allclose(base, want, **TOL)
    valid = np.zeros(P * ps, bool)
    for b, last in enumerate([11, 3]):
        for r in range(last + 1):
            valid[bt[b, r // ps] * ps + r % ps] = True
    pk_p = np.where(valid[:, None, None], pk.reshape(P * ps, KV, hd),
                    1e9).astype(np.float32).reshape(pk.shape)
    pv_p = np.where(valid[:, None, None], pv.reshape(P * ps, KV, hd),
                    1e9).astype(np.float32).reshape(pv.shape)
    got, _ = _both(q, pk_p, pv_p, bt, start)
    np.testing.assert_array_equal(got, base)


def test_freed_slot_returns_exact_zeros():
    """A freed slot (all--1 table, parked at INACTIVE_POS) attends nothing
    and returns exactly 0 on both sides."""
    B, H, KV, hd, P, ps, mps = 2, 4, 2, 16, 8, 8, 4
    q, pk, pv, _ = _setup(5, B, 1, H, KV, hd, P, ps, mps, [0, 0])
    bt = np.full((B, mps), -1, np.int32)
    start = np.asarray([INACTIVE, INACTIVE + 7], np.int32)
    got, want = _both(q, pk, pv, bt, start)
    assert np.all(got == 0) and np.all(want == 0)


def test_mid_prefill_slot_seen_by_decode_is_finite_and_matches():
    """A slot still being prefilled already owns pages while its position
    is INACTIVE_POS: decode visits those pages with q_pos = 2**30. Its
    output is unused, but it must be finite and agree with the oracle."""
    B, H, KV, hd, P, ps, mps = 2, 4, 1, 16, 10, 16, 4
    q, pk, pv, bt = _setup(6, B, 1, H, KV, hd, P, ps, mps, [40, 20])
    start = np.asarray([39, INACTIVE], np.int32)
    got, want = _both(q, pk, pv, bt, start)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_aliased_prefix_pages_shared_across_slots():
    """Two slots aliasing the SAME physical prefix page, with equal queries
    and tail pages holding the same rows, give identical outputs."""
    Sq, H, KV, hd, P, ps = 4, 4, 2, 16, 6, 8
    rng = np.random.default_rng(7)
    q1 = rng.standard_normal((1, Sq, H, hd)).astype(np.float32)
    q = np.concatenate([q1, q1])
    pk = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pk[4], pv[4] = pk[0], pv[0]
    bt = np.asarray([[2, 0, -1], [2, 4, -1]], np.int32)
    start = np.asarray([ps + 2, ps + 2], np.int32)
    got, want = _both(q, pk, pv, bt, start)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got, want, **TOL)


def test_degenerate_one_page_table_is_causal_attention():
    """page_size == s_max (one page per slot): paged attention collapses to
    plain causal attention over the slot's rows (repro's flash oracle)."""
    B, S, H, KV, hd = 2, 16, 4, 2, 16
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    bt = np.asarray([[0], [1]], np.int32)
    start = np.zeros((B,), np.int32)
    got, _ = _both(q, k, v, bt, start)
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    """On CPU tensors the wrapper takes the plain version and raises no
    launch count; malformed shapes raise before anything runs."""
    q, pk, pv, bt = _setup(9, 2, 1, 4, 2, 16, 8, 8, 4, [9, 3])
    start = np.asarray([8, 2], np.int32)
    args = list(map(torch.from_numpy, (q, pk, pv, bt, start)))
    pa.reset_launches()
    out = pa.paged_attention(*args, kind="decode")
    np.testing.assert_array_equal(out.numpy(),
                                  tref.paged_attention(*args).numpy())
    assert pa.LAUNCHES == {"decode": 0, "prefill": 0}
    with pytest.raises(ValueError):
        pa.paged_attention(args[0], args[1], args[2], args[3][:1], args[4])


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", KERNEL_CASES)
def test_kernel_matches_plain_version_on_card(cfg):
    """The CUDA kernel against its plain version on the card, at hd = 128,
    on the reference's kernel cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Sq, H, KV, ps, mps = (cfg["Sq"], cfg["H"], cfg["KV"], cfg["ps"],
                          cfg["mps"])
    B, hd, P = 2, 128, 2 * mps + 3
    fill = [ps + ps // 2 + Sq, ps // 2 + Sq]
    q, pk, pv, bt = _setup(3, B, Sq, H, KV, hd, P, ps, mps, fill)
    start = np.asarray([f - Sq for f in fill], np.int32)
    args = [torch.from_numpy(a).cuda() for a in (q, pk, pv, bt, start)]
    got = pa.paged_attention(*args, window=cfg["window"], kind="prefill")
    want = tref.paged_attention(*args, window=cfg["window"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
