"""The port's paged attention against the reference: the plain PyTorch
version (what CPU tensors run) against ``repro.kernels.ref.paged_attention``
and against ``repro.kernels.ops.paged_prefill`` (the Pallas kernel in
interpret mode), on the reference's own kernel cases plus poisoned and
unallocated pages, freed-slot zeros, aliased prefix pages, a mid-prefill
slot seen by decode and the degenerate one-page table. The same for int8
pools with per-page scales (the oracle with ``k_scale``/``v_scale`` and
``ops.paged_prefill_q8``) and for MLA latent pages
(``ref.paged_attention_latent`` and the latent Pallas kernel, freed slots
included), and the naive-expansion MLA oracle. Inputs are made with numpy
from a seed and handed to both packages.

Tolerance rtol = atol = 2e-5: both sides compute the same fp32 masked
softmax, but sum in different orders (XLA's einsum against PyTorch's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quantize import quantize_page  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the card's machine has no JAX: there only the gpu-marked test runs
# (``pytest -m gpu``) and the reference comparisons skip themselves
try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.paged_attention import paged_attention_latent as jlat
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
    (pkq, ks), (pvq, vs) = _q8(pk), _q8(pv)
    qargs = [args[0], torch.from_numpy(pkq), torch.from_numpy(pvq)] + args[3:]
    sc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_array_equal(
        tops.paged_decode_q8(qargs[0], qargs[1], qargs[2],
                             sc["k_scale"][:, None], sc["v_scale"][:, None],
                             *qargs[3:]).numpy(),
        tref.paged_attention(*qargs, **sc).numpy())
    pool_c = torch.from_numpy(pk[:, :, :1])
    np.testing.assert_array_equal(
        tops.paged_decode_latent(args[0], pool_c, args[3], args[4],
                                 scale_dim=24, d_v=8).numpy(),
        tref.paged_attention_latent(args[0], pool_c, args[3], args[4],
                                    scale_dim=24, d_v=8).numpy())
    assert set(pa.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        pa.paged_attention(args[0], args[1], args[2], args[3][:1], args[4])
    with pytest.raises(ValueError, match="kind"):
        pa.paged_attention(*qargs, kind="decode", **sc)
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention(*qargs, kind="decode_q8",
                           k_scale=sc["k_scale"])
    with pytest.raises(ValueError, match="kind"):
        pa.paged_attention_latent(args[0], pool_c, args[3], args[4],
                                  scale_dim=24, d_v=8, kind="decode")
    with pytest.raises(ValueError, match="d_v"):
        pa.paged_attention_latent(args[0], pool_c, args[3], args[4],
                                  scale_dim=24, d_v=17)


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


# ------------------------------------------------------------ int8 (K3)
def _q8(pool):
    """Quantize each page of an fp32 pool to int8 with its own scale."""
    qs, ss = zip(*(quantize_page(torch.from_numpy(p)) for p in pool))
    return torch.stack(qs).numpy(), torch.stack(ss).numpy()


def _q8_case(cfg, seed=3, hd=16):
    Sq, H, KV, ps, mps = (cfg["Sq"], cfg["H"], cfg["KV"], cfg["ps"],
                          cfg["mps"])
    B, P = 2, 2 * mps + 3
    fill = [ps + ps // 2 + Sq, ps // 2 + Sq]
    q, pk, pv, bt = _setup(seed, B, Sq, H, KV, hd, P, ps, mps, fill)
    start = np.asarray([f - Sq for f in fill], np.int32)
    (pkq, ks), (pvq, vs) = _q8(pk), _q8(pv)
    return q, pkq, pvq, ks, vs, bt, start


@pytest.mark.parametrize("cfg", KERNEL_CASES)
def test_q8_plain_matches_reference_oracle_and_pallas_kernel(cfg):
    """K1's cases over int8 pools: the port's plain version, given the
    per-page scales, equals repro's oracle and repro's q8 Pallas kernel
    (interpret mode)."""
    q, pkq, pvq, ks, vs, bt, start = _q8_case(cfg)
    got = tref.paged_attention(
        *map(torch.from_numpy, (q, pkq, pvq, bt, start)),
        window=cfg["window"], k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs)).numpy()
    jargs = list(map(jnp.asarray, (q, pkq, pvq, bt, start)))
    want = np.asarray(jref.paged_attention(
        *jargs, window=cfg["window"], k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(got, want, **TOL)
    kern = np.asarray(jops.paged_prefill_q8(
        jargs[0], jargs[1], jargs[2], jnp.asarray(ks)[:, None],
        jnp.asarray(vs)[:, None], jargs[3], jargs[4], window=cfg["window"]))
    np.testing.assert_allclose(got, kern, **TOL)


def test_q8_grouped_scales_match_reference_oracle():
    """(P, T) scale tables, one column per group of KV/T kv heads, as the
    reference's oracle takes them."""
    cfg = dict(Sq=8, H=8, KV=4, ps=8, mps=4, window=0)
    q, pkq, pvq, _, _, bt, start = _q8_case(cfg, seed=10)
    rng = np.random.default_rng(10)
    ks = rng.uniform(0.01, 0.1, (pkq.shape[0], 2)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (pkq.shape[0], 2)).astype(np.float32)
    got = tref.paged_attention(
        *map(torch.from_numpy, (q, pkq, pvq, bt, start)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    want = np.asarray(jref.paged_attention(
        *map(jnp.asarray, (q, pkq, pvq, bt, start)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------- latent (K4)
def _latent_case(seed, B, Sq, H, Lw, ps, mps, start):
    """A latent pool and tables giving slot b the pages its rows up to
    start[b] + Sq - 1 need; a slot whose start is INACTIVE gets none."""
    rng = np.random.default_rng(seed)
    P = B * mps + 2
    pool = rng.standard_normal((P, ps, 1, Lw)).astype(np.float32)
    q = rng.standard_normal((B, Sq, H, Lw)).astype(np.float32)
    bt = np.full((B, mps), -1, np.int32)
    perm = rng.permutation(P)
    nxt = 0
    for b in range(B):
        if start[b] >= INACTIVE:
            continue
        need = -(-int(start[b] + Sq) // ps)
        bt[b, :need] = perm[nxt:nxt + need]
        nxt += need
    return q, pool, bt, np.asarray(start, np.int32)


@pytest.mark.parametrize("Sq", [1, 4])
@pytest.mark.parametrize("widths", [(10, 8, 16), (64, 48, 96)])
def test_latent_plain_matches_reference_oracle_and_pallas_kernel(Sq, widths):
    """Slots at mid-page frontiers and a freed slot (all -1 table): the
    port's plain version equals repro's latent oracle and its latent
    Pallas kernel (interpret mode); the freed slot is exactly 0."""
    Lw, d_v, scale_dim = widths
    q, pool, bt, start = _latent_case(16, 4, Sq, 4, Lw, 8, 4,
                                      [13, 7, INACTIVE, 26 - Sq])
    got = tref.paged_attention_latent(
        *map(torch.from_numpy, (q, pool, bt, start)), scale_dim=scale_dim,
        d_v=d_v).numpy()
    jargs = list(map(jnp.asarray, (q, pool, bt, start)))
    want = np.asarray(jref.paged_attention_latent(
        *jargs, scale_dim=scale_dim, d_v=d_v))
    np.testing.assert_allclose(got, want, **TOL)
    kern = np.asarray(jlat(*jargs, scale_dim=scale_dim, d_v=d_v,
                           interpret=True))
    np.testing.assert_allclose(got, kern, **TOL)
    assert got.shape == (4, Sq, 4, d_v)
    assert np.all(got[2] == 0) and np.all(want[2] == 0)


def test_mla_naive_oracle_matches_reference():
    rng = np.random.default_rng(17)
    B, Sq, Sk, H, hd, c, r = 2, 5, 9, 3, 8, 6, 2
    arrs = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sq, H, r)).astype(np.float32),
            rng.standard_normal((B, Sk, c + r)).astype(np.float32),
            rng.standard_normal((H, hd, c)).astype(np.float32),
            rng.standard_normal((H, c, hd)).astype(np.float32),
            np.broadcast_to(np.arange(4, 4 + Sq), (B, Sq)).astype(np.int32),
            np.broadcast_to(np.arange(Sk), (B, Sk)).astype(np.int32))
    got = tref.mla_attention_naive(*map(torch.from_numpy, arrs)).numpy()
    want = np.asarray(jref.mla_attention_naive(*map(jnp.asarray, arrs)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", KERNEL_CASES)
def test_q8_kernel_matches_plain_version_on_card(cfg):
    """The int8 kernel (K3) against its plain version on the card, at
    hd = 128, on K1's cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, pkq, pvq, ks, vs, bt, start = _q8_case(cfg, hd=128)
    args = [torch.from_numpy(a).cuda() for a in (q, pkq, pvq, bt, start)]
    sc = dict(k_scale=torch.from_numpy(ks).cuda(),
              v_scale=torch.from_numpy(vs).cuda())
    got = pa.paged_attention(*args, window=cfg["window"], kind="prefill_q8",
                             **sc)
    want = tref.paged_attention(*args, window=cfg["window"], **sc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def _latent_edges(seed, B, Sq, H, Lw, ps, mps, start, holes=None,
                  spare=None):
    """``_latent_case`` plus edges of the kernel's key split: ``holes``
    {slot: page indices} unallocated inside a live slot's range, ``spare``
    {slot: n} pages allocated past its last row. Returns the inputs and
    the pool with every row no query can see set to NaN (the kernel never
    reads those rows; the plain version runs on the clean pool)."""
    q, pool, bt, start = _latent_case(seed, B, Sq, H, Lw, ps, mps, start)
    free = sorted(set(range(pool.shape[0])) - set(bt[bt >= 0].tolist()))
    for b, n in (spare or {}).items():
        need = -(-int(start[b] + Sq) // ps)
        bt[b, need:need + n] = free[:n]
        free = free[n:]
    for b, idx in (holes or {}).items():
        bt[b, list(idx)] = -1
    seen = np.zeros(pool.shape[:2], bool)
    for b in range(B):
        if start[b] < INACTIVE:
            for r in range(int(start[b]) + Sq):
                if bt[b, r // ps] >= 0:
                    seen[bt[b, r // ps], r % ps] = True
    poisoned = np.where(seen[:, :, None, None], pool, np.nan)
    return q, pool, poisoned.astype(np.float32), bt, start


# (Sq, (Lw, d_v, scale_dim), B, page_size, mps, starts, holes, spare)
LATENT_CARD_CASES = [
    (Sq, w, 4, 16, 4, [13, 7, INACTIVE, 60 - Sq], None, None)
    for w in ((10, 8, 16), (64, 48, 96), (576, 512, 192)) for Sq in (1, 4)
] + [
    # decode of 40 heads over 700+ live rows at the full width (many
    # splits): a fill ending mid-page (732), a freed slot beside a full
    # one (1024 rows), and a slot of 100 rows with 4 unallocated pages
    # (splits whose range holds only -1 pages) and 8 pages allocated past
    # its frontier
    (1, (576, 512, 192), 4, 16, 64, [731, INACTIVE, 1023, 99],
     {3: range(2, 6)}, {3: 8}),
    # a 37-row chunk: a freed slot beside a full one, a fill ending
    # mid-page, pages of 8 rows (two per key tile)
    (37, (576, 512, 192), 3, 8, 32, [INACTIVE, 256 - 37, 45], None,
     {2: 3}),
    # the widest rows (a 2-stage ring), values as wide as the rows
    (1, (1024, 1024, 192), 2, 16, 32, [200, 511], {1: [5]}, {0: 2}),
    (4, (1024, 512, 192), 2, 16, 32, [300, 40], None, None),
    # rows that are not a multiple of 4 floats (4-byte staging), many
    # splits, pages of 4 rows
    (1, (10, 8, 16), 3, 4, 64, [250, INACTIVE, 17], {0: range(10, 30)},
     {2: 5}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", LATENT_CARD_CASES)
def test_latent_kernel_matches_plain_version_on_card(case):
    """The latent kernel (K4) against its plain version on the card: the
    reduced, a middle and the full latent width with a freed slot; decode
    split over many blocks at 700+ live rows; split ranges of only -1
    pages or wholly past the frontier; a freed slot beside a full one
    (exact zeros); fills ending mid-page; the widest rows. Rows no query
    can see are NaN in the kernel's pool and never reach its output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Sq, (Lw, d_v, scale_dim), B, ps, mps, start, holes, spare = case
    q, clean, poisoned, bt, start = _latent_edges(
        16, B, Sq, 40, Lw, ps, mps, start, holes, spare)
    q, clean, poisoned, bt, start = (torch.from_numpy(a).cuda() for a in (
        q, clean, poisoned, bt, start))
    kind = "decode_latent" if Sq == 1 else "prefill_latent"
    got = pa.paged_attention_latent(q, poisoned, bt, start,
                                    scale_dim=scale_dim, d_v=d_v, kind=kind)
    want = tref.paged_attention_latent(q, clean, bt, start,
                                       scale_dim=scale_dim, d_v=d_v)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    for b in range(B):
        if start[b] >= INACTIVE:
            assert torch.all(got[b] == 0)


# (B, H * Sq, Lw, d_v, mps * page_size) -> (rows, stages, splits)
LATENT_PLANS = [
    ((8, 2560, 576, 512, 1024), (32, 3, 1)),    # full-width prefill chunk
    ((8, 40, 576, 512, 1024), (16, 3, 11)),     # full-width decode tick
    ((3, 40, 1024, 512, 64), (16, 2, 4)),       # widest rows, 4 key tiles
    ((2, 40, 1024, 1024, 512), (16, 2, 32)),    # values as wide as rows
    ((4, 160, 64, 48, 64), (32, 3, 4)),         # a tie pads least at 32
    ((4, 1480, 10, 8, 1024), (16, 3, 1)),       # 16 pads less; fills
]


@pytest.mark.parametrize("shape,want", LATENT_PLANS)
def test_latent_plan(shape, want):
    """latent_plan: the row tile that pads least (32 on a tie) whose value
    columns and 2-stage ring fit, 3 stages where they fit, no split where
    the (slot, row tile) pairs fill the SMs, else about two blocks per SM
    capped at one per key tile; its shared memory fits the card."""
    plan = pa.latent_plan(*shape, q_ptr=256, pool_ptr=512)
    assert (plan.rows, plan.stages, plan.splits) == want
    assert plan.smem <= pa.SMEM_MAX and plan.vec == (shape[2] % 4 == 0)
    assert pa.LATENT_THREADS // (plan.rows // 8) * 4 >= shape[3]
    if plan.stages == 2:
        assert pa._latent_smem(plan.rows, shape[2], 3) > pa.SMEM_MAX
    assert plan.c_args() == want + (int(plan.vec),)


def test_latent_plan_rejects_and_unaligned():
    assert not pa.latent_plan(2, 40, 576, 512, 64, q_ptr=8).vec
    with pytest.raises(ValueError, match="d_v"):
        pa.latent_plan(2, 40, 576, 600, 64)
    with pytest.raises(ValueError, match="d_v"):
        pa.latent_plan(2, 40, 2048, 512, 64)


# --------------------------------------------- K1 / K3: plan and splits
# (B, Sq, H, KV, hd, mps * page_size, pool element bytes, pointers)
#   -> (rows, key_tile, stages, splits, vec); int8 pools are 1, bf16 2
PAGED_PLANS = [
    # qwen2.5-32b at full width: a decode tick (64 pairs for 132 SMs:
    # split 4 ways) and a prefill chunk (320 pairs: no split)
    ((8, 1, 40, 8, 128, 1024, 4, (256, 512)), (16, 32, 3, 4, True)),
    ((8, 64, 40, 8, 128, 1024, 4, (256, 512)), (64, 64, 2, 1, True)),
    # int8 pools: a quarter of the ring's bytes; 32-key tiles at prefill,
    # whose 3 stages leave room for two blocks on an SM
    ((8, 1, 40, 8, 128, 1024, 1, (256, 512)), (16, 32, 3, 4, True)),
    ((8, 64, 40, 8, 128, 1024, 1, (256, 512)), (64, 32, 3, 1, True)),
    # head_dim 16 (int8 rows of 16 bytes), 64 and 256 (64-key tiles no
    # longer fit a ring beside 64 rows of Q)
    ((8, 1, 40, 8, 16, 1024, 1, (256, 512)), (16, 32, 3, 4, True)),
    ((8, 64, 40, 8, 64, 1024, 4, (256, 512)), (64, 64, 3, 1, True)),
    ((8, 1, 40, 8, 256, 1024, 4, (256, 512)), (16, 32, 3, 4, True)),
    ((8, 64, 40, 8, 256, 1024, 4, (256, 512)), (64, 32, 2, 1, True)),
    # one page a slot (page_size == s_max = 64): few pairs, but no more
    # splits than key tiles
    ((2, 1, 8, 2, 128, 64, 4, (256, 512)), (16, 32, 3, 2, True)),
    ((2, 64, 8, 2, 128, 64, 1, (256, 512)), (64, 32, 3, 2, True)),
    # an unaligned pointer, int8 rows not a multiple of 16 bytes: 4-byte
    # staging
    ((2, 4, 4, 2, 128, 256, 4, (256, 8)), (16, 32, 3, 8, False)),
    ((2, 1, 4, 2, 20, 256, 1, (256, 512)), (16, 32, 3, 8, False)),
    # bf16 pools: 32-key tiles as int8's (the upcasting pass); 16-byte
    # staging needs rows of 8 elements
    ((8, 1, 40, 8, 128, 1024, 2, (256, 512)), (16, 32, 3, 4, True)),
    ((8, 64, 40, 8, 128, 1024, 2, (256, 512)), (64, 32, 3, 1, True)),
    ((8, 64, 40, 8, 256, 1024, 2, (256, 512)), (64, 32, 2, 1, True)),
    ((2, 1, 4, 2, 20, 256, 2, (256, 512)), (16, 32, 3, 8, False)),
]


@pytest.mark.parametrize("shape,want", PAGED_PLANS)
def test_paged_plan(shape, want):
    """paged_plan: the row tile that pads the group's rows least (64 on a
    tie), its key tile (64 keys for 64 rows of fp32 where two stages fit,
    else 32), 3 stages where they fit, no split where the (slot,
    kv head, row tile) blocks fill the SMs, else about two blocks per SM
    capped at one split per key tile; its shared memory fits the card."""
    B, Sq, H, KV, hd, n_keys, elem, ptrs = shape
    plan = pa.paged_plan(B, Sq, H, KV, hd, n_keys, elem=elem, ptrs=ptrs)
    assert (plan.rows, plan.key_tile, plan.stages, plan.splits,
            plan.vec) == want
    assert plan.c_args() == want[:4] + (int(want[4]),)
    hdp = pa._head_pad(hd)
    assert plan.smem == pa._paged_smem(plan.rows, plan.key_tile, hdp,
                                       plan.stages, elem)
    assert plan.smem <= pa.SMEM_MAX
    if plan.stages == 2:
        assert pa._paged_smem(plan.rows, plan.key_tile, hdp, 3,
                              elem) > pa.SMEM_MAX
    pairs = B * KV * -(-(H // KV * Sq) // plan.rows)
    if pairs >= pa.SMS:
        assert plan.splits == 1
    else:
        assert plan.splits <= -(-n_keys // plan.key_tile)
        assert (plan.splits == -(-n_keys // plan.key_tile)
                or plan.splits == 2 * pa.SMS // pairs)


@pytest.mark.parametrize("shape", [
    (2, 1, 4, 2, 260, 64),     # head_dim past 256
    (2, 1, 4, 2, 18, 64),      # head_dim not a multiple of 4
    (2, 1, 6, 4, 128, 64),     # H not a multiple of KV
    (2, 1, 4, 2, 128, 0),      # no key
])
def test_paged_plan_rejects_what_the_kernel_cannot_take(shape):
    with pytest.raises(ValueError, match="paged_plan"):
        pa.paged_plan(*shape)


def _paged_edges(seed, B, Sq, hd, ps, mps, start, holes=None, spare=None,
                 window=0, H=40, KV=8):
    """Inputs for K1 / K3 at the edges of the kernel's key split: slot b
    holds the pages its rows up to start[b] + Sq - 1 need (none when its
    start is INACTIVE); ``holes`` {slot: page indices} unallocated inside a
    live slot's range, ``spare`` {slot: n} pages allocated past its last
    row. Returns (q, pool_k, pool_v, bt, start, seen): ``seen`` marks the
    pool rows some query can see (causal and window); the kernel reads no
    other row."""
    rng = np.random.default_rng(seed)
    P = B * mps + 4
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    pk = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    bt = np.full((B, mps), -1, np.int32)
    free = list(rng.permutation(P))
    for b in range(B):
        if start[b] >= INACTIVE:
            continue
        need = -(-int(start[b] + Sq) // ps) + (spare or {}).get(b, 0)
        bt[b, :need] = free[:need]
        free = free[need:]
    for b, idx in (holes or {}).items():
        bt[b, list(idx)] = -1
    seen = np.zeros((P, ps), bool)
    for b in range(B):
        if start[b] >= INACTIVE:
            continue
        last = int(start[b]) + Sq - 1
        first = int(start[b]) - window + 1 if window else 0
        for r in range(max(first, 0), last + 1):
            if bt[b, r // ps] >= 0:
                seen[bt[b, r // ps], r % ps] = True
    return q, pk, pv, bt, np.asarray(start, np.int32), seen


# (Sq, hd, B, page_size, mps, starts, holes, spare, window)
PAGED_CARD_CASES = [
    # decode over 700+ live rows (splits): a fill ending mid-page (732),
    # a freed slot beside a full one (1024 rows), a slot of 100 rows with
    # 4 unallocated pages (splits whose range holds only -1 pages) and 8
    # pages allocated past its frontier
    (1, 128, 4, 16, 64, [731, INACTIVE, 1023, 99], {3: range(2, 6)},
     {3: 8}, 0),
    # a window whose start falls inside a key tile, ranges split 16 ways
    (1, 128, 2, 16, 64, [700, 400], None, {1: 2}, 300),
    # a 37-row chunk with a window, pages of 8 rows: a freed slot, a fill
    # ending mid-page, pages past the frontier
    (37, 128, 3, 8, 32, [INACTIVE, 256 - 37, 45], None, {2: 3}, 50),
    # page sizes 8, 32 and 64, decode and chunk, fills ending mid-page
    (1, 128, 3, 8, 128, [900, 13, 333], {0: [7, 40]}, {1: 1}, 0),
    (16, 128, 3, 32, 32, [600, 17, 100], None, {2: 2}, 0),
    (1, 128, 2, 64, 16, [1000, 70], None, {1: 3}, 0),
    (64, 128, 2, 64, 16, [300, 0], None, None, 0),
    # page_size == s_max: one page a slot, split over its key tiles
    (1, 128, 3, 256, 1, [255, 100, INACTIVE], None, None, 0),
    (8, 128, 2, 256, 1, [200, 0], None, None, 0),
    # head_dim 16, 64 and 256 (16-byte int8 rows at 16)
    (1, 16, 3, 16, 64, [500, INACTIVE, 31], {0: [3]}, {2: 4}, 0),
    (4, 64, 3, 16, 64, [120, 800, 7], None, {0: 2}, 100),
    (1, 256, 2, 16, 64, [640, 90], {1: [1]}, None, 0),
]


def _on_card(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_CARD_CASES)
def test_kernel_split_edges_on_card(case):
    """K1 against its plain version on the card at the edges of its split
    over keys: splits of only -1 pages, split ranges past the frontier, a
    window crossing a split boundary, fills ending mid-page, page sizes 8
    to 64 and page_size == s_max, head_dim 16 to 256. Rows no query can
    see are NaN in the kernel's pools and never reach its output; a freed
    slot is exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Sq, hd, B, ps, mps, start, holes, spare, window = case
    q, pk, pv, bt, start, seen = _paged_edges(21, B, Sq, hd, ps, mps, start,
                                              holes, spare, window)
    poison = lambda a: np.where(seen[:, :, None, None], a,  # noqa: E731
                                np.nan).astype(np.float32)
    args = _on_card(q, pk, pv, bt, start)
    bad_k, bad_v = _on_card(poison(pk), poison(pv))
    kind = "decode" if Sq == 1 else "prefill"
    got = pa.paged_attention(args[0], bad_k, bad_v, *args[3:],
                             window=window, kind=kind)
    want = tref.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    for b in range(B):
        if start[b] >= INACTIVE:
            assert torch.all(got[b] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_CARD_CASES)
def test_q8_kernel_split_edges_on_card(case):
    """K3 at the same edges: against its plain version, and with NaN
    scales on every page whose rows no query can see (never read: the
    output is unchanged bit for bit); a freed slot is exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Sq, hd, B, ps, mps, start, holes, spare, window = case
    q, pk, pv, bt, start, seen = _paged_edges(22, B, Sq, hd, ps, mps, start,
                                              holes, spare, window)
    (pkq, ks), (pvq, vs) = _q8(pk), _q8(pv)
    args = _on_card(q, pkq, pvq, bt, start)
    sc = dict(zip(("k_scale", "v_scale"), _on_card(ks, vs)))
    unseen = torch.from_numpy(~seen.any(axis=1)).cuda()
    nan_sc = {k: torch.where(unseen, float("nan"), v) for k, v in sc.items()}
    kind = "decode_q8" if Sq == 1 else "prefill_q8"
    got = pa.paged_attention(*args, window=window, kind=kind, **sc)
    got_nan = pa.paged_attention(*args, window=window, kind=kind, **nan_sc)
    want = tref.paged_attention(*args, window=window, **sc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, got_nan)
    for b in range(B):
        if start[b] >= INACTIVE:
            assert torch.all(got[b] == 0)


def _within_bf16_step(got, want):
    """bf16 outputs within TOL and one bf16 step at every element: the
    kernel and its plain version compute in fp32, their sums in other
    orders (TOL), and each rounds once to bf16 (a step at most)."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float().cpu(), want.float().cpu()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(torch.bfloat16).smallest_normal)
    allowed = (torch.exp2(torch.floor(torch.log2(big)) - 7) + TOL["atol"]
               + TOL["rtol"] * w.abs())
    assert bool(((g - w).abs() <= allowed).all())


# (q dtype, pool dtype) of the bf16 entries: bf16 compute over bf16 pages,
# over fp32 pages, and fp32 q over bf16 pages
BF16_PAIRS = [(torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.float32, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", BF16_PAIRS, ids=["bf16", "bf16-f32",
                                                    "f32-bf16"])
@pytest.mark.parametrize("case", PAGED_CARD_CASES)
def test_bf16_kernel_split_edges_on_card(case, dtypes):
    """K1's bf16 entries at the split's edges: within one bf16 step of the
    plain version for a bf16 output (fp32 q: TOL), rows no query can see
    NaN and never read, a freed slot exactly 0; K3 with bf16 q over int8
    pools the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Sq, hd, B, ps, mps, start, holes, spare, window = case
    qd, pd = dtypes
    q, pk, pv, bt, start, seen = _paged_edges(23, B, Sq, hd, ps, mps, start,
                                              holes, spare, window)
    poison = lambda a: np.where(seen[:, :, None, None], a,  # noqa: E731
                                np.nan).astype(np.float32)
    args = _on_card(q, pk, pv, bt, start)
    args = [args[0].to(qd), args[1].to(pd), args[2].to(pd), *args[3:]]
    bad = [t.to(pd) for t in _on_card(poison(pk), poison(pv))]
    kind = "decode" if Sq == 1 else "prefill"
    got = pa.paged_attention(args[0], *bad, *args[3:], window=window,
                             kind=kind)
    want = tref.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    if qd == torch.bfloat16:
        _within_bf16_step(got, want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)
    for b in range(B):
        if start[b] >= INACTIVE:
            assert torch.all(got[b] == 0)
    if dtypes == BF16_PAIRS[0]:
        (pkq, ks), (pvq, vs) = _q8(pk), _q8(pv)
        a8 = _on_card(q, pkq, pvq, bt, start)
        a8[0] = a8[0].to(torch.bfloat16)
        sc = dict(zip(("k_scale", "v_scale"), _on_card(ks, vs)))
        got = pa.paged_attention(*a8, window=window, kind=kind + "_q8", **sc)
        _within_bf16_step(got, tref.paged_attention(*a8, window=window,
                                                    **sc))


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", BF16_PAIRS, ids=["bf16", "bf16-f32",
                                                    "f32-bf16"])
@pytest.mark.parametrize("case", LATENT_CARD_CASES)
def test_bf16_latent_kernel_on_card(case, dtypes):
    """K4's bf16 entries at the latent card cases, as the fp32 test: rows
    no query can see NaN in the pool, a freed slot exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Sq, (Lw, d_v, scale_dim), B, ps, mps, start, holes, spare = case
    qd, pd = dtypes
    q, clean, poisoned, bt, start = _latent_edges(
        17, B, Sq, 40, Lw, ps, mps, start, holes, spare)
    q, clean, poisoned, bt, start = (torch.from_numpy(a).cuda() for a in (
        q, clean, poisoned, bt, start))
    q, clean, poisoned = q.to(qd), clean.to(pd), poisoned.to(pd)
    kind = "decode_latent" if Sq == 1 else "prefill_latent"
    got = pa.paged_attention_latent(q, poisoned, bt, start,
                                    scale_dim=scale_dim, d_v=d_v, kind=kind)
    want = tref.paged_attention_latent(q, clean, bt, start,
                                       scale_dim=scale_dim, d_v=d_v)
    torch.cuda.synchronize()
    if qd == torch.bfloat16:
        _within_bf16_step(got, want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)
    for b in range(B):
        if start[b] >= INACTIVE:
            assert torch.all(got[b] == 0)
