"""The port's flash attention against the reference: the plain PyTorch
version (what CPU tensors run) against ``repro.kernels.ref.flash_attention``
and against ``repro.kernels.ops.flash_attention`` / ``flash_prefill`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it), on
the reference's kernel cases (causal and not, GQA, a window, Sq != Sk) and
on the serving engine's chunk lengths 1, 2, 37 and 64. Inputs are made with
numpy from a seed and handed to both packages.

Tolerance rtol = atol = 2e-4, as ``tests/test_kernels.py`` holds the Pallas
kernel to its oracle: the Pallas kernel scales q before the dot and sums
block by block, the plain version divides after the dot and sums in one
einsum. The plain version against the oracle (the same order) is held to
2e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
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


KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
ORACLE_TOL = dict(rtol=2e-5, atol=2e-5)

# the reference's kernel cases (tests/test_kernels.py) at head_dim 64
CASES = [
    dict(Sq=256, Sk=256, H=4, KV=2, causal=True, window=0),
    dict(Sq=256, Sk=256, H=4, KV=4, causal=False, window=0),
    dict(Sq=256, Sk=256, H=8, KV=2, causal=True, window=64),
    dict(Sq=128, Sk=512, H=2, KV=1, causal=False, window=0),
]
# prefill chunks from the engine's ladder, reduced qwen heads (4 over 1)
CHUNKS = [dict(Sq=c, Sk=c, H=4, KV=1, causal=True, window=w)
          for c in (1, 2, 37, 64) for w in (0, 8)]


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


def _name(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


@pytest.mark.parametrize("c", CASES + CHUNKS, ids=_name)
def test_plain_version_matches_oracle_and_pallas_kernel(c):
    hd = 64 if c in CASES else 16
    q, k, v = _qkv(1, 2, c["Sq"], c["Sk"], c["H"], c["KV"], hd)
    kw = dict(causal=c["causal"], window=c["window"])
    got = tref.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention(jq, jk, jv, **kw)),
        **ORACLE_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.flash_attention(
            jq, jk, jv, block_q=64, block_k=64, **kw)), **KERNEL_TOL)


@pytest.mark.parametrize("c", [CASES[0], CASES[2]] + CHUNKS[::2], ids=_name)
def test_flash_prefill_returns_its_kv_inputs(c):
    """O matches the reference's K/V-exporting kernel and the exported K/V
    ARE the inputs (the same tensors, so equal bit for bit), as in the
    plain version."""
    hd = 64 if c in CASES else 16
    q, k, v = _qkv(2, 2, c["Sq"], c["Sk"], c["H"], c["KV"], hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, ko, vo = tops.flash_prefill(tq, tk, tv, window=c["window"])
    po, pko, pvo = tref.flash_attention_kv(tq, tk, tv, window=c["window"])
    assert ko is tk and vo is tv and pko is tk and pvo is tv
    torch.testing.assert_close(o, po, rtol=0, atol=0)
    jo, jko, jvo = jops.flash_prefill(*map(jnp.asarray, (q, k, v)),
                                      window=c["window"], block_q=64,
                                      block_k=64)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **KERNEL_TOL)
    np.testing.assert_array_equal(ko.numpy(), np.asarray(jko))
    np.testing.assert_array_equal(vo.numpy(), np.asarray(jvo))


def test_positions_must_be_row_indices():
    """ops.flash_attention accepts positions for API parity, but only the
    row indices the kernel derives; the oracle honours any positions."""
    q, k, v = map(torch.from_numpy, _qkv(3, 2, 8, 8, 4, 2, 16))
    pos = torch.arange(8).expand(2, 8)
    base = tops.flash_attention(q, k, v)
    torch.testing.assert_close(
        tops.flash_attention(q, k, v, q_positions=pos, k_positions=pos), base,
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="row indices"):
        tops.flash_attention(q, k, v, q_positions=pos + 3, k_positions=pos)
    shifted = tref.flash_attention(q, k, v, q_positions=pos + 3,
                                   k_positions=pos)
    want = jref.flash_attention(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                                   v.numpy())),
                                q_positions=jnp.asarray(pos.numpy() + 3),
                                k_positions=jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(shifted.numpy(), np.asarray(want),
                               **ORACLE_TOL)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    """On CPU tensors the wrapper takes the plain version and raises no
    launch count; malformed inputs raise before anything runs."""
    q, k, v = map(torch.from_numpy, _qkv(4, 2, 8, 12, 4, 2, 16))
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=False, window=4)
    torch.testing.assert_close(
        out, tref.flash_attention(q, k, v, causal=False, window=4),
        rtol=0, atol=0)
    assert set(fa.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :1].expand(2, 12, 3, 16), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, kind="decode")


# one case of each kind at every head_dim the kernel's template covers
CARD_CASES = [dict(B=2, Sq=c["Sq"], Sk=c["Sk"], H=c["H"], KV=c["KV"],
                   causal=c["causal"], window=c["window"], hd=hd)
              for hd in (16, 64, 128, 256) for c in CASES] + \
    [dict(B=3, Sq=c, Sk=c, H=H, KV=KV, causal=True, window=w, hd=128)
     for c in (1, 2, 37, 64, 100) for H, KV in ((8, 8), (40, 8), (8, 1))
     for w in (0, 64)] + \
    [  # lengths off the 64-row and 64-key tiles, Sq != Sk both ways
     dict(B=2, Sq=300, Sk=1000, H=40, KV=8, causal=True, window=0, hd=128),
     dict(B=2, Sq=1000, Sk=300, H=40, KV=8, causal=False, window=0, hd=128),
     # a window of 64 over 1,000 rows: whole K/V tiles skipped per block
     dict(B=1, Sq=1000, Sk=1000, H=10, KV=2, causal=True, window=64, hd=64),
     dict(B=1, Sq=1000, Sk=1000, H=8, KV=1, causal=False, window=64,
          hd=128),
     # grids that fill the card (head_dim 128 takes 128 x 128 tiles)
     dict(B=2, Sq=1000, Sk=1000, H=40, KV=8, causal=True, window=0, hd=128),
     dict(B=2, Sq=700, Sk=700, H=40, KV=8, causal=True, window=100,
          hd=128),
     # G = 8 at head_dim 256; head_dims off the buckets
     dict(B=2, Sq=300, Sk=300, H=8, KV=1, causal=True, window=0, hd=256),
     dict(B=2, Sq=100, Sk=130, H=6, KV=2, causal=True, window=0, hd=4),
     dict(B=1, Sq=70, Sk=70, H=5, KV=1, causal=False, window=16, hd=196)]


@pytest.mark.gpu
@pytest.mark.parametrize("c", CARD_CASES, ids=_name)
def test_kernel_matches_plain_version_on_card(c):
    """The CUDA kernel against its plain version on the card, within
    2e-5: the same fp32 arithmetic, summed in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(
        5, c["B"], c["Sq"], c["Sk"], c["H"], c["KV"], c["hd"]))
    got = fa.flash_attention(q, k, v, causal=c["causal"], window=c["window"])
    want = tref.flash_attention(q, k, v, causal=c["causal"],
                                window=c["window"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ORACLE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("c", CARD_CASES, ids=_name)
def test_bf16_kernel_matches_plain_version_on_card(c):
    """The bf16 entry (q, k, v and the output bf16) against the plain
    version on the card: both compute in fp32, their sums in other orders
    (ORACLE_TOL), and round once, so each element within ORACLE_TOL and
    one bf16 step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(
        5, c["B"], c["Sq"], c["Sk"], c["H"], c["KV"], c["hd"]))
    got = fa.flash_attention(q, k, v, causal=c["causal"], window=c["window"])
    want = tref.flash_attention(q, k, v, causal=c["causal"],
                                window=c["window"])
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float().cpu(), want.float().cpu()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(torch.bfloat16).smallest_normal)
    allowed = (torch.exp2(torch.floor(torch.log2(big)) - 7)
               + ORACLE_TOL["atol"] + ORACLE_TOL["rtol"] * w.abs())
    assert bool(((g - w).abs() <= allowed).all())
