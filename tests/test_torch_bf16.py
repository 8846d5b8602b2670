"""bf16 serving: the port against ``repro`` at ``compute_dtype=bfloat16``.

- The plain versions of K1, K3, K4 and K2 (``kernels.ref``, what CPU
  tensors run) at bf16 q over bf16, fp32 and int8 pools (latent pools bf16
  and fp32), held against ``repro``'s Pallas kernels in interpret mode,
  called as ``tests/test_kernels.py`` calls them, within the fp32
  tolerance and one bf16 step of each element (both compute in fp32 and
  round once, at the output; their fp32 sums run in different orders, and
  each rounding adds at most a step), and against ``repro.kernels.ref`` at
  ``repro``'s own bf16 tolerance, 2e-2 (``tests/test_kernels.py:37``; that
  oracle rounds K, V and p to bf16, the kernels do not).
- ``ServeEngine(..., compute_dtype=bfloat16, cache_dtype=...)`` streams
  equal ``repro``'s engine built the same way, with ``cache_dtype`` None
  (the cache in bf16) and fp32, on reduced qwen2.5-32b (fp32, bf16 and
  int8 pages, the dense cache), qwen2.5-32b-mla (latent pages), rwkv6-7b
  and hymba-1.5b. ``repro`` on the CPU sends these reduced grids (B * H *
  mps <= 4096) to its Pallas kernels in interpret mode
  (``repro/kernels/ops.py:132``, ``:144-147``), whose function the port's
  plain versions compute; its first chunks take the einsum ('auto' on the
  CPU), as the port's do.
- The engine's cache leaves: every K/V pool and row in the cache dtype,
  int8 scales and recurrent states fp32.
- With every slot freed, a bf16 decode tick gives finite logits on fp32,
  bf16, int8 and latent pages (``tests/test_serve.py:512-530``).
- The serving step builders' dtype defaults are ``repro``'s."""
import inspect
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.quantize import quantize_page  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import ServeConfig as TConfig  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
# repro's bf16 kernel tolerance (tests/test_kernels.py:37)
ORACLE_TOL = dict(rtol=2e-2, atol=2e-2)
# two fp32 sums of the same attention in other orders
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
INACTIVE = 1 << 30
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int8: jnp.int8}


def _np(t):
    return t.float().numpy() if t.dtype == BF16 else t.numpy()


def _jax(t):
    return jnp.asarray(_np(t), _JDT[t.dtype])


def assert_within_bf16_step(got, want):
    """Two bf16 results within FP32_TOL and one bf16 step of each other at
    every element: the fp32 values they round differ as two fp32 sums in
    other orders do (FP32_TOL, ``tests/test_torch_paged_attention.py``),
    and each rounding to bf16 adds at most one step."""
    assert got.dtype == BF16 and tuple(got.shape) == tuple(want.shape)
    g = got.float()
    w = torch.from_numpy(np.asarray(want, np.float32))
    big = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(BF16).smallest_normal)
    allowed = (torch.exp2(torch.floor(torch.log2(big)) - 7)
               + FP32_TOL["atol"] + FP32_TOL["rtol"] * w.abs())
    diff = (g - w).abs()
    assert bool((diff <= allowed).all()), \
        f"{int((diff > allowed).sum())} elements further than FP32_TOL " \
        f"and a bf16 step (max diff {float(diff.max())})"


def _pages(seed, B, Sq, H, KV, hd, ps, mps, fill):
    """Random q / pools (float32) and block tables giving slot b the pages
    its fill[b] rows need, in a shuffled order; a slot with fill 0 is
    freed (all -1, start at INACTIVE)."""
    rng = np.random.default_rng(seed)
    P = B * mps + 2
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
    start = np.asarray([f - Sq if f else INACTIVE for f in fill], np.int32)
    return (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(bt), torch.from_numpy(start))


def _int8_pools(pk, pv):
    """int8 pools and (P,) f32 scales: each page quantized whole."""
    out = []
    for pool in (pk, pv):
        qs, scales = zip(*(quantize_page(page) for page in pool))
        out += [torch.stack(qs), torch.stack(scales).reshape(-1)]
    return out


# (Sq, window, fill): decode and prefill-chunk shapes, a window, a freed
# slot
PAGED_SHAPES = [(1, 0, [5, 29, 0]), (8, 0, [8, 31, 17]),
                (1, 12, [30, 9, 0]), (8, 12, [19, 32, 11])]
# (q dtype, pool dtype): bf16 compute over bf16 pages (cache_dtype None)
# and over fp32 pages (repro's step default), and fp32 q over bf16 pages
PAGED_DTYPES = [(BF16, BF16), (BF16, torch.float32), (torch.float32, BF16)]


@pytest.mark.parametrize("dtypes", PAGED_DTYPES,
                         ids=lambda d: f"{d[0]}-{d[1]}".replace("torch.", ""))
@pytest.mark.parametrize("shape", PAGED_SHAPES, ids=str)
def test_paged_plain_version_is_the_kernels_function(shape, dtypes):
    """K1's plain version at bf16 against the Pallas kernel (interpret
    mode) within FP32_TOL and a bf16 step, and against ``repro``'s oracle
    at 2e-2; the
    output comes back in q's dtype."""
    Sq, window, fill = shape
    qd, pd = dtypes
    q, pk, pv, bt, start = _pages(11, 3, Sq, 4, 2, 32, 8, 4, fill)
    q, pk, pv = q.to(qd), pk.to(pd), pv.to(pd)
    got = tpa.paged_attention(q, pk, pv, bt, start, window=window)
    assert got.dtype == qd
    jargs = (_jax(q), _jax(pk), _jax(pv), jnp.asarray(bt.numpy()),
             jnp.asarray(start.numpy()))
    want = jpa.paged_attention(*jargs, window=window, interpret=True)
    if qd == BF16:
        assert_within_bf16_step(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    oracle = jref.paged_attention(*jargs, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(oracle, np.float32),
                               **ORACLE_TOL)
    assert torch.all(got[start == INACTIVE] == 0)


@pytest.mark.parametrize("shape", PAGED_SHAPES, ids=str)
def test_paged_q8_plain_version_at_bf16(shape):
    """K3's plain version: bf16 q over int8 pools with f32 page scales,
    against the int8 Pallas kernel within a bf16 step and the oracle at
    2e-2."""
    Sq, window, fill = shape
    q, pk, pv, bt, start = _pages(12, 3, Sq, 4, 2, 32, 8, 4, fill)
    qk, ks, qv, vs = _int8_pools(pk, pv)
    q = q.to(BF16)
    got = tpa.paged_attention(q, qk, qv, bt, start, window=window,
                              kind="decode_q8" if Sq == 1 else "prefill_q8",
                              k_scale=ks, v_scale=vs)
    assert got.dtype == BF16
    jargs = (_jax(q), _jax(qk), _jax(qv), jnp.asarray(bt.numpy()),
             jnp.asarray(start.numpy()))
    jsc = dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    assert_within_bf16_step(got, jpa.paged_attention(
        *jargs, window=window, interpret=True, **jsc))
    np.testing.assert_allclose(
        _np(got), np.asarray(jref.paged_attention(*jargs, window=window,
                                                  **jsc), np.float32),
        **ORACLE_TOL)


@pytest.mark.parametrize("pool_dtype", [BF16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("Sq,fill", [(1, [5, 29, 0]), (8, [8, 31, 17])],
                         ids=["decode", "prefill"])
def test_latent_plain_version_at_bf16(Sq, fill, pool_dtype):
    """K4's plain version: bf16 absorbed queries over bf16 or fp32 latent
    pages, against the latent Pallas kernel within a bf16 step and the
    oracle at 2e-2."""
    rng = np.random.default_rng(13)
    B, H, Lw, d_v, ps, mps = 3, 4, 48, 32, 8, 4
    _, _, _, bt, start = _pages(13, B, Sq, H, 1, 8, ps, mps, fill)
    P = B * mps + 2
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, Lw)).astype(
        np.float32)).to(BF16)
    pool = torch.from_numpy(rng.standard_normal((P, ps, 1, Lw)).astype(
        np.float32)).to(pool_dtype)
    got = tpa.paged_attention_latent(q, pool, bt, start, scale_dim=24,
                                     d_v=d_v, kind="decode_latent")
    assert got.dtype == BF16 and tuple(got.shape) == (B, Sq, H, d_v)
    jargs = (_jax(q), _jax(pool), jnp.asarray(bt.numpy()),
             jnp.asarray(start.numpy()))
    assert_within_bf16_step(got, jpa.paged_attention_latent(
        *jargs, scale_dim=24, d_v=d_v, interpret=True))
    np.testing.assert_allclose(
        _np(got), np.asarray(jref.paged_attention_latent(
            *jargs, scale_dim=24, d_v=d_v), np.float32), **ORACLE_TOL)
    assert torch.all(got[start == INACTIVE] == 0)


@pytest.mark.parametrize("cfg", [
    dict(Sq=64, Sk=64, H=4, KV=2, causal=True, window=0),
    dict(Sq=64, Sk=64, H=4, KV=4, causal=False, window=0),
    dict(Sq=64, Sk=64, H=8, KV=2, causal=True, window=16),
], ids=str)
def test_flash_plain_version_at_bf16(cfg):
    """K2's plain version with q, k, v in bf16 against the Pallas kernel
    (interpret mode, q scaled then dotted) within a bf16 step and the
    oracle, which rounds p to bf16, at 2e-2."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, cfg[s], cfg[h], 32)).astype(np.float32)).to(BF16)
        for s, h in (("Sq", "H"), ("Sk", "KV"), ("Sk", "KV")))
    got = tfa.flash_attention(q, k, v, causal=cfg["causal"],
                              window=cfg["window"], kind="prefill")
    assert got.dtype == BF16
    jargs = (_jax(q), _jax(k), _jax(v))
    assert_within_bf16_step(got, jfa.flash_attention(
        *jargs, causal=cfg["causal"], window=cfg["window"], block_q=32,
        block_k=32, interpret=True))
    np.testing.assert_allclose(
        _np(got), np.asarray(jref.flash_attention(
            *jargs, causal=cfg["causal"], window=cfg["window"]), np.float32),
        **ORACLE_TOL)


def test_wrappers_take_the_dtype_pairs_on_cpu_without_counting():
    """On CPU tensors the wrappers run the plain versions for every dtype
    pair and raise no launch count; the counts have a key for every C
    entry."""
    tpa.reset_launches()
    tfa.reset_launches()
    q, pk, pv, bt, start = _pages(15, 2, 1, 4, 2, 32, 8, 4, [9, 20])
    for qd, pd in PAGED_DTYPES:
        tpa.paged_attention(q.to(qd), pk.to(pd), pv.to(pd), bt, start)
    assert set(tpa.LAUNCHES.values()) == {0}
    assert {"decode_bf16", "decode_bf16_f32", "decode_f32_bf16",
            "prefill_q8_bf16", "decode_latent_bf16",
            "prefill_latent_bf16_f32"} <= set(tpa.LAUNCHES)
    assert tpa.launch_suffix(BF16, torch.int8) == "_bf16"
    assert tpa.launch_suffix(torch.float32, torch.float32) == ""
    assert set(tfa.LAUNCHES) == {"prefill", "forward", "prefill_bf16",
                                 "forward_bf16"}


# (B, H * Sq, Lw, d_v, mps * page_size) -> (rows, stages, splits)
LATENT_BF16_PLANS = [
    ((8, 2560, 576, 512, 1024), (32, 3, 1)),    # full-width prefill chunk
    ((8, 40, 576, 512, 1024), (16, 3, 11)),     # full-width decode tick
    ((3, 40, 1024, 512, 64), (16, 2, 4)),       # widest rows: 2 stages
]


@pytest.mark.parametrize("shape,want", LATENT_BF16_PLANS)
def test_latent_plan_bf16(shape, want):
    """latent_plan over bf16 pools: the staged ring is half the bytes,
    plus one f32 tile it is upcast into; 3 stages where they fit, 16-byte
    staging needs rows of 8 elements, and an odd row width is refused."""
    plan = tpa.latent_plan(*shape, q_ptr=256, pool_ptr=512, elem=2)
    assert (plan.rows, plan.stages, plan.splits) == want
    if plan.stages == 2:
        assert tpa._latent_smem(plan.rows, shape[2], 3, 2) > tpa.SMEM_MAX
    assert plan.smem == tpa._latent_smem(plan.rows, shape[2], plan.stages, 2)
    assert plan.smem <= tpa.SMEM_MAX and plan.vec
    assert not tpa.latent_plan(2, 40, 36, 32, 64, q_ptr=256, pool_ptr=512,
                               elem=2).vec
    with pytest.raises(ValueError, match="even"):
        tpa.latent_plan(2, 40, 37, 32, 64, elem=2)


# ------------------------------------------------------------ engines
# Two ways of holding the port's bf16 engines to the reference's:
# - Streams: equal to ``repro``'s compiled with XLA's excess precision off
#   (``--xla_allow_excess_precision=false``, in a subprocess: the flag is
#   read once per process). By default XLA keeps fused bf16 elementwise
#   chains in fp32 and skips roundings the program writes; with it off,
#   every rounding the program writes happens, as in the port's eager ops,
#   and the streams are equal on every case below.
# - Logits along the trajectory of ``repro`` as it runs by default: each
#   step's logits recorded, the reference's handed on to the port's
#   sampler, so both run on the same tokens. Held within LOGIT_TOL of the
#   step's largest magnitude, with the same greedy token wherever the
#   reference's top-2 gap exceeds that. Reduced models in bf16 have
#   near-tied logits (vocab 512, 8 mantissa bits), so the excess precision
#   alone can flip a token and, from there, a whole stream.
LOGIT_TOL = 2e-2
# rwkv6-7b's recurrence carries the skipped roundings through every step
# (its logits move by up to 3.5 % there); the streams hold it exactly
RWKV_LOGIT_TOL = 5e-2
ENGINE_GEN = 6
NOISE = {"rwkv6-7b": {"u": 0.1, "mu": 0.1, "mu_x": 0.1, "lora_B": 0.01,
                      "wB": 0.01},
         "hymba-1.5b": {"logA": 0.5}}
# (arch, name, engine fields, cache dtype)
ENGINE_CASES = [
    ("qwen2.5-32b", "fp32-pages", dict(page_size=16), "float32"),
    ("qwen2.5-32b", "bf16-pages", dict(page_size=16), None),
    ("qwen2.5-32b", "int8-pages", dict(page_size=16,
                                       kv_backend="paged_int8"), None),
    ("qwen2.5-32b", "int8-pages-fp32-cache",
     dict(page_size=16, kv_backend="paged_int8"), "float32"),
    ("qwen2.5-32b", "dense", dict(), None),
    ("qwen2.5-32b", "dense-fp32-cache", dict(), "float32"),
    ("qwen2.5-32b-mla", "latent-pages", dict(page_size=16), None),
    ("qwen2.5-32b-mla", "latent-pages-fp32", dict(page_size=16), "float32"),
    ("rwkv6-7b", "dense", dict(), None),
    ("hymba-1.5b", "dense-ring", dict(), None),
    ("hymba-1.5b", "dense-ring-fp32-cache", dict(), "float32"),
    ("hymba-1.5b", "dense-ring-flash", dict(prefill_attn_impl="pallas"),
     None),
    ("hymba-1.5b", "paged-ring", dict(page_size=4), None),
]
ENGINE_IDS = [f"{a}-{n}" for a, n, _, _ in ENGINE_CASES]
# the cases held along the default-compiled reference's trajectory
TRAJECTORY_CASES = ["qwen2.5-32b-bf16-pages", "qwen2.5-32b-int8-pages",
                    "qwen2.5-32b-dense-fp32-cache",
                    "qwen2.5-32b-mla-latent-pages", "rwkv6-7b-dense",
                    "hymba-1.5b-dense-ring", "hymba-1.5b-dense-ring-flash"]


def reference_setup(arch):
    """The reference model, its weights as numpy (the recurrent families'
    zero-initialised leaves with seeded noise, as
    tests/test_torch_engine.py), the prompts (qwen's share a 20-token
    header: prefix hits and copy-on-write) and the engine fields."""
    from test_torch_ssm import perturbed
    rec = arch in NOISE
    jeng = JEngine.build(arch, config=JConfig(
        s_max=32 if rec else 64, page_size=None if rec else 16))
    params = (perturbed(jeng.params, NOISE[arch]) if rec
              else jax.tree.map(np.asarray, jeng.params))
    rng = np.random.default_rng(41)
    V = jeng.cfg.vocab_size
    if rec:
        return (jeng.model, params,
                [rng.integers(0, V, n) for n in (25, 3, 12, 1, 19)],
                dict(s_max=32, batch_slots=3))
    X = rng.integers(0, V, 20)
    prompts = [X, np.concatenate([X, rng.integers(0, V, 13)]),
               rng.integers(0, V, 9), rng.integers(0, V, 37),
               np.concatenate([X, rng.integers(0, V, 5)])]
    return jeng.model, params, prompts, dict(s_max=64)


def reference_engine(setup, fields, cache_dtype):
    model, params, _, base = setup
    return JEngine(model, jax.tree.map(jnp.asarray, params),
                   **JConfig(compute_dtype=jnp.bfloat16, **base,
                             **fields).engine_kwargs(),
                   cache_dtype=getattr(jnp, cache_dtype) if cache_dtype
                   else None)


def port_engine(arch, setup, fields, cache_dtype):
    _, params, _, base = setup
    model = treg.get_model(treg.reduced_config(tconfigs.get_config(arch)))
    return TEngine(model, bridge.params_from_numpy(params, "cpu"),
                   **TConfig(device="cpu", compute_dtype=BF16, **base,
                             **fields).engine_kwargs(),
                   cache_dtype=getattr(torch, cache_dtype) if cache_dtype
                   else None)


def serve(engine, prompts):
    reqs = [engine.submit(p, ENGINE_GEN) for p in prompts]
    engine.run()
    return [[int(t) for t in r.tokens] for r in reqs]


def reference_streams():
    """id -> the reference engine's greedy streams, every case."""
    setups, out = {}, {}
    for (arch, _, fields, cdt), cid in zip(ENGINE_CASES, ENGINE_IDS):
        if arch not in setups:
            setups[arch] = reference_setup(arch)
        out[cid] = serve(reference_engine(setups[arch], fields, cdt),
                         setups[arch][2])
    return out


@pytest.fixture(scope="module")
def setups():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = reference_setup(arch)
        return built[arch]
    return get


@pytest.fixture(scope="module")
def exact_reference_streams():
    """The reference's streams compiled with excess precision off, from a
    subprocess running this file."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__))],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,name,fields,cache_dtype", ENGINE_CASES,
                         ids=ENGINE_IDS)
def test_bf16_streams_equal_reference(setups, exact_reference_streams,
                                      arch, name, fields, cache_dtype):
    """``ServeEngine(compute_dtype=bfloat16, cache_dtype=...)`` serves the
    reference's greedy streams (compiled without excess precision) on the
    same weights and requests, with the same resolved paths; its cache
    holds K/V in the cache dtype."""
    setup = setups(arch)
    teng = port_engine(arch, setup, fields, cache_dtype)
    assert teng.cache_dtype == (getattr(torch, cache_dtype) if cache_dtype
                                else BF16)
    jeng = reference_engine(setup, fields, cache_dtype)
    assert (teng.paged, teng.prefix_cache, teng.paged_attn_impl,
            teng.prefill_attn_impl) == (jeng.paged, jeng.prefix_cache,
                                        jeng.paged_attn_impl,
                                        jeng.prefill_attn_impl)
    assert serve(teng, setup[2]) == \
        exact_reference_streams[f"{arch}-{name}"]


def _recording(fn, rec):
    def run(*args, **kw):
        logits, cache = fn(*args, **kw)
        rec.append(np.asarray(logits, np.float32))
        return logits, cache
    run.clear_cache = getattr(fn, "clear_cache", None)
    return run


def reference_run(jeng, prompts):
    """The reference engine's greedy streams and every step function's
    logits, in call order."""
    rec = []
    jeng._decode = _recording(jeng._decode, rec)
    for name in ("_chunk_paged_fn", "_chunk_fn", "_prefill_fn"):
        def built(*args, orig=getattr(jeng, name)):
            return _recording(orig(*args), rec)
        setattr(jeng, name, built)
    return serve(jeng, prompts), rec


def forced_run(teng, prompts, want):
    """The port's engine on the reference's trajectory: each step
    function's logits are recorded and the reference's logits of the same
    call are handed on, so the sampler takes the reference's tokens."""
    got, it = [], iter(want)

    def forcing(fn):
        def run(*args, **kw):
            logits, cache = fn(*args, **kw)
            got.append(logits.float().numpy())
            return torch.tensor(next(it)), cache
        return run
    for name in ("_decode", "_chunk_paged", "_chunk_first", "_chunk_cont",
                 "_prefill_scan"):
        setattr(teng, name, forcing(getattr(teng, name)))
    return serve(teng, prompts), got


def hold_on_trajectory(got, want, tol_rel):
    """Logits within ``tol_rel`` of each call's largest magnitude; greedy
    tokens equal wherever the reference's top-2 gap exceeds that. Returns
    (rows whose tokens were compared, rows in all)."""
    assert len(got) == len(want)
    compared = rows = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
        tol = tol_rel * float(np.abs(w).max())
        diff = float(np.abs(g - w).max())
        assert diff <= tol, f"logits {diff} apart, tolerance {tol}"
        top2 = np.sort(w, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > tol
        assert (g.argmax(-1)[clear] == w.argmax(-1)[clear]).all()
        compared += int(clear.sum())
        rows += len(w)
    return compared, rows


@pytest.mark.parametrize(
    "arch,name,fields,cache_dtype",
    [c for c, i in zip(ENGINE_CASES, ENGINE_IDS) if i in TRAJECTORY_CASES],
    ids=TRAJECTORY_CASES)
def test_bf16_logits_on_reference_trajectory(setups, arch, name, fields,
                                             cache_dtype):
    """Against ``repro``'s engine as it runs by default, on its own
    trajectory: logits within the stated tolerance at every step, the same
    greedy token wherever the reference's top-2 gap exceeds it (most
    rows)."""
    setup = setups(arch)
    want_streams, want = reference_run(
        reference_engine(setup, fields, cache_dtype), setup[2])
    got_streams, got = forced_run(
        port_engine(arch, setup, fields, cache_dtype), setup[2], want)
    assert got_streams == want_streams
    tol = RWKV_LOGIT_TOL if arch == "rwkv6-7b" else LOGIT_TOL
    compared, rows = hold_on_trajectory(got, want, tol)
    assert compared >= rows // 2


# ------------------------------------------------ cache leaves, freed slots
# (kv_backend, page_size, arch) -> the cache's K/V leaves
CACHE_CASES = [(None, 16, "qwen2.5-32b"), ("paged_int8", 16, "qwen2.5-32b"),
               (None, None, "qwen2.5-32b"), (None, 16, "qwen2.5-32b-mla"),
               (None, None, "hymba-1.5b"), (None, None, "rwkv6-7b")]


@pytest.fixture(scope="module")
def reduced_models():
    built = {}

    def get(arch):
        if arch not in built:
            model = treg.get_model(treg.reduced_config(
                tconfigs.get_config(arch)))
            built[arch] = (model, model.init(
                torch.Generator().manual_seed(0), "cpu"))
        return built[arch]
    return get


@pytest.mark.parametrize("cache_dtype", [None, torch.float32],
                         ids=["None", "fp32"])
@pytest.mark.parametrize("backend,page_size,arch", CACHE_CASES, ids=str)
def test_engine_cache_leaves_in_cache_dtype(reduced_models, backend,
                                            page_size, arch, cache_dtype):
    """``cache_dtype`` (None: the compute dtype, as ``repro``'s
    ``cache_dtype or compute_dtype``) is the dtype of every K/V pool or row
    leaf; int8 pages stay int8 with f32 scales, recurrent states f32."""
    model, params = reduced_models(arch)
    eng = TEngine(model, params, batch_slots=2, s_max=32, device="cpu",
                  page_size=page_size, kv_backend=backend,
                  compute_dtype=BF16, cache_dtype=cache_dtype)
    want = cache_dtype or BF16
    assert eng.compute_dtype == BF16 and eng.cache_dtype == want
    for key, leaf in eng.cache.items():
        if key in ("k", "v"):
            assert leaf.dtype == (torch.int8 if backend == "paged_int8"
                                  else want), key
        elif key.endswith("_scale") or key in ("S", "x_tm", "x_cm", "h",
                                                "conv"):
            assert leaf.dtype == torch.float32, key


def test_engine_signature_matches_reference():
    """``cache_dtype`` sits beside ``compute_dtype`` with ``repro``'s
    default (None), and ``ServeConfig`` passes none, as ``repro``'s."""
    tsig = inspect.signature(TEngine.__init__).parameters
    jsig = inspect.signature(JEngine.__init__).parameters
    assert tsig["cache_dtype"].default is jsig["cache_dtype"].default is None
    assert "cache_dtype" not in TConfig().engine_kwargs()
    assert "cache_dtype" not in JConfig().engine_kwargs()


FREED_CASES = [(None, torch.float32), (None, None), ("paged_int8", None),
               ("paged_latent", None)]


@pytest.mark.parametrize("backend,cache_dtype", FREED_CASES,
                         ids=["fp32-pages", "bf16-pages", "int8-pages",
                              "latent-pages"])
def test_all_freed_bf16_decode_is_finite(reduced_models, backend,
                                         cache_dtype):
    """``tests/test_serve.py:512-530`` in the port: with every slot freed
    (positions parked at INACTIVE_POS, block tables all -1) a bf16 decode
    tick gives finite logits, on fp32, bf16, int8 and latent pages."""
    arch = "qwen2.5-32b-mla" if backend == "paged_latent" else "qwen2.5-32b"
    model, params = reduced_models(arch)
    eng = TEngine(model, params, batch_slots=2, s_max=32, page_size=8,
                  kv_backend=backend, compute_dtype=BF16,
                  cache_dtype=cache_dtype, prefix_cache=False, device="cpu")
    req = eng.submit(np.arange(5) + 3, 2)
    eng.run()
    assert req.done and all(r is None for r in eng.slot_req)
    logits, eng.cache = eng._decode(
        eng.params, eng.cache,
        {"token": torch.from_numpy(eng.cur_token), **eng._prefill_extras(2)})
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------- step builders
@pytest.mark.parametrize("name", ["make_prefill", "make_prefill_chunk",
                                  "make_prefill_chunk_paged",
                                  "make_decode_step"])
def test_step_builder_dtype_defaults_match_reference(name):
    """The serving step builders default to ``repro``'s dtypes: bf16
    compute and, where they take one, an fp32 cache."""
    to_torch = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                jnp.dtype(jnp.float32): torch.float32}
    jsig = inspect.signature(getattr(jsteps, name)).parameters
    tsig = inspect.signature(getattr(tsteps, name)).parameters
    keys = [k for k in ("compute_dtype", "cache_dtype") if k in jsig]
    assert keys and [k for k in keys if k in tsig] == keys
    for key in keys:
        assert tsig[key].default == to_torch[jnp.dtype(jsig[key].default)]
    assert tsig["compute_dtype"].default == torch.bfloat16


if __name__ == "__main__":
    print(json.dumps(reference_streams()))
