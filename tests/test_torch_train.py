"""The port's training half against ``repro``'s, on reduced configs:

* ``cross_entropy`` equals ``chunked_cross_entropy`` and the reference's,
  gradients included (untied and tied heads, a ragged last chunk, a
  padded vocab masked at ``mask_value``), at rtol 1e-5 (values) and 1e-4
  / atol 1e-6 (gradients), as ``tests/test_steps.py`` holds the reference;
* ``TokenStream`` batches byte-equal to the reference's, through the
  prefetcher too; a mesh that is not a ``DeviceMesh`` raises;
* from the reference's init, carried across, 3 fp32 train steps
  (``make_optimizer`` of both trainers: minicpm-2b with ``wsd``, the rest
  ``cosine``) for qwen2.5-32b, minicpm-2b, moonshot-v1-16b-a3b (the MoE's
  aux and z terms in the loss), rwkv6-7b, hymba-1.5b (plain scans),
  llama-3.2-vision-11b (seeded cross gates) and whisper-large-v3: losses
  and metrics at rtol 1e-5 (grad norm 1e-4), params within 1e-4 (a third
  of one step's lr 3e-4: AdamW's normalised step turns a last-bit
  gradient difference where |g| is near zero into an update difference
  of the order of the lr);
* ``microbatches=4`` against 1 and against the reference's 4; ``remat``
  on against off, bit for bit (the recomputed forward is the same eager
  arithmetic); one bf16 step finite and within 2e-2 of the reference's
  bf16 loss (bf16 matmuls summed in another order);
* ResNet20's one-step loss and gradients against the reference's ``lax``
  route (the port through ``F.conv2d`` and through im2col + ``ops.matmul``)
  at rtol 1e-4 of each leaf's largest magnitude, and at a tiny width the
  port's ``ops.matmul`` (plain on the CPU) against the reference's im2col +
  Pallas ``ops.matmul`` in interpret mode, its custom VJP included;
* the trainer end to end with resume (a run resumed from an earlier
  checkpoint ends bit-equal to the uninterrupted one), its refusals, and
  the port's three new examples in subprocesses with ``--device cpu``.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.resnet20_cifar import ResNetConfig as JResNet  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.resnet20_cifar import ResNetConfig as TResNet  # noqa: E402
from repro_torch.data import synthetic as tsynth  # noqa: E402
from repro_torch.examples import train_resnet20_cifar as texample  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAM_ATOL = 1e-4
LOSS_RTOL = 1e-5
FAMILIES = {"qwen2.5-32b": "cosine", "minicpm-2b": "wsd",
            "moonshot-v1-16b-a3b": "cosine", "rwkv6-7b": "cosine",
            "hymba-1.5b": "cosine", "llama-3.2-vision-11b": "cosine",
            "whisper-large-v3": "cosine"}


# ------------------------------------------------------------------ loss
def _ce_case(seed, B, S, D, V, pad):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (0.1 * rng.standard_normal((D, V + pad))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    return feats, w, labels


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("chunk,pad", [(16, 0), (24, 14), (64, 3), (7, 0)])
def test_chunked_cross_entropy_matches(tied, chunk, pad):
    """Full CE, chunked CE and the reference's chunked CE agree in value
    and in the gradients of the features and the head (a ragged last
    chunk where ``chunk`` does not divide S; ``pad`` padded vocab
    columns, masked)."""
    B, S, D, V = 2, 64, 16, 50
    feats, w, labels = _ce_case(0, B, S, D, V, pad)
    head = w.T.copy() if tied else w

    def port(f, h, full):
        if full:
            logits = (f @ h.T if tied else f @ h).float()
            keep = torch.arange(V + pad) < V
            logits = torch.where(keep, logits, -1e30)
            return tsteps.cross_entropy(logits, torch.from_numpy(labels))
        return tsteps.chunked_cross_entropy(f, h, torch.from_numpy(labels), V,
                                            tied, chunk=chunk)

    want, jgrads = jax.value_and_grad(
        lambda f, h: jsteps.chunked_cross_entropy(f, h, labels, V, tied,
                                                  chunk=chunk),
        argnums=(0, 1))(feats, head)
    for full in (True, False):
        f = torch.from_numpy(feats).requires_grad_()
        h = torch.from_numpy(head).requires_grad_()
        got = port(f, h, full)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
        for g, jg in ((f.grad, jgrads[0]), (h.grad, jgrads[1])):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                       atol=1e-6)


def test_head_ce_chunk_masks_padded_vocab_at_mask_value():
    feats, w, labels = _ce_case(1, 1, 8, 4, 10, 6)
    t = tsteps.head_ce_chunk(torch.from_numpy(feats), torch.from_numpy(w),
                             torch.from_numpy(labels), 10, False)
    j = jsteps.head_ce_chunk(feats, w, labels, 10, False)
    np.testing.assert_allclose(t.item(), float(j), rtol=LOSS_RTOL)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 16, 0),
                                                  (122753, 2, 64, 7)])
def test_token_stream_byte_equal(vocab, batch, seq, seed):
    js = jsynth.TokenStream(vocab, batch, seq, seed)
    ts = tsynth.TokenStream(vocab, batch, seq, seed)
    np.testing.assert_array_equal(ts.next_tokens, js.next_tokens)
    for step in (0, 1, 17, 1000):
        a, b = js.batch_at(step), ts.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    it = iter(ts)
    assert next(it)["tokens"].tobytes() == js.batch_at(0)["tokens"].tobytes()


def test_lm_pipeline_prefetches_onto_the_device():
    pipe = tsynth.make_lm_pipeline(512, 4, 16, seed=3, start_step=5,
                                   device="cpu")
    js = jsynth.TokenStream(512, 4, 16, 3)
    for step in (5, 6, 7):
        b = next(pipe)
        assert isinstance(b["tokens"], torch.Tensor)
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      js.batch_at(step)["tokens"])
    pipe.close()
    with pytest.raises(TypeError, match="must be a DeviceMesh"):
        tsynth.make_lm_pipeline(512, 4, 16, mesh=object())


# ------------------------------------------------------------------ steps
def _build(arch, schedule, steps=10, microbatches=1, remat=False,
           dtype="float32", seed_gates=True):
    """The reference's train state (init + optimizer of its trainer),
    the same state carried to the port, and both step functions."""
    jcfg = jreg.reduced_config(jconfigs.get_config(arch))
    tcfg = treg.reduced_config(tconfigs.get_config(arch))
    jm, tm = jreg.get_model(jcfg), treg.get_model(tcfg)
    jtc = jtrain.TrainConfig(arch=arch, steps=steps, warmup=1,
                             schedule=schedule)
    ttc = ttrain.TrainConfig(arch=arch, steps=steps, warmup=1,
                             schedule=schedule, device="cpu")
    jopt, topt = jtrain.make_optimizer(jtc), ttrain.make_optimizer(ttc)
    state = jax.tree.map(np.asarray, jsteps.init_train_state(
        jm, jopt, jax.random.PRNGKey(0)))
    if seed_gates and jcfg.cross_attn_every:
        gate = state["params"]["super"]["cross"]["gate"]
        state["params"]["super"]["cross"]["gate"] = np.random.default_rng(
            7).normal(0, 1, gate.shape).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jstep = jax.jit(jsteps.make_train_step(jm, jopt, compute_dtype=jdt,
                                           remat=remat,
                                           microbatches=microbatches))
    tstep = tsteps.make_train_step(tm, topt, compute_dtype=tdt, remat=remat,
                                   microbatches=microbatches)
    return (jm, tm, jax.tree.map(jnp.asarray, state),
            bridge.params_from_numpy(state, "cpu"), jstep, tstep)


def _batches(jm, tm, n, B=4, S=16):
    """n (reference batch, port batch) pairs from one TokenStream, with
    each trainer's frontend stubs (which must agree)."""
    stream = jsynth.TokenStream(jm.cfg.vocab_size, B, S, 0)
    out = []
    for i in range(n):
        raw = stream.batch_at(i)
        jb = {k: jnp.asarray(v) for k, v in raw.items()}
        jb.update(jtrain.extras_for(jm, raw))
        tb = {k: torch.from_numpy(v.copy()) for k, v in raw.items()}
        tb.update(ttrain.extras_for(tm, raw))
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        out.append((jb, tb))
    return out


def _assert_params(jstate, tstate, atol=PARAM_ATOL):
    jl = jax.tree_util.tree_leaves_with_path(jstate["params"])
    tl = tree_leaves(tstate["params"])
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_three_fp32_steps_match_reference(arch):
    jm, tm, jstate, tstate, jstep, tstep = _build(arch, FAMILIES[arch])
    for jb, tb in _batches(jm, tm, 3):
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(
                tmet[k].item(), float(jmet[k]),
                rtol=1e-4 if k == "grad_norm" else LOSS_RTOL, atol=1e-7,
                err_msg=k)
        assert int(tstate["step"]) == int(jstate["step"])
        assert tstate["opt"]["count"].dtype == torch.int32
    if tm.cfg.moe:
        assert tmet["moe_aux"].item() > 0 and tmet["moe_z"].item() > 0
    _assert_params(jstate, tstate)


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-32b"])
def test_microbatches_four_against_one_and_reference(arch):
    jm, tm, jstate, tstate, jstep4, tstep4 = _build(arch, "cosine",
                                                    microbatches=4)
    tstep1 = _build(arch, "cosine")[5]
    (jb, tb), = _batches(jm, tm, 1, B=8)
    j4, jmet = jstep4(jstate, jb)
    t4, t4met = tstep4(tstate, tb)
    t1, t1met = tstep1(tstate, tb)
    np.testing.assert_allclose(t4met["loss"].item(), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(t4met["loss"].item(), t1met["loss"].item(),
                               rtol=LOSS_RTOL)
    _assert_params(j4, t4)
    for a, b in zip(tree_leaves(t1["params"]), tree_leaves(t4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_remat_on_equals_off(arch):
    jm, tm, _, tstate, _, off = _build(arch, FAMILIES[arch])
    on = _build(arch, FAMILIES[arch], remat=True)[5]
    outs = []
    for step in (off, on):
        s = tstate
        for _, tb in _batches(jm, tm, 2):
            s, met = step(s, tb)
        outs.append((s, met))
    (a, ma), (b, mb) = outs
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_remat_save_outs_checkpoints_like_true():
    jm, tm, _, tstate, _, on = _build("qwen2.5-32b", "cosine", remat=True)
    outs = _build("qwen2.5-32b", "cosine", remat="save_outs")[5]
    (_, tb), = _batches(jm, tm, 1)
    a, b = on(tstate, tb), outs(tstate, tb)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_bf16_step_is_finite_and_near_reference():
    jm, tm, jstate, tstate, jstep, tstep = _build("qwen2.5-32b", "cosine",
                                                  dtype="bfloat16")
    (jb, tb), = _batches(jm, tm, 1)
    _, jmet = jstep(jstate, jb)
    t, tmet = tstep(tstate, tb)
    assert all(torch.isfinite(leaf).all() for leaf in tree_leaves(t))
    assert abs(tmet["loss"].item() - float(jmet["loss"])) < 2e-2
    assert t["params"]["layers"]["attn"]["wq"].dtype == torch.float32


def test_unused_leaves_get_zero_gradients():
    def loss_fn(params, batch):
        return (params["a"] * batch["x"]).sum(), {}
    (_, _), grads = tsteps.value_and_grad(loss_fn)(
        {"a": torch.ones(3), "b": torch.ones(2)}, {"x": torch.arange(3.0)})
    assert torch.equal(grads["a"], torch.arange(3.0))
    assert torch.equal(grads["b"], torch.zeros(2))


# ------------------------------------------------------------------ resnet
def _resnet_params(cfg, seed):
    """The reference's init, BN affine terms and running stats seeded away
    from the identity, as numpy leaves."""
    params = jax.tree.map(np.asarray, jresnet.init(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    for cb in [params["stem"]] + [blk[k] for blocks in params["stages"]
                                  for blk in blocks for k in blk]:
        c = cb["w"].shape[-1]
        cb["bn"] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    params["head"]["w"] = (0.1 * rng.standard_normal(
        params["head"]["w"].shape)).astype(np.float32)
    return params


def _reference_grads(cfg, params, x, y, **route):
    def loss(p):
        logits = jresnet.forward(p, cfg, x, **route)
        onehot = jax.nn.one_hot(y, cfg.num_classes)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))
    return jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))


def _assert_grads(jgrads, tgrads, tol=1e-4):
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(tgrads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=tol,
                                   atol=tol * max(np.abs(a).max(), 1e-12))


@pytest.mark.parametrize("route", ["lax", "im2col"])
def test_resnet20_step_matches_reference_lax(route):
    """Full ResNet20 widths (16 / 32 / 64), batch 4: the loss (the
    example's) and every gradient leaf against the reference's ``lax``
    route."""
    jcfg, tcfg = JResNet(), TResNet()
    params = _resnet_params(jcfg, 4)
    x, y = jsynth.synthetic_cifar(4, seed=1)
    want, jgrads = _reference_grads(jcfg, params, x, y)
    (got, _), tgrads = tsteps.value_and_grad(texample.loss_fn(
        tcfg, texample.conv_route(route)))(
        bridge.params_from_numpy(params, "cpu"),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _assert_grads(jgrads, tgrads)


def test_resnet_tiny_im2col_through_ops_matmul_matches_interpret_mode():
    """Widths 2 / 4 / 8, one block a stage, batch 2: the port's im2col +
    ``ops.matmul`` (its autograd function, the plain version on the CPU)
    against the reference's im2col + Pallas ``ops.matmul`` (interpret
    mode, its custom VJP sending dX and dW through the kernel)."""
    kw = dict(num_blocks=(1, 1, 1), widths=(2, 4, 8))
    jcfg, tcfg = JResNet(**kw), TResNet(**kw)
    params = _resnet_params(jcfg, 5)
    x, y = jsynth.synthetic_cifar(2, seed=2)
    want, jgrads = _reference_grads(jcfg, params, x, y, impl="im2col",
                                    matmul_fn=jops.matmul)
    route = dict(impl="im2col", matmul_fn=tops.matmul)
    (got, _), tgrads = tsteps.value_and_grad(texample.loss_fn(tcfg, route))(
        bridge.params_from_numpy(params, "cpu"),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _assert_grads(jgrads, tgrads)


# ------------------------------------------------------------------ trainer
def _tc(tmp_path, **kw):
    base = dict(arch="codeqwen1.5-7b", reduced=True, steps=20, batch=4,
                seq_len=32, ckpt_dir=str(tmp_path / "run"),
                checkpoint_every=10, log_every=5, device="cpu")
    base.update(kw)
    return ttrain.TrainConfig(**base)


def test_trainer_end_to_end(tmp_path):
    """As ``tests/test_system.py``: 20 steps, then a second invocation
    resumes from the step-20 checkpoint and extends to 25."""
    stats = ttrain.train(_tc(tmp_path))
    assert np.isfinite(stats["final_loss"])
    stats2 = ttrain.train(_tc(tmp_path, steps=25))
    assert np.isfinite(stats2["final_loss"])
    assert CheckpointManager(tmp_path / "run").latest_step() == 25


def test_trainer_resume_is_bit_exact(tmp_path):
    """A run resumed from its step-10 checkpoint ends with the state of
    the uninterrupted run, bit for bit."""
    ttrain.train(_tc(tmp_path, steps=25))
    mgr = CheckpointManager(tmp_path / "run")
    full, _ = mgr.restore(step=25)
    for step in (20, 25):
        shutil.rmtree(tmp_path / "run" / f"step_{step:010d}")
    assert mgr.latest_step() == 10
    ttrain.train(_tc(tmp_path, steps=25))
    again, meta = mgr.restore(step=25)
    assert meta["step"] == 25
    for a, b in zip(jax.tree.leaves(full), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_trainer_wsd_schedule():
    tc = ttrain.TrainConfig(arch="minicpm-2b", reduced=True, steps=12,
                            batch=2, seq_len=16, schedule="wsd", log_every=4,
                            device="cpu")
    assert np.isfinite(ttrain.train(tc)["final_loss"])


def test_trainer_refusals(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs a process group"):
        ttrain.train(ttrain.TrainConfig(mesh_shape=(2,), device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(ttrain.TrainConfig(device="cuda"))


# ------------------------------------------------------------------ examples
@pytest.mark.parametrize("module,args,expect", [
    ("train_resnet20_cifar", ["--steps", "2", "--width", "2"],
     "ZCU104 ladder: the calibrated performance model's predictions"),
    ("train_resnet20_cifar", ["--steps", "2", "--width", "2",
                              "--conv-impl", "lax"], "measured inference on CPU"),
    ("quickstart", [], "quickstart OK"),
    ("quantize_ptq", ["--arch", "minicpm-2b"], "fixed16: top-1 agreement"),
])
def test_examples_run_on_the_cpu(module, args, expect):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{module}", *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout
