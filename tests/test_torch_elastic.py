"""Elastic restore, the compressed gradient all-reduce and the GPipe
pipeline of the port (``runtime.elastic``, ``checkpoint.manager``,
``optim.grad_compress``, ``sharding.pipeline``) against ``repro``'s and
the contract of ``tests/test_distributed.py``:

* reduced minicpm-2b trained one step on a (2, 2) mesh and saved, then
  restored on (2, 2), (4, 1) and (1, 4) (``elastic_restore``): one more
  step on each gives losses within 1e-4 of each other; the checkpoint
  saved on the mesh restores mesh-free and in ``repro`` bit for bit, and
  each rank's blocks are those of the saved arrays; ``choose_mesh_shape``
  equals ``repro``'s for every n in 1-64, model_parallel in {1, 2, 4, 8,
  16}, with and without the pod axis;
* the compressed all-reduce over 4 data ranks: the mean within 0.04, the
  residual at most 0.51 of a quantization step, the mean of 8 steps with
  error feedback within rtol 0.02 / atol 0.002, and every output bit-equal
  to a numpy rendering of ``compressed_psum_tree``'s formula;
  ``quantize_int8`` bit-equal to ``repro``'s;
* a 4-stage GPipe with 8 microbatches within 2e-5 of the sequential
  stages; ``bubble_fraction`` equal to ``repro``'s.

The ranks are one spawn of this file run as a script (4 gloo ranks, torch
only, one thread each, a file store, a timeout); each writes
rank<R>.json and rank<R>.npz."""
import datetime
import json
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 180
ARCH = "minicpm-2b"
BATCH = (8, 16)
MESHES = ((2, 2), (4, 1), (1, 4))
N_MICRO, STAGE_B, STAGE_D = 8, 2, 16


def _grads_global():
    """The 4 data ranks' gradients (4, 64, 32)."""
    return np.random.default_rng(0).standard_normal((WORLD, 64, 32)).astype(
        np.float32)


def _stage_inputs():
    rng = np.random.default_rng(1)
    ws = (rng.standard_normal((WORLD, STAGE_D, STAGE_D))
          / np.sqrt(STAGE_D)).astype(np.float32)
    x = rng.standard_normal((N_MICRO, STAGE_B, STAGE_D)).astype(np.float32)
    return ws, x


# ------------------------------------------------------------- the ranks
def _elastic(out_dir):
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import elastic
    from repro_torch.sharding import specs
    model = get_model(reduced_config(configs.get_config(ARCH)))
    opt = AdamW(learning_rate=1e-3)
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size, BATCH)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    step = steps.make_train_step(model, opt, compute_dtype=torch.float32,
                                 remat=False)
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), async_save=False)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    with specs.use_mesh(mesh):
        full = steps.init_train_state(model, opt,
                                      torch.Generator().manual_seed(0), "cpu")
        state = steps.place(full, steps.state_shardings(model, full))
    state, _ = step(state, batch)
    mgr.save(1, state)
    saved = _flatten(mgr.restore()[0])

    def blocks_equal(tree):
        return all(torch.equal(v.to_local(), specs.local_block(
            torch.from_numpy(saved[k]), specs.sharding_of(v)))
            for k, v in _flatten(tree).items())
    losses, restored_equal = {}, {}
    for shape in MESHES:
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
        restored, meta = elastic.elastic_restore(mgr, model, opt, mesh=mesh)
        restored_equal[str(shape)] = blocks_equal(restored)
        _, m = step(restored, batch)
        losses[str(shape)] = float(m["loss"])
    return {"losses": losses, "blocks_equal": blocks_equal(state),
            "restored_equal": restored_equal,
            "meta_step": meta["step"],
            "remesh": list(elastic.remesh(model_parallel=2,
                                          device_type="cpu").shape)}


def _compressed(rank, arrays):
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim.grad_compress import (init_error,
                                                 make_compressed_allreduce)
    mesh = mesh_mod.make_mesh((WORLD,), ("data",), "cpu")
    grads = {"w": torch.from_numpy(_grads_global()[rank])}
    ar = make_compressed_allreduce(mesh, None, dp_axes=("data",))
    mean, err = ar(grads, init_error(grads))
    arrays["mean"], arrays["err"] = mean["w"].numpy(), err["w"].numpy()
    err = init_error(grads)
    for i in range(8):
        mean, err = ar(grads, err)
        arrays[f"ef{i}"] = mean["w"].numpy()


def _pipeline(arrays):
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import specs
    from repro_torch.sharding.pipeline import make_pipeline
    mesh = mesh_mod.make_mesh((WORLD,), ("pod",), "cpu")
    ws, x = _stage_inputs()
    with specs.use_mesh(mesh):
        spec = {"w": specs.sharding_for(ws.shape, ("stage", None, None))}
    pipe = make_pipeline(mesh, lambda p, h: torch.tanh(h @ p["w"]), spec,
                         stage_axis="pod", n_micro=N_MICRO)
    arrays["pipeline"] = pipe({"w": torch.from_numpy(ws)},
                              torch.from_numpy(x)).numpy()


def _rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    arrays = {}
    out = {"elastic": _elastic(out_dir)}
    _compressed(rank, arrays)
    _pipeline(arrays)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from test_torch_sharding import start_ranks, wait_ranks
    out_dir = tmp_path_factory.mktemp("elastic")
    procs = start_ranks(WORLD, out_dir, __file__)
    done = []

    def get():
        if not done:
            ranks = wait_ranks(procs, out_dir, timeout=TIMEOUT)
            arrays = [dict(np.load(out_dir / f"rank{r}.npz"))
                      for r in range(WORLD)]
            done.append((ranks, arrays, out_dir))
        return done[0]
    yield get
    for p in procs:
        if p.poll() is None:
            p.kill()


def test_elastic_reshard_restore(spawned):
    ranks, _, _ = spawned()
    got = ranks[0]["elastic"]
    for r in ranks[1:]:
        assert r["elastic"]["losses"] == got["losses"]
    vals = list(got["losses"].values())
    assert len(vals) == len(MESHES) and all(np.isfinite(vals))
    assert max(vals) - min(vals) < 1e-4, got["losses"]
    assert got["meta_step"] == 1
    assert got["remesh"] == [2, 2]


def test_checkpoint_saved_on_a_mesh_restores_anywhere(spawned):
    """Mesh-free in the port and in ``repro``: the same arrays, bit for bit,
    and every rank's blocks on the saving mesh are those arrays' blocks."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    ranks, _, out_dir = spawned()
    assert all(r["elastic"]["blocks_equal"] for r in ranks)
    port, meta = CheckpointManager(out_dir / "ckpt").restore()
    ref, jmeta = JManager(out_dir / "ckpt").restore()
    assert meta["step"] == jmeta["step"] == 1
    a, b = _flatten(port), _flatten(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(b[k]).dtype == a[k].dtype
        assert np.asarray(b[k]).tobytes() == a[k].tobytes(), k


def test_restored_blocks_are_the_checkpoint_blocks(spawned):
    """On every mesh each rank restores exactly its block of each saved
    array (``elastic_restore``: ``state_shardings`` on that mesh)."""
    ranks, _, _ = spawned()
    for r in ranks:
        assert r["elastic"]["restored_equal"] == {
            str(shape): True for shape in MESHES}


@pytest.mark.parametrize("with_pod_axis", [False, True])
def test_choose_mesh_shape_equals_the_reference(with_pod_axis):
    from repro.runtime.elastic import choose_mesh_shape as jchoose
    from repro_torch.runtime.elastic import choose_mesh_shape
    for n in range(1, 65):
        for mp in (1, 2, 4, 8, 16):
            got = choose_mesh_shape(n, model_parallel=mp,
                                    with_pod_axis=with_pod_axis)
            assert got == jchoose(n, model_parallel=mp,
                                  with_pod_axis=with_pod_axis)
            assert int(np.prod(got[0])) == n
    assert np.prod(choose_mesh_shape(6, model_parallel=4)[0]) == 6


def _numpy_compressed(grads, errs):
    """``compressed_psum_tree``'s formula over the ranks' arrays, in
    float32 numpy: (the mean every rank gets, each rank's residual)."""
    g = [x + e for x, e in zip(grads, errs)]
    amax = np.float32(max(np.abs(x).max() for x in g))
    scale = np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in g]
    total = np.sum([x.astype(np.int32) for x in q], axis=0, dtype=np.int32)
    mean = total.astype(np.float32) * scale / np.float32(len(g))
    return mean, [x - qi.astype(np.float32) * scale for x, qi in zip(g, q)]


def test_compressed_allreduce(spawned):
    _, arrays, _ = spawned()
    g = _grads_global()
    want = g.mean(0)
    for a in arrays:
        np.testing.assert_allclose(a["mean"], want, rtol=0.04, atol=0.04)
    scale = np.abs(g).max(axis=(1, 2), keepdims=True) / 127.0
    assert max(np.abs(a["err"]).max() for a in arrays) <= \
        scale.max() * 0.51 + 1e-6
    total = sum(arrays[0][f"ef{i}"] for i in range(8))
    np.testing.assert_allclose(total / 8, want, rtol=0.02, atol=0.002)
    # bit for bit against the formula, the first call and the 8 EF steps
    mean, errs = _numpy_compressed(list(g), [np.zeros_like(x) for x in g])
    for r, a in enumerate(arrays):
        assert a["mean"].tobytes() == mean.tobytes()
        assert a["err"].tobytes() == errs[r].tobytes()
    errs = [np.zeros_like(x) for x in g]
    for i in range(8):
        mean, errs = _numpy_compressed(list(g), errs)
        for a in arrays:
            assert a[f"ef{i}"].tobytes() == mean.tobytes(), i


def test_quantize_int8_equals_the_reference():
    import jax.numpy as jnp
    from repro.optim.grad_compress import quantize_int8 as jquant
    from repro_torch.optim.grad_compress import quantize_int8
    rng = np.random.default_rng(3)
    cases = [rng.standard_normal((64, 32)).astype(np.float32),
             (np.arange(-300, 301) / 2.0).astype(np.float32),   # .5 ties
             np.zeros((5,), np.float32)]
    for x in cases:
        q, s = quantize_int8(torch.from_numpy(x))
        jq, js = jquant(jnp.asarray(x))
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        assert np.float32(s.item()) == np.float32(js)


def test_pipeline_parallel_matches_sequential(spawned):
    _, arrays, _ = spawned()
    ws, x = _stage_inputs()
    ref = torch.from_numpy(x)
    for s in range(WORLD):
        ref = torch.tanh(ref @ torch.from_numpy(ws[s]))
    for a in arrays:
        np.testing.assert_allclose(a["pipeline"], ref.numpy(), rtol=2e-5,
                                   atol=2e-5)
        assert a["pipeline"].tobytes() == arrays[0]["pipeline"].tobytes()


def test_bubble_fraction_equals_the_reference():
    from repro.sharding.pipeline import bubble_fraction as jbubble
    from repro_torch.sharding.pipeline import bubble_fraction
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9
    for p in range(1, 9):
        for m in range(1, 17):
            assert bubble_fraction(p, m) == jbubble(p, m)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
