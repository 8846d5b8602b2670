"""The port's checkpoint manager and fault runtime, mirroring
``tests/test_substrate.py``: round trip and retention, async and atomic
writes, kill-and-resume bit for bit through ``run_with_recovery``, the
straggler detector and the restart budget; and the format across the
packages: a checkpoint ``repro`` writes restores in the port and one the
port writes restores in ``repro``, every leaf equal (dtype, shape, bits),
with ``repro``'s flattened keys and a train state of the port's nesting
given back by ``restore(like=...)``."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jman  # noqa: E402
from repro.configs.resnet20_cifar import ResNetConfig as JResNet  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manager as tman  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault import (RestartPolicy,  # noqa: E402
                                       StragglerDetector, run_with_recovery)
from repro_torch.tree import tree_leaves  # noqa: E402


def _tree(step):
    return {"params": {"w": torch.full((4, 4), float(step)),
                       "b": torch.arange(3.0)},
            "opt": {"m": (torch.zeros(2), torch.ones(2)),
                    "count": torch.tensor(step, dtype=torch.int32)},
            "step": torch.tensor(step, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [2, 3]          # keep=2 retention
    tree, meta = mgr.restore(device="cpu")
    assert meta["step"] == 3
    assert float(tree["params"]["w"][0, 0]) == 3.0
    assert isinstance(tree["opt"]["m"], tuple)
    assert tree["step"].dtype == torch.int32 and tree["step"].dim() == 0
    tree2, meta2 = mgr.restore(step=2)
    assert meta2["step"] == 2 and isinstance(tree2["params"]["w"], np.ndarray)
    assert mgr.restore(step=None)[1]["step"] == 3
    assert CheckpointManager(tmp_path / "empty").restore() == (None, None)


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    tree = _tree(10)
    mgr.save(10, tree, metadata={"note": "x"})
    tree["params"]["w"].add_(1.0)     # the host copy was taken at save()
    mgr.wait()
    assert mgr.latest_step() == 10
    assert not list(pathlib.Path(tmp_path).glob(".tmp*"))
    back, meta = mgr.restore(device="cpu")
    assert float(back["params"]["w"][0, 0]) == 10.0 and meta["note"] == "x"


def test_checkpoint_write_error_surfaces_on_wait(tmp_path, monkeypatch):
    """A failed background write raises at the next ``wait`` (or save),
    and no partial checkpoint becomes visible; a leaf numpy cannot hold
    (bf16) is refused at ``save``."""
    mgr = CheckpointManager(tmp_path, async_save=True)

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(tman.np, "savez", fail)
    mgr.save(1, _tree(1))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    with pytest.raises(TypeError):
        mgr.save(2, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_checkpoint_kill_resume_bitwise(tmp_path):
    """Simulated failure: the run crashes mid-flight, restarts from the last
    checkpoint, and the recovered state stream is bitwise identical."""
    mgr = CheckpointManager(tmp_path, async_save=False)

    def fresh():
        return {"x": torch.zeros(()), "step": torch.tensor(0, dtype=torch.int32)}

    def reference_run(n):
        s = fresh()
        for i in range(n):
            s = {"x": s["x"] * 1.5 + i, "step": s["step"] + 1}
        return s

    holder = {"state": fresh(), "crashed": False}

    def step_fn(i):
        if i == 7 and not holder["crashed"]:
            holder["crashed"] = True
            raise RuntimeError("simulated chip failure")
        s = holder["state"]
        holder["state"] = {"x": s["x"] * 1.5 + i, "step": s["step"] + 1}

    def save_fn(i):
        mgr.save(i, holder["state"])

    def restore_fn():
        tree, meta = mgr.restore(device="cpu")
        if tree is None:
            holder["state"] = fresh()
            return 0
        holder["state"] = tree
        return meta["step"]

    stats = run_with_recovery(num_steps=12, step_fn=step_fn, save_fn=save_fn,
                              restore_fn=restore_fn, checkpoint_every=5,
                              sleep=lambda s: None)
    assert stats["failures"] == 1 and stats["restarts"] == 1
    ref = reference_run(12)
    assert torch.equal(holder["state"]["x"], ref["x"])
    assert int(holder["state"]["step"]) == 12


def test_straggler_detector():
    det = StragglerDetector(window=30, z_threshold=4.0, min_steps=10)
    jdet = jfault.StragglerDetector(window=30, z_threshold=4.0, min_steps=10)
    rng = np.random.default_rng(0)
    times = [0.100 + rng.normal(0, 0.002) for _ in range(20)]
    for t in times:
        assert det.record(t) == jdet.record(t)
    assert det.record(0.500) is True          # 5x median => flagged
    assert jdet.record(0.500) is True
    assert det.record(0.101) is False
    assert det.flagged == jdet.flagged == [21]


def test_restart_policy_budget():
    pol = RestartPolicy(max_restarts=2, backoff_s=0.1)
    assert pol.on_failure(ValueError()) == pytest.approx(0.1)
    assert pol.on_failure(ValueError()) == pytest.approx(0.2)
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        pol.on_failure(ValueError())


# ------------------------------------------------------ across the packages
def _reference_state(which):
    """A reference train state as numpy leaves: an LM's (reduced
    qwen2.5-32b, AdamW moments filled by one seeded step's worth of
    values) or ResNet20's (lists of stages of blocks: tuples on restore)."""
    if which == "lm":
        model = jreg.get_model(jreg.reduced_config(
            jconfigs.get_config("qwen2.5-32b")))
        state = jsteps.init_train_state(model, JAdamW(), jax.random.PRNGKey(0))
    else:
        params = jresnet.init(JResNet(num_blocks=(1, 1, 1), widths=(4, 8, 16)),
                              jax.random.PRNGKey(0))
        opt = JAdamW()
        state = {"params": params, "opt": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(3)
    for key in ("m", "v"):
        state["opt"][key] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(a.dtype),
            state["opt"][key])
    state["opt"]["count"] = np.asarray(7, np.int32)
    state["step"] = np.asarray(7, np.int32)
    return state


def _assert_same(a, b):
    la, lb = jax.tree.leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("which", ["lm", "resnet"])
def test_flattened_keys_equal_the_reference(which):
    state = _reference_state(which)
    want = jman._flatten(state)
    got = tman._flatten(bridge.params_from_numpy(state, "cpu"))
    assert list(got) == list(want)


@pytest.mark.parametrize("which", ["lm", "resnet"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, which):
    state = _reference_state(which)
    jman.CheckpointManager(tmp_path, async_save=False).save(7, state)
    like = bridge.params_from_numpy(state, "cpu")
    got, meta = CheckpointManager(tmp_path).restore(device="cpu", like=like)
    assert meta["step"] == 7
    _assert_same(state, got)
    assert type(got["params"].get("stages", [])) is type(
        like["params"].get("stages", []))
    assert got["opt"]["count"].dtype == torch.int32


@pytest.mark.parametrize("which", ["lm", "resnet"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, which):
    state = bridge.params_from_numpy(_reference_state(which), "cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, state)
    mgr.wait()
    got, meta = jman.CheckpointManager(tmp_path).restore()
    assert meta["step"] == 7
    _assert_same(got, state)
