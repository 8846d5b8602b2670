"""The port's AdamW and learning-rate schedules against ``repro``'s.

* Schedules (``cosine``, ``wsd``, ``constant``) at counts 0-400: equal
  to the reference run op by op (``cosine`` within 2 ulp: torch's fp32
  ``cos`` and XLA's round apart), and no further from the jitted
  reference than XLA's jitted values are from its own op-by-op ones.
* The leaf order of the global norm is ``jax.tree.leaves``'s (dict keys
  sorted), on a tree whose insertion order is not sorted.
* One AdamW update on bridged params (a reduced qwen2.5-32b) and seeded
  gradients, with clipping binding, with clipping off and with a schedule:
  updates, m, v, the count (int32, equal) and the norm, allclose at rtol
  1e-5 / atol 1e-7 (fp32 sums in another order; the bias corrections
  ``b ** count`` round as XLA's power to within an ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

COUNTS = np.arange(0, 401, dtype=np.int32)
SCHEDULES = {"cosine": ((3e-4, 10, 300), {}),
             "cosine_short": ((1e-2, 2, 6), {"min_ratio": 0.2}),
             "wsd": ((3e-4, 10, 230, 60), {}),
             "wsd_minicpm": ((3e-4, 10, 70, 20), {"min_ratio": 0.01}),
             "constant": ((3e-4,), {})}
TOL = dict(rtol=1e-5, atol=1e-7)


def _ulps(a, b):
    """Per-element distance in fp32 units in the last place."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_reference(name):
    """Against the reference run op by op: ``wsd`` and ``constant`` equal,
    ``cosine`` within 2 ulp (its fp32 ``cos`` and XLA's round apart).
    Against the jitted reference the train step runs: no further than
    XLA's own jitted values are from its op-by-op ones (up to 27 ulp for
    ``wsd``, whose fused decay rounds apart) plus those 2 ulp."""
    fn_name = name.split("_")[0]
    args, kw = SCHEDULES[name]
    jfn = getattr(jsched, fn_name)(*args, **kw)
    tfn = getattr(tsched, fn_name)(*args, **kw)
    eager = np.array([np.asarray(jfn(jnp.asarray(c, jnp.int32)))
                      for c in COUNTS])
    jitted = np.array([np.asarray(jax.jit(jfn)(jnp.asarray(c, jnp.int32)))
                       for c in COUNTS])
    got = np.array([tfn(torch.tensor(int(c), dtype=torch.int32)).numpy()
                    for c in COUNTS])
    assert got.dtype == eager.dtype == np.float32
    if fn_name == "cosine":
        assert _ulps(got, eager).max() <= 2
    else:
        np.testing.assert_array_equal(got, eager)
    assert (_ulps(got, jitted) <= _ulps(eager, jitted) + 2).all()


def test_tree_leaves_follow_jax_order():
    tree = {"z": {"b": np.ones(1), "a": np.zeros(2)}, "a": [np.ones(3),
            (np.ones(4), {"y": np.ones(5), "x": np.ones(6)})],
            "m": np.ones(7)}
    want = [leaf.size for leaf in jax.tree.leaves(tree)]
    assert [leaf.size for leaf in tree_leaves(tree)] == want
    assert tree_map(lambda a: a.size, tree)["a"][1][1]["x"] == 6


def _params_and_grads(seed=0, scale=1.0):
    cfg = jreg.reduced_config(jconfigs.get_config("qwen2.5-32b"))
    params = jax.tree.map(np.asarray,
                          jreg.get_model(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(
        lambda p: (scale * rng.standard_normal(p.shape)).astype(p.dtype),
        params)
    return params, grads


def _opts(case):
    kw = dict(learning_rate=1e-3)
    if case == "no_clip":
        kw["clip_norm"] = None
    if case == "schedule":
        kw["learning_rate"] = None
    if case == "decay":
        kw.update(weight_decay=0.5, b1=0.8, b2=0.99, eps=1e-6)
    jkw, tkw = dict(kw), dict(kw)
    if case == "schedule":
        jkw["learning_rate"] = jsched.cosine(3e-3, 2, 10)
        tkw["learning_rate"] = tsched.cosine(3e-3, 2, 10)
    return jadamw.AdamW(**jkw), tadamw.AdamW(**tkw)


@pytest.mark.parametrize("case", ["clip", "no_clip", "schedule", "decay"])
def test_adamw_updates_match_reference(case):
    """Three updates on bridged params: the first with the clip binding
    (the seeded gradients' norm is far above 1), then two more from the
    moments it left."""
    jopt, topt = _opts(case)
    params, _ = _params_and_grads()
    jstate, tstate = jopt.init(params), topt.init(
        bridge.params_from_numpy(params, "cpu"))
    assert tstate["count"].dtype == torch.int32
    jp, tp = params, bridge.params_from_numpy(params, "cpu")
    update = jax.jit(jopt.update)
    for k in range(3):
        _, grads = _params_and_grads(seed=k, scale=0.3 if k else 1.0)
        ju, jstate, jgn = update(grads, jstate, jp)
        tu, tstate, tgn = topt.update(bridge.params_from_numpy(grads, "cpu"),
                                      tstate, tp)
        np.testing.assert_allclose(tgn.numpy(), np.asarray(jgn), rtol=1e-6)
        assert int(tstate["count"]) == int(jstate["count"]) == k + 1
        assert tstate["count"].dtype == torch.int32
        for name, want, got in (("updates", ju, tu), ("m", jstate["m"],
                                                      tstate["m"]),
                                ("v", jstate["v"], tstate["v"])):
            for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                           err_msg=name)
        jp = jadamw.apply_updates(jp, ju)
        tp = tadamw.apply_updates(tp, tu)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_clip_scale_and_global_norm():
    params, grads = _params_and_grads(scale=5.0)
    tg = bridge.params_from_numpy(grads, "cpu")
    np.testing.assert_allclose(tadamw.global_norm(tg).numpy(),
                               np.asarray(jadamw.global_norm(grads)),
                               rtol=1e-6)
    opt = tadamw.AdamW(learning_rate=0.0, weight_decay=0.0, clip_norm=1.0)
    tp = bridge.params_from_numpy(params, "cpu")
    _, st, gn = opt.update(tg, opt.init(tp), tp)
    # m = (1 - b1) * clipped g, so the clipped norm is |m| / (1 - b1)
    np.testing.assert_allclose(
        tadamw.global_norm(st["m"]).numpy() / (1 - opt.b1), 1.0, rtol=1e-5)
    assert float(gn) > 1.0
