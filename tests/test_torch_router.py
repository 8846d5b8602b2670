"""The port's prefix-affinity replica router against ``repro``'s
(``tests/test_router.py``), over replicas of the reduced qwen2.5-32b that
hold the reference's weights bridged through numpy.

Header keys are byte-equal, and every pick, spill, shed and routed count
equals the reference router's on the same script over the same tier:
rendezvous affinity, the least-loaded answer for headerless prompts, the
round-robin mode, back-pressure spill and shed at the door, and the
uniform-page-size check's message. Routed streams complete on exactly one
replica each with the reference's greedy tokens, and ``replay`` returns
the pooled ``ReplaySummary`` with the per-replica breakdown and the
router's counters."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.router import ReplicaRouter as JRouter  # noqa: E402
from repro.serve.workload import ArrivalEvent as JEvent  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import SLO  # noqa: E402
from repro_torch.serve import ServeConfig as TConfig  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.router import ReplicaRouter as TRouter  # noqa: E402
from repro_torch.serve.workload import ArrivalEvent as TEvent  # noqa: E402

PS = 16


@pytest.fixture(scope="module")
def weights():
    """The reference's reduced qwen2.5-32b model and params, and the port's
    model over the same params."""
    ref = JEngine.build("qwen2.5-32b", config=JConfig(s_max=64))
    tmodel = treg.get_model(treg.reduced_config(
        tconfigs.get_config("qwen2.5-32b")))
    tparams = bridge.params_from_numpy(
        jax.tree.map(np.asarray, ref.params), "cpu")
    return ref.model, ref.params, tmodel, tparams


def _tiers(weights, n=2, page_sizes=None, **kw):
    model, params, tmodel, tparams = weights
    page_sizes = page_sizes or [PS] * n
    kw = dict(dict(batch_slots=2, s_max=64), **kw)
    jt = [JEngine(model, params, page_size=p, **kw) for p in page_sizes]
    tt = [TEngine(tmodel, tparams, device="cpu", page_size=p, **kw)
          for p in page_sizes]
    return jt, tt


def _prompt(header_token: int, tail_len: int, tail_token: int = 7):
    header = np.full(2 * PS, header_token, np.int32)    # 2 full pages
    return np.concatenate([header, np.full(tail_len, tail_token, np.int32)])


def _prompts():
    rng = np.random.default_rng(3)
    out = [_prompt(g, t) for g in range(5) for t in (1, 9)]
    out += [rng.integers(0, 512, n).astype(np.int32)
            for n in (3, 15, 16, 17, 40, 64)]
    out.append(np.concatenate([_prompt(3, 0), np.full(PS, 9, np.int32)]))
    return out


def test_header_keys_are_byte_equal(weights):
    jt, tt = _tiers(weights, 1)
    for pages in (1, 2, 4):
        jr = JRouter(jt, header_pages=pages)
        tr = TRouter(tt, header_pages=pages)
        for p in _prompts():
            assert tr.header_key(p) == jr.header_key(p)
    assert tr.header_key(np.arange(1, PS, dtype=np.int32)) is None


@pytest.mark.parametrize("n", [2, 3, 4])
def test_picks_equal_reference(weights, n):
    jt, tt = _tiers(weights, n)
    jr, tr = JRouter(jt), TRouter(tt)
    assert [tr.pick(p) for p in _prompts()] == \
        [jr.pick(p) for p in _prompts()]
    picks = {tr.pick(_prompt(3, t)) for t in (1, 5, 9, 13)}
    assert len(picks) == 1          # one header, one replica


def _route(router, script):
    """Submit ``script`` (prompt, gen_len) in order; returns each result's
    replica (None when shed) and the router's stats."""
    out = []
    for prompt, gen in script:
        res = router.submit(prompt, gen)
        out.append(None if res is None else res[1])
    return out, router.stats()


@pytest.mark.parametrize("kw", [dict(), dict(affinity=False),
                                dict(queue_limit=2), dict(queue_limit=1),
                                dict(header_pages=1, queue_limit=3)],
                         ids=["affinity", "round-robin", "spill",
                              "shed", "one-page"])
def test_routing_script_equals_reference(weights, kw):
    """The same submissions (headers, headerless prompts, a pile-up on one
    header) without ticking: targets, spills, sheds, affine and
    headerless counts equal the reference's."""
    jt, tt = _tiers(weights, 2)
    rng = np.random.default_rng(5)
    script = [(_prompt(3, 5), 4)] * 4
    script += [(_prompt(g, 3 + g), 2) for g in range(6)]
    script += [(rng.integers(0, 512, n).astype(np.int32), 2)
               for n in (4, 9, 15)]
    want = _route(JRouter(jt, **kw), script)
    got = _route(TRouter(tt, **kw), script)
    assert got == want
    assert [e.scheduler.waiting for e in tt] == \
        [e.scheduler.waiting for e in jt]
    if kw.get("queue_limit") == 1:
        assert sum(got[1]["sheds"]) > 0
    if kw.get("queue_limit") == 2:
        assert got[1]["spills"] > 0


def test_headerless_goes_least_loaded(weights):
    jt, tt = _tiers(weights, 2)
    short = np.arange(1, PS, dtype=np.int32)
    for tier, cls in ((jt, JRouter), (tt, TRouter)):
        router = cls(tier)
        tier[0].submit(_prompt(5, 3), 4)
        assert router.pick(short) == 1
        router.submit(short, 1)
        assert router.headerless == 1


def test_affinity_needs_a_uniform_paged_tier(weights):
    jt, tt = _tiers(weights, 2, page_sizes=[PS, 32])
    with pytest.raises(ValueError) as want:
        JRouter(jt)
    with pytest.raises(ValueError, match="page_size") as got:
        TRouter(tt)
    assert str(got.value) == str(want.value)
    TRouter(tt, affinity=False)
    with pytest.raises(ValueError, match="at least one engine"):
        TRouter([])


def test_routed_streams_equal_reference(weights):
    """Every routed request completes on one replica with the reference
    tier's greedy tokens; the counts match."""
    jt, tt = _tiers(weights, 2)
    jr, tr = JRouter(jt), TRouter(tt)
    prompts = [_prompt(i % 3, 3 + i) for i in range(6)]
    jreqs = [jr.submit(p, 4)[0] for p in prompts]
    treqs = [tr.submit(p, 4)[0] for p in prompts]
    jr.drain()
    tr.drain()
    assert all(r.done and r.error is None for r in treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert tr.stats() == jr.stats() and sum(tr.routed) == 6
    assert sum(e.metrics.prefix_hits for e in tt) == \
        sum(e.metrics.prefix_hits for e in jt) > 0


def test_replay_accounts_for_everything(weights):
    rng = np.random.default_rng(1)
    picks = [int(rng.integers(0, 3)) for _ in range(8)]
    outs = {}
    for name, cls, ev in (("j", JRouter, JEvent), ("t", TRouter, TEvent)):
        jt, tt = _tiers(weights, 2)
        tier = jt if name == "j" else tt
        events = [ev(t=i * 1e-4, prompt=_prompt(g, 3), gen_len=2,
                     priority=i % 2) for i, g in enumerate(picks)]
        outs[name] = cls(tier).replay(events) if name == "j" else \
            cls(tier).replay(events, slo=SLO(ttft_s=60.0, itl_p95_s=60.0))
    out = outs["t"]
    assert out["shed_at_router"] == 0
    assert out["router"] == outs["j"]["router"]
    assert sum(out["router"]["routed"]) == 8
    assert sum(s["completed"] for s in out["replicas"]) == 8
    assert out["requests"] == 8 and out["goodput"]["submitted"] == 8
    assert out.to_dict()["router"] == out.router


def test_build_through_config_routes(weights):
    """Replicas built by ``ServeEngine.build`` (the user's spelling) route
    as the hand-built ones do."""
    tier = [TEngine.build("qwen2.5-32b", config=TConfig(
        batch_slots=2, s_max=64, page_size=PS, device="cpu"))
        for _ in range(2)]
    router = TRouter(tier)
    for g in range(4):
        router.submit(_prompt(g, 2), 2)
    router.drain()
    assert sum(router.routed) == 4 and not router.pending
