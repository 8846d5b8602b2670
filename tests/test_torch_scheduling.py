"""The port's scheduling policy against ``repro``'s, step by step.

Every ``SchedPolicy`` knob drives the same submit / step script through
the reference engine and the port's engine (the reduced qwen2.5-32b, the
reference's weights bridged through numpy), and after every step each
request's state, slot, tokens, prompt (folded by preemption), error and
metric record are equal, as are the free pages, the deferrals, the
running / queued / job counts and every metrics counter: the FIFO anchor
(``SchedPolicy()``), deficit round-robin, the decode-starvation guard,
single and double preemption (the ``Request.folded`` watermark) with the
prefix cache off and on, shed and defer at the head, EDF, and a bursty
open-loop schedule under every knob at once (the reference bench's burst
policy) fed in by ticks. Forced double preemption and the burst policy
are held the same way beyond qwen's fp32 pages: on int8 pages, on the
latent pages of qwen2.5-32b-mla, on hymba's paged and dense rings and
rwkv6's dense state (their zero-initialised recurrent leaves perturbed)
and on dbrx's pages, where every routed row takes expert capacity, so a
resumed MoE request is held to the reference step by step, not to its
uninterrupted stream. The scheduler's own ordering (EDF, priority,
cancelled heads) is held on the module the port copies, and the engine
wiring of ``edf`` and ``deadline`` as the reference wires them."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.registry import get_model, reduced_config  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro.serve.scheduler import RequestState as JState  # noqa: E402
from repro.serve.scheduler import SchedPolicy as JPolicy  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve import workload as tworkload  # noqa: E402
from repro_torch.serve.scheduler import Request as TRequest  # noqa: E402
from repro_torch.serve.scheduler import RequestState  # noqa: E402
from repro_torch.serve.scheduler import SchedPolicy as TPolicy  # noqa: E402
from repro_torch.serve.scheduler import Scheduler as TScheduler  # noqa: E402

COUNTERS = ("decode_steps", "prefills", "prefill_tokens", "prefill_chunks",
            "prefill_chunk_tokens", "prefill_chunk_max_tokens",
            "prefix_lookups", "prefix_hits", "prefix_hit_tokens",
            "prefix_pages_shared", "prefix_cow_copies", "prefix_evictions",
            "preemptions", "shed_requests", "starvation_guard_skips")
# the reference bench's burst-cell policy (benchmarks/serve_bench.py:574)
GOODPUT_POLICY_KW = dict(drr=True, max_consecutive_prefill_ticks=2,
                         preemption=True, admission_low_water=0.15,
                         admission_shed_priority=2)
FINAL = ("done", "failed", "cancelled")


@pytest.fixture(scope="module")
def qwen():
    """(reference model, its params, port model, the same params)."""
    cfg = reduced_config(jconfigs.get_config("qwen2.5-32b"))
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = treg.get_model(treg.reduced_config(
        tconfigs.get_config("qwen2.5-32b")))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return model, params, tmodel, tparams


# (arch, engine fields beyond the test's own) of the held variants; an
# empty dict is the arch's pages, sized by the test
VARIANTS = {
    "int8": ("qwen2.5-32b", dict(kv_backend="paged_int8")),
    "latent": ("qwen2.5-32b-mla", dict(kv_backend="paged_latent")),
    "hymba-paged": ("hymba-1.5b", dict()),
    "hymba-dense": ("hymba-1.5b", dict(page_size=None)),
    "rwkv6": ("rwkv6-7b", dict(page_size=None)),
    "dbrx": ("dbrx-132b", dict()),
}


@pytest.fixture(scope="module")
def variants():
    """arch -> the ``qwen`` fixture's tuple for that arch (reduced), the
    recurrent archs' zero-initialised leaves perturbed as in
    tests/test_torch_engine.py; built once."""
    from test_torch_engine import RECURRENT_NOISE
    from test_torch_ssm import perturbed
    built = {}

    def get(arch):
        if arch not in built:
            model = get_model(reduced_config(jconfigs.get_config(arch)))
            params = jax.tree.map(np.asarray,
                                  model.init(jax.random.PRNGKey(0)))
            if arch in RECURRENT_NOISE:
                params = perturbed(params, RECURRENT_NOISE[arch])
            tmodel = treg.get_model(treg.reduced_config(
                tconfigs.get_config(arch)))
            built[arch] = (model, jax.tree.map(jax.numpy.asarray, params),
                           tmodel, bridge.params_from_numpy(params, "cpu"))
        return built[arch]
    return get


def _variant_fields(name, page_size, num_pages):
    """The variant's engine fields: its own, on pages of ``page_size``
    (hymba's 8-row ring: pages of 4) where it pages."""
    arch, fields = VARIANTS[name]
    fields = dict(fields)
    if "page_size" not in fields:
        fields.update(page_size=4 if arch == "hymba-1.5b" else page_size,
                      num_pages=num_pages)
    return arch, fields


class Lockstep:
    """One script through both engines, held equal after every step."""

    def __init__(self, qwen, policy=None, **kw):
        model, params, tmodel, tparams = qwen
        self.j = JEngine(model, params,
                         policy=None if policy is None
                         else JPolicy(**policy), **kw)
        self.t = TEngine(tmodel, tparams, device="cpu",
                         policy=None if policy is None
                         else TPolicy(**policy), **kw)
        self.pairs = []
        self.steps = 0
        self.first_token_step = {}

    def submit(self, prompt, gen_len, priority=0, deadline=None):
        prompt = np.asarray(prompt, np.int32)
        pair = (self.j.submit(prompt, gen_len, priority=priority,
                              deadline=deadline),
                self.t.submit(prompt, gen_len, priority=priority,
                              deadline=deadline))
        self.pairs.append(pair)
        self.check()
        return pair[1]

    def cancel(self, i):
        a, b = self.pairs[i]
        got = (self.j.cancel(a.rid), self.t.cancel(b.rid))
        assert got[0] == got[1]
        self.check()
        return got[1]

    def preempt(self, i):
        a, b = self.pairs[i]
        self.j._preempt(a.slot)
        self.t._preempt(b.slot)
        self.check()

    def step(self):
        self.j.step()
        self.t.step()
        self.steps += 1
        for i, (_, b) in enumerate(self.pairs):
            if b.tokens and i not in self.first_token_step:
                self.first_token_step[i] = self.steps
        self.check()

    def busy(self, e):
        return e.scheduler.waiting or e.active

    def drain(self, ticks=600):
        for _ in range(ticks):
            if not (self.busy(self.j) or self.busy(self.t)):
                break
            self.step()
        else:
            raise AssertionError(f"not drained in {ticks} ticks")
        assert all(b.state.value in FINAL for _, b in self.pairs)

    def check(self):
        j, t = self.j, self.t
        for a, b in self.pairs:
            assert (a.state.value, a.slot, list(a.tokens), a.error,
                    a.prompt.tolist(), a.folded, a.seq, a.deadline) == \
                (b.state.value, b.slot, list(b.tokens), b.error,
                 b.prompt.tolist(), b.folded, b.seq, b.deadline), a.rid
            ra, rb = j.metrics.requests[a.rid], t.metrics.requests[b.rid]
            assert (ra.n_tokens, ra.aborted, ra.t_done is None,
                    ra.t_first_token is None, ra.t_admit is None,
                    len(ra.itl_s)) == \
                (rb.n_tokens, rb.aborted, rb.t_done is None,
                 rb.t_first_token is None, rb.t_admit is None,
                 len(rb.itl_s)), a.rid
        assert (j.free_pages, j.deferrals, j.active, j.running,
                j.scheduler.waiting, len(j._jobs), j.prefill_failures,
                j.max_prefill_tokens_per_tick) == \
            (t.free_pages, t.deferrals, t.active, t.running,
             t.scheduler.waiting, len(t._jobs), t.prefill_failures,
             t.max_prefill_tokens_per_tick)
        assert [getattr(j.metrics, c) for c in COUNTERS] == \
            [getattr(t.metrics, c) for c in COUNTERS]
        assert [r is None for r in j.slot_req] == \
            [r is None for r in t.slot_req]
        j.assert_page_invariants()
        t.assert_page_invariants()


def _uninterrupted(qwen, prompt, gen, **kw):
    """The port's stream for one request served alone, no policy."""
    _, _, tmodel, tparams = qwen
    eng = TEngine(tmodel, tparams, device="cpu", **kw)
    r = eng.submit(prompt, gen)
    eng.run()
    return list(r.tokens)


# ------------------------------------------------------------ the anchor
@pytest.mark.parametrize("policy", [None, {}], ids=["None", "SchedPolicy()"])
def test_default_policy_is_the_fifo_path(qwen, policy):
    ls = Lockstep(qwen, policy=policy, batch_slots=2, s_max=48, page_size=8)
    ls.submit(np.arange(1, 9), 6)
    ls.submit(np.arange(40, 52), 6)
    ls.drain()
    assert ls.t.policy == TPolicy() and not ls.t.scheduler.edf
    assert ls.t.metrics.preemptions == ls.t.deferrals == 0


# ------------------------------------------------------------ DRR
@pytest.mark.parametrize("drr", [False, True])
def test_drr_interleaves_prefill_as_the_reference_does(qwen, drr):
    """With DRR a short prompt behind a long one reaches its first token
    first; FIFO drains the long head first. Tokens unchanged."""
    ls = Lockstep(qwen, policy=dict(drr=drr), batch_slots=2, s_max=48,
                  prefill_chunk_tokens=8)
    ls.submit(np.arange(1, 33), 4)
    ls.submit(np.arange(50, 58), 4)
    ls.drain()
    long_first, short_first = ls.first_token_step[0], ls.first_token_step[1]
    assert (short_first < long_first) == drr
    assert [list(b.tokens) for _, b in ls.pairs] == \
        [_uninterrupted(qwen, np.arange(1, 33), 4, batch_slots=2, s_max=48),
         _uninterrupted(qwen, np.arange(50, 58), 4, batch_slots=2,
                        s_max=48)]


@pytest.mark.parametrize("quantum", [3, 16])
def test_drr_with_a_fixed_quantum(qwen, quantum):
    ls = Lockstep(qwen, policy=dict(drr=True, drr_quantum=quantum),
                  batch_slots=3, s_max=48, page_size=8,
                  prefill_chunk_tokens=8)
    for n in (29, 13, 21):
        ls.submit(np.arange(2, 2 + n), 3)
    ls.drain()


# ------------------------------------------------------------ the guard
def test_starvation_guard_skips_as_the_reference_does(qwen):
    ls = Lockstep(qwen, policy=dict(max_consecutive_prefill_ticks=1),
                  batch_slots=2, s_max=48, prefill_chunk_tokens=8)
    ls.submit(np.arange(1, 9), 24)
    for _ in range(4):
        ls.submit(np.arange(1, 25), 2)
    ls.drain()
    assert ls.t.metrics.starvation_guard_skips > 0


# ------------------------------------------------------------ preemption
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preemption_pauses_the_lowest_and_resumes_its_stream(qwen,
                                                             prefix_cache):
    kw = dict(batch_slots=2, s_max=48, page_size=8, num_pages=4,
              prefix_cache=prefix_cache)
    ls = Lockstep(qwen, policy=dict(preemption=True), **kw)
    victim = ls.submit(np.arange(1, 9), 8, priority=1)
    for _ in range(4):
        ls.step()
    assert victim.state is RequestState.RUNNING
    prem = ls.submit(np.arange(20, 36), 4, priority=0)
    ls.drain()
    assert ls.t.metrics.preemptions >= 1 and victim.folded > 0
    assert victim.state is prem.state is RequestState.DONE
    assert list(victim.tokens) == _uninterrupted(qwen, np.arange(1, 9), 8,
                                                 **kw)


def test_double_preemption_folds_tokens_once(qwen):
    kw = dict(batch_slots=2, s_max=48, page_size=8, num_pages=6,
              prefix_cache=False)
    ls = Lockstep(qwen, policy=dict(preemption=True), **kw)
    prompt = np.arange(1, 9)
    victim = ls.submit(prompt, 8, priority=1)
    for _ in range(4):
        ls.step()
    assert victim.state is RequestState.RUNNING and victim.tokens
    ls.preempt(0)
    n_first = len(victim.tokens)
    assert len(victim.prompt) == len(prompt) + n_first
    for _ in range(400):
        ls.step()
        if (victim.state is RequestState.RUNNING
                and len(victim.tokens) > n_first):
            break
    ls.preempt(0)
    assert len(victim.prompt) == len(prompt) + len(victim.tokens)
    assert ls.t.metrics.preemptions == 2
    ls.drain()
    assert list(victim.tokens) == _uninterrupted(qwen, prompt, 8, **kw)


# ------------------------------------------------ admission control
@pytest.mark.parametrize("shed", [True, False])
def test_admission_sheds_or_defers_the_gated_head(qwen, shed):
    ls = Lockstep(qwen, policy=dict(admission_low_water=0.5,
                                    admission_shed_priority=1,
                                    admission_shed=shed),
                  batch_slots=2, s_max=48, page_size=8, num_pages=4,
                  prefix_cache=False)
    hog = ls.submit(np.arange(1, 17), 6, priority=0)
    for _ in range(3):
        ls.step()
    assert hog.state is RequestState.RUNNING
    low = ls.submit(np.arange(30, 34), 2, priority=1)
    premium = ls.submit(np.arange(40, 44), 2, priority=0)
    ls.step()
    if shed:
        assert low.state is RequestState.FAILED and "shed" in low.error
        assert ls.t.metrics.shed_requests == 1
    else:
        assert premium.state is not RequestState.QUEUED   # never gated
        assert low.state is RequestState.QUEUED
    ls.drain()
    assert low.state is (RequestState.FAILED if shed else RequestState.DONE)


def test_pool_deferral_counts_as_the_reference_does(qwen):
    ls = Lockstep(qwen, batch_slots=3, s_max=48, page_size=8, num_pages=6,
                  prefix_cache=False)
    for n in (20, 20, 9, 30):
        ls.submit(np.arange(3, 3 + n), 10)
    ls.drain()
    assert ls.t.deferrals > 0


# ------------------------------------------------------------ EDF
def test_edf_orders_dated_requests_first(qwen):
    ls = Lockstep(qwen, policy=dict(edf=True), batch_slots=1, s_max=32,
                  page_size=8)
    assert ls.j.scheduler.edf and ls.t.scheduler.edf
    ls.submit(np.arange(1, 4), 1)                       # undated
    ls.submit(np.arange(1, 4), 1, deadline=2.5)
    ls.submit(np.arange(5, 9), 2, deadline=1.0)
    ls.submit(np.arange(5, 9), 1, priority=1, deadline=0.1)
    ls.submit(np.arange(1, 4), 1)
    assert ls.t.scheduler.peek() is ls.pairs[2][1]
    ls.drain()
    order = sorted(range(5), key=lambda i: ls.first_token_step[i])
    assert order == [2, 1, 0, 4, 3]
    assert ls.pairs[0][1].deadline == math.inf


# ------------------------------------------------------------ burst
def test_burst_under_every_knob_equals_the_reference(qwen):
    """The reference bench's burst policy on its pool (4 slots, s_max 96,
    pages of 16, 8 pages) under a bursty three-tenant schedule from the
    port's ``generate``, arrivals fed in by tick: preemptions, sheds,
    deferrals, DRR and guard skips all happen, and every step equals the
    reference's."""
    ls = Lockstep(qwen, policy=GOODPUT_POLICY_KW, batch_slots=4, s_max=96,
                  page_size=16, num_pages=8)
    spec = tworkload.WorkloadSpec(
        n_requests=24, rate_rps=2.0, seed=3, prompt_len_median=24,
        prompt_len_sigma=0.5, prompt_len_max=48, gen_len_median=10,
        gen_len_sigma=0.5, gen_len_max=24,
        priority_weights=((0, 0.2), (1, 0.2), (2, 0.6)),
        burst_start_frac=0.1, burst_len_frac=0.5, burst_mult=2.5)
    events = tworkload.generate(spec, ls.t.cfg.vocab_size)
    tick = 0
    for e in events:
        while tick < int(e.t * 2.0):        # two ticks per second of arrival
            ls.step()
            tick += 1
        ls.submit(e.prompt, e.gen_len, priority=e.priority)
    ls.drain()
    m = ls.t.metrics
    assert m.preemptions > 0 and m.shed_requests > 0
    assert ls.t.deferrals > 0 and m.starvation_guard_skips > 0
    assert ls.t.free_pages + len(set(ls.t.prefix_index.pages)) == 8


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forced_double_preemption_equals_the_reference(variants, name):
    """``_preempt`` on a running request, twice, with a request queued
    behind it: the folded prompt re-prefills on every variant's cache and
    every step equals the reference's."""
    arch, fields = _variant_fields(name, 8, 6)
    ls = Lockstep(variants(arch), policy=dict(preemption=True),
                  batch_slots=2, s_max=48, prefix_cache=False, **fields)
    victim = ls.submit(np.arange(1, 9), 8, priority=1)
    ls.submit(np.arange(20, 31), 4)
    for _ in range(4):
        ls.step()
    assert victim.state is RequestState.RUNNING and victim.tokens
    ls.preempt(0)
    n_first = len(victim.tokens)
    for _ in range(400):
        ls.step()
        if (victim.state is RequestState.RUNNING
                and len(victim.tokens) > n_first):
            break
    ls.preempt(0)
    assert ls.t.metrics.preemptions == 2
    assert len(victim.prompt) == 8 + len(victim.tokens)
    ls.drain()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_burst_policy_on_every_variant_equals_the_reference(variants, name):
    """The reference bench's burst policy (4 slots, s_max 96; pages of 16,
    8 of them, where the variant pages) under a bursty three-tenant
    schedule of 12 requests from the port's ``generate``: every step
    equals the reference's, and on pages of 16 the policy preempts."""
    arch, fields = _variant_fields(name, 16, 8)
    ls = Lockstep(variants(arch), policy=GOODPUT_POLICY_KW, batch_slots=4,
                  s_max=96, **fields)
    spec = tworkload.WorkloadSpec(
        n_requests=12, rate_rps=2.0, seed=3, prompt_len_median=24,
        prompt_len_sigma=0.5, prompt_len_max=48, gen_len_median=10,
        gen_len_sigma=0.5, gen_len_max=24,
        priority_weights=((0, 0.2), (1, 0.2), (2, 0.6)),
        burst_start_frac=0.1, burst_len_frac=0.5, burst_mult=2.5)
    events = tworkload.generate(spec, ls.t.cfg.vocab_size)
    tick = 0
    for e in events:
        while tick < int(e.t * 2.0):
            ls.step()
            tick += 1
        ls.submit(e.prompt, e.gen_len, priority=e.priority)
    ls.drain()
    if fields.get("page_size") == 16:
        assert ls.t.metrics.preemptions > 0


# ------------------------------------------------------------ scheduler
def _reqs(cls, specs):
    out = []
    for rid, (prio, deadline) in enumerate(specs):
        r = cls(rid=rid, prompt=np.arange(1, 3, dtype=np.int32), gen_len=1,
                priority=prio)
        if deadline is not None:
            r.deadline = deadline
        out.append(r)
    return out


@pytest.mark.parametrize("edf", [False, True])
def test_scheduler_order_equals_the_reference(edf):
    specs = [(0, None), (0, 5.0), (1, 0.5), (0, 50.0), (0, None), (2, 1.0),
             (1, None), (0, 5.0)]
    pops = []
    for sched, cls, dead in ((JScheduler(edf=edf), JRequest, JState),
                             (TScheduler(edf=edf), TRequest, RequestState)):
        reqs = _reqs(cls, specs)
        for r in reqs:
            sched.submit(r)
        reqs[3].state = dead.CANCELLED
        first = sched.next_request()
        sched.submit(first)                 # re-queued: keeps its seq
        assert sched.waiting == len(specs) - 1
        pops.append([sched.next_request().rid for _ in range(len(specs) - 1)])
        assert sched.next_request() is None and not sched
    assert pops[0] == pops[1]
