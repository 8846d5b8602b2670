"""The port's open-loop traffic harness and goodput accounting against
``repro``'s.

``workload.generate`` draws from one seeded numpy generator in the
reference's order, so every spec (several shapes, burst windows,
priority mixes, seeds) gives the reference's schedule byte for byte, and
the spec checks raise the same messages. ``MetricsRecorder.summary(slo)``
with its ``goodput`` section, and ``merged_summary`` over a replica tier,
equal the reference's when both recorders see the same events on one fake
clock; ``ReplaySummary`` reads them the same way. ``replay`` and the
``python -m repro_torch.serve.workload`` smoke account for every request
on the reduced engine on the CPU."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import metrics as jmetrics  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
from repro_torch.serve import ServeConfig as TConfig  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve import metrics as tmetrics  # noqa: E402
from repro_torch.serve import workload as tworkload  # noqa: E402

VOCAB = 512

SPECS = [dict(n_requests=64, rate_rps=50.0, seed=7),
         dict(n_requests=200, rate_rps=100.0, seed=1, prompt_len_median=24,
              prompt_len_sigma=1.5, prompt_len_max=48, gen_len_median=8,
              gen_len_sigma=1.5, gen_len_max=16),
         dict(n_requests=120, rate_rps=12.5, seed=3, prompt_len_median=24,
              prompt_len_sigma=0.5, prompt_len_max=48, gen_len_median=10,
              gen_len_sigma=0.5, gen_len_max=24,
              priority_weights=((0, 0.2), (1, 0.2), (2, 0.6)),
              burst_start_frac=0.1, burst_len_frac=0.5, burst_mult=2.5),
         dict(n_requests=1, rate_rps=1e9, seed=0),
         dict(n_requests=33, rate_rps=0.5, seed=12345,
              priority_weights=((2, 3.0), (0, 1.0)), burst_start_frac=0.0,
              burst_len_frac=1.0, burst_mult=4.0)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"seed{s['seed']}")
@pytest.mark.parametrize("vocab", [VOCAB, 152_064])
def test_generate_is_byte_identical_to_reference(spec, vocab):
    want = jworkload.generate(jworkload.WorkloadSpec(**spec), vocab)
    got = tworkload.generate(tworkload.WorkloadSpec(**spec), vocab)
    assert len(got) == len(want) == spec["n_requests"]
    for g, w in zip(got, want):
        assert (g.t, g.gen_len, g.priority) == (w.t, w.gen_len, w.priority)
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        assert g.prompt.tobytes() == w.prompt.tobytes()


def test_spec_fields_and_checks_equal_reference():
    assert [(f.name, f.default) for f in
            dataclasses.fields(tworkload.WorkloadSpec)] == \
        [(f.name, f.default) for f in
         dataclasses.fields(jworkload.WorkloadSpec)]
    for bad in (dict(n_requests=0, rate_rps=1.0),
                dict(n_requests=-3, rate_rps=1.0),
                dict(n_requests=4, rate_rps=0.0),
                dict(n_requests=4, rate_rps=-2.0)):
        with pytest.raises(ValueError) as want:
            jworkload.generate(jworkload.WorkloadSpec(**bad), VOCAB)
        with pytest.raises(ValueError) as got:
            tworkload.generate(tworkload.WorkloadSpec(**bad), VOCAB)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ goodput
class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _drive(mod, clock, offset=0, t0=0.0):
    """One scripted request life-cycle mix on a recorder of ``mod``: met,
    late first token, slow inter-token gaps, shed, cancelled mid-stream,
    preempted and resumed, a prefix hit, chunks and decode steps."""
    m = mod.MetricsRecorder(clock=clock)
    clock.now = t0
    m.on_start()
    r = [offset + i for i in range(7)]
    for i, (rid, prio) in enumerate(zip(r, (0, 0, 1, 2, 1, 0, 2))):
        m.on_submit(rid, prompt_len=8 + i, priority=prio)
    clock.now = t0 + 0.2
    for rid in r[:3] + r[4:6]:
        m.on_admit(rid)
        m.on_prefill(rid, 8)
    m.on_prefill_chunk(40, 0.15)
    m.on_prefix_lookup(16, 1, True)
    m.on_prefix_evict(2)
    m.on_prefix_gather(0.01)
    m.on_first_token(r[0])
    m.on_first_token(r[2])
    m.on_first_token(r[4])
    m.on_shed(r[3])
    m.on_aborted(r[3])
    for k in range(1, 6):
        clock.now = t0 + 0.2 + 0.05 * k + (0.4 if k == 3 else 0.0)
        m.on_decode_step()
        for rid in (r[0], r[2], r[4]):
            m.on_token(rid)
        if k == 2:
            m.on_preempt(r[2])
            m.on_starvation_skip()
    clock.now = t0 + 3.0
    m.on_first_token(r[1])                  # late first token
    m.on_token(r[1])
    m.on_done(r[1])
    m.on_done(r[0])
    m.on_aborted(r[4])                      # cancelled mid-stream
    m.on_first_token(r[5])
    m.on_done(r[5])
    m.on_done(r[2])
    clock.now = t0 + 3.5
    m.on_stop()
    return m                                # r[6] never admitted


def _equal(a, b):
    """Nested summaries equal, NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b


@pytest.mark.parametrize("slo", [None, (2.0, 0.3), (0.1, 0.06),
                                 (10.0, 10.0)])
def test_summary_with_goodput_equals_reference(slo):
    js = tslo = None
    if slo is not None:
        js, tslo = jmetrics.SLO(*slo), tmetrics.SLO(*slo)
    want = _drive(jmetrics, Clock()).summary(js)
    got = _drive(tmetrics, Clock()).summary(tslo)
    _equal(got, want)
    assert ("goodput" in got) == (slo is not None)
    if slo is not None:
        assert got["goodput"]["submitted"] == 7
        assert set(got["goodput"]["by_priority"]) == {"0", "1", "2"}


def test_merged_summary_equals_reference():
    slo = (2.0, 0.3)
    want = jmetrics.merged_summary(
        [_drive(jmetrics, Clock(), 0, 0.0), _drive(jmetrics, Clock(), 7, 1.5)],
        jmetrics.SLO(*slo))
    got = tmetrics.merged_summary(
        [_drive(tmetrics, Clock(), 0, 0.0), _drive(tmetrics, Clock(), 7, 1.5)],
        tmetrics.SLO(*slo))
    _equal(got, want)
    assert got["requests"] == 14 and got["wall_s"] == 5.0
    assert tmetrics._SUMMED_COUNTERS == jmetrics._SUMMED_COUNTERS


def test_replay_summary_reads_as_reference():
    slo = (2.0, 0.3)
    parts = {}
    for name, mod in (("j", jmetrics), ("t", tmetrics)):
        recs = [_drive(mod, Clock(), 0), _drive(mod, Clock(), 7)]
        tier = mod.ReplaySummary(
            metrics=mod.merged_summary(recs, mod.SLO(*slo)),
            replicas=[mod.ReplaySummary(metrics=m.summary(mod.SLO(*slo)))
                      for m in recs],
            router={"routed": [7, 7]}, shed_at_router=1)
        parts[name] = tier
    j, t = parts["j"], parts["t"]
    _equal(t.to_dict(), j.to_dict())
    assert t.keys() == j.keys() and "router" in t and "bogus" not in t
    assert t["replicas"][0]["goodput"] == j["replicas"][0]["goodput"]
    assert t.get("bogus", 3) == 3
    for prop in ("goodput", "attainment_by_priority", "ttft_p95_s",
                 "itl_p95_s", "throughput_tokens_per_s"):
        _equal(getattr(t, prop), getattr(j, prop))
    single = tmetrics.ReplaySummary(metrics={"requests": 1})
    assert single.goodput is None and single.attainment_by_priority == {}
    assert "replicas" not in single


def test_slo_met_by_equals_reference():
    for slo in ((2.0, 0.3), (0.1, 0.06)):
        jm, tm = _drive(jmetrics, Clock()), _drive(tmetrics, Clock())
        assert [jmetrics.SLO(*slo).met_by(r) for r in jm.requests.values()] \
            == [tmetrics.SLO(*slo).met_by(r) for r in tm.requests.values()]


# ------------------------------------------------------------ replay
def test_replay_accounts_for_every_request():
    eng = TEngine.build("qwen2.5-32b", config=TConfig(
        batch_slots=2, s_max=48, device="cpu"))
    events = tworkload.generate(tworkload.WorkloadSpec(
        n_requests=4, rate_rps=1e9, seed=0, prompt_len_median=8,
        prompt_len_max=16, gen_len_median=3, gen_len_max=4,
        priority_weights=((0, 0.5), (1, 0.5))), eng.cfg.vocab_size)
    s = tworkload.replay(eng, events,
                         slo=tmetrics.SLO(ttft_s=60.0, itl_p95_s=60.0))
    assert isinstance(s, tmetrics.ReplaySummary)
    assert s["requests"] == 4 and s["completed"] + s["aborted"] == 4
    g = s["goodput"]
    assert g["submitted"] == 4 and set(g["by_priority"]) <= {"0", "1"}
    assert 0.0 <= g["slo_attainment"] <= 1.0


@pytest.mark.parametrize("fifo", [False, True])
def test_workload_main_runs_on_the_cpu(fifo, capsys):
    args = ["--device", "cpu", "--n", "5", "--rate", "200"]
    assert tworkload._main(args + (["--fifo"] if fifo else [])) == 0
    out = capsys.readouterr().out
    assert '"submitted": 5' in out and '"goodput"' in out
    assert '"prefill_failures": 0' in out


def test_workload_main_fails_when_a_prefill_chunk_fails(monkeypatch,
                                                       capsys):
    """The engine catches a chunk that raises and aborts its request; the
    smoke must not pass on that, so a kernel that does not launch fails
    it (the printed summary counts the failures)."""
    from repro_torch.kernels import ops as kops

    def fails(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(kops, "paged_prefill", fails)
    assert tworkload._main(["--device", "cpu", "--n", "3", "--rate", "200",
                            "--fifo"]) == 1
    out = capsys.readouterr().out
    assert '"prefill_failures": 3' in out and '"aborted": 3' in out


def test_workload_main_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tworkload._main(["--n", "2"])
