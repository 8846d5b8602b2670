"""Open-loop SLO traffic harness: seeded workload generation + replay.

The closed-loop bench submits the next request when a slot frees, so the
arrival process adapts to the server and queueing collapse is invisible —
the server sets its own pace. Real load does not: arrivals are OPEN-LOOP
(a Poisson process does not care that the engine is busy), lengths are
heavy-tailed, tenants carry different priorities, and traffic bursts. This
module generates such a workload DETERMINISTICALLY from a seed (same seed
=> identical arrival/length/priority schedule, the property the CI gate
depends on) and replays it against a live engine on a real clock, metering
GOODPUT — tokens/s delivered within the TTFT + per-request p95 inter-token
SLO (:class:`repro_torch.serve.metrics.SLO`) — instead of raw tokens/s.

A copy of ``repro/serve/workload.py``: numpy only, one ``default_rng``
drawn in the same order, so a spec generates the reference's schedule
byte for byte.

``python -m repro_torch.serve.workload`` runs a short self-contained smoke
replay on the card (``--device cpu`` off it).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.metrics import ReplaySummary, SLO


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Seeded open-loop workload description.

    Arrivals are Poisson at ``rate_rps`` (exponential inter-arrival gaps);
    inside the burst window — ``[burst_start_frac, burst_start_frac +
    burst_len_frac)`` of the nominal horizon ``n_requests / rate_rps`` —
    the instantaneous rate is multiplied by ``burst_mult``. Prompt and
    generation lengths are lognormal (median/sigma parameterised — the
    heavy tail is the point: a few long requests among many short ones)
    clipped to ``[1, *_max]``. Priorities are drawn from the
    ``priority_weights`` mix ((priority, weight) pairs, ascending priority
    = more important first, "think nice levels")."""
    n_requests: int
    rate_rps: float
    seed: int = 0
    prompt_len_median: int = 24
    prompt_len_sigma: float = 0.6
    prompt_len_max: int = 64
    gen_len_median: int = 8
    gen_len_sigma: float = 0.5
    gen_len_max: int = 32
    priority_weights: Tuple[Tuple[int, float], ...] = ((0, 1.0),)
    burst_start_frac: float = 0.0
    burst_len_frac: float = 0.0
    burst_mult: float = 1.0


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One generated arrival: submit ``prompt`` (``gen_len`` tokens to
    generate, at ``priority``) ``t`` seconds after replay start."""
    t: float
    prompt: np.ndarray
    gen_len: int
    priority: int


def _clipped_lognormal(rng: np.random.Generator, median: int, sigma: float,
                       upper: int) -> int:
    x = rng.lognormal(mean=float(np.log(max(median, 1))), sigma=sigma)
    return int(np.clip(round(x), 1, upper))


def generate(spec: WorkloadSpec, vocab_size: int) -> List[ArrivalEvent]:
    """Materialise the workload: a list of events sorted by arrival time.
    Every random draw comes from one ``default_rng(seed)`` in a fixed
    per-event order (gap, prompt len, gen len, priority, tokens), so equal
    specs generate byte-identical schedules on any platform."""
    if spec.n_requests <= 0:
        raise ValueError(f"n_requests must be positive, got {spec.n_requests}")
    if spec.rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {spec.rate_rps}")
    rng = np.random.default_rng(spec.seed)
    prios = [p for p, _ in spec.priority_weights]
    weights = np.asarray([w for _, w in spec.priority_weights], np.float64)
    weights = weights / weights.sum()
    horizon = spec.n_requests / spec.rate_rps
    burst_lo = spec.burst_start_frac * horizon
    burst_hi = burst_lo + spec.burst_len_frac * horizon
    events: List[ArrivalEvent] = []
    t = 0.0
    for _ in range(spec.n_requests):
        rate = spec.rate_rps
        if burst_lo <= t < burst_hi:
            rate *= spec.burst_mult
        t += float(rng.exponential(1.0 / rate))
        plen = _clipped_lognormal(rng, spec.prompt_len_median,
                                  spec.prompt_len_sigma, spec.prompt_len_max)
        glen = _clipped_lognormal(rng, spec.gen_len_median,
                                  spec.gen_len_sigma, spec.gen_len_max)
        prio = int(prios[rng.choice(len(prios), p=weights)])
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        events.append(ArrivalEvent(t=t, prompt=prompt, gen_len=glen,
                                   priority=prio))
    return events


def refuse_tp(engine):
    """Every rank of a tensor-parallel engine must take the same decision
    at the same tick, and a replay on a real clock cannot promise that."""
    if getattr(engine, "tp", 1) > 1:
        raise ValueError(
            f"open-loop replay reads a clock on every rank: under tp="
            f"{engine.tp} the ranks could submit at different ticks and "
            f"their collectives would hang; serve a tp engine closed-loop")


def replay(engine, events: List[ArrivalEvent],
           slo: Optional[SLO] = None) -> ReplaySummary:
    """Open-loop replay on a real clock: each event is submitted at its
    arrival offset WHETHER OR NOT the engine has caught up (queueing under
    overload is exactly what the harness measures), with engine ticks in
    between; returns a :class:`ReplaySummary` wrapping
    ``engine.metrics.summary(slo)`` — including the ``goodput`` section
    when an SLO is given. Dict-style indexing keeps working
    (``summary["requests"]``), same as the multi-replica
    ``router.replay``. It refuses a tensor-parallel engine (tp > 1), whose
    ranks would each read their own clock and could submit at different
    ticks; drive such an engine closed-loop (submit, then ``run``)."""
    refuse_tp(engine)
    ev = sorted(events, key=lambda e: e.t)
    m = engine.metrics
    m.on_start()
    t0 = m.now()
    i = 0
    while i < len(ev) or engine.scheduler.waiting or engine.active:
        now = m.now() - t0
        while i < len(ev) and ev[i].t <= now:
            engine.submit(ev[i].prompt, ev[i].gen_len,
                          priority=ev[i].priority)
            i += 1
        if engine.scheduler.waiting or engine.active:
            engine.step()
        elif i < len(ev):
            # fully idle: doze until the next arrival instead of spinning,
            # capped so the loop stays responsive to the clock
            time.sleep(min(0.010, max(0.0, ev[i].t - (m.now() - t0))))
    m.on_stop()
    return ReplaySummary(metrics=m.summary(slo))


def _main(argv=None) -> int:
    """Short self-contained smoke replay: build a small reduced paged
    engine on ``--device``, generate a bursty multi-tenant
    workload, replay it under an SLO with the scheduling policy ON, and
    print the summary JSON with the engine's ``prefill_failures``. Exits
    non-zero if the replay drops requests on the floor (submitted !=
    completed + aborted), aborts a request that admission control did not
    shed, fails a prefill chunk, or meters zero goodput denominator —
    structural harness failures, not SLO misses (a loaded machine may
    legitimately miss latency targets)."""
    import argparse
    import json

    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SchedPolicy

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--burst-mult", type=float, default=3.0)
    ap.add_argument("--slo-ttft", type=float, default=60.0)
    ap.add_argument("--slo-itl", type=float, default=30.0)
    ap.add_argument("--fifo", action="store_true",
                    help="disable the SLO-aware policy (baseline replay)")
    ap.add_argument("--kv-backend", default=None,
                    help="cache backend registry name (paged | paged_int8 "
                         "| paged_latent; default: layout follows "
                         "page_size). paged_latent needs an MLA --arch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    policy = None if args.fifo else SchedPolicy(
        drr=True, max_consecutive_prefill_ticks=2, preemption=True,
        admission_low_water=0.15, admission_shed_priority=2)
    eng = ServeEngine.build(args.arch, config=ServeConfig(
        reduced=True, batch_slots=2, s_max=96, page_size=16, policy=policy,
        kv_backend=args.kv_backend, device=args.device))
    spec = WorkloadSpec(
        n_requests=args.n, rate_rps=args.rate, seed=args.seed,
        prompt_len_median=16, prompt_len_max=64,
        gen_len_median=4, gen_len_max=16,
        priority_weights=((0, 0.5), (1, 0.3), (2, 0.2)),
        burst_start_frac=0.2, burst_len_frac=0.4,
        burst_mult=args.burst_mult)
    events = generate(spec, eng.cfg.vocab_size)
    summary = replay(eng, events,
                     slo=SLO(ttft_s=args.slo_ttft, itl_p95_s=args.slo_itl))
    print(json.dumps(dict(summary.to_dict(),
                          prefill_failures=eng.prefill_failures),
                     indent=2, default=float))
    # the engine catches a prefill chunk that raises and aborts its job:
    # only a shed may abort here, so a kernel that does not build or
    # launch fails the run
    ok = (summary["requests"] == args.n
          and summary["completed"] + summary["aborted"] == args.n
          and summary["aborted"] == summary["shed_requests"]
          and eng.prefill_failures == 0
          and summary["goodput"]["submitted"] == args.n)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(_main())
