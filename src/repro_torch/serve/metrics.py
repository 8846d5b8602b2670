"""Serving metrics: per-request time-to-first-token, tokens/s, and request
latency, plus engine-level p50/p95 and throughput. Pure host-side bookkeeping
— the engine calls the ``on_*`` hooks; ``summary()`` aggregates.

The clock is injectable so tests can drive deterministic timelines.

A copy of ``MetricsRecorder`` from ``repro/serve/metrics.py`` (the SLO /
goodput accounting of the traffic harness is not ported yet, ROADMAP queue
1 item 8). The engine synchronises the device before it reads the clock
around device work, so host timestamps cover the work itself.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    rid: int
    prompt_len: int
    t_submit: float
    priority: int = 0
    t_admit: Optional[float] = None           # slot reserved, prefill begins
    t_first_token: Optional[float] = None     # prefill done, token 1 sampled
    t_last_token: Optional[float] = None      # most recent token (ITL base)
    t_done: Optional[float] = None
    n_tokens: int = 0
    itl_s: List[float] = dataclasses.field(default_factory=list)
    #                           inter-token gaps (len == n_tokens - 1 for a
    #                           normally-streamed request); the per-request
    #                           p95 of these is what the ITL SLO checks
    aborted: bool = False     # FAILED/CANCELLED: excluded from completion
    #                           counts and latency percentiles (a request
    #                           cancelled right after submit would otherwise
    #                           enter latency_s p50 as ~0 s)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Time spent waiting for a slot/pages — the scheduling share of
        TTFT, split out so chunked prefill's head-of-line win (shorter
        waits behind long prompts) is visible separately from prefill
        compute time."""
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def tokens_per_s(self) -> Optional[float]:
        lat = self.latency_s
        if lat is None or self.n_tokens == 0:
            return None
        return self.n_tokens / max(lat, 1e-9)

    @property
    def itl_p95_s(self) -> Optional[float]:
        """Per-request p95 inter-token gap; None when the request produced
        fewer than two tokens (no gap exists — the ITL SLO is then
        trivially met)."""
        if not self.itl_s:
            return None
        return percentile(self.itl_s, 95)


def percentile(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))


# Shortest wall interval credited with throughput. Walls below this are clock
# granularity noise (or an injected test clock that never advanced): dividing
# by them reports absurd token rates, so summary() clamps the denominator.
MIN_WALL_S = 1e-6


class MetricsRecorder:
    """Collects request lifecycle timestamps and engine counters."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.requests: Dict[int, RequestRecord] = {}
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0         # token·rows pushed through chunks
        self.prefill_wall_s = 0.0             # wall spent inside chunk calls
        self.prefill_chunk_max_tokens = 0     # largest single chunk dispatch
        # prefix cache (one lookup per paged admission when enabled)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0            # prompt rows served from pages
        self.prefix_pages_shared = 0          # full pages aliased, no copy
        self.prefix_cow_copies = 0            # partial pages re-materialised
        self.prefix_evictions = 0             # LRU entries dropped for space
        # SLO-aware scheduling counters (all zero with the default policy)
        self.preemptions = 0                  # RUNNING slots paused+re-queued
        self.shed_requests = 0                # admission control gave up early
        self.starvation_guard_skips = 0       # prefill ticks skipped for decode
        self._t_start: Optional[float] = None
        self._t_stop: Optional[float] = None

    def now(self) -> float:
        """The recorder's clock — engines time prefill chunks with it so
        injected test clocks drive deterministic rates."""
        return self._clock()

    # ------------------------------------------------------------ hooks
    def on_start(self):
        if self._t_start is None:
            self._t_start = self._clock()

    def on_stop(self):
        self._t_stop = self._clock()

    def on_submit(self, rid: int, prompt_len: int, priority: int = 0):
        self.requests[rid] = RequestRecord(rid=rid, prompt_len=prompt_len,
                                           t_submit=self._clock(),
                                           priority=priority)

    def on_admit(self, rid: int):
        rec = self.requests[rid]
        if rec.t_admit is None:
            rec.t_admit = self._clock()

    def on_prefill(self, rid: int, prompt_len: int):
        self.prefills += 1
        self.prefill_tokens += prompt_len

    def on_prefill_chunk(self, n_tokens: int, wall_s: float):
        """One prefill chunk dispatch: ``n_tokens`` = group batch x chunk
        length (the rows of K/V it produced), ``wall_s`` its wall time.
        ``prefill_chunk_tokens / prefill_wall_s`` is the prefill tokens/s the
        bench reports; ``prefill_chunk_max_tokens`` bounds the work a single
        tick can insert between two decode ticks (the head-of-line bound
        chunked interleaving exists to enforce)."""
        self.prefill_chunks += 1
        self.prefill_chunk_tokens += n_tokens
        self.prefill_wall_s += wall_s
        self.prefill_chunk_max_tokens = max(self.prefill_chunk_max_tokens,
                                            n_tokens)

    def on_prefix_lookup(self, hit_tokens: int, pages_shared: int,
                         cow: bool):
        """One prefix-cache lookup at admission: ``hit_tokens`` prompt rows
        will be served from shared pages instead of recomputed
        (0 = miss), ``pages_shared`` full pages alias into the block table,
        ``cow`` marks a partial page re-materialised copy-on-write."""
        self.prefix_lookups += 1
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit_tokens
        self.prefix_pages_shared += pages_shared
        if cow:
            self.prefix_cow_copies += 1

    def on_prefix_evict(self, n_pages: int):
        self.prefix_evictions += n_pages

    def on_prefix_gather(self, wall_s: float):
        """Wall spent gathering shared prefix rows into a transient prefill
        cache — charged to prefill wall so hit-path prefill tokens/s pays
        for its own overhead (the bench's effective rate stays honest)."""
        self.prefill_wall_s += wall_s

    def on_first_token(self, rid: int):
        # idempotent like on_done: the token COUNT rides the same guard as
        # the timestamp, so a duplicate call (retried splice, defensive
        # engine path) cannot double-count token 1
        rec = self.requests[rid]
        if rec.t_first_token is None:
            rec.t_first_token = self._clock()
            rec.t_last_token = rec.t_first_token
            rec.n_tokens += 1

    def on_token(self, rid: int):
        rec = self.requests[rid]
        rec.n_tokens += 1
        now = self._clock()
        if rec.t_last_token is not None:
            rec.itl_s.append(now - rec.t_last_token)
        rec.t_last_token = now

    def on_preempt(self, rid: int):
        """A RUNNING request was paused and re-queued (recompute-style).
        The pause shows up naturally as one long inter-token gap when the
        request resumes — the ITL SLO is exactly what preemption trades
        away for higher-priority TTFT, so nothing is reset here."""
        self.preemptions += 1

    def on_shed(self, rid: int):
        self.shed_requests += 1

    def on_starvation_skip(self):
        self.starvation_guard_skips += 1

    def on_done(self, rid: int):
        # idempotent: a duplicate _finish must not move t_done forward and
        # skew the latency percentiles
        rec = self.requests[rid]
        if rec.t_done is None:
            rec.t_done = self._clock()

    def on_aborted(self, rid: int):
        """Close a record for a FAILED or CANCELLED request: the record is
        finalized (drain-able) but excluded from ``completed`` and the
        latency/tokens-per-second percentiles — an abort is not a served
        request. Idempotent like on_done."""
        rec = self.requests[rid]
        if rec.t_done is None:
            rec.t_done = self._clock()
        rec.aborted = True

    def on_decode_step(self):
        self.decode_steps += 1

    # ------------------------------------------------------------ summary
    def summary(self) -> dict:
        recs = list(self.requests.values())
        done = [r for r in recs if r.t_done is not None and not r.aborted]
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        waits = [r.queue_wait_s for r in done if r.queue_wait_s is not None]
        lats = [r.latency_s for r in done]
        tps = [r.tokens_per_s for r in done if r.tokens_per_s is not None]
        itls = [g for r in done for g in r.itl_s]
        # throughput counts SERVED tokens only: a FAILED/CANCELLED request's
        # partial stream was never delivered, so crediting it would inflate
        # tokens/s exactly when the engine is misbehaving (aborts are
        # already excluded from `completed`). Aborted work is still visible,
        # separately, as `aborted_tokens`.
        total_tokens = sum(r.n_tokens for r in recs if not r.aborted)
        aborted_tokens = sum(r.n_tokens for r in recs if r.aborted)
        t_end = self._t_stop if self._t_stop is not None else self._clock()
        # without on_start() (engine driven via step(), not run()) there is
        # no wall clock — report NaN like the other missing-data fields, not
        # a 1e9x-inflated throughput over a zero denominator; positive but
        # sub-MIN_WALL_S walls clamp to MIN_WALL_S instead of silently
        # reporting a near-infinite rate
        wall = (t_end - self._t_start) if self._t_start is not None else \
            float("nan")
        out = {
            "requests": len(recs),
            "completed": len(done),
            "aborted": sum(1 for r in recs if r.aborted),
            "wall_s": wall,
            "total_tokens": total_tokens,
            "aborted_tokens": aborted_tokens,
            "throughput_tokens_per_s": (total_tokens / max(wall, MIN_WALL_S)
                                        if wall > 0 else float("nan")),
            "preemptions": self.preemptions,
            "shed_requests": self.shed_requests,
            "starvation_guard_skips": self.starvation_guard_skips,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_max_tokens": self.prefill_chunk_max_tokens,
            # prefill throughput over the wall spent INSIDE chunk dispatches
            # — measures the forward's arithmetic intensity, not queueing
            "prefill_tokens_per_s": (
                self.prefill_chunk_tokens / max(self.prefill_wall_s,
                                                MIN_WALL_S)
                if self.prefill_wall_s > 0 else float("nan")),
            # prefix cache: hit_rate is per-LOOKUP (one lookup per paged
            # admission when enabled); hit_tokens / prefill_tokens is the
            # fraction of prompt rows served from shared pages
            "prefix": {
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                "hit_rate": (self.prefix_hits / self.prefix_lookups
                             if self.prefix_lookups else float("nan")),
                "hit_tokens": self.prefix_hit_tokens,
                "pages_shared": self.prefix_pages_shared,
                "cow_copies": self.prefix_cow_copies,
                "evictions": self.prefix_evictions,
            },
            "queue_wait_s": {"mean": float(np.mean(waits)) if waits
                             else float("nan"),
                             "p50": percentile(waits, 50),
                             "p95": percentile(waits, 95)},
            "ttft_s": {"mean": float(np.mean(ttfts)) if ttfts else float("nan"),
                       "p50": percentile(ttfts, 50),
                       "p95": percentile(ttfts, 95)},
            "latency_s": {"p50": percentile(lats, 50),
                          "p95": percentile(lats, 95)},
            "itl_s": {"p50": percentile(itls, 50),
                      "p95": percentile(itls, 95)},
            "request_tokens_per_s": {"p50": percentile(tps, 50),
                                     "p95": percentile(tps, 95)},
        }
        return out
