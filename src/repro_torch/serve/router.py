"""Prefix-affinity replica router: the front tier over N engine replicas.

Horizontal half of the multi-host story (the vertical half is the
tensor-parallel mesh inside one engine): N independent ``ServeEngine``
replicas, each with its own page pool and ``PrefixIndex``, behind a router
that decides WHERE a request runs. Pure host code — no device state, no new
jit traces; the engines don't know the router exists.

Routing is prefix-AFFINE: requests whose prompts share a page-aligned
header should land on the same replica, because that replica's
``PrefixIndex`` already holds the header's pages — admission then aliases
them (skipped prefill) instead of recomputing them. The affinity key is the
same ``chain_hash`` digest chain ``serve/prefix.py`` keys its index with,
walked over the prompt's first ``header_pages`` FULL pages: two prompts
that would hit the same index chain hash to the same key, and the page
alignment means a differing tail never perturbs the key. Replica choice is
rendezvous (highest-random-weight) hashing of (key, replica): stable under
identical keys, uniform across keys, and no ring state to rebalance.

Load handling, in order:

* headerless prompts (shorter than one page) carry no reusable prefix —
  they go to the least-loaded replica outright;
* a replica above ``queue_limit`` waiting requests exerts BACK-PRESSURE:
  the router spills the request to the least-loaded replica below the
  limit (affinity lost, service retained — counted in ``spills``);
* when every replica is above the limit the request is SHED at the door
  (returned as None, counted per-replica in ``sheds`` against the replica
  affinity wanted) — the same answer the engines' own admission control
  gives under overload, taken one hop earlier.

A copy of ``repro/serve/router.py`` over the port's engines: the affinity
key is the port's ``chain_hash`` chain, byte-equal to the reference's, so
both routers send a prompt to the same replica.
"""
from __future__ import annotations

import hashlib
import time
from typing import List, Optional

import numpy as np

from repro_torch.serve.metrics import ReplaySummary, SLO, merged_summary
from repro_torch.serve.prefix import _SEED, chain_hash
from repro_torch.serve.workload import ArrivalEvent, refuse_tp

__all__ = ["ReplicaRouter"]


class ReplicaRouter:
    """Fan a request stream across engine replicas with prefix affinity.

    ``engines``: the replicas. For affinity routing they must all be PAGED
    with one common page_size (the header key is page-aligned); a mixed or
    dense tier must run with ``affinity=False`` (pure least-loaded +
    round-robin tie-break).

    ``header_pages``: how many leading full pages feed the affinity key.
    Small on purpose — the shared-header traffic the router exists for
    (system prompts, few-shot preambles) concentrates its reuse in the
    first pages, and a short key makes near-miss headers (equal first
    pages, diverging later) still colocate where the index can alias their
    common prefix.

    ``queue_limit``: per-replica waiting-queue depth that triggers spill,
    then shed. None = never spill or shed (pure affinity).
    """

    def __init__(self, engines: List, *, affinity: bool = True,
                 header_pages: int = 4, queue_limit: Optional[int] = None):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)
        self.affinity = bool(affinity)
        self.header_pages = int(header_pages)
        self.queue_limit = queue_limit
        if self.affinity:
            sizes = {getattr(e, "page_size", None) for e in self.engines}
            if len(sizes) != 1 or None in sizes:
                raise ValueError(
                    "prefix-affinity routing needs paged replicas sharing "
                    f"one page_size (got {sorted(map(str, sizes))}); build "
                    "the tier uniformly or pass affinity=False")
            self.page_size = sizes.pop()
        else:
            self.page_size = getattr(self.engines[0], "page_size", None)
        n = len(self.engines)
        self._rr = 0                       # round-robin cursor (affinity off)
        self.routed = [0] * n              # submissions accepted per replica
        self.sheds = [0] * n               # shed at the door, per wanted replica
        self.spills = 0                    # affinity target over limit, rerouted
        self.affine = 0                    # routed by header key
        self.headerless = 0                # routed least-loaded (no full page)

    # ------------------------------------------------------------ routing
    def header_key(self, prompt) -> Optional[bytes]:
        """Page-aligned header digest (None if no full page): the chain
        hash of the prompt's first ``header_pages`` full pages — byte-equal
        to the chain key ``PrefixIndex`` files those pages under."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        n_pages = min(len(prompt) // ps, self.header_pages)
        if n_pages <= 0:
            return None
        h = _SEED
        for p in range(n_pages):
            h = chain_hash(h, prompt[p * ps:(p + 1) * ps])
        return h

    def load(self, i: int) -> int:
        """Replica load = queued + occupying a slot (prefilling/decoding)."""
        e = self.engines[i]
        return e.scheduler.waiting + e.active

    def _least_loaded(self, candidates) -> int:
        # round-robin cursor breaks load ties so an idle tier still spreads
        return min(candidates, key=lambda i: (self.load(i), (i - self._rr)
                                              % len(self.engines)))

    def _rendezvous(self, key: bytes) -> int:
        scores = [hashlib.blake2b(key + i.to_bytes(4, "little"),
                                  digest_size=8).digest()
                  for i in range(len(self.engines))]
        return max(range(len(self.engines)), key=lambda i: scores[i])

    def pick(self, prompt) -> int:
        """The replica this prompt WANTS (before back-pressure)."""
        if not self.affinity:
            want = self._rr % len(self.engines)
            return want
        key = self.header_key(prompt)
        if key is None:
            return self._least_loaded(range(len(self.engines)))
        return self._rendezvous(key)

    def submit(self, prompt, gen_len: int, priority: int = 0,
               deadline: Optional[float] = None):
        """Route + submit. Returns ``(request, replica_idx)``, or None when
        the whole tier is saturated (the request is shed, not queued)."""
        want = self.pick(prompt)
        target = want
        if self.affinity:
            if self.header_key(prompt) is None:
                self.headerless += 1
            else:
                self.affine += 1
        lim = self.queue_limit
        if lim is not None and self.engines[target].scheduler.waiting >= lim:
            under = [i for i in range(len(self.engines))
                     if self.engines[i].scheduler.waiting < lim]
            if not under:
                self.sheds[want] += 1
                return None
            target = self._least_loaded(under)
            if target != want:
                self.spills += 1
        req = self.engines[target].submit(prompt, gen_len, priority=priority,
                                          deadline=deadline)
        self.routed[target] += 1
        self._rr += 1
        return req, target

    # ------------------------------------------------------------ driving
    @property
    def pending(self) -> bool:
        return any(e.scheduler.waiting or e.active for e in self.engines)

    def step(self) -> int:
        """One tick across the tier: every replica with work advances once.
        Returns the number of replicas still busy."""
        busy = 0
        for e in self.engines:
            if e.scheduler.waiting or e.active:
                e.step()
                busy += 1
        return busy

    def drain(self, max_ticks: int = 100_000) -> None:
        ticks = 0
        while self.pending:
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"router drain exceeded {max_ticks} ticks")

    def replay(self, events: List[ArrivalEvent],
               slo: Optional[SLO] = None) -> ReplaySummary:
        """Open-loop replay of a workload stream across the tier (the
        multi-replica twin of ``workload.replay``): events submit at their
        arrival offsets against a real clock, every busy replica ticks in
        between, shed events are dropped at the door. Returns a
        :class:`ReplaySummary` whose top level is the POOLED tier summary
        (percentiles/goodput over every replica's records — the same shape
        the single-engine replay returns) with the per-replica breakdown,
        router counters, and router-shed count attached; the historical
        ``result["replicas"][i]`` / ``result["router"]`` /
        ``result["shed_at_router"]`` indexing still works. Refuses
        tensor-parallel replicas, as ``workload.replay`` does."""
        for e in self.engines:
            refuse_tp(e)
        ev = sorted(events, key=lambda e: e.t)
        for e in self.engines:
            e.metrics.on_start()
        t0 = time.monotonic()
        i = 0
        shed = 0
        while i < len(ev) or self.pending:
            now = time.monotonic() - t0
            while i < len(ev) and ev[i].t <= now:
                if self.submit(ev[i].prompt, ev[i].gen_len,
                               priority=ev[i].priority) is None:
                    shed += 1
                i += 1
            if not self.step() and i < len(ev):
                time.sleep(min(0.010, max(0.0, ev[i].t - (time.monotonic()
                                                          - t0))))
        for e in self.engines:
            e.metrics.on_stop()
        return ReplaySummary(
            metrics=merged_summary([e.metrics for e in self.engines], slo),
            replicas=[ReplaySummary(metrics=e.metrics.summary(slo))
                      for e in self.engines],
            router=self.stats(),
            shed_at_router=shed,
        )

    def stats(self) -> dict:
        return {
            "routed": list(self.routed),
            "sheds": list(self.sheds),
            "spills": self.spills,
            "affine": self.affine,
            "headerless": self.headerless,
        }
