"""Request queue for the serving engine: priority levels, FIFO within a
level, O(log n) admission. The engine pops a request the moment a batch slot
frees (continuous batching); nothing here touches device state.

A copy of ``repro/serve/scheduler.py``: the port imports nothing of
``repro``, and this module must order requests exactly as the reference
does for the greedy streams of the two engines to match.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import math
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"     # slot + pages reserved, prompt being chunked
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"             # prefill dispatch raised; resources released
    CANCELLED = "cancelled"       # caller aborted; resources released


@dataclasses.dataclass
class Request:
    """One generation request. ``priority`` is ascending: 0 is served before
    1 (think nice levels); equal priorities are FIFO by submission order."""
    rid: int
    prompt: np.ndarray            # (prompt_len,) int token ids
    gen_len: int
    priority: int = 0
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # prefix-cache rows the engine's submit-time probe found for this prompt
    # (0 = none/unknown). A prefix-aware scheduler uses it as an ordering
    # HINT within a priority level; it is advisory — the authoritative
    # lookup happens again at admission.
    prefix_hint: int = 0
    # set when the request leaves via FAILED (the prefill error, stringified)
    # or CANCELLED ("cancelled") instead of completing
    error: Optional[str] = None
    # scheduler-assigned arrival sequence, set once on FIRST submit and kept
    # across re-queues: a preempted request rejoins the FIFO order at its
    # original arrival position instead of the back of its priority level
    seq: Optional[int] = None
    # count of ``tokens`` entries already folded into ``prompt`` by
    # preemption; a later preemption folds only ``tokens[folded:]`` so a
    # twice-preempted request never duplicates context
    folded: int = 0
    # absolute completion deadline (same clock the caller schedules on;
    # the scheduler only compares values). inf = no deadline — sorts after
    # every dated request under EDF and leaves pure-FIFO streams unchanged.
    deadline: float = math.inf

    @property
    def remaining(self) -> int:
        return max(0, self.gen_len - len(self.tokens))

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.gen_len


@dataclasses.dataclass(frozen=True)
class SchedPolicy:
    """Opt-in scheduling features for the serve engine. EVERY default is
    "off": an engine built with ``SchedPolicy()`` (or ``policy=None``) emits
    bit-identical greedy token streams to the pre-policy engine — the
    standing anchor discipline. Each knob is independent; the bench's burst
    cell enables them together.

    - ``drr``: deficit round-robin across concurrent prefill jobs. Each
      tick every pending job earns ``drr_quantum`` chunk-token credit and
      jobs spend credit to dispatch chunks, so one long prompt can no
      longer monopolize the per-tick chunk budget (FIFO job order is the
      off-behavior). ``drr_quantum=0`` derives the quantum from the chunk
      budget split over pending jobs.
    - ``max_consecutive_prefill_ticks``: decode-starvation guard. After N
      consecutive ticks in which prefill dispatched work while slots were
      decoding, one tick skips prefill so running requests always make
      token progress under sustained admission pressure. 0 disables.
    - ``preemption``: under pool pressure, pause the lowest-priority
      RUNNING slot (strictly lower than the queue head), release its pages
      and re-queue it recompute-style — generated tokens fold into the
      prompt and re-prefill on re-admission (pages are cheap to release/
      alias; KV is reproducible). The request keeps its arrival ``seq``.
    - ``admission_low_water`` / ``admission_shed_priority``: admission
      control. When the free-page fraction drops below the low-water mark,
      queued requests at ``priority >= admission_shed_priority`` are shed
      (FAILED, ``admission_shed=True``) or deferred in place (False)
      instead of admitted. ``low_water=0.0`` disables.
    """
    drr: bool = False
    drr_quantum: int = 0
    max_consecutive_prefill_ticks: int = 0
    preemption: bool = False
    admission_low_water: float = 0.0
    admission_shed_priority: Optional[int] = None
    admission_shed: bool = True
    # SLO-aware admission ordering: earliest-deadline-first WITHIN a
    # priority level (priority still dominates; undated requests keep FIFO
    # among themselves behind every dated one). Off = pure FIFO, the
    # bit-exact anchor.
    edf: bool = False


class Scheduler:
    """Priority + FIFO admission queue, optionally prefix-aware.

    ``submit`` pushes; ``next_request`` pops the lowest (priority, hint
    rank, deadline key, seq) tuple. A monotone sequence number breaks ties
    so equal-priority requests leave in arrival order and the heap never
    compares Request objects directly. The sequence number is assigned once
    per request and survives re-queues (preemption), so a paused request
    keeps its arrival position. ``edf=True`` (SchedPolicy.edf) makes the
    deadline key ``Request.deadline`` — earliest-deadline-first within a
    (priority, hint-rank) class, with undated (inf) requests in FIFO order
    behind the dated ones; off, the key is constant and ordering is the
    exact pre-EDF FIFO.

    Lazily-cancelled requests (``cancel()`` flips a QUEUED request to
    CANCELLED without touching the heap) are pruned here, at the single
    source of truth: ``peek``/``next_request`` skip dead heads and
    ``waiting``/``__len__``/``__bool__`` count only live entries, so every
    consumer agrees and no caller needs its own skip loop.

    ``prefix_aware=True`` turns ``Request.prefix_hint`` (set by the engine's
    submit-time prefix-cache probe) into an ordering HINT: within a priority
    level, requests whose prompt prefix is already cached admit first —
    their pages are resident NOW, and serving them before the cache churns
    converts the hint into real skipped prefill. Strict FIFO is preserved
    within each (priority, hinted?) class, and the default (False) keeps
    the exact PR 1 ordering semantics.

    FAIRNESS: the hint ages. Each time a hinted request pops ahead of an
    older unhinted request of the same priority the bypass counter ticks;
    after ``hint_max_bypasses`` consecutive bypasses the OLDEST bypassed
    unhinted request is promoted to the hinted rank (keeping its seq), so a
    sustained cached-header stream can delay a cold prompt by at most
    ``hint_max_bypasses`` admissions instead of forever. Priorities still
    dominate the hint and have no aging ("think nice levels").
    """

    def __init__(self, prefix_aware: bool = False,
                 hint_max_bypasses: int = 4, edf: bool = False):
        self._heap: list = []
        self._seq = itertools.count()
        self.prefix_aware = prefix_aware
        self.hint_max_bypasses = hint_max_bypasses
        self.edf = edf
        self._bypasses = 0            # consecutive hinted-over-unhinted pops

    def _rank(self, req: Request) -> int:
        if not self.prefix_aware:
            return 0
        return 0 if req.prefix_hint > 0 else 1

    def _dkey(self, req: Request) -> float:
        """EDF sort key between (priority, hint-rank) and arrival seq: the
        request deadline when EDF is on, a constant otherwise (ordering then
        falls through to seq — exact FIFO, the anchor behavior). Undated
        requests carry deadline=inf, so among themselves they stay FIFO and
        every dated request overtakes them within the priority level."""
        return req.deadline if self.edf else 0.0

    def submit(self, req: Request) -> Request:
        if req.state != RequestState.QUEUED:
            raise ValueError(f"request {req.rid} is {req.state}, not QUEUED")
        if req.seq is None:
            req.seq = next(self._seq)
        heapq.heappush(self._heap,
                       (req.priority, self._rank(req), self._dkey(req),
                        req.seq, req))
        return req

    def _prune(self):
        """Drop lazily-cancelled entries from the heap head so peek/pop
        never surface a dead request."""
        while self._heap and \
                self._heap[0][-1].state is RequestState.CANCELLED:
            heapq.heappop(self._heap)

    def _age_hint(self, popped_prio: int, popped_rank: int, popped_seq: int):
        """Hint aging: count pops where a hinted request bypasses an older
        unhinted request of the same priority; at the bound, promote the
        oldest such victim to the hinted rank (seq preserved) and reset."""
        if not self.prefix_aware or self.hint_max_bypasses <= 0:
            return
        if popped_rank != 0:              # an unhinted request was served:
            self._bypasses = 0            # the stream is not starving anyone
            return
        victims = [i for i, (p, rank, dk, seq, r) in enumerate(self._heap)
                   if p == popped_prio and rank == 1 and seq < popped_seq
                   and r.state is not RequestState.CANCELLED]
        if not victims:
            self._bypasses = 0
            return
        self._bypasses += 1
        if self._bypasses < self.hint_max_bypasses:
            return
        oldest = min(victims, key=lambda i: self._heap[i][3])
        prio, _, dk, seq, req = self._heap[oldest]
        self._heap[oldest] = (prio, 0, dk, seq, req)
        heapq.heapify(self._heap)
        self._bypasses = 0

    def next_request(self) -> Optional[Request]:
        self._prune()
        if not self._heap:
            return None
        prio, rank, dk, seq, req = heapq.heappop(self._heap)
        self._age_hint(prio, rank, seq)
        return req

    def peek(self) -> Optional[Request]:
        """Head of the queue WITHOUT popping — the engine's paged admission
        peeks first so a request that cannot be covered by the free-page list
        defers in place (strict priority/FIFO order, no skip-ahead) instead of
        being popped and stranded."""
        self._prune()
        if not self._heap:
            return None
        return self._heap[0][-1]

    @property
    def waiting(self) -> int:
        # O(n): lazily-cancelled entries deeper in the heap must not count.
        # Queues here are small (hundreds at most) and the engine polls this
        # once per tick, so the scan is cheaper than keeping a side index
        # coherent with engine-side state flips.
        return sum(1 for *_, r in self._heap
                   if r.state is not RequestState.CANCELLED)

    def __len__(self) -> int:
        return self.waiting

    def __bool__(self) -> bool:
        return any(r.state is not RequestState.CANCELLED
                   for *_, r in self._heap)
