"""A copy of ``repro/runtime/fault.py`` (plain Python).

Fault tolerance & straggler mitigation for long multi-pod runs.

On real fleets, failures surface as (a) raised exceptions / lost heartbeats
from a host, (b) tail-latency steps from a degrading chip. This module gives
the train loop:

  * StragglerDetector — robust per-step-time tracker (median/MAD z-score).
    On TPU fleets the action hook triggers a re-slice request; here it logs
    and records, and the policy object is what tests exercise.
  * RestartPolicy — bounded exponential backoff restart budget.
  * run_with_recovery — drives step_fn with checkpoint/restore + restart
    accounting; simulated-failure tests kill a step and assert bitwise resume.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

log = logging.getLogger("repro_torch.fault")


class StragglerDetector:
    """Flags steps whose duration is a z-score outlier vs the trailing window
    (median/MAD — robust to the compile-step spike)."""

    def __init__(self, window: int = 50, z_threshold: float = 4.0,
                 min_steps: int = 10, action: Optional[Callable] = None):
        self.window = window
        self.z = z_threshold
        self.min_steps = min_steps
        self.times: List[float] = []
        self.flagged: List[int] = []
        self.action = action
        self._step = 0

    def record(self, duration_s: float) -> bool:
        self.times.append(duration_s)
        self.times = self.times[-self.window:]
        self._step += 1
        if len(self.times) < self.min_steps:
            return False
        med = _median(self.times)
        mad = _median([abs(t - med) for t in self.times]) or 1e-9
        is_straggler = (duration_s - med) / (1.4826 * mad) > self.z
        if is_straggler:
            self.flagged.append(self._step)
            log.warning("straggler step %d: %.3fs vs median %.3fs",
                        self._step, duration_s, med)
            if self.action:
                self.action(self._step, duration_s, med)
        return is_straggler


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    restarts: int = 0

    def on_failure(self, exc: BaseException) -> float:
        """Returns backoff seconds, or raises if the budget is exhausted."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted ({self.max_restarts})") from exc
        return self.backoff_s * (self.backoff_mult ** (self.restarts - 1))


def run_with_recovery(*, num_steps: int, step_fn: Callable[[int], dict],
                      save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      checkpoint_every: int = 50,
                      policy: Optional[RestartPolicy] = None,
                      detector: Optional[StragglerDetector] = None,
                      sleep=time.sleep) -> dict:
    """Checkpointed step loop: on any step exception, back off, restore the
    latest checkpoint, and continue from its step. Returns run stats."""
    policy = policy or RestartPolicy()
    detector = detector or StragglerDetector()
    step = restore_fn()
    failures = 0
    while step < num_steps:
        try:
            t0 = time.time()
            step_fn(step)
            detector.record(time.time() - t0)
            step += 1
            if step % checkpoint_every == 0 or step == num_steps:
                save_fn(step)
        except Exception as exc:   # noqa: BLE001 — any step failure
            failures += 1
            backoff = policy.on_failure(exc)
            log.warning("step %d failed (%s); restoring after %.1fs",
                        step, exc, backoff)
            sleep(backoff)
            step = restore_fn()
    return {"final_step": step, "failures": failures,
            "restarts": policy.restarts, "stragglers": len(detector.flagged)}
