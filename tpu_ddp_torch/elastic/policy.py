"""Restart policy: failure class -> action, with bounded backoff.

The port's copy of ``tpu_ddp/elastic/policy.py``.

The two failure modes a naive restart loop gets wrong, both fatal in
their own way:

- **Crash-looping a poisoned config.** A run that dies the same way
  every time (OOM on a layout that doesn't fit, a NaN'd recipe under
  ``--health-policy halt``, a config typo) must STOP — every restart
  replays the checkpoint window, burns the fleet, and hides the real
  bug under restart noise. Hence per-class budgets, tight for the
  classes that indicate the *program* is at fault (``oom``), zero for
  deliberate stops (``health_halt``), generous only where the
  *environment* is at fault.
- **Giving up on a preemption.** A preemption says nothing about the
  program; the Young–Daly analysis in the goodput ledger already prices
  its cost, and the only wrong response is not coming back. Hence the
  effectively-unbounded ``preempted`` budget.

Backoff is exponential with deterministic jitter (seeded per (class,
attempt) — replayable in tests, still de-synchronized across
supervisors restarting a shared-filesystem fleet). Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, Mapping, Optional

#: per-failure-class restart budgets (attempts AFTER which the
#: supervisor stops). Keys are the goodput ledger's exit taxonomy
#: (ledger/stitch.py) plus the supervisor's own `spawn_failure` (the
#: child died before writing any trace — argv/env/import trouble, which
#: retrying rarely fixes).
DEFAULT_BUDGETS: Dict[str, int] = {
    "preempted": 1_000_000,  # the environment's choice; always return
    "killed": 5,             # host loss / SIGKILL: restart, but a run
                             # that keeps dying killed is suspicious
    "hang": 3,               # wedged runtime (watchdog-abort escalation)
    "oom": 1,                # one retry covers a transient allocator
                             # race; repeat OOM = the layout does not fit
    "health_halt": 0,        # a deliberate drain: the recipe is sick,
                             # restarting replays the sickness
    "spawn_failure": 2,
}


def parse_budgets(text: Optional[str]) -> Dict[str, int]:
    """``"killed=3,hang=1"`` -> budget overrides merged over the
    defaults; refuses unknown classes by name so a typo'd class fails
    the launch instead of silently never matching."""
    budgets = dict(DEFAULT_BUDGETS)
    if not text:
        return budgets
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--max-restarts entry {part!r} is not class=N")
        klass, _, value = part.partition("=")
        klass = klass.strip()
        if klass not in DEFAULT_BUDGETS:
            raise ValueError(
                f"--max-restarts names unknown failure class {klass!r}; "
                f"known classes: {', '.join(sorted(DEFAULT_BUDGETS))}")
        budgets[klass] = int(value)
    return budgets


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with deterministic jitter."""

    base_s: float = 1.0
    cap_s: float = 60.0
    jitter_frac: float = 0.25
    seed: int = 0

    def delay_s(self, exit_class: str, attempt: int) -> float:
        """Backoff before restart ``attempt`` (1-based) of
        ``exit_class``. Preemptions skip the exponential ramp — they are
        not the program's fault, and the first restart after each
        preemption should be prompt."""
        if attempt < 1:
            return 0.0
        exponent = 0 if exit_class == "preempted" else attempt - 1
        delay = min(self.base_s * (2 ** exponent), self.cap_s)
        rng = random.Random(f"{self.seed}:{exit_class}:{attempt}")
        return delay * (1.0 + rng.uniform(0.0, self.jitter_frac))


@dataclasses.dataclass(frozen=True)
class Decision:
    """One policy verdict, ready for the ``elastic.jsonl`` record."""

    action: str                # "restart" | "stop"
    exit_class: str
    attempt: int               # 1-based restart attempt for this class
    backoff_s: float
    reason: str


class RestartPolicy:
    """Per-class budget accounting + backoff: the supervisor asks it one
    question per death."""

    def __init__(self, budgets: Optional[Mapping[str, int]] = None,
                 backoff: Optional[BackoffPolicy] = None):
        self.budgets = dict(DEFAULT_BUDGETS)
        if budgets:
            self.budgets.update(budgets)
        self.backoff = backoff or BackoffPolicy()
        self.attempts: Dict[str, int] = {}

    def decide(self, exit_class: str) -> Decision:
        """Record one death of ``exit_class`` and decide. Unknown
        classes (a future taxonomy entry) get the conservative treatment
        of the tightest bounded class: one attempt."""
        budget = self.budgets.get(exit_class, 1)
        attempt = self.attempts.get(exit_class, 0) + 1
        self.attempts[exit_class] = attempt
        if budget <= 0:
            return Decision(
                action="stop", exit_class=exit_class, attempt=attempt,
                backoff_s=0.0,
                reason=(f"{exit_class!r} has a zero restart budget "
                        "(a deliberate stop must stay stopped)"))
        if attempt > budget:
            return Decision(
                action="stop", exit_class=exit_class, attempt=attempt,
                backoff_s=0.0,
                reason=(f"restart budget exhausted for {exit_class!r} "
                        f"({budget} attempt"
                        f"{'s' if budget != 1 else ''}): a run that "
                        "keeps dying the same way is a poisoned config, "
                        "not bad luck"))
        return Decision(
            action="restart", exit_class=exit_class, attempt=attempt,
            backoff_s=self.backoff.delay_s(exit_class, attempt),
            reason=(f"{exit_class!r} restart {attempt}/{budget}"))
