"""Host-side sampling profiler: every thread's Python stack, at a fixed Hz.

The port's copy of ``tpu_ddp/profiler/host.py``, unchanged in what it
records and reads back. This is the half of a capture window
``torch.profiler`` cannot give: a DWT001 data-wait alert says the step
loop is input-bound, but the time is burned in *Python* (the loader
gather, a slow filesystem read inside ``next(it)``, the host-to-device
copy path) and the device trace shows only the idle gap that follows.
Sampling ``sys._current_frames`` from a daemon thread names the frame,
works on the card and on the CPU, and costs one stack walk a tick instead
of ``sys.settrace``'s tax on every call.

Only threads the interpreter runs show up. The native prefetcher's gather
threads (``native/prefetcher.cpp``) are started in C++ and never enter
Python, so ``sys._current_frames`` does not list them: their time shows
as the training thread waiting in ``BatchPrefetcher.acquire``.

Output is **folded stacks** (``thread;frame;frame;... count``, the
flamegraph.pl / speedscope interchange format) plus a self-time
top-frames table. ``parse_folded`` and ``frame_shares`` are the read-back
half the straggler diff in ``profiler/report.py`` builds on. Stdlib-only.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import Counter
from typing import Dict, List, Optional, Tuple


def _frame_token(frame) -> str:
    """One stack entry: ``func (file.py:line)`` — basename only, so folded
    lines stay readable and diffable across hosts with different roots."""
    code = frame.f_code
    return (f"{code.co_name} "
            f"({os.path.basename(code.co_filename)}:{frame.f_lineno})")


def _stack_of(frame) -> List[str]:
    """Root-first frame tokens of one thread's current stack."""
    out: List[str] = []
    while frame is not None:
        out.append(_frame_token(frame))
        frame = frame.f_back
    out.reverse()
    return out


class HostSampler:
    """Sample every live thread's stack at ``hz`` from a daemon thread.

    ``start()`` / ``stop()`` bracket a capture window; the aggregate is a
    folded-stack counter (identical stacks collapse to one line with a
    count), so memory stays bounded no matter how long the window runs.
    The sampler's own thread is excluded; every other thread is recorded
    under its thread name, so the read side can tell the main loop from
    the prefetcher or the exporter.
    """

    def __init__(self, hz: float = 97.0):
        if hz <= 0:
            raise ValueError(f"sampler hz must be > 0, got {hz}")
        self.hz = float(hz)
        self.samples = 0          # ticks taken (per-thread stacks share one)
        self._folded: Counter = Counter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HostSampler":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpu-ddp-host-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- sampling loop ----------------------------------------------------

    def _run(self) -> None:
        interval = 1.0 / self.hz
        own = threading.get_ident()
        while not self._stop.wait(interval):
            self._sample_once(own)

    def _sample_once(self, own_ident: Optional[int] = None) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        self.samples += 1
        for ident, frame in frames.items():
            if ident == own_ident:
                continue
            stack = _stack_of(frame)
            if not stack:
                continue
            key = ";".join([names.get(ident, f"thread-{ident}")] + stack)
            self._folded[key] += 1

    # -- read-back --------------------------------------------------------

    def folded(self) -> str:
        """The folded-stack text: ``thread;root;...;leaf count`` per line,
        heaviest first (flamegraph.pl / speedscope load this directly)."""
        lines = [f"{stack} {count}"
                 for stack, count in self._folded.most_common()]
        return "\n".join(lines) + ("\n" if lines else "")

    def top_frames(self, n: int = 40) -> List[dict]:
        return top_frames(dict(self._folded), n=n)


# -- folded-stack read-back (shared with the report/diff side) -------------

def parse_folded(text: str) -> Dict[str, int]:
    """``folded()`` text -> {stack: count}; tolerates blank/torn lines
    (the bundle may be read mid-write, like every JSONL in-tree)."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(count)
        except ValueError:
            continue
    return out


#: leaf-frame prefixes that mean "this thread is parked, not working" —
#: the exporter's select loop, Event/Thread waits, socket accepts. Idle
#: stacks stay in the folded record (full fidelity) but are excluded
#: from the share denominators, py-spy style: otherwise every parked
#: daemon thread contributes one sample per tick and the busy frames'
#: shares read meaninglessly small.
IDLE_LEAF_PREFIXES = (
    "select (selectors.py",
    "poll (selectors.py",
    "wait (threading.py",
    "_wait_for_tstate_lock (threading.py",
    "accept (socket.py",
    "serve_forever (socketserver.py",
)


def _is_idle_leaf(frame: str) -> bool:
    return frame.startswith(IDLE_LEAF_PREFIXES)


def _totals(folded: Dict[str, int],
            include_idle: bool = False) -> Tuple[Dict[str, int],
                                                 Dict[str, int], int]:
    """(self counts, inclusive counts, total leaf samples) per frame.
    Self = samples where the frame is the leaf; inclusive = samples where
    it appears anywhere on the stack (deduped per stack line). Stacks
    parked on an idle leaf are dropped unless ``include_idle``."""
    self_c: Dict[str, int] = {}
    incl: Dict[str, int] = {}
    total = 0
    for stack, count in folded.items():
        frames = stack.split(";")[1:]  # drop the thread-name prefix
        if not frames:
            continue
        leaf = frames[-1]
        if not include_idle and _is_idle_leaf(leaf):
            continue
        total += count
        self_c[leaf] = self_c.get(leaf, 0) + count
        for frame in set(frames):
            incl[frame] = incl.get(frame, 0) + count
    return self_c, incl, total


def top_frames(folded: Dict[str, int], *,
               n: int = 40, include_idle: bool = False) -> List[dict]:
    """Self-time-ranked frame table over a folded-stack counter. ``share``
    is of the BUSY leaf samples (idle waits excluded — see
    ``IDLE_LEAF_PREFIXES``), so a frame burning the loop reads directly
    as its fraction of working host time inside the window."""
    self_c, incl, total = _totals(folded, include_idle)
    denom = max(total, 1)
    rows = [
        {"frame": frame, "self": count, "total": incl[frame],
         "share": count / denom}
        for frame, count in self_c.items()
    ]
    rows.sort(key=lambda r: (-r["self"], r["frame"]))
    return rows[:n]


def frame_shares(folded: Dict[str, int],
                 include_idle: bool = False) -> Dict[str, float]:
    """{frame: busy self-time share} — the per-host vector the straggler
    diff compares against the fleet median."""
    self_c, _incl, total = _totals(folded, include_idle)
    denom = max(total, 1)
    return {frame: count / denom for frame, count in self_c.items()}


__all__ = [
    "HostSampler",
    "frame_shares",
    "parse_folded",
    "top_frames",
]
