"""The badput taxonomy: classify every wall-clock second of a run.

The port's copy of ``tpu_ddp/ledger/taxonomy.py``, with the JAX
categories (``compile`` included, at 0 s on a port run) so the JSON
shape is the JAX one.

The ledger's contract is an *accounting identity*: the category seconds
sum to the elapsed wall-clock (last evidence of the final incarnation
minus the first incarnation's start anchor) exactly, by construction —
the residual no span explains is attributed to ``host_overhead``
instead of vanishing, and a dead incarnation's quiet tail is ``stall``
up to its last evidence, then ``restart_gap`` until the next life's
anchor. A breakdown that doesn't sum is a breakdown that hides badput.

Category definitions and their evidence sources live in ``CATEGORIES``
(the single source behind the report table and docs/goodput.md's
taxonomy table, mirroring the lint/alert registries' pattern).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

from tpu_ddp_torch.ledger.advisor import mtbf_seconds, recommend_interval
from tpu_ddp_torch.ledger.stitch import StitchedRun

#: exit classes that count as FAILURES for MTBF: the run did not choose
#: to stop (preemption is the environment's choice, not the run's;
#: an OOM is the program hitting the HBM wall — docs/memory.md)
FAILURE_EXITS = ("killed", "hang", "preempted", "oom")

#: exit classes whose post-span tail is deliberate shutdown work (drain,
#: final checkpoint, sink flush) rather than a dead process's silence
_DRAINED_EXITS = ("clean", "preempted", "health_halt")


@dataclasses.dataclass(frozen=True)
class Category:
    name: str
    title: str
    evidence: str


#: the fixed taxonomy, in report order. Every classified second belongs
#: to exactly one category; the report's total row re-derives elapsed.
CATEGORIES = (
    Category("productive", "productive compiled steps",
             "compiled_step + device_sync spans, minus compile and "
             "replayed shares"),
    Category("replayed", "replayed work (rewound to checkpoint)",
             "step-range overlap between incarnation k-1's last executed "
             "step and incarnation k's resume step"),
    Category("compile", "XLA compilation",
             "jax/compile_seconds counter delta within the incarnation "
             "(compiles run inside the first compiled_step spans)"),
    Category("checkpoint_save", "checkpoint save",
             "checkpoint + checkpoint_wait spans"),
    Category("checkpoint_restore", "checkpoint restore",
             "checkpoint_restore span + checkpoint/restore_seconds"),
    Category("data_wait", "input pipeline wait", "data_wait spans"),
    Category("eval", "evaluation", "eval spans"),
    Category("host_overhead", "host overhead",
             "h2d / metrics-fetch / other host spans, plus all "
             "in-incarnation wall-clock no span accounts for"),
    Category("stall", "stall (dead incarnation's stale tail)",
             "gap between a non-drained incarnation's last span and its "
             "last evidence (trace tail, heartbeat file)"),
    Category("restart_gap", "restart gap",
             "last evidence of incarnation k-1 to incarnation k's "
             "wall-clock anchor"),
)

CATEGORY_NAMES = tuple(c.name for c in CATEGORIES)


@dataclasses.dataclass
class IncarnationEntry:
    """One incarnation's ledger line (the per-incarnation timeline)."""

    index: int
    start_offset_s: float
    elapsed_s: float
    exit: str
    steps: int
    first_step: Optional[int]
    executed_through: Optional[int]
    replayed_steps: int
    restart_gap_before_s: float
    categories: Dict[str, float]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RunLedger:
    """The stitched run's full accounting — what the report renders and
    ``--json`` serializes."""

    run_dir: str
    run_id: Optional[str]
    strategy: Optional[str]
    elapsed_s: float
    categories: Dict[str, float]
    goodput_fraction: float
    incarnations: List[IncarnationEntry]
    total_steps: int
    replayed_steps: int
    total_images: float
    replayed_images: float
    raw_images_per_sec: Optional[float]
    effective_images_per_sec: Optional[float]
    n_failures: int
    mtbf_s: Optional[float]
    checkpoint_cost_s: Optional[float]
    checkpoint_count: int
    recommendation: Optional[dict]
    notes: List[str]
    # run identity carried from the metadata header so the --json
    # artifact is perf-registry-recordable with full provenance
    # (device series + commit to bisect from; docs/registry.md)
    device_kind: Optional[str] = None
    torch_version: Optional[str] = None
    git_commit: Optional[str] = None
    git_dirty: Optional[bool] = None

    @property
    def category_presence(self) -> Dict[str, int]:
        """1 per BADPUT category carrying time — the regression-gate
        signal (a fresh ``restart_gap`` appearing in a CI artifact means
        the benched run started failing, whatever the wall-clock says).
        ``productive`` is deliberately excluded: its presence is good
        news, and the goodput_fraction gate already covers its size."""
        return {name: 1 for name in CATEGORY_NAMES
                if name != "productive"
                and self.categories.get(name, 0.0) > 1e-9}

    @property
    def exit_counts(self) -> Dict[str, int]:
        """{exit class: incarnation count} — ``bench compare`` gates
        the FAILURE classes with union-of-keys semantics (REG003
        style): a fresh ``oom``/``hang`` key appearing in a CI ledger
        artifact is a regression exactly like a fresh badput
        category, whatever the wall-clock says."""
        out: Dict[str, int] = {}
        for entry in self.incarnations:
            out[entry.exit] = out.get(entry.exit, 0) + 1
        return out


def _per_incarnation(inc, prev, notes) -> IncarnationEntry:
    """Classify one incarnation's window; exactness is per-window:
    categories sum to its elapsed + the gap before it."""
    elapsed = inc.elapsed_s
    cats = {name: 0.0 for name in CATEGORY_NAMES}
    for bucket, secs in inc.buckets.items():
        if bucket != "step":
            cats[bucket] = cats.get(bucket, 0.0) + secs
    pool = inc.buckets.get("step", 0.0)
    compile_s = min(inc.compile_seconds, pool)
    # replayed: the steps this life re-executed because resume rewound
    # to the last checkpoint — evidence is pure step-range overlap
    replayed_steps = 0
    if (prev is not None and prev.executed_through is not None
            and inc.first_step is not None):
        replayed_steps = max(0, prev.executed_through - inc.first_step)
    per_step = (pool - compile_s) / inc.steps if inc.steps else 0.0
    replayed_s = min(replayed_steps * per_step, max(pool - compile_s, 0.0))
    cats["compile"] = compile_s
    cats["replayed"] = replayed_s
    cats["productive"] = max(pool - compile_s - replayed_s, 0.0)
    # stall: a non-drained life's quiet tail between its last span and
    # its last evidence (the heartbeat a hung process kept on disk)
    if inc.exit not in _DRAINED_EXITS and inc.last_span_end_wall:
        cats["stall"] = max(
            0.0, (inc.end_wall or 0.0) - inc.last_span_end_wall)
    attributed = sum(cats.values())
    residual = elapsed - attributed
    if residual >= 0:
        cats["host_overhead"] += residual
    else:
        # spans (threads) overlapped the window; scale the span-derived
        # categories down so the identity holds and say so
        scale_base = attributed - cats["stall"]
        if scale_base > 0:
            factor = max(elapsed - cats["stall"], 0.0) / scale_base
            for name in CATEGORY_NAMES:
                if name != "stall":
                    cats[name] *= factor
            notes.append(
                f"incarnation {inc.index}: span time exceeded the "
                f"window by {-residual:.2f}s (overlapping spans); "
                "categories scaled to preserve the sum identity")
    gap = 0.0
    if prev is not None and prev.end_wall is not None:
        gap = max(0.0, inc.start_wall - prev.end_wall)
        cats["restart_gap"] = gap
    return IncarnationEntry(
        index=inc.index,
        start_offset_s=0.0,   # filled by build_ledger (needs run start)
        elapsed_s=elapsed,
        exit=inc.exit,
        steps=inc.steps,
        first_step=inc.first_step,
        executed_through=inc.executed_through,
        replayed_steps=replayed_steps,
        restart_gap_before_s=gap,
        categories=cats,
    )


def build_ledger(run: StitchedRun) -> RunLedger:
    """StitchedRun -> RunLedger. The sum identity is enforced here: any
    floating drift between the per-incarnation windows and the run's
    end-to-end elapsed is folded into host_overhead (and it is tiny —
    the windows tile the timeline by construction)."""
    notes: List[str] = []
    incs = run.incarnations
    for inc in incs:
        notes.extend(inc.notes)
    # clamp overlapping windows (clock skew between lives) so the tiles
    # never double-count: a life's evidence cannot outlive its successor
    for prev, nxt in zip(incs, incs[1:]):
        if (prev.end_wall is not None and nxt.start_wall is not None
                and prev.end_wall > nxt.start_wall):
            notes.append(
                f"incarnation {prev.index}: evidence overlaps the next "
                "life's anchor; clamped")
            prev.end_wall = nxt.start_wall
            if (prev.last_span_end_wall or 0.0) > prev.end_wall:
                prev.last_span_end_wall = prev.end_wall
    entries: List[IncarnationEntry] = []
    prev = None
    for inc in incs:
        entries.append(_per_incarnation(inc, prev, notes))
        prev = inc
    start = run.start_wall or 0.0
    for inc, entry in zip(incs, entries):
        entry.start_offset_s = (inc.start_wall or start) - start
    elapsed = max(0.0, (run.end_wall or start) - start)
    totals = {name: sum(e.categories.get(name, 0.0) for e in entries)
              for name in CATEGORY_NAMES}
    drift = elapsed - sum(totals.values())
    totals["host_overhead"] += drift
    if abs(drift) > 0.05 * max(elapsed, 1e-9):
        notes.append(
            f"timeline drift of {drift:.2f}s folded into host_overhead "
            "(evidence gaps between windows)")
    goodput = totals["productive"] / elapsed if elapsed > 0 else 0.0

    total_steps = sum(i.steps for i in incs)
    replayed_steps = sum(e.replayed_steps for e in entries)
    total_images = sum(i.images for i in incs)
    replayed_images = 0.0
    for inc, entry in zip(incs, entries):
        if entry.replayed_steps and inc.steps:
            replayed_images += entry.replayed_steps * (
                inc.images / inc.steps)
    raw_ips = total_images / elapsed if elapsed > 0 and total_images \
        else None
    eff_ips = ((total_images - replayed_images) / elapsed
               if elapsed > 0 and total_images else None)

    n_failures = sum(1 for i in incs if i.exit in FAILURE_EXITS)
    mtbf = mtbf_seconds(elapsed, n_failures)
    ckpt_durs = [c["dur_s"] for i in incs for c in i.checkpoints
                 if isinstance(c.get("dur_s"), (int, float))]
    ckpt_walls = sorted(c["wall"] for i in incs for c in i.checkpoints
                        if isinstance(c.get("wall"), (int, float)))
    ckpt_cost = statistics.median(ckpt_durs) if ckpt_durs else None
    current_interval = None
    if len(ckpt_walls) >= 2:
        deltas = [b - a for a, b in zip(ckpt_walls, ckpt_walls[1:])
                  if b > a]
        if deltas:
            current_interval = statistics.median(deltas)
    steps_per_sec = None
    step_pool = sum(i.buckets.get("step", 0.0) for i in incs)
    compile_total = totals["compile"]
    if total_steps and step_pool - compile_total > 0:
        steps_per_sec = total_steps / (step_pool - compile_total)
    recommendation = recommend_interval(
        checkpoint_cost_s=ckpt_cost,
        mtbf_s=mtbf,
        steps_per_sec=steps_per_sec,
        current_interval_s=current_interval,
    )

    meta = run.run_meta or {}
    return RunLedger(
        run_dir=run.run_dir,
        run_id=meta.get("run_id"),
        strategy=meta.get("strategy"),
        elapsed_s=elapsed,
        categories=totals,
        goodput_fraction=goodput,
        incarnations=entries,
        total_steps=total_steps,
        replayed_steps=replayed_steps,
        total_images=total_images,
        replayed_images=replayed_images,
        raw_images_per_sec=raw_ips,
        effective_images_per_sec=eff_ips,
        n_failures=n_failures,
        mtbf_s=mtbf,
        checkpoint_cost_s=ckpt_cost,
        checkpoint_count=len(ckpt_walls),
        recommendation=recommendation,
        notes=notes,
        device_kind=meta.get("device_kind"),
        torch_version=meta.get("torch_version"),
        git_commit=meta.get("git_commit"),
        git_dirty=meta.get("git_dirty"),
    )
