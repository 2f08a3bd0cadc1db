"""``tpu-ddp-torch lint`` — the graph lint over one step that runs.

The port's counterpart of ``tpu_ddp/analysis/lint.py``, with its rule ids,
titles, thresholds (``LintConfig``), artifact and exit codes (0 clean, 1 an
error finding, 2 a usage error). The JAX lint reads three tiers of a
compiled step: the optimized HLO, the jaxpr and the source. The port
compiles no step, so, as the step anatomy does (``analysis/anatomy.py``),
the audit comes from ONE step that runs (``audit_program``): the strategy's
step built as a run builds it (``analysis/explain.py::prepare_strategy_program``;
N ranks as rank 0 against ``anatomy.fake_world``), run once under the
collective recorder (``parallel/collectives.py``) and the anatomy's
counting dispatch mode, with the storage of every state tensor taken
before and after. The pass gives the program rules what the HLO and the
jaxpr give the JAX ones:

- **DON001** in-place state: the eager counterpart of buffer donation.
  The step's new state must occupy the old state's storages: a step that
  writes a fresh tensor into a params, optimizer-state or BatchNorm leaf
  (``p.data = new``, an out-of-place ``foreach``) holds two copies of it
  through the step, as a dropped ``donate_argnums`` did to the JAX step's
  HBM. ``donation_report`` keeps the JAX keys, from the tensors (so on the
  CPU as on the card): the arguments are the rank's state and batch, the
  outputs the state after, the donated bytes those of the leaves whose
  storage survived.
- **DTY001** widening in a bfloat16 program: big float32 results of the
  matmuls and convolutions (``anatomy.PRODUCT_OPS``, above
  ``big_op_bytes``) and float32 collective payloads over ``2.5 x f32 param
  bytes + 1 MiB``. The aten dtypes are the program's own on the CPU too, so
  the JAX rule's off-CPU HLO branch (XLA:CPU widens bf16 to f32) has
  nothing of its own here.
- **SHD001** replication: for zero1, zero3, fsdp, fsdp_tp and ep, the big
  leaves of the sections the layout scatters must be held cut (the bytes
  the rank holds against the whole leaf's, ``StateLayout.leaves``), and no
  leaf the layout cuts may be held whole.
- **COL001** order and participation: every collective's group set (the
  recorder books every group of the call's axis, ``parallel/mesh.py``)
  must partition the rank grid, permute pairs must be permutations, the
  strategy's ``ORDER_PINS`` and fingerprint (``explain.check_fingerprint``)
  hold, and zero3's prefetch schedule (``BlockGather``) has one all-gather
  a parameter block, none outside it, and block k+1's gather in flight
  before block k is first used.
- **XFR001** host transfers inside the step: ``.item()``, ``bool(t)`` and
  the like (``aten._local_scalar_dense``) and device-to-host copies the
  step's own code issues; gloo's staging of the wire is left out
  (``collectives.on_wire``), as XLA's collectives never show as host
  transfers.
- **RCP001** the AST tier, as the JAX one (stdlib), with ``torch.compile``,
  ``torch.jit.script`` and ``torch.jit.trace`` beside the JAX jit names;
  ``lint_source_tree`` defaults to the ``tpu_ddp_torch`` package.
- **KRN001** kernel capability: ``--kernels`` on a CUDA device where a
  switch-level kernel's build does not load (``ops.kernel_available``)
  is one error a kernel, naming it and its plain version; the wrapper
  would raise at its first launch, and the lint refuses before it. On the
  CPU the plain versions run, the counterpart of the Pallas interpreter,
  and there is no finding.

``tpu-ddp-torch lint --strategy all`` lints every strategy's program and
the source tier; ``--json`` writes the JAX artifact (with a ``provenance``
naming ``torch_version``), whose per-rule counts ``bench compare`` gates as
``lint/<RULE>``. The trainer's ``--lint-on-start`` lints the run's own step
(``train/trainer.py::Trainer.lint_preflight``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: bump on any breaking change to the lint artifact shape
LINT_SCHEMA_VERSION = 1

#: rule registry: id -> (what it catches, the one-line fix hint)
RULES: Dict[str, Dict[str, str]] = {
    "DON001": {
        "title": "donation audit",
        "fix": "update the train state in place (p.add_, torch._foreach_*_, "
               "copy_ into the existing tensors) so the new state occupies "
               "the old state's storage",
    },
    "DTY001": {
        "title": "dtype-widening audit",
        "fix": "keep big tensor ops and collective payloads bf16 in a "
               "bf16 program (cast at the op, or raise the allowlist "
               "budget in LintConfig if the f32 traffic is deliberate)",
    },
    "SHD001": {
        "title": "replication audit",
        "fix": "lay the state out through the strategy's StateLayout "
               "(ZeRO's shards, the model or expert cut) before the step — "
               "a replicated opt-state leaf forfeits the 1/N layout ZeRO "
               "pays for",
    },
    "COL001": {
        "title": "collective order/participation audit",
        "fix": "keep ONE deterministic collective schedule: every group "
               "set must partition the rank grid, permutes must be "
               "permutations, and grads sync before params gather back",
    },
    "XFR001": {
        "title": "host-transfer audit",
        "fix": "remove .item()/bool()/.cpu() reads of device tensors from "
               "the step — read them from the host loop (or the telemetry "
               "sinks) after the step instead",
    },
    "RCP001": {
        "title": "recompile-hazard audit",
        "fix": "hoist jax.jit/torch.compile/torch.jit out of loops, keep "
               "jitted-function defaults hashable, and bake no "
               "wall-clock/np.random values into step factories",
    },
    "KRN001": {
        "title": "fused-kernel capability audit",
        "fix": "run with --kernels only where the kernels' CUDA builds load "
               "(sm_90a with nvcc), or drop the switch and run the named "
               "plain version explicitly",
    },
}


@dataclasses.dataclass
class LintFinding:
    """One rule violation. ``severity`` is ``"error"`` (fails the lint
    exit code / the preflight) or ``"warning"`` (reported only)."""

    rule: str
    severity: str
    program: str        # strategy name, or "source" for the AST tier
    message: str
    fix: str = ""
    location: str = ""  # file:line for the AST tier

    def render(self) -> str:
        loc = f" ({self.location})" if self.location else ""
        out = (f"  {self.rule} [{self.severity}] {self.program}: "
               f"{self.message}{loc}")
        if self.fix:
            out += f"\n      fix: {self.fix}"
        return out

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _finding(rule: str, program: str, message: str,
             severity: str = "error", location: str = "") -> LintFinding:
    return LintFinding(rule=rule, severity=severity, program=program,
                       message=message, fix=RULES[rule]["fix"],
                       location=location)


@dataclasses.dataclass
class LintConfig:
    """Thresholds: the JAX defaults (``tpu_ddp/analysis/lint.py``)."""

    #: DON001: non-donated output bytes allowed (step counters, small
    #: leaves); the 2% floor in check_donation scales it for big programs
    donation_slack_bytes: int = 64 * 1024
    #: DTY001: a single f32 matmul/conv result below this is allowlisted
    big_op_bytes: int = 1 << 20
    #: DTY001: total f32 collective payload allowed, as a multiple of the
    #: f32 param bytes plus a flat floor for loss/norm/moment scalars
    f32_collective_budget_factor: float = 2.5
    f32_collective_budget_floor: int = 1 << 20
    #: SHD001: a state leaf below this many global bytes is not expected
    #: to be sharded (biases, scalars)
    big_leaf_bytes: int = 8 * 1024
    #: SHD001: minimum fraction of big-leaf bytes that must be held cut in
    #: the sections the strategy scatters
    min_sharded_fraction: float = 0.5


# -- the per-program audit ------------------------------------------------

@dataclasses.dataclass
class StateLeaf:
    """One tensor of the rank's state across the audited step:
    ``held_bytes`` the rank holds, ``global_bytes`` of the whole leaf,
    ``cut`` whether the layout splits it, and its storage before and after
    the step (``ptr_before``, ``ptr_after``; ``bytes_after``)."""

    section: str
    name: str
    dtype: str
    held_bytes: int
    global_bytes: int
    cut: bool
    ptr_before: int = 0
    ptr_after: int = 0
    bytes_after: int = 0


@dataclasses.dataclass
class ProgramAudit:
    """Everything the program rules read, gathered from one step that runs
    (``audit_program``). ``schedule`` is the linearized collective schedule
    (``anatomy.collective_schedule``), ``calls`` the recorder's records
    (zero3's block gathers), ``products`` the matmul/conv results (op,
    dtype, bytes), ``host`` the host transfers, ``n_blocks`` zero3's
    parameter blocks."""

    program: str               # display/strategy label
    strategy: str              # fingerprint key
    compute_dtype: str
    mesh_shape: Dict[str, int]
    n_devices: int
    device_kind: str
    anatomy: Any               # StepAnatomy
    schedule: List[Any] = dataclasses.field(default_factory=list)
    calls: List[dict] = dataclasses.field(default_factory=list)
    leaves: List[StateLeaf] = dataclasses.field(default_factory=list)
    batch_bytes: int = 0
    products: List[Tuple[str, str, int]] = dataclasses.field(default_factory=list)
    host: List[str] = dataclasses.field(default_factory=list)
    n_blocks: int = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def audit_program(prog, *, strategy: Optional[str] = None,
                  program: Optional[str] = None, live=None) -> ProgramAudit:
    """Run ``prog`` (an ``explain.StrategyProgram``) ONE step under the
    anatomy's counting pass (``anatomy.count_step``; ``live``: its tracker
    of the bytes alive through the step, for the memory planner), the
    state's storages taken before and after, and gather the audit (module
    docstring)."""
    from tpu_ddp_torch.analysis.anatomy import (
        anatomy_from_counts,
        collective_schedule,
        count_step,
        world_axis,
    )

    strategy = strategy or prog.strategy
    before = {}
    kept = []      # the old storages, alive through the step: no address reuse
    for section, name, t, numel, cut in prog.leaves():
        kept.append(t.untyped_storage())
        before[(section, name)] = StateLeaf(
            section=section, name=name, dtype=str(t.dtype).replace("torch.", ""),
            held_bytes=_nbytes(t), global_bytes=numel * t.element_size(), cut=cut,
            ptr_before=t.untyped_storage().data_ptr())
    batch_bytes = sum(_nbytes(v) for v in (prog.batch or {}).values()
                      if hasattr(v, "element_size"))
    counts = count_step(prog.step, world=world_axis(prog.mesh), device=prog.device,
                        live=live)
    for section, name, t, _, _ in prog.leaves():
        leaf = before.get((section, name))
        if leaf is not None:
            leaf.ptr_after = t.untyped_storage().data_ptr()
            leaf.bytes_after = _nbytes(t)
    del kept
    anatomy = anatomy_from_counts(
        counts, strategy=strategy, model=prog.model_name, device_kind=prog.device_kind,
        mesh=prog.mesh, per_shard_batch=prog.per_shard_batch,
        compute_dtype=prog.compute_dtype)
    zero = prog.zero
    return ProgramAudit(
        program=program or strategy, strategy=strategy,
        compute_dtype=prog.compute_dtype, mesh_shape=dict(prog.mesh),
        n_devices=prog.n_devices, device_kind=prog.device_kind, anatomy=anatomy,
        schedule=collective_schedule(counts["calls"]), calls=counts["calls"],
        leaves=list(before.values()), batch_bytes=batch_bytes,
        products=counts["products"], host=counts["host"],
        n_blocks=len(getattr(zero, "blocks", ())) if getattr(zero, "scattered_params", False)
        else 0)


# -- DON001: in-place state -------------------------------------------------

def donation_report(audit: ProgramAudit) -> dict:
    """The accounting DON001 gates on (the JAX keys), also in
    ``tools/memplan.py``'s report: the rank's argument bytes (state +
    batch), output bytes (the state after the step), the bytes of the
    leaves whose storage survived the step (``donated_bytes``), and the
    non-donated remainder with what it should be (the batch's bytes on the
    rank). For a step that updates in place ``argument_bytes -
    donated_bytes`` is the batch's bytes exactly."""
    arg = sum(leaf.held_bytes for leaf in audit.leaves) + audit.batch_bytes
    out = sum(leaf.bytes_after for leaf in audit.leaves)
    alias = sum(leaf.bytes_after for leaf in audit.leaves
                if leaf.ptr_after == leaf.ptr_before and leaf.ptr_before)
    return {
        "argument_bytes": arg,
        "output_bytes": out,
        "donated_bytes": alias,
        "undonated_output_bytes": out - alias,
        "non_donated_bytes": arg - alias,
        "expected_non_donated_bytes": audit.batch_bytes,
    }


def check_donation(audit: ProgramAudit,
                   cfg: LintConfig) -> List[LintFinding]:
    rep = donation_report(audit)
    # every output byte whose storage is not the old state's is a state
    # byte held twice through the step
    slack = max(cfg.donation_slack_bytes, rep["output_bytes"] // 50)
    excess = rep["undonated_output_bytes"]
    if excess > slack:
        moved = sorted((leaf for leaf in audit.leaves
                        if leaf.ptr_after != leaf.ptr_before),
                       key=lambda leaf: -leaf.bytes_after)
        head = ", ".join(f"{leaf.section}/{leaf.name}" for leaf in moved[:3])
        return [_finding(
            "DON001", audit.program,
            f"train state is not (fully) donated: only "
            f"{rep['donated_bytes']} of {rep['output_bytes']} output "
            f"bytes stay in the state's storage — {excess} B of state is "
            f"double-buffered every step ({len(moved)} leaves written to "
            f"fresh tensors, largest: {head}; argument_bytes="
            f"{rep['argument_bytes']}, batch accounts for "
            f"{rep['expected_non_donated_bytes']} B of the non-donated "
            "remainder)",
        )]
    return []


# -- DTY001: dtype widening ----------------------------------------------

_WIDE = ("float32", "float64")
_WIDE_HLO = ("f32", "f64")


def check_dtype_widening(audit: ProgramAudit,
                         cfg: LintConfig) -> List[LintFinding]:
    if audit.compute_dtype != "bfloat16":
        return []
    findings: List[LintFinding] = []
    big_ops = [(op, n) for op, dtype, n in audit.products
               if dtype in _WIDE and n > cfg.big_op_bytes]
    f32_collectives = [(c["kind"], c["payload_bytes"]) for c in audit.calls
                       if c["dtype"] in _WIDE_HLO]
    if big_ops:
        big_ops.sort(key=lambda t: -t[1])
        head = ", ".join(f"{k}[{n} B]" for k, n in big_ops[:3])
        findings.append(_finding(
            "DTY001", audit.program,
            f"{len(big_ops)} f32 tensor op(s) above "
            f"{cfg.big_op_bytes} B in a bf16-compute program "
            f"(largest: {head}) — the tensor cores run them at a "
            "fraction of the bf16 rate",
        ))
    # allowlist budget: the f32 master-weight gradient sync (+ zero1's f32
    # param all-gather) is mixed-precision-correct; loss, norms, optimizer
    # moments, and health stats are all under the floor
    params_f32 = sum(leaf.global_bytes for leaf in audit.leaves
                     if leaf.section == "params" and leaf.dtype in _WIDE)
    budget = int(cfg.f32_collective_budget_factor * params_f32
                 + cfg.f32_collective_budget_floor)
    total = sum(n for _, n in f32_collectives)
    if total > budget:
        f32_collectives.sort(key=lambda t: -t[1])
        head = ", ".join(f"{k}[{n} B]" for k, n in f32_collectives[:3])
        findings.append(_finding(
            "DTY001", audit.program,
            f"f32 collective payload {total} B exceeds the "
            f"mixed-precision allowlist budget {budget} B "
            f"(2.5x f32 param bytes + 1 MiB; largest: {head}) — "
            "a widened payload halves effective link bandwidth",
        ))
    return findings


# -- SHD001: replication -------------------------------------------------

#: strategy -> (state sections whose big leaves must be held cut, mode):
#: "fraction" = at least min_sharded_fraction of big-leaf bytes;
#: "any" = at least one big leaf (ep cuts only the expert tensors)
_SHARDED_SECTIONS = {
    "zero1": (("opt_state",), "fraction"),
    "zero3": (("params", "opt_state"), "fraction"),
    "fsdp": (("params", "opt_state"), "fraction"),
    "fsdp_tp": (("params", "opt_state"), "fraction"),
    "ep": (("params",), "any"),
}


def check_replication(audit: ProgramAudit,
                      cfg: LintConfig) -> List[LintFinding]:
    spec = _SHARDED_SECTIONS.get(audit.strategy)
    findings: List[LintFinding] = []
    # leaf-wise: a leaf the layout cuts must not be held whole
    for leaf in audit.leaves:
        if leaf.global_bytes < cfg.big_leaf_bytes:
            continue
        if leaf.cut and leaf.held_bytes >= leaf.global_bytes:
            findings.append(_finding(
                "SHD001", audit.program,
                f"{leaf.section}/{leaf.name} ({leaf.global_bytes} B): the "
                "layout cuts it but the rank holds it whole",
            ))
    if spec is None:
        return findings
    sections, mode = spec
    big = [leaf for leaf in audit.leaves
           if leaf.section in sections and leaf.global_bytes >= cfg.big_leaf_bytes]
    if not big:
        return findings
    total = sum(leaf.global_bytes for leaf in big)
    sharded = sum(leaf.global_bytes for leaf in big if leaf.held_bytes < leaf.global_bytes)
    if mode == "any":
        if sharded == 0:
            findings.append(_finding(
                "SHD001", audit.program,
                f"no big {'/'.join(sections)} leaf is held cut "
                f"({len(big)} leaves, {total} B all replicated) — the "
                f"{audit.strategy} layout requires a 1/N scatter",
            ))
    elif sharded < cfg.min_sharded_fraction * total:
        findings.append(_finding(
            "SHD001", audit.program,
            f"only {sharded}/{total} B of big {'/'.join(sections)} "
            f"leaves are held cut (< "
            f"{cfg.min_sharded_fraction:.0%}) — the {audit.strategy} "
            "layout requires the 1/N scatter ZeRO pays for",
        ))
    return findings


# -- COL001: collective order / participation ----------------------------

#: strategy -> [(late kind, early kinds, why)]: the first occurrence of
#: `late` must come after the first occurrence of one of `early`
ORDER_PINS = {
    # ZeRO-1: grads reduce-scatter down, THEN params all-gather back —
    # a gather first would train on stale params
    "zero1": [("all-gather", ("reduce-scatter", "all-reduce"),
               "params must gather back AFTER the gradient sync")],
    # ZeRO-3: the step OPENS with the prefetch all-gathers (block 0's
    # params are needed before anything computes); the grad sync belongs
    # to the tail — a sync-first schedule means params were not streamed
    "zero3": [("reduce-scatter", ("all-gather",),
               "the grad reduce-scatter belongs after the prefetch "
               "all-gathers (params stream in before anything computes)"),
              ("all-reduce", ("all-gather",),
               "every sync (loss/health/grad) belongs after the first "
               "prefetch all-gather")],
}


def _check_zero3_prefetch(audit: ProgramAudit) -> List[LintFinding]:
    """The zero3 schedule contract over ``BlockGather``'s records: every
    parameter block has its own all-gather, no all-gather lives outside
    the prefetch schedule (a gather with no block, or a block gathered
    again: the backward or a second forward re-gathering), and block
    k+1's gather is in flight before block k is first used (the
    double-buffer handoff; the serialized just-in-time schedule issues
    each block's gather at its use and fails closed)."""
    findings: List[LintFinding] = []
    n_blocks = audit.n_blocks
    gathers = [c for c in audit.calls if c["kind"] == "all-gather"]
    seen: Dict[int, dict] = {}
    stray = 0
    for c in gathers:
        k = c.get("block")
        if k is None or k in seen:
            stray += 1
        else:
            seen[k] = c
    if not seen:
        findings.append(_finding(
            "COL001", audit.program,
            "zero3 prefetch schedule absent: no all-gather in the step "
            "is a parameter block's gather — the parameters were never "
            "streamed, so the double-buffered overlap the --zero3 "
            "contract promises does not exist in this program",
        ))
        return findings
    missing = sorted(set(range(n_blocks)) - set(seen))
    if missing:
        findings.append(_finding(
            "COL001", audit.program,
            f"zero3 prefetch schedule incomplete: parameter blocks "
            f"{missing} of {n_blocks} have no all-gather in the step "
            "(their params reach compute without a scheduled gather slot)",
        ))
    if stray:
        findings.append(_finding(
            "COL001", audit.program,
            f"zero3 re-gather: {stray} all-gather(s) outside the "
            "prefetch schedule — the backward (or a second forward "
            "assembly) is re-gathering full params; the zero3 contract "
            "is ONE scheduled gather per block per step, grads "
            "reduce-scatter straight into shard space",
        ))
    late = sorted(k for k, c in seen.items() if c.get("next_in_flight") is False)
    if n_blocks > 1 and late:
        findings.append(_finding(
            "COL001", audit.program,
            f"zero3 double-buffer chain broken: blocks {late} were first "
            f"used before the next block's gather was issued ({len(late)} "
            f"of {n_blocks - 1} handoffs) — the gathers are serialized "
            "just in time, nothing overlaps block k+1's gather with block "
            "k's compute",
        ))
    return findings


def check_collective_order(audit: ProgramAudit, cfg: LintConfig,
                           schedule=None) -> List[LintFinding]:
    del cfg
    findings: List[LintFinding] = []
    if schedule is None:
        schedule = audit.schedule
    n = audit.n_devices
    all_ids = frozenset(range(n))
    for entry in schedule:
        if entry.groups:
            seen: List[int] = []
            for g in entry.groups:
                seen.extend(g)
            if len(seen) != len(set(seen)) or set(seen) != all_ids:
                findings.append(_finding(
                    "COL001", audit.program,
                    f"collective #{entry.index} ({entry.kind}) replica "
                    f"groups {entry.groups} do not partition the "
                    f"{n}-device mesh — devices left out of a group set "
                    "never join the rendezvous (multihost deadlock)",
                ))
        if entry.pairs:
            srcs = [s for s, _ in entry.pairs]
            tgts = [t for _, t in entry.pairs]
            if len(set(srcs)) != len(srcs) or len(set(tgts)) != len(tgts):
                findings.append(_finding(
                    "COL001", audit.program,
                    f"collective #{entry.index} (collective-permute) "
                    f"source_target_pairs {entry.pairs} are not a "
                    "permutation (duplicated source or target)",
                ))
    # order pin against the linearized schedule
    first: Dict[str, int] = {}
    for entry in schedule:
        first.setdefault(entry.kind, entry.index)
    for late, early, why in ORDER_PINS.get(audit.strategy, ()):
        if late not in first:
            continue
        early_first = min((first[k] for k in early if k in first),
                          default=None)
        if early_first is not None and first[late] < early_first:
            findings.append(_finding(
                "COL001", audit.program,
                f"collective schedule reordered: first {late} (#"
                f"{first[late]}) precedes the first "
                f"{'/'.join(early)} (#{early_first}) — {why}",
            ))
    if audit.strategy == "zero3" and n > 1:
        findings.extend(_check_zero3_prefetch(audit))
    if n == 1:
        # one rank issues no collective (XLA elides a one-device one): the
        # pinned fingerprint and zero3's gathers have nothing to hold
        return findings
    from tpu_ddp_torch.analysis.explain import check_fingerprint

    fp = check_fingerprint(audit.anatomy, audit.strategy)
    if fp.get("ok") is False:
        for miss in fp["missing"]:
            findings.append(_finding(
                "COL001", audit.program,
                f"pinned fingerprint: required collective family "
                f"missing: {miss}",
            ))
        for extra in fp["unexpected"]:
            findings.append(_finding(
                "COL001", audit.program,
                f"pinned fingerprint: forbidden collective kind present: "
                f"{extra}",
            ))
    return findings


# -- XFR001: host transfers ----------------------------------------------

def check_host_transfers(audit: ProgramAudit,
                         cfg: LintConfig) -> List[LintFinding]:
    del cfg
    return [_finding(
        "XFR001", audit.program,
        f"host transfer inside the step: {what} — a device->host round "
        "trip per step")
        for what in audit.host]


#: the program-tier rules, in report order
PROGRAM_CHECKS = (check_donation, check_dtype_widening, check_replication,
                  check_collective_order, check_host_transfers)


def lint_program(prog, *, strategy: Optional[str] = None,
                 program: Optional[str] = None,
                 config: Optional[LintConfig] = None,
                 ) -> Tuple[List[LintFinding], ProgramAudit]:
    """Run every program-tier rule over one step program (an
    ``explain.StrategyProgram``, or anything with its fields). The unit the
    CLI, the trainer's preflight and the injected-violation tests call."""
    cfg = config or LintConfig()
    audit = audit_program(prog, strategy=strategy, program=program)
    findings: List[LintFinding] = []
    for check in PROGRAM_CHECKS:
        findings.extend(check(audit, cfg))
    return findings, audit


def lint_strategy(strategy: str, *, config: Optional[LintConfig] = None,
                  **prog_kwargs) -> Tuple[List[LintFinding], ProgramAudit]:
    """Lint one strategy's program: the step a run of it trains with
    (``explain.prepare_strategy_program``, whose keywords this accepts;
    ``n_devices`` ranks as rank 0 of a fake group when no group is up)."""
    import contextlib

    from tpu_ddp_torch.analysis.anatomy import fake_world
    from tpu_ddp_torch.analysis.explain import prepare_strategy_program
    from tpu_ddp_torch.parallel.runtime import world_size

    n = prog_kwargs.get("n_devices", 8)
    with fake_world(n) if n > 1 and world_size() == 1 else contextlib.nullcontext():
        prog = prepare_strategy_program(strategy, **prog_kwargs)
        try:
            return lint_program(prog, config=config)
        finally:
            if prog.close is not None:
                prog.close()


# -- KRN001: kernel capability ----------------------------------------------

def lint_kernels(enabled: bool, *, device: Any = "auto",
                 program: str = "kernels") -> List[LintFinding]:
    """KRN001: the ``--kernels`` switch against the device. On a CUDA
    device every switch-level kernel (``ops.KERNELS`` with a ``hint``)
    whose build does not load here (``ops.kernel_available``) is one
    error naming the kernel and its plain version: its wrapper would raise
    at the first launch. On the CPU the plain versions run (the Pallas
    interpreter's counterpart) and there is no finding. ``device``:
    ``"auto"`` is the card when there is one."""
    if not enabled:
        return []
    import torch

    from tpu_ddp_torch.ops import KERNELS, kernel_available

    if device == "auto":
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        return []
    findings: List[LintFinding] = []
    for name in sorted(KERNELS):
        entry = KERNELS[name]
        if entry["hint"] is None or kernel_available(name):
            continue   # model-level kernels are not behind this switch
        findings.append(_finding(
            "KRN001", program,
            f"kernel switch is ON but '{name}' does not build or load on "
            f"this card ({entry['source']}): its wrapper would raise at the "
            f"first launch; its plain version is {entry['plain']}",
        ))
    return findings


# -- RCP001: AST tier -----------------------------------------------------

#: CANONICAL module prefixes whose calls bake a different value into
#: every trace (local names are resolved through the module's imports
#: first, so jax.random — keyed, deterministic — never matches even when
#: imported as ``from jax import random``)
_NONDETERMINISTIC = (
    "time.time", "time.monotonic", "time.perf_counter",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "numpy.random", "random.",
)

#: the calls that build a compiled wrapper: the JAX names, then torch's
_JAX_JIT_NAMES = ("jax.jit", "jit", "jax.pmap", "pmap")
_JIT_NAMES = _JAX_JIT_NAMES + ("torch.compile", "torch.jit.script", "torch.jit.trace")


def _import_map(tree) -> Dict[str, str]:
    """local name -> canonical dotted module for every import in the
    module (``from jax import random`` -> {"random": "jax.random"})."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:  # `import a.b as c` binds c -> a.b
                    out[alias.asname] = alias.name
                else:  # `import a.b` binds the TOP name a -> a
                    head = alias.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return out


def _canonical(dotted: str, imports: Dict[str, str]) -> str:
    head, _, rest = dotted.partition(".")
    full = imports.get(head, head)
    return f"{full}.{rest}" if rest else full


def _is_nondeterministic(name: str) -> bool:
    for p in _NONDETERMINISTIC:
        if p.endswith("."):  # whole-module prefix (stdlib random)
            if name.startswith(p) or name == p[:-1]:
                return True
        elif name == p or name.startswith(p + "."):
            return True
    return False


def _dotted(node) -> str:
    """'jax.jit' for an Attribute/Name chain, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _jit_name(node) -> str:
    """The wrapper a call builds, '' when it builds none: ``jax.jit(...)``
    / ``jit(...)`` / ``pmap(...)`` read as ``jax.jit`` (the JAX rule's
    word), ``torch.compile(...)`` / ``torch.jit.script|trace(...)`` as
    themselves, and ``functools.partial`` of one as that one."""
    if not isinstance(node, ast.Call):
        return ""
    name = _dotted(node.func)
    if name in ("functools.partial", "partial") and node.args:
        name = _dotted(node.args[0])
    if name in _JAX_JIT_NAMES:
        return "jax.jit"
    return name if name in _JIT_NAMES else ""


def _is_jit_expr(node) -> bool:
    """The expression produces a fresh compiled wrapper (``_jit_name``)."""
    return bool(_jit_name(node))


def _mutable_default(node) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set,
                         ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func) in ("dict", "list", "set")
    return False


def lint_source_text(text: str, path: str = "<source>",
                     program: str = "source") -> List[LintFinding]:
    """RCP001 over one module's source (the JAX rule, stdlib). Three
    hazards: a compiled wrapper built inside a loop (a fresh wrapper per
    iteration defeats the compile cache — every call recompiles), mutable
    (unhashable) defaults on jitted functions, and wall-clock / np.random
    calls inside the step factories (a different trace-time constant per
    process is a silent cross-rank program divergence)."""
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [_finding("RCP001", program,
                         f"syntax error prevents the AST audit: {e}",
                         location=f"{path}:{e.lineno or 0}")]
    findings: List[LintFinding] = []
    fname = os.path.basename(path)
    imports = _import_map(tree)

    def visit(node, loop_depth: int, in_factory: bool):
        if isinstance(node, (ast.For, ast.While)):
            for child in ast.iter_child_nodes(node):
                visit(child, loop_depth + 1, in_factory)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for deco in node.decorator_list:
                if (_is_jit_expr(deco)
                        or _dotted(deco) in _JIT_NAMES):
                    for d in (node.args.defaults
                              + [d for d in node.args.kw_defaults if d]):
                        if _mutable_default(d):
                            findings.append(_finding(
                                "RCP001", program,
                                f"jitted function '{node.name}' has a "
                                "mutable (unhashable) default argument",
                                location=f"{fname}:{node.lineno}"))
            factory = in_factory or node.name.startswith(("make_", "build_"))
            # a new function scope resets the loop context (a jit built
            # once inside a function that is ITSELF called in a loop is
            # the factory idiom, not the hazard)
            for child in ast.iter_child_nodes(node):
                visit(child, 0, factory)
            return
        if isinstance(node, ast.Call):
            if _is_jit_expr(node) and loop_depth > 0:
                findings.append(_finding(
                    "RCP001", program,
                    f"{_jit_name(node)} built inside a loop body — a fresh "
                    "wrapper per iteration recompiles every call",
                    location=f"{fname}:{node.lineno}"))
            if in_factory:
                name = _canonical(_dotted(node.func), imports)
                if _is_nondeterministic(name):
                    findings.append(_finding(
                        "RCP001", program,
                        f"'{name}' inside a step factory bakes a "
                        "nondeterministic trace-time constant into the "
                        "program (recompiles / cross-host divergence)",
                        location=f"{fname}:{node.lineno}"))
        for child in ast.iter_child_nodes(node):
            visit(child, loop_depth, in_factory)

    visit(tree, 0, False)
    return findings


def lint_source_tree(root: Optional[str] = None) -> List[LintFinding]:
    """RCP001 over every ``.py`` under ``root`` (default: the
    ``tpu_ddp_torch`` package)."""
    if root is None:
        import tpu_ddp_torch

        root = os.path.dirname(tpu_ddp_torch.__file__)
    findings: List[LintFinding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                text = f.read()
            rel = os.path.relpath(path, root)
            file_findings = lint_source_text(text, path=path)
            for fd in file_findings:
                fd.location = fd.location.replace(name, rel, 1)
            findings.extend(file_findings)
    return findings


# -- artifact + CLI -------------------------------------------------------

def rule_counts(findings: Sequence[LintFinding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


def _program_record(findings: List[LintFinding], audit: ProgramAudit) -> dict:
    """One program's artifact record: findings as exact-gated per-rule
    counts (``bench compare`` treats a count increase like an extra
    collective) plus the inventory/program-order baseline; ``hlo_ops``
    holds the aten ops the step ran."""
    return {
        "strategy": audit.program,
        "model": audit.anatomy.model,
        "compute_dtype": audit.compute_dtype,
        "rule_counts": rule_counts(findings),
        "findings": [f.to_json() for f in findings],
        "inventory": audit.anatomy.inventory(),
        "program_order": audit.anatomy.program_order,
        "hlo_ops": audit.anatomy.hlo_ops,
    }


def render_findings(program: str, findings: Sequence[LintFinding],
                    detail: str = "") -> str:
    if not findings:
        return f"tpu-ddp-torch lint: {program}{detail}: clean"
    lines = [f"tpu-ddp-torch lint: {program}{detail}: "
             f"{len(findings)} finding(s)"]
    lines += [f.render() for f in findings]
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``tpu-ddp-torch lint [--strategy all] [--json out.json] ...`` —
    exit 0 clean, 1 on any error-severity finding, 2 on usage/env
    errors."""
    import argparse

    from tpu_ddp_torch.analysis.explain import STRATEGIES

    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch lint",
        description="in-place state / dtype / sharding / collective / "
                    "host-transfer verifier over one step of every "
                    "strategy that runs",
    )
    ap.add_argument("--strategy", default="all",
                    help=f"one of {', '.join(STRATEGIES)}, or 'all' "
                         "(default: all)")
    ap.add_argument("--model", default=None,
                    help="zoo model name (default: tiny per-family model)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="per-shard batch")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bfloat16 arms the DTY001 widening audit")
    ap.add_argument("--json", default=None,
                    help="write the machine artifact here (per-rule "
                         "counts gate through `tpu-ddp-torch bench compare`)")
    ap.add_argument("--no-source", action="store_true",
                    help="skip the RCP001 AST tier over tpu_ddp_torch/")
    ap.add_argument("--source-root", default=None,
                    help="RCP001 root (default: the tpu_ddp_torch package)")
    ap.add_argument("--kernels", action="store_true",
                    help="the optimizer update through K1 and the int8 ring's "
                         "codec through K2/K3, and the KRN001 audit: on the "
                         "card, an error for each switch-level kernel whose "
                         "build does not load")
    ap.add_argument("--attention", default="full", choices=["full", "flash"],
                    help="attention models: flash runs K4-K6 (sp: the flash ring)")
    ap.add_argument("--n-devices", type=int, default=8,
                    help="ranks of each program (rank 0 runs against a group "
                         "that does not communicate)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the steps run (default cuda: a GPU is "
                         "required unless --device cpu)")
    args = ap.parse_args(list(argv) if argv is not None else None)

    strategies = (list(STRATEGIES) if args.strategy == "all"
                  else [args.strategy])
    programs: Dict[str, dict] = {}
    n_errors = 0
    try:
        for strategy in strategies:
            findings, audit = lint_strategy(
                strategy, model_name=args.model, n_devices=args.n_devices,
                device=args.device, per_shard_batch=args.batch_size,
                compute_dtype=args.compute_dtype, kernels=args.kernels,
                attention=args.attention,
            )
            n_errors += sum(1 for f in findings if f.severity == "error")
            programs[strategy] = _program_record(findings, audit)
            print(render_findings(
                strategy, findings,
                detail=(f" ({audit.anatomy.model}, "
                        f"{audit.device_kind} x{audit.n_devices})")),
                flush=True)
        if not args.no_source:
            src = lint_source_tree(args.source_root)
            n_errors += sum(1 for f in src if f.severity == "error")
            programs["source"] = {
                "strategy": "source",
                "rule_counts": rule_counts(src),
                "findings": [f.to_json() for f in src],
            }
            print(render_findings("source (RCP001 AST tier)", src),
                  flush=True)
        if args.kernels:
            krn = lint_kernels(True, device=args.device)
            n_errors += sum(1 for f in krn if f.severity == "error")
            programs["kernels"] = {
                "strategy": "kernels",
                "rule_counts": rule_counts(krn),
                "findings": [f.to_json() for f in krn],
            }
            print(render_findings("kernels (KRN001 capability tier)",
                                  krn), flush=True)
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch lint: {e}", flush=True)
        return 2
    if args.json:
        import torch

        from tpu_ddp_torch.telemetry.provenance import artifact_provenance

        with open(args.json, "w") as f:
            json.dump({
                "lint_schema_version": LINT_SCHEMA_VERSION,
                "programs": programs,
                # commit identity + a stable series key, so archived
                # lint artifacts trend per config across commits
                "provenance": artifact_provenance(
                    descriptor={"artifact": "lint",
                                "strategies": sorted(programs),
                                "compute_dtype": args.compute_dtype},
                    torch_version=torch.__version__,
                ),
            }, f, indent=1)
        print(f"tpu-ddp-torch lint: wrote {args.json} "
              f"({len(programs)} programs)", flush=True)
    if n_errors:
        print(f"tpu-ddp-torch lint: {n_errors} error(s)", flush=True)
        return 1
    print("tpu-ddp-torch lint: all programs clean", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
