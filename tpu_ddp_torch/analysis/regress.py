"""``tpu-ddp-torch bench compare old.json new.json`` — deviceless perf gate.

The port's copy of ``tpu_ddp/analysis/regress.py``: the same artifact
shapes, gates and exit codes, so either package's artifacts compare under
either package's gate.

Structured diff of two bench/AOT/analyze artifacts, built to catch the
regressions that matter BEFORE a TPU run, on CPU, in CI:

- an **extra collective** (one more all-gather in the optimized HLO than
  the pinned artifact has) — how a parallelism/layout bug usually lands;
- a **widened payload dtype** (an f32 collective where the artifact had
  s8 — the ``--grad-compress`` ring silently degrading);
- **memory growth** (argument/temp bytes up beyond ``--tolerance``);
- **cost-model growth** (flops / bytes-accessed up beyond tolerance).

COLLECTIVE counts compare exactly (an extra collective is never noise);
compiler-decision counts (fusion / convolution / custom-call) and sized
metrics compare with a relative tolerance (compiler-version jitter on
fusion choices and temp bytes is real). Wall-clock fields
(``compile_wall_s``) are reported, never gated — they measure the build
machine, not the program.

Understands nine artifact shapes: ``benchmarks/aot_v5e.json``-style
(``{"programs": {name: record}}``), ``tpu-ddp-torch analyze --json`` output
(``{"anatomy": ...}``), ``tpu-ddp-torch goodput --json`` ledgers
(``{"ledger": ...}`` — badput category presence AND failure-exit
counts gate exactly, the goodput fraction with tolerance, wall clock
is reported only), ``tpu-ddp-torch tune --json`` ranked tables
(``{"tune": ...}`` — the winner's predicted throughput gates as a
higher-is-better quality metric, its predicted step time as a size),
``tpu-ddp-torch mem --json`` memory reports (``{"mem": ...}`` — planned
peak and measured high-water gate as sizes, a fresh ``oom_count``
exactly), ``tpu-ddp-torch trace summarize --json`` run summaries (measured
phase percentiles: report-only here, trend-gated by the registry),
``tpu-ddp-torch curves --json`` learning curves (``{"curve": ...}`` — the
final eval accuracy gates as a higher-is-better quality metric, the
final eval loss and time-to-target steps as unit-scale sizes, and CRV
rule counts exactly through the shared rule-count channel), ``tpu-ddp-torch
comms bench --json`` measured interconnect models (``{"comms": ...}``
— the best measured link bandwidth gates as a higher-is-better
quality metric, the median fitted α latency as a unit-scale size),
and a bare single program record.
Stdlib-only — no torch import — so it gates anywhere the JSON lands.

``--against <registry-dir>`` replaces the hand-pointed baseline file
with auto-selection from the perf registry (docs/registry.md): the
newest clean entry matching the candidate's config digest + device
kind, refusing with a named reason (exit 2) when none matches.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

#: sized metrics where LOWER IS BETTER; relative increase > tolerance is
#: a regression (absolute increases under 1 KiB are ignored as noise)
_SIZE_KEYS = (
    "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
    "generated_code_size_in_bytes", "s8_payload_bytes", "f32_payload_bytes",
    "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
    "flops", "bytes_accessed", "predicted_step_us",
    "measured_high_water_bytes",
    "time_to_target_steps", "final_eval_loss", "alpha_s",
    "batch_time_s", "per_image_s", "seconds_per_batch",
)
_SIZE_NOISE_FLOOR = 1024

#: sized keys at UNIT scale (a loss ~2.3, a step count ~100): the 1 KiB
#: byte-noise floor would swallow them entirely, so these gate on the
#: relative tolerance alone
_UNIT_SIZE_KEYS = ("time_to_target_steps", "final_eval_loss", "alpha_s",
                   "batch_time_s", "per_image_s", "seconds_per_batch")

#: count metrics (exact): any increase is a regression
_COUNT_KEYS = ("s8_collective_permute_count", "f32_collective_permute_count",
               "oom_count")

#: goodput-ledger exit classes that gate as exact counts with
#: union-of-keys semantics: a FRESH failure key (e.g. `oom` appearing
#: where the baseline had none) reads 0 -> N, a regression. Mirrors
#: ledger/taxonomy.py::FAILURE_EXITS (duplicated so this module stays
#: stdlib-only and import-light, like _COLLECTIVE_OPS).
_FAILURE_EXIT_KEYS = ("killed", "hang", "preempted", "oom")

#: opcodes whose counts are COLLECTIVES — exact-gated (an extra one is a
#: layout change, never noise). Mirrors the JAX package's
#: analysis/hlo.py::COLLECTIVE_OPS, whose artifacts this gate reads
_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all")

#: counts that are COMPILER decisions (fusion/conv/custom-call counts
#: move on any XLA version bump): tolerance-gated, not exact
_SOFT_COUNT_KEYS = ("fusion_count",)

#: wall-clock fields: reported, never gated — they measure the machine
#: (or, for a goodput ledger, the incident), not the program
_WALL_KEYS = ("compile_wall_s", "elapsed_s")

#: HIGHER-is-better metrics (the goodput ledger's headline fraction,
#: the tuner's predicted winner throughput, and a learning curve's
#: final eval accuracy): a relative drop beyond tolerance is a
#: regression, a rise an improvement — mirroring the sized-metric gate
#: with the sign flipped
_QUALITY_KEYS = ("goodput_fraction", "predicted_images_per_sec_per_chip",
                 "final_eval_accuracy", "achieved_bw_bytes_per_s",
                 "batches_per_s", "bytes_per_s", "speedup")


def load_artifact(path: str) -> Dict[str, dict]:
    """Normalize an artifact file into ``{program_name: record}``."""
    with open(path) as f:
        art = json.load(f)
    return normalize_artifact(art, path)


def normalize_artifact(art, path: str = "<artifact>") -> Dict[str, dict]:
    """The shape rules behind :func:`load_artifact`, on an
    already-parsed document — callers that need both the raw artifact
    and its normalization (the perf registry) parse the file once and
    route through here."""
    if not isinstance(art, dict):
        raise ValueError(f"{path}: expected a JSON object artifact")
    if isinstance(art.get("programs"), dict):
        return {name: rec for name, rec in art["programs"].items()
                if isinstance(rec, dict)}
    if isinstance(art.get("anatomy"), dict):
        name = art["anatomy"].get("strategy", "anatomy")
        return {name: art["anatomy"]}
    if "diagnose_schema_version" in art and isinstance(
            art.get("diagnose"), dict):
        # `tpu-ddp-torch diagnose --json`: the per-DIA-rule suspect counts
        # gate exactly through the shared rule-count channel — a fresh
        # suspect class in a committed baseline is a regression by
        # definition (the run found a NEW way to lose goodput)
        diag = art["diagnose"]
        return {"diagnose": {k: v for k, v in diag.items()
                             if k not in ("verdicts", "sources",
                                          "refusals")}}
    if isinstance(art.get("ledger"), dict):
        # `tpu-ddp-torch goodput --json`: category PRESENCE gates exactly (a
        # fresh restart_gap category = the benched run started failing),
        # goodput_fraction gates with tolerance, wall clock is noted
        return {"goodput": art["ledger"]}
    if isinstance(art.get("tune"), dict):
        # `tpu-ddp-torch tune --json`: the winner's predicted throughput is
        # the higher-is-better quality metric (a drop = the searched
        # space got slower: a layout/pricing regression), the winner's
        # predicted step time gates as a size
        return {"tune": art["tune"]}
    if isinstance(art.get("mem"), dict):
        # `tpu-ddp-torch mem --json`: planned peak + measured high-water gate
        # as sizes, a fresh oom_count gates exactly; the measured-over-
        # planned ratio is calibration food, not a gate
        return {"mem": art["mem"]}
    if isinstance(art.get("curve"), dict):
        # `tpu-ddp-torch curves --json`: final eval accuracy gates as quality,
        # final eval loss / time-to-target as unit-scale sizes, and the
        # CRV rule counts exactly (the shared rule-count channel — a
        # fresh CRV finding regresses like a new lint finding)
        return {"curves": art["curve"]}
    if "comms_schema_version" in art and isinstance(
            art.get("comms"), dict):
        # `tpu-ddp-torch comms bench --json`: the headline achieved bandwidth
        # gates as quality (a measured link slowdown is a regression),
        # the median fitted α as a unit-scale size; raw sweeps are
        # evidence, not gates
        return {"comms": {k: v for k, v in art["comms"].items()
                          if k not in ("sweeps", "skipped")}}
    if "data_schema_version" in art and isinstance(art.get("data"), dict):
        # `tpu-ddp-torch data bench --json`: the headline loader throughput
        # gates as quality and the end-to-end batch time / per-image
        # cost as unit-scale sizes; each benched stage gates as its own
        # program (a stage that got slower — or stopped benching — is a
        # named regression), raw skips/rows are evidence, not gates
        data = art["data"]
        out = {"data": {k: v for k, v in data.items()
                        if k not in ("stages", "rows", "skipped")}}
        for stage, rec in (data.get("stages") or {}).items():
            if isinstance(rec, dict):
                out[f"data/{stage}"] = dict(rec)
        return out
    if "ops_schema_version" in art and isinstance(art.get("ops"), dict):
        # `tpu-ddp-torch ops bench --json`: the headline fused speedup gates
        # as quality (a kernel that stopped beating XLA is a
        # regression on the chip where it used to), and the parity
        # verdict travels with it; raw sweeps are evidence, not gates
        return {"ops": {k: v for k, v in art["ops"].items()
                        if k not in ("sweeps", "skipped", "kernels",
                                     "rows")}}
    if art.get("type") == "trace_summary" and isinstance(
            art.get("phases"), dict):
        # `tpu-ddp-torch trace summarize --json`: measured per-phase
        # percentiles. Nothing here is compare-gateable (wall clock
        # measures the machine), but the registry records it and trends
        # the phase p50s per (config, chip) series across commits.
        return {"trace_summary": art}
    return {"program": art}


def _inventory(rec: dict) -> Optional[Dict[str, dict]]:
    """The record's collective inventory, normalized to
    ``{"kind/dtype/axis/gN": entry}``; None when the record predates
    inventories (the pre-inventory ``aot_v5e.json`` schema) — callers
    must treat that as "no baseline", not "zero collectives"."""
    if isinstance(rec.get("inventory"), dict):
        return rec["inventory"]
    if isinstance(rec.get("collectives"), list):
        return {
            f"{c.get('kind')}/{c.get('dtype')}/{c.get('axis')}"
            f"/g{c.get('group_size', 0)}": c
            for c in rec["collectives"]
        }
    return None


def _counts(rec: dict) -> Dict[str, int]:
    """All exact-compare counters of a record: explicit count keys, the
    COLLECTIVE rows of the ``hlo_ops`` opcode table, per-
    (kind/dtype/axis/gN) inventory counts, and — for ``tpu-ddp-torch lint
    --json`` artifacts — per-rule lint finding counts (a NEW lint
    finding in a committed artifact gates exactly like an extra
    collective; a fixed one reads as an improvement)."""
    out: Dict[str, int] = {}
    for key in _COUNT_KEYS:
        if isinstance(rec.get(key), (int, float)):
            out[key] = int(rec[key])
    for op, n in (rec.get("hlo_ops") or {}).items():
        if op in _COLLECTIVE_OPS:
            out[f"hlo_ops/{op}"] = int(n)
    for key, entry in (_inventory(rec) or {}).items():
        if isinstance(entry, dict) and "count" in entry:
            out[f"inventory/{key}"] = int(entry["count"])
    for rule, n in (rec.get("rule_counts") or {}).items():
        if isinstance(n, (int, float)):
            out[f"lint/{rule}"] = int(n)
    for cat, present in (rec.get("category_presence") or {}).items():
        out[f"badput/{cat}"] = int(bool(present))
    for cls, n in (rec.get("exit_counts") or {}).items():
        # failure exits only: two clean incarnations vs one is not a
        # regression, a fresh oom/hang/kill always is
        if cls in _FAILURE_EXIT_KEYS and isinstance(n, (int, float)):
            out[f"exits/{cls}"] = int(n)
    return out


def _soft_counts(rec: dict) -> Dict[str, int]:
    """Counts that are compiler decisions, not layout facts — fusion /
    convolution / custom-call counts jitter across XLA versions, so they
    gate with the relative tolerance instead of exactly."""
    out: Dict[str, int] = {}
    for key in _SOFT_COUNT_KEYS:
        if isinstance(rec.get(key), (int, float)):
            out[key] = int(rec[key])
    for op, n in (rec.get("hlo_ops") or {}).items():
        if op not in _COLLECTIVE_OPS:
            out[f"hlo_ops/{op}"] = int(n)
    return out


def _sizes(rec: dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for key in _SIZE_KEYS:
        if isinstance(rec.get(key), (int, float)):
            out[key] = float(rec[key])
    for key, entry in (_inventory(rec) or {}).items():
        if isinstance(entry, dict):
            for field in ("payload_bytes", "wire_bytes"):
                if isinstance(entry.get(field), (int, float)):
                    out[f"inventory/{key}/{field}"] = float(entry[field])
    return out


def compare(old: Dict[str, dict], new: Dict[str, dict],
            *, tolerance: float = 0.05) -> dict:
    """Diff two normalized artifacts. Returns ``{regressions,
    improvements, notes}`` — nonempty ``regressions`` must fail the
    caller (exit 1)."""
    regressions: List[str] = []
    improvements: List[str] = []
    notes: List[str] = []

    for name in sorted(old):
        if name not in new:
            regressions.append(f"{name}: program missing from new artifact")
    for name in sorted(new):
        if name not in old:
            if new[name].get("ok") is False:
                regressions.append(
                    f"{name}: new program's compile is broken: "
                    f"{str(new[name].get('error', '?'))[:120]}"
                )
            else:
                notes.append(f"{name}: new program (no baseline)")

    for name in sorted(set(old) & set(new)):
        o, n = old[name], new[name]
        if o.get("ok") is True and n.get("ok") is False:
            regressions.append(
                f"{name}: compile broke (ok true -> false): "
                f"{n.get('error', '?')[:120]}"
            )
            continue
        oc, nc = _counts(o), _counts(n)
        # a baseline that predates inventories (the pre-inventory
        # aot_v5e.json schema) has NO inventory baseline — gating its
        # inventory/* keys would read every entry of a fresh capture as
        # 0 -> N "extra collectives". The REVERSE asymmetry is a
        # regression, not an improvement: a fresh capture that LOST its
        # inventory means the extraction broke, and reading its entries
        # as N -> 0 wins would fail the gate open exactly when the net
        # it depends on regressed.
        old_has_inventory = _inventory(o) is not None
        new_has_inventory = _inventory(n) is not None
        if old_has_inventory and not new_has_inventory:
            regressions.append(
                f"{name}: collective inventory missing from new artifact "
                "(extraction broke?) — baseline had one"
            )
        noted_fresh_inventory = False
        for key in sorted(set(oc) | set(nc)):
            ov, nv = oc.get(key, 0), nc.get(key, 0)
            if key.startswith("inventory/"):
                if not old_has_inventory:
                    if not noted_fresh_inventory:
                        notes.append(
                            f"{name}: baseline has no collective "
                            "inventory (pre-inventory schema); inventory "
                            "gates start with the new artifact"
                        )
                        noted_fresh_inventory = True
                    continue
                if not new_has_inventory:
                    continue  # already flagged wholesale above
            if nv > ov:
                kind = "extra collective" if key.startswith("inventory/") \
                    else "count increase"
                regressions.append(
                    f"{name}: {key}: {ov} -> {nv} ({kind})"
                )
            elif nv < ov:
                improvements.append(f"{name}: {key}: {ov} -> {nv}")
        osc, nsc = _soft_counts(o), _soft_counts(n)
        for key in sorted(set(osc) & set(nsc)):
            ov, nv = osc[key], nsc[key]
            if nv > ov * (1 + tolerance) and nv > ov + 2:
                regressions.append(
                    f"{name}: {key}: {ov} -> {nv} (compiler-count growth "
                    f"beyond tolerance {tolerance:.0%})"
                )
            elif ov > nv * (1 + tolerance) and ov > nv + 2:
                improvements.append(f"{name}: {key}: {ov} -> {nv}")
        # program-order (anatomy schema v2 / lint artifacts): when the
        # collective MULTISET is unchanged but the linearized schedule
        # moved, that is a layout/overlap change the counts can't see —
        # a reordered schedule across builders is the multihost-deadlock
        # class COL001 guards, so it gates. (Different multisets are
        # already fully gated by the count rules above.)
        oo, no_ = o.get("program_order"), n.get("program_order")
        if (isinstance(oo, list) and isinstance(no_, list) and oo and no_
                and oo != no_ and sorted(oo) == sorted(no_)):
            regressions.append(
                f"{name}: collective schedule reordered (same inventory, "
                f"different program order: {len(oo)} collectives)"
            )
        osz, nsz = _sizes(o), _sizes(n)
        for key in sorted(set(osz) | set(nsz)):
            ov, nv = osz.get(key), nsz.get(key)
            if ov is None:
                # a fresh inventory payload entry whose count didn't also
                # appear above means a baseline without inventories; the
                # count rule already gates real new-collective cases
                continue
            if nv is None:
                if key.startswith("inventory/") and new_has_inventory:
                    improvements.append(f"{name}: {key}: gone")
                continue
            unit = key in _UNIT_SIZE_KEYS
            floor = 0.0 if unit else _SIZE_NOISE_FLOOR

            def fmt(v: float) -> str:
                # unit-scale metrics (a loss) need decimals; byte/flop
                # counts stay integral
                return f"{v:.4g}" if unit else f"{v:.0f}"

            if nv > ov + floor and nv > ov * (1 + tolerance):
                # ov can be 0 (e.g. a wire_bytes entry whose groups failed
                # to parse): still a regression, just no percent to quote
                delta = (f"+{(nv - ov) / ov:.1%}" if ov else "from 0")
                regressions.append(
                    f"{name}: {key}: {fmt(ov)} -> {fmt(nv)} "
                    f"({delta}, tolerance {tolerance:.0%})"
                )
            elif ov > nv + floor and ov > nv * (1 + tolerance):
                improvements.append(
                    f"{name}: {key}: {fmt(ov)} -> {fmt(nv)} "
                    f"(-{(ov - nv) / ov:.1%})"
                )
        for key in _QUALITY_KEYS:
            ov, nv = o.get(key), n.get(key)
            if not (isinstance(ov, (int, float))
                    and isinstance(nv, (int, float))):
                continue
            if nv < ov * (1 - tolerance) and ov - nv > 0.005:
                regressions.append(
                    f"{name}: {key}: {ov:.3f} -> {nv:.3f} "
                    f"(-{(ov - nv) / ov:.1%}, tolerance {tolerance:.0%})"
                )
            elif nv > ov * (1 + tolerance) and nv - ov > 0.005:
                improvements.append(
                    f"{name}: {key}: {ov:.3f} -> {nv:.3f}")
        for key in _WALL_KEYS:
            ov, nv = o.get(key), n.get(key)
            if isinstance(ov, (int, float)) and isinstance(nv, (int, float)) \
                    and ov and abs(nv - ov) > 0.5 * ov:
                notes.append(
                    f"{name}: {key}: {ov} -> {nv} (informational — wall "
                    "clock measures the build machine)"
                )
    return {"regressions": regressions, "improvements": improvements,
            "notes": notes}


def render(result: dict, old_path: str, new_path: str) -> str:
    lines = [f"bench compare: {old_path} -> {new_path}"]
    for label, key in (("REGRESSIONS", "regressions"),
                       ("improvements", "improvements"),
                       ("notes", "notes")):
        entries = result[key]
        if not entries:
            continue
        lines.append(f"{label} ({len(entries)}):")
        lines.extend(f"  {e}" for e in entries)
    if not result["regressions"]:
        lines.append("no regressions")
    return "\n".join(lines)


def _baseline_from_registry(registry_dir: str, candidate_path: str,
                            allow_dirty: bool):
    """(programs, label) of the auto-selected baseline, or raises
    ``ValueError`` with the named refusal. Lazy import keeps the plain
    two-file compare path exactly as import-light as before."""
    from tpu_ddp_torch.registry.store import (
        candidate_identity,
        default_registry_dir,
        read_entries,
        select_baseline,
    )

    registry_dir = default_registry_dir(registry_dir)
    digest, device_kind, kind = candidate_identity(candidate_path)
    entry, refusal = select_baseline(
        read_entries(registry_dir),
        config_digest=digest, device_kind=device_kind,
        artifact_kind=kind, allow_dirty=allow_dirty,
    )
    if entry is None:
        raise ValueError(
            f"--against {registry_dir}: no baseline auto-selected: "
            f"{refusal}")
    return entry.programs, f"{registry_dir}:{entry.entry_id}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``tpu-ddp-torch bench compare old.json new.json [--tolerance 0.05]``
    or ``tpu-ddp-torch bench compare --against <registry-dir> new.json``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch bench compare",
        description="structured diff of two bench/AOT/analyze artifacts; "
                    "exits 1 on any regression (extra collectives, "
                    "widened payload dtypes, memory/flops growth). With "
                    "--against, the baseline is auto-selected from a "
                    "perf registry instead of hand-pointed",
    )
    ap.add_argument("paths", nargs="+", metavar="artifact.json",
                    help="baseline and candidate artifacts — or just "
                         "the candidate when --against picks the "
                         "baseline from the registry")
    ap.add_argument("--against", default=None, metavar="REGISTRY_DIR",
                    help="auto-select the baseline: newest clean "
                         "registry entry matching the candidate's "
                         "config digest + device kind (exit 2 with a "
                         "named reason when none matches)")
    ap.add_argument("--allow-dirty", action="store_true",
                    help="with --against: accept a baseline recorded "
                         "from a dirty working tree")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="relative growth allowed on sized metrics and "
                         "compiler-decision counts (default 0.05); "
                         "collective counts always compare exactly")
    args = ap.parse_args(list(argv) if argv is not None else None)
    try:
        if args.against:
            if len(args.paths) != 1:
                raise ValueError(
                    "--against takes exactly one candidate artifact "
                    f"(got {len(args.paths)} paths)")
            new_path = args.paths[0]
            old, old_label = _baseline_from_registry(
                args.against, new_path, args.allow_dirty)
        else:
            if len(args.paths) != 2:
                raise ValueError(
                    "expected exactly two artifacts: old.json new.json "
                    "(or --against <registry-dir> new.json)")
            old_label, new_path = args.paths
            old = load_artifact(old_label)
        new = load_artifact(new_path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"tpu-ddp-torch bench compare: {e}", flush=True)
        return 2
    result = compare(old, new, tolerance=args.tolerance)
    print(render(result, old_label, new_path), flush=True)
    return 1 if result["regressions"] else 0
