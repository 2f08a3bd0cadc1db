"""Append-only archive of perf/observability artifacts.

A registry workspace is a directory holding one ``registry.jsonl``;
each line is one :class:`RegistryEntry`: the artifact's programs
(normalized through ``analysis/regress.load_artifact`` — the SAME
loader ``bench compare`` trusts, so an archived entry diffs exactly
like the file it came from), a flat metric namespace extracted from
them (what ``trend.py`` runs series over), and a provenance stamp
(git commit + dirty, config digest, device kind, torch version, ...).

Identity model: ``config_digest`` (the PR 7 deterministic run-id
recipe) names WHAT was measured; ``device_kind`` names WHERE. Entries
sharing both form a time series across commits — the unit of trend
detection and of auto-baseline selection. Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from tpu_ddp_torch.analysis.regress import (
    _QUALITY_KEYS,
    _counts,
    _sizes,
    normalize_artifact,
)
from tpu_ddp_torch.telemetry.provenance import (
    PROVENANCE_SCHEMA_VERSION,
    config_digest,
    git_provenance,
)

#: bump on any breaking change to the registry.jsonl entry shape
REGISTRY_SCHEMA_VERSION = 1

REGISTRY_FILE = "registry.jsonl"

#: env var naming the default workspace (CI exports it so every demo
#: gate records into one accumulating registry)
REGISTRY_ENV = "TPU_DDP_REGISTRY"

#: top-level/program keys that are MEASURED, higher-is-better rates —
#: the registry's headline trend class (REG001)
_MEASURED_KEYS = (
    "value", "mfu", "images_per_sec_per_chip", "flash_speedup",
    "calls_per_sec", "steps_per_sec",
)


def default_registry_dir(path: Optional[str] = None) -> str:
    """Resolve a workspace dir: explicit arg > $TPU_DDP_REGISTRY >
    ``./perf_registry``."""
    return (path or os.environ.get(REGISTRY_ENV) or "perf_registry")


@dataclasses.dataclass
class RegistryEntry:
    """One archived artifact."""

    entry_id: str
    recorded_at: float
    artifact_kind: str
    artifact_path: Optional[str]
    config_digest: Optional[str]
    device_kind: str
    provenance: Dict[str, Any]
    programs: Dict[str, dict]
    metrics: Dict[str, float]
    note: Optional[str] = None

    def to_record(self) -> dict:
        return {
            "registry_schema_version": REGISTRY_SCHEMA_VERSION,
            "type": "registry_entry",
            **dataclasses.asdict(self),
        }

    @property
    def clean(self) -> bool:
        """True when this entry came from a clean (non-dirty) checkout.
        ``git_dirty=None`` (no git identity at all) is NOT clean — a
        baseline you can't attribute to a commit can't gate one."""
        return self.provenance.get("git_dirty") is False

    def label(self) -> str:
        commit = self.provenance.get("git_commit")
        commit = commit[:9] if isinstance(commit, str) else "-"
        dirty = "+dirty" if self.provenance.get("git_dirty") else ""
        return (f"{self.entry_id}  {self.artifact_kind:<13} "
                f"{commit}{dirty:<6} cfg={self.config_digest or '-':<10} "
                f"{self.device_kind}")


# -- metric extraction ------------------------------------------------------

def _measured_of(rec: dict, prefix: str, out: Dict[str, float]) -> None:
    for key in _MEASURED_KEYS:
        v = rec.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"{prefix}/measured/{key}"] = float(v)


def extract_metrics(programs: Dict[str, dict]) -> Dict[str, float]:
    """Flatten normalized program records into the common metric
    namespace: ``<program>/<class>/<key>`` where class decides the
    trend direction —

    - ``count``    exact (collective inventory, lint rule counts,
      badput category presence): any increase is drift (REG003)
    - ``size``     lower-is-better bytes/flops (REG002)
    - ``quality``  higher-is-better fractions (goodput) (REG001)
    - ``measured`` higher-is-better measured rates (REG001)
    - ``wall``     lower-is-better measured seconds (REG002)
    """
    out: Dict[str, float] = {}
    for name, rec in programs.items():
        if not isinstance(rec, dict):
            continue
        for k, v in _counts(rec).items():
            out[f"{name}/count/{k}"] = float(v)
        for k, v in _sizes(rec).items():
            out[f"{name}/size/{k}"] = float(v)
        for k in _QUALITY_KEYS:
            v = rec.get(k)
            if isinstance(v, (int, float)):
                out[f"{name}/quality/{k}"] = float(v)
        _measured_of(rec, name, out)
        # bench.py `rows` (named measurement rows of one bench run)
        rows = rec.get("rows")
        if isinstance(rows, dict):
            for rname, row in rows.items():
                if isinstance(row, dict):
                    _measured_of(row, f"{name}/rows/{rname}", out)
        # goodput ledger throughput block
        thr = rec.get("throughput")
        if isinstance(thr, dict):
            for k in ("raw_images_per_sec", "effective_images_per_sec"):
                v = thr.get(k)
                if isinstance(v, (int, float)):
                    out[f"{name}/measured/{k}"] = float(v)
        # trace-summary per-phase percentiles: measured wall seconds
        phases = rec.get("phases")
        if isinstance(phases, dict):
            for pname, ph in phases.items():
                if isinstance(ph, dict) and isinstance(
                        ph.get("p50_s"), (int, float)):
                    out[f"{name}/wall/phase/{pname}_p50_s"] = float(
                        ph["p50_s"])
        # watch --once --json: fleet rate inside the snapshot
        snap = rec.get("snapshot")
        if isinstance(snap, dict):
            v = (snap.get("fleet") or {}).get("steps_per_sec")
            if isinstance(v, (int, float)):
                out[f"{name}/measured/steps_per_sec"] = float(v)
    return out


# -- artifact identity ------------------------------------------------------

def _artifact_kind(art: dict) -> str:
    if art.get("type") == "trace_summary":
        return "trace_summary"
    if "tune_schema_version" in art:
        return "tune"
    if "curves_schema_version" in art or isinstance(
            art.get("curve"), dict):
        # `tpu-ddp-torch curves --json`: the seed-band baseline pool
        # (docs/curves.md) — its embedded provenance keys the series on
        # the seed-invariant quality digest, so N seeded runs of one
        # recipe land in ONE series
        return "curves"
    if "diagnose_schema_version" in art or isinstance(
            art.get("diagnose"), dict):
        # `tpu-ddp-torch diagnose --json`: the cross-observatory incident
        # verdict (docs/diagnose.md) — recorded per config digest so
        # the registry accumulates incident history
        return "diagnose"
    if art.get("type") == "memtrack" or isinstance(art.get("mem"), dict):
        return "mem"
    if isinstance(art.get("ledger"), dict):
        return "goodput_ledger"
    if isinstance(art.get("snapshot"), dict) and "alerts" in art:
        return "watch_snapshot"
    if "lint_schema_version" in art:
        return "lint"
    if isinstance(art.get("anatomy"), dict):
        return "analyze"
    if isinstance(art.get("programs"), dict):
        if art.get("topology"):
            return "aot"
        return "analyze_all"
    if "comms_schema_version" in art or isinstance(
            art.get("comms"), dict):
        # `tpu-ddp-torch comms bench --json`: the measured interconnect model
        # (docs/comms.md) — must outrank the bare "rows" fallback below
        # (the comms record carries a per-link rows trend channel too)
        return "comms"
    if "data_schema_version" in art or art.get("type") == "data":
        # `tpu-ddp-torch data bench --json`: the measured loader-stage model
        # (docs/data.md) — also outranks the "rows" fallback (its record
        # carries a per-stage rows trend channel)
        return "data"
    if "ops_schema_version" in art or isinstance(art.get("ops"), dict):
        # `tpu-ddp-torch ops bench --json`: the measured fused-kernel cost
        # model (docs/kernels.md) — also outranks the "rows" fallback
        # (its record carries a per-kernel rows trend channel)
        return "ops"
    if "images_per_sec_per_chip" in art or "vs_baseline" in art \
            or "rows" in art:
        return "bench"
    return "artifact"


def _find_run_id(art: dict) -> Optional[str]:
    """The run's deterministic config digest, wherever the artifact
    family put it."""
    for path in (("provenance", "run_id"),
                 ("run_meta", "run_id"),
                 ("ledger", "run_id"),
                 ("diagnose", "run_id"),
                 ("mem", "run_id"),
                 ("curve", "run_id"),
                 ("snapshot", "run_id")):
        node: Any = art
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if isinstance(node, str) and node:
            return node
    return None


def _entry_provenance(art: dict, programs: Dict[str, dict],
                      cwd: Optional[str] = None) -> Dict[str, Any]:
    """The stamp recorded with the entry. Artifact-embedded provenance
    (the capture wrote its own commit) wins over the record-time probe —
    recording can happen on a different machine/checkout than the
    capture; where the artifact is silent, the probe fills in (record
    typically runs right after capture on the same tree)."""
    embedded = art.get("provenance")
    embedded = dict(embedded) if isinstance(embedded, dict) else {}
    run_meta = art.get("run_meta")
    run_meta = run_meta if isinstance(run_meta, dict) else {}

    first = next(iter(programs.values()), {})
    first = first if isinstance(first, dict) else {}
    prov: Dict[str, Any] = {
        "provenance_schema_version": PROVENANCE_SCHEMA_VERSION}
    probe = git_provenance(cwd)
    for key in ("git_commit", "git_dirty"):
        # most-specific first: the artifact's own header, the run
        # metadata it embedded, a program record that carries identity
        # (the goodput ledger), then the record-time probe
        for source in (embedded, run_meta, first):
            if source.get(key) is not None:
                prov[key] = source[key]
                break
        else:
            prov[key] = probe[key]

    run_id = _find_run_id(art)
    digest = embedded.get("config_digest") or run_id
    if not digest:
        # artifacts with no run identity (a committed aot capture, a
        # lint sweep, a bare bench record): derive a stable series key
        # from WHAT was measured, so re-captures across commits line
        # up. Program names alone are not enough — every bare record
        # normalizes to the name "program" — so the shape of each
        # record (its metric label and field names, NOT its values)
        # joins the key, keeping unrelated benchmarks out of one
        # series.
        digest = config_digest({
            "kind": _artifact_kind(art),
            "topology": art.get("topology"),
            "metric": art.get("metric"),
            "programs": {
                name: sorted(rec) if isinstance(rec, dict) else None
                for name, rec in programs.items()
            },
        })
        prov["config_digest_source"] = "derived:programs"
    prov["config_digest"] = digest
    if run_id:
        prov["run_id"] = run_id

    for key in ("strategy", "mesh", "device_kind", "torch_version"):
        v = (embedded.get(key) or run_meta.get(key) or art.get(key)
             or first.get(key))
        if v is not None:
            prov[key] = v
    # which schema the artifact itself declared (any of the families')
    for key in ("schema_version", "lint_schema_version",
                "trace_summary_schema_version", "mem_schema_version"):
        if key in art:
            prov["artifact_schema_version"] = art[key]
            break
    return prov


# -- record / read ----------------------------------------------------------

def record_artifact(
    registry_dir: str,
    artifact_path: str,
    *,
    note: Optional[str] = None,
    now: Optional[float] = None,
    cwd: Optional[str] = None,
) -> RegistryEntry:
    """Ingest one artifact file and append it to the registry. Raises
    ``ValueError``/``OSError``/``json.JSONDecodeError`` exactly where
    ``bench compare`` would — the registry refuses what the gate would
    refuse."""
    with open(artifact_path) as f:
        art = json.load(f)
    programs = normalize_artifact(art, artifact_path)
    prov = _entry_provenance(art, programs, cwd=cwd)
    metrics = extract_metrics(programs)
    recorded_at = time.time() if now is None else now
    body = {
        "recorded_at": recorded_at,
        "programs": programs,
        "provenance": prov,
    }
    entry = RegistryEntry(
        entry_id=config_digest(body) + format(int(recorded_at) % 0x1000,
                                              "03x"),
        recorded_at=recorded_at,
        artifact_kind=_artifact_kind(art),
        artifact_path=os.path.abspath(artifact_path),
        config_digest=prov.get("config_digest"),
        device_kind=str(prov.get("device_kind") or "unknown"),
        provenance=prov,
        programs=programs,
        metrics=metrics,
        note=note,
    )
    os.makedirs(registry_dir, exist_ok=True)
    with open(os.path.join(registry_dir, REGISTRY_FILE), "a") as f:
        f.write(json.dumps(entry.to_record()) + "\n")
    return entry


def read_entries(registry_dir: str) -> List[RegistryEntry]:
    """All entries, oldest first. Torn trailing lines are skipped (a
    crash mid-append leaves at most one); a future schema is refused so
    an old tool can't silently misread new entries."""
    path = os.path.join(registry_dir, REGISTRY_FILE)
    if not os.path.isfile(path):
        return []
    entries: List[RegistryEntry] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn final line — expected after a crash
            version = rec.get("registry_schema_version")
            if isinstance(version, int) and version > REGISTRY_SCHEMA_VERSION:
                raise ValueError(
                    f"{path}: registry_schema_version {version} is newer "
                    f"than this tool understands ({REGISTRY_SCHEMA_VERSION})"
                )
            if rec.get("type") != "registry_entry":
                continue
            entries.append(RegistryEntry(**{
                k: rec.get(k) for k in (
                    "entry_id", "recorded_at", "artifact_kind",
                    "artifact_path", "config_digest", "device_kind",
                    "provenance", "programs", "metrics", "note")
            }))
    entries.sort(key=lambda e: e.recorded_at)
    return entries


def find_entry(entries: List[RegistryEntry],
               ref: str) -> Optional[RegistryEntry]:
    """Resolve an entry reference: a full/prefix ``entry_id``, or
    ``#N`` / ``#-N`` positional index (``#-1`` = newest)."""
    if ref.startswith("#"):
        try:
            return entries[int(ref[1:])]
        except (ValueError, IndexError):
            return None
    hits = [e for e in entries if e.entry_id.startswith(ref)]
    return hits[-1] if hits else None


# -- auto-baseline ----------------------------------------------------------

def select_baseline(
    entries: List[RegistryEntry],
    *,
    config_digest: Optional[str],
    device_kind: str,
    artifact_kind: Optional[str] = None,
    allow_dirty: bool = False,
) -> Tuple[Optional[RegistryEntry], Optional[str]]:
    """The newest clean entry matching (config digest, chip, artifact
    family) — what ``bench compare --against`` gates a fresh capture
    with. The family filter matters because one run records several
    artifact kinds under one digest (analyze + goodput + trace summary)
    and only the same kind carries comparable programs. Returns
    ``(entry, None)`` or ``(None, named_reason)``: the refusal always
    says WHY no baseline matched, because a gate that silently passes
    for lack of a baseline is how regressions slip in."""
    if not entries:
        return None, "registry is empty (nothing ever recorded)"
    if not config_digest:
        return None, ("candidate artifact carries no config digest "
                      "(no provenance header, run_id, or programs to "
                      "derive one from)")
    same_cfg = [e for e in entries if e.config_digest == config_digest]
    if not same_cfg:
        have = sorted({e.config_digest for e in entries
                       if e.config_digest})
        return None, (
            f"no entry matches config digest {config_digest} "
            f"(registry has: {', '.join(have[:8]) or 'none'}"
            + (", ..." if len(have) > 8 else "") + ")")
    if artifact_kind:
        same_kind = [e for e in same_cfg
                     if e.artifact_kind == artifact_kind]
        if not same_kind:
            have = sorted({e.artifact_kind for e in same_cfg})
            return None, (
                f"{len(same_cfg)} entr"
                f"{'y' if len(same_cfg) == 1 else 'ies'} match digest "
                f"{config_digest} but none is a {artifact_kind!r} "
                f"artifact (have: {', '.join(have)})")
        same_cfg = same_kind
    same_chip = [e for e in same_cfg if e.device_kind == device_kind]
    if not same_chip:
        have = sorted({e.device_kind for e in same_cfg})
        return None, (
            f"{len(same_cfg)} entr{'y' if len(same_cfg) == 1 else 'ies'} "
            f"match digest {config_digest} but none on device kind "
            f"{device_kind!r} (have: {', '.join(have)})")
    usable = same_chip if allow_dirty else [e for e in same_chip
                                            if e.clean]
    if not usable:
        return None, (
            f"{len(same_chip)} matching entr"
            f"{'y' if len(same_chip) == 1 else 'ies'} but none from a "
            "clean git checkout (re-record from a clean tree, or pass "
            "--allow-dirty to accept an unattributable baseline)")
    return usable[-1], None


def candidate_identity(
        artifact_path: str) -> Tuple[Optional[str], str, str]:
    """(config_digest, device_kind, artifact_kind) of a candidate
    artifact file, using the same derivation as
    :func:`record_artifact` — so the candidate and the baseline it
    seeks were keyed identically."""
    with open(artifact_path) as f:
        art = json.load(f)
    programs = normalize_artifact(art, artifact_path)
    prov = _entry_provenance(art, programs)
    return (prov.get("config_digest"),
            str(prov.get("device_kind") or "unknown"),
            _artifact_kind(art))
