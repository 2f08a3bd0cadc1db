"""Checkpoint checksum manifests: written at save, verified at restore.

The port's own copy of ``tpu_ddp/checkpoint/manifest.py`` (stdlib only;
the port imports nothing of the JAX package), with the same file names and
the same JSON schema, so a manifest either package writes verifies under
the other's ``verify_step``.

A manifest is a per-file SHA-256 record
(``<ckpt_dir>/manifests/step-<N>.json``) of a committed step directory, so
a restore can prove byte-integrity BEFORE deserializing, and a mismatch
becomes a *named refusal* that falls back to the next-older verified step
(``checkpoint/manager.py::Checkpointer.restore``). A committed step is a
directory whose name is the literal step number: the port's writer, like
orbax, writes under a temporary name and commits with one atomic rename,
which is all the discovery here relies on.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

MANIFEST_SCHEMA_VERSION = 1

#: subdirectory of the checkpoint dir holding the manifests — kept out
#: of the step dirs themselves so retention deletes never race a
#: manifest write, and a manifest can outlive (and thereby expose) a
#: half-deleted step
MANIFEST_DIRNAME = "manifests"


def manifest_dir(directory: str) -> str:
    return os.path.join(directory, MANIFEST_DIRNAME)


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(manifest_dir(directory), f"step-{int(step)}.json")


def committed_steps(directory: str) -> List[int]:
    """Step numbers with a committed (atomically renamed) step dir,
    ascending. In-flight saves live under tmp-suffixed names (the port's
    and orbax's alike), so a pure-digits directory name == a committed
    step."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = [
        int(n) for n in names
        if n.isdigit() and os.path.isdir(os.path.join(directory, n))
    ]
    return sorted(steps)


def _step_files(directory: str, step: int) -> List[str]:
    """Relative paths of every regular file under the step dir, sorted
    (the manifest's stable iteration order)."""
    root = os.path.join(directory, str(int(step)))
    out: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            full = os.path.join(dirpath, name)
            out.append(os.path.relpath(full, root))
    return sorted(out)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(directory: str, step: int) -> str:
    """Hash the committed step dir into its manifest (atomic replace).
    Must only run AFTER the step is committed — the caller owns that
    ordering (``Checkpointer``'s writer manifests a step right after its
    commit rename)."""
    step = int(step)
    root = os.path.join(directory, str(step))
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"cannot manifest step {step}: no committed dir at {root!r}")
    files: Dict[str, dict] = {}
    for rel in _step_files(directory, step):
        full = os.path.join(root, rel)
        files[rel] = {
            "sha256": _sha256(full),
            "bytes": os.path.getsize(full),
        }
    record = {
        "manifest_schema_version": MANIFEST_SCHEMA_VERSION,
        "step": step,
        "n_files": len(files),
        "files": files,
    }
    os.makedirs(manifest_dir(directory), exist_ok=True)
    path = manifest_path(directory, step)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1)
    os.replace(tmp, path)
    return path


def read_manifest(directory: str, step: int) -> Optional[dict]:
    """The manifest record, or None when absent/unreadable/from a newer
    schema (an unreadable manifest must not brick the restore — the step
    just degrades to 'unverifiable')."""
    try:
        with open(manifest_path(directory, step)) as f:
            record = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(record, dict):
        return None
    version = record.get("manifest_schema_version")
    if not isinstance(version, int) or version > MANIFEST_SCHEMA_VERSION:
        return None
    return record


def verify_step(directory: str, step: int) -> Tuple[Optional[bool], List[str]]:
    """``(verdict, problems)`` for one committed step.

    verdict True: manifest present and every file matches byte-for-byte.
    verdict False: manifest present but the step FAILS it — ``problems``
    names each mismatched/missing/extra file (the named refusal).
    verdict None: no usable manifest (legacy save, or the process died
    between commit and manifest) — the step cannot be verified either
    way; callers decide whether to accept it.
    """
    record = read_manifest(directory, step)
    if record is None:
        return None, []
    want = record.get("files")
    if not isinstance(want, dict):
        return None, []
    problems: List[str] = []
    root = os.path.join(directory, str(int(step)))
    have = set(_step_files(directory, step)) if os.path.isdir(root) else None
    if have is None:
        return False, [f"step {step}: committed dir is gone"]
    for rel, meta in sorted(want.items()):
        full = os.path.join(root, rel)
        if rel not in have:
            problems.append(f"{rel}: missing")
            continue
        try:
            digest = _sha256(full)
        except OSError as e:
            problems.append(f"{rel}: unreadable ({e})")
            continue
        if digest != meta.get("sha256"):
            problems.append(
                f"{rel}: sha256 mismatch (manifest "
                f"{str(meta.get('sha256'))[:12]}…, on disk {digest[:12]}…)")
    for rel in sorted(have - set(want)):
        problems.append(f"{rel}: not in manifest (file appeared after save)")
    return (not problems), problems


def sweep_manifests(directory: str, keep_steps) -> None:
    """Drop manifests whose steps retention already deleted (best-effort;
    a leftover manifest is harmless — it just names a step that no
    longer exists and is skipped by discovery)."""
    keep = {int(s) for s in keep_steps}
    mdir = manifest_dir(directory)
    try:
        names = os.listdir(mdir)
    except OSError:
        return
    for name in names:
        if not (name.startswith("step-") and name.endswith(".json")):
            continue
        try:
            step = int(name[len("step-"):-len(".json")])
        except ValueError:
            continue
        if step not in keep:
            try:
                os.remove(os.path.join(mdir, name))
            except OSError:
                pass


def latest_verified_step(
    directory: str,
    candidates: Optional[List[int]] = None,
) -> Tuple[Optional[int], List[dict]]:
    """Newest acceptable step, with every refusal named.

    Walks ``candidates`` (default: the committed steps) newest-first:
    a step whose manifest verifies is returned; a step whose manifest
    FAILS is refused by name (appended to the refusal list with its
    per-file problems) and the walk continues to the next-older step;
    a step with no manifest is accepted with a refusal-list *note*
    (``unverifiable``) — a legacy checkpoint must stay restorable.

    Returns ``(step or None, refusals)`` where each refusal is
    ``{"step": int, "verdict": "refused"|"unverifiable", "problems": [...]}``.
    """
    steps = sorted(
        candidates if candidates is not None else committed_steps(directory)
    )
    refusals: List[dict] = []
    for step in reversed(steps):
        verdict, problems = verify_step(directory, step)
        if verdict is True:
            return step, refusals
        if verdict is False:
            refusals.append(
                {"step": step, "verdict": "refused", "problems": problems})
            log.error(
                "checkpoint step %d REFUSED (checksum manifest): %s",
                step, "; ".join(problems) or "integrity failure")
            continue
        refusals.append(
            {"step": step, "verdict": "unverifiable",
             "problems": ["no manifest (legacy save or death before "
                          "manifest write)"]})
        return step, refusals
    return None, refusals
