"""Step-keyed checkpoints on ``torch.save``, with verified restore.

Counterpart of ``tpu_ddp/checkpoint/manager.py`` (``Checkpointer`` :131,
``merge_params`` :485), on ``torch.save`` / ``torch.load(weights_only=True)``
in place of orbax. A checkpoint is a flat dict of contiguous CPU tensors and
Python numbers (``train/state.py::checkpoint_state`` builds the trainer's),
with no pickled classes.

On disk a step is the directory ``<dir>/<step>/`` holding one file,
``state.pt``. It is written under a temporary name in the same directory
(``<step>.tmp-<pid>``, which ``manifest.committed_steps`` does not count),
fsynced, and committed with one ``os.replace``, as orbax commits; then its
SHA-256 manifest (``checkpoint/manifest.py``) is written and retention
keeps the ``max_to_keep`` highest steps.

``save(step, state)`` takes the device-to-host copy at once, into host
tensors (the card's through pinned buffers, with one synchronisation), and
a background thread then writes, commits and manifests, as orbax's async
save does; ``wait_until_finished()`` is the barrier and ``wait=True``
blocks. One save is in flight at a time: a save first waits for the one
before it. A save whose attempts all fail with ``OSError`` is logged and
dropped when it ran in the background, and raises when it was asked to
wait (the final save must not fake a clean exit).

Only rank 0 (``parallel/runtime.py::is_primary_process``) writes files;
every rank calls ``save`` at the same steps, after the collectives that
build the state. Every rank reads at restore, so ranks on several hosts
need a filesystem they all share.

Kept from the JAX class: the duplicate-step guard, retention by step
number, bounded retries with backoff and ``fault_hook(step, attempt)``,
``save_as_only`` with its intent marker, ``latest_step`` honouring the
marker, and verified restore with named refusal and fallback. Its
telemetry too (``telemetry=``, the JAX :84-475): the ``checkpoint`` span
around a save's initiation (the device-to-host copy, and with ``wait`` the
write and commit; ``step``, ``wait``, ``retries``; ``best`` for
``save_as_only``), ``checkpoint_wait`` around a wait for the save in
flight, ``checkpoint_restore`` around a restore; the counters
``checkpoint/saves``, ``completed`` and ``io_seconds`` (counted when the
write commits, from the save's start), ``manifests``, ``save_retries``,
``save_failures``, ``verify_refused``, ``restores`` and
``restore_seconds``; the instants ``checkpoint_save_failed``,
``checkpoint_save_retried`` and ``checkpoint_refused``. ``counters`` and
``timings`` keep the same counts a checkpointer (saves, retries, failures,
manifests, restores; the last save's initiation and commit and the last
restore, in ms).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import random
import shutil
import threading
import time
from typing import Callable, Dict, Optional

import torch

from tpu_ddp_torch.checkpoint import manifest as ckpt_manifest
from tpu_ddp_torch.parallel.runtime import is_primary_process

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
#: the longest wait between two save attempts, in seconds
_SAVE_RETRY_CAP_S = 5.0


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Step-keyed checkpoints of a flat ``{name: tensor or number}`` state
    (module docstring). ``fault_hook(step, attempt)`` runs before each save
    attempt; raising ``OSError`` from it exercises the retry path."""

    # intent record for save_as_only's delete sweep
    _ONLY_MARKER = "only_step.json"

    def __init__(self, directory: str, max_to_keep: int = 3, *,
                 save_attempts: int = 3, save_retry_base_s: float = 0.25,
                 fault_hook: Optional[Callable[[int, int], None]] = None,
                 telemetry=None):
        if save_attempts < 1:
            raise ValueError(
                f"save_attempts must be >= 1, got {save_attempts}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_attempts = save_attempts
        self.save_retry_base_s = save_retry_base_s
        self.fault_hook = fault_hook
        if telemetry is None:
            from tpu_ddp_torch.telemetry import NULL as telemetry
        self.telemetry = telemetry
        self.primary = is_primary_process()
        os.makedirs(self.directory, exist_ok=True)
        self.counters: Dict[str, int] = collections.Counter()
        self.timings: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._in_flight: Optional[int] = None
        self._pinned: Dict[str, torch.Tensor] = {}

    # ---- discovery --------------------------------------------------------

    def all_steps(self) -> list:
        """Committed steps, ascending."""
        return ckpt_manifest.committed_steps(self.directory)

    def _marker_step(self) -> Optional[int]:
        """The save_as_only intent marker's step, if it names a step that
        exists on disk; else None (a stale marker is harmless)."""
        try:
            with open(os.path.join(self.directory, self._ONLY_MARKER)) as f:
                want = int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None
        return want if want in self.all_steps() else None

    def _clear_marker(self) -> None:
        if self.primary:
            try:
                os.remove(os.path.join(self.directory, self._ONLY_MARKER))
            except OSError:
                pass

    def latest_step(self) -> Optional[int]:
        """Newest meaningful step: a pending save_as_only intent marker
        overrides the max-step rule."""
        marked = self._marker_step()
        if marked is not None:
            return marked
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- save -------------------------------------------------------------

    def _to_host(self, state: dict) -> dict:
        """Host copies of ``state``'s tensors, each contiguous with storage
        of its own (a view would drag its whole base into the file): the
        card's through reused pinned buffers, then ONE synchronisation."""
        out, on_card = {}, False
        for key, value in state.items():
            if not isinstance(value, torch.Tensor):
                out[key] = value
                continue
            value = value.detach()
            if value.device.type == "cuda":
                buf = self._pinned.get(key)
                if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
                    buf = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                    self._pinned[key] = buf
                buf.copy_(value, non_blocking=True)
                out[key], on_card = buf, True
            else:
                out[key] = value.contiguous().clone()
        if on_card:
            torch.cuda.synchronize()
        return out

    def save(self, step: int, state: dict, wait: bool = False) -> None:
        """Checkpoint ``state`` at ``step`` (module docstring). A step equal
        to the latest one is skipped (a cadence save colliding with the
        epoch-boundary or final save), and stays out of the telemetry;
        ``wait=True`` still drains. A ``wait=True`` save at the step of the
        background save in flight waits for it and saves again when that
        one failed, so a final save is never lost to a background failure
        that only logs."""
        step = int(step)
        if not self.primary:
            return
        if step == self._in_flight:
            if not wait:
                return
            self.wait_until_finished()
        if step == self.latest_step():
            if wait:
                self.wait_until_finished()
            return
        self._clear_marker()
        self._join()
        t0 = time.perf_counter()
        if wait:
            try:
                with self.telemetry.span("checkpoint", step=step, wait=True, retries=0):
                    host = self._to_host(state)
                    self.timings["initiate_ms"] = (time.perf_counter() - t0) * 1e3
                    self.counters["saves"] += 1
                    self._save_with_retry(step, host, t0=t0)
            except OSError as e:
                self._failed(step, e, "final checkpoint save")
                raise
            self.telemetry.count("checkpoint/saves")
            return
        with self.telemetry.span("checkpoint", step=step, wait=False, retries=0):
            host = self._to_host(state)
        self.timings["initiate_ms"] = (time.perf_counter() - t0) * 1e3
        self.counters["saves"] += 1
        self.telemetry.count("checkpoint/saves")
        self._in_flight = step
        self._thread = threading.Thread(target=self._save_background,
                                        args=(step, host, t0), daemon=True,
                                        name="tpu-ddp-torch-ckpt")
        self._thread.start()

    def _failed(self, step: int, e: OSError, what: str) -> None:
        """Record a save whose attempts are spent."""
        self.counters["save_failures"] += 1
        self.telemetry.count("checkpoint/save_failures")
        self.telemetry.instant("checkpoint_save_failed", step=step,
                               attempts=self.save_attempts, error=str(e)[:300])
        log.error("%s at step %d FAILED after %d attempts: %s", what, step,
                  self.save_attempts, e)

    def _save_background(self, step: int, host: dict, t0: float) -> None:
        try:
            self._save_with_retry(step, host, t0=t0)
        except OSError as e:
            # the cadence save is gone; training must not die for it
            self._failed(step, e, "checkpoint save")

    def _save_with_retry(self, step: int, host: dict, *, retain: bool = True,
                         t0: Optional[float] = None) -> None:
        """Bounded attempts with exponential backoff and jitter; raises the
        last ``OSError`` when the budget is spent. A commit counts
        ``checkpoint/completed`` and the seconds since ``t0``, the save's
        start, as ``checkpoint/io_seconds``."""
        attempt = 0
        while True:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step, attempt)
                self._commit(step, host, retain)
                break
            except OSError as e:
                attempt += 1
                if attempt >= self.save_attempts:
                    raise
                delay = min(self.save_retry_base_s * (2 ** (attempt - 1)),
                            _SAVE_RETRY_CAP_S)
                delay *= 1.0 + random.uniform(0.0, 0.25)
                log.warning("checkpoint save at step %d: attempt %d/%d failed "
                            "(%s); retrying in %.2fs", step, attempt,
                            self.save_attempts, e, delay)
                self.counters["save_retries"] += 1
                self.telemetry.count("checkpoint/save_retries")
                time.sleep(delay)
        if attempt:
            self.telemetry.instant("checkpoint_save_retried", step=step, retries=attempt)
        if t0 is not None:
            self.telemetry.count("checkpoint/io_seconds",
                                 round(time.perf_counter() - t0, 6))
        self.telemetry.count("checkpoint/completed")

    def _commit(self, step: int, host: dict, retain: bool) -> None:
        """Write under a temporary name, fsync, rename into place, fsync
        the directory; then the manifest and retention."""
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f"{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.directory, str(step))
            if os.path.isdir(final):              # save_as_only at an existing step
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _fsync_dir(self.directory)
        try:
            ckpt_manifest.write_manifest(self.directory, step)
            self.counters["manifests"] += 1
            self.telemetry.count("checkpoint/manifests")
        except OSError as e:
            log.warning("checksum manifest for step %d failed: %s (the step "
                        "stays restorable but unverifiable)", step, e)
        if retain:
            for old in self.all_steps()[:-self.max_to_keep]:
                self._delete(old)
        ckpt_manifest.sweep_manifests(self.directory, self.all_steps())
        self.timings["commit_ms"] = (time.perf_counter() - t0) * 1e3

    def _delete(self, step: int) -> None:
        shutil.rmtree(os.path.join(self.directory, str(step)), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until the in-flight background save has committed (or
        failed) and its manifest is written; the ``checkpoint_wait`` span
        shows a save's write that outlived its overlap with training."""
        with self.telemetry.span("checkpoint_wait",
                                 pending=int(self._thread is not None)):
            self._join()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._in_flight = None

    def save_as_only(self, step: int, state: dict) -> None:
        """Replace whatever checkpoints exist with this one (the best
        checkpoint's slot): a resumed run can replay a new best at a step
        older than the recorded one, which retention by step number would
        lose. The intent marker lands FIRST, then the new step is written
        and committed BEFORE the old ones are deleted; a crash in between
        leaves a marker naming the survivor, which ``latest_step`` prefers
        and the next ``save_as_only`` completes the sweep for."""
        self.wait_until_finished()
        if not self.primary:
            return
        prev = self._marker_step()
        if prev is not None:
            for s in self.all_steps():
                if s != prev:
                    log.warning("completing interrupted save_as_only sweep: "
                                "deleting stale step %d (keeping %d)", s, prev)
                    self._delete(s)
        marker = os.path.join(self.directory, self._ONLY_MARKER)
        tmp = f"{marker}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"step": int(step)}, f)
        os.replace(tmp, marker)
        t0 = time.perf_counter()
        with self.telemetry.span("checkpoint", step=int(step), best=True):
            host = self._to_host(state)
            self.timings["initiate_ms"] = (time.perf_counter() - t0) * 1e3
            self.counters["saves"] += 1
            self._save_with_retry(int(step), host, retain=False, t0=t0)
        self.telemetry.count("checkpoint/saves")
        for s in self.all_steps():
            if s != step:
                self._delete(s)
        self._clear_marker()
        ckpt_manifest.sweep_manifests(self.directory, self.all_steps())

    # ---- restore ----------------------------------------------------------

    def verified_restore_step(self) -> Optional[int]:
        """The step ``restore()`` picks with no explicit step: the newest
        VERIFIED one. A step whose manifest fails is refused by name and
        the next-older verified step wins; an unmanifested step is
        accepted with a note. The intent marker's step, when there is one,
        is the only candidate."""
        marked = self._marker_step()
        candidates = [marked] if marked is not None else self.all_steps()
        step, refusals = ckpt_manifest.latest_verified_step(
            self.directory, candidates=candidates)
        refused = [r for r in refusals if r["verdict"] == "refused"]
        self.counters["verify_refused"] += len(refused)
        for refusal in refused:
            self.telemetry.count("checkpoint/verify_refused")
            self.telemetry.instant("checkpoint_refused", step=refusal["step"],
                                   problems=refusal["problems"][:8])
        if step is not None and refused:
            log.warning("falling back to checkpoint step %d (next-older "
                        "verified step)", step)
        return step

    def restore(self, step: Optional[int] = None) -> dict:
        """The checkpoint's flat dict, on the CPU. With no ``step``, the
        newest verified one; an explicit step that fails its manifest
        raises ``ValueError`` naming the mismatched files."""
        if step is None:
            step = self.verified_restore_step()
            if step is None:
                raise FileNotFoundError(
                    f"no restorable checkpoint under {self.directory} (none "
                    "exist, or every existing step failed its checksum "
                    "manifest)")
        else:
            verdict, problems = ckpt_manifest.verify_step(self.directory, step)
            if verdict is False:
                self.counters["verify_refused"] += 1
                self.telemetry.count("checkpoint/verify_refused")
                self.telemetry.instant("checkpoint_refused", step=step,
                                       problems=problems[:8])
                raise ValueError(f"checkpoint step {step} REFUSED by its checksum "
                                 f"manifest: {'; '.join(problems)}")
        t0 = time.perf_counter()
        with self.telemetry.span("checkpoint_restore", step=step):
            state = torch.load(os.path.join(self.directory, str(int(step)), STATE_FILE),
                               map_location="cpu", weights_only=True)
        self.timings["restore_ms"] = (time.perf_counter() - t0) * 1e3
        self.counters["restores"] += 1
        self.telemetry.count("checkpoint/restore_seconds",
                             round(self.timings["restore_ms"] / 1e3, 6))
        self.telemetry.count("checkpoint/restores")
        return state

    def close(self) -> None:
        self.wait_until_finished()


def merge_params(restored: dict, fresh: dict, *, verbose: bool = True) -> dict:
    """Shape-tolerant merge over flat ``{name: tensor}`` dicts: the restored
    tensor where the name is present with the fresh tensor's shape, else the
    fresh one (``load_state_dict(strict=False)`` plus a head swap: a
    10-class checkpoint restored into a 3-class model keeps the backbone
    and re-initialises the head)."""
    merged = {}
    for name, fresh_leaf in fresh.items():
        r = restored.get(name)
        if r is not None and tuple(r.shape) == tuple(fresh_leaf.shape):
            merged[name] = r
            continue
        if verbose and is_primary_process():
            why = "missing" if r is None else f"shape {tuple(r.shape)} != {tuple(fresh_leaf.shape)}"
            log.info("merge_params: keeping fresh %s (%s)", name, why)
        merged[name] = fresh_leaf
    return merged
