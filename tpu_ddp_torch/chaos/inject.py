"""Step-triggered deterministic fault injection into a live training run.

Counterpart of ``tpu_ddp/chaos/inject.py``, fault for fault. Six kinds, each
modelled on a failure a fleet suffers:

- ``kill_host`` — ``os._exit`` mid-loop: no drain, no ``run_end``, no sink
  shutdown, byte for byte what a SIGKILL or a lost host leaves behind (the
  goodput ledger classifies it ``killed``). Optionally records the
  post-loss device capacity into ``<run_dir>/capacity.json``, the
  scheduler's surviving-capacity signal an elastic supervisor re-meshes
  from.
- ``hang`` — the process stops beating: the injector blocks the step loop
  without exiting, so the watchdog deadline passes, the stack dump fires,
  and (with ``--watchdog-abort``) the run exits with the ``hang`` class.
- ``checkpoint_corrupt`` — flips one bit in a COMMITTED checkpoint file
  (it waits for the step's commit and checksum manifest first, so the
  corruption is always detectable): the restore path
  (``checkpoint/manager.py``) must refuse the step by name and fall back
  to an older verified step.
- ``save_io_flake`` — raises ``OSError`` from the checkpointer's
  ``fault_hook`` for the first N save attempts at or after a step: the
  bounded-backoff retry path must absorb it.
- ``data_stall`` — sleeps the input pipeline at a step. With a ``stage``
  field it instead wedges that ONE named loader stage
  (``index``/``gather``/...) from the loader's observer seam
  (``datapath/stages.py``): the StageMonitor writes the stage
  ``in_flight`` to the data-health file BEFORE the sleep, so DAT001 and
  the hang bundle's ``suspect_stage`` name it while the step wedges.
  ``batches`` (default 1) bounds how many entries of that stage stall. The
  stage-targeted form needs the staged pipeline on the run
  (``--prefetch-batches N`` or ``--prefetch-depth 0``: the seam exists
  only there).
- ``comm_stall`` — stalls the gradient ring mid-collective: a per-hop
  delay raised from the ring hop hook
  (``parallel/collectives.py::set_ring_hop_hook``, ridden by the comms hop
  monitor). The first ``hops`` hops at or after the trigger step each
  sleep ``delay_s`` inside the collective, so the hop monitor's health
  file names the stalled collective ``in_flight`` while the step wedges.
  Needs ``--comms-monitor`` on the run (the hook is installed only then).

Determinism contract: faults are keyed by list position (``fault id``),
trigger on ``(process_index, step)``, and fire ONCE PER LOGICAL RUN: fired
ids persist in ``<run_dir>/chaos-state.json`` across restarts, so a
``--resume`` life replaying past the trigger step does not re-fire the kill
and crash-loop a supervisor. The corruption's byte and bit are drawn from
``random.Random(seed ^ fault_id)``. Stdlib-only: the injector must work
when torch is the thing being broken.
"""

from __future__ import annotations

import json
import logging
import os
import random
import sys
import time
from typing import Optional

log = logging.getLogger(__name__)

CHAOS_SCHEMA_VERSION = 1

#: exit code a kill_host fault dies with (the 128+9 convention a real
#: SIGKILL produces — the supervisor treats the trace, not the code, as
#: classification truth, but the code should look the part)
KILL_EXIT_CODE = 137

FAULT_KINDS = (
    "kill_host",
    "hang",
    "checkpoint_corrupt",
    "save_io_flake",
    "data_stall",
    "comm_stall",
)

_STATE_FILE = "chaos-state.json"
_CAPACITY_FILE = "capacity.json"


def capacity_file(run_dir: str) -> str:
    return os.path.join(run_dir, _CAPACITY_FILE)


def load_spec(path: str) -> dict:
    """Parse + validate a chaos spec; every refusal names the fault and
    the field so a typo'd spec dies at launch, not at its trigger step."""
    with open(path) as f:
        spec = json.load(f)
    if not isinstance(spec, dict):
        raise ValueError(f"chaos spec {path!r}: top level must be an object")
    version = spec.get("chaos_schema_version")
    if not isinstance(version, int) or version > CHAOS_SCHEMA_VERSION:
        raise ValueError(
            f"chaos spec {path!r}: chaos_schema_version must be an int "
            f"<= {CHAOS_SCHEMA_VERSION}, got {version!r}")
    faults = spec.get("faults")
    if not isinstance(faults, list) or not faults:
        raise ValueError(f"chaos spec {path!r}: 'faults' must be a "
                         "non-empty list")
    for i, fault in enumerate(faults):
        label = f"chaos spec {path!r} fault #{i}"
        if not isinstance(fault, dict):
            raise ValueError(f"{label}: must be an object")
        kind = fault.get("kind")
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"{label}: unknown kind {kind!r}; valid kinds: "
                f"{', '.join(FAULT_KINDS)}")
        step = fault.get("step")
        if not isinstance(step, int) or step < 0:
            raise ValueError(f"{label}: 'step' must be an int >= 0, "
                             f"got {step!r}")
        pid = fault.get("process_index", 0)
        if not isinstance(pid, int) or pid < 0:
            raise ValueError(f"{label}: 'process_index' must be an int "
                             f">= 0, got {pid!r}")
        if kind == "save_io_flake":
            times = fault.get("times", 1)
            if not isinstance(times, int) or times < 1:
                raise ValueError(f"{label}: 'times' must be an int >= 1, "
                                 f"got {times!r}")
        if kind == "checkpoint_corrupt":
            await_step = fault.get("await_step")
            if await_step is not None and (
                not isinstance(await_step, int) or await_step < 0
            ):
                raise ValueError(f"{label}: 'await_step' must be an int "
                                 f">= 0 when given, got {await_step!r}")
        if kind == "kill_host":
            survivors = fault.get("survivors")
            if survivors is not None and (
                not isinstance(survivors, int) or survivors < 1
            ):
                raise ValueError(f"{label}: 'survivors' must be an int "
                                 f">= 1 when given, got {survivors!r}")
        if kind == "data_stall":
            stall = fault.get("stall_s", 1.0)
            if not isinstance(stall, (int, float)) or stall < 0:
                raise ValueError(f"{label}: 'stall_s' must be a number "
                                 f">= 0, got {stall!r}")
            stage = fault.get("stage")
            if stage is not None:
                from tpu_ddp_torch.datapath.stages import STAGES

                if stage not in STAGES:
                    raise ValueError(
                        f"{label}: 'stage' must be one of "
                        f"{', '.join(STAGES)}, got {stage!r}")
                batches = fault.get("batches", 1)
                if not isinstance(batches, int) or batches < 1:
                    raise ValueError(f"{label}: 'batches' must be an int "
                                     f">= 1, got {batches!r}")
        if kind == "comm_stall":
            delay = fault.get("delay_s", 30.0)
            if not isinstance(delay, (int, float)) or delay <= 0:
                raise ValueError(f"{label}: 'delay_s' must be a number "
                                 f"> 0, got {delay!r}")
            hops = fault.get("hops", 1)
            if not isinstance(hops, int) or hops < 1:
                raise ValueError(f"{label}: 'hops' must be an int >= 1, "
                                 f"got {hops!r}")
    seed = spec.get("seed", 0)
    if not isinstance(seed, int):
        raise ValueError(f"chaos spec {path!r}: 'seed' must be an int")
    return spec


class ChaosInjector:
    """Drives one rank's share of a chaos spec inside the Trainer.

    Wiring (``train/trainer.py``): ``on_step(host_step)`` runs in the
    step loop after the watchdog beat (so a ``hang`` blocks the NEXT
    beat, as a wedged collective would); ``save_fault_hook`` is handed to
    the Checkpointer as its ``fault_hook``; ``comm_stall_hook`` to the hop
    monitor and ``data_stall_hook`` to the stage monitor.
    """

    def __init__(self, spec_path: str, run_dir: str, *,
                 process_index: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 telemetry=None):
        self.spec = load_spec(spec_path)
        self.run_dir = run_dir
        self.process_index = process_index
        self.checkpoint_dir = checkpoint_dir
        if telemetry is None:
            from tpu_ddp_torch.telemetry import NULL as telemetry
        self.telemetry = telemetry
        self.seed = int(self.spec.get("seed", 0))
        self.faults = list(self.spec["faults"])
        self._state = self._load_state()
        # the last step the loop finished (on_step runs AFTER a step
        # executes, so during step N this reads N-1): the comm_stall
        # hook fires mid-collective INSIDE step N when N >= its trigger
        self._last_step: Optional[int] = None
        for i, fault in enumerate(self.faults):
            if (fault["kind"] == "checkpoint_corrupt"
                    and not self.checkpoint_dir
                    and self._mine(fault)):
                raise ValueError(
                    f"chaos fault #{i} (checkpoint_corrupt) needs a "
                    "checkpoint dir, and this run has none")

    # -- fire-once state ---------------------------------------------------

    @property
    def _state_path(self) -> str:
        return os.path.join(self.run_dir, _STATE_FILE)

    def _load_state(self) -> dict:
        try:
            with open(self._state_path) as f:
                state = json.load(f)
        except (OSError, ValueError):
            state = {}
        state.setdefault("fired", [])
        state.setdefault("flake_remaining", {})
        state.setdefault("stall_remaining", {})
        return state

    def _save_state(self) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        tmp = f"{self._state_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self._state, f)
        os.replace(tmp, self._state_path)

    def _fired(self, fault_id: int) -> bool:
        return fault_id in self._state["fired"]

    def _mark_fired(self, fault_id: int) -> None:
        """Persist BEFORE the fault's effect: a kill_host that exits
        before recording would re-fire on every resumed incarnation and
        crash-loop the supervisor."""
        if not self._fired(fault_id):
            self._state["fired"].append(fault_id)
            self._save_state()

    def _mine(self, fault: dict) -> bool:
        return int(fault.get("process_index", 0)) == self.process_index

    def _announce(self, fault_id: int, fault: dict, **extra) -> None:
        self.telemetry.count("chaos/faults")
        self.telemetry.instant(
            "chaos_fault", kind=fault["kind"], fault_id=fault_id,
            trigger_step=fault["step"], **extra)
        log.warning("chaos: fault #%d (%s) firing at its trigger "
                    "(step >= %d)%s", fault_id, fault["kind"],
                    fault["step"],
                    f" {extra}" if extra else "")

    # -- step-loop injection ----------------------------------------------

    def on_step(self, step: int) -> None:
        """Fire every due, unfired, this-host fault, in spec order (two
        faults due at one step fire in list order — the ordering the
        corrupt-then-kill sequence depends on)."""
        self._last_step = int(step)
        for fault_id, fault in enumerate(self.faults):
            if (not self._mine(fault) or self._fired(fault_id)
                    or step < int(fault["step"])
                    # hook-driven faults fire from their own seams
                    or fault["kind"] in ("save_io_flake", "comm_stall")
                    or (fault["kind"] == "data_stall"
                        and fault.get("stage"))):
                continue
            getattr(self, f"_fire_{fault['kind']}")(fault_id, fault, step)

    def _fire_data_stall(self, fault_id: int, fault: dict,
                         step: int) -> None:
        self._mark_fired(fault_id)
        stall = float(fault.get("stall_s", 1.0))
        self._announce(fault_id, fault, step=step, stall_s=stall)
        time.sleep(stall)

    def _fire_hang(self, fault_id: int, fault: dict, step: int) -> None:
        self._mark_fired(fault_id)
        hang_s = float(fault.get("hang_s", 3600.0))
        self._announce(fault_id, fault, step=step, hang_s=hang_s)
        # block the step loop WITHOUT exiting: heartbeats stop, the
        # watchdog deadline passes, and --watchdog-abort turns the wedge
        # into a restartable `hang` exit (without it, this models the
        # eternal silent wedge — bounded here so an unsupervised test
        # run eventually continues)
        deadline = time.monotonic() + hang_s
        while time.monotonic() < deadline:
            time.sleep(0.1)

    def _fire_kill_host(self, fault_id: int, fault: dict,
                        step: int) -> None:
        self._mark_fired(fault_id)
        survivors = fault.get("survivors")
        if survivors is not None:
            # the scheduler's view of post-loss capacity: what the
            # elastic supervisor's --capacity-file re-mesh reads
            path = capacity_file(self.run_dir)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({
                    "capacity_schema_version": 1,
                    "devices": int(survivors),
                    "wall_time": time.time(),
                    "source": f"chaos kill_host fault #{fault_id}",
                }, f)
            os.replace(tmp, path)
        self._announce(fault_id, fault, step=step, survivors=survivors)
        sys.stderr.write(
            f"chaos: kill_host fault #{fault_id} at step {step} — "
            f"hard exit {KILL_EXIT_CODE}, no drain\n")
        sys.stderr.flush()
        # the JSONL sink is per-line flushed, so the chaos_fault instant
        # is already durable; _exit skips every drain path on purpose
        os._exit(KILL_EXIT_CODE)

    def _fire_checkpoint_corrupt(self, fault_id: int, fault: dict,
                                 step: int) -> None:
        from tpu_ddp_torch.checkpoint import manifest as ckpt_manifest

        await_step = fault.get("await_step")
        timeout_s = float(fault.get("timeout_s", 60.0))
        deadline = time.monotonic() + timeout_s
        target_step = None
        # wait for a committed, MANIFESTED target: corrupting an
        # in-flight save would model a torn write (also interesting, but
        # not this fault), and corrupting before the manifest lands
        # would leave the flip undetectable — the point is proving the
        # verifier catches it
        while time.monotonic() < deadline:
            steps = ckpt_manifest.committed_steps(self.checkpoint_dir)
            if await_step is not None:
                steps = [s for s in steps if s >= await_step]
            manifested = [
                s for s in steps
                if ckpt_manifest.read_manifest(self.checkpoint_dir, s)
                is not None
            ]
            if manifested:
                target_step = max(manifested)
                break
            time.sleep(0.05)
        self._mark_fired(fault_id)
        if target_step is None:
            log.error(
                "chaos: checkpoint_corrupt fault #%d found no committed+"
                "manifested checkpoint%s within %.0fs; nothing corrupted",
                fault_id,
                f" >= step {await_step}" if await_step is not None else "",
                timeout_s)
            self._announce(fault_id, fault, step=step, target_step=None)
            return
        path, offset = self._flip_bit(fault_id, target_step)
        self._announce(
            fault_id, fault, step=step, target_step=target_step,
            corrupted_file=os.path.relpath(path, self.checkpoint_dir),
            bit_offset=offset)

    def _flip_bit(self, fault_id: int, target_step: int) -> tuple:
        """Flip one seeded-random bit in the step's largest data file
        (the state payload, ``state.pt``: a flipped bit in a tiny
        metadata file would be caught by a parser and miss the
        silent-garbage case this fault exists for)."""
        root = os.path.join(self.checkpoint_dir, str(target_step))
        files = sorted(
            os.path.join(dirpath, name)
            for dirpath, _dirs, names in os.walk(root)
            for name in names
        )
        target = max(files, key=os.path.getsize)
        size = os.path.getsize(target)
        rng = random.Random(self.seed ^ (0x9E3779B9 + fault_id))
        offset = rng.randrange(max(size, 1))
        with open(target, "r+b") as f:
            f.seek(offset)
            byte = f.read(1) or b"\x00"
            f.seek(offset)
            f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
        return target, offset

    # -- checkpointer seam -------------------------------------------------

    def save_fault_hook(self, step: int, attempt: int) -> None:
        """``Checkpointer.fault_hook``: raise OSError for a
        ``save_io_flake`` fault's first N attempts at/after its step.
        The remaining-failure count persists in the chaos state file so
        a resumed incarnation doesn't get a fresh allowance."""
        del attempt
        for fault_id, fault in enumerate(self.faults):
            if (fault["kind"] != "save_io_flake" or not self._mine(fault)
                    or step < int(fault["step"])):
                continue
            key = str(fault_id)
            remaining = self._state["flake_remaining"].get(
                key, int(fault.get("times", 1)))
            if remaining <= 0:
                continue
            self._state["flake_remaining"][key] = remaining - 1
            if remaining - 1 <= 0 and not self._fired(fault_id):
                self._state["fired"].append(fault_id)
            self._save_state()
            self.telemetry.count("chaos/faults")
            self.telemetry.instant(
                "chaos_fault", kind="save_io_flake", fault_id=fault_id,
                trigger_step=fault["step"], step=step,
                remaining=remaining - 1)
            raise OSError(
                f"chaos: injected save IO failure (fault #{fault_id}, "
                f"{remaining - 1} more to come)")

    # -- ring hop seam -----------------------------------------------------

    def comm_stall_hook(self, axis: str, hop: int) -> None:
        """The hop monitor's ``fault_hook`` (the ring hop seam,
        ``parallel/collectives.py``): sleep ``delay_s`` inside the
        collective for a ``comm_stall`` fault's first N hops at/after
        its trigger step. Runs AFTER the monitor's health write, so the
        stalled collective is already named ``in_flight`` on disk when
        the watchdog fires. The remaining-hop count persists in the
        chaos state file, so a resumed incarnation doesn't stall again
        (fire-once per logical run, like every other fault)."""
        for fault_id, fault in enumerate(self.faults):
            if fault["kind"] != "comm_stall" or not self._mine(fault):
                continue
            want_axis = fault.get("axis")
            if want_axis is not None and want_axis != axis:
                continue
            # during step N the loop's last on_step was N-1, so the
            # fault for trigger step S is due once _last_step >= S - 1
            last = -1 if self._last_step is None else self._last_step
            if last < int(fault["step"]) - 1:
                continue
            key = str(fault_id)
            remaining = self._state["stall_remaining"].get(
                key, int(fault.get("hops", 1)))
            if remaining <= 0:
                continue
            self._state["stall_remaining"][key] = remaining - 1
            if remaining - 1 <= 0 and not self._fired(fault_id):
                self._state["fired"].append(fault_id)
            self._save_state()
            delay = float(fault.get("delay_s", 30.0))
            self.telemetry.count("chaos/faults")
            self.telemetry.instant(
                "chaos_fault", kind="comm_stall", fault_id=fault_id,
                trigger_step=fault["step"], axis=axis, hop=hop,
                delay_s=delay, remaining=remaining - 1)
            log.warning(
                "chaos: comm_stall fault #%d stalling axis %s hop %d "
                "for %.1fs (%d more hop(s) to stall)",
                fault_id, axis, hop, delay, remaining - 1)
            time.sleep(delay)

    def wants_comm_stall(self) -> bool:
        """True when this host's share of the spec includes a
        ``comm_stall`` — the Trainer refuses such a spec unless the
        comms hop monitor (its seam) is on."""
        return any(f["kind"] == "comm_stall" and self._mine(f)
                   for f in self.faults)

    # -- loader stage seam -------------------------------------------------

    def data_stall_hook(self, stage: str) -> None:
        """The StageMonitor's ``stall_hook`` (the staged loader's
        observer seam, ``datapath/stages.py``): sleep ``stall_s`` at the
        entry of the named stage for a stage-targeted ``data_stall``
        fault's first N batches at/after its trigger step. Runs AFTER
        the monitor's in-flight health write, so the wedged stage is
        already named on disk when the watchdog fires and the hang
        bundle's ``suspect_stage`` reads it. The remaining-batch count
        persists in the chaos state file, so a resumed incarnation
        doesn't stall again (fire-once per logical run)."""
        for fault_id, fault in enumerate(self.faults):
            if (fault["kind"] != "data_stall" or not self._mine(fault)
                    or fault.get("stage") != stage):
                continue
            # during step N the loop's last on_step was N-1, so the
            # fault for trigger step S is due once _last_step >= S - 1
            # (under --prefetch-batches the producer runs ahead of the
            # loop; the window is a floor, not an exact step match)
            last = -1 if self._last_step is None else self._last_step
            if last < int(fault["step"]) - 1:
                continue
            key = str(fault_id)
            remaining = self._state["stall_remaining"].get(
                key, int(fault.get("batches", 1)))
            if remaining <= 0:
                continue
            self._state["stall_remaining"][key] = remaining - 1
            if remaining - 1 <= 0 and not self._fired(fault_id):
                self._state["fired"].append(fault_id)
            self._save_state()
            stall = float(fault.get("stall_s", 1.0))
            self.telemetry.count("chaos/faults")
            self.telemetry.instant(
                "chaos_fault", kind="data_stall", fault_id=fault_id,
                trigger_step=fault["step"], stage=stage,
                stall_s=stall, remaining=remaining - 1)
            log.warning(
                "chaos: data_stall fault #%d wedging stage %s "
                "for %.1fs (%d more batch(es) to stall)",
                fault_id, stage, stall, remaining - 1)
            time.sleep(stall)

    def wants_data_stall_stage(self) -> bool:
        """True when this host's share of the spec includes a
        stage-targeted ``data_stall`` — the Trainer refuses such a spec
        unless the staged pipeline (its seam) is on."""
        return any(f["kind"] == "data_stall" and f.get("stage")
                   and self._mine(f) for f in self.faults)
