"""``tpu-ddp-torch elastic train …`` — the supervised restart loop.

The port's copy of ``tpu_ddp/elastic/supervisor.py``: the same loop,
decisions and ``elastic.jsonl`` records. A life differs in how it starts:
a JAX child is one process that owns every device, a port rank is one
process, so a life of ``--n-devices N`` (N > 1) runs through the port's
launcher, ``python -m tpu_ddp_torch.cli.launch --nproc-per-node N --
python -m tpu_ddp_torch.cli.train <argv>``, and any other life is one
``python -m tpu_ddp_torch.cli.train <argv>``. Without ``--n-devices`` in
the train args (the JAX "all visible devices") the first life is one
rank: counting cards would import torch into the supervisor.

Wraps the training CLI in the sense–act loop the observability stack
feeds: launch the trainer as a child process;
when it dies, classify the death from its own trace evidence (the
goodput ledger's exit taxonomy — killed / hang / oom / preempted /
health_halt, ``ledger/stitch.py``); ask the restart policy
(``elastic/policy.py``) whether this failure class has budget left;
back off; re-read the surviving device capacity and re-mesh
(``elastic/remesh.py`` — refusing by name when the survivors cannot
satisfy the strategy, falling back to the auto-tuner's next-ranked
candidate when ``--fallback-plan`` is given); verify the checkpoint
dir's manifests so the relaunch resumes from the newest *verified*
step (``elastic/recovery.py``); and append every decision to
``<run_dir>/elastic.jsonl``, which ``tpu-ddp-torch goodput`` joins so each
``restart_gap`` second is attributed to a decision.

The supervisor is stdlib-only and never imports torch: it must keep
functioning precisely when the training runtime is the thing that
keeps dying. The child is a fresh process per incarnation (a re-mesh
NEEDS a fresh process — device topology is latched at backend init).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from tpu_ddp_torch.elastic.policy import (
    BackoffPolicy,
    RestartPolicy,
    parse_budgets,
)
from tpu_ddp_torch.elastic.recovery import (
    append_decision,
    read_capacity,
    resume_assessment,
)
from tpu_ddp_torch.elastic.remesh import (
    RemeshPlan,
    RemeshRefusal,
    fallback_from_tune,
    plan_remesh,
)

#: child flags the supervisor rewrites between incarnations; True when
#: the flag consumes a value argument
_MANAGED_FLAGS = {
    "--n-devices": True,
    "--mesh": True,
    "--parallelism": True,
    "--resume": False,
    "--zero1": False,
    "--grad-compress": True,
    "--steps-per-call": True,
}


def child_flag_value(args: Sequence[str], flag: str) -> Optional[str]:
    """The value of ``--flag v`` / ``--flag=v`` in a child argv (last
    occurrence wins, argparse-style); None when absent. A flag whose
    value slot holds another option (``--flag --other``) yields None —
    the child's argparse would reject that argv anyway, and silently
    adopting ``--other`` as a value would send supervisor state into a
    directory named like an option."""
    value: Optional[str] = None
    for i, a in enumerate(args):
        if a == flag:
            if i + 1 < len(args) and not args[i + 1].startswith("--"):
                value = args[i + 1]
        elif a.startswith(flag + "="):
            value = a[len(flag) + 1:]
    return value


def strip_flag(args: List[str], flag: str, has_value: bool) -> List[str]:
    out: List[str] = []
    skip = False
    for a in args:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = has_value
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def rewrite_child_args(args: Sequence[str], plan: RemeshPlan, *,
                       resume: bool) -> List[str]:
    """Child argv for the next incarnation: the plan's layout flags
    replace the old ones; on a tuner fallback the strategy/overlay
    flags are replaced wholesale (a fallback IS a different program
    family, deliberately); ``--resume`` is ensured on restarts."""
    out = list(args)
    out = strip_flag(out, "--n-devices", True)
    out = strip_flag(out, "--mesh", True)
    out += ["--n-devices", str(plan.n_devices)]
    mesh_arg = plan.mesh_arg()
    if mesh_arg:
        out += ["--mesh", mesh_arg]
    if plan.source == "fallback":
        for flag in ("--parallelism", "--zero1", "--grad-compress",
                     "--steps-per-call"):
            out = strip_flag(out, flag, _MANAGED_FLAGS[flag])
        if plan.parallelism:
            out += ["--parallelism", plan.parallelism]
        for flag, value in (plan.extra_flags or {}).items():
            out += [flag] + ([value] if value else [])
    if resume and "--resume" not in out:
        out += ["--resume"]
    return out


def classify_exit(run_dir: str,
                  prior_families: int) -> Optional[str]:
    """Exit class of the newest incarnation's trace, via the goodput
    ledger's taxonomy; None when the child left no NEW trace family
    (died before the telemetry header — a spawn failure)."""
    from tpu_ddp_torch.ledger.stitch import (
        discover_incarnations,
        load_incarnation,
    )

    families = discover_incarnations(run_dir)
    if len(families) <= prior_families:
        return None
    index, files = families[-1]
    try:
        return load_incarnation(index, files).exit
    except (OSError, ValueError):
        return None


def count_families(run_dir: str) -> int:
    from tpu_ddp_torch.ledger.stitch import discover_incarnations

    try:
        return len(discover_incarnations(run_dir))
    except OSError:
        return 0


class Supervisor:
    """One logical run's restart loop (see module docstring).

    ``run_child`` is injectable for tests; the default execs the life
    (module docstring) and returns its exit code. Either way it is handed
    the train argv alone.
    """

    def __init__(
        self,
        train_args: Sequence[str],
        *,
        policy: Optional[RestartPolicy] = None,
        fallback_plan: Optional[str] = None,
        capacity_file: Optional[str] = None,
        max_incarnations: int = 12,
        run_child=None,
    ):
        self.train_args = list(train_args)
        self.run_dir = child_flag_value(train_args, "--telemetry-dir")
        if not self.run_dir:
            raise SystemExit(
                "tpu-ddp-torch elastic: the train args must include "
                "--telemetry-dir — the supervisor classifies deaths "
                "from the run dir's trace evidence and logs its "
                "decisions there (a run it cannot observe is a run it "
                "cannot supervise)")
        self.checkpoint_dir = child_flag_value(
            train_args, "--checkpoint-dir")
        self.policy = policy or RestartPolicy()
        self.fallback_plan = fallback_plan
        self.capacity_file = capacity_file or os.path.join(
            self.run_dir, "capacity.json")
        self.max_incarnations = max_incarnations
        self.run_child = run_child or self._exec_child
        n_dev = child_flag_value(train_args, "--n-devices")
        mesh_text = child_flag_value(train_args, "--mesh")
        mesh = None
        if mesh_text:
            mesh = {}
            for part in mesh_text.split(","):
                if "=" in part:
                    axis, _, size = part.partition("=")
                    mesh[axis.strip()] = int(size)
        global_batch = child_flag_value(
            train_args, "--global-batch-size")
        self.global_batch = int(global_batch) if global_batch else None
        if self.global_batch is None:
            print(
                "tpu-ddp-torch elastic: note: child uses --batch-size "
                "(per-shard) semantics; a re-mesh will change the "
                "GLOBAL batch. Pass --global-batch-size to hold the "
                "recipe fixed across re-meshes (docs/resilience.md)",
                file=sys.stderr)
        self.plan = RemeshPlan(
            n_devices=int(n_dev) if n_dev else 0,  # 0 = one rank
            parallelism=child_flag_value(train_args, "--parallelism"),
            mesh=mesh,
            source="initial",
        )

    # -- child execution ---------------------------------------------------

    def _exec_child(self, argv: List[str]) -> int:
        cmd = [sys.executable, "-m", "tpu_ddp_torch.cli.train", *argv]
        ranks = int(child_flag_value(argv, "--n-devices") or 1)
        if ranks > 1:
            # one process a rank: the launcher's lifecycle lands beside
            # the trace as launch-n0.jsonl, which no trace family counts
            cmd = [sys.executable, "-m", "tpu_ddp_torch.cli.launch",
                   "--nproc-per-node", str(ranks),
                   "--telemetry-dir", self.run_dir, "--", *cmd]
        print(f"[elastic] exec: {' '.join(cmd)}", flush=True)
        return subprocess.run(cmd).returncode

    def _child_argv(self, *, resume: bool) -> List[str]:
        if self.plan.source == "initial" and self.plan.n_devices == 0:
            # first launch with no explicit --n-devices: hand the args
            # through untouched (the child is one rank)
            out = list(self.train_args)
            if resume and "--resume" not in out:
                out += ["--resume"]
            return out
        return rewrite_child_args(
            self.train_args, self.plan, resume=resume)

    # -- the loop ----------------------------------------------------------

    def run(self) -> int:
        user_resume = "--resume" in self.train_args
        incarnation = 0
        append_decision(self.run_dir, {
            "event": "launch",
            "incarnation": incarnation,
            "action": "start",
            "plan": self.plan.to_json(),
            "resume": user_resume,
        })
        while True:
            if incarnation >= self.max_incarnations:
                append_decision(self.run_dir, {
                    "event": "stop",
                    "incarnation": incarnation,
                    "action": "stop",
                    "reason": (f"--max-incarnations {self.max_incarnations} "
                               "reached"),
                })
                print(f"[elastic] giving up: {self.max_incarnations} "
                      "incarnations", file=sys.stderr)
                return 1
            prior = count_families(self.run_dir)
            argv = self._child_argv(
                resume=user_resume or incarnation > 0)
            rc = self.run_child(argv)
            exit_class = classify_exit(self.run_dir, prior)
            if exit_class is None:
                exit_class = "spawn_failure" if rc != 0 else "clean"
            # a hang death carries its stuck-collective evidence when the
            # child ran with --comms-monitor: the forensics bundle (or the
            # raw health files) name the ring that wedged — the decision
            # log is where the operator reads WHY this restart happened
            suspect = None
            if exit_class == "hang":
                from tpu_ddp_torch.comms.forensics import suspect_from_files

                try:
                    suspect = suspect_from_files(self.run_dir)
                except Exception:
                    suspect = None
                if suspect:
                    print(f"[elastic] hang forensics: suspect collective "
                          f"{suspect.get('key')} "
                          f"({suspect.get('source')})", flush=True)
            # every death also gets the cross-observatory verdict: the
            # DIA rule registry over whatever the dead incarnation left
            # behind (docs/diagnose.md) — None is an honest "no suspect"
            verdict = None
            if exit_class != "clean":
                from tpu_ddp_torch.diagnose.rules import likely_cause

                verdict = likely_cause(self.run_dir)
                if verdict:
                    print(f"[elastic] diagnose: {verdict['rule']} "
                          f"{verdict['title']} — {verdict['message']}",
                          flush=True)
            if exit_class == "clean" and rc == 0:
                append_decision(self.run_dir, {
                    "event": "exit",
                    "incarnation": incarnation,
                    "exit_class": "clean",
                    "action": "done",
                    "rc": rc,
                })
                print(f"[elastic] incarnation {incarnation} finished "
                      "clean; supervision complete", flush=True)
                return 0
            if exit_class == "clean":
                # trace says drained clean but the process failed after
                # (post-run eval crash, sink trouble): restartable, but
                # as its own story, not a phantom 'clean'
                exit_class = "killed"
            decision = self.policy.decide(exit_class)
            if decision.action == "stop":
                append_decision(self.run_dir, {
                    "event": "stop",
                    "incarnation": incarnation,
                    "exit_class": exit_class,
                    "suspect_collective": suspect,
                    "diagnose": verdict,
                    "action": "stop",
                    "attempt": decision.attempt,
                    "reason": decision.reason,
                    "rc": rc,
                })
                print(f"[elastic] STOP after incarnation {incarnation} "
                      f"({exit_class}): {decision.reason}",
                      file=sys.stderr)
                return 1
            if decision.backoff_s > 0:
                print(f"[elastic] {exit_class}: backing off "
                      f"{decision.backoff_s:.2f}s before restart "
                      f"{decision.attempt}", flush=True)
                time.sleep(decision.backoff_s)
            refusal: Optional[str] = None
            capacity = read_capacity(
                self.capacity_file,
                default=self.plan.n_devices or None)
            if capacity is not None:
                try:
                    self.plan = plan_remesh(
                        n_devices=capacity,
                        parallelism=self.plan.parallelism,
                        mesh=self.plan.mesh,
                        global_batch=self.global_batch,
                    )
                except RemeshRefusal as e:
                    refusal = str(e)
                    if not self.fallback_plan:
                        append_decision(self.run_dir, {
                            "event": "stop",
                            "incarnation": incarnation,
                            "exit_class": exit_class,
                            "action": "stop",
                            "diagnose": verdict,
                            "reason": f"re-mesh refused: {e} (no "
                                      "--fallback-plan given)",
                            "rc": rc,
                        })
                        print(f"[elastic] STOP: re-mesh refused: {e}",
                              file=sys.stderr)
                        return 1
                    try:
                        self.plan = fallback_from_tune(
                            self.fallback_plan,
                            n_devices=capacity,
                            global_batch=self.global_batch,
                        )
                    except RemeshRefusal as e2:
                        append_decision(self.run_dir, {
                            "event": "stop",
                            "incarnation": incarnation,
                            "exit_class": exit_class,
                            "action": "stop",
                            "diagnose": verdict,
                            "reason": (f"re-mesh refused: {refusal}; "
                                       f"fallback plan refused: {e2}"),
                            "rc": rc,
                        })
                        print(f"[elastic] STOP: {refusal}; fallback: "
                              f"{e2}", file=sys.stderr)
                        return 1
            assessment = resume_assessment(self.checkpoint_dir)
            if (self.checkpoint_dir
                    and assessment["resume_step"] is None
                    and assessment["refused"]):
                append_decision(self.run_dir, {
                    "event": "stop",
                    "incarnation": incarnation,
                    "exit_class": exit_class,
                    "action": "stop",
                    "diagnose": verdict,
                    "reason": "no verifiable checkpoint to resume "
                              "from (every step refused by its "
                              "manifest)",
                    "recovery": assessment,
                    "rc": rc,
                })
                print("[elastic] STOP: every checkpoint refused its "
                      "checksum manifest", file=sys.stderr)
                return 1
            incarnation += 1
            append_decision(self.run_dir, {
                "event": "restart",
                "incarnation": incarnation,
                "exit_class": exit_class,
                "suspect_collective": suspect,
                "diagnose": verdict,
                "action": "restart",
                "attempt": decision.attempt,
                "backoff_s": round(decision.backoff_s, 3),
                "reason": decision.reason,
                "remesh_refusal": refusal,
                "plan": self.plan.to_json(),
                "recovery": assessment,
                "rc": rc,
            })
            print(f"[elastic] restart #{decision.attempt} after "
                  f"{exit_class}: {self.plan.n_devices or 'all'} "
                  f"device(s), resume step "
                  f"{assessment['resume_step']}"
                  + (f", {len(assessment['refused'])} checkpoint(s) "
                     "refused by manifest"
                     if assessment["refused"] else ""),
                  flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "train" in argv and "--" in argv[argv.index("train"):]:
        # `elastic train [OPTIONS] -- TRAIN ARGS`: the supervisor's own
        # options may also stand after the command, up to a `--`
        cmd = argv.index("train")
        cut = argv.index("--", cmd)
        argv = argv[:cmd] + argv[cmd + 1:cut] + ["train"] + argv[cut + 1:]
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch elastic",
        description="supervised elastic training: restart loop with "
                    "failure-class budgets, re-mesh to survivors, "
                    "verified-checkpoint recovery, and a decision log "
                    "the goodput ledger joins (docs/resilience.md)",
    )
    ap.add_argument("--max-restarts", default=None, metavar="CLASS=N,…",
                    help="per-failure-class restart budget overrides, "
                         "e.g. killed=3,hang=1 (defaults: "
                         "preempted=unbounded, killed=5, hang=3, oom=1, "
                         "health_halt=0, spawn_failure=2)")
    ap.add_argument("--backoff-base", type=float, default=1.0,
                    metavar="S", help="restart backoff base (doubles "
                    "per attempt per class; preemptions skip the ramp)")
    ap.add_argument("--backoff-cap", type=float, default=60.0,
                    metavar="S", help="restart backoff ceiling")
    ap.add_argument("--backoff-seed", type=int, default=0,
                    help="deterministic jitter seed")
    ap.add_argument("--fallback-plan", default=None, metavar="TUNE.JSON",
                    help="a `tpu-ddp-torch tune --json` artifact: when the "
                         "survivors cannot satisfy the current "
                         "strategy, fall back to the next-ranked "
                         "lint-clean candidate that fits")
    ap.add_argument("--capacity-file", default=None, metavar="PATH",
                    help="surviving-device-count signal "
                         "({\"devices\": N}; default "
                         "<telemetry-dir>/capacity.json — the chaos "
                         "harness's kill_host writes it; point this at "
                         "your scheduler's signal in production)")
    ap.add_argument("--max-incarnations", type=int, default=12,
                    help="absolute incarnation ceiling across all "
                         "failure classes")
    ap.add_argument("command", choices=["train"],
                    help="what to supervise (train)")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="the full `tpu-ddp-torch train` argv (must include "
                         "--telemetry-dir; --checkpoint-dir strongly "
                         "recommended); the options above may also follow "
                         "`train`, up to a `--` before the train argv")
    args = ap.parse_args(argv)
    try:
        budgets = parse_budgets(args.max_restarts)
    except ValueError as e:
        print(f"tpu-ddp-torch elastic: {e}", file=sys.stderr)
        return 2
    policy = RestartPolicy(
        budgets,
        BackoffPolicy(base_s=args.backoff_base, cap_s=args.backoff_cap,
                      seed=args.backoff_seed),
    )
    try:
        supervisor = Supervisor(
            args.train_args,
            policy=policy,
            fallback_plan=args.fallback_plan,
            capacity_file=args.capacity_file,
            max_incarnations=args.max_incarnations,
        )
    except SystemExit as e:
        print(str(e), file=sys.stderr)
        return 2
    return supervisor.run()


if __name__ == "__main__":
    sys.exit(main())
