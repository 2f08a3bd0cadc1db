"""``python -m tpu_ddp_torch.cli.launch``: spawn and supervise one training
process per local rank (the ``torchrun`` equivalent).

Counterpart of ``tpu_ddp/cli/launch.py`` (``plan_ranks`` :69, ``child_env``
:84, ``pick_free_port`` :100, ``_terminate_all`` :106, ``run_job`` :148),
with its logic copied, not imported:

    python -m tpu_ddp_torch.cli.launch --nproc-per-node 2 -- \\
        python -m tpu_ddp_torch.cli.train --synthetic-data --kernels \\
        --grad-compress int8 --grad-compress-error-feedback

Each child gets PyTorch's ``env://`` variables (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and
``LOCAL_WORLD_SIZE``), which ``parallel/runtime.py::initialize_distributed``
reads. As in the JAX launcher:

- any child exiting non-zero ends the whole job (SIGTERM, a grace window,
  SIGKILL), and the launcher exits with that child's code;
- SIGTERM and SIGINT to the launcher are forwarded to every child;
- ranks are dense and node-major: rank = node_rank * nproc_per_node +
  local_rank.

When the command asks for ``--kernels`` on ``cuda`` (no ``--device cpu``),
the launcher builds the port's CUDA libraries once before it spawns, so the
ranks find them built. With ``--telemetry-dir`` the launcher writes the
job's lifecycle into ``launch-n<node>.jsonl`` there (the JAX
``_job_telemetry`` :126-146 and its events :160-245): ``job_start``, a
``child_spawn`` and a ``child_exit`` a rank, ``signal_forwarded`` and
``job_end``. stdlib only: the launcher imports neither torch nor jax
(``ops/_build.py`` and ``telemetry/`` are stdlib only).
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

_TERM_GRACE_SECONDS = 15.0


def plan_ranks(nnodes: int, nproc_per_node: int,
               node_rank: int) -> List[Tuple[int, int]]:
    """(rank, local_rank) for every process THIS node launches: dense,
    node-major (rank 0 lives on node 0, where the rendezvous runs)."""
    if nnodes < 1 or nproc_per_node < 1:
        raise ValueError("nnodes and nproc-per-node must be >= 1")
    if not 0 <= node_rank < nnodes:
        raise ValueError(f"node-rank {node_rank} outside [0, {nnodes})")
    base = node_rank * nproc_per_node
    return [(base + local, local) for local in range(nproc_per_node)]


def child_env(base: dict, *, master: str, world_size: int, rank: int,
              local_rank: int, nproc_per_node: int = 1) -> dict:
    """Environment for one launched process: ``env://``'s rendezvous
    variables plus the local rank and the node's width."""
    host, _, port = master.rpartition(":")
    env = dict(base)
    env["MASTER_ADDR"] = host
    env["MASTER_PORT"] = port
    env["WORLD_SIZE"] = str(world_size)
    env["RANK"] = str(rank)
    env["LOCAL_RANK"] = str(local_rank)
    env["LOCAL_WORLD_SIZE"] = str(nproc_per_node)
    return env


#: rendezvous ports are drawn below Linux's ephemeral range (32768 and up
#: by default), which the kernel hands to outgoing connections and to
#: ``bind`` on port 0: a port from there can be taken, or sit in TIME_WAIT
#: from a finished job's connection, before rank 0's store listens on it
#: (seen as EADDRINUSE between back-to-back NCCL jobs on one host)
_PORTS = (20000, 32768)


def pick_free_port(host: str = "127.0.0.1") -> int:
    """A port on ``host`` that binds now, drawn from ``_PORTS``."""
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(*_PORTS)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
            return port
    raise OSError(f"no free port in {_PORTS} on {host}")


def _terminate_all(procs: Sequence[subprocess.Popen],
                   grace: float = _TERM_GRACE_SECONDS) -> None:
    """TERM every live child, give the group one shared grace window, then
    KILL stragglers."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def runs_on_cpu(cmd: Sequence[str]) -> bool:
    """Whether ``cmd`` asks for ``--device cpu``."""
    cmd = list(cmd)
    return "--device=cpu" in cmd or any(
        a == "--device" and b == "cpu" for a, b in zip(cmd, cmd[1:]))


def wants_kernel_build(cmd: Sequence[str]) -> bool:
    """Whether ``cmd`` runs the port's CUDA kernels: ``--kernels`` without
    ``--device cpu``."""
    return "--kernels" in cmd and not runs_on_cpu(cmd)


def _job_telemetry(telemetry_dir: Optional[str], node_rank: int):
    """The launcher's ``Telemetry``: one JSONL sink,
    ``launch-n<node>.jsonl`` in ``telemetry_dir``; the inert ``NULL``
    without one."""
    from tpu_ddp_torch.telemetry import NULL, Clock, JsonlTraceSink, Telemetry

    if not telemetry_dir:
        return NULL
    clock = Clock()
    sink = JsonlTraceSink(os.path.join(telemetry_dir, f"launch-n{node_rank}.jsonl"),
                          clock=clock, process_index=node_rank)
    return Telemetry([sink], process_index=node_rank, clock=clock)


def run_job(cmd: Sequence[str], *, nnodes: int = 1, nproc_per_node: int = 1,
            node_rank: int = 0, master: Optional[str] = None,
            telemetry_dir: Optional[str] = None) -> int:
    """Launch ``cmd`` once per local rank and supervise until all exit.
    Returns 0 iff every child exited 0, else the first failing child's code
    (the others torn down, torchrun-style). ``telemetry_dir``: the job's
    lifecycle events go to ``launch-n<node>.jsonl`` there."""
    tel = _job_telemetry(telemetry_dir, node_rank)
    if master is None:
        if nnodes > 1:
            raise ValueError("--master host:port is required when nnodes > 1 "
                             "(every node must agree on it)")
        master = f"127.0.0.1:{pick_free_port()}"
    if wants_kernel_build(cmd):
        from tpu_ddp_torch.ops import _build

        _build.build()
    world_size = nnodes * nproc_per_node
    base_env = dict(os.environ)
    if nproc_per_node > 1:
        # as torchrun: ranks sharing a host's cores run one thread each
        # unless told otherwise (gloo's waits spin against the others)
        base_env.setdefault("OMP_NUM_THREADS", "1")
    procs: List[subprocess.Popen] = []
    forwarded = []
    forwarded_logged = 0

    def _forward(signum, frame):
        # async-signal-safe: no sink IO here (the sink's lock may be held
        # by the interrupted main thread); the loop emits the instant
        forwarded.append(signum)
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except OSError:
                    pass

    prev = {s: signal.signal(s, _forward) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        tel.instant("job_start", nnodes=nnodes, nproc_per_node=nproc_per_node,
                    node_rank=node_rank, coordinator=master)
        for rank, local in plan_ranks(nnodes, nproc_per_node, node_rank):
            procs.append(subprocess.Popen(list(cmd), env=child_env(
                base_env, master=master, world_size=world_size, rank=rank,
                local_rank=local, nproc_per_node=nproc_per_node)))
            tel.instant("child_spawn", process_id=rank, local_rank=local,
                        os_pid=procs[-1].pid)
        rc = 0
        live = list(procs)
        escalate_at = None
        while live:
            time.sleep(0.1)
            while forwarded_logged < len(forwarded):
                tel.instant("signal_forwarded", signum=int(forwarded[forwarded_logged]))
                forwarded_logged += 1
            if forwarded and escalate_at is None:
                # a forwarded signal gets ONE grace window; a rank wedged in
                # a collective (its peer gone) must not pin the launcher
                escalate_at = time.monotonic() + _TERM_GRACE_SECONDS
            if escalate_at is not None and time.monotonic() >= escalate_at:
                _terminate_all(live, grace=1.0)
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                tel.instant("child_exit", os_pid=p.pid, code=code)
                if code != 0 and rc == 0:
                    rc = code
                    _terminate_all(live)
        # signal-style exits surface as the shell's 128+N
        rc = 128 - rc if rc < 0 else rc
        tel.instant("job_end", rc=rc)
        return rc
    finally:
        _terminate_all(procs)
        for s, h in prev.items():
            signal.signal(s, h)
        tel.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_ddp_torch.cli.launch",
        description="Spawn and supervise one training process per local "
                    "rank (torchrun equivalent; see the module docstring).")
    ap.add_argument("--nproc-per-node", type=int, default=1,
                    help="processes to launch on THIS node (one per card "
                         "under nccl; under gloo ranks may share a card)")
    ap.add_argument("--nnodes", type=int, default=1,
                    help="total nodes in the job")
    ap.add_argument("--node-rank", type=int, default=0,
                    help="this node's rank in [0, nnodes)")
    ap.add_argument("--master", default=None, metavar="HOST:PORT",
                    help="rendezvous address (node 0's reachable address); "
                         "a free localhost port for single-node jobs")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="write launcher job-lifecycle events "
                    "(spawn/exit/signals) to launch-n<node>.jsonl here; "
                    "pass the same dir to the train CLI's --telemetry-dir "
                    "for a combined picture")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to launch, after `--`: python -m "
                         "tpu_ddp_torch.cli.train ...")
    args = ap.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given; usage: python -m tpu_ddp_torch.cli.launch "
                 "[opts] -- python -m tpu_ddp_torch.cli.train ...")
    return run_job(cmd, nnodes=args.nnodes, nproc_per_node=args.nproc_per_node,
                   node_rank=args.node_rank, master=args.master,
                   telemetry_dir=args.telemetry_dir)


if __name__ == "__main__":
    sys.exit(main())
