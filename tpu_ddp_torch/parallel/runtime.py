"""Process-group bootstrap: one process per rank.

Counterpart of ``tpu_ddp/parallel/runtime.py`` (``initialize_distributed``
:24, ``is_primary_process`` :138). One JAX process drives every device of
its host, so the JAX runtime has no rank-to-device mapping and no backend
to choose. Here each rank is its own process (``cli/launch.py`` spawns
them), so the port chooses both:

* the backend: ``nccl`` by default on ``cuda``, ``gloo`` on ``cpu``; on
  ``cuda``, ``gloo`` only when asked for (``--dist-backend gloo``). gloo
  sends no CUDA tensor point to point, so the ring then stages its wire
  bytes through host memory (``parallel/collectives.py``);
* the rank's device: ``cuda:{local_rank}`` under ``nccl``, which refuses
  two ranks on one card, so a local rank without a card of its own raises
  before the group is joined. Under ``gloo`` ranks may share a card
  (``cuda:{local_rank % device_count}``). ``cpu`` under ``--device cpu``.

``initialize_distributed`` joins the group from the launcher's ``env://``
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) and is a no-op without them, so every single-rank path
stays as it was. ``tpu_ddp_torch/runtime.py`` keeps device selection and
the precision policy.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
#: the launcher's environment (``torch.distributed``'s ``env://`` names)
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def default_backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(device: str = "cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group the launcher set up; returns whether one is
    up. A no-op (False) when ``WORLD_SIZE`` is not in the environment or
    the group is already up. Under ``cuda`` it also makes the rank's card
    the current device."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"WORLD_SIZE is set but {', '.join(missing)} are not: a partial "
            "launcher environment (start ranks with python -m "
            "tpu_ddp_torch.cli.launch)")
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown dist backend {backend!r}; expected one "
                         f"of {BACKENDS}")
    if device == "cpu" and backend == "nccl":
        raise ValueError("--dist-backend nccl needs --device cuda")
    if device == "cuda":
        torch.cuda.set_device(rank_device(device, backend))
    dist.init_process_group(backend, init_method="env://")
    return True


def rank_device(device: str, backend: str) -> torch.device:
    """This rank's device (module docstring). Raises, naming ``--dist-backend
    gloo``, when an ``nccl`` rank has no card of its own."""
    if device == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            "--device cuda: no CUDA device is visible to PyTorch; pass "
            "--device cpu explicitly")
    lr = local_rank()
    if backend == "nccl" and lr >= count:
        raise RuntimeError(
            f"--dist-backend nccl: local rank {lr} has no card of its own "
            f"({count} visible) and NCCL refuses two ranks on one card; run "
            "at most one rank per card, or pass --dist-backend gloo to let "
            "ranks share a card")
    return torch.device("cuda", lr % count)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_process() -> bool:
    """Single-writer predicate (rank 0): only it logs and writes."""
    return rank() == 0


def agree_any(flag: bool) -> bool:
    """Whether ``flag`` is set on ANY rank: a MAX all-reduce of one int over
    the default group (gloo or nccl), every rank calls it at the same
    point; at one rank the flag itself (the JAX trainer's
    ``_preempt_agreed`` / ``_force_abort_agreed``, :1934-1961)."""
    if world_size() == 1:
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


#: what gloo's transport says when the rank across a pair is gone
_PEER_GONE = ("Connection closed by peer", "Connection reset by peer",
              "gloo/transport")


def peer_lost(exc: BaseException) -> bool:
    """Whether ``exc`` is a collective failing because another rank is
    gone: any ``torch.distributed`` error (``DistBackendError``, which
    NCCL raises, and its kin), or the plain ``RuntimeError`` that gloo's
    TCP transport raises on a closed or reset pair."""
    if isinstance(exc, getattr(dist, "DistError", ())):
        return True
    return isinstance(exc, RuntimeError) and any(s in str(exc) for s in _PEER_GONE)


def barrier() -> None:
    """Every rank waits for the others (a no-op at one rank)."""
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank_, world, backend, init_file, args) -> None:
    torch.set_num_threads(1)   # ranks share the host's cores, as under the launcher
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank_, world_size=world)
    try:
        fn(rank_, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, init_file: str,
          backend: str = "gloo", timeout: float = 120.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method: the caller may hold threads, or JAX) that join
    one process group through the rendezvous file ``init_file`` (which
    must not exist yet). Raises if a rank fails or the group is not done
    within ``timeout`` seconds; no process outlives the call. ``fn`` must
    be importable by name (a module-level function)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_file, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"{len(hung)} of {world} ranks still running "
                           f"after {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")
