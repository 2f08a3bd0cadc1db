"""Where a ``--zero1`` step spends its time against the replicated step,
on ranks that share one card over gloo.

    python -m tpu_ddp_torch.tools.profile_zero1                      # ViT-S/4
    python -m tpu_ddp_torch.tools.profile_zero1 --model netresdeep

Three ranks share ``cuda:0`` over gloo, as phases 14
and 15 of ``chip_smoke.py`` run them, with those phases' recipes: ViT-S/4
with ``--attention flash --kernels --optimizer adamw --lr 1e-3
--weight-decay 0.05 --grad-clip-norm 1.0 --ema-decay 0.999``; NetResDeep
(32 channels, 10 blocks) with ``--kernels``, SGD lr 1e-2; batch 32 a rank.
Each rank builds the model twice, replicated and with ``--zero1``, and
feeds both the same batches. For each:

1. the steady step time: ``STEPS`` steps in turns (replicated, zero1,
   zero1, replicated, ``ROUNDS`` times over), host clock between
   ``torch.cuda.synchronize()`` calls, after a warm-up;
2. the step cut into sections, each timed on the host clock between
   synchronisations over ``SECTION_STEPS`` steps. Replicated: the
   gradient all-reduce (``sync_gradients``) and the update
   (``Optimizer.apply``). ZeRO-1: the pack into the chunk-major buffer,
   the reduce-scatter (with its division), the clip's norm (its own
   all-reduce), the update of the shards (K1 and its prologue), the
   all-gather and the unpack. The rest (forward, backward, the BatchNorm
   stats' and the metrics' all-reduces) is the step less the sections.
   The synchronisations keep the host from running ahead of the card, so
   these steps are slower than those of 1;
3. ``PROFILE_STEPS`` steps under ``torch.profiler`` on every rank: each
   rank's device busy time a step (the sum of its kernels and copies) and
   its launches a step; the card's idle share is one less the ranks' busy
   times summed over the step's wall time;
4. ZeRO-1 only: the launches of one pack and of one unpack alone.

Rank 0 prints; the last line is one JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch

STEPS, ROUNDS, WARMUP, SECTION_STEPS, PROFILE_STEPS = 20, 3, 10, 20, 10
N_BATCHES = 40
NPROC, TIMEOUT_S = 3, 900.0
#: the checkout's root; the ranks' rendezvous and results go under build/
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANTS = ("replicated", "zero1")


def _argv(model: str, nproc: int) -> list:
    base = ["--device", "cuda", "--dist-backend", "gloo", "--synthetic-data",
            "--synthetic-size", str(nproc * 32 * N_BATCHES), "--epochs", "1",
            "--batch-size", "32", "--kernels"]
    if model == "vit_s4":
        return base + ["--model", "vit_s4", "--attention", "flash",
                       "--optimizer", "adamw", "--lr", "1e-3",
                       "--weight-decay", "0.05", "--grad-clip-norm", "1.0",
                       "--ema-decay", "0.999"]
    return base + ["--n-chans1", "32", "--n-blocks", "10", "--lr", "1e-2",
                   "--optimizer", "sgd"]


class Sections:
    """Host-clock seconds spent inside named calls, each timed between
    synchronisations and summed, until ``restore`` puts the calls back."""

    def __init__(self):
        self.seconds: dict = {}
        self._undo: list = []

    def wrap(self, owner, attr: str, name: str) -> None:
        """Time ``owner.attr`` (a module's function or an object's method,
        replaced on the module or the instance) as ``name``."""
        inner = getattr(owner, attr)
        had = attr in vars(owner)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, inner if had else None))

    def restore(self) -> None:
        for owner, attr, inner in reversed(self._undo):
            if inner is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, inner)
        self._undo.clear()


@contextlib.contextmanager
def _sections(trainer, variant: str):
    from tpu_ddp_torch.parallel import zero as zero_mod
    from tpu_ddp_torch.train import steps as steps_mod

    s = Sections()
    if variant == "zero1":
        z = trainer.zero1
        s.wrap(z.layout, "pack_", "pack")
        s.wrap(z, "reduce_scatter_mean", "reduce_scatter")
        s.wrap(zero_mod, "sharded_global_norm", "clip_norm")
        s.wrap(trainer.tx.fused, "apply_sharded", "update")
        s.wrap(z, "gather_params_", "all_gather")
        s.wrap(z.layout, "unpack_", "unpack")
    else:
        s.wrap(steps_mod, "sync_gradients", "grad_all_reduce")
        s.wrap(trainer.tx, "apply", "update")
    try:
        yield s
    finally:
        s.restore()


def _exclusive(seconds: dict) -> dict:
    """Nested sections less what they contain: the reduce-scatter holds the
    pack, the all-gather the unpack."""
    out = dict(seconds)
    if "reduce_scatter" in out:
        out["reduce_scatter"] -= out.get("pack", 0.0)
    if "all_gather" in out:
        out["all_gather"] -= out.get("unpack", 0.0)
    return out


def _run(trainer, batches) -> float:
    """Seconds a step over ``batches``, between synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.state, _ = trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(batches)


def _launches_of(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch.tools.profile_step import _device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_us(prof)[1]


def _rank(rank: int, world: int, model: str, out_path: str) -> None:
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.runtime import device_name
    from tpu_ddp_torch.tools.profile_step import _device_us
    from tpu_ddp_torch.train.trainer import Trainer

    argv = _argv(model, world)
    trainers = {v: Trainer(cli.config_from_args(cli.build_parser().parse_args(
        argv + (["--zero1"] if v == "zero1" else []))))
        for v in VARIANTS}
    first = trainers["replicated"]
    batches = [first.to_device(b) for b in first.train_loader.epoch_batches()]
    for t in trainers.values():
        _run(t, batches[:WARMUP])

    turns = (list(VARIANTS) + list(VARIANTS)[::-1]) * ROUNDS
    step_s = {v: [] for v in VARIANTS}
    for i, v in enumerate(turns):
        start = (i * STEPS) % (len(batches) - STEPS)
        step_s[v].append(_run(trainers[v], batches[start:start + STEPS]))

    rows = {}
    for v, t in trainers.items():
        window = batches[:SECTION_STEPS]
        with _sections(t, v) as s:
            sectioned = _run(t, window)
        sec_ms = {k: x / SECTION_STEPS * 1e3 for k, x in _exclusive(s.seconds).items()}
        sec_ms["rest"] = sectioned * 1e3 - sum(sec_ms.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = _run(t, batches[:PROFILE_STEPS])
        busy_us, launches, _ = _device_us(prof)
        rows[v] = {
            "step_ms": sum(step_s[v]) / len(step_s[v]) * 1e3,
            "step_ms_turns": [x * 1e3 for x in step_s[v]],
            "sectioned_step_ms": sectioned * 1e3,
            "sections_ms": sec_ms,
            "profiled_step_ms": wall * 1e3,
            "device_busy_ms_per_step": busy_us / PROFILE_STEPS * 1e-3,
            "launches_per_step": launches / PROFILE_STEPS,
        }
        if v == "zero1":
            z = t.zero1
            params = t.state.params()
            grads = {n: torch.randn_like(p) for n, p in params.items()}
            send = torch.zeros(z.n_shards, z.layout.width, device=t.device)
            outs = [torch.empty_like(p) for p in params.values()]
            rows[v]["pack_launches"] = _launches_of(
                lambda: z.layout.pack_(send, [grads[n] for n in z.names]))
            rows[v]["unpack_launches"] = _launches_of(
                lambda: z.layout.unpack_(send, outs))

    per_rank = [None] * world
    dist.all_gather_object(per_rank, rows)
    if rank != 0:
        return
    result = {"device": device_name(first.device), "model": model, "ranks": world,
              "backend": "gloo", "steps": STEPS, "rounds": ROUNDS}
    for v in VARIANTS:
        row = dict(rows[v])
        busy = [r[v]["device_busy_ms_per_step"] for r in per_rank]
        row["device_busy_ms_per_step_by_rank"] = busy
        row["card_idle_share"] = 1.0 - sum(busy) / row["profiled_step_ms"]
        row["step_ms_by_rank"] = [r[v]["step_ms"] for r in per_rank]
        result[v] = row
    with open(out_path, "w") as f:
        json.dump(result, f)


def main(argv=None) -> dict:
    from tpu_ddp_torch.parallel.runtime import spawn

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["netresdeep", "vit_s4"], default="vit_s4")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_zero1 needs a CUDA device")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="profile_zero1-", dir=build) as tmp:
        out = os.path.join(tmp, "result.json")
        spawn(_rank, NPROC, args.model, out,
              init_file=os.path.join(tmp, "rendezvous"), timeout=TIMEOUT_S)
        with open(out) as f:
            result = json.load(f)
    for v in VARIANTS:
        r = result[v]
        print(f"{v}: {r['step_ms']:.3f} ms/step (by rank "
              + " / ".join(f"{x:.3f}" for x in r["step_ms_by_rank"])
              + f"), sectioned {r['sectioned_step_ms']:.3f} ms: "
              + ", ".join(f"{k} {x:.3f}" for k, x in r["sections_ms"].items())
              + f"; {r['launches_per_step']:.1f} launches/step on rank 0, device busy "
              + " / ".join(f"{x:.3f}" for x in r["device_busy_ms_per_step_by_rank"])
              + f" ms/step by rank, card idle share {r['card_idle_share']:.3f}"
              + (f"; pack {r['pack_launches']} and unpack {r['unpack_launches']} launches"
                 if v == "zero1" else ""), flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
