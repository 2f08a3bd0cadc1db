"""Where the main path's train step spends its time on the card.

    python -m tpu_ddp_torch.tools.profile_step

Builds the main path's trainer (NetResDeep at full width, synthetic CIFAR,
batch 32, SGD lr 1e-2) twice, with the plain update and with ``--kernels``
(K1), and on one GPU:

1. times 100 train steps of each in turns (plain, K1, K1, plain, three
   times over), host clock between ``torch.cuda.synchronize()`` calls,
   after a warm-up;
2. times the optimizer update alone (``Optimizer.apply`` on fixed
   gradients, 200 calls, host and device together) in the same turns;
3. profiles 20 steps of each with ``torch.profiler``: the
   device's busy time per step (the sum of kernel times, one stream), its
   idle share of the step, kernels launched per step, and the operators
   that take most device time.

The last line is one JSON object with these numbers.
"""

from __future__ import annotations

import json
import time

import torch

from tpu_ddp_torch.cli import train as cli
from tpu_ddp_torch.runtime import device_name
from tpu_ddp_torch.train.trainer import Trainer

STEPS, PROFILE_STEPS, WARMUP, TOP = 100, 20, 20, 12
ROUNDS, UPDATE_CALLS = 3, 200
TURNS = ("plain", "kernels", "kernels", "plain") * ROUNDS


def _trainer(kernels: bool) -> Trainer:
    argv = ["--device", "cuda", "--synthetic-data", "--synthetic-size", "6400"]
    argv += ["--kernels"] if kernels else []
    return Trainer(cli.config_from_args(cli.build_parser().parse_args(argv)))


def _batches(trainer: Trainer, n: int):
    out = []
    while len(out) < n:
        for b in trainer.train_loader.epoch_batches():
            out.append(trainer.to_device(b))
            if len(out) == n:
                break
    return out


def _run(trainer: Trainer, batches) -> float:
    """Seconds per step over ``batches``, between synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.state, _ = trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(batches)


def _time_update(trainer: Trainer, grads) -> float:
    """Seconds per ``Optimizer.apply`` call on fixed gradients."""
    params, state = trainer.state.params(), trainer.state.opt_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(UPDATE_CALLS):
        trainer.tx.apply(grads, state, params)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / UPDATE_CALLS


def _profile(trainer: Trainer, batches, top: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _run(trainer, batches)
    n = len(batches)
    rows, busy_us, launches = [], 0.0, 0
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): a CPU operator's own
        # device time repeats the time of the kernels it launched
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = float(evt.self_device_time_total)
        busy_us += dev_us
        launches += evt.count
        rows.append((dev_us / n, evt.count / n, evt.key))
    rows.sort(reverse=True)
    busy = busy_us / n * 1e-6
    return {
        "profiled_step_ms": wall * 1e3,
        "device_busy_ms_per_step": busy * 1e3,
        "device_idle_share": 1.0 - busy / wall if wall else float("nan"),
        "kernels_per_step": launches / n,
        "top": [{"op": k, "device_us_per_step": us, "calls_per_step": c}
                for us, c, k in rows[:top]],
    }


def main() -> dict:
    trainers = {"plain": _trainer(False), "kernels": _trainer(True)}
    batches = _batches(trainers["plain"], STEPS)
    for t in trainers.values():
        _run(t, batches[:WARMUP])
    gen = torch.Generator(device=trainers["plain"].device).manual_seed(0)
    grads = {n: 1e-3 * torch.randn(p.shape, generator=gen, device=p.device)
             for n, p in trainers["plain"].state.params().items()}
    times = {"plain": [], "kernels": []}
    update = {"plain": [], "kernels": []}
    for name in TURNS:
        times[name].append(_run(trainers[name], batches))
        update[name].append(_time_update(trainers[name], grads))
    result = {"device": device_name(trainers["plain"].device), "steps": STEPS}
    for name, t in trainers.items():
        step_s = sum(times[name]) / len(times[name])
        upd_s = sum(update[name]) / len(update[name])
        prof = _profile(t, batches[:PROFILE_STEPS], TOP)
        result[name] = {"step_ms": step_s * 1e3,
                        "step_ms_turns": [x * 1e3 for x in times[name]],
                        "images_per_sec_per_chip": 32 / step_s,
                        "update_ms": upd_s * 1e3,
                        "update_ms_turns": [x * 1e3 for x in update[name]],
                        **prof}
        print(f"{name}: {step_s * 1e3:.3f} ms/step ({32 / step_s:.1f} images/s), "
              f"optimizer update {upd_s * 1e3:.4f} ms, "
              f"device busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"share {prof['device_idle_share']:.3f}, "
              f"{prof['kernels_per_step']:.1f} kernels/step", flush=True)
        for row in prof["top"]:
            print(f"    {row['device_us_per_step']:9.2f} us  "
                  f"{row['calls_per_step']:6.1f}x  {row['op'][:90]}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
