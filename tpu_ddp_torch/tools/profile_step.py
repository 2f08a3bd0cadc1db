"""Where a main path's train step spends its time on the card.

    python -m tpu_ddp_torch.tools.profile_step                  # NetResDeep
    python -m tpu_ddp_torch.tools.profile_step --model vit_s4   # ViT-S/4

NetResDeep (full width, synthetic CIFAR, batch 32, SGD lr 1e-2) is built
twice, with the plain update and with ``--kernels`` (K1). ViT-S/4 (batch
32, AdamW lr 1e-3, ``--kernels``) is built twice, with ``--attention full``
and with ``--attention flash`` (K4-K6). On one GPU, for each variant:

1. 100 train steps in turns (A, B, B, A, three times over), host clock
   between ``torch.cuda.synchronize()`` calls, after a warm-up;
2. the optimizer update alone (``Optimizer.apply`` on fixed gradients, 200
   calls, host and device together) in the same turns;
3. 20 steps under ``torch.profiler``: the device's busy time per step (the
   sum of kernel times, one stream), its idle share of the step, kernels
   launched per step, the device time of the flash kernels (K4-K6), and the
   operators that take most device time;
4. ViT only: the device time of one step's attention alone (forward and
   backward of the qkv split and the model's ``attention_impl`` at its
   (B, T, H, D), once per block; the sum of its kernels' times under
   ``torch.profiler`` over 50 repetitions, since the host, not the device,
   sets the wall time of such a loop), and its share of the step's device
   busy time.

The last line is one JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tpu_ddp_torch.cli import train as cli
from tpu_ddp_torch.runtime import device_name
from tpu_ddp_torch.train.trainer import Trainer

STEPS, PROFILE_STEPS, WARMUP, TOP = 100, 20, 20, 12
ROUNDS, UPDATE_CALLS, ATTENTION_REPS = 3, 200, 50
#: K4-K6's kernel names, float32 and bfloat16, as the profiler shows them
FLASH_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                 "flash_fwd_bf16_kernel", "flash_dq_bf16_kernel", "flash_dkv_bf16_kernel")


def variants(model: str) -> dict:
    """variant name -> extra CLI arguments."""
    base = ["--model", model]
    if model == "netresdeep":
        return {"plain": base, "kernels": base + ["--kernels"]}
    base += ["--kernels", "--optimizer", "adamw", "--lr", "1e-3"]
    return {a: base + ["--attention", a] for a in ("full", "flash")}


def _trainer(extra) -> Trainer:
    argv = ["--device", "cuda", "--synthetic-data", "--synthetic-size", "6400"]
    return Trainer(cli.config_from_args(cli.build_parser().parse_args(argv + extra)))


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


def _device_us(prof) -> tuple:
    """(device microseconds, launches, rows) of the device-side events of a
    profile: kernels and copies. A CPU operator's own device time repeats
    the time of the kernels it launched, so it is left out."""
    from torch.autograd import DeviceType

    busy_us, launches, rows = 0.0, 0, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = float(evt.self_device_time_total)
        busy_us += dev_us
        launches += evt.count
        rows.append((dev_us, evt.count, evt.key))
    return busy_us, launches, rows


def _profile(trainer: Trainer, batches, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _run(trainer, batches)
    n = len(batches)
    busy_us, launches, rows = _device_us(prof)
    flash_us = sum(us for us, _, k in rows if any(f in k for f in FLASH_KERNELS))
    rows = sorted(((us / n, c / n, k) for us, c, k in rows), reverse=True)
    busy = busy_us / n * 1e-6
    return {
        "profiled_step_ms": wall * 1e3,
        "device_busy_ms_per_step": busy * 1e3,
        "device_idle_share": 1.0 - busy / wall if wall else float("nan"),
        "kernels_per_step": launches / n,
        "flash_kernels_ms_per_step": flash_us / n * 1e-3,
        "top": [{"op": k, "device_us_per_step": us, "calls_per_step": c}
                for us, c, k in rows[:top]],
    }


def _attention_ms(trainer: Trainer, batch_size: int) -> float:
    """Device milliseconds of one step's attention alone: forward and
    backward of the qkv split and ``attention_impl`` once per block, at the
    step's (B, T, H, D)."""
    from torch.profiler import ProfilerActivity, profile

    model = trainer.state.model
    blocks = model.blocks
    attn = blocks[0].attn
    C = model.hidden_dim
    T = model.pos_embed.shape[1]
    H = attn.num_heads
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    qkv = torch.randn((batch_size, T, 3 * C), generator=gen, device=trainer.device,
                      requires_grad=True)
    g = torch.randn((batch_size, T, H, C // H), generator=gen, device=trainer.device)

    def once():
        for _ in blocks:
            q, k, v = (x.reshape(batch_size, T, H, C // H) for x in qkv.split(C, -1))
            torch.autograd.grad(attn.attention_impl(q, k, v), qkv, g)

    for _ in range(5):
        once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ATTENTION_REPS):
            once()
        torch.cuda.synchronize()
    return _device_us(prof)[0] / ATTENTION_REPS * 1e-3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["netresdeep", "vit_s4"], default="netresdeep")
    args = p.parse_args(argv)
    specs = variants(args.model)
    names = list(specs)
    turns = (names + names[::-1]) * ROUNDS
    trainers = {name: _trainer(extra) for name, extra in specs.items()}
    first = trainers[names[0]]
    batch_size = first.config.per_shard_batch
    batches = _batches(first, STEPS)
    for t in trainers.values():
        _run(t, batches[:WARMUP])
    gen = torch.Generator(device=first.device).manual_seed(0)
    grads = {n: 1e-3 * torch.randn(p.shape, generator=gen, device=p.device)
             for n, p in first.state.params().items()}
    times = {name: [] for name in names}
    update = {name: [] for name in names}
    for name in turns:
        times[name].append(_run(trainers[name], batches))
        update[name].append(_time_update(trainers[name], grads))
    result = {"device": device_name(first.device), "model": args.model,
              "steps": STEPS}
    for name, t in trainers.items():
        step_s = sum(times[name]) / len(times[name])
        upd_s = sum(update[name]) / len(update[name])
        prof = _profile(t, batches[:PROFILE_STEPS], TOP)
        row = {"step_ms": step_s * 1e3,
               "step_ms_turns": [x * 1e3 for x in times[name]],
               "images_per_sec_per_chip": batch_size / step_s,
               "update_ms": upd_s * 1e3,
               "update_ms_turns": [x * 1e3 for x in update[name]],
               **prof}
        if args.model != "netresdeep":
            att = _attention_ms(t, batch_size)
            row["attention_ms_per_step"] = att
            busy = prof["device_busy_ms_per_step"]
            row["attention_share_of_busy"] = att / busy if busy else float("nan")
        result[name] = row
        print(f"{name}: {step_s * 1e3:.3f} ms/step ({batch_size / step_s:.1f} images/s), "
              f"optimizer update {upd_s * 1e3:.4f} ms, "
              f"device busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"share {prof['device_idle_share']:.3f}, "
              f"{prof['kernels_per_step']:.1f} kernels/step, flash kernels "
              f"{prof['flash_kernels_ms_per_step']:.3f} ms/step"
              + (f", attention alone {row['attention_ms_per_step']:.3f} device ms/step "
                 f"({row['attention_share_of_busy']:.3f} of busy)"
                 if "attention_ms_per_step" in row else ""), flush=True)
        for r in prof["top"]:
            print(f"    {r['device_us_per_step']:9.2f} us  "
                  f"{r['calls_per_step']:6.1f}x  {r['op'][:90]}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
