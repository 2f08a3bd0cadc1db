#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpu_ddp_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Environment: Python, torch and CUDA versions, and the card's name and
   power limit from ``nvidia-smi``.
2. Build: every CUDA kernel of the port from the sources in the checkout
   (``tpu_ddp_torch/ops/csrc``, one ``nvcc`` per source, all in parallel).
3. Kernel vs plain: K1 (``fused_update``) against its plain PyTorch version
   on the card, for SGD, SGD+momentum+decay+clip+EMA and AdamW+decay+clip+
   EMA, each under a constant and a cosine schedule, at NetResDeep's nine
   leaf shapes, at ragged sizes (1, 127, 1,000,003, and 1,000,003 at an
   unaligned address) and at one large leaf (2**24 elements). Expected:
   bitwise equal; a difference above 2 ulp fails.
4. Main path: ``tpu_ddp_torch.cli.train.main`` with ``--device cuda
   --synthetic-data --kernels`` at NetResDeep's full width (n_chans1=32,
   n_blocks=10, tied), batch 32, SGD lr 1e-2, 2 epochs of 200 steps. The
   losses must be finite and falling, and K1 must have launched 9 times a
   step (one per parameter leaf).
5. Same steps, plain update: the first steps again without ``--kernels``;
   the per-step losses agree with phase 4 within ``rtol=1e-5`` over the
   first 5 steps (cuDNN's default backward sums in a run-dependent order,
   and the difference grows as training goes on). Then, with cuDNN's
   deterministic algorithms, 30 steps with K1 and 30 with the plain update
   from the same start must give bitwise equal losses and weights.
6. Timing: CUDA-event times of K1, of its plain version and of
   ``torch._fused_sgd_`` / ``torch._fused_adamw_`` as a yardstick (never
   called by the port, and with other semantics: no EMA, no clip in the
   pass, torch's AdamW decay), at the main path's shapes and at the large
   leaf, beside the least time the card could take (the bound).

The line before the last is one JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside the
# tensor cores, the rate K1's element-wise float32 work runs at.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

LARGE = 1 << 24
NETRESDEEP_LEAVES = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32,),
                     (32, 2048), (32,), (10, 32), (10,)]
RAGGED = [(1,), (127,), (1_000_003,)]
VARIANTS = {
    "sgd": dict(kind="sgd", momentum=0.0, wd=0.0, max_norm=0.0, ema=0.0),
    "sgd_mom_wd_clip_ema": dict(kind="sgd", momentum=0.9, wd=5e-4,
                                max_norm=1.0, ema=0.99),
    "adamw_wd_clip_ema": dict(kind="adamw", momentum=0.0, wd=0.05,
                              max_norm=1.0, ema=0.99),
}
MAIN_STEPS_PER_EPOCH = 200
PLAIN_STEPS = 30
PLAIN_STEPS_RTOL = 5


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=10):
    """Mean milliseconds per call of ``fn`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def leaf_config(variant, schedule, wd_apply):
    from tpu_ddp_torch.ops.fused_update import LeafConfig

    v = VARIANTS[variant]
    lr = 1e-3 if v["kind"] == "adamw" else 1e-2
    return LeafConfig(kind=v["kind"], momentum=v["momentum"], wd=v["wd"],
                      wd_apply=bool(wd_apply and v["wd"] > 0),
                      has_clip=v["max_norm"] > 0, max_norm=v["max_norm"],
                      step_const=-1 * lr if schedule == "constant" else None,
                      ema_decay=v["ema"], b1=0.9, b2=0.999, eps=1e-8)


def leaf_bytes_ops(cfg, n):
    """Bytes K1 must move (each operand read once, each result written
    once, plus the 16-byte scalar vector) and float operations it does."""
    slots = 2 + int(cfg.has_m) + int(cfg.has_v) + int(bool(cfg.ema_decay))
    ops = 2                                          # scale, p + u
    ops += 2 if cfg.has_clip else 0                  # (g / norm) * max
    if cfg.kind == "adamw":
        ops += 3 + 4 + 2 + 3 + (2 if cfg.wd_apply else 0)
    else:
        ops += (2 if cfg.wd_apply else 0) + (2 if cfg.has_m else 0)
    ops += 4 if cfg.ema_decay else 0
    return 4 * n * 2 * slots + 16, ops * n


def bound(items):
    """(bound_ms, bound_by) for a list of (cfg, n) leaves."""
    total_bytes = sum(leaf_bytes_ops(c, n)[0] for c, n in items)
    total_ops = sum(leaf_bytes_ops(c, n)[1] for c, n in items)
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = total_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Leaf:
    """One leaf's operands on the card, made from a seeded generator."""

    def __init__(self, shape, cfg, gen, offset=0):
        import torch

        n = math.prod(shape)

        def make(scale=1.0, positive=False):
            buf = torch.randn(n + offset, generator=gen, device="cuda") * scale
            buf = buf.abs() if positive else buf
            return buf[offset:].view(shape)

        self.cfg, self.n = cfg, n
        self.g, self.p = make(), make()
        self.m = make(0.1) if cfg.has_m else None
        self.v = make(0.01, positive=True) if cfg.has_v else None
        self.e = make() if cfg.ema_decay else None
        self.u = torch.empty(n + offset, device="cuda")[offset:].view(shape)

    def clone(self):
        import copy

        c = copy.copy(self)
        for k in ("g", "p", "m", "v", "e", "u"):
            t = getattr(self, k)
            if t is not None:
                setattr(c, k, t.clone())
        return c


def scalars_for(leaf_list, cfg, schedule):
    import torch

    from tpu_ddp_torch.ops.fused_update import global_norm

    g_norm = global_norm([lf.g for lf in leaf_list])
    step = torch.tensor(-0.7e-2 if schedule == "cosine" else 0.0, device="cuda")
    bc = (1 - 0.9 ** 3, 1 - 0.999 ** 3) if cfg.kind == "adamw" else (1.0, 1.0)
    return torch.stack([g_norm.float(), step.float(),
                        torch.tensor(bc[0], device="cuda"),
                        torch.tensor(bc[1], device="cuda")]).float()


def ulp_diff(a, b):
    """Max distance in units in the last place between two float32 tensors."""
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    # map the sign-magnitude float order onto a monotonic integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def compare(leaves, scalars):
    """Run K1 and the plain version on copies; (max_abs_err, max_ulp)."""
    from tpu_ddp_torch import ops

    entry = ops.resolve("fused_update")
    fused_update_, update_math = entry["wrapper"], entry["plain"]
    worst_abs, worst_ulp = 0.0, 0
    for lf in leaves:
        ref, krn = lf.clone(), lf.clone()
        u, m, v, e = update_math(ref.g, ref.p, ref.m, ref.v, ref.e, scalars, lf.cfg)
        want = {"u": u, "p": ref.p + u, "m": m, "v": v, "e": e}
        fused_update_(krn.g, krn.p, krn.m, krn.v, krn.e, krn.u, scalars, lf.cfg)
        for k, w in want.items():
            if w is None:
                continue
            got = getattr(krn, k)
            if not bool((got.isfinite() == w.isfinite()).all()):
                fail(f"K1 {k}: finite pattern differs from the plain version")
            worst_abs = max(worst_abs, float((got - w).abs().nan_to_num().max())
                            if got.numel() else 0.0)
            worst_ulp = max(worst_ulp, ulp_diff(got, w))
    return worst_abs, worst_ulp


def phase_kernel_vs_plain():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    print("phase 3: K1 vs plain version (max |diff|, max ulp)", flush=True)
    for variant in VARIANTS:
        for schedule in ("constant", "cosine"):
            groups = {
                "netresdeep": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen)
                               for s in NETRESDEEP_LEAVES],
                "ragged": [Leaf(s, leaf_config(variant, schedule, True), gen)
                           for s in RAGGED],
                "unaligned": [Leaf((1_000_003,), leaf_config(variant, schedule, True),
                                   gen, offset=1)],
                "large": [Leaf((LARGE,), leaf_config(variant, schedule, True), gen)],
            }
            for group, leaves in groups.items():
                scalars = scalars_for(leaves, leaves[0].cfg, schedule)
                err, ulp = compare(leaves, scalars)
                torch.cuda.synchronize()
                results[(variant, schedule, group)] = (err, ulp)
                print(f"  {variant:20s} {schedule:8s} {group:10s} "
                      f"max|diff|={err:.3g} max_ulp={ulp}", flush=True)
                if ulp > 2:
                    fail(f"K1 {variant}/{schedule}/{group}: {ulp} ulp from the "
                         "plain version (limit 2)")
            del groups
    bitwise = all(ulp == 0 for _, ulp in results.values())
    print(f"  K1 bitwise equal to its plain version everywhere: {bitwise}",
          flush=True)
    return results


def library_call(variant, leaves):
    """One PyTorch multi-tensor optimizer call over ``leaves`` (yardstick)."""
    import torch

    v = VARIANTS[variant]
    params = [lf.p for lf in leaves]
    grads = [lf.g for lf in leaves]
    if v["kind"] == "sgd":
        moms = [lf.m for lf in leaves] if v["momentum"] else []
        return lambda: torch._fused_sgd_(
            params, grads, moms, weight_decay=v["wd"], momentum=v["momentum"],
            lr=1e-2, dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)
    steps = [torch.tensor(3.0, device="cuda") for _ in leaves]
    return lambda: torch._fused_adamw_(
        params, grads, [lf.m for lf in leaves], [lf.v for lf in leaves], [],
        steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=v["wd"], eps=1e-8,
        amsgrad=False, maximize=False)


def time_group(variant, shapes, iters):
    """(kernel_ms, plain_ms, library_ms, bound_ms, bound_by) for one step's
    worth of K1 over ``shapes`` (constant schedule)."""
    import torch

    from tpu_ddp_torch import ops

    entry = ops.resolve("fused_update")
    fused_update_, update_math = entry["wrapper"], entry["plain"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = [Leaf(s, leaf_config(variant, "constant", len(s) >= 2), gen)
              for s in shapes]
    scalars = scalars_for(leaves, leaves[0].cfg, "constant")

    def kernel():
        for lf in leaves:
            fused_update_(lf.g, lf.p, lf.m, lf.v, lf.e, lf.u, scalars, lf.cfg)

    def plain():
        for lf in leaves:
            u = update_math(lf.g, lf.p, lf.m, lf.v, lf.e, scalars, lf.cfg)[0]
            lf.p + u

    lib = library_call(variant, leaves)
    # turns: kernel, plain, plain, kernel (and the yardstick between)
    k1 = time_ms(kernel, iters)
    p1 = time_ms(plain, iters)
    lib_ms = time_ms(lib, iters)
    p2 = time_ms(plain, iters)
    k2 = time_ms(kernel, iters)
    b_ms, b_by = bound([(lf.cfg, lf.n) for lf in leaves])
    return (k1 + k2) / 2, (p1 + p2) / 2, lib_ms, b_ms, b_by


def phase_timing(results, main_launches):
    from tpu_ddp_torch import ops

    entry = ops.KERNELS["fused_update"]
    rows = []
    cases = [("fused_update", "sgd", NETRESDEEP_LEAVES, "netresdeep", 500)]
    for variant in VARIANTS:
        cases.append((f"fused_update[{variant},2^24]", variant, [(LARGE,)],
                      "large", 50))
    print("phase 6: K1 timing (CUDA events; ms per step of the listed leaves)",
          flush=True)
    for name, variant, shapes, group, iters in cases:
        k_ms, p_ms, l_ms, b_ms, b_by = time_group(variant, shapes, iters)
        err = max(results[(variant, s, group)][0] for s in ("constant", "cosine"))
        rows.append({
            "name": name, "route": entry["route"], "source": entry["source"],
            "replaces": entry["replaces"], "launches": main_launches,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "shapes": "netresdeep 9 leaves (76,074)" if group == "netresdeep"
            else "one leaf of 2^24", "recipe": variant,
        })
        print(f"  {name:36s} kernel {k_ms:.5f} ms  plain {p_ms:.5f} ms  "
              f"library {l_ms:.5f} ms  bound {b_ms:.5f} ms ({b_by})", flush=True)
    return rows


def phase_main_path():
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * MAIN_STEPS_PER_EPOCH), "--epochs", "2", "--kernels",
            "--eval-each-epoch", "--log-every-epochs", "1",
            "--n-chans1", "32", "--n-blocks", "10", "--batch-size", "32",
            "--lr", "1e-2", "--optimizer", "sgd"]
    print(f"phase 4: main path: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
    ops.reset_launch_counts()
    metrics = cli.main(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = metrics["steps"]
    losses = metrics["step_losses"]
    print(f"  steps {steps}, K1 launches {counts['fused_update']} "
          f"(9 x steps = {9 * steps}), images/sec/chip "
          f"{metrics['images_per_sec_per_chip']:.1f}, training time "
          f"{metrics['total_seconds']:.3f} s, final test accuracy "
          f"{metrics['test_accuracy']:.4f}", flush=True)
    if steps != 2 * MAIN_STEPS_PER_EPOCH:
        fail(f"main path ran {steps} steps, expected {2 * MAIN_STEPS_PER_EPOCH}")
    if counts["fused_update"] != 9 * steps:
        fail(f"K1 launched {counts['fused_update']} times in {steps} steps, "
             f"expected {9 * steps}")
    if not all(math.isfinite(x) for x in losses):
        fail("main path produced a non-finite loss")
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    print(f"  mean loss of the first 20 steps {first:.4f}, last 20 {last:.4f}",
          flush=True)
    if not last < first:
        fail("main path losses did not fall")
    # the reference model's eval-mode accuracy on this synthetic task sits
    # near 0.3 (tied BatchNorm running stats; the JAX trainer shows the same
    # on the CPU): require it clearly above chance (0.1)
    if not math.isfinite(metrics["test_loss"]) or metrics["test_accuracy"] < 0.2:
        fail(f"final eval out of range: {metrics['test_accuracy']}, "
             f"{metrics['test_loss']}")
    return args, metrics, counts["fused_update"]


def run_steps(args, n_steps):
    """A fresh Trainer for ``args``; its first ``n_steps`` train steps of
    epoch 1. Returns (trainer, per-step losses)."""
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(args)))
    trainer.train_loader.set_epoch(1)
    losses = []
    for batch in trainer.train_loader.epoch_batches():
        if len(losses) == n_steps:
            break
        trainer.state, m = trainer.train_step(trainer.state, trainer.to_device(batch))
        losses.append(m["loss"])
    return trainer, [float(x) for x in losses]


def phase_plain_same_steps(args, metrics):
    """(a) the first steps of phase 4 again with the plain update, under
    cuDNN's default algorithms, whose backward sums in a run-dependent
    order: losses within rtol 1e-5 for PLAIN_STEPS_RTOL steps. (b) with
    cuDNN's deterministic algorithms, a K1 run and a plain-update run of
    PLAIN_STEPS steps from the same start: losses and final weights equal
    bit for bit (K1 is bitwise equal to the plain update)."""
    import torch

    plain_args = [a for a in args if a != "--kernels"]
    trainer, got = run_steps(plain_args, PLAIN_STEPS)
    if trainer.tx.fused is not None:
        fail("the plain run was built with K1")
    want = metrics["step_losses"][:PLAIN_STEPS]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"phase 5a: {PLAIN_STEPS} steps with the plain update, relative loss "
          f"difference to phase 4 per step: {' '.join(f'{r:.2g}' for r in rel)}",
          flush=True)
    worst = max(rel[:PLAIN_STEPS_RTOL])
    print(f"  max over the first {PLAIN_STEPS_RTOL} steps {worst:.3g} "
          "(limit 1e-5)", flush=True)
    if not worst <= 1e-5:
        fail("plain-update losses disagree with the K1 run")

    torch.backends.cudnn.deterministic = True
    try:
        k_trainer, k_losses = run_steps(args, PLAIN_STEPS)
        p_trainer, p_losses = run_steps(plain_args, PLAIN_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    k_sd, p_sd = k_trainer.state.model.state_dict(), p_trainer.state.model.state_dict()
    same = k_losses == p_losses and all(torch.equal(k_sd[n], p_sd[n]) for n in k_sd)
    print(f"phase 5b: deterministic cuDNN, {PLAIN_STEPS} steps K1 vs plain "
          f"update: losses and weights bitwise equal: {same} "
          f"(last loss {k_losses[-1]:.6f} vs {p_losses[-1]:.6f})", flush=True)
    if not same:
        fail("K1 run and plain-update run differ under deterministic cuDNN")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "tpu_ddp_torch", "ops", "csrc")):
        fail("run chip_smoke.py from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    print(f"  nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"phase 2: built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})", flush=True)
    for name in _build.LIBRARIES:
        log = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers/thread, {spills} bytes of spill stores", flush=True)

    results = phase_kernel_vs_plain()
    args, metrics, launches = phase_main_path()
    phase_plain_same_steps(args, metrics)
    rows = phase_timing(results, launches)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
