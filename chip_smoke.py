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
   on the card, for SGD, SGD+momentum+decay+clip+EMA, AdamW+decay+clip+EMA
   and the ViT path's AdamW (no decay, clip or EMA), each under a constant
   and a cosine schedule, at NetResDeep's nine leaf shapes, at ViT-S/4's 79
   leaf shapes, at ragged sizes (1, 127, 1,000,003, and 1,000,003 at an
   unaligned address), at one large leaf (2**24 elements) and at a mixed
   group (aligned and unaligned leaves, decayed and not, leaves spanning
   several blocks' chunks). Each group goes through one multi-tensor
   launch. Expected: bitwise equal, every leaf, and exactly one launch a
   group.
4. Main path: ``tpu_ddp_torch.cli.train.main`` with ``--device cuda
   --synthetic-data --kernels`` at NetResDeep's full width (n_chans1=32,
   n_blocks=10, tied), batch 32, SGD lr 1e-2, 2 epochs of 200 steps. The
   losses must be finite and falling, and K1 must have launched once a
   step (all nine parameter leaves in one launch).
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
   leaf, beside the least time the card could take (the bound). CUDA events
   around back-to-back calls measure what the caller waits for, which at
   small shapes is the host's launch rate; each row also carries the device
   time alone (``device_ms``, ``plain_device_ms``, ``library_device_ms``:
   the kernels' own times under ``torch.profiler``).
7. Flash attention, kernel vs plain: K4 (``flash_forward``: out and row
   log-sum-exp), K5 (``flash_dq``) and K6 (``flash_dkv``) against
   ``forward_plain``/``dq_plain``/``dkv_plain`` on the same inputs (K5 and
   K6 get the plain forward's lse and ``di``), at the ViT-S/4 path's
   (32, 64, 3, 64) as views of one qkv product, ViT-B/16's 196 tokens
   (8, 196, 12, 64), D=48, a prime T=67, causal at (4, 512, 4, 64), causal
   with a key mask that leaves rows with no visible key (their output and dq
   must be exactly 0, and the masked keys' dk and dv too), the long regime
   (4, 2048, 8, 128), and (3, 77, 2, 37): D not a multiple of 4 (4-byte
   copies) and T not a multiple of any tile. Tolerances
   (``|got - want| <= atol + rtol * |want|``) are those of
   ``tests/test_ops.py`` everywhere: forward and lse ``atol=2e-5``,
   gradients ``atol=5e-5``, ``rtol=1e-4``. A second call of K5 and of K6
   on the same inputs must give the same bits (no atomics).
8. The ViT main path: ``tpu_ddp_torch.cli.train.main`` with ``--device cuda
   --synthetic-data --model vit_s4 --attention flash --kernels --optimizer
   adamw --lr 1e-3`` (full width: patch 4, hidden 192, depth 6, 3 heads of
   64, 64 tokens), batch 32, 2 epochs of 100 steps with eval each epoch and
   at the end. Losses finite and falling; launches exact: K4 6 x (train
   steps + eval batches), K5 = K6 = 6 x train steps, K1 once a train step.
   Then the same run with ``--attention full``: no flash launch, K1 as
   before, and its first 5 per-step losses within ``rtol=1e-5`` of the flash
   run's (the two attentions sum in other orders; AdamW's normalised update
   carries the difference on). Steady-state images/sec/chip of both.
9. Timing on the ViT path: K1 at ViT-S/4's 79 leaves under the path's
   recipe, as in phase 6, with phase 8's flash run's launches. K4, K5 and
   K6 at the main path's shape and at (4, 2048, 8, 128), each in turns with
   its plain version, beside its bound (bytes over 3.35 TB/s against
   float32 operations over 67 TFLOP/s; also ``bound_tc_ms``, the same bytes
   against its products in 3xTF32, three TF32 products each, over the
   tensor cores' 495 TFLOP/s: two products for K4, three for K5, four for
   K6; and each kernel's launch: tile rows, registers, shared memory and
   blocks an SM) and ``torch.nn.functional.scaled_dot_product_attention``
   as the yardstick (forward for K4, its backward, which gives dq, dk and
   dv at once, for K5 and for K6; never called by the port). One line a
   shape gives K5 + K6 beside SDPA's backward, by events and device time.

10. K2/K3 against plain on the card: ``fused_quant`` and ``fused_dequant``
    (bare and with ``add_to``) against ``quantize_chunk`` and
    ``dequantize_chunk`` at NetResDeep's 9 ring chunks at 2 ranks, ViT-S/4's
    79 leaves halved, sizes 1, 255, 257, 1,000,003 (also from an unaligned
    address) and 2**24 at block 256, blocks 1, 64, 256, 1,000 and 4,096, and
    blocks holding NaN, +Inf, -Inf and only zeros. Bitwise, except the int8
    bytes of a block whose scale is not finite: there the scales must agree
    (NaN with NaN, +-Inf equal) and the block must dequantize non-finite.
11. The ring on the card: two ranks on ``cuda:0`` over gloo (spawned) run
    ``ring_all_reduce`` int8 with ``with_error`` at NetResDeep's 9 leaves and
    one 2**22 leaf, through K2/K3 and through the plain versions on the same
    inputs: outputs and errors bitwise equal on each rank, outputs identical
    across ranks. Then one step's ring over the 9 leaves (error feedback,
    K2/K3) timed by the host clock, and its device time split by
    ``torch.profiler`` into K2/K3, host-device copies and other kernels.
12. The main path on two ranks: ``python -m tpu_ddp_torch.cli.launch
    --nproc-per-node 2 -- python -m tpu_ddp_torch.cli.train --device cuda
    --dist-backend gloo --synthetic-data --kernels --grad-compress int8
    --grad-compress-error-feedback --eval-each-epoch``, NetResDeep at full
    width, batch 32 a rank, SGD lr 1e-2, 2 epochs of 100 steps, both ranks
    sharing the card. Losses finite and falling; launches exact on each rank
    (K1 1, K2 18 and K3 45 a step, nothing else); params bitwise equal on
    both ranks at the end. The same run without ``--grad-compress`` (plain
    DP over gloo) keeps its first 5 step losses within 0.05 of the int8
    run's. Steady-state step time per rank of both.
13. Timing of K2, K3 and K3 with ``add_to``: one main-path step's calls on
    one rank (each of the 9 chunks twice through K2, four times through K3
    and once through K3 with ``add_to``) and one 2**24 chunk, each in turns
    with its plain version, beside the bound (bytes over 3.35 TB/s). No
    single PyTorch call quantizes or dequantizes block-scaled int8, so these
    rows have no library time.

The NetResDeep phases keep their sizes; the whole run takes two to three
minutes on the card, the build included. ``python3 chip_smoke.py --nccl N``,
on a machine with N cards, runs phase 12 alone at N ranks, one card each,
over NCCL. The line before the last is one JSON object
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
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
# dense TF32 on the tensor cores, K4's products (3xTF32: three TF32 products
# for each float32 one)
TF32_OPS_PER_S = 495e12

LARGE = 1 << 24
NETRESDEEP_LEAVES = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32,),
                     (32, 2048), (32,), (10, 32), (10,)]
RAGGED = [(1,), (127,), (1_000_003,)]
#: (shape, offset in floats from a 16-byte boundary, decayed): aligned and
#: unaligned leaves, decayed and not, small and spanning several chunks
MIXED = [((4096,), 0, True), ((333,), 0, False), ((1000,), 1, True),
         ((100_003,), 1, False), ((65_541,), 0, True), ((7,), 3, False),
         ((16_384,), 2, True), ((16_385,), 0, False), ((64, 3, 3, 3), 0, True)]
VARIANTS = {
    "sgd": dict(kind="sgd", momentum=0.0, wd=0.0, max_norm=0.0, ema=0.0),
    "sgd_mom_wd_clip_ema": dict(kind="sgd", momentum=0.9, wd=5e-4,
                                max_norm=1.0, ema=0.99),
    "adamw_wd_clip_ema": dict(kind="adamw", momentum=0.0, wd=0.05,
                              max_norm=1.0, ema=0.99),
    # the ViT path's recipe (phase 8): --optimizer adamw and nothing else
    "adamw": dict(kind="adamw", momentum=0.0, wd=0.0, max_norm=0.0, ema=0.0),
}
VIT_RECIPE = "adamw"
MAIN_STEPS_PER_EPOCH = 200
PLAIN_STEPS = 30
PLAIN_STEPS_RTOL = 5

VIT_STEPS_PER_EPOCH = 100
VIT_DEPTH = 6
VIT_LEAVES = 79
FULL_STEPS_RTOL = 1e-5
FWD_TOL = dict(atol=2e-5, rtol=0.0)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
#: name -> (B, T, H, D, causal, key mask kind, q/k/v as views of one qkv)
FLASH_CASES = {
    "vit_s4": (32, 64, 3, 64, False, None, True),
    "vit_b16_t196": (8, 196, 12, 64, False, None, False),
    "d48": (8, 128, 4, 48, False, None, False),
    "t67": (8, 67, 3, 64, False, None, False),
    "causal_t512": (4, 512, 4, 64, True, None, False),
    "causal_dead_rows": (4, 256, 4, 64, True, "dead", False),
    "t2048_d128": (4, 2048, 8, 128, False, None, False),
    # D not a multiple of 4 (4-byte copies, zero-filled columns) and T not a
    # multiple of any tile
    "d37_t77": (3, 77, 2, 37, False, None, False),
}
FLASH_TIMED = {"vit_s4": 200, "t2048_d128": 20}   # case -> timed iterations


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


def device_ms(fn, iters):
    """Mean device milliseconds per call of ``fn``: the sum of the times of
    the kernels (and copies) it ran, from ``torch.profiler``, without the
    host time between them. At small shapes the host's launch rate, not the
    device, sets ``time_ms``; this is the device's share. A profile that
    recorded no device event at all is taken again, up to three times, and
    then reported as None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters * 1e-3
    return None


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


def leaf_batch(leaves):
    """K1's multi-tensor wrapper over ``leaves`` (their step's flags, each
    leaf's decay flag)."""
    from tpu_ddp_torch.ops.fused_update import LeafBatch

    return LeafBatch([lf.p for lf in leaves], [lf.m for lf in leaves],
                     [lf.v for lf in leaves], [lf.e for lf in leaves],
                     leaves[0].cfg, [lf.cfg.wd_apply for lf in leaves],
                     us=[lf.u for lf in leaves])


def compare(leaves, scalars):
    """K1 over all of ``leaves`` in one multi-tensor call and the plain
    version leaf by leaf, on copies; (max_abs_err, max_ulp, launches)."""
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.ops.fused_update import update_math

    refs, krns = [lf.clone() for lf in leaves], [lf.clone() for lf in leaves]
    before = ops.LAUNCHES["fused_update"]
    leaf_batch(krns).run([k.g for k in krns], scalars)
    launches = ops.LAUNCHES["fused_update"] - before
    worst_abs, worst_ulp = 0.0, 0
    for ref, krn in zip(refs, krns):
        u, m, v, e = update_math(ref.g, ref.p, ref.m, ref.v, ref.e, scalars, ref.cfg)
        want = {"u": u, "p": ref.p + u, "m": m, "v": v, "e": e}
        for k, w in want.items():
            if w is None:
                continue
            got = getattr(krn, k)
            if not bool((got.isfinite() == w.isfinite()).all()):
                fail(f"K1 {k}: finite pattern differs from the plain version")
            worst_abs = max(worst_abs, float((got - w).abs().nan_to_num().max())
                            if got.numel() else 0.0)
            worst_ulp = max(worst_ulp, ulp_diff(got, w))
    return worst_abs, worst_ulp, launches


def vit_leaf_shapes():
    """ViT-S/4's parameter shapes, in the model's order."""
    from tpu_ddp_torch.models import MODEL_REGISTRY

    shapes = [tuple(p.shape) for _, p in
              MODEL_REGISTRY["vit_s4"]().named_parameters()]
    if len(shapes) != VIT_LEAVES:
        fail(f"vit_s4 has {len(shapes)} parameter leaves, expected {VIT_LEAVES}")
    return shapes


def phase_kernel_vs_plain():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    vit_shapes = vit_leaf_shapes()
    results = {}
    print("phase 3: K1 vs plain version, one launch a group (max |diff|, max ulp, "
          "launches)", flush=True)
    for variant in VARIANTS:
        for schedule in ("constant", "cosine"):
            groups = {
                "netresdeep": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen)
                               for s in NETRESDEEP_LEAVES],
                "vit_s4": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen)
                           for s in vit_shapes],
                "ragged": [Leaf(s, leaf_config(variant, schedule, True), gen)
                           for s in RAGGED],
                "unaligned": [Leaf((1_000_003,), leaf_config(variant, schedule, True),
                                   gen, offset=1)],
                "large": [Leaf((LARGE,), leaf_config(variant, schedule, True), gen)],
                "mixed": [Leaf(s, leaf_config(variant, schedule, wd), gen, offset=off)
                          for s, off, wd in MIXED],
            }
            for group, leaves in groups.items():
                scalars = scalars_for(leaves, leaves[0].cfg, schedule)
                err, ulp, launches = compare(leaves, scalars)
                torch.cuda.synchronize()
                results[(variant, schedule, group)] = (err, ulp)
                print(f"  {variant:20s} {schedule:8s} {group:10s} "
                      f"max|diff|={err:.3g} max_ulp={ulp} launches={launches}",
                      flush=True)
                if ulp:
                    fail(f"K1 {variant}/{schedule}/{group}: {ulp} ulp from the "
                         "plain version (must be bitwise)")
                if launches != 1:
                    fail(f"K1 {variant}/{schedule}/{group}: {launches} launches "
                         f"for {len(leaves)} leaves, expected 1")
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
    worth of K1 over ``shapes`` (constant schedule): one multi-tensor call
    against the plain version leaf by leaf."""
    import torch

    from tpu_ddp_torch import ops

    update_math = ops.resolve("fused_update")["plain"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = [Leaf(s, leaf_config(variant, "constant", len(s) >= 2), gen)
              for s in shapes]
    scalars = scalars_for(leaves, leaves[0].cfg, "constant")
    batch, grads = leaf_batch(leaves), [lf.g for lf in leaves]

    def kernel():
        # what FusedUpdate.apply runs a step after its prologue: the grads'
        # check and one launch
        batch.run(grads, scalars)

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
    dev = {"device_ms": device_ms(kernel, 20), "plain_device_ms": device_ms(plain, 20),
           "library_device_ms": device_ms(lib, 20)}
    return (k1 + k2) / 2, (p1 + p2) / 2, lib_ms, b_ms, b_by, dev


def k1_row(name, variant, shapes, group, iters, launches, results, label):
    """One ``kernels`` row of K1 over ``shapes`` under ``variant``."""
    from tpu_ddp_torch import ops

    entry = ops.KERNELS["fused_update"]
    k_ms, p_ms, l_ms, b_ms, b_by, dev = time_group(variant, shapes, iters)
    err = max(results[(variant, s, group)][0] for s in ("constant", "cosine"))
    print(f"  {name:36s} kernel {k_ms:.5f} ms  plain {p_ms:.5f} ms  "
          f"library {l_ms:.5f} ms  bound {b_ms:.5f} ms ({b_by}); device "
          f"only: kernel {dev['device_ms']}, plain {dev['plain_device_ms']}, "
          f"library {dev['library_device_ms']} ms", flush=True)
    return {
        "name": name, "route": entry["route"], "source": entry["source"],
        "replaces": entry["replaces"], "launches": launches,
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
        "shapes": label, "recipe": variant, **dev,
    }


def phase_timing(results, main_launches):
    print("phase 6: K1 timing (CUDA events; ms per step of the listed leaves)",
          flush=True)
    rows = [k1_row("fused_update", "sgd", NETRESDEEP_LEAVES, "netresdeep", 500,
                   main_launches, results, "netresdeep 9 leaves (76,074)")]
    for variant in VARIANTS:
        rows.append(k1_row(f"fused_update[{variant},2^24]", variant, [(LARGE,)],
                           "large", 50, main_launches, results, "one leaf of 2^24"))
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
          f"(one a step: {steps}), images/sec/chip "
          f"{metrics['images_per_sec_per_chip']:.1f}, training time "
          f"{metrics['total_seconds']:.3f} s, final test accuracy "
          f"{metrics['test_accuracy']:.4f}", flush=True)
    if steps != 2 * MAIN_STEPS_PER_EPOCH:
        fail(f"main path ran {steps} steps, expected {2 * MAIN_STEPS_PER_EPOCH}")
    if any(n for name, n in counts.items() if name != "fused_update"):
        fail(f"the NetResDeep path launched attention kernels: {counts}")
    if counts["fused_update"] != steps:
        fail(f"K1 launched {counts['fused_update']} times in {steps} steps, "
             f"expected {steps}")
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


def close(got, want, atol, rtol):
    """(max |got - want|, all within atol + rtol * |want|)."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= atol + rtol * want.abs()).all())


def flash_inputs(case, seed=0):
    """q, k, v, do and the key mask of ``FLASH_CASES[case]`` on the card."""
    import torch

    B, T, H, D, causal, mask_kind, views = FLASH_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if views:
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda")
        q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                   for _ in range(3))
    do = torch.randn((B, T, H, D), generator=gen, device="cuda")
    mask = None
    if mask_kind == "dead":
        # batch 0 hides its last quarter of keys; batch 1 its first quarter,
        # so under causal its first T/4 queries see no key at all
        mask = torch.ones((B, T), device="cuda")
        mask[0, 3 * T // 4:] = 0
        mask[1, :T // 4] = 0
    return q, k, v, do, mask, causal


def phase_flash_vs_plain():
    import torch

    from tpu_ddp_torch.ops import flash_attention as fa

    print("phase 7: K4/K5/K6 vs plain versions (max |diff|)", flush=True)
    results, failed = {}, []
    for case in FLASH_CASES:
        q, k, v, do, mask, causal = flash_inputs(case)
        want_out, want_lse = fa.forward_plain(q, k, v, mask, causal)
        di = fa.row_dot(do, want_out)
        want_dq = fa.dq_plain(q, k, v, do, want_lse, di, mask, causal)
        want_dk, want_dv = fa.dkv_plain(q, k, v, do, want_lse, di, mask, causal)
        out, lse = fa.flash_forward(q, k, v, mask, causal)
        dq = fa.flash_dq(q, k, v, do, want_lse, di, mask, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, want_lse, di, mask, causal)
        # each output row is written once by its block (no atomics): a
        # second call gives the same bits
        again = (fa.flash_dq(q, k, v, do, want_lse, di, mask, causal),
                 *fa.flash_dkv(q, k, v, do, want_lse, di, mask, causal))
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        if not repeat:
            failed.append(f"{case}: two calls of K5/K6 differ")
        errs, size = {}, {}
        for name, got, want, tol in (
                ("out", out, want_out, FWD_TOL), ("lse", lse, want_lse, FWD_TOL),
                ("dq", dq, want_dq, GRAD_TOL), ("dk", dk, want_dk, GRAD_TOL),
                ("dv", dv, want_dv, GRAD_TOL)):
            err, ok = close(got, want, **tol)
            errs[name], size[name] = err, float(want.abs().max())
            if not ok or not bool(torch.isfinite(got).all()):
                failed.append(f"{case} {name} (max |diff| {err:.3g})")
        if mask is not None:
            T = q.shape[1]
            dead = (bool((out[1, :T // 4] == 0).all())
                    and bool((dq[1, :T // 4] == 0).all())
                    and bool((lse[1, :, :T // 4] == fa.NEG).all()))
            if not dead:
                failed.append(f"{case}: rows with no visible key are not exactly 0")
            hidden = mask == 0
            if not (bool((dk[hidden] == 0).all()) and bool((dv[hidden] == 0).all())):
                failed.append(f"{case}: masked keys' dk/dv are not exactly 0")
        results[case] = errs
        print(f"  {case:18s} {tuple(q.shape)} causal={causal} mask={mask is not None} "
              + " ".join(f"{n}={e:.3g} (of {size[n]:.3g})" for n, e in errs.items())
              + f" K5/K6 bitwise on a second call: {repeat}", flush=True)
        del q, k, v, do, want_out, want_lse, want_dq, want_dk, want_dv, again
    if failed:
        fail("flash kernels disagree with their plain versions: " + "; ".join(failed))
    return results


def vit_args(attention):
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * VIT_STEPS_PER_EPOCH), "--epochs", "2", "--model", "vit_s4",
            "--attention", attention, "--kernels", "--optimizer", "adamw",
            "--lr", "1e-3", "--batch-size", "32", "--eval-each-epoch",
            "--log-every-epochs", "1"]


def phase_vit_main_path():
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    runs = {}
    for attention in ("flash", "full"):
        args = vit_args(attention)
        print(f"phase 8: ViT main path: tpu_ddp_torch.cli.train {' '.join(args)}",
              flush=True)
        ops.reset_launch_counts()
        metrics = cli.main(args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps, evals = metrics["steps"], metrics["eval_batches"]
        losses = metrics["step_losses"]
        print(f"  steps {steps}, eval batches {evals}, launches {counts}, "
              f"images/sec/chip {metrics['images_per_sec_per_chip']:.1f}, "
              f"training time {metrics['total_seconds']:.3f} s, final test "
              f"accuracy {metrics['test_accuracy']:.4f}", flush=True)
        if steps != 2 * VIT_STEPS_PER_EPOCH:
            fail(f"ViT path ran {steps} steps, expected {2 * VIT_STEPS_PER_EPOCH}")
        flash = attention == "flash"
        want = {"fused_update": steps,
                "flash_attention_fwd": VIT_DEPTH * (steps + evals) if flash else 0,
                "flash_attention_dq": VIT_DEPTH * steps if flash else 0,
                "flash_attention_dkv": VIT_DEPTH * steps if flash else 0,
                "fused_quant": 0, "fused_dequant": 0}
        if counts != want:
            fail(f"ViT --attention {attention}: launches {counts}, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"ViT --attention {attention} produced a non-finite loss")
        first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
        print(f"  mean loss of the first 20 steps {first:.4f}, last 20 {last:.4f}",
              flush=True)
        if not last < first:
            fail(f"ViT --attention {attention} losses did not fall")
        if not math.isfinite(metrics["test_loss"]) or metrics["test_accuracy"] < 0.2:
            fail(f"ViT final eval out of range: {metrics['test_accuracy']}, "
                 f"{metrics['test_loss']}")
        runs[attention] = (metrics, counts)
    got = runs["full"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    want = runs["flash"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"  --attention full vs flash, relative loss difference per step: "
          f"{' '.join(f'{r:.2g}' for r in rel)} (limit {FULL_STEPS_RTOL})", flush=True)
    if not max(rel) <= FULL_STEPS_RTOL:
        fail("--attention full and flash losses disagree over the first steps")
    return runs


def attention_work(kind, B, T, H, D):
    """(bytes, product operations, other float32 operations) of one
    non-causal, unmasked call: each input read once, each output written
    once; two operations per multiply-add of its products (forward: S and
    P V; dq: S, dP and dS K; dk/dv: S, dP, P^T dO and dS^T Q), and the
    per-score softmax work."""
    n, rows, pairs = B * T * H * D, B * H * T, B * H * T * T
    if kind == "fwd":        # read q, k, v; write out, lse
        return 4 * (4 * n + rows), 4 * pairs * D, 5 * pairs
    if kind == "dq":         # read q, k, v, dO, lse, di; write dq
        return 4 * (5 * n + 2 * rows), 6 * pairs * D, 6 * pairs
    # read q, k, v, dO, lse, di; write dk, dv
    return 4 * (6 * n + 2 * rows), 8 * pairs * D, 6 * pairs


def attention_bound(kind, B, T, H, D):
    """(bound_ms, bound_by) of one call: its bytes over the HBM rate
    against all its float32 operations over the float32 rate."""
    nbytes, products, other = attention_work(kind, B, T, H, D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (products + other) / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_tc(kind, B, T, H, D):
    """(bound_ms, bound_by) of one call of K4, K5 or K6 in 3xTF32: its bytes
    against its products as three TF32 products each over the tensor
    cores' rate."""
    nbytes, products, _ = attention_work(kind, B, T, H, D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * products / TF32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash_timing(results, counts):
    import torch
    import torch.nn.functional as F

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.ops import flash_attention as fa

    print("phase 9: timing on the ViT path (CUDA events; ms per call)", flush=True)
    rows = [k1_row("fused_update[vit_s4]", VIT_RECIPE, vit_leaf_shapes(), "vit_s4",
                   100, counts["fused_update"], results["k1"],
                   f"vit_s4 {VIT_LEAVES} leaves (2,693,194)")]
    for case, iters in FLASH_TIMED.items():
        q, k, v, do, _, _ = flash_inputs(case, seed=1)
        B, T, H, D = q.shape
        out, lse = fa.forward_plain(q, k, v)
        di = fa.row_dot(do, out)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves))
        sdpa_do = do.transpose(1, 2)
        library = {
            "fwd": lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            "bwd": lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_do,
                                               retain_graph=True),
        }
        lib_ms = {key: time_ms(fn, iters) for key, fn in library.items()}
        lib_dev = {key: device_ms(fn, iters) for key, fn in library.items()}
        timed = {
            "flash_attention_fwd": ("fwd", lambda: fa.flash_forward(q, k, v),
                                    lambda: fa.forward_plain(q, k, v), ("out", "lse")),
            "flash_attention_dq": ("dq", lambda: fa.flash_dq(q, k, v, do, lse, di),
                                   lambda: fa.dq_plain(q, k, v, do, lse, di), ("dq",)),
            "flash_attention_dkv": ("dkv", lambda: fa.flash_dkv(q, k, v, do, lse, di),
                                    lambda: fa.dkv_plain(q, k, v, do, lse, di),
                                    ("dk", "dv")),
        }
        for name, (kind, kernel, plain, outputs) in timed.items():
            entry = ops.KERNELS[name]
            k1 = time_ms(kernel, iters)
            p1 = time_ms(plain, iters)
            p2 = time_ms(plain, iters)
            k2 = time_ms(kernel, iters)
            b_ms, b_by = attention_bound(kind, B, T, H, D)
            lib_key = "fwd" if kind == "fwd" else "bwd"
            l_ms = lib_ms[lib_key]
            dev = {"device_ms": device_ms(kernel, iters),
                   "plain_device_ms": device_ms(plain, iters),
                   "library_device_ms": lib_dev[lib_key]}
            tc_ms, tc_by = attention_bound_tc(kind, B, T, H, D)
            dev.update(bound_tc_ms=tc_ms, bound_tc_by=tc_by,
                       launch=fa.forward_launch_info(D) if kind == "fwd"
                       else fa.backward_launch_info(kind, D))
            print(f"  {name + '[' + case + ']':36s} 3xTF32 bound {tc_ms:.5f} ms "
                  f"({tc_by}); launch {dev['launch']}", flush=True)
            rows.append({
                "name": f"{name}[{case}]", "route": entry["route"],
                "source": entry["source"], "replaces": entry["replaces"],
                "launches": counts[name],
                "max_abs_err": max(results["flash"][case][o] for o in outputs),
                "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                "shapes": f"(B, T, H, D) = {(B, T, H, D)}",
                "library": "scaled_dot_product_attention "
                           + ("forward" if kind == "fwd" else "backward (dq, dk, dv)"),
                **dev,
            })
            print(f"  {name + '[' + case + ']':36s} kernel {(k1 + k2) / 2:.5f} ms  "
                  f"plain {(p1 + p2) / 2:.5f} ms  library {l_ms:.5f} ms  "
                  f"bound {b_ms:.5f} ms ({b_by}); device only: kernel "
                  f"{dev['device_ms']}, plain {dev['plain_device_ms']}, "
                  f"library {dev['library_device_ms']} ms", flush=True)
        k5, k6 = rows[-2], rows[-1]
        dev_sum = (None if k5["device_ms"] is None or k6["device_ms"] is None
                   else k5["device_ms"] + k6["device_ms"])
        print(f"  K5 + K6 [{case}]: events {k5['ms'] + k6['ms']:.5f} ms, device {dev_sum} ms; "
              f"SDPA backward (dq, dk, dv): events {lib_ms['bwd']:.5f} ms, device "
              f"{lib_dev['bwd']} ms", flush=True)
        del q, k, v, do, out, lse, di, leaves, sdpa_out
    return rows


# ---- phases 10-13: the compressed gradient ring on two ranks (K2, K3) ----

#: NetResDeep's leaves flattened, padded to 2 ranks and halved: the ring's
#: chunk sizes at n = 2, one K2 / K3 call each per hop
NETRESDEEP_CHUNKS = [432, 16, 4608, 16, 16, 32768, 16, 160, 5]
QUANT_BLOCK = 256                      # --grad-compress-block default
QUANT_SIZES = [1, 255, 257, 1_000_003, LARGE]
QUANT_BLOCKS = [1, 64, 256, 1000, 4096]   # 4096: one thread block a scale block
RING_LEAVES = [math.prod(s) for s in NETRESDEEP_LEAVES] + [1 << 22]
DP_STEPS_PER_EPOCH = 100
DP_LOSS_ATOL = 0.05


def quant_case(x, block, gen, failed, label):
    """K2 and K3 (bare and accumulating) against their plain versions on
    ``x``. Bitwise, except the int8 bytes of a block whose scale is not
    finite: there the scales must agree (NaN with NaN, +-Inf equal) and
    every dequantized element must be non-finite. Returns max |diff|."""
    import torch

    from tpu_ddp_torch.ops.fused_quant import fused_dequant, fused_quant
    from tpu_ddp_torch.parallel.compression import dequantize_chunk, quantize_chunk

    size = x.numel()
    want = quantize_chunk(x, "int8", block)
    got = fused_quant(x, block)
    s_k, s_p = got["scale"], want["scale"]
    finite = torch.isfinite(s_p)
    same_scale = bool((torch.isnan(s_k) == torch.isnan(s_p)).all()) and bool(
        (s_k[~torch.isnan(s_p)] == s_p[~torch.isnan(s_p)]).all())
    rows = finite.repeat_interleave(block)
    same_q = torch.equal(got["q"][rows], want["q"][rows])
    acc = torch.randn(size, generator=gen, device="cuda")
    worst = 0.0
    for add in (None, acc):
        d_k = fused_dequant(got, block, size, add_to=add)
        d_p = dequantize_chunk(got, "int8", block, size)
        d_p = d_p if add is None else add + d_p
        fin = torch.isfinite(d_p)
        bad_block = ~finite.repeat_interleave(block)[:size]
        if not torch.equal(fin, torch.isfinite(d_k)) or bool(fin[bad_block].any()):
            failed.append(f"{label}: K3 non-finite pattern")
        if not torch.equal(d_k[fin].view(torch.int32), d_p[fin].view(torch.int32)):
            failed.append(f"{label}: K3{' +add_to' if add is not None else ''} "
                          "differs from its plain version")
        if size:
            worst = max(worst, float((d_k[fin] - d_p[fin]).abs().max()))
    if not (same_scale and same_q):
        failed.append(f"{label}: K2 scale equal {same_scale}, q equal {same_q}")
    return worst


def phase_quant_vs_plain():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(10)
    failed, worst = [], {}

    def run(label, x, block):
        err = quant_case(x, block, gen, failed, label)
        torch.cuda.synchronize()
        worst[label] = err

    print("phase 10: K2/K3 vs plain versions (bitwise; non-finite blocks by "
          "the sentinel contract)", flush=True)
    for i, n in enumerate(NETRESDEEP_CHUNKS):
        run(f"netresdeep chunk {i} ({n})", torch.randn(n, generator=gen, device="cuda"),
            QUANT_BLOCK)
    for i, shape in enumerate(vit_leaf_shapes()):
        n = math.prod(shape)
        run(f"vit_s4 chunk {i} ({(n + n % 2) // 2})",
            torch.randn((n + n % 2) // 2, generator=gen, device="cuda") * 0.02, QUANT_BLOCK)
    for n in QUANT_SIZES:
        run(f"size {n}", torch.randn(n, generator=gen, device="cuda") * 3, QUANT_BLOCK)
    buf = torch.randn(1_000_004, generator=gen, device="cuda")
    run("size 1000003 unaligned", buf[1:], QUANT_BLOCK)
    for block in QUANT_BLOCKS:
        run(f"block {block} (size 100003)",
            torch.randn(100_003, generator=gen, device="cuda"), block)
    x = torch.randn(8 * 256, generator=gen, device="cuda")
    x[3], x[300], x[600], x[1024:1280] = float("nan"), float("inf"), -float("inf"), 0.0
    x[1300], x[1301] = float("inf"), float("nan")
    run("nan, +inf, -inf and all-zero blocks", x, QUANT_BLOCK)
    run("nan, +inf, -inf and all-zero blocks, block 64", x, 64)
    print(f"  {len(worst)} cases, max |diff| over finite values "
          f"{max(worst.values()):.3g}", flush=True)
    if failed:
        fail("K2/K3 disagree with their plain versions: " + "; ".join(failed[:10]))
    return max(worst.values())


def ring_rank(rank, world, out_dir):
    """Phase 11 on one rank (spawned; both ranks on cuda:0 over gloo)."""
    import torch

    from tpu_ddp_torch.parallel.collectives import ring_all_reduce
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    result = {"equal": True}
    outs = []
    for n in RING_LEAVES:
        x = torch.randn(n + n % 2, generator=gen, device="cuda")
        k_out, k_err = ring_all_reduce(x, mode="int8", block=QUANT_BLOCK,
                                       with_error=True, kernels=True)
        p_out, p_err = ring_all_reduce(x, mode="int8", block=QUANT_BLOCK,
                                       with_error=True, kernels=False)
        result["equal"] &= torch.equal(k_out, p_out) and torch.equal(k_err, p_err)
        outs.append(k_out.cpu())
    torch.save(outs, f"{out_dir}/ring{rank}.pt")
    # one step's ring over NetResDeep's 9 leaves, as the train step runs it
    params = {f"leaf{i}": torch.randn(s, generator=gen, device="cuda")
              for i, s in enumerate(NETRESDEEP_LEAVES)}
    comp = GradCompressor(GradCompression(mode="int8", block=QUANT_BLOCK,
                                          error_feedback=True, kernels=True),
                          params, world)
    residual = comp.init_residual("cuda")

    def step():
        nonlocal residual
        _, residual = comp.all_reduce_mean(params, residual, with_error=True)

    for _ in range(10):
        step()
    torch.cuda.synchronize()
    iters = 100
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    result["ring_step_ms"] = (time.perf_counter() - t0) / iters * 1e3
    result["ring_device"] = profile_split(step, 20)
    with open(f"{out_dir}/ring{rank}.json", "w") as f:
        json.dump(result, f)


def profile_split(fn, iters):
    """Device ms per call of ``fn`` under ``torch.profiler``, split into
    K2/K3, host<->device copies and other kernels; None without device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {"quant_kernels": 0.0, "memcpy": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("quant_kernels" if "tpu_ddp_quant" in e.key or "tpu_ddp_dequant" in e.key
               else "memcpy" if "memcpy" in e.key.lower() else "other")
        split[key] += e.self_device_time_total / iters * 1e-3
    return split if any(split.values()) else None


def phase_ring_on_card(tmp):
    from tpu_ddp_torch.parallel.runtime import spawn

    import torch

    print("phase 11: ring_all_reduce int8 + error feedback on two ranks on "
          "cuda:0 over gloo, K2/K3 vs plain versions", flush=True)
    out = os.path.join(tmp, "ring")
    os.makedirs(out)
    spawn(ring_rank, 2, out, init_file=os.path.join(out, "rdzv"), timeout=300)
    res = []
    for r in range(2):
        with open(os.path.join(out, f"ring{r}.json")) as f:
            res.append(json.load(f))
    outs = [torch.load(os.path.join(out, f"ring{r}.pt")) for r in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"  leaves {RING_LEAVES}: kernels == plain on rank 0 {res[0]['equal']}, "
          f"rank 1 {res[1]['equal']}; outputs identical across ranks {same}", flush=True)
    for r in range(2):
        print(f"  rank {r}: one step's ring over NetResDeep's 9 leaves "
              f"{res[r]['ring_step_ms']:.4f} ms (host clock); device ms a step by "
              f"kind: {res[r]['ring_device']}", flush=True)
    if not (res[0]["equal"] and res[1]["equal"] and same):
        fail("the ring with K2/K3 differs from the ring with plain versions, "
             "or across ranks")
    return res


def dp_args(compress, nproc=2, backend="gloo"):
    args = ["--device", "cuda", "--dist-backend", backend, "--synthetic-data",
            "--synthetic-size", str(nproc * 32 * DP_STEPS_PER_EPOCH), "--epochs", "2",
            "--kernels", "--eval-each-epoch", "--log-every-epochs", "1",
            "--n-chans1", "32", "--n-blocks", "10", "--batch-size", "32",
            "--lr", "1e-2", "--optimizer", "sgd"]
    if compress:
        args += ["--grad-compress", "int8", "--grad-compress-error-feedback"]
    return args


def dp_launches(nproc):
    """K1, K2 and K3 launches a step a rank at ``nproc`` ranks with error
    feedback, over NetResDeep's 9 leaves: K1 once (all leaves in one
    launch), K2 n a leaf (n-1 hops and the gather phase's quantize), K3
    (n-1)(1+ef) + ef + n a leaf (tpu_ddp/parallel/collectives.py:245-268,
    :289-303)."""
    return {"fused_update": 1, "fused_quant": 9 * nproc,
            "fused_dequant": 9 * ((nproc - 1) * 2 + 1 + nproc)}


def rank_child(out_dir, args):
    """One rank of phase 12, started by the launcher: the train CLI's
    ``run`` with the launch counts zeroed just before; writes the counts,
    the metrics and the final weights to ``out_dir``."""
    import torch

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    rank = int(os.environ["RANK"])
    ops.reset_launch_counts()
    trainer, metrics = cli.run(args)
    torch.cuda.synchronize()
    metrics["launches"] = ops.launch_counts()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(metrics, f)
    torch.save({k: v.cpu() for k, v in trainer.state.model.state_dict().items()},
               os.path.join(out_dir, f"rank{rank}.pt"))


def launch_dp(tmp, name, args, nproc):
    import torch

    from tpu_ddp_torch.cli.launch import run_job

    out = os.path.join(tmp, name)
    os.makedirs(out)
    print(f"phase 12: python -m tpu_ddp_torch.cli.launch --nproc-per-node {nproc} "
          f"-- python -m tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
    rc = run_job([sys.executable, os.path.abspath(__file__), "--rank-child", out,
                  *args], nproc_per_node=nproc)
    if rc:
        fail(f"the {nproc}-rank run exited with {rc}")
    metrics = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            metrics.append(json.load(f))
    weights = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(nproc)]
    same = all(torch.equal(weights[0][k], w[k]) for w in weights[1:] for k in w)
    return metrics, same


def phase_dp_main_path(tmp, nproc=2, backend="gloo"):
    runs = {}
    for compress in (True, False):
        metrics, same = launch_dp(tmp, "int8" if compress else "plain",
                                  dp_args(compress, nproc, backend), nproc)
        m = metrics[0]
        steps, losses = m["steps"], m["step_losses"]
        first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
        print(f"  steps {steps}; launches on rank 0 {m['launches']}; params "
              f"bitwise equal on all {nproc} ranks {same}", flush=True)
        step_ms = " / ".join(f"{x['steady_step_ms']:.4f}" for x in metrics)
        print(f"  mean loss of the first 20 steps {first:.4f}, last 20 {last:.4f}; "
              f"final test accuracy {m['test_accuracy']:.4f}; steady-state step "
              f"time per rank: {step_ms} ms", flush=True)
        if steps != 2 * DP_STEPS_PER_EPOCH:
            fail(f"the {nproc}-rank run took {steps} steps, expected "
                 f"{2 * DP_STEPS_PER_EPOCH}")
        if not all(math.isfinite(x) for x in losses) or not last < first:
            fail(f"the {nproc}-rank run's losses are not finite and falling")
        if not same:
            fail(f"the {nproc} ranks end with different params")
        want = {name: 0 for name in m["launches"]}
        want["fused_update"] = steps
        if compress:
            want.update({k: v * steps for k, v in dp_launches(nproc).items()})
        for r in range(nproc):
            if metrics[r]["launches"] != want:
                fail(f"rank {r} launched {metrics[r]['launches']}, expected {want}")
        runs["int8" if compress else "plain"] = metrics
    got = runs["plain"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    want = runs["int8"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    diff = max(abs(g - w) for g, w in zip(got, want))
    print(f"  plain DP vs int8 + error feedback, first {PLAIN_STEPS_RTOL} step losses: "
          f"max |diff| {diff:.4g} (limit {DP_LOSS_ATOL})", flush=True)
    if not diff <= DP_LOSS_ATOL:
        fail("plain DP and the int8 ring disagree over the first steps")
    return runs


def quant_bound(sizes, block, kind):
    """(bound_ms, "bytes"): bytes each call must move over the HBM rate.
    K2 reads 4 bytes an element and writes nb * block int8 plus 4 bytes a
    block; K3 reads 1 byte an element (5 with add_to) plus 4 a block and
    writes 4 an element. Their few operations an element are far below the
    bytes' time."""
    total = 0
    for n in sizes:
        nb = -(-n // block)
        if kind == "quant":
            total += 4 * n + nb * block + 4 * nb
        else:
            total += n + 4 * nb + 4 * n + (4 * n if kind == "dequant_add" else 0)
    return total / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_quant_timing(quant_err, runs):
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.ops.fused_quant import fused_dequant, fused_quant
    from tpu_ddp_torch.parallel.compression import dequantize_chunk, quantize_chunk

    print("phase 13: K2/K3 timing (CUDA events, ms per step of the listed calls; "
          "no single PyTorch call computes either function, so no library time)",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    launches = runs["int8"][0]["launches"]
    groups = {
        # one step of the main path on one rank: each chunk twice through K2,
        # four times through bare K3 and once through K3 with add_to
        "netresdeep step": (NETRESDEEP_CHUNKS, {"quant": 2, "dequant": 4,
                                                "dequant_add": 1}, 500),
        "2^24": ([LARGE], {"quant": 1, "dequant": 1, "dequant_add": 1}, 50),
    }
    rows = []
    for group, (sizes, reps, iters) in groups.items():
        xs = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
        accs = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
        payloads = [fused_quant(x, QUANT_BLOCK) for x in xs]
        calls = {
            "quant": (lambda: [fused_quant(x, QUANT_BLOCK) for x in xs],
                      lambda: [quantize_chunk(x, "int8", QUANT_BLOCK) for x in xs]),
            "dequant": (lambda: [fused_dequant(p, QUANT_BLOCK, x.numel())
                                 for p, x in zip(payloads, xs)],
                        lambda: [dequantize_chunk(p, "int8", QUANT_BLOCK, x.numel())
                                 for p, x in zip(payloads, xs)]),
            "dequant_add": (lambda: [fused_dequant(p, QUANT_BLOCK, x.numel(), add_to=a)
                                     for p, x, a in zip(payloads, xs, accs)],
                            lambda: [a + dequantize_chunk(p, "int8", QUANT_BLOCK, x.numel())
                                     for p, x, a in zip(payloads, xs, accs)]),
        }
        for kind, (kernel, plain) in calls.items():
            n_rep = reps[kind]
            k1, p1 = time_ms(kernel, iters), time_ms(plain, iters)
            p2, k2 = time_ms(plain, iters), time_ms(kernel, iters)
            dev_k, dev_p = device_ms(kernel, 20), device_ms(plain, 20)
            b_ms, b_by = quant_bound(sizes, QUANT_BLOCK, kind)
            name = "fused_quant" if kind == "quant" else "fused_dequant"
            entry = ops.KERNELS[name]
            scale = lambda v: None if v is None else v * n_rep  # noqa: E731
            row = {
                "name": name + {"quant": "", "dequant": "",
                                "dequant_add": "[add_to]"}[kind]
                + ("" if group == "netresdeep step" else "[2^24]"),
                "route": entry["route"], "source": entry["source"],
                "replaces": entry["replaces"], "launches": launches[name],
                "max_abs_err": quant_err, "ms": (k1 + k2) / 2 * n_rep,
                "plain_ms": (p1 + p2) / 2 * n_rep, "bound_ms": b_ms * n_rep,
                "bound_by": b_by, "library_ms": None,
                "library": "none: no single PyTorch call quantizes or dequantizes "
                           "block-scaled int8",
                "shapes": f"{group}: chunks {sizes} x {n_rep}, block {QUANT_BLOCK}",
                "device_ms": scale(dev_k), "plain_device_ms": scale(dev_p),
            }
            rows.append(row)
            print(f"  {row['name']:28s} {group:16s} x{n_rep}: kernel {row['ms']:.5f} ms  "
                  f"plain {row['plain_ms']:.5f} ms  bound {row['bound_ms']:.6f} ms "
                  f"(bytes); device only: kernel {row['device_ms']}, plain "
                  f"{row['plain_device_ms']} ms", flush=True)
        del xs, accs, payloads
    return rows


def nccl_main(nproc):
    """``python3 chip_smoke.py --nccl N`` on a machine with N cards: phase 12
    at N ranks, one card each, over NCCL (the default backend on cuda)."""
    import shutil
    import tempfile

    import torch

    if torch.cuda.device_count() < nproc:
        fail(f"--nccl {nproc} needs {nproc} cards, {torch.cuda.device_count()} visible")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch.ops import _build

    print(nvidia_smi(), flush=True)
    _build.build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_dp_main_path(tmp, nproc, "nccl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"chip_smoke --nccl {nproc}: ok", flush=True)


def main():
    if sys.argv[1:2] == ["--rank-child"]:
        return rank_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--nccl"]:
        return nccl_main(int(sys.argv[2]))
    import shutil
    import tempfile

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
    flash_results = phase_flash_vs_plain()
    vit_runs = phase_vit_main_path()
    rows += phase_flash_timing({"k1": results, "flash": flash_results},
                               vit_runs["flash"][1])
    for attention, (m, _) in vit_runs.items():
        print(f"ViT-S/4 --attention {attention}: steady-state images/sec/chip "
              f"{m['images_per_sec_per_chip']:.1f}", flush=True)
    quant_err = phase_quant_vs_plain()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_ring_on_card(tmp)
        dp_runs = phase_dp_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows += phase_quant_timing(quant_err, dp_runs)
    for name, ms in (("int8 ring", dp_runs["int8"]), ("plain DP", dp_runs["plain"])):
        print(f"NetResDeep on two ranks, {name}: steady-state step time per rank "
              f"{ms[0]['steady_step_ms']:.4f} / {ms[1]['steady_step_ms']:.4f} ms",
              flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
