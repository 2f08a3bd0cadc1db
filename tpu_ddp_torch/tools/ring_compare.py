"""The compressed gradient ring and the steps that run it, timed in turns
against another checkout of the repository on one card.

    python -m tpu_ddp_torch.tools.ring_compare --other DIR [--turns 4]

``DIR`` is another checkout (the parent commit, say, unpacked with ``git
archive`` into a directory ``.gitignore`` lists). The turns alternate other,
this, this, other (``--turns 4``), each in fresh processes that import the
turn's own ``tpu_ddp_torch`` and build its own kernels. Each turn runs:

1. ``ring``: two ranks sharing ``cuda:0`` over gloo; one step's compressed
   ring (``GradCompressor.all_reduce_mean``, int8, block 256, error
   feedback, the kernels) over NetResDeep's 9 leaves and over ViT-S/4's 79:
   host ms a step (steady, between synchronisations), K2/K3 launches and
   wire calls a step, and its device ms by kind (``torch.profiler``).
2. ``kernels``: K2, K3 and K3 with ``add_to`` on one 2**24 chunk at block
   256 (``fused_quant`` / ``fused_dequant``, whose interface both sides
   share): ms a call by CUDA events over 50 calls, and device ms a call.
3. ``steps``: NetResDeep at full width through the launcher, batch 32 a
   rank, SGD lr 1e-2, ``--kernels``, two epochs of 100 steps: two ranks
   with ``--grad-compress int8 --grad-compress-error-feedback`` and without
   (plain DP); three ranks with ``--zero1``, int8 with error feedback and
   float32. The steady step time per rank (the trainer's, over the second
   epoch).

Prints the card's ``nvidia-smi`` name and power limit, one JSON line a turn
and, last, one JSON object with every turn. Writes nothing but a scratch
directory under ``build/``, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

THIS = os.path.abspath(__file__)
HERE = os.path.dirname(os.path.dirname(os.path.dirname(THIS)))
NETRESDEEP_LEAVES = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32,),
                     (32, 2048), (32,), (10, 32), (10,)]
RING_ITERS = {"netresdeep": 100, "vit_s4": 30}
STEPS = 100
LARGE = 1 << 24


def wire_counter() -> dict:
    """Count the ring's wire calls from here on in this process:
    ``exchange`` and ``all_gather_bytes`` as the ring in
    ``parallel/collectives.py`` looks them up. Returns the live counts."""
    from tpu_ddp_torch.parallel import collectives

    counts = {"exchange": 0, "all_gather_bytes": 0}
    for name in counts:
        fn = getattr(collectives, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)

        setattr(collectives, name, counted)
    return counts


def device_split(fn, iters):
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
        if e.device_type == DeviceType.CUDA:
            key = ("quant_kernels" if "tpu_ddp_quant" in e.key or "tpu_ddp_dequant" in e.key
                   else "memcpy" if "memcpy" in e.key.lower() else "other")
            split[key] += e.self_device_time_total / iters * 1e-3
    return split if any(split.values()) else None


def time_ring(comp, params, residual, wire, iters) -> dict:
    """One step's compressed ring (``comp.all_reduce_mean`` with error
    feedback) on this rank, after 10 warm-up steps: host ms a step between
    synchronisations over ``iters`` steps, the kernels' launches and the
    wire calls (``wire``, from ``wire_counter``) of one step, and device ms
    a step by kind."""
    import torch

    from tpu_ddp_torch import ops

    def step():
        nonlocal residual
        _, residual = comp.all_reduce_mean(params, residual, with_error=True)

    for _ in range(10):
        step()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    before = dict(wire)
    step()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    calls = {k: wire[k] - before[k] for k in wire}
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return {"host_ms": (time.perf_counter() - t0) / iters * 1e3, "launches": launches,
            "wire_calls": calls, "device_ms": device_split(step, 20)}


def ring_child(rank, world, out_dir):
    """One rank of the ``ring`` measurement (spawned)."""
    import torch

    from tpu_ddp_torch.models import MODEL_REGISTRY
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

    torch.cuda.set_device(0)
    wire = wire_counter()
    gen = torch.Generator(device="cuda").manual_seed(rank)
    vit = [tuple(p.shape) for p in MODEL_REGISTRY["vit_s4"]().parameters()]
    result = {}
    for model, shapes in (("netresdeep", NETRESDEEP_LEAVES), ("vit_s4", vit)):
        params = {f"leaf{i}": torch.randn(s, generator=gen, device="cuda") * 0.02
                  for i, s in enumerate(shapes)}
        comp = GradCompressor(GradCompression(mode="int8", block=256,
                                              error_feedback=True, kernels=True),
                              params, world)
        result[model] = dict(leaves=len(shapes), **time_ring(
            comp, params, comp.init_residual("cuda"), wire, RING_ITERS[model]))
    with open(os.path.join(out_dir, f"ring{rank}.json"), "w") as f:
        json.dump(result, f)


def kernels_child(out_dir):
    """The ``kernels`` measurement (one process)."""
    import torch

    from tpu_ddp_torch.ops.fused_quant import fused_dequant, fused_quant

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, acc = (torch.randn(LARGE, generator=gen, device="cuda") for _ in range(2))
    payload = fused_quant(x, 256)
    calls = {"fused_quant": lambda: fused_quant(x, 256),
             "fused_dequant": lambda: fused_dequant(payload, 256, LARGE),
             "fused_dequant[add_to]": lambda: fused_dequant(payload, 256, LARGE,
                                                            add_to=acc)}
    result = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(50):
            fn()
        end.record()
        end.synchronize()
        result[name] = {"ms": start.elapsed_time(end) / 50,
                        "device_ms": device_split(fn, 20)["quant_kernels"]}
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump(result, f)


def step_child(out_dir, args):
    """One rank of a ``steps`` run, started by the turn's launcher."""
    from tpu_ddp_torch.cli import train as cli

    _, metrics = cli.run(args)
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.json"), "w") as f:
        json.dump({"steady_step_ms": metrics["steady_step_ms"],
                   "steps": metrics["steps"]}, f)


def _ring_main(out_dir):
    from tpu_ddp_torch.parallel.runtime import spawn

    spawn(ring_child, 2, out_dir, init_file=os.path.join(out_dir, "rdzv"), timeout=600)


STEP_RUNS = {
    "dp_int8_ef": (2, ["--grad-compress", "int8", "--grad-compress-error-feedback"]),
    "dp_plain": (2, []),
    "zero1_int8_ef": (3, ["--zero1", "--grad-compress", "int8",
                          "--grad-compress-error-feedback"]),
    "zero1_f32": (3, ["--zero1"]),
}


def _step_args(nproc, extra):
    return ["--device", "cuda", "--dist-backend", "gloo", "--synthetic-data",
            "--synthetic-size", str(nproc * 32 * STEPS), "--epochs", "2", "--kernels",
            "--log-every-epochs", "1", "--n-chans1", "32", "--n-blocks", "10",
            "--batch-size", "32", "--lr", "1e-2", "--optimizer", "sgd", *extra]


def _turn(root, scratch):
    """One turn from checkout ``root``: the ring, the kernels and the four
    step runs."""
    env = dict(os.environ, PYTHONPATH=root)
    out = tempfile.mkdtemp(dir=scratch)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, THIS, "--ring-child", root, out], cwd=root,
                   env=env, check=True)
    ring = [json.load(open(os.path.join(out, f"ring{r}.json"))) for r in range(2)]
    subprocess.run([sys.executable, THIS, "--kernels-child", root, out], cwd=root,
                   env=env, check=True)
    kernels = json.load(open(os.path.join(out, "kernels.json")))
    steps = {}
    for name, (nproc, extra) in STEP_RUNS.items():
        run_dir = tempfile.mkdtemp(dir=scratch)
        subprocess.run([sys.executable, "-m", "tpu_ddp_torch.cli.launch",
                        "--nproc-per-node", str(nproc), "--", sys.executable, THIS,
                        "--step-child", root, run_dir, *_step_args(nproc, extra)],
                       cwd=root, env=env, check=True)
        steps[name] = [json.load(open(os.path.join(run_dir, f"rank{r}.json")))
                       ["steady_step_ms"] for r in range(nproc)]
    return {"root": root, "seconds": time.perf_counter() - t0, "ring": ring,
            "kernels": kernels, "steady_step_ms": steps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other checkout's root")
    ap.add_argument("--turns", type=int, default=4,
                    help="turns in the order other, this, this, other, ...")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    roots = {"other": os.path.abspath(args.other), "this": HERE}
    order = [("other", "this", "this", "other")[i % 4] for i in range(args.turns)]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="ring_compare-", dir=os.path.join(HERE, "build"))
    turns = []
    try:
        for who in order:
            turn = dict(_turn(roots[who], scratch), turn=who)
            print(json.dumps(turn), flush=True)
            turns.append(turn)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"device": smi, "turns": turns}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ring-child"]:
        sys.path.insert(0, sys.argv[2])
        _ring_main(sys.argv[3])
    elif sys.argv[1:2] == ["--kernels-child"]:
        sys.path.insert(0, sys.argv[2])
        kernels_child(sys.argv[3])
    elif sys.argv[1:2] == ["--step-child"]:
        sys.path.insert(0, sys.argv[2])
        step_child(sys.argv[3], sys.argv[4:])
    else:
        main()
