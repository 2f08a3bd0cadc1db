"""What ZeRO-1's pad mask costs K1 on the card: K1 as built against K1
rebuilt with the mask compiled out, on the same inputs, in turns.

    python -m tpu_ddp_torch.tools.k1_variants

The variants are ``csrc/fused_update.cu`` built with the library's own nvcc
flags (``tools/variants.py``):

* ``built``: the source as it is;
* ``no_mask``: no block ever takes the masked loop, so the compiler drops
  it: the kernel as it was before the mask, on the same leaf table.

Unmasked leaves (2^24 elements under each recipe, and NetResDeep's 9 and
ViT-S/4's 79 whole leaves) run through both; the ZeRO-1 shards of both
models at rank 2 of 3 run through ``built`` with their mask and without it
(every ``valid`` set to the shard's size). Each reading is the kernel's
device time under ``torch.profiler``, microseconds a call, two readings
in turns (built, no_mask, no_mask, built). The masked outputs are checked
bitwise against ``update_math_masked``. The last line is one JSON object
with these numbers.
"""

from __future__ import annotations

import json
import math

import torch

from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep
from tpu_ddp_torch.ops.fused_update import (
    LeafBatch,
    LeafConfig,
    shard_valid,
    update_math_masked,
)
from tpu_ddp_torch.runtime import device_name
from tpu_ddp_torch.tools import variants

LIBRARY = "fused_update"
VARIANTS = {
    "built": [],
    "no_mask": [("const bool mask = (L.flags & kLeafMask) != 0 && end > L.valid;",
                 "const bool mask = false;")],
}
RECIPES = {
    "sgd": dict(kind="sgd", momentum=0.0, wd=0.0, clip=False, ema=0.0),
    "sgd_mom_wd_clip_ema": dict(kind="sgd", momentum=0.9, wd=5e-4, clip=True, ema=0.99),
    "adamw_wd_clip_ema": dict(kind="adamw", momentum=0.0, wd=0.05, clip=True, ema=0.99),
    "adamw": dict(kind="adamw", momentum=0.0, wd=0.0, clip=False, ema=0.0),
}
RANKS, RANK = 3, 2


def config(recipe: str, decayed: bool) -> LeafConfig:
    r = RECIPES[recipe]
    return LeafConfig(kind=r["kind"], momentum=r["momentum"], wd=r["wd"],
                      wd_apply=decayed and r["wd"] > 0, has_clip=r["clip"],
                      max_norm=1.0, step_const=-1e-3 if r["kind"] == "adamw" else -1e-2,
                      ema_decay=r["ema"], b1=0.9, b2=0.999, eps=1e-8)


def operands(sizes, recipe, decayed, valid, gen):
    """One step's leaves on the card: a ``LeafBatch`` over fresh operands
    of ``sizes`` (with ``valid`` live elements each), its grads and its
    scalars."""
    cfg = config(recipe, True)
    t = lambda n: torch.randn(n, generator=gen, device="cuda")  # noqa: E731
    ps = [t(n) for n in sizes]
    ms = [t(n) * 0.1 for n in sizes] if cfg.has_m else None
    vs = [t(n).abs() * 0.01 for n in sizes] if cfg.has_v else None
    es = [t(n) for n in sizes] if cfg.ema_decay else None
    batch = LeafBatch(ps, ms, vs, es, cfg, decayed, valid=valid)
    grads = [t(n) for n in sizes]
    scalars = torch.tensor([3.0, -0.007, 0.271, 0.002997], device="cuda")
    return batch, grads, scalars


def run(lib, batch, grads, scalars):
    batch.table_for(grads)
    batch._launch(scalars, lib)


def masked_exact(lib, sizes, recipe, decayed, valid, gen) -> bool:
    """One masked launch through ``lib`` bitwise equal to the plain
    version, every output of every leaf."""
    batch, grads, scalars = operands(sizes, recipe, decayed, valid, gen)
    slots = ("ps", "ms", "vs", "es")
    before = {k: [None if x is None else x.clone() for x in getattr(batch, k)]
              for k in slots}
    run(lib, batch, grads, scalars)
    for i, (n, live) in enumerate(zip(sizes, valid)):
        cfg = config(recipe, decayed[i])
        want = update_math_masked(grads[i], *(before[k][i] for k in slots), scalars,
                                  cfg, start=0, mask_size=live if live < n else None)
        got = (batch.us[i], batch.ps[i], batch.ms[i], batch.vs[i], batch.es[i])
        if not all(w is None or torch.equal(g, w) for g, w in zip(got, want)):
            return False
    return True


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants needs a CUDA device")
    libs = variants.build(LIBRARY, VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = {"netresdeep": NetResDeep(n_chans1=32, n_blocks=10, num_classes=10),
              "vit_s4": MODEL_REGISTRY["vit_s4"]()}
    shapes = {m: [tuple(p.shape) for p in model.parameters()]
              for m, model in models.items()}
    cases = {f"2^24 {r}": (r, [1 << 24], [True]) for r in RECIPES}
    cases["netresdeep 9 leaves sgd"] = ("sgd", [math.prod(s) for s in shapes["netresdeep"]],
                                        [len(s) >= 2 for s in shapes["netresdeep"]])
    cases["vit_s4 79 leaves adamw_wd_clip_ema"] = (
        "adamw_wd_clip_ema", [math.prod(s) for s in shapes["vit_s4"]],
        [len(s) >= 2 for s in shapes["vit_s4"]])
    result = {"device": device_name(torch.device("cuda")), "us": {}, "exact": True}
    for name, (recipe, sizes, decayed) in cases.items():
        batch, grads, scalars = operands(sizes, recipe, decayed, None, gen)
        iters = 20 if sizes[0] >= 1 << 24 else 200
        us = {v: [] for v in libs}
        for v in ("built", "no_mask", "no_mask", "built"):
            us[v].append(variants.kernel_us(lambda v=v: run(libs[v], batch, grads, scalars),
                                            iters, ("fused_update_kernel",))
                         ["fused_update_kernel"])
        result["us"][name] = us
        print(f"{name}: " + "  ".join(f"{v} {u[0]:.3f}/{u[1]:.3f}" for v, u in us.items()),
              flush=True)
    for model, recipe in (("netresdeep", "sgd"), ("vit_s4", "adamw_wd_clip_ema")):
        sizes, valid, decayed = [], [], []
        for s in shapes[model]:
            size = math.prod(s)
            n = -(-size // RANKS)
            sizes.append(n)
            valid.append(shard_valid(size, RANK * n, n))
            decayed.append(len(s) >= 2)
        result["exact"] &= masked_exact(libs["built"], sizes, recipe, decayed, valid, gen)
        masked = operands(sizes, recipe, decayed, valid, gen)
        bare = operands(sizes, recipe, decayed, None, gen)
        us = {"masked": [], "unmasked": []}
        for v in ("masked", "unmasked", "unmasked", "masked"):
            args = masked if v == "masked" else bare
            us[v].append(variants.kernel_us(lambda a=args: run(libs["built"], *a), 200,
                                            ("fused_update_kernel",))["fused_update_kernel"])
        name = f"{model} shards, rank {RANK} of {RANKS}, {recipe}"
        result["us"][name] = us
        print(f"{name} ({sum(k < n for k, n in zip(valid, sizes))} masked): "
              + "  ".join(f"{v} {u[0]:.3f}/{u[1]:.3f}" for v, u in us.items()), flush=True)
    print(json.dumps(result), flush=True)
    if not result["exact"]:
        raise SystemExit("masked K1 differs from update_math_masked")
    return result


if __name__ == "__main__":
    main()
