"""Where K2's time goes on the card: K2 as built against K2 rebuilt with one
choice undone, and against another checkout's K2, on the same inputs, in
turns.

    python -m tpu_ddp_torch.tools.k2_variants [--parent DIR]

The variants are ``csrc/fused_quant.cu`` built with the library's own nvcc
flags (``tools/variants.py``):

* ``built``: the source as it is (one warp a scale block, each lane's
  elements held in registers between the max and the quantize pass, the
  error output compiled in only when it is asked for);
* ``err_branch``: the error output's store behind a test of the pointer at
  run time in every build of the kernel;
* ``loop``: each pass loops over the scale block and the second reads it
  again from the cache;
* ``loop_err_branch``: both (the segment K2 as it was first written);
* ``loop_bounds8``: ``loop_err_branch`` held to eight 256-thread blocks an
  SM (``__launch_bounds__``: at most 32 registers a thread);
* ``parent`` (with ``--parent DIR``): ``DIR``'s
  ``tpu_ddp_torch/ops/csrc/fused_quant.cu``, a K2 of one chunk a launch
  (the interface before the segment table), run once a leaf.

Inputs: one 2^24-element chunk (the one-segment case) and one ring hop over
ViT-B/16's 151 leaves (224x224) at two ranks, each without and with the
error output. Each reading is the device time of the call's kernels under
``torch.profiler`` and its time by CUDA events, microseconds a call, two
readings in turns (the variants in order, then in reverse). Every output
is checked bitwise against the plain version (``quantize_chunk``,
``segment_quant_plain``). Prints the card's name and power limit, the
registers a thread of each variant's kernels (ptxas), one line a case and,
last, one JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import torch

from tpu_ddp_torch.models import MODEL_REGISTRY
from tpu_ddp_torch.ops import _build
from tpu_ddp_torch.ops.fused_quant import segment_quant_plain
from tpu_ddp_torch.parallel.compression import (
    GradCompression,
    GradCompressor,
    quantize_chunk,
)
from tpu_ddp_torch.tools import variants

LIBRARY = "fused_quant"
LOOP = [("else if (block > 16 * kWarp) launch_quant<kWarp, 32>(warps,",
         "else if (block > 0) launch_quant<kWarp, 0>(warps,")]
ERR_BRANCH = [("  const bool with_err = E;", "  const bool with_err = err != nullptr;")]
BOUNDS8 = [("template <int G, int K, bool E>\n__global__ void tpu_ddp_quant_kernel(",
            "template <int G, int K, bool E>\n__global__ void __launch_bounds__(kThreads, 8) "
            "tpu_ddp_quant_kernel(")]
VARIANTS = {
    "built": [],
    "err_branch": ERR_BRANCH,
    "loop": LOOP,
    "loop_err_branch": LOOP + ERR_BRANCH,
    "loop_bounds8": LOOP + ERR_BRANCH + BOUNDS8,
}
BLOCK, RANKS, LARGE = 256, 2, 1 << 24
_P, _LL = ctypes.c_void_p, ctypes.c_longlong


def registers(name: str) -> list:
    log = (_build.BUILD_DIR / f"{LIBRARY}_variants" / f"{name}.log").read_text()
    return sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})


def launch(lib, x, table, nseg, size, nb, chunk, scale, q, err):
    rc = lib.tpu_ddp_fused_quant(
        x.data_ptr(), None if table is None else table.data_ptr(), nseg, size, nb,
        BLOCK, chunk, scale.data_ptr(), q.data_ptr(),
        None if err is None else err.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "k2 variant launch")


def parent_quant(lib, x, q, scale):
    """The parent interface: one chunk of ``x.numel()`` elements."""
    rc = lib.tpu_ddp_fused_quant(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                 x.numel(), BLOCK, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "parent k2 launch")


def parent_dequant(lib, q, scale, out):
    rc = lib.tpu_ddp_fused_dequant(q.data_ptr(), scale.data_ptr(), None, out.data_ptr(),
                                   out.numel(), BLOCK, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "parent k3 launch")


def events_us(fn, iters: int) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def vit_b16_layout():
    with torch.device("meta"):
        model = MODEL_REGISTRY["vit_b16"](image_size=224)
    template = {str(i): p for i, p in enumerate(model.parameters())}
    return GradCompressor(GradCompression(block=BLOCK), template, RANKS).layout


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout, whose K2 runs as 'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    extra = {}
    if args.parent:
        extra["parent"] = (os.path.join(os.path.abspath(args.parent), "tpu_ddp_torch",
                                        "ops", "csrc", "fused_quant.cu"), ())
    libs = variants.build(LIBRARY, VARIANTS, extra)
    if "parent" in libs:
        libs["parent"].tpu_ddp_fused_quant.argtypes = [_P, _P, _P, _LL, _LL, _P]
        libs["parent"].tpu_ddp_fused_dequant.argtypes = [_P, _P, _P, _P, _LL, _LL, _P]
    regs = {v: registers(v) for v in libs}
    print("registers a thread: " + ", ".join(f"{v} {r}" for v, r in regs.items()),
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": smi, "registers": regs, "us": {}, "exact": {}}
    big = torch.randn(LARGE, generator=gen, device="cuda")
    nb_big = -(-LARGE // BLOCK)
    layout = vit_b16_layout()
    x = torch.randn(layout.total, generator=gen, device="cuda")
    table = layout.table(x.device)
    want_big = quantize_chunk(big, "int8", BLOCK)
    want_big_err = big - (want_big["q"].float().view(-1, BLOCK)
                          * want_big["scale"][:, None]).view(-1)
    want_err = torch.zeros_like(x)
    want_msg = segment_quant_plain(x, layout, 0, "int8", err=want_err)
    chunks = [layout.chunk(x, i, 0) for i in range(len(layout.shard))]

    def one_segment(v, with_err):
        scale = torch.empty(nb_big, device="cuda")
        q = torch.empty(nb_big * BLOCK, dtype=torch.int8, device="cuda")
        err = torch.empty_like(big) if with_err else None
        if v == "parent":
            out = torch.empty_like(big)

            def fn():
                parent_quant(libs[v], big, q, scale)
                if with_err:
                    parent_dequant(libs[v], q, scale, out)
                    torch.sub(big, out, out=err)
        else:
            def fn():
                launch(libs[v], big, None, 1, LARGE, nb_big, 0, scale, q, err)
        fn()
        exact = torch.equal(q, want_big["q"]) and torch.equal(scale, want_big["scale"])
        if with_err:
            exact = exact and torch.equal(err, want_big_err)
        return fn, exact

    def hop(v, with_err):
        msg = torch.empty(layout.msg_bytes("int8"), dtype=torch.uint8, device="cuda")
        scale = msg[:4 * layout.n_blocks].view(torch.float32)
        q = msg[4 * layout.n_blocks:].view(torch.int8)
        err = torch.zeros_like(x) if with_err else None
        if v == "parent":
            views = layout.payload(msg, "int8")
            outs = [torch.empty_like(c) for c in chunks]

            def fn():
                for i, c in enumerate(chunks):
                    parent_quant(libs[v], c, views[i]["q"], views[i]["scale"])
                    if with_err:
                        parent_dequant(libs[v], views[i]["q"], views[i]["scale"], outs[i])
                        torch.sub(c, outs[i], out=layout.chunk(err, i, 0))
        else:
            def fn():
                launch(libs[v], x, table, table.shape[0], 0, layout.n_blocks, 0, scale,
                       q, err)
        fn()
        exact = torch.equal(msg, want_msg)
        if with_err:
            exact = exact and torch.equal(err, want_err)
        return fn, exact

    cases = {
        "2^24": (one_segment, False, list(libs), 50),
        "2^24 with the error": (one_segment, True, list(libs), 50),
        f"vit_b16 hop, {len(layout.shard)} leaves at {RANKS} ranks": (
            hop, False, list(libs), 10),
        f"vit_b16 hop, {len(layout.shard)} leaves at {RANKS} ranks, with the error": (
            hop, True, list(libs), 10),
    }
    for name, (make, with_err, names, iters) in cases.items():
        fns = {}
        for v in names:
            fns[v], result["exact"][f"{name} {v}"] = make(v, with_err)
        dev = {v: [] for v in names}
        ev = {v: [] for v in names}
        for v in names + names[::-1]:
            # the parent's error is three kernels a chunk; count them all
            us = variants.kernel_us(fns[v], iters, ("",))
            dev[v].append(us[""])
            ev[v].append(events_us(fns[v], iters))
        result["us"][name] = {"device": dev, "events": ev}
        print(f"{name}: " + "  ".join(
            f"{v} dev {dev[v][0]:.2f}/{dev[v][1]:.2f} ev {ev[v][0]:.2f}/{ev[v][1]:.2f}"
            for v in names), flush=True)
    result["bitwise"] = all(result["exact"].values())
    print(json.dumps(result), flush=True)
    if not result["bitwise"]:
        raise SystemExit("a variant disagrees with the plain version: "
                         + ", ".join(k for k, ok in result["exact"].items() if not ok))
    return result


if __name__ == "__main__":
    main()
