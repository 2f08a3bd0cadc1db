"""K5/K6's design choices on the card: the kernels as built against the
kernels rebuilt with one choice undone, on the same inputs, in turns.

    python -m tpu_ddp_torch.tools.k56_variants [--dtype bfloat16]
        [--baseline PATH [--baseline-flags F]]

Each variant is ``csrc/flash_attention.cu`` and its headers with one
textual change, built with the library's own nvcc flags
(``tools/variants.py``). float32 (the 3xTF32 kernels):

* ``built``: the source as it is;
* ``lo_rounded``: the low part of each operand split rounded to TF32, as K4
  rounds it, instead of handed to the tensor core as it is;
* ``kg2``: the output n-tiles of dQ, dV and dK two at a time, not four;
* ``dq_rows64_d64``: K5 at D <= 64 with 64-key streamed tiles, not 32.

bfloat16 (K5's wgmma kernel and K6's mma.sync one, ``--dtype bfloat16``):

* ``built``: the source as it is;
* ``stages3``: three K/V stages in K5's ring, not four;
* ``stages6_d64``: six K/V stages in K5's ring at D <= 64, not four.

``--baseline`` adds another source with the same C entry points (an earlier
``flash_attention.cu``, say; for the parent commit's, ``git show
<commit>:tpu_ddp_torch/ops/csrc/flash_attention.cu``, with its
``bf16_tiles.cuh`` beside it), built with the library's flags and
``--baseline-flags``, as the variant ``baseline``.

For each: the largest difference from ``dq_plain``/``dkv_plain`` at every
timed shape (float32: held to ``tests/test_ops.py``'s gradient tolerance;
bfloat16: to 2 bf16 units of each row's largest value), the registers and
blocks an SM of K5 and K6 at D = 64 and 128 where the source reports them,
and each kernel's device time (``torch.profiler``, microseconds a call, two
readings in turns). float32: at the ViT-S/4 path's (32, 64, 3, 64), at
(4, 2048, 8, 128) and at (4, 2048, 8, 64). bfloat16: at the LM-32k path's
(4, 4096, 8, 64) causal and the ViT-S/4 path's (32, 64, 3, 64), q, k and v
views of one qkv product, with each kernel's CUDA-event time beside. The
last line is one JSON object with these numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.runtime import device_name
from tpu_ddp_torch.tools import variants

LIBRARY = "flash_attention"
#: variant -> [(text in the source, its replacement)], each found once
VARIANTS = {
    "built": [],
    "lo_rounded": [("  lo = __float_as_uint(rest);\n",
                    "  lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;\n")],
    "kg2": [("constexpr int kG = 4;", "constexpr int kG = 2;")],
    "dq_rows64_d64": [(
        "Launch<Args>{flash_dq_kernel<64, 32>, smem_bytes<64, 32, 1>(), kBM, 32}",
        "Launch<Args>{flash_dq_kernel<64, 64>, smem_bytes<64, 64, 1>(), kBM, 64}")],
}
VARIANTS_BF16 = {
    "built": [],
    "stages3": [("constexpr int kDqStages = 4;", "constexpr int kDqStages = 3;")],
    "stages6_d64": [("LaunchW{flash_dq_bf16_kernel<64, kDqStages>, Smem<64, 2, kDqStages>",
                     "LaunchW{flash_dq_bf16_kernel<64, 6>, Smem<64, 2, 6>")],
}
#: name -> (B, T, H, D, timed calls)
SHAPES = {
    "vit_s4": (32, 64, 3, 64, 200),
    "t2048_d128": (4, 2048, 8, 128, 10),
    "t2048_d64": (4, 2048, 8, 64, 10),
}
#: name -> (B, T, H, D, causal, timed calls)
SHAPES_BF16 = {
    "lm_causal": (4, 4096, 8, 64, True, 20),
    "vit_s4": (32, 64, 3, 64, False, 200),
}
TOL = dict(atol=5e-5, rtol=1e-4)   # tests/test_ops.py's gradient tolerance
BF16_UNITS = 2                     # chip_smoke.py phase 20a's bfloat16 tolerance
DQ, DKV = "flash_dq_kernel", "flash_dkv_kernel"
DQ_BF16, DKV_BF16 = "flash_dq_bf16", "flash_dkv_bf16"


def launch_info(lib, suffix="") -> dict:
    """K5's and K6's launches at D = 64 and 128 (``backward_launch_info``'s
    keys), where the library reports them; ``suffix`` "_bf16" for the
    bfloat16 kernels."""
    fn = getattr(lib, "tpu_ddp_flash_bwd_info" + suffix, None)
    if fn is None:
        return {}
    info = {}
    for which, kind in enumerate(("dq", "dkv")):
        for D in (64, 128):
            out = (ctypes.c_int * len(fa._LAUNCH_KEYS))()
            if fn(which, D, out) == 0:
                info[f"{kind}_d{D}"] = dict(zip(fa._LAUNCH_KEYS, out))
    return info


def dq(lib, q, k, v, do, lse, di, causal=False):
    """K5 of ``lib``: dq; the bfloat16 entry point for bfloat16 inputs,
    through the wrapper's operand plan."""
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), device=q.device, dtype=q.dtype)
    bf16 = q.dtype == torch.bfloat16
    fn = lib.tpu_ddp_flash_dq_bf16 if bf16 else lib.tpu_ddp_flash_dq
    planned = [fa.tma_operand(x) for x in (q, k, v, do)] if bf16 else [q, k, v, do]
    rc = fn(*[x.data_ptr() for x in planned], lse.data_ptr(), di.data_ptr(), None,
            out.data_ptr(), fa._strides(*planned, out), B, T, H, D, int(causal),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"K5 launch: CUDA error {rc}")
    return out


def backward(lib, q, k, v, do, lse, di, causal=False):
    """K5 and K6 of ``lib``: (dq, dk, dv); the bfloat16 entry points for
    bfloat16 inputs."""
    B, T, H, D = q.shape
    dk, dv = (torch.empty((B, T, H, D), device=q.device, dtype=q.dtype) for _ in range(2))
    fn = lib.tpu_ddp_flash_dkv_bf16 if q.dtype == torch.bfloat16 else lib.tpu_ddp_flash_dkv
    rc = fn(*[x.data_ptr() for x in (q, k, v, do, lse, di)], None, dk.data_ptr(),
            dv.data_ptr(), fa._strides(q, k, v, do, dk, dv), B, T, H, D, int(causal),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"K6 launch: CUDA error {rc}")
    return dq(lib, q, k, v, do, lse, di, causal), dk, dv


def _main_bf16(libs, gen, result) -> dict:
    """The bfloat16 kernels at ``SHAPES_BF16``: errors, device and event
    times in turns."""
    bad = {}
    for shape, (B, T, H, D, causal, iters) in SHAPES_BF16.items():
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
        do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = fa.forward_plain(q, k, v, causal=causal)
        di = fa.row_dot(do, out)
        want = (fa.dq_plain(q, k, v, do, lse, di, causal=causal),
                *fa.dkv_plain(q, k, v, do, lse, di, causal=causal))
        for name, lib in libs.items():
            got = backward(lib, q, k, v, do, lse, di, causal)
            err = max(float(variants.bf16_row_units(g, w).max())
                      for g, w in zip(got, want))
            result["max_abs_err"][name] = max(err, result["max_abs_err"].get(name, 0.0))
            if not err <= BF16_UNITS:
                bad.setdefault(name, []).append(shape)
        turns = list(libs) + list(libs)[::-1]
        us = {name: [] for name in libs}
        ev = {name: [] for name in libs}
        for name in turns:
            call = lambda lib=libs[name]: backward(lib, q, k, v, do, lse, di, causal)  # noqa: E731
            us[name].append(variants.kernel_us(call, iters, (DQ_BF16, DKV_BF16)))
            ev[name].append(variants.event_us(call, iters))
        result["us"][shape] = us
        result["event_us"][shape] = ev
        print(f"{shape}: " + "  ".join(
            f"{n} dq {u[0][DQ_BF16]:.2f}/{u[1][DQ_BF16]:.2f} dkv {u[0][DKV_BF16]:.2f}/"
            f"{u[1][DKV_BF16]:.2f} events (both) {e[0]:.2f}/{e[1]:.2f}"
            for (n, u), e in zip(us.items(), ev.values())), flush=True)
        del q, k, v, do, qkv, out, lse, di, want
    return bad


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--baseline", help="another source with the same C entry points")
    parser.add_argument("--baseline-flags", default="",
                        help="extra nvcc flags for --baseline, space-separated")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k56_variants needs a CUDA device")
    bf16 = args.dtype == "bfloat16"
    extra = {"baseline": (args.baseline, args.baseline_flags.split())} if args.baseline else {}
    libs = variants.build(LIBRARY, VARIANTS_BF16 if bf16 else VARIANTS, extra)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": device_name(torch.device("cuda")), "dtype": args.dtype,
              "launch": {n: launch_info(lib, "_bf16" if bf16 else "")
                         for n, lib in libs.items()},
              "us": {}, "event_us": {}, "max_abs_err": {}}
    if bf16:
        bad = _main_bf16(libs, gen, result)
        print(f"launch: {result['launch']}", flush=True)
        print(json.dumps(result), flush=True)
        if bad:
            raise SystemExit(f"variants beyond {BF16_UNITS} bf16 units of the plain versions: "
                             f"{bad}")
        return result
    bad = {}
    for shape, (B, T, H, D, iters) in SHAPES.items():
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                       for _ in range(4))
        out, lse = fa.forward_plain(q, k, v)
        di = fa.row_dot(do, out)
        want = (fa.dq_plain(q, k, v, do, lse, di), *fa.dkv_plain(q, k, v, do, lse, di))
        for name, lib in libs.items():
            got = backward(lib, q, k, v, do, lse, di)
            diff = [(g - w).abs() for g, w in zip(got, want)]
            err = max(float(d.max()) for d in diff)
            result["max_abs_err"][name] = max(err, result["max_abs_err"].get(name, 0.0))
            if not all(bool((d <= TOL["atol"] + TOL["rtol"] * w.abs()).all())
                       for d, w in zip(diff, want)):
                bad.setdefault(name, []).append(shape)
        turns = list(libs) + list(libs)[::-1]
        us = {name: [] for name in libs}
        for name in turns:
            us[name].append(variants.kernel_us(
                lambda lib=libs[name]: backward(lib, q, k, v, do, lse, di), iters,
                (DQ, DKV)))
        result["us"][shape] = us
        print(f"{shape}: " + "  ".join(
            f"{n} dq {u[0][DQ]:.2f}/{u[1][DQ]:.2f} dkv {u[0][DKV]:.2f}/{u[1][DKV]:.2f}"
            for n, u in us.items()), flush=True)
        del q, k, v, do, out, lse, di, want
    print(f"launch: {result['launch']}", flush=True)
    print(json.dumps(result), flush=True)
    if bad:
        raise SystemExit(f"variants beyond the gradient tolerance of the plain versions: {bad}")
    return result


if __name__ == "__main__":
    main()
