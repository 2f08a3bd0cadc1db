"""K5/K6's design choices on the card: the kernels as built against the
kernels rebuilt with one choice undone, on the same inputs, in turns.

    python -m tpu_ddp_torch.tools.k56_variants [--baseline PATH [--baseline-flags F]]

Each variant is ``csrc/flash_attention.cu`` with one textual change, built
with the library's own nvcc flags (``tools/variants.py``):

* ``built``: the source as it is;
* ``lo_rounded``: the low part of each operand split rounded to TF32, as K4
  rounds it, instead of handed to the tensor core as it is;
* ``kg2``: the output n-tiles of dQ, dV and dK two at a time, not four;
* ``dq_rows64_d64``: K5 at D <= 64 with 64-key streamed tiles, not 32.

``--baseline`` adds another source with the same C entry points (an earlier
``flash_attention.cu``, say), built with the library's flags and
``--baseline-flags``, as the variant ``baseline``.

For each: the largest difference from ``dq_plain``/``dkv_plain`` at every
timed shape (held to ``tests/test_ops.py``'s gradient tolerance), the
registers and blocks an SM of K5 and K6 at D = 64 and 128 where the source
reports them, and each kernel's device time (``torch.profiler``,
microseconds a call, two readings in turns) at the ViT-S/4 path's
(32, 64, 3, 64), at (4, 2048, 8, 128) and at (4, 2048, 8, 64). The last line
is one JSON object with these numbers.
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
        "Launch{flash_dq_kernel<64, 32>, smem_bytes<64, 32, 1>(), kBM, 32}",
        "Launch{flash_dq_kernel<64, 64>, smem_bytes<64, 64, 1>(), kBM, 64}")],
}
#: name -> (B, T, H, D, timed calls)
SHAPES = {
    "vit_s4": (32, 64, 3, 64, 200),
    "t2048_d128": (4, 2048, 8, 128, 10),
    "t2048_d64": (4, 2048, 8, 64, 10),
}
TOL = dict(atol=5e-5, rtol=1e-4)   # tests/test_ops.py's gradient tolerance
DQ, DKV = "flash_dq_kernel", "flash_dkv_kernel"


def launch_info(lib) -> dict:
    """K5's and K6's launches at D = 64 and 128 (``backward_launch_info``'s
    keys), where the library reports them."""
    if not hasattr(lib, "tpu_ddp_flash_bwd_info"):
        return {}
    info = {}
    for which, kind in enumerate(("dq", "dkv")):
        for D in (64, 128):
            out = (ctypes.c_int * len(fa._LAUNCH_KEYS))()
            if lib.tpu_ddp_flash_bwd_info(which, D, out) == 0:
                info[f"{kind}_d{D}"] = dict(zip(fa._LAUNCH_KEYS, out))
    return info


def backward(lib, q, k, v, do, lse, di):
    """K5 and K6 of ``lib``: (dq, dk, dv)."""
    B, T, H, D = q.shape
    dq, dk, dv = (torch.empty((B, T, H, D), device=q.device) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, di)]
    rc = lib.tpu_ddp_flash_dq(*ptrs, None, dq.data_ptr(), fa._strides(q, k, v, do, dq),
                              B, T, H, D, 0, stream)
    rc = rc or lib.tpu_ddp_flash_dkv(*ptrs, None, dk.data_ptr(), dv.data_ptr(),
                                     fa._strides(q, k, v, do, dk, dv), B, T, H, D, 0,
                                     stream)
    if rc:
        raise RuntimeError(f"K5/K6 launch: CUDA error {rc}")
    return dq, dk, dv


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="another source with the same C entry points")
    parser.add_argument("--baseline-flags", default="",
                        help="extra nvcc flags for --baseline, space-separated")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k56_variants needs a CUDA device")
    extra = {"baseline": (args.baseline, args.baseline_flags.split())} if args.baseline else {}
    libs = variants.build(LIBRARY, VARIANTS, extra)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": device_name(torch.device("cuda")),
              "launch": {n: launch_info(lib) for n, lib in libs.items()},
              "us": {}, "max_abs_err": {}}
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
