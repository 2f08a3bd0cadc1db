"""K4's design choices on the card: K4 as built against K4 rebuilt with one
choice undone, on the same inputs, in turns.

    python -m tpu_ddp_torch.tools.k4_variants

Each variant is ``csrc/flash_forward.cu`` with one textual change, built
with the library's own nvcc flags (``tools/variants.py``):

* ``built``: the source as it is;
* ``cvt_rna``: the operand split through ``cvt.rna.tf32.f32`` instead of its
  integer form (the same rounding);
* ``rows32``: 32-row query tiles of two warps, which double the grid at
  short T;
* ``unroll_full``: the S loop fully unrolled at D = 64 too.

For each: the largest difference from ``forward_plain`` at every timed
shape, and the kernel's device time (``torch.profiler``, microseconds a
call, two readings in turns) at the ViT-S/4 path's (32, 64, 3, 64) called
back to back and called between the two linears that surround it in a ViT
block, and at (4, 2048, 8, 128) and (4, 2048, 8, 64). The last line is one
JSON object with these numbers.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.runtime import device_name
from tpu_ddp_torch.tools import variants

LIBRARY = "flash_forward"
#: variant -> [(text in the source, its replacement)], each found once
VARIANTS = {
    "built": [],
    "cvt_rna": [(
        "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "  const float rest = x - __uint_as_float(hi);\n"
        "  lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;\n",
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        "  const float rest = x - __uint_as_float(hi);\n"
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));\n')],
    "rows32": [("constexpr int kBM = 64;", "constexpr int kBM = 32;"),
               ("constexpr int kThreads = 128;", "constexpr int kThreads = 64;"),
               ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 8)")],
    "unroll_full": [("#pragma unroll(kD == 64 ? 2 : kD / 8)", "#pragma unroll")],
}
#: name -> (B, T, H, D, between the block's linears, timed calls)
SHAPES = {
    "vit_s4": (32, 64, 3, 64, False, 200),
    "vit_s4_between_linears": (32, 64, 3, 64, True, 200),
    "t2048_d128": (4, 2048, 8, 128, False, 10),
    "t2048_d64": (4, 2048, 8, 64, False, 10),
}
TOL = 2e-5       # tests/test_ops.py's forward tolerance


def forward(lib, q, k, v) -> torch.Tensor:
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), device=q.device)
    lse = torch.empty((B, H, T), device=q.device)
    rc = lib.tpu_ddp_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                               out.data_ptr(), lse.data_ptr(), fa._strides(q, k, v, out),
                               B, T, H, D, 0, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"K4 launch: CUDA error {rc}")
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants needs a CUDA device")
    libs = variants.build(LIBRARY, VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": device_name(torch.device("cuda")), "us": {}, "max_abs_err": {}}
    for shape, (B, T, H, D, between, iters) in SHAPES.items():
        C = H * D
        x = torch.randn((B * T, C), generator=gen, device="cuda")
        w_qkv = torch.randn((3 * C, C), generator=gen, device="cuda") / C ** 0.5
        w_out = torch.randn((C, C), generator=gen, device="cuda") / C ** 0.5

        def qkv():
            return [t.reshape(B, T, H, D) for t in
                    F.linear(x, w_qkv).view(B, T, 3 * C).split(C, dim=-1)]

        q, k, v = qkv()
        want = fa.forward_plain(q, k, v)[0]
        calls = {}
        for name, lib in libs.items():
            err = float((forward(lib, q, k, v) - want).abs().max())
            result["max_abs_err"][name] = max(err, result["max_abs_err"].get(name, 0.0))
            if between:
                calls[name] = lambda lib=lib: F.linear(
                    forward(lib, *qkv()).reshape(B * T, C), w_out)
            else:
                calls[name] = lambda lib=lib: forward(lib, q, k, v)
        turns = list(libs) + list(libs)[::-1]
        us = {name: [] for name in libs}
        for name in turns:
            us[name].append(
                variants.kernel_us(calls[name], iters, ("flash_fwd",))["flash_fwd"])
        result["us"][shape] = us
        print(f"{shape}: " + "  ".join(f"{n} {u[0]:.3f}/{u[1]:.3f}" for n, u in us.items()),
              flush=True)
    bad = {n: e for n, e in result["max_abs_err"].items() if not e <= TOL}
    print(json.dumps(result), flush=True)
    if bad:
        raise SystemExit(f"variants beyond {TOL} of forward_plain: {bad}")
    return result


if __name__ == "__main__":
    main()
