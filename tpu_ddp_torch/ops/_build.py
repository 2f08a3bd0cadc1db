"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``csrc/`` becomes ``build/tpu_ddp_torch/lib<name>-<hash>.so``
at the root of the checkout (a directory ``.gitignore`` lists) at first use;
the hash covers the source, the headers of ``csrc/`` (``*.cuh``) and the
flags that library is built with, so an edited source or header or a
changed flag is rebuilt. ``build`` starts one ``nvcc``
per missing library, all at once, and waits for them. It holds a lock file
in the build directory while it does, so that processes started together
(the ranks of one job) build each library once and never write the same
file at once. Nothing is built when
a module is imported, and nothing here falls back: a failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_ddp_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ERR = {"tpu_ddp_cuda_error_string": (ctypes.c_char_p, [_I])}

#: library name -> (source file, extra nvcc flags,
#:                  {C function: (restype, argtypes)})
LIBRARIES = {
    # -fmad=false: K1 rounds every product as its plain version does
    "fused_update": ("fused_update.cu", ("-fmad=false",), {
        "tpu_ddp_fused_update": (
            _I, [_P, _I, _I, _P] + [_I] * 5 + [_F] * 11 + [_P]),
        **_ERR,
    }),
    # K4, held to a tolerance: nvcc's default contraction into FMAs; its
    # float32 kernel's __launch_bounds__ hold it to 128 registers a thread,
    # its bfloat16 kernel's (256 threads: TMA, mbarriers, wgmma) to 255.
    # The TMA tensor maps are encoded through the runtime's
    # driver entry point (hopper.cuh), so no library or link flag is added.
    "flash_forward": ("flash_forward.cu", (), {
        "tpu_ddp_flash_fwd": (_I, [_P] * 7 + [_I] * 5 + [_P]),
        "tpu_ddp_flash_fwd_info": (_I, [_I, _P]),
        "tpu_ddp_flash_fwd_bf16": (_I, [_P] * 7 + [_I] * 5 + [_P]),
        "tpu_ddp_flash_fwd_info_bf16": (_I, [_I, _P]),
        **_ERR,
    }),
    # K5 and K6, held to a tolerance: nvcc's default contraction into FMAs;
    # their __launch_bounds__ (128 threads, two blocks an SM; their bfloat16
    # kernels, on TMA and wgmma as K4's, 256 threads, one) allow up to 255
    # registers a thread
    "flash_attention": ("flash_attention.cu", (), {
        "tpu_ddp_flash_dq": (_I, [_P] * 9 + [_I] * 5 + [_P]),
        "tpu_ddp_flash_dkv": (_I, [_P] * 10 + [_I] * 5 + [_P]),
        "tpu_ddp_flash_bwd_info": (_I, [_I, _I, _P]),
        "tpu_ddp_flash_dq_bf16": (_I, [_P] * 9 + [_I] * 5 + [_P]),
        "tpu_ddp_flash_dkv_bf16": (_I, [_P] * 10 + [_I] * 5 + [_P]),
        "tpu_ddp_flash_bwd_info_bf16": (_I, [_I, _I, _P]),
        **_ERR,
    }),
    # -fmad=false: K2's error and K3 round q * scale and then the
    # difference or the sum apart, as their plain versions do
    "fused_quant": ("fused_quant.cu", ("-fmad=false",), {
        "tpu_ddp_fused_quant": (_I, [_P, _P, _I] + [_LL] * 4 + [_P] * 4),
        "tpu_ddp_fused_dequant": (
            _I, [_P, _P, _LL, _I, _P, _I] + [_LL] * 3 + [_P, _LL, _P, _LL, _I, _P]),
        **_ERR,
    }),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use"
    )


def flags(name: str) -> tuple:
    """The nvcc flags ``name`` is built with."""
    return NVCC_FLAGS + LIBRARIES[name][1]


def library_path(name: str) -> Path:
    source = LIBRARIES[name][0]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + headers + " ".join(flags(name)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named library that is not built yet, all in parallel,
    under the build directory's lock. Returns seconds per library compiled
    (empty when all were built)."""
    names = list(LIBRARIES if names is None else names)
    if all(library_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # another process may have built them while this one waited
        return _compile([n for n in names if not library_path(n).exists()])


def _compile(todo) -> Dict[str, float]:
    if not todo:
        return {}
    compiler = nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(out.with_suffix(".log"), "w")
        cmd = [compiler, *flags(name), "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in LIBRARIES[name][2].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.tpu_ddp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
