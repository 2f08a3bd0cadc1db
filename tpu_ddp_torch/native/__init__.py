"""ctypes bindings of the port's native host data-path library.

Counterpart of ``tpu_ddp/native/__init__.py`` (``decode_normalize`` :133,
``gather_rows`` :157). The C++ sources here are the port's own copies
(``cifar_codec.cpp``, ``prefetcher.cpp``, ``parallel_for.h``) and
``blake2b.h``, which the JAX package has no counterpart of; the
prefetcher's C ABI differs from the JAX package's: its slot buffers are the
caller's, and it can digest the rows it gathers (``native/prefetch.py``).

The library is built with ``g++`` at first use, not at import, into
``build/tpu_ddp_torch/libcifar_codec-<hash>.so`` at the root of the
checkout (the directory of the CUDA kernels, ``ops/_build.py``), under a
lock file, so that ranks started together build it once. The hash covers
the sources, the header and the flags. Nothing falls back: where the JAX
package degrades to numpy and a Python thread when the build fails, here a
failed build raises with g++'s output, and ``available()`` only reports.

``gather_rows`` keeps the JAX package's dispatch: the native threaded copy
for float32 and int32 gathers of at least 1 MiB with indices in range,
numpy's fancy indexing for the rest (small copies, where the thread fan-out
costs more than the copy, other dtypes, and indices numpy must reject or
wrap). Both are exact copies, so the choice never changes a bit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from tpu_ddp_torch.ops._build import BUILD_DIR

HERE = Path(__file__).resolve().parent
SOURCES = ("cifar_codec.cpp", "prefetcher.cpp")
HEADERS = ("parallel_for.h", "blake2b.h")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 4

_P, _I, _LL, _ULL = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
#: C function -> (restype, argtypes)
FUNCTIONS = {
    "cifar_decode_normalize": (None, [_P, _P, _LL, _P, _P]),
    "gather_rows_f32": (None, [_P, _P, _P, _LL, _LL]),
    "gather_rows_i32": (None, [_P, _P, _P, _LL, _LL]),
    "bp_create": (_P, [_I, _P, _P, _P, _LL, _LL, _LL, _ULL]),
    "bp_submit": (_I, [_P, _P, _P, _P, _LL, _LL, _LL]),
    "bp_acquire": (_I, [_P]),
    "bp_release": (None, [_P, _I]),
    "bp_destroy": (None, [_P]),
    "cifar_codec_abi_version": (_I, []),
}

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(
        b"".join((HERE / f).read_bytes() for f in SOURCES + HEADERS)
        + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcifar_codec-{digest}.so"


def build() -> float:
    """Compile the library unless it is built; returns the seconds g++ took
    (0.0 when it was there). Raises with g++'s output when it fails."""
    import time

    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():           # another process built it while this waited
            return 0.0
        t0 = time.perf_counter()
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp),
               *(str(HERE / f) for f in SOURCES), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native data-path library build failed (g++ exit "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(str(library_path()))
        for fn, (restype, argtypes) in FUNCTIONS.items():
            getattr(handle, fn).restype = restype
            getattr(handle, fn).argtypes = argtypes
        if handle.cifar_codec_abi_version() != ABI_VERSION:
            raise RuntimeError("native data-path library: ABI version mismatch")
        _lib = handle
    return _lib


def available() -> bool:
    """Whether the library builds and loads (a report: nothing here falls
    back when it does not)."""
    try:
        lib()
    except (OSError, RuntimeError):
        return False
    return True


def decode_normalize(raw: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """(N, 3072) uint8 planar RGB -> (N, 32, 32, 3) float32,
    ``byte * (1 / (255 std)) - mean / std`` per channel, by the C++ codec."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.shape[0]
    if raw.ndim != 2 or raw.shape[1] != 3072:
        raise ValueError(f"expected (N, 3072) uint8 records, got {raw.shape}")
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    out = np.empty((n, 32, 32, 3), np.float32)
    lib().cifar_decode_normalize(raw.ctypes.data, out.ctypes.data, n,
                                 mean32.ctypes.data, std32.ctypes.data)
    return out


#: below this, the per-call std::thread fan-out costs more than the copy
NATIVE_GATHER_MIN_BYTES = 1 << 20


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``dst[j] = src[idx[j]]`` along axis 0 (module docstring)."""
    idx64 = np.ascontiguousarray(idx, np.int64)
    if (src.dtype in (np.float32, np.int32) and src.flags.c_contiguous
            and idx64.size > 0 and int(idx64.min()) >= 0
            and int(idx64.max()) < len(src)):
        row_elems = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
        if idx64.size * row_elems * src.itemsize >= NATIVE_GATHER_MIN_BYTES:
            out = np.empty((len(idx64),) + src.shape[1:], src.dtype)
            fn = lib().gather_rows_f32 if src.dtype == np.float32 else lib().gather_rows_i32
            fn(src.ctypes.data, idx64.ctypes.data, out.ctypes.data, len(idx64), row_elems)
            return out
    return src[idx64]
