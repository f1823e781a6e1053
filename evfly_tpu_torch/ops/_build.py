"""Build and load the port's CUDA kernels: one ``nvcc`` call, one ``.so``.

Every ``csrc/*.cu`` source has a plain C interface and includes no PyTorch
or CUTLASS header, so a cold build takes seconds.  The shared library goes to
``build/`` at the repository root (git-ignored), named by a sha256 of the
sources and the flags: a build whose hash matches is reused.  It is loaded
with ``ctypes``; every entry point returns ``cudaGetLastError()`` after its
launch, and ``check`` raises when that is not 0.

Nothing here runs when the module is imported: the first kernel launch (or
``build()``) compiles.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes does not cut a 64-bit address to a 32-bit int)
_SIGNATURES = {
    "evfly_hist_scaled_resized": (
        [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P]
    ),
    "evfly_lstm_stacked": [_P] * 9 + [_I] * 3 + [_P],
    "evfly_error_string": [_I],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: pathlib.Path
    seconds: float
    cache_hit: bool
    log: str


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


@functools.lru_cache(maxsize=1)
def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into ``build/libevfly_kernels_<hash>.so`` unless
    a library of the same hash is there already."""
    t0 = time.perf_counter()
    out = BUILD_DIR / f"libevfly_kernels_{source_hash()}.so"
    if out.exists():
        return BuildInfo(out, time.perf_counter() - t0, True, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return BuildInfo(out, time.perf_counter() - t0, False, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_char_p if name == "evfly_error_string" else ctypes.c_int
    return lib


def check(name: str, status: int) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if status != 0:
        text = library().evfly_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {text}")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
