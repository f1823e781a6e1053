"""Build and load the port's CUDA kernels: one ``nvcc`` per source, all
started together, linked into one ``.so``.

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
_L = ctypes.c_longlong
# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes does not cut a 64-bit address to a 32-bit int)
_SIGNATURES = {
    "evfly_hist_frame": [_P] * 6 + [_I] * 5 + [_F, _F, _I, _P],
    "evfly_scale_counts": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
    "evfly_hist_frame_cluster": [_P] * 4 + [_I] * 5 + [_F, _F, _I, _P],
    "evfly_hist_frame_windows": [_P] * 10 + [_I, _L] + [_I] * 3 + [_F, _F, _I, _P],
    "evfly_hist_frame_cluster_windows": [_P] * 6 + [_I] * 4 + [_F, _F, _I, _P],
    "evfly_hist_scaled_cluster": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
    "evfly_hist_scaled_resized_cluster": [_P] * 6 + [_I] * 8 + [_F, _I, _P],
    "evfly_hist_frame_cluster_fits": [_I] * 4,
    "evfly_hist_frame_route": [_I] * 3,
    "evfly_hist_band_cells": [_I] * 3,
    "evfly_hist_scaled_cluster_cap": [_I] * 3,
    "evfly_hist_resized_cluster_cap": [_I] * 5,
    "evfly_hist_cluster_occupancy": [_I] * 7 + [_P],
    "evfly_empty": [_I, _P],
    "evfly_lstm_stacked": [_P] * 9 + [_I] * 4 + [_P],
    "evfly_lstm_wavefront": [_P] * 9 + [_I] * 4 + [_P],
    "evfly_lstm_cluster": [_P] * 8 + [_I] * 5 + [_P],
    "evfly_lstm_cluster_occupancy": [_I] * 3 + [_P],
    "evfly_lstm_cluster_fits": [_I, _I],
    "evfly_lstm_grid": [_P] * 10 + [_I] * 5 + [_P],
    "evfly_lstm_grid_occupancy": [_I] * 3 + [_P],
    "evfly_lstm_grid_fits": [_I, _I],
    "evfly_lstm_route": [_I, _I],
    "evfly_dwconv3x3_gelu": [_P] * 4 + [_I] * 7 + [_P],
    "evfly_sepconvgru_conv": [_I, _I] + [_P] * 8 + [_I] * 11 + [_P],
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


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def source_hash(defines=()) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_flags(defines)).encode())
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


@functools.lru_cache(maxsize=2)
def build(defines=()) -> BuildInfo:
    """Compile ``csrc/*.cu`` into ``build/libevfly_kernels_<hash>.so`` unless
    a library of the same hash is there already.  ``defines``: macros for a
    probe's build (e.g. ``("EVFLY_PHASE_STAMPS",)``), part of the hash."""
    t0 = time.perf_counter()
    out = BUILD_DIR / f"libevfly_kernels_{source_hash(defines)}.so"
    if out.exists():
        return BuildInfo(out, time.perf_counter() - t0, True, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    # one nvcc per source, all at once, then one link
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    compile_flags = [f for f in _flags(defines) if f != "-shared"]
    cmds = [[_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objects)]
    cmds.append([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds[:-1]]
    logs = []
    try:
        for cmd, proc in zip(cmds, procs):
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{logs[-1]}")
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed ({link.returncode}): {' '.join(cmds[-1])}\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return BuildInfo(out, time.perf_counter() - t0, False, "".join(logs))


@functools.lru_cache(maxsize=2)
def library(defines=()) -> ctypes.CDLL:
    """The kernels' library (built with ``defines``), entry points typed."""
    lib = ctypes.CDLL(str(build(defines).path))
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
