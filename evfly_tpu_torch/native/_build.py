"""Build and load the port's host-side native libraries.

``evstream.cpp`` (the event accumulator), ``flightcore.cpp`` (the
flight-stack core) and ``evt3.cpp`` (the Prophesee EVT3 decoder) are copies
of the JAX package's sources in ``evfly_tpu/native/``.  Each builds with one ``g++ -O3 -fPIC -std=c++17
-shared`` into ``build/`` at the repository root (git-ignored), named by a
sha256 of the source and the flags, at its first use; a library whose hash
matches is reused.  A build writes to a name of its own and renames it into
place, so processes building at once never load a half-written file.
Nothing is written next to the sources, and nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBRARIES = ("evstream", "flightcore", "evt3")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native libraries build only where it is")
    return cxx


def library_path(name: str) -> pathlib.Path:
    """Where ``lib<name>`` of the current source and flags is built."""
    if name not in LIBRARIES:
        raise ValueError(f"unknown native library {name!r}; one of {LIBRARIES}")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``<name>.cpp`` unless its library is built; its path.
    Raises RuntimeError when the compiler fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """``lib<name>``, built at its first use in this process."""
    return ctypes.CDLL(str(build(name)))
