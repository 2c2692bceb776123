"""Build and load the port's CUDA kernels.

Each kernel module keeps one CUDA C++ source under ``csrc/`` with a plain C
interface.  :func:`build` compiles it with ``nvcc`` for ``sm_90a`` into
``build/`` beside the module, as a shared library whose name carries a hash
of the source, unless that library exists already.  :func:`load` opens it
with ``ctypes`` once per process.  Builds of different sources may run in
parallel threads: each writes a temporary file of its own and renames it
into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_loaded: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def build(source: Path, build_dir: Path, name: str) -> tuple[Path, str]:
    """Compile ``source`` for sm_90a unless a library built from the same
    source exists.  Returns ``(library path, nvcc log)``; the log holds
    ``ptxas -v``'s register and spill report (empty when the library was
    already built)."""
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    out = build_dir / f"lib{name}_{tag}.so"
    if out.exists():
        return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: the {name} kernels are built "
                           f"from source on the machine with the card")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stderr


def load(source: Path, build_dir: Path, name: str) -> ctypes.CDLL:
    """The library built from ``source``, built on first use and opened
    once per process."""
    path, _ = build(source, build_dir, name)
    with _lock:
        if path not in _loaded:
            _loaded[path] = ctypes.CDLL(str(path))
        return _loaded[path]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (0 = launched).  The
    library's ``kernel_error_string(int)`` names the error."""
    if rc != 0:
        fn = lib.kernel_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what} launch failed: {fn(rc).decode()}")
