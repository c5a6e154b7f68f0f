"""Build and load the port's CUDA kernels.

Each source in ``repro_torch/csrc/`` compiles with ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <lib> <source>

Libraries are built at first use (or all at once, in parallel, by
:func:`build_all`) into ``repro_torch/build/``, which ``.gitignore``
lists; the file name carries a digest of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source never loads a stale
build.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("crossbar_mac", "paged_attention", "deepnet_stream", "ir_solve")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register / shared-memory report) per library
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """The ``nvcc`` of ``$CUDA_HOME``, else of ``/usr/local/cuda``, else
    the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.blake2b(digest_size=6)
    for src in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def _start(name: str) -> Tuple[Path, subprocess.Popen]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return tmp, proc


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no current build, one ``nvcc``
    per source, all started together; returns seconds per build (0.0
    for a library that was already built).  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    secs = {}
    t0 = time.perf_counter()
    for name in names:
        if library_path(name).exists():
            secs[name] = 0.0
        else:
            started[name] = _start(name)
    failed = []
    for name, (tmp, proc) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
