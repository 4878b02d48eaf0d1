"""Build the CUDA sources under ``nonode_tpu_torch/csrc/`` and load them.

Each source is compiled by ``nvcc`` into a plain shared library with a C
interface and loaded with ctypes. Libraries are named by a hash of their
source, the shared headers (``csrc/*.cuh``) and the flags, in
``nonode_tpu_torch/_build/`` (git-ignored), so a source is rebuilt only when
it or a header changes. Nothing is built when a module is imported:
the first launch builds, or a caller builds every source at once
(``build_all``), one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
# --split-compile=0: the optimizer and ptxas split each source's kernels
# over the CPUs (the two widths of #1/#2 build side by side)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}   # source -> nvcc's stderr (ptxas register report)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_all(sources) -> float:
    """Compile every source not built yet, in parallel. Returns the wall
    seconds. Raises with nvcc's stderr when a build fails."""
    t0 = time.perf_counter()
    todo = [s for s in dict.fromkeys(sources) if not library_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        BUILD_LOGS[src] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          f"{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _LIBS.get(source)
    if lib is None:
        build_all([source])
        lib = ctypes.CDLL(str(library_path(source)))
        _LIBS[source] = lib
    return lib
