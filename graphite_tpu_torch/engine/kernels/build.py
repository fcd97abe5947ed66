"""Build the CUDA sources with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own into ``build/kernels/<name>-<hash>.so`` under the repository
root (the hash covers the source and the flags, so an edited kernel never
loads a stale library).  :func:`build_all` starts one nvcc per source at
once.  ``-Xptxas -v`` output (registers, spills) is kept beside each
library as ``.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("window_walk", "chain_classify", "fast_forward_walk")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time, "ptxas": [lines], "path": str}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def build_all(names: List[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no current library, one nvcc
    process each, all started together.  Raises on a failed build."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for name, job in jobs.items():
        if job is None:
            log = _target(name).with_suffix(".ptxas.txt")
            BUILD_INFO.setdefault(name, {
                "seconds": 0.0, "path": str(_target(name)),
                "ptxas": log.read_text().splitlines() if log.exists()
                else []})
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
        os.replace(tmp, out)
        out.with_suffix(".ptxas.txt").write_text(text)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "path": str(out),
                            "ptxas": text.splitlines()}
    return {n: BUILD_INFO[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(BUILD_INFO[name]["path"])
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.kernel_error_string(err).decode()
