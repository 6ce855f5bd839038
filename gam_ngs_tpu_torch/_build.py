"""Build csrc/*.cu into one shared library at first use and load it.

nvcc compiles the sources (plain C entry points, no PyTorch headers, so
a build takes seconds) for sm_90a, one nvcc process per source, all
started together, then links the objects into one library in _build/,
under a name keyed by a hash of the sources and flags, so a stale
library is never loaded.  The library is loaded with ctypes; the ops
modules declare each entry point's argument types.  A missing nvcc or a
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of this process's build (ptxas -v lines)


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of gam_ngs_tpu_torch cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libgam_kernels_{h.hexdigest()[:16]}.so")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                build_log = _compile_and_link(tmp, so)
        _lib = ctypes.CDLL(so)
        return _lib


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Start every command, then wait for each: (exit code, output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return [(p.returncode, out) for p in procs
            for out in [p.communicate()[0]]]


def _compile_and_link(tmp: str, so: str) -> str:
    """One nvcc per source in parallel, one link; the library appears at
    `so` only once it is whole.  Returns nvcc's output."""
    nvcc = _nvcc()
    objs = [os.path.join(tmp, os.path.basename(src) + ".o")
            for src in sources()]
    res = _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                    for src, obj in zip(sources(), objs)])
    part = os.path.join(tmp, "lib.so")
    if all(rc == 0 for rc, _ in res):
        res += _run_all([[nvcc, "-shared", "-o", part, *objs]])
    log = "".join(out for _, out in res)
    bad = [rc for rc, _ in res if rc != 0]
    if bad:
        raise RuntimeError(f"nvcc failed (exit {bad[0]}):\n{log}")
    os.replace(part, so)
    return log
