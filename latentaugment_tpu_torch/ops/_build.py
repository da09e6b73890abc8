"""Build helpers for the hand-written kernels.

Everything a kernel build writes goes under `<repo>/build/` (listed in
.gitignore): the nvcc-built shared libraries and Triton's compile cache.
Nothing here runs at import time; the first launch on a CUDA tensor
builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

_LIBS = {}
_LOAD_LOCK = threading.Lock()  # threads' first launches build a library once


def set_triton_cache_dir():
    """Keep Triton's on-disk cache inside the checkout (it defaults to
    $HOME/.triton). Call before the first `import triton`."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return path


def _library_path(source):
    """(source path, library path): the library is named by the content
    of every file under csrc/ (the sources share headers), so an edited
    source or header is rebuilt."""
    src = os.path.join(CSRC_DIR, source)
    digest = hashlib.sha256()
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read() + b"\0")
    out_dir = os.path.join(BUILD_DIR, "kernels")
    os.makedirs(out_dir, exist_ok=True)
    return src, os.path.join(
        out_dir, f"{os.path.splitext(source)[0]}-{digest.hexdigest()[:16]}.so")


def build_cuda_libraries(sources, resource_usage=False):
    """Compile each `csrc/<source>` for sm_90a into a shared library with a
    plain C interface, one nvcc per source, all running at once; skips
    those already built. Returns the compilers' messages by source; with
    `resource_usage` they hold ptxas' registers, spills and shared memory
    per kernel (-Xptxas -v)."""
    jobs = []
    for source in sources:
        src, lib_path = _library_path(source)
        if os.path.isfile(lib_path):
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
        if resource_usage:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, src]
        jobs.append((source, src, lib_path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, messages = [], {}
    for source, src, lib_path, tmp, proc in jobs:
        out, err = proc.communicate()
        messages[source] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {src}:\n{out}\n{err}")
        else:
            os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return messages


def load_cuda_library(source):
    """Build `csrc/<source>` if needed (build_cuda_libraries) and load it
    with ctypes, once per process."""
    if source in _LIBS:
        return _LIBS[source]
    with _LOAD_LOCK:
        if source not in _LIBS:
            build_cuda_libraries([source])
            _LIBS[source] = ctypes.CDLL(_library_path(source)[1])
    return _LIBS[source]
