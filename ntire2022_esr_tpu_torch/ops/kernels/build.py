"""Build and load the hand-written CUDA kernels (``ntire2022_esr_tpu_torch/csrc``),
and the host C helpers beside them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``build/kernels/`` at the repository root (listed in ``.gitignore``),
and loaded with ``ctypes``. A library's file name carries a hash of its
sources, so an edited kernel is rebuilt. ``build()`` starts one ``nvcc``
per missing library, all at once. Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on it.

A host helper ``csrc/<name>.c`` (:func:`load_host`) is compiled the same
way with the host C compiler (``cc -O3 -shared -fPIC``); a failed build
raises.

Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
SOURCES = ("conv_chain", "tail")
HEADERS = ("common.cuh", "mma_stage.cuh")  # every library is rebuilt when one changes
MAX_SMEM = 232448  # dynamic shared memory one block may opt into on sm_90
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_CFLAGS = ("-std=c99", "-O3", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()  # a decode thread and the main thread may both ask


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def host_cc() -> str:
    for cand in ("cc", "gcc"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C compiler (cc or gcc) on PATH: the host helpers in "
                       "ntire2022_esr_tpu_torch/csrc/*.c build with it")


def _lib_path(name: str, sources=None, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256()
    for f in sources or (f"{name}.cu", *HEADERS):
        with open(os.path.join(SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, str]:
    """Compile the named libraries that are not built yet, one ``nvcc``
    each, all started together. Returns each name's compiler output
    (``-Xptxas -v`` register and shared-memory report when ``verbose``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path) and not verbose:
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        lib.esr_error_string.argtypes = [ctypes.c_int]
        lib.esr_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/<name>.c``, compiled first if needed.
    A failed build raises with the compiler's output."""
    with _host_lock:
        lib = _libs.get(name)
        if lib is None:
            src = f"{name}.c"
            path = _lib_path(name, (src,), HOST_CFLAGS)
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                proc = subprocess.run([host_cc(), *HOST_CFLAGS, "-o", tmp,
                                       os.path.join(SRC_DIR, src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"the host C compiler failed for {src}:\n{proc.stdout}")
                os.replace(tmp, path)
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: {lib.esr_error_string(rc).decode()}")


def dtype_code(dtype: torch.dtype) -> int:
    codes = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
    if dtype not in codes:
        raise TypeError(f"the kernels take float32, float16 or bfloat16 activations, not {dtype}")
    return codes[dtype]

