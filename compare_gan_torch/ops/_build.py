"""Build and load the port's CUDA kernels.

`nvcc` compiles `compare_gan_torch/csrc/*.cu` for sm_90a into one shared
library with a plain C interface, which is loaded with ctypes. The build runs
at first use (never at import), from the checkout's sources only, into
`compare_gan_torch/_build/` (git-ignored). The library's file name carries a
hash of the sources and flags, so an edited source is never served by a stale
build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SOURCES = ("attention.cu",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the build.


def nvcc_path() -> str:
    for candidate in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                                   "nvcc"),
                      "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built.")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcgt_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless an up-to-date library exists; return its
    path. Concurrent builders each write a private temporary file and
    rename it into place."""
    global build_log
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *FLAGS, "-o", tmp,
           *(os.path.join(SRC_DIR, s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.cgt_attention_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
            lib.cgt_attention_fwd.restype = i32
            lib.cgt_attention_bwd.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
            lib.cgt_attention_bwd.restype = i32
            lib.cgt_error_string.argtypes = [i32]
            lib.cgt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.cgt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}).")
