"""Build and load the port's CUDA kernels.

`nvcc` compiles `compare_gan_torch/csrc/attention.cu` for sm_90a into one
shared library with a plain C interface, which is loaded with ctypes. The
source is compiled once per padded C (`-DCGT_CP=16, 32, 48, 64`: the
kernels at that width), once for C > 64 (`-DCGT_WIDE`: the kernels that
loop over chunks of 64) and once without (the entry points), by as many
`nvcc` processes started together, and the objects are linked. The build
runs at first use (never at import), from the checkout's sources only, into
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
SOURCE = os.path.join(SRC_DIR, "attention.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# One object of the kernels per padded C (csrc/attention.cu's CP), one of
# the kernels at C > 64, and the entry object (no define).
PARTS = ((), ("-DCGT_CP=16",), ("-DCGT_CP=32",), ("-DCGT_CP=48",),
         ("-DCGT_CP=64",), ("-DCGT_WIDE",))

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
    h.update(repr(PARTS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcgt_kernels-{h.hexdigest()[:16]}.so")


def compile_library(source: str, out: str) -> str:
    """Compile `source` into the shared library `out`: one `nvcc -c` per
    entry of PARTS, all running at once, then one link. Returns nvcc's
    output (ptxas's register and spill report); raises if a step fails."""
    objs = [f"{out}.part{i}.o" for i in range(len(PARTS))]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc_path(), *FLAGS, *defines, "-c", "-o", obj,
                          source] for defines, obj in zip(PARTS, objs))]
    logs, failed = [], []
    for cmd, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (rc {proc.returncode})")
    if not failed:
        cmd = [nvcc_path(), "-shared", "-o", out, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (rc {proc.returncode})")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n" + log)
    return log


def build() -> str:
    """Compile the kernels unless an up-to-date library exists; return its
    path. Concurrent builders each write private temporary files and
    rename the library into place."""
    global build_log
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    build_log = compile_library(SOURCE, tmp)
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _lib = bind(lib)
        return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and return types on `lib`."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cgt_attention_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.cgt_attention_fwd.restype = i32
    lib.cgt_attention_bwd.argtypes = [ptr] * 12 + [i32] * 7 + [ptr]
    lib.cgt_attention_bwd.restype = i32
    lib.cgt_error_string.argtypes = [i32]
    lib.cgt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.cgt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}).")
