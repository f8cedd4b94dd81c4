"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``dsjax_torch/csrc/*.cu`` file compiles, one nvcc process per file and
all at once, into an object; the objects link into one shared library with a
plain C interface, ``build/dsjax_torch/libdsjax_torch.so`` under the
checkout's root. Nothing here includes PyTorch's headers, so a build takes
seconds rather than minutes. The library is built at first use and rebuilt
only when the sources (``*.cu`` and the ``*.cuh`` they include) or the flags
change (a SHA-256 of both is kept beside it). Importing this module builds
and loads nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
# build/ beside the package assumes a checkout: an installed package would
# put it in site-packages
BUILD_DIR = PACKAGE_DIR.parent / "build" / "dsjax_torch"
LIB_PATH = BUILD_DIR / "libdsjax_torch.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                       "build dsjax_torch's CUDA kernels")


def build(force: bool = False) -> Path:
    """Compile the sources into LIB_PATH unless an up-to-date build exists."""
    digest = source_hash()
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if (not force and LIB_PATH.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        cu_files = sorted(SRC_DIR.glob("*.cu"))
        objects = [os.path.join(work, p.stem + ".o") for p in cu_files]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for obj, src in zip(objects, cu_files)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in compiles]
        failed = []
        for cmd, proc in zip(compiles, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        # link beside the target, then rename: a concurrent process never
        # loads a half-written library
        tmp = os.path.join(work, LIB_PATH.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    stamp.write_text(digest + "\n")
    return LIB_PATH


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsjax_torch_lstm_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.dsjax_torch_lstm_fwd.restype = i
    lib.dsjax_torch_lstm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.dsjax_torch_lstm_bwd.restype = i
    lib.dsjax_torch_topk.argtypes = [p, p, p, i, i, i, p]
    lib.dsjax_torch_topk.restype = i
    lib.dsjax_torch_beam_scan.argtypes = [p] * 23 + [i] * 5 + [p]
    lib.dsjax_torch_beam_scan.restype = i
    lib.dsjax_torch_error_string.argtypes = [i]
    lib.dsjax_torch_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.dsjax_torch_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
