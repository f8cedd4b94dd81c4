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
from typing import Callable, List, Optional

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


def stamped_build(lib_path: Path, digest: str, make: Callable[[str, str], None],
                  force: bool = False) -> Path:
    """Build ``lib_path`` with ``make(work_dir, out_path)`` unless a build
    stamped with ``digest`` (a SHA-256 of its sources and flags, kept beside
    it) exists. The library is made in a temporary directory and renamed
    into place, so a concurrent process never loads a half-written one."""
    stamp = lib_path.with_name(lib_path.name + ".sha256")
    if (not force and lib_path.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest):
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as work:
        tmp = os.path.join(work, lib_path.name)
        make(work, tmp)
        os.replace(tmp, lib_path)
    stamp.write_text(digest + "\n")
    return lib_path


def run_all(commands: List[List[str]]) -> None:
    """Run the commands at once; raise with the output of each that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    failed = []
    for cmd, proc in zip(commands, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(cmd[0])} failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(force: bool = False) -> Path:
    """Compile the sources into LIB_PATH unless an up-to-date build exists."""

    def make(work: str, out: str) -> None:
        nvcc = find_nvcc()
        cu_files = sorted(SRC_DIR.glob("*.cu"))
        objects = [os.path.join(work, p.stem + ".o") for p in cu_files]
        run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                 for obj, src in zip(objects, cu_files)])
        run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objects]])

    return stamped_build(LIB_PATH, source_hash(), make, force)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsjax_torch_lstm_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.dsjax_torch_lstm_fwd.restype = i
    lib.dsjax_torch_lstm_fwd_attributes.argtypes = [i, p]
    lib.dsjax_torch_lstm_fwd_attributes.restype = i
    lib.dsjax_torch_lstm_scan_attributes.argtypes = [i, i, i, p]
    lib.dsjax_torch_lstm_scan_attributes.restype = i
    lib.dsjax_torch_lstm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, p,
                                         p]
    lib.dsjax_torch_lstm_bwd.restype = i
    lib.dsjax_torch_lstm_bwd_clusters.argtypes = [p, p]
    lib.dsjax_torch_lstm_bwd_clusters.restype = i
    lib.dsjax_torch_lstm_bwd_attributes.argtypes = [i, i, i, i, p]
    lib.dsjax_torch_lstm_bwd_attributes.restype = i
    lib.dsjax_torch_gru_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.dsjax_torch_gru_fwd.restype = i
    lib.dsjax_torch_gru_fwd_attributes.argtypes = [i, p]
    lib.dsjax_torch_gru_fwd_attributes.restype = i
    lib.dsjax_torch_gru_scan_attributes.argtypes = [i, i, i, p]
    lib.dsjax_torch_gru_scan_attributes.restype = i
    lib.dsjax_torch_gru_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.dsjax_torch_gru_bwd.restype = i
    lib.dsjax_torch_gru_bwd_attributes.argtypes = [i, p]
    lib.dsjax_torch_gru_bwd_attributes.restype = i
    lib.dsjax_torch_mm_chain.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.dsjax_torch_mm_chain.restype = i
    lib.dsjax_torch_mm_chain_attributes.argtypes = [i, p]
    lib.dsjax_torch_mm_chain_attributes.restype = i
    lib.dsjax_torch_topk.argtypes = [p, p, p, i, i, i, p]
    lib.dsjax_torch_topk.restype = i
    lib.dsjax_torch_beam_scan.argtypes = [p] * 23 + [i] * 5 + [p]
    lib.dsjax_torch_beam_scan.restype = i
    lib.dsjax_torch_beam_backtrack.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.dsjax_torch_beam_backtrack.restype = i
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


def kernel_attributes(entry: str, is_bf16: bool, *args: int) -> dict:
    """A scan kernel's resources as built (needs the card), from the C entry
    point ``entry`` (given ``args`` after the dtype flag): registers a
    thread, static and dynamic shared memory a CTA, local memory (spills) a
    thread, and the hidden units a CTA owns (0 for the persistent kernels,
    whose shared memory and units are their plan's)."""
    lib = load_library()
    out = (ctypes.c_int * 5)()
    check(lib, getattr(lib, entry)(int(is_bf16), *args, out), entry)
    return dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                     "local_bytes", "units"), out))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.dsjax_torch_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
