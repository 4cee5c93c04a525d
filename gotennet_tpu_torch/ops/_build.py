"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.  The
build goes to ``build/`` at the repository root at first use and is
reused while the source, the headers of ``csrc/`` and the flags are
unchanged (the file name carries their hash).  Nothing here runs at
import time.

Every entry point ``gotennet_<name>`` takes its tensors' pointers, a
workspace of the size ``gotennet_<name>_workspace`` asks for, its integers
and the stream, and returns a CUDA error code: ``call_entry`` makes that
call, ``launch`` makes it on the current stream of the tensors' device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["build_all", "load_library", "build_log", "SOURCES", "aligned",
           "call_entry", "launch"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("fused_gata_fwd.cu", "fused_gata_bwd.cu", "fused_htr_fwd.cu",
           "fused_htr_bwd.cu", "fused_ell_fwd.cu", "fused_ell_bwd.cu",
           "fused_htr_ell_fwd.cu", "fused_htr_ell_bwd.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources=SOURCES) -> List[Path]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = [_target(s) for s in sources]
    procs = []
    for src, out in zip(sources, targets):
        if out.exists():
            continue
        # per-process names: several processes may build at once
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(f".{os.getpid()}.log"), "w")
        procs.append((subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log))
    failed = []
    for proc, tmp, out, log in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            # atomic: readers never see half a file
            os.replace(log.name, out.with_suffix(".log"))
            os.replace(tmp, out)
        else:
            failed.append(f"{out.name}: nvcc exit {rc}\n"
                          + Path(log.name).read_text())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(source: str = SOURCES[0]) -> str:
    """nvcc's output (with the ``-Xptxas -v`` register/shared-memory
    summary) from the build of ``source``."""
    return _target(source).with_suffix(".log").read_text()


def _declare(lib: ctypes.CDLL, source: str = SOURCES[0]) -> None:
    """Argument and result types of the C functions of ``source``."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if source == "fused_gata_fwd.cu":
        fn = lib.gotennet_fused_gata_fwd
        fn.argtypes = [ptr] * 17 + [i32] * 11 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_gata_fwd_workspace
        fn.argtypes = [i32] * 7
        fn.restype = i64
    elif source == "fused_gata_bwd.cu":
        fn = lib.gotennet_fused_gata_bwd
        fn.argtypes = [ptr] * 30 + [i32] * 11 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_gata_bwd_workspace
        fn.argtypes = [i32] * 7
        fn.restype = i64
    elif source == "fused_htr_fwd.cu":
        fn = lib.gotennet_fused_htr_fwd
        fn.argtypes = [ptr] * 8 + [i32] * 10 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_htr_fwd_workspace
        fn.argtypes = [i32] * 4
        fn.restype = i64
    elif source == "fused_htr_bwd.cu":
        fn = lib.gotennet_fused_htr_bwd
        fn.argtypes = [ptr] * 14 + [i32] * 10 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_htr_bwd_workspace
        fn.argtypes = [i32] * 3
        fn.restype = i64
    elif source == "fused_ell_fwd.cu":
        fn = lib.gotennet_fused_ell_fwd
        fn.argtypes = [ptr] * 18 + [i32] * 12 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_ell_fwd_workspace
        fn.argtypes = [i32] * 8
        fn.restype = i64
    elif source == "fused_ell_bwd.cu":
        fn = lib.gotennet_fused_ell_bwd
        fn.argtypes = [ptr] * 33 + [i32] * 12 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_ell_bwd_workspace
        fn.argtypes = [i32] * 7
        fn.restype = i64
    elif source == "fused_htr_ell_fwd.cu":
        fn = lib.gotennet_fused_htr_ell_fwd
        fn.argtypes = [ptr] * 9 + [i32] * 11 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_htr_ell_fwd_workspace
        fn.argtypes = [i32] * 4
        fn.restype = i64
    elif source == "fused_htr_ell_bwd.cu":
        fn = lib.gotennet_fused_htr_ell_bwd
        fn.argtypes = [ptr] * 17 + [i32] * 11 + [ptr]
        fn.restype = i32
        fn = lib.gotennet_fused_htr_ell_bwd_workspace
        fn.argtypes = [i32] * 3
        fn.restype = i64
    else:
        raise ValueError(f"no C interface declared for {source}")
    lib.gotennet_cuda_error_string.argtypes = [i32]
    lib.gotennet_cuda_error_string.restype = ctypes.c_char_p


def load_library(source: str = SOURCES[0]) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        if source not in _libs:
            path, = build_all((source,))
            lib = ctypes.CDLL(str(path))
            _declare(lib, source)
            _libs[source] = lib
        return _libs[source]


def aligned(a: torch.Tensor) -> torch.Tensor:
    """``a``, or a copy of it when its data do not start on a 16-byte
    boundary (a view with an offset): the kernels load 16 bytes at a time."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.gotennet_cuda_error_string(err).decode()})")


def call_entry(lib, name: str, stream, sizes: Sequence[int],
               tensors: Sequence[Optional[torch.Tensor]],
               ints: Sequence[int]) -> None:
    """``gotennet_<name>`` of ``lib`` on ``stream``: asks
    ``gotennet_<name>_workspace(*sizes)`` for its bytes, allocates them on
    the first tensor's device, passes the tensors' pointers (None for a
    None), the workspace's, ``ints`` and the stream, and raises on the CUDA
    error it returns.  Arguments are validated by the caller."""
    n_bytes = getattr(lib, f"gotennet_{name}_workspace")(*sizes)
    work = torch.empty((n_bytes + 3) // 4, dtype=torch.float32,
                       device=tensors[0].device)
    err = getattr(lib, f"gotennet_{name}")(
        *(a.data_ptr() if a is not None else None for a in tensors),
        work.data_ptr(), *ints, stream)
    _raise_on(lib, err, name)


def launch(source: str, call: Callable, *args, **kw) -> None:
    """``call(lib, stream, *args, **kw)`` with the library of ``source`` on
    the current stream of the first argument's device, that device
    current."""
    device = args[0].device
    with torch.cuda.device(device):
        call(load_library(source),
             torch.cuda.current_stream(device).cuda_stream, *args, **kw)
