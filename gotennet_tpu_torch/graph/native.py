"""Radius graph of one molecule on the host through the package's C++ cell
list (``csrc/neighborlist.cpp``), bound with ctypes.

Counterpart of ``gotennet_tpu/graph/native.py``, with its own copy of the
source.  The source is compiled with ``g++`` into ``build/`` at the
repository root at first use; the library's name carries the hash of the
source and the flags, so an edit rebuilds it and concurrent processes never
load half a file (each writes a temporary name and renames it into place).
Unlike the JAX package's binding, nothing falls back to numpy: a failed
build or load raises, since the numpy version is some 100x slower at 4,000
atoms.  ``build_edges_np`` (``graph/neighborlist.py``) stays the plain
version the tests hold this one against; both give the same arrays in the
same order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["build_library", "build_edges_native", "build_edges"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "neighborlist.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# no -march=native: the library may be copied to another host; no FMA
# contraction: every product is rounded, as numpy rounds it
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
CXX = "g++"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libneighborlist-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``csrc/neighborlist.cpp`` unless an up-to-date library is
    there; returns its path.  Raises ``RuntimeError`` when it cannot."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the host neighbour list "
                           f"({SOURCE.name}) is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = build_library()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading {path} failed: {e}") from e
            fn = lib.build_radius_graph
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                           ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64]
            _lib = lib
        return _lib


def build_edges_native(pos: np.ndarray, cutoff: float, loop: bool = True,
                       max_num_neighbors: int = 32
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """``(src, dst)`` int32 edges of one molecule, the same arrays as
    ``build_edges_np(pos, cutoff, loop, max_num_neighbors)``: dst-sorted,
    sources within ``cutoff`` (the nearest ``max_num_neighbors`` when
    more, then in index order), and with ``loop`` each node's self-loop
    last.  Positions are taken as float32."""
    pos = np.ascontiguousarray(pos, np.float32)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be [n, 3], got {pos.shape}")
    if max_num_neighbors < 0:
        raise ValueError("max_num_neighbors must be >= 0")
    lib = _load()
    n = pos.shape[0]
    cap = n * (max_num_neighbors + (1 if loop else 0))
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    e = lib.build_radius_graph(pos.ctypes.data, n, cutoff, max_num_neighbors,
                               int(loop), src.ctypes.data, dst.ctypes.data,
                               cap)
    if e < 0:
        raise RuntimeError("neighbour list overflowed its buffer")
    return src[:e].copy(), dst[:e].copy()


# what the loaders call
build_edges = build_edges_native
