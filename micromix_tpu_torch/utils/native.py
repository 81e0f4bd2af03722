"""ctypes bindings for the port's native host libraries.

Counterpart of ``micromix_tpu/utils/native.py``.  The port keeps its own
copies of the C++ sources in ``micromix_tpu_torch/csrc/host/``:
``mxpack.cpp`` (the multithreaded load-time weight quantizers) and
``kvpool.cpp`` (the engine's page pool, ``serve/block_manager.py``).  Each
is built at first use with ``g++ -O3 -std=c++17 -fPIC -shared -pthread``
into ``build/host/`` at the repository root (listed in ``.gitignore``),
named by a hash of its source and flags, and loaded with ctypes.

``quantize_mixed_host`` and ``quantize_scaledw8_host`` take and return
numpy arrays, with the JAX package's signatures and results.  Where the
JAX package falls back to its NumPy oracle without a compiler, the port
raises: a library that does not build is an error.
``quantize_scaledw8_host`` returning None for a layout that does not fit
ScaledW8 (exponent span or base out of range) is the function's own
result, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

HOST_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++) found: the port's host "
                       "libraries (csrc/host/*.cpp) need one")


def _target(name: str) -> Path:
    src = (HOST_SRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return HOST_BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/host/<name>.cpp``; raises RuntimeError
    if it does not build or load."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        target = _target(name)
        if not target.exists():
            HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            p = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                                str(HOST_SRC / f"{name}.cpp")],
                               capture_output=True, text=True, timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"building {name}.cpp failed:\n{p.stderr}")
            os.replace(tmp, target)
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            raise RuntimeError(f"loading {target} failed: {e}") from e
        _libs[name] = lib
        return lib


def _mxpack() -> ctypes.CDLL:
    lib = host_library("mxpack")
    i64, u8p, f32p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                      ctypes.POINTER(ctypes.c_float))
    lib.mx_quantize_mixed.argtypes = [f32p, i64, i64, i64, i64, ctypes.c_int,
                                      u8p, u8p, u8p, u8p, u8p, u8p, ctypes.c_int]
    lib.mx_quantize_mixed.restype = None
    lib.mx_quantize_scaledw8.argtypes = [f32p, i64, i64, i64, i64, u8p,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int]
    lib.mx_quantize_scaledw8.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    """Whether the host quantizers build and load here."""
    try:
        _mxpack()
    except RuntimeError:
        return False
    return True


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _threads(n_threads: Optional[int]) -> int:
    return n_threads or (os.cpu_count() or 1)


def quantize_scaledw8_host(x: np.ndarray, k4: int, k6: int, k8: int, *,
                           n_threads: Optional[int] = None):
    """Fused quantize + ScaledW8 pack of a (rows, K) f32 weight on the host
    (the all-MXFP4 weight grid).  -> (codes (rows, K) u8, base int), or
    None when the layout does not fit ScaledW8 (exponent span over 62 or
    base above 1)."""
    lib = _mxpack()
    x = np.ascontiguousarray(x, np.float32)
    rows, k = x.shape
    if k != k4 + k6 + k8:
        raise ValueError(f"K {k} != {k4} + {k6} + {k8}")
    codes = np.empty((rows, k), np.uint8)
    base = ctypes.c_int32(0)
    rc = lib.mx_quantize_scaledw8(_f32(x), rows, k4, k6, k8, _u8(codes),
                                  ctypes.byref(base), _threads(n_threads))
    if rc != 0:
        return None
    return codes, int(base.value)


def quantize_mixed_host(x: np.ndarray, k4: int, k6: int, k8: int, *,
                        weight_fp4_only: bool = False,
                        n_threads: Optional[int] = None) -> Dict[str, np.ndarray]:
    """NumPy (rows, K) f32 -> dict(fp4 (split-plane packed), fp6, fp8, sf4,
    sf6, sf8) u8 arrays in the device layout, bit-identical to
    ``mx.mxtensor.quantize_mixed(pack_fp4=True)``."""
    lib = _mxpack()
    x = np.ascontiguousarray(x, np.float32)
    rows, k = x.shape
    if k != k4 + k6 + k8:
        raise ValueError(f"K {k} != {k4} + {k6} + {k8}")
    out = {
        "fp4": np.empty((rows, k4 // 2), np.uint8),
        "sf4": np.empty((rows, k4 // 32), np.uint8),
        "fp6": np.empty((rows, k6), np.uint8),
        "sf6": np.empty((rows, k6 // 32), np.uint8),
        "fp8": np.empty((rows, k8), np.uint8),
        "sf8": np.empty((rows, k8 // 32), np.uint8),
    }
    lib.mx_quantize_mixed(_f32(x), rows, k4, k6, k8, int(weight_fp4_only),
                          _u8(out["fp4"]), _u8(out["sf4"]), _u8(out["fp6"]),
                          _u8(out["sf6"]), _u8(out["fp8"]), _u8(out["sf8"]),
                          _threads(n_threads))
    return out


__all__ = ["native_available", "quantize_mixed_host", "quantize_scaledw8_host",
           "host_library"]
