"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``micromix_tpu_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds) and loaded with ``ctypes``.  Builds happen on first
use, never at import: the first ``library()`` call starts one ``nvcc`` per
source that is not built yet, all at once, and waits for them.  Libraries
go to ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of source and flags, so an edited source is rebuilt.

Every wrapper counts its launches in ``launches`` (one per kernel launch
made by a wrapper call; B's and K's calls with f32 output also under
"w8_gemm_f32" / "sp_gemm_f32"), so a run can show that its main path went
through the kernels; the attention kernels over KV pages (C and H) also
count each launch by page width in ``page_launches`` ((name, bits) ->
launches), so a run can show which pages they read; B, F, C and D, which
the speculative verify runs at B*S rows, also count each launch by its
rows in ``row_launches`` ((name, rows) -> launches; C's launches with the
per-row ``lengths`` override as "paged_decode_lengths").
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("site_fakequant", "w8_gemm", "paged_decode", "append_kv",
           "flash_attention", "w8_stack", "w8_pair", "paged_prefill",
           "w8_grouped", "mx_quantize", "sp_gemm", "sp_stack")
# No --use_fast_math: the site kernel's bit-exactness rests on IEEE
# division, sqrtf and rintf.  -Xptxas -v: each kernel's registers, spills
# and shared memory, kept beside its library (``ptxas_report``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: collections.Counter = collections.Counter()
page_launches: collections.Counter = collections.Counter()
row_launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
# host arrays (ctypes arrays of c_int / c_float / c_void_p)
INTS = ctypes.POINTER(ctypes.c_int)
FLOATS = ctypes.POINTER(ctypes.c_float)
PTRS = ctypes.POINTER(ctypes.c_void_p)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _target(name: str) -> Path:
    # the shared headers are part of every source's identity
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every listed kernel not built yet, one ``nvcc`` each, all
    started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{n}.cu:\n{out.decode(errors='replace')}")
        else:
            _target(n).with_suffix(".ptxas.txt").write_bytes(out)
            os.replace(tmp, _target(n))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> List[Dict]:
    """What ``ptxas -v`` said of each kernel instantiation in source
    ``name`` when it was built: [{"function", "registers", "spill_stores",
    "spill_loads", "stack", "smem"}] (smem: static shared bytes)."""
    import re
    text = _target(name).with_suffix(".ptxas.txt").read_text(errors="replace")
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # a mangled kernel name -> "name<template ints>"
            t = re.search(r"([A-Za-z_]+)I((?:Li\d+E)+)E", m.group(1))
            cur = {"function": m.group(1) if t is None else
                   f"{t.group(1)}<{','.join(re.findall(r'Li(\d+)E', t.group(2)))}>"}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def library(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Load one kernel library (building all missing ones first) and set
    ``argtypes`` for each exported function; every export returns the
    ``cudaGetLastError()`` of its launch as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def ptr(t) -> int:
    """Device address of a tensor (0 for None)."""
    return 0 if t is None else t.data_ptr()


def require_cuda(name: str, *tensors) -> torch.device:
    """All given tensors lie on one CUDA device, are contiguous and start
    16-byte aligned (the kernels load 16 bytes a thread)."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: input {tuple(t.shape)} not 16-byte aligned")
    return dev


def reset_launches() -> None:
    launches.clear()
    page_launches.clear()
    row_launches.clear()
