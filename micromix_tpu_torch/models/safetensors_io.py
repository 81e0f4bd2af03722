"""A reader of the safetensors format that needs only torch and json.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"`` of strings), then the tensors' raw
little-endian bytes, offsets counted from the end of the header.

The file is mapped copy-on-write, so nothing is read before a tensor is
asked for: a tensor for the CPU is a view of the mapping (the pages are
read once, when touched), and a tensor for the GPU is copied to the card
from it, once.  The JAX package reads checkpoints with the
``safetensors`` package; this port reads them with this module alone.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, List

import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I32": torch.int32, "I64": torch.int64, "U8": torch.uint8,
    "F8_E4M3": torch.float8_e4m3fn,
}


class SafetensorsFile:
    """One ``.safetensors`` file: ``keys()``, ``metadata`` and
    ``get_tensor(name, device)``."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._begin = 8 + n
        self._entries = header
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{e['dtype']}, which this reader does not take")
            lo, hi = e["data_offsets"]
            count = 1
            for s in e["shape"]:
                count *= s
            if hi - lo != count * DTYPES[e["dtype"]].itemsize or \
                    self._begin + hi > len(self._map):
                raise ValueError(f"{path}: tensor {name!r} has offsets "
                                 f"{e['data_offsets']} for {e['shape']} "
                                 f"{e['dtype']}")

    def keys(self) -> List[str]:
        return list(self._entries)

    def get_tensor(self, name: str, device=None) -> torch.Tensor:
        e = self._entries[name]
        dtype = DTYPES[e["dtype"]]
        lo, hi = e["data_offsets"]
        if hi == lo:
            return torch.empty(e["shape"], dtype=dtype, device=device)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=hi - lo,
                               offset=self._begin + lo)
        if (self._begin + lo) % dtype.itemsize:
            raw = raw.clone()       # an unaligned tensor: one aligned copy
        t = raw.view(dtype).reshape(e["shape"])
        return t if device is None else t.to(device)


__all__ = ["DTYPES", "SafetensorsFile"]
