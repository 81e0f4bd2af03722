"""KV-cache append (Kernel D, ``csrc/append_kv.cu``), in place.

Counterpart of ``micromix_tpu/serve/append_kernel.py``, with two entry
points:

  * ``append_kv_kernel``: T quantized token columns into their pages (one
    thread per token, head and row); on CPU tensors its plain version is
    one indexed store per array.  The JAX kernel's signature; the serving
    path no longer calls it.
  * ``append_kv_quant``: the launch of the whole append of
    ``kv_cache.append_kv`` (K's RoPE, ``kv_quantize`` of K and V, the slot
    index, the stores and the ``lengths`` max) in one kernel; CUDA
    tensors only (``kv_cache.append_kv`` runs the plain version on the
    CPU).

A per-column store has no page-tile read-blend-write, so either kernel
takes decode appends and prefill appends of any T.  Tokens that share a
target can only be ones parked on the scratch page, whose contents nothing
reads.
"""

from __future__ import annotations

import torch

from ..kernels import build, limits

_SIG = {"append_kv": [build.PTR] * 10 + [build.INT] * 4 + [build.PTR],
        "append_kv_quant": ([build.PTR] * 12 + [build.INT] * 10 + [build.FLOAT]
                            + [build.PTR])}


def append_kv_plain(k_codes, v_codes, k_sz, v_sz, page_id, off,
                    kq, vq, ksz, vsz) -> None:
    pid, o = page_id.long(), off.long()
    k_codes[pid, :, :, o] = kq
    v_codes[pid, :, :, o] = vq
    k_sz[pid, :, :, o] = ksz
    v_sz[pid, :, :, o] = vsz


def append_kv_kernel(k_codes: torch.Tensor, v_codes: torch.Tensor,
                     k_sz: torch.Tensor, v_sz: torch.Tensor,
                     page_id: torch.Tensor, off: torch.Tensor,
                     kq: torch.Tensor, vq: torch.Tensor,
                     ksz: torch.Tensor, vsz: torch.Tensor) -> None:
    """``k_codes[page_id[t], :, :, off[t]] = kq[t]`` (and v, and the sz
    arrays) for every t.  kq/vq (T, H, dq) u8; ksz/vsz (T, H, 2) bf16."""
    t, h, dq = kq.shape
    if k_codes.shape[1:3] != (h, dq) or ksz.shape != (t, h, 2):
        raise ValueError(f"append shapes: pages {tuple(k_codes.shape)}, "
                         f"codes {tuple(kq.shape)}, sz {tuple(ksz.shape)}")
    if not k_codes.is_cuda:
        append_kv_plain(k_codes, v_codes, k_sz, v_sz, page_id, off,
                        kq, vq, ksz, vsz)
        return
    if kq.dtype != torch.uint8 or ksz.dtype != torch.bfloat16:
        raise ValueError("append takes u8 codes and bf16 [scale, zero]")
    page_id = page_id.to(torch.int32).contiguous()
    off = off.to(torch.int32).contiguous()
    kq, vq, ksz, vsz = (a.contiguous() for a in (kq, vq, ksz, vsz))
    build.require_cuda("append_kv", k_codes, v_codes, k_sz, v_sz, page_id,
                       off, kq, vq, ksz, vsz)
    if t == 0:
        return
    lib = build.library("append_kv", _SIG)
    build.launches["append_kv"] += 1
    rc = lib.append_kv(build.ptr(k_codes), build.ptr(v_codes), build.ptr(k_sz),
                       build.ptr(v_sz), build.ptr(page_id), build.ptr(off),
                       build.ptr(kq), build.ptr(vq), build.ptr(ksz),
                       build.ptr(vsz), t, h, dq, k_codes.shape[3],
                       build.stream())
    build.check(rc, "append_kv")


def append_kv_quant(k_codes: torch.Tensor, v_codes: torch.Tensor,
                    k_sz: torch.Tensor, v_sz: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor,
                    seq_ids: torch.Tensor, positions: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, bits: int, recip: float,
                    cos=None, sin=None) -> None:
    """One launch of the whole append (``kv_cache.append_kv`` on the card).

    k/v (T, H, D) bf16 with heads and dims dense (any token stride);
    seq_ids/positions (T,) int32; cos/sin (T, D) f32 or both None;
    ``recip`` the f32 1 / (2^bits - 1) (unread for bf16 pages, bits 16).
    Raises on anything else: nothing is converted or copied on the way."""
    t, h, d = k.shape
    dq = d // 2 if bits == 4 else d
    tensors = (k_codes, v_codes, k_sz, v_sz, page_table, lengths, seq_ids,
               positions, k, v) + (() if cos is None else (cos, sin))
    if any(a.device != k_codes.device for a in tensors) or not k_codes.is_cuda:
        raise ValueError("append_kv_quant: every tensor on one CUDA device")
    limits.check("append", head_dim=d, bits=bits)
    if k_codes.dtype != (torch.bfloat16 if bits == 16 else torch.uint8):
        raise ValueError(f"append_kv_quant: {k_codes.dtype} pages for {bits} bits")
    if (k_codes.shape[1:3] != (h, dq) or v.shape != k.shape
            or seq_ids.shape != (t,) or positions.shape != (t,)):
        raise ValueError(f"append_kv_quant shapes: pages {tuple(k_codes.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, seq_ids "
                         f"{tuple(seq_ids.shape)}, positions {tuple(positions.shape)}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"append_kv_quant: k/v {k.dtype}, {v.dtype}: takes bf16")
    for a in (k, v):
        if a.stride(2) != 1 or a.stride(1) != d:
            raise ValueError(f"append_kv_quant: k/v strides {a.stride()}: heads "
                             "and dims must be dense")
    for a in (seq_ids, positions, page_table, lengths):
        if a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError(f"append_kv_quant: index array {a.dtype} "
                             f"{tuple(a.shape)}: takes contiguous int32")
    if (cos is None) != (sin is None):
        raise ValueError("append_kv_quant: give both RoPE tables or neither")
    if cos is not None:
        for a in (cos, sin):
            if (a.dtype != torch.float32 or a.shape != (t, d)
                    or not a.is_contiguous()):
                raise ValueError(f"append_kv_quant: RoPE table {a.dtype} "
                                 f"{tuple(a.shape)}: takes contiguous f32 {(t, d)}")
    if not all(a.is_contiguous() for a in (k_codes, v_codes, k_sz, v_sz)):
        raise ValueError("append_kv_quant: non-contiguous page arrays")
    if t == 0:
        return
    lib = build.library("append_kv", _SIG)
    build.launches["append_kv_quant"] += 1
    build.row_launches[("append_kv_quant", t)] += 1
    rc = lib.append_kv_quant(
        build.ptr(k_codes), build.ptr(v_codes), build.ptr(k_sz), build.ptr(v_sz),
        build.ptr(page_table), build.ptr(lengths), build.ptr(seq_ids),
        build.ptr(positions), build.ptr(k), build.ptr(v), build.ptr(cos),
        build.ptr(sin), t, h, d, k_codes.shape[3], k_codes.shape[0],
        page_table.shape[1], page_table.shape[0], k.stride(0), v.stride(0),
        bits, recip, build.stream())
    build.check(rc, "append_kv_quant")
