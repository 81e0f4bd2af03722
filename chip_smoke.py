#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``micromix_tpu_torch``) on one H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's twelve CUDA kernels from ``micromix_tpu_torch/csrc/``
and runs these phases; any failure exits non-zero before the result line.

  0. the card's name and power limit, torch / CUDA / nvcc versions;
  1. build the kernels (one nvcc per source, all at once);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the Llama-3.1-8B (ScaledW8 and split-plane layouts) and
     Mixtral-8x7B main paths, with its median time (CUDA events, L2
     flushed before each launch), its bound (bytes over 3.35 TB/s or
     operations over 989 TFLOP/s, whichever is larger), the plain
     version's time and, where one PyTorch call computes the same
     function, that call's time; for the stacked and grouped GEMMs (F, I)
     also the GEMM alone on the site image, and from 256 rows the
     dequantize route the model runs above their row limits, with the
     route table and the limits its timings select; Kernel G alone
     beside the pair, and on both of its mainloops (the decode-row strip
     and w8_tile.cuh's tile) at 8-128 rows with the row limit their
     timings select; the site kernel also at prefill rows (rms 512 and
     4096, Mixtral-8x7B's 4096-row expert sites); decode attention also
     at 2048, 4096 and 8192 tokens, over int8 pages, with a 1024-token
     window, and with the ``lengths`` override and the (m, den) state;
  3. 2-layer full-width models from one seed, stacked: Llama-3.1-8B
     (ScaledW8, and again with a 256-token sliding window), Mixtral-8x7B
     (experts grouped) and Llama-3.1-8B in the split-plane layout: a
     300-token prompt prefilled in chunks of 128
     (flash, then paged history) and 8 (Mixtral: 4) greedy decode steps
     (ScaledW8 Llama: through the residual pairs), each chunk and step
     with the kernels on the card and with the plain versions on the CPU
     from the same cache state; the greedy tokens must be equal;
  4. serving Llama-3.1-8B at full depth (32 layers, random weights made on
     the card): the default (stacked) engine answers 8 requests, six of
     96-128 and two of 1200-1500 prompt tokens, with prefill_chunk 512
     and 32 new tokens each, so chunked prefill and piggyback run; then
     the per-consumer engine (``MICROMIX_NO_STACK=1``) at 4 layers
     answers 8 requests of 96-128 tokens;
  5. serving Mixtral-8x7B at full depth (32 layers, random weights made
     on the card and grouped layer by layer) with the default engine and
     phase 4's traffic; then the per-expert engine (``MICROMIX_NO_STACK=1``)
     at 2 layers answers 8 requests of 96-128 tokens;
  6. serving Llama-3.1-8B in the split-plane layout
     (``random_quantized_model(layout="splitplane")``) at 32 layers with
     the default engine and phase 4's kind of traffic (one long prompt's
     last chunk pads to 256 rows, the other's to 512, so both sides of
     the 512-row dequantize threshold run); then the per-consumer engine
     at 4 layers, 8 requests of 96-128 tokens.

In phases 4 to 6 every kernel launch counter is reset just before each
run and read just after; each run must launch every kernel of its path
(the default Mixtral run no residual pair, the split-plane runs no
ScaledW8 kernel).  Kernel launches per decode step and layer, host ms
and device busy ms per step (``torch.profiler``) are taken for every
form.  It prints the per-kernel JSON line, and last
``{"ok": true, "device": ...}``.  Per-shape results also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits with
status 2 and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_S = 989e12        # H100 SXM dense bf16 tensor cores
SEED = 0
TIMED_ITERS = 15
SPLIT_4096 = (3584, 256, 256)          # default_calibration(p6=256, p8=256)
SPLIT_14336 = (13824, 256, 256)
LLAMA3_SCALING = ("llama3", 8.0, 1.0, 4.0, 8192)
OUT_DIR = "chiprun_out"
DEV = "cuda"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def llama31_8b(num_layers: int):
    """Llama-3.1-8B's published config.json widths; depth as given."""
    from micromix_tpu_torch.models.common import ModelConfig
    return ModelConfig(arch="llama", vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=num_layers,
                       num_heads=32, num_kv_heads=8, head_dim=128,
                       rope_theta=500000.0, rms_eps=1e-5,
                       max_position_embeddings=131072,
                       rope_scaling=LLAMA3_SCALING)


def mixtral_8x7b(num_layers: int):
    """Mixtral-8x7B's published config.json widths; depth as given.  Dense
    dispatch (no capacity factor), no sliding window."""
    from micromix_tpu_torch.models.common import ModelConfig
    return ModelConfig(arch="mixtral", vocab_size=32000, hidden_size=4096,
                       intermediate_size=14336, num_layers=num_layers,
                       num_heads=32, num_kv_heads=8, head_dim=128,
                       rope_theta=1e6, rms_eps=1e-5,
                       max_position_embeddings=32768, num_experts=8,
                       num_experts_per_tok=2)


class Timer:
    """Median per-call device time from CUDA events, L2 flushed before
    each call.  A spin of about 1 ms on the card after the flush lets the
    host enqueue every launch of a multi-launch wrapper before the start
    event runs, so host launch overhead stays out of the reading."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)

    def ms(self, fn, iters: int = TIMED_ITERS) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def record(results, kernel, shape, err, tol, ok, t, nbytes, flops,
           plain_ms, library_ms=None, **extra):
    """One kernel check; ``extra``: other measured times of the shape
    (yardsticks that are not the same function), printed and kept."""
    bms, by = bound(nbytes, flops)
    r = dict(kernel=kernel, shape=shape, max_abs_err=err, tolerance=tol,
             ms=t, bound_ms=bms, bound_by=by, plain_ms=plain_ms,
             library_ms=library_ms, **extra)
    results.append(r)
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    more = "".join(f" {key}={val:.4f}" if isinstance(val, float) else
                   f" {key}={val}" for key, val in extra.items())
    print(f"  {kernel:16s} {shape:34s} max_abs_err={err:.3e} ({tol}) "
          f"ms={t:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
          f"library_ms={lib}{more}", flush=True)
    if not ok:
        fail(f"{kernel} {shape}: error {err} outside {tol}")


def close(got, ref):
    """GEMM / attention tolerance: exact or f32-exact operands, sums in
    another order, one bf16 rounding -> 2^-7 |ref| + 2^-8 max|ref|."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    ok = bool((err <= 2.0 ** -7 * r.abs() + 2.0 ** -8 * r.abs().max()).all())
    return float(err.max()), ok


def tie_band(got, ref, splits):
    """Site images: at most 1 element in 1000 may sit one grid step of its
    32-block away (an RNE tie moved by the f32 sum order or the sigmoid's
    last bit)."""
    g, r = got.float(), ref.float()
    diff = g != r
    ok = float(diff.float().mean()) <= 1e-3
    off = 0
    for kseg, mant in zip(splits, (1, 2, 3)):
        gb = g[:, off:off + kseg].reshape(g.shape[0], 32, -1)
        rb = r[:, off:off + kseg].reshape(r.shape[0], 32, -1)
        bmax = torch.maximum(gb.abs().amax(1), rb.abs().amax(1)).clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(bmax)) - mant)
        ok = ok and bool(((gb - rb).abs() <= step[:, None, :]).all())
        off += kseg
    return float((g - r).abs().max()), ok


# ----------------------------------------------------------------- phase 2

def check_site(results, timer, rng):
    from micromix_tpu_torch.kernels.fakequant import (fakequant_site,
                                                      fakequant_site_plain)
    from micromix_tpu_torch.mx.layout import compose_segmented
    dev = DEV
    for m in (8, 128):
        for producer, k, splits in (("rms", 4096, SPLIT_4096),
                                    ("silu", 14336, SPLIT_14336),
                                    ("plain", 4096, SPLIT_4096)):
            x = torch.randn(m, k, device=dev)
            x[:, torch.randperm(k, device=dev)[:16]] *= 30.0
            x = x.to(torch.bfloat16)
            kw = {}
            if producer == "rms":
                kw["gamma"] = 1.0 + 0.1 * torch.randn(k, device=dev)
            if producer == "silu":
                kw["up"] = torch.randn(m, k, device=dev).to(torch.bfloat16)
            else:
                kw["perm"] = torch.from_numpy(compose_segmented(
                    rng.permutation(k).astype(np.int32), *splits)).to(dev)
            if producer != "plain":
                kw.update(producer=producer, eps=1e-5)
            got = fakequant_site(x, *splits, **kw)
            ref = fakequant_site_plain(x, *splits, **kw)
            if producer == "plain":
                err = float((got.float() - ref.float()).abs().max())
                ok, tol = err == 0.0, "bit-exact"
            else:
                (err, ok), tol = tie_band(got, ref, splits), "tie band"
            aux = {"rms": k * 4 + k * 4, "silu": m * k * 2, "plain": k * 4}
            nbytes = 2 * m * k * 2 + aux[producer]
            record(results, "site_fakequant", f"{producer} M={m} K={k}", err,
                   tol, ok, timer.ms(lambda: fakequant_site(x, *splits, **kw)),
                   nbytes, 0.0,
                   timer.ms(lambda: fakequant_site_plain(x, *splits, **kw)))
    # prefill rows: the q|k|v site of 512- and 4096-token chunks, and the
    # Mixtral-8x7B expert sites of a 512-token dense-dispatch chunk (E x C
    # = 4096 rows): w1|w3's plain site, one permutation per 512 rows, and
    # w2's silu site
    for producer, m, k, splits, groups in (
            ("rms", 512, 4096, SPLIT_4096, 1), ("rms", 4096, 4096, SPLIT_4096, 1),
            ("silu", 4096, 14336, SPLIT_14336, 0),
            ("plain", 4096, 4096, SPLIT_4096, 8)):
        x = _site_input(m, k)
        kw = {}
        if producer == "rms":
            kw = dict(producer="rms", eps=1e-5, perm=_perm(rng, k, splits),
                      gamma=1.0 + 0.1 * torch.randn(k, device=dev))
        elif producer == "silu":
            kw = dict(producer="silu", up=torch.randn(m, k, device=dev).to(torch.bfloat16))
        else:
            kw = dict(perm=torch.stack([_perm(rng, k, splits) for _ in range(groups)]))
        got = fakequant_site(x, *splits, **kw)
        ref = fakequant_site_plain(x, *splits, **kw)
        if producer == "plain":
            err = float((got.float() - ref.float()).abs().max())
            ok, tol = err == 0.0, "bit-exact"
        else:
            (err, ok), tol = tie_band(got, ref, splits), "tie band"
        aux = {"rms": k * 8, "silu": m * k * 2, "plain": groups * k * 4}[producer]
        label = f"{producer} M={m} K={k}" + (f" perm_rows={m // groups}"
                                             if groups > 1 else "")
        record(results, "site_fakequant", label, err, tol, ok,
               timer.ms(lambda: fakequant_site(x, *splits, **kw)),
               2 * m * k * 2 + aux, 0.0,
               timer.ms(lambda: fakequant_site_plain(x, *splits, **kw)))


def check_gemm(results, timer):
    """Kernel B at the decode rows and at the prefill rows of the single
    ScaledW8 weights (o: N=4096 K=4096, down: N=4096 K=14336; 128, 512 and
    1023 rows reach B, from 1024 the dequantize-then-matmul route runs).
    At 1024 and 2048 rows of o and down B is also timed against that route
    (``route_ms``: dequantize to bf16 plus ``torch.matmul``), to show where
    B stops winning; the route is what ``mixed_matmul`` runs there."""
    from micromix_tpu_torch.kernels.fakequant import fakequant_values
    from micromix_tpu_torch.kernels.mixed_matmul import (
        mixed_matmul_w8, mixed_matmul_w8_plain)
    from micromix_tpu_torch.mx.mxtensor import quantize_mixed
    from micromix_tpu_torch.mx.scaledw8 import (dequantize_scaled_w8,
                                                pack_scaled_w8)
    dev = DEV
    for n, k in ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)):
        splits = SPLIT_4096 if k == 4096 else SPLIT_14336
        w = pack_scaled_w8(quantize_mixed(
            torch.randn(n, k, device=dev) / k ** 0.5, *splits,
            weight_fp4_only=True))
        wd = dequantize_scaled_w8(w, torch.bfloat16)
        rows = (8, 128, 512) + ((1023, 1024, 2048) if n == 4096 else ())
        for m in rows:
            a = fakequant_values(torch.randn(m, k, device=dev), *splits)
            got = mixed_matmul_w8(a, w)
            err, ok = close(got, mixed_matmul_w8_plain(a, w))
            extra = {}
            if m >= 1024:
                extra["route_ms"] = timer.ms(lambda: torch.matmul(
                    a, dequantize_scaled_w8(w, torch.bfloat16).t()))
            record(results, "w8_gemm", f"M={m} N={n} K={k}", err,
                   "2^-7|ref|+2^-8max|ref|", ok,
                   timer.ms(lambda: mixed_matmul_w8(a, w)),
                   m * k * 2 + n * k + m * n * 2, 2.0 * m * n * k,
                   timer.ms(lambda: mixed_matmul_w8_plain(a, w)),
                   timer.ms(lambda: torch.matmul(a, wd.t())), **extra)
        del w, wd


def _decode_cache(rng, b, mp, bits=4, ps=128, hkv=8, d=128):
    """b rows of mp random pages each (codes, scales in [0.01, 0.1],
    integer zero points as kv_quantize makes them, a shuffled table)."""
    from micromix_tpu_torch.serve.kv_cache import make_cache
    cache = make_cache(b * mp + 1, ps, hkv, d, b, mp, bits=bits, device=DEV)
    cache.k_codes.random_(0, 256)
    cache.v_codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.01, 0.1)
        sz[:, :, 1].copy_(torch.randint(0, 2 ** bits, sz[:, :, 1].shape, device=DEV))
    cache.page_table.copy_(torch.from_numpy(
        1 + rng.permutation(b * mp).reshape(b, mp).astype(np.int32)))
    return cache


def check_decode(results, timer, rng):
    """Kernel C at the main path's decode (B=8, 100-600 tokens), at long
    contexts (B=8 at 2048 and 4096 tokens, B=1 at 8192: 64 pages), over
    int8 pages, with a 1024-token window at 4096, and with the ``lengths``
    override (8 rows of one 4096-token sequence at successive positions,
    as speculative verify runs them) and the (m, den) state: m within
    2^-16 max(1, |m|), den within 2^-12 relative (f32 sums in another
    order).  The bound counts every K/V code and [scale, zero] pair of
    each row's attended range once, q and the output."""
    from micromix_tpu_torch.models.common import rope_inv_freq
    from micromix_tpu_torch.serve.attention import (
        decode_split, paged_decode_attention, paged_decode_attention_plain)
    h, hkv, d, ps = 32, 8, 128, 128
    inv = rope_inv_freq(d, 500000.0, LLAMA3_SCALING, device=DEV)
    cases = (("len 100..600", 8, np.linspace(100, 600, 8), 4, None, False),
             ("len 2048", 8, np.full(8, 2048), 4, None, False),
             ("len 4096", 8, np.full(8, 4096), 4, None, False),
             ("len 8192", 1, np.full(1, 8192), 4, None, False),
             ("len 100..600 int8", 8, np.linspace(100, 600, 8), 8, None, False),
             ("len 4096 window 1024", 8, np.full(8, 4096), 4, 1024, False),
             ("lengths 4089..4096 state", 8, np.arange(4089, 4097), 4, None, True))
    for label, b, lengths, bits, window, override in cases:
        lengths = lengths.astype(np.int32)
        mp = -(-int(lengths.max()) // ps)
        cache = _decode_cache(rng, 1 if override else b, mp, bits)
        if override:      # one sequence, rows at successive positions
            cache.lengths.fill_(int(lengths.max()))
            seq = torch.zeros(b, dtype=torch.int32, device=DEV)
        else:
            cache.lengths.copy_(torch.from_numpy(lengths))
            seq = torch.arange(b, device=DEV, dtype=torch.int32)
        q = torch.randn(b, h, d, device=DEV).to(torch.bfloat16)
        pos = torch.from_numpy(lengths - 1).to(DEV)
        kw = dict(rope_positions=pos, rope_inv_freq=inv, sliding_window=window)
        pkw = {}
        if override:
            kw.update(lengths=torch.from_numpy(lengths).to(DEV), with_state=True)
            pkw = dict(lengths=kw["lengths"], with_state=True)
        run = lambda: paged_decode_attention(q, cache, seq, **kw)
        plain = lambda: paged_decode_attention_plain(q, cache, seq, window, pos,
                                                     inv, **pkw)
        got, ref = run(), plain()
        tol = "2^-7|ref|+2^-8max|ref|"
        if override:
            (got, m, den), (ref, rm, rden) = got, ref
            err, ok = close(got, ref)
            ok = (ok and bool(((m - rm).abs() <= 2.0 ** -16
                               * rm.abs().max().clamp_min(1.0)).all())
                  and bool(((den - rden).abs() <= 2.0 ** -12 * rden.abs()).all()))
            tol += "; m 2^-16 max(1,|m|), den 2^-12 rel"
        else:
            err, ok = close(got, ref)
        attended = np.minimum(lengths, window or lengths.max())
        tokens = int(attended.sum())
        # the function's inputs read once: one sequence's pages under the
        # override, each row's attended pages otherwise
        read = int(attended.max()) if override else tokens
        dq = d // 2 if bits == 4 else d
        nbytes = 2 * b * h * d * 2 + 2 * read * hkv * (dq + 4) + b * mp * 4
        splits, pps = decode_split(b, hkv, mp)
        record(results, "paged_decode", f"B={b} H={h} Hkv={hkv} D={d} {label}",
               err, tol, ok, timer.ms(run), nbytes, 4.0 * tokens * h * d,
               timer.ms(plain), grid_splits=splits, pages_per_split=pps)
        del cache


def check_append(results, timer, rng):
    from micromix_tpu_torch.serve.append_kernel import (append_kv_kernel,
                                                        append_kv_plain)
    from micromix_tpu_torch.serve.kv_cache import kv_quantize, make_cache
    dev = DEV
    hkv, d, ps = 8, 128, 128
    for t in (8, 1024):
        cache = make_cache(20, ps, hkv, d, 8, 2, device=dev)
        for a in (cache.k_codes, cache.v_codes):
            a.copy_(torch.randint(0, 256, a.shape, device=dev))
        if t == 8:          # decode: one token per sequence
            page_id = torch.arange(1, 9, device=dev, dtype=torch.int32)
            off = torch.from_numpy(rng.integers(0, ps, 8).astype(np.int32)).to(dev)
        else:               # prefill: 8 sequences x 128 positions
            page_id = torch.arange(1, 9, device=dev,
                                   dtype=torch.int32).repeat_interleave(128)
            off = torch.arange(128, device=dev, dtype=torch.int32).repeat(8)
        kq, ks, kz = kv_quantize(torch.randn(t, hkv, d, device=dev), 4)
        vq, vs, vz = kv_quantize(torch.randn(t, hkv, d, device=dev), 4)
        ksz, vsz = torch.stack([ks, kz], -1), torch.stack([vs, vz], -1)
        pages = (cache.k_codes, cache.v_codes, cache.k_sz, cache.v_sz)
        got = [p.clone() for p in pages]
        ref = [p.clone() for p in pages]
        args = (page_id, off, kq, vq, ksz, vsz)
        append_kv_kernel(*got, *args)
        append_kv_plain(*ref, *args)
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, ref))
        nbytes = 2 * (2 * t * hkv * (d // 2 + 4)) + t * 8
        record(results, "append_kv", f"T={t} Hkv={hkv} D={d}", err,
               "bit-exact", err == 0.0,
               timer.ms(lambda: append_kv_kernel(*got, *args)), nbytes, 0.0,
               timer.ms(lambda: append_kv_plain(*ref, *args)))


def check_flash(results, timer):
    import torch.nn.functional as F
    from micromix_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    dev = DEV
    h, hkv, d = 32, 8, 128
    for b, s in ((1, 128), (8, 128), (1, 2048), (1, 4096)):
        q = torch.randn(b, s, h, d, device=dev).to(torch.bfloat16)
        k = torch.randn(b, s, hkv, d, device=dev).to(torch.bfloat16)
        v = torch.randn(b, s, hkv, d, device=dev).to(torch.bfloat16)
        err, ok = close(flash_attention(q, k, v), flash_attention_plain(q, k, v))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = 2 * b * s * (h + 2 * hkv) * d + 2 * b * s * h * d
        flops = 2.0 * d * s * (s + 1) * b * h       # QK^T and PV, causal half
        record(results, "flash_attention", f"B={b} S={s} H={h} Hkv={hkv} D={d}",
               err, "2^-7|ref|+2^-8max|ref|", ok,
               timer.ms(lambda: flash_attention(q, k, v)), nbytes, flops,
               timer.ms(lambda: flash_attention_plain(q, k, v)), lib)


def _w8_weight(n, k, splits):
    from micromix_tpu_torch.mx.mxtensor import quantize_mixed
    from micromix_tpu_torch.mx.scaledw8 import pack_scaled_w8
    return pack_scaled_w8(quantize_mixed(
        torch.randn(n, k, device=DEV) / k ** 0.5, *splits, weight_fp4_only=True))


def _site_input(m, k):
    x = torch.randn(m, k, device=DEV)
    x[:, torch.randperm(k, device=DEV)[:16]] *= 30.0
    return x.to(torch.bfloat16)


def _perm(rng, k, splits):
    from micromix_tpu_torch.mx.layout import compose_segmented
    return torch.from_numpy(compose_segmented(
        rng.permutation(k).astype(np.int32), *splits)).to(DEV)


def _stack_close(outs, img, st):
    """Stacked outputs against the plain GEMM on the kernel's own site
    image, so a tie the site kernel moved does not count against the GEMM."""
    from micromix_tpu_torch.kernels.mixed_matmul import w8_stack_gemm_plain
    errs = [close(g, r) for g, r in zip(outs, w8_stack_gemm_plain(img, st))]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


STACK_ROWS = {"q|k|v": (8, 100, 128, 256, 512, 1023),
              "gate|up": (8, 128, 256, 512, 1023)}
GROUPED_ROWS = {"w13": (8, 100, 128, 256, 512), "w2": (8, 128, 256, 512)}
ROUTE_MIN_ROWS = 256        # rows from which both routes are timed


def check_stack(results, timer, rng):
    """Kernel F behind the rms site at q|k|v and gate|up (K=4096): decode
    rows (8, the narrow tile), 100 and 128 (the wide tile) and the prefill
    rows of the route table (256, 512, 1023).  ``gemm_ms``: F alone on the
    kernel's image (``w8_stack_gemm``), beside the wrapper's time (site +
    F).  From 256 rows ``route_ms`` times what the model runs above the
    stack's row limit (``stack_dense_apply`` after the site: the stack
    dequantized, ``torch.matmul``, the section split), all its launches
    counted."""
    from micromix_tpu_torch.kernels.fakequant import (fakequant_site,
                                                      fakequant_site_plain)
    from micromix_tpu_torch.kernels.mixed_matmul import (
        mixed_matmul_w8_stack, mixed_matmul_w8_stack_plain, w8_stack_gemm)
    from micromix_tpu_torch.models.common import stack_dense_apply
    from micromix_tpu_torch.mx.scaledw8 import dequantize_stack, stack_scaled_w8
    k = 4096
    for name, ns in (("q|k|v", (4096, 1024, 1024)), ("gate|up", (14336, 14336))):
        st = stack_scaled_w8([_w8_weight(n, k, SPLIT_4096) for n in ns])
        wd = dequantize_stack(st)
        for m in STACK_ROWS[name]:
            x = _site_input(m, k)
            kw = dict(producer="rms", gamma=1.0 + 0.1 * torch.randn(k, device=DEV),
                      perm=_perm(rng, k, SPLIT_4096), eps=1e-5)
            outs = mixed_matmul_w8_stack(x, st, **kw)
            img = fakequant_site(x, *SPLIT_4096, **kw)
            _, ok_img = tie_band(img, fakequant_site_plain(x, *SPLIT_4096, **kw),
                                 SPLIT_4096)
            err, ok = _stack_close(outs, img, st)
            extra = dict(gemm_ms=timer.ms(lambda: w8_stack_gemm(img, st)))
            if m >= ROUTE_MIN_ROWS:
                extra["route_ms"] = timer.ms(lambda: stack_dense_apply(
                    fakequant_site(x, *SPLIT_4096, **kw), st))
            nbytes = sum(st.padded) * k + m * k * 2 + k * 8 + m * sum(ns) * 2
            record(results, "w8_stack", f"{name} rms M={m} K={k}", err,
                   "image in the tie band; outputs 2^-7|ref|+2^-8max|ref| "
                   "on the kernel's image", ok and ok_img,
                   timer.ms(lambda: mixed_matmul_w8_stack(x, st, **kw)),
                   nbytes, 2.0 * m * sum(ns) * k,
                   timer.ms(lambda: mixed_matmul_w8_stack_plain(x, st, **kw)),
                   timer.ms(lambda: torch.matmul(img, wd.t())), **extra)
        del st, wd


def check_pair(results, timer, rng):
    from micromix_tpu_torch.kernels.fakequant import (fakequant_site,
                                                      fakequant_site_plain)
    from micromix_tpu_torch.kernels.mixed_matmul import (
        mixed_matmul_w8_pair, mixed_matmul_w8_pair_plain, w8_residual,
        w8_residual_plain)
    from micromix_tpu_torch.mx.scaledw8 import dequantize_scaled_w8, stack_scaled_w8
    k, m = 4096, 8
    for name, ka, ksplit, ns, producer in (
            ("o_gateup", 4096, SPLIT_4096, (14336, 14336), "plain"),
            ("down_qkv", 14336, SPLIT_14336, (4096, 1024, 1024), "silu")):
        wa = _w8_weight(k, ka, ksplit)
        st = stack_scaled_w8([_w8_weight(n, k, SPLIT_4096) for n in ns])
        x = _site_input(m, ka)
        h = torch.randn(m, k, device=DEV).to(torch.bfloat16)
        gamma = 1.0 + 0.1 * torch.randn(k, device=DEV)
        perm_b = _perm(rng, k, SPLIT_4096)
        kw = dict(gamma_b=gamma, perm_b=perm_b, eps=1e-5, producer_a=producer)
        akw = dict(producer=producer, eps=1e-5)
        if producer == "plain":
            kw["perm_a"] = akw["perm"] = _perm(rng, ka, ksplit)
        else:
            kw["up_a"] = akw["up"] = torch.randn(m, ka, device=DEV).to(torch.bfloat16)
        hm, outs = mixed_matmul_w8_pair(x, h, wa, st, **kw)
        img_a = fakequant_site(x, *ksplit, **akw)
        _, ok_a = tie_band(img_a, fakequant_site_plain(x, *ksplit, **akw), ksplit)
        err_h = float((hm.float() - w8_residual_plain(img_a, wa, h).float()).abs().max())
        img_b = fakequant_site(hm, *SPLIT_4096, producer="rms", gamma=gamma,
                               perm=perm_b, eps=1e-5)
        err, ok = _stack_close(outs, img_b, st)
        nbytes = (k * ka + sum(st.padded) * k + m * ka * 2 * (1 + (producer == "silu"))
                  + 2 * m * k * 2 + k * 8 + m * sum(ns) * 2)
        # Kernel G alone on the kernel's site-A image: its codes, the image,
        # h in and h_mid out; beside it torch.addmm on the bf16 weight image
        # (one rounding where G rounds at the product: a yardstick only)
        g_bound, _ = bound(k * ka + m * ka * 2 + 2 * m * k * 2, 2.0 * m * k * ka)
        wd = dequantize_scaled_w8(wa, torch.bfloat16)
        record(results, "w8_pair", f"{name} M={m}", max(err_h, err),
               "h_mid bit-exact on the kernel's site-A image; outputs "
               "2^-7|ref|+2^-8max|ref| on its site-B image",
               ok and ok_a and err_h == 0.0,
               timer.ms(lambda: mixed_matmul_w8_pair(x, h, wa, st, **kw)),
               nbytes, 2.0 * m * (k * ka + sum(ns) * k),
               timer.ms(lambda: mixed_matmul_w8_pair_plain(x, h, wa, st, **kw)),
               residual_ms=timer.ms(lambda: w8_residual(img_a, wa, h)),
               residual_bound_ms=g_bound,
               residual_library_ms=timer.ms(lambda: torch.addmm(h, img_a, wd.t())))
        del wa, st, wd


G_ROUTE_ROWS = (8, 16, 32, 64, 128)


def check_residual_routes(results, timer) -> dict:
    """Kernel G alone (``w8_residual``) at o (N=4096 K=4096) and down
    (N=4096 K=14336) over the rows the pair gate admits, on the decode-row
    strip (up to 32 rows) and on w8_tile.cuh's tile, each bit-exact against
    the plain version on a site image; ``library_ms`` torch.addmm on the
    bf16 weight image.  Prints the table and the row limit the timings
    select (the largest timed row count up to which the strip is no slower
    at both shapes) beside ``W8_RESIDUAL_ROWS_MAX_M``."""
    from micromix_tpu_torch.kernels.fakequant import fakequant_values
    from micromix_tpu_torch.kernels.mixed_matmul import (
        W8_RESIDUAL_ROWS_MAX_M, _ROWS_MAX_M, residual_plan, w8_residual_plain,
        w8_residual_routed)
    from micromix_tpu_torch.mx.scaledw8 import dequantize_scaled_w8
    n = 4096
    table = {}
    for name, k, ksplit in (("o", 4096, SPLIT_4096), ("down", 14336, SPLIT_14336)):
        wa = _w8_weight(n, k, ksplit)
        wd = dequantize_scaled_w8(wa, torch.bfloat16)
        for m in G_ROUTE_ROWS:
            qa = fakequant_values(torch.randn(m, k, device=DEV), *ksplit)
            h = torch.randn(m, n, device=DEV).to(torch.bfloat16)
            ref = w8_residual_plain(qa, wa, h)
            plain = timer.ms(lambda: w8_residual_plain(qa, wa, h))
            lib = timer.ms(lambda: torch.addmm(h, qa, wd.t()))
            for route in ("rows", "tile") if m <= _ROWS_MAX_M else ("tile",):
                got = w8_residual_routed(qa, wa, h, None, route)
                err = float((got.float() - ref.float()).abs().max())
                t = timer.ms(lambda: w8_residual_routed(qa, wa, h, None, route))
                record(results, "w8_pair", f"G {name} M={m} {route}", err,
                       "bit-exact on a site image", err == 0.0, t,
                       n * k + m * k * 2 + 2 * m * n * 2, 2.0 * m * n * k, plain, lib,
                       splits=residual_plan(m, n, k, route)[1])
                table.setdefault(m, {}).setdefault(route, []).append(t)
        del wa, wd
    print("  G routes: decode-row strip ms / tile ms, o and down", flush=True)
    for m in G_ROUTE_ROWS:
        print(f"    M={m:3d} rows {table[m].get('rows')} tile {table[m]['tile']}",
              flush=True)
    selected = 0
    for m in G_ROUTE_ROWS:
        r = table[m]
        if "rows" not in r or any(a > b for a, b in zip(r["rows"], r["tile"])):
            break
        selected = m
    print(f"    W8_RESIDUAL_ROWS_MAX_M: the timings select {selected}; the "
          f"module constant is {W8_RESIDUAL_ROWS_MAX_M}", flush=True)
    return dict(selected=selected, constant=W8_RESIDUAL_ROWS_MAX_M,
                ms={m: table[m] for m in G_ROUTE_ROWS})


def check_prefill(results, timer, rng):
    """Kernel H at the main path's chunks (S=512 over 512, 1024 and 1536
    history positions) and over no history.  At hist 0 it computes what
    SDPA computes (causal attention over the chunk's own bf16 K/V, GQA):
    that call, in the (B, H, S, D) layout, is the library time.  With
    history no one call computes the same function (the history is int4);
    ``sdpa_bf16_ms`` times SDPA over the history dequantized to bf16
    beforehand plus the chunk, with an explicit mask: a yardstick only,
    its dequantization not timed."""
    import torch.nn.functional as F
    from micromix_tpu_torch.serve.kv_cache import kv_dequantize_page, make_cache
    from micromix_tpu_torch.serve.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    h, hkv, d, ps = 32, 8, 128, 128
    for s, hist in ((512, 1536), (512, 512), (512, 1024), (120, 0), (2048, 0)):
        mp = -(-(hist + s) // ps)
        cache = make_cache(mp + 1, ps, hkv, d, 1, mp, device=DEV)
        cache.k_codes.random_(0, 256)
        cache.v_codes.random_(0, 256)
        for sz in (cache.k_sz, cache.v_sz):
            sz[:, :, 0].uniform_(0.01, 0.1)
            sz[:, :, 1].copy_(torch.randint(0, 16, sz[:, :, 1].shape, device=DEV))
        cache.page_table[0] = torch.from_numpy(
            1 + rng.permutation(mp).astype(np.int32)).to(DEV)
        q = torch.randn(s, h, d, device=DEV).to(torch.bfloat16)
        k = torch.randn(s, hkv, d, device=DEV).to(torch.bfloat16)
        v = torch.randn(s, hkv, d, device=DEV).to(torch.bfloat16)
        start = torch.tensor(hist, dtype=torch.int32, device=DEV)
        run = lambda: paged_prefill_attention(q, k, v, cache, 0, start)
        plain = lambda: paged_prefill_attention_plain(q, k, v, cache, 0, start)
        err, ok = close(run(), plain())
        qt = q.transpose(0, 1)[None].contiguous()                # (1, H, S, D)
        if hist == 0:
            kt, vt = (x.transpose(0, 1)[None].contiguous() for x in (k, v))
            lib, extra = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)), {}
        else:
            pages = cache.page_table[0].long()

            def history(codes, sz):     # (1, Hkv, hist, D) bf16
                x = kv_dequantize_page(codes[pages], sz[pages], cache.bits)
                return x.permute(1, 0, 3, 2).reshape(hkv, -1, d)[None, :, :hist]
            kt = torch.cat([history(cache.k_codes, cache.k_sz),
                            k.transpose(0, 1)[None].float()], 2).to(torch.bfloat16)
            vt = torch.cat([history(cache.v_codes, cache.v_sz),
                            v.transpose(0, 1)[None].float()], 2).to(torch.bfloat16)
            mask = torch.ones(s, hist + s, dtype=torch.bool, device=DEV)
            mask[:, hist:] = torch.ones(s, s, dtype=torch.bool, device=DEV).tril()
            lib, extra = None, {"sdpa_bf16_ms": timer.ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                       enable_gqa=True))}
        nbytes = 2 * s * (h + 2 * hkv) * d + 2 * s * h * d + 2 * hist * hkv * (d // 2 + 4)
        record(results, "paged_prefill", f"S={s} hist={hist} H={h} Hkv={hkv} D={d}",
               err, "2^-7|ref|+2^-8max|ref|", ok, timer.ms(run), nbytes,
               4.0 * s * (hist + s / 2) * h * d, timer.ms(plain), lib, **extra)


def check_grouped(results, timer, rng):
    """Kernel I at Mixtral-8x7B's expert shapes, E=8: w1|w3 behind each
    expert's own plain site and w2 behind the silu site, at decode rows
    per expert (8, the narrow tile), 100 and 128 (the wide tile) and the
    prefill rows of the route table (256, 512: a dense-dispatch chunk).
    The site image against the plain site (bit-exact, or the tie band for
    silu), the outputs against the plain GEMM on the kernel's own image,
    and against the per-expert loop of the site and Kernel B on the card,
    bit for bit.  ``gemm_ms``: I alone on the kernel's image
    (``w8_grouped_gemm``); from 256 rows ``route_ms``: what the model runs
    above ``GROUPED_MAX_C`` (the site, then ``_grouped_apply``: the
    experts dequantized and one batched ``torch.matmul``)."""
    from micromix_tpu_torch.kernels.fakequant import (fakequant_site,
                                                      fakequant_site_plain)
    from micromix_tpu_torch.kernels.mixed_matmul import (
        mixed_matmul_w8_grouped, mixed_matmul_w8_grouped_plain,
        mixed_matmul_w8_site, w8_grouped_gemm, w8_grouped_gemm_plain)
    from micromix_tpu_torch.models.transformer import _grouped_apply
    from micromix_tpu_torch.mx.scaledw8 import (dequantize_grouped,
                                                group_scaled_w8, grouped_section)
    e = 8
    for name, k, ksplit, ns, producer in (
            ("w13", 4096, SPLIT_4096, (14336, 14336), "plain"),
            ("w2", 14336, SPLIT_14336, (4096,), "silu")):
        secs = [[_w8_weight(n, k, ksplit) for _ in range(e)] for n in ns]
        gw = group_scaled_w8(secs)
        del secs
        wd = dequantize_grouped(gw)
        for c in GROUPED_ROWS[name]:
            x = _site_input(e * c, k).reshape(e, c, k)
            if producer == "plain":
                perm = torch.stack([_perm(rng, k, ksplit) for _ in range(e)])
                kw = dict(perm=perm)
                site_kw = dict(perm=perm)
                one = [dict(perm=perm[i]) for i in range(e)]
            else:
                up = torch.randn(e, c, k, device=DEV).to(torch.bfloat16)
                kw = dict(producer="silu", up=up)
                site_kw = dict(producer="silu", up=up.reshape(-1, k))
                one = [dict(producer="silu", up=up[i]) for i in range(e)]
            outs = mixed_matmul_w8_grouped(x, gw, **kw)
            img = fakequant_site(x.reshape(-1, k), *ksplit, **site_kw)
            ref_img = fakequant_site_plain(x.reshape(-1, k), *ksplit, **site_kw)
            if producer == "plain":
                ok_img = torch.equal(img, ref_img)
            else:
                _, ok_img = tie_band(img, ref_img, ksplit)
            img = img.reshape(e, c, k)
            errs = [close(g, r) for g, r in zip(outs, w8_grouped_gemm_plain(img, gw))]
            err, ok = max(x for x, _ in errs), all(o for _, o in errs)
            loop_exact = all(
                torch.equal(outs[si][i], mixed_matmul_w8_site(
                    x[i], grouped_section(gw, i, si), **one[i]))
                for i in range(e) for si in range(len(ns)))
            extra = dict(gemm_ms=timer.ms(lambda: w8_grouped_gemm(img, gw)))
            if c >= ROUTE_MIN_ROWS:
                extra["route_ms"] = timer.ms(lambda: _grouped_apply(
                    fakequant_site(x.reshape(-1, k), *ksplit,
                                   **site_kw).reshape(e, c, k), gw))
            nbytes = (gw.codes.numel() + e * c * k * 2 * (1 + (producer == "silu"))
                      + (e * k * 4 if producer == "plain" else 0)
                      + e * c * sum(ns) * 2)
            record(results, "w8_grouped", f"{name} {producer} E={e} C={c} K={k}",
                   err, "image bit-exact (plain) or in the tie band (silu); "
                   "outputs 2^-7|ref|+2^-8max|ref| on the kernel's image and "
                   "bit-exact against the per-expert loop on the card",
                   ok and ok_img and loop_exact,
                   timer.ms(lambda: mixed_matmul_w8_grouped(x, gw, **kw)),
                   nbytes, 2.0 * e * c * sum(ns) * k,
                   timer.ms(lambda: mixed_matmul_w8_grouped_plain(x, gw, **kw)),
                   timer.ms(lambda: torch.bmm(img, wd.transpose(1, 2))), **extra)
        del gw, wd


def route_table(results, card: str) -> dict:
    """Kernel F / I against the dequantize route, at the rows where both
    were timed, and the row limits those timings select: the largest
    candidate at which the kernel's wrapper is no slower than the route at
    every timed row count up to it, for every shape of the kernel (128,
    the JAX package's limit, needs no timing: the kernels run there
    already).  Printed beside the module constants the model runs with."""
    from micromix_tpu_torch.kernels.mixed_matmul import (GROUPED_MAX_C,
                                                         W8_STACK_MAX_M)
    out = {}
    print(f"  route table ({card}): wrapper ms / dequantize route ms", flush=True)
    for kernel, constant, value, candidates in (
            ("w8_stack", "W8_STACK_MAX_M", W8_STACK_MAX_M, (128, 256, 512, 1023)),
            ("w8_grouped", "GROUPED_MAX_C", GROUPED_MAX_C, (128, 256, 512))):
        rows = [r for r in results if r["kernel"] == kernel and "route_ms" in r]
        for r in rows:
            print(f"    {kernel:10s} {r['shape']:32s} {r['ms']:.4f} / "
                  f"{r['route_ms']:.4f} ({r['ms'] / r['route_ms']:.3f}x)", flush=True)
        timed = {}                # rows -> the kernel no slower at every shape
        for r in rows:
            m = int(r["shape"].split("=")[-2].split()[0])
            timed[m] = timed.get(m, True) and r["ms"] <= r["route_ms"]
        selected = 128
        for cand in candidates[1:]:
            if all(ok for m, ok in timed.items() if m <= cand):
                selected = cand
            else:
                break
        print(f"    {constant}: the timings select {selected}; the module "
              f"constant is {value}", flush=True)
        out[constant] = dict(selected=selected, constant=value)
    return out


MX_FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")


def _mx_bytes(t) -> int:
    return sum(getattr(t, f).numel() for f in MX_FIELDS)


def _sp_weight(n, k, splits, fp4_only=True):
    from micromix_tpu_torch.mx.mxtensor import quantize_mixed
    return quantize_mixed(torch.randn(n, k, device=DEV) / k ** 0.5, *splits,
                          weight_fp4_only=fp4_only, pack_fp4=True)


def _sp_site_kw(rng, producer, m, k, splits) -> dict:
    if producer == "silu":
        return dict(producer="silu",
                    up=torch.randn(m, k, device=DEV).to(torch.bfloat16))
    kw = dict(perm=_perm(rng, k, splits))
    if producer == "rms":
        kw.update(producer="rms", gamma=1.0 + 0.1 * torch.randn(k, device=DEV),
                  eps=1e-5)
    return kw


def check_quantize(results, timer, rng):
    """Kernel J at the per-consumer decode site (rms, M=8, with the
    gather) and the silu site of a 256-row prefill chunk.  Codes and scale
    bytes bit-exact against the plain version on the card: the rms input
    lies on a grid of 1/4 below 8, so its row moment is exact in any
    summation order; silu's values are the same f32 operations in both.
    And on any input the decoded codes equal the site kernel's image."""
    from micromix_tpu_torch.kernels.fakequant import fakequant_site
    from micromix_tpu_torch.kernels.quantize import (quantize_mixed,
                                                     quantize_mixed_plain)
    from micromix_tpu_torch.mx.mxtensor import dequantize_mixed_device
    for producer, m, k, splits in (("rms", 8, 4096, SPLIT_4096),
                                   ("silu", 256, 14336, SPLIT_14336)):
        if producer == "rms":
            x = (torch.randint(-31, 32, (m, k), device=DEV) / 4.0).to(torch.bfloat16)
        else:
            x = _site_input(m, k)
        kw = _sp_site_kw(rng, producer, m, k, splits)
        got = quantize_mixed(x, *splits, **kw)
        ref = quantize_mixed_plain(x, *splits, **kw)
        diff = sum(int((getattr(got, f) != getattr(ref, f)).sum()) for f in MX_FIELDS)
        xs = _site_input(m, k)
        img_ok = torch.equal(dequantize_mixed_device(quantize_mixed(xs, *splits, **kw)),
                             fakequant_site(xs, *splits, **kw))
        nbytes = (m * k * 2 * (2 if producer == "silu" else 1)
                  + (k * 8 if producer == "rms" else 0) + _mx_bytes(got))
        record(results, "mx_quantize", f"{producer} M={m} K={k}", float(diff),
               "differing code and scale bytes: 0 (bit-exact); decoded codes "
               "== the site kernel's image", diff == 0 and img_ok,
               timer.ms(lambda: quantize_mixed(x, *splits, **kw)), nbytes, 0.0,
               timer.ms(lambda: quantize_mixed_plain(x, *splits, **kw)))


def check_sp_gemm(results, timer):
    """Kernel K on per-consumer decode shapes (fp4-only and symmetric
    weights; a split whose fp4 plane boundary, 1984, is no multiple of
    128) and on prefill chunks' down projections of 128, 256 and 511 rows
    (one, two and four 128-row tiles)."""
    from micromix_tpu_torch.kernels.mixed_matmul import (mixed_matmul_sp,
                                                         mixed_matmul_sp_plain)
    from micromix_tpu_torch.kernels.quantize import quantize_mixed
    from micromix_tpu_torch.mx.mxtensor import dequantize_mixed_device
    for m, n, k, splits, fp4_only, note in (
            (8, 14336, 4096, SPLIT_4096, True, "fp4-only"),
            (8, 14336, 4096, SPLIT_4096, False, "symmetric"),
            (8, 4096, 4096, (3968, 128, 0), True, "k4%256=128"),
            (256, 4096, 14336, SPLIT_14336, True, "tail-chunk down"),
            (128, 4096, 14336, SPLIT_14336, True, "chunk down"),
            (511, 4096, 14336, SPLIT_14336, True, "chunk down")):
        w = _sp_weight(n, k, splits, fp4_only)
        a = quantize_mixed(_site_input(m, k), *splits)
        err, ok = close(mixed_matmul_sp(a, w), mixed_matmul_sp_plain(a, w))
        ad, wd = dequantize_mixed_device(a), dequantize_mixed_device(w)
        record(results, "sp_gemm", f"M={m} N={n} K={k} {note}", err,
               "2^-7|ref|+2^-8max|ref|", ok,
               timer.ms(lambda: mixed_matmul_sp(a, w)),
               _mx_bytes(a) + _mx_bytes(w) + m * n * 2, 2.0 * m * n * k,
               timer.ms(lambda: mixed_matmul_sp_plain(a, w)),
               timer.ms(lambda: torch.matmul(ad, wd.t())))
        del w, wd


def check_sp_stack(results, timer, rng):
    """Kernel L behind the site kernel at the stacked decode sites (M=8):
    q|k|v and gate|up (rms), o (plain, with the gather) and down (silu),
    split-plane weights; and q|k|v and gate|up at a 128-row prefill
    chunk (one 128-row tile).  The site image in the tie band of the plain
    site, the outputs against the plain GEMM on the kernel's own image,
    and bit for bit against Kernel J followed by Kernel K on each section
    (the fakequant-direct equivalence)."""
    from micromix_tpu_torch.kernels.fakequant import (fakequant_site,
                                                      fakequant_site_plain)
    from micromix_tpu_torch.kernels.mixed_matmul import (
        mixed_matmul_sp, mixed_matmul_sp_stack, mixed_matmul_sp_stack_plain,
        sp_stack_gemm_plain)
    from micromix_tpu_torch.kernels.quantize import quantize_mixed
    from micromix_tpu_torch.mx.mxtensor import (dequantize_mixed_device,
                                                section_mixed, stack_split_plane)
    for name, k, splits, ns, producer, m in (
            ("q|k|v", 4096, SPLIT_4096, (4096, 1024, 1024), "rms", 8),
            ("gate|up", 4096, SPLIT_4096, (14336, 14336), "rms", 8),
            ("o", 4096, SPLIT_4096, (4096,), "plain", 8),
            ("down", 14336, SPLIT_14336, (4096,), "silu", 8),
            ("q|k|v", 4096, SPLIT_4096, (4096, 1024, 1024), "rms", 128),
            ("gate|up", 4096, SPLIT_4096, (14336, 14336), "rms", 128)):
        st = stack_split_plane([_sp_weight(n, k, splits) for n in ns])
        x = _site_input(m, k)
        kw = _sp_site_kw(rng, producer, m, k, splits)
        outs = mixed_matmul_sp_stack(x, st, **kw)
        img = fakequant_site(x, *splits, **kw)
        ref_img = fakequant_site_plain(x, *splits, **kw)
        ok_img = (torch.equal(img, ref_img) if producer == "plain"
                  else tie_band(img, ref_img, splits)[1])
        errs = [close(g, r) for g, r in zip(outs, sp_stack_gemm_plain(img, st))]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        codes = quantize_mixed(x, *splits, **kw)
        exact = all(torch.equal(o, mixed_matmul_sp(codes, section_mixed(st, i)))
                    for i, o in enumerate(outs))
        wd = dequantize_mixed_device(st.mt)
        nbytes = (_mx_bytes(st.mt) + m * k * 2 * (1 + (producer == "silu"))
                  + {"rms": k * 8, "plain": k * 4, "silu": 0}[producer]
                  + m * sum(ns) * 2)
        record(results, "sp_stack", f"{name} {producer} M={m} K={k}", err,
               "image in the tie band (bit-exact for plain); outputs "
               "2^-7|ref|+2^-8max|ref| on the kernel's image and bit-exact "
               "against Kernel J + Kernel K per section",
               ok and ok_img and exact,
               timer.ms(lambda: mixed_matmul_sp_stack(x, st, **kw)), nbytes,
               2.0 * m * sum(ns) * k,
               timer.ms(lambda: mixed_matmul_sp_stack_plain(x, st, **kw)),
               timer.ms(lambda: torch.matmul(img, wd.t())))
        del st, wd


# ----------------------------------------------------------------- phase 3

def params_to(params, device):
    """Copy a quantized parameter dict to another device."""
    def move(x):
        if x is None or isinstance(x, (int, float, str)):
            return x
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        return dataclasses.replace(x, **{f.name: move(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return move(params)


def phase3() -> dict:
    """Card against CPU on 2-layer full-width stacked models: a 300-token
    prompt prefilled in chunks of 128 (flash, then paged history), then
    greedy decode steps: Llama-3.1-8B, 8 steps through the residual pairs,
    also with a 256-token sliding window; Mixtral-8x7B (experts grouped, dense dispatch), 4 steps through the
    grouped expert GEMMs (the CPU side dequantizes 1.4 G codes per layer
    and unit).

    The windowed Llama is also served by the default engine on the card.
    Each chunk and each decode step runs on the card and on the CPU from
    the same state: the card's KV cache, copied to the CPU just before,
    and the same tokens; the card then goes on from its own result.  A
    random fp4-activation model amplifies a last-bit difference that
    crosses a rounding boundary (a RoPE table or attention output one ulp
    off, as CUDA's and the CPU's cos, exp and f32 sums give) into a change
    of a sizable fraction of the logit range, and over a whole 300-token
    run such changes compound until the greedy paths part.  Starting
    every unit from one state keeps each comparison to that unit's own
    arithmetic.  The greedy token of the last chunk and of every decode
    step must be equal.  Logits: within 0.5 of the CPU's logit range.  On
    the H100 a Llama unit without such a crossing agreed to about 3e-7 of
    the range, a decode step's single row with one to 0.25, a 128-row
    chunk to about 0.12 (this phase's own printout); a kernel that
    computed another function would move them by the order of the range."""
    from micromix_tpu_torch.mx.mxtensor import SplitPlaneStack
    from micromix_tpu_torch.serve.runner import _can_pair
    out = {}
    cfg = llama31_8b(2)
    out["llama"] = card_vs_cpu(cfg, 8, ("flash_attention", "paged_prefill",
                                        "w8_stack", "w8_pair"),
                               lambda p: _can_pair(p, cfg, 1))
    out["mixtral"] = card_vs_cpu(mixtral_8x7b(2), 4,
                                 ("flash_attention", "paged_prefill",
                                  "w8_stack", "w8_grouped"),
                                 lambda p: "experts_grouped" in p["layers"][0])
    out["llama_splitplane"] = card_vs_cpu(
        cfg, 8, ("flash_attention", "paged_prefill", "site_fakequant",
                 "sp_stack"),
        lambda p: (isinstance(p["layers"][0]["qkv_stack"], SplitPlaneStack)
                   and not _can_pair(p, cfg, 1)), layout="splitplane")
    # a 256-token sliding window: the third chunk's queries (H) and every
    # decode step (C, floor position + 1 - 256) drop the oldest tokens; E
    # takes the window too, though a 128-token chunk lies inside it
    # Its last chunk's two top CPU logits lie 0.012 of the range apart (on
    # an H100), a tenth of a chunk's card/CPU difference (0.11-0.14 in
    # every model): there the chunk's greedy token is a coin toss, so it
    # must be one of the CPU's two top tokens; every decode step's must be
    # equal.
    cfg_w = dataclasses.replace(cfg, sliding_window=256)
    out["llama_window"] = card_vs_cpu(
        cfg_w, 8, ("flash_attention", "paged_prefill", "paged_decode",
                   "w8_stack", "w8_pair"),
        lambda p: _can_pair(p, cfg_w, 1), name="llama window 256",
        near_tie=True)
    out["llama_window_engine"] = window_engine(cfg_w)
    return out


def window_engine(cfg) -> dict:
    """The default engine on the card with the windowed 2-layer Llama: a
    300-token prompt in chunks of 128 (E, then H over the history, the
    window applied) beside a 100-token one, 8 new tokens each (C with the
    window)."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    from micromix_tpu_torch.serve.engine import Request
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    rng = np.random.default_rng(SEED + 3)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=8) for i, n in enumerate((300, 100))]
    _, stats = serve(cfg, params, reqs, "phase 3", max_seqs=2, page_size=128,
                     max_pages_per_seq=4, decode_chunk=4, prefill_chunk=128)
    missing = [k for k in ("flash_attention", "paged_prefill", "paged_decode")
               if not stats["launches"].get(k)]
    if missing:
        fail(f"phase 3 (window engine): kernels not launched: {missing}")
    print(f"  llama window {cfg.sliding_window}, the engine on the card: "
          f"{stats['requests_done']} requests of {stats['prompt_tokens']} "
          f"prompt tokens answered, launches {stats['launches']}", flush=True)
    return stats


def card_vs_cpu(cfg, steps: int, must_launch, form_ok, layout="auto",
                name=None, near_tie=False) -> dict:
    """One model of phase 3: its units on the card and on the CPU.  With
    ``near_tie``, a last chunk whose two top CPU logits lie closer than
    that unit's card/CPU difference may give either of the two as its
    greedy token on the card (the decode steps' tokens must be equal)."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model,
                                                   stack_layer_projections)
    from micromix_tpu_torch.serve.kv_cache import make_cache
    from micromix_tpu_torch.serve.runner import decode_step, prefill
    calib = default_calibration(cfg, p6=256, p8=256, seed=SEED)
    gpu_params = stack_layer_projections(
        random_quantized_model(cfg, calib, seed=SEED, device=DEV, layout=layout))
    name = name or f"{cfg.arch} ({layout})"
    if not form_ok(gpu_params):
        fail(f"phase 3 ({name}): the stacked model is not in its serving form")
    cpu_params = params_to(gpu_params, "cpu")
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, 300).tolist()
    ps, chunk = 128, 128
    mp = -(-(len(prompt) + steps + 1) // ps)
    caches = [make_cache(mp + 1, ps, cfg.num_kv_heads, cfg.head_dim, 1, mp,
                         device=DEV) for _ in range(cfg.num_layers)]
    for c in caches:
        c.page_table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
    t0 = time.perf_counter()
    build.reset_launches()
    rels, card, cpu, top2 = [], [], [], []

    def both(fn, *args, **kw):
        """One unit on the card and on a CPU copy of its state: the
        greedy tokens of both."""
        nonlocal caches
        cpu_caches = params_to(caches, "cpu")
        g, caches = fn(gpu_params, cfg, caches, *args, **kw)
        c, _ = fn(cpu_params, cfg, cpu_caches,
                  *[params_to(a, "cpu") for a in args], **kw)
        g, c = g[0].float().cpu(), c[0].float()
        rng_c = float(c.abs().max())
        rels.append(float((g - c).abs().max()) / rng_c)
        t = torch.topk(c, 2)
        top2.append((t.indices.tolist(), float(t.values[0] - t.values[1]) / rng_c))
        return int(torch.argmax(g)), int(torch.argmax(c))

    seq = torch.zeros(1, dtype=torch.int32, device=DEV)
    n_chunks = -(-len(prompt) // chunk)
    for start in range(0, len(prompt), chunk):
        toks = torch.tensor([prompt[start:start + chunk]], device=DEV)
        g_tok, c_tok = both(prefill, toks, 0, start, hist_len=start)
    card.append(g_tok)
    cpu.append(c_tok)
    for i in range(steps):
        g_tok, c_tok = both(decode_step, torch.tensor([card[-1]], device=DEV),
                            seq, torch.tensor([len(prompt) + i], device=DEV))
        card.append(g_tok)
        cpu.append(c_tok)
    launches = dict(build.launches)
    tol = 0.5
    wall = time.perf_counter() - t0
    print(f"  {name}, 2-layer full width, stacked: prompt {len(prompt)} "
          f"tokens in chunks of {chunk}, then {steps} decode steps, each unit "
          f"from the card's state; greedy tokens card {card}, cpu {cpu}; max "
          f"|logit diff| / max |cpu logit| per unit {['%.2e' % r for r in rels]} "
          f"(tolerance {tol}); card launches {launches}; wall {wall:.1f}s",
          flush=True)
    print(f"  {name}: first chunk (Kernel E) error {rels[0]:.4f} of the logit "
          f"range, later chunks (Kernel H) {max(rels[1:n_chunks]):.4f}", flush=True)
    chunk_tie = False
    if near_tie and card[1:] == cpu[1:] and card[0] != cpu[0]:
        (i1, i2), margin = top2[n_chunks - 1]
        chunk_tie = margin < rels[n_chunks - 1] and card[0] == i2
        print(f"  {name}: last chunk's CPU tokens {i1}, {i2} lie {margin:.4f} of "
              f"the range apart, that unit's card/CPU difference "
              f"{rels[n_chunks - 1]:.4f}; the card's token {card[0]}: "
              f"{'accepted as a near tie' if chunk_tie else 'refused'}", flush=True)
    if card != cpu and not chunk_tie:
        fail(f"phase 3 ({name}): greedy tokens differ between the card "
             "and the CPU")
    if max(rels) > tol:
        fail(f"phase 3 ({name}): logit error {max(rels):.3e} over {tol}")
    missing = [n for n in must_launch if not launches.get(n)]
    if missing:
        fail(f"phase 3 ({name}): kernels not launched on the card: {missing}")
    return dict(logit_rel_err=rels, first_chunk_rel_err=rels[0],
                tokens=card, launches=launches, wall_s=wall)


# ----------------------------------------------------------------- phase 4

def decode_window(eng, cfg, steps: int = 8) -> dict:
    """The port's kernel launches per decode step (and per layer) and the
    host ms per step, over one ``decode_multi`` chunk with the engine's
    params, every slot on the scratch row (short contexts); then the
    device busy ms per step (the sum of kernel times under
    ``torch.profiler``) and the largest kernels, over one more chunk."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.serve.runner import decode_multi
    b = eng.max_seqs
    z = torch.zeros(b, dtype=torch.int32, device=DEV)
    seq = torch.full((b,), b, dtype=torch.int32, device=DEV)
    kw = dict(gen=None, temps=torch.zeros(b, device=DEV), top_k=z,
              top_p=torch.ones(b, device=DEV), n_steps=steps,
              sample_mode="greedy")
    decode_multi(eng.params, cfg, eng.caches, z, seq, z, **kw)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    decode_multi(eng.params, cfg, eng.caches, z, seq, z + steps, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    per_step = {k: v / steps for k, v in build.launches.items()}
    total = sum(per_step.values())
    # device busy: the kernels' own times over a third, profiled chunk
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_multi(eng.params, cfg, eng.caches, z, seq, z + 2 * steps, **kw)
        torch.cuda.synchronize()
    per_kernel = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name.split("(")[0][:60]] += e.device_time_total / 1e3
    busy = sum(per_kernel.values()) / steps
    if busy <= 0.0:
        fail("decode window: the profiler saw no device time")
    return dict(ms_per_step=ms, kernel_launches_per_step=total,
                kernel_launches_per_layer_step=total / cfg.num_layers,
                by_kernel=per_step, device_busy_ms_per_step=busy,
                top_device_ms_per_step={k: v / steps for k, v in
                                        per_kernel.most_common(6)})


def serve(cfg, params, reqs, phase="phase 4", **kw):
    """One engine run with the launch counters reset just before it and
    read just after it."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.serve.engine import Engine
    eng = Engine(params, cfg, seed=SEED, device=DEV, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)
    n_new = reqs[0].max_new_tokens
    done = sum(r.done and len(r.output) == n_new for r in reqs)
    out_toks = sum(len(r.output) for r in reqs)
    steps = eng.phase_steps
    stats = dict(
        requests_done=done, tokens_out=out_toks,
        prompt_tokens=[len(r.prompt) for r in reqs],
        prefill_s=eng.phase_s["prefill"], mixed_s=eng.phase_s["mixed"],
        decode_ms_per_step=(1e3 * eng.phase_s["decode"] / steps["decode"]
                            if steps["decode"] else None),
        mixed_ms_per_step=(1e3 * eng.phase_s["mixed"] / steps["mixed"]
                           if steps["mixed"] else None),
        decode_steps=steps, preemptions=eng.preemptions,
        end_to_end_tok_s=out_toks / wall, wall_s=wall,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches)
    if done != len(reqs):
        fail(f"{phase}: {done} of {len(reqs)} requests finished with "
             f"{n_new} tokens")
    for r in reqs:
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            fail(f"{phase}: token out of vocabulary")
    return eng, stats


def phase4(rng) -> dict:
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    from micromix_tpu_torch.serve.engine import Request
    cfg = llama31_8b(32)
    t0 = time.perf_counter()
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng, stats = serve(cfg, params, _traffic(rng, cfg.vocab_size),
                       max_seqs=8, page_size=128,
                       max_pages_per_seq=16, decode_chunk=8, prefill_chunk=512)
    stats["model_build_s"] = build_s
    if "qkv_stack" not in eng.params["layers"][0]:
        fail("phase 4: the default engine did not stack its params")
    missing = [n for n in LLAMA_KERNELS if not stats["launches"].get(n)]
    if missing:
        fail(f"phase 4: kernels never launched on the main path: {missing}")
    if not stats["decode_steps"]["mixed"]:
        fail("phase 4: no prefill chunk rode a decode call")
    stats["decode_window"] = decode_window(eng, cfg)
    print("  stacked, 32 layers: " + json.dumps(stats), flush=True)
    del eng, params
    torch.cuda.empty_cache()

    # the per-consumer form, still driven: 4 layers, PR 1's traffic
    cfg4 = llama31_8b(4)
    params4 = random_quantized_model(
        cfg4, default_calibration(cfg4, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    reqs4 = [Request(i, rng.integers(0, cfg4.vocab_size,
                                     int(rng.integers(96, 129))).tolist(),
                     max_new_tokens=32) for i in range(8)]
    os.environ["MICROMIX_NO_STACK"] = "1"
    try:
        eng4, stats4 = serve(cfg4, params4, reqs4, max_seqs=8, page_size=128,
                             max_pages_per_seq=2, decode_chunk=8)
    finally:
        del os.environ["MICROMIX_NO_STACK"]
    if "qkv_stack" in eng4.params["layers"][0]:
        fail("phase 4: MICROMIX_NO_STACK=1 still stacked the params")
    missing = [n for n in PER_CONSUMER_KERNELS if not stats4["launches"].get(n)]
    if missing:
        fail(f"phase 4: per-consumer kernels never launched: {missing}")
    stats4["decode_window"] = decode_window(eng4, cfg4)
    print("  per-consumer, 4 layers: " + json.dumps(stats4), flush=True)
    print(f"  kernel launches per decode step and layer: stacked "
          f"{stats['decode_window']['kernel_launches_per_layer_step']:.2f}, "
          f"per-consumer "
          f"{stats4['decode_window']['kernel_launches_per_layer_step']:.2f}",
          flush=True)
    return dict(stacked=stats, per_consumer=stats4)


def _traffic(rng, vocab: int, long_lens=None):
    """Phase 4's requests: six of 96-128 prompt tokens, two of 1200-1500
    (``long_lens`` when given), 32 new tokens each."""
    from micromix_tpu_torch.serve.engine import Request
    lens = ([int(rng.integers(96, 129)) for _ in range(6)]
            + (list(long_lens) if long_lens else
               [int(rng.integers(1200, 1501)) for _ in range(2)]))
    return [Request(i, rng.integers(0, vocab, n).tolist(), max_new_tokens=32)
            for i, n in enumerate(lens)]


def phase5(rng) -> dict:
    """Mixtral-8x7B at 32 layers with the default engine (experts grouped
    layer by layer as the model is made, so the card never holds two
    copies of them), then the per-expert form at 2 layers."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    from micromix_tpu_torch.serve.engine import Request
    cfg = mixtral_8x7b(32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    codes_gib = sum(t.numel() for p in params["layers"] for t in (
        p["experts_grouped"]["w13"].codes, p["experts_grouped"]["w2"].codes,
        p["q"].w.codes, p["k"].w.codes, p["v"].w.codes, p["o"].w.codes)) / 2 ** 30
    eng, stats = serve(cfg, params, _traffic(rng, cfg.vocab_size), "phase 5",
                       max_seqs=8, page_size=128, max_pages_per_seq=16,
                       decode_chunk=8, prefill_chunk=512)
    stats.update(model_build_s=build_s, build_peak_mem_gib=build_peak,
                 codes_gib=codes_gib)
    layer0 = eng.params["layers"][0]
    if "experts_grouped" not in layer0 or "qkv_stack" not in layer0:
        fail("phase 5: the default engine did not keep the grouped experts "
             "and stack q|k|v")
    missing = [n for n in MIXTRAL_KERNELS if not stats["launches"].get(n)]
    if missing:
        fail(f"phase 5: kernels never launched on the main path: {missing}")
    if stats["launches"].get("w8_pair"):
        fail("phase 5: a Mixtral decode took the residual pair")
    if not stats["decode_steps"]["mixed"]:
        fail("phase 5: no prefill chunk rode a decode call")
    if stats["peak_mem_gib"] >= 80 or build_peak >= 80:
        fail(f"phase 5: peak memory {stats['peak_mem_gib']:.1f} GiB")
    win = stats["decode_window"] = decode_window(eng, cfg)
    if win["by_kernel"].get("w8_grouped") != 2 * cfg.num_layers:
        fail(f"phase 5: {win['by_kernel'].get('w8_grouped')} grouped calls per "
             f"decode step, not 2 per layer")
    print("  Mixtral-8x7B, default engine, 32 layers: " + json.dumps(stats),
          flush=True)
    del eng, params
    torch.cuda.empty_cache()

    # the per-expert form, still driven: 2 layers, 8 requests of 96-128
    cfg2 = mixtral_8x7b(2)
    params2 = random_quantized_model(
        cfg2, default_calibration(cfg2, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV, group_experts=False)
    reqs2 = [Request(i, rng.integers(0, cfg2.vocab_size,
                                     int(rng.integers(96, 129))).tolist(),
                     max_new_tokens=32) for i in range(8)]
    os.environ["MICROMIX_NO_STACK"] = "1"
    try:
        eng2, stats2 = serve(cfg2, params2, reqs2, "phase 5", max_seqs=8,
                             page_size=128, max_pages_per_seq=2, decode_chunk=8)
    finally:
        del os.environ["MICROMIX_NO_STACK"]
    if "experts" not in eng2.params["layers"][0]:
        fail("phase 5: MICROMIX_NO_STACK=1 grouped the experts")
    missing = [n for n in PER_CONSUMER_KERNELS if not stats2["launches"].get(n)]
    if missing or stats2["launches"].get("w8_grouped"):
        fail(f"phase 5: the per-expert form launched {stats2['launches']}")
    stats2["decode_window"] = decode_window(eng2, cfg2)
    print("  Mixtral per-expert, 2 layers: " + json.dumps(stats2), flush=True)
    del eng2, params2
    torch.cuda.empty_cache()
    return dict(grouped=stats, per_expert=stats2)


def phase6() -> dict:
    """Llama-3.1-8B in the split-plane layout: the default engine at 32
    layers (SplitPlaneStacks, the unpaired decode loop), then the
    per-consumer engine at 4 layers.  Its own generator: the long prompts
    are 1200-1280 tokens (last chunk padded to 256 rows: the silu quantize
    and Kernel K) and 1281-1500 (padded to 512: both operands dequantized,
    one dense product)."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    from micromix_tpu_torch.mx.mxtensor import SplitPlaneStack
    from micromix_tpu_torch.serve.engine import Request
    from micromix_tpu_torch.serve.runner import _can_pair
    rng = np.random.default_rng(SEED + 6)
    cfg = llama31_8b(32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV, layout="splitplane")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ws = [p[n].w for p in params["layers"]
          for n in ("q", "k", "v", "o", "gate", "up", "down")]
    code_bytes = sum(_mx_bytes(w) for w in ws)
    w8_bytes = sum(w.rows * w.k for w in ws)     # ScaledW8: a byte a weight
    long_lens = (int(rng.integers(1200, 1281)), int(rng.integers(1281, 1501)))
    eng, stats = serve(cfg, params, _traffic(rng, cfg.vocab_size, long_lens),
                       "phase 6", max_seqs=8, page_size=128,
                       max_pages_per_seq=16, decode_chunk=8, prefill_chunk=512)
    stats.update(model_build_s=build_s, build_peak_mem_gib=build_peak,
                 code_bytes=code_bytes, scaledw8_code_bytes=w8_bytes,
                 code_bytes_ratio=code_bytes / w8_bytes)
    if not isinstance(eng.params["layers"][0].get("qkv_stack"), SplitPlaneStack):
        fail("phase 6: the default engine did not build SplitPlaneStacks")
    if _can_pair(eng.params, cfg, 8):
        fail("phase 6: split-plane params took the residual pair")
    missing = [n for n in SPLITPLANE_KERNELS if not stats["launches"].get(n)]
    w8 = [n for n in stats["launches"] if n.startswith("w8_")]
    if missing or w8:
        fail(f"phase 6: kernels not launched {missing}, ScaledW8 kernels "
             f"launched {w8}")
    if not stats["decode_steps"]["mixed"]:
        fail("phase 6: no prefill chunk rode a decode call")
    if code_bytes > 0.6 * w8_bytes:
        fail(f"phase 6: split-plane codes {code_bytes} B over 0.6x the "
             f"ScaledW8 model's {w8_bytes} B")
    stats["decode_window"] = decode_window(eng, cfg)
    print("  split-plane, stacked, 32 layers: " + json.dumps(stats), flush=True)
    del eng, params, ws
    torch.cuda.empty_cache()

    cfg4 = llama31_8b(4)
    params4 = random_quantized_model(
        cfg4, default_calibration(cfg4, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV, layout="splitplane")
    reqs4 = [Request(i, rng.integers(0, cfg4.vocab_size,
                                     int(rng.integers(96, 129))).tolist(),
                     max_new_tokens=32) for i in range(8)]
    os.environ["MICROMIX_NO_STACK"] = "1"
    try:
        eng4, stats4 = serve(cfg4, params4, reqs4, "phase 6", max_seqs=8,
                             page_size=128, max_pages_per_seq=2, decode_chunk=8)
    finally:
        del os.environ["MICROMIX_NO_STACK"]
    if "qkv_stack" in eng4.params["layers"][0]:
        fail("phase 6: MICROMIX_NO_STACK=1 still stacked the params")
    missing = [n for n in SPLITPLANE_PER_CONSUMER_KERNELS
               if not stats4["launches"].get(n)]
    w8 = [n for n in stats4["launches"] if n.startswith("w8_")]
    if missing or w8:
        fail(f"phase 6: per-consumer kernels not launched {missing}, "
             f"ScaledW8 kernels launched {w8}")
    stats4["decode_window"] = decode_window(eng4, cfg4)
    print("  split-plane, per-consumer, 4 layers: " + json.dumps(stats4),
          flush=True)
    print(f"  kernel launches per decode step and layer: stacked "
          f"{stats['decode_window']['kernel_launches_per_layer_step']:.2f}, "
          f"per-consumer "
          f"{stats4['decode_window']['kernel_launches_per_layer_step']:.2f}",
          flush=True)
    del eng4, params4
    torch.cuda.empty_cache()
    return dict(stacked=stats, per_consumer=stats4)


# name -> (source, TPU kernel it replaces, shape reported in the JSON line)
KERNELS = {
    "site_fakequant": ("micromix_tpu_torch/csrc/site_fakequant.cu",
                       "micromix_tpu/kernels/fakequant.py:103",
                       "rms M=8 K=4096"),
    "w8_gemm": ("micromix_tpu_torch/csrc/w8_gemm.cu",
                "micromix_tpu/kernels/mixed_matmul.py:253",
                "M=8 N=14336 K=4096"),
    "paged_decode": ("micromix_tpu_torch/csrc/paged_decode.cu",
                     "micromix_tpu/serve/attention.py:201", "B=8"),
    "append_kv": ("micromix_tpu_torch/csrc/append_kv.cu",
                  "micromix_tpu/serve/append_kernel.py:88", "T=8"),
    "flash_attention": ("micromix_tpu_torch/csrc/flash_attention.cu",
                        "micromix_tpu/kernels/flash_attention.py:138",
                        "B=8 S=128"),
    "w8_stack": ("micromix_tpu_torch/csrc/w8_stack.cu",
                 "micromix_tpu/kernels/mixed_matmul.py:554", "q|k|v rms M=8"),
    "w8_pair": ("micromix_tpu_torch/csrc/w8_pair.cu",
                "micromix_tpu/kernels/mixed_matmul.py:760", "o_gateup M=8"),
    "paged_prefill": ("micromix_tpu_torch/csrc/paged_prefill.cu",
                      "micromix_tpu/serve/prefill_attention.py:174",
                      "S=512 hist=1536"),
    "w8_grouped": ("micromix_tpu_torch/csrc/w8_grouped.cu",
                   "micromix_tpu/kernels/mixed_matmul.py:1160",
                   "w13 plain E=8 C=8"),
    "mx_quantize": ("micromix_tpu_torch/csrc/mx_quantize.cu",
                    "micromix_tpu/kernels/quantize.py:65", "rms M=8 K=4096"),
    "sp_gemm": ("micromix_tpu_torch/csrc/sp_gemm.cu",
                "micromix_tpu/kernels/mixed_matmul.py:1263",
                "M=8 N=14336 K=4096 fp4-only"),
    "sp_stack": ("micromix_tpu_torch/csrc/sp_stack.cu",
                 "micromix_tpu/kernels/mixed_matmul.py:992",
                 "gate|up rms M=8"),
}
# the kernels each path must launch: the default Llama engine (phase 4),
# the default Mixtral engine (phase 5: experts grouped, no residual pair),
# and the per-consumer and per-expert forms (MICROMIX_NO_STACK=1: the
# site, the per-consumer GEMM and the attention kernels)
LLAMA_KERNELS = ("site_fakequant", "w8_gemm", "paged_decode", "append_kv",
                 "flash_attention", "w8_stack", "w8_pair", "paged_prefill")
MIXTRAL_KERNELS = ("site_fakequant", "w8_gemm", "w8_stack", "w8_grouped",
                   "paged_decode", "append_kv", "flash_attention",
                   "paged_prefill")
PER_CONSUMER_KERNELS = ("site_fakequant", "w8_gemm", "paged_decode",
                        "append_kv", "flash_attention")
# the split-plane engines (phase 6): the default one stacks q|k|v and
# gate|up (A + L at decode; J + K for a 256-row chunk's down), the
# per-consumer one quantizes each site with J for K (o and down: A + L)
SPLITPLANE_KERNELS = ("site_fakequant", "sp_stack", "sp_gemm", "mx_quantize",
                      "paged_decode", "append_kv", "flash_attention",
                      "paged_prefill")
SPLITPLANE_PER_CONSUMER_KERNELS = ("mx_quantize", "sp_gemm", "sp_stack",
                                   "site_fakequant", "paged_decode",
                                   "append_kv", "flash_attention")


def kernel_line(results, launches) -> dict:
    out = []
    for name, (src, replaces, shape) in KERNELS.items():
        rows = [r for r in results if r["kernel"] == name]
        rep = next(r for r in rows if r["shape"].startswith(shape))
        out.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                        launches=launches.get(name, 0),
                        max_abs_err=max(r["max_abs_err"] for r in rows),
                        ms=rep["ms"], plain_ms=rep["plain_ms"],
                        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
                        library_ms=rep["library_ms"]))
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from micromix_tpu_torch.kernels import build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else name
    print(card, flush=True)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc}, {name}", flush=True)

    print(f"phase 1: built {len(build.SOURCES)} kernels in "
          f"{build.build():.1f}s", flush=True)

    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results = []
    timer = Timer()
    print("phase 2: kernels against their plain versions on the card", flush=True)
    check_site(results, timer, rng)
    check_gemm(results, timer)
    check_decode(results, timer, rng)
    check_append(results, timer, rng)
    check_flash(results, timer)
    check_stack(results, timer, rng)
    check_pair(results, timer, rng)
    g_routes = check_residual_routes(results, timer)
    check_prefill(results, timer, rng)
    check_grouped(results, timer, rng)
    routes = route_table(results, card)
    check_quantize(results, timer, rng)
    check_sp_gemm(results, timer)
    check_sp_stack(results, timer, rng)
    del timer
    torch.cuda.empty_cache()

    print("phase 3: 2-layer full-width stacked models, card against CPU",
          flush=True)
    p3 = phase3()
    torch.cuda.empty_cache()

    print("phase 4: the stacked engine at full depth (32 layers) and the "
          "per-consumer engine at 4 layers, 8 requests each", flush=True)
    p4 = phase4(rng)
    torch.cuda.empty_cache()

    print("phase 5: Mixtral-8x7B, the default engine at full depth (32 "
          "layers) and the per-expert engine at 2 layers, 8 requests each",
          flush=True)
    p5 = phase5(rng)
    torch.cuda.empty_cache()

    print("phase 6: split-plane Llama-3.1-8B, the default engine at full "
          "depth (32 layers) and the per-consumer engine at 4 layers, 8 "
          "requests each", flush=True)
    p6 = phase6()

    for label, stats in (("Llama stacked", p4["stacked"]),
                         ("Llama per-consumer", p4["per_consumer"]),
                         ("Mixtral grouped", p5["grouped"]),
                         ("Mixtral per-expert", p5["per_expert"]),
                         ("split-plane stacked", p6["stacked"]),
                         ("split-plane per-consumer", p6["per_consumer"])):
        w = stats["decode_window"]
        print(f"  decode, {label}: engine {stats['decode_ms_per_step']} ms/step; "
              f"decode window {w['ms_per_step']:.3f} ms/step host, "
              f"{w['device_busy_ms_per_step']:.3f} ms/step device busy", flush=True)
    # launches on the main paths: the Llama, Mixtral and split-plane
    # Llama default engines
    main_launches = collections.Counter(p4["stacked"]["launches"])
    main_launches.update(p5["grouped"]["launches"])
    main_launches.update(p6["stacked"]["launches"])
    line = kernel_line(results, main_launches)
    wall = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, checks=results, phase3=p3, phase4=p4,
                       phase5=p5, phase6=p6, routes=routes, g_routes=g_routes,
                       kernels=line["kernels"],
                       wall_s=wall), f,
                  indent=1)
    print(f"chip_smoke: all phases passed in {wall:.1f}s", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
