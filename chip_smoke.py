#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``micromix_tpu_torch``) on one H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's twelve CUDA kernel sources from
``micromix_tpu_torch/csrc/`` and runs these phases; any failure exits
non-zero before the result line.

  0. the card's name and power limit, torch / CUDA / nvcc versions;
  1. build the kernels (one nvcc per source, all at once) and the host
     libraries (``utils/native.py``: g++ of ``csrc/host/*.cpp``);
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
     window, with the ``lengths`` override and the (m, den) state, and at
     the speculative verify's 40 rows (8 sequences x 5 positions under the
     override; D, F at q|k|v and B at o there too), over bf16 pages and
     at Qwen2-7B's 28 / 4 heads (G = 7) on int4 and bf16 pages;
     paged prefill attention (H) at S=512 over int4, int8 and bf16 pages,
     and at G = 3, 5, 6 and 7 (the groups that do not divide 64);
     Kernel A's block-format route (the hetero sites: o's plain site and
     the rms site at 8 rows, the down's silu site, the rms site at 512
     rows; block formats in runs of 1-7 blocks);
     Kernel D's whole append (K's RoPE, quantize, slot index, stores,
     lengths) at T=8 with RoPE and T=1024, int4, int8 and bf16, bit-exact,
     beside the composition the port ran before (``old_path_ms``) and
     with the host time of a call; ``mixed_matmul_w8_site`` (A then B) at
     the last layer's down; then the logit-controls stage and the chosen
     tokens' logprobs (plain PyTorch ops, no kernel) on the card against
     the CPU on the same f32 logits at B=8, V=128256 (controlled logits
     bit-exact, greedy tokens equal, logprobs within 4.3e-5), with each
     part's device ms and CUDA launches;
  3. 2-layer full-width models from one seed, stacked: Llama-3.1-8B
     (ScaledW8, again on int8 KV pages, and with a 256-token sliding
     window), Mixtral-8x7B
     (experts grouped) and Llama-3.1-8B in the split-plane layout: a
     200-token prompt (the windowed model's 300) prefilled in chunks of 128
     (flash, then paged history) and 4 (Mixtral: 2) greedy decode steps
     (ScaledW8 Llama: through the residual pairs), each chunk and step
     with the kernels on the card and with the plain versions on the CPU
     from the same cache state; the greedy tokens must be equal;
  4. serving Llama-3.1-8B at full depth (32 layers, random weights made on
     the card): the default (stacked) engine answers 8 requests, six of
     96-128 and two of 1200-1500 prompt tokens, with prefill_chunk 512
     and 32 new tokens each, so chunked prefill and piggyback run; after
     its measured windows the same engine serves a second batch of 8
     with the request surface (repetition penalty, min-p at temperature
     0.8, min_new_tokens against eos and stop ids, logprobs, an
     ``on_token`` stream, one request cancelled from its own callback;
     stop ids from a probe run of the batch), with its decode ms/step,
     device busy and CUDA launches a step beside the plain batch's; then
     the per-consumer engine (``MICROMIX_NO_STACK=1``) at 4 layers
     answers 8 requests of 96-128 tokens; the default engine decodes
     pipelined, and a window serves 8 greedy and sampled requests with and
     without pipelining, in turns, their token streams equal;
  5. serving Mixtral-8x7B at full depth (32 layers, random weights made
     on the card and grouped layer by layer) with the default engine and
     phase 4's traffic; then the per-expert engine (``MICROMIX_NO_STACK=1``)
     at 2 layers answers 8 requests of 96-128 tokens;
  6. serving Llama-3.1-8B in the split-plane layout
     (``random_quantized_model(layout="splitplane")``) at 32 layers with
     the default engine and phase 4's kind of traffic (one long prompt's
     last chunk pads to 256 rows, the other's to 512, so both sides of
     the 512-row dequantize threshold run); then the per-consumer engine
     at 4 layers, 8 requests of 96-128 tokens;
  7. the dense calibrate -> smooth -> quantize -> perplexity pipeline at
     Llama-3.1-8B widths, 32 layers, dense weights from the seed made on
     the card: calibration on 4 windows of 2048 ``synthetic_tokens``,
     smoothing and quantization layer by layer, dense and quantized
     perplexity on the next 4 windows, with each stage's seconds, the
     average bits and the peak memory; quantized ppl under 1.25 x dense;
     then the same pipeline at 2 layers on the card and on the CPU
     (stats, calibrations, perplexities compared);
  8. the shell at Llama-3.1-8B widths, 4 layers (a full-depth checkpoint
     would write and read 16 GB of bf16; 4 layers write about 3.9 GB):
     an HF checkpoint directory (two shards, the index, a stray file,
     llama3 ``rope_scaling``) written by this script, ``cli.main``
     calibrate, quantize, eval and serve (int4 and int8 KV pages), the
     ApiServer over urllib and a two-replica Router on the checkpoint,
     each held against the model in memory (``phase8``); then serve with
     ``--spec-ngram 2``, with ``--draft-model`` (a dense 2-layer HF
     directory at Llama-3.2-1B widths written by the phase, 0.77 GB) and
     with ``--prefix-cache``, their stats lines checked;
  9. speculative decoding and the prefix cache on the main path's model
     (Llama-3.1-8B widths, 32 layers, int4 pages): ``verify_block`` at
     B=8, gamma 4 against the decode chain, before and after a rollback;
     the draft-model engine (the target's first 4 layers, aliased) and
     the prompt-lookup engine, each emitted token held against the
     target's greedy chain; the prefix-cache engine (7 x 1024 hit tokens,
     an exact replay) (``phase9``);
 10. Qwen2-7B at its published widths and full depth (28 layers; q/k/v
     bias, an untied 152064-row head, 28 / 4 heads): the default engine on
     phase 4's kind of traffic, on int4 and on bf16 KV pages, then 2
     layers card against CPU as phase 3, on both page widths
     (``phase10``);
 11. the other single-card weight forms at Llama-3.1-8B widths, 32
     layers, phase 7's dense model made again from the seed: the hetero
     form (phase 7's calibrations as its budgets),
     weight-only MXFP4 and
     MXFP8 and int8, each served by the default engine on phase 4's
     traffic (A's block-format route only in the hetero run, B in the
     hetero and MXFP4 runs, no plain version), then 2 layers of each card
     against CPU; then the Mixtral calibrate -> smooth -> quantize
     (segmented and hetero) -> perplexity pipeline at Mixtral-8x7B widths,
     4 layers, and the hetero Mixtral serving four requests
     (``phase11``).  Phase 8 also bakes the hetero, weight-only MXFP8 and
     int8 checkpoints through the CLI, each held against the tree made in
     memory, and serves the hetero one under ``--profile``, whose trace
     must name the port's kernels;
 12. tensor and expert parallelism on the one card, two ranks (two
     processes on cuda:0 over gloo, ``parallel.spawn``): B and K with f32
     output against their plain versions at Llama-3.1-8B's tp=2
     row-parallel shard shapes, their bf16 output equal to the f32 one
     rounded, bit for bit; Llama-3.1-8B widths at 8 layers, tp=2, each
     rank quantizing its own shard from the seed with phase 7's first 8
     calibrations, on phase 4's traffic; 2 layers of it card against CPU,
     and at identity calibration with k4-only budgets against the single
     card; the hetero and symmetric-weights forms at 4 layers;
     Mixtral-8x7B widths at 4 layers, ep=2, under dense and capacity
     dispatch, and 2 layers card against CPU; ``cli serve --tp 2`` on
     phase 8's checkpoint (run in phase 8) (``phase12``).  Every rank
     must launch its path's kernels and no plain version, and the ranks'
     streams must be equal; their decode windows count the blocking
     all_reduces a step;
 13. the rest of ``parallel/`` on the one card, 2 and 4 ranks over gloo,
     Llama-3.1-8B widths quantized at ``default_calibration`` (every
     channel MXFP4): the collectives (all_gather, all_to_all, ppermute as
     a ring and a chain) bit-equal to the same ops on CPU tensors, with
     the kinds gloo took through the host; TP v1 at tp=2, 8 layers, B=2 x
     S=256, and at (data=2, model=2), 2 layers, against
     ``forward(attend=causal_attention)``; PP at 32 layers, 2 stages, B=4
     x S=256, bit-equal to 1 stage and against ``forward`` on each
     microbatch; SP gather, ring and Ulysses at 8 layers, sp=2 (S=1536)
     and sp=4 (S=2048), a 512-token window across the shard border, and
     gather and ring at S=8192 on 4 ranks, each variant against the
     reference that computes its function (the ring's attention within an
     ulp of the f32 attention, and a 2-layer dense model for the ring
     through the model); in phase
     8, ``cli serve --tp 2 --port`` (eight completions equal to batch
     mode's, one streamed, one cancelled mid-stream, /metrics) and
     ``--profile`` (a trace a rank) (``phase13``).  Each run prints, per
     rank, host ms, device busy ms, CUDA launches, each collective's
     count and host ms, the launches by kernel and the peak memory;
 14. every head dim and GQA group the port serves (``phase14``): (a)
     Kernels E, H, C and D at head dims 32, 64, 80, 96, 100, 112, 128,
     192 and 256 (the padded widths 64, 128, 256) and C and H at G = 1,
     12, 16, 32 and 64, on int4, int8 and bf16 pages, C's window and
     ``lengths``-override rows, each against its plain version (D
     bit-exact), beside SDPA for E and for H over history dequantized
     beforehand, with ``ptxas -v`` of each instantiation; (b)
     Llama-3.1-405B's published widths (hidden 16384, 128 / 8 heads: G =
     16, intermediate 53248, vocab 128256) at 4 layers of random weights
     through the default engine on phase 4's traffic, int4 and bf16
     pages, then 2 layers of a narrow model with the same G and D card
     against CPU; (c) head dim 96 at Phi-3-mini's widths (32 / 32 heads,
     hidden 3072) and 256 at Gemma-2B's (8 / 1 heads, hidden 2048) served
     the same way at 4 layers, each 2 layers card against CPU; (d)
     ``quantize_model(host=True)`` (the port's native host quantizer) of
     2 layers at Llama-3.1-8B widths held in host memory equal to the
     card's quantizer on the same weights, both timed, and every engine
     of the run on the native page pool (the prefix cache's on its Python
     pool);
 15. Kernel C at every page size the JAX package serves on its chip
     (``phase15a``, ``phase15b``, ``phase15c``): (a) pages of 256, 384,
     512 and 1024 tokens (walked in 128-token stages) against the plain
     version on int4, int8 and bf16 pages at D = 64, 128 and 256, G = 4
     and 16, B=8 over 100-600 tokens and B=1 at 8192, the window and
     ``lengths`` rows at 512, the same rows at 128 beside them, with
     ``ptxas -v`` of C; (b) the default engine at Llama-3.1-8B widths, 4
     layers, on pages of 256 and 512 tokens (phase 4's traffic), then each
     prefill chunk and decode step at 256 and 512 from the state of the
     same run at 128 (its caches re-paged), logits within 0.5 of the
     range; (c) the lm-eval adapter: ``cli eval --tasks`` on phase 8's
     quantized checkpoint under a stand-in ``lm_eval`` (in phase 8; equal
     to ``run_lm_eval`` on the model in memory), ``Scorer`` at
     Llama-3.1-8B widths, 4 layers (loglikelihood, rolling,
     generate_until requests launching A, B and E and no plain version),
     and 2 narrow layers card against CPU;
 16. data-parallel serving over replicas of ranks (``phase16``): 4
     processes on the card over gloo, two replicas of two ranks behind
     ``parallel.ReplicaRouter`` (replica r is ranks 2r, 2r + 1): (a) tp=2
     at Llama-3.1-8B widths, 4 layers, phase 4's eight requests (each
     replica's tokens equal to a lone tp=2 engine's on its requests in
     the same order, ``assigned`` equal to ``Router``'s rule on the
     host); (b) the ``ApiServer`` over such replicas (nine prompts, one
     cut stream, ``/metrics`` against the summed stats); (c) ep=2 at
     Mixtral-8x7B widths, 2 layers, eight requests, tokens equal to a
     lone ep=2 engine's.  Per replica: decode ms a step, a window's host
     and busy ms, control messages, rank 0's host ms a tick.

Every kernel check of phases 2, 12, 14 and 15 calls the kernel twice more on
its inputs and fails unless the results are equal bit for bit
(``record``'s ``rerun``).

In phases 4 to 16 every kernel launch counter is reset just before each
run and read just after; each run must launch every kernel of its path
(the default Mixtral run no residual pair, the split-plane runs no
ScaledW8 kernel, phase 11's forms no kernel off their own path), and no
run may take the plain PyTorch append or the pre-quantized one (nor, in
phase 11, A's or B's plain version; in phases 12, 13 and 16, A's, B's,
E's, J's or K's).
Every pipelined decode dispatch of a single-card engine (phases 4-11)
runs under ``torch.cuda.set_sync_debug_mode("error")``: a stream
synchronize or a blocking copy there fails the run.  Phase 12's do not:
gloo's all_reduce of a CUDA tensor blocks on a copy to the host.  Kernel launches per decode step
and layer, host ms,
device busy ms and all CUDA launches per step (``torch.profiler``) are
taken for every form.  It prints the per-kernel JSON line, and last
``{"ok": true, "device": ...}``.  Per-shape results also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits with
status 2 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_S = 989e12        # H100 SXM dense bf16 tensor cores
PEAK_F32_S = 67e12          # H100 SXM f32 outside the tensor cores
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


def qwen2_7b(num_layers: int):
    """Qwen/Qwen2-7B's published config.json widths (q/k/v bias, an
    untied head, ``use_sliding_window`` false); depth as given."""
    from micromix_tpu_torch.models.common import ModelConfig
    return ModelConfig(arch="qwen2", vocab_size=152064, hidden_size=3584,
                       intermediate_size=18944, num_layers=num_layers,
                       num_heads=28, num_kv_heads=4, head_dim=128,
                       rope_theta=1e6, rms_eps=1e-6, qkv_bias=True,
                       tie_embeddings=False, max_position_embeddings=131072)


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


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_S):
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _same_bits(a, b) -> bool:
    """Two results (tensors, nested in tuples / lists / dataclasses) equal
    bit for bit."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same_bits(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))
    return a == b


def record(results, kernel, shape, err, tol, ok, t, nbytes, flops,
           plain_ms, library_ms=None, flops_peak=PEAK_BF16_S, rerun=None,
           **extra):
    """One kernel check; ``extra``: other measured times of the shape
    (yardsticks that are not the same function), printed and kept.
    ``flops_peak``: the card's rate for the type of the operations.
    ``rerun``: the kernel's call, made twice more on the same inputs:
    its results must be equal bit for bit (run-to-run determinism)."""
    if rerun is not None:
        extra["repeat_bit_equal"] = _same_bits(rerun(), rerun())
        if not extra["repeat_bit_equal"]:
            fail(f"{kernel} {shape}: two calls on the same inputs differ")
    bms, by = bound(nbytes, flops, flops_peak)
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


def block_tie_band(got, ref, fmt):
    """``tie_band`` for a canonical-order site image whose 32-block b has
    format ``fmt[b]`` (the hetero sites)."""
    g, r = got.float(), ref.float()
    diff = g != r
    gb, rb = g.reshape(g.shape[0], -1, 32), r.reshape(r.shape[0], -1, 32)
    bmax = torch.maximum(gb.abs().amax(-1), rb.abs().amax(-1)).clamp_min(1e-30)
    mant = (fmt.long() + 1).to(torch.float32)[None, :]
    step = torch.exp2(torch.floor(torch.log2(bmax)) - mant)
    ok = (float(diff.float().mean()) <= 1e-3
          and bool(((gb - rb).abs() <= step[..., None]).all()))
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
                   timer.ms(lambda: fakequant_site_plain(x, *splits, **kw)),
           rerun=lambda: fakequant_site(x, *splits, **kw))
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
               timer.ms(lambda: fakequant_site_plain(x, *splits, **kw)),
           rerun=lambda: fakequant_site(x, *splits, **kw))


def _block_formats(rng, k: int) -> torch.Tensor:
    """A (K / 32,) int32 block_fmt in runs of 1-7 blocks (32-224
    channels, so most runs are not multiples of 128) of formats drawn in
    turn, every format present."""
    fmt, run = [], 0
    while len(fmt) < k // 32:
        f = run if run < 3 else int(rng.integers(0, 3))
        fmt += [f] * int(rng.integers(1, 8))
        run += 1
    return torch.tensor(fmt[:k // 32], dtype=torch.int32, device=DEV)


def check_site_blocks(results, timer, rng):
    """Kernel A's block-format route (the hetero sites) against its plain
    version: o's plain site (perm) and the q|k|v rms site at decode rows,
    the down's silu site, the rms site of a 512-row chunk.  Plain images
    bit-exact, rms and silu within the tie band of each block's format."""
    from micromix_tpu_torch.kernels.fakequant import (
        fakequant_site_blocks, fakequant_site_blocks_plain)
    for producer, m, k in (("plain", 8, 4096), ("rms", 8, 4096),
                           ("silu", 8, 14336), ("rms", 512, 4096)):
        x = _site_input(m, k)
        fmt = _block_formats(rng, k)
        kw, aux = {}, 0
        if producer == "silu":
            kw = dict(producer="silu",
                      up=torch.randn(m, k, device=DEV).to(torch.bfloat16))
            aux = m * k * 2
        else:
            kw["perm"] = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(DEV)
            aux = k * 4
        if producer == "rms":
            kw.update(producer="rms", eps=1e-5,
                      gamma=1.0 + 0.1 * torch.randn(k, device=DEV))
            aux += k * 4
        got = fakequant_site_blocks(x, fmt, **kw)
        ref = fakequant_site_blocks_plain(x, fmt, **kw)
        if producer == "plain":
            err = float((got.float() - ref.float()).abs().max())
            ok, tol = err == 0.0, "bit-exact"
        else:
            (err, ok), tol = block_tie_band(got, ref, fmt), "tie band"
        runs = int((fmt[1:] != fmt[:-1]).sum()) + 1
        record(results, "site_fakequant_blocks",
               f"{producer} M={m} K={k} ({runs} format runs)", err, tol, ok,
               timer.ms(lambda: fakequant_site_blocks(x, fmt, **kw)),
               2 * m * k * 2 + aux + k // 8, 0.0,
               timer.ms(lambda: fakequant_site_blocks_plain(x, fmt, **kw)),
           rerun=lambda: fakequant_site_blocks(x, fmt, **kw))


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
        rows = ((8, 40, 128, 512) if (n, k) == (4096, 4096) else (8, 128, 512)) \
            + ((1023, 1024, 2048) if n == 4096 else ())
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
                   timer.ms(lambda: torch.matmul(a, wd.t())), **extra,
           rerun=lambda: mixed_matmul_w8(a, w))
        del w, wd


def _decode_cache(rng, b, mp, bits=4, ps=128, hkv=8, d=128):
    """b rows of mp random pages each (codes, scales in [0.01, 0.1],
    integer zero points as kv_quantize makes them, a shuffled table; bf16
    pages hold normal values)."""
    from micromix_tpu_torch.serve.kv_cache import make_cache
    cache = make_cache(b * mp + 1, ps, hkv, d, b, mp, bits=bits, device=DEV)
    for codes in (cache.k_codes, cache.v_codes):
        if bits == 16:
            codes.copy_(torch.randn(codes.shape, device=DEV))
        else:
            codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.01, 0.1)
        sz[:, :, 1].copy_(torch.randint(0, 2 ** min(bits, 8), sz[:, :, 1].shape,
                                        device=DEV))
    cache.page_table.copy_(torch.from_numpy(
        1 + rng.permutation(b * mp).reshape(b, mp).astype(np.int32)))
    return cache


def _page_bytes(bits: int, d: int) -> int:
    """Bytes a token and KV head of K (or V) take in pages that a kernel
    reads: the codes and the [scale, zero] pair; bf16 pages the values
    alone (their pairs are not read)."""
    return 2 * d if bits == 16 else (d // 2 if bits == 4 else d) + 4


def check_decode(results, timer, rng):
    """Kernel C at the main path's decode (B=8, 100-600 tokens), at long
    contexts (B=8 at 2048 and 4096 tokens, B=1 at 8192: 64 pages), over
    int8 pages, with a 1024-token window at 4096, with the ``lengths``
    override (8 rows of one 4096-token sequence at successive positions)
    and the (m, den) state: m within 2^-16 max(1, |m|), den within 2^-12
    relative (f32 sums in another order), at the speculative verify's
    shape (phase 9: gamma 4, 8 sequences of 100-600 tokens, 5 rows each at
    their last 5 positions, 40 rows under the override), over bf16 pages
    and at Qwen2-7B's heads (28 over 4 KV heads: G = 7) on int4 and bf16
    pages.  The bound counts every K/V code and [scale, zero]
    pair (bf16 pages: every value) of each sequence's attended range
    once, q and the output."""
    from micromix_tpu_torch.models.common import rope_inv_freq
    from micromix_tpu_torch.serve.attention import (
        decode_split, paged_decode_attention, paged_decode_attention_plain)
    d, ps = 128, 128
    inv = rope_inv_freq(d, 500000.0, LLAMA3_SCALING, device=DEV)
    short = np.linspace(100, 600, 8)
    cases = (("len 100..600", 8, short, 4, None, None),
             ("len 2048", 8, np.full(8, 2048), 4, None, None),
             ("len 4096", 8, np.full(8, 4096), 4, None, None),
             ("len 8192", 1, np.full(1, 8192), 4, None, None),
             ("len 100..600 int8", 8, short, 8, None, None),
             ("len 4096 window 1024", 8, np.full(8, 4096), 4, 1024, None),
             ("lengths 4089..4096 state", 8, np.arange(4089, 4097), 4, None, "one"),
             ("verify 8x5 len 100..600", 40,
              (short.astype(int)[:, None] + np.arange(-4, 1)[None]).reshape(-1),
              4, None, "verify"),
             ("len 100..600 bf16", 8, short, 16, None, None),
             ("len 4096 bf16", 8, np.full(8, 4096), 16, None, None))
    cases = [c + (32, 8) for c in cases] + [
        ("len 100..600", 8, short, 4, None, None, 28, 4),
        ("len 100..600 bf16", 8, short, 16, None, None, 28, 4)]
    for label, b, lengths, bits, window, override, h, hkv in cases:
        lengths = lengths.astype(np.int32)
        mp = -(-int(lengths.max()) // ps)
        seqs = {None: b, "one": 1, "verify": b // 5}[override]
        cache = _decode_cache(rng, seqs, mp, bits, hkv=hkv)
        seq = torch.arange(b, device=DEV, dtype=torch.int32)
        if override:      # rows of a sequence at successive positions
            seq = seq // (b // seqs)
            cache.lengths.copy_(torch.from_numpy(
                lengths.reshape(seqs, -1).max(axis=1)))
        else:
            cache.lengths.copy_(torch.from_numpy(lengths))
        q = torch.randn(b, h, d, device=DEV).to(torch.bfloat16)
        pos = torch.from_numpy(lengths - 1).to(DEV)
        kw = dict(rope_positions=pos, rope_inv_freq=inv, sliding_window=window)
        pkw = {}
        if override:
            kw.update(lengths=torch.from_numpy(lengths).to(DEV),
                      with_state=override == "one")
            pkw = dict(lengths=kw["lengths"], with_state=override == "one")
        run = lambda: paged_decode_attention(q, cache, seq, **kw)
        plain = lambda: paged_decode_attention_plain(q, cache, seq, window, pos,
                                                     inv, **pkw)
        got, ref = run(), plain()
        tol = "2^-7|ref|+2^-8max|ref|"
        if override == "one":
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
        # the function's inputs read once: each sequence's attended pages
        read = int(attended.reshape(seqs, -1).max(axis=1).sum())
        nbytes = 2 * b * h * d * 2 + 2 * read * hkv * _page_bytes(bits, d) + b * mp * 4
        splits, pps = decode_split(b, hkv, mp)
        record(results, "paged_decode", f"B={b} H={h} Hkv={hkv} D={d} {label}",
               err, tol, ok, timer.ms(run), nbytes, 4.0 * tokens * h * d,
               timer.ms(plain), grid_splits=splits, pages_per_split=pps,
           rerun=run)
        del cache


KV_FIELDS = ("k_codes", "v_codes", "k_sz", "v_sz", "lengths")


def appended(state, fn) -> list:
    """``fn`` (an append) applied to a copy of ``state``, a cache (its
    pages and lengths) or a list of page tensors: the copy's tensors."""
    if isinstance(state, list):
        copy = [p.clone() for p in state]
        fn(copy)
        return copy
    copy = dataclasses.replace(state, **{n: getattr(state, n).clone()
                                         for n in KV_FIELDS})
    fn(copy)
    return [getattr(copy, n) for n in KV_FIELDS]


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
               timer.ms(lambda: append_kv_plain(*ref, *args)),
               rerun=lambda: appended(list(pages),
                                      lambda c: append_kv_kernel(*c, *args)))


def _append_cache(rng, bits, seqs, mp, hkv=8, d=128, ps=128):
    """seqs rows of mp pages each (a shuffled table) with random page
    contents; lengths 0."""
    from micromix_tpu_torch.serve.kv_cache import make_cache
    cache = make_cache(seqs * mp + 1, ps, hkv, d, seqs, mp, bits=bits, device=DEV)
    for a in (cache.k_codes, cache.v_codes):
        a.random_(0, 256)
    for a in (cache.k_sz, cache.v_sz):
        a.copy_(torch.randn(a.shape, device=DEV))
    cache.page_table.copy_(torch.from_numpy(
        1 + rng.permutation(seqs * mp).reshape(seqs, mp).astype(np.int32)))
    return cache


def _old_append(cache, seq, pos, k, v, rope):
    """The append as the port ran it before Kernel D took the whole
    function: K's RoPE (decode), ``kv_quantize`` of K and V, the slot
    index and the [scale, zero] stacks in PyTorch, Kernel D's store of
    pre-quantized columns (``append_kv_kernel``), then ``scatter_reduce_``."""
    from micromix_tpu_torch.serve.append_kernel import append_kv_kernel
    from micromix_tpu_torch.serve.kv_cache import kv_quantize, rope_rows
    if rope is not None:
        k = rope_rows(k, *rope)
    kq, ks, kz = kv_quantize(k, cache.bits)
    vq, vs, vz = kv_quantize(v, cache.bits)
    pos, seq = pos.to(torch.long), seq.to(torch.long)
    page_id = cache.page_table[seq, pos // cache.page_size]
    off = (pos % cache.page_size).to(torch.int32)
    append_kv_kernel(cache.k_codes, cache.v_codes, cache.k_sz, cache.v_sz,
                     page_id, off, kq, vq, torch.stack([ks, kz], dim=-1),
                     torch.stack([vs, vz], dim=-1))
    cache.lengths.scatter_reduce_(0, seq, (pos + 1).to(torch.int32), reduce="amax")


def host_ms(fn, iters: int = 20) -> float:
    """Host milliseconds a call takes to enqueue its work (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def check_append_quant(results, timer, rng):
    """Kernel D's whole append (``kv_cache.append_kv``: K's RoPE at decode,
    ``kv_quantize``, the slot index, the stores, the ``lengths`` max) in
    int4 and int8 at decode (T=8: one token per sequence, K and V column
    views of a q|k|v output, RoPE tables from the positions), int4 at the
    speculative verify's rows (T=40: 8 sequences x 5 successive positions,
    with RoPE) and at prefill (T=1024: 8 sequences x 128 positions from
    0), bit-exact against its
    plain version (codes, [scale, zero] as int16 bits, lengths), timed
    beside it, beside the old composition (``old_path_ms``) and with the
    host time of a call for both (``host_ms``, ``old_path_host_ms``); and
    on bf16 pages (the rotated values and [1, 0] stored) at T=8 with RoPE
    and T=1024, where no old composition existed.  The bound
    counts K and V, the RoPE tables, the indices, the page-table entries
    and lengths the tokens touch once, and the codes (values) and pairs
    written; or about 7 f32 operations an element (4 more for K's RoPE;
    bf16 pages: those 4 alone) at 67 TFLOP/s, whichever is larger."""
    from micromix_tpu_torch.models.common import rope_inv_freq
    from micromix_tpu_torch.serve.kv_cache import append_kv, append_kv_plain
    hkv, d, ps = 8, 128, 128
    inv = rope_inv_freq(d, 500000.0, LLAMA3_SCALING, device=DEV)
    for bits in (4, 8, 16):
        shapes = ((8, "rope"), (40, "verify"), (1024, "prefill"))
        for t, label in shapes if bits == 4 else shapes[::2]:
            seqs, mp = (8, 1) if label == "prefill" else (8, 4)
            cache = _append_cache(rng, bits, seqs, mp)
            if label != "prefill":
                rows = t // seqs
                seq = torch.arange(8, device=DEV,
                                   dtype=torch.int32).repeat_interleave(rows)
                start = rng.integers(0, mp * ps - rows + 1, 8)
                pos = torch.from_numpy((start[:, None] + np.arange(rows)[None])
                                       .reshape(-1).astype(np.int32)).to(DEV)
                qkv = torch.randn(t, 48 * d, device=DEV).to(torch.bfloat16)
                k = qkv[:, 32 * d:40 * d].unflatten(1, (hkv, d))
                v = qkv[:, 40 * d:].unflatten(1, (hkv, d))
                ang = pos.float()[:, None] * inv[None, :]
                ang = torch.cat([ang, ang], dim=-1)
                rope = (torch.cos(ang), torch.sin(ang))
            else:
                seq = torch.arange(8, device=DEV, dtype=torch.int32).repeat_interleave(128)
                pos = torch.arange(128, device=DEV, dtype=torch.int32).repeat(8)
                k, v = (torch.randn(t, hkv, d, device=DEV).to(torch.bfloat16)
                        for _ in range(2))
                rope = None
            cache.lengths.copy_(torch.randint(0, 100, (seqs,), device=DEV,
                                              dtype=torch.int32))
            got, ref, old = (dataclasses.replace(cache, **{
                n: getattr(cache, n).clone() for n in ("k_codes", "v_codes",
                                                       "k_sz", "v_sz", "lengths")})
                for _ in range(3))
            append_kv(got, seq, pos, k, v, rope=rope)
            append_kv_plain(ref, seq, pos, k, v, rope=rope)
            err = 0.0
            for n in ("k_codes", "v_codes", "k_sz", "v_sz", "lengths"):
                g, r = getattr(got, n), getattr(ref, n)
                if g.dtype == torch.bfloat16:
                    g, r = g.view(torch.int16), r.view(torch.int16)
                err = max(err, float((g.float() - r.float()).abs().max()))
            slots = len(set((seq.long() * mp + pos.long() // ps).tolist()))
            nbytes = (2 * t * hkv * d * 2 + (2 * t * d * 4 if rope else 0)
                      + 2 * t * 4 + slots * 4 + seqs * 8
                      + 2 * t * hkv * _page_bytes(bits, d)
                      + (2 * t * hkv * 4 if bits == 16 else 0))
            ops = t * hkv * d * ((0 if bits == 16 else 7 * 2) + (4 if rope else 0))
            extra = dict(host_ms=host_ms(lambda: append_kv(got, seq, pos, k, v,
                                                           rope=rope)))
            if bits != 16:
                extra.update(
                    old_path_ms=timer.ms(lambda: _old_append(old, seq, pos, k, v, rope)),
                    old_path_host_ms=host_ms(lambda: _old_append(old, seq, pos, k, v,
                                                                  rope)))
            width = "bf16" if bits == 16 else f"int{bits}"
            record(results, "append_kv_quant",
                   f"T={t} Hkv={hkv} D={d} {width} {label}", err,
                   "bit-exact (sz as int16 bits)", err == 0.0,
                   timer.ms(lambda: append_kv(got, seq, pos, k, v, rope=rope)),
                   nbytes, ops,
                   timer.ms(lambda: append_kv_plain(ref, seq, pos, k, v, rope=rope)),
                   flops_peak=PEAK_F32_S,
                   rerun=lambda: appended(cache, lambda c: append_kv(
                       c, seq, pos, k, v, rope=rope)), **extra)
            del cache, got, ref, old


def check_site_gemm(results, timer):
    """``mixed_matmul_w8_site`` (row 2 of the TPU kernel table: Kernel A
    then Kernel B) at the last layer's down, silu M=8 K=14336 -> N=4096:
    the site image within the tie band of the plain site's, the product
    against the plain GEMM on that image; timed whole (two launches)."""
    from micromix_tpu_torch.kernels.fakequant import fakequant_site_plain
    from micromix_tpu_torch.kernels.mixed_matmul import (mixed_matmul_w8_plain,
                                                         mixed_matmul_w8_site)
    m, n, k = 8, 4096, 14336
    w = _w8_weight(n, k, SPLIT_14336)
    x, up = (_site_input(m, k) for _ in range(2))
    y, qx = mixed_matmul_w8_site(x, w, producer="silu", up=up, emit_qx=True)
    band_err, band_ok = tie_band(qx, fakequant_site_plain(
        x, *SPLIT_14336, producer="silu", up=up), SPLIT_14336)
    err, ok = close(y, mixed_matmul_w8_plain(qx, w))

    def plain():
        return mixed_matmul_w8_plain(fakequant_site_plain(
            x, *SPLIT_14336, producer="silu", up=up), w)

    record(results, "w8_site", f"silu M={m} N={n} K={k}", max(err, band_err),
           "site: tie band; GEMM: 2^-7|ref|+2^-8max|ref|", ok and band_ok,
           timer.ms(lambda: mixed_matmul_w8_site(x, w, producer="silu", up=up)),
           2 * m * k * 2 + n * k + m * n * 2, 2.0 * m * n * k, timer.ms(plain),
           rerun=lambda: mixed_matmul_w8_site(x, w, producer="silu", up=up))
    del w


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
               timer.ms(lambda: flash_attention_plain(q, k, v)), lib,
           rerun=lambda: flash_attention(q, k, v))


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


STACK_ROWS = {"q|k|v": (8, 40, 100, 128, 256, 512, 1023),
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
                   timer.ms(lambda: torch.matmul(img, wd.t())), **extra,
           rerun=lambda: mixed_matmul_w8_stack(x, st, **kw))
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
               residual_library_ms=timer.ms(lambda: torch.addmm(h, img_a, wd.t())),
           rerun=lambda: mixed_matmul_w8_pair(x, h, wa, st, **kw))
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
    history positions of int4 pages, and over 1024 and 1536 of int8
    pages) and over no history.  At hist 0 it computes what SDPA computes
    (causal attention over the chunk's own bf16 K/V, GQA): that call, in
    the (B, H, S, D) layout, is the library time.  With history no one
    call computes the same function (the history is quantized);
    ``sdpa_bf16_ms`` times SDPA over the history dequantized to bf16
    beforehand plus the chunk, with an explicit mask: a yardstick only,
    its dequantization not timed.  Also over bf16 pages (at
    Llama's 32 / 8 heads and Qwen2-7B's 28 / 4), and at the GQA groups
    that do not divide 64, int4, 1536 history positions: G = 3
    (Llama-3.2-3B, 24 / 8 heads), 5 (Qwen2.5-14B, 40 / 8), 6 (Qwen2-1.5B,
    12 / 2) and 7 (Qwen2-7B, 28 / 4)."""
    import torch.nn.functional as F
    from micromix_tpu_torch.serve.kv_cache import kv_dequantize_page, make_cache
    from micromix_tpu_torch.serve.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    d, ps = 128, 128
    cases = [c + (32, 8) for c in ((512, 1536, 4), (512, 512, 4), (512, 1024, 4),
                                   (120, 0, 4), (2048, 0, 4), (512, 1536, 8),
                                   (512, 1024, 8), (512, 1536, 16))]
    cases += [(512, 1536, 4, 24, 8), (512, 1536, 4, 40, 8), (512, 1536, 4, 12, 2),
              (512, 1536, 4, 28, 4), (512, 1536, 16, 28, 4)]
    for s, hist, bits, h, hkv in cases:
        mp = -(-(hist + s) // ps)
        cache = make_cache(mp + 1, ps, hkv, d, 1, mp, bits=bits, device=DEV)
        for codes in (cache.k_codes, cache.v_codes):
            if bits == 16:
                codes.copy_(torch.randn(codes.shape, device=DEV))
            else:
                codes.random_(0, 256)
        # values (c - z) s within about +-1.5 at either width
        smax = 0.1 if bits == 4 else 0.006
        for sz in (cache.k_sz, cache.v_sz):
            sz[:, :, 0].uniform_(smax / 10, smax)
            sz[:, :, 1].copy_(torch.randint(0, 2 ** min(bits, 8), sz[:, :, 1].shape,
                                            device=DEV))
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
        nbytes = (2 * s * (h + 2 * hkv) * d + 2 * s * h * d
                  + 2 * hist * hkv * _page_bytes(bits, d))
        label = (f"S={s} hist={hist} H={h} Hkv={hkv} D={d}"
                 + {4: "", 8: " int8", 16: " bf16"}[bits])
        record(results, "paged_prefill", label,
               err, "2^-7|ref|+2^-8max|ref|", ok, timer.ms(run), nbytes,
               4.0 * s * (hist + s / 2) * h * d, timer.ms(plain), lib, **extra,
           rerun=run)


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
                   timer.ms(lambda: torch.bmm(img, wd.transpose(1, 2))), **extra,
           rerun=lambda: mixed_matmul_w8_grouped(x, gw, **kw))
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
               timer.ms(lambda: quantize_mixed_plain(x, *splits, **kw)),
           rerun=lambda: quantize_mixed(x, *splits, **kw))


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
               timer.ms(lambda: torch.matmul(ad, wd.t())),
           rerun=lambda: mixed_matmul_sp(a, w))
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
               timer.ms(lambda: torch.matmul(img, wd.t())),
           rerun=lambda: mixed_matmul_sp_stack(x, st, **kw))
        del st, wd


def cuda_launches(fn) -> int:
    """CUDA kernel launches of one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


# two f32 sums of V = 128256 exps in another order: about sqrt(V) * 2^-24
# (2.1e-5) of the log-sum-exp each
LOGPROB_TOL = 2 * np.sqrt(128256) * 2.0 ** -24


def check_controls(timer) -> dict:
    """The logit-controls stage and ``decode_multi``'s logprobs: plain
    PyTorch ops over (B, V) (the JAX package computes them with jnp ops
    outside any kernel), on the card against the CPU on the same f32
    logits at B=8, V=128256.  The controlled logits must be bit-exact
    (compares, IEEE divisions and multiplies, a max), the greedy token
    equal, the chosen tokens' raw logprobs within LOGPROB_TOL (two
    log_softmax sums over 128256 terms in another order).  Each part's
    device ms (CUDA events, L2 flushed) and CUDA launches: the chunk's
    set-up (presence unpacked, terminators' mask), a step's stage
    (suppression, penalty, min-p, the presence update) and a step's
    logprobs."""
    from micromix_tpu_torch.serve.sampling import (SamplingParams,
                                                   apply_logit_controls,
                                                   ban_mask, chosen_logprobs,
                                                   minp_shifts,
                                                   unpack_presence)
    b, v = 8, 128256
    g = np.random.default_rng(SEED + 11)
    presence = np.zeros((b, v), bool)
    for i in range(b):
        presence[i, g.integers(0, v, 1500)] = True
    sp = [SamplingParams(temperature=0.8 * (i % 2), min_p=0.1,
                         repetition_penalty=(1.3, 1.0, 0.8, 1.3)[i % 4])
          for i in range(b)]
    ban = g.integers(0, v, (b, 3)).astype(np.int32)
    ban[1, 1:] = -1
    cpu = dict(logits=torch.from_numpy(g.normal(0, 3, (b, v)).astype(np.float32)),
               bits=torch.from_numpy(np.packbits(presence, axis=1,
                                                 bitorder="little")),
               pen=torch.tensor([p.repetition_penalty for p in sp]),
               ban=torch.from_numpy(ban),
               mrem=torch.tensor([16, 0, 3, 1, 0, 16, 2, 0], dtype=torch.int32),
               mps=torch.from_numpy(minp_shifts(sp)))
    card = {k: t.to(DEV) for k, t in cpu.items()}

    def setup(t):
        return unpack_presence(t["bits"], v), ban_mask(t["ban"], v)

    def stage(t, pres, banned, i=0):
        suppress = (t["mrem"] > i)[:, None] & banned
        x = apply_logit_controls(t["logits"], pres, t["pen"], suppress,
                                 minp_shift=t["mps"])
        tok = torch.argmax(x, dim=-1)
        pres[torch.arange(b, device=x.device), tok] = True
        return x, tok

    def logprobs(t, tok):
        return chosen_logprobs(t["logits"], tok)

    x_c, tok_c = stage(cpu, *setup(cpu))
    x_g, tok_g = stage(card, *setup(card))
    lp_c, lp_g = logprobs(cpu, tok_c), logprobs(card, tok_g)
    exact = torch.equal(x_g.cpu(), x_c)
    same_tok = torch.equal(tok_g.cpu(), tok_c)
    lp_err = float((lp_g.cpu() - lp_c).abs().max())
    pres, banned = setup(card)
    out = dict(
        controlled_logits_bit_exact=exact, greedy_tokens_equal=same_tok,
        logprob_max_abs_err=lp_err, logprob_tolerance=LOGPROB_TOL,
        setup_ms=timer.ms(lambda: setup(card)),
        setup_launches=cuda_launches(lambda: setup(card)),
        stage_ms=timer.ms(lambda: stage(card, pres, banned)),
        stage_launches=cuda_launches(lambda: stage(card, pres, banned)),
        logprobs_ms=timer.ms(lambda: logprobs(card, tok_g)),
        logprobs_launches=cuda_launches(lambda: logprobs(card, tok_g)))
    print(f"  controls B={b} V={v}: controlled logits bit-exact {exact}, "
          f"greedy tokens equal {same_tok}, logprobs max abs err "
          f"{lp_err:.3e} ({LOGPROB_TOL}); device ms and CUDA launches: "
          f"chunk set-up {out['setup_ms']:.4f} / {out['setup_launches']}, "
          f"a step's stage {out['stage_ms']:.4f} / {out['stage_launches']}, "
          f"a step's logprobs {out['logprobs_ms']:.4f} / "
          f"{out['logprobs_launches']} (plain PyTorch ops, no kernel)",
          flush=True)
    if not (exact and same_tok and lp_err <= LOGPROB_TOL):
        fail("controls: the card's controlled logits, greedy tokens or "
             "logprobs disagree with the CPU's")
    return out


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
        if not dataclasses.is_dataclass(x):
            return x
        return dataclasses.replace(x, **{f.name: move(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return move(params)


# decode steps of the card-against-CPU checks' Llama units (phases 3, 10,
# 14) and of phase 3's Mixtral's, and their prompt (2 chunks: E, then H)
# but for the windowed model's 300 (3 chunks, the window crossed): the
# CPU side of every unit dequantizes every weight, seconds a unit
P3_STEPS = 4
P3_MOE_STEPS = 2
P3_PROMPT = 200


def phase3() -> dict:
    """Card against CPU on 2-layer full-width stacked models: a
    ``P3_PROMPT``-token prompt (300 for the windowed Llama) prefilled in
    chunks of 128 (flash, then paged history), then
    greedy decode steps: Llama-3.1-8B, ``P3_STEPS`` steps through the
    residual pairs, again on int8 KV pages, also with a 256-token sliding
    window; Mixtral-8x7B (experts grouped, dense dispatch),
    ``P3_MOE_STEPS`` steps through the grouped expert GEMMs (the CPU side
    dequantizes 1.4 G codes per layer and unit).  Each CPU unit
    dequantizes every weight, so the units set the phase's time.

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
    out["llama"] = card_vs_cpu(cfg, P3_STEPS, ("flash_attention", "paged_prefill",
                                        "w8_stack", "w8_pair"),
                               lambda p: _can_pair(p, cfg, 1),
                               prompt_len=P3_PROMPT)
    # the same model on int8 KV pages: H reads them at the second chunk, C
    # at every decode step
    out["llama_int8_kv"] = card_vs_cpu(
        cfg, P3_STEPS, ("flash_attention", "paged_prefill", "paged_decode",
                        "w8_stack", "w8_pair"),
        lambda p: _can_pair(p, cfg, 1), name="llama int8 KV", bits=8,
        prompt_len=P3_PROMPT)
    out["mixtral"] = card_vs_cpu(mixtral_8x7b(2), P3_MOE_STEPS,
                                 ("flash_attention", "paged_prefill",
                                  "w8_stack", "w8_grouped"),
                                 lambda p: "experts_grouped" in p["layers"][0],
                                 prompt_len=P3_PROMPT)
    out["llama_splitplane"] = card_vs_cpu(
        cfg, P3_STEPS, ("flash_attention", "paged_prefill", "site_fakequant",
                        "sp_stack"),
        lambda p: (isinstance(p["layers"][0]["qkv_stack"], SplitPlaneStack)
                   and not _can_pair(p, cfg, 1)), layout="splitplane",
        prompt_len=P3_PROMPT)
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
        cfg_w, P3_STEPS, ("flash_attention", "paged_prefill", "paged_decode",
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
                name=None, near_tie=False, bits=4, make=None,
                prompt_len=300) -> dict:
    """One model of phase 3: its units on the card and on the CPU, KV
    pages of ``bits``; the model random_quantized_model's in ``layout``,
    or ``make()``'s (phase 11's forms), stacked as the engine stacks it.  With ``near_tie``, a last chunk whose two top CPU
    logits lie closer than that unit's card/CPU difference may give either
    of the two as its greedy token on the card (the decode steps' tokens
    must be equal).  On int8 or bf16 pages Kernels H and C must launch on
    them."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model,
                                                   stack_layer_projections)
    from micromix_tpu_torch.serve.kv_cache import make_cache
    from micromix_tpu_torch.serve.runner import decode_step, prefill
    if make is None:
        calib = default_calibration(cfg, p6=256, p8=256, seed=SEED)
        gpu_params = stack_layer_projections(random_quantized_model(
            cfg, calib, seed=SEED, device=DEV, layout=layout))
    else:
        gpu_params = stack_layer_projections(make())
    name = name or f"{cfg.arch} ({layout})"
    if not form_ok(gpu_params):
        fail(f"phase 3 ({name}): the stacked model is not in its serving form")
    cpu_params = params_to(gpu_params, "cpu")
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                  prompt_len).tolist()
    ps, chunk = 128, 128
    mp = -(-(len(prompt) + steps + 1) // ps)
    caches = [make_cache(mp + 1, ps, cfg.num_kv_heads, cfg.head_dim, 1, mp,
                         bits=bits, device=DEV) for _ in range(cfg.num_layers)]
    for c in caches:
        c.page_table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
    t0 = time.perf_counter()
    build.reset_launches()
    rels, card, cpu, top2, digests = [], [], [], [], []

    def both(fn, *args, **kw):
        """One unit on the card and on a CPU copy of its state: the
        greedy tokens of both."""
        nonlocal caches
        cpu_caches = params_to(caches, "cpu")
        g, caches = fn(gpu_params, cfg, caches, *args, **kw)
        c, _ = fn(cpu_params, cfg, cpu_caches,
                  *[params_to(a, "cpu") for a in args], **kw)
        g, c = g[0].float().cpu(), c[0].float()
        digests.append(hashlib.sha256(g.numpy().tobytes()).hexdigest()[:16])
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
                            seq, torch.tensor([len(prompt) + i], device=DEV,
                                              dtype=torch.int32))
        card.append(g_tok)
        cpu.append(c_tok)
    launches = dict(build.launches)
    on_pages = {f"{k}/{'bf16' if b == 16 else f'int{b}'}": n
                for (k, b), n in build.page_launches.items()}
    tol = 0.5
    wall = time.perf_counter() - t0
    print(f"  {name}, 2-layer full width, stacked: prompt {len(prompt)} "
          f"tokens in chunks of {chunk}, then {steps} decode steps, each unit "
          f"from the card's state; greedy tokens card {card}, cpu {cpu}; max "
          f"|logit diff| / max |cpu logit| per unit {['%.2e' % r for r in rels]} "
          f"(tolerance {tol}); card launches {launches}, by page width "
          f"{on_pages}; wall {wall:.1f}s", flush=True)
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
    if bits != 4:
        missing += [f"{k}/{bits}-bit" for k in ("paged_prefill", "paged_decode")
                    if not build.page_launches.get((k, bits))]
    if missing:
        fail(f"phase 3 ({name}): kernels not launched on the card: {missing}")
    return dict(logit_rel_err=rels, first_chunk_rel_err=rels[0],
                tokens=card, cpu_tokens=cpu, cpu_top2=top2,
                card_logit_sha256=digests, launches=launches,
                page_launches=on_pages, kv_bits=bits, wall_s=wall)


# ----------------------------------------------------------------- phase 4

def decode_window(eng, cfg, steps: int = 8, controls=None,
                  with_logprobs: bool = False) -> dict:
    """The port's kernel launches per decode step (and per layer) and the
    host ms per step, over one ``decode_multi`` chunk with the engine's
    params, every slot on the scratch row (short contexts), greedy, with
    the logit controls and logprobs when given; then the device busy ms
    per step (the sum of kernel times under ``torch.profiler``), all CUDA
    launches per step (PyTorch's included) and the largest kernels, over
    one more chunk."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.serve.runner import decode_multi
    b = eng.max_seqs
    z = torch.zeros(b, dtype=torch.int32, device=DEV)
    seq = torch.full((b,), b, dtype=torch.int32, device=DEV)
    kw = dict(gen=None, temps=torch.zeros(b, device=DEV), top_k=z,
              top_p=torch.ones(b, device=DEV), controls=controls,
              n_steps=steps, sample_mode="greedy",
              with_logprobs=with_logprobs)
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
    cuda_launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name.split("(")[0][:60]] += e.device_time_total / 1e3
            cuda_launches += 1
    busy = sum(per_kernel.values()) / steps
    if busy <= 0.0:
        fail("decode window: the profiler saw no device time")
    return dict(ms_per_step=ms, kernel_launches_per_step=total,
                kernel_launches_per_layer_step=total / cfg.num_layers,
                cuda_launches_per_step=cuda_launches / steps,
                by_kernel=per_step, device_busy_ms_per_step=busy,
                top_device_ms_per_step={k: v / steps for k, v in
                                        per_kernel.most_common(6)})


def counted_run(label: str, fn, must_launch=(), pages=None):
    """``fn()`` with the launch counters reset just before it and read
    just after it.  The plain PyTorch append refuses to run meanwhile,
    the pre-quantized append must not launch, every kernel of
    ``must_launch`` must, and with ``pages`` C and H must launch on pages
    of that width.  -> (result, host wall s, launches, launches by
    (kernel, page bits))."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.serve import kv_cache
    torch.cuda.synchronize()
    build.reset_launches()
    plain_append = kv_cache.append_kv_plain

    def refuse(*args, **kwargs):
        fail(f"{label}: the plain PyTorch append ran on the card")

    kv_cache.append_kv_plain = refuse
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kv_cache.append_kv_plain = plain_append
    launches, by_page = dict(build.launches), dict(build.page_launches)
    if launches.get("append_kv"):
        fail(f"{label}: the pre-quantized append (the old composition) ran")
    missing = [n for n in must_launch if not launches.get(n)]
    missing += [f"{k}/{pages}-bit" for k in ("paged_prefill", "paged_decode")
                if pages and not by_page.get((k, pages))]
    if missing:
        fail(f"{label}: kernels not launched: {missing}")
    return out, wall, launches, by_page


def engine_run(eng, reqs, phase: str, pages=None):
    """``eng.run(reqs)`` under ``counted_run`` -> (host wall s, launches,
    launches by (kernel, page bits))."""
    _, wall, launches, by_page = counted_run(phase, lambda: eng.run(reqs),
                                             pages=pages)
    return wall, launches, by_page


def strict_dispatch(eng, label: str) -> list:
    """Run every pipelined dispatch of ``eng`` (the chunk enqueued while
    the one before it is in flight) under
    ``torch.cuda.set_sync_debug_mode("error")``: a stream synchronize or a
    blocking copy there fails the run.  -> a one-element list counting the
    dispatches."""
    count = [0]
    # a weak reference: a closure over the engine stored on the engine
    # would keep it (its stacked params, its caches) until a cyclic GC
    engine = weakref.ref(eng)

    def strict(*args):
        count[0] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return type(engine())._dispatch(engine(), *args)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            fail(f"{label}: the pipelined dispatch waited for the card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng._dispatch = strict
    return count


def serve(cfg, params, reqs, phase="phase 4", **kw):
    """One engine run (``engine_run``) of a fresh default engine, its
    pipelined dispatches under ``strict_dispatch``; every request must
    finish with its ``max_new_tokens``.  On KV pages of other than 4 bits
    C and H must launch on them."""
    from micromix_tpu_torch.serve.engine import Engine
    eng = Engine(params, cfg, seed=SEED, device=DEV, **kw)
    pipelined = strict_dispatch(eng, phase)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bits = kw.get("kv_bits", 4)
    wall, launches, by_page = engine_run(eng, reqs, phase,
                                         pages=bits if bits != 4 else None)
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
        launches=launches, pipelined_chunks=pipelined[0],
        page_launches={f"{k}/{b}": n for (k, b), n in by_page.items()})
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
    if not stats["pipelined_chunks"]:
        fail("phase 4: the default engine dispatched no pipelined chunk")
    stats["decode_window"] = decode_window(eng, cfg)
    print("  stacked, 32 layers: " + json.dumps(stats), flush=True)
    stats["pipeline_window"] = pipeline_window(params, cfg, rng, "phase 4")
    ctl = controls_batch(eng, cfg, rng)
    for label, st in (("plain batch", stats), ("controls batch", ctl)):
        w = st["decode_window"]
        print(f"  {label}: engine {st['decode_ms_per_step']:.3f} ms/step; "
              f"decode window {w['ms_per_step']:.3f} ms/step host, "
              f"{w['device_busy_ms_per_step']:.3f} ms/step device busy, "
              f"{w['cuda_launches_per_step']:.1f} CUDA launches/step",
              flush=True)
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
    return dict(stacked=stats, per_consumer=stats4, controls=ctl)


def pipeline_window(params, cfg, rng, phase: str) -> dict:
    """The engine with and without pipelined decode on the same eight
    requests (96-128 prompt tokens, batched in one prefill; 40-64 new
    tokens, staggered; four greedy, four sampled at temperature 0.8), in
    turns: unpipelined, pipelined, pipelined, unpipelined, twice, each a
    fresh engine from one seed.  Every run's token streams must be equal
    (the generator draws alike); each pipelined dispatch runs under
    ``strict_dispatch``.  Host ms a decode step (``phase_s["decode"]`` over
    the steps: dispatch, and the wait for the tokens) and wall for each,
    and each mode's median."""
    from micromix_tpu_torch.serve.engine import Engine, Request
    from micromix_tpu_torch.serve.sampling import SamplingParams
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(96, 129))).tolist()
               for _ in range(8)]

    def reqs():
        return [Request(i, list(p), max_new_tokens=40 + 8 * (i % 4),
                        sampling=SamplingParams(temperature=0.8 * (i % 2)))
                for i, p in enumerate(prompts)]

    runs, streams = [], []
    for pipeline in (False, True, True, False) * 2:
        eng = Engine(params, cfg, seed=SEED, device=DEV, pipeline=pipeline,
                     max_seqs=8, page_size=128, max_pages_per_seq=2,
                     decode_chunk=8)
        count = strict_dispatch(eng, f"{phase} (pipeline window)")
        rs = reqs()
        wall, _, _ = engine_run(eng, rs, f"{phase} (pipeline window)")
        streams.append([r.output for r in rs])
        runs.append(dict(pipeline=pipeline, wall_s=wall, pipelined_chunks=count[0],
                         decode_steps=eng.phase_steps["decode"],
                         decode_ms_per_step=1e3 * eng.phase_s["decode"]
                         / eng.phase_steps["decode"]))
        del eng
    if any(s != streams[0] for s in streams):
        fail(f"{phase}: pipelined and unpipelined token streams differ")
    if not all(r["pipelined_chunks"] for r in runs if r["pipeline"]):
        fail(f"{phase}: the pipelined engine dispatched no pipelined chunk")
    out = dict(runs=runs, streams_equal=True)
    for p, name in ((False, "unpipelined"), (True, "pipelined")):
        ms = [r["decode_ms_per_step"] for r in runs if r["pipeline"] == p]
        out[f"{name}_ms_per_step"] = ms
        out[f"{name}_median_ms_per_step"] = statistics.median(ms)
    print(f"  {phase} pipeline window, 8 requests x 40-64 tokens, greedy and "
          f"sampled: streams equal in all {len(runs)} runs; decode host "
          f"ms/step unpipelined {['%.3f' % x for x in out['unpipelined_ms_per_step']]} "
          f"(median {out['unpipelined_median_ms_per_step']:.3f}), pipelined "
          f"{['%.3f' % x for x in out['pipelined_ms_per_step']]} (median "
          f"{out['pipelined_median_ms_per_step']:.3f}); "
          f"{[r['pipelined_chunks'] for r in runs]} pipelined chunks", flush=True)
    return out


CANCELLED, CANCEL_AT, MIN_NEW = 6, 5, 16


def controls_batch(eng, cfg, rng) -> dict:
    """Phase 4's second batch, on the same engine: 8 requests of 96-128
    prompt tokens, 32 new tokens at most, every one with logprobs and an
    ``on_token`` stream: greedy with repetition penalty 1.3 and a stop id
    (0), min_p 0.1 at temperature 0.8 (1, 5; with the penalty: 3),
    min_new_tokens 16 against eos and stop ids (2; with the penalty: 4),
    the penalty and a cancel from its own ``on_token`` after 5 tokens
    (6), greedy min-p (7, the argmax alone).

    The stop and eos ids are read from a probe run of the same batch
    without them: rows are computed independently of one another, so
    request 0's greedy path is the probe's up to the stop id (its first
    occurrence from token 4 on), and the ids of 2 and 4, which the probe
    emitted before token 16, must now be suppressed until it.  Checks:
    the stop id ends request 0 there; no eos or stop id before token 16;
    ``len(token_logprobs) == len(output)``, each a log-probability; the
    streamed tokens are the output; the cancelled request is done with 5
    tokens and its slot free; every page returns to the pool.  The
    launch counters are reset just before the measured run and read just
    after it; then a greedy decode window with the controls and logprobs
    beside the plain batch's."""
    from micromix_tpu_torch.serve.engine import Request
    from micromix_tpu_torch.serve.sampling import SamplingParams
    v = cfg.vocab_size
    prompts = [rng.integers(0, v, int(rng.integers(96, 129))).tolist()
               for _ in range(8)]
    sps = [SamplingParams(repetition_penalty=1.3),
           SamplingParams(temperature=0.8, min_p=0.1),
           SamplingParams(min_new_tokens=MIN_NEW),
           SamplingParams(temperature=0.8, min_p=0.1, repetition_penalty=1.3),
           SamplingParams(repetition_penalty=1.3, min_new_tokens=MIN_NEW),
           SamplingParams(temperature=0.8, min_p=0.1),
           SamplingParams(repetition_penalty=1.3),
           SamplingParams(min_p=0.1)]

    def batch(ids):
        streams = [[] for _ in prompts]

        def on_token(i):
            def f(t):
                streams[i].append(t)
                if i == CANCELLED and len(streams[i]) == CANCEL_AT:
                    if not eng.cancel(i) or eng.slots[i].req is not None:
                        fail("phase 4 (controls): the cancel did not release "
                             "its slot")
            return f
        return [Request(i, p, max_new_tokens=32, sampling=sps[i],
                        eos_id=ids.get(i, (None, None))[0],
                        stop_ids=ids.get(i, (None, None))[1], logprobs=True,
                        on_token=on_token(i))
                for i, p in enumerate(prompts)], streams

    probe, _ = batch({})
    engine_run(eng, probe, "phase 4 (controls probe)")
    out0 = probe[0].output
    k0 = next((k for k in range(4, len(out0)) if out0[k] not in out0[:k]), None)
    o2, o4 = probe[2].output, probe[4].output
    if k0 is None or len(o2) < 4 or len(o4) < 3:
        fail("phase 4 (controls): the probe run gave no usable stop id")
    ids = {0: (None, [out0[k0]]), 2: (o2[1], [o2[3], o2[2]]), 4: (o4[2], None)}
    reqs, streams = batch(ids)
    d0, s0 = eng.phase_s["decode"], eng.phase_steps["decode"]
    torch.cuda.reset_peak_memory_stats()
    wall, launches, _ = engine_run(eng, reqs, "phase 4 (controls)")
    steps = eng.phase_steps["decode"] - s0
    r0 = reqs[0]
    if r0.output != out0[:k0 + 1]:
        fail(f"phase 4 (controls): request 0 did not end at its stop id "
             f"{out0[k0]} (token {k0})")
    for i in (2, 4):
        eos, stops = ids[i]
        banned = {eos, *(stops or [])}
        if banned & set(reqs[i].output[:MIN_NEW]):
            fail(f"phase 4 (controls): request {i} emitted a terminator "
                 f"before {MIN_NEW} tokens")
    for r, st in zip(reqs, streams):
        if not r.done or st != r.output:
            fail(f"phase 4 (controls): request {r.req_id} not done, or its "
                 "stream differs from its output")
        if len(r.token_logprobs) != len(r.output) or not all(
                np.isfinite(x) and x <= 0.0 for x in r.token_logprobs):
            fail(f"phase 4 (controls): request {r.req_id}'s logprobs")
        if not all(0 <= t < v for t in r.output):
            fail("phase 4 (controls): token out of vocabulary")
    if len(reqs[CANCELLED].output) != CANCEL_AT:
        fail("phase 4 (controls): the cancelled request went on")
    bm = eng.block_manager
    if bm.num_free != bm.n_pages - 1 or any(s.req is not None for s in eng.slots):
        fail("phase 4 (controls): slots or pages not released")
    missing = [n for n in CONTROLS_KERNELS if not launches.get(n)]
    if missing:
        fail(f"phase 4 (controls): kernels not launched: {missing}")
    window_reqs = [Request(r.req_id, r.prompt, sampling=r.sampling,
                           eos_id=r.eos_id, stop_ids=r.stop_ids) for r in reqs]
    # the engine's per-chunk host work for the stage: presence from each
    # context, packed, and the five arrays copied to the card
    setup_ms = host_ms(lambda: eng._controls_arrays(window_reqs))
    stats = dict(
        controls_arrays_host_ms_per_chunk=setup_ms,
        tokens_out=[len(r.output) for r in reqs], stop_at=k0,
        decode_ms_per_step=1e3 * (eng.phase_s["decode"] - d0) / steps,
        decode_steps=steps, wall_s=wall, launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        decode_window=decode_window(eng, cfg,
                                    controls=eng._controls_arrays(window_reqs),
                                    with_logprobs=True))
    print("  controls batch, 32 layers: " + json.dumps(stats), flush=True)
    return stats


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


# ----------------------------------------------------------------- phase 7

P7_SEQLEN, P7_CAL, P7_EVAL = 2048, 4, 4
P7_LAYERS = 32
# the 2-layer card/CPU comparison: windows of 512 tokens keep the CPU's
# f32 forwards (a 128256-row head) to seconds
P7_CMP_SEQLEN, P7_CMP_CAL, P7_CMP_EVAL = 512, 2, 2
# card/CPU tolerances of the stats: the dense linears' f32 sums run in
# another order (cuBLAS, the CPU's GEMM), so a bf16 output can land one
# step (0.8%) apart and compound through silu * up and the next layer
STATS_RTOL = {"absmax": 0.05, "saliency": 0.05, "below4": 5e-3,
              "below6": 5e-3, "total": 0.0}
PPL_RTOL = 2e-3


def _normal(gen, shape, std, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=gen).to(torch.bfloat16)


def dense_layer(cfg, gen, device) -> dict:
    """One seeded dense layer, drawn from ``gen`` (``dense_llama``'s
    draws for a layer, in its order)."""
    from micromix_tpu_torch.models.common import DenseLinear
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    odim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def lin(n, k):
        return DenseLinear(w=_normal(gen, (n, k), 1.0 / np.sqrt(k), device))

    def ones():
        return torch.ones(hid, dtype=torch.bfloat16, device=device)

    attn = dict(ln1=ones(), ln2=ones(), q=lin(odim, hid), k=lin(kvdim, hid),
                v=lin(kvdim, hid), o=lin(hid, odim))
    if cfg.is_moe:
        return dict(attn, router=lin(cfg.num_experts, hid),
                    experts=[dict(w1=lin(inter, hid), w3=lin(inter, hid),
                                  w2=lin(hid, inter))
                             for _ in range(cfg.num_experts)])
    return dict(attn, gate=lin(inter, hid), up=lin(inter, hid),
                down=lin(hid, inter))


def dense_llama(cfg, seed: int, device):
    """A seeded dense bf16 Llama (or, for a MoE config, Mixtral: a router
    and the experts' w1, w3, w2 in place of gate, up, down) made on
    ``device`` (torch.Generator draws): each linear N(0, 1/sqrt(K)), embed
    and head N(0, 0.02), norms 1 -- the widths and draws of
    random_dense_params, without numpy.  The layers are drawn first, then
    the embedding, then the head (``p12_tp_model`` draws them so too)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hid = cfg.hidden_size
    layers = [dense_layer(cfg, gen, device) for _ in range(cfg.num_layers)]
    embed = _normal(gen, (cfg.vocab_size, hid), 0.02, device)
    return {"embed": embed,
            "final_ln": torch.ones(hid, dtype=torch.bfloat16, device=device),
            "lm_head": _normal(gen, (cfg.vocab_size, hid), 0.02, device),
            "layers": layers}


def calib_pipeline(params, cfg, seqlen: int, n_cal: int, n_eval: int,
                   sync=lambda: None, quantize_from=None, **quant_kw) -> dict:
    """calibrate -> allocate -> dense ppl -> smooth + quantize (layer by
    layer, each dense layer dropped) -> quantized ppl over
    ``synthetic_tokens`` from SEED: n_cal windows of ``seqlen`` to
    calibrate, the next n_eval to evaluate.  ``quantize_from``: another
    run's result, whose stats and calibrations then smooth and quantize
    the model in place of this run's own; ``quant_kw`` go to the
    quantizer (``host=True`` on the CPU).  Consumes ``params``."""
    from micromix_tpu_torch.calib import (average_bits, collect_calibration,
                                          smooth_quantize_model,
                                          stats_to_calibration)
    from micromix_tpu_torch.eval import eval_ppl, synthetic_tokens
    stream = synthetic_tokens(cfg.vocab_size, (n_cal + n_eval) * seqlen,
                              seed=SEED)
    windows = [stream[i * seqlen:(i + 1) * seqlen][None, :] for i in range(n_cal)]
    test = stream[n_cal * seqlen:]
    out, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return r

    stats = timed("calibrate", lambda: collect_calibration(params, cfg, windows))
    calibs = timed("allocate", lambda: stats_to_calibration(stats, cfg))
    out["dense_ppl"] = timed("dense_ppl", lambda: eval_ppl(
        params, cfg, test, seqlen=seqlen))
    src = quantize_from or dict(stats=stats, calibs=calibs)
    qparams = timed("smooth_quantize", lambda: smooth_quantize_model(
        params, cfg, src["stats"], src["calibs"], **quant_kw))
    out["quant_ppl"] = timed("quant_ppl", lambda: eval_ppl(
        qparams, cfg, test, seqlen=seqlen))
    out.update(average_bits=average_bits(calibs, cfg), stage_s=secs,
               stats=stats, calibs=calibs)
    return out


def phase7() -> dict:
    """The dense calibrate -> smooth -> quantize -> perplexity path at
    Llama-3.1-8B widths, weights from SEED, P7_LAYERS layers: calibration
    on 4 windows of 2048 tokens, evaluation on the next 4.  The launch
    counters are reset just before the pipeline and read just after it;
    it must launch Kernel E (every forward's attention) and Kernel A (the
    quantized forward's sites).  At 2048 rows the quantized forward's
    ScaledW8 products take the dequantize route (dequantize +
    torch.matmul from W8_PREFILL_DEQUANT_THRESHOLD rows, as the JAX
    package's), which is not a kernel.  quant_ppl < 1.25 x dense_ppl, the
    golden test's check.  Then the 2-layer card/CPU comparison."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.kernels.mixed_matmul import \
        W8_PREFILL_DEQUANT_THRESHOLD
    cfg = llama31_8b(P7_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dense_llama(cfg, SEED, DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build.reset_launches()
    res = calib_pipeline(params, cfg, P7_SEQLEN, P7_CAL, P7_EVAL,
                         sync=torch.cuda.synchronize)
    launches = dict(build.launches)
    del params
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dense_ppl, quant_ppl = res["dense_ppl"], res["quant_ppl"]
    stats = dict(layers=P7_LAYERS, seqlen=P7_SEQLEN, calib_windows=P7_CAL,
                 eval_windows=P7_EVAL, average_bits=res["average_bits"],
                 calibs=res["calibs"],
                 dense_ppl=dense_ppl, quant_ppl=quant_ppl,
                 model_build_s=build_s, stage_s=res["stage_s"],
                 peak_mem_gib=peak, launches=launches,
                 gemm_route=f"dequantize + torch.matmul (rows >= "
                            f"{W8_PREFILL_DEQUANT_THRESHOLD}), not a kernel")
    print(f"  {P7_LAYERS} layers: " + json.dumps(
        {k: v for k, v in stats.items() if k != "calibs"}), flush=True)
    if not (np.isfinite(dense_ppl) and np.isfinite(quant_ppl)):
        fail("phase 7: perplexity not finite")
    if quant_ppl >= 1.25 * dense_ppl:
        fail(f"phase 7: quantized ppl {quant_ppl} over 1.25 x dense {dense_ppl}")
    missing = [n for n in PIPELINE_KERNELS if not launches.get(n)]
    if missing:
        fail(f"phase 7: kernels not launched: {missing}")
    torch.cuda.empty_cache()
    stats["card_vs_cpu"] = phase7_card_vs_cpu()
    return stats


def _units(st, k: int):
    """A site's unrounded fp6 and fp8 widths in units of 128 channels."""
    p4 = float(st["below4"]) / float(st["total"])
    p6 = float(st["below6"]) / float(st["total"]) - p4
    return round(k * p6 / 128, 4), round(k * (1.0 - p4 - p6) / 128, 4)


def phase7_card_vs_cpu() -> dict:
    """The same pipeline at 2 layers, full width, on the card and on the
    CPU from the same dense weights (P7_CMP_CAL + P7_CMP_EVAL windows of
    P7_CMP_SEQLEN): the stats within STATS_RTOL; the fp6 / fp8 channel
    counts equal, or flips that the stats within their tolerance explain
    (the two sides' ratios straddle a multiple of 128), printed; the
    reorder indices compared position by position.  Random weights give
    channels of near-equal saliency, so a saliency within its tolerance
    reorders many of them, and with them which channels each segment
    holds: the CPU therefore smooths and quantizes from the card's stats
    and calibrations, so that both perplexities (dense, and quantized of
    the same quantized model) are held to PPL_RTOL.  The CPU quantizes
    with the native host quantizer (bit for bit the torch quantizer's)."""
    cfg = llama31_8b(2)
    card_params = dense_llama(cfg, SEED, DEV)
    cpu_params = params_to(card_params, "cpu")
    t0 = time.perf_counter()
    card = calib_pipeline(card_params, cfg, P7_CMP_SEQLEN, P7_CMP_CAL,
                          P7_CMP_EVAL, sync=torch.cuda.synchronize)
    card_s = time.perf_counter() - t0
    del card_params
    t0 = time.perf_counter()
    cpu = calib_pipeline(cpu_params, cfg, P7_CMP_SEQLEN, P7_CMP_CAL,
                         P7_CMP_EVAL, quantize_from=card, host=True)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    stat_err = {f: 0.0 for f in STATS_RTOL}
    for key, st in cpu["stats"].items():
        for f, ref in st.items():
            got = card["stats"][key][f]
            rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
            stat_err[f] = max(stat_err[f], float(rel.max()))
    flips, order_diff = [], []
    for i, (lc_g, lc_c) in enumerate(zip(card["calibs"], cpu["calibs"])):
        for name in lc_c:
            g, c = lc_g[name], lc_c[name]
            if (g.p6_num, g.p8_num) != (c.p6_num, c.p8_num):
                # the unrounded fp6 / fp8 widths in 128-channel units: a
                # flip is two sides of a multiple, the counts' difference
                # being within its tolerance (checked below)
                units = [_units(run["stats"][f"layer{i}/{name}"],
                                len(c.reorder_index)) for run in (card, cpu)]
                flips.append(f"layer{i}/{name}: card {g.p6_num}/{g.p8_num} "
                             f"({units[0]}), cpu {c.p6_num}/{c.p8_num} "
                             f"({units[1]})")
            order_diff.append(float(np.mean(g.reorder_index != c.reorder_index)))
    ppl_err = {k: abs(card[k] - cpu[k]) / cpu[k] for k in ("dense_ppl", "quant_ppl")}
    out = dict(seqlen=P7_CMP_SEQLEN, calib_windows=P7_CMP_CAL,
               eval_windows=P7_CMP_EVAL, stats_rel_err=stat_err,
               stats_rtol=STATS_RTOL, calib_flips=flips,
               reorder_positions_differing=order_diff,
               card={k: card[k] for k in ("dense_ppl", "quant_ppl",
                                          "average_bits", "stage_s")},
               cpu={k: cpu[k] for k in ("dense_ppl", "quant_ppl",
                                        "average_bits", "stage_s")},
               ppl_rel_err=ppl_err, ppl_rtol=PPL_RTOL, card_s=card_s,
               cpu_s=cpu_s)
    print("  2 layers, card against CPU: " + json.dumps(out), flush=True)
    bad = [f for f, e in stat_err.items() if e > STATS_RTOL[f]]
    if bad:
        fail(f"phase 7 (card vs CPU): stats {bad} outside their tolerance")
    if any(e > PPL_RTOL for e in ppl_err.values()):
        fail(f"phase 7 (card vs CPU): perplexity {ppl_err} over {PPL_RTOL}")
    return out


# ----------------------------------------------------------------- phase 8

P8_LAYERS = 4
P8_DIR = os.path.join(OUT_DIR, "phase8")
P8_NEW = 32
# Llama-3.1-8B's published config.json, depth cut to P8_LAYERS
P8_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_hidden_layers": P8_LAYERS, "vocab_size": 128256,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 131072,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 128000, "eos_token_id": 128001,
}
ST_DTYPES = {torch.bfloat16: "BF16", torch.float32: "F32"}
# the speculative draft of ``serve --draft-model``: Llama-3.2-1B's published
# config.json (tied embeddings, head_dim 64), depth cut to 2 layers
P8_DRAFT_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 2048, "intermediate_size": 8192,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_hidden_layers": 2, "vocab_size": 128256, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "max_position_embeddings": 131072,
    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "tie_word_embeddings": True, "torch_dtype": "bfloat16",
    "bos_token_id": 128000, "eos_token_id": 128001,
}


def write_safetensors(path: str, tensors) -> int:
    """A minimal safetensors writer (an 8-byte little-endian header
    length, the JSON header padded to 8 bytes, the tensors' raw bytes):
    the card's machine has no ``safetensors`` package.  -> bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def write_hf_checkpoint(params, cfg, path: str) -> int:
    """The dense params as an HF checkpoint directory: two shards named by
    model.safetensors.index.json, config.json, and a stray consolidated
    file with a wrong final norm, which the loader must ignore.  -> bytes."""
    from micromix_tpu_torch.models.loader import export_dense_params
    os.makedirs(path, exist_ok=True)
    tensors = export_dense_params(params, cfg)
    names = sorted(tensors)
    weight_map, total = {}, 0
    for i, part in enumerate((names[0::2], names[1::2])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        total += write_safetensors(os.path.join(path, fname),
                                   {n: tensors[n] for n in part})
        weight_map.update({n: fname for n in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(P8_HF_CONFIG, f)
    stray = torch.full_like(params["final_ln"], 99.0)
    write_safetensors(os.path.join(path, "consolidated.safetensors"),
                      {"model.norm.weight": stray})
    return total


class IntTokenizer:
    """Whitespace-separated integers <-> ids, vocab 128256, no eos: the
    card's machine has no ``transformers``, so it stands in for the
    checkpoint's tokenizer (``cli._tokenizer``)."""

    vocab_size = 128256
    eos_token_id = None
    bos_token_id = None
    chat_template = None

    def __call__(self, text, return_tensors=None):
        return {"input_ids": self.encode(text)}

    def encode(self, text, add_special_tokens=True):
        return [int(w) for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def write_draft_checkpoint(path: str) -> int:
    """The dense draft (``P8_DRAFT_CONFIG``, weights from SEED + 1 made on
    the card, the head tied to the embedding) as an HF directory of one
    shard -> bytes."""
    from micromix_tpu_torch.models.loader import (config_from_hf,
                                                  export_dense_params)
    cfg = config_from_hf(P8_DRAFT_CONFIG)
    params = dense_llama(cfg, SEED + 1, DEV)
    params["lm_head"] = params["embed"]
    tensors = export_dense_params(params, cfg)
    del tensors["lm_head.weight"]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(P8_DRAFT_CONFIG, f)
    return write_safetensors(os.path.join(path, "model.safetensors"), tensors)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _same_tree(a, b, where="") -> bool:
    """Two parameter trees: equal structure, equal statics, equal tensor
    bits."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and a.device == b.device
                and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    if dataclasses.is_dataclass(a):
        return (type(a) is type(b) and all(
            _same_tree(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)))
    return a == b


class P8Timer:
    """Host seconds of ``save_params`` / ``load_params`` calls made while
    the shell runs (the checkpoint's write and read)."""

    def __init__(self):
        self.s = collections.defaultdict(list)

    def wrap(self, module, name):
        fn = getattr(module, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[name].append(time.perf_counter() - t0)
            return out
        setattr(module, name, timed)
        return fn


def p8_traffic(rng, vocab: int):
    """Phase 4's kind of traffic for the shell's engine: six prompts of
    96-128 tokens and two long ones, 32 new tokens each.  The CLI's engine
    prefills a prompt in chunks of its largest bucket (2048: ``serve`` has
    no chunk flag, as in the JAX package), so the long prompts are
    2200-2600 tokens: their second chunk reads 2048 tokens of history."""
    lens = ([int(rng.integers(96, 129)) for _ in range(6)]
            + [int(rng.integers(2200, 2601)) for _ in range(2)])
    return [rng.integers(0, vocab, n).tolist() for n in lens]


# CUDA kernel names of the port that a hetero serve's trace must hold (A's
# site_kernel, B's w8_gemm_kernel, C's decode_kernel, D's
# append_quant_kernel, E's flash_kernel)
P8_TRACE_KERNELS = ("site_kernel", "w8_gemm", "decode_kernel",
                    "append_quant_kernel", "flash_kernel")


def p8_trace(logdir: str) -> dict:
    """``serve --profile``'s trace: one Chrome-trace JSON file under
    ``logdir`` whose kernel events name the port's kernels."""
    files = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    if len(files) != 1 or not files[0].endswith(".json"):
        fail(f"phase 8 (serve --profile): trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "kernel")
    found = {k: sum(n for name, n in names.items() if k in name)
             for k in P8_TRACE_KERNELS}
    missing = [k for k, n in found.items() if not n]
    if missing:
        fail(f"phase 8 (serve --profile): the trace names none of {missing}; "
             f"its kernels: {[n[:60] for n in names][:20]}")
    return dict(bytes=os.path.getsize(files[0]), events=len(events),
                kernel_events=sum(names.values()), port_kernels=found)


def p8_engine_tokens(params, cfg, prompts, n_new, kv_bits):
    """Engine.run of the prompts on a fresh engine with the CLI's serve
    settings -> their greedy tokens."""
    from micromix_tpu_torch.serve import Engine, Request
    from micromix_tpu_torch.serve.sampling import SamplingParams
    eng = Engine(params, cfg, max_seqs=8, page_size=128, kv_bits=kv_bits,
                 decode_chunk=8, device=DEV)
    reqs = [Request(i, p, max_new_tokens=n_new, sampling=SamplingParams())
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.output for r in reqs]


def _http(port: int, path: str, body=None):
    import urllib.request
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read().decode()


def p8_api(params, cfg, prompts) -> dict:
    """The ApiServer over one engine on the loaded checkpoint: a
    completion, a streamed completion and a chat, one at a time, each
    held against Engine.run of its prompt alone; then /metrics."""
    from micromix_tpu_torch.serve import ApiServer, Engine
    tok = IntTokenizer()
    eng = Engine(params, cfg, max_seqs=8, page_size=128, kv_bits=4,
                 decode_chunk=8, device=DEV)
    srv = ApiServer(eng, lambda s: tok(s)["input_ids"], tok.decode,
                    model_name="llama-3.1-8b-4-layers",
                    chat_template=lambda msgs: " ".join(m["content"] for m in msgs))
    srv.start()
    n = 16
    try:
        got = []
        st, body = _http(srv.port, "/v1/completions",
                         {"prompt": tok.decode(prompts[0]), "max_tokens": n})
        got.append([int(w) for w in json.loads(body)["choices"][0]["text"].split()])
        st2, raw = _http(srv.port, "/v1/completions",
                         {"prompt": tok.decode(prompts[1]), "max_tokens": n,
                          "stream": True})
        events = [ln[len("data: "):] for ln in raw.splitlines()
                  if ln.startswith("data: ")]
        if events[-1] != "[DONE]":
            fail("phase 8 (api): the stream did not end with [DONE]")
        text = "".join(json.loads(e)["choices"][0]["text"] for e in events[:-1])
        got.append([int(w) for w in text.split()])
        st3, body = _http(srv.port, "/v1/chat/completions",
                          {"messages": [{"role": "user",
                                         "content": tok.decode(prompts[2])}],
                           "max_tokens": n})
        chat = json.loads(body)["choices"][0]["message"]
        got.append([int(w) for w in chat["content"].split()])
        st4, metrics = _http(srv.port, "/metrics")
    finally:
        srv.close()
    ref = [p8_engine_tokens(params, cfg, [p], n, 4)[0] for p in prompts[:3]]
    lines = dict(ln.split(" ", 1) for ln in metrics.strip().splitlines())
    if {st, st2, st3, st4} != {200} or got != ref:
        fail(f"phase 8 (api): completions {got} differ from Engine.run's {ref}")
    if int(lines["micromix_requests_total"]) != 3 or \
            int(lines["micromix_ttft_seconds_count"]) != 3:
        fail(f"phase 8 (api): /metrics says {lines}")
    return dict(tokens=got, metrics=lines)


def p8_router(params, cfg, prompts) -> dict:
    """A two-replica Router with the serve traffic: each replica's tokens
    against Engine.run of the requests it was given."""
    from micromix_tpu_torch.serve import Engine, Request, Router
    from micromix_tpu_torch.serve.sampling import SamplingParams
    router = Router([Engine(params, cfg, max_seqs=8, page_size=128,
                            kv_bits=4, decode_chunk=8, device=DEV)
                     for _ in range(2)])
    reqs = [Request(i, p, max_new_tokens=P8_NEW, sampling=SamplingParams())
            for i, p in enumerate(prompts)]
    picks = [router.submit(r) for r in reqs]
    while router.step():
        pass
    for rep in (0, 1):
        mine = [i for i, k in enumerate(picks) if k == rep]
        ref = p8_engine_tokens(params, cfg, [prompts[i] for i in mine], P8_NEW, 4)
        if [reqs[i].output for i in mine] != ref:
            fail(f"phase 8 (router): replica {rep}'s tokens differ from Engine.run's")
    return dict(assigned=picks, stats=router.stats)


def phase8(rng) -> dict:
    """The shell on the card at Llama-3.1-8B widths, P8_LAYERS layers
    (full depth would write and read a 16 GB bf16 checkpoint; 4 layers
    write about 3.9 GB), dense weights from SEED made on the card:

      1. the HF checkpoint directory under chiprun_out/ (two shards, the
         index, a stray consolidated file, config.json with llama3
         rope_scaling), by this script's own safetensors writer;
      2. ``cli._tokenizer`` replaced by ``IntTokenizer``;
      3. ``cli.main``: calibrate (4 synthetic windows of 2048), quantize,
         eval (synthetic perplexity), serve (8 prompts, int4 and int8 KV);
      4. the ApiServer on the loaded checkpoint (completion, stream, chat,
         /metrics over urllib) and a two-replica Router.

    Checks: the loaded dense tree equals the written one bit for bit;
    ``load_params`` equals the quantized tree made in memory from the
    same calibration; eval's perplexity equals ``eval_ppl`` of that tree;
    the greedy completions of serve, the API and the router equal
    ``Engine.run``'s on it; each run launches every kernel of its path,
    and the int8 serve launches H and C on int8 pages.  The checkpoints
    are deleted at the end."""
    import contextlib
    import io
    import shutil
    from micromix_tpu_torch import cli
    from micromix_tpu_torch.calib import load_calibration, smooth_quantize_model
    from micromix_tpu_torch.eval import eval_ppl
    from micromix_tpu_torch.eval.datasets import get_loaders
    from micromix_tpu_torch.models import checkpoint
    from micromix_tpu_torch.models.loader import config_from_hf, load_dense_params
    from micromix_tpu_torch.models.surgery import (quantize_model_int8_turbo,
                                                   quantize_model_weight_only)
    cfg = llama31_8b(P8_LAYERS)
    if config_from_hf(P8_HF_CONFIG) != cfg:
        fail("phase 8: config.json does not give Llama-3.1-8B's config")
    shutil.rmtree(P8_DIR, ignore_errors=True)
    hf, calib = os.path.join(P8_DIR, "hf"), os.path.join(P8_DIR, "calib.npz")
    qdir = os.path.join(P8_DIR, "quantized")
    stage, out = {}, {}
    t0 = time.perf_counter()
    dense = dense_llama(cfg, SEED, DEV)
    torch.cuda.synchronize()
    stage["make_dense"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hf_bytes = write_hf_checkpoint(dense, cfg, hf)
    stage["write_hf"] = time.perf_counter() - t0

    timer = P8Timer()
    saved = [timer.wrap(checkpoint, "save_params"),
             timer.wrap(checkpoint, "load_params")]
    tokenizer = cli._tokenizer
    cli._tokenizer = lambda args: IntTokenizer()
    runs = {}

    def shell(label, argv, must_launch, pages=None):
        buf = io.StringIO()

        def go():
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
        _, secs, launches, by_page = counted_run(f"phase 8 ({label})", go,
                                                 must_launch, pages)
        stage[label] = secs
        runs[label] = dict(launches=launches, page_launches=by_page)
        return buf.getvalue()

    traffic = p8_traffic(rng, cfg.vocab_size)
    prompts = os.path.join(P8_DIR, "prompts.txt")
    try:
        text = shell("calibrate", ["calibrate", "--model", hf, "--dataset",
                                   "synthetic", "--samples", "4", "--seqlen",
                                   "2048", "--output", calib],
                     ("flash_attention",))
        print("  calibrate: " + " | ".join(text.strip().splitlines()), flush=True)
        shell("quantize", ["quantize", "--model", hf, "--calibration", calib,
                           "--output", qdir], ())
        text = shell("eval", ["eval", "--model", hf, "--quantized-ckpt", qdir,
                              "--eval-ppl", "synthetic", "--log-dir",
                              os.path.join(P8_DIR, "results")],
                     ("flash_attention", "site_fakequant"))
        ppl = float(text.split("synthetic perplexity:")[1])
        # phase 15 (c): eval --tasks on the same checkpoint, under the
        # stand-in lm_eval (the card's machine has none)
        with mini_lm_eval(p15_tasks(cfg.vocab_size)):
            text = shell("eval_tasks", ["eval", "--model", hf,
                                        "--quantized-ckpt", qdir, "--tasks",
                                        "p15_mc", "--log-dir",
                                        os.path.join(P8_DIR, "results")],
                         FORWARD_KERNELS)
        out["eval_tasks"] = json.loads(text)
        print(f"  phase 15 (c), eval --tasks p15_mc: {json.dumps(out['eval_tasks'])} "
              f"in {stage['eval_tasks']:.1f}s", flush=True)
        with open(prompts, "w") as f:
            f.write("\n".join(IntTokenizer().decode(p) for p in traffic) + "\n")
        served = {}
        for kv in (4, 8):
            text = shell(f"serve_int{kv}",
                         ["serve", "--model", hf, "--quantized-ckpt", qdir,
                          "--prompts", prompts, "--kv-bits", str(kv),
                          "--max-new-tokens", str(P8_NEW), "--max-seqs", "8",
                          "--page-size", "128", "--decode-chunk", "8"],
                         LLAMA_KERNELS, pages=kv)
            lines = text.strip().splitlines()
            stats = json.loads(lines[-1])
            toks = [[int(w) for w in lines[i + 1].split()]
                    for i, ln in enumerate(lines[:-1]) if ln.startswith("--- [")]
            served[kv] = toks
            out[f"serve_int{kv}"] = stats
            print(f"  serve --kv-bits {kv}: " + json.dumps(
                {k: stats[k] for k in ("requests", "prefill_tokens",
                                       "decode_tokens", "wall_s",
                                       "decode_tokens_per_s", "mean_ttft_ms",
                                       "phase_s")}), flush=True)
        # speculation and the prefix cache through the CLI, int4 pages: the
        # prefix run's last four prompts come after its first four (four
        # slots) and share their prompts (one long prompt's first 2176
        # tokens, another long prompt whole)
        draft_dir = os.path.join(P8_DIR, "draft")
        t0 = time.perf_counter()
        draft_bytes = write_draft_checkpoint(draft_dir)
        stage["write_draft"] = time.perf_counter() - t0
        shared = [traffic[6], traffic[7], traffic[0], traffic[1],
                  traffic[6][:2176] + rng.integers(0, cfg.vocab_size, 64).tolist(),
                  traffic[7], traffic[2], traffic[3]]
        prefix_prompts = os.path.join(P8_DIR, "prefix_prompts.txt")
        with open(prefix_prompts, "w") as f:
            f.write("\n".join(IntTokenizer().decode(p) for p in shared) + "\n")
        base = ["serve", "--model", hf, "--quantized-ckpt", qdir, "--kv-bits",
                "4", "--max-new-tokens", str(P8_NEW), "--page-size", "128",
                "--decode-chunk", "8"]
        for label, flags, must in (
                ("serve_spec_ngram", ["--prompts", prompts, "--max-seqs", "8",
                                      "--spec-ngram", "2"], PLOOKUP_KERNELS),
                ("serve_draft", ["--prompts", prompts, "--max-seqs", "8",
                                 "--draft-model", draft_dir, "--spec-gamma", "4"],
                 PLOOKUP_KERNELS),
                ("serve_prefix_cache", ["--prompts", prefix_prompts, "--max-seqs",
                                        "4", "--prefix-cache"], LLAMA_KERNELS)):
            lines = shell(label, base + flags, must).strip().splitlines()
            stats = json.loads(lines[-1])
            out[label] = stats
            toks = [[int(w) for w in lines[i + 1].split()]
                    for i, ln in enumerate(lines[:-1]) if ln.startswith("--- [")]
            ok = (stats["requests"] == 8 and len(toks) == 8
                  and all(len(t) == P8_NEW for t in toks)
                  and all(0 <= w < cfg.vocab_size for t in toks for w in t))
            if label == "serve_prefix_cache":
                ok = ok and stats.get("prefix_hit_tokens", 0) >= 2176
            else:
                ok = ok and 0.0 <= stats.get("spec_accept_rate", -1.0) <= 1.0
            print(f"  serve {' '.join(flags[4:])}: " + json.dumps(stats),
                  flush=True)
            if not ok:
                fail(f"phase 8 ({label}): its stats line or completions")
        # the forms of ROADMAP item 8: the hetero, weight-only MXFP8 and int8
        # checkpoints, then a profiled serve of the hetero one
        for label, flags in (("quantize_hetero", ["--calibration", calib,
                                                  "--hetero"]),
                             ("quantize_weight_only", ["--weight-only", "mxfp8"]),
                             ("quantize_int8_turbo", ["--int8-turbo"])):
            shell(label, ["quantize", "--model", hf, *flags, "--output",
                          os.path.join(P8_DIR, label)], ())
        short = os.path.join(P8_DIR, "short_prompts.txt")
        with open(short, "w") as f:
            f.write("\n".join(IntTokenizer().decode(p) for p in traffic[:2]) + "\n")
        prof_dir = os.path.join(P8_DIR, "profile")
        lines = shell("serve_profile", [
            "serve", "--model", hf, "--quantized-ckpt",
            os.path.join(P8_DIR, "quantize_hetero"), "--prompts", short,
            "--max-new-tokens", "8", "--max-seqs", "2", "--page-size", "128",
            "--decode-chunk", "8", "--profile", prof_dir],
            ("site_fakequant_blocks", "w8_gemm", "paged_decode",
             "append_kv_quant", "flash_attention")).strip().splitlines()
        out["serve_profile"] = json.loads(lines[-1])
        out["profile"] = p8_trace(prof_dir)
        # phase 12 (f): serve --tp 2 on this checkpoint, two ranks that each
        # quantize their shard from the dense weights after the
        # calibration's smoothing (their kernels launch in the ranks)
        lines = shell("serve_tp", [
            "serve", "--model", hf, "--do-quant", "--calibration", calib,
            "--prompts", short, "--tp", "2", "--max-new-tokens", "8",
            "--max-seqs", "2", "--page-size", "128", "--decode-chunk", "8"],
            ()).strip().splitlines()
        toks = [[int(w) for w in lines[i + 1].split()]
                for i, ln in enumerate(lines[:-1]) if ln.startswith("--- [")]
        out["serve_tp"] = dict(stats=json.loads(lines[-1]), tokens=toks)
        if len(toks) != 2 or not all(len(t) == 8 and all(
                0 <= w < cfg.vocab_size for w in t) for t in toks):
            fail(f"phase 12 (f): serve --tp 2 printed {toks}")
        print("  phase 12 (f), serve --tp 2: " + json.dumps(out["serve_tp"]),
              flush=True)
        # phase 13 (e), (f): serve --tp 2 --port and --profile here
        out["p13"] = p13_serve(cli, hf, calib, np.random.default_rng(SEED + 13),
                               cfg.vocab_size)
        print(f"  quantize --hetero / --weight-only mxfp8 / --int8-turbo, then "
              f"serve --profile on the hetero checkpoint: "
              + json.dumps(out["serve_profile"]) + "; trace "
              + json.dumps(out["profile"]), flush=True)
    finally:
        cli._tokenizer = tokenizer
        checkpoint.save_params, checkpoint.load_params = saved

    # the checks against the model in memory
    t0 = time.perf_counter()
    loaded = load_dense_params(hf, device=DEV)
    torch.cuda.synchronize()
    stage["read_hf"] = time.perf_counter() - t0
    if not _same_tree(loaded, dense):
        fail("phase 8: the loaded dense tree differs from the one written")
    del loaded
    calibs, absmax = load_calibration(calib)
    smooth = {k: {"absmax": v} for k, v in absmax.items()}
    for label, make in (
            ("quantize_hetero", lambda: smooth_quantize_model(
                dict(dense, layers=list(dense["layers"])), cfg, smooth, calibs,
                alpha=0.5, hetero=True)),
            ("quantize_weight_only",
             lambda: quantize_model_weight_only(dense, cfg, "mxfp8")),
            ("quantize_int8_turbo", lambda: quantize_model_int8_turbo(dense, cfg))):
        qload, qcfg, _ = checkpoint.load_params(os.path.join(P8_DIR, label),
                                                device=DEV)
        if qcfg != cfg or not _same_tree(qload, make()):
            fail(f"phase 8 ({label}): the checkpoint differs from the tree "
                 "quantized in memory")
        del qload
    qmem = smooth_quantize_model(dense, cfg, smooth, calibs, alpha=0.5)
    del dense
    t0 = time.perf_counter()
    qload, qcfg, meta = checkpoint.load_params(qdir, device=DEV)
    torch.cuda.synchronize()
    stage["read_quantized"] = time.perf_counter() - t0
    if qcfg != cfg or not _same_tree(qload, qmem):
        fail("phase 8: load_params differs from the quantized tree in memory")
    del qload
    _, test = get_loaders("synthetic", IntTokenizer(), seqlen=2048)
    ppl_mem = eval_ppl(qmem, cfg, test, seqlen=2048)
    if not np.isfinite(ppl) or abs(ppl - ppl_mem) > 1e-4 * ppl_mem:
        fail(f"phase 8: eval's perplexity {ppl} against {ppl_mem} in memory")
    from micromix_tpu_torch.eval.lm_eval_adapter import Scorer, run_lm_eval
    with mini_lm_eval(p15_tasks(cfg.vocab_size)):
        tasks_mem = run_lm_eval(Scorer(qmem, cfg), IntTokenizer(),
                                ["p15_mc"])["results"]
    if out["eval_tasks"] != tasks_mem:
        fail(f"phase 15 (c): eval --tasks gave {out['eval_tasks']}, "
             f"run_lm_eval on the model in memory {tasks_mem}")
    for kv in (4, 8):
        ref = p8_engine_tokens(qmem, cfg, traffic, P8_NEW, kv)
        if served[kv] != ref:
            fail(f"phase 8: serve --kv-bits {kv} completions differ from "
                 "Engine.run's on the model in memory")
    api, stage["api"], _, _ = counted_run(
        "phase 8 (api)", lambda: p8_api(qmem, cfg, traffic), CONTROLS_KERNELS)
    router, stage["router"], _, _ = counted_run(
        "phase 8 (router)", lambda: p8_router(qmem, cfg, traffic), LLAMA_KERNELS)
    ck_bytes = _dir_bytes(qdir)
    shutil.rmtree(P8_DIR, ignore_errors=True)
    out.update(layers=P8_LAYERS, stage_s=stage, hf_bytes=hf_bytes,
               draft_bytes=draft_bytes,
               quantized_bytes=ck_bytes,
               quantized_write_s=timer.s["save_params"],
               quantized_read_s=timer.s["load_params"], eval_ppl=ppl,
               meta=meta, api=api, router=router,
               runs={k: {"launches": v["launches"],
                         "page_launches": {f"{n}/int{b}": c for (n, b), c
                                           in v["page_launches"].items()}}
                     for k, v in runs.items()})
    print(f"  stage seconds {json.dumps({k: round(v, 3) for k, v in stage.items()})}; "
          f"HF checkpoint {hf_bytes} bytes, written in {stage['write_hf']:.2f}s, "
          f"read in {stage['read_hf']:.2f}s; quantized checkpoint {ck_bytes} "
          f"bytes, written in {timer.s['save_params']} s, read in "
          f"{timer.s['load_params']} s; eval ppl {ppl}; API {api['tokens'][0][:4]}..., "
          f"router assigned {router['assigned']}", flush=True)
    main = collections.Counter()
    pages = collections.Counter()
    for label in ("eval_tasks", "serve_int4", "serve_int8", "serve_spec_ngram",
                  "serve_draft", "serve_prefix_cache", "serve_profile"):
        main.update(runs[label]["launches"])
        pages.update(runs[label]["page_launches"])
    out["main_launches"], out["main_page_launches"] = main, pages
    return out


# ----------------------------------------------------------------- phase 9

P9_GAMMA, P9_ROUNDS, P9_DRAFT_LAYERS = 4, 2, 4
P9_PREFIX, P9_TAIL, P9_SHARERS = 1024, 64, 7
P9_ENGINE = dict(max_seqs=8, page_size=128, max_pages_per_seq=16,
                 decode_chunk=8, prefill_chunk=512)
# the verify's B*S = 8 x (gamma + 1) = 40 rows: C under the lengths
# override, D, F at q|k|v and B at o and down
VERIFY_ROWS = (("paged_decode_lengths", 40), ("append_kv_quant", 40),
               ("w8_stack", 40), ("w8_gemm", 40))


def p9_caches(cfg, b: int, mp: int):
    """b slots of mp pages each (slot i on pages 1 + i*mp ...) and the
    scratch row on page 0."""
    from micromix_tpu_torch.serve.kv_cache import make_cache
    caches = [make_cache(b * mp + 1, 128, cfg.num_kv_heads, cfg.head_dim, b + 1,
                         mp, device=DEV) for _ in range(cfg.num_layers)]
    table = torch.zeros((b + 1, mp), dtype=torch.int32)
    table[:b] = 1 + torch.arange(b * mp, dtype=torch.int32).reshape(b, mp)
    for c in caches:
        c.page_table.copy_(table)
    return caches


def p9_clone(caches):
    return [dataclasses.replace(c, **{n: getattr(c, n).clone() for n in (
        "k_codes", "v_codes", "k_sz", "v_sz", "page_table", "lengths")})
        for c in caches]


def p9_prefill(params, cfg, caches, prompts, chunk=P9_ENGINE["prefill_chunk"]):
    """Prompt i into slot i as the engine prefills it: the prompts of at
    most ``chunk`` tokens in one ``prefill_batch`` over every slot (the
    others on the scratch row), padded to their bucket; each longer one in
    chunks of ``chunk``, each padded to its bucket, after the first over
    the paged history -> the last prompt position's logits (B, V)."""
    from micromix_tpu_torch.serve.runner import prefill, prefill_batch
    buckets = (16, 32, 64, 128, 256, 512, 1024, 2048)
    b = len(prompts)
    out = [None] * b
    short = [i for i, p in enumerate(prompts) if len(p) <= chunk]
    if len(short) >= 2:
        bucket = next(x for x in buckets if x >= max(len(prompts[i]) for i in short))
        toks = torch.zeros((b, bucket), dtype=torch.int32)
        seqs = torch.full((b,), b, dtype=torch.int32)
        last = torch.zeros((b,), dtype=torch.int32)
        for row, i in enumerate(short):
            toks[row, :len(prompts[i])] = torch.tensor(prompts[i])
            seqs[row], last[row] = i, len(prompts[i]) - 1
        logits, _ = prefill_batch(params, cfg, caches, toks.to(DEV),
                                  seqs.to(DEV), last.to(DEV))
        for row, i in enumerate(short):
            out[i] = logits[row]
    for i, p in enumerate(prompts):
        for start in range(0, len(p), chunk) if out[i] is None else ():
            n = min(chunk, len(p) - start)
            toks = torch.zeros((1, next(x for x in buckets if x >= n)),
                               dtype=torch.int32)
            toks[0, :n] = torch.tensor(p[start:start + n])
            logits, _ = prefill(params, cfg, caches, toks.to(DEV), i, start,
                                n - 1, hist_len=start)
            for c in caches:
                c.lengths[i] = start + n
            out[i] = logits[0]
        for c in caches:
            c.lengths[i] = len(p)
    return torch.stack(out)


@contextlib.contextmanager
def unpaired():
    """Decode steps in the per-site form (``MICROMIX_NO_PAIR=1``), the
    form ``verify_block`` computes."""
    os.environ["MICROMIX_NO_PAIR"] = "1"
    try:
        yield
    finally:
        del os.environ["MICROMIX_NO_PAIR"]


def verify_vs_decode(params, cfg, rng) -> dict:
    """Phase 9 (a): ``verify_block`` at B=8, gamma 4 (40 rows) against the
    decode chain teacher-forced on the same block, from one cache state,
    in the engine's form (the residual pairs) and in the per-site form
    that the verify computes; then all roll back (each row keeps 1 to 5
    positions) and score the next block.  Tolerance: phase 3's, 0.5 of the
    logit range."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.serve.runner import decode_step, verify_block
    from micromix_tpu_torch.serve.speculative import _set_lengths
    b, s, v = 8, P9_GAMMA + 1, cfg.vocab_size
    prompts = [rng.integers(0, v, int(rng.integers(96, 129))).tolist()
               for _ in range(b)]
    caches = p9_caches(cfg, b, 2)
    first = p9_prefill(params, cfg, caches, prompts).argmax(-1).to(torch.int32)
    seq = torch.arange(b, device=DEV, dtype=torch.int32)
    pos = torch.tensor([len(p) for p in prompts], device=DEV, dtype=torch.int32)
    block = torch.cat([first[:, None], torch.from_numpy(rng.integers(
        0, v, (b, s - 1)).astype(np.int32)).to(DEV)], dim=1)

    def chain(blk, at):
        cc = p9_clone(caches)
        return torch.stack([decode_step(params, cfg, cc, blk[:, j], seq,
                                        at + j)[0] for j in range(s)], 1)

    out = {}
    for label in ("block", "after rollback"):
        ref = chain(block, pos)
        with unpaired():
            ref_site = chain(block, pos)
        torch.cuda.synchronize()
        build.reset_launches()
        got, _ = verify_block(params, cfg, caches, block, seq, pos)
        torch.cuda.synchronize()
        rows = {f"{k}/{m}": build.row_launches[(k, m)] for k, m in VERIFY_ROWS}
        diff = float((got - ref).abs().max())
        span = float(ref.abs().max())
        rel = diff / span
        site = float((got - ref_site).abs().max())
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        out[label] = dict(max_abs_diff=diff, rel=rel, per_site_diff=site,
                          logit_span=span, argmax_agree=agree,
                          row_launches=rows)
        print(f"  (a) verify_block B={b} S={s} {label}: max |diff| {diff:.4e} "
              f"({rel:.4e} of the range, tolerance 0.5) against the paired "
              f"chain, {site:.4e} against the per-site chain, argmax "
              f"agreement {agree:.3f}, launches at 40 rows {rows}", flush=True)
        if rel > 0.5 or not all(rows.values()):
            fail(f"phase 9 (a): verify_block {label}: error {rel:.3e} of the "
                 f"range, or a kernel not at 40 rows: {rows}")
        keep = torch.arange(b, device=DEV, dtype=torch.int32) % s + 1
        pos = pos + keep
        _set_lengths(caches, seq, pos)
        block = torch.cat([block[torch.arange(b, device=DEV), keep.long() - 1][:, None],
                           torch.from_numpy(rng.integers(0, v, (b, s - 1))
                                            .astype(np.int32)).to(DEV)], dim=1)
    # the band of ``teacher_forced``: twice the per-site difference, at
    # least 1e-3 of the logit range
    out["band"] = max(2 * max(o["per_site_diff"] for o in out.values()),
                      1e-3 * max(o["logit_span"] for o in out.values()))
    return out


def teacher_forced(params, cfg, reqs, band: float, rows: int = 0) -> dict:
    """Every emitted token of ``reqs`` against the target fed the emitted
    tokens (``p9_prefill``, then the steps below): the token's logit must
    lie within ``band`` of the largest (JAX's definition of near-greedy,
    tests/test_speculative.py).  The steps: the engine's decode chain (all
    8 rows a step, the residual pairs) for the plain engine; with ``rows``
    (gamma + 1), ``verify_block`` over blocks of ``rows`` emitted tokens a
    slot, the form and the shapes the speculative engine verified them
    in.  Every row's arithmetic depends on its own inputs and the launch
    shapes alone, so the speculative stream is reproduced exactly where
    the engine kept its caches right; against the pairs instead, a
    random fp4 model turns a last-bit difference of another C split grid
    or rounding place into a sizable logit change now and then (phase
    3), which the result reports as ``paired``."""
    from micromix_tpu_torch.serve.runner import decode_step, verify_block
    b = len(reqs)
    caches = p9_caches(cfg, b, P9_ENGINE["max_pages_per_seq"])
    logits = p9_prefill(params, cfg, caches, [r.prompt for r in reqs])
    out = torch.tensor([r.output for r in reqs], device=DEV, dtype=torch.int32)
    seq = torch.arange(b, device=DEV, dtype=torch.int32)
    pos = torch.tensor([len(r.prompt) for r in reqs], device=DEV,
                       dtype=torch.int32)
    n = out.shape[1]
    gaps = [logits.max(-1).values - logits.gather(1, out[:, :1].long())[:, 0]]
    if rows:
        for j in range(0, n - 1, rows):
            blk = out[:, j:j + rows]
            blk = torch.cat([blk, blk[:, -1:].expand(b, rows - blk.shape[1])], 1)
            lg, _ = verify_block(params, cfg, caches, blk.contiguous(), seq,
                                 pos + j)
            for k in range(min(rows, n - 1 - j)):
                gaps.append(lg[:, k].max(-1).values - lg[:, k].gather(
                    1, out[:, j + k + 1:j + k + 2].long())[:, 0])
    else:
        for j in range(1, n):
            lg, _ = decode_step(params, cfg, caches, out[:, j - 1], seq,
                                pos + j - 1)
            gaps.append(lg.max(-1).values - lg.gather(1, out[:, j:j + 1].long())[:, 0])
    gaps = torch.stack(gaps).cpu()
    return dict(steps=int(gaps.numel()), not_argmax=int((gaps > 0).sum()),
                max_gap=float(gaps.max()), band=band,
                ok=bool((gaps <= band).all()))


def spec_window(eng, cfg) -> dict:
    """Kernel launches and host ms per speculative round over one call of
    ``spec_rounds`` rounds with the engine's params (every slot on the
    scratch row, greedy), and the device busy ms per round
    (``torch.profiler``) over one more call."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.serve.speculative import (PLookupState, SpecState,
                                                      plookup_decode_multi,
                                                      spec_decode_multi)
    b, r = eng.max_seqs, eng.spec_rounds
    z = torch.zeros(b, dtype=torch.int32, device=DEV)
    seq = torch.full((b,), b, dtype=torch.int32, device=DEV)
    kw = dict(gamma=eng.spec_gamma, n_rounds=r, greedy=True)

    def call():
        if eng.dcaches is None:
            st = PLookupState(tokens=torch.zeros((b, 16), dtype=torch.int32,
                                                 device=DEV),
                              length=z + 4, positions=z + 1)
            return plookup_decode_multi(eng.params, cfg, eng.caches, st, seq,
                                        None, z.float(), ngram=eng.spec_ngram,
                                        **kw)
        st = SpecState(prev=z, cur=z, positions=z + 1)
        return spec_decode_multi(eng.params, eng.draft_params, cfg,
                                 eng.draft_cfg, eng.caches, eng.dcaches, st,
                                 seq, None, z.float(), **kw)

    call()
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / r
    by_kernel = {k: v / r for k, v in build.launches.items()}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / r
    cuda = sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events()) / r
    return dict(host_ms_per_round=ms, kernel_launches_per_round=sum(
        by_kernel.values()), by_kernel=by_kernel, device_busy_ms_per_round=busy,
        cuda_launches_per_round=cuda)


def _per_token(st) -> dict:
    """ms per generated token: end to end (wall over tokens out) and over
    the decode phases (spec, decode, mixed) alone."""
    return dict(e2e_ms_per_token=1e3 * st["wall_s"] / st["tokens_out"],
                decode_ms_per_token=1e3 * st["decode_phase_s"] / st["decode_tokens"])


def p9_serve(cfg, params, reqs, label, must_launch, **kw):
    """``serve`` with the engine's decode-phase seconds, generated tokens
    and the verify's row launches kept, and ``must_launch`` checked."""
    from micromix_tpu_torch.kernels import build
    eng, st = serve(cfg, params, reqs, f"phase 9 ({label})", **kw)
    st["row_launches"] = {f"{k}/{m}": n for (k, m), n in build.row_launches.items()}
    st["decode_phase_s"] = sum(eng.phase_s[k] for k in ("spec", "decode", "mixed"))
    st["decode_tokens"] = eng.decode_tokens
    st["spec_proposed"], st["spec_accepted"] = eng.spec_proposed, eng.spec_accepted
    st["spec_rounds"] = eng.phase_steps["spec"]
    missing = [k for k in must_launch if not st["launches"].get(k)]
    if missing:
        fail(f"phase 9 ({label}): kernels not launched: {missing}")
    return eng, st


def phase9(rng, p4: dict) -> dict:
    """Speculative decoding and the prefix cache on the main path's model:
    Llama-3.1-8B widths, ScaledW8, 32 layers, int4 pages, random weights
    from SEED made on the card, stacked once and shared by every engine.

      (a) ``verify_vs_decode``;
      (b) the draft-model engine: the draft is the target's first 4 layers
          (aliased: the same stacked dicts, embed and head), gamma 4, 2
          rounds a call, on phase 4's kind of traffic beside the plain
          engine on the same requests; every request finishes and every
          emitted token passes ``teacher_forced``;
      (c) the prompt-lookup engine (ngram 2, gamma 3) on prompts that
          repeat a 16-token segment: where an output cycles, some
          proposals must have been accepted; ``teacher_forced`` too;
      (d) the prefix-cache engine: a request of a 1024-token prefix and a
          64-token tail, then seven sharing the prefix with their own
          tails (7 x 1024 hit tokens, each hit prefilled over the
          quantized history: H), then the first prompt again, which must
          replay the first request's output.

    Each engine run resets the launch counters just before it and reads
    them just after; together they must launch A to H, and the draft run C
    with the lengths override, D, F and B at the verify's 40 rows."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model,
                                                   stack_layer_projections)
    from micromix_tpu_torch.serve.engine import Request
    t9 = time.perf_counter()
    cfg = llama31_8b(32)
    params = stack_layer_projections(random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV))
    v = cfg.vocab_size
    out = {"verify": verify_vs_decode(params, cfg, rng)}

    # (b) the draft-model engine beside the plain engine, the same requests
    traffic = _traffic(rng, v)

    def copy(reqs):
        return [Request(r.req_id, list(r.prompt), max_new_tokens=r.max_new_tokens)
                for r in reqs]

    plain_reqs = copy(traffic)
    _, plain = p9_serve(cfg, params, plain_reqs, "plain", LLAMA_KERNELS,
                        **P9_ENGINE)
    # the plain engine's tokens against its own (paired) form: exact
    plain["teacher_forced"] = teacher_forced(params, cfg, plain_reqs, 0.0)
    band = out["verify"]["band"]
    draft = {**params, "layers": params["layers"][:P9_DRAFT_LAYERS]}
    spec_reqs = copy(traffic)
    eng, spec = p9_serve(cfg, params, spec_reqs, "draft", LLAMA_KERNELS,
                         draft_params=draft, draft_cfg=llama31_8b(P9_DRAFT_LAYERS),
                         spec_gamma=P9_GAMMA, spec_rounds=P9_ROUNDS, **P9_ENGINE)
    if eng.draft_params["layers"][0] is not eng.params["layers"][0]:
        fail("phase 9 (b): the draft holds a second copy of the target's layers")
    missing = [f"{k}/{m}" for k, m in VERIFY_ROWS
               if not spec["row_launches"].get(f"{k}/{m}")]
    if missing:
        fail(f"phase 9 (b): not launched at the verify's 40 rows: {missing}")
    spec["window"] = spec_window(eng, cfg)
    spec["teacher_forced"] = teacher_forced(params, cfg, spec_reqs, band,
                                            P9_GAMMA + 1)
    spec["teacher_forced_paired"] = teacher_forced(params, cfg, spec_reqs, band)
    del eng
    out.update(plain=plain, draft=spec)

    # (c) prompt lookup on prompts that repeat a segment
    look_reqs = []
    for i in range(8):
        seg = rng.integers(0, v, 16).tolist()
        look_reqs.append(Request(i, seg * int(rng.integers(6, 9)),
                                 max_new_tokens=32))
    eng, look = p9_serve(cfg, params, look_reqs, "prompt lookup",
                         SHORT_PLOOKUP_KERNELS, spec_ngram=2, spec_gamma=3,
                         spec_rounds=P9_ROUNDS, **P9_ENGINE)
    look["window"] = spec_window(eng, cfg)
    del eng
    cycles = [any(r.output[-p:] == r.output[-2 * p:-p] for p in range(1, 13))
              for r in look_reqs]
    look["cycling_outputs"] = sum(cycles)
    look["teacher_forced"] = teacher_forced(params, cfg, look_reqs, band, 4)
    look["teacher_forced_paired"] = teacher_forced(params, cfg, look_reqs, band)
    if any(cycles) and not look["spec_accepted"]:
        fail("phase 9 (c): outputs cycle but no lookup proposal was accepted")
    out["plookup"] = look

    # (d) the prefix cache
    from micromix_tpu_torch.serve.engine import Engine
    pc = Engine(params, cfg, seed=SEED, device=DEV, prefix_cache=True,
                **P9_ENGINE)
    prefix = rng.integers(0, v, P9_PREFIX).tolist()
    first = Request(0, prefix + rng.integers(0, v, P9_TAIL).tolist(),
                    max_new_tokens=32)
    sharers = [Request(1 + i, prefix + rng.integers(0, v, P9_TAIL).tolist(),
                       max_new_tokens=32) for i in range(P9_SHARERS)]
    replay = Request(99, list(first.prompt), max_new_tokens=32)
    runs, launches = {}, collections.Counter()
    for label, reqs in (("cold", [first]), ("sharers", sharers),
                        ("replay", [replay])):
        h0 = pc.prefix_hit_tokens
        p0 = pc.phase_s["prefill"] + pc.phase_s["mixed"]
        wall, ln, _ = engine_run(pc, reqs, f"phase 9 (prefix cache, {label})")
        launches.update(ln)
        if not all(r.done and len(r.output) == 32 for r in reqs):
            fail(f"phase 9 (d): {label} requests did not finish")
        runs[label] = dict(hit_tokens=pc.prefix_hit_tokens - h0, wall_s=wall,
                           prefill_s=pc.phase_s["prefill"] + pc.phase_s["mixed"] - p0,
                           ttft_s=[pc.ttft[r.req_id] for r in reqs],
                           launches=ln)
    if runs["cold"]["hit_tokens"] or \
            runs["sharers"]["hit_tokens"] != P9_SHARERS * P9_PREFIX:
        fail(f"phase 9 (d): prefix hits {runs['sharers']['hit_tokens']}, "
             f"want {P9_SHARERS * P9_PREFIX}")
    if runs["replay"]["hit_tokens"] != P9_PREFIX or replay.output != first.output:
        fail("phase 9 (d): the repeated prompt did not replay the first output")
    if not runs["sharers"]["launches"].get("paged_prefill"):
        fail("phase 9 (d): the prefix hits did not prefill through Kernel H")
    missing = [k for k in LLAMA_KERNELS if not launches.get(k)]
    if missing:
        fail(f"phase 9 (d): kernels not launched: {missing}")
    out["prefix"] = runs
    del pc, params
    torch.cuda.empty_cache()

    p4s = p4["stacked"]
    for label, st in (("plain", plain), ("draft", spec), ("prompt lookup", look)):
        extra = f"; teacher forced {st['teacher_forced']}"
        if st["spec_proposed"]:
            w = st["window"]
            extra = (f"; spec_accept_rate {st['spec_accepted'] / st['spec_proposed']:.4f}"
                     f" ({st['spec_accepted']} / {st['spec_proposed']}), "
                     f"{st['spec_rounds']} rounds; per round "
                     f"{w['kernel_launches_per_round']:.1f} kernel launches, "
                     f"{w['cuda_launches_per_round']:.1f} CUDA launches, host "
                     f"{w['host_ms_per_round']:.3f} ms, device busy "
                     f"{w['device_busy_ms_per_round']:.3f} ms") + extra
        st.update(_per_token(st))
        print(f"  ({'b' if label != 'prompt lookup' else 'c'}) {label}: "
              f"{st['requests_done']} requests, {st['tokens_out']} tokens, "
              f"{st['e2e_ms_per_token']:.3f} ms per generated token end to end, "
              f"{st['decode_ms_per_token']:.3f} over the decode phases{extra}",
              flush=True)
    print(f"  phase 4's plain engine (other requests of the same kind): "
          f"{1e3 * p4s['wall_s'] / p4s['tokens_out']:.3f} ms per generated token "
          f"end to end; its decode window "
          f"{p4s['decode_window']['kernel_launches_per_step']:.1f} kernel "
          f"launches a step", flush=True)
    print(f"  (c) outputs that cycle: {look['cycling_outputs']} of 8", flush=True)
    print(f"  (d) prefix cache: " + json.dumps(
        {k: {n: r[n] for n in ("hit_tokens", "prefill_s", "ttft_s", "wall_s")}
         for k, r in runs.items()}), flush=True)
    for label, st in (("draft", spec), ("prompt lookup", look)):
        print(f"  ({label}) against the paired chain: "
              f"{st['teacher_forced_paired']}", flush=True)
        if not st["teacher_forced"]["ok"] or not st["teacher_forced"]["steps"]:
            fail(f"phase 9 ({label}): an emitted token lies outside the band "
                 f"of the target's argmax: {st['teacher_forced']}")
    if not plain["teacher_forced"]["ok"]:
        fail(f"phase 9 (plain): the harness does not reproduce the plain "
             f"engine: {plain['teacher_forced']}")
    out["seconds"] = time.perf_counter() - t9
    return out


# ---------------------------------------------------------------- phase 10

P10_LAYERS = 28


def phase10(rng) -> dict:
    """Qwen2-7B at its published widths and full depth (28 layers of
    random ScaledW8 weights made on the card; q|k|v N = 4608 with its
    biases, gate|up N = 37888, down K = 18944, a 152064 x 3584 head, G =
    7): the default engine (stacked, paired decode since 3584 is a
    multiple of 512, pipelined) on phase 4's kind of traffic (two prompts
    of 1200-1500 tokens, so H runs at G = 7 over the history of every
    chunk after the first), then the same engine on bf16 KV pages; then 2
    layers on the card against the CPU as phase 3 does, on int4 and on
    bf16 pages."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    from micromix_tpu_torch.serve.runner import _can_pair
    cfg = qwen2_7b(P10_LAYERS)
    t10 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lay = params["layers"][0]
    codes_gib = sum(lay[n].w.codes.numel() for n in
                    ("q", "k", "v", "o", "gate", "up", "down")) * cfg.num_layers / 2 ** 30
    if lay["q"].bias is None:
        fail("phase 10: the Qwen2 model has no q/k/v bias")
    out = {}
    for bits in (4, 16):
        label = f"phase 10 ({'bf16' if bits == 16 else 'int4'} KV)"
        eng, stats = serve(cfg, params, _traffic(rng, cfg.vocab_size), label,
                           max_seqs=8, page_size=128, max_pages_per_seq=16,
                           decode_chunk=8, prefill_chunk=512, kv_bits=bits)
        if "qkv_stack" not in eng.params["layers"][0] \
                or not _can_pair(eng.params, cfg, 8):
            fail(f"{label}: the engine did not stack and pair its params")
        missing = [n for n in LLAMA_KERNELS if not stats["launches"].get(n)]
        if missing:
            fail(f"{label}: kernels never launched: {missing}")
        if not stats["decode_steps"]["mixed"] or not stats["pipelined_chunks"]:
            fail(f"{label}: no piggybacked chunk or no pipelined dispatch")
        stats["decode_window"] = decode_window(eng, cfg)
        stats.update(model_build_s=build_s, codes_gib=codes_gib)
        w = stats["decode_window"]
        print(f"  qwen2-7b, {P10_LAYERS} layers, {label}: engine "
              f"{stats['decode_ms_per_step']:.3f} ms/step, decode window "
              f"{w['ms_per_step']:.3f} ms/step host, "
              f"{w['device_busy_ms_per_step']:.3f} busy, "
              f"{w['cuda_launches_per_step']:.1f} CUDA launches/step; "
              f"{stats['pipelined_chunks']} pipelined chunks; peak "
              f"{stats['peak_mem_gib']:.2f} GiB; " + json.dumps(stats), flush=True)
        out["bf16" if bits == 16 else "int4"] = stats
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    cfg2 = qwen2_7b(2)
    for bits in (4, 16):
        out[f"card_vs_cpu_{'bf16' if bits == 16 else 'int4'}"] = card_vs_cpu(
            cfg2, P3_STEPS, ("flash_attention", "paged_prefill", "paged_decode",
                             "w8_stack", "w8_pair"),
            lambda p: _can_pair(p, cfg2, 1),
            name=f"qwen2-7b {'bf16' if bits == 16 else 'int4'} KV", bits=bits,
            prompt_len=P3_PROMPT)
    out["seconds"] = time.perf_counter() - t10
    return out


# ---------------------------------------------------------------- phase 11

P11_LAYERS = 32
P11_FORMS = ("hetero", "mxfp4", "mxfp8", "int8")
P11_MOE_LAYERS = 4
P11_MOE_SEQLEN, P11_MOE_CAL, P11_MOE_EVAL = 512, 2, 2
ATTENTION_KERNELS = ("paged_decode", "append_kv_quant", "flash_attention",
                     "paged_prefill")
# the kernels each form's path launches besides the attention kernels:
# the hetero sites on A's block-format route, then B per consumer (no
# stack, no pair); weight-only MXFP4 on B; MXFP8 (dequantize +
# torch.matmul) and int8 (torch._int_mm) on none of the port's
FORM_KERNELS = {"hetero": ("site_fakequant_blocks", "w8_gemm"),
                "mxfp4": ("w8_gemm",), "mxfp8": (), "int8": ()}
FORM_LINEAR = {"hetero": "QuantLinear", "mxfp4": "WeightOnlyLinear",
               "mxfp8": "WeightOnlyLinear", "int8": "Int8TurboLinear"}


def p11_quantize(form: str, dense, cfg, calibs):
    """The dense model -> one of phase 11's forms (``dense`` is kept)."""
    from micromix_tpu_torch.models.hetero import quantize_model_hetero
    from micromix_tpu_torch.models.surgery import (quantize_model_int8_turbo,
                                                   quantize_model_weight_only)
    if form == "hetero":
        return quantize_model_hetero(dense, cfg, calibs)
    if form == "int8":
        return quantize_model_int8_turbo(dense, cfg)
    return quantize_model_weight_only(dense, cfg, form)


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


@contextlib.contextmanager
def refuse_plain(label: str):
    """Kernel A's (both routes) and Kernel B's plain versions fail the run
    if anything calls them meanwhile."""
    import importlib
    fakequant = importlib.import_module("micromix_tpu_torch.kernels.fakequant")
    matmul = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")
    names = ((fakequant, "fakequant_site_plain"),
             (fakequant, "fakequant_site_blocks_plain"),
             (matmul, "mixed_matmul_w8_plain"))
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]

    def refuse(*args, **kwargs):
        fail(f"{label}: a kernel's plain version ran on the card")

    for mod, n in names:
        setattr(mod, n, refuse)
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def form_serve(cfg, params, reqs, form: str, label: str, **kw):
    """``serve`` of one form with the plain versions refused; it must
    launch the attention kernels its traffic needs and its form's
    kernels, and no other kernel of the port."""
    allowed = set(ATTENTION_KERNELS) | set(FORM_KERNELS[form])
    with refuse_plain(label):
        eng, stats = serve(cfg, params, reqs, label, **kw)
        stats["decode_window"] = decode_window(eng, cfg)
    launches = stats["launches"]
    need = [k for k in ATTENTION_KERNELS
            if k != "paged_prefill" or kw.get("prefill_chunk")]
    missing = [k for k in need + list(FORM_KERNELS[form]) if not launches.get(k)]
    stray = [k for k, n in launches.items() if n and k not in allowed]
    if missing or stray:
        fail(f"{label}: kernels not launched {missing}, off its path {stray}")
    if "qkv_stack" in eng.params["layers"][0]:
        fail(f"{label}: the engine stacked a {form} layer")
    return eng, stats


def phase11(rng, calibs) -> dict:
    """Llama-3.1-8B widths, P11_LAYERS layers, dense weights from SEED made
    on the card (phase 7's model; its calibrations give the hetero budgets): the
    default engine serves phase 4's traffic with the hetero form, weight-
    only MXFP4 and MXFP8 and int8 in turn, each launching its path's
    kernels and no plain version; then 2 layers of each form card against
    CPU as phase 3 does (a 200-token prompt in chunks of 128, 4 decode
    steps); then the Mixtral pipeline (``p11_moe``)."""
    from micromix_tpu_torch.models.hetero import budgets
    cfg = llama31_8b(P11_LAYERS)
    t11 = time.perf_counter()
    dense = dense_llama(cfg, SEED, DEV)
    out = {"forms": {}}
    for form in P11_FORMS:
        t0 = time.perf_counter()
        params = p11_quantize(form, dense, cfg, calibs[:P11_LAYERS])
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        params_gib = _tree_bytes(params["layers"]) / 2 ** 30
        if form == "hetero":
            b = sorted(budgets(params))
            out["hetero_budgets"] = b
            print(f"  hetero: {len(b)} distinct (k4, k6, k8) budgets over the "
                  f"{4 * cfg.num_layers} sites of {cfg.num_layers} layers: {b}",
                  flush=True)
        label = f"phase 11 ({form})"
        resident = torch.cuda.memory_allocated() / 2 ** 30
        eng, stats = form_serve(cfg, params, _traffic(rng, cfg.vocab_size),
                                form, label, max_seqs=8, page_size=128,
                                max_pages_per_seq=16, decode_chunk=8,
                                prefill_chunk=512)
        over = stats["peak_mem_gib"] - resident
        stats.update(quantize_s=quant_s, params_gib=params_gib,
                     peak_over_resident_gib=over,
                     peak_alone_gib=params_gib + over)
        w = stats["decode_window"]
        print(f"  {form}, {P11_LAYERS} layers: engine "
              f"{stats['decode_ms_per_step']:.3f} ms/step; decode window "
              f"{w['ms_per_step']:.3f} ms/step host, "
              f"{w['device_busy_ms_per_step']:.3f} busy, "
              f"{w['cuda_launches_per_step']:.1f} CUDA launches/step; "
              f"weights {params_gib:.2f} GiB, serving peak without the dense "
              f"model {params_gib + over:.2f} GiB; " + json.dumps(stats),
              flush=True)
        out["forms"][form] = stats
        del eng, params
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()
    cfg2 = llama31_8b(2)
    for form in P11_FORMS:
        out[f"card_vs_cpu_{form}"] = card_vs_cpu(
            cfg2, 4, ("flash_attention", "paged_prefill", "paged_decode")
            + FORM_KERNELS[form],
            lambda p, form=form: type(p["layers"][0]["q"]).__name__ == FORM_LINEAR[form],
            name=f"llama {form}", prompt_len=200,
            make=lambda form=form: p11_quantize(
                form, dense_llama(cfg2, SEED, DEV), cfg2, calibs[:2]))
    out["moe"] = p11_moe(rng)
    out["seconds"] = time.perf_counter() - t11
    return out


def p11_moe(rng) -> dict:
    """The MoE calibrate -> smooth -> quantize (segmented and hetero) ->
    perplexity pipeline at Mixtral-8x7B widths, P11_MOE_LAYERS layers (the
    dense model at full depth, about 93 GB of bf16, exceeds the card; 4
    layers are about 11.6 GB), dense weights from SEED made on the card:
    calibration on P11_MOE_CAL windows of P11_MOE_SEQLEN (the experts'
    routed-row masks), smoothing with the expert fan-out, both quantized
    forms and every perplexity on the next P11_MOE_EVAL windows; quantized
    ppl under 1.25 x dense, hetero within 1% of segmented.  Then the
    hetero Mixtral serves four requests."""
    from micromix_tpu_torch.calib import (average_bits, collect_calibration,
                                          smooth_params, stats_to_calibration)
    from micromix_tpu_torch.eval import eval_ppl, synthetic_tokens
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.models.hetero import budgets, quantize_model_hetero
    from micromix_tpu_torch.models.surgery import quantize_model
    from micromix_tpu_torch.serve.engine import Request
    cfg = mixtral_8x7b(P11_MOE_LAYERS)
    seqlen, n_cal = P11_MOE_SEQLEN, P11_MOE_CAL
    stream = synthetic_tokens(cfg.vocab_size, (n_cal + P11_MOE_EVAL) * seqlen,
                              seed=SEED)
    windows = [stream[i * seqlen:(i + 1) * seqlen][None, :] for i in range(n_cal)]
    test = stream[n_cal * seqlen:]
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return r

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    dense = timed("make_dense", lambda: dense_llama(cfg, SEED, DEV))
    stats = timed("calibrate", lambda: collect_calibration(dense, cfg, windows))
    calibs = stats_to_calibration(stats, cfg)
    ppl = {"dense": timed("dense_ppl", lambda: eval_ppl(dense, cfg, test,
                                                         seqlen=seqlen))}
    smoothed = timed("smooth", lambda: smooth_params(dense, cfg, stats))
    del dense
    seg = timed("quantize", lambda: quantize_model(smoothed, cfg, calibs))
    ppl["segmented"] = timed("quant_ppl", lambda: eval_ppl(seg, cfg, test,
                                                           seqlen=seqlen))
    del seg
    het = timed("quantize_hetero", lambda: quantize_model_hetero(smoothed, cfg,
                                                                 calibs))
    del smoothed
    ppl["hetero"] = timed("hetero_ppl", lambda: eval_ppl(het, cfg, test,
                                                         seqlen=seqlen))
    launches = dict(build.launches)
    out = dict(layers=P11_MOE_LAYERS, seqlen=seqlen, calib_windows=n_cal,
               eval_windows=P11_MOE_EVAL, ppl=ppl, stage_s=secs,
               average_bits=average_bits(calibs, cfg),
               hetero_budgets=len(budgets(het)),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    print(f"  Mixtral-8x7B widths, {P11_MOE_LAYERS} layers: " + json.dumps(out),
          flush=True)
    if not all(np.isfinite(v) for v in ppl.values()):
        fail("phase 11 (Mixtral): perplexity not finite")
    if ppl["segmented"] >= 1.25 * ppl["dense"]:
        fail(f"phase 11 (Mixtral): quantized ppl {ppl['segmented']} over 1.25 x "
             f"dense {ppl['dense']}")
    if abs(ppl["hetero"] - ppl["segmented"]) > 0.01 * ppl["segmented"]:
        fail(f"phase 11 (Mixtral): hetero ppl {ppl['hetero']} not within 1% "
             f"of segmented {ppl['segmented']}")
    missing = [k for k in ("flash_attention", "site_fakequant", "w8_gemm",
                           "site_fakequant_blocks") if not launches.get(k)]
    if missing:
        fail(f"phase 11 (Mixtral pipeline): kernels not launched: {missing}")
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(96, 129))).tolist(),
                    max_new_tokens=16) for i in range(4)]
    eng, st = form_serve(cfg, het, reqs, "hetero", "phase 11 (hetero Mixtral)",
                         max_seqs=4, page_size=128, max_pages_per_seq=2,
                         decode_chunk=8)
    w = st["decode_window"]
    print(f"  hetero Mixtral, {P11_MOE_LAYERS} layers: {st['requests_done']} "
          f"requests answered; decode window {w['ms_per_step']:.3f} ms/step "
          f"host, {w['device_busy_ms_per_step']:.3f} busy, "
          f"{w['cuda_launches_per_step']:.1f} CUDA launches/step", flush=True)
    out["serve"] = st
    del eng, het
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 12

P12_TP = 2
# (b) serves the first 4 of phase 7's 32 layers: at 32 layers 320 of its
# 437 ms a step were 64 host-staged gloo all_reduces, time of the
# script's 1200 s spent on the same kernels and shapes (PERF.md section
# 4); phase 11 serves all 32 layers' budgets on one card, and phase 16
# serves two more tp=2 replicas at 4 layers
P12_LAYERS = 4
P12_SMALL_LAYERS = 4
# the row-parallel shard shapes of Llama-3.1-8B at tp=2: o (N=4096,
# K=4096/2) and down (K=14336/2), at decode rows and a 512-row chunk
P12_GEMMS = ((8, 4096, 2048, "o"), (8, 4096, 7168, "down"),
             (512, 4096, 2048, "o chunk"))
SPLIT_2048 = (1792, 128, 128)
SPLIT_7168 = (6912, 128, 128)
# what each phase 12 run must launch on every rank
TP_KERNELS = ("site_fakequant", "w8_gemm", "w8_gemm_f32", "paged_decode",
              "append_kv_quant", "flash_attention", "paged_prefill",
              "mx_quantize")
TP_HETERO_KERNELS = ("site_fakequant_blocks", "w8_gemm", "w8_gemm_f32",
                     "paged_decode", "append_kv_quant", "flash_attention")
TP_SYMMETRIC_KERNELS = ("mx_quantize", "sp_gemm", "sp_gemm_f32",
                        "paged_decode", "append_kv_quant", "flash_attention")
EP_KERNELS = ("site_fakequant", "w8_gemm", "w8_grouped", "paged_decode",
              "append_kv_quant", "flash_attention")


def close_f32(got, ref, a, w):
    """f32 outputs of the same exact products summed in another order:
    |got - ref| <= 2 K 2^-24 (|A| |W|^T), each side's bound for a sum of K
    terms in any order (gamma_K)."""
    k = a.shape[1]
    bound = 2 * k * 2.0 ** -24 * torch.matmul(a.abs().float(), w.abs().float().t())
    err = (got.float() - ref.float()).abs()
    return float(err.max()), bool((err <= bound).all())


def check_f32_gemms(results, timer) -> dict:
    """Kernels B and K with f32 output (a tensor-parallel rank's partial)
    at the row-parallel shard shapes of Llama-3.1-8B at tp=2, against
    their plain versions; B's and K's bf16 output must equal their f32
    output rounded to bf16, bit for bit, on the same inputs and split."""
    from micromix_tpu_torch.kernels.fakequant import fakequant_values
    from micromix_tpu_torch.kernels.mixed_matmul import (
        mixed_matmul_sp, mixed_matmul_sp_plain, mixed_matmul_w8,
        mixed_matmul_w8_plain)
    from micromix_tpu_torch.kernels.quantize import quantize_mixed
    from micromix_tpu_torch.mx.mxtensor import dequantize_mixed_device
    from micromix_tpu_torch.mx.scaledw8 import dequantize_scaled_w8
    f32 = torch.float32
    rounded = {}
    for m, n, k, what in P12_GEMMS:
        splits = SPLIT_2048 if k == 2048 else SPLIT_7168
        w = _w8_weight(n, k, splits)
        wd = dequantize_scaled_w8(w, torch.bfloat16)
        a = fakequant_values(torch.randn(m, k, device=DEV), *splits)
        got = mixed_matmul_w8(a, w, f32)
        err, ok = close_f32(got, mixed_matmul_w8_plain(a, w, f32), a, wd)
        same = torch.equal(mixed_matmul_w8(a, w), got.to(torch.bfloat16))
        rounded[f"w8_gemm M={m} K={k}"] = same
        record(results, "w8_gemm", f"M={m} N={n} K={k} f32 ({what}, tp=2)", err,
               "2K 2^-24 (|A||W|^T); bf16 out == f32 out rounded", ok and same,
               timer.ms(lambda: mixed_matmul_w8(a, w, f32)),
               m * k * 2 + n * k + m * n * 4, 2.0 * m * n * k,
               timer.ms(lambda: mixed_matmul_w8_plain(a, w, f32)),
               timer.ms(lambda: torch.matmul(a, wd.t())),
           rerun=lambda: mixed_matmul_w8(a, w, f32))
        del w, wd
    # K at a shard's budgets as phase 7's calibration splits them: the
    # fp6 / fp8 widths are multiples of 32, not 128 (partial steps)
    for m, n, k, what, splits in (
            (8, 4096, 2048, "o", SPLIT_2048), (8, 4096, 7168, "down", SPLIT_7168),
            (8, 4096, 2048, "o, segments of 32s", (576, 1024, 448))):
        w = _sp_weight(n, k, splits, fp4_only=False)
        a = quantize_mixed(_site_input(m, k), *splits)
        ad, wd = dequantize_mixed_device(a), dequantize_mixed_device(w)
        got = mixed_matmul_sp(a, w, f32)
        err, ok = close_f32(got, mixed_matmul_sp_plain(a, w, f32), ad, wd)
        same = torch.equal(mixed_matmul_sp(a, w), got.to(torch.bfloat16))
        rounded[f"sp_gemm M={m} K={k} {splits}"] = same
        record(results, "sp_gemm", f"M={m} N={n} K={k} f32 fp6/fp8 {splits} ({what}, tp=2)",
               err, "2K 2^-24 (|A||W|^T); bf16 out == f32 out rounded",
               ok and same, timer.ms(lambda: mixed_matmul_sp(a, w, f32)),
               _mx_bytes(a) + _mx_bytes(w) + m * n * 4, 2.0 * m * n * k,
               timer.ms(lambda: mixed_matmul_sp_plain(a, w, f32)),
               timer.ms(lambda: torch.matmul(ad, wd.t())),
           rerun=lambda: mixed_matmul_sp(a, w, f32))
        del w, wd
    return rounded


@contextlib.contextmanager
def refuse_plain_kernels(label: str):
    """The plain versions of A (both routes), B, E, J and K, and the plain
    PyTorch append, fail the run if anything on the card calls them."""
    import importlib
    mods = {m: importlib.import_module(f"micromix_tpu_torch.{m}") for m in
            ("kernels.fakequant", "kernels.mixed_matmul", "kernels.quantize",
             "kernels.flash_attention", "serve.kv_cache")}
    names = (("kernels.fakequant", "fakequant_site_plain"),
             ("kernels.fakequant", "fakequant_site_blocks_plain"),
             ("kernels.mixed_matmul", "mixed_matmul_w8_plain"),
             ("kernels.mixed_matmul", "mixed_matmul_sp_plain"),
             ("kernels.quantize", "quantize_mixed_plain"),
             ("kernels.flash_attention", "flash_attention_plain"),
             ("serve.kv_cache", "append_kv_plain"))
    saved = [(mods[m], n, getattr(mods[m], n)) for m, n in names]

    def refuse(*args, **kwargs):
        fail(f"{label}: a kernel's plain version ran on the card")

    for mod, n, _ in saved:
        setattr(mod, n, refuse)
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def p12_requests(specs):
    from micromix_tpu_torch.serve.engine import Request
    return [Request(i, list(p), max_new_tokens=n) for i, (p, n) in enumerate(specs)]


def p12_specs(rng, vocab: int, lens, new: int):
    return [(rng.integers(0, vocab, n).tolist(), new) for n in lens]


def p12_tp_model(cfg, calibs, group, seed: int, hetero=False,
                 weight_fp4_only=True):
    """The rank's tree of a tensor-parallel Llama: each dense layer drawn
    from the seed (``dense_layer``, as ``dense_llama`` draws them), the
    rank's shard of it quantized (``group``: the common bases and
    fallbacks agreed over the ranks), the dense layer dropped; then the
    embedding and head, whole."""
    from micromix_tpu_torch.parallel.tp_hetero import quantize_layer_tp_hetero
    from micromix_tpu_torch.parallel.tp_quant import quantize_layer_tp
    gen = torch.Generator(device=DEV).manual_seed(seed)
    layers = []
    for calib in calibs:
        p = dense_layer(cfg, gen, DEV)
        if hetero:
            layers.append(quantize_layer_tp_hetero(p, cfg, calib, group.world,
                                                   group=group))
        else:
            layers.append(quantize_layer_tp(p, cfg, calib, group.world,
                                            weight_fp4_only=weight_fp4_only,
                                            group=group))
        del p
    hid = cfg.hidden_size
    embed = _normal(gen, (cfg.vocab_size, hid), 0.02, DEV)
    return {"embed": embed,
            "final_ln": torch.ones(hid, dtype=torch.bfloat16, device=DEV),
            "lm_head": _normal(gen, (cfg.vocab_size, hid), 0.02, DEV),
            "layers": layers}


def p12_window(eng, group, steps: int = 8) -> dict:
    """A rank's decode window (``decode_window`` through the engine's own
    step program): host ms, kernel launches, all_reduces and their host
    ms a step over one chunk, then device busy ms and all CUDA launches a
    step under ``torch.profiler`` over one more."""
    from micromix_tpu_torch.kernels import build
    from torch.profiler import ProfilerActivity, profile
    b = eng.max_seqs
    z = torch.zeros(b, dtype=torch.int32, device=DEV)
    seq = torch.full((b,), b, dtype=torch.int32, device=DEV)
    kw = dict(gen=None, temps=torch.zeros(b, device=DEV), top_k=z,
              top_p=torch.ones(b, device=DEV), controls=None, n_steps=steps,
              sample_mode="greedy")

    def chunk(start):
        eng._sf.decode_multi(eng.params, eng.caches, z, seq, z + start, **kw)
        torch.cuda.synchronize()

    chunk(0)
    build.reset_launches()
    group.reset_counts()
    t0 = time.perf_counter()
    chunk(steps)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {k: v / steps for k, v in build.launches.items()}
    reduces, reduce_ms = group.reduces / steps, group.reduce_s * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk(2 * steps)
    busy, cuda_launches = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.device_time_total / 1e3
            cuda_launches += 1
    if busy <= 0.0:
        fail("phase 12: the profiler saw no device time")
    return dict(ms_per_step=ms, kernel_launches_per_step=sum(launches.values()),
                by_kernel=launches, all_reduces_per_step=reduces,
                all_reduce_ms_per_step=reduce_ms,
                device_busy_ms_per_step=busy / steps,
                cuda_launches_per_step=cuda_launches / steps)


def p12_serve(eng, specs, group, label: str, must_launch) -> dict:
    """A rank's engine run with the launch counters and the group's reduce
    counts reset just before it and read just after, the plain versions
    refused; every request must finish with its tokens; then the decode
    window."""
    from micromix_tpu_torch.kernels import build
    reqs = p12_requests(specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    group.reset_counts()
    with refuse_plain_kernels(label):
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(build.launches)
    missing = [k for k in must_launch if not launches.get(k)]
    # an f32 call of B or K counts under its kernel's name too: the bf16
    # output is proven by more launches there than f32 ones
    missing += [f"{k} (bf16 out)" for k in ("w8_gemm", "sp_gemm")
                if f"{k}_f32" in must_launch
                and launches.get(k, 0) <= launches.get(f"{k}_f32", 0)]
    if missing:
        fail(f"{label}: rank {group.rank}: kernels not launched: {missing}")
    if not all(r.done and len(r.output) == r.max_new_tokens for r in reqs):
        fail(f"{label}: rank {group.rank}: a request did not finish")
    steps = eng.phase_steps["decode"]
    stats = dict(tokens=[r.output for r in reqs], launches=launches, wall_s=wall,
                 prefill_s=eng.phase_s["prefill"],
                 decode_ms_per_step=(1e3 * eng.phase_s["decode"] / steps
                                     if steps else None),
                 decode_steps=steps, all_reduces=group.reduces,
                 all_reduce_s=group.reduce_s,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    with refuse_plain_kernels(label):
        stats["decode_window"] = p12_window(eng, group)
    return stats


def _p12_pick(g, c, rel: float, tie_ok: bool):
    """Greedy tokens of one unit on both sides: equal, or, where
    ``tie_ok`` (phase 3's rule: the last prefill chunk only), a near tie
    (the CPU's two top logits closer than the unit's difference, and the
    card on the CPU's second) -> (card token, cpu token, accepted)."""
    gt, ct = int(torch.argmax(g)), int(torch.argmax(c))
    if gt == ct:
        return gt, ct, True
    if not tie_ok:
        return gt, ct, False
    top = torch.topk(c, 2)
    margin = float(top.values[0] - top.values[1]) / float(c.abs().max())
    return gt, ct, margin < rel and gt == int(top.indices[1])


def p12_units(run_a, run_b, cfg, prompt, steps: int, chunk: int = 128,
              label: str = "") -> dict:
    """A prompt in chunks (a flash chunk, then chunks over the paged
    history), then greedy decode steps, each unit run by ``run_a(kind,
    args)`` and ``run_b(kind, args)`` -> logits (1, V) on each side; the
    units follow side A's tokens.  Greedy tokens equal at every unit but
    the last prefill chunk, which may be a near tie (phase 3's rule);
    logits within 0.5 of side B's range."""
    rels, toks_a, toks_b, ties = [], [], [], 0

    def unit(kind, args, tie_ok=False):
        nonlocal ties
        g = run_a(kind, args)[0].float().cpu()
        c = run_b(kind, args)[0].float().cpu()
        rel = float((g - c).abs().max()) / float(c.abs().max())
        rels.append(rel)
        gt, ct, ok = _p12_pick(g, c, rel, tie_ok)
        if not ok:
            fail(f"phase 12 ({label}): {kind} greedy tokens {gt} / {ct} differ")
        ties += gt != ct
        toks_a.append(gt)
        toks_b.append(ct)

    starts = range(0, len(prompt), chunk)
    for start in starts:
        unit("prefill", (prompt[start:start + chunk], start),
             tie_ok=start == starts[-1])
    for i in range(steps):
        unit("decode", (toks_a[-1], len(prompt) + i))
    if max(rels) > 0.5:
        fail(f"phase 12 ({label}): logit error {max(rels):.3e} over 0.5")
    return dict(tokens=toks_a, other_tokens=toks_b, near_ties=ties,
                logit_rel_err=rels)


def _p12_caches(cfg, n_kv, device, prompt_len, steps, ps=128):
    from micromix_tpu_torch.serve.kv_cache import make_cache
    mp = -(-(prompt_len + steps + 1) // ps)
    caches = [make_cache(mp + 1, ps, n_kv, cfg.head_dim, 1, mp, device=device)
              for _ in range(cfg.num_layers)]
    for c in caches:
        c.page_table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
    return caches


def _p12_runner(params, cfg, caches, device, prefill_fn, decode_fn):
    """run(kind, args) over ``caches`` (kept in a one-element list)."""
    def run(kind, args):
        if kind == "prefill":
            toks, start = args
            t = torch.tensor([toks], device=device)
            logits, caches[0] = prefill_fn(params, cfg, caches[0], t, 0, start,
                                           hist_len=start)
        else:
            tok, pos = args
            logits, caches[0] = decode_fn(
                params, cfg, caches[0], torch.tensor([tok], device=device),
                torch.zeros(1, dtype=torch.int32, device=device),
                torch.tensor([pos], dtype=torch.int32, device=device))
        return logits
    return run


def p12_card_vs_cpu(params, cfg_run, group, prefill_fn, decode_fn, n_kv,
                    prompt_len, steps, label) -> dict:
    """The rank's units on the card and, from a CPU copy of the card's
    state taken just before each, the same units on the CPU (its
    all_reduces over gloo too); the card goes on from its own result."""
    cpu_params = params_to(params, "cpu")
    prompt = np.random.default_rng(SEED).integers(0, cfg_run.vocab_size,
                                                  prompt_len).tolist()
    gcaches = [_p12_caches(cfg_run, n_kv, DEV, prompt_len, steps)]
    card = _p12_runner(params, cfg_run, gcaches, DEV, prefill_fn, decode_fn)
    before = []

    def card_unit(kind, args):
        before.append(params_to(gcaches[0], "cpu"))
        return card(kind, args)

    def cpu_unit(kind, args):
        return _p12_runner(cpu_params, cfg_run, [before.pop()], "cpu",
                           prefill_fn, decode_fn)(kind, args)

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // group.world))
    t0 = time.perf_counter()
    try:
        out = p12_units(card_unit, cpu_unit, cfg_run, prompt, steps, label=label)
    finally:
        torch.set_num_threads(threads)
    out["wall_s"] = time.perf_counter() - t0
    return out


def p12_tp_rank(group, calibs, specs, small_specs) -> dict:
    """One rank of phase 12's tensor-parallel runs (b)-(d) on the card."""
    import functools
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   quantize_layer,
                                                   stack_layer_projections)
    from micromix_tpu_torch.parallel import make_tp_engine
    from micromix_tpu_torch.parallel.tp_quant import (local_config,
                                                      quantize_layer_tp)
    from micromix_tpu_torch.parallel.tp_serve import tp_decode_step, tp_prefill
    from micromix_tpu_torch.serve.runner import decode_step, prefill
    out = {"backend": group.backend, "device": str(group.device)}
    eng_kw = dict(seed=SEED, max_seqs=8, page_size=128, decode_chunk=8)

    # (b) Llama-3.1-8B widths, the first P12_LAYERS of phase 7's layers
    cfg = llama31_8b(P12_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = p12_tp_model(cfg, calibs[:P12_LAYERS], group, SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    codes = _tree_bytes(tree["layers"])
    eng = make_tp_engine(tree, cfg, group, max_pages_per_seq=16,
                         prefill_chunk=512, **eng_kw)
    if eng.caches[0].n_kv_heads != cfg.num_kv_heads // group.world:
        fail("phase 12 (b): the rank's cache does not hold nkv / tp heads")
    st = p12_serve(eng, specs, group, "phase 12 (b)", TP_KERNELS)
    st.update(model_build_s=build_s, build_peak_mem_gib=build_peak,
              layer_bytes=codes, cache_heads=eng.caches[0].n_kv_heads)
    out["b"] = st
    del eng, tree
    torch.cuda.empty_cache()

    # (c) two layers: the ranks on the card against the same ranks on the
    # CPU; then identity calibration and k4-only budgets against the
    # single-card runner (rank 0) on the same dense weights
    cfg2 = llama31_8b(2)
    cfg2_l = local_config(cfg2, group.world)
    tp_pre = functools.partial(tp_prefill, group=group)
    tp_dec = functools.partial(tp_decode_step, group=group)
    tree = p12_tp_model(cfg2, calibs[:2], group, SEED + 12)
    out["c_cpu"] = p12_card_vs_cpu(tree, cfg2_l, group, tp_pre, tp_dec,
                                   cfg2_l.num_kv_heads, 200, 4,
                                   "c: card against CPU")
    del tree
    ident = default_calibration(cfg2)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    layers, single = [], []
    for calib in ident:
        p = dense_layer(cfg2, gen, DEV)
        layers.append(quantize_layer_tp(p, cfg2, calib, group.world, group=group))
        if group.rank == 0:
            single.append(quantize_layer(p, cfg2, calib))
        del p
    head = dict(embed=_normal(gen, (cfg2.vocab_size, cfg2.hidden_size), 0.02, DEV),
                final_ln=torch.ones(cfg2.hidden_size, dtype=torch.bfloat16,
                                    device=DEV))
    head["lm_head"] = _normal(gen, (cfg2.vocab_size, cfg2.hidden_size), 0.02, DEV)
    tree = dict(head, layers=layers)
    prompt = np.random.default_rng(SEED + 1).integers(0, cfg2.vocab_size,
                                                      200).tolist()
    tcaches = [_p12_caches(cfg2_l, cfg2_l.num_kv_heads, DEV, 200, 4)]
    run_tp = _p12_runner(tree, cfg2_l, tcaches, DEV, tp_pre, tp_dec)
    if group.rank == 0:
        sparams = stack_layer_projections(dict(head, layers=single))
        scaches = [_p12_caches(cfg2, cfg2.num_kv_heads, DEV, 200, 4)]
        other = _p12_runner(sparams, cfg2, scaches, DEV, prefill, decode_step)
    else:
        # the other ranks run the same TP units (their collectives) and
        # hold them against themselves
        last = []
        tp_unit = run_tp
        run_tp = lambda kind, args: last.append(tp_unit(kind, args)) or last[-1]  # noqa: E731
        other = lambda kind, args: last[-1]  # noqa: E731
    out["c_single"] = p12_units(run_tp, other, cfg2, prompt, 4,
                                label="c: TP against single card")
    if group.rank:
        out["c_single"] = None
    del tree, single, head, tcaches
    torch.cuda.empty_cache()

    # (d) the hetero form, then the symmetric-weights form (split-plane
    # o / down: K's f32 output), 4 layers, 8 requests of 96-128 tokens
    cfg4 = llama31_8b(P12_SMALL_LAYERS)
    for key, kw, must in (("d_hetero", dict(hetero=True), TP_HETERO_KERNELS),
                          ("d_symmetric", dict(weight_fp4_only=False),
                           TP_SYMMETRIC_KERNELS)):
        tree = p12_tp_model(cfg4, calibs[:P12_SMALL_LAYERS], group, SEED, **kw)
        eng = make_tp_engine(tree, cfg4, group, max_pages_per_seq=2,
                             **eng_kw)
        out[key] = p12_serve(eng, small_specs, group, f"phase 12 ({key})", must)
        del eng, tree
        torch.cuda.empty_cache()
    return out


def p12_ep_model(cfg, group, seed: int = SEED):
    """The rank's tree of an expert-parallel Mixtral: the quantized model
    made from the seed, each layer's experts grouped as it is made
    (``random_quantized_model``), then split over the ranks
    (``shard_params_ep``: the rank keeps its E / ep experts)."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    from micromix_tpu_torch.parallel import shard_params_ep
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=seed), seed=seed,
        device=DEV)
    for p in params["layers"]:
        p["experts_grouped_ep"] = p.pop("experts_grouped")
    mine = shard_params_ep(params, group)
    del params
    torch.cuda.empty_cache()
    return mine


def p12_ep_rank(group, specs) -> dict:
    """One rank of phase 12's expert-parallel runs (e): Mixtral-8x7B widths
    at 4 layers under dense then capacity dispatch, then 2 layers card
    against CPU."""
    from micromix_tpu_torch.parallel import make_ep_step_fns
    from micromix_tpu_torch.serve.engine import Engine
    from micromix_tpu_torch.serve.runner import decode_step, prefill
    out = {"backend": group.backend}
    cfg = mixtral_8x7b(P12_SMALL_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mine = p12_ep_model(cfg, group)
    torch.cuda.synchronize()
    out["model_build_s"] = time.perf_counter() - t0
    out["build_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["layer_bytes"] = _tree_bytes(mine["layers"])
    for key, c in (("e_dense", cfg),
                   ("e_capacity", dataclasses.replace(cfg, moe_capacity_factor=1.25))):
        eng = Engine(mine, c, step_fns=make_ep_step_fns(c), seed=SEED,
                     device=DEV, max_seqs=4, page_size=128, max_pages_per_seq=2,
                     decode_chunk=8)
        out[key] = p12_serve(eng, specs, group, f"phase 12 ({key})", EP_KERNELS)
        del eng
    del mine
    torch.cuda.empty_cache()
    cfg2 = mixtral_8x7b(2)
    mine = p12_ep_model(cfg2, group)
    out["e_cpu"] = p12_card_vs_cpu(mine, cfg2, group, prefill, decode_step,
                                   cfg2.num_kv_heads, 128, 2,
                                   "e: card against CPU")
    del mine
    torch.cuda.empty_cache()
    return out


def phase12(rng, calibs, p8_tp) -> dict:
    """Tensor and expert parallelism on the one card: two ranks, two
    processes on cuda:0 over gloo (NCCL refuses two ranks on one card).

      a. B and K with f32 output (``check_f32_gemms``);
      b. Llama-3.1-8B widths, P12_LAYERS layers, tp=2, phase 7's first
         P12_LAYERS calibrations:
         each rank draws its dense layers from the seed one at a time and
         quantizes its shard alone (half the codes each, the embedding
         and head whole); phase 4's traffic (chunked and batched prefill);
      c. 2 layers of (b), the ranks on the card against the same ranks on
         the CPU from one state per unit; and at identity calibration with
         k4-only budgets the TP ranks against the single-card runner on
         the same dense weights (greedy tokens equal; the last prefill
         chunk may be a near tie, phase 3's rule);
      d. the hetero form (``--hetero``), then the symmetric-weights form
         (split-plane o / down: K's f32 output), 4 layers, 8 requests of
         96-128 tokens;
      e. Mixtral-8x7B widths, 4 layers (93 GB of bf16 at full depth), ep=2:
         4 local experts a rank, four requests under dense and then
         capacity dispatch; 2 layers card against CPU;
      f. ``cli serve --tp 2`` (run inside phase 8, on its checkpoint): its
         stats line names (b)'s backend and rank count.

    Every rank must launch its path's kernels and no plain version, and
    the ranks' token streams must be equal.  These runs are not under
    ``torch.cuda.set_sync_debug_mode("error")``: gloo's all_reduce of a
    CUDA tensor copies it to the host and back and blocks the calling
    thread, so every row-parallel projection and MoE block of a dispatch
    synchronizes; the decode window counts these blocking collectives a
    step instead (``all_reduces_per_step``).  The numbers measure TP and
    EP on one card over host-staged collectives, not TP performance."""
    from micromix_tpu_torch.parallel import spawn
    t_start = time.perf_counter()
    out = {}
    results = []
    timer = Timer()
    out["f32_rounding"] = check_f32_gemms(results, timer)
    del timer
    torch.cuda.empty_cache()
    out["checks"] = results
    vocab = llama31_8b(1).vocab_size
    specs = [(r.prompt, r.max_new_tokens) for r in _traffic(rng, vocab)]
    small = p12_specs(rng, vocab, [int(rng.integers(96, 129)) for _ in range(8)], 32)
    ranks = spawn(p12_tp_rank, P12_TP, calibs, specs, small, device=DEV)
    for key in ("b", "d_hetero", "d_symmetric"):
        toks = [r[key]["tokens"] for r in ranks]
        if any(t != toks[0] for t in toks[1:]):
            fail(f"phase 12 ({key}): the ranks' token streams differ")
        out[key] = [{k: v for k, v in r[key].items() if k != "tokens"}
                    for r in ranks]
        for rank, st in enumerate(out[key]):
            w = st["decode_window"]
            print(f"  ({key}) rank {rank}: engine {st['decode_ms_per_step']:.3f} "
                  f"ms/step; window {w['ms_per_step']:.3f} ms/step host, "
                  f"{w['device_busy_ms_per_step']:.3f} busy, "
                  f"{w['cuda_launches_per_step']:.1f} CUDA launches, "
                  f"{w['all_reduces_per_step']:.1f} all_reduces "
                  f"({w['all_reduce_ms_per_step']:.3f} ms) a step; peak "
                  f"{st['peak_mem_gib']:.2f} GiB", flush=True)
    out["b_tokens"] = ranks[0]["b"]["tokens"]
    out["c_cpu"] = ranks[0]["c_cpu"]
    out["c_single"] = ranks[0]["c_single"]
    if ranks[1]["c_cpu"]["tokens"] != out["c_cpu"]["tokens"]:
        fail("phase 12 (c): the ranks' card tokens differ")
    print(f"  (c) card against CPU: tokens {out['c_cpu']['tokens']}, near ties "
          f"{out['c_cpu']['near_ties']}, max rel err "
          f"{max(out['c_cpu']['logit_rel_err']):.3e}; TP against single card: "
          f"tokens {out['c_single']['tokens']} / "
          f"{out['c_single']['other_tokens']}, near ties "
          f"{out['c_single']['near_ties']}", flush=True)
    backend = ranks[0]["backend"]
    print(f"  (b) backend {backend}, {P12_TP} ranks on {ranks[0]['device']}; "
          f"rank 0 layers {ranks[0]['b']['layer_bytes'] / 2 ** 30:.2f} GiB, "
          f"built in {ranks[0]['b']['model_build_s']:.1f}s", flush=True)
    ep_specs = p12_specs(rng, mixtral_8x7b(1).vocab_size,
                         [int(rng.integers(96, 129)) for _ in range(4)], 16)
    eranks = spawn(p12_ep_rank, P12_TP, ep_specs, device=DEV, axis="expert")
    for key in ("e_dense", "e_capacity"):
        toks = [r[key]["tokens"] for r in eranks]
        if any(t != toks[0] for t in toks[1:]):
            fail(f"phase 12 ({key}): the ranks' token streams differ")
        out[key] = [{k: v for k, v in r[key].items() if k != "tokens"}
                    for r in eranks]
        for rank, st in enumerate(out[key]):
            w = st["decode_window"]
            print(f"  ({key}) rank {rank}: window {w['ms_per_step']:.3f} ms/step "
                  f"host, {w['device_busy_ms_per_step']:.3f} busy, "
                  f"{w['all_reduces_per_step']:.1f} all_reduces a step; I "
                  f"launches {st['launches'].get('w8_grouped')}", flush=True)
    out["e_cpu"] = eranks[0]["e_cpu"]
    print(f"  (e) card against CPU: tokens {out['e_cpu']['tokens']}, max rel "
          f"err {max(out['e_cpu']['logit_rel_err']):.3e}", flush=True)
    if p8_tp["stats"].get("backend") != backend or \
            p8_tp["stats"].get("ranks") != P12_TP:
        fail(f"phase 12 (f): serve --tp printed {p8_tp['stats']}, not "
             f"{P12_TP} ranks over {backend}")
    out["f"] = p8_tp
    out["launches"] = collections.Counter()
    for r in ranks:
        for key in ("b", "d_hetero", "d_symmetric"):
            out["launches"].update(r[key]["launches"])
    for r in eranks:
        for key in ("e_dense", "e_capacity"):
            out["launches"].update(r[key]["launches"])
    out["seconds"] = time.perf_counter() - t_start
    return out


# --------------------------------------------------------------- phase 13

P13_TP_LAYERS = 8          # TP v1 (b) and SP (d)
P13_PP_LAYERS = 32         # PP (c), full depth
P13_S = 256                # (b), (c): a rank's rows stay under 1024
P13_SP = ((2, 1536), (4, 2048))   # (sp, S): 768 and 512 rows a rank
P13_LONG = 8192            # (d) at sp=4: 2048 rows a rank
P13_WINDOW = 512           # crosses the shard border at 768 rows a rank
P13_DENSE_LAYERS = 2       # the dense model's depth (JAX's ring test's)
P13_HEAD_CHUNK = 8         # query heads a reference attention forms at once
TPV1_KERNELS = ("mx_quantize", "w8_gemm")
PP_KERNELS = ("site_fakequant", "w8_gemm", "flash_attention")
SP_KERNELS = ("site_fakequant", "w8_gemm")
SP_LONG_KERNELS = ("site_fakequant",)   # 2048 rows a rank: B's dequant route
# JAX's bands (tests/test_parallel.py:47-50, tests/test_sp_pp.py): against
# the single card, rtol = atol = 2e-2 with correlation > 0.999; Ulysses
# against gather, dense within 3e-2, quantized 99.9% of the logits within
# 3e-2.  Each variant is held to the reference that computes its function:
# gather to ``forward(attend=causal_attention)`` (probabilities rounded to
# bf16; at S=8192 too), Ulysses to gather, the ring (f32 probabilities) to
# ``forward(attend=flash_attention_plain)`` (the exact f32 attention) on a
# 2-layer dense model.  The ring's attention itself is held to the exact
# f32 attention within one bf16 ulp (``p13_ring_attention``, at S=8192
# too).  Through the model a different sum order of f32 probabilities
# moves bf16 rounds now and then: on the dense model 99.59-99.68% of the
# logits stay within JAX's 2e-2, correlation 0.99997 (this phase on an
# H100 80GB HBM3), so the dense ring is held to correlation > 0.999 with
# 99% of the logits within 2e-2.  Through 8 MXFP4 layers of random weights
# such moves flip o-site decisions that compound (the quantized ring
# against gather correlates 0.900-0.916; JAX's quantized band, correlation
# > 0.95, is for its test's 2 layers), so the quantized ring's readings,
# against gather and against its own function, are measured and kept, not
# held, beside the same readings between single-card attentions
# (``p13_witness``).
BANDS = {"forward": dict(rtol=2e-2, atol=2e-2, corr=0.999),
         "ring": dict(rtol=2e-2, atol=2e-2, corr=0.999, frac=0.99),
         "dense": dict(rtol=3e-2, atol=3e-2),
         "ulysses": dict(rtol=3e-2, atol=3e-2, frac=0.999),
         "measured": dict(rtol=3e-2, atol=3e-2, frac=0.0)}
BAND_FORWARD = BANDS["forward"]
P13_COLL_KINDS = ("all_reduce", "broadcast", "all_gather", "all_to_all",
                  "ppermute")


def p13_model(num_layers: int, seed: int):
    """Llama-3.1-8B widths at ``num_layers``, quantized at
    ``default_calibration`` (identity order, every channel MXFP4: uniform
    budgets, as JAX's ``stack_layers`` needs), from the seed on the card."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    cfg = llama31_8b(num_layers)
    return cfg, random_quantized_model(cfg, default_calibration(cfg),
                                       seed=seed, device=DEV)


def band_parts(got, ref, rtol: float, atol: float) -> dict:
    """The sums a band check over several ranks' shards combines: element
    count, count within atol + rtol |ref|, max |got - ref|, and the f64
    moments of the correlation."""
    g, r = got.reshape(-1).double(), ref.reshape(-1).double()
    err = (g - r).abs()
    return dict(n=g.numel(), close=int((err <= atol + rtol * r.abs()).sum()),
                max_abs=float(err.max()), sx=float(g.sum()), sy=float(r.sum()),
                sxx=float((g * g).sum()), syy=float((r * r).sum()),
                sxy=float((g * r).sum()),
                argmax_equal=int((got.argmax(-1) == ref.argmax(-1)).sum()),
                rows=int(got.reshape(-1, got.shape[-1]).shape[0]))


def band(parts, label: str, rtol: float, atol: float, corr: float = None,
         frac: float = None) -> dict:
    """Combine ``band_parts`` of every shard; fail unless every element is
    within the band (or, with ``frac``, that share of them) and the
    correlation is above ``corr``."""
    n = sum(p["n"] for p in parts)
    sums = {k: sum(p[k] for p in parts) for k in ("sx", "sy", "sxx", "syy",
                                                  "sxy", "close")}
    cov = sums["sxy"] - sums["sx"] * sums["sy"] / n
    var_g = sums["sxx"] - sums["sx"] ** 2 / n
    var_r = sums["syy"] - sums["sy"] ** 2 / n
    out = dict(rtol=rtol, atol=atol, frac_close=sums["close"] / n,
               max_abs_err=max(p["max_abs"] for p in parts),
               corr=cov / max(np.sqrt(var_g * var_r), 1e-300),
               argmax_equal=sum(p["argmax_equal"] for p in parts)
               / sum(p["rows"] for p in parts))
    ok = out["frac_close"] >= (frac if frac is not None else 1.0)
    if corr is not None:
        ok = ok and out["corr"] > corr
    print(f"  {label}: {out['frac_close']:.6f} of the logits within rtol "
          f"{rtol} atol {atol}, max |err| {out['max_abs_err']:.4g}, corr "
          f"{out['corr']:.6f}, argmax equal {out['argmax_equal']:.4f}",
          flush=True)
    if not ok:
        fail(f"{label}: outside the band {out}")
    return out


def p13_run(label: str, fn, groups, must_launch) -> tuple:
    """A rank's parallel forward ``fn()`` with the launch counters and the
    groups' collective counts reset just before it and read just after,
    the plain versions refused; then device busy ms and CUDA launches
    under ``torch.profiler`` over one more call -> (result, stats)."""
    from micromix_tpu_torch.kernels import build
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for g in groups:
        g.reset_counts()
    with refuse_plain_kernels(label):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in build.launches.items() if v}
    coll = {k: [sum(g.counts[k] for g in groups),
                sum(g.seconds[k] for g in groups) * 1e3]
            for k in P13_COLL_KINDS if any(g.counts[k] for g in groups)}
    missing = [k for k in must_launch if not launches.get(k)]
    if missing:
        fail(f"{label}: rank {groups[0].rank}: kernels not launched: {missing}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with refuse_plain_kernels(label), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, n_cuda = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.device_time_total / 1e3
            n_cuda += 1
    if busy <= 0.0:
        fail(f"{label}: the profiler saw no device time")
    staged = sorted(set().union(*(g.staged for g in groups)))
    return out, dict(host_ms=host_ms, device_busy_ms=busy, cuda_launches=n_cuda,
                     collectives=coll, launches=launches, peak_mem_gib=peak,
                     staged=staged)


def p13_print(label: str, stats_by_rank) -> None:
    for rank, st in enumerate(stats_by_rank):
        coll = ", ".join(f"{k} {n} ({ms:.1f} ms)"
                         for k, (n, ms) in st["collectives"].items())
        print(f"  {label} rank {rank}: {st['host_ms']:.1f} ms host, "
              f"{st['device_busy_ms']:.1f} ms busy, {st['cuda_launches']} "
              f"CUDA launches; {coll}; kernels {st['launches']}; peak "
              f"{st['peak_mem_gib']:.2f} GiB; host-staged {st['staged']}",
              flush=True)


def p13_collectives(group) -> dict:
    """(a) all_gather, all_to_all and ppermute (a ring and a chain) on bf16
    and f32 CUDA tensors, each against the same op on CPU copies."""
    import dataclasses as dc
    cpu = dc.replace(group, device=torch.device("cpu"), staged=set(),
                     counts=collections.Counter(),
                     seconds=collections.Counter())
    w, r = group.world, group.rank
    gen = torch.Generator(device=DEV).manual_seed(SEED + 130 + r)
    equal = {}
    for dt in (torch.bfloat16, torch.float32):
        t = torch.randn((4, 8 * w, 128), generator=gen, device=DEV).to(dt)
        ops = {"all_gather": lambda g, x: g.all_gather(x, 1),
               "all_to_all": lambda g, x: g.all_to_all(x, 1, 0),
               "ppermute ring": lambda g, x: g.ppermute(
                   x, [(i, (i + 1) % w) for i in range(w)]),
               "ppermute chain": lambda g, x: g.ppermute(
                   x, [(i, i + 1) for i in range(w - 1)])}
        for name, op in ops.items():
            got = op(group, t).cpu()
            ref = op(cpu, t.cpu())
            equal[f"{name} {str(dt)[6:]}"] = bool(
                got.dtype == ref.dtype and torch.equal(got, ref))
    if not all(equal.values()):
        fail(f"phase 13 (a): rank {r}: CUDA collectives differ from CPU: {equal}")
    return dict(equal=equal, staged=sorted(group.staged))


def _stage_group(group, axis: str):
    return dataclasses.replace(group, axis=axis, counts=collections.Counter(),
                               seconds=collections.Counter(), staged=set())


def p13_tp(group, cfg, params, tokens, data: int, model: int) -> dict:
    """(b) TP v1 on a (data, model) layout: the rank's logits, and its
    data shard's rows of ``forward(attend=causal_attention)`` (the JAX
    package's single-device forward on its XLA attention, the attention TP
    v1 runs)."""
    import hashlib
    from micromix_tpu_torch.models.common import causal_attention
    from micromix_tpu_torch.models.transformer import forward
    from micromix_tpu_torch.parallel import (axis_groups,
                                             shard_quantized_params,
                                             sharded_quantized_forward)
    label = f"phase 13 (b) data={data} model={model}"
    groups = axis_groups(group, data=data, model=model)
    mine = shard_quantized_params(params, groups["model"].rank, model)
    toks = torch.from_numpy(tokens).to(DEV)
    logits, st = p13_run(label, lambda: sharded_quantized_forward(
        mine, cfg, toks, groups), list(groups.values()), TPV1_KERNELS)
    del mine
    b = tokens.shape[0] // data
    d = groups["data"].rank
    ref = forward(params, cfg, toks[d * b:(d + 1) * b],
                  attend=causal_attention)
    st.update(digest=hashlib.sha256(logits.cpu().numpy().tobytes()).hexdigest(),
              data_rank=d, parts=band_parts(logits, ref, **{
                  k: BAND_FORWARD[k] for k in ("rtol", "atol")}))
    return st


def p13_pp(group, cfg, params, tokens) -> dict:
    """(c) the 2-stage pipeline; on rank 0 the 1-stage run of the same
    program (bit-equal) and ``forward`` on each microbatch (the same rows
    through the same kernels)."""
    from micromix_tpu_torch.models.transformer import forward
    from micromix_tpu_torch.parallel import RankGroup, pipeline_parallel_forward
    stage = _stage_group(group, "stage")
    toks = torch.from_numpy(tokens).to(DEV)
    logits, st = p13_run("phase 13 (c)", lambda: pipeline_parallel_forward(
        params, cfg, toks, stage, n_micro=2), [stage], PP_KERNELS)
    if group.rank == 0:
        one = pipeline_parallel_forward(params, cfg, toks,
                                        RankGroup.single("stage", DEV),
                                        n_micro=2)
        st["one_stage_bit_equal"] = bool(torch.equal(one, logits))
        del one
        mb = tokens.shape[0] // 2
        ref = torch.cat([forward(params, cfg, toks[i * mb:(i + 1) * mb])
                         for i in range(2)])
        st["parts"] = band_parts(logits, ref, BAND_FORWARD["rtol"],
                                 BAND_FORWARD["atol"])
        del ref
    import hashlib
    st["digest"] = hashlib.sha256(logits.cpu().numpy().tobytes()).hexdigest()
    return st


def p13_in_turn(group, fn):
    """``fn()`` on one rank of ``group`` at a time (a reference's temporaries
    at S=8192 are GiBs a rank), the card's cache emptied after each."""
    import torch.distributed as dist
    out = None
    for turn in range(group.world):
        if turn == group.rank:
            out = fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier(group=group.group)
    return out


def p13_forward_rows(params, cfg, toks, rows, attend):
    """The rows ``rows`` of ``forward(params, cfg, toks, attend=attend)``:
    ``forward``'s layers, the head on those rows only (the f32 logits of
    8192 tokens are 4.2 GB)."""
    from micromix_tpu_torch.models.common import lm_logits, rmsnorm, rope_table
    from micromix_tpu_torch.models.transformer import decoder_layer
    h = params["embed"][toks].to(torch.bfloat16)
    cos, sin = rope_table(torch.arange(toks.shape[1], device=toks.device), cfg)
    for p in params["layers"]:
        h = decoder_layer(h, p, cfg, cos, sin, attend=attend)
    return lm_logits(rmsnorm(h[:, rows], params["final_ln"], cfg.rms_eps),
                     params["lm_head"])


def p13_f32_attention(q, k, v, sliding_window=None):
    """The exact f32 attention (Kernel E's plain version) a few query heads
    at a time: its scores over 8192 tokens for all 32 heads are 8.6 GB."""
    from micromix_tpu_torch.kernels.flash_attention import flash_attention_plain
    rep = q.shape[2] // k.shape[2]
    hk = max(1, P13_HEAD_CHUNK // rep)
    return torch.cat([flash_attention_plain(
        q[:, :, j * rep:(j + hk) * rep], k[:, :, j:j + hk], v[:, :, j:j + hk],
        sliding_window) for j in range(0, k.shape[2], hk)], dim=2)


def p13_attend(ref: str):
    """A reference's attention: "plain" the JAX package's XLA attention
    (``causal_attention``, bf16 probabilities), "f32" the exact f32
    attention (``p13_f32_attention``), "flash" Kernel E."""
    from micromix_tpu_torch.kernels.flash_attention import flash_attention
    from micromix_tpu_torch.models.common import causal_attention
    return {"plain": causal_attention, "f32": p13_f32_attention,
            "flash": flash_attention}[ref]


def p13_sp(group, cfg, params, tokens, must, checks, label="") -> dict:
    """(d) the SP variants of ``checks`` (attn -> its (reference, band)
    pairs) on the rank's sequence shard, each with its launches,
    collectives and memory, and each held against its references:
    "gather", or the rank's rows of ``forward`` on the attention that
    ``p13_attend`` names."""
    from micromix_tpu_torch.parallel import sequence_parallel_forward
    seq = _stage_group(group, "seq")
    toks = torch.from_numpy(tokens).to(DEV)
    s_loc = tokens.shape[1] // group.world
    rows = slice(group.rank * s_loc, (group.rank + 1) * s_loc)
    out, logits = {}, {}
    for attn in checks:
        logits[attn], out[attn] = p13_run(
            f"phase 13 (d{label}) {attn}", lambda: sequence_parallel_forward(
                params, cfg, toks, seq, attn=attn), [seq], must)
    refs = {ref for pairs in checks.values() for ref, _ in pairs} - {"gather"}
    ref_logits = {ref: p13_in_turn(seq, lambda: p13_forward_rows(
        params, cfg, toks, rows, p13_attend(ref))) for ref in sorted(refs)}
    ref_logits["gather"] = logits.get("gather")
    for attn, pairs in checks.items():
        out[attn]["parts"] = [dict(band_parts(
            logits[attn], ref_logits[ref], BANDS[bnd]["rtol"],
            BANDS[bnd]["atol"]), ref=ref, band=bnd) for ref, bnd in pairs]
    del logits, ref_logits
    torch.cuda.empty_cache()
    return out


def p13_ring_attention(group, s: int, window=None) -> dict:
    """The ring's attention on seeded q / k / v at Llama-3.1-8B's heads
    (32 / 8 of 128) over ``s`` tokens, the rank's shard against the same
    rows of the exact f32 attention (``p13_f32_attention``, one rank at a
    time): within
    one bf16 ulp (2^-7 of the value), plus 2^-16 of max |v| for the f32
    sums in another order where an output cancels to near 0."""
    from micromix_tpu_torch.parallel.sp import _ring_attention
    seq = _stage_group(group, "seq")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 132)
    q, k, v = (torch.randn((1, s, h, 128), generator=gen, device=DEV).to(
        torch.bfloat16) for h in (32, 8, 8))
    s_loc = s // group.world
    rows = slice(group.rank * s_loc, (group.rank + 1) * s_loc)
    got = _ring_attention(q[:, rows], k[:, rows], v[:, rows],
                          offset=group.rank * s_loc, group=seq,
                          window=window).float()
    # the rows' f32 attention needs the keys up to their end only
    end = rows.stop
    ref = p13_in_turn(seq, lambda: p13_f32_attention(
        q[:, :end], k[:, :end], v[:, :end], window)[:, rows].float())
    err = (got - ref).abs()
    ok = bool((err <= ref.abs() * 2.0 ** -7
               + float(v.abs().max()) * 2.0 ** -16).all())
    out = dict(s=s, window=window, max_abs_err=float(err.max()),
               ulp_moves=float((err > 0).float().mean()), ok=ok)
    if not ok:
        fail(f"phase 13 (d): rank {group.rank}: the ring's attention is "
             f"more than an ulp from the f32 attention: {out}")
    return out


def p13_dense(num_layers: int, seed: int):
    """The dense bf16 model at Llama-3.1-8B widths (``dense_llama``)."""
    cfg = llama31_8b(num_layers)
    return cfg, dense_llama(cfg, seed, DEV)


def p13_witness(cfg, params, tokens) -> dict:
    """Single-card readings beside the quantized ring's: ``forward`` on the
    whole sequence with the exact f32 attention against the XLA attention
    (bf16 probabilities: the pair the ring and gather compute) and
    against Kernel E (f32 probabilities in another sum order: the pair the
    ring and its own function are)."""
    toks = torch.from_numpy(tokens).to(DEV)
    every = slice(None)
    f32 = p13_forward_rows(params, cfg, toks, every, p13_attend("f32"))
    out = {}
    for ref in ("plain", "flash"):
        r = p13_forward_rows(params, cfg, toks, every, p13_attend(ref))
        out[ref] = dict(band_parts(f32, r, BANDS["measured"]["rtol"],
                                   BANDS["measured"]["atol"]), ref=ref)
        del r
    del f32
    torch.cuda.empty_cache()
    return out


def p13_rank(group, tok) -> dict:
    """One rank of phase 13's 2-rank or 4-rank runs."""
    import dataclasses as dc
    out = {"backend": group.backend, "device": str(group.device)}
    out["a"] = p13_collectives(group)
    cfg8, params8 = p13_model(P13_TP_LAYERS, SEED + 13)
    dcfg, dparams = p13_dense(P13_DENSE_LAYERS, SEED + 15)
    quant = {"gather": [("plain", "forward")],
             "ring": [("gather", "measured"), ("f32", "measured")],
             "ulysses": [("gather", "ulysses")]}
    dense = {"gather": [], "ring": [("f32", "ring")],
             "ulysses": [("gather", "dense")]}
    sp_s = P13_SP[0][1] if group.world == 2 else P13_SP[1][1]
    out["ring_attention"] = [p13_ring_attention(group, sp_s),
                             p13_ring_attention(group, sp_s, P13_WINDOW)]
    if group.world == 4:
        out["ring_attention"].append(p13_ring_attention(group, P13_LONG))
    if group.world == 2:
        out["b"] = p13_tp(group, cfg8, params8, tok["b"], 1, 2)
        out["d"] = p13_sp(group, cfg8, params8, tok["d2"], SP_KERNELS, quant)
        if group.rank == 0:
            out["witness"] = p13_witness(cfg8, params8, tok["d2"])
        out["d_dense"] = p13_sp(group, dcfg, dparams, tok["d2"], (), dense,
                                " dense")
        # a 512-token window across the border of 768-row shards
        wcfg = dc.replace(cfg8, sliding_window=P13_WINDOW)
        out["d_window"] = p13_sp(group, wcfg, params8, tok["d2"], SP_KERNELS,
                                 {k: quant[k] for k in ("gather", "ring")},
                                 " window")
        wcfg = dc.replace(dcfg, sliding_window=P13_WINDOW)
        out["d_dense_window"] = p13_sp(group, wcfg, dparams, tok["d2"], (),
                                       {"ring": dense["ring"]}, " dense window")
        del params8, dparams
        torch.cuda.empty_cache()
        cfg32, params32 = p13_model(P13_PP_LAYERS, SEED + 14)
        out["c"] = p13_pp(group, cfg32, params32, tok["c"])
        del params32
    else:
        out["b"] = p13_tp(group, dc.replace(cfg8, num_layers=2),
                          {**params8, "layers": params8["layers"][:2]},
                          tok["b"], 2, 2)
        out["d"] = p13_sp(group, cfg8, params8, tok["d4"], SP_KERNELS, quant)
        out["d_dense"] = p13_sp(group, dcfg, dparams, tok["d4"], (), dense,
                                " dense")
        del dparams
        # 2048 rows a rank: B gives way to the dequantize route
        out["d_long"] = p13_sp(group, cfg8, params8, tok["long"],
                               SP_LONG_KERNELS,
                               {k: quant[k] for k in ("gather", "ring")},
                               " long")
        del params8
    torch.cuda.empty_cache()
    return out


def phase13(rng, p8_ranks) -> dict:
    """The rest of ``parallel/`` on the one card: every rank a process on
    cuda:0 over gloo, Llama-3.1-8B widths, seeded random weights quantized
    at ``default_calibration``.

      a. all_gather, all_to_all and ppermute (a ring and a chain) over 2
         and 4 ranks on bf16 and f32 CUDA tensors, bit-equal to the same
         op on CPU tensors; the kinds gloo took through the host;
      b. TP v1 at tp=2 (data=1), 8 layers, B=2 x S=256: the ranks'
         logits bit-equal, within JAX's band of
         ``forward(attend=causal_attention)`` (the single card on the
         attention TP v1 runs); 2 layers at
         (data=2, model=2) on 4 ranks the same way;
      c. PP at 32 layers, 2 stages of 16, B=4 x S=256, n_micro=2: the
         ranks' logits equal, bit-equal to the 1-stage run of the same
         program, within JAX's band of ``forward`` on each microbatch;
      d. SP at 8 layers, B=1: gather, ring and Ulysses at sp=2 (S=1536)
         and sp=4 (S=2048), Ulysses against gather within JAX's band,
         gather against ``forward(attend=causal_attention)`` within JAX's
         2e-2 band; the ring's attention within one bf16 ulp of the
         exact f32 attention, the dense 2-layer ring against ``forward``
         on that attention, the quantized ring's readings against gather
         and against its own function measured beside the single card's
         (``p13_witness``); a 512-token sliding window across the shard
         border (gather and ring, sp=2); gather and ring at sp=4 with
         S=8192 (2048 rows a rank: B gives way to the dequantize route, A
         still launches), gather against ``forward`` on its attention
         within 2e-2, the ring's attention within an ulp;
      e. ``cli serve --tp 2 --port`` and (f) ``--profile``, run in phase 8
         on its checkpoint (``p13_serve``).

    Every rank must launch its path's kernels (J and B in TP v1; A, B and
    E in PP; A and B in SP) and no plain version.  These runs measure
    correctness over host-staged collectives on one card, not parallel
    speed."""
    from micromix_tpu_torch.parallel import spawn
    t_start = time.perf_counter()
    vocab = llama31_8b(1).vocab_size
    tok = {"b": rng.integers(0, vocab, (2, P13_S)),
           "c": rng.integers(0, vocab, (4, P13_S)),
           "d2": rng.integers(0, vocab, (1, P13_SP[0][1])),
           "d4": rng.integers(0, vocab, (1, P13_SP[1][1])),
           "long": rng.integers(0, vocab, (1, P13_LONG))}
    out = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = spawn(p13_rank, world, tok, device=DEV, axis="seq")
        out[f"ranks{world}_s"] = time.perf_counter() - t0
        out[f"a{world}"] = [r["a"] for r in ranks]
        print(f"  (a) {world} ranks: equal on every rank; host-staged "
              f"{ranks[0]['a']['staged']}", flush=True)
        out[f"ring_attention{world}"] = [r["ring_attention"] for r in ranks]
        print(f"  (d) sp={world} ring attention against the f32 attention: "
              + "; ".join(f"S={x['s']} window {x['window']}: max |err| "
                          f"{max(r['ring_attention'][i]['max_abs_err'] for r in ranks):.3g}, "
                          f"{max(r['ring_attention'][i]['ulp_moves'] for r in ranks):.2e} "
                          "of the values an ulp off"
                          for i, x in enumerate(ranks[0]["ring_attention"])),
              flush=True)
        b = [r["b"] for r in ranks]
        p13_print(f"(b) {world} ranks", b)
        for d in sorted({x["data_rank"] for x in b}):
            if len({x["digest"] for x in b if x["data_rank"] == d}) != 1:
                fail(f"phase 13 (b) {world} ranks: the model ranks' logits differ")
        out[f"b{world}"] = dict(ranks=b, band=band(
            [x["parts"] for x in b], f"(b) {world} ranks against the single card",
            **BAND_FORWARD))
        keys = (("d", "d_dense", "d_window", "d_dense_window", "c")
                if world == 2 else ("d", "d_dense", "d_long"))
        for key in keys:
            runs = [r[key] for r in ranks]
            if key == "c":
                p13_print("(c)", runs)
                if len({x["digest"] for x in runs}) != 1:
                    fail("phase 13 (c): the stages' logits differ")
                if not runs[0]["one_stage_bit_equal"]:
                    fail("phase 13 (c): 2 stages differ from 1 stage")
                out["c"] = dict(ranks=runs, band=band(
                    [runs[0].pop("parts")], "(c) against forward",
                    **BAND_FORWARD))
                continue
            res = {}
            for attn in runs[0]:
                st = [x[attn] for x in runs]
                what = f"(d) sp={world}{key[1:].replace('_', ' ')} {attn}"
                p13_print(what, st)
                res[attn] = dict(ranks=st, bands={})
                parts = [x.pop("parts") for x in st]
                for i, first in enumerate(parts[0]):
                    ref, bnd = first["ref"], first["band"]
                    res[attn]["bands"][ref] = band(
                        [p[i] for p in parts], f"{what} against {ref}"
                        + (" (measured)" if bnd == "measured" else ""),
                        **BANDS[bnd])
            out[f"{key}{world}"] = res
        if world == 2:
            out["witness"] = {ref: band([x], f"(d) single card, S={P13_SP[0][1]}: "
                                        f"forward on f32 attention against {ref} "
                                        "(measured)", **BANDS["measured"])
                              for ref, x in ranks[0]["witness"].items()}
        print(f"  {world} ranks took {out[f'ranks{world}_s']:.1f}s", flush=True)
    if not p8_ranks or "profile" not in p8_ranks:
        fail("phase 13 (e), (f): phase 8 did not run them")
    out["e"] = p8_ranks
    out["staged"] = sorted(set().union(*(x["staged"] for x in out["a4"])))
    out["seconds"] = time.perf_counter() - t_start
    return out


def p13_launches(p13) -> collections.Counter:
    """Every rank's kernel launches in phase 13's counted runs."""
    out = collections.Counter()

    def walk(x):
        if isinstance(x, dict):
            if "launches" in x and "host_ms" in x:
                out.update(x["launches"])
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
    walk(p13)
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cut_stream(port: int, prompt: str, n_read: int = 2) -> int:
    """A streamed completion whose client goes away after ``n_read``
    events -> the events read."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/completions", json.dumps(
        {"prompt": prompt, "max_tokens": 64, "stream": True}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    seen = 0
    while seen < n_read:
        if resp.fp.readline().startswith(b"data: "):
            seen += 1
    conn.close()
    return seen


def p13_traces(logdir: str) -> dict:
    """``serve --tp 2 --profile``: one Chrome trace under rank0/ and one
    under rank1/, each naming B's kernel."""
    out = {}
    for r in ("rank0", "rank1"):
        d = os.path.join(logdir, r)
        files = os.listdir(d) if os.path.isdir(d) else []
        if len(files) != 1:
            fail(f"phase 13 (f): {d} holds {files}")
        with open(os.path.join(d, files[0])) as f:
            events = json.load(f)["traceEvents"]
        names = collections.Counter(e["name"] for e in events
                                    if e.get("cat") == "kernel")
        b = sum(n for name, n in names.items() if "w8_gemm" in name)
        if not b:
            fail(f"phase 13 (f): {r}'s trace names no w8_gemm kernel")
        out[r] = dict(events=len(events), kernel_events=sum(names.values()),
                      w8_gemm=b)
    return out


def p13_serve(cli, hf: str, calib: str, rng, vocab: int) -> dict:
    """(e) ``serve --tp 2 --port`` and (f) ``--profile`` on phase 8's
    checkpoint, its tokenizer swapped for integers.  (e): eight greedy
    completions sent at once (one streamed) beside a ninth streamed
    request whose client goes away after two events; the eight texts must
    equal ``serve --tp 2``'s batch-mode completions of the same prompts
    (one slot, ``--max-seqs 1``, so every request decodes alone in both
    modes); rank 0's /metrics answers; the CLI's stats line after the
    stop (its check: every rank's outputs of every request equal, the
    cancel included)."""
    import contextlib
    import io
    import threading
    from concurrent.futures import ThreadPoolExecutor
    tk = IntTokenizer()
    prompts = [tk.decode(rng.integers(0, vocab, int(rng.integers(64, 129))))
               for _ in range(9)]
    pfile = os.path.join(P8_DIR, "http_prompts.txt")
    with open(pfile, "w") as f:
        f.write("\n".join(prompts[:8]) + "\n")
    n_new = 8
    common = ["serve", "--model", hf, "--do-quant", "--calibration", calib,
              "--tp", "2", "--max-new-tokens", str(n_new), "--page-size",
              "128", "--decode-chunk", "8"]
    base = common + ["--max-seqs", "1"]
    out = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(base + ["--prompts", pfile])
    lines = buf.getvalue().strip().splitlines()
    batch = [lines[i + 1] for i, ln in enumerate(lines[:-1])
             if ln.startswith("--- [")]
    out["batch_s"] = time.perf_counter() - t0
    port, err, buf = _free_port(), [], io.StringIO()

    def run():
        try:
            cli.main(base + ["--port", str(port)])
        except BaseException as e:      # noqa: BLE001 (failed below)
            err.append(repr(e))

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        th = threading.Thread(target=run)
        th.start()
        try:
            while True:
                try:
                    if _http(port, "/health")[0] == 200:
                        break
                except OSError:
                    pass
                if err or time.perf_counter() - t0 > 600:
                    fail(f"phase 13 (e): the server did not come up: {err}")
                time.sleep(0.5)
            out["up_s"] = time.perf_counter() - t0

            def one(i):
                body = {"prompt": prompts[i], "max_tokens": n_new}
                if i != 1:
                    return json.loads(_http(port, "/v1/completions", body)[1]
                                      )["choices"][0]["text"]
                raw = _http(port, "/v1/completions", dict(body, stream=True))[1]
                ev = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
                if ev[-1] != "[DONE]":
                    fail("phase 13 (e): the stream did not end with [DONE]")
                return "".join(json.loads(e)["choices"][0]["text"]
                               for e in ev[:-1])

            t1 = time.perf_counter()
            with ThreadPoolExecutor(9) as ex:
                cut = ex.submit(_cut_stream, port, prompts[8])
                texts = list(ex.map(one, range(8)))
                cut.result()
            out["requests_s"] = time.perf_counter() - t1
            status, metrics = _http(port, "/metrics")
        finally:
            cli.stop_serving()
            th.join(600)
    if th.is_alive() or err:
        fail(f"phase 13 (e): the server over ranks did not stop cleanly: {err}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    mlines = dict(ln.split(" ", 1) for ln in metrics.strip().splitlines())
    if texts != batch or status != 200 or \
            int(mlines["micromix_requests_total"]) != 9:
        fail(f"phase 13 (e): HTTP texts {texts} / batch {batch}; /metrics "
             f"{status} {mlines}")
    if stats["ranks"] != 2 or stats["requests"] != 9:
        fail(f"phase 13 (e): stats line {stats}")
    out.update(stats=stats, metrics=mlines, tokens=[t.split() for t in texts])
    print(f"  phase 13 (e), serve --tp 2 --port: 8 completions equal batch "
          f"mode, a cancel mid-stream, /metrics {mlines}; "
          + json.dumps(stats), flush=True)
    pdir = os.path.join(P8_DIR, "profile_tp")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(common + ["--max-seqs", "2", "--prompts", pfile,
                           "--profile", pdir])
    out["profile"] = dict(stats=json.loads(buf.getvalue().strip().splitlines()[-1]),
                          traces=p13_traces(pdir))
    print("  phase 13 (f), serve --tp 2 --profile: "
          + json.dumps(out["profile"]["traces"]), flush=True)
    return out


# ---------------------------------------------------------------- phase 14

# (D, H, Hkv) of phase 14's head-dim sweep: each public family's heads at
# that width where one exists (Phi-2's 32 x 80, Phi-3-mini's 32 x 96,
# Gemma-2B's 8 / 1 x 256), else Llama-3.1-8B's 32 / 8
P14_DIMS = ((32, 32, 8), (64, 32, 8), (80, 32, 32), (96, 32, 32),
            (100, 32, 8), (112, 32, 8), (128, 32, 8), (192, 16, 4),
            (256, 8, 1))
# (H, Hkv) of the GQA-group sweep at D = 128: G = 1, 12, 16 (Llama-3.1-
# 405B's 128 / 8), 32 and 64
P14_GROUPS = ((8, 8), (96, 8), (128, 8), (64, 2), (128, 2))
# the C, D and H kernels' (padded width) sources, for their ptxas report
P14_SOURCES = ("flash_attention", "paged_decode", "paged_prefill", "append_kv")


def _rand_pages(cache, rng, bits):
    """Random page contents as ``_decode_cache`` makes them: codes, scales
    in [smax / 10, smax] with integer zero points (bf16 pages: normal
    values), values (c - z) s within about +-1.5 at either width."""
    for codes in (cache.k_codes, cache.v_codes):
        if bits == 16:
            codes.copy_(torch.randn(codes.shape, device=DEV))
        else:
            codes.random_(0, 256)
    smax = 0.1 if bits == 4 else 0.006
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(smax / 10, smax)
        sz[:, :, 1].copy_(torch.randint(0, 2 ** min(bits, 8), sz[:, :, 1].shape,
                                        device=DEV))


def p14_flash(results, timer, d, h, hkv, s=2048):
    import torch.nn.functional as F
    from micromix_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    q = torch.randn(1, s, h, d, device=DEV).to(torch.bfloat16)
    k = torch.randn(1, s, hkv, d, device=DEV).to(torch.bfloat16)
    v = torch.randn(1, s, hkv, d, device=DEV).to(torch.bfloat16)
    err, ok = close(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    record(results, "flash_attention", f"B=1 S={s} H={h} Hkv={hkv} D={d}",
           err, "2^-7|ref|+2^-8max|ref|", ok,
           timer.ms(lambda: flash_attention(q, k, v)),
           2 * s * (h + 2 * hkv) * d + 2 * s * h * d, 2.0 * d * s * (s + 1) * h,
           timer.ms(lambda: flash_attention_plain(q, k, v)), lib,
           rerun=lambda: flash_attention(q, k, v))


def p14_prefill(results, timer, rng, d, h, hkv, bits, s=512, hist=1536):
    import torch.nn.functional as F
    from micromix_tpu_torch.serve.kv_cache import kv_dequantize_page, make_cache
    from micromix_tpu_torch.serve.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    ps = 128
    mp = -(-(hist + s) // ps)
    cache = make_cache(mp + 1, ps, hkv, d, 1, mp, bits=bits, device=DEV)
    _rand_pages(cache, rng, bits)
    cache.page_table[0] = torch.from_numpy(
        1 + rng.permutation(mp).astype(np.int32)).to(DEV)
    q = torch.randn(s, h, d, device=DEV).to(torch.bfloat16)
    k = torch.randn(s, hkv, d, device=DEV).to(torch.bfloat16)
    v = torch.randn(s, hkv, d, device=DEV).to(torch.bfloat16)
    start = torch.tensor(hist, dtype=torch.int32, device=DEV)
    run = lambda: paged_prefill_attention(q, k, v, cache, 0, start)
    plain = lambda: paged_prefill_attention_plain(q, k, v, cache, 0, start)
    err, ok = close(run(), plain())
    # SDPA over the history dequantized beforehand, plus the chunk: a
    # yardstick (no one call computes the function over quantized pages)
    pages = cache.page_table[0].long()

    def history(codes, sz):     # (1, Hkv, hist, D)
        x = kv_dequantize_page(codes[pages], sz[pages], cache.bits)
        return x.permute(1, 0, 3, 2).reshape(hkv, -1, d)[None, :, :hist]
    qt = q.transpose(0, 1)[None].contiguous()
    kt = torch.cat([history(cache.k_codes, cache.k_sz),
                    k.transpose(0, 1)[None].float()], 2).to(torch.bfloat16)
    vt = torch.cat([history(cache.v_codes, cache.v_sz),
                    v.transpose(0, 1)[None].float()], 2).to(torch.bfloat16)
    mask = torch.ones(s, hist + s, dtype=torch.bool, device=DEV)
    mask[:, hist:] = torch.ones(s, s, dtype=torch.bool, device=DEV).tril()
    sdpa = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    record(results, "paged_prefill",
           f"S={s} hist={hist} H={h} Hkv={hkv} D={d}"
           + {4: "", 8: " int8", 16: " bf16"}[bits],
           err, "2^-7|ref|+2^-8max|ref|", ok, timer.ms(run),
           2 * s * (h + 2 * hkv) * d + 2 * s * h * d
           + 2 * hist * hkv * _page_bytes(bits, d),
           4.0 * s * (hist + s / 2) * h * d, timer.ms(plain), None,
           sdpa_bf16_ms=sdpa,
           rerun=run)


def p14_decode(results, timer, rng, d, h, hkv, bits, case="len 100..600",
               ps=128):
    """Kernel C at B=8 over 100-600 tokens, or ("window") 4096 tokens under
    a 1024-token window, or ("lengths") 8 rows of one 2048-token sequence
    at successive positions under the ``lengths`` override with the (m,
    den) state, as ``check_decode`` holds each, or ("len 8192") B=1 at
    8192 tokens; on pages of ``ps`` tokens."""
    from micromix_tpu_torch.models.common import rope_inv_freq
    from micromix_tpu_torch.serve.attention import (
        decode_split, paged_decode_attention, paged_decode_attention_plain)
    from micromix_tpu_torch.serve.kv_cache import make_cache
    lengths, window, override = {
        "len 100..600": (np.linspace(100, 600, 8), None, False),
        "len 8192": (np.full(1, 8192), None, False),
        "window 1024 len 4096": (np.full(8, 4096), 1024, False),
        "lengths 2041..2048 state": (np.arange(2041, 2049), None, True)}[case]
    lengths = lengths.astype(np.int32)
    b = len(lengths)
    mp = -(-int(lengths.max()) // ps)
    seqs = 1 if override else b
    cache = make_cache(seqs * mp + 1, ps, hkv, d, seqs, mp, bits=bits, device=DEV)
    _rand_pages(cache, rng, bits)
    cache.page_table.copy_(torch.from_numpy(
        1 + rng.permutation(seqs * mp).reshape(seqs, mp).astype(np.int32)))
    inv = rope_inv_freq(d, 500000.0, LLAMA3_SCALING, device=DEV)
    seq = torch.zeros(b, device=DEV, dtype=torch.int32) if override else \
        torch.arange(b, device=DEV, dtype=torch.int32)
    cache.lengths.copy_(torch.from_numpy(lengths[-1:] if override else lengths))
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
    read = int(attended.max()) if override else int(attended.sum())
    nbytes = 2 * b * h * d * 2 + 2 * read * hkv * _page_bytes(bits, d) + b * mp * 4
    groups = hkv * -(-(h // hkv) // 8)
    splits, pps = decode_split(b, groups, mp)
    width = {4: "", 8: " int8", 16: " bf16"}[bits] + f" ps={ps}"
    record(results, "paged_decode", f"B={b} H={h} Hkv={hkv} D={d} {case}{width}",
           err, tol, ok, timer.ms(run), nbytes,
           4.0 * int(attended.sum()) * h * d, timer.ms(plain),
           grid_splits=splits, pages_per_split=pps, head_groups=groups // hkv,
           rerun=run)


def p14_append(results, timer, rng, d, hkv, bits, t=8):
    """Kernel D's whole append at T=8 with RoPE (one token per sequence,
    K and V column views of a q|k|v output) or T=1024 (8 sequences x 128
    positions, no RoPE), bit-exact against its plain version."""
    from micromix_tpu_torch.models.common import rope_inv_freq
    from micromix_tpu_torch.serve.kv_cache import append_kv, append_kv_plain
    ps, seqs = 128, 8
    mp = 1 if t > 8 else 4
    cache = _append_cache(rng, bits, seqs, mp, hkv=hkv, d=d, ps=ps)
    if t == 8:
        seq = torch.arange(8, device=DEV, dtype=torch.int32)
        pos = torch.from_numpy(rng.integers(0, mp * ps, 8).astype(np.int32)).to(DEV)
        qkv = torch.randn(t, 6 * hkv * d, device=DEV).to(torch.bfloat16)
        k = qkv[:, 4 * hkv * d:5 * hkv * d].unflatten(1, (hkv, d))
        v = qkv[:, 5 * hkv * d:].unflatten(1, (hkv, d))
        inv = rope_inv_freq(d, 500000.0, LLAMA3_SCALING, device=DEV)
        ang = pos.float()[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        rope = (torch.cos(ang), torch.sin(ang))
    else:
        seq = torch.arange(8, device=DEV, dtype=torch.int32).repeat_interleave(128)
        pos = torch.arange(128, device=DEV, dtype=torch.int32).repeat(8)
        k, v = (torch.randn(t, hkv, d, device=DEV).to(torch.bfloat16) for _ in range(2))
        rope = None
    cache.lengths.zero_()
    got, ref = (dataclasses.replace(cache, **{
        n: getattr(cache, n).clone() for n in ("k_codes", "v_codes", "k_sz",
                                               "v_sz", "lengths")})
        for _ in range(2))
    append_kv(got, seq, pos, k, v, rope=rope)
    append_kv_plain(ref, seq, pos, k, v, rope=rope)
    err = 0.0
    for n in ("k_codes", "v_codes", "k_sz", "v_sz", "lengths"):
        g, r = getattr(got, n), getattr(ref, n)
        if g.dtype == torch.bfloat16:
            g, r = g.view(torch.int16), r.view(torch.int16)
        err = max(err, float((g.float() - r.float()).abs().max()))
    slots = len(set((seq.long() * mp + pos.long() // ps).tolist()))
    nbytes = (2 * t * hkv * d * 2 + (2 * t * d * 4 if rope else 0) + 2 * t * 4
              + slots * 4 + seqs * 8 + 2 * t * hkv * _page_bytes(bits, d)
              + (2 * t * hkv * 4 if bits == 16 else 0))
    ops = t * hkv * d * ((0 if bits == 16 else 7 * 2) + (4 if rope else 0))
    width = "bf16" if bits == 16 else f"int{bits}"
    record(results, "append_kv_quant",
           f"T={t} Hkv={hkv} D={d} {width}" + (" rope" if rope else ""), err,
           "bit-exact (sz as int16 bits)", err == 0.0,
           timer.ms(lambda: append_kv(got, seq, pos, k, v, rope=rope)),
           nbytes, ops,
           timer.ms(lambda: append_kv_plain(ref, seq, pos, k, v, rope=rope)),
           flops_peak=PEAK_F32_S,
           rerun=lambda: appended(cache, lambda c: append_kv(c, seq, pos, k, v,
                                                             rope=rope)))


def p14_ptxas() -> dict:
    """``ptxas -v`` of the four kernels' instantiations: registers, spill
    bytes, stack, static shared memory."""
    return {name: build_report(name) for name in P14_SOURCES}


def phase14a(results, timer, rng) -> dict:
    """Kernels E, H, C and D at every head dim of ``P14_DIMS`` and C and H
    at every group of ``P14_GROUPS``, each against its plain version on
    the card: E at S=2048 (beside SDPA); H at S=512 over 1536 history
    positions of int4 pages (beside SDPA over the history dequantized
    beforehand); C at B=8 over 100-600 tokens of int4 pages; D at T=8
    with RoPE, bit-exact; then int8 and bf16 pages at D = 80, 100 and 256
    (D also at T=1024), C's window and ``lengths``-override rows at D =
    96, 256 and G = 12, 16, and the groups again on bf16 pages."""
    t0 = time.perf_counter()
    out = {"ptxas": p14_ptxas()}
    for d, h, hkv in P14_DIMS:
        p14_flash(results, timer, d, h, hkv)
        p14_prefill(results, timer, rng, d, h, hkv, 4)
        p14_decode(results, timer, rng, d, h, hkv, 4)
        p14_append(results, timer, rng, d, hkv, 4)
    for d, h, hkv in P14_DIMS:
        if d not in (80, 100, 256):
            continue
        for bits in (8, 16):
            p14_prefill(results, timer, rng, d, h, hkv, bits)
            p14_decode(results, timer, rng, d, h, hkv, bits)
            p14_append(results, timer, rng, d, hkv, bits)
        p14_append(results, timer, rng, d, hkv, 4, t=1024)
    for h, hkv in P14_GROUPS:
        p14_prefill(results, timer, rng, 128, h, hkv, 4)
        p14_decode(results, timer, rng, 128, h, hkv, 4)
        p14_prefill(results, timer, rng, 128, h, hkv, 16)
        p14_decode(results, timer, rng, 128, h, hkv, 16)
    for d, h, hkv in ((96, 32, 32), (256, 8, 1), (128, 96, 8), (128, 128, 8)):
        p14_decode(results, timer, rng, d, h, hkv, 4, "window 1024 len 4096")
        p14_decode(results, timer, rng, d, h, hkv, 8, "lengths 2041..2048 state")
    out["seconds"] = time.perf_counter() - t0
    return out


def llama31_405b(num_layers: int):
    """Llama-3.1-405B's published config.json widths (128 query heads over
    8 KV heads: G = 16); depth as given."""
    from micromix_tpu_torch.models.common import ModelConfig
    return ModelConfig(arch="llama", vocab_size=128256, hidden_size=16384,
                       intermediate_size=53248, num_layers=num_layers,
                       num_heads=128, num_kv_heads=8, head_dim=128,
                       rope_theta=500000.0, rms_eps=1e-5,
                       max_position_embeddings=131072,
                       rope_scaling=LLAMA3_SCALING)


def phi3_mini_attention(num_layers: int):
    """A Llama-architecture config at Phi-3-mini's published attention and
    MLP widths (hidden 3072, 32 / 32 heads of 96, intermediate 8192,
    vocab 32064, rope_theta 1e4); Phi-3's fused qkv / gate_up checkpoint
    layout is not ported, only its shapes are served."""
    from micromix_tpu_torch.models.common import ModelConfig
    return ModelConfig(arch="llama", vocab_size=32064, hidden_size=3072,
                       intermediate_size=8192, num_layers=num_layers,
                       num_heads=32, num_kv_heads=32, head_dim=96,
                       rope_theta=10000.0, rms_eps=1e-5,
                       max_position_embeddings=4096)


def gemma_2b_attention(num_layers: int):
    """A Llama-architecture config at Gemma-2B's published widths (hidden
    2048, 8 query heads of 256 over 1 KV head, intermediate 16384, vocab
    256000, rope_theta 1e4); Gemma's GeGLU MLP and scaled embedding are
    not ported, only its shapes are served."""
    from micromix_tpu_torch.models.common import ModelConfig
    return ModelConfig(arch="llama", vocab_size=256000, hidden_size=2048,
                       intermediate_size=16384, num_layers=num_layers,
                       num_heads=8, num_kv_heads=1, head_dim=256,
                       rope_theta=10000.0, rms_eps=1e-6,
                       max_position_embeddings=8192)


P14_405B_LAYERS = 4
P14_HEAD_DIM_LAYERS = 4
# every Engine this process makes: (its page pool's class, native or not)
ENGINE_POOLS = []


def watch_engine_pools() -> None:
    """Record the page pool of every ``Engine`` made from here on (its
    subclasses' too) in ``ENGINE_POOLS``."""
    from micromix_tpu_torch.serve import engine as engine_mod
    init = engine_mod.Engine.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        bm = self.block_manager
        ENGINE_POOLS.append((type(bm).__name__, bm.is_native))

    engine_mod.Engine.__init__ = recorded


def p14_serve(cfg, label: str, rng) -> dict:
    """``cfg`` at its widths, random ScaledW8 weights made on the card:
    the default engine (stacked, paired, pipelined) on phase 4's kind of
    traffic on int4 and on bf16 KV pages, each run launching every kernel
    of the Llama path, with its decode window and peak memory."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model)
    from micromix_tpu_torch.serve.runner import _can_pair
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    torch.cuda.synchronize()
    out = {"model_build_s": time.perf_counter() - t0,
           "codes_gib": sum(lay[n].w.codes.numel() for lay in params["layers"]
                            for n in ("q", "k", "v", "o", "gate", "up", "down"))
           / 2 ** 30}
    for bits in (4, 16):
        width = "bf16" if bits == 16 else "int4"
        name = f"phase 14 ({label}, {width} KV)"
        eng, stats = serve(cfg, params, _traffic(rng, cfg.vocab_size), name,
                           max_seqs=8, page_size=128, max_pages_per_seq=16,
                           decode_chunk=8, prefill_chunk=512, kv_bits=bits)
        if "qkv_stack" not in eng.params["layers"][0] \
                or not _can_pair(eng.params, cfg, 8):
            fail(f"{name}: the engine did not stack and pair its params")
        missing = [n for n in LLAMA_KERNELS if not stats["launches"].get(n)]
        if missing:
            fail(f"{name}: kernels never launched: {missing}")
        stats["decode_window"] = decode_window(eng, cfg)
        w = stats["decode_window"]
        print(f"  {label}, {cfg.num_layers} layers, {width} KV: engine "
              f"{stats['decode_ms_per_step']:.3f} ms/step, decode window "
              f"{w['ms_per_step']:.3f} ms/step host, "
              f"{w['device_busy_ms_per_step']:.3f} busy, "
              f"{w['cuda_launches_per_step']:.1f} CUDA launches/step; peak "
              f"{stats['peak_mem_gib']:.2f} GiB; " + json.dumps(stats), flush=True)
        out[width] = stats
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def p14_host_quantize() -> dict:
    """``quantize_model(host=True)`` of a 2-layer dense model at
    Llama-3.1-8B widths (made on the card from the seed, then copied to
    host memory): quantized there by the port's native library, against
    the card's quantizer on the same weights: every code and base equal.
    Both timed (host wall seconds, the card's with a synchronize)."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   quantize_model)
    from micromix_tpu_torch.utils.native import native_available
    if not native_available():
        fail("phase 14 (d): the host quantizer library did not build")
    cfg = llama31_8b(2)
    dense = dense_llama(cfg, SEED + 14, DEV)
    calib = default_calibration(cfg, p6=256, p8=256, seed=SEED)
    quantize_model(dense, cfg, calib)       # the card's first call warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = quantize_model(dense, cfg, calib)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    on_host = params_to(dense, "cpu")
    del dense
    t0 = time.perf_counter()
    host = quantize_model(on_host, cfg, calib, host=True)
    host_s = time.perf_counter() - t0
    n = 0
    for lc, lh in zip(card["layers"], host["layers"]):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            wc, wh = lc[name].w, lh[name].w
            if (type(wc) is not type(wh) or wh.codes.device.type != "cpu"
                    or not torch.equal(wc.codes.cpu(), wh.codes)
                    or wc.base != wh.base):
                fail(f"phase 14 (d): {name}'s host codes differ from the card's")
            n += wc.codes.numel()
    out = dict(card_s=card_s, host_s=host_s, weights=n,
               host_threads=os.cpu_count())
    print(f"  quantize_model at Llama-3.1-8B widths, 2 layers ({n} weights): "
          f"card {card_s:.2f}s, host (native, {os.cpu_count()} threads, "
          f"weights in host memory) {host_s:.2f}s; codes and bases "
          "equal", flush=True)
    return out


def phase14(rng, results, timer) -> dict:
    """Every head dim and GQA group the port serves: (a) Kernels E, H, C
    and D at every head dim and group against their plain versions
    (``phase14a``); (b) Llama-3.1-405B's published widths at
    ``P14_405B_LAYERS`` layers (G = 16) through the default engine on
    int4 and bf16 pages, then 2 layers of a narrow model with the same G
    and D card against CPU; (c) head dims 96 (Phi-3-mini's widths) and
    256 (Gemma-2B's) served the same way at ``P14_HEAD_DIM_LAYERS``
    layers, each 2 layers card against CPU; (d) the host quantizer
    against the card's, and every engine of the run on the native page
    pool.  Card against CPU: the prompt's last chunk may give the CPU's
    second token where the CPU's top two lie closer than that unit's
    card/CPU difference (``card_vs_cpu``'s ``near_tie``), as phase 3's
    windowed Llama may: at Gemma-2B's widths (a 256000-token vocabulary)
    the last chunk's token parted in one call while every decode step's
    agreed; every decode step's token must be equal."""
    from micromix_tpu_torch.models.common import ModelConfig
    from micromix_tpu_torch.serve.runner import _can_pair
    t14 = time.perf_counter()
    out = {"a": phase14a(results, timer, rng)}
    print(f"  phase 14 (a) took {out['a']['seconds']:.1f}s", flush=True)
    out["b"] = p14_serve(llama31_405b(P14_405B_LAYERS), "llama-3.1-405b", rng)
    narrow = ModelConfig(arch="llama", vocab_size=32000, hidden_size=2048,
                         intermediate_size=5632, num_layers=2, num_heads=16,
                         num_kv_heads=1, head_dim=128, rope_theta=500000.0,
                         rms_eps=1e-5, rope_scaling=LLAMA3_SCALING)
    must = ("flash_attention", "paged_prefill", "paged_decode", "w8_stack",
            "w8_pair")
    for bits in (4, 16):
        width = "bf16" if bits == 16 else "int4"
        out["b"][f"card_vs_cpu_{width}"] = card_vs_cpu(
            narrow, P3_STEPS, must, lambda p: _can_pair(p, narrow, 1),
            name=f"G=16 D=128 narrow {width} KV", near_tie=True, bits=bits,
            prompt_len=P3_PROMPT)
    out["c"] = {}
    for make, label in ((phi3_mini_attention, "d96"), (gemma_2b_attention, "d256")):
        cfg = make(P14_HEAD_DIM_LAYERS)
        run = p14_serve(cfg, f"{label} ({cfg.num_heads} / {cfg.num_kv_heads} "
                             f"heads of {cfg.head_dim})", rng)
        cfg2 = make(2)
        for bits in (4, 16):
            width = "bf16" if bits == 16 else "int4"
            run[f"card_vs_cpu_{width}"] = card_vs_cpu(
                cfg2, P3_STEPS, must, lambda p, c=cfg2: _can_pair(p, c, 1),
                name=f"{label} {width} KV", near_tie=True, bits=bits,
                prompt_len=P3_PROMPT)
        out["c"][label] = run
    out["d"] = p14_host_quantize()
    pools = collections.Counter(ENGINE_POOLS)
    print(f"  page pools of this run's engines: {dict(pools)}", flush=True)
    off = [k for k in pools if not k[1] and k[0] != "PrefixBlockManager"]
    if off or not pools:
        fail(f"phase 14 (d): engines off the native page pool: {off}")
    out["d"]["pools"] = {f"{k[0]}/{'native' if k[1] else 'python'}": n
                         for k, n in pools.items()}
    out["seconds"] = time.perf_counter() - t14
    return out


def p14_launches(p14, part: str) -> collections.Counter:
    """The launches of phase 14's engine runs: (b)'s ("g16"), or (c)'s at
    one head dim ("d96", "d256")."""
    runs = p14["b"] if part == "g16" else p14["c"][part]
    out = collections.Counter()
    for width in ("int4", "bf16"):
        out.update(runs[width]["launches"])
    return out


# ----------------------------------------------------------------- phase 15

# page sizes above 128 tokens that Kernel C walks in 128-token stages (the
# JAX kernel's pages on its chip are multiples of 128)
P15_PAGES = (256, 384, 512, 1024)
# (D, H, Hkv, page bits) of each page size's rows: D = 128 at G = 4 on
# int4, int8 and bf16 pages, D = 64 and 256 at G = 4, G = 16 (Llama-3.1-
# 405B's 128 / 8) on int4 and bf16
P15_ROWS = ((128, 32, 8, 4), (128, 32, 8, 8), (128, 32, 8, 16), (64, 32, 8, 4),
            (256, 32, 8, 4), (128, 128, 8, 4), (128, 128, 8, 16))
P15_CASE_PS = 512           # the page size of the window and lengths rows


def phase15a(results, timer, rng) -> dict:
    """Kernel C at pages of 256, 384, 512 and 1024 tokens against its
    plain version on the card, and at 128 beside them: every row of
    ``P15_ROWS`` at B=8 over 100-600 tokens, B=1 at 8192 tokens (int4, D =
    128, G = 4), and the window and ``lengths``-override rows at
    ``P15_CASE_PS``; each with the ``rerun`` bit-equality check, its
    median time and bound; then ``ptxas -v`` of C's instantiations, and
    per page size the grid's blocks at B=8 over 100-600 tokens (G = 4)."""
    from micromix_tpu_torch.serve.attention import decode_split
    t0 = time.perf_counter()
    out = {"ptxas": build_report("paged_decode"), "grid": {}}
    first = len(results)
    for ps in (128,) + P15_PAGES:
        for d, h, hkv, bits in P15_ROWS:
            p14_decode(results, timer, rng, d, h, hkv, bits, ps=ps)
        p14_decode(results, timer, rng, 128, 32, 8, 4, "len 8192", ps=ps)
        if ps in (128, P15_CASE_PS):
            p14_decode(results, timer, rng, 128, 32, 8, 4,
                       "window 1024 len 4096", ps=ps)
            p14_decode(results, timer, rng, 128, 32, 8, 8,
                       "lengths 2041..2048 state", ps=ps)
        mp = -(-600 // ps)
        splits, pps = decode_split(8, 8, mp)
        # blocks with pages to walk: a row of n tokens has ceil(n / ps)
        # pages, ceil(pages / pps) non-empty splits, each over 8 KV heads
        busy = sum(8 * -(-(-(-int(n) // ps)) // pps)
                   for n in np.linspace(100, 600, 8).astype(np.int32))
        out["grid"][ps] = dict(splits=splits, pages_per_split=pps,
                               blocks=8 * 8 * splits, blocks_with_pages=busy)
        print(f"  C at ps={ps}, B=8 100-600 tokens, G=4: grid {8 * 8 * splits} "
              f"blocks ({splits} splits of {pps} pages), {busy} with pages "
              f"to walk, on 132 SMs", flush=True)
    out["rows"] = len(results) - first
    out["seconds"] = time.perf_counter() - t0
    return out


def build_report(name: str) -> list:
    """``ptxas -v`` of one kernel source's instantiations, printed."""
    from micromix_tpu_torch.kernels import build
    rows = build.ptxas_report(name)
    for r in rows:
        print(f"  ptxas {name}: ...{r['function'][-40:]} registers="
              f"{r.get('registers')} spill_stores={r.get('spill_stores')} "
              f"spill_loads={r.get('spill_loads')} stack={r.get('stack')} "
              f"smem={r.get('smem')}", flush=True)
    return rows


P15_LAYERS = 4              # (b)'s and (c)'s depth at Llama-3.1-8B widths
P15_SERVE_PAGES = (256, 512)
P15_BAND = 0.5              # (b): |logit diff| / max |logit| against ps=128
P15_NARROW_RTOL = 5e-2      # (c): the narrow model's log-likelihoods, card vs CPU
# the kernels of ``forward`` at prefill rows (the per-consumer ScaledW8
# projections, the causal prefill attention)
FORWARD_KERNELS = ("site_fakequant", "w8_gemm", "flash_attention")


def p15_repage(cache, ps: int):
    """A copy of one sequence's pages (row 0, the whole table) on pages of
    ``ps`` tokens: the same tokens, codes and [scale, zero] pairs."""
    from micromix_tpu_torch.serve.kv_cache import make_cache
    total = cache.page_table.shape[1] * cache.page_size
    mp = total // ps
    new = make_cache(mp + 1, ps, cache.n_kv_heads, cache.head_dim, 1, mp,
                     bits=cache.bits, device=DEV)
    new.page_table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
    pages = cache.page_table[0].long()
    for name in ("k_codes", "v_codes", "k_sz", "v_sz"):
        x = getattr(cache, name)[pages]                 # (MP, Hkv, rows, ps0)
        hkv, rows = x.shape[1], x.shape[2]
        x = x.permute(1, 2, 0, 3).reshape(hkv, rows, mp, ps)
        getattr(new, name)[1:] = x.permute(2, 0, 1, 3)
    new.lengths.copy_(cache.lengths)
    return new


def p15_units(params, cfg, prompt, feed, pages=P15_SERVE_PAGES) -> dict:
    """The runner on pages of 128 tokens: ``prompt`` prefilled in chunks
    of 512 (E, then H over the paged history), then one decode step (C)
    for each token of ``feed``; each unit also run on a copy of its caches
    re-paged to each of ``pages`` -> {page size: each unit's f32 logits on
    the host}, every page size's units from the 128-token run's state."""
    from micromix_tpu_torch.serve.kv_cache import make_cache
    from micromix_tpu_torch.serve.runner import decode_step, prefill
    mp = -(-(len(prompt) + len(feed) + 1) // max(pages))
    mp *= max(pages) // 128
    caches = [make_cache(mp + 1, 128, cfg.num_kv_heads, cfg.head_dim, 1, mp,
                         device=DEV) for _ in range(cfg.num_layers)]
    for c in caches:
        c.page_table[0] = torch.arange(1, mp + 1, dtype=torch.int32)
    out = {ps: [] for ps in (128,) + tuple(pages)}

    def unit(fn, *args, **kw):
        nonlocal caches
        for ps in pages:
            lg, _ = fn(params, cfg, [p15_repage(c, ps) for c in caches],
                       *args, **kw)
            out[ps].append(lg[0].float().cpu())
        lg, caches = fn(params, cfg, caches, *args, **kw)
        out[128].append(lg[0].float().cpu())

    for start in range(0, len(prompt), 512):
        unit(prefill, torch.tensor([prompt[start:start + 512]], device=DEV),
             0, start, hist_len=start)
    seq = torch.zeros(1, dtype=torch.int32, device=DEV)
    for i, tok in enumerate(feed):
        unit(decode_step, torch.tensor([tok], device=DEV), seq,
             torch.tensor([len(prompt) + i], device=DEV, dtype=torch.int32))
    del caches
    return out


def phase15b(rng) -> dict:
    """The default engine at Llama-3.1-8B widths, ``P15_LAYERS`` layers of
    random ScaledW8 weights, on pages of 256 and of 512 tokens (phase 4's
    traffic, 2048 tokens a slot): every kernel of the Llama path launched,
    no plain append, C and H on int4 pages; then a 1300-token prompt and 8
    decode steps through the runner, each unit at 256 and 512 run from the
    state of the same run at 128 (its caches re-paged), every unit's
    logits within ``P15_BAND`` of the range of that run's: only the order
    of C's and H's f32 sums differs (C's split merge, H's page walk), and
    where that moves one bf16 output across an RNE tie of a site's codes,
    the random layers carry it to a sizable fraction of the range: the
    band is phase 3's card-against-CPU one (a decode step's single row
    with such a crossing reached 0.25 there, and 0.236 at 256-token pages
    in one run here); most units are bit-equal."""
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   random_quantized_model,
                                                   stack_layer_projections)
    from micromix_tpu_torch.serve.runner import _can_pair
    cfg = llama31_8b(P15_LAYERS)
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    out = {}
    for ps in P15_SERVE_PAGES:
        name = f"phase 15 (b, ps={ps})"
        eng, stats = serve(cfg, params, _traffic(rng, cfg.vocab_size), name,
                           max_seqs=8, page_size=ps,
                           max_pages_per_seq=2048 // ps, decode_chunk=8,
                           prefill_chunk=512)
        if "qkv_stack" not in eng.params["layers"][0] \
                or not _can_pair(eng.params, cfg, 8):
            fail(f"{name}: the engine did not stack and pair its params")
        missing = [n for n in LLAMA_KERNELS if not stats["launches"].get(n)]
        if missing:
            fail(f"{name}: kernels never launched: {missing}")
        stats["decode_window"] = decode_window(eng, cfg)
        w = stats["decode_window"]
        print(f"  ps={ps}, {cfg.num_layers} layers: engine "
              f"{stats['decode_ms_per_step']:.3f} ms/step, decode window "
              f"{w['ms_per_step']:.3f} ms/step host, "
              f"{w['device_busy_ms_per_step']:.3f} busy, "
              f"{w['cuda_launches_per_step']:.1f} CUDA launches/step; "
              + json.dumps(stats), flush=True)
        out[f"ps{ps}"] = stats
        del eng
        torch.cuda.empty_cache()
    stacked = stack_layer_projections(params)
    prompt = rng.integers(0, cfg.vocab_size, 1300).tolist()
    feed = rng.integers(0, cfg.vocab_size, 8).tolist()
    units = p15_units(stacked, cfg, prompt, feed)
    ref = units[128]
    out["logits"] = {}
    for ps in P15_SERVE_PAGES:
        got = units[ps]
        rels = [float((g - r).abs().max() / r.abs().max())
                for g, r in zip(got, ref)]
        same = [bool(torch.equal(g, r)) for g, r in zip(got, ref)]
        tokens = [int(g.argmax()) for g in got]
        out["logits"][f"ps{ps}"] = dict(rel_err=rels, bit_equal=same,
                                        tokens=tokens,
                                        tokens_128=[int(r.argmax()) for r in ref])
        print(f"  ps={ps} against ps=128, 3 prefill chunks then 8 decode steps: "
              f"|logit diff| / max |logit| {['%.2e' % r for r in rels]} (band "
              f"{P15_BAND}); bit-equal {same}; greedy {tokens} against "
              f"{out['logits'][f'ps{ps}']['tokens_128']}", flush=True)
        if max(rels) > P15_BAND:
            fail(f"phase 15 (b): ps={ps} logits {max(rels):.3e} of the range "
                 f"from ps=128's, over {P15_BAND}")
    del params, stacked
    torch.cuda.empty_cache()
    return out


class _Instance:
    """lm-eval 0.4's ``Instance``: a request's ``args``."""

    def __init__(self, request_type, args):
        self.request_type = request_type
        self.args = args


def p15_tasks(vocab: int) -> dict:
    """The stand-in harness's task: multiple choice over integer tokens
    (the words of ``IntTokenizer``), 4 documents of 100-400 query tokens
    and 3 choices of 1-4 tokens, from the seed."""
    rng = np.random.default_rng(SEED + 15)
    words = lambda n: " ".join(str(int(t)) for t in rng.integers(0, vocab, n))
    return {"p15_mc": [dict(query=words(int(rng.integers(100, 401))),
                            choices=[" " + words(int(rng.integers(1, 5)))
                                     for _ in range(3)], gold=int(i % 3))
                       for i in range(4)]}


@contextlib.contextmanager
def mini_lm_eval(tasks: dict):
    """A stand-in for lm-eval 0.4's ``lm_eval`` (the card's machine has
    none), as the JAX package's own harness test vendors it: the
    ``lm_eval.api.model.LM`` base, and a ``simple_evaluate`` that scores
    each document's choices by loglikelihood requests (accuracy), then
    issues one ``loglikelihood_rolling`` and one ``generate_until``
    request."""
    import types
    lm_eval = types.ModuleType("lm_eval")
    api = types.ModuleType("lm_eval.api")
    model_mod = types.ModuleType("lm_eval.api.model")

    class LM:
        def __init__(self):
            pass

    def simple_evaluate(model, tasks=(), num_fewshot=0, limit=None):
        if not isinstance(model, LM):
            fail("lm_eval stand-in: the model is not an LM")
        results = {}
        for task in tasks:
            docs = docs_by_task[task][:limit] if limit else docs_by_task[task]
            correct = 0
            for doc in docs:
                lls = model.loglikelihood([
                    _Instance("loglikelihood", (doc["query"], c))
                    for c in doc["choices"]])
                correct += int(int(np.argmax([ll for ll, _ in lls]))
                               == doc["gold"])
            results[task] = {"acc": correct / len(docs)}
        roll = model.loglikelihood_rolling(
            [_Instance("loglikelihood_rolling", (docs_by_task[tasks[0]][0]["query"],))])
        gen = model.generate_until(
            [_Instance("generate_until", ("1 2 3", {"max_gen_toks": 3}))])
        if not (len(roll) == 1 and np.isfinite(roll[0]) and len(gen) == 1
                and len(gen[0].split()) == 3):
            fail(f"lm_eval stand-in: rolling {roll}, generated {gen}")
        return {"results": results}

    docs_by_task = tasks
    model_mod.LM = LM
    api.model = model_mod
    lm_eval.api = api
    lm_eval.simple_evaluate = simple_evaluate
    names = {"lm_eval": lm_eval, "lm_eval.api": api,
             "lm_eval.api.model": model_mod}
    saved = {k: sys.modules.get(k) for k in names}
    sys.modules.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def p15_requests(vocab: int, rng):
    """A few requests of each kind: 4 loglikelihood (contexts of 200-900
    tokens, continuations of 1-8; one empty context), 2 rolling (600 and
    1800 tokens), 2 generate_until (contexts of 300 and 700, 4 and 8 new
    tokens)."""
    words = lambda n: " ".join(str(int(t)) for t in rng.integers(0, vocab, n))
    ll = [_Instance("loglikelihood", (words(n), " " + words(c)))
          for n, c in ((200, 1), (500, 4), (900, 8))]
    ll.append(_Instance("loglikelihood", ("", words(5))))
    roll = [_Instance("loglikelihood_rolling", (words(n),)) for n in (600, 1800)]
    gen = [_Instance("generate_until", (words(n), {"max_gen_toks": k}))
           for n, k in ((300, 4), (700, 8))]
    return ll, roll, gen


def p15_score(scorer, reqs, label: str, must_launch=()) -> dict:
    """The three request kinds through ``make_lm_eval_model`` under the
    stand-in harness, counted (``must_launch``) with the plain versions of
    A, B and E refused on the card -> results, seconds per request."""
    from micromix_tpu_torch.eval.lm_eval_adapter import make_lm_eval_model
    ll, roll, gen = reqs
    out = {}
    with mini_lm_eval({}):
        lm = make_lm_eval_model(scorer, IntTokenizer())
        for kind, fn, batch in (("loglikelihood", lm.loglikelihood, ll),
                                ("loglikelihood_rolling",
                                 lm.loglikelihood_rolling, roll),
                                ("generate_until", lm.generate_until, gen)):
            guard = (refuse_plain_kernels(label) if scorer.device.type == "cuda"
                     else contextlib.nullcontext())
            with guard:
                res, secs, launches, _ = counted_run(
                    f"{label} ({kind})", lambda: fn(batch),
                    must_launch if scorer.device.type == "cuda" else ())
            out[kind] = dict(results=res, s_per_request=secs / len(batch),
                             launches=launches)
    return out


def p15_greedy_steps(card, cpu, gen_requests) -> list:
    """Each ``generate_until`` request's greedy steps on the card, every
    step's next token then taken on the CPU from the same context (the
    card's tokens so far), as phase 3 holds each unit from one state: over
    a whole generation a random fp4 model turns last-bit differences into
    other paths.  A step whose CPU top two lie closer than that step's
    card/CPU logit difference (of the CPU's range) is a near tie and may
    give the CPU's second token on the card."""
    tok = IntTokenizer()
    out = []
    for req in gen_requests:
        ctx, kw = req.args
        ids = tok.encode(ctx)
        gen = card.greedy_generate(ids, kw["max_gen_toks"])
        for i, t in enumerate(gen):
            prefix = (ids + gen[:i])[-card.max_len:]
            g = card._logits(prefix)[-1].float().cpu()
            c = cpu._logits(prefix)[-1].float()
            span = float(c.abs().max())
            top = torch.topk(c, 2)
            diff = float((g - c).abs().max()) / span
            margin = float(top.values[0] - top.values[1]) / span
            out.append(dict(card=t, cpu=int(top.indices[0]), rel_err=diff,
                            margin=margin, near_tie=bool(
                                margin < diff and t == int(top.indices[1]))))
    return out


def phase15c(rng) -> dict:
    """``Scorer`` at Llama-3.1-8B widths, ``P15_LAYERS`` layers of random
    ScaledW8 weights (the per-consumer form ``forward`` runs): a few
    loglikelihood, rolling and generate_until requests through
    ``make_lm_eval_model`` under the stand-in harness, each kind launching
    A, B and E and no plain version; then 2 layers of a narrow model
    (hidden 512, 8 / 4 heads, vocab 512) on the card and on the CPU, in
    the weight-only MXFP4 form (B and E on the card, no activation site:
    with segmented sites a 2-layer random model's units part on the
    sites' RNE ties by about a tenth of the logit range between the
    devices, phase 3, and its greedy steps part with them): the
    log-likelihoods within ``P15_NARROW_RTOL`` (E's and B's f32 sums in
    another order), the greedy flags equal, and every greedy step of the
    generate_until requests equal from the card's context
    (``p15_greedy_steps``; a near tie may give the CPU's second token).
    ``eval --tasks`` on phase 8's checkpoint ran in phase 8."""
    from micromix_tpu_torch.eval.lm_eval_adapter import Scorer
    from micromix_tpu_torch.models.common import ModelConfig
    from micromix_tpu_torch.models.surgery import (default_calibration,
                                                   quantize_model_weight_only,
                                                   random_quantized_model)
    cfg = llama31_8b(P15_LAYERS)
    params = random_quantized_model(
        cfg, default_calibration(cfg, p6=256, p8=256, seed=SEED), seed=SEED,
        device=DEV)
    out = {"8b": p15_score(Scorer(params, cfg), p15_requests(cfg.vocab_size, rng),
                           "phase 15 (c)", FORWARD_KERNELS)}
    for kind, r in out["8b"].items():
        print(f"  Scorer, {cfg.num_layers} layers at Llama-3.1-8B widths, "
              f"{kind}: {r['s_per_request']:.3f} s a request; launches "
              f"{r['launches']}", flush=True)
    del params
    torch.cuda.empty_cache()
    narrow = ModelConfig(arch="llama", vocab_size=512, hidden_size=512,
                         intermediate_size=1024, num_layers=2, num_heads=8,
                         num_kv_heads=4, head_dim=64, rope_theta=500000.0,
                         rms_eps=1e-5)
    params = quantize_model_weight_only(dense_llama(narrow, SEED, DEV), narrow,
                                        "mxfp4")
    reqs = p15_requests(narrow.vocab_size, np.random.default_rng(SEED + 151))
    card = p15_score(Scorer(params, narrow), reqs, "phase 15 (c, narrow)",
                     ("w8_gemm", "flash_attention"))
    cpu = p15_score(Scorer(params_to(params, "cpu"), narrow), reqs,
                    "phase 15 (c, narrow, CPU)")
    g_ll, c_ll = card["loglikelihood"]["results"], cpu["loglikelihood"]["results"]
    rel = [abs(g - c) / abs(c) for (g, _), (c, _) in zip(g_ll, c_ll)]
    g_roll = card["loglikelihood_rolling"]["results"]
    c_roll = cpu["loglikelihood_rolling"]["results"]
    rel += [abs(g - c) / abs(c) for g, c in zip(g_roll, c_roll)]
    flags = ([f for _, f in g_ll], [f for _, f in c_ll])
    steps = p15_greedy_steps(Scorer(params, narrow),
                             Scorer(params_to(params, "cpu"), narrow), reqs[2])
    out["narrow"] = dict(rel_err=rel, greedy_flags=flags, steps=steps,
                         card=card, cpu=cpu)
    ties = sum(st["near_tie"] for st in steps)
    print(f"  narrow 2-layer model, card against CPU: log-likelihood relative "
          f"differences {['%.2e' % r for r in rel]} (tolerance "
          f"{P15_NARROW_RTOL}); greedy flags {flags[0]} / {flags[1]}; "
          f"generate_until's {len(steps)} greedy steps, each from the card's "
          f"context: card tokens {[st['card'] for st in steps]}, CPU "
          f"{[st['cpu'] for st in steps]}, {ties} near ties accepted "
          f"(CPU's top two closer than the step's card/CPU difference)",
          flush=True)
    if max(rel) > P15_NARROW_RTOL or flags[0] != flags[1] or not all(
            st["card"] == st["cpu"] or st["near_tie"] for st in steps):
        fail("phase 15 (c): the narrow model's card and CPU scores differ")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 16

P16_REPLICAS, P16_RANKS = 2, 2      # R replicas of P ranks: 4 processes
P16_LAYERS = 4                      # (a), (b): Llama-3.1-8B widths
P16_MOE_LAYERS = 2                  # (c): Mixtral-8x7B widths
P16_HEARTBEAT_S = 0.5               # (b): idle heartbeats the server sends
P16_ENGINE = dict(seed=SEED, max_seqs=8, page_size=128, max_pages_per_seq=16,
                  prefill_chunk=512, decode_chunk=8)
P16_EP_ENGINE = dict(seed=SEED, max_seqs=4, page_size=128, max_pages_per_seq=2,
                     decode_chunk=8)


def p16_assign(specs, replicas: int) -> list:
    """``Router``'s rule on the host for requests all submitted before the
    first step: each to the replica with the least queued prompt + new
    tokens, ties to the lowest index."""
    loads, out = [0] * replicas, []
    for prompt, new in specs:
        out.append(loads.index(min(loads)))
        loads[out[-1]] += len(prompt) + new
    return out


def p16_routed(router, specs, label: str, must_launch, lone) -> dict:
    """One routed run over the replicas (rank 0 submits ``specs`` and
    steps until no work is left, then stops the followers), launch
    counters reset just before and read just after, the plain versions
    refused; then a lone engine of the rank's replica (``lone(group)``,
    fresh caches, over the replica's group) runs the replica's requests in the order it admitted them,
    and must emit the same tokens; then its decode window."""
    from micromix_tpu_torch.kernels import build
    from micromix_tpu_torch.serve.engine import Request
    rank = router.group.rank
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    router.local.reset_counts()
    out = {}
    with refuse_plain_kernels(label):
        t0 = time.perf_counter()
        if rank == 0:
            reqs = p12_requests(specs)
            out["where"] = [router.submit(r) for r in reqs]
            while router.step():
                pass
            router.close()
            out["tokens"] = [r.output for r in reqs]
            out["done"] = all(r.done for r in reqs)
        else:
            router.follow()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    launches = dict(build.launches)
    missing = [k for k in must_launch if not launches.get(k)]
    missing += [f"{k} (bf16 out)" for k in ("w8_gemm", "sp_gemm")
                if f"{k}_f32" in must_launch
                and launches.get(k, 0) <= launches.get(f"{k}_f32", 0)]
    if missing:
        fail(f"{label}: rank {rank}: kernels not launched: {missing}")
    eng = router.engine
    steps = eng.phase_steps["decode"]
    out.update(launches=launches, routed=router.outputs(),
               messages=router.messages, all_reduces=router.local.reduces,
               all_reduce_s=router.local.reduce_s,
               decode_steps=steps, decode_ms_per_step=(
                   1e3 * eng.phase_s["decode"] / steps if steps else None),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if rank == 0:
        out["ticks"] = router.ticks
        out["tick_ms"] = 1e3 * router.tick_s / max(1, router.ticks)
        out["ctl_ms"] = 1e3 * router.ctl_s / max(1, router.ticks)
        out["stats"] = router.stats
        out["replicas"] = [dict(steps=m.steps,
                                leader_step_ms=1e3 * m.step_s / max(1, m.steps),
                                decode_ms_per_step=(
                                    1e3 * m.phase_s.get("decode", 0.0)
                                    / m.phase_steps["decode"]
                                    if m.phase_steps.get("decode") else None))
                           for m in router.engines]
    order = list(router.member.requests.values())
    eng2 = lone(router.local)
    reqs = [Request(r.req_id, list(r.prompt), max_new_tokens=r.max_new_tokens)
            for r in order]
    with refuse_plain_kernels(label):
        eng2.run(reqs)
        out["window"] = p12_window(eng2, router.local)
    out["lone"] = {r.req_id: r.output for r in reqs}
    if out["lone"] != out["routed"]:
        fail(f"{label}: rank {rank}: the routed replica's tokens differ from "
             f"a lone engine's on the same requests")
    del eng2
    torch.cuda.empty_cache()
    return out


def p16_http(router, prompts, new: int) -> dict:
    """(b): the ``ApiServer`` over the replicas on rank 0
    (``parallel.serve_http``): the prompts as completions at once (the
    second one streamed), beside a stream whose client goes away; after a
    few idle heartbeats /metrics, with the router's stats read under the
    server's lock.  The others follow."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from micromix_tpu_torch.parallel import serve_http
    from micromix_tpu_torch.serve import ApiServer, api
    api.HEARTBEAT_S = P16_HEARTBEAT_S
    tok = IntTokenizer()
    stop, got = threading.Event(), {}

    def client(srv):
        def one(i):
            text = tok.decode(prompts[i])
            if i == 1:
                _, raw = _http(srv.port, "/v1/completions",
                               {"prompt": text, "max_tokens": new, "stream": True})
                ev = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
                if ev[-1] != "[DONE]":
                    fail("phase 16 (b): the stream did not end with [DONE]")
                return "".join(json.loads(e)["choices"][0]["text"]
                               for e in ev[:-1]).split()
            _, body = _http(srv.port, "/v1/completions",
                            {"prompt": text, "max_tokens": new})
            return json.loads(body)["choices"][0]["text"].split()

        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(prompts)) as ex:
                cut = ex.submit(_cut_stream, srv.port, tok.decode(prompts[0]))
                got["texts"] = [[int(w) for w in t]
                                for t in ex.map(one, range(1, len(prompts)))]
                got["cut_read"] = cut.result()
            got["wall_s"] = time.perf_counter() - t0
            time.sleep(3 * P16_HEARTBEAT_S)
            _, metrics = _http(srv.port, "/metrics")
            with srv._lock:
                got["stats"] = router.stats
            got["metrics"] = dict(ln.split(" ", 1)
                                  for ln in metrics.strip().splitlines())
        finally:
            stop.set()

    with refuse_plain_kernels("phase 16 (b)"):
        st = serve_http(router, lambda rt: ApiServer(rt, lambda s: tok(s)["input_ids"],
                                                     tok.decode), stop,
                        on_start=client)
    eng = router.engine
    got.update(served=st, ticks=router.ticks,
               served_by={r.req_id: (list(r.prompt), list(r.output))
                          for r in router.member.requests.values()},
               counters={"decode_tokens": eng.decode_tokens,
                         "prefill_tokens": eng.prefill_tokens})
    return got


def p16_rank(group, calibs, specs, http_prompts, ep_specs) -> dict:
    """One rank of phase 16: (a) and (b) over two tp=2 replicas of
    Llama-3.1-8B widths (each replica's tree from its own seed, each rank
    quantizing its shard), (c) over two ep=2 replicas of Mixtral-8x7B
    widths."""
    from micromix_tpu_torch.parallel import (ReplicaRouter, make_ep_step_fns,
                                             make_tp_engine)
    from micromix_tpu_torch.serve.engine import Engine
    cfg = llama31_8b(P16_LAYERS)
    trees = {}

    def tp_engine(g, r):
        if "tp" not in trees:
            trees["tp"] = p12_tp_model(cfg, calibs[:P16_LAYERS], g,
                                       SEED + 16 + r)
        return make_tp_engine(trees["tp"], cfg, g, **P16_ENGINE)

    out = {"backend": group.backend, "device": str(group.device)}
    router = ReplicaRouter(group, tp_engine, P16_REPLICAS)
    out["placement"] = dict(replica=router.replica, members=router.local.members,
                            local_backend=router.local.backend)
    out["a"] = p16_routed(router, specs, "phase 16 (a)", TP_KERNELS,
                          lambda g: tp_engine(g, None))
    router = ReplicaRouter(group, tp_engine, P16_REPLICAS)
    out["b"] = p16_http(router, http_prompts, P16_HTTP_NEW)
    del router
    trees.clear()
    torch.cuda.empty_cache()

    mcfg = mixtral_8x7b(P16_MOE_LAYERS)

    def ep_engine(g, r):
        if "ep" not in trees:
            trees["ep"] = p12_ep_model(mcfg, g, seed=SEED + 160 + r)
        return Engine(trees["ep"], mcfg, step_fns=make_ep_step_fns(mcfg),
                      device=DEV, **P16_EP_ENGINE)

    router = ReplicaRouter(group, ep_engine, P16_REPLICAS)
    out["c"] = p16_routed(router, ep_specs, "phase 16 (c)", EP_KERNELS,
                          lambda g: ep_engine(g, None))
    trees.clear()
    torch.cuda.empty_cache()
    return out


P16_HTTP_NEW = 8


def phase16(rng, calibs) -> dict:
    """Data-parallel serving over replicas of ranks: 4 processes on the
    card over gloo, two replicas of two ranks (``parallel.ReplicaRouter``;
    replica r is global ranks 2r, 2r + 1).

      a. two tp=2 replicas at Llama-3.1-8B widths, P16_LAYERS layers
         (phase 7's first calibrations, each replica's weights from its
         own seed), phase 4's eight requests, 32 new tokens: ``assigned``
         equal to ``Router``'s rule on the host, every request's tokens
         equal to a lone tp=2 engine's run of its replica's requests in
         the same order;
      b. the ``ApiServer`` over two such replicas: nine prompts of
         64-128 tokens (eight completions at once, one streamed, and a
         stream whose client goes away), ``/metrics`` against the summed
         ``stats`` and the replicas' own counters; every completion's
         tokens are the serving replica's;
      c. two ep=2 replicas at Mixtral-8x7B widths, P16_MOE_LAYERS layers,
         eight requests of 96-128 tokens, 16 new: tokens equal to a lone
         ep=2 engine's.

    Every rank must launch its path's kernels and no plain version, and
    the ranks of a replica must emit the same tokens.  Per replica: the
    engine's decode ms a step, a decode window's host and busy ms (the
    other replica running on the same card meanwhile), the control
    messages, rank 0's host ms a tick and the channel's share of it."""
    from micromix_tpu_torch.parallel import spawn
    t_start = time.perf_counter()
    vocab = llama31_8b(1).vocab_size
    specs = [(r.prompt, r.max_new_tokens) for r in _traffic(rng, vocab)]
    http_prompts = [rng.integers(0, vocab, int(rng.integers(64, 129))).tolist()
                    for _ in range(9)]
    ep_specs = p12_specs(rng, mixtral_8x7b(1).vocab_size,
                         [int(rng.integers(96, 129)) for _ in range(8)], 16)
    world = P16_REPLICAS * P16_RANKS
    ranks = spawn(p16_rank, world, calibs, specs, http_prompts, ep_specs,
                  device=DEV)
    out = {"backend": ranks[0]["backend"], "device": ranks[0]["device"],
           "launches": collections.Counter()}
    for g, r in enumerate(ranks):
        pl = r["placement"]
        want = tuple(range(g - g % P16_RANKS, g - g % P16_RANKS + P16_RANKS))
        if pl["replica"] != g // P16_RANKS or tuple(pl["members"]) != want:
            fail(f"phase 16: rank {g} placed as {pl}, not in replica "
                 f"{g // P16_RANKS} of ranks {want}")
    for key, sp, label in (("a", specs, "Llama-3.1-8B tp=2"),
                           ("c", ep_specs, "Mixtral-8x7B ep=2")):
        a0 = ranks[0][key]
        rule = p16_assign(sp, P16_REPLICAS)
        if a0["where"] != rule or a0["stats"]["assigned"] != [
                rule.count(r) for r in range(P16_REPLICAS)]:
            fail(f"phase 16 ({key}): assigned {a0['where']}, Router's rule {rule}")
        if not a0["done"]:
            fail(f"phase 16 ({key}): a request did not finish")
        for g, r in enumerate(ranks):
            if r[key]["routed"] != ranks[g - g % P16_RANKS][key]["routed"]:
                fail(f"phase 16 ({key}): rank {g}'s tokens differ from its "
                     f"replica's first rank's")
        for i, rep in enumerate(a0["where"]):
            lone = ranks[rep * P16_RANKS][key]["lone"][i]
            if a0["tokens"][i] != lone or len(lone) != sp[i][1]:
                fail(f"phase 16 ({key}): request {i}'s tokens differ from the "
                     f"lone engine's on replica {rep}")
        for g, r in enumerate(ranks):
            out["launches"].update(r[key]["launches"])
        out[key] = dict(where=a0["where"], stats=a0["stats"], ticks=a0["ticks"],
                        tick_ms=a0["tick_ms"], ctl_ms=a0["ctl_ms"],
                        replicas=a0["replicas"],
                        ranks=[{k: v for k, v in r[key].items()
                                if k not in ("routed", "lone", "tokens")}
                               for r in ranks])
        print(f"  ({key}) {label} x {P16_REPLICAS} replicas: assigned "
              f"{a0['stats']['assigned']} (Router's rule), every request's "
              f"tokens equal to a lone engine's; rank 0: {a0['ticks']} ticks, "
              f"{a0['tick_ms']:.3f} host ms a tick, {a0['ctl_ms']:.3f} of it "
              f"the channel, {a0['messages']} control messages", flush=True)
        for rep, m in enumerate(a0["replicas"]):
            w = ranks[rep * P16_RANKS][key]["window"]
            dms = m["decode_ms_per_step"]
            print(f"    replica {rep}: engine decode "
                  f"{'n/a' if dms is None else f'{dms:.3f}'} ms/step, leader "
                  f"{m['leader_step_ms']:.3f} ms an engine step(); window "
                  f"{w['ms_per_step']:.3f} ms/step host, "
                  f"{w['device_busy_ms_per_step']:.3f} busy, "
                  f"{w['all_reduces_per_step']:.1f} all_reduces a step",
                  flush=True)
        for g, r in enumerate(ranks):
            print(f"    rank {g}: launches {dict(sorted(r[key]['launches'].items()))}; "
                  f"no plain version ran; peak {r[key]['peak_mem_gib']:.2f} GiB",
                  flush=True)
    b0 = ranks[0]["b"]
    served = {}
    for g in range(0, world, P16_RANKS):
        for g2 in range(g, g + P16_RANKS):
            if ranks[g2]["b"]["served_by"] != ranks[g]["b"]["served_by"]:
                fail(f"phase 16 (b): rank {g2}'s tokens differ from rank {g}'s")
        for prompt, output in ranks[g]["b"]["served_by"].values():
            served[tuple(prompt)] = output
    if [served.get(tuple(p)) for p in http_prompts[1:]] != b0["texts"] or \
            b0["cut_read"] != 2 or any(len(t) != P16_HTTP_NEW for t in b0["texts"]):
        fail("phase 16 (b): the completions differ from their replicas' tokens")
    if not len(served.get(tuple(http_prompts[0]), [])) < 64:
        fail("phase 16 (b): the cut stream was not cancelled on its replica")
    m, st = b0["metrics"], b0["stats"]
    leaders = [ranks[g]["b"]["counters"] for g in range(0, world, P16_RANKS)]
    for key in ("decode_tokens", "prefill_tokens"):
        if int(m[f"micromix_{key}_total"]) != sum(st[key]) or \
                st[key] != [c[key] for c in leaders]:
            fail(f"phase 16 (b): /metrics {key} {m} against stats {st} and "
                 f"the replicas' {leaders}")
    if int(m["micromix_requests_total"]) != len(http_prompts):
        fail(f"phase 16 (b): /metrics says {m}")
    idles = b0["served"]["messages"] - b0["ticks"] - 1
    out["b"] = dict(metrics=m, stats=st, wall_s=b0["wall_s"], ticks=b0["ticks"],
                    messages=b0["served"]["messages"], idle_heartbeats=idles)
    print(f"  (b) ApiServer over 2 x tp=2: {len(http_prompts)} requests "
          f"(one cut), assigned {st['assigned']}, {b0['ticks']} ticks, "
          f"{idles} idle heartbeats, completions in {b0['wall_s']:.2f}s; "
          f"/metrics = summed stats = the replicas' counters", flush=True)
    out["seconds"] = time.perf_counter() - t_start
    return out


# name -> (source, TPU kernel it replaces, shape reported in the JSON line)
KERNELS = {
    "site_fakequant": ("micromix_tpu_torch/csrc/site_fakequant.cu",
                       "micromix_tpu/kernels/fakequant.py:103",
                       "rms M=8 K=4096"),
    # A's block-format route: the hetero sites (jnp in the JAX package,
    # micromix_tpu/models/hetero.py:67-104)
    "site_fakequant_blocks": ("micromix_tpu_torch/csrc/site_fakequant.cu",
                              "micromix_tpu/kernels/fakequant.py:103",
                              "rms M=8 K=4096"),
    "w8_gemm": ("micromix_tpu_torch/csrc/w8_gemm.cu",
                "micromix_tpu/kernels/mixed_matmul.py:253",
                "M=8 N=14336 K=4096"),
    "paged_decode": ("micromix_tpu_torch/csrc/paged_decode.cu",
                     "micromix_tpu/serve/attention.py:201", "B=8"),
    "append_kv": ("micromix_tpu_torch/csrc/append_kv.cu",
                  "micromix_tpu/serve/append_kernel.py:88", "T=8"),
    "append_kv_quant": ("micromix_tpu_torch/csrc/append_kv.cu",
                        "micromix_tpu/serve/append_kernel.py:88",
                        "T=8 Hkv=8 D=128 int4 rope"),
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
LLAMA_KERNELS = ("site_fakequant", "w8_gemm", "paged_decode",
                 "append_kv_quant", "flash_attention", "w8_stack", "w8_pair",
                 "paged_prefill")
MIXTRAL_KERNELS = ("site_fakequant", "w8_gemm", "w8_stack", "w8_grouped",
                   "paged_decode", "append_kv_quant", "flash_attention",
                   "paged_prefill")
# phase 7's pipeline: E in every forward, A at the quantized forward's sites
PIPELINE_KERNELS = ("flash_attention", "site_fakequant")
# phase 4's controls batch: short prompts batched (no chunk, so no H)
CONTROLS_KERNELS = ("site_fakequant", "w8_gemm", "paged_decode",
                    "append_kv_quant", "flash_attention", "w8_stack",
                    "w8_pair")
PER_CONSUMER_KERNELS = ("site_fakequant", "w8_gemm", "paged_decode",
                        "append_kv_quant", "flash_attention")
# the split-plane engines (phase 6): the default one stacks q|k|v and
# gate|up (A + L at decode; J + K for a 256-row chunk's down), the
# per-consumer one quantizes each site with J for K (o and down: A + L)
SPLITPLANE_KERNELS = ("site_fakequant", "sp_stack", "sp_gemm", "mx_quantize",
                      "paged_decode", "append_kv_quant", "flash_attention",
                      "paged_prefill")
SPLITPLANE_PER_CONSUMER_KERNELS = ("mx_quantize", "sp_gemm", "sp_stack",
                                   "site_fakequant", "paged_decode",
                                   "append_kv_quant", "flash_attention")
# speculative serving: with a quantized draft that shares the target's
# layers (phase 9) every kernel of the stacked Llama, G in the draft's
# decode steps; with prompt lookup or a dense draft (phase 8) no residual
# pair runs, and prompts that fit one chunk take no H
PLOOKUP_KERNELS = tuple(k for k in LLAMA_KERNELS if k != "w8_pair")
SHORT_PLOOKUP_KERNELS = tuple(k for k in PLOOKUP_KERNELS if k != "paged_prefill")


# the attention kernels again on int8 pages: entry -> (kernel, the shape
# reported); their launches are those made on int8 pages
INT8_ENTRIES = {
    "paged_decode_int8": ("paged_decode", "B=8 H=32 Hkv=8 D=128 len 100..600 int8"),
    "paged_prefill_int8": ("paged_prefill", "S=512 hist=1536 H=32 Hkv=8 D=128 int8"),
}


# the kernels again at the speculative verify's 40 rows (phase 9: 8 slots,
# gamma 4): entry -> (kernel, the shape reported, its row_launches key);
# their launches are phase 9's draft run's at those rows
VERIFY_ENTRIES = {
    "paged_decode_verify": ("paged_decode",
                            "B=40 H=32 Hkv=8 D=128 verify 8x5 len 100..600",
                            "paged_decode_lengths/40"),
    "append_kv_quant_verify": ("append_kv_quant", "T=40 Hkv=8 D=128 int4 verify",
                               "append_kv_quant/40"),
    "w8_stack_verify": ("w8_stack", "q|k|v rms M=40 K=4096", "w8_stack/40"),
    "w8_gemm_verify": ("w8_gemm", "M=40 N=4096 K=4096", "w8_gemm/40"),
}


# the kernels again on bf16 pages: entry -> (kernel, the shape
# reported); their launches are phase 10's bf16 engine run's
BF16_ENTRIES = {
    "paged_decode_bf16": ("paged_decode", "B=8 H=32 Hkv=8 D=128 len 100..600 bf16"),
    "paged_prefill_bf16": ("paged_prefill", "S=512 hist=1536 H=32 Hkv=8 D=128 bf16"),
    "append_kv_quant_bf16": ("append_kv_quant", "T=8 Hkv=8 D=128 bf16 rope"),
}
# C and H at Qwen2-7B's GQA group of 7 (28 / 4 heads); their
# launches are phase 10's two engine runs' (int4 and bf16 pages)
G7_ENTRIES = {
    "paged_decode_g7": ("paged_decode", "B=8 H=28 Hkv=4 D=128 len 100..600"),
    "paged_prefill_g7": ("paged_prefill", "S=512 hist=1536 H=28 Hkv=4 D=128"),
}
# phase 14: C and H at Llama-3.1-405B's G = 16 (their launches phase 14
# (b)'s engine runs', on int4 and bf16 pages), and E, H, C and D at head
# dims 96 and 256 (phase 14 (c)'s runs at Phi-3-mini's and Gemma-2B's
# widths): entry -> (kernel, the shape reported, launches key)
P14_ENTRIES = {
    "paged_decode_g16": ("paged_decode", "B=8 H=128 Hkv=8 D=128 len 100..600", "g16"),
    "paged_prefill_g16": ("paged_prefill", "S=512 hist=1536 H=128 Hkv=8 D=128", "g16"),
    "flash_attention_d96": ("flash_attention", "B=1 S=2048 H=32 Hkv=32 D=96", "d96"),
    "paged_decode_d96": ("paged_decode", "B=8 H=32 Hkv=32 D=96 len 100..600", "d96"),
    "paged_prefill_d96": ("paged_prefill", "S=512 hist=1536 H=32 Hkv=32 D=96", "d96"),
    "append_kv_quant_d96": ("append_kv_quant", "T=8 Hkv=32 D=96 int4 rope", "d96"),
    "flash_attention_d256": ("flash_attention", "B=1 S=2048 H=8 Hkv=1 D=256", "d256"),
    "paged_decode_d256": ("paged_decode", "B=8 H=8 Hkv=1 D=256 len 100..600", "d256"),
    "paged_prefill_d256": ("paged_prefill", "S=512 hist=1536 H=8 Hkv=1 D=256", "d256"),
    "append_kv_quant_d256": ("append_kv_quant", "T=8 Hkv=1 D=256 int4 rope", "d256"),
}
# the rows of phase 14's checks whose largest error each entry reports
P14_PARTS = {"g16": "H=128 Hkv=8 D=128", "d96": "D=96", "d256": "D=256"}
# phase 15: C on pages of 256 and 512 tokens (their launches phase 15
# (b)'s engine runs at those page sizes): entry -> (kernel, the shape
# reported, the run)
P15_ENTRIES = {
    "paged_decode_ps256": ("paged_decode", "B=8 H=32 Hkv=8 D=128 len 100..600 ps=256",
                           "ps256"),
    "paged_decode_ps512": ("paged_decode", "B=8 H=32 Hkv=8 D=128 len 100..600 ps=512",
                           "ps512"),
}
# B and K with f32 output (a tensor-parallel rank's row-parallel
# partial); their launches are phase 12's, on every rank
F32_ENTRIES = {
    "w8_gemm_f32": ("w8_gemm", "M=8 N=4096 K=2048 f32"),
    "sp_gemm_f32": ("sp_gemm", "M=8 N=4096 K=2048 f32"),
}


def kernel_line(results, launches, page_launches, verify_launches,
                bf16_launches, g7_launches, f32_launches, p14, p15) -> dict:
    """The per-kernel JSON line: every kernel at its main shape, then the
    entries of another page width, row count, head group or head dim,
    each with the largest error over its rows (those whose shape names
    it)."""
    out = []
    entries = [(name, name, shape, launches.get(name, 0), None)
               for name, (_, _, shape) in KERNELS.items()]
    entries += [(entry, kernel, shape, page_launches.get((kernel, 8), 0), "int8")
                for entry, (kernel, shape) in INT8_ENTRIES.items()]
    entries += [(entry, kernel, shape, verify_launches.get(key, 0), shape)
                for entry, (kernel, shape, key) in VERIFY_ENTRIES.items()]
    entries += [(entry, kernel, shape, bf16_launches.get(kernel, 0), "bf16")
                for entry, (kernel, shape) in BF16_ENTRIES.items()]
    entries += [(entry, kernel, shape, g7_launches.get(kernel, 0), "H=28 Hkv=4")
                for entry, (kernel, shape) in G7_ENTRIES.items()]
    entries += [(entry, kernel, shape, f32_launches.get(entry, 0), "f32")
                for entry, (kernel, shape) in F32_ENTRIES.items()]
    entries += [(entry, kernel, shape, p14_launches(p14, key).get(kernel, 0),
                 P14_PARTS[key])
                for entry, (kernel, shape, key) in P14_ENTRIES.items()]
    entries += [(entry, kernel, shape,
                 p15["b"][key]["launches"].get(kernel, 0), shape)
                for entry, (kernel, shape, key) in P15_ENTRIES.items()]
    for entry, kernel, shape, n, part in entries:
        src, replaces, _ = KERNELS[kernel]
        rows = [r for r in results if r["kernel"] == kernel
                and (part is None or part in r["shape"])]
        rep = next(r for r in rows if r["shape"].startswith(shape))
        out.append(dict(name=entry, route="cuda", source=src, replaces=replaces,
                        launches=n,
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
    from micromix_tpu_torch.utils.native import host_library
    t0 = time.perf_counter()
    for lib in ("mxpack", "kvpool"):
        host_library(lib)
    print(f"  built the host libraries (mxpack, kvpool) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    watch_engine_pools()

    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results = []
    timer = Timer()
    print("phase 2: kernels against their plain versions on the card", flush=True)
    t_phase = time.perf_counter()

    def took(phase: int) -> None:
        nonlocal t_phase
        print(f"  phase {phase} took {time.perf_counter() - t_phase:.1f}s",
              flush=True)
        t_phase = time.perf_counter()

    check_site(results, timer, rng)
    check_site_blocks(results, timer, rng)
    check_gemm(results, timer)
    check_decode(results, timer, rng)
    check_append(results, timer, rng)
    check_append_quant(results, timer, rng)
    check_site_gemm(results, timer)
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
    controls = check_controls(timer)
    del timer
    torch.cuda.empty_cache()
    took(2)

    print("phase 3: 2-layer full-width stacked models, card against CPU",
          flush=True)
    p3 = phase3()
    torch.cuda.empty_cache()
    took(3)

    print("phase 4: the stacked engine at full depth (32 layers) and the "
          "per-consumer engine at 4 layers, 8 requests each", flush=True)
    p4 = phase4(rng)
    torch.cuda.empty_cache()
    took(4)

    print("phase 5: Mixtral-8x7B, the default engine at full depth (32 "
          "layers) and the per-expert engine at 2 layers, 8 requests each",
          flush=True)
    p5 = phase5(rng)
    torch.cuda.empty_cache()
    took(5)

    print("phase 6: split-plane Llama-3.1-8B, the default engine at full "
          "depth (32 layers) and the per-consumer engine at 4 layers, 8 "
          "requests each", flush=True)
    p6 = phase6()
    torch.cuda.empty_cache()
    took(6)

    print(f"phase 7: calibrate -> smooth -> quantize -> perplexity, dense "
          f"Llama-3.1-8B widths at {P7_LAYERS} layers, then 2 layers card "
          f"against CPU", flush=True)
    p7 = phase7()
    p7_calibs = p7.pop("calibs")
    torch.cuda.empty_cache()
    took(7)

    print(f"phase 8: the shell (HF checkpoint, cli calibrate / quantize / "
          f"eval / serve at int4 and int8 KV, the API server, the router) at "
          f"Llama-3.1-8B widths, {P8_LAYERS} layers", flush=True)
    t8 = time.perf_counter()
    p8 = phase8(rng)
    p8_launches = p8.pop("main_launches")
    p8_pages = p8.pop("main_page_launches")
    print(f"  phase 8 took {time.perf_counter() - t8:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 9: speculative decoding (draft model, prompt lookup) and "
          f"the prefix cache, Llama-3.1-8B widths at 32 layers", flush=True)
    p9 = phase9(rng, p4)
    print(f"  phase 9 took {p9['seconds']:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 10: Qwen2-7B at {P10_LAYERS} layers, the default (pipelined) "
          f"engine on int4 and bf16 KV pages, then 2 layers card against CPU",
          flush=True)
    p10 = phase10(rng)
    print(f"  phase 10 took {p10['seconds']:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 11: the hetero, weight-only MXFP4 / MXFP8 and int8 forms of "
          f"Llama-3.1-8B at {P11_LAYERS} layers through the default engine, 2 "
          f"layers of each card against CPU, then the Mixtral-8x7B-width "
          f"pipeline at {P11_MOE_LAYERS} layers", flush=True)
    p11 = phase11(rng, p7_calibs)
    print(f"  phase 11 took {p11['seconds']:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 12: tensor and expert parallelism, {P12_TP} ranks on the "
          f"card over gloo: B and K with f32 output, Llama-3.1-8B tp=2 at {P12_LAYERS} "
          f"layers, 2 layers card against CPU and against the single card, "
          f"the hetero and symmetric forms at {P12_SMALL_LAYERS} layers, "
          f"Mixtral-8x7B ep=2 at {P12_SMALL_LAYERS} layers, serve --tp 2",
          flush=True)
    p12 = phase12(rng, p7_calibs, p8["serve_tp"])
    results.extend(p12.pop("checks"))
    print(f"  phase 12 took {p12['seconds']:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 13: TP v1, PP and SP (gather, ring, Ulysses) over 2 and 4 "
          f"ranks on the card over gloo, Llama-3.1-8B widths: the collectives, "
          f"TP v1 at {P13_TP_LAYERS} layers, PP at {P13_PP_LAYERS} layers, SP "
          f"at {P13_TP_LAYERS} layers up to S={P13_LONG}; serve --tp 2 --port "
          f"and --profile ran in phase 8", flush=True)
    p13 = phase13(np.random.default_rng(SEED + 131), p8.get("p13"))
    print(f"  phase 13 took {p13['seconds']:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 14: every head dim (up to 256) and GQA group (up to 64): "
          f"E, H, C and D against their plain versions; Llama-3.1-405B "
          f"widths at {P14_405B_LAYERS} layers (G = 16) and head dims 96 and "
          f"256 at {P14_HEAD_DIM_LAYERS} layers through the default engine, "
          f"each 2 layers card against CPU; the host quantizer and the "
          f"native page pool", flush=True)
    timer = Timer()
    p14 = phase14(rng, results, timer)
    del timer
    print(f"  phase 14 took {p14['seconds']:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 15: Kernel C on pages of 256-1024 tokens against its plain "
          f"version; the default engine at Llama-3.1-8B widths on pages of "
          f"256 and 512 at {P15_LAYERS} layers; the lm-eval adapter's Scorer "
          f"at {P15_LAYERS} layers and 2 narrow layers card against CPU "
          f"(eval --tasks ran in phase 8)", flush=True)
    t15 = time.perf_counter()
    timer = Timer()
    p15 = {"a": phase15a(results, timer, rng)}
    del timer
    p15["b"] = phase15b(rng)
    p15["c"] = phase15c(rng)
    p15["seconds"] = time.perf_counter() - t15
    print(f"  phase 15 took {p15['seconds']:.1f}s", flush=True)
    torch.cuda.empty_cache()

    print(f"phase 16: data-parallel serving, {P16_REPLICAS} replicas of "
          f"{P16_RANKS} ranks ({P16_REPLICAS * P16_RANKS} processes on the card "
          f"over gloo) behind the router: Llama-3.1-8B tp=2 at {P16_LAYERS} "
          f"layers, the ApiServer over it, Mixtral-8x7B ep=2 at "
          f"{P16_MOE_LAYERS} layers", flush=True)
    p16 = phase16(np.random.default_rng(SEED + 16), p7_calibs)
    print(f"  phase 16 took {p16['seconds']:.1f}s", flush=True)

    for label, stats in (("Llama stacked", p4["stacked"]),
                         ("Llama per-consumer", p4["per_consumer"]),
                         ("Mixtral grouped", p5["grouped"]),
                         ("Mixtral per-expert", p5["per_expert"]),
                         ("split-plane stacked", p6["stacked"]),
                         ("split-plane per-consumer", p6["per_consumer"]),
                         ("Qwen2-7B int4 KV", p10["int4"]),
                         ("Qwen2-7B bf16 KV", p10["bf16"]),
                         *((f"Llama {form}", p11["forms"][form])
                           for form in P11_FORMS),
                         ("Llama-3.1-405B int4 KV", p14["b"]["int4"]),
                         ("Llama-3.1-405B bf16 KV", p14["b"]["bf16"]),
                         ("D=96 int4 KV", p14["c"]["d96"]["int4"]),
                         ("D=256 int4 KV", p14["c"]["d256"]["int4"]),
                         *((f"Llama pages of {ps}", p15["b"][f"ps{ps}"])
                           for ps in P15_SERVE_PAGES)):
        w = stats["decode_window"]
        print(f"  decode, {label}: engine {stats['decode_ms_per_step']} ms/step; "
              f"decode window {w['ms_per_step']:.3f} ms/step host, "
              f"{w['device_busy_ms_per_step']:.3f} ms/step device busy, "
              f"{w['cuda_launches_per_step']:.1f} CUDA launches/step", flush=True)
    # launches on the main paths: the Llama (plain and controls batches),
    # Mixtral and split-plane Llama default engines, phase 7's pipeline and
    # the shell's two serve runs (int4 and int8 KV; on int8 pages only
    # those)
    main_launches = collections.Counter(p4["stacked"]["launches"])
    main_launches.update(p4["controls"]["launches"])
    main_launches.update(p5["grouped"]["launches"])
    main_launches.update(p6["stacked"]["launches"])
    main_launches.update(p7["launches"])
    main_launches.update(p8_launches)
    for label in ("plain", "draft", "plookup"):
        main_launches.update(p9[label]["launches"])
    for run in p9["prefix"].values():
        main_launches.update(run["launches"])
    main_launches.update(p10["int4"]["launches"])
    main_launches.update(p10["bf16"]["launches"])
    for form in P11_FORMS:
        main_launches.update(p11["forms"][form]["launches"])
    main_launches.update(p11["moe"]["serve"]["launches"])
    main_launches.update(p12["launches"])
    main_launches.update(p13_launches(p13))
    for key in ("g16", "d96", "d256"):
        main_launches.update(p14_launches(p14, key))
    for ps in P15_SERVE_PAGES:
        main_launches.update(p15["b"][f"ps{ps}"]["launches"])
    for run in p15["c"]["8b"].values():
        main_launches.update(run["launches"])
    main_launches.update(p16["launches"])
    # bf16 pages: C's and H's launches on them, D's in that run
    bf16_launches = {k: p10["bf16"]["page_launches"].get(f"{k}/16", 0)
                     for k in ("paged_decode", "paged_prefill")}
    bf16_launches["append_kv_quant"] = p10["bf16"]["launches"].get("append_kv_quant", 0)
    g7_launches = collections.Counter(p10["int4"]["launches"])
    g7_launches.update(p10["bf16"]["launches"])
    f32_launches = collections.Counter(p12["launches"])
    f32_launches.update(p16["launches"])
    line = kernel_line(results, main_launches, p8_pages,
                       p9["draft"]["row_launches"], bf16_launches, g7_launches,
                       f32_launches, p14, p15)
    wall = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, checks=results, controls=controls,
                       phase3=p3, phase4=p4, phase5=p5, phase6=p6, phase7=p7,
                       phase8=p8, phase9=p9, phase10=p10, phase11=p11,
                       phase12=p12, phase13=p13, phase14=p14, phase15=p15,
                       phase16=p16,
                       routes=routes, g_routes=g_routes,
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
