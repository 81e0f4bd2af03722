"""The port's CUDA kernels against their plain versions at small, ragged
shapes.  These need an NVIDIA GPU (marker ``cuda``) and skip without one;
on the GPU machine run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest``: the suite's conftest imports JAX, which that machine need
not have).

Tolerances as in the CPU parity tests: site images bit-exact for the
plain producer and within the RNE tie band for rms / silu; GEMM and
attention outputs within 2^-7 |ref| + 2^-8 max|ref|; KV pages bit-exact;
the pair's h_mid bit-exact; the grouped GEMM bit-exact against the
per-expert loop of the site and Kernel B (the same split of K, the same
f32 sums).  The MX quantize (Kernel J): codes and scale bytes bit-exact
against the plain version for the plain and silu producers (on the H100
PyTorch's sigmoid gave the kernel's 1 / (1 + expf(-x)) bit for bit),
and for rms on inputs whose row moment is exact in any order;
its decoded codes equal the site kernel's image, bit for bit, for every
producer (shared arithmetic).  The
stacked split-plane GEMM (Kernel L) equals Kernel J followed by the
split-plane GEMM (Kernel K) on every section, bit for bit.  Stacked outputs behind an rms site are compared on the
kernel's own site image (``w8_stack_gemm``), so a tie the site kernel
moved does not count against the GEMM.
"""

import ctypes
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from micromix_tpu_torch.kernels import build
from micromix_tpu_torch.kernels.fakequant import (fakequant_site,
                                                  fakequant_site_blocks,
                                                  fakequant_site_blocks_plain,
                                                  fakequant_site_plain,
                                                  fakequant_values)
from micromix_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain)
from micromix_tpu_torch.kernels.mixed_matmul import (
    mixed_matmul_sp, mixed_matmul_sp_plain, mixed_matmul_sp_stack,
    sp_stack_gemm, sp_stack_gemm_plain, mixed_matmul_w8, mixed_matmul_w8_grouped, mixed_matmul_w8_pair,
    mixed_matmul_w8_pair_plain, mixed_matmul_w8_plain, mixed_matmul_w8_site,
    mixed_matmul_w8_stack, mixed_matmul_w8_stack_plain, w8_gemm_split,
    w8_grouped_gemm, w8_grouped_gemm_plain, w8_residual,
    w8_residual_plain, w8_residual_routed, w8_stack_gemm, w8_stack_gemm_plain, wide_tiles)
from micromix_tpu_torch.kernels.quantize import (quantize_mixed as mx_quantize,
                                                 quantize_mixed_plain)
from micromix_tpu_torch.mx.layout import compose_segmented
from micromix_tpu_torch.mx.mxtensor import (MixedTensor,
                                            dequantize_mixed_device,
                                            quantize_mixed, section_mixed,
                                            stack_split_plane)
from micromix_tpu_torch.mx.numerics import pack_fp4
from micromix_tpu_torch.mx.scaledw8 import (ScaledW8, dequantize_scaled_w8,
                                            group_scaled_w8, pack_scaled_w8,
                                            stack_scaled_w8)
from micromix_tpu_torch.serve.append_kernel import (append_kv_kernel,
                                                    append_kv_plain)
from micromix_tpu_torch.serve.attention import (decode_split,
                                                paged_decode_attention,
                                                paged_decode_attention_plain)
from micromix_tpu_torch.serve import kv_cache
from micromix_tpu_torch.serve.kv_cache import make_cache
from micromix_tpu_torch.serve.prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_plain)

pytestmark = pytest.mark.cuda
# the module (the package exports a function of the same name)
mm = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")
SPLITS = (256, 128, 128)
K = sum(SPLITS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.manual_seed(0)
    return torch.device("cuda")


def _close(got, ref):
    g, r = got.float(), ref.float()
    assert bool(((g - r).abs() <= 2.0 ** -7 * r.abs()
                 + 2.0 ** -8 * r.abs().max()).all()), float((g - r).abs().max())


def _tie_band(got, ref):
    g, r = got.float(), ref.float()
    assert float((g != r).float().mean()) <= 1e-3
    off = 0
    for kseg, mant in zip(SPLITS, (1, 2, 3)):
        gb = g[:, off:off + kseg].reshape(g.shape[0], 32, -1)
        rb = r[:, off:off + kseg].reshape(r.shape[0], 32, -1)
        bmax = torch.maximum(gb.abs().amax(1), rb.abs().amax(1)).clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(bmax)) - mant)
        assert bool(((gb - rb).abs() <= step[:, None, :]).all())
        off += kseg


@pytest.mark.parametrize("m", [1, 3, 130])
@pytest.mark.parametrize("producer", ["plain", "rms", "silu"])
def test_site_kernel(dev, m, producer):
    x = (torch.randn(m, K, device=dev) * 4).to(torch.bfloat16)
    kw = {}
    if producer == "silu":
        kw["up"] = torch.randn(m, K, device=dev).to(torch.bfloat16)
    else:
        perm = compose_segmented(np.random.default_rng(m).permutation(K), *SPLITS)
        kw["perm"] = torch.from_numpy(perm).to(dev)
    if producer == "rms":
        kw["gamma"] = torch.rand(K, device=dev) + 0.5
    if producer != "plain":
        kw.update(producer=producer, eps=1e-5)
    got = fakequant_site(x, *SPLITS, **kw)
    ref = fakequant_site_plain(x, *SPLITS, **kw)
    if producer == "plain":
        assert torch.equal(got, ref)
    else:
        _tie_band(got, ref)


def _tie_band_splits(got, ref, splits):
    g, r = got.float(), ref.float()
    assert float((g != r).float().mean()) <= 1e-3
    off = 0
    for kseg, mant in zip(splits, (1, 2, 3)):
        if kseg:
            gb = g[:, off:off + kseg].reshape(g.shape[0], 32, -1)
            rb = r[:, off:off + kseg].reshape(r.shape[0], 32, -1)
            bmax = torch.maximum(gb.abs().amax(1), rb.abs().amax(1)).clamp_min(1e-30)
            step = torch.exp2(torch.floor(torch.log2(bmax)) - mant)
            assert bool(((gb - rb).abs() <= step[:, None, :]).all())
        off += kseg


# Llama-3.1-8B's widths, and a K of 127 blocks (the row split's last CTA
# short, segments across CTA boundaries)
SITE_SPLITS = {4096: (3584, 256, 256), 14336: (13824, 256, 256),
               4064: (3584, 256, 224)}


@pytest.mark.parametrize("m", [1, 3, 8, 130, 4096])
@pytest.mark.parametrize("producer,k", [("plain", 4096), ("rms", 4096),
                                        ("silu", 14336), ("rms", 4064),
                                        ("plain", 4064)])
def test_site_kernel_row_split(dev, m, producer, k):
    """Kernel A at real widths across its launch forms: decode rows split
    over blocks (a warp a 32-block), whole rows staged in shared memory
    (M = 4096), and a block count that leaves the last block short."""
    splits = SITE_SPLITS[k]
    x = torch.randn(m, k, device=dev)
    x[:, torch.randperm(k, device=dev)[:16]] *= 30.0
    x = x.to(torch.bfloat16)
    kw = {}
    if producer == "silu":
        kw["up"] = torch.randn(m, k, device=dev).to(torch.bfloat16)
    else:
        kw["perm"] = torch.from_numpy(compose_segmented(
            np.random.default_rng(m).permutation(k), *splits)).to(dev)
    if producer == "rms":
        kw["gamma"] = torch.rand(k, device=dev) + 0.5
    if producer != "plain":
        kw.update(producer=producer, eps=1e-5)
    got = fakequant_site(x, *splits, **kw)
    ref = fakequant_site_plain(x, *splits, **kw)
    if producer == "plain":
        assert torch.equal(got, ref)
    else:
        _tie_band_splits(got, ref, splits)
    assert torch.equal(got, fakequant_site(x, *splits, **kw))


@pytest.mark.parametrize("m,groups", [(24, 8), (4096, 8), (130, 2)])
def test_site_kernel_perm_rows(dev, m, groups):
    """A plain site with one permutation per group of M / G rows (the MoE
    experts' own sites, perm_rows = M / G) in both launch forms: bit-exact
    against the plain version, and against one launch per group."""
    k = 4096
    splits = SITE_SPLITS[k]
    x = (torch.randn(m, k, device=dev) * 4).to(torch.bfloat16)
    perm = torch.stack([torch.from_numpy(compose_segmented(
        np.random.default_rng(i).permutation(k), *splits)) for i in range(groups)]).to(dev)
    got = fakequant_site(x, *splits, perm=perm)
    assert torch.equal(got, fakequant_site_plain(x, *splits, perm=perm))
    rows = m // groups
    for i in range(groups):
        one = fakequant_site(x[i * rows:(i + 1) * rows].contiguous(), *splits, perm=perm[i])
        assert torch.equal(got[i * rows:(i + 1) * rows], one)


@pytest.mark.parametrize("m", [1, 8, 130, 512, 4096])
@pytest.mark.parametrize("producer,k", [("plain", 4096), ("rms", 4096),
                                        ("silu", 14336), ("rms", 4064),
                                        ("plain", 4064)])
def test_site_blocks_kernel(dev, m, producer, k):
    """Kernel A's block-format route (the hetero sites): block formats in
    runs of 1-7 blocks, both launch forms (split rows below 264, whole
    rows above), a short last CTA at K = 4064; one launch a call, the
    plain image bit-exact, rms and silu within each block's tie band."""
    rng = np.random.default_rng(m + k)
    nb = k // 32
    fmt = np.repeat(rng.integers(0, 3, nb), rng.integers(1, 8, nb))[:nb]
    fmt = torch.from_numpy(np.resize(fmt, nb).astype(np.int32)).to(dev)
    x = torch.randn(m, k, device=dev)
    x[:, torch.randperm(k, device=dev)[:16]] *= 30.0
    x = x.to(torch.bfloat16)
    kw = {}
    if producer == "silu":
        kw = dict(producer="silu", up=torch.randn(m, k, device=dev).to(torch.bfloat16))
    else:
        kw["perm"] = torch.from_numpy(rng.permutation(k).astype(np.int32)).to(dev)
    if producer == "rms":
        kw.update(producer="rms", eps=1e-5, gamma=torch.rand(k, device=dev) + 0.5)
    before = build.launches["site_fakequant_blocks"]
    got = fakequant_site_blocks(x, fmt, **kw)
    assert build.launches["site_fakequant_blocks"] == before + 1
    ref = fakequant_site_blocks_plain(x, fmt, **kw)
    if producer == "plain":
        assert torch.equal(got, ref)
        return
    g, r = got.float(), ref.float()
    assert float((g != r).float().mean()) <= 1e-3
    gb, rb = g.reshape(m, nb, 32), r.reshape(m, nb, 32)
    bmax = torch.maximum(gb.abs().amax(-1), rb.abs().amax(-1)).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(bmax)) - (fmt.float() + 1)[None, :])
    assert bool(((gb - rb).abs() <= step[..., None]).all())


@pytest.mark.parametrize("m", [1, 8, 17, 300])
def test_int8_turbo_linear_card_equals_cpu(dev, m):
    """torch._int_mm on the card (rows padded to a multiple of 8, at least
    32) and the f32 scaling: the CPU's output bit for bit."""
    from micromix_tpu_torch.models.common import Int8TurboLinear
    w = torch.randint(-127, 128, (1024, 512), dtype=torch.int8)
    lin = Int8TurboLinear(w=w, w_scale=torch.rand(1024) * 1e-2 + 1e-4,
                          bias=torch.randn(1024).to(torch.bfloat16))
    x = (torch.randn(m, 512) * 3).to(torch.bfloat16)
    card = Int8TurboLinear(w=w.to(dev), w_scale=lin.w_scale.to(dev),
                           bias=lin.bias.to(dev))(x.to(dev))
    assert torch.equal(card.cpu(), lin(x))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("fmt", ["mxfp4", "mxfp6", "mxfp8"])
def test_weight_only_linear_card_vs_cpu(dev, fmt, bias):
    """A weight-only linear on the card (Kernel B for MXFP4, the f32
    dequantized product otherwise, its bias added before the one round to
    bf16) against the same linear on the CPU."""
    from micromix_tpu_torch.models.common import DenseLinear
    from micromix_tpu_torch.models.surgery import quantize_model_weight_only
    from micromix_tpu_torch.models.common import ModelConfig
    cfg = ModelConfig(arch="llama", vocab_size=8, hidden_size=512,
                      intermediate_size=1024, num_layers=1, num_heads=4,
                      num_kv_heads=4, head_dim=128)
    lin = DenseLinear(w=(torch.randn(1024, 512) / 512 ** 0.5).to(torch.bfloat16),
                      bias=torch.randn(1024).to(torch.bfloat16) if bias else None)
    dense = {"embed": None, "final_ln": None, "lm_head": None, "layers": [
        {"ln1": None, "ln2": None, **{n: lin for n in
                                       ("q", "k", "v", "o", "gate", "up", "down")}}]}
    q = quantize_model_weight_only(dense, cfg, fmt)["layers"][0]["q"]
    x = torch.randn(9, 512).to(torch.bfloat16)
    card = dataclasses.replace(q, w=dataclasses.replace(q.w, **{
        f.name: getattr(q.w, f.name).to(dev) for f in dataclasses.fields(q.w)
        if isinstance(getattr(q.w, f.name), torch.Tensor)}),
        bias=None if q.bias is None else q.bias.to(dev))(x.to(dev))
    _close(card.cpu(), q(x))


@pytest.mark.parametrize("m", [1, 5, 17, 100])
@pytest.mark.parametrize("n,k", [(8, 512), (72, 512), (264, 1024)])
def test_w8_gemm_kernel(dev, m, n, k):
    splits = (k - 256, 128, 128)
    w = pack_scaled_w8(quantize_mixed(torch.randn(n, k, device=dev) * 0.05,
                                      *splits, weight_fp4_only=True))
    a = torch.randn(m, k, device=dev).to(torch.bfloat16)
    before = build.launches["w8_gemm"]
    _close(mixed_matmul_w8(a, w), mixed_matmul_w8_plain(a, w))
    assert build.launches["w8_gemm"] == before + 1


@pytest.mark.parametrize("m", [65, 128, 129, 300, 512, 1023])
@pytest.mark.parametrize("n,k", [(136, 512), (264, 1024)])
def test_w8_gemm_wide_tile(dev, m, n, k):
    """Kernel B above 64 rows, its 128 x 256 cp.async tile: ragged M and N
    tiles, K split or not (w8_gemm_split), one launch a call, and equal
    bits from two calls (fixed-order partial sums)."""
    splits = (k - 256, 128, 128)
    w = pack_scaled_w8(quantize_mixed(torch.randn(n, k, device=dev) * 0.05,
                                      *splits, weight_fp4_only=True))
    a = fakequant_values(torch.randn(m, k, device=dev), *splits)
    before = build.launches["w8_gemm"]
    got = mixed_matmul_w8(a, w)
    assert build.launches["w8_gemm"] == before + 1
    _close(got, mixed_matmul_w8_plain(a, w))
    assert torch.equal(got, mixed_matmul_w8(a, w))


@pytest.mark.parametrize("base", [1, -60, -126, -135])
def test_w8_decode_exact(dev, base):
    """The 128- and 64-row ScaledW8 tiles decode every code 0..255 to the
    same bits (subnormal and underflowing values at base -135): the
    identity's first 128 rows against all codes, through the 128-row tile
    and, in two halves, through the 64-row tile.  Where the table of
    dequantize_scaled_w8 is defined (base >= -126, codes whose magnitude
    bits are not 1, which pack_scaled_w8 never emits), both equal it."""
    n, k = 256, 256
    codes = ((torch.arange(n)[:, None] + torch.arange(k)[None, :]) % 256).to(torch.uint8)
    w = ScaledW8(codes.to(dev), base)
    eye = torch.eye(k, dtype=torch.bfloat16, device=dev)
    wide = mixed_matmul_w8(eye[:128], w)
    narrow = torch.cat([mixed_matmul_w8(eye[:64], w), mixed_matmul_w8(eye[64:128], w)])
    assert torch.equal(wide, narrow)
    if base >= -126:
        ref = dequantize_scaled_w8(w).t()[:128]
        valid = (w.codes.t()[:128] & 0x7F) != 1
        assert torch.equal(wide[valid], ref[valid])


@pytest.mark.parametrize("d,ps,h,hkv", [(64, 16, 8, 2), (128, 128, 32, 8),
                                        (128, 64, 4, 4), (128, 256, 32, 8),
                                        (64, 384, 8, 2), (128, 512, 32, 8),
                                        (256, 1024, 8, 1)])
def test_paged_decode_kernel(dev, d, ps, h, hkv):
    rng = np.random.default_rng(d + ps)
    b, mp = 4, 5
    cache = make_cache(b * mp + 1, ps, hkv, d, b, mp, device=dev)
    cache.k_codes.random_(0, 256)
    cache.v_codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.01, 0.2)
        sz[:, :, 1].copy_(torch.randint(0, 16, sz[:, :, 1].shape, device=dev))
    cache.page_table.copy_(torch.from_numpy(
        1 + rng.permutation(b * mp).reshape(b, mp).astype(np.int32)))
    lengths = np.array([0, 1, ps, mp * ps - 3], np.int32)
    cache.lengths.copy_(torch.from_numpy(lengths))
    q = torch.randn(b, h, d, device=dev).to(torch.bfloat16)
    seq = torch.arange(b, device=dev, dtype=torch.int32)
    pos = torch.from_numpy(np.maximum(lengths - 1, 0)).to(dev)
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=dev) / d))
    got = paged_decode_attention(q, cache, seq, rope_positions=pos,
                                 rope_inv_freq=inv)
    _close(got, paged_decode_attention_plain(q, cache, seq, None, pos, inv))
    assert float(got[0].float().abs().max()) == 0.0     # empty sequence


def _decode_cache(dev, rng, b, mp, ps, hkv, d, bits=4):
    """A cache of b rows of mp random pages: codes, scales in [0.01, 0.2],
    integer zero points (as kv_quantize makes them), a shuffled table;
    bf16 pages (bits 16) hold normal values (their sz pages go unread)."""
    cache = make_cache(b * mp + 1, ps, hkv, d, b, mp, bits=bits, device=dev)
    for codes in (cache.k_codes, cache.v_codes):
        if bits == 16:
            codes.copy_(torch.randn(codes.shape, device=dev))
        else:
            codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.01, 0.2)
        sz[:, :, 1].copy_(torch.randint(0, 2 ** bits, sz[:, :, 1].shape, device=dev))
    cache.page_table.copy_(torch.from_numpy(
        1 + rng.permutation(b * mp).reshape(b, mp).astype(np.int32)))
    return cache


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("d,ps,h,hkv,mp", [(64, 16, 8, 2, 24), (128, 128, 32, 8, 24),
                                           (128, 64, 4, 4, 24), (128, 32, 24, 8, 40),
                                           (128, 16, 28, 4, 24), (128, 256, 32, 8, 12),
                                           (64, 384, 8, 2, 8), (128, 512, 32, 8, 6),
                                           (128, 1024, 128, 8, 4)])
def test_paged_decode_split_boundaries(dev, bits, window, d, ps, h, hkv, mp):
    """Kernel C across its split-KV grid: lengths 0, 1, ps, one token past
    the first split, every page, and a ragged one; query positions up to
    3 past the stored length (the window counts back from the query);
    G = 3 and Qwen2-7B's G = 7 pad to 8 columns; int4, int8 and bf16
    pages; pages of 256-1024 tokens, walked in stages of 128 (a window
    that starts inside a page, lengths that end inside a stage).  Twice
    the same bits: the partials merge in split order
    whichever block finishes last."""
    rng = np.random.default_rng(d + ps + bits)
    b = 6
    _, pps = decode_split(b, hkv, mp)
    cache = _decode_cache(dev, rng, b, mp, ps, hkv, d, bits)
    lengths = np.array([0, 1, ps, pps * ps + 1, mp * ps, mp * ps - 3 * ps - 5], np.int32)
    cache.lengths.copy_(torch.from_numpy(lengths))
    q = torch.randn(b, h, d, device=dev).to(torch.bfloat16)
    seq = torch.arange(b, device=dev, dtype=torch.int32)
    pos = torch.from_numpy(np.maximum(lengths - 1, 0) + np.array([0, 0, 1, 3, 0, 2])).to(dev)
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=dev) / d))
    kw = dict(rope_positions=pos, rope_inv_freq=inv, sliding_window=window)
    got = paged_decode_attention(q, cache, seq, **kw)
    _close(got, paged_decode_attention_plain(q, cache, seq, window, pos, inv))
    assert float(got[0].float().abs().max()) == 0.0     # empty sequence
    assert torch.equal(got, paged_decode_attention(q, cache, seq, **kw))


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("rope", [True, False])
def test_paged_decode_lengths_and_state(dev, bits, window, rope):
    """The ``lengths`` override (eight rows of one 1000-token sequence at
    successive positions, as speculative verify runs them, and an empty
    row) with the state (m, den): out in the attention tolerance, m within
    2^-16 max(1, |m|), den within rtol 2^-12 (f32 sums in another order);
    the empty row 0 with the state (-1e30, 0)."""
    rng = np.random.default_rng(bits)
    d, ps, h, hkv, mp = 128, 128, 32, 8, 8
    cache = _decode_cache(dev, rng, 2, mp, ps, hkv, d, bits)
    cache.lengths.copy_(torch.tensor([1000, 0], dtype=torch.int32))
    lengths = torch.tensor([990 + i for i in range(8)] + [0], dtype=torch.int32,
                           device=dev)
    seq = torch.tensor([0] * 8 + [1], dtype=torch.int32, device=dev)
    q = torch.randn(9, h, d, device=dev).to(torch.bfloat16)
    kw = dict(sliding_window=window, lengths=lengths, with_state=True)
    pos = inv = None
    if rope:
        pos = (lengths - 1).clamp_min(0)
        inv = 1.0 / (500000.0 ** (torch.arange(0, d, 2, device=dev) / d))
        kw.update(rope_positions=pos, rope_inv_freq=inv)
    out, m, den = paged_decode_attention(q, cache, seq, **kw)
    rout, rm, rden = paged_decode_attention_plain(q, cache, seq, window, pos, inv,
                                                  lengths, True)
    _close(out, rout)
    assert bool(((m - rm).abs() <= 2.0 ** -16 * rm[:8].abs().max().clamp_min(1.0)).all())
    assert bool(((den - rden).abs() <= 2.0 ** -12 * rden.abs()).all())
    assert not out[8].any() and bool((m[8] == -1e30).all()) and not den[8].any()


def test_paged_decode_refuses(dev):
    rng = np.random.default_rng(0)
    cache = _decode_cache(dev, rng, 1, 2, 48, 2, 64)
    q = torch.zeros(1, 4, 64, dtype=torch.bfloat16, device=dev)
    seq = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                     # ps 48
        paged_decode_attention(q, cache, seq)
    cache = _decode_cache(dev, rng, 1, 2, 16, 1, 64)
    with pytest.raises(ValueError):                     # G = 65
        paged_decode_attention(torch.zeros(1, 65, 64, dtype=torch.bfloat16,
                                           device=dev), cache, seq)
    cache = _decode_cache(dev, rng, 1, 2, 16, 1, 65)
    with pytest.raises(ValueError):                     # odd D
        paged_decode_attention(torch.zeros(1, 4, 65, dtype=torch.bfloat16,
                                           device=dev), cache, seq)


def test_append_kernel(dev):
    p, h, dq, ps, t = 6, 2, 32, 16, 40
    pages = [torch.randint(0, 256, (p, h, dq, ps), device=dev, dtype=torch.uint8)
             for _ in range(2)]
    pages += [torch.randn(p, h, 2, ps, device=dev).to(torch.bfloat16)
              for _ in range(2)]
    slot = torch.randperm((p - 1) * ps, device=dev)[:t]    # distinct targets
    pid, off = (1 + slot // ps).to(torch.int32), (slot % ps).to(torch.int32)
    args = (pid, off,
            torch.randint(0, 256, (t, h, dq), device=dev, dtype=torch.uint8),
            torch.randint(0, 256, (t, h, dq), device=dev, dtype=torch.uint8),
            torch.randn(t, h, 2, device=dev).to(torch.bfloat16),
            torch.randn(t, h, 2, device=dev).to(torch.bfloat16))
    got = [a.clone() for a in pages]
    ref = [a.clone() for a in pages]
    append_kv_kernel(*got, *args)
    append_kv_plain(*ref, *args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _append_cache(dev, bits, seqs, mp, d, ps=128, hkv=8):
    """seqs rows of mp pages each (a shuffled table; the scratch row
    ``seqs`` on page 0), random page contents and lengths."""
    cache = make_cache(seqs * mp + 1, ps, hkv, d, seqs + 1, mp, bits=bits,
                       device=dev)
    for a in (cache.k_codes, cache.v_codes):
        a.random_(0, 256)
    for a in (cache.k_sz, cache.v_sz):
        a.copy_(torch.randn(a.shape, device=dev))
    cache.page_table[:seqs] = 1 + torch.randperm(
        seqs * mp, device=dev).to(torch.int32).reshape(seqs, mp)
    cache.lengths.copy_(torch.randint(0, 50, (seqs + 1,), device=dev,
                                      dtype=torch.int32))
    return cache


def _append_matches_plain(cache, seq, pos, k, v, rope=None):
    """Kernel D's whole append against its plain version on copies of one
    cache: codes, [scale, zero] as int16 bits and lengths, bit for bit, on
    every page but the scratch page 0."""
    got, ref = (dataclasses.replace(cache, **{
        n: getattr(cache, n).clone() for n in ("k_codes", "v_codes", "k_sz",
                                               "v_sz", "lengths")})
        for _ in range(2))
    kv_cache.append_kv(got, seq, pos, k, v, rope=rope)
    kv_cache.append_kv_plain(ref, seq, pos, k, v, rope=rope)
    for name in ("k_codes", "v_codes", "k_sz", "v_sz"):
        g, r = getattr(got, name)[1:], getattr(ref, name)[1:]
        if g.dtype == torch.bfloat16:
            g, r = g.view(torch.int16), r.view(torch.int16)
        assert torch.equal(g, r), name
    assert torch.equal(got.lengths, ref.lengths)


def _rope_tables(pos, d):
    from micromix_tpu_torch.models.common import rope_inv_freq
    inv = rope_inv_freq(d, 500000.0, ("llama3", 8.0, 1.0, 4.0, 8192),
                        device=pos.device)
    ang = pos.float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


@pytest.mark.parametrize("t", [1, 8, 32])
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("d", [64, 128])
def test_append_quant_decode(dev, t, bits, d):
    """Decode appends with K's RoPE inside: one token per sequence on its
    own page, two rows parked on the scratch page (T >= 8), K and V as
    column views of one q|k|v output (a token stride of 48 heads); every
    fourth row of K lies above zero (a zero point from -0.0)."""
    hkv, mp = 8, 4
    real = t if t == 1 else t - 2
    cache = _append_cache(dev, bits, real, mp, d)
    seq = torch.cat([torch.arange(real, device=dev),
                     torch.full((t - real,), real, device=dev)]).to(torch.int32)
    pos = torch.randint(0, mp * 128, (t,), device=dev, dtype=torch.int32)
    pos[real:] = 0
    qkv = (torch.randn(t, 48 * d, device=dev) * 3).to(torch.bfloat16)
    qkv[::4, 32 * d:33 * d] = qkv[::4, 32 * d:33 * d].abs() + 0.01
    k = qkv[:, 32 * d:40 * d].unflatten(1, (hkv, d))
    v = qkv[:, 40 * d:].unflatten(1, (hkv, d))
    _append_matches_plain(cache, seq, pos, k, v, _rope_tables(pos, d))


@pytest.mark.parametrize("t,start", [(512, 0), (1024, 0), (512, 12), (1024, 77)])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_append_quant_prefill(dev, t, start, bits):
    """Prefill appends (K already rotated): 512-token runs of T / 512
    sequences from ``start`` (page-aligned, 4-aligned mid-page, and odd;
    bf16 pages store 4-byte words from an even column)."""
    d, n = 128, t // 512
    mp = -(-(start + 512) // 128)
    cache = _append_cache(dev, bits, n, mp, d)
    seq = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(512)
    pos = (start + torch.arange(512, device=dev, dtype=torch.int32)).repeat(n)
    k, v = ((torch.randn(t, 8, d, device=dev) * 2).to(torch.bfloat16)
            for _ in range(2))
    _append_matches_plain(cache, seq, pos, k, v)


def test_append_quant_one_cuda_launch(dev):
    """One CUDA kernel an ``append_kv`` call, at decode with RoPE and at
    prefill (torch.profiler's device events), counted once by the wrapper."""
    from torch.profiler import ProfilerActivity, profile
    cache = _append_cache(dev, 4, 8, 8, 128)
    dec_pos = torch.arange(8, device=dev, dtype=torch.int32) * 100
    dec = (torch.arange(8, device=dev, dtype=torch.int32), dec_pos,
           *((torch.randn(8, 8, 128, device=dev)).to(torch.bfloat16) for _ in range(2)))
    pre = (torch.zeros(1024, device=dev, dtype=torch.int32),
           torch.arange(1024, device=dev, dtype=torch.int32),
           *((torch.randn(1024, 8, 128, device=dev)).to(torch.bfloat16) for _ in range(2)))
    rope = _rope_tables(dec_pos, 128)
    calls = [lambda: kv_cache.append_kv(cache, *dec, rope=rope),
             lambda: kv_cache.append_kv(cache, *pre)]
    for c in calls:
        c()
    torch.cuda.synchronize()
    build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in calls:
            c()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == len(calls), [e.name for e in kernels]
    assert all("append_quant" in e.name for e in kernels), [e.name for e in kernels]
    assert dict(build.launches) == {"append_kv_quant": len(calls)}


def test_append_quant_refusals(dev):
    """No conversion on the card: int64 indices, f32 K, K whose dims are
    not dense, a head dim the kernel does not take (258: over 256) all
    raise."""
    cache = _append_cache(dev, 4, 2, 2, 128)
    seq = torch.arange(2, device=dev, dtype=torch.int32)
    pos = torch.tensor([3, 9], device=dev, dtype=torch.int32)
    k = torch.randn(2, 8, 128, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        kv_cache.append_kv(cache, seq.long(), pos, k, k)
    with pytest.raises(ValueError):
        kv_cache.append_kv(cache, seq, pos.long(), k, k)
    with pytest.raises(ValueError):
        kv_cache.append_kv(cache, seq, pos, k.float(), k)
    with pytest.raises(ValueError):
        kv_cache.append_kv(cache, seq, pos, k.transpose(1, 2).contiguous().transpose(1, 2), k)
    with pytest.raises(ValueError):
        kv_cache.append_kv(_append_cache(dev, 4, 2, 2, 258), seq, pos,
                  torch.zeros(2, 8, 258, device=dev, dtype=torch.bfloat16),
                  torch.zeros(2, 8, 258, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 300])
@pytest.mark.parametrize("window", [None, 40, 100])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel(dev, s, window, group, d):
    """Kernel E around its 64-row tiles (ragged S, one and several tiles,
    the window edge inside and across tiles), GQA groups 1, 4 and 8."""
    b, h = 2, 8
    hkv = h // group
    q = torch.randn(b, s, h, d, device=dev).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, device=dev).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, device=dev).to(torch.bfloat16)
    _close(flash_attention(q, k, v, sliding_window=window),
           flash_attention_plain(q, k, v, sliding_window=window))


def _w8(dev, n, k, splits=SPLITS):
    return pack_scaled_w8(quantize_mixed(torch.randn(n, k, device=dev) * 0.05,
                                         *splits, weight_fp4_only=True))


# (12104, 8136): enough wide tiles for one split of K, and section 0's
# last tile runs past its padded rows into section 1
STACK_SECTIONS = [(256, 64, 64), (384, 120), (12104, 8136)]


@pytest.mark.parametrize("m", [1, 8, 65, 100, 128])
@pytest.mark.parametrize("ns", STACK_SECTIONS)
def test_w8_stack_kernel(dev, m, ns):
    """Kernel F: the narrow tile up to 64 rows, the wide tile above (tiles
    numbered per section; (256, 64, 64) and (384, 120) put a 256-wide
    tile over two sections' padded rows), K split or not."""
    st = stack_scaled_w8([_w8(dev, n, K) for n in ns])
    a = torch.randn(m, K, device=dev).to(torch.bfloat16)
    before = build.launches["w8_stack"]
    got = w8_stack_gemm(a, st)
    assert build.launches["w8_stack"] == before + 1
    for g, r in zip(got, w8_stack_gemm_plain(a, st)):
        assert g.shape == r.shape
        _close(g, r)
    x = (torch.randn(m, K, device=dev) * 4).to(torch.bfloat16)
    perm = torch.from_numpy(compose_segmented(
        np.random.default_rng(m).permutation(K), *SPLITS)).to(dev)
    kw = dict(producer="rms", gamma=torch.rand(K, device=dev) + 0.5,
              perm=perm, eps=1e-5)
    img = fakequant_site(x, *SPLITS, **kw)
    _tie_band(img, fakequant_site_plain(x, *SPLITS, **kw))
    for g, r in zip(mixed_matmul_w8_stack(x, st, **kw), w8_stack_gemm_plain(img, st)):
        _close(g, r)
    for g, r in zip(mixed_matmul_w8_stack(x, st, perm=perm),
                    mixed_matmul_w8_stack_plain(x, st, perm=perm)):
        _close(g, r)


def _guarded_w8_stack(qx, st, guard=1024):
    """Kernel F through its C entry with every section's output a view
    into one NaN-filled buffer, ``guard`` elements apart: a write past a
    section's true rows lands in a guard or a neighbour.  Returns the
    outputs and the guards."""
    m, k = qx.shape
    sizes = [m * n for n in st.sections]
    buf = torch.full((sum(sizes) + guard * len(sizes),), float("nan"),
                     dtype=torch.bfloat16, device=qx.device)
    outs, guards, off = [], [], 0
    for n, size in zip(st.sections, sizes):
        outs.append(buf[off:off + size].view(m, n))
        guards.append(buf[off + size:off + size + guard])
        off += size + guard
    n_sec, total = st.n_sections, sum(st.padded)
    splits = w8_gemm_split(m, total, k)
    partial = (torch.full((splits, m, total), float("nan"), device=qx.device)
               if splits > 1 else None)
    lib = build.library("w8_stack", mm._SIG_STACK)
    rc = lib.w8_stack(
        build.ptr(qx), build.ptr(st.codes), build.ptr(partial),
        (ctypes.c_int * n_sec)(*st.sections), (ctypes.c_int * n_sec)(*st.padded),
        (ctypes.c_int * (n_sec + 1))(*wide_tiles(st.sections)),
        (ctypes.c_float * n_sec)(*[2.0 ** (b + 126) for b in st.bases]),
        (ctypes.c_void_p * n_sec)(*[o.data_ptr() for o in outs]),
        n_sec, m, k, splits, build.stream())
    build.check(rc, "w8_stack")
    torch.cuda.synchronize()
    return outs, guards


@pytest.mark.parametrize("m", [8, 65, 128])
@pytest.mark.parametrize("ns", STACK_SECTIONS)
def test_w8_stack_padded_rows_unwritten(dev, m, ns):
    """No tile writes a section's padded rows: every guard after a
    section's output keeps its NaN, and every output element is written
    (no NaN left) and right."""
    st = stack_scaled_w8([_w8(dev, n, K) for n in ns])
    a = torch.randn(m, K, device=dev).to(torch.bfloat16)
    outs, guards = _guarded_w8_stack(a, st)
    for g in guards:
        assert bool(torch.isnan(g).all())
    for g, r in zip(outs, w8_stack_gemm_plain(a, st)):
        assert not bool(torch.isnan(g).any())
        _close(g, r)


def _residual_case(dev, m, n, k, bias, seed=0):
    """A pair-A weight, a site image whose products with it sum exactly in
    f32 (so any order gives the plain version's bits), h_in and a bias."""
    torch.manual_seed(seed)
    wa = _w8(dev, n, k, (k - 256, 128, 128))
    qa = fakequant_values(torch.randn(m, k, device=dev) * 3, k - 256, 128, 128)
    h = torch.randn(m, n, device=dev).to(torch.bfloat16)
    b = (torch.randn(n, device=dev) * 0.1).to(torch.bfloat16) if bias else None
    return qa, wa, h, b


@pytest.mark.parametrize("m", [1, 3, 8, 16, 32, 40, 128])
@pytest.mark.parametrize("n,k", [(512, 512), (512, 4096), (4096, 512),
                                 (4096, 4096), (4096, 14336)])
@pytest.mark.parametrize("bias", [False, True])
def test_w8_residual_kernel(dev, m, n, k, bias):
    """Kernel G, h_mid bit-exact against the plain version, one launch a
    call, on the route ``w8_residual`` picks and, up to 32 rows, on both
    (the decode-row strip and w8_tile.cuh's tile); the strip splits K
    (tickets) at N = 512 and not at N = 4096, the tile where split_k
    says."""
    qa, wa, h, b = _residual_case(dev, m, n, k, bias)
    ref = w8_residual_plain(qa, wa, h, b)
    before = build.launches["w8_pair"]
    got = w8_residual(qa, wa, h, b)
    assert build.launches["w8_pair"] == before + 1
    assert torch.equal(got, ref)
    for route in (["rows", "tile"] if m <= mm._ROWS_MAX_M else ["tile"]):
        assert torch.equal(w8_residual_routed(qa, wa, h, b, route), ref), route


@pytest.mark.parametrize("route,m", [("rows", 8), ("rows", 16), ("rows", 32),
                                     ("tile", 8), ("tile", 40)])
@pytest.mark.parametrize("base", [1, -60, -126, -135])
def test_w8_residual_decode_exact(dev, route, m, base):
    """Every code 0..255 at every base decodes as Kernel B's 16-row tile
    decodes it (f32 product rounded to bf16, subnormal and underflowing
    values at base -135): the identity's first m rows against codes[n, k]
    = (n + k) % 256 give each code in every output row, with h_in = 0;
    where the table of dequantize_scaled_w8 is defined (base >= -126,
    codes whose magnitude bits are not 1), both equal it."""
    n, k = 256, 256
    codes = ((torch.arange(n)[:, None] + torch.arange(k)[None, :]) % 256).to(torch.uint8)
    w = ScaledW8(codes.to(dev), base)
    eye = torch.eye(k, dtype=torch.bfloat16, device=dev)[:m]
    zero = torch.zeros(m, n, dtype=torch.bfloat16, device=dev)
    got = w8_residual_routed(eye, w, zero, None, route)
    ref = torch.cat([mixed_matmul_w8(eye[i:i + 8], w) for i in range(0, m, 8)]) + zero
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    if base >= -126:
        table = dequantize_scaled_w8(w).t()[:m]
        valid = (w.codes.t()[:m] & 0x7F) != 1
        assert torch.equal(got[valid], table[valid])


def test_w8_residual_tickets_reset(dev):
    """Calls of shapes that split K (tickets and partials in the shared
    scratch), interleaved back to back on both routes without a
    synchronize: a ticket a launch left raised, or a stale partial, shows
    as a wrong h_mid in a later call."""
    cases = [_residual_case(dev, m, n, k, True, seed=i) for i, (m, n, k) in
             enumerate([(8, 512, 4096), (16, 1024, 2048), (40, 512, 4096),
                        (3, 512, 1024)])]
    for m, n, k in [(8, 512, 4096), (16, 1024, 2048), (40, 512, 4096)]:
        assert max(mm.residual_plan(m, n, k, r)[1] for r in ("rows", "tile")
                   if m <= mm._ROWS_MAX_M or r == "tile") > 1
    refs = [w8_residual_plain(*c) for c in cases]
    outs = []
    for _ in range(3):
        for qa, wa, h, b in cases:
            outs.append(w8_residual(qa, wa, h, b))
            if qa.shape[0] <= mm._ROWS_MAX_M:
                outs.append(w8_residual_routed(qa, wa, h, b, "tile"))
    torch.cuda.synchronize()
    i = 0
    for _ in range(3):
        for (qa, *_), ref in zip(cases, refs):
            for _ in range(2 if qa.shape[0] <= mm._ROWS_MAX_M else 1):
                assert torch.equal(outs[i], ref), i
                i += 1


def test_w8_residual_one_cuda_launch(dev):
    """One CUDA kernel a ``w8_residual`` call, split or not, on every
    route (torch.profiler's device events; the scratch is made by a call
    before the window)."""
    from torch.profiler import ProfilerActivity, profile
    cases = [_residual_case(dev, m, n, 4096, False)
             for m, n in [(8, 4096), (8, 512), (16, 512), (40, 512), (128, 4096)]]
    for c in cases:
        w8_residual(*c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in cases:
            w8_residual(*c)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert len(kernels) == len(cases), [e.name for e in kernels]
    assert all("w8_residual" in e.name for e in kernels), [e.name for e in kernels]


@pytest.mark.parametrize("producer", ["plain", "silu"])
def test_w8_pair_kernels(dev, producer):
    m, k = 8, 512
    st = stack_scaled_w8([_w8(dev, n, k) for n in (256, 128, 128)])
    x = torch.randn(m, K, device=dev).to(torch.bfloat16)
    kw = dict(gamma_b=torch.rand(k, device=dev) + 0.5, eps=1e-5,
              perm_b=torch.from_numpy(compose_segmented(
                  np.random.default_rng(1).permutation(k), *SPLITS)).to(dev))
    if producer == "silu":
        kw.update(producer_a="silu", up_a=torch.randn(m, K, device=dev).to(torch.bfloat16))
    else:
        kw["perm_a"] = torch.from_numpy(compose_segmented(
            np.random.default_rng(2).permutation(K), *SPLITS)).to(dev)
    wa = _w8(dev, k, K)
    h = torch.randn(m, k, device=dev).to(torch.bfloat16)
    hm, outs = mixed_matmul_w8_pair(x, h, wa, st, **kw)
    hm_ref, _ = mixed_matmul_w8_pair_plain(x, h, wa, st, **kw)
    assert torch.equal(hm, hm_ref)
    img = fakequant_site(hm, *SPLITS, producer="rms", gamma=kw["gamma_b"],
                         perm=kw["perm_b"], eps=1e-5)
    for g, r in zip(outs, w8_stack_gemm_plain(img, st)):
        _close(g, r)


@pytest.mark.parametrize("start,s,window,d,ps", [
    (0, 70, None, 64, 16), (16, 13, None, 128, 16), (41, 100, 30, 64, 16),
    (300, 128, None, 128, 128), (200, 65, 90, 128, 128),
    (57, 70, 30, 128, 12), (50, 40, None, 64, 8)])   # 4-byte page copies
def test_paged_prefill_kernel(dev, start, s, window, d, ps):
    rng = np.random.default_rng(start + s)
    h, hkv, mp = 8, 2, 8
    cache = make_cache(mp + 2, ps, hkv, d, 2, mp, device=dev)
    cache.k_codes.random_(0, 256)
    cache.v_codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.01, 0.2)
        sz[:, :, 1].copy_(torch.randint(0, 16, sz[:, :, 1].shape, device=dev))
    cache.page_table[1] = torch.from_numpy(
        1 + rng.permutation(mp + 1)[:mp].astype(np.int32)).to(dev)
    q = torch.randn(s, h, d, device=dev).to(torch.bfloat16)
    k = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    v = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    before = build.launches["paged_prefill"]
    got = paged_prefill_attention(q, k, v, cache, 1, start_t, sliding_window=window)
    assert build.launches["paged_prefill"] == before + 1
    _close(got, paged_prefill_attention_plain(q, k, v, cache, 1, start_t, window))


@pytest.mark.parametrize("hist", [512, 1536])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("window", [None, 700])
def test_paged_prefill_main_path(dev, hist, ps, group, window):
    """Kernel H at the serving chunk (S=512 over 512 or 1536 positions of
    int4 history, D=128), pages of 16 (four to a 64-key tile) and 128 (two
    tiles a page), GQA groups 4 and 8, with and without a window: against
    the plain version, one launch a call, equal bits from two calls."""
    rng = np.random.default_rng(hist + ps + group)
    s, hkv, d = 512, 2, 128
    mp = (hist + s) // ps
    cache = make_cache(mp + 1, ps, hkv, d, 1, mp, device=dev)
    cache.k_codes.random_(0, 256)
    cache.v_codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.01, 0.2)
        sz[:, :, 1].copy_(torch.randint(0, 16, sz[:, :, 1].shape, device=dev))
    cache.page_table[0] = torch.from_numpy(1 + rng.permutation(mp).astype(np.int32)).to(dev)
    q = torch.randn(s, hkv * group, d, device=dev).to(torch.bfloat16)
    k = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    v = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    start = torch.tensor(hist, dtype=torch.int32, device=dev)
    before = build.launches["paged_prefill"]
    got = paged_prefill_attention(q, k, v, cache, 0, start, sliding_window=window)
    assert build.launches["paged_prefill"] == before + 1
    _close(got, paged_prefill_attention_plain(q, k, v, cache, 0, start, window))
    assert torch.equal(got, paged_prefill_attention(q, k, v, cache, 0, start,
                                                    sliding_window=window))


@pytest.mark.parametrize("start,s,window,d,ps,group", [
    (0, 70, None, 64, 16, 4), (41, 100, 30, 64, 16, 4),
    (300, 128, None, 128, 128, 4), (200, 65, 90, 128, 128, 8),
    (57, 70, 30, 128, 12, 4), (50, 40, None, 64, 8, 2),   # 4-byte page copies
    (1536, 512, None, 128, 128, 4), (1024, 512, 700, 128, 16, 8)])
def test_paged_prefill_int8(dev, start, s, window, d, ps, group):
    """Kernel H on int8 pages (codes 0..255, integer zero points 0..255,
    so c - z spans [-255, 255]) against the plain version, small ragged
    shapes and the serving chunk (S=512 over 1024 and 1536 positions):
    one launch a call, counted as int8, equal bits from two calls."""
    rng = np.random.default_rng(start + s + d)
    hkv = 2
    mp = -(-(start + s) // ps)
    cache = make_cache(mp + 2, ps, hkv, d, 2, mp, bits=8, device=dev)
    cache.k_codes.random_(0, 256)
    cache.v_codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.001, 0.02)
        sz[:, :, 1].copy_(torch.randint(0, 256, sz[:, :, 1].shape, device=dev))
    cache.page_table[1] = torch.from_numpy(
        1 + rng.permutation(mp + 1)[:mp].astype(np.int32)).to(dev)
    q = torch.randn(s, hkv * group, d, device=dev).to(torch.bfloat16)
    k = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    v = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    before = build.page_launches[("paged_prefill", 8)]
    got = paged_prefill_attention(q, k, v, cache, 1, start_t, sliding_window=window)
    assert build.page_launches[("paged_prefill", 8)] == before + 1
    _close(got, paged_prefill_attention_plain(q, k, v, cache, 1, start_t, window))
    assert torch.equal(got, paged_prefill_attention(q, k, v, cache, 1, start_t,
                                                    sliding_window=window))


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("start,s,window,d,ps,h,hkv", [
    (41, 100, 30, 64, 16, 6, 2), (300, 128, None, 128, 128, 5, 1),
    (200, 65, 90, 128, 128, 14, 2), (57, 70, 30, 128, 12, 3, 1),
    (50, 40, None, 64, 8, 8, 1), (1536, 512, None, 128, 16, 28, 4),
    (1024, 512, 700, 128, 128, 28, 4), (0, 70, None, 64, 16, 4, 4)])
def test_paged_prefill_any_group(dev, bits, start, s, window, d, ps, h, hkv):
    """Kernel H at GQA groups that do not divide 64 (G = 3, 5, 6, 7: a
    block's spare rows are never stored, and its positions may straddle
    two chunk tiles) and at 1 and 8, on int4, int8 and bf16 pages, pages
    of 8 and 12 tokens (H's smaller copies), ragged chunks, windows, and
    Qwen2-7B's serving chunk (S = 512 over 1536 positions, 28 / 4 heads,
    D = 128): against the plain version, one launch a call counted under
    its page width, equal bits from two calls."""
    rng = np.random.default_rng(start + s + d + h)
    mp = -(-(start + s) // ps)
    cache = make_cache(mp + 2, ps, hkv, d, 2, mp, bits=bits, device=dev)
    for codes in (cache.k_codes, cache.v_codes):
        if bits == 16:
            codes.copy_(torch.randn(codes.shape, device=dev))
        else:
            codes.random_(0, 256)
    for sz in (cache.k_sz, cache.v_sz):
        sz[:, :, 0].uniform_(0.001, 0.02)
        sz[:, :, 1].copy_(torch.randint(0, 2 ** min(bits, 8), sz[:, :, 1].shape,
                                        device=dev))
    cache.page_table[1] = torch.from_numpy(
        1 + rng.permutation(mp + 1)[:mp].astype(np.int32)).to(dev)
    q = torch.randn(s, h, d, device=dev).to(torch.bfloat16)
    k = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    v = torch.randn(s, hkv, d, device=dev).to(torch.bfloat16)
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    before = build.page_launches[("paged_prefill", bits)]
    got = paged_prefill_attention(q, k, v, cache, 1, start_t, sliding_window=window)
    assert build.page_launches[("paged_prefill", bits)] == before + 1
    _close(got, paged_prefill_attention_plain(q, k, v, cache, 1, start_t, window))
    assert torch.equal(got, paged_prefill_attention(q, k, v, cache, 1, start_t,
                                                    sliding_window=window))


def test_flash_off_rne(dev):
    """Kernel E's P.V keeps the probabilities to f32's level (fault 3.1):
    at most 0.1% of its outputs differ from the float64 reference rounded
    once to bf16 (P in two bf16 terms left 0.2%, the f32 kernel 0.03-0.06%)."""
    b, s, h, hkv, d = 1, 512, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, s, hh, d, device=dev, generator=gen).to(torch.bfloat16)
               for hh in (h, hkv, hkv))
    g = h // hkv
    scores = torch.einsum("bshd,bthd->bhst", q.double(),
                          k.double().repeat_interleave(g, dim=2)) / d ** 0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    ref = torch.einsum("bhst,bthd->bshd", probs, v.double().repeat_interleave(g, dim=2))
    off = float((flash_attention(q, k, v) != ref.to(torch.bfloat16)).double().mean())
    assert off <= 1e-3, off


@pytest.mark.parametrize("c", [1, 8, 65, 100, 128, 129])
@pytest.mark.parametrize("producer", ["plain", "silu"])
def test_w8_grouped_kernel(dev, c, producer):
    """Kernel I: 3 experts; plain: sections of 200 and 120 rows (both
    padded to 256 and 128) behind each expert's own permutation; silu: one
    section of 256.  Up to 64 rows per expert the narrow tile, above the
    wide one.  Against the plain version on the kernel's own image, and
    against the per-expert loop of the site kernel and Kernel B, bit for
    bit."""
    e = 3
    ns = (200, 120) if producer == "plain" else (256,)
    secs = [[_w8(dev, n, K) for _ in range(e)] for n in ns]
    gw = group_scaled_w8(secs)
    assert gw.padded == ((256, 128) if producer == "plain" else (256,))
    x = (torch.randn(e, c, K, device=dev) * 4).to(torch.bfloat16)
    if producer == "plain":
        perm = torch.stack([torch.from_numpy(compose_segmented(
            np.random.default_rng(i).permutation(K), *SPLITS)) for i in range(e)]).to(dev)
        kw = dict(perm=perm)
        site_kw = [dict(perm=perm[i]) for i in range(e)]
    else:
        up = torch.randn(e, c, K, device=dev).to(torch.bfloat16)
        kw = dict(producer="silu", up=up)
        site_kw = [dict(producer="silu", up=up[i]) for i in range(e)]
    before = dict(build.launches)
    got = mixed_matmul_w8_grouped(x, gw, **kw)
    assert build.launches["w8_grouped"] == before.get("w8_grouped", 0) + 1
    assert build.launches["site_fakequant"] == before.get("site_fakequant", 0) + 1
    img = torch.stack([fakequant_site(x[i], *SPLITS, **site_kw[i]) for i in range(e)])
    for g, r in zip(w8_grouped_gemm(img, gw), w8_grouped_gemm_plain(img, gw)):
        assert g.shape == r.shape
        _close(g, r)
    for i in range(e):
        for si, ws in enumerate(secs):
            assert torch.equal(got[si][i], mixed_matmul_w8_site(x[i], ws[i], **site_kw[i]))


def test_w8_grouped_refuses(dev):
    gw = group_scaled_w8([[_w8(dev, 128, K) for _ in range(2)]])
    odd = dataclasses.replace(gw, padded=(96,))    # a section not padded to 64
    with pytest.raises(ValueError):
        w8_grouped_gemm(torch.zeros(2, 8, K, dtype=torch.bfloat16, device=dev), odd)
    with pytest.raises(ValueError):               # not bf16
        w8_grouped_gemm(torch.zeros(2, 8, K, device=dev), gw)
    with pytest.raises(ValueError):               # not contiguous
        mixed_matmul_w8_grouped(
            torch.zeros(8, 2, K, dtype=torch.bfloat16, device=dev).transpose(0, 1), gw)


@pytest.mark.parametrize("above", [0, 1])
def test_w8_stack_route_limit(dev, above):
    """project_all's ScaledW8 stacked leg runs Kernel F at
    ``W8_STACK_MAX_M`` rows and the dequantized stack one row above; both
    match the plain GEMM on the site kernel's own image."""
    from micromix_tpu_torch.models.common import QuantSite, project_all
    m = mm.W8_STACK_MAX_M + above
    st = stack_scaled_w8([_w8(dev, n, K) for n in (256, 120, 128)])
    perm = torch.from_numpy(compose_segmented(
        np.random.default_rng(3).permutation(K), *SPLITS)).to(dev)
    gamma = (torch.rand(K, device=dev) + 0.5).to(torch.bfloat16)
    x = (torch.randn(m, K, device=dev) * 4).to(torch.bfloat16)
    before = build.launches["w8_stack"]
    got = project_all(x, QuantSite(*SPLITS, perm=perm), None, gamma, 1e-5, stack=st)
    assert build.launches["w8_stack"] == before + (1 - above)
    img = fakequant_site(x, *SPLITS, producer="rms", gamma=gamma, perm=perm, eps=1e-5)
    for g, r in zip(got, w8_stack_gemm_plain(img, st)):
        _close(g, r)


@pytest.mark.parametrize("above", [0, 1])
def test_w8_grouped_route_limit(dev, above):
    """The grouped MoE path (dense dispatch) runs Kernel I twice at
    ``GROUPED_MAX_C`` rows per expert and the dequantized batched product
    one row above: 3 experts, K = 512, against the same path on the CPU's
    plain versions (silu-site ties moved by the sigmoid's last bit: the
    JAX package's band for a flipped tie, rtol 0.05, atol 1.0, median
    |diff| <= 0.25)."""
    import types
    from micromix_tpu_torch.models.transformer import _moe_grouped
    e, t = 3, mm.GROUPED_MAX_C + above
    gr = dict(w13=group_scaled_w8([[_w8(dev, K, K) for _ in range(e)] for _ in range(2)]),
              w2=group_scaled_w8([[_w8(dev, K, K) for _ in range(e)]]),
              perm=torch.stack([torch.from_numpy(compose_segmented(
                  np.random.default_rng(i).permutation(K), *SPLITS))
                  for i in range(e)]).to(dev))
    xn = (torch.randn(t, K, device=dev) * 8).to(torch.bfloat16)
    w = torch.rand(t, e, device=dev)
    w = torch.where(w >= w.min(dim=1, keepdim=True).values * 1.0001, w, torch.zeros_like(w))
    w = w / w.sum(dim=1, keepdim=True)
    cfg = types.SimpleNamespace(moe_capacity_factor=None)
    before = build.launches["w8_grouped"]
    got = _moe_grouped(xn, w, gr, cfg)
    assert build.launches["w8_grouped"] == before + 2 * (1 - above)
    cpu = lambda v: dataclasses.replace(v, **{f.name: getattr(v, f.name).cpu()
                                             for f in dataclasses.fields(v)
                                             if isinstance(getattr(v, f.name), torch.Tensor)})
    ref = _moe_grouped(xn.cpu(), w.cpu(), dict(w13=cpu(gr["w13"]), w2=cpu(gr["w2"]),
                                              perm=gr["perm"].cpu()), cfg)
    g, r = got.cpu().numpy(), ref.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, r, rtol=0.05, atol=1.0)
    assert np.median(np.abs(g - r)) <= 0.25


def test_wrappers_refuse_mixed_devices(dev):
    x = torch.zeros(2, K, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fakequant_site(x, *SPLITS, perm=None, producer="rms",
                       gamma=torch.ones(K))             # gamma on the CPU


FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")


def _exact_moment_input(dev, m, k):
    """bf16 rows on a grid of 1/4 below 8 in magnitude: every square and
    partial sum of the row moment is exact in f32, so any summation order
    gives the same rvar."""
    return (torch.randint(-31, 32, (m, k), device=dev) / 4.0).to(torch.bfloat16)


@pytest.mark.parametrize("m", [1, 8, 130])
@pytest.mark.parametrize("producer", ["plain", "rms", "silu"])
@pytest.mark.parametrize("splits", [SPLITS, (384, 128, 0)])
def test_mx_quantize_kernel(dev, m, producer, splits):
    k = sum(splits)
    x = _exact_moment_input(dev, m, k) if producer == "rms" else \
        (torch.randn(m, k, device=dev) * 4).to(torch.bfloat16)
    x[0, :64] = 0.0
    kw = {}
    if producer == "silu":
        kw["up"] = torch.randn(m, k, device=dev).to(torch.bfloat16)
    else:
        kw["perm"] = torch.from_numpy(compose_segmented(
            np.random.default_rng(m).permutation(k), *splits)).to(dev)
    if producer == "rms":
        kw["gamma"] = torch.rand(k, device=dev) + 0.5
    if producer != "plain":
        kw.update(producer=producer, eps=1e-5)
    before = build.launches["mx_quantize"]
    got = mx_quantize(x, *splits, **kw)
    assert build.launches["mx_quantize"] == before + 1
    assert torch.equal(dequantize_mixed_device(got), fakequant_site(x, *splits, **kw))
    ref = quantize_mixed_plain(x, *splits, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _sp_weight(dev, n, splits, fp4_only=True):
    return quantize_mixed(torch.randn(n, sum(splits), device=dev) * 0.05, *splits,
                          weight_fp4_only=fp4_only, pack_fp4=True)


@pytest.mark.parametrize("m", [1, 8, 65, 100, 128, 129, 256, 300, 511])
@pytest.mark.parametrize("splits,n,fp4_only", [
    (SPLITS, 200, True), (SPLITS, 64, False), ((384, 128, 0), 136, True),
    ((1792, 128, 128), 72, False), ((576, 1024, 448), 72, False),
    ((160, 32, 64), 64, True)])
def test_sp_gemm_kernel(dev, m, splits, n, fp4_only):
    """Kernel K against its plain version; (1792, 128, 128) splits K at
    decode M and its fp4 plane boundary (896) is no multiple of 128;
    (576, 1024, 448) and (160, 32, 64): segments of multiples of 32 (a
    tensor-parallel shard's budgets), each segment's last step partial."""
    a = mx_quantize((torch.randn(m, sum(splits), device=dev) * 3).to(torch.bfloat16),
                    *splits)
    w = _sp_weight(dev, n, splits, fp4_only)
    before = build.launches["sp_gemm"]
    got = mixed_matmul_sp(a, w)
    assert build.launches["sp_gemm"] == before + 1
    _close(got, mixed_matmul_sp_plain(a, w))


@pytest.mark.parametrize("m", [1, 8, 100, 128])
@pytest.mark.parametrize("producer", ["plain", "rms", "silu"])
@pytest.mark.parametrize("splits", [(1792, 128, 128), (576, 1024, 448),
                                    (160, 32, 64)])
def test_sp_stack_kernel(dev, m, producer, splits):
    """Kernel L against its plain version on the site kernel's image, and
    against Kernel J + Kernel K on every section, bit for bit; sections
    of 256, 120 and 128 rows (padded to 256, 128, 128).  (576, 1024, 448)
    and (160, 32, 64): segments of multiples of 32 (a tensor-parallel
    shard's budgets), each segment's last step partial, as in
    ``test_sp_gemm_kernel``."""
    k = sum(splits)
    ns = (256,) if producer == "silu" else (256, 120, 128)
    st = stack_split_plane([_sp_weight(dev, n, splits, fp4_only=False) for n in ns])
    x = (torch.randn(m, k, device=dev) * 4).to(torch.bfloat16)
    kw = {}
    if producer == "silu":
        kw = dict(producer="silu", up=torch.randn(m, k, device=dev).to(torch.bfloat16))
    else:
        kw["perm"] = torch.from_numpy(compose_segmented(
            np.random.default_rng(m).permutation(k), *splits)).to(dev)
        if producer == "rms":
            kw.update(producer="rms", gamma=torch.rand(k, device=dev) + 0.5, eps=1e-5)
    before = dict(build.launches)
    got = mixed_matmul_sp_stack(x, st, **kw)
    assert build.launches["sp_stack"] == before.get("sp_stack", 0) + 1
    assert build.launches["site_fakequant"] == before.get("site_fakequant", 0) + 1
    img = fakequant_site(x, *splits, **kw)
    for g, r in zip(got, sp_stack_gemm_plain(img, st)):
        assert g.shape == r.shape
        _close(g, r)
    codes = mx_quantize(x, *splits, **kw)
    for i, g in enumerate(got):
        assert torch.equal(g, mixed_matmul_sp(codes, section_mixed(st, i)))
    for g, h in zip(sp_stack_gemm(img, st), got):
        assert torch.equal(g, h)


ONE = (0x2, 0x0C, 0x38)   # 1.0 in e2m1, e3m2, e4m3


def _one_hot(dev, splits, packed):
    """K rows, row i the one-hot of device column i: the code of 1.0 in
    its segment's grid, scale byte 127 (2^0); fp4 packed for a weight."""
    k = sum(splits)
    parts, scales, off = [], [], 0
    for kseg, one in zip(splits, ONE):
        c = torch.zeros(k, kseg, dtype=torch.uint8)
        c[torch.arange(off, off + kseg), torch.arange(kseg)] = one
        parts.append(c)
        scales.append(torch.full((k, kseg // 32), 127, dtype=torch.uint8))
        off += kseg
    if packed:
        parts[0] = pack_fp4(parts[0])
    return MixedTensor(*[t.to(dev) for t in parts + scales], fp4_packed=packed)


def _all_codes(dev, splits, n, fp4_only, packed):
    """n rows holding every code of each segment's grid beside every scale
    byte 0..254 (byte (row * nb + block) % 255): fp4 code (column // nb)
    % 16 in the low plane and shifted by the row in the high one; FP6 / FP8
    codes (column // nb + 32 * row) mod 64 / 256.  Codes whose value
    overflows bf16 at their scale are set to 0, since one infinity would
    turn a whole output row into NaN."""
    k4, k6, k8 = splits
    row = torch.arange(n)[:, None]
    parts, scales = [], []
    for seg, kseg in enumerate(splits):
        nb = kseg // 32
        col = torch.arange(kseg)[None, :]
        member = col // nb                  # column c is in scale block c % nb
        if seg == 0 or fp4_only:
            code = (member + row * (col >= k4 // 2 if seg == 0 else 1)) % 16
        else:
            code = (member + 32 * row) % (64 if seg == 1 else 256)
        parts.append(code.to(torch.uint8))
        scales.append(((row * nb + torch.arange(nb)[None, :]) % 255).to(torch.uint8))
    t = MixedTensor(*[x.to(dev) for x in parts + scales], fp4_only=fp4_only)
    over = torch.isinf(dequantize_mixed_device(t))
    off = 0
    for seg, kseg in enumerate(splits):
        parts[seg][over[:, off:off + kseg].cpu()] = 0
        off += kseg
    if packed:
        parts[0] = pack_fp4(parts[0])
    return MixedTensor(*[x.to(dev) for x in parts + scales], fp4_packed=packed,
                       fp4_only=fp4_only)


@pytest.mark.parametrize("side,fp4_only", [("weight", True), ("weight", False),
                                           ("activation", False)])
def test_sp_decode_exact(dev, side, fp4_only):
    """Kernel K's decode, bit for bit: one operand one-hot, so each output
    is one product by 1.0 plus zeros and K returns the other operand's
    dequantize_mixed_device image exactly (a -0 comes out as +0, which
    torch.equal counts equal), over every code and scale byte 0..254.  On
    the weight side Kernel L on the identity image gives the same."""
    splits = (256, 128, 128)
    k = sum(splits)
    if side == "weight":
        w = _all_codes(dev, splits, 512, fp4_only, packed=True)
        a = _one_hot(dev, splits, packed=False)
        assert torch.equal(dequantize_mixed_device(a),
                           torch.eye(k, dtype=torch.bfloat16, device=dev))
        ref = dequantize_mixed_device(w).t()
        got = mixed_matmul_sp(a, w)
        assert torch.equal(sp_stack_gemm(torch.eye(k, dtype=torch.bfloat16, device=dev),
                                         stack_split_plane([w]))[0], ref)
    else:                                   # activations: MX grids per segment
        a = _all_codes(dev, splits, 512, False, packed=False)
        w = _one_hot(dev, splits, packed=True)
        ref = dequantize_mixed_device(a)
        got = mixed_matmul_sp(a, w)
    assert not torch.isnan(ref).any()
    assert torch.equal(got, ref)


def test_sp_kernels_refuse(dev):
    w = _sp_weight(dev, 64, SPLITS)
    a = mx_quantize(torch.zeros(2, K, dtype=torch.bfloat16, device=dev), *SPLITS)
    with pytest.raises(ValueError):               # N % 8
        mixed_matmul_sp(a, _sp_weight(dev, 60, SPLITS))
    with pytest.raises(ValueError):               # packed activation
        mixed_matmul_sp(quantize_mixed(torch.zeros(2, K, device=dev), *SPLITS,
                                       pack_fp4=True), w)
    with pytest.raises(ValueError):               # more than 4 sections
        sp_stack_gemm(torch.zeros(2, K, dtype=torch.bfloat16, device=dev),
                      stack_split_plane([w] * 5))


def _f32_close(got, ref, a, w):
    """f32 sums of the same exact products in another order: each side
    within gamma_K = K 2^-24 of |A| |W|^T."""
    bound = 2 * a.shape[1] * 2.0 ** -24 * (a.abs().float() @ w.abs().float().t())
    assert bool(((got - ref).abs() <= bound).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("m", [1, 8, 100, 512])
@pytest.mark.parametrize("n,k", [(72, 512), (264, 2048)])
def test_w8_gemm_f32_out(dev, m, n, k):
    """Kernel B with f32 output (a tensor-parallel rank's partial) against
    its plain version; its bf16 output is the f32 one rounded, bit for
    bit (one store template, the same split); f32 calls counted apart."""
    splits = (k - 256, 128, 128)
    w = pack_scaled_w8(quantize_mixed(torch.randn(n, k, device=dev) * 0.05,
                                      *splits, weight_fp4_only=True))
    a = fakequant_values(torch.randn(m, k, device=dev), *splits)
    before = build.launches["w8_gemm_f32"]
    got = mixed_matmul_w8(a, w, torch.float32)
    assert got.dtype == torch.float32
    assert build.launches["w8_gemm_f32"] == before + 1
    _f32_close(got, mixed_matmul_w8_plain(a, w, torch.float32), a,
               dequantize_scaled_w8(w))
    assert torch.equal(mixed_matmul_w8(a, w), got.to(torch.bfloat16))


@pytest.mark.parametrize("m", [1, 8, 100, 511])
@pytest.mark.parametrize("splits,n,fp4_only", [(SPLITS, 200, True),
                                               ((1792, 128, 128), 72, False),
                                               ((576, 1024, 448), 72, False)])
def test_sp_gemm_f32_out(dev, m, splits, n, fp4_only):
    """Kernel K with f32 output against its plain version; its bf16
    output is the f32 one rounded, bit for bit."""
    a = mx_quantize((torch.randn(m, sum(splits), device=dev) * 3).to(torch.bfloat16),
                    *splits)
    w = _sp_weight(dev, n, splits, fp4_only)
    before = build.launches["sp_gemm_f32"]
    got = mixed_matmul_sp(a, w, torch.float32)
    assert got.dtype == torch.float32
    assert build.launches["sp_gemm_f32"] == before + 1
    _f32_close(got, mixed_matmul_sp_plain(a, w, torch.float32),
               dequantize_mixed_device(a), dequantize_mixed_device(w))
    assert torch.equal(mixed_matmul_sp(a, w), got.to(torch.bfloat16))


def test_f32_out_dequantize_routes(dev):
    """From the row thresholds on, ``mixed_matmul`` gives f32 out from f32
    products of the exact decoded operands (the JAX package's dot with f32
    accumulation), within the same band of its plain version."""
    splits = (256, 128, 128)
    w8 = pack_scaled_w8(quantize_mixed(torch.randn(64, K, device=dev) * 0.05,
                                       *splits, weight_fp4_only=True))
    a = fakequant_values(torch.randn(mm.W8_PREFILL_DEQUANT_THRESHOLD, K,
                                     device=dev), *splits)
    got = mm.mixed_matmul(a, w8, out_dtype=torch.float32)
    _f32_close(got, mixed_matmul_w8_plain(a, w8, torch.float32), a,
               dequantize_scaled_w8(w8))
    wsp = _sp_weight(dev, 64, splits, False)
    asp = mx_quantize(torch.randn(mm.PREFILL_DEQUANT_THRESHOLD, K,
                                  device=dev).to(torch.bfloat16), *splits)
    got = mm.mixed_matmul(asp, wsp, out_dtype=torch.float32)
    _f32_close(got, mixed_matmul_sp_plain(asp, wsp, torch.float32),
               dequantize_mixed_device(asp), dequantize_mixed_device(wsp))


def test_two_ranks_all_reduce_cuda_tensors_on_one_card(dev):
    """Two ranks on one card (parallel.spawn): gloo, as NCCL refuses two
    ranks on one device, sums CUDA tensors staged through the host."""
    import torch_ranks
    from micromix_tpu_torch.parallel import spawn
    if torch.cuda.device_count() != 1:
        pytest.skip("one card: the two ranks share it")
    out = spawn(torch_ranks.cuda_all_reduce, 2, device="cuda")
    assert [o["backend"] for o in out] == ["gloo", "gloo"]
    assert all(o["device"] == "cuda:0" for o in out)
    assert all(o["sum"] == [3.0, 6.0, 9.0] for o in out)
