"""Kernel H's arithmetic on the tensor-core tile, held against the JAX
package's paged prefill attention on the CPU.

The CUDA kernel (``csrc/paged_prefill.cu``) cannot run here, so a
test-local helper computes paged prefill attention the way its tile does:
the int4 history unpacked to ``(c - z)`` rounded to bf16 (exact: the zero
point is an integer), Q . (C - z)^T with f32 sums, each score column times
its token's scale and 1/sqrt(D) in f32, the V scale folded into the
probabilities before they are split into three bf16 terms
(``fa::PV_TERMS``), each tile's P.V summed apart and added to O in f32, and
one online softmax over 64-key tiles of history, then of the chunk.

Tolerance against ``paged_prefill_attention(interpret=True)``: both are f32
computations of the same function that differ in the order of the sums,
in where the scales' roundings fall and in P's last bits (three bf16 terms
keep 24 of them), about 2^-20 of an output; so after the one bf16 rounding
of the output at most 1 output in 2000 may differ (one whose f32 value
lies that close to a rounding midpoint), each by at most
2^-7 |ref| + 2^-8 max|ref|, as the suite's attention tests allow.  (P in
two bf16 terms, 2^-17 of p, moves 1-2 outputs in 1000 on these inputs.)
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve.prefill_attention import \
    paged_prefill_attention as j_prefill_attn

PS, HKV, D, P, MP = 16, 2, 64, 12, 6
BK = 64          # keys a tile (csrc/flash_tile.cuh)
TERMS = 3        # bf16 terms of P (fa::PV_TERMS)
NEG = -1e30


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _split(p: torch.Tensor, terms: int) -> list:
    """p (f32) -> bf16 terms, each the rounding of what the others left."""
    out = []
    for _ in range(terms):
        t = p.to(torch.bfloat16).float()
        out.append(t)
        p = p - t                                       # exact in f32
    return out


def tile_attention(q, k, v, kc, ksz, vc, vsz, table, start, window, terms=TERMS):
    """Paged prefill attention as Kernel H's tile computes it.  q (S, H, D),
    k / v (S, Hkv, D): bf16 values in f32 numpy; kc / vc (P, Hkv, D/2, ps)
    u8 pages; ksz / vsz (P, Hkv, 2, ps) bf16 values in f32."""
    s, h, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    ps = kc.shape[-1]
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    pos = np.arange(start)
    page, off = table[pos // ps], pos % ps

    def unpack(codes, sz):
        c = codes[page, :, :, off]                         # (T, Hkv, D/2)
        c = np.concatenate([c & 0xF, c >> 4], -1).astype(np.float32)
        z = sz[page, :, 1, off]                            # (T, Hkv)
        diff = torch.from_numpy(c - z[..., None])
        cz = diff.to(torch.bfloat16).float()
        assert torch.equal(cz, diff)                       # c - z exact in bf16
        return cz, torch.from_numpy(sz[page, :, 0, off].copy())

    kcz, ks = unpack(kc, ksz)
    vcz, vs = unpack(vc, vsz)
    head = np.arange(h) // g
    qf = torch.from_numpy(q)                                # (S, H, D)
    lp = torch.arange(s)[None, :, None]                     # chunk-local row
    m = torch.full((h, s, 1), NEG)
    den = torch.zeros(h, s, 1)
    o = torch.zeros(h, s, d)

    def step(scores, allow, vals, vscale=None):
        nonlocal m, den, o
        scores = torch.where(allow, scores, torch.tensor(NEG))
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        den = den * corr + p.sum(-1, keepdim=True)
        if vscale is not None:
            p = p * vscale                                  # s_t folded into p_t
        tile = sum(torch.einsum("hst,thd->hsd", t, vals) for t in _split(p, terms))
        o = o * corr + tile
        m = m_new

    for t0 in range(0, start, BK):                          # the int4 history
        cols = slice(t0, min(t0 + BK, start))
        kpos = torch.arange(t0, cols.stop)[None, None, :]
        ksc = ks[cols][:, head].T[:, None, :] * scale       # (H, 1, T) f32
        scores = torch.einsum("shd,thd->hst", qf, kcz[cols][:, head]) * ksc
        allow = kpos < start
        if window is not None:
            allow = allow & (kpos > start + lp - window)
        step(scores, allow, vcz[cols][:, head], vs[cols][:, head].T[:, None, :])
    kf, vf = torch.from_numpy(k), torch.from_numpy(v)
    for t0 in range(0, s, BK):                              # the chunk, causal
        cols = slice(t0, min(t0 + BK, s))
        kpos = torch.arange(t0, cols.stop)[None, None, :]
        scores = torch.einsum("shd,thd->hst", qf, kf[cols][:, head]) * scale
        allow = kpos <= lp
        if window is not None:
            allow = allow & (kpos > lp - window)
        step(scores, allow, vf[cols][:, head])
    out = o / den.clamp_min(1e-30)
    return out.permute(1, 0, 2).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("start,s,window,g", [
    (41, 20, None, 1),      # start not a multiple of ps, GQA group 1
    (41, 20, None, 4),      # the same, group 4
    (70, 24, 30, 4),        # a window over history and chunk
    (16, 13, None, 1),      # one whole page, ragged chunk
])
def test_tile_arithmetic_matches_pallas(start, s, window, g):
    rng = np.random.default_rng(start + s + g)
    h = HKV * g
    kc, vc = (rng.integers(0, 256, (P, HKV, D // 2, PS)).astype(np.uint8)
              for _ in range(2))
    ksz, vsz = (_bf16(np.stack([rng.uniform(0.01, 0.3, (P, HKV, PS)),
                                rng.integers(0, 16, (P, HKV, PS))], axis=2
                               ).astype(np.float32)) for _ in range(2))
    table = np.zeros((2, MP), np.int32)
    table[0] = 1 + rng.permutation(P - 1)[:MP]
    q, k, v = (_bf16(rng.normal(0, 1, (s, hh, D)).astype(np.float32))
               for hh in (h, HKV, HKV))
    cache = jkv.PagedKVCache(
        k_codes=jnp.asarray(kc), v_codes=jnp.asarray(vc),
        k_sz=jnp.asarray(ksz, jnp.bfloat16), v_sz=jnp.asarray(vsz, jnp.bfloat16),
        page_table=jnp.asarray(table), lengths=jnp.zeros((2,), jnp.int32), bits=4)
    ref = np.asarray(j_prefill_attn(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), cache, jnp.int32(0), jnp.int32(start),
        sliding_window=window, interpret=True).astype(jnp.float32))
    got = tile_attention(q, k, v, kc, ksz, vc, vsz, table[0], start, window)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))
    assert float(np.mean(got != ref)) <= 5e-4


@pytest.mark.parametrize("qmax", [15, 255])
def test_code_minus_zero_exact_in_bf16(qmax):
    """Every c - z, c and z integers in [0, qmax] (int4 and int8 pages), is
    exact in bf16; and for int4 the kernel's unpack, the bf16 difference of
    128 + c (bits 0x4300 | c) and 128 + z, gives it exactly."""
    c = torch.arange(qmax + 1, dtype=torch.float32)[:, None]
    z = torch.arange(qmax + 1, dtype=torch.float32)[None, :]
    diff = c - z
    assert torch.equal(diff.to(torch.bfloat16).float(), diff)
    if qmax == 15:
        bits = (0x4300 | torch.arange(16, dtype=torch.int16)).view(torch.bfloat16)
        assert torch.equal(bits.float(), 128.0 + c[:, 0])
        zz = (128.0 + z).to(torch.bfloat16)
        assert torch.equal((bits[:, None] - zz).float(), diff)
