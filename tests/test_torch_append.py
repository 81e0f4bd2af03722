"""Port parity: the whole KV append (``kv_cache.append_kv``: K's RoPE on the
decode path, ``kv_quantize`` of K and V, the slot index, the stores and the
``lengths`` max, which Kernel D computes in one launch on the card) held
against the JAX package's jitted ``kv_cache.append_kv`` on the CPU, where
the port runs its plain version.

Tolerances:
  * codes, the [scale, zero] pairs (compared as int16 bits, so a -0.0
    zero point counts) and ``lengths``: bit-exact, on every page but the
    scratch page (page 0), where rows parked by the engine share targets
    and nothing reads the contents.
  * K's RoPE: the JAX CPU program contracts ``x * cos + rot(x) * sin``
    into an FMA (``fma(x, cos, rot * sin)``, one rounding), the port rounds
    each product (as its kernel does); the rotated K agrees bit for bit
    but on about 2 elements in 10^5, each one bf16 step off and equal to
    the FMA form (ROADMAP 3.2).  So the decode form holds the port's
    pages bit-exact against the JAX program exactly as its runner calls
    it (``_rope1`` then ``append_kv``) on every (token, head) whose
    rotated K agrees, and against JAX's ``append_kv`` of the port's
    rotated K on every one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.models.common import rope_inv_freq as j_inv_freq
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve.runner import _rope1 as j_rope1
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve.append_kernel import append_kv_quant

P, HKV, D, PS, SEQS, MP = 28, 2, 64, 16, 6, 4
SCRATCH = SEQS                      # the engine's scratch row: page 0
LLAMA3 = ("llama3", 8.0, 1.0, 4.0, 8192)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _caches(rng, bits):
    """Random page contents (so untouched columns are checked too), a
    shuffled table with the scratch row on page 0, random lengths; bf16
    pages (bits 16) hold random normal values."""
    dq = D // 2 if bits == 4 else D
    if bits == 16:
        kc, vc = (jnp.asarray(rng.normal(0, 1, (P, HKV, dq, PS)), jnp.bfloat16)
                  for _ in range(2))
    else:
        kc, vc = (rng.integers(0, 256, (P, HKV, dq, PS)).astype(np.uint8)
                  for _ in range(2))
    ksz, vsz = (np.stack([rng.uniform(0.01, 0.3, (P, HKV, PS)),
                          rng.integers(0, 2 ** bits, (P, HKV, PS))], axis=2
                         ).astype(np.float32) for _ in range(2))
    table = np.zeros((SEQS + 1, MP), np.int32)
    table[:SEQS] = 1 + rng.permutation(P - 1)[:SEQS * MP].reshape(SEQS, MP)
    lengths = rng.integers(0, 40, SEQS + 1).astype(np.int32)
    jks, jvs = jnp.asarray(ksz, jnp.bfloat16), jnp.asarray(vsz, jnp.bfloat16)
    jc = jkv.PagedKVCache(
        k_codes=jnp.asarray(kc), v_codes=jnp.asarray(vc), k_sz=jks, v_sz=jvs,
        page_table=jnp.asarray(table), lengths=jnp.asarray(lengths), bits=bits)
    codes = ((_bf16(kc), _bf16(vc)) if bits == 16 else
             (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())))
    tc = tkv.PagedKVCache(
        k_codes=codes[0], v_codes=codes[1],
        k_sz=_bf16(jks), v_sz=_bf16(jvs), page_table=torch.from_numpy(table.copy()),
        lengths=torch.from_numpy(lengths.copy()), bits=bits)
    return jc, tc


def _bf16(j) -> torch.Tensor:
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _kv(rng, t):
    """K and V (T, HKV, D) bf16 on both sides; every third row lies wholly
    above zero, so its zero point rounds from a negative ratio to 0."""
    out = []
    for _ in range(2):
        x = rng.normal(0, 2, (t, HKV, D)).astype(np.float32)
        x[::3, 0] = np.abs(x[::3, 0]) + 0.01
        j = jnp.asarray(x, jnp.bfloat16)
        out.append((j, _bf16(j)))
    return out


def _pages(c):
    """The page arrays as numpy: codes u8 (bf16 pages, and sz, as int16
    bits); lengths."""
    arrays = [c.k_codes, c.v_codes, c.k_sz, c.v_sz]
    if isinstance(c, tkv.PagedKVCache):
        return ([a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
                 else a.numpy() for a in arrays], c.lengths.numpy())
    return ([np.asarray(a).view(np.int16) if a.dtype == jnp.bfloat16
             else np.asarray(a) for a in arrays], np.asarray(c.lengths))


def _assert_pages_equal(tc, jc, skip=None):
    """Every page array bit for bit, but page 0 and the (page, head, col)
    targets in ``skip`` (K's arrays only)."""
    (tp, tl), (jp, jl) = _pages(tc), _pages(jc)
    np.testing.assert_array_equal(tl, jl, err_msg="lengths")
    for i, (name, g, r) in enumerate(zip(("k_codes", "v_codes", "k_sz", "v_sz"),
                                         tp, jp)):
        keep = np.ones(g.shape, bool)
        keep[0] = False
        for page, head, col in (skip or []) if i in (0, 2) else []:
            keep[page, head, :, col] = False
        np.testing.assert_array_equal(g[keep], r[keep], err_msg=name)


def _tables(pos):
    """cos / sin (T, D) f32 of Llama-3.1's scaled RoPE at ``pos``."""
    inv = np.asarray(j_inv_freq(D, 500000.0, LLAMA3))
    ang = pos.astype(np.float32)[:, None] * inv[None, :]
    ang = np.concatenate([ang, ang], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_decode_append_matches_jax_runner(rng, bits):
    """The decode form: one token per sequence on its own page, plus two
    rows parked on the scratch row (page 0), K rotated inside the append
    as the JAX runner's ``_rope1`` + ``append_kv`` program does; bf16
    pages (bits 16) store the rotated values and [1, 0]."""
    jc, tc = _caches(rng, bits)
    seq = np.array(list(range(SEQS)) + [SCRATCH, SCRATCH], np.int32)
    pos = np.concatenate([rng.integers(0, MP * PS, SEQS), [0, 0]]).astype(np.int32)
    (jk, tk), (jv, tv) = _kv(rng, len(seq))
    cos, sin = _tables(pos)

    @jax.jit
    def runner_append(c, s, p, k, v, cs, sn):
        return jkv.append_kv(c, s, p, j_rope1(k, cs, sn), v, distinct_pages=True)

    jref = runner_append(jc, jnp.asarray(seq), jnp.asarray(pos), jk, jv,
                         jnp.asarray(cos), jnp.asarray(sin))
    tcos, tsin = torch.from_numpy(cos), torch.from_numpy(sin)
    kr = tkv.rope_rows(tk, tcos, tsin)
    kr_j = np.asarray(jax.jit(j_rope1)(jk, jnp.asarray(cos), jnp.asarray(sin))
                      .astype(jnp.float32))
    jref_kr = jax.jit(jkv.append_kv)(jc, jnp.asarray(seq), jnp.asarray(pos),
                                     jnp.asarray(kr.float().numpy(), jnp.bfloat16), jv)
    got = tkv.append_kv(tc, torch.from_numpy(seq), torch.from_numpy(pos), tk, tv,
                        rope=(tcos, tsin))
    assert got is tc                                   # in place
    off = kr.float().numpy() != kr_j
    step = 2.0 ** (np.floor(np.log2(np.abs(kr_j[off]))) - 7)
    assert (np.abs(kr.float().numpy()[off] - kr_j[off]) <= step).all()
    skip = [(int(np.asarray(jc.page_table)[seq[t], pos[t] // PS]), h, pos[t] % PS)
            for t, h in zip(*np.nonzero(off.any(-1)))]
    _assert_pages_equal(tc, jref, skip)
    _assert_pages_equal(tc, jref_kr)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_prefill_append_matches_jax(rng, bits):
    """The prefill form (K already rotated): a 40-token run of one sequence
    from position 5, across two page boundaries, and a 24-token run of
    another from position 0; lengths below and above the new ones."""
    jc, tc = _caches(rng, bits)
    seq = np.array([1] * 40 + [3] * 24, np.int32)
    pos = np.concatenate([np.arange(5, 45), np.arange(24)]).astype(np.int32)
    (jk, tk), (jv, tv) = _kv(rng, len(seq))
    jref = jax.jit(jkv.append_kv)(jc, jnp.asarray(seq), jnp.asarray(pos), jk, jv)
    tkv.append_kv(tc, torch.from_numpy(seq), torch.from_numpy(pos), tk, tv)
    _assert_pages_equal(tc, jref)
    assert tc.lengths[1] == max(45, int(np.asarray(jc.lengths)[1]))


def test_rope_rows_against_jax_rope1(rng):
    """The port's K rotation against JAX's jitted ``_rope1`` at Llama
    widths: equal but where the JAX CPU program's FMA rounds once, and
    there one bf16 step apart and equal to that FMA form."""
    t, h, d = 32, 8, 128
    inv = np.asarray(j_inv_freq(d, 500000.0, LLAMA3))
    n_off = 0
    for _ in range(4):
        x = jnp.asarray(rng.normal(0, 3, (t, h, d)), jnp.bfloat16)
        ang = rng.integers(0, 8192, t).astype(np.float32)[:, None] * inv[None, :]
        ang = np.concatenate([ang, ang], axis=-1)
        cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
        ref = np.asarray(jax.jit(j_rope1)(x, jnp.asarray(cos), jnp.asarray(sin))
                         .astype(jnp.float32))
        got = tkv.rope_rows(_bf16(x), torch.from_numpy(cos),
                            torch.from_numpy(sin)).float().numpy()
        xf = np.array(x.astype(jnp.float32), np.float64)
        rot = np.concatenate([-xf[..., d // 2:], xf[..., :d // 2]], axis=-1)
        prod = (rot * sin[:, None, :]).astype(np.float32).astype(np.float64)
        # x * cos is exact in f64 (8 x 24 bits); the sum, rounded once
        fma = np.asarray(jnp.asarray((xf * cos[:, None, :] + prod).astype(np.float32),
                                     jnp.bfloat16).astype(jnp.float32))
        off = got != ref
        n_off += int(off.sum())
        np.testing.assert_array_equal(ref[off], fma[off])
        step = 2.0 ** (np.floor(np.log2(np.abs(ref[off]))) - 7)
        assert (np.abs(got[off] - ref[off]) <= step).all()
    assert n_off <= 1e-4 * 4 * t * h * d


def test_append_refusals(rng):
    """The wrapper refuses what it cannot take instead of converting it:
    k/v not bf16, wrong shapes, RoPE tables not f32 (T, D), a token outside
    the page table or on a page id outside the pages; and the card's
    launch refuses CPU tensors."""
    _, tc = _caches(rng, 4)
    seq = torch.tensor([0, 1], dtype=torch.int32)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    k = torch.zeros((2, HKV, D), dtype=torch.bfloat16)
    cos = torch.ones((2, D))
    with pytest.raises(ValueError):
        tkv.append_kv(tc, seq, pos, k.float(), k)
    with pytest.raises(ValueError):
        tkv.append_kv(tc, seq, pos, k[:, :1], k[:, :1])
    with pytest.raises(ValueError):
        tkv.append_kv(tc, seq, pos, k, k, rope=(cos.double(), cos.double()))
    with pytest.raises(ValueError):                    # past the table's pages
        tkv.append_kv(tc, seq, torch.tensor([3, MP * PS], dtype=torch.int32), k, k)
    with pytest.raises(ValueError):                    # no such sequence row
        tkv.append_kv(tc, torch.tensor([0, SEQS + 1], dtype=torch.int32), pos, k, k)
    tc.page_table[1, 0] = P                            # a page id past the pages
    with pytest.raises(ValueError):
        tkv.append_kv(tc, seq, pos, k, k)
    with pytest.raises(ValueError):
        append_kv_quant(tc.k_codes, tc.v_codes, tc.k_sz, tc.v_sz, tc.page_table,
                        tc.lengths, seq, pos, k, k, 4, tkv._F32_RECIP[4])
