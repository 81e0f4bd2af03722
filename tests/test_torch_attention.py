"""Port parity: prefill flash attention (Kernel E's function), the paged
int4 KV cache, its append (Kernel D's function) and paged decode
attention (Kernel C's function), held against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port's
wrappers get CPU tensors and run their plain versions.

Tolerances:
  * kv_quantize codes / scale / zero and the page arrays after an
    append: bit-exact (==) against the JAX functions under ``jax.jit``,
    as the JAX runner always calls them.  (Under jit XLA folds
    ``/ qmax`` into a multiply by the f32 reciprocal, which the port
    mirrors; run op by op, JAX divides and differs from its own jitted
    program on about 1 code in 10^4.)
  * attention outputs: both sides compute in f32 and round once to bf16,
    with sums in another order: |diff| <= 2^-7 |ref| + 2^-8 max|ref|.
  * the decode state (m, den) against the Pallas kernel's: m is the max
    of the same f32 dot products summed in another order, |diff| <=
    2^-16 max(1, |m|) (some 2^7 f32 ulps); den sums the exponentials of
    scores that differ by that much, in another order: rtol 2^-12.
  * a row with nothing to attend (empty, or wholly below its window)
    gives 0 and the state (-1e30, 0) exactly.  The Pallas kernel agrees
    for an empty row; a row whose window lies wholly above its stored
    length it scores over masked tokens (p = 1 each), so no case here
    has one.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.kernels.flash_attention import flash_attention_hsd as j_flash_hsd
from micromix_tpu.models.common import rope_inv_freq as j_inv_freq
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve.append_kernel import append_kv_kernel as j_append_kernel
from micromix_tpu.serve.attention import paged_decode_attention as j_decode
from micromix_tpu.serve.attention import paged_decode_attention_xla as j_decode_xla
from micromix_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_hsd)
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve.append_kernel import append_kv_kernel
from micromix_tpu_torch.serve.attention import (
    DECODE_BLOCKS, DECODE_MAX_SPLITS, decode_split, paged_decode_attention,
    paged_decode_attention_plain, rotate_q)

P, HKV, D, PS, SEQS, MP = 20, 2, 64, 16, 4, 4


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))


def _within(got, ref) -> bool:
    return bool((np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref)
                 + 2.0 ** -8 * float(np.abs(ref).max())).all())


def _inv_freq():
    return np.asarray(j_inv_freq(D, 500000.0, ("llama3", 8.0, 1.0, 4.0, 8192)))


@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_matches_pallas(rng, window):
    b, s, h = 2, 70, 4                          # ragged S, GQA group 2
    q, k, v = (rng.normal(0, 1, (b, s, hh, D)).astype(np.float32)
               for hh in (h, HKV, HKV))
    (jq, tq), (jk, tk), (jv, tv) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    ref = _f32(j_flash(jq, jk, jv, sliding_window=window, interpret=True))
    _close(_f32(flash_attention(tq, tk, tv, sliding_window=window)), ref)


@pytest.mark.parametrize("d,window", [(64, None), (64, 20), (128, None),
                                      (128, 20)])
def test_flash_attention_hsd_matches_pallas(rng, d, window):
    """The single-sequence (H, S, D) entry point against the JAX one, in
    the attention tolerance above."""
    s, h, hkv = 45, 4, 2                        # ragged S, GQA group 2
    q, k, v = (rng.normal(0, 1, (hh, s, d)).astype(np.float32)
               for hh in (h, hkv, hkv))
    (jq, tq), (jk, tk), (jv, tv) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    ref = _f32(j_flash_hsd(jq, jk, jv, sliding_window=window, interpret=True))
    got = flash_attention_hsd(tq, tk, tv, sliding_window=window)
    assert got.shape == (h, s, d) and got.dtype == torch.bfloat16
    _close(_f32(got), ref)


def test_kv_quantize_bit_exact(rng):
    x = rng.normal(0, 3, (5, HKV, D)).astype(np.float32)
    x[0, 0] = 0.0                               # degenerate group
    jx, tx = _bf16_pair(x)
    for bits in (4, 8):
        ref = jax.jit(lambda a, b=bits: jkv.kv_quantize(a, b))(jx)
        got = tkv.kv_quantize(tx, bits)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_f32(g), _f32(r))


def _random_caches(rng, bits=4):
    """The same random page contents as a JAX and a port cache."""
    dq = D // 2 if bits == 4 else D
    kc, vc = (rng.integers(0, 256, (P, HKV, dq, PS)).astype(np.uint8)
              for _ in range(2))
    ksz, vsz = (np.stack([rng.uniform(0.01, 0.3, (P, HKV, PS)),
                          rng.integers(0, 16, (P, HKV, PS))], axis=2
                         ).astype(np.float32) for _ in range(2))
    table = np.zeros((SEQS + 1, MP), np.int32)
    table[:SEQS] = 1 + rng.permutation(P - 1)[:SEQS * MP].reshape(SEQS, MP)
    lengths = np.array([5, 17, 40, 64, 0], np.int32)
    jc = jkv.PagedKVCache(
        k_codes=jnp.asarray(kc), v_codes=jnp.asarray(vc),
        k_sz=jnp.asarray(ksz, jnp.bfloat16), v_sz=jnp.asarray(vsz, jnp.bfloat16),
        page_table=jnp.asarray(table), lengths=jnp.asarray(lengths), bits=bits)
    tc = tkv.PagedKVCache(
        k_codes=torch.from_numpy(kc.copy()), v_codes=torch.from_numpy(vc.copy()),
        k_sz=_bf16_pair(ksz)[1], v_sz=_bf16_pair(vsz)[1],
        page_table=torch.from_numpy(table.copy()),
        lengths=torch.from_numpy(lengths.copy()), bits=bits)
    return jc, tc


def _assert_cache_equal(tc, jc):
    for name in ("k_codes", "v_codes", "k_sz", "v_sz", "page_table", "lengths"):
        np.testing.assert_array_equal(_f32(getattr(tc, name)),
                                      _f32(getattr(jc, name)), err_msg=name)


@pytest.mark.parametrize("t", [3, 40])
def test_append_kv_pages_bit_exact(rng, t):
    """Decode-sized appends (one token per sequence) and a prefill-sized
    append (T > 32, many tokens per page) write identical page arrays."""
    jc, tc = _random_caches(rng)
    if t <= SEQS:
        seq = np.arange(t, dtype=np.int32)
        pos = np.array([5, 17, 40][:t], np.int32)
    else:
        seq = np.full((t,), 2, np.int32)
        pos = np.arange(t, dtype=np.int32) + 3
    k = rng.normal(0, 1, (t, HKV, D)).astype(np.float32)
    v = rng.normal(0, 1, (t, HKV, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _bf16_pair(k), _bf16_pair(v)
    jc = jax.jit(jkv.append_kv)(jc, jnp.asarray(seq), jnp.asarray(pos), jk, jv)
    got = tkv.append_kv(tc, torch.from_numpy(seq), torch.from_numpy(pos), tk, tv)
    assert got is tc                             # in place
    _assert_cache_equal(tc, jc)


def test_append_kernel_matches_pallas(rng):
    jc, tc = _random_caches(rng)
    t = 3
    page_id = np.array([2, 7, 4], np.int32)
    off = np.array([0, 9, 15], np.int32)
    kq, vq = (rng.integers(0, 256, (t, HKV, D // 2)).astype(np.uint8)
              for _ in range(2))
    ksz, vsz = (rng.normal(0, 1, (t, HKV, 2)).astype(np.float32)
                for _ in range(2))
    (jks, tks), (jvs, tvs) = _bf16_pair(ksz), _bf16_pair(vsz)
    outs = j_append_kernel(jc.k_codes, jc.v_codes, jc.k_sz, jc.v_sz,
                           jnp.asarray(page_id), jnp.asarray(off),
                           jnp.asarray(kq), jnp.asarray(vq), jks, jvs,
                           interpret=True)
    append_kv_kernel(tc.k_codes, tc.v_codes, tc.k_sz, tc.v_sz,
                     torch.from_numpy(page_id), torch.from_numpy(off),
                     torch.from_numpy(kq), torch.from_numpy(vq), tks, tvs)
    for got, ref in zip((tc.k_codes, tc.v_codes, tc.k_sz, tc.v_sz), outs):
        np.testing.assert_array_equal(_f32(got), _f32(ref))


def test_gather_kv_bit_exact(rng):
    jc, tc = _random_caches(rng, bits=8)
    for r, g in zip(jkv.gather_kv(jc, 1, 2 * PS, jnp.float32),
                    tkv.gather_kv(tc, 1, 2 * PS, torch.float32)):
        np.testing.assert_array_equal(_f32(g), _f32(r))


def test_paged_decode_attention_matches_pallas(rng):
    """Fused q-RoPE (llama3-scaled inverse frequencies), GQA group 4,
    every sequence length class: part of a page, exact pages, empty."""
    jc, tc = _random_caches(rng)
    b, h = SEQS + 1, 4 * HKV
    seq = np.array([0, 1, 2, 3, 4], np.int32)
    pos = np.array([4, 16, 39, 63, 0], np.int32)
    q = rng.normal(0, 1, (b, h, D)).astype(np.float32)
    jq, tq = _bf16_pair(q)
    inv = np.asarray(j_inv_freq(D, 500000.0, ("llama3", 8.0, 1.0, 4.0, 8192)))
    ref = _f32(j_decode(jq, jc, jnp.asarray(seq), rope_positions=jnp.asarray(pos),
                        rope_inv_freq=jnp.asarray(inv), interpret=True))
    got = _f32(paged_decode_attention(
        tq, tc, torch.from_numpy(seq), rope_positions=torch.from_numpy(pos),
        rope_inv_freq=torch.from_numpy(inv)))
    _close(got, ref)


@pytest.mark.parametrize("window", [None, 20])
def test_decode_plain_matches_xla_reference(rng, window):
    jc, tc = _random_caches(rng, bits=8)
    seq = np.array([3, 1, 2], np.int32)
    q = rng.normal(0, 1, (3, 2 * HKV, D)).astype(np.float32)
    jq, tq = _bf16_pair(q)
    ref = _f32(j_decode_xla(jq, jc, jnp.asarray(seq), sliding_window=window))
    got = _f32(paged_decode_attention_plain(tq, tc, torch.from_numpy(seq),
                                            sliding_window=window))
    _close(got, ref)


def test_cache_lengths_follow_appends(rng):
    _, tc = _random_caches(rng)
    tc.lengths.zero_()
    k = torch.zeros((2, HKV, D), dtype=torch.bfloat16)
    tkv.append_kv(tc, torch.tensor([1, 1]), torch.tensor([6, 7]), k, k)
    assert tc.lengths.tolist() == [0, 8, 0, 0, 0]
    jc = dataclasses.replace(_random_caches(rng)[0],
                             lengths=jnp.zeros((SEQS + 1,), jnp.int32))
    jc = jkv.append_kv(jc, jnp.asarray([1, 1]), jnp.asarray([6, 7]),
                       jnp.zeros((2, HKV, D), jnp.bfloat16),
                       jnp.zeros((2, HKV, D), jnp.bfloat16))
    assert np.asarray(jc.lengths).tolist() == tc.lengths.tolist()


def test_decode_window_floor_is_the_query_position(rng):
    """With fused RoPE the window floor is positions + 1 - window, as the
    Pallas kernel takes it, not the stored length minus the window: rows
    1-3 sit at positions past their stored lengths (a query ahead of its
    pages), so the two floors differ there, and only the first agrees
    with the Pallas kernel."""
    jc, tc = _random_caches(rng)
    window = 20
    seq = np.array([0, 1, 2, 3], np.int32)            # n = 5, 17, 40, 64
    pos = np.array([10, 30, 45, 70], np.int32)        # floors -9, 11, 26, 51
    q = rng.normal(0, 1, (4, 4 * HKV, D)).astype(np.float32)
    jq, tq = _bf16_pair(q)
    inv = _inv_freq().copy()
    ref = _f32(j_decode(jq, jc, jnp.asarray(seq), sliding_window=window,
                        rope_positions=jnp.asarray(pos),
                        rope_inv_freq=jnp.asarray(inv), interpret=True))
    got = _f32(paged_decode_attention(
        tq, tc, torch.from_numpy(seq), sliding_window=window,
        rope_positions=torch.from_numpy(pos), rope_inv_freq=torch.from_numpy(inv)))
    _close(got, ref)
    # the stored-length floor (n - window), on the same q rotated
    # beforehand, attends more tokens on rows 1-3
    q_rot = rotate_q(tq, torch.from_numpy(pos), torch.from_numpy(inv))
    old = _f32(paged_decode_attention_plain(q_rot.to(torch.bfloat16), tc,
                                            torch.from_numpy(seq), window))
    for r in (1, 2, 3):
        assert not _within(old[r], ref[r]), r


# (bits, window, RoPE fused, lengths override, with_state): each row set
# ends with the empty sequence 4
DECODE_CASES = [(4, None, True, True, True), (4, 20, True, True, True),
                (8, None, True, False, True), (8, 24, True, False, False),
                (4, 20, False, False, True)]


@pytest.mark.parametrize("bits,window,rope,override,state", DECODE_CASES)
def test_decode_full_function_matches_pallas(rng, bits, window, rope,
                                             override, state):
    """The port's decode (plain on the CPU) against the Pallas kernel in
    interpret mode over int4 and int8 pages, a window, the ``lengths``
    override (rows of sequence 3 at successive positions, as speculative
    verify runs them) and the (m, den) state, in the tolerances above."""
    jc, tc = _random_caches(rng, bits=bits)
    if override:
        seq = np.array([3, 3, 3, 3, 4], np.int32)
        lengths = np.array([61, 62, 63, 64, 0], np.int32)
        pos = np.maximum(lengths - 1, 0)
    else:
        seq = np.array([0, 1, 2, 3, 4], np.int32)
        lengths = None
        pos = np.array([4, 16, 39, 63, 0], np.int32)
    q = rng.normal(0, 1, (5, 4 * HKV, D)).astype(np.float32)
    jq, tq = _bf16_pair(q)
    jkw, tkw = dict(sliding_window=window), dict(sliding_window=window)
    if rope:
        inv = _inv_freq()
        jkw.update(rope_positions=jnp.asarray(pos), rope_inv_freq=jnp.asarray(inv))
        tkw.update(rope_positions=torch.from_numpy(pos),
                   rope_inv_freq=torch.from_numpy(inv))
    if override:
        jkw["lengths"] = jnp.asarray(lengths)
        tkw["lengths"] = torch.from_numpy(lengths)
    ref = j_decode(jq, jc, jnp.asarray(seq), with_state=state,
                   interpret=True, **jkw)
    got = paged_decode_attention(tq, tc, torch.from_numpy(seq),
                                 with_state=state, **tkw)
    if not state:
        ref, got = (ref,), (got,)
    _close(_f32(got[0]), _f32(ref[0]))
    assert not _f32(got[0])[4].any()                  # the empty row
    if state:
        (gm, gd), (rm, rd) = (_f32(t) for t in got[1:]), (_f32(t) for t in ref[1:])
        np.testing.assert_allclose(gm, rm, rtol=0,
                                   atol=2.0 ** -16 * max(1.0, np.abs(rm[:4]).max()))
        np.testing.assert_allclose(gd, rd, rtol=2.0 ** -12)
        assert (gm[4] == -1e30).all() and (gd[4] == 0).all()


def test_decode_grid_depends_on_shapes_only():
    """The split-KV grid (Hkv, B, splits) comes from B, Hkv and
    max_pages_per_seq: every page in exactly one split, at most
    ``DECODE_MAX_SPLITS`` splits, the block count near ``DECODE_BLOCKS``
    once there are pages enough."""
    for b, hkv, mp in ((8, 8, 5), (8, 8, 32), (1, 8, 64), (8, 8, 16),
                       (4, 2, 4), (64, 8, 64), (1, 1, 1), (1, 1, 1000)):
        splits, pps = decode_split(b, hkv, mp)
        assert (splits - 1) * pps < mp <= splits * pps
        assert splits <= DECODE_MAX_SPLITS
        assert b * hkv * splits <= max(DECODE_BLOCKS, b * hkv) * 2
    assert decode_split(8, 8, 32) == (8, 4)
    assert decode_split(1, 8, 64) == (32, 2)
