"""Port parity at every head dim and GQA group the card's attention and
KV-cache kernels take (``kernels/limits.py``): the plain versions of
Kernels E (flash attention), C (paged decode), H (paged prefill) and D
(the KV append) against the JAX package's functions on the CPU, its
Pallas kernels in interpret mode; then the default engine on a 2-layer
random Llama with D = 96 and 16 query heads over one KV head against the
JAX engine.

Each (D, G) case pairs one head dim with one group, so the seven cases
cover D in {32, 80, 96, 100, 112, 192, 256} and G in {1, 8, 12, 16, 32,
64}; page widths, windows and the ``lengths`` override vary across them.

Tolerances (restated from tests/test_torch_attention.py and
tests/test_torch_prefill.py, with their reasons):
  * attention outputs: both sides compute in f32 and round once to bf16,
    with sums in another order: |diff| <= 2^-7 |ref| + 2^-8 max|ref|;
  * the decode state (m, den): m is the max of the same f32 dot products
    summed in another order, |diff| <= 2^-16 max(1, |m|); den sums the
    exponentials of scores that differ by that much: rtol 2^-12;
  * KV codes, [scale, zero] (compared as int16 bits), page tables and
    lengths after an append: bit-exact against the JAX append under
    ``jax.jit``, as the JAX runner calls it;
  * the engine: equal greedy tokens; a fresh chunk's and a decode step's
    logits, each from one cache state, within 2% of their range (f32 sums
    in another order, one bf16 rounding at the same points).
"""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.kernels.flash_attention import flash_attention as j_flash
from micromix_tpu.models import ModelConfig as JModelConfig
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.models.common import rope_inv_freq as j_inv_freq
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu.serve.attention import paged_decode_attention as j_decode
from micromix_tpu.serve.prefill_attention import \
    paged_prefill_attention as j_prefill
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.kernels.flash_attention import flash_attention
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve.attention import paged_decode_attention
from micromix_tpu_torch.serve.prefill_attention import paged_prefill_attention

P, PS, SEQS, MP = 10, 16, 3, 3
# (D, G, KV heads, page bits, window, lengths override with state)
CASES = [(32, 1, 2, 4, None, False), (80, 12, 1, 8, 20, False),
         (96, 16, 1, 4, None, True), (100, 32, 1, 16, None, False),
         (112, 64, 1, 4, 20, False), (192, 16, 1, 8, None, True),
         (256, 8, 1, 16, 20, True)]
SCALING = ("llama3", 8.0, 1.0, 4.0, 8192)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()),
                               err_msg=what)


def _caches(rng, d, hkv, bits):
    """The same random pages as a JAX and a port cache: codes and integer
    zero points (bf16 pages: normal values), row r's table a slice of a
    permutation of pages 1..P-1; lengths 5, 22 and 48."""
    dq = d // 2 if bits == 4 else d
    if bits == 16:
        kc, vc = (_bf16_pair(rng.normal(0, 1, (P, hkv, dq, PS)).astype(np.float32))
                  for _ in range(2))
    else:
        kc, vc = ((jnp.asarray(a), torch.from_numpy(a.copy())) for a in (
            rng.integers(0, 256, (P, hkv, dq, PS)).astype(np.uint8)
            for _ in range(2)))
    qmax = 15 if bits == 4 else 255
    ksz, vsz = (np.stack([rng.uniform(0.01, 0.3, (P, hkv, PS)),
                          rng.integers(0, qmax + 1, (P, hkv, PS))], axis=2
                         ).astype(np.float32) for _ in range(2))
    table = (1 + rng.permutation(P - 1)[:SEQS * MP]).reshape(SEQS, MP).astype(np.int32)
    lengths = np.array([5, 22, 48], np.int32)
    jc = jkv.PagedKVCache(
        k_codes=kc[0], v_codes=vc[0],
        k_sz=jnp.asarray(ksz, jnp.bfloat16), v_sz=jnp.asarray(vsz, jnp.bfloat16),
        page_table=jnp.asarray(table), lengths=jnp.asarray(lengths), bits=bits)
    tc = tkv.PagedKVCache(
        k_codes=kc[1], v_codes=vc[1], k_sz=_bf16_pair(ksz)[1],
        v_sz=_bf16_pair(vsz)[1], page_table=torch.from_numpy(table.copy()),
        lengths=torch.from_numpy(lengths.copy()), bits=bits)
    return jc, tc


def test_attention_every_head_dim_and_group():
    """E, C and H's plain versions against JAX's Pallas functions at each
    (D, G) of ``CASES``: flash attention over a ragged 40-token sequence
    with the case's window; decode with fused llama3 RoPE over int4, int8
    or bf16 pages, the window, and on three cases the ``lengths``
    override (rows of one sequence at successive positions) with the (m,
    den) state; prefill of a 13-token chunk over 35 history positions."""
    for d, g, hkv, bits, window, override in CASES:
        rng = np.random.default_rng(d + g)
        h = g * hkv
        what = f"D={d} G={g} bits={bits} window={window}"
        # E: (B, S, H, D)
        q, k, v = (rng.normal(0, 1, (1, 40, hh, d)).astype(np.float32)
                   for hh in (h, hkv, hkv))
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(a) for a in (q, k, v))
        ref = _f32(j_flash(jq, jk, jv, sliding_window=window, interpret=True))
        _close(_f32(flash_attention(tq, tk, tv, sliding_window=window)), ref,
               f"flash {what}")
        # C
        jc, tc = _caches(rng, d, hkv, bits)
        if override:
            seq = np.array([2, 2, 2], np.int32)
            lengths = np.array([46, 47, 48], np.int32)
            pos = lengths - 1
        else:
            seq, lengths = np.array([0, 1, 2], np.int32), None
            pos = np.array([4, 23, 47], np.int32)
        inv = np.asarray(j_inv_freq(d, 500000.0, SCALING))
        jq, tq = _bf16_pair(rng.normal(0, 1, (3, h, d)).astype(np.float32))
        jkw = dict(sliding_window=window, rope_positions=jnp.asarray(pos),
                   rope_inv_freq=jnp.asarray(inv), with_state=override)
        tkw = dict(sliding_window=window, rope_positions=torch.from_numpy(pos),
                   rope_inv_freq=torch.from_numpy(inv), with_state=override)
        if override:
            jkw["lengths"], tkw["lengths"] = (jnp.asarray(lengths),
                                              torch.from_numpy(lengths))
        ref = j_decode(jq, jc, jnp.asarray(seq), interpret=True, **jkw)
        got = paged_decode_attention(tq, tc, torch.from_numpy(seq), **tkw)
        if not override:
            ref, got = (ref,), (got,)
        _close(_f32(got[0]), _f32(ref[0]), f"decode {what}")
        if override:
            (gm, gd), (rm, rd) = ((_f32(t) for t in x[1:]) for x in (got, ref))
            np.testing.assert_allclose(
                gm, rm, rtol=0, atol=2.0 ** -16 * max(1.0, np.abs(rm).max()),
                err_msg=f"decode m {what}")
            np.testing.assert_allclose(gd, rd, rtol=2.0 ** -12,
                                       err_msg=f"decode den {what}")
        # H: a chunk of 13 at position 35 of sequence 2 (48 stored tokens;
        # history is what lies below 35)
        s, start = 13, 35
        (jq, tq), (jk, tk), (jv, tv) = (
            _bf16_pair(rng.normal(0, 1, (s, hh, d)).astype(np.float32))
            for hh in (h, hkv, hkv))
        ref = _f32(j_prefill(jq, jk, jv, jc, jnp.int32(2), jnp.int32(start),
                             sliding_window=window, interpret=True))
        got = _f32(paged_prefill_attention(tq, tk, tv, tc, 2, start,
                                           sliding_window=window))
        _close(got, ref, f"prefill {what}")


def _pages(c):
    out = {}
    for name in ("k_codes", "v_codes", "k_sz", "v_sz", "page_table", "lengths"):
        a = getattr(c, name)
        if isinstance(a, torch.Tensor):
            a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
            out[name] = a.numpy().astype(np.int64)
        else:
            a = np.asarray(a)
            out[name] = (a.view(np.int16) if a.dtype.name == "bfloat16" else a
                         ).astype(np.int64)
    return out


def test_append_every_head_dim_bit_exact():
    """D's function (``kv_cache.append_kv``: ``kv_quantize`` over the
    whole D, int4 pairing dims i and i + D/2, the stores and the lengths)
    at each D of ``CASES`` on int4 pages, and at D = 100 and 256 (D/2 not
    a multiple of 32, and the widest) on int8 and bf16 pages: a decode-sized
    append (one token per sequence) and a prefill-sized one (20 tokens
    of one sequence across pages), every page array bit-exact against
    JAX's jitted ``append_kv``; ``kv_quantize``'s codes, scale and zero
    bit-exact too, a zero row among them."""
    j_append = jax.jit(jkv.append_kv)
    for d, _, hkv, _, _, _ in CASES:
        for bits in (4, 8, 16) if d in (100, 256) else (4,):
            rng = np.random.default_rng(d * bits)
            jc, tc = _caches(rng, d, hkv, bits)
            tc.lengths.zero_()
            jc = dataclasses.replace(jc, lengths=jnp.zeros((SEQS,), jnp.int32))
            x = rng.normal(0, 3, (5, hkv, d)).astype(np.float32)
            x[0, 0] = 0.0
            jx, tx = _bf16_pair(x)
            if bits != 16:
                for r, g in zip(jax.jit(lambda a, b=bits: jkv.kv_quantize(a, b))(jx),
                                tkv.kv_quantize(tx, bits)):
                    np.testing.assert_array_equal(_f32(g), _f32(r),
                                                  err_msg=f"kv_quantize D={d}")
            for seq, pos in ((np.array([0, 1, 2], np.int32),
                              np.array([3, 17, 40], np.int32)),
                             (np.full(20, 1, np.int32),
                              np.arange(20, dtype=np.int32) + 9)):
                t = len(seq)
                (jk, tk), (jv, tv) = (
                    _bf16_pair(rng.normal(0, 1, (t, hkv, d)).astype(np.float32))
                    for _ in range(2))
                jc = j_append(jc, jnp.asarray(seq), jnp.asarray(pos), jk, jv)
                tkv.append_kv(tc, torch.from_numpy(seq), torch.from_numpy(pos),
                              tk, tv)
                want, have = _pages(jc), _pages(tc)
                for name in want:
                    np.testing.assert_array_equal(
                        have[name], want[name],
                        err_msg=f"{name} D={d} bits={bits} T={t}")


# a 2-layer random Llama at head_dim 96 with 16 query heads over 1 KV head
D96_G16 = dict(arch="llama", vocab_size=256, hidden_size=1536,
               intermediate_size=1536, num_layers=2, num_heads=16,
               num_kv_heads=1, head_dim=96, rope_theta=500000.0, rms_eps=1e-5)
ENGINE = dict(max_seqs=2, page_size=16, max_pages_per_seq=4,
              prefill_buckets=(16,), decode_chunk=4, seed=0)


@pytest.fixture
def jax_tpu_runner(monkeypatch):
    """The JAX runner on its TPU branches (its paged prefill kernel over a
    chunk's history, in interpret mode), as tests/test_torch_prefill.py
    points it; its residual pair held off (the port pairs: 1536 is a
    multiple of 512)."""
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jrunner, "jax", proxy)
    monkeypatch.setattr(jrunner, "_can_pair", lambda *a: False)


def test_engine_d96_g16_matches_jax(jax_tpu_runner):
    """The port's default engine (stacked, paired, pipelined, chunked
    prefill over paged history) on the D = 96, G = 16 Llama against the
    JAX engine's defaults, both on the JAX package's quantized model
    (all-MXFP4 sites, so GEMM sums are exact in f32): three requests over
    two slots (prompts of 10, 21 and 32 tokens: one chunk, two, and two
    with the second over history), 8 new tokens each, greedy tokens
    equal; then one decode step's logits, both runners from the same
    prefilled cache state, within 2% of their range."""
    jcfg = JModelConfig(**D96_G16)
    tcfg = ModelConfig(**D96_G16)
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=5), jcfg,
        jsurg.default_calibration(jcfg, seed=1), host=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (10, 21, 32)]
    jreqs = jengine.Engine(jparams, jcfg, **ENGINE).run(
        [jengine.Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    teng = tengine.Engine(tparams, tcfg, device="cpu", **ENGINE)
    treqs = teng.run([tengine.Request(i, p, max_new_tokens=8)
                      for i, p in enumerate(prompts)])
    assert teng.block_manager.is_native
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.output) == 8
        assert tr.output == jr.output
    # the logits of each unit (two prefill chunks of 16, the second over
    # paged history, then a decode step), both runners from the JAX
    # runner's cache state: a K code that JAX's FMA-contracted CPU RoPE
    # rounds the other way moves later MXFP4 site codes, so states carried
    # apart are not compared.  Greedy tokens equal in every unit; logits
    # within 2% of their range in the fresh chunk and the decode step
    # (measured 1.2e-7 and 2.2e-7).  The chunk over history is held to its
    # token alone: its attention (H's plain version against JAX's Pallas
    # kernel, within the band of the test above) moves a few MXFP4 site
    # codes one grid step, and 2 random layers spread that to 13% of the
    # range (measured; at D = 128 a decode step from one state spreads to
    # 28% the same way, at D = 64 none)
    from micromix_tpu_torch.serve import runner as trunner
    prompt = np.array([prompts[2]], np.int32)
    jcaches = [jkv.make_cache(5, 16, 1, 96, 2, 4, bits=4) for _ in range(2)]
    jcaches = [dataclasses.replace(c, page_table=c.page_table.at[0].set(
        jnp.arange(1, 5, dtype=jnp.int32))) for c in jcaches]
    tcaches = [tkv.make_cache(5, 16, 1, 96, 2, 4, bits=4, device="cpu")
               for _ in range(2)]

    def from_jax(tcs, jcs):
        for t, j in zip(tcs, jcs):
            for name in ("k_codes", "v_codes", "k_sz", "v_sz", "page_table",
                         "lengths"):
                a, dst = np.asarray(getattr(j, name)), getattr(t, name)
                src = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                       if dst.dtype == torch.bfloat16 else torch.from_numpy(a.copy()))
                dst.copy_(src)

    units = [(jrunner.prefill, trunner.prefill,
              (prompt[:, s0:s0 + 16], 0, s0), dict(hist_len=s0), s0 == 0)
             for s0 in (0, 16)]
    units.append((jrunner.decode_step, trunner.decode_step,
                  (prompt[:, -1], np.zeros(1, np.int32), np.array([32], np.int32)),
                  {}, True))
    for jfn, tfn, args, kw, band in units:
        from_jax(tcaches, jcaches)
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
                 for a in args]
        ref, jcaches = jfn(jparams, jcfg, jcaches, *jargs, **kw)
        got, _ = tfn(tparams, tcfg, tcaches, *targs, **kw)
        ref, got = _f32(ref), _f32(got)
        if band:
            assert np.abs(got - ref).max() / np.abs(ref).max() < 0.02, jfn.__name__
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
