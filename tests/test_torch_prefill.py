"""Port parity for chunked prefill: paged prefill attention (Kernel H's
function), a chunked ``prefill`` + ``decode_multi``, and the default
``Engine`` (stacked params, paired decode, chunked prefill, piggyback,
preemption), held against the JAX package on the CPU.

On the CPU the JAX runner takes ``gather_kv`` plus XLA attention for a
chunk with history (which rounds probabilities to bf16) and XLA attention
for a fresh chunk; on the TPU it runs its paged prefill and flash kernels,
which the port mirrors.  The fixture ``jax_tpu_runner`` points the JAX
runner at its TPU branches: its module-level ``jax`` becomes a proxy whose
``default_backend()`` says "tpu" and which forwards every other name to
``jax``; the Pallas wrappers read the real backend and run in interpret
mode.  The proxy would also open the JAX pair gate, so ``_can_pair`` is
held false there, as the JAX package's own tests patch it: the JAX side
decodes stacked but unpaired, the port paired.

Tolerances:
  * paged prefill attention: f32 on both sides, sums in another order,
    one bf16 rounding: |diff| <= 2^-7 |ref| + 2^-8 max|ref|;
  * prefill, decode and engine: equal greedy tokens (the paired decode
    sits within the JAX package's pair-vs-unfused band, which
    tests/test_torch_stack.py holds at the logits).
"""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from __graft_entry__ import _llama_cfg
from micromix_tpu.models import surgery as jsurg
from micromix_tpu.serve import engine as jengine
from micromix_tpu.serve import kv_cache as jkv
from micromix_tpu.serve import runner as jrunner
from micromix_tpu.serve.prefill_attention import \
    paged_prefill_attention as j_prefill_attn
from micromix_tpu_torch.convert import from_jax_params
from micromix_tpu_torch.models import surgery as tsurg
from micromix_tpu_torch.models.common import ModelConfig
from micromix_tpu_torch.serve import engine as tengine
from micromix_tpu_torch.serve import kv_cache as tkv
from micromix_tpu_torch.serve import runner as trunner
from micromix_tpu_torch.serve.prefill_attention import paged_prefill_attention

PS, HKV, D, P, MP = 16, 2, 64, 12, 4


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


@pytest.fixture
def jax_tpu_runner(monkeypatch):
    proxy = types.ModuleType("jax_on_tpu")
    proxy.__getattr__ = lambda name: getattr(jax, name)
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jrunner, "jax", proxy)
    monkeypatch.setattr(jrunner, "_can_pair", lambda *a: False)


@pytest.fixture(scope="module")
def model():
    jcfg = _llama_cfg()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jsurg.quantize_model(
        jsurg.random_dense_params(jcfg, seed=1), jcfg,
        jsurg.default_calibration(jcfg, p6=128, p8=128, seed=1), host=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _random_cache(rng, bits):
    """The same random pages as a JAX and a port cache; row 0's table is a
    permutation of pages 1..MP."""
    dq = D // 2 if bits == 4 else D
    if bits == 16:      # bf16 pages hold the values themselves
        kc, vc = (_bf16_pair(rng.normal(0, 1, (P, HKV, dq, PS)).astype(np.float32))
                  for _ in range(2))
    else:
        kc, vc = ((jnp.asarray(a), torch.from_numpy(a)) for a in (
            rng.integers(0, 256, (P, HKV, dq, PS)).astype(np.uint8)
            for _ in range(2)))
    ksz, vsz = (np.stack([rng.uniform(0.01, 0.3, (P, HKV, PS)),
                          rng.integers(0, 16, (P, HKV, PS))], axis=2
                         ).astype(np.float32) for _ in range(2))
    table = np.zeros((2, MP), np.int32)
    table[0] = 1 + rng.permutation(P - 1)[:MP]
    jc = jkv.PagedKVCache(
        k_codes=kc[0], v_codes=vc[0],
        k_sz=jnp.asarray(ksz, jnp.bfloat16), v_sz=jnp.asarray(vsz, jnp.bfloat16),
        page_table=jnp.asarray(table), lengths=jnp.zeros((2,), jnp.int32),
        bits=bits)
    tc = tkv.PagedKVCache(
        k_codes=kc[1], v_codes=vc[1],
        k_sz=_bf16_pair(ksz)[1], v_sz=_bf16_pair(vsz)[1],
        page_table=torch.from_numpy(table), lengths=torch.zeros(2, dtype=torch.int32),
        bits=bits)
    return jc, tc


@pytest.mark.parametrize("start,s,bits,window", [
    (0, 16, 4, None),       # no history
    (16, 13, 4, None),      # one page, ragged chunk
    (41, 16, 8, 20),        # two pages and a partial one, int8, window
    (41, 21, 4, None),      # a partial page, ragged chunk
    (33, 8, 16, None),      # bf16 pages (the plain version only)
])
def test_paged_prefill_attention_matches_pallas(start, s, bits, window):
    rng = np.random.default_rng(start + s + bits)
    jc, tc = _random_cache(rng, bits)
    h = 2 * HKV                                              # GQA group 2
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16_pair(rng.normal(0, 1, (s, hh, D)).astype(np.float32))
        for hh in (h, HKV, HKV))
    ref = _f32(j_prefill_attn(jq, jk, jv, jc, jnp.int32(0), jnp.int32(start),
                              sliding_window=window, interpret=True))
    got = _f32(paged_prefill_attention(tq, tk, tv, tc, 0, start,
                                       sliding_window=window))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))


def test_chunked_prefill_and_paired_decode_match_jax(model, jax_tpu_runner):
    """A 40-token prompt prefilled in chunks of 16 (flash, then paged
    history twice, the last chunk bucket-padded), then 6 greedy steps."""
    jcfg, tcfg, jparams, tparams = model
    jparams = jsurg.stack_layer_projections(jparams)
    tparams = tsurg.stack_layer_projections(tparams)
    assert trunner._can_pair(tparams, tcfg, 1)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, 40)
    row = np.array([5, 2, 7, 1, 0, 0], np.int32)
    nkv, hd, mp = jcfg.num_kv_heads, jcfg.head_dim, len(row)
    jc = [dataclasses.replace(jkv.make_cache(9, PS, nkv, hd, 2, mp),
                              page_table=jnp.zeros((2, mp), jnp.int32).at[0].set(row))
          for _ in range(jcfg.num_layers)]
    tc = [tkv.make_cache(9, PS, nkv, hd, 2, mp, device="cpu") for _ in range(jcfg.num_layers)]
    for c in tc:
        c.page_table[0] = torch.from_numpy(row)
    jfns = {}
    for start in range(0, 40, 16):
        n = min(16, 40 - start)
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = prompt[start:start + n]
        if start not in jfns:
            jfns[start] = jax.jit(lambda p, c, t, sp, li, h=start: jrunner.prefill(
                p, jcfg, c, t, jnp.int32(0), sp, li, hist_len=h))
        jlog, jc = jfns[start](jparams, jc, jnp.asarray(toks), jnp.int32(start),
                               jnp.int32(n - 1))
        tlog, tc = trunner.prefill(tparams, tcfg, tc, torch.from_numpy(toks), 0,
                                   start, n - 1, hist_len=start)
        jc = [dataclasses.replace(c, lengths=c.lengths.at[0].set(start + n))
              for c in jc]
        for c in tc:
            c.lengths[0] = start + n
    first = int(np.argmax(np.asarray(jlog)[0]))
    assert int(torch.argmax(tlog[0])) == first
    z = np.zeros((1,), np.float32)
    jtoks, _ = jax.jit(lambda p, c: jrunner.decode_multi(
        p, jcfg, c, jnp.asarray([first], jnp.int32), jnp.asarray([0], jnp.int32),
        jnp.asarray([40], jnp.int32), jax.random.PRNGKey(0), jnp.asarray(z),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.float32), n_steps=6,
        sample_mode="greedy"))(jparams, jc)
    ttoks, _ = trunner.decode_multi(
        tparams, tcfg, tc, torch.tensor([first]), torch.tensor([0]),
        torch.tensor([40]), None, torch.from_numpy(z),
        torch.zeros(1, dtype=torch.int32), torch.ones(1), n_steps=6,
        sample_mode="greedy")
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_default_engine_matches_jax_engine(model, jax_tpu_runner):
    """Both engines with their defaults (stacked params, piggyback on) but
    pipelining, which both turn off here: prefill_chunk 16, prompts of
    9-40 tokens, two slots and a pool of 5 usable pages: a batched fresh
    prefill, chunked prefills that ride the decode call, and one
    preemption whose request is recomputed.  (Pipelined, neither package
    preempts on this traffic; the pipelined engines are held against each
    other in tests/test_torch_pipeline.py.)"""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (9, 40, 13, 21)]
    new = [16, 12, 10, 8]
    kw = dict(max_seqs=2, page_size=PS, max_pages_per_seq=4, n_pages=6,
              prefill_buckets=(16, 32), decode_chunk=4, prefill_chunk=16, seed=0,
              pipeline=False)
    jeng = jengine.Engine(jparams, jcfg, **kw)
    jreqs = jeng.run([jengine.Request(i, p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, new))])
    teng = tengine.Engine(tparams, tcfg, device="cpu", **kw)
    treqs = teng.run([tengine.Request(i, p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, new))])
    assert "qkv_stack" in teng.params["layers"][0]
    assert teng.preemptions == jeng.preemptions >= 1
    assert teng.phase_steps["mixed"] > 0
    for jr, tr, n in zip(jreqs, treqs, new):
        assert tr.done and len(tr.output) == n
        assert tr.output == jr.output
    assert teng.block_manager.num_free == teng.block_manager.n_pages - 1


def test_bf16_pages_engine_matches_jax(jax_tpu_runner):
    """tests/test_engine.py's chunked-prefill case on bf16 KV pages
    (``kv_bits=16``, so the history is exact): a dense model, a 40-token
    prompt streamed in chunks of 16 (16 + 16 + 8, each chunk after the
    first over the paged history) gives the greedy tokens of a single-shot
    prefill, in the port as in the JAX package, and the two packages'
    tokens are equal."""
    jcfg = dataclasses.replace(_llama_cfg(), vocab_size=128, hidden_size=128,
                               intermediate_size=256, num_heads=2,
                               num_kv_heads=2, head_dim=64, rope_theta=10000.0,
                               rms_eps=1e-6)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jsurg.random_dense_params(jcfg, seed=40)
    tparams = tsurg.random_dense_params(tcfg, seed=40, device="cpu")
    prompt = np.random.default_rng(40).integers(0, 128, 40).tolist()

    def gen(engine, params, cfg, buckets, chunk, **kw):
        eng = engine.Engine(params, cfg, max_seqs=1, page_size=PS,
                            max_pages_per_seq=8, prefill_buckets=buckets,
                            decode_chunk=2, prefill_chunk=chunk, kv_bits=16,
                            **kw)
        (req,) = eng.run([engine.Request(0, prompt, max_new_tokens=4)])
        assert eng.caches[0].k_codes.dtype == (
            torch.bfloat16 if engine is tengine else jnp.bfloat16)
        return req.output

    single = gen(tengine, tparams, tcfg, (64,), 64, device="cpu")
    chunked = gen(tengine, tparams, tcfg, (16,), 16, device="cpu")
    assert single == chunked
    assert chunked == gen(jengine, jparams, jcfg, (16,), 16)
